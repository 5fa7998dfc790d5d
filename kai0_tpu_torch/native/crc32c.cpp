// CRC-32C (Castagnoli) and TFRecord's masked CRC, for the RLDS stream.
//
// A TFRecord file is a run of records, each
//   uint64 length | uint32 masked_crc32c(length) | payload | uint32 masked_crc32c(payload)
// (little endian), where masked(c) = ((c >> 15) | (c << 17)) + 0xa282ead8 mod 2^32.
// zlib's crc32 is another polynomial, and a byte loop in Python is too slow for
// episodes of several megabytes, so the CRC lives here: SSE4.2's crc32
// instruction where the CPU has it (chosen at run time), else slicing-by-8.
//
// Exposed via the CPython C API:
//   crc32c(data, value=0) -> int        the CRC of data, extending value
//   masked_crc32c(data) -> int          TFRecord's masked CRC
// The GIL is released while a CRC runs.
//
// Built at first use by kai0_tpu_torch/native/__init__.py (load_crc32c); the
// Python side is kai0_tpu_torch/data/tfrecord.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(__i386__)
#include <nmmintrin.h>
#define KAI0_CRC_X86 1
#endif

namespace {

constexpr uint32_t kPoly = 0x82f63b78u;  // reflected Castagnoli polynomial
constexpr uint32_t kMaskDelta = 0xa282ead8u;

uint32_t table[8][256];

void init_tables() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? kPoly : 0u);
    table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t) table[t][i] = (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 0xffu];
}

// Both take and return the register (the CRC before the final inversion).
uint32_t crc_software(uint32_t c, const uint8_t* p, size_t n) {
  while (n && (reinterpret_cast<uintptr_t>(p) & 7u)) {
    c = (c >> 8) ^ table[0][(c ^ *p++) & 0xffu];
    --n;
  }
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= c;
    c = table[7][w & 0xff] ^ table[6][(w >> 8) & 0xff] ^ table[5][(w >> 16) & 0xff] ^ table[4][(w >> 24) & 0xff] ^
        table[3][(w >> 32) & 0xff] ^ table[2][(w >> 40) & 0xff] ^ table[1][(w >> 48) & 0xff] ^
        table[0][(w >> 56) & 0xff];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ table[0][(c ^ *p++) & 0xffu];
  return c;
}

#ifdef KAI0_CRC_X86
__attribute__((target("sse4.2"))) uint32_t crc_hardware(uint32_t c, const uint8_t* p, size_t n) {
#if defined(__x86_64__)
  uint64_t c64 = c;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    c64 = _mm_crc32_u64(c64, w);
    p += 8;
    n -= 8;
  }
  c = static_cast<uint32_t>(c64);
#endif
  while (n--) c = _mm_crc32_u8(c, *p++);
  return c;
}
#endif

bool use_hardware = false;

uint32_t crc32c_extend(uint32_t value, const uint8_t* p, size_t n) {
  uint32_t c = ~value;
#ifdef KAI0_CRC_X86
  if (use_hardware) return ~crc_hardware(c, p, n);
#endif
  return ~crc_software(c, p, n);
}

uint32_t masked(uint32_t c) { return ((c >> 15) | (c << 17)) + kMaskDelta; }

PyObject* py_crc32c(PyObject*, PyObject* args, PyObject* kwargs) {
  static const char* names[] = {"data", "value", nullptr};
  Py_buffer view;
  unsigned long value = 0;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "y*|k", const_cast<char**>(names), &view, &value)) return nullptr;
  uint32_t c;
  Py_BEGIN_ALLOW_THREADS
  c = crc32c_extend(static_cast<uint32_t>(value), static_cast<const uint8_t*>(view.buf), view.len);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  return PyLong_FromUnsignedLong(c);
}

PyObject* py_masked_crc32c(PyObject*, PyObject* args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return nullptr;
  uint32_t c;
  Py_BEGIN_ALLOW_THREADS
  c = masked(crc32c_extend(0, static_cast<const uint8_t*>(view.buf), view.len));
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  return PyLong_FromUnsignedLong(c);
}

PyMethodDef methods[] = {
    {"crc32c", (PyCFunction)py_crc32c, METH_VARARGS | METH_KEYWORDS,
     "crc32c(data, value=0): the CRC-32C of data, extending value."},
    {"masked_crc32c", (PyCFunction)py_masked_crc32c, METH_VARARGS, "masked_crc32c(data): TFRecord's masked CRC."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef crc_module = {PyModuleDef_HEAD_INIT, "_crc32c", "CRC-32C (Castagnoli) and TFRecord's mask.", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__crc32c(void) {
  init_tables();
#ifdef KAI0_CRC_X86
  __builtin_cpu_init();
  use_hardware = __builtin_cpu_supports("sse4.2");
#endif
  return PyModule_Create(&crc_module);
}
