"""int8 x int8 matrix products with a scaling epilogue (kernels K4b, K4a) and their plain versions.

Counterpart of ``kai0_tpu/ops/pallas_quant.py``:

- ``int8_matmul`` (K4b): ``y[M, N] = float(xq · w) * sx * sn``, the int32 sum
  exact, scaled in f32 in the order ``acc * sx`` then ``* sn``, written in
  ``out_dtype``. ``nt=False`` takes ``w [K, N]``; ``nt=True`` takes ``w [N, K]``
  and contracts both operands on their trailing axis. ``sn=None`` scales by
  the rows only (the backward's ``dx = q_row(dy·s) @ qᵀ``).
- ``int8_matmul_lora`` (K4a): the forward product over the stored weight
  ``w [N, K]`` with both scales, plus a rank-r term per output,
  ``y = acc * sx * sn + round(u · b)``: ``u [M, r]`` and ``b [r, N]`` in the
  activation dtype (= ``out_dtype``), summed in f32 and rounded to that dtype
  once before the add (no rounding when it is f32).

The port stores a quantized weight once, as ``[out, in]`` like a
``nn.Linear``: its forward products are the ``nt`` orientation (K4a knows no
other), the backward's ``dx`` the other one, over the same tensor.

On CUDA tensors the wrappers launch ``csrc/int8_mm.cu``; on CPU tensors they
run the plain versions. Which hand-written kernel a product takes follows its
shape: both orientations at M > 64 with 16-byte aligned rows (every product of
the training paths and of int8 serving's prefill) run on ``wgmma`` tiles fed
by TMA, ``nn`` with its weight operand transposed in registers; K4b's forward
orientation at M <= 64 (int8 serving's denoise steps) on a kernel that splits
the contraction over blocks to cover the card's SMs and sums the int32 partials
exactly in a workspace this module keeps per device and width (all zero between
calls; one stream a device at a time); the rest on ``mma.sync`` tiles. K4b is
bit-equal to its plain version; K4a sums the r terms in another order than a
library product, so isolated outputs differ by
one unit in the last place of the rank-r term. The plain product accumulates in
float64 on every device, which is exact here (every partial sum is an integer
of magnitude <= 16384 · 127² < 2⁵³, so no addition rounds; an f32 accumulator
would round above 2²⁴) and, unlike torch's integer product, exists on CUDA and
runs through BLAS on the CPU.
"""

from __future__ import annotations

import functools

import torch

from kai0_tpu_torch.ops import _build

# Kernel launches since the last ``reset_launches()``.
LAUNCHES = {"int8_matmul": 0, "int8_matmul_lora": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


SPLIT_K_MAX_ROWS = 64  # K4b's forward orientation up to this many rows splits the contraction
_SPLIT_K_TILES = (64, 32, 16)  # column tiles of the split kernel, widest first
_SPLIT_K_PIECE = 128  # contraction bytes: a split covers whole pieces, only the last may end short
# (device, n) -> (int32 [SPLIT_K_MAX_ROWS * n] partial sums, int32 arrival counters a column tile), zero between calls
_SPLIT_K_BUFFERS: dict[tuple[torch.device, int], tuple[torch.Tensor, torch.Tensor]] = {}


@functools.lru_cache(maxsize=256)
def _split_k_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int, int]:
    """``(column tile, splits, chunk bytes)`` of K4b's forward orientation; ``(0, 1, k)`` above 64 rows.

    The split kernel's grid is ``ceil(n / tile) x splits`` blocks, block ``s``
    summing the contraction range ``[s * chunk, min(k, (s + 1) * chunk))``.
    ``chunk`` is a whole number of 128-byte pieces; the splits are as many as
    cover ``sms`` SMs together with the column tiles (at most one a piece), with
    the widest tile that then reaches ``sms`` blocks, else the narrowest.
    """
    if m > SPLIT_K_MAX_ROWS:
        return 0, 1, k
    pieces = -(-k // _SPLIT_K_PIECE)
    for tile in _SPLIT_K_TILES:
        tiles = -(-n // tile)
        per = max(1, pieces // min(pieces, -(-sms // tiles)))
        splits = -(-pieces // per)
        if tiles * splits >= sms:
            break
    return tile, splits, per * _SPLIT_K_PIECE


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_k_buffers(device: torch.device, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (device, n)
    if key not in _SPLIT_K_BUFFERS:
        _SPLIT_K_BUFFERS[key] = (
            torch.zeros(SPLIT_K_MAX_ROWS * n, dtype=torch.int32, device=device),
            torch.zeros(-(-n // min(_SPLIT_K_TILES)), dtype=torch.int32, device=device),
        )
    return _SPLIT_K_BUFFERS[key]


def _scaled_product(xq, w, sx, sn, nt: bool) -> torch.Tensor:
    a, b = xq.to(torch.float64), w.to(torch.float64)
    y = (a @ (b.T if nt else b)).to(torch.float32) * sx.reshape(-1, 1)
    return y if sn is None else y * sn


def int8_matmul_plain(xq, w, sx, sn=None, *, nt: bool = False, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K4b's plain version, on any device."""
    return _scaled_product(xq, w, sx, sn, nt).to(out_dtype)


def int8_matmul_lora_plain(xq, w, sx, sn, u, b, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K4a's plain version over ``w [N, K]``: ``base + (u @ b).float()`` with the product in u's dtype."""
    return (_scaled_product(xq, w, sx, sn, True) + (u @ b).to(torch.float32)).to(out_dtype)


def _check_operands(xq, w, sx, sn, nt: bool, out_dtype) -> tuple[int, int, int]:
    if xq.ndim != 2 or w.ndim != 2 or xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"int8_matmul takes 2-D int8 operands, not {xq.dtype} {tuple(xq.shape)}, {w.dtype} {tuple(w.shape)}")
    m, k = xq.shape
    n, kw = w.shape if nt else w.shape[::-1]
    if kw != k:
        raise ValueError(f"contraction mismatch: xq {tuple(xq.shape)} vs w {tuple(w.shape)} (nt={nt})")
    if sx.dtype != torch.float32 or sx.numel() != m or (sn is not None and (sn.dtype != torch.float32 or sn.shape != (n,))):
        raise ValueError("int8_matmul takes f32 scales sx [M, 1] and sn [N]")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul writes f32 or bf16, not {out_dtype}")
    return m, n, k


def _check_kernel_operands(*tensors) -> None:
    device = tensors[0].device
    for t in tensors:
        if t is not None and (t.device != device or not t.is_contiguous()):
            raise ValueError(f"int8_matmul kernel takes contiguous tensors on one device, not {tuple(t.shape)} on {t.device}")


def int8_matmul(xq, w, sx, sn=None, *, nt: bool = False, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K4b on CUDA tensors, the plain version on CPU tensors."""
    m, n, k = _check_operands(xq, w, sx, sn, nt, out_dtype)
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, w, sx, sn, nt=nt, out_dtype=out_dtype)
    _check_kernel_operands(xq, w, sx, sn)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    args = (xq.data_ptr(), w.data_ptr(), sx.data_ptr(), None if sn is None else sn.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    if nt and m <= SPLIT_K_MAX_ROWS:
        tile, splits, chunk = _split_k_plan(m, n, k, _sm_count(xq.device))
        ws, counters = _split_k_buffers(xq.device, n)
        err = _build.load().kai0_int8_mm_splitk(
            *args, ws.data_ptr(), counters.data_ptr(), m, n, k, tile, splits, chunk, int(out_dtype == torch.bfloat16), stream,
        )
    else:
        err = _build.load().kai0_int8_mm(*args, m, n, k, int(nt), int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError_t {err}")
    LAUNCHES["int8_matmul"] += 1
    return out


def int8_matmul_lora(xq, w, sx, sn, u, b, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K4a on CUDA tensors, the plain version on CPU tensors; ``w`` is the stored weight ``[N, K]``."""
    m, n, k = _check_operands(xq, w, sx, sn, True, out_dtype)
    if sn is None:
        raise ValueError("int8_matmul_lora takes column scales")
    if u.ndim != 2 or b.ndim != 2 or u.shape[0] != m or b.shape[1] != n or u.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: xq {tuple(xq.shape)} w {tuple(w.shape)} u {tuple(u.shape)} b {tuple(b.shape)}")
    if u.dtype != out_dtype or b.dtype != out_dtype:
        raise ValueError(f"int8_matmul_lora takes u and b in out_dtype {out_dtype}, not {u.dtype}, {b.dtype}")
    if xq.device.type == "cpu":
        return int8_matmul_lora_plain(xq, w, sx, sn, u, b, out_dtype=out_dtype)
    rank = u.shape[1]
    if rank == 0:
        raise ValueError("int8_matmul_lora kernel takes a rank of 1 or more, not 0")
    _check_kernel_operands(xq, w, sx, sn, u, b)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    err = _build.load().kai0_int8_mm_lora(
        xq.data_ptr(), w.data_ptr(), sx.data_ptr(), sn.data_ptr(), u.data_ptr(), b.data_ptr(), out.data_ptr(),
        m, n, k, rank, int(out_dtype == torch.bfloat16), torch.cuda.current_stream(xq.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul_lora launch failed: cudaError_t {err}")
    LAUNCHES["int8_matmul_lora"] += 1
    return out
