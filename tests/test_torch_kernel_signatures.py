"""The ctypes signatures of the kernel library against the C entry points in ``csrc/*.cu``.

``_build.load`` sets ``argtypes`` from ``_build._SIGNATURES``; a list that does not
match the C declaration passes its arguments wrongly without any error (a pointer
declared as ``c_int`` is cut to 32 bits). These tests read every
``extern "C" int kai0_*(...)`` declaration from the sources, with no compiler and
no card, and hold each argument's C type to its ctypes type.
"""

import ctypes
import re

import pytest

from kai0_tpu_torch.ops import _build

_DECL = re.compile(r'extern\s+"C"\s+int\s+(kai0_\w+)\s*\(([^)]*)\)', re.S)
# C type of an argument (its declaration without the name) -> ctypes type
_CTYPES = {
    "void*": ctypes.c_void_p,
    "const void*": ctypes.c_void_p,
    "int": ctypes.c_int,
    "float": ctypes.c_float,
    "long long": ctypes.c_longlong,
    "unsigned int": ctypes.c_uint,
}


def _declarations() -> dict[str, tuple[str, list[str]]]:
    """name -> (source file, C types of the arguments) of every C entry point."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, args in _DECL.findall(src.read_text()):
            assert name not in found, f"{name} declared in {found[name][0]} and {src.name}"
            types = []
            for arg in args.split(","):
                words = arg.replace("*", " * ").split()
                types.append(" ".join(words[:-1]).replace(" *", "*"))
            found[name] = (src.name, types)
    return found


def test_every_signature_has_a_source_and_every_source_a_signature():
    declared = _declarations()
    assert len(declared) >= 8
    assert sorted(declared) == sorted(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_argtypes_match_the_c_declaration(name):
    declared = _declarations()
    assert name in declared, f"{name} has no extern \"C\" declaration in csrc/*.cu"
    src, c_types = declared[name]
    argtypes = _build._SIGNATURES[name]
    assert len(argtypes) == len(c_types), f"{name} ({src}): {len(argtypes)} argtypes for {len(c_types)} arguments"
    for i, (c_type, argtype) in enumerate(zip(c_types, argtypes, strict=True)):
        assert c_type in _CTYPES, f"{name} ({src}) argument {i}: C type {c_type!r} has no ctypes mapping here"
        assert argtype is _CTYPES[c_type], f"{name} ({src}) argument {i}: {c_type} declared, {argtype} bound"


def test_the_parser_reads_a_declaration():
    text = 'extern "C" int kai0_x(const void* a, void* b,\n    long long n, unsigned int s, float f, int k) {'
    name, args = _DECL.findall(text)[0]
    assert name == "kai0_x" and len(args.split(",")) == 6
