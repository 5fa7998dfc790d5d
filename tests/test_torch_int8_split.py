"""K4b's split contraction at M <= 64 (int8 serving's denoise steps), on the CPU.

``_split_k_plan`` is a pure function of (M, N, K, SMs): these tests hold its
contract (one split above 64 rows, ranges of whole 128-byte pieces but the last,
enough blocks to cover the SMs at the action expert's six denoise products).
The kernel's arithmetic is emulated in int64: int32 partial sums over the
ranges of a split, added in any order, then the epilogue once, equal
``int8_matmul_plain`` bit for bit, because integer addition is exact and
associative and the epilogue sees the same integer as the plain version.
"""

import numpy as np
import pytest
import torch

from kai0_tpu_torch.ops import int8_matmul as mm

# (K, N) of the action expert's products in a denoise step: q, the joint kv, out, gate (= up), down.
DENOISE = {"q": (1024, 2048), "kv": (1024, 512), "out": (2048, 1024), "gate/up": (1024, 4096), "down": (4096, 1024)}


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("m", [1, 7, 50, 64, 65, 968, 7744])
@pytest.mark.parametrize("n,k", [*DENOISE.values(), (16384, 2048), (2048, 16384), (33, 17), (1000, 4100)])
def test_split_plan(sms, m, n, k):
    tile, splits, chunk = mm._split_k_plan(m, n, k, sms)
    assert splits >= 1
    if m > 64:
        assert (tile, splits, chunk) == (0, 1, k)
        return
    assert tile in (16, 32, 64)
    assert chunk % 128 == 0 and (splits - 1) * chunk < k <= splits * chunk  # whole pieces, only the last short
    if (k, n) in DENOISE.values():
        assert -(-n // tile) * splits >= sms, "the denoise products should cover the SMs"


def _emulate(xq, w, sx, sn, chunk, out_dtype, order):
    """The split kernel in int64: a partial sum per range (each within int32), summed in ``order``, then the epilogue."""
    k = xq.shape[1]
    partials = []
    for k0 in range(0, k, chunk):
        part = xq[:, k0:k0 + chunk].to(torch.int64) @ w[:, k0:k0 + chunk].to(torch.int64).T
        assert part.abs().max() < 2**31
        partials.append(part)
    total = torch.zeros_like(partials[0])
    for i in order(len(partials)):
        total += partials[i]
    assert total.abs().max() < 2**31
    y = total.to(torch.int32).to(torch.float32) * sx
    return (y if sn is None else y * sn).to(out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("m,n,k", [(50, 512, 1024), (7, 200, 1040), (64, 96, 4100)])
def test_split_sums_then_epilogue_equal_the_plain_version(out_dtype, scaled, m, n, k):
    rng = np.random.default_rng(m + n + k)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    sx = torch.from_numpy((rng.random((m, 1)) * 1e-2 + 1e-4).astype(np.float32))
    sn = torch.from_numpy((rng.random(n) * 1e-3 + 1e-5).astype(np.float32)) if scaled else None
    want = mm.int8_matmul_plain(xq, w, sx, sn, nt=True, out_dtype=out_dtype)
    _, _, chunk = mm._split_k_plan(m, n, k, 132)
    for c in (chunk, 128, k):  # the plan's split, the finest, none
        for order in (lambda s: range(s), lambda s: reversed(range(s)), lambda s: rng.permutation(s)):
            assert torch.equal(_emulate(xq, w, sx, sn, c, out_dtype, order), want)
