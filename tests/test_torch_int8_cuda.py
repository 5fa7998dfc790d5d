"""The int8 CUDA kernels of kai0_tpu_torch (K5, K4b, K4a) against their plain PyTorch versions.

This file imports no JAX, so that the card's machine (which has none) can run it
without the repository's conftest:

    python -m pytest tests/test_torch_int8_cuda.py -m cuda --noconftest -q

The ``cuda`` tests skip where no card is present. K5 (codes and scales, with
and without a column scale, from its register kernel and from its edge kernel
for ragged or misaligned rows) and K4b (both orientations, with and without column scales, bf16 and f32 outputs)
are held bit-equal. K4a (the forward orientation only) sums its rank-r term in another order than the plain
version's library product, so the bf16 rounding of that term can flip by one
unit in its last place: at most 1e-3 of the bf16 outputs differ at all, and
each by at most 2^-7 x max(|y|, |rank-r term|) (one bf16 step of the larger of
the output and the term; where the two nearly cancel, a step of the term is
many steps of the output); in f32 the difference is at most 1e-5 x max |y|
(the r-term sum's rounding).

A product runs on one of three kernels by shape (``wgmma`` tiles in both
orientations at M > 64 with 16-byte aligned rows, the split contraction for K4b's
forward orientation at M <= 64, the ``mma.sync`` tiles otherwise); the cases
below reach each, and ``test_kernel_choice_follows_the_shape`` reads from the
profiler which one ran.
"""

import pytest
import torch

from kai0_tpu_torch.ops import int8_matmul as mm
from kai0_tpu_torch.ops import row_quant as rq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, n, k, seed, device, rank=None, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
    sx = torch.rand(m, 1, generator=g, device=device) * 1e-2 + 1e-4
    sn = torch.rand(n, generator=g, device=device) * 1e-3 + 1e-5
    if rank is None:
        return xq, w, sx, sn
    u = torch.randn(m, rank, generator=g, device=device).to(dtype)
    b = (torch.randn(rank, n, generator=g, device=device) * 5).to(dtype)
    return xq, w, sx, sn, u, b


def _row_quant_operands(m, k, dtype, device, offset=0):
    """Rows (a row of zeros, a row whose amax is 1e-20) and column scales from 1e-5 to 1e-2, each ``offset``
    elements past an aligned allocation."""
    g = torch.Generator(device=device).manual_seed(m + 7 * k)
    x = torch.empty(m * k + offset, dtype=dtype, device=device)[offset:].view(m, k)
    x.copy_(torch.randn(m, k, generator=g, device=device) * 3)
    if m > 2:
        x[1] = 0
        x[2] = torch.randn(k, generator=g, device=device) * 3e-21
        x[2, 0] = 1e-20
    c = torch.empty(k + offset, device=device)[offset:]
    c.copy_(10.0 ** (torch.rand(k, generator=g, device=device) * 3 - 5))
    return x, c


def _check_row_quant(x, c):
    before = dict(rq.LAUNCHES)
    xq, sx = rq.row_quant(x, col_scale=c)
    torch.cuda.synchronize()
    assert rq.LAUNCHES == {"row_quant": before["row_quant"] + 1,
                           "row_quant_colscale": before["row_quant_colscale"] + (c is not None)}
    ref_q, ref_s = rq.row_quant_plain(x, c)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32 and sx.shape == (x.shape[0], 1)
    assert torch.equal(sx, ref_s), (sx - ref_s).abs().max().item()
    assert torch.equal(xq, ref_q), (xq.int() - ref_q.int()).abs().max().item()
    if x.shape[0] > 2:
        assert not xq[1].any() and xq[2].abs().max().item() == 127 and sx[2].item() < 1e-20


# Every M against every K, and shapes of the int8 paths off that grid.
_ROW_QUANT_SHAPES = [(m, k) for m in (1, 50, 65, 968, 7744) for k in (100, 1027, 2048, 4096, 16384)] + [
    (50, 1024), (300, 16384), (7, 100), (33, 1027)]


@pytest.mark.cuda
@pytest.mark.parametrize("col_scale", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", _ROW_QUANT_SHAPES)
def test_row_quant_kernel_is_bit_equal(cuda, col_scale, dtype, m, k):
    x, c = _row_quant_operands(m, k, dtype, cuda)
    _check_row_quant(x, c if col_scale else None)


@pytest.mark.cuda
@pytest.mark.parametrize("col_scale", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(65, 2048), (7, 16384), (50, 1024)])
def test_row_quant_misaligned_base_is_bit_equal(cuda, col_scale, dtype, m, k):
    x, c = _row_quant_operands(m, k, dtype, cuda, offset=1)
    assert x.data_ptr() % 16 and c.data_ptr() % 16
    _check_row_quant(x, c if col_scale else None)


@pytest.mark.cuda
def test_row_quant_kernel_choice(cuda):
    """Aligned rows of a multiple of 16 elements up to 16384: the register kernel; others: the edge kernel."""
    x, c = _row_quant_operands(65, 2048, torch.bfloat16, cuda)
    odd, odd_c = _row_quant_operands(65, 2048, torch.bfloat16, cuda, offset=1)
    ragged, ragged_c = _row_quant_operands(65, 1027, torch.float32, cuda)
    wide = torch.randn(3, 16400, device=cuda)
    cases = {
        "row_quant_regs_kernel<": (lambda: rq.row_quant(x), lambda: rq.row_quant(x, c)),
        "row_quant_edge_kernel<": (lambda: rq.row_quant(odd), lambda: rq.row_quant(x, odd_c),
                                   lambda: rq.row_quant(ragged, ragged_c), lambda: rq.row_quant(wide)),
    }
    for kernel, calls in cases.items():
        for call in calls:
            call()
            names = _kernels_run(call)
            assert len(names) == 1 and kernel in names[0], (kernel, names)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nt", [True, False])
@pytest.mark.parametrize("m,n,k", [(50, 256, 1024), (968, 2048, 2048), (200, 4096, 16384), (130, 1024, 4096),
                                   (70, 72, 48), (5, 33, 100), (129, 130, 17)])
def test_int8_matmul_kernel_is_bit_equal(cuda, out_dtype, nt, m, n, k):
    xq, w, sx, sn = _operands(m, n, k, m + n + k, cuda)
    w = w if nt else w.T.contiguous()
    for scales in (sn, None):
        before = mm.LAUNCHES["int8_matmul"]
        out = mm.int8_matmul(xq, w, sx, scales, nt=nt, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert mm.LAUNCHES["int8_matmul"] == before + 1
        ref = mm.int8_matmul_plain(xq, w, sx, scales, nt=nt, out_dtype=out_dtype)
        assert out.dtype == out_dtype and torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,rank", [(50, 4096, 1024, 32), (968, 16384, 2048, 16), (968, 2048, 16384, 16),
                                        (1600, 1024, 4096, 32), (70, 72, 48, 4), (129, 130, 32, 7),
                                        (300, 1024, 2048, 40), (968, 2048, 2048, 64), (129, 520, 64, 128)])
def test_int8_matmul_lora_kernel_bf16_ulp(cuda, m, n, k, rank):
    xq, w, sx, sn, u, b = _operands(m, n, k, m + n + k + rank, cuda, rank)
    before = mm.LAUNCHES["int8_matmul_lora"]
    out = mm.int8_matmul_lora(xq, w, sx, sn, u, b)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["int8_matmul_lora"] == before + 1
    ref = mm.int8_matmul_lora_plain(xq, w, sx, sn, u, b)
    term = (u @ b).float()
    diff = (out.float() - ref.float()).abs()
    assert (diff <= 2.0**-7 * torch.maximum(ref.float().abs(), term.abs())).all(), diff.max().item()
    assert (diff > 0).float().mean().item() <= 1e-3
    base = mm.int8_matmul_plain(xq, w, sx, sn, nt=True)
    assert (out.float() - base.float()).abs().max().item() > 0.1  # the rank-r term is in the output


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,rank,seed", [(100, 4096, 2048, 16, 3), (300, 1024, 2048, 40, 40),
                                             (300, 1024, 2048, 64, 64), (300, 1024, 2048, 128, 128)])
def test_int8_matmul_lora_kernel_f32(cuda, m, n, k, rank, seed):
    """Ranks above 32 span several slices of the epilogue: the f32 sums run on across the slices."""
    xq, w, sx, sn, u, b = _operands(m, n, k, seed, cuda, rank, torch.float32)
    out = mm.int8_matmul_lora(xq, w, sx, sn, u, b, out_dtype=torch.float32)
    ref = mm.int8_matmul_lora_plain(xq, w, sx, sn, u, b, out_dtype=torch.float32)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    xq, w, sx, sn, u, b = _operands(8, 16, 64, 0, cuda, 40)
    with pytest.raises(ValueError):
        mm.int8_matmul_lora(xq, w, sx, sn, u[:, :0], b[:0])  # rank 0
    with pytest.raises(ValueError):
        mm.int8_matmul(xq.T, w, sx, sn, nt=True)  # contraction mismatch
    with pytest.raises(ValueError):
        rq.row_quant(torch.zeros(4, 8, device=cuda, dtype=torch.float16))
    x = torch.zeros(4, 8, device=cuda)
    for c in (torch.ones(9, device=cuda), torch.ones(8, device=cuda, dtype=torch.bfloat16), torch.ones(8),
              torch.ones(16, device=cuda)[::2]):
        with pytest.raises(ValueError):
            rq.row_quant(x, col_scale=c)


def _kernels_run(fn) -> list[str]:
    """Names of the CUDA kernels that ``fn`` launches, from the profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 7, 50, 64])
@pytest.mark.parametrize("n,k", [(1000, 4100), (2050, 1040), (512, 1024), (33, 200)])
def test_int8_matmul_split_k_is_bit_equal(cuda, out_dtype, m, n, k):
    """K4b nt at M <= 64: splits of the contraction (K not a multiple of splits x 128, ragged N), exact sums."""
    tile, splits, chunk = mm._split_k_plan(m, n, k, mm._sm_count(cuda))
    assert tile in (16, 32, 64) and (splits - 1) * chunk < k <= splits * chunk
    xq, w, sx, sn = _operands(m, n, k, m + n + k, cuda)
    for scales in (sn, None):
        out = mm.int8_matmul(xq, w, sx, scales, nt=True, out_dtype=out_dtype)
        again = mm.int8_matmul(xq, w, sx, scales, nt=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        ref = mm.int8_matmul_plain(xq, w, sx, scales, nt=True, out_dtype=out_dtype)
        assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
        assert torch.equal(out, again)
    ws, counters = mm._SPLIT_K_BUFFERS[(xq.device, n)]
    assert not ws.any() and not counters.any(), "the split kernel left its workspace dirty"


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [65, 129, 968, 7744])
@pytest.mark.parametrize("n", [1000, 2050])
def test_int8_matmul_wgmma_is_bit_equal(cuda, out_dtype, m, n):
    """K4b nt at M > 64 on the wgmma kernel: ragged M and N, K = 2048 + 16 (a partial last stage)."""
    k = 2048 + 16
    xq, w, sx, sn = _operands(m, n, k, m + n, cuda)
    for scales in (sn, None):
        out = mm.int8_matmul(xq, w, sx, scales, nt=True, out_dtype=out_dtype)
        again = mm.int8_matmul(xq, w, sx, scales, nt=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        ref = mm.int8_matmul_plain(xq, w, sx, scales, nt=True, out_dtype=out_dtype)
        assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
        assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [7, 16, 32, 40, 64])
def test_int8_matmul_lora_wgmma(cuda, rank):
    """K4a on the wgmma kernel at ranks of one, two and three 32-rank slices, bf16 and f32."""
    m, n, k = 300, 1000, 2064
    xq, w, sx, sn, u, b = _operands(m, n, k, rank, cuda, rank)
    out = mm.int8_matmul_lora(xq, w, sx, sn, u, b)
    assert torch.equal(out, mm.int8_matmul_lora(xq, w, sx, sn, u, b))
    ref = mm.int8_matmul_lora_plain(xq, w, sx, sn, u, b)
    diff = (out.float() - ref.float()).abs()
    assert (diff <= 2.0**-7 * torch.maximum(ref.float().abs(), (u @ b).float().abs())).all(), diff.max().item()
    assert (diff > 0).float().mean().item() <= 1e-3
    xq, w, sx, sn, u, b = _operands(m, n, k, rank, cuda, rank, torch.float32)
    out = mm.int8_matmul_lora(xq, w, sx, sn, u, b, out_dtype=torch.float32)
    ref = mm.int8_matmul_lora_plain(xq, w, sx, sn, u, b, out_dtype=torch.float32)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [65, 1600, 7744])
@pytest.mark.parametrize("n,k", [(1008, 2064), (2064, 1040)])
def test_int8_matmul_nn_wgmma_is_bit_equal(cuda, out_dtype, m, n, k):
    """K4b nn (the LoRA step's dx) at M > 64 on the wgmma kernel: ragged M, N and K, with and without sn."""
    xq, w, sx, sn = _operands(m, n, k, m + n + k, cuda)
    w = w.T.contiguous()  # [k, n]: the stored [out, in] weight of a dx product
    for scales in (sn, None):
        out = mm.int8_matmul(xq, w, sx, scales, nt=False, out_dtype=out_dtype)
        again = mm.int8_matmul(xq, w, sx, scales, nt=False, out_dtype=out_dtype)
        torch.cuda.synchronize()
        ref = mm.int8_matmul_plain(xq, w, sx, scales, nt=False, out_dtype=out_dtype)
        assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
        assert torch.equal(out, again)


def _orientation(name: str) -> str:
    """``nn`` or ``nt`` from the template arguments of an int8 kernel's name (its second one is NN)."""
    return "nn" if name.split("<")[1].split(",")[1].strip() == "true" else "nt"


@pytest.mark.cuda
def test_kernel_choice_follows_the_shape(cuda):
    """Both orientations at M > 64 with aligned rows: wgmma; K4b nt at M <= 64: the split kernel; unaligned rows,
    K4a and nn at M <= 64: mma.sync."""
    xq, w, sx, sn, u, b = _operands(129, 256, 2048, 0, cuda, 16)
    # operands made here: a copy inside a profiled call would show as a kernel of its own
    x50, sx50, u50, g = xq[:50].contiguous(), sx[:50].contiguous(), u[:50].contiguous(), xq[:, :256].contiguous()
    g50, g40 = g[:50].contiguous(), g[:, :40].contiguous()
    odd_x, odd_w = xq[:, :2040].contiguous(), w[:, :2040].contiguous()  # rows of 2040 bytes: not 16-byte aligned
    cases = {
        ("int8_mm_wgmma_kernel<", "nt"): (lambda: mm.int8_matmul(xq, w, sx, sn, nt=True),
                                          lambda: mm.int8_matmul_lora(xq, w, sx, sn, u, b)),
        ("int8_mm_wgmma_kernel<", "nn"): (lambda: mm.int8_matmul(g, w, sx, None, nt=False),),
        ("int8_mm_splitk_kernel<", "nt"): (lambda: mm.int8_matmul(x50, w, sx50, sn, nt=True),),
        ("int8_mm_kernel<", "nt"): (lambda: mm.int8_matmul(odd_x, odd_w, sx, sn, nt=True),
                                    lambda: mm.int8_matmul_lora(x50, w, sx50, sn, u50, b)),
        ("int8_mm_kernel<", "nn"): (lambda: mm.int8_matmul(g40, odd_w[:40], sx, None, nt=False),
                                    lambda: mm.int8_matmul(g50, w, sx50, None, nt=False)),
    }
    for calls in cases.values():  # the first call of a shape may allocate the split kernel's workspace
        for call in calls:
            call()
    for (kernel, orientation), calls in cases.items():
        for call in calls:
            names = _kernels_run(call)
            assert len(names) == 1 and kernel in names[0], (kernel, names)
            if kernel != "int8_mm_splitk_kernel<":
                assert _orientation(names[0].replace("(anonymous namespace)::", "")) == orientation, names


@pytest.mark.cuda
def test_split_k_workspace_is_not_made_inside_a_capture(cuda):
    """The split kernel's int32 workspace is cached per N and must be zero before each launch. Made inside a CUDA
    graph capture, its zero fill would run only on replay and eager calls would read it unset: capturing a product
    with a new N raises and caches nothing. After one eager call the capture replays bit-equal to the plain version,
    and eager calls after the replays stay bit-equal with the workspace left zero."""
    m, n, k = 50, 1352, 1024  # an N no other test of the process uses
    xq, w, sx, sn = _operands(m, n, k, 91, cuda)
    mm._SPLIT_K_BUFFERS.pop((xq.device, n), None)
    ref = mm.int8_matmul_plain(xq, w, sx, sn, nt=True)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        with torch.cuda.graph(graph):
            mm.int8_matmul(xq, w, sx, sn, nt=True)
    assert (xq.device, n) not in mm._SPLIT_K_BUFFERS
    eager = mm.int8_matmul(xq, w, sx, sn, nt=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = mm.int8_matmul(xq, w, sx, sn, nt=True)
    graph.replay()
    replayed = captured.clone()
    graph.replay()
    after = mm.int8_matmul(xq, w, sx, sn, nt=True)
    torch.cuda.synchronize()
    for y in (eager, replayed, captured, after):
        assert torch.equal(y, ref)
    ws, counters = mm._SPLIT_K_BUFFERS[(xq.device, n)]
    assert not ws.any() and not counters.any()
