"""The CUDA kernels of kai0_tpu_torch against their plain PyTorch versions.

This file imports no JAX, so that the card's machine (which has none) can run it
without the repository's conftest:

    python -m pytest tests/test_torch_flash_cuda.py -m cuda --noconftest -q

The ``cuda`` tests skip where no card is present. bf16 inputs of ``flash_mha``
and ``flash_mhsa`` run on the tensor-core kernels (``csrc/flash_mqa_mma.cuh``,
``csrc/flash_mhsa_mma.cuh``), f32 inputs on the scalar ones. Tolerances, with unit-normal inputs and q scaled by
head_dim**-0.5: forward, max abs 1e-4 in f32 (summation order); in bf16 max abs
2e-2 and mean abs 2e-3 (the kernel rounds the unnormalised softmax weights to
bf16, the plain version the normalised probabilities). Backward, against
autograd through the plain version: max abs <= 1e-4 x max |grad| in f32 and
<= 2e-2 x max |grad| in bf16, per gradient.
K3 in deterministic mode: scales equal, codes within 1 on at most 1e-5 of the
elements, update within 1e-6 relative. K3 over all tensors in one launch
(``adam_q8_leaves``) gives the per-tensor kernel's bits in both modes.
"""

import pathlib

import pytest
import torch

from kai0_tpu_torch.ops import _build
from kai0_tpu_torch.ops import adam_q8 as q8
from kai0_tpu_torch.ops import attention
from kai0_tpu_torch.ops import flash_attention as fa
from kai0_tpu_torch.ops.masks import make_attn_mask

TOL = {torch.float32: (1e-4, None), torch.bfloat16: (2e-2, 2e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _serving_mask(t: int, s: int, device) -> torch.Tensor:
    """Prefix validity as serving builds it (one camera masked, a padded prompt); denoise rows for t < s."""
    prefix = torch.ones(1, 968, dtype=torch.bool, device=device)
    prefix[:, 512:768] = False
    prefix[:, 818:] = False
    ar = torch.zeros(968, dtype=torch.bool, device=device)
    if t == s == 968:
        return make_attn_mask(prefix, ar)
    suffix = make_attn_mask(torch.ones(1, t, dtype=torch.bool, device=device), torch.arange(t, device=device) == 0)
    return torch.cat([prefix[:, None, :].expand(1, t, 968), suffix], dim=-1).contiguous()


def _assert_close(out, ref, dtype):
    max_tol, mean_tol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= max_tol, err.max().item()
    if mean_tol is not None:
        assert err.mean().item() <= mean_tol, err.mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s", [(968, 968), (50, 1018)])
def test_flash_mha_kernel_matches_plain(cuda, dtype, t, s):
    g = torch.Generator(device=cuda).manual_seed(t)
    q = (torch.randn(1, t, 8, 256, generator=g, device=cuda) / 16).to(dtype)
    k, v = (torch.randn(1, s, 1, 256, generator=g, device=cuda).to(dtype) for _ in range(2))
    mask = _serving_mask(t, s, cuda)
    before = fa.LAUNCHES["flash_mha"]
    out, lse = fa.flash_mha_fwd(q, k, v, mask)
    ref = fa.flash_mha_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_mha"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype and lse.shape == (1, t * 8)
    _assert_close(out, ref, dtype)
    _assert_close(fa.flash_mha(q, k, v, mask[:, None]), ref, dtype)  # [B,1,T,S] masks too

    logits = torch.einsum("btnh,bsh->btns", q.float(), k[:, :, 0].float())
    logits = torch.where(mask[:, :, None, :], logits, fa.BIG_NEG)
    valid = mask.any(dim=-1).repeat_interleave(8, dim=1)  # lse of fully masked rows is BIG_NEG-sized
    torch.testing.assert_close(lse[valid], torch.logsumexp(logits, dim=-1).reshape(1, -1)[valid], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mhsa_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = (torch.randn(3, 16, 256, 72, generator=g, device=cuda) / 72**0.5).to(dtype)
    k, v = (torch.randn(3, 16, 256, 72, generator=g, device=cuda).to(dtype) for _ in range(2))
    out, lse = fa.flash_mhsa_fwd(q, k, v)
    torch.cuda.synchronize()
    assert lse.shape == (3, 16, 256)
    _assert_close(out, fa.flash_mhsa_plain(q, k, v), dtype)
    torch.testing.assert_close(lse, torch.logsumexp(torch.einsum("bnth,bnsh->bnts", q.float(), k.float()), -1))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s", [(2, 37, 131), (3, 1, 64), (1, 130, 65)])
def test_ragged_shapes_and_random_masks(cuda, b, t, s):
    """Row tiles and key tiles that end mid-tile, batch > 1, rows with every key masked."""
    g = torch.Generator(device=cuda).manual_seed(b * t + s)
    q = torch.randn(b, t, 8, 256, generator=g, device=cuda) / 16
    k, v = (torch.randn(b, s, 1, 256, generator=g, device=cuda) for _ in range(2))
    mask = torch.rand(b, t, s, generator=g, device=cuda) < 0.5
    mask[:, ::3] = False  # fully masked rows
    _assert_close(fa.flash_mha(q, k, v, mask), fa.flash_mha_plain(q, k, v, mask), torch.float32)
    qh = torch.randn(b, 16, t, 72, generator=g, device=cuda) / 72**0.5
    kh, vh = (torch.randn(b, 16, s, 72, generator=g, device=cuda) for _ in range(2))
    _assert_close(fa.flash_mhsa(qh, kh, vh), fa.flash_mhsa_plain(qh, kh, vh), torch.float32)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 16, 8, 128, device=cuda)
    k = torch.randn(1, 16, 1, 128, device=cuda)
    mask = torch.ones(1, 16, 16, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_mha(q, k, k, mask)
    q = torch.randn(1, 16, 8, 256, device=cuda)
    k = torch.randn(1, 16, 1, 256, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_mha(q.half(), k.half(), k.half(), mask)
    with pytest.raises(ValueError, match="non-contiguous"):
        fa.flash_mha(q.transpose(1, 2).contiguous().transpose(1, 2), k, k, mask)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_mha(q, k, k, mask.float())
    with pytest.raises(ValueError, match="query heads"):
        fa.flash_mha(q[:, :, :4].contiguous().bfloat16(), k.bfloat16(), k.bfloat16(), mask)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_mhsa(*(torch.randn(1, 2, 64, 64, device=cuda) for _ in range(3)))


GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_grads_close(got, want, dtype):
    for name, a, b in zip("qkv", got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert scale > 0 and err <= GRAD_TOL[dtype] * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s", [(2, 37, 131), (1, 130, 65), (1, 968, 968)])
def test_flash_mha_bwd_matches_autograd_of_plain(cuda, dtype, b, t, s):
    """Ragged tiles, random masks with fully masked rows, and a dO that is non-zero on those rows."""
    g = torch.Generator(device=cuda).manual_seed(b * t + s)
    q = (torch.randn(b, t, 8, 256, generator=g, device=cuda) / 16).to(dtype)
    k, v = (torch.randn(b, s, 1, 256, generator=g, device=cuda).to(dtype) for _ in range(2))
    mask = _serving_mask(t, s, cuda) if t == s == 968 else torch.rand(b, t, s, generator=g, device=cuda) < 0.5
    if t != 968:
        mask[:, ::3] = False
    dout = torch.randn(b, t, 8, 256, generator=g, device=cuda).to(dtype)
    out, lse = fa.flash_mha_fwd(q, k, v, mask)
    before = fa.LAUNCHES["flash_mha_bwd"]
    got = fa.flash_mha_bwd(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_mha_bwd"] == before + 1
    _assert_grads_close(got, fa.flash_mha_bwd_plain(q, k, v, mask, dout), dtype)


def _training_mask(batch: int, device) -> torch.Tensor:
    """The joint [prefix, suffix] mask of a training step: padded prompts per sample, one camera masked in one."""
    valid = torch.ones(batch, 1018, dtype=torch.bool, device=device)
    valid[0, 512:768] = False
    for b in range(batch):
        valid[b, 768 + 40 + 30 * b : 968] = False
    return make_attn_mask(valid, torch.arange(1018, device=device) == 968)


def _bf16_mqa_case(b, t, s, device):
    """bf16 q, k, v, dO and a mask that differs per sample, with fully masked rows (the training mask at T=S=1018)."""
    g = torch.Generator(device=device).manual_seed(1000 * b + t + s)
    q = (torch.randn(b, t, 8, 256, generator=g, device=device) / 16).bfloat16()
    k, v = (torch.randn(b, s, 1, 256, generator=g, device=device).bfloat16() for _ in range(2))
    dout = torch.randn(b, t, 8, 256, generator=g, device=device).bfloat16()
    if t == s == 1018:
        mask = _training_mask(b, device)
    else:
        mask = torch.rand(b, t, s, generator=g, device=device) < torch.linspace(0.2, 0.8, b, device=device)[:, None, None]
        mask[:, ::3] = False
    return q, k, v, mask, dout


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s", [(2, 37, 131), (1, 50, 1018), (3, 4, 64), (2, 130, 65), (8, 1018, 1018)])
def test_bf16_tensor_core_mqa_matches_plain(cuda, b, t, s):
    """K1f and K1b in bf16 (the tensor-core kernels): ragged row and key tiles, masks that differ per sample,
    fully masked rows with a non-zero dO, a split key axis (the small shapes) and one at batch 8 (one split)."""
    q, k, v, mask, dout = _bf16_mqa_case(b, t, s, cuda)
    assert (~mask.any(dim=-1)).any(), "the case should hold fully masked rows"
    out, lse = fa.flash_mha_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    _assert_close(out, fa.flash_mha_plain(q, k, v, mask), torch.bfloat16)
    logits = torch.einsum("btnh,bsh->btns", q.float(), k[:, :, 0].float())
    logits = torch.where(mask[:, :, None, :], logits, fa.BIG_NEG)
    valid = mask.any(dim=-1).repeat_interleave(8, dim=1)
    torch.testing.assert_close(lse[valid], torch.logsumexp(logits, dim=-1).reshape(b, -1)[valid], rtol=1e-5, atol=1e-4)
    del logits
    got = fa.flash_mha_bwd(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    _assert_grads_close(got, fa.flash_mha_bwd_plain(q, k, v, mask, dout), torch.bfloat16)


@pytest.mark.cuda
def test_bf16_mqa_backward_is_deterministic(cuda):
    """No atomics: two backward calls on the same inputs give the same bits (the training step relies on it)."""
    q, k, v, mask, dout = _bf16_mqa_case(2, 1018, 1018, cuda)
    out, lse = fa.flash_mha_fwd(q, k, v, mask)
    first = fa.flash_mha_bwd(q, k, v, mask, out, lse, dout)
    second = fa.flash_mha_bwd(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", first, second, strict=True):
        assert torch.equal(a, b), f"d{name} differs between two calls"
    assert torch.equal(fa.flash_mha_fwd(q, k, v, mask)[0], out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 16, 256, 72), (1, 2, 37, 72)])
def test_flash_mhsa_bwd_matches_autograd_of_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[2])
    q = (torch.randn(shape, generator=g, device=cuda) / 72**0.5).to(dtype)
    k, v, dout = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    out, lse = fa.flash_mhsa_fwd(q, k, v)
    got = fa.flash_mhsa_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    _assert_grads_close(got, fa.flash_mhsa_bwd_plain(q, k, v, dout), dtype)


def _bf16_mhsa_case(b, n, t, s, device):
    """bf16 head-major q (scaled), k, v and dO with T query rows against S keys."""
    g = torch.Generator(device=device).manual_seed(100 * b + 10 * n + t + s)
    q = (torch.randn(b, n, t, 72, generator=g, device=device) / 72**0.5).bfloat16()
    k, v = (torch.randn(b, n, s, 72, generator=g, device=device).bfloat16() for _ in range(2))
    dout = torch.randn(b, n, t, 72, generator=g, device=device).bfloat16()
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,t,s", [(8, 16, 256, 256), (1, 2, 37, 37), (2, 3, 130, 65), (2, 3, 65, 130), (1, 1, 1, 3)])
def test_bf16_tensor_core_mhsa_matches_plain(cuda, b, n, t, s):
    """K2f and K2b in bf16 (the tensor-core kernels): the SigLIP shape at batch 8, row and key tiles that end
    mid-tile, T != S both ways, and a single query row (whose dq is not zero: S > 1)."""
    q, k, v, dout = _bf16_mhsa_case(b, n, t, s, cuda)
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_mhsa_fwd(q, k, v)
    got = fa.flash_mhsa_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_mhsa"] == before["flash_mhsa"] + 1
    assert fa.LAUNCHES["flash_mhsa_bwd"] == before["flash_mhsa_bwd"] + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and lse.shape == (b, n, t)
    _assert_close(out, fa.flash_mhsa_plain(q, k, v), torch.bfloat16)
    torch.testing.assert_close(lse, torch.logsumexp(torch.einsum("bnth,bnsh->bnts", q.float(), k.float()), -1),
                               rtol=1e-5, atol=1e-4)
    _assert_grads_close(got, fa.flash_mhsa_bwd_plain(q, k, v, dout), torch.bfloat16)


@pytest.mark.cuda
def test_bf16_mhsa_backward_is_deterministic(cuda):
    """No atomics: two backward calls on the same inputs give the same bits, and so do two forward calls."""
    q, k, v, dout = _bf16_mhsa_case(6, 16, 256, 256, cuda)
    out, lse = fa.flash_mhsa_fwd(q, k, v)
    first = fa.flash_mhsa_bwd(q, k, v, out, lse, dout)
    second = fa.flash_mhsa_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", first, second, strict=True):
        assert torch.equal(a, b), f"d{name} differs between two calls"
    again, lse_again = fa.flash_mhsa_fwd(q, k, v)
    assert torch.equal(again, out) and torch.equal(lse_again, lse)


@pytest.mark.cuda
def test_attention_on_the_card_passes_gradients(cuda):
    """A loss through ``mha`` / ``mhsa_dense_hm`` on CUDA reaches q, k and v, through the backward kernels."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = (torch.randn(1, 40, 8, 256, generator=g, device=cuda) / 16).requires_grad_()
    k, v = (torch.randn(1, 40, 1, 256, generator=g, device=cuda).requires_grad_() for _ in range(2))
    mask = make_attn_mask(torch.ones(1, 40, dtype=torch.bool, device=cuda), torch.arange(40, device=cuda) == 20)
    before = dict(fa.LAUNCHES)
    attention.mha(q, k, v, mask).square().sum().backward()
    qh, kh, vh = (torch.randn(1, 16, 64, 72, generator=g, device=cuda).requires_grad_() for _ in range(3))
    attention.mhsa_dense_hm(qh, kh, vh).square().sum().backward()
    torch.cuda.synchronize()
    for x in (q, k, v, qh, kh, vh):
        assert x.grad is not None and x.grad.abs().max().item() > 0
    assert {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES} == {
        "flash_mha": 1, "flash_mhsa": 1, "flash_mha_bwd": 1, "flash_mhsa_bwd": 1,
    }


def _q8_state(n_shape, device, gen):
    """Moments after two plain steps of random gradients, so every code and scale is in use."""
    mq = torch.zeros(n_shape, dtype=torch.int8, device=device)
    vq = torch.zeros(n_shape, dtype=torch.uint8, device=device)
    blocks = q8.num_blocks(mq.numel())
    ms, vs = torch.zeros(blocks, device=device), torch.zeros(blocks, device=device)
    for _ in range(2):
        g = torch.randn(n_shape, generator=gen, device=device) * 1e-3
        q8.adam_q8_leaf_plain(g, mq, ms, vq, vs, 1.0, 1e-8, 0, b1=0.9, b2=0.95, deterministic=True)
    return mq, ms, vq, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 2048), (3, 1000)])
def test_adam_q8_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(1)
    state = _q8_state(shape, cuda, gen)
    g = (torch.randn(shape, generator=gen, device=cuda) * 1e-3).to(dtype)
    for deterministic in (True, False):
        k_state = [x.clone() for x in state]
        p_state = [x.clone() for x in state]
        before = q8.LAUNCHES["adam_q8"]
        out = q8.adam_q8_leaf(g, *k_state, 1.7, 2e-8, 12345, b1=0.9, b2=0.95, deterministic=deterministic)
        ref = q8.adam_q8_leaf_plain(g, *p_state, 1.7, 2e-8, 12345, b1=0.9, b2=0.95, deterministic=deterministic)
        torch.cuda.synchronize()
        assert q8.LAUNCHES["adam_q8"] == before + 1
        assert out.dtype == dtype and out.shape == g.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-6, atol=0)
        for code_k, code_p in ((k_state[0], p_state[0]), (k_state[2], p_state[2])):
            diff = (code_k.int() - code_p.int()).abs()
            assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-5
        assert torch.equal(k_state[1], p_state[1]) and torch.equal(k_state[3], p_state[3])


def _q8_leaves(shapes, dtypes, device):
    """Gradients and moments after two plain steps for tensors of ``shapes`` (gradients of ``dtypes``)."""
    gen = torch.Generator(device=device).manual_seed(2)
    states = [_q8_state(shape, device, gen) for shape in shapes]
    gs = [(torch.randn(shape, generator=gen, device=device) * 1e-3).to(dtype) for shape, dtype in zip(shapes, dtypes)]
    return gs, states


# Tensors of 1,000, 3,000, 2,048, 64 x 2,048, 5 and 2,048 x 16,384 elements: tail blocks, whole blocks, one
# block, and Gemma-2B's FFN leaf.
_Q8_SHAPES = [(1000,), (3, 1000), (2048,), (64, 2048), (5,), (2048, 16384)]


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [True, False])
def test_adam_q8_leaves_matches_the_per_tensor_kernel(cuda, deterministic):
    dtypes = [torch.bfloat16, torch.float32, torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16]
    gs, states = _q8_leaves(_Q8_SHAPES, dtypes, cuda)
    seeds = [11, 12, 13, 14, 15, 2**31 - 2]
    k_states = [[x.clone() for x in s] for s in states]
    before = (q8.LAUNCHES["adam_q8"], q8.LEAVES["adam_q8"])
    outs = q8.adam_q8_leaves(gs, *([s[i] for s in k_states] for i in range(4)), 1.7, 2e-8, seeds, b1=0.9, b2=0.95,
                             deterministic=deterministic)
    torch.cuda.synchronize()
    assert (q8.LAUNCHES["adam_q8"], q8.LEAVES["adam_q8"]) == (before[0] + 1, before[1] + len(gs))
    for g, state, k_state, out, seed in zip(gs, states, k_states, outs, seeds):
        ref_state = [x.clone() for x in state]
        ref = q8.adam_q8_leaf(g, *ref_state, 1.7, 2e-8, seed, b1=0.9, b2=0.95, deterministic=deterministic)
        assert out.dtype == g.dtype and out.shape == g.shape and torch.equal(out, ref)
        assert all(torch.equal(a, b) for a, b in zip(k_state, ref_state))
        if deterministic:  # and the plain version's, as the per-tensor kernel's test holds it
            p_state = [x.clone() for x in state]
            plain = q8.adam_q8_leaf_plain(g, *p_state, 1.7, 2e-8, seed, b1=0.9, b2=0.95, deterministic=True)
            torch.testing.assert_close(out.float(), plain.float(), rtol=1e-6, atol=0)
            for code_k, code_p in ((k_state[0], p_state[0]), (k_state[2], p_state[2])):
                diff = (code_k.int() - code_p.int()).abs()
                assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-5
            assert torch.equal(k_state[1], p_state[1]) and torch.equal(k_state[3], p_state[3])


@pytest.mark.cuda
def test_adam_q8_leaves_in_place_and_unaligned(cuda):
    """Updates written over the gradients, and a gradient whose address is not 16-byte aligned (staged byte by byte)."""
    shapes = [(4097,), (2048,), (3, 2048)]
    gs, states = _q8_leaves(shapes, [torch.bfloat16, torch.bfloat16, torch.float32], cuda)
    seeds = [1, 2, 3]
    refs = []
    for g, state, seed in zip(gs, states, seeds):
        ref_state = [x.clone() for x in state]
        refs.append((q8.adam_q8_leaf(g, *ref_state, 1.7, 2e-8, seed, b1=0.9, b2=0.95), ref_state))
    storage = torch.zeros(2048 + 1, dtype=torch.bfloat16, device=cuda)
    storage[1:] = gs[1]
    unaligned = [gs[0], storage[1:], gs[2]]  # the second 2 bytes past an aligned address
    copies = [g.clone() for g in gs]
    for grads, out in ((unaligned, None), (copies, copies)):
        k_states = [[x.clone() for x in s] for s in states]
        outs = q8.adam_q8_leaves(grads, *([s[i] for s in k_states] for i in range(4)), 1.7, 2e-8, seeds, b1=0.9,
                                 b2=0.95, out=out)
        torch.cuda.synchronize()
        for k, (o, k_state, (ref, ref_state)) in enumerate(zip(outs, k_states, refs)):
            assert torch.equal(o, ref) and all(torch.equal(a, b) for a, b in zip(k_state, ref_state))
            assert out is None or o.data_ptr() == out[k].data_ptr()


def test_cpu_tensors_take_the_plain_path():
    q, k, v = torch.randn(1, 4, 8, 256), torch.randn(1, 6, 1, 256), torch.randn(1, 6, 1, 256)
    mask = torch.ones(1, 4, 6, dtype=torch.bool)
    before = dict(fa.LAUNCHES)
    torch.testing.assert_close(fa.flash_mha(q, k, v, mask), fa.flash_mha_plain(q, k, v, mask), rtol=0, atol=0)
    x = torch.randn(1, 2, 8, 72)
    torch.testing.assert_close(fa.flash_mhsa(x, x, x), fa.flash_mhsa_plain(x, x, x), rtol=0, atol=0)
    assert fa.LAUNCHES == before


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not list(tmp_path.glob("*.so"))


def test_library_is_named_by_the_sources(tmp_path, monkeypatch):
    name = _build.library_path().name
    assert name.startswith("kai0_kernels_") and name.endswith(".so")
    assert _build.library_path().parent == pathlib.Path(_build.BUILD_DIR)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.library_path().name == name
    (csrc / "flash_mqa_fwd.cu").write_text((csrc / "flash_mqa_fwd.cu").read_text() + "\n// changed\n")
    assert _build.library_path().name != name
