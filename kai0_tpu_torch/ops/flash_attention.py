"""Fused attention kernels (forward and backward) and their plain PyTorch versions.

Counterpart of ``kai0_tpu/ops/pallas_attention.py``:

- ``flash_mha``: masked multi-query attention for the Gemma experts, q [B,T,N,H],
  one K/V head k/v [B,S,1,H], bool mask [B,T,S] or [B,1,T,S]
  (CUDA kernels ``csrc/flash_mqa_fwd.cu`` and ``csrc/flash_mqa_bwd.cu``,
  head_dim 256; bf16 runs on the tensor-core kernels of
  ``csrc/flash_mqa_mma.cuh`` and needs N >= 8, f32 on the scalar kernels by
  choice of dtype);
- ``flash_mhsa``: dense head-major attention for SigLIP, q/k/v [B,N,T,H], q
  pre-scaled (CUDA kernels ``csrc/flash_mhsa_fwd.cu`` and
  ``csrc/flash_mhsa_bwd.cu``, head_dim 72; bf16 runs on the tensor-core
  kernels of ``csrc/flash_mhsa_mma.cuh``, f32 on the scalar kernels).

On CUDA tensors both go through a ``torch.autograd.Function`` (``FlashMHA``,
``FlashMHSA``, the counterpart of the custom VJPs at ``pallas_attention.py:
290-328,484-508``): the forward kernel saves (q, k, v, mask, out, lse) and the
backward kernel recomputes P from the lse. A tensor on the CPU goes to the
plain version (``flash_mha_plain``, ``flash_mhsa_plain``) and autograd through
it; a CUDA tensor goes to the kernels, and the wrappers raise on anything the
kernels do not take. ``flash_mha_bwd_plain`` / ``flash_mhsa_bwd_plain`` are the
backward kernels' plain versions. ``LAUNCHES`` counts kernel launches per
wrapper (plain calls are not counted).
"""

from __future__ import annotations

import torch

from kai0_tpu_torch.ops import _build

BIG_NEG = -2.3819763e38  # Gemma's masking constant

# Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES = {"flash_mha": 0, "flash_mhsa": 0, "flash_mha_bwd": 0, "flash_mhsa_bwd": 0}

_KEYS_PER_TILE = 64  # kKeys in csrc/flash_fwd.cuh
_ROWS_PER_BLOCK = 64  # kRows
_MQA_HEAD_DIM = 256
_MHSA_HEAD_DIM = 72


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (the numerics the kernels are held to)
# ---------------------------------------------------------------------------


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention with f32 logits and softmax; returns [B, T, N, H].

    q [B,T,N,H] (RoPE'd, scaled), k/v [B,S,K,H], mask bool [B,T,S] or [B,1,T,S].
    Masked logits take ``BIG_NEG``, so a fully masked row is the uniform average
    of V. The probabilities are cast to q's dtype before P·V.
    """
    b, t, n, h = q.shape
    num_kv = k.shape[2]
    qg = q.reshape(b, t, num_kv, n // num_kv, h)
    logits = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
    if mask.ndim == 3:
        mask = mask[:, None]
    logits = torch.where(mask[:, :, None], logits, BIG_NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskh->btkgh", probs, v).reshape(b, t, n, h)


def flash_mhsa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense attention in head-major layout [B, N, T, H], f32 logits and softmax."""
    logits = torch.einsum("bnth,bnsh->bnts", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnts,bnsh->bnth", probs, v)


def _autograd_vjp(fn, inputs: tuple[torch.Tensor, ...], dout: torch.Tensor, *args) -> tuple[torch.Tensor, ...]:
    with torch.enable_grad():
        leaves = tuple(x.detach().requires_grad_() for x in inputs)
        return torch.autograd.grad(fn(*leaves, *args), leaves, dout)


def flash_mha_bwd_plain(q, k, v, mask, dout) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by autograd through ``flash_mha_plain``: the backward kernel's plain version."""
    return _autograd_vjp(flash_mha_plain, (q, k, v), dout, mask)


def flash_mhsa_bwd_plain(q, k, v, dout) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by autograd through ``flash_mhsa_plain``."""
    return _autograd_vjp(flash_mhsa_plain, (q, k, v), dout)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel does not take this input: {what}")


def _check_inputs(*tensors: torch.Tensor) -> None:
    q = tensors[0]
    _require(q.is_cuda, f"device {q.device} (CUDA tensors go to the kernel, CPU tensors to the plain version)")
    _require(q.dtype in (torch.float32, torch.bfloat16), f"dtype {q.dtype}")
    for x in tensors:
        _require(x.device == q.device and x.dtype == q.dtype, "q, k, v must share device and dtype")
        _require(x.is_contiguous(), "non-contiguous tensor")


def _splits(blocks: int, s: int, device: torch.device) -> tuple[int, int]:
    """Split the key axis until the grid covers about two waves of the SMs.

    Returns (splits, keys per split); every split holds at least one key.
    """
    tiles = -(-s // _KEYS_PER_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(tiles, -(-2 * sms // blocks)))
    chunk = -(-tiles // want) * _KEYS_PER_TILE
    return -(-s // chunk), chunk


def _workspace(splits: int, rows: int, h: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.empty((splits, rows, h), dtype=torch.float32, device=device),
        torch.empty((splits, rows, 2), dtype=torch.float32, device=device),
    )


def _mqa_mask(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Check the MQA kernels' inputs; return the mask as a contiguous bool [B,T,S]."""
    _check_inputs(q, k, v)
    b, t, n, h = q.shape
    s = k.shape[1]
    _require(h == _MQA_HEAD_DIM, f"head_dim {h} (kernel built for {_MQA_HEAD_DIM})")
    _require(k.shape == (b, s, 1, h) and v.shape == k.shape, f"k/v shape {tuple(k.shape)} (need [B,S,1,H])")
    _require(q.dtype == torch.float32 or n >= 8, f"{n} query heads (the bf16 kernels take 8 or more per K/V head)")
    if mask.ndim == 4:
        _require(mask.shape[1] == 1, f"mask shape {tuple(mask.shape)}")
        mask = mask[:, 0]
    _require(mask.shape == (b, t, s), f"mask shape {tuple(mask.shape)} (need [{b},{t},{s}])")
    _require(mask.dtype == torch.bool and mask.device == q.device and mask.is_contiguous(), "mask must be a contiguous bool CUDA tensor")
    return mask


def flash_mha_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the MQA kernel: returns (out [B,T,N,H], lse f32 [B, T*N], rows t-major)."""
    b, t, n, h = q.shape
    s = k.shape[1]
    mask = _mqa_mask(q, k, v, mask)
    rows = b * t * n
    splits, chunk = _splits(b * -(-t * n // _ROWS_PER_BLOCK), s, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, t * n), dtype=torch.float32, device=q.device)
    # The bf16 kernel writes out and lse itself when the key axis is not split.
    part_acc, part_ml = _workspace(splits if q.dtype == torch.float32 or splits > 1 else 0, rows, h, q.device)
    err = _build.load().kai0_flash_mqa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.view(torch.uint8).data_ptr(),
        out.data_ptr(), lse.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        b, t, s, n, h, splits, chunk, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_mqa_fwd launch failed: cudaError_t {err}")
    LAUNCHES["flash_mha"] += 1
    return out, lse


def flash_mha_bwd(q, k, v, mask, out, lse, dout) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the MQA backward kernel: returns (dq [B,T,N,H], dk, dv [B,S,1,H]) in the inputs' dtype."""
    b, t, n, h = q.shape
    s = k.shape[1]
    mask = _mqa_mask(q, k, v, mask)
    _check_inputs(q, out, dout)
    _require(out.shape == q.shape and dout.shape == q.shape, "out/dout must have q's shape")
    _require(lse.shape == (b, t * n) and lse.dtype == torch.float32 and lse.is_contiguous(), "lse must be f32 [B, T*N]")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, t * n), dtype=torch.float32, device=q.device)
    err = _build.load().kai0_flash_mqa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.view(torch.uint8).data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, s, n, h, int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_mqa_bwd launch failed: cudaError_t {err}")
    LAUNCHES["flash_mha_bwd"] += 1
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """MQA attention on the card: forward kernel K1f, backward kernel K1b."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, lse = flash_mha_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, mask, out, lse, dout.contiguous())
        return dq, dk, dv, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked MQA attention, q [B,T,N,H] (RoPE'd + scaled), k/v [B,S,1,H] -> [B,T,N,H]."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, mask)
    return FlashMHA.apply(q, k, v, mask)


def _mhsa_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_inputs(q, k, v)
    b, n, t, h = q.shape
    _require(h == _MHSA_HEAD_DIM, f"head_dim {h} (kernel built for {_MHSA_HEAD_DIM})")
    _require(b * n <= 65535, f"{b * n} (batch, head) pairs (the kernels' grid takes at most 65535)")
    _require(k.shape == (b, n, k.shape[2], h) and v.shape == k.shape, f"k/v shape {tuple(k.shape)}")


def flash_mhsa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dense MHA kernel: returns (out [B,N,T,H], lse f32 [B,N,T])."""
    _mhsa_check(q, k, v)
    b, n, t, h = q.shape
    s = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel takes the whole key axis and needs no workspace
        splits, chunk, work = 1, -(-s // _KEYS_PER_TILE) * _KEYS_PER_TILE, ()
    else:
        splits, chunk = _splits(b * n * -(-t // _ROWS_PER_BLOCK), s, q.device)
        work = _workspace(splits, b * n * t, h, q.device)
    part_ptrs = tuple(x.data_ptr() for x in work) or (None, None)
    err = _build.load().kai0_flash_mhsa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), *part_ptrs,
        b * n, t, s, h, splits, chunk, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_mhsa_fwd launch failed: cudaError_t {err}")
    LAUNCHES["flash_mhsa"] += 1
    return out, lse


def flash_mhsa_bwd(q, k, v, out, lse, dout) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dense MHA backward kernel: returns (dq, dk, dv), each [B,N,T,H] in the inputs' dtype."""
    _mhsa_check(q, k, v)
    _check_inputs(q, out, dout)
    b, n, t, h = q.shape
    s = k.shape[2]
    _require(out.shape == q.shape and dout.shape == q.shape, "out/dout must have q's shape")
    _require(lse.shape == (b, n, t) and lse.dtype == torch.float32 and lse.is_contiguous(), "lse must be f32 [B, N, T]")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    err = _build.load().kai0_flash_mhsa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * n, t, s, h, int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_mhsa_bwd launch failed: cudaError_t {err}")
    LAUNCHES["flash_mhsa_bwd"] += 1
    return dq, dk, dv


class FlashMHSA(torch.autograd.Function):
    """Dense head-major MHA on the card: forward kernel K2f, backward kernel K2b."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_mhsa_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_mhsa_bwd(q, k, v, out, lse, dout.contiguous())


def flash_mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense (unmasked) MHA, head-major [B,N,T,H], q pre-scaled -> [B,N,T,H]."""
    if q.device.type == "cpu":
        return flash_mhsa_plain(q, k, v)
    return FlashMHSA.apply(q, k, v)
