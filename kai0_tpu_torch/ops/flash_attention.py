"""Fused attention forward kernels and their plain PyTorch versions.

Counterpart of ``kai0_tpu/ops/pallas_attention.py``:

- ``flash_mha``: masked multi-query attention for the Gemma experts, q [B,T,N,H],
  one K/V head k/v [B,S,1,H], bool mask [B,T,S] or [B,1,T,S]
  (CUDA kernel ``csrc/flash_mqa_fwd.cu``, head_dim 256);
- ``flash_mhsa``: dense head-major attention for SigLIP, q/k/v [B,N,T,H], q
  pre-scaled (CUDA kernel ``csrc/flash_mhsa_fwd.cu``, head_dim 72).

A tensor on the CPU goes to the plain version (``flash_mha_plain``,
``flash_mhsa_plain``); a CUDA tensor goes to the kernel, and the wrapper raises
on anything the kernel does not take. ``LAUNCHES`` counts kernel launches per
wrapper (plain calls are not counted).
"""

from __future__ import annotations

import torch

from kai0_tpu_torch.ops import _build

BIG_NEG = -2.3819763e38  # Gemma's masking constant

# Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES = {"flash_mha": 0, "flash_mhsa": 0}

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


def flash_mha_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the MQA kernel: returns (out [B,T,N,H], lse f32 [B, T*N], rows t-major)."""
    _check_inputs(q, k, v)
    b, t, n, h = q.shape
    s = k.shape[1]
    _require(h == _MQA_HEAD_DIM, f"head_dim {h} (kernel built for {_MQA_HEAD_DIM})")
    _require(k.shape == (b, s, 1, h) and v.shape == k.shape, f"k/v shape {tuple(k.shape)} (need [B,S,1,H])")
    if mask.ndim == 4:
        _require(mask.shape[1] == 1, f"mask shape {tuple(mask.shape)}")
        mask = mask[:, 0]
    _require(mask.shape == (b, t, s), f"mask shape {tuple(mask.shape)} (need [{b},{t},{s}])")
    _require(mask.dtype == torch.bool and mask.device == q.device and mask.is_contiguous(), "mask must be a contiguous bool CUDA tensor")

    rows = b * t * n
    splits, chunk = _splits(b * -(-t * n // _ROWS_PER_BLOCK), s, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, t * n), dtype=torch.float32, device=q.device)
    part_acc, part_ml = _workspace(splits, rows, h, q.device)
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


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked MQA attention, q [B,T,N,H] (RoPE'd + scaled), k/v [B,S,1,H] -> [B,T,N,H]."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, mask)
    return flash_mha_fwd(q, k, v, mask)[0]


def flash_mhsa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dense MHA kernel: returns (out [B,N,T,H], lse f32 [B,N,T])."""
    _check_inputs(q, k, v)
    b, n, t, h = q.shape
    s = k.shape[2]
    _require(h == _MHSA_HEAD_DIM, f"head_dim {h} (kernel built for {_MHSA_HEAD_DIM})")
    _require(k.shape == (b, n, s, h) and v.shape == k.shape, f"k/v shape {tuple(k.shape)}")

    rows = b * n * t
    splits, chunk = _splits(b * n * -(-t // _ROWS_PER_BLOCK), s, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    part_acc, part_ml = _workspace(splits, rows, h, q.device)
    err = _build.load().kai0_flash_mhsa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        b * n, t, s, h, splits, chunk, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_mhsa_fwd launch failed: cudaError_t {err}")
    LAUNCHES["flash_mhsa"] += 1
    return out, lse


def flash_mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense (unmasked) MHA, head-major [B,N,T,H], q pre-scaled -> [B,N,T,H]."""
    if q.device.type == "cpu":
        return flash_mhsa_plain(q, k, v)
    return flash_mhsa_fwd(q, k, v)[0]
