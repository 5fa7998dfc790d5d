"""The fused 8-bit blockwise AdamW step (kernel K3) and its plain PyTorch version.

Counterpart of ``kai0_tpu/ops/pallas_q8.py`` (``adam_q8_leaf``) and of the
codec in ``kai0_tpu/training/optimizer.py:129-168``. Each moment of a
parameter tensor is stored as codes of the tensor's shape plus one f32 scale
(the absmax) per block of 2048 elements of its row-major flattening: mu as
signed int8 codes of 127 levels, nu as uint8 codes of 255 levels, each level a
step of ``7·ln10/levels`` in log magnitude below the scale, code 0 exact zero.

``adam_q8_leaf`` decodes both moments, runs the f32 Adam recurrence, returns
the update ``a·m/(sqrt(v)+b)`` in g's dtype and re-encodes the new moments
with stochastic rounding in the log-index domain. It updates the codes and
scales **in place** (they are the optimizer state; this saves a copy of it).
On a CUDA tensor it launches ``csrc/adam_q8.cu``'s ``adam_q8_kernel``; on a
CPU tensor it runs ``adam_q8_leaf_plain``, which does the same operations in
the same order. ``adam_q8_leaves`` does the same for every tensor of a step
in one launch of ``adam_q8_leaves_kernel`` (the optimizer's path), from a
table of the tensors built by ``leaf_table``; its plain version is a loop of
``adam_q8_leaf_plain``.

The rounding draws u from Philox-4x32-10 keyed by (seed, 0), counter
(block·256 + t, e // 4, moment, 0) for element ``e·256 + t`` of a block, lane
``e % 4``, 24 bits. Both versions use it, so they agree in stochastic mode
too; the draws differ from the TPU's. ``deterministic=True`` sets u = 0.5.
Every tensor goes through the kernel, its tail block masked.
"""

from __future__ import annotations

from collections.abc import Sequence
import math

import numpy as np
import torch

from kai0_tpu_torch.ops import _build

QBLOCK = 2048
_THREADS = 256  # the kernel's threads per block; fixes the counter layout of the draws
LEVELS_S = 127.0  # signed mu codes
LEVELS_U = 255.0  # unsigned nu codes
DECADES = 7.0

# Kernel launches since the last ``reset_launches()``, and the tensors those launches updated.
LAUNCHES = {"adam_q8": 0}
LEAVES = {"adam_q8": 0}


def reset_launches() -> None:
    LAUNCHES["adam_q8"] = 0
    LEAVES["adam_q8"] = 0


def _step(levels: float) -> float:
    """The f32 log distance between adjacent codes, as the JAX package computes it."""
    return float(np.float32(DECADES * math.log(10.0) / levels))


def num_blocks(n: int) -> int:
    return -(-n // QBLOCK)


# ---------------------------------------------------------------------------
# Philox-4x32-10 on int64 tensors holding uint32 values
# ---------------------------------------------------------------------------

_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of a·b for a constant a and uint32 values b, without int64 overflow."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll, lh, hl = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = a_hi * b_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(c: list[torch.Tensor], key: tuple[int, int]) -> list[torch.Tensor]:
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c


def uniforms(seed: int, blocks: int, moment: int, device) -> torch.Tensor:
    """The kernel's draws u in [0, 1) for ``blocks`` blocks of one moment (0 = mu, 1 = nu): f32 [blocks, 2048]."""
    counter = torch.arange(blocks * _THREADS, dtype=torch.int64, device=device)
    zero = torch.zeros_like(counter)
    lanes = []
    for half in range(QBLOCK // _THREADS // 4):
        out = philox4x32_10([counter, zero + half, zero + moment, zero], (seed & _U32, 0))
        lanes.extend(out)  # element e = 4·half + lane
    bits = torch.stack(lanes, dim=0).view(-1, blocks, _THREADS)  # [8, blocks, 256]
    u = (bits >> 8).to(torch.float32) * (2.0**-24)
    return u.permute(1, 0, 2).reshape(blocks, QBLOCK)  # block position e·256 + t


# ---------------------------------------------------------------------------
# Codec (plain)
# ---------------------------------------------------------------------------


def _blocks(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    flat = x.reshape(-1).to(dtype)
    return torch.nn.functional.pad(flat, (0, num_blocks(flat.numel()) * QBLOCK - flat.numel())).view(-1, QBLOCK)


def _decode_blocks(q: torch.Tensor, scale: torch.Tensor, *, signed: bool) -> torch.Tensor:
    levels = LEVELS_S if signed else LEVELS_U
    qf = _blocks(q)
    mag = torch.exp((torch.abs(qf) - levels) * _step(levels)) * scale[:, None]
    val = torch.sign(qf) * mag if signed else mag
    return torch.where(qf == 0, 0.0, val)


def _encode_blocks(x: torch.Tensor, u, *, signed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes (int8 or uint8, [blocks, 2048]) and scales (f32 [blocks]) of f32 blocks x; u a tensor or 0.5."""
    levels = LEVELS_S if signed else LEVELS_U
    absx = torch.abs(x)
    scale = torch.amax(absx, dim=1)
    safe = torch.where(scale > 0, scale, 1.0)
    logmag = torch.log(torch.clamp_min(absx / safe[:, None], 1e-38)) / _step(levels) + levels
    code = torch.where(absx > 0, torch.clamp(torch.floor(logmag + u), 0.0, levels), 0.0)
    if signed:
        return (torch.sign(x) * code).to(torch.int8), scale
    return code.to(torch.uint8), scale


def q8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Decode codes of any shape (int8 = mu, uint8 = nu) with their block scales; f32 of q's shape."""
    val = _decode_blocks(q, scale, signed=q.dtype == torch.int8)
    return val.reshape(-1)[: q.numel()].view(q.shape)


def q8_encode(x: torch.Tensor, u, *, signed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode x (any shape) with draws u ([blocks, 2048] or 0.5); returns (codes of x's shape, scales)."""
    q, scale = _encode_blocks(_blocks(x), u, signed=signed)
    return q.reshape(-1)[: x.numel()].view(x.shape), scale


# ---------------------------------------------------------------------------
# The AdamW step of one tensor
# ---------------------------------------------------------------------------


def adam_q8_leaf_plain(g, mq, ms, vq, vs, a: float, b: float, seed: int, *, b1: float, b2: float, deterministic: bool):
    """The kernel's plain version: returns the update; writes the new codes and scales into mq, ms, vq, vs."""
    blocks = num_blocks(g.numel())
    gb = _blocks(g)
    m = b1 * _decode_blocks(mq, ms, signed=True) + (1 - b1) * gb
    v = b2 * _decode_blocks(vq, vs, signed=False) + (1 - b2) * (gb * gb)
    out = (a * m / (torch.sqrt(v) + b)).to(g.dtype)
    if deterministic:
        um = uv = 0.5
    else:
        um, uv = (uniforms(seed, blocks, moment, g.device) for moment in (0, 1))
    nmq, nms = _encode_blocks(m, um, signed=True)
    nvq, nvs = _encode_blocks(v, uv, signed=False)
    n = g.numel()
    mq.copy_(nmq.view(-1)[:n].view(mq.shape))
    vq.copy_(nvq.view(-1)[:n].view(vq.shape))
    ms.copy_(nms)
    vs.copy_(nvs)
    return out.reshape(-1)[:n].view(g.shape)


def _f32(x: float) -> float:
    return float(np.float32(x))


def adam_q8_leaf(g, mq, ms, vq, vs, a: float, b: float, seed: int, *, b1: float, b2: float, deterministic: bool = False):
    """One tensor's 8-bit AdamW step (kernel K3 on CUDA tensors, the plain version on CPU tensors).

    g: gradient (f32 or bf16); mq int8 / vq uint8 codes of g's shape; ms / vs f32
    [ceil(n/2048)] scales; a = sqrt(c2)/c1, b = eps·sqrt(c2) (f32 values); seed a
    non-negative 32-bit int. Returns the update in g's dtype; mq, ms, vq, vs are
    updated in place.
    """
    if g.device.type == "cpu":
        return adam_q8_leaf_plain(g, mq, ms, vq, vs, a, b, seed, b1=b1, b2=b2, deterministic=deterministic)
    n = g.numel()
    blocks = num_blocks(n)
    for name, x, dtype, numel in (
        ("g", g, None, n), ("mq", mq, torch.int8, n), ("vq", vq, torch.uint8, n),
        ("ms", ms, torch.float32, blocks), ("vs", vs, torch.float32, blocks),
    ):
        if x.device != g.device or not x.is_contiguous() or x.numel() != numel or (dtype is not None and x.dtype != dtype):
            raise ValueError(f"adam_q8 kernel does not take {name}: {x.dtype} {tuple(x.shape)} on {x.device}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"adam_q8 kernel does not take g of dtype {g.dtype}")
    out = torch.empty_like(g)
    err = _build.load().kai0_adam_q8(
        g.data_ptr(), mq.data_ptr(), ms.data_ptr(), vq.data_ptr(), vs.data_ptr(), out.data_ptr(), n,
        _f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2), _f32(a), _f32(b), _step(LEVELS_S), _step(LEVELS_U),
        seed & _U32, int(deterministic), int(g.dtype == torch.bfloat16),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"adam_q8 launch failed: cudaError_t {err}")
    LAUNCHES["adam_q8"] += 1
    LEAVES["adam_q8"] += 1
    return out


# ---------------------------------------------------------------------------
# The AdamW step of every tensor at once
# ---------------------------------------------------------------------------

def leaf_table(numels: Sequence[int]) -> tuple[list[int], int]:
    """The first block of each tensor among all tensors' 2048-element blocks (prefix sums), and the total."""
    firsts, total = [], 0
    for n in numels:
        if n <= 0:
            raise ValueError(f"adam_q8 takes tensors of at least one element, not {n}")
        firsts.append(total)
        total += num_blocks(n)
    return firsts, total


def adam_q8_leaves_plain(gs, mqs, mss, vqs, vss, a: float, b: float, seeds, *, b1: float, b2: float,
                         deterministic: bool, out=None) -> list[torch.Tensor]:
    """The all-tensors kernel's plain version: ``adam_q8_leaf_plain`` on each tensor with its seed."""
    updates = [
        adam_q8_leaf_plain(g, mq, ms, vq, vs, a, b, seed, b1=b1, b2=b2, deterministic=deterministic)
        for g, mq, ms, vq, vs, seed in zip(gs, mqs, mss, vqs, vss, seeds, strict=True)
    ]
    if out is None:
        return updates
    for o, u in zip(out, updates, strict=True):
        o.copy_(u)
    return list(out)


def adam_q8_leaves(gs, mqs, mss, vqs, vss, a: float, b: float, seeds, *, b1: float, b2: float,
                   deterministic: bool = False, out=None) -> list[torch.Tensor]:
    """``adam_q8_leaf`` over every tensor of a step: one launch of K3 on CUDA tensors, the plain loop on CPU tensors.

    ``gs``, ``mqs``, ``mss``, ``vqs``, ``vss`` and ``seeds`` are sequences with
    one entry a tensor, as ``adam_q8_leaf`` takes them; the codes and scales are
    updated in place. ``out``: tensors of the gradients' shapes and dtypes to
    write the updates into (they may be the gradients themselves), else new ones.
    Returns the updates.
    """
    gs = list(gs)
    if not gs:
        return []
    if gs[0].device.type == "cpu":
        return adam_q8_leaves_plain(gs, mqs, mss, vqs, vss, a, b, seeds, b1=b1, b2=b2, deterministic=deterministic,
                                    out=out)
    out = [torch.empty_like(g) for g in gs] if out is None else list(out)
    table, blocks = leaves_table(gs, mqs, mss, vqs, vss, out, seeds)
    launch_leaves(table, blocks, a, b, b1=b1, b2=b2, deterministic=deterministic)
    return out


def leaves_table(gs, mqs, mss, vqs, vss, out, seeds) -> tuple[torch.Tensor, int]:
    """The kernel's table of the tensors (int64 [tensors, 10] on their device, copied without a wait) and its blocks."""
    device = gs[0].device
    firsts, blocks = leaf_table([g.numel() for g in gs])
    i8, u8, f32, bf16 = torch.int8, torch.uint8, torch.float32, torch.bfloat16
    rows = []
    for g, mq, ms, vq, vs, o, seed, first in zip(gs, mqs, mss, vqs, vss, out, seeds, firsts, strict=True):
        n, dtype, nb = g.numel(), g.dtype, num_blocks(g.numel())
        if not (
            (dtype is bf16 or dtype is f32) and mq.dtype is i8 and vq.dtype is u8 and ms.dtype is f32
            and vs.dtype is f32 and o.dtype is dtype and mq.numel() == vq.numel() == o.numel() == n
            and ms.numel() == vs.numel() == nb and g.is_contiguous() and mq.is_contiguous() and vq.is_contiguous()
            and o.is_contiguous() and ms.is_contiguous() and vs.is_contiguous()
            and g.device == mq.device == vq.device == o.device == ms.device == vs.device == device
        ):
            raise ValueError("adam_q8 kernel does not take " + ", ".join(
                f"{x.dtype} {tuple(x.shape)} on {x.device}" for x in (g, mq, ms, vq, vs, o)))
        # a row of the kernel's table: ``Q8Leaf`` in csrc/adam_q8.cu
        rows.append((g.data_ptr(), mq.data_ptr(), ms.data_ptr(), vq.data_ptr(), vs.data_ptr(), o.data_ptr(), n, first,
                     seed & _U32, int(dtype is bf16)))
    return torch.tensor(rows, dtype=torch.int64).pin_memory().to(device, non_blocking=True), blocks


def launch_leaves(table: torch.Tensor, blocks: int, a: float, b: float, *, b1: float, b2: float,
                  deterministic: bool = False) -> None:
    """One launch of K3 over the tensors of a ``leaves_table``."""
    err = _build.load().kai0_adam_q8_leaves(
        table.data_ptr(), table.shape[0], blocks, _f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2), _f32(a), _f32(b),
        _step(LEVELS_S), _step(LEVELS_U), int(deterministic), torch.cuda.current_stream(table.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"adam_q8_leaves launch failed: cudaError_t {err}")
    LAUNCHES["adam_q8"] += 1
    LEAVES["adam_q8"] += table.shape[0]
