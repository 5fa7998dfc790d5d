"""Per-row dynamic int8 quantization (kernel K5) and its plain PyTorch version.

Counterpart of ``kai0_tpu/ops/pallas_rowquant.py`` (``row_quant``) and of
``kai0_tpu/ops/quant.py:191-199`` (``_row_quant``): for a 2-D activation
``x [M, K]``, ``amax = max|x|`` per row (taken in x's dtype, then cast),
``s = max(amax, 1e-30) * (1/127)`` in f32 and codes ``round_half_even(x_f32 / s)``
as int8, so that ``x ≈ xq * sx``. Returns ``(xq int8 [M, K], sx f32 [M, 1])``.

With ``col_scale`` (f32 ``[K]``) the rows of ``x.float() * col_scale`` are
quantized instead: the straight-through backward's ``q_row(dy · s)``
(``kai0_tpu/ops/quant.py`` ``_bwd_dx``, ``_qbwd_col``), whose product the
kernel forms in registers, so that no f32 image of ``dy`` is written.

On a CUDA tensor ``row_quant`` launches ``csrc/row_quant.cu``; on a CPU tensor
it runs ``row_quant_plain``. The two are bit-equal (the kernel multiplies by
the column scale once, divides by s with IEEE division and rounds to nearest
even).

The scale is a product with the f32 constant 1/127, not a division by 127:
under jit, which is how the JAX package always runs it, XLA compiles
``/ 127.0`` to a multiplication by the reciprocal, one unit in the last place
off the true quotient on some rows. The port follows the jitted numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from kai0_tpu_torch.ops import _build

# Kernel launches since the last ``reset_launches()``: all of them, and those with a column scale.
LAUNCHES = {"row_quant": 0, "row_quant_colscale": 0}

INV_127 = float(np.float32(1.0) / np.float32(127.0))  # the f32 reciprocal that a jitted ``/ 127.0`` multiplies by


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def row_quant_plain(x: torch.Tensor, col_scale: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version, on any device."""
    if col_scale is not None:
        x = x.to(torch.float32) * col_scale
    sx = x.abs().amax(dim=-1, keepdim=True).to(torch.float32).clamp_min(1e-30) * INV_127
    xq = torch.round(x.to(torch.float32) / sx).to(torch.int8)
    return xq, sx


def row_quant(x: torch.Tensor, col_scale: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize the rows of ``x [M, K]`` (bf16 or f32), or of ``x.float() * col_scale`` (f32 ``[K]``).

    Kernel K5 on CUDA tensors, the plain version on CPU tensors.
    """
    if x.device.type == "cpu":
        return row_quant_plain(x, col_scale)
    if x.ndim != 2 or not x.is_contiguous() or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"row_quant kernel does not take x: {x.dtype} {tuple(x.shape)} strides {x.stride()}")
    m, k = x.shape
    if col_scale is not None and (col_scale.shape != (k,) or col_scale.dtype != torch.float32
                                  or col_scale.device != x.device or not col_scale.is_contiguous()):
        raise ValueError(f"row_quant kernel does not take col_scale: {col_scale.dtype} {tuple(col_scale.shape)} "
                         f"on {col_scale.device} for x {tuple(x.shape)}")
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    err = _build.load().kai0_row_quant(
        x.data_ptr(), None if col_scale is None else col_scale.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"row_quant launch failed: cudaError_t {err}")
    LAUNCHES["row_quant"] += 1
    if col_scale is not None:
        LAUNCHES["row_quant_colscale"] += 1
    return xq, sx
