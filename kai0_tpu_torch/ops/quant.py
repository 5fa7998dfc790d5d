"""Int8 matrix products: a frozen int8 base (the LoRA fine-tune, int8 serving) and SwitchBack on weights that train.

Counterpart of ``kai0_tpu/ops/quant.py``. A frozen matmul weight is quantized
once (symmetric, one f32 scale per output channel) and every product with it
runs int8 x int8 -> int32: activations (and, in the backward, incoming
gradients) are quantized per row at each call,
``y ≈ (q_row(x) @ Wq) * s_x * s_w``, with a straight-through estimator through
the rounding (SwitchBack, arXiv:2304.13013). Weights that train (the full
fine-tune's Gemma, the SigLIP tower) take the same products over codes made at
each call (``SwitchBackLinear``, ``sb_fused_ffn``): forward and ``dx`` in
int8, ``dW`` a product of bf16 operands summed in f32 and rounded once. With
``weight_only`` a holder's forward casts its codes to the activation dtype
and runs one product summed in f32, scaled per column, rounded once; nothing
of the activations is quantized, and ``dx`` stays int8 (``wo_chunk`` and
``_bwd_dx`` of the JAX package).

``QuantLinear`` holds one quantized weight as ``nn.Linear`` lays it out:
``qweight`` int8 ``[out, in]``, ``scale`` f32 ``[out]`` and, for SigLIP's
sites, the layer's bias. JAX's ``QuantArray.q`` is the transpose,
``[in, out]``, per layer; a stacked JAX leaf (``kv_einsum``,
``gating_einsum``) is quantized per column, so its column blocks are the
port's ``k_proj`` / ``v_proj`` and ``gate_proj`` / ``up_proj`` weights value
for value. JAX applies ``gating_einsum`` slice by slice, so gate and up get a
holder each; it applies ``kv_einsum`` as one product, whose backward quantizes
the rows of ``[dk·s | dv·s]`` with one scale a row, so K and V share one
holder, ``kv_proj`` (K's rows, then V's), which takes the place of ``k_proj``
and ``v_proj`` on the attention module; under SwitchBack the two weights stay
separate parameters and go through one product, concatenated.

The modes are module swaps (``quantize_frozen_tree``,
``quantize_inference_tree``, ``switchback_tree``) that keep every parameter's
name; which sites they take is an argument (``kai0_tpu_torch.knobs`` resolves
the run's settings). On CUDA tensors every row quantization is kernel K5
(``row_quant``; a weight's per-call column quantization is K5 over the rows
of the stored ``[out, in]`` weight), every forward product K4b
(``int8_matmul``, the ``nt`` orientation over the stored weight) or, for the
gate, up and down products of the fused FFN with LoRA factors, K4a
(``int8_matmul_lora``), and every ``dx`` K4b in its other orientation over the
same stored weight. On CPU tensors the same wrappers run their plain versions.
The small LoRA products around the kernels, the weight gradients and the
weight-only products are ``torch.mm`` (cuBLAS), as JAX leaves them to XLA.
Rows are independent, so the fused FFNs walk over row chunks sized to keep
their widest intermediates, the backward's f32 images of ``[rows, mlp_dim]``
(the LoRA gradients' operands, and ``dy·s`` on the CPU), within
``_CHUNK_BYTES``; chunking changes no value but the f32 summation order of the
weight and LoRA gradients.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
import re
from typing import NamedTuple

import torch
from torch import nn
import torch.nn.functional as F

from kai0_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_lora
from kai0_tpu_torch.ops.row_quant import INV_127, row_quant
from kai0_tpu_torch.param_paths import jax_param_path

_CHUNK_BYTES = 512 * 2**20  # of one f32 [rows, mlp_dim] intermediate: 8192 rows at Gemma-2B's mlp_dim of 16384


class QuantLinear(nn.Module):
    """A frozen ``nn.Linear`` weight as int8 codes and per-output-channel f32 scales, and the layer's bias.

    ``weight ≈ qweight * scale[:, None]``; ``orig_dtype`` is the dtype the
    weight had, which ``dequantize`` restores. The scales stay f32 when the
    model is cast to another dtype. The bias (SigLIP's sites) stays a frozen
    parameter, added after the product by the model. ``weight_only`` selects
    the weight-only forward (``_QMM``).
    """

    def __init__(self, qweight: torch.Tensor, scale: torch.Tensor, orig_dtype: torch.dtype,
                 bias: torch.Tensor | None = None, *, weight_only: bool = False):
        super().__init__()
        if qweight.dtype != torch.int8 or qweight.ndim != 2 or scale.shape != (qweight.shape[0],):
            raise ValueError(f"QuantLinear takes int8 [out, in] codes and [out] scales, not {qweight.dtype} "
                             f"{tuple(qweight.shape)}, {tuple(scale.shape)}")
        if bias is not None and bias.shape != scale.shape:
            raise ValueError(f"QuantLinear takes an [out] bias, not {tuple(bias.shape)}")
        self.register_buffer("qweight", qweight.contiguous())
        self.register_buffer("scale", scale.to(torch.float32).contiguous())
        self.register_parameter("bias", None if bias is None else nn.Parameter(bias.detach(), requires_grad=False))
        self.orig_dtype = orig_dtype
        self.weight_only = weight_only

    @property
    def out_features(self) -> int:
        return self.qweight.shape[0]

    @property
    def in_features(self) -> int:
        return self.qweight.shape[1]

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        if self.scale.dtype != torch.float32:  # a dtype cast of the model: keep the exact f32 scales
            self.scale = scale.to(self.scale.device)
        return self

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}, "
                f"orig_dtype={self.orig_dtype}, weight_only={self.weight_only}")


def is_quant(x) -> bool:
    return isinstance(x, QuantLinear)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes int8 ``[out, in]`` and scales f32 ``[out]`` of a weight ``[out, in]`` (``quantize_einsum_weight``).

    ``s = max(amax * (1/127), 1e-30)``: the product is what JAX's ``/ 127.0`` compiles to (see ``ops.row_quant``).
    """
    w32 = w.detach().to(torch.float32)
    s = torch.clamp_min(w32.abs().amax(dim=1) * INV_127, 1e-30)
    q = torch.round(w32 / s[:, None]).to(torch.int8)
    return q, s


def quantize_linear(layer: nn.Linear, *, weight_only: bool = False) -> QuantLinear:
    q, s = quantize_weight(layer.weight)
    return QuantLinear(q, s, layer.weight.dtype, layer.bias, weight_only=weight_only)


def dequantize(ql: QuantLinear) -> torch.Tensor:
    """The represented weight ``[out, in]`` in its original dtype."""
    return (ql.qweight.to(torch.float32) * ql.scale[:, None]).to(ql.orig_dtype)


def sq_norm(ql: QuantLinear) -> torch.Tensor:
    """Squared Frobenius norm of the represented weight without dequantizing: sum_j s_j² · sum_i q_ij²."""
    q = ql.qweight.to(torch.int32)
    qsq = torch.sum(q * q, dim=1)  # K · 127² < 2³¹
    return torch.sum(qsq.to(torch.float32) * ql.scale * ql.scale)


# ---------------------------------------------------------------------------
# y = q_row(x) @ (q · s), straight-through d/dx
# ---------------------------------------------------------------------------


class _Codes(NamedTuple):
    """A weight's int8 codes ``[out, in]`` and f32 scales ``[out]``: a ``QuantLinear``'s, or made at this call."""

    qweight: torch.Tensor
    scale: torch.Tensor
    weight_only: bool = False


def _col_codes(w: torch.Tensor, weight_only: bool = False) -> _Codes:
    """The per-call quantization of a weight that trains (``_col_quant``): K5 over the rows of ``w [out, in]``.

    ``s = max(amax, 1e-30) · f32(1/127)``, K5's order: the clamp before the
    product, where ``quantize_weight`` clamps after it.
    """
    q, s = row_quant(w.contiguous())
    return _Codes(q, s.view(-1), weight_only)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in f32 and written in f32, whatever the operands' dtype (bf16 products are exact in f32).

    On CUDA ``torch.mm(..., out_dtype=torch.float32)`` (cuBLAS, f32 output: no
    bf16 rounding of split-K partials); on the CPU, which has no such overload,
    the f32 images of the operands.
    """
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def _weight_only(x2: torch.Tensor, codes, add: torch.Tensor | None) -> torch.Tensor:
    """``wo_chunk``: ``x2 @ q`` with q cast to x's dtype (exact), summed in f32, times the column scales, plus
    ``add`` in f32, rounded once to x's dtype."""
    y = _mm_f32(x2, codes.qweight.to(x2.dtype).T) * codes.scale
    if add is not None:
        y = y + add.to(torch.float32)
    return y.to(x2.dtype)


def _forward_product(x2: torch.Tensor, codes, add: torch.Tensor | None = None) -> torch.Tensor:
    """``_qmm_fwd_impl``: ``q_row(x2) @ qᵀ`` scaled by both scales (K5, K4b), ``add`` joined in f32 before the one
    rounding to x's dtype; or the weight-only product."""
    if codes.weight_only:
        return _weight_only(x2, codes, add)
    xq, sx = row_quant(x2)
    if add is None:
        return int8_matmul(xq, codes.qweight, sx, codes.scale, nt=True, out_dtype=x2.dtype)
    y = int8_matmul(xq, codes.qweight, sx, codes.scale, nt=True, out_dtype=torch.float32)
    return (y + add.to(torch.float32)).to(x2.dtype)


def _dx(ql, dy: torch.Tensor) -> torch.Tensor:
    """dL/dx of a quantized product, straight-through: ``q_row(dy · s) @ q`` with the row scale in the epilogue.

    ``ql`` is a ``QuantLinear`` or ``_Codes``. ``dy · s`` is f32; on CUDA K5
    forms it in registers from ``dy``, on the CPU the plain version writes it.
    """
    gq, sg = row_quant(dy, col_scale=ql.scale)
    return int8_matmul(gq, ql.qweight, sg, None, nt=False, out_dtype=dy.dtype)


class _QMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, add, ql):
        ctx.ql = ql
        return _forward_product(x2, ql, add)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        return _dx(ctx.ql, dy), (dy if ctx.needs_input_grad[1] else None), None


def qmm(x2: torch.Tensor, ql: QuantLinear, add: torch.Tensor | None = None) -> torch.Tensor:
    """``x2 [M, K]`` times the quantized weight, plus ``add [M, N]`` when given; the weight gets no gradient."""
    return _QMM.apply(x2.contiguous(), add, ql)


def linear(x: torch.Tensor, ql: QuantLinear, add: torch.Tensor | None = None) -> torch.Tensor:
    """``qmm`` over the leading axes of ``x [..., K]`` (``apply_quant_einsum`` for a flattened projection)."""
    y = qmm(x.reshape(-1, x.shape[-1]), ql, None if add is None else add.reshape(-1, add.shape[-1]))
    return y.view(*x.shape[:-1], -1)


# ---------------------------------------------------------------------------
# SwitchBack: a product over a weight that trains
# ---------------------------------------------------------------------------


def _wgrad(dy: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """dL/dW ``[N, K] = dyᵀ x``: the operands' products summed in f32, rounded once to x's dtype."""
    return _mm_f32(dy.T, x2).to(x2.dtype)


class _SwitchBack(torch.autograd.Function):
    """``_make_switchback``: forward over the weight's per-call codes (K5 on x and on w, K4b ``nt``), the
    straight-through ``dx`` (K5 with the column scale, K4b ``nn``) and a bf16 ``dW`` summed in f32."""

    @staticmethod
    def forward(ctx, x2, w, weight_only):
        codes = _col_codes(w, weight_only)
        # x for dW, the codes (half the weight's bf16 bytes) for dx; saved, so a recomputed block drops them.
        ctx.save_for_backward(x2, codes.qweight, codes.scale)
        return _forward_product(x2, codes)

    @staticmethod
    def backward(ctx, dy):
        x2, q, s = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _dx(_Codes(q, s), dy) if ctx.needs_input_grad[0] else None
        return dx, (_wgrad(dy, x2) if ctx.needs_input_grad[1] else None), None


class SwitchBackLinear(nn.Linear):
    """An ``nn.Linear`` whose products run SwitchBack (``switchback_einsum``): the same parameters, under the
    same names, as the layer it replaces (``switchback_tree``). ``weight_only`` takes the weight-only forward."""

    weight_only: bool = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = switchback_linear(x, self.weight, self.weight_only)
        return y if self.bias is None else y + self.bias.to(x.dtype)


def switchback_linear(x: torch.Tensor, weight: torch.Tensor, weight_only: bool = False) -> torch.Tensor:
    """``x [..., in] @ weightᵀ`` by SwitchBack, in x's dtype; the weight (``[out, in]``) is cast to it first."""
    y = _SwitchBack.apply(x.reshape(-1, x.shape[-1]).contiguous(), weight.to(x.dtype), weight_only)
    return y.view(*x.shape[:-1], -1)


def switchback_joint(x: torch.Tensor, layers) -> torch.Tensor:
    """One SwitchBack product over the rows of several layers' weights, concatenated: JAX's stacked
    ``kv_einsum`` (one scale a row of ``[dk·s | dv·s]`` in the backward); each weight gets its slice of dW."""
    weight = torch.cat([layer.weight.to(x.dtype) for layer in layers], dim=0)
    return switchback_linear(x, weight, layers[0].weight_only)


def is_switchback(layer) -> bool:
    return isinstance(layer, SwitchBackLinear)


def product(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """``x [..., in] -> [..., out]`` in x's dtype, without the bias, by the layer's route: the frozen int8 product
    of a ``QuantLinear``, SwitchBack for a ``SwitchBackLinear``, else ``x @ Wᵀ``."""
    if is_quant(layer):
        return linear(x, layer)
    if is_switchback(layer):
        return switchback_linear(x, layer.weight, layer.weight_only)
    return x @ layer.weight.to(x.dtype).T


# ---------------------------------------------------------------------------
# Fused gated FFN (gate | up -> gelu · up -> down) with a hand-written backward
# ---------------------------------------------------------------------------


def _project(xq, sx, x_c, ql, a, b) -> torch.Tensor:
    """One projection of a row chunk over a holder or per-call ``_Codes``: K4a with LoRA factors, K4b without."""
    if a is None:
        return int8_matmul(xq, ql.qweight, sx, ql.scale, nt=True, out_dtype=x_c.dtype)
    return int8_matmul_lora(xq, ql.qweight, sx, ql.scale, x_c @ a, b, out_dtype=x_c.dtype)


def _row_chunks(m: int, mlp_dim: int) -> list[tuple[int, int]]:
    """Even row spans of ``[m, mlp_dim]``, each at most ``_CHUNK_BYTES`` in f32."""
    count = max(1, -(-m // max(1, _CHUNK_BYTES // (4 * mlp_dim))))
    rows = -(-m // count)
    return [(i, min(i + rows, m)) for i in range(0, m, rows)]


def _ffn_forward(x2: torch.Tensor, layers, lora) -> torch.Tensor:
    """The fused FFN's forward over row chunks; ``layers`` are holders or per-call ``_Codes``."""
    gate, up, down = layers
    ag, bg, au, bu, ad, bd = lora if lora else (None,) * 6
    out = []
    for lo, hi in _row_chunks(x2.shape[0], gate.qweight.shape[0]):
        x_c = x2[lo:hi]
        xq, sx = row_quant(x_c)
        act = F.gelu(_project(xq, sx, x_c, gate, ag, bg), approximate="tanh") * _project(xq, sx, x_c, up, au, bu)
        aq, sa = row_quant(act)
        out.append(_project(aq, sa, act, down, ad, bd))
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)


def _ffn_backward(x2: torch.Tensor, dy: torch.Tensor, layers, lora, weight_grads: bool):
    """The fused FFN's backward over row chunks, gate, up and act re-derived a chunk at a time.

    Returns ``dx``, the six LoRA gradients (with ``lora``) and, with
    ``weight_grads``, dW of gate, up and down (``[F, D]``, ``[F, D]``,
    ``[D, F]``), each summed in f32 over the rows and the chunks and cast to
    dy's dtype at the end.
    """
    gate_l, up_l, down_l = layers
    ag, bg, au, bu, ad, bd = lora if lora else (None,) * 6
    dy = dy.contiguous()
    f32 = torch.float32
    acc = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in lora]
    acc_w = [torch.zeros(layer.qweight.shape, dtype=f32, device=x2.device) for layer in layers] if weight_grads else []
    dxs = []
    for lo, hi in _row_chunks(x2.shape[0], gate_l.qweight.shape[0]):
        x_c, dy_c = x2[lo:hi], dy[lo:hi]
        xq, sx = row_quant(x_c)
        gate = _project(xq, sx, x_c, gate_l, ag, bg)
        up = _project(xq, sx, x_c, up_l, au, bu)
        with torch.enable_grad():
            gate_in = gate.detach().requires_grad_()
            gel = F.gelu(gate_in, approximate="tanh")
        act = gel.detach() * up
        # down backward (the row quantization of act is straight-through, like qmm's).
        dact = _dx(down_l, dy_c)
        if lora:
            pd_back = dy_c @ bd.T  # [rows, r]
            dact = dact + pd_back @ ad.T
        dup = dact * gel.detach()
        (dgate,) = torch.autograd.grad(gel, gate_in, dact * up)
        dx_c = _dx(gate_l, dgate) + _dx(up_l, dup)
        if lora:
            pg, pu = dgate @ bg.T, dup @ bu.T
            dx_c = dx_c + pg @ ag.T + pu @ au.T
            xt = x_c.T.to(f32)
            for total, lhs, rhs in (
                (acc[0], xt, pg), (acc[1], (x_c @ ag).T.to(f32), dgate),
                (acc[2], xt, pu), (acc[3], (x_c @ au).T.to(f32), dup),
                (acc[4], act.T.to(f32), pd_back), (acc[5], (act @ ad).T.to(f32), dy_c),
            ):
                total += lhs @ rhs.to(f32)  # f32 accumulation over the rows, and over the chunks
        for total, lhs, rhs in zip(acc_w, (dgate, dup, dy_c), (x_c, x_c, act)):
            total += _mm_f32(lhs.T, rhs)  # SwitchBack's dW: bf16 operands, f32 sums (``_make_sb_fused_ffn``)
        dxs.append(dx_c)
    dx = dxs[0] if len(dxs) == 1 else torch.cat(dxs, dim=0)
    return dx, [g.to(dy.dtype) for g in acc], [g.to(dy.dtype) for g in acc_w]


class _FusedFFN(torch.autograd.Function):
    """``_make_fused_ffn`` of the JAX package: saves only the input; the backward re-derives gate, up and act."""

    @staticmethod
    def forward(ctx, x2, gate, up, down, *lora):
        ctx.layers = (gate, up, down)
        ctx.save_for_backward(x2, *lora)
        return _ffn_forward(x2, (gate, up, down), lora)

    @staticmethod
    def backward(ctx, dy):
        x2, *lora = ctx.saved_tensors
        dx, lora_grads, _ = _ffn_backward(x2, dy, ctx.layers, lora, weight_grads=False)
        return (dx, None, None, None, *lora_grads)


def apply_fused_ffn(gate: QuantLinear, up: QuantLinear, down: QuantLinear, x: torch.Tensor, lora_params=None):
    """Gated-GELU FFN on quantized weights as one op with a hand-written backward.

    ``lora_params`` are the (unscaled) factors ``(a_gate [D, r], b_gate [r, F],
    a_up, b_up, a_down [F, r], b_down [r, D])`` or None; they are cast to x's
    dtype, and their gradients accumulate in f32 and are cast at the end.
    """
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    lora = () if lora_params is None else tuple(p.to(x.dtype) for p in lora_params)
    return _FusedFFN.apply(x2, gate, up, down, *lora).view(*x.shape[:-1], -1)


class _SBFusedFFN(torch.autograd.Function):
    """``_make_sb_fused_ffn``: the fused FFN over weights that train. The forward quantizes each weight once (K5
    over its rows) and saves the input with the codes; the backward re-derives gate, up and act a chunk at a time
    and sums dW of all three in f32 over the chunks."""

    @staticmethod
    def forward(ctx, x2, wg, wu, wd):
        layers = [_col_codes(w) for w in (wg, wu, wd)]
        ctx.save_for_backward(x2, *(t for codes in layers for t in codes[:2]))
        return _ffn_forward(x2, layers, ())

    @staticmethod
    def backward(ctx, dy):
        x2, qg, sg, qu, su, qd, sd = ctx.saved_tensors
        dx, _, weight_grads = _ffn_backward(
            x2, dy, (_Codes(qg, sg), _Codes(qu, su), _Codes(qd, sd)), (), weight_grads=True)
        return (dx, *weight_grads)


def sb_fused_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Gated-GELU FFN over trainable weights (``[F, D]``, ``[F, D]``, ``[D, F]``, cast to x's dtype) as one
    SwitchBack op: forward and ``dx`` in int8 over per-call codes, dW summed in f32; no ``[rows, mlp_dim]``
    intermediate outlives its chunk."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return _SBFusedFFN.apply(x2, *(w.to(x.dtype) for w in (wg, wu, wd))).view(*x.shape[:-1], -1)


# ---------------------------------------------------------------------------
# Model-level transforms
# ---------------------------------------------------------------------------

# Path-suffix patterns of the matmul weights, on the JAX parameter paths the
# port's names map to (``kai0_tpu_torch.param_paths.jax_param_path``): the
# pattern texts of ``_GEMMA_QUANT_SITES`` and ``_SIGLIP_QUANT_SITES``, whose
# substrings the site selections below read as JAX reads them.
GEMMA_QUANT_SITES: tuple[re.Pattern, ...] = (
    re.compile(r"attn/qkv_einsum(_\d+)?/w$"),
    re.compile(r"attn/q_einsum(_\d+)?/w$"),
    re.compile(r"attn/kv_einsum(_\d+)?/w$"),
    re.compile(r"attn/attn_vec_einsum(_\d+)?/w$"),
    re.compile(r"mlp(_\d+)?/gating_einsum$"),
    re.compile(r"mlp(_\d+)?/linear$"),
)
SIGLIP_QUANT_SITES: tuple[re.Pattern, ...] = (
    re.compile(r"img/Transformer/encoderblock/MultiHeadDotProductAttention_0/(query|key|value)/kernel$"),
    re.compile(r"img/Transformer/encoderblock/MultiHeadDotProductAttention_0/out/kernel$"),
    re.compile(r"img/Transformer/encoderblock/MlpBlock_0/Dense_0/kernel$"),
    re.compile(r"img/Transformer/encoderblock/MlpBlock_0/Dense_1/kernel$"),
    re.compile(r"img/head/kernel$"),
)
# The sites of the SwitchBack switches (``switchback_gemma_enabled``, ``switchback_enabled``).
SWITCHBACK_SITES = {
    "gemma": {"attn": GEMMA_QUANT_SITES[:4], "ffn": GEMMA_QUANT_SITES[4:]},
    "siglip": {"attn": SIGLIP_QUANT_SITES[:2], "mlp": SIGLIP_QUANT_SITES[2:4], "head": SIGLIP_QUANT_SITES[4:]},
}
_OFF, _ON = ("0", "false", "off", "no", ""), ("1", "true", "on", "yes", "all")


def switchback_on(spec: str, site: str) -> bool:
    """Whether a SwitchBack spec (``0`` / ``1`` / ``all`` or a comma list of sites) selects ``site``, as JAX
    reads ``KAI0_INT8_SB`` and ``KAI0_INT8_SB_GEMMA``."""
    if spec.lower() in _OFF:
        return False
    return spec.lower() in _ON or site in spec.split(",")


def gemma_sites(spec: str | None, default_spec: str = "all") -> tuple[re.Pattern, ...]:
    """The Gemma sites of ``KAI0_INT8_SITES`` (``_active_sites``): comma-separated substrings of the site patterns,
    a leading ``-`` excluding; ``all`` or nothing selects every site. A token that matches no site raises."""
    spec = spec or default_spec
    if not spec or spec == "all":
        return GEMMA_QUANT_SITES
    keys = [k.strip() for k in spec.split(",") if k.strip()]
    neg = [k[1:] for k in keys if k.startswith("-")]
    pos = [k for k in keys if not k.startswith("-")]
    for k in pos + neg:
        if not any(k in p.pattern for p in GEMMA_QUANT_SITES):
            raise ValueError(f"KAI0_INT8_SITES token {k!r} matches no gemma quant site pattern")
    return tuple(p for p in GEMMA_QUANT_SITES
                 if (not pos or any(k in p.pattern for k in pos)) and not any(k in p.pattern for k in neg))


def siglip_inference_sites(spec: str) -> tuple[re.Pattern, ...]:
    """The SigLIP sites of int8 serving (``KAI0_INT8_SIGLIP``, ``_siglip_inference_sites``): ``0`` none,
    ``1`` / ``all`` every one, else a comma list of ``attn``, ``mlp``, ``head`` (or pattern substrings).
    A token that selects nothing raises."""
    spec = spec.strip().lower()
    if spec in _OFF:
        return ()
    if spec in _ON:
        return SIGLIP_QUANT_SITES
    words = {"attn": "Attention", "mlp": "Mlp", "head": "head/kernel"}
    want = []
    for token in (t.strip() for t in spec.split(",")):
        if not token:
            continue
        text = words.get(token, token)
        if not any(text in p.pattern for p in SIGLIP_QUANT_SITES):
            raise ValueError(f"KAI0_INT8_SIGLIP token {token!r} selects no SigLIP quant site "
                             f"(expected one of {sorted(words)}, 'all', or '0')")
        want.append(text)
    return tuple(p for p in SIGLIP_QUANT_SITES if any(w in p.pattern for w in want))


# Port layers that JAX holds and applies as one matrix: (members, in JAX's column order) -> the joint holder.
JOINT_HOLDERS = {("k_proj", "v_proj"): "kv_proj"}


def _site_path(prefix: str, attr: str, child, sites) -> str | None:
    """The JAX path of ``child``'s weight when it is a plain ``nn.Linear`` at one of ``sites``, else None."""
    if type(child) is not nn.Linear and not is_switchback(child):
        return None
    path = jax_param_path(f"{prefix}.{attr}.weight" if prefix else f"{attr}.weight")
    return path if any(p.search(path) for p in sites) else None


def quantize_frozen_tree(model: nn.Module, trainable_mask: Mapping[str, bool] | Callable[[str], bool], sites=None,
                         *, weight_only: bool = False):
    """Replace the frozen matmul weights of ``model`` with ``QuantLinear`` holders, in place.

    Only a weight whose mask entry is False (a name missing from a mapping
    counts as trainable) and whose JAX path matches one of ``sites`` (the
    Gemma sites by default) is converted; norms, the embedder, LoRA factors
    and any trainable tower stay. K and V become one holder where both are
    converted and share their JAX leaf (Gemma's ``kv_einsum``).
    """
    sites = GEMMA_QUANT_SITES if sites is None else tuple(sites)
    trainable = trainable_mask if callable(trainable_mask) else (lambda name: trainable_mask.get(name, True))

    def convert(prefix: str, attr: str, child) -> str | None:
        name = f"{prefix}.{attr}.weight" if prefix else f"{attr}.weight"
        return None if trainable(name) else _site_path(prefix, attr, child, sites)

    for prefix, parent in list(model.named_modules()):
        children = dict(parent.named_children())
        for members, joint in JOINT_HOLDERS.items():
            paths = [convert(prefix, m, children[m]) if m in children else None for m in members]
            if None not in paths and len(set(paths)) == 1:
                stacked = nn.Linear(children[members[0]].in_features, 1, bias=False, device="meta")
                stacked.weight = nn.Parameter(torch.cat([children[m].weight for m in members], dim=0), requires_grad=False)
                setattr(parent, joint, quantize_linear(stacked, weight_only=weight_only))
                for m in members:
                    delattr(parent, m)
                    del children[m]
        for attr, child in children.items():
            if convert(prefix, attr, child):
                setattr(parent, attr, quantize_linear(child, weight_only=weight_only))
    return model


def quantize_inference_tree(model: nn.Module, *, sites=None, siglip_sites=(), weight_only: bool = False) -> nn.Module:
    """Quantize the Gemma matmul sites (``sites``, all by default) and ``siglip_sites`` for inference (the whole
    model frozen), in place; ``weight_only`` gives every holder the weight-only forward."""
    sites = (GEMMA_QUANT_SITES if sites is None else tuple(sites)) + tuple(siglip_sites)
    return quantize_frozen_tree(model, lambda name: False, sites, weight_only=weight_only)


def switchback_tree(model: nn.Module, *, gemma: str = "0", siglip: str = "0", weight_only: bool = False) -> nn.Module:
    """Run the products of the ``nn.Linear`` layers at the selected sites by SwitchBack, in place.

    ``gemma`` and ``siglip`` are the specs of ``KAI0_INT8_SB_GEMMA`` (sites
    ``attn``, ``ffn``) and ``KAI0_INT8_SB`` (``attn``, ``mlp``, ``head``). Each
    layer becomes a ``SwitchBackLinear`` holding the same parameter tensors,
    so names, checkpoints and optimizer state do not change; an int8 holder
    keeps its frozen product, as JAX checks ``is_quant`` first.
    """
    sites = tuple(p for tower, spec in (("gemma", gemma), ("siglip", siglip))
                  for site, patterns in SWITCHBACK_SITES[tower].items() if switchback_on(spec, site) for p in patterns)
    if not sites:
        return model
    for prefix, parent in list(model.named_modules()):
        for attr, child in list(parent.named_children()):
            if type(child) is nn.Linear and _site_path(prefix, attr, child, sites):
                layer = SwitchBackLinear(child.in_features, child.out_features, bias=child.bias is not None,
                                         device="meta")
                layer.weight, layer.bias = child.weight, child.bias
                layer.weight_only = weight_only
                setattr(parent, attr, layer)
    return model


def dequantize_tree(model: nn.Module) -> nn.Module:
    """Inverse of ``quantize_frozen_tree``: every holder becomes an ``nn.Linear`` again (with its bias), in place."""
    def as_linear(w: torch.Tensor, bias: torch.Tensor | None = None) -> nn.Linear:
        layer = nn.Linear(w.shape[1], w.shape[0], bias=bias is not None, device="meta")
        layer.weight = nn.Parameter(w.contiguous(), requires_grad=False)
        if bias is not None:
            layer.bias = bias
        return layer

    joint = {name: members for members, name in JOINT_HOLDERS.items()}
    for parent in list(model.modules()):
        for attr, child in list(parent.named_children()):
            if not is_quant(child):
                continue
            w = dequantize(child)
            if attr in joint:
                delattr(parent, attr)
                for member, part in zip(joint[attr], w.chunk(len(joint[attr]), dim=0), strict=True):
                    setattr(parent, member, as_linear(part))
            else:
                setattr(parent, attr, as_linear(w, child.bias))
    return model


def has_quant(model: nn.Module) -> bool:
    return any(is_quant(m) for m in model.modules())
