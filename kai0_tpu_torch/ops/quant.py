"""Int8 quantization of frozen base weights: the LoRA fine-tune's frozen base and int8 serving.

Counterpart of the frozen-base half of ``kai0_tpu/ops/quant.py``. A frozen
matmul weight is quantized once (symmetric, one f32 scale per output channel)
and every product with it runs int8 x int8 -> int32: activations (and, in the
backward, incoming gradients) are quantized per row at each call,
``y ≈ (q_row(x) @ Wq) * s_x * s_w``, with a straight-through estimator through
the rounding (SwitchBack, arXiv:2304.13013).

``QuantLinear`` holds one quantized weight as ``nn.Linear`` lays it out:
``qweight`` int8 ``[out, in]`` and ``scale`` f32 ``[out]``. JAX's
``QuantArray.q`` is the transpose, ``[in, out]``, per layer; a stacked JAX leaf
(``kv_einsum``, ``gating_einsum``) is quantized per column, so its column
blocks are the port's ``k_proj`` / ``v_proj`` and ``gate_proj`` / ``up_proj``
weights value for value. JAX applies ``gating_einsum`` slice by slice, so gate
and up get a holder each; it applies ``kv_einsum`` as one product, whose
backward quantizes the rows of ``[dk·s | dv·s]`` with one scale a row, so K and
V share one holder, ``kv_proj`` (K's rows, then V's), which takes the place of
``k_proj`` and ``v_proj`` on the attention module.

Routing has no switches. On CUDA tensors every row quantization is kernel K5
(``row_quant``), every forward product K4b (``int8_matmul``, the ``nt``
orientation over the stored weight) or, for the gate, up and down products of
the fused FFN with LoRA factors, K4a (``int8_matmul_lora``), and every ``dx``
K4b in its other orientation over the same stored weight. On CPU tensors the
same wrappers run their plain versions. The small LoRA products around the
kernels are ``torch.matmul``, as JAX leaves them outside its kernels. Rows are
independent, so the fused FFN walks over row chunks sized to keep its widest
intermediates, the backward's f32 images of ``[rows, mlp_dim]`` (the LoRA
gradients' operands, and ``dy·s`` on the CPU), within ``_CHUNK_BYTES``;
chunking changes no value but the f32 summation order of the six LoRA
gradients.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
import re

import torch
from torch import nn
import torch.nn.functional as F

from kai0_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_lora
from kai0_tpu_torch.ops.row_quant import INV_127, row_quant
from kai0_tpu_torch.param_paths import jax_param_path

_CHUNK_BYTES = 512 * 2**20  # of one f32 [rows, mlp_dim] intermediate: 8192 rows at Gemma-2B's mlp_dim of 16384


class QuantLinear(nn.Module):
    """A frozen ``nn.Linear`` weight (no bias) as int8 codes and per-output-channel f32 scales.

    ``weight ≈ qweight * scale[:, None]``; ``orig_dtype`` is the dtype the
    weight had, which ``dequantize`` restores. The scales stay f32 when the
    model is cast to another dtype.
    """

    def __init__(self, qweight: torch.Tensor, scale: torch.Tensor, orig_dtype: torch.dtype):
        super().__init__()
        if qweight.dtype != torch.int8 or qweight.ndim != 2 or scale.shape != (qweight.shape[0],):
            raise ValueError(f"QuantLinear takes int8 [out, in] codes and [out] scales, not {qweight.dtype} "
                             f"{tuple(qweight.shape)}, {tuple(scale.shape)}")
        self.register_buffer("qweight", qweight.contiguous())
        self.register_buffer("scale", scale.to(torch.float32).contiguous())
        self.orig_dtype = orig_dtype

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
        return f"in_features={self.in_features}, out_features={self.out_features}, orig_dtype={self.orig_dtype}"


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


def quantize_linear(layer: nn.Linear) -> QuantLinear:
    if layer.bias is not None:
        raise ValueError("only bias-free projections are quantized")
    q, s = quantize_weight(layer.weight)
    return QuantLinear(q, s, layer.weight.dtype)


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


def _dx(ql: QuantLinear, dy: torch.Tensor) -> torch.Tensor:
    """dL/dx of a quantized product, straight-through: ``q_row(dy · s) @ q`` with the row scale in the epilogue.

    ``dy · s`` is f32; on CUDA K5 forms it in registers from ``dy``, on the CPU the plain version writes it.
    """
    gq, sg = row_quant(dy, col_scale=ql.scale)
    return int8_matmul(gq, ql.qweight, sg, None, nt=False, out_dtype=dy.dtype)


class _QMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, add, ql):
        ctx.ql = ql
        xq, sx = row_quant(x2)
        if add is None:
            return int8_matmul(xq, ql.qweight, sx, ql.scale, nt=True, out_dtype=x2.dtype)
        # The add joins in f32, before the one rounding to x's dtype.
        y = int8_matmul(xq, ql.qweight, sx, ql.scale, nt=True, out_dtype=torch.float32)
        return (y + add.to(torch.float32)).to(x2.dtype)

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
# Fused gated FFN (gate | up -> gelu · up -> down) with a hand-written backward
# ---------------------------------------------------------------------------


def _project(xq, sx, x_c, ql: QuantLinear, a, b) -> torch.Tensor:
    """One projection of a row chunk: K4a with LoRA factors, K4b without."""
    if a is None:
        return int8_matmul(xq, ql.qweight, sx, ql.scale, nt=True, out_dtype=x_c.dtype)
    return int8_matmul_lora(xq, ql.qweight, sx, ql.scale, x_c @ a, b, out_dtype=x_c.dtype)


def _row_chunks(m: int, mlp_dim: int) -> list[tuple[int, int]]:
    """Even row spans of ``[m, mlp_dim]``, each at most ``_CHUNK_BYTES`` in f32."""
    count = max(1, -(-m // max(1, _CHUNK_BYTES // (4 * mlp_dim))))
    rows = -(-m // count)
    return [(i, min(i + rows, m)) for i in range(0, m, rows)]


class _FusedFFN(torch.autograd.Function):
    """``_make_fused_ffn`` of the JAX package: saves only the input; the backward re-derives gate, up and act."""

    @staticmethod
    def forward(ctx, x2, gate, up, down, *lora):
        ctx.layers = (gate, up, down)
        ctx.save_for_backward(x2, *lora)
        ag, bg, au, bu, ad, bd = lora if lora else (None,) * 6
        out = []
        for lo, hi in _row_chunks(x2.shape[0], gate.out_features):
            x_c = x2[lo:hi]
            xq, sx = row_quant(x_c)
            act = F.gelu(_project(xq, sx, x_c, gate, ag, bg), approximate="tanh") * _project(xq, sx, x_c, up, au, bu)
            aq, sa = row_quant(act)
            out.append(_project(aq, sa, act, down, ad, bd))
        return out[0] if len(out) == 1 else torch.cat(out, dim=0)

    @staticmethod
    def backward(ctx, dy):
        gate_l, up_l, down_l = ctx.layers
        x2, *lora = ctx.saved_tensors
        ag, bg, au, bu, ad, bd = lora if lora else (None,) * 6
        dy = dy.contiguous()
        f32 = torch.float32
        acc = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in lora]
        dxs = []
        for lo, hi in _row_chunks(x2.shape[0], gate_l.out_features):
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
            dxs.append(dx_c)
        dx = dxs[0] if len(dxs) == 1 else torch.cat(dxs, dim=0)
        return (dx, None, None, None, *(g.to(dy.dtype) for g in acc))


def apply_fused_ffn(gate: QuantLinear, up: QuantLinear, down: QuantLinear, x: torch.Tensor, lora_params=None):
    """Gated-GELU FFN on quantized weights as one op with a hand-written backward.

    ``lora_params`` are the (unscaled) factors ``(a_gate [D, r], b_gate [r, F],
    a_up, b_up, a_down [F, r], b_down [r, D])`` or None; they are cast to x's
    dtype, and their gradients accumulate in f32 and are cast at the end.
    """
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    lora = () if lora_params is None else tuple(p.to(x.dtype) for p in lora_params)
    return _FusedFFN.apply(x2, gate, up, down, *lora).view(*x.shape[:-1], -1)


# ---------------------------------------------------------------------------
# Model-level transforms
# ---------------------------------------------------------------------------

# Path-suffix patterns of the Gemma matmul weights, on the JAX parameter paths
# the port's names map to (``kai0_tpu_torch.param_paths.jax_param_path``).
GEMMA_QUANT_SITES: tuple[re.Pattern, ...] = (
    re.compile(r"attn/qkv_einsum(_\d+)?/w$"),
    re.compile(r"attn/q_einsum(_\d+)?/w$"),
    re.compile(r"attn/kv_einsum(_\d+)?/w$"),
    re.compile(r"attn/attn_vec_einsum(_\d+)?/w$"),
    re.compile(r"mlp(_\d+)?/gating_einsum$"),
    re.compile(r"mlp(_\d+)?/linear$"),
)


# Port layers that JAX holds and applies as one matrix: (members, in JAX's column order) -> the joint holder.
JOINT_HOLDERS = {("k_proj", "v_proj"): "kv_proj"}


def quantize_frozen_tree(model: nn.Module, trainable_mask: Mapping[str, bool] | Callable[[str], bool], sites=None):
    """Replace the frozen matmul weights of ``model`` with ``QuantLinear`` holders, in place.

    Only a weight whose mask entry is False (a name missing from a mapping
    counts as trainable) and whose JAX path matches a known matmul site is
    converted; norms, the embedder, LoRA factors and any trainable tower stay.
    """
    sites = GEMMA_QUANT_SITES if sites is None else sites
    trainable = trainable_mask if callable(trainable_mask) else (lambda name: trainable_mask.get(name, True))

    def convert(prefix: str, attr: str, child) -> bool:
        name = f"{prefix}.{attr}.weight" if prefix else f"{attr}.weight"
        return (isinstance(child, nn.Linear) and child.bias is None and not trainable(name)
                and any(p.search(jax_param_path(name)) for p in sites))

    for prefix, parent in list(model.named_modules()):
        children = dict(parent.named_children())
        for members, joint in JOINT_HOLDERS.items():
            if all(m in children and convert(prefix, m, children[m]) for m in members):
                stacked = nn.Linear(children[members[0]].in_features, 1, bias=False, device="meta")
                stacked.weight = nn.Parameter(torch.cat([children[m].weight for m in members], dim=0), requires_grad=False)
                setattr(parent, joint, quantize_linear(stacked))
                for m in members:
                    delattr(parent, m)
                    del children[m]
        for attr, child in children.items():
            if convert(prefix, attr, child):
                setattr(parent, attr, quantize_linear(child))
    return model


def quantize_inference_tree(model: nn.Module) -> nn.Module:
    """Quantize every Gemma matmul site for inference (the whole model is frozen), in place."""
    return quantize_frozen_tree(model, lambda name: False)


def dequantize_tree(model: nn.Module) -> nn.Module:
    """Inverse of ``quantize_frozen_tree``: every holder becomes a bias-free ``nn.Linear`` again, in place."""
    def as_linear(w: torch.Tensor) -> nn.Linear:
        layer = nn.Linear(w.shape[1], w.shape[0], bias=False, device="meta")
        layer.weight = nn.Parameter(w.contiguous(), requires_grad=False)
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
                setattr(parent, attr, as_linear(w))
    return model


def has_quant(model: nn.Module) -> bool:
    return any(is_quant(m) for m in model.modules())
