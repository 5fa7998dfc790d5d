"""The JAX parameter path of each of the port's parameter names.

The port names its parameters as the ``PI0Pytorch`` state dict does; the JAX
package names them by their path in its parameter tree. The freeze filter
(``models/pi0.py``), the quantization sites (``ops/quant.py``) and the carrying
of weights across (``interop.py``) are all written against the JAX paths, so
the map lives here, below all three, and imports nothing of the package.
"""

from __future__ import annotations

import re

PG = "paligemma_with_expert.paligemma.model"
EXPERT_ROOTS = ((f"{PG}.language_model", ""), ("paligemma_with_expert.gemma_expert.model", "_1"))
LLM = "PaliGemma/llm"

# port tail (under ``layers.{i}.``) -> JAX leaf (under ``PaliGemma/llm/layers/``, ``{s}`` the expert suffix)
LAYER_LEAVES = {
    "self_attn.q_proj": "attn/q_einsum{s}/w",
    "self_attn.k_proj": "attn/kv_einsum{s}/w",
    "self_attn.v_proj": "attn/kv_einsum{s}/w",
    "self_attn.kv_proj": "attn/kv_einsum{s}/w",  # the joint int8 holder of K and V (ops/quant.py)
    "self_attn.o_proj": "attn/attn_vec_einsum{s}/w",
    "self_attn.q_lora_a": "attn/q_einsum{s}/lora_a",
    "self_attn.q_lora_b": "attn/q_einsum{s}/lora_b",
    "self_attn.kv_lora_a": "attn/kv_einsum{s}/lora_a",
    "self_attn.kv_lora_b": "attn/kv_einsum{s}/lora_b",
    "self_attn.o_lora_a": "attn/attn_vec_einsum{s}/lora_a",
    "self_attn.o_lora_b": "attn/attn_vec_einsum{s}/lora_b",
    "mlp.gate_proj": "mlp{s}/gating_einsum",
    "mlp.up_proj": "mlp{s}/gating_einsum",
    "mlp.down_proj": "mlp{s}/linear",
    "mlp.gating_lora_a": "mlp{s}/gating_einsum_lora_a",
    "mlp.gating_lora_b": "mlp{s}/gating_einsum_lora_b",
    "mlp.linear_lora_a": "mlp{s}/linear_lora_a",
    "mlp.linear_lora_b": "mlp{s}/linear_lora_b",
    "input_layernorm": "pre_attention_norm{s}",
    "post_attention_layernorm": "pre_ffw_norm{s}",
}
LORA_TAILS = tuple(tail for tail in LAYER_LEAVES if "lora" in tail)
_NORM_LEAVES = {"weight": "scale", "dense.weight": "Dense_0/kernel", "dense.bias": "Dense_0/bias"}


def _gemma_leaf(rest: str, sfx: str) -> str | None:
    if rest == "embed_tokens.weight":
        return "embedder/input_embedding"
    if rest.startswith("norm.") and rest[5:] in _NORM_LEAVES:
        return f"final_norm{sfx}/{_NORM_LEAVES[rest[5:]]}"
    m = re.match(r"layers\.\d+\.(.+)$", rest)
    if not m:
        return None
    tail = m.group(1)
    for key, leaf in LAYER_LEAVES.items():
        if tail != key and not tail.startswith(key + "."):
            continue
        path, sub = f"layers/{leaf.format(s=sfx)}", tail[len(key) + 1:]
        if key.endswith("layernorm"):
            return f"{path}/{_NORM_LEAVES[sub]}" if sub in _NORM_LEAVES else None
        return path if sub in ("", "weight", "qweight", "scale") else None
    return None


def jax_param_path(name: str) -> str:
    """The JAX parameter path of a port parameter or buffer name.

    Gemma names map leaf for leaf (a ``QuantLinear``'s ``qweight`` / ``scale``
    map to the weight they replace). SigLIP names are not translated one by
    one: they come back as ``PaliGemma/img/<port tail>``, which is all that the
    path predicates (``llm``, the ``_1`` expert suffix, ``lora``) read. The
    advantage estimator's ``value_head.{0,2,4}`` are ``value_head/Dense_{0,1,2}``
    (``kai0_tpu/interop/torch_safetensors.py:320-321``).
    """
    for root, sfx in EXPERT_ROOTS:
        if name.startswith(root + "."):
            leaf = _gemma_leaf(name[len(root) + 1:], sfx)
            if leaf is None:
                raise KeyError(f"no JAX parameter path for {name!r}")
            return f"{LLM}/{leaf}"
    if name.startswith((f"{PG}.vision_tower.", f"{PG}.multi_modal_projector.")):
        return "PaliGemma/img/" + name[len(PG) + 1:].replace(".", "/")
    module, _, leaf = name.rpartition(".")
    if m := re.fullmatch(r"value_head\.([024])", module):  # the estimator's head: Dense_0-2 (torch 0, 2, 4)
        module = f"value_head/Dense_{int(m.group(1)) // 2}"
    return f"{module}/{'kernel' if leaf == 'weight' else leaf}"
