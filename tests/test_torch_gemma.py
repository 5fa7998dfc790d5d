"""kai0_tpu_torch two-expert Gemma stack against kai0_tpu.models.gemma (CPU, f32).

A prefix pass of the PaliGemma expert (padded tokens, prefix-LM mask) that
fills the KV cache, then a suffix pass of the adaRMS action expert against the
cache, for the ``dummy`` pair and a narrow pair with the real head layout
(8 heads of 256, one KV head). Zero-initialised leaves (adaRMS ``Dense_0``,
RMSNorm scales) are perturbed. Tolerance 1e-4; rows of padded tokens are not
compared (never attended to, and not meaningful in either package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import perturb_zero_leaves, sub_state
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import gemma as jax_gemma
from kai0_tpu.ops.masks import make_attn_mask as jax_make_attn_mask
from kai0_tpu.transforms import flatten_dict
from kai0_tpu_torch import interop as torch_interop
from kai0_tpu_torch.models import gemma as torch_gemma
from kai0_tpu_torch.ops.masks import make_attn_mask

_PG = "paligemma_with_expert.paligemma.model.language_model."
_EXPERT = "paligemma_with_expert.gemma_expert.model."

NARROW = (
    dict(width=128, depth=2, mlp_dim=256, num_heads=8, num_kv_heads=1, head_dim=256),
    dict(width=64, depth=2, mlp_dim=128, num_heads=8, num_kv_heads=1, head_dim=256),
)


def _pair(kind):
    if kind == "dummy":
        return [jax_gemma.get_config("dummy")] * 2, [torch_gemma.get_config("dummy")] * 2
    return [jax_gemma.Config(**c) for c in NARROW], [torch_gemma.Config(**c) for c in NARROW]


def _port_of(params: dict, jax_cfgs, torch_cfgs):
    flat = flatten_dict({"PaliGemma": {"llm": params}})
    state = {_PG + "embed_tokens.weight": np.asarray(flat["PaliGemma/llm/embedder/input_embedding"])}
    for i, (root, adarms) in enumerate(((_PG[:-1], False), (_EXPERT[:-1], True))):
        sites = tsf._gemma_sites(jax_cfgs[i], torch_root=root, jax_suffix="_1" if i else "", adarms=adarms, depth=jax_cfgs[i].depth)
        for site in sites:
            state.update(zip(site.torch_keys, site.fwd(np.asarray(flat[site.jax_path])), strict=True))
    vlm = torch_gemma.GemmaModel(torch_cfgs[0], adarms=False, embed=True)
    expert = torch_gemma.GemmaModel(torch_cfgs[1], adarms=True, embed=False)
    torch_interop.load_jax_state(vlm, sub_state(state, _PG))
    torch_interop.load_jax_state(expert, sub_state(state, _EXPERT))
    return [vlm, expert]


@pytest.mark.parametrize("kind", ["dummy", "narrow"])
def test_prefix_then_cached_suffix(kind):
    jax_cfgs, torch_cfgs = _pair(kind)
    params = perturb_zero_leaves(jax_gemma.init(jax.random.key(0), jax_cfgs, (False, True)), seed=1)
    experts = _port_of(params, jax_cfgs, torch_cfgs)
    rng = np.random.default_rng(2)
    b, p, s = 2, 24, 10

    tokens = rng.integers(0, 257_152, (b, p), dtype=np.int32)
    prefix_mask = np.ones((b, p), bool)
    prefix_mask[0, 18:] = False  # padded prompt
    prefix_mask[1, 3:6] = False
    positions = np.cumsum(prefix_mask, axis=1) - 1
    x_jax = jax_gemma.embed(params, jnp.asarray(tokens), "float32")
    with torch.no_grad():
        x = torch_gemma.embed(experts[0], torch.from_numpy(tokens), torch.float32)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_jax), rtol=1e-6, atol=1e-6)

    attn = np.array(jax_make_attn_mask(jnp.asarray(prefix_mask), jnp.zeros(p, bool)))
    np.testing.assert_array_equal(make_attn_mask(torch.from_numpy(prefix_mask), torch.zeros(p, dtype=torch.bool)).numpy(), attn)
    (out_jax, _), (k_jax, v_jax) = jax_gemma.apply(
        params, jax_cfgs, [x_jax, None], jnp.asarray(positions), jnp.asarray(attn), embed_dtype="float32"
    )
    with torch.no_grad():
        (out, none), cache = torch_gemma.apply(
            experts, [x, None], torch.from_numpy(positions), torch.from_numpy(attn), embed_dtype=torch.float32
        )
    assert none is None and len(cache) == jax_cfgs[0].depth
    np.testing.assert_allclose(out.numpy()[prefix_mask], np.asarray(out_jax)[prefix_mask], rtol=1e-4, atol=1e-4)
    for layer, (k, v) in enumerate(cache):
        assert k.shape == (b, p, 1, jax_cfgs[0].head_dim)
        np.testing.assert_allclose(k.numpy()[prefix_mask], np.asarray(k_jax[layer])[prefix_mask], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(v.numpy()[prefix_mask], np.asarray(v_jax[layer])[prefix_mask], rtol=1e-4, atol=1e-4)

    suffix = rng.standard_normal((b, s, jax_cfgs[1].width)).astype(np.float32)
    cond = rng.standard_normal((b, jax_cfgs[1].width)).astype(np.float32)
    suffix_ar = np.array([True] + [False] * (s - 1))
    suffix_attn = np.array(jax_make_attn_mask(jnp.ones((b, s), bool), jnp.asarray(suffix_ar)))
    full = np.concatenate([np.broadcast_to(prefix_mask[:, None, :], (b, s, p)), suffix_attn], axis=-1)
    suffix_positions = prefix_mask.sum(-1)[:, None] + np.arange(s)[None]
    (_, suffix_jax), _ = jax_gemma.apply(
        params, jax_cfgs, [None, jnp.asarray(suffix)], jnp.asarray(suffix_positions), jnp.asarray(full),
        adarms_cond=[None, jnp.asarray(cond)], kv_cache=(k_jax, v_jax), embed_dtype="float32",
    )
    with torch.no_grad():
        (_, suffix_out), _ = torch_gemma.apply(
            experts, [None, torch.from_numpy(suffix)], torch.from_numpy(suffix_positions), torch.from_numpy(full),
            [None, torch.from_numpy(cond)], kv_cache=cache, embed_dtype=torch.float32,
        )
    np.testing.assert_allclose(suffix_out.numpy(), np.asarray(suffix_jax), rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(suffix_jax)).max() > 0.1


def test_variant_table_matches_jax():
    for variant in ("dummy", "gemma_300m", "gemma_2b"):
        assert torch_gemma.get_config(variant) == torch_gemma.Config(
            **{k: getattr(jax_gemma.get_config(variant), k) for k in torch_gemma.Config.__dataclass_fields__}
        )
