"""kai0_tpu_torch SigLIP against kai0_tpu SigLIP (CPU, f32, same weights and images).

A ``mu/14`` tower, and one full-width So400m block (width 1152, 16 heads of 72,
MLP 4304, depth 1) with the 2048-wide head. Zero-initialised leaves (biases, the
head) are perturbed. Tolerance 1e-4 (f32 sums taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import perturb_zero_leaves, sub_state
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import siglip as jax_siglip
from kai0_tpu.transforms import flatten_dict
from kai0_tpu_torch import interop as torch_interop
from kai0_tpu_torch.models import siglip as torch_siglip

_VIT = "paligemma_with_expert.paligemma.model.vision_tower.vision_model."
_HEAD = "paligemma_with_expert.paligemma.model.multi_modal_projector.linear."


def _port_of(img_params: dict, jax_cfg) -> tuple[torch_siglip.VisionModel, torch.nn.Linear]:
    """The same weights in the port's modules, through the interop mapping of the JAX package."""
    flat = flatten_dict({"PaliGemma": {"img": img_params}})
    state = {}
    for site in tsf._vit_sites(jax_cfg):
        state.update(zip(site.torch_keys, site.fwd(np.asarray(flat[site.jax_path])), strict=True))
    cfg = torch_siglip.Config(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(torch_siglip.Config)})
    tower = torch_siglip.VisionModel(cfg)
    head = torch.nn.Linear(cfg.width, cfg.num_classes)
    torch_interop.load_jax_state(tower, sub_state(state, _VIT))
    torch_interop.load_jax_state(head, sub_state(state, _HEAD))
    return tower, head


@pytest.mark.parametrize(
    "variant,depth,num_classes",
    [("mu/14", None, 64), ("So400m/14", 1, 2048)],
)
def test_siglip_matches_jax(variant, depth, num_classes):
    jax_cfg = jax_siglip.get_config(num_classes, variant)
    if depth is not None:
        jax_cfg = dataclasses.replace(jax_cfg, depth=depth)
    params = perturb_zero_leaves(jax_siglip.init(jax.random.key(0), jax_cfg), seed=1)
    tower, head = _port_of(params, jax_cfg)

    images = np.random.default_rng(2).uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(jax_siglip.apply(params, jax_cfg, jnp.asarray(images)))
    with torch.no_grad():
        out = torch_siglip.apply(tower, head, torch.from_numpy(images)).numpy()
    assert out.shape == ref.shape == (2, 256, num_classes)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    assert np.abs(ref).max() > 0.1  # the perturbed head makes the check non-trivial


def test_siglip_variant_table_matches_jax():
    for variant in ("mu/14", "So400m/14", "B/16"):
        jax_cfg = jax_siglip.get_config(2048, variant, dtype_mm="bfloat16")
        cfg = torch_siglip.get_config(2048, variant, dtype_mm="bfloat16")
        for field in dataclasses.fields(cfg):
            assert getattr(cfg, field.name) == getattr(jax_cfg, field.name), (variant, field.name)
