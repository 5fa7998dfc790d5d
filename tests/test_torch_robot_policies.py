"""The port's robot policies against the JAX package's: inputs and outputs bit-equal on each ``make_*_example``.

Agilex and ARX (through ``bimanual``: camera renames, the [-π, π] state clip,
padding, truncation to 14), Aloha (joint flips, gripper conversions, the
dropped ``cam_low``), DROID and Libero (camera slots per model type), for the
model types each has branches for, with actions in the inputs too (training
form) and the model's 32-wide action chunk through the outputs.
"""

import copy

import numpy as np
import pytest

from _torch_parity import assert_same
from kai0_tpu.models import model as jax_model
from kai0_tpu.policies import agilex_policy as jax_agilex
from kai0_tpu.policies import aloha_policy as jax_aloha
from kai0_tpu.policies import arx_policy as jax_arx
from kai0_tpu.policies import bimanual as jax_bimanual
from kai0_tpu.policies import droid_policy as jax_droid
from kai0_tpu.policies import libero_policy as jax_libero
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.policies import agilex_policy, aloha_policy, arx_policy, bimanual, droid_policy, libero_policy


def _example(make, seed: int, *, actions_dim: int | None) -> dict:
    np.random.seed(seed)
    example = make()
    if actions_dim is not None:
        example["actions"] = np.random.uniform(-4, 4, (50, actions_dim)).astype(np.float32)
    return example


def _agilex_example_out_of_range() -> dict:
    example = jax_agilex.make_agilex_example()
    example["state"][[0, 7]] = [3.5, -3.3]  # outside [-π, π]: Agilex zeroes them, ARX keeps them
    example["images"]["his_-100_top_head"] = np.random.rand(3, 480, 640).astype(np.float32)  # float CHW history camera
    return example


# name -> (make example, actions width, (JAX inputs, port inputs) per model type, (JAX outputs, port outputs))
POLICIES = {
    "agilex": (_agilex_example_out_of_range, 14,
               lambda jm, tm: (jax_agilex.AgilexInputs(action_dim=32, model_type=jm),
                               agilex_policy.AgilexInputs(action_dim=32, model_type=tm)),
               (jax_agilex.AgilexOutputs(), agilex_policy.AgilexOutputs())),
    "arx": (_agilex_example_out_of_range, 14,
            lambda jm, tm: (jax_arx.ARXInputs(action_dim=32, model_type=jm, mask_state=True),
                            arx_policy.ARXInputs(action_dim=32, model_type=tm, mask_state=True)),
            (jax_arx.ARXOutputs(), arx_policy.ARXOutputs())),
    "bimanual": (jax_agilex.make_agilex_example, 14,
                 lambda jm, tm: (jax_bimanual.BimanualInputs(action_dim=16, model_type=jm),
                                 bimanual.BimanualInputs(action_dim=16, model_type=tm)),
                 (jax_bimanual.BimanualOutputs(7), bimanual.BimanualOutputs(7))),
    "aloha": (jax_aloha.make_aloha_example, 14,
              lambda jm, tm: (jax_aloha.AlohaInputs(), aloha_policy.AlohaInputs()),
              (jax_aloha.AlohaOutputs(), aloha_policy.AlohaOutputs())),
    "droid": (jax_droid.make_droid_example, 8,
              lambda jm, tm: (jax_droid.DroidInputs(model_type=jm), droid_policy.DroidInputs(model_type=tm)),
              (jax_droid.DroidOutputs(), droid_policy.DroidOutputs())),
    "libero": (jax_libero.make_libero_example, 7,
               lambda jm, tm: (jax_libero.LiberoInputs(model_type=jm), libero_policy.LiberoInputs(model_type=tm)),
               (jax_libero.LiberoOutputs(), libero_policy.LiberoOutputs())),
}
MODEL_TYPES = ["PI05", "PI0", "PI0_FAST"]


@pytest.mark.parametrize("model_type", MODEL_TYPES)
@pytest.mark.parametrize("with_actions", [False, True])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_inputs_match_jax(name, with_actions, model_type):
    make, width, inputs, _ = POLICIES[name]
    example = _example(make, 7, actions_dim=width if with_actions else None)
    jax_fn, torch_fn = inputs(jax_model.ModelType[model_type], torch_model.ModelType[model_type])
    assert_same(jax_fn(copy.deepcopy(example)), torch_fn(copy.deepcopy(example)))


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_outputs_match_jax(name):
    jax_fn, torch_fn = POLICIES[name][3]
    data = {"actions": np.random.default_rng(3).uniform(-2, 2, (50, 32)).astype(np.float32),
            "state": np.zeros(32, np.float32)}
    out = torch_fn(copy.deepcopy(data))
    assert_same(jax_fn(copy.deepcopy(data)), out)
    assert out["actions"].shape[0] == 50


@pytest.mark.parametrize("make, port_make", [
    (jax_agilex.make_agilex_example, agilex_policy.make_agilex_example),
    (jax_aloha.make_aloha_example, aloha_policy.make_aloha_example),
    (jax_droid.make_droid_example, droid_policy.make_droid_example),
    (jax_libero.make_libero_example, libero_policy.make_libero_example),
])
def test_examples_match_jax(make, port_make):
    np.random.seed(5)
    ref = make()
    np.random.seed(5)
    assert_same(ref, port_make())


def test_agilex_example_is_three_raw_cameras():
    example = agilex_policy.make_agilex_example()
    assert {k: (v.shape, v.dtype) for k, v in example["images"].items()} == {
        k: ((3, 480, 640), np.uint8) for k in ("top_head", "hand_left", "hand_right")}
    assert example["state"].shape == (14,) and isinstance(example["prompt"], str)
    with pytest.raises(ValueError, match="Unexpected cameras"):
        agilex_policy.AgilexInputs(action_dim=32)({**example, "images": {**example["images"], "extra": None}})
