"""The port's ``train_lib.param_norm`` against ``kai0_tpu.training.train_lib.param_norm`` on the same weights.

The metric the training loop logs at every ``log_interval``: the norm of the
>1-D weights without biases, norm scales and embeddings, plus, for an int8
base, the norm each quantized weight represents (``sq_norm`` of its codes and
scales). ``debug_pi05`` in f32, and ``debug_lora`` with its frozen base in bf16
and quantized to int8 (each package quantizing with its own
``quantize_frozen_tree``), from one JAX init with the zero leaves perturbed.
JAX's runs jitted, as its loop runs it. Tolerance: 1e-5 relative.
"""

import jax
import pytest

from _torch_parity import debug_lora_models, debug_models
from kai0_tpu.training import train_lib as jax_train_lib
from kai0_tpu_torch.training import train_lib


@pytest.mark.parametrize("kind", ["debug_pi05", "debug_lora_int8"])
def test_param_norm_matches_jax(kind):
    if kind == "debug_pi05":
        _, params, _, model = debug_models(seed=3)
    else:
        _, params, _, model = debug_lora_models(seed=3, quantize=True)
    ref = float(jax.jit(jax_train_lib.param_norm)(params))
    got = float(train_lib.param_norm(model))
    print(f"{kind}: param_norm {got:.7f}, JAX {ref:.7f}, relative difference {abs(got - ref) / ref:.2e}")
    assert abs(got - ref) <= 1e-5 * ref
