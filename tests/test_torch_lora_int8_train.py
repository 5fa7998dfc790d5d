"""The port's LoRA fine-tune over a frozen **int8** base against the JAX package's, on the CPU.

The tests, and the account of the int8 tolerances (activation-code flips), are
those of ``test_torch_lora_train.py``; only the ``runs`` fixture differs. A
file of its own, so that the two runs spread over the test workers.
"""

import pytest

from _torch_parity import lora_finetune_runs
from test_torch_lora_train import (  # noqa: F401  (collected here, against this file's fixture)
    test_frozen_leaves_are_untouched_and_the_optimizer_holds_trainable_leaves_only,
    test_loss_and_every_trainable_gradient_match_jax,
    test_three_steps_track_jax,
    test_trainable_leaves_and_their_ema_track_jax,
)


@pytest.fixture(scope="module")
def runs():
    return {"quantize": True, **lora_finetune_runs(quantize=True)}
