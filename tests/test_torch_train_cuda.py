"""The training entry point on the card: ``train_lib.main`` launches the kernels of a full-width step.

This file imports no JAX, so that the card's machine can run it without the
repository's conftest:

    python -m pytest tests/test_torch_train_cuda.py -m cuda --noconftest -q

Two steps of ``pi05_base`` at full width (Gemma-2B + Gemma-300M, So400m/14),
batch 32, bf16 parameters with stochastic rounding, int8 AdamW moments, no
EMA, fake data read by one producer thread, seeded weights: every step
launches 36 flash_mha, 18 flash_mha_bwd, 54 flash_mhsa, 27 flash_mhsa_bwd
and one adam_q8, and no int8 kernel, as ``chip_smoke.py`` phase 9's steps.
"""

import dataclasses

import pytest
import torch

from kai0_tpu_torch.ops import adam_q8, int8_matmul, row_quant
from kai0_tpu_torch.ops import flash_attention as fa
from kai0_tpu_torch.training import config as train_config
from kai0_tpu_torch.training import optimizer, train_lib

pytestmark = pytest.mark.cuda

STEP_LAUNCHES = {"flash_mha": 36, "flash_mha_bwd": 18, "flash_mhsa": 54, "flash_mhsa_bwd": 27, "adam_q8": 1}


def _counts() -> dict:
    return {**fa.LAUNCHES, **adam_q8.LAUNCHES, **row_quant.LAUNCHES, **int8_matmul.LAUNCHES}


def test_main_launches_the_kernels_of_a_full_width_step(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("WANDB_MODE", "disabled")  # the card's machine may have wandb, and has no network
    config = dataclasses.replace(
        train_config.get_config("pi05_base"), exp_name="cuda", checkpoint_base_dir=str(tmp_path), batch_size=32,
        num_train_steps=2, log_interval=1, save_interval=100, num_workers=0, param_dtype="bfloat16",
        optimizer=optimizer.AdamW(state_dtype="int8"), ema_decay=None, wandb_enabled=False,
    )
    for module in (fa, adam_q8, row_quant, int8_matmul):
        module.reset_launches()
    steps = []
    before = _counts()

    def on_step(step, record):
        nonlocal before
        counts = _counts()
        steps.append({k: v - before[k] for k, v in counts.items() if v - before[k]})
        before = counts
        assert torch.isfinite(record["loss"]) and torch.isfinite(record["grad_norm"])

    model, state = train_lib.main(config, on_step=on_step)
    assert state.step == 2 and next(model.parameters()).device.type == "cuda"
    assert steps == [STEP_LAUNCHES, STEP_LAUNCHES], steps
