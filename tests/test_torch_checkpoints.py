"""The port's checkpoints: round trips, retention, resume detection, the quantized resume, JAX serving them.

- Save → restore into a fresh model and state is bit-equal (parameters, EMA,
  moments, count, step) for ``debug_pi05`` with f32, bf16 and int8 AdamW
  moments, with and without the EMA; every tensor of the saved state is
  drawn from a seed (random int8 codes and uint8 codes), so no zero hides a
  tensor that was not restored.
- Retention keeps the newest step and every step divisible by
  ``keep_period`` (Orbax's ``max_to_keep=1`` with ``keep_period``); a
  ``<step>.tmp`` left by an interrupted save is no step, and the next save of
  that step replaces it.
- Resume detection: a new directory starts fresh, an existing one is refused
  without ``resume`` or ``overwrite``, ``overwrite`` empties it, and a
  directory without a step > 0 starts fresh even with ``resume``.
- ``debug_lora`` with ``quantize_frozen=True``: the checkpoint holds the int8
  base dequantized (bf16), so the restore requantizes it; every requantized
  code is within one int8 step of the original, and the number of codes that
  move is the one measured on this tree (a weight's bf16 rounding of
  ``127 · s`` moves its row's scale).
- ``create_trained_policy`` of the JAX package on a step checkpoint that the
  port's ``train_lib.main`` wrote (2 steps of ``debug_pi05``, EMA on) serves
  the port's actions within 1e-3 (BASELINE.md:27), on the kai0 task config
  ``pi05_flatten_fold_normal`` with its model cut to the debug size, as
  ``tests/test_torch_policy_config.py`` serves a JAX-written checkpoint.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import DEBUG
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.policies import agilex_policy as jax_agilex
from kai0_tpu.policies import policy_config as jax_policy_config
from kai0_tpu.training import config as jax_config
from kai0_tpu_torch import interop
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.ops import quant
from kai0_tpu_torch.policies import policy_config
from kai0_tpu_torch.shared import normalize
from kai0_tpu_torch.training import checkpoints
from kai0_tpu_torch.training import config as torch_config
from kai0_tpu_torch.training import optimizer, train_lib

# Codes of the debug_lora int8 base (344,064) that requantization moves by one step, measured on the CPU.
LORA_REQUANT_MOVED = 0


def _filled(config, seed: int = 5):
    """(model, state) of ``config`` with every tensor of the state drawn from ``seed`` (int8 codes, f32 scales)."""
    model = train_lib.create_model(config, device="cpu")
    state = train_lib.init_train_state(model, config, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    tensors = [*state.params.values(), *(state.ema or {}).values()]
    for key in ("mu", "nu"):
        for moment in state.opt_state[key].values():
            tensors.extend(moment.values() if isinstance(moment, dict) else [moment])
    with torch.no_grad():
        for t in tensors:
            if t.dtype.is_floating_point:
                t.copy_(torch.randn(t.shape, generator=gen))
            else:
                t.copy_(torch.randint(-128 if t.dtype == torch.int8 else 0, 128, t.shape, generator=gen))
    return model, dataclasses.replace(state, step=3, opt_state={**state.opt_state, "count": 3})


def _fresh(config):
    model = train_lib.create_model(dataclasses.replace(config, seed=7), device="cpu")
    return model, train_lib.init_train_state(model, config, device="cpu", resume=True)


def _assert_bit_equal(a, b, name=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), name
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{name}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool else a, b), name
    else:
        assert a == b, (name, a, b)


@pytest.mark.parametrize("ema_decay", [0.99, None])
@pytest.mark.parametrize("state_dtype", [None, "bfloat16", "int8"])
def test_save_restore_is_bit_equal(tmp_path, state_dtype, ema_decay):
    config = dataclasses.replace(torch_config.get_config("debug_pi05"), ema_decay=ema_decay,
                                 optimizer=optimizer.AdamW(state_dtype=state_dtype))
    model, state = _filled(config)
    manager, resuming = checkpoints.initialize_checkpoint_dir(tmp_path / "run", keep_period=None, overwrite=False,
                                                              resume=False)
    assert not resuming
    nbytes = checkpoints.save_state(manager, model, state, 1)
    assert nbytes == sum(f.stat().st_size for f in (tmp_path / "run" / "1").iterdir())
    assert json.loads((tmp_path / "run" / "1" / "train_state.json").read_text()) == {
        "step": 3, "count": 3, "ema": ema_decay is not None}

    fresh_model, fresh = _fresh(config)
    restored = checkpoints.restore_state(manager, fresh_model, fresh)
    assert restored.step == state.step == 3
    _assert_bit_equal(restored.params, state.params, "params")
    _assert_bit_equal(restored.opt_state, state.opt_state, "opt_state")
    _assert_bit_equal(restored.ema, state.ema, "ema")
    _assert_bit_equal(fresh_model.state_dict(), model.state_dict(), "model")
    # The inference file: EMA when kept, else the parameters, under the model's state-dict keys.
    served = interop.read_safetensors(tmp_path / "run" / "1" / interop.CHECKPOINT_FILE)
    assert set(served) == set(model.state_dict())
    _assert_bit_equal(served, state.ema if ema_decay else {k: p.detach() for k, p in state.params.items()}, "served")


def test_retention_and_interrupted_saves(tmp_path):
    manager = checkpoints.CheckpointManager(tmp_path, keep_period=2)
    for step in range(1, 6):
        (tmp_path / str(step)).mkdir()
        manager.prune()
    assert manager.all_steps() == [2, 4, 5]
    (tmp_path / "6").mkdir()
    checkpoints.CheckpointManager(tmp_path, keep_period=None).prune()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["6"]

    # A save interrupted before its rename leaves <step>.tmp: no step for resume, replaced by the next save.
    config = torch_config.get_config("debug_pi05")
    model, state = _filled(config)
    run = tmp_path / "run"
    manager, _ = checkpoints.initialize_checkpoint_dir(run, keep_period=None, overwrite=False, resume=False)
    checkpoints.save_state(manager, model, state, 3)
    (run / "4.tmp").mkdir()
    (run / "4.tmp" / "model.safetensors").write_bytes(b"half")
    assert manager.all_steps() == [3] and manager.latest_step() == 3
    assert checkpoints.initialize_checkpoint_dir(run, keep_period=None, overwrite=False, resume=True)[1]
    fresh_model, fresh = _fresh(config)
    assert checkpoints.restore_state(manager, fresh_model, fresh).step == state.step
    checkpoints.save_state(manager, model, state, 4)
    assert sorted(p.name for p in run.iterdir()) == ["4"]


def test_resume_detection(tmp_path):
    run = tmp_path / "run"
    manager, resuming = checkpoints.initialize_checkpoint_dir(run, keep_period=5000, overwrite=False, resume=False)
    assert run.is_dir() and not resuming and manager.keep_period == 5000
    with pytest.raises(FileExistsError, match="--overwrite.*--resume"):
        checkpoints.initialize_checkpoint_dir(run, keep_period=None, overwrite=False, resume=False)
    # resume on a directory without a step > 0 (nothing, step 0, an interrupted save) starts from scratch.
    for name in ("0", "5.tmp"):
        (run / name).mkdir()
        assert not checkpoints.initialize_checkpoint_dir(run, keep_period=None, overwrite=False, resume=True)[1]
    (run / "5").mkdir()
    assert checkpoints.initialize_checkpoint_dir(run, keep_period=None, overwrite=False, resume=True)[1]
    (run / "marker").write_text("x")
    _, resuming = checkpoints.initialize_checkpoint_dir(run, keep_period=None, overwrite=True, resume=False)
    assert not resuming and list(run.iterdir()) == []
    with pytest.raises(ValueError, match="resume and overwrite"):
        dataclasses.replace(torch_config.get_config("debug_pi05"), resume=True, overwrite=True)


def test_quantized_resume_requantizes_within_one_int8_step(tmp_path):
    config = dataclasses.replace(torch_config.get_config("debug_lora"), quantize_frozen=True)
    model, state = _filled(config)
    codes = {name: (m.qweight.clone(), m.scale.clone()) for name, m in model.named_modules() if quant.is_quant(m)}
    assert codes
    manager, _ = checkpoints.initialize_checkpoint_dir(tmp_path / "run", keep_period=None, overwrite=False,
                                                       resume=False)
    checkpoints.save_state(manager, model, state, 0)
    served = interop.read_safetensors(tmp_path / "run" / "0" / interop.CHECKPOINT_FILE)
    assert set(served) == set(quant.dequantize_tree(_fresh(config)[0]).state_dict())  # the plain layout
    fresh_model, fresh = _fresh(config)
    restored = checkpoints.restore_state(manager, fresh_model, fresh)
    _assert_bit_equal(restored.params, state.params, "params")
    _assert_bit_equal(restored.opt_state, state.opt_state, "opt_state")
    moved, total = 0, 0
    for name, m in fresh_model.named_modules():
        if quant.is_quant(m):
            q0, s0 = codes[name]
            diff = (m.qweight.to(torch.int32) - q0.to(torch.int32)).abs()
            assert int(diff.max()) <= 1, name
            moved += int((diff > 0).sum())
            total += diff.numel()
            torch.testing.assert_close(m.scale, s0, rtol=2**-8, atol=0)  # a bf16 rounding of 127 · s
    print(f"requantized codes that moved: {moved} of {total}")
    assert moved == LORA_REQUANT_MOVED, moved


def test_jax_serves_the_ports_checkpoint(tmp_path):
    config = dataclasses.replace(torch_config.get_config("debug_pi05"), exp_name="serve", num_train_steps=2,
                                 checkpoint_base_dir=str(tmp_path), save_interval=100)
    model, _ = train_lib.main(config, device="cpu")
    ckpt = config.checkpoint_dir / "1"
    jax_cfg = dataclasses.replace(jax_config.get_config("pi05_flatten_fold_normal"), model=jax_pi0.Pi0Config(**DEBUG))
    torch_cfg = dataclasses.replace(torch_config.get_config("pi05_flatten_fold_normal"),
                                    model=torch_pi0.Pi0Config(**DEBUG))
    rng = np.random.default_rng(3)
    lo = rng.uniform(-1.5, -0.5, 32)
    stats = {k: normalize.NormStats(mean=np.zeros(32), std=np.ones(32), q01=lo, q99=lo + rng.uniform(1, 3, 32))
             for k in ("state", "actions")}
    normalize.save(ckpt / "assets" / "data/FlattenFold/base", stats)
    np.random.seed(11)
    obs = jax_agilex.make_agilex_example()
    noise = np.random.default_rng(4).standard_normal((50, 32)).astype(np.float32)
    ref = jax_policy_config.create_trained_policy(jax_cfg, ckpt).infer(obs, noise=noise)["actions"]
    out = policy_config.create_trained_policy(torch_cfg, ckpt, device="cpu").infer(obs, noise=noise)["actions"]
    err = float(np.abs(out - np.asarray(ref)).max())
    print(f"max abs difference of the actions {err:.3e} (|actions| max {np.abs(ref).max():.3f})")
    assert out.shape == (50, 14) and np.isfinite(out).all() and err <= 1e-3, err
