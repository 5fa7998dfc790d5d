"""The port's training entry point: a resumed step, the command line, weight loading and the script.

- A step from a restored state is bit-equal (loss, grad_norm, parameters,
  moments, EMA) to the same step from the in-memory state on the same
  batch: the default f32 configuration with its EMA, and bf16 parameters
  with bf16 moments and no EMA (the stochastic roundings draw from
  (seed, step)).
- The port's ``cli`` and JAX's ``cli`` give equal values, for the same argv,
  on every field the port's config has (the weight loader's path aside: the
  port reads ``model.safetensors``).
- ``CheckpointWeightLoader``: a ``debug_pi05`` checkpoint loads into
  ``debug_lora``, whose LoRA factors it does not hold, with those filled from
  the fresh init; a loader with an unknown or a missing key is refused, as
  are ``gs://`` paths and ``PaliGemmaWeightLoader``.
- ``main`` writes a ``torch.profiler`` trace of ``profile_steps`` steps, and
  refuses ``fsdp_devices`` > 1 (ROADMAP Queue 1 item 10).
- ``scripts/train_torch.py`` imports nothing of JAX; ``--help`` and a
  misspelt config name exit with JAX's usage and did-you-mean text; one CPU
  step through the script writes its checkpoint.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.training import cli as jax_cli
from kai0_tpu.training import config as jax_config
from kai0_tpu_torch import interop
from kai0_tpu_torch.training import checkpoints
from kai0_tpu_torch.training import config as torch_config
from kai0_tpu_torch.training import data_loader, optimizer, train_lib, weight_loaders

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("bundle", [False, True], ids=["f32_ema", "bf16"])
def test_a_step_from_a_restored_state_is_bit_equal(tmp_path, bundle):
    config = torch_config.get_config("debug_pi05")
    if bundle:
        config = dataclasses.replace(config, param_dtype="bfloat16", ema_decay=None,
                                     optimizer=optimizer.AdamW(state_dtype="bfloat16"))
    batches = list(data_loader.create_data_loader(config, device="cpu", num_batches=2))
    model = train_lib.create_model(config, device="cpu")
    state, _ = train_lib.train_step(model, train_lib.init_train_state(model, config, device="cpu"), batches[0], config)
    manager, _ = checkpoints.initialize_checkpoint_dir(tmp_path, keep_period=None, overwrite=True, resume=False)
    checkpoints.save_state(manager, model, state, 0)
    fresh = train_lib.create_model(dataclasses.replace(config, seed=0), device="cpu")
    restored = checkpoints.restore_state(manager, fresh, train_lib.init_train_state(fresh, config, device="cpu",
                                                                                     resume=True))
    state, info = train_lib.train_step(model, state, batches[1], config)
    restored, info_r = train_lib.train_step(fresh, restored, batches[1], config)
    assert state.step == restored.step == 2
    for key in ("loss", "grad_norm"):
        assert torch.equal(info[key], info_r[key]), key
    for a, b in ((model.state_dict(), fresh.state_dict()), (state.ema or {}, restored.ema or {}),
                 *((state.opt_state[k], restored.opt_state[k]) for k in ("mu", "nu"))):
        assert set(a) == set(b)
        for name in a:
            x, y = (a[name]["q"], b[name]["q"]) if isinstance(a[name], dict) else (a[name], b[name])
            assert torch.equal(x, y), name


def _same_fields(port, ref, path=""):
    """Every field of the port's dataclass equal to JAX's where both hold plain values; returns the fields compared."""
    compared = 0
    for field in dataclasses.fields(port):
        name = f"{path}.{field.name}".lstrip(".")
        if not hasattr(ref, field.name) or name == "weight_loader":
            continue
        a, b = getattr(port, field.name), getattr(ref, field.name)
        if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
            compared += _same_fields(a, b, name)
        elif a is None or isinstance(a, (bool, int, float, str, tuple)):
            assert a == b, (name, a, b)
            compared += 1
    return compared


@pytest.mark.parametrize("argv", [
    ["debug_pi05", "--exp_name=x", "--batch_size=4", "--num_train_steps", "10", "--optimizer.state_dtype=int8",
     "--ema_decay=none", "--param_dtype=bfloat16", "--lr_schedule.peak_lr=1e-4", "--resume", "--keep-period", "3",
     "--wandb_enabled=false", "--profile_steps=2"],
    ["pi05_flatten_fold_normal", "--exp_name=run", "--data.base_config.prompt_from_task=true", "--num_workers=0",
     "--save_interval=50", "--seed=3", "--split=train", "--log_interval=10"],
    ["pi05_base", "--exp_name=x", "--overwrite", "--model.action_horizon=10", "--checkpoint_base_dir=/tmp/x",
     "--keep_period=none", "--drop_last=false", "--skip_norm_stats", "--quantize_frozen=true"],
])
def test_cli_gives_jax_values(argv):
    port = torch_config.cli(argv)
    ref = jax_cli.cli(jax_config.registry(), argv)
    assert _same_fields(port, ref) > 40


def test_checkpoint_weight_loader_fills_lora_and_rejects_unknown_keys(tmp_path):
    base = train_lib.create_model(dataclasses.replace(torch_config.get_config("debug_pi05"), seed=1), device="cpu")
    path = interop.save_torch_checkpoint(base, tmp_path)
    saved = {k: v.clone() for k, v in base.state_dict().items()}
    config = dataclasses.replace(torch_config.get_config("debug_lora"),
                                 weight_loader=weight_loaders.CheckpointWeightLoader(str(tmp_path)))
    init = train_lib.create_model(config, device="cpu").state_dict()
    model = train_lib.create_model(config, device="cpu")
    train_lib.init_train_state(model, config, device="cpu")
    lora = [k for k in init if "lora" in k]
    assert lora and set(init) == set(saved) | set(lora)
    for key, value in model.state_dict().items():
        want = init[key] if "lora" in key else saved[key].to(value.dtype)  # the frozen base is stored in bf16
        assert torch.equal(value, want), key

    class Extra(weight_loaders.NoOpWeightLoader):
        def load(self, params):
            return {**params, "action_out_proj.extra": torch.zeros(1)}

    with pytest.raises(ValueError, match=r"Unknown keys \(1\): \['action_out_proj.extra'\]"):
        train_lib.init_train_state(train_lib.create_model(config, device="cpu"),
                                   dataclasses.replace(config, weight_loader=Extra()), device="cpu")
    interop.write_safetensors({k: v for k, v in saved.items() if k != "action_in_proj.bias"}, path)
    with pytest.raises(ValueError, match=r"Missing keys \(1\): \['action_in_proj.bias'\]"):
        train_lib.init_train_state(train_lib.create_model(config, device="cpu"), config, device="cpu")
    for loader in (weight_loaders.CheckpointWeightLoader("gs://openpi-assets/checkpoints/pi05_base/params"),
                   weight_loaders.PaliGemmaWeightLoader()):
        with pytest.raises(NotImplementedError, match="local"):
            loader.load(init)


def _script(*args, cwd=REPO):
    env = {**os.environ, "PYTHONPATH": ""}
    return subprocess.run([sys.executable, str(REPO / "scripts" / "train_torch.py"), *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=120)


def test_script_usage_did_you_mean_and_a_cpu_step(tmp_path):
    import ast

    tree = ast.parse((REPO / "scripts" / "train_torch.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in imported if m.split(".")[0] in ("jax", "kai0_tpu")}, imported
    for argv in (["--help"], ["pi05_flatten_fold_norml", "--exp_name=x"]):
        out = _script(*argv)
        with pytest.raises(SystemExit) as ref:
            jax_cli.cli(torch_config.registry(), argv)
        assert out.returncode == 1 and out.stderr.strip() == str(ref.value), out.stderr
        with pytest.raises(SystemExit) as jax_ref:
            jax_cli.cli(jax_config.registry(), argv)
        assert out.stderr.splitlines()[0] == str(jax_ref.value).splitlines()[0]
    assert "Did you mean one of: ['pi05_flatten_fold_normal'" in out.stderr
    # An RLDS config reaches the stream through the command line's rlds_data_dir (here a directory without shards).
    out = _script("pi05_full_droid_finetune", "--exp_name=x", f"--data.rlds_data_dir={tmp_path / 'rlds'}",
                  f"--checkpoint_base_dir={tmp_path}", "--device=cpu", cwd=tmp_path)
    assert out.returncode == 1 and (f"no RLDS shards droid-train.tfrecord-*-of-* under {tmp_path / 'rlds' / 'droid' / '1.0.1'}"
                                    in out.stderr), out.stderr[-3000:]

    out = _script("debug_pi05", "--exp_name=s", f"--checkpoint_base_dir={tmp_path}", "--num_train_steps=1",
                  "--device=cpu", cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Step 0: grad_norm=" in out.stderr and (tmp_path / "debug_pi05" / "s" / "0" / "model.safetensors").exists()


def test_main_writes_a_profiler_trace_and_refuses_fsdp(tmp_path):
    config = dataclasses.replace(torch_config.get_config("debug_pi05"), exp_name="prof", num_train_steps=3,
                                 checkpoint_base_dir=str(tmp_path), profile_steps=1, save_interval=100)
    with pytest.raises(NotImplementedError, match="item 10"):
        train_lib.main(dataclasses.replace(config, fsdp_devices=2), device="cpu")
    train_lib.main(config, device="cpu")
    trace = config.checkpoint_dir / "profile" / "trace_steps_1-1.json"
    assert [p.name for p in trace.parent.iterdir()] == [trace.name] and trace.stat().st_size > 0
