"""SwitchBack in the port's advantage evaluator, against the JAX package's.

JAX's estimator reads ``KAI0_INT8_SB_GEMMA`` when its value function traces,
so its ``SimpleValueEvaluator`` runs the Gemma FFN by SwitchBack whenever the
variable selects it; the port's evaluator installs ``ops/quant.switchback_tree``
from the environment (set with ``monkeypatch`` before either package builds
or traces).

A debug estimator (f32, numpy-seeded, the port's ``model.safetensors``) on
three 6-frame 48x64 videos, 1-timestep mode at batch 4 (one full and one
padded batch), JAX's key-0 draws: values within 1e-5 of JAX's (the bf16
evaluator's bar in ``test_torch_stage_advantage.py``; measured 1.5e-8), and
off the port's bf16 evaluator's.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _sp_model
from _torch_parity import DEBUG, numpy_params
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.advantage.evaluator import SimpleValueEvaluator as JaxEvaluator
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import advantage as jax_advantage
from kai0_tpu.models import tokenizer as jax_tokenizer
from kai0_tpu_torch import knobs
from kai0_tpu_torch.advantage.evaluator import SimpleValueEvaluator
from kai0_tpu_torch.models import advantage
from kai0_tpu_torch.ops import quant
from kai0_tpu_torch.training import config as torch_config

VALUE_TOL = 1e-5
ESTIMATOR = dict(DEBUG, max_token_len=48, discrete_state_input=False, loss_action_weight=0.0, loss_value_weight=1.0)
FRAMES, BATCH = 6, 4
PROMPT = "Flatten and fold the cloth."


@pytest.fixture(autouse=True)
def _sb_gemma_ffn(monkeypatch):
    for name in knobs.ENV.values():
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KAI0_INT8_SB_GEMMA", "ffn")



def _videos(root) -> list:
    import cv2

    rng = np.random.default_rng(31)
    paths = []
    for camera in ("top_head", "hand_left", "hand_right"):
        path = root / f"{camera}.mp4"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        for _ in range(FRAMES):
            writer.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
        writer.release()
        paths.append(path)
    return paths


def test_switchback_evaluator_matches_jax(tmp_path, monkeypatch):
    sp = tmp_path / "tokenizer.model"
    sp.write_bytes(_sp_model.build_paligemma_like_bpe(jax_tokenizer.PALIGEMMA_VOCAB_SIZE)[0])
    monkeypatch.setenv("KAI0_PALIGEMMA_TOKENIZER", str(sp))
    jax_model_config = jax_advantage.AdvantageEstimatorConfig(**ESTIMATOR)
    params = numpy_params(jax_model_config, seed=3)
    tsf.save_torch_checkpoint(params, jax_model_config, tmp_path / "ckpt")
    paths = _videos(tmp_path)

    ev = JaxEvaluator.__new__(JaxEvaluator)  # tests/test_stage_advantage.py's manual init: no registry
    ev.config, ev.model_config, ev.batch_size, ev.num_workers = None, jax_model_config, BATCH, 2
    ev._executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    ev._params = params
    ev.tokenizer = jax_tokenizer.PaligemmaTokenizer(jax_model_config.max_token_len)
    ev._rng = jax.random.key(0)
    ev._values_fn = jax.jit(functools.partial(lambda m, p, r, o: m.sample_values(p, r, o), jax_model_config))
    noise_rng, time_rng = jax.random.split(jax.random.key(0))
    draws = (np.asarray(jax.random.normal(noise_rng, (BATCH, 50, 32))),
             np.asarray(jax.random.beta(time_rng, 1.5, 1, (BATCH,)) * 0.999 + 0.001))
    config = torch_config.get_config("ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD")
    config = dataclasses.replace(config, model=advantage.AdvantageEstimatorConfig(**ESTIMATOR))

    def port_values(environment: str) -> list[float]:
        monkeypatch.setenv("KAI0_INT8_SB_GEMMA", environment)
        port = SimpleValueEvaluator(config, tmp_path / "ckpt", num_workers=2, batch_size=BATCH, device="cpu",
                                    param_dtype=torch.float32, draws=draws)
        try:
            assert sum(quant.is_switchback(m) for m in port.model.modules()) == (24 if environment == "ffn" else 0)
            return [r["absolute_value"] for r in port.evaluate_video_1timestep_advantage(paths, PROMPT)]
        finally:
            port.shutdown()

    try:
        want = [r["absolute_value"] for r in ev.evaluate_video_1timestep_advantage(paths, PROMPT)]
    finally:
        ev.shutdown()
    got = port_values("ffn")
    plain = port_values("0")
    err = max(abs(a - b) for a, b in zip(got, want, strict=True))
    print(f"SwitchBack evaluator: {len(got)} values, max abs {err:.3e} (|values| max {max(map(abs, want)):.3f})")
    assert len(got) == len(want) == FRAMES and err <= VALUE_TOL
    assert max(abs(a - b) for a, b in zip(got, plain, strict=True)) > 1e-6
