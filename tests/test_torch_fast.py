"""The port's π₀-FAST (``models/{pi0_fast,gemma_fast}.py``) against ``kai0_tpu.models.{pi0_fast,gemma_fast}``.

Debug size (``dummy`` Gemma, ``mu/14`` SigLIP, f32, 48 prompt tokens, 8-dim
actions over 10 steps), numpy-seeded weights (``_torch_parity.numpy_params``)
carried across by the port's weight function ``interop.state_from_jax``
(the JAX package's ``torch_safetensors`` has no FAST mapping). Tolerances:

- ``gemma_fast.apply``: the prefill (a prefix-LM mask padded by 4 decode
  slots) and one decode step against the cache it left: prelogits and
  logits within 1e-5 x max(1, |x|);
- ``compute_loss`` within 1e-5, every gradient within 1e-4 x max(its max
  abs, 1e-5) (JAX's value_and_grad jitted);
- greedy ``sample_actions`` at ``max_decoding_steps=8``, batch 2: the token
  buffers equal JAX's bit for bit, and the batch equals each row decoded
  alone (``tests/test_pi0_fast.py:50``);
- EOS: with the EOS embedding row moved (by least squares on the
  hidden states) so that both rows emit EOS at step 1, both packages stop
  there (buffers ``[t, 1, 0, ...]``); with only one row emitting it, both
  decode all 8 steps;
- ``left_to_right_align`` and ``put_along_last_axis`` bit-equal;
- every π₀-FAST config of the JAX registry builds at dummy size
  (``train_lib.create_model``), with JAX's freeze filter, and
  ``FakeDataset`` items carry the token masks bit-equal to JAX's.

``create_trained_policy`` of both packages on a raw DROID observation is in
``test_torch_fast_tokenizer.py``, with the rest of the FAST chain.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import numpy_params, to_torch
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.models import gemma_fast as jax_gemma_fast
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0_fast as jax_fast
from kai0_tpu.ops.masks import make_attn_mask as jax_make_attn_mask
from kai0_tpu.training import config as jax_config_module
from kai0_tpu.training import data_loader as jax_data_loader
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch import interop
from kai0_tpu_torch.models import gemma as torch_gemma
from kai0_tpu_torch.models import gemma_fast
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.models import pi0_fast
from kai0_tpu_torch.training import config as torch_config_module
from kai0_tpu_torch.training import data_loader
from kai0_tpu_torch.training import train_lib

BATCH, TOKENS, STEPS = 2, 48, 8
FAST = dict(paligemma_variant="dummy", vision_variant="mu/14", dtype="float32", action_dim=8, action_horizon=10,
            max_token_len=TOKENS)


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(params).items()}


def _port_model(params, **overrides):
    model = pi0_fast.Pi0FAST(pi0_fast.Pi0FASTConfig(**{**FAST, **overrides}), device="cpu")
    return interop.load_jax_state(model, interop.state_from_jax(_flat(params), model))


@pytest.fixture(scope="module", autouse=True)
def no_hf_processor():
    """Both packages' ``FASTTokenizer`` take the DCT codec: ``transformers`` does not import. (Given a hub id, the
    JAX package's ``from_pretrained(local_files_only=True)`` still queries the hub for optional files.)"""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        yield


@pytest.fixture(scope="module")
def models():
    jax_config = jax_fast.Pi0FASTConfig(**FAST)
    params = numpy_params(jax_config, seed=0)
    return jax_config, params, _port_model(params)


def _inputs(seed: int, batch: int = BATCH, used=(20, 31)) -> dict:
    """Model-facing FAST inputs: three cameras, a prompt of ``used`` tokens whose last 6 are causal and in the loss."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((batch, TOKENS), bool)
    ar = np.zeros((batch, TOKENS), np.int32)
    for b in range(batch):
        mask[b, : used[b]] = True
        ar[b, used[b] - 6 : used[b]] = 1
    tokens = rng.integers(2, 257_152, (batch, TOKENS), dtype=np.int32)
    return {
        "image": {k: rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8) for k in pi0_fast.FAST_IMAGE_KEYS},
        "image_mask": {k: np.ones(batch, bool) for k in pi0_fast.FAST_IMAGE_KEYS},
        "state": rng.standard_normal((batch, 8)).astype(np.float32),
        "tokenized_prompt": np.where(mask, tokens, 0).astype(np.int32),
        "tokenized_prompt_mask": mask,
        "token_ar_mask": ar,
        "token_loss_mask": ar.astype(bool),
    }


def _row(inputs: dict, i: int) -> dict:
    return {k: _row(v, i) if isinstance(v, dict) else v[i : i + 1] for k, v in inputs.items()}


def _close(got, want, tol, what):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def test_gemma_fast_prefill_and_decode_logits_match(models):
    jax_config, params, model = models
    llm, lm = params["PaliGemma"]["llm"], model._pg.language_model
    rng = np.random.default_rng(3)
    t, pad = 12, 4
    emb = rng.standard_normal((BATCH, t, 64)).astype(np.float32)
    input_mask = np.arange(t)[None, :] < np.array([[9], [12]])
    ar = (np.arange(t)[None, :] >= 7).astype(np.int32).repeat(BATCH, 0)
    mask = np.asarray(jax_make_attn_mask(input_mask, ar))
    mask = np.concatenate([mask, np.zeros((BATCH, t, pad), bool)], axis=-1)
    positions = (np.cumsum(input_mask, axis=1) - 1).astype(np.int32)
    apply = jax.jit(functools.partial(jax_gemma_fast.apply, config=jax_config.paligemma_config, embed_dtype="float32"))
    want, cache = apply(llm, embedded=emb, positions=positions, mask=mask)
    got, kv = gemma_fast.apply(lm, torch.from_numpy(emb), torch.from_numpy(positions), torch.from_numpy(mask),
                               embed_dtype=torch.float32)
    assert kv.idx == t and tuple(kv.k.shape) == cache.k.shape == (4, BATCH, t + pad, 1, 16)
    _close(got, want, 1e-5, "prefill prelogits")
    _close(kv.k[:, :, :t], cache.k[:, :, :t], 1e-5, "prefill k")
    _close(torch_gemma.decode_logits(lm, got), jax_gemma_fast.decode_logits(llm, want), 1e-5, "prefill logits")

    token = np.array([[5], [77]], np.int32)
    step_mask = (np.arange(t + pad)[None, None, :] < t + 1) & (np.arange(t + pad)[None, None, :] >= np.array([[[0]], [[0]]]))
    step_pos = positions[:, -1:] + 1
    want, cache = apply(llm, embedded=jax_gemma_fast.embed(llm, token, "float32"), positions=step_pos, mask=step_mask,
                        kv_cache=cache)
    got, kv = gemma_fast.apply(lm, torch_gemma.embed(lm, torch.from_numpy(token), torch.float32),
                               torch.from_numpy(step_pos), torch.from_numpy(step_mask), kv_cache=kv,
                               embed_dtype=torch.float32)
    assert kv.idx == t + 1 and int(cache.idx[0]) == t + 1
    _close(got, want, 1e-5, "decode prelogits")
    _close(torch_gemma.decode_logits(lm, got), jax_gemma_fast.decode_logits(llm, want), 1e-5, "decode logits")
    _close(kv.v[:, :, t], cache.v[:, :, t], 1e-5, "the decoded token's v, written in place at idx")
    assert not kv.k[:, :, t + 1 :].any()


def test_compute_loss_and_every_gradient_match(models):
    jax_config, params, model = models
    inputs = _inputs(1)
    obs = jax_model.Observation.from_dict(inputs)

    def loss_fn(p):
        loss = jax_fast.compute_loss(p, jax_config, jax.random.key(0), obs, None)
        return jnp.mean(loss), loss

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model.zero_grad(set_to_none=True)
    got = model.compute_loss(torch_model.Observation.from_dict(to_torch(inputs)))
    got.mean().backward()
    assert got.shape == (BATCH,) and float(got.detach().min()) > 5  # ~log(257152) on random weights
    _close(got.detach(), want, 1e-5, "loss")
    want_grads = interop.state_from_jax(_flat(grads), model)
    for name, p in model.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        ref = want_grads[name]
        assert np.abs(g - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1e-5), (name, np.abs(g - ref).max())
    model.zero_grad(set_to_none=True)


@functools.cache
def _jax_sampler(jax_config, steps: int):
    return jax.jit(functools.partial(jax_fast.sample_actions, config=jax_config, max_decoding_steps=steps))


def _jax_sample(jax_config, params, inputs, steps=STEPS):
    sample = _jax_sampler(jax_config, steps)
    return np.asarray(sample(params, rng=jax.random.key(1), observation=jax_model.Observation.from_dict(inputs)))


def _port_sample(model, inputs, steps=STEPS):
    return model.sample_actions(torch_model.Observation.from_dict(to_torch(inputs)), max_decoding_steps=steps).numpy()


def test_greedy_tokens_equal_jax_and_the_batch_equals_each_row(models):
    jax_config, params, model = models
    inputs = _inputs(5)
    want = _jax_sample(jax_config, params, inputs)
    got = _port_sample(model, inputs)
    assert got.dtype == want.dtype == np.float32 and got.shape == (BATCH, STEPS)
    np.testing.assert_array_equal(got, want)
    assert (got != 1).all() and len({tuple(r) for r in got}) == BATCH  # no EOS; the rows differ
    for i in range(BATCH):
        np.testing.assert_array_equal(_port_sample(model, _row(inputs, i)), got[i : i + 1])


def test_left_to_right_align_and_put_along_last_axis_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 10, 4)).astype(np.float32)
    input_mask = np.arange(10)[None, :] < np.array([[3], [10], [7]])
    attn = rng.random((3, 10, 10)) > 0.5
    want = jax_fast.left_to_right_align(x, input_mask, attn)
    got = pi0_fast.left_to_right_align(torch.from_numpy(x), torch.from_numpy(input_mask), torch.from_numpy(attn))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    arr = rng.standard_normal((3, 6)).astype(np.float32)
    idx = np.array([[0], [5], [2]])
    vals = np.array([[7.0], [8.0], [9.0]], np.float32)
    np.testing.assert_array_equal(
        pi0_fast.put_along_last_axis(torch.from_numpy(arr), torch.from_numpy(idx), torch.from_numpy(vals)).numpy(),
        np.asarray(jax_fast.put_along_last_axis(jnp.asarray(arr), jnp.asarray(idx), jnp.asarray(vals))))


def test_eos_stops_the_loop_at_jax_step(models, monkeypatch):
    jax_config, params, model = models
    inputs = _inputs(5)
    hidden = []
    decode = pi0_fast._gemma.decode_logits
    monkeypatch.setattr(pi0_fast._gemma, "decode_logits", lambda lm, x: (hidden.append(x[:, -1]), decode(lm, x))[1])
    free = _port_sample(model, inputs, steps=3)
    monkeypatch.undo()
    h = torch.stack(hidden[:2]).numpy().astype(np.float64)  # [step 0/1, B, D]: the states read at steps 0 and 1
    table = model._pg.language_model.embed_tokens.weight.detach().numpy().astype(np.float64)
    top = np.einsum("sbd,sbd->sb", h, table[free[:, :2].astype(int).T])  # each row's winning logit at steps 0, 1

    def with_eos_row(rows_at_step1):
        """Params whose EOS row loses at step 0 and wins at step 1 for ``rows_at_step1`` (least squares on h)."""
        lhs, rhs = [], []
        for b in range(BATCH):
            lhs.append(h[0, b])
            rhs.append(top[0, b] - 2.0)
            lhs.append(h[1, b])
            rhs.append(top[1, b] + (2.0 if b in rows_at_step1 else -2.0))
        row = np.linalg.lstsq(np.stack(lhs), np.array(rhs), rcond=None)[0].astype(np.float32)
        flat = _flat(params)
        table = flat["PaliGemma/llm/embedder/input_embedding"].copy()
        table[1] = row
        flat["PaliGemma/llm/embedder/input_embedding"] = table
        return unflatten_dict(flat)

    for rows in ((0, 1), (0,)):
        p = with_eos_row(rows)
        want = _jax_sample(jax_config, p, inputs)
        got = _port_sample(_port_model(p), inputs)
        np.testing.assert_array_equal(got, want)
        for b in range(BATCH):
            assert got[b, 0] == free[b, 0] and (got[b, 1] == 1) == (b in rows), (rows, got)
        # The loop stops at the first step at which every row emits EOS (JAX's cond), else runs all steps.
        stop = next((s for s in range(STEPS) if (got[:, s] == 1).all()), STEPS - 1)
        assert stop == (1 if len(rows) == BATCH else stop) and stop > 1 or len(rows) == BATCH, (rows, got)
        assert got[:, : stop + 1].all() and not got[:, stop + 1 :].any(), (rows, got)


def test_every_fast_config_builds_at_dummy_size_with_jax_freeze_filter():
    names = [n for n, c in jax_config_module.registry().items() if type(c.model).__name__ == "Pi0FASTConfig"]
    assert len(names) == 10
    built = {}
    for name in names:
        cfg = torch_config_module.get_config(name)
        jax_cfg = jax_config_module.get_config(name)
        assert cfg.model.model_type.value == "pi0_fast" and cfg.model.max_token_len == jax_cfg.model.max_token_len
        lora = "lora" in cfg.model.paligemma_variant
        model_config = dataclasses.replace(cfg.model, paligemma_variant="dummy_lora" if lora else "dummy",
                                           vision_variant="mu/14", fast_model_tokenizer=None,
                                           fast_model_tokenizer_kwargs=None)
        if model_config not in built:
            built[model_config] = train_lib.create_model(dataclasses.replace(cfg, model=model_config), device="cpu")
        model = built[model_config]
        assert isinstance(model, pi0_fast.Pi0FAST)
        frozen = dataclasses.replace(jax_cfg.model, paligemma_variant=model_config.paligemma_variant).freeze_filter()
        mask = train_lib.trainable_mask(model)
        from kai0_tpu_torch import param_paths

        for param_name, trainable in mask.items():
            assert trainable == (not frozen(param_paths.jax_param_path(param_name))), (name, param_name)
        assert (not all(mask.values())) == lora, name


def test_fake_items_carry_the_token_masks_as_jax():
    jax_items = jax_data_loader.FakeDataset(jax_fast.Pi0FASTConfig(**FAST), 4)
    items = data_loader.FakeDataset(pi0_fast.Pi0FASTConfig(**FAST), 4)
    for i in range(2):
        want, got = jax_items[i], items[i]
        for key in ("state", "tokenized_prompt", "tokenized_prompt_mask", "token_ar_mask", "token_loss_mask",
                    "actions"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
            assert got[key].dtype == np.asarray(want[key]).dtype, key
        for key in pi0_fast.FAST_IMAGE_KEYS:
            np.testing.assert_array_equal(got["image"][key], np.asarray(want["image"][key]))
    batch = {k: to_torch(np.stack([items[i][k] for i in range(2)])) for k in ("state", "token_ar_mask")}
    obs = torch_model.Observation.from_dict({**{k: v for k, v in batch.items()}, "image": {}, "image_mask": {}})
    assert obs.token_ar_mask.shape == (2, TOKENS)


def test_a_fast_train_step_saves_and_restores_bit_equal(tmp_path):
    """One ``train_step`` of a dummy π₀-FAST on fake data, saved and restored by the port's checkpoints: parameters
    and moments bit-equal; ``model.safetensors`` holds the FAST tree."""
    from kai0_tpu_torch.training import checkpoints

    model_config = pi0_fast.Pi0FASTConfig(**FAST)
    config = torch_config_module.TrainConfig(name="fast_debug", model=model_config, ema_decay=None)
    item = data_loader.FakeDataset(model_config, 1)[0]
    batch = {k: to_torch(v[None]) for k, v in item.items() if not isinstance(v, dict)}
    batch.update({k: {n: to_torch(x[None]) for n, x in item[k].items()} for k in ("image", "image_mask")})
    obs = torch_model.Observation.from_dict(batch)

    def fresh():
        model = train_lib.create_model(config, device="cpu")
        return model, train_lib.init_train_state(model, config, device="cpu")

    model, state = fresh()
    state, info = train_lib.train_step(model, state, (obs, batch["actions"]), config)
    assert np.isfinite(float(info["loss"])) and float(info["grad_norm"]) > 0
    manager, _ = checkpoints.initialize_checkpoint_dir(tmp_path / "run", keep_period=None, overwrite=False,
                                                       resume=False)
    checkpoints.save_state(manager, model, state, 0)
    served = interop.read_safetensors(tmp_path / "run" / "0" / interop.CHECKPOINT_FILE)
    assert "paligemma_with_expert.paligemma.model.language_model.layers.0.mlp.gate_proj.weight" in served
    assert not any("gemma_expert" in k or "action_" in k for k in served)
    other, other_state = fresh()
    restored = checkpoints.restore_state(manager, other, other_state)
    for name, value in model.state_dict().items():
        assert torch.equal(other.state_dict()[name], value), name
    for group in ("mu", "nu"):
        for name, value in flatten_dict(state.opt_state[group]).items():
            assert torch.equal(flatten_dict(restored.opt_state[group])[name], value), (group, name)
    assert restored.step == state.step == 1
