"""The int8 modes of ``kai0_tpu_torch`` against ``kai0_tpu``'s knobs on the CPU: weight-only int8, SigLIP's
int8 serving sites, the Gemma site filter, SwitchBack's sites, their selection and a trained checkpoint's keys.

The JAX side reads ``KAI0_INT8_*`` from the environment (``monkeypatch.setenv``
before each jit); the port gets the same choice as arguments or through
``kai0_tpu_torch.knobs``. Tolerances:

- weight-only ``qmm``: its forward is one product of x with the codes cast to
  x's dtype, summed in f32 (XLA's dot and torch's in another order), times the
  column scales, rounded once: within 2 units in the last place of f32
  (1.2e-7 x max |y|) in f32, one bf16 step in bf16; its ``dx`` is the int8
  ``dx`` of ``qmm``, bit-equal. No row quantization runs in its forward.
- SigLIP's codes and scales at every site: bit-equal to the jitted
  ``quantize_inference_tree`` (``quantize_einsum_weight``).
- ``sample_actions`` of a debug π₀.₅ through both packages' ``Policy``:
  weight-only within 1e-4 (no activation is quantized: the packages differ by
  f32 rounding only), SigLIP + Gemma int8 within 5e-3 (the int8 serving bar
  of ``test_torch_policy.py``: activation codes flip on f32 rounding).
- the sets of converted parameters, the site selections and their errors: equal.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_inputs, numpy_params
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu import knobs as jax_knobs
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.ops import quant as jax_quant
from kai0_tpu.policies import policy as jax_policy
from kai0_tpu.training import cli as jax_cli
from kai0_tpu.training import config as jax_config_module
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch import interop, knobs, param_paths
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.ops import quant
from kai0_tpu_torch.policies import policy as torch_policy
from kai0_tpu_torch.training import config as torch_config
from kai0_tpu_torch.training import train_lib

DEBUG = dict(paligemma_variant="dummy", action_expert_variant="dummy", vision_variant="mu/14", dtype="float32", pi05=True)
ENV = tuple(knobs.ENV.values())


@pytest.fixture(autouse=True)
def _no_int8_environment(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module")
def models():
    jax_config = jax_pi0.Pi0Config(**DEBUG)
    params = numpy_params(jax_config, seed=11)
    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu")
    interop.load_jax_state(model, tsf.jax_to_torch_state(params, jax_config))
    return jax_config, params, model


# ---------------------------------------------------------------------------
# Weight-only int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_qmm_and_its_dx_match_jax(monkeypatch, dtype):
    rng = np.random.default_rng(5)
    x, cot, add = (rng.standard_normal(s).astype(np.float32) for s in ((24, 64), (24, 40), (24, 40)))
    w = (rng.standard_normal((64, 40)) / 8).astype(np.float32)
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    qa = jax.jit(lambda a: jax_quant.quantize_einsum_weight(a, "BD,DF->BF"))(jnp.asarray(w))
    monkeypatch.setenv("KAI0_INT8_WO", "1")

    def loss(xj, addj):
        y = jax_quant.qmm(xj, qa.q, qa.s, addj)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, yj), (dxj, _) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x, jdtype), jnp.asarray(add, jdtype))
    q, s = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(np.asarray(qa.q).T, q.numpy())
    ql = quant.QuantLinear(q, s, torch.float32, weight_only=True)
    xt, addt = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_() for a in (x, add))
    calls = []
    real = quant.row_quant
    monkeypatch.setattr(quant, "row_quant", lambda *a, **k: calls.append(k) or real(*a, **k))
    y = quant.qmm(xt, ql, addt)
    assert not calls  # the weight-only forward quantizes nothing of the activations (no K5, no K4b on the card)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert len(calls) == 1 and "col_scale" in calls[0]  # the dx stays int8: q_row(dy·s)
    want = np.asarray(yj.astype(jnp.float32))
    step = 2.0**-22 if dtype == "float32" else 2.0**-7
    assert np.abs(_bits(y) - want).max() <= step * np.abs(want).max(), np.abs(_bits(y) - want).max()
    np.testing.assert_array_equal(_bits(xt.grad), np.asarray(dxj.astype(jnp.float32)))


def _unbatched(inputs: dict) -> dict:
    return {k: ({n: x[0] for n, x in v.items()} if isinstance(v, dict) else v[0]) for k, v in inputs.items()}


def _served_actions(monkeypatch, models, env: dict, **port_modes):
    """JAX's and the port's actions of one request, each model quantized by its own ``quantize_inference_tree``."""
    jax_config, params, model = models
    obs = _unbatched(model_inputs(6))
    noise = np.random.default_rng(8).standard_normal((50, 32)).astype(np.float32)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ref = jax_policy.Policy(jax_config, jax_quant.quantize_inference_tree(params)).infer(obs, noise=noise)
    served = quant.quantize_inference_tree(copy.deepcopy(model), **port_modes)
    out = torch_policy.Policy(served, model.config, device="cpu").infer(obs, noise=noise)
    return served, out["actions"], np.asarray(ref["actions"])


def test_weight_only_sample_actions_matches_jax(monkeypatch, models):
    served, got, want = _served_actions(monkeypatch, models, {"KAI0_INT8_WO": "1"}, weight_only=True)
    holders = [m for m in served.modules() if quant.is_quant(m)]
    assert len(holders) == 2 * 4 * 6 and all(m.weight_only for m in holders)
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()


# ---------------------------------------------------------------------------
# SigLIP's int8 serving sites
# ---------------------------------------------------------------------------


def test_siglip_codes_and_scales_of_every_site_are_bit_equal(monkeypatch, models):
    _, params, model = models
    monkeypatch.setenv("KAI0_INT8_SIGLIP", "all")
    # Jitted, as the port's arithmetic follows (× f32(1/127)); eager JAX divides the unstacked head by 127.
    flat = flatten_dict(jax.jit(jax_quant.quantize_inference_tree)(params))
    served = quant.quantize_inference_tree(copy.deepcopy(model), siglip_sites=quant.SIGLIP_QUANT_SITES)
    seen = set()
    for name, holder in served.named_modules():
        path = quant.is_quant(holder) and param_paths.jax_param_path(f"{name}.qweight")
        if not path or "/img/" not in path:
            continue
        qa = flat[path]
        layer = int(name.split("layers.")[1].split(".")[0]) if "encoder.layers." in name else None
        q, s = (np.asarray(qa.q), np.asarray(qa.s)) if layer is None else (np.asarray(qa.q[layer]), np.asarray(qa.s[layer]))
        np.testing.assert_array_equal(holder.qweight.numpy(), q.T, err_msg=name)
        np.testing.assert_array_equal(holder.scale.numpy(), s, err_msg=name)
        assert holder.bias is not None and not holder.bias.requires_grad
        seen.add(path)
    assert len(seen) == 7  # query, key, value, out, Dense_0, Dense_1 (one stacked layer each) and the head
    restored = quant.dequantize_tree(served)
    assert not quant.has_quant(restored)
    assert set(restored.state_dict()) == set(model.state_dict())  # biased layers come back whole


def test_siglip_and_gemma_int8_sample_actions_matches_jax(monkeypatch, models):
    served, got, want = _served_actions(monkeypatch, models, {"KAI0_INT8_SIGLIP": "all"},
                                        siglip_sites=quant.siglip_inference_sites("all"))
    assert sum(quant.is_quant(m) for m in served.modules()) == 2 * 4 * 6 + 7
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 5e-3, np.abs(got - want).max()


# ---------------------------------------------------------------------------
# Site selection and the sets of converted parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["all", "", "q_einsum,kv", "-gating", "attn,-vec", "mlp", "linear,-mlp", "bogus",
                                  "-nothing"])
def test_gemma_site_filter_matches_jax(monkeypatch, spec):
    monkeypatch.setenv("KAI0_INT8_SITES", spec)
    try:
        want = [p.pattern for p, _, _ in jax_quant._active_sites()]
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" matches")[0].replace("'", ".")):
            quant.gemma_sites(spec)
        return
    assert [p.pattern for p in quant.gemma_sites(spec)] == want


@pytest.mark.parametrize("spec", ["0", "1", "all", "ALL", "attn", "mlp,head", " head ", "Dense_1", "off", "bogus"])
def test_siglip_site_selection_matches_jax(monkeypatch, spec):
    monkeypatch.setenv("KAI0_INT8_SIGLIP", spec)
    try:
        want = [p.pattern for p, _, _ in jax_quant._siglip_inference_sites()]
    except ValueError as e:
        with pytest.raises(ValueError, match="selects no SigLIP quant site"):
            quant.siglip_inference_sites(spec)
        assert "selects no SigLIP quant site" in str(e)
        return
    assert [p.pattern for p in quant.siglip_inference_sites(spec)] == want


@pytest.mark.parametrize("spec", ["0", "1", "all", "false", "ON", "ffn", "attn", "attn,ffn", "mlp,head", "ffn,Head"])
def test_switchback_site_switches_match_jax(monkeypatch, spec):
    monkeypatch.setenv("KAI0_INT8_SB_GEMMA", spec)
    monkeypatch.setenv("KAI0_INT8_SB", spec)
    for site in ("attn", "ffn"):
        assert quant.switchback_on(spec, site) == jax_quant.switchback_gemma_enabled(site), site
    for site in ("attn", "mlp", "head"):
        assert quant.switchback_on(spec, site) == jax_quant.switchback_enabled(site), site


def test_knobs_resolve_with_jax_precedence(monkeypatch):
    """The environment over the config over the defaults, with JAX's names, spellings and defaults."""
    fields = [f.name for f in dataclasses.fields(knobs.Knobs)]
    assert {k: jax_knobs._ENV[k] for k in fields} == knobs.ENV
    assert {k: jax_knobs._DEFAULTS[k] for k in fields} == knobs.DEFAULTS
    configured = dict(int8_sb_gemma="ffn", int8_weight_only=True, int8_sites="-gating")
    cases = [({}, None), ({}, configured), ({"KAI0_INT8_SB_GEMMA": "attn", "KAI0_INT8_WO": "0"}, configured),
             ({"KAI0_INT8_SB": "mlp,head", "KAI0_INT8_SIGLIP": "all", "KAI0_INT8_SITES": "", "KAI0_INT8_WO": "yes"},
              None)]
    try:
        for env, conf in cases:
            for name in ENV:
                monkeypatch.delenv(name, raising=False)
            for name, value in env.items():
                monkeypatch.setenv(name, value)
            jax_knobs.configure(None if conf is None else jax_knobs.Knobs(**conf))
            want = {k: getattr(jax_knobs.get(), k) for k in fields}
            assert dataclasses.asdict(knobs.resolve(None if conf is None else knobs.Knobs(**conf))) == want, env
    finally:
        jax_knobs.configure(None)


def test_cli_sets_the_knobs_as_jax_does():
    argv = ["debug_pi05", "--exp_name=x", "--knobs.int8_sb_gemma=ffn", "--knobs.int8_switchback=mlp,head",
            "--knobs.int8_weight_only=true", "--knobs.int8_sites=-gating", "--knobs.int8_siglip=all"]
    port = torch_config.cli(argv).knobs
    ref = jax_cli.cli(jax_config_module.registry(), argv).knobs
    assert dataclasses.asdict(port) == {f.name: getattr(ref, f.name) for f in dataclasses.fields(port)}


def _jax_paths(params: dict, patterns) -> set[str]:
    return {k for k in flatten_dict(params) if any(p.search(k) for p in patterns)}


@pytest.mark.parametrize("sites,siglip", [("all", "all"), ("-gating", "mlp,head"), ("attn", "0"), ("linear", "attn")])
def test_inference_tree_converts_what_jax_converts(monkeypatch, models, sites, siglip):
    _, params, model = models
    monkeypatch.setenv("KAI0_INT8_SITES", sites)
    monkeypatch.setenv("KAI0_INT8_SIGLIP", siglip)
    want = {k for k, v in flatten_dict(jax_quant.quantize_inference_tree(params)).items() if jax_quant.is_quant(v)}
    served = quant.quantize_inference_tree(copy.deepcopy(model), sites=quant.gemma_sites(sites),
                                           siglip_sites=quant.siglip_inference_sites(siglip))
    got = {param_paths.jax_param_path(f"{n}.qweight") for n, m in served.named_modules() if quant.is_quant(m)}
    assert got == want


@pytest.mark.parametrize("gemma,siglip", [("ffn", "0"), ("attn", "head"), ("all", "all"), ("0", "mlp")])
def test_switchback_tree_takes_the_sites_jax_routes(models, gemma, siglip):
    """JAX converts no parameter for SwitchBack: its switches route the einsums of the site patterns. The port's
    ``SwitchBackLinear`` layers are those parameters, name for name, and nothing else of the model changes."""
    _, params, model = models
    model = copy.deepcopy(model)
    patterns = [p for site, ps in (("attn", jax_quant._GEMMA_QUANT_SITES[:4]), ("ffn", jax_quant._GEMMA_QUANT_SITES[4:]))
                if quant.switchback_on(gemma, site) for p, _, _ in ps]
    patterns += [p for site, ps in (("attn", jax_quant._SIGLIP_QUANT_SITES[:2]), ("mlp", jax_quant._SIGLIP_QUANT_SITES[2:4]),
                                    ("head", jax_quant._SIGLIP_QUANT_SITES[4:]))
                 if quant.switchback_on(siglip, site) for p, _, _ in ps]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    quant.switchback_tree(model, gemma=gemma, siglip=siglip)
    got = {param_paths.jax_param_path(f"{n}.weight") for n, m in model.named_modules() if quant.is_switchback(m)}
    assert got == _jax_paths(params, patterns)
    state = model.state_dict()
    assert list(state) == list(before) and all(torch.equal(state[k], v) for k, v in before.items())


def test_lora_int8_base_with_a_site_filter_converts_what_jax_converts(monkeypatch):
    """``quantize_frozen=True`` under ``KAI0_INT8_SITES=-gating``: the frozen base's holders, name for name."""
    lora = dict(DEBUG, paligemma_variant="dummy_lora", action_expert_variant="dummy_lora")
    jax_config = jax_pi0.Pi0Config(**lora)
    frozen = jax_config.freeze_filter()
    flat = flatten_dict(numpy_params(jax_config, seed=3))
    mask = {k: not frozen(k) for k in flat}
    monkeypatch.setenv("KAI0_INT8_SITES", "-gating")
    want = {k for k, v in flatten_dict(jax_quant.quantize_frozen_tree(unflatten_dict(flat), unflatten_dict(mask))).items()
            if jax_quant.is_quant(v)}
    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**lora), device="cpu")
    train_lib.freeze_params(model, quantize=True)
    got = {param_paths.jax_param_path(f"{n}.qweight") for n, m in model.named_modules() if quant.is_quant(m)}
    assert got == want and not any("gating" in k for k in got) and any("linear" in k for k in got)


# ---------------------------------------------------------------------------
# A trained checkpoint with SwitchBack on
# ---------------------------------------------------------------------------


def test_switchback_training_writes_the_keys_of_a_bf16_run(tmp_path):
    """Two steps of ``train_lib.main`` on ``debug_pi05`` with ``--knobs.int8_sb_gemma=ffn`` (the fused SwitchBack
    FFN) and without: the same checkpoint keys (model and optimizer state), and different losses."""
    from kai0_tpu_torch.interop import read_safetensors
    from kai0_tpu_torch.training import checkpoints

    runs = {}
    for label, extra in (("bf16", []), ("sb", ["--knobs.int8_sb_gemma=ffn"])):
        config = torch_config.cli(["debug_pi05", f"--exp_name={label}", f"--checkpoint_base_dir={tmp_path}",
                                   "--num_train_steps=2", "--save_interval=1", *extra])
        losses = []
        model, state = train_lib.main(config, device="cpu", on_step=lambda step, record: losses.append(float(record["loss"])))
        step_dir = checkpoints.CheckpointManager(config.checkpoint_dir, keep_period=None).step_dir(1)
        runs[label] = (model, losses, {f.name: set(read_safetensors(f)) for f in step_dir.glob("*.safetensors")})
    (bf16, bf16_losses, bf16_files), (sb, sb_losses, sb_files) = runs["bf16"], runs["sb"]
    assert not any(quant.is_switchback(m) for m in bf16.modules())
    assert sum(quant.is_switchback(m) for m in sb.modules()) == 2 * 4 * 3  # gate, up, down of both experts
    assert sb_files == bf16_files and len(sb_files) == 2 and all(sb_files.values())
    assert bf16_losses[0] != sb_losses[0] and np.isfinite(sb_losses).all()


def test_serving_script_flags_set_the_config_knobs(monkeypatch):
    """``scripts/serve_policy_torch.py``'s ``--int8_*`` flags reach ``create_trained_policy`` as the config's knobs."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "serve_policy_torch.py"
    spec = importlib.util.spec_from_file_location("serve_policy_torch_modes", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    calls = []
    monkeypatch.setattr(script._policy_config, "create_trained_policy", lambda config, *a, **k: calls.append((config, k)))
    base = ["policy:checkpoint", "--policy.config=pi05_flatten_fold_normal", "--policy.dir=/checkpoint", "--int8"]
    script.create_policy(script.parse_args([*base, "--int8_weight_only", "--int8_siglip=all", "--int8-sites=-gating"]))
    script.create_policy(script.parse_args(base))
    (modes, kwargs), (plain, _) = calls
    assert kwargs["quantize"] and modes.knobs == knobs.Knobs(int8_weight_only=True, int8_siglip="all", int8_sites="-gating")
    assert plain.knobs == knobs.Knobs()
