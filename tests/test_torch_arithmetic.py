"""The port's Model Arithmetic against ``kai0_tpu.arithmetic.core`` and ``model_arithmetic/*.py``.

Three ``debug_pi05`` checkpoints (``dummy``/``dummy`` Gemma, ``mu/14`` SigLIP,
f32, 48 prompt tokens) as fine-tunes of one base: the base numpy-seeded by
``_torch_parity.numpy_params``, and two copies whose action expert and heads
are moved by seeded noise (seeds 1 and 2), written once as f32
``model.safetensors`` that both packages read (both hold them in bf16). One
batch of 1 from a seed. JAX's ``DeviceEnsemble`` draws noise and time from
``jax.random.key(0)`` on every evaluation; the port's ``Ensemble`` is handed
those draws. JAX's ensemble runs on one of the 8 test devices (sharded over
all 8, an evaluation costs 2-4x more) and is built once for the module; each
of its evaluations is kept by its weights, since key 0 makes it a function of
them alone, so cases that revisit weights (every descent starts at the
uniform weights, greedy at the vertices) pay once: a forward and backward of
JAX's debug model costs about 0.9 s on an 8-core CPU.

- The host half bit-equal (JSON byte-equal) to JAX's: weights that do not sum
  to 1, one norm-stats dict, the JSON round trip, inverse-loss weights.
- The mixing script's f64 mix bit-equal to ``arithmetic_torch.mix_torch_params``
  on the f32 files, and both raising on a key mismatch and on weights whose sum
  is not 1.
- ``Ensemble`` against ``DeviceEnsemble`` (built and jitted once for the
  module; the π₀-FAST and estimator families are held in
  ``test_torch_arithmetic_{fast,estimator}.py``): vertex losses within 1e-5 relative, the loss and weight gradient at
  a non-vertex within 1e-5 and 1e-4 x max, 3 iterations of (adaptive)
  gradient descent within 1e-5, greedy (grid 2) equal. Two batches average
  as one batch twice (the gradient accumulates across batches in place).
- ``scripts/model_arithmetic_torch.py --device=cpu`` against
  ``model_arithmetic/arithmetic_torch.py``: ``--weights`` bit-equal tensors and
  a byte-equal ``norm_stats.json``; ``gradient_descent`` for 2 iterations the
  same weights within 1e-5. Norm stats under ``assets/<asset_id>/`` (where both
  trainers write them) are mixed by neither.
- ``scripts/dump_data_torch.py`` bit-equal to ``model_arithmetic/dump_data.py``
  on ``debug_pi05`` (batch 8: JAX's loader splits a batch over its 8 test
  devices).
"""

import dataclasses
import functools
import json
import pathlib
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import model_inputs, numpy_params, worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.arithmetic import core as jax_core
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import model as jax_model
from kai0_tpu.parallel import sharding as jax_sharding
from kai0_tpu.training import config as jax_config
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch import interop
from kai0_tpu_torch.arithmetic import core
from kai0_tpu_torch.models import advantage
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.training import config as torch_config

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "model_arithmetic"))
sys.path.insert(0, str(REPO / "scripts"))
import arithmetic_torch as jax_cli  # noqa: E402
import dump_data as jax_dump  # noqa: E402
import dump_data_torch as torch_dump  # noqa: E402
import model_arithmetic_torch as torch_cli  # noqa: E402

CONFIG = "debug_pi05"
SEEDS = (0, 1, 2)
BATCH = 1


def _norm_stats(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: {"mean": rng.standard_normal(4).tolist(), "std": rng.uniform(0.5, 2, 4).tolist(),
                "q01": rng.uniform(-2, -1, 4).tolist(), "q99": rng.uniform(1, 2, 4).tolist()}
            for k in ("state", "actions")}


class _Kept:
    """JAX's ``DeviceEnsemble`` whose evaluations are kept by their f32 weights (JAX casts the weights to f32)."""

    def __init__(self, ensemble):
        self.ensemble, self.params_list, self.kept = ensemble, ensemble.params_list, {}

    def _call(self, method: str, weights, batches):
        key = (method, np.asarray(weights, np.float32).tobytes())
        if key not in self.kept:
            self.kept[key] = getattr(self.ensemble, method)(weights, batches)
        return self.kept[key]

    def loss(self, weights, batches):
        return self._call("loss", weights, batches)

    def loss_and_weight_grad(self, weights, batches):
        return self._call("loss_and_weight_grad", weights, batches)

    def checkpoint_losses(self, batches):
        return [self.loss(np.eye(len(self.params_list))[i], batches) for i in range(len(self.params_list))]


def _fine_tuned(path: str) -> bool:
    """The leaves the fine-tunes of the base move: the action expert's (``_1``) and the projection heads."""
    return "_1" in path or not path.startswith("PaliGemma")


@functools.partial(jax.jit, static_argnums=0)
def _key0_draws(shape) -> dict:
    """Noise and time as JAX's ``compute_loss`` draws them from ``jax.random.key(0)`` (one jit: eagerly, the beta
    draw compiles op by op)."""
    _, noise_rng, time_rng = jax.random.split(jax.random.key(0), 3)
    time = jax.random.beta(time_rng, 1.5, 1, shape[:1]) * 0.999 + 0.001
    return {"noise": jax.random.normal(noise_rng, shape), "time": time}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The checkpoints (norm stats at each root), the batch, JAX's key-0 draws and both ensembles."""
    root = tmp_path_factory.mktemp("arithmetic")
    jax_model_config = jax_config.get_config(CONFIG).model
    base, paths = flatten_dict(numpy_params(jax_model_config, 0)), []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        params = {k: v if seed == 0 or not _fine_tuned(k) else (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
                  for k, v in base.items()}
        state = tsf.jax_to_torch_state(unflatten_dict(params), jax_model_config)
        ckpt = root / f"ckpt_{seed}"
        ckpt.mkdir()
        interop.write_safetensors({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
                                  ckpt / "model.safetensors")
        jax_core.save_norm_stats_json(_norm_stats(seed), ckpt / "norm_stats.json")
        paths.append(str(ckpt))
    inputs = model_inputs(7, batch=BATCH, prompt_len=48)
    actions = np.random.default_rng(8).standard_normal((BATCH, 50, 32)).astype(np.float32)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in _key0_draws(actions.shape).items()}
    jax_batches = [(jax.tree.map(np.asarray, jax_model.Observation.from_dict(inputs)), actions)]
    mesh = jax_sharding.make_mesh(1, devices=jax.devices()[:1])
    jax_ensemble = _Kept(jax_core.DeviceEnsemble(paths, jax_model_config, mesh=mesh))
    ensemble = core.Ensemble(paths, torch_config.get_config(CONFIG).model, device="cpu")
    batches = ensemble.stage([(inputs, actions)], draws=[(draws["noise"], draws["time"])])
    return dict(root=root, paths=paths, inputs=inputs, actions=actions, draws=draws, jax_batches=jax_batches,
                jax_ensemble=jax_ensemble, ensemble=ensemble, batches=batches)


@pytest.fixture(scope="module")
def vertex_losses(setup):
    return setup["ensemble"].checkpoint_losses(setup["batches"]), setup["jax_ensemble"].checkpoint_losses(
        setup["jax_batches"])


# -- the host half ------------------------------------------------------------------------


@pytest.mark.parametrize("weights", [[1.0, 3.0, 0.5], [0.2, 0.3, 0.5]])
def test_mix_params_bit_equal_to_jax(weights):
    rng = np.random.default_rng(1)
    trees = [{"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": {"x": rng.standard_normal(7).astype(np.float32)}} for _ in weights]
    got, want = core.mix_params(trees, list(weights)), jax_core.mix_params(trees, list(weights))
    for k in ("w", "b"):
        a, b = (got[k], want[k]) if k == "w" else (got[k]["x"], want[k]["x"])
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 4.0]])
def test_mix_norm_stats_bit_equal_to_jax(weights):
    stats = [_norm_stats(s) for s in SEEDS]
    assert core.mix_norm_stats(stats, weights) == jax_core.mix_norm_stats(stats, weights)
    assert core.mix_norm_stats(stats[:1], weights) is stats[0]
    assert jax_core.mix_norm_stats(stats[:1], weights) is stats[0]


def test_norm_stats_json_byte_equal_to_jax(tmp_path):
    stats = _norm_stats(5)
    core.save_norm_stats_json(stats, tmp_path / "port" / "norm_stats.json")
    jax_core.save_norm_stats_json(stats, tmp_path / "jax" / "norm_stats.json")
    assert (tmp_path / "port" / "norm_stats.json").read_bytes() == (tmp_path / "jax" / "norm_stats.json").read_bytes()
    assert core.load_norm_stats_json(tmp_path / "jax" / "norm_stats.json") == stats
    (tmp_path / "bad.json").write_text(json.dumps({"other": 1}))
    for load in (core.load_norm_stats_json, jax_core.load_norm_stats_json):
        with pytest.raises(ValueError, match="Invalid norm_stats format"):
            load(tmp_path / "bad.json")


def test_inverse_loss_weights_equal_to_jax():
    losses = [0.5, 1.25, 3.0]
    assert core.compute_optimal_weights(losses) == jax_core.compute_optimal_weights(losses)


def test_checkpoint_dirs_resolve_as_the_reference_cli(setup, tmp_path):
    ckpt = pathlib.Path(setup["paths"][0])
    for path in (ckpt, ckpt / "params"):
        assert core.resolve_checkpoint_dir(path) == jax_cli.resolve_torch_ckpt_path(path) == ckpt
    for resolve in (core.resolve_checkpoint_dir, jax_cli.resolve_torch_ckpt_path):
        with pytest.raises(FileNotFoundError, match="no model.safetensors"):
            resolve(tmp_path)


def test_script_mix_bit_equal_to_mix_torch_params_and_raises_alike(setup, tmp_path):
    states = [interop.read_safetensors(pathlib.Path(p) / "model.safetensors") for p in setup["paths"]]
    arrays = [jax_cli.load_torch_params(p) for p in setup["paths"]]
    weights = [0.2, 0.45, 0.35]
    got, want = core.mix_state_dicts(states, weights, device="cpu"), jax_cli.mix_torch_params(arrays, weights)
    assert list(got) == list(states[0]) and set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and v.dtype == np.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    for mix, lists in ((lambda s, w: core.mix_state_dicts(s, w, device="cpu"), states),
                       (jax_cli.mix_torch_params, arrays)):
        with pytest.raises(ValueError, match="Weights must sum to 1.0"):
            mix(lists, [0.2, 0.45, 0.3])
        bad = dict(lists[1])
        bad["extra.weight"] = bad.pop("action_in_proj.weight")
        with pytest.raises(ValueError, match="Checkpoint 1 key mismatch"):
            mix([lists[0], bad, lists[2]], weights)


# -- the ensemble ------------------------------------------------------------------------------


def test_checkpoint_losses_match_jax(vertex_losses):
    got, want = vertex_losses
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # Greedy compares these: the seeds give vertex losses far apart, so float noise cannot reorder them.
    assert min(abs(a - b) for i, a in enumerate(want) for b in want[i + 1:]) > 1e-3 * max(want)


def test_loss_and_weight_grad_match_jax(setup):
    weights = [0.2, 0.5, 0.3]
    loss, grad = setup["ensemble"].loss_and_weight_grad(weights, setup["batches"])
    jax_loss, jax_grad = setup["jax_ensemble"].loss_and_weight_grad(weights, setup["jax_batches"])
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, jax_grad, rtol=0, atol=1e-4 * np.abs(jax_grad).max())
    assert np.abs(jax_grad).min() > 0
    # The loss alone is the gradient call's loss.
    np.testing.assert_allclose(setup["ensemble"].loss(weights, setup["batches"]), loss, rtol=1e-6)


@pytest.mark.parametrize("adaptive", [False, True])
def test_gradient_descent_matches_jax(setup, adaptive):
    kwargs = dict(num_iterations=3, learning_rate=0.05, adaptive=adaptive)
    got = core.optimize_weights_gradient_descent(setup["ensemble"], setup["batches"], **kwargs)
    want = jax_core.optimize_weights_gradient_descent(setup["jax_ensemble"], setup["jax_batches"], **kwargs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sum(got), 1.0, rtol=1e-6)


def test_greedy_equals_jax(setup, vertex_losses):
    got = core.optimize_weights_greedy(setup["ensemble"], setup["batches"], grid=2)
    want = jax_core.optimize_weights_greedy(setup["jax_ensemble"], setup["jax_batches"], grid=2)
    np.testing.assert_array_equal(got, want)
    assert got != np.eye(3)[int(np.argmin(vertex_losses[1]))].tolist()  # a blend was kept


def test_two_batches_average_as_one_batch_twice(setup):
    ensemble, batches = setup["ensemble"], setup["batches"]
    weights = [0.6, 0.1, 0.3]
    loss, grad = ensemble.loss_and_weight_grad(weights, batches)
    twice_loss, twice_grad = ensemble.loss_and_weight_grad(weights, batches * 2)
    np.testing.assert_allclose(twice_loss, loss, rtol=1e-6)
    np.testing.assert_allclose(twice_grad, grad, rtol=0, atol=1e-6 * np.abs(grad).max())
    np.testing.assert_allclose(ensemble.loss(weights, batches * 2), loss, rtol=1e-6)


def test_ensemble_refuses_a_checkpoint_without_a_parameter_and_other_model_types(setup, tmp_path):
    state = interop.read_safetensors(pathlib.Path(setup["paths"][0]) / "model.safetensors")
    del state["action_out_proj.bias"]
    interop.write_safetensors(state, tmp_path / "model.safetensors")
    model_config = torch_config.get_config(CONFIG).model
    with pytest.raises(KeyError, match="action_out_proj.bias"):
        core.Ensemble([tmp_path], model_config, device="cpu")
    # Every family mixes (tests/test_torch_arithmetic_{fast,estimator}.py); an estimator's is refused for a
    # π₀.₅ checkpoint, which has no value head.
    estimator = advantage.AdvantageEstimatorConfig(**{f.name: getattr(model_config, f.name)
                                                      for f in dataclasses.fields(model_config) if f.init})
    with pytest.raises(KeyError, match="value_head"):
        core.Ensemble([setup["paths"][0]], estimator, device="cpu")


# -- the scripts ---------------------------------------------------------------------------------


def _run_both(setup, tmp_path, monkeypatch, extra: list[str], batches: bool = False):
    """Both mixing CLIs on the module's checkpoints; returns (port weights, JAX weights, port dir, JAX dir)."""
    args = ["--checkpoints", *setup["paths"], *extra]
    if batches:
        for name, data in (("port.pkl", [(setup["inputs"], setup["actions"])]), ("jax.pkl", setup["jax_batches"])):
            with open(tmp_path / name, "wb") as f:
                pickle.dump(data, f)
        draws = (setup["draws"]["noise"], setup["draws"]["time"])
        monkeypatch.setattr(torch_pi0, "draw_noise_and_time", lambda *args, **kwargs: draws)

        def reuse(paths, model_config, mesh=None):
            assert list(paths) == setup["paths"]
            return setup["jax_ensemble"]

        monkeypatch.setattr(jax_core, "DeviceEnsemble", reuse)
    captured = []
    optimize = jax_cli.optimize_weights
    monkeypatch.setattr(jax_cli, "optimize_weights", lambda a: captured.append(optimize(a)) or captured[-1])
    got = torch_cli.main([*args, "--output", str(tmp_path / "port"), "--device", "cpu",
                          *(["--data-path", str(tmp_path / "port.pkl")] if batches else [])])
    jax_cli.main([*args, "--output", str(tmp_path / "jax"),
                  *(["--data-path", str(tmp_path / "jax.pkl")] if batches else [])])
    return got, (captured[0] if captured else None), tmp_path / "port", tmp_path / "jax"


def test_mixing_script_with_weights_matches_the_reference(setup, tmp_path, monkeypatch):
    weights = ["0.25", "0.5", "0.25"]
    got, _, port, ref = _run_both(setup, tmp_path, monkeypatch, ["--weights", *weights])
    assert got == [float(w) for w in weights]
    mixed = interop.read_safetensors(port / "model.safetensors")
    want = jax_cli.load_torch_params(ref)
    assert set(mixed) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(mixed[k].numpy(), v, err_msg=k)
    assert (port / "norm_stats.json").read_bytes() == (ref / "norm_stats.json").read_bytes()


def test_mixing_script_gradient_descent_matches_the_reference(setup, tmp_path, monkeypatch):
    extra = ["--optimize_method", "gradient_descent", "--config", CONFIG, "--num_iterations", "2"]
    got, want, port, ref = _run_both(setup, tmp_path, monkeypatch, extra, batches=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    a = jax_cli.load_torch_params(ref)["action_in_proj.weight"]
    np.testing.assert_allclose(interop.read_safetensors(port / "model.safetensors")["action_in_proj.weight"].numpy(),
                               a, rtol=0, atol=1e-5 * np.abs(a).max())


def test_norm_stats_where_the_trainers_write_them_are_mixed_by_neither(setup, tmp_path, monkeypatch):
    """Both CLIs read ``<root>/norm_stats.json`` or ``<root>/assets/norm_stats.json``; both trainers write
    ``<root>/assets/<asset_id>/norm_stats.json`` (ROADMAP Queue 3): neither mixes those."""
    paths = []
    for i, path in enumerate(setup["paths"]):
        ckpt = tmp_path / f"trained_{i}"
        (ckpt / "assets" / "agilex").mkdir(parents=True)
        (ckpt / "model.safetensors").symlink_to(pathlib.Path(path) / "model.safetensors")
        jax_core.save_norm_stats_json(_norm_stats(i), ckpt / "assets" / "agilex" / "norm_stats.json")
        paths.append(str(ckpt))
    _, _, port, ref = _run_both(dict(setup, paths=paths), tmp_path, monkeypatch, ["--weights", "0.5", "0.25", "0.25"])
    assert (port / "model.safetensors").exists() and (ref / "model.safetensors").exists()
    assert not (port / "norm_stats.json").exists() and not (ref / "norm_stats.json").exists()
    assert core.find_norm_stats(paths[0]) is None


def test_usage_text_names_the_batches_it_reads(capsys):
    with pytest.raises(SystemExit):
        torch_cli.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "scripts/dump_data_torch.py" in text and "model_arithmetic/dump_data.py" in text
    assert "cannot read" in text


def test_dump_data_bit_equal_to_the_reference(tmp_path):
    args = ["--config", CONFIG, "--num-batches", "1", "--batch-size", "8"]
    torch_dump.main([*args, "--output", str(tmp_path / "port.pkl")])
    jax_dump.main([*args, "--output", str(tmp_path / "jax.pkl")])
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    assert len(got) == len(want) == 1
    (obs, actions), (jax_obs, jax_actions) = got[0], want[0]

    def same(a, b, path=""):
        if isinstance(b, dict):
            b = {k: v for k, v in b.items() if v is not None}
            assert isinstance(a, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert type(a) is np.ndarray and a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=path)

    same(obs, jax_obs.to_dict())
    same(actions, jax_actions)
    assert obs["image"]["base_0_rgb"].shape == (8, 224, 224, 3)
