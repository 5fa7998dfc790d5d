"""Model Arithmetic on the port: weight-space mixing of fine-tuned checkpoints, and the search for its weights.

Counterpart of ``kai0_tpu/arithmetic/core.py``, with the JAX-layout trees and
orbax checkpoints replaced by ``model.safetensors`` in the ``PI0Pytorch`` key
layout (what ``training/checkpoints.py`` and JAX's
``interop.save_torch_checkpoint`` write).

The host half is numpy, as in JAX: ``mix_params`` (an f64 weighted average cast
to f32), ``mix_norm_stats``, ``load_norm_stats_json`` / ``save_norm_stats_json``
and ``compute_optimal_weights`` (squared inverse losses). ``mix_state_dicts``
is the mixing CLI's key-wise f64 mix (``model_arithmetic/arithmetic_torch.py``'s
``mix_torch_params``), on the host or on the card.

``Ensemble`` (JAX's ``DeviceEnsemble``) holds N checkpoints on the card and
evaluates the loss of their mix ``Σ w_k·θ_k`` with ``Pi0.compute_loss(train=False)``.
Memory, with P parameters (3.35e9 for π₀.₅):

- the N checkpoints in bf16, one [N, P] tensor: 2·N·P bytes (6.7 GB each);
- one f32 mix of P, whose views are the parameters of one ``Pi0`` built on the
  meta device: 4·P bytes (13.4 GB);
- its f32 gradient, made at the first gradient call: 4·P bytes;
- a [N, 2^22] f32 staging chunk, the activations of one batch (per-block
  recompute) and the backward's temporaries.

At N = 3 that is 47 GB resident before activations. The mix and the
projections stream the checkpoints chunk by chunk through the staging chunk
(one cast and one ``mv`` a chunk), so nothing of size N·P is ever made in f32.
Before each allocation the card's free memory is read, and if it is short the
constructor raises with the bytes needed: checkpoints never move to the host.

``∂L/∂w_k = Σ_leaves ⟨∂L/∂θ_mix, θ_k⟩``: one backward through the mixed model
per batch accumulates ``∂L/∂θ_mix`` in place (the parameters' gradients are
views of one flat buffer), then one projection pass gives the N dot products,
accumulated in f32. JAX forms the same products through the mix's own
derivative (``jnp.tensordot``), batch by batch.

Noise and time: JAX draws them from ``jax.random.key(0)`` on every evaluation,
so its objective is deterministic. The port draws ``(noise, time)`` once per
batch from a ``torch.Generator`` in ``Ensemble.stage`` (or takes given draws)
and reuses them on every evaluation.

The mix and the projections are ``jnp`` work in JAX, with no Pallas kernel;
here they are plain torch. The model inside runs the attention kernels of
``ops/flash_attention.py``.
"""

from __future__ import annotations

from collections.abc import Sequence
import dataclasses
import json
import logging
import pathlib

import numpy as np
import torch

from kai0_tpu_torch import interop as _interop
from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.models import pi0 as _pi0

logger = logging.getLogger("kai0_tpu_torch")

_CHUNK = 1 << 22  # elements of each checkpoint staged in f32 at a time by the mix and the projections
_ALIGN = 64  # each parameter starts at a multiple of 64 elements of the flat buffers


# --------------------------------------------------------------------------------------
# Checkpoints and the host half
# --------------------------------------------------------------------------------------


def resolve_checkpoint_dir(path) -> pathlib.Path:
    """The directory that holds ``model.safetensors``; ``.../params`` names its parent (arithmetic_torch.py:45-53)."""
    p = pathlib.Path(path)
    if (p / _interop.CHECKPOINT_FILE).exists():
        return p
    if p.name == "params" and (p.parent / _interop.CHECKPOINT_FILE).exists():
        return p.parent
    raise FileNotFoundError(f"Invalid PyTorch checkpoint path (no model.safetensors): {p}")


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def mix_params(params_list: list[dict], weights) -> dict:
    """Weighted average of nested dicts of arrays in f64, cast to f32; the weights are normalized to sum to 1."""
    weights = np.asarray(weights, dtype=np.float64)
    weights /= weights.sum()
    return _tree_map(
        lambda *leaves: np.average(
            np.stack([np.asarray(x, dtype=np.float64) for x in leaves]), axis=0, weights=weights
        ).astype(np.float32),
        *params_list,
    )


def mix_norm_stats(norm_stats_list: list[dict], weights=None) -> dict:
    """Weighted average of raw norm-stats JSON dicts (uniform without weights; one dict is returned as it is)."""
    if len(norm_stats_list) == 1:
        return norm_stats_list[0]
    if weights is None:
        weights = [1.0 / len(norm_stats_list)] * len(norm_stats_list)
    total = sum(weights)
    weights = [w / total for w in weights]
    result = {}
    for key in norm_stats_list[0]:
        values = [ns[key] for ns in norm_stats_list]
        if isinstance(values[0], dict):
            result[key] = {
                stat: np.average(
                    np.stack([np.asarray(v[stat], dtype=np.float64) for v in values]), axis=0, weights=weights
                ).tolist()
                for stat in values[0]
            }
        else:
            result[key] = values[0]
    return result


def load_norm_stats_json(path) -> dict:
    with open(path) as f:
        data = json.load(f)
    if "norm_stats" not in data:
        raise ValueError(f"Invalid norm_stats format in {path}")
    return data["norm_stats"]


def save_norm_stats_json(norm_stats: dict, path) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"norm_stats": norm_stats}, f, indent=2)


def find_norm_stats(checkpoint) -> pathlib.Path | None:
    """``<root>/norm_stats.json`` or ``<root>/assets/norm_stats.json`` of a checkpoint, as both mixing CLIs look.

    Neither trainer writes either: they write ``assets/<asset_id>/norm_stats.json``
    (ROADMAP Queue 3, "Questions about the reference"), which is not mixed.
    """
    root = resolve_checkpoint_dir(checkpoint)
    for candidate in (root / "norm_stats.json", root / "assets" / "norm_stats.json"):
        if candidate.exists():
            return candidate
    return None


def compute_optimal_weights(losses) -> list[float]:
    """Inverse-loss weighting: a worse loss gets a smaller weight (squared, reference common.py:64-70)."""
    losses = np.asarray(losses)
    inv = (1.0 / (losses + 1e-8)) ** 2
    return (inv / inv.sum()).tolist()


def mix_state_dicts(states: Sequence[dict[str, torch.Tensor]], weights, *, device="cuda") -> dict[str, torch.Tensor]:
    """Key by key, ``acc += w·x`` in f64 on ``device``, cast back to the first state's dtype; host tensors out.

    Bit-equal to numpy's ``acc += w * x.astype(np.float64)``: the product and
    the sum are separate operations, each rounded once (no fused multiply-add).
    Raises, as ``mix_torch_params``, on weights that do not sum to 1 and on
    states whose keys differ.
    """
    weights = np.asarray(weights, dtype=np.float64)
    if abs(weights.sum() - 1.0) > 1e-6:
        raise ValueError(f"Weights must sum to 1.0, got {weights.sum()}")
    keys = set(states[0])
    for i, state in enumerate(states[1:], start=1):
        if set(state) != keys:
            missing = keys.symmetric_difference(state)
            raise ValueError(f"Checkpoint {i} key mismatch (e.g. {sorted(missing)[:3]})")
    mixed = {}
    for key, first in states[0].items():
        acc = torch.zeros(first.shape, dtype=torch.float64, device=device)
        for w, state in zip(weights, states, strict=True):
            acc += state[key].to(device).double() * float(w)
        mixed[key] = acc.to(first.dtype).cpu()
    return mixed


# --------------------------------------------------------------------------------------
# The ensemble on the card
# --------------------------------------------------------------------------------------


@dataclasses.dataclass
class Batch:
    """One validation batch on the ensemble's device with its fixed flow draws."""

    observation: _model.Observation
    actions: torch.Tensor
    noise: torch.Tensor
    time: torch.Tensor


class Ensemble:
    """N π₀ / π₀.₅ checkpoints on ``device`` in bf16, and one ``Pi0`` whose f32 parameters are their mix."""

    def __init__(self, checkpoint_paths: Sequence, model_config, *, device="cuda"):
        if model_config.model_type not in (_model.ModelType.PI0, _model.ModelType.PI05,
                                           _model.ModelType.PI0_RTC, _model.ModelType.PI05_RTC):
            raise NotImplementedError(f"Model Arithmetic mixes π₀ / π₀.₅ checkpoints, not {model_config.model_type}")
        self.device = torch.device(device)
        self.n = len(checkpoint_paths)
        model = _pi0.Pi0(model_config, device="meta")
        self._layout, offset = [], 0
        for name, p in model.named_parameters():
            self._layout.append((name, offset, p.shape))
            offset += -(-p.numel() // _ALIGN) * _ALIGN
        self.num_params = sum(p.numel() for p in model.parameters())
        self._size = offset
        self._theta = self._allocate((self.n, offset), torch.bfloat16, "the checkpoints in bf16")
        self._mixed = self._allocate((offset,), torch.float32, "their f32 mix")
        self._grad = None
        self._chunk = self._allocate((self.n, min(_CHUNK, offset)), torch.float32, "the f32 staging chunk")
        logger.info(f"Loading {self.n} checkpoints of {self.num_params} parameters onto {self.device}")
        expected = [name for name, _, _ in self._layout]
        for k, path in enumerate(checkpoint_paths):
            state = _interop.read_checkpoint_state(resolve_checkpoint_dir(path), expected)
            if missing := [name for name in expected if name not in state]:
                raise KeyError(f"{path}: {len(missing)} parameters missing, e.g. {missing[:3]}")
            for name, start, shape in self._layout:
                value = state[name]
                if value.shape != shape:
                    raise ValueError(f"{path}: {name} has shape {tuple(value.shape)}, the model {tuple(shape)}")
                self._theta[k, start : start + value.numel()].copy_(value.reshape(-1))
        for name, start, shape in self._layout:
            module_name, _, leaf = name.rpartition(".")
            view = self._mixed[start : start + shape.numel()].view(shape)
            setattr(model.get_submodule(module_name), leaf, torch.nn.Parameter(view))
        self.model = model

    def _allocate(self, shape: tuple, dtype: torch.dtype, what: str) -> torch.Tensor:
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
            if nbytes > free:
                raise MemoryError(
                    f"{what}: {nbytes} bytes needed on {self.device}, {free} free. {self.n} checkpoints of "
                    f"{self._size} (padded) parameters take {self.n * self._size * 2} bytes in bf16, their f32 mix "
                    f"{self._size * 4} and its gradient {self._size * 4} more"
                )
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def stage(self, batches, *, generator: torch.Generator | None = None, draws=None) -> list[Batch]:
        """Batches on the device with their draws: ``batches`` are ``(observation dict, actions)`` pairs of arrays
        (the ``from_dict`` form, as ``scripts/dump_data_torch.py`` pickles them); ``draws`` a ``(noise, time)``
        pair per batch, or None to draw them from ``generator`` (seeded 0 on the device by default)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        staged = []
        for i, (observation, actions) in enumerate(batches):
            tree = _tree_map(lambda x: torch.as_tensor(x).to(self.device), observation)
            actions = torch.as_tensor(actions).to(self.device, torch.float32)
            noise, time = (None, None) if draws is None else draws[i]
            noise, time = _pi0.draw_noise_and_time(actions.shape, generator, self.device, noise, time)
            staged.append(Batch(_model.Observation.from_dict(tree), actions, noise.to(self.device),
                                time.to(self.device)))
        return staged

    @torch.no_grad()
    def mix(self, weights) -> None:
        """The model's parameters become ``Σ w_k·θ_k`` in f32."""
        w = torch.as_tensor(np.asarray(weights, dtype=np.float32), device=self.device)
        for start in range(0, self._size, self._chunk.shape[1]):
            stop = min(start + self._chunk.shape[1], self._size)
            chunk = self._chunk[:, : stop - start]
            chunk.copy_(self._theta[:, start:stop])
            torch.mv(chunk.T, w, out=self._mixed[start:stop])

    @torch.no_grad()
    def project(self) -> np.ndarray:
        """``⟨∂L/∂θ_mix, θ_k⟩`` for each k, from the gradient the last backward left (f32 sums, as f64 numbers)."""
        out = torch.zeros(self.n, dtype=torch.float32, device=self.device)
        for start in range(0, self._size, self._chunk.shape[1]):
            stop = min(start + self._chunk.shape[1], self._size)
            chunk = self._chunk[:, : stop - start]
            chunk.copy_(self._theta[:, start:stop])
            out.addmv_(chunk, self._grad[start:stop])
        return out.cpu().numpy().astype(np.float64)

    def _batch_loss(self, batch: Batch) -> torch.Tensor:
        losses = self.model.compute_loss(batch.observation, batch.actions, noise=batch.noise, time=batch.time)
        return torch.mean(losses)

    @torch.no_grad()
    def loss(self, weights, batches: Sequence[Batch]) -> float:
        """The mean over the batches of the mixed model's loss."""
        self.mix(weights)
        losses = torch.stack([self._batch_loss(batch) for batch in batches]).tolist()
        return sum(losses) / len(batches)

    def loss_and_weight_grad(self, weights, batches: Sequence[Batch]) -> tuple[float, np.ndarray]:
        """``loss`` and its gradient with respect to the N weights."""
        if self._grad is None:
            self._grad = self._allocate((self._size,), torch.float32, "the f32 gradient of the mix")
            for name, start, shape in self._layout:
                self.model.get_parameter(name).grad = self._grad[start : start + shape.numel()].view(shape)
        self.mix(weights)
        self._grad.zero_()
        losses = []
        for batch in batches:
            loss = self._batch_loss(batch)
            (loss / len(batches)).backward()  # accumulates into the views of self._grad in place
            losses.append(loss.detach())
        return sum(torch.stack(losses).tolist()) / len(batches), self.project()

    def checkpoint_losses(self, batches: Sequence[Batch]) -> list[float]:
        return [self.loss(np.eye(self.n)[i], batches) for i in range(self.n)]


def optimize_weights_gradient_descent(
    ensemble: Ensemble,
    batches: Sequence[Batch],
    *,
    num_iterations: int = 50,
    learning_rate: float = 0.05,
    adaptive: bool = False,
) -> list[float]:
    """Weights on the simplex as softmax(log_weights), the log-weights updated by Adam (reference :118-294).

    The weights returned are the ones evaluated before the update that followed
    the best loss; ``adaptive`` scales each step by ``(loss / 0.05)²``.
    """
    log_w = torch.zeros(ensemble.n, requires_grad=True)
    opt = torch.optim.Adam([log_w], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    best_w, best_loss = None, float("inf")
    for it in range(num_iterations):
        wn = torch.softmax(log_w.detach(), dim=0).numpy()
        loss, g = ensemble.loss_and_weight_grad(wn, batches)
        # d loss / d log_w through the softmax: w ⊙ (g − ⟨g, w⟩).
        grad_log = wn * (g - np.dot(g, wn))
        if adaptive:
            grad_log = grad_log * (loss / 0.05) ** 2
        log_w.grad = torch.from_numpy(np.asarray(grad_log, dtype=np.float32))
        opt.step()
        if loss < best_loss:
            best_loss, best_w = loss, wn
        logger.info(f"iter {it}: loss={loss:.6f} weights={np.round(wn, 4).tolist()}")
    return np.asarray(best_w if best_w is not None else torch.softmax(log_w.detach(), dim=0).numpy()).tolist()


def optimize_weights_greedy(ensemble: Ensemble, batches: Sequence[Batch], *, grid: int = 5) -> list[float]:
    """Greedy forward selection (reference :330-425): from the best single checkpoint, blend in each remaining one
    at ratios ``linspace(0.1, 0.5, grid)``, keeping the first improvement, until a round improves nothing."""
    n = ensemble.n
    losses = ensemble.checkpoint_losses(batches)
    weights = np.eye(n)[int(np.argmin(losses))]
    best_loss = min(losses)
    remaining = set(range(n)) - {int(np.argmin(losses))}

    improved = True
    while improved and remaining:
        improved = False
        for k in sorted(remaining):
            for alpha in np.linspace(0.1, 0.5, grid):
                cand = weights * (1 - alpha) + np.eye(n)[k] * alpha
                loss = ensemble.loss(cand, batches)
                if loss < best_loss:
                    best_loss, weights = loss, cand
                    improved = True
                    remaining.discard(k)
                    break
    logger.info(f"greedy final loss={best_loss:.6f} weights={np.round(weights, 4).tolist()}")
    return weights.tolist()
