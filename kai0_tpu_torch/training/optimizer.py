"""Learning-rate schedules and AdamW, as plain functions over dicts of tensors.

Counterpart of ``kai0_tpu/training/optimizer.py`` (the schedules at :29-91,
``_stochastic_round_bf16`` :94-108, the q8 codec :129-168, AdamW with f32,
bf16 or 8-bit moments :171-348 and :404-441, the f32-accumulated clip
:351-378, ``apply_updates_sr`` :381-401). Not ``torch.optim``: the update is
the JAX chain in its order, clip -> Adam -> ``+ wd·p`` -> ``x(-lr(count))``,
where optax bias-corrects with the incremented count and the learning rate
reads the count before the increment.

State: ``{"count": int, "mu": {name: moment}, "nu": {name: moment}}`` with a
moment a tensor (f32 or bf16 storage) or, for ``state_dtype="int8"``, a dict
``{"q": codes, "s": block scales}`` updated in place by kernel K3, one launch
over every tensor of the step (``kai0_tpu_torch.ops.adam_q8.adam_q8_leaves``;
the module also holds the q8 codec). The q8 blocks are cut over the port's
per-layer tensors, JAX's over its stacked leaves, so q8 state crosses between
the packages as f32 moments: ``q8_moments`` decodes the port's state per
tensor, ``q8_state_from_moments`` encodes moments into it.

Randomness: the bf16 stochastic rounding of nu and the q8 rounding draw from
generators seeded by (tag, count, tensor index), so a step is deterministic
given its count.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Mapping
import dataclasses
import math

import torch

from kai0_tpu_torch.ops import adam_q8 as _adam_q8

_NU_SR_TAG = 0x6B61  # bf16 nu stochastic rounding
_Q8_TAG = 0x6B62  # q8 rounding seeds
_APPLY_SR_TAG = 0x7072  # bf16 parameter apply, the key of kai0_tpu/training/train_lib.py:128


def step_generator(tag: int, step: int, index: int = 0, device="cpu") -> torch.Generator:
    """A generator determined by (tag, step, index): the port's ``fold_in(key(tag), step)``."""
    seed = ((tag * 1_000_003 + step) * 1_000_003 + index) % (2**63)
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def _warmup(step: int, peak: float, steps: int) -> float:
    """The reference's warmup ramp: peak/(steps+1) at step 0, peak at ``steps``."""
    f = min(max(step / max(steps, 1), 0.0), 1.0)
    lo = peak / (steps + 1)
    return lo + f * (peak - lo)


@dataclasses.dataclass(frozen=True)
class CosineDecaySchedule:
    """Linear warmup to ``peak_lr``, then half-cosine down to ``decay_lr`` at ``decay_steps``."""

    peak_lr: float = 2.5e-5
    decay_lr: float = 2.5e-6
    warmup_steps: int = 1000
    decay_steps: int = 30000

    def __call__(self, step: int) -> float:
        if step < self.warmup_steps:
            return _warmup(step, self.peak_lr, self.warmup_steps)
        span = max(self.decay_steps - self.warmup_steps, 1)
        t = min(max((step - self.warmup_steps) / span, 0.0), 1.0)
        return self.decay_lr + (self.peak_lr - self.decay_lr) * 0.5 * (1 + math.cos(math.pi * t))


@dataclasses.dataclass(frozen=True)
class RsqrtDecaySchedule:
    """Linear warmup, then peak_lr · sqrt(timescale / (timescale + step − warmup))."""

    peak_lr: float = 5e-5
    warmup_steps: int = 1000
    timescale: float = 10000

    def __call__(self, step: int) -> float:
        if step < self.warmup_steps:
            return _warmup(step, self.peak_lr, self.warmup_steps)
        return self.peak_lr * math.sqrt(self.timescale / (self.timescale + max(step - self.warmup_steps, 0)))


# ---------------------------------------------------------------------------
# Rounding and norms
# ---------------------------------------------------------------------------


def _stochastic_round_bf16(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding: add 16 uniform low bits to the f32 pattern, keep the top 16.

    Unbiased (E[sr(x)] = x). The add carries into the top half as uint32
    arithmetic would; it is done on the split halves, so no int32 add overflows.
    NaN and ±inf pass through as the plain cast.
    """
    xf = x.float()
    bits = xf.view(torch.int32)
    rnd = torch.randint(0, 1 << 16, xf.shape, generator=generator, device=xf.device, dtype=torch.int32)
    carry = ((bits & 0xFFFF) + rnd) >> 16
    rounded = ((bits >> 16) + carry).to(torch.int16).view(torch.bfloat16)
    return torch.where(torch.isfinite(xf), rounded, xf.to(torch.bfloat16))


def global_norm_f32(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares, accumulated in f32 (optax's ``global_norm`` for f32 trees)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def _clip(g: torch.Tensor, norm: torch.Tensor, max_norm: float, all_f32: bool) -> torch.Tensor:
    """One tensor of the global-norm clip at norm >= max_norm (f32 trees as optax, others in f32)."""
    if all_f32:  # optax.clip_by_global_norm
        return g / norm * max_norm
    return (g.float() * (max_norm / norm)).to(g.dtype)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A scalar rounded to ``like``'s dtype first, as JAX casts a weak scalar."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Global-norm-clipped AdamW with moments stored in f32 (None), ``"bfloat16"`` or ``"int8"``."""

    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 1e-10
    clip_gradient_norm: float = 1.0
    state_dtype: str | None = None

    def __post_init__(self):
        if self.state_dtype not in (None, "bfloat16", "int8"):
            raise ValueError(f"state_dtype must be None, 'bfloat16' or 'int8', not {self.state_dtype!r}")

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        if self.state_dtype == "int8":
            def packed(p, qdtype):
                blocks = _adam_q8.num_blocks(p.numel())
                return {"q": torch.zeros_like(p, dtype=qdtype), "s": torch.zeros(blocks, device=p.device)}

            mu = {k: packed(p, torch.int8) for k, p in params.items()}
            nu = {k: packed(p, torch.uint8) for k, p in params.items()}
        else:
            dtype = torch.float32 if self.state_dtype is None else torch.bfloat16
            mu = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
            nu = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
        return {"count": 0, "mu": mu, "nu": nu}

    def _adam_q8(self, names: list[str], gs: list[torch.Tensor], state: dict, count: int, owned: bool) -> list:
        """Adam with int8 moments on every tensor at once (kernel K3, one launch); updates ``state`` in place.

        ``owned``: the gradients are this step's own copies (clipped), so the updates overwrite them.
        """
        b1, b2 = self.b1, self.b2
        c1, c2 = 1 - _f32(b1) ** count, 1 - _f32(b2) ** count
        a, b = float(torch.sqrt(c2) / c1), float(self.eps * torch.sqrt(c2))
        seeds = torch.randint(0, 2**31 - 1, (len(gs),), generator=step_generator(_Q8_TAG, count)).tolist()
        mu, nu = (state[key] for key in ("mu", "nu"))
        return _adam_q8.adam_q8_leaves(
            gs, [mu[k]["q"] for k in names], [mu[k]["s"] for k in names], [nu[k]["q"] for k in names],
            [nu[k]["s"] for k in names], a, b, seeds, b1=b1, b2=b2, out=gs if owned else None,
        )

    def _adam(self, i: int, name: str, g: torch.Tensor, state: dict, count: int) -> torch.Tensor:
        """Adam with f32 or bf16 moments on one tensor (count already incremented); stores them into ``state``."""
        b1, b2, eps = self.b1, self.b2, self.eps
        c1, c2 = 1 - _f32(b1) ** count, 1 - _f32(b2) ** count
        mu, nu = state["mu"], state["nu"]
        if self.state_dtype is None:  # optax.scale_by_adam
            m = (1 - b1) * g + b1 * mu[name]
            v = (1 - b2) * (g * g) + b2 * nu[name]
            mu[name], nu[name] = m, v
            return (m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + eps)
        # bf16 storage: the math in g's dtype; mu rounds to nearest, nu stochastically.
        m = _scalar(b1, g) * mu[name].to(g.dtype) + _scalar(1 - b1, g) * g
        v = _scalar(b2, g) * nu[name].to(g.dtype) + _scalar(1 - b2, g) * (g * g)
        out = (m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + _scalar(eps, g))
        mu[name] = m.to(torch.bfloat16)
        nu[name] = _stochastic_round_bf16(v, step_generator(_NU_SR_TAG, count, i, device=v.device))
        return out

    def update(
        self,
        grads: Mapping[str, torch.Tensor],
        state: dict,
        params: Mapping[str, torch.Tensor],
        lr: Callable[[int], float],
    ) -> tuple[dict[str, torch.Tensor], dict]:
        """The updates to add to ``params``, and the new state (its moment tensors replace or update the old)."""
        norm = global_norm_f32(grads.values())
        all_f32 = all(g.dtype == torch.float32 for g in grads.values())
        clip = bool(norm >= self.clip_gradient_norm)  # optax scales only when norm >= max_norm
        count = state["count"] + 1
        step_lr = lr(state["count"])
        new_state = {"count": count, "mu": dict(state["mu"]), "nu": dict(state["nu"])}

        def clipped(g):
            return _clip(g, norm, self.clip_gradient_norm, all_f32) if clip else g

        if self.state_dtype == "int8":
            adam = self._adam_q8(list(grads), [clipped(g) for g in grads.values()], new_state, count, clip)
        else:  # tensor by tensor, so that one clipped copy is alive at a time
            adam = (self._adam(i, name, clipped(g), new_state, count) for i, (name, g) in enumerate(grads.items()))
        # Adam's updates are this function's own tensors: the rest of the chain runs in place on them.
        updates = {}
        for name, u in zip(grads, adam, strict=True):
            p = params[name]
            u.add_(_scalar(self.weight_decay, p) * p)  # optax.add_decayed_weights
            updates[name] = u.mul_(_scalar(-step_lr, u))  # optax.scale_by_learning_rate
        return updates, new_state


def q8_moments(state: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """The f32 moments ``{"mu": {name: tensor}, "nu": {name: tensor}}`` that a q8 state encodes, per tensor."""
    return {key: {name: _adam_q8.q8_decode(p["q"], p["s"]) for name, p in state[key].items()} for key in ("mu", "nu")}


def q8_state_from_moments(moments: Mapping[str, Mapping[str, torch.Tensor]], count: int) -> dict:
    """A q8 optimizer state at ``count`` that encodes f32 moments per tensor (``nu`` non-negative).

    Each value rounds to the nearer code of its block's log grid (the codec's
    deterministic u = 0.5), so it decodes within half a grid step, a factor of
    exp(7 ln 10 / 254) for mu and exp(7 ln 10 / 510) for nu, of the moment
    (values below about 1e-7 of their block's absmax decode as 0, as in either
    package's codec).
    """
    def encode(x: torch.Tensor, signed: bool) -> dict:
        q, scale = _adam_q8.q8_encode(x.to(torch.float32), 0.5, signed=signed)
        return {"q": q, "s": scale}

    return {
        "count": count,
        "mu": {name: encode(x, True) for name, x in moments["mu"].items()},
        "nu": {name: encode(x, False) for name, x in moments["nu"].items()},
    }


def apply_updates(params: Mapping[str, torch.Tensor], updates: Mapping[str, torch.Tensor]) -> None:
    """``optax.apply_updates`` in place: p <- p + u in p's dtype."""
    for name, p in params.items():
        p.copy_(p + updates[name].to(p.dtype))


def apply_updates_sr(params: Mapping[str, torch.Tensor], updates: Mapping[str, torch.Tensor], step: int) -> None:
    """In place: bf16 tensors updated in f32 and stochastically rounded back; others as ``apply_updates``."""
    for i, (name, p) in enumerate(params.items()):
        u = updates[name]
        if p.dtype == torch.bfloat16:
            p.copy_(_stochastic_round_bf16(p.float() + u.float(), step_generator(_APPLY_SR_TAG, step, i, device=p.device)))
        else:
            p.copy_(p + u.to(p.dtype))
