"""π₀.₅-RTC: real-time-chunking guided sampling, PyTorch.

Counterpart of ``kai0_tpu/models/pi0_rtc.py``. The model and its weights are
π₀.₅'s; only the sampler differs. With a previous chunk, every Euler step
takes a vector-Jacobian product through the action expert: the action
estimate is x̂₁ = x_t − t·v_t, the error ``(prev − x̂₁)`` weighted by the
prefix-weight schedule over ``[inference_delay, execute_horizon)`` and masked
to the first ``min(14, provided)`` action dims is pulled back through
``torch.autograd.grad``, and the velocity becomes ``v − w·vjp`` with the
guidance weight ``w = min(c·inv_r2, max_guidance_weight)`` at τ = 1 − t.
Without one, the Euler steps are π₀.₅'s with the velocity scrubbed of NaN and
inf. The incoming chunk and x_0 are scrubbed too.

The sampler (``Pi0RTC.denoise``) reads the chunk, the delay and the horizon as
device tensors and forms the prefix weights and the dim mask on the device,
so that one CUDA graph (``policies/graphs.py``) serves every delay and
horizon, as JAX traces them as arrays. The chunk's length and ``provided_dim``
are shapes. The prefix runs under ``no_grad`` and each guided velocity under
``enable_grad``; the served parameters take no gradient (``Pi0RTC`` freezes
them), so the backward reaches x_t only. The vjp runs the backward kernels of
the attention (K1b) and of the int8 products (K5's column-scale mode, K4b
``nn``) on the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.models import pi0 as _pi0

RTC_KEYS = ("prev_action_chunk", "inference_delay", "execute_horizon")
GUIDED_DIMS = 14  # at most the joints and grippers of a bimanual robot are guided


def get_prefix_weights(start: torch.Tensor, end: torch.Tensor, total: int, schedule: str) -> torch.Tensor:
    """Per-step guidance weights [total]: 1 before ``start``, 0 from ``end``, scheduled between.

    ``start`` and ``end`` are 0-d tensors on the weights' device.
    """
    start = torch.minimum(start, end)
    steps = torch.arange(total, device=end.device)
    if schedule == "ones":
        w = torch.ones(total, device=end.device)
    elif schedule == "zeros":
        w = (steps < start).to(torch.float32)
    elif schedule in ("linear", "exp"):
        w = torch.clamp((start - 1 - steps) / (end - start + 1) + 1, 0, 1)
        if schedule == "exp":
            w = w * torch.expm1(w) / (math.e - 1)
    else:
        raise ValueError(f"Invalid schedule: {schedule}")
    return torch.where(steps >= end, 0, w)


@dataclasses.dataclass(frozen=True)
class Pi0RTCConfig(_pi0.Pi0Config):
    """π₀.₅ with RTC-capable sampling."""

    @property
    def model_type(self) -> _model.ModelType:
        return _model.ModelType.PI05_RTC if self.pi05 else _model.ModelType.PI0_RTC


def _scrub(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _guidance_weight(time: torch.Tensor, max_guidance_weight: float) -> torch.Tensor:
    """LeRobot-RTC guidance weight at τ = 1 − t, capped at ``max_guidance_weight``."""
    tau_safe = torch.clamp(1.0 - time, 1e-3, 1.0)
    squared_one_minus_tau = (1 - tau_safe) ** 2
    inv_r2 = (squared_one_minus_tau + tau_safe**2) / squared_one_minus_tau
    c = torch.nan_to_num((1 - tau_safe) / tau_safe, posinf=max_guidance_weight)
    return torch.clamp(c * inv_r2, max=max_guidance_weight)


def rtc_inputs(prev_action_chunk, inference_delay, execute_horizon, action_horizon: int, action_dim: int):
    """A request's RTC keys as the sampler takes them: (chunk f32 [1, L, action_dim], cropped or zero-padded, NaN
    kept for the sampler to scrub; ``provided_dim``, the leading dims guided; f32 [2]: the delay, 0 when None, and
    the horizon, ``action_horizon`` when None, both unclipped)."""
    chunk = np.asarray(prev_action_chunk, dtype=np.float32)
    if chunk.ndim == 2:
        chunk = chunk[None]
    provided_dim = min(GUIDED_DIMS, chunk.shape[-1], action_dim)
    if chunk.shape[-1] > action_dim:
        chunk = chunk[..., :action_dim]
    elif chunk.shape[-1] < action_dim:
        chunk = np.concatenate([chunk, np.zeros((*chunk.shape[:-1], action_dim - chunk.shape[-1]), np.float32)], -1)
    scalars = [0 if inference_delay is None else inference_delay, action_horizon if execute_horizon is None else
               execute_horizon]
    return np.ascontiguousarray(chunk), provided_dim, np.array([np.asarray(x).item() for x in scalars], np.float32)


class Pi0RTC(_pi0.Pi0):
    """π₀.₅ served with RTC guidance; its parameters are frozen (the vjp is with respect to x_t only)."""

    def __init__(self, config: _pi0.Pi0Config, *, device="cuda", param_dtype: torch.dtype = torch.float32):
        super().__init__(config, device=device, param_dtype=param_dtype)
        self.requires_grad_(False)

    @torch.no_grad()
    def denoise(
        self,
        observation: _model.Observation,
        noise: torch.Tensor,
        times: torch.Tensor,
        chunk: torch.Tensor | None = None,
        delay: torch.Tensor | None = None,
        horizon: torch.Tensor | None = None,
        *,
        provided_dim: int = 0,
        mask_prefix_delay: bool = False,
        prefix_attention_schedule: str = "exp",
        max_guidance_weight: float = 0.5,
    ) -> torch.Tensor:
        """``Pi0.denoise``, guided by ``chunk`` [1, L, action_dim] when given.

        ``delay`` and ``horizon`` are f32 0-d device tensors as the client sent
        them (clipped here). Launches kernels only: ``graphs.SampleGraph``
        captures it.
        """
        observation, kv_cache, prefix_mask = self.prefix(observation)
        horizon_len = self.config.action_horizon
        dt = -1.0 / times.shape[0]
        x_t = noise.to(torch.float32)

        def velocity(x, time):
            return self.compute_velocity(observation, kv_cache, prefix_mask, x, time)

        if chunk is None:
            for step in range(times.shape[0]):
                x_t = x_t + dt * _scrub(velocity(x_t, times[step]))
            return _scrub(x_t)

        prev_chunk = _scrub(chunk.to(torch.float32))
        exec_h = torch.clamp(horizon, 1, horizon_len).clamp(max=chunk.shape[1])
        d = torch.clamp(delay, 0, horizon_len)
        dim_mask = (torch.arange(self.config.action_dim, device=x_t.device) < provided_dim).to(torch.float32)[None, None]
        weights = get_prefix_weights(d, exec_h, horizon_len, prefix_attention_schedule)
        delayed = (torch.arange(horizon_len, device=x_t.device) < d)[None, :, None]
        for step in range(times.shape[0]):
            time = times[step]
            x_in = x_t
            if mask_prefix_delay and provided_dim > 0:
                # Freeze the still-executing delay prefix to the previous chunk.
                head = torch.where(delayed, prev_chunk[..., :provided_dim], x_t[..., :provided_dim])
                x_in = torch.cat([head, x_t[..., provided_dim:]], dim=-1)
            x_in = x_in.detach().requires_grad_()
            with torch.enable_grad():
                v_t = velocity(x_in, time)
                # The flow runs action → noise: the action estimate from (x_t, v_t) is x̂₁ = x_t − t·v_t.
                x_1 = x_in - time * v_t
            error = (prev_chunk - x_1.detach()) * weights[None, :, None] * dim_mask
            (correction,) = torch.autograd.grad(x_1, x_in, grad_outputs=error)
            v_t = _scrub(v_t.detach() - _guidance_weight(time, max_guidance_weight) * correction)
            x_t = x_t + dt * v_t
        return _scrub(x_t)

    def sample_actions(
        self,
        observation: _model.Observation,
        *,
        num_steps: int = 10,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        prev_action_chunk=None,
        inference_delay=None,
        execute_horizon=None,
        mask_prefix_delay: bool = False,
        prefix_attention_schedule: str = "exp",
        max_guidance_weight: float = 0.5,
        enable_rtc: bool = True,
    ) -> torch.Tensor:
        """``kai0_tpu.models.pi0_rtc.sample_actions``: actions [B, H, action_dim] f32, guided by ``prev_action_chunk``
        ([L, D] or [1, L, D], any D) over ``[inference_delay, execute_horizon)`` when given and ``enable_rtc``."""
        batch_size = observation.state.shape[0]
        shape = (batch_size, self.config.action_horizon, self.config.action_dim)
        if noise is None:
            noise = torch.randn(shape, generator=generator, dtype=torch.float32, device=self.device)
        times = self.time_grid(num_steps)
        if not (enable_rtc and prev_action_chunk is not None):
            return self.denoise(observation, noise, times)
        chunk, provided_dim, scalars = rtc_inputs(prev_action_chunk, inference_delay, execute_horizon,
                                                  self.config.action_horizon, self.config.action_dim)
        scalars = torch.from_numpy(scalars).to(self.device)
        return self.denoise(
            observation, noise, times, torch.from_numpy(chunk).to(self.device), scalars[0], scalars[1],
            provided_dim=provided_dim, mask_prefix_delay=mask_prefix_delay,
            prefix_attention_schedule=prefix_attention_schedule, max_guidance_weight=max_guidance_weight,
        )
