"""The advantage (stage-progress) estimator: a value head on the π₀.₅ action expert, PyTorch.

Counterpart of ``kai0_tpu/models/advantage.py``:

- ``value_head`` = Linear(w, w) → SiLU → Linear(w, w) → SiLU → Linear(w, 1) →
  tanh over the first suffix token's final representation (``suffix_out[:, 0]``),
  all in f32 (``advantage.py:54-57``). It is an ``nn.Sequential`` so that its
  state-dict keys are ``value_head.{0,2,4}.{weight,bias}``, the names of the
  reference's torch checkpoints; the forward applies the three products
  itself, in f32 whatever the parameters' dtype.
- ``compute_loss`` = ``loss_action_weight`` · flow MSE [B, H] +
  ``loss_value_weight`` · (value − clip(progress, −1, 1))² [B, 1], broadcast to
  [B, H]; preprocessing runs with ``train=False`` (no augmentation,
  ``:92-118``). ``compute_loss_and_aux`` also returns the two means.
- ``sample_values``: one joint forward on random noisy actions and time;
  returns the value [B, 1] (``:121-130``).

Draws come from ``generator``: noise, then time (as JAX splits its key), time
~ Beta(1.5, 1)·0.999 + 0.001; ``noise=`` and ``time=`` override them. The
joint prefix + suffix pass is ``Pi0.suffix_forward`` (no KV cache), so the
estimator launches the attention kernels exactly as the π₀.₅ loss does.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F

from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.models import pi0 as _pi0


@dataclasses.dataclass(frozen=True)
class AdvantageEstimatorConfig(_pi0.Pi0Config):
    loss_action_weight: float = 1.0
    loss_value_weight: float = 1.0


class AdvantageEstimator(_pi0.Pi0):
    def __init__(self, config: AdvantageEstimatorConfig, *, device="cuda", param_dtype: torch.dtype = torch.float32):
        super().__init__(config, device=device, param_dtype=param_dtype)
        factory = {"device": device, "dtype": param_dtype}
        width = config.action_expert_config.width
        self.value_head = nn.Sequential(
            nn.Linear(width, width, **factory), nn.SiLU(),
            nn.Linear(width, width, **factory), nn.SiLU(),
            nn.Linear(width, 1, **factory), nn.Tanh(),
        )

    def value(self, suffix_out: torch.Tensor) -> torch.Tensor:
        """The head over the first suffix token, in f32: [B, 1] in (−1, 1)."""
        dense = self.value_head[0::2]
        h = F.silu(_pi0._linear(suffix_out[:, 0, :].float(), dense[0]))
        h = F.silu(_pi0._linear(h, dense[1]))
        return torch.tanh(_pi0._linear(h, dense[2]))

    def compute_loss_and_aux(
        self,
        observation: _model.Observation,
        actions: torch.Tensor,
        *,
        noise: torch.Tensor | None = None,
        time: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        remat: bool = True,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(weighted flow + value loss [B, H], {"loss_action", "loss_value"} means)."""
        observation = _model.preprocess_observation(observation, train=False)
        actions = actions.float()
        noise, time = _pi0.draw_noise_and_time(actions.shape, generator, actions.device, noise, time)
        t = time[:, None, None]
        x_t = t * noise + (1 - t) * actions
        u_t = noise - actions

        suffix_out = self.suffix_forward(observation, x_t, time, remat=remat)
        v_t = _pi0._linear(suffix_out[:, -self.config.action_horizon :].float(), self.action_out_proj)
        loss_action = torch.mean(torch.square(v_t - u_t), dim=-1)  # [B, H]

        value_pred = self.value(suffix_out)  # [B, 1]
        progress_tgt = torch.clamp(observation.progress.float(), -1.0, 1.0)[:, None]
        loss_value = torch.square(value_pred - progress_tgt)  # [B, 1]

        loss = loss_action * self.config.loss_action_weight + loss_value * self.config.loss_value_weight
        return loss, {"loss_action": loss_action.mean(), "loss_value": loss_value.mean()}

    def compute_loss(
        self,
        observation: _model.Observation,
        actions: torch.Tensor,
        *,
        train: bool = False,
        noise: torch.Tensor | None = None,
        time: torch.Tensor | None = None,
        augment_params: dict | None = None,
        generator: torch.Generator | None = None,
        remat: bool = True,
    ) -> torch.Tensor:
        """The loss [B, H] of ``compute_loss_and_aux``. ``train`` and ``augment_params`` are accepted and unused:
        the estimator trains without augmentation (reference ``pi0_pytorch.py:487``)."""
        del train, augment_params
        loss, _ = self.compute_loss_and_aux(
            observation, actions, noise=noise, time=time, generator=generator, remat=remat
        )
        return loss

    @torch.inference_mode()
    def sample_values(
        self,
        observation: _model.Observation,
        *,
        noise: torch.Tensor | None = None,
        time: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """The predicted progress value [B, 1] of a batch, from one forward on noisy actions at a random time."""
        observation = _model.preprocess_observation(observation, train=False)
        batch_size = observation.state.shape[0]
        shape = (batch_size, self.config.action_horizon, self.config.action_dim)
        noise, time = _pi0.draw_noise_and_time(shape, generator, self.device, noise, time)
        suffix_out = self.suffix_forward(observation, noise.float(), time)
        return self.value(suffix_out)
