"""π₀.₅ flow-matching VLA, PyTorch: the training loss and the sampler.

Counterpart of ``kai0_tpu/models/pi0.py``. Serving: the prefix (SigLIP tokens
for each camera + prompt tokens, bidirectional) runs once through the
PaliGemma expert and leaves a per-layer KV cache; then ``num_steps`` Euler
steps from t=1 to 0 run the action expert (adaRMS time conditioning) against
that cache. Training: ``compute_loss`` runs prefix and suffix jointly through
both experts and returns the flow-matching velocity MSE.

Parameters follow the ``PI0Pytorch`` state-dict layout
(``paligemma_with_expert.paligemma.model.language_model...``,
``paligemma_with_expert.gemma_expert.model...``, ``action_in_proj`` ...), so the
output of ``kai0_tpu.interop.torch_safetensors.jax_to_torch_state`` loads with
``strict=True``. The ``*_lora`` Gemma variants add LoRA factors (carried across by
``kai0_tpu_torch.interop.lora_state_from_jax``), and ``Pi0Config.freeze_filter``
names the leaves a LoRA fine-tune freezes. Only π₀.₅ (``pi05=True``) is ported;
the π₀ state-token suffix is not. The model is built on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

from collections.abc import Callable
import dataclasses
import math
import re

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from kai0_tpu_torch import param_paths as _param_paths
from kai0_tpu_torch.models import gemma as _gemma
from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.models import siglip as _siglip
from kai0_tpu_torch.ops.masks import make_attn_mask, posemb_sincos


@dataclasses.dataclass(frozen=True)
class Pi0Config:
    dtype: str = "bfloat16"
    paligemma_variant: str = "gemma_2b"
    action_expert_variant: str = "gemma_300m"
    vision_variant: str = "So400m/14"

    action_dim: int = 32
    action_horizon: int = 50
    max_token_len: int = None  # type: ignore[assignment]
    pi05: bool = False
    discrete_state_input: bool = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.max_token_len is None:
            object.__setattr__(self, "max_token_len", 200 if self.pi05 else 48)
        if self.discrete_state_input is None:
            object.__setattr__(self, "discrete_state_input", self.pi05)

    @property
    def model_type(self) -> _model.ModelType:
        return _model.ModelType.PI05 if self.pi05 else _model.ModelType.PI0

    @property
    def paligemma_config(self) -> _gemma.Config:
        return _gemma.get_config(self.paligemma_variant)

    @property
    def action_expert_config(self) -> _gemma.Config:
        return _gemma.get_config(self.action_expert_variant)

    @property
    def use_adarms(self) -> tuple[bool, bool]:
        return (False, True) if self.pi05 else (False, False)

    @property
    def vision_config(self) -> _siglip.Config:
        return _siglip.get_config(self.paligemma_config.width, self.vision_variant, dtype_mm=self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def inputs_spec(self, *, batch_size: int = 1) -> tuple[dict, tuple]:
        """``(shape, numpy dtype)`` of each input of a batch, for ``FakeDataset`` (``kai0_tpu/models/pi0.py:84-96``).

        The observation in the nested-dict form of ``Observation.from_dict``
        (images float32 in [-1, 1], keyed by camera), and the actions.
        """
        f32, boolean = np.dtype(np.float32), np.dtype(bool)
        observation = {
            "image": {key: ((batch_size, *_model.IMAGE_RESOLUTION, 3), f32) for key in _model.IMAGE_KEYS},
            "image_mask": {key: ((batch_size,), boolean) for key in _model.IMAGE_KEYS},
            "state": ((batch_size, self.action_dim), f32),
            "tokenized_prompt": ((batch_size, self.max_token_len), np.dtype(np.int32)),
            "tokenized_prompt_mask": ((batch_size, self.max_token_len), boolean),
        }
        return observation, ((batch_size, self.action_horizon, self.action_dim), f32)

    def fake_obs(self, batch_size: int = 1) -> dict[str, np.ndarray]:
        """A batch of ones in the model-facing form the transform chain produces (``Observation.from_dict``'s input).

        ``kai0_tpu``'s ``fake_obs`` is the ``Observation`` of ones; the port stages
        uint8 images, so its images are 255, which ``from_dict`` maps to that 1.0.
        """
        images = np.full((batch_size, *_model.IMAGE_RESOLUTION, 3), 255, dtype=np.uint8)
        return {
            "image": {key: images for key in _model.IMAGE_KEYS},
            "image_mask": {key: np.ones(batch_size, dtype=bool) for key in _model.IMAGE_KEYS},
            "state": np.ones((batch_size, self.action_dim), dtype=np.float32),
            "tokenized_prompt": np.ones((batch_size, self.max_token_len), dtype=np.int32),
            "tokenized_prompt_mask": np.ones((batch_size, self.max_token_len), dtype=bool),
        }

    def freeze_filter(self) -> Callable[[str], bool]:
        """Predicate on the port's parameter names (True = frozen): the JAX filter on the path each name maps to."""
        frozen = make_freeze_filter(self.paligemma_variant, self.action_expert_variant)
        return lambda name: frozen(_param_paths.jax_param_path(name))


def make_freeze_filter(paligemma_variant: str, action_expert_variant: str) -> Callable[[str], bool]:
    """LoRA freeze logic on JAX parameter paths (True = frozen), as ``kai0_tpu.models.pi0.make_freeze_filter``:
    the base weights of a LoRA'd expert freeze, LoRA factors never do."""
    gemma_re = re.compile(r".*llm.*")
    expert_re = re.compile(r".*llm.*_1.*")
    lora_re = re.compile(r".*lora.*")

    pg_lora = "lora" in paligemma_variant
    ae_lora = "lora" in action_expert_variant

    def frozen(path: str) -> bool:
        if not (pg_lora or ae_lora):
            return False
        if lora_re.match(path):
            return False
        if pg_lora and gemma_re.match(path):
            if not ae_lora and expert_re.match(path):
                return False  # action expert trains fully
            return True
        if ae_lora and not pg_lora:
            return bool(expert_re.match(path))
        return False

    return frozen


class _Node(nn.Module):
    """A named level of the state-dict hierarchy."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


def draw_noise_and_time(shape, generator, device, noise=None, time=None):
    """The flow's noise ~ N(0, 1) of ``shape``, then time ~ Beta(1.5, 1)·0.999 + 0.001 per row, from ``generator``;
    a given ``noise`` or ``time`` is kept (and not drawn)."""
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    if time is None:
        # Beta(1.5, 1) has CDF x^1.5: invert it on a uniform draw.
        u = torch.rand(shape[0], generator=generator, device=device)
        time = u ** (1 / 1.5) * 0.999 + 0.001
    return noise, time


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """x·Wᵀ + b in x's dtype (the projection heads run in f32 on f32 inputs)."""
    return x @ layer.weight.to(x.dtype).T + layer.bias.to(x.dtype)


class Pi0(nn.Module):
    def __init__(self, config: Pi0Config, *, device="cuda", param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if not config.pi05:
            raise NotImplementedError("only the π₀.₅ model (pi05=True) is ported")
        self.config = config
        factory = {"device": device, "dtype": param_dtype}
        vlm, expert, vit = config.paligemma_config, config.action_expert_config, config.vision_config
        adarms = config.use_adarms
        self.paligemma_with_expert = _Node(
            paligemma=_Node(
                model=_Node(
                    language_model=_gemma.GemmaModel(vlm, adarms=adarms[0], embed=True, **factory),
                    vision_tower=_Node(vision_model=_siglip.VisionModel(vit, _model.IMAGE_RESOLUTION, **factory)),
                    multi_modal_projector=_Node(linear=nn.Linear(vit.width, vit.num_classes, **factory)),
                )
            ),
            gemma_expert=_Node(model=_gemma.GemmaModel(expert, adarms=adarms[1], embed=False, **factory)),
        )
        self.action_in_proj = nn.Linear(config.action_dim, expert.width, **factory)
        self.action_out_proj = nn.Linear(expert.width, config.action_dim, **factory)
        self.time_mlp_in = nn.Linear(expert.width, expert.width, **factory)
        self.time_mlp_out = nn.Linear(expert.width, expert.width, **factory)

    # -- structure ---------------------------------------------------------------------

    @property
    def _pg(self) -> nn.Module:
        return self.paligemma_with_expert.paligemma.model

    @property
    def experts(self) -> list[_gemma.GemmaModel]:
        return [self._pg.language_model, self.paligemma_with_expert.gemma_expert.model]

    @property
    def device(self) -> torch.device:
        return self.action_in_proj.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Pi0":
        """Draw every parameter from ``generator`` (on the parameters' device).

        Matrices ~ N(0, 1/fan_in); embeddings ~ N(0, 1/width); biases ~ N(0, 0.02²);
        LayerNorm scales ~ 1 + N(0, 0.1²) and RMSNorm ``w`` ~ N(0, 0.1²) (applied as
        1+w). The leaves that the JAX init zeroes (adaRMS ``dense``, the SigLIP
        head) are drawn like the others, so the action expert's gates are open
        and image tokens reach the actions. LoRA factors ~ N(0, init_stddev²),
        both of them (as the JAX init), drawn after everything else.
        """

        def normal(t, std):
            t.normal_(0.0, std, generator=generator)

        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                normal(module.weight, 1.0 / math.sqrt(module.weight[0].numel()))
                if module.bias is not None:
                    normal(module.bias, 0.02)
            elif isinstance(module, nn.Embedding):
                normal(module.weight, 1.0 / math.sqrt(module.weight.shape[1]))
            elif isinstance(module, nn.LayerNorm):
                normal(module.weight, 0.1)
                module.weight.add_(1.0)
                normal(module.bias, 0.02)
            elif isinstance(module, _gemma.RMSNorm):
                normal(module.weight, 0.1)
        for expert in self.experts:
            for name, p in expert.named_parameters():
                if "lora" in name:
                    lora = expert.config.lora_attn if "self_attn" in name else expert.config.lora_ffn
                    normal(p, lora.init_stddev)
        return self

    # -- embedding ---------------------------------------------------------------------

    def embed_prefix(self, obs: _model.Observation, *, remat: bool = True):
        """Images + prompt -> (tokens [B, P, D0], input_mask bool[B, P], ar_mask bool[P]).

        All cameras go through SigLIP in one batched call.
        """
        image_names = list(obs.images)
        images = torch.stack([obs.images[name] for name in image_names], dim=0)  # [C, B, H, W, 3]
        c, b = images.shape[:2]
        image_tokens = _siglip.apply(
            self._pg.vision_tower.vision_model,
            self._pg.multi_modal_projector.linear,
            images.reshape(c * b, *images.shape[2:]),
            remat=remat,
        )
        image_tokens = image_tokens.reshape(c, b, *image_tokens.shape[1:])
        tokens_per_image = image_tokens.shape[2]

        tokens = [image_tokens[i] for i in range(c)]
        input_mask = [obs.image_masks[name][:, None].expand(b, tokens_per_image) for name in image_names]
        if obs.tokenized_prompt is not None:
            prompt = _gemma.embed(self._pg.language_model, obs.tokenized_prompt, self.config.torch_dtype)
            tokens.append(prompt)
            input_mask.append(obs.tokenized_prompt_mask)
        tokens = torch.cat(tokens, dim=1)
        # The prefix attends bidirectionally; made on the device, so that a CUDA graph can capture it.
        return tokens, torch.cat(input_mask, dim=1), torch.zeros(tokens.shape[1], dtype=torch.bool, device=images.device)

    def embed_suffix(self, obs: _model.Observation, noisy_actions: torch.Tensor, timestep: torch.Tensor):
        """Noisy actions + time (π₀.₅) -> (tokens [B, H, D1], input_mask, ar_mask, adarms_cond)."""
        action_tokens = _linear(noisy_actions, self.action_in_proj)
        time_emb = posemb_sincos(timestep, self.config.action_expert_config.width, min_period=4e-3, max_period=4.0)
        time_emb = F.silu(_linear(time_emb, self.time_mlp_in))
        time_emb = F.silu(_linear(time_emb, self.time_mlp_out))
        horizon = self.config.action_horizon
        input_mask = torch.ones(action_tokens.shape[:2], dtype=torch.bool, device=action_tokens.device)
        ar_mask = torch.arange(horizon, device=action_tokens.device) == 0  # [True, False, ...]: made on the device
        return action_tokens, input_mask, ar_mask, time_emb

    # -- training ----------------------------------------------------------------------

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
        """Flow-matching velocity MSE per (batch, action step), f32 [B, H] (``pi0.py:269-298``).

        time ~ Beta(1.5, 1)·0.999 + 0.001, x_t = t·noise + (1−t)·actions,
        u_t = noise − actions; prefix and suffix run jointly through both
        experts with positions ``cumsum(input_mask) − 1``, and the f32
        ``action_out_proj`` head reads the last ``action_horizon`` tokens.
        ``noise``, ``time`` and ``augment_params`` override draws from
        ``generator`` (augmentation, then noise, then time).
        """
        observation = _model.preprocess_observation(
            observation, train=train, augment_params=augment_params, generator=generator
        )
        actions = actions.float()
        noise, time = draw_noise_and_time(actions.shape, generator, actions.device, noise, time)
        t = time[:, None, None]
        x_t = t * noise + (1 - t) * actions
        u_t = noise - actions

        suffix_out = self.suffix_forward(observation, x_t, time, remat=remat)
        v_t = _linear(suffix_out[:, -self.config.action_horizon :].float(), self.action_out_proj)
        return torch.mean(torch.square(v_t - u_t), dim=-1)

    def suffix_forward(
        self, observation: _model.Observation, x_t: torch.Tensor, time: torch.Tensor, *, remat: bool = True
    ) -> torch.Tensor:
        """The joint prefix + suffix pass through both experts, no KV cache: the suffix expert's output tokens.

        Positions are ``cumsum(input_mask) − 1``; ``observation`` is preprocessed.
        """
        prefix_tokens, prefix_mask, prefix_ar_mask = self.embed_prefix(observation, remat=remat)
        suffix_tokens, suffix_mask, suffix_ar_mask, adarms_cond = self.embed_suffix(observation, x_t, time)
        input_mask = torch.cat([prefix_mask, suffix_mask], dim=1)
        ar_mask = torch.cat([prefix_ar_mask, suffix_ar_mask], dim=0)
        attn_mask = make_attn_mask(input_mask, ar_mask)
        positions = torch.cumsum(input_mask.to(torch.int32), dim=1) - 1
        (_, suffix_out), _ = _gemma.apply(
            self.experts,
            [prefix_tokens, suffix_tokens],
            positions,
            attn_mask,
            [None, adarms_cond],
            embed_dtype=self.config.torch_dtype,
            remat=remat,
            return_kv_cache=False,
        )
        return suffix_out

    # -- sampling ----------------------------------------------------------------------

    def compute_prefix_kv_cache(self, obs: _model.Observation):
        """Prefix-only forward pass: returns (per-layer kv_cache, prefix_mask)."""
        prefix_tokens, prefix_mask, prefix_ar_mask = self.embed_prefix(obs)
        prefix_attn_mask = make_attn_mask(prefix_mask, prefix_ar_mask)
        positions = torch.cumsum(prefix_mask.to(torch.int32), dim=1) - 1
        _, kv_cache = _gemma.apply(
            self.experts, [prefix_tokens, None], positions, prefix_attn_mask, embed_dtype=self.config.torch_dtype
        )
        return kv_cache, prefix_mask

    def compute_velocity(self, obs, kv_cache, prefix_mask, x_t: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        """One denoiser evaluation v(x_t, t) against the cached prefix. Never recomputed: RTC's guided steps take its
        gradient, and recomputing each block would launch its forward kernels twice."""
        batch_size = obs.state.shape[0]
        suffix_tokens, suffix_mask, suffix_ar_mask, adarms_cond = self.embed_suffix(
            obs, x_t, time.expand(batch_size)
        )
        suffix_attn_mask = make_attn_mask(suffix_mask, suffix_ar_mask)
        prefix_attn_mask = prefix_mask[:, None, :].expand(batch_size, suffix_tokens.shape[1], prefix_mask.shape[1])
        full_attn_mask = torch.cat([prefix_attn_mask, suffix_attn_mask], dim=-1)
        positions = prefix_mask.sum(dim=-1)[:, None] + torch.cumsum(suffix_mask.to(torch.int32), dim=-1) - 1
        (_, suffix_out), _ = _gemma.apply(
            self.experts,
            [None, suffix_tokens],
            positions,
            full_attn_mask,
            [None, adarms_cond],
            kv_cache=kv_cache,
            embed_dtype=self.config.torch_dtype,
            remat=False,
        )
        return _linear(suffix_out[:, -self.config.action_horizon :].float(), self.action_out_proj)

    def time_grid(self, num_steps: int) -> torch.Tensor:
        """The Euler steps' times on the model's device: 1, 1 + dt, ... with dt = -1/num_steps.

        They follow the JAX loop's carry: ``time = f32(time) + f32(dt)`` while
        ``time >= -dt/2``, which gives ``num_steps`` steps. A device tensor made
        once, so that a CUDA graph of the loop reads it instead of a host scalar.
        """
        dt = -1.0 / num_steps
        times, time = [], 1.0
        while time >= -dt / 2:
            times.append(time)
            time = float(np.float32(time) + np.float32(dt))
        return torch.tensor(times, dtype=torch.float32, device=self.device)

    def prefix(self, observation: _model.Observation):
        """Preprocessing and the prefix pass: (the preprocessed observation, per-layer kv_cache, prefix_mask)."""
        observation = _model.preprocess_observation(observation)
        kv_cache, prefix_mask = self.compute_prefix_kv_cache(observation)
        return observation, kv_cache, prefix_mask

    @torch.inference_mode()
    def denoise(self, observation: _model.Observation, noise: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        """From preprocessing to x_0: the prefix pass and its KV cache, then one Euler step per entry of ``times``.

        Launches kernels only, reading ``noise`` and ``times`` (``time_grid``) on
        the device: ``policies/graphs.py`` captures it as one CUDA graph.
        """
        observation, kv_cache, prefix_mask = self.prefix(observation)
        dt = -1.0 / times.shape[0]
        x_t = noise.to(torch.float32)
        for step in range(times.shape[0]):
            x_t = x_t + dt * self.compute_velocity(observation, kv_cache, prefix_mask, x_t, times[step])
        return x_t

    @torch.inference_mode()
    def sample_actions(
        self,
        observation: _model.Observation,
        *,
        num_steps: int = 10,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Euler-integrate the flow from t=1 (noise) to t=0; returns actions [B, H, action_dim] f32.

        ``time`` is kept at f32 precision as the JAX loop carries it, and the stop
        rule ``time >= -dt/2`` gives ``num_steps`` steps (``time_grid``).
        """
        batch_size = observation.state.shape[0]
        shape = (batch_size, self.config.action_horizon, self.config.action_dim)
        if noise is None:
            noise = torch.randn(shape, generator=generator, dtype=torch.float32, device=self.device)
        return self.denoise(observation, noise, self.time_grid(num_steps))
