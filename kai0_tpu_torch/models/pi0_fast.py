"""π₀-FAST: the autoregressive action-token VLA, PyTorch.

Counterpart of ``kai0_tpu/models/pi0_fast.py``. One Gemma (no action expert):
the inputs are SigLIP's tokens of each camera (bidirectional) and the
tokenized prompt, whose ``token_ar_mask`` makes the prompt's action part
causal; the actions are tokens of the prompt.

- ``compute_loss``: the next-token cross entropy over ``token_loss_mask``,
  normalized per sample. The logits are decoded for the target positions only,
  and each target's log-probability is gathered from ``log_softmax``, which
  gives the value of JAX's product with a one-hot over the 257,152-token
  vocabulary without building that one-hot.
- ``sample_actions``: the prefix is rolled so that its valid tokens end at the
  right edge (``left_to_right_align``), the prefill fills a KV cache of
  capacity prefill + ``max_decoding_steps`` (``gemma_fast.py``), and tokens are
  decoded one a step, greedily or by temperature from an explicit generator.
  The loop runs eagerly and checks on the host after each step whether every
  row has emitted EOS; it then stops, as JAX's ``while_loop`` does, so the
  returned f32 token buffer ``[B, max_decoding_steps]`` is JAX's: the tokens up
  to that step, zeros after. The forward pass of the step that ends the loop
  is skipped: nothing reads its logits.

Parameters: the PaliGemma half of the ``PI0Pytorch`` layout
(``paligemma_with_expert.paligemma.model.{language_model, vision_tower,
multi_modal_projector}``), the port's own naming of the FAST tree (JAX's
interop has no FAST mapping): a JAX FAST tree crosses through
``interop.state_from_jax``, and the port's checkpoints hold this layout. The
model is built on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

from collections.abc import Callable
import dataclasses
import re
from typing import Any

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from kai0_tpu_torch import param_paths as _param_paths
from kai0_tpu_torch.models import gemma as _gemma
from kai0_tpu_torch.models import gemma_fast as _gemma_fast
from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.models import pi0 as _pi0
from kai0_tpu_torch.models import siglip as _siglip
from kai0_tpu_torch.ops.masks import make_attn_mask

PALIGEMMA_EOS_TOKEN = 1

FAST_IMAGE_KEYS = ("base_0_rgb", "base_1_rgb", "wrist_0_rgb")


def left_to_right_align(x: torch.Tensor, input_mask: torch.Tensor, attn_mask: torch.Tensor):
    """Roll each left-aligned row so that its valid tokens end at the right edge (``pi0_fast.py:31-39``).

    x [B, N, ...], input_mask [B, N], attn_mask [B, N, N]: row b moves by
    ``-(last valid index + 1)``, as ``jnp.roll`` on both axes of the mask.
    """
    n = input_mask.shape[1]
    ar = torch.arange(n, device=input_mask.device)
    seqlen = (input_mask.to(torch.int64) * ar).amax(dim=1) + 1
    idx = (ar[None, :] + seqlen[:, None]) % n  # out[i] = in[(i + seqlen) % n]
    x = x.gather(1, idx.view(*idx.shape, *(1,) * (x.ndim - 2)).expand_as(x))
    attn_mask = attn_mask.gather(1, idx[:, :, None].expand(-1, -1, n)).gather(2, idx[:, None, :].expand(-1, n, -1))
    return x, input_mask.gather(1, idx), attn_mask


def put_along_last_axis(arr: torch.Tensor, indices: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``np.put_along_axis(arr, indices, values, axis=-1)`` out of place (``pi0_fast.py:42-47``)."""
    return arr.scatter(-1, indices, values.to(arr.dtype))


@dataclasses.dataclass(frozen=True)
class Pi0FASTConfig:
    dtype: str = "bfloat16"
    paligemma_variant: str = "gemma_2b"
    vision_variant: str = "So400m/14"

    action_dim: int = 32
    action_horizon: int = 32
    max_token_len: int = 250

    # Named by some configs; neither the model nor the transform factory reads them (the JAX package's
    # ``ModelTransformFactory`` builds a ``FASTTokenizer`` whatever they say, and so does the port's).
    fast_model_tokenizer: Any | None = None
    fast_model_tokenizer_kwargs: dict[str, Any] | None = None

    # Read by the transform factory.
    discrete_state_input: bool = True

    @property
    def model_type(self) -> _model.ModelType:
        return _model.ModelType.PI0_FAST

    @property
    def paligemma_config(self) -> _gemma.Config:
        return _gemma.get_config(self.paligemma_variant)

    @property
    def vision_config(self) -> _siglip.Config:
        return _siglip.get_config(self.paligemma_config.width, self.vision_variant, dtype_mm=self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def inputs_spec(self, *, batch_size: int = 1) -> tuple[dict, tuple]:
        """``(shape, numpy dtype)`` of each input of a batch (``kai0_tpu/models/pi0_fast.py:77-91``), in the
        nested-dict form of ``Observation.from_dict``."""
        f32, boolean, i32 = np.dtype(np.float32), np.dtype(bool), np.dtype(np.int32)
        tokens = (batch_size, self.max_token_len)
        observation = {
            "image": {key: ((batch_size, *_model.IMAGE_RESOLUTION, 3), f32) for key in FAST_IMAGE_KEYS},
            "image_mask": {key: ((batch_size,), boolean) for key in FAST_IMAGE_KEYS},
            "state": ((batch_size, self.action_dim), f32),
            "tokenized_prompt": (tokens, i32),
            "tokenized_prompt_mask": (tokens, boolean),
            "token_ar_mask": (tokens, i32),
            "token_loss_mask": (tokens, boolean),
        }
        return observation, ((batch_size, self.action_horizon, self.action_dim), f32)

    def fake_obs(self, batch_size: int = 1) -> dict[str, np.ndarray]:
        """A batch of ones in the model-facing form (uint8 images of 255, which ``from_dict`` maps to 1.0)."""
        observation, _ = self.inputs_spec(batch_size=batch_size)

        def ones(spec):
            if isinstance(spec, dict):
                return {k: ones(v) for k, v in spec.items()}
            shape, dtype = spec
            return np.ones(shape, dtype=dtype)

        fake = ones(observation)
        fake["image"] = {k: np.full(v.shape, 255, dtype=np.uint8) for k, v in fake["image"].items()}
        return fake

    def freeze_filter(self) -> Callable[[str], bool]:
        """Predicate on the port's parameter names (True = frozen), as ``pi0_fast.py:117-127`` on the JAX paths:
        with a ``*_lora`` Gemma its base weights freeze, LoRA factors and SigLIP train."""
        lora = "lora" in self.paligemma_variant
        llm_re, lora_re = re.compile(r".*llm.*"), re.compile(r".*lora.*")

        def frozen(path: str) -> bool:
            return bool(lora and llm_re.match(path) and not lora_re.match(path))

        return lambda name: frozen(_param_paths.jax_param_path(name))


class Pi0FAST(nn.Module):
    def __init__(self, config: Pi0FASTConfig, *, device="cuda", param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        factory = {"device": device, "dtype": param_dtype}
        vlm, vit = config.paligemma_config, config.vision_config
        self.paligemma_with_expert = _pi0._Node(
            paligemma=_pi0._Node(
                model=_pi0._Node(
                    language_model=_gemma.GemmaModel(vlm, adarms=False, embed=True, **factory),
                    vision_tower=_pi0._Node(vision_model=_siglip.VisionModel(vit, _model.IMAGE_RESOLUTION, **factory)),
                    multi_modal_projector=_pi0._Node(linear=nn.Linear(vit.width, vit.num_classes, **factory)),
                )
            )
        )

    @property
    def _pg(self) -> nn.Module:
        return self.paligemma_with_expert.paligemma.model

    @property
    def experts(self) -> list[_gemma.GemmaModel]:
        return [self._pg.language_model]

    @property
    def device(self) -> torch.device:
        return self._pg.multi_modal_projector.linear.weight.device

    def init_weights(self, generator: torch.Generator) -> "Pi0FAST":
        """Draw every parameter from ``generator``, as ``pi0.init_weights``."""
        return _pi0.init_weights(self, self.experts, generator)

    def embed_inputs(self, obs: _model.Observation, *, remat: bool = True):
        """Images + prompt -> (tokens [B, N, D], input_mask bool [B, N], ar_mask int32 [B, N]) (``pi0_fast.py:131-155``)."""
        image_names = list(obs.images)
        images = torch.stack([obs.images[name] for name in image_names], dim=0)
        c, b = images.shape[:2]
        image_tokens = _siglip.apply(
            self._pg.vision_tower.vision_model,
            self._pg.multi_modal_projector.linear,
            images.reshape(c * b, *images.shape[2:]),
            remat=remat,
        )
        image_tokens = image_tokens.reshape(c, b, *image_tokens.shape[1:])
        n = image_tokens.shape[2]
        tokens = [image_tokens[i] for i in range(c)]
        input_mask = [obs.image_masks[name][:, None].expand(b, n) for name in image_names]
        ar_mask = [torch.zeros((b, c * n), dtype=torch.int32, device=images.device)]
        tokens.append(_gemma.embed(self._pg.language_model, obs.tokenized_prompt, self.config.torch_dtype))
        input_mask.append(obs.tokenized_prompt_mask)
        ar_mask.append(obs.token_ar_mask.to(torch.int32))
        return torch.cat(tokens, dim=1), torch.cat(input_mask, dim=1), torch.cat(ar_mask, dim=1)

    def compute_loss(
        self,
        observation: _model.Observation,
        actions: torch.Tensor | None = None,
        *,
        train: bool = False,
        augment_params: dict | None = None,
        generator: torch.Generator | None = None,
        remat: bool = True,
        noise: torch.Tensor | None = None,
        time: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Per-sample masked next-token cross entropy, f32 [B] (``pi0_fast.py:158-187``).

        ``actions``, ``noise`` and ``time`` are unused (the action targets are
        FAST tokens of the prompt); they are taken so that ``train_step`` calls
        every model alike. Augmentation draws as ``pi0.Pi0.compute_loss``'s.
        """
        del actions, noise, time
        observation = _model.preprocess_observation(
            observation, train=train, augment_params=augment_params, generator=generator,
            image_keys=list(observation.images),
        )
        embeddings, input_mask, ar_mask = self.embed_inputs(observation, remat=remat)
        attn_mask = make_attn_mask(input_mask, ar_mask)
        targets = observation.tokenized_prompt[:, 1:].to(torch.int64)
        positions = torch.cumsum(input_mask.to(torch.int32), dim=1) - 1
        # Each position predicts the next token: the last input predicts nothing.
        pre_logits, _ = _gemma_fast.apply(
            self._pg.language_model, embeddings[:, :-1], positions[:, :-1], attn_mask[:, :-1, :-1].contiguous(),
            embed_dtype=self.config.torch_dtype, return_kv_cache=False, remat=remat,
        )
        logits = _gemma.decode_logits(self._pg.language_model, pre_logits[:, -targets.shape[1]:])
        logp = torch.log_softmax(logits.float(), dim=-1)
        token_pplx = logp.gather(-1, targets[..., None])[..., 0]
        loss_mask = observation.token_loss_mask[:, 1:]
        return -torch.sum(token_pplx * loss_mask, dim=-1) / torch.clamp(loss_mask.sum(dim=-1), min=1)

    @torch.inference_mode()
    def prefill(self, observation: _model.Observation, max_decoding_steps: int):
        """Preprocessing, the aligned prefix and the prefill: (the first step's f32 logits [B, 1, V], the KV cache of
        capacity prefill + ``max_decoding_steps``, prefill_len [B], prefix_start [B])."""
        observation = _model.preprocess_observation(observation, image_keys=list(observation.images))
        embeddings, input_mask, ar_mask = self.embed_inputs(observation)
        attn_mask = make_attn_mask(input_mask, ar_mask)
        embeddings, input_mask, attn_mask = left_to_right_align(embeddings, input_mask, attn_mask)
        prefill_len = input_mask.sum(dim=-1)
        prefix_start = input_mask.shape[1] - prefill_len
        # The cache's capacity is the mask's key length: prefill + decode budget.
        pad = attn_mask.new_zeros((*attn_mask.shape[:2], max_decoding_steps))
        positions = torch.cumsum(input_mask.to(torch.int32), dim=-1) - 1
        prelogits, kv_cache = _gemma_fast.apply(
            self._pg.language_model, embeddings, positions, torch.cat([attn_mask, pad], dim=-1),
            embed_dtype=self.config.torch_dtype,
        )
        last_logit = _gemma.decode_logits(self._pg.language_model, prelogits[:, -1:]).float()
        return last_logit, kv_cache, prefill_len, prefix_start

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, step: int, kv_cache, prefill_len, prefix_start):
        """Feed ``token`` [B, 1], decoded at ``step``: returns (the next f32 logits [B, 1, V], the cache).

        It attends to ``[prefix_start, prefill_size + step + 1)``: the row's
        valid prefix and the tokens decoded so far (``pi0_fast.py:247-251``).
        """
        lm = self._pg.language_model
        prefill_size = kv_cache.idx - step
        key_pos = torch.arange(kv_cache.k.shape[2], device=token.device)[None, None, :]
        mask = (key_pos >= prefix_start[:, None, None]) & (key_pos < prefill_size + step + 1)
        positions = prefill_len[:, None] + step + 1
        prelogits, kv_cache = _gemma_fast.apply(
            lm, _gemma.embed(lm, token, self.config.torch_dtype), positions, mask, kv_cache=kv_cache,
            embed_dtype=self.config.torch_dtype,
        )
        return _gemma.decode_logits(lm, prelogits).float(), kv_cache

    @torch.inference_mode()
    def sample_actions(
        self,
        observation: _model.Observation,
        *,
        max_decoding_steps: int = 256,
        temperature: float = 0.0,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Decode FAST action tokens: the f32 token buffer [B, max_decoding_steps] for the output transform
        (``pi0_fast.py:190-265``): argmax when ``temperature`` is 0, else a draw from ``generator`` at that
        temperature; zeros after the step at which every row has emitted EOS."""
        last_logit, kv_cache, prefill_len, prefix_start = self.prefill(observation, max_decoding_steps)
        batch = last_logit.shape[0]
        output_tokens = torch.zeros((batch, max_decoding_steps), dtype=torch.float32, device=last_logit.device)
        for step in range(max_decoding_steps):
            if temperature > 0.0:
                probs = torch.softmax(last_logit[:, 0] / max(temperature, 1e-6), dim=-1)
                token = torch.multinomial(probs, 1, generator=generator)
            else:
                token = torch.argmax(last_logit, dim=-1)
            output_tokens = put_along_last_axis(output_tokens, torch.full_like(token, step), token)
            if step == max_decoding_steps - 1 or bool(torch.all(torch.any(token == PALIGEMMA_EOS_TOKEN, dim=-1))):
                break
            last_logit, kv_cache = self.decode_step(token, step, kv_cache, prefill_len, prefix_start)
        return output_tokens
