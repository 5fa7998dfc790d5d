"""Policy runtime: caller-supplied transforms around ``Pi0.sample_actions``.

Counterpart of ``kai0_tpu/policies/policy.py:89-135`` (``Policy.infer``): copy
the observation, apply the input transforms on the host, add a batch axis and
move to the device, sample one action chunk, take it back to numpy, apply the
output transforms, and report ``policy_timing``. The transforms are plain
callables on dicts; the model-facing dict has ``image`` (uint8 [224,224,3] per
camera), ``image_mask``, ``state``, ``tokenized_prompt`` and
``tokenized_prompt_mask``, already tokenized and resized. Batched inference,
prompt buckets and the RTC kwargs are not ported.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
import time

import numpy as np
import torch

from kai0_tpu_torch.models import model as _model

Transform = Callable[[dict], dict]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _compose(transforms: Sequence[Transform]) -> Transform:
    def apply(data: dict) -> dict:
        for transform in transforms:
            data = transform(data)
        return data

    return apply


class Policy:
    def __init__(
        self,
        model,
        config,
        *,
        device: torch.device | str = "cuda",
        generator: torch.Generator | None = None,
        transforms: Sequence[Transform] = (),
        output_transforms: Sequence[Transform] = (),
    ):
        self._model = model
        self._config = config
        self._device = torch.device(device)
        self._generator = generator
        self._input_transform = _compose(transforms)
        self._output_transform = _compose(output_transforms)

    @property
    def model_config(self):
        return self._config

    def infer(self, obs: dict, *, noise: np.ndarray | None = None) -> dict:
        t_start = time.monotonic()
        inputs = _map(lambda x: x, obs)  # copy: transforms may modify inputs in place
        inputs = self._input_transform(inputs)
        t_staged = time.monotonic()
        batched = _map(lambda x: torch.from_numpy(np.array(x))[None].to(self._device), inputs)
        if noise is not None:
            noise = torch.as_tensor(np.asarray(noise), dtype=torch.float32, device=self._device)
            if noise.ndim == 2:
                noise = noise[None]
        observation = _model.Observation.from_dict(batched)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)  # staging is not model time
        start_time = time.monotonic()
        actions = self._model.sample_actions(observation, noise=noise, generator=self._generator)
        outputs = {"state": batched["state"], "actions": actions}
        outputs = {k: v[0].cpu().numpy() for k, v in outputs.items()}  # waits for the device
        t_fetched = time.monotonic()

        outputs = self._output_transform(outputs)
        t_end = time.monotonic()
        outputs["policy_timing"] = {
            "infer_ms": (t_fetched - start_time) * 1000,
            "transform_ms": ((t_staged - t_start) + (t_end - t_fetched)) * 1000,
            "stage_ms": (start_time - t_staged) * 1000,
        }
        return outputs

    def reset(self) -> None:
        pass
