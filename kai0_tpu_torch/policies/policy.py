"""Policy runtime: transform chains around the π₀.₅ sampler.

Counterpart of ``kai0_tpu/policies/policy.py``: ``infer`` copies the
observation, applies the input transforms on the host, trims the prompt's
padding to the smallest prompt bucket that holds it, adds a batch axis (in
JAX's input dtypes: f32 and int32), samples one action chunk, takes it back to
numpy, applies the output transforms and reports ``policy_timing``
(``infer_ms``: the model call with the fetch; ``transform_ms``: the host
transforms; ``stage_ms``: host → device staging, with any wait for another
thread's request).

On CUDA the sampler always runs as a captured CUDA graph (``graphs.py``), one
per shape of the staged inputs: a bucket's graph is captured on the first
request that needs it, or by ``warmup``. A graph's buffers serve one request
at a time: a lock serializes capture, staging, replay and fetch, so requests
from several threads (the server's executor) each get their own actions; the
host transforms run outside it. Tensors on the CPU run
``Pi0.sample_actions`` eagerly. ``PolicyRecorder`` writes each request and
reply to a ``.npy`` file. Batched inference (``infer_batch``, the batching
server) and the RTC kwargs are not ported.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
import logging
import pathlib
import threading
import time
from typing import Any

import numpy as np
import torch

from kai0_tpu_torch import transforms as _transforms
from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.policies import graphs as _graphs
from kai0_tpu_torch.transforms import _map_structure

logger = logging.getLogger("kai0_tpu_torch")

Transform = Callable[[dict], dict]


def _model_array(x) -> np.ndarray:
    """A leaf as the JAX package stages it (``jnp.asarray`` without x64): float64 → float32, int64 → int32."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        return x.astype(np.float32)
    if x.dtype == np.int64:
        return x.astype(np.int32)
    return x


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
        metadata: dict[str, Any] | None = None,
        prompt_buckets: Sequence[int] | None = None,
    ):
        self._model = model
        self._config = config
        self._device = torch.device(device)
        self._generator = generator
        self._input_transform = _transforms.compose(transforms)
        self._output_transform = _transforms.compose(output_transforms)
        self._metadata = metadata or {}
        # Trimming trailing prompt padding to a bucket leaves the actions as they are (positions are
        # cumsum(mask) - 1 and padding is masked out) and shortens the prefill from 968 rows to 768 + bucket.
        self._prompt_buckets = tuple(sorted(prompt_buckets)) if prompt_buckets else None
        self._graphs: dict[tuple, _graphs.SampleGraph] = {}
        self._graph_lock = threading.RLock()  # held by graph_for and by infer's stage → replay → fetch

    @property
    def model(self):
        return self._model

    @property
    def model_config(self):
        return self._config

    @property
    def metadata(self) -> dict[str, Any]:
        return self._metadata

    @property
    def graphs(self) -> dict[tuple, _graphs.SampleGraph]:
        """The captured sampler graphs by ``SampleGraph.key`` (empty on the CPU)."""
        return self._graphs

    def graph_for(self, inputs: dict) -> _graphs.SampleGraph:
        """The graph for batched staged ``inputs``, captured on first use."""
        key = _graphs.signature(inputs)
        with self._graph_lock:
            if key not in self._graphs:
                graph = _graphs.SampleGraph(self._model, inputs)
                self._graphs[graph.key] = graph
                logger.info(f"Captured the sampler for {dict((p, s) for p, s, _ in key)} in {graph.capture_seconds:.1f}s")
            return self._graphs[key]

    def stage_inputs(self, obs: dict) -> dict:
        """The observation through the input transforms and the prompt bucket, batched: what the sampler takes."""
        inputs = _map_structure(lambda x: x, obs)  # copy: transforms may modify inputs in place
        inputs = self._input_transform(inputs)
        if self._prompt_buckets and "tokenized_prompt" in inputs and "token_ar_mask" not in inputs:
            inputs = _trim_prompt_to_bucket(inputs, self._prompt_buckets)
        return _map_structure(lambda x: _model_array(x)[np.newaxis], inputs)

    def infer(self, obs: dict, *, noise: np.ndarray | None = None) -> dict:
        t_start = time.monotonic()
        inputs = self.stage_inputs(obs)
        t_staged = time.monotonic()
        if noise is not None:
            noise = np.asarray(noise, dtype=np.float32)
            if noise.ndim == 2:
                noise = noise[None]
        if self._device.type == "cuda":
            with self._graph_lock:
                graph = self.graph_for(inputs)
                if noise is None:
                    noise = torch.randn(graph.noise_shape, generator=self._generator, dtype=torch.float32,
                                        device=self._device)
                graph.stage(inputs, noise)
                torch.cuda.current_stream(self._device).synchronize()  # staging is not model time
                start_time = time.monotonic()
                graph.replay()
                actions = graph.fetch()
        else:
            batched = _map_structure(lambda x: torch.from_numpy(np.array(x)).to(self._device), inputs)
            observation = _model.Observation.from_dict(batched)
            start_time = time.monotonic()
            if noise is not None:
                noise = torch.from_numpy(noise).to(self._device)
            actions = self._model.sample_actions(observation, noise=noise, generator=self._generator).numpy()
        t_fetched = time.monotonic()
        outputs = {"state": inputs["state"][0], "actions": actions[0]}

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

    def warmup(self, example: dict | None = None) -> float:
        """Capture the sampler at batch 1 for every prompt bucket and the full prompt length (from the model config's
        ``fake_obs``), then serve ``example`` through the whole chain; returns the seconds taken. Captures nothing
        on the CPU."""
        start = time.monotonic()
        if self._device.type == "cuda":
            fake = self._config.fake_obs(1)
            full = fake["tokenized_prompt"].shape[-1]
            for length in sorted({b for b in self._prompt_buckets or () if b < full} | {full}):
                self.graph_for({**fake, "tokenized_prompt": fake["tokenized_prompt"][:, :length],
                                "tokenized_prompt_mask": fake["tokenized_prompt_mask"][:, :length]})
        if example is not None:
            self.infer(example)
        elapsed = time.monotonic() - start
        logger.info(f"Policy warmup took {elapsed:.1f}s")
        return elapsed


def _used_prompt_len(inputs: dict) -> int:
    """Number of leading valid prompt tokens (the tokenizer right-pads)."""
    valid = np.flatnonzero(np.asarray(inputs["tokenized_prompt_mask"]))
    return int(valid[-1]) + 1 if valid.size else 0


def _trim_prompt_to_bucket(inputs: dict, buckets: tuple[int, ...]) -> dict:
    """Trim trailing prompt padding to the smallest bucket >= the used length (unbatched numpy dict)."""
    mask = np.asarray(inputs["tokenized_prompt_mask"])
    full = mask.shape[-1]
    bucket = next((b for b in buckets if b >= _used_prompt_len(inputs)), full)
    if bucket < full:
        inputs = dict(inputs)
        inputs["tokenized_prompt"] = np.asarray(inputs["tokenized_prompt"])[..., :bucket]
        inputs["tokenized_prompt_mask"] = mask[..., :bucket]
    return inputs


class PolicyRecorder:
    """Records the observations and outputs of a wrapped policy to ``.npy`` files (``kai0_tpu/policies/policy.py``)."""

    def __init__(self, policy, record_dir: str):
        self._policy = policy
        self._record_dir = pathlib.Path(record_dir)
        self._record_dir.mkdir(parents=True, exist_ok=True)
        self._record_step = 0
        logger.info(f"Dumping policy records to: {self._record_dir}")

    @property
    def metadata(self) -> dict:
        return getattr(self._policy, "metadata", {})

    def infer(self, obs: dict) -> dict:
        results = self._policy.infer(obs)
        data = _transforms.flatten_dict({"inputs": obs, "outputs": results})
        output_path = self._record_dir / f"step_{self._record_step}"
        self._record_step += 1
        np.save(output_path, np.asarray(data, dtype=object))
        return results

    def reset(self) -> None:
        self._policy.reset()
