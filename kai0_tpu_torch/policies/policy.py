"""Policy runtime: transform chains around the sampler of π₀, π₀.₅ or π₀-FAST.

Counterpart of ``kai0_tpu/policies/policy.py``: ``infer`` copies the
observation, applies the input transforms on the host, trims the prompt's
padding to the smallest prompt bucket that holds it, adds a batch axis (in
JAX's input dtypes: f32 and int32), samples one action chunk, takes it back to
numpy, applies the output transforms and reports ``policy_timing``
(``infer_ms``: the model call with the fetch; ``transform_ms``: the host
transforms; ``stage_ms``: host → device staging, with any wait for another
thread's request).

On CUDA the flow sampler (π₀, π₀.₅ and their RTC variants) always runs as a
captured CUDA graph (``graphs.py``), one per shape of the staged inputs: a
bucket's graph is captured on the first request that needs it, or by
``warmup``. π₀-FAST's sampler is chosen eager by its model type: its decode
loop ends when every row has emitted EOS, which the host reads each step, so
there is no one graph of it to capture. Prompt buckets apply to the flow
models only (a FAST prompt carries ``token_ar_mask``), as in JAX.
``sample_kwargs`` go to every eager sampler call (π₀-FAST's
``max_decoding_steps``, ``temperature``; on the CPU any key, as JAX passes
them). A flow model takes JAX's static ones only (``graphs.STATIC_SAMPLE_KWARGS``:
``num_steps``, and for an RTC model ``prefix_attention_schedule`` and
``max_guidance_weight``); any other key raises ``TypeError`` naming it, as
JAX's sampler does. On CUDA they are part of each graph's key and run at
capture (``num_steps`` Euler steps, ``graphs.NUM_STEPS`` when absent), as
JAX's jit compiles one program for each. A graph's buffers serve one request
at a time: a lock serializes capture, staging, replay and fetch, so requests
from several threads (the server's executor) each get their own actions; the
host transforms run outside it. Tensors on the CPU run
``Pi0.sample_actions`` eagerly. ``PolicyRecorder`` writes each request and
reply to a ``.npy`` file.

RTC: ``prev_action_chunk``, ``inference_delay`` and ``execute_horizon`` pass
from the raw request, in its units, to the RTC sampler, as JAX's ``infer``
passes them (``kai0_tpu/policies/policy.py:103-106``); a model that is not
RTC raises ``TypeError`` on them, as JAX's ``sample_actions`` does. On CUDA a
request with a chunk replays the RTC graph of its chunk's shape, with the
delay and the horizon staged as data. ``infer_batch`` samples several
observations in one batch (one graph for each padded batch size); it takes
no RTC keys (the batching server serves those alone).
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
from kai0_tpu_torch.models import pi0_rtc as _pi0_rtc
from kai0_tpu_torch.policies import graphs as _graphs
from kai0_tpu_torch.transforms import _map_structure, flatten_dict, unflatten_dict

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
        sample_kwargs: dict[str, Any] | None = None,
    ):
        self._model = model
        self._config = config
        self._device = torch.device(device)
        self._graphed = self._device.type == "cuda" and config.model_type != _model.ModelType.PI0_FAST
        self._sample_kwargs = dict(sample_kwargs or {})
        if self._graphed:
            accepted = _graphs.STATIC_SAMPLE_KWARGS if isinstance(model, _pi0_rtc.Pi0RTC) else ("num_steps",)
            unknown = sorted(set(self._sample_kwargs) - set(accepted))
            if unknown:
                raise TypeError(f"sample_actions() of {type(model).__name__} got unexpected keyword arguments {unknown}: "
                                f"its graphed sampler takes {accepted}")
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

    def graph_for(self, inputs: dict, chunk: tuple[int, int] | None = None) -> _graphs.SampleGraph:
        """The graph for batched staged ``inputs`` (and an RTC chunk's (length, provided_dim)) at the policy's
        ``sample_kwargs``, captured on first use."""
        key = _graphs.signature(inputs, chunk, self._sample_kwargs)
        with self._graph_lock:
            if key not in self._graphs:
                graph = _graphs.SampleGraph(self._model, inputs, chunk, self._sample_kwargs)
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

    def _rtc_kwargs(self, obs: dict) -> dict:
        """The request's RTC keys, as JAX's ``infer`` passes them to ``sample_actions``."""
        rtc = {key: obs[key] for key in _pi0_rtc.RTC_KEYS if key in obs}
        if rtc and not isinstance(self._model, _pi0_rtc.Pi0RTC):
            raise TypeError(f"sample_actions() of {type(self._model).__name__} got unexpected keyword arguments "
                            f"{sorted(rtc)}: only an RTC model takes them")
        return rtc

    def _sample(self, inputs: dict, noise: np.ndarray | None, rtc: dict) -> tuple[float, np.ndarray]:
        """Sample batched staged ``inputs`` (a graph replay on CUDA, eagerly on the CPU); returns the model call's start
        time (after staging) and the actions [B, H, D]. ``rtc``: the request's RTC keys."""
        if self._graphed:
            guidance = chunk_key = None  # a guided request stages its chunk and its (delay, horizon)
            if rtc.get("prev_action_chunk") is not None:
                chunk, provided_dim, scalars = _pi0_rtc.rtc_inputs(
                    rtc["prev_action_chunk"], rtc.get("inference_delay"), rtc.get("execute_horizon"),
                    self._config.action_horizon, self._config.action_dim)
                guidance, chunk_key = (chunk, scalars), (chunk.shape[1], provided_dim)
            with self._graph_lock:
                graph = self.graph_for(inputs, chunk_key)
                if noise is None:
                    noise = torch.randn(graph.noise_shape, generator=self._generator, dtype=torch.float32,
                                        device=self._device)
                graph.stage(inputs, noise, guidance)
                torch.cuda.current_stream(self._device).synchronize()  # staging is not model time
                start_time = time.monotonic()
                graph.replay()
                return start_time, graph.fetch()
        batched = _map_structure(lambda x: torch.from_numpy(np.array(x)).to(self._device), inputs)
        observation = _model.Observation.from_dict(batched)
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()  # staging is not model time
        start_time = time.monotonic()
        kwargs = {**self._sample_kwargs, **rtc}
        if noise is not None:  # a FAST model takes none and raises, as JAX's sample_actions does
            kwargs["noise"] = torch.from_numpy(np.ascontiguousarray(noise)).to(self._device)
        actions = self._model.sample_actions(observation, generator=self._generator, **kwargs)
        return start_time, actions.cpu().numpy()

    def infer(self, obs: dict, *, noise: np.ndarray | None = None) -> dict:
        t_start = time.monotonic()
        inputs = self.stage_inputs(obs)
        t_staged = time.monotonic()
        rtc = self._rtc_kwargs(obs)
        if noise is not None:
            noise = np.asarray(noise, dtype=np.float32)
            if noise.ndim == 2:
                noise = noise[None]
        start_time, actions = self._sample(inputs, noise, rtc)
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

    def infer_batch(
        self, obs_list: Sequence[dict], *, noise: np.ndarray | None = None, pad_to: int | None = None
    ) -> list[dict]:
        """Sample several observations in one batch (``kai0_tpu/policies/policy.py:137-208``).

        The batch takes the largest prompt bucket any member needs; ``pad_to``
        pads it by repeating row 0 (padding rows are dropped), so that a few
        batch sizes, each one graph, serve any count. ``noise`` [H, D] is
        broadcast to every row, [n, H, D] padded with its row 0.
        ``policy_timing`` is ``{infer_ms, batch_size}``. RTC keys raise
        ``ValueError``: RTC requests are served alone.
        """
        if not obs_list:
            return []
        for obs in obs_list:
            for key in _pi0_rtc.RTC_KEYS:
                if key in obs:
                    raise ValueError(f"infer_batch does not support RTC kwarg {key!r}; dispatch solo")

        inputs_list = [self._input_transform(_map_structure(lambda x: x, obs)) for obs in obs_list]
        if self._prompt_buckets and all("tokenized_prompt" in i and "token_ar_mask" not in i for i in inputs_list):
            # One common bucket for the whole batch: the largest any member needs.
            used = max(_used_prompt_len(i) for i in inputs_list)
            inputs_list = [_trim_prompt_to_bucket(i, self._prompt_buckets, used) for i in inputs_list]
        n = len(inputs_list)
        m = max(pad_to, n) if pad_to else n
        flat = [flatten_dict(_map_structure(_model_array, i)) for i in inputs_list]
        batch = unflatten_dict({path: np.stack([f[path] for f in flat] + [flat[0][path]] * (m - n)) for path in flat[0]})
        if noise is not None:
            noise = np.asarray(noise, dtype=np.float32)
            if noise.ndim == 2:
                noise = np.broadcast_to(noise, (m, *noise.shape))
            elif noise.shape[0] != m:
                noise = np.concatenate([noise, np.broadcast_to(noise[:1], (m - noise.shape[0], *noise.shape[1:]))])

        start_time, actions = self._sample(batch, noise, {})
        model_time = time.monotonic() - start_time

        results = []
        for i in range(n):
            outputs = self._output_transform({"state": batch["state"][i], "actions": actions[i]})
            outputs["policy_timing"] = {"infer_ms": model_time * 1000, "batch_size": n}
            results.append(outputs)
        return results

    def reset(self) -> None:
        pass

    def warmup(self, example: dict | None = None) -> float:
        """Capture the sampler at batch 1 and the policy's ``sample_kwargs`` for every prompt bucket and the full
        prompt length (from the model config's ``fake_obs``), an RTC model's also guided by a chunk of
        ``action_horizon`` rows, then serve ``example``
        through the whole chain; returns the seconds taken. Captures nothing on the CPU or for a FAST model."""
        start = time.monotonic()
        if self._graphed:
            fake = self._config.fake_obs(1)
            full = fake["tokenized_prompt"].shape[-1]
            chunks = [None]
            if isinstance(self._model, _pi0_rtc.Pi0RTC):
                dim = self._config.action_dim
                chunks.append((self._config.action_horizon, min(_pi0_rtc.GUIDED_DIMS, dim)))
            for length in sorted({b for b in self._prompt_buckets or () if b < full} | {full}):
                for chunk in chunks:
                    self.graph_for({**fake, "tokenized_prompt": fake["tokenized_prompt"][:, :length],
                                    "tokenized_prompt_mask": fake["tokenized_prompt_mask"][:, :length]}, chunk)
        if example is not None:
            self.infer(example)
        elapsed = time.monotonic() - start
        logger.info(f"Policy warmup took {elapsed:.1f}s")
        return elapsed


def _used_prompt_len(inputs: dict) -> int:
    """Number of leading valid prompt tokens (the tokenizer right-pads)."""
    valid = np.flatnonzero(np.asarray(inputs["tokenized_prompt_mask"]))
    return int(valid[-1]) + 1 if valid.size else 0


def _trim_prompt_to_bucket(inputs: dict, buckets: tuple[int, ...], used: int | None = None) -> dict:
    """Trim trailing prompt padding to the smallest bucket >= the used length (unbatched numpy dict); ``used``
    defaults to this prompt's own."""
    mask = np.asarray(inputs["tokenized_prompt_mask"])
    full = mask.shape[-1]
    used = _used_prompt_len(inputs) if used is None else used
    bucket = next((b for b in buckets if b >= used), full)
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
