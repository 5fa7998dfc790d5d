"""The sampler as a CUDA graph: the port's counterpart of ``jax.jit(sample)`` (``kai0_tpu/policies/policy.py:76-79``).

A ``SampleGraph`` holds one captured ``model.denoise`` (``Pi0.denoise``, or
``Pi0RTC.denoise`` for an RTC model) for one shape of the staged inputs
(batch, prompt length, image sizes), one set of the sampler's static keyword
arguments (``STATIC_SAMPLE_KWARGS``: JAX's ``Policy`` compiles one program for
each, ``kai0_tpu/policies/policy.py:38,79``) and, for an RTC request with a
previous chunk, one shape of that chunk (its length and guided dims): the
uint8 → [-1, 1] map of the images, preprocessing, SigLIP, the prefix pass with
its KV cache and every Euler step, from the staged inputs to x_0. One graph,
not a prefix graph and a step graph replayed ``num_steps`` times (``NUM_STEPS``
unless the kwargs say otherwise): the times are a device tensor fixed by the
step count at capture (``Pi0.time_grid``), so nothing the host supplies changes
between steps, and one replay is one host call. Two step counts are two graphs,
each with its own buffers.

Inputs live in static device buffers, filled from pinned host buffers by
asynchronous copies; the noise is drawn outside the graph (from the policy's
generator) or copied in, into its own buffer, and x_0 leaves through a pinned
buffer. An RTC graph also stages the chunk and the delay and horizon, so
one graph serves every delay and horizon; its capture holds the
``torch.autograd.grad`` of each guided step, whose backward kernels run on
the capturing stream. Capture: the work runs once eagerly on a side stream first, as
``torch.cuda.graph`` requires (it loads the kernels' library, makes cuBLAS's
handles and the kernels' cached workspaces, which must not be made inside a
capture), then ``torch.cuda.graph`` captures it on that same stream, which
every graph on the device shares. A capture that fails raises:
on CUDA there is no return to the eager loop.

The kernel wrappers count a launch when Python calls them, so a capture counts
the kernels of one request and a replay counts none: ``capture_launches``
keeps the capture's counts.

A graph's buffers are shared by every request that replays it: ``Policy`` holds
a lock around staging, replay and fetch, and around a capture.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.transforms import _map_structure, flatten_dict, unflatten_dict

NUM_STEPS = 10  # Euler steps of a request without ``num_steps``: Pi0.sample_actions' default
# The sampler's keyword arguments that fix the captured work (JAX: jit's static_argnames, policy.py:38).
STATIC_SAMPLE_KWARGS = ("num_steps", "prefix_attention_schedule", "max_guidance_weight")


def launch_counts() -> dict[str, int]:
    """The launch counters of the kernels the sampler runs (attention, and K5 / K4 of int8 serving)."""
    from kai0_tpu_torch.ops import flash_attention, int8_matmul, row_quant

    return {**flash_attention.LAUNCHES, **row_quant.LAUNCHES, **int8_matmul.LAUNCHES}


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of the eager runs and captures on ``device``: cuBLAS keeps a workspace for every stream
    it has run on (tens of MiB each), which a new stream for each graph would add up."""
    return torch.cuda.Stream(device)


def signature(inputs: dict, chunk: tuple[int, int] | None = None, sample_kwargs: dict | None = None) -> tuple:
    """What a graph is captured for: the path, shape and dtype of every staged input, in path order, the static
    sample kwargs when there are any, and an RTC request's chunk (its length and ``provided_dim``) when it has one
    (always the last entry)."""
    key = tuple(sorted((path, tuple(x.shape), str(x.dtype)) for path, x in flatten_dict(inputs).items()))
    if sample_kwargs:
        key = (*key, ("sample_kwargs", tuple(sorted(sample_kwargs.items())), "static"))
    return key if chunk is None else (*key, ("prev_action_chunk", chunk, "rtc"))


class SampleGraph:
    """``model.denoise`` captured for inputs shaped like ``inputs`` (batched numpy, as ``Policy`` stages them).

    ``chunk`` = (length, provided_dim) captures the RTC sampler guided by a previous chunk of that shape;
    ``sample_kwargs`` (names of ``STATIC_SAMPLE_KWARGS``) are the step count and the RTC sampler's schedule and
    guidance cap that the capture runs with.
    """

    def __init__(self, model, inputs: dict, chunk: tuple[int, int] | None = None, sample_kwargs: dict | None = None):
        start = time.monotonic()
        self._model = model
        self.device = model.device
        statics = dict(sample_kwargs or {})
        self.key = signature(inputs, chunk, statics)
        self.num_steps = int(statics.pop("num_steps", NUM_STEPS))
        self._denoise_kwargs = statics  # the RTC sampler's schedule and guidance cap
        self._host = flatten_dict(_map_structure(lambda x: torch.from_numpy(np.ascontiguousarray(x)).pin_memory(), inputs))
        self._static = {path: torch.empty_like(x, device=self.device) for path, x in self._host.items()}
        batch = next(iter(self._host.values())).shape[0]
        shape = (batch, model.config.action_horizon, model.config.action_dim)
        self._noise = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._noise_host = torch.empty(shape, dtype=torch.float32).pin_memory()
        self._out_host = torch.empty(shape, dtype=torch.float32).pin_memory()
        self._times = model.time_grid(self.num_steps)
        self._chunk = None
        if chunk is not None:
            length, self._provided_dim = chunk
            self._chunk = torch.zeros((1, length, model.config.action_dim), dtype=torch.float32, device=self.device)
            self._chunk_host = torch.empty(self._chunk.shape, dtype=torch.float32).pin_memory()
            self._scalars = torch.zeros(2, dtype=torch.float32, device=self.device)  # the delay and the horizon
            self._scalars_host = torch.empty(2, dtype=torch.float32).pin_memory()
        self.stage(inputs)

        stream, side = torch.cuda.current_stream(self.device), _capture_stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._run()
        stream.wait_stream(side)
        before = launch_counts()
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph, stream=side):
            self._out = self._run()
        self.capture_launches = {k: v - before[k] for k, v in launch_counts().items()}
        self.capture_seconds = time.monotonic() - start  # buffers, the eager run and the capture

    def _run(self) -> torch.Tensor:
        observation = _model.Observation.from_dict(unflatten_dict(self._static))
        if self._chunk is None:
            return self._model.denoise(observation, self._noise, self._times, **self._denoise_kwargs)
        return self._model.denoise(observation, self._noise, self._times, self._chunk, self._scalars[0],
                                   self._scalars[1], provided_dim=self._provided_dim, **self._denoise_kwargs)

    @property
    def noise_shape(self) -> tuple[int, ...]:
        return tuple(self._noise.shape)

    def stage(self, inputs: dict, noise: np.ndarray | torch.Tensor | None = None, rtc: tuple | None = None) -> None:
        """Copy a request into the static buffers through the pinned ones; ``noise`` a host array or a device tensor;
        ``rtc`` = (chunk, scalars) of ``pi0_rtc.rtc_inputs`` for a graph captured with a chunk (left as staged
        before when None)."""
        if rtc is not None and self._chunk is None:
            raise ValueError("this graph was captured without a previous action chunk")
        values = flatten_dict(inputs)
        if values.keys() != self._host.keys():
            raise ValueError(f"inputs {sorted(values)}, the graph was captured for {sorted(self._host)}")
        for path, host in self._host.items():
            host.numpy()[...] = values[path]
            self._static[path].copy_(host, non_blocking=True)
        if rtc is not None:
            chunk, scalars = rtc
            self._chunk_host.numpy()[...] = chunk
            self._scalars_host.numpy()[...] = scalars
            self._chunk.copy_(self._chunk_host, non_blocking=True)
            self._scalars.copy_(self._scalars_host, non_blocking=True)
        if isinstance(noise, torch.Tensor):
            self._noise.copy_(noise, non_blocking=True)
        elif noise is not None:
            self._noise_host.numpy()[...] = noise
            self._noise.copy_(self._noise_host, non_blocking=True)

    def replay(self) -> torch.Tensor:
        """Run the graph on the staged inputs; returns x_0 (a static device buffer, valid until the next replay)."""
        self._graph.replay()
        return self._out

    def fetch(self) -> np.ndarray:
        """x_0 of the last replay on the host; waits for the device."""
        self._out_host.copy_(self._out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._out_host.numpy().copy()
