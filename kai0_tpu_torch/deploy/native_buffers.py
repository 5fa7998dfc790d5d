"""Python wrappers over the C++ action buffers (``kai0_tpu_torch/native``).

The port's copy of ``kai0_tpu/deploy/native_buffers.py``, with the API of
``deploy/buffers.py``: the C++ core releases the GIL around its lock and math,
so a slow Python inference thread never stalls the 25-30 Hz publish loop.
Building them raises when the C++ extension cannot be built or
``KAI0_DISABLE_NATIVE`` is set (``native.load``); ``deploy.make_stream_buffer``
and ``make_ensembling_buffer`` choose between these and the Python buffers.
"""

from __future__ import annotations

import numpy as np


def _to_f64_matrix(chunk) -> np.ndarray:
    chunk = np.ascontiguousarray(np.asarray(chunk, dtype=np.float64))
    if chunk.ndim != 2:
        raise ValueError(f"Expected [n, dim] chunk, got shape {chunk.shape}")
    return chunk


def _load(module):
    if module is not None:
        return module
    from kai0_tpu_torch import native

    return native.load()


class NativeStreamActionBuffer:
    """C++-backed crossfade smoothing buffer (API of ``buffers.StreamActionBuffer``)."""

    def __init__(self, *, smooth_method: str = "temporal", _module=None):
        self._impl = _load(_module).StreamActionBuffer(smooth_method)

    def integrate_new_chunk(self, actions_chunk, max_k: int, min_m: int = 8) -> None:
        if actions_chunk is None or len(actions_chunk) == 0:
            return
        self._impl.integrate_new_chunk(_to_f64_matrix(actions_chunk), int(max_k), int(min_m))

    def pop_next_action(self) -> np.ndarray | None:
        raw = self._impl.pop_next_action_bytes()
        return None if raw is None else np.frombuffer(raw, dtype=np.float64)

    def has_any(self) -> bool:
        return self._impl.size() > 0

    def __len__(self) -> int:
        return self._impl.size()

    @property
    def k(self) -> int:
        return self._impl.staleness()


class NativeTemporalEnsemblingBuffer:
    """C++-backed ACT ensembling buffer (API of ``buffers.TemporalEnsemblingBuffer``)."""

    def __init__(self, *, chunk_size: int = 50, exp_weight_m: float = 0.01, cleanup_lag: int = 10,
                 _module=None):
        self.chunk_size = chunk_size
        self.exp_weight_m = exp_weight_m
        self._impl = _load(_module).TemporalEnsembleBuffer(float(exp_weight_m), int(cleanup_lag))

    def add_chunk(self, actions_chunk, start_timestep: int | None = None) -> None:
        if actions_chunk is None or len(actions_chunk) == 0:
            return
        self._impl.add_chunk(_to_f64_matrix(actions_chunk), start_timestep)

    def get_action(self, timestep: int | None = None) -> np.ndarray | None:
        raw = self._impl.get_action_bytes(timestep)
        return None if raw is None else np.frombuffer(raw, dtype=np.float64)

    def step(self) -> np.ndarray | None:
        raw = self._impl.step_bytes()
        return None if raw is None else np.frombuffer(raw, dtype=np.float64)

    @property
    def current_t(self) -> int:
        return self._impl.cursor()
