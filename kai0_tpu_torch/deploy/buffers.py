"""The real-time-chunking helpers of the deployment buffers.

The port's copy of ``DelayEstimator`` and ``rtc_align_chunks`` from
``kai0_tpu/deploy/buffers.py:163-203`` (reference
``agilex_inference_openpi_rtc.py:517-527,567-590``): the inference delay in
action steps from the median round trip, and the split of each new chunk into
the actions to execute and the previous chunk of the next round.
"""

from __future__ import annotations

import collections

import numpy as np


class DelayEstimator:
    """Median inference RTT × publish rate → predicted delay in action steps."""

    def __init__(self, publish_rate: float, maxlen: int = 20):
        self.publish_rate = float(publish_rate)
        self._rtts: collections.deque[float] = collections.deque(maxlen=maxlen)
        self.delay_steps = 0

    def update(self, rtt_sec: float) -> int:
        if rtt_sec is not None and np.isfinite(rtt_sec):
            self._rtts.append(float(rtt_sec))
        if self._rtts:
            median = float(np.median(np.asarray(self._rtts)))
            self.delay_steps = int(max(0, round(median * self.publish_rate)))
        return self.delay_steps


def rtc_align_chunks(
    prev_chunk: np.ndarray, next_chunk: np.ndarray, delay_steps: int, execute_horizon: int
) -> tuple[np.ndarray, np.ndarray]:
    """Real-time-chunking execution alignment.

    Returns ``(actions_to_execute [execute_horizon, D], shifted_chunk [chunk, D])``:
    the first ``delay_steps`` actions come from the previous chunk (they were already
    committed while inference ran), the rest from the new chunk; the new chunk is
    then shifted by ``execute_horizon`` (zero-padded) to serve as the next round's
    ``prev_action_chunk``.
    """
    prev_chunk = np.asarray(prev_chunk, dtype=float)
    next_chunk = np.asarray(next_chunk, dtype=float)
    delay_steps = max(0, int(delay_steps))
    execute_horizon = max(1, int(execute_horizon))
    chunk_size = prev_chunk.shape[0]
    if next_chunk.shape[0] != chunk_size:
        raise ValueError(f"Chunk size mismatch: {prev_chunk.shape} vs {next_chunk.shape}")
    d = min(delay_steps, execute_horizon, chunk_size)
    s = min(execute_horizon, chunk_size)
    actions_to_execute = np.concatenate([prev_chunk[:d], next_chunk[d:s]], axis=0)
    pad = np.zeros((s, next_chunk.shape[1]), dtype=float)
    shifted = np.concatenate([next_chunk[s:], pad], axis=0)
    return actions_to_execute, shifted
