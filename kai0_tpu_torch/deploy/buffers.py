"""Action-chunk buffers for latency-compensated deployment.

The port's copy of ``kai0_tpu/deploy/buffers.py``: pure-NumPy, thread-safe
cores of the reference ROS clients, and the semantics the C++ buffers of
``deploy/native_buffers.py`` are held to.

- ``StreamActionBuffer``: temporal smoothing. On each new chunk, trim the first
  ``min(k, max_k)`` steps for inference latency, then crossfade the old chunk
  into the new over their overlap (w_old 1 → 0)
  (``agilex_inference_openpi_rtc.py:167-287``).
- ``TemporalEnsemblingBuffer``: ACT-style aggregation. Every chunk's prediction
  is kept per absolute timestep and aggregated with weights ``exp(−m·i)`` over
  chunk age (``agilex_inference_openpi_temporal_ensembling.py:56-146``).
- ``DelayEstimator`` and ``rtc_align_chunks``: the inference delay in action
  steps from the median round trip, and the split of each new chunk into the
  actions to execute and the previous chunk of the next round
  (``agilex_inference_openpi_rtc.py:517-527,567-590``).
"""

from __future__ import annotations

import collections
import threading

import numpy as np


class StreamActionBuffer:
    """Single-consumer action queue with latency trim + crossfade smoothing."""

    def __init__(self, *, smooth_method: str = "temporal"):
        self._lock = threading.Lock()
        self._cur: collections.deque[np.ndarray] = collections.deque()
        self._smooth = smooth_method.lower()
        # Steps popped since the last chunk integration (= how stale a new chunk is).
        self.k = 0
        self._last_action: np.ndarray | None = None

    def integrate_new_chunk(self, actions_chunk: np.ndarray, max_k: int, min_m: int = 8) -> None:
        """Integrate a freshly inferred chunk.

        1. Trim the front by ``min(k, max_k)`` steps (actions already executed while
           inference ran).
        2. Crossfade the remaining old chunk into the new one over their overlap
           (weight on the old chunk decays linearly 1→0).
        3. Reset the staleness counter.
        """
        with self._lock:
            if actions_chunk is None or len(actions_chunk) == 0:
                return
            drop_n = min(self.k, max(0, int(max_k)))
            if drop_n >= len(actions_chunk):
                return
            new_list = [np.asarray(a, dtype=float).copy() for a in actions_chunk[drop_n:]]

            if self._smooth == "raw":
                self._cur = collections.deque(new_list)
                self.k = 0
                return

            min_m = max(1, int(min_m))
            if not self._cur and self._last_action is not None:
                # Bridge from the last executed action so the crossfade has an anchor.
                old_list = [self._last_action.copy() for _ in range(min_m)]
                self._last_action = None
            else:
                old_list = list(self._cur)
                if old_list and len(old_list) < min_m:
                    tail = old_list[-1].copy()
                    old_list += [tail.copy() for _ in range(min_m - len(old_list))]
                elif not old_list:
                    self._cur = collections.deque(new_list)
                    self.k = 0
                    return

            overlap = min(len(old_list), len(new_list))
            w_old = np.array([1.0]) if overlap == 1 else np.linspace(1.0, 0.0, overlap)
            smoothed = [
                w_old[i] * old_list[i] + (1.0 - w_old[i]) * new_list[i] for i in range(overlap)
            ]
            self._cur = collections.deque(smoothed + new_list[overlap:])
            self.k = 0

    def has_any(self) -> bool:
        with self._lock:
            return bool(self._cur)

    def __len__(self) -> int:
        with self._lock:
            return len(self._cur)

    def pop_next_action(self) -> np.ndarray | None:
        """Pop the next action to publish (None when drained); increments staleness."""
        with self._lock:
            if not self._cur:
                return None
            if len(self._cur) == 1:
                self._last_action = np.asarray(self._cur[0], dtype=float).copy()
            self.k += 1
            return np.asarray(self._cur.popleft(), dtype=float)


class TemporalEnsemblingBuffer:
    """ACT-style temporal ensembling over overlapping action chunks.

    Predictions are stored per absolute timestep; ``get_action(t)`` averages every
    chunk's prediction for ``t`` with weights ``exp(−m·i)`` (i = chunk age order,
    oldest first), so older chunks dominate for small m and new observations take
    over as m grows.
    """

    def __init__(self, *, chunk_size: int = 50, exp_weight_m: float = 0.01, cleanup_lag: int = 10):
        self.chunk_size = chunk_size
        self.exp_weight_m = exp_weight_m
        self._cleanup_lag = cleanup_lag
        self._lock = threading.Lock()
        self._predictions: dict[int, list[tuple[int, np.ndarray]]] = {}
        self.current_t = 0
        self._inference_count = 0
        self._last_action: np.ndarray | None = None

    def add_chunk(self, actions_chunk: np.ndarray, start_timestep: int | None = None) -> None:
        with self._lock:
            if actions_chunk is None or len(actions_chunk) == 0:
                return
            start = self.current_t if start_timestep is None else start_timestep
            idx = self._inference_count
            self._inference_count += 1
            for i, action in enumerate(np.asarray(actions_chunk)):
                t = start + i
                if t < 0:
                    continue
                self._predictions.setdefault(t, []).append((idx, np.array(action, dtype=float)))
            # Drop timesteps that are far behind the execution cursor.
            threshold = max(0, self.current_t - self._cleanup_lag)
            for t in [t for t in self._predictions if t < threshold]:
                del self._predictions[t]

    def get_action(self, timestep: int | None = None) -> np.ndarray | None:
        """Aggregated action for ``timestep`` (default: current cursor)."""
        with self._lock:
            t = self.current_t if timestep is None else timestep
            preds = self._predictions.get(t)
            if not preds:
                return self._last_action
            if len(preds) == 1:
                self._last_action = preds[0][1].copy()
                return self._last_action.copy()
            preds = sorted(preds, key=lambda p: p[0])
            actions = np.stack([p[1] for p in preds])
            w = np.exp(-self.exp_weight_m * np.arange(len(preds)))
            w /= w.sum()
            self._last_action = (actions * w[:, None]).sum(axis=0)
            return self._last_action.copy()

    def step(self) -> np.ndarray | None:
        """Get the action at the cursor and advance it (the publish-loop call)."""
        action = self.get_action()
        with self._lock:
            self.current_t += 1
        return action


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
