"""Request coalescing for serving several robots from one card.

Counterpart of ``kai0_tpu/serving/batching.py``. A batch-1 request streams
every weight of the 3B model for one chunk of actions; a batch of B streams
them once for B chunks. ``BatchingPolicy`` funnels concurrent ``infer`` calls
(the websocket server runs each request on an executor thread) into a queue
drained by one dispatcher thread, which runs ``Policy.infer_batch`` over
whatever is pending, up to ``max_batch``. Batch sizes are padded up to powers
of two, so at most ``log2(max_batch) + 1`` CUDA graphs serve every count.

Requests with RTC keys (``prev_action_chunk``, ...) bypass the batcher and run
alone: their guidance is per client and ``infer_batch`` rejects them.

``warmup`` captures each batch size's graph and raises if one fails (the JAX
package logs and goes on): a capture that failed there would fail again on a
robot's request.
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue
import threading
import time
from typing import Any

from kai0_tpu_torch.models.pi0_rtc import RTC_KEYS

logger = logging.getLogger("kai0_tpu_torch")


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class BatchingPolicy:
    """Wrap a ``Policy`` so that concurrent ``infer`` calls share one device batch.

    ``wait_ms`` holds the first request of a batch that long, so that requests
    arriving within the window join it; 0 (the default) takes only what is
    already queued and adds no latency.
    """

    def __init__(self, policy, max_batch: int, *, wait_ms: float = 0.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._policy = policy
        self._max_batch = max_batch
        self._wait_s = wait_ms / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self.batch_sizes: list[int] = []  # the dispatch log: requests per dispatch
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True, name="kai0-batcher")
        self._thread.start()

    @property
    def metadata(self) -> dict[str, Any]:
        return getattr(self._policy, "metadata", {})

    @property
    def model_config(self):
        return self._policy.model_config

    def infer(self, obs: dict) -> dict:
        if any(key in obs for key in RTC_KEYS):
            return self._policy.infer(obs)
        future: concurrent.futures.Future = concurrent.futures.Future()
        self._queue.put((obs, future))
        return future.result()

    def reset(self) -> None:
        self._policy.reset()

    def warmup(self, example: dict | None = None) -> float:
        """Warm the wrapped policy, then capture every padded batch size's graph on ``example``."""
        start = time.monotonic()
        self._policy.warmup(example)
        if example is not None:
            size = 2
            while size <= self._max_batch:
                self._policy.infer_batch([example] * 2, pad_to=size)
                size *= 2
        return time.monotonic() - start

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=5)

    def _dispatch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            group = [item]
            if self._wait_s:
                time.sleep(self._wait_s)
            while len(group) < self._max_batch:
                try:
                    extra = self._queue.get_nowait()
                except queue.Empty:
                    break
                if extra is None:
                    self._finish(group)
                    return
                group.append(extra)
            self._finish(group)

    def _finish(self, group: list) -> None:
        self.batch_sizes.append(len(group))
        try:
            if len(group) == 1:
                results = [self._policy.infer(group[0][0])]
            else:
                results = self._policy.infer_batch(
                    [obs for obs, _ in group], pad_to=_bucket(len(group), self._max_batch)
                )
            for (_, future), result in zip(group, results, strict=True):
                future.set_result(result)
        except Exception as e:  # noqa: BLE001 — a boundary: every waiting client gets the error
            for _, future in group:
                if not future.done():
                    future.set_exception(e)
