"""RTC inference client: payload assembly and latency bookkeeping.

The port's copy of ``kai0_tpu/deploy/rtc_client.py``. Wraps any policy with an
``infer(obs) -> {"actions": ...}`` method (the websocket client or an
in-process ``Policy``) and keeps the real-time-chunking state:
``prev_action_chunk`` (shifted between rounds), the inference delay estimated
from observed round trips, and each round's execution slice.

Reference: ``agilex_inference_openpi_rtc.py`` ``_rtc_infer`` :530-564 (payload
assembly, action-dim padding of the previous chunk), ``_update_delay_buffer``
:517-527, and the chunk-alignment helper :567-590.
"""

from __future__ import annotations

import time

import numpy as np

from kai0_tpu_torch.deploy.buffers import DelayEstimator, rtc_align_chunks


class RTCClient:
    """Round-based RTC driver: call :meth:`infer_round` each inference cycle."""

    def __init__(
        self,
        policy,
        *,
        action_dim: int = 32,
        chunk_size: int = 50,
        execute_horizon: int = 25,
        publish_rate: float = 25.0,
        enable_rtc: bool = True,
        mask_prefix_delay: bool = False,
        max_guidance_weight: float = 5.0,
    ):
        self._policy = policy
        self.action_dim = action_dim
        self.chunk_size = chunk_size
        self.execute_horizon = execute_horizon
        self.enable_rtc = enable_rtc
        self.mask_prefix_delay = mask_prefix_delay
        self.max_guidance_weight = max_guidance_weight
        self.delay = DelayEstimator(publish_rate)
        self.prev_chunk: np.ndarray | None = None

    def _pad_prev_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """Pad/crop the executed-action chunk to the model action dim."""
        chunk = np.asarray(chunk, dtype=float)
        if chunk.shape[-1] < self.action_dim:
            pad = np.zeros((*chunk.shape[:-1], self.action_dim - chunk.shape[-1]), dtype=chunk.dtype)
            return np.concatenate([chunk, pad], axis=-1)
        return chunk[..., : self.action_dim]

    def make_payload(self, observation: dict) -> dict:
        payload = dict(observation)
        if self.prev_chunk is not None:
            payload["prev_action_chunk"] = self._pad_prev_chunk(self.prev_chunk)
        payload["inference_delay"] = int(max(0, self.delay.delay_steps))
        payload["execute_horizon"] = int(max(1, self.execute_horizon))
        payload["enable_rtc"] = bool(self.enable_rtc)
        payload["mask_prefix_delay"] = bool(self.mask_prefix_delay)
        payload["max_guidance_weight"] = float(self.max_guidance_weight)
        return payload

    def infer_round(self, observation: dict) -> np.ndarray:
        """One inference round: returns the actions to execute this cycle.

        Also updates the RTT-based delay estimate and the shifted previous chunk for
        the next round's guidance.
        """
        t0 = time.monotonic()
        result = self._policy.infer(self.make_payload(observation))
        self.delay.update(time.monotonic() - t0)

        next_chunk = np.asarray(result["actions"], dtype=float)
        if self.prev_chunk is None:
            # First round: execute the head of the chunk directly.
            s = min(self.execute_horizon, next_chunk.shape[0])
            to_execute = next_chunk[:s]
            pad = np.zeros((s, next_chunk.shape[1]))
            self.prev_chunk = np.concatenate([next_chunk[s:], pad], axis=0)
        else:
            prev = np.asarray(self.prev_chunk, dtype=float)[..., : next_chunk.shape[-1]]
            to_execute, self.prev_chunk = rtc_align_chunks(
                prev, next_chunk, self.delay.delay_steps, self.execute_horizon
            )
        return to_execute
