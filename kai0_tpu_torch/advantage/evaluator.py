"""Batched advantage evaluation over episode videos, on the card.

The port's counterpart of ``kai0_tpu/advantage/evaluator.py`` (reference
``stage_advantage/annotation/evaluator.py``, ``SimpleValueEvaluator``): it
loads a trained estimator's ``model.safetensors``, decodes the three camera
videos of an episode on a thread pool (``load_video_frames``: cv2, BGR →
RGB) and resizes each frame there, once, to 224×224 with pad
(``resize_with_pad_np``, the JAX evaluator's ``_prep_image``; JAX resizes a
frame again for every batch that reads it, which gives the same bytes), and
runs ``AdvantageEstimator.sample_values`` over fixed-size batches (the last
batch padded with its last row). Under ``KAI0_INT8_SB_GEMMA`` / ``KAI0_INT8_SB``
the estimator's products run by SwitchBack (``ops/quant.switchback_tree``), as
JAX's estimator reads those variables when it traces (the environment alone
decides: JAX applies no config's knobs here).

Two modes (reference :249-485 and :486+):

- ``evaluate_video_2timesteps_advantages`` (KAI0): per frame n,
  relative_advantage = value(history = frame n, current = frame n + K),
  absolute_value = value(history = frame 0, current = frame n) (0 for frame 0)
  and absolute_advantage = absolute_value[n + K] − absolute_value[n], each
  rescaled to the interval K where the episode's tail shortens it, and clipped
  to [−1, 1];
- ``evaluate_video_1timestep_advantage`` (PI06): the absolute value only.

The history frames (``*_-100_rgb``) are decoded, resized and staged as the JAX
evaluator does, and the model drops them (``preprocess_observation`` keeps the
three current cameras): the value reads frame n + K or n, and the prompt.

Draws: JAX uses one key, ``jax.random.key(0)``, for every batch, so a frame's
value depends on its row in the batch. The port draws the same way: the
noise and then the time come from a generator seeded 0 afresh for each
forward; ``draws=(noise [B, H, A], time [B])`` replaces them (the CPU tests
hand in JAX's). ``timing`` holds the last call's decode and resize seconds
and, per batch, in ms: the host's assembly of the 6 × B frames, the staging
of the batch on the device with its draws, and the forward (``sample_values``).
"""

from __future__ import annotations

import concurrent.futures
import logging
import pathlib
import time

import numpy as np
import torch

from kai0_tpu_torch import interop as _interop
from kai0_tpu_torch import knobs as _knobs
from kai0_tpu_torch.models import advantage as _advantage
from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.models import tokenizer as _tokenizer
from kai0_tpu_torch.ops import quant as _quant
from kai0_tpu_torch.shared import image_tools

logger = logging.getLogger("kai0_tpu_torch")

# Model image keys: the current frame (suffix _0) and the history / comparison frame (_-100).
_CURRENT_KEYS = ("base_0_rgb", "left_wrist_0_rgb", "right_wrist_0_rgb")
_HISTORY_KEYS = ("base_-100_rgb", "left_wrist_-100_rgb", "right_wrist_-100_rgb")


def load_video_frames(video_path: str | pathlib.Path, frame_interval: int = 1) -> list[np.ndarray]:
    """Decode an mp4 into RGB uint8 frames (every ``frame_interval``-th)."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise FileNotFoundError(f"Cannot open video {video_path}")
    frames = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % frame_interval == 0:
            frames.append(frame[..., ::-1].copy())  # BGR → RGB
        idx += 1
    cap.release()
    return frames


def _decode_and_resize(video_path, frame_interval: int, chunk: int = 64) -> np.ndarray:
    """``load_video_frames`` resized with pad to the model's resolution (``resize_with_pad_np``, as the JAX
    evaluator prepares each frame), ``chunk`` frames at a time."""
    frames = load_video_frames(video_path, frame_interval)
    h, w = _model.IMAGE_RESOLUTION
    out = np.empty((len(frames), h, w, 3), dtype=np.uint8)
    for i in range(0, len(frames), chunk):
        out[i : i + chunk] = image_tools.resize_with_pad_np(np.stack(frames[i : i + chunk]), h, w)
    return out


class SimpleValueEvaluator:
    """A trained estimator that evaluates per-frame advantages over an episode's videos."""

    def __init__(
        self,
        config_name,
        ckpt_dir: str | pathlib.Path,
        *,
        num_workers: int = 4,
        batch_size: int = 8,
        device="cuda",
        param_dtype: torch.dtype = torch.bfloat16,
        draws: tuple[np.ndarray, np.ndarray] | None = None,
    ):
        """``config_name``: a named config of ``training.config`` or a ``TrainConfig``; ``ckpt_dir`` holds the
        estimator's ``model.safetensors`` (loaded in ``param_dtype``, bf16 as the JAX evaluator loads it)."""
        from kai0_tpu_torch.training import config as _config

        self.config = _config.get_config(config_name) if isinstance(config_name, str) else config_name
        self.model_config = self.config.model
        if not isinstance(self.model_config, _advantage.AdvantageEstimatorConfig):
            raise ValueError(f"{self.config.name} is not an advantage estimator config")
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=num_workers)

        ckpt_dir = pathlib.Path(ckpt_dir)
        if not _interop.is_torch_checkpoint(ckpt_dir):
            raise FileNotFoundError(f"no {_interop.CHECKPOINT_FILE} under {ckpt_dir}: the port reads the estimator's "
                                    "torch checkpoint (kai0_tpu.interop.save_torch_checkpoint writes one)")
        model = _advantage.AdvantageEstimator(self.model_config, device=self.device, param_dtype=param_dtype)
        self.model = _interop.load_torch_checkpoint(model, ckpt_dir).requires_grad_(False).eval()
        knobs = _knobs.resolve()
        _quant.switchback_tree(self.model, gemma=knobs.int8_sb_gemma, siglip=knobs.int8_switchback,
                               weight_only=knobs.int8_weight_only)
        self.tokenizer = _tokenizer.PaligemmaTokenizer(self.model_config.max_token_len)
        self._draws = draws
        self.timing: dict = {}

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False)

    # ---------------------------------------------------------------- helpers

    def _load_videos(self, video_paths, frame_interval: int) -> list[np.ndarray]:
        """Each camera's frames decoded and resized to the model's resolution, one camera a pool thread:
        uint8 [frames, 224, 224, 3]. A frame is resized once, however many batches read it."""
        t = time.perf_counter()
        cams = [f.result() for f in [self._executor.submit(_decode_and_resize, p, frame_interval) for p in video_paths]]
        self.timing = {"decode_s": time.perf_counter() - t, "prep_ms": [], "stage_ms": [], "device_ms": []}
        return cams

    def _infer_values(self, history: list[np.ndarray], current: list[np.ndarray], tokens, token_masks):
        """One batch (per camera, the resized frames of its rows), padded to ``batch_size`` with its last row
        → np.float32[actual rows]."""
        t = time.perf_counter()
        actual = len(history[0])
        pad = self.batch_size - actual

        def stack(frames):
            if pad:
                frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)])
            return torch.from_numpy(np.ascontiguousarray(frames))

        images = {}
        for key, cam in zip(_HISTORY_KEYS, history):
            images[key] = stack(cam)
        for key, cam in zip(_CURRENT_KEYS, current):
            images[key] = stack(cam)
        self.timing["prep_ms"].append((time.perf_counter() - t) * 1000)

        t = time.perf_counter()
        dev = self.device
        obs = _model.Observation.from_dict({
            "image": {k: v.to(dev) for k, v in images.items()},
            "image_mask": {k: torch.ones(self.batch_size, dtype=torch.bool, device=dev) for k in images},
            "state": torch.zeros((self.batch_size, self.model_config.action_dim), dtype=torch.float32, device=dev),
            "tokenized_prompt": torch.from_numpy(np.tile(tokens[None], (self.batch_size, 1))).to(dev),
            "tokenized_prompt_mask": torch.from_numpy(np.tile(token_masks[None], (self.batch_size, 1))).to(dev),
        })
        if self._draws is None:  # one generator seeded 0 for every forward, as JAX's key(0) for every batch
            draws = {"generator": torch.Generator(device=dev).manual_seed(0)}
        else:
            draws = {k: torch.as_tensor(np.array(x), device=dev) for k, x in zip(("noise", "time"), self._draws)}
        self._sync()
        self.timing["stage_ms"].append((time.perf_counter() - t) * 1000)
        t = time.perf_counter()
        values = self.model.sample_values(obs, **draws)
        self._sync()
        self.timing["device_ms"].append((time.perf_counter() - t) * 1000)
        return values.float().cpu().numpy()[:actual, 0]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ modes

    def evaluate_video_2timesteps_advantages(
        self,
        video_paths,
        prompt: str,
        *,
        batch_size: int | None = None,
        frame_interval: int = 1,
        relative_interval: int = 50,
        min_frame_index: int | None = None,
        max_frame_index: int | None = None,
    ) -> list[dict]:
        """Relative and absolute advantage per frame (reference :249-485)."""
        if len(video_paths) != 3:
            raise ValueError("Expected 3 video paths: (top, left, right)")
        if batch_size is not None:
            self.batch_size = batch_size
        cams = self._load_videos(video_paths, frame_interval)
        n_frames = {len(c) for c in cams}
        if len(n_frames) != 1:
            raise ValueError(f"Inconsistent frame counts: {[len(c) for c in cams]}")

        lo = min_frame_index or 0
        hi = max_frame_index + 1 if max_frame_index is not None else None
        cams = [c[lo:hi] for c in cams]
        num_frames = len(cams[0])
        if num_frames < 2:
            raise ValueError(f"Insufficient frames: {num_frames}, need at least 2")
        max_idx = num_frames - 1

        tokens, token_masks = self.tokenizer.tokenize(prompt)
        results = []
        for start in range(0, num_frames, self.batch_size):
            idxs = list(range(start, min(start + self.batch_size, num_frames)))
            future_idxs = [min(j + relative_interval, max_idx) for j in idxs]
            # relative: history = frame n, current = frame n+K
            rel = self._infer_values([c[idxs] for c in cams], [c[future_idxs] for c in cams], tokens, token_masks)
            # absolute: history = frame 0, current = frame n
            absolute = self._infer_values([c[[0] * len(idxs)] for c in cams], [c[idxs] for c in cams], tokens,
                                          token_masks)
            for k, (j, f) in enumerate(zip(idxs, future_idxs)):
                # Rescale the relative advantage where the tail shortens the interval.
                if f == j:
                    rel_val = 0.0
                elif f - j == relative_interval:
                    rel_val = float(rel[k])
                else:
                    rel_val = float(rel[k]) / (f - j) * relative_interval
                results.append({
                    "frame_idx": j,
                    "future_frame_idx": f,
                    "relative_advantage": rel_val,
                    "absolute_value": 0.0 if j == 0 else float(absolute[k]),
                })

        # absolute_advantage = Δ absolute_value over the (interval-normalized) lookahead.
        by_idx = {r["frame_idx"]: r for r in results}
        for r in results:
            j, f = r["frame_idx"], r["future_frame_idx"]
            if f == j:
                adv = 0.0
            else:
                adv = by_idx[f]["absolute_value"] - r["absolute_value"]
                if f - j != relative_interval:
                    adv = adv / (f - j) * relative_interval
            r["absolute_advantage"] = float(np.clip(adv, -1.0, 1.0))
            r["relative_advantage"] = float(np.clip(r["relative_advantage"], -1.0, 1.0))
        logger.info(f"Evaluated {len(results)} frames (2-timestep mode)")
        return results

    def evaluate_video_1timestep_advantage(
        self,
        video_paths,
        prompt: str,
        *,
        batch_size: int | None = None,
        frame_interval: int = 1,
        min_frame_index: int | None = None,
        max_frame_index: int | None = None,
    ) -> list[dict]:
        """The absolute value only (PI06 mode, reference :486+)."""
        if len(video_paths) != 3:
            raise ValueError("Expected 3 video paths: (top, left, right)")
        if batch_size is not None:
            self.batch_size = batch_size
        cams = self._load_videos(video_paths, frame_interval)
        lo = min_frame_index or 0
        hi = max_frame_index + 1 if max_frame_index is not None else None
        cams = [c[lo:hi] for c in cams]
        num_frames = len(cams[0])
        tokens, token_masks = self.tokenizer.tokenize(prompt)

        results = []
        for start in range(0, num_frames, self.batch_size):
            idxs = list(range(start, min(start + self.batch_size, num_frames)))
            absolute = self._infer_values([c[[0] * len(idxs)] for c in cams], [c[idxs] for c in cams], tokens,
                                          token_masks)
            for k, j in enumerate(idxs):
                results.append(
                    {"frame_idx": j, "absolute_value": 0.0 if j == 0 else float(np.clip(absolute[k], -1.0, 1.0))}
                )
        logger.info(f"Evaluated {len(results)} frames (1-timestep mode)")
        return results
