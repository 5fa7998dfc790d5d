"""Aspect-preserving resize with centred black padding, without JAX or OpenCV.

Counterpart of ``kai0_tpu/shared/image_tools.py``:

- ``resize_with_pad_np`` (numpy in and out, computed by torch on the CPU) is
  the resize of the transform chain (``ResizeImages``) and of the JAX
  package's data loader, which run OpenCV's ``INTER_LINEAR``
  (``image_tools.py:73-108``): no antialiasing, half-pixel centres. It is
  written here as two 1-D two-tap passes with OpenCV's own weights and, for
  uint8, its fixed-point arithmetic, so that it gives OpenCV's bytes on hosts
  without OpenCV:
  - source coordinate ``(d + 0.5) * src / dst - 0.5``, split into its floor
    and fraction; along x the fraction is zeroed at both borders, along y it
    is kept and the row index clipped (as ``cv::resize`` does);
  - uint8: the coordinate rounded to f32 before the split, weights
    ``round(w * 2048)``, the row pass summed exactly in int32, the column pass
    as OpenCV's vector code forms it,
    ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2 >> 2`` (an
    11 + 11-bit rounding shift by 22): OpenCV's bytes;
  - float32: the coordinate split in f64, the taps in f32, then clipped to
    [-1, 1]: OpenCV's values up to f32 rounding.
- ``resize_with_pad`` (torch, any device) is the branch the model takes for an
  image that is not 224×224 (``kai0_tpu/models/model.py:133-135``):
  ``jax.image.resize(..., LINEAR)``, which widens its triangle kernel by the
  scale when it downsamples. ``F.interpolate(bilinear, antialias=True)``
  computes the same filter; JAX ran it outside any Pallas kernel, so a library
  call stands here.
- ``convert_to_uint8``: [-1, 1] or [0, 1] floats to uint8.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS: uint8 weights are round(w * 2048)


def _geometry(cur_height: int, cur_width: int, height: int, width: int) -> tuple[int, int, int, int]:
    """(resized height, resized width, top pad, left pad) of ``resize_with_pad``."""
    ratio = max(cur_width / width, cur_height / height)
    resized_height = int(cur_height / ratio)
    resized_width = int(cur_width / ratio)
    return resized_height, resized_width, (height - resized_height) // 2, (width - resized_width) // 2


def _taps(src: int, dst: int, *, clamp_weight: bool, f32_coordinate: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's linear taps from ``src`` to ``dst`` samples: (first index, second index, f32 fraction)."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    if f32_coordinate:
        f = f.astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = (f - i).astype(np.float32)
    if clamp_weight:
        f[(i < 0) | (i >= src - 1)] = 0
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), f


def _resize_linear(images: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_LINEAR)`` of each ``[B, H, W, C]`` image.

    In torch on the CPU (its integer ops run on every core): only the source
    rows that the column pass reads go through the row pass.
    """
    u8 = images.dtype == np.uint8
    x0, x1, fx = _taps(images.shape[2], width, clamp_weight=True, f32_coordinate=u8)
    y0, y1, fy = _taps(images.shape[1], height, clamp_weight=False, f32_coordinate=u8)
    rows, at = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    i0, i1, x0, x1 = (torch.from_numpy(np.ascontiguousarray(i)) for i in (at[:height], at[height:], x0, x1))
    with warnings.catch_warnings():  # a read-only request array (a msgpack buffer): only read here
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        src = torch.from_numpy(images)  # any strides (a CHW frame transposed to HWC is a view)
    src = src.index_select(1, torch.from_numpy(rows))
    one = np.float32(1)
    if u8:
        scale = np.float32(1 << _COEF_BITS)
        ax = [torch.from_numpy(np.rint(w * scale).astype(np.int32)[:, None]) for w in (one - fx, fx)]
        by = [torch.from_numpy(np.rint(w * scale).astype(np.int32)[:, None, None]) for w in (one - fy, fy)]
        src = src.to(torch.int32)
        r = src.index_select(2, x0) * ax[0] + src.index_select(2, x1) * ax[1]  # [B, rows, width, C], exact
        out = (((r.index_select(1, i0) >> 4) * by[0]) >> 16) + (((r.index_select(1, i1) >> 4) * by[1]) >> 16)
        return ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8).numpy()
    ax = [torch.from_numpy(w[:, None]) for w in (one - fx, fx)]
    by = [torch.from_numpy(w[:, None, None]) for w in (one - fy, fy)]
    r = src.index_select(2, x0) * ax[0] + src.index_select(2, x1) * ax[1]
    return (r.index_select(1, i0) * by[0] + r.index_select(1, i1) * by[1]).numpy()


def resize_with_pad_np(images: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize uint8 or float32 ``[*b, h, w, c]`` images to (height, width) without distortion, padding with black."""
    images = np.asarray(images)
    if images.dtype not in (np.uint8, np.float32):
        raise ValueError(f"Unsupported image dtype: {images.dtype}")
    has_batch_dim = images.ndim == 4
    if not has_batch_dim:
        images = images[None]
    cur_height, cur_width = images.shape[1:3]
    if (cur_height, cur_width) == (height, width):
        return images if has_batch_dim else images[0]
    resized_height, resized_width, pad_h0, pad_w0 = _geometry(cur_height, cur_width, height, width)
    resized = _resize_linear(images, resized_height, resized_width)
    if images.dtype == np.float32:
        resized = np.clip(resized, -1.0, 1.0)
    out = np.full((images.shape[0], height, width, images.shape[3]), 0 if images.dtype == np.uint8 else -1.0,
                  dtype=images.dtype)
    out[:, pad_h0 : pad_h0 + resized_height, pad_w0 : pad_w0 + resized_width] = resized
    return out if has_batch_dim else out[0]


def resize_with_pad(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize ``[*b, h, w, c]`` float32 ([-1, 1], padded with -1) or uint8 (padded with 0) images, antialiased."""
    if images.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"Unsupported image dtype: {images.dtype}")
    has_batch_dim = images.ndim == 4
    if not has_batch_dim:
        images = images[None]
    resized_height, resized_width, pad_h0, pad_w0 = _geometry(*images.shape[1:3], height, width)
    resized = F.interpolate(
        images.permute(0, 3, 1, 2).float(), size=(resized_height, resized_width), mode="bilinear",
        align_corners=False, antialias=True,
    ).permute(0, 2, 3, 1)
    if images.dtype == torch.uint8:
        resized = resized.round().clamp(0, 255).to(torch.uint8)
    else:
        resized = resized.clamp(-1.0, 1.0)
    out = torch.full((images.shape[0], height, width, images.shape[3]), 0 if images.dtype == torch.uint8 else -1.0,
                     dtype=images.dtype, device=images.device)
    out[:, pad_h0 : pad_h0 + resized_height, pad_w0 : pad_w0 + resized_width] = resized
    return out if has_batch_dim else out[0]


def convert_to_uint8(img: np.ndarray) -> np.ndarray:
    """Convert a [-1, 1] or [0, 1] float image to uint8, passing uint8 through."""
    if np.issubdtype(img.dtype, np.floating):
        if img.min() < -1e-4:
            img = img / 2.0 + 0.5  # [-1, 1] -> [0, 1]
        img = (255 * np.clip(img, 0.0, 1.0)).astype(np.uint8)
    return img
