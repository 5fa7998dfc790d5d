"""Train-time image augmentation, PyTorch.

Counterpart of ``kai0_tpu/models/augment.py``: crop (95%) -> resize -> rotate
(±5°) as one affine warp with zero-padded bilinear taps (``:24-66``), then a
colour jitter of brightness 0.3, contrast 0.4 and saturation 0.5 in that order
(``:69-81``), on [-1, 1] images ``[B, H, W, C]``. Drawing the parameters
(``draw_augment_params``) and applying them (``augment_image``) are separate
steps, so a caller can hand in the JAX package's draws.
"""

from __future__ import annotations

import math

import torch

CROP_FRACTION = 0.95
MAX_ROTATION_DEG = 5.0
BRIGHTNESS = 0.3
CONTRAST = 0.4
SATURATION = 0.5


def draw_augment_params(
    generator: torch.Generator | None, batch: int, crop_and_rotate: bool, *, height: int = 224, width: int = 224,
    device=None,
) -> dict[str, torch.Tensor]:
    """Per-image parameters, f32, drawn from ``generator`` (torch's default one if None) on ``device``.

    ``offset`` [B, 2] (crop origin y, x) and ``theta`` [B] (radians) only with
    ``crop_and_rotate``; ``brightness``, ``contrast``, ``saturation`` [B].
    """
    u = torch.rand((batch, 6), generator=generator, device=device, dtype=torch.float32)

    def between(x, lo, hi):
        return x * (hi - lo) + lo

    params = {
        "brightness": between(u[:, 0], 1 - BRIGHTNESS, 1 + BRIGHTNESS),
        "contrast": between(u[:, 1], 1 - CONTRAST, 1 + CONTRAST),
        "saturation": between(u[:, 2], 1 - SATURATION, 1 + SATURATION),
    }
    if crop_and_rotate:
        max_off = torch.tensor([height * (1 - CROP_FRACTION), width * (1 - CROP_FRACTION)], device=u.device)
        params["offset"] = torch.stack([u[:, 3], u[:, 4]], dim=-1) * max_off
        params["theta"] = between(u[:, 5], -MAX_ROTATION_DEG, MAX_ROTATION_DEG) * (math.pi / 180.0)
    return params


def _bilinear_sample(images: torch.Tensor, y_in: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
    """Sample [B, H, W, C] at float coordinates [B, H, W]; taps outside the image are zero."""
    b, h, w, c = images.shape
    y0, x0 = torch.floor(y_in), torch.floor(x_in)
    wy, wx = (y_in - y0)[..., None], (x_in - x0)[..., None]
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    flat = images.reshape(b, h * w, c)

    def tap(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1, 1).expand(b, h * w, c)
        return torch.where(valid, torch.gather(flat, 1, idx).view(b, h, w, c), 0.0)

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x0i + 1) * wx
    bot = tap(y0i + 1, x0i) * (1 - wx) + tap(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def affine_warp(images: torch.Tensor, offset: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """crop(CROP_FRACTION at ``offset``) -> resize back -> rotate(``theta``), one bilinear pass."""
    b, h, w, _ = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=images.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=images.device)[None, None, :]
    cos_t, sin_t = torch.cos(-theta)[:, None, None], torch.sin(-theta)[:, None, None]
    y1 = cos_t * (yy - cy) - sin_t * (xx - cx) + cy
    x1 = sin_t * (yy - cy) + cos_t * (xx - cx) + cx
    y_in = offset[:, 0, None, None] + y1 * CROP_FRACTION
    x_in = offset[:, 1, None, None] + x1 * CROP_FRACTION
    return _bilinear_sample(images, y_in, x_in)


def color_jitter(images: torch.Tensor, brightness, contrast, saturation) -> torch.Tensor:
    """Brightness, contrast, saturation (per image, [B] each) on [0, 1] images, clipped to [0, 1]."""
    images = images * brightness[:, None, None, None]
    mean = images.mean(dim=(-3, -2, -1), keepdim=True)
    images = (images - mean) * contrast[:, None, None, None] + mean
    gray = images.mean(dim=-1, keepdim=True)
    images = gray + (images - gray) * saturation[:, None, None, None]
    return images.clamp(0.0, 1.0)


def augment_image(images: torch.Tensor, params: dict[str, torch.Tensor]) -> torch.Tensor:
    """Augment [-1, 1] images ``[B, H, W, C]``: the warp where ``params`` has ``offset``, then the jitter."""
    images = images / 2.0 + 0.5
    if "offset" in params:
        images = affine_warp(images, params["offset"], params["theta"])
    images = color_jitter(images, params["brightness"], params["contrast"], params["saturation"])
    return images * 2.0 - 1.0
