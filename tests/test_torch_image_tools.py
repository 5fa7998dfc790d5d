"""``kai0_tpu_torch.shared.image_tools`` against ``kai0_tpu.shared.image_tools``.

- The host resize of the transform chain: the JAX package's
  ``resize_with_pad_np`` runs OpenCV's ``INTER_LINEAR`` (installed here); the
  port writes OpenCV's fixed-point arithmetic out in numpy. Held to 1 uint8
  level, and the share of pixels that differ is printed (it is 0 where the
  arithmetic is OpenCV's). float32 images to 1e-6 (OpenCV's f32 sums may
  round differently).
- The model's float resize (``preprocess_observation``): ``jax.image.resize``
  LINEAR against ``F.interpolate(bilinear, antialias=True)``, downsampling and
  upsampling, to 1e-4 (measured ≤ 1.7e-5; both filter in f32).
"""

import warnings

import numpy as np
import pytest
import torch

from kai0_tpu.shared import image_tools as jax_tools
from kai0_tpu_torch.shared import image_tools as torch_tools


@pytest.mark.parametrize("shape", [(480, 640), (224, 224), (100, 300), (1, 1), (120, 160), (720, 1280)])
@pytest.mark.parametrize("batched", [False, True])
def test_uint8_resize_matches_opencv(shape, batched):
    rng = np.random.default_rng(sum(shape))
    images = rng.integers(0, 256, ((2,) if batched else ()) + (*shape, 3), dtype=np.uint8)
    ref = jax_tools.resize_with_pad_np(images, 224, 224)
    out = torch_tools.resize_with_pad_np(images, 224, 224)
    assert out.dtype == np.uint8 and out.shape == ref.shape == images.shape[:-3] + (224, 224, 3)
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    print(f"{shape} batched={batched}: {100 * (diff > 0).mean():.4f}% of uint8 values differ, max {diff.max()}")
    assert diff.max() <= 1


@pytest.mark.parametrize("shape", [(480, 640), (100, 300), (120, 160)])
def test_float32_host_resize_matches_opencv(shape):
    images = np.random.default_rng(1).uniform(-1, 1, (*shape, 3)).astype(np.float32)
    ref = jax_tools.resize_with_pad_np(images, 224, 224)
    out = torch_tools.resize_with_pad_np(images, 224, 224)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(480, 640), (100, 300), (120, 160), (300, 200)])
def test_float_resize_matches_jax_image_resize(shape):
    images = np.random.default_rng(2).uniform(-1, 1, (2, *shape, 3)).astype(np.float32)
    ref = np.asarray(jax_tools.resize_with_pad(images, 224, 224))
    out = torch_tools.resize_with_pad(torch.from_numpy(images), 224, 224).numpy()
    assert out.shape == ref.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    single = torch_tools.resize_with_pad(torch.from_numpy(images[0]), 224, 224).numpy()
    np.testing.assert_array_equal(single, out[0])


def test_unsupported_dtype_and_uint8_conversion():
    with pytest.raises(ValueError, match="Unsupported image dtype"):
        torch_tools.resize_with_pad_np(np.zeros((4, 4, 3), np.float64), 2, 2)
    x = np.random.default_rng(3).uniform(-1, 1, (8, 8, 3)).astype(np.float32)
    for img in (x, (x + 1) / 2, (x * 127 + 128).astype(np.uint8)):
        np.testing.assert_array_equal(torch_tools.convert_to_uint8(img), jax_tools.convert_to_uint8(img))


def test_uint8_resize_of_a_chw_frame_view_and_a_read_only_buffer():
    """The chain hands the resize a CHW camera frame transposed to HWC (a view, ``parse_image``), and the websocket
    hands read-only buffers: both give OpenCV's bytes, without a warning."""
    chw = np.random.default_rng(4).integers(0, 256, (3, 480, 640), dtype=np.uint8)
    hwc = np.transpose(chw, (1, 2, 0))
    ref = jax_tools.resize_with_pad_np(np.ascontiguousarray(hwc), 224, 224)
    read_only = np.frombuffer(np.ascontiguousarray(hwc).tobytes(), dtype=np.uint8).reshape(hwc.shape)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for frame in (hwc, read_only):
            np.testing.assert_array_equal(torch_tools.resize_with_pad_np(frame, 224, 224), ref)
