"""Model inputs and observation preprocessing, PyTorch.

Counterpart of ``kai0_tpu/models/model.py``: ``Observation`` with the
nested-dict contract of ``from_dict`` (uint8 images mapped to [-1, 1]) and
``preprocess_observation`` with its train branch (augmentation, crop and
rotation only where ``"wrist"`` is not in the camera key). Resizing is not
ported: images must already be 224×224.
"""

from __future__ import annotations

import dataclasses

import torch

from kai0_tpu_torch.models import augment as _augment

# The model always expects these images.
IMAGE_KEYS = (
    "base_0_rgb",
    "left_wrist_0_rgb",
    "right_wrist_0_rgb",
)

IMAGE_RESOLUTION = (224, 224)


def _to_float_image(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0 * 2.0 - 1.0
    return x


@dataclasses.dataclass
class Observation:
    """Model inputs: images ``[B, H, W, 3]`` in [-1, 1], keyed by camera name."""

    images: dict[str, torch.Tensor]
    image_masks: dict[str, torch.Tensor]
    state: torch.Tensor
    tokenized_prompt: torch.Tensor | None = None
    tokenized_prompt_mask: torch.Tensor | None = None

    @classmethod
    def from_dict(cls, data: dict) -> "Observation":
        """From the transform-chain dict: ``image``, ``image_mask``, ``state``, ``tokenized_prompt[_mask]``."""
        if ("tokenized_prompt" in data) != ("tokenized_prompt_mask" in data):
            raise ValueError("tokenized_prompt and tokenized_prompt_mask must be provided together.")
        return cls(
            images={k: _to_float_image(v) for k, v in data["image"].items()},
            image_masks=dict(data["image_mask"]),
            state=data["state"],
            tokenized_prompt=data.get("tokenized_prompt"),
            tokenized_prompt_mask=data.get("tokenized_prompt_mask"),
        )


def preprocess_observation(
    observation: Observation,
    *,
    train: bool = False,
    augment_params: dict[str, dict[str, torch.Tensor]] | None = None,
    generator: torch.Generator | None = None,
) -> Observation:
    """Check the images, augment them when ``train``, default-fill missing image masks with True.

    In training each camera's parameters come from ``augment_params[key]`` when
    given (see ``augment.draw_augment_params``), else they are drawn from
    ``generator``, camera by camera in ``IMAGE_KEYS`` order.
    """
    if not set(IMAGE_KEYS).issubset(observation.images):
        raise ValueError(f"images dict missing keys: expected {IMAGE_KEYS}, got {list(observation.images)}")
    batch_shape = observation.state.shape[:-1]
    out_images, out_masks = {}, {}
    for key in IMAGE_KEYS:
        image = observation.images[key]
        if tuple(image.shape[1:3]) != IMAGE_RESOLUTION:
            raise ValueError(
                f"image {key} is {tuple(image.shape[1:3])}, the port needs {IMAGE_RESOLUTION} (resizing is not ported)"
            )
        if train:
            if augment_params is not None:
                params = augment_params[key]
            else:
                params = _augment.draw_augment_params(
                    generator, image.shape[0], "wrist" not in key, device=image.device
                )
            image = _augment.augment_image(image, params)
        out_images[key] = image
        if key in observation.image_masks:
            out_masks[key] = torch.as_tensor(observation.image_masks[key], device=image.device)
        else:
            out_masks[key] = torch.ones(batch_shape, dtype=torch.bool, device=image.device)
    return dataclasses.replace(observation, images=out_images, image_masks=out_masks)
