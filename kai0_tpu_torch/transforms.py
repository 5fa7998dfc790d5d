"""Data transforms without JAX: the contract between datasets, training and serving.

Counterpart of ``kai0_tpu/transforms.py`` (the '/'-path dict toolkit, the
transform protocol, prompts, normalization with and without quantiles,
delta/absolute actions, prompt tokenization, resize and pad), on unbatched
nested dicts of numpy arrays. The FAST transforms (``TokenizeFASTInputs``,
``ExtractFASTActions``) wait for the FAST model. ``ResizeImages`` resizes with
``shared/image_tools.resize_with_pad_np``, OpenCV's ``INTER_LINEAR`` written
without OpenCV.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
import dataclasses
import re
from typing import Protocol, TypeAlias, TypeVar, runtime_checkable

import numpy as np

from kai0_tpu_torch.shared import image_tools as _image_tools
from kai0_tpu_torch.shared import normalize as _normalize

DataDict: TypeAlias = dict
NormStats: TypeAlias = _normalize.NormStats

T = TypeVar("T")
S = TypeVar("S")


# --------------------------------------------------------------------------------------
# '/'-path dict toolkit
# --------------------------------------------------------------------------------------


def flatten_dict(tree: dict, sep: str = "/") -> dict:
    """Nested dict → {'a/b/c': leaf}, preserving insertion order."""
    flat: dict = {}

    def walk(node: dict, prefix: str) -> None:
        for key, value in node.items():
            path = f"{prefix}{sep}{key}" if prefix else str(key)
            if isinstance(value, dict):
                walk(value, path)
            else:
                flat[path] = value

    walk(tree, "")
    return flat


def unflatten_dict(tree: dict, sep: str = "/") -> dict:
    """{'a/b/c': leaf} → nested dict. Inverse of :func:`flatten_dict`."""
    nested: dict = {}
    for path, leaf in tree.items():
        *branches, last = path.split(sep)
        node = nested
        for b in branches:
            node = node.setdefault(b, {})
        node[last] = leaf
    return nested


def _map_structure(fn: Callable, structure):
    if not isinstance(structure, dict):
        return fn(structure)
    return {k: _map_structure(fn, v) for k, v in structure.items()}


def transform_dict(patterns: Mapping[str, str | None], tree: dict) -> dict:
    """Rename/remove keys of a nested dict using ordered full-match regex patterns.

    Keys are flattened '/'-paths. The first matching pattern wins; its value is
    the replacement (backreferences allowed) or ``None`` to drop the key.
    Non-matching keys pass through. Raises if two keys land on the same output
    name or if an output leaf aliases an output subtree.
    Parity: reference transforms.py:382-433.
    """
    rules = [(re.compile(pat), repl) for pat, repl in patterns.items()]

    renamed: dict = {}
    for path, leaf in flatten_dict(tree).items():
        target: str | None = path
        for rx, repl in rules:
            if rx.fullmatch(path):
                target = None if repl is None else rx.sub(repl, path, count=1)
                break
        if target is None:
            continue
        if target in renamed:
            raise ValueError(f"Key '{target}' already exists in output")
        renamed[target] = leaf

    ordered = sorted(renamed)
    for shorter, longer in zip(ordered, ordered[1:]):
        if longer.startswith(shorter + "/"):
            raise ValueError(f"Leaf '{shorter}' aliases a node of '{longer}'")
    return unflatten_dict(renamed)


def apply_tree(tree: dict, selector: dict, fn: Callable[[T, S], T], *, strict: bool = False) -> dict:
    """Apply ``fn(leaf, selector_leaf)`` wherever ``selector`` has a matching path."""
    flat, sel = flatten_dict(tree), flatten_dict(selector)
    if strict and (missing := [k for k in sel if k not in flat]):
        raise ValueError(f"Selector key {missing[0]} not found in tree")
    return unflatten_dict({k: fn(v, sel[k]) if k in sel else v for k, v in flat.items()})


def pad_to_dim(x: np.ndarray, target_dim: int, axis: int = -1, value: float = 0.0) -> np.ndarray:
    """Pad ``x`` with ``value`` along ``axis`` up to ``target_dim`` (no-op if already there)."""
    x = np.asarray(x)
    missing = target_dim - x.shape[axis]
    if missing <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis % x.ndim] = (0, missing)
    return np.pad(x, widths, constant_values=value)


def make_bool_mask(*dims: int) -> tuple[bool, ...]:
    """``make_bool_mask(2, -2, 2) == (True, True, False, False, True, True)``."""
    out: list[bool] = []
    for d in dims:
        out += [d > 0] * abs(d)
    return tuple(out)


# --------------------------------------------------------------------------------------
# Transform protocol + composition
# --------------------------------------------------------------------------------------


@runtime_checkable
class DataTransformFn(Protocol):
    def __call__(self, data: DataDict) -> DataDict: ...


@dataclasses.dataclass(frozen=True)
class Group:
    """Transforms applied around the model: ``inputs`` before, ``outputs`` after."""

    inputs: Sequence[DataTransformFn] = ()
    outputs: Sequence[DataTransformFn] = ()

    def push(self, *, inputs: Sequence[DataTransformFn] = (), outputs: Sequence[DataTransformFn] = ()) -> "Group":
        """New group with ``inputs`` appended (inner side) and ``outputs`` prepended (inner side)."""
        return Group(inputs=(*self.inputs, *inputs), outputs=(*outputs, *self.outputs))


@dataclasses.dataclass(frozen=True)
class CompositeTransform(DataTransformFn):
    transforms: Sequence[DataTransformFn]

    def __call__(self, data: DataDict) -> DataDict:
        for step in self.transforms:
            data = step(data)
        return data


def compose(transforms: Sequence[DataTransformFn]) -> DataTransformFn:
    return CompositeTransform(transforms)


@dataclasses.dataclass(frozen=True)
class RepackTransform(DataTransformFn):
    """Rebuild the dict in a new shape: ``structure`` leaves name '/'-paths into the old dict.

    ``{"images": {"cam_high": "observation.images.top"}, "state": "observation.state"}``
    """

    structure: dict

    def __call__(self, data: DataDict) -> DataDict:
        source = flatten_dict(data)
        return _map_structure(source.__getitem__, self.structure)


# --------------------------------------------------------------------------------------
# Prompt transforms
# --------------------------------------------------------------------------------------


def _as_str(prompt) -> str:
    return prompt if isinstance(prompt, str) else prompt.item()


@dataclasses.dataclass(frozen=True)
class InjectDefaultPrompt(DataTransformFn):
    prompt: str | None

    def __call__(self, data: DataDict) -> DataDict:
        if "prompt" in data or self.prompt is None:
            return data
        return {**data, "prompt": np.asarray(self.prompt)}


@dataclasses.dataclass(frozen=True)
class InsertAdvantageIntoPrompt(DataTransformFn):
    """Appends ``, Advantage: {x:.4f}`` to the prompt (Stage Advantage conditioning)."""

    def __call__(self, data: DataDict) -> DataDict:
        for required in ("advantage", "prompt"):
            if required not in data:
                raise ValueError(f"{required} is not in data, data_keys: {list(data.keys())}")
        suffix = f", Advantage: {float(data['advantage']):.4f}"
        data["prompt"] = _as_str(data["prompt"]) + suffix
        return data


@dataclasses.dataclass(frozen=True)
class PromptFromLeRobotTask(DataTransformFn):
    """Prompt := the LeRobot task string for this frame's task_index (AWBC hook)."""

    tasks: dict[int, str]

    def __call__(self, data: DataDict) -> DataDict:
        if "task_index" not in data:
            raise ValueError('Cannot extract prompt without "task_index"')
        index = int(data["task_index"])
        if index not in self.tasks:
            raise ValueError(f"task_index={index} not found in task mapping: {self.tasks}")
        return {**data, "prompt": self.tasks[index]}


# --------------------------------------------------------------------------------------
# Normalization
#
# Forward truncates the stats to the data's trailing dim; inverse pads the stats
# (z-score: mean←0 / std←1) or passes extra dims through untouched (quantile).
# The epsilon placement matches the reference exactly — it is part of the 1e-3
# action-fidelity contract.
# --------------------------------------------------------------------------------------


def _znorm(x, s: NormStats):
    d = x.shape[-1]
    return (x - s.mean[..., :d]) / (s.std[..., :d] + 1e-6)


def _znorm_inv(x, s: NormStats):
    mean = pad_to_dim(s.mean, x.shape[-1], axis=-1, value=0.0)
    std = pad_to_dim(s.std, x.shape[-1], axis=-1, value=1.0)
    return x * (std + 1e-6) + mean


def _qnorm(x, s: NormStats):
    d = x.shape[-1]
    lo, hi = s.q01[..., :d], s.q99[..., :d]
    return (x - lo) / (hi - lo + 1e-6) * 2.0 - 1.0


def _qnorm_inv(x, s: NormStats):
    lo, hi = s.q01, s.q99
    d = lo.shape[-1]
    mapped = (x[..., :d] + 1.0) / 2.0 * (hi - lo + 1e-6) + lo
    if d < x.shape[-1]:
        return np.concatenate([mapped, x[..., d:]], axis=-1)
    return mapped


def _require_quantiles(norm_stats: dict) -> None:
    for path, s in flatten_dict(norm_stats).items():
        if s.q01 is None or s.q99 is None:
            raise ValueError(
                f"quantile stats must be provided if use_quantile_norm is True. Key {path} is missing q01 or q99."
            )


@dataclasses.dataclass(frozen=True)
class Normalize(DataTransformFn):
    norm_stats: dict | None
    use_quantiles: bool = False  # quantile map to [-1, 1] instead of z-score
    strict: bool = False  # raise if a stats key is absent from the data

    def __post_init__(self):
        if self.use_quantiles and self.norm_stats is not None:
            _require_quantiles(self.norm_stats)

    def __call__(self, data: DataDict) -> DataDict:
        if self.norm_stats is None:
            return data
        mode = _qnorm if self.use_quantiles else _znorm
        return apply_tree(data, self.norm_stats, mode, strict=self.strict)


@dataclasses.dataclass(frozen=True)
class Unnormalize(DataTransformFn):
    norm_stats: dict | None
    use_quantiles: bool = False

    def __post_init__(self):
        if self.use_quantiles and self.norm_stats is not None:
            _require_quantiles(self.norm_stats)

    def __call__(self, data: DataDict) -> DataDict:
        if self.norm_stats is None:
            return data
        mode = _qnorm_inv if self.use_quantiles else _znorm_inv
        # strict: unnormalizing model outputs must never silently skip a key.
        return apply_tree(data, self.norm_stats, mode, strict=True)


# --------------------------------------------------------------------------------------
# Action-space transforms
# --------------------------------------------------------------------------------------


def _shift_by_state(data: DataDict, mask, sign: int) -> DataDict:
    """actions[..., :d] ± state[..., :d] on mask-selected dims (broadcast over horizon)."""
    if mask is None or "actions" not in data:
        return data
    mask = np.asarray(mask)
    d = mask.shape[-1]
    offset = np.where(mask, data["state"][..., :d], 0)[..., None, :]
    data["actions"][..., :d] += sign * offset
    return data


@dataclasses.dataclass(frozen=True)
class DeltaActions(DataTransformFn):
    """Absolute → delta action space on mask-selected dims (relative to current state)."""

    mask: Sequence[bool] | None

    def __call__(self, data: DataDict) -> DataDict:
        return _shift_by_state(data, self.mask, -1)


@dataclasses.dataclass(frozen=True)
class AbsoluteActions(DataTransformFn):
    """Delta → absolute action space on mask-selected dims."""

    mask: Sequence[bool] | None

    def __call__(self, data: DataDict) -> DataDict:
        return _shift_by_state(data, self.mask, +1)


@dataclasses.dataclass(frozen=True)
class SubsampleActions(DataTransformFn):
    stride: int

    def __call__(self, data: DataDict) -> DataDict:
        return {**data, "actions": data["actions"][:: self.stride]}


# --------------------------------------------------------------------------------------
# Tokenization
# --------------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenizePrompt(DataTransformFn):
    tokenizer: object  # PaligemmaTokenizer protocol: .tokenize(prompt, state|None)
    discrete_state_input: bool = False  # π₀.₅: discretized state goes into the prompt

    def __call__(self, data: DataDict) -> DataDict:
        prompt = data.pop("prompt", None)
        if prompt is None:
            raise ValueError("Prompt is required")
        state = None
        if self.discrete_state_input:
            state = data.get("state")
            if state is None:
                raise ValueError("State is required.")
        tokens, masks = self.tokenizer.tokenize(_as_str(prompt), state)
        return {**data, "tokenized_prompt": tokens, "tokenized_prompt_mask": masks}


# --------------------------------------------------------------------------------------
# Shape transforms
# --------------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResizeImages(DataTransformFn):
    height: int
    width: int

    def __call__(self, data: DataDict) -> DataDict:
        resized = {
            name: _image_tools.resize_with_pad_np(np.asarray(img), self.height, self.width)
            for name, img in data["image"].items()
        }
        return {**data, "image": resized}


@dataclasses.dataclass(frozen=True)
class PadStatesAndActions(DataTransformFn):
    """Zero-pads state (and actions, when present) to the model action dimension."""

    model_action_dim: int

    def __call__(self, data: DataDict) -> DataDict:
        out = {**data, "state": pad_to_dim(data["state"], self.model_action_dim, axis=-1)}
        if "actions" in data:
            out["actions"] = pad_to_dim(data["actions"], self.model_action_dim, axis=-1)
        return out
