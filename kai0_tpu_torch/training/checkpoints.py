"""Checkpoints of the training loop: directory set-up, resume detection, save, restore and retention.

Counterpart of ``kai0_tpu/training/checkpoints.py:34-195``. The port reads and
writes no Orbax; its layout is one that the serving of both packages reads.
Under ``<checkpoint_dir>/<step>/``:

- ``model.safetensors``: the inference tree in the ``PI0Pytorch`` key layout
  (what ``interop.save_torch_checkpoint`` writes, and what
  ``create_trained_policy`` of either package serves): the EMA when the run
  keeps one, the parameters otherwise (``_split_params`` of JAX). An int8
  frozen holder is saved dequantized, as its bf16 weight, so a restore
  requantizes it: a weight may move by one int8 step (JAX's quantized resume,
  ``kai0_tpu/training/train_lib.py:230-258``).
- ``train_state.safetensors`` and ``train_state.json``: the rest of what a
  resume needs. The tensors are the optimizer moments in their storage dtype
  (f32, bf16, or int8 codes and f32 block scales; SGD's momentum trace;
  ClipSGD keeps none) and, when the EMA holds
  ``model.safetensors``, the parameters; the JSON holds the step, the
  optimizer count and whether the run keeps an EMA.
- ``assets/<asset_id>/norm_stats.json`` when the data config has norm stats.

No generator state is saved: the noise, time and augmentation draws, the bf16
apply and the optimizer's rounding derive from (seed, step)
(``train_lib.train_step``, ``optimizer.step_generator``), so a resumed step
draws what the uninterrupted run would have drawn.

A step is written to ``<step>.tmp`` and renamed, so a process that dies while
saving leaves no step that resume would pick up; a leftover ``.tmp`` is
ignored and replaced. Retention is Orbax's ``max_to_keep=1`` with
``keep_period``: the newest step and every step divisible by ``keep_period``
stay. Saving is synchronous (JAX's Orbax save is asynchronous): the loop
waits for it, and ``train_lib.main`` logs its seconds and bytes.

The port resumes its own checkpoints only. A JAX run starts the port through
its parameters: ``kai0_tpu.interop.save_torch_checkpoint`` exports them to a
``model.safetensors``, which ``weight_loaders.CheckpointWeightLoader`` reads.
"""

from __future__ import annotations

from collections.abc import Mapping
import dataclasses
import json
import logging
import pathlib
import shutil

import torch
from torch import nn

from kai0_tpu_torch import interop as _interop
from kai0_tpu_torch.ops import quant as _quant
from kai0_tpu_torch.shared import normalize as _normalize
from kai0_tpu_torch.training.utils import TrainState

logger = logging.getLogger("kai0_tpu_torch")

TRAIN_STATE_FILE = "train_state.safetensors"
TRAIN_STATE_META = "train_state.json"


@dataclasses.dataclass(frozen=True)
class CheckpointManager:
    """The step directories of one run, and their retention: the newest step and every ``keep_period``-th."""

    directory: pathlib.Path
    keep_period: int | None = None

    def all_steps(self) -> list[int]:
        """The steps saved in full (a ``<step>.tmp`` of an interrupted save is not one)."""
        if not self.directory.exists():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir() if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> pathlib.Path:
        return self.directory / str(step)

    def prune(self) -> None:
        steps = self.all_steps()
        keep = set(steps[-1:])
        if self.keep_period:
            keep |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_dir(s))


def initialize_checkpoint_dir(
    checkpoint_dir: pathlib.Path | str, *, keep_period: int | None, overwrite: bool, resume: bool
) -> tuple[CheckpointManager, bool]:
    """The run's manager, and whether the run resumes (the directory holds a step > 0 and ``resume`` is set)."""
    checkpoint_dir = pathlib.Path(checkpoint_dir).resolve()
    has_prior_run = checkpoint_dir.exists()
    if has_prior_run and overwrite:
        shutil.rmtree(checkpoint_dir)
        logger.info(f"Removed existing checkpoint directory {checkpoint_dir}")
        has_prior_run = False
    if has_prior_run and not resume:
        raise FileExistsError(
            f"{checkpoint_dir} already holds a previous run; pass --overwrite to replace it "
            "or --resume to continue from it."
        )
    resuming = has_prior_run
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    manager = CheckpointManager(checkpoint_dir, keep_period=keep_period)
    # A resume against a directory that never reached a save (no steps, or only step 0) restores nothing.
    if resuming and not any(step > 0 for step in manager.all_steps()):
        logger.info(f"No restorable checkpoint under {checkpoint_dir}; starting from scratch instead of resuming.")
        resuming = False
    return manager, resuming


def _holders(model: nn.Module):
    """(module name, holder, weight keys) of every int8 holder: the keys of the weights it stands for in the layout."""
    joint = {name: members for members, name in _quant.JOINT_HOLDERS.items()}
    for name, module in model.named_modules():
        if _quant.is_quant(module):
            parent, attr = name.rsplit(".", 1)
            members = joint.get(attr)
            keys = [f"{parent}.{m}.weight" for m in members] if members else [f"{name}.weight"]
            yield name, module, keys


def inference_state(model: nn.Module, state: TrainState) -> dict[str, torch.Tensor]:
    """The ``PI0Pytorch``-layout tree that serving reads: the EMA (else the parameters), holders dequantized."""
    params = state.ema if state.ema is not None else state.params
    out = {name: params[name].detach() for name, _ in model.named_parameters()}
    for _, holder, keys in _holders(model):
        out.update(zip(keys, _quant.dequantize(holder).chunk(len(keys), dim=0), strict=True))
    return out


def _opt_tensors(opt_state: Mapping) -> dict[str, torch.Tensor]:
    """The optimizer state's tensors by ``opt/<key>/<name>``: AdamW's ``mu`` and ``nu``, SGD's ``trace``, none of
    ClipSGD's."""
    out = {}
    for key, moments in opt_state.items():
        if key == "count":
            continue
        for name, moment in moments.items():
            if isinstance(moment, Mapping):  # int8 codes and f32 block scales
                out.update({f"opt/{key}/{name}/{part}": moment[part] for part in ("q", "s")})
            else:
                out[f"opt/{key}/{name}"] = moment
    return out


def _nbytes(path: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def save_state(
    manager: CheckpointManager,
    model: nn.Module,
    state: TrainState,
    step: int,
    *,
    norm_stats: dict[str, _normalize.NormStats] | None = None,
    asset_id: str | None = None,
) -> int:
    """Write step ``step`` (through ``<step>.tmp``), prune by retention, and return the bytes written."""
    tmp = manager.directory / f"{step}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    _interop.write_safetensors(inference_state(model, state), tmp / _interop.CHECKPOINT_FILE)
    tensors = _opt_tensors(state.opt_state)
    if state.ema is not None:  # the EMA holds model.safetensors: the parameters go here
        tensors.update({f"params/{name}": p.detach() for name, p in state.params.items()})
    _interop.write_safetensors(tensors, tmp / TRAIN_STATE_FILE)
    meta = {"step": state.step, "count": state.opt_state["count"], "ema": state.ema is not None}
    (tmp / TRAIN_STATE_META).write_text(json.dumps(meta))
    if norm_stats is not None and asset_id is not None:
        _normalize.save(tmp / "assets" / asset_id, norm_stats)
    nbytes = _nbytes(tmp)
    final = manager.step_dir(step)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    manager.prune()
    return nbytes


def _copy(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"checkpoint tensor {name}: {tuple(src.shape)} {src.dtype}, the state holds "
                         f"{tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def restore_state(manager: CheckpointManager, model: nn.Module, state: TrainState, step: int | None = None) -> TrainState:
    """Restore ``step`` (the latest by default) into ``model`` and ``state``, in place, and return the restored state.

    ``state`` is the fresh state of the same configuration (``init_train_state(..., resume=True)``): every
    tensor must match the checkpoint's shape and dtype. Int8 holders are requantized from the saved weights.
    """
    step = manager.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {manager.directory}")
    directory = manager.step_dir(step)
    meta = json.loads((directory / TRAIN_STATE_META).read_text())
    if meta["ema"] != (state.ema is not None):
        raise ValueError(f"step {step} was saved {'with' if meta['ema'] else 'without'} an EMA; the config differs")
    inference = _interop.read_safetensors(directory / _interop.CHECKPOINT_FILE)
    saved = _interop.read_safetensors(directory / TRAIN_STATE_FILE)
    params = {k.removeprefix("params/"): v for k, v in saved.items() if k.startswith("params/")} if meta["ema"] else inference
    with torch.no_grad():
        for name, p in state.params.items():
            _copy(p, params[name], name)
        if state.ema is not None:
            for name, e in state.ema.items():
                _copy(e, inference[name], name)
        for name, holder, keys in _holders(model):  # one holder at a time: one dequantized weight on the card
            w = torch.cat([inference[k] for k in keys], dim=0).to(holder.qweight.device)
            q, s = _quant.quantize_weight(w)
            _copy(holder.qweight, q, f"{name}.qweight")
            _copy(holder.scale, s, f"{name}.scale")
        for key, tensor in _opt_tensors(state.opt_state).items():
            _copy(tensor, saved[key], key)
    logger.info(f"Restored step {step} from {directory}")
    return TrainState(step=meta["step"], params=state.params, opt_state={**state.opt_state, "count": meta["count"]},
                      ema=state.ema)
