"""Training metrics: an append-only ``metrics.jsonl`` always, wandb when it imports.

Counterpart of ``kai0_tpu/training/metrics.py:17-61``. The file lives in the
checkpoint directory, one ``{"step", "ts", <metric>: float}`` record a line;
a resumed run appends to it and keeps the run id of ``run_id.txt`` (the
convention of the reference's ``wandb_id.txt``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
import uuid


class MetricsLogger:
    def __init__(self, checkpoint_dir: pathlib.Path | str, *, resuming: bool, enabled: bool = True, config=None):
        self._enabled = enabled
        self._wandb = None
        self._file = None
        if not enabled:
            return

        ckpt_dir = pathlib.Path(checkpoint_dir)
        run_id_file = ckpt_dir / "run_id.txt"
        if resuming and run_id_file.exists():
            self._run_id = run_id_file.read_text().strip()
        else:
            self._run_id = uuid.uuid4().hex[:8]
            run_id_file.write_text(self._run_id)

        self._file = (ckpt_dir / "metrics.jsonl").open("a")

        try:
            import wandb

            if resuming:
                self._wandb = wandb.init(id=self._run_id, resume="allow")
            else:
                cfg = dataclasses.asdict(config) if config is not None and dataclasses.is_dataclass(config) else None
                self._wandb = wandb.init(name=getattr(config, "exp_name", None), config=cfg)
        except Exception:  # noqa: BLE001 - wandb absent or offline
            self._wandb = None

    def log(self, metrics: dict, step: int):
        if not self._enabled:
            return
        record = {"step": step, "ts": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._file is not None:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
