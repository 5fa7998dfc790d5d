"""The int8 modes of ``ops/quant.py`` and where a run selects them: one registry, one environment read.

Counterpart of the int8 half of ``kai0_tpu/knobs.py``, with its environment
names, spellings and defaults. Precedence, highest first:

1. an environment variable (``KAI0_INT8_SB_GEMMA=ffn python scripts/train_torch.py ...``);
2. ``TrainConfig.knobs`` (``--knobs.int8_sb_gemma=ffn`` on the training
   command line; the serving script's ``--int8_*`` flags);
3. the default: every mode off, the bf16 path of the reference.

An empty variable counts as unset. ``resolve`` is the only place where the
port reads these variables: the entry points (``train_lib.init_train_state``,
``policy_config.create_trained_policy``) resolve once and hand explicit
arguments to ``ops/quant.py``'s tree transforms, which swap modules; ops and
models read no environment.

The JAX package's other ``int8_*`` knobs steer its TPU lowering (Pallas
routing, chunk budgets, unrolling, A/B reverts) and are not ported (ROADMAP,
"Port the default path").
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Knobs:
    """Overrides of the int8 modes; None falls through to the environment's value or the default."""

    int8_sb_gemma: str | None = None  # 0 | 1 | all | attn,ffn: SwitchBack on the Gemma matmuls (the full fine-tune)
    int8_switchback: str | None = None  # 0 | 1 | all | attn,mlp,head: SwitchBack on the SigLIP matmuls
    int8_weight_only: bool | None = None  # int8 weights dequantized into a bf16 product; activations not quantized
    int8_siglip: str | None = None  # 0 | 1 | all | attn,mlp,head: SigLIP sites of int8 serving
    int8_sites: str | None = None  # Gemma sites of the int8 base: comma-separated substrings, "-x" excludes; all


ENV = {
    "int8_sb_gemma": "KAI0_INT8_SB_GEMMA",
    "int8_switchback": "KAI0_INT8_SB",
    "int8_weight_only": "KAI0_INT8_WO",
    "int8_siglip": "KAI0_INT8_SIGLIP",
    "int8_sites": "KAI0_INT8_SITES",
}

DEFAULTS = {
    "int8_sb_gemma": "0",
    "int8_switchback": "0",
    "int8_weight_only": False,
    "int8_siglip": "0",
    "int8_sites": None,
}


def _coerce(field: str, raw: str):
    if isinstance(DEFAULTS[field], bool):
        return raw.lower() not in ("0", "false", "off", "no", "")
    return raw


def resolve(configured: Knobs | None = None) -> Knobs:
    """The effective modes: the environment over ``configured`` over the defaults (no field left None but
    ``int8_sites``, whose None selects every site)."""
    values = {}
    for field, env in ENV.items():
        raw = os.environ.get(env)
        if raw:
            values[field] = _coerce(field, raw)
            continue
        conf = None if configured is None else getattr(configured, field)
        values[field] = DEFAULTS[field] if conf is None else conf
    return Knobs(**values)
