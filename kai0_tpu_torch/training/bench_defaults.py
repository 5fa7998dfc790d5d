"""The knobs of the JAX package's full fine-tune benchmark that the port reads.

The port's copy of ``bench.py:116-170`` (``int8_bench_defaults``,
``fullft_bench_defaults``), which cannot be imported here: ``bench.py``
imports jax. ``scripts/check_convergence_onchip_torch.py`` builds its
``--full-ft`` arms with it, so that the configuration whose convergence is
measured is the one the benchmark runs. The environment wins over it, as over
any ``TrainConfig.knobs`` (``KAI0_INT8_SB_GEMMA=0`` selects the bf16 step).

Of the JAX sets only SwitchBack on the Gemma FFN is left. The rest is not
knobs here:

- ``KAI0_INT8_CHUNK_MB`` (the TPU's row chunking of the int8 FFN: the port
  chunks by ``ops/quant._CHUNK_BYTES``);
- ``KAI0_SIGLIP_BLOCK_T_BWD`` (the Pallas SigLIP backward's query block: K2b
  has its own tiles);
- ``KAI0_REMAT`` (XLA's rematerialization policy: the port recomputes each
  block in the backward, always);
- ``KAI0_BENCH_PARAM_DTYPE=bfloat16`` (bf16 parameters with stochastically
  rounded updates): a ``TrainConfig`` field in the port, which the
  convergence script's full fine-tune sets, ``param_dtype="bfloat16"``.

So the LoRA-over-int8 set (``int8_bench_defaults``), all TPU lowering, has
no counterpart.
"""

from __future__ import annotations

from kai0_tpu_torch import knobs as _knobs

FULLFT_KNOBS = _knobs.Knobs(int8_sb_gemma="ffn")  # SwitchBack on the fused Gemma FFN (ops/quant.sb_fused_ffn)
