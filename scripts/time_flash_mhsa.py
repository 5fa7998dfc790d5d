"""Time SigLIP's attention kernels K2f / K2b of ``kai0_tpu_torch`` on one CUDA card.

    python3 scripts/time_flash_mhsa.py [--root DIR] [--batch 96] [--batch 6] [--batch 3] [--runs 10]

On head-major q/k/v [B,16,256,72] bf16 (So400m/14: 16 heads of 72 over 256
patches; B = samples x 3 cameras, so 96 is the batch-32 training step, 6 the
batch-2 one and 3 a serving request) it times, with CUDA-event medians: the
forward kernel, the backward kernel, the plain PyTorch versions,
``scaled_dot_product_attention`` forward and forward+backward on the same inputs
(a yardstick the port never calls), and the bound (4·B·N·T·S·H forward and
10·B·N·T·S·H backward operations over 989 TFLOP/s bf16, or the bytes over
3.35 TB/s). It also holds the kernels to the plain versions (forward max / mean
abs error, each gradient's max error over its max |grad|). Timing and bound are
``chip_smoke.py``'s own.

``--root`` imports ``kai0_tpu_torch`` from another checkout (for example the
parent commit unpacked with ``git archive``), so two trees can be timed in one
call on one card. Prints the card (``nvidia-smi`` name and power limit) and one
JSON line per batch.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
HEADS, TOKENS, HEAD_DIM = 16, 256, 72


def time_batch(fa, cs, batch: int, runs: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(batch)
    shape = (batch, HEADS, TOKENS, HEAD_DIM)
    q = (torch.randn(shape, generator=gen, device="cuda") / HEAD_DIM**0.5).bfloat16()
    k, v, dout = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
    out, lse = fa.flash_mhsa_fwd(q, k, v)
    grads = fa.flash_mhsa_bwd(q, k, v, out, lse, dout)
    err = (out.float() - fa.flash_mhsa_plain(q, k, v).float()).abs()
    rec = {"shape": list(shape), "fwd_max_abs_err": err.max().item(), "fwd_mean_abs_err": err.mean().item(),
           "bwd_err_over_max_grad": cs._grad_errors(grads, fa.flash_mhsa_bwd_plain(q, k, v, dout))}
    del err
    torch.cuda.empty_cache()
    for key, fn in (
        ("fwd", lambda: fa.flash_mhsa_fwd(q, k, v)),
        ("bwd", lambda: fa.flash_mhsa_bwd(q, k, v, out, lse, dout)),
        ("sdpa_fwd", cs._sdpa(q, k, v)),
        ("sdpa_fwd_bwd", cs._sdpa(q, k, v, dout=dout)),
        ("plain_fwd", lambda: fa.flash_mhsa_plain(q, k, v)),
        ("plain_bwd", lambda: fa.flash_mhsa_bwd_plain(q, k, v, dout)),
    ):
        rec[f"{key}_ms"] = cs._cuda_ms(fn, runs=runs)
        torch.cuda.empty_cache()
    pairs = batch * HEADS * TOKENS * TOKENS * HEAD_DIM
    nbytes = cs._nbytes(q, k, v, out, lse)
    rec["bound_fwd_ms"], rec["bound_fwd_by"] = cs._bound(4 * pairs, nbytes, torch.bfloat16)
    nbytes += cs._nbytes(dout, *grads)
    rec["bound_bwd_ms"], rec["bound_bwd_by"] = cs._bound(10 * pairs, nbytes, torch.bfloat16)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose kai0_tpu_torch is timed")
    parser.add_argument("--batch", type=int, action="append", help="leading dims B (default 96, 6 and 3)")
    parser.add_argument("--runs", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_mhsa.py: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # the measurement helpers, from this checkout

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from kai0_tpu_torch.ops import flash_attention as fa  # the kernels, from --root

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; kai0_tpu_torch from {pathlib.Path(fa.__file__).parents[2]}")
    for batch in args.batch or [96, 6, 3]:
        print(json.dumps({"root": args.root, "card": card, **time_batch(fa, cs, batch, args.runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
