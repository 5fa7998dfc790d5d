"""Time the MQA attention kernels K1f / K1b of ``kai0_tpu_torch`` on one CUDA card.

    python3 scripts/time_flash_mqa.py [--root DIR] [--batch 32] [--batch 2] [--runs 10]

At the π₀.₅ training shape (q [B,1018,8,256] bf16, one K/V head, the joint
prefix/suffix training mask) it times, with CUDA-event medians: the forward
kernel, the backward kernel, the plain PyTorch versions,
``scaled_dot_product_attention`` forward and forward+backward on the same inputs
(K/V expanded to 8 heads; a yardstick the port never calls), and the bound
(this mask's operations over 989 TFLOP/s bf16, or the bytes over 3.35 TB/s). It
also holds the kernels to the plain versions (forward max / mean abs error, each
gradient's max error over its max |grad|). The inputs, mask, timing and bound
are ``chip_smoke.py``'s own (phase 6).

``--root`` imports ``kai0_tpu_torch`` from another checkout (for example the
parent commit unpacked with ``git archive``), so two trees can be timed in one
run on one card. Prints the card (``nvidia-smi`` name and power limit) and one
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


def time_batch(fa, cs, batch: int, runs: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(batch)
    mask = cs._training_mask(batch)
    q = (torch.randn(batch, 1018, 8, 256, generator=gen, device="cuda") / 16).bfloat16()
    k, v = (torch.randn(batch, 1018, 1, 256, generator=gen, device="cuda").bfloat16() for _ in range(2))
    dout = torch.randn(batch, 1018, 8, 256, generator=gen, device="cuda").bfloat16()
    out, lse = fa.flash_mha_fwd(q, k, v, mask)
    grads = fa.flash_mha_bwd(q, k, v, mask, out, lse, dout)
    err = (out.float() - fa.flash_mha_plain(q, k, v, mask).float()).abs()
    rec = {"batch": batch, "fwd_max_abs_err": err.max().item(), "fwd_mean_abs_err": err.mean().item(),
           "bwd_err_over_max_grad": cs._grad_errors(grads, fa.flash_mha_bwd_plain(q, k, v, mask, dout))}
    del err
    torch.cuda.empty_cache()
    for key, fn in (
        ("fwd", lambda: fa.flash_mha_fwd(q, k, v, mask)),
        ("bwd", lambda: fa.flash_mha_bwd(q, k, v, mask, out, lse, dout)),
        ("sdpa_fwd", cs._sdpa(q, k, v, mask)),
        ("sdpa_fwd_bwd", cs._sdpa(q, k, v, mask, dout=dout)),
        ("plain_fwd", lambda: fa.flash_mha_plain(q, k, v, mask)),
        ("plain_bwd", lambda: fa.flash_mha_bwd_plain(q, k, v, mask, dout)),
    ):
        rec[f"{key}_ms"] = cs._cuda_ms(fn, runs=runs)
        torch.cuda.empty_cache()
    nbytes = cs._nbytes(q, k, v, mask, out, lse)
    rec["bound_fwd_ms"], rec["bound_fwd_by"] = cs._bound(cs._mqa_flops(mask, 8, 256, 2), nbytes, torch.bfloat16)
    nbytes += cs._nbytes(dout, *grads)
    rec["bound_bwd_ms"], rec["bound_bwd_by"] = cs._bound(cs._mqa_flops(mask, 8, 256, 5), nbytes, torch.bfloat16)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose kai0_tpu_torch is timed")
    parser.add_argument("--batch", type=int, action="append", help="batch sizes (default 32 and 2)")
    parser.add_argument("--runs", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_mqa.py: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # the measurement helpers, from this checkout

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from kai0_tpu_torch.ops import flash_attention as fa  # the kernels, from --root

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; kai0_tpu_torch from {pathlib.Path(fa.__file__).parents[2]}")
    for batch in args.batch or [32, 2]:
        print(json.dumps({"root": args.root, "card": card, **time_batch(fa, cs, batch, args.runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
