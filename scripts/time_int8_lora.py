"""Time K4a (``int8_matmul_lora`` on one CUDA card) and print SHA-256 digests of its outputs on seeded operands.

    python3 scripts/time_int8_lora.py [--root DIR] [--runs 20]

For each (M, N, K, rank) below, in bf16 and f32, the operands are drawn from a
CUDA generator seeded by the shape and the kernel runs once: the digest of its
output bytes is printed, and in bf16 its CUDA-event median over ``--runs``
launches (``chip_smoke.py``'s timing). Two checkouts that print the same
digests give the same bits: ``--root`` imports ``kai0_tpu_torch`` from another
checkout (for example the parent commit unpacked with ``git archive``), so a
change to the kernel can be held bit for bit, and timed, against the tree
before it in one call. The shapes are the LoRA products of the int8 fine-tune
at batch 32 (Gemma-2B rank 16 on a 7,744-row chunk, Gemma-300M rank 32 on
1,600 rows), int8 serving's 50 rows, small ragged ones, and rank 64 (two
slices of the kernel's epilogue; a tree that caps the rank at 32 raises there
and prints null).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ((7744, 16384, 2048, 16), (7744, 2048, 16384, 16), (1600, 4096, 1024, 32), (1600, 1024, 4096, 32),
          (50, 4096, 1024, 32), (129, 130, 32, 7), (70, 72, 48, 4), (968, 2048, 16384, 16), (7744, 16384, 2048, 64))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose kai0_tpu_torch is run")
    parser.add_argument("--runs", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_int8_lora.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # the timing helper, from this checkout

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from kai0_tpu_torch.ops import int8_matmul as mm  # the kernel, from --root

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    digests, times = {}, {}
    for m, n, k, rank in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(m + n + k + rank)
            xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
            w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
            sx = torch.rand(m, 1, generator=g, device="cuda") * 1e-2 + 1e-4
            sn = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-5
            u = torch.randn(m, rank, generator=g, device="cuda").to(dtype)
            b = (torch.randn(rank, n, generator=g, device="cuda") * 0.05).to(dtype)
            key = f"{m}x{n}x{k} r={rank} {str(dtype)[6:]}"
            try:
                out = mm.int8_matmul_lora(xq, w, sx, sn, u, b, out_dtype=dtype)
            except ValueError:  # a tree with a rank cap
                digests[key] = times[key] = None
                continue
            raw = out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).cpu().numpy().tobytes()
            digests[key] = hashlib.sha256(raw).hexdigest()[:16]
            if dtype == torch.bfloat16:
                times[key] = cs._cuda_ms(lambda: mm.int8_matmul_lora(xq, w, sx, sn, u, b), runs=args.runs)
    print(json.dumps({"root": args.root, "card": card, "int8_matmul_lora_sha256": digests, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
