"""Time K5 (``row_quant`` on one CUDA card) at the shapes of ``chip_smoke.py``'s phase 10, in both modes.

    python3 scripts/time_row_quant.py [--root DIR] [--runs 20]

Rows: the rows of bf16 and f32 activations that the int8 paths quantize (every
row count of phase 10 against every contraction width), and the straight-through
backward's ``q_row(dy · s)`` at every ``dx`` shape of both experts, with ``dy``
in bf16 (the training path's) and f32 and column scales from 1e-5 to 1e-2.
Inputs come from a CUDA generator seeded by the shape. For each row it prints
the kernel's CUDA-event median over ``--runs`` calls (``chip_smoke.py``'s
timing, which includes the host's launch), the device time of one call among
20 captured back to back in a CUDA graph (``graph_ms``: no host in it), the
bytes bound (each input read once, the codes and scales written once, over
3.35 TB/s) and SHA-256 digests of the codes and of the scales. A ``dy · s`` row
also times the three launches that quantized it before the column-scale mode
(the cast to f32, the multiply, K5 on the f32 product: ``three_launch_ms`` and
``three_launch_graph_ms``); on a checkout whose ``row_quant`` takes no column
scale those are all it times, and its digests are theirs. ``--root`` imports
``kai0_tpu_torch`` from another checkout (for example the parent commit
unpacked with ``git archive``), so two trees can be timed in turns in one call
and held bit for bit by their digests. The last line is one JSON object with
every row.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _shapes(cs) -> list[tuple[str, int, int, torch.dtype]]:
    """(mode, M, K, dtype) of phase 10: activations at every contraction width, ``dy · s`` at every dx shape."""
    bf16, f32 = torch.bfloat16, torch.float32
    rows = (*cs.INT8_ROWS, cs.INT8_CHUNK_ROWS, cs.INT8_ATTENTION_ROWS)
    shapes = [("rows", m, k, dtype) for dtype, ks in ((bf16, (1024, 2048, 4096, 16384)), (f32, (512, 1024, 2048, 4096, 16384)))
              for m in rows for k in ks if not (m == cs.INT8_ATTENTION_ROWS and k > 2048)]
    dx = sorted({(m, n) for sites, _ in cs.INT8_SITES.values() for site, (_, n) in sites.items()
                 for m in (*cs.INT8_ROWS, cs.INT8_CHUNK_ROWS) + ((cs.INT8_ATTENTION_ROWS,) if site in ("q", "kv", "out") else ())})
    return shapes + [("dy·s", m, n, dtype) for m, n in dx for dtype in (bf16, f32)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose kai0_tpu_torch is run")
    parser.add_argument("--runs", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_row_quant.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # the shapes and the timing helper, from this checkout
    from scripts.time_int8_mm import _graph_ms

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from kai0_tpu_torch.ops import row_quant as rq  # the kernel, from --root

    one_launch = "col_scale" in inspect.signature(rq.row_quant).parameters
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; root {args.root}; column-scale mode {'in the kernel' if one_launch else 'absent'}")
    results = []
    for mode, m, k, dtype in _shapes(cs):
        g = torch.Generator(device="cuda").manual_seed(m + 3 * k + (mode == "dy·s") + 5 * (dtype == torch.float32))
        x = (torch.randn(m, k, generator=g, device="cuda") * 3).to(dtype)
        x[1] = 0
        c = 10.0 ** (torch.rand(k, generator=g, device="cuda") * 3 - 5) if mode == "dy·s" else None
        three = (lambda: rq.row_quant(x.to(torch.float32) * c)) if c is not None else None
        if c is None:
            kernel = lambda: rq.row_quant(x)  # noqa: E731
        else:
            kernel = (lambda: rq.row_quant(x, col_scale=c)) if one_launch else None
        xq, sx = (kernel or three)()
        row = {"mode": mode, "M": m, "K": k, "dtype": str(dtype)[6:], "codes_sha256": _digest(xq),
               "scales_sha256": _digest(sx), "bound_ms": _nbytes(x, xq, sx, *([] if c is None else [c])) / HBM_BYTES_PER_S * 1e3}
        if kernel is not None:
            row.update(ms=cs._cuda_ms(kernel, runs=args.runs), graph_ms=_graph_ms(kernel))
        if three is not None:
            row.update(three_launch_ms=cs._cuda_ms(three, runs=args.runs), three_launch_graph_ms=_graph_ms(three))
        results.append(row)
        print(f"{mode:5s} [{m:5d},{k:5d}] {row['dtype']:8s}: " + " ".join(
            f"{key}={row[key]:.4f}" for key in ("ms", "graph_ms", "three_launch_ms", "three_launch_graph_ms", "bound_ms")
            if key in row) + f" codes={row['codes_sha256']} scales={row['scales_sha256']}")
        del x, c, xq, sx
    print(json.dumps({"root": args.root, "card": card, "one_launch": one_launch, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
