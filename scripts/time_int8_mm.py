"""Time K4b and K4a (``int8_matmul``, ``int8_matmul_lora`` on one CUDA card) at the shapes the int8 paths launch.

    python3 scripts/time_int8_mm.py [--root DIR] [--runs 20]

Each row is one product of a path: int8 serving's denoise steps (M = 50, the
action expert's six products) and prefill (M = 968, Gemma-2B's six), the
batch-32 LoRA + int8 step's forward products (K4a on the fused FFN's row chunks
of 7,744 and 1,600 rows, K4b at the attention sites) and its ``dx`` products
(the ``nn`` orientation), and Gemma-2B's down at M = 50, which no path launches
(kept to compare with earlier records). Operands come from a CUDA generator
seeded by the shape. For each row it prints the SHA-256 digest of the bf16
output's bytes, the kernel's CUDA-event median over ``--runs`` launches
(``chip_smoke.py``'s timing, which at these sizes includes the host's launch
time), the device time of one launch among 20 captured back to back in a CUDA
graph (``graph_ms``: no host in it), both also for one ``torch._int_mm`` call
followed by the scaling (and the LoRA add for K4a) on the same inputs, a
yardstick that the port never calls, the bound (the larger of the int8 operations over
1,979 TOP/s and each operand read once and the output written once over
3.35 TB/s) and TOP/s. ``--root`` imports ``kai0_tpu_torch`` from another
checkout (for example the parent commit unpacked with ``git archive``), so two
trees can be timed in turns in one call and held bit for bit by their digests.
The last line is one JSON object with every row.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
# (path, site, M, K, N, orientation, LoRA rank or 0). nt: w is the stored [N, K] weight; nn: w is [K, N] (the
# backward's dx over the stored [out, in] weight, contracted on its leading axis).
_DENOISE = {"q": (1024, 2048), "kv": (1024, 512), "out": (2048, 1024), "gate/up": (1024, 4096), "down": (4096, 1024)}
_PREFILL = {"q": (2048, 2048), "kv": (2048, 512), "out": (2048, 2048), "gate/up": (2048, 16384), "down": (16384, 2048)}
ROWS = (
    *(("serving denoise", site, 50, k, n, "nt", 0) for site, (k, n) in _DENOISE.items()),
    *(("serving prefill", site, 968, k, n, "nt", 0) for site, (k, n) in _PREFILL.items()),
    ("lora step K4a", "gemma_2b gate/up", 7744, 2048, 16384, "nt", 16),
    ("lora step K4a", "gemma_2b down", 7744, 16384, 2048, "nt", 16),
    ("lora step K4a", "gemma_300m gate/up", 1600, 1024, 4096, "nt", 32),
    ("lora step K4a", "gemma_300m down", 1600, 4096, 1024, "nt", 32),
    *(("lora step attention", f"gemma_2b {site}", 30976, *_PREFILL[site], "nt", 0) for site in ("q", "kv", "out")),
    *(("lora step attention", f"gemma_300m {site}", 1600, *_DENOISE[site], "nt", 0) for site in ("q", "kv", "out")),
    ("lora step dx", "gemma_2b gate/up", 7744, 16384, 2048, "nn", 0),
    ("lora step dx", "gemma_2b down", 7744, 2048, 16384, "nn", 0),
    ("lora step dx", "gemma_2b q", 30976, 2048, 2048, "nn", 0),
    ("lora step dx", "gemma_300m gate/up", 1600, 4096, 1024, "nn", 0),
    ("lora step dx", "gemma_300m down", 1600, 1024, 4096, "nn", 0),
    ("no path", "gemma_2b down", 50, 16384, 2048, "nt", 0),
)
PEAK_INT8, PEAK_BF16, HBM_BYTES_PER_S = 1979e12, 989e12, 3.35e12


def _graph_ms(fn, calls: int = 20, runs: int = 10) -> float:
    """Median device ms of one call among ``calls`` captured back to back in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose kai0_tpu_torch is run")
    parser.add_argument("--runs", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_int8_mm.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # the timing helper, from this checkout

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from kai0_tpu_torch.ops import int8_matmul as mm  # the kernel, from --root

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; root {args.root}")
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    for path, site, m, k, n, orient, rank in ROWS:
        g = torch.Generator(device="cuda").manual_seed(m + 3 * k + 7 * n + rank + (orient == "nn"))
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k) if orient == "nt" else (k, n), generator=g, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, 1, generator=g, device="cuda") * 1e-2 + 1e-4
        sn = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-5 if orient == "nt" else None
        if rank:
            u = torch.randn(m, rank, generator=g, device="cuda").to(bf16)
            b = (torch.randn(rank, n, generator=g, device="cuda") * 0.05).to(bf16)
            kernel = lambda: mm.int8_matmul_lora(xq, w, sx, sn, u, b)  # noqa: E731
            library = lambda: (torch._int_mm(xq, w.T).to(f32) * sx * sn + (u @ b).to(f32)).to(bf16)  # noqa: E731
            operands = (xq, w, sx, sn, u, b)
        elif orient == "nt":
            kernel = lambda: mm.int8_matmul(xq, w, sx, sn, nt=True)  # noqa: E731
            library = lambda: (torch._int_mm(xq, w.T).to(f32) * sx * sn).to(bf16)  # noqa: E731
            operands = (xq, w, sx, sn)
        else:
            kernel = lambda: mm.int8_matmul(xq, w, sx, None, nt=False)  # noqa: E731
            library = lambda: (torch._int_mm(xq, w).to(f32) * sx).to(bf16)  # noqa: E731
            operands = (xq, w, sx)
        out = kernel()
        digest = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        ms, lib_ms = cs._cuda_ms(kernel, runs=args.runs), cs._cuda_ms(library, runs=args.runs)
        graph_ms, lib_graph_ms = _graph_ms(kernel), _graph_ms(library)
        ops_s = 2 * m * n * k / PEAK_INT8 + 2 * m * n * rank / PEAK_BF16
        bytes_s = _nbytes(*operands, out) / HBM_BYTES_PER_S
        row = {"path": path, "site": site, "kernel": "int8_matmul_lora" if rank else "int8_matmul", "orient": orient,
               "M": m, "K": k, "N": n, "rank": rank, "sha256": digest, "ms": ms, "library_ms": lib_ms,
               "graph_ms": graph_ms, "library_graph_ms": lib_graph_ms,
               "bound_ms": max(ops_s, bytes_s) * 1e3, "bound_by": "operations" if ops_s >= bytes_s else "bytes",
               "top_s": 2 * m * n * k / ms / 1e9}
        rows.append(row)
        print(f"{path:20s} {site:20s} {row['kernel']:16s} {orient} M={m:5d} K={k:5d} N={n:5d} r={rank:2d}: "
              f"kernel_ms={ms:.4f} library_ms={lib_ms:.4f} graph_ms={graph_ms:.4f} library_graph_ms={lib_graph_ms:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"{row['top_s']:.1f} TOP/s ({2 * m * n * k / graph_ms / 1e9:.1f} in the graph) sha256={digest}")
        del xq, w, sx, sn, out
    print(json.dumps({"root": args.root, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
