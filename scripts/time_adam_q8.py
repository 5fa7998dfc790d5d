"""Time K3, the fused 8-bit AdamW kernel, on one CUDA card: one tensor, and every tensor of a full-width step.

    python3 scripts/time_adam_q8.py [--root DIR] [--runs 10]

The tensors are those of the full-width π₀.₅ (``Pi0(Pi0Config(pi05=True))``,
built on the meta device: 811 tensors, 3.353 B elements) with bf16 gradients
and int8 moments, as the full fine-tune's step hands them to the optimizer.
Gradients, codes and scales come from a CUDA generator seeded with 0, so every
code value is in use. Rows:

- ``leaf``: Gemma-2B's FFN tensor [2048, 16384] alone, by the per-tensor
  kernel (``adam_q8_leaf``) and, where the checkout has it, by the
  all-tensors kernel (``adam_q8_leaves``) on that one tensor;
- ``step``: every tensor, by the per-tensor kernel launched once a tensor
  (the optimizer's earlier path) and by the all-tensors kernel in one
  launch (where the checkout has it), in stochastic and deterministic mode.

Beside them, ``copy``: one device copy of as many bytes as K3 reads (and so
writes), a yardstick of what moving its bytes takes on this card.

For each row: ``ms``, the CUDA-event median over ``--runs`` calls (the host's
launches included: 811 of them for the per-tensor step), ``device_ms``, the
summed device time of the kernel launches of one call under torch.profiler,
``launches``, the bound (each input read once and each output written once
over 3.35 TB/s: the gradient, the update, the codes and the scales read and
written), and a digest of the updates, codes and scales after one call from the
seeded state (SHA-256 over a weighted byte sum of each tensor, computed on the
card), so that two checkouts and two kernels can be held bit for bit; in one
checkout the two kernels' outputs are also compared with ``torch.equal``.
``--root`` imports ``kai0_tpu_torch`` from another checkout (for example the
parent commit unpacked with ``git archive``). The last line is one JSON object
with every row.
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
HBM_BYTES_PER_S = 3.35e12
B1, B2, A, B = 0.9, 0.95, 1.7, 2e-8


def _events_ms(fn, runs: int) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn) -> tuple[float, int]:
    """Summed device time (ms) and count of the AdamW kernel launches of one call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "adam_q8" in e.name]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1000, len(kernels)


def _fingerprint(tensors) -> str:
    """SHA-256 over a position-weighted sum of each tensor's bytes, the sums taken on the card."""
    sums = []
    for t in tensors:
        raw = t.contiguous().view(-1).view(torch.uint8)
        for chunk in raw.split(1 << 26):
            weights = torch.arange(chunk.numel(), device=chunk.device, dtype=torch.int32) % 65521 + 1
            sums.append(int((chunk.to(torch.int32) * weights).sum(dtype=torch.int64)))
    return hashlib.sha256(json.dumps(sums).encode()).hexdigest()[:16]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose kai0_tpu_torch is run")
    parser.add_argument("--runs", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from kai0_tpu_torch.models.pi0 import Pi0, Pi0Config
    from kai0_tpu_torch.ops import adam_q8 as q8

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; root {args.root}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = [tuple(p.shape) for p in Pi0(Pi0Config(pi05=True), device="meta", param_dtype=torch.bfloat16).parameters()]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def tensors(shape_list):
        gs = [(torch.randn(s, generator=gen, device="cuda") * 1e-3).bfloat16() for s in shape_list]
        state = []
        for s in shape_list:
            blocks = q8.num_blocks(torch.Size(s).numel())
            state.append([
                torch.randint(-127, 128, s, generator=gen, device="cuda", dtype=torch.int8),
                torch.rand(blocks, generator=gen, device="cuda") * 1e-3,
                torch.randint(0, 256, s, generator=gen, device="cuda", dtype=torch.uint8),
                torch.rand(blocks, generator=gen, device="cuda") * 1e-6,
            ])
        return gs, state

    has_leaves = hasattr(q8, "adam_q8_leaves")
    rows = []
    for label, shape_list in (("leaf [2048,16384]", [(2048, 16384)]), (f"step ({len(shapes)} tensors)", shapes)):
        gs, initial = tensors(shape_list)
        seeds = torch.randint(0, 2**31 - 1, (len(gs),), generator=gen, device="cuda").tolist()
        nbytes = sum(2 * g.numel() * g.element_size() + 2 * sum(x.numel() * x.element_size() for x in st)
                     for g, st in zip(gs, initial))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        work = [[x.clone() for x in st] for st in initial]  # timed calls keep updating this copy in place

        def per_tensor(state, deterministic):
            return [q8.adam_q8_leaf(g, *st, A, B, seed, b1=B1, b2=B2, deterministic=deterministic)
                    for g, st, seed in zip(gs, state, seeds)]

        def all_tensors(state, deterministic):
            return q8.adam_q8_leaves(gs, *([st[i] for st in state] for i in range(4)), A, B, seeds, b1=B1, b2=B2,
                                     deterministic=deterministic)

        kernels = {"per-tensor": per_tensor, **({"all-tensors": all_tensors} if has_leaves else {})}
        outputs = {}
        for deterministic in (False, True):
            for name, fn in kernels.items():
                state = [[x.clone() for x in st] for st in initial]
                outs = fn(state, deterministic)
                torch.cuda.synchronize()
                digest = _fingerprint([*outs, *(x for st in state for x in st)])
                outputs[(name, deterministic)] = (outs, state)
                ms = _events_ms(lambda fn=fn: fn(work, deterministic), args.runs)
                device_ms, launches = _device_ms(lambda fn=fn: fn(work, deterministic))
                row = {"row": label, "kernel": name, "mode": "deterministic" if deterministic else "stochastic",
                       "ms": round(ms, 4), "device_ms": round(device_ms, 4), "launches": launches,
                       "bound_ms": round(bound_ms, 4), "bytes": nbytes, "digest": digest}
                rows.append(row)
                print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
            if has_leaves:
                (a_outs, a_state), (b_outs, b_state) = outputs[("per-tensor", deterministic)], outputs[("all-tensors", deterministic)]
                same = all(torch.equal(x, y) for x, y in zip(a_outs, b_outs)) and all(
                    torch.equal(x, y) for sa, sb in zip(a_state, b_state) for x, y in zip(sa, sb))
                print(f"{label} {'deterministic' if deterministic else 'stochastic'}: all-tensors kernel bit-equal to "
                      f"the per-tensor kernel: {same}", flush=True)
                rows.append({"row": label, "mode": "deterministic" if deterministic else "stochastic", "bit_equal": same})
            outputs.clear()
            torch.cuda.empty_cache()
        del gs, initial, work
        torch.cuda.empty_cache()
        src_bytes = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
        dst_bytes = torch.empty_like(src_bytes)
        copy_ms = _events_ms(lambda: dst_bytes.copy_(src_bytes), args.runs)
        row = {"row": label, "kernel": "copy", "ms": round(copy_ms, 4), "bytes": nbytes, "bound_ms": round(bound_ms, 4)}
        rows.append(row)
        print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        del src_bytes, dst_bytes
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "root": args.root, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
