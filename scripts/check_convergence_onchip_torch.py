"""Full-width convergence A/B of the port on the card: per-step loss trajectories of the shipped knob sets.

The port's ``scripts/check_convergence_onchip.py``: π₀.₅ at full width
(Gemma-2B + Gemma-300M, So400m/14), a fixed batch of ones, the step's draws
from (``--seed``, step). Four arms, as the JAX script defines them:

    # LoRA (r16 + r32) over a frozen int8 base, bf16 AdamW moments (the default)
    python3 scripts/check_convergence_onchip_torch.py --steps 300 --label int8 > conv_int8.json
    # LoRA over a bf16 base, f32 moments
    KAI0_BENCH_INT8=0 python3 scripts/check_convergence_onchip_torch.py --steps 300 --label bf16 > conv_bf16.json
    # full fine-tune: ClipSGD, bf16 parameters stochastically rounded, no EMA, SwitchBack on the Gemma FFN
    python3 scripts/check_convergence_onchip_torch.py --full-ft --steps 300 --label sb > conv_sb.json
    # the same with bf16 products
    KAI0_INT8_SB_GEMMA=0 python3 scripts/check_convergence_onchip_torch.py --full-ft --steps 300 \\
        --label fullft_bf16 > conv_fullft_bf16.json

    python3 scripts/check_convergence_onchip_torch.py --compare conv_sb.json conv_fullft_bf16.json

The full fine-tune's knobs come from ``kai0_tpu_torch/training/bench_defaults.py``
(the environment wins); the LoRA arms have none. Batch 12 by default, as in JAX. Losses stay on the
card and are read once a chunk (``--chunk`` steps); neither optimizer reads
anything back to the host within a step (``optimizer.clipper``). Progress and each chunk's ms a step go to stderr; the JSON line to
stdout also holds ``ms_per_step`` (one number a chunk, the first chunk's
including the first step's warm-up).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from scripts.check_convergence_torch import fixed_batch, start  # noqa: E402


def compare(path_a: str, path_b: str) -> int:
    """Relative loss differences of two runs' JSON (``check_convergence_onchip.py:42-68``, the same output)."""
    a, b = (json.load(open(p)) for p in (path_a, path_b))
    la, lb = a["losses"], b["losses"]
    n = min(len(la), len(lb))
    rel = [abs(x - y) / max(abs(y), 1e-9) for x, y in zip(la[:n], lb[:n])]
    tail = max(1, n // 10)
    print(
        json.dumps(
            {
                "a": a["label"],
                "b": b["label"],
                "steps": n,
                "max_rel_diff": round(max(rel), 5),
                "mean_rel_diff": round(sum(rel) / n, 5),
                "final_tail_mean": [
                    round(sum(la[n - tail : n]) / tail, 5),
                    round(sum(lb[n - tail : n]) / tail, 5),
                ],
                # Drift check: the relative difference over thirds (growing: drift).
                "rel_diff_by_third": [
                    round(sum(rel[i * n // 3 : (i + 1) * n // 3]) / max(n // 3, 1), 5)
                    for i in range(3)
                ],
            }
        )
    )
    return 0


def arm_config(*, full_ft: bool, batch: int, seed: int = 0, quantize: bool = True, opt_state: str | None = None,
               lr: float | None = None):
    """The arm's ``TrainConfig`` on ``debug``'s loop: ``full_ft`` trains every parameter of π₀.₅ in bf16 by ClipSGD
    with ``bench_defaults.FULLFT_KNOBS``; otherwise LoRA over a frozen base (int8 under ``quantize``) with AdamW
    moments in ``opt_state`` (None: f32). ``lr``: a constant learning rate in place of ``debug``'s schedule."""
    from kai0_tpu_torch.models import pi0 as _pi0
    from kai0_tpu_torch.training import bench_defaults
    from kai0_tpu_torch.training import config as _config
    from kai0_tpu_torch.training import optimizer as _optimizer

    base = _config.get_config("debug")
    common = dict(batch_size=batch, exp_name="convergence_onchip", ema_decay=None, seed=seed)
    if lr is not None:
        common["lr_schedule"] = _optimizer.CosineDecaySchedule(peak_lr=lr, decay_lr=lr, warmup_steps=0)
    if full_ft:
        return dataclasses.replace(base, model=_pi0.Pi0Config(pi05=True), param_dtype="bfloat16",
                                   optimizer=_optimizer.ClipSGD(), knobs=bench_defaults.FULLFT_KNOBS, **common)
    model = _pi0.Pi0Config(pi05=True, paligemma_variant="gemma_2b_lora", action_expert_variant="gemma_300m_lora")
    optimizer = _optimizer.AdamW(state_dtype=None if opt_state in (None, "float32") else opt_state)
    return dataclasses.replace(base, model=model, quantize_frozen=quantize, optimizer=optimizer, **common)


def run(config, steps: int, *, chunk: int = 50, device="cuda", log=None) -> tuple[list[float], list[float]]:
    """``steps`` train steps of ``config`` on a fixed batch of ones; (losses, ms a step of each chunk).

    The losses of a chunk are stacked on the card and read once at its end. ``log(done, losses, ms)`` is called
    after each chunk."""
    from kai0_tpu_torch.training import train_lib

    model, state = start(config, device=device)
    batch = fixed_batch(config.model, config.batch_size, model.device)
    losses, ms = [], []
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    for offset in range(0, steps, chunk):
        sync()
        t = time.perf_counter()
        pending = []
        for _ in range(min(chunk, steps - offset)):
            state, info = train_lib.train_step(model, state, batch, config)
            pending.append(info["loss"])
        losses.extend(torch.stack(pending).float().tolist())  # the chunk's one read
        ms.append((time.perf_counter() - t) * 1000 / len(pending))
        if log is not None:
            log(offset + len(pending), losses, ms[-1])
    del model, state
    return losses, ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--chunk", type=int, default=50, help="steps whose losses are read at once")
    p.add_argument("--batch", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--label", default="run")
    p.add_argument("--full-ft", action="store_true",
                   help="full fine-tune arms (every parameter trains, bf16 parameters, ClipSGD): the SwitchBack FFN "
                        "of bench_defaults.FULLFT_KNOBS against KAI0_INT8_SB_GEMMA=0")
    p.add_argument("--lr", type=float, default=None,
                   help="a constant learning rate in place of debug's schedule, which warms up over 1,000 steps to "
                        "2.5e-5 (not in the JAX script)")
    p.add_argument("--compare", nargs=2, metavar=("A.json", "B.json"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.compare:
        return compare(*args.compare)

    from kai0_tpu_torch import knobs as _knobs

    if args.full_ft:
        quantize, opt_state = False, "none (ClipSGD)"
        config = arm_config(full_ft=True, batch=args.batch, seed=args.seed, lr=args.lr)
    else:
        quantize = os.environ.get("KAI0_BENCH_INT8", "1").lower() not in ("0", "false", "off", "no", "")
        opt_state = os.environ.get("KAI0_BENCH_OPT_STATE", "bfloat16" if quantize else "float32")
        config = arm_config(full_ft=False, batch=args.batch, seed=args.seed, quantize=quantize, opt_state=opt_state,
                            lr=args.lr)
    knob_map = {k: v for k, v in dataclasses.asdict(_knobs.resolve(config.knobs)).items()
                if v != _knobs.DEFAULTS[k]}
    knob_map["quantize_frozen"] = config.quantize_frozen
    t0 = time.time()

    def log(done, losses, ms):
        print(f"steps {done}/{args.steps} loss={losses[-1]:.4f} {ms:.1f} ms a step ({time.time() - t0:.0f}s)",
              file=sys.stderr)

    losses, ms = run(config, args.steps, chunk=args.chunk, device=args.device, log=log)
    print(json.dumps({
        "label": args.label,
        "int8": quantize,
        "opt_state": opt_state,
        "batch": args.batch,
        "steps": args.steps,
        "lr": args.lr,
        "knobs": knob_map,
        "losses": [round(x, 6) for x in losses],
        "ms_per_step": [round(x, 3) for x in ms],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
