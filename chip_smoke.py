"""Drive the PyTorch port (kai0_tpu_torch) once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, none of which catches an error (any failure exits non-zero):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build both attention kernels from ``kai0_tpu_torch/ops/csrc`` with nvcc.
3. Hold each kernel against its plain PyTorch version at the serving shapes,
   in f32 and bf16: the Gemma prefill (T=S=968: 3x256 image tokens with one
   camera masked + 200 prompt tokens, 150 of them padding), the denoise step
   (T=50 against S=1018), and SigLIP ([3,16,256,72]). Inputs are unit normal,
   q scaled by head_dim**-0.5 as its callers do. Tolerances: max abs <= 1e-4 in
   f32; max abs <= 2e-2 and mean abs <= 2e-3 in bf16 (the kernel rounds the
   unnormalised softmax weights to bf16, the plain version the normalised ones).
   Times are CUDA-event medians of 30 runs after warm-up.
4. Serve 5 requests through ``Policy.infer`` with the full-width π₀.₅ model
   (Gemma-2B + Gemma-300M, So400m/14, bf16, seeded random weights) at batch 1,
   counting kernel launches per request (27 flash_mhsa, 198 flash_mha), and
   check the actions: (50, 32) per request, finite, identical for identical
   noise and different for other noise.
5. Reference at full width: the same architecture in f32 samples one chunk on
   the card (kernels) and on the host CPU (plain versions) from the same
   weights and noise; the two must agree within 1e-3.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REQUESTS = 5
TOL = {"float32": {"max": 1e-4}, "bfloat16": {"max": 2e-2, "mean": 2e-3}}
FULL_WIDTH_TOL = 1e-3


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _cuda_ms(fn, runs: int = 30) -> float:
    for _ in range(3):
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


def _prefix_mask(prompt_used: int = 50):
    """Serving prefix validity: 3 cameras x 256 tokens (the third masked) + 200 prompt tokens."""
    mask = torch.ones(1, 968, dtype=torch.bool, device="cuda")
    mask[:, 512:768] = False
    mask[:, 768 + prompt_used :] = False
    return mask


def check_kernels() -> dict:
    from kai0_tpu_torch.ops import flash_attention as fa
    from kai0_tpu_torch.ops.masks import make_attn_mask

    prefix = _prefix_mask()
    prefill_mask = make_attn_mask(prefix, torch.zeros(968, dtype=torch.bool, device="cuda"))
    suffix = torch.ones(1, 50, dtype=torch.bool, device="cuda")
    denoise_mask = torch.cat(
        [
            prefix[:, None, :].expand(1, 50, 968),
            make_attn_mask(suffix, torch.tensor([True] + [False] * 49, device="cuda")),
        ],
        dim=-1,
    ).contiguous()
    _check((~prefill_mask).all(dim=-1).sum() == 256 + 150, "prefill mask should have fully masked rows")

    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)

    cases = [
        ("flash_mha", "prefill T=S=968", (normal(1, 968, 8, 256) / 16, normal(1, 968, 1, 256), normal(1, 968, 1, 256)), prefill_mask),
        ("flash_mha", "denoise T=50 S=1018", (normal(1, 50, 8, 256) / 16, normal(1, 1018, 1, 256), normal(1, 1018, 1, 256)), denoise_mask),
        ("flash_mhsa", "siglip [3,16,256,72]", (normal(3, 16, 256, 72) / 72**0.5, normal(3, 16, 256, 72), normal(3, 16, 256, 72)), None),
    ]
    record = {}
    for name, label, qkv, mask in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in qkv)
            if name == "flash_mha":
                kernel = lambda: fa.flash_mha_fwd(q, k, v, mask)  # noqa: E731
                plain = lambda: fa.flash_mha_plain(q, k, v, mask)  # noqa: E731
            else:
                kernel = lambda: fa.flash_mhsa_fwd(q, k, v)  # noqa: E731
                plain = lambda: fa.flash_mhsa_plain(q, k, v)  # noqa: E731
            out, lse = kernel()
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            tol = TOL[str(dtype).removeprefix("torch.")]
            _check(torch.isfinite(out).all() and torch.isfinite(lse).all(), f"{name} {label}: non-finite output")
            _check(max_err <= tol["max"], f"{name} {label} {dtype}: max abs err {max_err} > {tol['max']}")
            _check(mean_err <= tol.get("mean", float("inf")), f"{name} {label} {dtype}: mean abs err {mean_err}")
            ms, plain_ms = _cuda_ms(kernel), _cuda_ms(plain)
            print(
                f"kernel {name} {label} {str(dtype)[6:]}: max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
            )
            if dtype == torch.bfloat16:
                entry = record.setdefault(name, {"max_abs_err": 0.0, "ms": None, "plain_ms": None})
                entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
                if entry["ms"] is None:  # the first (prefill / SigLIP) shape is the one recorded
                    entry["ms"], entry["plain_ms"] = ms, plain_ms
    return record


def _request_inputs(rng: np.random.Generator) -> dict:
    keys = ("base_0_rgb", "left_wrist_0_rgb", "right_wrist_0_rgb")
    mask = np.zeros(200, bool)
    mask[:50] = True
    return {
        "image": {k: rng.integers(0, 256, (224, 224, 3), dtype=np.uint8) for k in keys},
        "image_mask": {k: np.bool_(k != "right_wrist_0_rgb") for k in keys},
        "state": rng.standard_normal(32).astype(np.float32),
        "tokenized_prompt": rng.integers(0, 257_152, 200, dtype=np.int32),
        "tokenized_prompt_mask": mask,
    }


def serve() -> dict:
    from kai0_tpu_torch.models.pi0 import Pi0, Pi0Config
    from kai0_tpu_torch.ops import flash_attention as fa
    from kai0_tpu_torch.policies.policy import Policy

    config = Pi0Config(pi05=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = Pi0(config, device="cuda", param_dtype=torch.bfloat16).init_weights(gen).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: pi05 {config.paligemma_variant}+{config.action_expert_variant} {config.vision_variant} "
          f"{config.dtype}, {n_params / 1e9:.3f}B params, built in {time.perf_counter() - t0:.1f}s")
    policy = Policy(model, config, device="cuda", generator=gen)

    rng = np.random.default_rng(0)
    obs = _request_inputs(rng)
    noises = [rng.standard_normal((50, 32)).astype(np.float32) for _ in range(2)]
    plan = [0] * (REQUESTS - 1) + [1]  # noise index per request: repeats, then other noise

    fa.reset_launches()
    actions, per_request = [], []
    for i, noise_idx in enumerate(plan):
        before = dict(fa.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs, noise=noises[noise_idx])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1000
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        print(f"request {i}: wall_ms={wall_ms:.2f} infer_ms={out['policy_timing']['infer_ms']:.2f} "
              f"peak_mem_gib={peak_gib:.3f} launches={launches}")
        _check(launches == {"flash_mhsa": 27, "flash_mha": 18 + 10 * 18}, f"request {i}: launches {launches}")
        a = out["actions"]
        _check(a.shape == (50, 32) and a.dtype == np.float32, f"actions {a.shape} {a.dtype}")
        _check(np.isfinite(a).all(), "non-finite actions")
        actions.append(a)
        per_request.append(wall_ms)
    main_path_launches = dict(fa.LAUNCHES)
    for i in (1, 2, 3):
        _check(np.array_equal(actions[i], actions[0]), f"request {i}: same noise, different actions")
    _check(not np.array_equal(actions[4], actions[0]), "other noise gave the same actions")
    _check(np.abs(actions[0] - noises[0]).max() > 1e-2, "actions did not move from the noise")
    print(f"serving: median wall_ms={statistics.median(per_request[1:]):.2f} over requests 1-{REQUESTS - 1} "
          f"{[round(x, 2) for x in per_request[1:]]} (request 0 includes first-use set-up)")
    del policy, model
    torch.cuda.empty_cache()
    return main_path_launches


def full_width_reference() -> None:
    from kai0_tpu_torch.models.pi0 import Pi0, Pi0Config
    from kai0_tpu_torch.policies.policy import Policy

    config = Pi0Config(pi05=True, dtype="float32")
    model = Pi0(config, device="cuda", param_dtype=torch.float32).init_weights(
        torch.Generator(device="cuda").manual_seed(1)
    ).eval()
    rng = np.random.default_rng(1)
    obs = _request_inputs(rng)
    noise = rng.standard_normal((50, 32)).astype(np.float32)
    on_card = Policy(model, config, device="cuda").infer(obs, noise=noise)
    model.to("cpu")
    torch.cuda.empty_cache()
    on_host = Policy(model, config, device="cpu").infer(obs, noise=noise)
    err = float(np.abs(on_card["actions"] - on_host["actions"]).max())
    print(f"full-width f32 reference: card (kernels) vs host CPU (plain) max_abs_err={err:.3e} "
          f"(|actions| max {np.abs(on_host['actions']).max():.3f}; card {on_card['policy_timing']['infer_ms']:.1f} ms, "
          f"host {on_host['policy_timing']['infer_ms']:.1f} ms)")
    _check(np.isfinite(on_card["actions"]).all() and err <= FULL_WIDTH_TOL, f"full-width f32 mismatch {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; the port runs only on a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from kai0_tpu_torch.ops import _build

    t = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"build: {path.name} in {time.perf_counter() - t:.2f}s (nvcc {_build.build_seconds}s)")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    record = check_kernels()
    launches = serve()
    full_width_reference()

    sources = {
        "flash_mha": ("kai0_tpu_torch/ops/csrc/flash_mqa_fwd.cu", "kai0_tpu/ops/pallas_attention.py:109"),
        "flash_mhsa": ("kai0_tpu_torch/ops/csrc/flash_mhsa_fwd.cu", "kai0_tpu/ops/pallas_attention.py:419"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        _check(launches[name] > 0, f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], **record[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
