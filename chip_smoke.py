"""Drive the PyTorch port (kai0_tpu_torch) once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, none of which catches an error (any failure exits non-zero):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build all eight kernels from ``kai0_tpu_torch/ops/csrc`` with nvcc (one
   process per source, all started together).
3. Hold each forward kernel against its plain PyTorch version at the serving
   shapes, in f32 and bf16: the Gemma prefill (T=S=968: 3x256 image tokens with
   one camera masked + 200 prompt tokens, 150 of them padding), the denoise
   step (T=50 against S=1018), and SigLIP ([3,16,256,72]). Inputs are unit
   normal, q scaled by head_dim**-0.5 as its callers do. Tolerances: max abs
   <= 1e-4 in f32; max abs <= 2e-2 and mean abs <= 2e-3 in bf16 (the kernel
   rounds the unnormalised softmax weights to bf16, the plain version the
   normalised ones). Times are CUDA-event medians of 30 runs after warm-up,
   beside ``scaled_dot_product_attention`` on the same inputs (a yardstick the
   port never calls; its fully masked rows differ).
4. Serve 5 requests through ``Policy.infer`` with the full-width π₀.₅ model
   (Gemma-2B + Gemma-300M, So400m/14, bf16, seeded random weights) at batch 1,
   counting kernel launches per request (27 flash_mhsa, 198 flash_mha), and
   check the actions: (50, 32) per request, finite, identical for identical
   noise and different for other noise. The 5 requests are then served a
   second time (same actions required), to show the spread of the host-bound
   wall time within one run.
5. Reference at full width: the same architecture in f32 samples one chunk on
   the card (kernels) and on the host CPU (plain versions) from the same
   weights and noise; the two must agree within 1e-3. The same weights rounded
   to bf16 sample the chunk on the card through the tensor-core K1 and K2; its
   actions must lie within 0.1 x max |actions| (max abs) and 0.02 x mean
   |actions| (mean abs) of the f32 host's (the reason is in
   ``full_width_reference``).
6. Attention at the training shapes, forward and backward kernels against the
   plain version and its autograd: MQA at T=S=1018 with the training mask
   (3x256 image tokens, one camera masked in one sample, 200 prompt tokens with
   padding, 50 action tokens behind the ar mask) at B=2 in f32 and bf16 and at
   B=32 (the main path's batch) in bf16; SigLIP at [6,16,256,72] in f32 and
   bf16 and at [96,16,256,72] (batch 32 x 3 cameras) in bf16; the bf16 kernels
   run on the tensor cores. Unit-normal inputs and a unit-normal dO that is
   non-zero on the fully masked rows. Tolerances as in phase 3 for the forward;
   per gradient: max abs <= 1e-4 x max |grad| in f32, <= 2e-2 x max |grad| in
   bf16; in bf16 two backward calls must give the same bits. Times beside SDPA
   forward and forward+backward and the bound.
7. The 8-bit AdamW kernel. The per-tensor kernel on a [2048, 16384] bf16 leaf
   (Gemma-2B's FFN) with moments from two earlier steps. Deterministic mode:
   scales bit-equal, codes within 1 on at most 1e-5 of the elements, update
   within 1e-6 relative. Stochastic mode: the first moment decoded after each
   of 64 seeds, averaged, is within 3e-3 of the exact f32 moment in mean signed
   relative error (the log grid's own bias is at most cosh(step/2) - 1 =
   2.0e-3). Then the kernel the optimizer launches, one launch over every
   tensor of the full-width π₀.₅ (811 tensors, bf16 gradients, moments from two
   earlier steps): bit-equal to the per-tensor kernel in both modes, and held
   to the plain version as above in deterministic mode.
8. Gradients of the model at full width, depth cut to 2 (both Gemma experts
   and SigLIP), f32, batch 2, fixed noise, time and augmentation: the card
   (kernels) and the host CPU (plain versions) give every parameter gradient
   within 1e-3 x that tensor's max abs (at least 1e-6 x the largest gradient:
   softmax cancels the gradient of SigLIP's key bias, which is rounding noise
   in both), and every parameter group (SigLIP,
   Gemma-2B, the action expert, the projections) gets a non-zero gradient.
9. The main path: 5 full fine-tune steps of π₀.₅ at full width on one card
   at batch 32, bf16 parameters with stochastically rounded updates, 8-bit
   AdamW moments, no EMA, per-block recompute, augmentation on, the default
   cosine schedule, on seeded synthetic batches. Per step: wall ms between synchronizes,
   samples/s, loss, grad_norm, peak GiB, launches (36/18 flash_mha
   forward/backward, 54/27 flash_mhsa, one adam_q8 over all 811 parameter
   tensors).
   A second run from the same seed must give identical losses; its last step
   runs under torch.profiler for device time by kernel family, and must launch
   none of the scalar attention kernels (they serve f32 only).

10. The int8 kernels against their plain versions at the full-width shapes of
    the int8 paths, every (K, N) of both experts (q, the joint kv, out,
    gate/up, down of Gemma-2B and Gemma-300M) against M = 50 and 968 (int8
    serving), 2 x 968 (phase 12) and the rows phase 13 launches at batch 32:
    1,600 (the action expert), 7,744 (a row chunk of Gemma-2B's fused FFN) and,
    at the attention sites, which are not chunked, 30,976.
    K5 (``row_quant``; bf16 and f32 rows, and with a column scale the
    backward's ``dy·s`` from bf16 and f32 ``dy`` at every ``dx`` shape, timed
    beside the cast, multiply and K5 it replaces) and
    K4b (``int8_matmul``; the forward orientation with both scales, the
    backward's orientation with the row scale only; bf16 and f32 outputs) are
    held bit-equal. K4a (``int8_matmul_lora``; rank 16 or 32, and rank 64 on
    Gemma-2B's gate/up at 7,744 rows) sums its rank-r
    term in another order than the plain version's library product: at most
    1e-3 of the bf16 outputs differ, each by at most 2^-7 x max(|y|, |term|)
    (one bf16 step of the term); f32 within 1e-5 x max |y|. Times beside the
    bound (the larger of the int8 operations over 1,979 TOP/s and the bytes over
    3.35 TB/s; bytes only for K5) and, for K4b and K4a, ``torch._int_mm``
    followed by the scaling (and the separate LoRA add), a yardstick the port
    never calls. Both orientations reach the ``wgmma`` kernel at every row
    count above 64; the forward orientation the split-contraction kernel at
    M = 50 and the backward's the ``mma.sync`` tiles there.
11. int8 serving: the model of phase 4 with ``quantize_inference_tree`` applied
    serves the same 5 requests; per request 990 ``row_quant`` and 1188
    ``int8_matmul`` launches (18 layers x (1 prefill + 10 denoise steps) x 5
    row quantizations and 6 products), none of ``int8_matmul_lora``. The actions
    are compared with the bf16 model's on the same weights and noise, and the
    difference printed (int8 perturbs the actions by design). A sixth request
    runs under torch.profiler: its 108 prefill products must run on the
    ``wgmma`` kernel and its 1,080 denoise products on the split-contraction
    kernel, none on the ``mma.sync`` tiles.
12. The LoRA fine-tune over a frozen int8 base at full width, depth cut to 2,
    f32 activations, batch 2, fixed draws: the card (kernels) against the host
    CPU (plain versions) on the same codes. Card and host differ by f32
    rounding, which flips an activation code now and then, so the loss is held
    to 5e-4 and every trainable gradient (LoRA factors, SigLIP, projections) to
    3e-2 x its max abs and 2e-2 in L2.
13. The int8 main path: 5 steps of the LoRA fine-tune of π₀.₅ at full width
    (``gemma_2b_lora`` rank 16 + ``gemma_300m_lora`` rank 32) over a frozen int8
    base at batch 32: trainable leaves (LoRA factors, SigLIP, projections) in
    f32 with bf16 AdamW moments, no EMA, per-block recompute, augmentation on,
    the batches of phase 9. Per step: wall ms, samples/s, loss, grad_norm, peak
    GiB and the launches of all kernels (asserted against the counts worked out
    from the code). The frozen leaves, codes and scales must be bit-identical
    after the steps and the optimizer state must cover the trainable leaves
    only. A second run from the same seed must give identical losses; its last
    step runs under torch.profiler, whose int8 kernels must be the ``wgmma``
    kernel in the forward orientation for every forward product (K4a, and K4b
    at the attention sites) and in the backward's orientation for every ``dx``,
    and every K5 launch must be its register kernel, with the column scale for
    each ``dx`` (365 a step).

Build: ptxas's register and spill lines of every kernel are printed; the
tensor-core attention kernels, the ``wgmma`` and split int8 kernels, the
all-tensors AdamW kernel and K5's register kernel must not spill.

The line before the last is the kernels' JSON record: times in bf16, the
attention kernels at phase 6's shapes (K1f/K1b at batch 32 and K2f/K2b at
[96,16,256,72], with the batch-2 numbers under the same keys suffixed ``_b2``),
the AdamW kernel over all tensors of phase 7 (``ms`` its one launch on a table
built beforehand, ``ms_call`` the call with the host's table, and
``ms_per_tensor_kernel`` the 811 calls of the per-tensor kernel; its [2048, 16384]
leaf under keys suffixed ``_leaf``), the int8 kernels at shapes phase 13 launches (K5
on a [7744, 16384] bf16 chunk, and as ``row_quant_colscale`` on the gate/up ``dx``'s bf16
``dy·s`` of that chunk, with the three launches it replaced, K4a the gate/up product of that chunk, rank 64
under keys suffixed ``_r64``, K4b its ``dx``, and K4b on the action expert's down in a denoise step, M = 50,
under keys suffixed ``_m50``: int8 serving's split-contraction kernel);
``launches`` from the first 5-step run of the path that runs the kernel: phase
9 for the attention and AdamW kernels, phase 13 for the int8 ones. The last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REQUESTS = 5
TRAIN_STEPS = 5
TRAIN_BATCH = 32  # per card: kai0's fine-tunes run a global batch of 256 on 8 cards
TOL = {"float32": {"max": 1e-4}, "bfloat16": {"max": 2e-2, "mean": 2e-3}}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FULL_WIDTH_TOL = 1e-3
BF16_SAMPLE_TOL = {"max": 0.1, "mean": 0.02}  # x max / mean |actions| of the f32 host (phase 5's docstring)
MODEL_GRAD_TOL = 1e-3
Q8_BIAS_TOL = 3e-3
LORA_FLIP_SHARE = 1e-3  # K4a: share of bf16 outputs that may differ from the plain version
INT8_LOSS_TOL, INT8_GRAD_TOL, INT8_GRAD_L2_TOL = 5e-4, 3e-2, 2e-2  # card vs host with activation-code flips
# Rows of the int8 kernels' operands: int8 serving and the depth-2 gradient check; then what the batch-32 LoRA step
# launches (the action expert's 32 x 50 rows, a chunk of Gemma-2B's fused FFN, the unchunked attention sites).
INT8_ROWS, INT8_CHUNK_ROWS, INT8_ATTENTION_ROWS = (50, 968, 2 * 968, TRAIN_BATCH * 50), TRAIN_BATCH * 968 // 4, TRAIN_BATCH * 968
INT8_REQUEST_LAUNCHES = {"row_quant": 18 * 11 * 5, "int8_matmul": 18 * 11 * 6, "int8_matmul_lora": 0}
# (K, N) of the quantized products of one layer: Gemma-2B, then the Gemma-300M action expert; LoRA rank.
INT8_SITES = {
    "gemma_2b": ({"q": (2048, 2048), "kv": (2048, 512), "out": (2048, 2048), "gate/up": (2048, 16384),
                  "down": (16384, 2048)}, 16),
    "gemma_300m": ({"q": (1024, 2048), "kv": (1024, 512), "out": (2048, 1024), "gate/up": (1024, 4096),
                    "down": (4096, 1024)}, 32),
}

# Kernels whose ptxas report must show no spills: the tensor-core attention kernels, the int8 kernels of
# int8_mm_wgmma.cuh (both orientations), the all-tensors AdamW kernel and K5's register kernel.
SPILL_FREE_KERNELS = ("mqa_mma", "mhsa_mma", "int8_mm_wgmma_kernel", "int8_mm_splitk_kernel", "adam_q8_leaves_kernel",
                      "row_quant_regs_kernel")
# The scalar-FMA attention kernels (flash_fwd.cuh, flash_bwd.cuh but its delta pass): f32 only.
SCALAR_ATTENTION_KERNELS = ("flash_fwd_partial", "flash_fwd_combine", "flash_bwd_dkdv", "flash_bwd_dq")

# NVIDIA's data-sheet peaks of the H100 SXM at 700 W (dense).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
HBM_BYTES_PER_S = 3.35e12
Q8_OPS_PER_ELEMENT = 40  # f32 operations of decode, recurrence, update, absmax and encode
# Model FLOP of one π₀.₅ training sample, forward + backward without recompute
# (scripts/bench_full_finetune.py ANALYTIC_MODEL_FLOPS_PER_SAMPLE["full"]).
MODEL_FLOPS_PER_SAMPLE = 13.8e12


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


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(flops: float, nbytes: int, dtype: torch.dtype) -> tuple[float, str]:
    """The least time (ms) for the work on one H100, and which of operations or bytes sets it."""
    ops_s, bytes_s = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _mqa_flops(mask: torch.Tensor, n: int, h: int, products: int) -> int:
    """Operations of masked MQA with n heads of h: 2·n·h per product per (query row, unmasked key).

    A fully masked row adds the mean of V over its S keys (2·n·h·S). The forward
    has 2 products (QKᵀ, PV), the backward 5 (QKᵀ, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q).
    """
    pairs = mask.sum().item()
    dead = (~mask.any(dim=-1)).sum().item()
    return 2 * n * h * (products * pairs + mask.shape[-1] * dead)


def _prefix_mask(prompt_used: int = 50):
    """Serving prefix validity: 3 cameras x 256 tokens (the third masked) + 200 prompt tokens."""
    mask = torch.ones(1, 968, dtype=torch.bool, device="cuda")
    mask[:, 512:768] = False
    mask[:, 768 + prompt_used :] = False
    return mask


def _sdpa(q, k, v, mask=None, dout=None):
    """One ``scaled_dot_product_attention`` call on the kernels' inputs: forward, or forward+backward with ``dout``.

    With a mask, q is the MQA layout [B,T,N,H] and k/v [B,S,1,H] are expanded to
    the N query heads; without one, q/k/v are head-major [B,N,T,H]. q is
    pre-scaled, so ``scale=1``.
    """
    import torch.nn.functional as F

    if mask is not None:
        n = q.shape[2]
        q = q.transpose(1, 2)
        k, v = (x.transpose(1, 2).expand(-1, n, -1, -1).contiguous() for x in (k, v))
        mask = mask[:, None]
        dout = None if dout is None else dout.transpose(1, 2)
    if dout is None:
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0).backward(dout)


def check_kernels() -> None:
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
    for name, label, qkv, mask in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in qkv)
            if name == "flash_mha":
                kernel = lambda: fa.flash_mha_fwd(q, k, v, mask)  # noqa: E731
                plain = lambda: fa.flash_mha_plain(q, k, v, mask)  # noqa: E731
                library = _sdpa(q, k, v, mask)
            else:
                kernel = lambda: fa.flash_mhsa_fwd(q, k, v)  # noqa: E731
                plain = lambda: fa.flash_mhsa_plain(q, k, v)  # noqa: E731
                library = _sdpa(q, k, v)
            out, lse = kernel()
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            tol = TOL[str(dtype).removeprefix("torch.")]
            _check(torch.isfinite(out).all() and torch.isfinite(lse).all(), f"{name} {label}: non-finite output")
            _check(max_err <= tol["max"], f"{name} {label} {dtype}: max abs err {max_err} > {tol['max']}")
            _check(mean_err <= tol.get("mean", float("inf")), f"{name} {label} {dtype}: mean abs err {mean_err}")
            ms, plain_ms, sdpa_ms = _cuda_ms(kernel), _cuda_ms(plain), _cuda_ms(library)
            if name == "flash_mha":
                flops, nbytes = _mqa_flops(mask, 8, 256, 2), _nbytes(q, k, v, mask, out, lse)
            else:
                flops, nbytes = 4 * q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] * q.shape[3], _nbytes(q, k, v, out, lse)
            bound_ms, bound_by = _bound(flops, nbytes, dtype)
            print(
                f"kernel {name} {label} {str(dtype)[6:]}: max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={sdpa_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
            )


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


def serve():
    """Phase 4; returns its launches and what phase 11 serves again in int8 (model, policy, inputs, actions)."""
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
        _check(launches == {"flash_mhsa": 27, "flash_mha": 18 + 10 * 18, "flash_mha_bwd": 0, "flash_mhsa_bwd": 0},
               f"request {i}: launches {launches}")
        _check(not any(_int8_launches().values()), f"request {i}: the bf16 model launched int8 kernels")
        a = out["actions"]
        _check(a.shape == (50, 32) and a.dtype == np.float32, f"actions {a.shape} {a.dtype}")
        _check(np.isfinite(a).all(), "non-finite actions")
        actions.append(a)
        per_request.append(wall_ms)
    serve_launches = dict(fa.LAUNCHES)
    again = []
    for i, noise_idx in enumerate(plan):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs, noise=noises[noise_idx])
        torch.cuda.synchronize()
        again.append((time.perf_counter() - t) * 1000)
        _check(np.array_equal(out["actions"], actions[i]), f"request {i} served again: different actions")
    for i in (1, 2, 3):
        _check(np.array_equal(actions[i], actions[0]), f"request {i}: same noise, different actions")
    _check(not np.array_equal(actions[4], actions[0]), "other noise gave the same actions")
    _check(np.abs(actions[0] - noises[0]).max() > 1e-2, "actions did not move from the noise")
    print(f"serving: median wall_ms={statistics.median(per_request[1:]):.2f} over requests 1-{REQUESTS - 1} "
          f"{[round(x, 2) for x in per_request[1:]]} (request 0 includes first-use set-up); the same requests again: "
          f"median wall_ms={statistics.median(again[1:]):.2f} {[round(x, 2) for x in again]}")
    return serve_launches, (model, policy, obs, noises, plan, actions)


def _int8_launches() -> dict:
    from kai0_tpu_torch.ops import int8_matmul, row_quant

    return {**row_quant.LAUNCHES, **int8_matmul.LAUNCHES}


def serve_int8(served) -> dict:
    """Phase 11: the same model with its Gemma matmul weights quantized, the same requests."""
    from kai0_tpu_torch.ops import quant

    model, policy, obs, noises, plan, bf16_actions = served
    t0 = time.perf_counter()
    quant.quantize_inference_tree(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    holders = sum(quant.is_quant(m) for m in model.modules())
    _check(holders == 2 * 18 * 6, f"{holders} quantized holders, want {2 * 18 * 6}")
    print(f"int8 serving: {holders} int8 holders (q, kv, out, gate, up, down of both experts' 18 layers), quantized in "
          f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    _reset_launches()
    actions, per_request = [], []
    for i, noise_idx in enumerate(plan):
        before = _read_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs, noise=noises[noise_idx])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1000
        launches = {k: v - before[k] for k, v in _read_launches().items() if v - before[k]}
        print(f"int8 request {i}: wall_ms={wall_ms:.2f} infer_ms={out['policy_timing']['infer_ms']:.2f} "
              f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f} launches={launches}")
        want = {"flash_mhsa": 27, "flash_mha": 18 + 10 * 18, **{k: v for k, v in INT8_REQUEST_LAUNCHES.items() if v}}
        _check(launches == want, f"int8 request {i}: launches {launches}, want {want}")
        a = out["actions"]
        _check(a.shape == (50, 32) and a.dtype == np.float32 and np.isfinite(a).all(), "int8 actions")
        actions.append(a)
        per_request.append(wall_ms)
    launches = _read_launches()
    # One more request under the profiler: the prefill's products (M = 968) on the wgmma kernel, the denoise
    # steps' (M = 50) on the split kernel, nothing on the mma.sync tiles.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        again = policy.infer(obs, noise=noises[plan[0]])["actions"]
        torch.cuda.synchronize()
    _check(np.array_equal(again, actions[0]), "int8: the profiled request gave other actions")
    counts = _check_int8_orientations(_kernels_named(prof, "int8_mm"), "profiled int8 request")
    want = {"wgmma nt": 18 * 6, "wgmma nn": 0, "splitk nt": 18 * 10 * 6, "mma.sync nt": 0, "mma.sync nn": 0}
    _check(counts == want, f"int8 request: launches by kernel {counts}, want {want}")
    for i in (1, 2, 3):
        _check(np.array_equal(actions[i], actions[0]), f"int8 request {i}: same noise, different actions")
    _check(not np.array_equal(actions[4], actions[0]), "int8: other noise gave the same actions")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(actions, bf16_actions, strict=True))
    _check(0 < diff < 0.5 * float(np.abs(bf16_actions[0]).max()), f"int8 actions against bf16 actions: {diff}")
    print(f"int8 serving: median wall_ms={statistics.median(per_request[1:]):.2f} over requests 1-{REQUESTS - 1} "
          f"{[round(x, 2) for x in per_request[1:]]}; actions against the bf16 model's on the same weights and noise: "
          f"max_abs_diff={diff:.4e} (|actions| max {np.abs(bf16_actions[0]).max():.3f})")
    del served, policy, model
    torch.cuda.empty_cache()
    return launches


def full_width_reference() -> None:
    """Phase 5: one chunk sampled at full width on the card, in f32 and in bf16, against the f32 host CPU.

    The bf16 model takes the f32 model's weights rounded to bf16 and the same
    inputs and noise, and runs the tensor-core K1 and K2. bf16 keeps 8
    significant bits (unit roundoff 2^-9): a random-weight π₀.₅ compounds that
    over 27 SigLIP and 18 joint layers and 10 Euler steps, and int8 serving,
    whose per-product error is of the same order, moves the actions by about 1%
    of their range (phase 11). So the bf16 actions must lie within 0.1 x max
    |actions| (max abs) and 0.02 x mean |actions| (mean abs) of the f32 host's:
    room for that, while a wrong kernel moves them by O(|actions|).
    """
    from kai0_tpu_torch.models.pi0 import Pi0, Pi0Config
    from kai0_tpu_torch.ops import flash_attention as fa
    from kai0_tpu_torch.policies.policy import Policy

    config = Pi0Config(pi05=True, dtype="float32")
    model = Pi0(config, device="cuda", param_dtype=torch.float32).init_weights(
        torch.Generator(device="cuda").manual_seed(1)
    ).eval()
    rng = np.random.default_rng(1)
    obs = _request_inputs(rng)
    noise = rng.standard_normal((50, 32)).astype(np.float32)
    on_card = Policy(model, config, device="cuda").infer(obs, noise=noise)
    bf16_config = Pi0Config(pi05=True)
    bf16_model = Pi0(bf16_config, device="cuda", param_dtype=torch.bfloat16).eval()
    bf16_model.load_state_dict(model.state_dict())  # the same weights, rounded to bf16
    fa.reset_launches()
    on_card_bf16 = Policy(bf16_model, bf16_config, device="cuda").infer(obs, noise=noise)
    _check(fa.LAUNCHES["flash_mhsa"] == 27 and fa.LAUNCHES["flash_mha"] == 198, f"bf16 sample launches {fa.LAUNCHES}")
    del bf16_model
    model.to("cpu")
    torch.cuda.empty_cache()
    on_host = Policy(model, config, device="cpu").infer(obs, noise=noise)
    err = float(np.abs(on_card["actions"] - on_host["actions"]).max())
    print(f"full-width f32 reference: card (kernels) vs host CPU (plain) max_abs_err={err:.3e} "
          f"(|actions| max {np.abs(on_host['actions']).max():.3f}; card {on_card['policy_timing']['infer_ms']:.1f} ms, "
          f"host {on_host['policy_timing']['infer_ms']:.1f} ms)")
    _check(np.isfinite(on_card["actions"]).all() and err <= FULL_WIDTH_TOL, f"full-width f32 mismatch {err}")
    diff = np.abs(on_card_bf16["actions"] - on_host["actions"])
    ref_max, ref_mean = float(np.abs(on_host["actions"]).max()), float(np.abs(on_host["actions"]).mean())
    print(f"full-width bf16 sample: card (tensor-core K1, K2) vs f32 host CPU max_abs_err={diff.max():.4e} "
          f"mean_abs_err={diff.mean():.4e} (|actions| max {ref_max:.3f}, mean {ref_mean:.3f}; "
          f"limits {BF16_SAMPLE_TOL['max'] * ref_max:.4e}, {BF16_SAMPLE_TOL['mean'] * ref_mean:.4e})")
    _check(np.isfinite(on_card_bf16["actions"]).all() and diff.max() <= BF16_SAMPLE_TOL["max"] * ref_max
           and diff.mean() <= BF16_SAMPLE_TOL["mean"] * ref_mean, "full-width bf16 sample too far from the f32 host")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _training_mask(batch: int) -> torch.Tensor:
    """The joint [prefix, suffix] mask of ``compute_loss``: bool [B, 1018, 1018]."""
    from kai0_tpu_torch.ops.masks import make_attn_mask

    valid = torch.ones(batch, 1018, dtype=torch.bool, device="cuda")
    valid[0, 512:768] = False  # one camera masked in one sample
    for b in range(batch):
        valid[b, 768 + 40 + 30 * b : 968] = False  # padded prompt
    ar = torch.zeros(1018, dtype=torch.bool, device="cuda")
    ar[968] = True
    return make_attn_mask(valid, ar)


def _grad_errors(got, want) -> list[float]:
    """Per gradient (q, k, v): max abs error over max |grad|."""
    errs = []
    for a, b in zip(got, want, strict=True):
        _check(a.dtype == b.dtype and a.shape == b.shape and torch.isfinite(a.float()).all(), "gradient dtype/shape")
        scale = b.float().abs().max().item()
        _check(scale > 0, "zero reference gradient")
        errs.append((a.float() - b.float()).abs().max().item() / scale)
    return errs


def check_attention_training() -> dict:
    """Phase 6: forward and backward attention kernels at the training shapes.

    MQA at B=2 (f32 and bf16) and at B=32 (bf16, the main path's shape); SigLIP
    at [6,16,256,72] (f32 and bf16: 2 samples x 3 cameras) and at [96,16,256,72]
    (bf16: the batch-32 step's shape). The record's numbers are batch 32's, with
    batch 2's under the same keys suffixed ``_b2``. In bf16 two backward calls
    must give the same bits.
    """
    from kai0_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    record = {}
    cases = (("flash_mha", 2, (torch.float32, torch.bfloat16)), ("flash_mha", TRAIN_BATCH, (torch.bfloat16,)),
             ("flash_mhsa", 2, (torch.float32, torch.bfloat16)), ("flash_mhsa", TRAIN_BATCH, (torch.bfloat16,)))
    for name, samples, dtypes in cases:
        if name == "flash_mha":
            batch = samples
            mask = _training_mask(batch)
            _check((~mask.any(dim=-1)).sum().item() > 0, "the training mask should have fully masked rows")
            shape_q, shape_kv, label = (batch, 1018, 8, 256), (batch, 1018, 1, 256), f"B={batch} T=S=1018"
            fwd_flops, bwd_flops = _mqa_flops(mask, 8, 256, 2), _mqa_flops(mask, 8, 256, 5)
        else:
            batch = 3 * samples  # three cameras a sample
            shape_q = shape_kv = (batch, 16, 256, 72)
            label = f"[{batch},16,256,72]"
            fwd_flops, bwd_flops = 4 * batch * 16 * 256 * 256 * 72, 10 * batch * 16 * 256 * 256 * 72
        base = [torch.randn(shp, generator=gen, device="cuda") for shp in (shape_q, shape_kv, shape_kv, shape_q)]
        base[0] /= base[0].shape[-1] ** 0.5
        for dtype in dtypes:
            q, k, v, dout = (x.to(dtype) for x in base)
            if name == "flash_mha":
                extra = (mask,)
                fwd = lambda: fa.flash_mha_fwd(q, k, v, mask)  # noqa: E731
                plain_fwd = lambda: fa.flash_mha_plain(q, k, v, mask)  # noqa: E731
                out, lse = fwd()
                bwd = lambda: fa.flash_mha_bwd(q, k, v, mask, out, lse, dout)  # noqa: E731
                plain_bwd = lambda: fa.flash_mha_bwd_plain(q, k, v, mask, dout)  # noqa: E731
            else:
                extra = ()
                fwd = lambda: fa.flash_mhsa_fwd(q, k, v)  # noqa: E731
                plain_fwd = lambda: fa.flash_mhsa_plain(q, k, v)  # noqa: E731
                out, lse = fwd()
                bwd = lambda: fa.flash_mhsa_bwd(q, k, v, out, lse, dout)  # noqa: E731
                plain_bwd = lambda: fa.flash_mhsa_bwd_plain(q, k, v, dout)  # noqa: E731
            fwd_err = (out.float() - plain_fwd().float()).abs()
            tol = TOL[str(dtype)[6:]]
            _check(fwd_err.max().item() <= tol["max"] and fwd_err.mean().item() <= tol.get("mean", 1.0),
                   f"{name} forward {label} {dtype}: max {fwd_err.max().item()} mean {fwd_err.mean().item()}")
            grads, ref_grads = bwd(), plain_bwd()
            errs = _grad_errors(grads, ref_grads)
            if dtype == torch.bfloat16:
                _check(all(torch.equal(a, b) for a, b in zip(grads, bwd(), strict=True)),
                       f"{name}_bwd {label}: two backward calls differ")
            _check(max(errs) <= GRAD_TOL[str(dtype)[6:]], f"{name}_bwd {label} {dtype}: relative errors {errs}")
            bwd_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, ref_grads, strict=True))
            del ref_grads  # at B=32 the plain backward's f32 [32,8,1018,1018] tensors are ~1 GB each
            torch.cuda.empty_cache()
            times = {key: _cuda_ms(fn, runs=10) for key, fn in (
                ("fwd", fwd), ("plain_fwd", plain_fwd), ("sdpa_fwd", _sdpa(q, k, v, *extra)),
                ("bwd", bwd), ("plain_bwd", plain_bwd), ("sdpa_fwd_bwd", _sdpa(q, k, v, *extra, dout=dout)),
            )}
            torch.cuda.empty_cache()
            print(f"kernel {name} training {label} {str(dtype)[6:]}: fwd max_abs_err={fwd_err.max().item():.3e} "
                  f"bwd max_err/max|grad| (q,k,v)={[f'{e:.3e}' for e in errs]} "
                  + " ".join(f"{key}_ms={t:.4f}" for key, t in times.items()))
            if dtype != torch.bfloat16:
                continue
            suffix = "_b2" if samples == 2 else ""
            for key, flops, nbytes, err, ms, plain_ms, lib_ms in (
                (name, fwd_flops, _nbytes(q, k, v, *extra, out, lse), fwd_err.max().item(),
                 times["fwd"], times["plain_fwd"], times["sdpa_fwd"]),
                (f"{name}_bwd", bwd_flops, _nbytes(q, k, v, *extra, out, dout, lse, *grads), bwd_err,
                 times["bwd"], times["plain_bwd"], times["sdpa_fwd_bwd"]),
            ):
                bound_ms, bound_by = _bound(flops, nbytes, dtype)
                record.setdefault(key, {}).update({
                    f"max_abs_err{suffix}": err, f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                    f"bound_ms{suffix}": bound_ms, f"bound_by{suffix}": bound_by, f"library_ms{suffix}": lib_ms})
                print(f"  {key} {label}: bound_ms={bound_ms:.4f} ({bound_by}; {flops / 1e9:.2f} GFLOP, "
                      f"{nbytes / 1e6:.1f} MB); kernel / bound {ms / bound_ms:.1f}, kernel / library {ms / lib_ms:.2f}")
            del out, lse, grads, fwd_err
        torch.cuda.empty_cache()
    return record


def _q8_nbytes(gs, states) -> int:
    """Bytes that K3 must move: each gradient read, each update written, codes and scales read and written."""
    return sum(2 * _nbytes(g) + 2 * _nbytes(*st) for g, st in zip(gs, states, strict=True))


def _check_q8_against_plain(out, state, ref, ref_state, label) -> tuple[float, float, list[int]]:
    """Deterministic mode: update within 1e-6 relative, scales equal, codes within 1; (max abs err, relative err,
    codes of mu and of nu that differ). The caller holds each count to at most 1e-5 of the elements."""
    rel = ((out.float() - ref.float()).abs() / ref.float().abs().clamp_min(1e-30)).max().item()
    _check(rel <= 1e-6, f"{label}: update relative error {rel}")
    _check(torch.equal(state[1], ref_state[1]) and torch.equal(state[3], ref_state[3]), f"{label}: scales differ")
    flips = []
    for i in (0, 2):
        diff = (state[i].int() - ref_state[i].int()).abs()
        _check(diff.max().item() <= 1, f"{label}: codes: max diff {diff.max().item()}")
        flips.append(int((diff > 0).sum().item()))
    return (out.float() - ref.float()).abs().max().item(), rel, flips


def check_adam_q8() -> dict:
    """Phase 7: K3 on a Gemma-2B FFN leaf, then over every tensor of the full-width model, against its references."""
    from kai0_tpu_torch.models.pi0 import Pi0, Pi0Config
    from kai0_tpu_torch.ops import adam_q8 as q8

    shape, b1, b2, a, b = (2048, 16384), 0.9, 0.95, 1.7, 2e-8
    gen = torch.Generator(device="cuda").manual_seed(7)
    mq = torch.zeros(shape, dtype=torch.int8, device="cuda")
    vq = torch.zeros(shape, dtype=torch.uint8, device="cuda")
    ms, vs = (torch.zeros(q8.num_blocks(mq.numel()), device="cuda") for _ in range(2))
    for seed in (1, 2):  # two earlier steps put every code and scale in use
        g = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).bfloat16()
        q8.adam_q8_leaf_plain(g, mq, ms, vq, vs, a, b, seed, b1=b1, b2=b2, deterministic=False)
    g = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).bfloat16()
    state = (mq, ms, vq, vs)

    k_state, p_state = [x.clone() for x in state], [x.clone() for x in state]
    out = q8.adam_q8_leaf(g, *k_state, a, b, 3, b1=b1, b2=b2, deterministic=True)
    ref = q8.adam_q8_leaf_plain(g, *p_state, a, b, 3, b1=b1, b2=b2, deterministic=True)
    torch.cuda.synchronize()
    max_err, rel, flips = _check_q8_against_plain(out, k_state, ref, p_state, "adam_q8 [2048,16384]")
    _check(max(flips) <= 1e-5 * g.numel(), f"adam_q8 [2048,16384]: {flips} codes of mu, nu differ")

    exact_m = b1 * q8.q8_decode(mq, ms) + (1 - b1) * g.float()
    mean_m = torch.zeros_like(exact_m)
    for seed in range(64):
        ks = [x.clone() for x in state]
        q8.adam_q8_leaf(g, *ks, a, b, 1000 + seed, b1=b1, b2=b2)
        mean_m += q8.q8_decode(ks[0], ks[1]) / 64
    big = exact_m.abs() > 1e-6 * exact_m.abs().amax()
    bias = ((mean_m - exact_m)[big] / exact_m[big].abs()).mean().item()
    _check(abs(bias) <= Q8_BIAS_TOL, f"adam_q8 stochastic rounding bias {bias}")

    work = [x.clone() for x in state]  # timed runs keep updating this copy in place: the same work each time
    kernel_ms = _cuda_ms(lambda: q8.adam_q8_leaf(g, *work, a, b, 3, b1=b1, b2=b2), runs=10)
    leaves_ms = _cuda_ms(lambda: q8.adam_q8_leaves([g], *([x] for x in work), a, b, [3], b1=b1, b2=b2), runs=10)
    plain_ms = _cuda_ms(lambda: q8.adam_q8_leaf_plain(g, *work, a, b, 3, b1=b1, b2=b2, deterministic=False), runs=5)
    nbytes = _q8_nbytes([g], [state])
    bound_ms, bound_by = _bound(Q8_OPS_PER_ELEMENT * g.numel(), nbytes, torch.float32)
    print(f"kernel adam_q8 [2048,16384] bf16: update max_abs_err={max_err:.3e} (relative {rel:.3e}), "
          f"stochastic mean relative bias over 64 seeds={bias:.3e}; kernel_ms={kernel_ms:.4f} (per-tensor kernel), "
          f"{leaves_ms:.4f} (all-tensors kernel on this tensor) plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({bound_by}, {nbytes / 1e6:.1f} MB)")
    record = {"max_abs_err_leaf": max_err, "ms_leaf": leaves_ms, "ms_leaf_per_tensor_kernel": kernel_ms,
              "plain_ms_leaf": plain_ms, "bound_ms_leaf": bound_ms, "bound_by_leaf": bound_by}
    del g, state, work, k_state, p_state, out, ref, exact_m, mean_m
    torch.cuda.empty_cache()

    # Every tensor of the full-width model in one launch, as the full fine-tune's optimizer calls it.
    shapes = [tuple(p.shape) for p in Pi0(Pi0Config(pi05=True), device="meta", param_dtype=torch.bfloat16).parameters()]
    gs = [(torch.randn(s, generator=gen, device="cuda") * 1e-3).bfloat16() for s in shapes]
    states = [[torch.zeros(s, dtype=torch.int8, device="cuda"), torch.zeros(q8.num_blocks(g.numel()), device="cuda"),
               torch.zeros(s, dtype=torch.uint8, device="cuda"), torch.zeros(q8.num_blocks(g.numel()), device="cuda")]
              for s, g in zip(shapes, gs, strict=True)]

    def cols(sts):
        return [[st[i] for st in sts] for i in range(4)]

    for seed in (1, 2):  # two earlier steps put every code and scale in use
        q8.adam_q8_leaves(gs, *cols(states), a, b, [seed + i for i in range(len(gs))], b1=b1, b2=b2)
    gs = [(torch.randn(s, generator=gen, device="cuda") * 1e-3).bfloat16() for s in shapes]
    seeds = torch.randint(0, 2**31 - 1, (len(gs),), generator=gen, device="cuda").tolist()
    elements = sum(g.numel() for g in gs)
    for deterministic in (True, False):
        k_states = [[x.clone() for x in st] for st in states]
        outs = q8.adam_q8_leaves(gs, *cols(k_states), a, b, seeds, b1=b1, b2=b2, deterministic=deterministic)
        worst, flips = 0.0, [0, 0]
        for g, st, k_st, out, seed in zip(gs, states, k_states, outs, seeds, strict=True):
            ref_st = [x.clone() for x in st]
            ref = q8.adam_q8_leaf(g, *ref_st, a, b, seed, b1=b1, b2=b2, deterministic=deterministic)
            _check(torch.equal(out, ref) and all(torch.equal(x, y) for x, y in zip(k_st, ref_st, strict=True)),
                   f"adam_q8 over all tensors: {tuple(g.shape)} differs from the per-tensor kernel ({deterministic=})")
            if deterministic:
                ref_st = [x.clone() for x in st]
                ref = q8.adam_q8_leaf_plain(g, *ref_st, a, b, seed, b1=b1, b2=b2, deterministic=True)
                err, _, n = _check_q8_against_plain(out, k_st, ref, ref_st, f"adam_q8 over all tensors {tuple(g.shape)}")
                worst, flips = max(worst, err), [f + k for f, k in zip(flips, n, strict=True)]
        del k_states, outs
        if deterministic:
            _check(max(flips) <= 1e-5 * elements, f"adam_q8 over all tensors: {flips} codes of mu, nu differ from plain")
            all_max_err, all_flips = worst, flips
    torch.cuda.synchronize()
    work = [[x.clone() for x in st] for st in states]

    def all_tensors():
        return q8.adam_q8_leaves(gs, *cols(work), a, b, seeds, b1=b1, b2=b2)

    def per_tensor():
        return [q8.adam_q8_leaf(g, *st, a, b, s, b1=b1, b2=b2) for g, st, s in zip(gs, work, seeds, strict=True)]

    # The call's events include the host's table of 811 tensors; the kernel's own time is that of its launch on a
    # table built beforehand.
    outs = [torch.empty_like(g) for g in gs]
    table, blocks = q8.leaves_table(gs, *cols(work), outs, seeds)
    step_ms = _cuda_ms(lambda: q8.launch_leaves(table, blocks, a, b, b1=b1, b2=b2), runs=10)
    call_ms, per_tensor_ms = _cuda_ms(all_tensors, runs=10), _cuda_ms(per_tensor, runs=5)
    del outs, table
    step_plain_ms = _cuda_ms(lambda: q8.adam_q8_leaves_plain(gs, *cols(work), a, b, seeds, b1=b1, b2=b2,
                                                             deterministic=False), runs=1)
    nbytes = _q8_nbytes(gs, states)
    bound_ms, bound_by = _bound(Q8_OPS_PER_ELEMENT * elements, nbytes, torch.float32)
    print(f"kernel adam_q8 over all {len(gs)} tensors of the full-width model ({elements / 1e9:.3f}B elements, bf16): "
          f"bit-equal to the per-tensor kernel in both modes; against the plain version update max_abs_err="
          f"{all_max_err:.3e}, {all_flips} codes of mu, nu (of {elements} each) one step apart; kernel_ms={step_ms:.4f} (the "
          f"launch; the call with its host table {call_ms:.4f}) per_tensor_kernel_ms={per_tensor_ms:.4f} ({len(gs)} calls) "
          f"plain_ms={step_plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, {nbytes / 1e9:.2f} GB)")
    record.update({"max_abs_err": all_max_err, "ms": step_ms, "ms_call": call_ms,
                   "ms_per_tensor_kernel": per_tensor_ms,
                   "plain_ms": step_plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    del gs, states, work
    torch.cuda.empty_cache()
    return {"adam_q8": record}


def _int8_bound(m: int, n: int, k: int, nbytes: int, rank: int = 0) -> tuple[float, str]:
    """Least ms for an int8 product [m, k] x [k, n] (plus a rank-``rank`` bf16 term) moving ``nbytes``."""
    ops_s = 2 * m * n * k / PEAK_FLOPS[torch.int8] + 2 * m * n * rank / PEAK_FLOPS[torch.bfloat16]
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def check_int8_kernels() -> dict:
    """Phase 10: K5, K4b (both orientations) and K4a against their plain versions at the int8 paths' shapes."""
    from kai0_tpu_torch.ops import int8_matmul as mm
    from kai0_tpu_torch.ops import quant
    from kai0_tpu_torch.ops import row_quant as rq

    gen = torch.Generator(device="cuda").manual_seed(10)
    bf16, f32 = torch.bfloat16, torch.float32
    record = {}
    _check(quant._row_chunks(INT8_ATTENTION_ROWS, 16384)[0] == (0, INT8_CHUNK_ROWS) and len(quant._row_chunks(INT8_ROWS[-1], 4096)) == 1,
           "the fused FFN's row chunks at batch 32 are not the rows held here")

    def tag(dtype):
        return str(dtype)[6:]

    # K5: bf16 activations at every contraction width, and f32 rows (phase 12's activations) at every width.
    widths = {bf16: (1024, 2048, 4096, 16384), f32: (512, 1024, 2048, 4096, 16384)}
    for dtype, ks in widths.items():
        for m in (*INT8_ROWS, INT8_CHUNK_ROWS, INT8_ATTENTION_ROWS):
            for k in ks:
                if m == INT8_ATTENTION_ROWS and k > 2048:  # only the attention sites see all rows at once
                    continue
                x = (torch.randn(m, k, generator=gen, device="cuda") * 3).to(dtype)
                x[1] = 0
                xq, sx = rq.row_quant(x)
                ref_q, ref_s = rq.row_quant_plain(x)
                torch.cuda.synchronize()
                _check(torch.equal(sx, ref_s) and torch.equal(xq, ref_q), f"row_quant [{m},{k}] {dtype}: not bit-equal")
                _check(not xq[1].any() and xq.abs().max().item() == 127, f"row_quant [{m},{k}] {dtype}: codes")
                ms, plain_ms = _cuda_ms(lambda: rq.row_quant(x), runs=10), _cuda_ms(lambda: rq.row_quant_plain(x), runs=10)
                bound_ms = _nbytes(x, xq, sx) / HBM_BYTES_PER_S * 1e3
                print(f"kernel row_quant [{m},{k}] {tag(dtype)}: bit-equal; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"bound_ms={bound_ms:.4f} (bytes)")
                if (dtype, m, k) == (bf16, INT8_CHUNK_ROWS, 16384):
                    record["row_quant"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                           "bound_by": "bytes", "library_ms": None}

    # K5 with a column scale, the backward's q_row(dy·s), at every dx shape of both experts: dy [m, N] in bf16 (the
    # training path's) and f32, s of [N] from 1e-5 to 1e-2; beside the three launches it replaces (the cast, the
    # multiply, K5 on the f32 product) on the same inputs. Drawn from a generator of its own: the draws of the
    # products below stay the same.
    cs_gen = torch.Generator(device="cuda").manual_seed(11)
    dx_shapes = sorted({(m, n) for sites, _ in INT8_SITES.values() for site, (_, n) in sites.items()
                        for m in (*INT8_ROWS, INT8_CHUNK_ROWS) + ((INT8_ATTENTION_ROWS,) if site in ("q", "kv", "out") else ())})
    for (m, n), dtype in ((shape, dtype) for shape in dx_shapes for dtype in (bf16, f32)):
        dy = (torch.randn(m, n, generator=cs_gen, device="cuda") * 3).to(dtype)
        dy[1] = 0
        cs = 10.0 ** (torch.rand(n, generator=cs_gen, device="cuda") * 3 - 5)
        xq, sx = rq.row_quant(dy, col_scale=cs)
        ref_q, ref_s = rq.row_quant_plain(dy, cs)
        torch.cuda.synchronize()
        _check(torch.equal(sx, ref_s) and torch.equal(xq, ref_q), f"row_quant dy·s [{m},{n}] {dtype}: not bit-equal")
        _check(not xq[1].any() and xq.abs().max().item() == 127, f"row_quant dy·s [{m},{n}] {dtype}: codes")
        ms, plain_ms, three_ms = (_cuda_ms(f, runs=10) for f in (
            lambda: rq.row_quant(dy, col_scale=cs), lambda: rq.row_quant_plain(dy, cs),
            lambda: rq.row_quant(dy.to(f32) * cs)))
        bound_ms = _nbytes(dy, cs, xq, sx) / HBM_BYTES_PER_S * 1e3
        print(f"kernel row_quant dy·s [{m},{n}] {tag(dtype)}: bit-equal; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} (bytes) cast_multiply_row_quant_ms={three_ms:.4f}")
        if (dtype, m, n) == (bf16, INT8_CHUNK_ROWS, 16384):
            record["row_quant_colscale"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                            "bound_by": "bytes", "library_ms": None,
                                            "cast_multiply_row_quant_ms": three_ms}
    del dy, cs

    for expert, (sites, rank) in INT8_SITES.items():
        for site, (k, n) in sites.items():
            w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)  # as stored: [out, in]
            sn = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-5
            rows = (*INT8_ROWS, INT8_CHUNK_ROWS) + ((INT8_ATTENTION_ROWS,) if site in ("q", "kv", "out") else ())
            for m in rows:
                xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
                gq = torch.randint(-127, 128, (m, n), generator=gen, device="cuda", dtype=torch.int8)
                sx = torch.rand(m, 1, generator=gen, device="cuda") * 1e-2 + 1e-4
                # K4b forward (nt, both scales) and the backward's dx (the other orientation, row scale only)
                cases = {
                    "fwd": (lambda d: mm.int8_matmul(xq, w, sx, sn, nt=True, out_dtype=d),
                            lambda d: mm.int8_matmul_plain(xq, w, sx, sn, nt=True, out_dtype=d),
                            lambda d: (torch._int_mm(xq, w.T).to(f32) * sx * sn).to(d), (m, n, k), (xq, w, sx, sn)),
                    "dx": (lambda d: mm.int8_matmul(gq, w, sx, None, nt=False, out_dtype=d),
                           lambda d: mm.int8_matmul_plain(gq, w, sx, None, nt=False, out_dtype=d),
                           lambda d: (torch._int_mm(gq, w).to(f32) * sx).to(d), (m, k, n), (gq, w, sx)),
                }
                for which, (kernel, plain, library, (mm_m, mm_n, mm_k), operands) in cases.items():
                    for dtype in (bf16, f32):
                        out, ref = kernel(dtype), plain(dtype)
                        torch.cuda.synchronize()
                        _check(out.dtype == dtype and torch.equal(out, ref),
                               f"int8_matmul {expert} {site} {which} M={m} {dtype}: not bit-equal")
                    out = kernel(bf16)
                    _check(torch.equal(library(bf16), out), f"int8_matmul {expert} {site} {which} M={m}: library yardstick differs")
                    ms, plain_ms, lib_ms = (_cuda_ms(lambda f=f: f(bf16), runs=10) for f in (kernel, plain, library))
                    bound_ms, bound_by = _int8_bound(mm_m, mm_n, mm_k, _nbytes(*operands, out))
                    print(f"kernel int8_matmul {expert} {site} {which} M={m} K={mm_k} N={mm_n}: bit-equal (bf16, f32); "
                          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} int_mm_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
                          f"{2 * mm_m * mm_n * mm_k / ms / 1e9:.1f} TOP/s")
                    if (expert, site, which, m) == ("gemma_2b", "gate/up", "dx", INT8_CHUNK_ROWS):
                        record.setdefault("int8_matmul", {}).update({
                            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": lib_ms})
                    if (expert, site, which, m) == ("gemma_300m", "down", "fwd", 50):  # a denoise step's product
                        record.setdefault("int8_matmul", {}).update({
                            "max_abs_err_m50": 0.0, "ms_m50": ms, "plain_ms_m50": plain_ms, "bound_ms_m50": bound_ms,
                            "bound_by_m50": bound_by, "library_ms_m50": lib_ms})
                if site not in ("gate/up", "down"):
                    continue
                # K4a: the fused FFN's products with the rank-r term in the epilogue; at one shape also rank 64,
                # two slices of the epilogue's rank loop (a rank no shipped variant uses)
                ranks = (rank, 64) if (expert, site, m) == ("gemma_2b", "gate/up", INT8_CHUNK_ROWS) else (rank,)
                for r, dtype in ((r, d) for r in ranks for d in (bf16, f32)):
                    g = gen if r == rank else torch.Generator(device="cuda").manual_seed(r)  # the other cases' draws stay
                    u = torch.randn(m, r, generator=g, device="cuda").to(dtype)
                    b = (torch.randn(r, n, generator=g, device="cuda") * 0.05).to(dtype)
                    kernel = lambda: mm.int8_matmul_lora(xq, w, sx, sn, u, b, out_dtype=dtype)  # noqa: E731
                    plain = lambda: mm.int8_matmul_lora_plain(xq, w, sx, sn, u, b, out_dtype=dtype)  # noqa: E731
                    library = lambda: (torch._int_mm(xq, w.T).to(f32) * sx * sn + (u @ b).to(f32)).to(dtype)  # noqa: E731
                    out, ref = kernel(), plain()
                    torch.cuda.synchronize()
                    diff = (out.to(f32) - ref.to(f32)).abs()
                    max_err, share = diff.max().item(), (diff > 0).to(f32).mean().item()
                    if dtype == bf16:
                        term = (u @ b).to(f32).abs()
                        _check((diff <= 2.0**-7 * torch.maximum(ref.to(f32).abs(), term)).all() and share <= LORA_FLIP_SHARE,
                               f"int8_matmul_lora {expert} {site} M={m} r={r} bf16: max err {max_err}, share {share}")
                    else:
                        _check(max_err <= 1e-5 * ref.abs().max().item(), f"int8_matmul_lora {expert} {site} M={m} r={r} f32: {max_err}")
                    _check((out.to(f32) - mm.int8_matmul(xq, w, sx, sn, nt=True, out_dtype=dtype).to(f32)).abs().max().item() > 0.05,
                           "int8_matmul_lora: the rank-r term is missing")
                    if dtype == f32:
                        print(f"kernel int8_matmul_lora {expert} {site} M={m} r={r} f32: max_abs_err={max_err:.3e}")
                        continue
                    ms, plain_ms, lib_ms = (_cuda_ms(f, runs=10) for f in (kernel, plain, library))
                    bound_ms, bound_by = _int8_bound(m, n, k, _nbytes(xq, w, sx, sn, u, b, out), r)
                    print(f"kernel int8_matmul_lora {expert} {site} M={m} K={k} N={n} r={r} bf16: max_abs_err={max_err:.3e}, "
                          f"share of outputs that differ {share:.3e}; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                          f"int_mm_plus_lora_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) {2 * m * n * k / ms / 1e9:.1f} TOP/s")
                    if (expert, site, m) == ("gemma_2b", "gate/up", INT8_CHUNK_ROWS):
                        suffix = "" if r == rank else f"_r{r}"
                        record.setdefault("int8_matmul_lora", {}).update({
                            f"max_abs_err{suffix}": max_err, f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                            f"bound_ms{suffix}": bound_ms, f"bound_by{suffix}": bound_by, f"library_ms{suffix}": lib_ms})
    return record


def _train_batch(seed: int, batch: int, device="cuda"):
    """A seeded synthetic batch: 3 uint8 cameras (one masked in sample 0), a padded prompt, state, actions."""
    from kai0_tpu_torch.models.model import IMAGE_KEYS, Observation

    gen = torch.Generator(device=device).manual_seed(seed)
    lengths = torch.randint(20, 200, (batch,), generator=gen, device=device)
    obs = Observation.from_dict({
        "image": {k: torch.randint(0, 256, (batch, 224, 224, 3), generator=gen, device=device, dtype=torch.uint8)
                  for k in IMAGE_KEYS},
        "image_mask": {k: (torch.arange(batch, device=device) > 0) | (k != "right_wrist_0_rgb") for k in IMAGE_KEYS},
        "state": torch.randn(batch, 32, generator=gen, device=device),
        "tokenized_prompt": torch.randint(0, 257_152, (batch, 200), generator=gen, device=device),
        "tokenized_prompt_mask": torch.arange(200, device=device)[None, :] < lengths[:, None],
    })
    return obs, torch.randn(batch, 50, 32, generator=gen, device=device)


def _on(device, obs, actions, draws):
    from kai0_tpu_torch.models.model import Observation

    def to(x):
        return {k: to(v) for k, v in x.items()} if isinstance(x, dict) else x.to(device)

    moved = Observation(images=to(obs.images), image_masks=to(obs.image_masks), state=to(obs.state),
                        tokenized_prompt=to(obs.tokenized_prompt), tokenized_prompt_mask=to(obs.tokenized_prompt_mask))
    return moved, actions.to(device), {k: to(v) for k, v in draws.items()}


def _cut_depth_config(depth: int = 2, **kwargs):
    """``Pi0Config`` at full width with both Gemma experts and SigLIP cut to ``depth`` layers."""
    from kai0_tpu_torch.models.pi0 import Pi0Config

    @dataclasses.dataclass(frozen=True)
    class CutDepth(Pi0Config):
        @property
        def paligemma_config(self):
            return dataclasses.replace(super().paligemma_config, depth=depth)

        @property
        def action_expert_config(self):
            return dataclasses.replace(super().action_expert_config, depth=depth)

        @property
        def vision_config(self):
            return dataclasses.replace(super().vision_config, depth=depth)

    return CutDepth(**kwargs)


def _gradient_inputs(seed: int, batch: int = 2):
    """A seeded batch on the card with fixed noise, time and augmentation draws."""
    from kai0_tpu_torch.models import augment
    from kai0_tpu_torch.models.model import IMAGE_KEYS

    obs, actions = _train_batch(seed, batch)
    gen = torch.Generator(device="cuda").manual_seed(10 * seed)
    draws = {
        "noise": torch.randn(actions.shape, generator=gen, device="cuda"),
        "time": torch.rand(batch, generator=gen, device="cuda"),
        "augment_params": {k: augment.draw_augment_params(gen, batch, "wrist" not in k, device="cuda") for k in IMAGE_KEYS},
    }
    return obs, actions, draws


def _loss_and_grads(model, device, obs, actions, draws):
    """(loss, {name: gradient on the host} of every parameter that trains, ms) with the model's tensors on ``device``."""
    o, a, d = _on(device, obs, actions, draws)
    model.zero_grad(set_to_none=True)
    t = time.perf_counter()
    loss = model.compute_loss(o, a, train=True, **d).mean()
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    out = {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
           for k, p in model.named_parameters() if p.requires_grad}
    return loss.item(), out, (time.perf_counter() - t) * 1000


def check_model_gradients() -> None:
    """Phase 8: full-width, depth-2 f32 gradients on the card (kernels) against the host CPU (plain)."""
    from kai0_tpu_torch.models.pi0 import Pi0

    config = _cut_depth_config(pi05=True, dtype="float32")
    model = Pi0(config, device="cuda", param_dtype=torch.float32).init_weights(
        torch.Generator(device="cuda").manual_seed(8))
    obs, actions, draws = _gradient_inputs(8)

    def grads(device):
        return _loss_and_grads(model, device, obs, actions, draws)

    _reset_launches()
    card_loss, card, card_ms = grads("cuda")
    launches = _read_launches()
    _check(all(launches[k] > 0 for k in ("flash_mha", "flash_mha_bwd", "flash_mhsa", "flash_mhsa_bwd")),
           f"depth-2 gradients did not go through the kernels: {launches}")
    groups = {
        "SigLIP": "paligemma_with_expert.paligemma.model.vision_tower.",
        "Gemma-2B": "paligemma_with_expert.paligemma.model.language_model.",
        "action expert": "paligemma_with_expert.gemma_expert.",
        "projections": ("paligemma_with_expert.paligemma.model.multi_modal_projector.", "action_in_proj.",
                        "action_out_proj.", "time_mlp_in.", "time_mlp_out."),
    }
    for group, prefix in groups.items():
        gmax = max(g.abs().max().item() for k, g in card.items() if k.startswith(prefix))
        _check(gmax > 0, f"{group}: zero gradient on the card")
    for k in ("paligemma_with_expert.paligemma.model.vision_tower.vision_model.encoder.layers.0.self_attn.q_proj.weight",
              "paligemma_with_expert.paligemma.model.language_model.layers.0.self_attn.q_proj.weight",
              "paligemma_with_expert.gemma_expert.model.layers.0.self_attn.q_proj.weight"):
        _check(card[k].abs().max().item() > 0, f"{k}: zero gradient before the attention on the card")

    model.to("cpu")
    torch.cuda.empty_cache()
    host_loss, host, host_ms = grads("cpu")
    worst, worst_key = 0.0, None
    floor = 1e-6 * max(g.abs().max().item() for g in host.values())  # SigLIP's key bias: zero up to rounding
    for k, g in host.items():
        scale = max(g.abs().max().item(), floor)
        err = (card[k] - g).abs().max().item()
        _check(err <= MODEL_GRAD_TOL * scale, f"{k}: card vs host gradient error {err} > {MODEL_GRAD_TOL} x {scale}")
        if scale > 0 and err / scale > worst:
            worst, worst_key = err / scale, k
    print(f"model gradients, full width, depth 2, f32, batch 2: loss card {card_loss:.6f} host {host_loss:.6f}; "
          f"worst gradient error {worst:.3e} x max |grad| ({worst_key}); {len(host)} tensors; "
          f"launches {launches}; card {card_ms:.1f} ms, host {host_ms:.1f} ms")
    del model


def check_lora_int8_gradients() -> None:
    """Phase 12: the LoRA + int8 loss and trainable gradients, full width, depth 2, f32: card (kernels) vs host (plain)."""
    from kai0_tpu_torch.models.pi0 import Pi0
    from kai0_tpu_torch.ops import quant
    from kai0_tpu_torch.training import train_lib

    config = _cut_depth_config(pi05=True, dtype="float32", paligemma_variant="gemma_2b_lora",
                               action_expert_variant="gemma_300m_lora")
    model = Pi0(config, device="cuda", param_dtype=torch.float32).init_weights(
        torch.Generator(device="cuda").manual_seed(12))
    mask = train_lib.freeze_params(model, quantize=True)
    holders = sum(quant.is_quant(m) for m in model.modules())
    _check(holders == 2 * 2 * 6 and not all(mask.values()), f"{holders} int8 holders at depth 2")
    obs, actions, draws = _gradient_inputs(12)

    _reset_launches()
    card_loss, card, card_ms = _loss_and_grads(model, "cuda", obs, actions, draws)
    launches = _read_launches()
    _check(all(launches[k] > 0 for k in ("row_quant", "int8_matmul", "int8_matmul_lora", "flash_mha", "flash_mha_bwd",
                                         "flash_mhsa", "flash_mhsa_bwd")),
           f"the LoRA + int8 gradients did not go through the kernels: {launches}")
    _check(set(card) == {k for k, t in mask.items() if t}, "gradients for the trainable leaves only")
    for group in ("lora", "vision_tower", "action_in_proj", "gemma_expert"):
        _check(max(g.abs().max().item() for k, g in card.items() if group in k) > 0, f"{group}: zero gradient on the card")

    model.to("cpu")
    torch.cuda.empty_cache()
    host_loss, host, host_ms = _loss_and_grads(model, "cpu", obs, actions, draws)
    _check(abs(card_loss - host_loss) <= INT8_LOSS_TOL * max(1.0, abs(host_loss)), f"loss card {card_loss} host {host_loss}")
    worst, worst_key, worst_l2 = 0.0, None, 0.0
    floor = 1e-6 * max(g.abs().max().item() for g in host.values())
    for k, g in host.items():
        scale = max(g.abs().max().item(), floor)
        err = (card[k] - g).abs().max().item()
        l2 = (card[k] - g).norm().item() / max(g.norm().item(), floor)
        _check(err <= INT8_GRAD_TOL * scale, f"{k}: card vs host gradient error {err} > {INT8_GRAD_TOL} x {scale}")
        _check(l2 <= INT8_GRAD_L2_TOL or g.abs().max().item() <= floor, f"{k}: card vs host gradient L2 error {l2}")
        worst_l2 = max(worst_l2, l2 if g.abs().max().item() > floor else 0.0)
        if err / scale > worst:
            worst, worst_key = err / scale, k
    print(f"LoRA + int8 gradients, full width, depth 2, f32, batch 2: loss card {card_loss:.6f} host {host_loss:.6f}; "
          f"worst gradient error {worst:.3e} x max |grad| ({worst_key}), worst L2 error {worst_l2:.3e}; {len(host)} "
          f"trainable tensors; launches {launches}; card {card_ms:.1f} ms, host {host_ms:.1f} ms")
    del model


def _reset_launches():
    from kai0_tpu_torch.ops import adam_q8, int8_matmul, row_quant
    from kai0_tpu_torch.ops import flash_attention as fa

    for module in (fa, adam_q8, row_quant, int8_matmul):
        module.reset_launches()


def _read_launches() -> dict:
    from kai0_tpu_torch.ops import adam_q8
    from kai0_tpu_torch.ops import flash_attention as fa

    return {**fa.LAUNCHES, **adam_q8.LAUNCHES, **_int8_launches()}


def _kernel_name(event_name: str) -> str:
    """A kernel's name with its template arguments, without its namespace and parameters."""
    name = event_name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("::")[-1]


def _kernels_named(prof, part: str) -> dict:
    """(ms, count) by kernel of a profile, with its template arguments, of the kernels whose names hold ``part``."""
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and part in e.name:
            ms, count = kernels.get(_kernel_name(e.name), (0.0, 0))
            kernels[_kernel_name(e.name)] = (ms + e.time_range.elapsed_us() / 1000, count + 1)
    return kernels


def _check_int8_orientations(kernels: dict, label: str) -> dict:
    """Launches of the int8 product kernels of a profile by kernel and orientation.

    The second template argument of the wgmma and the mma.sync kernels is their orientation
    (``int8_mm_wgmma_kernel<BN, NN, LORA, T>``, ``int8_mm_kernel<BM, NN, LORA, T>``); the split kernel computes nt
    only.
    """
    print(f"  int8 kernels of the {label}: " + "; ".join(
        f"{k} {ms:.2f} ms x{count}" for k, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])))
    counts = {"wgmma nt": 0, "wgmma nn": 0, "splitk nt": 0, "mma.sync nt": 0, "mma.sync nn": 0}
    for name, (_, count) in kernels.items():
        kernel = {"int8_mm_wgmma_kernel": "wgmma", "int8_mm_splitk_kernel": "splitk", "int8_mm_kernel": "mma.sync"}.get(
            name.split("<")[0])
        _check(kernel is not None, f"{label}: unknown int8 kernel {name}")
        nn = kernel != "splitk" and name.split("<")[1].split(",")[1].strip() == "true"
        counts[f"{kernel} {'nn' if nn else 'nt'}"] += count
    print(f"  int8 launches of the {label} by kernel: {counts}")
    return counts


def _profile_families(prof) -> tuple[dict, float, dict]:
    """Device ms of one profiled step by kernel family, the summed device ms, and (ms, count) by attention kernel."""
    families, attention = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name
        if any(k in name for k in ("flash_bwd", "mqa_bwd", "mhsa_bwd")):
            fam = "attention backward (K1b, K2b)"
        elif any(k in name for k in ("flash_fwd", "mqa_fwd", "mhsa_fwd")):
            fam = "attention forward (K1f, K2f)"
        elif "adam_q8" in name:
            fam = "8-bit AdamW (K3)"
        elif "int8_mm" in name:
            fam = "int8 matmuls (K4a, K4b)"
        elif "row_quant" in name:
            fam = "row quantization (K5)"
        elif any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
            fam = "matmuls (cuBLAS)"
        elif "memcpy" in name.lower() or "memset" in name.lower():
            fam = "copies and fills"
        else:
            fam = "elementwise / reductions / other"
        ms, count = families.get(fam, (0.0, 0))
        families[fam] = (ms + e.time_range.elapsed_us() / 1000, count + 1)
        if fam.startswith("attention"):
            kernel = name.split("(")[0].split("<")[0].removeprefix("void ")
            ms, count = attention.get(kernel, (0.0, 0))
            attention[kernel] = (ms + e.time_range.elapsed_us() / 1000, count + 1)
    return families, sum(ms for ms, _ in families.values()), attention


def _lora_int8_step_launches(batch: int) -> dict:
    """Launches of the int8 kernels in one LoRA + int8 training step, worked out from the code.

    A block runs both experts. Forward (run twice: once, and again as the
    backward's recompute): per expert 3 row quantizations and 3 K4b products
    (q, the joint kv, out), and per row chunk of the fused FFN 2 row
    quantizations (x, act) and 3 K4a products (gate, up, down). Backward: per
    expert 3 + 3 again (the three ``dx``), and per FFN chunk 4 row
    quantizations (x, and the three ``dy·s``), 2 K4a (gate and up re-derived)
    and 3 K4b (``dx`` of down, gate, up). The prefix expert's last layer
    reaches the loss only through its K and V: its backward is the kv ``dx``,
    plus the q ``dx`` on the zero gradient that the joint attention hands to
    its query rows. Every ``dx`` quantizes ``dy·s`` with a column scale
    (``row_quant_colscale``, counted in ``row_quant`` too).
    """
    from kai0_tpu_torch.ops import quant

    chunks = [len(quant._row_chunks(batch * rows, mlp_dim)) for rows, mlp_dim in ((968, 16384), (50, 4096))]  # prefix, suffix
    depth = 18
    fwd = {"row_quant": 6 + 2 * sum(chunks), "row_quant_colscale": 0, "int8_matmul": 6,
           "int8_matmul_lora": 3 * sum(chunks)}
    bwd = {"row_quant": 6 + 4 * sum(chunks), "row_quant_colscale": 6 + 3 * sum(chunks),
           "int8_matmul": 6 + 3 * sum(chunks), "int8_matmul_lora": 2 * sum(chunks)}
    last = {"row_quant": 2 + 3 + 4 * chunks[1], "row_quant_colscale": 2 + 3 + 3 * chunks[1],
            "int8_matmul": 2 + 3 + 3 * chunks[1], "int8_matmul_lora": 2 * chunks[1]}
    return {k: 2 * depth * fwd[k] + (depth - 1) * bwd[k] + last[k] for k in fwd}


def train(kind: str = "full") -> tuple[dict, list]:
    """Phases 9 and 13: a fine-tune step at full width, 5 steps twice from the same seed.

    ``kind="full"``: the full fine-tune (bf16 parameters, int8 AdamW moments).
    ``kind="lora_int8"``: LoRA over a frozen int8 base (f32 trainable leaves, bf16 AdamW moments).
    """
    from kai0_tpu_torch.models.pi0 import Pi0, Pi0Config
    from kai0_tpu_torch.ops import adam_q8, quant
    from kai0_tpu_torch.training import optimizer, train_lib

    attention = {"flash_mha": 36, "flash_mha_bwd": 18, "flash_mhsa": 54, "flash_mhsa_bwd": 27}
    if kind == "full":
        config = Pi0Config(pi05=True)
        train_config = train_lib.TrainConfig(
            optimizer=optimizer.AdamW(state_dtype="int8"), param_dtype="bfloat16", ema_decay=None,
        )
        model = Pi0(config, device="cuda", param_dtype=torch.bfloat16)
        print(f"training: pi05 full fine-tune, batch {TRAIN_BATCH}, bf16 params (stochastic rounding), int8 AdamW "
              f"moments, no EMA, per-block recompute, augmentation on, cosine schedule")
    else:
        config = Pi0Config(pi05=True, paligemma_variant="gemma_2b_lora", action_expert_variant="gemma_300m_lora")
        train_config = train_lib.TrainConfig(
            optimizer=optimizer.AdamW(state_dtype="bfloat16"), ema_decay=None, quantize_frozen=True,
        )
        model = Pi0(config, device="cuda", param_dtype=torch.float32)
        print(f"training: pi05 LoRA fine-tune (rank 16 + rank 32) over a frozen int8 base, batch {TRAIN_BATCH}, f32 "
              f"trainable leaves, bf16 AdamW moments, no EMA, per-block recompute, augmentation on, cosine schedule")
    t0 = time.perf_counter()
    batches = [_train_batch(100 + i, TRAIN_BATCH) for i in range(TRAIN_STEPS)]
    runs, run_launches = [], None
    for run in range(2):
        if kind == "lora_int8" and run == 1:  # the first run froze and quantized this model: start from a new one
            del model
            torch.cuda.empty_cache()
            model = Pi0(config, device="cuda", param_dtype=torch.float32)
        model.init_weights(torch.Generator(device="cuda").manual_seed(9))
        state = train_lib.init_train_state(model, train_config)
        n_tensors = len(state.params)
        trainable = {k for k, p in state.params.items() if p.requires_grad}
        if kind == "full":
            # one launch of the 8-bit AdamW kernel a step, over every tensor
            want = {**attention, "adam_q8": 1, "row_quant": 0, "row_quant_colscale": 0, "int8_matmul": 0,
                    "int8_matmul_lora": 0}
        else:
            want = {**attention, "adam_q8": 0, **_lora_int8_step_launches(TRAIN_BATCH)}
            frozen_before = {k: v.clone() for k, v in model.state_dict().items() if k not in trainable}
            _check(set(state.opt_state["mu"]) == set(state.opt_state["nu"]) == trainable and 0 < len(trainable) < n_tensors,
                   "the optimizer state should cover the trainable leaves only")
            _check(all(state.params[k].dtype == torch.float32 for k in trainable)
                   and all(m.dtype == torch.bfloat16 for m in state.opt_state["mu"].values()), "trainable f32, moments bf16")
        if run == 0:
            print(f"  state: {sum(p.numel() for p in state.params.values()) / 1e9:.3f}B params in {n_tensors} tensors, "
                  f"set up in {time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
            if kind == "lora_int8":
                holders = [m for m in model.modules() if quant.is_quant(m)]
                print(f"  {len(trainable)} trainable tensors ({sum(state.params[k].numel() for k in trainable) / 1e9:.3f}B "
                      f"elements), {len(frozen_before)} frozen tensors of which {2 * len(holders)} are the codes and "
                      f"scales of {len(holders)} int8 holders ({sum(m.qweight.numel() for m in holders) / 1e9:.3f}B codes)")
                _check(len(holders) == 2 * 18 * 6, f"{len(holders)} int8 holders, want {2 * 18 * 6}")
        losses, walls = [], []
        _reset_launches()
        for step, batch in enumerate(batches):
            profile = run == 1 and step == TRAIN_STEPS - 1
            before, leaves_before = _read_launches(), adam_q8.LEAVES["adam_q8"]
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if profile:
                with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                ) as prof:
                    state, info = train_lib.train_step(model, state, batch, train_config)
                    torch.cuda.synchronize()
            else:
                state, info = train_lib.train_step(model, state, batch, train_config)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1000
            loss, grad_norm = float(info["loss"]), float(info["grad_norm"])
            launches = {k: v - before[k] for k, v in _read_launches().items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            mfu = MODEL_FLOPS_PER_SAMPLE * TRAIN_BATCH / (wall_ms / 1000) / PEAK_FLOPS[torch.bfloat16]
            print(f"  run {run} step {step}{' (profiled)' if profile else ''}: wall_ms={wall_ms:.2f} "
                  f"samples_per_s={TRAIN_BATCH / wall_ms * 1000:.3f} "
                  + (f"model_mfu={mfu:.4f} " if kind == "full" else "") +
                  f"loss={loss:.6f} grad_norm={grad_norm:.6f} "
                  f"peak_mem_gib={peak:.3f} launches={launches}")
            _check(np.isfinite(loss) and np.isfinite(grad_norm) and grad_norm > 0, f"step {step}: loss {loss}, norm {grad_norm}")
            _check(launches == want, f"step {step}: launches {launches}, want {want}")
            leaves = adam_q8.LEAVES["adam_q8"] - leaves_before
            _check(leaves == (n_tensors if kind == "full" else 0), f"step {step}: adam_q8 updated {leaves} tensors")
            if step == 0 and kind == "full":
                # Every tensor but the 7 the loss cannot reach (Gemma-2B's last layer past its K/V, its final norm).
                moved = [sum(bool(m["q"].any()) for m in state.opt_state[key].values()) for key in ("mu", "nu")]
                print(f"  int8 moments non-zero after step 1: mu {moved[0]}, nu {moved[1]} of {n_tensors} tensors")
                _check(min(moved) >= n_tensors - 7, f"int8 moments still zero after step 1: {moved} of {n_tensors}")
            losses.append(loss)
            if not profile:
                walls.append(wall_ms)
        if run == 0:
            run_launches = _read_launches()
            print(f"  run 0: median wall_ms over steps 1-{TRAIN_STEPS - 1} = {statistics.median(walls[1:]):.2f} "
                  f"({TRAIN_BATCH / statistics.median(walls[1:]) * 1000:.3f} samples/s); launches over "
                  f"{TRAIN_STEPS} steps {run_launches}")
        if kind == "lora_int8":
            after = model.state_dict()
            changed = [k for k, v in frozen_before.items() if not torch.equal(after[k], v)]
            _check(not changed, f"frozen leaves changed during the steps: {changed[:5]}")
            moved = sum(bool(m.any()) for m in state.opt_state["mu"].values())
            _check(moved >= len(trainable) - 16, f"only {moved} of {len(trainable)} trainable tensors have a moment")
            if run == 0:
                print(f"  frozen leaves, int8 codes and scales bit-identical after {TRAIN_STEPS} steps ({len(frozen_before)} "
                      f"tensors); optimizer state over the {len(trainable)} trainable tensors only, {moved} with a non-zero mu")
            del frozen_before, after
        runs.append(losses)
        del state
        torch.cuda.empty_cache()
    _check(runs[0] == runs[1], f"two runs from the same seed differ: {runs}")
    families, busy_ms, attention = _profile_families(prof)
    print(f"  profiled step: summed device time {busy_ms:.2f} ms; by kernel family:")
    for fam, (ms, count) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"    {fam}: {ms:.2f} ms, {count} kernels")
    print("  attention kernels of the profiled step: " + "; ".join(
        f"{kernel} {ms:.2f} ms x{count}" for kernel, (ms, count) in sorted(attention.items(), key=lambda kv: -kv[1][0])))
    scalar = [k for k in attention if any(s in k for s in SCALAR_ATTENTION_KERNELS)]
    _check(not scalar, f"the bf16 step launched the scalar attention kernels {scalar}")
    if kind == "lora_int8":
        # The forward products (K4a, and K4b at the attention sites twice: forward and recompute) are nt, every
        # other K4b product a dx (nn); all on the wgmma kernel.
        counts = _check_int8_orientations(_kernels_named(prof, "int8_mm"), "profiled step")
        # K5: every launch on the register kernel (row_quant_regs_kernel<T, CS, TPR>), the dx's dy·s with the
        # column scale (CS, the second template argument).
        k5 = _kernels_named(prof, "row_quant")
        other = families.get("elementwise / reductions / other", (0.0, 0))
        print("  K5 kernels of the profiled step: " + "; ".join(
            f"{k} {ms:.2f} ms x{count}" for k, (ms, count) in sorted(k5.items(), key=lambda kv: -kv[1][0]))
              + f"; elementwise / reductions / other: {other[0]:.2f} ms, {other[1]} launches")
        _check(all(k.startswith("row_quant_regs_kernel<") for k in k5), f"K5 off the register kernel: {sorted(k5)}")
        colscale = sum(count for k, (_, count) in k5.items() if k.split("<")[1].split(",")[1].strip() == "true")
        _check((sum(count for _, count in k5.values()), colscale) == (want["row_quant"], want["row_quant_colscale"]),
               f"K5 launches of the profiled step: {k5}")
        nt_k4b = 2 * 18 * 6
        expected = {"wgmma nt": want["int8_matmul_lora"] + nt_k4b, "wgmma nn": want["int8_matmul"] - nt_k4b,
                    "splitk nt": 0, "mma.sync nt": 0, "mma.sync nn": 0}
        _check(counts == expected, f"int8 kernels of the profiled step: {counts}, want {expected}")
    return run_launches, runs[0]


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
    function = ""
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {function}: {line.strip().removeprefix('ptxas info    : ')}")
            _check(not any(k in function for k in SPILL_FREE_KERNELS) or " 0 bytes spill stores" in line
                   or "spill" not in line, f"the tensor-core kernel {function} spills registers: {line.strip()}")

    check_kernels()
    serve_launches, served = serve()
    int8_serve_launches = serve_int8(served)
    del served
    full_width_reference()
    record = check_attention_training()
    record.update(check_adam_q8())
    record.update(check_int8_kernels())
    check_model_gradients()
    check_lora_int8_gradients()
    launches, _ = train("full")
    int8_launches, _ = train("lora_int8")

    sources = {
        "flash_mha": ("kai0_tpu_torch/ops/csrc/flash_mqa_fwd.cu", "kai0_tpu/ops/pallas_attention.py:109"),
        "flash_mha_bwd": ("kai0_tpu_torch/ops/csrc/flash_mqa_bwd.cu", "kai0_tpu/ops/pallas_attention.py:224"),
        "flash_mhsa": ("kai0_tpu_torch/ops/csrc/flash_mhsa_fwd.cu", "kai0_tpu/ops/pallas_attention.py:419"),
        "flash_mhsa_bwd": ("kai0_tpu_torch/ops/csrc/flash_mhsa_bwd.cu", "kai0_tpu/ops/pallas_attention.py:449"),
        "adam_q8": ("kai0_tpu_torch/ops/csrc/adam_q8.cu", "kai0_tpu/ops/pallas_q8.py:119"),
        "row_quant": ("kai0_tpu_torch/ops/csrc/row_quant.cu", "kai0_tpu/ops/pallas_rowquant.py:68"),
        "row_quant_colscale": ("kai0_tpu_torch/ops/csrc/row_quant.cu", "kai0_tpu/ops/pallas_rowquant.py:68"),
        "int8_matmul": ("kai0_tpu_torch/ops/csrc/int8_mm.cu", "kai0_tpu/ops/pallas_quant.py:257"),
        "int8_matmul_lora": ("kai0_tpu_torch/ops/csrc/int8_mm.cu", "kai0_tpu/ops/pallas_quant.py:180"),
    }
    int8_kernels = ("row_quant", "row_quant_colscale", "int8_matmul", "int8_matmul_lora")
    kernels = []
    for name, (source, replaces) in sources.items():
        # launches: over the 5 steps of the main path that runs the kernel (int8 kernels: LoRA + int8; others: full fine-tune)
        path_launches = int8_launches if name in int8_kernels else launches
        _check(path_launches[name] > 0, f"{name} was not launched on its training path")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": path_launches[name], **record[name]}
        if name in ("flash_mha", "flash_mhsa"):
            _check(serve_launches[name] > 0 and int8_launches[name] > 0, f"{name} was not launched on every path")
            entry["launches_serving"] = serve_launches[name]
        if name in ("row_quant", "int8_matmul"):
            _check(int8_serve_launches[name] > 0, f"{name} was not launched on the int8 serving path")
            entry["launches_serving"] = int8_serve_launches[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
