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
   port never calls; its fully masked rows differ). Then the MQA backward
   kernel where RTC's vjp launches it: B=1, T=50 action rows against the
   bucket-64 prefix (832 rows) or the full one (968) and the 50 suffix rows
   (S = 882, 1018), the serving mask, f32 and bf16, against autograd of the
   plain version within phase 6's tolerances; two bf16 calls give the same
   bits; timed beside SDPA forward+backward and the bound.
4. Serve 5 requests through ``Policy.infer`` with the full-width π₀.₅ model
   (Gemma-2B + Gemma-300M, So400m/14, bf16, seeded random weights) at batch 1.
   ``infer`` runs the sampler as a CUDA graph: the first request runs it once
   eagerly and captures it, which counts one request's kernel launches (27
   flash_mhsa, 198 flash_mha); the others replay it and call no kernel
   wrapper. An eager ``model.sample_actions`` on the same staged inputs and
   noise launches the same counts and gives bit-equal actions. The actions
   are (50, 32) per request, finite, identical for identical noise and
   different for other noise. The 5 requests are then served a second time
   (same actions required), to show the spread of the wall time within one
   run.
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
   A second run of 2 steps from the same seed must give the same losses; its last step
   runs under torch.profiler for device time by kernel family, and must launch
   none of the scalar attention kernels (they serve f32 only).

10. The int8 kernels against their plain versions at the full-width shapes of
    the int8 paths, every (K, N) of both experts (q, the joint kv, out,
    gate/up, down of Gemma-2B and Gemma-300M) against M = 50 and 968 (int8
    serving), 2 x 968 (phase 12) and the rows phase 13 launches at batch 32:
    1,600 (the action expert), 7,744 (a row chunk of Gemma-2B's fused FFN) and,
    at the attention sites, which are not chunked, 30,976; and the action
    expert's at M = 200 (a denoise step of phase 16's int8 batch of 4).
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
    serves the same 5 requests through a new policy (graphed as in phase 4);
    per request, at capture and eagerly, 990 ``row_quant`` and 1188
    ``int8_matmul`` launches (18 layers x (1 prefill + 10 denoise steps) x 5
    row quantizations and 6 products), none of ``int8_matmul_lora``; graphed
    and eager actions bit-equal. The actions are compared with the bf16
    model's on the same weights and noise, and the difference printed (int8
    perturbs the actions by design). A sixth request, a replay, runs under
    torch.profiler: its 108 prefill products must run on the ``wgmma`` kernel
    and its 1,080 denoise products on the split-contraction kernel, none on
    the ``mma.sync`` tiles. The requests are served again for the spread.
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
    only. A second run of 2 steps from the same seed must give the same losses; its last
    step runs under torch.profiler, whose int8 kernels must be the ``wgmma``
    kernel in the forward orientation for every forward product (K4a, and K4b
    at the attention sites) and in the backward's orientation for every ``dx``,
    and every K5 launch must be its register kernel, with the column scale for
    each ``dx`` (365 a step).
14. Serving through the entry points a robot operator calls: the seeded bf16
    π₀.₅ is written to ``model.safetensors`` in a temporary directory with
    synthetic quantile norm stats under ``assets/<asset_id>``;
    ``create_trained_policy(get_config("pi05_flatten_fold_normal"), ckpt,
    prompt_buckets=[64, 128], warmup=True)`` reads it and captures the
    sampler of each bucket and of the full 200-token prompt; 20 raw Agilex
    requests (three 3x480x640 uint8 cameras, a 14-dim state, the task prompt)
    with one noise give (50, 14) finite actions (other noise other actions),
    with the p50 and p90 of the wall time and of ``policy_timing``. On the
    first request's staged inputs: the graph's x_0 bit-equal to the eager
    ``sample_actions``, the capture's launch counts equal to the eager
    request's, the bucket's x_0 within phase 5's bf16 bounds of the full
    prompt's, and a profiled replay launching the eager request's (counted) attention
    kernels by name and count (its device time and kernel count printed).
    Then all of it again with ``quantize=True``, whose replay must run the
    prefill products on ``wgmma`` and the denoise products on split-K. Then
    ``create_trained_policy(..., sample_kwargs={"num_steps": 5})`` on the same
    checkpoint serves 11 of the requests: the first captures a 5-step graph
    (keyed by the kwargs, beside the 10-step policy's) with the counts at 0,
    108 K1f and 27 K2f, its x_0 bit-equal to the eager sampler's at 5 steps and
    other than the 10-step graph's; ``infer_ms`` p50 / p90 of the 10 replays.
15. RTC through the entry points, on phase 14's checkpoint, bf16 then int8:
    ``create_trained_policy(get_config("pi05_rtc_flatten_fold_inference"),
    ..., prompt_buckets=[64], warmup=True)`` captures, per bucket, the
    unguided sampler and the sampler guided by a chunk of 50 rows (the vjp
    inside the graph). 10 rounds of the port's ``RTCClient``
    (execute_horizon 25, 25 Hz) on raw Agilex requests; rounds 0 and 1
    capture the bucket's two graphs with the counts at 0, the counts after the
    rounds are those captures twice, and a guided request launches 198
    flash_mha, 180 flash_mha_bwd and 27 flash_mhsa (int8: also the row
    quantizations, 1,080 of them with the column scale, and the products
    worked out in ``_rtc_int8_launches``). On the last round's inputs, chunk,
    delay, horizon and noise the graph's x_0 is bit-equal to the eager
    ``Pi0RTC.sample_actions``; the guided rows [2, 25) of x_0 lie nearer the
    previous chunk than the unguided sample's; a profiled replay launches the
    eager request's attention kernels by name and count (int8: the 1,080
    ``nn`` products on the ``mma.sync`` tiles, split-K and ``wgmma`` for the
    rest, and K5's column-scale launches). In bf16, the last round's guided
    request through ``create_trained_policy(..., sample_kwargs=
    {"max_guidance_weight": 5.0})`` (the client's default cap): its graph's
    capture with the counts at 0 (198 K1f, 180 K1b, 27 K2f), x_0 bit-equal to
    the eager sampler's at that cap and other than the 0.5 cap's. Then a
    guided sample at full width, depth 2, f32: card (kernels) against host
    CPU within 1e-3.
16. Batched requests: ``infer_batch`` of raw Agilex requests at padded sizes
    1, 2, 4 and 8 (bucket 64, 10 batches each) in bf16 and 4 in int8, each
    row within phase 5's bf16 bounds of the same request served alone with
    the same noise row; wall p50, robots per second and peak GiB; an int8
    batch of 4 runs every product on ``wgmma``. Then ``BatchingPolicy
    (max_batch=8)`` under 8 robot threads: dispatches coalesce and each robot
    gets its own replies.
17. The port's websocket server on this machine: an import probe of
    ``websockets`` and ``msgpack`` (printed), RTC's bf16 policy of phase 15
    served on 127.0.0.1 from a thread, ``GET /healthz``, 10 raw Agilex
    requests from the port's client beside the same requests in process,
    bytes per request and reply, and 10 RTC rounds over the wire.
18. Training through the entry point, at full width: an import probe of
    ``pyarrow``, ``cv2``, ``av``, ``torchvision`` and ``decord`` (printed: what
    could read LeRobot parquet and mp4 here); the free disk of the temporary
    directory, which must hold the bf16 weights and two checkpoints (the run
    fails otherwise, saying how many bytes it needs); a seeded bf16 π₀.₅
    written to ``model.safetensors``. ``train_lib.main`` on ``pi05_base``
    from that file (``CheckpointWeightLoader``), batch 32, 4 steps, a log
    each step, one save (step 3), 2 loader workers, phase 9's configuration:
    per step the wall time, samples/s, loss, grad_norm, peak GiB, the loader's
    wait and the launches of every kernel, which must be phase 9's a step;
    the save's seconds and bytes. ``checkpoints.restore_state`` of step 3
    into a fresh state must give main's state bit for bit (parameters, int8
    codes and scales, count, step). ``scripts/train_torch.py pi05_base ...
    --resume --num_train_steps=6`` in a subprocess must restore step 3, log
    steps 4 and 5, append them to ``metrics.jsonl`` and exit 0 (wandb, if
    it imports, is disabled: the machine has no network). The LoRA + int8
    fine-tune (``gemma_2b_lora`` + ``gemma_300m_lora``, ``quantize_frozen``)
    at full width, depth 2, batch 2: 4 steps, then a resume to 6 in process,
    whose requantized int8 codes must lie within one step of the codes saved
    (the count that moved is printed). Last, ``create_trained_policy(
    get_config("pi05_flatten_fold_normal"), "<checkpoints>/5")`` with phase
    14's synthetic norm stats serves one raw Agilex request: finite (50, 14)
    actions, and the loaded tensors bit-equal to the checkpoint's. The
    checkpoints are deleted at the end.
19. Stage Advantage through the port's entry points, at full width: (a) the
    port's LeRobot writer writes a synthetic Agilex dataset (2 episodes x 400
    frames, three 480x640 mp4 cameras, ``stage_progress_gt`` rising from 0 to
    1, one task); (b) a seeded bf16 estimator (π₀.₅ + value head) is written
    to ``model.safetensors`` (a π₀.₅ checkpoint has no value head, which the
    weight loader refuses); (c) ``train_lib.main`` on
    ``ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD`` pointed at the dataset, batch 32, 4
    steps, a save at the last, the config's 8 loader workers (or the
    machine's CPUs), phase 9's memory configuration (bf16 parameters, int8
    moments, no EMA; the config's f32 AdamW + EMA would need ~66 GB of state):
    per step the wall, loader wait, peak and launches, which must be phase
    9's; (d) the estimator's loss, value and gradients at depth 2, f32, card
    against host within phase 8's 1e-3 x max; (e) step 3's checkpoint in the
    port's ``SimpleValueEvaluator``: one episode in 2-timestep mode at the KAI0
    registry batch of 160 (the first episode of (f)'s annotation, timed as
    the call it is) and in 1-timestep mode at the PI06 batch of 400 (or
    the largest power of two whose reckoned peak, ``_eval_peak_gib``, fits 70
    GiB): frames/s, decode and resize seconds, host ms and device ms a batch,
    peak, 18 K1f and 27 K2f launches a forward, every value finite and in
    [-1, 1]; one batch of 160 with the kernels against the plain attention
    on the card within phase 5's bf16 bounds, and a profiled forward by
    kernel family; (f) every episode annotated (2-timestep, batch 160),
    discretized (binary, threshold 70: the top 70% positive) and read back
    through the port's ``LeRobotDataset`` with ``pi05_flatten_fold_awbc``'s
    data config: every prompt ends in ", Advantage: positive" or ",
    Advantage: negative", 70% +- 10% positive.
20. π₀ and π₀-FAST through the port's entry points, at full width (seeded
    bf16 weights): (a) K1f at π₀-FAST's shapes in bf16 against its plain
    version with phase 3's tolerances, timed beside SDPA and the bound: the
    prefill of ``pi0_fast_droid`` (T = 1018 rows against S = 1274 cache slots,
    the left-aligned prefix-LM mask) and a decode step (T = 1, 8 folded rows
    against S = 1274, the decode mask padded to the cache); K1f and K1b at
    the batch-32 training shapes of π₀ (T = S = 867, the suffix in two
    blocks) and π₀-FAST (T = S = 947, causal action tokens) in bf16 against
    their plain versions with phase 6's tolerances; as phase 8, π₀ and
    π₀-FAST (180 tokens) at depth 2, f32, batch 2: the card's loss within
    1e-3 x the host's and every gradient within 1e-3 x max; (b) π₀ serving:
    ``pi0_libero``'s model (Gemma-2B + Gemma-300M, So400m/14, horizon 50, 48
    prompt tokens) written to ``model.safetensors`` with synthetic stats,
    ``create_trained_policy(warmup=True)``, 10 raw LIBERO requests (two
    256x256 cameras, 8-dim state) at batch 1 through the CUDA graph: wall and
    ``infer_ms`` p50/p90, 198 K1f and 27 K2f a request (the first request's
    capture, counts at 0 just before), graphed x_0 bit-equal to the eager
    sampler's; (c) π₀ at depth 2: f32 card against f32 host within 1e-3, the
    same weights in bf16 on the card within phase 5's bounds of the f32 host;
    (d) π₀-FAST serving: ``pi0_fast_droid``'s model (Gemma-2B, So400m/14,
    8-dim actions over 10 steps, 250 prompt tokens), 1 raw DROID request
    (two 180x320 cameras) through ``create_trained_policy`` and the eager
    greedy decoder: wall and ``infer_ms`` a request, the tokens decoded, the
    prefill's ms and the ms a decode step, 18 K1f a token (the prefill, then
    each token fed back) and 27 K2f a request; the same request in int8
    (``quantize=True``): per forward 90 K5 and 108 K4b ``nt`` beside the 18
    K1f, a profiled prefill and decode step running the prefill's products on
    ``wgmma`` (M = 1,018) and the step's on split-K (M = 1), wall, ``infer_ms``
    and ms a token, finite actions; K5 and K4b at those shapes (every Gemma-2B
    site) against their plain versions, bit-equal, timed beside the bound and
    ``torch._int_mm`` + scaling (none at M = 1: it takes more than 16 rows); one prefill and one decode
    step profiled: device ms by kernel family and the device's idle share of
    the unprofiled wall; (e) π₀-FAST at depth 2, f32: the logits of the
    prefill and of 15 decode steps fed seeded tokens agree, card against
    host, within 1e-3 x their max, and the first 16 greedy tokens are equal;
    (f) 3 steps of ``train_lib.main`` at batch
    32 in phase 9's memory configuration for ``pi0_base`` and for
    ``pi0_fast_libero``'s model (180 tokens) on fake data read in a thread
    (no spawn workers), the last save left out: wall, samples/s, peak GiB,
    phase 9's launches a step.
21. Model Arithmetic through the port's entry points, at full width: K1f /
    K1b at B=8 T=S=1018 and K2f / K2b at [24,16,256,72] (the batch of 8 the
    ensemble runs) in bf16 against their plain versions with phase 6's
    tolerances; 3 ``pi05_base`` checkpoints in bf16 (a seeded base and two
    copies moved by seeded noise of 1% of each leaf's std: fine-tunes of one
    base, which kai0 mixes); ``scripts/dump_data_torch.py`` dumps 4 batches
    of 8 from ``FakeDataset``; ``scripts/model_arithmetic_torch.py`` runs
    gradient descent for 3 iterations, then its f64 mix and save, with the
    counts at 0 just before: load seconds and bytes, ms a GD iteration, of the
    mix and of the projections, peak GiB, the f64 mix's and the save's seconds
    and bytes, and launches of 3 x 4 x phase 9's attention counts a step.
    Then an ``Ensemble`` called directly gives the vertex losses (ms a loss
    evaluation, 72 K1f and 108 K2f each), ``inverse_loss`` and ``greedy``
    (grid 2) weights. Checks: every set of weights on the simplex; gradient
    descent's loss at or under its uniform start's; greedy's at or under the
    best vertex's; the saved tensors bit-equal to the host's f64 mix on a
    seeded sample of 64 keys covering every dtype; a ``Pi0`` loaded from the
    mixed ``model.safetensors`` gives, on the same draws, the ensemble's loss
    at the same weights within ``ARITH_MIXED_LOSS_RTOL`` (the reason is
    there). Last, two depth-2 checkpoints, f32 compute, batch 2, fixed draws:
    the card's ``Ensemble`` against the host's, vertex losses and the loss
    at w = (0.3, 0.7) within 1e-5 relative, dL/dw within 1e-3 x its max.
22. Train-Deploy Alignment's data side on the card's machine: phase 18's
    probe of ``pandas``, ``h5py`` and ``tqdm`` (the JAX package's data tools
    use them; the port does not); phase 19's writer makes a 2 x 50-frame Agilex dataset
    (three 480x640 mp4 cameras); ``scripts/time_scaling_torch.py`` (factor
    2), ``scripts/space_mirroring_torch.py full`` on its output, and
    ``scripts/split_lerobot_torch.py`` / ``merge_lerobot_torch.py`` (2 parts,
    merged second first) run as subprocesses, the two chains side by side,
    each output's episode, frame, video and global-index counts checked; ``MirroredView(TimeScaledView(raw,
    2))`` against a reader over the offline time-scaled-then-mirrored dataset
    (state, action and the bookkeeping columns bit-equal, each camera's mean
    abs difference under 30); both norm-stats scripts' ``compute`` on
    ``pi05_flatten_fold_normal`` over the dataset with ``augment_mirror``
    (the files' sizes and first state means); 4 steps of ``train_lib.main`` on
    that config through both views, batch 32, 8 workers, the seeded init,
    the last save left out: the norm stats and the item count the loader
    used, finite loss and gradient norm, phase 9's launches a step, the
    loader's wait a step and its collation ms a batch (those collated while
    the steps ran give the workers' samples/s beside the step's).
23. The int8 modes of ``ops/quant.py`` beyond the frozen base: (a) phase 9's
    full fine-tune with ``knobs.int8_sb_gemma="ffn"`` (SwitchBack on the
    Gemma FFN: the JAX package's full fine-tune default), phase 9's seed and
    batches: the bf16 step-0 gradient of phase 9's model, then the same
    model through ``init_train_state`` with the knob, its step-0 loss within
    5% of phase 9's and its gradient's cosine to the bf16 one above 0.98
    (JAX's bars, ``tests/test_quant.py:566-573``); 4 steps and a profiled
    fifth: wall, samples/s against phase 9's of this call, peak, device time
    by kernel family, and each step's launches equal to phase 9's plus the
    K5 and K4b counts worked out in ``_sb_step_launches``; (b) every
    SwitchBack site (Gemma's attention and FFN, SigLIP's attention, MLP and
    head) on a fresh model: the same two bars and one step's launches; (c)
    the fused SwitchBack FFN at full width (one chunk of 7,744 rows, D 2048,
    F 16384) through K5 and K4b and through their plain versions on the
    card, forward and ``dx`` bit-equal, the three weight gradients within
    one bf16 step; K5 on the weights' rows and K5 / K4b (forward and ``dx``)
    at SigLIP's shapes, M = 768 (serving) and 24,576 (training), bit-equal,
    timed beside the bound and (K4b) ``torch._int_mm`` + scaling; (d) inside phase 14, on its checkpoint and first
    10 requests: ``create_trained_policy(quantize=True)`` with
    ``knobs.int8_weight_only`` and with ``knobs.int8_siglip="all"``, the
    first request capturing the graph with the counts at 0: no K5 or K4b
    launch in a weight-only request, SigLIP + Gemma int8 launching 163 more
    of each than Gemma-only int8 (27 layers x 6 projections and the head),
    the actions within phase 11's int8 bound of phase 14's bf16 actions,
    ``infer_ms`` p50 / p90 beside phase 14's bf16 and int8.
24. The robot edge, inside phase 17, against its server (RTC's bf16 policy
    on 127.0.0.1): the C++ buffers of ``kai0_tpu_torch/native`` built from
    the checkout with g++ (seconds, ``g++ --version``, and whether
    ``Python.h``, ``h5py`` and ``cv2`` are here); ``make_stream_buffer`` /
    ``make_ensembling_buffer`` give the C++ buffers. The client's four modes
    (``scripts/inference_client_torch.py``'s ``run_sync``, ``run_smooth``,
    ``run_ensemble``, ``run_rtc``) in turn on ``SimRobot`` with the Agilex
    cameras over the port's wire client, 25 Hz publishing, 4 Hz inference,
    50 steps each: exactly 50 finite actions, the requests, the publish
    period p50 / p90 and the wall a request; each mode's first requests
    capture its graphs with the counts at 0, so its K1f, K2f and (rtc) K1b
    launches are > 0 and twice its captures. The script itself with
    ``--sim --mode smooth --max-steps 25`` must exit 0. The DAgger driver
    (``scripts/dagger_collect_torch.py``'s ``run``) over 30 frames with the
    server's actions (infer, record, take over, resume, save): without
    ``h5py`` the save must raise naming it with the 29 recorded frames kept;
    with it ``convert_h5`` must read the 29 back.

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
9 for the attention and AdamW kernels, phase 13 for the int8 ones;
``launches_serving`` and ``launches_serving_entry`` the launches of the graph
the requests of phases 4 / 11 and 14 replayed, counted at its capture by the
first request with the counts set to 0 just before; ``launches_serving_rtc``
one guided request of phase 15 (the int8 policy's for the int8 kernels),
``launches_serving_b8`` one batch of 8 and ``launches_serving_b4`` one int8
batch of 4 of phase 16, each its graph's capture; ``launches_train_entry`` the
4 steps of phase 18's first ``train_lib.main`` run (its LoRA + int8 run's for
the int8 kernels); ``launches_advantage_train`` the 4 estimator steps of phase
19 (K1f, K1b, K2f, K2b, K3) and ``launches_advantage_eval`` its 2-timestep
evaluation of one episode (K1f, K2f); K1b's numbers at the RTC
shapes of phase 3 under keys suffixed ``_rtc`` (S = 882) and ``_rtc_s1018``;
phase 20's ``launches_pi0_serving`` (one π₀ request, its graph's capture),
``launches_fast_serving`` (one π₀-FAST request: prefill and decode steps),
``launches_pi0_train`` and ``launches_fast_train`` (3 steps each), K1f's
numbers at the FAST decode step under keys suffixed ``_fast_decode``, and
K1f's and K1b's at phase 20's batch-32 training shapes under keys suffixed
``_pi0_train`` and ``_fast_train``; phase 21's ``launches_arithmetic`` (the
mixing script's run), ``launches_arithmetic_gd_iteration`` and
``launches_arithmetic_loss`` (one iteration and one loss evaluation of its
ensemble), and K1f's, K1b's, K2f's and K2b's numbers at its batch of 8 under
keys suffixed ``_arithmetic``; phase 22's ``launches_aligned_train`` (its 4 steps
through the views; 0 for the int8 kernels); for K5 (both entries) and K4b,
phase 23's ``launches_sb_train`` (one step of (a)) and
``launches_serving_siglip_int8`` (the capture of (d)'s SigLIP + Gemma int8
request); phase 14's ``launches_serving_5step`` and phase 15's
``launches_serving_rtc_guidance5`` (their graphs' captures), phase 20's
``launches_fast_int8_serving`` (K1f, K2f, K5, K4b) and K5's and K4b's numbers
at its decode and prefill shapes under keys suffixed ``_fast_decode`` and
``_fast_prefill``, and phase 24's ``launches_client_<mode>`` for each client
mode (K1f, K2f; K1b for rtc).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REQUESTS = 5
TRAIN_STEPS = 5
TRAIN_STEPS_AGAIN = 2  # phases 9 and 13: the determinism check's second run, its last step profiled
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
INT8_BATCH4_ROWS = 4 * 50  # the action expert's products in a denoise step of an int8 batch of 4 (phase 16)
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


def _cuda_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
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


def check_rtc_backward() -> dict:
    """Phase 3, continued: K1b where RTC's vjp launches it (B=1, T=50 action rows against the bucket-64 prefix of 832
    rows or the full 968, and the 50 suffix rows, with the serving mask), f32 and bf16, against autograd of the plain
    version; two bf16 calls give the same bits. Returns the bf16 numbers under keys suffixed ``_rtc`` (S=882, the
    served bucket) and ``_rtc_s1018``."""
    from kai0_tpu_torch.ops import flash_attention as fa
    from kai0_tpu_torch.ops.masks import make_attn_mask

    gen = torch.Generator(device="cuda").manual_seed(3)
    suffix = make_attn_mask(torch.ones(1, 50, dtype=torch.bool, device="cuda"), torch.arange(50, device="cuda") == 0)
    record = {}
    for s, key in ((882, "_rtc"), (1018, "_rtc_s1018")):
        mask = torch.cat([_prefix_mask()[:, None, : s - 50].expand(1, 50, s - 50), suffix], dim=-1).contiguous()
        base = [torch.randn(shape, generator=gen, device="cuda") for shape in ((1, 50, 8, 256), (1, s, 1, 256),
                                                                             (1, s, 1, 256), (1, 50, 8, 256))]
        base[0] /= 16
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (x.to(dtype) for x in base)
            out, lse = fa.flash_mha_fwd(q, k, v, mask)
            bwd = lambda: fa.flash_mha_bwd(q, k, v, mask, out, lse, dout)  # noqa: E731
            plain = lambda: fa.flash_mha_bwd_plain(q, k, v, mask, dout)  # noqa: E731
            grads, ref = bwd(), plain()
            errs = _grad_errors(grads, ref)
            _check(max(errs) <= GRAD_TOL[str(dtype)[6:]], f"flash_mha_bwd RTC S={s} {dtype}: relative errors {errs}")
            if dtype == torch.bfloat16:
                _check(all(torch.equal(a, b) for a, b in zip(grads, bwd(), strict=True)),
                       f"flash_mha_bwd RTC S={s}: two bf16 calls differ")
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, ref, strict=True))
            ms, plain_ms, sdpa_ms = _cuda_ms(bwd), _cuda_ms(plain), _cuda_ms(_sdpa(q, k, v, mask, dout=dout))
            bound_ms, bound_by = _bound(_mqa_flops(mask, 8, 256, 5), _nbytes(q, k, v, mask, out, dout, lse, *grads), dtype)
            print(f"kernel flash_mha_bwd RTC vjp B=1 T=50 S={s} {str(dtype)[6:]}: max_err/max|grad| (q,k,v)="
                  f"{[f'{e:.3e}' for e in errs]} max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"sdpa_fwd_bwd_ms={sdpa_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
            if dtype == torch.bfloat16:
                record.update({f"max_abs_err{key}": err, f"ms{key}": ms, f"plain_ms{key}": plain_ms,
                               f"bound_ms{key}": bound_ms, f"bound_by{key}": bound_by, f"library_ms{key}": sdpa_ms})
    return {"flash_mha_bwd": record}


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


def _device_inputs(staged: dict) -> dict:
    """Batched staged numpy inputs (``Policy.stage_inputs``) as CUDA tensors."""
    return {k: _device_inputs(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)).cuda()
            for k, v in staged.items()}


def _eager_sample(model, staged: dict, noise: np.ndarray, **sample_kwargs) -> tuple[np.ndarray, dict]:
    """``model.sample_actions`` (eager, no graph) on staged inputs and noise: x_0 [B, 50, 32] and its launches."""
    from kai0_tpu_torch.models.model import Observation
    from kai0_tpu_torch.policies import graphs

    obs = Observation.from_dict(_device_inputs(staged))
    noise = torch.from_numpy(noise.reshape(1, *noise.shape[-2:])).cuda()
    before = graphs.launch_counts()
    x0 = model.sample_actions(obs, noise=noise, **sample_kwargs)
    torch.cuda.synchronize()
    return x0.cpu().numpy(), {k: v - before[k] for k, v in graphs.launch_counts().items() if v - before[k]}


def _served_launches(policy, launches: list[dict], want: dict, label: str) -> dict:
    """Phases 4 and 11: the first request captures the sampler (after one eager run of it on a side stream), the
    others replay it and call no kernel wrapper; the capture counts one request's kernels. The counts were set to 0
    just before the first request; returns the launches of the graph the requests replayed, at its capture."""
    (graph,) = policy.graphs.values()
    capture = {k: v for k, v in graph.capture_launches.items() if v}
    _check(capture == want, f"{label}: launches at capture {capture}, want {want}")
    _check(launches[0] == {k: 2 * v for k, v in want.items()}, f"{label} 0 (eager run + capture): {launches[0]}")
    _check(not any(any(x.values()) for x in launches[1:]), f"{label}s 1-: a replay called kernel wrappers {launches}")
    total = {k: v for k, v in _read_launches().items() if v}
    _check(total == {k: 2 * v for k, v in want.items()}, f"{label}s: launches since the counts were set to 0 {total}")
    print(f"{label}s: captured in {graph.capture_seconds:.2f}s with launches {capture}; replays launch none from Python")
    return capture


def serve():
    """Phase 4; returns its launches and what phase 11 serves again in int8 (model, inputs, noises, plan, actions)."""
    from kai0_tpu_torch.models.pi0 import Pi0, Pi0Config
    from kai0_tpu_torch.policies import graphs
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

    actions, per_request, launches = [], [], []
    _reset_launches()
    for i, noise_idx in enumerate(plan):
        before = graphs.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs, noise=noises[noise_idx])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1000
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches.append({k: v - before[k] for k, v in graphs.launch_counts().items() if v - before[k]})
        print(f"request {i}: wall_ms={wall_ms:.2f} infer_ms={out['policy_timing']['infer_ms']:.2f} "
              f"peak_mem_gib={peak_gib:.3f} launches={launches[-1]}")
        a = out["actions"]
        _check(a.shape == (50, 32) and a.dtype == np.float32, f"actions {a.shape} {a.dtype}")
        _check(np.isfinite(a).all(), "non-finite actions")
        actions.append(a)
        per_request.append(wall_ms)
    want = {"flash_mhsa": 27, "flash_mha": 18 + 10 * 18}
    serve_launches = _served_launches(policy, launches, want, "request")
    eager, eager_launches = _eager_sample(model, policy.stage_inputs(obs), noises[0])
    _check(eager_launches == want, f"eager request: launches {eager_launches}, want {want}")
    _check(np.array_equal(eager[0], actions[0]), "the graphed actions differ from the eager sampler's")
    print("graphed actions bit-equal to the eager sampler's on the same inputs and noise; eager launches "
          f"{eager_launches}")
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
          f"{[round(x, 2) for x in per_request[1:]]} (request 0 includes the capture); the same requests again: "
          f"median wall_ms={statistics.median(again[1:]):.2f} {[round(x, 2) for x in again]}")
    del policy
    return serve_launches, (model, obs, noises, plan, actions)


def _int8_launches() -> dict:
    from kai0_tpu_torch.ops import int8_matmul, row_quant

    return {**row_quant.LAUNCHES, **int8_matmul.LAUNCHES}


def serve_int8(served) -> dict:
    """Phase 11: the same model with its Gemma matmul weights quantized, the same requests (a new policy: the bf16
    graph is gone with the old one)."""
    from kai0_tpu_torch.ops import quant
    from kai0_tpu_torch.policies import graphs
    from kai0_tpu_torch.policies.policy import Policy

    model, obs, noises, plan, bf16_actions = served
    t0 = time.perf_counter()
    quant.quantize_inference_tree(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    holders = sum(quant.is_quant(m) for m in model.modules())
    _check(holders == 2 * 18 * 6, f"{holders} quantized holders, want {2 * 18 * 6}")
    print(f"int8 serving: {holders} int8 holders (q, kv, out, gate, up, down of both experts' 18 layers), quantized in "
          f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    policy = Policy(model, model.config, device="cuda")
    actions, per_request, launches = [], [], []
    _reset_launches()
    for i, noise_idx in enumerate(plan):
        before = graphs.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs, noise=noises[noise_idx])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1000
        launches.append({k: v - before[k] for k, v in graphs.launch_counts().items() if v - before[k]})
        print(f"int8 request {i}: wall_ms={wall_ms:.2f} infer_ms={out['policy_timing']['infer_ms']:.2f} "
              f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f} launches={launches[-1]}")
        a = out["actions"]
        _check(a.shape == (50, 32) and a.dtype == np.float32 and np.isfinite(a).all(), "int8 actions")
        actions.append(a)
        per_request.append(wall_ms)
    want = {"flash_mhsa": 27, "flash_mha": 18 + 10 * 18, **{k: v for k, v in INT8_REQUEST_LAUNCHES.items() if v}}
    capture = _served_launches(policy, launches, want, "int8 request")
    eager, eager_launches = _eager_sample(model, policy.stage_inputs(obs), noises[0])
    _check(eager_launches == want, f"int8 eager request: launches {eager_launches}, want {want}")
    _check(np.array_equal(eager[0], actions[0]), "int8: the graphed actions differ from the eager sampler's")
    print(f"int8: graphed actions bit-equal to the eager sampler's; eager launches {eager_launches}")
    # One more request under the profiler, a replay: the prefill's products (M = 968) on the wgmma kernel, the
    # denoise steps' (M = 50) on the split kernel, nothing on the mma.sync tiles.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        again = policy.infer(obs, noise=noises[plan[0]])["actions"]
        torch.cuda.synchronize()
    _check(np.array_equal(again, actions[0]), "int8: the profiled request gave other actions")
    counts = _check_int8_orientations(_kernels_named(prof, "int8_mm"), "profiled int8 request")
    want = {"wgmma nt": 18 * 6, "wgmma nn": 0, "splitk nt": 18 * 10 * 6, "mma.sync nt": 0, "mma.sync nn": 0}
    _check(counts == want, f"int8 request: launches by kernel {counts}, want {want}")
    _check_replayed_row_quant(prof, True, "profiled int8 request")
    again_ms = []
    for noise_idx in plan:
        torch.cuda.synchronize()
        t = time.perf_counter()
        policy.infer(obs, noise=noises[noise_idx])
        torch.cuda.synchronize()
        again_ms.append((time.perf_counter() - t) * 1000)
    for i in (1, 2, 3):
        _check(np.array_equal(actions[i], actions[0]), f"int8 request {i}: same noise, different actions")
    _check(not np.array_equal(actions[4], actions[0]), "int8: other noise gave the same actions")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(actions, bf16_actions, strict=True))
    _check(0 < diff < 0.5 * float(np.abs(bf16_actions[0]).max()), f"int8 actions against bf16 actions: {diff}")
    print(f"int8 serving: median wall_ms={statistics.median(per_request[1:]):.2f} over requests 1-{REQUESTS - 1} "
          f"{[round(x, 2) for x in per_request[1:]]}; the same requests again: median wall_ms="
          f"{statistics.median(again_ms[1:]):.2f} {[round(x, 2) for x in again_ms]}; actions against the bf16 model's "
          f"on the same weights and noise: max_abs_diff={diff:.4e} (|actions| max {np.abs(bf16_actions[0]).max():.3f})")
    del served, policy, model
    torch.cuda.empty_cache()
    return capture


def _check_replayed_row_quant(prof, quantize: bool, label: str) -> None:
    """K5 in a profiled replay: one request's 990 launches in int8 (5 a layer and pass), none in bf16."""
    k5 = _kernels_named(prof, "row_quant")
    launched = sum(count for _, count in k5.values())
    want = INT8_REQUEST_LAUNCHES["row_quant"] if quantize else 0
    _check(launched == want, f"{label}: {launched} row_quant launches {k5}, want {want}")
    _check(quantize or not _kernels_named(prof, "int8_mm"), f"{label}: a bf16 request launched int8 products")
    print(f"  row_quant kernels of the {label}: {launched} " + "; ".join(
        f"{k} {ms:.2f} ms x{count}" for k, (ms, count) in k5.items()))


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
    from kai0_tpu_torch.policies.policy import Policy

    config = Pi0Config(pi05=True, dtype="float32")
    model = Pi0(config, device="cuda", param_dtype=torch.float32).init_weights(
        torch.Generator(device="cuda").manual_seed(1)
    ).eval()
    rng = np.random.default_rng(1)
    obs = _request_inputs(rng)
    noise = rng.standard_normal((50, 32)).astype(np.float32)
    card_policy = Policy(model, config, device="cuda")
    on_card = card_policy.infer(obs, noise=noise)
    del card_policy  # and its graph
    bf16_config = Pi0Config(pi05=True)
    bf16_model = Pi0(bf16_config, device="cuda", param_dtype=torch.bfloat16).eval()
    bf16_model.load_state_dict(model.state_dict())  # the same weights, rounded to bf16
    bf16_policy = Policy(bf16_model, bf16_config, device="cuda")
    on_card_bf16 = bf16_policy.infer(obs, noise=noise)
    (graph,) = bf16_policy.graphs.values()
    _check({k: graph.capture_launches[k] for k in ("flash_mhsa", "flash_mha")} == {"flash_mhsa": 27, "flash_mha": 198},
           f"bf16 sample launches at capture {graph.capture_launches}")
    del bf16_policy, bf16_model, graph
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


def check_attention_training(batches: dict | None = None) -> dict:
    """Phase 6: forward and backward attention kernels at the training shapes.

    MQA at B=2 (f32 and bf16) and at B=32 (bf16, the main path's shape); SigLIP
    at [6,16,256,72] (f32 and bf16: 2 samples x 3 cameras) and at [96,16,256,72]
    (bf16: the batch-32 step's shape). The record's numbers are batch 32's, with
    batch 2's under the same keys suffixed ``_b2``. In bf16 two backward calls
    must give the same bits. ``batches`` maps each batch to the suffix of its
    keys and its dtypes (phase 21 runs batch 8).
    """
    from kai0_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    record = {}
    batches = batches or {2: ("_b2", (torch.float32, torch.bfloat16)), TRAIN_BATCH: ("", (torch.bfloat16,))}
    cases = [(name, samples, dtypes) for name in ("flash_mha", "flash_mhsa") for samples, (_, dtypes) in batches.items()]
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
            suffix = batches[samples][0]
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
    # The plain step over every tensor takes 10-40 s: one run, no warm-up (the per-tensor checks above ran its ops).
    step_plain_ms = _cuda_ms(lambda: q8.adam_q8_leaves_plain(gs, *cols(work), a, b, seeds, b1=b1, b2=b2,
                                                             deterministic=False), runs=1, warmup=0)
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
            rows += (INT8_BATCH4_ROWS,) if expert == "gemma_300m" else ()
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


def _train_batch(seed: int, batch: int, device="cuda", tokens: int = 200):
    """A seeded synthetic batch: 3 uint8 cameras (one masked in sample 0), a prompt of ``tokens`` slots padded after
    20 or more, state, actions."""
    from kai0_tpu_torch.models.model import IMAGE_KEYS, Observation

    gen = torch.Generator(device=device).manual_seed(seed)
    lengths = torch.randint(20, tokens, (batch,), generator=gen, device=device)
    obs = Observation.from_dict({
        "image": {k: torch.randint(0, 256, (batch, 224, 224, 3), generator=gen, device=device, dtype=torch.uint8)
                  for k in IMAGE_KEYS},
        "image_mask": {k: (torch.arange(batch, device=device) > 0) | (k != "right_wrist_0_rgb") for k in IMAGE_KEYS},
        "state": torch.randn(batch, 32, generator=gen, device=device),
        "tokenized_prompt": torch.randint(0, 257_152, (batch, tokens), generator=gen, device=device),
        "tokenized_prompt_mask": torch.arange(tokens, device=device)[None, :] < lengths[:, None],
    })
    return obs, torch.randn(batch, 50, 32, generator=gen, device=device)


def _on(device, obs, actions, draws):
    """The observation (every field), the actions and the draws on ``device``."""

    def to(x):
        return None if x is None else {k: to(v) for k, v in x.items()} if isinstance(x, dict) else x.to(device)

    moved = dataclasses.replace(obs, **{f.name: to(getattr(obs, f.name)) for f in dataclasses.fields(obs)})
    return moved, actions.to(device), {k: to(v) for k, v in draws.items()}


def _cut_depth_config(depth: int = 2, base=None, **kwargs):
    """``base`` (``Pi0Config`` by default) at full width with both Gemma experts and SigLIP cut to ``depth`` layers."""
    from kai0_tpu_torch.models.pi0 import Pi0Config

    @dataclasses.dataclass(frozen=True)
    class CutDepth(base or Pi0Config):
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


def _gradient_inputs(seed: int, batch: int = 2, tokens: int = 200):
    """A seeded batch on the card with fixed noise, time and augmentation draws."""
    from kai0_tpu_torch.models import augment
    from kai0_tpu_torch.models.model import IMAGE_KEYS

    obs, actions = _train_batch(seed, batch, tokens=tokens)
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


def _card_vs_host_gradients(card: dict, host: dict, scale_of=lambda k: k) -> tuple[float, str, list[str]]:
    """Each gradient of the card against the host's, over max |the host's gradient of ``scale_of(name)``| (and at
    least 1e-6 x the largest host gradient); returns the worst ratio, its tensor, and the tensors beyond
    ``MODEL_GRAD_TOL``."""
    worst, worst_key, bad = 0.0, None, []
    floor = 1e-6 * max(g.abs().max().item() for g in host.values())  # SigLIP's key bias: zero up to rounding
    for k, g in host.items():
        scale = max(g.abs().max().item(), host[scale_of(k)].abs().max().item(), floor)
        err = (card[k] - g).abs().max().item()
        if err > MODEL_GRAD_TOL * scale:
            bad.append(f"{k}: card vs host gradient error {err} > {MODEL_GRAD_TOL} x {scale}")
        if scale > 0 and err / scale > worst:
            worst, worst_key = err / scale, k
    return worst, worst_key, bad


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
    worst, worst_key, bad = _card_vs_host_gradients(card, host)
    print(f"model gradients, full width, depth 2, f32, batch 2: loss card {card_loss:.6f} host {host_loss:.6f}; "
          f"worst gradient error {worst:.3e} x max |grad| ({worst_key}); {len(host)} tensors; "
          f"launches {launches}; card {card_ms:.1f} ms, host {host_ms:.1f} ms")
    _check(not bad, "; ".join(bad))
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


def train(kind: str = "full") -> tuple[dict, list, float]:
    """Phases 9 and 13: a fine-tune step at full width, 5 steps, then 2 again from the same seed (the second profiled).

    Returns the first run's launches, its losses and the median wall ms of its steps 1-4.

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
        for step, batch in enumerate(batches if run == 0 else batches[:TRAIN_STEPS_AGAIN]):
            profile = run == 1 and step == TRAIN_STEPS_AGAIN - 1
            before, leaves_before = _read_launches(), adam_q8.LEAVES["adam_q8"]
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if profile:
                # Device events only: reading a profile with the host's ops too took 18-37 s a step.
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
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
            run_launches, median_ms = _read_launches(), statistics.median(walls[1:])
            print(f"  run 0: median wall_ms over steps 1-{TRAIN_STEPS - 1} = {median_ms:.2f} "
                  f"({TRAIN_BATCH / median_ms * 1000:.3f} samples/s); launches over {TRAIN_STEPS} steps {run_launches}")
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
    _check(runs[0][:len(runs[1])] == runs[1], f"two runs from the same seed differ: {runs}")
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
    return run_launches, runs[0], median_ms


ENTRY_CONFIG = "pi05_flatten_fold_normal"
ENTRY_BUCKETS = [64, 128]
ENTRY_REQUESTS = 20
AGILEX_CAMERAS = ("top_head", "hand_left", "hand_right")


def _clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _percentiles(values: list[float]) -> str:
    return f"p50={np.percentile(values, 50):.2f} p90={np.percentile(values, 90):.2f}"


def _serve_entry_once(cfg, ckpt: str, quantize: bool) -> dict:
    """One ``create_trained_policy`` of phase 14 and its checks; returns the launches of the graph the requests
    replayed (``capture``), counted at its capture by the first request with every count set to 0 just before, and
    the requests, their noise, actions and ``infer_ms`` (phase 23 serves them again)."""
    from kai0_tpu_torch.policies import graphs, policy_config

    label = "int8" if quantize else "bf16"
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    policy = policy_config.create_trained_policy(cfg, ckpt, prompt_buckets=ENTRY_BUCKETS, warmup=True, quantize=quantize)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    capture_s = sum(g.capture_seconds for g in policy.graphs.values())
    print(f"entry {label}: create_trained_policy({ENTRY_CONFIG!r}, quantize={quantize}, prompt_buckets={ENTRY_BUCKETS}, "
          f"warmup=True) in {total_s:.2f}s: {len(policy.graphs)} captures {capture_s:.2f}s, reading the checkpoint"
          f"{', quantizing' if quantize else ''} and the example request {total_s - capture_s:.2f}s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _check(len(policy.graphs) == len(ENTRY_BUCKETS) + 1, f"entry {label}: {len(policy.graphs)} graphs after warmup")

    rng = np.random.default_rng(14)
    noise = rng.standard_normal((50, 32)).astype(np.float32)
    requests = [{"images": {cam: rng.integers(0, 256, (3, 480, 640), dtype=np.uint8) for cam in AGILEX_CAMERAS},
                 "state": rng.uniform(-1, 1, 14).astype(np.float32), "prompt": cfg.data.default_prompt}
                for _ in range(ENTRY_REQUESTS)]
    walls, timing, outs = [], {"infer_ms": [], "transform_ms": [], "stage_ms": []}, []
    # The requests' bucket graph from warmup is dropped, so that the first request captures it again with every
    # count at 0: the counts read after the requests are its eager run and its capture, and the replays add none.
    staged = policy.stage_inputs(requests[0])
    del policy.graphs[graphs.signature(staged)]
    _reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    policy.infer(requests[0], noise=noise)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1000
    clocks = [_clocks()]
    for obs in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs, noise=noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1000)
        for key in timing:
            timing[key].append(out["policy_timing"][key])
        a = out["actions"]
        # Unnormalize maps the actions with the f64 stats of norm_stats.json into f64, as the JAX package's does.
        _check(a.shape == (50, 14) and a.dtype == np.float64 and np.isfinite(a).all(),
               f"entry {label}: actions {a.shape} {a.dtype}, finite {np.isfinite(a).all()}")
        outs.append(a)
    clocks.append(_clocks())
    served = {k: v for k, v in _read_launches().items() if v}
    graph = policy.graph_for(staged)
    capture = {k: v for k, v in graph.capture_launches.items() if v}
    _check(len(policy.graphs) == len(ENTRY_BUCKETS) + 1 and served == {k: 2 * v for k, v in capture.items()},
           f"entry {label}: launches of the requests {served}, of the one capture {capture}")
    print(f"entry {label}: the first request captured its bucket's graph in {first_ms:.2f} ms (capture "
          f"{graph.capture_seconds:.2f}s); launches since the counts were set to 0: {served} = the eager run and the "
          f"capture of that graph; the {ENTRY_REQUESTS} requests after it replayed and launched none from Python")
    other = policy.infer(requests[0], noise=rng.standard_normal((50, 32)).astype(np.float32))["actions"]
    _check(not np.array_equal(other, outs[0]), f"entry {label}: other noise gave the same actions")
    print(f"entry {label}: {ENTRY_REQUESTS} raw Agilex requests (3 x 3x480x640 uint8 cameras, 14-dim state, prompt "
          f"{cfg.data.default_prompt!r}), one noise: wall_ms {_percentiles(walls)}; "
          + "; ".join(f"{k} {_percentiles(v)}" for k, v in timing.items())
          + f"; SM clock, max SM clock, power draw, temperature before / after: {clocks[0]} / {clocks[1]}")

    # The graph against the eager sampler, on the staged inputs of the first request (its prompt bucket).
    bucket = staged["tokenized_prompt"].shape[-1]
    _check(bucket in ENTRY_BUCKETS, f"entry {label}: the prompt took the bucket {bucket}")
    graph.stage(staged, noise[None])
    graph.replay()
    x0 = graph.fetch()
    eager, eager_launches = _eager_sample(policy.model, staged, noise)
    _check(np.array_equal(eager, x0), f"entry {label}: the graphed x_0 differs from the eager sampler's")
    _check(capture == eager_launches, f"entry {label}: launches at capture {capture}, eager {eager_launches}")
    print(f"entry {label}: bucket {bucket}: graphed x_0 bit-equal to the eager sampler's; launches at capture = "
          f"eager launches = {eager_launches}")

    # The bucket against the full prompt length (the tokenizer's padding put back; its graph came from warmup).
    pad = ((0, 0), (0, 200 - bucket))
    full = {**staged, "tokenized_prompt": np.pad(staged["tokenized_prompt"], pad),
            "tokenized_prompt_mask": np.pad(staged["tokenized_prompt_mask"], pad)}
    full_graph = policy.graph_for(full)
    _check(len(policy.graphs) == len(ENTRY_BUCKETS) + 1, f"entry {label}: the full prompt length had no graph")
    full_graph.stage(full, noise[None])
    full_graph.replay()
    x0_full = full_graph.fetch()
    diff = np.abs(x0 - x0_full)
    ref_max, ref_mean = float(np.abs(x0_full).max()), float(np.abs(x0_full).mean())
    print(f"entry {label}: bucket {bucket} against the full 200-token prompt: max_abs_diff={diff.max():.4e} "
          f"mean_abs_diff={diff.mean():.4e} (|x_0| max {ref_max:.3f}, mean {ref_mean:.3f}; limits "
          f"{BF16_SAMPLE_TOL['max'] * ref_max:.4e}, {BF16_SAMPLE_TOL['mean'] * ref_mean:.4e})")
    _check(diff.max() <= BF16_SAMPLE_TOL["max"] * ref_max and diff.mean() <= BF16_SAMPLE_TOL["mean"] * ref_mean,
           f"entry {label}: the bucket moved x_0 too far")

    # One replayed request and one eager request under the profiler.
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof_replay:
        graph.stage(staged, noise[None])
        graph.replay()
        graph.fetch()
    with torch.profiler.profile(activities=activities) as prof_eager:
        _eager_sample(policy.model, staged, noise)
    replay_families, replay_ms, replay_attention = _profile_families(prof_replay)
    eager_families, eager_ms, eager_attention = _profile_families(prof_eager)
    by_count = lambda kernels: {k: count for k, (_, count) in kernels.items()}  # noqa: E731
    # The replay's attention kernels by name and count against the eager request's launches (the counters, which
    # equal the capture's, above), not against its profile: the profiler can drop a kernel record of an eager run
    # (PR 20's call 2 saw 197 of its 198 K1f; phase 15 compares the same way).
    by_name = {k.split("::")[-1]: count for k, count in by_count(replay_attention).items()}
    _check(by_name.get("mqa_fwd") == capture["flash_mha"] and by_name.get("mhsa_fwd") == capture["flash_mhsa"]
           and by_name.get("flash_fwd_combine", 0) <= capture["flash_mha"],
           f"entry {label}: attention kernels of the replay {by_count(replay_attention)}, launches of the eager request "
           f"{eager_launches}; the eager request's profile {by_count(eager_attention)}")
    kernels = sum(count for _, count in replay_families.values())
    print(f"entry {label}: one replayed request: {replay_ms:.2f} ms of device time in {kernels} kernels (wall p50 "
          f"{np.percentile(walls, 50):.2f} ms, infer_ms p50 {np.percentile(timing['infer_ms'], 50):.2f}); eager: "
          f"{eager_ms:.2f} ms in {sum(c for _, c in eager_families.values())} kernels; by family (replay): "
          + "; ".join(f"{fam} {ms:.2f} ms x{count}" for fam, (ms, count) in sorted(replay_families.items(),
                                                                                 key=lambda kv: -kv[1][0])))
    print(f"  attention kernels of the replay (= the eager request's launches): {by_count(replay_attention)}; of the "
          f"eager request's profile: {by_count(eager_attention)}")
    if quantize:
        counts = _check_int8_orientations(_kernels_named(prof_replay, "int8_mm"), f"entry {label} replay")
        want = {"wgmma nt": 18 * 6, "wgmma nn": 0, "splitk nt": 18 * 10 * 6, "mma.sync nt": 0, "mma.sync nn": 0}
        _check(counts == want, f"entry {label}: int8 kernels of the replay {counts}, want {want}")
    _check_replayed_row_quant(prof_replay, quantize, f"entry {label} replay")
    five = None if quantize else _serve_five_steps(cfg, ckpt, policy, requests, noise)
    del policy, graph, full_graph
    torch.cuda.empty_cache()
    return {"capture": capture, "requests": requests, "noise": noise, "actions": outs, "infer_ms": timing["infer_ms"],
            "five_steps": five}


FIVE_STEPS = 5  # phase 14's request with sample_kwargs={"num_steps": 5}
FIVE_STEP_REQUESTS = 10  # replayed, after the one that captures


def _serve_five_steps(cfg, ckpt: str, ten: object, requests: list, noise: np.ndarray) -> dict:
    """Phase 14, continued: ``create_trained_policy(..., sample_kwargs={"num_steps": 5})`` on the same checkpoint
    serves 11 of the requests; the first captures the 5-step graph with the counts at 0 (keyed by the kwargs,
    beside the 10-step policy's graph of the same bucket), whose x_0 must equal the eager sampler's at 5 steps, bit
    for bit, and launch 18 + 5 x 18 K1f and 27 K2f. Returns the launches of that capture."""
    from kai0_tpu_torch.policies import graphs, policy_config

    kwargs = {"num_steps": FIVE_STEPS}
    t = time.perf_counter()
    policy = policy_config.create_trained_policy(cfg, ckpt, prompt_buckets=ENTRY_BUCKETS, sample_kwargs=kwargs)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    _reset_launches()
    walls, infer_ms = [], []
    for obs in requests[: FIVE_STEP_REQUESTS + 1]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs, noise=noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1000)
        infer_ms.append(out["policy_timing"]["infer_ms"])
        _check(out["actions"].shape == (50, 14) and np.isfinite(out["actions"]).all(), "5-step request: actions")
    served = {k: v for k, v in _read_launches().items() if v}
    staged = policy.stage_inputs(requests[0])
    key = graphs.signature(staged, None, kwargs)
    _check(list(policy.graphs) == [key], f"5-step policy: graphs {list(policy.graphs)}")
    graph = policy.graphs[key]
    capture = {k: v for k, v in graph.capture_launches.items() if v}
    want = {"flash_mha": 18 + FIVE_STEPS * 18, "flash_mhsa": 27}
    _check(graph.num_steps == FIVE_STEPS and capture == want and served == {k: 2 * v for k, v in want.items()},
           f"5-step policy: launches at capture {capture}, of the requests {served}, want {want}")
    graph.stage(staged, noise[None])
    graph.replay()
    x0 = graph.fetch()
    eager, eager_launches = _eager_sample(policy.model, staged, noise, num_steps=FIVE_STEPS)
    _check(np.array_equal(eager, x0) and eager_launches == capture,
           f"5-step graph against the eager sampler at 5 steps: equal {np.array_equal(eager, x0)}, launches "
           f"{eager_launches}")
    ten_graph = ten.graph_for(staged)
    ten_graph.stage(staged, noise[None])
    ten_graph.replay()
    x0_ten = ten_graph.fetch()
    _check(ten_graph.num_steps == 10 and ten_graph.key != key and not np.array_equal(x0_ten, x0),
           "the 5-step and 10-step graphs are not two graphs")
    print(f"entry bf16 5 steps: create_trained_policy(..., sample_kwargs={kwargs}) in {load_s:.2f}s; the first of "
          f"{FIVE_STEP_REQUESTS + 1} requests captured the 5-step graph ({graph.capture_seconds:.2f}s; key "
          f"{key[-1]}), launches at capture {capture} (10 steps: 198 K1f); x_0 bit-equal to the eager sampler's at 5 "
          f"steps; |x_0(5) - x_0(10)| max {np.abs(x0 - x0_ten).max():.4e}; requests 1-{FIVE_STEP_REQUESTS}: wall_ms "
          f"{_percentiles(walls[1:])}, infer_ms {_percentiles(infer_ms[1:])}")
    del policy, graph
    torch.cuda.empty_cache()
    return capture


RTC_CONFIG = "pi05_rtc_flatten_fold_inference"
RTC_ROUNDS = 10
RTC_BUCKETS = [64]  # phase 15's prompt buckets: its requests' (phase 14 serves [64, 128])
WIRE_REQUESTS = 10  # phase 17: requests, and RTC rounds, over the wire
RTC_CHUNK = (50, 14)  # the graph key of a chunk of the action horizon whose 14 joints and grippers are guided
BATCH_SIZES = (1, 2, 4, 8)
BATCH_REPEATS = 10


def _agilex_requests(cfg, rng: np.random.Generator, n: int) -> list[dict]:
    return [{"images": {cam: rng.integers(0, 256, (3, 480, 640), dtype=np.uint8) for cam in AGILEX_CAMERAS},
             "state": rng.uniform(-1, 1, 14).astype(np.float32), "prompt": cfg.data.default_prompt} for _ in range(n)]


def _rtc_eager(model, staged: dict, noise: np.ndarray, rtc: dict) -> tuple[np.ndarray, dict]:
    """``Pi0RTC.sample_actions`` (eager, no graph) on staged inputs, noise and a request's RTC keys: x_0, launches."""
    from kai0_tpu_torch.models.model import Observation
    from kai0_tpu_torch.policies import graphs

    obs = Observation.from_dict(_device_inputs(staged))
    before = graphs.launch_counts()
    x0 = model.sample_actions(obs, noise=torch.from_numpy(noise.reshape(1, 50, 32)).cuda(), **rtc)
    torch.cuda.synchronize()
    return x0.cpu().numpy(), {k: v - before[k] for k, v in graphs.launch_counts().items() if v - before[k]}


def _rtc_graph_x0(policy, staged: dict, noise: np.ndarray, rtc: dict | None) -> np.ndarray:
    """x_0 of the policy's RTC graph for ``staged`` (guided by ``rtc``'s keys when given)."""
    from kai0_tpu_torch.models import pi0_rtc

    if rtc is None:
        graph = policy.graph_for(staged)
        graph.stage(staged, noise[None])
    else:
        config = policy.model_config
        chunk, provided, scalars = pi0_rtc.rtc_inputs(rtc["prev_action_chunk"], rtc["inference_delay"],
                                                      rtc["execute_horizon"], config.action_horizon, config.action_dim)
        graph = policy.graph_for(staged, (chunk.shape[1], provided))
        graph.stage(staged, noise[None], (chunk, scalars))
    graph.replay()
    return graph.fetch()


class _Timed:
    """A policy whose ``infer`` records each request, its reply and its wall ms (between synchronizes)."""

    def __init__(self, policy):
        self.policy, self.calls = policy, []

    def infer(self, obs: dict) -> dict:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.policy.infer(obs)
        torch.cuda.synchronize()
        self.calls.append((obs, out, (time.perf_counter() - t) * 1000))
        return out


def _rtc_int8_launches(depth: int = 18, steps: int = 10) -> dict:
    """Launches of the int8 kernels in one guided RTC request, worked out from the code.

    Forward, the prefill and each step: per layer 5 row quantizations (q, kv, out; the FFN's x and act) and 6
    products. The vjp of each step, per layer of the action expert: the straight-through ``dx`` of q, kv and out
    (``_QMM.backward``: a column-scale K5 and an ``nn`` product each), and the fused FFN's backward at 50 rows (one
    chunk): x quantized again, gate and up re-derived (2 ``nt`` products), and the ``dx`` of down, gate and up (3
    column-scale K5 and 3 ``nn`` products).
    """
    forward = {"row_quant": 5, "int8_matmul": 6}
    backward = {"row_quant": 3 + 1 + 3, "row_quant_colscale": 3 + 3, "int8_matmul": 3 + 2 + 3}
    return {k: depth * (1 + steps) * forward.get(k, 0) + depth * steps * backward[k] for k in backward}


def _serve_rtc_once(cfg, ckpt: str, quantize: bool) -> tuple[dict, object, list[float], dict | None]:
    """Phase 15 for one policy; returns the launches of one guided request (its graph's capture), the policy, the
    wall ms of its replayed rounds and (bf16) the launches of the guided request at ``RTC_GUIDANCE``."""
    from kai0_tpu_torch.deploy.rtc_client import RTCClient
    from kai0_tpu_torch.policies import graphs, policy_config

    label = "RTC int8" if quantize else "RTC bf16"
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    policy = policy_config.create_trained_policy(cfg, ckpt, prompt_buckets=RTC_BUCKETS, warmup=True, quantize=quantize)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    capture_s = sum(g.capture_seconds for g in policy.graphs.values())
    guided = [g for g in policy.graphs.values() if g.key[-1][0] == "prev_action_chunk"]
    print(f"{label}: create_trained_policy({RTC_CONFIG!r}, quantize={quantize}, prompt_buckets={RTC_BUCKETS}, "
          f"warmup=True) in {total_s:.2f}s: {len(policy.graphs)} captures {capture_s:.2f}s (guided: "
          f"{[round(g.capture_seconds, 2) for g in guided]}); peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _check(len(policy.graphs) == 2 * (len(RTC_BUCKETS) + 1) and len(guided) == len(RTC_BUCKETS) + 1,
           f"{label}: {len(policy.graphs)} graphs after warmup")

    rng = np.random.default_rng(16)
    observations = _agilex_requests(cfg, rng, RTC_ROUNDS)
    staged = policy.stage_inputs(observations[0])
    # The bucket's two graphs from warmup are dropped, so that rounds 0 (no previous chunk yet) and 1 capture them
    # with every count at 0: the counts read after the rounds are their eager runs and captures.
    for chunk in (None, RTC_CHUNK):
        del policy.graphs[graphs.signature(staged, chunk)]
    _reset_launches()
    timed = _Timed(policy)
    client = RTCClient(timed, action_dim=32, chunk_size=50, execute_horizon=25, publish_rate=25.0)
    clocks = [_clocks()]
    for obs in observations:
        executed = client.infer_round(obs)
        _check(executed.shape == (25, 14) and np.isfinite(executed).all(), f"{label}: executed {executed.shape}")
    clocks.append(_clocks())
    served = {k: v for k, v in _read_launches().items() if v}
    free_graph, guided_graph = policy.graph_for(staged), policy.graph_for(staged, RTC_CHUNK)
    free, capture = ({k: v for k, v in g.capture_launches.items() if v} for g in (free_graph, guided_graph))
    _check(served == {k: 2 * free.get(k, 0) + 2 * capture.get(k, 0) for k in served},
           f"{label}: launches of the rounds {served}, captures {free} (no chunk) and {capture} (guided)")
    want = {"flash_mha": 198, "flash_mha_bwd": 180, "flash_mhsa": 27, **(_rtc_int8_launches() if quantize else {})}
    _check(capture == want, f"{label}: launches of a guided request {capture}, want {want}")
    payloads = [obs for obs, _, _ in timed.calls]
    _check("prev_action_chunk" not in payloads[0] and all("prev_action_chunk" in p for p in payloads[1:]),
           f"{label}: the client sent no chunk after round 0")
    walls = [ms for _, _, ms in timed.calls[2:]]
    infer_ms = [out["policy_timing"]["infer_ms"] for _, out, _ in timed.calls[2:]]
    print(f"{label}: {RTC_ROUNDS} rounds of RTCClient(execute_horizon=25, 25 Hz) on raw Agilex requests; rounds 0-1 "
          f"captured the bucket's graphs (no chunk, guided: {timed.calls[0][2]:.1f} / {timed.calls[1][2]:.1f} ms); "
          f"rounds 2-{RTC_ROUNDS - 1}: wall_ms {_percentiles(walls)}, infer_ms {_percentiles(infer_ms)}; delay "
          f"{client.delay.delay_steps} steps at the end; launches since the counts were set to 0: {served}; SM clock, "
          f"max SM clock, power draw, temperature before / after: {clocks[0]} / {clocks[1]}")

    # The graph against the eager sampler, on the last round's staged inputs, chunk, delay, horizon and noise.
    last = payloads[-1]
    rtc = {k: last[k] for k in ("prev_action_chunk", "inference_delay", "execute_horizon")}
    noise = rng.standard_normal((50, 32)).astype(np.float32)
    staged_last = policy.stage_inputs(last)
    x0 = _rtc_graph_x0(policy, staged_last, noise, rtc)
    eager, eager_launches = _rtc_eager(policy.model, staged_last, noise, rtc)
    _check(np.array_equal(eager, x0), f"{label}: the graphed x_0 differs from the eager RTC sampler's")
    _check(eager_launches == capture, f"{label}: eager launches {eager_launches}, capture {capture}")
    print(f"{label}: guided graph x_0 bit-equal to the eager RTC sampler's on the last round's inputs (delay "
          f"{rtc['inference_delay']}, horizon {rtc['execute_horizon']}); eager launches = capture = {eager_launches}")

    # Model level: the guided rows [d, exec_h) lie nearer the previous chunk than the unguided sample's.
    unguided = _rtc_graph_x0(policy, staged, noise, None)
    prev = unguided[0] + 0.5
    pulled = _rtc_graph_x0(policy, staged, noise, {"prev_action_chunk": prev, "inference_delay": 2,
                                                   "execute_horizon": 25})
    d_free = float(np.abs(unguided[0, 2:25, :14] - prev[2:25, :14]).mean())
    d_guided = float(np.abs(pulled[0, 2:25, :14] - prev[2:25, :14]).mean())
    print(f"{label}: rows [2, 25) of x_0, mean |x_0 - prev|: unguided {d_free:.4f}, guided {d_guided:.4f}; "
          f"rows [25, 50): {np.abs(unguided[0, 25:] - prev[25:]).mean():.4f} / {np.abs(pulled[0, 25:] - prev[25:]).mean():.4f}")
    _check(np.isfinite(pulled).all() and d_guided < d_free, f"{label}: guidance did not pull toward the chunk")

    # A profiled replay of the guided graph: its kernels by name and count, against the capture's launch counts.
    # (Not against a profiled eager request: the profiler drops some of the kernels autograd's thread launches.)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof_replay:
        _rtc_graph_x0(policy, staged_last, noise, rtc)
    families, replay_ms, attention = _profile_families(prof_replay)
    by_count = {k.split("::")[-1]: count for k, (_, count) in attention.items()}
    seen = {"flash_mha": by_count.get("mqa_fwd"), "flash_mha_bwd": by_count.get("mqa_bwd_dq"),
            "flash_mhsa": by_count.get("mhsa_fwd")}
    _check(seen == {k: capture[k] for k in seen} and by_count.get("mqa_bwd_dkdv") == capture["flash_mha_bwd"],
           f"{label}: attention kernels of the replay {by_count}, launches at capture {capture}")
    print(f"{label}: one replayed guided request: {replay_ms:.2f} ms of device time in "
          f"{sum(c for _, c in families.values())} kernels; by family: " + "; ".join(
              f"{fam} {ms:.2f} ms x{count}" for fam, (ms, count) in sorted(families.items(), key=lambda kv: -kv[1][0])))
    print(f"  attention kernels of the replay (K1f, K1b, K2f as captured): {by_count}")
    if quantize:
        counts = _check_int8_orientations(_kernels_named(prof_replay, "int8_mm"), f"{label} replay")
        want_kernels = {"wgmma nt": 18 * 6, "wgmma nn": 0, "splitk nt": 18 * 10 * (6 + 2), "mma.sync nt": 0,
                        "mma.sync nn": 18 * 10 * 6}
        _check(counts == want_kernels, f"{label}: int8 kernels of the replay {counts}, want {want_kernels}")
        k5 = _kernels_named(prof_replay, "row_quant")
        colscale = sum(c for name, (_, c) in k5.items() if name.split("<")[1].split(",")[1].strip(" >") == "true")
        _check(sum(c for _, c in k5.values()) == want["row_quant"] and colscale == want["row_quant_colscale"],
               f"{label}: K5 kernels of the replay {k5}")
        print(f"  row_quant kernels of the {label} replay: {colscale} with the column scale of "
              f"{sum(c for _, c in k5.values())}: " + "; ".join(f"{k} {ms:.2f} ms x{c}" for k, (ms, c) in k5.items()))
    guidance = None if quantize else _serve_rtc_guidance(cfg, ckpt, policy, last, noise)
    return capture, policy, walls, guidance


RTC_GUIDANCE = 5.0  # max_guidance_weight: the client's default (train_deploy_alignment/inference/inference_client.py:274)


def _serve_rtc_guidance(cfg, ckpt: str, half: object, request: dict, noise: np.ndarray) -> dict:
    """Phase 15, continued (bf16): ``create_trained_policy(..., sample_kwargs={"max_guidance_weight": 5.0})`` serves
    the last round's guided request twice; the first captures the guided graph at that cap with the counts at 0. Its
    x_0 must equal the eager RTC sampler's at that cap, bit for bit, and differ from the default cap's (0.5) graph.
    Returns the launches of that capture."""
    from kai0_tpu_torch.models import pi0_rtc
    from kai0_tpu_torch.policies import graphs, policy_config

    kwargs = {"max_guidance_weight": RTC_GUIDANCE}
    t = time.perf_counter()
    policy = policy_config.create_trained_policy(cfg, ckpt, prompt_buckets=RTC_BUCKETS, sample_kwargs=kwargs)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    _reset_launches()
    walls, outs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(policy.infer(request, noise=noise))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1000)
    served = {k: v for k, v in _read_launches().items() if v}
    _check(np.array_equal(outs[0]["actions"], outs[1]["actions"]) and np.isfinite(outs[0]["actions"]).all(),
           f"RTC guidance {RTC_GUIDANCE}: the replay's actions differ from the capturing request's")
    rtc = {k: request[k] for k in pi0_rtc.RTC_KEYS}
    staged = policy.stage_inputs(request)
    config = policy.model_config
    chunk, provided, _ = pi0_rtc.rtc_inputs(rtc["prev_action_chunk"], rtc["inference_delay"], rtc["execute_horizon"],
                                            config.action_horizon, config.action_dim)
    key = graphs.signature(staged, (chunk.shape[1], provided), kwargs)
    _check(list(policy.graphs) == [key], f"RTC guidance {RTC_GUIDANCE}: graphs {list(policy.graphs)}")
    capture = {k: v for k, v in policy.graphs[key].capture_launches.items() if v}
    want = {"flash_mha": 198, "flash_mha_bwd": 180, "flash_mhsa": 27}
    _check(capture == want and served == {k: 2 * v for k, v in want.items()},
           f"RTC guidance {RTC_GUIDANCE}: launches at capture {capture}, of the requests {served}")
    x0 = _rtc_graph_x0(policy, staged, noise, rtc)
    eager, eager_launches = _rtc_eager(policy.model, staged, noise, {**rtc, **kwargs})
    _check(np.array_equal(eager, x0) and eager_launches == capture,
           f"RTC guidance {RTC_GUIDANCE}: graph against eager: equal {np.array_equal(eager, x0)}, launches "
           f"{eager_launches}")
    x0_half = _rtc_graph_x0(half, staged, noise, rtc)
    _check(not np.array_equal(x0_half, x0), f"RTC guidance {RTC_GUIDANCE}: the cap did not move x_0")
    print(f"RTC bf16, max_guidance_weight={RTC_GUIDANCE}: create_trained_policy(..., sample_kwargs={kwargs}) in "
          f"{load_s:.2f}s; the last round's guided request (delay {rtc['inference_delay']}) captured its graph "
          f"(key {key[-2]}) in {walls[0]:.1f} ms with launches {capture}; its replay {walls[1]:.2f} ms, infer_ms "
          f"{outs[1]['policy_timing']['infer_ms']:.2f}; x_0 bit-equal to the eager RTC sampler's at that cap; "
          f"|x_0(5.0) - x_0(0.5)| max {np.abs(x0 - x0_half).max():.4e}")
    del policy
    torch.cuda.empty_cache()
    return capture


def rtc_card_vs_host() -> None:
    """Phase 15, continued: a guided RTC sample at full width, depth cut to 2, f32, on the card (kernels: K1f and K1b
    on the scalar f32 path) and on the host CPU (plain versions), from the same weights, inputs, chunk and noise."""
    from kai0_tpu_torch.models.model import Observation
    from kai0_tpu_torch.models.pi0_rtc import Pi0RTC

    config = _cut_depth_config(2, pi05=True, dtype="float32")
    model = Pi0RTC(config, device="cuda", param_dtype=torch.float32).init_weights(
        torch.Generator(device="cuda").manual_seed(18)).eval()
    rng = np.random.default_rng(18)
    staged = {k: ({n: x[None] for n, x in v.items()} if isinstance(v, dict) else np.asarray(v)[None])
              for k, v in _request_inputs(rng).items()}
    noise = rng.standard_normal((1, 50, 32)).astype(np.float32)
    rtc = {"prev_action_chunk": rng.uniform(-1, 1, (50, 14)).astype(np.float32), "inference_delay": 3,
           "execute_horizon": 25}
    outs, times = [], []
    for device in ("cuda", "cpu"):
        model.to(device)
        obs = Observation.from_dict({k: ({n: torch.from_numpy(np.array(x)).to(device) for n, x in v.items()}
                                         if isinstance(v, dict) else torch.from_numpy(np.array(v)).to(device))
                                     for k, v in staged.items()})
        t = time.perf_counter()
        outs.append(model.sample_actions(obs, noise=torch.from_numpy(noise).to(device), **rtc).cpu().numpy())
        times.append(time.perf_counter() - t)
    err = float(np.abs(outs[0] - outs[1]).max())
    print(f"RTC full width, depth 2, f32, guided (delay 3, horizon 25): card (kernels) vs host CPU (plain) "
          f"max_abs_err={err:.3e} (|actions| max {np.abs(outs[1]).max():.3f}; card {times[0]:.2f}s, host "
          f"{times[1]:.2f}s)")
    _check(np.isfinite(outs[0]).all() and err <= FULL_WIDTH_TOL, f"RTC card vs host: {err}")
    del model


class _Recorder:
    """A policy that records the reply each observation got, by the observation's identity."""

    def __init__(self, policy):
        self.policy, self.replies = policy, {}
        self.metadata, self.model_config = policy.metadata, policy.model_config

    def _record(self, obs_list, replies):
        for obs, reply in zip(obs_list, replies, strict=True):
            self.replies[id(obs)] = reply
        return replies

    def infer(self, obs):
        return self._record([obs], [self.policy.infer(obs)])[0]

    def infer_batch(self, obs_list, *, noise=None, pad_to=None):
        return self._record(obs_list, self.policy.infer_batch(obs_list, noise=noise, pad_to=pad_to))


def serve_batched(ckpt: str) -> dict:
    """Phase 16: ``infer_batch`` at padded sizes 1-8 (bf16) and 4 (int8), then ``BatchingPolicy`` under 8 threads;
    returns the launches of one batch of 8 (bf16) and of 4 (int8), each its graph's capture."""
    import threading

    from kai0_tpu_torch.policies import policy_config
    from kai0_tpu_torch.serving.batching import BatchingPolicy
    from kai0_tpu_torch.training import config as train_config

    cfg = train_config.get_config(ENTRY_CONFIG)
    rng = np.random.default_rng(17)
    requests = _agilex_requests(cfg, rng, max(BATCH_SIZES))
    noises = rng.standard_normal((max(BATCH_SIZES), 50, 32)).astype(np.float32)
    launches = {}
    for quantize, sizes in ((False, BATCH_SIZES), (True, (4,))):
        label = "batched int8" if quantize else "batched bf16"
        policy = policy_config.create_trained_policy(cfg, ckpt, prompt_buckets=ENTRY_BUCKETS, quantize=quantize)
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        walls_by_size = {}
        for size in sizes:
            first = policy.infer_batch(requests[:size], noise=noises[:size], pad_to=size)  # captures
            staged_key = [g for g in policy.graphs.values() if g.noise_shape[0] == size]
            _check(len(staged_key) == 1, f"{label}: {len(staged_key)} graphs of batch {size}")
            capture = {k: v for k, v in staged_key[0].capture_launches.items() if v}
            walls = []
            for _ in range(BATCH_REPEATS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = policy.infer_batch(requests[:size], noise=noises[:size])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1000)
            for i, (a, b) in enumerate(zip(first, out, strict=True)):
                _check(np.array_equal(a["actions"], b["actions"]), f"{label} {size}: row {i} changed between replays")
            worst = (0.0, 0.0)
            for i in range(size):
                alone = policy.infer(requests[i], noise=noises[i])["actions"]
                diff = np.abs(out[i]["actions"] - alone)
                _check(out[i]["actions"].shape == (50, 14) and np.isfinite(out[i]["actions"]).all()
                       and diff.max() <= BF16_SAMPLE_TOL["max"] * np.abs(alone).max()
                       and diff.mean() <= BF16_SAMPLE_TOL["mean"] * np.abs(alone).mean(),
                       f"{label} {size}: row {i} against the same request alone: max {diff.max()}, mean {diff.mean()}")
                worst = max(worst, (float(diff.max()), float(diff.mean())))
            p50 = float(np.percentile(walls, 50))
            walls_by_size[size] = p50
            print(f"{label} batch {size}: wall_ms {_percentiles(walls)} over {BATCH_REPEATS} batches, robots/s "
                  f"{size / p50 * 1000:.2f}; rows against the same request alone: worst max_abs_diff {worst[0]:.4e}, "
                  f"mean {worst[1]:.4e}; launches at capture {capture}")
            launches[(quantize, size)] = capture
        served = {k: v for k, v in _read_launches().items() if v}
        _check(served == {k: 2 * sum(launches[(quantize, b)].get(k, 0) for b in sizes)
                          + (0 if 1 in sizes else 2 * launches[(quantize, sizes[0])].get(k, 0)) for k in served},
               f"{label}: launches since the counts were set to 0 {served}")
        print(f"{label}: peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB with the graphs of batch "
              f"{list(sizes)} (and 1) captured; launches since the counts were set to 0 {served}")
        if quantize:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                policy.infer_batch(requests[:4], noise=noises[:4])
            counts = _check_int8_orientations(_kernels_named(prof, "int8_mm"), f"{label} batch 4 replay")
            want = {"wgmma nt": 18 * 6 * 11, "wgmma nn": 0, "splitk nt": 0, "mma.sync nt": 0, "mma.sync nn": 0}
            _check(counts == want, f"{label}: int8 kernels of a batch of 4 {counts}, want {want}")
        else:
            recorder = _Recorder(policy)
            batcher = BatchingPolicy(recorder, max_batch=8)
            replies: dict = {}
            barrier = threading.Barrier(8)

            def robot(i: int) -> None:
                barrier.wait()
                for r in range(5):
                    obs = {**requests[i], "state": requests[i]["state"] + 0.01 * r}
                    replies[(i, r)] = (obs, batcher.infer(obs))

            threads = [threading.Thread(target=robot, args=(i,)) for i in range(8)]
            t = time.perf_counter()
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=120)
            wall = time.perf_counter() - t
            batcher.close()
            _check(not any(th.is_alive() for th in threads) and len(replies) == 40, "BatchingPolicy: a robot hung")
            _check(all(recorder.replies[id(obs)] is reply for obs, reply in replies.values()),
                   "BatchingPolicy: a robot got another request's reply")
            _check(max(batcher.batch_sizes) > 1 and sum(batcher.batch_sizes) == 40,
                   f"BatchingPolicy: no coalescing {batcher.batch_sizes}")
            print(f"BatchingPolicy(max_batch=8): 8 robot threads x 5 requests in {wall:.2f}s "
                  f"({40 / wall:.2f} requests/s); dispatches {batcher.batch_sizes}; each robot got its own replies")
        del policy
        torch.cuda.empty_cache()
    return {"bf16": launches[(False, 8)], "int8": launches[(True, 4)]}


def serve_wire(policy, rtc_walls: list[float]) -> dict:
    """Phase 17: the port's server in a thread on 127.0.0.1, the port's client on the same machine: raw Agilex
    requests and RTC rounds over the wire beside the same in process; then phase 24 against the same server.
    Returns phase 24's launches."""
    import asyncio
    import contextlib
    import http.client
    import importlib.util
    import socket
    import threading

    from kai0_tpu_torch.deploy.rtc_client import RTCClient
    from kai0_tpu_torch.serving import msgpack_numpy
    from kai0_tpu_torch.serving.client import WebsocketClientPolicy
    from kai0_tpu_torch.serving.websocket_policy_server import WebsocketPolicyServer
    from kai0_tpu_torch.training import config as train_config

    print("import probe: " + ", ".join(f"{name} {'present' if importlib.util.find_spec(name) else 'absent'}"
                                       for name in ("websockets", "msgpack")))
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    stop = threading.Event()

    async def serve() -> None:  # the server until ``stop`` is set, then cancelled and awaited
        task = asyncio.create_task(WebsocketPolicyServer(policy, host="127.0.0.1", port=port,
                                                         metadata=policy.metadata).run())
        while not (stop.is_set() or task.done()):
            await asyncio.sleep(0.05)
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await task

    thread = threading.Thread(target=asyncio.run, args=(serve(),), daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 30
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                _check(time.monotonic() < deadline and thread.is_alive(), "the server did not start")
                time.sleep(0.05)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/healthz")
        response = conn.getresponse()
        _check((response.status, response.read()) == (200, b"OK\n"), "GET /healthz")
        cfg = train_config.get_config(RTC_CONFIG)
        requests = _agilex_requests(cfg, np.random.default_rng(19), WIRE_REQUESTS)
        local = _Timed(policy)
        for obs in requests:
            local.infer(obs)
        client = WebsocketClientPolicy(host="127.0.0.1", port=port, retry_interval_s=0.2)
        _check(client.get_server_metadata() == policy.metadata, "server metadata")
        wire, sizes = [], []
        for obs in requests:
            t = time.perf_counter()
            reply = client.infer(obs)
            wire.append((time.perf_counter() - t) * 1000)
            _check(reply["actions"].shape == (50, 14) and np.isfinite(reply["actions"]).all(), "wire actions")
            sizes.append((len(msgpack_numpy.packb(obs)), len(msgpack_numpy.packb(reply))))
        rtc_timed = _Timed(client)
        rtc_client = RTCClient(rtc_timed, action_dim=32, chunk_size=50, execute_horizon=25, publish_rate=25.0)
        for obs in requests:
            _check(rtc_client.infer_round(obs).shape == (25, 14), "wire RTC round")
        rtc_wire = [ms for _, _, ms in rtc_timed.calls[1:]]
        rtc_sizes = len(msgpack_numpy.packb(rtc_client.make_payload(requests[-1])))
        client.close()
        local_ms = [ms for _, _, ms in local.calls]
        print(f"wire: {WIRE_REQUESTS} raw Agilex requests through the port's client and server on 127.0.0.1: wall_ms "
              f"{_percentiles(wire)} against {_percentiles(local_ms)} in process (the same policy and requests); "
              f"{sizes[0][0]} bytes a request, {sizes[0][1]} a reply; {WIRE_REQUESTS} RTC rounds over the wire: rounds "
              f"1-{WIRE_REQUESTS - 1} wall_ms {_percentiles(rtc_wire)} against phase 15's in process {_percentiles(rtc_walls)};"
              f" {rtc_sizes} bytes a guided request; GET /healthz 200")
        edge = timed("24 robot edge", robot_edge, policy, port)
    finally:
        stop.set()
        thread.join(timeout=30)
    _check(not thread.is_alive(), "the server did not stop")
    return edge


# ---------------------------------------------------------------------------
# Phase 24: the robot edge against phase 17's server
# ---------------------------------------------------------------------------

CLIENT_MODES = ("sync", "smooth", "ensemble", "rtc")
CLIENT_STEPS, CLIENT_PUBLISH_HZ, CLIENT_INFER_HZ = 50, 25.0, 4.0
CLI_STEPS = 25
DAGGER_FRAMES = 30
# Keys sent after that many published frames: record, take over, resume, save; quit once the loop saved (without
# h5py the save raises first). Frames 2-30 are recorded, 10-17 labelled interventions.
DAGGER_KEYS = {2: " ", 10: "d", 18: "r", DAGGER_FRAMES: "s", DAGGER_FRAMES + 1: "q"}


class _WireTimed:
    """A wire client whose ``infer`` records each request's wall ms (no synchronize: the server runs the card)."""

    def __init__(self, client):
        self.client, self.ms = client, []

    def infer(self, obs: dict) -> dict:
        t = time.perf_counter()
        out = self.client.infer(obs)
        self.ms.append((time.perf_counter() - t) * 1000)
        return out


class _Published:
    """A robot that keeps each published action and the time it was published, and sends its cameras HWC when
    ``hwc`` (the DAgger collector's mp4 writer takes HWC; the client's robots send CHW)."""

    def __init__(self, robot, hwc: bool = False, on_publish=None):
        self.robot, self.hwc, self.on_publish = robot, hwc, on_publish
        self.actions, self.times = [], []

    def get_observation(self) -> dict:
        obs = self.robot.get_observation()
        if self.hwc:
            obs["images"] = {c: np.ascontiguousarray(x.transpose(1, 2, 0)) for c, x in obs["images"].items()}
        return obs

    def publish_action(self, action) -> None:
        self.times.append(time.perf_counter())
        self.actions.append(np.array(action, copy=True))
        self.robot.publish_action(action)
        if self.on_publish is not None:
            self.on_publish(len(self.actions))


def _toolchain_probe() -> str:
    import importlib.util
    import os
    import shutil
    import sysconfig

    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    version = subprocess.run([found, "--version"], capture_output=True, text=True).stdout.splitlines()[0] if found else "absent"
    include = pathlib.Path(sysconfig.get_paths()["include"])
    return (f"{cxx}: {version}; Python.h {'present' if (include / 'Python.h').exists() else 'absent'} in {include}; "
            + ", ".join(f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}" for m in ("h5py", "cv2")))


def robot_edge(policy, port: int) -> dict:
    """Phase 24: the port's robot edge against phase 17's server (``pi05_rtc_flatten_fold_inference`` at full width,
    bf16) on 127.0.0.1. The native buffers built from ``kai0_tpu_torch/native`` (build seconds, the compiler, and
    whether ``Python.h``, ``h5py`` and ``cv2`` are here); ``make_stream_buffer`` / ``make_ensembling_buffer`` must give
    the C++ buffers. The client's four modes in turn on ``SimRobot`` (the Agilex cameras) over the port's wire
    client, 25 Hz publishing, 4 Hz inference for smooth and ensemble, 50 steps each: exactly 50 finite actions, the
    requests, the publish period and the wall a request; each mode's first request captures its graphs with the
    counts at 0 (the bucket's graphs are dropped just before), so the K1f, K2f (and, rtc, K1b) launches of the mode,
    each > 0, are twice its captures. Then ``scripts/inference_client_torch.py --sim --mode smooth`` as a process,
    which must exit 0. Last, the DAgger driver (``scripts/dagger_collect_torch.py``'s ``run``) over 30 frames whose
    actions come from the server: infer, record, take over, resume, save; without ``h5py`` the save must raise
    naming it, with it the port's ``convert_h5`` must read the episode back. Returns each mode's launches."""
    import importlib.util
    import tempfile

    from kai0_tpu_torch import deploy, native
    from kai0_tpu_torch.deploy import dagger, native_buffers
    from kai0_tpu_torch.policies import graphs
    from kai0_tpu_torch.serving.client import WebsocketClientPolicy
    from kai0_tpu_torch.training import config as train_config

    root = pathlib.Path(__file__).resolve().parent
    t = time.perf_counter()
    native.load()
    load_s = time.perf_counter() - t
    built = f"built in {native.build_seconds}s" if native.build_seconds is not None else "already built"
    print(f"robot edge: native buffers {native.library_path().relative_to(root)} {built} (load {load_s:.2f}s); "
          + _toolchain_probe())
    _check(isinstance(deploy.make_stream_buffer(), native_buffers.NativeStreamActionBuffer)
           and isinstance(deploy.make_ensembling_buffer(), native_buffers.NativeTemporalEnsemblingBuffer),
           "make_stream_buffer / make_ensembling_buffer did not give the native buffers")
    client = _script("inference_client_torch")
    prompt = train_config.get_config(RTC_CONFIG).data.default_prompt
    sample = client.SimRobot(cameras=AGILEX_CAMERAS).get_observation()
    staged = policy.stage_inputs({**sample, "prompt": prompt})

    launches = {}
    for mode in CLIENT_MODES:
        chunks = (None, RTC_CHUNK) if mode == "rtc" else (None,)
        for chunk in chunks:  # the mode's first requests capture the bucket's graphs again, with the counts at 0
            policy.graphs.pop(graphs.signature(staged, chunk), None)
        wire = _WireTimed(WebsocketClientPolicy(host="127.0.0.1", port=port, retry_interval_s=0.2))
        robot = _Published(client.SimRobot(cameras=AGILEX_CAMERAS))
        common = dict(policy=wire, robot=robot, prompt=prompt, publish_rate=CLIENT_PUBLISH_HZ, max_steps=CLIENT_STEPS)
        _reset_launches()
        t = time.perf_counter()
        if mode == "sync":
            client.run_sync(**common)
        elif mode == "smooth":
            client.run_smooth(**common, infer_rate=CLIENT_INFER_HZ)
        elif mode == "ensemble":
            client.run_ensemble(**common, infer_rate=CLIENT_INFER_HZ)
        else:
            client.run_rtc(**common)
        mode_s = time.perf_counter() - t
        wire.client.close()
        served = {k: v for k, v in _read_launches().items() if v}
        captures = [{k: v for k, v in policy.graphs[graphs.signature(staged, c)].capture_launches.items() if v}
                    for c in chunks]
        twice = {k: 2 * sum(c.get(k, 0) for c in captures) for k in served}
        need = ("flash_mha", "flash_mhsa") + (("flash_mha_bwd",) if mode == "rtc" else ())
        _check(len(robot.actions) == CLIENT_STEPS and all(a.shape == (14,) and np.isfinite(a).all() for a in robot.actions),
               f"client {mode}: {len(robot.actions)} actions published")
        _check(all(served.get(k, 0) > 0 for k in need) and served == twice,
               f"client {mode}: launches {served}, the mode's captures {captures}")
        periods = np.diff(robot.times) * 1000
        print(f"client {mode}: {CLIENT_STEPS} finite actions published at {CLIENT_PUBLISH_HZ:g} Hz"
              f"{f', inference at {CLIENT_INFER_HZ:g} Hz' if mode in ('smooth', 'ensemble') else ''} in {mode_s:.2f}s; "
              f"{len(wire.ms)} requests, wall ms a request: first {wire.ms[0]:.1f} (captures), then "
              f"{_percentiles(wire.ms[1:]) if len(wire.ms) > 1 else 'none'}; publish period ms {_percentiles(periods)}; "
              f"launches {served} (= the mode's captures twice)")
        launches[mode] = served

    t = time.perf_counter()
    cli = subprocess.run([sys.executable, str(root / "scripts" / "inference_client_torch.py"), "--sim", "--mode",
                          "smooth", "--max-steps", str(CLI_STEPS), "--host", "127.0.0.1", "--port", str(port)],
                         capture_output=True, text=True, timeout=180, cwd=root)
    print(f"client CLI: scripts/inference_client_torch.py --sim --mode smooth --max-steps {CLI_STEPS} exited "
          f"{cli.returncode} in {time.perf_counter() - t:.2f}s")
    _check(cli.returncode == 0, f"the client CLI failed:\n{cli.stderr[-3000:]}")

    collect = _script("dagger_collect_torch")
    sm = dagger.DaggerStateMachine()
    sm.on_key("enter")
    with tempfile.TemporaryDirectory(prefix="kai0_dagger_") as tmp:
        collector = dagger.DAggerCollector(list(AGILEX_CAMERAS), tmp, fps=CLIENT_PUBLISH_HZ)

        def keys(frames: int) -> None:
            if frames in DAGGER_KEYS:
                sm.on_key(DAGGER_KEYS[frames])

        robot = _Published(client.SimRobot(cameras=AGILEX_CAMERAS), hwc=True, on_publish=keys)
        wire = _WireTimed(WebsocketClientPolicy(host="127.0.0.1", port=port, retry_interval_s=0.2))
        t = time.perf_counter()
        error = None
        try:
            collect.run(wire, robot, client.SimRobot(), collector, sm, prompt, CLIENT_PUBLISH_HZ)
        except ImportError as e:  # held to the probe's answer below
            error = e
        dagger_s = time.perf_counter() - t
        wire.client.close()
        frames = len(robot.actions)
        if importlib.util.find_spec("h5py") is None:
            _check(error is not None and "h5py" in str(error) and collector.frame_count == DAGGER_FRAMES - 1,
                   f"DAgger without h5py: the save gave {error!r} with {collector.frame_count} frames")
            outcome = f"save_episode raised as it must without h5py ({error}); {collector.frame_count} frames kept"
        else:
            from kai0_tpu_torch.augment import convert_h5

            saved = pathlib.Path(tmp) / "episode_0.hdf5"
            _check(error is None and saved.exists(), f"DAgger: the save failed: {error!r}")
            meta = convert_h5.convert_h5_to_lerobot(tmp, pathlib.Path(tmp) / "lerobot", task=prompt,
                                                    cameras=list(AGILEX_CAMERAS), fps=CLIENT_PUBLISH_HZ)
            _check(meta.info["total_episodes"] == 1 and meta.info["total_frames"] == DAGGER_FRAMES - 1,
                   f"DAgger: convert_h5 read {meta.info['total_frames']} frames")
            outcome = f"saved {saved.name}, read back by convert_h5: {meta.info['total_frames']} frames"
    # a request at frame 1 and at frame 19 (after the take-over), and with h5py one more after the save
    _check(frames == DAGGER_FRAMES + (error is None) and len(wire.ms) == 2 + (error is None),
           f"DAgger: {frames} frames, {len(wire.ms)} requests")
    print(f"dagger: {frames} SimRobot frames (infer; record from frame 2, take over at 10, resume at 18, save at "
          f"{DAGGER_FRAMES}) in {dagger_s:.2f}s, {len(wire.ms)} requests to the server (wall ms "
          f"{[round(m, 1) for m in wire.ms]}); {outcome}")
    return launches


def _quantile_stats(width: int = 32) -> dict:
    """Synthetic quantile norm stats of the ``width``-wide state and actions (phases 14, 18 and 20; π₀-FAST's are
    8-wide: its state and actions are not padded)."""
    from kai0_tpu_torch.shared import normalize

    rng = np.random.default_rng(15)
    stats = {}
    for key in ("state", "actions"):
        lo = rng.uniform(-1.5, -0.5, width)
        stats[key] = normalize.NormStats(mean=np.zeros(width), std=np.ones(width), q01=lo,
                                         q99=lo + rng.uniform(1, 3, width))
    return stats


def serve_entry() -> dict:
    """Phases 14-17 on one seeded checkpoint: serving through the entry points a robot operator calls, at full width,
    bf16 then int8 (14), then weight-only and SigLIP + Gemma int8 (23 (d)); RTC (15); batched requests (16); the
    websocket server on this machine (17)."""
    import tempfile

    from kai0_tpu_torch import interop
    from kai0_tpu_torch.models.pi0 import Pi0
    from kai0_tpu_torch.shared import normalize
    from kai0_tpu_torch.training import config as train_config

    cfg = train_config.get_config(ENTRY_CONFIG)
    asset_id = cfg.data.create(cfg.assets_dirs, cfg.model).asset_id
    launches = {}
    with tempfile.TemporaryDirectory(prefix="kai0_checkpoint_") as ckpt:
        t = time.perf_counter()
        model = Pi0(cfg.model, device="cuda", param_dtype=torch.bfloat16).init_weights(
            torch.Generator(device="cuda").manual_seed(14))
        path = interop.save_torch_checkpoint(model, ckpt)
        del model
        torch.cuda.empty_cache()
        normalize.save(pathlib.Path(ckpt) / "assets" / asset_id, _quantile_stats())
        print(f"entry: seeded bf16 pi05 written to {path.name} ({path.stat().st_size / 1e9:.3f} GB) with synthetic "
              f"quantile norm stats under assets/{asset_id} in {time.perf_counter() - t:.1f}s")
        served = {("int8" if quantize else "bf16"): _serve_entry_once(cfg, ckpt, quantize) for quantize in (False, True)}
        launches.update({label: rec["capture"] for label, rec in served.items()})
        launches["bf16_5step"] = served["bf16"]["five_steps"]
        launches["int8_modes"] = timed("23 (d) serving int8 modes", serve_int8_modes, cfg, ckpt, served)
        del served
        rtc_cfg = train_config.get_config(RTC_CONFIG)
        launches["rtc_bf16"], rtc_policy, rtc_walls, launches["rtc_bf16_guidance5"] = _serve_rtc_once(
            rtc_cfg, ckpt, quantize=False)
        launches["rtc_int8"], int8_policy, _, _ = _serve_rtc_once(rtc_cfg, ckpt, quantize=True)
        del int8_policy
        torch.cuda.empty_cache()
        rtc_card_vs_host()
        batched = serve_batched(ckpt)
        launches["b8"], launches["b4_int8"] = batched["bf16"], batched["int8"]
        launches["client"] = serve_wire(rtc_policy, rtc_walls)
        del rtc_policy
        torch.cuda.empty_cache()
    return launches


TRAIN_ENTRY_STEPS, TRAIN_ENTRY_RESUMED = 4, 6  # the first run's steps, and the step count the resume runs to
# Launches of one full fine-tune step at batch 32 (phase 9's), which every step of the entry's first run must make.
TRAIN_STEP_LAUNCHES = {"flash_mha": 36, "flash_mha_bwd": 18, "flash_mhsa": 54, "flash_mhsa_bwd": 27, "adam_q8": 1,
                       "row_quant": 0, "row_quant_colscale": 0, "int8_matmul": 0, "int8_matmul_lora": 0}
# What could read and decode LeRobot data here, and what the JAX package's data tools use (not promised here).
DECODER_PROBE = ("pyarrow", "cv2", "av", "torchvision", "decord", "pandas", "h5py", "tqdm")


_PROBED: dict = {}


def _probe(modules) -> dict:
    """Each module's ``__version__`` ("present" without one), or why it does not import; each module probed once a
    run (phase 22 reads what phase 18 found)."""
    import importlib

    for module in modules:
        if module not in _PROBED:
            try:
                _PROBED[module] = getattr(importlib.import_module(module), "__version__", "present")
            except ImportError as e:
                _PROBED[module] = f"absent ({e})"
    return {module: _PROBED[module] for module in modules}


def _train_entry_config(base, checkpoint_base_dir: str, **overrides):
    """``base`` with phase 18's loop: batch 32, 4 steps, a log each step, one save (the last step), 2 workers; the
    configuration of phase 9 (bf16 parameters, int8 moments, no EMA); metrics.jsonl on."""
    from kai0_tpu_torch.training import optimizer

    fields = dict(exp_name="entry", checkpoint_base_dir=checkpoint_base_dir, batch_size=TRAIN_BATCH,
                  num_train_steps=TRAIN_ENTRY_STEPS, log_interval=1, save_interval=100, num_workers=2,
                  param_dtype="bfloat16", optimizer=optimizer.AdamW(state_dtype="int8"), ema_decay=None,
                  wandb_enabled=True)
    return dataclasses.replace(base, **{**fields, **overrides})


class _StepRecorder:
    """``on_step`` of ``train_lib.main``: per step the wall time since the last step's end (the step, its log and the
    wait for the next batch; a save's time left out), loss, grad_norm, peak memory, the loader's wait and the
    launches of every kernel, held to ``want`` when given."""

    def __init__(self, label: str, batch: int, want: dict | None):
        self.label, self.batch, self.want, self.rows = label, batch, want, []
        self.t = None
        self.before = _read_launches()

    def start(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t = time.perf_counter()

    def __call__(self, step: int, record: dict):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = _read_launches()
        launches = {k: v - self.before[k] for k, v in counts.items()}
        self.before = counts
        row = {"step": step, "wall_ms": (now - self.t - record.get("save_s", 0.0)) * 1000,
               "loss": float(record["loss"]), "grad_norm": float(record["grad_norm"]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "loader_wait_ms": record["loader_wait_ms"],
               "launches": launches, **{k: record[k] for k in ("save_s", "save_bytes") if k in record}}
        self.rows.append(row)
        print(f"  {self.label} step {step}: wall_ms={row['wall_ms']:.2f} samples_per_s="
              f"{self.batch / row['wall_ms'] * 1000:.3f} loss={row['loss']:.6f} grad_norm={row['grad_norm']:.6f} "
              f"peak_mem_gib={row['peak_gib']:.3f} loader_wait_ms={row['loader_wait_ms']:.3f} launches={launches}"
              + (f" save_s={row['save_s']:.3f} save_bytes={row['save_bytes']}" if "save_s" in row else ""))
        _check(np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"]) and row["grad_norm"] > 0,
               f"{self.label} step {step}: loss {row['loss']}, grad_norm {row['grad_norm']}")
        if self.want is not None:
            _check(launches == self.want, f"{self.label} step {step}: launches {launches}, want {self.want}")
        self.start()


def _differing(a: dict, b: dict) -> list[str]:
    """Names whose tensors differ in dtype, shape or bits (nested dicts flattened)."""
    out = []
    for k in a.keys() | b.keys():
        x, y = a.get(k), b.get(k)
        if isinstance(x, dict) and isinstance(y, dict):
            out += [f"{k}/{n}" for n in _differing(x, y)]
        elif not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and x.dtype == y.dtype
                  and torch.equal(x, y)):
            out.append(k)
    return out


def train_entry() -> dict:
    """Phase 18: training through the entry point (``train_lib.main`` and ``scripts/train_torch.py``) at full width,
    its checkpoints, resume and serving; returns the launches of the first run's 4 steps."""
    import os
    import shutil
    import tempfile

    from kai0_tpu_torch import interop
    from kai0_tpu_torch.models.pi0 import Pi0
    from kai0_tpu_torch.policies import policy_config
    from kai0_tpu_torch.shared import normalize
    from kai0_tpu_torch.training import checkpoints, train_lib, weight_loaders
    from kai0_tpu_torch.training import config as train_config

    print(f"train entry: decoder probe: {_probe(DECODER_PROBE)}")
    # The loop's MetricsLogger uses wandb when it imports; this machine may have it and has no network.
    os.environ["WANDB_MODE"] = "disabled"

    base = train_config.get_config("pi05_base")
    n = sum(p.numel() for p in Pi0(base.model, device="meta").parameters())
    # A checkpoint: bf16 parameters (2 bytes each) + int8 mu and nu codes (2) + their f32 block scales.
    checkpoint_bytes = 4 * n + 8 * sum(-(-p.numel() // 2048) for p in Pi0(base.model, device="meta").parameters())
    needed = 2 * n + 2 * checkpoint_bytes  # the starting weights, and two steps on disk while the resume saves
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    print(f"train entry: {free / 1e9:.3f} GB free under {tmp}; {needed / 1e9:.3f} GB needed (the bf16 weights "
          f"{2 * n / 1e9:.3f} GB and two checkpoints of {checkpoint_bytes / 1e9:.3f} GB)")
    if free < needed:
        raise RuntimeError(f"phase 18 needs {needed} bytes free under {tmp}, which has {free}")

    launches = {}
    with tempfile.TemporaryDirectory(prefix="kai0_train_") as root:
        root = pathlib.Path(root)
        t = time.perf_counter()
        model = Pi0(base.model, device="cuda", param_dtype=torch.bfloat16).init_weights(
            torch.Generator(device="cuda").manual_seed(18))
        weights = interop.save_torch_checkpoint(model, root / "weights")
        del model
        torch.cuda.empty_cache()
        print(f"train entry: seeded bf16 pi05 written to {weights.name} ({weights.stat().st_size / 1e9:.3f} GB) in "
              f"{time.perf_counter() - t:.1f}s")

        # First run: train_lib.main in process from the weights, 4 steps, the save at step 3.
        config = _train_entry_config(base, str(root / "checkpoints"),
                                     weight_loader=weight_loaders.CheckpointWeightLoader(str(weights)))
        print(f"train entry: train_lib.main('pi05_base', batch {TRAIN_BATCH}, {TRAIN_ENTRY_STEPS} steps, bf16 "
              f"parameters, int8 moments, no EMA, 2 loader workers, CheckpointWeightLoader)")
        _reset_launches()
        recorder = _StepRecorder("main", TRAIN_BATCH, TRAIN_STEP_LAUNCHES)
        t = time.perf_counter()
        recorder.start()
        model, state = train_lib.main(config, on_step=recorder)
        total_s = time.perf_counter() - t
        launches = _read_launches()
        walls = [r["wall_ms"] for r in recorder.rows[1:]]
        save = recorder.rows[-1]
        print(f"  main: {total_s:.1f}s in all; median wall_ms over steps 1-{TRAIN_ENTRY_STEPS - 1} = "
              f"{statistics.median(walls):.2f} ({TRAIN_BATCH / statistics.median(walls) * 1000:.3f} samples/s); "
              f"loader wait ms {[round(r['loader_wait_ms'], 3) for r in recorder.rows]}; save of step "
              f"{save['step']}: {save['save_s']:.3f}s, {save['save_bytes']} bytes; launches over "
              f"{TRAIN_ENTRY_STEPS} steps {launches}")
        _check(state.step == TRAIN_ENTRY_STEPS and "save_s" in save, f"main ended at step {state.step}")

        # Restore step 3 into a fresh state: bit for bit the state main returned.
        manager = checkpoints.CheckpointManager(config.checkpoint_dir, keep_period=config.keep_period)
        fresh = Pi0(base.model, device="cuda", param_dtype=torch.bfloat16)
        fresh_state = train_lib.init_train_state(fresh, config, resume=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        restored = checkpoints.restore_state(manager, fresh, fresh_state, step=TRAIN_ENTRY_STEPS - 1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        step_bytes = sum(f.stat().st_size for f in manager.step_dir(TRAIN_ENTRY_STEPS - 1).rglob("*") if f.is_file())
        diff = (_differing(restored.params, state.params) + _differing(restored.opt_state["mu"], state.opt_state["mu"])
                + _differing(restored.opt_state["nu"], state.opt_state["nu"]))
        print(f"  restore of step {TRAIN_ENTRY_STEPS - 1}: {restore_s:.3f}s, {step_bytes} bytes; {len(state.params)} "
              f"parameters and {2 * len(state.opt_state['mu'])} int8 moments (codes and scales) against main's state: "
              f"{len(diff)} differ; count {restored.opt_state['count']}, step {restored.step}")
        _check(not diff and restored.step == state.step and restored.opt_state["count"] == state.opt_state["count"],
               f"restored state differs from main's: {diff[:5]}")
        del model, state, fresh, fresh_state, restored
        torch.cuda.empty_cache()

        # Resume through the script, as a user would: 2 more steps, no starting weights.
        argv = [sys.executable, "scripts/train_torch.py", "pi05_base", "--exp_name=entry",
                f"--checkpoint_base_dir={root / 'checkpoints'}", "--resume", f"--num_train_steps={TRAIN_ENTRY_RESUMED}",
                f"--batch_size={TRAIN_BATCH}", "--log_interval=1", "--save_interval=100", "--num_workers=2",
                "--param_dtype=bfloat16", "--optimizer.state_dtype=int8", "--ema_decay=none", "--wandb_enabled=true"]
        t = time.perf_counter()
        out = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                             cwd=pathlib.Path(__file__).resolve().parent)
        script_s = time.perf_counter() - t
        logged = [line.split("[I] ")[-1].split("  ")[0] for line in out.stderr.splitlines()
                  if " Step " in line or "Saved step" in line or "Restored step" in line]
        print(f"  scripts/train_torch.py --resume --num_train_steps={TRAIN_ENTRY_RESUMED}: rc {out.returncode} in "
              f"{script_s:.1f}s; " + "; ".join(logged))
        _check(out.returncode == 0, f"the resume through the script failed:\n{out.stderr[-4000:]}")
        metrics = [json.loads(line) for line in (config.checkpoint_dir / "metrics.jsonl").read_text().splitlines()]
        _check([m["step"] for m in metrics] == list(range(TRAIN_ENTRY_RESUMED))
               and any("Restored step 3" in line for line in logged), f"metrics.jsonl steps {[m['step'] for m in metrics]}")
        print(f"  metrics.jsonl: {len(metrics)} records, steps {[m['step'] for m in metrics]}, keys {list(metrics[0])}")

        launches_lora = _train_entry_lora(root, weights, base)

        # Serve the resumed checkpoint through the kai0 task config.
        step_dir = manager.step_dir(TRAIN_ENTRY_RESUMED - 1)
        serve_cfg = train_config.get_config(ENTRY_CONFIG)
        asset_id = serve_cfg.data.create(serve_cfg.assets_dirs, serve_cfg.model).asset_id
        normalize.save(step_dir / "assets" / asset_id, _quantile_stats())
        t = time.perf_counter()
        policy = policy_config.create_trained_policy(serve_cfg, step_dir)
        request = _agilex_requests(serve_cfg, np.random.default_rng(18), 1)[0]
        actions = policy.infer(request, noise=np.random.default_rng(18).standard_normal((50, 32)).astype(np.float32))[
            "actions"]
        serve_s = time.perf_counter() - t
        trained = interop.read_safetensors(step_dir / interop.CHECKPOINT_FILE)
        loaded = policy._model.state_dict()
        diff = _differing({k: v.cpu() for k, v in loaded.items()}, trained)
        print(f"  create_trained_policy({ENTRY_CONFIG!r}, '<checkpoints>/{step_dir.name}') and one raw Agilex request in "
              f"{serve_s:.1f}s: actions {actions.shape}, finite {bool(np.isfinite(actions).all())}, max |a| "
              f"{np.abs(actions).max():.4f}; {len(loaded)} loaded tensors against the checkpoint: {len(diff)} differ")
        _check(actions.shape == (50, 14) and np.isfinite(actions).all() and not diff,
               f"serving the trained checkpoint: {actions.shape}, differing {diff[:5]}")
        del policy, loaded, trained
        torch.cuda.empty_cache()
    print(f"train entry: checkpoints deleted; {torch.cuda.memory_allocated() / 2**30:.3f} GiB still allocated")
    return {"full": launches, "lora_int8": launches_lora}


def _train_entry_lora(root: pathlib.Path, weights: pathlib.Path, base) -> dict:
    """Phase 18's LoRA + int8 run and resume in process at full width, depth 2, batch 2: the requantized base
    within one int8 step of the codes saved; returns the launches of the first run."""
    from kai0_tpu_torch.ops import quant
    from kai0_tpu_torch.training import optimizer, train_lib, weight_loaders

    model_config = _cut_depth_config(2, pi05=True, paligemma_variant="gemma_2b_lora",
                                     action_expert_variant="gemma_300m_lora")
    config = _train_entry_config(
        dataclasses.replace(base, name="pi05_lora_int8_depth2", model=model_config), str(root / "checkpoints"),
        batch_size=2, num_workers=0, param_dtype=None, optimizer=optimizer.AdamW(state_dtype="bfloat16"),
        quantize_frozen=True, weight_loader=weight_loaders.CheckpointWeightLoader(str(weights)))
    print(f"train entry: LoRA (rank 16 + rank 32) over an int8 base, depth 2, batch 2, {TRAIN_ENTRY_STEPS} steps, "
          f"then resume to {TRAIN_ENTRY_RESUMED}, in process")
    _reset_launches()
    recorder = _StepRecorder("lora", config.batch_size, None)
    recorder.start()
    model, state = train_lib.main(config, on_step=recorder)
    launches = _read_launches()
    codes = {name: m.qweight.clone() for name, m in model.named_modules() if quant.is_quant(m)}
    del model, state
    recorder = _StepRecorder("lora resume", config.batch_size, None)
    recorder.start()
    model, state = train_lib.main(dataclasses.replace(config, resume=True, num_train_steps=TRAIN_ENTRY_RESUMED),
                                  on_step=recorder)
    moved, worst, total = 0, 0, 0
    for name, m in model.named_modules():
        if quant.is_quant(m):
            d = (m.qweight.to(torch.int32) - codes[name].to(torch.int32)).abs()
            moved, worst, total = moved + int((d > 0).sum()), max(worst, int(d.max())), total + d.numel()
    print(f"  lora: launches over {TRAIN_ENTRY_STEPS} steps {launches}; after the resume, {moved} of {total} int8 codes "
          f"of {len(codes)} holders differ from the codes saved, by at most {worst}; resumed at step {state.step}")
    _check(state.step == TRAIN_ENTRY_RESUMED and len(codes) == 2 * 2 * 6 and worst <= 1,
           f"LoRA + int8 resume: step {state.step}, {len(codes)} holders, codes moved by up to {worst}")
    _check(launches["int8_matmul"] > 0 and launches["row_quant"] > 0 and launches["int8_matmul_lora"] > 0,
           f"the LoRA + int8 run launched no int8 kernel: {launches}")
    del model, state
    torch.cuda.empty_cache()
    return launches


ADVANTAGE_CONFIG, PI06_CONFIG = "ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD", "ADVANTAGE_TORCH_PI06_FLATTEN_FOLD"
ADVANTAGE_EPISODES, ADVANTAGE_FRAMES, ADVANTAGE_HW = 2, 400, (480, 640)  # phase 19's synthetic Agilex dataset
ADVANTAGE_INTERVAL, ADVANTAGE_THRESHOLD = 50, 70.0  # the evaluator's relative interval; discretize's top share, %
EVAL_PEAK_LIMIT_GIB = 70.0  # the evaluator's batch is cut to the largest power of two whose reckoned peak fits


def _write_advantage_dataset(root: pathlib.Path, prompt: str, episodes: int = ADVANTAGE_EPISODES,
                             frames: int = ADVANTAGE_FRAMES) -> pathlib.Path:
    """Phase 19's dataset, written by the port's writer: ``episodes`` x ``frames`` frames, three 480x640 mp4 cameras
    (a blocky random image per camera and episode, shifted 2 pixels a frame), a 14-dim state and action (random
    walks), ``stage_progress_gt`` rising from 0 to 1, one task."""
    from kai0_tpu_torch.data import lerobot_writer

    h, w = ADVANTAGE_HW
    feats = lerobot_writer.feature_spec(state_dim=14, action_dim=14, cameras={c: (h, w) for c in AGILEX_CAMERAS},
                                        fps=30)
    feats["stage_progress_gt"] = {"dtype": "float32", "shape": [1]}
    writer = lerobot_writer.LeRobotDatasetWriter(root, feats, fps=30, robot_type="agilex")
    rng = np.random.default_rng(19)
    n = frames
    for _ in range(episodes):
        videos = {}
        for cam in AGILEX_CAMERAS:
            tile = np.repeat(np.repeat(rng.integers(0, 256, (h // 16, w // 16, 3), dtype=np.uint8), 16, 0), 16, 1)
            videos[f"observation.images.{cam}"] = np.stack([np.roll(tile, 2 * t, axis=1) for t in range(n)])
        walk = np.clip(np.cumsum(rng.normal(0, 0.02, (n, 2, 14)), axis=0), -1, 1).astype(np.float32)
        writer.add_episode({"observation.state": walk[:, 0], "action": walk[:, 1],
                            "stage_progress_gt": np.linspace(0, 1, n, dtype=np.float32)}, task=prompt, videos=videos)
    writer.finalize()
    return root


def _eval_peak_gib(batch: int, n_params: int) -> float:
    """Reckoned peak of one estimator forward at ``batch`` (bf16): the weights, Gemma-2B's FFN over the 968 prefix
    tokens (gate, up, gelu(gate) and their product alive together, [B·968, 16384] bf16 each), three f32 images of the
    RoPE'd queries of all 1018 tokens ([B, 1018, 8, 256]), and the six cameras as f32 [B, 224, 224, 3]."""
    ffn = 4 * batch * 968 * 16384 * 2
    rope = 3 * batch * 1018 * 8 * 256 * 4
    images = 6 * batch * 224 * 224 * 3 * 4
    return (2 * n_params + ffn + rope + images) / 2**30


def _eval_batch(want: int, n_params: int) -> int:
    """``want``, or the largest power of two under it whose reckoned peak fits ``EVAL_PEAK_LIMIT_GIB``."""
    batch = want
    while _eval_peak_gib(batch, n_params) > EVAL_PEAK_LIMIT_GIB:
        batch = 2 ** (batch.bit_length() - 1) if batch & (batch - 1) else batch // 2
    return batch


class _PlainAttention:
    """Within the block, the models' attention runs the plain PyTorch versions on the card (for comparison only)."""

    def __enter__(self):
        from kai0_tpu_torch.ops import attention
        from kai0_tpu_torch.ops import flash_attention as fa

        self.saved = attention.mha, attention.mhsa_dense_hm
        attention.mha, attention.mhsa_dense_hm = fa.flash_mha_plain, fa.flash_mhsa_plain

    def __exit__(self, *exc):
        from kai0_tpu_torch.ops import attention

        attention.mha, attention.mhsa_dense_hm = self.saved


def check_advantage_gradients() -> None:
    """Phase 19 (d): the estimator's loss, value and gradients at full width, depth 2, f32, batch 2: card (kernels)
    against the host CPU (plain versions), within phase 8's 1e-3 x max."""
    from kai0_tpu_torch.models.advantage import AdvantageEstimator, AdvantageEstimatorConfig

    config = _cut_depth_config(2, base=AdvantageEstimatorConfig, pi05=True, dtype="float32", discrete_state_input=False,
                               loss_action_weight=0.0, loss_value_weight=1.0)
    model = AdvantageEstimator(config, device="cuda", param_dtype=torch.float32).init_weights(
        torch.Generator(device="cuda").manual_seed(19))
    obs, actions, draws = _gradient_inputs(19)
    obs = dataclasses.replace(obs, progress=torch.tensor([0.35, -0.6], device="cuda"))
    draws = {"noise": draws["noise"], "time": draws["time"]}

    def run(device):
        o, a, d = _on(device, obs, actions, draws)
        model.zero_grad(set_to_none=True)
        loss, aux = model.compute_loss_and_aux(o, a, **d)
        loss.mean().backward()
        values = model.sample_values(o, **d)
        grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
                 for k, p in model.named_parameters()}
        return loss.detach().cpu(), {k: float(v) for k, v in aux.items()}, values.cpu(), grads

    _reset_launches()
    card = run("cuda")
    launches = _read_launches()
    _check(all(launches[k] > 0 for k in ("flash_mha", "flash_mha_bwd", "flash_mhsa", "flash_mhsa_bwd")),
           f"the estimator's gradients did not go through the kernels: {launches}")
    model.to("cpu")
    torch.cuda.empty_cache()
    host = run("cpu")
    for name, a, b in (("loss", card[0], host[0]), ("value", card[2], host[2])):
        err = (a - b).abs().max().item()
        _check(err <= MODEL_GRAD_TOL * max(b.abs().max().item(), 1e-6), f"estimator {name}: card vs host {err}")
    worst, worst_key = 0.0, None
    floor = 1e-6 * max(g.abs().max().item() for g in host[3].values())
    for k, g in host[3].items():
        scale = max(g.abs().max().item(), floor)
        err = (card[3][k] - g).abs().max().item()
        _check(err <= MODEL_GRAD_TOL * scale, f"{k}: card vs host gradient error {err} > {MODEL_GRAD_TOL} x {scale}")
        if err / scale > worst:
            worst, worst_key = err / scale, k
    _check(all(card[3][f"value_head.{i}.weight"].abs().max() > 0 for i in (0, 2, 4)), "zero value head gradient")
    print(f"advantage: estimator at full width, depth 2, f32, batch 2: loss card {card[0].mean().item():.6f} host "
          f"{host[0].mean().item():.6f}, aux card {card[1]} host {host[1]}; values card {card[2].flatten().tolist()} "
          f"host {host[2].flatten().tolist()}; worst gradient error {worst:.3e} x max |grad| ({worst_key}); "
          f"{len(host[3])} tensors; launches {launches}")
    del model


def _evaluate(evaluator, paths, prompt: str, mode: str, batch: int, frames: int) -> dict:
    """One episode through the evaluator in ``mode`` at ``batch``, the counts set to 0 just before: its records and
    launches, checked by ``_evaluated``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t = time.perf_counter()
    if mode == "2timesteps":
        results = evaluator.evaluate_video_2timesteps_advantages(paths, prompt, batch_size=batch,
                                                                 relative_interval=ADVANTAGE_INTERVAL)
    else:
        results = evaluator.evaluate_video_1timestep_advantage(paths, prompt, batch_size=batch)
    return _evaluated(mode, batch, frames, time.perf_counter() - t, evaluator.timing, _read_launches(),
                      torch.cuda.max_memory_allocated(), results)


def _evaluated(mode: str, batch: int, frames: int, wall: float, timing: dict, launches: dict, peak: int,
               results: list) -> dict:
    """An episode's evaluation printed and checked (finite values in [-1, 1]; one K1f launch a Gemma layer and one
    K2f a SigLIP layer a forward); returns its launches."""
    forwards = len(timing["device_ms"])
    values = np.asarray([[v for k, v in r.items() if not k.endswith("idx")] for r in results], dtype=np.float64)
    print(f"  {mode} at batch {batch}: {frames} frames in {wall:.3f}s = {frames / wall:.3f} frames/s; decode and "
          f"resize {timing['decode_s']:.3f}s; {forwards} forwards, device ms {[round(x, 2) for x in timing['device_ms']]}; "
          f"host assembly ms {[round(x, 2) for x in timing['prep_ms']]}; staging ms "
          f"{[round(x, 2) for x in timing['stage_ms']]}; peak {peak / 2**30:.3f} GiB; "
          f"values in [{values.min():.4f}, {values.max():.4f}]; launches {launches}")
    _check(len(results) == frames and np.isfinite(values).all() and np.abs(values).max() <= 1.0,
           f"{mode}: {len(results)} results, values in [{values.min()}, {values.max()}]")
    _check(launches["flash_mha"] == 18 * forwards and launches["flash_mhsa"] == 27 * forwards
           and launches["flash_mha_bwd"] == launches["flash_mhsa_bwd"] == 0, f"{mode}: launches {launches}")
    return launches


def stage_advantage() -> dict:
    """Phase 19: Stage Advantage through the port's entry points at full width; returns the launches of the
    estimator's 4 training steps and of the 2-timestep evaluation of one episode."""
    import os
    import shutil
    import tempfile

    from kai0_tpu_torch import interop
    from kai0_tpu_torch.advantage import annotate, discretize
    from kai0_tpu_torch.advantage.evaluator import SimpleValueEvaluator
    from kai0_tpu_torch.models.advantage import AdvantageEstimator
    from kai0_tpu_torch.shared import normalize
    from kai0_tpu_torch.training import config as train_config
    from kai0_tpu_torch.training import data_loader, optimizer, train_lib, weight_loaders
    from scripts.annotate_advantage_torch import MODELS_CONFIG_MAP

    os.environ["WANDB_MODE"] = "disabled"
    registry = MODELS_CONFIG_MAP["Flatten-Fold"]
    base = train_config.get_config(ADVANTAGE_CONFIG)
    prompt = base.data.default_prompt
    n = sum(p.numel() for p in AdvantageEstimator(base.model, device="meta").parameters())
    checkpoint_bytes = 4 * n + 8 * sum(-(-p.numel() // 2048) for p in AdvantageEstimator(base.model, device="meta").parameters())
    needed = 2 * n + checkpoint_bytes + 2 * 10**9  # the starting weights, one checkpoint, the dataset and its copies
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    print(f"advantage: {free / 1e9:.3f} GB free under {tmp}; {needed / 1e9:.3f} GB needed")
    if free < needed:
        raise RuntimeError(f"phase 19 needs {needed} bytes free under {tmp}, which has {free}")

    launches = {}
    with tempfile.TemporaryDirectory(prefix="kai0_advantage_") as root:
        root = pathlib.Path(root)
        # (a) the dataset
        t = time.perf_counter()
        dataset = _write_advantage_dataset(root / "FlattenFold", prompt)
        size = sum(f.stat().st_size for f in dataset.rglob("*") if f.is_file())
        print(f"advantage: dataset of {ADVANTAGE_EPISODES} x {ADVANTAGE_FRAMES} frames, cameras {AGILEX_CAMERAS} at "
              f"{ADVANTAGE_HW} (mp4v), written by the port's writer in {time.perf_counter() - t:.1f}s, {size} bytes")
        # (b) a seeded estimator checkpoint with its value head (a pi05 checkpoint has none: the loader refuses it)
        t = time.perf_counter()
        model = AdvantageEstimator(base.model, device="cuda", param_dtype=torch.bfloat16).init_weights(
            torch.Generator(device="cuda").manual_seed(19))
        weights = interop.save_torch_checkpoint(model, root / "weights")
        del model
        torch.cuda.empty_cache()
        print(f"advantage: seeded bf16 estimator ({n / 1e9:.3f}B parameters, value head included) written to "
              f"{weights.name} ({weights.stat().st_size / 1e9:.3f} GB) in {time.perf_counter() - t:.1f}s")

        # (c) train through train_lib.main: phase 9's memory configuration, the config's loader workers
        workers = min(base.num_workers, os.cpu_count() or 1)
        config = dataclasses.replace(
            _train_entry_config(base, str(root / "checkpoints"), num_workers=workers, wandb_enabled=False,
                                weight_loader=weight_loaders.CheckpointWeightLoader(str(weights))),
            exp_name="advantage", assets_base_dir=str(root / "assets"),
            data=dataclasses.replace(base.data, repo_id=str(dataset),
                                     assets=train_config.AssetsConfig(asset_id="synthetic")))
        normalize.save(config.assets_dirs / "synthetic", _quantile_stats())
        print(f"advantage: train_lib.main({ADVANTAGE_CONFIG!r}, batch {TRAIN_BATCH}, {TRAIN_ENTRY_STEPS} steps, bf16 "
              f"parameters, int8 moments, no EMA (the config's f32 AdamW + EMA overridden), {workers} loader workers "
              f"(config {base.num_workers}, {os.cpu_count()} CPUs), split {config.split!r}, 6 mp4 frames a sample)")
        _reset_launches()
        recorder = _StepRecorder("advantage", TRAIN_BATCH, TRAIN_STEP_LAUNCHES)
        t = time.perf_counter()
        recorder.start()
        model, state = train_lib.main(config, on_step=recorder)
        total_s = time.perf_counter() - t
        launches["train"] = _read_launches()
        walls = [r["wall_ms"] for r in recorder.rows[1:]]
        save = recorder.rows[-1]
        print(f"  advantage main: {total_s:.1f}s in all; median wall_ms over steps 1-{TRAIN_ENTRY_STEPS - 1} = "
              f"{statistics.median(walls):.2f} ({TRAIN_BATCH / statistics.median(walls) * 1000:.3f} samples/s); "
              f"loader wait ms {[round(r['loader_wait_ms'], 3) for r in recorder.rows]}; peak GiB "
              f"{[round(r['peak_gib'], 3) for r in recorder.rows]}; save of step {save['step']}: {save['save_s']:.3f}s, "
              f"{save['save_bytes']} bytes; launches over {TRAIN_ENTRY_STEPS} steps {launches['train']}")
        step_dir = config.checkpoint_dir / str(TRAIN_ENTRY_STEPS - 1)
        saved = interop.read_safetensors(step_dir / interop.CHECKPOINT_FILE)
        _check(state.step == TRAIN_ENTRY_STEPS and {f"value_head.{i}.weight" for i in (0, 2, 4)} <= set(saved),
               f"the estimator's checkpoint: step {state.step}, value head keys {sorted(k for k in saved if 'value' in k)}")
        del model, state, saved
        torch.cuda.empty_cache()

        # (d) card vs host
        check_advantage_gradients()
        torch.cuda.empty_cache()

        # (e) evaluate one episode with step 3's checkpoint
        t = time.perf_counter()
        evaluator = SimpleValueEvaluator(ADVANTAGE_CONFIG, step_dir, batch_size=registry["KAI0"]["batch_size"])
        print(f"advantage: SimpleValueEvaluator({ADVANTAGE_CONFIG!r}, '<checkpoints>/{step_dir.name}') in "
              f"{time.perf_counter() - t:.1f}s")
        paths = [dataset / f"videos/chunk-000/observation.images.{c}/episode_000000.mp4" for c in AGILEX_CAMERAS]
        kai0_batch = registry["KAI0"]["batch_size"]
        pi06_batch = _eval_batch(registry["PI06"]["batch_size"], n)
        print(f"  reckoned peak of a forward: {_eval_peak_gib(kai0_batch, n):.3f} GiB at batch {kai0_batch}, "
              f"{_eval_peak_gib(registry['PI06']['batch_size'], n):.3f} GiB at {registry['PI06']['batch_size']}; "
              f"1-timestep mode runs at {pi06_batch}")

        # (f) annotate every episode (2-timestep, batch 160), the counts set to 0 just before: its first episode's
        # evaluation, the episode of (e), is (e)'s 2-timestep record.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t = time.perf_counter()
        keep = lambda args, out: (evaluator.timing, _read_launches(), torch.cuda.max_memory_allocated(), out)  # noqa: E731
        with _Calls(evaluator, "evaluate_video_2timesteps_advantages", keep=keep) as episodes:
            written = annotate.annotate_dataset(evaluator, dataset, prompt=prompt, output_tag="KAI0_smoke",
                                                mode=registry["KAI0"]["mode"], relative_interval=ADVANTAGE_INTERVAL,
                                                batch_size=kai0_batch)
        annotate_s = time.perf_counter() - t
        episode_ms, (timing, first_launches, peak, results) = episodes.rows[0]
        launches["eval"] = _evaluated("2timesteps", kai0_batch, ADVANTAGE_FRAMES, episode_ms / 1000, timing,
                                      first_launches, peak, results)
        _evaluate(evaluator, paths, prompt, "1timestep", pi06_batch, ADVANTAGE_FRAMES)

        # One batch with the kernels and through the plain attention, and one profiled forward.
        cams = evaluator._load_videos(paths, 1)
        rows = list(range(kai0_batch))
        tokens, token_masks = evaluator.tokenizer.tokenize(prompt)
        batch = ([c[[0] * kai0_batch] for c in cams], [c[rows] for c in cams], tokens, token_masks)
        evaluator.batch_size = kai0_batch
        kernel = evaluator._infer_values(*batch)
        _reset_launches()
        with _PlainAttention():
            plain = evaluator._infer_values(*batch)
        _check(sum(_read_launches().values()) == 0, "the plain forward launched a kernel")
        err = np.abs(kernel - plain)
        print(f"  one batch of {kai0_batch}, kernels vs plain attention on the card (bf16): max abs {err.max():.4e}, "
              f"mean abs {err.mean():.4e} (|values| max {np.abs(plain).max():.4f}, mean {np.abs(plain).mean():.4f})")
        _check(err.max() <= BF16_SAMPLE_TOL["max"] * np.abs(plain).max()
               and err.mean() <= BF16_SAMPLE_TOL["mean"] * np.abs(plain).mean(), "kernels vs plain attention")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            evaluator._infer_values(*batch)
            torch.cuda.synchronize()
        families, busy_ms, attention = _profile_families(prof)
        print(f"  profiled forward at batch {kai0_batch}: summed device time {busy_ms:.2f} ms; by kernel family: "
              + "; ".join(f"{fam} {ms:.2f} ms x{count}" for fam, (ms, count) in
                          sorted(families.items(), key=lambda kv: -kv[1][0]))
              + "; attention: " + "; ".join(f"{k} {ms:.2f} ms x{c}" for k, (ms, c) in attention.items()))
        del cams, batch

        # (f) discretize, read the labels back as AWBC prompts
        evaluator.shutdown()
        del evaluator
        torch.cuda.empty_cache()
        stats = discretize.discretize_dataset(dataset, threshold=ADVANTAGE_THRESHOLD, discretion_type="binary",
                                              data_glob="data_KAI0_smoke/chunk-*/*.parquet", base_prompt=prompt)
        (dataset / "data").rename(dataset / "data_base")
        (dataset / "data_KAI0_smoke").rename(dataset / "data")
        awbc = train_config.get_config("pi05_flatten_fold_awbc")
        awbc_data = dataclasses.replace(awbc.data, repo_id=str(dataset)).create(awbc.assets_dirs, awbc.model)
        items = data_loader.create_dataset(awbc_data, awbc.model)
        t = time.perf_counter()
        prompts = [items[i]["prompt"] for i in range(len(items))]
        read_s = time.perf_counter() - t
        positive = sum(p.endswith(", Advantage: positive") for p in prompts) / len(prompts)
        print(f"advantage: annotated {len(written)} episodes in {annotate_s:.1f}s; discretized (binary, threshold "
              f"{ADVANTAGE_THRESHOLD}): absolute_advantage mean {stats[0]['mean']:.6f}, p30 "
              f"{stats[0]['percentiles'][30]:.6f}; read back through pi05_flatten_fold_awbc's data config in "
              f"{read_s:.1f}s: {len(prompts)} prompts, {positive:.4f} positive, e.g. {prompts[0]!r}")
        _check(len(written) == ADVANTAGE_EPISODES and len(prompts) == ADVANTAGE_EPISODES * ADVANTAGE_FRAMES
               and all(p.endswith((", Advantage: positive", ", Advantage: negative")) for p in prompts)
               and abs(positive - ADVANTAGE_THRESHOLD / 100) <= 0.1, f"AWBC labels: {positive} positive")
    print(f"advantage: temporary files deleted; {torch.cuda.memory_allocated() / 2**30:.3f} GiB still allocated")
    return launches


# ---------------------------------------------------------------------------
# Phase 20: π₀ and π₀-FAST
# ---------------------------------------------------------------------------

PI0_CONFIG, FAST_CONFIG, FAST_TRAIN_CONFIG = "pi0_libero", "pi0_fast_droid", "pi0_fast_libero"
# A FAST request decodes 256 tokens, ~9 s: the 1,200 s budget allows 10 π₀ requests and 1 FAST request.
PI0_REQUESTS, FAST_REQUESTS, PHASE20_TRAIN_STEPS = 10, 1, 3
FAST_MAX_DECODING_STEPS = 256  # Pi0FAST.sample_actions' default, which the policy serves
FAST_CARD_VS_HOST_STEPS = 16


def _libero_requests(rng: np.random.Generator, n: int) -> list[dict]:
    """Raw LIBERO requests: two 256x256 HWC uint8 cameras (resized to 224 by the chain), an 8-dim state, a prompt."""
    return [{"observation/image": rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
             "observation/wrist_image": rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
             "observation/state": rng.uniform(-1, 1, 8).astype(np.float32),
             "prompt": "put the bowl on the plate"} for _ in range(n)]


def _droid_requests(rng: np.random.Generator, n: int) -> list[dict]:
    """Raw DROID requests: two 180x320 HWC uint8 cameras, 7 joint positions and the gripper, a prompt."""
    return [{"observation/exterior_image_1_left": rng.integers(0, 256, (180, 320, 3), dtype=np.uint8),
             "observation/wrist_image_left": rng.integers(0, 256, (180, 320, 3), dtype=np.uint8),
             "observation/joint_position": rng.uniform(-1, 1, 7),
             "observation/gripper_position": rng.uniform(0, 1, 1),
             "prompt": "put the marker in the cup"} for _ in range(n)]


def _seeded_checkpoint(model_cls, cfg, ckpt: pathlib.Path, seed: int, stats_width: int = 32) -> pathlib.Path:
    """A seeded bf16 model of ``cfg`` written to ``ckpt/model.safetensors`` with phase 14's synthetic stats."""
    from kai0_tpu_torch import interop
    from kai0_tpu_torch.shared import normalize

    t = time.perf_counter()
    model = model_cls(cfg.model, device="cuda", param_dtype=torch.bfloat16).init_weights(
        torch.Generator(device="cuda").manual_seed(seed))
    n = sum(p.numel() for p in model.parameters())
    path = interop.save_torch_checkpoint(model, ckpt)
    del model
    torch.cuda.empty_cache()
    asset_id = cfg.data.create(cfg.assets_dirs, cfg.model).asset_id
    normalize.save(ckpt / "assets" / asset_id, _quantile_stats(stats_width))
    print(f"{cfg.name}: seeded bf16 {model_cls.__name__} ({n} parameters) written to {path.name} "
          f"({path.stat().st_size / 1e9:.3f} GB) with synthetic norm stats under assets/{asset_id} in "
          f"{time.perf_counter() - t:.1f}s")
    return path


def serve_pi0(root: pathlib.Path) -> dict:
    """Phase 20, π₀ serving: ``pi0_libero`` (Gemma-2B + Gemma-300M, So400m/14, horizon 50, 48 prompt tokens) from a
    seeded ``model.safetensors`` through ``create_trained_policy`` and the CUDA graph; returns the launches of the
    graph the requests replayed, at its capture."""
    from kai0_tpu_torch.models.pi0 import Pi0
    from kai0_tpu_torch.policies import graphs, policy_config
    from kai0_tpu_torch.training import config as train_config

    cfg = train_config.get_config(PI0_CONFIG)
    _check(not cfg.model.pi05 and cfg.model.max_token_len == 48, f"{PI0_CONFIG} is not the π₀ model")
    ckpt = root / "pi0"
    _seeded_checkpoint(Pi0, cfg, ckpt, seed=20)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    policy = policy_config.create_trained_policy(cfg, ckpt, warmup=True)
    torch.cuda.synchronize()
    _check(hasattr(policy.model, "state_proj") and not hasattr(policy.model, "time_mlp_in") and len(policy.graphs) == 1,
           "pi0 serving: not the π₀ model, or warmup captured no graph")
    print(f"pi0 serving: create_trained_policy({PI0_CONFIG!r}, warmup=True) in {time.perf_counter() - t:.2f}s "
          f"(capture {next(iter(policy.graphs.values())).capture_seconds:.2f}s)")

    rng = np.random.default_rng(20)
    noise = rng.standard_normal((50, 32)).astype(np.float32)
    requests = _libero_requests(rng, PI0_REQUESTS)
    staged = policy.stage_inputs(requests[0])
    del policy.graphs[graphs.signature(staged)]  # the first request captures it again, with every count at 0
    _reset_launches()
    policy.infer(requests[0], noise=noise)
    walls, timing, outs = [], {"infer_ms": [], "transform_ms": [], "stage_ms": []}, []
    for obs in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs, noise=noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1000)
        for key in timing:
            timing[key].append(out["policy_timing"][key])
        _check(out["actions"].shape == (50, 7) and np.isfinite(out["actions"]).all(),
               f"pi0 serving: actions {out['actions'].shape}")
        outs.append(out["actions"])
    graph = policy.graph_for(staged)
    capture = {k: v for k, v in graph.capture_launches.items() if v}
    served = {k: v for k, v in _read_launches().items() if v}
    want = {"flash_mha": 18 + 10 * 18, "flash_mhsa": 27}
    _check(capture == want and served == {k: 2 * v for k, v in want.items()},
           f"pi0 serving: launches at capture {capture}, since the counts were set to 0 {served}, want {want}")
    graph.stage(staged, noise[None])
    graph.replay()
    x0 = graph.fetch()
    eager, eager_launches = _eager_sample(policy.model, staged, noise)
    _check(np.array_equal(eager, x0) and eager_launches == capture,
           f"pi0 serving: graphed x_0 against eager: equal {np.array_equal(eager, x0)}, launches {eager_launches}")
    print(f"pi0 serving: {PI0_REQUESTS} raw LIBERO requests (2 x 256x256 cameras, 8-dim state), batch 1, one noise: "
          f"wall_ms {_percentiles(walls)}; " + "; ".join(f"{k} {_percentiles(v)}" for k, v in timing.items())
          + f"; walls {[round(w, 1) for w in walls]}; launches a request (at capture) "
          f"{capture}; graphed x_0 bit-equal to eager sample_actions; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del policy, graph
    torch.cuda.empty_cache()
    return capture


def pi0_card_vs_host() -> None:
    """Phase 20: π₀ at full width, depth 2: f32 card (kernels) against f32 host (plain) within 1e-3, and the same
    weights in bf16 on the card within phase 5's bounds of the f32 host."""
    from kai0_tpu_torch.models.pi0 import Pi0
    from kai0_tpu_torch.policies.policy import Policy

    config = _cut_depth_config(2, pi05=False, dtype="float32")
    model = Pi0(config, device="cuda", param_dtype=torch.float32).init_weights(
        torch.Generator(device="cuda").manual_seed(21)).eval()
    rng = np.random.default_rng(21)
    obs = _request_inputs(rng)
    obs["tokenized_prompt"], obs["tokenized_prompt_mask"] = obs["tokenized_prompt"][:48], obs["tokenized_prompt_mask"][:48]
    noise = rng.standard_normal((50, 32)).astype(np.float32)
    on_card = Policy(model, config, device="cuda").infer(obs, noise=noise)["actions"]
    bf16_config = _cut_depth_config(2, pi05=False)
    bf16_model = Pi0(bf16_config, device="cuda", param_dtype=torch.bfloat16).eval()
    bf16_model.load_state_dict(model.state_dict())
    on_card_bf16 = Policy(bf16_model, bf16_config, device="cuda").infer(obs, noise=noise)["actions"]
    del bf16_model
    model.to("cpu")
    torch.cuda.empty_cache()
    on_host = Policy(model, config, device="cpu").infer(obs, noise=noise)["actions"]
    err = float(np.abs(on_card - on_host).max())
    diff = np.abs(on_card_bf16 - on_host)
    ref_max, ref_mean = float(np.abs(on_host).max()), float(np.abs(on_host).mean())
    print(f"pi0 card vs host (full width, depth 2): f32 max_abs_err={err:.3e} (tolerance {FULL_WIDTH_TOL}); bf16 card "
          f"vs f32 host max_abs_err={diff.max():.4e} mean_abs_err={diff.mean():.4e} (|actions| max {ref_max:.3f}, mean "
          f"{ref_mean:.3f}; limits {BF16_SAMPLE_TOL['max'] * ref_max:.4e}, {BF16_SAMPLE_TOL['mean'] * ref_mean:.4e})")
    _check(np.isfinite(on_card).all() and err <= FULL_WIDTH_TOL, f"pi0 f32 card vs host {err}")
    _check(diff.max() <= BF16_SAMPLE_TOL["max"] * ref_max and diff.mean() <= BF16_SAMPLE_TOL["mean"] * ref_mean,
           "pi0 bf16 sample too far from the f32 host")


def _fast_decode_mask(s: int, prefill: int, used: int, step: int) -> torch.Tensor:
    """The mask of decode step ``step``: keys [prefill - used, prefill + step + 1) of a cache of ``s`` slots."""
    key = torch.arange(s, device="cuda")
    return ((key >= prefill - used) & (key < prefill + step + 1))[None, None, :].contiguous()


def check_fast_attention() -> dict:
    """Phase 20: K1f at π₀-FAST's shapes in bf16 against its plain version (phase 3's tolerances): the prefill of
    ``pi0_fast_droid`` (T = 1018 rows against S = 1274 cache slots, the left-aligned prefix-LM mask) and a decode step
    (T = 1: 8 folded rows against S = 1274); timed beside SDPA and the bound. Returns the decode step's record."""
    from kai0_tpu_torch.ops import flash_attention as fa
    from kai0_tpu_torch.ops.masks import make_attn_mask

    prefill, s, used = 3 * 256 + 250, 3 * 256 + 250 + FAST_MAX_DECODING_STEPS, 3 * 256 + 60
    gen = torch.Generator(device="cuda").manual_seed(24)
    valid = torch.arange(prefill, device="cuda")[None] >= prefill - used
    prefill_mask = torch.cat([make_attn_mask(valid, torch.zeros(prefill, dtype=torch.bool, device="cuda")),
                              torch.zeros(1, prefill, FAST_MAX_DECODING_STEPS, dtype=torch.bool, device="cuda")], -1)
    record = {}
    for label, t, mask in (("prefill T=1018 S=1274", prefill, prefill_mask.contiguous()),
                           ("decode T=1 S=1274", 1, _fast_decode_mask(s, prefill, used, 100))):
        q = (torch.randn(1, t, 8, 256, generator=gen, device="cuda") / 16).bfloat16()
        k, v = (torch.randn(1, s, 1, 256, generator=gen, device="cuda").bfloat16() for _ in range(2))
        out, lse = fa.flash_mha_fwd(q, k, v, mask)
        ref = fa.flash_mha_plain(q, k, v, mask)
        err = (out.float() - ref.float()).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        tol = TOL["bfloat16"]
        _check(torch.isfinite(out).all() and max_err <= tol["max"] and mean_err <= tol["mean"],
               f"flash_mha FAST {label}: max abs err {max_err}, mean {mean_err}")
        ms = _cuda_ms(lambda: fa.flash_mha_fwd(q, k, v, mask))  # noqa: B023
        plain_ms = _cuda_ms(lambda: fa.flash_mha_plain(q, k, v, mask))  # noqa: B023
        sdpa_ms = _cuda_ms(_sdpa(q, k, v, mask))
        bound_ms, bound_by = _bound(_mqa_flops(mask, 8, 256, 2), _nbytes(q, k, v, mask, out, lse), torch.bfloat16)
        print(f"kernel flash_mha FAST {label} bfloat16: max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={sdpa_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        if t == 1:
            record = {"max_abs_err_fast_decode": max_err, "ms_fast_decode": ms, "plain_ms_fast_decode": plain_ms,
                      "bound_ms_fast_decode": bound_ms, "bound_by_fast_decode": bound_by,
                      "library_ms_fast_decode": sdpa_ms}
    return record


def _pi0_training_mask(batch: int) -> torch.Tensor:
    """π₀'s joint [prefix, suffix] mask of ``compute_loss`` at 48 prompt tokens: bool [B, 867, 867]. The suffix is two
    blocks: the state token, then the 50 action tokens."""
    from kai0_tpu_torch.ops.masks import make_attn_mask

    valid = torch.ones(batch, 867, dtype=torch.bool, device="cuda")
    valid[0, 512:768] = False  # one camera masked in one sample
    for b in range(batch):
        valid[b, 768 + 10 + (7 * b) % 38 : 816] = False  # padded prompt
    ar = torch.zeros(867, dtype=torch.bool, device="cuda")
    ar[816:818] = True
    return make_attn_mask(valid, ar)


def _fast_training_mask(batch: int) -> torch.Tensor:
    """π₀-FAST's mask of ``compute_loss`` at 180 prompt tokens, without the last input: bool [B, 947, 947]. A prompt
    is a bidirectional prefix, then action tokens that attend causally (``token_ar_mask``), then padding."""
    from kai0_tpu_torch.ops.masks import make_attn_mask

    n = 768 + 180
    valid = torch.zeros(batch, n, dtype=torch.bool, device="cuda")
    ar = torch.zeros(batch, n, dtype=torch.int32, device="cuda")
    valid[:, :768] = True
    valid[0, 256:512] = False
    for b in range(batch):
        prefix = 768 + 20 + (5 * b) % 40
        end = min(prefix + 60 + (11 * b) % 80, n)
        valid[b, 768:end] = True
        ar[b, prefix:end] = 1
    return make_attn_mask(valid, ar)[:, :-1, :-1].contiguous()


def check_family_attention_training() -> dict:
    """Phase 20: K1f and K1b at the batch-32 training shapes of π₀ (T = S = 867, a two-block suffix) and π₀-FAST
    (T = S = 947, causal action tokens) in bf16 against their plain versions with phase 6's tolerances (two backward
    calls must give the same bits); timed beside SDPA and the bound. Returns each kernel's numbers under keys
    suffixed ``_pi0_train`` and ``_fast_train``."""
    from kai0_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(26)
    record = {}
    for path, mask in (("pi0_train", _pi0_training_mask(TRAIN_BATCH)), ("fast_train", _fast_training_mask(TRAIN_BATCH))):
        b, t = mask.shape[:2]
        label = f"{path} B={b} T=S={t}"
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                         for shape in ((b, t, 8, 256), (b, t, 1, 256), (b, t, 1, 256), (b, t, 8, 256)))
        q, k, v, dout = (x.bfloat16() for x in (q / 16, k, v, dout))
        out, lse = fa.flash_mha_fwd(q, k, v, mask)
        fwd_err = (out.float() - fa.flash_mha_plain(q, k, v, mask).float()).abs()
        tol = TOL["bfloat16"]
        _check(torch.isfinite(out).all() and fwd_err.max().item() <= tol["max"] and fwd_err.mean().item() <= tol["mean"],
               f"flash_mha {label}: max abs err {fwd_err.max().item()}, mean {fwd_err.mean().item()}")
        grads, ref_grads = fa.flash_mha_bwd(q, k, v, mask, out, lse, dout), fa.flash_mha_bwd_plain(q, k, v, mask, dout)
        errs = _grad_errors(grads, ref_grads)
        bwd_err = max((a.float() - g.float()).abs().max().item() for a, g in zip(grads, ref_grads, strict=True))
        del ref_grads
        torch.cuda.empty_cache()
        _check(max(errs) <= GRAD_TOL["bfloat16"], f"flash_mha_bwd {label}: relative errors {errs}")
        _check(all(torch.equal(a, g) for a, g in zip(grads, fa.flash_mha_bwd(q, k, v, mask, out, lse, dout), strict=True)),
               f"flash_mha_bwd {label}: two backward calls differ")
        times = {key: _cuda_ms(fn, runs=10) for key, fn in (
            ("fwd", lambda: fa.flash_mha_fwd(q, k, v, mask)),  # noqa: B023
            ("plain_fwd", lambda: fa.flash_mha_plain(q, k, v, mask)),  # noqa: B023
            ("sdpa_fwd", _sdpa(q, k, v, mask)),
            ("bwd", lambda: fa.flash_mha_bwd(q, k, v, mask, out, lse, dout)),  # noqa: B023
            ("plain_bwd", lambda: fa.flash_mha_bwd_plain(q, k, v, mask, dout)),  # noqa: B023
            ("sdpa_fwd_bwd", _sdpa(q, k, v, mask, dout=dout)),
        )}
        torch.cuda.empty_cache()
        print(f"kernel flash_mha {label} bfloat16: fwd max_abs_err={fwd_err.max().item():.3e} mean_abs_err="
              f"{fwd_err.mean().item():.3e}; bwd max_err/max|grad| (q,k,v)={[f'{e:.3e}' for e in errs]}; "
              + " ".join(f"{key}_ms={ms:.4f}" for key, ms in times.items()))
        for key, flops, nbytes, err, ms, plain_ms, lib_ms in (
            ("flash_mha", _mqa_flops(mask, 8, 256, 2), _nbytes(q, k, v, mask, out, lse), fwd_err.max().item(),
             times["fwd"], times["plain_fwd"], times["sdpa_fwd"]),
            ("flash_mha_bwd", _mqa_flops(mask, 8, 256, 5), _nbytes(q, k, v, mask, out, dout, lse, *grads), bwd_err,
             times["bwd"], times["plain_bwd"], times["sdpa_fwd_bwd"]),
        ):
            bound_ms, bound_by = _bound(flops, nbytes, torch.bfloat16)
            record.setdefault(key, {}).update({
                f"max_abs_err_{path}": err, f"ms_{path}": ms, f"plain_ms_{path}": plain_ms,
                f"bound_ms_{path}": bound_ms, f"bound_by_{path}": bound_by, f"library_ms_{path}": lib_ms})
            print(f"  {key} {label}: bound_ms={bound_ms:.4f} ({bound_by}); kernel / library {ms / lib_ms:.2f}")
        del q, k, v, dout, out, lse, grads, fwd_err
        torch.cuda.empty_cache()
    return record


def _fast_gradient_inputs(seed: int, batch: int = 2, tokens: int = 180):
    """A seeded π₀-FAST batch on the card (three cameras, one masked in sample 0; a prompt of a bidirectional prefix,
    then causal action tokens that the loss reads, then padding; 7-dim state and actions) with fixed augmentation
    draws."""
    from kai0_tpu_torch.models import augment
    from kai0_tpu_torch.models.model import Observation
    from kai0_tpu_torch.models.pi0_fast import FAST_IMAGE_KEYS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    pos = torch.arange(tokens, device="cuda")[None]
    prefix = torch.randint(10, 60, (batch, 1), generator=gen, device="cuda")
    end = prefix + torch.randint(20, 120, (batch, 1), generator=gen, device="cuda")
    actions_part = (pos >= prefix) & (pos < end)
    obs = Observation.from_dict({
        "image": {k: torch.randint(0, 256, (batch, 224, 224, 3), generator=gen, device="cuda", dtype=torch.uint8)
                  for k in FAST_IMAGE_KEYS},
        "image_mask": {k: (torch.arange(batch, device="cuda") > 0) | (k != "base_1_rgb") for k in FAST_IMAGE_KEYS},
        "state": torch.randn(batch, 7, generator=gen, device="cuda"),
        "tokenized_prompt": torch.where(pos < end, torch.randint(2, 257_152, (batch, tokens), generator=gen,
                                                                 device="cuda"), 0).to(torch.int32),
        "tokenized_prompt_mask": pos < end,
        "token_ar_mask": actions_part.to(torch.int32),
        "token_loss_mask": actions_part,
    })
    draws = {"augment_params": {k: augment.draw_augment_params(gen, batch, "wrist" not in k, device="cuda")
                                for k in FAST_IMAGE_KEYS}}
    return obs, torch.randn(batch, 10, 7, generator=gen, device="cuda"), draws


def family_gradients() -> None:
    """Phase 20, as phase 8: π₀ (48 prompt tokens, the state token) and π₀-FAST (``pi0_fast_libero``'s 180 tokens)
    at full width, depth 2, f32, batch 2, with augmentation: the card's (kernels) ``compute_loss`` within 1e-3 x
    |host's| and every gradient within 1e-3 x max |host's| of the host's (plain). SigLIP's key bias has a gradient
    that softmax cancels (zero but for rounding, on both sides): it is held at the scale of its layer's key-weight
    gradient, whose sums run over the same products."""
    from kai0_tpu_torch.models.pi0 import Pi0
    from kai0_tpu_torch.models.pi0_fast import Pi0FAST, Pi0FASTConfig

    language, vision = ("paligemma_with_expert.paligemma.model.language_model.",
                        "paligemma_with_expert.paligemma.model.vision_tower.vision_model.encoder.")
    cases = (
        ("pi0", Pi0, _cut_depth_config(pi05=False, dtype="float32"), lambda: _gradient_inputs(25, tokens=48),
         ("state_proj.weight", "action_time_mlp_in.weight", "action_time_mlp_out.weight",
          "paligemma_with_expert.gemma_expert.model.layers.0.self_attn.q_proj.weight")),
        ("fast", Pi0FAST, _cut_depth_config(base=Pi0FASTConfig, dtype="float32", action_dim=7, action_horizon=10,
                                            max_token_len=180), lambda: _fast_gradient_inputs(27),
         (f"{language}embed_tokens.weight",)),
    )
    for label, cls, config, inputs, nonzero in cases:
        model = cls(config, device="cuda", param_dtype=torch.float32).init_weights(
            torch.Generator(device="cuda").manual_seed(25))
        obs, actions, draws = inputs()
        _reset_launches()
        card_loss, card, card_ms = _loss_and_grads(model, "cuda", obs, actions, draws)
        launches = _read_launches()
        _check(all(launches[k] > 0 for k in ("flash_mha", "flash_mha_bwd", "flash_mhsa", "flash_mhsa_bwd")),
               f"{label} depth-2 gradients did not go through the kernels: {launches}")
        for k in (*nonzero, f"{language}layers.0.self_attn.q_proj.weight", f"{vision}layers.0.self_attn.q_proj.weight"):
            _check(card[k].abs().max().item() > 0, f"{label}: {k} has a zero gradient on the card")
        model.to("cpu")
        torch.cuda.empty_cache()
        host_loss, host, host_ms = _loss_and_grads(model, "cpu", obs, actions, draws)
        loss_err = abs(card_loss - host_loss)
        key_bias = {k: float(host[k].abs().max()) for k in host if k.startswith(vision) and k.endswith("k_proj.bias")}
        worst, worst_key, bad = _card_vs_host_gradients(
            card, host, lambda k: k.removesuffix("bias") + "weight" if k in key_bias else k)
        print(f"{label} gradients, full width, depth 2, f32, batch 2: loss card {card_loss:.6f} host {host_loss:.6f} "
              f"(error {loss_err:.3e}); worst gradient error {worst:.3e} x max |grad| ({worst_key}); {len(host)} "
              f"tensors; SigLIP key-bias gradients (host) {[f'{v:.2e}' for v in key_bias.values()]}; launches "
              f"{launches}; card {card_ms:.1f} ms, host {host_ms:.1f} ms")
        _check(not bad and loss_err <= MODEL_GRAD_TOL * abs(host_loss),
               f"{label}: loss card {card_loss} host {host_loss}; " + "; ".join(bad))
        del model, card, host


def _device_busy(prof) -> tuple[float, int]:
    """The union of a profile's device intervals (kernels, copies), ms, and their count."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1000, len(spans)


def _profile_fast(model, obs) -> None:
    """One prefill and one decode step of ``pi0_fast_droid`` under the profiler: device ms by family, kernels, and
    the device's idle share of each one's unprofiled wall (median of 5)."""
    logits, cache, prefill_len, prefix_start = model.prefill(obs, FAST_MAX_DECODING_STEPS)
    token = logits.argmax(-1)

    state = {"cache": cache, "step": 0}

    def prefill():
        model.prefill(obs, FAST_MAX_DECODING_STEPS)

    def decode():  # each call writes the next slot of the cache
        _, state["cache"] = model.decode_step(token, state["step"], state["cache"], prefill_len, prefix_start)
        state["step"] += 1

    for label, fn in (("prefill", prefill), ("decode step", decode)):
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1000)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        families, summed_ms, _ = _profile_families(prof)
        busy_ms, count = _device_busy(prof)
        wall = statistics.median(walls)
        print(f"fast {label} profiled: device busy {busy_ms:.3f} ms (summed {summed_ms:.3f}) in {count} kernels and "
              f"copies; unprofiled wall median {wall:.3f} ms of {[round(w, 3) for w in walls]}; device idle share "
              f"{1 - busy_ms / wall:.4f}; by family: " + "; ".join(
                  f"{fam} {ms:.3f} ms x{n}" for fam, (ms, n) in sorted(families.items(), key=lambda kv: -kv[1][0])))


def serve_fast(root: pathlib.Path) -> dict:
    """Phase 20, π₀-FAST serving: ``pi0_fast_droid`` (Gemma-2B, So400m/14, 8-dim actions over 10 steps, 250 prompt
    tokens) from a seeded ``model.safetensors`` through ``create_trained_policy``, whose sampler is eager; returns
    one request's launches, and those of the same request served in int8 (``serve_fast_int8``)."""
    from kai0_tpu_torch.models.model import Observation
    from kai0_tpu_torch.models.pi0_fast import Pi0FAST
    from kai0_tpu_torch.policies import policy_config
    from kai0_tpu_torch.training import config as train_config

    cfg = train_config.get_config(FAST_CONFIG)
    ckpt = root / "fast"
    _seeded_checkpoint(Pi0FAST, cfg, ckpt, seed=22, stats_width=cfg.model.action_dim)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    # No warmup: FAST's sampler is eager, so a warmup would only serve one more 256-token request (~8 s).
    policy = policy_config.create_trained_policy(cfg, ckpt)
    torch.cuda.synchronize()
    _check(isinstance(policy.model, Pi0FAST) and not policy.graphs, "fast serving: not the FAST model, or a graph")
    print(f"fast serving: create_trained_policy({FAST_CONFIG!r}) in {time.perf_counter() - t:.2f}s (no graph: the "
          "sampler is eager)")
    requests = _droid_requests(np.random.default_rng(22), FAST_REQUESTS)
    walls, infer_ms, launches = [], [], []
    for obs in requests:
        _reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1000)
        infer_ms.append(out["policy_timing"]["infer_ms"])
        launches.append({k: v for k, v in _read_launches().items() if v})
        _check(out["actions"].shape == (10, 8) and np.isfinite(out["actions"]).all(),
               f"fast serving: actions {out['actions'].shape}")
    tokens = [n["flash_mha"] // 18 for n in launches]  # one forward a token: the prefill, then each token fed back
    for n, k in zip(launches, tokens, strict=True):
        _check(n == {"flash_mha": 18 * k, "flash_mhsa": 27} and 1 <= k <= FAST_MAX_DECODING_STEPS,
               f"fast serving: launches {n}")
    staged = policy.stage_inputs(requests[0])
    obs = Observation.from_dict(_device_inputs(staged))
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        policy.model.prefill(obs, FAST_MAX_DECODING_STEPS)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1000)
    prefill = statistics.median(prefill_ms)
    step_ms = [(m - prefill) / max(k - 1, 1) for m, k in zip(infer_ms, tokens, strict=True)]
    _profile_fast(policy.model, obs)
    print(f"fast serving: {FAST_REQUESTS} raw DROID requests (2 x 180x320 cameras, 8-dim state), batch 1, greedy: "
          f"tokens decoded {tokens} (of {FAST_MAX_DECODING_STEPS}); wall_ms {[round(w, 2) for w in walls]}; infer_ms "
          f"{[round(m, 2) for m in infer_ms]}; prefill ms (median of 3) {prefill:.2f}; ms a decode step "
          f"{[round(m, 3) for m in step_ms]}; launches a request {launches[0]} (prefill 18 K1f, each decode step 18); "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    actions = out["actions"]
    del policy, obs
    torch.cuda.empty_cache()
    return launches[0], serve_fast_int8(cfg, ckpt, requests[0], actions)


def serve_fast_int8(cfg, ckpt: pathlib.Path, request: dict, bf16_actions: np.ndarray) -> dict:
    """Phase 20, int8 π₀-FAST: ``create_trained_policy(..., quantize=True)`` on the same checkpoint serves the same
    request (eager, greedy) with the counts at 0: per forward (the prefill, then each token fed back) 18 K1f, and per
    layer 5 K5 and 6 K4b ``nt`` (the prefill's at M = 1,018 on ``wgmma``, a decode step's at M = 1 on split-K, as
    a profiled prefill and decode step must show); 27 K2f. Returns the request's launches."""
    from kai0_tpu_torch.models.model import Observation
    from kai0_tpu_torch.policies import policy_config

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    policy = policy_config.create_trained_policy(cfg, ckpt, quantize=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    _reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = policy.infer(request)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1000
    launches = {k: v for k, v in _read_launches().items() if v}
    tokens = launches.get("flash_mha", 0) // 18
    want = {"flash_mha": 18 * tokens, "flash_mhsa": 27, "row_quant": 18 * 5 * tokens, "int8_matmul": 18 * 6 * tokens}
    _check(launches == want and 1 <= tokens <= FAST_MAX_DECODING_STEPS, f"fast int8 serving: launches {launches}")
    actions = out["actions"]
    _check(actions.shape == (10, 8) and np.isfinite(actions).all(), f"fast int8 serving: actions {actions.shape}")
    obs = Observation.from_dict(_device_inputs(policy.stage_inputs(request)))
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache, prefill_len, prefix_start = policy.model.prefill(obs, FAST_MAX_DECODING_STEPS)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1000)
    prefill = statistics.median(prefill_ms)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        policy.model.prefill(obs, FAST_MAX_DECODING_STEPS)
        policy.model.decode_step(logits.argmax(-1), 0, cache, prefill_len, prefix_start)
        torch.cuda.synchronize()
    counts = _check_int8_orientations(_kernels_named(prof, "int8_mm"), "fast int8 prefill and decode step")
    want_kernels = {"wgmma nt": 18 * 6, "wgmma nn": 0, "splitk nt": 18 * 6, "mma.sync nt": 0, "mma.sync nn": 0}
    _check(counts == want_kernels, f"fast int8: int8 kernels of a prefill and a decode step {counts}")
    infer_ms = out["policy_timing"]["infer_ms"]
    print(f"fast int8 serving: create_trained_policy({FAST_CONFIG!r}, quantize=True) in {load_s:.2f}s; 1 raw DROID "
          f"request, greedy: tokens decoded {tokens} (of {FAST_MAX_DECODING_STEPS}); wall_ms {wall:.2f}; infer_ms "
          f"{infer_ms:.2f}; ms a token {infer_ms / tokens:.3f}; prefill ms (median of 3) {prefill:.2f}; ms a decode "
          f"step {(infer_ms - prefill) / max(tokens - 1, 1):.3f}; launches {launches}; actions finite, max |int8 - "
          f"bf16| {np.abs(actions - bf16_actions).max():.4e}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del policy, obs, logits, cache
    torch.cuda.empty_cache()
    return launches


FAST_PREFILL_ROWS = 1018  # pi0_fast_droid's prefill: 3 x 256 image tokens + 250 prompt tokens


def check_fast_int8_kernels() -> dict:
    """Phase 20: K5 and K4b (``nt``, both scales) at int8 π₀-FAST serving's shapes, every Gemma-2B site at M = 1 (a
    decode step: split-K) and M = 1,018 (the prefill: ``wgmma``), bf16, against their plain versions (bit-equal),
    timed beside the bound and ``torch._int_mm`` + scaling (at M = 1 none: ``torch._int_mm`` takes more than 16
    rows). Returns K5's and K4b's records under keys suffixed ``_fast_decode`` and ``_fast_prefill`` (K5 at K =
    2048, K4b at gate/up)."""
    from kai0_tpu_torch.ops import int8_matmul as mm
    from kai0_tpu_torch.ops import row_quant as rq

    gen = torch.Generator(device="cuda").manual_seed(20)
    bf16, f32 = torch.bfloat16, torch.float32
    record = {"row_quant": {}, "int8_matmul": {}}
    for m, label in ((1, "fast_decode"), (FAST_PREFILL_ROWS, "fast_prefill")):
        for k in (2048, 16384):
            x = (torch.randn(m, k, generator=gen, device="cuda") * 3).to(bf16)
            xq, sx = rq.row_quant(x)
            ref_q, ref_s = rq.row_quant_plain(x)
            torch.cuda.synchronize()
            _check(torch.equal(xq, ref_q) and torch.equal(sx, ref_s), f"row_quant [{m},{k}]: not bit-equal")
            ms, plain_ms = _cuda_ms(lambda: rq.row_quant(x), runs=10), _cuda_ms(lambda: rq.row_quant_plain(x), runs=10)
            bound_ms = _nbytes(x, xq, sx) / HBM_BYTES_PER_S * 1e3
            print(f"kernel row_quant [{m},{k}] bf16 ({label}): bit-equal; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} (bytes)")
            if k == 2048:
                record["row_quant"].update({f"max_abs_err_{label}": 0.0, f"ms_{label}": ms, f"plain_ms_{label}": plain_ms,
                                            f"bound_ms_{label}": bound_ms, f"bound_by_{label}": "bytes",
                                            f"library_ms_{label}": None})
        for site, (k, n) in INT8_SITES["gemma_2b"][0].items():
            w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
            sn = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-5
            xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
            sx = torch.rand(m, 1, generator=gen, device="cuda") * 1e-2 + 1e-4
            kernel = lambda: mm.int8_matmul(xq, w, sx, sn, nt=True, out_dtype=bf16)  # noqa: E731
            plain = lambda: mm.int8_matmul_plain(xq, w, sx, sn, nt=True, out_dtype=bf16)  # noqa: E731
            library = lambda: (torch._int_mm(xq, w.T).to(f32) * sx * sn).to(bf16)  # noqa: E731
            out = kernel()
            _check(torch.equal(out, plain()), f"int8_matmul gemma_2b {site} M={m}: not bit-equal")
            if m > 16:
                _check(torch.equal(library(), out), f"int8_matmul gemma_2b {site} M={m}: library yardstick differs")
            ms, plain_ms = _cuda_ms(kernel, runs=10), _cuda_ms(plain, runs=10)
            lib_ms = _cuda_ms(library, runs=10) if m > 16 else None
            bound_ms, bound_by = _int8_bound(m, n, k, _nbytes(xq, w, sx, sn, out))
            print(f"kernel int8_matmul gemma_2b {site} nt M={m} K={k} N={n} ({label}): bit-equal; kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} int_mm_ms={'none (M <= 16)' if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"bound_ms={bound_ms:.4f} ({bound_by})")
            if site == "gate/up":
                record["int8_matmul"].update({f"max_abs_err_{label}": 0.0, f"ms_{label}": ms,
                                              f"plain_ms_{label}": plain_ms, f"bound_ms_{label}": bound_ms,
                                              f"bound_by_{label}": bound_by, f"library_ms_{label}": lib_ms})
    return record


def fast_card_vs_host() -> None:
    """Phase 20: π₀-FAST at full width, depth 2, f32, card (kernels) against host (plain): the prefill's logits and
    those of 15 decode steps fed seeded tokens (the same on both sides, so each step reads a cache that differs from
    the last) within 1e-3 x their max, and the first 16 greedy tokens equal."""
    from kai0_tpu_torch.models.model import Observation
    from kai0_tpu_torch.models.pi0_fast import FAST_IMAGE_KEYS, Pi0FAST, Pi0FASTConfig

    config = _cut_depth_config(base=Pi0FASTConfig, action_dim=8, action_horizon=10, dtype="float32")
    model = Pi0FAST(config, device="cuda", param_dtype=torch.float32).init_weights(
        torch.Generator(device="cuda").manual_seed(23)).eval()
    rng = np.random.default_rng(23)
    mask = np.arange(config.max_token_len) < 60
    inputs = {"image": {k: rng.integers(0, 256, (1, 224, 224, 3), dtype=np.uint8) for k in FAST_IMAGE_KEYS},
              "image_mask": {k: np.ones(1, bool) for k in FAST_IMAGE_KEYS},
              "state": rng.uniform(-1, 1, (1, 8)).astype(np.float32),
              "tokenized_prompt": np.where(mask, rng.integers(2, 257_152, config.max_token_len), 0)[None].astype(np.int32),
              "tokenized_prompt_mask": mask[None], "token_ar_mask": np.zeros((1, config.max_token_len), np.int32),
              "token_loss_mask": np.zeros((1, config.max_token_len), bool)}
    fed = rng.integers(2, 257_152, FAST_CARD_VS_HOST_STEPS - 1)

    def run(device):
        obs = Observation.from_dict({k: {n: torch.from_numpy(x).to(device) for n, x in v.items()} if isinstance(v, dict)
                                     else torch.from_numpy(v).to(device) for k, v in inputs.items()})
        logits, cache, prefill_len, prefix_start = model.prefill(obs, FAST_CARD_VS_HOST_STEPS)
        steps = [logits[0, 0].cpu()]
        for step, token in enumerate(fed):
            logits, cache = model.decode_step(torch.tensor([[token]], device=device), step, cache, prefill_len,
                                              prefix_start)
            steps.append(logits[0, 0].cpu())
        return torch.stack(steps), model.sample_actions(obs, max_decoding_steps=FAST_CARD_VS_HOST_STEPS).cpu()

    card_logits, card_tokens = run("cuda")
    model.to("cpu")
    torch.cuda.empty_cache()
    host_logits, host_tokens = run("cpu")
    errs = (card_logits - host_logits).abs().amax(dim=-1)
    scales = host_logits.abs().amax(dim=-1)
    worst = float((errs / scales).max())
    print(f"fast card vs host (full width, depth 2, f32): logits of the prefill and {len(fed)} decode steps fed "
          f"seeded tokens: worst max_abs_err / max|logits| {worst:.3e} (tolerance 1e-3; prefill {float(errs[0]):.3e} "
          f"of {float(scales[0]):.3f}, steps {[f'{float(e):.2e}' for e in errs[1:]]}); the host's argmax at those "
          f"steps takes {len(set(host_logits.argmax(-1).tolist()))} values; greedy tokens card "
          f"{card_tokens[0].long().tolist()}, host equal {torch.equal(card_tokens, host_tokens)}")
    _check(bool((errs <= 1e-3 * scales).all()) and torch.equal(card_tokens, host_tokens), "fast card vs host mismatch")


def train_pi0_and_fast(root: pathlib.Path) -> dict:
    """Phase 20: 3 steps of ``train_lib.main`` at batch 32 in phase 9's memory configuration (bf16 parameters, int8
    moments, no EMA) for π₀ (``pi0_base``) and for π₀-FAST (``pi0_fast_libero``'s model, 180 tokens, on fake data);
    each step's launches must be phase 9's. Returns each run's launches."""
    import os

    from kai0_tpu_torch.training import config as train_config
    from kai0_tpu_torch.training import train_lib, weight_loaders

    os.environ["WANDB_MODE"] = "disabled"  # the loop's MetricsLogger uses wandb when it imports; no network here
    fast = dataclasses.replace(train_config.get_config(FAST_TRAIN_CONFIG), data=train_config.FakeDataConfig(),
                               weight_loader=weight_loaders.NoOpWeightLoader())
    from kai0_tpu_torch.training import checkpoints

    launches = {}
    for label, base in (("pi0", train_config.get_config("pi0_base")), ("fast", fast)):
        # Fake data read in a thread: the spawn workers' start-up is phases 18, 19 and 22's to measure.
        config = _train_entry_config(base, str(root / f"train_{label}"), num_train_steps=PHASE20_TRAIN_STEPS,
                                     num_workers=0)
        _reset_launches()
        recorder = _StepRecorder(f"{label} train", TRAIN_BATCH, TRAIN_STEP_LAUNCHES)
        t = time.perf_counter()
        recorder.start()
        saved = checkpoints.save_state  # the last step's save left out (6-8 s each): phase 18 holds saves
        checkpoints.save_state = lambda *args, **kwargs: 0
        try:
            model, state = train_lib.main(config, on_step=recorder)
        finally:
            checkpoints.save_state = saved
        walls = [r["wall_ms"] for r in recorder.rows[1:]]
        launches[label] = _read_launches()
        print(f"  {label} train ({base.name}'s model, {type(model).__name__}): {time.perf_counter() - t:.1f}s in all; "
              f"median wall_ms over steps 1-{PHASE20_TRAIN_STEPS - 1} = {statistics.median(walls):.2f} "
              f"({TRAIN_BATCH / statistics.median(walls) * 1000:.3f} samples/s); peak "
              f"{max(r['peak_gib'] for r in recorder.rows):.3f} GiB; launches over {PHASE20_TRAIN_STEPS} steps "
              f"{ {k: v for k, v in launches[label].items() if v} }")
        _check(state.step == PHASE20_TRAIN_STEPS, f"{label} train ended at step {state.step}")
        del model, state
        torch.cuda.empty_cache()
    return launches


def pi0_and_fast() -> dict:
    """Phase 20: π₀ and π₀-FAST served and trained at full width through the port's entry points."""
    import shutil
    import tempfile

    record = {"flash_mha": check_fast_attention()}
    for name, numbers in check_family_attention_training().items():
        record.setdefault(name, {}).update(numbers)
    for name, numbers in check_fast_int8_kernels().items():
        record.setdefault(name, {}).update(numbers)
    family_gradients()
    with tempfile.TemporaryDirectory(prefix="kai0_pi0_") as root:
        root = pathlib.Path(root)
        pi0_serving = serve_pi0(root)
        shutil.rmtree(root / "pi0")
        pi0_card_vs_host()
        fast_serving, fast_int8_serving = serve_fast(root)
        shutil.rmtree(root / "fast")
        fast_card_vs_host()
        train = train_pi0_and_fast(root)
    return {"pi0_serving": pi0_serving, "fast_serving": fast_serving, "fast_int8_serving": fast_int8_serving,
            "pi0_train": train["pi0"], "fast_train": train["fast"], "records": record}


ARITH_CONFIG = "pi05_base"
ARITH_CHECKPOINTS = 3
ARITH_PERTURBATION = 0.01  # x each leaf's std: the checkpoints stand for fine-tunes of one base, which kai0 mixes
ARITH_BATCHES, ARITH_BATCH = 4, 8
ARITH_GD_ITERATIONS = 3
ARITH_SAMPLED_KEYS = 64
# The mixed model.safetensors is bf16: each mixed weight is rounded once more, by at most 2^-9 of itself, where the
# ensemble keeps its f32 mix. The weights the model casts to bf16 for its products move only where that rounding
# flips (almost never); the ones it reads in f32 (norm scales, the action and time heads, adaRMS) move by up to 2^-9,
# with random signs. 1e-3 of the loss holds that and not a mix at other weights.
ARITH_MIXED_LOSS_RTOL = 1e-3
ARITH_HOST_LOSS_RTOL = 1e-5
ARITH_HOST_GRAD_TOL = 1e-3  # x max |dL/dw| of the host


class _Calls:
    """Within the block, each call of ``owner.name`` is timed (wall ms, between synchronizes unless ``sync`` is
    false) and ``keep(args, out)`` recorded; the attribute is restored after."""

    def __init__(self, owner, name: str, keep=lambda args, out: None, sync: bool = True):
        self.owner, self.name, self.keep, self.sync, self.rows = owner, name, keep, sync, []

    def __enter__(self):
        fn = self.fn = getattr(self.owner, self.name)

        def timed(*args, **kwargs):
            if self.sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.sync:
                torch.cuda.synchronize()
            self.rows.append(((time.perf_counter() - t) * 1000, self.keep(args, out)))
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)

    @property
    def ms(self) -> list[float]:
        return [ms for ms, _ in self.rows]


def _script(name: str):
    """``scripts/<name>.py`` as a module, so that its ``main`` runs in this process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"kai0_script_{name}",
                                                  pathlib.Path(__file__).resolve().parent / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _arithmetic_checkpoints(root: pathlib.Path, model_config) -> list[pathlib.Path]:
    """Phase 21's checkpoints: a seeded bf16 base, and copies of it with every leaf moved by seeded noise of
    ``ARITH_PERTURBATION`` x that leaf's std; the files are written from the card by one thread each."""
    from concurrent.futures import ThreadPoolExecutor

    from kai0_tpu_torch import interop
    from kai0_tpu_torch.models.pi0 import Pi0

    model = Pi0(model_config, device="cuda", param_dtype=torch.bfloat16).init_weights(
        torch.Generator(device="cuda").manual_seed(21))
    base = {name: p.detach() for name, p in model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(2100)
    states = [base]
    for _ in range(ARITH_CHECKPOINTS - 1):
        states.append({name: (b.float() + ARITH_PERTURBATION * b.float().std() * torch.randn(
            b.shape, generator=gen, device="cuda")).to(b.dtype) for name, b in base.items()})
    paths = [root / f"ckpt_{k}" for k in range(ARITH_CHECKPOINTS)]
    for path in paths:
        path.mkdir()
    with ThreadPoolExecutor(ARITH_CHECKPOINTS) as pool:
        list(pool.map(lambda k: interop.write_safetensors(states[k], paths[k] / "model.safetensors"),
                      range(ARITH_CHECKPOINTS)))
    del model, base, states
    torch.cuda.empty_cache()
    return paths


def _on_simplex(weights) -> bool:
    w = np.asarray(weights, dtype=np.float64)
    return bool(np.all(w >= 0) and abs(w.sum() - 1.0) <= 1e-6)


def _arithmetic_card_vs_host(root: pathlib.Path, batch: tuple) -> None:
    """Phase 21 (g): two depth-2 full-width checkpoints, f32 compute, batch 2, fixed draws: the card's ``Ensemble``
    (kernels) against the host's (plain versions)."""
    from kai0_tpu_torch import interop
    from kai0_tpu_torch.arithmetic import core
    from kai0_tpu_torch.models.pi0 import Pi0

    cut = _cut_depth_config(2, pi05=True, dtype="float32")
    paths = []
    for seed in (211, 212):
        model = Pi0(cut, device="cuda", param_dtype=torch.bfloat16).init_weights(
            torch.Generator(device="cuda").manual_seed(seed))
        paths.append(interop.save_torch_checkpoint(model, root / f"depth2_{seed}").parent)
        del model
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(213)
    draws = [(torch.randn((2, 50, 32), generator=gen), torch.rand(2, generator=gen) * 0.999 + 0.001)]
    results = {}
    for device in ("cuda", "cpu"):
        t = time.perf_counter()
        ensemble = core.Ensemble(paths, cut, device=device)
        staged = ensemble.stage([batch], draws=draws)
        vertices = ensemble.checkpoint_losses(staged)
        loss, grad = ensemble.loss_and_weight_grad([0.3, 0.7], staged)
        results[device] = (vertices, loss, grad, time.perf_counter() - t)
        del ensemble, staged
        torch.cuda.empty_cache()
    (cv, cl, cg, cs), (hv, hl, hg, hs) = results["cuda"], results["cpu"]
    vertex_err = max(abs(a - b) / abs(b) for a, b in zip(cv, hv, strict=True))
    loss_err = abs(cl - hl) / abs(hl)
    grad_err = np.abs(cg - hg).max() / np.abs(hg).max()
    print(f"  card vs host (depth 2, f32, N=2, batch 2): vertex losses {cv} / {hv} (worst relative {vertex_err:.3e}); "
          f"at w=(0.3, 0.7) loss {cl:.6f} / {hl:.6f} (relative {loss_err:.3e}), dL/dw {cg.tolist()} / {hg.tolist()} "
          f"({grad_err:.3e} x max); card {cs:.1f}s, host {hs:.1f}s")
    _check(vertex_err <= ARITH_HOST_LOSS_RTOL, f"arithmetic card vs host: vertex losses {cv} vs {hv}")
    _check(loss_err <= ARITH_HOST_LOSS_RTOL, f"arithmetic card vs host: loss {cl} vs {hl}")
    _check(grad_err <= ARITH_HOST_GRAD_TOL, f"arithmetic card vs host: dL/dw {cg} vs {hg}")


def model_arithmetic() -> dict:
    """Phase 21: Model Arithmetic at full width through the port's entry points; returns the kernels' record and the
    launches of the mixing script's run, of one gradient-descent iteration and of one loss evaluation."""
    import pickle
    import shutil
    import tempfile

    from kai0_tpu_torch import interop
    from kai0_tpu_torch.arithmetic import core
    from kai0_tpu_torch.models.pi0 import Pi0
    from kai0_tpu_torch.training import config as train_config

    record = check_attention_training({ARITH_BATCH: ("_arithmetic", (torch.bfloat16,))})
    model_config = train_config.get_config(ARITH_CONFIG).model
    n = sum(p.numel() for p in Pi0(model_config, device="meta").parameters())
    n_cut = sum(p.numel() for p in Pi0(_cut_depth_config(2, pi05=True), device="meta").parameters())
    needed = (ARITH_CHECKPOINTS + 1) * 2 * n + 2 * 2 * n_cut
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    print(f"model arithmetic: {free / 1e9:.3f} GB free under {tmp}; {needed / 1e9:.3f} GB needed")
    if free < needed:
        raise RuntimeError(f"phase 21 needs {needed} bytes free under {tmp}, which has {free}")
    dump, cli = _script("dump_data_torch"), _script("model_arithmetic_torch")
    with tempfile.TemporaryDirectory(prefix="kai0_arithmetic_") as root:
        root = pathlib.Path(root)
        t = time.perf_counter()
        paths = _arithmetic_checkpoints(root, model_config)
        nbytes = sum((p / "model.safetensors").stat().st_size for p in paths)
        print(f"  {ARITH_CHECKPOINTS} checkpoints ({n} bf16 parameters each, {nbytes / 1e9:.3f} GB in all; a base and "
              f"{ARITH_CHECKPOINTS - 1} copies moved by {ARITH_PERTURBATION} x each leaf's std) written in "
              f"{time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        data = dump.main(["--config", ARITH_CONFIG, "--output", str(root / "val.pkl"),
                          "--num-batches", str(ARITH_BATCHES), "--batch-size", str(ARITH_BATCH)])
        print(f"  scripts/dump_data_torch.py: {ARITH_BATCHES} batches of {ARITH_BATCH} ({ARITH_CONFIG}, fake data) in "
              f"{time.perf_counter() - t:.1f}s, {data.stat().st_size} bytes")

        # The main path: the mixing script, gradient descent, then its f64 mix and save, counts at 0 just before.
        argv = ["--checkpoints", *map(str, paths), "--output", str(root / "mixed"), "--optimize_method",
                "gradient_descent", "--config", ARITH_CONFIG, "--data-path", str(data),
                "--num_iterations", str(ARITH_GD_ITERATIONS)]
        weights_and_loss = lambda args, out: (np.asarray(args[1], np.float32), out if np.isscalar(out) else out[0])  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t = time.perf_counter()
        with (_Calls(core.Ensemble, "__init__") as load, _Calls(core.Ensemble, "mix") as mix,
              _Calls(core.Ensemble, "project") as project,
              _Calls(core.Ensemble, "loss_and_weight_grad", weights_and_loss) as steps,
              _Calls(core, "mix_state_dicts") as host_mix, _Calls(interop, "write_safetensors") as save):
            gd = cli.main(argv)
        wall = time.perf_counter() - t
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        mixed_path = root / "mixed" / "model.safetensors"
        per_batch = {k: v if k.startswith("flash") else 0 for k, v in TRAIN_STEP_LAUNCHES.items()}
        per_iteration = {k: ARITH_BATCHES * v for k, v in per_batch.items()}
        print(f"  scripts/model_arithmetic_torch.py gradient_descent, {ARITH_GD_ITERATIONS} iterations: {wall:.1f}s in "
              f"all; load {load.ms[0] / 1000:.1f}s ({nbytes} bytes); ms a GD iteration {[f'{x:.1f}' for x in steps.ms]}; "
              f"mix ms {[f'{x:.1f}' for x in mix.ms]}; projections ms {[f'{x:.1f}' for x in project.ms]}; f64 mix "
              f"{host_mix.ms[0] / 1000:.1f}s and save {save.ms[0] / 1000:.1f}s ({mixed_path.stat().st_size} bytes); "
              f"peak {peak:.3f} GiB; launches {launches}")
        _check(launches == {k: ARITH_GD_ITERATIONS * v for k, v in per_iteration.items()},
               f"the mixing script launched {launches}, want {ARITH_GD_ITERATIONS} x {per_iteration}")
        evaluated = [row for _, row in steps.rows]
        chosen = [loss for w, loss in evaluated if np.array_equal(w, np.asarray(gd, np.float32))]
        _check(len(evaluated) == ARITH_GD_ITERATIONS and np.allclose(evaluated[0][0], 1 / ARITH_CHECKPOINTS)
               and len(chosen) > 0, f"gradient descent evaluated {evaluated} and returned {gd}")
        gd_loss = chosen[0]
        print(f"  gradient_descent: losses {[round(loss, 6) for _, loss in evaluated]}; weights {gd}, loss {gd_loss:.6f}")
        _check(_on_simplex(gd) and gd_loss <= evaluated[0][1],
               f"gradient descent: weights {gd}, loss {gd_loss} against {evaluated[0][1]} at the uniform start")

        # The other modes on an Ensemble called directly (weights only: their host mixes are skipped).
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        ensemble = core.Ensemble(paths, model_config)
        load_s = time.perf_counter() - t
        with open(data, "rb") as f:
            batches = ensemble.stage(pickle.load(f))
        _reset_launches()
        with _Calls(core.Ensemble, "loss", weights_and_loss) as evals:
            losses = ensemble.checkpoint_losses(batches)
            per_loss = {k: v // ARITH_CHECKPOINTS for k, v in _read_launches().items()}
            inverse = core.compute_optimal_weights(losses)
            inverse_loss = ensemble.loss(inverse, batches)
            greedy = core.optimize_weights_greedy(ensemble, batches, grid=2)
            ensemble_loss = ensemble.loss(gd, batches)
        greedy_loss = min(loss for w, loss in [row for _, row in evals.rows]
                          if np.array_equal(w, np.asarray(greedy, np.float32)))
        print(f"  Ensemble called directly: load {load_s:.1f}s; ms a loss evaluation ({ARITH_BATCHES} batches of "
              f"{ARITH_BATCH}) {[f'{x:.1f}' for x in evals.ms]}; launches of one {per_loss}; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"  vertex losses {losses}; inverse_loss weights {inverse}, loss {inverse_loss:.6f}; greedy (grid 2) "
              f"weights {greedy}, loss {greedy_loss:.6f}; at gradient descent's weights {ensemble_loss:.6f}")
        _check(per_loss == {k: ARITH_BATCHES * v // 2 if k in ("flash_mha", "flash_mhsa") else 0
                            for k, v in per_batch.items()}, f"a loss evaluation launched {per_loss}")
        _check(_on_simplex(inverse) and _on_simplex(greedy), f"weights off the simplex: {inverse}, {greedy}")
        _check(greedy_loss <= min(losses), f"greedy's loss {greedy_loss} above the best vertex's {min(losses)}")
        del ensemble
        torch.cuda.empty_cache()

        # The saved tensors against the host's f64 mix, on a seeded sample of keys covering every dtype.
        states = [interop.read_safetensors(p / "model.safetensors") for p in paths]
        mixed = interop.read_safetensors(mixed_path)
        keys = sorted(mixed)
        sample = set(np.random.default_rng(21).choice(keys, ARITH_SAMPLED_KEYS, replace=False).tolist())
        for dtype in {mixed[k].dtype for k in keys} - {mixed[k].dtype for k in sample}:
            sample.add(next(k for k in keys if mixed[k].dtype == dtype))
        t = time.perf_counter()
        differing = []
        for k in sorted(sample):  # the host's mix element by element, in chunks that stay in the CPU's caches
            flat = [s[k].reshape(-1) for s in states]
            for start in range(0, flat[0].numel(), 1 << 20):
                host = core.mix_state_dicts([{k: x[start : start + (1 << 20)]} for x in flat], gd, device="cpu")[k]
                if not torch.equal(host, mixed[k].reshape(-1)[start : start + (1 << 20)]):
                    differing.append(k)
                    break
        print(f"  the saved mix against the host's f64 mix: {len(sample)} keys "
              f"({sum(mixed[k].numel() for k in sample)} values, {sorted({str(mixed[k].dtype) for k in sample})}) in "
              f"{time.perf_counter() - t:.1f}s, {len(differing)} differ")
        _check(set(mixed) == set(states[0]) and not differing, f"the saved mix differs from the host's: {differing}")
        del states, mixed

        # A Pi0 loaded from the mixed file, on the same batches and draws, against the ensemble at the same weights.
        model = interop.load_torch_checkpoint(Pi0(model_config, device="cuda"), mixed_path.parent)
        with torch.no_grad():
            mixed_loss = sum(model.compute_loss(b.observation, b.actions, noise=b.noise, time=b.time).mean().item()
                             for b in batches) / len(batches)
        rel = abs(mixed_loss - ensemble_loss) / abs(ensemble_loss)
        print(f"  the mixed model.safetensors in a Pi0: loss {mixed_loss:.6f} against the ensemble's {ensemble_loss:.6f} "
              f"(relative {rel:.3e}, tolerance {ARITH_MIXED_LOSS_RTOL})")
        _check(rel <= ARITH_MIXED_LOSS_RTOL, f"the mixed checkpoint's loss {mixed_loss} vs the ensemble's {ensemble_loss}")
        del model, batches
        torch.cuda.empty_cache()

        with open(data, "rb") as f:
            observation, actions = pickle.load(f)[0]
        rows = lambda tree: {k: rows(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[:2]  # noqa: E731
        _arithmetic_card_vs_host(root, (rows(observation), actions[:2]))
    return {"records": record, "launches": launches, "gd_iteration": per_iteration, "loss": per_loss}


# ---------------------------------------------------------------------------
# Phase 22: Train-Deploy Alignment's data side
# ---------------------------------------------------------------------------

# Phase 19's dataset layout at 50 frames an episode, which the 1,200 s budget allows.
ALIGN_EPISODES, ALIGN_FRAMES = 2, 50
ALIGN_FACTOR = 2  # the time scale, offline and in the view
# 4 steps: main takes batch 0 before it builds the model, and batches 1-3 are collated while it does (a queue of 2 and
# one in hand), so batch 4 is the first that the workers collate while steps run; the loader's rate is read from the
# collations of batches 4 on.
ALIGN_STEPS, ALIGN_WORKERS, ALIGN_PREFETCHED = 4, 8, 4
ALIGN_VIDEO_TOL = 30.0  # mean abs difference of a decoded frame, view vs offline mp4 (tests/test_augment.py's bound)
ALIGN_INDICES = (0, 18, 24, 25, 49, 50, 68, 74, 75, 99)  # both episodes of both halves, each episode's last item
ALIGN_EXACT_KEYS = ("observation.state", "action", "episode_index", "index", "frame_index", "timestamp")


def _tools(*chains) -> None:
    """Each chain a list of ``(script, *args)`` run in turn as subprocesses of ``scripts/<script>``, as a user runs
    them; the chains side by side. Prints each tool's seconds and last line of output."""
    import concurrent.futures

    def run(chain):
        lines = []
        for script, *args in chain:
            t = time.perf_counter()
            out = subprocess.run([sys.executable, f"scripts/{script}", *map(str, args)], capture_output=True, text=True,
                                 timeout=300, cwd=pathlib.Path(__file__).resolve().parent)
            _check(out.returncode == 0, f"scripts/{script} failed:\n{out.stderr[-4000:]}")
            lines.append(f"  scripts/{script}: rc 0 in {time.perf_counter() - t:.1f}s: "
                         f"{out.stdout.strip().splitlines()[-1]}")
        return lines

    with concurrent.futures.ThreadPoolExecutor(len(chains)) as pool:
        for lines in pool.map(run, chains):
            print("\n".join(lines))


def _counts(root: pathlib.Path, episodes: int, frames: int) -> None:
    """The meta files and the parquet tables of a written dataset both hold ``episodes`` and ``frames``."""
    import pyarrow.parquet as pq

    from kai0_tpu_torch.data import lerobot_meta

    meta = lerobot_meta.LeRobotMetadata.load(root)
    rows = [pq.read_table(meta.data_path(ep["episode_index"])).num_rows for ep in meta.episodes]
    index = np.concatenate([pq.read_table(meta.data_path(ep["episode_index"])).column("index").to_numpy()
                            for ep in meta.episodes])
    videos = sum(meta.video_path(ep["episode_index"], k).exists() for ep in meta.episodes for k in meta.video_keys)
    print(f"    {root.name}: {meta.info['total_episodes']} episodes, {meta.info['total_frames']} frames, rows "
          f"{rows}, {videos} videos, global index 0..{index.max()}")
    _check(meta.info["total_episodes"] == len(meta.episodes) == episodes and meta.info["total_frames"] == frames
           and sum(rows) == frames and [ep["length"] for ep in meta.episodes] == rows
           and videos == episodes * len(AGILEX_CAMERAS) and np.array_equal(index, np.arange(frames)),
           f"{root}: counts differ from {episodes} episodes of {frames} frames")


def _view_against_offline(raw: pathlib.Path, offline: pathlib.Path, horizon: int) -> None:
    """``MirroredView(TimeScaledView(raw))`` against a reader over the offline time-scaled-then-mirrored dataset:
    the parquet keys bit-equal, each camera within ``ALIGN_VIDEO_TOL``."""
    from kai0_tpu_torch.data import augment_views, lerobot_dataset

    kwargs = dict(action_horizon=horizon, action_sequence_keys=("action",))
    view = augment_views.MirroredView(augment_views.TimeScaledView(
        lerobot_dataset.LeRobotDataset(str(raw), **kwargs), ALIGN_FACTOR))
    rewritten = lerobot_dataset.LeRobotDataset(str(offline), **kwargs)
    _check(len(view) == len(rewritten) == 2 * ALIGN_EPISODES * -(-ALIGN_FRAMES // ALIGN_FACTOR),
           f"view {len(view)} vs offline {len(rewritten)} items")
    worst = dict.fromkeys(AGILEX_CAMERAS, 0.0)
    for i in ALIGN_INDICES:
        a, b = view[i], rewritten[i]
        differing = [k for k in ALIGN_EXACT_KEYS if not np.array_equal(a[k], b[k])]
        _check(not differing, f"item {i}: {differing} differ between the view and the offline rewrite")
        for cam in AGILEX_CAMERAS:
            key = f"observation.images.{cam}"
            worst[cam] = max(worst[cam], float(np.abs(a[key].astype(np.float32) - b[key].astype(np.float32)).mean()))
    print(f"  MirroredView(TimeScaledView(raw, {ALIGN_FACTOR})) vs the offline rewrite, {len(view)} items each: at "
          f"{list(ALIGN_INDICES)} {', '.join(ALIGN_EXACT_KEYS)} bit-equal; worst mean abs image difference "
          + ", ".join(f"{cam} {d:.3f}" for cam, d in worst.items()) + f" (bound {ALIGN_VIDEO_TOL})")
    _check(max(worst.values()) < ALIGN_VIDEO_TOL, f"images of the view vs the offline rewrite: {worst}")


def train_deploy_alignment() -> dict:
    """Phase 22: Train-Deploy Alignment's data side on the card's machine: the offline tools as scripts, the
    train-time views against their output, both norm-stats scripts, and ``train_lib.main`` at full width through
    the mirror and time-scale views; returns the launches of its steps."""
    import os
    import tempfile

    from kai0_tpu_torch.training import checkpoints, data_loader, train_lib, weight_loaders
    from kai0_tpu_torch.training import config as train_config

    print(f"alignment: the JAX package's data-tool imports (phase 18's probe): {_probe(('pandas', 'h5py', 'tqdm'))}")
    os.environ["WANDB_MODE"] = "disabled"
    base = train_config.get_config(ENTRY_CONFIG)
    with tempfile.TemporaryDirectory(prefix="kai0_align_") as root:
        root = pathlib.Path(root)
        t = time.perf_counter()
        raw = _write_advantage_dataset(root / "raw", base.data.default_prompt, ALIGN_EPISODES, ALIGN_FRAMES)
        print(f"alignment: dataset of {ALIGN_EPISODES} x {ALIGN_FRAMES} frames, cameras {AGILEX_CAMERAS} at "
              f"{ADVANTAGE_HW} (mp4v), written in {time.perf_counter() - t:.1f}s")

        # The offline tools, each a subprocess of its script, in two chains side by side: time scale, then mirror
        # and merge the scaled dataset; a split and its merge (the second part first).
        kept = ALIGN_EPISODES * -(-ALIGN_FRAMES // ALIGN_FACTOR)
        t = time.perf_counter()
        _tools([("time_scaling_torch.py", "--src", raw, "--dst", root / "scaled", "--extraction-factor", ALIGN_FACTOR),
                ("space_mirroring_torch.py", "full", "--src", root / "scaled", "--dst", root / "scaled_mirrored")],
               [("split_lerobot_torch.py", "--source_path", raw, "--dst_path", root / "split", "--split_num", 2),
                ("merge_lerobot_torch.py", "--sources", root / "split" / "split_1", root / "split" / "split_0",
                 "--dst", root / "merged")])
        print(f"  (the two chains took {time.perf_counter() - t:.1f}s side by side)")
        _counts(root / "scaled", ALIGN_EPISODES, kept)
        _counts(root / "scaled_mirrored", 2 * ALIGN_EPISODES, 2 * kept)
        for part in ("split_0", "split_1"):
            _counts(root / "split" / part, ALIGN_EPISODES // 2, ALIGN_FRAMES * ALIGN_EPISODES // 2)
        _counts(root / "merged", ALIGN_EPISODES, ALIGN_EPISODES * ALIGN_FRAMES)

        t = time.perf_counter()
        _view_against_offline(raw, root / "scaled_mirrored", base.model.action_horizon)
        print(f"  (the comparison took {time.perf_counter() - t:.1f}s)")

        # Norm stats of the raw dataset seen through the mirror view, by both scripts (each into its own assets).
        def on_raw(assets: str, **flags):
            return dataclasses.replace(base, assets_base_dir=str(root / assets), data=dataclasses.replace(
                base.data, repo_id=str(raw), assets=train_config.AssetsConfig(asset_id="synthetic"),
                base_config=train_config.DataConfig(**flags)))

        stats_files = {}
        for script, assets in (("compute_norm_stats_torch", "assets"), ("compute_norm_stats_fast_torch", "fast")):
            t = time.perf_counter()
            batch = {"batch_size": TRAIN_BATCH} if script == "compute_norm_stats_torch" else {}
            out = _script(script).compute(on_raw(assets, augment_mirror=True), **batch) / "norm_stats.json"
            stats = json.loads(out.read_text())["norm_stats"]
            stats_files[script] = out
            print(f"  {script}.compute(augment_mirror=True): {time.perf_counter() - t:.1f}s, {out.stat().st_size} "
                  f"bytes, state mean[:4] {[round(x, 6) for x in stats['state']['mean'][:4]]}, keys {sorted(stats)}")
            _check(set(stats) == {"state", "actions"} and all(
                len(v) == base.model.action_dim for s in stats.values() for v in s.values()), f"{out}: {stats.keys()}")

        # Train through train_lib.main on the raw dataset through both views, with the norm stats just written. The
        # base checkpoint (a download) is replaced by the seeded init (config.seed), as phase 20 does; phase 18 holds
        # the checkpoint loader.
        config = dataclasses.replace(
            _train_entry_config(on_raw("assets", augment_mirror=True, augment_time_scale=ALIGN_FACTOR),
                                str(root / "checkpoints"), num_train_steps=ALIGN_STEPS, num_workers=ALIGN_WORKERS,
                                wandb_enabled=False, weight_loader=weight_loaders.NoOpWeightLoader()),
            exp_name="alignment")
        print(f"alignment: train_lib.main({ENTRY_CONFIG!r}, augment_mirror=True, augment_time_scale={ALIGN_FACTOR}, "
              f"batch {TRAIN_BATCH}, {ALIGN_STEPS} steps, {ALIGN_WORKERS} loader workers, phase 9's memory "
              f"configuration, the seeded init; the last step's save left out, phase 18 holds saves)")
        saved = checkpoints.save_state
        checkpoints.save_state = lambda *args, **kwargs: 0
        try:
            with _Calls(data_loader, "create_data_loader",
                        keep=lambda args, out: (out.data_config().norm_stats, len(out._loader._dataset))) as loaders, \
                    _Calls(data_loader.DataLoader, "_collate", sync=False) as collates:
                _reset_launches()
                recorder = _StepRecorder("alignment", TRAIN_BATCH, TRAIN_STEP_LAUNCHES)
                t = time.perf_counter()
                recorder.start()
                model, state = train_lib.main(config, on_step=recorder)
                total_s = time.perf_counter() - t
                launches = _read_launches()
        finally:
            checkpoints.save_state = saved
        (_, (norm_stats, items)), = loaders.rows
        walls = [r["wall_ms"] for r in recorder.rows[1:]]
        step_ms = statistics.median(walls)
        # The workers' rate: the producer's wall for a batch (8 workers decode, flip and transform 32 items, then the
        # stack), over the batches collated while steps ran.
        collate_ms = collates.ms[ALIGN_PREFETCHED:]
        print(f"  alignment main: {total_s:.1f}s in all; {items} items ({ALIGN_EPISODES} x {kept // ALIGN_EPISODES} "
              f"kept frames, and their mirrored twins); norm stats "
              f"{sorted(norm_stats) if norm_stats else None}; median wall_ms over steps 1-{ALIGN_STEPS - 1} = "
              f"{step_ms:.2f} ({TRAIN_BATCH / step_ms * 1000:.3f} samples/s); "
              f"loader wait ms {[round(r['loader_wait_ms'], 3) for r in recorder.rows]}; peak GiB "
              f"{[round(r['peak_gib'], 3) for r in recorder.rows]}; launches over {ALIGN_STEPS} steps "
              f"{ {k: v for k, v in launches.items() if v} }")
        print(f"  the loader's collation, ms a batch of {TRAIN_BATCH} ({ALIGN_WORKERS} workers): before the steps "
              f"{[round(ms, 1) for ms in collates.ms[:ALIGN_PREFETCHED]]}, while they ran "
              f"{[round(ms, 1) for ms in collate_ms]}"
              + (f"; median {statistics.median(collate_ms):.1f} ms = "
                 f"{TRAIN_BATCH / statistics.median(collate_ms) * 1000:.3f} samples/s against the step's "
                 f"{TRAIN_BATCH / step_ms * 1000:.3f}" if collate_ms else "; none while they ran"))
        _check(state.step == ALIGN_STEPS and norm_stats is not None and items == 2 * kept,
               f"alignment main: step {state.step}, norm stats {norm_stats is not None}, {items} items")
        del model, state
        torch.cuda.empty_cache()
    print(f"alignment: temporary files deleted; {torch.cuda.memory_allocated() / 2**30:.3f} GiB still allocated")
    return launches


SB_STEPS = 4  # phase 23 (a): SwitchBack full fine-tune steps, then one profiled step
SB_LOSS_RTOL, SB_GRAD_COSINE = 0.05, 0.98  # step 0 against the bf16 step: JAX's bars, tests/test_quant.py:566-573
SIGLIP_SHAPES = {"attn": (1152, 1152), "fc1": (1152, 4304), "fc2": (4304, 1152), "head": (1152, 2048)}  # (K, N)
SIGLIP_ROWS = {"train": TRAIN_BATCH * 3 * 256, "serve": 3 * 256}
INT8_MODES_REQUESTS = 10


def _sb_step_launches(batch: int, gemma: str = "ffn", siglip: str = "0") -> dict:
    """Launches of K5 and K4b in one full fine-tune step with SwitchBack at the selected sites, worked out from the
    code (``ops/quant.py``).

    Gemma, per expert and forward (run twice: once, and again as the
    backward's recompute): ``ffn``, the fused op: K5 on the 3 weights (their
    per-call codes), then per row chunk K5 on x and on act and 3 K4b (gate,
    up, down); ``attn``: q, the joint kv and out each K5 on the weight and on
    x and one K4b. Backward, per expert: ``ffn``, per chunk K5 on x and 2 K4b
    (gate and up re-derived) and the three ``dx`` (K5 with the column scale
    and K4b each; the codes are saved, not made again); ``attn``, the three
    ``dx``. The prefix expert's last layer reaches the loss only through its
    K and V: its backward is the kv and q ``dx`` (phase 13's account). SigLIP
    (27 layers, recomputed as Gemma's blocks; the head once): per layer q, k,
    v, out (``attn``) and fc1, fc2 (``mlp``) each K5 twice and one K4b
    forward and one ``dx`` backward, down to layer 0 (the patch embedding
    trains); the head (``head``) the same.
    """
    from kai0_tpu_torch.ops import quant

    on = {site: quant.switchback_on(gemma, site) for site in ("attn", "ffn")}
    vit = {site: quant.switchback_on(siglip, site) for site in ("attn", "mlp", "head")}
    pre, suf = (len(quant._row_chunks(batch * rows, mlp_dim)) for rows, mlp_dim in ((968, 16384), (50, 4096)))
    ffn, attn, depth, vit_depth = on["ffn"], on["attn"], 18, 27
    fwd = {"row_quant": ffn * (6 + 2 * (pre + suf)) + attn * 12, "row_quant_colscale": 0,
           "int8_matmul": ffn * 3 * (pre + suf) + attn * 6}
    bwd = {"row_quant": ffn * 4 * (pre + suf) + attn * 6, "row_quant_colscale": ffn * 3 * (pre + suf) + attn * 6,
           "int8_matmul": ffn * 5 * (pre + suf) + attn * 6}
    last = {"row_quant": ffn * 4 * suf + attn * 5, "row_quant_colscale": ffn * 3 * suf + attn * 5,
            "int8_matmul": ffn * 5 * suf + attn * 5}
    sites = 4 * vit["attn"] + 2 * vit["mlp"]
    out = {k: 2 * depth * fwd[k] + (depth - 1) * bwd[k] + last[k] for k in fwd}
    out["row_quant"] += vit_depth * (2 * 2 * sites + sites) + vit["head"] * 3
    out["row_quant_colscale"] += vit_depth * sites + vit["head"]
    out["int8_matmul"] += vit_depth * (2 * sites + sites) + vit["head"] * 2
    return {**out, "int8_matmul_lora": 0}


def _grad_cosine(a: dict, b: dict) -> float:
    """Cosine of two gradients over every parameter (a missing gradient counts as zeros), summed in f64."""
    dot = na = nb = 0.0
    for k in a.keys() | b.keys():
        x, y = a.get(k), b.get(k)
        if x is not None:
            na += float(x.float().square().sum(dtype=torch.float64))
        if y is not None:
            nb += float(y.float().square().sum(dtype=torch.float64))
        if x is not None and y is not None:
            dot += float((x.float() * y.float()).sum(dtype=torch.float64))
    return dot / max(np.sqrt(na * nb), 1e-30)


def _step0_loss_and_grads(model, batch, seed: int) -> tuple[float, dict]:
    """Loss and gradients of ``train_step``'s step 0 (its draws: ``step_generator(seed, 0)``), no update."""
    from kai0_tpu_torch.training import optimizer

    obs, actions = batch
    model.zero_grad(set_to_none=True)
    loss = model.compute_loss(obs, actions, train=True, generator=optimizer.step_generator(seed, 0, device="cuda"))
    loss = loss.mean()
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters() if p.requires_grad}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def switchback_training(phase9: dict) -> dict:
    """Phase 23 (a)-(c): the SwitchBack full fine-tune (``int8_sb_gemma=ffn``, the JAX package's full fine-tune
    default) and every SwitchBack site, against the bf16 step of phase 9; the fused SwitchBack FFN and SigLIP's
    int8 shapes against their plain versions."""
    from kai0_tpu_torch import knobs
    from kai0_tpu_torch.models.pi0 import Pi0, Pi0Config
    from kai0_tpu_torch.ops import quant
    from kai0_tpu_torch.training import optimizer, train_lib

    config = Pi0Config(pi05=True)
    base = train_lib.TrainConfig(optimizer=optimizer.AdamW(state_dtype="int8"), param_dtype="bfloat16", ema_decay=None)
    batches = [_train_batch(100 + i, TRAIN_BATCH) for i in range(SB_STEPS + 1)]  # phase 9's batches

    def fresh():  # phase 9's model and seed
        model = Pi0(config, device="cuda", param_dtype=torch.bfloat16)
        return model.init_weights(torch.Generator(device="cuda").manual_seed(9))

    def against_bf16(label, model, want_layers):
        loss, grads = _step0_loss_and_grads(model, batches[0], base.seed)
        cosine = _grad_cosine(grads, bf16_grads)
        del grads
        rel = abs(loss - phase9["loss0"]) / abs(phase9["loss0"])
        layers = sum(quant.is_switchback(m) for m in model.modules())
        print(f"switchback {label}: {layers} SwitchBack layers; step 0 loss {loss:.6f} against phase 9's "
              f"{phase9['loss0']:.6f} (rel {rel:.4e}, limit {SB_LOSS_RTOL}); gradient cosine to the bf16 step's "
              f"{cosine:.6f} (limit > {SB_GRAD_COSINE})")
        _check(layers == want_layers, f"switchback {label}: {layers} SwitchBack layers, want {want_layers}")
        _check(rel < SB_LOSS_RTOL and cosine > SB_GRAD_COSINE, f"switchback {label}: loss rel {rel}, cosine {cosine}")
        return {"loss0": loss, "loss_rel": rel, "cosine": cosine}

    # The bf16 step-0 gradient of phase 9's model; (b) first, so that this gradient is gone before (a)'s timed steps.
    model = fresh()
    bf16_loss, bf16_grads = _step0_loss_and_grads(model, batches[0], base.seed)
    print(f"switchback: the bf16 step 0 on phase 9's seed and batch: loss {bf16_loss:.6f} (phase 9's "
          f"{phase9['loss0']:.6f}, {'bit-equal' if bf16_loss == phase9['loss0'] else 'differs'})")

    # (b) every SwitchBack site: Gemma's attention and FFN, SigLIP's attention, MLP and head; one step.
    all_config = dataclasses.replace(base, knobs=knobs.Knobs(int8_sb_gemma="all", int8_switchback="all"))
    state = train_lib.init_train_state(model, all_config)
    record = {"all": against_bf16("all sites", model, 2 * 18 * 7 + 27 * 6 + 1)}
    want = {**TRAIN_STEP_LAUNCHES, **_sb_step_launches(TRAIN_BATCH, "all", "all")}
    before = _read_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, info = train_lib.train_step(model, state, batches[0], all_config)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1000
    launches = {k: v - before[k] for k, v in _read_launches().items()}
    print(f"  switchback all sites, one step: wall_ms={wall_ms:.2f} loss={float(info['loss']):.6f} "
          f"grad_norm={float(info['grad_norm']):.6f} launches={launches}")
    _check(launches == want and float(info["loss"]) == record["all"]["loss0"],
           f"switchback all sites: launches {launches}, want {want}")
    record["all"].update(wall_ms=wall_ms, launches=launches)
    del model, state
    torch.cuda.empty_cache()

    # (a) phase 9's model with SwitchBack on the Gemma FFN (the JAX package's full fine-tune default), 4 steps.
    model = fresh()
    sb_config = dataclasses.replace(base, knobs=knobs.Knobs(int8_sb_gemma="ffn"))
    state = train_lib.init_train_state(model, sb_config)
    record["ffn"] = against_bf16("ffn (full fine-tune)", model, 2 * 18 * 3)
    del bf16_grads
    want = {**TRAIN_STEP_LAUNCHES, **_sb_step_launches(TRAIN_BATCH, "ffn")}
    walls, step_launches = [], None
    for step, batch in enumerate(batches):
        profile = step == SB_STEPS
        before = _read_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if profile:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                state, info = train_lib.train_step(model, state, batch, sb_config)
                torch.cuda.synchronize()
        else:
            state, info = train_lib.train_step(model, state, batch, sb_config)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1000
        launches = {k: v - before[k] for k, v in _read_launches().items()}
        loss, grad_norm = float(info["loss"]), float(info["grad_norm"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  switchback ffn step {step}{' (profiled)' if profile else ''}: wall_ms={wall_ms:.2f} samples_per_s="
              f"{TRAIN_BATCH / wall_ms * 1000:.3f} loss={loss:.6f} grad_norm={grad_norm:.6f} peak_mem_gib={peak:.3f} "
              f"launches={launches}")
        _check(np.isfinite(loss) and np.isfinite(grad_norm) and grad_norm > 0, f"switchback step {step}: {loss}")
        _check(launches == want, f"switchback step {step}: launches {launches}, want {want}")
        if step == 0:
            _check(loss == record["ffn"]["loss0"], f"switchback step 0: train_step's loss {loss} differs from the "
                   f"same draws' {record['ffn']['loss0']}")
            step_launches = launches
        if 1 <= step < SB_STEPS:
            walls.append(wall_ms)
    median = statistics.median(walls)
    families, busy_ms, _ = _profile_families(prof)
    print(f"switchback ffn: median wall_ms over steps 1-{SB_STEPS - 1} = {median:.2f} ({TRAIN_BATCH / median * 1000:.3f} "
          f"samples/s) against phase 9's bf16 {phase9['median_ms']:.2f} ({TRAIN_BATCH / phase9['median_ms'] * 1000:.3f} "
          f"samples/s), same call; peak {peak:.3f} GiB; profiled step: {busy_ms:.2f} ms of device time: " + "; ".join(
              f"{fam} {ms:.2f} ms x{count}" for fam, (ms, count) in sorted(families.items(), key=lambda kv: -kv[1][0])))
    counts = _check_int8_orientations(_kernels_named(prof, "int8_mm"), "switchback ffn step")
    record["ffn"].update(median_ms=median, peak_gib=peak, launches=step_launches, families=families)
    del model, state
    torch.cuda.empty_cache()
    record["kernels"] = check_switchback_kernels()
    record["orientations"] = counts
    return record


def _with_plain_kernels(fn):
    """``fn()`` with ``ops.quant`` calling K5's and K4b's plain versions (on the card) in place of the kernels."""
    from kai0_tpu_torch.ops import int8_matmul as mm
    from kai0_tpu_torch.ops import quant
    from kai0_tpu_torch.ops import row_quant as rq

    saved = quant.row_quant, quant.int8_matmul
    quant.row_quant, quant.int8_matmul = rq.row_quant_plain, mm.int8_matmul_plain
    try:
        return fn()
    finally:
        quant.row_quant, quant.int8_matmul = saved


def check_switchback_kernels() -> dict:
    """Phase 23 (c): the fused SwitchBack FFN op at full width (one chunk of 7,744 rows, D 2048, F 16384) through
    K5 and K4b and through their plain versions, on the card; K5 and K4b at SigLIP's shapes against their plain
    versions, timed beside the bound (and K4b beside ``torch._int_mm`` + scaling)."""
    from kai0_tpu_torch.ops import int8_matmul as mm
    from kai0_tpu_torch.ops import quant
    from kai0_tpu_torch.ops import row_quant as rq

    gen = torch.Generator(device="cuda").manual_seed(23)
    bf16 = torch.bfloat16
    m, d, f = INT8_CHUNK_ROWS, 2048, 16384
    _check(len(quant._row_chunks(m, f)) == 1, "the chunk of 7,744 rows is not one chunk")
    x = torch.randn(m, d, generator=gen, device="cuda").to(bf16)
    dy = torch.randn(m, d, generator=gen, device="cuda").to(bf16)
    weights = [(torch.randn(*shape, generator=gen, device="cuda") * 0.02).to(bf16) for shape in ((f, d), (f, d), (d, f))]

    def run():
        xs = x.clone().requires_grad_()
        ws = [w.clone().requires_grad_() for w in weights]
        y = quant.sb_fused_ffn(xs, *ws)
        y.backward(dy)
        torch.cuda.synchronize()
        return y.detach(), xs.grad, [w.grad for w in ws]

    t = time.perf_counter()
    y, dx, dws = run()
    kernel_s = time.perf_counter() - t
    y_p, dx_p, dws_p = _with_plain_kernels(run)
    _check(torch.equal(y, y_p) and torch.equal(dx, dx_p), "the fused SwitchBack FFN: forward or dx differs from the "
           "plain versions'")
    worst = max(float((a.float() - b.float()).abs().max() / b.float().abs().max()) for a, b in zip(dws, dws_p))
    print(f"switchback fused FFN [{m}, {d}] x F {f} bf16: forward and dx bit-equal with K5 and K4b and with their plain "
          f"versions on the card; dW of gate, up, down within {worst:.3e} x max (limit one bf16 step, 2^-8); the "
          f"kernels' forward + backward {kernel_s * 1000:.1f} ms (first call)")
    _check(worst <= 2.0**-8, f"the fused SwitchBack FFN's weight gradients: {worst}")
    del y, dx, dws, y_p, dx_p, dws_p

    shapes = {}
    for label, rows in SIGLIP_ROWS.items():
        for site, (k, n) in SIGLIP_SHAPES.items():
            shapes[f"{site} M={rows}"] = (rows, k, n)
    for site, (k, n) in {"gate/up": (2048, 16384), "down": (16384, 2048)}.items():
        shapes[f"weight codes {site}"] = (None, k, n)
    record = {}
    for label, (rows, k, n) in shapes.items():
        w = (torch.randn(n, k, generator=gen, device="cuda") * 0.02).to(bf16)
        wq, ws = rq.row_quant(w)
        ref_q, ref_s = rq.row_quant_plain(w)
        _check(torch.equal(wq, ref_q) and torch.equal(ws, ref_s), f"row_quant of the weight [{n},{k}]: not bit-equal")
        if rows is None:  # a weight's per-call codes
            ms, plain_ms = _cuda_ms(lambda: rq.row_quant(w), runs=10), _cuda_ms(lambda: rq.row_quant_plain(w), runs=10)
            bound_ms = _nbytes(w, wq, ws) / HBM_BYTES_PER_S * 1e3
            print(f"kernel row_quant of a weight [{n},{k}] bf16 ({label}): bit-equal; kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} (bytes)")
            record[label] = {"row_quant": (ms, plain_ms, bound_ms)}
            continue
        a = (torch.randn(rows, k, generator=gen, device="cuda") * 3).to(bf16)
        aq, sa = rq.row_quant(a)
        ref_q, ref_s = rq.row_quant_plain(a)
        _check(torch.equal(aq, ref_q) and torch.equal(sa, ref_s), f"row_quant [{rows},{k}]: not bit-equal")
        y = mm.int8_matmul(aq, wq, sa, ws.view(-1), nt=True, out_dtype=bf16)
        y_p = mm.int8_matmul_plain(aq, wq, sa, ws.view(-1), nt=True, out_dtype=bf16)
        g = (torch.randn(rows, n, generator=gen, device="cuda")).to(bf16)
        gq, sg = rq.row_quant(g, col_scale=ws.view(-1))
        dx = mm.int8_matmul(gq, wq, sg, None, nt=False, out_dtype=bf16)
        dx_p = mm.int8_matmul_plain(gq, wq, sg, None, nt=False, out_dtype=bf16)
        torch.cuda.synchronize()
        _check(torch.equal(y, y_p) and torch.equal(dx, dx_p), f"int8_matmul at SigLIP's {label}: not bit-equal")
        library = lambda: (torch._int_mm(aq, wq.T).to(torch.float32) * sa * ws.view(-1)).to(bf16)  # noqa: E731
        _check(torch.equal(library(), y), f"int8_matmul at SigLIP's {label}: library yardstick differs")
        ms = _cuda_ms(lambda: mm.int8_matmul(aq, wq, sa, ws.view(-1), nt=True, out_dtype=bf16), runs=10)
        plain_ms = _cuda_ms(lambda: mm.int8_matmul_plain(aq, wq, sa, ws.view(-1), nt=True, out_dtype=bf16), runs=3)
        lib_ms = _cuda_ms(library, runs=10)
        bound_ms, bound_by = _int8_bound(rows, n, k, _nbytes(aq, wq, sa, ws, y))
        rq_ms = _cuda_ms(lambda: rq.row_quant(a), runs=10)
        rq_bound = _nbytes(a, aq, sa) / HBM_BYTES_PER_S * 1e3
        print(f"kernel int8_matmul at SigLIP's {label} (K={k}, N={n}, nt and the dx): bit-equal; kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} int_mm_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}); row_quant "
              f"[{rows},{k}] kernel_ms={rq_ms:.4f} bound_ms={rq_bound:.4f} (bytes)")
        record[label] = {"int8_matmul": (ms, plain_ms, bound_ms, lib_ms), "row_quant": (rq_ms, None, rq_bound)}
    return record


def _serve_int8_mode(cfg, ckpt: str, label: str, knob_values: dict, requests: list, noise) -> dict:
    """One ``create_trained_policy(quantize=True)`` with the config's knobs set; ``INT8_MODES_REQUESTS`` requests,
    the first capturing the graph with the counts at 0 just before. Returns the capture's launches, the actions and
    the times."""
    from kai0_tpu_torch import knobs
    from kai0_tpu_torch.ops import quant
    from kai0_tpu_torch.policies import policy_config

    cfg = dataclasses.replace(cfg, knobs=knobs.Knobs(**knob_values))
    t = time.perf_counter()
    policy = policy_config.create_trained_policy(cfg, ckpt, prompt_buckets=ENTRY_BUCKETS, quantize=True)
    torch.cuda.synchronize()
    holders = [m for m in policy.model.modules() if quant.is_quant(m)]
    load_s = time.perf_counter() - t
    _reset_launches()
    walls, infer_ms, actions = [], [], []
    for obs in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = policy.infer(obs, noise=noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1000)
        infer_ms.append(out["policy_timing"]["infer_ms"])
        a = out["actions"]
        _check(a.shape == (50, 14) and np.isfinite(a).all(), f"{label}: actions {a.shape}")
        actions.append(a)
    (graph,) = policy.graphs.values()
    capture = {k: v for k, v in graph.capture_launches.items() if v}
    served = {k: v for k, v in _read_launches().items() if v}
    _check(served == {k: 2 * v for k, v in capture.items()}, f"{label}: launches {served}, capture {capture}")
    print(f"int8 modes {label}: create_trained_policy(quantize=True, knobs={knob_values}) in {load_s:.2f}s, "
          f"{len(holders)} int8 holders (weight-only: {sum(m.weight_only for m in holders)}); {len(requests)} raw "
          f"Agilex requests, the first capturing its graph: wall_ms {_percentiles(walls[1:])}, infer_ms "
          f"{_percentiles(infer_ms[1:])} (requests 1-{len(requests) - 1}); launches of the capture {capture}")
    del policy
    torch.cuda.empty_cache()
    return {"capture": capture, "actions": actions, "walls": walls, "infer_ms": infer_ms, "holders": len(holders)}


def serve_int8_modes(cfg, ckpt: str, entry: dict) -> dict:
    """Phase 23 (d): weight-only int8 and SigLIP + Gemma int8 through ``create_trained_policy`` on phase 14's
    checkpoint and requests, against phase 14's bf16 and int8 policies of this call."""
    requests, noise = entry["bf16"]["requests"][:INT8_MODES_REQUESTS], entry["bf16"]["noise"]
    modes = {"weight-only": {"int8_weight_only": True}, "siglip + gemma": {"int8_siglip": "all"}}
    out = {label: _serve_int8_mode(cfg, ckpt, label, values, requests, noise) for label, values in modes.items()}
    bf16, int8 = entry["bf16"], entry["int8"]
    gemma_only = int8["capture"]
    wo, sig = out["weight-only"]["capture"], out["siglip + gemma"]["capture"]
    _check(not any(wo.get(k) for k in ("row_quant", "row_quant_colscale", "int8_matmul", "int8_matmul_lora")),
           f"weight-only: K5 or K4b launched in the forward: {wo}")
    extra = 27 * 6 + 1  # SigLIP's q, k, v, out, fc1, fc2 in 27 layers and the head: K5 on x and one K4b each
    _check(sig.get("row_quant") == gemma_only["row_quant"] + extra and sig.get("int8_matmul") == gemma_only["int8_matmul"]
           + extra, f"siglip + gemma int8: launches {sig} against Gemma-only int8's {gemma_only}")
    for label, rec in out.items():
        diff = max(float(np.abs(a - b).max()) for a, b in zip(rec["actions"], bf16["actions"], strict=False))
        ref = float(np.abs(bf16["actions"][0]).max())
        print(f"int8 modes {label}: actions against phase 14's bf16 policy on the same requests and noise: "
              f"max_abs_diff={diff:.4e} (|actions| max {ref:.3f}; int8 serving bound 0.5 x max, phase 11)")
        _check(0 < diff < 0.5 * ref, f"{label}: actions against bf16 {diff}")
    print("int8 modes: infer_ms p50 / p90 (requests 1-), same call: " + "; ".join(
        f"{label} {np.percentile(r['infer_ms'][1:], 50):.2f} / {np.percentile(r['infer_ms'][1:], 90):.2f}"
        for label, r in (("bf16 (phase 14)", bf16), ("gemma int8 (phase 14)", int8), *out.items())))
    return {label: rec["capture"] for label, rec in out.items()}


def timed(label: str, fn, *args):
    start = time.perf_counter()
    out = fn(*args)
    print(f"phase time: {label} {time.perf_counter() - start:.1f}s")
    return out


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

    timed("3 kernels", check_kernels)
    rtc_record = timed("3 rtc backward", check_rtc_backward)
    serve_launches, served = timed("4 serve", serve)
    int8_serve_launches = timed("11 serve int8", serve_int8, served)
    del served
    timed("5 full-width reference", full_width_reference)
    record = timed("6 attention training", check_attention_training)
    record.update(timed("7 adam_q8", check_adam_q8))
    record.update(timed("10 int8 kernels", check_int8_kernels))
    record["flash_mha_bwd"].update(rtc_record["flash_mha_bwd"])
    timed("8 model gradients", check_model_gradients)
    timed("12 lora int8 gradients", check_lora_int8_gradients)
    launches, phase9_losses, phase9_ms = timed("9 train", train, "full")
    int8_launches, _, _ = timed("13 train lora int8", train, "lora_int8")
    switchback = timed("23 (a)-(c) switchback training", switchback_training,
                       {"loss0": phase9_losses[0], "median_ms": phase9_ms})
    entry_launches = timed("14-17 serve entry", serve_entry)
    train_entry_launches = timed("18 train entry", train_entry)
    advantage_launches = timed("19 stage advantage", stage_advantage)
    families = timed("20 pi0 and fast", pi0_and_fast)
    for name, numbers in families["records"].items():
        record[name].update(numbers)
    arithmetic = timed("21 model arithmetic", model_arithmetic)
    for name, numbers in arithmetic["records"].items():
        record[name].update(numbers)
    aligned_launches = timed("22 train-deploy alignment", train_deploy_alignment)

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
        # launches_serving: the capture of the graph phase 4's requests replayed (phase 11's for the int8 kernels);
        # launches_serving_entry: the same in phase 14 (the int8 policy's for the int8 kernels). Each is counted from 0
        # set just before the requests; phases 11 and 14 hold a profiled replay's kernels to these counts
        if name in ("flash_mha", "flash_mhsa"):
            _check(min(serve_launches[name], int8_launches[name], entry_launches["bf16"][name]) > 0,
                   f"{name} was not launched on every path")
            entry["launches_serving"] = serve_launches[name]
            entry["launches_serving_entry"] = entry_launches["bf16"][name]
        if name in ("row_quant", "int8_matmul"):
            _check(min(int8_serve_launches[name], entry_launches["int8"][name]) > 0,
                   f"{name} was not launched on the int8 serving paths")
            entry["launches_serving"] = int8_serve_launches[name]
            entry["launches_serving_entry"] = entry_launches["int8"][name]
        # launches_serving_rtc: one guided request of phase 15 (its graph's capture; the int8 policy's for the int8
        # kernels); launches_serving_b8 / _b4: one batch of 8 (bf16) / 4 (int8) of phase 16, its graph's capture.
        # Each phase set the counts to 0 just before its requests and held the counts after them to its captures.
        rtc = entry_launches["rtc_int8" if name in int8_kernels else "rtc_bf16"]
        if name in ("flash_mha", "flash_mha_bwd", "flash_mhsa", "row_quant", "row_quant_colscale", "int8_matmul"):
            _check(rtc.get(name, 0) > 0, f"{name} was not launched on the RTC serving path")
            entry["launches_serving_rtc"] = rtc[name]
        if name in ("flash_mha", "flash_mhsa"):
            _check(entry_launches["b8"][name] > 0, f"{name} was not launched by a batch of 8")
            entry["launches_serving_b8"] = entry_launches["b8"][name]
        if name in ("row_quant", "int8_matmul"):
            _check(entry_launches["b4_int8"][name] > 0, f"{name} was not launched by an int8 batch of 4")
            entry["launches_serving_b4"] = entry_launches["b4_int8"][name]
        # launches_train_entry: the 4 steps of phase 18's first run through train_lib.main (the LoRA + int8 run's,
        # depth 2, batch 2, for the int8 kernels), counted from 0 set just before main.
        entry_train = train_entry_launches["lora_int8" if name in int8_kernels else "full"]
        _check(entry_train[name] > 0, f"{name} was not launched on the training entry path")
        entry["launches_train_entry"] = entry_train[name]
        # launches_advantage_train: phase 19's 4 estimator steps through train_lib.main; launches_advantage_eval: its
        # 2-timestep evaluation of one episode (6 forwards at batch 160); each counted from 0 set just before.
        if name in ("flash_mha", "flash_mha_bwd", "flash_mhsa", "flash_mhsa_bwd", "adam_q8"):
            _check(advantage_launches["train"][name] > 0, f"{name} was not launched by the estimator's training")
            entry["launches_advantage_train"] = advantage_launches["train"][name]
        if name in ("flash_mha", "flash_mhsa"):
            _check(advantage_launches["eval"][name] > 0, f"{name} was not launched by the estimator's evaluation")
            entry["launches_advantage_eval"] = advantage_launches["eval"][name]
        # launches_pi0_serving / launches_fast_serving: phase 20's π₀ request (its graph's capture) and one π₀-FAST
        # request (eager: the prefill and every decode step); launches_pi0_train / launches_fast_train: the 3 steps of
        # each train_lib.main run. Each counted from 0 set just before.
        for path in ("pi0_serving", "fast_serving", "pi0_train", "fast_train"):
            if name in ("flash_mha", "flash_mhsa") or (path.endswith("train") and name in (
                    "flash_mha_bwd", "flash_mhsa_bwd", "adam_q8")):
                _check(families[path].get(name, 0) > 0, f"{name} was not launched by phase 20's {path}")
                entry[f"launches_{path}"] = families[path][name]
        # launches_arithmetic: phase 21's mixing script (gradient descent, 3 iterations of 4 batches of 8), counted from
        # 0 set just before; launches_arithmetic_gd_iteration / _loss: one iteration and one loss evaluation of its
        # Ensemble (K3, K4 and K5 none: the path has no optimizer step and no int8).
        if name.startswith("flash_"):
            _check(arithmetic["launches"][name] > 0, f"{name} was not launched by phase 21's mixing script")
            entry["launches_arithmetic"] = arithmetic["launches"][name]
        entry["launches_arithmetic_gd_iteration"] = arithmetic["gd_iteration"][name]
        entry["launches_arithmetic_loss"] = arithmetic["loss"][name]
        # launches_aligned_train: phase 22's 4 steps of train_lib.main through the mirror and time-scale views,
        # counted from 0 set just before main (K4, K5: 0, the path has no int8).
        if name in ("flash_mha", "flash_mha_bwd", "flash_mhsa", "flash_mhsa_bwd", "adam_q8"):
            _check(aligned_launches[name] > 0, f"{name} was not launched by phase 22's training")
        entry["launches_aligned_train"] = aligned_launches[name]
        # launches_sb_train: one step of phase 23 (a)'s SwitchBack full fine-tune; launches_serving_siglip_int8: the
        # capture of phase 23 (d)'s SigLIP + Gemma int8 request; each counted from 0 set just before.
        if name in ("row_quant", "row_quant_colscale", "int8_matmul"):
            entry["launches_sb_train"] = switchback["ffn"]["launches"][name]
            entry["launches_serving_siglip_int8"] = entry_launches["int8_modes"]["siglip + gemma"].get(name, 0)
            _check(entry["launches_sb_train"] > 0, f"{name} was not launched by the SwitchBack full fine-tune")
            _check(name == "row_quant_colscale" or entry["launches_serving_siglip_int8"] > 0,
                   f"{name} was not launched by SigLIP + Gemma int8 serving")
        # launches_serving_5step: phase 14's request at sample_kwargs={"num_steps": 5} (its graph's capture);
        # launches_serving_rtc_guidance5: phase 15's guided request at max_guidance_weight=5.0 (its graph's capture);
        # launches_fast_int8_serving: phase 20's int8 π₀-FAST request (eager: the prefill and every decode step);
        # launches_client_<mode>: each of phase 24's client modes against the server (its graphs' captures). Each
        # counted from 0 set just before.
        if name in ("flash_mha", "flash_mhsa"):
            entry["launches_serving_5step"] = entry_launches["bf16_5step"][name]
        if name in ("flash_mha", "flash_mha_bwd", "flash_mhsa"):
            entry["launches_serving_rtc_guidance5"] = entry_launches["rtc_bf16_guidance5"][name]
        if name in ("flash_mha", "flash_mhsa", "row_quant", "int8_matmul"):
            _check(families["fast_int8_serving"].get(name, 0) > 0, f"{name} was not launched by int8 FAST serving")
            entry["launches_fast_int8_serving"] = families["fast_int8_serving"][name]
        for mode, counts in entry_launches["client"].items():
            if name in ("flash_mha", "flash_mhsa") or (name, mode) == ("flash_mha_bwd", "rtc"):
                _check(counts.get(name, 0) > 0, f"{name} was not launched by the client's {mode} mode")
                entry[f"launches_client_{mode}"] = counts[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
