#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``veles_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each printing JSON lines; any failure ends the run non-zero:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — compiles every kernel source in ``veles_torch/csrc`` with
   nvcc for sm_90a, all at once, and reports the seconds and each
   kernel's registers and spilled bytes (ptxas; the full reports go to
   ``nvcc_<source>.log`` in the output directory of phase 7); where
   ``cuobjdump`` exists, the count of ``HGMMA`` (wgmma) and ``UTMALDG``
   (TMA load) instructions in each kernel of the bf16 forward
   (``flash_fwd_sm90.cu``), fused backward and dk/dv kernel
   (``flash_bwd_sm90.cu``) and dq kernel (``flash_dq_sm90.cu``), failing
   if one has none of either;
3. kernels — holds the bias-gradient kernel against its plain PyTorch
   version on the card: every activation, float32 and bfloat16 inputs,
   at the MNIST shapes and two large ones; ``linear`` and ``tanh`` at the
   110M LM step's shapes (``LM_SHAPES``) in the dtype the LM gives each,
   and the stacked 110M's f32 qkv bias sum (``STACK_SHAPES``);
   ``relu`` (softplus) in bf16 at the conv path's shapes (``CONV_SHAPES``:
   AlexNet's five conv GD views and FC layers at minibatch 128, CIFAR-10's
   two at minibatch 100), timed beside ``err.sum(0, dtype=float32)``;
   ``tanh`` in f32 and bf16 at the autoencoders' (``AE_SHAPES``), timed
   in both.
   The tolerance per column is ``1e-4·Σ_n|dz[n,k]|`` against the plain
   math in float64 and against the plain version (f32 sums taken in
   another order); two launches must
   agree bitwise. Times the kernel, its plain version and, for the
   identity form, the one PyTorch call that computes it, with the L2
   cache flushed before every launch, beside the least time the card
   could take, at every shape;
4. flash_kernels — the five flash-attention kernels (forward and
   pipelined forward: for bf16 the wgmma + TMA kernel of
   ``flash_fwd_sm90.cu``, for f32 the scalar one; fused backward: for bf16
   the wgmma + TMA kernel of ``flash_bwd_sm90.cu``, for f32 the chunked
   one; and the two-kernel backward's dq and dk/dv kernels: for bf16 the
   wgmma + TMA kernel of ``flash_dq_sm90.cu`` and that of
   ``flash_bwd_sm90.cu`` without dq, for f32 the scalar ones) and their
   plain versions against the
   float64 math from the same inputs, f32 and bf16, causal and not, at
   (B, H, S, dh) = (64, 4, 32, 16) (the LM sample), (8, 12, 512, 64)
   (the 110M row), (2, 3, 200, 64) (ragged S), (4, 4, 256, 32) and
   (2, 3, 200, 128) (the other head dims, the second ragged) and
   (4, 12, 8192, 64) (the 110M_s8k shape). Every element of out, dq, dk
   and dv is held to
   its own size and its row's (``scaled_err``: |got − ref| ≤ tol·(|ref|
   + rms of the row) + ATOL_SHARE·max|ref|, a row per (b, h, query) or
   (b, h, key)), since causal rows shrink with their position and a
   tensor-wide scale would leave the later rows' work unchecked; tol
   (``FLASH_TOL``) comes from the sound readings on the card; lse within
   1e-3; the bf16-accumulated forward, pipelined or not, to
   ``FLASH_ACC_BF16_TOL``. Kernel and plain version must agree with each
   other to ``FLASH_VS_PLAIN_TOL``, and two launches bitwise; the two-kernel
   backward (``fused=False``) also agrees with the fused kernel to
   ``FLASH_VS_PLAIN_TOL``, in bf16 its dk and dv bit for bit (one
   kernel, with and without dq; in f32 two kernels that sum in other
   orders), and a hoisted delta changes no bit of it;
5. flash_kernel_times — at the 110M and 110M_s8k shapes, bf16, causal:
   kernel, plain version and ``F.scaled_dot_product_attention`` (its
   autograd backward for the backward, and for the two-kernel pair: no
   one PyTorch call computes dq alone or dk/dv alone), L2 flushed,
   beside the bound; then the fused backward and the pair in turns
   (fused, pair, pair, fused): the A/B of the two backward forms;
6. mnist   — trains the MNIST sample through the CLI entry point at its
   full width (784-100-10, minibatch 100, 6000/1000 samples), 3 epochs
   at seed 1337 on ``cuda`` and on ``cpu``. The bias-gradient kernel must
   have launched twice per train step (once per GD unit); the final
   validation error must be below 0.15 and within 0.02 of the CPU run;
7. profile — one more MNIST epoch under ``torch.profiler``: the
   device's busy time and idle share, launches per step, the top
   device operations, the bias-gradient kernel's device launches and
   time by dtype, read from the trace by kernel name — one device launch
   per call, or the run fails (trace in
   ``chiprun_out/mnist_epoch_trace.json``);
8. lm      — the transformer LM through the CLI entry point with
   ``attn_impl=pallas`` at seed 1337: (a) the sample's width on cuda
   and cpu for its 8 epochs — the validation loss must fall and end
   within ``LM_CPU_TOLERANCE`` of the CPU run's; (b) the same on cuda
   with ``attn_pipeline=True`` and with ``attn_acc="bf16"``; (c) the
   full-width 110M row (dim 768, 12 heads, 12 layers, ffn 3072, vocab
   16384, S 512, minibatch 8; 64/16 samples, 2 epochs) on cuda: every
   parameter finite and the train loss falling (16 steps on a
   16384-token vocabulary need not lower the validation loss yet),
   tokens/s and step ms. Every run counts the launches from 0:
   forward = layers × (train + eval steps), fused backward = layers ×
   train steps, pipelined = the forward count in the pipelined run and
   0 elsewhere, the two-kernel backward's kernels 0 (the LM takes the
   fused backward, as the reference's does), and the bias-gradient
   kernel's identity form (layers·6 + 1) per train step;
   flash_bwd_two_kernel — on each of the 110M run's 12 attention units'
   forward cache (q, k, v, out, lse; bf16 (8, 12, 512, 64)) with a dout
   from a seeded generator, the fused and the two-kernel backward
   (``flash_attention_bwd(fused=False)``) agree to
   ``FLASH_VS_PLAIN_TOL`` and their dk and dv bit for bit; counted from
   0: 12 launches each of the fused, dq and dk/dv kernels;
9. lm_profile — one full-width 110M train step under
   ``torch.profiler``: device busy time, idle share, top device
   operations, the flash kernels' share, and the bias-gradient kernel's
   device time and launches by dtype, one device launch per call (trace
   ``lm_step_trace.json`` in the output directory of phase 7);
10. cifar   — the CIFAR-10 sample through the CLI at its full width
    (conv 32 and 64 kernels of 5×5, max pools, softmax) with the
    reference test's data and settings (``CIFAR_RUN``: 600/200 images,
    minibatch 50, 3 epochs, lr 0.01, moment 0.5, seed 2024) on the
    port's CPU and on the card: the card's final validation error below
    0.55 and within 0.08 of the CPU's; the bias-gradient kernel exactly
    2 masked + 1 identity launches per train step, no flash launch;
11. alexnet_parity — one AlexNet train step at full geometry (227×227,
    every width), minibatch 8, dropout 0, in f32 (``compute_dtype = amp
    = float32``) on the card and on the port's CPU from the same
    weights and minibatch: every parameter and velocity within
    ``ALEXNET_PARITY_RTOL`` of its largest element;
12. alexnet — the AlexNet sample through the CLI at full width under the
    bf16 policy (``ALEXNET_RUN``: minibatch 128, 1024/256 images of the
    synthetic bank, 2 epochs, dropout 0.5): every parameter finite, the
    last train loss below 1.5 times the first (the reference's bar), the
    bias-gradient kernel exactly 7 masked + 1 identity launches per
    train step; images/s over the warm epoch; alexnet_profile — one
    train step under ``torch.profiler`` (busy, idle share, device
    operations, top operations, the bias gradient's device launches and
    ms; trace ``alexnet_step_trace.json``);
13. ae, video_ae — the MnistAE and VideoAE samples through the CLI at
    the reference's own configuration (``AE_RUNS``: MnistAE 2000/500
    images, minibatch 100, 4 epochs; VideoAE 40 clips × 16 frames of
    24×24, minibatch 50, 5 epochs; seed 1337) on the port's CPU and on
    the card: the validation MSE falls on both and the card's last lies
    within max(0.15·mse, 1e-3) of the CPU's (the reference's bound,
    tests/test_mnist_ae.py); exactly one masked bias-gradient launch per
    train step (the conv_tanh GD at (57600, 9) and (20000, 8)) and no
    other kernel; one f32 step on the card and the CPU from the same
    weights, every parameter and velocity within ``AE_PARITY_RTOL`` of
    its largest element; one bf16 step under ``torch.profiler`` (phases
    ``ae_profile``, ``video_ae_profile``; traces ``<phase>_step_trace.
    json``); ae_units — Deconv/GDDeconv (strided, unequal padding) and
    Depooling/GDDepooling (overlapping windows, cropped output) on the
    card in f32 with TF32 off, within ``AE_UNIT_RTOL`` of the CPU and
    bitwise equal on two launches;
14. serve_predict — the MNIST, AlexNet and MnistAE workflows of phases
    6, 12 and 13 exported (``export_inference``), loaded by
    ``ArchiveModel`` on the card, every bucket of an
    ``InferenceEngine(max_batch=64)`` (1 to 64 rows) against the port's
    training forward in eval mode with the f32 policy on the same rows,
    the CPU ``ArchiveModel`` (all 64 MNIST and MnistAE rows, 2 AlexNet
    rows) and the bucket without pad rows, each within
    ``SERVE_RTOL`` of the largest output; ms by the host clock and rows/s
    per bucket; a ``MicroBatcher`` under ``SERVE_CLIENTS`` concurrent
    client threads (its batch fill and latencies); no hand-written kernel
    may launch (counts from 0 just before);
15. serve_decode — (a) the LM sample of phase 8 exported and decoded
    greedily by ``GenerativeEngine`` + ``ContinuousBatcher`` (8 slots) on
    the card and on the CPU, two concurrent prompts of different
    lengths, equal token for token to the port's ``generate()`` on the
    card, the slots all free after; (b) the 110M LM of phase 8 at full
    width and depth exported and decoded with ``DECODE_SLOTS`` slots of
    ``DECODE_MAX_LEN`` positions: the first decode step's logits within
    ``LOGIT_RTOL`` of a full forward over prompt + token, greedy tokens
    equal to ``generate()``'s except where the top-two gap is within
    ``LOGIT_RTOL`` (a near tie; the positions reported), tokens/s with
    ``DECODE_REQUESTS`` requests of 64–256 prompt tokens and
    ``DECODE_NEW`` new tokens submitted at once and one at a time,
    first-token latency,
    the step's ms (and three steps under ``torch.profiler``: device busy
    and idle share, operations per step; traces
    ``decode_step_trace_<mode>.json``), a warm prefill's ms at 64 and 256
    tokens, the pool's bytes and the peak device memory; (c) the
    same with int8 and fp8 weights at rest: their bytes, tokens/s, the
    post-softmax outputs within ``QUANT_PROB_ATOL`` of f32 along the f32
    greedy chain and the greedy tokens equal along its strong-margin
    prefix (the reference's bounds); no hand-written kernel may launch;
16. lm_adam — the 110M row as bench.py configures it (``attn_block``
    256 and no ``attn_impl``: the auto policy, which resolves to the
    kernels at S 512 on the card) under AdamW and a warmup-cosine
    schedule (``ADAM_RUN``) through the CLI: launches as the resolved
    mode implies (rows 2, 3 and 5), every parameter and solver tensor
    finite, the train loss falls, and the validation loss in a run at the
    sample's width (``SAMPLE_ADAM_RUN``: S 32, the scan); two steps under
    ``accumulate_gradient=2`` (no parameter moves on the first, every one
    on the second); one f32 AdamW step of a small LM on the card against
    the port's CPU within ``LM_PARITY_RTOL``; the step's time split beside
    the momentum 110M's (``lm_adam_step_trace.json``,
    ``lm_momentum_step_trace.json``);
17. attn_policy — the scan against the kernels on one bf16 input
    (FLASH_MAIN) within the bf16 bound of phase 4; the train step of the
    110M widths at ``POLICY_LAYERS`` layers by the host clock with the
    scan and with the kernels, in turns, at each
    ``POLICY_SHAPES`` entry; the threshold the table implies beside
    ``MultiHeadAttention.PALLAS_AUTO_MIN_S``;
18. lm_stack — the stacked 110M (one ``transformer_stack`` unit of 12
    blocks, dense attention) under AdamW through the CLI with remat off
    and on (the train loss falls, 6 identity launches a block + 1 a step,
    no flash kernel; the validation loss in a stacked run with remat at
    the sample's width); one step with remat bit for bit equal to one
    without, each step's peak device memory and ms; the archive served
    and decoded greedily against ``generate()`` but at near ties;
19. text_lm — the README's text-LM command (SURVEY.md as the corpus,
    AdamW, warmup-cosine, ``--generate-text``) on the CPU and the card:
    the final validation losses within ``LM_CPU_TOLERANCE``; the card's
    greedy text equal to the CPU's decode of the card's weights but at
    near ties;
20. moe — the MoE LM at the 110M width, 4 layers, 8 experts
    (``LM_110M_MOE``) under AdamW: the validation loss falls, the tokens
    each layer drops in a step; a small MoE LM's drops equal on the card
    and the CPU (f32); the archive served within ``SERVE_RTOL`` of the
    f32 training forward;
21. resume — (a) the 110M row as phase lm_adam runs it, at 2 of its 12
    layers (``RESUME_RUN``: ``LM_110M`` + ``ADAM_RUN``, 64/16 sequences, 2
    epochs) through the CLI:
    run A, 2 epochs in one go; run B with ``--snapshots DIR`` as a user
    runs it (the improvement-gated ``gz`` checkpoint at epoch 0's
    valid/train boundary, the epoch-entry clone at each train class,
    each clone's ms and bytes), preempted by a SIGTERM
    ``PREEMPT_B_AFTER`` train steps into epoch 1's train class: it must
    exit 75 with a ``current`` checkpoint of epoch 1's entry; then a fresh
    process (the CLI with ``--snapshots DIR --snapshot auto``) restarts
    epoch 1 from it and writes its final state. Every parameter and
    solver tensor of A and B must be equal bit for bit, and so must
    their decisions (history, best metric, epochs since the best). The
    checkpoint's bytes and its write and read seconds, for ``gz`` (run
    B's own writes) and ``""`` (the same state written again, equal
    array for array). (b) MNIST preemption through the CLI on the card
    in a child process (``PREEMPT_RUN``): a SIGTERM once the first
    ``_current-`` checkpoint exists; the process must exit 75 and leave
    checkpoints that verify; ``--snapshot auto`` then completes an epoch
    (in this process: rows 1 and 2 counted).
    (c) ``--profile-dir`` around a short 110M run (``PROFILE_RUN``): the
    trace must hold the flash forward and backward kernels and the
    bias-gradient kernel by name. (d) ``ArchiveModel.load_checkpoint``:
    run A's 110M archive refreshed from run B's preemption checkpoint,
    its logits within ``SERVE_RTOL`` of the f32 training forward of run B
    restored to that checkpoint, on a minibatch. Launches are counted
    from 0 in every run of the phase (the child's read in the child) and
    must be what each run implies;
22. model_health — the model-health plane on the card, each run under
    a fresh monitor of the port: (a) MNIST (3 epochs, seed 1337) through
    the launcher with the layer stats at stride 1 and 8, on the card and on
    the CPU: the same (step index, layers) sequence, every norm within
    ``HEALTH_MNIST_RTOL`` of the CPU's, finite, update ratios in (0, 1),
    the verdict healthy, 2 bias-gradient launches a train step; the
    stride-8 card run's ImageSaver files (``SAVER_LIMIT`` an epoch, each
    the loader's sample). (b) the learning rate NaN on train step
    ``NAN_STEP`` with ``--rollback-on-divergence`` and a rollback: the
    verdict diverged on that step's stats with the reasons
    ``NAN_REASONS`` (the CPU's too), one rollback, the rates cut, healthy
    at the end; a checkpoint written meanwhile stamped diverged and
    passed over by ``resolve_auto``; ``--model-stats off`` stamps
    ``unknown``. (c) the 110M row at 4 of its layers (``HEALTH_LM``,
    momentum, the kernels)
    through the CLI with the stats off, at stride 8 and 1: the launches
    each run implies (the stats change none), the vectors finite; then in
    turns (``STATS_TURNS``) the step's host ms, and its device
    operations from the profiler. (d) the stride-8 MNIST archive through
    a ``MicroBatcher`` on the card: the monitor's entropy and margin equal
    the numpy formula on the sampled batch's outputs. (e) the eight
    activation pairs forward and backward at AlexNet conv1's output
    (``ACTIVATION_SHAPE``) in f32 and bf16 against the CPU
    (``ACTIVATION_TOL``). Also, at the 110M flash shape, SDPA's backward
    with its backend pinned (flash, then memory-efficient) beside phase
    flash_kernel_times;
23. unsupervised — the Kohonen SOM and the MnistRBM samples through the
    CLI at the reference's own configurations (8×8 map, 1000 points,
    minibatch 50, 20 epochs; 784 → 64, 2000/500 images, minibatch 100, 5
    epochs; seed 1337) on the port's CPU and on the card, with the
    model-health plane on (no stat unit on either path): the SOM's
    quantization error on the card below 0.3 and within
    ``KOHONEN_QE_TOL`` of the CPU's, its final weights within
    ``KOHONEN_CARD_ATOL`` of the CPU's largest; the RBM's validation error
    falling by 13% on both and the card's last within 35% of the CPU's
    (``RBM_FALL``, ``RBM_CROSS_RTOL``: the reference's bounds between its
    backends); each run's checkpoint restored by a fresh workflow on the
    other device bit for bit and trained one more epoch; no kernel
    launched; each sample's ms per epoch and one more epoch under
    ``torch.profiler`` (device operations per step, idle share; traces
    ``kohonen_epoch_trace.json``, ``rbm_epoch_trace.json``);
24. plots — phase mnist's run with the confusion matrix on
    (``PLOTS_RUN``) through the CLI with ``--graphics-dir``: the renderer
    process's ``plot_metric``, ``plot_weights`` and ``plot_confusion``
    PNGs and ``plots.json``, each PNG decoded (no plotting library) to a
    non-constant image; one bias-gradient launch of each form per train
    step, as phase mnist; ``WeightDiversity`` of the first layer against
    a float64 numpy recomputation from the exported weights
    (``DIVERSITY_ATOL``); the device operations of an epoch without and
    with the plotters in turns, the plotted ones ``PLOT_DEVICE_READS``
    more (the weights' and the confusion matrix's one copy each, after
    the classes); the Kohonen sample on the card through the launcher
    with a graphics server and its ``som_hits`` and ``som_umatrix``
    maps;
25. serve_http — the serving plane over HTTP: phase mnist's run through
    the CLI with ``--snapshots`` on an HTTP store (a stdlib server in
    this script; improvement-gated and rolling checkpoints, written by
    ``HTTPSnapshotStore``) and ``--export-inference``, one bias-gradient
    launch of each form per train step and no flash launch; then
    ``python -m veles_torch serve -d cuda`` in a child process with the
    MNIST archive (``--checkpoint`` the store's oldest checkpoint,
    ``--refresh-every 1``) and phase serve_decode's 110M archive
    (``DECODE_SLOTS`` × ``DECODE_MAX_LEN``): the newest checkpoint served
    as version 2; ``/readyz`` 200; ``SERVE_CLIENTS`` concurrent
    ``/v1/predict`` clients within ``SERVE_RTOL`` of an in-process engine
    on the same checkpoint, batch fill above 1; per bucket
    (``HTTP_BUCKETS``) p50/p99 latency and rows/s over HTTP and in
    process; a client's ``traceparent`` echoed and on the server's
    ``/debug/trace`` spans; greedy ``/v1/generate`` of the 110M streamed
    over a raw socket and not streamed, token for token equal to the
    in-process decode; ``DECODE_REQUESTS`` concurrent streams' tokens/s
    and first-token latency beside serve_decode's; a client leaving
    mid-stream frees its KV slot and is counted
    (``veles_serving_rejected_total{reason="disconnect"}``); a newer
    checkpoint stamped diverged skipped and counted while version 2
    serves on; ``/metrics`` exporting ``HTTP_FAMILIES``; the server
    stopped by SIGTERM and exiting 0 (its output in
    ``serve_http_server.log``);
26. ensemble — ``--ensemble 3`` of the full-width MNIST sample through the
    CLI (``ENSEMBLE_RUN``: 3 epochs, members from seeds 1337–1339): the
    report over the 1000 validation rows with 3 member errors, the
    ensemble's error no worse than its weakest member's, exactly one
    launch of each bias-gradient form a train step (3 × 180), no flash
    launch;
27. optimize — ``--optimize 2x4`` in this process (``OPTIMIZE_CONFIG``:
    both learning rates ``Tune(0.02, 0.005, 0.1)``; ``OPTIMIZE_RUN``: 2
    epochs, seed 1337): 8 evaluations, 960 launches of each form; then
    ``2x4x2``, the CLI's worker branch (``ProcessPoolMap`` of 2 spawned
    processes sharing the card, the kernels built once by this process
    before they start): the same best fitness, best values and champion
    history as in process, and each individual's seconds, launches and
    peak device memory read in the worker that ran it (``TimedTrainer``;
    ``optimize_workers.jsonl``), 960 launches of each form over the
    workers and none in this process;
28. shell_forge — the MNIST sample on the card through the launcher with
    a headless shell (``link_shell``) whose ``stop()`` ends the run at the
    first epoch's end: one epoch in the history, 60 launches of each form
    (no minibatch of the second epoch runs); that run's checkpoint and
    inference archive packaged and fetched back by the forge client, byte
    for byte, and the fetched checkpoint resumed on the card to a second
    epoch (60 more of each form, the first epoch's history kept);
29. profiling — the 110M LM as phase 8 runs it (16 train steps) under a
    fresh registry: ``veles_step_flops_total{kind="train"}`` equal to the
    step's counted signature costs (``perf.py``; a stats-due step and a
    plain one apart) over its train steps, the flash kernels' reported
    work a train step equal to ``FLASH_WORK``'s at ``FLASH_MAIN``,
    ``veles_step_mfu_ratio{kind="train"}`` in (0, 1] (printed with the
    FLOP/s, tokens/s and each train step's flops, bytes and precision),
    ``veles_device_memory_bytes{kind="peak_bytes_in_use"}`` equal to
    ``torch.cuda.max_memory_allocated()``, and the counting's price: a
    train minibatch timed plainly and counted in turns; then the
    full-width MNIST sample through the CLI with ``--web-status 0``, 3
    epochs, while it trains ``/debug/profile?seconds=2`` (speedscope, the
    main thread and the reactor named), ``/debug/critical_path`` (200)
    and ``python -m veles_torch top --once --json`` in a child process
    (the target ready, its RSS and device memory read); launches 240
    forward, 192 fused backward and 1168 identity for the LM, 180 of each
    bias-gradient form for MNIST (the counted minibatch is one of the
    run's own: no extra launch);
30. image_stream — a PNG tree written with the port's ``write_png`` under
    the output directory (``TREE_CLASSES`` × ``TREE_PER_CLASS``, every
    other image ``TREE_OTHER_SIZE`` so the resize runs; removed after
    the phase), the decode rate of one thread on it and on a Paeth-filtered
    copy of ``DECODE_TIMED`` images, then the AlexNet sample through the
    CLI at full width on that tree (``IMAGE_STREAM_RUN``: 2 epochs,
    1024/128 images, mb 128, 227 crop, bf16) in stream mode: the file
    loader and its split, 7 masked and 1 identity bias-gradient launches
    a train step, finite losses with the last below 1.5 × the first; the
    warm epoch's images/s, ``stream_wait_seconds``, the window size and
    the bytes uploaded; three windows uploaded back to back holding their
    own bytes (``uploads_in_flight``); and one f32 epoch through an
    ``ArrayStreamLoader`` against a ``FullBatchLoader`` and again (the
    resident bank's path) on the same uint8 images and weights, cuDNN
    deterministic, within ``STREAM_PARITY_RTOL`` (``stream_vs_resident``);
31. continual — ``CONTINUAL_ROUNDS`` continual rounds of the full-width
    MNIST through the launcher's ``continual`` branch (``--continual``)
    over a ``ContinualStreamLoader`` fed by ``HttpStreamSource`` from
    the port's ``stream_handler`` in this process: the rounds, cursor and
    launches (one of each form a train step), every checkpoint stamped
    with ``ingest_wall``, the trainer's staleness after each round, and a
    serving registry on the newest checkpoint publishing
    ``veles_staleness_seconds{point="serving:mnist"}``;
32. distributed — the elastic master/slave wire: (a) the full-width
    MNIST sample through the CLI, a master process (host weights, no
    CUDA: its result line says so) and two slave processes on the card,
    2 epochs under ``--grad-codec none`` and again under ``int8``: every
    job served and acknowledged, the slaves' summed masked and identity
    launches equal to the train jobs, the master's persisted weights
    finite and moved, int8's received bytes a job at most
    ``DIST_INT8_SHARE`` of none's; the two slaves of the first run build
    the bias-gradient library at once (its file removed first) and both
    load it; the per-job round trip p50, the slave's compute and the
    wire's share from the master's trace (``job.wire`` and the absorbed
    ``slave.*`` spans); one unshuffled slave in process against the
    standalone card run over the same order, within ``DIST_SEQ_RTOL`` of
    the largest weight; the update bytes a job of bf16 and top-k (one
    slave in process); and a run of ``DIST_KILL_EPOCHS`` where one slave
    is SIGKILLed (frozen first, and killed only while the master holds a
    job of it out) once the master served ``DIST_KILL_AFTER_JOBS`` jobs:
    it is dropped within ``--slave-timeout``, its job requeued, the run
    completes and ``faults`` shows the drop; (b) the
    110M LM's widths at 2 layers, one slave on the card, 4 jobs under
    bf16: the flash forward and fused backward launches the jobs imply,
    every ``PARAMS`` name of every GD unit in the job and the update, the
    master's weights finite; (c) ``--optimize 2x4 --listen-address`` with
    two ``--optimize slave`` processes on the card: 8 individuals, finite
    fitness, one launch of each form a train step in the slaves;
33. parallel — data, tensor and ring-sequence parallelism, 2 ranks on
    this one card spawned by the CLI over ``--transport gloo-host`` (NCCL
    refuses two ranks on one GPU: the collectives copy through the host,
    every kernel stays on the card; these are gloo-host times, not
    NCCL's, which one card cannot show; ``tools/parallel_nccl.py`` runs
    the same checks over NCCL, one rank per card). Each parallel run of
    the 110M row (``PARALLEL_110M``: ``PARALLEL_LAYERS`` (4) of its 12
    layers, 2 train and 1 valid minibatch of 8)
    is held against a one-process run of the same global minibatches on
    the card (``parallel_held``): every tensor's movement over the run
    (its inference archive, TP's shards gathered, less the seed's initial
    weights), the losses within ``PARALLEL_LOSS_RTOL``, each rank's flash
    and bias-gradient launches equal to that run's, and the collectives a
    train step. (a) ``root.lm.parallel.data=2`` in f32
    (``PARALLEL_F32``), movement within ``PARALLEL_DP_RTOL``, one gradient
    all-reduce a step of exactly the parameters' f32 bytes
    (``grad_sync_bytes``); (a') ``data=2`` under the default bf16 policy,
    movement within ``PARALLEL_BF16_RTOL``; (b) the 110M_s8k row
    (``PARALLEL_S8K``: B 4, S 8192, 6 of its 12 layers, 1 train and 1
    valid minibatch) with ``seq=2``: the per-shard S 4096 takes the
    kernels in the ring, rank 0 launching one causal forward and one
    causal fused backward a layer a step and rank 1 one causal and one
    non-causal of each; one MHA layer's ring (out, lse, dq, dk, dv at (4,
    12, 8192, 64), bf16) on 2 ranks against the single-card flash path
    (``FLASH_VS_PLAIN_TOL``) and the float64 math (``FLASH_TOL``, lse
    ``LSE_ATOL``) by ``scaled_err``; (c) ``model=2`` (6 heads a rank)
    under the bf16 policy, movement within ``PARALLEL_BF16_RTOL``, 4
    all-reduces a layer a step; (d) ``graft_entry.dryrun_multichip(2)`` on the
    card. Each rank's step time, collective bytes and host seconds;
34. parallel_ep_pp — expert and pipeline parallelism, 2 ranks on this
    card over gloo-host as phase parallel (``check_parallel_ep_pp``;
    ``tools/parallel_nccl.py`` runs it over NCCL, one rank per card). Each
    run is held as phase parallel's, in f32 (movement within
    ``PARALLEL_DP_RTOL``), against the one-process run of its config. (e)
    the 110M MoE as phase moe runs it (``PARALLEL_MOE``: 4 layers, 8
    experts, cf 2.0) under ``expert=2`` with gather routing: the tokens
    each layer dropped equal the one-process run's; with the all-to-all
    exchange at cf 8.0 (``PARALLEL_MOE_A2A``: no shard overflows its
    quota, so it must equal one process); each rank's flash and identity
    launches exact, the collectives a step (``ep_expected``). (f) the
    stacked 110M (``PARALLEL_STACK``: ``PARALLEL_LAYERS`` blocks) under
    ``pipe=2`` over
    ``PARALLEL_MICRO`` microbatches, GPipe and 1F1B: each stage's identity
    launches (6 a block a microbatch of its 2 blocks, and the token
    dense's, a train step), its chunk forwards (one a microbatch a step:
    1F1B folds the loss in), ``PARALLEL_MICRO`` hops and 2 all-reduces a
    step, and each stage's ``torch.cuda.max_memory_allocated`` under each
    schedule (1F1B's at most GPipe's);
35. parallel_unsupervised — the SOM and the MnistRBM at phase
    unsupervised's configs in f32 under ``data=2`` (2 ranks of this
    process's ``parallel.spawn`` over ``PARALLEL_TRANSPORT``, while the
    one-process runs go here): the SOM's weights within
    ``UNSUP_DP_ATOL`` of its largest, the RBM's binarize uniforms bit for
    bit and its errors within ``UNSUP_DP_RTOL``, 1 and 2 all-reduces a
    train step, each epoch's ms;
36. parallel_preempt — ``PREEMPT_PAR_RUN`` (the 110M widths at 2 layers,
    f32, momentum, ``data=2``) through the CLI: run A uninterrupted (a
    child process, beside B), run B signalled by its rank 0
    ``PREEMPT_B_AFTER`` train steps into epoch 1 (``PREEMPT_HOOK``): the
    spawner (this process) forwards the SIGTERM, every rank exits 75 and
    the CLI returns 75, one ``current`` checkpoint (uncompressed:
    ``PREEMPT_RAW``); B resumed by ``--snapshot auto`` in a fresh spawn:
    every tensor of the gathered archive and the history bit for bit;
    the seconds from the signal to exit 75;
37. parallel_cli — (1) the 110M at full width under ``data=2``, 2 train
    steps, then ``--generate`` (``PAR_GEN_RUN``) sampled at
    ``PAR_GEN_TEMPERATURE``: the tokens equal one process's decode of the
    gathered archive, and vary (``PAR_GEN_DISTINCT``); (2) ``--ensemble 2``
    and ``--optimize 1x2`` of the LM sample (``PAR_LM_SAMPLE``) under
    ``data=2`` against one process, within ``PAR_CLI_ERROR_ATOL`` and
    ``PARALLEL_LOSS_RTOL``; (3) a host master (``--listen-address``, no
    ranks, no CUDA) with a slave of 2 ranks, against one with a
    one-process slave: the masters' archives within ``PAR_SLAVE_ATOL``.
    The runs under ``data=2`` go in child processes side by side (their
    ranks wait on host copies), the one-process runs here;
38. image_jpeg — every fixture of ``tests/data/jpeg`` (Huffman,
    arithmetic-coded and lossless JPEG, a PNG) decoded by the native
    routines (``csrc/image_decode.cu``), and all but the tree images and
    one arithmetic-coded tree image by their Python twins: the JPEG
    coefficients (a lossless frame's samples) equal, the pixels (RGB, L,
    their 256×256 resizes) hashing to Pillow's digests
    (``digests.json``); the decode ms of a baseline 4:2:0, a progressive
    JPEG, their arithmetic-coded twins, a lossless JPEG and a Paeth PNG,
    native and twin; AlexNet at full width streamed 2 epochs from a tree
    of 16 classes of ``JPEG_COPIES`` copies of the tree fixtures, Huffman
    and arithmetic-coded in turn: 7 masked and 1 identity bias-gradient
    launches a train step, every scan decoded natively (the scans counted
    by routine and coding, arithmetic-coded ones among them), at
    ``JPEG_LR`` the train loss falling and the validation loss after one
    epoch below the untrained model's, the warm images/s;
39. capture_purity — the guard of the CUDA-graph capture to come: (a)
    ``python -m veles_torch lint --select tracer-purity --format json
    veles_torch`` in a subprocess exits 0 with ``[]``; a control
    (``.item()`` of a card tensor) must raise one sync warning; (b)
    MNIST (the sample's config, mb 100) and (c) the 110M widths at 2
    layers (``CAPTURE_LM``: S 512, mb 8, bf16, momentum, the auto
    attention policy) each take a warm train minibatch, then a train
    minibatch off the stats cadence and an eval minibatch under
    ``torch.cuda.set_sync_debug_mode("warn")``: a synchronizing call
    whose innermost ``veles_torch`` frame lies in a function of
    ``tracer-purity``'s scope (``rules_purity.traced_functions``) fails
    the run, one elsewhere is printed (``capture_purity: ... sync
    outside the scope``) with its stack in the row; launches exact (1
    masked and 1 identity a MNIST step; the LM's as ``lm_expected_counts``
    gives them, the flash kernels at S 512);
40. the ``kernels`` summary line (the bias gradient's launches summed
    over the MNIST, CIFAR-10, AlexNet, autoencoder, LM-slice, resume,
    model-health, unsupervised, plots, serve_http, ensemble, optimize (in
    process and in the workers), shell_forge, profiling, image_stream,
    continual, distributed, parallel, parallel_ep_pp, the five phases
    above (the slaves' and the ranks' counts from their result lines; a
    SIGKILLed slave's are lost), each
    path's beside it, the serving paths' among them), the card line, and
    last ``{"ok": true, "device": {...}}``.

Phases resume, image_stream, continual, image_jpeg, distributed and the
parallel ones run in three side processes (``SIDE_GROUPS``), started
once the kernels are timed and running beside the others; each counts
its own launches, and its lines are printed once it has ended, before
the summary line. Every JSON line also goes to ``chip_smoke.jsonl`` in
that directory, with ``at_s``: the seconds since the script started.
"""

import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
ACTIVATIONS = ("linear", "softmax", "tanh", "relu", "strict_relu",
               "sigmoid")
SHAPES = ((100, 100), (100, 10), (72900, 96), (4097, 1000))
#: the bias gradients of the 110M LM step (N = B·S = 4096 rows): the
#: attention and FFN output biases (768, bf16), the qkv bias (2304,
#: bf16), the vocab head (16384, bf16), the layer norms' (768, f32) and
#: the FFN's hidden bias (3072, f32)
LM_SHAPES = (((4096, 768), "bfloat16"), ((4096, 2304), "bfloat16"),
             ((4096, 16384), "bfloat16"), ((4096, 768), "float32"),
             ((4096, 3072), "float32"))
#: the stacked 110M's bias sums not among LM_SHAPES: the stack runs in
#: f32 from its boundary on, so its qkv bias sum is (4096, 2304) f32 (its
#: (4096, 768) and (4096, 3072) sums are f32 too)
STACK_SHAPES = (((4096, 2304), "float32"),)
#: activations checked at LM_SHAPES: the identity form the LM runs and a
#: masked one (every activation runs at SHAPES)
LM_ACTIVATIONS = ("linear", "tanh")
#: the bias gradients of the conv path (relu, i.e. softplus, bf16), each a
#: GD unit's (B·oy·ox, K) view: AlexNet at minibatch 128 (conv1 (128·55·55,
#: 96), conv2 (128·27·27, 256), conv3-4 (128·13·13, 384), conv5 (.., 256),
#: the two FC layers (128, 4096)) and CIFAR-10 at its minibatch 100 (conv1
#: (100·32·32, 32), conv2 (100·16·16, 64))
CONV_SHAPES = ((387200, 96), (93312, 256), (21632, 384), (21632, 256),
               (128, 4096), (102400, 32), (25600, 64))
#: the bias gradients of the autoencoders (tanh, masked): MnistAE's
#: conv_tanh GD view at minibatch 100 (100·24·24, 9) and VideoAE's at
#: minibatch 50 (50·20·20, 8), checked and timed in f32 and bf16
AE_SHAPES = ((57600, 9), (20000, 8))
#: the bias-gradient kernel in a profiler trace (``bias_grad_kernel<T,
#: ACT, VEC>`` in csrc/bias_grad.cu)
BIAS_GRAD_KERNEL = "bias_grad_kernel"
#: (form, activation timed, main-path shape, TPU kernel replaced)
FORMS = (("identity", "linear", (100, 10),
          "veles/znicz_tpu/ops/pallas_grads.py:95"),
         ("masked", "tanh", (100, 100),
          "veles/znicz_tpu/ops/pallas_grads.py:76"))
TOLERANCE = 1e-4
#: (B, H, S, dh) of the flash checks: the LM sample's attention, the
#: 110M row, a ragged S, the 110M_s8k row (bench.py LM_ROWS)
FLASH_SHAPES = ((64, 4, 32, 16), (8, 12, 512, 64), (2, 3, 200, 64),
                (4, 4, 256, 32), (2, 3, 200, 128), (4, 12, 8192, 64))
#: timed shapes (bf16, causal) and the main path's (the 110M row)
FLASH_TIMED = ((8, 12, 512, 64), (4, 12, 8192, 64))
FLASH_MAIN = (8, 12, 512, 64)
#: limits of scaled_err, by input dtype, against the float64 math: each
#: element is held to its own size plus its row's rms (one row per (b, h,
#: query) of out and dq, per (b, h, key) of dk and dv), since causal rows
#: shrink with their position (out row i is about 1/√i in size) and a
#: tensor-wide scale would leave the later rows' work unchecked. Sound
#: kernels on an H100 read at most 0.0149 (bf16) and 5.3e-6 (f32) at the
#: four FLASH_SHAPES; a V row dropped from the second half's off-diagonal
#: tiles of the forward read 1.51, a dropped diagonal mask 1.3e3. The
#: bf16-accumulated forward rounds its accumulator once per K tile, so
#: its error grows with the number of K tiles: 0.096 at S=8192 non-causal
#: with the 64-key tiles of the mma.sync kernel (the wgmma kernel's are
#: 128 keys).
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_ACC_BF16_TOL = 0.2
#: kernel against plain version, both rounding p and ds to the storage
#: dtype (values on either side of a bf16 rounding step differ by one
#: bf16 ulp); sound readings at most 0.0114 (bf16), 4.1e-6 (f32)
FLASH_VS_PLAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_ATOL = 1e-3
#: absolute allowance, as a share of max|ref|, for an f32 sum's rounding
#: where the reference is 0 (dq of row 0 in a causal run: ds = p·(dp −
#: delta) = 0 exactly)
ATOL_SHARE = 1e-6
#: (summary name, source of the bf16 kernel, TPU kernel replaced)
FLASH_KERNELS = (
    ("flash_fwd", "veles_torch/csrc/flash_fwd_sm90.cu",
     "veles/znicz_tpu/parallel/pallas_attention.py:161"),
    ("flash_fwd_pipe", "veles_torch/csrc/flash_fwd_sm90.cu",
     "veles/znicz_tpu/parallel/pallas_attention.py:203"),
    ("flash_bwd_fused", "veles_torch/csrc/flash_bwd_sm90.cu",
     "veles/znicz_tpu/parallel/pallas_attention.py:384"),
    ("flash_bwd_dq", "veles_torch/csrc/flash_dq_sm90.cu",
     "veles/znicz_tpu/parallel/pallas_attention.py:278"),
    ("flash_bwd_dkv", "veles_torch/csrc/flash_bwd_sm90.cu",
     "veles/znicz_tpu/parallel/pallas_attention.py:324"))
#: the libraries of the bf16 forward, fused backward (with the dk/dv
#: kernel) and dq kernel, and the instructions each of their kernels must
#: hold: wgmma and TMA loads
SM90_LIBRARIES = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_dq_sm90")
SM90_OPCODES = ("HGMMA", "UTMALDG")
#: per form: operations as multiples of B·H·S²·dh/2 (causal: each block
#: product is 2·S²·dh/2 operations), bf16 (B, H, S, dh) tensors and f32
#: (B, H, S) rows moved. The pair (dq and dk/dv kernels) computes what
#: the fused backward computes, with s and dp recomputed in each kernel:
#: 7 products, not 5; as one function it moves the fused backward's
#: bytes, though its two kernels between them read 11 tensors and 4 rows.
FLASH_WORK = {"fwd": (4, 4, 1), "bwd": (10, 7, 2), "dq": (6, 5, 2),
              "dkv": (8, 6, 2), "pair": (14, 7, 2)}
MODELS = os.path.join(HERE, "veles_torch", "znicz", "models")
LM_SAMPLE = os.path.join(MODELS, "transformer_lm.py")
CIFAR_SAMPLE = os.path.join(MODELS, "cifar10.py")
IMAGENET_SAMPLE = os.path.join(MODELS, "imagenet.py")
#: the reference test's reduced CIFAR-10 run (tests/test_cifar_functional.py:
#: 600/200 images, minibatch 50, 3 epochs, lr 0.01, moment 0.5, seed
#: 2024) at the sample's full width; its bars: the validation error below
#: 0.55, and within 0.08 of the port's CPU run (the reference's numpy
#: against XLA)
CIFAR_RUN = ("root.cifar.loader.n_train=600", "root.cifar.loader.n_valid=200",
             "root.cifar.loader.minibatch_size=50",
             "root.cifar.decision.max_epochs=3")
CIFAR_MAX_ERROR = 0.55
CIFAR_CPU_TOLERANCE = 0.08
#: the AlexNet sample at full width under the card's bf16 policy,
#: minibatch 128, its bank cut to 1024/256 images and 2 epochs
ALEXNET_RUN = ("root.imagenet.loader.n_train=1024",
               "root.imagenet.loader.n_valid=256",
               "root.imagenet.decision.max_epochs=2")
#: one AlexNet train step at full geometry, minibatch 8, dropout 0, in
#: f32 (compute_dtype = amp = float32): every parameter and velocity on
#: the card within ALEXNET_PARITY_RTOL of its largest element of the
#: port's CPU step from the same weights, routed through the card's max
#: pool winners (f32 sums in another order; without the routing, a near
#: tie that picks another winner moves conv1's bias and velocity far
#: beyond that error)
ALEXNET_PARITY_RTOL = 1e-4
#: a max pool's winner may differ between the card and the CPU only where
#: the two candidates lie within this share of the input's largest
#: element (f32 sums in another order: some 1e-7 relative)
NEAR_TIE = 1e-5
#: final validation loss of the LM sample, cuda vs cpu: the card runs
#: bf16 matmul inputs and activations, the CPU f32, and the loss drops
#: through a transition (epochs 4-6 at seed 1337) whose timing moves
#: with rounding; since the card's products are the f32 sums of the
#: rounded inputs, both read the same loss to 3e-4 (1.3473 and 1.3476)
LM_CPU_TOLERANCE = 0.05
#: the 110M row of bench.py (LM_ROWS["110M"]) with the flash kernels,
#: its corpus cut to 64/16 sequences and 2 epochs
LM_110M = ("root.lm.loader.minibatch_size=8", "root.lm.loader.n_train=64",
           "root.lm.loader.n_valid=16", "root.lm.loader.seq_len=512",
           "root.lm.loader.vocab=16384", "root.lm.loader.max_period=8",
           "root.lm.model.dim=768", "root.lm.model.heads=12",
           "root.lm.model.layers=12", "root.lm.model.ffn_hidden=3072",
           "root.lm.model.attn_block=256", "root.lm.decision.max_epochs=2")
#: a serving forward on the card against the port's f32 training forward
#: of the same rows, the CPU ArchiveModel, and the bucket run without pad
#: rows: each within this share of the largest output (f32 on every side,
#: sums in other orders)
SERVE_RTOL = 1e-5
#: concurrent clients of the MicroBatcher and the requests each sends
SERVE_CLIENTS, SERVE_REQUESTS = 32, 4
#: the 110M decode: KV slots and positions, requests, new tokens each
#: (64 until PR 22, which cut them to 32 to make room for its four phases:
#: the sequential baseline of 3 × 16 requests took 46 of phase
#: serve_decode's 61 s), and the prompt lengths drawn between these bounds
DECODE_SLOTS, DECODE_MAX_LEN = 8, 512
DECODE_REQUESTS, DECODE_NEW = 16, 32
DECODE_PROMPT = (64, 256)
#: the first decode step's logits against a full forward over prompt +
#: token, as a share of the largest logit (f32 through 12 layers, the
#: cached and the dense attention summing in other orders); also the
#: top-two gap within which greedy tokens of two f32 paths may differ
#: (a near tie)
LOGIT_RTOL = 1e-4
#: the reference's quantized-parity bound (tests/test_wquant.py):
#: post-softmax outputs of a quantized forward against f32
QUANT_PROB_ATOL = 2e-2
#: the autoencoder samples at the reference's own configuration (nothing
#: cut): (phase, sample file, seed); MnistAE 2000/500 images, minibatch
#: 100, 4 epochs; VideoAE 40 clips × 16 frames of 24×24, minibatch 50, 5
#: epochs
AE_RUNS = (("ae", "mnist_ae.py", 1337), ("video_ae", "video_ae.py", 1337))
#: the card's final validation MSE against the port's CPU run: the
#: reference's own bound between its backends (tests/test_mnist_ae.py),
#: max(AE_CPU_RTOL·mse, AE_CPU_ATOL)
AE_CPU_RTOL, AE_CPU_ATOL = 0.15, 1e-3
#: one f32 autoencoder step, card against CPU, every parameter and
#: velocity against its largest element (as ALEXNET_PARITY_RTOL)
AE_PARITY_RTOL = 1e-4
#: the deconvolution and depooling units on the card against the CPU, f32
#: with TF32 off, as a share of the largest element (f32 sums in another
#: order)
AE_UNIT_RTOL = 1e-5
#: where traces and the full log go (listed in .gitignore)
OUT_DIR = os.path.join(HERE, "chiprun_out")
#: every JSON line printed, in full (the end of stdout may be all that a
#: remote runner keeps)
LOG_PATH = os.path.join(OUT_DIR, "chip_smoke.jsonl")
#: the workflows the training phases leave for the serving phases
TRAINED = {}
#: the script's start on the host's monotonic clock (the log's ``at_s``;
#: a side process takes the first process's, see SIDE_GROUPS)
STARTED = float(os.environ.get("CHIP_SMOKE_STARTED") or time.monotonic())


def emit(obj):
    """Print ``obj`` as one JSON line; the log's copy also holds
    ``at_s``, the seconds since the script started (where a run's time
    goes, phase by phase)."""
    line = json.dumps(obj)
    print(line, flush=True)
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    with open(LOG_PATH, "a") as f:
        f.write(json.dumps(dict(obj, at_s=time.monotonic() - STARTED))
                + "\n")


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled):
    """``name<template ints,element type>`` of an Itanium-mangled kernel
    name: the last of its ``<length><identifier>`` parts, then the
    integer and element-type template arguments."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group()
        pos += len(n)
        name = mangled[pos:pos + int(n)]
        pos += int(n)
    head = mangled[pos:].split("Ev", 1)[0]
    args = re.findall(r"L[ib](\d+)E", head)
    if "bfloat16" in head:
        args.append("bf16")
    elif head.startswith("If"):
        args.append("f32")
    return "%s<%s>" % (name, ",".join(args))


def ptxas_report(log):
    """{kernel: [registers, spilled bytes stored + loaded]} from nvcc's
    ``-Xptxas -v`` report."""
    report, name, spills = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (_Z\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = [int(m.group(1)), spills]
            name = None
    return report


def sass_counts(kernels, library):
    """{kernel: {opcode: count}} of SM90_OPCODES in ``cuobjdump -sass``
    of the built ``library``; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", kernels.library_path(library)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (_Z\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = dict.fromkeys(SM90_OPCODES, 0)
        elif name:
            for op in SM90_OPCODES:
                counts[name][op] += bool(re.search(r"\b%s\b" % op, line))
    return counts


def bound_ms(n, k, itemsize, activation):
    """Least time for the function on an H100: inputs read once, the
    (K,) f32 output written once, against the f32 operation count."""
    from veles_torch.znicz.ops import activations as A
    from veles_torch.znicz.ops.bias_grad import OPS_PER_ELEMENT
    inputs = 1 if A.is_identity(activation) else 2
    nbytes = inputs * n * k * itemsize + 4 * k
    ops = OPS_PER_ELEMENT[activation] * n * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


class Timer:
    """Median device time of one call, the L2 cache flushed first."""

    def __init__(self, torch):
        self.torch = torch
        # larger than the 50 MB L2, so each launch starts cold
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps=25):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in ev)
        return times[len(times) // 2]


def check_bias_grad(torch, err, y, act, forms):
    """One (shape, dtype, activation) of phase kernels: the kernel twice
    against the float64 math and its plain version; -> max |error|
    against the float64 math."""
    from veles_torch.znicz.ops import activations as A
    from veles_torch.znicz.ops.bias_grad import bias_grad, bias_grad_plain
    n, k = err.shape
    out = bias_grad(err, y, act)
    again = bias_grad(err, y, act)
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or out.shape != (k,):
        fail("bias_grad %s %s: got %s %s"
             % (act, (n, k), out.dtype, tuple(out.shape)))
    if not torch.equal(out, again):
        fail("bias_grad %s %s %s: two launches differ"
             % (act, (n, k), err.dtype))
    d = A.ACTIVATIONS[act][1](y.double())
    dz = err.double() if isinstance(d, float) else err.double() * d
    diff = (out.double() - dz.sum(dim=0)).abs()
    limit = TOLERANCE * dz.abs().sum(dim=0)
    plain = (out.double() - bias_grad_plain(err, y, act).double()).abs()
    if not bool((diff <= limit).all() and (plain <= limit).all()):
        fail("bias_grad %s %s %s: error %.3g (%.3g from the plain version) "
             "over limit (worst ratio %.3g)"
             % (act, (n, k), err.dtype, diff.max().item(),
                plain.max().item(),
                (torch.maximum(diff, plain)
                 / limit.clamp_min(1e-30)).max().item()))
    form = "identity" if A.is_identity(act) else "masked"
    forms[form]["max_abs_err"] = max(forms[form]["max_abs_err"],
                                     diff.max().item())
    return diff.max().item()


def check_kernels(torch, timer):
    """Phase 3; -> {form: {"max_abs_err", and the main-path times}}."""
    from veles_torch.znicz.ops.bias_grad import bias_grad, bias_grad_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1337)
    forms = {form: {"max_abs_err": 0.0} for form, _, _, _ in FORMS}
    timed = [(form, act) for form, act, _, _ in FORMS]
    both = ("float32", "bfloat16")
    # (shape, dtypes checked, activations, (form, activation) timed,
    # dtypes timed)
    cases = [(shape, both, ACTIVATIONS, timed, both[-1:])
             for shape in SHAPES] + [
        (shape, (dname,), LM_ACTIVATIONS, timed, (dname,))
        for shape, dname in LM_SHAPES + STACK_SHAPES] + [
        (shape, ("bfloat16",), ("relu",), [("masked", "relu")],
         ("bfloat16",)) for shape in CONV_SHAPES] + [
        (shape, both, ("tanh",), [("masked", "tanh")], both)
        for shape in AE_SHAPES]
    for (n, k), dnames, acts, timed, timed_dtypes in cases:
        base_err = torch.randn((n, k), generator=gen, device="cuda")
        base_y = torch.randn((n, k), generator=gen, device="cuda")
        for dname in dnames:
            dtype = getattr(torch, dname)
            err, y = base_err.to(dtype), base_y.to(dtype)
            worst = {act: check_bias_grad(torch, err, y, act, forms)
                     for act in acts}
            emit({"phase": "kernels", "shape": [n, k], "dtype": dname,
                  "max_abs_err": worst, "bitwise_repeat": True})
        # timings in the card's activation dtype, or the LM's for its
        # shapes (both for the autoencoders'); err.sum is the one PyTorch
        # call of the identity form, and beside the masked form a
        # yardstick of the same bytes of err
        for dname in timed_dtypes:
            dtype = getattr(torch, dname)
            err, y = base_err.to(dtype), base_y.to(dtype)
            for form, act in timed:
                sum_ms = timer(lambda: err.sum(0, dtype=torch.float32))
                row = {
                    "kernel_ms": timer(lambda: bias_grad(err, y, act)),
                    "plain_ms": timer(lambda: bias_grad_plain(err, y,
                                                              act)),
                    "library_ms": sum_ms if form == "identity" else None,
                    "err_sum_ms": sum_ms,
                }
                row["bound_ms"], row["bound_by"] = bound_ms(
                    n, k, err.element_size(), act)
                emit({"phase": "kernel_times", "form": form,
                      "activation": act, "shape": [n, k], "dtype": dname,
                      **row})
                if any((n, k) == main and form == f
                       for f, _, main, _ in FORMS):
                    forms[form].update(row)
        del base_err, base_y, err, y
        torch.cuda.empty_cache()
    return forms


def cli_run(argv, monitor=None):
    """The port's CLI entry point in this process, under a fresh
    model-health monitor (or ``monitor``), as a process of its own runs
    it: one run's losses must not judge (and stamp the checkpoints of)
    another."""
    from veles_torch import model_health
    from veles_torch.__main__ import main as cli
    with model_health.scoped(monitor):
        return cli(argv)


def run_mnist(torch, device):
    return cli_run([os.path.join(HERE, "veles_torch", "znicz", "models",
                             "mnist.py"),
                "root.mnist.decision.max_epochs=3", "--seed", "1337",
                "-d", device])


def check_mnist(torch, wf, name):
    history = wf.decision.history
    if len(history) != 3:
        fail("%s: %d epochs in the history, expected 3"
             % (name, len(history)))
    check_params_finite(torch, wf, name)
    shapes = {u.name: tuple(u.weights.shape) for u in wf.forwards}
    if list(shapes.values()) != [(784, 100), (100, 10)]:
        fail("%s: weight shapes %s" % (name, shapes))
    return history[-1]["validation"]["metric"]


def device_trace(prof, name):
    """Write the profile's Chrome trace to OUT_DIR/<name> and sum its
    device intervals (kernels, copies, memsets): -> (busy ms as the union
    of the intervals, device op count, {op name: (count, ms)}, path)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                   for e in events if e.get("ph") == "X" and e.get("cat")
                   in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, None
    for lo, hi, _ in spans:
        if end is None or lo > end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    by_name = {}
    for lo, hi, op in spans:
        n, t = by_name.get(op, (0, 0.0))
        by_name[op] = (n + 1, t + (hi - lo) / 1e3)
    return busy_us / 1e3, len(spans), by_name, os.path.relpath(path, HERE)


#: kinds of device operation in a trace, by kernel name, first match wins
OP_KINDS = (("bias_grad", BIAS_GRAD_KERNEL), ("flash", "flash_|dq_reduce"),
            ("convolution", "implicit_gemm|cudnn|conv"),
            ("gemm", "gemm|nvjet|cublas|cutlass"),
            ("copy_cast", "copy|Memcpy|Memset"), ("elementwise", ""))


def ops_by_kind(by_name):
    """{kind of OP_KINDS: [count, ms]} of a trace's device operations."""
    kinds = {kind: [0, 0.0] for kind, _ in OP_KINDS}
    for op, (count, ms) in by_name.items():
        kind = next(k for k, pattern in OP_KINDS if re.search(pattern, op))
        kinds[kind][0] += count
        kinds[kind][1] += ms
    return kinds


def top_ops(by_name, n=8):
    return [{"name": op[:80], "count": c, "ms": t} for op, (c, t) in
            sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]]


def bias_grad_in_trace(by_name, calls, where):
    """The bias-gradient kernel's device launches and ms in a trace, by
    input dtype (read from the kernel name); fails unless the ``calls``
    to the wrapper in the traced window launched one kernel each."""
    rows = {}
    for op, (count, ms) in by_name.items():
        if BIAS_GRAD_KERNEL not in op:
            continue
        dname = "bfloat16" if "bfloat16" in op \
            else "float16" if "__half" in op else "float32"
        row = rows.setdefault(dname, {"launches": 0, "ms": 0.0})
        row["launches"] += count
        row["ms"] += ms
    launches = sum(row["launches"] for row in rows.values())
    if launches != calls:
        fail("%s: %d bias-gradient kernels on the device for %d calls"
             % (where, launches, calls))
    return {"calls": calls, "launches": launches,
            "ms": sum(row["ms"] for row in rows.values()), "by_dtype": rows}


def profile_epoch(torch):
    """One steady MNIST epoch on the card under torch.profiler: device
    busy time (union of kernel, copy and memset intervals) against the
    host wall time, and launches per step. The Chrome trace goes to
    chiprun_out/mnist_epoch_trace.json."""
    from torch.profiler import ProfilerActivity
    from veles_torch.znicz.models import mnist
    wf = mnist.create_workflow(name="MnistProfile")
    wf.decision.max_epochs = None
    wf.initialize(device="cuda")
    wf.step.run_epoch()                  # uploads and first launches
    wf.loader.next_epoch()
    steps0 = wf.step.train_steps
    torch.cuda.synchronize()
    reset_counts()
    with counted_window([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                        torch.cuda.synchronize) as prof:
        t0 = time.perf_counter()
        wf.step.run_epoch()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, n_ops, by_name, path = device_trace(prof,
                                                 "mnist_epoch_trace.json")
    from veles_torch.znicz.ops.bias_grad import bias_grad
    bias = bias_grad_in_trace(by_name, bias_grad.launches, "mnist epoch")
    return {"phase": "profile", "wall_ms": wall_ms, "bias_grad": bias,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if n_ops else None,
            "device_ops": n_ops, "train_steps": wf.step.train_steps - steps0,
            "eval_steps": len(wf.loader.class_schedule(1)[0]),
            "top_device_ops": top_ops(by_name), "trace": path}


# -- flash attention ------------------------------------------------------


def flash_inputs(torch, shape, dtype, seed=1337):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 .to(dtype) for _ in range(4))


def flash_reference(torch, q, k, v, dout, causal, out_in=None):
    """The float64 math from the same inputs, chunked over b·h: (out,
    lse), and with ``out_in`` also (dq, dk, dv), whose delta =
    rowsum(dout·out_in) as the kernels take it from the out they are
    given."""
    from veles_torch.znicz.ops import flash_attention as FA
    b, h, s, dh = q.shape
    scale = FA.scale_for(dh)
    flat = [t.reshape(b * h, s, dh) for t in (q, k, v, dout)]
    res = [torch.empty((b * h, s, dh), dtype=torch.float64, device="cuda")
           for _ in range(1 if out_in is None else 4)]
    lse = torch.empty((b * h, s), dtype=torch.float64, device="cuda")
    step = max(1, (1 << 27) // (s * s))
    mask = torch.ones((s, s), dtype=torch.bool, device="cuda").triu(1)
    for i in range(0, b * h, step):
        sl = slice(i, min(i + step, b * h))
        qd, kd, vd, dod = (t[sl].double() for t in flat)
        sc = torch.matmul(qd, kd.transpose(1, 2)) * scale
        if causal:
            sc.masked_fill_(mask, float("-inf"))
        lse[sl] = torch.logsumexp(sc, dim=-1)
        p = torch.exp(sc - lse[sl][..., None])
        del sc
        res[0][sl] = torch.matmul(p, vd)
        if out_in is None:
            continue
        od = out_in.reshape(b * h, s, dh)[sl].double()
        ds = torch.matmul(dod, vd.transpose(1, 2))
        ds -= (dod * od).sum(dim=-1, keepdim=True)
        ds *= p * scale
        res[1][sl] = torch.matmul(ds, kd)
        res[2][sl] = torch.matmul(ds.transpose(1, 2), qd)
        res[3][sl] = torch.matmul(p.transpose(1, 2), dod)
        del p, ds
    return tuple(t.reshape(b, h, s, dh) for t in res[:1]) \
        + (lse.reshape(b, h, s),) \
        + tuple(t.reshape(b, h, s, dh) for t in res[1:])


def scaled_err(got, ref):
    """Worst element of (B, H, S, dh) ``got`` against ``ref``, each held
    to its own size and its row's: max of (|got − ref| − ATOL_SHARE ·
    max|ref|) / (|ref| + rms of ref's row)."""
    g, r = got.double(), ref.double()
    d = (g - r).abs() - ATOL_SHARE * r.abs().max()
    scale = r.abs() + r.square().mean(-1, keepdim=True).sqrt()
    return (d.clamp_min(0) / scale.clamp_min(1e-300)).max().item()


def check_flash(torch):
    """Phase flash_kernels; -> {kernel: max |kernel − plain|}."""
    from veles_torch.znicz.ops import flash_attention as FA
    worst = {name: 0.0 for name, _, _ in FLASH_KERNELS}
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            tol = FLASH_TOL[dname]
            q, k, v, dout = flash_inputs(torch, shape, dtype)
            for causal in (True, False):
                row = {}
                ref_out, ref_lse = flash_reference(
                    torch, q, k, v, dout, causal)
                out_in = ref_out.to(dtype)
                lse_in = ref_lse.float()
                ref = flash_reference(torch, q, k, v, dout, causal, out_in)
                plain = {"fwd": FA.flash_attention_fwd_plain(q, k, v,
                                                             causal)}
                plain["fwd_pipe"] = plain["fwd"]
                plain["bwd"] = FA.flash_attention_bwd_plain(
                    q, k, v, out_in, lse_in, dout, causal)
                # the dq and dk/dv plain versions are bwd_plain's results
                # to the bit (tests/test_torch_flash_attention.py)
                plain["two"] = plain["bwd"]
                got = {}
                for variant, pipe in (("fwd", False), ("fwd_pipe", True)):
                    a = FA.flash_attention_fwd(q, k, v, causal, pipe)
                    b = FA.flash_attention_fwd(q, k, v, causal, pipe)
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip(a, b)):
                        fail("%s %s %s causal=%s: two launches differ"
                             % (variant, shape, dname, causal))
                    got[variant] = a
                a = FA.flash_attention_bwd(q, k, v, out_in, lse_in, dout,
                                           causal)
                b = FA.flash_attention_bwd(q, k, v, out_in, lse_in, dout,
                                           causal)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    fail("bwd %s %s causal=%s: two launches differ"
                         % (shape, dname, causal))
                got["bwd"] = a
                a = FA.flash_attention_bwd(q, k, v, out_in, lse_in, dout,
                                           causal, fused=False)
                b = FA.flash_attention_bwd(
                    q, k, v, out_in, lse_in, dout, causal,
                    delta=FA.row_delta(out_in, dout), fused=False)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    fail("two-kernel bwd %s %s causal=%s: two launches, one "
                         "with delta hoisted, differ" % (shape, dname, causal))
                got["two"] = a
                acc = FA.flash_attention_fwd(q, k, v, causal,
                                             acc_dtype=torch.bfloat16)[0]
                acc_pipe = FA.flash_attention_fwd(
                    q, k, v, causal, True, torch.bfloat16)[0]
                checks = [("fwd", "out", got["fwd"][0], ref[0], tol),
                          ("fwd_pipe", "out", got["fwd_pipe"][0], ref[0],
                           tol),
                          ("fwd_acc_bf16", "out", acc, ref[0],
                           FLASH_ACC_BF16_TOL),
                          ("fwd_pipe_acc_bf16", "out", acc_pipe, ref[0],
                           FLASH_ACC_BF16_TOL),
                          ("plain_fwd", "out", plain["fwd"][0], ref[0],
                           tol)]
                near = FLASH_VS_PLAIN_TOL[dname]
                for i, name in enumerate(("dq", "dk", "dv")):
                    checks += [("bwd", name, got["bwd"][i], ref[2 + i], tol),
                               ("plain_bwd", name, plain["bwd"][i],
                                ref[2 + i], tol),
                               ("bwd_vs_plain", name, got["bwd"][i],
                                plain["bwd"][i], near),
                               ("two", name, got["two"][i], ref[2 + i], tol),
                               ("two_vs_plain", name, got["two"][i],
                                plain["two"][i], near),
                               ("two_vs_fused", name, got["two"][i],
                                got["bwd"][i], near)]
                for variant in ("fwd", "fwd_pipe"):
                    checks.append(("%s_vs_plain" % variant, "out",
                                   got[variant][0], plain[variant][0], near))
                over = []
                for label, name, g, r, t in checks:
                    e = scaled_err(g, r)
                    row["%s.%s" % (label, name)] = e
                    if not e <= t:
                        over.append("%s.%s scaled error %.3g over %.3g"
                                    % (label, name, e, t))
                for variant in ("fwd", "fwd_pipe", "plain_fwd"):
                    lse = (got.get(variant) or plain["fwd"])[1]
                    e = (lse.double() - ref[1]).abs().max().item()
                    row["%s.lse_abs" % variant] = e
                    if not e <= LSE_ATOL:
                        over.append("%s.lse error %.3g over %.3g"
                                    % (variant, e, LSE_ATOL))
                for name, variant, pairs in (
                        ("flash_fwd", "fwd", [(0, 0)]),
                        ("flash_fwd_pipe", "fwd_pipe", [(0, 0)]),
                        ("flash_bwd_fused", "bwd", [(0, 0), (1, 1),
                                                     (2, 2)]),
                        ("flash_bwd_dq", "two", [(0, 0)]),
                        ("flash_bwd_dkv", "two", [(1, 1), (2, 2)])):
                    for gi, pi in pairs:
                        worst[name] = max(worst[name], (
                            got[variant][gi].double()
                            - plain[variant][pi].double()).abs().max()
                            .item())
                # bf16: one kernel computes dk and dv with dq and without
                same = all(torch.equal(got["two"][i], got["bwd"][i])
                           for i in (1, 2))
                if dtype == torch.bfloat16 and not same:
                    over.append("two-kernel dk, dv differ from the fused "
                                "kernel's bits")
                emit({"phase": "flash_kernels", "shape": list(shape),
                      "dtype": dname, "causal": causal,
                      "bitwise_repeat": True,
                      "two_dk_dv_bitwise_fused": same,
                      "scaled_err": row})
                if over:
                    fail("flash %s %s causal=%s: %s"
                         % (shape, dname, causal, "; ".join(over)))
                del ref, plain, got, a, b, acc, acc_pipe
            torch.cuda.empty_cache()
    return worst


def flash_bound_ms(shape, form):
    """Least time on an H100 for ``form`` of FLASH_WORK at the bf16 peak
    and the HBM rate: -> (ms, what bounds it)."""
    b, h, s, dh = shape
    products, tensors, rows = FLASH_WORK[form]
    ops = products * b * h * s * s * dh / 2
    nbytes = tensors * b * h * s * dh * 2 + rows * b * h * s * 4
    t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def sdpa_backward_pinned(torch, timer, q, k, v, dout, reps):
    """SDPA's backward (causal) with its backend pinned by
    ``torch.nn.attention.sdpa_kernel``: flash, then memory-efficient; each
    row names the autograd node that ran."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    row = {"phase": "sdpa_backward_pinned", "shape": list(q.shape),
           "dtype": str(q.dtype)[6:], "causal": True, "reps": reps}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        with sdpa_kernel(backend):
            out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        row[name + "_ms"] = timer(lambda: torch.autograd.grad(
            out, (qr, kr, vr), dout, retain_graph=True), reps)
        row[name + "_node"] = type(out.grad_fn).__name__
    return row


def time_flash(torch, timer):
    """Phase flash_kernel_times; -> {kernel: the main shape's row}."""
    import torch.nn.functional as F
    from veles_torch.znicz.ops import flash_attention as FA
    rows = {}
    for shape in FLASH_TIMED:
        reps = 25 if shape[2] <= 1024 else 5
        q, k, v, dout = flash_inputs(torch, shape, torch.bfloat16)
        out, lse = FA.flash_attention_fwd(q, k, v)
        delta = FA.row_delta(out, dout)
        grads = (q, k, v, out, lse, dout)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        plain_fwd = timer(lambda: FA.flash_attention_fwd_plain(q, k, v),
                          reps)
        lib_fwd = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps)
        lib_bwd = timer(lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), dout, retain_graph=True), reps)
        if shape == FLASH_MAIN:
            emit(sdpa_backward_pinned(torch, timer, q, k, v, dout, reps))
        pair = functools.partial(FA.flash_attention_bwd, *grads,
                                 delta=delta, fused=False)
        # no one PyTorch call computes dq alone or dk/dv alone: their rows
        # have no library time; the pair's has SDPA's backward
        for name, fn, plain_fn, lib_ms, form in (
                ("flash_fwd", lambda: FA.flash_attention_fwd(q, k, v),
                 None, lib_fwd, "fwd"),
                ("flash_fwd_pipe",
                 lambda: FA.flash_attention_fwd(q, k, v, pipeline=True),
                 None, lib_fwd, "fwd"),
                ("flash_bwd_fused",
                 lambda: FA.flash_attention_bwd(*grads, delta=delta),
                 lambda: FA.flash_attention_bwd_plain(*grads, delta=delta),
                 lib_bwd, "bwd"),
                ("flash_bwd_dq",
                 lambda: FA.flash_attention_dq(*grads, delta=delta),
                 lambda: FA.flash_attention_dq_plain(*grads, delta=delta),
                 None, "dq"),
                ("flash_bwd_dkv",
                 lambda: FA.flash_attention_dkv(*grads, delta=delta),
                 lambda: FA.flash_attention_dkv_plain(*grads, delta=delta),
                 None, "dkv"),
                ("flash_bwd_pair", pair,
                 lambda: (FA.flash_attention_dq_plain(*grads, delta=delta),
                          FA.flash_attention_dkv_plain(*grads,
                                                       delta=delta)),
                 lib_bwd, "pair")):
            row = {"ms": timer(fn, reps),
                   "plain_ms": plain_fwd if plain_fn is None
                   else timer(plain_fn, reps),
                   "library_ms": lib_ms}
            row["bound_ms"], row["bound_by"] = flash_bound_ms(shape, form)
            emit({"phase": "flash_kernel_times", "kernel": name,
                  "shape": list(shape), "dtype": "bfloat16",
                  "causal": True, "reps": reps, **row})
            if shape == FLASH_MAIN:
                rows[name] = row
        fused = functools.partial(FA.flash_attention_bwd, *grads,
                                  delta=delta)
        turns = [("fused", timer(fused, reps)), ("pair", timer(pair, reps)),
                 ("pair", timer(pair, reps)), ("fused", timer(fused, reps))]
        emit({"phase": "flash_bwd_ab", "shape": list(shape),
              "dtype": "bfloat16", "causal": True, "reps": reps,
              "fused_ms": [t for form, t in turns if form == "fused"],
              "pair_ms": [t for form, t in turns if form == "pair"]})
        del q, k, v, dout, out, lse, delta, grads, qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    return rows


# -- transformer LM -------------------------------------------------------


def reset_counts():
    from veles_torch.znicz.ops import flash_attention as FA
    from veles_torch.znicz.ops.bias_grad import bias_grad
    FA.reset_launches()
    bias_grad.launches = 0
    bias_grad.form_launches = {"identity": 0, "masked": 0}


def read_counts():
    from veles_torch.znicz.ops import flash_attention as FA
    from veles_torch.znicz.ops.bias_grad import bias_grad
    fwd = FA.flash_attention_fwd.variant_launches
    bwd = FA.flash_attention_bwd.variant_launches
    return {"flash_fwd": fwd["fwd"], "flash_fwd_pipe": fwd["fwd_pipe"],
            "flash_bwd_fused": bwd["fused"], "flash_bwd_dq": bwd["dq"],
            "flash_bwd_dkv": bwd["dkv"],
            "bias_grad[identity]": bias_grad.form_launches["identity"],
            "bias_grad[masked]": bias_grad.form_launches["masked"]}


def identity_sums_per_step(wf):
    """Column sums a train step of the LM ``wf`` takes through the
    bias-gradient kernel's identity form: 2 per attention and FFN unit, 1
    per layernorm and token dense, 6 per block of a stack, none in an MoE
    FFN (its expert bias sums are batched torch sums)."""
    from veles_torch.znicz.ops.attention import (
        MultiHeadAttention, TokenDenseBase, TransformerFFN)
    from veles_torch.znicz.ops.layernorm import LayerNormForward
    from veles_torch.znicz.ops.transformer_stack import TransformerBlockStack
    per = ((MultiHeadAttention, 2), (TransformerFFN, 2),
           (LayerNormForward, 1), (TokenDenseBase, 1))
    n = 0
    for f in wf.forwards:
        if isinstance(f, TransformerBlockStack):
            n += 6 * f.layers
        else:
            n += next((k for cls, k in per if isinstance(f, cls)), 0)
    return n


def lm_expected_counts(wf, device):
    """The launches an LM run of ``wf`` implies: the flash kernels as its
    attention's dispatch resolves (``mode``: the kernels, or the scan,
    dense and nothing), the fused backward, and the identity form once per
    column sum of every train step; all 0 on the CPU; -> (counts, mode)."""
    from veles_torch.znicz.ops.attention import MultiHeadAttention
    attn = [f for f in wf.forwards if isinstance(f, MultiHeadAttention)]
    mode = attn[0].mode(wf.loader.original_data.shape[1]) if attn else None
    train, evals = wf.step.train_steps, wf.step.eval_steps
    kernels = mode == "pallas"
    fwd = len(attn) * (train + evals) if kernels else 0
    pipeline = kernels and attn[0].attn_pipeline
    want = {"flash_fwd": 0 if pipeline else fwd,
            "flash_fwd_pipe": fwd if pipeline else 0,
            "flash_bwd_fused": len(attn) * train if kernels else 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "bias_grad[identity]": train * identity_sums_per_step(wf),
            "bias_grad[masked]": 0}
    if device == "cpu":
        want = dict.fromkeys(want, 0)
    return want, mode


def run_lm(torch, name, device, *overrides, valid_must_fall=True,
           impl="pallas", phase="lm", cli_args=(), stdout=None, monitor=None):
    """One LM run through the CLI entry point (``attn_impl`` set to
    ``impl`` unless None; ``root.lm.train`` emptied first, so no earlier
    run's solver options remain), its launches counted from 0; ->
    (workflow, counts, summary dict). Fails on a launch count other than
    the run implies (:func:`lm_expected_counts`), a non-finite parameter
    or solver tensor, or a train loss (and, with ``valid_must_fall``, a
    validation loss) that does not fall. ``cli_args`` go to the CLI after
    the rest; with ``stdout`` (a text stream) the CLI prints there; the run
is judged by ``monitor`` (a model-health monitor; a fresh one by
default)."""
    import contextlib
    from veles_torch.config import root
    root.lm.train = {}
    reset_counts()
    impl_arg = ("root.lm.model.attn_impl=%s" % impl,) if impl else ()
    with contextlib.redirect_stdout(stdout or sys.stdout):
        wf = cli_run([LM_SAMPLE, *impl_arg, *overrides, "--seed", "1337",
                      "-d", device, *cli_args], monitor)
    if device == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    want, mode = lm_expected_counts(wf, device)
    if counts != want:
        fail("%s %s: launches %s, expected %s" % (phase, name, counts, want))
    check_params_finite(torch, wf, "%s %s" % (phase, name))
    hist = wf.decision.history
    valid = [h["validation"]["loss"] for h in hist]
    train_loss = [h["train"]["loss"] for h in hist]
    if (valid_must_fall and not valid[-1] < valid[0]) \
            or not train_loss[-1] < train_loss[0]:
        fail("%s %s: loss did not fall: validation %s, train %s"
             % (phase, name, valid, train_loss))
    train, evals = wf.step.train_steps, wf.step.eval_steps
    per_epoch = (train + evals) / len(hist)
    tokens = (sum(wf.loader.class_lengths)
              * wf.loader.original_data.shape[1])
    summary = {"phase": phase, "run": name, "device": device,
               "attention_mode": mode,
               "layers": root.lm.model.layers,
               "train_steps": train, "eval_steps": evals,
               "launches": counts, "validation_loss": valid,
               "train_loss": train_loss,
               "epoch_seconds": wf.step.epoch_seconds}
    if len(hist) > 1:
        # the first epoch carries one-off costs (uploads, kernel load)
        warm = wf.step.epoch_seconds[1:]
        summary["tokens_per_sec"] = tokens * len(warm) / sum(warm)
        summary["ms_per_minibatch"] = 1e3 * sum(warm) / (
            per_epoch * len(warm))
    emit(summary)
    return wf, counts, summary


def profile_lm_step(torch, wf):
    """One full-width train step of ``wf`` (already run on the card)
    under torch.profiler (:func:`profile_step`), with the flash kernels'
    share of the device's busy time."""
    row, batch, by_name = profile_step(torch, wf, "lm_step_trace.json",
                                       "110M step")
    flash_ms = sum(t for op, (_, t) in by_name.items()
                   if "flash_" in op or "dq_reduce" in op)
    b, s = batch[0].shape
    return {"phase": "lm_profile", "shape": [b, s],
            "tokens_per_sec": b * s / row["step_ms"] * 1e3, **row,
            "flash_ms": flash_ms,
            "flash_share_of_busy": flash_ms / row["device_busy_ms"]
            if row["device_busy_ms"] else None}


def check_two_kernel(torch, wf):
    """Phase flash_bwd_two_kernel: the fused and the two-kernel backward
    on each attention unit's forward cache of ``wf`` (the 110M run), dout
    from a seeded generator, counted from 0; -> the counts."""
    from veles_torch.znicz.ops import flash_attention as FA
    from veles_torch.znicz.ops.attention import MultiHeadAttention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1337)
    units = [f for f in wf.forwards if isinstance(f, MultiHeadAttention)]
    tol = FLASH_VS_PLAIN_TOL["bfloat16"]
    worst, bitwise, over = {}, 0, []
    reset_counts()
    for f in units:
        q, k, v, out, lse, _ = f.cache
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        fused = FA.flash_attention_bwd(q, k, v, out, lse, dout, f.causal)
        two = FA.flash_attention_bwd(q, k, v, out, lse, dout, f.causal,
                                     fused=False)
        for name, a, b in zip(("dq", "dk", "dv"), two, fused):
            e = scaled_err(a, b)
            worst[name] = max(worst.get(name, 0.0), e)
            if not e <= tol:
                over.append("%s %s scaled error %.3g over %.3g"
                            % (f.name, name, e, tol))
        # the dk/dv kernel is the fused kernel without dq: the same bits
        same = all(torch.equal(a, b) for a, b in zip(two[1:], fused[1:]))
        bitwise += same
        if not same:
            over.append("%s dk, dv differ from the fused kernel's bits"
                        % f.name)
    torch.cuda.synchronize()
    counts = read_counts()
    want = dict({name: 0 for name in counts}, flash_bwd_fused=len(units),
                flash_bwd_dq=len(units), flash_bwd_dkv=len(units))
    emit({"phase": "flash_bwd_two_kernel", "units": len(units),
          "shape": list(q.shape), "dtype": str(q.dtype)[6:],
          "scaled_err_vs_fused": worst, "dk_dv_bitwise_fused": bitwise,
          "launches": counts})
    if over or counts != want:
        fail("two-kernel backward on the 110M activations: %s; launches "
             "%s, expected %s" % ("; ".join(over), counts, want))
    return counts


def check_lm(torch):
    """Phases lm, flash_bwd_two_kernel and lm_profile; -> launches of the
    flash kernels on their paths (the 110M run; the pipelined run for
    flash_fwd_pipe; the 110M activations for the two-kernel backward)."""
    _, _, cpu = run_lm(torch, "sample", "cpu")
    TRAINED["lm_sample"], _, cuda = run_lm(torch, "sample", "cuda")
    gap = abs(cuda["validation_loss"][-1] - cpu["validation_loss"][-1])
    if gap > LM_CPU_TOLERANCE:
        fail("lm sample: final validation loss %.4f on cuda vs %.4f on cpu"
             % (cuda["validation_loss"][-1], cpu["validation_loss"][-1]))
    _, pipe, _ = run_lm(torch, "sample_pipeline", "cuda",
                        "root.lm.model.attn_pipeline=True")
    run_lm(torch, "sample_acc_bf16", "cuda", "root.lm.model.attn_acc=bf16")
    # 16 train steps on a 16384-token vocabulary: the train loss falls,
    # the validation loss need not yet
    wf, full, _ = run_lm(torch, "110M", "cuda", *LM_110M,
                         valid_must_fall=False)
    TRAINED["lm_110M"] = wf
    two = check_two_kernel(torch, wf)
    emit(profile_lm_step(torch, wf))
    return dict(full, flash_fwd_pipe=pipe["flash_fwd_pipe"],
                flash_bwd_dq=two["flash_bwd_dq"],
                flash_bwd_dkv=two["flash_bwd_dkv"])


# -- the conv slice: CIFAR-10 and AlexNet -----------------------------------


def check_params_finite(torch, wf, name):
    """Fail unless every parameter and state tensor of ``wf`` is finite."""
    for unit, sub in wf.export_tree().items():
        for key, t in sub.items():
            if not bool(torch.isfinite(t.float()).all()):
                fail("%s: %s.%s is not finite" % (name, unit, key))


def conv_launches_ok(counts, train, masked_per_step):
    """The conv path's launch counts: the bias-gradient kernel's masked
    form ``masked_per_step`` and its identity form once per train step,
    no flash kernel."""
    want = dict({name: 0 for name in counts},
                **{"bias_grad[masked]": masked_per_step * train,
                   "bias_grad[identity]": train})
    return counts == want, want


def warm_images_per_sec(wf):
    """Images (train + validation) per second by the host clock over the
    epochs after the first (which carries the uploads and first
    launches)."""
    warm = wf.step.epoch_seconds[1:]
    return sum(wf.loader.class_lengths) * len(warm) / sum(warm)


def check_cifar(torch):
    """Phase cifar: the CIFAR-10 sample through the CLI at its full width
    (32 and 64 kernels of 5×5) with the reference test's data and
    settings (CIFAR_RUN, lr 0.01, moment 0.5, seed 2024) on the port's
    CPU and on the card, the launches counted from 0 just before the
    card run; -> the card run's launch counts."""
    import copy
    from veles_torch.config import root
    from veles_torch.znicz.models import cifar10  # noqa: F401 (defaults)
    layers = copy.deepcopy(root.cifar.layers)
    for layer in layers:
        if "<-" in layer:
            layer["<-"].update(learning_rate=0.01, gradient_moment=0.5)
    args = [CIFAR_SAMPLE, *CIFAR_RUN, "root.cifar.layers=%r" % (layers,),
            "--seed", "2024"]
    errors = {}
    for device in ("cpu", "cuda"):
        reset_counts()
        wf = cli_run(args + ["-d", device])
        if device == "cuda":
            torch.cuda.synchronize()
        counts = read_counts()
        check_params_finite(torch, wf, "cifar " + device)
        errors[device] = [h["validation"]["metric"]
                          for h in wf.decision.history]
    train = wf.step.train_steps
    ok, want = conv_launches_ok(counts, train, 2)
    emit({"phase": "cifar", "train_steps": train,
          "eval_steps": wf.step.eval_steps, "launches": counts,
          "validation_error_cuda": errors["cuda"],
          "validation_error_cpu": errors["cpu"],
          "images_per_sec": warm_images_per_sec(wf),
          "epoch_seconds": wf.step.epoch_seconds})
    err_cuda, err_cpu = errors["cuda"][-1], errors["cpu"][-1]
    if not ok:
        fail("cifar: launches %s, expected %s" % (counts, want))
    if not err_cuda < CIFAR_MAX_ERROR \
            or abs(err_cuda - err_cpu) > CIFAR_CPU_TOLERANCE:
        fail("cifar: final validation error %.4f on cuda vs %.4f on cpu"
             % (err_cuda, err_cpu))
    return counts


def alexnet_parity_workflow(device):
    """AlexNet at full geometry (227×227 crops of the 256×256 bank, every
    width), minibatch 8, dropout 0, initialized on ``device``."""
    from veles_torch import prng
    from veles_torch.config import root
    from veles_torch.znicz.models import imagenet
    from veles_torch.znicz.standard_workflow import StandardWorkflow
    root.imagenet.loader.update({"minibatch_size": 8, "n_train": 8,
                                 "n_valid": 8})
    layers = imagenet.alexnet_layers(root.imagenet.loader.n_classes)
    for layer in layers:
        if layer["type"] == "dropout":
            layer["->"]["dropout_ratio"] = 0.0
    prng.seed_all(1337)
    wf = StandardWorkflow(name="AlexNetParity", layers=layers,
                          loader_factory=imagenet.make_loader,
                          decision_config={"max_epochs": 1})
    return wf.initialize(device=device)


def check_alexnet_parity(torch):
    """Phase alexnet_parity: one AlexNet train step at full geometry in
    f32 on the card, then on the port's CPU from the same weights and
    minibatch. The two forwards sum in other orders, so a max pool's
    window whose two largest values lie within that noise may pick
    another winner (a near tie) and route its error elsewhere: the CPU's
    backward takes the card's winners, every differing winner must be a
    near tie (``NEAR_TIE`` of the input's largest element apart on the
    CPU), and then every parameter and velocity must lie within
    ALEXNET_PARITY_RTOL of its largest element."""
    from veles_torch.config import root
    from veles_torch.znicz.ops.pooling import MaxPooling
    engine = root.common.engine
    saved = (engine.to_dict(), root.imagenet.loader.to_dict())
    engine.compute_dtype = engine.amp = "float32"
    try:
        wf = alexnet_parity_workflow("cuda")
        start = {u: {k: t.clone() for k, t in sub.items()}
                 for u, sub in wf.export_tree().items()}
        loss_cuda = float(wf.step.train_minibatch(
            *first_train_batch(torch, wf))[0])
        pools = [i for i, f in enumerate(wf.forwards)
                 if isinstance(f, MaxPooling)]
        routes = {i: wf.forwards[i].input_offset.cpu() for i in pools}
        card = {u: {k: t.double().cpu() for k, t in sub.items()}
                for u, sub in wf.export_tree().items()}
        wf = alexnet_parity_workflow("cpu")
        wf.import_tree(start)
        data, labels, valid = first_train_batch(torch, wf)
        inputs, last = wf.step._forward(data, True)
        flips = {}
        for i in pools:
            f = wf.forwards[i]
            values = torch.stack([v for _, v in f.taps(inputs[i].float())])
            own, theirs = (values.gather(0, sel[None].long())[0]
                           for sel in (f.input_offset, routes[i]))
            gap = (own - theirs).abs().max().item()
            flips[f.name] = {
                "windows": int((f.input_offset != routes[i]).sum()),
                "gap": gap}
            if gap > NEAR_TIE * inputs[i].abs().max().item():
                fail("alexnet_parity: %s picks winners %.3g apart on the "
                     "card and the CPU" % (f.name, gap))
            f.input_offset = routes[i]
        loss_cpu = float(wf.step.train_backward(inputs, last, labels,
                                                valid)[0])
        cpu = {u: {k: t.double() for k, t in sub.items()}
               for u, sub in wf.export_tree().items()}
    finally:
        engine.update(saved[0])
        root.imagenet.loader.update(saved[1])
    worst, over = {}, []
    for unit, sub in cpu.items():
        for key, want in sub.items():
            e = ((card[unit][key] - want).abs().max()
                 / want.abs().max().clamp_min(1e-30)).item()
            worst["%s.%s" % (unit, key)] = e
            if not e <= ALEXNET_PARITY_RTOL:
                over.append("%s.%s %.3g" % (unit, key, e))
    emit({"phase": "alexnet_parity", "minibatch": int(data.shape[0]),
          "crop": list(data.shape[1:3]), "loss_cuda": loss_cuda,
          "loss_cpu": loss_cpu, "rtol": ALEXNET_PARITY_RTOL,
          "pool_winners_differing": flips,
          "max_rel_err": max(worst.values()), "rel_err": worst})
    if over:
        fail("alexnet_parity: over %g of the largest element: %s"
             % (ALEXNET_PARITY_RTOL, "; ".join(over)))


def first_train_batch(torch, wf):
    """The first train minibatch of ``wf``'s loader on its device, as
    ``TorchStep.train_minibatch`` takes it (``TorchStep.gather``: after
    ``batch_transform``, with the evaluator's target): (data, target,
    valid count)."""
    from veles_torch.loader.base import CLASS_TRAIN
    dev = wf.device.device
    full = wf.loader.device_full_arrays(dev)
    idx_mat, valids = wf.loader.class_schedule(CLASS_TRAIN)
    idx = torch.as_tensor(idx_mat[0], dtype=torch.int64, device=dev)
    return (*wf.step.gather(full, idx, True),
            torch.tensor(int(valids[0]), device=dev))


def profile_step(torch, wf, trace_name, where):
    """One train step of ``wf`` (already run on the card) under
    torch.profiler, after the host-clock time of 5 steps: step ms, device
    busy ms and idle share, device operations, the top operations, and
    the bias-gradient kernel's device launches and ms (one device launch
    per call, or this fails). -> (row, the batch, {device op: (count,
    ms)})."""
    from torch.profiler import ProfilerActivity
    from veles_torch.znicz.ops.bias_grad import bias_grad
    batch = first_train_batch(torch, wf)
    wf.step.train_minibatch(*batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        wf.step.train_minibatch(*batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 5
    reset_counts()
    with counted_window([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                        torch.cuda.synchronize) as prof:
        t0 = time.perf_counter()
        wf.step.train_minibatch(*batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, n_ops, by_name, path = device_trace(prof, trace_name)
    bias = bias_grad_in_trace(by_name, bias_grad.launches, where)
    return {"step_ms": step_ms, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if n_ops else None,
            "device_ops": n_ops, "ops_by_kind": ops_by_kind(by_name),
            "bias_grad": bias,
            "bias_grad_share_of_busy": bias["ms"] / busy_ms if busy_ms
            else None,
            "top_device_ops": top_ops(by_name, 12), "trace": path}, \
        batch, by_name


def check_alexnet(torch):
    """Phases alexnet and alexnet_profile: the AlexNet sample through the
    CLI at full width under the bf16 policy (ALEXNET_RUN: minibatch 128,
    227×227, dropout 0.5, seed 1337), launches counted from 0; losses
    finite and the last train loss below 1.5 times the first (the
    reference's bar, tests/test_image_loader.py); images/s over the warm
    epoch; then one profiled step. -> the run's launch counts."""
    reset_counts()
    wf = cli_run([IMAGENET_SAMPLE, *ALEXNET_RUN, "--seed", "1337", "-d", "cuda"])
    torch.cuda.synchronize()
    TRAINED["alexnet"] = wf
    counts = read_counts()
    check_params_finite(torch, wf, "alexnet")
    train = wf.step.train_steps
    losses = [h["train"]["loss"] for h in wf.decision.history]
    ok, want = conv_launches_ok(counts, train, 7)
    emit({"phase": "alexnet", "train_steps": train,
          "eval_steps": wf.step.eval_steps, "launches": counts,
          "train_loss": losses,
          "validation_error": [h["validation"]["metric"]
                               for h in wf.decision.history],
          "images_per_sec": warm_images_per_sec(wf),
          "epoch_seconds": wf.step.epoch_seconds})
    if not ok:
        fail("alexnet: launches %s, expected %s" % (counts, want))
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 1.5 * losses[0]:
        fail("alexnet: train losses %s" % (losses,))
    row, batch, _ = profile_step(torch, wf, "alexnet_step_trace.json",
                                 "AlexNet step")
    b = batch[0].shape[0]
    emit({"phase": "alexnet_profile", "shape": list(batch[0].shape),
          "images_per_sec_step": b / row["step_ms"] * 1e3, **row})
    return counts


# -- the autoencoders: MnistAE and VideoAE --------------------------------


def f32_policy():
    """Set ``root.common.engine`` to f32 (compute_dtype = amp = float32);
    -> a function that restores it."""
    from veles_torch.config import root
    engine = root.common.engine
    saved = engine.to_dict()
    engine.compute_dtype = engine.amp = "float32"
    return lambda: engine.update(saved)


def rel_errors(card, cpu):
    """{unit.key: max |card − cpu| over max |cpu|} of two export trees
    (host float64)."""
    return {"%s.%s" % (unit, key): (
                (card[unit][key] - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item()
            for unit, sub in cpu.items() for key, want in sub.items()}


def ae_parity(torch, module, seed):
    """One f32 train step of the sample ``module`` on the card and on the
    port's CPU from the same weights and minibatch; -> (loss on each,
    {tensor: error relative to its largest element})."""
    from veles_torch import prng
    restore = f32_policy()
    try:
        trees, losses = {}, {}
        start = None
        for device in ("cuda", "cpu"):
            prng.seed_all(seed)
            wf = module.create_workflow(name="AEParity").initialize(
                device=device)
            if start is None:
                start = {u: {k: t.clone() for k, t in sub.items()}
                         for u, sub in wf.export_tree().items()}
            wf.import_tree(start)
            losses[device] = float(wf.step.train_minibatch(
                *first_train_batch(torch, wf))[0])
            trees[device] = {u: {k: t.double().cpu() for k, t in sub.items()}
                             for u, sub in wf.export_tree().items()}
    finally:
        restore()
    return losses, rel_errors(trees["cuda"], trees["cpu"])


def check_ae(torch, phase, sample, seed):
    """Phases ae and video_ae: the sample through the CLI at the
    reference's own configuration on the port's CPU and on the card, the
    launches counted from 0 just before the card run: the validation MSE
    falls on both, the card's last within max(AE_CPU_RTOL·mse,
    AE_CPU_ATOL) of the CPU's, exactly one masked bias-gradient launch per
    train step and no other kernel; one f32 step card against CPU within
    AE_PARITY_RTOL; one bf16 step under torch.profiler. -> the card run's
    launch counts."""
    import importlib
    path = os.path.join(MODELS, sample)
    mse = {}
    for device in ("cpu", "cuda"):
        reset_counts()
        wf = cli_run([path, "--seed", str(seed), "-d", device])
        if device == "cuda":
            torch.cuda.synchronize()
        counts = read_counts()
        check_params_finite(torch, wf, "%s %s" % (phase, device))
        mse[device] = [h["validation"]["metric"]
                       for h in wf.decision.history]
    TRAINED[phase] = wf
    train = wf.step.train_steps
    want = dict({name: 0 for name in counts}, **{"bias_grad[masked]": train})
    module = importlib.import_module(
        "veles_torch.znicz.models." + sample[:-3])
    losses, errors = ae_parity(torch, module, seed)
    row, batch, _ = profile_step(torch, wf, "%s_step_trace.json" % phase,
                                 "%s step" % phase)
    cpu, card = mse["cpu"][-1], mse["cuda"][-1]
    bound = max(AE_CPU_RTOL * cpu, AE_CPU_ATOL)
    emit({"phase": phase, "train_steps": train,
          "eval_steps": wf.step.eval_steps, "launches": counts,
          "validation_mse_cuda": mse["cuda"],
          "validation_mse_cpu": mse["cpu"], "cpu_bound": bound,
          "images_per_sec": warm_images_per_sec(wf),
          "epoch_seconds": wf.step.epoch_seconds,
          "parity_loss": losses, "parity_rtol": AE_PARITY_RTOL,
          "parity_max_rel_err": max(errors.values()),
          "parity_rel_err": errors})
    emit({"phase": phase + "_profile", "shape": list(batch[0].shape),
          **row})
    if counts != want:
        fail("%s: launches %s, expected %s" % (phase, counts, want))
    for device, hist in mse.items():
        if not hist[-1] < hist[0]:
            fail("%s: the validation MSE did not fall on %s: %s"
                 % (phase, device, hist))
    if not abs(card - cpu) <= bound:
        fail("%s: final validation MSE %.6g on cuda vs %.6g on cpu"
             % (phase, card, cpu))
    over = {k: e for k, e in errors.items() if not e <= AE_PARITY_RTOL}
    if over:
        fail("%s: f32 step over %g of the largest element: %s"
             % (phase, AE_PARITY_RTOL, over))
    return counts


#: the unit checks: (forward class, its kwargs, input shape); a strided
#: deconvolution with unequal padding (the stride remainders at the
#: bottom and right) and depooling with overlapping windows onto a
#: cropped output
AE_UNIT_CASES = (
    ("Deconv", dict(n_kernels=16, kx=4, ky=5, sliding=(2, 3),
                    padding=(2, 1, 1, 2), n_channels=8), (16, 12, 10, 16)),
    ("Depooling", dict(kx=3, ky=3, sliding=2,
                       output_shape_source=(None, 24, 24, 9)),
     (16, 12, 12, 9)),
)


def unit_step(torch, cls, kwargs, shape, device, x, err, start):
    """Forward and GD (learning rate 1) of one unit on ``device`` from the
    weights ``start`` (or its own when None); -> (output, err_input,
    weights or None)."""
    from veles_torch.backends import TorchDevice
    from veles_torch.znicz.nn_units import gradient_unit_for
    fwd = cls(**kwargs)
    fwd.initialize(shape, TorchDevice(device))
    if start is not None:
        fwd.weights = start.to(device)
    gd = gradient_unit_for(cls)(learning_rate=1.0).setup_forward(fwd)
    gd.initialize()
    x, err = x.to(device), err.to(device)
    y = fwd(x)
    ei = gd.run(x, y, err)
    return y, ei, fwd.weights


def check_ae_units(torch):
    """Phase ae_units: Deconv/GDDeconv and Depooling/GDDepooling on the
    card, f32 with TF32 off, against the port's CPU path from the same
    input, error and weights: the output, err_input and updated weights
    within AE_UNIT_RTOL of the largest element, and two launches on the
    card equal bit for bit."""
    from veles_torch.backends import TorchDevice
    from veles_torch.znicz.ops import deconv
    restore = f32_policy()
    try:
        gen = torch.Generator().manual_seed(1337)
        for name, kwargs, shape in AE_UNIT_CASES:
            cls = getattr(deconv, name)
            x = torch.randn(shape, generator=gen)
            probe = cls(**kwargs)
            err = torch.randn(probe.initialize(shape, TorchDevice("cpu")),
                              generator=gen)
            start = probe.weights
            cpu = unit_step(torch, cls, kwargs, shape, "cpu", x, err, start)
            card = [unit_step(torch, cls, kwargs, shape, "cuda", x, err,
                              start) for _ in range(2)]
            torch.cuda.synchronize()
            if torch.backends.cuda.matmul.allow_tf32 \
                    or torch.backends.cudnn.allow_tf32:
                fail("ae_units: TF32 is on")
            errors, bitwise = {}, True
            for part, a, b, want in zip(("output", "err_input", "weights"),
                                        card[0], card[1], cpu):
                if want is None:
                    continue
                bitwise = bitwise and torch.equal(a, b)
                errors[part] = max_rel(a, want)
            emit({"phase": "ae_units", "unit": name, "kwargs": kwargs,
                  "input": list(shape),
                  "rel_err": errors, "rtol": AE_UNIT_RTOL,
                  "bitwise_repeat": bitwise})
            if not bitwise:
                fail("ae_units %s: two launches differ" % name)
            over = {k: e for k, e in errors.items() if not e <= AE_UNIT_RTOL}
            if over:
                fail("ae_units %s: over %g: %s" % (name, AE_UNIT_RTOL, over))
    finally:
        restore()


# -- serving: the predict and decode planes on the card ---------------------


def no_launches(name):
    """Read the kernel counts after a serving phase (set to 0 before it):
    serving runs none of the hand-written kernels; -> the counts."""
    counts = read_counts()
    if any(counts.values()):
        fail("%s launched hand-written kernels: %s" % (name, counts))
    return counts


def max_rel(got, want):
    """max |got − want| over max |want|, as floats on the host."""
    import numpy
    got, want = (numpy.asarray(t.cpu() if hasattr(t, "cpu") else t,
                               numpy.float64) for t in (got, want))
    return float(numpy.abs(got - want).max()
                 / max(numpy.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def archive_dir(name):
    """A fresh directory for one exported archive (removed at exit)."""
    import atexit
    import shutil
    import tempfile
    path = tempfile.mkdtemp(prefix="chip_smoke_%s_" % name)
    atexit.register(shutil.rmtree, path, True)
    return path


def train_forward_f32(torch, wf, x):
    """The port's training forward of ``wf`` in eval mode with its
    device's dtype policy set to f32 for the call."""
    dev = wf.device
    saved = (dev.compute_dtype, dev.act_dtype)
    dev.compute_dtype = dev.act_dtype = torch.float32
    try:
        with torch.no_grad():
            return wf.step._forward(x, False)[1].float()
    finally:
        dev.compute_dtype, dev.act_dtype = saved


def serving_rows(wf):
    """64 rows of ``wf``'s data as its first forward takes them (the
    eval transform on the card for AlexNet)."""
    dev = wf.device.device
    data = wf.loader.device_full_arrays(dev)["data"][:64]
    return wf.loader.batch_transform(data, False).float()


def serve_one(torch, name):
    """Phase serve_predict for one trained workflow: export, load on the
    card and on the CPU, every bucket of an InferenceEngine(max_batch=64)
    against the training forward, pad rows, and the MicroBatcher under
    concurrent clients; -> the summary row."""
    import threading
    import numpy
    from veles_torch.serving import (ArchiveModel, InferenceEngine,
                                     MicroBatcher)
    from veles_torch.serving.engine import bucket_sizes
    wf = TRAINED[name]
    path = archive_dir(name)
    t0 = time.perf_counter()
    wf.export_inference(path)
    export_s = time.perf_counter() - t0
    model = ArchiveModel.from_dir(path)
    if model.device.type != "cuda":
        fail("serve_predict %s: the ArchiveModel is on %s" % (name,
                                                             model.device))
    engine = InferenceEngine(model, max_batch=64)
    first_run = engine.warmup()
    rows = serving_rows(wf)
    want = train_forward_f32(torch, wf, rows)
    host = rows.cpu().numpy()
    worst, buckets, over = {}, {}, []
    for b in bucket_sizes(64):
        out, bucket = engine.predict(host[:b])
        e = max_rel(out, want[:b])
        worst[b] = e
        if bucket != b or not e <= SERVE_RTOL:
            over.append("bucket %d (got %d): %.3g" % (b, bucket, e))
        reps = 5 if name == "alexnet" else 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.predict(host[:b])
        ms = 1e3 * (time.perf_counter() - t0) / reps
        buckets[b] = {"ms": ms, "rows_per_sec": b / ms * 1e3}
    # pad rows: 3 rows in bucket 4 against each row alone (bucket 1)
    padded = engine.predict(host[:3])[0]
    alone = numpy.concatenate([engine.predict(host[i:i + 1])[0]
                               for i in range(3)])
    pad_err = max_rel(padded, alone)
    cpu = ArchiveModel.from_dir(path, device="cpu")
    n_cpu = 2 if name == "alexnet" else 64
    cpu_err = max_rel(engine.predict(host[:n_cpu])[0], cpu(host[:n_cpu]))
    batcher = MicroBatcher(engine.predict, max_batch=64, max_wait_ms=2.0,
                           default_timeout_ms=60000.0)
    results, errors = {}, []

    def client(c):
        try:
            for r in range(SERVE_REQUESTS):
                i = (c * SERVE_REQUESTS + r) % 64
                results[(c, r)] = (i, batcher.predict(host[i:i + 1]))
        except Exception as exc:        # reported below, fails the phase
            errors.append("%s: %s" % (type(exc).__name__, exc))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batch_s = time.perf_counter() - t0
    batcher.close()
    metrics = batcher.metrics()
    batch_err = max((max_rel(out, want[i:i + 1])
                     for i, out in results.values()), default=None)
    row = {"model": name, "input_sample_shape": list(model.input_sample_shape),
           "export_seconds": export_s, "first_run_seconds": first_run,
           "max_rel_err_vs_train_forward": max(worst.values()),
           "rel_err_by_bucket": worst, "pad_rows_rel_err": pad_err,
           "cpu_rel_err": cpu_err, "cpu_rows": n_cpu, "buckets": buckets,
           "batcher": {"clients": SERVE_CLIENTS,
                       "requests": SERVE_CLIENTS * SERVE_REQUESTS,
                       "seconds": batch_s,
                       "requests_per_sec": len(results) / batch_s,
                       "max_rel_err": batch_err, **metrics}}
    if over or errors or len(results) != SERVE_CLIENTS * SERVE_REQUESTS:
        fail("serve_predict %s: %s" % (name, "; ".join(over + errors)
                                       or "requests lost"))
    if not (pad_err <= SERVE_RTOL and cpu_err <= SERVE_RTOL
            and batch_err <= SERVE_RTOL):
        fail("serve_predict %s: pad rows %.3g, cpu %.3g, batcher %.3g over "
             "%g" % (name, pad_err, cpu_err, batch_err, SERVE_RTOL))
    return row


def check_serve_predict(torch):
    """Phase serve_predict: the MNIST, AlexNet and MnistAE workflows the
    earlier phases trained, exported and served on the card (see
    serve_one), the kernels' counts set to 0 just before and read just
    after; -> the counts."""
    reset_counts()
    rows = [serve_one(torch, name) for name in ("mnist", "alexnet", "ae")]
    torch.cuda.synchronize()
    counts = no_launches("serve_predict")
    for row in rows:
        emit({"phase": "serve_predict", "launches": counts, **row})
    return counts


def periodic_prompts(n, vocab, lengths, seed=4242):
    """``n`` prompts of the LM corpus' kind (a random pattern of period 2
    to 8 repeated) with lengths drawn from ``lengths`` = (lo, hi)."""
    import numpy
    rng = numpy.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = int(rng.integers(lengths[0], lengths[1] + 1))
        pattern = rng.integers(0, vocab, int(rng.integers(2, 9)))
        out.append(numpy.tile(pattern, size // len(pattern) + 1)[:size]
                   .tolist())
    return out


def first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def top2_gap(logits):
    top = logits.float().topk(2).values
    return float(top[0] - top[1])


def greedy_vs_generate(torch, wf, model, batcher, prompts, n_new):
    """Greedy continuous decode of ``prompts`` (submitted together)
    against the port's generate() on ``wf``, token for token; where the
    two first differ, the top-two gap of the full forward's logits
    there; -> [(prompt length, first differing index or None, gap)]."""
    from veles_torch.znicz.generate import generate
    handles = [batcher.submit(p, max_tokens=n_new) for p in prompts]
    got = [h.wait(600) for h in handles]
    out = []
    for p, toks in zip(prompts, got):
        want = generate(wf, [p], n_new)[0].tolist()
        i = first_divergence(toks, want)
        gap = None
        if i is not None:
            with torch.no_grad():
                logits = model([p + want[:i]])[0, -1]
            gap = top2_gap(logits) / float(logits.abs().max())
        out.append((len(p), i, gap))
    return out


def decode_throughput(torch, batcher, prompts, n_new):
    """Tokens/s with every prompt submitted at once (continuous) and one
    at a time (sequential), first-token latencies of the continuous run;
    -> dict."""
    import numpy
    t0 = time.perf_counter()
    handles = [batcher.submit(p, max_tokens=n_new) for p in prompts]
    toks = [h.wait(600) for h in handles]
    cont_s = time.perf_counter() - t0
    first = [1e3 * (h.t_first - h.t_submit) for h in handles]
    t0 = time.perf_counter()
    for p in prompts:
        batcher.generate(p, max_tokens=n_new, wait_s=600)
    seq_s = time.perf_counter() - t0
    n = sum(len(t) for t in toks)
    if n != len(prompts) * n_new:
        fail("serve_decode: %d tokens for %d requests" % (n, len(prompts)))
    return {"requests": len(prompts), "new_tokens": n_new,
            "continuous_seconds": cont_s,
            "tokens_per_sec_continuous": n / cont_s,
            "sequential_seconds": seq_s,
            "tokens_per_sec_sequential": n / seq_s,
            "first_token_ms_p50": float(numpy.median(first)),
            "first_token_ms_max": float(max(first))}


def step_ms(torch, engine, reps=30):
    """One decode step over every slot (positions mid-pool), by the host
    clock over ``reps`` steps (each ends in the token copy to the
    host)."""
    import numpy
    n = engine.pool.n_slots
    tokens = numpy.arange(n, dtype=numpy.int32)
    pos = numpy.full(n, engine.max_len // 2, numpy.int32)
    temp = numpy.zeros(n, numpy.float32)
    engine.step(tokens, pos, temp)
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.step(tokens, pos, temp)
    return 1e3 * (time.perf_counter() - t0) / reps


def profile_decode_step(torch, engine, trace_name, reps=3):
    """``reps`` decode steps over every slot under torch.profiler: wall
    and device-busy ms per step, idle share, device operations per step,
    by kind and the largest (trace in the output directory)."""
    import numpy
    from torch.profiler import ProfilerActivity
    n = engine.pool.n_slots
    tokens = numpy.arange(n, dtype=numpy.int32)
    pos = numpy.full(n, engine.max_len // 2, numpy.int32)
    temp = numpy.zeros(n, numpy.float32)
    engine.step(tokens, pos, temp)
    torch.cuda.synchronize()
    with counted_window([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                        torch.cuda.synchronize) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.step(tokens, pos, temp)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    busy_ms, n_ops, by_name, path = device_trace(prof, trace_name)
    busy_ms /= reps
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": n_ops / reps,
            "ops_by_kind": {k: [c / reps, t / reps] for k, (c, t) in
                            ops_by_kind(by_name).items()},
            "top_device_ops": top_ops(by_name, 10), "trace": path}


def prefill_ms(torch, engine, prompt, reps=5):
    """A warm prefill of ``prompt`` into slot 0, by the host clock (each
    ends in the first token's copy to the host)."""
    engine.prefill_into(0, prompt, 0.0)
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.prefill_into(0, prompt, 0.0)
    return 1e3 * (time.perf_counter() - t0) / reps


def decode_sample(torch):
    """serve_decode (1): the LM sample phase lm trained on the card,
    exported and decoded greedily through a ContinuousBatcher on the card
    and on the CPU, two concurrent prompts of different lengths, against
    generate() on the card, token for token."""
    from veles_torch.serving import (ArchiveModel, ContinuousBatcher,
                                     GenerativeEngine)
    from veles_torch.znicz.generate import generate
    wf = TRAINED["lm_sample"]
    path = archive_dir("lm_sample")
    wf.export_inference(path)
    prompts = ([1, 2, 3, 4, 5, 1, 2, 3], [5, 6, 5])
    got = {}
    for dev in ("cuda", "cpu"):
        engine = GenerativeEngine(ArchiveModel.from_dir(path, device=dev),
                                  n_slots=DECODE_SLOTS, max_len=256,
                                  device=dev)
        batcher = ContinuousBatcher(engine)
        try:
            handles = [batcher.submit(p, max_tokens=24) for p in prompts]
            got[dev] = [h.wait(600) for h in handles]
        finally:
            batcher.close()
        if engine.pool.in_use:
            fail("serve_decode sample: %d slots in use after the run on %s"
                 % (engine.pool.in_use, dev))
    want = [generate(wf, [p], 24)[0].tolist() for p in prompts]
    row = {"run": "sample", "tokens_cuda": got["cuda"],
           "tokens_cpu": got["cpu"], "generate_cuda": want,
           "max_len": engine.max_len}
    if not got["cuda"] == want == got["cpu"]:
        fail("serve_decode sample: continuous decode %s on cuda, %s on cpu, "
             "generate() %s" % (got["cuda"], got["cpu"], want))
    return row


def decode_110m(torch):
    """serve_decode (2, 3): the 110M LM phase lm trained, exported and
    decoded on the card with DECODE_SLOTS slots of DECODE_MAX_LEN
    positions: the first step's logits against a full forward, greedy
    tokens against generate() except at near ties, throughput continuous
    and sequential, the step's ms; then the same with int8 and fp8
    weights at rest (bytes, tokens/s, post-softmax parity against f32 and
    the greedy tokens along the strong prefix); -> [rows]."""
    import numpy
    from veles_torch.serving import (ArchiveModel, ContinuousBatcher,
                                     GenerativeEngine)
    from veles_torch.serving.quant import quantize_tree, tree_nbytes
    wf = TRAINED["lm_110M"]
    path = archive_dir("lm_110M")
    t0 = time.perf_counter()
    wf.export_inference(path)
    export_s = time.perf_counter() - t0
    vocab = wf.forwards[0].vocab_size
    prompts = periodic_prompts(DECODE_REQUESTS, vocab, DECODE_PROMPT)
    rows, f32 = [], {}
    for mode in ("none", "int8", "fp8"):
        model = ArchiveModel.from_dir(path)
        f32_bytes = tree_nbytes(model.params)
        model.params = quantize_tree(model.params, mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        engine = GenerativeEngine(model, n_slots=DECODE_SLOTS,
                                  max_len=DECODE_MAX_LEN)
        warm = engine.warmup([64, 128, 256])
        row = {"run": "110M", "quantize": mode, "export_seconds": export_s,
               "at_rest_bytes": tree_nbytes(model.params),
               "at_rest_share_of_f32": tree_nbytes(model.params) / f32_bytes,
               "kv_pool_bytes": engine.pool.nbytes(),
               "slots": DECODE_SLOTS, "max_len": engine.max_len,
               "first_run_seconds": warm}
        # the first decode step's logits against a full forward
        p = prompts[0]
        tok = engine.prefill_into(0, p, 0.0)
        n = engine.pool.n_slots
        toks = numpy.zeros(n, numpy.int32)
        pos = numpy.zeros(n, numpy.int32)
        toks[0], pos[0] = tok, len(p)
        step = engine.logits(toks, pos)[0]
        with torch.no_grad():
            full = model([p + [tok]])[0, -1]
        row["first_step_logits_rel_err"] = max_rel(step, full)
        batcher = ContinuousBatcher(engine, max_queue=DECODE_REQUESTS)
        try:
            if mode == "none":
                pairs = greedy_vs_generate(torch, wf, model, batcher,
                                           prompts[:2], DECODE_NEW)
                row["greedy_vs_generate"] = [
                    {"prompt": a, "first_differing": i, "top2_gap": g}
                    for a, i, g in pairs]
                for a, i, g in pairs:
                    if i is not None and not g <= LOGIT_RTOL:
                        fail("serve_decode 110M: greedy tokens differ from "
                             "generate() at %d of a %d-token prompt, top-two "
                             "gap %.3g (no near tie)" % (i, a, g))
            row.update(decode_throughput(torch, batcher, prompts,
                                         DECODE_NEW))
            if mode == "none":
                SERVE_DECODE_ROW.update(row)
            chain = batcher.generate(p, max_tokens=DECODE_NEW, wait_s=600)
        finally:
            batcher.close()
        if engine.pool.in_use:
            fail("serve_decode 110M: %d slots in use after the run"
                 % engine.pool.in_use)
        row["decode_step_ms"] = step_ms(torch, engine)
        row["prefill_ms"] = {n: prefill_ms(torch, engine, [1] * n)
                             for n in (64, 256)}
        row["decode_step_profile"] = profile_decode_step(
            torch, engine, "decode_step_trace_%s.json" % mode)
        row["kv_pool_bytes_reported"] = engine.pool.nbytes()
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        row["memory_allocated_before_engine"] = base
        # teacher-forced logits along the f32 greedy chain
        if mode == "none":
            f32 = {"chain": chain}
        with torch.no_grad():
            seq = p + f32["chain"][:-1]
            logits = model([seq])[0, len(p) - 1:].float()
        probs = torch.softmax(logits, -1)
        if mode == "none":
            f32.update(logits=logits, probs=probs)
        else:
            prob_diff = float((probs - f32["probs"]).abs().max())
            logit_diff = float((logits - f32["logits"]).abs().max())
            top2 = f32["logits"].topk(2, dim=-1).values
            strong = (top2[:, 0] - top2[:, 1] > 2 * logit_diff).tolist()
            agree = 0
            for i, s in enumerate(strong):
                if not s:
                    break
                if chain[i] != f32["chain"][i]:
                    fail("serve_decode 110M %s: greedy token %d differs from "
                         "f32 at a strong margin" % (mode, i))
                agree += 1
            row.update(prob_max_abs_diff=prob_diff,
                       logit_max_abs_diff=logit_diff,
                       strong_prefix_tokens_agreeing=agree)
            if not prob_diff < QUANT_PROB_ATOL:
                fail("serve_decode 110M %s: probabilities %.3g from f32 "
                     "(bound %g)" % (mode, prob_diff, QUANT_PROB_ATOL))
        if not row["first_step_logits_rel_err"] <= LOGIT_RTOL:
            fail("serve_decode 110M %s: first step's logits %.3g from the "
                 "full forward" % (mode, row["first_step_logits_rel_err"]))
        rows.append(row)
        del engine, batcher, model
    return rows


def check_serve_decode(torch):
    """Phase serve_decode: decode_sample and decode_110m, the kernels'
    counts set to 0 just before and read just after; -> the counts."""
    reset_counts()
    rows = [decode_sample(torch)] + decode_110m(torch)
    torch.cuda.synchronize()
    counts = no_launches("serve_decode")
    for row in rows:
        emit({"phase": "serve_decode", "launches": counts, **row})
    return counts


# -- the LM as its users configure it: solvers, the scan, the stack, the --
# -- text corpus, the MoE FFN ----------------------------------------------

#: AdamW (beta1 0.9) under a warmup-cosine schedule over the 110M run's 16
#: train steps
ADAM_RUN = ("root.lm.train.solver=adam", "root.lm.train.learning_rate=0.001",
            "root.lm.train.gradient_moment=0.9",
            "root.lm.train.lr_policy={'name': 'warmup_cosine', "
            "'warmup': 4, 'total': 16}")
#: one f32 AdamW step of a small LM (the sample's width, S 32, attn_block
#: 16: the scan on both sides, under the auto threshold) on the card
#: against the port's CPU from the same weights and minibatch: every
#: parameter, ``vel_*`` and ``sq_*`` within this share of its largest
#: element (f32 sums in another order, as ALEXNET_PARITY_RTOL). adam_eps
#: 1e-2 keeps AdamW's step well conditioned: at 1e-8 the attention's key
#: bias, whose gradient is 0 in exact arithmetic, moves by ±lr with the
#: sign of each device's rounding noise (0.08 of its largest element
#: apart on an NVIDIA H100), as in tests/test_torch_solvers.py
LM_PARITY_RTOL = 1e-4
LM_PARITY_RUN = ("root.lm.loader.n_train=256", "root.lm.loader.n_valid=64",
                 "root.lm.model.attn_block=16", "root.lm.train.solver=adam",
                 "root.lm.train.learning_rate=0.002",
                 "root.lm.train.gradient_moment=0.9",
                 "root.lm.train.adam_eps=0.01")
#: the LM sample's width and corpus (S 32, 8 epochs, 256 train steps)
#: under AdamW and warmup-cosine, with attn_block 16 (the auto policy: the
#: scan on the card below PALLAS_AUTO_MIN_S), per-layer and stacked: the
#: validation loss falls. At the 110M width the 16 train steps lower the
#: train loss only: the validation windows hold random tokens of a
#: 16384-word vocabulary the run never saw (phase lm says the same)
SAMPLE_ADAM_RUN = ("root.lm.train.solver=adam",
                   "root.lm.train.learning_rate=0.003",
                   "root.lm.train.gradient_moment=0.9",
                   "root.lm.train.lr_policy={'name': 'warmup_cosine', "
                   "'warmup': 16, 'total': 256}")
#: the auto policy's table: (S, minibatch) of the 110M widths' train step
#: at POLICY_LAYERS of its 12 layers (cut from 12: see PARALLEL_LAYERS),
#: the scan against the kernels by the host clock, POLICY_STEPS steps after
#: a warm one, in turns (scan, kernels, kernels, scan)
POLICY_SHAPES = ((512, 8), (1024, 8), (2048, 8), (8192, 4))
POLICY_LAYERS = 4
POLICY_STEPS = 3
#: steps a host-clock step time averages over (lm_adam, lm_stack)
STEPS_TIMED = 5
#: the scan's block: LM_ROWS' attn_block
SCAN_BLOCK = 256
#: the stacked 110M: one transformer_stack unit of 12 blocks, dense
#: attention inside (the reference refuses attn_block there)
LM_110M_STACKED = tuple(o for o in LM_110M if "attn_block" not in o) + (
    "root.lm.model.stacked=True",)
#: the README's text-LM command on the repo's SURVEY.md (a file no change
#: edits): the default root.lm model, AdamW, warmup-cosine over 24 epochs
#: of 17 steps. At lr 0.01 the bf16 policy leaves the characters' unigram
#: plateau (3.5) some 8 epochs after f32 does (2.90 on an NVIDIA H100
#: against 2.48 on the CPU after 40 epochs; 2.88 with the bf16 policy on
#: the CPU); at 0.003 both leave it together (2.67 bf16 and
#: 2.69 f32 on the CPU, under two thread counts) and write words
TEXT_CORPUS = os.path.join(HERE, "SURVEY.md")
TEXT_RUN = ("root.lm.loader.text_file=%r" % TEXT_CORPUS,
            "root.lm.decision.max_epochs=24",
            "root.lm.train.solver=adam", "root.lm.train.learning_rate=0.003",
            "root.lm.train.gradient_moment=0.9",
            "root.lm.train.lr_policy={'name': 'warmup_cosine', "
            "'warmup': 20, 'total': 408}")
TEXT_PROMPT, TEXT_TOKENS = "The ", 64
#: the MoE FFN at the 110M width (dim 768, ffn 3072, 12 heads, S 512,
#: minibatch 8), 8 experts of capacity factor 2 and aux weight 0.01, its
#: depth cut from 12 to 4 layers
LM_110M_MOE = LM_110M + ("root.lm.model.layers=4",
                         "root.lm.model.moe_experts=8",
                         "root.lm.model.moe_capacity_factor=2.0",
                         "root.lm.model.moe_aux_weight=0.01")
#: the MoE run's drops, card against CPU: the sample's width with 4
#: experts at capacity factor 1 (tokens dropped), f32
MOE_SMALL = ("root.lm.loader.n_train=256", "root.lm.loader.n_valid=64",
             "root.lm.model.moe_experts=4",
             "root.lm.model.moe_capacity_factor=1.0")


def build_lm(*overrides, device="cuda", seed=1337, name="LM"):
    """The LM sample with ``overrides`` applied after its defaults (and
    ``root.lm.train`` emptied first), initialized on ``device``."""
    from veles_torch import prng
    from veles_torch.config import root
    from veles_torch.znicz.models import transformer_lm as tlm
    root.lm.train = {}
    root.lm.update(tlm.DEFAULTS)
    for override in overrides:
        root.apply_override(override)
    prng.seed_all(seed)
    return tlm.create_workflow(name=name).initialize(device=device)


def host_tree(wf):
    return {u: {k: t.double().cpu() for k, t in sub.items()}
            for u, sub in wf.export_tree().items()}


def f32_step_parity(torch, overrides, name):
    """One f32 train step of the LM of ``overrides`` on the card and on the
    port's CPU from the same weights and minibatch -> ({tensor: error
    relative to its largest element}, losses)."""
    restore = f32_policy()
    try:
        trees, losses, start = {}, {}, None
        for device in ("cuda", "cpu"):
            wf = build_lm(*overrides, device=device, name=name)
            if start is None:
                start = {u: {k: t.clone() for k, t in sub.items()}
                         for u, sub in wf.export_tree().items()}
            wf.import_tree(start)
            losses[device] = float(wf.step.train_minibatch(
                *first_train_batch(torch, wf))[0])
            trees[device] = host_tree(wf)
    finally:
        restore()
    return rel_errors(trees["cuda"], trees["cpu"]), losses


def accumulation_steps(torch):
    """Two train steps of the 110M under AdamW with accumulate_gradient=2:
    no parameter moves on the first, every one on the second; ->
    summary."""
    wf = build_lm(*LM_110M, *ADAM_RUN, "root.lm.train.accumulate_gradient=2",
                  name="Accumulate")
    batch = first_train_batch(torch, wf)
    params = [(f.name, k, t) for f in wf.forwards
              for k, t in f.export_params().items()]
    before = [t.clone() for _, _, t in params]
    moved = []
    for _ in range(2):
        wf.step.train_minibatch(*batch)
        torch.cuda.synchronize()
        now = [t for f in wf.forwards for t in f.export_params().values()]
        moved.append(sum(not torch.equal(a, b) for a, b in zip(before, now)))
    counts = sorted({int(g.acc_count) for g in wf.gds
                     if g.acc_count is not None})
    if moved != [0, len(params)] or counts != [0]:
        fail("lm_adam accumulate 2: %s of %d parameters moved on each call, "
             "acc_count %s" % (moved, len(params), counts))
    return {"parameters": len(params), "moved_per_call": moved}


def check_lm_adam(torch):
    """Phase lm_adam: the 110M row as bench.py configures it (attn_block
    256, no attn_impl: the auto policy) under AdamW and a warmup-cosine
    schedule through the CLI, launches from 0 as the resolved mode implies;
    every parameter and solver tensor finite, the train loss falls (the
    validation loss in a run at the sample's width, SAMPLE_ADAM_RUN); one
    accumulation pair; the f32 step card vs CPU; the step's time split
    beside the momentum 110M's. -> the 110M run's counts."""
    from veles_torch.config import root
    _, sample, _ = run_lm(torch, "sample_adam", "cuda",
                          "root.lm.model.attn_block=16", *SAMPLE_ADAM_RUN,
                          impl=None, phase="lm_adam")
    wf, counts, summary = run_lm(torch, "110M_adam", "cuda", *LM_110M,
                                 *ADAM_RUN, impl=None, phase="lm_adam",
                                 valid_must_fall=False)
    sq = [k for sub in wf.export_tree().values() for k in sub
          if k.startswith("sq_")]
    if not sq or summary["attention_mode"] != expected_auto_mode(512):
        fail("lm_adam: %d second moments, attention mode %s"
             % (len(sq), summary["attention_mode"]))
    accumulate = accumulation_steps(torch)
    errors, losses = f32_step_parity(torch, LM_PARITY_RUN, "AdamParity")
    worst = max(errors, key=errors.get)
    momentum_wf = TRAINED["lm_110M"]
    batch = first_train_batch(torch, wf)
    turns = {"adam": [], "momentum": []}
    for name in ("adam", "momentum", "momentum", "adam"):
        run = wf if name == "adam" else momentum_wf
        turns[name].append(time_steps(torch, run, batch))
    adam, _, _ = profile_step(torch, wf, "lm_adam_step_trace.json",
                              "110M adam step")
    momentum, _, _ = profile_step(torch, momentum_wf,
                                  "lm_momentum_step_trace.json",
                                  "110M momentum step")
    root.lm.train = {}
    emit({"phase": "lm_adam", "card": card_line(), "launches": counts,
          "sample_launches": sample,
          "second_moments": len(sq), "accumulate_2": accumulate,
          "f32_parity": {"losses": losses, "worst": worst,
                         "worst_rel_err": errors[worst],
                         "bound": LM_PARITY_RTOL},
          "step_ms_in_turns": turns,
          "adam_step": adam, "momentum_step": momentum,
          "adam_extra_ms": adam["step_ms"] - momentum["step_ms"],
          "adam_extra_device_ops": adam["device_ops"]
          - momentum["device_ops"]})
    if not errors[worst] <= LM_PARITY_RTOL:
        fail("lm_adam f32 step: %s %.3g from the CPU (bound %g)"
             % (worst, errors[worst], LM_PARITY_RTOL))
    TRAINED["lm_adam"] = wf
    return counts


def expected_auto_mode(s):
    """What the auto policy resolves to on the card at sequence ``s``."""
    from veles_torch.znicz.ops.attention import MultiHeadAttention
    return "pallas" if s >= MultiHeadAttention.PALLAS_AUTO_MIN_S else "scan"


def scan_vs_kernels(torch):
    """The scan and the kernels from the same bf16 inputs at FLASH_MAIN,
    causal: out, dq, dk, dv held to each other by scaled_err within
    FLASH_VS_PLAIN_TOL["bfloat16"]; -> {tensor: scaled error}."""
    from veles_torch.backends import TorchDevice
    from veles_torch.znicz.ops import flash_attention as FA
    from veles_torch.znicz.ops import scan_attention as SA
    q, k, v, dout = flash_inputs(torch, FLASH_MAIN, torch.bfloat16)
    dot = TorchDevice("cuda").dot
    out, lse = SA.blocked_attention_fwd(q, k, v, block=SCAN_BLOCK, dot=dot)
    grads = SA.blocked_attention_bwd(q, k, v, out, lse, dout,
                                     block=SCAN_BLOCK, dot=dot)
    fout, flse = FA.flash_attention_fwd(q, k, v, causal=True)
    fgrads = FA.flash_attention_bwd(q, k, v, fout, flse, dout, causal=True)
    errs = {name: scaled_err(a, b) for name, a, b in zip(
        ("out", "dq", "dk", "dv"), (out, *grads), (fout, *fgrads))}
    errs["lse_max_abs"] = float((lse - flse).abs().max())
    tol = FLASH_VS_PLAIN_TOL["bfloat16"]
    if not all(e <= tol for n, e in errs.items() if n != "lse_max_abs") \
            or not errs["lse_max_abs"] <= LSE_ATOL:
        fail("attn_policy: scan vs kernels %s (bounds %g, lse %g)"
             % (errs, tol, LSE_ATOL))
    return errs


def check_attn_policy(torch):
    """Phase attn_policy: the 110M train step by the host clock with
    attn_impl "scan" and "pallas" (the kernels) at each POLICY_SHAPES
    entry, in turns on one workflow per shape; the threshold the table
    implies (the smallest S from which the kernels win at every larger S)
    beside PALLAS_AUTO_MIN_S; the scan against the kernels on one input.
    -> the counts (the kernels' turns)."""
    from veles_torch.znicz.ops.attention import MultiHeadAttention
    agree = scan_vs_kernels(torch)
    reset_counts()
    rows, steps = [], 0
    for s, b in POLICY_SHAPES:
        wf = build_lm(*LM_110M, "root.lm.loader.seq_len=%d" % s,
                      "root.lm.model.layers=%d" % POLICY_LAYERS,
                      "root.lm.loader.minibatch_size=%d" % b,
                      "root.lm.loader.n_train=%d" % (2 * b),
                      "root.lm.loader.n_valid=%d" % b, name="Policy")
        batch = first_train_batch(torch, wf)
        attn = [f for f in wf.forwards if isinstance(f, MultiHeadAttention)]
        layers = len(attn)
        times = {"scan": [], "pallas": []}
        for impl in ("scan", "pallas", "pallas", "scan"):
            for f in attn:
                f.attn_impl = impl
            wf.step.train_minibatch(*batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(POLICY_STEPS):
                wf.step.train_minibatch(*batch)
            torch.cuda.synchronize()
            times[impl].append(1e3 * (time.perf_counter() - t0)
                               / POLICY_STEPS)
            steps += POLICY_STEPS + 1
        scan_ms, kernel_ms = (sum(times[m]) / 2 for m in ("scan", "pallas"))
        rows.append({"seq_len": s, "minibatch": b, "scan_ms": scan_ms,
                     "kernels_ms": kernel_ms, "turns_ms": times,
                     "kernels_faster": kernel_ms < scan_ms,
                     "tokens_per_sec_scan": b * s / scan_ms * 1e3,
                     "tokens_per_sec_kernels": b * s / kernel_ms * 1e3})
        del wf, batch, attn
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = read_counts()
    kernel_steps = layers * len(POLICY_SHAPES) * 2 * (POLICY_STEPS + 1)
    want = dict.fromkeys(counts, 0)
    want.update({"flash_fwd": kernel_steps, "flash_bwd_fused": kernel_steps,
                 "bias_grad[identity]": steps * (6 * layers + 1)})
    threshold = None
    for row in reversed(rows):
        if not row["kernels_faster"]:
            break
        threshold = row["seq_len"]
    emit({"phase": "attn_policy", "card": card_line(), "table": rows,
          "measured_threshold": threshold,
          "PALLAS_AUTO_MIN_S": MultiHeadAttention.PALLAS_AUTO_MIN_S,
          "scan_vs_kernels": agree, "launches": counts})
    if counts != want:
        fail("attn_policy: launches %s, expected %s" % (counts, want))
    return counts


def time_steps(torch, wf, batch, n=STEPS_TIMED):
    """ms of one train step of ``wf`` by the host clock, over ``n`` steps
    on ``batch`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        wf.step.train_minibatch(*batch)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def remat_bitwise(torch):
    """One AdamW step of the stacked 110M with remat and one without, from
    the same state and minibatch: every tensor bit for bit; then, in turns
    (cached, remat, remat, cached), the step's ms over STEPS_TIMED steps
    and its peak device memory above what was allocated before it; ->
    summary."""
    wf = build_lm(*LM_110M_STACKED, *ADAM_RUN, name="Remat")
    stack = wf.forwards[1]
    batch = first_train_batch(torch, wf)
    start = {u: {k: t.clone() for k, t in sub.items()}
             for u, sub in wf.export_tree().items()}
    trees, out = [], {}
    for remat in (False, True):
        wf.import_tree(start)
        stack.remat = remat
        wf.step.train_minibatch(*batch)
        trees.append({u: {k: t.clone() for k, t in sub.items()}
                      for u, sub in wf.export_tree().items()})
    for remat in (False, True, True, False):
        stack.remat = remat
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        row = out.setdefault("remat" if remat else "cached",
                             {"step_ms": [], "peak_bytes": 0})
        row["step_ms"].append(time_steps(torch, wf, batch))
        row["peak_bytes"] = max(row["peak_bytes"],
                                torch.cuda.max_memory_allocated() - base)
    bad = [(u, k) for u, sub in trees[0].items() for k, t in sub.items()
           if not torch.equal(t, trees[1][u][k])]
    if bad:
        fail("lm_stack: one step with remat differs from one without at %s"
             % bad[:5])
    del wf, stack, trees, start
    torch.cuda.empty_cache()
    return out


def serve_stack(torch, wf):
    """The stacked 110M exported and served on the card: a full forward
    through ArchiveModel, greedy continuous decode of two prompts against
    generate() except at near ties; -> summary."""
    from veles_torch.serving import (ArchiveModel, ContinuousBatcher,
                                     GenerativeEngine)
    path = archive_dir("lm_stack")
    wf.export_inference(path)
    model = ArchiveModel.from_dir(path)
    engine = GenerativeEngine(model, n_slots=4, max_len=DECODE_MAX_LEN)
    prompts = periodic_prompts(2, wf.forwards[0].vocab_size, (64, 128))
    batcher = ContinuousBatcher(engine, max_queue=4)
    try:
        pairs = greedy_vs_generate(torch, wf, model, batcher, prompts, 32)
    finally:
        batcher.close()
    for a, i, g in pairs:
        if i is not None and not g <= LOGIT_RTOL:
            fail("lm_stack: greedy tokens differ from generate() at %d of a "
                 "%d-token prompt, top-two gap %.3g (no near tie)" % (i, a, g))
    if engine.pool.in_use:
        fail("lm_stack: %d slots in use after decoding" % engine.pool.in_use)
    return {"caches": engine.plan.n_caches,
            "greedy_vs_generate": [{"prompt": a, "first_differing": i,
                                    "top2_gap": g} for a, i, g in pairs]}


def check_lm_stack(torch):
    """Phase lm_stack: the stacked 110M (12 blocks in one unit, dense
    attention) through the CLI under AdamW, remat off and on (the train
    loss falls, the bias-gradient kernel 6 launches a block + 1 per step,
    no flash kernel; the validation loss falls in a stacked run with remat
    at the sample's width), remat bit for bit against no remat, peak
    memory and step ms of each, the archive served and decoded. -> the
    110M runs' counts (summed)."""
    _, sample, _ = run_lm(torch, "sample_stacked_remat", "cuda",
                          "root.lm.model.stacked=True",
                          "root.lm.model.remat=True", *SAMPLE_ADAM_RUN,
                          impl=None, phase="lm_stack")
    total = {}
    runs = {}
    for remat in (False, True):
        wf, counts, summary = run_lm(
            torch, "110M_stacked" + ("_remat" if remat else ""), "cuda",
            *LM_110M_STACKED, *ADAM_RUN, "root.lm.model.remat=%s" % remat,
            impl=None, phase="lm_stack", valid_must_fall=False)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        runs[remat] = wf
    profile, _, _ = profile_step(torch, runs[True],
                                 "lm_stack_step_trace.json",
                                 "stacked 110M remat step")
    served = serve_stack(torch, runs[True])
    del runs
    torch.cuda.empty_cache()
    steps = remat_bitwise(torch)
    emit({"phase": "lm_stack", "card": card_line(), "launches": total,
          "sample_launches": sample,
          "remat_bitwise": True, "steps": steps, "remat_step": profile,
          "serving": served})
    return total


def generated_text(torch, cli_args, *overrides, device):
    """One text-LM run through the CLI (as run_lm) -> (workflow, counts,
    summary, the text its ``generated:`` line printed)."""
    import io
    out = io.StringIO()
    wf, counts, summary = run_lm(
        torch, "text_" + device, device, *overrides, impl=None,
        phase="text_lm", cli_args=cli_args, stdout=out)
    lines = [line for line in out.getvalue().splitlines()
             if line.startswith("generated: ")]
    if len(lines) != 1:
        fail("text_lm %s: %d generated lines" % (device, len(lines)))
    return wf, counts, summary, lines[0][len("generated: "):]


def check_text_lm(torch):
    """Phase text_lm: the README's command (a text corpus, AdamW, a
    warmup-cosine schedule, ``--generate-text``) through the CLI on the
    CPU and the card: the card's final validation loss within
    LM_CPU_TOLERANCE of the CPU's; the card's greedy text equal to the CPU
    generate() from the card's weights but at near ties; how far the
    CPU-trained text agrees. -> the card run's counts."""
    import numpy
    from veles_torch.znicz.generate import generate
    args = ("--generate-text", TEXT_PROMPT, "--gen-tokens", str(TEXT_TOKENS))
    cpu_wf, _, cpu, cpu_text = generated_text(torch, args, *TEXT_RUN,
                                              device="cpu")
    wf, counts, card, text = generated_text(torch, args, *TEXT_RUN,
                                            device="cuda")
    gap = abs(card["validation_loss"][-1] - cpu["validation_loss"][-1])
    # the card's weights decoded on the CPU: the same text but at near ties
    cpu_wf.import_tree({u: {k: t.cpu() for k, t in sub.items()}
                        for u, sub in wf.export_tree().items()})
    prompt = wf.loader.encode(TEXT_PROMPT)
    want = generate(cpu_wf, prompt, TEXT_TOKENS)[0].tolist()
    got = [int(i) for i in wf.loader.encode(text[len(TEXT_PROMPT):])[0]]
    i = first_divergence(got, want)
    tie = None
    if i is not None:
        with torch.no_grad():
            ids = torch.from_numpy(numpy.array([prompt[0].tolist()
                                                + want[:i]]))
            logits = cpu_wf.step._forward(ids, False)[1][0, -1]
        tie = top2_gap(logits) / float(logits.abs().max())
    agree = first_divergence(text, cpu_text)
    emit({"phase": "text_lm", "card": card_line(),
          "corpus": os.path.relpath(TEXT_CORPUS, HERE),
          "vocab": wf.forwards[0].vocab_size,
          "windows": sum(wf.loader.class_lengths),
          "final_validation_loss": {"cuda": card["validation_loss"][-1],
                                    "cpu": cpu["validation_loss"][-1]},
          "text_cuda": text, "text_cpu_trained": cpu_text,
          "card_weights_first_differing_on_cpu": i, "top2_gap": tie,
          "cpu_trained_text_agrees_chars": len(text) if agree is None
          else agree, "launches": counts})
    if gap > LM_CPU_TOLERANCE:
        fail("text_lm: final validation loss %.4f on cuda vs %.4f on cpu"
             % (card["validation_loss"][-1], cpu["validation_loss"][-1]))
    if len(text) != len(TEXT_PROMPT) + TEXT_TOKENS \
            or (i is not None and not tie <= LOGIT_RTOL):
        fail("text_lm: the card's text %r differs from the CPU's decode of "
             "its weights at %s (top-two gap %s)" % (text, i, tie))
    return counts


def check_moe(torch):
    """Phase moe: the MoE LM at the 110M width (LM_110M_MOE, 4 layers)
    through the CLI under AdamW: the validation loss falls, the tokens
    each MoE layer drops in a step; the drops of a small MoE LM equal on
    the card and the CPU (f32, same weights and minibatch); the 110M MoE
    archive served on the card within SERVE_RTOL of the f32 training
    forward, each sample on its own. -> the counts."""
    from veles_torch.serving import ArchiveModel
    from veles_torch.znicz.ops.moe import MoEFFN
    wf, counts, summary = run_lm(torch, "110M_moe", "cuda", *LM_110M_MOE,
                                 *ADAM_RUN, impl=None, phase="moe")
    units = [f for f in wf.forwards if isinstance(f, MoEFFN)]
    batch = first_train_batch(torch, wf)
    wf.step.train_minibatch(*batch)
    dropped = [int(f.dropped) for f in units]
    restore = f32_policy()
    try:
        small = {}
        start = None
        for device in ("cuda", "cpu"):
            sw = build_lm(*MOE_SMALL, device=device, name="MoEDrops")
            if start is None:
                start = {u: {k: t.clone() for k, t in sub.items()}
                         for u, sub in sw.export_tree().items()}
            sw.import_tree(start)
            sw.step.train_minibatch(*first_train_batch(torch, sw))
            small[device] = [int(f.dropped) for f in sw.forwards
                             if isinstance(f, MoEFFN)]
    finally:
        restore()
    path = archive_dir("lm_moe")
    wf.export_inference(path)
    model = ArchiveModel.from_dir(path)
    rows = wf.loader.device_full_arrays(wf.device.device)["data"][:2]
    served = [max_rel(model(rows[i:i + 1].float()),
                      train_forward_f32(torch, wf, rows[i:i + 1]))
              for i in range(2)]
    emit({"phase": "moe", "card": card_line(), "experts": units[0].experts,
          "capacity": units[0].capacity(batch[0].numel()),
          "dropped_per_layer_110M": dropped,
          "dropped_small": small, "serve_rel_err": served,
          "launches": counts})
    if small["cuda"] != small["cpu"] or not max(served) <= SERVE_RTOL:
        fail("moe: drops %s on cuda vs %s on cpu; served %s (bound %g)"
             % (small["cuda"], small["cpu"], served, SERVE_RTOL))
    return counts


def check_lm_slice(torch):
    """The phases lm_adam, attn_policy, lm_stack, text_lm and moe; -> their
    counts by path."""
    return {"lm_adam": check_lm_adam(torch),
            "attn_policy": check_attn_policy(torch),
            "lm_stack": check_lm_stack(torch),
            "text_lm": check_text_lm(torch),
            "moe": check_moe(torch)}


# -- state and launcher -----------------------------------------------------

#: the 110M row as phase lm_adam runs it (AdamW, warmup-cosine, 64/16
#: sequences of 512, minibatch 8, 2 epochs), its depth cut from 12 to 2
#: layers: the phase's time goes to its checkpoints' bytes (190 of its
#: 226 s at 12 layers on an NVIDIA H100), and the script's limit needs room
RESUME_RUN = LM_110M + ADAM_RUN + ("root.lm.model.layers=2",)
MNIST_SAMPLE = os.path.join(MODELS, "mnist.py")
#: the device of the phase's runs (a rehearsal on a host without a card
#: sets "cpu" and shrinks RESUME_RUN)
RESUME_DEVICE = "cuda"
#: the reference's preemption test (tests/test_durability.py) on the card:
#: the MNIST sample at full size, rolling checkpoints every 0.2 s, a run
#: of 500 epochs that the SIGTERM cuts short
PREEMPT_RUN = ("--checkpoint-every", "0.2",
               "root.mnist.decision.max_epochs=500")
#: seconds the first rolling checkpoint may take to appear, and the
#: preempted process to exit
PREEMPT_DEADLINE = 300
#: the --profile-dir run: the 110M row's width and depth, its sequences
#: cut to 16/8 (2 train steps, 1 evaluation)
PROFILE_RUN = ("root.lm.loader.n_train=16", "root.lm.loader.n_valid=8",
               "root.lm.decision.max_epochs=1")
#: run B is preempted (a SIGTERM to its process) after this many train
#: steps of epoch 1, while the train class is in flight
PREEMPT_B_AFTER = 2
#: run B's second process (arguments: an output directory, the train
#: steps the checkpoint carries, then the CLI's): the CLI's main, then its
#: launch counts, what its own steps imply, its decision, and its final
#: state (uncompressed) in the output directory
RESUME_CHILD = """
import json, sys, torch
import chip_smoke as C
from veles_torch.__main__ import main
from veles_torch.snapshotter import FileSnapshotStore, write_checkpoint
from veles_torch.znicz.standard_workflow import StandardWorkflow
# the resumed run's own checkpoints go uncompressed: run B's writes are
# the gzip the phase times, and this run's would add ~15 s
_link = StandardWorkflow.link_snapshotter
StandardWorkflow.link_snapshotter = lambda self, **cfg: _link(
    self, **dict({"compression": ""}, **cfg))
C.reset_counts()
wf = main(sys.argv[3:])
if wf.device.device.type == "cuda":
    torch.cuda.synchronize()
counts = C.read_counts()
path, _ = write_checkpoint(FileSnapshotStore(sys.argv[1]), "final.ckpt.npz",
                           wf.checkpoint_state(), compression="")
wf.step.train_steps -= int(sys.argv[2])
print(json.dumps({"counts": counts,
                  "expected": C.lm_expected_counts(
                      wf, wf.device.device.type)[0],
                  "decision": wf.decision.get_state(), "final": path}))
"""


def child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    return env


def sync(torch):
    if RESUME_DEVICE == "cuda":
        torch.cuda.synchronize()


def lm_cli(torch, *args, preempted=None):
    """One run of the LM sample through the CLI entry point in this
    process (``root.lm.train`` emptied first), its launches counted from 0
    and held to what it implies; -> (workflow, counts). With
    ``preempted`` (a dict that run B's hooks fill with its workflow) the
    run must end in the launcher's preemption exit."""
    from veles_torch.config import root
    from veles_torch.launcher import EXIT_PREEMPTED
    root.lm.train = {}
    reset_counts()
    code = 0
    with contextlib.redirect_stdout(sys.stdout):
        try:
            wf = cli_run([LM_SAMPLE, *args, "--seed", "1337", "-d",
                      RESUME_DEVICE])
        except SystemExit as exc:
            code = exc.code
            wf = (preempted or {}).get("workflow")
    sync(torch)
    counts = read_counts()
    if code != (0 if preempted is None else EXIT_PREEMPTED):
        fail("resume %s: the CLI exited %s" % (args[-1:], code))
    want, _ = lm_expected_counts(wf, RESUME_DEVICE)
    if counts != want:
        fail("resume %s: launches %s, expected %s" % (args[-1:], counts,
                                                      want))
    return wf, counts


def add_counts(*runs):
    return {k: sum(c[k] for c in runs) for k in runs[0]}


def host_state(tree):
    """The params and solver sections of a checkpoint tree."""
    return {"%s/%s/%s" % (sec, u, k): v for sec in ("params", "state")
            for u, sub in tree[sec].items() for k, v in sub.items()}


@contextlib.contextmanager
def run_b_hooks(torch, seen):
    """Run B's hooks: each epoch-entry clone timed (its ms, the bytes it
    clones and, on the card, what the allocator grew by), the workflow
    kept in ``seen``; and ``PREEMPT_B_AFTER`` train steps into epoch 1's
    train class a SIGTERM to this process, as a preemption sends it."""
    import signal
    from veles_torch.znicz.standard_workflow import StandardWorkflow
    from veles_torch.znicz.step import TorchStep
    copy_view, train = StandardWorkflow._copy_view, TorchStep.train_minibatch

    def timed_copy(wf):
        sync(torch)
        on_card = RESUME_DEVICE == "cuda"
        before = torch.cuda.memory_allocated() if on_card else None
        t0 = time.perf_counter()
        view = copy_view(wf)
        sync(torch)
        ms = (time.perf_counter() - t0) * 1e3
        seen["workflow"] = wf
        seen["clones"].append({
            "ms": ms, "bytes": sum(t.numel() * t.element_size()
                                   for sec in ("params", "state")
                                   for sub in view[sec].values()
                                   for t in sub.values()),
            "allocated_bytes": torch.cuda.memory_allocated() - before
            if on_card else None})
        return view

    def preempting_train(step, *args):
        out = train(step, *args)
        if step.decision.epoch_number == 1 and \
                step.train_steps == step.entry["step_index"] \
                + PREEMPT_B_AFTER:
            signal.raise_signal(signal.SIGTERM)
        return out

    StandardWorkflow._copy_view = timed_copy
    TorchStep.train_minibatch = preempting_train
    try:
        yield
    finally:
        StandardWorkflow._copy_view = copy_view
        TorchStep.train_minibatch = train


def raw_costs(wf, directory):
    """Write ``wf``'s checkpoint uncompressed through a snapshotter and
    read it back; -> ({bytes, write_s, read_s}, its tree)."""
    from veles_torch import snapshotter as S
    snap = wf.link_snapshotter(directory=directory, compression="",
                               prefix="resume_raw")
    t0 = time.perf_counter()
    path = snap.export_snapshot(slot="current")
    write_s = time.perf_counter() - t0
    if path is None:
        fail("resume: the uncompressed checkpoint was not written")
    t0 = time.perf_counter()
    tree = S.load_snapshot(path)
    return {"bytes": os.path.getsize(path), "write_s": write_s,
            "read_s": time.perf_counter() - t0}, tree


def unequal_tensors(want, got):
    """{tensor: max abs difference} of the params and solver sections of
    two checkpoint trees that are not bit for bit equal."""
    import numpy
    want, got = host_state(want), host_state(got)
    if sorted(want) != sorted(got):
        fail("resume: tensors %s vs %s" % (sorted(want)[:4],
                                           sorted(got)[:4]))
    return {k: float(numpy.abs(got[k].astype(numpy.float64)
                               - want[k]).max())
            for k in want if not numpy.array_equal(want[k], got[k])}


def resume_110m(torch, tmp):
    """Part (a): runs A and B of the 110M; -> (summary, counts, run B's
    preemption checkpoint, run A, run B restored to that checkpoint)."""
    from veles_torch import snapshotter as S
    wf_a, counts_a = lm_cli(torch, *RESUME_RUN)
    snaps = os.path.join(tmp, "b")
    seen = {"clones": []}
    writes = len(S.COUNTERS.write_seconds)
    with run_b_hooks(torch, seen):
        wf_b, counts_b1 = lm_cli(torch, *RESUME_RUN, "--snapshots", snaps,
                                 preempted=seen)
    gz_writes = S.COUNTERS.write_seconds[writes:]
    path = wf_b.snapshotter.destination
    t0 = time.perf_counter()
    tree = S.load_snapshot(path)
    gz_read = time.perf_counter() - t0
    entry_step = int(tree["meta"]["step_index"])
    names = sorted(os.listdir(snaps))
    if "_current-" not in path or tree["decision"]["epoch_number"] != 1 \
            or entry_step != wf_b.step.entry["step_index"] \
            or wf_b.step.train_steps != entry_step + PREEMPT_B_AFTER \
            or len(seen["clones"]) != 2 or len(gz_writes) != len(names):
        fail("resume: run B's preemption checkpoint %s: epoch %s, step %d "
             "(run stopped at %d), %d entry clones, %d writes, store %s"
             % (path, tree["decision"]["epoch_number"], entry_step,
                wf_b.step.train_steps, len(seen["clones"]), len(gz_writes),
                names))
    raw, raw_tree = raw_costs(wf_b, os.path.join(tmp, "raw"))
    if unequal_tensors(tree, raw_tree):
        fail("resume: the uncompressed checkpoint of run B's entry differs "
             "from its preemption checkpoint")
    out = os.path.join(tmp, "b2")
    os.makedirs(out)
    child = subprocess.run(
        [sys.executable, "-c", RESUME_CHILD, out, str(entry_step),
         LM_SAMPLE, *RESUME_RUN, "--snapshots", snaps, "--snapshot", "auto",
         "--seed", "1337", "-d", RESUME_DEVICE],
        cwd=HERE, env=child_env(), capture_output=True, text=True,
        timeout=900)
    if child.returncode:
        fail("resume: run B's second process exited %d: %s"
             % (child.returncode, child.stderr[-2000:]))
    report = json.loads(child.stdout.strip().splitlines()[-1])
    if report["counts"] != report["expected"]:
        fail("resume: run B's second process launched %s, expected %s"
             % (report["counts"], report["expected"]))
    want = wf_a.checkpoint_state()
    unequal = unequal_tensors(want, S.load_snapshot(report["final"]))
    if unequal or report["decision"] != want["decision"]:
        fail("resume: run B differs from run A: %d tensors (%s), "
             "decisions equal: %s" % (
                 len(unequal), sorted(unequal.items(),
                                      key=lambda kv: -kv[1])[:5],
                 report["decision"] == want["decision"]))
    wf_b.restore_state(tree)
    summary = {"tensors": len(host_state(want)), "bitwise_equal": True,
               "history": report["decision"]["history"],
               "preempted_at_step": entry_step + PREEMPT_B_AFTER,
               "resumed_from": os.path.basename(path),
               "store": names, "entry_clones": seen["clones"],
               "checkpoint": {"gz": {"bytes": os.path.getsize(path),
                                     "write_s": gz_writes,
                                     "read_s": gz_read},
                              "raw": raw},
               "launches": {"run_a": counts_a, "run_b_first": counts_b1,
                            "run_b_second": report["counts"]}}
    return (summary, add_counts(counts_a, counts_b1, report["counts"]),
            path, wf_a, wf_b)


def preempt_mnist(torch, tmp):
    """Part (b); -> (summary, counts of the resumed run)."""
    import signal
    from veles_torch import snapshotter as S
    from veles_torch.znicz.ops.bias_grad import bias_grad
    snaps = os.path.join(tmp, "mnist")
    base = [MNIST_SAMPLE, "-d", RESUME_DEVICE, "--seed", "1337",
            "--snapshots", snaps]
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_torch", *base, *PREEMPT_RUN],
        cwd=HERE, env=child_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + PREEMPT_DEADLINE
        while not (os.path.isdir(snaps) and any(
                "_current-" in n for n in os.listdir(snaps))):
            if proc.poll() is not None:
                fail("resume: the MNIST run ended (%d) before a rolling "
                     "checkpoint: %s" % (proc.returncode,
                                         proc.stderr.read()[-2000:]))
            if time.monotonic() > deadline:
                fail("resume: no rolling checkpoint in %d s"
                     % PREEMPT_DEADLINE)
            time.sleep(0.05)
        t_signal = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=PREEMPT_DEADLINE)
        exit_s = time.monotonic() - t_signal
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 75:
        fail("resume: the preempted MNIST run exited %d: %s"
             % (rc, proc.stderr.read()[-2000:]))
    infos = S.scan_checkpoints(snaps)
    if not infos or any(i.status != "valid" for i in infos):
        fail("resume: the preempted run's store: %s" % infos)
    tree, name, _ = S.resolve_auto(snaps)
    epoch = tree["decision"]["epoch_number"]
    reset_counts()
    wf = cli_run(base + ["--snapshot", "auto",
                     "root.mnist.decision.max_epochs=%d" % (epoch + 1)])
    sync(torch)
    counts = read_counts()
    steps = wf.step.train_steps - int(tree["meta"]["step_index"])
    launches = bias_grad.form_launches
    if steps <= 0 or launches != {"identity": steps, "masked": steps} \
            or len(wf.decision.history) != epoch + 1:
        fail("resume: MNIST resumed from %s (epoch %d): %d train steps, "
             "bias_grad %s, %d epochs" % (name, epoch, steps, launches,
                                          len(wf.decision.history)))
    return {"exit_code": rc, "seconds_to_exit": exit_s,
            "checkpoints": [(i.name, i.status) for i in infos],
            "resumed_from": name, "resumed_epoch": epoch,
            "train_steps": steps, "launches": counts}, counts


def profile_dir_run(torch, tmp):
    """Part (c); -> (summary, counts)."""
    from veles_torch.launcher import TRACE_NAME
    prof = os.path.join(tmp, "profile")
    _, counts = lm_cli(torch, *RESUME_RUN, *PROFILE_RUN, "--profile-dir",
                       prof)
    path = os.path.join(prof, TRACE_NAME)
    with open(path) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
    named = {key: sum(pattern in k for k in kernels) for key, pattern in
             (("flash_fwd", "flash_fwd"), ("flash_bwd", "flash_bwd"),
              ("bias_grad", BIAS_GRAD_KERNEL))}
    if not all(named.values()):
        fail("resume: the --profile-dir trace misses kernels: %s" % named)
    return {"trace_bytes": os.path.getsize(path),
            "device_kernels": len(kernels), "by_name": named,
            "launches": counts}, counts


def refresh_archive(torch, wf_a, wf_b, ckpt):
    """Part (d): run A's archive refreshed from run B's preemption
    checkpoint, against run B restored to it."""
    from veles_torch.serving.model import ArchiveModel
    path = archive_dir("resume_110m")
    wf_a.export_inference(path)
    model = ArchiveModel.from_dir(path, device=RESUME_DEVICE)
    rows = first_train_batch(torch, wf_b)[0][:2]
    want = train_forward_f32(torch, wf_b, rows)
    before = max_rel(model(rows), want)
    loaded = model.load_checkpoint(ckpt)
    after = max_rel(model(rows), want)
    if not after <= SERVE_RTOL or not before > SERVE_RTOL:
        fail("resume: load_checkpoint: logits %.3g of run B's before the "
             "refresh, %.3g after (bound %g)" % (before, after, SERVE_RTOL))
    return {"tensors_loaded": loaded, "rel_err_before": before,
            "rel_err_after": after, "bound": SERVE_RTOL}


def check_resume(torch):
    """Phase resume; -> its launches (every run of the phase that this
    process or run B's second process counted)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        summary, counts, ckpt, wf_a, wf_b = resume_110m(torch, tmp)
        emit({"phase": "resume", "part": "110M", "card": card_line(),
              **summary})
        preempt, mnist = preempt_mnist(torch, tmp)
        emit({"phase": "resume", "part": "mnist_preemption", **preempt})
        profile, prof_counts = profile_dir_run(torch, tmp)
        emit({"phase": "resume", "part": "profile_dir", **profile})
        refresh = refresh_archive(torch, wf_a, wf_b, ckpt)
        emit({"phase": "resume", "part": "load_checkpoint", **refresh})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return add_counts(counts, mnist, prof_counts)


# -- the model-health plane --------------------------------------------------

#: the layer stats of an MNIST card run against the port's CPU run at the
#: same seed, relative: bf16 activations and products on the card, f32 on
#: the CPU, over 180 steps (phase mnist holds the final validation errors
#: within 0.02)
HEALTH_MNIST_RTOL = 5e-2
#: the injected blow-up: the learning rate is NaN on this train step (the
#: eleventh of epoch 1: MNIST takes 60 a epoch), so that update writes NaN
#: into every weight and its stats read a non-finite weight norm
NAN_STEP = 70
#: the reasons the reference's detector gives for that observation
NAN_REASONS = ["nonfinite:GDSoftmax", "nonfinite:GDTanh"]
#: the 110M stats cost, in turns: stats off, at stride 8, at stride 1
STATS_TURNS = (None, 8, 1, 1, 8, None)
#: train steps timed a turn (a multiple of 8: one due step in 8 at stride
#: 8), and profiled once a setting
STATS_STEPS = 16
STATS_PROFILED = 8
#: the activation pairs at AlexNet conv1's output (minibatch 128)
ACTIVATION_SHAPE = (128, 55, 55, 96)
#: each pair on the card against the CPU, as a share of max(|cpu|, 1): in
#: f32 the tier-1 bound (tests/test_torch_activation.py), in bf16 two
#: roundings of 2^-8
ACTIVATION_TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}
#: the device of the phase's card runs (``cpu`` rehearses the phase)
HEALTH_DEVICE = "cuda"
#: the ImageSaver's per-epoch limit in the MNIST card run
SAVER_LIMIT = 16
#: the serving drift against the numpy formula (the document rounds to
#: 6 decimals)
DRIFT_ATOL = 1e-6


def health_sync(torch):
    if HEALTH_DEVICE == "cuda":
        torch.cuda.synchronize()


def per_step(steps):
    """Launches of a kernel that runs once a train step: 0 on the CPU."""
    return steps if HEALTH_DEVICE == "cuda" else 0


def recording_monitor():
    """A fresh model-health monitor of the port that also records each
    layer-stats observation: (step index, layers, float64 vectors), and the
    (verdict, reasons) after it."""
    import numpy
    from veles_torch import model_health

    class Recording(model_health.ModelHealthMonitor):
        def __init__(self):
            super().__init__()
            self.seen, self.verdicts = [], []

        def observe_stats(self, stats, step_index=None):
            # a probe's sink: it records each observation it is handed,
            # behind the step's own cadence gate
            rows = [numpy.asarray(v, numpy.float64)  # zlint: disable=stats-cadence (a probe's sink that records each observation it is handed)
                    for v in stats.values()]
            self.seen.append((step_index, list(stats), numpy.array(rows)))  # zlint: disable=stats-cadence (a probe's sink that records each observation it is handed)
            super().observe_stats(stats, step_index)
            self.verdicts.append(self.verdict_state())

    return Recording()


def health_mnist(torch, device, stride, saver_dir=None, blowup=False,
                 snap_dir=None):
    """The MNIST sample (root.mnist, 3 epochs, seed 1337) through the
    launcher on ``device`` with the stats every ``stride`` steps, under a
    fresh recording monitor; ``saver_dir`` links an ImageSaver; ``blowup``
    makes the learning rate NaN on train step ``NAN_STEP`` and links a
    rollback armed by ``--rollback-on-divergence``; ``snap_dir`` links a
    snapshotter writing at every class boundary. -> (workflow, monitor,
    launches)."""
    from veles_torch import model_health, prng
    from veles_torch.launcher import Launcher
    from veles_torch.znicz.lr_adjust import ArbitraryStepPolicy
    from veles_torch.znicz.models import mnist
    monitor = recording_monitor()
    with model_health.scoped(monitor):
        prng.seed_all(1337)
        wf = mnist.create_workflow(name="MnistHealth")
        wf.decision.max_epochs = 3
        if saver_dir:
            wf.link_image_saver(saver_dir, limit_per_epoch=SAVER_LIMIT)
        if blowup:
            wf.link_lr_adjuster(ArbitraryStepPolicy(
                [(0.02, NAN_STEP), (float("nan"), 1), (0.02, 1)]))
            wf.link_rollback()
        if snap_dir:
            wf.link_snapshotter(directory=snap_dir, interval=1e-9,
                                keep_interval=1000, compression="")
        launcher = Launcher(device=device, stats_interval=stride,
                            rollback_on_divergence=blowup)
        launcher.initialize(wf)
        reset_counts()
        launcher.run()
        health_sync(torch)
        counts = read_counts()
    return wf, monitor, counts


def stats_errors(want, got):
    """Max relative error of each STAT_FIELDS norm of two recorded runs,
    after checking the same (step index, layers) sequence and non-finite
    counts; -> {field: error}."""
    import numpy
    if [(s, n) for s, n, _ in want] != [(s, n) for s, n, _ in got]:
        fail("model_health: the stats sequences differ: %s ... against %s "
             "..." % ([(s, n) for s, n, _ in want][:3],
                      [(s, n) for s, n, _ in got][:3]))
    a = numpy.stack([v for _, _, v in want])
    b = numpy.stack([v for _, _, v in got])
    if not numpy.array_equal(a[..., 3], b[..., 3]):
        fail("model_health: non-finite counts differ")
    rel = numpy.abs(b - a) / numpy.maximum(numpy.abs(a), 1e-30)
    return {f: float(rel[..., i].max()) for i, f in enumerate(
        ("grad_norm", "weight_norm", "update_ratio"))}


def check_stats_sane(monitor, where):
    """Every recorded vector finite with no non-finite count, every
    update ratio in (0, 1), the verdict healthy."""
    import numpy
    for _, _, v in monitor.seen:
        if not (numpy.isfinite(v).all() and (v[:, 3] == 0).all()
                and (v[:, 2] > 0).all() and (v[:, 2] < 1).all()):
            fail("%s: stat vectors %s" % (where, v.tolist()))
    if monitor.verdict_state() != ("healthy", []):
        fail("%s: verdict %s" % (where, monitor.verdict_state()))


def check_saver(wf, saver_dir):
    """The ImageSaver's files of a 3-epoch run: SAVER_LIMIT an epoch,
    each named by its class, global index and label, each array equal to
    the loader's sample."""
    import numpy
    saver = wf.image_saver
    found = 0
    for epoch in range(3):
        d = os.path.join(saver_dir, "epoch%04d" % epoch)
        names = sorted(os.listdir(d)) if os.path.isdir(d) else []
        if len(names) != SAVER_LIMIT:
            fail("image_saver: %d files in %s, expected %d"
                 % (len(names), d, SAVER_LIMIT))
        for name in names:
            m = re.match(r"c(\d)_i(\d+)_pred-1_true(\d+)\.npy$", name)
            gidx = int(m.group(2)) if m else -1
            if not m or int(m.group(3)) != int(
                    wf.loader.original_labels[gidx]) or not numpy.array_equal(
                        numpy.load(os.path.join(d, name)),
                        wf.loader.original_data[gidx]):
                fail("image_saver: %s is not the loader's sample" % name)
            found += 1
    if saver.total_saved != found:
        fail("image_saver: total_saved %d, %d files" % (saver.total_saved,
                                                       found))
    return {"files": found, "per_epoch": SAVER_LIMIT,
            "state": saver.get_state()}


def health_mnist_strides(torch, tmp):
    """Part (a): MNIST on the card and on the CPU at stride 1 and 8."""
    rows, launches = [], []
    for stride in (1, 8):
        _, cpu_mon, _ = health_mnist(torch, "cpu", stride)
        saver_dir = os.path.join(tmp, "saver") if stride == 8 else None
        wf, mon, counts = health_mnist(torch, HEALTH_DEVICE, stride,
                                       saver_dir)
        steps = wf.step.train_steps
        due = len(range(0, steps, stride))
        errors = stats_errors(cpu_mon.seen, mon.seen)
        check_stats_sane(mon, "model_health mnist stride %d" % stride)
        row = {"phase": "model_health", "part": "mnist", "stride": stride,
               "train_steps": steps, "observations": len(mon.seen),
               "rel_err_vs_cpu": errors, "bound": HEALTH_MNIST_RTOL,
               "launches": counts, "verdict": mon.verdict_state()[0],
               "epoch_seconds": wf.step.epoch_seconds}
        if len(mon.seen) != due or max(errors.values()) > HEALTH_MNIST_RTOL \
                or counts["bias_grad[identity]"] != per_step(steps) \
                or counts["bias_grad[masked]"] != per_step(steps):
            fail("model_health mnist stride %d: %s" % (stride, row))
        if saver_dir:
            row["image_saver"] = check_saver(wf, saver_dir)
            TRAINED["mnist_health"] = wf
        emit(row)
        launches.append(counts)
    return launches


def health_blowup(torch, tmp):
    """Part (b): the NaN step on the card (and on the CPU, for the
    reasons), the rollback, the stamped checkpoints, resolve_auto, and
    ``--model-stats off``."""
    from veles_torch import snapshotter as S
    snaps = os.path.join(tmp, "blowup")
    wf, mon, counts = health_mnist(torch, HEALTH_DEVICE, 1, blowup=True,
                                   snap_dir=snaps)
    _, cpu_mon, _ = health_mnist(torch, "cpu", 1, blowup=True)
    first = [v for v, _ in mon.verdicts].index("diverged")
    reasons = mon.verdicts[first][1]
    check_params_finite(torch, wf, "model_health blow-up")
    infos = S.scan_checkpoints(snaps)
    stamps = [i.health_verdict for i in infos]
    skips0 = S.COUNTERS.diverged_skips
    _, resumed, _ = S.resolve_auto(snaps)
    skipped = S.COUNTERS.diverged_skips - skips0
    resumed_verdict = next(i.health_verdict for i in infos
                           if i.name == resumed)
    row = {"phase": "model_health", "part": "blowup", "nan_step": NAN_STEP,
           "first_diverged_observation": first, "reasons": reasons,
           "cpu_first_diverged": [v for v, _ in cpu_mon.verdicts].index(
               "diverged"),
           "cpu_reasons": cpu_mon.verdicts[first][1],
           "rollbacks": wf.rollback.rollback_count,
           "lr_scales": [gd.lr_scale for gd in wf.gds],
           "final_verdict": mon.verdict_state(),
           "checkpoint_verdicts": {v: stamps.count(v) for v in set(stamps)},
           "resolve_auto": resumed, "resolve_auto_verdict": resumed_verdict,
           "diverged_skips": skipped,
           "launches": counts}
    steps = wf.step.train_steps
    if first != NAN_STEP or row["cpu_first_diverged"] != NAN_STEP \
            or reasons != NAN_REASONS or row["cpu_reasons"] != NAN_REASONS \
            or wf.rollback.rollback_count != 1 \
            or any(s != 0.5 for s in row["lr_scales"]) \
            or mon.verdict_state() != ("healthy", []) \
            or "diverged" not in stamps or resumed_verdict == "diverged" \
            or not skipped \
            or counts["bias_grad[identity]"] != per_step(steps) \
            or counts["bias_grad[masked]"] != per_step(steps):
        fail("model_health blow-up: %s" % row)
    # --model-stats off: the plane stands down, checkpoints say unknown
    off_dir = os.path.join(tmp, "off")
    reset_counts()
    off = cli_run([MNIST_SAMPLE, "root.mnist.decision.max_epochs=1",
                   "--seed", "1337", "-d", HEALTH_DEVICE, "--snapshots",
                   off_dir, "--model-stats", "off"])
    health_sync(torch)
    off_counts = read_counts()
    off_stamps = sorted({i.health_verdict
                         for i in S.scan_checkpoints(off_dir)})
    row_off = {"phase": "model_health", "part": "model_stats_off",
               "checkpoint_verdicts": off_stamps, "launches": off_counts,
               "stat_units": off.step.stat_names}
    if off_stamps != ["unknown"] or off.step.stat_names is not None \
            or off_counts["bias_grad[masked]"] != per_step(
                off.step.train_steps):
        fail("model_health --model-stats off: %s" % row_off)
    emit(row)
    emit(row_off)
    return [counts, off_counts]


#: seconds a counted profile window leaves the card idle at each end.
#: The profiler drops the device events it timestamps outside its window,
#: and its device-to-host clock conversion has been seen to jump by a few
#: milliseconds on an H100: without the margin, a plotted MNIST epoch once
#: counted 12 operations fewer than the next one (phase plots), and with
#: the side processes on the card a traced VideoAE step lost its one
#: bias-gradient kernel. Every traced window takes it
COUNT_PAD_S = 0.05


@contextlib.contextmanager
def counted_window(activities, sync):
    """torch.profiler over the block, for counting its device operations
    (:func:`count_device_ops`): ``sync()`` and COUNT_PAD_S idle seconds
    after the window opens and after the block, so that no operation of
    the block lies near an edge of the window; -> the profile."""
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        sync()
        time.sleep(COUNT_PAD_S)
        yield prof
        sync()
        time.sleep(COUNT_PAD_S)


def device_ops_by_name(prof):
    """Device operations (kernels, copies, memsets) in a profile, counted
    by name; the trace is read from a temporary file, not kept."""
    import collections
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return collections.Counter(
        e.get("name", "")[:160] for e in events if e.get("ph") == "X"
        and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


def count_device_ops(prof):
    """Device operations (kernels, copies, memsets) in a profile."""
    return sum(device_ops_by_name(prof).values())


def set_stats(wf, stride):
    """Stats off (``stride`` None) or every ``stride`` steps."""
    wf.step.set_stats_enabled(stride is not None)
    wf.step.stats_interval = stride or 8


#: part (c)'s LM: the 110M row at 4 of its 12 layers (cut from 12: see
#: PARALLEL_LAYERS)
HEALTH_LM = LM_110M + ("root.lm.model.layers=4",)


def health_110m(torch):
    """Part (c): the 110M row at 4 layers (momentum, the flash kernels)
    through the CLI with the stats off, at stride 8 and at stride 1: the
    launches each run implies (the flash kernels and 25 identity bias
    sums a step, whatever the stats), the vectors finite with update
    ratios below 1;
    then on one workflow, in turns, the step's host ms, and its device
    operations from the profiler."""
    from torch.profiler import ProfilerActivity
    runs, wf = [], None
    for stride in (None, 8, 1):
        flags = ("--model-stats", "off") if stride is None \
            else ("--stats-interval", str(stride))
        monitor = recording_monitor()
        wf, counts, summary = run_lm(
            torch, "110M stats %s" % (stride or "off"), HEALTH_DEVICE,
            *HEALTH_LM,
            valid_must_fall=False, phase="model_health", cli_args=flags,
            monitor=monitor)
        steps = wf.step.train_steps
        want = 0 if stride is None else len(range(0, steps, stride))
        if stride is not None:
            check_stats_sane(monitor, "model_health 110M stride %d" % stride)
        if len(monitor.seen) != want:
            fail("model_health 110M stride %s: %d observations, expected "
                 "%d" % (stride, len(monitor.seen), want))
        if counts["bias_grad[identity]"] != per_step(
                steps * identity_sums_per_step(wf)):
            fail("model_health 110M: %d identity sums in %d steps"
                 % (counts["bias_grad[identity]"], steps))
        runs.append(counts)
        if stride is not None:
            last = monitor.seen[-1][2]
            emit({"phase": "model_health", "part": "110M_vectors",
                  "stride": stride, "observations": len(monitor.seen),
                  "stat_units": len(wf.step.stat_names),
                  "update_ratio_max": float(max(v[:, 2].max() for _, _, v
                                                in monitor.seen)),
                  "last": {"grad_norm_max": float(last[:, 0].max()),
                           "weight_norm_max": float(last[:, 1].max())}})
    batch = first_train_batch(torch, wf)
    turns = []
    for stride in STATS_TURNS:
        set_stats(wf, stride)
        turns.append((stride, time_steps(torch, wf, batch, STATS_STEPS)))
    ops = {}
    activities = [ProfilerActivity.CPU]
    if HEALTH_DEVICE == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for stride in (None, 8, 1):
        set_stats(wf, stride)
        wf.step.train_minibatch(*batch)
        health_sync(torch)
        # STATS_PROFILED is a multiple of 8: one due step at stride 8
        with counted_window(activities,
                            functools.partial(health_sync, torch)) as prof:
            for _ in range(STATS_PROFILED):
                wf.step.train_minibatch(*batch)
        ops[stride or "off"] = count_device_ops(prof) / STATS_PROFILED
    set_stats(wf, 8)
    ms = {key: [t for s, t in turns if (s or "off") == key]
          for key in ("off", 8, 1)}
    mean = {key: sum(v) / len(v) for key, v in ms.items()}
    row = {"phase": "model_health", "part": "110M_stats_cost",
           "card": card_line() if HEALTH_DEVICE == "cuda" else None,
           "steps_a_turn": STATS_STEPS,
           "turns": [[s or "off", t] for s, t in turns],
           "step_ms": ms, "device_ops_per_step": ops,
           "due_step_ms_over_off": mean[1] - mean["off"],
           "due_step_ops_over_off": ops[1] - ops["off"],
           "stride8_ms_over_off": mean[8] - mean["off"],
           "stride8_ops_over_off": ops[8] - ops["off"],
           "launches": runs}
    emit(row)
    if HEALTH_DEVICE == "cuda" and not ops[1] > ops[8] > ops["off"]:
        fail("model_health 110M: device operations a step %s" % ops)
    return runs


def entropy_margin(rows):
    """The drift gauges' formula in numpy: softmax of logits (rows that
    are not a distribution), mean entropy and mean top-1 − top-2."""
    import numpy
    p = numpy.asarray(rows, numpy.float64)
    if (p < 0).any() or not numpy.allclose(p.sum(1), 1.0, atol=1e-3):
        e = numpy.exp(p - p.max(1, keepdims=True))
        p = e / e.sum(1, keepdims=True)
    ent = -(p * numpy.log(numpy.maximum(p, 1e-12))).sum(1).mean()
    top = numpy.sort(p, 1)
    return float(ent), float((top[:, -1] - top[:, -2]).mean())


def health_serving(torch):
    """Part (d): the MNIST archive of part (a) through a MicroBatcher on
    the card, one request a batch: the monitor's entropy and margin of
    the stride's sampled batch against the numpy formula on its outputs."""
    from veles_torch import model_health
    from veles_torch.serving import (ArchiveModel, InferenceEngine,
                                     MicroBatcher)
    wf = TRAINED.pop("mnist_health")
    path = archive_dir("mnist_health")
    wf.export_inference(path)
    engine = InferenceEngine(ArchiveModel.from_dir(path,
                                                   device=HEALTH_DEVICE),
                             max_batch=64, device=HEALTH_DEVICE)
    host = serving_rows(wf).cpu().numpy()
    with model_health.scoped() as monitor:
        batcher = MicroBatcher(engine.predict, max_batch=64,
                               default_timeout_ms=60000.0, name="mnist")
        try:
            outs = [batcher.predict(host[i:i + 1])
                    for i in range(monitor.serving_stride + 1)]
        finally:
            batcher.close()
        doc = monitor.snapshot()["serving"]["mnist"]
        gauges = monitor.metrics()
    want = entropy_margin(outs[monitor.serving_stride])
    got = (doc["entropy"], doc["top1_margin"])
    gauge = (gauges["veles_serving_logit_entropy"]['model="mnist"'],
             gauges["veles_serving_top1_margin"]['model="mnist"'])
    row = {"phase": "model_health", "part": "serving_drift",
           "batches": len(outs), "stride": monitor.serving_stride,
           "monitor": got, "gauges": gauge, "numpy": want,
           "max_abs_err": max(abs(a - b) for a, b in zip(gauge, want))}
    emit(row)
    if any(abs(a - b) > DRIFT_ATOL for a, b in zip(got + gauge, want * 2)):
        fail("model_health serving drift: %s" % row)


def health_activations(torch):
    """Part (e): the eight activation pairs forward and backward on the
    card at ACTIVATION_SHAPE in f32 and bf16, against the CPU on the same
    inputs."""
    from veles_torch.backends import TorchDevice
    from veles_torch.znicz.nn_units import forward_by_name, \
        gradient_unit_for
    gen = torch.Generator(device=HEALTH_DEVICE)
    gen.manual_seed(1337)
    x32 = 2.0 * torch.randn(ACTIVATION_SHAPE, generator=gen,
                            device=HEALTH_DEVICE)
    e32 = torch.randn(ACTIVATION_SHAPE, generator=gen, device=HEALTH_DEVICE)
    worst = {}
    for dname, tol in ACTIVATION_TOL.items():
        dtype = getattr(torch, dname)
        x, err = x32.to(dtype), e32.to(dtype)
        xc, ec = x.cpu(), err.cpu()
        for name in ("activation_tanh", "activation_relu", "activation_str",
                     "activation_sigmoid", "activation_log",
                     "activation_mul", "activation_tanhlog",
                     "activation_sincos"):
            got, want = [], []
            for dev_name, xi, ei, out in ((HEALTH_DEVICE, x, err, got),
                                          ("cpu", xc, ec, want)):
                dev = TorchDevice(dev_name)
                dev.act_dtype = dtype
                fwd = forward_by_name(name)()
                fwd.initialize(ACTIVATION_SHAPE, dev)
                gd = gradient_unit_for(type(fwd))().setup_forward(fwd)
                y = fwd(xi)
                out += [y, gd.run(xi, y, ei)]
            health_sync(torch)
            for part, a, b in zip(("forward", "backward"), got, want):
                b = b.double()
                e = float(((a.cpu().double() - b).abs()
                           / b.abs().clamp_min(1.0)).max())
                worst["%s %s %s" % (name, part, dname)] = e
                if not e <= tol or a.dtype != dtype:
                    fail("model_health %s %s %s: %.3g over %g (%s)"
                         % (name, part, dname, e, tol, a.dtype))
        del x, err, xc, ec
    emit({"phase": "model_health", "part": "activations",
          "shape": list(ACTIVATION_SHAPE), "tolerance": ACTIVATION_TOL,
          "max_err": worst})


def check_model_health(torch):
    """Phase model_health; -> its launches (the MNIST and 110M runs)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_health_")
    try:
        runs = health_mnist_strides(torch, tmp)
        runs += health_blowup(torch, tmp)
        runs += health_110m(torch)
        health_serving(torch)
        health_activations(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return add_counts(*runs)


# -- the unsupervised samples and the plotting plane -------------------------

KOHONEN_SAMPLE = os.path.join(MODELS, "kohonen.py")
RBM_SAMPLE = os.path.join(MODELS, "mnist_rbm.py")
UNSUPERVISED_SEED = 1337
#: the device of phases unsupervised and plots (a rehearsal on a host
#: without a card sets "cpu")
UNSUPERVISED_DEVICE = "cuda"
#: the SOM's quantization error on the card: below the reference test's
#: bar (tests/test_unsupervised.py), and within KOHONEN_QE_TOL of the
#: CPU's
KOHONEN_QE_MAX = 0.3
KOHONEN_QE_TOL = 1e-4
#: the SOM's final weights on the card against the CPU's, a share of the
#: largest weight: f32 products (TF32 off) summed in another order; a
#: winner that flips between the two (a near tie) moves a neighbourhood
#: and shows far above it
KOHONEN_CARD_ATOL = 1e-5
#: the RBM's validation error falls by 13% over the run and its last
#: value is within 35% of the CPU's (the reference's thresholds between
#: its own two backends, tests/test_unsupervised.py): the Binarization's
#: uniforms differ between devices
RBM_FALL = 0.87
RBM_CROSS_RTOL = 0.35
#: the plots phase's MNIST run: phase mnist's, with the confusion matrix
PLOTS_RUN = ("root.mnist.decision.max_epochs=3",
             "root.mnist.evaluator.compute_confusion=True")
#: the files the plotted MNIST run's renderer must write
MNIST_PLOTS = ("plot_metric", "plot_weights", "plot_confusion")
#: device reads a plotted MNIST epoch adds, all after its classes: the
#: first layer's weights (Weights2D) and the confusion matrix, one copy
#: each
PLOT_DEVICE_READS = 2
#: WeightDiversity's statistics against a float64 numpy recomputation
DIVERSITY_ATOL = 1e-6


def unsupervised_sync(torch):
    if UNSUPERVISED_DEVICE == "cuda":
        torch.cuda.synchronize()


def profile_run_epoch(torch, wf, trace_name):
    """One more epoch of ``wf`` (its units after the decision included)
    under torch.profiler: host ms, device busy ms, idle share, device
    operations in all and per step, the top operations; the trace goes
    to the output directory."""
    from torch.profiler import ProfilerActivity
    from veles_torch import model_health
    activities = [ProfilerActivity.CPU]
    if UNSUPERVISED_DEVICE == "cuda":
        activities.append(ProfilerActivity.CUDA)
    steps0 = wf.step.train_steps + wf.step.eval_steps
    unsupervised_sync(torch)
    with model_health.scoped(), counted_window(
            activities, lambda: unsupervised_sync(torch)) as prof:
        t0 = time.perf_counter()
        wf.step.run_epoch(wf._after_decision)
        unsupervised_sync(torch)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, n_ops, by_name, path = device_trace(prof, trace_name)
    steps = wf.step.train_steps + wf.step.eval_steps - steps0
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if n_ops else None,
            "device_ops": n_ops, "steps": steps,
            "device_ops_per_step": n_ops / steps,
            "top_device_ops": top_ops(by_name), "trace": path}


def unsupervised_runs(torch, sample):
    """``sample`` through the CLI at its own configuration on the CPU and
    on the card, under fresh monitors, the model-health plane on (no stat
    unit: neither trainer is a GD unit); -> ({device: workflow}, the card
    run's launches counted from 0)."""
    runs = {}
    for device in ("cpu", UNSUPERVISED_DEVICE):
        reset_counts()
        wf = cli_run([sample, "--seed", str(UNSUPERVISED_SEED), "-d",
                      device])
        unsupervised_sync(torch)
        check_params_finite(torch, wf, "%s %s"
                            % (os.path.basename(sample), device))
        if wf.step.stat_units:
            fail("%s: stat units %s (no GD unit on the path)"
                 % (sample, wf.step.stat_units))
        runs[device] = wf
    return runs, read_counts()


def quantization_error(x, w):
    import numpy
    d = ((x[:, None, :] - w[None, :, :]) ** 2).sum(axis=-1)
    return float(numpy.sqrt(d.min(axis=1)).mean())


def cross_resume(torch, module, runs, tmp):
    """Each run's checkpoint restored by a fresh workflow on the other
    device (the same seed, so the same data): every array bit for bit,
    then one more epoch; -> {direction: checkpoint bytes}."""
    import numpy
    from veles_torch import model_health, prng
    from veles_torch import snapshotter as TS
    out = {}
    for src, dst in (("cpu", UNSUPERVISED_DEVICE),
                     (UNSUPERVISED_DEVICE, "cpu")):
        wf = runs[src]
        tree = wf.checkpoint_state()
        uri, nbytes = TS.write_checkpoint(
            TS.FileSnapshotStore(tmp), "%s_%s_initial.ckpt.npz"
            % (wf.name, src), tree, compression="")
        prng.seed_all(UNSUPERVISED_SEED)
        with model_health.scoped():
            fresh = module.create_workflow(name=wf.name)
            fresh.initialize(device=dst)
            fresh.restore_state(TS.load_snapshot(uri))
            for section in ("params", "state"):
                for unit, sub in tree[section].items():
                    got = fresh.units()[unit].export_params() \
                        if section == "params" \
                        else fresh.units()[unit].export_state()
                    for key, value in sub.items():
                        if not numpy.array_equal(
                                got[key].cpu().numpy(), value):
                            fail("%s: %s/%s/%s of the %s checkpoint "
                                 "restored on %s differs" % (
                                     wf.name, section, unit, key, src, dst))
            epochs = len(fresh.decision.history)
            fresh.decision.max_epochs = epochs + 1
            fresh.run()
            unsupervised_sync(torch)
        if len(fresh.decision.history) != epochs + 1:
            fail("%s resumed on %s: %d epochs in the history, expected %d"
                 % (wf.name, dst, len(fresh.decision.history), epochs + 1))
        check_params_finite(torch, fresh, "%s resumed on %s" % (wf.name, dst))
        out["%s->%s" % (src, dst)] = nbytes
    return out


def check_kohonen(torch, tmp):
    """The SOM: quantization error, weights against the CPU, the
    checkpoint both ways, one profiled epoch; -> the card run's
    launches."""
    import numpy
    from veles_torch.znicz.models import kohonen
    runs, counts = unsupervised_runs(torch, KOHONEN_SAMPLE)
    cpu, card = runs["cpu"], runs[UNSUPERVISED_DEVICE]
    x = card.loader.original_data
    w_cpu = cpu.forwards[0].weights.cpu().numpy()
    w_card = card.forwards[0].weights.cpu().numpy()
    qe = {"cpu": quantization_error(x, w_cpu),
          "card": quantization_error(x, w_card)}
    diff = float(numpy.abs(w_card - w_cpu).max())
    limit = KOHONEN_CARD_ATOL * float(numpy.abs(w_cpu).max())
    metric = {d: [h["train"]["metric"] for h in wf.decision.history]
              for d, wf in (("cpu", cpu), ("card", card))}
    steps = card.step.train_steps
    ckpt = cross_resume(torch, kohonen, runs, tmp)
    prof = profile_run_epoch(torch, card, "kohonen_epoch_trace.json")
    emit({"phase": "unsupervised", "sample": "kohonen",
          "train_steps": steps, "launches": counts,
          "epoch_ms": [1e3 * t for t in card.step.epoch_seconds],
          "quantization_error": qe, "weights_max_abs_diff": diff,
          "weights_limit": limit, "train_metric": metric,
          "checkpoint_bytes": ckpt, "profile": prof})
    if len(metric["card"]) != len(metric["cpu"]):
        fail("kohonen: %d epochs on the card, %d on the CPU"
             % (len(metric["card"]), len(metric["cpu"])))
    if not qe["card"] < KOHONEN_QE_MAX \
            or abs(qe["card"] - qe["cpu"]) > KOHONEN_QE_TOL:
        fail("kohonen: quantization error %s" % qe)
    if not diff <= limit:
        fail("kohonen: final weights %.3g from the CPU's (limit %.3g)"
             % (diff, limit))
    return counts


def check_rbm(torch, tmp):
    """The RBM: the validation error falls and ends near the CPU's, the
    checkpoint both ways, one profiled epoch; -> the card run's
    launches."""
    from veles_torch.znicz.models import mnist_rbm
    runs, counts = unsupervised_runs(torch, RBM_SAMPLE)
    hist = {d: [h["validation"]["metric"] for h in wf.decision.history]
            for d, wf in (("cpu", runs["cpu"]),
                          ("card", runs[UNSUPERVISED_DEVICE]))}
    card = runs[UNSUPERVISED_DEVICE]
    steps = (card.step.train_steps, card.step.eval_steps)
    ckpt = cross_resume(torch, mnist_rbm, runs, tmp)
    prof = profile_run_epoch(torch, card, "rbm_epoch_trace.json")
    emit({"phase": "unsupervised", "sample": "mnist_rbm",
          "train_steps": steps[0], "eval_steps": steps[1],
          "launches": counts,
          "epoch_ms": [1e3 * t for t in card.step.epoch_seconds],
          "validation_mse": hist, "checkpoint_bytes": ckpt,
          "profile": prof})
    for device, h in hist.items():
        if not h[-1] < RBM_FALL * h[0]:
            fail("rbm on %s: the validation error fell from %.4g to %.4g, "
                 "not by %.0f%%" % (device, h[0], h[-1],
                                    100 * (1 - RBM_FALL)))
    rel = abs(hist["card"][-1] - hist["cpu"][-1]) / hist["cpu"][-1]
    if not rel < RBM_CROSS_RTOL:
        fail("rbm: last validation error %.4g on the card, %.4g on the CPU"
             % (hist["card"][-1], hist["cpu"][-1]))
    return counts


def check_unsupervised(torch):
    """Phase unsupervised; -> its launches (none of the kernels is on
    either path)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_unsupervised_")
    try:
        counts = add_counts(check_kohonen(torch, tmp), check_rbm(torch, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if any(counts.values()):
        fail("unsupervised: kernel launches %s, expected none" % counts)
    return counts


def check_pngs(out, names):
    """Each ``names`` PNG in ``out`` decodes to a non-constant image and
    ``plots.json`` names it; -> {name: (height, width)}."""
    from veles_torch.graphics_client import read_png
    with open(os.path.join(out, "plots.json")) as f:
        index = json.load(f)
    shapes = {}
    for name in names:
        entry = index.get(name)
        if entry is None or entry["file"] != name + ".png":
            fail("plots.json of %s: %r for %s" % (out, entry, name))
        img = read_png(os.path.join(out, entry["file"]))
        if not img.std() > 0:
            fail("%s/%s is a constant image" % (out, entry["file"]))
        shapes[name] = list(img.shape[:2])
    return shapes


def diversity_errors(wf):
    """WeightDiversity of MNIST's first layer against a float64 numpy
    recomputation from the exported weights; -> (stats, {field: error})."""
    import numpy
    from veles_torch.znicz.diversity import WeightDiversity
    unit = WeightDiversity(wf)
    unit.make_payload()
    rows = wf.forwards[0].export_params()["weights"].cpu().numpy() \
        .astype(numpy.float64).T
    norms = numpy.linalg.norm(rows, axis=1)
    unit_rows = rows / numpy.where(norms == 0, 1.0, norms)[:, None]
    sim = unit_rows @ unit_rows.T
    off = numpy.abs(sim[~numpy.eye(len(sim), dtype=bool)])
    want = {"n_units": len(rows), "mean_abs_similarity": off.mean(),
            "max_abs_similarity": off.max(),
            "similar_pairs": int((numpy.abs(numpy.triu(sim, 1))
                                  >= unit.threshold).sum()),
            "dead_units": int((norms == 0).sum())}
    return unit.stats, {k: abs(unit.stats[k] - v) for k, v in want.items()}


def plotted_epoch_ops(torch, wf):
    """Device operations of a MNIST epoch without and with the plotters,
    in turns (without, with, with, without), with the layer stats off: at
    stride 8 the 60 train steps of an epoch hold 7 or 8 due steps. The
    first epoch after the CLI run is counted apart, without the plotters:
    on an H100 host it once read 33 operations more than the same epoch
    at the end (7206, 7175, 7175, 7173 with it in the turns); -> (the
    turns' counts, the first epoch's count, {name: how many more of it
    the first epoch ran than the last}: what those operations are)."""
    from torch.profiler import ProfilerActivity
    from veles_torch import model_health
    plotters, ops, names = wf.plotters, [], []
    wf.step.set_stats_enabled(False)
    sync = functools.partial(unsupervised_sync, torch)
    for plotted in (False, False, True, True, False):
        wf.plotters = plotters if plotted else []
        sync()
        with model_health.scoped(), counted_window(
                [ProfilerActivity.CPU, ProfilerActivity.CUDA], sync) as prof:
            wf.step.run_epoch(wf._after_decision)
        names.append(device_ops_by_name(prof))
        ops.append(sum(names[-1].values()))
    wf.plotters = plotters
    wf.step.set_stats_enabled(True)
    extra = dict(names[0] - names[-1])
    extra.update({k: -v for k, v in (names[-1] - names[0]).items()})
    return ops[1:], ops[0], extra


def check_plots(torch):
    """Phase plots; -> the plotted MNIST run's launches."""
    import shutil
    import tempfile
    from veles_torch import model_health, prng
    from veles_torch.config import root
    from veles_torch.launcher import Launcher
    from veles_torch.znicz import nn_plotting_units as P
    from veles_torch.znicz.models import kohonen
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plots_")
    try:
        out = os.path.join(tmp, "mnist")
        reset_counts()
        wf = cli_run([MNIST_SAMPLE, *PLOTS_RUN, "--seed",
                      str(UNSUPERVISED_SEED), "-d", UNSUPERVISED_DEVICE,
                      "--graphics-dir", out])
        unsupervised_sync(torch)
        counts = read_counts()
        root.mnist.evaluator.compute_confusion = False
        train = wf.step.train_steps
        per_step = train if UNSUPERVISED_DEVICE == "cuda" else 0
        want = dict({name: 0 for name in counts},
                    **{"bias_grad[identity]": per_step,
                       "bias_grad[masked]": per_step})
        shapes = check_pngs(out, MNIST_PLOTS)
        stats, errors = diversity_errors(wf)
        ops, first, extra = plotted_epoch_ops(torch, wf) \
            if UNSUPERVISED_DEVICE == "cuda" else (None, None, None)
        som_out = os.path.join(tmp, "kohonen")
        prng.seed_all(UNSUPERVISED_SEED)
        with model_health.scoped():
            som = kohonen.create_workflow(name="KohonenPlots")
            som.plotters += [
                P.KohonenHits(som, forward=som.forwards[0],
                              name="som_hits"),
                P.KohonenNeighborMap(som, forward=som.forwards[0],
                                     name="som_umatrix")]
            launcher = Launcher(device=UNSUPERVISED_DEVICE,
                                graphics_dir=som_out)
            launcher.initialize(som)
            launcher.run()
        shapes.update(check_pngs(som_out, ("som_hits", "som_umatrix")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "plots", "train_steps": train, "launches": counts,
          "png_shapes": shapes, "diversity": stats,
          "diversity_errors": errors,
          "epoch_device_ops_without_with_with_without": ops,
          "first_epoch_device_ops": first, "first_epoch_extra_ops": extra,
          "plot_device_reads": PLOT_DEVICE_READS})
    if counts != want:
        fail("plots: launches %s, expected %s" % (counts, want))
    over = {k: e for k, e in errors.items() if not e <= DIVERSITY_ATOL}
    if over:
        fail("plots: WeightDiversity off the numpy recomputation: %s" % over)
    if ops is not None and (ops[1] - ops[0] != PLOT_DEVICE_READS
                            or ops[2] - ops[3] != PLOT_DEVICE_READS):
        fail("plots: device operations of an epoch without/with the plots "
             "%s, expected %d more with" % (ops, PLOT_DEVICE_READS))
    return counts


# -- the serving plane over HTTP ---------------------------------------------

#: the device of the serve_http phase (the CPU only to rehearse it)
SERVE_HTTP_DEVICE = "cuda"
#: phase mnist's run, its checkpoints written through the HTTP store: the
#: improvement-gated ones and a rolling one at every class boundary
SERVE_HTTP_RUN = ("root.mnist.decision.max_epochs=3", "--seed", "1337",
                  "--checkpoint-every", "0.001")
#: the LM archive the server decodes (None: the 110M one serve_decode
#: exported)
SERVE_HTTP_LM = None
#: the predict buckets timed over HTTP and in process, requests each
HTTP_BUCKETS, HTTP_TIMED = (1, 8, 64), 20
#: seconds the server may take to print its first line, and a refresh
#: or a disconnect to show
HTTP_START_S, HTTP_WAIT_S = 300.0, 60.0
#: serve_decode's 110M f32 row (tokens/s, first-token latency), what the
#: HTTP decode is held beside
SERVE_DECODE_ROW = {}
#: the serving families the server's /metrics must export
HTTP_FAMILIES = ("veles_serving_requests_total", "veles_serving_batches_total",
                 "veles_serving_latency_seconds", "veles_serving_queue_rows",
                 "veles_serving_model_version",
                 "veles_serving_checkpoint_wall_seconds",
                 "veles_serving_forward_cache_bytes",
                 "veles_serving_generated_tokens_total",
                 "veles_serving_kv_pool_slots",
                 "veles_serving_kv_slots_in_use",
                 "veles_serving_first_token_seconds",
                 "veles_serving_rejected_total",
                 "veles_serving_tenant_requests_total",
                 "veles_checkpoint_diverged_skips_total")


@contextlib.contextmanager
def http_store(directory):
    """A stdlib HTTP server speaking the snapshot-store protocol over
    ``directory`` (GET/PUT/DELETE ``<base>/<name>``, GET ``<base>/`` the
    JSON list); -> the base URL. Shut down on exit."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    os.makedirs(directory, exist_ok=True)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _name(self):
            name = self.path.rstrip("/").rsplit("/", 1)[-1]
            return "" if name == "store" else name

        def _send(self, code, body=b""):
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            name = self._name()
            if not name:
                return self._send(200, json.dumps(
                    sorted(os.listdir(directory))).encode())
            try:
                with open(os.path.join(directory, name), "rb") as f:
                    self._send(200, f.read())
            except OSError:
                self._send(404)

        def do_PUT(self):
            data = self.rfile.read(int(self.headers["Content-Length"]))
            tmp = os.path.join(directory, "." + self._name())
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, os.path.join(directory, self._name()))
            self._send(201)

        def do_DELETE(self):
            try:
                os.remove(os.path.join(directory, self._name()))
            except OSError:
                pass
            self._send(204)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:%d/store" % httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()


def http_call(port, path, doc=None, headers=None, timeout=120.0):
    """One request to the server on ``port`` (POST when ``doc`` is given);
    -> (status, JSON body or text, headers)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=None if doc is None else json.dumps(doc).encode(),
        headers=dict(headers or {}),
        method="GET" if doc is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, body, hdr = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as exc:
        code, body, hdr = exc.code, exc.read(), exc.headers
    ctype = hdr.get("Content-Type", "")
    return code, (json.loads(body) if "json" in ctype else body.decode()), \
        dict(hdr)


def http_stream(port, doc, stop_after=None):
    """POST /v1/generate on a raw socket and read the chunked ndjson; ->
    (lines, ms to the first token line, seconds to the end). With
    ``stop_after`` the socket closes after that many lines (a client
    that leaves mid-stream)."""
    import socket
    body = json.dumps(doc).encode()
    t0 = time.perf_counter()
    first = None
    sock = socket.create_connection(("127.0.0.1", port), timeout=600)
    try:
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     b"%d\r\n\r\n" % len(body) + body)
        buf, lines = b"", []
        while b"\r\n\r\n" not in buf:
            buf += sock.recv(65536)
        head, buf = buf.split(b"\r\n\r\n", 1)
        if b" 200 " not in head.split(b"\r\n")[0] \
                or b"transfer-encoding: chunked" not in head.lower():
            fail("serve_http: /v1/generate answered %r" % head[:200])
        while True:
            while b"\r\n" not in buf:
                more = sock.recv(65536)
                if not more:
                    return lines, first, time.perf_counter() - t0
                buf += more
            size_s, buf = buf.split(b"\r\n", 1)
            size = int(size_s, 16)
            if size == 0:
                return lines, first, time.perf_counter() - t0
            while len(buf) < size + 2:
                buf += sock.recv(65536)
            for line in buf[:size].decode().splitlines():
                lines.append(json.loads(line))
                if first is None and "token" in lines[-1]:
                    first = 1e3 * (time.perf_counter() - t0)
                if stop_after is not None and len(lines) >= stop_after:
                    return lines, first, time.perf_counter() - t0
            buf = buf[size + 2:]
    finally:
        sock.close()


@contextlib.contextmanager
def serve_subprocess(args, record):
    """``python -m veles_torch serve --port 0 ARGS`` in a child process,
    its output copied to ``serve_http_server.log`` in the output
    directory; -> (its first JSON line, its port). On exit it gets
    SIGTERM (a kill past 30 s); ``record["exit_code"]`` is its exit code,
    ``record["alive_at_end"]`` whether it still ran when asked to stop."""
    import threading
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_torch", "serve", "--port", "0",
         *args], cwd=HERE, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    first = {}
    ready = threading.Event()
    reader = None
    with open(os.path.join(OUT_DIR, "serve_http_server.log"), "w") as log:

        def pump():
            for line in proc.stdout:
                log.write(line)
                log.flush()
                if not first and line.startswith("{"):
                    first.update(json.loads(line))
                    ready.set()
            ready.set()

        try:
            reader = threading.Thread(target=pump, daemon=True)
            reader.start()
            if not ready.wait(HTTP_START_S) or not first:
                fail("serve_http: the server printed no JSON line in %gs "
                     "(exit code %s)" % (HTTP_START_S, proc.poll()))
            yield first, int(first["serving"].rsplit(":", 1)[1])
        finally:
            record["alive_at_end"] = proc.poll() is None
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if reader is not None:
                reader.join(timeout=10)
            record["exit_code"] = proc.returncode


def poll_until(fn, what, timeout=HTTP_WAIT_S):
    """Call ``fn`` until it returns a true value; -> that value (fails
    the run past ``timeout`` seconds)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    fail("serve_http: timed out waiting for %s" % what)


def percentiles_ms(seconds):
    import numpy
    ms = 1e3 * numpy.asarray(seconds)
    return {"p50_ms": float(numpy.percentile(ms, 50)),
            "p99_ms": float(numpy.percentile(ms, 99))}


def http_predict(torch, port, engine, host, served):
    """Concurrent /v1/predict clients against the in-process engine, and
    the per-bucket latency and rows/s over HTTP and in process; -> the
    row."""
    import threading
    want = engine.predict(host)[0]
    results, errors = [], []

    def client(c):
        for r in range(SERVE_REQUESTS):
            i = (c * SERVE_REQUESTS + r) % len(host)
            code, doc, _ = http_call(port, "/v1/predict", {
                "model": "mnist", "inputs": host[i:i + 1].tolist(),
                "timeout_ms": 60000})
            if code != 200:
                errors.append("%d %s" % (code, doc))
            else:
                results.append((i, doc["version"], doc["outputs"]))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    err = max((max_rel(out, want[i:i + 1]) for i, _, out in results),
              default=None)
    versions = sorted({v for _, v, _ in results})
    metrics = http_call(port, "/metrics.json")[1]["models"]["mnist"]
    row = {"clients": SERVE_CLIENTS,
           "requests": SERVE_CLIENTS * SERVE_REQUESTS,
           "seconds": seconds, "requests_per_sec": len(results) / seconds,
           "max_rel_err_vs_in_process": err, "versions": versions,
           "batch_fill_ratio": metrics["batch_fill_ratio"],
           "bucket_pad_ratio": metrics["bucket_pad_ratio"]}
    if errors or len(results) != SERVE_CLIENTS * SERVE_REQUESTS:
        fail("serve_http predict: %s" % ("; ".join(errors[:4])
                                         or "requests lost"))
    if not err <= SERVE_RTOL or versions != [served]:
        fail("serve_http predict: %.3g from the in-process engine (bound "
             "%g), versions %s (want [%d])" % (err, SERVE_RTOL, versions,
                                               served))
    if not metrics["batch_fill_ratio"] > 1:
        fail("serve_http predict: batch fill %s under %d concurrent clients"
             % (metrics["batch_fill_ratio"], SERVE_CLIENTS))
    buckets = {}
    for b in HTTP_BUCKETS:
        over, inproc = [], []
        for _ in range(HTTP_TIMED):
            t0 = time.perf_counter()
            code, _, _ = http_call(port, "/v1/predict", {
                "model": "mnist", "inputs": host[:b].tolist()})
            over.append(time.perf_counter() - t0)
            if code != 200:
                fail("serve_http predict: bucket %d answered %d" % (b, code))
            t0 = time.perf_counter()
            engine.predict(host[:b])
            inproc.append(time.perf_counter() - t0)
        buckets[b] = {
            "http": dict(percentiles_ms(over),
                         rows_per_sec=b * len(over) / sum(over)),
            "in_process": dict(percentiles_ms(inproc),
                               rows_per_sec=b * len(inproc) / sum(inproc))}
    row["buckets"] = buckets
    return row


def http_decode(torch, port, lm_path):
    """Greedy /v1/generate of the LM streamed over a raw socket and not
    streamed, against the in-process decode of the same archive token for
    token; DECODE_REQUESTS concurrent streams' tokens/s and first-token
    latency beside serve_decode's; a client leaving mid-stream frees its
    KV slot and is counted; -> the row."""
    import threading
    from veles_torch.serving import (ArchiveModel, ContinuousBatcher,
                                     GenerativeEngine)
    model = ArchiveModel.from_dir(lm_path, device=SERVE_HTTP_DEVICE)
    vocab = int(model.units[0]["config"]["vocab_size"])
    prompts = periodic_prompts(DECODE_REQUESTS, vocab, DECODE_PROMPT)
    engine = GenerativeEngine(model, n_slots=DECODE_SLOTS,
                              max_len=DECODE_MAX_LEN,
                              device=SERVE_HTTP_DEVICE)
    batcher = ContinuousBatcher(engine)
    try:
        want = [batcher.generate(p, max_tokens=DECODE_NEW, wait_s=600)
                for p in prompts[:2]]
    finally:
        batcher.close()
    del engine, batcher, model
    got_stream, got_once, first_ms = [], [], []
    for p in prompts[:2]:
        lines, first, _ = http_stream(port, {"model": "lm", "prompt": p,
                                             "max_tokens": DECODE_NEW})
        if not lines or not lines[-1].get("done"):
            fail("serve_http decode: the stream ended without its done "
                 "line: %s" % lines[-2:])
        got_stream.append([ln["token"] for ln in lines[1:-1]])
        first_ms.append(first)
        code, doc, _ = http_call(port, "/v1/generate", {
            "model": "lm", "prompt": p, "max_tokens": DECODE_NEW,
            "stream": False})
        got_once.append(doc.get("tokens") if code == 200 else code)
    if not got_stream == want == got_once:
        fail("serve_http decode: streamed %s, one reply %s, in process %s"
             % ([t[:8] for t in got_stream], [t[:8] if isinstance(t, list)
                                              else t for t in got_once],
                [t[:8] for t in want]))
    streams = [None] * len(prompts)

    def stream(i):
        streams[i] = http_stream(port, {"model": "lm", "prompt": prompts[i],
                                        "max_tokens": DECODE_NEW})

    threads = [threading.Thread(target=stream, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    n = sum(len(s[0]) - 2 for s in streams)
    if n != len(prompts) * DECODE_NEW:
        fail("serve_http decode: %d tokens for %d streams" % (n, len(prompts)))
    # a client leaving mid-stream
    lines, _, _ = http_stream(port, {"model": "lm", "prompt": prompts[0],
                                     "max_tokens": DECODE_MAX_LEN
                                     - len(prompts[0])}, stop_after=3)

    def freed():
        doc = http_call(port, "/metrics.json")[1]["models"]["lm"]["decode"]
        text = http_call(port, "/metrics")[1]
        seen = re.search(r'veles_serving_rejected_total\{reason="disconnect",'
                         r'tenant="[^"]*"\} (\d+)', text)
        return doc if doc["kv_slots_in_use"] == 0 and seen \
            and int(seen.group(1)) == 1 else None

    after = poll_until(freed, "the disconnected stream's KV slot")
    import numpy
    first_all = [s[1] for s in streams]
    return {"greedy_tokens_equal": True, "new_tokens": DECODE_NEW,
            "first_token_ms_single": first_ms,
            "streams": len(prompts), "seconds": seconds,
            "tokens_per_sec_http": n / seconds,
            "first_token_ms_p50_http": float(numpy.median(first_all)),
            "first_token_ms_max_http": float(max(first_all)),
            "serve_decode_in_process": {
                k: SERVE_DECODE_ROW.get(k) for k in (
                    "tokens_per_sec_continuous", "first_token_ms_p50",
                    "first_token_ms_max")},
            "after_disconnect": {k: after[k] for k in (
                "kv_slots_in_use", "kv_pool_slots", "generated_tokens_total",
                "steps_total")}}


def check_serve_http(torch):
    """Phase serve_http: the serving plane over HTTP on the card, the
    kernels' counts set to 0 just before and read just after; -> the
    counts."""
    import shutil
    import tempfile
    from veles_torch import snapshotter, telemetry
    from veles_torch.serving import ArchiveModel, InferenceEngine
    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    server = {}
    row = {"phase": "serve_http"}
    try:
        with http_store(os.path.join(tmp, "store")) as base:
            reset_counts()
            mnist = os.path.join(tmp, "mnist")
            wf = cli_run([MNIST_SAMPLE, *SERVE_HTTP_RUN, "-d",
                          SERVE_HTTP_DEVICE, "--snapshots", base,
                          "--export-inference", mnist])
            if SERVE_HTTP_DEVICE == "cuda":
                torch.cuda.synchronize()
            steps = wf.step.train_steps
            valid = [i for i in snapshotter.scan_checkpoints(base)
                     if i.status == "valid"]
            if len(valid) < 2:
                fail("serve_http: %d valid checkpoints in the HTTP store"
                     % len(valid))
            oldest, newest = valid[-1], valid[0]
            lm = SERVE_HTTP_LM or archive_dir("lm_110M")
            args = ["-d", SERVE_HTTP_DEVICE, "--model", "mnist=" + mnist,
                    "--model", "lm=" + lm,
                    "--checkpoint", "mnist=%s/%s" % (base, oldest.name),
                    "--refresh-every", "1",
                    "--decode-slots", str(DECODE_SLOTS),
                    "--decode-max-len", str(DECODE_MAX_LEN),
                    "--max-batch", "64", "--timeout-ms", "60000"]
            t0 = time.perf_counter()
            with serve_subprocess(args, server) as (first, port):
                row["server_start_seconds"] = time.perf_counter() - t0
                row["first_line"] = first
                models = {m["name"]: m for m in first["models"]}
                if models["mnist"]["backend"] != "torch:" \
                        + SERVE_HTTP_DEVICE:
                    fail("serve_http: the server's backend is %s"
                         % models["mnist"]["backend"])

                def version(v):
                    doc = http_call(port, "/v1/models")[1]["models"]
                    entry = {m["name"]: m for m in doc}["mnist"]
                    return entry if entry["version"] == v else None

                entry = poll_until(lambda: version(2),
                                   "the newer checkpoint as version 2")
                if not entry["checkpoint"].endswith("/" + newest.name):
                    fail("serve_http: version 2 serves %s, not the newest %s"
                         % (entry["checkpoint"], newest.name))
                code, ready, _ = http_call(port, "/readyz")
                if code != 200 or not ready["ready"]:
                    fail("serve_http: /readyz %d %s" % (code, ready))
                model = ArchiveModel.from_dir(mnist, device=SERVE_HTTP_DEVICE)
                model.load_checkpoint("%s/%s" % (base, newest.name))
                engine = InferenceEngine(model, max_batch=64,
                                         device=SERVE_HTTP_DEVICE)
                host = serving_rows(wf).cpu().numpy()
                row["predict"] = http_predict(torch, port, engine, host, 2)
                # a client's trace reaches the server's spans
                tp = telemetry.TraceContext.new()
                code, _, hdr = http_call(
                    port, "/v1/predict",
                    {"model": "mnist", "inputs": host[:2].tolist()},
                    headers={"traceparent": tp.to_traceparent()})
                echoed = telemetry.TraceContext.from_traceparent(
                    hdr.get("traceparent"))
                spans = [e for e in http_call(port, "/debug/trace")[1]
                         ["traceEvents"] if e.get("args", {}).get(
                             "trace_id") == tp.trace_id]
                names = sorted({e["name"] for e in spans})
                row["trace_spans"] = names
                if code != 200 or echoed is None \
                        or echoed.trace_id != tp.trace_id \
                        or "http.predict" not in names:
                    fail("serve_http: traceparent %s echoed %s, spans %s"
                         % (tp.trace_id, hdr.get("traceparent"), names))
                row["decode"] = http_decode(torch, port, lm)
                # a newer checkpoint stamped diverged: skipped and counted
                state, _ = snapshotter.load_snapshot_meta(
                    "%s/%s" % (base, newest.name))
                snapshotter.write_checkpoint(
                    snapshotter.store_for_base(base),
                    "zz_diverged.ckpt.npz.gz", state,
                    extra_meta={"model_health": {"verdict": "diverged"}})

                def skipped():
                    text = http_call(port, "/metrics")[1]
                    m = re.search(r"^veles_checkpoint_diverged_skips_total "
                                  r"(\S+)$", text, re.M)
                    return (float(m.group(1)), text) \
                        if m and float(m.group(1)) >= 1 else None

                skips, text = poll_until(skipped,
                                         "the diverged checkpoint skipped")
                row["diverged_skips"] = skips
                if version(2) is None:
                    fail("serve_http: the diverged checkpoint was loaded")
                missing = [f for f in HTTP_FAMILIES
                           if "# TYPE %s " % f not in text]
                row["missing_families"] = missing
                if missing:
                    fail("serve_http: /metrics lacks %s" % missing)
                row["server_metrics"] = http_call(port, "/metrics.json")[1]
            if SERVE_HTTP_DEVICE == "cuda":
                torch.cuda.synchronize()
            counts = read_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row.update(launches=counts, train_steps=steps,
               server_exit_code=server.get("exit_code"),
               server_alive_at_end=server.get("alive_at_end"))
    emit(row)
    per_step = steps if SERVE_HTTP_DEVICE == "cuda" else 0
    want = dict({name: 0 for name in counts},
                **{"bias_grad[identity]": per_step,
                   "bias_grad[masked]": per_step})
    if counts != want:
        fail("serve_http: launches %s, expected %s" % (counts, want))
    if not server.get("alive_at_end") or server.get("exit_code") != 0:
        fail("serve_http: the server was alive at the end: %s, exit code %s"
             % (server.get("alive_at_end"), server.get("exit_code")))
    return counts


# -- ensembles, the genetic search, the shell and the forge client -----------

#: the device of phases ensemble, optimize and shell_forge (the CPU only to
#: rehearse them)
SEARCH_DEVICE = "cuda"
#: phase ensemble: the full-width MNIST sample, 3 members of 3 epochs each
ENSEMBLE_RUN = ("root.mnist.decision.max_epochs=3", "--seed", "1337",
                "--ensemble", "3")
#: phase optimize: the config file marking both layers' learning rates
#: searchable (the reference test's), and the run of every individual
OPTIMIZE_CONFIG = (
    "from veles_torch.config import root, Tune\n"
    "for layer in root.mnist.layers:\n"
    "    if '<-' in layer:\n"
    "        layer['<-']['learning_rate'] = Tune(0.02, 0.005, 0.1)\n")
OPTIMIZE_RUN = ("root.mnist.decision.max_epochs=2", "--seed", "1337")
#: GENSxPOP in process, then with WORKERS processes sharing the card
OPTIMIZE_SEARCH = "2x4"
OPTIMIZE_WORKERS = 2
#: the search's evaluations: POP, then POP - elite (2) a generation
OPTIMIZE_EVALUATIONS = 8
#: what each worker records of its individuals (one JSON line each)
WORKER_LOG = os.path.join(OUT_DIR, "optimize_workers.jsonl")
#: phase shell_forge: the shell stops the run at the first epoch's end of
#: these; the fetched checkpoint then resumes to the second
SHELL_MAX_EPOCHS = 3
MNIST_TRAIN_STEPS = 60


class TimedTrainer:
    """A genetic-search fitness (the port's ``SubprocessTrainer``) that
    appends each individual's seconds, peak device memory and launches to
    ``WORKER_LOG``, from the worker that ran it."""

    def __init__(self, trainer):
        self.trainer = trainer

    def __call__(self, values):
        import torch
        from veles_torch.znicz.ops.bias_grad import bias_grad
        card = torch.cuda.is_available()
        reset_counts()
        if card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fitness = self.trainer(values)
        if card:
            torch.cuda.synchronize()
        row = {"pid": os.getpid(), "values": values, "fitness": fitness,
               "seconds": time.perf_counter() - t0,
               "launches": dict(bias_grad.form_launches),
               "peak_allocated_bytes":
                   torch.cuda.max_memory_allocated() if card else 0,
               "reserved_bytes": torch.cuda.memory_reserved() if card else 0}
        with open(WORKER_LOG, "a") as f:
            f.write(json.dumps(row) + "\n")
        return fitness


def search_sync(torch):
    if SEARCH_DEVICE == "cuda":
        torch.cuda.synchronize()


def expect_mnist_launches(counts, train_steps, where):
    """Every flash count 0, one launch of each bias-gradient form a train
    step (none on the CPU)."""
    per_step = train_steps if SEARCH_DEVICE == "cuda" else 0
    want = dict({name: 0 for name in counts},
                **{"bias_grad[identity]": per_step,
                   "bias_grad[masked]": per_step})
    if counts != want:
        fail("%s: launches %s, expected %s" % (where, counts, want))


def check_ensemble(torch):
    """Phase ensemble: ``--ensemble 3`` of the full-width MNIST; -> its
    launches."""
    reset_counts()
    t0 = time.perf_counter()
    ens = cli_run([MNIST_SAMPLE, *ENSEMBLE_RUN, "-d", SEARCH_DEVICE])
    search_sync(torch)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    t1 = time.perf_counter()
    report = ens.evaluate_classification()
    eval_seconds = time.perf_counter() - t1
    emit({"phase": "ensemble", "report": report, "seconds": seconds,
          "evaluate_seconds": eval_seconds, "launches": counts,
          "member_histories": [[h["validation"]["metric"]
                                for h in wf.decision.history]
                               for wf in ens.workflows]})
    errors = report["member_errors"]
    if report["n_valid"] != 1000 or len(errors) != 3:
        fail("ensemble: report %s, expected 3 members over 1000 rows"
             % report)
    if not report["ensemble_error"] <= max(errors):
        fail("ensemble: error %.4f above its weakest member's %.4f"
             % (report["ensemble_error"], max(errors)))
    expect_mnist_launches(counts, 3 * 3 * MNIST_TRAIN_STEPS, "ensemble")
    return counts


def check_optimize(torch, tmp):
    """Phase optimize: the search in process, then in worker processes
    sharing the card; -> (the in-process launches, the workers')."""
    from veles_torch import genetics
    cfg = os.path.join(tmp, "ga_config.py")
    with open(cfg, "w") as f:
        f.write(OPTIMIZE_CONFIG)
    argv = [MNIST_SAMPLE, cfg, *OPTIMIZE_RUN, "-d", SEARCH_DEVICE,
            "--optimize"]
    reset_counts()
    t0 = time.perf_counter()
    seq = cli_run(argv + [OPTIMIZE_SEARCH])
    search_sync(torch)
    seq_seconds = time.perf_counter() - t0
    counts = read_counts()
    # the CLI's worker branch, each individual it sends to a worker timed
    # there (TimedTrainer)
    plain = genetics.ProcessPoolMap

    class TimedPool(plain):
        def __call__(self, f, xs):
            return plain.__call__(
                self, genetics._SafeEval(TimedTrainer(f.evaluate)), xs)

    open(WORKER_LOG, "w").close()
    genetics.ProcessPoolMap = TimedPool
    try:
        reset_counts()
        t0 = time.perf_counter()
        par = cli_run(argv + ["%sx%d" % (OPTIMIZE_SEARCH, OPTIMIZE_WORKERS)])
        par_seconds = time.perf_counter() - t0
    finally:
        genetics.ProcessPoolMap = plain
    parent = read_counts()
    with open(WORKER_LOG) as f:
        rows = [json.loads(line) for line in f]
    workers = {}
    for row in rows:
        w = workers.setdefault(row["pid"], {"individuals": 0,
                                            "peak_allocated_bytes": 0,
                                            "reserved_bytes": 0})
        w["individuals"] += 1
        for key in ("peak_allocated_bytes", "reserved_bytes"):
            w[key] = max(w[key], row[key])
    worker_counts = dict({name: 0 for name in counts}, **{
        "bias_grad[%s]" % form: sum(r["launches"][form] for r in rows)
        for form in ("identity", "masked")})
    emit({"phase": "optimize", "search": OPTIMIZE_SEARCH,
          "workers": OPTIMIZE_WORKERS,
          "in_process": {"best_fitness": seq.best_fitness,
                         "best_values": seq.best_values,
                         "evaluations": seq.evaluations,
                         "history": seq.history, "seconds": seq_seconds,
                         "seconds_per_individual":
                             seq_seconds / max(seq.evaluations, 1),
                         "launches": counts},
          "parallel": {"best_fitness": par.best_fitness,
                       "best_values": par.best_values,
                       "evaluations": par.evaluations,
                       "history": par.history, "seconds": par_seconds,
                       "parent_launches": parent,
                       "worker_launches": worker_counts},
          "individuals": [{k: r[k] for k in ("pid", "values", "fitness",
                                             "seconds",
                                             "peak_allocated_bytes")}
                          for r in rows],
          "per_worker": {str(pid): w for pid, w in workers.items()}})
    if seq.evaluations != OPTIMIZE_EVALUATIONS \
            or par.evaluations != OPTIMIZE_EVALUATIONS:
        fail("optimize: %d and %d evaluations, expected %d"
             % (seq.evaluations, par.evaluations, OPTIMIZE_EVALUATIONS))
    expect_mnist_launches(counts, OPTIMIZE_EVALUATIONS * 2 * MNIST_TRAIN_STEPS,
                          "optimize (in process)")
    if len(rows) != OPTIMIZE_EVALUATIONS or len(workers) > OPTIMIZE_WORKERS:
        fail("optimize: %d individuals in %d worker processes, expected %d "
             "in at most %d" % (len(rows), len(workers),
                                OPTIMIZE_EVALUATIONS, OPTIMIZE_WORKERS))
    expect_mnist_launches(parent, 0, "optimize (parallel, parent)")
    expect_mnist_launches(worker_counts,
                          OPTIMIZE_EVALUATIONS * 2 * MNIST_TRAIN_STEPS,
                          "optimize (parallel, workers)")
    if (par.best_fitness, par.best_values, par.history) != \
            (seq.best_fitness, seq.best_values, seq.history):
        fail("optimize: the workers' search %s differs from the in-process "
             "one %s" % ((par.best_fitness, par.best_values, par.history),
                         (seq.best_fitness, seq.best_values, seq.history)))
    return counts, worker_counts


def mnist_defaults(max_epochs):
    """The MNIST sample's module with its ``root.mnist`` defaults run
    again (an earlier run's overrides and search values gone) and
    ``max_epochs``."""
    from veles_torch.__main__ import import_file
    from veles_torch.config import root
    module = import_file(MNIST_SAMPLE, "chip_smoke_mnist")
    root.mnist.decision.max_epochs = max_epochs
    return module


def check_shell_forge(torch, tmp):
    """Phase shell_forge: a card MNIST run stopped by its headless shell
    at the first epoch's end, its checkpoint and inference archive through
    the forge client, the fetched checkpoint resumed on the card; -> the
    two runs' launches."""
    from veles_torch import forge_client, model_health, prng
    from veles_torch.launcher import Launcher
    from veles_torch.snapshotter import load_snapshot

    def launch(wf, restore=None):
        with model_health.scoped():
            launcher = Launcher(device=SEARCH_DEVICE)
            launcher.initialize(wf)
            if restore is not None:
                wf.restore_state(restore)
            launcher.run()
        search_sync(torch)
        return read_counts()

    module = mnist_defaults(SHELL_MAX_EPOCHS)
    prng.seed_all(1337)
    wf = module.create_workflow(name="ShellForge")
    shell = wf.link_shell(commands=["stop()"])
    wf.link_snapshotter(directory=os.path.join(tmp, "snaps"))
    reset_counts()
    stopped = launch(wf)
    history = wf.decision.history
    if shell.activations != 1 or shell.results != [("stop()", None)] \
            or len(history) != 1 or wf.step.train_steps != MNIST_TRAIN_STEPS:
        fail("shell_forge: the shell ran %d time(s) (%s), the run kept %d "
             "epoch(s) and %d train steps; expected one stop after epoch 1"
             % (shell.activations, shell.results, len(history),
                wf.step.train_steps))
    expect_mnist_launches(stopped, MNIST_TRAIN_STEPS, "shell_forge (stop)")
    ckpt = wf.snapshotter.export_snapshot(slot="current")
    archive = os.path.join(tmp, "archive")
    wf.export_inference(archive)
    store = os.path.join(tmp, "forge")
    t0 = time.perf_counter()
    package = forge_client.upload("mnist_shell", [ckpt, ("archive", archive)],
                                  store=store, version="1",
                                  workflow=wf.name)
    dest = os.path.join(tmp, "fetched")
    meta = forge_client.fetch("mnist_shell", dest, store=store)
    forge_seconds = time.perf_counter() - t0
    fetched = os.path.join(dest, os.path.basename(ckpt))
    for a, b in ((ckpt, fetched),) + tuple(
            (os.path.join(archive, n), os.path.join(dest, "archive", n))
            for n in sorted(os.listdir(archive))):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                fail("shell_forge: %s fetched unlike %s" % (b, a))
    module = mnist_defaults(2)
    prng.seed_all(1337)
    resumed_wf = module.create_workflow(name="ShellForge")
    reset_counts()
    resumed = launch(resumed_wf, restore=load_snapshot(fetched))
    if len(resumed_wf.decision.history) != 2 \
            or resumed_wf.decision.history[0] != history[0]:
        fail("shell_forge: the resumed history %s does not continue %s"
             % (resumed_wf.decision.history, history))
    expect_mnist_launches(resumed, MNIST_TRAIN_STEPS, "shell_forge (resume)")
    emit({"phase": "shell_forge", "stopped_history": history,
          "stopped_launches": stopped, "package_bytes":
              os.path.getsize(package), "package_files": meta["files"],
          "forge_seconds": forge_seconds,
          "resumed_history": resumed_wf.decision.history,
          "resumed_launches": resumed})
    return {name: stopped[name] + resumed[name] for name in stopped}


def check_search_slice(torch):
    """Phases ensemble, optimize and shell_forge; -> launches by path."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_search_")
    try:
        ensemble = check_ensemble(torch)
        optimize, workers = check_optimize(torch, tmp)
        shell_forge = check_shell_forge(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"ensemble": ensemble, "optimize": optimize,
            "optimize_workers": workers, "shell_forge": shell_forge}


# -- the profiling plane: the step's cost ledger, /debug/profile, top -------

PROFILING_DEVICE = "cuda"
#: the watched run: the full-width MNIST sample, 3 epochs, its dashboard
#: on a free port
WATCHED_RUN = ("root.mnist.decision.max_epochs=3", "--seed", "1337",
               "--web-status", "0")
#: the capture fetched from the watched run's dashboard while it trains
PROFILE_SECONDS = 2.0
#: train minibatches of the 110M timed plainly and under the cost counter,
#: in turns (plain, counted, counted, plain) of this many each
COUNT_REPS = 3


def profiling_sync(torch):
    if PROFILING_DEVICE == "cuda":
        torch.cuda.synchronize()


def minibatch_ms(torch, wf, batch, counted):
    """Host ms of one train minibatch of ``wf`` to its sync, under a
    CostCounter when ``counted``."""
    from veles_torch import perf
    profiling_sync(torch)
    t0 = time.perf_counter()
    with perf.CostCounter() if counted else contextlib.nullcontext():
        wf.step.train_minibatch(*batch)
    profiling_sync(torch)
    return 1e3 * (time.perf_counter() - t0)


def costed_110m(torch):
    """The 110M LM as ``run_lm`` runs it (16 train steps) under a fresh
    registry: ``veles_step_flops_total{kind="train"}`` equal to the
    step's counted signature costs over its train steps, the flash
    kernels' share of each train step equal to FLASH_WORK's at
    FLASH_MAIN, ``veles_step_mfu_ratio{kind="train"}`` in (0, 1], and the
    device memory gauge's peak equal to ``max_memory_allocated``; then
    the counting's price, a train minibatch plainly and counted in turns.
    -> (launches, summary)."""
    from veles_torch import profiling, telemetry
    from veles_torch.config import root
    from veles_torch.fleet import metric_total, parse_prometheus
    from veles_torch.loader.base import CLASS_TRAIN
    cuda = PROFILING_DEVICE == "cuda"
    with telemetry.scoped() as registry:
        wf, counts, summary = run_lm(torch, "110M_costed", PROFILING_DEVICE,
                                     *LM_110M, valid_must_fall=False,
                                     phase="profiling")
        profiling.register_memory_gauges(registry)
        metrics = parse_prometheus(registry.render_prometheus())
    step = wf.step
    costs = {due: c for (cls, _, due), c in step.costs.items()
             if cls == CLASS_TRAIN}
    want = sum(costs[step.stats_due(t)].flops
               for t in range(step.train_steps))
    got = metric_total(metrics, "veles_step_flops_total", kind="train")
    if got is None or abs(got - want) > 1e-9 * want:
        fail("profiling: veles_step_flops_total{kind=\"train\"} %s, the "
             "step's costs over %d train steps %s"
             % (got, step.train_steps, want))
    b, h, s, dh = FLASH_MAIN
    layers = root.lm.model.layers
    flash_want = layers * (FLASH_WORK["fwd"][0] + FLASH_WORK["bwd"][0]) \
        * b * h * s * s * dh / 2 if cuda else 0
    flash = {due: c.kernel_flops.get("flash_fwd", 0.0)
             + c.kernel_flops.get("flash_bwd_fused", 0.0)
             for due, c in costs.items()}
    if any(f != flash_want for f in flash.values()):
        fail("profiling: flash work a train step %s, FLASH_WORK at %s: %s"
             % (flash, FLASH_MAIN, flash_want))
    mfu = metric_total(metrics, "veles_step_mfu_ratio", kind="train")
    if cuda and not (mfu is not None and 0 < mfu <= 1):
        fail("profiling: veles_step_mfu_ratio{kind=\"train\"} %s" % mfu)
    gauge_peak = metric_total(metrics, "veles_device_memory_bytes",
                              kind="peak_bytes_in_use")
    max_alloc = torch.cuda.max_memory_allocated() if cuda else None
    if gauge_peak != max_alloc:
        fail("profiling: device memory gauge peak %s, max_memory_allocated"
             " %s" % (gauge_peak, max_alloc))
    steps = step.train_steps
    batch = first_train_batch(torch, wf)
    minibatch_ms(torch, wf, batch, False)
    turns = {False: [], True: []}
    for counted in (False, True, True, False):
        turns[counted] += [minibatch_ms(torch, wf, batch, counted)
                           for _ in range(COUNT_REPS)]
    plain, counted = (sorted(turns[k])[len(turns[k]) // 2]
                      for k in (False, True))
    plain_cost = costs[False]
    summary = {
        "phase": "profiling", "run": "110M_costed", "card": card_line(),
        "train_steps": steps,
        "mfu_ratio": mfu,
        "flops_per_second": metric_total(
            metrics, "veles_step_flops_per_second", kind="train"),
        "tokens_per_second": metric_total(
            metrics, "veles_step_tokens_per_second", kind="train"),
        "train_step_flops": {str(due): c.flops for due, c in costs.items()},
        "train_step_bytes": plain_cost.bytes,
        "train_step_dot_share": plain_cost.dot_flops / plain_cost.flops,
        "precision": plain_cost.precision,
        "kernel_flops_per_train_step": plain_cost.kernel_flops,
        "flash_flops_per_train_step": flash_want,
        "flops_total_train": got,
        "counted_minibatch_ms": counted, "plain_minibatch_ms": plain,
        "counting_extra_ms": counted - plain, "turn_ms": turns,
        "device_memory_peak_gauge": gauge_peak,
        "max_memory_allocated": max_alloc,
        "device_memory_in_use_gauge": metric_total(
            metrics, "veles_device_memory_bytes", kind="bytes_in_use"),
        "launches": counts}
    emit(summary)
    return counts, summary


def fetch_while_training(url, seen):
    """The watched run's surfaces, fetched from a thread while it trains:
    ``top --once --json`` in a child process (started first: its imports
    take seconds), ``/debug/profile`` and ``/debug/critical_path``."""
    import subprocess
    import urllib.request
    top = subprocess.Popen(
        [sys.executable, "-m", "veles_torch", "top", url, "--once",
         "--json", "--timeout", "30"], cwd=HERE, env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for key, path in (("profile", "/debug/profile?seconds=%g"
                           % PROFILE_SECONDS),
                          ("critical_path", "/debug/critical_path")):
            with urllib.request.urlopen(url + path, timeout=60) as resp:
                seen[key] = (resp.status, json.load(resp))
        out, err = top.communicate(timeout=120)
        seen["top"] = (top.returncode, out, err)
    except Exception as exc:
        seen["error"] = "%s: %s" % (type(exc).__name__, exc)
    finally:
        if top.poll() is None:
            top.kill()
            top.wait()


def watched_mnist(torch):
    """The full-width MNIST sample through the CLI with ``--web-status 0``,
    3 epochs, its surfaces fetched while it trains (the run waits for the
    fetches before it closes its dashboard): a speedscope capture naming
    the main thread and the reactor, ``/debug/critical_path`` 200, and
    ``top --once --json`` reading the target ready with its RSS and device
    memory; 180 launches of each bias-gradient form. -> (launches,
    summary)."""
    import threading
    from veles_torch import health, launcher, telemetry
    seen = {}
    run = launcher.Launcher.run

    def watched_run(self):
        url = "http://127.0.0.1:%d" % self.web_status.port
        health.get_monitor().tick()      # the memory gauges, /readyz
        fetcher = threading.Thread(target=fetch_while_training,
                                   args=(url, seen), daemon=True,
                                   name="profiling-fetch")
        fetcher.start()
        train = self._train

        def train_then_wait():
            train()
            fetcher.join(timeout=240)

        self._train = train_then_wait
        return run(self)

    launcher.Launcher.run = watched_run
    try:
        with telemetry.scoped(), health.scoped(health.HealthMonitor()):
            reset_counts()
            wf = cli_run([MNIST_SAMPLE, "-d", PROFILING_DEVICE,
                          *WATCHED_RUN])
            profiling_sync(torch)
            counts = read_counts()
    finally:
        launcher.Launcher.run = run
    if "error" in seen or set(seen) != {"profile", "critical_path", "top"}:
        fail("profiling: the watched run's fetches: %s"
             % seen.get("error", sorted(seen)))
    cuda = PROFILING_DEVICE == "cuda"
    steps = wf.step.train_steps
    want = dict.fromkeys(counts, 0)
    if cuda:
        want.update({"bias_grad[identity]": steps,
                     "bias_grad[masked]": steps})
    if steps != MNIST_TRAIN_STEPS * 3 or counts != want:
        fail("profiling: the watched MNIST run's launches %s in %d train "
             "steps, expected %s" % (counts, steps, want))
    code, doc = seen["profile"]
    names = [p["name"] for p in doc.get("profiles", ())]
    if code != 200 or not doc.get("$schema", "").startswith(
            "https://www.speedscope.app/") \
            or not {"MainThread", "reactor"} <= set(names):
        fail("profiling: /debug/profile answered %s with threads %s"
             % (code, names))
    if seen["critical_path"][0] != 200:
        fail("profiling: /debug/critical_path answered %s"
             % seen["critical_path"][0])
    rc, out, err = seen["top"]
    try:
        snap = json.loads(out)
        row = snap["targets"][0]
    except (ValueError, KeyError, IndexError):
        fail("profiling: top exited %s: %s %s" % (rc, out[-500:],
                                                 err[-2000:]))
    metrics = row.get("metrics", {})
    if rc != 0 or not row.get("ready") \
            or not metrics.get("host_rss_bytes", 0) > 0 \
            or (cuda and not metrics.get("device_memory_bytes", 0) > 0):
        fail("profiling: top exited %s, row %s" % (rc, row))
    summary = {"phase": "profiling", "run": "mnist_watched",
               "train_steps": steps, "launches": counts,
               "profile_threads": names, "profile_meta": doc.get("veles"),
               "critical_path_traces": seen["critical_path"][1].get(
                   "traces"),
               "top_ready": row.get("ready"), "top_metrics": metrics}
    emit(summary)
    return counts, summary


def check_profiling(torch):
    """Phase profiling: the costed 110M run and the watched MNIST run; ->
    the launches of the two runs together."""
    lm, _ = costed_110m(torch)
    mnist, _ = watched_mnist(torch)
    return add_counts(lm, mnist)


# -- the streaming image loader and continual training ----------------------

STREAM_DEVICE = "cuda"
#: the PNG tree of phase image_stream: CLASSES class directories of PER_CLASS
#: images, every other one TREE_OTHER_SIZE (resized to 256×256 on decode),
#: the rest 256×256; the stride split holds 8 of 72 out a class: 1024 train
#: and 128 validation images, AlexNet's minibatch 128 at its 227 crop
TREE_CLASSES = 16
TREE_PER_CLASS = 72
TREE_SIZE = (256, 256)
TREE_OTHER_SIZE = (320, 288)
IMAGE_STREAM_RUN = ("root.imagenet.decision.max_epochs=2", "--seed", "1337")
#: images decoded one by one, per tree kind, for the decode rate
DECODE_TIMED = 64
#: the stream path against the resident bank on the card: one f32 AlexNet
#: epoch each from the same uint8 images (STREAM_PARITY_IMAGES: valid,
#: train) and weights, with cuDNN held to its deterministic algorithms
#: (with its free choice the two runs read 1.13e-3 of a tensor's largest
#: element apart on an H100, with equal losses: reductions in another
#: order); every parameter and velocity within STREAM_PARITY_RTOL of its
#: largest element of the resident run's, and a second resident run
#: beside them
STREAM_PARITY_IMAGES = (128, 256)
STREAM_PARITY_CROP = (227, 227)
STREAM_PARITY_MB = 128
STREAM_PARITY_RTOL = 1e-6
#: phase continual: the full-width MNIST (784-100-10, minibatch 100) over a
#: ContinualStreamLoader fed over HTTP: rounds of CONTINUAL_ROUND_SAMPLES
#: after a pinned validation head of CONTINUAL_VALID
CONTINUAL_ROUNDS = 3
CONTINUAL_ROUND_SAMPLES = 6000
CONTINUAL_VALID = 1000


def stream_sync(torch):
    if STREAM_DEVICE == "cuda":
        torch.cuda.synchronize()


def write_png_paeth(path, rgb):
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG with the Paeth filter
    on every row: the slowest rows for the port's decoder (libpng and
    Pillow pick filters per row; this is their worst case)."""
    import struct
    import zlib
    import numpy
    from veles_torch.graphics_client import _chunk
    x = numpy.ascontiguousarray(rgb, numpy.uint8).astype(numpy.int16)
    h, w, _ = x.shape
    a = numpy.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = numpy.zeros_like(x)
    b[1:] = x[:-1]
    c = numpy.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    pred = numpy.where((pa <= pb) & (pa <= pc), a,
                       numpy.where(pb <= pc, b, c))
    raw = numpy.empty((h, 1 + 3 * w), numpy.uint8)
    raw[:, 0] = 4
    raw[:, 1:] = ((x - pred) % 256).reshape(h, 3 * w)
    png = b"\x89PNG\r\n\x1a\n" \
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) \
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) \
        + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


def write_image_tree(base):
    """Phase image_stream's tree: a low-frequency prototype per class plus
    per-image noise, written with the port's ``write_png`` (filter 0) by 8
    threads (zlib runs outside the interpreter lock); -> the paths
    written."""
    import concurrent.futures
    import numpy
    from veles_torch.graphics_client import write_png
    gen = numpy.random.Generator(numpy.random.PCG64(0x1AA6E))
    protos = gen.uniform(0, 255, (TREE_CLASSES, 8, 8, 3))
    jobs = []
    for k in range(TREE_CLASSES):
        d = os.path.join(base, "c%02d" % k)
        os.makedirs(d)
        for j in range(TREE_PER_CLASS):
            h, w = TREE_SIZE if j % 2 == 0 else TREE_OTHER_SIZE
            proto = numpy.kron(protos[k], numpy.ones(
                ((h + 7) // 8, (w + 7) // 8, 1)))[:h, :w]
            noise = gen.integers(-40, 40, ((h + 3) // 4, (w + 3) // 4, 3))
            noise = numpy.kron(noise, numpy.ones((4, 4, 1)))[:h, :w]
            img = numpy.clip(proto + noise, 0, 255).astype(numpy.uint8)
            jobs.append((os.path.join(d, "i%03d.png" % j), img))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for future in [pool.submit(write_png, *job) for job in jobs]:
            future.result()
    return [path for path, _ in jobs]


def decode_ms(paths):
    """Host ms to decode, convert and resize one image of ``paths`` (one
    thread)."""
    from veles_torch.loader import codecs
    t0 = time.perf_counter()
    for path in paths:
        codecs.load(path, "RGB", TREE_SIZE)
    return 1e3 * (time.perf_counter() - t0) / len(paths)


def decode_rates(paths, tmp):
    """The decode rate of the filter-0 tree and of a Paeth copy of its
    first DECODE_TIMED images."""
    from veles_torch.loader import codecs
    paeth = []
    for i, path in enumerate(paths[:DECODE_TIMED]):
        out = os.path.join(tmp, "paeth_%03d.png" % i)
        write_png_paeth(out, codecs.read_png(path))
        paeth.append(out)
    return {"filter0_ms_per_image": decode_ms(paths[:DECODE_TIMED]),
            "paeth_ms_per_image": decode_ms(paeth)}


def uploads_in_flight(torch):
    """Three windows uploaded back to back with no synchronization (the
    third reuses the first's pinned buffer): each device window holds its
    own host window's bytes. -> the check's row."""
    import numpy
    from veles_torch.znicz.step import WindowUploader
    gen = numpy.random.Generator(numpy.random.PCG64(3))
    wins = [{"data": gen.integers(0, 256, (2, 128, 227, 227, 3),
                                  dtype=numpy.uint8),
             "labels": gen.integers(0, 16, (2, 128), dtype=numpy.int32)}
            for _ in range(3)]
    up = WindowUploader(STREAM_DEVICE)
    t0 = time.perf_counter()
    outs = [up.upload(w) for w in wins]
    stream_sync(torch)
    seconds = time.perf_counter() - t0
    equal = [bool(numpy.array_equal(o["data"].cpu().numpy(), w["data"]))
             and bool(numpy.array_equal(o["labels"].cpu().numpy(),
                                        w["labels"]))
             for o, w in zip(outs, wins)]
    return {"windows_equal": equal, "bytes": up.bytes,
            "gb_per_s": up.bytes / seconds / 1e9}


def stream_vs_resident(torch):
    """One f32 AlexNet epoch at full geometry from the same uint8 images
    and weights through an ArrayStreamLoader and a FullBatchLoader (the
    resident bank's path); -> the comparison's row."""
    import numpy
    from veles_torch import prng
    from veles_torch.loader.fullbatch import FullBatchLoader
    from veles_torch.loader.stream import ArrayStreamLoader
    from veles_torch.znicz.models import imagenet
    from veles_torch.znicz.standard_workflow import StandardWorkflow

    def normalized(data, train):
        return (data.to(torch.float32) / 255.0 - 0.5) / 0.5

    class Streamed(ArrayStreamLoader):
        batch_transform = staticmethod(normalized)

    class Resident(FullBatchLoader):
        batch_transform = staticmethod(normalized)

    n_valid, n_train = STREAM_PARITY_IMAGES
    gen = numpy.random.Generator(numpy.random.PCG64(4242))
    images = gen.integers(0, 256, (n_valid + n_train,) + STREAM_PARITY_CROP
                          + (3,), dtype=numpy.uint8)
    labels = (numpy.arange(n_valid + n_train) % TREE_CLASSES).astype(
        numpy.int32)
    lengths = [0, n_valid, n_train]

    def streamed(wf):
        return Streamed(wf, name="loader", minibatch_size=STREAM_PARITY_MB,
                        data=images, labels=labels, class_lengths=lengths)

    def resident(wf):
        ld = Resident(wf, name="loader", minibatch_size=STREAM_PARITY_MB)
        ld.original_data, ld.original_labels = images, labels
        ld.class_lengths = list(lengths)
        ld.serve_dtype = numpy.uint8
        return ld

    layers = imagenet.alexnet_layers(TREE_CLASSES)
    for layer in layers:
        if layer["type"] == "dropout":
            layer["->"]["dropout_ratio"] = 0.0
    trees, losses = {}, {}
    restore = f32_policy()
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for kind, factory in (("resident", resident), ("stream", streamed),
                              ("resident_again", resident)):
            prng.seed_all(1337)
            wf = StandardWorkflow(name="AlexNet_" + kind, layers=layers,
                                  loader_factory=factory,
                                  decision_config={"max_epochs": 1})
            wf.initialize(device=STREAM_DEVICE)
            wf.run()
            stream_sync(torch)
            wf.close()
            trees[kind] = {u: {k: t.detach().double().cpu()
                               for k, t in sub.items()}
                           for u, sub in wf.export_tree().items()}
            losses[kind] = wf.decision.history[-1]["train"]["loss"]
            if wf.loader.supports_streaming != (kind == "stream"):
                fail("image_stream: the parity's %s run took the wrong "
                     "path" % kind)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        restore()
    worst = rel_errors(trees["stream"], trees["resident"])
    spread = rel_errors(trees["resident_again"], trees["resident"])
    bitwise = all(torch.equal(trees["stream"][u][k], trees["resident"][u][k])
                  for u in trees["stream"] for k in trees["stream"][u])
    return {"images": [n_valid, n_train], "rtol": STREAM_PARITY_RTOL,
            "bitwise": bitwise, "max_rel_err": max(worst.values()),
            "worst_tensors": sorted(worst.items(), key=lambda kv: -kv[1])[:3],
            "resident_vs_resident": max(spread.values()),
            "train_loss": losses}


def check_image_stream(torch):
    """Phase image_stream: AlexNet at full width through the CLI from a
    PNG tree on disk, in stream mode; -> its launch counts."""
    import shutil
    import tempfile
    from veles_torch.config import root
    tmp = tempfile.mkdtemp(prefix="image_tree_", dir=OUT_DIR)
    saved = root.imagenet.loader.to_dict()
    try:
        t0 = time.perf_counter()
        paths = write_image_tree(os.path.join(tmp, "tree"))
        write_seconds = time.perf_counter() - t0
        rates = decode_rates(paths, tmp)
        reset_counts()
        wf = cli_run([IMAGENET_SAMPLE, "root.imagenet.loader.base_dir=%s"
                      % os.path.join(tmp, "tree"), *IMAGE_STREAM_RUN,
                      "-d", STREAM_DEVICE])
        stream_sync(torch)
        counts = read_counts()
    finally:
        root.imagenet.loader.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    loader, step = wf.loader, wf.step
    train = step.train_steps
    losses = [h["train"]["loss"] for h in wf.decision.history]
    images = sum(loader.class_lengths)
    warm = step.epoch_seconds[1]
    waits = {kind: w for kind, w in step.stream_wait_seconds.items()}
    ok, want = conv_launches_ok(counts, train, 7)
    in_flight = uploads_in_flight(torch)
    parity = stream_vs_resident(torch)
    emit({"phase": "image_stream", "images": images,
          "class_lengths": loader.class_lengths,
          "n_classes": loader.n_classes, "train_steps": train,
          "eval_steps": step.eval_steps, "launches": counts,
          "train_loss": losses,
          "validation_error": [h["validation"]["metric"]
                               for h in wf.decision.history],
          "epoch_seconds": step.epoch_seconds,
          "images_per_sec_warm_epoch": images / warm,
          "stream_wait_seconds": waits,
          "stream_wait_share_warm_epoch": sum(
              w[1] for w in waits.values()) / warm,
          "window_minibatches": step.last_window_minibatches,
          "uploaded_bytes": step.uploader.bytes,
          "uploads": step.uploader.uploads,
          "tree_write_seconds": write_seconds, "decode": rates,
          "uploads_in_flight": in_flight, "stream_vs_resident": parity})
    if not loader.supports_streaming \
            or type(loader).__name__ != "AutoLabelFileImageLoader":
        fail("image_stream: the run used %s, not the streaming file "
             "loader" % type(loader).__name__)
    if loader.class_lengths != [0, 128, 1024] \
            or loader.n_classes != TREE_CLASSES:
        fail("image_stream: split %s over %s classes"
             % (loader.class_lengths, loader.n_classes))
    if not ok:
        fail("image_stream: launches %s, expected %s" % (counts, want))
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 1.5 * losses[0]:
        fail("image_stream: train losses %s" % (losses,))
    if not all(in_flight["windows_equal"]):
        fail("image_stream: windows in flight hold %s"
             % in_flight["windows_equal"])
    if not parity["max_rel_err"] <= STREAM_PARITY_RTOL:
        fail("image_stream: stream vs resident %.3g of the largest element"
             % parity["max_rel_err"])
    return counts


def check_continual(torch):
    """Phase continual: ``--continual 3`` of the full-width MNIST (the
    launcher's continual branch) over a ContinualStreamLoader fed by
    HttpStreamSource from the port's stream_handler in this process, the
    checkpoints stamped with ``ingest_wall``, then a serving registry on
    the newest one publishing its staleness; -> the run's launch
    counts."""
    import shutil
    import tempfile
    import numpy
    from veles_torch import continual, model_health, prng, snapshotter
    from veles_torch import telemetry
    from veles_torch.config import root
    from veles_torch.launcher import Launcher
    from veles_torch.loader.stream import ArraySource, ContinualStreamLoader
    from veles_torch.reactor import HttpServer
    from veles_torch.serving.registry import ModelRegistry
    from veles_torch.znicz.models import datasets, mnist  # noqa: F401
    from veles_torch.znicz.standard_workflow import StandardWorkflow
    prng.seed_all(1337)
    tx, ty, vx, vy = datasets.load_mnist(n_train=CONTINUAL_ROUND_SAMPLES,
                                         n_valid=CONTINUAL_VALID)
    data = numpy.concatenate([vx, tx]).reshape(-1, 784).astype(
        numpy.float32)
    server = HttpServer("127.0.0.1", 0, continual.stream_handler(
        ArraySource(data, numpy.concatenate([vy, ty]))), name="ingest")
    url = "http://127.0.0.1:%d" % server.port
    tmp = tempfile.mkdtemp(prefix="chip_smoke_continual_")
    store = os.path.join(tmp, "store")
    reg = None
    try:
        wf = StandardWorkflow(
            name="mnist", layers=root.mnist.layers,
            loader_factory=lambda w: ContinualStreamLoader(
                w, name="loader", minibatch_size=100,
                source=continual.HttpStreamSource(url),
                round_samples=CONTINUAL_ROUND_SAMPLES,
                valid_samples=CONTINUAL_VALID),
            decision_config={"max_epochs": 1, "fail_iterations": 50},
            snapshotter_config={"directory": store})
        reset_counts()
        t0 = time.perf_counter()
        with model_health.scoped():
            launcher = Launcher(device=STREAM_DEVICE,
                                continual=CONTINUAL_ROUNDS, stats=False)
            launcher.initialize(wf)
            launcher.run()
            stream_sync(torch)
            seconds = time.perf_counter() - t0
            counts = read_counts()
            trainer = telemetry.get_registry().gauge(
                continual.STALENESS_FAMILY, labels=("point",)).labels(
                    "trainer").value
            wf.snapshotter.export_snapshot(slot="current")
        rounds = [e for e in telemetry.tracer.recent_events()
                  if e["event"] == "continual_round"
                  and e.get("workflow") == "mnist"][-CONTINUAL_ROUNDS:]
        infos = [i for i in snapshotter.scan_checkpoints(store)
                 if i.status == "valid"]
        archive = os.path.dirname(wf.export_inference(
            os.path.join(tmp, "archive")))
        reg = ModelRegistry(device=STREAM_DEVICE)
        reg.load("mnist", archive, refresh_store=store)
        loaded = reg.refresh_newest("mnist")
        served_wall = reg.get("mnist").model.checkpoint_meta.get(
            "ingest_wall")
        serving = telemetry.get_registry().gauge(
            continual.STALENESS_FAMILY, labels=("point",)).labels(
                "serving:mnist").value
        expected_serving = time.time() - (served_wall or 0.0)
    finally:
        if reg is not None:
            reg.close()
        server.close()
        continual.register_ingest_clock(None)
        shutil.rmtree(tmp, ignore_errors=True)
    train = wf.step.train_steps
    emit({"phase": "continual", "rounds": len(rounds),
          "seconds": seconds, "train_steps": train, "launches": counts,
          "cursor_base": wf.loader.cursor_base,
          "staleness_after_round": [
              e["wall"] - e["ingest_wall"] if e.get("ingest_wall") else None
              for e in rounds],
          "trainer_staleness": trainer,
          "checkpoints": [[i.name, i.ingest_wall] for i in infos],
          "served": loaded, "served_ingest_wall": served_wall,
          "serving_staleness": serving,
          "validation_error": [h["validation"]["metric"]
                               for h in wf.decision.history]})
    per_round = CONTINUAL_ROUND_SAMPLES // 100
    if len(rounds) != CONTINUAL_ROUNDS \
            or len(wf.decision.history) != CONTINUAL_ROUNDS \
            or train != CONTINUAL_ROUNDS * per_round:
        fail("continual: %d rounds, %d epochs, %d train steps"
             % (len(rounds), len(wf.decision.history), train))
    if wf.loader.cursor_base != CONTINUAL_VALID \
            + CONTINUAL_ROUNDS * CONTINUAL_ROUND_SAMPLES:
        fail("continual: cursor at %d" % wf.loader.cursor_base)
    per_step = train if STREAM_DEVICE == "cuda" else 0
    want = dict({name: 0 for name in counts},
                **{"bias_grad[identity]": per_step,
                   "bias_grad[masked]": per_step})
    if counts != want:
        fail("continual: launches %s, expected %s" % (counts, want))
    if not infos or any(i.ingest_wall is None for i in infos):
        fail("continual: checkpoints without ingest_wall: %s"
             % [(i.name, i.ingest_wall) for i in infos])
    if loaded is None or not served_wall \
            or not abs(serving - expected_serving) < 5.0 or serving <= 0:
        fail("continual: serving staleness %r for ingest wall %r (%s)"
             % (serving, served_wall, loaded))
    if not 0.0 <= trainer < 60.0:
        fail("continual: trainer staleness %r" % trainer)
    return counts



# -- the master/slave wire: MNIST and the 110M LM over it, the GA over slaves

DIST_DEVICE = "cuda"
#: the full-width MNIST sample (root.mnist: 784 -> 100 -> 10, minibatch
#: 100, 6000/1000 samples): jobs an epoch, train and valid minibatches
DIST_SEED = ("--seed", "1337")
DIST_TRAIN_JOBS, DIST_VALID_JOBS = 60, 10
DIST_EPOCHS = 2
#: the kill run: more epochs, so the SIGKILL lands mid-run, once the
#: master has merged this many jobs
DIST_KILL_EPOCHS = 8
DIST_KILL_AFTER_JOBS = 40
DIST_SLAVE_TIMEOUT = 10.0
#: one unshuffled slave against the standalone card run over the same
#: order, as a share of the largest weight (the master adds each delta
#: w_new - w_basis to w_basis: one rounding a train job)
DIST_SEQ_RTOL = 1e-5
#: the master's received bytes a job under int8 against none's (the
#: reference's acceptance share)
DIST_INT8_SHARE = 0.3
#: codecs whose wire bytes a job the in-process runs read (none and int8
#: come from the processes' runs)
DIST_INPROC_CODECS = ("bf16", "topk")
#: the 110M LM's widths at 2 layers: 3 train and 1 valid minibatch of 8
#: sequences of 512 tokens, one epoch: 4 jobs
DIST_LM = LM_110M + ("root.lm.model.layers=2", "root.lm.loader.n_train=24",
                     "root.lm.loader.n_valid=8",
                     "root.lm.decision.max_epochs=1",
                     "root.lm.model.attn_impl=pallas")
DIST_LM_JOBS = 4
#: seconds any process of the phase may take
DIST_BOUND = 240


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_cli(*args):
    """``python -m veles_torch`` on the MNIST sample in a child process on
    DIST_DEVICE; -> the process."""
    return subprocess.Popen(
        [sys.executable, "-m", "veles_torch", MNIST_SAMPLE, "-d",
         DIST_DEVICE, "--no-stats", *DIST_SEED, *args], cwd=HERE,
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def dist_finish(procs, where, allow_killed=()):
    """Wait for every process within DIST_BOUND; a nonzero exit (but for
    the ``allow_killed`` ones) fails the phase; kills what is left."""
    try:
        for p in procs:
            _, err = p.communicate(timeout=DIST_BOUND)
            if p.returncode and p not in allow_killed:
                fail("distributed %s: a process exited %s:\n%s"
                     % (where, p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def job_timing(trace_path):
    """Per merged job, from the master's trace: the wire seconds
    (``job.wire``), the slave's own seconds (its absorbed ``slave.*``
    spans) and their sum, the round trip; -> a dict of lists."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    wire, own, compute = {}, {}, {}
    for e in events:
        args = e.get("args") or {}
        key = (args.get("slave"), args.get("job_id"))
        if e.get("ph") != "X" or key[1] is None:
            continue
        if e["name"] == "job.wire":
            wire[key] = e["dur"] / 1e6
        elif e["name"].startswith("slave."):
            own[key] = own.get(key, 0.0) + e["dur"] / 1e6
            if e["name"] == "slave.compute":
                compute[key] = e["dur"] / 1e6
    keys = sorted(k for k in wire if k in own)
    return {"wire_s": [wire[k] for k in keys],
            "compute_s": [compute.get(k, 0.0) for k in keys],
            "rtt_s": [wire[k] + own[k] for k in keys]}


def median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def dist_cluster(tmp, tag, codec, epochs, kill_after=None):
    """A master and two slaves of the MNIST sample as processes, the
    master with its snapshot store (its final tree), its trace and its
    dashboard; with ``kill_after``, one slave is SIGKILLed once the
    master has merged that many jobs. -> (the master's result, the
    slaves' results, the timing of the master's trace, the master's
    final tree, the seconds the run took)."""
    from veles_torch.snapshotter import load_snapshot
    import signal
    import urllib.request
    addr = "127.0.0.1:%d" % free_port()
    web = free_port()
    out = {name: os.path.join(tmp, "%s_%s.json" % (tag, name))
           for name in ("master", "slave0", "slave1", "trace")}
    snaps = os.path.join(tmp, "%s_snapshots" % tag)
    t0 = time.perf_counter()
    master = dist_cli("--listen-address", addr, "--grad-codec", codec,
                      "--slave-timeout", str(DIST_SLAVE_TIMEOUT),
                      "--snapshots", snaps, "--trace-out", out["trace"],
                      "--web-status", str(web), "--result-file",
                      out["master"],
                      "root.mnist.decision.max_epochs=%d" % epochs)
    slaves = [dist_cli("--master-address", addr, "--grad-codec", codec,
                       "--slave-retries", "40", "--result-file",
                       out["slave%d" % i]) for i in range(2)]
    killed = ()
    drop_seconds = None

    def cluster_status():
        try:
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d/status.json" % web,
                    timeout=5) as resp:
                return json.load(resp).get("cluster", {})
        except OSError:
            return {}

    try:
        if kill_after is not None:
            deadline = time.monotonic() + DIST_BOUND
            victim = slaves[0]
            while True:
                if time.monotonic() > deadline or master.poll() is not None:
                    fail("distributed %s: no slave was caught holding a "
                         "job after %d jobs" % (tag, kill_after))
                rows = cluster_status().get("slaves") or {}
                if len(rows) < 2 or sum(r["jobs"] for r in rows.values()) \
                        < kill_after:
                    time.sleep(0.01)
                    continue
                # freeze the victim, let the frames in transit land, and
                # kill it only while the master holds a job of it out
                os.kill(victim.pid, signal.SIGSTOP)
                time.sleep(0.1)
                rows = cluster_status().get("slaves") or {}
                if len(rows) == 2 and all(r["outstanding"]
                                          for r in rows.values()):
                    break
                os.kill(victim.pid, signal.SIGCONT)
                time.sleep(0.05)
            t_kill = time.monotonic()
            os.kill(victim.pid, signal.SIGKILL)
            killed = (victim,)
            while time.monotonic() < t_kill + DIST_SLAVE_TIMEOUT + 5:
                if cluster_status().get("faults", {}).get("drops", 0):
                    drop_seconds = time.monotonic() - t_kill
                    break
                time.sleep(0.01)
            if drop_seconds is None or drop_seconds > DIST_SLAVE_TIMEOUT:
                fail("distributed %s: the killed slave was dropped after "
                     "%s s (slave timeout %s s)"
                     % (tag, drop_seconds, DIST_SLAVE_TIMEOUT))
        dist_finish([master] + slaves, tag, allow_killed=killed)
    finally:
        for p in [master] + slaves:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    with open(out["master"]) as f:
        mres = json.load(f)
    sres = []
    for i in range(2):
        if slaves[i] in killed:
            continue
        with open(out["slave%d" % i]) as f:
            sres.append(json.load(f))
    trees = sorted(n for n in os.listdir(snaps) if "_master-" in n)
    if not trees:
        fail("distributed %s: the master persisted no tree" % tag)
    tree = load_snapshot(os.path.join(snaps, trees[-1]))
    mres["drop_seconds"] = drop_seconds
    return mres, sres, job_timing(out["trace"]), tree, seconds


def dist_counts(results):
    """The kernels' launches summed over slave result lines, in
    read_counts' keys."""
    counts = dict.fromkeys(read_counts(), 0)
    for r in results:
        launches = r["launches"]
        counts["flash_fwd"] += launches["flash_fwd"]["fwd"]
        counts["flash_fwd_pipe"] += launches["flash_fwd"]["fwd_pipe"]
        counts["flash_bwd_fused"] += launches["flash_bwd"]["fused"]
        counts["flash_bwd_dq"] += launches["flash_bwd"]["dq"]
        counts["flash_bwd_dkv"] += launches["flash_bwd"]["dkv"]
        for form in ("identity", "masked"):
            counts["bias_grad[%s]" % form] += launches["bias_grad"][form]
    return counts


def tree_weights(tree):
    """{unit/param: ndarray} of a master tree's forward parameters."""
    return {"%s/%s" % (u, k): v
            for u, sub in tree["workflow"]["params"].items()
            for k, v in sub.items()}


#: the sample's own sizes, set again in this process (earlier phases
#: override root.mnist here)
DIST_MNIST_SIZES = ("root.mnist.loader.minibatch_size=100",
                    "root.mnist.loader.n_train=6000",
                    "root.mnist.loader.n_valid=1000")


def dist_mnist_workflow(shuffle):
    """The MNIST sample's workflow at its own sizes (seed 1337), its
    loader's shuffle as given, not initialized."""
    from veles_torch import prng
    from veles_torch.config import root
    from veles_torch.znicz.models import mnist
    for override in DIST_MNIST_SIZES:
        root.apply_override(override)
    prng.seed_all(1337)
    wf = mnist.create_workflow()
    wf.loader.shuffle_enabled = shuffle
    return wf


class WireMeter:
    """Wraps a MasterServer's ``handle``: the bytes of each received
    update frame (its payload as the wire carries it, plus the frame
    overhead), and the first train update's unit payload keys."""

    def __init__(self, server):
        from veles_torch import server as wire
        self.wire = wire
        self.update_bytes = []
        self.job_keys = None
        self.update_keys = None
        self._handle = server.handle
        server.handle = self

    def __call__(self, request):
        if request[0] == "update" and len(request) > 5:
            self.update_bytes.append(
                sum(len(p) for p in self.wire._frame_parts(request))
                + self.wire._FRAME_OVERHEAD)
            data = request[5]
            if self.update_keys is None and isinstance(data, dict) and any(
                    isinstance(v, dict) and v for v in data.values()):
                self.update_keys = {u: sorted(v) for u, v in data.items()
                                    if isinstance(v, dict) and v
                                    and u != "__telemetry__"}
        resp = self._handle(request)
        if resp[0] == "job" and self.job_keys is None:
            self.job_keys = {u: sorted(v) for u, v in resp[1].items()
                             if isinstance(v, dict)}
        return resp


def dist_inprocess(torch, workflow, codec, epochs, **server_kwargs):
    """A port master (host weights, no step) in this process's threads
    and one slave on DIST_DEVICE through the launcher; -> (the master's
    workflow, the slave's workflow, the master, its WireMeter, the
    slave's launches)."""
    from veles_torch import model_health
    from veles_torch.launcher import Launcher
    from veles_torch.server import MasterServer
    master_wf = workflow()
    master_wf.initialize(device="cpu", with_step=False)
    server = MasterServer(master_wf, "127.0.0.1:0", max_epochs=epochs,
                          grad_codec=codec, drain_timeout=0.1,
                          **server_kwargs)
    meter = WireMeter(server)
    thread = server.start_background()
    try:
        slave_wf = workflow()
        reset_counts()
        with model_health.scoped():
            launcher = Launcher(
                device=DIST_DEVICE, stats=False, grad_codec=codec,
                master_address="127.0.0.1:%d" % server.bound_address[1])
            launcher.initialize(slave_wf)
            launcher.run()
        if DIST_DEVICE == "cuda":
            torch.cuda.synchronize()
        counts = read_counts()
    except BaseException:
        # a failed slave run must not leave the master serving
        server.request_stop()
        raise
    finally:
        server.done.set()
        thread.join(timeout=DIST_BOUND)
    if not server.done.is_set() or server.epoch != epochs:
        fail("distributed in process (%s): the master ended at epoch %d"
             % (codec, server.epoch))
    return master_wf, slave_wf, server, meter, counts


def expect_dist_launches(counts, train_jobs, where):
    per = train_jobs if DIST_DEVICE == "cuda" else 0
    want = dict(dict.fromkeys(counts, 0), **{"bias_grad[identity]": per,
                                             "bias_grad[masked]": per})
    if counts != want:
        fail("distributed %s: launches %s, expected %s"
             % (where, counts, want))


def check_dist_mnist(torch, tmp):
    """Phase distributed (a); -> (launches, the summary)."""
    import numpy
    from veles_torch import kernels, model_health
    jobs = DIST_EPOCHS * (DIST_TRAIN_JOBS + DIST_VALID_JOBS)
    train_jobs = DIST_EPOCHS * DIST_TRAIN_JOBS
    if DIST_DEVICE == "cuda":
        # the two slaves build the bias-gradient library at once, each
        # into a file of its own renamed into place: both must load a
        # whole library
        os.unlink(kernels.library_path("bias_grad"))
    runs = {}
    for codec in ("none", "int8"):
        mres, sres, timing, tree, seconds = dist_cluster(
            tmp, codec, codec, DIST_EPOCHS)
        cluster = mres["cluster"]
        served = sum(r["slave"]["jobs"] for r in sres)
        if not cluster["complete"] or cluster["epoch"] != DIST_EPOCHS \
                or served != jobs or cluster["faults"]["drops"] \
                or cluster["faults"]["fenced_updates"] \
                or cluster["faults"]["codec_fallbacks"] \
                or cluster["grad_codec"] != codec:
            fail("distributed (%s): served %d of %d jobs: %s"
                 % (codec, served, jobs, cluster))
        if mres["cuda_initialized"]:
            fail("distributed (%s): the master initialized CUDA" % codec)
        counts = dist_counts(sres)
        expect_dist_launches(counts, train_jobs, "slaves (%s)" % codec)
        for r in sres:
            if r["slave"]["codec"] != codec:
                fail("distributed: a slave synced %r, not %r"
                     % (r["slave"]["codec"], codec))
        runs[codec] = {"master": mres, "slaves": sres, "timing": timing,
                       "tree": tree, "seconds": seconds, "counts": counts}
    # the weights moved from the initial ones and stayed finite
    init = dist_mnist_workflow(True)
    init.initialize(device="cpu", with_step=False)
    w0 = {"%s/%s" % (f.name, k): t.numpy()
          for f in init.forwards for k, t in f.export_params().items()}
    for codec, run in runs.items():
        w = tree_weights(run["tree"])
        if not all(numpy.isfinite(v).all() for v in w.values()):
            fail("distributed (%s): non-finite master weights" % codec)
        moved = max(float(numpy.abs(w[k] - w0[k]).max()) for k in w0)
        if not moved > 1e-3:
            fail("distributed (%s): the master's weights moved %g"
                 % (codec, moved))
        run["moved"] = moved
    per_job = {codec: run["master"]["wire_bytes"]["rx"] / jobs
               for codec, run in runs.items()}
    if not per_job["int8"] <= DIST_INT8_SHARE * per_job["none"]:
        fail("distributed: int8 received %.0f bytes a job, none %.0f"
             % (per_job["int8"], per_job["none"]))
    # one unshuffled slave against the standalone card run
    ref = dist_mnist_workflow(False)
    ref.initialize(device=DIST_DEVICE)
    with model_health.scoped():
        ref.decision.max_epochs = DIST_EPOCHS
        ref.run()
    if ref.decision.epoch_number != DIST_EPOCHS:
        fail("distributed: the standalone run ended at epoch %d"
             % ref.decision.epoch_number)
    master_wf, slave_wf, server, meter, seq_counts = dist_inprocess(
        torch, lambda: dist_mnist_workflow(False), "none", DIST_EPOCHS)
    if len(meter.update_bytes) != jobs \
            or slave_wf.step.train_steps != train_jobs:
        fail("distributed: one unshuffled slave ran %d jobs, %d train"
             % (len(meter.update_bytes), slave_wf.step.train_steps))
    expect_dist_launches(seq_counts, train_jobs, "one unshuffled slave")
    scale = max(float(f.weights.abs().max()) for f in ref.forwards)
    seq_err = max(float((mf.export_params()[k]
                         - rf.export_params()[k].cpu()).abs().max())
                  for mf, rf in zip(master_wf.forwards, ref.forwards)
                  for k in rf.export_params()) / scale
    if not seq_err <= DIST_SEQ_RTOL:
        fail("distributed: one unshuffled slave's weights lie %.3g of the "
             "largest weight from the standalone run's" % seq_err)
    per_job["none_inprocess"] = sum(meter.update_bytes) / jobs
    # the other codecs' update bytes, one slave, one epoch each
    inproc_counts = dict(seq_counts)
    for codec in DIST_INPROC_CODECS:
        _, _, _, m, c = dist_inprocess(
            torch, lambda: dist_mnist_workflow(True), codec, 1)
        expect_dist_launches(c, DIST_TRAIN_JOBS, "one slave (%s)" % codec)
        inproc_counts = add_counts(inproc_counts, c)
        per_job[codec + "_inprocess"] = sum(m.update_bytes) \
            / len(m.update_bytes)
    # a slave killed mid-run: dropped, its jobs requeued, the run done
    kres, ksres, _, ktree, kseconds = dist_cluster(
        tmp, "kill", "none", DIST_KILL_EPOCHS, DIST_KILL_AFTER_JOBS)
    kc = kres["cluster"]
    if not kc["complete"] or kc["epoch"] != DIST_KILL_EPOCHS \
            or kc["faults"]["drops"] != 1 \
            or kc["faults"]["requeued_jobs"] < 1:
        fail("distributed kill: %s" % kc)
    timing = runs["none"]["timing"]
    summary = {
        "phase": "distributed", "part": "mnist", "card": card_line(),
        "jobs": jobs, "train_jobs": train_jobs,
        "rtt_p50_ms": 1e3 * median(timing["rtt_s"]),
        "compute_p50_ms": 1e3 * median(timing["compute_s"]),
        "wire_p50_ms": 1e3 * median(timing["wire_s"]),
        "wire_share_p50": median([w / r for w, r in zip(
            timing["wire_s"], timing["rtt_s"])]),
        "rtt_max_ms": 1e3 * max(timing["rtt_s"]),
        "timed_jobs": len(timing["rtt_s"]),
        "rx_bytes_per_job": per_job,
        "int8_share_of_none": per_job["int8"] / per_job["none"],
        "run_seconds": {c: r["seconds"] for c, r in runs.items()},
        "weights_moved": {c: r["moved"] for c, r in runs.items()},
        "sequential_err_share": seq_err,
        "kill": {"faults": kc["faults"], "seconds": kseconds,
                 "drop_seconds": kres["drop_seconds"],
                 "epochs": kc["epoch"],
                 "survivor_jobs": [r["slave"]["jobs"] for r in ksres]},
        "launches": {c: r["counts"] for c, r in runs.items()},
        "inprocess_launches": inproc_counts,
        "kill_survivor_launches": dist_counts(ksres)}
    emit(summary)
    counts = add_counts(runs["none"]["counts"], runs["int8"]["counts"])
    counts = add_counts(counts, inproc_counts)
    return add_counts(counts, dist_counts(ksres)), summary


def check_dist_lm(torch):
    """Phase distributed (b): the 110M LM's widths at 2 layers, one slave
    on the card, 4 jobs under bf16; -> its launches."""
    import numpy
    from veles_torch.config import root
    from veles_torch.znicz.models import transformer_lm
    from veles_torch import prng
    root.lm.train = {}
    for override in DIST_LM:
        root.apply_override(override)

    def workflow():
        prng.seed_all(1337)
        return transformer_lm.create_workflow()

    t0 = time.perf_counter()
    master_wf, slave_wf, server, meter, counts = dist_inprocess(
        torch, workflow, "bf16", 1)
    seconds = time.perf_counter() - t0
    want, mode = lm_expected_counts(slave_wf, DIST_DEVICE)
    if counts != want:
        fail("distributed lm: launches %s, expected %s" % (counts, want))
    jobs = slave_wf.step.train_steps + slave_wf.step.eval_steps
    if jobs != DIST_LM_JOBS:
        fail("distributed lm: %d jobs, expected %d" % (jobs, DIST_LM_JOBS))
    for gd in master_wf.gds:
        params = [name for name, _ in gd._wire_params()]
        if not params:
            continue
        if meter.job_keys.get(gd.name) != sorted(params) \
                or meter.update_keys.get(gd.name) != sorted(
                    "d" + p for p in params):
            fail("distributed lm: %s shipped %s / %s, its PARAMS %s"
                 % (gd.name, meter.job_keys.get(gd.name),
                    meter.update_keys.get(gd.name), params))
    bad = [f.name for f in master_wf.forwards
           for t in f.export_params().values()
           if not bool(numpy.isfinite(t.numpy()).all())]
    if bad:
        fail("distributed lm: non-finite master weights in %s" % bad)
    emit({"phase": "distributed", "part": "lm", "card": card_line(),
          "jobs": jobs, "attention_mode": mode, "seconds": seconds,
          "params": sum(t.numel() for f in master_wf.forwards
                        for t in f.export_params().values()),
          "update_bytes": meter.update_bytes,
          "faults": server.faults, "launches": counts})
    return counts


def start_dist_ga(tmp):
    """Phase distributed (c)'s GA master process, started ahead (its
    start overlaps part (b)); -> (its argv base, the process, the
    start time)."""
    cfg = os.path.join(tmp, "ga_config.py")
    with open(cfg, "w") as f:
        f.write(OPTIMIZE_CONFIG)
    base = [sys.executable, "-m", "veles_torch", MNIST_SAMPLE, cfg,
            *OPTIMIZE_RUN, "-d", DIST_DEVICE]
    master = subprocess.Popen(
        base + ["--optimize", OPTIMIZE_SEARCH, "--listen-address",
                "127.0.0.1:0"], cwd=HERE, env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return base, master, time.perf_counter()


def check_dist_ga(torch, started):
    """Phase distributed (c): ``--optimize 2x4 --listen-address`` (the
    master of :func:`start_dist_ga`) with two ``--optimize slave``
    processes on the card; -> the slaves' launches."""
    base, master, t0 = started
    slaves = []
    try:
        line = master.stdout.readline()
        try:
            addr = json.loads(line)["ga_master_listen"]
        except (ValueError, KeyError):
            fail("distributed ga: the master printed %r" % line)
        slaves = [subprocess.Popen(
            base + ["--optimize", "slave", "--master-address", addr],
            cwd=HERE, env=child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for _ in range(2)]
        out, err = master.communicate(timeout=DIST_BOUND)
        if master.returncode:
            fail("distributed ga: the master exited %s:\n%s"
                 % (master.returncode, err[-3000:]))
        reports = []
        for s in slaves:
            s_out, s_err = s.communicate(timeout=DIST_BOUND)
            if s.returncode:
                fail("distributed ga: a slave exited %s:\n%s"
                     % (s.returncode, s_err[-3000:]))
            reports.append(json.loads(s_out.strip().splitlines()[-1]))
    finally:
        for p in [master] + slaves:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    report = json.loads(out.strip().splitlines()[-1])
    served = sum(r["ga_slave_tasks"] for r in reports)
    if report["evaluations"] != OPTIMIZE_EVALUATIONS \
            or served != OPTIMIZE_EVALUATIONS \
            or not math.isfinite(report["best_fitness"]):
        fail("distributed ga: %s, %d tasks served" % (report, served))
    counts = dist_counts(reports)
    per = OPTIMIZE_EVALUATIONS * 2 * MNIST_TRAIN_STEPS \
        if DIST_DEVICE == "cuda" else 0
    want = dict(dict.fromkeys(counts, 0), **{"bias_grad[identity]": per,
                                             "bias_grad[masked]": per})
    if counts != want:
        fail("distributed ga: launches %s, expected %s" % (counts, want))
    emit({"phase": "distributed", "part": "ga", "card": card_line(),
          "search": OPTIMIZE_SEARCH, "seconds": seconds,
          "best_fitness": report["best_fitness"],
          "best_values": report["best_values"],
          "evaluations": report["evaluations"],
          "tasks_by_slave": [r["ga_slave_tasks"] for r in reports],
          "launches": counts})
    return counts


def check_distributed(torch):
    """Phase distributed: (a) the MNIST sample over the wire, (b) the
    110M LM's widths at 2 layers, (c) the GA over slaves; -> the
    launches of every slave of the phase."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    t0 = time.perf_counter()
    try:
        counts, _ = check_dist_mnist(torch, tmp)
        started = start_dist_ga(tmp)
        try:
            counts = add_counts(counts, check_dist_lm(torch))
        except BaseException:
            started[1].kill()
            started[1].wait()
            raise
        counts = add_counts(counts, check_dist_ga(torch, started))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "distributed", "part": "total", "card": card_line(),
          "seconds": time.perf_counter() - t0, "launches": counts})
    return counts

#: phase parallel: the ranks' device and their declared transport (two
#: ranks on one card: NCCL refuses that, so gloo over host copies)
PARALLEL_DEVICE = "cuda"
PARALLEL_TRANSPORT = "gloo-host"
#: (a) and (c): the 110M row at PARALLEL_LAYERS of its 12 layers, 2 train
#: and 1 valid minibatch of 8, 1 epoch (cut from 4 train minibatches and
#: 12 layers to keep the script inside its time limit: a 12-layer run took
#: the script to 1178-1309 s of its 1200 on slower hosts; phase
#: parallel_ep_pp runs the same minibatches and depth)
PARALLEL_LAYERS = 4
PARALLEL_110M = LM_110M + ("root.lm.loader.n_train=16",
                           "root.lm.loader.n_valid=8",
                           "root.lm.decision.max_epochs=1",
                           "root.lm.model.layers=%d" % PARALLEL_LAYERS)
#: (b): the 110M_s8k row (bench.py LM_ROWS: B 4, S 8192), its depth cut
#: from 12 to 6 layers, 1 train and 1 valid minibatch: the ring's host
#: copies cost ~10 s a 12-layer step over gloo-host (the first full call:
#: 7.85 GB of hops in 19.6 s over 2 train and 1 valid step)
PARALLEL_S8K_LAYERS = 6
PARALLEL_S8K = PARALLEL_110M + ("root.lm.loader.minibatch_size=4",
                                "root.lm.loader.n_train=4",
                                "root.lm.loader.n_valid=4",
                                "root.lm.loader.seq_len=8192",
                                "root.lm.model.layers=%d"
                                % PARALLEL_S8K_LAYERS)
PARALLEL_S8K_SHAPE = (4, 12, 8192, 64)
#: (a) holds DP in f32 (both runs) by each tensor's movement: under the
#: bf16 policy the ranks' half batches take other cuBLAS tilings than the
#: whole batch, whose f32 sums round to other bf16 activations, and the
#: bias sums over 4096 rows cancel: the first call read the biases up to
#: 1.6e-2 of their largest element off the one-process bf16 run (weights
#: 1.0e-3), while on the CPU (f32) DP equals one process to 3e-7. In f32
#: the only difference is the order of the gradient sums (two halves, then
#: the all-reduce)
PARALLEL_F32 = ("root.common.engine.amp=float32",
                "root.common.engine.compute_dtype=float32")
#: (a): every tensor's movement over the run in the f32 DP run's archive
#: against the f32 one-process run's: max|Δ_dp − Δ_1| / max|Δ_1|, Δ the
#: weights less the seed's initial ones. Predicted ~1e-5 before the second
#: call, which read up to 7.3e-3 of the largest element on the FFNs'
#: first-layer biases (5.2e-4 on their weights): the ReLU gate is a step,
#: and a pre-activation within an f32 rounding of 0 flips its row's whole
#: gradient there, so the two sum orders part by more than rounding over
#: 4 steps. A rank whose gradients skipped the all-reduce moves half as
#: far: about 0.5
PARALLEL_DP_RTOL = 5e-2
#: (a') and (c), the default bf16 policy: the same movement comparison
#: against the bf16 one-process run. bf16 rounds the activations where
#: the two runs' f32 sums part (1 ulp = 3.9e-3), and more ReLU gates flip
#: than in f32. A fault moves a tensor by another amount of the order of
#: its movement: a rank that skips the gradient all-reduce moves half as
#: far (0.5); a skipped partial-sum all-reduce under TP drops the other
#: rank's half of every attention output and FFN product, and a skipped
#: input-gradient all-reduce half of every lower layer's gradient
#: (test_torch_lm_parallel.py's planted faults read 0.70 and 1.61 on the
#: CPU, the sound runs 1.4e-6). Read on the card: DP 2.27e-2, TP 5.98e-2
PARALLEL_BF16_RTOL = 0.25
#: the validation and train losses of a parallel run against the
#: one-process run's, relative. Predicted: the row-sharded products sum
#: 384 of the 768 (3072) terms per rank in f32, then add: the losses agree
#: to a few f32 ulps of the activations' bf16 rounding, below 1e-3. The
#: losses barely move over 4 steps from random weights (validation runs
#: before them), so this bar alone would not show a fault: the movement
#: bars do
PARALLEL_LOSS_RTOL = 1e-3


def parallel_cli(torch, tmp, tag, overrides, *args):
    """One parallel LM run through the CLI in this process: the CLI builds
    the kernels (done) and spawns the ranks on this card over
    ``PARALLEL_TRANSPORT``; -> rank 0's result line (with ``seconds``)."""
    from veles_torch.config import root
    out = os.path.join(tmp, tag + ".json")
    t0 = time.perf_counter()
    transport = () if PARALLEL_TRANSPORT == "gloo" \
        else ("--transport", PARALLEL_TRANSPORT)
    try:
        code = cli_run([LM_SAMPLE, *overrides, *args, "--seed", "1337",
                        "-d", PARALLEL_DEVICE, *transport, "--no-stats",
                        "--result-file", out])
    finally:
        # the overrides also landed in this process's root
        root.common.engine.amp = root.common.engine.compute_dtype = None
    if code != 0:
        fail("parallel %s: the CLI exited %s" % (tag, code))
    with open(out) as f:
        res = json.load(f)
    res["seconds"] = time.perf_counter() - t0
    par = res["parallel"]
    if par["transport"] != PARALLEL_TRANSPORT:
        fail("parallel %s: transport %s" % (tag, par["transport"]))
    return res


def parallel_single(torch, tmp, tag, *overrides):
    """The one-process run of ``PARALLEL_110M`` (+ ``overrides``) on the
    card, its launches counted from 0 and held to what it implies; ->
    (workflow, counts, archive directory). The engine's dtype policy is
    cleared after."""
    from veles_torch.config import root
    archive = os.path.join(tmp, tag + "_archive")
    reset_counts()
    try:
        with contextlib.redirect_stdout(sys.stdout):
            wf = cli_run([LM_SAMPLE, *PARALLEL_110M, *overrides, "--seed",
                          "1337", "-d", PARALLEL_DEVICE, "--no-stats",
                          "--export-inference", archive])
    finally:
        root.common.engine.amp = root.common.engine.compute_dtype = None
    torch.cuda.synchronize()
    counts = read_counts()
    want, _ = lm_expected_counts(wf, PARALLEL_DEVICE)
    if counts != want:
        fail("parallel single %s: launches %s, expected %s"
             % (tag, counts, want))
    return wf, counts, archive


def rank_counts(launches):
    """A rank's ``launches_by_rank`` entry in ``read_counts``' keys."""
    return {"flash_fwd": launches["flash_fwd[fwd]"],
            "flash_fwd_pipe": launches["flash_fwd[fwd_pipe]"],
            "flash_bwd_fused": launches["flash_bwd[fused]"],
            "flash_bwd_dq": launches["flash_bwd[dq]"],
            "flash_bwd_dkv": launches["flash_bwd[dkv]"],
            "bias_grad[identity]": launches["bias_grad[identity]"],
            "bias_grad[masked]": launches["bias_grad[masked]"]}


def parallel_rows(res):
    """The per-rank timing lines of one parallel run."""
    par = res["parallel"]
    return [{"rank": r,
             "step_ms": 1e3 * st["train_seconds"] / max(1, st["train_steps"]),
             "collective_mb": st["collective_bytes"] / 1e6,
             "collective_host_s": st["collective_seconds"]}
            for r, st in enumerate(par["stats_by_rank"])]


def archive_errors(numpy, got_dir, want_dir, start_dir):
    """{file: max|Δgot − Δwant| / max|Δwant|} of every .npy of two
    inference archives, Δ each less the ``start_dir`` archive's (the
    tensor's movement over the run)."""
    out = {}
    for name in sorted(os.listdir(want_dir)):
        if not name.endswith(".npy"):
            continue
        start, want, got = (
            numpy.load(os.path.join(d, name)).astype(numpy.float64)
            for d in (start_dir, want_dir, got_dir))
        moved = numpy.abs(want - start).max()
        out[name] = float(numpy.abs(got - want).max() / max(moved, 1e-30))
    return out


def initial_archive(tmp, *overrides, tag="initial"):
    """The inference archive of ``PARALLEL_110M``'s (+ ``overrides``)
    weights as the seed draws them (f32, built on the host) -> its
    directory."""
    from veles_torch.config import root
    path = os.path.join(tmp, tag + "_archive")
    try:
        wf = build_lm(*PARALLEL_110M, *overrides, *PARALLEL_F32,
                      device="cpu")
        wf.export_inference(path)
    finally:
        root.common.engine.amp = root.common.engine.compute_dtype = None
    return path


def parallel_axes_args(axes):
    return tuple("root.lm.parallel.%s=%d" % kv for kv in axes.items())


def parallel_held(torch, tmp, tag, axes, single, single_counts,
                  single_archive, start, rtol, overrides=(),
                  collectives=None, rank_want=None, phase="parallel"):
    """One run of ``PARALLEL_110M`` (+ ``overrides``) under ``axes``
    through the CLI, held against the one-process run ``single`` of the
    same global minibatches (its launches ``single_counts``, its archive
    ``single_archive``): every tensor's movement from ``start`` (the
    seed's weights) within ``rtol``, the losses within
    ``PARALLEL_LOSS_RTOL``, each rank's launches equal to the one-process
    run's, and the collectives of a train step: 4 all-reduces a layer
    under ``model`` (12 heads and 3072 FFN units split), one gradient
    bucket of the parameters' f32 bytes under ``data`` (once a step in
    all when ``data`` is the only axis); or, given, the ``collectives``
    of a train step (rank 0's) and ``rank_want(rank)``, each rank's
    launches; -> the result line."""
    import numpy
    archive = os.path.join(tmp, tag + "_archive")
    res = parallel_cli(torch, tmp, tag, PARALLEL_110M + tuple(overrides),
                       *parallel_axes_args(axes), "--export-inference",
                       archive)
    par = res["parallel"]
    errs = archive_errors(numpy, archive, single_archive, start)
    worst = max(errs.values()) if errs else float("inf")
    if worst > rtol:
        fail("parallel %s: weights moved off the one-process run's by %s "
             "(bar %g)" % (tag, {k: v for k, v in errs.items() if v > rtol},
                           rtol))
    want_h, got_h = single.decision.history, res["history"]
    losses = {p: abs(got_h[0][p]["loss"] - want_h[0][p]["loss"])
              / abs(want_h[0][p]["loss"]) for p in ("validation", "train")}
    if max(losses.values()) > PARALLEL_LOSS_RTOL:
        fail("parallel %s: losses %s against the one-process run's %s"
             % (tag, [got_h[0][p]["loss"] for p in ("validation", "train")],
                [want_h[0][p]["loss"] for p in ("validation", "train")]))
    steps = par["train_steps"]
    if steps != single.step.train_steps:
        fail("parallel %s: %d train steps, the one-process run %d"
             % (tag, steps, single.step.train_steps))
    for r, launches in enumerate(par["launches_by_rank"]):
        got = rank_counts(launches)
        want = single_counts if rank_want is None else rank_want(r)
        if got != want:
            fail("parallel %s rank %d: launches %s, expected %s"
                 % (tag, r, got, want))
    if collectives is None:
        collectives = {"all-reduce": (4 * PARALLEL_LAYERS
                                      if axes.get("model", 1) > 1
                                      else 0)
                       + (1 if axes.get("data", 1) > 1 else 0)}
    if par["collective_counts"] != collectives:
        fail("parallel %s: collectives a step %s, expected %s"
             % (tag, par["collective_counts"], collectives))
    row = {"phase": phase, "part": tag, "card": card_line(),
           "transport": par["transport"], "mesh": par["mesh"],
           "dtype": "float32" if set(PARALLEL_F32) <= set(overrides)
           else "bfloat16",
           "seconds": res["seconds"], "train_steps": steps,
           "movement_max_rel_err": worst, "movement_bar": rtol,
           "loss_rel_err": losses,
           "worst_tensors": sorted(errs.items(), key=lambda kv: -kv[1])[:5],
           "ranks": parallel_rows(res),
           "single_step_ms": 1e3 * single.step.dispatch_seconds["train"][0]
           / single.step.train_steps,
           "collective_counts": par["collective_counts"],
           "collective_step_bytes": par["collective_step_bytes"],
           "collective_bytes": par["collective_bytes"],
           "collective_seconds": par["collective_seconds"],
           "launches_by_rank": par["launches_by_rank"]}
    if set(axes) == {"data"}:
        # a train step's one gradient bucket, and before every minibatch
        # the 2 stop flags' host all-reduce (8 bytes; TorchStep.stop_agreed)
        flags = par["stop_flag_all_reduces"]
        per_step = (par["collective_bytes"]["all-reduce"] - 8 * flags) \
            / steps
        if par["collective_calls"].get("all-reduce") != steps + flags \
                or per_step != par["grad_sync_bytes"]:
            fail("parallel %s: %s all-reduces for %d steps and %d stop "
                 "flags, %.0f bytes a step, the parameters %d" % (
                     tag, par["collective_calls"], steps, flags, per_step,
                     par["grad_sync_bytes"]))
        row["grad_allreduce_bytes_per_step"] = per_step
        row["stop_flag_all_reduces"] = flags
        row["stop_flag_seconds"] = par["stop_flag_seconds"]
    emit(dict(row, **transport_note()))
    return res


def transport_note():
    """The note that the phase's times are gloo-host's, where they are."""
    if PARALLEL_TRANSPORT != "gloo-host":
        return {}
    return {"note": "gloo-host times: host copies and gloo on one card, "
                    "not NCCL"}


def ring_layer_rank(seed):
    """One rank of phase parallel (b)'s layer check: the ring forward and
    backward of one MHA layer's attention at ``PARALLEL_S8K_SHAPE`` on
    this rank's shard of the sequence, against the single-card flash path
    and the float64 math on the same rows; -> (errors, this rank's flash
    launches by mask in the ring)."""
    import torch
    from veles_torch.znicz import parallel
    from veles_torch.znicz.ops import flash_attention as FA
    from veles_torch.znicz.parallel import ring as R
    rank, world = parallel.init_multihost(transport=PARALLEL_TRANSPORT)
    if PARALLEL_TRANSPORT == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    try:
        mesh = parallel.make_mesh({"seq": world})
        q, k, v, dout = flash_inputs(torch, PARALLEL_S8K_SHAPE,
                                     torch.bfloat16, seed=seed)
        s = q.shape[2] // world
        lo = mesh.index("seq") * s

        def mine(t):
            return t[:, :, lo:lo + s].contiguous()
        FA.reset_launches()
        out, lse = R.ring_self_attention(mine(q), mine(k), mine(v), mesh,
                                         causal=True, inner="pallas")
        grads = R.ring_self_attention_bwd(
            mine(q), mine(k), mine(v), out, lse, mine(dout), mesh,
            causal=True, inner="pallas")
        torch.cuda.synchronize()
        launches = {"fwd": dict(FA.flash_attention_fwd.mask_launches),
                    "bwd": dict(FA.flash_attention_bwd.mask_launches)}
        ro, rl = FA.flash_attention_fwd(q, k, v, causal=True)
        rgrads = FA.flash_attention_bwd(q, k, v, ro, rl, dout, causal=True)
        exact = flash_reference(torch, q, k, v, dout, True, out_in=ro)
        names = ("out", "dq", "dk", "dv")
        got = (out,) + tuple(grads)
        vs_single = {n: scaled_err(g, mine(w)) for n, g, w in
                     zip(names, got, (ro,) + tuple(rgrads))}
        vs_exact = {n: scaled_err(g, mine(w)) for n, g, w in
                    zip(names, got, exact[:1] + exact[2:])}
        vs_single["lse"] = (lse - mine(rl)).abs().max().item()
        vs_exact["lse"] = (lse.double() - mine(exact[1])).abs().max().item()
        return {"vs_single": vs_single, "vs_exact": vs_exact}, launches
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def parallel_sp(torch, tmp, ranks=2):
    """Phase parallel (b) on ``ranks`` ranks: rank r's ring launches one
    causal forward and backward a layer a step and r non-causal ones (its
    past shards), and hops 2(n−1) + 4(n−1) + 2 times a layer a step."""
    from veles_torch.znicz import parallel
    t0 = time.perf_counter()
    layer = parallel.spawn(ring_layer_rank, ranks, args=(2718,),
                           timeout_s=300.0)
    layer_s = time.perf_counter() - t0
    for r, (errs, launches) in enumerate(layer):
        tol, etol = FLASH_VS_PLAIN_TOL["bfloat16"], FLASH_TOL["bfloat16"]
        bad = {n: e for n, e in errs["vs_single"].items()
               if e > (LSE_ATOL if n == "lse" else tol)}
        bad.update({"exact_" + n: e for n, e in errs["vs_exact"].items()
                    if e > (LSE_ATOL if n == "lse" else etol)})
        if bad:
            fail("parallel sp: ring rank %d off the single-card flash path "
                 "or the float64 math: %s" % (r, bad))
        want = {"causal": 1, "full": r}
        if launches != {"fwd": want, "bwd": want}:
            fail("parallel sp: ring rank %d launched %s, expected %s each"
                 % (r, launches, want))
    res = parallel_cli(torch, tmp, "sp", PARALLEL_S8K,
                       "root.lm.parallel.seq=%d" % ranks)
    par = res["parallel"]
    layers = PARALLEL_S8K_LAYERS
    train, evals = par["train_steps"], par["eval_steps"]
    for r, launches in enumerate(par["launches_by_rank"]):
        steps_fwd, steps_bwd = layers * (train + evals), layers * train
        want = {"flash_fwd[causal]": steps_fwd,
                "flash_fwd[full]": steps_fwd * r,
                "flash_bwd[causal]": steps_bwd,
                "flash_bwd[full]": steps_bwd * r,
                "flash_fwd[fwd_pipe]": 0, "flash_bwd[dq]": 0,
                "flash_bwd[dkv]": 0}
        got = {k: launches[k] for k in want}
        if got != want:
            fail("parallel sp rank %d: launches %s, expected %s"
                 % (r, got, want))
    hops = layers * (2 * (ranks - 1) + 4 * (ranks - 1) + 2)
    if par["collective_counts"] != {"collective-permute": hops,
                                    "all-reduce": 1}:
        fail("parallel sp: collectives a step %s"
             % par["collective_counts"])
    emit({"phase": "parallel", "part": "sp", "card": card_line(),
          "transport": par["transport"], "mesh": par["mesh"],
          **transport_note(),
          "layer_check": [e for e, _ in layer], "layer_check_seconds":
          layer_s, "seconds": res["seconds"], "train_steps": train,
          "eval_steps": evals, "ranks": parallel_rows(res),
          "collective_counts": par["collective_counts"],
          "collective_bytes": par["collective_bytes"],
          "collective_seconds": par["collective_seconds"],
          "launches_by_rank": par["launches_by_rank"],
          "history": res["history"]})
    return res


def check_parallel(torch, ranks=2):
    """Phase parallel on ``ranks`` ranks over ``PARALLEL_TRANSPORT``: (a)
    DP in f32, (a') DP and (c) TP under the bf16 policy, (b) the ring,
    (d) the dry run; -> the ranks' launches of the phase's runs,
    summed."""
    import shutil
    import tempfile
    from veles_torch.graft_entry import dryrun_multichip
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_")
    t0 = time.perf_counter()
    try:
        start = initial_archive(tmp)
        single, counts32, archive = parallel_single(torch, tmp, "f32",
                                                    *PARALLEL_F32)
        runs = [parallel_held(torch, tmp, "dp", {"data": ranks}, single,
                              counts32, archive, start, PARALLEL_DP_RTOL,
                              PARALLEL_F32)]
        del single
        single, counts16, archive = parallel_single(torch, tmp, "bf16")
        runs.append(parallel_held(torch, tmp, "dp_bf16", {"data": ranks},
                                  single, counts16, archive, start,
                                  PARALLEL_BF16_RTOL))
        runs.append(parallel_held(torch, tmp, "tp", {"model": ranks},
                                  single, counts16, archive, start,
                                  PARALLEL_BF16_RTOL))
        if ranks >= 4:
            runs.append(parallel_held(
                torch, tmp, "dp_tp", {"data": 2, "model": ranks // 2},
                single, counts16, archive, start, PARALLEL_BF16_RTOL))
        del single
        torch.cuda.empty_cache()
        runs.append(parallel_sp(torch, tmp, ranks))
        t1 = time.perf_counter()
        dry = dryrun_multichip(ranks, device=PARALLEL_DEVICE,
                               transport=PARALLEL_TRANSPORT)
        emit({"phase": "parallel", "part": "dryrun", "card": card_line(),
              "seconds": time.perf_counter() - t1, **dry})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = add_counts(*[rank_counts(l) for res in runs
                          for l in res["parallel"]["launches_by_rank"]])
    emit({"phase": "parallel", "part": "total", "card": card_line(),
          "ranks": ranks, "transport": PARALLEL_TRANSPORT,
          "seconds": time.perf_counter() - t0, "launches": counts})
    return counts


#: phase parallel_ep_pp (e): the MoE FFN at the 110M width as phase moe
#: runs it (LM_110M_MOE: 4 layers, 8 experts, cf 2.0, aux 0.01) on
#: PARALLEL_110M's minibatches, in f32 (a skipped combine must read above
#: PARALLEL_DP_RTOL, which holds the f32 runs)
PARALLEL_MOE = ("root.lm.model.layers=4", "root.lm.model.moe_experts=8",
                "root.lm.model.moe_capacity_factor=2.0",
                "root.lm.model.moe_aux_weight=0.01") + PARALLEL_F32
#: the all-to-all run's capacity factor: at 8 experts a factor of 8 gives
#: every expert a whole source shard's tokens, so no shard overflows its
#: quota and the exchange must equal one process (the reference's
#: condition)
PARALLEL_MOE_A2A = PARALLEL_MOE + ("root.lm.model.moe_capacity_factor=8.0",)
#: (f): the stacked 110M (PARALLEL_LAYERS blocks, dense attention inside)
#: on PARALLEL_110M's minibatches in f32, pipe 2 over PARALLEL_MICRO
#: microbatches of 2
PARALLEL_STACK = ("root.lm.model.stacked=True",
                  "root.lm.model.attn_block=None") + PARALLEL_F32
PARALLEL_MICRO = 4
#: (e): the tokens a gather run's MoE layer dropped in its last step equal
#: the one-process run's under ``expert`` alone; with ``data`` too, within
#: this many a layer: the attention then runs on 2 rows a rank, not 8, its
#: f32 products round otherwise, and after 3 updates a router near-tie can
#: flip (1 of 4096 tokens at layer 2, 4 NVIDIA H100s over NCCL)
PARALLEL_DROPS_ATOL = 4


def ep_expected(layers, routing, axes):
    """Rank 0's collectives of an EP train step (the last step: no layer
    stats): gather routing gathers a MoE layer's tokens and errors over
    the expert line (and its token counts over data) and all-reduces its
    combine and its input and gate gradients; the exchange all-to-alls
    its slots there and back, forward and backward, and all-reduces the
    routing frequency; one gradient bucket over every axis, and under
    data the experts' own over data."""
    data = axes.get("data", 1) > 1
    if routing == "gather":
        return {"all-gather": (3 if data else 2) * layers,
                "all-reduce": 2 * layers + 1 + data}
    return {"all-to-all": 4 * layers, "all-reduce": layers + 1 + data}


def pp_rank_want(single_counts, wf, stages):
    """A stage's launches under PP: no flash kernel (the stack's attention
    is dense), and per train step the block's 6 column sums per microbatch
    of its L/P blocks plus the token dense's one."""
    from veles_torch.znicz.ops.transformer_stack import TransformerBlockStack
    layers = next(f.layers for f in wf.forwards
                  if isinstance(f, TransformerBlockStack))
    train = wf.step.train_steps
    want = dict(single_counts, **{
        "bias_grad[identity]": train * (6 * layers // stages
                                        * PARALLEL_MICRO + 1)})
    if PARALLEL_DEVICE == "cpu":
        want = dict.fromkeys(want, 0)
    return lambda rank: want


def ep_pp_modes(ranks):
    """(EP modes [(tag, axes, routing)], PP modes [(tag, axes,
    schedule)]) of phase parallel_ep_pp on ``ranks`` ranks: every axis
    over all of them, and on 4 ranks also 2 × data 2."""
    ep = [("ep_gather", {"expert": ranks}, "gather")]
    pp = [("pp_gpipe", {"pipe": ranks}, "gpipe"),
          ("pp_1f1b", {"pipe": ranks}, "1f1b")]
    if ranks >= 4:
        ep.append(("ep_gather_dp", {"data": ranks // 2, "expert": 2},
                   "gather"))
        pp.append(("pp_gpipe_dp", {"data": ranks // 2, "pipe": 2},
                   "gpipe"))
    ep.append(("ep_alltoall", {"expert": ranks}, "alltoall"))
    return ep, pp


def check_parallel_ep_pp(torch, ranks=2):
    """Phase parallel_ep_pp on ``ranks`` ranks over ``PARALLEL_TRANSPORT``
    as phase parallel (``ep_pp_modes``): (e) the 110M MoE under
    ``expert``, gather routing and the all-to-all exchange, and (f) the
    stacked 110M under ``pipe``, GPipe and 1F1B, each held against the
    one-process run of its config by every tensor's movement
    (``PARALLEL_DP_RTOL``, f32), the losses, each rank's exact launches
    and the collectives a step; the gather runs' drops a layer equal to
    the one-process run's; the stages' chunk forwards (one a microbatch a
    step) and peak device memory under each schedule; -> the ranks'
    launches, summed."""
    import shutil
    import tempfile
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eppp_")
    t0 = time.perf_counter()
    runs = []
    ep_modes, pp_modes = ep_pp_modes(ranks)
    try:
        start = initial_archive(tmp, *PARALLEL_MOE, tag="moe_initial")
        singles = {}
        for tag, axes, routing in ep_modes:
            overrides = PARALLEL_MOE if routing == "gather" \
                else PARALLEL_MOE_A2A
            if routing not in singles:     # the modes come routing by
                singles.clear()            # routing: one single each
                singles[routing] = parallel_single(
                    torch, tmp, "ep_single_" + routing, *overrides)
            single, counts, archive = singles[routing]
            res = parallel_held(
                torch, tmp, tag, axes, single, counts, archive, start,
                PARALLEL_DP_RTOL,
                overrides + ("root.lm.parallel.ep_routing=%s" % routing,),
                collectives=ep_expected(4, routing, axes),
                phase="parallel_ep_pp")
            want = {f.name: float(f.dropped) for f in single.forwards
                    if getattr(f, "dropped", None) is not None}
            got = res["parallel"]["dropped"]
            tol = 0 if set(axes) == {"expert"} else PARALLEL_DROPS_ATOL
            if routing == "gather" and (set(got) != set(want) or any(
                    abs(got[k] - want[k]) > tol for k in want)):
                fail("parallel_ep_pp %s: dropped %s a layer, the one-process "
                     "run %s (within %d)" % (tag, got, want, tol))
            if routing == "alltoall" and any(got.values()):
                fail("parallel_ep_pp %s: rank 0's shard dropped %s at a "
                     "capacity no shard overflows" % (tag, got))
            emit({"phase": "parallel_ep_pp", "part": tag + "_drops",
                  "card": card_line(), "dropped": got,
                  "single_dropped": want})
            runs.append(res)
        singles.clear()
        start = initial_archive(tmp, *PARALLEL_STACK, tag="stack_initial")
        single, counts, archive = parallel_single(torch, tmp, "pp_single",
                                                  *PARALLEL_STACK)
        peaks = {}
        for tag, axes, schedule in pp_modes:
            data = axes.get("data", 1)
            res = parallel_held(
                torch, tmp, tag, axes, single, counts, archive, start,
                PARALLEL_DP_RTOL, PARALLEL_STACK + (
                    "root.lm.parallel.schedule=%s" % schedule,
                    "root.lm.parallel.microbatches=%d" % PARALLEL_MICRO),
                collectives={"collective-permute": PARALLEL_MICRO,
                             "all-reduce": 2 + (data > 1)},
                rank_want=pp_rank_want(counts, single, axes["pipe"]),
                phase="parallel_ep_pp")
            par = res["parallel"]
            steps = par["train_steps"] + par["eval_steps"]
            for r, st in enumerate(par["stats_by_rank"]):
                if st["chunk_forwards"] != PARALLEL_MICRO * steps:
                    fail("parallel_ep_pp %s rank %d: %d chunk forwards for "
                         "%d steps of %d microbatches" % (
                             tag, r, st["chunk_forwards"], steps,
                             PARALLEL_MICRO))
            if data == 1:
                peaks[schedule] = [st["max_memory_allocated"]
                                   for st in par["stats_by_rank"]]
            runs.append(res)
        del single
        emit({"phase": "parallel_ep_pp", "part": "pp_memory",
              "card": card_line(), "microbatches": PARALLEL_MICRO,
              "max_memory_allocated_by_stage": peaks,
              "gpipe_less_1f1b_by_stage": [
                  g - o for g, o in zip(peaks["gpipe"], peaks["1f1b"])]})
        if any(o > g for g, o in zip(peaks["gpipe"], peaks["1f1b"])):
            fail("parallel_ep_pp: 1F1B's peak memory %s above GPipe's %s"
                 % (peaks["1f1b"], peaks["gpipe"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = add_counts(*[rank_counts(l) for res in runs
                          for l in res["parallel"]["launches_by_rank"]])
    emit({"phase": "parallel_ep_pp", "part": "total", "card": card_line(),
          "ranks": ranks, "transport": PARALLEL_TRANSPORT,
          "seconds": time.perf_counter() - t0, "launches": counts})
    return counts


# -- the rest of the parallelism, and the image formats ---------------------

#: phase parallel_unsupervised: the SOM and MnistRBM at the reference's
#: configs (phase unsupervised's) under data=2, two ranks sharing the card
#: over PARALLEL_TRANSPORT, against one process on the card. The SOM's
#: weights within UNSUP_DP_ATOL of their largest element (f32 pulls summed
#: over two shards, then all-reduced); the RBM's binarize uniforms bit for
#: bit (each rank draws the minibatch's array and keeps its rows), its
#: errors within UNSUP_DP_RTOL relative; both in f32 (the RBM's tied
#: products otherwise round to bf16 on the card)
UNSUP_DP_ATOL = 1e-5
UNSUP_DP_RTOL = 1e-5
#: phase parallel_preempt: the 110M widths at 2 of 12 layers, momentum,
#: f32, 4 train and 1 valid minibatch of 8 an epoch, 2 epochs, under
#: data=2; run B signalled PREEMPT_B_AFTER train steps into epoch 1
PREEMPT_PAR_RUN = LM_110M + (
    "root.lm.model.layers=2", "root.lm.loader.n_train=32",
    "root.lm.loader.n_valid=8", "root.lm.decision.max_epochs=2",
    "root.lm.parallel.data=2") + PARALLEL_F32
#: the config file of runs B and B resumed: their snapshotter writes
#: uncompressed checkpoints (the default gzip at level 9 on one core takes
#: ~15 s for this run's 243 MB, PR 22 call 1; phase resume times both
#: forms)
PREEMPT_RAW = """
from veles_torch.znicz.standard_workflow import StandardWorkflow
_link = StandardWorkflow.link_snapshotter
StandardWorkflow.link_snapshotter = \\
    lambda self, **cfg: _link(self, **dict({"compression": ""}, **cfg))
"""
#: run B's config file besides: rank 0 signals the spawner (its parent)
#: after the train step PREEMPT_B_AFTER into epoch 1, notes the wall time,
#: and waits for its own forwarded signal, so every rank stops before the
#: next minibatch
PREEMPT_HOOK = PREEMPT_RAW + """
import os, signal, time
from veles_torch.znicz.step import TorchStep
if os.environ.get("RANK") == "0":
    _train = TorchStep.train_minibatch

    def _preempting(step, *args):
        out = _train(step, *args)
        if step.decision.epoch_number == 1 and step.entry is not None \\
                and step.train_steps == step.entry["step_index"] + %d:
            with open(%r, "w") as f:
                f.write(repr(time.time()))
            os.kill(os.getppid(), signal.SIGTERM)
            deadline = time.monotonic() + 120
            while not step.stop_requested and time.monotonic() < deadline:
                time.sleep(0.005)
        return out
    TorchStep.train_minibatch = _preempting
"""
#: phase parallel_cli: the 110M at full width (12 layers), 2 train and 1
#: valid minibatch of 8, under data=2, then --generate sampled at
#: PAR_GEN_TEMPERATURE (the sampler seeded as one process seeds it; f32
#: either way): greedy, the 2-step model repeats one token, which weights
#: far from the gathered ones could give as well
PAR_GEN_RUN = LM_110M + ("root.lm.loader.n_train=16",
                         "root.lm.loader.n_valid=8",
                         "root.lm.decision.max_epochs=1",
                         "root.lm.parallel.data=2")
PAR_GEN_PROMPT, PAR_GEN_TOKENS = "1,2,3,4", 16
PAR_GEN_TEMPERATURE = 1.0
#: the sampled tokens must hold at least this many distinct ones
PAR_GEN_DISTINCT = 4
#: --ensemble 2 and --optimize 1x2 of the LM sample (dim 64, 2 layers) cut
#: from 8 epochs to 2 (with 512 of its 2048 train sequences the members
#: barely learn, and the ensemble read worse than its weakest member: PR
#: 22 call 2), in f32, under data=2 against one process: the
#: existing bars (phase ensemble: the ensemble no worse than its weakest
#: member; phase optimize: the same values and evaluations), each
#: member's error within PAR_CLI_ERROR_ATOL of one process's (phase
#: mnist's card-against-cpu bar on an error rate) and the fitness (the
#: best validation loss) within PARALLEL_LOSS_RTOL. Not bit for bit: on
#: the card the ranks' half batches take other cuBLAS tilings than the
#: whole batch (PR 20: DP f32 moves a tensor up to 9.3e-3 of its
#: movement off over 4 steps), and over 2 epochs the members part: the
#: first call read one member's error 2.8e-3 off (23 of 8192 tokens)
PAR_LM_SAMPLE = ("root.lm.decision.max_epochs=2",) + PARALLEL_F32
PAR_CLI_ERROR_ATOL = 0.02
#: the LM sample's learning rate searched by --optimize 1x2
PAR_TUNE = ("from veles_torch.config import Tune, root\n"
            "root.lm.train.learning_rate = Tune(0.02, 0.005, 0.1)\n")
#: a host master of the LM sample (1 epoch) with a slave of 2 ranks, and
#: with a one-process slave: the masters' archives within PAR_SLAVE_ATOL
#: of the largest element
PAR_SLAVE_RUN = ("root.lm.decision.max_epochs=1",) + PARALLEL_F32
PAR_SLAVE_ATOL = 1e-5
#: phase image_jpeg: the committed fixtures and their Pillow digests
JPEG_FIXTURES = os.path.join(HERE, "tests", "data", "jpeg")
#: the streamed tree: each of the 16 tree_NN.jpg fixtures (320x240, even
#: ones baseline 4:2:0, odd ones progressive) and its arithmetic-coded
#: twin arith_tree_NN.jpg (the same coefficients, so the same pixels)
#: copied JPEG_COPIES times in turn into its class's directory: phase
#: image_stream's geometry (the stride split holds 8 of 72 out a class:
#: 1024 train and 128 validation images, 8 train steps an epoch), so the
#: two trees' images/s compare
JPEG_COPIES = 72
#: 2 epochs at a learning rate of JPEG_LR. At the sample's 0.01 AlexNet's
#: train loss on this tree spikes from 4.6 to 24 within the first epoch
#: and its validation loss ends 5.6 times the untrained model's (an H100,
#: tools/alexnet_tree_losses.py; phase image_stream's PNG tree alike), so
#: the check below could not tell a run that learns from one that
#: diverged
JPEG_LR = 0.001
JPEG_RUN = ("root.imagenet.decision.max_epochs=2",
            "root.imagenet.lr=%g" % JPEG_LR, "--seed", "1337")
#: decodes timed per file kind, one thread, and the files timed
JPEG_TIMED = 16
JPEG_TIMED_FILES = {"baseline_420": "tree_00.jpg",
                    "progressive": "tree_01.jpg",
                    "arith_sequential": "arith_tree_00.jpg",
                    "arith_progressive": "arith_tree_01.jpg",
                    "lossless_420": "lossless_420.jpg",
                    "paeth_png": "paeth.png"}
#: the codings of the streamed tree's copies, in turn, and the prefix of
#: each coding's tree fixtures
JPEG_TREE_CODINGS = ("huffman", "arithmetic")
JPEG_TREE_PREFIX = {"huffman": "", "arithmetic": "arith_"}
#: the one tree image the twins decode in check_fixtures (the natives
#: decode every fixture)
JPEG_TWIN_TREE = "arith_tree_01.jpg"


def par_device_args():
    """The CLI's device and declared transport of the parallel runs."""
    return ("-d", PARALLEL_DEVICE) + (
        () if PARALLEL_TRANSPORT == "gloo"
        else ("--transport", PARALLEL_TRANSPORT))


def par_sync(torch):
    if PARALLEL_DEVICE == "cuda":
        torch.cuda.synchronize()


def unsup_run(sample, device, record=None):
    """The SOM or MnistRBM sample at its reference config in f32 on
    ``device`` (on a mesh: set up by the caller after it returns the
    initialized workflow); with ``record`` (a list) the RBM's binarize
    uniforms are appended to it. -> the initialized workflow."""
    from veles_torch import prng
    from veles_torch.config import root
    from veles_torch.__main__ import import_file
    module = import_file(sample, "chip_smoke_unsup_%s"
                         % os.path.basename(sample)[:-3])
    restore = f32_policy()
    try:
        prng.seed_all(UNSUPERVISED_SEED)
        wf = module.create_workflow().initialize(device=device)
    finally:
        restore()
    if record is not None and hasattr(wf, "binarize"):
        plain = wf.binarize.uniforms

        def recording(p):
            u = plain(p)
            record.append(u.cpu().numpy())
            return u
        wf.binarize.uniforms = recording
    return wf


def unsup_result(torch, wf, record):
    import numpy
    par_sync(torch)
    from veles_torch.znicz import parallel
    params = {"%s.%s" % (u, k): t.detach().cpu().numpy()
              for u, sub in wf.export_tree().items()
              for k, t in sub.items()}
    return {"history": wf.decision.history, "params": params,
            "uniforms": numpy.concatenate(record) if record else None,
            "counts": parallel.collective_counts(wf.step),
            "epoch_ms": [1e3 * t for t in wf.step.epoch_seconds],
            "train_steps": wf.step.train_steps,
            "stop_flag_all_reduces": wf.step.stop_flag_reduces,
            "stop_flag_seconds": wf.step.stop_flag_seconds}


def unsup_rank(samples, transport):
    """One rank of phase parallel_unsupervised (``parallel.spawn``): each
    sample under data=2 on the card. -> {sample: its result
    (unsup_result) and the seconds of its run}."""
    import torch
    import torch.distributed as dist
    from veles_torch.znicz import parallel
    parallel.init_multihost(transport=transport)
    out = {}
    try:
        for sample in samples:
            t0 = time.perf_counter()
            record = []
            wf = unsup_run(sample, PARALLEL_DEVICE, record)
            parallel.setup_data_parallel(wf,
                                         parallel.make_mesh({"data": 2}))
            wf.run()
            out[sample] = dict(unsup_result(torch, wf, record),
                               seconds=time.perf_counter() - t0)
        return out
    finally:
        dist.destroy_process_group()


def check_parallel_unsupervised(torch):
    """Phase parallel_unsupervised; -> its launches (none: neither path
    runs a kernel of the port)."""
    import numpy
    from veles_torch.znicz import parallel
    t0 = time.perf_counter()
    import threading
    samples = (KOHONEN_SAMPLE, RBM_SAMPLE)
    reset_counts()
    # the ranks' run in a thread while the one-process runs go here
    spawned = {}

    def ranks_run():
        t1 = time.perf_counter()
        try:
            spawned["dp"] = parallel.spawn(unsup_rank, 2, args=(
                samples, PARALLEL_TRANSPORT))
        except BaseException as exc:
            spawned["error"] = exc
        spawned["seconds"] = time.perf_counter() - t1
    thread = threading.Thread(target=ranks_run)
    thread.start()
    ones = {}
    for sample in samples:
        record = []
        wf = unsup_run(sample, PARALLEL_DEVICE, record)
        wf.run()
        ones[sample] = unsup_result(torch, wf, record)
        del wf
    counts = read_counts()
    thread.join()
    if "error" in spawned:
        raise spawned["error"]
    dp, spawn_seconds = spawned["dp"], spawned["seconds"]
    for sample in samples:
        name = os.path.basename(sample)[:-3]
        one = ones[sample]
        ranks = [r[sample] for r in dp]
        dp_seconds = ranks[0]["seconds"]
        worst = max(float(numpy.abs(ranks[0]["params"][k] - w).max()
                          / max(float(numpy.abs(w).max()), 1e-30))
                    for k, w in one["params"].items())
        ranks_equal = all(numpy.array_equal(ranks[0]["params"][k],
                                            ranks[1]["params"][k])
                          for k in one["params"])
        errors = [(h1["train"]["metric"], h2["train"]["metric"])
                  for h1, h2 in zip(one["history"], ranks[0]["history"])]
        errors += [(h1["validation"]["metric"], h2["validation"]["metric"])
                   for h1, h2 in zip(one["history"], ranks[0]["history"])
                   if "validation" in h1]
        err_rel = max(abs(a - b) / max(abs(a), 1e-30) for a, b in errors)
        bits = None
        if one["uniforms"] is not None:
            per = [numpy.split(r["uniforms"], len(r["uniforms"]) // 50)
                   for r in ranks]
            whole = numpy.concatenate([numpy.concatenate([a, b])
                                       for a, b in zip(*per)])
            bits = bool(numpy.array_equal(whole, one["uniforms"]))
        row = {"phase": "parallel_unsupervised", "sample": name,
               "card": card_line(), "transport": PARALLEL_TRANSPORT,
               "epochs": [len(one["history"]), len(ranks[0]["history"])],
               "train_steps": ranks[0]["train_steps"],
               "weights_max_rel_err": worst, "ranks_equal": ranks_equal,
               "metric_max_rel_err": err_rel, "uniform_bits_equal": bits,
               "collective_counts": ranks[0]["counts"],
               "stop_flag_all_reduces": ranks[0]["stop_flag_all_reduces"],
               "stop_flag_seconds": ranks[0]["stop_flag_seconds"],
               "epoch_ms_one": one["epoch_ms"],
               "epoch_ms_rank0": ranks[0]["epoch_ms"],
               "dp_seconds": dp_seconds, "spawn_seconds": spawn_seconds,
               "launches": counts}
        emit(row)
        want_counts = {"all-reduce": 1 if name == "kohonen" else 2}
        if len(one["history"]) != len(ranks[0]["history"]) \
                or not ranks_equal:
            fail("parallel_unsupervised %s: %s" % (name, row))
        if name == "kohonen" and not worst <= UNSUP_DP_ATOL:
            fail("parallel_unsupervised: SOM weights %.3g of the largest "
                 "from one process's" % worst)
        if name != "kohonen" and (not bits or not err_rel <= UNSUP_DP_RTOL):
            fail("parallel_unsupervised: RBM uniforms equal %s, errors "
                 "%.3g relative" % (bits, err_rel))
        if ranks[0]["counts"] != want_counts:
            fail("parallel_unsupervised %s: collectives a step %s, "
                 "expected %s" % (name, ranks[0]["counts"], want_counts))
    emit({"phase": "parallel_unsupervised", "part": "total",
          "seconds": time.perf_counter() - t0})
    return dict.fromkeys(read_counts(), 0)


def archive_arrays(path):
    import numpy
    return {f: numpy.load(os.path.join(path, f))
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}


def start_cli(tmp, tag, args):
    """``python -m veles_torch`` with ``args`` started in a child process
    on this card, its output to ``tmp/<tag>.out``; -> (the process, that
    path, its start). The independent parallel runs of phases
    parallel_preempt and parallel_cli run side by side: their ranks spend
    their time in host copies and leave the card mostly idle."""
    path = os.path.join(tmp, tag + ".out")
    with open(path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "veles_torch",
                                 *args], cwd=HERE, env=child_env(),
                                stdout=out, stderr=subprocess.STDOUT)
    return proc, path, time.perf_counter()


def finish_cli(started, what, timeout=900):
    """Wait for a child of :func:`start_cli`; -> (its output, its
    seconds). A failed child fails the phase with its output."""
    proc, path, t0 = started
    try:
        code = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(path) as f:
        out = f.read()
    if code != 0:
        fail("%s: exit %d: %s" % (what, code, out[-3000:]))
    return out, time.perf_counter() - t0


def check_parallel_preempt(torch):
    """Phase parallel_preempt: run A uninterrupted under data=2 (a child
    process, beside B); run B signalled PREEMPT_B_AFTER train steps into
    epoch 1 (every rank and the spawner exit 75, one checkpoint), resumed
    by --snapshot auto in a fresh spawn; every parameter and the decision
    bit for bit. -> the ranks' launches of the three runs."""
    import shutil
    import tempfile
    import numpy
    from veles_torch import snapshotter as S
    from veles_torch.launcher import EXIT_PREEMPTED
    tmp = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
    t0 = time.perf_counter()
    runs = []
    try:
        # run A in a child process while run B and its resume run here
        a_json = os.path.join(tmp, "a.json")
        run_a = start_cli(tmp, "preempt_a", [
            LM_SAMPLE, *PREEMPT_PAR_RUN, "--seed", "1337",
            *par_device_args(), "--no-stats", "--result-file", a_json,
            "--export-inference", os.path.join(tmp, "a_archive")])
        hook = os.path.join(tmp, "hook.py")
        raw = os.path.join(tmp, "raw.py")
        mark = os.path.join(tmp, "mark")
        with open(hook, "w") as f:
            f.write(PREEMPT_HOOK % (PREEMPT_B_AFTER, mark))
        with open(raw, "w") as f:
            f.write(PREEMPT_RAW)
        snaps = os.path.join(tmp, "b_snaps")
        from veles_torch.config import root
        try:
            code = cli_run([LM_SAMPLE, hook, *PREEMPT_PAR_RUN, "--seed",
                            "1337", *par_device_args(), "--no-stats",
                            "--snapshots", snaps])
        finally:
            root.common.engine.amp = root.common.engine.compute_dtype = None
        exited = time.time()
        if code != EXIT_PREEMPTED or not os.path.exists(mark):
            fail("parallel_preempt: run B exited %s (signal sent: %s)"
                 % (code, os.path.exists(mark)))
        with open(mark) as f:
            signal_to_exit = exited - float(f.read())
        current = [n for n in os.listdir(snaps) if "_current-" in n]
        tree, name, _ = S.resolve_auto(snaps)
        res_b = parallel_cli(torch, tmp, "preempt_b", (raw,)
                             + PREEMPT_PAR_RUN, "--snapshots", snaps,
                             "--snapshot", "auto:" + snaps,
                             "--export-inference",
                             os.path.join(tmp, "b_archive"))
        runs.append(res_b)
        finish_cli(run_a, "parallel_preempt run A")
        with open(a_json) as f:
            res_a = json.load(f)
        runs.append(res_a)
        a = archive_arrays(os.path.join(tmp, "a_archive"))
        b = archive_arrays(os.path.join(tmp, "b_archive"))
        unequal = sorted(k for k in a if not numpy.array_equal(a[k], b[k]))
        ckpt_bytes = os.path.getsize(os.path.join(snaps, name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "parallel_preempt", "card": card_line(),
           "transport": PARALLEL_TRANSPORT,
           "preempted_at_step": 4 + PREEMPT_B_AFTER,
           "seconds_sigterm_to_exit_75": signal_to_exit,
           "current_checkpoints": len(current),
           "checkpoint": name, "checkpoint_bytes": ckpt_bytes,
           "checkpoint_epoch": int(tree["decision"]["epoch_number"]),
           "tensors": len(a), "unequal_tensors": unequal,
           "history_equal": res_a["history"] == res_b["history"],
           "stop_flag_all_reduces": res_a["parallel"].get(
               "stop_flag_all_reduces"),
           "stop_flag_seconds": res_a["parallel"].get("stop_flag_seconds"),
           "seconds": time.perf_counter() - t0}
    emit(row)
    if len(current) != 1 or name != current[0] or unequal \
            or not row["history_equal"] or not a:
        fail("parallel_preempt: %s" % row)
    return add_counts(*[rank_counts(l) for res in runs
                        for l in res["parallel"]["launches_by_rank"]])


def one_process_decode(torch, archive, overrides, prompt, n,
                       temperature=0.0):
    """The decode of ``n`` tokens after ``prompt`` (greedy, or sampled at
    ``temperature`` as the CLI samples) by one process on the card from
    the inference archive ``archive`` of the LM of ``overrides``. -> the
    tokens."""
    import numpy
    from veles_torch.config import root
    from veles_torch.znicz.generate import generate
    wf = build_lm(*[o for o in overrides
                    if not o.startswith("root.lm.parallel.")],
                  device=PARALLEL_DEVICE)
    root.common.engine.amp = root.common.engine.compute_dtype = None
    dev = wf.device.device
    for unit in wf.forwards:
        for key in unit.export_params():
            path = os.path.join(archive, "%s_%s.npy" % (
                unit.name.replace("/", "_"), key))
            setattr(unit, key, torch.as_tensor(numpy.load(path)).to(dev))
    ids = numpy.array([[int(t) for t in prompt.split(",")]], numpy.int32)
    return [int(t) for t in generate(wf, ids, n,
                                     temperature=temperature)[0].tolist()]


@contextlib.contextmanager
def stdout_to(path):
    """File descriptor 1 of this process, and so of the ranks it spawns,
    sent to ``path`` for the block."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield path
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def par_cli(tmp, tag, args):
    """``python -m veles_torch`` with ``args`` in this process (the CLI
    spawns its ranks), its standard output, its ranks' included, kept;
    -> (exit code, that output). The engine's dtype policy is cleared
    after."""
    from veles_torch.config import root
    path = os.path.join(tmp, tag + ".out")
    try:
        with stdout_to(path):
            code = cli_run(list(args))
    finally:
        root.common.engine.amp = root.common.engine.compute_dtype = None
    with open(path) as f:
        out = f.read()
    if code not in (0, None) and not hasattr(code, "step") \
            and not hasattr(code, "best_fitness") \
            and not hasattr(code, "workflows"):
        fail("parallel_cli %s: exit %s: %s" % (tag, code, out[-2000:]))
    return code, out


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def par_generate_start(tmp):
    """(1) the 110M under data=2 with --generate, started in a child. ->
    (the child, its archive, its result file)."""
    archive = os.path.join(tmp, "gen_archive")
    out_file = os.path.join(tmp, "gen.json")
    return start_cli(tmp, "generate", [
        LM_SAMPLE, *PAR_GEN_RUN, "--seed", "1337", *par_device_args(),
        "--no-stats", "--export-inference", archive, "--generate",
        PAR_GEN_PROMPT, "--gen-tokens", str(PAR_GEN_TOKENS),
        "--gen-temperature", str(PAR_GEN_TEMPERATURE),
        "--result-file", out_file]), archive, out_file


def par_generate_finish(torch, started):
    """(1)'s tokens against one process's decode of the gathered archive.
    -> (row, the ranks' launches)."""
    child, archive, out_file = started
    out, seconds = finish_cli(child, "parallel_cli generate")
    lines = [l for l in out.splitlines() if l.startswith("generated: ")]
    got = [int(t) for t in lines[0][len("generated: "):].split(",")] \
        if len(lines) == 1 else None
    with open(out_file) as f:
        res = json.load(f)
    want = one_process_decode(torch, archive, PAR_GEN_RUN, PAR_GEN_PROMPT,
                              PAR_GEN_TOKENS, PAR_GEN_TEMPERATURE)
    row = {"part": "generate", "temperature": PAR_GEN_TEMPERATURE,
           "tokens": got, "one_process": want,
           "seconds": seconds, "train_steps": res["parallel"]["train_steps"],
           "step_ms": parallel_rows(res)}
    if got != want or res["parallel"]["mesh"] != {"data": 2} \
            or len(set(want)) < PAR_GEN_DISTINCT:
        fail("parallel_cli generate: %s" % row)
    return row, add_counts(*[rank_counts(l) for l in
                             res["parallel"]["launches_by_rank"]])


#: (2)'s two modes: (name, the CLI's arguments past the sample)
PAR_SEARCH_MODES = (("ensemble", ("--ensemble", "2")),
                    ("optimize", ("TUNE", "--optimize", "1x2")))


def par_search(torch, tmp):
    """(2) --ensemble 2 and --optimize 1x2 of the LM sample under data=2
    (children, side by side) and in one process (here, meanwhile). ->
    the row."""
    tune = os.path.join(tmp, "tune.py")
    with open(tune, "w") as f:
        f.write(PAR_TUNE)
    modes = [(mode, tuple(tune if a == "TUNE" else a for a in args))
             for mode, args in PAR_SEARCH_MODES]

    def line(args, result, axes=()):
        return [LM_SAMPLE, *args, *PAR_LM_SAMPLE, *axes, "--seed", "1337",
                *par_device_args(), "--no-stats", "--result-file", result]
    children = {mode: start_cli(tmp, mode + "_data2", line(
        args, os.path.join(tmp, mode + "_data2.json"),
        ("root.lm.parallel.data=2",))) for mode, args in modes}
    reports = {}
    for mode, args in modes:
        t0 = time.perf_counter()
        result = os.path.join(tmp, mode + "_one.json")
        par_cli(tmp, mode + "_one", line(args, result))
        with open(result) as f:
            reports[mode] = {"one": dict(json.load(f),
                                         seconds=time.perf_counter() - t0)}
    row = {"part": "search"}
    for mode, _ in modes:
        _, seconds = finish_cli(children[mode], "parallel_cli " + mode)
        with open(os.path.join(tmp, mode + "_data2.json")) as f:
            reports[mode]["data2"] = dict(json.load(f), seconds=seconds)
        row[mode] = reports[mode]
        got, want = reports[mode]["data2"], reports[mode]["one"]
        if mode == "ensemble":
            diff = max(abs(a - b) for a, b in zip(
                got["member_errors"] + [got["ensemble_error"]],
                want["member_errors"] + [want["ensemble_error"]]))
            ok = got["ensemble_error"] <= max(got["member_errors"]) \
                and got["n_valid"] == want["n_valid"]
        else:
            diff = abs(got["best_fitness"] - want["best_fitness"])
            ok = got["best_values"] == want["best_values"] \
                and got["evaluations"] == want["evaluations"]
        row[mode + "_max_abs_diff"] = diff
        bar = PAR_CLI_ERROR_ATOL if mode == "ensemble" \
            else PARALLEL_LOSS_RTOL * abs(want["best_fitness"])
        if not ok or not diff <= bar:
            fail("parallel_cli %s: %s" % (mode, reports[mode]))
    return row


def start_master(tmp, tag):
    """A host master of the LM sample (its own process: no ranks, no
    CUDA) on a free port. -> (the child, its address, its archive)."""
    from veles_torch.znicz import parallel
    archive = os.path.join(tmp, "master_%s" % tag)
    port = parallel.free_port()
    child = start_cli(tmp, "master_" + tag, [
        LM_SAMPLE, *PAR_SLAVE_RUN, "root.lm.parallel.data=2", "--seed",
        "1337", "--listen-address", "127.0.0.1:%d" % port,
        "--export-inference", archive, "--no-stats"])
    return child, "127.0.0.1:%d" % port, archive


def par_slave(torch, tmp):
    """(3) a host master with a slave of 2 ranks (children, side by side)
    and a master with a one-process slave (the slave here, meanwhile):
    the masters' archives. -> the row."""
    import numpy
    row = {"part": "slave"}
    masters = {tag: start_master(tmp, tag) for tag in ("data2", "one")}

    def slave_line(tag, axes=()):
        return [LM_SAMPLE, *PAR_SLAVE_RUN, *axes, "--seed", "1337",
                *par_device_args(), "--master-address", masters[tag][1],
                "--slave-retries", "60", "--no-stats"]
    slave_dp = start_cli(tmp, "slave_data2", slave_line(
        "data2", ("root.lm.parallel.data=2",)))
    t0 = time.perf_counter()
    _, out = par_cli(tmp, "slave_one", slave_line("one"))
    slaves = {"one": (last_json(out), time.perf_counter() - t0)}
    out, seconds = finish_cli(slave_dp, "parallel_cli slave of 2 ranks")
    slaves["data2"] = (last_json(out), seconds)
    archives = {}
    for tag, (child, _, archive) in masters.items():
        text, _ = finish_cli(child, "parallel_cli master " + tag, 300)
        slave, seconds = slaves[tag]
        row[tag] = {"jobs": slave["slave"]["jobs"], "seconds": seconds,
                    "master_cuda_initialized":
                        last_json(text)["cuda_initialized"],
                    "slave_parallel": "parallel" in slave}
        archives[tag] = archive_arrays(archive)
    got, want = archives["data2"], archives["one"]
    worst = max(float(numpy.abs(got[k] - w).max()
                      / max(float(numpy.abs(w).max()), 1e-30))
                for k, w in want.items())
    row["weights_max_rel_err"] = worst
    if sorted(got) != sorted(want) or not worst <= PAR_SLAVE_ATOL \
            or row["data2"]["jobs"] != row["one"]["jobs"] \
            or row["data2"]["master_cuda_initialized"] \
            or not row["data2"]["slave_parallel"]:
        fail("parallel_cli slave: %s" % row)
    return row


def check_parallel_cli(torch):
    """Phase parallel_cli: (1) --generate under data=2, (2) --ensemble and
    --optimize under data=2, (3) a host master with a 2-rank slave; the
    runs under data=2 in child processes side by side with (1), and the
    one-process runs here. -> the launches of (1)'s ranks (from its
    result line) and of this process (the one-process decode, searches
    and slave); the other children print no launch counts."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_cli_")
    t0 = time.perf_counter()
    reset_counts()
    try:
        generate = par_generate_start(tmp)
        search = par_search(torch, tmp)
        row, counts = par_generate_finish(torch, generate)
        emit(dict(row, phase="parallel_cli", card=card_line()))
        emit(dict(search, phase="parallel_cli", card=card_line()))
        emit(dict(par_slave(torch, tmp), phase="parallel_cli",
                  card=card_line()))
        par_sync(torch)
        counts = add_counts(counts, read_counts())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "parallel_cli", "part": "total",
          "seconds": time.perf_counter() - t0, "launches": counts})
    return counts


def fixture_digests():
    with open(os.path.join(JPEG_FIXTURES, "digests.json")) as f:
        return json.load(f)["files"]


def check_fixtures():
    """Every committed fixture decoded by the native routines, and all
    but the tree images (JPEG_TWIN_TREE aside) by their twins: the JPEG
    coefficients (a lossless frame's samples) and the PNG rows equal, the
    pixels (RGB and L, and their 256x256 bilinear resizes) hashing to
    Pillow's digests. -> (files checked, mismatches, files the twins
    decoded)."""
    import hashlib
    import numpy
    from veles_torch.loader import codecs, jpeg
    bad = []
    twinned = 0
    digests = fixture_digests()
    for name, want in sorted(digests.items()):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        twin = "tree_" not in name or name == JPEG_TWIN_TREE
        twinned += twin
        if name.endswith(".jpg") and twin:
            frame = jpeg.parse(data, name)
            native = jpeg.entropy_decode(frame, True)[0]
            if not numpy.array_equal(native,
                                     jpeg.entropy_decode(frame, False)[0]):
                bad.append((name, "entropy decode"))
        for native in (True, False) if twin else (True,):
            pixels, mode = codecs.decode(data, name, native)
            for space, key in (("RGB", "RGB"), ("GRAY", "L")):
                col = codecs.to_color(pixels, mode, space)
                for tag, arr in ((key, col), (key + "_256", codecs.resize(
                        col, (256, 256)))):
                    got = hashlib.sha256(numpy.ascontiguousarray(
                        arr).tobytes()).hexdigest()
                    if got != want[tag]:
                        bad.append((name, native, tag))
    return len(digests), bad, twinned


def jpeg_decode_ms():
    """Host ms to decode, convert and resize (256x256) one image of each
    timed kind, by the native routines and by the twins (one thread)."""
    from veles_torch.loader import codecs
    out = {}
    for kind, name in JPEG_TIMED_FILES.items():
        path = os.path.join(JPEG_FIXTURES, name)
        for native in (True, False):
            n = JPEG_TIMED if native else 2
            codecs.load(path, "RGB", (256, 256), native)
            t0 = time.perf_counter()
            for _ in range(n):
                codecs.load(path, "RGB", (256, 256), native)
            out["%s_%s_ms" % (kind, "native" if native else "twin")] = \
                1e3 * (time.perf_counter() - t0) / n
    return out


def write_jpeg_tree(base, codings=JPEG_TREE_CODINGS):
    """16 class directories, each JPEG_COPIES copies of its fixture, coded
    as ``codings`` name in turn (by default the Huffman-coded and the
    arithmetic-coded file), named as an ImageNet staging names them
    (``<class>_<n>.JPEG``)."""
    for k in range(TREE_CLASSES):
        d = os.path.join(base, "n%08d" % k)
        os.makedirs(d)
        for j in range(JPEG_COPIES):
            src = os.path.join(JPEG_FIXTURES, "%stree_%02d.jpg" % (
                JPEG_TREE_PREFIX[codings[j % len(codings)]], k))
            shutil.copyfile(src, os.path.join(d, "n%08d_%d.JPEG" % (k, j)))


def check_image_jpeg(torch, codings=JPEG_TREE_CODINGS):
    """Phase image_jpeg: the fixtures, the decode rates, then AlexNet at
    full width streamed 2 epochs from the JPEG tree written in
    ``codings`` (:func:`write_jpeg_tree`); -> its launches."""
    import tempfile
    from veles_torch.config import root
    from veles_torch.loader import codecs, jpeg
    t0 = time.perf_counter()
    files, bad, twinned = check_fixtures()
    rates = jpeg_decode_ms()
    tmp = tempfile.mkdtemp(prefix="jpeg_tree_", dir=OUT_DIR)
    saved = root.imagenet.loader.to_dict()
    try:
        write_jpeg_tree(os.path.join(tmp, "tree"), codings)
        before = dict(jpeg.scans), dict(codecs.unfilters)
        reset_counts()
        wf = cli_run([IMAGENET_SAMPLE, "root.imagenet.loader.base_dir=%s"
                      % os.path.join(tmp, "tree"), *JPEG_RUN,
                      "-d", STREAM_DEVICE])
        stream_sync(torch)
        counts = read_counts()
        scans = {k: jpeg.scans[k] - before[0][k] for k in jpeg.scans}
    finally:
        root.imagenet.loader.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    loader, step = wf.loader, wf.step
    train = step.train_steps
    losses = [h["train"]["loss"] for h in wf.decision.history]
    # an epoch validates before it trains: the first is the untrained
    # model's loss, the second the loss after one epoch's training
    valid_losses = [h["validation"]["loss"] for h in wf.decision.history]
    images = sum(loader.class_lengths)
    warm = step.epoch_seconds[1]
    ok, want = conv_launches_ok(counts, train, 7)
    row = {"phase": "image_jpeg", "card": card_line(), "fixtures": files,
           "fixtures_twinned": twinned, "fixture_mismatches": bad,
           "decode": rates,
           "class_lengths": loader.class_lengths,
           "n_classes": loader.n_classes, "train_steps": train,
           "launches": counts, "learning_rate": JPEG_LR,
           "train_loss": losses, "validation_loss": valid_losses,
           "validation_error": [h["validation"]["metric"]
                                for h in wf.decision.history],
           "native_decode": loader.native_decode,
           "tree_codings": list(codings), "scans": scans,
           "epoch_seconds": step.epoch_seconds,
           "images_per_sec_warm_epoch": images / warm,
           "stream_wait_seconds": dict(step.stream_wait_seconds),
           "seconds": time.perf_counter() - t0}
    emit(row)
    if bad:
        fail("image_jpeg: fixtures differ from their twins or Pillow: %s"
             % bad[:10])
    if not loader.native_decode or scans["python"] \
            or not all(scans["native_" + c] for c in codings):
        fail("image_jpeg: the run's scans %s (native decode %s)"
             % (scans, loader.native_decode))
    if loader.n_classes != TREE_CLASSES or not ok:
        fail("image_jpeg: %d classes, launches %s, expected %s"
             % (loader.n_classes, counts, want))
    if not all(math.isfinite(v) for v in losses + valid_losses) \
            or not losses[-1] < losses[0] \
            or not valid_losses[-1] < valid_losses[0]:
        fail("image_jpeg: train losses %s, validation losses %s"
             % (losses, valid_losses))
    return counts


# -- capture purity: the unit bodies a CUDA graph will capture ------------

#: phase capture_purity's device (the CPU only to rehearse it)
CAPTURE_DEVICE = "cuda"
#: (b) MNIST at the sample's config (minibatch 100: a masked and an
#: identity bias gradient a train step); (c) the 110M widths at 2 layers
#: (S 512, minibatch 8, the card's bf16 policy, momentum, the auto
#: attention policy: the flash forward and fused backward, the identity
#: bias gradient)
CAPTURE_LM = LM_110M + ("root.lm.model.layers=2",)
#: the lint subprocess's time limit, seconds
CAPTURE_LINT_S = 300


def capture_lint():
    """(a) Start ``python -m veles_torch lint --select tracer-purity
    --format json veles_torch`` in a subprocess (it runs on the host
    while (b) and (c) run the card); -> a function that waits for it,
    checks exit 0 and ``[]`` and returns its seconds (``check=False``:
    stops it instead)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_torch", "lint", "--select",
         "tracer-purity", "--format", "json", "veles_torch"],
        cwd=HERE, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def finish(check=True):
        try:
            out, err = proc.communicate(
                timeout=CAPTURE_LINT_S if check else 0.1)
        except subprocess.TimeoutExpired:
            if check:
                raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if not check:
            return None
        if proc.returncode != 0 or json.loads(out or "null") != []:
            fail("capture_purity: the lint exited %d with %r (stderr %r)"
                 % (proc.returncode, out[-2000:], err[-2000:]))
        return time.perf_counter() - t0

    return finish


def capture_scope():
    """tracer-purity's scope over this checkout's ``veles_torch``:
    {repo-relative path: [(first line, last line, name)]}."""
    from veles_torch.analysis import core, rules_purity
    project = core.build_project([os.path.join(HERE, "veles_torch")],
                                 base=HERE)
    scope = {}
    for path, first, last, name in rules_purity.traced_functions(project):
        scope.setdefault(path, []).append((first, last, name))
    return scope


def sync_sites(torch, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``
    (restored after); -> one (path, line, stack) per synchronizing call:
    the innermost frame of the port (``veles_torch``) on the warning's
    stack, its path relative to the checkout (the innermost frame of all
    when no frame is the port's), and the stack's last frames."""
    import traceback
    import warnings
    port = os.path.join(HERE, "veles_torch") + os.sep
    sites = []
    #: only while ``fn`` runs: switching the mode warns of itself
    running = [False]

    def record(message, category, filename, lineno, file=None, line=None):
        if not running[0] or "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.startswith(os.path.dirname(
                     warnings.__file__) + os.sep + "warnings")]
        mine = [f for f in stack
                if os.path.abspath(f.filename).startswith(port)]
        where = (mine or stack)[-1]
        path = os.path.abspath(where.filename)
        if path.startswith(HERE + os.sep):
            path = os.path.relpath(path, HERE)
        sites.append((path, where.lineno, [
            "%s:%d %s" % (os.path.relpath(f.filename, HERE)
                          if os.path.abspath(f.filename).startswith(
                              HERE + os.sep) else f.filename,
                          f.lineno, f.name) for f in stack[-6:]]))

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        try:
            torch.cuda.set_sync_debug_mode("warn")
            running[0] = True
            fn()
        finally:
            running[0] = False
            torch.cuda.set_sync_debug_mode(prev)
    return sites


def in_scope(scope, site):
    """The scoped function that holds ``site`` (path, line), or None."""
    path, line = site
    return next((name for first, last, name in scope.get(path, ())
                 if first <= line <= last), None)


def capture_batches(torch, wf):
    """The first train and the first validation minibatch of ``wf`` as
    the step's loop hands them over: (data, target, 0-d device valid)."""
    from veles_torch.loader.base import CLASS_TRAIN, CLASS_VALID
    dev = wf.device.device
    full = wf.loader.device_full_arrays(dev)
    out = []
    for cls, train in ((CLASS_TRAIN, True), (CLASS_VALID, False)):
        idx_mat, valids = wf.loader.class_schedule(cls)
        idx = torch.as_tensor(idx_mat[0], dtype=torch.int64, device=dev)
        out.append((*wf.step.gather(full, idx, train),
                    torch.as_tensor(valids).to(dev)[0]))
    return out


def capture_run(torch, wf, scope):
    """One warm train minibatch, then a train minibatch on a step that
    takes no layer stats and an eval minibatch, each under the sync
    warnings; -> (the row: sites in and out of scope by minibatch, the
    launches of the three minibatches)."""
    step = wf.step
    (train, evaluate) = capture_batches(torch, wf)
    sync_capture(torch)
    reset_counts()
    step.train_minibatch(*train)
    while step.stats_due():
        step.train_minibatch(*train)
    sync_capture(torch)
    warm = step.train_steps
    sites = {"train": sync_sites(torch,
                                 lambda: step.train_minibatch(*train)),
             "eval": sync_sites(torch,
                                lambda: step.eval_minibatch(*evaluate))}
    sync_capture(torch)
    counts = read_counts()
    row = {"train_steps": step.train_steps, "warm_steps": warm,
           "launches": counts, "inside": {}, "outside": {}}
    row["stacks"] = {}
    for kind, found in sites.items():
        row["inside"][kind] = sorted({"%s:%d %s" % (p, n, in_scope(scope,
                                                                  (p, n)))
                                      for p, n, _ in found
                                      if in_scope(scope, (p, n))})
        row["outside"][kind] = sorted({"%s:%d" % (p, n)
                                       for p, n, _ in found
                                       if not in_scope(scope, (p, n))})
        for p, n, stack in found:
            row["stacks"].setdefault("%s:%d" % (p, n), stack)
    return row, counts


def sync_capture(torch):
    if CAPTURE_DEVICE == "cuda":
        torch.cuda.synchronize()


def capture_models(torch, scope):
    """(b) and (c), after a control (one ``.item()`` must raise one sync
    warning); -> (MNIST's row, launches and expected launches, the same
    of the 110M, its attention mode)."""
    from veles_torch import prng
    from veles_torch.znicz.models import mnist
    # the control: a sync the warnings must see
    control = sync_sites(torch, lambda: torch.ones(
        1, device=CAPTURE_DEVICE).item()) if CAPTURE_DEVICE == "cuda" \
        else [None]
    if len(control) != 1:
        fail("capture_purity: one .item() gave %d sync warnings"
             % len(control))
    prng.seed_all(1337)
    wf = mnist.create_workflow(name="MnistCapture")
    wf.initialize(device=CAPTURE_DEVICE)
    mnist_row, mnist_counts = capture_run(torch, wf, scope)
    del wf
    n = mnist_row["train_steps"]
    want_mnist = dict(dict.fromkeys(mnist_counts, 0), **{
        "bias_grad[identity]": n, "bias_grad[masked]": n})
    wf = build_lm(*CAPTURE_LM, device=CAPTURE_DEVICE, name="LMCapture")
    lm_row, lm_counts = capture_run(torch, wf, scope)
    want_lm, mode = lm_expected_counts(wf, CAPTURE_DEVICE)
    del wf
    return (mnist_row, mnist_counts, want_mnist, lm_row, lm_counts,
            want_lm, mode)


def check_capture_purity(torch):
    """Phase capture_purity: (a) the lint of tracer-purity on the card's
    Python; (b) MNIST and (c) the 110M at 2 layers, a train minibatch off
    the stats cadence and an eval minibatch under the sync warnings: no
    synchronizing call inside tracer-purity's scope; -> the launches of
    (b) and (c) together."""
    t0 = time.perf_counter()
    lint = capture_lint()
    try:
        scope = capture_scope()
        mnist_row, mnist_counts, want_mnist, lm_row, lm_counts, want_lm, \
            mode = capture_models(torch, scope)
    except BaseException:
        lint(check=False)
        raise
    lint_s = lint()
    row = {"phase": "capture_purity", "card": card_line(),
           "lint_seconds": lint_s,
           "scope_functions": sum(len(v) for v in scope.values()),
           "mnist": mnist_row, "lm_110m_2l": lm_row}
    for name, sub in (("mnist", mnist_row), ("lm_110m_2l", lm_row)):
        for kind, sites in sub["outside"].items():
            for site in sites:
                print("capture_purity: %s %s sync outside the scope: %s"
                      % (name, kind, site), flush=True)
    if CAPTURE_DEVICE == "cpu":
        want_mnist = dict.fromkeys(want_mnist, 0)
    row["attention_mode"] = mode
    if mnist_counts != want_mnist or lm_counts != want_lm \
            or mode != ("pallas" if CAPTURE_DEVICE == "cuda" else "scan"):
        row["expected"] = {"mnist": want_mnist, "lm_110m_2l": want_lm}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    inside = {name: sub["inside"] for name, sub in
              (("mnist", mnist_row), ("lm_110m_2l", lm_row))
              if any(sub["inside"].values())}
    if inside:
        fail("capture_purity: synchronizing calls inside tracer-purity's "
             "scope: %s" % inside)
    if "expected" in row:
        fail("capture_purity: attention %s, launches %s, expected %s" % (
            mode, {"mnist": mnist_counts, "lm_110m_2l": lm_counts},
            row["expected"]))
    return {k: mnist_counts[k] + lm_counts[k] for k in mnist_counts}


#: the phases that run beside the first process's, each tuple in a process
#: of its own (its phases in order), all started once the kernels are
#: timed. They drive their paths through child processes and ranks that
#: wait on the host more than they keep the card busy, and the card holds
#: them all at once; one after another they took the script to 967-1309 s
#: of its 1200 s limit on a fast host and past it on a slower one. Each
#: side process counts its own launches; the numbers its phases print are
#: taken with the other processes on the card
SIDE_GROUPS = (("parallel", "parallel_ep_pp"),
               ("distributed", "parallel_preempt", "parallel_cli"),
               ("resume", "image_stream", "continual", "image_jpeg",
                "parallel_unsupervised"))
#: each side phase: torch -> {path: launches}
SIDE_PHASES = {
    "resume": lambda torch: {"resume": check_resume(torch)},
    "image_stream": lambda torch: {"image_stream": check_image_stream(torch)},
    "continual": lambda torch: {"continual": check_continual(torch)},
    "image_jpeg": lambda torch: {"image_jpeg": check_image_jpeg(torch)},
    "distributed": lambda torch: {"distributed": check_distributed(torch)},
    "parallel": lambda torch: {"parallel": check_parallel(torch)},
    "parallel_ep_pp": lambda torch: {
        "parallel_ep_pp": check_parallel_ep_pp(torch)},
    "parallel_unsupervised": lambda torch: {
        "parallel_unsupervised": check_parallel_unsupervised(torch)},
    "parallel_preempt": lambda torch: {
        "parallel_preempt": check_parallel_preempt(torch)},
    "parallel_cli": lambda torch: {"parallel_cli": check_parallel_cli(torch)},
}
#: a side process's command (``python -c``; its arguments name the phases)
SIDE_MAIN = "import sys, chip_smoke as C; sys.exit(C.run_side(sys.argv[1:]))"
#: the seconds since the script started by which every side process must
#: have ended
SIDE_DEADLINE = 1150
#: each side process's OpenMP threads (8 a process on the 8 cores would
#: spin against each other)
SIDE_THREADS = 2


def run_side(names):
    """A side process: each phase of ``names`` in order, on the kernels the
    first process built; its last line ``{"side_paths": {path:
    launches}}``."""
    import signal
    import torch
    from veles_torch import kernels
    # a SIGTERM from the first process unwinds the phases, whose cleanup
    # stops their children
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    kernels.build()
    paths = {}
    for name in names:
        print("side phase %s starting at %.1f s"
              % (name, time.monotonic() - STARTED), flush=True)
        paths.update(SIDE_PHASES[name](torch))
    print(json.dumps({"side_paths": paths}), flush=True)
    return 0


def start_sides():
    """Starts a process for each of SIDE_GROUPS, its stdout to a file;
    -> [(names, process, stdout file)]."""
    env = dict(child_env(), CHIP_SMOKE_STARTED=repr(STARTED),
               OMP_NUM_THREADS=str(SIDE_THREADS))
    sides = []
    try:
        for i, names in enumerate(SIDE_GROUPS):
            out = open(os.path.join(OUT_DIR, "side%d.out" % i), "w+")
            try:
                proc = subprocess.Popen(
                    [sys.executable, "-c", SIDE_MAIN, *names], cwd=HERE,
                    env=env, stdout=out)
            except BaseException:
                out.close()
                raise
            sides.append((names, proc, out))
    except BaseException:
        stop_sides(sides)
        raise
    return sides


#: seconds a side process has to stop its children after a SIGTERM
SIDE_STOP_S = 60


def stop_sides(sides):
    """Stops every side process still running: a SIGTERM (its phases stop
    their children), then SIGKILL after SIDE_STOP_S."""
    for _, proc, _ in sides:
        if proc.poll() is None:
            proc.terminate()
    for _, proc, out in sides:
        try:
            proc.wait(timeout=SIDE_STOP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        out.close()


def finish_sides(sides):
    """Waits for every side process, relays its stdout but the last line;
    -> {path: launches} of all their phases. Fails if one exits non-zero,
    prints no result or outlasts SIDE_DEADLINE."""
    paths = {}
    for names, proc, out in sides:
        try:
            rc = proc.wait(timeout=max(
                1.0, SIDE_DEADLINE - (time.monotonic() - STARTED)))
        except subprocess.TimeoutExpired:
            fail("side phases %s still running %d s after the start"
                 % (", ".join(names), SIDE_DEADLINE))
        out.seek(0)
        lines = out.read().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if rc or not lines or not lines[-1].startswith('{"side_paths"'):
            fail("side phases %s exited %d: %s" % (
                ", ".join(names), rc, "\n".join(lines[-5:])))
        paths.update(json.loads(lines[-1])["side_paths"])
    return paths


def main(argv=None):
    import torch
    if (sys.argv[1:] if argv is None else argv):
        print("usage: chip_smoke.py (no arguments)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from veles_torch import kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    open(LOG_PATH, "w").close()

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = kernels.build()
    for name, log in kernels.build_logs.items():
        with open(os.path.join(OUT_DIR, "nvcc_%s.log" % name), "w") as f:
            f.write(log)
    sass = {lib: sass_counts(kernels, lib) for lib in SM90_LIBRARIES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": built, "sources": kernels.sources(),
          "ptxas": {name: ptxas_report(log)
                    for name, log in kernels.build_logs.items()},
          "sass": sass})
    for lib, counts in sass.items():
        if counts is None:
            continue
        short = {fn: n for fn, n in counts.items()
                 if not all(n[op] for op in SM90_OPCODES)}
        if not counts or short:
            fail("%s: kernels without %s: %s" % (
                lib, " and ".join(SM90_OPCODES), short or counts))

    timer = Timer(torch)
    forms = check_kernels(torch, timer)
    flash_err = check_flash(torch)
    flash_rows = time_flash(torch, timer)
    sides = start_sides()
    try:
        launches = check_mnist_path(torch)
        lm_launches = check_lm(torch)
        cifar = check_cifar(torch)
        check_alexnet_parity(torch)
        alexnet = check_alexnet(torch)
        ae = {phase: check_ae(torch, phase, sample, seed)
              for phase, sample, seed in AE_RUNS}
        check_ae_units(torch)
        serving = {"serve_predict": check_serve_predict(torch),
                   "serve_decode": check_serve_decode(torch)}
        lm_slice = check_lm_slice(torch)
        health = check_model_health(torch)
        unsupervised = check_unsupervised(torch)
        plots = check_plots(torch)
        serve_http = check_serve_http(torch)
        search = check_search_slice(torch)
        profiling = check_profiling(torch)
        capture_purity = check_capture_purity(torch)
        side_paths = finish_sides(sides)
    finally:
        stop_sides(sides)
    paths = {**ae, **serving, **lm_slice, "model_health": health,
             "unsupervised": unsupervised, "plots": plots,
             "serve_http": serve_http, **search, "profiling": profiling,
             "capture_purity": capture_purity, **side_paths}
    by_path = {form: {"mnist": launches[form],
                      "cifar": cifar["bias_grad[%s]" % form],
                      "alexnet": alexnet["bias_grad[%s]" % form],
                      **{path: counts["bias_grad[%s]" % form]
                         for path, counts in paths.items()}}
               for form, _, _, _ in FORMS}

    emit({"kernels": [{
        "name": "bias_grad[%s]" % form,
        "route": "cuda",
        "source": "veles_torch/csrc/bias_grad.cu",
        "replaces": replaces,
        "launches": sum(by_path[form].values()),
        "launches_by_path": by_path[form],
        "max_abs_err": forms[form]["max_abs_err"],
        "ms": forms[form]["kernel_ms"],
        "plain_ms": forms[form]["plain_ms"],
        "bound_ms": forms[form]["bound_ms"],
        "bound_by": forms[form]["bound_by"],
        "library_ms": forms[form]["library_ms"],
    } for form, _, _, replaces in FORMS] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": lm_launches[name],
        "launches_by_path": {"lm": lm_launches[name],
                             **{path: counts[name] for path, counts in
                                paths.items()}},
        "max_abs_err": flash_err[name],
        **flash_rows[name],
    } for name, source, replaces in FLASH_KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def check_mnist_path(torch):
    """Phases mnist and profile; -> bias_grad launches by form on the
    MNIST path."""
    from veles_torch.znicz.ops.bias_grad import bias_grad
    cpu_wf = run_mnist(torch, "cpu")
    err_cpu = check_mnist(torch, cpu_wf, "cpu")
    reset_counts()
    wf = run_mnist(torch, "cuda")
    torch.cuda.synchronize()
    TRAINED["mnist"] = wf
    launches = dict(bias_grad.form_launches, total=bias_grad.launches)
    err_cuda = check_mnist(torch, wf, "cuda")
    steps = wf.step.train_steps
    if launches["total"] != 2 * steps or launches["identity"] != steps \
            or launches["masked"] != steps:
        fail("bias_grad launched %s times for %d train steps"
             % (launches, steps))
    if not err_cuda < 0.15 or abs(err_cuda - err_cpu) > 0.02:
        fail("final validation error %.4f on cuda vs %.4f on cpu"
             % (err_cuda, err_cpu))
    # the first epoch carries one-off costs (uploads, kernel load)
    per_epoch = steps / len(wf.step.epoch_seconds)
    warm = wf.step.epoch_seconds[1:]
    emit({"phase": "mnist", "train_steps": steps,
          "bias_grad_launches": launches,
          "train_steps_per_sec": per_epoch * len(warm) / sum(warm),
          "epoch_seconds": wf.step.epoch_seconds,
          "final_valid_error_cuda": err_cuda,
          "final_valid_error_cpu": err_cpu,
          "history_cuda": wf.decision.history})
    emit(profile_epoch(torch))
    return launches


if __name__ == "__main__":
    sys.exit(main())
