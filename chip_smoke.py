#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dist_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Drives the port's serving and training paths and the reference's MNIST
program end to end on the card and holds every kernel on them against its
plain PyTorch version. Phases:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi``); turn TF32 off for matmuls and cuDNN;
2. build: compile the five kernel sources of the checkout (one ``nvcc``
   per source, all at once), printing ptxas registers and spills, and the
   SASS mix (instructions, HMMA) of every flash kernel: each must hold
   HMMA (every product on the tensor cores);
3. forward kernel vs plain version on the card, fp32 and bf16 inputs,
   causal and not, at serving's 8 instances (each query tile's keys split
   over several blocks and merged) and at 264 (unsplit): O and lse against
   the plain version in fp32 at atol = rtol = 1e-4 (the summation order
   and ``exp`` differ); a bf16 O within 1e-4 + 2**-8 (|O_ref| + P_ref @
   |V|) (``bf16_limit``: the kernel rounds P to bf16 before P·V, as the TPU
   kernel does, and O to bf16); two calls give the same bits in both
   regimes;
4. serve the benchmark LM at full width (vocab 8192, d_model 512, depth 4,
   8 heads, 512 positions, fp32, random weights from seed 0): 16 seeded
   requests through ``ServeEngine``; every request must finish, the flash
   kernel must have launched ``depth x prefills`` times, each prefill's
   logits must match a re-run with the plain attention (atol 1e-3), and
   every generated token must be the full forward's greedy choice (a
   top-2 gap under 1e-4 counts as a certified tie);
5. the CLI (``python -m tpu_dist_torch.serve --bench``) at full width;
   its flash launches must be ``depth x`` the prefills it counted;
6. times at serving's shapes [8, L, 64] fp32 causal, L = 512 (the
   record's), 256 and 128 (the prefill pads): the wrapper (CUDA-event
   windows, host work included), its kernels' device time
   (``torch.profiler``), plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only, never used by the
   port; wrapper-style and device time), beside the kernel's lower bound
   on the card's fastest fp32-accurate route (3xTF32 on the tensor cores,
   165 TFLOP/s) and on the CUDA cores (67 TFLOP/s), and the split count;
7. backward kernels vs their plain version: dQ, dK, dV for L in {77, 128,
   200, 512, 1024} (512 is the TPU's one-tile case), D in {32, 64, 128},
   fp32 and bf16, causal and not (tolerances at ``assert_grads_close``);
8. fused Adam vs its plain version over the full-width LM's 21.3 M
   parameters for 5 updates at counts up to 10**6 (the kernel computes the
   bias correction from the count; rtol 1e-6: the same arithmetic in the
   same order);
9. train the benchmark LM at full width through ``make_train_function`` /
   ``train_state`` (``bench.py:63-68``, ``:101-106``, ``:120``: batch 64,
   L 512, SGD lr 0.001, the bench token stream), 3 steps: flash forward
   and backward launches must be depth x steps, every loss must match a
   twin with the same initial weights and the plain attention
   (``_dense_attention``) within ``LOSS_ATOL``, and the parameters must
   move, each leaf within ``PARAM_RTOL`` of its step plus ``PARAM_ATOL``
   of the twin's (SGD); then the same with ``Adam(fused=True)``, whose
   launches must be the steps, against a twin on ``Adam(fused=False)``,
   and which must build its leaf table once;
10. ``Model.fit((x, y), epochs=1, steps_per_epoch=4, verbose=0)`` at full
    width: a finite History loss and depth x 4 launches of each flash
    kernel;
11. at the training shape [64, 8, 512, 64] fp32 causal, the forward and
    backward kernels against their plain versions on the same inputs (the
    errors the kernel line reports), and a second forward and backward
    call that must give the same bits; then times at the training shapes,
    each beside its bound: the forward in fp32 and bf16 beside SDPA's
    forward (bounds: 3xTF32 operations; bytes for bf16); the backward there
    (kernels, each kernel alone, the delta kernel, plain version, SDPA's backward as fwd+bwd minus fwd, the
    kernels SDPA ran from one ``torch.profiler`` pass; bounds on the
    tensor cores, 3xTF32 at 165 TFLOP/s, and on the CUDA cores), the same
    backward in bf16 beside SDPA's bf16 backward (bound at 989 TFLOP/s),
    fused Adam at the LM's 21.3 M parameters and the CNN's 225 k (the
    whole call on a cached table, the kernel alone, ``Adam.update``, the
    plain version, ``torch.optim.Adam(fused=True).step()``, the table
    builds over the timed calls, and one update captured in a CUDA graph
    and replayed bit for bit with eager), and the full training step in ms
    and tokens/s. Library calls are yardsticks only, never used by the
    port;
12. fused cross-entropy kernels vs their plain version: loss, lse and
    dlogits at [64, 10], [37, 10] (ragged, some labels out of range),
    [2, 16, 64] (rank 3), [1000, 1000] and the LM's [32768, 8192], fp32
    and bf16: loss and lse within ``CE_TOL``, dlogits bit for bit;
13. fused SGD vs its plain version, plain / momentum 0.9 / Nesterov, over
    the full-width LM's 70 leaves and the CNN's 8, 3 steps (a float
    learning rate, then a schedule's values on the card): bit for bit;
14. the reference program, ``tpu_dist_torch.examples.tpu_dist_example`` as
    it stands (one worker, plain CE and SGD, 10 epochs x 20 steps at batch
    64): the loss must fall;
15. the same chain with the CNN compiled with
    ``SparseCategoricalCrossentropy(from_logits=True, fused=True)`` and
    ``SGD(learning_rate=0.001, fused=True)`` — this slice's main path: 200
    launches each of CE forward, CE backward and SGD, and per-epoch losses
    within ``CNN_LOSS_ATOL`` of a twin compiled without ``fused`` from the
    same weights and batches; then 2 x 20 steps with ``SGD(momentum=0.9,
    fused=True)`` against its twin, which launch the momentum kernel, and
    2 x 20 with an ``ExponentialDecay`` rate, which launch the kernel too;
    each run builds its optimizer's leaf table once;
16. the benchmark LM at full width through ``make_train_function`` with
    the fused CE and ``SGD(fused=True)``, 3 steps: 3 launches of each new
    kernel plus the flash launches, losses and per-leaf parameters against
    phase 9's plain twin under phase 9's rules, and one leaf table built;
17. times of the CE and SGD kernels at the LM's and the CNN's shapes
    (kernel, plain version, library yardstick, bound; for SGD, plain and
    momentum, the same set as phase 11's Adam, beside
    ``torch.optim.SGD(foreach=True).step()``), a device copy moving the
    plain SGD's bytes at the LM's size (the card's attainable rate), the LM
    train step with the fused CE + SGD beside phase 11's, and the CNN train
    step, fused and unfused in turns, in ms, images/s and device ms
    (``torch.profiler``);
18. paged serving at full width (phase 4's LM, 8 slots, ``page_size=16``,
    256 pages + scratch; the paged path computes dense attention as the
    reference's does, so it launches no flash kernel): (a) phase 4's 16
    requests through ``ServeEngine(paged=True)``: all finish, every token
    the full forward's greedy choice (``_certified``), the streams phase
    4's but at certified ties, 0 flash launches; (b) a warm request, then
    8 sharing its 256-token prefix with 16-64-token suffixes, prefix
    caching on and off: at least 8 hits, skipped tokens, equal streams but
    at certified ties; (c) (a)'s requests with ``prefill_chunk=64``, paged
    and contiguous: the unchunked streams but at certified ties, and
    ``serve.prefill.chunks`` = the sum of ceil(len / 64); (d) (a)'s
    requests on int8 pages: all finish; one prompt into an fp32 and an
    int8 pool, every written position's dequantized K/V within scale / 2
    (+ 1e-6 relative) of the rows quantized (layer 0's: the fp32 pool's),
    the worst equal to ``serve.kv.quant_error``'s maximum to 1e-6; (e) at
    the budget of the contiguous 8 x 512 cache, 48 short requests through
    ``max_batch=32`` paged peak at 16 or more concurrent, and a contiguous
    9-slot engine refuses the budget; (f) tok/s, TTFT and latency p50 of
    every run and the decode step at bucket 8, 448 positions (contiguous,
    fp32 pool, int8 pool; CUDA events and ``torch.profiler``); then
    ``python -m tpu_dist_torch.serve --bench --paged`` with and without
    ``--kv-dtype int8`` at phase 5's arguments;
19. serving on captured CUDA graphs (on CUDA every engine runs each
    program family as a captured program: the first call eager, the
    second captured, later ones replayed; phases 4, 5 and 18 run so too,
    their kernel counts holding because a replay adds the launches its
    capture recorded): (a) for each family (decode, prefill, prefill
    chunk; paged decode, ragged decode and paged prefill on fp32 and int8
    pools) a captured program against the eager ``kv_cache`` function on
    the same inputs over three calls: outputs and cache or pool bytes bit
    for bit (a pool's scratch row aside); (b) phase 4's 16 requests
    through ``ServeEngine(paged=True, ragged=True)``, fp32 and int8: the
    streams of phase 18's bucketed engines (fp32 under the certified-tie
    rule, int8 token for token), one decode program whose calls are the
    decode steps; (c) phase 18 (f)'s decode step through a captured
    program, CUDA events and device time, beside the eager numbers; (d)
    phase 18 (b)'s prefix run on engines warmed up first: TTFT p50 with
    hits against cold beside the reference's 0.5x (reported), capture
    seconds apart, and the device time of the step that admits the
    sharers (``torch.profiler``); (e) the flash forward at [8, L, 64], L = 512, 256, 128,
    through its wrapper, replayed from a captured program, and SDPA's
    call (ROADMAP K1);
20. training on captured graphs: (a) the reference program with
    ``steps_per_execution=20``, fused and unfused: per-epoch losses within
    ``CNN_LOSS_ATOL`` and parameters within ``GRAPH_PARAM_ATOL`` of phase
    15's k = 1 runs, 200 launches of each fused kernel; (b) the CNN step's
    time and device-busy share at k = 20 beside k = 1 (phase 17's
    measure); (c) the full-width LM at k = 2 for 2 executions with SGD
    and with ``Adam(fused=True)``: losses within ``LOSS_ATOL`` of k = 1's
    pair means, every kernel launch counted;
21. the input pipeline (``data/``): (a) the native loader built from
    ``csrc/loader.cpp`` with ``g++``; at 60,000 synthetic MNIST images its
    ``shuffled_indices``, ``gather_scale`` and ``gather_labels`` equal its
    numpy path bit for bit; (b) a ``DeviceDataset`` at seed 5, ``mul`` and
    ``div``, 2 epochs: every batch on the card equals the host chain's map
    of the same samples bit for bit, each epoch covers every sample once,
    the images stay uint8 on the card, an evaluation pass leaves the
    training order as it was; (c) the reference program as it stands: fit
    promotes its chain to a ``DeviceDataset`` (one upload), whose steps
    send the card only their index vectors (the host-to-device copies of
    a profiled epoch: none as large as an image), and the loss falls; then
    phase 15's fused compile on the promoted chain without a shuffle: 200
    launches each of CE forward, CE backward and SGD, losses within
    ``CNN_LOSS_ATOL`` and parameters within ``GRAPH_PARAM_ATOL`` of the
    same program fed from the host chain; (d) the same at
    ``steps_per_execution=20``: one captured program whose only input is
    the index vector, equal to (c) within the same tolerances, 200 launches
    each; (e) ``compile(prefetch_to_device=2)`` on the host chain: the
    losses of prefetch 0; (f) the host ms per batch of the element path,
    the vectorized paths and the prefetched path, the CNN fit step fused,
    host-fed and device-resident, at k = 1 and 20 (ms, images/s, device ms
    and busy share from ``torch.profiler``), and the upload's seconds at
    8,192 and 60,000 images;
22. bench.py's ResNets at full width and batch (``bench.py:59-60, 71-111,
    1045-1047``): ResNet-18 on Fashion-MNIST 28x28x1 and ResNet-50 on
    CIFAR-10 32x32x3 (the synthetic splits), global batch 256, SGD(0.001),
    random weights from seed 0; (a) ``fit`` 2 epochs x 4 steps on the
    reference chain without its shuffle (promoted to a ``DeviceDataset``),
    fused CE + SGD against an unfused twin from the same weights (cuDNN
    deterministic): losses, parameters and BatchNorm state within
    ``RESNET_*`` after the first step, and after 8 within
    ``RESNET_DRIFT`` times the drift of an unfused twin started one ulp
    off; 8 launches each of CE fwd, CE bwd and SGD; (b) the same
    at ``steps_per_execution`` 8 / 4 on a captured graph against (a); (c)
    ``evaluate`` and ``predict`` over 2,576 test images (a ragged last
    batch of 16): one captured eval program, equal to the eval forward
    batch by batch (the ragged one padded), and within ``PREDICT_RTOL`` of
    the forward of its 16 rows alone; then ``predict`` over the test chain
    without its ragged batch promoted to a ``DeviceDataset``: equal to the
    host chain's ``predict`` exactly, and the card sends the host no copy
    but the outputs; (d) ResNet-18 fit again under ``mixed_bfloat16``
    without recompiling, on the chain with its shuffle: a new captured
    program, bf16 into the first conv, finite losses, fp32 logits and
    BatchNorm state; (e) fused SGD at both leaf tables (phase 17's
    measures); (f) the train step at k = 1 and 8 / 4, fp32 and ResNet-18
    bf16: ms, images/s, device busy share, the top device kernels and
    operators and the layout work (SAME pads, copies, transposes;
    ``torch.profiler``), and the conv and Dense FLOPs' share of the card's
    fp32 CUDA-core (bf16 tensor) peak;
23. checkpoints, resumed fits and serving a saved model at full width
    (``training/checkpoint.py``, ``models/serialize.py``): (a) ResNet-18
    (phase 22's, batch 256, seed 0) with ``SGD(0.001, momentum=0.9,
    fused=True)`` and the fused CE on a promoted chain of exactly 4
    batches a pass without a shuffle: ``fit(checkpoint_dir=D, epochs=2)``
    on a fresh model, then ``fit(checkpoint_dir=D, epochs=4)`` on another,
    which must resume at epoch 2; epochs 3-4's losses, the parameters, the
    BatchNorm state and the velocity against an uninterrupted 4-epoch fit,
    bit for bit when two uninterrupted fits are bit for bit, else within
    their spread (the log says which); (b) the benchmark LM at batch 64 x
    512 with ``Adam(fused=True)``, 2 epochs x 2 steps, resumed to 3: the
    same, plus ``mu``, ``nu`` and the device step counter, every kernel's
    launches counted; (c) ``save_model`` of phase 4's LM, ``load_model``
    (the weights bit for bit), ``ServeEngine.from_saved`` on phase 4's 16
    requests: phase 4's streams token for token and its flash forward
    launches; then ``python -m tpu_dist_torch.serve --model-dir D --bench``
    at phase 5's arguments exits 0; (d) for ResNet-18 and the LM: the sync
    save's seconds and the directory's MB, the async save's stall at the
    epoch end and its writer's seconds, restore seconds, and the resumed
    fit's step beside the uninterrupted one's.
24. the data-parallel surface and the profiler: two worker processes
    (``chip_smoke.py --dp-worker DIR``, each with one of
    ``make_local_cluster(2)``'s TF_CONFIGs and its own timeout) share the
    card through ``MultiWorkerMirroredStrategy(communication="ring")``,
    gloo on CUDA tensors (NCCL cannot put two ranks on one device), with
    the kernels phase 2 built. (a) phase 22's ResNet-18 at global batch
    256 (128 a worker, DATA sharding), fused CE + SGD(0.001), 2 x 4
    steps with ``gradient_bucket_bytes=262144``: the workers bit for bit
    (losses, parameters, BatchNorm state after the first step and the
    last), rows 1-3 launched 8 times a worker, the bucket collectives
    ``len(partition_buckets(...))`` x 8; against a single-process twin
    (each global batch's halves through the model with local moments from
    the same state, losses, gradients and states averaged, unfused SGD)
    within phase 22's ``RESNET_*`` tolerances after one step and its drift
    rule after 8 (a one-ulp-nudged twin's drift, x ``RESNET_DRIFT``); (b)
    the same with ``gradient_bucket_bytes=0``: sync-BN over gloo, against
    one process fitting the global batch; (c) ``fit(profile_dir=D)`` of
    phase 9's LM, 4 SGD steps after one untraced: one trace in D whose
    flash forward, dQ, dK/dV and delta kernels number depth x 4, the top
    ten device kernels and the kernel families with their share of the
    step; the CNN at k = 4 fit on its captured program inside a trace and
    outside, bit for bit; (d) ``examples/custom_training_loop.py`` on the
    two workers, 40 steps: ``strategy.run``'s per-replica losses the
    same on both, ``reduce("mean")`` their mean, the parameters bit for
    bit and within ``CNN_LOSS_ATOL`` of a single-process twin on the
    global batch, the loss falling; (e) ms a step on each schedule, the
    gradient reduction alone, the bucket count and bytes: gloo staging
    through the host on a shared card, not NCCL.
25. sharded files and ``AutoShardPolicy.FILE``: ``write_sharded`` splits
    the synthetic MNIST (8,192 images) into 8 npz files, which
    ``load("mnist")`` finds through ``TPU_DIST_DATA_DIR``; two workers
    (``chip_smoke.py --file-worker DIR``, phase 24's harness) run the
    reference program's chain (load -> map(scale) -> cache -> shuffle,
    seeded -> batch(128)) with AUTO, which resolves to FILE: each worker's
    element stream equals a direct read of files i, i+2, ... bit for bit,
    the two are disjoint and their union is the dataset; the CNN with the
    fused CE and ``SGD(fused=True)`` fits 2 x 20 steps of 64 a worker on
    the host-fed path, the workers bit for bit, rows 1-3 launched 40 times
    a worker, and a single-process twin on the same per-worker batches
    (gradients averaged, unfused) within ``CNN_LOSS_ATOL``; the host ms a
    batch of the file-backed element path beside the in-memory one;
26. serving resilience on phase 4's LM at full width: (a) phase 4's 16
    requests through a journaled engine abandoned after CRASH_STEPS steps
    with its unflushed tail dropped, a second engine recovering from the
    journal: every request done, the replay naming the active and queued
    requests the journal held, the streams equal the uninterrupted ones
    (phase 4's; an uninterrupted int8 run's for the pool) but for ties
    certified by the full forward (counted), the flash forward's launches
    depth x prefills, re-prefills included; on the contiguous cache and
    the paged int8 ragged pool; (b) ``python -m tpu_dist_torch.serve
    --chaos --plan engine_crash@req6`` and then ``decode_stall@req6:S``
    with ``--stall-timeout-s`` above three times the slowest step of the
    first run's fresh worker (captures included) and S beyond it, both at
    phase 5's arguments, each exiting 0 with every gate true: restarts,
    ``replay_s``, seconds from each restart to its first token; (c) the
    storm ``request_storm@req0`` at full width on the virtual clock:
    shedding within the p99 target and shedding something, the control
    past it; (d) decode tok/s and the captured decode step's ms with the
    journal and without it (off, on, on, off), the flush's ms and bytes.
27-28. the serving fleet and the observe layer (their sections below);
29. tensor and sequence parallelism: two workers (``chip_smoke.py
    --tp-worker DIR``, phase 24's harness) share the card over gloo. (a)
    the benchmark LM at full width under ``{data: 1, model: 2}`` with
    ``Adam(fused=True)`` and the fused CE, 4 steps of 8 x 512 through
    ``make_train_function`` from seed 0's weights: the ranks' losses and
    replicated leaves bit for bit, losses within ``LOSS_ATOL`` and the
    gathered parameters within ``PARAM_RTOL`` of their step of a
    single-process twin's, ``wq`` [512, 256] a rank, the flash kernels on
    [8, 4, 512, 64], launches (16, 16, 4, 4, 4) a rank, a checkpoint at
    step 2; (b) the same under ``mixed_bfloat16`` against a bf16 twin
    within ``BF16_LOSS_ATOL``; (c) the LM with ``RingAttention()`` under
    ``{data: 1, seq: 2}`` against the flash twin (no flash launch), then
    ``ring_attention_blocks`` alone at [1, 8, 16384, 64] fp32 causal
    (8,192 positions a rank, 2048-position chunks), forward and backward
    against
    the flash kernels on the gathered q, k, v within ``RING_TOL``; (d)
    (a)'s checkpoint restored in one process and continued, against the
    tensor-parallel run's last steps; times: the step against the twin's,
    the model-axis collectives a step (each timed alone), ring against
    flash fwd+bwd at 16,384 positions, the ring's host staging.
30. the pipe and expert axes: two workers again (``chip_smoke.py
    --pp-worker DIR``). (a) the benchmark LM with ``pipeline_stages=2``,
    ``pipeline_microbatches=4`` under ``{data: 1, pipe: 2}``, 4 steps of
    ``fit`` on 8 x 512 with ``Adam(fused=True)`` and the fused CE: the
    ranks' losses and replicated leaves bit for bit, losses within
    ``PP_LOSS_RTOL`` of a pipe-less one-process twin's, stage leaves
    [1, ...] a rank, launches (32, 32, 4, 4, 4, 0) a rank, a checkpoint at
    step 2; (b) ``make_1f1b_train_step`` at M = 4 and 8: loss and
    gradients against GPipe's on the same weights within ``F1B_TOL``, the
    stash's counts, each one's peak device memory at M = 8 (1F1B's below
    GPipe's), 4 steps with ``SGD(fused=True)``; (c) the LM with 4 experts
    (top 2, 8 groups) under ``{data: 1, expert: 2}``: ranks bit for bit,
    within ``PP_LOSS_RTOL`` of a one-process twin, experts [2, ...] a
    rank, the aux loss in the objective; (d) (a)'s checkpoint restored in
    one process without a pipe axis and continued; times: each rank's step
    beside its twin's, the stage handoffs' host staging, the all_to_all's
    host time.
31. supervised training that survives its faults: ``python -m
    tpu_dist_torch.resilience`` on the card (the demo CNN, 3 x 4 steps of
    32; a baseline, then the supervised run, each run ``ok``; all five
    runs at once, beside (f), phase 32 (b) and phase 33's ``jobs
    --chaos``): (a)
    ``kill-worker@step5,kill-during-save@epoch2:attempt1``: restarts >= 2,
    the first two exits ``EXIT_FAULT_KILL``, the last resume from step 1,
    ``loss_delta`` <= 1e-5; (b) ``preempt@step6``: a ``preempted`` exit
    and its drain seconds, parity; (c) ``nan_loss@step2,grad_spike@step6,
    corrupt_batch@step10`` in one process: no restart, a rollback per
    fault, parity; (d) ``--workers 2`` (gloo on the one card)
    ``bitflip@step9:leaf1:replica1``: the SDC audit names
    ``['conv2d']['kernel']`` on both ranks (a group of two has no
    majority), no restart, a rollback, parity; (e) ``--workers 2
    kill-worker@step5:rank1``: the gang restarts and reaches parity, the
    survivor's exit logged. (f) in this process, the benchmark LM at batch
    64 x 512 with ``Adam(fused=True)``, 2 epochs x 2 steps and a
    checkpoint an epoch, at k = 1 eager and k = 2 on graphs: armed
    (``TPU_DIST_INTEGRITY=1``) with the fused CE, bit for bit with the
    unarmed fit, the same launches (rows 1-2, 5, 6-9); with the plain CE
    (a token batch's poisoned labels give it a NaN, where the fused CE
    reads their loss as the lse) and ``nan_loss@step3`` (epoch 1's last
    step): one rollback to
    step 0, the final loss and every parameter bit for bit with the clean
    fit, launches x 1.5 (the replayed epoch); the armed step's health
    vector against its plain version (``HEALTH_RTOL``); the armed step
    against the unarmed one in turns, and the SDC audit's ms over the
    21,269,504 parameters.
32. elasticity: (a) ``python -m tpu_dist_torch.resilience --step-rejoin
    --plan kill-worker@step6:rank1`` (the demo CNN on two single-process
    workers, a file gang): the control leg restarts the gang, the reform
    leg reforms it mid-epoch; the CLI's gates (a fault in both legs, no
    restart in the reform leg, a ``gang_reform`` and a ``worker_rejoin``,
    its ``recovery_wall_s`` strictly below the control's, ``loss_delta``
    exactly 0.0), printed with both legs' recovery, the speedup and the
    breakdown; (b) ``--reshape 2,1 --plan preempt@step5``: two gloo
    processes on the card with v2 checkpoints, both drained at step 5
    (``preempted`` exits), the restart on one process restoring their
    step (a ``reshape_restore`` 2 -> 1), ``loss_delta`` <= 1e-5; (c) two
    workers (``chip_smoke.py --elastic-worker DIR``) fit the benchmark LM
    under ``{data: 1, model: 2}``, 2 epochs x 2 steps of 8 x 512 with
    ``Adam(fused=True)`` and the fused CE, with ``ModelCheckpoint(sharded=
    True)`` synchronous and asynchronous and a v1 one beside them: every
    stitched v2 leaf bit for bit with the v1 step's, one process resuming
    the v2 step (2 -> 1) for an epoch bit for bit with the same resume from
    v1, a one-process v2 step restored onto the two ranks (1 -> 2) and
    trained on; each rank's bytes written and save seconds (v2, and v1's
    gather and write), the restore seconds; launches (16, 16, 4, 4, 4, 0) a
    rank; (d) on the same two ranks, ``bootstrap.reinitialize`` of their
    gloo group of CUDA tensors: an all-reduce at generation 0, the re-dial
    on base + 1, the all-reduce again; teardown and bring-up seconds. The
    one-process fit whose v2 step (c) restores runs while the workers
    start (they wait for its pointer).
33. jobs and the parameter server: (a) the benchmark LM at full width as
    a parameter server: a ``PSServer`` in this process with
    ``Adam(fused=True)`` and two worker processes (``chip_smoke.py
    --ps-worker DIR RANK``) of 8 x 512 with the fused CE, staleness 4, a
    budget of 16 applies over the file transport: the server's launches
    (0, 0, 16, 0, 0, 0), each worker's (4n, 4n, 0, n, n, 0) for its n
    pushes; each worker's first gradients against a one-process twin's at
    the packet's base version (``PS_GRAD_RTOL``); ``replay_apply_log`` from
    seed 0 reproducing the server's final checksums bit for bit; push MB
    and seconds, pull seconds, the server's apply ms, applies/s; (b)
    ``python -m tpu_dist_torch.resilience --ps-chaos`` with 4 workers and
    96 applies a leg (the demo CNN, its six legs and gates: the calibrated
    straggler against the synchronous control's collapse, a killed worker
    with no restart, a killed server restoring and finishing its budget),
    the straggler pair alone, the other legs beside phases 22-25; (c)
    ``python -m tpu_dist_torch.jobs --bench`` (beside phases 29-30: packed
    makespan against serial, the gate ratio; each serve job's flash
    launches one a prefill) and ``--chaos`` (beside phase 31: solo
    baselines, the kill and abort phases, blast radius zero); (d) phase 27's fleet of
    two replicas with ``devices_per_replica=1`` (each leasing a
    ``MeshRuntime`` slot under a job scope, its captured programs in the
    runtime's cache) against the same fleet without it: the same tokens or
    certified ties, flash launches depth x requests.
34. analysis on the card's machine (no JAX there): (a) the four modes of
    ``python -m tpu_dist_torch.analysis`` over ``tpu_dist_torch/`` (the
    check mode at ``--fail-on error``, ``--concurrency --strict``,
    ``--determinism --strict``, ``cost --baseline`` the committed
    baseline) as subprocesses beside (b) and (c), each exit 0, with their
    seconds; (b) the benchmark LM's train step (64 x 512, fp32,
    ``Adam(fused=True)``, the fused CE) recorded on the card by
    ``CollectiveRecorder(device="cuda")`` after one warm step: the same
    loss, parameters and launch counts, bit for bit, as a twin's
    unrecorded step; the recorded peak of live tensor bytes (plus what was
    allocated before the step) against ``torch.cuda.max_memory_allocated``
    over the same step, which it may fall below by at most
    ``PEAK_TOL_BYTES`` + ``PEAK_TOL_FRAC`` of the card's peak; (c) phase
    29's tensor-parallel step (``TP_AXES``, 8 x 512) recorded on a
    two-rank fake process group on the card, no process started: its
    collectives a step, ``{(op, shape, dtype): count}``, equal to what
    phase 29 (a)'s gloo rank 0 counted, both ranks' sequences clean of
    SC201/SC203, and the modeled comm bytes a step.

Every phase's seconds are logged (``[time]``) and listed at the end.

Prints one JSON line of kernel records, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import io
import itertools
import json
import os
import pathlib
import runpy
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu_dist_torch import data as td_data
from tpu_dist_torch.cluster import bootstrap, make_local_cluster
from tpu_dist_torch.data import native
from tpu_dist_torch.data.device import DeviceDataset
from tpu_dist_torch.models.cnn import build_cnn_model
from tpu_dist_torch.models.model import _flatten, _nest
from tpu_dist_torch.models.policy import policy, set_policy
from tpu_dist_torch.models.resnet import ResNet18, ResNet50
from tpu_dist_torch.models.transformer import (MultiHeadAttention,
                                               _dense_attention,
                                               build_transformer_lm)
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.ops import _build
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import fused
from tpu_dist_torch.ops.losses import SparseCategoricalCrossentropy
from tpu_dist_torch.ops.metrics import SparseCategoricalAccuracy
from tpu_dist_torch.ops.optimizers import SGD, Adam
from tpu_dist_torch.ops.schedules import ExponentialDecay
from tpu_dist_torch.parallel import (MultiWorkerMirroredStrategy,
                                     collectives, shard_batch)
from tpu_dist_torch.serve import cli, kv_cache
from tpu_dist_torch.serve.engine import ServeEngine, _pad_to_pow2
from tpu_dist_torch.serve.scheduler import DONE
from tpu_dist_torch.data import vectorize
from tpu_dist_torch.models.serialize import load_model, save_model
from tpu_dist_torch.training import Callback, checkpoint

#: bench.py's TRANSFORMER_LM at its 512-token sequence length.
LM = dict(vocab_size=8192, seq_len=512, d_model=512, depth=4, num_heads=8)
#: bench.py:63's transformer_lm global batch.
TRAIN_BATCH = 64
TRAIN_STEPS = 3
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "fused_adam.cu", "fused_ce.cu",
           "fused_sgd.cu")
#: The reference program (tf_dist_example.py): batch 64 per worker, 10
#: epochs x 20 steps, shuffle buffer 10000.
CNN_BATCH, CNN_EPOCHS, CNN_STEPS = 64, 10, 20

#: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: HBM3
#: bandwidth; fp32 on the CUDA cores; TF32 and bf16 on the tensor cores.
#: An fp32-accurate product on the tensor cores is three TF32 products
#: (3xTF32), so the card's fastest fp32 route runs at a third of the TF32
#: peak. The attention kernels' bounds (rows 6-9) take the fastest route for
#: their precision and keep the CUDA-core figure beside it; the elementwise
#: kernels are bound by bytes either way and keep the CUDA-core figure.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32X3_FLOPS_PER_S = 495e12 / 3
BF16_FLOPS_PER_S = 989e12

TIE_GAP = 1e-4
#: Kernel vs plain version: fp32 arithmetic on both sides, different
#: summation order and exp.
FP32_TOL = 1e-4
#: A bf16 value rounded to nearest is within half a bf16 ulp of its fp32
#: value: 2**-8 of its magnitude (8 significant bits). The flash forward
#: rounds P and O so (``bf16_limit``).
BF16_RTOL = 2.0 ** -8
#: Train step vs the plain-attention twin: losses near ln(8192) = 9.01,
#: where one fp32 ulp is 2**-20 = 9.5e-7, and the two attentions agree to
#: ~1e-6 — 1e-5 is about ten ulps of the loss.
LOSS_ATOL = 1e-5
#: SGD parameters vs the twin's after the 3 steps, leaf by leaf: within
#: PARAM_RTOL of the leaf's own step plus PARAM_ATOL. Measured on an H100:
#: the gaps are at most one fp32 ulp of the weights (2**-27 = 7.5e-9 for
#: |w| < 0.125), where p - lr g rounds the other way, and at most 2.4 % of
#: a leaf's step (the attention projections step by 1.3e-7 to 2.3e-6). A
#: backward that dropped dQ, dK or dV would leave wq, wk or wv where it
#: was: a gap of its whole step.
PARAM_RTOL = 0.05
PARAM_ATOL = 1e-8
#: CE kernel vs plain version, fp32 loss and lse: the same fp32 math, but
#: the kernel sums exp(x - max) with an online rescale in its own order (the
#: plain version: max first, then one sum), so lse differs by a few ulps of
#: its ~10 (1e-6). The backward is held bit for bit instead: both sides get
#: the kernel's own lse and do the same fp32 operations (accurate expf, one
#: subtraction, one product) and, for bf16 logits, the same round to nearest.
CE_TOL = 1e-5
#: CNN per-epoch losses (~2.3) vs the unfused twin after 10 x 20 steps at
#: lr 0.001: each step's gradients differ by the CE kernel's ~1e-7 relative
#: rounding, which moves the weights by ~lr x 1e-7 per step; 1e-5 is some
#: fifty fp32 ulps of the loss. cuDNN is set deterministic for the pair, so
#: the convolutions add no run-to-run noise.
CNN_LOSS_ATOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        "TF32 off for matmul and cuDNN")
    return card


def build_phase() -> None:
    t0 = time.monotonic()
    _build.build(SOURCES)
    for source in SOURCES:
        _build.load(source)
    log(f"[2 build] {', '.join(SOURCES)} ready in "
        f"{time.monotonic() - t0:.2f} s (built in parallel)")
    for source in SOURCES:
        info = _build.build_info.get(source, {})
        log(f"[2 build] {source}: nvcc {info.get('seconds', 0.0):.2f} s")
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    # Every product of the flash kernels runs on the tensor cores.
    for source in ("flash_fwd.cu", "flash_bwd.cu"):
        mix = _sass_mix(source)
        for name, (total, hmma) in mix.items():
            log(f"[2 build] {source} SASS {name}: {total} instructions, "
                f"{hmma} HMMA ({hmma / max(total, 1) * 100:.1f} %)")
        if any(hmma == 0 for _, hmma in mix.values()):
            raise AssertionError(f"{source}: a kernel without HMMA: {mix}")
        if not mix:
            log(f"[2 build] {source} SASS: not read (no cuobjdump)")


def _sass_mix(source: str) -> dict:
    """Instructions and tensor-core MMAs (HMMA) in each kernel of a built
    source, from ``cuobjdump -sass``; empty when the tool is missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(_build._library(source)[1])],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    mix, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : \S*?(flash_bwd_(?:dkv|dq)_kernel|"
                       r"flash_fwd_kernel)I(\w+?)Li(\d+)", line)
        if fn:
            dtype = "bf16" if "bfloat16" in fn.group(2) else "fp32"
            name = f"{fn.group(1)} {dtype} D={fn.group(3)}"
            mix[name] = [0, 0]
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", line):
            mix[name][0] += 1
            mix[name][1] += " HMMA." in line
    return {k: tuple(v) for k, v in mix.items()}


def _qkv(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to("cuda", dtype)
            for _ in range(3)]


def fwd_close(q, k, v, o, lse, *, causal: bool, scale: float) -> float:
    """The forward kernel's (O, lse) against the plain version in fp32 on
    the same (upcast) inputs; returns the largest |difference| over O and
    lse. fp32: atol = rtol = FP32_TOL. bf16 (``bf16_limit``): O within
    1e-4 + 2**-8 (|O_ref| + P_ref @ |V|), lse at FP32_TOL."""
    qf, kf, vf = q.float(), k.float(), v.float()
    o_ref, lse_ref = fa.flash_attention_plain(qf, kf, vf, causal=causal,
                                              scale=scale)
    torch.testing.assert_close(lse, lse_ref, atol=FP32_TOL, rtol=FP32_TOL)
    err = float((o.float() - o_ref).abs().max())
    if q.dtype == torch.float32:
        torch.testing.assert_close(o, o_ref, atol=FP32_TOL, rtol=FP32_TOL)
    else:
        limit = bf16_limit(qf, kf, vf, o_ref, causal=causal, scale=scale)
        worst = float(((o.float() - o_ref).abs() / limit).max())
        if worst > 1:
            raise AssertionError(f"bf16 forward O off the plain version by "
                                 f"{worst:.3f} x its limit")
    return max(err, float((lse - lse_ref).abs().max()))


def bf16_limit(qf, kf, vf, o_ref, *, causal: bool, scale: float):
    """Elementwise limit of a bf16 forward's O against the plain fp32 one.
    The kernel rounds each p to bf16 before P·V, as the TPU kernel casts it
    (`p.astype(v_blk.dtype)`): p (1 + d), |d| <= 2**-8, moves O by at most
    2**-8 (P_ref @ |V|) with P_ref the plain softmax (l sums the unrounded
    p); O rounded to bf16 moves by at most 2**-8 |O|; the fp32 arithmetic
    adds well under 1e-4."""
    s = torch.einsum("...qd,...kd->...qk", qf, kf) * scale
    if causal:
        ln = s.shape[-1]
        keep = torch.ones(ln, ln, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return 1e-4 + BF16_RTOL * (o_ref.abs() + torch.softmax(s, -1) @ vf.abs())


def kernel_check_phase() -> float:
    """Kernel vs plain version; returns the largest fp32 |difference|.

    The plain version runs in fp32 on the same (upcast) inputs. Both sides
    do fp32 arithmetic, so O and lse agree to FP32_TOL; a bf16 O is held to
    ``bf16_limit``. Serving's shapes (8 instances) split each query tile's
    keys over several blocks and merge them; 264 instances fill the card
    unsplit. Two calls must give the same bits in either regime."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(1, ln, 64) for ln in (128, 256, 512, 200)] + [
        (1, 256, 128), (1, 77, 32), (1, 1, 64), (33, 128, 64)]
    worst_fp32 = 0.0
    for b, ln, d in cases:
        splits = fa.split_count(b * 8, ln, d, sms)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = _qkv((b, 8, ln, d), dtype, seed=ln * d + b)
                scale = d ** -0.5
                o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                                scale=scale)
                torch.cuda.synchronize()
                err = fwd_close(q, k, v, o, lse, causal=causal, scale=scale)
                if dtype == torch.float32:
                    worst_fp32 = max(worst_fp32, err)
                limit = (f"atol = rtol = {FP32_TOL:g}"
                         if dtype == torch.float32 else "bf16 limit")
                log(f"[3 kernel] [{b * 8}, {ln}, {d}] {str(dtype)[6:]} "
                    f"causal={causal}, {splits} run(s): max |kernel - "
                    f"plain| {err:.3e} ({limit})")
    for b in (1, 33):
        q, k, v = _qkv((b, 8, 512, 64), torch.float32, seed=3)
        first = fa.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
        second = fa.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"flash forward [{b * 8}, 512, 64] is not "
                                 f"deterministic")
    log("[3 kernel] two calls give the same bits at [8, 512, 64] (split) "
        "and [264, 512, 64] (unsplit)")
    return worst_fp32


def _certified(logits: torch.Tensor, token: int) -> bool:
    """``token`` is the argmax of ``logits``, or ties it within TIE_GAP."""
    return float(logits.max() - logits[token]) < TIE_GAP


def _serve_lm():
    """The benchmark LM at full width, random weights from seed 0."""
    return build_transformer_lm(LM["vocab_size"], LM["seq_len"],
                                d_model=LM["d_model"], depth=LM["depth"],
                                num_heads=LM["num_heads"], seed=0)


def _serve_specs() -> list:
    """Phase 4's 16 seeded requests: (prompt of 65-448 tokens, budget of
    16-32 new tokens)."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, LM["vocab_size"],
                          size=int(rng.integers(65, 449))).tolist(),
             int(rng.integers(16, 33))) for _ in range(16)]


def serve_phase() -> tuple[int, list]:
    """Returns the flash launches of the serve run and its streams."""
    model = _serve_lm()
    engine = ServeEngine(model, max_batch=8, max_len=LM["seq_len"])
    specs = _serve_specs()

    fa.flash_attention_fwd.launches = 0
    t0 = time.monotonic()
    reqs = [engine.submit(p, max_new_tokens=m) for p, m in specs]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = fa.flash_attention_fwd.launches

    if not all(r.status == DONE and len(r.generated) == r.max_new_tokens
               for r in reqs):
        raise AssertionError("not every request finished with its budget: "
                             f"{[(r.status, len(r.generated)) for r in reqs]}")
    want = LM["depth"] * len(reqs)
    if launches != want:
        raise AssertionError(f"flash kernel launched {launches} times in "
                             f"the serve run; expected depth x prefills = "
                             f"{want}")
    tokens = sum(len(r.generated) for r in reqs)
    ttft = statistics.median(r.ttft_s for r in reqs)
    lat = statistics.median(r.latency_s for r in reqs)
    log(f"[4 serve] full-width LM, 16 requests (prompts "
        f"{min(len(p) for p, _ in specs)}-{max(len(p) for p, _ in specs)}):"
        f" all done; {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tok/s; TTFT p50 {ttft * 1e3:.2f} ms; "
        f"latency p50 {lat * 1e3:.2f} ms; flash launches {launches} "
        f"= depth {LM['depth']} x {len(reqs)} prefills; pads "
        f"{engine.compiled_programs()['prefill']}, buckets "
        f"{engine.compiled_programs()['decode']}")

    # Correctness, after the counted run: prefill logits against the plain
    # attention, and every generated token against the full forward.
    plan = engine.plan
    worst, first_agree, ties, decode_ok = 0.0, 0, 0, 0
    with torch.inference_mode():
        for r in reqs:
            plen = len(r.prompt)
            padded = torch.zeros(_pad_to_pow2(plen, hi=LM["seq_len"]),
                                 dtype=torch.long)
            padded[:plen] = torch.tensor(r.prompt)
            padded = padded.cuda()
            scratch = kv_cache.init_cache(plan, max_batch=1,
                                          max_len=LM["seq_len"],
                                          device="cuda")
            lg = kv_cache.prefill(plan, scratch, padded, plen, 0)
            lg_plain = kv_cache.prefill(plan, scratch, padded, plen, 0,
                                        attention_fn=_dense_attention)
            if not (torch.isfinite(lg).all() and lg.shape == (
                    LM["vocab_size"],)):
                raise AssertionError(f"request {r.rid}: bad prefill logits")
            torch.testing.assert_close(lg, lg_plain, atol=1e-3, rtol=0)
            worst = max(worst, float((lg - lg_plain).abs().max()))
            first = r.generated[0]
            if int(lg_plain.argmax()) == first:
                first_agree += 1
            elif _certified(lg_plain, first):
                ties += 1
            else:
                raise AssertionError(
                    f"request {r.rid}: first token {first} is not the plain "
                    f"path's greedy choice {int(lg_plain.argmax())}")
            seq = torch.tensor(r.prompt + r.generated[:-1]).cuda()
            full = model(seq[None])[0]
            for t, tok in enumerate(r.generated):
                if not _certified(full[plen - 1 + t], tok):
                    raise AssertionError(
                        f"request {r.rid}: token {t} ({tok}) differs from "
                        f"the full forward's {int(full[plen - 1 + t].argmax())}")
            decode_ok += 1
    torch.cuda.synchronize()
    log(f"[4 serve] prefill logits kernel vs plain: max |diff| {worst:.3e} "
        f"(atol 1e-3); first greedy token: {first_agree}/16 agree, {ties} "
        f"certified ties (top-2 gap < {TIE_GAP:g}); generated tokens match "
        f"the full forward for {decode_ok}/16 requests")
    return launches, [r.generated for r in reqs]


def cli_phase() -> None:
    argv = ["--bench", "--requests", "8", "--max-len", str(LM["seq_len"]),
            "--vocab", str(LM["vocab_size"]), "--d-model",
            str(LM["d_model"]), "--depth", str(LM["depth"]), "--num-heads",
            str(LM["num_heads"]), "--min-new", "8", "--max-new", "16"]
    out = io.StringIO()
    fa.flash_attention_fwd.launches = 0
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    launches = fa.flash_attention_fwd.launches
    report = json.loads(out.getvalue())
    if rc != 0 or not report["ok"] or report["completed"] != 8:
        raise AssertionError(f"serve CLI bench failed: rc {rc}, {report}")
    prefills = metrics.get_registry().snapshot()["counters"]["serve.prefills"]
    if prefills != 8 or launches != LM["depth"] * prefills:
        raise AssertionError(
            f"serve CLI bench: flash kernel launched {launches} times for "
            f"{prefills} prefills; expected depth x prefills = "
            f"{LM['depth']} x 8")
    log(f"[5 cli] python -m tpu_dist_torch.serve --bench (full width, 8 "
        f"requests): {report['throughput_tok_s']} tok/s, TTFT p50 "
        f"{report['ttft_s']['p50']} s on {report['device']}; flash launches "
        f"{launches} = depth {LM['depth']} x {prefills} prefills")


def _host_us(fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` in microseconds: the calls are enqueued
    back to back on the host clock, and the card is waited for after the
    clock stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def _time_ms(fn, *, runs: int = 21, per_run: int = 10,
             warmup: int = 5) -> float:
    """Median over ``runs`` CUDA-event windows of ``per_run`` calls each,
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def _fwd_bounds(bh: int, ln: int, d: int, dtype) -> dict:
    """The forward's least time on the card, causal: q, k, v read and O
    written in the input dtype, lse in fp32; two L x L x D products over the
    causal pairs, on the card's fastest route for the precision (3xTF32 at
    165 TFLOP/s for fp32, 989 TFLOP/s for bf16) and, for fp32, on the CUDA
    cores (67 TFLOP/s)."""
    size = 4 if dtype == torch.float32 else 2
    nbytes = 4 * bh * ln * d * size + bh * ln * 4
    flops = 4 * bh * d * ln * (ln + 1) // 2
    fast = TF32X3_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    bound_ms, bound_by = _bound(nbytes, flops, fast)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops, "bound_ms_cuda_cores": _bound(nbytes, flops)[0]}


def _fwd_times(q, k, v, scale, *, plain: bool) -> dict:
    """The forward at these inputs, causal: the wrapper (CUDA-event windows
    over calls back to back, which at serving's sizes also hold its host
    work), its kernels' device time (``torch.profiler``), the plain version
    and SDPA's forward (a yardstick only, never used by the port), each
    beside the bound."""
    def fwd():
        return fa.flash_attention_fwd(q, k, v, causal=True, scale=scale)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)

    b, h, ln, d = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"ms": _time_ms(fwd), "device_ms": _device_ms(fwd, 20),
            "plain_ms": (_time_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=True, scale=scale)) if plain else None),
            "library_ms": _time_ms(sdpa),
            "library_device_ms": _device_ms(sdpa, 20),
            "splits": fa.split_count(b * h, ln, d, sms),
            "dtype": str(q.dtype)[6:], **_fwd_bounds(b * h, ln, d, q.dtype)}


def _log_fwd_times(phase: str, shape: str, t: dict) -> None:
    dev = lambda x: "not measured" if x is None else f"{x:.4f}"
    plain = "" if t["plain_ms"] is None else f", plain {t['plain_ms']:.4f}"
    cores = (f"; {t['bound_ms_cuda_cores']:.4f} ms at 67 TFLOP/s on the "
             f"CUDA cores" if t["dtype"] == "float32" else "")
    log(f"[{phase} times] flash forward {shape} {t['dtype']} causal, "
        f"{t['splits']} run(s): wrapper {t['ms']:.4f} ms (device "
        f"{dev(t['device_ms'])}){plain}, SDPA {t['library_ms']:.4f} (device "
        f"{dev(t['library_device_ms'])}), bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}: {t['bytes']} B at 3.35 TB/s, {t['flops']} FLOP"
        f"{cores})")


def timing_phase(launches: int, max_abs_err: float) -> dict:
    """The forward at serving's shapes: [8, L, 64] fp32 causal for the
    prefill pads L = 512 (the record's shape), 256 and 128."""
    times = {}
    for ln in (512, 256, 128):
        q, k, v = _qkv((1, 8, ln, 64), torch.float32, seed=1)
        times[ln] = _fwd_times(q, k, v, 64 ** -0.5, plain=True)
        _log_fwd_times("6", f"[8, {ln}, 64]", times[ln])
    t = times[512]
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpu_dist_torch/csrc/flash_fwd.cu",
        "replaces": "tpu_dist/ops/flash_attention.py:148",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_ms_cuda_cores": t["bound_ms_cuda_cores"],
        "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
        "library_device_ms": t["library_device_ms"],
        "splits": t["splits"],
        "shape": [8, 512, 64],
        "serving_pads": {str(ln): {key: times[ln][key] for key in (
            "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "splits")}
                         for ln in (256, 128)},
    }


def fwd_train_timing(q, k, v, scale) -> dict:
    """The forward at the training shape, fp32 and (the mixed-bf16
    policy's) bf16, beside SDPA's forward and the bounds."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = [t.to(dtype) for t in (q, k, v)]
        t = _fwd_times(*x, scale, plain=False)
        _log_fwd_times("11", f"{list(q.shape)}", t)
        out[str(dtype)[6:]] = {key: t[key] for key in (
            "ms", "device_ms", "library_ms", "library_device_ms", "bound_ms",
            "bound_by", "bound_ms_cuda_cores", "splits")}
        del x
    return out


def assert_grads_close(got, want, dtype) -> float:
    """A backward kernel's output against the plain version's; returns the
    largest |difference|. fp32: both sides sum fp32 products in another
    order (atol = rtol = 1e-4). bf16: either side may round an output to
    the neighbouring bf16 value (one ulp, at most 2**-7 of it), and a P or
    dS value lying within the fp32 difference of a bf16 rounding boundary
    may round the other way on one side (2**-8 of one term, at most of the
    largest output)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=2.0 ** -7,
                                   atol=2.0 ** -8 * float(want.abs().max()))
    return float((got - want).abs().max())


def _bwd_inputs(shape, dtype, causal, seed):
    """q, k, v, dO and the forward kernel's (o, lse) for a backward call."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen).to("cuda", dtype)
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    return (q, k, v, o, lse, do), scale


def bwd_check_phase() -> float:
    """Backward kernels vs their plain version on the same residuals;
    returns the largest fp32 |difference| over dQ, dK, dV."""
    worst_fp32 = 0.0
    for ln in (77, 128, 200, 512, 1024):
        for d in (32, 64, 128):
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                for causal in (True, False):
                    args, scale = _bwd_inputs((1, 8, ln, d), dtype, causal,
                                              seed=ln * d + causal)
                    got = fa.flash_attention_bwd(*args, causal=causal,
                                                 scale=scale)
                    torch.cuda.synchronize()
                    want = fa.flash_attention_bwd_plain(*args, causal=causal,
                                                        scale=scale)
                    torch.cuda.synchronize()
                    err = max(assert_grads_close(g, w, dtype)
                              for g, w in zip(got, want))
                    errs[(str(dtype)[6:], causal)] = err
                    if dtype == torch.float32:
                        worst_fp32 = max(worst_fp32, err)
            log(f"[7 bwd] [8, {ln}, {d}] max |kernel - plain| over dq, dk, "
                f"dv: " + ", ".join(f"{t}{' causal' if c else ''} {e:.2e}"
                                    for (t, c), e in errs.items()))
    log(f"[7 bwd] 60 cases within tolerance (fp32 atol = rtol = 1e-4; bf16 "
        f"rtol 2**-7 + atol 2**-8 max|plain|); worst fp32 {worst_fp32:.3e}")
    return worst_fp32


def _lm_params_and_grads():
    """The full-width LM's parameters on the card and seeded gradients of
    the same shapes, fp32."""
    model = build_transformer_lm(LM["vocab_size"], LM["seq_len"],
                                 d_model=LM["d_model"], depth=LM["depth"],
                                 num_heads=LM["num_heads"], seed=0)
    params = [p.detach().to("cuda") for p in model.parameters()]
    gen = torch.Generator().manual_seed(1)
    grads = [1e-3 * torch.randn(p.shape, generator=gen).to("cuda")
             for p in params]
    return params, grads


def _adam_step(t: int) -> torch.Tensor:
    """Adam's update count ``t`` as the optimizer keeps it: 0-d int32 on
    the card."""
    return torch.tensor(t, dtype=torch.int32, device="cuda")


#: Phase 8's update counts: the first steps, and two far along, where the
#: bias correction's powers differ in their last bits.
ADAM_STEPS = (1, 2, 3, 10 ** 4, 10 ** 6)


def adam_check_phase() -> tuple[float, int]:
    """Fused Adam vs its plain version over the full-width LM's parameters
    for 5 updates at the counts ADAM_STEPS (the kernel derives the bias
    correction from the count itself); returns (largest |difference|,
    parameter count). rtol 1e-6: both sides do the same fp32 operations in
    the same order with round-to-nearest (expected bit for bit); the
    tolerance allows a division or square root that rounds the other
    way."""
    params, grads = _lm_params_and_grads()
    n = sum(p.numel() for p in params)
    kernel = [[p.clone() for p in params],
              [torch.zeros_like(p) for p in params],
              [torch.zeros_like(p) for p in params]]
    plain = [[t.clone() for t in ts] for ts in kernel]
    for t in ADAM_STEPS:
        kw = dict(step=_adam_step(t), learning_rate=1e-3, epsilon=1e-7)
        fused.fused_adam_apply(kernel[0], grads, kernel[1], kernel[2], **kw)
        fused.fused_adam_plain(plain[0], grads, plain[1], plain[2], **kw)
    torch.cuda.synchronize()
    worst, exact = 0.0, True
    for got, want in zip(kernel, plain):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-12)
            worst = max(worst, float((g - w).abs().max()))
            exact = exact and torch.equal(g, w)
    moved = max(float((a - b).abs().max()) for a, b in zip(kernel[0], params))
    if not moved > 0:
        raise AssertionError("fused Adam left the parameters unchanged")
    log(f"[8 adam] {len(params)} leaves, {n} parameters, updates at counts "
        f"{list(ADAM_STEPS)}: max "
        f"|kernel - plain| over p, m, v {worst:.3e} (rtol 1e-6; bit for bit: "
        f"{exact}); params moved by up to {moved:.3e}")
    return worst, n


def _bench_tokens(global_batch: int):
    """bench.py:120's deterministic next-token batch, on the card."""
    ln, vocab = LM["seq_len"], LM["vocab_size"]
    stream = (np.arange(global_batch * ln + 1) * 2654435761) % vocab
    x = stream[:-1].reshape(global_batch, ln).astype(np.int64)
    y = stream[1:].reshape(global_batch, ln).astype(np.int64)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def _compiled_lm(optimizer, *, plain_attention: bool = False,
                 fused_ce: bool = False):
    """bench.py:101-106's compile of the full-width LM, on the card; the
    twin's attention is the plain version; ``fused_ce`` takes the fused
    cross-entropy kernels."""
    model = build_transformer_lm(LM["vocab_size"], LM["seq_len"],
                                 d_model=LM["d_model"], depth=LM["depth"],
                                 num_heads=LM["num_heads"], seed=0)
    if plain_attention:
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.attention_fn = _dense_attention
    model.compile(optimizer=optimizer,
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=fused_ce),
                  metrics=[SparseCategoricalAccuracy()])
    return model


_COUNTED = ((fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
            (fused, "fused_adam_apply"), (fused, "fused_ce_fwd"),
            (fused, "fused_ce_bwd"), (fused, "fused_sgd_apply"))


def _reset_counts() -> None:
    for mod, name in _COUNTED:
        getattr(mod, name).launches = 0
    fused.fused_sgd_apply.momentum_launches = 0


def _counts() -> tuple[int, ...]:
    """Launches of (flash fwd, flash bwd, Adam, CE fwd, CE bwd, SGD)."""
    return tuple(getattr(mod, name).launches for mod, name in _COUNTED)


def _one_table(name: str, model) -> int:
    """The fused optimizer of ``model`` built its leaf table once over the
    run: the grads move every step, the params and the state do not."""
    builds = model.optimizer._tables.builds
    if builds != 1:
        raise AssertionError(f"{name}: {builds} leaf tables built; expected "
                             f"one per steady run")
    return builds


def _train_steps(model, x, y) -> list[float]:
    fn, state = model.make_train_function(), model.train_state()
    losses = [fn(*state, x, y) for _ in range(TRAIN_STEPS)]
    return [float(v) for v in losses]


def _twin_param_check(name, model, twin, before, *, sgd: bool):
    """The parameters moved, and (SGD) each leaf lies within PARAM_RTOL of
    its step plus PARAM_ATOL of the twin's; returns (largest move, largest
    gap to the twin, a note on the leaf nearest its limit)."""
    moved = max(float((p.detach() - b).abs().max())
                for p, b in zip(model.parameters(), before))
    if not moved > 0:
        raise AssertionError(f"{name}: the parameters did not move")
    # (|params - twin's|, the twin's own step, name) per leaf.
    leaves = [(float((p - q).detach().abs().max()),
               float((q.detach() - b).abs().max()), n)
              for (n, p), q, b in zip(model.named_parameters(),
                                      twin.parameters(), before)]
    param_diff = max(gap for gap, _, _ in leaves)
    if not sgd:
        return moved, param_diff, ""
    gap, step, leaf = max(
        leaves, key=lambda r: r[0] / (PARAM_RTOL * r[1] + PARAM_ATOL))
    qkv_step = min(step for _, step, n in leaves
                   if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv"))
    # SGD is linear in the gradients: the two models' parameters differ by
    # lr x the gradients' differences.
    over = [f"{n}: {gap:.3e} (step {step:.3e})" for gap, step, n in leaves
            if gap > PARAM_RTOL * step + PARAM_ATOL]
    if over:
        raise AssertionError(
            f"{name}: parameters differ from the twin's by more than "
            f"{PARAM_RTOL:g} x their step + {PARAM_ATOL:g}: "
            f"{'; '.join(over[:8])}")
    return moved, param_diff, (
        f" (per leaf <= {PARAM_RTOL:g} x step + {PARAM_ATOL:g}; nearest its "
        f"limit {leaf}: {gap:.3e} for a step of {step:.3e}; least wq/wk/wv "
        f"step {qkv_step:.3e})")


def train_phase() -> dict:
    """Full-width training through make_train_function/train_state: SGD,
    then Adam(fused=True), each against its plain-attention twin. Returns
    the launch counts of the two runs together."""
    x, y = _bench_tokens(TRAIN_BATCH)
    depth = LM["depth"]
    totals = [0, 0, 0]
    for name, make, fused_adam in (
            ("SGD(learning_rate=0.001)", lambda f: SGD(learning_rate=0.001),
             False),
            ("Adam(fused=True)", lambda f: Adam(fused=f), True)):
        model = _compiled_lm(make(True))
        before = [p.detach().clone() for p in model.parameters()]
        _reset_counts()
        t0 = time.monotonic()
        losses = _train_steps(model, x, y)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
        want = (depth * TRAIN_STEPS, depth * TRAIN_STEPS,
                TRAIN_STEPS if fused_adam else 0, 0, 0, 0)
        if counts != want:
            raise AssertionError(
                f"{name}: launches (flash fwd, flash bwd, Adam, CE fwd, CE "
                f"bwd, SGD) "
                f"{counts}; expected {want}")
        totals = [a + b for a, b in zip(totals, counts[:3])]
        twin = _compiled_lm(make(False), plain_attention=True)
        _reset_counts()
        twin_losses = _train_steps(twin, x, y)
        if any(_counts()):
            raise AssertionError(f"the plain twin launched {_counts()}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        np.testing.assert_allclose(losses, twin_losses, atol=LOSS_ATOL,
                                   rtol=0, err_msg=name)
        moved, param_diff, limit = _twin_param_check(
            name, model, twin, before, sgd=not fused_adam)
        tables = (f", leaf tables built {_one_table(name, model)}"
                  if fused_adam else "")
        log(f"[9 train] {name}, batch {TRAIN_BATCH} x L {LM['seq_len']}, "
            f"{TRAIN_STEPS} steps in {wall:.3f} s: losses "
            f"{[round(v, 6) for v in losses]}; plain-attention twin "
            f"{[round(v, 6) for v in twin_losses]} (max |diff| "
            f"{max(abs(a - b) for a, b in zip(losses, twin_losses)):.2e}, "
            f"atol {LOSS_ATOL:g}); params moved by up to {moved:.3e}, max "
            f"|params - twin's| {param_diff:.3e}"
            f"{limit}; launches fwd {counts[0]}, "
            f"bwd {counts[1]} (= depth {depth} x {TRAIN_STEPS}), fused Adam "
            f"{counts[2]}{tables}")
        del model, twin
        torch.cuda.empty_cache()
    return {"fwd": totals[0], "bwd": totals[1], "adam": totals[2]}


def fit_phase() -> None:
    model = _compiled_lm(SGD(learning_rate=0.001))
    x, y = _bench_tokens(4 * 32)
    _reset_counts()
    t0 = time.monotonic()
    history = model.fit((x.cpu().numpy(), y.cpu().numpy()), epochs=1,
                        steps_per_epoch=4, verbose=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = _counts()
    loss = history.history["loss"]
    if len(loss) != 1 or not np.isfinite(loss[0]):
        raise AssertionError(f"fit: History loss {loss}")
    want = (LM["depth"] * 4, LM["depth"] * 4, 0, 0, 0, 0)
    if counts != want:
        raise AssertionError(f"fit: launches {counts}; expected {want}")
    log(f"[10 fit] Model.fit((x, y), epochs=1, steps_per_epoch=4) at full "
        f"width (batches of 32) in {wall:.3f} s: loss {loss[0]:.6f}, "
        f"accuracy {history.history['accuracy'][0]:.6f}; launches fwd "
        f"{counts[0]}, bwd {counts[1]} (= depth {LM['depth']} x 4)")


def _bound(nbytes: float, flops: float,
           flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` of HBM traffic and ``flops`` at
    ``flops_per_s``, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _kernel_times(fn, calls: int = 1) -> list:
    """The CUDA kernels and copies of ``calls`` calls of ``fn`` in a
    ``torch.profiler`` trace, most device time first: ``[(name, us), ...]``,
    empty when the trace holds no device time."""
    return _step_profile(fn, calls)[0]


def _step_profile(fn, calls: int) -> tuple[list, list]:
    """One ``torch.profiler`` trace of ``calls`` calls of ``fn`` (after one
    more): its CUDA kernels and copies, and the PyTorch operators that
    launched them with their own device time, each ``[(name, us), ...]``
    most device time first (the operators are empty for a graph replay,
    which runs no operator)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    table = prof.key_averages()
    kernels = [(e.key, getattr(e, "self_device_time_total", 0))
               for e in table
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [(e.key, getattr(e, "self_device_time_total", 0)) for e in table
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    top = lambda rows: sorted((r for r in rows if r[1] > 0),
                              key=lambda r: -r[1])
    return top(kernels), top(ops)


#: Where a ResNet step moves data without computing: the SAME pads'
#: padded copies, explicit contiguous copies, and the layout transposes
#: that cuDNN or PyTorch launch (by kernel name).
LAYOUT_OPS = ("aten::constant_pad_nd", "aten::clone", "aten::contiguous")
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "transpose", "Transpose")


def _layout_ms(fn, calls: int) -> dict:
    """Device ms a call of the layout work in one trace of ``fn``: each of
    :data:`LAYOUT_OPS` with its children's kernels, and the kernels whose
    names hold one of :data:`LAYOUT_KERNELS`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in LAYOUT_OPS}
    out["transpose kernels"] = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU and e.key in out:
            out[e.key] += getattr(e, "device_time_total", 0) / 1e3 / calls
        elif (e.device_type == torch.autograd.DeviceType.CUDA
              and any(k in e.key for k in LAYOUT_KERNELS)):
            out["transpose kernels"] += getattr(
                e, "self_device_time_total", 0) / 1e3 / calls
    return out


def train_shape_check(args, scale) -> tuple[float, float]:
    """The forward and backward kernels against their plain versions on
    the training path's own shape and inputs ([64, 8, 512, 64] fp32
    causal, the residuals the timing uses); returns (forward, backward)
    largest |difference|."""
    q, k, v, o, lse, do = args
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=True,
                                              scale=scale)
    torch.testing.assert_close(o, o_ref, atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(lse, lse_ref, atol=FP32_TOL, rtol=FP32_TOL)
    fwd_err = max(float((o - o_ref).abs().max()),
                  float((lse - lse_ref).abs().max()))
    del o_ref, lse_ref
    again = fa.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    if not (torch.equal(again[0], o) and torch.equal(again[1], lse)):
        raise AssertionError("flash forward is not deterministic at the "
                             "training shape")
    del again
    got = fa.flash_attention_bwd(*args, causal=True, scale=scale)
    want = fa.flash_attention_bwd_plain(*args, causal=True, scale=scale)
    bwd_err = max(assert_grads_close(g, w, torch.float32)
                  for g, w in zip(got, want))
    del want
    # Each block writes only the rows it owns, summing in a fixed order (no
    # atomics): a second call gives the same bits.
    again = fa.flash_attention_bwd(*args, causal=True, scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(
                f"flash backward is not deterministic: two calls' {name} "
                f"differ by {float((a - b).abs().max()):.3e}")
    log(f"[11 times] training shape {list(q.shape)} fp32 causal, kernel vs "
        f"plain on the same inputs: forward O and lse {fwd_err:.3e} (atol = "
        f"rtol = {FP32_TOL:g}), backward dq, dk, dv {bwd_err:.3e} (atol = "
        f"rtol = 1e-4); a second forward and a second backward call give "
        f"the same bits")
    return fwd_err, bwd_err


def _sdpa_bwd_ms(q, k, v, do, scale) -> tuple[float, float, list]:
    """SDPA's backward at these inputs as fwd+bwd minus fwd (a yardstick,
    never used by the port): (backward ms, fwd+bwd ms, the kernels one
    profiler pass over fwd+bwd ran)."""
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                              scale=scale)

    def sdpa_fwd_bwd():
        qg.grad = kg.grad = vg.grad = None
        sdpa().backward(do)

    fwd_bwd_ms = _time_ms(sdpa_fwd_bwd)
    fwd_ms = _time_ms(sdpa)
    return fwd_bwd_ms - fwd_ms, fwd_bwd_ms, _kernel_times(sdpa_fwd_bwd)[:3]


def bwd_timing_phase(launches: int,
                     check_err: float) -> tuple[list, float, dict]:
    """Checks and times the backward at the training shape; returns the
    records of its two kernels and of the whole backward call (the TPU's
    one-tile kernel, which both compute at L = 512), the forward's error
    at that shape, and the forward's times there in fp32 and bf16.

    Bounds (rows 6-9 of the kernel table): the larger of the bytes over
    3.35 TB/s and the products' operations over the card's fastest route
    for the precision, 165 TFLOP/s for fp32-accurate products (3xTF32 on
    the tensor cores, 495 / 3) and 989 TFLOP/s for bf16; the CUDA-core
    bound (67 TFLOP/s fp32) is kept beside it as ``bound_ms_cuda_cores``.
    The bf16 time at the same shape (the mixed-bf16 policy's) is logged
    beside SDPA's bf16 backward, with no target."""
    b, h, ln, d = TRAIN_BATCH, LM["num_heads"], LM["seq_len"], 64
    bh = b * h
    args, scale = _bwd_inputs((b, h, ln, d), torch.float32, True, seed=2)
    fwd_err, bwd_err = train_shape_check(args, scale)
    q, k, v, o, lse, do = args
    ms = _time_ms(lambda: fa.flash_attention_bwd(*args, causal=True,
                                                 scale=scale))
    delta = (do * o).sum(-1)
    outs = [torch.empty_like(q) for _ in range(3)]
    part_ms = {name: _time_ms(lambda parts=parts: fa._launch_bwd(
        q, k, v, do, lse, delta, *outs, causal=True, scale=scale,
        parts=parts)) for name, parts in (("dkv", 1), ("dq", 2))}
    delta_ms = _time_ms(lambda: fa._launch_delta(do, o, delta))
    plain_ms = _time_ms(lambda: fa.flash_attention_bwd_plain(
        *args, causal=True, scale=scale), runs=11, per_run=2)
    library_ms, fwd_bwd_ms, sdpa_kernels = _sdpa_bwd_ms(q, k, v, do, scale)
    fwd_train = fwd_train_timing(q, k, v, scale)
    pairs = bh * ln * (ln + 1) // 2              # causal (query, key) pairs
    # q, k, v, o, dO read and dq, dk, dv written, fp32; lse read.
    nbytes = 8 * bh * ln * d * 4 + bh * ln * 4
    flops = 5 * 2 * d * pairs                    # S, dP, dV, dK, dQ products
    bound_ms, bound_by = _bound(nbytes, flops, TF32X3_FLOPS_PER_S)
    cuda_cores_ms, _ = _bound(nbytes, flops)
    # Each kernel alone: dK/dV reads q, k, v, dO, lse, delta and writes dk,
    # dv (products S, dP, dV, dK); dQ writes dq (products S, dP, dQ).
    part_io = {"dkv": (6 * bh * ln * d * 4 + 2 * bh * ln * 4, 8 * d * pairs),
               "dq": (5 * bh * ln * d * 4 + 2 * bh * ln * 4, 6 * d * pairs)}
    part_bound = {part: (_bound(*io, TF32X3_FLOPS_PER_S), _bound(*io))
                  for part, io in part_io.items()}
    log(f"[11 times] flash backward kernels alone: dK/dV bound "
        f"{part_bound['dkv'][0][0]:.4f} ms ({part_bound['dkv'][0][1]}; "
        f"CUDA cores {part_bound['dkv'][1][0]:.4f}), dQ bound "
        f"{part_bound['dq'][0][0]:.4f} ms ({part_bound['dq'][0][1]}; CUDA "
        f"cores {part_bound['dq'][1][0]:.4f})")
    names = ", ".join(f"{name} ({us:.0f} us)" for name, us in sdpa_kernels)
    log(f"[11 times] flash backward [{bh}, {ln}, {d}] fp32 causal, median "
        f"of CUDA-event windows: kernels {ms:.4f} ms (dK/dV kernel "
        f"{part_ms['dkv']:.4f} ms, dQ kernel {part_ms['dq']:.4f} ms, delta "
        f"kernel {delta_ms:.4f} ms), plain {plain_ms:.4f} ms, SDPA backward "
        f"{library_ms:.4f} ms (fwd+bwd {fwd_bwd_ms:.4f} - fwd "
        f"{fwd_bwd_ms - library_ms:.4f}), bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B at 3.35 TB/s, {flops} FLOP at 165 TFLOP/s "
        f"3xTF32; {cuda_cores_ms:.4f} ms at 67 TFLOP/s on the CUDA cores); "
        f"SDPA ran {names or 'not measured (no device time in the trace)'}")
    bf16 = bf16_timing(args, scale, pairs)
    del args, q, k, v, o, lse, do, delta, outs
    torch.cuda.empty_cache()
    common = {"route": "cuda", "source": "tpu_dist_torch/csrc/flash_bwd.cu",
              "launches": launches, "max_abs_err": bwd_err,
              "max_abs_err_check_cases": check_err}
    # A kernel alone has no plain version or library call of its own: its
    # plain_ms is the whole backward's plain version.
    parts = [{"name": f"flash_bwd_{part}", **common,
              "replaces": f"tpu_dist/ops/flash_attention.py:{line}",
              "ms": part_ms[part], "plain_ms": plain_ms,
              "plain_is_whole_backward": True,
              "bound_ms": part_bound[part][0][0],
              "bound_by": part_bound[part][0][1],
              "bound_ms_cuda_cores": part_bound[part][1][0],
              "library_ms": None}
             for part, line in (("dq", 245), ("dkv", 285))]
    whole = {"name": "flash_bwd", **common,
             "replaces": "tpu_dist/ops/flash_attention.py:332",
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "bound_ms_cuda_cores": cuda_cores_ms,
             "library_ms": library_ms, "delta_ms": delta_ms,
             "library_kernels": [name for name, _ in sdpa_kernels],
             "bf16": bf16}
    return [*parts, whole], fwd_err, fwd_train


def bf16_timing(args, scale, pairs) -> dict:
    """The backward on bf16 copies of the training-shape inputs (the
    mixed-bf16 policy), beside SDPA's bf16 backward; no target."""
    q, k, v, o, lse, do = args
    bq, bk, bv, bdo = (t.to(torch.bfloat16) for t in (q, k, v, do))
    bo, blse = fa.flash_attention_fwd(bq, bk, bv, causal=True, scale=scale)
    bargs = (bq, bk, bv, bo, blse, bdo)
    ms = _time_ms(lambda: fa.flash_attention_bwd(*bargs, causal=True,
                                                 scale=scale))
    library_ms, _, sdpa_kernels = _sdpa_bwd_ms(bq, bk, bv, bdo, scale)
    bh, ln, d = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    nbytes = 8 * bh * ln * d * 2 + bh * ln * 4
    bound_ms, bound_by = _bound(nbytes, 10 * d * pairs, BF16_FLOPS_PER_S)
    names = ", ".join(f"{name} ({us:.0f} us)" for name, us in sdpa_kernels)
    log(f"[11 times] flash backward {list(q.shape)} bf16 causal: kernels "
        f"{ms:.4f} ms, SDPA backward {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: 989 TFLOP/s bf16); SDPA ran "
        f"{names or 'not measured (no device time in the trace)'}")
    return {"ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "library_kernels": [name for name, _ in sdpa_kernels]}


def _state_tensors(state) -> list:
    """Every tensor of an optimizer state, in order."""
    if isinstance(state, list):
        return state
    return [t for part in state
            for t in (part if isinstance(part, list) else [part])]


def _graph_check(make, params, grads) -> int:
    """One update of ``make()`` over a copy of ``params``, captured in a
    CUDA graph and replayed 3 times after one eager warm-up, against a
    twin's 4 eager updates of another copy: bit for bit, or raise. Returns
    the captured optimizer's table builds (1 expected)."""
    a, b = [p.clone() for p in params], [p.clone() for p in params]
    opt, twin = make(), make()
    sa, sb = opt.init(a), twin.init(b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sa = opt.update(grads, sa, a)
    torch.cuda.current_stream().wait_stream(side)
    sb = twin.update(grads, sb, b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.update(grads, sa, a)
    for _ in range(3):
        graph.replay()
        sb = twin.update(grads, sb, b)
    torch.cuda.synchronize()
    got, want = a + _state_tensors(sa), b + _state_tensors(sb)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"{opt!r}: the replayed graph differs from the "
                             f"eager updates")
    if all(torch.equal(x, p) for x, p in zip(a, params)):
        raise AssertionError(f"{opt!r}: the replayed graph changed nothing")
    return opt._tables.builds


def _adam_times(params, grads) -> dict:
    """Whole call (on a cached table), kernel alone, ``Adam.update``, plain
    and library times of fused Adam over these leaves, the table builds
    over the timed calls, the graph check and the bound."""
    n = sum(p.numel() for p in params)
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    step = _adam_step(1)
    tables = fused.adam_tables()
    call = lambda: fused.fused_adam_apply(
        params, grads, mu, nu, step=step, learning_rate=1e-3, tables=tables)
    ms, host_us = _time_ms(call), _host_us(call)
    t = tables.get(0, params, grads, (mu, nu))
    lr = tables.rate(1e-3, 0)
    gptrs = fused._grad_pointers(grads)
    stream = torch.cuda.current_stream().cuda_stream
    kernel_ms = _time_ms(lambda: fused._adam_kernel()(
        t.ptr, t.rows, t.chunks, step.data_ptr(), lr.data_ptr(), 0.9,
        1 - 0.9, 0.999, 1 - 0.999, 1e-7, gptrs.buffer_info()[0], len(gptrs),
        stream))
    adam = Adam(fused=True)
    state = adam.init(params)
    update_ms = _time_ms(lambda: adam.update(grads, state, params))
    plain_ms = _time_ms(lambda: fused.fused_adam_plain(
        params, grads, mu, nu, step=step, learning_rate=1e-3))
    leaves = [p.clone().requires_grad_() for p in params]
    for p, g in zip(leaves, grads):
        p.grad = g
    torch_adam = torch.optim.Adam(leaves, lr=1e-3, eps=1e-7, fused=True)
    library_ms = _time_ms(torch_adam.step)
    nbytes = 7 * 4 * n + 8          # read p, g, m, v; write p, m, v; t, lr
    flops = 12 * n                  # 3 for m, 4 for v, 5 for p
    return {"n": n, "leaves": len(params), "ms": ms, "host_us": host_us,
            "kernel_alone_ms": kernel_ms, "update_ms": update_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "builds": tables.builds,
            "update_builds": adam._tables.builds,
            "graph_builds": _graph_check(lambda: Adam(fused=True), params,
                                         grads),
            "bound": _bound(nbytes, flops)}


def _log_optimizer_times(phase: str, name: str, where: str, t: dict,
                         library: str) -> None:
    log(f"[{phase} times] {name} over {t['n']} {where} parameters "
        f"({t['leaves']} leaves), median of CUDA-event windows: whole call "
        f"{t['ms']:.4f} ms (host time {t['host_us']:.1f} us a call; kernel "
        f"alone {t['kernel_alone_ms']:.4f} ms; table builds over the timed "
        f"calls {t['builds']}), "
        f"{'SGD' if 'SGD' in name else 'Adam'}.update {t['update_ms']:.4f} ms "
        f"(builds {t['update_builds']}), plain {t['plain_ms']:.4f} ms, "
        f"{library} {t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
        f"({t['bound'][1]}); captured update replayed 3 times bit for bit "
        f"with eager (builds {t['graph_builds']})")


def adam_timing_phase(launches: int, max_abs_err: float) -> dict:
    """Fused Adam at the LM's and the CNN's sizes; returns its record."""
    times = {}
    for where, (params, grads) in (("LM", _lm_params_and_grads()),
                                   ("CNN", _cnn_params_and_grads())):
        times[where] = _adam_times(params, grads)
        _log_optimizer_times("11", "fused Adam", where, times[where],
                             "torch.optim.Adam(fused=True).step()")
        del params, grads
    lm, cnn = times["LM"], times["CNN"]
    return {"name": "fused_adam", "route": "cuda",
            "source": "tpu_dist_torch/csrc/fused_adam.cu",
            "replaces": "tpu_dist/ops/pallas_kernels.py:359",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": lm["ms"], "plain_ms": lm["plain_ms"],
            "bound_ms": lm["bound"][0], "bound_by": lm["bound"][1],
            "library_ms": lm["library_ms"],
            "kernel_alone_ms": lm["kernel_alone_ms"],
            "update_ms": lm["update_ms"], "host_us": lm["host_us"],
            "table_builds": lm["builds"],
            "cnn_shape": {k: cnn[k] for k in (
                "ms", "host_us", "kernel_alone_ms", "update_ms",
                "plain_ms", "library_ms", "builds")} | {"bound_ms": cnn["bound"][0]}}


def _lm_step_ms(name: str, model, phase: str) -> float:
    x, y = _bench_tokens(TRAIN_BATCH)
    fn, state = model.make_train_function(), model.train_state()
    ms = _time_ms(lambda: fn(*state, x, y), runs=5, per_run=4)
    tokens = TRAIN_BATCH * LM["seq_len"]
    log(f"[{phase} times] full train step, {name}, batch {TRAIN_BATCH} x L "
        f"{LM['seq_len']} fp32, median of 5 windows x 4 steps: "
        f"{ms:.3f} ms = {tokens / ms * 1e3:.1f} tokens/s")
    return ms


def step_timing_phase() -> float:
    """Times the train step with SGD and with Adam(fused=True); returns the
    SGD step's ms."""
    times = {}
    for name, optimizer in (("SGD", SGD(learning_rate=0.001)),
                            ("Adam(fused=True)", Adam(fused=True))):
        model = _compiled_lm(optimizer)
        times[name] = _lm_step_ms(name, model, "11")
        del model
        torch.cuda.empty_cache()
    return times["SGD"]


# -- slice 3: the fused CE and SGD kernels and the reference program --------

#: Phase 12's shapes: the CNN's batch, a ragged batch, a rank-3 input, a
#: square case, and the LM's B x L by vocab.
CE_SHAPES = ((64, 10), (37, 10), (2, 16, 64), (1000, 1000), (32768, 8192))


def _ce_inputs(shape, dtype, seed):
    """Logits (3 x N(0, 1)), int64 labels and a cotangent in [0.5, 1.5) on
    the card; some labels of the ragged case lie outside [0, C)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    x = (3 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    y = torch.randint(0, shape[-1], shape[:-1], generator=gen, device="cuda")
    if shape == (37, 10):   # no column matches: loss = lse, no one-hot
        y.view(-1)[::5] = -1
        y.view(-1)[1::7] = shape[-1]
    g = torch.rand(shape[:-1], generator=gen, device="cuda") + 0.5
    return x, y, g


def ce_check_phase() -> tuple[float, float]:
    """CE kernels vs their plain version on the same inputs (the backward
    on the kernel's lse); returns the largest fp32 |difference| of the
    forward (loss, lse) and of the backward."""
    worst = [0.0, 0.0]
    for shape in CE_SHAPES:
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            x, y, g = _ce_inputs(shape, dtype, seed=shape[-1] + len(shape))
            c = shape[-1]
            x2, y2, g2 = x.reshape(-1, c), y.reshape(-1), g.reshape(-1)
            loss, lse = fused.fused_ce_fwd(x2, y2)
            dx = fused.fused_ce_bwd(x2, y2, lse, g2)
            # The rank-general autograd path launches the same kernels.
            xr = x.detach().clone().requires_grad_()
            per = fused.fused_sparse_cross_entropy(xr, y)
            per.backward(g)
            torch.cuda.synchronize()
            want_loss, want_lse = fused.fused_ce_fwd_plain(x2, y2)
            want_dx = fused.fused_ce_bwd_plain(x2, y2, lse, g2)
            torch.cuda.synchronize()
            torch.testing.assert_close(loss, want_loss, atol=CE_TOL,
                                       rtol=CE_TOL)
            torch.testing.assert_close(lse, want_lse, atol=CE_TOL,
                                       rtol=CE_TOL)
            if not torch.equal(dx, want_dx):
                raise AssertionError(
                    f"CE {shape} {dtype}: dlogits differ from the plain "
                    f"version by up to "
                    f"{float((dx.float() - want_dx.float()).abs().max()):.3e}")
            if not (torch.equal(per.detach().reshape(-1), loss)
                    and torch.equal(xr.grad.reshape(-1, c), dx)):
                raise AssertionError(f"CE {shape}: the autograd path differs "
                                     f"from the kernels called directly")
            f_err = max(float((loss - want_loss).abs().max()),
                        float((lse - want_lse).abs().max()))
            b_err = float((dx.float() - want_dx.float()).abs().max())
            errs.append(f"{str(dtype)[6:]} fwd {f_err:.2e} bwd {b_err:.2e}")
            if dtype == torch.float32:
                worst = [max(worst[0], f_err), max(worst[1], b_err)]
            del x, x2, xr, per, dx, want_dx
            torch.cuda.empty_cache()
        log(f"[12 ce] {list(shape)}: max |kernel - plain| {'; '.join(errs)}")
    log(f"[12 ce] 10 cases: loss and lse within atol = rtol = {CE_TOL:g}, "
        f"dlogits bit for bit; worst fp32 forward {worst[0]:.3e}, "
        f"backward {worst[1]:.3e}")
    return worst[0], worst[1]


def _cnn_params_and_grads():
    """The CNN's parameters on the card and seeded gradients, fp32."""
    params = [p.detach().to("cuda") for p in build_cnn_model().parameters()]
    gen = torch.Generator().manual_seed(2)
    grads = [1e-2 * torch.randn(p.shape, generator=gen).to("cuda")
             for p in params]
    return params, grads


SGD_MODES = (("plain", 0.0, False), ("momentum", 0.9, False),
             ("nesterov", 0.9, True))


def _sgd_rates():
    """Phase 13's learning rate per step: a float, then a schedule's 0-d
    value on the card at steps 1 and 2."""
    decay = ExponentialDecay(0.002, decay_steps=1, decay_rate=0.5)
    return [0.001] + [decay(torch.tensor(k, dtype=torch.int32, device="cuda"))
                      for k in (1, 2)]


def sgd_check_phase() -> dict:
    """Fused SGD vs its plain version over the LM's and the CNN's leaves for
    3 steps, each mode, the first at a float learning rate and the next two
    at a schedule's device value: bit for bit (the same fp32 operations in
    the same order, rounded to nearest, no contraction). Returns the
    largest |difference| of the plain mode and of the momentum modes."""
    worst = {"plain": 0.0, "momentum": 0.0}
    for label, (params, grads) in (("LM", _lm_params_and_grads()),
                                   ("CNN", _cnn_params_and_grads())):
        n = sum(p.numel() for p in params)
        done = []
        for mode, m, nesterov in SGD_MODES:
            kp, pp = ([p.clone() for p in params] for _ in range(2))
            kv, pv = (([torch.zeros_like(p) for p in params] if m else None)
                      for _ in range(2))
            for lr in _sgd_rates():
                fused.fused_sgd_apply(kp, grads, kv, learning_rate=lr,
                                      momentum=m, nesterov=nesterov)
                fused.fused_sgd_plain(pp, grads, pv, learning_rate=lr,
                                      momentum=m, nesterov=nesterov)
            torch.cuda.synchronize()
            got, want = kp + (kv or []), pp + (pv or [])
            diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"fused SGD ({label}, {mode}) differs "
                                     f"from its plain version by {diff:.3e}")
            key = "plain" if m == 0.0 else "momentum"
            worst[key] = max(worst[key], diff)
            if not all(not torch.equal(a, b) for a, b in zip(kp, params)):
                raise AssertionError(f"fused SGD ({label}, {mode}) left a "
                                     f"leaf unchanged")
            done.append(mode)
        log(f"[13 sgd] {label}: {len(params)} leaves, {n} parameters, 3 "
            f"steps (lr 0.001, then ExponentialDecay's device values) of "
            f"{', '.join(done)}: bit for bit with the plain version")
    return worst


def program_phase() -> None:
    """The reference program as it stands, in this process."""
    argv, out = sys.argv, io.StringIO()
    _reset_counts()
    t0 = time.monotonic()
    try:
        sys.argv = ["tpu_dist_example"]
        with contextlib.redirect_stdout(out):
            g = runpy.run_module("tpu_dist_torch.examples.tpu_dist_example",
                                 run_name="__main__")
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    history = g["history"].history
    loss = history["loss"]
    device = next(g["multi_worker_model"].parameters()).device
    if device.type != "cuda":
        raise AssertionError(f"the reference program trained on {device}")
    if len(loss) != CNN_EPOCHS or not np.all(np.isfinite(loss)) or not (
            loss[-1] < loss[0]):
        raise AssertionError(f"reference program: epoch losses {loss}")
    if any(_counts()):
        raise AssertionError(f"the unfused program launched {_counts()}")
    log(f"[14 program] python -m tpu_dist_torch.examples.tpu_dist_example "
        f"(1 worker on {device}, {CNN_EPOCHS} x {CNN_STEPS} steps of "
        f"{CNN_BATCH}) in {wall:.3f} s: loss {loss[0]:.6f} -> {loss[-1]:.6f}, "
        f"accuracy {history['accuracy'][0]:.4f} -> "
        f"{history['accuracy'][-1]:.4f}")


def _program_chain(seed: int):
    """The reference program's chain (load -> map(scale) -> cache ->
    shuffle -> batch, OFF), with a seeded shuffle so that two runs see the
    same batches."""
    def scale(image, label):
        return np.asarray(image, np.float32) / 255.0, label

    ds = (td_data.load("mnist", split="train").map(scale).cache()
          .shuffle(10000, seed=seed).batch(CNN_BATCH))
    options = td_data.Options()
    options.experimental_distribute.auto_shard_policy = \
        td_data.AutoShardPolicy.OFF
    return ds.with_options(options)


def _cnn_fit(optimizer, fused_ce: bool, epochs: int, seed: int, k: int = 1):
    """The reference program's strategy, model and fit, with this compile
    (``k`` steps an execution)."""
    strategy = MultiWorkerMirroredStrategy()
    with strategy.scope():
        model = build_cnn_model()
        model.compile(optimizer=optimizer,
                      loss=SparseCategoricalCrossentropy(from_logits=True,
                                                         fused=fused_ce),
                      metrics=[SparseCategoricalAccuracy()],
                      steps_per_execution=k)
    history = model.fit(_program_chain(seed), epochs=epochs,
                        steps_per_epoch=CNN_STEPS, verbose=0)
    return model, history.history


def cnn_fused_phase() -> dict:
    """This slice's main path: the program with the fused CE and SGD,
    against its unfused twin; then momentum SGD. Returns launch counts."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        _reset_counts()
        t0 = time.monotonic()
        fm, h = _cnn_fit(SGD(learning_rate=0.001, fused=True), True,
                         CNN_EPOCHS, seed=0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
        steps = CNN_EPOCHS * CNN_STEPS
        want = (0, 0, 0, steps, steps, steps)
        if counts != want or fused.fused_sgd_apply.momentum_launches:
            raise AssertionError(f"fused CNN program: launches {counts}; "
                                 f"expected {want}")
        _reset_counts()
        tm, th = _cnn_fit(SGD(learning_rate=0.001), False, CNN_EPOCHS, seed=0)
        if any(_counts()):
            raise AssertionError(f"the unfused twin launched {_counts()}")
        np.testing.assert_allclose(h["loss"], th["loss"], atol=CNN_LOSS_ATOL,
                                   rtol=0, err_msg="fused CNN vs twin")
        if not h["loss"][-1] < h["loss"][0]:
            raise AssertionError(f"fused CNN program: losses {h['loss']}")
        log(f"[15 cnn] the program with fused CE + SGD(fused=True), "
            f"{CNN_EPOCHS} x {CNN_STEPS} steps of {CNN_BATCH} in {wall:.3f} "
            f"s: losses {[round(v, 6) for v in h['loss']]}; unfused twin max "
            f"|diff| {max(abs(a - b) for a, b in zip(h['loss'], th['loss'])):.2e}"
            f" (atol {CNN_LOSS_ATOL:g}); launches CE fwd {counts[3]}, CE bwd "
            f"{counts[4]}, SGD {counts[5]}; leaf tables built "
            f"{_one_table('fused CNN program', fm)}")
        _reset_counts()
        mm, mh = _cnn_fit(SGD(learning_rate=0.001, momentum=0.9,
                              fused=True), True, 2, seed=1)
        momentum = fused.fused_sgd_apply.momentum_launches
        if momentum != 2 * CNN_STEPS or _counts()[5] != 2 * CNN_STEPS:
            raise AssertionError(f"momentum CNN: {momentum} momentum launches "
                                 f"of {_counts()}; expected {2 * CNN_STEPS}")
        _, mth = _cnn_fit(SGD(learning_rate=0.001, momentum=0.9), False, 2,
                          seed=1)
        np.testing.assert_allclose(mh["loss"], mth["loss"],
                                   atol=CNN_LOSS_ATOL, rtol=0,
                                   err_msg="momentum CNN vs twin")
        log(f"[15 cnn] SGD(momentum=0.9, fused=True), 2 x {CNN_STEPS} steps: "
            f"losses {[round(v, 6) for v in mh['loss']]}, twin "
            f"{[round(v, 6) for v in mth['loss']]}; momentum launches "
            f"{momentum}; leaf tables built {_one_table('momentum CNN', mm)}")
        # A scheduled rate launches the kernel too: it reads the schedule's
        # value on the card.
        decay = lambda: ExponentialDecay(0.002, CNN_STEPS, 0.5)
        _reset_counts()
        sm, sh = _cnn_fit(SGD(learning_rate=decay(), fused=True), True, 2,
                          seed=2)
        scheduled = _counts()[5]
        if scheduled != 2 * CNN_STEPS:
            raise AssertionError(f"scheduled CNN: {_counts()}; expected "
                                 f"{2 * CNN_STEPS} SGD launches")
        _, sth = _cnn_fit(SGD(learning_rate=decay()), False, 2, seed=2)
        np.testing.assert_allclose(sh["loss"], sth["loss"],
                                   atol=CNN_LOSS_ATOL, rtol=0,
                                   err_msg="scheduled CNN vs twin")
        log(f"[15 cnn] SGD(ExponentialDecay(0.002, {CNN_STEPS}, 0.5), "
            f"fused=True), 2 x {CNN_STEPS} steps: losses "
            f"{[round(v, 6) for v in sh['loss']]}, twin "
            f"{[round(v, 6) for v in sth['loss']]}; SGD launches {scheduled}; "
            f"leaf tables built {_one_table('scheduled CNN', sm)}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    # Phase 20 holds its graphed runs to these k = 1 runs.
    k1 = {"fused": (h["loss"], [p.detach().clone() for p in fm.parameters()]),
          "unfused": (th["loss"],
                      [p.detach().clone() for p in tm.parameters()])}
    return {"ce_fwd": counts[3], "ce_bwd": counts[4], "sgd": counts[5],
            "sgd_momentum": momentum, "sgd_scheduled": scheduled, "k1": k1}


def lm_fused_phase() -> dict:
    """The full-width LM with the fused CE and SGD(fused=True) against phase
    9's plain twin (plain attention, unfused loss and SGD)."""
    x, y = _bench_tokens(TRAIN_BATCH)
    depth, name = LM["depth"], "fused CE + SGD(fused=True)"
    model = _compiled_lm(SGD(learning_rate=0.001, fused=True), fused_ce=True)
    before = [p.detach().clone() for p in model.parameters()]
    _reset_counts()
    t0 = time.monotonic()
    losses = _train_steps(model, x, y)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = _counts()
    want = (depth * TRAIN_STEPS, depth * TRAIN_STEPS, 0, TRAIN_STEPS,
            TRAIN_STEPS, TRAIN_STEPS)
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}; expected {want}")
    twin = _compiled_lm(SGD(learning_rate=0.001), plain_attention=True)
    _reset_counts()
    twin_losses = _train_steps(twin, x, y)
    if any(_counts()):
        raise AssertionError(f"the plain twin launched {_counts()}")
    np.testing.assert_allclose(losses, twin_losses, atol=LOSS_ATOL, rtol=0,
                               err_msg=name)
    moved, param_diff, limit = _twin_param_check(name, model, twin, before,
                                                 sgd=True)
    log(f"[16 lm] {name}, batch {TRAIN_BATCH} x L {LM['seq_len']}, "
        f"{TRAIN_STEPS} steps in {wall:.3f} s: losses "
        f"{[round(v, 6) for v in losses]}; plain twin "
        f"{[round(v, 6) for v in twin_losses]} (max |diff| "
        f"{max(abs(a - b) for a, b in zip(losses, twin_losses)):.2e}, atol "
        f"{LOSS_ATOL:g}); params moved by up to {moved:.3e}, max |params - "
        f"twin's| {param_diff:.3e}{limit}; launches (flash fwd, flash bwd, "
        f"Adam, CE fwd, CE bwd, SGD) {counts}; leaf tables built "
        f"{_one_table(name, model)}")
    del model, twin
    torch.cuda.empty_cache()
    return {"ce_fwd": counts[3], "ce_bwd": counts[4], "sgd": counts[5]}


def _ce_times(shape) -> dict:
    """Kernel, plain and library times of the CE pair at ``shape`` fp32."""
    rows, cols = shape
    x, y, g = _ce_inputs(shape, torch.float32, seed=rows)
    big = rows * cols > 1e6
    slow = dict(runs=11, per_run=2) if big else {}
    loss, lse = fused.fused_ce_fwd(x, y)
    xg = x.detach().clone().requires_grad_()

    def lib_fwd():
        return F.cross_entropy(xg, y, reduction="none")

    def lib_fwd_bwd():
        xg.grad = None
        lib_fwd().backward(g)

    fwd_lib = _time_ms(lib_fwd)
    t = {"fwd": {"ms": _time_ms(lambda: fused.fused_ce_fwd(x, y)),
                 "plain_ms": _time_ms(lambda: fused.fused_ce_fwd_plain(x, y),
                                      **slow),
                 "library_ms": fwd_lib},
         "bwd": {"ms": _time_ms(lambda: fused.fused_ce_bwd(x, y, lse, g)),
                 "plain_ms": _time_ms(lambda: fused.fused_ce_bwd_plain(
                     x, y, lse, g), **slow),
                 "library_ms": _time_ms(lib_fwd_bwd) - fwd_lib}}
    # fp32 logits, int64 labels, fp32 loss + lse / lse + g in, dlogits out.
    t["fwd"]["bound"] = _bound(rows * cols * 4 + rows * (8 + 8),
                               5 * rows * cols)
    t["bwd"]["bound"] = _bound(2 * rows * cols * 4 + rows * (8 + 4 + 4),
                               4 * rows * cols)
    return t


def _sgd_times(params, grads) -> dict:
    """Whole call (on a cached table), kernel alone, ``SGD.update``, plain
    and library times of fused SGD, plain and momentum, over these leaves,
    the table builds over the timed calls, the graph check and the
    bound."""
    n = sum(p.numel() for p in params)
    stream = torch.cuda.current_stream().cuda_stream
    gptrs = fused._grad_pointers(grads)
    out = {}
    for mode, m in (("plain", 0.0), ("momentum", 0.9)):
        vel = [torch.zeros_like(p) for p in params] if m else None
        kw = dict(learning_rate=0.001, momentum=m)
        tables = fused.sgd_tables()
        call = lambda: fused.fused_sgd_apply(params, grads, vel,
                                             tables=tables, **kw)
        ms, host_us = _time_ms(call), _host_us(call)
        t = tables.get(0, params, grads, (vel,) if vel else ())
        lr = tables.rate(0.001, 0)
        sgd = SGD(fused=True, **kw)
        state = sgd.init(params)
        leaves = [p.clone().requires_grad_() for p in params]
        for p, g in zip(leaves, grads):
            p.grad = g
        torch_sgd = torch.optim.SGD(leaves, lr=0.001, momentum=m,
                                    foreach=True)
        out[mode] = {
            "n": n, "leaves": len(params), "ms": ms, "host_us": host_us,
            "kernel_alone_ms": _time_ms(lambda: fused._sgd_kernel()(
                t.ptr, t.rows, t.chunks, fused._sgd_mode(m, False),
                lr.data_ptr(), m, gptrs.buffer_info()[0], len(gptrs),
                stream)),
            "update_ms": _time_ms(lambda: sgd.update(grads, state, params)),
            "plain_ms": _time_ms(lambda: fused.fused_sgd_plain(
                params, grads, vel, **kw)),
            "library_ms": _time_ms(torch_sgd.step),
            "builds": tables.builds, "update_builds": sgd._tables.builds,
            "graph_builds": _graph_check(lambda: SGD(fused=True, **kw),
                                         params, grads),
            # p, g read and p written (plus v read and written), fp32.
            "bound": _bound((12 if not m else 20) * n, (2 if not m else 4) * n),
        }
    return out


def _device_ms(fn, steps: int) -> float | None:
    """Device time per call of ``fn`` (the sum of its CUDA kernels and
    copies in a ``torch.profiler`` trace of ``steps`` calls), or None when
    the trace holds no device time."""
    total_us = sum(us for _, us in _kernel_times(fn, steps))
    return total_us / 1e3 / steps if total_us else None


def _cnn_step_times(batch, fused_on: bool):
    """(ms per CNN train step, device ms per step or None)."""
    model = build_cnn_model()
    model.compile(optimizer=SGD(learning_rate=0.001, fused=fused_on),
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=fused_on),
                  metrics=[SparseCategoricalAccuracy()])
    fn, state = model.make_train_function(), model.train_state()
    step = lambda: fn(*state, *batch)
    return _time_ms(step, runs=11, per_run=20), _device_ms(step, 20)


def slice3_timing_phase(launches: dict, ce_errs: tuple, sgd_errs: dict,
                        sgd_step_ms: float) -> list:
    """Times of the four new kernels at the LM's and the CNN's shapes, the
    LM step with them beside phase 11's, and the CNN step; returns their
    kernel records (rows 1-4 of the TPU kernel table)."""
    ce = {"lm": _ce_times((TRAIN_BATCH * LM["seq_len"], LM["vocab_size"])),
          "cnn": _ce_times((CNN_BATCH, 10))}
    for part in ("fwd", "bwd"):
        for where, shape in (("lm", f"[{TRAIN_BATCH * LM['seq_len']}, "
                                    f"{LM['vocab_size']}]"),
                             ("cnn", f"[{CNN_BATCH}, 10]")):
            t = ce[where][part]
            log(f"[17 times] CE {part} {shape} fp32: kernel {t['ms']:.4f} "
                f"ms, plain {t['plain_ms']:.4f} ms, F.cross_entropy "
                f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
                f"({t['bound'][1]})")
    lm_p, lm_g = _lm_params_and_grads()
    cnn_p, cnn_g = _cnn_params_and_grads()
    sgd = {"lm": _sgd_times(lm_p, lm_g), "cnn": _sgd_times(cnn_p, cnn_g)}
    # The rate a plain device copy reaches for plain SGD's traffic at the
    # LM's size (12 bytes an element: a copy reads and writes 1.5 floats).
    n = sum(p.numel() for p in lm_p)
    src = torch.ones(3 * n // 2, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = _time_ms(lambda: dst.copy_(src))
    lm_sgd = sgd["lm"]["plain"]
    log(f"[17 times] device copy of {src.numel() * 4} B (plain SGD's {12 * n} "
        f"B of traffic at the LM): {copy_ms:.4f} ms = "
        f"{12 * n / copy_ms / 1e9:.3f} TB/s; the SGD kernel alone "
        f"{lm_sgd['kernel_alone_ms']:.4f} ms = "
        f"{12 * n / lm_sgd['kernel_alone_ms'] / 1e9:.3f} TB/s "
        f"({copy_ms / lm_sgd['kernel_alone_ms'] * 100:.1f} % of the copy's)")
    del src, dst
    for where in ("lm", "cnn"):
        for mode, t in sgd[where].items():
            _log_optimizer_times(
                "17", f"fused SGD {mode}", where.upper(), t,
                f"torch.optim.SGD(momentum={0.9 if mode != 'plain' else 0},"
                f" foreach=True).step()")
    del lm_p, lm_g
    model = _compiled_lm(SGD(learning_rate=0.001, fused=True), fused_ce=True)
    fused_ms = _lm_step_ms("fused CE + SGD(fused=True)", model, "17")
    log(f"[17 times] LM step with the fused CE + SGD {fused_ms:.3f} ms "
        f"beside phase 11's SGD step {sgd_step_ms:.3f} ms "
        f"({(fused_ms / sgd_step_ms - 1) * 100:+.2f} %)")
    del model
    torch.cuda.empty_cache()
    x, y = next(iter(_program_chain(0)))
    batch = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    # The main path's step and its unfused twin, in turns. The step is
    # host-bound and its wall time drifts between calls; the device time is
    # the number to compare.
    for fused_on in (True, False):
        ms, dev = _cnn_step_times(batch, fused_on)
        busy = ("not measured" if dev is None else
                f"device {dev:.4f} ms/step ({dev / ms * 100:.1f} % busy)")
        log(f"[17 times] CNN train step, batch {CNN_BATCH}, CE and SGD "
            f"{'fused' if fused_on else 'unfused'}, median of 11 windows x "
            f"20 steps: {ms:.4f} ms = {CNN_BATCH / ms * 1e3:.1f} images/s; "
            f"{busy} (torch.profiler, 20 steps)")
    records = []
    for name, row, part, err, key in (
            ("fused_ce_fwd", 73, "fwd", ce_errs[0], "ce_fwd"),
            ("fused_ce_bwd", 123, "bwd", ce_errs[1], "ce_bwd")):
        lm, cnn_t = ce["lm"][part], ce["cnn"][part]
        records.append({
            "name": name, "route": "cuda",
            "source": "tpu_dist_torch/csrc/fused_ce.cu",
            "replaces": f"tpu_dist/ops/pallas_kernels.py:{row}",
            "launches": launches["cnn"][key],
            "launches_by_path": {"cnn_program": launches["cnn"][key],
                                 "lm_train": launches["lm"][key]},
            "max_abs_err": err, "ms": lm["ms"], "plain_ms": lm["plain_ms"],
            "bound_ms": lm["bound"][0], "bound_by": lm["bound"][1],
            "library_ms": lm["library_ms"],
            "shape": [TRAIN_BATCH * LM["seq_len"], LM["vocab_size"]],
            "cnn_shape": {"shape": [CNN_BATCH, 10], "ms": cnn_t["ms"],
                          "plain_ms": cnn_t["plain_ms"],
                          "library_ms": cnn_t["library_ms"],
                          "bound_ms": cnn_t["bound"][0]}})
    for name, row, mode, count in (
            ("fused_sgd", 237, "plain", launches["cnn"]["sgd"]),
            ("fused_sgd_momentum", 241, "momentum",
             launches["cnn"]["sgd_momentum"])):
        lm, cnn_t = sgd["lm"][mode], sgd["cnn"][mode]
        records.append({
            "name": name, "route": "cuda",
            "source": "tpu_dist_torch/csrc/fused_sgd.cu",
            "replaces": f"tpu_dist/ops/pallas_kernels.py:{row}",
            "launches": count,
            "launches_by_path": ({"cnn_program": count,
                                  "cnn_scheduled":
                                      launches["cnn"]["sgd_scheduled"],
                                  "lm_train": launches["lm"]["sgd"]}
                                 if mode == "plain"
                                 else {"cnn_momentum": count}),
            "max_abs_err": sgd_errs[mode], "ms": lm["ms"],
            "plain_ms": lm["plain_ms"],
            "bound_ms": lm["bound"][0], "bound_by": lm["bound"][1],
            "library_ms": lm["library_ms"],
            "kernel_alone_ms": lm["kernel_alone_ms"],
            "update_ms": lm["update_ms"], "host_us": lm["host_us"],
            "table_builds": lm["builds"],
            "cnn_shape": {k: cnn_t[k] for k in (
                "ms", "host_us", "kernel_alone_ms", "update_ms",
                "plain_ms", "library_ms", "builds")} | {"bound_ms": cnn_t["bound"][0]}})
    return records


# -- slice 7: the paged KV pool, prefix caching, chunked prefill, int8 pages --

#: Phase 18's chunk size for chunked prefill.
PAGED_CHUNK = 64
#: A dequantized int8 K/V value against the row it quantized: rounding to
#: the nearest step is within half a step (scale / 2); the division and
#: the product add a few fp32 ulps of the value.
QUANT_RTOL = 1e-6


def _counter(name: str) -> float:
    return metrics.get_registry().snapshot()["counters"].get(name, 0)


def _drain(engine, specs) -> tuple[list, dict]:
    """Submit ``specs`` on a fresh metrics registry and drain; returns the
    requests and the run's times (host clock, the card synchronized)."""
    metrics.get_registry().reset()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [engine.submit(p, max_new_tokens=m) for p, m in specs]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if not all(r.status == DONE and len(r.generated) == r.max_new_tokens
               for r in reqs):
        raise AssertionError("not every request finished with its budget: "
                             f"{[(r.status, len(r.generated)) for r in reqs]}")
    tokens = sum(len(r.generated) for r in reqs)
    return reqs, {"tok_s": tokens / wall,
                  "ttft_p50_ms": statistics.median(
                      r.ttft_s for r in reqs) * 1e3,
                  "latency_p50_ms": statistics.median(
                      r.latency_s for r in reqs) * 1e3}


def _certify(model, reqs, label: str) -> None:
    """Every generated token is the full forward's greedy choice, under
    phase 4's rule (a top-2 gap under TIE_GAP counts as a tie)."""
    with torch.inference_mode():
        for r in reqs:
            seq = torch.tensor(r.prompt + r.generated[:-1], device="cuda")
            full = model(seq[None])[0]
            plen = len(r.prompt)
            for t, tok in enumerate(r.generated):
                if not _certified(full[plen - 1 + t], tok):
                    raise AssertionError(
                        f"{label}: request {r.rid} token {t} ({tok}) differs "
                        f"from the full forward's "
                        f"{int(full[plen - 1 + t].argmax())}")


def _ties(model, reqs, want: list, label: str) -> int:
    """The number of requests whose stream leaves ``want``'s at a certified
    tie of the full forward; any other difference raises."""
    ties = 0
    with torch.inference_mode():
        for r, other in zip(reqs, want):
            if r.generated == other:
                continue
            t = next((i for i, (a, b) in enumerate(zip(r.generated, other))
                      if a != b), None)
            if t is None:
                raise AssertionError(f"{label}: request {r.rid} stream "
                                     "length differs")
            seq = torch.tensor(r.prompt + r.generated[:t], device="cuda")
            logits = model(seq[None])[0, -1]
            if not (_certified(logits, r.generated[t])
                    and _certified(logits, other[t])):
                raise AssertionError(
                    f"{label}: request {r.rid} leaves the other stream at "
                    f"token {t} ({r.generated[t]} vs {other[t]}), which is "
                    "not a certified tie")
            ties += 1
    return ties


@contextlib.contextmanager
def _quantized_rows():
    """Record every (rows, int8 payload, scale) that the int8 pool
    quantizes while the block runs."""
    seen = []
    quant = kv_cache._quant_rows

    def record(x):
        q, scale = quant(x)
        seen.append((x.float(), q, scale))
        return q, scale

    kv_cache._quant_rows = record
    try:
        yield seen
    finally:
        kv_cache._quant_rows = quant


def _int8_check(model, prompt) -> tuple[float, float, float]:
    """One prompt prefilled into an fp32 pool and an int8 pool (two paged
    engines on the same weights). Every written position's dequantized
    K/V lies within scale / 2 (plus QUANT_RTOL of the value) of the rows
    the int8 path quantized; at layer 0, where both pools saw the same
    inputs, those rows are the fp32 pool's. Returns (worst error, the
    ``serve.kv.quant_error`` maximum, the largest |int8 - fp32| over later
    layers, where the int8 path's own rounding has moved the inputs)."""
    ln, ps = LM["seq_len"], 16
    plen = len(prompt)
    engines = {}
    for dtype in ("fp32", "int8"):
        engines[dtype] = ServeEngine(model, max_batch=8, max_len=ln,
                                     paged=True, kv_dtype=dtype)
        metrics.get_registry().reset()
        engines[dtype].submit(prompt, max_new_tokens=4)
        with _quantized_rows() as seen:
            engines[dtype].step()  # the prefill and one decode step
        if dtype == "int8":
            qerr_max = metrics.get_registry().snapshot()[
                "distributions"]["serve.kv.quant_error"]["max"]
            rows = seen[:2 * LM["depth"]]  # the prefill's k and v, in order
    pools = {d: e.cache for d, e in engines.items()}
    table = {d: torch.tensor(e._paging.allocator.table[0], device="cuda")
             for d, e in engines.items()}
    worst, later = 0.0, 0.0
    with torch.inference_mode():
        for i, (x, q, scale) in enumerate(rows):
            layer, name = divmod(i, 2)
            name = "kv"[name]
            x, q, scale = x[:plen], q[:plen], scale[:plen]  # [plen, H, dk]
            deq = q.float() * scale[..., None]
            err = (x - deq).abs()
            bound = scale[..., None] / 2 + QUANT_RTOL * x.abs()
            if not bool((err <= bound).all()):
                raise AssertionError(f"int8 layer {layer} {name}: dequantized "
                                     "values off by more than half a step")
            worst = max(worst, float(err.max()))
            # What the pool holds is what was quantized, and (layer 0) the
            # rows are the fp32 pool's.
            got = kv_cache._gather_kv(pools["int8"], name, layer,
                                      table["int8"])[:, :plen].movedim(0, 1)
            torch.testing.assert_close(got, deq, atol=0, rtol=0)
            ref = kv_cache._gather_kv(pools["fp32"], name, layer,
                                      table["fp32"])[:, :plen].movedim(0, 1)
            if layer == 0:
                torch.testing.assert_close(x, ref, atol=0, rtol=QUANT_RTOL)
            else:
                later = max(later, float((deq - ref).abs().max()))
    if abs(worst - qerr_max) > 1e-6:
        raise AssertionError(f"serve.kv.quant_error max {qerr_max} is not the "
                             f"worst dequantization error {worst}")
    return worst, qerr_max, later


def _decode_step_times(plan, dtype=None) -> dict:
    """The decode step at bucket 8 with every slot at 448 positions: the
    contiguous cache (``dtype`` None) or a pool of 256 pages (32 a slot,
    fp32 or int8), timed with CUDA events and in device time."""
    ln, ps, b, pos = LM["seq_len"], 16, 8, 448
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, LM["vocab_size"], (b,), device="cuda",
                           generator=gen)
    lengths = torch.full((b,), pos, device="cuda")
    if dtype is None:
        cache = kv_cache.init_cache(plan, max_batch=b, max_len=ln,
                                    device="cuda")
        step = lambda: kv_cache.decode_step(plan, cache, tokens, lengths,
                                            bucket=b)
    else:
        cache = kv_cache.init_page_pool(plan, num_pages=b * ln // ps,
                                        page_size=ps, dtype=dtype,
                                        device="cuda")
        tables = torch.arange(b * ln // ps, device="cuda",
                              dtype=torch.int32).reshape(b, ln // ps)
        step = lambda: kv_cache.paged_decode_step(plan, cache, tables,
                                                  tokens, lengths, bucket=b)
    with torch.inference_mode():
        ms = _time_ms(step)
        kernels = _kernel_times(step, 20)
    total_us = sum(us for _, us in kernels)
    return {"ms": ms, "device_ms": total_us / 1e3 / 20 if total_us else None,
            "top": [(name[:48], us / 20) for name, us in kernels[:3]]}


def paged_phase(card: str, contiguous_streams: list) -> dict:
    """Phase 18: the paged engine at full width; returns its numbers."""
    model = _serve_lm()
    plan = kv_cache.build_plan(model)
    specs = _serve_specs()
    ln = LM["seq_len"]
    times = {}
    metrics.enable()
    try:
        # (a) Cold paged streams: phase 4's requests.
        engine = ServeEngine(model, max_batch=8, max_len=ln, paged=True)
        fa.flash_attention_fwd.launches = 0
        reqs, times["paged fp32"] = _drain(engine, specs)
        launches = fa.flash_attention_fwd.launches
        if launches:
            raise AssertionError(f"the paged run launched the flash kernel "
                                 f"{launches} times; its prefill is dense")
        _certify(model, reqs, "(a) paged")
        ties = _ties(model, reqs, contiguous_streams, "(a) paged")
        paged_streams = [r.generated for r in reqs]
        pool = kv_cache.page_pool_nbytes(plan, num_pages=engine.num_pages,
                                         page_size=16)
        log(f"[18 paged] (a) 16 requests through ServeEngine(paged=True), "
            f"{engine.num_pages} pages of 16 + scratch ({pool} B): all done, "
            f"every token the full forward's greedy choice; streams equal "
            f"phase 4's but {ties} leaving it at a certified tie; flash "
            f"launches {launches}")

        # (b) Prefix caching: a warm request, then 8 sharing its prefix.
        rng = np.random.default_rng(18)
        prefix = rng.integers(0, LM["vocab_size"], size=256).tolist()
        warm = [(prefix + rng.integers(0, LM["vocab_size"],
                                       size=16).tolist(), 16)]
        shared = [(prefix + rng.integers(0, LM["vocab_size"], size=int(
            rng.integers(16, 65))).tolist(), int(rng.integers(16, 33)))
            for _ in range(8)]
        runs = {}
        # In turns, twice: the second of each is kept (the first pays the
        # first use of the suffixes' shapes).
        for caching in (True, False, True, False):
            engine = ServeEngine(model, max_batch=8, max_len=ln, paged=True,
                                 prefix_caching=caching)
            _drain(engine, warm)
            reqs, t = _drain(engine, shared)
            snap = metrics.get_registry().snapshot()
            runs[caching] = (reqs, t, snap)
        reqs, t_hit, snap = runs[True]
        hits = snap["counters"].get("serve.prefix.hits", 0)
        skipped = snap["distributions"]["serve.prefill.skipped_tokens"]
        if hits < 8 or not skipped["sum"] > 0:
            raise AssertionError(f"(b) prefix hits {hits}, skipped tokens "
                                 f"{skipped['sum']}")
        _certify(model, reqs, "(b) prefix hits")
        b_ties = _ties(model, reqs, [r.generated for r in runs[False][0]],
                       "(b) prefix caching on vs off")
        times["prefix hits"], times["prefix off"] = t_hit, runs[False][1]
        log(f"[18 paged] (b) 8 requests sharing a 256-token prefix: "
            f"{hits} hits, {int(skipped['sum'])} prefill tokens skipped; "
            f"streams equal to prefix_caching=False but {b_ties} certified "
            f"ties; TTFT p50 {t_hit['ttft_p50_ms']:.3f} ms with hits vs "
            f"{runs[False][1]['ttft_p50_ms']:.3f} ms cold ({card})")

        # (c) Chunked prefill, paged and contiguous.
        want_chunks = sum(-(-len(p) // PAGED_CHUNK) for p, _ in specs)
        for paged, want in ((True, paged_streams),
                            (False, contiguous_streams)):
            engine = ServeEngine(model, max_batch=8, max_len=ln, paged=paged,
                                 prefill_chunk=PAGED_CHUNK)
            reqs, times[f"chunked {'paged' if paged else 'contiguous'}"] = \
                _drain(engine, specs)
            chunks = _counter("serve.prefill.chunks")
            if chunks != want_chunks:
                raise AssertionError(f"(c) {chunks} chunks, expected "
                                     f"{want_chunks}")
            c_ties = _ties(model, reqs, want, "(c) chunked")
            log(f"[18 paged] (c) prefill_chunk={PAGED_CHUNK}, "
                f"{'paged' if paged else 'contiguous'}: {chunks} chunks = "
                f"sum of ceil(len / {PAGED_CHUNK}); streams equal to the "
                f"unchunked ones but {c_ties} certified ties")

        # (d) int8 pages.
        engine = ServeEngine(model, max_batch=8, max_len=ln, paged=True,
                             kv_dtype="int8")
        reqs, times["paged int8"] = _drain(engine, specs)
        int8_streams = [r.generated for r in reqs]
        same = sum(a == b for r, want in zip(reqs, paged_streams)
                   for a, b in zip(r.generated, want))
        total = sum(len(w) for w in paged_streams)
        worst, qerr_max, later = _int8_check(model, specs[0][0])
        page = kv_cache.page_nbytes(plan, page_size=16, dtype=torch.int8)
        log(f"[18 paged] (d) kv_dtype='int8' ({page} B a page): all done; "
            f"dequantized K/V within scale/2 of the rows quantized, worst "
            f"{worst:.6g} = serve.kv.quant_error max {qerr_max:.6g}; layer 0 "
            f"rows equal the fp32 pool's (later layers' |int8 - fp32| "
            f"{later:.6g}); {same}/{total} tokens equal (a)'s (not gated)")

        # (e) A fixed budget: the contiguous cache of 8 slots x 512.
        budget = kv_cache.cache_nbytes(plan, max_batch=8, max_len=ln)
        try:
            ServeEngine(model, max_batch=9, max_len=ln, budget_bytes=budget)
        except ValueError as e:
            if "fits 8 slot(s)" not in str(e):
                raise
            refused = str(e)
        else:
            raise AssertionError("(e) a contiguous 9-slot cache fit the "
                                 "8-slot budget")
        engine = ServeEngine(model, max_batch=32, max_len=ln, paged=True,
                             budget_bytes=budget)
        rng = np.random.default_rng(19)
        backlog = [(rng.integers(0, LM["vocab_size"], size=int(
            rng.integers(16, 65))).tolist(), int(rng.integers(16, 33)))
            for _ in range(48)]
        metrics.get_registry().reset()
        reqs = [engine.submit(p, max_new_tokens=m) for p, m in backlog]
        peak = 0
        while not engine.scheduler.idle():
            engine.step()
            peak = max(peak, engine.scheduler.num_active)
        if not all(r.status == DONE for r in reqs) or peak < 16:
            raise AssertionError(f"(e) peak {peak} concurrent (need >= 16), "
                                 f"{sum(r.status == DONE for r in reqs)}/48 "
                                 "done")
        log(f"[18 paged] (e) budget {budget} B: {engine.num_pages} pages; "
            f"48 requests through max_batch=32, all done, peak {peak} "
            f"concurrent (>= 16, twice the contiguous engine's 8); a "
            f"contiguous 9-slot engine refuses: {refused[:60]}...")

        # (f) Times of (a)'s requests in turns, twice; the second round is
        # kept.
        for _ in range(2):
            for name, kw in (("contiguous", {}),
                             ("paged fp32", {"paged": True}),
                             ("paged int8", {"paged": True,
                                             "kv_dtype": "int8"})):
                _, times[name] = _drain(
                    ServeEngine(model, max_batch=8, max_len=ln, **kw), specs)
        for name in ("contiguous", "paged fp32", "paged int8",
                     "chunked contiguous", "chunked paged", "prefix hits",
                     "prefix off"):
            t = times[name]
            log(f"[18 times] serve {name}: {t['tok_s']:.1f} tok/s, TTFT p50 "
                f"{t['ttft_p50_ms']:.3f} ms, latency p50 "
                f"{t['latency_p50_ms']:.3f} ms ({card}; host clock)")
        steps = {"contiguous": _decode_step_times(plan),
                 "paged fp32": _decode_step_times(plan, torch.float32),
                 "paged int8": _decode_step_times(plan, torch.int8)}
        for name, t in steps.items():
            dev = ("not measured" if t["device_ms"] is None
                   else f"{t['device_ms']:.4f} ms "
                        f"({t['device_ms'] / t['ms'] * 100:.1f} % busy)")
            top = "; ".join(f"{k} {us:.1f} us" for k, us in t["top"])
            log(f"[18 times] decode step, bucket 8 at 448 positions, {name}: "
                f"{t['ms']:.4f} ms (CUDA events), device {dev} "
                f"(torch.profiler; most device time: {top}) ({card})")
    finally:
        metrics.disable()
    return {"serve": times, "decode_step": steps, "ties": ties,
            "streams": {"fp32": paged_streams, "int8": int8_streams}}


def paged_cli_phase() -> None:
    """``python -m tpu_dist_torch.serve --bench --paged`` (and with
    ``--kv-dtype int8``) at phase 5's full-width arguments."""
    for extra in ([], ["--kv-dtype", "int8"]):
        argv = ["--bench", "--paged", *extra, "--requests", "8",
                "--max-len", str(LM["seq_len"]), "--vocab",
                str(LM["vocab_size"]), "--d-model", str(LM["d_model"]),
                "--depth", str(LM["depth"]), "--num-heads",
                str(LM["num_heads"]), "--min-new", "8", "--max-new", "16"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        report = json.loads(out.getvalue())
        if rc != 0 or not report["ok"] or report["completed"] != 8:
            raise AssertionError(f"paged serve CLI failed: rc {rc}, {report}")
        log(f"[18 cli] python -m tpu_dist_torch.serve --bench --paged "
            f"{' '.join(extra)}: 8 done, {report['throughput_tok_s']} tok/s, "
            f"TTFT p50 {report['ttft_s']['p50']} s on {report['device']}")


# -- slice 8: CUDA graphs, ragged decode, steps_per_execution ---------------

#: The reference's serve-bench gate on prefix caching: TTFT p50 with hits at
#: or under half of cold. Reported beside the port's ratio, not asserted.
PREFIX_TTFT_GATE = 0.5
#: Phase 20's graphed CNN parameters against k = 1's after 200 steps: the
#: replays run the kernels of the eager steps on the same inputs, so any
#: difference is cuBLAS or cuDNN choosing otherwise on the capture stream;
#: at lr 0.001 such a choice moves a weight by well under 1e-6.
GRAPH_PARAM_ATOL = 1e-6
#: Phase 20 (c): executions of the full-width LM at k = 2 (the first
#: eager, the second captured and replayed, the rest replays), and its final
#: parameters against k = 1's: the same kernels on the same inputs, as for
#: the CNN.
LM_GRAPH_EXECUTIONS = 3
LM_GRAPH_PARAM_ATOL = 1e-6


def _filled(shape, dtype, gen):
    """Seeded values for a cache or pool entry: int8 payloads, positive
    scales, normal floats."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device="cuda")


def _fresh_state(plan, kind: str):
    """A contiguous 8 x 512 cache, or a 256-page pool (fp32 or int8),
    filled with the same seeded values on every call."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    if kind == "cache":
        state = kv_cache.init_cache(plan, max_batch=8, max_len=LM["seq_len"],
                                    device="cuda")
    else:
        state = kv_cache.init_page_pool(
            plan, num_pages=256, page_size=16, device="cuda",
            dtype=torch.int8 if kind == "int8" else torch.float32)
    for name, a in state.items():
        vals = _filled(a.shape, a.dtype, gen)
        a.copy_(vals.abs() / 64 if name.endswith("_scale") else vals)
    return state


def _replay_check(name, plan, kind, fn, calls) -> int:
    """One program family's captured program against its eager function:
    ``fn(state, **inputs)`` runs the kv_cache function; ``calls`` are host
    inputs (numpy arrays and ints), the first run eagerly, the second
    captured and replayed, the third replayed. Each call's outputs and the
    cache or pool bytes equal the eager function's on the same inputs (ints
    as ints) bit for bit, a pool's scratch row aside (padding and inactive
    rows write there, in no fixed order). Returns the replays."""
    import functools

    from tpu_dist_torch.utils.graphs import CapturedProgram, spec_of

    eager, graphed = _fresh_state(plan, kind), _fresh_state(plan, kind)
    prog = CapturedProgram(functools.partial(fn, graphed),
                           {n: spec_of(v) for n, v in calls[0].items()},
                           device="cuda")
    with torch.inference_mode():
        for i, call in enumerate(calls):
            got = prog(**call)
            got = [t.clone() for t in (got if isinstance(got, tuple)
                                       else (got,))]
            want = fn(eager, **{n: torch.from_numpy(v).cuda()
                                if isinstance(v, np.ndarray) else v
                                for n, v in call.items()})
            for g, w in zip(got, want if isinstance(want, tuple)
                            else (want,)):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"(a) {name}: call {i + 1}'s output differs from the "
                        f"eager function's by {float((g - w).abs().max())}")
            for key in eager:
                a, b = eager[key], graphed[key]
                if kind != "cache":
                    a, b = a[:, :-1], b[:, :-1]
                if not torch.equal(a, b):
                    raise AssertionError(f"(a) {name}: call {i + 1} left "
                                         f"{key} unlike the eager function")
    return prog.replays


def _family_checks(plan) -> list:
    """Phase 19 (a): every program family the engine captures."""
    ln, vocab = LM["seq_len"], LM["vocab_size"]
    rng = np.random.default_rng(20)
    tok = lambda n: rng.integers(0, vocab, size=n)
    tables = rng.permutation(256).astype(np.int32).reshape(8, 32)
    lengths = lambda: rng.integers(0, 448, size=8)
    active = np.array([1, 1, 0, 1, 0, 1, 1, 0], bool)  # 2, 4, 7: inactive
    decode = [dict(tokens=tok(8), lengths=lengths()) for _ in range(3)]
    paged = [dict(page_tables=tables, **d) for d in decode]
    ragged = [dict(active=active, **d) for d in paged]
    prefill = [dict(tokens=tok(256), length=n, slot=s)
               for n, s in ((200, 3), (256, 0), (131, 7))]
    chunk = [dict(tokens=tok(64), length=n, slot=s, start=st)
             for n, s, st in ((114, 2, 64), (192, 5, 128), (40, 0, 0))]
    suffix = [dict(page_row=tables[s], tokens=tok(64), length=n, start=st)
              for n, s, st in ((104, 1, 64), (50, 4, 0), (300, 6, 256))]
    families = [
        ("decode bucket 8", "cache", lambda c, tokens, lengths:
         kv_cache.decode_step(plan, c, tokens, lengths, bucket=8), decode),
        ("prefill pad 256", "cache", lambda c, tokens, length, slot:
         kv_cache.prefill(plan, c, tokens, length, slot), prefill),
        ("prefill_chunk pad 64", "cache", lambda c, **kw:
         kv_cache.prefill_chunk_step(plan, c, **kw), chunk)]
    for kind in ("fp32", "int8"):
        families += [
            (f"paged_decode bucket 8 {kind}", kind, lambda c, **kw:
             kv_cache.paged_decode_step(plan, c, bucket=8, **kw), paged),
            (f"paged_decode_ragged {kind}", kind, lambda c, **kw:
             kv_cache.paged_decode_ragged(plan, c, **kw), ragged),
            (f"paged_prefill pad 64 {kind}", kind, lambda c, **kw:
             kv_cache.paged_prefill(plan, c, **kw), suffix)]
    return [(name, _replay_check(name, plan, kind, fn, calls))
            for name, kind, fn, calls in families]


def _graphed_decode_times(plan, kind: str) -> dict:
    """Phase 18 (f)'s decode step (bucket 8, every slot at 448 positions)
    through a captured program fed from the host, as the engine runs it:
    staging, copies to the card and the replay, timed with CUDA events and
    in device time."""
    import functools

    from tpu_dist_torch.utils.graphs import CapturedProgram, spec_of

    state = _fresh_state(plan, kind)
    host = dict(tokens=np.random.default_rng(3).integers(
        0, LM["vocab_size"], size=8), lengths=np.full(8, 448))
    if kind == "cache":
        fn = functools.partial(kv_cache.decode_step, plan, state, bucket=8)
    else:
        host["page_tables"] = np.arange(256, dtype=np.int32).reshape(8, 32)
        fn = functools.partial(kv_cache.paged_decode_step, plan, state,
                               bucket=8)
    prog = CapturedProgram(fn, {n: spec_of(v) for n, v in host.items()},
                           device="cuda")
    step = lambda: prog(**host)
    with torch.inference_mode():
        ms = _time_ms(step)
        kernels = _kernel_times(step, 20)
    total_us = sum(us for _, us in kernels)
    return {"ms": ms, "device_ms": total_us / 1e3 / 20 if total_us else None}


def _flash_graph_times() -> list:
    """ROADMAP K1: the flash forward at serving's prefill shapes [8, L, 64]
    fp32 causal, L = 512, 256, 128, called through its wrapper, replayed
    from a captured program (the wrapper's host work gone), and SDPA's
    call, in turns in one window each; CUDA events."""
    from tpu_dist_torch.utils.graphs import CapturedProgram

    out = []
    for ln in (512, 256, 128):
        q, k, v = _qkv((1, 8, ln, 64), torch.float32, seed=ln)
        call = lambda: fa.flash_attention_fwd(q, k, v, causal=True,
                                              scale=0.125)
        prog = CapturedProgram(call, {}, device="cuda")
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)
        out.append((ln, _time_ms(call), _time_ms(prog), _time_ms(sdpa)))
    return out


def _admission_device_ms(engine, warm, shared) -> float | None:
    """Device time of the step that admits ``shared`` (its 8 prefills and
    one decode step) after ``warm`` ran, from a ``torch.profiler`` trace;
    None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    _drain(engine, warm)
    for p, m in shared:
        engine.submit(p, max_new_tokens=m)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    engine.run_until_idle()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 if us else None


def _prefix_ttft(model, caching: bool) -> tuple:
    """Phase 18 (b)'s prefix run on an engine whose programs are captured
    first: two warm-up rounds of the same shapes under other prefixes, then
    the warm request and the 8 sharers. Returns the sharers' times, the
    warm-up's capture seconds, the measured run's, and the device ms of
    one more such admission step, profiled."""
    ln, vocab = LM["seq_len"], LM["vocab_size"]

    def backlog(seed):
        rng = np.random.default_rng(seed)
        prefix = rng.integers(0, vocab, size=256).tolist()
        warm = [(prefix + rng.integers(0, vocab, size=16).tolist(), 16)]
        shared = [(prefix + rng.integers(0, vocab, size=int(
            rng.integers(16, 65))).tolist(), int(rng.integers(16, 33)))
            for _ in range(8)]
        return warm, shared

    engine = ServeEngine(model, max_batch=8, max_len=ln, paged=True,
                         prefix_caching=caching)
    lengths = [(len(p), m) for p, m in backlog(18)[1]]
    for seed in (118, 218):
        warm, _ = backlog(seed)
        rng = np.random.default_rng(seed)
        shared = [(warm[0][0][:256] + rng.integers(0, vocab, size=n - 256)
                   .tolist(), m) for n, m in lengths]
        _drain(engine, warm)
        _drain(engine, shared)
    warmup_s = engine.capture_seconds
    warm, shared = backlog(18)
    _drain(engine, warm)
    _, t = _drain(engine, shared)
    measured_s = engine.capture_seconds - warmup_s
    warm, _ = backlog(318)
    rng = np.random.default_rng(318)
    shared = [(warm[0][0][:256] + rng.integers(0, vocab, size=n - 256)
               .tolist(), m) for n, m in lengths]
    return (t, warmup_s, measured_s,
            _admission_device_ms(engine, warm, shared))


def graph_serve_phase(card: str, paged: dict) -> None:
    """Phase 19: serving on captured graphs at full width."""
    model = _serve_lm().cuda().eval()
    plan = kv_cache.build_plan(model)
    specs = _serve_specs()
    ln = LM["seq_len"]
    checks = _family_checks(plan)
    log(f"[19 graphs] (a) one replay equals the eager kv_cache function, "
        f"outputs and cache/pool bytes bit for bit (a pool's scratch row "
        f"aside), for {len(checks)} program families: "
        f"{', '.join(f'{n} ({r} replays)' for n, r in checks)}")
    metrics.enable()
    try:
        for kv in ("fp32", "int8"):
            engine = ServeEngine(model, max_batch=8, max_len=ln, paged=True,
                                 ragged=True, kv_dtype=kv)
            fa.flash_attention_fwd.launches = 0
            reqs, t = _drain(engine, specs)
            want = paged["streams"][kv]
            if kv == "fp32":
                ties = _ties(model, reqs, want, f"(b) ragged {kv}")
            elif [r.generated for r in reqs] != want:
                raise AssertionError("(b) ragged int8 streams differ from "
                                     "phase 18 (d)'s bucketed ones")
            else:
                ties = 0
            steps = _counter("serve.decode.steps")
            decode = [p for (family, _), p in engine.programs.items()
                      if family == "paged_decode"]
            if (len(decode) != 1 or decode[0].calls != steps
                    or decode[0].replays != steps - 1
                    or engine.compiled_programs()["paged_decode"] != [8]
                    or fa.flash_attention_fwd.launches):
                raise AssertionError(
                    f"(b) ragged {kv}: {len(decode)} decode programs, "
                    f"{steps} steps, {engine.compiled_programs()}, flash "
                    f"launches {fa.flash_attention_fwd.launches}")
            graphs_n = sum(p.graph is not None
                           for p in engine.programs.values())
            log(f"[19 graphs] (b) phase 4's 16 requests through "
                f"ServeEngine(paged=True, ragged=True, kv_dtype='{kv}'): "
                f"streams equal phase 18's bucketed paged streams, {ties} "
                f"certified ties; one decode program, {decode[0].calls} "
                f"calls = {steps} decode steps, {decode[0].replays} replays "
                f"(the first call ran eagerly and the second captured); "
                f"{graphs_n} graphs captured in "
                f"{engine.capture_seconds:.3f} s; {t['tok_s']:.1f} tok/s, "
                f"TTFT p50 {t['ttft_p50_ms']:.3f} ms, captures included "
                f"({card}; host clock)")
        eager = paged["decode_step"]
        for kind, name in (("cache", "contiguous"), ("fp32", "paged fp32"),
                           ("int8", "paged int8")):
            g, e = _graphed_decode_times(plan, kind), eager[name]
            busy = lambda t: (
                "device not measured" if t["device_ms"] is None else
                f"device {t['device_ms']:.4f} ms "
                f"({t['device_ms'] / t['ms'] * 100:.1f} % busy)")
            log(f"[19 times] decode step, bucket 8 at 448 positions, {name}:"
                f" graph {g['ms']:.4f} ms (CUDA events; staging, copies and "
                f"replay), {busy(g)}; "
                f"eager (phase 18 f) {e['ms']:.4f} ms, {busy(e)} ({card})")
        for ln, wrapper, replay, sdpa in _flash_graph_times():
            log(f"[19 times] flash forward [8, {ln}, 64] fp32 causal: "
                f"wrapper {wrapper:.4f} ms, captured and replayed "
                f"{replay:.4f} ms, SDPA {sdpa:.4f} ms (CUDA events; {card})")
        runs = {}
        for caching in (True, False, True, False):
            runs[caching] = _prefix_ttft(model, caching)
        (hit, warm_s, hit_s, hit_dev), (cold, cold_warm_s, cold_s,
                                         cold_dev) = runs[True], runs[False]
        ratio = hit["ttft_p50_ms"] / cold["ttft_p50_ms"]
        dev = ("not measured" if hit_dev is None or cold_dev is None else
               f"{hit_dev:.3f} ms with hits vs {cold_dev:.3f} ms cold = "
               f"{hit_dev / cold_dev:.3f}x")
        log(f"[19 times] prefix hits on captured programs: TTFT p50 "
            f"{hit['ttft_p50_ms']:.3f} ms with hits vs "
            f"{cold['ttft_p50_ms']:.3f} ms cold = {ratio:.3f}x (the "
            f"reference's serve-bench gate: <= {PREFIX_TTFT_GATE}x; "
            f"reported, not asserted); captures {warm_s:.3f} s / "
            f"{cold_warm_s:.3f} s in the warm-ups, {hit_s:.3f} s / "
            f"{cold_s:.3f} s in the measured runs; second of two rounds in "
            f"turns ({card}; host clock); device time of the step that "
            f"admits the 8 (8 prefills, 1 decode step; torch.profiler): "
            f"{dev}")
    finally:
        metrics.disable()


def _cnn_device_busy(batch, k: int, fused_on: bool) -> tuple:
    """(ms per CNN train step, device ms per step or None) at ``k`` steps
    an execution: phase 17's measure (the batch on the card), through
    ``make_train_function(k)`` on k stacked copies of it."""
    model = build_cnn_model()
    model.compile(optimizer=SGD(learning_rate=0.001, fused=fused_on),
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=fused_on),
                  metrics=[SparseCategoricalAccuracy()])
    fn, state = model.make_train_function(k), model.train_state()
    xs, ys = (torch.stack([a] * k) if k > 1 else a for a in batch)
    step = lambda: fn(*state, xs, ys)
    windows = max(1, 20 // k)
    ms = _time_ms(step, runs=11, per_run=windows) / k
    dev = _device_ms(step, windows)
    return ms, None if dev is None else dev / k


def _lm_k_run(make_opt, k: int, batches) -> tuple[list, tuple, list]:
    """The full-width LM through ``make_train_function(k)`` over
    ``batches``, k at a time; returns the executions' losses, the launch
    counts and the final parameters."""
    model = _compiled_lm(make_opt())
    fn, state = model.make_train_function(k), model.train_state()
    _reset_counts()
    losses = []
    for i in range(0, len(batches), k):
        group = batches[i:i + k]
        if k == 1:
            losses.append(fn(*state, *group[0]))
        else:
            losses.append(fn(*state, torch.stack([x for x, _ in group]),
                             torch.stack([y for _, y in group])))
    losses = [float(v) for v in losses]
    counts = _counts()
    params = [p.detach().clone() for p in model.parameters()]
    del model, fn, state
    torch.cuda.empty_cache()
    return losses, counts, params


def graph_train_phase(card: str, k1: dict) -> None:
    """Phase 20: training on captured graphs."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    steps = CNN_EPOCHS * CNN_STEPS
    try:
        for fused_on in (True, False):
            name = "fused" if fused_on else "unfused"
            _reset_counts()
            t0 = time.monotonic()
            model, h = _cnn_fit(SGD(learning_rate=0.001, fused=fused_on),
                                fused_on, CNN_EPOCHS, seed=0, k=CNN_STEPS)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = _counts()
            want = (0, 0, 0) + ((steps,) * 3 if fused_on else (0, 0, 0))
            if counts != want:
                raise AssertionError(f"(a) CNN {name} at k = {CNN_STEPS}: "
                                     f"launches {counts}; expected {want}")
            loss1, params1 = k1[name]
            loss_diff = max(abs(a - b) for a, b in zip(h["loss"], loss1))
            param_diff = max(float((p.detach() - q).abs().max())
                             for p, q in zip(model.parameters(), params1))
            if loss_diff > CNN_LOSS_ATOL or param_diff > GRAPH_PARAM_ATOL:
                raise AssertionError(
                    f"(a) CNN {name} at k = {CNN_STEPS}: losses off k = 1's "
                    f"by {loss_diff:.3e} (atol {CNN_LOSS_ATOL:g}), params by "
                    f"{param_diff:.3e} (atol {GRAPH_PARAM_ATOL:g})")
            (graphed,) = model._trainer._graphed.values()
            ((prog, _),) = graphed.programs.values()
            log(f"[20 graphs] (a) the program, {name}, "
                f"steps_per_execution={CNN_STEPS}, {CNN_EPOCHS} x "
                f"{CNN_STEPS} steps of {CNN_BATCH} in {wall:.3f} s: "
                f"{prog.calls} executions ({prog.replays} replays of one "
                f"graph captured in {prog.capture_s:.3f} s); losses "
                f"{[round(v, 6) for v in h['loss']]}, max |diff| to k = 1 "
                f"{loss_diff:.3e} (atol {CNN_LOSS_ATOL:g}), params "
                f"{param_diff:.3e} (atol {GRAPH_PARAM_ATOL:g}); launches CE "
                f"fwd {counts[3]}, CE bwd {counts[4]}, SGD {counts[5]}")
            del model
        x, y = next(iter(_program_chain(0)))
        batch = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
        for fused_on in (True, False):
            for k in (1, CNN_STEPS):
                ms, dev = _cnn_device_busy(batch, k, fused_on)
                busy = ("not measured" if dev is None else
                        f"device {dev:.4f} ms/step ({dev / ms * 100:.1f} % "
                        f"busy)")
                log(f"[20 times] CNN train step, batch {CNN_BATCH}, "
                    f"{'fused' if fused_on else 'unfused'}, k = {k}: "
                    f"{ms:.4f} ms/step = {CNN_BATCH / ms * 1e3:.1f} images/s;"
                    f" {busy} (torch.profiler) ({card})")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    x, y = _bench_tokens(TRAIN_BATCH)
    batches = [(torch.roll(x, i, 0), torch.roll(y, i, 0))
               for i in range(2 * LM_GRAPH_EXECUTIONS)]
    depth, n = LM["depth"], len(batches)
    for name, make, adam in (
            ("SGD(learning_rate=0.001)", lambda: SGD(learning_rate=0.001),
             False),
            ("Adam(fused=True)", lambda: Adam(fused=True), True)):
        one, c1, p1 = _lm_k_run(make, 1, batches)
        two, c2, p2 = _lm_k_run(make, 2, batches)
        pairs = [(one[i] + one[i + 1]) / 2 for i in range(0, n, 2)]
        want = (depth * n, depth * n, n if adam else 0, 0, 0, 0)
        if c1 != want or c2 != want:
            raise AssertionError(f"(c) LM {name}: launches {c1} (k = 1), "
                                 f"{c2} (k = 2); expected {want}")
        np.testing.assert_allclose(two, pairs, atol=LOSS_ATOL, rtol=0,
                                   err_msg=f"(c) LM {name} at k = 2")
        leaf_diffs = [float((a - b).abs().max()) for a, b in zip(p2, p1)]
        param_diff = max(leaf_diffs)
        if param_diff > LM_GRAPH_PARAM_ATOL:
            raise AssertionError(
                f"(c) LM {name} at k = 2: parameters off k = 1's by "
                f"{param_diff:.3e} (atol {LM_GRAPH_PARAM_ATOL:g}); per leaf "
                f"{[f'{d:.2e}' for d in leaf_diffs]}")
        log(f"[20 graphs] (c) full-width LM, {name}, steps_per_execution=2,"
            f" {len(two)} executions (the first eager, then a capture and "
            f"{len(two) - 1} replays): losses {[round(v, 6) for v in two]} "
            f"vs k = 1's pair means {[round(v, 6) for v in pairs]} (max "
            f"|diff| {max(abs(a - b) for a, b in zip(two, pairs)):.2e}, "
            f"atol {LOSS_ATOL:g}); final parameters, {len(p2)} leaves, max "
            f"|diff| to k = 1 {param_diff:.3e} (atol "
            f"{LM_GRAPH_PARAM_ATOL:g}; {sum(d == 0 for d in leaf_diffs)} "
            f"leaves bit-identical); launches (flash fwd, flash bwd, Adam, "
            f"CE fwd, CE bwd, SGD) {c2}")



#: Phase 21's source for the upload at MNIST's real scale: the synthetic
#: MNIST at 60,000 images (47 MB as uint8).
MNIST_TRAIN = 60000


def _scale_div(image, label):
    """The reference program's map: x / 255 in float32."""
    return np.asarray(image, np.float32) / 255.0, label


def _scale_mul(image, label):
    return np.asarray(image, np.float32) * np.float32(1.0 / 255.0), label


def _chain(shuffle: bool, seed=None, scale=_scale_div, size=None):
    """The reference program's chain (load -> map -> cache -> shuffle? ->
    batch, OFF). Unseeded and unshuffled chains are promoted to the card
    by ``fit``; a seeded one stays on the host path."""
    ds = td_data.load("mnist", split="train", synthetic_size=size).map(
        scale).cache()
    if shuffle:
        ds = ds.shuffle(10000, seed=seed)
    options = td_data.Options()
    options.experimental_distribute.auto_shard_policy = \
        td_data.AutoShardPolicy.OFF
    return ds.batch(CNN_BATCH).with_options(options)


def _fused_fit(x, *, k: int = 1, prefetch: int = 0, epochs: int = CNN_EPOCHS,
               model=None):
    """The reference program's strategy and CNN with phase 15's fused
    compile, fit on ``x``; returns (model, History dict)."""
    if model is None:
        strategy = MultiWorkerMirroredStrategy()
        with strategy.scope():
            model = build_cnn_model()
            model.compile(optimizer=SGD(learning_rate=0.001, fused=True),
                          loss=SparseCategoricalCrossentropy(
                              from_logits=True, fused=True),
                          metrics=[SparseCategoricalAccuracy()],
                          steps_per_execution=k, prefetch_to_device=prefetch)
    h = model.fit(x, epochs=epochs, steps_per_epoch=CNN_STEPS, verbose=0)
    return model, h.history


def _params(model) -> list:
    return [p.detach().clone() for p in model.parameters()]


def _max_diff(a, b) -> float:
    return max(float((p - q).abs().max()) for p, q in zip(a, b))


@contextlib.contextmanager
def _numpy_loader():
    """The native loader's numpy path, as on a machine without g++."""
    load = native._load
    native._load = lambda: None
    try:
        yield
    finally:
        native._load = load


def _htod_copies(fn, kind: str = "HtoD") -> list | None:
    """The sizes in bytes of the copies the card received from the host
    while ``fn`` ran (the ``Memcpy HtoD`` records of a ``torch.profiler``
    trace; with ``kind="DtoH"``, those it sent the host), or None when the
    trace gives no sizes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    copies = [e for e in events if kind in str(e.get("name", ""))
              and e.get("ph") == "X"]
    if not copies or any("bytes" not in e.get("args", {}) for e in copies):
        return None
    return [int(e["args"]["bytes"]) for e in copies]


def _host_ms_per_batch(batches, count: int) -> float:
    it = iter(batches)
    next(it)
    t0 = time.perf_counter()
    for _ in range(count):
        next(it)
    return (time.perf_counter() - t0) / count * 1e3


def _fit_step_times(make_x, k: int) -> tuple:
    """(ms a step of ``fit`` on the host clock, device ms a step or None)
    for the fused CNN at ``k`` steps an execution: two warm-up epochs (a
    k > 1 execution's first run is eager, its second captures), then 5
    epochs timed and 2 profiled."""
    x = make_x()
    model, _ = _fused_fit(x, k=k, epochs=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _fused_fit(x, epochs=5, model=model)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (5 * CNN_STEPS) * 1e3
    dev = _device_ms(lambda: _fused_fit(x, epochs=1, model=model), 1)
    return ms, None if dev is None else dev / CNN_STEPS


def data_phase(card: str) -> None:
    """Phase 21: the input pipeline on the card."""
    from tpu_dist_torch.data import vectorize
    from tpu_dist_torch.data.device import DeviceDataset

    steps = CNN_EPOCHS * CNN_STEPS
    # (a) The native loader, built from the checkout, against its numpy
    # path at MNIST's real scale.
    t0 = time.monotonic()
    if not native.native_available():
        raise AssertionError("the native loader did not build (g++)")
    build_s = time.monotonic() - t0
    images, labels = td_data.load_arrays("mnist", "train",
                                         synthetic_size=MNIST_TRAIN)
    perm = native.shuffled_indices(MNIST_TRAIN, 7)
    idx = perm[:CNN_BATCH * 16]
    got = (perm, native.gather_scale(images, idx, 1.0 / 255.0),
           native.gather_labels(labels, idx))
    with _numpy_loader():
        want = (native.shuffled_indices(MNIST_TRAIN, 7),
                native.gather_scale(images, idx, 1.0 / 255.0),
                native.gather_labels(labels, idx))
    for name, g, w in zip(("shuffled_indices", "gather_scale",
                           "gather_labels"), got, want):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"(a) native {name} differs from its numpy "
                                 f"path")
    log(f"[21 data] (a) native loader {native.library_path().name} built "
        f"from csrc/loader.cpp in {build_s:.2f} s; at {MNIST_TRAIN} images "
        f"shuffled_indices, gather_scale ({len(idx)} rows) and "
        f"gather_labels equal the numpy path bit for bit")

    # (b) DeviceDataset against the host chain's batches, mul and div.
    x8, y8 = td_data.load_arrays("mnist", "train")
    for scale, op, fn in ((1.0 / 255.0, "mul", _scale_mul),
                          (255.0, "div", _scale_div)):
        ds = DeviceDataset(x8, y8, global_batch_size=CNN_BATCH, seed=5,
                           scale=scale, scale_op=op, device="cuda")
        probe = DeviceDataset(x8, y8, global_batch_size=CNN_BATCH, seed=5,
                              scale=scale, scale_op=op, device="cuda")
        per_epoch = ds.cardinality()
        seen = []
        for epoch in range(2):
            for b in range(per_epoch):
                xb, yb = ds.next_batch()
                sel = ds._perm[ds._pos - CNN_BATCH:ds._pos]
                wx, wy = fn(x8[sel], y8[sel])
                if not (torch.equal(xb.cpu(), torch.from_numpy(wx))
                        and torch.equal(yb.cpu(), torch.from_numpy(wy))):
                    raise AssertionError(f"(b) {op}: epoch {epoch} batch {b}"
                                         " differs from the host chain's")
                seen.append(sel)
            got = np.concatenate(seen[-per_epoch:])
            if sorted(got.tolist()) != list(range(len(x8))):
                raise AssertionError(f"(b) {op}: epoch {epoch} does not "
                                     "cover every sample once")
        if ds._dx.dtype != torch.uint8 or ds._dx.device.type != "cuda":
            raise AssertionError(f"(b) images on the card as {ds._dx.dtype}")
        # The same draws with an evaluation pass in the middle of epoch 0.
        for i, sel in enumerate(seen):
            if i == 40:
                list(probe)
            probe.next_batch()
            if not np.array_equal(probe._perm[probe._pos - CNN_BATCH:
                                              probe._pos], sel):
                raise AssertionError("(b) an evaluation pass moved the "
                                     "training order")
    log(f"[21 data] (b) DeviceDataset, seed 5, 2 epochs x {per_epoch} "
        f"batches of {CNN_BATCH}, mul and div: every batch equals the host "
        f"chain's map of the same samples bit for bit on the card, each "
        f"epoch covers the {len(x8)} samples once, images uint8 on the "
        f"card, an evaluation pass leaves the training order as it was")

    # (c) The reference program as it stands: fit promotes its chain.
    argv, out = sys.argv, io.StringIO()
    try:
        sys.argv = ["tpu_dist_example"]
        with contextlib.redirect_stdout(out):
            g = runpy.run_module("tpu_dist_torch.examples.tpu_dist_example",
                                 run_name="__main__")
    finally:
        sys.argv = argv
    promoted = getattr(g["train_datasets_no_auto_shard"], "_device_promoted",
                       None)
    loss = g["history"].history["loss"]
    if not isinstance(promoted, DeviceDataset) or promoted.uploads != 1 \
            or promoted.device.type != "cuda":
        raise AssertionError(f"(c) the program's chain was not promoted: "
                             f"{promoted!r}")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"(c) promoted program: losses {loss}")
    index_per_step = promoted.index_bytes / steps
    model = g["multi_worker_model"]
    before = (promoted.index_copies, promoted.index_bytes)
    copies = _htod_copies(lambda: model.fit(
        g["train_datasets_no_auto_shard"], epochs=1,
        steps_per_epoch=CNN_STEPS, verbose=0))
    # Every step sent its index vector: the dataset's own count of the
    # copies it issued (a trace has lost one such record in a whole-script
    # run, so the trace is not what counts them).
    sent_copies = promoted.index_copies - before[0]
    sent_bytes = promoted.index_bytes - before[1]
    if (sent_copies != CNN_STEPS
            or sent_bytes != CNN_STEPS * int(index_per_step)):
        raise AssertionError(f"(c) index vectors sent in an epoch of "
                             f"{CNN_STEPS} steps: {sent_copies} copies, "
                             f"{sent_bytes} bytes")
    if copies is None:
        sent = "not measured (the trace gives no copy sizes)"
    else:
        # No copy as large as one image of the batch: no pixel crossed.
        image_bytes = int(np.prod(x8.shape[1:]))
        if max(copies) >= image_bytes:
            raise AssertionError(f"(c) host->device copies in an epoch of "
                                 f"{CNN_STEPS} steps: {copies}")
        sent = (f"{len(copies)} copies, {sum(copies)} bytes in "
                f"{CNN_STEPS} steps ({copies.count(int(index_per_step))} "
                f"index vectors in the trace, {sent_copies} counted; other "
                f"sizes {sorted(set(copies) - {int(index_per_step)})})")
    log(f"[21 data] (c) the reference program as it stands: its chain "
        f"promoted to a DeviceDataset on {promoted.device} ({promoted.uploads}"
        f" upload of {promoted.upload_bytes} bytes in "
        f"{promoted.upload_seconds:.4f} s), {index_per_step:.0f} bytes of "
        f"indices a step; host->device in a profiled epoch: {sent}; loss "
        f"{loss[0]:.6f} -> {loss[-1]:.6f}")
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        chain = _chain(shuffle=False)
        _reset_counts()
        dm, dh = _fused_fit(chain)
        counts = _counts()
        if counts != (0, 0, 0, steps, steps, steps):
            raise AssertionError(f"(c) fused on the card's data: launches "
                                 f"{counts}")
        if not isinstance(getattr(chain, "_device_promoted", None),
                          DeviceDataset):
            raise AssertionError("(c) the unshuffled chain was not promoted")
        hm, hh = _fused_fit(td_data.DistributedDataset(_chain(shuffle=False),
                                                       None))
        loss_diff = max(abs(a - b) for a, b in zip(dh["loss"], hh["loss"]))
        param_diff = _max_diff(_params(dm), _params(hm))
        if loss_diff > CNN_LOSS_ATOL or param_diff > GRAPH_PARAM_ATOL:
            raise AssertionError(f"(c) device-resident vs host-fed: losses "
                                 f"{loss_diff:.3e}, params {param_diff:.3e}")
        log(f"[21 data] (c) fused CE + SGD on the promoted chain (no "
            f"shuffle), {CNN_EPOCHS} x {CNN_STEPS}: launches CE fwd "
            f"{counts[3]}, CE bwd {counts[4]}, SGD {counts[5]}; against the "
            f"same program fed from the host chain: losses max |diff| "
            f"{loss_diff:.3e} (atol {CNN_LOSS_ATOL:g}), params "
            f"{param_diff:.3e} (atol {GRAPH_PARAM_ATOL:g})")

        # (d) steps_per_execution=20 on the device-resident chain.
        _reset_counts()
        km, kh = _fused_fit(_chain(shuffle=False), k=CNN_STEPS)
        counts = _counts()
        loss_diff = max(abs(a - b) for a, b in zip(kh["loss"], dh["loss"]))
        param_diff = _max_diff(_params(km), _params(dm))
        if counts != (0, 0, 0, steps, steps, steps) or \
                loss_diff > CNN_LOSS_ATOL or param_diff > GRAPH_PARAM_ATOL:
            raise AssertionError(f"(d) k = {CNN_STEPS} on the card's data: "
                                 f"launches {counts}, losses {loss_diff:.3e},"
                                 f" params {param_diff:.3e}")
        (graphed,) = km._trainer._graphed.values()
        ((key, (prog, _)),) = graphed.programs.items()
        if key[0] != "indices" or list(prog.static) != ["idx"]:
            raise AssertionError(f"(d) the program's inputs: {key}")
        log(f"[21 data] (d) steps_per_execution={CNN_STEPS} on the promoted "
            f"chain: one program whose only input is the [{CNN_STEPS}, "
            f"{CNN_BATCH}] index vector ({prog.calls} executions, "
            f"{prog.replays} replays); losses max |diff| to k = 1 "
            f"{loss_diff:.3e} (atol {CNN_LOSS_ATOL:g}), params "
            f"{param_diff:.3e} (atol {GRAPH_PARAM_ATOL:g}); launches CE fwd "
            f"{counts[3]}, CE bwd {counts[4]}, SGD {counts[5]}")

        # (e) prefetch_to_device=2 on the host chain.
        metrics.enable()
        hits0 = _counter("data.prefetch.hits")
        misses0 = _counter("data.prefetch.misses")
        _, ph = _fused_fit(_program_chain(3), prefetch=2)
        hits = _counter("data.prefetch.hits") - hits0
        misses = _counter("data.prefetch.misses") - misses0
        _, nh = _fused_fit(_program_chain(3))
        loss_diff = max(abs(a - b) for a, b in zip(ph["loss"], nh["loss"]))
        if loss_diff > CNN_LOSS_ATOL or hits + misses != steps:
            raise AssertionError(f"(e) prefetch_to_device=2: losses "
                                 f"{loss_diff:.3e}, {hits} hits + {misses} "
                                 f"misses")
        log(f"[21 data] (e) prefetch_to_device=2 on the host chain (seed 3):"
            f" losses max |diff| to prefetch 0 {loss_diff:.3e} (atol "
            f"{CNN_LOSS_ATOL:g}); {hits} batches already on the card when "
            f"asked, {misses} not")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags

    # (f) Times.
    element = _chain(shuffle=True, seed=1)
    list(element)   # the first pass fills the cache
    n = len(x8) // CNN_BATCH - 2
    host = {
        "element": _host_ms_per_batch(element, n),
        "vectorized (uint8, the trainer's CUDA path)": _host_ms_per_batch(
            vectorize.try_rewrite(_chain(True, seed=1), device="cuda"), n),
        "vectorized (native gather_scale, mul)": _host_ms_per_batch(
            vectorize.try_rewrite(_chain(True, seed=1, scale=_scale_mul),
                                  defer_scale_to_device=False), n),
    }
    pf = td_data.DevicePrefetcher(iter(vectorize.try_rewrite(
        _chain(True, seed=1), device="cuda")), depth=2, device="cuda")
    host["prefetched onto the card (uint8)"] = _host_ms_per_batch(pf, n)
    pf.close()
    for name, ms in host.items():
        log(f"[21 times] host input, {name}: {ms:.4f} ms a batch of "
            f"{CNN_BATCH} ({card})")
    if not all(native.calls.values()):
        raise AssertionError(f"the native loader's calls: {native.calls}")
    log(f"[21 times] native loader calls {native.calls}")
    for name, make in (("host-fed", lambda: _program_chain(1)),
                       ("device-resident", lambda: _chain(shuffle=True))):
        for k in (1, CNN_STEPS):
            ms, dev = _fit_step_times(make, k)
            busy = ("not measured" if dev is None else
                    f"device {dev:.4f} ms/step ({dev / ms * 100:.1f} % busy)")
            log(f"[21 times] CNN fit step, batch {CNN_BATCH}, fused, {name},"
                f" k = {k}: {ms:.4f} ms/step = {CNN_BATCH / ms * 1e3:.1f} "
                f"images/s; {busy} (torch.profiler) ({card})")
    for size, (xs, ys) in ((len(x8), (x8, y8)), (MNIST_TRAIN,
                                                  (images, labels))):
        ds = DeviceDataset(xs, ys, global_batch_size=CNN_BATCH, device="cuda")
        ds.next_batch()
        log(f"[21 times] upload of {size} images ({ds.upload_bytes} bytes, "
            f"pinned copy and transfer): {ds.upload_seconds:.4f} s ({card})")


# -- slice 10: the ResNets of bench.py at full width --------------------------

#: bench.py:59-60 (dataset, input shape) and :1045-1047 (steps_per_execution)
#: of its two ResNet configurations; both at global batch 256, built and
#: compiled as ``bench.py:71-111`` builds them.
RESNETS = (("resnet18", "fashion_mnist", (28, 28, 1), 8, ResNet18),
           ("resnet50", "cifar10", (32, 32, 3), 4, ResNet50))
RESNET_BATCH, RESNET_EPOCHS, RESNET_STEPS = 256, 2, 4
#: The test split: 2,576 = 10 x 256 + 16, so the last batch is ragged.
RESNET_TEST = 2_576
#: Fused against unfused, after the first step: the same forward (so the
#: same loss and BatchNorm statistics, to rounding) and one update whose
#: gradients differ by the CE kernel's ~1e-7 relative rounding, which moves
#: a weight by far under 1e-6 at lr 0.001.
RESNET_LOSS_ATOL = 1e-5
RESNET_PARAM_ATOL = 1e-6
RESNET_STATE_TOL = 1e-5
#: After 8 steps a BatchNorm net carries any rounding difference far (on
#: the card, a twin whose weights start one ulp off drifts by as much as
#: the fused run does): the fused run must stay within RESNET_DRIFT times
#: that one-ulp twin's distance from the unfused one, measured in the same
#: run, on losses, parameters and BatchNorm state.
RESNET_DRIFT = 10.0
#: predict against the eval-mode forward: the same kernels on the same
#: rows give the same bits (full batches; the ragged batch against the
#: forward of its padded copy). Against the forward of the 16 rows alone,
#: cuDNN may take another algorithm and sum in another order: within
#: PREDICT_RTOL of the logits' size (fp32 sums over up to 4,608 terms).
PREDICT_RTOL = 1e-4


class _FirstStep(Callback):
    """Keeps the parameters and buffers after the fit's first step."""

    wants_batches = True

    def __init__(self):
        self.taken = None

    def on_batch_end(self, step, logs):
        if self.taken is None:
            self.taken = (logs["loss"], _params(self.model),
                          _bn_state(self.model))


def _resnet_chain(source, *, shuffle: bool = False):
    """The reference chain on a loaded dataset: map(x / 255) -> cache ->
    (shuffle(10000), unseeded, as the reference program's) -> batch(256).
    Without the shuffle, two fits see the same batches in order (phase 21's
    rule for its comparisons: a promoted chain's shuffle draws a seed of
    its own)."""
    def scale(image, label):
        return np.asarray(image, np.float32) / 255.0, label

    ds = source.map(scale).cache()
    if shuffle:
        ds = ds.shuffle(10000)
    return ds.batch(RESNET_BATCH)


def _resnet(make_model, shape, *, fused_on: bool = True, k: int = 1,
            bucket_bytes: int = 0):
    """``bench.py:build_model``'s ResNet: SparseCategoricalCrossentropy(
    from_logits=True), SGD(0.001) and SparseCategoricalAccuracy, with the
    kernels' flags; random weights from seed 0, so two builds start equal."""
    model = make_model(num_classes=10, input_shape=shape)
    model.compile(optimizer=SGD(learning_rate=0.001, fused=fused_on),
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=fused_on),
                  metrics=[SparseCategoricalAccuracy()],
                  steps_per_execution=k, gradient_bucket_bytes=bucket_bytes)
    return model


def _bn_state(model) -> list:
    return [b.detach().clone() for b in model.buffers()]


def _state_diff(a, b) -> float:
    """The largest |a - b| / (1 + |b|) over the BatchNorm buffers."""
    return max(float(((p - q).abs() / (1 + q.abs())).max())
               for p, q in zip(a, b))


def _conv_dense_flops(model, x) -> float:
    """FLOPs of one train step's convolutions and Dense products, counted
    from their shapes in an eval forward of ``x``: 2 per multiply-add
    forward, twice that backward (the input gradient and the weight
    gradient), less the first conv's input gradient, which nothing needs.
    BatchNorm, activations, pooling and the optimizer are not counted."""
    from tpu_dist_torch.models.layers import Conv2D, Dense

    fwd, first = [], []

    def hook(m, inputs, out):
        if isinstance(m, Conv2D):
            kh, kw = m.kernel_size
            macs = out.numel() * kh * kw * inputs[0].shape[-1]
        else:
            macs = out.numel() * inputs[0].shape[-1]
        fwd.append(2.0 * macs)
        if not first:
            first.append(2.0 * macs)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv2D, Dense))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return 3 * sum(fwd) - first[0]


def _resnet_step_times(make_model, shape, k: int, batch, peak: float) -> dict:
    """A fresh fused model's train step at ``k`` steps an execution on one
    device batch (``make_train_function``): ms a step (median of
    CUDA-event windows), images/s, device ms and busy share, the top
    device kernels and operators (``torch.profiler``), and the conv and
    Dense FLOPs' share of ``peak``."""
    model = _resnet(make_model, shape)
    fn, state = model.make_train_function(k), model.train_state()
    xs, ys = (torch.stack([a] * k) if k > 1 else a for a in batch)
    step = lambda: fn(*state, xs, ys)
    per = 2 if k == 1 else 1
    ms = _time_ms(step, runs=3, per_run=per, warmup=2) / k
    kernels, ops = _step_profile(step, per)
    layout = _layout_ms(step, per) if k == 1 else None
    steps = per * k
    dev = sum(us for _, us in kernels) / 1e3 / steps if kernels else None
    flops = _conv_dense_flops(model, batch[0])
    return {"k": k, "ms": ms, "images_s": RESNET_BATCH / ms * 1e3,
            "device_ms": dev, "busy": None if dev is None else dev / ms,
            "top": [(n, us / steps / 1e3) for n, us in kernels[:6]],
            "ops": [(n, us / steps / 1e3) for n, us in ops[:8]],
            "layout": layout,
            "tflop": flops / 1e12, "flop_share": flops / (ms * 1e-3) / peak}


def _log_step(name: str, policy_name: str, t: dict, card: str) -> None:
    busy = ("device not measured" if t["device_ms"] is None else
            f"device {t['device_ms']:.4f} ms a step "
            f"({t['busy'] * 100:.1f} % busy)")
    log(f"[22 resnet] (f) {name} {policy_name} train step, batch "
        f"{RESNET_BATCH}, k = {t['k']}: {t['ms']:.4f} ms = "
        f"{t['images_s']:.1f} images/s; {busy}; conv + Dense "
        f"{t['tflop']:.4f} TFLOP a step = "
        f"{t['flop_share'] * 100:.1f} % of the card's "
        f"{'fp32 CUDA-core' if policy_name == 'float32' else 'bf16 tensor'}"
        f" peak ({card})")
    log("    top device kernels, ms a step: " + "; ".join(
        f"{n[:90]} {ms:.4f}" for n, ms in t["top"]))
    if t["ops"]:
        log("    top operators by their kernels' device time, ms a step: "
            + "; ".join(f"{n} {ms:.4f}" for n, ms in t["ops"]))
    if t["layout"]:
        log("    layout work, device ms a step: " + "; ".join(
            f"{n} {ms:.4f}" for n, ms in t["layout"].items()))


def _device_predict_check(model, name: str, dataset: str) -> None:
    """Phase 22 (c), F3: ``predict`` over the test chain promoted to a
    ``DeviceDataset`` (the full batches: a promoted chain drops the ragged
    one) equals the host chain's ``predict`` exactly, and sends the host
    one copy, the outputs."""
    source = td_data.load(dataset, split="test", synthetic_size=RESNET_TEST)

    def chain():
        return source.map(lambda i, l: (np.asarray(i, np.float32) / 255.0,
                                        l)).cache().batch(
            RESNET_BATCH, drop_remainder=True)

    promoted = vectorize.try_promote_to_device(chain(), torch.device("cuda"))
    if not isinstance(promoted, DeviceDataset):
        raise AssertionError(f"(c) {name}: the test chain was not promoted")
    host = model.predict(chain())
    got = {}
    copies = _htod_copies(lambda: got.update(out=model.predict(promoted)),
                          kind="DtoH")
    t0 = time.monotonic()
    again = model.predict(promoted)
    dev_s = time.monotonic() - t0
    rows = (RESNET_TEST // RESNET_BATCH) * RESNET_BATCH
    out = got["out"]
    if not np.array_equal(again, out):
        raise AssertionError(f"(c) {name}: two predicts over the "
                             f"DeviceDataset differ")
    if (out.shape != (rows, 10) or not np.array_equal(out, host)
            or (copies is not None and copies != [out.nbytes])):
        raise AssertionError(
            f"(c) {name}: predict over the DeviceDataset {out.shape} off "
            f"the host chain's by {np.abs(out - host).max():.3e}; "
            f"device-to-host copies {copies}")
    log(f"[22 resnet] (c) {name} predict over the test chain promoted to a "
        f"DeviceDataset ({rows} images, the ragged batch dropped) in "
        f"{dev_s:.3f} s (a second pass, not profiled): equal to the host "
        f"chain's predict exactly; device-to-host copies of a profiled pass "
        f"{'not read' if copies is None else copies} (the outputs only)")


def resnet_phase(card: str) -> dict:
    """Phase 22: bench.py's two ResNets at full width and batch."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    steps = RESNET_EPOCHS * RESNET_STEPS
    out = {}
    try:
        for name, dataset, shape, k, make_model in RESNETS:
            source = td_data.load(dataset, split="train")
            runs = {}
            for label, fused_on, kk, nudge in (
                    ("fused", True, 1, False), ("unfused", False, 1, False),
                    ("nudged", False, 1, True), ("graphed", True, k, False)):
                model = _resnet(make_model, shape, fused_on=fused_on, k=kk)
                if nudge:   # every weight one ulp up
                    with torch.no_grad():
                        for p in model.parameters():
                            p.copy_(torch.nextafter(
                                p, torch.full_like(p, float("inf"))))
                chain = _resnet_chain(source)
                first = _FirstStep()
                _reset_counts()
                t0 = time.monotonic()
                h = model.fit(chain, epochs=RESNET_EPOCHS,
                              steps_per_epoch=RESNET_STEPS, verbose=0,
                              callbacks=[first] if kk == 1 else [])
                torch.cuda.synchronize()
                runs[label] = (model, h.history, _counts(),
                               time.monotonic() - t0, first.taken)
                promoted = getattr(chain, "_device_promoted", None)
                if not isinstance(promoted, DeviceDataset):
                    raise AssertionError(f"(a) {name}: the chain was not "
                                         f"promoted: {promoted!r}")
            fm, fh, fc, fwall, f1 = runs["fused"]
            tm, th, tc, _, t1 = runs["unfused"]
            nm, nh, _, _, _ = runs["nudged"]
            gm, gh, gc, gwall, _ = runs["graphed"]
            want = (0, 0, 0, steps, steps, steps)
            if fc != want or gc != want or any(tc):
                raise AssertionError(f"(a) {name}: launches fused {fc}, "
                                     f"graphed {gc}, unfused {tc}; expected "
                                     f"{want}, {want} and none")

            def gaps(a, b):
                return (max(abs(x - y) for x, y in zip(a[0], b[0])),
                        _max_diff(a[1], b[1]), _state_diff(a[2], b[2]))

            first_gap = gaps(([f1[0]], f1[1], f1[2]), ([t1[0]], t1[1], t1[2]))
            end = [(h["loss"], _params(m), _bn_state(m))
                   for m, h in ((fm, fh), (tm, th), (nm, nh))]
            fused_gap, ulp_gap = gaps(end[0], end[1]), gaps(end[2], end[1])
            if (first_gap[0] > RESNET_LOSS_ATOL
                    or first_gap[1] > RESNET_PARAM_ATOL
                    or first_gap[2] > RESNET_STATE_TOL
                    or any(f > RESNET_DRIFT * u
                           for f, u in zip(fused_gap, ulp_gap))
                    or not np.isfinite(fh["loss"]).all()):
                raise AssertionError(
                    f"(a) {name} fused vs unfused: after one step losses, "
                    f"params, BN state {first_gap} (limits "
                    f"{RESNET_LOSS_ATOL:g}, {RESNET_PARAM_ATOL:g}, "
                    f"{RESNET_STATE_TOL:g}); after {steps} {fused_gap} "
                    f"against the one-ulp twin's {ulp_gap} (x "
                    f"{RESNET_DRIFT:g}); losses {fh['loss']}")
            log(f"[22 resnet] (a) {name} "
                f"({sum(p.numel() for p in fm.parameters())} parameters in "
                f"{len(list(fm.parameters()))} leaves, "
                f"{sum(b.numel() for b in fm.buffers())} BN state), the "
                f"{dataset} chain promoted to a DeviceDataset, fused CE + "
                f"SGD(fused=True), {RESNET_EPOCHS} x {RESNET_STEPS} steps of "
                f"{RESNET_BATCH} in {fwall:.3f} s: losses "
                f"{[round(v, 6) for v in fh['loss']]}; against the unfused "
                f"twin, max |diff| of losses, params and BN state "
                f"(relative) after one step {first_gap[0]:.3e}, "
                f"{first_gap[1]:.3e}, {first_gap[2]:.3e} (limits "
                f"{RESNET_LOSS_ATOL:g}, {RESNET_PARAM_ATOL:g}, "
                f"{RESNET_STATE_TOL:g}), after {steps} {fused_gap[0]:.3e}, "
                f"{fused_gap[1]:.3e}, {fused_gap[2]:.3e}, where the twin "
                f"started one ulp off drifts by {ulp_gap[0]:.3e}, "
                f"{ulp_gap[1]:.3e}, {ulp_gap[2]:.3e} (limit {RESNET_DRIFT:g}"
                f" x); launches CE fwd {fc[3]}, CE bwd {fc[4]}, SGD {fc[5]};"
                f" leaf tables built {_one_table(name, fm)}")
            # (b) k steps an execution on a captured graph against k = 1.
            loss_k = max(abs(a - b) for a, b in zip(gh["loss"], fh["loss"]))
            param_k = _max_diff(_params(gm), _params(fm))
            state_k = _state_diff(_bn_state(gm), _bn_state(fm))
            (graphed,) = gm._trainer._graphed.values()
            ((key, (prog, _)),) = graphed.programs.items()
            if (loss_k > RESNET_LOSS_ATOL or param_k > GRAPH_PARAM_ATOL
                    or state_k > RESNET_STATE_TOL or prog.replays < 1):
                raise AssertionError(
                    f"(b) {name} k = {k} vs k = 1: losses {loss_k:.3e}, "
                    f"params {param_k:.3e}, BN state {state_k:.3e}; "
                    f"{prog.replays} replays")
            log(f"[22 resnet] (b) {name} steps_per_execution={k} on a "
                f"captured graph ({prog.calls} executions, {prog.replays} "
                f"replays, captured in {prog.capture_s:.3f} s; key {key[0]})"
                f" in {gwall:.3f} s against k = 1: max |diff| losses "
                f"{loss_k:.3e}, params {param_k:.3e}, BN state {state_k:.3e}"
                f" ({'exact' if param_k == state_k == 0 else 'not exact'}); "
                f"launches {gc[3]}, {gc[4]}, {gc[5]}")
            # (c) evaluate and predict over the test split, eval mode.
            test = _resnet_chain(td_data.load(dataset, split="test",
                                              synthetic_size=RESNET_TEST))
            logs = fm.evaluate(test, verbose=0)
            t0 = time.monotonic()
            pred = fm.predict(test)
            pred_s = time.monotonic() - t0
            ((pkey, (pprog, _)),) = fm._trainer._predict_programs.items()
            exact = ragged = 0.0
            row = 0
            with torch.no_grad():
                for xb, _ in test:
                    xb = np.asarray(xb)
                    n = len(xb)
                    padded = np.concatenate(
                        [xb, np.repeat(xb[-1:], RESNET_BATCH - n, axis=0)])
                    got = pred[row:row + n]
                    ref = fm(torch.from_numpy(padded).cuda()).cpu().numpy()
                    exact = max(exact, float(np.abs(got - ref[:n]).max()))
                    if n < RESNET_BATCH:
                        alone = fm(torch.from_numpy(xb).cuda()).cpu().numpy()
                        ragged = float(np.abs(got - alone).max()
                                       / np.abs(alone).max())
                    row += n
            if (pred.shape != (RESNET_TEST, 10) or row != RESNET_TEST
                    or exact != 0.0 or ragged > PREDICT_RTOL
                    or not np.isfinite(logs["loss"]) or fm.training):
                raise AssertionError(
                    f"(c) {name}: predict {pred.shape} off the eval forward "
                    f"by {exact:.3e}, the ragged batch off the forward of "
                    f"its rows alone by {ragged:.3e} of the logits' size; "
                    f"evaluate {logs}")
            log(f"[22 resnet] (c) {name} evaluate over {RESNET_TEST} test "
                f"images (last batch {RESNET_TEST % RESNET_BATCH} rows): "
                f"loss {logs['loss']:.6f}, accuracy {logs['accuracy']:.4f}; "
                f"predict {pred.shape} in {pred_s:.3f} s through one "
                f"captured eval program ({pprog.calls} calls, "
                f"{pprog.replays} replays): equal to the eval forward batch "
                f"by batch exactly (the ragged one padded to "
                f"{RESNET_BATCH} rows), and to the forward of its 16 rows "
                f"alone within {ragged:.3e} of the logits' size (rtol "
                f"{PREDICT_RTOL:g})")
            _device_predict_check(fm, name, dataset)
            out[name] = {"model": gm, "counts": fc, "k": k, "source": source,
                         "batch": next(iter(_resnet_chain(source)))}
            del fm, tm, nm, runs
        # (d) ResNet-18 under mixed_bfloat16, the reference's TPU recipe:
        # the k = 8 model fit again after set_policy, without recompiling,
        # on the reference chain as it stands (its unseeded shuffle).
        gm = out["resnet18"]["model"]
        seen = []
        hook = gm.conv2d.register_forward_hook(
            lambda m, i, o: seen.append(i[0].dtype))
        chain = _resnet_chain(out["resnet18"]["source"], shuffle=True)
        before = policy()
        try:
            set_policy("mixed_bfloat16")
            h = gm.fit(chain, epochs=RESNET_EPOCHS,
                       steps_per_epoch=RESNET_STEPS, verbose=0).history
            logits = gm.predict(out["resnet18"]["batch"][0][:64])
        finally:
            set_policy(before)
            hook.remove()
        if not isinstance(getattr(chain, "_device_promoted", None),
                          DeviceDataset):
            raise AssertionError("(d) the shuffled chain was not promoted")
        keys = sorted(key[0] for key in gm._trainer._graphed)
        (prog16, _), = [p for key, g in gm._trainer._graphed.items()
                        if key[0] == "mixed_bfloat16"
                        for p in g.programs.values()]
        bf16_state = [b.dtype for b in gm.buffers()]
        if (keys != ["float32", "mixed_bfloat16"] or prog16.replays < 1
                or seen[:1] != [torch.bfloat16]
                or not np.isfinite(h["loss"]).all()
                or logits.dtype != np.float32
                or set(bf16_state) != {torch.float32}
                or not all(torch.isfinite(b).all() for b in gm.buffers())):
            raise AssertionError(
                f"(d) bf16 ResNet-18: programs {keys}, first conv input "
                f"{seen[:1]}, losses {h['loss']}, logits {logits.dtype}, "
                f"BN state {set(bf16_state)}")
        log(f"[22 resnet] (d) resnet18 fit again under mixed_bfloat16 "
            f"without recompiling: a new captured program (programs keyed "
            f"{keys}; {prog16.calls} executions, {prog16.replays} replays), "
            f"first conv input {seen[0]}, losses "
            f"{[round(v, 6) for v in h['loss']]} (finite), logits "
            f"{logits.dtype}, BN state {sorted(map(str, set(bf16_state)))}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    # (e) fused SGD at the ResNets' leaf tables.
    sgd = {}
    for name, _, shape, _, make_model in RESNETS:
        params = [p.detach().to("cuda") for p in
                  make_model(num_classes=10, input_shape=shape).parameters()]
        gen = torch.Generator().manual_seed(3)
        grads = [1e-2 * torch.randn(p.shape, generator=gen).to("cuda")
                 for p in params]
        sgd[name] = _sgd_times(params, grads)["plain"]
        _log_optimizer_times("22", "fused SGD plain", name, sgd[name],
                             "torch.optim.SGD(foreach=True).step()")
        del params, grads
    # (f) step times, fp32 (TF32 off, phase 1) and ResNet-18 bf16.
    times = {}
    for name, _, shape, k, make_model in RESNETS:
        batch = tuple(torch.from_numpy(np.asarray(a)).cuda()
                      for a in out[name]["batch"])
        for kk in (1, k):
            t = _resnet_step_times(make_model, shape, kk, batch,
                                   FP32_FLOPS_PER_S)
            times[name, "float32", kk] = t
            _log_step(name, "float32", t, card)
        if name == "resnet18":
            before = policy()
            try:
                set_policy("mixed_bfloat16")
                for kk in (1, k):
                    t = _resnet_step_times(make_model, shape, kk, batch,
                                           BF16_FLOPS_PER_S)
                    times[name, "mixed_bfloat16", kk] = t
                    _log_step(name, "mixed_bfloat16", t, card)
            finally:
                set_policy(before)
    torch.cuda.empty_cache()
    return {"launches": {name: out[name]["counts"] for name in out},
            "sgd": sgd, "times": times}


# -- checkpoints, resumed fits, serving a saved model -------------------------

#: Phase 23 (a): ResNet-18 on a chain of exactly 4 batches a pass, 2 epochs,
#: then resumed to 4. (b): the LM on 2 batches a pass, 2 epochs, resumed to 3.
RESUME_RESNET = dict(rows=4 * RESNET_BATCH, at=2, epochs=4)
RESUME_LM = dict(rows=2 * TRAIN_BATCH, at=2, epochs=3)


def _opt_tensors(model) -> list:
    """The optimizer state's tensors (velocity; Adam's mu, nu and step), in
    the checkpoint's key order."""
    from tpu_dist_torch.models import bridge

    names = [n for n, _ in model.named_parameters()]
    keys = bridge.opt_keys(model._trainer.variables["opt"], names)
    return [keys[k].detach().clone() for k in sorted(keys)]


class _EpochClock(Callback):
    """Each epoch's wall seconds, from its start to its logs: ``fit`` reads
    the epoch's loss on the host before ``on_epoch_end``, so the device's
    work is in it; a ``ModelCheckpoint`` that ``fit`` adds runs after this
    callback, so its stall is not (the snapshot's device work, which
    overlaps the next epoch, is)."""

    def __init__(self):
        self.seconds, self._t0 = [], None

    def on_epoch_begin(self, epoch):
        self._t0 = time.perf_counter()

    def on_epoch_end(self, epoch, logs):
        self.seconds.append(time.perf_counter() - self._t0)


def _fit_record(model, history, clock: _EpochClock) -> dict:
    return {"loss": history["loss"], "epoch_s": clock.seconds,
            "params": _params(model), "state": _bn_state(model),
            "opt": _opt_tensors(model), "counts": _counts()}


def _gaps(a: dict, b: dict, skip: int = 0) -> dict:
    """Largest |a - b| of the losses (``a``'s from epoch ``skip`` on),
    parameters, BatchNorm state and optimizer state."""
    la = a["loss"][skip:] if len(a["loss"]) > len(b["loss"]) else a["loss"]
    lb = b["loss"][skip:] if len(b["loss"]) > len(a["loss"]) else b["loss"]
    out = {"loss": max(abs(x - y) for x, y in zip(la, lb))}
    for k in ("params", "state", "opt"):
        out[k] = (_max_diff(a[k], b[k]) if a[k] else 0.0)
    return out


def _resumed_fit(label: str, make_model, make_data, at: int, epochs: int,
                 steps: int, tmp: pathlib.Path) -> dict:
    """Two uninterrupted fits, then one of ``at`` epochs with
    ``checkpoint_dir`` and one resumed to ``epochs`` on a fresh model:
    returns the records and the resumed fit's checkpoint metrics."""
    runs = {}
    for name in ("straight", "again"):
        model = make_model()
        _reset_counts()
        clock = _EpochClock()
        h = model.fit(make_data(), epochs=epochs, verbose=0,
                      callbacks=[clock]).history
        torch.cuda.synchronize()
        runs[name] = _fit_record(model, h, clock)
        del model
    directory = tmp / label
    # The checkpointed fits' saves (metrics: the async stall at each
    # epoch's end, the writer's seconds).
    metrics.get_registry().reset()
    metrics.enable()
    try:
        model = make_model()
        model.fit(make_data(), epochs=at, verbose=0,
                  checkpoint_dir=str(directory))
        del model
        if checkpoint.all_steps(directory) != list(range(at)):
            raise AssertionError(f"(23) {label}: steps written "
                                 f"{checkpoint.all_steps(directory)}")
        model = make_model()
        _reset_counts()
        clock = _EpochClock()
        h = model.fit(make_data(), epochs=epochs, verbose=0,
                      callbacks=[clock],
                      checkpoint_dir=str(directory)).history
        torch.cuda.synchronize()
        dists = metrics.get_registry().snapshot()["distributions"]
    finally:
        metrics.disable()
    runs["resumed"] = _fit_record(model, h, clock)
    runs["model"], runs["metrics"], runs["dir"] = model, dists, directory
    if len(h["loss"]) != epochs - at:
        raise AssertionError(f"(23) {label}: the resumed fit ran "
                             f"{len(h['loss'])} epochs; expected "
                             f"{epochs - at} (epoch {at} on)")
    want = tuple(c * (epochs - at) // epochs
                 for c in runs["straight"]["counts"])
    if runs["resumed"]["counts"] != want or not any(want):
        raise AssertionError(f"(23) {label}: launches {runs['resumed']['counts']}"
                             f"; expected {want}")
    spread = _gaps(runs["straight"], runs["again"])
    resumed = _gaps(runs["resumed"], runs["straight"], skip=at)
    bitwise = all(v == 0.0 for v in spread.values())
    limit = (dict.fromkeys(spread, 0.0) if bitwise else spread)
    if any(resumed[k] > limit[k] for k in resumed) or not all(
            np.isfinite(runs["resumed"]["loss"])):
        raise AssertionError(
            f"(23) {label}: resumed against uninterrupted {resumed}; two "
            f"uninterrupted fits differ by {spread}")
    runs["gaps"], runs["bitwise"] = resumed, bitwise
    runs["steps"] = steps
    return runs


def _save_times(model, directory: pathlib.Path) -> dict:
    """The sync save's and the restore's seconds, and the step directory's
    MB (``model``'s live variables, on the card)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checkpoint.save(directory, model, step=0)
    save_s = time.monotonic() - t0
    mb = sum(f.stat().st_size for f in (directory / "ckpt-0").iterdir()) / 1e6
    t0 = time.monotonic()
    checkpoint.restore_model(directory, model, step=0)
    torch.cuda.synchronize()
    return {"save_s": save_s, "mb": mb, "restore_s": time.monotonic() - t0}


def _log_resume(label: str, runs: dict, times: dict, card: str) -> None:
    straight, resumed = runs["straight"], runs["resumed"]
    at = len(straight["loss"]) - len(resumed["loss"])
    ms = lambda seconds: [round(1e3 * v / runs["steps"], 4) for v in seconds]
    dist = runs["metrics"]
    fmt = lambda d: ("not measured" if not d else
                     f"p50 {d['p50']:.4f} s, max {d['max']:.4f} s over "
                     f"{d['count']}")
    gaps = runs["gaps"]
    log(f"[23 resume] {label}: resumed at epoch {at} (restored step "
        f"{at - 1}); epochs {at + 1}-{len(straight['loss'])} losses "
        f"{[round(v, 6) for v in resumed['loss']]} against the uninterrupted"
        f" fit's {[round(v, 6) for v in straight['loss'][at:]]}; max |diff| "
        f"losses {gaps['loss']:.3e}, params {gaps['params']:.3e}, BN state "
        f"{gaps['state']:.3e}, optimizer state {gaps['opt']:.3e} ("
        f"{'bit for bit, as two uninterrupted fits are' if runs['bitwise'] else 'within the spread of two uninterrupted fits'}"
        f"); launches (flash fwd, flash bwd, Adam, CE fwd, CE bwd, SGD) "
        f"{resumed['counts']}")
    log(f"[23 times] {label}: sync save {times['save_s']:.4f} s for "
        f"{times['mb']:.2f} MB; async save stall at the epoch end "
        f"{fmt(dist.get('checkpoint.stall_s'))}, its writer "
        f"{fmt(dist.get('checkpoint.write_s'))}; restore "
        f"{times['restore_s']:.4f} s; ms a step, epoch by epoch (wall "
        f"seconds of the epoch / its steps; a fit's first epoch warms up): "
        f"resumed {ms(resumed['epoch_s'])}, uninterrupted "
        f"{ms(straight['epoch_s'])} (epochs 1-{len(straight['loss'])}) "
        f"({card})")


def _saved_serve_check(contiguous_streams: list, tmp: pathlib.Path) -> int:
    """Phase 23 (c): phase 4's LM through save_model, load_model and
    ``ServeEngine.from_saved``; returns the flash forward launches."""
    directory = tmp / "saved_lm"
    model = _serve_lm()
    t0 = time.monotonic()
    save_model(model, directory)
    save_s = time.monotonic() - t0
    loaded = load_model(directory, compile=False)
    want = model.state_dict()
    if not all(torch.equal(v.cpu(), want[k].cpu())
               for k, v in loaded.state_dict().items()):
        raise AssertionError("(23 c) load_model: weights differ")
    del loaded
    engine = ServeEngine.from_saved(directory, max_batch=8,
                                    max_len=LM["seq_len"])
    fa.flash_attention_fwd.launches = 0
    reqs = [engine.submit(p, max_new_tokens=m) for p, m in _serve_specs()]
    engine.run_until_idle()
    torch.cuda.synchronize()
    launches = fa.flash_attention_fwd.launches
    streams = [r.generated for r in reqs]
    if streams != contiguous_streams or launches != LM["depth"] * len(reqs):
        raise AssertionError(
            f"(23 c) from_saved: {sum(a != b for a, b in zip(streams, contiguous_streams))}"
            f" streams differ from phase 4's; {launches} flash launches")
    # Phase 5's arguments; the saved model's own width wins over the
    # demo LM's (--d-model, --depth, --num-heads).
    argv = ["--bench", "--requests", "8", "--max-len", str(LM["seq_len"]),
            "--vocab", str(LM["vocab_size"]), "--d-model",
            str(LM["d_model"]), "--depth", str(LM["depth"]), "--num-heads",
            str(LM["num_heads"]), "--min-new", "8", "--max-new", "16"]
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.serve", "--model-dir",
         str(directory), *argv], capture_output=True, text=True,
        timeout=300, cwd=pathlib.Path(__file__).resolve().parent)
    cli_s = time.monotonic() - t0
    report = json.loads(proc.stdout) if proc.returncode == 0 else {}
    if proc.returncode != 0 or not report.get("ok") or \
            report.get("completed") != 8:
        raise AssertionError(f"(23 c) serve --model-dir: rc "
                             f"{proc.returncode}, {proc.stderr[-2000:]}")
    log(f"[23 saved] (c) save_model of phase 4's LM in {save_s:.3f} s, "
        f"load_model (weights bit for bit), ServeEngine.from_saved on phase "
        f"4's 16 requests: phase 4's streams token for token, flash "
        f"launches {launches} = depth {LM['depth']} x 16 prefills; python -m"
        f" tpu_dist_torch.serve --model-dir D --bench (phase 5's arguments) "
        f"exit 0 in {cli_s:.1f} s: {report['throughput_tok_s']} tok/s, TTFT "
        f"p50 {report['ttft_s']['p50']} s")
    return launches


def resume_phase(card: str, contiguous_streams: list) -> dict:
    """Phase 23: resumed fits of ResNet-18 and the LM, and serving a saved
    model; returns the launches of each path for the kernel line."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        try:
            source = td_data.load("fashion_mnist", split="train",
                                  synthetic_size=RESUME_RESNET["rows"])

            def resnet():
                model = ResNet18(num_classes=10, input_shape=(28, 28, 1))
                model.compile(
                    optimizer=SGD(learning_rate=0.001, momentum=0.9,
                                  fused=True),
                    loss=SparseCategoricalCrossentropy(from_logits=True,
                                                       fused=True),
                    metrics=[SparseCategoricalAccuracy()])
                return model

            r = RESUME_RESNET
            runs = _resumed_fit("resnet18", resnet,
                                lambda: _resnet_chain(source), r["at"],
                                r["epochs"], r["rows"] // RESNET_BATCH, tmp)
            times = _save_times(runs["model"], tmp / "resnet18_sync")
            _log_resume("(a) resnet18 (11,172,810 parameters, batch 256, "
                        "SGD momentum 0.9 fused, fused CE)", runs, times,
                        card)
            out["resnet18"] = runs["resumed"]["counts"]
            del runs
        finally:
            torch.backends.cudnn.deterministic, \
                torch.backends.cudnn.benchmark = flags
        x, y = (t.cpu().numpy() for t in _bench_tokens(RESUME_LM["rows"]))
        r = RESUME_LM
        runs = _resumed_fit(
            "lm", lambda: _compiled_lm(Adam(fused=True)),
            lambda: td_data.Dataset.from_tensor_slices((x, y)).batch(
                TRAIN_BATCH), r["at"], r["epochs"],
            r["rows"] // TRAIN_BATCH, tmp)
        times = _save_times(runs["model"], tmp / "lm_sync")
        step = runs["model"]._trainer.variables["opt"].step
        if int(step) != r["epochs"] * r["rows"] // TRAIN_BATCH:
            raise AssertionError(f"(23 b) Adam's step counter {int(step)}")
        _log_resume(f"(b) the benchmark LM (21,269,504 parameters, batch "
                    f"{TRAIN_BATCH} x {LM['seq_len']}, Adam fused; device "
                    f"step counter {int(step)})", runs, times, card)
        out["lm"] = runs["resumed"]["counts"]
        del runs
        torch.cuda.empty_cache()
        out["serve_from_saved"] = _saved_serve_check(contiguous_streams, tmp)
    torch.cuda.empty_cache()
    return out


# -- the data-parallel surface: two workers on one card ----------------------

#: Phase 24: ResNet-18 (phase 22's) at global batch 256 over two workers
#: (128 rows each), 2 epochs x 4 steps, bucketed at
#: benchmarks/step_bench.py:140's default and on the default schedule; the
#: custom loop's 40 steps. Each worker has its own timeout.
DP_WORKERS, DP_EPOCHS, DP_STEPS = 2, 2, 4
DP_BUCKET_BYTES = 262144
DP_LOOP_STEPS = 40
DP_TIMEOUT_S = 420
#: (d): at lr 0.01 a batch of 16 carries rounding far: on the CPU the
#: workers' loss (the mean of two 8-row means) and a single process's
#: (one 16-row mean) agree to 7e-7 for the first 33 steps and then part
#: by up to 1e-3 by step 100. The first LOOP_CLOSE_STEPS steps are held to
#: CNN_LOSS_ATOL; all DP_LOOP_STEPS and the parameters to RESNET_DRIFT
#: times a one-ulp-nudged twin's drift, phase 22's rule.
LOOP_CLOSE_STEPS = 20
DP_TIMED = 10
#: Phase 24 (c): the profiled LM fit's steps.
PROFILE_STEPS = 4


def _cpu(obj):
    """``obj`` with every tensor moved to the CPU (nested lists, tuples and
    dicts)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _ms(fn, calls: int) -> float:
    """Host ms a call of ``fn`` over ``calls`` calls, after two more; the
    card is synchronised at both ends."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def _dp_fit(strategy, source, bucket_bytes: int) -> dict:
    """One worker's fit of ResNet-18 on its half of every global batch of
    256: the first step's and the end's values, the kernels' and the
    buckets' launches; then the step's ms and its gradient reduction's."""
    with strategy.scope():
        model = _resnet(ResNet18, (28, 28, 1), bucket_bytes=bucket_bytes)
    first = _FirstStep()
    _reset_counts()
    collectives.bucketed_all_reduce.launches = 0
    h = model.fit(_resnet_chain(source), epochs=DP_EPOCHS,
                  steps_per_epoch=DP_STEPS, verbose=0, callbacks=[first])
    torch.cuda.synchronize()
    out = {"loss": h.history["loss"], "counts": _counts(),
           "bucket_launches": collectives.bucketed_all_reduce.launches,
           "first": first.taken, "params": _params(model),
           "state": _bn_state(model),
           "synced": [m.synchronized for m in model.modules()
                      if hasattr(m, "synchronized")]}
    names = [n for n, _ in model.named_parameters()]
    tree = _nest(model.named_parameters())
    leaves = collectives.tree_leaves(tree)
    out["bucket_bytes"] = [
        sum(leaves[i].numel() * leaves[i].element_size() for i in b)
        for b in collectives.partition_buckets(tree, bucket_bytes)]
    x, y = next(iter(_resnet_chain(source)))
    x, y = (t.cuda() for t in shard_batch((x, y), strategy.mesh))
    fn, st = model.make_train_function(), model.train_state()
    out["step_ms"] = _ms(lambda: fn(*st, x, y), DP_TIMED)
    grads = [p.grad for p in model.parameters()]
    loss = torch.zeros((), device="cuda")
    if bucket_bytes:
        reduce = lambda: collectives.bucketed_all_reduce(
            _nest(zip(names, grads)), "mean", bucket_bytes=bucket_bytes)
    else:
        reduce = lambda: collectives.all_reduce([*grads, loss], "mean")
    out["reduce_ms"] = _ms(reduce, DP_TIMED)
    return out


def dp_worker(outdir: pathlib.Path) -> int:
    """Phase 24's worker (``chip_smoke.py --dp-worker DIR``, TF_CONFIG in
    the environment): ``MultiWorkerMirroredStrategy(communication="ring")``,
    gloo over CUDA tensors on the one card, the kernels phase 2 built;
    (a) the bucketed fit, (b) the default one with sync-BN, (d) the custom
    loop. Writes ``worker<rank>.pt`` into ``outdir``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    strategy = MultiWorkerMirroredStrategy(communication="ring")
    for source in SOURCES:
        _build.load(source)
    fashion = td_data.load("fashion_mnist", split="train")
    out = {"device": str(strategy.device),
           "backend": torch.distributed.get_backend()}
    for label, bucket_bytes in (("bucketed", DP_BUCKET_BYTES),
                                ("default", 0)):
        out[label] = _dp_fit(strategy, fashion, bucket_bytes)
        torch.cuda.empty_cache()
    from tpu_dist_torch.examples import custom_training_loop

    t0 = time.monotonic()
    out["loop"] = custom_training_loop.main(["--steps", str(DP_LOOP_STEPS)])
    out["loop_s"] = time.monotonic() - t0
    torch.save(_cpu(out), outdir / f"worker{bootstrap.process_index()}.pt")
    return 0


def _spawn_dp_workers(tmp: pathlib.Path, flag: str = "--dp-worker",
                      env: dict | None = None) -> list:
    """Both workers (``chip_smoke.py <flag> DIR``) to their end, each within
    DP_TIMEOUT_S; a failure or a hang raises with the tail of its log.
    Returns their records."""
    return _finish_dp_workers(tmp, *_start_dp_workers(tmp, flag, env))


def _start_dp_workers(tmp: pathlib.Path, flag: str = "--dp-worker",
                      env: dict | None = None) -> tuple:
    """Start :func:`_spawn_dp_workers`'s workers; ``(processes, logs,
    flag)`` for :func:`_finish_dp_workers`."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = pathlib.Path(__file__).resolve().parent
    procs, logs = [], []
    try:
        for rank, cfg in enumerate(make_local_cluster(DP_WORKERS,
                                                      base_port=port)):
            logs.append(open(tmp / f"worker{rank}.log", "w"))
            worker_env = dict(os.environ, **(env or {}),
                              TF_CONFIG=json.dumps(cfg),
                              PYTHONPATH=os.pathsep.join(
                                  filter(None, [str(root), os.environ.get(
                                      "PYTHONPATH")])))
            procs.append(subprocess.Popen(
                [sys.executable, str(root / "chip_smoke.py"), flag,
                 str(tmp)], cwd=root, env=worker_env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
    except BaseException:
        _stop_workers(procs, logs)
        raise
    return procs, logs, flag


def _stop_workers(procs: list, logs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()


def _finish_dp_workers(tmp: pathlib.Path, procs: list, logs: list,
                       flag: str) -> list:
    """Wait for started workers (see :func:`_spawn_dp_workers`)."""
    try:
        deadline = time.monotonic() + DP_TIMEOUT_S
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            if p.returncode != 0:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                tail = (tmp / f"worker{rank}.log").read_text()[-3000:]
                raise AssertionError(
                    f"({flag}) worker {rank} exit {p.returncode} (timeout "
                    f"{DP_TIMEOUT_S} s):\n{tail}")
    finally:
        _stop_workers(procs, logs)
    return [torch.load(tmp / f"worker{r}.pt", weights_only=False)
            for r in range(DP_WORKERS)]


def _equal(a, b) -> bool:
    """Bit for bit: floats, tensors and nests of them."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _epoch_means(losses: list, epochs: int = DP_EPOCHS,
                 steps: int = DP_STEPS) -> list:
    """Per-epoch means of per-step float32 losses, summed in float32 in
    order as the trainer's device accumulator sums them."""
    out = []
    for e in range(epochs):
        acc = np.float32(0.0)
        for v in losses[e * steps:(e + 1) * steps]:
            acc = np.float32(acc + np.float32(v))
        out.append(float(acc / np.float32(steps)))
    return out


def _bucketed_twin(batches, nudge: bool) -> dict:
    """The bucketed step's plain version in one process: each global
    batch's two halves through the model with local moments from the same
    state, their losses, gradients and states averaged, then unfused
    SGD."""
    model = _resnet(ResNet18, (28, 28, 1), fused_on=False)
    model.train()
    params, bufs = list(model.parameters()), list(model.buffers())
    if nudge:   # every weight one ulp up
        with torch.no_grad():
            for p in params:
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    opt_state = model.optimizer.init(params)
    losses, first = [], None
    for xb, yb in batches:
        xb, yb = (torch.from_numpy(np.asarray(a)).cuda() for a in (xb, yb))
        half = len(xb) // DP_WORKERS
        start = [b.clone() for b in bufs]
        parts = []
        for h in range(DP_WORKERS):
            rows = slice(h * half, (h + 1) * half)
            with torch.no_grad():
                for b, s in zip(bufs, start):
                    b.copy_(s)
            for p in params:
                p.grad = None
            loss = model.loss(model(xb[rows]), yb[rows])
            loss.backward()
            parts.append((loss.detach(), [p.grad for p in params],
                          [b.clone() for b in bufs]))
        (l0, g0, s0), (l1, g1, s1) = parts
        with torch.no_grad():
            for b, u, v in zip(bufs, s0, s1):
                b.copy_((u + v) / DP_WORKERS)
        grads = [(u + v) / DP_WORKERS for u, v in zip(g0, g1)]
        model.optimizer.update(grads, opt_state, params)
        losses.append(float((l0 + l1) / DP_WORKERS))
        if first is None:
            first = (losses[0], _params(model), _bn_state(model))
    return _cpu({"loss": _epoch_means(losses), "first": first,
                 "params": _params(model), "state": _bn_state(model)})


def _global_fit_twin(source, nudge: bool) -> dict:
    """The default schedule's plain version: one process fits the global
    batch of 256 unfused (its BatchNorm's moments are the batch's)."""
    model = _resnet(ResNet18, (28, 28, 1), fused_on=False)
    if nudge:
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    first = _FirstStep()
    h = model.fit(_resnet_chain(source), epochs=DP_EPOCHS,
                  steps_per_epoch=DP_STEPS, verbose=0, callbacks=[first])
    return _cpu({"loss": h.history["loss"], "first": first.taken,
                 "params": _params(model), "state": _bn_state(model)})


def _dp_check(label: str, workers: list, twin: dict, nudged: dict) -> tuple:
    """Both workers bit for bit; against the twin, phase 22's tolerances
    after the first step and its drift rule after the last. Returns the
    gaps (first, end, one-ulp twin's)."""
    a, b = (w[label] for w in workers)
    for key in ("loss", "first", "params", "state", "counts",
                "bucket_launches"):
        if not _equal(a[key], b[key]):
            raise AssertionError(f"(24) {label}: the workers' {key} differ")

    def gaps(x, y):
        return (max(abs(u - v) for u, v in zip(x["loss"], y["loss"])),
                _max_diff(x["params"], y["params"]),
                _state_diff(x["state"], y["state"]))

    first = (abs(a["first"][0] - twin["first"][0]),
             _max_diff(a["first"][1], twin["first"][1]),
             _state_diff(a["first"][2], twin["first"][2]))
    end, ulp = gaps(a, twin), gaps(nudged, twin)
    if (first[0] > RESNET_LOSS_ATOL or first[1] > RESNET_PARAM_ATOL
            or first[2] > RESNET_STATE_TOL
            or any(f > RESNET_DRIFT * u for f, u in zip(end, ulp))
            or not np.isfinite(a["loss"]).all()):
        raise AssertionError(
            f"(24) {label} against its twin: after one step losses, params, "
            f"BN state {first} (limits {RESNET_LOSS_ATOL:g}, "
            f"{RESNET_PARAM_ATOL:g}, {RESNET_STATE_TOL:g}); after "
            f"{DP_EPOCHS * DP_STEPS} {end} against the one-ulp twin's {ulp} "
            f"(x {RESNET_DRIFT:g}); losses {a['loss']}")
    return first, end, ulp


def _loop_twin(steps: int, nudge: bool = False) -> dict:
    """The custom loop in one process on the global batch: both workers'
    pipelines (seeded by their ids) side by side, the example's step on
    ``Model.apply`` and SGD(0.01); ``nudge`` starts every weight one ulp
    up."""
    from tpu_dist_torch.ops.losses import sparse_categorical_crossentropy
    from tpu_dist_torch.parallel import InputContext

    model = build_cnn_model()
    variables = model.init(seed=0)
    state = collectives.tree_map(lambda t: t.cuda(), variables["state"])
    params = collectives.tree_map(lambda t: t.cuda(), variables["params"])
    leaves = [p.requires_grad_() for p in collectives.tree_leaves(params)]
    if nudge:
        with torch.no_grad():
            for p in leaves:
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    opt = SGD(learning_rate=0.01)
    opt_state = opt.init(leaves)
    streams = []
    for i in range(DP_WORKERS):
        ctx = InputContext(DP_WORKERS, i, DP_WORKERS)
        ds = td_data.load("mnist", split="train", synthetic_size=4096).map(
            lambda x, y: (np.asarray(x, np.float32) / 255.0, y))
        streams.append(iter(ds.shuffle(1024, seed=i).batch(
            ctx.get_per_replica_batch_size(8 * DP_WORKERS)).repeat()))
    losses = []
    for _ in range(steps):
        halves = [next(s) for s in streams]
        x, y = (torch.from_numpy(np.concatenate([h[j] for h in halves]))
                .cuda() for j in (0, 1))
        logits, _ = model.apply(params, state, x, training=True)
        loss = sparse_categorical_crossentropy(logits, y).mean()
        grads = list(torch.autograd.grad(loss, leaves))
        opt.update(grads, opt_state, leaves)
        losses.append(float(loss.detach()))
    return {"losses": losses,
            "params": {k: v.detach().cpu().numpy()
                       for k, v in _flatten(params).items()}}


def _trace_kernels(directory: pathlib.Path) -> dict:
    """``{kernel name: (calls, device us)}`` of the one trace file in
    ``directory``."""
    (trace,) = directory.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            calls, us = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (calls + 1, us + float(e.get("dur", 0.0)))
    return out


def _kernel_family(name: str) -> str:
    n = name.lower()
    if "flash" in n:
        return "flash attention (rows 6-9)"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "cublas")):
        return "matmuls (cuBLAS fp32)"
    if "softmax" in n:
        return "softmax"
    if "reduce" in n:
        return "reductions"
    if any(s in n for s in ("elementwise", "vectorized", "unrolled")):
        return "elementwise"
    return "other"


def profile_phase(card: str, sgd_step_ms: float) -> dict:
    """Phase 24 (c): ``fit(profile_dir=)`` of phase 9's LM, the trace's
    flash launches and top kernels; and a captured CNN program inside a
    trace against one outside it. Returns the flash launches."""
    depth = LM["depth"]
    model = _compiled_lm(SGD(learning_rate=0.001))
    x, y = (t.cpu().numpy() for t in _bench_tokens(
        TRAIN_BATCH * (PROFILE_STEPS + 1)))
    data = td_data.Dataset.from_tensor_slices((x, y)).batch(TRAIN_BATCH)
    model.fit(data, epochs=1, steps_per_epoch=1, verbose=0)   # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        _reset_counts()
        t0 = time.monotonic()
        h = model.fit(data, epochs=1, steps_per_epoch=PROFILE_STEPS,
                      verbose=0, profile_dir=tmp / "lm")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
        kernels = _trace_kernels(tmp / "lm")
        calls = lambda key: sum(c for n, (c, _) in kernels.items()
                                if key in n)
        want = depth * PROFILE_STEPS
        seen = {k: calls(k) for k in ("flash_fwd_kernel",
                                      "flash_bwd_dq_kernel",
                                      "flash_bwd_dkv_kernel",
                                      "flash_bwd_delta_kernel")}
        if (counts[:2] != (want, want) or set(seen.values()) != {want}
                or not np.isfinite(h.history["loss"]).all()):
            raise AssertionError(f"(24 c) profiled LM fit: launches "
                                 f"{counts[:2]}, in the trace {seen}; "
                                 f"expected {want} each")
        total = sum(us for _, us in kernels.values())
        step_ms = total / 1e3 / PROFILE_STEPS
        log(f"[24 profile] (c) fit(profile_dir=D) of the LM at batch "
            f"{TRAIN_BATCH} x {LM['seq_len']}, SGD, {PROFILE_STEPS} steps "
            f"in {wall:.3f} s (traced): one trace in D; flash launches "
            f"{counts[0]} fwd, {counts[1]} bwd = depth {depth} x "
            f"{PROFILE_STEPS}, in the trace {seen}; device kernel time "
            f"{step_ms:.4f} ms a step against phase 11's untraced step "
            f"{sgd_step_ms:.4f} ms ({card})")
        for name, (c, us) in sorted(kernels.items(),
                                    key=lambda r: -r[1][1])[:10]:
            log(f"    {us / 1e3 / PROFILE_STEPS:9.4f} ms a step "
                f"({us / 1e3 / PROFILE_STEPS / sgd_step_ms * 100:5.1f} % of "
                f"the step, {us / total * 100:5.1f} % of its kernel time), "
                f"{c // PROFILE_STEPS} calls a step: {name[:110]}")
        families: dict = {}
        for name, (_, us) in kernels.items():
            f = _kernel_family(name)
            families[f] = families.get(f, 0.0) + us
        log("[24 profile] (c) by family, ms a step: " + "; ".join(
            f"{f} {us / 1e3 / PROFILE_STEPS:.4f} ({us / total * 100:.1f} %)"
            for f, us in sorted(families.items(), key=lambda r: -r[1])))
        # A captured program inside a trace: the CNN at k = 4 (phase 20's
        # family) traced and untraced, bit for bit (cuDNN deterministic).
        runs = []
        flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        for profile_dir in (None, tmp / "cnn"):
            strategy = MultiWorkerMirroredStrategy()
            with strategy.scope():
                cnn = build_cnn_model()
                cnn.compile(optimizer=SGD(learning_rate=0.001, fused=True),
                            loss=SparseCategoricalCrossentropy(
                                from_logits=True, fused=True),
                            steps_per_execution=4)
            _reset_counts()
            hc = cnn.fit(_chain(False), epochs=2, steps_per_epoch=CNN_STEPS,
                         verbose=0, profile_dir=profile_dir).history
            (graphed,) = cnn._trainer._graphed.values()
            (prog, _), = graphed.programs.values()
            runs.append((hc["loss"], _params(cnn), prog.replays, _counts()))
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
        sgd_in_trace = sum(c for n, (c, _) in _trace_kernels(
            tmp / "cnn").items() if "fused_sgd_kernel" in n)
        if (runs[0][0] != runs[1][0] or not _equal(runs[0][1], runs[1][1])
                or runs[1][2] < 1):
            raise AssertionError(f"(24 c) captured inside a trace: losses "
                                 f"{runs[1][0]} vs {runs[0][0]}, replays "
                                 f"{runs[1][2]}")
        log(f"[24 profile] (c) the CNN at k = 4 on its captured program "
            f"inside a trace: losses and parameters equal an untraced fit's "
            f"bit for bit, {runs[1][2]} replays; fused SGD launches "
            f"{runs[1][3][5]}, in the trace {sgd_in_trace} (a replay's "
            f"kernels {'are' if sgd_in_trace == runs[1][3][5] else 'are not all'}"
            f" in the trace)")
    del model
    torch.cuda.empty_cache()
    return {"fwd": counts[0], "bwd": counts[1]}


def dp_phase(card: str) -> dict:
    """Phase 24 (a), (b), (d), (e): two workers on the card over gloo
    (``communication="ring"``) against single-process twins. Returns the
    workers' launches of rows 1-3 on each path."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        workers = _spawn_dp_workers(pathlib.Path(tmp))
        workers_s = time.monotonic() - t0
    if {w["device"] for w in workers} != {"cuda:0"} or \
            {w["backend"] for w in workers} != {"gloo"}:
        raise AssertionError(f"(24) workers on {[w['device'] for w in workers]}"
                             f" over {[w['backend'] for w in workers]}")
    steps = DP_EPOCHS * DP_STEPS
    want = (0, 0, 0, steps, steps, steps)
    source = td_data.load("fashion_mnist", split="train")
    batches = list(itertools.islice(iter(_resnet_chain(source)), steps))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        twins = {"bucketed": (_bucketed_twin(batches, False),
                              _bucketed_twin(batches, True)),
                 "default": (_global_fit_twin(source, False),
                             _global_fit_twin(source, True))}
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    out = {}
    for label, schedule in (("bucketed", f"gradient_bucket_bytes="
                                         f"{DP_BUCKET_BYTES}: local moments,"
                                         f" buckets, the state averaged"),
                            ("default", "gradient_bucket_bytes=0: sync-BN "
                                        "over gloo on CUDA tensors, one "
                                        "flat all-reduce")):
        w = workers[0][label]
        n_buckets = len(w["bucket_bytes"])
        launches = n_buckets * steps if label == "bucketed" else 0
        synced = set(w["synced"])
        if (w["counts"] != want or w["bucket_launches"] != launches
                or synced != {label == "default"}):
            raise AssertionError(
                f"(24) {label}: launches {w['counts']} (expected {want}), "
                f"bucket launches {w['bucket_launches']} (expected "
                f"{launches}), BatchNorm synchronized {synced}")
        first, end, ulp = _dp_check(label, workers, *twins[label])
        log(f"[24 dp] ({'a' if label == 'bucketed' else 'b'}) resnet18, two "
            f"workers on one card (communication=ring: gloo on CUDA "
            f"tensors), {schedule}; {DP_EPOCHS} x {DP_STEPS} steps of "
            f"{RESNET_BATCH} ({RESNET_BATCH // DP_WORKERS} a worker): losses "
            f"{[round(v, 6) for v in w['loss']]}, the workers bit for bit "
            f"(losses, parameters, BN state after one step and after "
            f"{steps}); against the single-process twin after one step "
            f"{first[0]:.3e}, {first[1]:.3e}, {first[2]:.3e} (limits "
            f"{RESNET_LOSS_ATOL:g}, {RESNET_PARAM_ATOL:g}, "
            f"{RESNET_STATE_TOL:g}), after {steps} {end[0]:.3e}, "
            f"{end[1]:.3e}, {end[2]:.3e}, where the one-ulp twin drifts "
            f"{ulp[0]:.3e}, {ulp[1]:.3e}, {ulp[2]:.3e} (limit "
            f"{RESNET_DRIFT:g} x); launches CE fwd {w['counts'][3]}, CE bwd "
            f"{w['counts'][4]}, SGD {w['counts'][5]} a worker; bucket "
            f"collectives {w['bucket_launches']}"
            + (f" = {n_buckets} buckets x {steps} steps" if launches
               else " (one flat all-reduce a step)"))
        out[label] = w["counts"]
    # (d) the custom training loop.
    a, b = (w["loop"] for w in workers)
    means = a["mean_of_replicas"]
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        twin, nudged = (_loop_twin(DP_LOOP_STEPS, nudge)
                        for nudge in (False, True))
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags

    def gaps(x, y):
        loss = [abs(u - v) for u, v in zip(x["losses"], y["losses"])]
        return (max(loss[:LOOP_CLOSE_STEPS]), max(loss),
                max(float(np.abs(x["params"][k] - v).max())
                    for k, v in y["params"].items()))

    if sorted(a["params"]) != sorted(twin["params"]):
        raise AssertionError(f"(24 d) parameter names {sorted(a['params'])}")
    gap, ulp = gaps(a, twin), gaps(nudged, twin)
    falls = np.mean(a["losses"][-10:]) < np.mean(a["losses"][:10])
    if (a["per_replica"] != b["per_replica"] or a["losses"] != b["losses"]
            or any(not np.array_equal(a["params"][k], b["params"][k])
                   for k in a["params"])
            or any(abs(means[s] - np.float32(sum(np.float32(v) for v in r))
                       / np.float32(len(r))) > 1e-6
                   for s, r in a["per_replica"].items())
            or gap[0] > CNN_LOSS_ATOL
            or any(g > RESNET_DRIFT * u for g, u in zip(gap[1:], ulp[1:]))
            or not falls):
        raise AssertionError(
            f"(24 d) custom loop: per-replica {a['per_replica']} vs "
            f"{b['per_replica']}, means {means}; against the twin: losses "
            f"of the first {LOOP_CLOSE_STEPS} steps {gap[0]:.3e}, all "
            f"{gap[1]:.3e}, params {gap[2]:.3e}, the one-ulp twin's "
            f"{ulp[1]:.3e}, {ulp[2]:.3e}; falls {falls}")
    log(f"[24 dp] (d) examples/custom_training_loop.py on two workers, "
        f"{DP_LOOP_STEPS} steps of 8 a replica in {workers[0]['loop_s']:.2f}"
        f" s: loss {a['losses'][0]:.4f} -> {a['losses'][-1]:.4f}; "
        f"strategy.run's per-replica losses identical on both workers "
        f"{ {s: [round(v, 4) for v in r] for s, r in a['per_replica'].items()} }, "
        f"reduce('mean') their mean; parameters bit for bit across workers;"
        f" against the single-process twin on the global batch: losses of "
        f"the first {LOOP_CLOSE_STEPS} steps {gap[0]:.3e} (limit "
        f"{CNN_LOSS_ATOL:g}), of all {gap[1]:.3e}, parameters {gap[2]:.3e},"
        f" where the twin started one ulp off drifts {ulp[1]:.3e}, "
        f"{ulp[2]:.3e} (limit {RESNET_DRIFT:g} x)")
    # (e) times.
    for label in ("bucketed", "default"):
        w = [x[label] for x in workers]
        sizes = w[0]["bucket_bytes"]
        log(f"[24 times] (e) resnet18 at two workers, {label}: "
            f"{[round(x['step_ms'], 4) for x in w]} ms a step (workers 0, "
            f"1; {DP_TIMED} steps of 128 rows each after 2), the gradient "
            f"reduction alone {[round(x['reduce_ms'], 4) for x in w]} ms "
            f"({len(sizes)} collective(s) over {sum(sizes)} bytes; buckets "
            f"{min(sizes)}-{max(sizes)} bytes). These time gloo staging "
            f"each collective through the host, two processes sharing one "
            f"card, not NCCL ({card})")
    log(f"[24 dp] the workers ran in {workers_s:.1f} s")
    torch.cuda.empty_cache()
    return out


# -- phase 25: sharded files and AutoShardPolicy.FILE -------------------------

FILE_SHARDS, FILE_BATCH, FILE_SEED = 8, 128, 5
FILE_EPOCHS, FILE_STEPS = 2, 20


def _file_chain():
    """The reference program's chain over the shard files under
    ``$TPU_DIST_DATA_DIR`` (load -> map(scale) -> cache -> shuffle ->
    batch(GLOBAL)), AUTO as left by default, the shuffle seeded so that a
    twin can rebuild each worker's batches."""
    return (td_data.load("mnist", split="train").map(_scale_div).cache()
            .shuffle(10000, seed=FILE_SEED).batch(FILE_BATCH))


def _shard_files(directory) -> list:
    return sorted(pathlib.Path(directory).glob("mnist-train.shard-*.npz"))


def _direct_read(files) -> tuple:
    """The files' images and labels read with numpy, file after file."""
    xs, ys = [], []
    for f in files:
        with np.load(f) as z:
            xs.append(z["images"])
            ys.append(z["labels"].astype(np.int64))
    return np.concatenate(xs), np.concatenate(ys)


def file_worker(outdir: pathlib.Path) -> int:
    """Phase 25's worker (``chip_smoke.py --file-worker DIR``, TF_CONFIG
    and ``TPU_DIST_DATA_DIR`` in the environment): its element stream under
    AUTO (FILE over the shard files), then the reference program's CNN
    with the fused CE and ``SGD(fused=True)`` fit on the FILE-sharded
    chain. Writes ``worker<rank>.pt`` into ``outdir``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    strategy = MultiWorkerMirroredStrategy(communication="ring")
    for source in SOURCES:
        _build.load(source)
    rank, n = bootstrap.process_index(), bootstrap.process_count()
    source = td_data.load("mnist", split="train")
    local = td_data.shard_dataset(source, n, rank)
    xs = np.stack([x for x, _ in local])
    ys = np.array([y for _, y in local])
    dist = td_data.DistributedDataset(_file_chain(), strategy, prefetch=None)
    with strategy.scope():
        model = build_cnn_model()
        model.compile(optimizer=SGD(learning_rate=0.001, fused=True),
                      loss=SparseCategoricalCrossentropy(from_logits=True,
                                                         fused=True),
                      metrics=[SparseCategoricalAccuracy()])
    _reset_counts()
    t0 = time.monotonic()
    h = model.fit(_file_chain(), epochs=FILE_EPOCHS,
                  steps_per_epoch=FILE_STEPS, verbose=0)
    torch.cuda.synchronize()
    out = {"rank": rank, "policy": dist.auto_shard_policy.name,
           "num_files": source.num_files,
           "local_batches": dist.cardinality(),
           "stream": (xs, ys), "loss": h.history["loss"],
           "counts": _counts(), "params": _params(model),
           "fit_s": time.monotonic() - t0}
    torch.save(_cpu(out), outdir / f"worker{rank}.pt")
    return 0


def _file_twin(per_worker: list) -> dict:
    """The plain version in one process: each step's two per-worker
    batches through the unfused CNN, their losses and gradients averaged,
    then unfused SGD."""
    model = build_cnn_model()
    model.compile(optimizer=SGD(learning_rate=0.001),
                  loss=SparseCategoricalCrossentropy(from_logits=True),
                  metrics=[SparseCategoricalAccuracy()])
    model.train()
    params = list(model.parameters())
    opt_state = model.optimizer.init(params)
    losses = []
    for step in zip(*per_worker):
        parts = []
        for xb, yb in step:
            xb, yb = (torch.from_numpy(np.asarray(a)).cuda()
                      for a in (xb, yb))
            for p in params:
                p.grad = None
            loss = model.loss(model(xb), yb)
            loss.backward()
            parts.append((loss.detach(), [p.grad for p in params]))
        (l0, g0), (l1, g1) = parts
        grads = [(u + v) / DP_WORKERS for u, v in zip(g0, g1)]
        model.optimizer.update(grads, opt_state, params)
        losses.append(float((l0 + l1) / DP_WORKERS))
    return {"loss": _epoch_means(losses, FILE_EPOCHS, FILE_STEPS),
            "params": _params(model)}


def file_phase(card: str) -> tuple:
    """Phase 25: ``write_sharded`` splits the synthetic MNIST into
    FILE_SHARDS files, two workers fit the reference program's CNN on
    the AUTO (= FILE) sharded chain over gloo. Returns each worker's
    (CE fwd, CE bwd, SGD) launches."""
    images, labels = td_data.load_arrays("mnist")
    steps = FILE_EPOCHS * FILE_STEPS
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        td_data.write_sharded(tmp / "data", "mnist", "train", images, labels,
                              FILE_SHARDS)
        write_s = time.perf_counter() - t0
        env = {td_data.sources.DATA_DIR_ENV: str(tmp / "data")}
        old = os.environ.get(td_data.sources.DATA_DIR_ENV)
        os.environ.update(env)
        try:
            t0 = time.monotonic()
            workers = _spawn_dp_workers(tmp, "--file-worker", env)
            workers_s = time.monotonic() - t0
            direct = [_direct_read(_shard_files(tmp / "data")[i::DP_WORKERS])
                      for i in range(DP_WORKERS)]
            # Each worker's batches as an independent construction gives
            # them: the chain, sharded for worker i of 2.
            per_worker = [list(itertools.islice(iter(td_data.shard_dataset(
                _file_chain(), DP_WORKERS, i, pre_batched=True)), steps))
                for i in range(DP_WORKERS)]
            # Host ms a batch of the file-backed element path: the first
            # pass reads the files, later passes the cache.
            chain = (td_data.load("mnist", split="train").map(_scale_div)
                     .cache().shuffle(10000, seed=1).batch(CNN_BATCH))
            n = len(images) // CNN_BATCH - 2
            t0 = time.perf_counter()
            first_pass = list(chain)
            first_ms = (time.perf_counter() - t0) / len(first_pass) * 1e3
            file_ms = _host_ms_per_batch(chain, n)
        finally:
            if old is None:
                os.environ.pop(td_data.sources.DATA_DIR_ENV)
            else:
                os.environ[td_data.sources.DATA_DIR_ENV] = old
    memory_ms = _host_ms_per_batch(_chain(shuffle=True, seed=1), n)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        twin = _file_twin(per_worker)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    want_counts = (0, 0, 0, steps, steps, steps)
    streams = []
    for rank, w in enumerate(workers):
        dx, dy = direct[rank]
        sx, sy = w["stream"]
        if not (np.array_equal(sx, dx) and np.array_equal(sy, dy)):
            raise AssertionError(f"(25) worker {rank}'s element stream is "
                                 f"not files {rank}, {rank + 2}, ... read "
                                 "directly")
        if (w["policy"] != "FILE" or w["num_files"] != FILE_SHARDS
                or w["local_batches"] != len(images) // FILE_BATCH
                or w["counts"] != want_counts):
            raise AssertionError(
                f"(25) worker {rank}: policy {w['policy']}, "
                f"{w['num_files']} files, {w['local_batches']} local "
                f"batches, launches {w['counts']} (expected {want_counts})")
        streams.append(sx.reshape(len(sx), -1))
    ids = [{row.tobytes() for row in s} for s in streams]
    union = {row.tobytes() for row in images.reshape(len(images), -1)}
    if ids[0] & ids[1] or (ids[0] | ids[1]) != union or \
            sum(len(s) for s in streams) != len(images):
        raise AssertionError("(25) the workers' streams are not a disjoint "
                             "split of the dataset")
    a, b = workers
    if a["loss"] != b["loss"] or not _equal(a["params"], b["params"]):
        raise AssertionError(f"(25) the workers part: {a['loss']} vs "
                             f"{b['loss']}")
    loss_gap = max(abs(u - v) for u, v in zip(a["loss"], twin["loss"]))
    param_gap = _max_diff(a["params"], [p.cpu() for p in twin["params"]])
    if loss_gap > CNN_LOSS_ATOL:
        raise AssertionError(f"(25) losses {a['loss']} vs the twin's "
                             f"{twin['loss']}: {loss_gap:.3e}")
    log(f"[25 file] write_sharded: {len(images)} synthetic MNIST images in "
        f"{FILE_SHARDS} files in {write_s:.4f} s; load('mnist') found "
        f"{a['num_files']} files through {td_data.sources.DATA_DIR_ENV}; "
        f"AUTO resolved to {a['policy']} on both workers, each reads files "
        f"i, i+2, ... ({a['local_batches']} batches of "
        f"{FILE_BATCH // DP_WORKERS}), bit for bit a direct read; the two "
        f"streams disjoint, their union the dataset")
    log(f"[25 file] reference program's CNN on the FILE-sharded chain, two "
        f"workers (communication=ring, gloo), global batch {FILE_BATCH}, "
        f"fused CE + SGD(fused=True), {FILE_EPOCHS} x {FILE_STEPS} steps in "
        f"{a['fit_s']:.2f} s / {b['fit_s']:.2f} s (workers ran "
        f"{workers_s:.1f} s): losses {[round(v, 6) for v in a['loss']]}, "
        f"the workers bit for bit (losses, parameters); launches CE fwd "
        f"{a['counts'][3]}, CE bwd {a['counts'][4]}, SGD {a['counts'][5]} "
        f"a worker; against the single-process twin on the same per-worker "
        f"batches (gradients averaged, unfused): losses {loss_gap:.3e} "
        f"(limit {CNN_LOSS_ATOL:g}), parameters {param_gap:.3e}")
    log(f"[25 times] host input, file-backed element path (8 npz files): "
        f"first pass {first_ms:.4f} ms a batch of {CNN_BATCH} (reads the "
        f"files), cached {file_ms:.4f} ms; phase 21's in-memory element "
        f"path {memory_ms:.4f} ms ({card})")
    return tuple(w["counts"][3:] for w in workers)


# -- phase 26: serving resilience ---------------------------------------------

#: Steps the first journaled engine serves before it is abandoned.
CRASH_STEPS = 6
#: Phase 5's full-width CLI arguments (8 seeded requests).
SERVE_ARGS = ["--requests", "8", "--max-len", str(LM["seq_len"]),
              "--vocab", str(LM["vocab_size"]), "--d-model",
              str(LM["d_model"]), "--depth", str(LM["depth"]),
              "--num-heads", str(LM["num_heads"]), "--min-new", "8",
              "--max-new", "16"]
CHAOS_TIMEOUT_S = 400
#: Journal-cost workload: 8 requests of 64 prompt tokens and 128 new ones,
#: so every step after the admitting one decodes the full bucket of 8.
COST_PROMPT, COST_NEW = 64, 128


def _recovered_streams(model, specs, kw: dict) -> tuple:
    """Phase 4's requests through a journaled engine abandoned after
    CRASH_STEPS steps with its unflushed tail dropped, then a second engine
    recovering from the journal. Returns (requests as the journal ends
    them, the replay, the pending rids at the crash, prefills, flash
    launches, seconds to build the recovering engine, its run's seconds)."""
    from types import SimpleNamespace

    from tpu_dist_torch.serve import journal

    metrics.get_registry().reset()
    metrics.enable()
    fa.flash_attention_fwd.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        first = ServeEngine(model, max_batch=8, max_len=LM["seq_len"],
                            journal=tmp, **kw)
        for p, m in specs:
            first.submit(p, max_new_tokens=m)
        for _ in range(CRASH_STEPS):
            first.step()
        first.journal._buf.clear()
        del first
        torch.cuda.synchronize()
        active, queued = journal.load(pathlib.Path(tmp) /
                                      journal.JOURNAL_NAME).pending()
        t0 = time.perf_counter()
        second = ServeEngine(model, max_batch=8, max_len=LM["seq_len"],
                             journal=tmp, **kw)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        second.run_until_idle()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        second.close()
        state = journal.load(pathlib.Path(tmp) / journal.JOURNAL_NAME)
    metrics.disable()
    prefills = metrics.get_registry().counter("serve.prefills").value
    reqs = [SimpleNamespace(rid=rid, prompt=jr.prompt, generated=jr.tokens,
                            finished=jr.finished, budget=jr.max_new_tokens)
            for rid, jr in sorted(state.requests.items())]
    pending = ([r.rid for r in active], [r.rid for r in queued])
    return (reqs, second.last_replay, pending, prefills,
            fa.flash_attention_fwd.launches, build_s, run_s)


def _chaos_cli(args: list, tmp: pathlib.Path) -> dict:
    """``python -m tpu_dist_torch.serve --chaos ARGS`` as a subprocess to
    its end; its report, which must pass every gate."""
    root = pathlib.Path(__file__).resolve().parent
    report_path = tmp / "report.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.serve", "--chaos", *args,
         "--workdir", str(tmp / "work"), "--report", str(report_path)],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=CHAOS_TIMEOUT_S)
    wall = time.monotonic() - t0
    if proc.returncode != 0 or not report_path.exists():
        logs = "".join(p.read_text()[-1500:] for p in sorted(
            (tmp / "work" / "logs").glob("*.log"))) \
            if (tmp / "work" / "logs").is_dir() else ""
        raise AssertionError(f"(26) --chaos {args[:2]} exit "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-2000:]}\n{logs}")
    report = json.loads(report_path.read_text())
    eng = report.get("engine")
    if not report["ok"] or (eng is not None and not (
            eng["success"] and eng["faults_fired"] and eng["restarts"] >= 1
            and eng["journal_replays"] and eng.get("parity_ok"))):
        raise AssertionError(f"(26) --chaos {args[:2]}: {report}")
    report["wall_s"] = wall
    return report


def _journal_cost(model, card: str) -> None:
    """(d): decode tok/s and the decode step's ms with the journal (one
    write and one fsync a step) and without it, in turns off, on, on,
    off; the flush's ms and bytes a step."""
    rng = np.random.default_rng(11)
    specs = [(rng.integers(0, LM["vocab_size"], size=COST_PROMPT).tolist(),
              COST_NEW) for _ in range(8)]
    warm = [(p, 4) for p, _ in specs]
    runs = {"off": [], "on": []}
    flushes = []
    for label in ("off", "on", "on", "off"):
        with tempfile.TemporaryDirectory() as tmp:
            engine = ServeEngine(model, max_batch=8, max_len=LM["seq_len"],
                                 journal=tmp if label == "on" else None)
            for _ in range(2):      # the programs run eagerly, then capture
                for p, m in warm:
                    engine.submit(p, max_new_tokens=m)
                engine.run_until_idle()
            if engine.journal is not None:
                flush, path = engine.journal.flush, engine.journal.path

                def timed_flush(flush=flush, path=path):
                    size = path.stat().st_size if path.exists() else 0
                    t0 = time.perf_counter()
                    n = flush()
                    flushes.append(((time.perf_counter() - t0) * 1e3,
                                    path.stat().st_size - size, n))
                    return n

                engine.journal.flush = timed_flush
                flushes.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [engine.submit(p, max_new_tokens=m) for p, m in specs]
            engine.step()
            steps = []
            while not engine.scheduler.idle():
                t1 = time.perf_counter()
                engine.step()
                steps.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            engine.close()
        if not all(len(r.generated) == COST_NEW for r in reqs):
            raise AssertionError("(26 d) a request missed its budget")
        runs[label].append((8 * COST_NEW / wall,
                            statistics.median(steps[:-1])))
        if label == "on":
            decode = [f for f in flushes if f[2] == 8]
            # Steps 2 .. COST_NEW - 1 flush a token record a request (the
            # first also the submits, the last the finishes).
            if len(decode) != COST_NEW - 3:
                raise AssertionError(f"(26 d) {len(decode)} flushes of 8 "
                                     "token records")
            log(f"[26 times] (d) journal flush (one write + one fsync of a "
                f"step's 8 token records): median "
                f"{statistics.median(f[0] for f in decode):.4f} ms, max "
                f"{max(f[0] for f in decode):.4f} ms, "
                f"{statistics.median(f[1] for f in decode):.0f} bytes a "
                f"step ({card})")
    for label, values in runs.items():
        log(f"[26 times] (d) decode, 8 requests x {COST_NEW} tokens at "
            f"full width, journal {label}: "
            f"{[round(v[0], 2) for v in values]} tok/s; decode step "
            f"(bucket 8, captured) median "
            f"{[round(v[1], 4) for v in values]} ms ({card})")


def resilience_phase(card: str, contiguous_streams: list) -> dict:
    """Phase 26: journal recovery in process (contiguous and int8 ragged
    pool), the chaos CLI's crash and stall runs, the storm, the journal's
    cost. Returns the flash forward's launches on each path."""
    model = _serve_lm()
    specs = _serve_specs()
    out = {}
    # (a) In process.
    paged_kw = dict(paged=True, page_size=16, kv_dtype="int8", ragged=True)
    base = ServeEngine(model, max_batch=8, max_len=LM["seq_len"],
                       **paged_kw)
    int8_streams = [r.generated for r in _drain(base, specs)[0]]
    del base
    for label, kw, want in (("contiguous", {}, contiguous_streams),
                            ("int8 ragged pool", paged_kw, int8_streams)):
        (reqs, replay, pending, prefills, launches, build_s,
         run_s) = _recovered_streams(model, specs, kw)
        if not all(r.finished and len(r.generated) == r.budget
                   for r in reqs) or len(reqs) != len(specs):
            raise AssertionError(f"(26 a) {label}: not every request "
                                 "finished with its budget")
        if (replay["active"], replay["queued"]) != pending or \
                not replay["active"]:
            raise AssertionError(f"(26 a) {label}: the replay names "
                                 f"{replay}, the journal held {pending}")
        ties = _ties(model, reqs, want, f"(26 a) {label}")
        want_launches = 0 if kw else LM["depth"] * prefills
        if launches != want_launches or prefills <= len(specs):
            raise AssertionError(
                f"(26 a) {label}: flash launches {launches} for {prefills} "
                f"prefills (expected {want_launches})")
        out[f"resilient_serve_{'paged' if kw else 'contiguous'}"] = launches
        log(f"[26 resilience] (a) {label}: 16 requests, the engine "
            f"abandoned after {CRASH_STEPS} steps with its unflushed journal "
            f"tail dropped; the recovering engine's replay names active "
            f"{replay['active']} and queued {replay['queued']} as the "
            f"journal held them, finished {replay['completed']}; every "
            f"request done; streams equal the uninterrupted run's with "
            f"{ties} certified ties; prefills {prefills} (16 + "
            f"{prefills - 16} re-prefills), flash launches {launches}"
            f"{' = depth x prefills' if not kw else ' (dense attention)'}; "
            f"replay_s {replay['replay_s']:.6f} s, recovering engine built "
            f"in {build_s:.4f} s, served the rest in {run_s:.4f} s ({card})")
    # (b) The chaos CLI: a crash, then a stall past a timeout above the
    # slowest step a fresh worker took.
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        crash = _chaos_cli(["--plan", "engine_crash@req6", *SERVE_ARGS],
                           tmp / "crash")
        final = crash["engine"]["final_result"]
        timeout = round(max(2.0, 3 * final["max_step_s"]), 1)
        stall_s = timeout + 2.0
        log(f"[26 resilience] (b) a fresh worker captured graphs for "
            f"{final['capture_seconds']:.4f} s and its slowest step took "
            f"{final['max_step_s']:.4f} s: stall timeout {timeout} s, "
            f"decode_stall {stall_s} s")
        stall = _chaos_cli(["--plan", f"decode_stall@req6:{stall_s}s",
                            "--stall-timeout-s", str(timeout), *SERVE_ARGS],
                           tmp / "stall")
    for label, rep in (("engine_crash@req6", crash),
                       (f"decode_stall@req6:{stall_s}s", stall)):
        e = rep["engine"]
        log(f"[26 resilience] (b) python -m tpu_dist_torch.serve --chaos "
            f"--plan {label} (phase 5's arguments): exit 0, every gate true;"
            f" exit kinds {e['exit_kinds']}, restarts {e['restarts']}, "
            f"replay_s {[m['replay_s'] for m in e['journal_replays']]}, "
            f"restart to first token {e['restart_to_first_token_s']} s, "
            f"certified ties {len(e['certified_ties'])}, whole run "
            f"{rep['wall_s']:.1f} s ({card})")
    # (c) The storm at full width, in process (flash launches counted).
    buf = io.StringIO()
    fa.flash_attention_fwd.launches = 0
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["--chaos", "--plan", "request_storm@req0",
                       *SERVE_ARGS])
    report = json.loads(buf.getvalue())
    storm = report["storm"]
    sh, ctl = storm["shedding"], storm["control"]
    prefills = sh["completed"] + ctl["completed"]
    if rc != 0 or not storm.get("ok") or sh["shed"] <= 0 or \
            sh["p99_latency_virtual_s"] > storm["p99_target_s"] or \
            ctl["p99_latency_virtual_s"] <= storm["p99_target_s"] or \
            fa.flash_attention_fwd.launches != LM["depth"] * prefills:
        raise AssertionError(f"(26 c) storm: rc {rc}, {storm}, flash "
                             f"launches {fa.flash_attention_fwd.launches}")
    out["storm"] = fa.flash_attention_fwd.launches
    log(f"[26 resilience] (c) request_storm@req0 at full width, "
        f"{sh['requests']} requests on the virtual clock (target p99 "
        f"{storm['p99_target_s']} virtual s, BENCH_SERVE.json's config): "
        f"shedding completed {sh['completed']}, shed {sh['shed']} "
        f"{sh['shed_causes']}, p99 {sh['p99_latency_virtual_s']} s; control "
        f"completed {ctl['completed']}, p99 {ctl['p99_latency_virtual_s']} "
        f"s; flash launches {fa.flash_attention_fwd.launches} = depth x "
        f"{prefills} prefills")
    # (d) The journal's cost.
    _journal_cost(model, card)
    torch.cuda.empty_cache()
    return out


# -- phase 27: the serving fleet ----------------------------------------------

#: ``serve --fleet`` at phase 4's LM: 2 replicas, 4 sessions, 32 requests.
FLEET_ARGS = ["--fleet", "--fleet-replicas", "2", "--fleet-sessions", "4",
              "--requests", "32", "--max-len", str(LM["seq_len"]),
              "--vocab", str(LM["vocab_size"]), "--d-model",
              str(LM["d_model"]), "--depth", str(LM["depth"]),
              "--num-heads", str(LM["num_heads"])]
#: (b)'s plan: replica 0 dies at its 2nd completion, a 16-request burst
#: enters the router at the first submission.
FLEET_PLAN = "replica_kill@req2:replica0,router_storm@req0:x16"


def _fleet_cli(extra: list, deaths: list) -> tuple:
    """``python -m tpu_dist_torch.serve`` with FLEET_ARGS + ``extra``, in
    this process: (report, flash launches, prefills, wall s). Every gate
    must hold, and the replicas that died must be ``deaths``, a list of
    (replica, killed by the plan): a replica whose engine raised (a failed
    capture, a CUDA error) dies too, and its work fails over unseen by the
    gates."""
    out = io.StringIO()
    fa.flash_attention_fwd.launches = 0
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = cli.main(FLEET_ARGS + extra)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = fa.flash_attention_fwd.launches
    text = out.getvalue()
    report = json.loads(text[text.index("\n{") + 1:text.rindex("\n}") + 2])
    prefills = metrics.get_registry().counter("serve.prefills").value
    metrics.disable()
    died = [(d["replica"], d["killed"]) for d in report["deaths"]]
    if (rc != 0 or not report["ok"] or not all(report["gates"].values())
            or died != deaths):
        raise AssertionError(f"(27) serve {' '.join(extra)}: rc {rc}, "
                             f"gates {report['gates']}, deaths "
                             f"{report['deaths']}, expected {deaths}")
    if launches != LM["depth"] * prefills:
        raise AssertionError(
            f"(27) serve --fleet {' '.join(extra)}: flash launched "
            f"{launches} times for {prefills} prefills; expected depth x "
            "prefills")
    graphs = report["graphs"]
    if not graphs or not all(g["captured"] > 0 and g["replays"] > 0
                             for g in graphs.values()):
        raise AssertionError(f"(27) a replica did not capture and replay: "
                             f"{graphs}")
    return report, launches, prefills, wall


def _fleet_workload(requests: int = 32) -> list:
    """The CLI's sessioned workload at FLEET_ARGS's arguments."""
    from types import SimpleNamespace

    from tpu_dist_torch.serve import fleet

    args = SimpleNamespace(seed=0, vocab=LM["vocab_size"],
                           max_len=LM["seq_len"], requests=requests,
                           min_new=4, max_new=24)
    return fleet._fleet_workload(args, sessions=4, page_size=16)


def _pool_bytes(engine) -> int | None:
    """Bytes of the segments of ``engine``'s graph pool, or None when the
    allocator's snapshot does not name pools."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    pool = tuple(engine._graph_pool)
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == pool)


def _fleet_run(model, work: list, replicas: int, *, passes: int = 2,
               autoscale=None, waves: int = 1,
               devices_per_replica=None, **engine_kw) -> tuple:
    """``work`` through a ServeFleet of ``replicas`` engines sharing
    ``model``, ``passes`` times (the first warms up: captures); returns
    (the fleet, the last pass's FleetRequests, its wall s, its route
    counts). ``waves > 1``
    submits the last pass in that many waves, an autoscale tick after
    each but the last."""
    from tpu_dist_torch.serve.fleet import ServeFleet

    def factory(i, *, journal, fault_injector):
        return ServeEngine(model, max_batch=8, max_len=LM["seq_len"],
                           seed=0, journal=journal,
                           fault_injector=fault_injector, **engine_kw)

    tmp = tempfile.mkdtemp(prefix="fleet-")
    fleet = ServeFleet(factory, replicas=replicas, page_size=16,
                       journal_root=tmp, autoscale=None,
                       devices_per_replica=devices_per_replica)
    fleet.start()
    for k in range(passes):
        last = k == passes - 1
        if last:
            fleet._autoscale = autoscale
            before = dict(fleet.route_counts)
        size = -(-len(work) // (waves if last else 1))
        # No torch.cuda.synchronize() while replicas run: a device-wide
        # wait would invalidate a capture under way on a replica's thread.
        # A drained pass has read every token on the host.
        t0 = time.monotonic()
        frs = []
        for start in range(0, len(work), size):
            frs += [fleet.submit(w["prompt"],
                                 max_new_tokens=w["max_new_tokens"])
                    for w in work[start:start + size]]
            if last and autoscale is not None and start + size < len(work):
                fleet.autoscale_tick()
        fleet.drain(timeout_s=300.0)
        wall = time.monotonic() - t0
    fleet.close()
    if fleet.deaths or not all(fr.status == DONE for fr in frs):
        raise AssertionError(f"(27) fleet of {replicas}: deaths "
                             f"{fleet.deaths}; statuses "
                             f"{[fr.status for fr in frs]}")
    routes = {k: v - before[k] for k, v in fleet.route_counts.items()}
    return fleet, frs, wall, routes


def _solo_streams(model, work: list, **engine_kw) -> list:
    engine = ServeEngine(model, max_batch=8, max_len=LM["seq_len"], seed=0,
                         **engine_kw)
    reqs = [engine.submit(w["prompt"], max_new_tokens=w["max_new_tokens"])
            for w in work]
    engine.run_until_idle()
    engine.close()
    return reqs


def _as_reqs(frs) -> list:
    from types import SimpleNamespace

    return [SimpleNamespace(rid=fr.frid, prompt=fr.prompt,
                            generated=fr.tokens) for fr in frs]


def fleet_phase(card: str) -> dict:
    """Phase 27: (a) the fleet CLI at full width, every gate, flash
    launches depth x prefills (solo and replicas), each replica captured
    and replayed; (b) the same with a kill and a storm; (c) int8 ragged
    paged replicas scaled up mid-run (a capture during another replica's
    decode); (d) one replica against two on the same workload, in turns.
    Returns the flash launches by path."""
    from tpu_dist_torch.serve.fleet import AutoscalePolicy

    out = {}
    report, launches, prefills, wall = _fleet_cli([], deaths=[])
    out["fleet_cli"] = launches
    log(f"[27 fleet] (a) serve {' '.join(FLEET_ARGS[:9])} at phase 4's LM in "
        f"{wall:.3f} s: gates {report['gates']}; routes {report['route']}; "
        f"flash launches {launches} = depth {LM['depth']} x {prefills} "
        f"prefills (solo 32 + fleet 32); graphs {report['graphs']}; "
        f"certified ties {len(report['certified_ties'])}; p99 latency "
        f"{report['p99_latency_s']} s ({card})")
    report, launches, prefills, wall = _fleet_cli(["--plan", FLEET_PLAN],
                                                  deaths=[(0, True)])
    out["fleet_cli_kill_storm"] = launches
    g = report["gates"]
    if not (g.get("kill_fired") and g.get("storm_settled")
            and report["failover_replayed"] >= 1):
        raise AssertionError(f"(27) kill and storm: {report}")
    log(f"[27 fleet] (b) --plan {FLEET_PLAN} in {wall:.3f} s: gates {g}; "
        f"failover_replayed {report['failover_replayed']}; deaths "
        f"{[(d['replica'], d['fired']) for d in report['deaths']]}; storm "
        f"{report['storm_fired']}; chaff {report['chaff']}; routes "
        f"{report['route']}; flash launches {launches} = depth x {prefills} "
        f"prefills; certified ties {report['certified_ties']} ({card})")

    model = _serve_lm()
    work = _fleet_workload()
    # (c) int8 ragged replicas: one at first; the second wave finds every
    # request on replica 0 and scales up, so replica 1 builds and captures
    # while replica 0 decodes.
    quant = dict(paged=True, page_size=16, kv_dtype="int8", ragged=True)
    solo = _solo_streams(model, work, **quant)
    fa.flash_attention_fwd.launches = 0
    policy = AutoscalePolicy(min_replicas=1, max_replicas=2,
                             scale_up_outstanding=8, idle_ticks_down=10**9)
    fleet, frs, wall, _ = _fleet_run(model, work, 1, passes=1, waves=2,
                                     autoscale=policy, **quant)
    ups = [e for e in fleet.autoscale_events if e["action"] == "up"]
    stats = fleet.graph_stats()
    by = collections.Counter(fr.replica for fr in frs)
    if not ups or by[1] == 0 or not all(
            s["captured"] > 0 and s["replays"] > 0 for s in stats.values()):
        raise AssertionError(f"(27 c) no scale-up capture: {ups}, {by}, "
                             f"{stats}")
    ties = _ties(model, _as_reqs(frs), [r.generated for r in solo],
                 "(27 c) int8 fleet")
    out["fleet_int8_autoscale"] = fa.flash_attention_fwd.launches
    log(f"[27 fleet] (c) int8 ragged pool, autoscale {ups}: requests by "
        f"replica {dict(by)}, graphs {stats}, programs "
        f"{fleet.compiled_programs()}; streams equal the solo int8 run's, "
        f"{ties} certified ties; flash launches "
        f"{fa.flash_attention_fwd.launches} (paged: none) in {wall:.3f} s "
        f"({card})")
    del fleet

    # (d) one replica against two, in turns 1, 2, 2, 1; each fleet's
    # second pass is timed (the first captures).
    solo = _solo_streams(model, work)
    runs = {1: [], 2: []}
    fa.flash_attention_fwd.launches = 0
    for n in (1, 2, 2, 1):
        fleet, frs, wall, routes = _fleet_run(model, work, n)
        ties = _ties(model, _as_reqs(frs), [r.generated for r in solo],
                     f"(27 d) {n} replicas")
        tokens = sum(len(fr.tokens) for fr in frs)
        lat = sorted(fr.latency_s for fr in frs)
        runs[n].append({
            "wall_s": wall, "tok_s": tokens / wall,
            "p50": statistics.median(lat),
            "p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "routes": routes, "ties": ties,
            "pool_mib": [None if b is None else b / 2**20 for b in
                         (_pool_bytes(w.engine)
                          for w in fleet._workers.values())]})
        del fleet
        torch.cuda.empty_cache()
    out["fleet_1_vs_2"] = fa.flash_attention_fwd.launches
    for n, rs in runs.items():
        log(f"[27 fleet] (d) {n} replica(s), 32 requests, captured: " + "; "
            .join(f"wall {r['wall_s']:.4f} s, {r['tok_s']:.2f} tok/s, "
                  f"latency p50 {r['p50']:.4f} s p99 {r['p99']:.4f} s, "
                  f"routes {r['routes']}, ties {r['ties']}, graph pool MiB "
                  f"{r['pool_mib']}" for r in rs) + f" ({card})")
    ratio = [b["tok_s"] / a["tok_s"] for a, b in zip(runs[1], runs[2])]
    log(f"[27 fleet] (d) two replicas' tok/s over one's: "
        f"{', '.join(f'{r:.3f}' for r in ratio)} ({card})")
    return out


# -- phase 28: the observe layer ----------------------------------------------

#: (c): rank 1's input pipeline sleeps this long a sample (32 ms a batch).
OBSERVE_SLEEP_S = 0.0005
#: (a): `observe bench`'s rounds (the CLI's default is 400: 80 s on the
#: card at PR 19, reading 1.638 % against the 5 % gate).
OBSERVE_BENCH_ROUNDS = 200
#: Epoch 0 carries rank 0's warm-up (its first steps build and load), so
#: only the later epochs must flag rank 1.
OBSERVE_EPOCHS, OBSERVE_STEPS = 3, 10


def _observe_cli(argv: list) -> tuple:
    from tpu_dist_torch.observe import cli as observe_cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = observe_cli.main(argv)
    return rc, json.loads(out.getvalue())


def _split_sums(snap: dict) -> tuple:
    d = snap["distributions"]
    return (d["step.total_s"]["sum"],
            sum(d[f"step.{p}_s"]["sum"]
                for p in ("data_wait", "dispatch", "device_block")),
            d["step.total_s"]["count"])


def _observed_fit(make_model, data, telemetry: bool, **fit_kw) -> tuple:
    """(launch counts, registry snapshot or None, History dict) of one fit,
    with a Telemetry callback or without."""
    from tpu_dist_torch.observe.metrics import MetricsRegistry
    from tpu_dist_torch.observe.telemetry import Telemetry

    model = make_model()
    reg = MetricsRegistry(enabled=False)
    cbs = [Telemetry(registry=reg)] if telemetry else []
    _reset_counts()
    h = model.fit(data, verbose=0, callbacks=cbs, **fit_kw)
    torch.cuda.synchronize()
    return _counts(), (reg.snapshot() if telemetry else None), h.history


def observe_worker(outdir: pathlib.Path) -> int:
    """Phase 28 (c)'s worker (``chip_smoke.py --observe-worker DIR`` under
    a ``Supervisor(observe_dir=)``): the process group over gloo carries
    the telemetry exchange only; each rank fits the fused CNN on its own
    (so a slow rank slows no one else), rank 1's host pipeline sleeping
    OBSERVE_SLEEP_S a sample. Of two ranks the median is their mean, so
    the chief flags at 1.5 (a rank 3x its peer). Writes the launch counts
    to ``worker<rank>.json``."""
    from tpu_dist_torch.observe.telemetry import maybe_telemetry_from_env

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bootstrap.initialize(communication="ring")
    rank = bootstrap.process_index()
    for source in SOURCES:
        _build.load(source)
    sleep_s = OBSERVE_SLEEP_S if rank == 1 else 0.0

    def slow(image, label):
        if sleep_s:
            time.sleep(sleep_s)
        return True

    ds = (td_data.load("mnist", split="train").map(_scale_div).cache()
          .filter(slow).batch(CNN_BATCH))
    model = build_cnn_model()
    model.compile(optimizer=SGD(learning_rate=0.001, fused=True),
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=True),
                  metrics=[SparseCategoricalAccuracy()])
    telemetry = maybe_telemetry_from_env()
    telemetry.straggler_threshold = 1.5
    _reset_counts()
    model.fit(ds, epochs=OBSERVE_EPOCHS, steps_per_epoch=OBSERVE_STEPS,
              verbose=0, callbacks=[telemetry])
    torch.cuda.synchronize()
    (outdir / f"worker{rank}.json").write_text(json.dumps(
        {"counts": _counts(),
         "device": str(next(model.parameters()).device)}))
    return 0


def observe_phase(card: str) -> dict:
    """Phase 28: (a) the observe CLI's demo and bench; (b) Telemetry on the
    fused CNN fit (k = 1, 20) and the LM fit with fused Adam against the
    same fits without it; (c) two gloo ranks under a Supervisor with
    ``observe_dir``. Returns the launch counts by path."""
    from tpu_dist_torch.observe import exporters
    from tpu_dist_torch.resilience import events
    from tpu_dist_torch.resilience.supervisor import Supervisor

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.monotonic()
        rc, demo = _observe_cli(["demo", "--epochs", "4",
                                 "--steps-per-epoch", "4", "--batch", "256",
                                 "--out", str(tmp / "demo")])
        demo_s = time.monotonic() - t0
        summary = demo["summary"]
        if rc != 0 or not demo["ok"] or summary["steps"] != 16:
            raise AssertionError(f"(28 a) observe demo: rc {rc}, {demo}")
        # The bench as a user runs it: a fresh interpreter, whose heap and
        # threads are its own.
        t0 = time.monotonic()
        root = pathlib.Path(__file__).resolve().parent
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_dist_torch.observe", "bench",
             "--rounds", str(OBSERVE_BENCH_ROUNDS),
             "--workdir", str(tmp / "bench")], cwd=root,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(filter(
                None, [str(root), os.environ.get("PYTHONPATH")]))),
            capture_output=True, text=True, timeout=600)
        bench_s = time.monotonic() - t0
        rc = proc.returncode
        try:
            bench = json.loads(proc.stdout)
        except json.JSONDecodeError:
            raise AssertionError(f"(28 a) observe bench: rc {rc}, "
                                 f"{proc.stderr[-2000:]}") from None
        log(f"[28 observe] (a) demo (CNN, batch 256, 4 x 4) in {demo_s:.2f}"
            f" s: {summary['steps']} steps, {summary['steps_per_s']} "
            f"steps/s, step p50/p95/p99 {summary['step_total_s']} s, phases "
            f"p50 {summary['step_phase_p50_s']}, collectives "
            f"{summary['collective_calls']}; bench in {bench_s:.2f} s: off "
            f"{bench['telemetry_off_steps_per_s']} steps/s, on "
            f"{bench['telemetry_on_steps_per_s']} (mean of "
            f"{bench['rounds']} runs a side), overhead "
            f"{bench['overhead_pct']} % (gate {bench['max_overhead_pct']} "
            f"%), exit {rc} ({card})")
        if rc != 0 or not bench["ok"]:
            raise AssertionError(f"(28 a) observe bench: rc {rc}, {bench}")

    # (b) Telemetry on the fused paths, launch for launch.
    def cnn(k):
        def make():
            model = build_cnn_model()
            model.compile(optimizer=SGD(learning_rate=0.001, fused=True),
                          loss=SparseCategoricalCrossentropy(
                              from_logits=True, fused=True),
                          metrics=[SparseCategoricalAccuracy()],
                          steps_per_execution=k)
            return model
        return make

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        for k in (1, 20):
            steps = CNN_EPOCHS * CNN_STEPS
            runs = [_observed_fit(cnn(k), _chain(True, seed=0), tel,
                                  epochs=CNN_EPOCHS,
                                  steps_per_epoch=CNN_STEPS)
                    for tel in (False, True)]
            (plain, _, h0), (counts, snap, h1) = runs
            total, parts, execs = _split_sums(snap)
            if (counts != plain or counts[3:] != (steps,) * 3
                    or snap["counters"]["step.count"] != steps
                    or execs != CNN_EPOCHS * -(-CNN_STEPS // k)
                    or abs(total - parts) > 1e-9 * max(total, 1.0)
                    or h0["loss"] != h1["loss"]):
                raise AssertionError(
                    f"(28 b) CNN k = {k}: launches {counts} vs {plain}, "
                    f"steps {snap['counters']['step.count']}, executions "
                    f"{execs}, split {parts} vs total {total}")
            out[f"cnn_fit_telemetry_k{k}"] = counts
            d = snap["distributions"]
            log(f"[28 observe] (b) fused CNN fit, k = {k}, {steps} steps "
                f"under Telemetry: launches {counts} = without it; "
                f"step.count {steps}; {execs} executions, their split sums "
                f"to the total ({total:.6f} s); per step p50 total "
                f"{d['step.total_s']['p50'] * 1e3:.4f} ms = data "
                f"{d['step.data_wait_s']['p50'] * 1e3:.4f} + dispatch "
                f"{d['step.dispatch_s']['p50'] * 1e3:.4f} + device "
                f"{d['step.device_block_s']['p50'] * 1e3:.4f} (medians); "
                f"losses equal ({card})")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags
    x, y = _bench_tokens(4 * 32)
    xy = (x.cpu().numpy(), y.cpu().numpy())
    runs = [_observed_fit(lambda: _compiled_lm(Adam(fused=True)), xy, tel,
                          epochs=1, steps_per_epoch=4)
            for tel in (False, True)]
    (plain, _, _), (counts, snap, _) = runs
    want = (LM["depth"] * 4, LM["depth"] * 4, 4, 0, 0, 0)
    total, parts, execs = _split_sums(snap)
    d = snap["distributions"]
    # The LM step is device-bound: the timer's wait on each execution's
    # end must hold most of it.
    if (counts != plain or counts != want
            or snap["counters"]["step.count"] != 4
            or abs(total - parts) > 1e-9 * max(total, 1.0)
            or d["step.device_block_s"]["p50"]
            <= d["step.dispatch_s"]["p50"]):
        raise AssertionError(f"(28 b) LM: launches {counts} vs {plain} "
                             f"(want {want}), split {parts} vs {total}, "
                             f"distributions {d}")
    out["lm_fit_telemetry"] = counts
    log(f"[28 observe] (b) LM fit, Adam(fused=True), 4 steps of 32 x 512 "
        f"under Telemetry: launches {counts} = without it; per step p50 "
        f"total {d['step.total_s']['p50'] * 1e3:.3f} ms = data "
        f"{d['step.data_wait_s']['p50'] * 1e3:.3f} + dispatch "
        f"{d['step.dispatch_s']['p50'] * 1e3:.3f} + device "
        f"{d['step.device_block_s']['p50'] * 1e3:.3f} ({card})")

    # (c) two gloo ranks under the Supervisor, telemetry armed per rank.
    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        env = {"PYTHONPATH": os.pathsep.join(
                   filter(None, [str(root), os.environ.get("PYTHONPATH")])),
               events.EVENT_LOG_ENV: str(tmp / "events.jsonl")}
        sup = Supervisor([sys.executable, str(root / "chip_smoke.py"),
                          "--observe-worker", str(tmp)], num_workers=2,
                         max_restarts=0, attempt_deadline_s=DP_TIMEOUT_S,
                         env=env, log_dir=tmp / "logs",
                         observe_dir=tmp / "obs")
        t0 = time.monotonic()
        rep = sup.run()
        wall = time.monotonic() - t0
        if not rep.success:
            tail = "".join(p.read_text()[-2000:]
                           for p in sorted((tmp / "logs").glob("*.log")))
            raise AssertionError(f"(28 c) workers: {rep.to_json()}\n{tail}")
        gauges = [exporters.read_series(tmp / "obs" / f"rank{r}"
                                        / "metrics.jsonl")[-1]["metrics"]
                  ["gauges"] for r in (0, 1)]
        flagged = events.read_events(tmp / "events.jsonl",
                                     "straggler_detected")
        timing = events.read_events(tmp / "events.jsonl", "step_timing")
        workers = [json.loads((tmp / f"worker{r}.json").read_text())
                   for r in (0, 1)]
    per_rank = [(g["rank0.step_time_s"], g["rank1.step_time_s"])
                for g in gauges]
    steps = OBSERVE_EPOCHS * OBSERVE_STEPS
    if (per_rank[0] != per_rank[1]
            or any(f["rank"] != 1 for f in flagged)
            or not {f["epoch"] for f in flagged} >= set(
                range(1, OBSERVE_EPOCHS))
            or any(tuple(w["counts"][3:]) != (steps,) * 3
                   for w in workers)):
        raise AssertionError(f"(28 c) gauges {per_rank}, flagged "
                             f"{flagged}, workers {workers}")
    for r, w in enumerate(workers):
        out[f"observe_rank{r}"] = tuple(w["counts"])
    log(f"[28 observe] (c) two gloo ranks under Supervisor(observe_dir=) "
        f"in {wall:.2f} s: rank{{0,1}}.step_time_s {per_rank[0]} on both "
        f"ranks; rank 1 (sleeping {OBSERVE_SLEEP_S} s a sample) flagged "
        f"in epochs {[f['epoch'] for f in flagged]}, ratios "
        f"{[round(f['ratio'], 3) for f in flagged]}; step_timing records "
        f"{len(timing)}; rows 1-3 launched {workers[0]['counts'][3:]} a "
        f"rank ({card})")
    return out



# -- phase 29: tensor and sequence parallelism --------------------------------

TP_AXES = {"data": 1, "model": 2}
SEQ_AXES = {"data": 1, "seq": 2}
#: (a)-(c): 4 steps of 8 x 512 tokens (each rank holds all 8 rows).
TP_BATCH, TP_STEPS = 8, 4
#: (a): the checkpoint (d) restores, after this many steps.
TP_CKPT_STEP = 2
#: (c): ring attention alone, fp32 causal; each rank holds 8,192 positions,
#: so the 2048 auto-chunk runs.
RING_SHAPE = (1, 8, 16384, 64)
#: Ring vs the flash kernels at RING_SHAPE: fp32 sums over 16,384 keys or
#: queries, 16x phase 7's longest, in different orders (the ring's folds
#: and cuBLAS against the kernels' tiles); the rounding grows as the square
#: root of the terms, so 4x FP32_TOL, of the largest |value| for atol.
RING_TOL = 4 * FP32_TOL
#: bf16 twins: the losses (~9.01, fp32 from bf16 logits) may differ by one
#: bf16 rounding of their size: 2**-8 of ln(8192). Each rank's row-parallel
#: partial sums round to bf16 before the all-reduce adds them, where one
#: process rounds the whole sum once.
BF16_LOSS_ATOL = 2.0 ** -8 * float(np.log(LM["vocab_size"]))
#: (a), (d): a zero-gradient leaf, the key projection's bias (softmax
#: cancels a constant per query row): Adam takes its rounding noise to
#: full-size steps, so it is held to the steps' sizes, lr x steps.
ADAM_LR = 1e-3


def _recording(model) -> list:
    """Every attention layer's ``attention_fn`` wrapped to record the q
    shape it is given; returns the list the calls append to."""
    shapes = []
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            inner = m.attention_fn

            def record(q, k, v, *, _inner=inner, **kw):
                shapes.append(tuple(q.shape))
                return _inner(q, k, v, **kw)

            m.attention_fn = record
    return shapes


def _tp_steps(model, x, y, *, ckpt_dir=None) -> dict:
    """TP_STEPS train steps of ``model`` through make_train_function on
    (x, y), counted; a checkpoint after TP_CKPT_STEP when ``ckpt_dir``;
    then the gathered parameters."""
    from tpu_dist_torch.parallel import tensor

    fn, st = model.make_train_function(), model.train_state()
    _reset_counts()
    losses = []
    for step in range(TP_STEPS):
        losses.append(float(fn(*st, x, y)))
        if ckpt_dir is not None and step + 1 == TP_CKPT_STEP:
            checkpoint.save(ckpt_dir, model, step=TP_CKPT_STEP)
    torch.cuda.synchronize()
    counts = _counts()
    return {"loss": losses, "counts": counts, "fn": fn, "st": st,
            "params": {n: t.detach().cpu() for n, t in
                       tensor.gather_params(model).items()}}


def _collective_ms(group, size: int, calls: dict, steps: int) -> tuple:
    """Each collective of ``calls`` (a model axis's, ``{(op, shape,
    dtype): count}`` over ``steps`` steps) timed alone on fresh tensors of
    its shape and dtype (synchronised around, 5 calls after 2): the ms a
    step, and the breakdown {(op, shape, dtype): (calls a step, ms a
    call)}."""
    out, total = {}, 0.0
    for (op, shape, dtype), n in calls.items():
        t = torch.randn(shape, device="cuda").to(getattr(torch, dtype[6:]))
        if op == "all_reduce":
            fn = lambda: torch.distributed.all_reduce(t, group=group)
        else:
            parts = [torch.empty_like(t) for _ in range(size)]
            fn = lambda: torch.distributed.all_gather(parts, t, group=group)
        torch.distributed.barrier()
        ms = _ms(fn, 5)
        out[op, shape, dtype] = (n / steps, ms)
        total += n / steps * ms
    return total, out


def _tp_run(strategy, x, y, ckpt_dir=None) -> dict:
    """(a) / (b): the full-width LM under {data: 1, model: 2} with fused
    Adam and the fused CE, TP_STEPS steps from seed 0's weights on both
    ranks; then the step's ms and the model-axis collectives'."""
    with strategy.scope():
        model = _compiled_lm(Adam(ADAM_LR, fused=True), fused_ce=True)
    shard = model._tensor_parallel[0]
    shapes = _recording(model)
    shard.calls.clear()
    shard.seconds = 0.0
    run = _tp_steps(model, x, y, ckpt_dir=ckpt_dir)
    calls = collections.Counter(shard.calls)
    fn, st = run.pop("fn"), run.pop("st")
    shard.seconds = 0.0
    torch.distributed.barrier()
    run["step_ms"] = _ms(lambda: fn(*st, x, y), 5)
    run["collective_host_s"] = shard.seconds / 7
    run["collective_ms"], run["collectives"] = _collective_ms(
        shard.group, shard.size, calls, TP_STEPS)
    params = dict(model.named_parameters())
    wq = params["block.residual.main.multiheadattention.wq"]
    layout = model._tensor_parallel[1]
    run.update(heads=sorted(set(shapes)), wq=tuple(wq.shape),
               wq_dtype=str(wq.dtype), layout=sorted(layout),
               replicated={n: p.detach().cpu() for n, p in params.items()
                           if n not in layout})
    del model
    torch.cuda.empty_cache()
    return run


def _ring_lm(strategy, x, y) -> dict:
    """(c): the LM of (a) with RingAttention() in every block under
    {data: 1, seq: 2}, TP_STEPS steps."""
    from tpu_dist_torch.parallel import RingAttention

    with strategy.scope():
        model = build_transformer_lm(
            LM["vocab_size"], LM["seq_len"], d_model=LM["d_model"],
            depth=LM["depth"], num_heads=LM["num_heads"], seed=0,
            attention_fn=RingAttention())
        model.compile(optimizer=Adam(ADAM_LR, fused=True),
                      loss=SparseCategoricalCrossentropy(from_logits=True,
                                                         fused=True),
                      metrics=[SparseCategoricalAccuracy()])
        run = _tp_steps(model, x, y)
    run.pop("fn"), run.pop("st")
    del model
    torch.cuda.empty_cache()
    return run


def _ring_alone(strategy) -> dict:
    """(c): ring_attention_blocks at RING_SHAPE fp32 causal on this rank's
    block, forward and backward (a seeded cotangent), against the flash
    kernels on the gathered q, k, v (this rank's block of their output
    and gradients); then both timed, the flash pair on rank 0 alone."""
    from tpu_dist_torch.parallel import sequence

    mesh = strategy.mesh
    gen = torch.Generator().manual_seed(29)
    q, k, v, do = (torch.randn(RING_SHAPE, generator=gen).cuda()
                   for _ in range(4))
    place = sequence.sequence_sharding(mesh).place
    ql, kl, vl = (place(t).requires_grad_() for t in (q, k, v))
    dol = place(do)
    scale = RING_SHAPE[-1] ** -0.5

    def ring():
        o = sequence.ring_attention_blocks(ql, kl, vl, mesh=mesh,
                                           causal=True)
        return (o, *torch.autograd.grad(o, (ql, kl, vl), dol))

    for key in sequence.staging:
        sequence.staging[key] = 0
    got = ring()
    torch.cuda.synchronize()
    staged = dict(sequence.staging)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                   scale=scale)
    want = [place(t) for t in (o, *grads)]
    torch.cuda.synchronize()
    errs = [float((g.detach() - w).abs().max()) for g, w in zip(got, want)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.detach(), w, rtol=RING_TOL,
                                   atol=RING_TOL * float(w.abs().max()))
    del got, want, grads, o, lse
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    ring_ms = _ms(ring, 3)
    flash_ms = None
    if bootstrap.process_index() == 0:
        def flash():
            o, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                            scale=scale)
            return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                          scale=scale)
        flash_ms = _ms(flash, 3)
    torch.distributed.barrier()
    return {"errs": errs, "ring_ms": ring_ms, "flash_ms": flash_ms,
            "staged": staged, "block": list(ql.shape)}


def tp_worker(outdir: pathlib.Path) -> int:
    """Phase 29's worker (``chip_smoke.py --tp-worker DIR``, TF_CONFIG in
    the environment): (a) the full-width LM under {data: 1, model: 2}
    (gloo on CUDA tensors, one card), its checkpoint at step 2 into
    DIR/ckpt; (b) the same under mixed_bfloat16; (c) the LM with
    RingAttention under {data: 1, seq: 2}, then ring attention alone.
    Writes ``tp_worker<rank>.pt`` into DIR."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for source in SOURCES:
        _build.load(source)
    x, y = _bench_tokens(TP_BATCH)
    tp = MultiWorkerMirroredStrategy(communication="ring",
                                     axis_shapes=TP_AXES)
    out = {"device": str(tp.device),
           "backend": torch.distributed.get_backend(),
           "replicas": tp.num_replicas_in_sync}
    out["fp32"] = _tp_run(tp, x, y, ckpt_dir=outdir / "ckpt")
    set_policy("mixed_bfloat16")
    try:
        out["bf16"] = _tp_run(tp, x, y)
    finally:
        set_policy("float32")
    seq = MultiWorkerMirroredStrategy(communication="ring",
                                      axis_shapes=SEQ_AXES)
    out["ring_lm"] = _ring_lm(seq, x, y)
    out["ring"] = _ring_alone(seq)
    torch.save(_cpu(out), outdir / f"worker{bootstrap.process_index()}.pt")
    return 0


def _single_lm(x, y, *, steps: int = TP_STEPS, restore=None) -> dict:
    """The single-process twin of (a) (or of (d) from ``restore``, a
    checkpoint directory): the same compile, ``steps`` steps on (x, y),
    counted, then its step's ms."""
    model = _compiled_lm(Adam(ADAM_LR, fused=True), fused_ce=True)
    fn, st = model.make_train_function(), model.train_state()
    step = None
    if restore is not None:
        step = checkpoint.restore_model(restore, model)
    _reset_counts()
    losses = [float(fn(*st, x, y)) for _ in range(steps)]
    torch.cuda.synchronize()
    out = {"loss": losses, "counts": _counts(), "step": step,
           "params": {n: p.detach().cpu()
                      for n, p in model.named_parameters()}}
    out["step_ms"] = _ms(lambda: fn(*st, x, y), 5)
    del model
    torch.cuda.empty_cache()
    return out


def _param_gaps(got: dict, want: dict, before: dict) -> tuple:
    """Every leaf of ``got`` within PARAM_RTOL of its step (from
    ``before``) plus PARAM_ATOL of ``want``'s, but the key biases (a zero
    gradient: within ADAM_LR x TP_STEPS); returns (largest gap, the leaf
    nearest its limit)."""
    over, worst, near = [], 0.0, ("", 0.0)
    for name, w in want.items():
        gap = float((got[name] - w).abs().max())
        step = float((w - before[name]).abs().max())
        limit = (ADAM_LR * TP_STEPS if name.endswith(".bk")
                 else PARAM_RTOL * step + PARAM_ATOL)
        worst = max(worst, gap)
        if gap / limit > near[1]:
            near = (name, gap / limit)
        if gap > limit:
            over.append(f"{name}: {gap:.3e} (step {step:.3e})")
    if over:
        raise AssertionError(f"parameters beyond the twin's limits: "
                             f"{'; '.join(over[:8])}")
    return worst, near


def tp_phase(card: str) -> dict:
    """Phase 29: tensor and sequence parallelism on two gloo ranks sharing
    the card. Returns each rank's launch counts on (a) and (c)'s LM."""
    x, y = _bench_tokens(TP_BATCH)
    depth, steps = LM["depth"], TP_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.monotonic()
        workers = _spawn_dp_workers(tmp, flag="--tp-worker")
        wall = time.monotonic() - t0
        twin = _single_lm(x, y)
        resumed = _single_lm(x, y, steps=steps - TP_CKPT_STEP,
                             restore=tmp / "ckpt")
    set_policy("mixed_bfloat16")
    try:
        twin16 = _single_lm(x, y)
    finally:
        set_policy("float32")
    before = {n: p.detach().cpu() for n, p in _compiled_lm(
        Adam(ADAM_LR, fused=True)).named_parameters()}
    r0, r1 = workers
    half = LM["num_heads"] // 2
    dk = LM["d_model"] // LM["num_heads"]
    want_counts = (depth * steps, depth * steps, steps, steps, steps, 0)
    # (a) fp32.
    a0, a1 = r0["fp32"], r1["fp32"]
    _TP_RANK0_CALLS.update(
        {k: v[0] for k, v in a0["collectives"].items()})
    if (a0["loss"] != a1["loss"] or r0["replicas"] != 1
            or r0["backend"] != "gloo"
            or any(not torch.equal(a0["replicated"][n], a1["replicated"][n])
                   for n in a0["replicated"])):
        raise AssertionError(f"(29 a) the ranks differ: losses {a0['loss']}"
                             f" / {a1['loss']}")
    for r, a in enumerate((a0, a1)):
        if (a["counts"] != want_counts or a["wq"] != (LM["d_model"], 256)
                or a["heads"] != [(TP_BATCH, half, LM["seq_len"], dk)]):
            raise AssertionError(f"(29 a) rank {r}: launches {a['counts']} "
                                 f"(want {want_counts}), wq {a['wq']}, "
                                 f"attention on {a['heads']}")
    np.testing.assert_allclose(a0["loss"], twin["loss"], atol=LOSS_ATOL,
                               rtol=0, err_msg="(29 a) losses vs the twin")
    gap, near = _param_gaps(a0["params"], twin["params"], before)
    coll = sorted(((k, v) for k, v in a0["collectives"].items()),
                  key=lambda kv: -kv[1][0] * kv[1][1])
    log(f"[29 tp] (a) the full-width LM under {TP_AXES} on two gloo ranks "
        f"sharing the card (workers {wall:.1f} s), Adam(fused=True) + fused"
        f" CE, {steps} steps of {TP_BATCH} x {LM['seq_len']}: losses "
        f"{[round(v, 6) for v in a0['loss']]} bit for bit on both ranks "
        f"(replicated leaves too); twin {[round(v, 6) for v in twin['loss']]}"
        f" (max |diff| {max(abs(p - q) for p, q in zip(a0['loss'], twin['loss'])):.2e},"
        f" atol {LOSS_ATOL:g}); gathered params within {PARAM_RTOL:g} x "
        f"step + {PARAM_ATOL:g} of the twin's (bk: lr x steps), max gap "
        f"{gap:.3e}, nearest its limit {near[0]} at {near[1]:.3f}; wq "
        f"{a0['wq']} a rank; flash on {a0['heads']}; launches (flash fwd, "
        f"bwd, Adam, CE fwd, CE bwd, SGD) {a0['counts']} / {a1['counts']}; "
        f"sharded leaves {len(a0['layout'])} ({card})")
    log(f"[29 tp] (a) times ({card}): step {a0['step_ms']:.3f} / "
        f"{a1['step_ms']:.3f} ms a rank (two ranks on one card) against the "
        f"single-process twin's {twin['step_ms']:.3f} ms; the model-axis "
        f"collectives {a0['collective_ms']:.3f} ms a step timed alone (gloo "
        f"staging through the host), host time inside the step "
        f"{a0['collective_host_s'] * 1e3:.3f} ms; per step: " + "; ".join(
            f"{op} {list(shape)} {dtype[6:]} x {n:g} at {ms:.3f} ms"
            for (op, shape, dtype), (n, ms) in coll))
    # (b) mixed_bfloat16.
    b0, b1 = r0["bf16"], r1["bf16"]
    if (b0["loss"] != b1["loss"] or b0["counts"] != want_counts
            or b0["wq_dtype"] != "torch.float32"
            or b0["heads"] != [(TP_BATCH, half, LM["seq_len"], dk)]):
        raise AssertionError(f"(29 b) bf16: losses {b0['loss']} / "
                             f"{b1['loss']}, launches {b0['counts']}, wq "
                             f"{b0['wq_dtype']}, heads {b0['heads']}")
    np.testing.assert_allclose(b0["loss"], twin16["loss"],
                               atol=BF16_LOSS_ATOL, rtol=0,
                               err_msg="(29 b) bf16 losses vs the twin")
    log(f"[29 tp] (b) the same under mixed_bfloat16 (flash bf16, row 6c): "
        f"losses {[round(v, 5) for v in b0['loss']]} bit for bit on both "
        f"ranks; single-process twin {[round(v, 5) for v in twin16['loss']]}"
        f" (atol {BF16_LOSS_ATOL:.4f}, one bf16 rounding of ln(8192)); "
        f"launches {b0['counts']}; step {b0['step_ms']:.3f} ms against the "
        f"twin's {twin16['step_ms']:.3f}; collectives {b0['collective_ms']:.3f}"
        f" ms a step ({card})")
    # (c) the ring LM and ring attention alone.
    c0, c1 = r0["ring_lm"], r1["ring_lm"]
    ring_counts = (0, 0, steps, steps, steps, 0)
    if c0["loss"] != c1["loss"] or c0["counts"] != ring_counts:
        raise AssertionError(f"(29 c) ring LM: losses {c0['loss']} / "
                             f"{c1['loss']}, launches {c0['counts']}")
    np.testing.assert_allclose(c0["loss"], twin["loss"], atol=LOSS_ATOL,
                               rtol=0, err_msg="(29 c) ring LM vs the twin")
    gap_c, near_c = _param_gaps(c0["params"], twin["params"], before)
    ring = [r0["ring"], r1["ring"]]
    log(f"[29 tp] (c) the LM with RingAttention() under {SEQ_AXES}: losses "
        f"{[round(v, 6) for v in c0['loss']]} bit for bit on both ranks, "
        f"within {LOSS_ATOL:g} of the flash twin's; params max gap "
        f"{gap_c:.3e} (nearest {near_c[0]} at {near_c[1]:.3f}); launches "
        f"{c0['counts']} (the ring reaches no flash kernel) ({card})")
    staged = ring[0]["staged"]
    log(f"[29 tp] (c) ring_attention {list(RING_SHAPE)} fp32 causal, blocks "
        f"{ring[0]['block']} (2048-position chunks): max |ring - flash| "
        f"over o, dq, dk, dv rank 0 {[f'{e:.2e}' for e in ring[0]['errs']]}, "
        f"rank 1 {[f'{e:.2e}' for e in ring[1]['errs']]} (rtol {RING_TOL:g},"
        f" atol {RING_TOL:g} of the largest |value|); fwd+bwd {ring[0]['ring_ms']:.3f} / {ring[1]['ring_ms']:.3f}"
        f" ms a rank against the flash kernels' {ring[0]['flash_ms']:.3f} ms "
        f"(one process, the whole sequence); host staging of the shifts: "
        f"{staged['calls']} exchanges, {staged['bytes'] / 2**20:.1f} MiB, "
        f"{staged['seconds'] * 1e3:.3f} ms in one fwd+bwd ({card})")
    # (d) (a)'s checkpoint restored in one process and continued.
    if resumed["step"] != TP_CKPT_STEP:
        raise AssertionError(f"(29 d) restored step {resumed['step']}")
    np.testing.assert_allclose(resumed["loss"], a0["loss"][TP_CKPT_STEP:],
                               atol=LOSS_ATOL, rtol=0,
                               err_msg="(29 d) resumed losses")
    gap_d, near_d = _param_gaps(resumed["params"], a0["params"], before)
    log(f"[29 tp] (d) (a)'s checkpoint at step {TP_CKPT_STEP} (global "
        f"arrays, gathered over the model axis) restored in one process and "
        f"continued {steps - TP_CKPT_STEP} steps: losses "
        f"{[round(v, 6) for v in resumed['loss']]} against the tensor-"
        f"parallel run's {[round(v, 6) for v in a0['loss'][TP_CKPT_STEP:]]};"
        f" params max gap {gap_d:.3e} (nearest {near_d[0]} at "
        f"{near_d[1]:.3f}) ({card})")
    return {"tp_rank0": a0["counts"], "tp_rank1": a1["counts"],
            "tp_bf16_rank0": b0["counts"], "tp_bf16_rank1": b1["counts"],
            "ring_lm_rank0": c0["counts"], "ring_lm_rank1": c1["counts"]}


# -- phase 30: the pipe and expert axes ----------------------------------------

PP_AXES = {"data": 1, "pipe": 2}
EP_AXES = {"data": 1, "expert": 2}
#: (a)-(d): 4 steps of 8 x 512 tokens (each rank holds all 8 rows); the
#: checkpoint (d) restores after step 2.
PP_BATCH, PP_STEPS, PP_CKPT_STEP = 8, 4, 2
PP_KW = dict(pipeline_stages=2, pipeline_microbatches=4)
MOE_KW = dict(moe_experts=4, moe_top_k=2, moe_groups=8)
#: (a), (c), (d): the ranks against a one-process twin: the same fp32 math
#: on microbatches of 2 rows (or a process's 4 rows) where the twin takes
#: 8, so cuBLAS may pick other kernels: the losses within 1e-5 of their
#: size.
PP_LOSS_RTOL = 1e-5
#: (b): 1F1B against GPipe on the same weights, the reference's bar
#: (tests/test_pipeline_parallel.py:299).
F1B_TOL = dict(rtol=5e-4, atol=5e-5)
F1B_SGD_LR = 0.1


def _pp_lm(optimizer, **kw):
    """The full-width LM of bench.py with ``kw``'s pipeline or
    mixture-of-experts options, seed 0, the fused CE, on the card."""
    model = build_transformer_lm(LM["vocab_size"], LM["seq_len"],
                                 d_model=LM["d_model"], depth=LM["depth"],
                                 num_heads=LM["num_heads"], seed=0, **kw)
    model.compile(optimizer=optimizer,
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=True),
                  metrics=[SparseCategoricalAccuracy()])
    return model


class _SaveAt(Callback):
    """Checkpoint ``step`` into ``directory`` at the end of that epoch (one
    step an epoch)."""

    def __init__(self, directory, step: int):
        self.directory, self.step = directory, step

    def on_epoch_end(self, epoch, logs):
        if epoch + 1 == self.step:
            checkpoint.save(self.directory, self.model, step=self.step)


def _pp_fit(model, x, y, steps: int, ckpt_dir=None) -> dict:
    """``steps`` steps of ``fit`` on the batch (x, y), one an epoch,
    counted; a checkpoint after PP_CKPT_STEP when ``ckpt_dir``."""
    data = (x.cpu().numpy(), y.cpu().numpy())
    callbacks = [] if ckpt_dir is None else [_SaveAt(ckpt_dir, PP_CKPT_STEP)]
    _reset_counts()
    hist = model.fit(data, epochs=steps, steps_per_epoch=1, verbose=0,
                     callbacks=callbacks)
    torch.cuda.synchronize()
    return {"loss": hist.history["loss"], "counts": _counts()}


def _grads_of(model, x, y) -> tuple:
    """One forward and backward of ``model`` in train mode on (x, y): the
    loss and every parameter's gradient (this process's block)."""
    model.train()
    for p in model.parameters():
        p.grad = None
    loss = model.loss(model(x), y)
    loss.backward()
    model.eval()
    return float(loss), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def _gpipe_run(strategy, x, y, ckpt_dir) -> dict:
    """(a): the pipelined LM's fit under PP_AXES, then its step's ms and
    the stage handoffs' staging over one step."""
    from tpu_dist_torch.parallel import pipeline_parallel

    with strategy.scope():
        model = _pp_lm(Adam(ADAM_LR, fused=True), **PP_KW)
    run = _pp_fit(model, x, y, PP_STEPS, ckpt_dir)
    named = dict(model.named_parameters())
    layout = model._tensor_parallel[1]
    run.update(layout=sorted(layout),
               stage_shapes={n: tuple(named[n].shape) for n in layout},
               replicated={n: p.detach().cpu() for n, p in named.items()
                           if n not in layout})
    fn, st = model.make_train_function(), model.train_state()
    torch.distributed.barrier()
    run["step_ms"] = _ms(lambda: fn(*st, x, y), 5)
    for key in pipeline_parallel.staging:
        pipeline_parallel.staging[key] = 0
    fn(*st, x, y)
    torch.cuda.synchronize()
    run["staged"] = dict(pipeline_parallel.staging)
    del model, fn, st
    torch.cuda.empty_cache()
    return run


def _peak_mb(fn) -> float:
    """The peak of this process's allocated device memory above what it
    held before, over one call of ``fn``, in MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _f1b_run(strategy, x, y) -> dict:
    """(b): on seed 0's weights, GPipe's loss and gradients against the
    1F1B step's at M = 4 and M = 8; each one's peak memory at M = 8; then
    PP_STEPS steps of the 1F1B step with fused SGD, counted."""
    from tpu_dist_torch.parallel import make_1f1b_train_step

    with strategy.scope():
        model = _pp_lm(Adam(ADAM_LR, fused=True), **PP_KW)
    pb = next(m for m in model.modules() if type(m).__name__
              == "PipelinedBlocks")
    loss_fn = model.loss
    out = {"gpipe": _grads_of(model, x, y), "f1b": {}, "peak_mb": {}}
    for m in (4, 8):
        pb.microbatches = m
        step = make_1f1b_train_step(model, loss_fn, strategy=strategy)
        loss, grads = step(x, y)
        out["f1b"][m] = (float(loss), {n: g.detach().clone()
                                        for n, g in grads.items()},
                         dict(step.stats))
        del grads
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    # M = 8 on the same model and batch: 1F1B's step, then GPipe's.
    step = make_1f1b_train_step(model, loss_fn, strategy=strategy)
    out["peak_mb"]["f1b"] = _peak_mb(lambda: step(x, y))
    torch.cuda.empty_cache()
    out["peak_mb"]["gpipe"] = _peak_mb(lambda: _grads_of(model, x, y))
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    pb.microbatches = PP_KW["pipeline_microbatches"]
    step = make_1f1b_train_step(model, loss_fn, strategy=strategy)
    opt = SGD(F1B_SGD_LR, fused=True)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    state = opt.init(params)
    _reset_counts()
    losses = []
    for _ in range(PP_STEPS):
        loss, grads = step(x, y)
        opt.update([grads[n] for n in names], state, params)
        losses.append(float(loss))
    torch.cuda.synchronize()
    out.update(sgd_loss=losses, counts=_counts())

    def one():
        loss, grads = step(x, y)
        opt.update([grads[n] for n in names], state, params)

    torch.distributed.barrier()
    out["step_ms"] = _ms(one, 5)
    del model, step
    torch.cuda.empty_cache()
    return out


def _moe_run(strategy, x, y) -> dict:
    """(c): the MoE LM's fit under EP_AXES, the aux loss's share of the
    objective, then its step's ms and the all_to_all host time a step."""
    from tpu_dist_torch.parallel import expert

    with strategy.scope():
        model = _pp_lm(Adam(ADAM_LR, fused=True), **MOE_KW)
    run = _pp_fit(model, x, y, PP_STEPS)
    named = dict(model.named_parameters())
    layout = model._tensor_parallel[1]
    run.update(layout=sorted(layout),
               expert_shapes={n: tuple(named[n].shape) for n in layout},
               replicated={n: p.detach().cpu() for n, p in named.items()
                           if n not in layout})
    fn, st = model.make_train_function(), model.train_state()
    # The objective holds the aux loss: the pure CE of this forward plus
    # the aux buffers it leaves is the next step's loss (same weights).
    with torch.no_grad():
        model.train()
        ce = float(model.loss(model(x), y))
        model.eval()
    run["aux"] = [float(b) for n, b in model.named_buffers()
                  if n.endswith("aux_loss")]
    run["objective"] = (ce, float(fn(*st, x, y)))
    torch.distributed.barrier()
    run["step_ms"] = _ms(lambda: fn(*st, x, y), 5)
    expert.exchanges.update(calls=0, seconds=0.0)
    t0 = time.perf_counter()
    fn(*st, x, y)
    torch.cuda.synchronize()
    run["a2a"] = dict(expert.exchanges, step_s=time.perf_counter() - t0)
    del model, fn, st
    torch.cuda.empty_cache()
    return run


def pp_worker(outdir: pathlib.Path) -> int:
    """Phase 30's worker (``chip_smoke.py --pp-worker DIR``, TF_CONFIG in
    the environment): (a) the pipelined LM's fit under {data: 1, pipe: 2}
    (gloo, one card), its checkpoint at step 2 into DIR/ckpt; (b) the 1F1B
    step on the same model; (c) the MoE LM's fit under {data: 1, expert:
    2}. Writes ``worker<rank>.pt`` into DIR."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for source in SOURCES:
        _build.load(source)
    x, y = _bench_tokens(PP_BATCH)
    pipe = MultiWorkerMirroredStrategy(communication="ring",
                                       axis_shapes=PP_AXES)
    out = {"backend": torch.distributed.get_backend(),
           "replicas": pipe.num_replicas_in_sync}
    t0 = time.monotonic()
    out["gpipe"] = _gpipe_run(pipe, x, y, outdir / "ckpt")
    out["f1b"] = _f1b_run(pipe, x, y)
    ep = MultiWorkerMirroredStrategy(communication="ring",
                                     axis_shapes=EP_AXES)
    out["moe"] = _moe_run(ep, x, y)
    out["seconds"] = time.monotonic() - t0
    torch.save(_cpu(out), outdir / f"worker{bootstrap.process_index()}.pt")
    return 0


def _pp_twin(x, y, kw, *, steps=PP_STEPS, restore=None) -> dict:
    """A one-process twin of (a) or (c) (``kw``), or (d) from ``restore``:
    the same compile, ``steps`` steps of fit, then its step's ms."""
    model = _pp_lm(Adam(ADAM_LR, fused=True), **kw)
    step = None
    if restore is not None:
        step = checkpoint.restore_model(restore, model)
    run = _pp_fit(model, x, y, steps)
    fn, st = model.make_train_function(), model.train_state()
    run.update(step=step, step_ms=_ms(lambda: fn(*st, x, y), 5))
    del model, fn, st
    torch.cuda.empty_cache()
    return run


def _close_rel(got, want, label: str) -> float:
    """Largest |got - want| / |want|; raises above PP_LOSS_RTOL."""
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if len(got) != len(want) or rel > PP_LOSS_RTOL:
        raise AssertionError(f"{label}: {got} against {want} (largest "
                             f"relative gap {rel:.2e})")
    return rel


def _grad_gap(got: dict, want: dict, label: str) -> float:
    """Every gradient of ``got`` against ``want``'s under F1B_TOL; returns
    the largest |difference|."""
    worst = 0.0
    for n, w in want.items():
        torch.testing.assert_close(got[n].float(), w.float(), **F1B_TOL,
                                   msg=lambda m: f"{label} {n}: {m}")
        worst = max(worst, float((got[n].float() - w.float()).abs().max()))
    return worst


def pp_phase(card: str) -> dict:
    """Phase 30: the pipe and expert axes on two gloo ranks sharing the
    card. Returns each rank's launch counts on (a), (b) and (c)."""
    x, y = _bench_tokens(PP_BATCH)
    depth, steps = LM["depth"], PP_STEPS
    m, s_count = PP_KW["pipeline_microbatches"], PP_KW["pipeline_stages"]
    per_stage = depth // s_count
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        workers = _spawn_dp_workers(tmp, flag="--pp-worker")
        wall = time.monotonic() - t0
        twin = _pp_twin(x, y, PP_KW)
        resumed = _pp_twin(x, y, PP_KW, steps=steps - PP_CKPT_STEP,
                           restore=tmp / "ckpt")
    moe_twin = _pp_twin(x, y, MOE_KW)
    r0, r1 = workers
    # (a) GPipe through fit. Each rank's stage runs its blocks' attention
    # on each of the M microbatches, forward and backward; every rank
    # computes the loss on the broadcast output.
    a0, a1 = r0["gpipe"], r1["gpipe"]
    want_a = (per_stage * m * steps, per_stage * m * steps, steps, steps,
              steps, 0)
    if (a0["loss"] != a1["loss"] or r0["replicas"] != 1
            or r0["backend"] != "gloo"
            or any(not torch.equal(a0["replicated"][n], a1["replicated"][n])
                   for n in a0["replicated"])):
        raise AssertionError(f"(30 a) the ranks differ: losses {a0['loss']}"
                             f" / {a1['loss']}")
    for r, a in enumerate((a0, a1)):
        if (a["counts"] != want_a or not a["layout"]
                or any(shape[0] != 1 for shape in a["stage_shapes"].values())):
            raise AssertionError(f"(30 a) rank {r}: launches {a['counts']} "
                                 f"(want {want_a}), stage leaves "
                                 f"{sorted(set(a['stage_shapes'].values()))}")
    rel_a = _close_rel(a0["loss"], twin["loss"], "(30 a) losses vs the twin")
    staged = a0["staged"]
    log(f"[30 pp] (a) the full-width LM with pipeline_stages={s_count}, "
        f"microbatches={m} under {PP_AXES} on two gloo ranks sharing the "
        f"card (workers {wall:.1f} s), fit with Adam(fused=True) + fused CE,"
        f" {steps} steps of {PP_BATCH} x {LM['seq_len']}: losses "
        f"{[round(v, 6) for v in a0['loss']]} bit for bit on both ranks "
        f"(replicated leaves too); pipe-less twin "
        f"{[round(v, 6) for v in twin['loss']]} (largest relative gap "
        f"{rel_a:.2e}, limit {PP_LOSS_RTOL:g}); stage leaves "
        f"{len(a0['layout'])} at [1, ...] a rank; launches (flash fwd, bwd,"
        f" Adam, CE fwd, CE bwd, SGD) {a0['counts']} / {a1['counts']} "
        f"(predicted {want_a}; twin {twin['counts']}) ({card})")
    log(f"[30 pp] (a) times ({card}): step {a0['step_ms']:.3f} / "
        f"{a1['step_ms']:.3f} ms a rank (two ranks on one card) against the "
        f"one-process twin's {twin['step_ms']:.3f} ms; stage handoffs in one "
        f"step: {staged['shifts']} exchanges, {staged['calls']} staged "
        f"through the host, {staged['bytes'] / 2**20:.2f} MiB, "
        f"{staged['seconds'] * 1e3:.3f} ms host time")
    # (b) 1F1B against GPipe on the same weights, its memory, an SGD loop.
    b0, b1 = r0["f1b"], r1["f1b"]
    gaps = {}
    for r, b in enumerate((b0, b1)):
        loss_g, grads_g = b["gpipe"]
        for mm in (4, 8):
            loss_f, grads_f, stats = b["f1b"][mm]
            np.testing.assert_allclose(loss_f, loss_g, **F1B_TOL,
                                       err_msg=f"(30 b) rank {r} M={mm}")
            gaps[r, mm] = _grad_gap(grads_f, grads_g,
                                    f"(30 b) rank {r} M={mm}")
            if stats["slots"] != min(s_count, mm) or \
                    stats["max_live"] > min(s_count, mm):
                raise AssertionError(f"(30 b) rank {r} M={mm}: {stats}")
        if not b["peak_mb"]["f1b"] < b["peak_mb"]["gpipe"]:
            raise AssertionError(f"(30 b) rank {r}: 1F1B peak "
                                 f"{b['peak_mb']} not below GPipe's")
        if not b["sgd_loss"][-1] < b["sgd_loss"][0] or b["counts"][5] != steps:
            raise AssertionError(f"(30 b) rank {r}: SGD losses "
                                 f"{b['sgd_loss']}, launches {b['counts']}")
    if b0["sgd_loss"] != b1["sgd_loss"]:
        raise AssertionError(f"(30 b) losses {b0['sgd_loss']} / "
                             f"{b1['sgd_loss']}")
    log(f"[30 pp] (b) make_1f1b_train_step on seed 0's weights: loss and "
        f"gradients against GPipe's at rtol {F1B_TOL['rtol']:g}, atol "
        f"{F1B_TOL['atol']:g}: largest |diff| M=4 {gaps[0, 4]:.2e} / "
        f"{gaps[1, 4]:.2e}, M=8 {gaps[0, 8]:.2e} / {gaps[1, 8]:.2e} (rank "
        f"0 / 1); stash {b0['f1b'][8][2]} / {b1['f1b'][8][2]} at M=8; peak "
        f"allocated above the model over one step at M=8: 1F1B "
        f"{b0['peak_mb']['f1b']:.1f} / {b1['peak_mb']['f1b']:.1f} MiB, GPipe "
        f"{b0['peak_mb']['gpipe']:.1f} / {b1['peak_mb']['gpipe']:.1f} MiB; "
        f"{steps} steps with SGD(fused=True, lr {F1B_SGD_LR:g}): losses "
        f"{[round(v, 5) for v in b0['sgd_loss']]} on both ranks; launches "
        f"{b0['counts']} / {b1['counts']}; step + update "
        f"{b0['step_ms']:.3f} / {b1['step_ms']:.3f} ms ({card})")
    # (c) MoE through fit.
    c0, c1 = r0["moe"], r1["moe"]
    want_c = (depth * steps, depth * steps, steps, steps, steps, 0)
    routers = [n for n in c0["replicated"] if n.endswith("router")]
    if (c0["loss"] != c1["loss"] or len(routers) != depth
            or any(not torch.equal(c0["replicated"][n], c1["replicated"][n])
                   for n in c0["replicated"])):
        raise AssertionError(f"(30 c) the ranks differ: losses {c0['loss']}"
                             f" / {c1['loss']}")
    e_local = MOE_KW["moe_experts"] // EP_AXES["expert"]
    for r, c in enumerate((c0, c1)):
        ce, stepped = c["objective"]
        aux = sum(c["aux"])
        if (c["counts"] != want_c
                or any(shape[0] != e_local
                       for shape in c["expert_shapes"].values())
                or not all(np.isfinite(c["aux"])) or not aux > 0
                or abs(stepped - (ce + aux)) > 1e-5 * abs(stepped)):
            raise AssertionError(
                f"(30 c) rank {r}: launches {c['counts']} (want {want_c}), "
                f"experts {sorted(set(c['expert_shapes'].values()))}, aux "
                f"{c['aux']}, step loss {stepped} vs CE {ce} + aux {aux}")
    rel_c = _close_rel(c0["loss"], moe_twin["loss"],
                       "(30 c) losses vs the twin")
    log(f"[30 pp] (c) the LM with moe_experts={MOE_KW['moe_experts']}, "
        f"top_k={MOE_KW['moe_top_k']}, groups={MOE_KW['moe_groups']} under "
        f"{EP_AXES}, fit as (a): losses {[round(v, 6) for v in c0['loss']]} "
        f"bit for bit on both ranks (router and every replicated leaf too); "
        f"one-process twin {[round(v, 6) for v in moe_twin['loss']]} "
        f"(largest relative gap {rel_c:.2e}); expert leaves "
        f"{len(c0['layout'])} at [{e_local}, ...] a rank; aux losses "
        f"{[round(v, 6) for v in c0['aux']]} in the objective (step loss "
        f"{c0['objective'][1]:.6f} = CE {c0['objective'][0]:.6f} + aux); "
        f"launches {c0['counts']} / {c1['counts']} (twin "
        f"{moe_twin['counts']}) ({card})")
    log(f"[30 pp] (c) times ({card}): step {c0['step_ms']:.3f} / "
        f"{c1['step_ms']:.3f} ms a rank against the twin's "
        f"{moe_twin['step_ms']:.3f} ms; all_to_all: {c0['a2a']['calls']} "
        f"exchanges, {c0['a2a']['seconds'] * 1e3:.3f} ms host time of a "
        f"{c0['a2a']['step_s'] * 1e3:.3f} ms step")
    # (d) (a)'s checkpoint restored in one process and continued.
    if resumed["step"] != PP_CKPT_STEP:
        raise AssertionError(f"(30 d) restored step {resumed['step']}")
    rel_d = _close_rel(resumed["loss"], a0["loss"][PP_CKPT_STEP:],
                       "(30 d) resumed losses")
    log(f"[30 pp] (d) (a)'s checkpoint at step {PP_CKPT_STEP} (stage leaves"
        f" gathered over the pipe axis) restored in one process without a "
        f"pipe axis and fit {steps - PP_CKPT_STEP} more steps: losses "
        f"{[round(v, 6) for v in resumed['loss']]} against the pipelined "
        f"run's {[round(v, 6) for v in a0['loss'][PP_CKPT_STEP:]]} "
        f"(largest relative gap {rel_d:.2e}) ({card})")
    log(f"[30 pp] phase 30 took {time.monotonic() - t0:.1f} s (workers "
        f"{r0['seconds']:.1f} s of work each)")
    return {"gpipe_rank0": a0["counts"], "gpipe_rank1": a1["counts"],
            "f1b_rank0": b0["counts"], "f1b_rank1": b1["counts"],
            "moe_rank0": c0["counts"], "moe_rank1": c1["counts"]}


# -- phase 31: supervised training that survives its faults ----------------------

#: Phase 31 (f): 2 epochs x 2 steps of the benchmark LM at batch 64 x 512.
GUARD_EPOCHS, GUARD_STEPS = 2, 2
#: (f)'s nan_loss: epoch 1's last step, so the rollback restores epoch 0's
#: step and replays epoch 1.
GUARD_NAN_STEP = GUARD_EPOCHS * GUARD_STEPS - 1
#: The chaos CLI's subprocess runs (a)-(e), together: the baselines, then
#: every attempt.
TRAIN_CHAOS_TIMEOUT_S = 400
#: (f) the health vector against its plain version on the card: fp32 sums
#: of squares in another order (the port reduces per-leaf norms).
HEALTH_RTOL = 1e-5
_GUARD_ENV = ("TPU_DIST_INTEGRITY", "TPU_DIST_FAULT_PLAN",
              "TPU_DIST_EVENT_LOG")


def _train_chaos(runs: dict, tmp: pathlib.Path, phase: str = "31") -> dict:
    """``python -m tpu_dist_torch.resilience ARGS`` for each ``{label:
    ARGS}`` (on the card: no ``--device``), all at once as subprocesses
    (their workers share the card and the host), each to its end; their
    reports, each of which must say ``ok``, with ``wall_s`` from the start
    to the run's end."""
    return _finish_chaos(_start_chaos(runs, tmp), tmp, phase)


def _start_chaos(runs: dict, tmp: pathlib.Path) -> tuple:
    """Start :func:`_train_chaos`'s subprocesses; ``(procs, t0)``."""
    root = pathlib.Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if k not in _GUARD_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(root), os.environ.get("PYTHONPATH")]))
    t0 = time.monotonic()
    procs = {}
    for label, args in runs.items():
        with open(tmp / f"{label}.out", "wb") as out:
            procs[label] = subprocess.Popen(
                [sys.executable, "-m", "tpu_dist_torch.resilience", *args,
                 "--workdir", str(tmp / label),
                 "--report", str(tmp / f"{label}.json")],
                cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    return procs, t0


def _finish_chaos(started: tuple, tmp: pathlib.Path, phase: str) -> dict:
    """Wait for :func:`_start_chaos`'s runs; their reports."""
    procs, t0 = started
    ended = {}
    try:
        while len(ended) < len(procs):
            if time.monotonic() - t0 > TRAIN_CHAOS_TIMEOUT_S:
                raise AssertionError(f"({phase}) chaos runs {sorted(set(procs) - set(ended))} "
                                     f"past {TRAIN_CHAOS_TIMEOUT_S} s")
            for label, proc in procs.items():
                if label not in ended and proc.poll() is not None:
                    ended[label] = time.monotonic() - t0
            time.sleep(0.2)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    reports = {}
    for label, proc in procs.items():
        path = tmp / f"{label}.json"
        report = json.loads(path.read_text()) if path.exists() else {}
        if proc.returncode != 0 or not report.get("ok"):
            work = tmp / label
            logs = "".join(p.read_text()[-1500:] for p in sorted(
                work.glob("**/logs/*.log")))
            raise AssertionError(
                f"({phase} {label}) exit {proc.returncode}: "
                f"{report.get('failure')}\n"
                f"{(tmp / f'{label}.out').read_text()[-3000:]}\n{logs}")
        report["wall_s"] = ended[label]
        reports[label] = report
    return reports


def _guarded_lm(k: int, fused_ce: bool):
    """The benchmark LM (seed 0) with ``Adam(fused=True)`` at k steps an
    execution; the fused CE or the plain one."""
    model = build_transformer_lm(LM["vocab_size"], LM["seq_len"],
                                 d_model=LM["d_model"], depth=LM["depth"],
                                 num_heads=LM["num_heads"], seed=0)
    model.compile(optimizer=Adam(fused=True),
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=fused_ce),
                  steps_per_execution=k)
    return model


def _free_card() -> str:
    """Collect the earlier models' reference cycles, whose captured graphs'
    private pools hold the card's memory until their owners are collected,
    and return the freed cache to the card; the allocator's state after."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return (f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")


def _guarded_fit(tmp: pathlib.Path, label: str, *, k: int, armed: bool,
                 fused_ce: bool, plan: str | None = None) -> dict:
    """One fit of :func:`_guarded_lm` on the bench tokens (one pass an
    epoch) with a checkpoint per epoch, ``TPU_DIST_INTEGRITY`` set when
    ``armed``, ``plan`` in ``TPU_DIST_FAULT_PLAN``: its losses, parameters,
    kernel launches and events. The model (and its k-step graphs) is
    freed before the next one."""
    from tpu_dist_torch.resilience import read_events

    _free_card()
    work = tmp / label
    work.mkdir(parents=True)
    saved = {name: os.environ.pop(name, None) for name in _GUARD_ENV}
    os.environ["TPU_DIST_EVENT_LOG"] = str(work / "events.jsonl")
    if armed:
        os.environ["TPU_DIST_INTEGRITY"] = "1"
    if plan:
        os.environ["TPU_DIST_FAULT_PLAN"] = plan
    try:
        x, y = (t.cpu().numpy()
                for t in _bench_tokens(GUARD_STEPS * TRAIN_BATCH))
        model = _guarded_lm(k, fused_ce)
        _reset_counts()
        clock = _EpochClock()
        h = model.fit(
            td_data.Dataset.from_tensor_slices((x, y)).batch(TRAIN_BATCH),
            epochs=GUARD_EPOCHS, verbose=0, callbacks=[clock],
            checkpoint_dir=str(work / "ckpt")).history
        torch.cuda.synchronize()
    finally:
        for name, value in saved.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value
    return {"loss": h["loss"], "params": _params(model), "counts": _counts(),
            "epoch_s": clock.seconds,
            "events": read_events(work / "events.jsonl")}


def _same_bits(a: dict, b: dict) -> bool:
    return (a["loss"] == b["loss"] and all(
        torch.equal(p, q) for p, q in zip(a["params"], b["params"])))


def _armed_step_times(card: str) -> dict:
    """(f) the armed step (its health vector, and the guard's one-behind
    read) against the unarmed step on the same trainer, in turns (plain,
    armed, armed, plain) x 3, 5 steps each; the health vector against its
    plain version; the SDC audit's seconds over the 21,269,504
    parameters."""
    from tpu_dist_torch.training import integrity

    _free_card()
    model = _guarded_lm(1, fused_ce=True)
    tr = model._get_trainer("optimizer loss")
    tr.ensure_variables()
    v = tr.variables
    acc = tr._init_loss_acc()
    x, y = _bench_tokens(TRAIN_BATCH)
    args = (v["params"], v["state"], v["opt"], v["metrics"], acc, x, y)
    plain = tr._step()
    armed = tr._step(None, None, integrity.StepHealth(v["params"]))
    guard = integrity.IntegrityGuard(
        integrity.IntegrityConfig(rollback_budget=10 ** 6))
    # The vector against health_summary of the same step, on the card.
    before = [p.detach().clone() for p in v["params"]]
    loss, h = armed(*args)
    want = integrity.health_summary(loss, [p.grad for p in v["params"]],
                                    before, v["params"])
    if float(h[0]) != float(want[0]) or not torch.allclose(
            h[1:], want[1:], rtol=HEALTH_RTOL, atol=0.0):
        raise AssertionError(f"(31 f) armed health {h.tolist()} against "
                             f"its plain version {want.tolist()}")
    step_no = itertools.count()

    def run(armed_on: bool, n: int = 5) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            if armed_on:
                _, health = armed(*args)
                guard.on_execution(next(step_no), 1, health, None)
            else:
                plain(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    run(False), run(True)  # warm-up
    times = {"plain": [], "armed": []}
    for _ in range(3):
        for armed_on in (False, True, True, False):
            times["armed" if armed_on else "plain"].append(run(armed_on))
    guard.flush()
    leaves = integrity.named_leaves(model)
    audit_ms = []
    for i in range(5):
        guard.audit(leaves, gstep=i + 1)
        audit_ms.append(guard.last_audit_s * 1e3)
    out = {k: statistics.median(t) for k, t in times.items()}
    log(f"[31 f] armed step {out['armed']:.3f} ms against unarmed "
        f"{out['plain']:.3f} ms (medians of 6 runs of 5 steps, turns plain,"
        f" armed, armed, plain: plain {[round(t, 3) for t in times['plain']]}"
        f", armed {[round(t, 3) for t in times['armed']]}; "
        f"{(out['armed'] / out['plain'] - 1) * 100:+.2f} %); health "
        f"{[float(f'{t:.6g}') for t in h.tolist()]} (plain "
        f"{[float(f'{t:.6g}') for t in want.tolist()]}); the SDC audit over "
        f"{sum(t.numel() for t in leaves.values()):,} parameters in "
        f"{len(leaves)} leaves {statistics.median(audit_ms):.3f} ms median "
        f"({[round(t, 3) for t in audit_ms]}, host clock, D2H included); "
        f"{card}")
    return out


def _guard_fits(card: str, tmp: pathlib.Path) -> dict:
    """Phase 31 (f): the integrity guard at full width in this process.
    Returns the launches on its paths: (flash fwd, flash bwd, Adam, CE fwd,
    CE bwd, SGD) a fit."""
    log(f"[31 f] the card before (f): {_free_card()}")
    out = {}
    for k in (1, 2):
        runs = {armed: _guarded_fit(tmp, f"f{k}_{'armed' if armed else 'off'}",
                                    k=k, armed=armed, fused_ce=True)
                for armed in (False, True)}
        if not _same_bits(runs[True], runs[False]) or \
                runs[True]["counts"] != runs[False]["counts"]:
            raise AssertionError(
                f"(31 f) k = {k}: the armed fit moved: losses "
                f"{runs[True]['loss']} / {runs[False]['loss']}, launches "
                f"{runs[True]['counts']} / {runs[False]['counts']}")
        want = (LM["depth"] * GUARD_EPOCHS * GUARD_STEPS,) * 2 + (
            GUARD_EPOCHS * GUARD_STEPS,) * 3 + (0,)
        if runs[True]["counts"] != want:
            raise AssertionError(f"(31 f) k = {k}: launches "
                                 f"{runs[True]['counts']}; expected {want}")
        out[f"lm_guarded_k{k}"] = runs[True]["counts"]
        clean = _guarded_fit(tmp, f"f{k}_clean", k=k, armed=False,
                             fused_ce=False)
        chaos = _guarded_fit(tmp, f"f{k}_nan", k=k, armed=True,
                             fused_ce=False,
                             plan=f"nan_loss@step{GUARD_NAN_STEP}")
        rbs = [e for e in chaos["events"]
               if e["event"] == "integrity_rollback"]
        replayed = tuple(c * (GUARD_EPOCHS + 1) // GUARD_EPOCHS
                         for c in clean["counts"])
        if not (len(rbs) == 1 and rbs[0]["restored_step"] == 0
                and _same_bits(chaos, clean) and chaos["counts"] == replayed):
            raise AssertionError(
                f"(31 f) k = {k} nan_loss: rollbacks {rbs}, losses "
                f"{chaos['loss']} / {clean['loss']}, launches "
                f"{chaos['counts']} (expected {replayed})")
        out[f"lm_rollback_k{k}"] = chaos["counts"]
        log(f"[31 f] k = {k}{' on graphs' if k > 1 else ' eager'}: armed "
            f"fused-CE fit bit for bit with the unarmed one (losses "
            f"{[float(f'{l:.7g}') for l in runs[True]['loss']]}), launches "
            f"{runs[True]['counts']}, epoch s armed "
            f"{[round(t, 3) for t in runs[True]['epoch_s']]} / unarmed "
            f"{[round(t, 3) for t in runs[False]['epoch_s']]}; nan_loss@"
            f"{GUARD_NAN_STEP} "
            f"(plain CE): 1 rollback to step 0, final loss and every "
            f"parameter bit for bit with the clean fit "
            f"({clean['loss'][-1]!r}), launches {chaos['counts']} (the "
            f"replayed epoch included)")
    _armed_step_times(card)
    return out


def train_chaos_phase(card: str) -> dict:
    """Phase 31: the training chaos CLI on the card (a)-(e), then the
    integrity guard at full width in this process (f). Returns the
    kernels' launches on (f)'s paths: (flash fwd, flash bwd, Adam, CE fwd,
    CE bwd, SGD) a fit."""
    t_phase = time.monotonic()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-31-"))
    # Phase 33 (c)'s `jobs --chaos` runs beside (a)-(e): no gate of either
    # reads a time, and their process starts overlap.
    _BACKGROUND["jobs_chaos"] = _start_cli(
        "tpu_dist_torch.jobs", JOBS_CHAOS_ARGS,
        pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-33-")), "jobs_chaos")
    # Phase 32 (b)'s reshape run too: its gates are parity and events.
    tmp32 = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-32-"))
    _BACKGROUND["reshape"] = (_start_chaos(RESHAPE_RUN, tmp32), tmp32)
    # (a)-(e) at once, beside (f) in this process (the gates are the
    # runs' own and (f)'s are bit for bit: none reads a time; the wall
    # times are on a shared card and host).
    started = _start_chaos({
        # The reference's acceptance demo: a kill, then a kill inside the
        # epoch-2 write on the restarted attempt.
        "a": ["--plan", "kill-worker@step5,kill-during-save@epoch2:attempt1"],
        # Preemption: a SIGTERM drained at the step.
        "b": ["--plan", "preempt@step6"],
        # The three batch faults in one process, one rollback each.
        "c": ["--plan", "nan_loss@step2,grad_spike@step6,"
              "corrupt_batch@step10"],
        # Silent data corruption on two gloo ranks of the card.
        "d": ["--workers", "2", "--plan", "bitflip@step9:leaf1:replica1"],
        # A dead peer: rank 1 killed; the gang restarts and recovers.
        "e": ["--workers", "2", "--plan", "kill-worker@step5:rank1"],
    }, tmp)
    out = _guard_fits(card, tmp)
    reports = _finish_chaos(started, tmp, "31")
    t_cli = time.monotonic() - t_phase
    rep = reports["a"]
    if not (rep["restarts"] >= 2 and rep["exit_codes"][:2] == [[43], [43]]
            and rep["resumed_from"][-1:] == [1]
            and rep["loss_delta"] <= 1e-5):
        raise AssertionError(f"(31 a) {rep}")
    log(f"[31 a] kill at step 5, kill during the epoch-2 save: restarts "
        f"{rep['restarts']}, exit codes {rep['exit_codes']}, resumed from "
        f"{rep['resumed_from']}, loss_delta {rep['loss_delta']!r} (final "
        f"{rep['final_loss']!r}), recovery_wall_s {rep['recovery_wall_s']}, "
        f"run {rep['wall_s']:.1f} s")
    rep = reports["b"]
    if not (any("preempted" in k for k in rep["exit_kinds"])
            and any(d is not None for d in rep["drain_s"])
            and rep["loss_delta"] <= 1e-5):
        raise AssertionError(f"(31 b) {rep}")
    log(f"[31 b] preempt at step 6: exit kinds {rep['exit_kinds']}, drain_s "
        f"{rep['drain_s']}, loss_delta {rep['loss_delta']!r}, "
        f"recovery_wall_s {rep['recovery_wall_s']}, run {rep['wall_s']:.1f} s")
    rep = reports["c"]
    rollbacks = rep["integrity"]["rollbacks"]
    if not (rep["restarts"] == 0 and len(rep["faults_fired"]) == 3
            and len(rollbacks) >= 3 and rep["loss_delta"] <= 1e-5):
        raise AssertionError(f"(31 c) {rep}")
    log(f"[31 c] nan_loss@2, grad_spike@6, corrupt_batch@10: restarts 0, "
        f"rollbacks {[(r['kind'], r['step'], r['restored_step']) for r in rollbacks]}"
        f", loss_delta {rep['loss_delta']!r}, run {rep['wall_s']:.1f} s")
    rep = reports["d"]
    sdc = rep["integrity"]["sdc_detections"]
    flipped = {c["leaf"] for d in sdc for c in d["culprits"]}
    ranks_named = {c["rank"] for d in sdc for c in d["culprits"]}
    if not (sdc and flipped == {"['conv2d']['kernel']"}
            and ranks_named == {0, 1} and rep["restarts"] == 0
            and rep["integrity"]["rollbacks"]
            and rep["loss_delta"] <= 1e-5):
        raise AssertionError(f"(31 d) {rep}")
    log(f"[31 d] bitflip on rank 1, leaf 1: culprits {sorted(flipped)} on "
        f"ranks {sorted(ranks_named)} (a group of two has no majority), "
        f"restarts 0, rollbacks {len(rep['integrity']['rollbacks'])} (one a "
        f"rank), loss_delta {rep['loss_delta']!r}, run {rep['wall_s']:.1f} s")
    rep = reports["e"]
    if not (rep["restarts"] >= 1 and rep["loss_delta"] <= 1e-5):
        raise AssertionError(f"(31 e) {rep}")
    events = [json.loads(line) for line in
              (tmp / "e" / "events.jsonl").read_text().splitlines()]
    survivor = [e["event"] for e in events
                if e["event"] in ("peer_unavailable", "worker_error")]
    log(f"[31 e] rank 1 killed at step 5: exit kinds {rep['exit_kinds']}, "
        f"the survivor's exit event {survivor}, loss_delta "
        f"{rep['loss_delta']!r}, recovery_wall_s {rep['recovery_wall_s']}, "
        f"run {rep['wall_s']:.1f} s")
    log(f"[31] done in {time.monotonic() - t_phase:.1f} s ((a)-(e) beside "
        f"(f), ended {t_cli:.1f} s in); {card}")
    return out



# -- phase 32: elasticity --------------------------------------------------------

#: (b): the reshape run of the chaos CLI.
RESHAPE_RUN = {"b": ["--reshape", "2,1", "--plan", "preempt@step5"]}
#: (c): 2 epochs x 2 steps of the benchmark LM at 8 x 512 under TP_AXES.
ELASTIC_EPOCHS, ELASTIC_STEPS, ELASTIC_BATCH = 2, 2, 8
#: (c): how long a worker waits for the parent's one-process step.
ELASTIC_ONE_WAIT_S = 300


def _elastic_data():
    """(c)'s two batches of bench.py's token stream, 8 x 512 each, host
    side (a process group's fit feeds them from the host)."""
    x, y = _bench_tokens(ELASTIC_BATCH * ELASTIC_STEPS)
    return td_data.Dataset.from_tensor_slices(
        (x.cpu().numpy(), y.cpu().numpy())).batch(ELASTIC_BATCH)


def _elastic_lm():
    return _compiled_lm(Adam(ADAM_LR, fused=True), fused_ce=True)


def _step_bytes(target: pathlib.Path, rank: int, chief: bool) -> int:
    """The bytes ``rank`` wrote into the published step ``target``: its
    shard files (v2), and the chief's arrays and manifest."""
    names = [f"arrays-shard-{rank}.npz", f"shards-{rank}.json"]
    if chief:
        names += ["arrays.npz", "manifest.json"]
    return sum((target / n).stat().st_size for n in names
               if (target / n).exists())


def elastic_worker(outdir: pathlib.Path) -> int:
    """Phase 32's worker (``chip_smoke.py --elastic-worker DIR``, TF_CONFIG
    in the environment): (c) the LM under {data: 1, model: 2} with v2
    checkpoints (sync and async) and a v1 one, timed saves, DIR/one's
    one-process v2 step restored and trained on; (d) the group's
    reinitialize. Writes ``worker<rank>.pt`` into DIR."""
    from tpu_dist_torch.training.callbacks import ModelCheckpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for source in SOURCES:
        _build.load(source)
    strategy = MultiWorkerMirroredStrategy(communication="ring",
                                          axis_shapes=TP_AXES)
    rank, chief = bootstrap.process_index(), bootstrap.is_chief()
    with strategy.scope():
        model = _elastic_lm()
    cbs = [ModelCheckpoint(str(outdir / "v2_sync"), sharded=True,
                           async_save=False),
           ModelCheckpoint(str(outdir / "v2_async"), sharded=True),
           ModelCheckpoint(str(outdir / "v1"), async_save=False)]
    _reset_counts()
    loss = model.fit(_elastic_data(), epochs=ELASTIC_EPOCHS,
                     steps_per_epoch=ELASTIC_STEPS, verbose=0,
                     callbacks=cbs).history["loss"]
    torch.cuda.synchronize()
    out = {"counts": _counts(), "loss": loss, "save_s": {}, "bytes": {}}
    for label, kw in (("v2", {"sharded": True}), ("v1", {})):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        checkpoint.save(outdir / f"timed_{label}", model, step=0, **kw)
        out["save_s"][label] = time.perf_counter() - t0
        out["bytes"][label] = _step_bytes(
            outdir / f"timed_{label}" / "ckpt-0", rank, chief)
    del model
    torch.cuda.empty_cache()
    # 1 -> 2: the one-process v2 step onto both ranks, then an epoch. The
    # parent fits and saves it while the workers start and fit.
    deadline = time.monotonic() + ELASTIC_ONE_WAIT_S
    while checkpoint.latest_step(outdir / "one") is None:
        if time.monotonic() > deadline:
            raise AssertionError(f"(32 c) no one-process step in "
                                 f"{ELASTIC_ONE_WAIT_S} s")
        time.sleep(0.1)
    with strategy.scope():
        reader = _elastic_lm()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    out["one_step"] = checkpoint.restore_model(outdir / "one", reader)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["one_loss"] = reader.fit(_elastic_data(), epochs=1,
                                 steps_per_epoch=ELASTIC_STEPS,
                                 verbose=0).history["loss"]
    del reader
    torch.cuda.empty_cache()
    # (d) the group re-dialled under generation 1.
    dev = bootstrap.group_device()
    x = torch.full((4,), float(rank + 1), device=dev)
    torch.distributed.all_reduce(x)
    params = bootstrap._live_group_params()
    old_port = params["base_port"] + bootstrap.current_generation()
    generation = bootstrap.reinitialize()
    y = torch.full((4,), float(rank + 1), device=dev)
    torch.distributed.all_reduce(y)
    out["reinit"] = {**bootstrap.last_reinit, "old_port": old_port,
                     "generation_returned": generation,
                     "before": x.tolist(), "after": y.tolist(),
                     "backend": torch.distributed.get_backend()}
    torch.save(_cpu(out), outdir / f"worker{rank}.pt")
    return 0


def _resume_epoch(directory: pathlib.Path) -> dict:
    """(c)'s one-process resume: restore ``directory``'s step 1 (end of
    epoch 1) into the LM and fit epoch 2; restore seconds, losses and the
    parameters and Adam states after."""
    model = _elastic_lm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = checkpoint.restore_model(directory, model, step=1)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    loss = model.fit(_elastic_data(), epochs=ELASTIC_EPOCHS + 1,
                     initial_epoch=ELASTIC_EPOCHS,
                     steps_per_epoch=ELASTIC_STEPS,
                     verbose=0).history["loss"]
    state = {k: t.detach().cpu() for k, t in
             checkpoint._live_tensors(model, gathered=False).items()}
    del model
    torch.cuda.empty_cache()
    return {"step": step, "restore_s": restore_s, "loss": loss,
            "state": state}


def elastic_phase(card: str) -> dict:
    """Phase 32: elasticity, (a)-(d). Returns each rank's launches on
    (c)'s fit."""
    t_phase = time.monotonic()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-32-"))
    # (b) in the background while (c) and (d) run (its gates are parity
    # and events, not times), started by phase 31 unless this phase runs
    # alone.
    reshape, tmp_b = _BACKGROUND.pop("reshape", None) or (
        _start_chaos(RESHAPE_RUN, tmp), tmp)
    # The workers start (~8 s each to reach the card) while this process
    # fits and saves the one-process step they restore after their fit.
    c = tmp / "c"
    c.mkdir()
    t_workers = time.monotonic()
    spawned = _start_dp_workers(c, "--elastic-worker")
    try:
        one = _elastic_lm()
        one.fit(_elastic_data(), epochs=1, steps_per_epoch=ELASTIC_STEPS,
                verbose=0)
        checkpoint.save(c / "one", one, step=0, sharded=True)
        del one
        torch.cuda.empty_cache()
    except BaseException:
        _stop_workers(*spawned[:2])
        raise
    workers = _finish_dp_workers(c, *spawned)
    t_workers = time.monotonic() - t_workers
    # (c) every stitched v2 leaf against the v1 step's, bit for bit.
    with np.load(c / "v1" / "ckpt-1" / "arrays.npz") as z:
        v1 = {k: z[k] for k in z.files}
    sharded = 0
    for label in ("v2_sync", "v2_async"):
        target = c / label / "ckpt-1"
        manifest = json.loads((target / "manifest.json").read_text())
        if (manifest["format"] != "tpu_dist.checkpoint.v2-sharded"
                or manifest["process_count"] != 2):
            raise AssertionError(f"(32 c) {label}: manifest {manifest}")
        leaves = dict(checkpoint._iter_sharded_leaves(target))
        if set(leaves) != set(v1):
            raise AssertionError(f"(32 c) {label}: keys differ from v1's")
        for key, assemble in leaves.items():
            a = assemble()
            if a.dtype != v1[key].dtype or a.tobytes() != v1[key].tobytes():
                raise AssertionError(f"(32 c) {label}: {key} differs from "
                                     f"the v1 step's")
        sharded = sum(m["sharded"] for m in manifest["leaves"].values())
    # 2 -> 1: one process resumes the v2 step for an epoch, bit for bit
    # with the same resume from the v1 step.
    r2, r1 = _resume_epoch(c / "v2_sync"), _resume_epoch(c / "v1")
    if not (r2["step"] == r1["step"] == 1 and r2["loss"] == r1["loss"]
            and all(torch.equal(r2["state"][k], r1["state"][k])
                    for k in r1["state"])):
        raise AssertionError(f"(32 c) 2 -> 1 resume: v2 losses "
                             f"{r2['loss']} against v1's {r1['loss']}")
    want = (LM["depth"] * ELASTIC_EPOCHS * ELASTIC_STEPS,) * 2 + (
        ELASTIC_EPOCHS * ELASTIC_STEPS,) * 3 + (0,)
    for rank, w in enumerate(workers):
        if tuple(w["counts"]) != want:
            raise AssertionError(f"(32 c) rank {rank} launches "
                                 f"{w['counts']}; expected {want}")
        if not (w["one_step"] == 0
                and all(np.isfinite(l) for l in w["one_loss"])):
            raise AssertionError(f"(32 c) rank {rank}: 1 -> 2 restore "
                                 f"{w['one_step']}, losses {w['one_loss']}")
    if workers[0]["loss"] != workers[1]["loss"]:
        raise AssertionError(f"(32 c) the ranks' losses differ: "
                             f"{[w['loss'] for w in workers]}")
    log(f"[32 c] {{data: 1, model: 2}} LM, {ELASTIC_EPOCHS} x "
        f"{ELASTIC_STEPS} steps of {ELASTIC_BATCH} x {LM['seq_len']}, losses "
        f"{[float(f'{l:.7g}') for l in workers[0]['loss']]}: v2 (sync and "
        f"async, {sharded} of {len(v1)} leaves in blocks) stitched bit for "
        f"bit with v1; 2 -> 1 resume of epoch 2 bit for bit with v1's "
        f"(loss {r1['loss']}); 1 -> 2 restore + an epoch (losses "
        f"{[float(f'{l:.7g}') for l in workers[0]['one_loss']]}); workers "
        f"{t_workers:.1f} s")
    for rank, w in enumerate(workers):
        log(f"[32 c] rank {rank}: bytes written v2 {w['bytes']['v2']} / v1 "
            f"{w['bytes']['v1']}; save s v2 {w['save_s']['v2']:.4f} / v1 "
            f"(gather and write) {w['save_s']['v1']:.4f}; restore s (1 -> "
            f"2) {w['restore_s']:.4f}; launches {tuple(w['counts'])}")
    log(f"[32 c] one process: restore s v2 (2 -> 1, stitched) "
        f"{r2['restore_s']:.4f} / v1 {r1['restore_s']:.4f}; {card}")
    # (d) the gloo group of CUDA tensors re-dialled on base + 1.
    for rank, w in enumerate(workers):
        r = w["reinit"]
        if not (r["generation"] == r["generation_returned"] == 1
                and r["before"] == r["after"] == [3.0] * 4
                and r["port"] == r["old_port"] + 1):
            raise AssertionError(f"(32 d) rank {rank}: {r}")
        log(f"[32 d] rank {rank} ({r['backend']}): all-reduce {r['before']}"
            f" at generation 0 on port {r['old_port']}, {r['after']} at "
            f"generation 1 on port {r['port']}; teardown "
            f"{r['teardown_s'] * 1e3:.2f} ms, bring-up "
            f"{r['init_s'] * 1e3:.2f} ms")
    # (b)'s report.
    rep = _finish_chaos(reshape, tmp_b, "32")["b"]
    restores = [(r["saved_process_count"], r["process_count"])
                for r in rep["reshape_restores"]]
    if not (rep["exit_kinds"][0] == ["preempted", "preempted"]
            and restores == [(2, 1)] and rep["loss_delta"] <= 1e-5):
        raise AssertionError(f"(32 b) {rep}")
    log(f"[32 b] --reshape 2,1 preempt@step5: exit kinds "
        f"{rep['exit_kinds']}, reshape_restores {rep['reshape_restores']}, "
        f"loss_delta {rep['loss_delta']!r} (final {rep['final_loss']!r}), "
        f"recovery_wall_s {rep['recovery_wall_s']}, run "
        f"{rep['wall_s']:.1f} s")
    # (a) alone: its gate compares two legs' wall times.
    for label in ("jobs_bench", "jobs_chaos"):
        _join_background(label)
    rep = _train_chaos({"a": ["--step-rejoin", "--plan",
                              "kill-worker@step6:rank1"]}, tmp, "32")["a"]
    legs = rep["step_rejoin"]
    if not (legs["reform"]["restarts"] == 0 and rep["loss_delta"] == 0.0
            and legs["reform"]["gang_reforms"] == [1]):
        raise AssertionError(f"(32 a) {rep}")
    log(f"[32 a] --step-rejoin kill-worker@step6:rank1: recovery_wall_s "
        f"control (gang restart) {legs['control']['recovery_wall_s']} / "
        f"reform {legs['reform']['recovery_wall_s']}, speedup "
        f"{legs['speedup']}, breakdown {rep['recovery_breakdown']}, "
        f"loss_delta {rep['loss_delta']!r}, run {rep['wall_s']:.1f} s; "
        f"{card}")
    log(f"[32] done in {time.monotonic() - t_phase:.1f} s")
    return {f"elastic_rank{rank}": tuple(w["counts"])
            for rank, w in enumerate(workers)}



# -- phase 33: jobs and the parameter server ---------------------------------------

#: (a): the benchmark LM as a parameter server: two workers of 8 x 512 each,
#: a budget of PS_BUDGET applies through Adam(fused=True), staleness 4.
PS_WORKERS, PS_BATCH, PS_BUDGET, PS_STALENESS = 2, 8, 16, 4
#: (a): the batches a worker cycles through (an "epoch"), and the epochs of
#: its local cap (the server's STOP ends it first).
PS_STEPS, PS_EPOCHS = 4, 2
#: (a): a worker's first gradients against the one-process twin's at the
#: packet's base version: the same kernels on the same card, held within
#: this fraction of the largest gradient (fp32 rounding).
PS_GRAD_RTOL = 1e-6
PS_TIMEOUT_S = 300
#: (b): workers a leg, and steps an epoch a worker (the budget is 2 x steps
#: x workers applies). The CLI's defaults (2 workers, 4 steps: 16 applies)
#: are applied on the card in ~0.3 s, too short a window for its
#: throughput ratios; and the straggler gate's premise is that the fast
#: workers keep the server busy. On the card's host the server's apply
#: rate moves by up to ±30 % from one leg to the next, and at 2-3 workers
#: the straggler pair's ratio fell either side of the gate (0.66-1.24 over
#: the builder's runs of the CLI), at 4 it stayed above it (1.20-1.94,
#: PERF.md §6): a clean leg's four workers load the host more than the
#: straggler leg's three.
PS_CHAOS_WORLD, PS_CHAOS_STEPS = 4, 12
PS_CHAOS_ARGS = ["--ps-chaos", "--device", "cuda", "--ps-world",
                 str(PS_CHAOS_WORLD), "--ps-steps", str(PS_CHAOS_STEPS)]
PS_OTHERS_ARGS = [*PS_CHAOS_ARGS, "--ps-legs", "sync,kill,server"]
#: (b)-(c): each CLI run's timeout.
JOBS_TIMEOUT_S = 400
JOBS_CHAOS_ARGS = ["--chaos", "--device", "cuda"]
JOBS_BENCH_ARGS = ["--bench", "--device", "cuda"]


def _ps_lm():
    """(a)'s model: the benchmark LM from seed 0 with ``Adam(fused=True)``
    and the fused CE: the server applies through the Adam kernel, a
    worker's step launches the flash and CE kernels."""
    return _compiled_lm(Adam(learning_rate=ADAM_LR, fused=True),
                        fused_ce=True)


def _ps_batches(rank: int):
    """Worker ``rank``'s PS_STEPS batches of 8 x 512 on the host:
    bench.py's token stream, started 7919 tokens further for each rank (the
    stream repeats every 16 rows, so its consecutive rows would give every
    worker the same batches)."""
    ln, vocab = LM["seq_len"], LM["vocab_size"]
    n = PS_STEPS * PS_BATCH
    stream = ((np.arange(n * ln + 1) + rank * 7919) * 2654435761) % vocab
    return (stream[:-1].reshape(n, ln).astype(np.int64),
            stream[1:].reshape(n, ln).astype(np.int64))


def ps_worker(outdir: pathlib.Path, rank: int) -> int:
    """A PS worker of (a) (``chip_smoke.py --ps-worker DIR RANK``): the LM
    fit under ``ParameterServerStrategy`` until the server's STOP; writes
    its launches, pushes, and the pull and push seconds."""
    from tpu_dist_torch.parallel.ps_strategy import ParameterServerStrategy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    metrics.get_registry().reset()
    metrics.enable()
    strategy = ParameterServerStrategy(
        str(outdir / "ps"), role="worker", rank=rank, num_workers=PS_WORKERS,
        staleness=PS_STALENESS, pull_timeout_s=PS_TIMEOUT_S)
    with strategy.scope():
        model = _ps_lm()
    x, y = _ps_batches(rank)
    ds = td_data.Dataset.from_tensor_slices((x, y)).batch(PS_BATCH)
    _reset_counts()
    t0 = time.perf_counter()
    history = model.fit(ds, epochs=PS_EPOCHS, steps_per_epoch=PS_STEPS,
                        verbose=0)
    seconds = time.perf_counter() - t0
    snap = metrics.get_registry().snapshot()["distributions"]
    (outdir / f"worker{rank}.json").write_text(json.dumps({
        "counts": list(_counts()), "pushes": strategy.pushed,
        "loss": [float(v) for v in history.history["loss"]],
        "push_s": snap.get("ps.push_s"), "pull_s": snap.get("ps.pull_s"),
        "seconds": seconds}))
    return 0


def _spawn_ps_workers(root: pathlib.Path) -> list:
    """(a)'s worker processes, ``chip_smoke.py --ps-worker DIR RANK``,
    logging to one file."""
    env = dict(os.environ)
    here = pathlib.Path(__file__).resolve()
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(here.parent), os.environ.get("PYTHONPATH")]))
    with open(root / "worker.log", "wb") as log_file:
        return [subprocess.Popen(
            [sys.executable, str(here), "--ps-worker", str(root), str(r)],
            env=env, stdout=log_file, stderr=subprocess.STDOUT)
            for r in range(PS_WORKERS)]


def _tail(path: pathlib.Path, n: int = 3000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return "<no log>"


def _at_version(psdir, version: int):
    """A fresh (a) LM at the server's parameters of ``version``: seed 0,
    then the apply log's first ``version`` packets through its fused Adam
    (the replay's arithmetic)."""
    from tpu_dist_torch.cluster.ps_transport import PSDir
    from tpu_dist_torch.models.bridge import keypath

    model = _ps_lm()
    named = list(model.named_parameters())
    params = [p for _, p in named]
    opt = model.optimizer.init(params)
    records = [r for r in psdir.read_apply_log() if "rank" in r]
    for rec in records[:version]:
        _, arrays = PSDir.load_grad(
            psdir.grads / f"g-r{rec['rank']}-{rec['seq']:08d}.npz")
        grads = [torch.from_numpy(arrays[keypath(n)]).to(p.device)
                 for n, p in named]
        with torch.no_grad():
            model.optimizer.update(grads, opt, params)
    return model


def _first_grad_gap(psdir, rank: int) -> tuple:
    """Worker ``rank``'s first packet against the one-process twin's
    gradients on its first batch, at the packet's base version: (base
    version, the largest gap over the largest gradient, bit for bit)."""
    from tpu_dist_torch.cluster.ps_transport import PSDir
    from tpu_dist_torch.models.bridge import keypath

    meta, arrays = PSDir.load_grad(psdir.grads / f"g-r{rank}-00000000.npz")
    model = _at_version(psdir, int(meta["base_version"]))
    dev = next(model.parameters()).device
    x, y = _ps_batches(rank)
    model.train()
    loss = model.loss(model(torch.from_numpy(x[:PS_BATCH]).to(dev)),
                      torch.from_numpy(y[:PS_BATCH]).to(dev))
    loss.backward()
    gap = top = 0.0
    same = True
    for name, p in model.named_parameters():
        got = torch.from_numpy(arrays[keypath(name)]).to(dev)
        gap = max(gap, float((got - p.grad).abs().max()))
        top = max(top, float(p.grad.abs().max()))
        same = same and torch.equal(got, p.grad)
    return int(meta["base_version"]), gap / top, same


def _ps_full_width(card: str, tmp: pathlib.Path) -> dict:
    """(a): a PSServer in this process and PS_WORKERS worker processes on
    the card, the gates, and the transport's times. Returns the launches
    a path: (flash fwd, flash bwd, Adam, CE fwd, CE bwd, SGD)."""
    from tpu_dist_torch.cluster.ps_transport import PSDir
    from tpu_dist_torch.parallel import ps_strategy
    from tpu_dist_torch.training import integrity

    root = tmp / "ps_lm"
    root.mkdir()
    psdir = PSDir(root / "ps")
    t0 = time.monotonic()
    procs = _spawn_ps_workers(root)
    try:
        model = _ps_lm()
        server = ps_strategy.PSServer(
            model, psdir, num_workers=PS_WORKERS, budget=PS_BUDGET, seed=0,
            retain_grads=True, idle_timeout_s=PS_TIMEOUT_S)
        _reset_counts()
        stats = server.run()
        server_counts = _counts()
        final = integrity.host_leaf_checksums(
            ps_strategy.tree_to_arrays(ps_strategy.params_tree(model)))
        for p in procs:
            if p.wait(timeout=PS_TIMEOUT_S) != 0:
                raise AssertionError(
                    f"(33 a) a PS worker exited {p.returncode}: "
                    f"{_tail(root / 'worker.log')}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.monotonic() - t0
    apply_ms = [t * 1e3 for t in server.apply_s]
    del server, model
    torch.cuda.empty_cache()
    workers = [json.loads((root / f"worker{r}.json").read_text())
               for r in range(PS_WORKERS)]
    if stats["applies"] != PS_BUDGET or stats["stop_reason"] != "budget":
        raise AssertionError(f"(33 a) server {stats}")
    # The server's Adam once an apply; a worker's step the flash pair
    # depth times and the CE pair once, nothing else.
    if server_counts != (0, 0, PS_BUDGET, 0, 0, 0):
        raise AssertionError(f"(33 a) server launches {server_counts}")
    for r, w in enumerate(workers):
        n = w["pushes"]
        want = [LM["depth"] * n, LM["depth"] * n, 0, n, n, 0]
        if n < 1 or w["counts"] != want:
            raise AssertionError(f"(33 a) worker {r}: launches "
                                 f"{w['counts']} for {n} pushes, expected "
                                 f"{want}")
    # The log replayed on a fresh model from seed 0: the server's final
    # checksums, bit for bit.
    _reset_counts()
    replayed = ps_strategy.replay_apply_log(psdir, _ps_lm(), seed=0)
    replay_counts = _counts()
    if replayed["applies"] != PS_BUDGET or replayed["checksums"] != final:
        bad = [k for k in final if final[k] != replayed["checksums"].get(k)]
        raise AssertionError(f"(33 a) the replay of {replayed['applies']} "
                             f"applies differs on {len(bad)} of "
                             f"{len(final)} leaves: {bad[:3]}")
    gaps = [_first_grad_gap(psdir, r) for r in range(PS_WORKERS)]
    for r, (version, rel, _) in enumerate(gaps):
        if rel > PS_GRAD_RTOL:
            raise AssertionError(f"(33 a) worker {r}'s first gradients "
                                 f"(base version {version}) are {rel:.2e} "
                                 "of the largest from the twin's")
    torch.cuda.empty_cache()
    push_mb = statistics.median(
        p.stat().st_size for p in psdir.grads.glob("g-r*.npz")) / 1e6
    log(f"[33 a] PS on the benchmark LM (21,269,504 parameters): a server "
        f"here and {PS_WORKERS} worker processes of {PS_BATCH} x "
        f"{LM['seq_len']}, staleness {PS_STALENESS}: {stats['applies']} "
        f"applies (by rank {stats['applied_by_rank']}), pushes "
        f"{[w['pushes'] for w in workers]}, losses "
        f"{[[round(v, 5) for v in w['loss']] for w in workers]}; launches "
        f"server {server_counts}, workers {[w['counts'] for w in workers]} "
        f"(flash fwd, flash bwd, Adam, CE fwd, CE bwd, SGD), replay "
        f"{replay_counts}; the replay's {len(final)} checksums equal the "
        f"server's; first gradients at base versions "
        f"{[g[0] for g in gaps]}: gap {[f'{g[1]:.2e}' for g in gaps]} of "
        f"the largest, bit for bit {[g[2] for g in gaps]}")
    log(f"[33 a] a push {push_mb:.2f} MB (npz + fsync): push s p50 "
        f"{[round(w['push_s']['p50'], 4) for w in workers]}, pull s p50 "
        f"{[round(w['pull_s']['p50'], 4) for w in workers]} (the wait for "
        f"the staleness window included); server apply (H2D and the Adam "
        f"kernel) {statistics.median(apply_ms):.3f} ms median "
        f"({min(apply_ms):.3f}-{max(apply_ms):.3f}); "
        f"{stats['throughput_sps']} applies/s over the apply span "
        f"{stats['apply_span_s']:.3f} s; wall {wall:.1f} s with the "
        f"workers' starts; {card}")
    return {f"ps_worker{r}": tuple(w["counts"])
            for r, w in enumerate(workers)} | {"ps_server": server_counts}


#: CLI runs started by an earlier phase than the one that reads them
#: (their process starts overlap that phase's), by label; stopped at exit
#: if still running.
_BACKGROUND: dict = {}


def _stop_background() -> None:
    for entry in _BACKGROUND.values():
        procs = entry[0]
        if isinstance(procs, tuple):  # _start_chaos's (processes, start)
            procs = procs[0]
        for proc in (procs.values() if isinstance(procs, dict)
                     else [procs]):
            if proc.poll() is None:
                proc.kill()


atexit.register(_stop_background)


def _start_cli(module: str, args: list, tmp: pathlib.Path,
               label: str) -> tuple:
    """Start ``python -m MODULE ARGS --workdir --report`` on the card as a
    subprocess; ``(process, start, tmp, label)``."""
    root = pathlib.Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if k not in _GUARD_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(root), os.environ.get("PYTHONPATH")]))
    with open(tmp / f"{label}.out", "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", module, *args, "--workdir",
             str(tmp / label), "--report", str(tmp / f"{label}.json")],
            cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, time.monotonic(), tmp, label


def _join_background(label: str) -> None:
    """Wait for a background CLI run (if one was started) to end, leaving
    its report for the phase that reads it: the next phase's gate times
    the host."""
    if label not in _BACKGROUND:
        return
    proc = _BACKGROUND[label][0]
    try:
        proc.wait(timeout=JOBS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()


def _finish_cli(started: tuple) -> tuple:
    """Wait for a :func:`_start_cli` run: (its report, its seconds from
    its start); a non-zero exit or a missing report raises."""
    proc, t0, tmp, label = started
    try:
        code = proc.wait(timeout=JOBS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"(33) {label} timed out: "
                             f"{_tail(tmp / f'{label}.out')}") from None
    seconds = time.monotonic() - t0
    report = tmp / f"{label}.json"
    if code != 0 or not report.exists():
        raise AssertionError(f"(33) {label} exited {code}: "
                             f"{_tail(tmp / f'{label}.out')}; report: "
                             f"{_tail(report, 8000)}")
    return json.loads(report.read_text()), seconds


def _cli_json(module: str, args: list, tmp: pathlib.Path,
              label: str) -> tuple:
    """:func:`_start_cli` and :func:`_finish_cli` back to back."""
    return _finish_cli(_start_cli(module, args, tmp, label))


def _ps_chaos(card: str, tmp: pathlib.Path) -> None:
    """(b): the chaos CLI's PS legs on the card (the demo CNN), in two
    runs: the straggler pair, whose gate compares two legs' throughput,
    alone; the synchronous control, kill-worker and server-kill legs
    (``PS_OTHERS_ARGS``, no gate of which reads a time closer than 2x)
    started before phase 22, ended before phase 26."""
    strag, s_s = _cli_json("tpu_dist_torch.resilience",
                           [*PS_CHAOS_ARGS, "--ps-legs", "straggler"], tmp,
                           "ps_chaos_straggler")
    started = _BACKGROUND.pop("ps_chaos_others", None) or _start_cli(
        "tpu_dist_torch.resilience", PS_OTHERS_ARGS, tmp, "ps_chaos_others")
    others, _ = _finish_cli(started)
    s, cfg = strag["straggler"], strag["config"]
    legs = {**others["legs"], **strag["legs"]}
    log(f"[33 b] --ps-chaos ({cfg['world']} workers, budget {cfg['budget']} "
        f"applies a leg): ok; straggler delay {s['delay_s']} s (9x the "
        f"clean step {s['clean_step_s']} s): async throughput ratio "
        f"{s['async_throughput_ratio']} (gate >= 0.9), alone in "
        f"{s_s:.1f} s; sync {others['straggler']['sync_throughput_ratio']} "
        f"(gate < 0.5), convergence {others['convergence']}; kill-worker: "
        f"restarts {legs['kill_worker']['server_restarts']}, exits "
        f"{legs['kill_worker']['worker_exit_codes']}, applies "
        f"{legs['kill_worker']['applies']}; server-kill: restarts "
        f"{legs['server_kill']['server_restarts']}, restored from "
        f"{legs['server_kill']['server_restores']}, applies "
        f"{legs['server_kill']['applies']} (these beside phases 22-25); "
        f"legs' applies/s "
        f"{ {k: v['throughput_sps'] for k, v in legs.items()} }, wall s "
        f"{ {k: v['wall_s'] for k, v in legs.items()} }; {card}")


def _jobs(card: str, tmp: pathlib.Path) -> dict:
    """(c): the jobs CLI's bench and chaos on the card. Returns the serve
    jobs' flash forward launches a path."""
    # Phase 29 starts it (its gate compares the packed and the serial
    # makespans, both inside the run), unless this phase runs alone.
    started = _BACKGROUND.pop("jobs_bench", None) or _start_cli(
        "tpu_dist_torch.jobs", JOBS_BENCH_ARGS, tmp, "jobs_bench")
    bench, b_s = _finish_cli(started)
    out = {}
    for side, jobs in (("serial", bench["serial"]["jobs"].values()),
                       ("packed", bench["packed"]["jobs"])):
        for j in jobs:
            res = j["result"]
            if j["kind"] == "serve":
                spec = next(s for s in bench["config"]["jobs"]
                            if s["name"] == j["name"])
                # One prefill a request, one block.
                if res["flash_fwd_launches"] != spec["requests"]:
                    raise AssertionError(f"(33 c) {side} {j['name']}: "
                                         f"flash launches {res}")
                out[f"jobs_{side}_{j['name']}"] = res["flash_fwd_launches"]
    log(f"[33 c] jobs --bench: packed makespan {bench['packed']['makespan_s']}"
        f" s against serial {bench['serial']['makespan_s']} s (ratio "
        f"{bench['packed_over_serial']}, gate <= "
        f"{bench['config']['gate_ratio']}); jobs "
        f"{[(j['name'], j['state'], j['duration_s']) for j in bench['packed']['jobs']]}"
        f"; serve jobs' flash launches {out}; run {b_s:.1f} s; {card}")
    # Phase 31 starts it (it has no timing gate; its process starts
    # overlap that phase's), unless this phase runs alone.
    started = _BACKGROUND.pop("jobs_chaos", None) or _start_cli(
        "tpu_dist_torch.jobs", JOBS_CHAOS_ARGS, tmp, "jobs_chaos")
    chaos, c_s = _finish_cli(started)
    for phase in ("kill", "abort"):
        p = chaos[phase]
        log(f"[33 c] jobs --chaos {phase}: faults fired by job "
            f"{p['faults_fired_by_job']}; jobs "
            f"{[(j['name'], j['state'], j['restarts'], j['classification']) for j in p['pool']['jobs']]}"
            f" (survivors at zero restarts and bit for bit with solo); "
            f"makespan {p['pool']['makespan_s']} s")
    log(f"[33 c] jobs --chaos: ok (solo baselines, kill, abort); run "
        f"{c_s:.1f} s; {card}")
    return out


def _leased_fleet(card: str) -> int:
    """(d): phase 27's fleet of two replicas with ``devices_per_replica=1``
    (each leases a slot of a MeshRuntime and runs under a job scope) against
    the same fleet without it: the same tokens (or certified ties).
    Returns the leased run's flash forward launches."""
    # On the card before the replicas' threads build their engines: two
    # threads moving one CPU model at once race.
    model = _serve_lm().cuda()
    work = _fleet_workload(16)
    _, plain, _, _ = _fleet_run(model, work, 2, passes=1)
    _reset_counts()
    fleet, leased, wall, _ = _fleet_run(model, work, 2, passes=1,
                                        devices_per_replica=1)
    launches = _counts()[0]
    keys = fleet._runtime.program_keys()
    if not keys or {k[0] for k in keys} != {"fleet-r0", "fleet-r1"}:
        raise AssertionError(f"(33 d) the runtime's programs: {keys}")
    ties = _ties(model, _as_reqs(leased), [fr.tokens for fr in plain],
                 "(33 d)")
    if launches != LM["depth"] * len(work):
        raise AssertionError(f"(33 d) flash launches {launches}")
    log(f"[33 d] a fleet of 2 replicas each leasing a MeshRuntime slot: "
        f"{len(work)} requests, tokens equal to the fleet without leases "
        f"({ties} certified ties), {len(keys)} captured programs in the "
        f"runtime's cache ({sorted({k[3] for k in keys})}), flash launches "
        f"{launches}, {wall:.2f} s; {card}")
    return launches


def jobs_phase(card: str) -> dict:
    """Phase 33: the parameter server at full width (a), its chaos legs
    (b), the jobs runtime's bench and chaos (c) and the leased fleet (d).
    Returns the launches a path."""
    t0 = time.monotonic()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-33-"))
    out = _ps_full_width(card, tmp)
    _ps_chaos(card, tmp)
    out.update(_jobs(card, tmp))
    out["fleet_leased"] = _leased_fleet(card)
    log(f"[33] done in {time.monotonic() - t0:.1f} s; {card}")
    return out


_PHASE_S: dict = {}


# -- phase 34: analysis on the card's machine --------------------------------------

#: (a): the four modes of the port's shardcheck over its own tree.
ANALYSIS_MODES = {
    "check": ["tpu_dist_torch/", "--fail-on", "error"],
    "concurrency": ["--concurrency", "--strict", "tpu_dist_torch/"],
    "determinism": ["--determinism", "--strict", "tpu_dist_torch/"],
    "cost": ["cost", "--baseline",
             "tpu_dist_torch/analysis/ANALYSIS_BASELINE.json"],
}
ANALYSIS_TIMEOUT_S = 300
#: (b): how far the recorded peak (plus what was allocated before the
#: step) may fall below ``max_memory_allocated``. The recorder sees every
#: tensor an op returns, not what an op allocates and frees inside itself
#: (cuBLAS/cuDNN workspaces, a reduction's scratch), and the allocator
#: rounds each block up to 512 bytes: a few MiB of workspace and ~512 B a
#: live tensor, well inside 8 MiB plus 1 % of the step's peak.
PEAK_TOL_BYTES, PEAK_TOL_FRAC = 8 << 20, 0.01
#: (c): phase 29 (a)'s rank-0 model-axis collectives a step, ``{(op,
#: shape, dtype): calls a step}`` (filled by :func:`tp_phase`).
_TP_RANK0_CALLS: dict = {}
#: (c): the recorder's c10d ops under ModelShard's names for them.
_C10D_AS_SHARD_OP = {"allreduce_": "all_reduce", "allgather_": "all_gather"}


def _start_analysis(tmp: pathlib.Path) -> dict:
    """(a): each mode as a subprocess (on the host's CPU, as the CLI
    records); ``{mode: (process, start, log path)}``."""
    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    started = {}
    for mode, args in ANALYSIS_MODES.items():
        path = tmp / f"analysis_{mode}.out"
        with open(path, "wb") as out:
            started[mode] = (subprocess.Popen(
                [sys.executable, "-m", "tpu_dist_torch.analysis", *args],
                cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT),
                time.monotonic(), path)
    _BACKGROUND["analysis"] = ({m: v[0] for m, v in started.items()},)
    return started


def _finish_analysis(started: dict, card: str) -> None:
    """(a): each mode's exit and its seconds from its start to its end."""
    ended: dict = {}
    while len(ended) < len(started):
        for mode, (proc, t0, _) in started.items():
            if mode not in ended and proc.poll() is not None:
                ended[mode] = (proc.returncode, time.monotonic() - t0)
            elif (mode not in ended
                  and time.monotonic() - t0 > ANALYSIS_TIMEOUT_S):
                proc.kill()
                ended[mode] = ("timeout", time.monotonic() - t0)
        time.sleep(0.05)
    for mode, (proc, t0, path) in started.items():
        code, seconds = ended[mode]
        tail = path.read_text(errors="replace").strip().splitlines()
        if code != 0:
            raise AssertionError(f"(34 a) {mode} exited {code}: "
                                 f"{tail[-20:]}")
        log(f"[34 a] python -m tpu_dist_torch.analysis "
            f"{' '.join(ANALYSIS_MODES[mode])}: exit 0 in {seconds:.1f} s "
            f"({tail[-1] if tail else ''}); {card}")
    _BACKGROUND.pop("analysis", None)


def _recorded_lm_step(card: str) -> None:
    """(b): the full-width LM's step recorded on the card against a
    twin's unrecorded step."""
    from tpu_dist_torch.analysis import costmodel
    from tpu_dist_torch.analysis.trace_checks import CollectiveRecorder

    x, y = _bench_tokens(TRAIN_BATCH)
    runs = {}
    for label in ("plain", "recorded"):
        model = _compiled_lm(Adam(fused=True), fused_ce=True)
        fn, st = model.make_train_function(), model.train_state()
        fn(*st, x, y)  # the warm step: leaf tables, cuBLAS handles
        torch.cuda.synchronize()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        if label == "recorded":
            with CollectiveRecorder("cuda") as rec:
                loss = fn(*st, x, y)
                torch.cuda.synchronize()
        else:
            loss = fn(*st, x, y)
            torch.cuda.synchronize()
        runs[label] = {
            "loss": loss.clone(), "counts": _counts(),
            "peak": torch.cuda.max_memory_allocated(), "before": before,
            "params": [p.detach().clone() for p in model.parameters()]}
        if label == "recorded":
            runs[label]["rec"] = rec.recording
        del model, fn, st, loss
        torch.cuda.empty_cache()
    plain, got = runs["plain"], runs["recorded"]
    if not (torch.equal(plain["loss"], got["loss"])
            and all(torch.equal(a, b) for a, b in zip(plain["params"],
                                                      got["params"]))):
        raise AssertionError("(34 b) the recorded step's loss or parameters "
                             "differ from the unrecorded twin's")
    want = (LM["depth"], LM["depth"], 1, 1, 1, 0)
    if plain["counts"] != got["counts"] or got["counts"] != want:
        raise AssertionError(f"(34 b) launches recorded {got['counts']}, "
                             f"unrecorded {plain['counts']}, want {want}")
    rec = got["rec"]
    modeled = got["before"] + costmodel.peak_live_bytes(rec)
    card_peak = got["peak"]
    tol = PEAK_TOL_BYTES + PEAK_TOL_FRAC * card_peak
    if modeled < card_peak - tol:
        raise AssertionError(
            f"(34 b) recorded peak {modeled} B falls {card_peak - modeled} "
            f"B below max_memory_allocated {card_peak} B (tolerance "
            f"{tol:.0f} B)")
    log(f"[34 b] the LM step ({TRAIN_BATCH} x {LM['seq_len']}, fp32, "
        f"Adam(fused=True), fused CE) recorded on the card: loss "
        f"{float(got['loss']):.6f} and {len(got['params'])} parameters bit "
        f"for bit with the unrecorded twin's, launches {got['counts']} both; "
        f"recorded peak of live tensors {costmodel.peak_live_bytes(rec)} B "
        f"+ allocated before the step {got['before']} B = {modeled} B "
        f"against max_memory_allocated {card_peak} B ({modeled / card_peak:.4f}"
        f"x; unrecorded twin's {plain['peak']} B); {len(rec.events)} events "
        f"({len(rec.comm_events())} collective), random ops "
        f"{rec.random_ops()}, {rec.flops / 1e12:.3f} TFLOP modeled; {card}")


def _recorded_tp_step(card: str) -> None:
    """(c): phase 29's tensor-parallel step on a two-rank fake group on
    the card."""
    from tpu_dist_torch.analysis import costmodel, trace_checks

    x, y = _bench_tokens(TP_BATCH)
    recs = {}
    for rank in range(2):
        with trace_checks.fake_group(rank, 2, device=torch.device(
                "cuda", torch.cuda.current_device())):
            strategy = MultiWorkerMirroredStrategy(communication="ring",
                                                   axis_shapes=TP_AXES)
            with strategy.scope():
                model = _compiled_lm(Adam(ADAM_LR, fused=True),
                                     fused_ce=True)
            fn, st = model.make_train_function(), model.train_state()
            recs[rank] = trace_checks.record(
                lambda: fn(*st, x, y), device="cuda",
                axis_of=trace_checks.axis_map(TP_AXES), rank=rank, world=2)
            torch.cuda.synchronize()
            del model, fn, st, strategy
        torch.cuda.empty_cache()
    findings = trace_checks.check_trace({0: recs},
                                        label="phase 29's TP step")
    if findings:
        raise AssertionError(f"(34 c) {[f.render() for f in findings]}")
    got = {}
    for (op, shape, dtype), n in recs[0].collective_counts().items():
        key = (_C10D_AS_SHARD_OP.get(op, op), shape, f"torch.{dtype}")
        got[key] = got.get(key, 0) + n
    if not _TP_RANK0_CALLS or got != _TP_RANK0_CALLS:
        raise AssertionError(f"(34 c) recorded collectives a step {got}; "
                             f"phase 29 (a)'s rank 0 {_TP_RANK0_CALLS}")
    report = costmodel.analyze_trace(recs[0], entry="tp_step")
    log(f"[34 c] phase 29's step ({TP_AXES}, {TP_BATCH} x {LM['seq_len']}) "
        f"recorded on a two-rank fake group on the card: collectives a "
        f"step {sorted(got.items())} equal phase 29 (a)'s rank 0's; modeled "
        f"comm {report.total_comm_bytes} B a step "
        f"({report.total_comm_bytes / 2**20:.3f} MiB), recorded peak "
        f"{report.peak_hbm_bytes} B; {card}")


def analysis_phase(card: str) -> None:
    """Phase 34: (a) the CLI's four modes beside (b) and (c)."""
    t0 = time.monotonic()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-34-"))
    started = _start_analysis(tmp)
    _recorded_lm_step(card)
    _recorded_tp_step(card)
    _finish_analysis(started, card)
    log(f"[34] done in {time.monotonic() - t0:.1f} s")


def _timed(name: str, fn, *args):
    """``fn(*args)``, its seconds logged and kept under ``name``."""
    t0 = time.monotonic()
    out = fn(*args)
    _PHASE_S[name] = round(time.monotonic() - t0, 1)
    log(f"[time] phase {name}: {_PHASE_S[name]} s")
    return out


def main() -> int:
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--file-worker"]:
        return file_worker(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--observe-worker"]:
        return observe_worker(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-worker"]:
        return tp_worker(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--pp-worker"]:
        return pp_worker(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--elastic-worker"]:
        return elastic_worker(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--ps-worker"]:
        return ps_worker(pathlib.Path(sys.argv[2]), int(sys.argv[3]))
    t0 = time.monotonic()
    card = device_phase()
    build_phase()
    max_abs_err = _timed("3", kernel_check_phase)
    launches, contiguous_streams = _timed("4", serve_phase)
    _timed("5", cli_phase)
    record = _timed("6", timing_phase, launches, max_abs_err)
    bwd_err = _timed("7", bwd_check_phase)
    adam_err, _ = _timed("8", adam_check_phase)
    train_launches = _timed("9", train_phase)
    record["launches_by_path"] = {"serve": launches,
                                  "train": train_launches["fwd"]}
    _timed("10", fit_phase)
    bwd_records, fwd_train_err, fwd_train = _timed(
        "11-12", bwd_timing_phase, train_launches["bwd"], bwd_err)
    record["train_shape"] = {"shape": [TRAIN_BATCH * LM["num_heads"],
                                       LM["seq_len"], 64], **fwd_train}
    # The forward runs at the serving shapes (phase 3) and the training
    # shape: its error is the larger of the two.
    record["max_abs_err"] = max(record["max_abs_err"], fwd_train_err)
    adam_record = _timed("11 adam", adam_timing_phase,
                         train_launches["adam"], adam_err)
    sgd_step_ms = _timed("11 step", step_timing_phase)
    ce_errs = _timed("12 ce", ce_check_phase)
    sgd_errs = _timed("13", sgd_check_phase)
    _timed("14", program_phase)
    slice3 = {"cnn": _timed("15 cnn", cnn_fused_phase),
              "lm": _timed("16", lm_fused_phase)}
    new_records = _timed("17", slice3_timing_phase, slice3, ce_errs,
                         sgd_errs, sgd_step_ms)
    paged = _timed("18", paged_phase, card, contiguous_streams)
    _timed("18 cli", paged_cli_phase)
    _timed("19", graph_serve_phase, card, paged)
    _timed("20", graph_train_phase, card, slice3["cnn"]["k1"])
    _timed("21", data_phase, card)
    # Phase 33 (b)'s synchronous control, kill-worker and server-kill legs
    # run beside phases 22-25: no gate of theirs reads a time closer than
    # 2x, and none of those phases gates on one. Phase 26 sizes a stall
    # timeout from a worker's steps: it waits for them.
    _BACKGROUND["ps_chaos_others"] = _start_cli(
        "tpu_dist_torch.resilience", PS_OTHERS_ARGS,
        pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-33-")),
        "ps_chaos_others")
    resnets = _timed("22", resnet_phase, card)
    resumed = _timed("23", resume_phase, card, contiguous_streams)
    # Rows 1-3 launch on the ResNets' fit too (the counts of phase 22 (a)),
    # and row 3 runs at their leaf tables.
    for rec, index in zip(new_records[:3], (3, 4, 5)):
        for name, counts in resnets["launches"].items():
            rec["launches_by_path"][f"{name}_fit"] = counts[index]
    for name, t in resnets["sgd"].items():
        new_records[2][f"{name}_shape"] = {k: t[k] for k in (
            "n", "leaves", "ms", "host_us", "kernel_alone_ms", "update_ms",
            "plain_ms", "library_ms", "builds")} | {"bound_ms": t["bound"][0]}
    # Phase 23's paths: the resumed ResNet-18 fit launches rows 1, 2 and 4
    # (momentum), the resumed LM fit rows 5-9, serving from the saved
    # directory row 6. Counts: (flash fwd, flash bwd, Adam, CE fwd, CE bwd,
    # SGD).
    res, lm = resumed["resnet18"], resumed["lm"]
    for rec, count in zip(new_records, (res[3], res[4], 0, res[5])):
        rec["launches_by_path"]["resnet18_resumed"] = count
    adam_record.setdefault("launches_by_path", {})["lm_resumed"] = lm[2]
    record["launches_by_path"]["lm_resumed"] = lm[0]
    record["launches_by_path"]["serve_from_saved"] = \
        resumed["serve_from_saved"]
    for rec in bwd_records:
        rec.setdefault("launches_by_path", {})["lm_resumed"] = lm[1]
    # Phase 24's paths: each worker's bucketed and default ResNet-18 fits
    # launch rows 1-3; the profiled LM fit rows 6-9.
    dp = _timed("24", dp_phase, card)
    profiled = _timed("24 c", profile_phase, card, sgd_step_ms)
    for rec, index in zip(new_records[:3], (3, 4, 5)):
        for label, counts in dp.items():
            rec["launches_by_path"][f"resnet18_two_workers_{label}"] = \
                counts[index]
    record["launches_by_path"]["lm_profiled"] = profiled["fwd"]
    for rec in bwd_records:
        rec["launches_by_path"]["lm_profiled"] = profiled["bwd"]
    # Phase 25's path: each worker's FILE-sharded fit launches rows 1-3;
    # phase 26's resilient serving row 6.
    files = _timed("25", file_phase, card)
    for i, rec in enumerate(new_records[:3]):
        for rank, counts in enumerate(files):
            rec["launches_by_path"][f"mnist_file_sharded_worker{rank}"] = \
                counts[i]
    _join_background("ps_chaos_others")
    record["launches_by_path"].update(_timed(
        "26", resilience_phase, card, contiguous_streams))
    # Phase 27's paths launch row 6 (the contiguous replicas' prefills);
    # phase 28's rows 1-3 (the fused CNN fits, each rank's fit) and 5-9
    # (the LM fit), each beside the same fit without Telemetry.
    record["launches_by_path"].update(_timed("27", fleet_phase, card))
    observed = _timed("28", observe_phase, card)
    for label in ("cnn_fit_telemetry_k1", "cnn_fit_telemetry_k20",
                  "observe_rank0", "observe_rank1"):
        for rec, count in zip(new_records[:3], observed[label][3:]):
            rec["launches_by_path"][label] = count
    lm_counts = observed["lm_fit_telemetry"]
    record["launches_by_path"]["lm_fit_telemetry"] = lm_counts[0]
    adam_record["launches_by_path"]["lm_fit_telemetry"] = lm_counts[2]
    for rec in bwd_records:
        rec["launches_by_path"]["lm_fit_telemetry"] = lm_counts[1]
    # Phase 29's paths: each rank's tensor-parallel LM (fp32 and bf16)
    # launches rows 1-2, 5 and 6-9; the ring LM rows 1-2 and 5.
    # Phase 33 (c)'s `jobs --bench` runs beside phases 29-30: no gate of
    # theirs reads a time, and the bench's compares the packed and serial
    # makespans, both inside its own run.
    _BACKGROUND["jobs_bench"] = _start_cli(
        "tpu_dist_torch.jobs", JOBS_BENCH_ARGS,
        pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-33-")), "jobs_bench")
    for label, counts in _timed("29", tp_phase, card).items():
        for rec, count in zip(new_records[:2], counts[3:5]):
            rec["launches_by_path"][label] = count
        adam_record["launches_by_path"][label] = counts[2]
        record["launches_by_path"][label] = counts[0]
        for rec in bwd_records:
            rec["launches_by_path"][label] = counts[1]
    # Phase 30's paths: each rank's GPipe and MoE fits launch rows 1-2, 5
    # and 6-9; the 1F1B loop rows 3 and 6-9, and rows 1-2 on the last
    # stage.
    for label, counts in _timed("30", pp_phase, card).items():
        for rec, count in zip(new_records[:3], (*counts[3:5], counts[5])):
            rec["launches_by_path"][label] = count
        adam_record["launches_by_path"][label] = counts[2]
        record["launches_by_path"][label] = counts[0]
        for rec in bwd_records:
            rec["launches_by_path"][label] = counts[1]
    # Phase 31's paths: (f)'s armed fused-CE fits launch rows 1-2, 5 and
    # 6-9; its rolled-back plain-CE fits rows 5 and 6-9, the replayed epoch
    # included.
    for label, counts in _timed("31", train_chaos_phase, card).items():
        for rec, count in zip(new_records[:2], counts[3:5]):
            rec["launches_by_path"][label] = count
        adam_record["launches_by_path"][label] = counts[2]
        record["launches_by_path"][label] = counts[0]
        for rec in bwd_records:
            rec["launches_by_path"][label] = counts[1]
    # Phase 32's paths: each rank's sharded-checkpointed LM fit under
    # {data: 1, model: 2} launches rows 1-2, 5 and 6-9.
    for label, counts in _timed("32", elastic_phase, card).items():
        for rec, count in zip(new_records[:2], counts[3:5]):
            rec["launches_by_path"][label] = count
        adam_record["launches_by_path"][label] = counts[2]
        record["launches_by_path"][label] = counts[0]
        for rec in bwd_records:
            rec["launches_by_path"][label] = counts[1]
    # Phase 33's paths: each PS worker's step launches rows 1-2 and 6-9,
    # the PS server row 5; the serve jobs and the leased fleet row 6.
    for label, counts in _timed("33", jobs_phase, card).items():
        if isinstance(counts, int):
            record["launches_by_path"][label] = counts
            continue
        for rec, count in zip(new_records[:2], counts[3:5]):
            rec["launches_by_path"][label] = count
        adam_record["launches_by_path"][label] = counts[2]
        record["launches_by_path"][label] = counts[0]
        for rec in bwd_records:
            rec["launches_by_path"][label] = counts[1]
    _timed("34", analysis_phase, card)
    # In the order of the TPU kernel table (PERF.md): rows 1-9.
    records = [*new_records, adam_record, record, *bwd_records]
    log(f"[time] phases (s): {json.dumps(_PHASE_S)}")
    log(f"done in {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
