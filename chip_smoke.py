#!/usr/bin/env python3
"""Run the PyTorch port's batch FAST detection, streaming detection,
offline Min-Max LSH search, LM serving (every LM family), detection
serving, detector snapshots, elastic pool membership, the location /
magnitude tier, LM training (every family), the one-chunk
``detect_step``, the station-sharded pool and ``detect_step_sharded``
over logical meshes of the one card, LM training and serving under a
mesh with one NCCL rank, and the model axis's split, on one NVIDIA GPU,
end to end.

    python3 chip_smoke.py

Phases (each fails loudly; the script exits non-zero on any mismatch):

1. Builds the CUDA kernels from ``src/repro_torch/csrc/`` with
   ``nvcc`` for ``sm_90a`` (one compiler process per source, in parallel)
   and prints the card's name and power limit.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes one paper-scale block gives it (4 stations × 256 fingerprints):
   Min-Max signatures/buckets and Jaccard bit-exact (empty rows and empty
   unions included), STFT and Haar within rtol 1e-5, atol 1e-5·max|x|.
   Times kernel, plain version and, where one PyTorch call computes the
   same function, that call (CUDA events, median of 30 launches, each
   behind a ~0.5 ms device busy wait so that the events time the device's
   work and not the host's dispatch). The Min-Max bounds count 2 · nnz · H
   comparisons at the DPX rate (``cost.MINMAX_COMPARES_PER_S``), and a
   ``minmax_sig_buckets_rate`` line gives the plan that ran and the bytes
   it reads from L2 by its design over its time (arithmetic, not traced).
   The replay's shapes that take the row kernel (one station's block; a
   block of the smoke config, D 1024, H 40, f 2) are held bit-exact too,
   and the kernels line names each shape's plan. ``jaccard_popcount``
   scores 4 × 4096 slots all valid over the paper ring (ids not reduced
   modulo the ring), on both plans (16-byte loads; 4-byte words on a copy
   of the ring 4 bytes off 16), each bit-exact, timed warm and cold (an
   L2 flush of ``L2_FLUSH_BYTES`` before each busy wait, outside the
   events), with a ``jaccard_popcount_rate`` line; its bound counts the
   valid pairs' distinct rows once and 2 POPC a word at
   ``cost.POPC_OPS_PER_S``.
3. The port's ``detect_events`` on the batch golden dataset (regenerated
   from the seed in ``tests/golden/batch_detect.json``): the golden's
   stats, per-station pair triplets, 9 detections and recall 1.0, exactly.
4. The paper widths on a 20-minute trace, on the card and on the CPU: the
   stats and pair triplets must be equal (the CPU path is held to the JAX
   package on this trace by ``tests/test_torch_paper_widths.py``).
5. The paper configuration (``fast_seismic.config()`` widths) on 4
   stations × 24 h of synthetic 100 Hz data, with launch counters zeroed
   just before and read just after: stage wall times, fingerprints per
   second, detections, recall, peak memory and each kernel's launches
   (each must be at least the number of blocks), and each station's
   pairs emitted. Then ``jaccard_popcount`` at the replay's real shape:
   4 × 4096 slots, station s valid on a prefix as long as its pairs
   emitted over the whole replay (capped at 4096), garbage ids behind
   it; both plans bit-exact, warm and cold, with its own rate line.
6. The stream golden: ``StreamingDetector`` on the card runs the golden
   test's four runs on ``tests/golden/stream_pairs.json``'s trace — two-pass
   statistics (computed on the CPU), the deferred freeze and compact +
   verify each reproduce ``stream_two_pass_pairs`` exactly with no
   overflow; self-computed statistics give the port's CPU pair set — then
   the bounded 3-station smoke stream (sliding window, rolling filter,
   live association), whose alerts, detections and events must equal the
   port's CPU path.
7. The paper streaming service on phase 5's data: ``fast_seismic.config()``
   with ``stream_config()``, 4 stations pooled, pushed in 60 s chunks
   (``STREAM_CHUNK``, 1,440 pushes), statistics from the reservoir, launch
   counters zeroed just before and read just after (each of the four
   kernels at least once per pooled block): real-time factor,
   fingerprints per second, push wall p50 / p99, the ``ingest``,
   ``dup_hash`` (the sample-exact duplicate guard's hashing, host side),
   ``fused_step`` and ``host_tail`` span totals, peak memory, per-station
   pairs and events, alerts, detections and the drop breakdown.
8. The same data in parity mode (``stream_config()`` with
   ``filter_window_fingerprints=0``), given the statistics
   ``detect_events`` computes: per-station post-filter pair triplets and
   events equal ``detect_events``' on the same ``StreamConfig`` (one
   detection core, two drivers; the stream takes the advance route).
9. The offline golden: ``core.lsh.search`` on the card reproduces the 17
   ``offline_pairs`` of ``tests/golden/stream_pairs.json``, and
   ``data.dedup.find_duplicates`` on the card equals the port's CPU path.
10. The offline search at the paper widths on the 20-minute trace of phase
    4, card against the port's CPU path: packed fingerprints, pair arrays,
    stats and Jaccard values equal.
11. The offline search on phase 5's 4 stations × 24 h: per station
    fingerprints, ``search`` and ``verify_jaccard`` of the valid pairs, and
    ``partitioned_search`` (4 partitions) on station 0, with launch counters
    zeroed just before and read just after (``minmax_hash`` at least once
    per search, ``occurrence_filter`` once per ``search``,
    ``jaccard_popcount`` once per verify): stage wall
    times, fingerprints per second, pairs before and after the filter,
    ``max_bucket``, peak memory, then a synced stage breakdown of station 0.
12. ``minmax_hash`` against its plain version at station 0's shape (N =
    43,184 rows, 256 words, H = 400, some rows zeroed) and at the MinHash
    baseline's H = 800, bit-exact, timed and bounded, with a
    ``minmax_hash_rate`` line for each; bit-exact also at the row kernel's
    shapes of the offline path (the offline golden's station, D 1024,
    H 40; corpus dedup's 24 × 1024 × 64). Then ``occurrence_filter`` at
    station 0's candidate stream (t · cap · N = 17.3 M slots): kernel,
    flags, sim and excluded mask bit-exact against its plain version,
    timed beside its bound, the plain version and the four library
    scatters it replaced (``library_ms``).
13. The LM kernels against their plain versions on the card, timed and
    bounded: ``flash_attention`` at qwen2.5-14b's prefill shape (B = 1,
    40 / 8 heads, 2048 × 2048, D = 128, bf16, causal), plus Sq < Sk, a
    ragged 1000 × 1000 and an fp32 case, and at the other families'
    2048-token prefills (heads / kv heads / D: yi-9b 32 / 4 / 128,
    codeqwen1.5-7b 32 / 32 / 128, command-r-35b 64 / 8 / 128, the two MoE
    16 / 16 / 128, musicgen-large and zamba2-1.2b 32 / 32 / 64,
    internvl2-1b 14 / 2 / 64) and at command-r-35b-smoke's head dim 16
    (``D16_CASES``: 8 / 2 heads, 2048 × 2048, bf16 and fp32);
    ``mamba_scan`` at falcon-mamba-7b's (B = 1, S = 2048, Di = 8192,
    N = 16, fp32).
    Tolerance max abs err ≤ 5e-5·max|plain| in fp32 (summation order, the
    online-softmax rescale) and ≤ 2⁻⁷·max|plain| for a bf16 output (one
    rounding of the output, P rounded to bf16 before P·V). Prints each
    case's achieved TFLOP/s (``flash_attention_rate``), as phase 2 prints
    ``stft_mag``'s and ``haar2d``'s GFLOP/s (``stft_mag_rate``,
    ``haar2d_rate``). ``mamba_scan``'s bound counts its exponentials on
    the SFU (16 a clock an SM) beside its bytes and fp32 operations.
14. LM parity: ``ServeEngine`` on the card against the port's CPU path on
    the fp32 variants of the default smoke model and the ten LM archs'
    smoke configs as they are (command-r-35b-smoke's head dim 16 runs the
    D = 16 kernels), same parameters, 4 requests: equal token lists,
    prefill logits within 1e-4·max|logit| (internvl2-1b's also on a
    prompt with ``patch_embeds``), and for the two MoE archs the
    prefills' routed expert ids equal; launch counters zeroed before the
    card's run and read after it (each config's kernel launched).
15. LM serving at full width: every LM arch's ``config()`` with every
    width unchanged, ``n_layers`` cut to 4 but for zamba2-1.2b (38
    layers: 6 shared-attention groups and a tail of 2) and internvl2-1b
    (24), which run whole (``LM_SERVE_MODELS``), bf16 parameters made on
    the card by ``init_params`` (seed 0), ``ServeEngine(n_slots=4,
    max_len=2560)`` answering 8 requests (prompts of 512–2048 tokens, 32
    new tokens each) after a warm-up run of the same prompts, launch
    counters zeroed just before and read just after: ``mamba_scan``
    (falcon-mamba) exactly once per layer per request, ``flash_attention``
    once per attention layer per request (zamba2: per shared block, 6 ×
    8). Tokens/s, prefill and decode walls, peak memory, parameter bytes,
    and for the MoE archs the share of the prefills' routed (token, slot)
    pairs that capacity dropped.
16. Detection serving at full width over phase 7's pool (4 stations ×
    24 h, taken through ``pool_serving_state()``), ``serve_config()`` (32
    slots, queue 1,024, top-k 64): 64 request windows of 60 s starting on
    corpus fingerprints, submitted at once, then 1,100 more at once (76
    shed), launch counters zeroed just before and read just after
    (``stft_mag``, ``haar2d`` and ``minmax_hash`` exactly once a
    dispatched tick, none on an idle tick): requests per second, latency
    p50 / p95 / p99, queue wait and service p50 / p99, served, shed,
    hits, and the share of query fingerprints that find their own source
    fingerprint in their station's top-k (at least 0.9). The CPU path on a
    copy of the same state gives equal (station, id, sim) lists for the
    first tick's 32 requests. The first tick's live work is printed
    (``first_tick_live``: valid query fingerprints a slot of 256, raw
    collisions and thresholded candidates a (station, slot) row). At the
    serving batch's shapes, ``stft_mag`` (32 blocks) and ``haar2d`` are
    held against their plain versions at the kernel tolerance and
    ``minmax_hash`` (4 × 32 × 256 rows, 256 words, H = 400, the tiled
    plan) bit-exact against its plain version, each timed and bounded
    (``serving_shapes``; ``minmax_hash_serve_rate``).
17. Snapshots: phase 7's stream again to push 720, ``snapshot`` into a
    temporary directory (bytes on disk, write time), ``restore`` into a
    new detector on the card (restore time), pushes 721–1,440: per-station
    stats, events, alerts, detections and drops equal phase 7's
    uninterrupted run.
18. Elastic membership at full width: phase 17's snapshot restored again,
    ``add_station()`` (a fifth station at the frontier, seeded noise), 60
    pushes to all five, ``remove_station(4)``, the rest of the stream,
    launch counters zeroed just before and read just after: stations
    0–3's per-station stats and events and the detections equal phase 7's
    record; the two re-pack walls. The snapshot directory is then deleted.
19. The located batch scenario at the paper's location width
    (``locate_config()``) on ``tests/golden/located_scenario.json``'s
    6-station, 600 s network (written from the JAX reference by
    ``tools/located_golden.py``): clean, pairwise and gated runs of
    ``detect_events``, launch counters around the three; every associated
    group's integer columns (``dt``, ``onset``, ``n_stations``, ``valid``,
    ``n_used``, ``consistent``) exact, origins within one finest cell
    (``cell_km``, + 1e-4 km of float32 spacing), magnitudes within 1e-5,
    the summary counts equal and the median origin error within 0.01 km;
    the three walls and the migration stack's share of each.
20. The location stack at scale: ``locate_groups`` with ``locate_config()``
    on 4,096 groups × 16 stations (onsets from known origins, a quarter of
    the stations absent), card against the CPU (origins within one finest
    cell, ``n_used`` and ``consistent`` equal), timed on the card.
21. The located stream: ``located_smoke_config()`` with
    ``stream_bounded_smoke_config()`` on a 4-station, 900 s, seed-11
    ``physical_geometry`` trace in 6,000-sample pushes: card = the port's
    CPU path (alert rows exact but for ±1 milli-km in the location
    columns, detections within 1e-4), launch counters around the card's
    run; then snapshotted halfway, restored on the card and finished:
    amplitude timelines and result equal to the uninterrupted run.
22. ``serve_detect.main(["--locate", ...])`` on the card and the CPU: the
    RESULT's ``located`` block and the ``ALERT`` rows equal, launch
    counters around the card's run.
23. One paper block with ``time_domain_bandpass=True``: the card's
    spectrogram within the kernel tolerance of the CPU's, the bits
    (the CPU's statistics on both) agreeing on ≥ 99.9%.
24. The backward kernels against their plain versions (``plain_bwd``),
    each launched twice and bitwise equal, timed and bounded:
    ``flash_attention_bwd`` at qwen2.5-14b's training shape (B = 1, 40 / 8
    heads, 2048², D = 128, bf16, causal, on the forward kernel's own
    output and log-sum-exp, which are first held to ``plain_with_lse``'s:
    the output as phase 13's, the log-sum-exp within 1e-3 absolute), an
    fp32 case at S = 512 and phase 26's other attention microbatches in
    bf16 (deepseek-moe-16b 1 × 16 / 16, D 128; zamba2-1.2b 2 × 32 / 32,
    D 64; internvl2-1b 2 × 14 / 2, D 64) and ``D16_CASES`` (1 × 8 / 2,
    D 16, bf16 and fp32), its bound 10·D flops an
    allowed q–k pair at the tensor (or fp32) rate and its library column
    the backward of
    ``scaled_dot_product_attention`` on the same tensors;
    ``mamba_scan_bwd`` at the training path's microbatch of
    falcon-mamba-7b (B = 2, S = 2048, Di = 8192, N = 16, fp32: the scan
    dtype of training), and at B = 1 in fp32 and bf16, on the chunk
    states of ``mamba_scan_chunks``, whose y and h_final are first held to
    the plain forward's; its bound the larger of its bytes and one
    exponential an element on the SFU. Tolerances as phase 13's. Each
    case's ``lm_bwd_split`` line gives the device time of every kernel one
    call launches, from CUDA events the C entry records between them
    (flash: ``prep``, ``dkdv``, ``combine`` (0 where the walk is not
    split), ``dq``; scan: ``main``, ``sum_dbdc``, ``sum_da``), beside the
    achieved TFLOP/s (flash, 10·D flops a pair) or GB/s (scan, the bytes
    of its bound). Then
    the embedding lookup's backward at qwen2.5-14b's table and 2,048
    tokens, ``F.embedding`` (the port's) against the indexing's
    ``index_put_``, timed, and ``F.embedding``'s gradient bitwise
    repeatable (the launcher's resume relies on it).
25. Training parity: on the fp32 smoke config of every LM arch and the
    launcher's smoke model (``_lm_smoke_configs()``, command-r-35b-smoke
    at head dim 16; remat "block"; internvl2-1b's batches
    with seeded ``patch_embeds``), the card's ``lm_loss`` and gradients
    and three ``make_train_step`` steps in each ``accum_mode`` against
    the port's CPU path from the same parameters and batches (loss 1e-5
    relative, gradients 2e-5 of each leaf's max, grad norm 1e-4
    relative; parameters within lr (3e-4) at most and 1e-6 in RMS: an
    element whose gradient sits at its rounding noise moves by up to ~lr
    in AdamW's first steps); the MoE archs' routed expert ids equal in
    every routing; a layer's kernel launches twice (forward and the remat
    recompute) and its backward kernel once, the hybrid's shared
    attention block (outside the checkpointed stack, as in the
    reference) its forward once.
26. Training at full width, ``LM_TRAIN``: qwen2.5-14b, falcon-mamba-7b
    and deepseek-moe-16b with ``n_layers`` cut to 4, zamba2-1.2b (38)
    and internvl2-1b (24, with seeded bf16 ``patch_embeds`` of (B, 256,
    896) on every batch) whole, bf16 parameters from
    ``init_train_state`` (seed 0), ``make_train_step`` with remat
    "block", fp32 accumulation and the global batch (2 or 4 sequences of
    2,048 tokens) in 2 microbatches, on ``TokenPipeline`` batches (dedup
    on the card); one warm-up step, then 4 timed steps with launch
    counters zeroed just before and read just after, each kernel's count
    exactly phase 25's rule × microbatches × steps. Step walls, tokens/s,
    the AdamW update alone (``apply_updates`` on the trained state) and
    its share of the step, peak memory, parameter count, parameter and
    optimizer bytes (``utils.tree_bytes``), the losses. command-r-35b does
    not fit one card at its widths and trains at its smoke config only.
27. Resume: ``python -m repro_torch.launch.train --device cuda`` for 8
    steps with ``--arch smoke``, ``--arch deepseek-moe-16b --smoke`` and
    ``--arch zamba2-1.2b --smoke``, each again with
    ``--inject-failure-at 5`` (exit 42 before step 5's checkpoint), then
    ``--resume``: the final checkpoint's every leaf and the final loss
    equal the uninterrupted run's bit for bit (the three archs' runs side
    by side).
28. MoE repeatability: deepseek-moe-16b's bf16 smoke config, gradients
    twice and a train step from two copies of one state, every leaf
    equal, and the warnings of PyTorch's deterministic mode on that step
    (reported); at full width (4 layers, seq 2048) one microbatch's gradients
    twice, equal, and a 2-microbatch train step twice from the seeded
    state, every leaf's digest (the int64 sums of its bit patterns, plain
    and weighted by position) equal.
29. ``core.detect.detect_step`` at the paper widths on each station of
    phase 4's 20-minute trace as one chunk (the CPU's statistics at rate
    1.0): every output equal to the CPU path's, launch counters zeroed
    just before and read just after (``stft_mag``, ``haar2d``,
    ``minmax_sig_buckets`` and ``occurrence_filter`` once a call), the
    card's walls.
30. The station-sharded pool (``StreamingDetector(devices=...)``) over
    logical meshes of the one card, ``[cuda:0] × width``: the shards run
    one after another on the card, so this holds the split to the
    one-device answers and counts its launches; it does not measure
    multi-card scaling. (a) Phase 7's stream under a 2-wide mesh (no pad
    row) and a 3-wide one (``SHARDED_WIDTHS``; two pad rows): each record
    equal to phase 7's, each of the four kernels launched at least once a
    shard a block, ``memory_allocated`` equal before the steady pushes
    ``SHARDED_MEMORY_PUSHES`` (ten apart), walls, spans (``fused_step``
    beside phase 7's), memory before and at peak, launches; the 3-wide
    pool is snapshotted after push 720. (c) That snapshot restored with no
    mesh and under the 2-wide mesh, each finished equal to phase 7's
    record. (b) Phase 18's join and leave over it under the 3-wide mesh
    (``sharded_elastic``: the pool padded 5 → 6, then 4 → 6), stations
    0–3 equal to phase 7's. (d) ``core.detect.detect_step_sharded`` at
    ``SHAPES["station_month"]`` (512 chunks × 512,000 samples of a seeded
    one-station synthetic month) at the paper widths under a 2-wide mesh,
    ``DETECT_SHARDED_GROUP`` chunks a pooled call, launch counters
    zeroed just before and read just after (``stft_mag``, ``haar2d``,
    ``minmax_sig_buckets`` once a call, ``occurrence_filter`` once a
    chunk): wall, chunks and fingerprints a
    second, ``model_flops`` over the wall beside the fp32 peak, memory;
    eight seeded chunks equal the CPU path's ``detect_step`` on each
    alone, exactly (the kernels' plain versions at this path's shapes).
31. Multi-device LM training through ``torch.distributed`` with one NCCL
    rank on the card (``dist.init_ranks``, a free local port). (a)
    qwen2.5-14b at phase 26's cell (4 layers, bf16, seq 2048, its
    initial state and ``TokenPipeline`` batches, 2 microbatches, remat
    "block"): two steps with no mesh, then from the same state two
    ``shard_grads_like_opt`` steps under a (1, 1) data×model mesh
    (``shard_train_state``: every collective runs, on one rank); loss,
    grad norm and every bf16 parameter bitwise equal, else within 1e-6
    relative (``MESH_TOL``; printed which), the master / m / v digests;
    the mesh steps' walls, one more mesh step profiled for its
    collectives (``torch.profiler``: the host's collective calls, the
    NCCL kernels and the device copies a one-rank communicator runs),
    peak memory, and its ``flash_attention`` launches
    (counters zeroed just before the mesh steps, read just after: phase
    26's rule × microbatches × steps). (b) deepseek-moe-16b (4 layers)
    the same way, one step: expert parallelism runs at model = 1; its
    loss and every routing's expert ids equal the no-mesh step's. (c) A
    (1, 1, 1) pod×data×model mesh: ``pod_compressed_value_and_grad`` on
    (a)'s cell and first microbatch; the int8 gradients equal the port's
    plain ``_quantize`` / dequantize of the exact gradients bitwise, each
    leaf's quantization error at most half its scale (plus fp32
    rounding), and the int8 bytes
    the pod ``all_gather`` carried beside the fp32 bytes it replaces. (d)
    command-r-35b's 4-layer cut is not trained: its per-rank bytes under
    the tp layout and ZeRO on the (data, model) layouts of 1, 2, 4 and 8
    cards (``MESH_LAYOUTS``) from the rules (the model axis divides the
    parameters, the gradients and the optimizer state), plus one
    microbatch's bf16 gradients in the model blocks and its other
    transients measured on the card, and the least layout of each card
    count whose sum fits 80 GB.
32. The ``model`` axis as compute (``dist.TensorParallel``), one NCCL
    rank. (a) Phase 15's cell of qwen2.5-14b and falcon-mamba-7b
    (``TP_SERVE``: 4 layers, bf16, 4 slots, 8 prompts of 512–2048
    tokens, 32 new each) served without a mesh and under a (1, 1)
    data×model mesh, each after a warm-up: every prefill's and decode
    step's logits bitwise equal, else within ``MESH_TOL`` (printed
    which), the tokens equal, tokens/s of both runs, the collectives of a
    decode step (``dist.COLLECTIVES``), the kernel's launches equal. (b)
    Phase 31a's qwen2.5-14b step, which runs the tensor-parallel path:
    its equality, step walls and collective calls beside the same cell's
    when each layer gathered its blocks whole (``GATHERED_LAYERS``). (c)
    One full-width layer of qwen2.5-14b (attention + MLP), falcon-mamba-7b
    (Mamba1) and command-r-35b (the parallel block) at ``TP_SEQ`` tokens,
    its parts at
    ``TP_RANKS`` model ranks played in turn (``layers.attention_partial``
    + ``mlp_partial``, ``ssm.mamba1_mix`` + ``mamba1_scan_out`` with
    x_proj's parts summed between, ``layers.parallel_partial``) summed
    here, against the same function at one rank, fp32 within 1e-5 and
    bf16 within 2⁻⁷ of max|out| (``TP_TOL``). (d) ``flash_attention`` at
    qwen2.5-14b's 2048-token prefill cut to its heads at model widths 2,
    4 and 8 (20 / 4, 10 / 2, 5 / 1) and ``mamba_scan`` at
    falcon-mamba-7b's cut to 4096 / 2048 / 1024 channels, each against
    its plain version, timed, bounded, attention beside SDPA. (e) Phase
    32a's cell again under the (1, 1) mesh in the fsdp layout (each
    layer's blocks gathered whole at use, the decode cache's rows over
    data): every logit bitwise equal to serving without a mesh (the same
    no-mesh run as 32a's), the tokens equal, tokens/s, a decode step's
    collectives (``fsdp_serve`` lines).
33. The dry run (``repro_torch.launch.dryrun``), in processes of its own
    (its fake process group of 256 or 512 ranks cannot share a process
    with phases 31–32's NCCL group). (a) Started in the background right
    after the build, with CUDA hidden (host work only), one process an
    arch of ``DRYRUN_JOBS``: qwen2.5-14b, falcon-mamba-7b and
    deepseek-moe-16b × ``train_4k`` / ``prefill_32k`` / ``decode_32k``,
    falcon-mamba-7b × ``long_500k`` and fast_seismic × ``station_month``,
    each single and multi, traced on ``meta`` tensors at full width as
    rank 0 of the production mesh; here every cell must be ``ok``, and
    each prints its per-rank flops, bytes, collectives, memory, roofline
    terms, ``dominant`` and ``useful_flops_ratio``. (b) ``--profile
    --reuse-trace`` on the card for each of ``DRYRUN_PROFILE``
    (qwen2.5-14b × ``train_4k`` and fast_seismic × ``station_month``,
    single): the rank's block run for real (random values, the
    collectives counted and not performed), one warm-up step and one
    profiled step: the step must launch its path's kernels, no measured
    time may fall below its traced bound (the step's device time against
    the bound without collectives, each kernel's device time against its
    calls' ``cost.py`` bounds), and ``max_memory_allocated`` must lie in
    the cell's band of the traced peak (arguments + temporaries). (a)
    also traces ``DRYRUN_FSDP`` (qwen2.5-14b × ``prefill_32k`` /
    ``decode_32k`` × single) under ``--layout fsdp``, its records tagged
    ``fsdp``: each ``ok`` and printed as the others.

``--profile`` adds a last phase: the first 2 h of the paper-scale replay
again under ``torch.profiler``, reporting device time by kernel and the
device's busy and idle shares (``chiprun_out/profile.txt``); it also
profiles three serving ticks in phase 16 (``chiprun_out/serve_profile.txt``).

It prints a ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. Every kernel's ``launches`` is read
from the path that runs it: the paper streaming service (phase 7) for the
four kernels of the detection core, each with the batch replay's count
(phase 5) beside it under ``launches_by_path``; the offline search (phase
11) for ``minmax_hash`` and ``occurrence_filter``; the LM serve runs
(phase 15) for
``flash_attention`` (qwen2.5-14b) and ``mamba_scan`` (falcon-mamba-7b),
each also with the training run's count under ``launches_by_path``; the
training runs (phase 26) for ``flash_attention_bwd`` and
``mamba_scan_bwd``; the four LM kernels with every serve and training
run's count under ``launches_by_model``. ``flash_attention`` and
``flash_attention_bwd`` also carry ``head_dim_16``: the D = 16 cases of
phases 13 and 24 (error, times, bound, SDPA) and the launches of
command-r-35b-smoke's card runs in phases 14 and 25.
The serving phase's counts stand beside them under ``launches_by_path``
(``serve``) for ``stft_mag``, ``haar2d`` and ``minmax_hash``, whose entries
also carry their error, time, bound and library time at the serving
shapes (``serving_shape``), and so do the located paths' (phases 18, 19,
21 and 22: ``elastic``, ``located_batch``, ``located_stream``,
``serve_locate``) and ``detect_step``'s (29) for the kernels each runs;
the sharded stream's (30a, its 3-wide mesh: ``sharded_stream``) and
``detect_step_sharded``'s (30d) stand under all four kernels of the
detection core.
Before them it prints the script's seconds (``chip_smoke_seconds``).
Without CUDA it exits 2 and prints no result. Writes
``chiprun_out/chip_smoke.json`` with everything printed.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100's peak rates and each kernel's work: every bound_ms below is
# kernels/cost.py's (import-light: no torch)
from repro_torch.kernels import cost  # noqa: E402
# bytes written before each cold timing: more than the 50 MB L2 holds
L2_FLUSH_BYTES = 128 << 20
RTOL = 1e-5
# ~0.5 ms of device busy wait before each timed call (see _time_ms): a
# slow moment of the host (~0.1 ms of wait was not always enough for the
# jaccard_popcount wrapper on a shared host) would otherwise land inside
# the events
PRIME_CYCLES = 1_000_000
N_STATIONS = 4
PAPER_HOURS = 24.0
# samples a station a push of the paper stream: 60 s at 100 Hz, the
# reorder horizon stream_config() is sized for (a live feed's packet span)
STREAM_CHUNK = 6000
# a short trace whose events the paper's 32 s fingerprints see; the same
# as tests/test_torch_paper_widths.py
PARITY_SYNTH = dict(duration_s=1200.0, n_stations=3, n_sources=2,
                    events_per_source=4, repeating_noise_stations=(0,),
                    event_snr=6.0, seed=5)
# the kernels of the batch replay; minmax_hash runs on the offline search
BATCH_KERNELS = ("stft_mag", "haar2d", "minmax_sig_buckets",
                 "jaccard_popcount")
# the path whose launch counts the kernels line reports, per kernel: the
# streaming service for the four kernels of the detection core (each also
# reports the batch replay's count under launches_by_path)
KERNEL_PATH = {**{k: ("stream_paper",) for k in BATCH_KERNELS},
               "minmax_hash": ("offline_paper",),
               "occurrence_filter": ("offline_paper",),
               "flash_attention": ("lm_serve", "qwen2.5-14b"),
               "mamba_scan": ("lm_serve", "falcon-mamba-7b"),
               "flash_attention_bwd": ("lm_train", "qwen2.5-14b"),
               "mamba_scan_bwd": ("lm_train", "falcon-mamba-7b")}
# every path whose launch counts a kernel's entry lists under
# launches_by_path: the batch replay (phase 5), the streaming service
# (phase 7), the offline search (phase 11), detection serving (phase 16),
# the elastic stream (18), the located batch replay (19), the located
# stream (21), serving with --locate (22), detect_step (29), the sharded
# stream (30a, its 3-wide mesh) and detect_step_sharded (30d)
MORE_PATHS = ("located_batch", "located_stream", "serve_locate", "elastic",
              "detect_step", "sharded_stream", "detect_step_sharded")
KERNEL_PATHS = {"stft_mag": ("paper", "stream_paper", "serve")
                + MORE_PATHS,
                "haar2d": ("paper", "stream_paper", "serve") + MORE_PATHS,
                "minmax_sig_buckets": ("paper", "stream_paper")
                + MORE_PATHS,
                "jaccard_popcount": ("paper", "stream_paper", "elastic",
                                     "sharded_stream",
                                     "detect_step_sharded"),
                "minmax_hash": ("offline_paper", "serve", "serve_locate"),
                "occurrence_filter": ("offline_paper", "paper",
                                      "stream_paper", "detect_step",
                                      "detect_step_sharded")}
SERVE_KERNELS = tuple(k for k, p in KERNEL_PATHS.items() if "serve" in p)
# kernel tolerance, a share of max|plain|: fp32 summation order and the
# online-softmax rescale; one rounding of a bf16 output, plus P rounded to
# bf16 before P·V (at most ~2⁻⁹·max|v|)
LM_TOL = {"float32": 5e-5, "bfloat16": 2.0 ** -7}
LM_SERVE_LAYERS = 4
# phase 15's models: (arch, n_layers cut to LM_SERVE_LAYERS), the kernel
# of each model's layers; zamba2-1.2b runs whole (a 4-layer cut has no
# shared-attention group at shared_attn_every = 6) and so does
# internvl2-1b (small enough)
LM_SERVE_MODELS = (("qwen2.5-14b", True), ("falcon-mamba-7b", True),
                   ("yi-9b", True), ("codeqwen1.5-7b", True),
                   ("musicgen-large", True), ("command-r-35b", True),
                   ("deepseek-moe-16b", True),
                   ("moonshot-v1-16b-a3b", True), ("zamba2-1.2b", False),
                   ("internvl2-1b", False))
# the smoke config whose head dim, 128 / 8 = 16, phases 14 and 25 run the
# D = 16 kernels on (the kernels line's head_dim_16 launches), and the
# D = 16 attention cases of phases 13 and 24: its 8 / 2 heads at a
# 2048-token prefill, bf16 and fp32
D16_MODEL = "command-r-35b-smoke"
D16_CASES = ((1, 8, 2, 2048, 2048, 16, "bfloat16"),
             (1, 8, 2, 2048, 2048, 16, "float32"))
# full-width training (phase 26): seq 2048, per model (global batch,
# microbatches, n_layers cut to 4 as the serve phase cuts it); timed
# steps after one warm-up step. One arch of each family that fits one
# card: zamba2-1.2b and internvl2-1b run whole, as in phase 15;
# command-r-35b does not fit (its 4-layer cut's training state is ~126
# GB) and trains at its smoke config only (phase 25)
LM_TRAIN_LAYERS = 4
LM_TRAIN_SEQ = 2048
LM_TRAIN = {"qwen2.5-14b": (2, 2, True), "falcon-mamba-7b": (4, 2, True),
            "deepseek-moe-16b": (2, 2, True), "zamba2-1.2b": (4, 2, False),
            "internvl2-1b": (4, 2, False)}
LM_TRAIN_STEPS = 4
# the LM kernels' launches by path: the serve runs (phase 15) and the
# training runs (phase 26), of the model that runs each kernel; every
# other model's count stands under launches_by_model
LM_KERNEL_MODEL = {"flash_attention": "qwen2.5-14b",
                   "flash_attention_bwd": "qwen2.5-14b",
                   "mamba_scan": "falcon-mamba-7b",
                   "mamba_scan_bwd": "falcon-mamba-7b"}
# the launcher runs of the resume phase (27): --arch, with --smoke
RESUME_ARCHS = (("smoke", False), ("deepseek-moe-16b", True),
                ("zamba2-1.2b", True))
# the serving phase: request windows of 60 s on the fingerprint grid, a
# burst of SERVE_REQUESTS, then SERVE_OVERLOAD more at once (past the
# serve_config() queue bound of 1,024, so SERVE_OVERLOAD - 1,024 shed); the
# first tick's requests (every slot) are held against the port's CPU path
SERVE_WINDOW_S = 60.0
SERVE_REQUESTS = 64
SERVE_OVERLOAD = 1100
# phase 30: the logical station meshes on one card, [cuda:0] × width (the
# 3-wide one pads phase 7's 4 stations with 2 rows); the pushes before
# which memory_allocated is read (ten steady pushes, well past the
# statistics freeze); detect_step_sharded's shape, mesh, chunks a pooled
# call (512 chunks of 2,544 fingerprints do not fit one call: ~26 MB of
# outputs and ~0.2 GB of work a chunk) and sampled chunks
SHARDED_WIDTHS = (2, 3)
SHARDED_MEMORY_PUSHES = (300, 310)
DETECT_SHARDED_SHAPE = "station_month"
DETECT_SHARDED_WIDTH = 2
DETECT_SHARDED_GROUP = 32
DETECT_SHARDED_SAMPLE = 8
# wall-clock entries of a stream's ingest summaries
# phase 31: the models of its cells, the no-mesh / mesh steps compared,
# the tolerance where the design does not give bit equality, the data
# widths of command-r-35b's reckoning
MESH_TRAIN = {"qwen2.5-14b": 2, "deepseek-moe-16b": 1}
MESH_TOL = 1e-6
# 31d: command-r-35b's (data, model) layouts on 1, 2, 4 and 8 cards
MESH_LAYOUTS = ((1, 1), (2, 1), (1, 2), (4, 1), (2, 2), (1, 4), (8, 1),
                (4, 2), (2, 4), (1, 8))
# phase 32: the served models under a (1, 1) mesh (phase 15's cell), the
# full-width layers split over TP_RANKS model ranks played in turn, the
# split's tolerance (a share of max|out|) by dtype, the kernels' per-rank
# shapes at model widths TP_WIDTHS
TP_SERVE = ("qwen2.5-14b", "falcon-mamba-7b")
TP_LAYERS = {"qwen2.5-14b": "attention + mlp", "falcon-mamba-7b": "mamba1",
             "command-r-35b": "parallel"}
TP_RANKS = 4
TP_SEQ = 2048
TP_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TP_WIDTHS = (2, 4, 8)
# 31a's cell when each layer gathered its blocks whole at use (this
# script's phase 31 on an NVIDIA H100 80GB HBM3 at 700 W): the mesh and
# no-mesh step walls and the profiled step's collective events
GATHERED_LAYERS = {"step_mesh_s": 0.532, "step_no_mesh_s": 0.380,
                   "collective_calls": 430}
# 31d's budget a card: 80 GB (the card reports 85.0e9 bytes; the rest is
# left to the CUDA context, the allocator and the step's transients)
CARD_BUDGET = 80e9
# phase 33: the traced cells, one background process an entry (arch,
# shapes), each single and multi; the profiled cells (arch, shape) with
# the band of max_memory_allocated over the traced peak (PERF.md, stated
# before the first run on the card) and the kernels the step must launch
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun"
DRYRUN_JOBS = (("fast_seismic", "station_month"),
               ("qwen2.5-14b", "train_4k,prefill_32k,decode_32k"),
               ("falcon-mamba-7b",
                "train_4k,prefill_32k,decode_32k,long_500k"),
               ("deepseek-moe-16b", "train_4k,prefill_32k,decode_32k"))
# the serving cells traced under the fsdp layout (single only, records
# tagged "fsdp" beside the tp ones)
DRYRUN_FSDP = ("qwen2.5-14b", "prefill_32k,decode_32k")
DRYRUN_PROFILE = {
    ("qwen2.5-14b", "train_4k"): ((0.9, 1.3), ("flash_attention",
                                               "flash_attention_bwd")),
    ("fast_seismic", "station_month"): ((0.2, 1.3), (
        "stft_mag", "haar2d", "minmax_sig_buckets"))}
DRYRUN_TIMEOUT = 900
WALL_KEYS = ("wall_s", "chunk_ms_p50", "chunk_ms_p95", "chunks_per_s",
             "samples_per_s")
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def _time_ms(fn, iters: int = 30, warmup: int = 3,
             primed: bool = True, flush=None) -> float:
    """Median of ``iters`` timings of ``fn`` between two CUDA events.
    ``primed`` queues a device-side busy wait of ``PRIME_CYCLES`` before
    each call, so the host has enqueued the call before the device reaches
    the first event and the events bracket the device's work alone;
    unprimed, a call whose host dispatch outlasts its device work (~0.05
    ms for a ctypes kernel wrapper) is timed at its dispatch. ``flush``
    (a tensor larger than the L2) is zeroed before each busy wait, outside
    the events, so that each call finds its inputs in device memory."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        if primed:
            torch.cuda._sleep(PRIME_CYCLES)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2]


def _plan_dict(p) -> dict:
    return {"tiled": p.tiled, "warps": p.warps, "split": p.split,
            "grid": list(p.grid)}


def _minmax_l2(p, nnz: int, words: int, h: int) -> tuple[str, int]:
    """The bytes that the plan ``p`` reads from L2 by its design, and what
    they are: the row kernel's gathers of a mapping value a set bit and
    column (``gather``, nnz · H · 4), or the tiled kernel's staging of the
    table once a row tile (``staged``). Arithmetic from the plan, not a
    traced byte count."""
    if p.tiled:
        return "staged", p.grid[0] // p.split * 32 * words * h * 4
    return "gather", nnz * h * 4


def _minmax_rate(name: str, packed, mappings, nnz: int, ms: float,
                 f: int | None = None) -> dict:
    """Print ``<name>_rate``: the plan that ran, and the bytes it reads
    from L2 by its design (``_minmax_l2``) over the kernel's time, as
    ``gather_tb_s`` for the row kernel or ``staged_tb_s`` for the tiled
    one."""
    from repro_torch.kernels import minmax_hash as mm_k
    n, words = packed.shape
    h = mappings.shape[1]
    p = mm_k._plan_for(packed, mappings, f)
    kind, l2 = _minmax_l2(p, nnz, words, h)
    out = {"shape": [n, words, h], "set_bits": nnz, "ms": ms,
           f"{kind}_bytes": l2, f"{kind}_tb_s": l2 / ms * 1e-9,
           "plan": _plan_dict(p)}
    print(f"{name}_rate", json.dumps(out), flush=True)
    return out


def _minmax_row_cases(name: str, cases: dict, call, plain) -> dict:
    """Shapes of the path that the plan gives the row kernel: each of
    ``cases`` (label → args) must plan the row kernel, ``call(*args)``
    must equal ``plain(*args)`` bit for bit; returns each one's plan,
    shape and time."""
    import torch
    from repro_torch.kernels import minmax_hash as mm_k
    out = {}
    for label, args in cases.items():
        packed, mappings, f = args[0], args[1], args[-1]
        p = mm_k._plan_for(packed, mappings, f)
        _need(not p.tiled, f"{name} ({label}) must take the row kernel")
        got, want = call(*args), plain(*args)
        torch.cuda.synchronize()
        _need(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} ({label}) differs from its plain version")
        out[label] = {"shape": [*packed.shape, mappings.shape[1]],
                      **_plan_dict(p), "ms": _time_ms(lambda: call(*args))}
    return out


def _close(got, want) -> float:
    import torch
    err = float((got - want).abs().max())
    tol = RTOL * float(want.abs().max())
    _need(bool(torch.isfinite(got).all()), "non-finite kernel output")
    _need(torch.allclose(got, want, rtol=RTOL, atol=tol),
          f"kernel differs from plain version: max abs err {err}")
    return err


def _shape_case(call, plain, work: cost.Work, library=None) -> dict:
    """A kernel at one more shape of its path: held against its plain
    version at ``_close``'s tolerance, timed, with its bound (``work``'s)
    and, where one PyTorch call computes the same function
    (``library``), that call's time."""
    import torch
    got, want = call(), plain()
    torch.cuda.synchronize()
    err = _close(got, want)
    bound, by = cost.bound_ms(work)
    return {"shape": list(got.shape), "max_abs_err": err,
            "ms": _time_ms(call), "plain_ms": _time_ms(plain),
            "bound_ms": bound, "bound_by": by,
            "library_ms": None if library is None else _time_ms(library)}


def kernel_phase(ds, n_fp: int, dev) -> tuple[list[dict], dict]:
    """Every kernel against its plain version at one paper block's shapes;
    returns their entries and the Jaccard slots for the replay's shape."""
    import numpy as np
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import fingerprint as fp_mod
    from repro_torch.core import lsh as lsh_mod
    from repro_torch.kernels import haar2d as haar_k
    from repro_torch.kernels import minmax_hash as mm_k
    from repro_torch.kernels import ops
    from repro_torch.kernels import stft_mag as stft_k

    cfg = fast_seismic.config()
    fcfg, lcfg = cfg.fingerprint, cfg.lsh
    n_buckets = 16384
    bs = fcfg.block_samples(256)
    start = (n_fp // 2 // 256) * 256 * fcfg.lag_samples   # a middle block
    wave = torch.as_tensor(
        np.ascontiguousarray(ds.waveforms[:, start:start + bs]), device=dev)
    c = fp_mod._consts(fcfg, dev)
    out = []

    # --- stft_mag
    args = (wave, c["window"], c["dft_r"], c["dft_i"], fcfg.stft_hop)
    got = ops.stft_mag(*args)
    want = stft_k.plain(*args)
    torch.cuda.synchronize()
    err = _close(got, want)
    r, nf, k = got.shape
    frame_len = fcfg.stft_len
    frames = wave[:, :(nf - 1) * fcfg.stft_hop + frame_len].unfold(
        -1, frame_len, fcfg.stft_hop)
    xw = (frames * c["window"]).reshape(-1, frame_len).contiguous()
    dft_cat = torch.cat([c["dft_r"], c["dft_i"]], dim=1).contiguous()
    work = cost.stft_mag(*wave.shape, frame_len, k, fcfg.stft_hop)
    bound, by = cost.bound_ms(work)
    ms = _time_ms(lambda: ops.stft_mag(*args))
    out.append({"name": "stft_mag", "route": "cuda",
                "source": "src/repro_torch/csrc/stft_mag.cu",
                "replaces": "src/repro/kernels/stft_mag.py:35",
                "shape": [r, nf, k], "max_abs_err": err, "ms": ms,
                "gflop_s": work.ops / ms * 1e-6,
                "plain_ms": _time_ms(lambda: stft_k.plain(*args)),
                "bound_ms": bound, "bound_by": by,
                "library_ms": _time_ms(lambda: torch.matmul(xw, dft_cat))})
    print("stft_mag_rate", json.dumps({
        "shape": [r, nf, k], "ms": ms, "gflop_s": out[-1]["gflop_s"],
        "ms_unprimed": _time_ms(lambda: ops.stft_mag(*args), primed=False),
        "library_ms_unprimed": _time_ms(lambda: torch.matmul(xw, dft_cat),
                                        primed=False)}), flush=True)
    spec = want

    # --- haar2d
    imgs = fp_mod.spectral_images(spec, fcfg).reshape(
        -1, fcfg.img_freq, fcfg.img_time).contiguous()
    th, tw, _ = ops.haar_mats(fcfg.img_freq, fcfg.img_time, dev)
    got = ops.haar2d(imgs)
    want = haar_k.plain(imgs, th, tw)
    torch.cuda.synchronize()
    err = _close(got, want)
    n, h, w = imgs.shape
    work = cost.haar2d(n, h, w)
    bound, by = cost.bound_ms(work)
    ms = _time_ms(lambda: ops.haar2d(imgs))
    out.append({"name": "haar2d", "route": "cuda",
                "source": "src/repro_torch/csrc/haar2d.cu",
                "replaces": "src/repro/kernels/haar2d.py:39",
                "shape": [n, h, w], "max_abs_err": err, "ms": ms,
                "gflop_s": work.ops / ms * 1e-6,
                "plain_ms": _time_ms(lambda: haar_k.plain(imgs, th, tw)),
                "bound_ms": bound, "bound_by": by,
                "library_ms": _time_ms(lambda: torch.einsum(
                    "ij,njk,lk->nil", th, imgs, tw))})
    print("haar2d_rate", json.dumps({
        "shape": [n, h, w], "ms": ms, "gflop_s": out[-1]["gflop_s"],
        "plain_ms": out[-1]["plain_ms"],
        "library_ms": out[-1]["library_ms"]}), flush=True)

    # --- minmax_sig_buckets (bit-exact, including rows with no set bit)
    coeffs = want.reshape(n, -1)
    med, mad = fp_mod.mad_stats(coeffs, 1.0)
    _, packed = fp_mod.binarize_coeffs(coeffs, fcfg, (med, mad))
    packed = packed.contiguous()
    packed[:: 97] = 0
    mappings = lsh_mod.hash_mappings(fcfg.fp_dim, lcfg, dev)
    salts = lsh_mod.bucket_salts(lcfg.n_tables, lcfg.seed, dev)
    mm_args = (packed, mappings, salts)
    kw = {"use_minmax": lcfg.use_minmax, "n_buckets": n_buckets}
    sig, bkt = ops.minmax_sig_buckets(*mm_args, **kw)
    f = lcfg.funcs_per_table
    sig_p, bkt_p = mm_k.plain(*mm_args, f, lcfg.use_minmax, n_buckets)
    torch.cuda.synchronize()
    _need(torch.equal(sig, sig_p) and torch.equal(bkt, bkt_p),
          "minmax_sig_buckets differs from its plain version")
    bits = (packed[:, :, None] >> torch.arange(32, device=dev)) & 1
    nnz = int(bits.sum())
    dims = int(bits.reshape(n, -1).any(dim=0).sum())
    h_fns = mappings.shape[1]
    bound, by = cost.bound_ms(cost.minmax_sig_buckets(
        n, packed.shape[1], h_fns, lcfg.n_tables, nnz=nnz, dims=dims))
    ms = _time_ms(lambda: ops.minmax_sig_buckets(*mm_args, **kw))
    rate = _minmax_rate("minmax_sig_buckets", packed, mappings, nnz, ms, f)
    # the row kernel's shapes of the replay: one station's block at the
    # paper widths, and a 4-station block of the smoke config (D 1024,
    # H 40, f 2)
    scfg = fast_seismic.smoke_config()
    sfc, slc = scfg.fingerprint, scfg.lsh
    s0 = min(start, ds.waveforms.shape[1] - sfc.block_samples(256))
    swave = torch.as_tensor(np.ascontiguousarray(
        ds.waveforms[:, s0:s0 + sfc.block_samples(256)]), device=dev)
    spacked = torch.cat([fp_mod.fingerprints_from_waveform(x, sfc)[1]
                         for x in swave]).contiguous()
    spacked[:: 97] = 0
    plans = {"paper_block": rate["plan"]}
    plans.update(_minmax_row_cases(
        "minmax_sig_buckets",
        {"one_station": (packed[:n // N_STATIONS].contiguous(), mappings,
                         salts, lcfg.use_minmax, f),
         "smoke_block": (spacked, lsh_mod.hash_mappings(sfc.fp_dim, slc, dev),
                         lsh_mod.bucket_salts(slc.n_tables, slc.seed, dev),
                         slc.use_minmax, slc.funcs_per_table)},
        lambda pk, mp, sa, um, ff: ops.minmax_sig_buckets(
            pk, mp, sa, use_minmax=um, n_buckets=n_buckets),
        lambda pk, mp, sa, um, ff: mm_k.plain(pk, mp, sa, ff, um,
                                              n_buckets)))
    out.append({"name": "minmax_sig_buckets", "route": "cuda",
                "source": "src/repro_torch/csrc/minmax_hash.cu",
                "replaces": "src/repro/kernels/minmax_hash.py:151",
                "shape": [n, packed.shape[1], h_fns], "set_bits": nnz,
                "max_abs_err": 0, "ms": ms,
                **{k: v for k, v in rate.items() if k.endswith("_tb_s")},
                "plans": plans,
                "plain_ms": _time_ms(lambda: mm_k.plain(
                    *mm_args, f, lcfg.use_minmax, n_buckets), iters=20),
                "bound_ms": bound, "bound_by": by, "library_ms": None})

    # --- jaccard_popcount (bit-exact, including empty unions). As in
    # verify_pairs on the paper replay: the packed ring covers the whole
    # trace, idx2 is a row of the current block and idx1 any row the ring
    # has filled so far, so the gathers reach across all of it; the ids
    # are not reduced modulo the ring (the kernel reduces them).
    ring, m = n_fp, 4096
    words = packed.shape[1]
    per = n // N_STATIONS
    blk = packed.reshape(N_STATIONS, per, words)
    first = start // fcfg.lag_samples             # the block's first id
    g = torch.Generator(device="cpu").manual_seed(0)
    i2 = first + torch.randint(0, per, (N_STATIONS, m), generator=g)
    i1 = torch.randint(0, first + per, (N_STATIONS, m), generator=g)
    i1[:, :64] = i2[:, :64]                       # identical rows
    i1[:, 64:96] = ring - 1                       # empty unions
    i2[:, 64:96] = ring - 2
    for ids in (i1, i2):                          # ids as the stream has them
        ids += ring * torch.randint(-1, 3, (N_STATIONS, m), generator=g)
    jac = {"blk": blk.cpu(), "ring": ring, "i1": i1.to(torch.int32),
           "i2": i2.to(torch.int32)}
    entry = {"name": "jaccard_popcount", "route": "cuda",
             "source": "src/repro_torch/csrc/jaccard_popcount.cu",
             "replaces": "src/repro/kernels/jaccard_popcount.py:32",
             "shape": [N_STATIONS, m, words], "max_abs_err": 0,
             "library_ms": None, "plans": {}}
    valid = torch.ones((N_STATIONS, m), dtype=torch.bool)
    case = jaccard_case("all_valid", jac, valid, dev, entry)
    entry.update({"ms": case["warm_ms"], "cold_ms": case["cold_ms"],
                  "plain_ms": case["plain_ms"],
                  "bound_ms": case["bound_ms"], "bound_by": case["bound_by"]})
    out.append(entry)
    return out, jac


def _jaccard_ring(jac: dict, dev):
    """The paper replay's packed ring for 4 stations at the paper widths
    (one block's rows repeated over the whole trace, the last two rows
    empty), and a copy of it that starts 4 bytes off 16 (the scalar
    plan's input)."""
    import torch
    blk, ring = jac["blk"].to(dev), jac["ring"]
    per = blk.shape[1]
    pk = blk.repeat(1, -(-ring // per), 1)[:, :ring].contiguous()
    pk[:, ring - 2:] = 0
    flat = torch.empty(pk.numel() + 1, dtype=torch.int32, device=dev)
    off = flat[1:].view(pk.shape)
    off.copy_(pk)
    return pk, off


def jaccard_case(label: str, jac: dict, valid, dev, entry: dict) -> dict:
    """``jaccard_popcount`` at one shape of the replay's verify: the
    slots' ids of ``jac``, valid where ``valid`` says (garbage ids
    elsewhere, never read). Both plans (16-byte loads on the aligned
    ring, 4-byte words on the copy off 16 bytes) bit-exact against the
    plain version; each timed warm (the same call repeated) and cold (an
    L2 flush before each call); the bound counts the rows of the valid
    pairs once, the flags, the valid slots' ids and the scores, and 2
    POPC a word of each valid pair at ``cost.POPC_OPS_PER_S``. Prints a
    ``jaccard_popcount_rate`` line and records each plan in ``entry``."""
    import torch
    from repro_torch.kernels import jaccard_popcount as jac_k
    from repro_torch.kernels import ops
    pk, off = _jaccard_ring(jac, dev)
    s, ring, words = pk.shape
    g = torch.Generator(device="cpu").manual_seed(1)
    junk = torch.randint(-2**31, 2**31 - 1, (2, *valid.shape), generator=g,
                         dtype=torch.int32)
    i1 = torch.where(valid, jac["i1"], junk[0]).to(dev)
    i2 = torch.where(valid, jac["i2"], junk[1]).to(dev)
    valid = valid.to(dev)
    want = jac_k.plain(pk, i1, i2, valid)
    live = int(valid.sum())
    st = torch.arange(s, device=dev)[:, None].expand_as(valid)[valid]
    rows = torch.unique(torch.cat([st * ring + (i[valid] % ring)
                                   for i in (i1, i2)])).numel()
    bound, by = cost.bound_ms(cost.jaccard_popcount(
        s, ring, valid.shape[1], words, live=live, rows=rows))
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = {"case": label, "shape": [s, valid.shape[1], words],
           "valid_pairs": live, "distinct_rows": rows, "bound_ms": bound,
           "bound_by": by, "popc_ops_per_s": cost.POPC_OPS_PER_S}
    for name, ring_t in (("vector", pk), ("scalar", off)):
        p = jac_k.plan(words, ring_t.data_ptr())
        _need(p.vector == (name == "vector"),
              f"jaccard_popcount ({label}): the {name} plan did not run")
        got = ops.jaccard_popcount(ring_t, i1, i2, valid)
        torch.cuda.synchronize()
        _need(torch.equal(got, want),
              f"jaccard_popcount ({label}, {name} plan) differs from plain")
        call = (lambda r=ring_t: ops.jaccard_popcount(r, i1, i2, valid))
        warm, cold = _time_ms(call), _time_ms(call, flush=flush)
        row_bytes = 2 * live * words * 4
        out[name] = {"plan": dataclasses.asdict(p), "warm_ms": warm,
                     "cold_ms": cold, "warm_gb_s": row_bytes / warm * 1e-6,
                     "cold_gb_s": row_bytes / cold * 1e-6}
        entry["plans"][f"{label}_{name}"] = {**out[name]["plan"],
                                            "warm_ms": warm, "cold_ms": cold}
    _need(bool((want[~valid] == 0).all()), "invalid slots must score 0")
    out["warm_ms"], out["cold_ms"] = (out["vector"]["warm_ms"],
                                      out["vector"]["cold_ms"])
    if label == "all_valid":
        _need(bool((want[:, 64:96] == 0).all()), "empty union must score 0")
        out["plain_ms"] = _time_ms(lambda: jac_k.plain(pk, i1, i2, valid))
    print("jaccard_popcount_rate", json.dumps(out), flush=True)
    del flush
    return out


def jaccard_replay_phase(jac: dict, emitted: list, dev,
                         entry: dict) -> dict:
    """``jaccard_popcount`` at the replay's real shape: 4 × 4096 slots a
    block, station s valid on a prefix as long as its pairs emitted over
    the whole paper replay (capped at 4096; no block can hold more)."""
    import torch
    m = jac["i1"].shape[1]
    valid = (torch.arange(m)[None, :]
             < torch.tensor([min(e, m) for e in emitted])[:, None])
    out = jaccard_case("replay", jac, valid, dev, entry)
    out["pairs_emitted_per_station"] = emitted
    entry["replay"] = {k: out[k] for k in (
        "valid_pairs", "warm_ms", "cold_ms", "bound_ms", "bound_by")}
    return out


def golden_phase(dev) -> dict:
    """The batch golden on the card: 9 detections and recall 1.0."""
    from repro_torch.core import (AlignConfig, DetectConfig,
                                  FingerprintConfig, LSHConfig, SynthConfig,
                                  make_dataset)
    from repro_torch.core.detect import detect_events, recall_against_truth
    gold = json.loads((ROOT / "tests" / "golden" / "batch_detect.json")
                      .read_text())
    syn = dict(gold["synth"])
    syn["repeating_noise_stations"] = tuple(syn["repeating_noise_stations"])
    ds = make_dataset(SynthConfig(**syn))
    fcfg = FingerprintConfig(img_time=32, img_hop=4, top_k=200,
                             mad_sample_rate=1.0)
    cfg = DetectConfig(
        fingerprint=fcfg,
        lsh=LSHConfig(n_tables=100, n_funcs=4, n_matches=2, bucket_cap=8,
                      min_dt=fcfg.overlap_fingerprints,
                      occurrence_frac=0.05),
        align=AlignConfig(channel_threshold=3, min_cluster_sim=4,
                          min_cluster_size=1, min_stations=2,
                          onset_tol=int(10 * fcfg.fs / fcfg.lag_samples)))
    det, events, _, stats = detect_events(ds.waveforms, cfg,
                                          keep_pairs=True, device=dev)
    pairs = stats.pop("_station_pairs")
    rec = recall_against_truth(det, events, ds, fcfg)
    overlap = []
    for st, p in enumerate(pairs):
        v = p.valid.cpu().numpy()
        got = set(zip(p.idx1.cpu().numpy()[v].tolist(),
                      p.idx2.cpu().numpy()[v].tolist(),
                      p.sim.cpu().numpy()[v].tolist()))
        want = {tuple(t) for t in gold["station_pairs"][st]}
        overlap.append(len(got & want) / max(len(got | want), 1))
    stats = {k: v for k, v in stats.items()
             if k != "drops" and not k.endswith("_qc")}
    out = {"detections": stats["detections"], "recall": rec["recall"],
           "stats_equal_golden": stats == gold["stats"],
           "pair_overlap": overlap}
    print("golden", json.dumps(out), flush=True)
    _need(stats["detections"] == gold["stats"]["detections"] == 9,
          f"golden detections {stats['detections']} != 9")
    _need(rec["recall"] == 1.0, f"golden recall {rec['recall']} != 1.0")
    _need(out["stats_equal_golden"], "golden stats differ on the card")
    _need(all(o == 1.0 for o in overlap),
          f"golden pair sets differ on the card: overlap {overlap}")
    return out


def _triplets(p) -> list:
    v = p.valid.cpu().numpy()
    return sorted(zip(p.idx1.cpu().numpy()[v].tolist(),
                      p.idx2.cpu().numpy()[v].tolist(),
                      p.sim.cpu().numpy()[v].tolist()))


def paper_parity_phase(dev) -> dict:
    """The paper widths on a short trace, card against the port's CPU path.

    ``tests/test_torch_paper_widths.py`` holds the CPU path to the JAX
    package on this trace and configuration (pair triplets, stats and
    detections equal), so equality here ties the card to the reference
    at the paper's widths."""
    import dataclasses
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.core.detect import detect_events
    ds = make_dataset(SynthConfig(**PARITY_SYNTH))
    cfg = fast_seismic.config()
    cfg = dataclasses.replace(cfg, fingerprint=dataclasses.replace(
        cfg.fingerprint, mad_sample_rate=1.0))
    scfg = fast_seismic.batch_replay_config(
        cfg.fingerprint.n_fingerprints(ds.waveforms.shape[1]))
    runs = [detect_events(ds.waveforms, cfg, scfg=scfg, keep_pairs=True,
                          device=d)[3] for d in (dev, "cpu")]
    pairs = [r.pop("_station_pairs") for r in runs]
    same = [_triplets(a) == _triplets(b) for a, b in zip(*pairs)]
    out = {"synth": PARITY_SYNTH, "detections": runs[0]["detections"],
           "pairs_emitted": runs[0]["drops"]["pairs_emitted"],
           "stats_equal_cpu": runs[0] == runs[1], "pair_sets_equal": same}
    print("paper_parity", json.dumps(out), flush=True)
    _need(runs[0]["drops"]["pairs_emitted"] > 0,
          "the paper-width parity trace emitted no pairs")
    _need(out["stats_equal_cpu"] and all(same),
          "paper widths: the card's result differs from the CPU path's")
    return out


def paper_phase(ds, n_fp: int, dev) -> dict:
    """The paper configuration end to end, launches counted."""
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core.detect import detect_events, recall_against_truth
    from repro_torch.kernels import ops
    cfg = fast_seismic.config()
    fcfg = cfg.fingerprint
    scfg = fast_seismic.batch_replay_config(n_fp)
    n_blocks = -(-n_fp // scfg.block_fingerprints)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    det, events, times, stats = detect_events(ds.waveforms, cfg, scfg=scfg,
                                              device=dev)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    rec = recall_against_truth(det, events, ds, fcfg)
    out = {
        "stations": ds.waveforms.shape[0], "hours": PAPER_HOURS,
        "fingerprints_per_station": n_fp, "blocks": n_blocks,
        "stage_s": {"fingerprint_stats": times.fingerprint_s,
                    "hashgen": times.hashgen_s,
                    "fused_step": times.fused_step_s,
                    "host_tail": times.align_s},
        "wall_s": wall,
        "fingerprints_per_s": ds.waveforms.shape[0] * n_fp / wall,
        "replay_fingerprints_per_s":
            ds.waveforms.shape[0] * n_fp / times.fused_step_s,
        "detections": stats["detections"], "recall": rec,
        "drops": stats["drops"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "pairs_emitted_per_station": [
            stats[f"station{st}_qc"]["pairs_emitted"]
            for st in range(ds.waveforms.shape[0])],
    }
    print("paper", json.dumps(out), flush=True)
    for name in BATCH_KERNELS:
        count = launches[name]
        _need(count >= n_blocks,
              f"{name} launched {count} times on the main path, fewer than "
              f"its {n_blocks} blocks")
    _need(stats["drops"]["raw_collisions"] > 0,
          "the index search found no collisions at all")
    _need(all(det[k].shape == det["valid"].shape for k in det),
          "detections columns differ in shape")
    _need(sum(stats[f"station{st}_pairs"] for st in range(len(events)))
          <= stats["drops"]["pairs_emitted"],
          "more post-filter pairs than the replay emitted")
    return out


def _stream_pairs(det, station: int = 0) -> set:
    """One station's post-filter (idx1, idx2) pairs after a stream."""
    _, pairs, _ = det.stations[station].finalize()
    return {p[:2] for p in _triplets(pairs)}


def _event_rows(ev) -> list:
    from repro_torch.stream.engine import events_to_rows
    return sorted(map(tuple, events_to_rows(ev).tolist()))


def _stream_run(cfg, scfg, wf, pushes, dev, med_mad=None, n_stations=1):
    """A detector on ``dev`` fed ``wf`` (T,) or (S, T) in ``pushes`` equal
    chunks; returns the detector after its last push (not flushed)."""
    import numpy as np
    from repro_torch.stream import StreamingDetector
    det = StreamingDetector(cfg, scfg, n_stations=n_stations,
                            med_mad=med_mad, device=dev)
    for chunk in np.array_split(wf, pushes, axis=-1):
        det.push(chunk)
    return det


def stream_golden_phase(dev) -> dict:
    """The stream golden on the card: the golden test's four runs on
    ``tests/golden/stream_pairs.json``'s trace (two-pass statistics
    computed on the CPU), then the bounded 3-station smoke stream, card
    against the port's CPU path."""
    import dataclasses
    import torch
    from repro_torch.configs import fast_seismic as fs
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.core import fingerprint as fp_mod
    from repro_torch.kernels import ops
    gold = json.loads((ROOT / "tests" / "golden" / "stream_pairs.json")
                      .read_text())
    cfg = fs.smoke_config()
    wf = make_dataset(SynthConfig(**gold["synth"])).waveforms[0]
    two_pass = fp_mod.mad_stats(fp_mod.coeffs_from_waveform(
        torch.as_tensor(wf), cfg.fingerprint), 1.0)
    want = {tuple(p) for p in gold["stream_two_pass_pairs"]}
    smoke = dataclasses.replace(fs.stream_smoke_config(), reservoir_rows=2048)
    runs = {"two_pass": (smoke, two_pass), "self_stats": (smoke, None),
            "deferred": (fs.stream_deferred_smoke_config(), None),
            "compact_verify": (fs.stream_compact_smoke_config(), two_pass)}
    out = {}
    for name, (scfg, mm) in runs.items():
        ops.reset_launches()
        det = _stream_run(cfg, scfg, wf, gold["n_chunks"], dev, mm)
        got = _stream_pairs(det)
        out[name] = {"pairs": len(got), "launches": dict(ops.LAUNCHES),
                     "drops": det.telemetry.drop_breakdown()}
        if name == "self_stats":
            cpu = _stream_pairs(_stream_run(cfg, scfg, wf, gold["n_chunks"],
                                            "cpu"))
            out[name]["equal_cpu"] = got == cpu
            _need(got == cpu, "stream golden: self-stats pairs on the card "
                  "differ from the CPU path's")
        else:
            out[name]["equal_golden"] = got == want
            _need(got == want, f"stream golden: {name} pairs differ from "
                  f"stream_two_pass_pairs: {sorted(got ^ want)}")
        _need(out[name]["drops"]["overflow_pairs"] == 0,
              f"stream golden: {name} overflowed its compaction")
        _need(all(ops.LAUNCHES[k] > 0 for k in BATCH_KERNELS[:3]),
              f"stream golden: {name} missed a kernel: {ops.LAUNCHES}")
    _need(out["compact_verify"]["launches"]["jaccard_popcount"] > 0,
          "stream golden: compact + verify never launched jaccard_popcount")
    # bounded mode: sliding window + rolling filter + live association
    ds = make_dataset(SynthConfig(duration_s=600.0, n_stations=3,
                                  n_sources=2, events_per_source=5,
                                  event_snr=3.0, seed=11))
    bounded = []
    for d in (dev, "cpu"):
        det = _stream_run(cfg, fs.stream_bounded_smoke_config(),
                          ds.waveforms, 10, d, n_stations=3)
        dets, events, stats = det.finalize()
        bounded.append({
            "alerts": [a.tolist() for a in det.alerts],
            "detections": {k: v.cpu().tolist() for k, v in dets.items()},
            "events": [_event_rows(e) for e in events],
            "n_detections": stats["detections"]})
    out["bounded"] = {"alerts": sum(len(a) for a in bounded[0]["alerts"]),
                      "detections": bounded[0]["n_detections"],
                      "equal_cpu": bounded[0] == bounded[1]}
    print("stream_golden", json.dumps(out), flush=True)
    _need(out["bounded"]["equal_cpu"],
          "bounded stream: alerts / detections on the card differ from the "
          "CPU path's")
    _need(out["bounded"]["alerts"] >= 1 and out["bounded"]["detections"] >= 1,
          "bounded stream: no alert or no detection")
    return out


def _stream_record(det, dets, events, stats) -> dict:
    """What a finished stream leaves, to hold one run against another:
    per-station stats (wall times dropped), events, every alert row,
    detections and the drop counters."""
    import numpy as np
    stats = json.loads(json.dumps(stats))
    for s in stats["ingest"]:
        for k in WALL_KEYS:
            s.pop(k)
    return {"stats": stats,
            "events": [_event_rows(e) for e in events],
            "alerts": (np.concatenate(det.alerts).tolist() if det.alerts
                       else []),
            "detections": {k: v.cpu().tolist() for k, v in dets.items()},
            "drops": det.telemetry.drop_breakdown()}


def stream_paper_phase(ds, dev) -> tuple[dict, object, dict]:
    """The paper streaming service on phase 5's 4 stations × 24 h:
    ``fast_seismic.config()`` with ``stream_config()``, pooled, pushed in
    ``STREAM_CHUNK``-sample chunks, self-computed statistics, launch
    counters zeroed just before and read just after. Returns the report,
    the finished detector (phase 16 serves its pool) and its record
    (phase 17 holds a restored stream to it)."""
    import numpy as np
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.kernels import ops
    from repro_torch.stream import StreamingDetector
    cfg, scfg = fast_seismic.config(), fast_seismic.stream_config()
    fcfg = cfg.fingerprint
    wave = ds.waveforms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    det = StreamingDetector(cfg, scfg, n_stations=wave.shape[0], device=dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    walls = []
    for a in range(0, wave.shape[1], STREAM_CHUNK):
        t = time.perf_counter()
        det.push(wave[:, a:a + STREAM_CHUNK])
        walls.append(time.perf_counter() - t)
    t = time.perf_counter()
    dets, events, stats = det.finalize()
    finalize_s = time.perf_counter() - t
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    blocks = det.stations[0].stats.blocks
    n_fp = sum(stats[f"station{i}_fingerprints"]
               for i in range(wave.shape[0]))
    spans = det.telemetry.tracer.summary()
    out = {
        "stations": wave.shape[0], "hours": wave.shape[1] / fcfg.fs / 3600,
        "chunk_samples": STREAM_CHUNK, "pushes": len(walls),
        "blocks": blocks, "setup_s": setup_s, "wall_s": wall,
        "finalize_s": finalize_s,
        "real_time_factor": wave.shape[1] / fcfg.fs / wall,
        "fingerprints_per_s": n_fp / wall,
        "push_ms_p50": float(np.percentile(walls, 50)) * 1e3,
        "push_ms_p99": float(np.percentile(walls, 99)) * 1e3,
        "push_ms_max": max(walls) * 1e3,
        "slowest_push": int(np.argmax(walls)),
        "span_s": {k: spans.get(k, {"total_s": 0.0})["total_s"]
                   for k in ("ingest", "dup_hash", "fused_step",
                             "host_tail")},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "pairs_per_station": [stats[f"station{i}_pairs"]
                              for i in range(wave.shape[0])],
        "events_per_station": [stats[f"station{i}_events"]
                               for i in range(wave.shape[0])],
        "alerts": stats["alerts"], "detections": stats["detections"],
        "drops": det.telemetry.drop_breakdown(),
        "quality": stats["quality"],
    }
    print("stream_paper", json.dumps(out), flush=True)
    for name in BATCH_KERNELS:
        _need(launches[name] >= blocks,
              f"stream: {name} launched {launches[name]} times, fewer than "
              f"the {blocks} pooled blocks")
    _need(out["drops"]["raw_collisions"] > 0,
          "stream: the index search found no collisions at all")
    _need(n_fp == wave.shape[0] * fcfg.n_fingerprints(wave.shape[1]),
          f"stream: {n_fp} fingerprints, not every station's whole trace")
    _need(all(dets[k].shape == dets["valid"].shape for k in dets),
          "stream: detections columns differ in shape")
    return out, det, _stream_record(det, dets, events, stats)


def stream_parity_phase(ds, dev) -> dict:
    """The paper stream in parity mode (``stream_config()`` with
    ``filter_window_fingerprints=0``), given the statistics
    ``detect_events`` computes, against ``detect_events`` on the same
    ``StreamConfig``: per-station post-filter pair triplets and events
    equal."""
    import dataclasses
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import detect
    cfg = fast_seismic.config()
    scfg = dataclasses.replace(fast_seismic.stream_config(),
                               filter_window_fingerprints=0)
    wave = torch.as_tensor(ds.waveforms, device=dev)
    meds, mads = detect.station_stats(wave, cfg.fingerprint)
    del wave
    t0 = time.perf_counter()
    _, b_events, _, b_stats = detect.detect_events(
        ds.waveforms, cfg, scfg=scfg, keep_pairs=True, device=dev)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    det = _stream_run(cfg, scfg, ds.waveforms,
                      -(-ds.waveforms.shape[1] // STREAM_CHUNK), dev,
                      (torch.stack(meds), torch.stack(mads)),
                      n_stations=ds.waveforms.shape[0])
    det.flush()
    stream_s = time.perf_counter() - t0
    same_pairs, same_events, n_pairs = [], [], []
    for i, st in enumerate(det.stations):
        ev, pairs, _ = st.finalize()
        got = _triplets(pairs)
        same_pairs.append(got == _triplets(b_stats["_station_pairs"][i]))
        same_events.append(_event_rows(ev) == _event_rows(b_events[i]))
        n_pairs.append(len(got))
    out = {"batch_s": batch_s, "stream_s": stream_s,
           "pairs_per_station": n_pairs, "pairs_equal": same_pairs,
           "events_equal": same_events,
           "stream_blocks": det.stations[0].stats.blocks}
    print("stream_parity", json.dumps(out), flush=True)
    _need(all(same_pairs) and all(same_events),
          "stream parity: the stream's pairs or events differ from "
          "detect_events' on the same StreamConfig")
    return out


def _serve_windows(ds, fcfg, n: int, seed: int) -> list:
    """``n`` request windows of ``SERVE_WINDOW_S`` seconds, station by
    station in turn, each starting on a corpus fingerprint (a random one,
    from ``seed``): (station, first fingerprint id, samples)."""
    import numpy as np
    wave = ds.waveforms
    win = int(SERVE_WINDOW_S * fcfg.fs)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, (wave.shape[1] - win) // fcfg.lag_samples, n)
    return [(i % wave.shape[0], int(f),
             wave[i % wave.shape[0],
                  f * fcfg.lag_samples:f * fcfg.lag_samples + win])
            for i, f in enumerate(starts)]


def serve_phase(det, ds, dev) -> tuple[dict, dict]:
    """Detection serving at full width over phase 7's pool (4 stations ×
    24 h, ``pool_serving_state()``), ``serve_config()`` (32 slots, queue
    1,024, top-k 64): a burst of ``SERVE_REQUESTS`` 60 s windows, then
    ``SERVE_OVERLOAD`` more at once, launch counters zeroed just before
    and read just after (``stft_mag``, ``haar2d`` and ``minmax_hash`` once
    a dispatched tick, none on an idle tick). Then the share of query
    fingerprints that find their own source fingerprint in their
    station's top-k, the CPU path's match lists on the same state for the
    first tick's requests (every slot), the first tick's live work (valid
    query fingerprints a slot, raw collisions and thresholded candidates
    a (station, slot) row), and ``stft_mag``, ``haar2d`` and
    ``minmax_hash`` at the serving batch's shapes against their plain
    versions, timed and bounded. Returns the report and the kernels'
    serving-shape entries by name."""
    import numpy as np
    import torch
    from repro_torch import utils
    from repro_torch.configs import fast_seismic
    from repro_torch.core import fingerprint as fp_mod
    from repro_torch.core import lsh as lsh_mod
    from repro_torch.kernels import haar2d as haar_k
    from repro_torch.kernels import minmax_hash as mm_k
    from repro_torch.kernels import ops
    from repro_torch.kernels import stft_mag as stft_k
    from repro_torch.launch.serve_detect import (QueryRequest,
                                                 ServeDetectEngine)
    from repro_torch.stream import index as index_mod
    from repro_torch.stream.index import IndexState
    cfg, scfg, sv = det.cfg, det.scfg, fast_seismic.serve_config()
    fcfg = cfg.fingerprint
    state, med, mad = det.pool_serving_state()

    def engine(d, n_slots=sv.n_slots, st=state, mm=(med, mad)):
        return ServeDetectEngine(cfg, scfg, st, mm, n_slots=n_slots,
                                 top_k=sv.top_k, max_queue=sv.max_queue,
                                 device=d)

    def requests(windows):
        return [QueryRequest(rid=i, window=w)
                for i, (_, _, w) in enumerate(windows)]

    burst = _serve_windows(ds, fcfg, SERVE_REQUESTS, 0)
    overload = _serve_windows(ds, fcfg, SERVE_OVERLOAD, 1)
    engine(dev).run(requests(burst[:sv.n_slots]))     # warm-up, not counted
    eng = engine(dev)
    reqs, more = requests(burst), requests(overload)
    torch.cuda.synchronize()
    ops.reset_launches()
    first = eng.run(reqs)
    ticks_first = eng.dispatches
    second = eng.run(more)
    idle = eng.tick()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    # own-fingerprint recall: query fingerprint i of a window starting at
    # corpus fingerprint f is corpus fingerprint f + i of its station
    n_q = (int(SERVE_WINDOW_S * fcfg.fs) - fcfg.window_samples) \
        // fcfg.lag_samples + 1
    found = 0
    for (st, f, _), r in zip(burst, reqs):
        ids = {i for s, i, _ in r.matches if s == st}
        found += sum(f + i in ids for i in range(n_q))
    # the CPU path on a copy of the same serving state, over the first
    # tick's requests: every slot of the batch
    cpu_state = IndexState(**{k: getattr(state, k).cpu()
                              for k in IndexState.__dataclass_fields__})
    cpu_reqs = requests(burst[:sv.n_slots])
    t0 = time.perf_counter()
    engine("cpu", sv.n_slots, cpu_state,
           (med.cpu(), mad.cpu())).run(cpu_reqs)
    cpu_s = time.perf_counter() - t0
    equal_cpu = [a.matches == b.matches for a, b in zip(reqs, cpu_reqs)]
    out = {
        "stations": state.n_stations, "slots": sv.n_slots,
        "top_k": sv.top_k, "max_queue": sv.max_queue,
        "window_s": SERVE_WINDOW_S, "query_fingerprints": n_q,
        "burst": first, "overload": second,
        "dispatches": eng.dispatches, "ticks": eng.ticks,
        "idle_tick_served": idle, "launches": launches,
        "self_match_share": found / (n_q * len(burst)),
        "cpu_requests": len(cpu_reqs), "cpu_s": cpu_s,
        "equal_cpu": all(equal_cpu),
        "matches_first": len(reqs[0].matches),
    }
    # the first tick's batch (every slot's first block and fingerprint
    # mask), after the counts: stft_mag and haar2d at its shapes
    first_blocks = [eng._split_blocks(w)[0] for _, _, w in burst[:sv.n_slots]]
    blocks = torch.as_tensor(np.stack([b for b, _ in first_blocks]),
                             device=dev)
    slot_valid = torch.as_tensor(np.stack([m for _, m in first_blocks]),
                                 device=dev)
    c = fp_mod._consts(fcfg, dev)
    args = (blocks, c["window"], c["dft_r"], c["dft_i"], fcfg.stft_hop)
    spec = stft_k.plain(*args)
    imgs = fp_mod.spectral_images(spec, fcfg).reshape(
        -1, fcfg.img_freq, fcfg.img_time).contiguous()
    th, tw, _ = ops.haar_mats(fcfg.img_freq, fcfg.img_time, dev)
    # the library calls of kernel_phase at these shapes: one matmul of
    # the windowed frames by both DFT matrices, one einsum of the images
    # by the two transform matrices
    frames = blocks[:, :(spec.shape[1] - 1) * fcfg.stft_hop
                    + fcfg.stft_len].unfold(-1, fcfg.stft_len, fcfg.stft_hop)
    xw = (frames * c["window"]).reshape(-1, fcfg.stft_len).contiguous()
    dft_cat = torch.cat([c["dft_r"], c["dft_i"]], dim=1).contiguous()
    shapes = {
        "stft_mag": _shape_case(lambda: ops.stft_mag(*args),
                                lambda: stft_k.plain(*args),
                                cost.stft_mag(*blocks.shape, fcfg.stft_len,
                                              spec.shape[2], fcfg.stft_hop),
                                lambda: torch.matmul(xw, dft_cat)),
        "haar2d": _shape_case(lambda: ops.haar2d(imgs),
                              lambda: haar_k.plain(imgs, th, tw),
                              cost.haar2d(*imgs.shape),
                              lambda: torch.einsum("ij,njk,lk->nil", th,
                                                   imgs, tw))}
    del frames, xw
    # its live work: a (station, slot) row holds t·N·C candidate slots
    _, packed = fp_mod.binarize_coeffs(
        fp_mod.coeffs_from_waveform(blocks, fcfg), fcfg,
        (med[:, None], mad[:, None]))                    # (S, Q, N, W)
    s_, q_, n_ = packed.shape[:3]
    sigs = lsh_mod.signatures(packed, eng.mappings, cfg.lsh,
                              valid=slot_valid.expand(s_, -1, -1))
    qids = (index_mod.INVALID - 1 - n_) + torch.arange(
        n_, dtype=torch.int32, device=dev)
    pairs, qc = index_mod.query(state, sigs, qids, cfg.lsh, counts=1)
    per_row = pairs.valid.sum(dim=-1).float()
    t_, c_ = state.sig.shape[1], state.sig.shape[-1]
    out["first_tick_live"] = {
        "valid_fingerprints_per_slot": int(slot_valid.sum(dim=-1).max()),
        "block_fingerprints": n_,
        "candidate_slots_per_row": t_ * n_ * c_,
        "raw_collisions_per_row": float(qc[:, 0].sum()) / (s_ * q_),
        "pairs_per_row_mean": float(per_row.mean()),
        "pairs_per_row_max": int(per_row.max())}
    # minmax_hash at the serving batch's shape: the packed fingerprints of
    # every slot of every station
    packed = packed.reshape(-1, packed.shape[-1]).contiguous()
    mp = eng.mappings
    n, words = packed.shape
    h = mp.shape[1]
    got = ops.minmax_hash(packed, mp)
    want = mm_k.plain_raw(packed, mp)
    torch.cuda.synchronize()
    exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    nnz = int(utils.popcount(packed).sum())
    dims = int(utils.unpack_bits(packed, 32 * words).any(dim=0).sum())
    bound, by = cost.bound_ms(cost.minmax_hash(n, words, h, nnz=nnz,
                                               dims=dims))
    ms = _time_ms(lambda: ops.minmax_hash(packed, mp))
    rate = _minmax_rate("minmax_hash_serve", packed, mp, nnz, ms)
    shapes["minmax_hash"] = {
        "shape": [n, words, h], "set_bits": nnz, "exact": exact,
        "ms": ms, "plan": rate["plan"],
        **{k: v for k, v in rate.items() if k.endswith("_tb_s")},
        "plain_ms": _time_ms(lambda: mm_k.plain_raw(packed, mp),
                             iters=3, warmup=1),
        "bound_ms": bound, "bound_by": by}
    out["serving_shapes"] = shapes
    if "--profile" in sys.argv[1:]:
        # three full ticks of the burst's windows under the profiler
        from torch.profiler import ProfilerActivity, profile
        prof_eng = engine(dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_eng.run(requests(burst[:sv.n_slots] * 3))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["profile"] = {"ticks": prof_eng.dispatches,
                          **_device_breakdown(prof, wall,
                                              "serve_profile.txt")}
    print("serve", json.dumps(out), flush=True)
    n_disp = eng.dispatches
    for name in SERVE_KERNELS:
        _need(launches[name] == n_disp,
              f"serve: {name} launched {launches[name]} times in "
              f"{n_disp} dispatched ticks")
    _need(launches["minmax_sig_buckets"] == 0
          and launches["jaccard_popcount"] == 0,
          f"serve: a kernel of the stream launched: {launches}")
    _need(idle == 0 and eng.ticks == n_disp + 1,
          "serve: an idle tick served or a tick did not dispatch")
    _need(first["served"] == SERVE_REQUESTS and first["shed"] == 0
          and ticks_first == -(-SERVE_REQUESTS // sv.n_slots),
          f"serve: the burst was not served in full: {first}")
    _need(second["shed"] == SERVE_OVERLOAD - sv.max_queue
          and second["served"] == sv.max_queue,
          f"serve: the overload did not shed deterministically: {second}")
    _need(all(equal_cpu), "serve: the card's match lists differ from the "
          f"CPU path's: {equal_cpu}")
    _need(out["self_match_share"] >= 0.9,
          f"serve: only {out['self_match_share']:.3f} of the query "
          "fingerprints found their own source fingerprint")
    _need(exact and rate["plan"]["tiled"],
          "serve: minmax_hash at the serving shape is not bit-exact or "
          "did not take the tiled plan")
    return out, shapes


def snapshot_phase(ds, dev, want: dict, tmp: str) -> dict:
    """Phase 7's stream again to its halfway push, snapshotted into
    ``tmp`` (size on disk, write time; the elastic phase restores it
    again), restored into a new detector on the card (restore time), and
    pushed to the end: the record (per-station stats, events, alerts,
    detections, drops) must equal phase 7's uninterrupted run."""
    import pathlib as pl
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.stream import StreamingDetector
    cfg, scfg = fast_seismic.config(), fast_seismic.stream_config()
    wave = ds.waveforms
    starts = list(range(0, wave.shape[1], STREAM_CHUNK))
    half = len(starts) // 2
    det = StreamingDetector(cfg, scfg, n_stations=wave.shape[0], device=dev)
    for a in starts[:half]:
        det.push(wave[:, a:a + STREAM_CHUNK])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.snapshot(tmp, step=half)
    write_s = time.perf_counter() - t0
    files = [f for f in pl.Path(tmp).rglob("*") if f.is_file()]
    size = sum(f.stat().st_size for f in files)
    del det
    t0 = time.perf_counter()
    restored, step = StreamingDetector.restore(tmp, cfg, scfg, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a in starts[half:]:
        restored.push(wave[:, a:a + STREAM_CHUNK])
    dets, events, stats = restored.finalize()
    rest_s = time.perf_counter() - t0
    got = _stream_record(restored, dets, events, stats)
    same = {k: got[k] == want[k] for k in got}
    out = {"snapshot_push": half, "step": step, "bytes": size,
           "files": len(files), "write_s": write_s, "restore_s": restore_s,
           "pushes_after": len(starts) - half, "rest_s": rest_s,
           "pooled": restored.pooled, "equal": same}
    print("snapshot", json.dumps(out), flush=True)
    _need(all(same.values()), f"snapshot: the restored stream differs from "
          f"the uninterrupted run: {same}")
    _need(step == half and restored.pooled, "snapshot: wrong step or pool")
    return out


def _located_golden():
    """``tests/golden/located_scenario.json`` (written from the JAX
    reference by ``tools/located_golden.py``) and the port's configuration
    of its scenario, rebuilt from the file."""
    from repro_torch import core
    from repro_torch.core.locate import LocateConfig
    gold = json.loads((ROOT / "tests" / "golden" / "located_scenario.json")
                      .read_text())
    cfg = core.DetectConfig(
        fingerprint=core.FingerprintConfig(**gold["fingerprint"]),
        lsh=core.LSHConfig(**gold["lsh"]),
        align=core.AlignConfig(**gold["align"]),
        locate=LocateConfig(**gold["locate"]))
    return gold, cfg


def _host_dict(det: dict) -> dict:
    import torch
    return {k: v.cpu().numpy() if torch.is_tensor(v) else v
            for k, v in det.items()}


def located_batch_phase(dev) -> dict:
    """The located batch scenario at the paper's location width
    (``locate_config()``: 12 × 12 grid, two refinements, the 2-lag gate)
    on the card: ``tests/golden/located_scenario.json``'s 6-station,
    600 s ``physical_geometry`` network, clean (location off), pairwise
    (located, ungated) and gated. Launch counters zeroed just before the
    three runs and read just after; the migration stack's wall is taken
    around each ``locate_detections`` pass (one device→host copy each).
    Every associated group's integer columns must equal the golden's,
    origins within one finest cell, magnitudes within 1e-5, the summary
    counts equal and the median origin error within 0.01 km."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import locate as locate_mod
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.core.detect import detect_events
    from repro_torch.kernels import ops
    sys.path.insert(0, str(ROOT))
    from tools.located_golden import group_rows, summarize
    gold, cfg = _located_golden()
    clean = make_dataset(SynthConfig(**gold["synth"]))
    noisy = make_dataset(SynthConfig(
        **gold["synth"], repeating_noise_stations=tuple(
            gold["noisy_stations"])))
    stack_s = [0.0]
    inner = locate_mod.locate_detections

    def timed(*a, **k):
        t = time.perf_counter()
        out = inner(*a, **k)
        stack_s[0] += time.perf_counter() - t
        return out

    runs, walls, stacks = {}, {}, {}
    locate_mod.locate_detections = timed
    try:
        # one untimed run first: the kernels' first launches at these
        # shapes, outside the walls and the counts
        detect_events(clean.waveforms, cfg, device=dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        for name, wf, loc in (
                ("golden", clean.waveforms, None),
                ("pairwise", noisy.waveforms, dataclasses.replace(
                    cfg.locate, reject_inconsistent=False)),
                ("gated", noisy.waveforms, cfg.locate)):
            stack_s[0] = 0.0
            t0 = time.perf_counter()
            det, _, _, stats = detect_events(
                wf, dataclasses.replace(cfg, locate=loc), device=dev,
                station_xy=noisy.station_xy if loc else None)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            stacks[name] = stack_s[0]
            runs[name] = (_host_dict(det), stats)
        launches = dict(ops.LAUNCHES)
    finally:
        locate_mod.locate_detections = inner
    summary = summarize(runs["golden"][0], runs["pairwise"][0],
                        runs["gated"][0], runs["gated"][1], cfg.align,
                        noisy.source_xy, cfg.locate.coarse_cell_km)
    tol = cfg.locate.cell_km + 1e-4       # one finest cell in float32
    checks, worst = {}, {}
    for name in runs:
        got = group_rows(runs[name][0], name != "golden")
        want = gold["runs"][name]
        ok = set(got) == set(want)
        for k in want:
            if k in ("x_km", "y_km", "magnitude"):
                g = np.array([np.nan if x is None else x for x in got[k]])
                w = np.array([np.nan if x is None else x for x in want[k]])
                d = np.abs(g - w)[~np.isnan(w)]
                worst[f"{name}_{k}"] = float(d.max()) if d.size else 0.0
                ok &= bool(np.array_equal(np.isnan(g), np.isnan(w)) and
                           (d <= (1e-5 if k == "magnitude" else tol)).all())
            else:
                ok &= got[k] == want[k]
        checks[name] = ok
    same_summary = all(
        abs(summary[k] - v) <= 0.01 if k.startswith("median_origin_err")
        else summary[k] == v for k, v in gold["summary"].items())
    out = {"stations": gold["synth"]["n_stations"],
           "duration_s": gold["synth"]["duration_s"],
           "grid": cfg.locate.grid_n, "refine_levels":
           cfg.locate.refine_levels, "wall_s": walls, "stack_s": stacks,
           "stack_share": {k: stacks[k] / walls[k] for k in walls},
           "launches": launches, "summary": summary,
           "max_diff": worst, "groups_equal": checks,
           "summary_equal": same_summary}
    print("located_batch", json.dumps(out), flush=True)
    _need(all(checks.values()), f"located batch: groups differ from "
          f"tests/golden/located_scenario.json: {checks} {worst}")
    _need(same_summary, f"located batch: summary {summary} differs from "
          f"the golden's {gold['summary']}")
    for name in BATCH_KERNELS[:3]:
        _need(launches[name] >= 3, f"located batch: {name} launched "
              f"{launches[name]} times in three replays")
    return out


def locate_stack_phase(dev) -> dict:
    """``locate_groups`` with ``locate_config()`` on 4,096 groups × 16
    stations: onsets from known origins through ``travel_time_lags``
    (lag noise, a quarter of the stations absent), on the card and on the
    CPU. Origins within one finest cell of the CPU's, ``n_used`` and
    ``consistent`` equal; the card's time (CUDA events) beside it."""
    import numpy as np
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import locate
    from repro_torch.kernels import ops
    cfg = fast_seismic.locate_config()
    g_n, s_n, lag_s = 4096, 16, np.float32(2.0)
    rng = np.random.default_rng(20)
    xy = torch.as_tensor(rng.uniform(2.5, 47.5, (s_n, 2)),
                         dtype=torch.float32)
    src = torch.as_tensor(rng.uniform(0.0, 50.0, (g_n, 2)),
                          dtype=torch.float32)
    tt = locate.travel_time_lags(src, xy, cfg, lag_s).numpy()
    on = np.round(300 + tt + rng.normal(0, 0.5, tt.shape)).astype(np.int32)
    on[rng.random(on.shape) < 0.25] = 2**31 - 1
    w = torch.as_tensor(rng.uniform(0.05, 1.0, s_n), dtype=torch.float32)
    args = {d: (torch.as_tensor(on, device=d), w.to(d), xy.to(d))
            for d in (dev, "cpu")}
    ops.reset_launches()
    card = locate.locate_groups(*args[dev], lag_s, cfg)
    torch.cuda.synchronize()
    launches = sum(ops.LAUNCHES.values())
    t0 = time.perf_counter()
    cpu = locate.locate_groups(*args["cpu"], lag_s, cfg)
    cpu_s = time.perf_counter() - t0
    card = {k: v.cpu().numpy() for k, v in card.items()}
    cpu = {k: v.numpy() for k, v in cpu.items()}
    xy_diff = float(np.abs(card["xy"] - cpu["xy"]).max())
    err = np.linalg.norm(card["xy"] - src.numpy(), axis=1)
    out = {"groups": g_n, "stations": s_n, "grid": cfg.grid_n,
           "refine_levels": cfg.refine_levels,
           "candidates_per_level": cfg.grid_n ** 2,
           "ms": _time_ms(lambda: locate.locate_groups(*args[dev], lag_s,
                                                       cfg), iters=10),
           "cpu_s": cpu_s, "kernel_launches": launches,
           "max_xy_diff_km": xy_diff, "cell_km": cfg.cell_km,
           "n_used_equal": bool(np.array_equal(card["n_used"],
                                               cpu["n_used"])),
           "consistent_equal": bool(np.array_equal(card["consistent"],
                                                   cpu["consistent"])),
           "consistent_share": float(cpu["consistent"].mean()),
           "median_origin_err_km": float(np.median(err))}
    print("locate_stack", json.dumps(out), flush=True)
    _need(xy_diff <= cfg.cell_km + 1e-4 and out["n_used_equal"]
          and out["consistent_equal"], f"locate stack: card differs from "
          f"the CPU: {out}")
    return out


def _located_stream(cfg, scfg, ds, dev, upto=None, det=None):
    """The located bounded stream on ``dev`` in ``STREAM_CHUNK`` pushes
    (from ``det``'s position when given, up to push ``upto``)."""
    from repro_torch.stream import StreamingDetector
    if det is None:
        det = StreamingDetector(cfg, scfg, n_stations=ds.waveforms.shape[0],
                                station_xy=ds.station_xy, device=dev)
    starts = list(range(0, ds.waveforms.shape[1], STREAM_CHUNK))
    done = det.stations[0].stats.chunks
    for a in starts[done:upto]:
        det.push(ds.waveforms[:, a:a + STREAM_CHUNK])
    return det


def _located_record(det) -> dict:
    """A finished located stream: alert rows, located detections (NaN as
    None), per-station events and stats, the locate counters."""
    import numpy as np
    alerts = np.concatenate(det.alerts) if det.alerts else np.zeros((0, 8))
    dets, events, stats = det.finalize()
    stats = json.loads(json.dumps(stats, default=float))
    for s in stats["ingest"]:
        for k in WALL_KEYS:
            s.pop(k)
    view = det.telemetry.locate_view()
    return {"alerts": alerts.astype(np.int64),
            "detections": _host_dict(dets),
            "events": [_event_rows(e) for e in events], "stats": stats,
            "locate": {k: view[k] for k in ("passes", "groups", "located",
                                           "moveout_rejected")}}


def _located_equal(a: dict, b: dict, loc_tol: int, tol: float) -> bool:
    """Two located records equal: alert rows exact but for ``loc_tol``
    milli-km in the location columns, detections' integer columns exact
    and float columns within ``tol`` (NaN where the other is NaN)."""
    import numpy as np
    x, y = a["alerts"], b["alerts"]
    if x.shape != y.shape or not np.array_equal(np.delete(x, [5, 6], 1),
                                                np.delete(y, [5, 6], 1)):
        return False
    if x.size and np.abs(x[:, 5:7] - y[:, 5:7]).max() > loc_tol:
        return False
    if set(a["detections"]) != set(b["detections"]):
        return False
    for k, u in a["detections"].items():
        v = b["detections"][k]
        if u.dtype.kind == "f":
            if not (np.array_equal(np.isnan(u), np.isnan(v)) and np.all(
                    np.abs(u - v)[~np.isnan(v)] <= tol)):
                return False
        elif not np.array_equal(u, v):
            return False
    return all(a[k] == b[k] for k in ("events", "stats", "locate"))


def located_stream_phase(dev, tmp: str) -> dict:
    """The located stream: ``located_smoke_config()`` with
    ``stream_bounded_smoke_config()`` on the 4-station, 900 s, seed-11
    ``physical_geometry`` trace in 6,000-sample pushes, launch counters
    zeroed just before and read just after the card's run. The card must
    equal the port's CPU path (alert rows within ±1 milli-km in the
    location columns and exact elsewhere; detections' integer columns
    exact, floats within 1e-4). Then the card's stream is snapshotted at
    its halfway push into ``tmp``, restored on the card and finished:
    the amplitude timelines restore bin for bin and the result equals the
    uninterrupted card run's exactly."""
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.kernels import ops
    from repro_torch.stream import StreamingDetector
    cfg = fast_seismic.located_smoke_config()
    scfg = fast_seismic.stream_bounded_smoke_config()
    ds = make_dataset(SynthConfig(duration_s=900.0, n_stations=4,
                                  n_sources=2, events_per_source=6,
                                  event_snr=3.0, seed=11,
                                  physical_geometry=True))
    _located_stream(cfg, scfg, ds, dev)          # first launches, untimed
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    det = _located_stream(cfg, scfg, ds, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    blocks = det.stations[0].stats.blocks
    card = _located_record(det)
    cpu = _located_record(_located_stream(cfg, scfg, ds, "cpu"))
    pushes = det.stations[0].stats.chunks
    half = _located_stream(cfg, scfg, ds, dev, upto=pushes // 2)
    amps = [dict(d) for d in half._amp]
    half.snapshot(tmp, step=pushes // 2)
    restored, step = StreamingDetector.restore(
        tmp, cfg, scfg, station_xy=ds.station_xy, device=dev)
    same_amps = restored._amp == amps
    resumed = _located_record(_located_stream(cfg, scfg, ds, dev,
                                              det=restored))
    out = {"stations": 4, "duration_s": 900.0, "pushes": pushes,
           "blocks": blocks, "wall_s": wall, "launches": launches,
           "alerts": int(card["alerts"].shape[0]),
           "located_alerts": int((card["alerts"][:, 5] >= 0).sum()),
           "detections": card["stats"]["detections"],
           "locate": card["locate"],
           "equal_cpu": _located_equal(card, cpu, 1, 1e-4),
           "snapshot_step": step,
           "amp_bins": [len(d) for d in amps], "amps_equal": same_amps,
           "restored_equal": _located_equal(resumed, card, 0, 0.0)}
    print("located_stream", json.dumps(out), flush=True)
    _need(out["equal_cpu"], "located stream: the card differs from the CPU")
    _need(same_amps and out["restored_equal"], "located stream: the "
          "restored stream differs from the uninterrupted one")
    _need(out["located_alerts"] >= 1 and card["locate"]["passes"] >= 2,
          f"located stream: no located alert: {out}")
    for name in BATCH_KERNELS[:3]:
        _need(launches[name] >= blocks, f"located stream: {name} launched "
              f"{launches[name]} times for {blocks} pooled blocks")
    return out


def serve_locate_phase(dev) -> dict:
    """``serve_detect.main(["--locate", ...])`` on the card and on the
    CPU: located alert rows served, and the RESULT's ``located`` block
    equal. Launch counters zeroed just before the card's run and read
    just after (ingest and queries: ``stft_mag``, ``haar2d``,
    ``minmax_sig_buckets``, ``minmax_hash``)."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_detect
    argv = ["--locate", "--requests", "8", "--slots", "4"]
    with contextlib.redirect_stdout(io.StringIO()):     # first launches
        serve_detect.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    res = {}
    for d in ("cuda", "cpu"):
        if d == "cuda":
            ops.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            stats = serve_detect.main(argv + ["--device", d])
        if d == "cuda":
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
        alerts = [ln for ln in buf.getvalue().splitlines()
                  if ln.startswith("ALERT ")]
        res[d] = (stats, alerts, time.perf_counter() - t0)
    (card, card_alerts, wall), (cpu, cpu_alerts, cpu_wall) = \
        res["cuda"], res["cpu"]
    out = {"located": card["located"], "served": card["served"],
           "hit_requests": card["hit_requests"], "wall_s": wall,
           "cpu_wall_s": cpu_wall, "launches": launches,
           "alert_rows": card_alerts[:4],
           "located_equal_cpu": card["located"] == cpu["located"],
           "alert_rows_equal_cpu": card_alerts == cpu_alerts}
    print("serve_locate", json.dumps(out), flush=True)
    _need(out["located_equal_cpu"], f"serve --locate: the located block "
          f"differs from the CPU's: {card['located']} {cpu['located']}")
    _need(card["located"]["located"] >= 1 and card["served"] == 8,
          f"serve --locate: nothing located or served: {card}")
    for name in ("stft_mag", "haar2d", "minmax_sig_buckets", "minmax_hash"):
        _need(launches[name] >= 1, f"serve --locate: {name} never launched")
    return out


def elastic_phase(ds, dev, tmp: str, want: dict, devices=None,
                  label: str = "elastic") -> dict:
    """Elastic pool membership at full width: phase 17's paper-pool
    snapshot (push 720) restored on the card, ``add_station()`` (a fifth
    station joining at the frontier, fed seeded noise at station 0's
    level), 60 more 60 s pushes to all five, ``remove_station(4)``, then
    the rest of the stream, with launch counters zeroed just before the
    first push and read just after the last. Stations 0–3's per-station
    stats and events, and the detections, must equal phase 7's
    uninterrupted record (bounded mode keeps no triplets past their
    window, so pairs are held by the counts the stats carry: emitted,
    kept, windows). The two re-packs are timed (synchronised).
    ``devices`` restores the pool over that station mesh (phase 30b):
    each re-pack re-pads and re-splits it, and every kernel then launches
    at least once a shard a block; the pool's pad rows and mesh width are
    reported after the restore, the join and the leave."""
    import numpy as np
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.kernels import ops
    from repro_torch.stream import StreamingDetector
    cfg, scfg = fast_seismic.config(), fast_seismic.stream_config()
    wave = ds.waveforms
    starts = list(range(0, wave.shape[1], STREAM_CHUNK))
    det, step = StreamingDetector.restore(tmp, cfg, scfg, device=dev,
                                          devices=devices)
    n = wave.shape[0]
    rng = np.random.default_rng(5)

    def layout():
        return {"pool_pad": det.pool_pad,
                "mesh": det.mesh.size if det.mesh else 1}

    pools = [layout()]
    scale = float(np.std(wave[0, :STREAM_CHUNK * 60]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    joined = det.add_station()
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    pools.append(layout())
    ops.reset_launches()
    blocks0 = det.stations[0].stats.blocks
    for a in starts[step:step + 60]:
        chunk = wave[:, a:a + STREAM_CHUNK]
        extra = scale * rng.standard_normal((1, chunk.shape[1]))
        det.push(np.concatenate([chunk, extra.astype(np.float32)]))
    five_blocks = det.stations[0].stats.blocks - blocks0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.remove_station(joined)
    torch.cuda.synchronize()
    remove_s = time.perf_counter() - t0
    pools.append(layout())
    for a in starts[step + 60:]:
        det.push(wave[:, a:a + STREAM_CHUNK])
    dets, events, stats = det.finalize()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    blocks = det.stations[0].stats.blocks - blocks0
    got = _stream_record(det, dets, events, stats)
    per_station = [{k: got["stats"].get(k) == v
                    for k, v in want["stats"].items()
                    if k.startswith(f"station{i}_")} for i in range(n)]
    ingest = [got["stats"]["ingest"][i] == want["stats"]["ingest"][i]
              for i in range(n)]
    events_equal = [got["events"][i] == want["events"][i] for i in range(n)]
    first_diff = None
    for i in range(n):
        if not events_equal[i]:
            a, b = got["events"][i], want["events"][i]
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            first_diff = {"station": i, "row": j,
                          "elastic": a[j] if j < len(a) else None,
                          "uninterrupted": b[j] if j < len(b) else None}
            break
    out = {"restored_step": step, "joined": joined, "pools": pools,
           "add_station_s": add_s, "remove_station_s": remove_s,
           "five_station_pushes": 60, "five_station_blocks": five_blocks,
           "blocks": blocks, "launches": launches,
           "stats_equal": per_station, "ingest_equal": ingest,
           "events_equal": events_equal,
           "detections_equal": got["detections"] == want["detections"],
           "alerts_equal": got["alerts"] == want["alerts"],
           "first_diff": first_diff}
    print(label, json.dumps(out), flush=True)
    _need(all(all(d.values()) for d in per_station) and all(ingest)
          and all(events_equal) and out["detections_equal"],
          f"{label}: stations 0-3 differ from the uninterrupted run: {out}")
    shards = pools[-1]["mesh"]
    for name in BATCH_KERNELS:
        _need(launches[name] >= shards * blocks, f"{label}: {name} launched "
              f"{launches[name]} times for {blocks} pooled blocks on "
              f"{shards} shards")
    return out


def bandpass_phase(ds, dev) -> dict:
    """One paper block (4 stations × 256 fingerprints) with
    ``time_domain_bandpass=True``: the card's spectrogram (the bandpass a
    ``conv1d`` with TF32 off, then ``stft_mag``) within the kernel
    tolerance of the port's CPU path, and the binarized fingerprints (the
    CPU's statistics on both) agreeing on at least 99.9% of the bits."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import fingerprint as fp_mod
    fcfg = dataclasses.replace(fast_seismic.config().fingerprint,
                               time_domain_bandpass=True)
    bs = fcfg.block_samples(256)
    block = np.ascontiguousarray(ds.waveforms[:, :bs])
    spec = {d: fp_mod.spectrogram(torch.as_tensor(block, device=d), fcfg)
            for d in (dev, "cpu")}
    torch.cuda.synchronize()
    err = _close(spec[dev].cpu(), spec["cpu"])
    coeffs = fp_mod.coeffs_from_waveform(torch.as_tensor(block), fcfg)
    med, mad = fp_mod.mad_stats(coeffs.reshape(-1, coeffs.shape[-1]), 1.0)
    bits = {d: fp_mod.fingerprints_from_waveform(
        torch.as_tensor(block, device=d), fcfg,
        med_mad=(med.to(d), mad.to(d)))[0].cpu() for d in (dev, "cpu")}
    agree = float((bits[dev] == bits["cpu"]).float().mean())
    out = {"shape": list(spec["cpu"].shape), "max_abs_err": err,
           "bit_agreement": agree, "bp_taps": fcfg.bp_taps}
    print("bandpass", json.dumps(out), flush=True)
    _need(agree >= 0.999, f"bandpass: bits agree on only {agree:.5f}")
    return out


def _lap(acc: dict, key: str, fn, peaks: dict | None = None):
    """Run ``fn``, synchronise the card, add the wall seconds to
    ``acc[key]`` and, with ``peaks``, keep in ``peaks[key]`` the most
    device memory allocated during any call; returns what ``fn``
    returned."""
    import torch
    if peaks is not None:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
    if peaks is not None:
        peaks[key] = max(peaks.get(key, 0), torch.cuda.max_memory_allocated())
    return out


def _station_packed(wave, fcfg, st: int):
    """Packed fingerprints of one station's whole trace, with the §5.2
    statistics drawn as ``detect_events`` draws them."""
    from repro_torch.core import fingerprint as fp_mod
    coeffs = fp_mod.coeffs_from_waveform(wave, fcfg)
    rows = (None if fcfg.mad_sample_rate >= 1.0 else
            fp_mod.sample_rows(coeffs.shape[0], fcfg.mad_sample_rate,
                               fcfg.stft_len + st))
    med_mad = fp_mod.mad_stats(coeffs, fcfg.mad_sample_rate, rows)
    return fp_mod.binarize_coeffs(coeffs, fcfg, med_mad)[1].contiguous()


def _valid_pairs(p) -> list:
    v = p.valid.cpu().numpy()
    return sorted(zip(p.idx1.cpu().numpy()[v].tolist(),
                      p.idx2.cpu().numpy()[v].tolist()))


def _same_search(a, b) -> bool:
    """Two (pairs, stats, jaccard) results equal, array by array."""
    import torch
    (pa, sa, ja), (pb, sb, jb) = a, b
    return (all(torch.equal(getattr(pa, f).cpu(), getattr(pb, f).cpu())
                for f in ("idx1", "idx2", "sim", "valid"))
            and {k: v.item() for k, v in sa.items()}
            == {k: v.item() for k, v in sb.items()}
            and torch.equal(ja.cpu(), jb.cpu()))


def _dedup_docs():
    """tests/test_data.py's input: 24 documents, an exact and a near
    duplicate among them."""
    import numpy as np
    docs = np.random.default_rng(0).integers(1, 1000, (24, 128)).astype(
        np.int32)
    docs[20] = docs[3]
    docs[21] = docs[5].copy()
    docs[21, ::37] = 7
    return docs


def offline_golden_phase(dev) -> dict:
    """The offline search's golden on the card, and corpus dedup card
    against CPU."""
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.core import fingerprint as fp_mod
    from repro_torch.core import lsh
    from repro_torch.data import dedup
    gold = json.loads((ROOT / "tests" / "golden" / "stream_pairs.json")
                      .read_text())
    cfg = fast_seismic.smoke_config()
    ds = make_dataset(SynthConfig(**gold["synth"]))
    _, packed = fp_mod.fingerprints_from_waveform(
        torch.as_tensor(ds.waveforms[0], device=dev), cfg.fingerprint)
    pairs, _ = lsh.search(packed, cfg.lsh)
    got = [list(p) for p in _valid_pairs(pairs)]
    docs = _dedup_docs()
    keep, dstats = dedup.find_duplicates(docs, device=dev)
    keep_cpu, dstats_cpu = dedup.find_duplicates(docs, device="cpu")
    out = {"offline_pairs": len(got),
           "equal_golden": got == gold["offline_pairs"],
           "dedup": dstats,
           "dedup_equal_cpu": bool((keep == keep_cpu).all())
           and dstats == dstats_cpu}
    print("offline_golden", json.dumps(out), flush=True)
    _need(out["equal_golden"] and len(got) == 17,
          f"offline search gave {len(got)} pairs, not the golden's 17")
    _need(out["dedup_equal_cpu"] and dstats["dropped"] >= 2,
          "find_duplicates on the card differs from the CPU path")
    return out


def offline_parity_phase(dev) -> dict:
    """The offline search at the paper widths on the 20-minute trace, card
    against the port's CPU path, whole path from the waveform.

    ``tests/test_torch_search.py`` holds the CPU path's search to the JAX
    package at these widths."""
    import dataclasses
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.core import lsh
    ds = make_dataset(SynthConfig(**PARITY_SYNTH))
    cfg = fast_seismic.config()
    fcfg = dataclasses.replace(cfg.fingerprint, mad_sample_rate=1.0)
    out = {"synth": PARITY_SYNTH, "stations": []}
    for st in range(ds.waveforms.shape[0]):
        runs = []
        for d in (dev, torch.device("cpu")):
            packed = _station_packed(torch.as_tensor(ds.waveforms[st],
                                                     device=d), fcfg, st)
            pairs, stats = lsh.search(packed, cfg.lsh)
            runs.append((packed.cpu(),
                         (pairs, stats, lsh.verify_jaccard(packed, pairs))))
        out["stations"].append({
            "fingerprints": runs[0][0].shape[0],
            "pre_filter_pairs": int(runs[0][1][1]["pre_filter_pairs"]),
            "pairs": int(runs[0][1][1]["pairs"]),
            "packed_equal": torch.equal(runs[0][0], runs[1][0]),
            "search_equal": _same_search(runs[0][1], runs[1][1])})
    print("offline_parity", json.dumps(out), flush=True)
    _need(sum(s["pairs"] for s in out["stations"]) > 0,
          "the offline parity trace found no pairs")
    _need(all(s["packed_equal"] and s["search_equal"]
              for s in out["stations"]),
          "offline search: the card's result differs from the CPU path's")
    return out


def offline_paper_phase(ds, n_fp: int, dev) -> tuple[dict, object]:
    """The paper's offline search on every station of the 24 h dataset,
    launches counted; returns the report and station 0's packed words."""
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import lsh
    from repro_torch.kernels import ops
    cfg = fast_seismic.config()
    fcfg, lcfg = cfg.fingerprint, cfg.lsh
    n_parts = 4
    wave = torch.as_tensor(ds.waveforms, device=dev)
    stage, peaks, stations, packed0 = {}, {}, [], None
    torch.cuda.synchronize()
    ops.reset_launches()
    t_all = time.perf_counter()
    for st in range(wave.shape[0]):
        packed = _lap(stage, "fingerprint",
                      lambda: _station_packed(wave[st], fcfg, st), peaks)
        pairs, stats = _lap(stage, "search", lambda: lsh.search(packed, lcfg),
                            peaks)
        jac = _lap(stage, "verify", lambda: lsh.verify_jaccard(packed, pairs),
                   peaks)
        v = pairs.valid
        stations.append({
            "fingerprints": packed.shape[0],
            "pre_filter_pairs": int(stats["pre_filter_pairs"]),
            "pairs": int(stats["pairs"]),
            "excluded_fingerprints": int(stats["excluded_fingerprints"]),
            "max_bucket": int(stats["max_bucket"]),
            "avg_lookups_per_query": float(stats["avg_lookups_per_query"]),
            "selectivity": float(stats["selectivity"]),
            "mean_jaccard": float(jac[v].mean()) if bool(v.any()) else None})
        if st == 0:
            packed0 = packed
    wall = time.perf_counter() - t_all
    blocks, pstats = _lap(stage, "partitioned_search_station0",
                          lambda: lsh.partitioned_search(packed0, lcfg,
                                                         n_parts), peaks)
    launches = dict(ops.LAUNCHES)
    n_search = wave.shape[0] + 1
    with_pairs = sum(s["pairs"] > 0 for s in stations)

    # a synced breakdown of station 0's search (after the counts were read)
    split = {}
    mp = _lap(split, "hash_mappings",
              lambda: lsh.hash_mappings(fcfg.fp_dim, lcfg, dev))
    sigs = _lap(split, "signatures", lambda: lsh.signatures(packed0, mp, lcfg))
    cand = _lap(split, "candidate_pairs",
                lambda: lsh.candidate_pairs(sigs, lcfg))
    _lap(split, "occurrence_filter", lambda: lsh.occurrence_filter(
        cand, packed0.shape[0], lcfg.occurrence_frac))
    _lap(split, "bucket_stats", lambda: lsh.bucket_stats(sigs))

    n_total = wave.shape[0] * n_fp
    out = {
        "stations": wave.shape[0], "hours": PAPER_HOURS,
        "fingerprints_per_station": n_fp,
        "stage_s": stage,
        "wall_s": wall,
        "fingerprints_per_s": n_total / wall,
        "search_fingerprints_per_s": n_total / stage["search"],
        "per_station": stations,
        "partitioned": {"n_partitions": n_parts,
                        "pairs": sum(int(b.count()) for b in blocks),
                        **pstats},
        "station0_search_split_s": split,
        "peak_memory_bytes": max(peaks.values()),
        "stage_peak_memory_bytes": peaks,
        "launches": launches,
    }
    print("offline_paper", json.dumps(out), flush=True)
    _need(launches["minmax_hash"] >= n_search,
          f"minmax_hash launched {launches['minmax_hash']} times for "
          f"{n_search} searches")
    _need(launches["occurrence_filter"] == wave.shape[0],
          f"occurrence_filter launched {launches['occurrence_filter']} "
          f"times for {wave.shape[0]} filtered searches")
    _need(with_pairs > 0, "the offline search found no pair at any station")
    _need(launches["jaccard_popcount"] >= with_pairs,
          f"jaccard_popcount launched {launches['jaccard_popcount']} times "
          f"for {with_pairs} searches with pairs")
    _need(all(s["pairs"] <= s["pre_filter_pairs"] for s in stations),
          "more pairs after the occurrence filter than before")
    return out, packed0


def minmax_hash_phase(packed0, dev) -> dict:
    """``minmax_hash`` against its plain version at the offline search's
    shape (one station-day), bit-exact, and at the MinHash baseline's
    H = t·k = 800; then at the shapes of the path that take the row
    kernel: the offline golden's station (the smoke config, D 1024, H 40)
    and corpus dedup's 24 × 1024 × 64."""
    import dataclasses
    import torch
    from repro_torch import utils
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.core import fingerprint as fp_mod
    from repro_torch.core import lsh
    from repro_torch.data import dedup
    from repro_torch.kernels import minmax_hash as mm_k
    from repro_torch.kernels import ops
    lcfg = fast_seismic.config().lsh
    packed = packed0.clone()
    packed[:: 97] = 0                                  # rows with no set bit
    n, words = packed.shape
    nnz = int(utils.popcount(packed).sum())
    dims = int(utils.unpack_bits(packed, 32 * words).any(dim=0).sum())
    runs = {}
    for label, cfg in (("minmax", lcfg),
                       ("baseline", dataclasses.replace(lcfg,
                                                        use_minmax=False))):
        mp = lsh.hash_mappings(32 * words, cfg, dev)
        got = ops.minmax_hash(packed, mp)
        want = mm_k.plain_raw(packed, mp)
        torch.cuda.synchronize()
        _need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"minmax_hash ({label}) differs from its plain version")
        del want
        h = mp.shape[1]
        bound, by = cost.bound_ms(cost.minmax_hash(n, words, h, nnz=nnz,
                                                   dims=dims))
        ms = _time_ms(lambda: ops.minmax_hash(packed, mp), iters=20)
        rate = _minmax_rate("minmax_hash", packed, mp, nnz, ms)
        runs[label] = {
            "shape": [n, words, h], "ms": ms,
            **{k: v for k, v in rate.items() if k.endswith("_tb_s")},
            "plan": rate["plan"],
            "plain_ms": _time_ms(lambda: mm_k.plain_raw(packed, mp),
                                 iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by}
    gold = json.loads((ROOT / "tests" / "golden" / "stream_pairs.json")
                      .read_text())
    scfg = fast_seismic.smoke_config()
    _, gpacked = fp_mod.fingerprints_from_waveform(torch.as_tensor(
        make_dataset(SynthConfig(**gold["synth"])).waveforms[0], device=dev),
        scfg.fingerprint)
    dcfg = dedup.DedupConfig()
    dpacked = utils.pack_bits(dedup.shingle_fingerprints(
        torch.as_tensor(_dedup_docs(), device=dev), dcfg))
    plans = {"station_day": runs["minmax"]["plan"],
             "station_day_h800": runs["baseline"]["plan"]}
    plans.update(_minmax_row_cases(
        "minmax_hash",
        {"offline_golden": (gpacked, lsh.hash_mappings(
            scfg.fingerprint.fp_dim, scfg.lsh, dev), None),
         "dedup": (dpacked, lsh.hash_mappings(dcfg.feature_dim, dcfg.lsh,
                                              dev), None)},
        lambda pk, mp, _: ops.minmax_hash(pk, mp),
        lambda pk, mp, _: mm_k.plain_raw(pk, mp)))
    main = runs["minmax"]
    out = {"name": "minmax_hash", "route": "cuda",
           "source": "src/repro_torch/csrc/minmax_hash.cu",
           "replaces": "src/repro/kernels/minmax_hash.py:71",
           "shape": main["shape"], "set_bits": nnz, "max_abs_err": 0,
           "ms": main["ms"],
           **{k: v for k, v in main.items() if k.endswith("_tb_s")},
           "plans": plans, "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "library_ms": None, "baseline_h800": runs["baseline"]}
    print("minmax_hash", json.dumps(out), flush=True)
    return out


def occurrence_filter_phase(packed0, dev) -> dict:
    """``occurrence_filter`` at the offline search's shape: station 0's
    candidate stream from ``lsh.candidate_pairs`` (t · cap · N slots,
    17.3 M at a station-day), the kernel against its plain version bit for
    bit (flags, sim and the excluded mask), timed beside its bound, the
    plain version and, as ``library_ms``, the four library scatters the
    port ran before the kernel (``scatter_add_`` twice and
    ``scatter_reduce_(amax)`` twice over every slot, the masked ones aimed
    at fingerprint 0), which the port no longer calls."""
    import torch
    from repro_torch import utils
    from repro_torch.configs import fast_seismic
    from repro_torch.core import lsh
    from repro_torch.kernels import ops, ref
    lcfg = fast_seismic.config().lsh
    n, words = packed0.shape
    cand = lsh.candidate_pairs(lsh.signatures(
        packed0, lsh.hash_mappings(32 * words, lcfg, dev), lcfg), lcfg)
    cap = max(1, int(lcfg.occurrence_frac * n))
    args = (cand.idx1, cand.idx2, cand.sim, cand.valid, n, cap)
    got = ops.occurrence_filter(*args)
    want = ref.occurrence_filter(*args)
    torch.cuda.synchronize()
    _need(all(torch.equal(a, b) for a, b in zip(got, want)),
          "occurrence_filter differs from its plain version")
    del want
    v = cand.valid
    m, live = v.shape[0], int(v.sum())
    zero = torch.zeros_like(cand.idx1)
    i1, i2 = torch.where(v, cand.idx1, zero), torch.where(v, cand.idx2, zero)
    w = v.to(torch.int32)
    marks = torch.where(v, got[2][i2.long()].to(torch.int32), zero)

    def library():
        utils.segment_sum(w, i1, n)
        utils.segment_sum(w, i2, n)
        utils.segment_max(marks, i1, n)
        utils.segment_max(marks, i2, n)

    bound, by = cost.bound_ms(cost.occurrence_filter(m, n, live))
    out = {"name": "occurrence_filter", "route": "cuda",
           "source": "src/repro_torch/csrc/occurrence_filter.cu",
           "replaces": "none (jax.ops.segment_* in "
                       "src/repro/core/lsh.py:273)",
           "shape": [m, n], "valid_slots": live, "cap": cap,
           "excluded": int(got[2].sum()), "kept": int(got[0].sum()),
           "max_abs_err": 0,
           "ms": _time_ms(lambda: ops.occurrence_filter(*args)),
           "plain_ms": _time_ms(lambda: ref.occurrence_filter(*args),
                                iters=5, warmup=1),
           "bound_ms": bound, "bound_by": by,
           "library_ms": _time_ms(library, iters=5, warmup=1)}
    print("occurrence_filter", json.dumps(out), flush=True)
    return out


def _lm_check(got, want, what: str) -> float:
    """Max abs error of a kernel's output against its plain version, held
    to the dtype's share of max|plain|."""
    import torch
    _need(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype or shape differs from the plain version")
    _need(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    tol = LM_TOL[str(want.dtype).split(".")[-1]] * float(
        want.float().abs().max())
    _need(err <= tol, f"{what} differs from its plain version: max abs err "
          f"{err} > {tol}")
    return err


def _d16_cases(runs: list) -> dict:
    """The kernels line's D = 16 cases of an attention kernel's runs
    (their launches are added from phases 14 and 25)."""
    keys = ("shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    return {"cases": [{k: r[k] for k in keys} for r in runs
                      if r["shape"][5] == 16]}


def lm_kernel_phase(dev) -> list[dict]:
    """``flash_attention`` and ``mamba_scan`` against their plain versions
    at the LM prefill shapes, timed and bounded."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import mamba_scan as ms_k
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(0)
    out = []

    # --- flash_attention: (B, Hq, Hkv, Sq, Sk, D, dtype), the first is
    # qwen2.5-14b's 2048-token prefill, the one the kernels line reports;
    # then the other families' 2048-token prefills (model, the heads and
    # head dim of their attention layers)
    cases = [(1, 40, 8, 2048, 2048, 128, torch.bfloat16),
             (1, 40, 8, 512, 2048, 128, torch.bfloat16),
             (1, 40, 8, 1000, 1000, 128, torch.bfloat16),
             (1, 40, 8, 2048, 2048, 128, torch.float32)]
    family_cases = {"yi-9b": (32, 4, 128), "codeqwen1.5-7b": (32, 32, 128),
                    "command-r-35b": (64, 8, 128),
                    "deepseek-moe-16b / moonshot-v1-16b-a3b": (16, 16, 128),
                    "musicgen-large / zamba2-1.2b": (32, 32, 64),
                    "internvl2-1b": (14, 2, 64)}
    cases += [(1, hq, hkv, 2048, 2048, d, torch.bfloat16)
              for hq, hkv, d in family_cases.values()]
    models = ["qwen2.5-14b"] * 4 + list(family_cases)
    # head dim 16: command-r-35b-smoke's heads, bf16 and fp32
    cases += [(*c[:6], getattr(torch, c[6])) for c in D16_CASES]
    models += [D16_MODEL] * len(D16_CASES)
    runs = []
    for (b, hq, hkv, sq, sk, d, dt), model in zip(cases, models):
        q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(dt)
        k = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dt)
        v = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dt)
        got = ops.flash_attention(q, k, v)
        want = fa_k.plain(q, k, v)
        torch.cuda.synchronize()
        err = _lm_check(got, want, f"flash_attention {[b, hq, sq, sk, d]}")
        del got, want
        pairs = cost.causal_pairs(sq, sk)
        work = cost.flash_attention(b, hq, hkv, sq, sk, d, dt)
        bound, by = cost.bound_ms(work)
        ms = _time_ms(lambda: ops.flash_attention(q, k, v))
        runs.append({
            "model": model, "shape": [b, hq, hkv, sq, sk, d],
            "dtype": str(dt)[6:],
            "causal_pairs": pairs, "max_abs_err": err, "ms": ms,
            "tflop_s": work.ops / ms * 1e-9,
            "ms_unprimed": _time_ms(lambda: ops.flash_attention(q, k, v),
                                    primed=False),
            "plain_ms": _time_ms(lambda: fa_k.plain(q, k, v), iters=10),
            "bound_ms": bound, "bound_by": by,
            # the library's causal mask is not offset for Sq < Sk
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            if sq == sk else None})
        del q, k, v
    print("flash_attention_rate", json.dumps([
        {key: r[key] for key in ("model", "shape", "dtype", "ms", "tflop_s",
                                 "ms_unprimed", "library_ms")}
        for r in runs]), flush=True)
    main = runs[0]
    out.append({"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:89",
                **{k: main[k] for k in ("shape", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                "cases": runs, "head_dim_16": _d16_cases(runs)})

    # --- mamba_scan at falcon-mamba-7b's prefill shape, fp32, with the
    # model's A = -exp(a_log) = -(1..N) and a softplus-sized dt
    b, s, di, n = 1, 2048, 8192, 16
    xdt = torch.randn((b, s, di), generator=g, device=dev)
    dtv = F.softplus(torch.randn((b, s, di), generator=g, device=dev) - 4.6)
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=dev).expand(di, n).contiguous()
    bm = torch.randn((b, s, n), generator=g, device=dev)
    cm = torch.randn((b, s, n), generator=g, device=dev)
    args = (xdt, dtv, a, bm, cm)
    y, h = ops.mamba_scan(*args)
    y_p, h_p = ms_k.plain(*args)
    torch.cuda.synchronize()
    err = max(_lm_check(y, y_p, "mamba_scan y"),
              _lm_check(h, h_p, "mamba_scan h_final"))
    # one exponential per (step, channel, state), on the SFU
    bound, by = cost.bound_ms(cost.mamba_scan(b, s, di, n, torch.float32))
    out.append({"name": "mamba_scan", "route": "cuda",
                "source": "src/repro_torch/csrc/mamba_scan.cu",
                "replaces": "src/repro/kernels/mamba_scan.py:54",
                "shape": [b, s, di, n], "dtype": "float32",
                "max_abs_err": err,
                "ms": _time_ms(lambda: ops.mamba_scan(*args)),
                "plain_ms": _time_ms(lambda: ms_k.plain(*args), iters=3,
                                     warmup=1),
                "bound_ms": bound, "bound_by": by, "library_ms": None})
    for k in out:
        print("lm_kernel", json.dumps(k), flush=True)
    return out


def _lm_smoke_configs():
    """The fp32 variants of the launcher's smoke model and of every LM
    arch's smoke config."""
    import dataclasses
    from repro_torch.configs import LM_ARCHS, get_smoke_config
    from repro_torch.launch.serve import default_smoke_model
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               cache_dtype="float32")
    out = []
    for c in [default_smoke_model()] + [get_smoke_config(a)
                                        for a in LM_ARCHS]:
        out.append(dataclasses.replace(c, **f32))
    return out


class _RecordRoutes:
    """Within the ``with``: every MoE routing's expert ids (T, k), in call
    order (``layers._route`` wrapped; the tensors stay where they are).
    Instrumentation of this script only: the model code is untouched."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.ids, self._route = [], L._route

        def route(h2, router_w, cfg):
            out = self._route(h2, router_w, cfg)
            self.ids.append(out[0])
            return out

        L._route = route
        return self.ids

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L._route = self._route


def _attn_layers(cfg) -> int:
    """The layers that run the flash_attention kernel in a prefill."""
    if cfg.shared_attn_every:
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers if cfg.block_kind == "attn" else 0


def _tree_to(tree: dict, dev) -> dict:
    """A copy of a tree of tensors on ``dev`` (a copy on the same device
    too, so a run that updates it in place leaves the source alone)."""
    return {k: _tree_to(v, dev) if isinstance(v, dict)
            else v.to(dev, copy=True) for k, v in tree.items()}


def lm_parity_phase(dev) -> dict:
    """``ServeEngine`` on the card against the port's CPU path (which
    ``tests/test_torch_serve.py`` holds to the JAX package), fp32 smoke
    configs, the same parameters and requests; the prefill logits, and
    for MoE the prefills' routed expert ids, on the same prompts (the
    patch frontend's prefill also on a prompt with ``patch_embeds``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import init_params, prefill
    out = {}
    for cfg in _lm_smoke_configs():
        params = init_params(cfg, 0, "cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(4, 17)))
                   .astype(np.int32) for _ in range(4)]
        batches = [{"tokens": pr[None]} for pr in prompts]
        if cfg.frontend == "patch":
            batches.append({
                "tokens": rng.integers(1, cfg.vocab_size, (1, 24)).astype(
                    np.int32),
                "patch_embeds": rng.standard_normal(
                    (1, cfg.n_patches, cfg.d_model)).astype(np.float32)})
        runs = []
        ops.reset_launches()        # the card's run; the CPU's launches none
        for d in (dev, torch.device("cpu")):
            p = _tree_to(params, d)
            reqs = [Request(i, pr, 8) for i, pr in enumerate(prompts)]
            stats = ServeEngine(cfg, n_slots=2, max_len=64, params=p).run(
                reqs)
            with _RecordRoutes() as routes:
                logits = torch.stack([prefill(p, {
                    k: torch.as_tensor(v, device=d) for k, v in b.items()},
                    cfg)[0][0].cpu() for b in batches])
            runs.append(([r.out for r in reqs], stats["ticks"], logits,
                         [r.cpu() for r in routes]))
        err = float((runs[0][2] - runs[1][2]).abs().max())
        out[cfg.name] = {"tokens": runs[0][0], "ticks": runs[0][1],
                         "head_dim": cfg.hd, "launches": dict(ops.LAUNCHES),
                         "kernel": "mamba_scan" if cfg.block_kind == "mamba1"
                         else "flash_attention",
                         "tokens_equal_cpu": runs[0][:2] == runs[1][:2],
                         "prefill_logit_max_abs_err": err,
                         "max_abs_logit": float(runs[1][2].abs().max()),
                         "prefill_batches": len(batches)}
        if cfg.is_moe:
            card, cpu = runs[0][3], runs[1][3]
            out[cfg.name]["routings"] = len(cpu)
            out[cfg.name]["routed_pairs"] = sum(r.numel() for r in cpu)
            out[cfg.name]["expert_ids_equal_cpu"] = len(card) == len(cpu) \
                and all(torch.equal(a, b) for a, b in zip(card, cpu))
    print("lm_parity", json.dumps(out), flush=True)
    for name, r in out.items():
        _need(r["tokens_equal_cpu"],
              f"LM parity {name}: the card's tokens differ from the CPU's")
        _need(r["prefill_logit_max_abs_err"] <= 1e-4 * r["max_abs_logit"],
              f"LM parity {name}: prefill logits differ by "
              f"{r['prefill_logit_max_abs_err']}")
        _need(r.get("expert_ids_equal_cpu", True),
              f"LM parity {name}: the card routes tokens to other experts")
        _need(r["launches"].get(r["kernel"], 0) > 0,
              f"LM parity {name}: the card's run launched no {r['kernel']}")
    return out


def lm_serve_phase(dev) -> dict:
    """Every LM arch at full width (``LM_SERVE_MODELS``: n_layers cut to 4
    but for zamba2-1.2b and internvl2-1b) serving 8 requests each,
    launches counted around each run; for MoE, the share of the prefills'
    routed (token, slot) pairs that capacity dropped."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    from repro_torch.utils import tree_bytes
    n_req, max_new, n_slots = 8, 32, 4
    out = {}
    for arch, cut in LM_SERVE_MODELS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=LM_SERVE_LAYERS) if cut \
            else full
        kernel = "mamba_scan" if cfg.block_kind == "mamba1" \
            else "flash_attention"
        want = (cfg.n_layers if kernel == "mamba_scan"
                else _attn_layers(cfg)) * n_req
        torch.cuda.empty_cache()
        params = init_params(cfg, 0, dev)
        torch.cuda.synchronize()
        lens = np.random.default_rng(0).choice([512, 1024, 1536, 2048],
                                               n_req)
        prng = np.random.default_rng(1)
        reqs = [Request(i, prng.integers(1, cfg.vocab_size, int(n))
                        .astype(np.int32), max_new)
                for i, n in enumerate(lens)]
        # warm-up: every prompt length once, so the timed run below pays
        # no first-use costs (library handles, per-shape GEMM choices)
        t0 = time.perf_counter()
        ServeEngine(cfg, n_slots=n_slots, max_len=2560, params=params).run(
            [Request(i, q.prompt, 2) for i, q in enumerate(reqs)])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        eng = ServeEngine(cfg, n_slots=n_slots, max_len=2560, params=params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with _RecordRoutes() as routes:
            stats = eng.run(reqs)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        widths = {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                  "n_kv_heads": cfg.n_kv_heads, "hd": cfg.hd,
                  "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size}
        if cfg.is_moe:
            widths.update(n_experts=cfg.n_experts, moe_top_k=cfg.moe_top_k,
                          expert_ff=cfg.expert_ff,
                          n_shared_experts=cfg.n_shared_experts)
        if cfg.block_kind != "attn":
            widths.update(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state)
        if cfg.block_kind == "mamba2":
            widths.update(ssm_heads=cfg.ssm_heads,
                          ssm_head_dim=cfg.ssm_head_dim,
                          shared_attn_every=cfg.shared_attn_every)
        r = {"reduced": {"n_layers": [full.n_layers, cfg.n_layers]}
             if cut else {}, "widths": widths,
             "prompt_lens": [int(n) for n in lens], "max_new": max_new,
             "warmup_s": warm_s,
             "wall_s": stats["wall_s"], "prefill_s": stats["prefill_s"],
             "decode_s": stats["wall_s"] - stats["prefill_s"],
             "decode_ticks": stats["ticks"], "generated": stats["generated"],
             "tokens_per_s": stats["tokens_per_s"],
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "param_bytes": tree_bytes(params),
             "launches": launches}
        if cfg.is_moe:
            # the decode steps route n_slots tokens, the prefills their
            # prompts' 512-2048
            kept = dropped = 0
            for ids in routes:
                if ids.shape[0] == n_slots:
                    continue
                rank = L._rank_within_expert(ids.reshape(-1), cfg.n_experts)
                n_drop = int((rank >= L._capacity(ids.shape[0], cfg)).sum())
                dropped += n_drop
                kept += ids.numel() - n_drop
            r["prefill_routed_pairs"] = kept + dropped
            r["prefill_dropped_share"] = dropped / (kept + dropped)
        print("lm_serve", cfg.name, json.dumps(r), flush=True)
        _need(all(q.done and len(q.out) == max_new + 1 for q in reqs),
              f"{cfg.name}: a request was not served in full")
        _need(launches[kernel] == want,
              f"{cfg.name}: {kernel} launched {launches[kernel]} times, not "
              f"{want} (its layers x requests)")
        out[full.name] = r
        del eng, params, routes
    return out


def _split_ms(launch, names, iters: int = 20) -> dict:
    """Median device time of each kernel one call of a backward wrapper
    launches: ``launch(events)`` records len(names) + 1 CUDA events on the
    stream, before the first kernel and after each; each call sits behind
    the same busy wait as ``_time_ms``'s."""
    import torch
    runs = []
    for _ in range(iters + 2):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        torch.cuda._sleep(PRIME_CYCLES)
        launch(ev)
        runs.append(ev)
    torch.cuda.synchronize()
    runs = runs[2:]   # warm-up
    out = {}
    for i, name in enumerate(names):
        ts = sorted(r[i].elapsed_time(r[i + 1]) for r in runs)
        out[name] = ts[len(ts) // 2]
    return out


def lm_bwd_kernel_phase(dev) -> list[dict]:
    """The backward kernels of ``flash_attention`` and ``mamba_scan``
    against their plain versions (``plain_bwd``) at the training shapes,
    each launched twice and bitwise equal, timed and bounded."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import mamba_scan as ms_k
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(1)
    out = []

    # --- flash_attention_bwd: (B, Hq, Hkv, S, D, dtype), causal; the
    # first is qwen2.5-14b's training shape, the one the kernels line
    # reports; the last three phase 26's microbatches of deepseek-moe-16b,
    # zamba2-1.2b's shared block and internvl2-1b (GQA group 7)
    runs = []
    for b, hq, hkv, s, d, dt in ((1, 40, 8, 2048, 128, torch.bfloat16),
                                 (1, 40, 8, 512, 128, torch.float32),
                                 (1, 16, 16, 2048, 128, torch.bfloat16),
                                 (2, 32, 32, 2048, 64, torch.bfloat16),
                                 (2, 14, 2, 2048, 64, torch.bfloat16),
                                 *((c[0], c[1], c[2], c[3], c[5],
                                    getattr(torch, c[6]))
                                   for c in D16_CASES)):
        q, do = (torch.randn((b, hq, s, d), generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=g, device=dev).to(dt)
                for _ in range(2))
        o = torch.empty_like(q)
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
        fa_k.launch(q, k, v, o, True, lse)      # the forward's o and L
        o_p, lse_p = fa_k.plain_with_lse(q, k, v, True)
        _lm_check(o, o_p, f"flash_attention o {[b, hq, s, d]}")
        lse_err = float((lse - lse_p).abs().max())
        _need(lse_err <= 1e-3, f"flash_attention log-sum-exp {[b, hq, s, d]}"
              f" differs from the plain one: max abs err {lse_err} > 1e-3")
        del o_p, lse_p
        got = ops.flash_attention_bwd(q, k, v, o, lse, do)
        again = ops.flash_attention_bwd(q, k, v, o, lse, do)
        want = fa_k.plain_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        _need(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"flash_attention_bwd {[b, hq, s, d]}: two launches differ")
        err = max(_lm_check(x, w, f"flash_attention_bwd d{n} {[b, hq, s, d]}")
                  for x, w, n in zip(got, want, "qkv"))
        del got, again, want
        pairs = cost.causal_pairs(s, s)
        # 10·D flops an allowed pair: the 5 products of a backward
        work = cost.flash_attention_bwd(b, hq, hkv, s, s, d, dt)
        bound, by = cost.bound_ms(work)
        ms = _time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do))
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        split = _split_ms(lambda ev: fa_k.launch_bwd(
            q, k, v, o, lse, do, *grads, True, events=ev),
            ("prep", "dkdv", "combine", "dq"))
        del grads
        plain_ms = _time_ms(lambda: fa_k.plain_bwd(q, k, v, o, lse, do),
                            iters=5, warmup=1)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                            enable_gqa=True)
        library_ms = _time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True))
        runs.append({"shape": [b, hq, hkv, s, s, d], "dtype": str(dt)[6:],
                     "causal_pairs": pairs, "max_abs_err": err,
                     "lse_max_abs_err": lse_err, "ms": ms,
                     "tflop_s": work.ops / ms * 1e-9,
                     "split_ms": split,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": library_ms,
                     "repeatable": True})
        del q, k, v, o, lse, do, ql, kl, vl, ol
    main = runs[0]
    out.append({"name": "flash_attention_bwd", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:89 "
                            "(its backward; no Pallas counterpart)",
                **{k: main[k] for k in ("shape", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                "cases": runs, "head_dim_16": _d16_cases(runs)})

    # --- mamba_scan_bwd: (B, dtype) at falcon-mamba-7b's S, Di, N; the
    # first is the training path's microbatch (LM_TRAIN: 4 sequences in 2
    # microbatches) in training's scan dtype, the row the kernels line
    # reports
    s, di, n = LM_TRAIN_SEQ, 8192, 16
    b_train = LM_TRAIN["falcon-mamba-7b"][0] // LM_TRAIN["falcon-mamba-7b"][1]
    runs = []
    for b, dt in ((b_train, torch.float32), (1, torch.float32),
                  (1, torch.bfloat16)):
        xdt, dy = (torch.randn((b, s, di), generator=g, device=dev).to(dt)
                   for _ in range(2))
        dtv = F.softplus(torch.randn((b, s, di), generator=g, device=dev)
                         - 4.6).to(dt)
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).expand(di, n).contiguous()
        bm, cm = (torch.randn((b, s, n), generator=g, device=dev).to(dt)
                  for _ in range(2))
        args = (xdt, dtv, a, bm, cm)
        y, hf, hc = ops.mamba_scan_chunks(*args)
        y_p, hf_p = ms_k.plain(*args)
        _lm_check(y, y_p, f"mamba_scan_chunks y {[b, dt]}")
        _lm_check(hf, hf_p, f"mamba_scan_chunks h_final {[b, dt]}")
        del y, hf, y_p, hf_p
        got = ops.mamba_scan_bwd(*args, dy, None, hc)
        again = ops.mamba_scan_bwd(*args, dy, None, hc)
        want = ms_k.plain_bwd(*args, dy)
        torch.cuda.synchronize()
        _need(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"mamba_scan_bwd {[b, dt]}: two launches differ")
        err = max(_lm_check(x, w, f"mamba_scan_bwd {name} {[b, dt]}")
                  for x, w, name in zip(got, want, ("dxdt", "ddt", "da",
                                                    "db", "dc")))
        del got, again, want
        # one exponential a (step, channel, state) on the SFU: the
        # adjoint's g_t is the recompute's (the kernel forms it twice)
        work = cost.mamba_scan_bwd(b, s, di, n, dt)
        bound, by = cost.bound_ms(work)
        # the training path's forward (the instance that stores the chunk
        # states) at the same shape, bounded as phase 13's plus its stores
        fwd_bound, fwd_by = cost.bound_ms(cost.mamba_scan(b, s, di, n, dt,
                                                          chunks=True))
        ms = _time_ms(lambda: ops.mamba_scan_bwd(*args, dy, None, hc))
        grads = (torch.empty_like(xdt), torch.empty_like(xdt),
                 torch.empty_like(a), torch.empty_like(bm),
                 torch.empty_like(cm))
        split = _split_ms(lambda ev: ms_k.launch_bwd(
            *args, dy, None, hc, grads, events=ev),
            ("main", "sum_dbdc", "sum_da"))
        del grads
        runs.append({
            "shape": [b, s, di, n], "dtype": str(dt)[6:], "max_abs_err": err,
            "fwd_chunks_ms": _time_ms(lambda: ops.mamba_scan_chunks(*args)),
            "fwd_chunks_bound_ms": fwd_bound, "fwd_chunks_bound_by": fwd_by,
            "ms": ms, "gb_s": work.bytes / ms * 1e-6, "split_ms": split,
            "plain_ms": _time_ms(lambda: ms_k.plain_bwd(*args, dy), iters=1,
                                 warmup=0),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "repeatable": True})
        del xdt, dy, dtv, bm, cm, hc, args
    main = runs[0]
    out.append({"name": "mamba_scan_bwd", "route": "cuda",
                "source": "src/repro_torch/csrc/mamba_scan.cu",
                "replaces": "src/repro/kernels/mamba_scan.py:54 "
                            "(its backward; no Pallas counterpart)",
                **{k: main[k] for k in ("shape", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                "cases": runs})
    for k in out:
        print("lm_bwd_kernel", json.dumps(k), flush=True)
        for case in k["cases"]:
            print("lm_bwd_split", json.dumps(
                {"name": k["name"], "shape": case["shape"],
                 "dtype": case["dtype"], "ms": case["ms"],
                 "split_ms": case["split_ms"],
                 **{r: case[r] for r in ("tflop_s", "gb_s") if r in case}}),
                flush=True)
    return out


def embedding_bwd_phase(dev) -> dict:
    """The embedding lookup's backward at qwen2.5-14b's table (153,600 ×
    5,120 bf16) and one microbatch of phase 26 (2,048 zipf-distributed
    tokens, so rows repeat as in text): ``F.embedding`` (the port's
    ``layers.embed_tokens``: a sorted, fixed-order sum of each token's
    rows) and the indexing ``table[tokens]`` (``index_put_`` with
    accumulation), each timed as forward + backward of the lookup alone,
    and whether each repeats its gradient bit for bit over 5 runs.
    ``F.embedding`` must: the launcher's resume is checked bit-exact."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import padded_vocab
    cfg = get_config("qwen2.5-14b")
    g = torch.Generator(device=dev).manual_seed(2)
    table = (torch.randn((padded_vocab(cfg), cfg.d_model), generator=g,
                         device=dev) * 0.02).to(torch.bfloat16)
    table.requires_grad_()
    toks = torch.as_tensor(np.minimum(
        np.random.default_rng(0).zipf(1.2, (1, LM_TRAIN_SEQ)),
        cfg.vocab_size - 1) - 1, dtype=torch.int32, device=dev)
    dy = torch.randn((1, LM_TRAIN_SEQ, cfg.d_model), generator=g,
                     device=dev).to(torch.bfloat16)
    ways = {"F.embedding": lambda: F.embedding(toks, table),
            "index_put_": lambda: table[toks.long()]}
    out = {"table": list(table.shape), "tokens": LM_TRAIN_SEQ,
           "distinct_tokens": int(torch.unique(toks).numel())}
    for name, fwd in ways.items():
        grads = [torch.autograd.grad(fwd(), table, dy)[0] for _ in range(5)]
        out[name] = {
            "ms": _time_ms(lambda: torch.autograd.grad(fwd(), table, dy),
                           iters=20),
            "repeatable": all(torch.equal(grads[0], x) for x in grads[1:])}
        del grads
    print("embedding_bwd", json.dumps(out), flush=True)
    _need(out["F.embedding"]["repeatable"],
          "F.embedding's backward is not bitwise repeatable on the card")
    return out


def _patch_embeds(cfg, b: int, seed: int, dev):
    """Seeded (B, n_patches, d_model) patch embeddings in the compute
    dtype: the patch frontend's input (the reference's
    ``configs/shapes.input_specs`` layout)."""
    import numpy as np
    import torch
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return torch.as_tensor(x, device=dev).to(cfg.cdtype)


def _train_batch(cfg, b: int, s: int, seed: int, dev) -> dict:
    """Seeded random tokens with next-token labels (the last position
    masked out), and patch embeddings for the patch frontend."""
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.zeros((b, 1), np.int32)], 1)
    mask = np.ones((b, s), np.float32)
    mask[:, -1] = 0.0
    out = {k: torch.as_tensor(v, device=dev) for k, v in
           (("tokens", toks), ("labels", labels), ("loss_mask", mask))}
    if cfg.frontend == "patch":
        out["patch_embeds"] = _patch_embeds(cfg, b, seed, dev)
    return out


def _train_launches(cfg) -> dict:
    """The LM kernels' launches for one microbatch of a training step with
    remat "block": the layer stack's kernel twice a layer (the forward and
    the recompute) and its backward once a layer. The hybrid's shared
    attention block runs outside the checkpointed stack, as in the
    reference, so it launches its forward once an invocation."""
    if cfg.block_kind == "mamba1":
        return {"mamba_scan": 2 * cfg.n_layers,
                "mamba_scan_bwd": cfg.n_layers}
    a = _attn_layers(cfg)
    return {"flash_attention": a if cfg.shared_attn_every else 2 * a,
            "flash_attention_bwd": a}


def _same_routes(card: list, cpu: list) -> bool:
    """Two ``_RecordRoutes`` lists equal, routing for routing."""
    import torch
    return len(card) == len(cpu) and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(card, cpu))


def lm_train_parity_phase(dev) -> dict:
    """Training on the card against the port's CPU path (which
    ``tests/test_torch_lm_grad.py`` and ``tests/test_torch_train.py``
    hold to the JAX package) on every fp32 smoke config
    (``_lm_smoke_configs()``), remat "block", the patch frontend with
    ``patch_embeds``: ``lm_loss`` and its gradients, then three
    ``make_train_step`` steps (2 microbatches) in each ``accum_mode`` from
    the same state. Tolerances: loss 1e-5 relative and gradients 2e-5 of
    each leaf's max|CPU|, as the CPU parity tests; the metrics' loss 1e-5
    and grad norm 1e-4 relative; parameters after three steps within lr
    (3e-4) and their RMS difference within 1e-6: AdamW's first steps move
    an element by ~lr · g / |g|, so an element whose gradient is near its
    rounding noise can land up to ~lr away (2.7e-5 seen on the card),
    while the bulk must agree. The MoE archs' routed expert ids, card =
    CPU in every routing of the loss, its recompute and the steps."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, lm_loss
    from repro_torch.train.loop import TrainState, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.utils import tree_leaves as leaves
    out = {}
    for cfg in _lm_smoke_configs():
        cfg = dataclasses.replace(cfg, remat="block")
        params = init_params(cfg, 0, "cpu")
        res, routes = [], []
        ops.reset_launches()
        for d in (dev, torch.device("cpu")):
            p = _tree_to(params, d)
            tensors = [t.requires_grad_() for _, t in leaves(p)]
            with _RecordRoutes() as ids:
                loss, _ = lm_loss(p, _train_batch(cfg, 4, 64, 0, d), cfg)
                grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                            materialize_grads=True)
            res.append((float(loss.detach()), [x.cpu() for x in grads]))
            routes.append(ids)
        launches = dict(ops.LAUNCHES)
        grad_err = max(float((a - w).abs().max()) / float(w.abs().max())
                       for a, w in zip(res[0][1], res[1][1])
                       if float(w.abs().max()) > 0)
        steps = {}
        for mode in ("scan_grads", "grad_of_scan"):
            step = make_train_step(cfg, OptimizerConfig(
                warmup_steps=1, total_steps=10, accum_dtype="float32"),
                n_microbatches=2, accum_mode=mode)
            finals = []
            for d in (dev, torch.device("cpu")):
                p = _tree_to(params, d)
                st = TrainState(p, init_opt_state(p), torch.zeros(
                    (), dtype=torch.int32, device=d))
                mets = []
                with _RecordRoutes() as ids:
                    for i in range(3):
                        st, m = step(st, _train_batch(cfg, 4, 64, 10 + i, d))
                        mets.append({k: float(v) for k, v in m.items()})
                finals.append((st, mets, ids))
            diffs = [(a.cpu() - w).flatten() for (_, a), (_, w)
                     in zip(leaves(finals[0][0].params),
                            leaves(finals[1][0].params))]
            perr = max(float(x.abs().max()) for x in diffs)
            rms = float(torch.cat(diffs).square().mean().sqrt())
            steps[mode] = {
                "metrics_card": finals[0][1], "metrics_cpu": finals[1][1],
                "param_max_abs_err": perr, "param_rms_err": rms}
            if cfg.is_moe:
                steps[mode]["expert_ids_equal_cpu"] = _same_routes(
                    finals[0][2], finals[1][2])
            _need(perr <= 3e-4 and rms <= 1e-6,
                  f"LM train parity {cfg.name} {mode}: parameters differ by "
                  f"{perr} (max) / {rms} (RMS) after 3 steps")
            for mc, mh in zip(finals[0][1], finals[1][1]):
                _need(abs(mc["loss"] - mh["loss"]) <= 1e-5 * abs(mh["loss"])
                      and abs(mc["grad_norm"] - mh["grad_norm"])
                      <= 1e-4 * mh["grad_norm"],
                      f"LM train parity {cfg.name} {mode}: metrics {mc} vs "
                      f"{mh}")
            _need(steps[mode].get("expert_ids_equal_cpu", True),
                  f"LM train parity {cfg.name} {mode}: the card routes "
                  "tokens to other experts")
        r = {"loss_card": res[0][0], "loss_cpu": res[1][0],
             "grad_max_rel_err": grad_err, "launches": launches,
             "steps": steps}
        if cfg.is_moe:
            r["routings"] = len(routes[1])
            r["expert_ids_equal_cpu"] = _same_routes(*routes)
        out[cfg.name] = r
        _need(abs(res[0][0] - res[1][0]) <= 1e-5 * abs(res[1][0]),
              f"LM train parity {cfg.name}: loss {res[0][0]} vs {res[1][0]}")
        _need(grad_err <= 2e-5, f"LM train parity {cfg.name}: gradients "
              f"differ by {grad_err} of their max")
        _need(r.get("expert_ids_equal_cpu", True),
              f"LM train parity {cfg.name}: the card routes tokens to other "
              "experts")
        want = _train_launches(cfg)
        _need(all(launches[k] == n for k, n in want.items()),
              f"LM train parity {cfg.name}: launches {launches}, want {want}")
    print("lm_train_parity", json.dumps(out), flush=True)
    return out


def lm_train_phase(dev) -> dict:
    """``LM_TRAIN``'s models at full width (n_layers cut to 4 but for
    zamba2-1.2b and internvl2-1b) training through ``make_train_step`` on
    ``TokenPipeline`` batches (dedup on the card), internvl2-1b's with
    seeded bf16 ``patch_embeds``: seq 2048, the global batch in
    microbatches, fp32 accumulation, remat "block", bf16 parameters; one
    warm-up step, then ``LM_TRAIN_STEPS`` timed steps with the launch
    counters zeroed just before and read just after
    (``_train_launches`` × microbatches × steps)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, apply_updates
    from repro_torch.utils import tree_bytes, tree_map, tree_param_count
    out = {}
    for arch, (batch, n_mb, cut) in LM_TRAIN.items():
        full = get_config(arch)
        cfg = dataclasses.replace(
            full, n_layers=LM_TRAIN_LAYERS if cut else full.n_layers,
            remat="block")
        torch.cuda.empty_cache()
        state = init_train_state(cfg, 0, dev)
        opt_cfg = OptimizerConfig(warmup_steps=1,
                                  total_steps=LM_TRAIN_STEPS + 1,
                                  accum_dtype="float32")
        step = make_train_step(cfg, opt_cfg, n_microbatches=n_mb)
        t0 = time.perf_counter()
        pipe = TokenPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
            global_batch=batch, seed=0), device=dev)
        it = pipe.batches()
        batches = []
        for i in range(LM_TRAIN_STEPS + 1):
            tb = {k: torch.as_tensor(v, device=dev)
                  for k, v in next(it).items()}
            if cfg.frontend == "patch":
                tb["patch_embeds"] = _patch_embeds(cfg, batch, i, dev)
            batches.append(tb)
        data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, m = step(state, batches[0])
        losses = [float(m["loss"])]
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        walls = []
        for tb in batches[1:]:
            t0 = time.perf_counter()
            state, m = step(state, tb)
            losses.append(float(m["loss"]))     # the step's one read-back
            walls.append(time.perf_counter() - t0)
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        zeros = tree_map(torch.zeros_like, state.opt["master"])
        adamw_ms = _time_ms(lambda: apply_updates(
            state.params, zeros, state.opt, opt_cfg), iters=3, warmup=1,
            primed=False)
        del zeros
        tokens = batch * LM_TRAIN_SEQ
        wall = sorted(walls)[len(walls) // 2]
        widths = {k: getattr(cfg, k) for k in (
            "d_model", "n_heads", "n_kv_heads", "hd", "d_ff", "d_inner",
            "ssm_state", "vocab_size", "n_experts", "moe_top_k", "expert_ff",
            "n_shared_experts", "shared_attn_every", "n_patches")}
        r = {"reduced": {"n_layers": [full.n_layers, cfg.n_layers]}
             if cut else {}, "widths": widths,
             "seq": LM_TRAIN_SEQ, "global_batch": batch,
             "microbatches": n_mb, "remat": cfg.remat,
             "data_s": data_s, "warmup_s": warm_s, "step_walls_s": walls,
             "step_wall_s": wall, "tokens_per_s": tokens / wall,
             "adamw_ms": adamw_ms, "adamw_share": adamw_ms / 1e3 / wall,
             "peak_memory_bytes": peak,
             "params": tree_param_count(state.params),
             "param_bytes": tree_bytes(state.params),
             "opt_bytes": tree_bytes(state.opt), "losses": losses,
             "first_loss": losses[0], "last_loss": losses[-1],
             "dedup": pipe.dedup_stats, "launches": launches}
        print("lm_train", cfg.name, json.dumps(r), flush=True)
        want = {k: n * n_mb * LM_TRAIN_STEPS
                for k, n in _train_launches(cfg).items()}
        _need(all(math.isfinite(x) for x in losses),
              f"{cfg.name}: a loss is not finite: {losses}")
        _need(all(launches[k] == n for k, n in want.items()),
              f"{cfg.name}: launches {launches}, want {want} (a "
              "microbatch's launches x microbatches x steps)")
        out[full.name] = r
        del state, batches, step
    return out


def moe_repeat_phase(dev) -> dict:
    """MoE training repeats bit for bit on the card: deepseek-moe-16b's
    bf16 smoke config, gradients twice from one state and a train step
    from two copies of one state, every leaf of parameters and optimizer
    state equal, and the warnings a third step raises under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the ops
    PyTorch lists as not repeatable; reported); then at full width (4
    layers, seq 2048, 2 microbatches) the gradients of one microbatch
    twice, equal, and a train step twice
    from the seeded initial state, compared by a digest of every leaf
    (two copies of the ~44 GB state do not fit the card): the int64 sum of
    its bit patterns and their sum weighted by position."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import init_params, lm_loss
    from repro_torch.train.loop import (TrainState, init_train_state,
                                        make_train_step)
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.utils import tree_leaves

    def grads(cfg, params, batch):
        ts = [t.requires_grad_() for _, t in tree_leaves(params)]
        loss, _ = lm_loss(params, batch, cfg)
        g = torch.autograd.grad(loss, ts, allow_unused=True,
                                materialize_grads=True)
        for t in ts:
            t.requires_grad_(False)
        return g

    def leaves(st):
        return [t for _, t in tree_leaves(st.params)] + \
            [t for _, t in tree_leaves(st.opt)]

    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=10,
                              accum_dtype="float32")
    out = {}
    cfg = get_smoke_config("deepseek-moe-16b")
    params = init_params(cfg, 0, dev)
    batch = _train_batch(cfg, 4, 64, 0, dev)
    g = [grads(cfg, params, batch) for _ in range(2)]
    step = make_train_step(cfg, opt_cfg, n_microbatches=2)
    runs = []
    for _ in range(2):
        p = _tree_to(params, dev)
        runs.append(leaves(step(TrainState(p, init_opt_state(p), torch.zeros(
            (), dtype=torch.int32, device=dev)), batch)[0]))
    # the ops PyTorch itself lists as not repeatable on CUDA, if the step
    # runs any: one more step in its deterministic mode, warnings only
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p = _tree_to(params, dev)
            step(TrainState(p, init_opt_state(p), torch.zeros(
                (), dtype=torch.int32, device=dev)), batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    out[cfg.name] = {
        "grads_equal": all(torch.equal(a, b) for a, b in zip(*g)),
        "step_equal": all(torch.equal(a, b) for a, b in zip(*runs)),
        "deterministic_mode_warnings": sorted(
            {str(w.message)[:200] for w in caught
             if "deterministic" in str(w.message)})}
    del g, runs, params, p

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              n_layers=LM_TRAIN_LAYERS, remat="block")
    torch.cuda.empty_cache()
    params = init_params(cfg, 0, dev)
    g = [grads(cfg, params, _train_batch(cfg, 1, LM_TRAIN_SEQ, 1, dev))
         for _ in range(2)]
    grads_equal = all(torch.equal(a, b) for a, b in zip(*g))
    del g, params
    step = make_train_step(cfg, opt_cfg, n_microbatches=2)
    batch = _train_batch(cfg, 2, LM_TRAIN_SEQ, 2, dev)
    digests, losses = [], []
    for _ in range(2):
        torch.cuda.empty_cache()
        st, m = step(init_train_state(cfg, 0, dev), batch)
        losses.append(float(m["loss"]))
        digests.append(_leaf_digest(leaves(st)))
        del st
    out[cfg.name] = {"reduced": {"n_layers": [28, cfg.n_layers]},
                     "grads_equal": grads_equal,
                     "step_digest_equal": digests[0] == digests[1],
                     "leaves": len(digests[0]), "losses": losses}
    print("moe_repeat", json.dumps(out), flush=True)
    for name, r in out.items():
        _need(all(v for k, v in r.items() if k.endswith("equal")),
              f"MoE training does not repeat on the card: {name} {r}")
    return out


def detect_step_phase(dev) -> dict:
    """``core.detect.detect_step`` at the paper widths (``fast_seismic.
    config()``, statistics at rate 1.0) on each station of phase 4's
    20-minute trace as one chunk, given the CPU's frozen statistics
    (``station_stats``): the card's outputs equal the CPU path's (all
    integers and masks, so exactly, as phase 4 holds its pairs), launch
    counters zeroed just before and read just after the card's calls
    (``stft_mag``, ``haar2d``, ``minmax_sig_buckets`` and
    ``occurrence_filter`` once a call, no other kernel), the card's
    walls."""
    import dataclasses
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.core.detect import detect_step, station_stats
    from repro_torch.kernels import ops
    ds = make_dataset(SynthConfig(**PARITY_SYNTH))
    cfg = fast_seismic.config()
    cfg = dataclasses.replace(cfg, fingerprint=dataclasses.replace(
        cfg.fingerprint, mad_sample_rate=1.0))
    wave = torch.as_tensor(ds.waveforms)
    meds, mads = station_stats(wave, cfg.fingerprint)
    n = wave.shape[0]
    detect_step(wave[0].to(dev), meds[0], mads[0], cfg)     # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    card, walls = [], []
    for st in range(n):
        t0 = time.perf_counter()
        r = detect_step(wave[st].to(dev), meds[st], mads[st], cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        card.append({k: v.cpu() for k, v in r.items()})
    launches = dict(ops.LAUNCHES)
    cpu = [detect_step(wave[st], meds[st], mads[st], cfg, device="cpu")
           for st in range(n)]
    equal = all(torch.equal(a[k], b[k]) for a, b in zip(card, cpu)
                for k in b)
    out = {"synth": PARITY_SYNTH, "chunk_samples": wave.shape[1],
           "pairs": [int(r["pair_valid"].sum()) for r in cpu],
           "events": [int(r["ev_valid"].sum()) for r in cpu],
           "equal_cpu": equal, "walls_s": walls, "launches": launches}
    print("detect_step", json.dumps(out), flush=True)
    want = {k: (n if k in ("stft_mag", "haar2d", "minmax_sig_buckets",
                           "occurrence_filter") else 0) for k in launches}
    _need(sum(out["pairs"]) > 0, "detect_step found no pairs on the trace")
    _need(equal, "detect_step: the card's outputs differ from the CPU's")
    _need(launches == want, f"detect_step launches {launches}, want {want}")
    return out


def _sharded_stream(ds, dev, width: int, want: dict, tmp=None) -> dict:
    """Phase 7's stream under the ``width``-wide mesh ``[dev] * width``
    (phase 30a): launch counters zeroed just before and read just after,
    ``memory_allocated`` read before and after the steady pushes
    ``SHARDED_MEMORY_PUSHES``, and with ``tmp`` a snapshot after the
    halfway push (its write outside the walls). The record must equal
    phase 7's. Earlier detectors (their stations point back at them) are
    collected first, so the memory read is this run's and phase 7's
    record's only."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.kernels import ops
    from repro_torch.stream import StreamingDetector
    cfg, scfg = fast_seismic.config(), fast_seismic.stream_config()
    wave = ds.waveforms
    starts = list(range(0, wave.shape[1], STREAM_CHUNK))
    half = len(starts) // 2
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    det = StreamingDetector(cfg, scfg, n_stations=wave.shape[0], device=dev,
                            devices=[dev] * width)
    walls, memory, write_s = [], {}, None
    for i, a in enumerate(starts):
        if i in SHARDED_MEMORY_PUSHES:
            torch.cuda.synchronize()
            memory[i] = torch.cuda.memory_allocated(dev)
        if tmp is not None and i == half:
            t = time.perf_counter()
            det.snapshot(tmp, step=half)
            write_s = time.perf_counter() - t
        t = time.perf_counter()
        det.push(wave[:, a:a + STREAM_CHUNK])
        walls.append(time.perf_counter() - t)
    t = time.perf_counter()
    dets, events, stats = det.finalize()
    finalize_s = time.perf_counter() - t
    wall = sum(walls) + finalize_s
    launches = dict(ops.LAUNCHES)
    blocks = det.stations[0].stats.blocks
    spans = det.telemetry.tracer.summary()
    got = _stream_record(det, dets, events, stats)
    same = {k: got[k] == want[k] for k in got}
    out = {"devices": [str(dev)] * width, "mesh": det.mesh.size,
           "pool_pad": det.pool_pad, "shard_rows": det.pstate[0].halo.shape[0],
           "pushes": len(walls), "blocks": blocks, "wall_s": wall,
           "real_time_factor": wave.shape[1] / cfg.fingerprint.fs / wall,
           "push_ms_p50": float(np.percentile(walls, 50)) * 1e3,
           "push_ms_p99": float(np.percentile(walls, 99)) * 1e3,
           "span_s": {k: spans.get(k, {"total_s": 0.0})["total_s"]
                      for k in ("ingest", "dup_hash", "fused_step",
                                "host_tail")},
           "memory_before_bytes": base,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "memory_allocated": {str(k): v for k, v in memory.items()},
           "snapshot_write_s": write_s, "launches": launches,
           "pairs_per_station": [st.stats.pairs for st in det.stations],
           "equal_stream_paper": same}
    _need(all(same.values()), f"sharded stream ({width}-wide): the record "
          f"differs from phase 7's pooled run: {same}")
    _need(len(set(memory.values())) == 1, f"sharded stream ({width}-wide): "
          f"memory_allocated moved over steady pushes: {memory}")
    for name in BATCH_KERNELS:
        _need(launches[name] >= width * blocks,
              f"sharded stream ({width}-wide): {name} launched "
              f"{launches[name]} times, fewer than {width} shards × {blocks} "
              f"blocks")
    return out


def _sharded_restore(ds, dev, tmp: str, want: dict, devices) -> dict:
    """Phase 30c: the 3-wide pool's snapshot restored under ``devices``
    (``None``: no mesh) and pushed to the end; its record against phase
    7's."""
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.stream import StreamingDetector
    cfg, scfg = fast_seismic.config(), fast_seismic.stream_config()
    wave = ds.waveforms
    t0 = time.perf_counter()
    det, step = StreamingDetector.restore(tmp, cfg, scfg, device=dev,
                                          devices=devices)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a in list(range(0, wave.shape[1], STREAM_CHUNK))[step:]:
        det.push(wave[:, a:a + STREAM_CHUNK])
    dets, events, stats = det.finalize()
    rest_s = time.perf_counter() - t0
    got = _stream_record(det, dets, events, stats)
    same = {k: got[k] == want[k] for k in got}
    width = det.mesh.size if det.mesh else 1
    _need(all(same.values()), f"snapshot of the 3-wide pool restored on a "
          f"{width}-wide mesh differs from the uninterrupted run: {same}")
    return {"step": step, "mesh": width, "pool_pad": det.pool_pad,
            "restore_s": restore_s, "rest_s": rest_s, "equal": same}


def sharded_phase(ds, dev, want: dict, stream7: dict, tmp: str) -> dict:
    """Phase 30a–c: the station-sharded pool on one card. Every shard runs
    on ``dev`` (``[dev] * width``), so the shards serialise: this holds the
    split to phase 7's answers, it does not time multi-card scaling.
    (a) phase 7's stream under 2- and 3-wide meshes (the 3-wide pool has
    two pad rows and is snapshotted at push 720); (c) that snapshot
    restored with no mesh and under the 2-wide mesh; (b) phase 18's join
    and leave over it under the 3-wide mesh. Each must equal phase 7's
    record."""
    out = {"stream": {}, "restore": {}}
    for width in SHARDED_WIDTHS:
        out["stream"][str(width)] = _sharded_stream(
            ds, dev, width, want, tmp if width == 3 else None)
    for label, devices in (("none", None), ("2", [dev] * 2)):
        out["restore"][label] = _sharded_restore(ds, dev, tmp, want, devices)
    out["fused_step_vs_stream_paper"] = {
        w: r["span_s"]["fused_step"] / stream7["span_s"]["fused_step"]
        for w, r in out["stream"].items()}
    out["launches"] = out["stream"]["3"]["launches"]
    print("sharded_stream", json.dumps(out), flush=True)
    return out


def detect_sharded_phase(dev) -> dict:
    """Phase 30d: ``core.detect.detect_step_sharded`` at
    ``SHAPES["station_month"]`` (512 chunks × 512,000 samples, a seeded
    one-station synthetic month) at the paper widths under
    ``[dev] * DETECT_SHARDED_WIDTH``, ``DETECT_SHARDED_GROUP`` chunks a
    pooled call, launch counters zeroed just before and read just after:
    wall, chunks and fingerprints a second, ``model_flops`` over the wall
    beside the card's fp32 rate, memory before (the month's samples
    included) and at peak, the outputs' bytes; a seeded sample of
    ``DETECT_SHARDED_SAMPLE`` chunks equals the CPU path's ``detect_step``
    on each chunk alone, exactly (integer outputs), as phase 29 holds the
    card to the CPU: the kernels' plain versions at this path's shapes."""
    import gc
    import numpy as np
    import torch
    from repro_torch import dist
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.core.detect import (detect_step, detect_step_sharded,
                                         station_stats)
    from repro_torch.kernels import ops
    cfg = fast_seismic.config()
    n_chunks, chunk = fast_seismic.SHAPES[DETECT_SHARDED_SHAPE]
    t0 = time.perf_counter()
    ds = make_dataset(SynthConfig(duration_s=n_chunks * chunk / 100.0,
                                  n_stations=1, n_sources=8,
                                  events_per_source=400, event_snr=6.0,
                                  seed=7))
    synth_s = time.perf_counter() - t0
    wave = torch.as_tensor(ds.waveforms[0]).to(dev)
    del ds
    meds, mads = station_stats(wave[None, :4 * chunk], cfg.fingerprint)
    chunks = wave.reshape(n_chunks, chunk)
    mesh = dist.station_mesh(devices=[dev] * DETECT_SHARDED_WIDTH)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = detect_step_sharded(chunks, meds[0], mads[0], cfg, mesh,
                              group=DETECT_SHARDED_GROUP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rows = sorted(np.random.default_rng(3).choice(
        n_chunks, DETECT_SHARDED_SAMPLE, replace=False).tolist())
    equal, t0 = [], time.perf_counter()
    for r in rows:
        one = detect_step(chunks[r].cpu(), meds[0].cpu(), mads[0].cpu(), cfg,
                          device="cpu")
        equal.append(all(torch.equal(one[k], out[k][r].cpu()) for k in one))
    cpu_s = time.perf_counter() - t0
    n_fp = cfg.fingerprint.n_fingerprints(chunk)
    flops = fast_seismic.model_flops(DETECT_SHARDED_SHAPE)
    calls = n_chunks // DETECT_SHARDED_GROUP
    res = {"shape": [n_chunks, chunk], "mesh": mesh.size,
           "group": DETECT_SHARDED_GROUP, "pooled_calls": calls,
           "synth_s": synth_s, "wall_s": wall,
           "chunks_per_s": n_chunks / wall,
           "fingerprints_per_chunk": n_fp,
           "fingerprints_per_s": n_chunks * n_fp / wall,
           "model_flops": flops, "model_flops_per_s": flops / wall,
           "fp32_peak_flops_per_s": cost.FP32_OPS_PER_S,
           "memory_before_bytes": base, "peak_memory_bytes": peak,
           "output_bytes": sum(v.numel() * v.element_size()
                               for v in out.values()),
           "pairs": int(out["pair_valid"].sum()),
           "events": int(out["ev_valid"].sum()),
           "sample": rows, "sample_equal_cpu": equal,
           "sample_cpu_s": cpu_s, "launches": launches}
    print("detect_step_sharded", json.dumps(res), flush=True)
    _need(all(equal), f"detect_step_sharded: sampled chunks differ from "
          f"the CPU's detect_step: {dict(zip(rows, equal))}")
    want = {k: (calls if k in ("stft_mag", "haar2d", "minmax_sig_buckets")
                else n_chunks if k == "occurrence_filter" else 0)
            for k in launches}
    _need(launches == want, f"detect_step_sharded launches {launches}, "
          f"want {want}")
    return res


def train_resume_phase(tmp: str) -> dict:
    """For each of ``RESUME_ARCHS`` (the launcher's smoke model, an MoE
    and a hybrid smoke config): ``python -m repro_torch.launch.train
    --device cuda`` for 8 steps uninterrupted and, beside it on the same
    card, again with ``--inject-failure-at 5``, which must exit 42 before
    step 5's checkpoint; then ``--resume`` of the second: the final
    checkpoint (parameters, master, moments, steps) and the final loss
    must equal the uninterrupted run's bit for bit. The archs' runs go
    side by side: the six first runs at once, then the three resumes."""
    import os
    import numpy as np
    from repro_torch.train import checkpoint as ckpt
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def start(arch, smoke, args):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               arch, "--steps", "8", "--seq", "64", "--batch", "4",
               "--ckpt-every", "2", "--seed", "3", "--device", "cuda"]
        return subprocess.Popen(cmd + (["--smoke"] if smoke else []) + args,
                                env=env, text=True, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)

    def finish(p):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        return p.returncode, err

    t0 = time.perf_counter()
    procs = {arch: [start(arch, smoke, ["--ckpt-dir", f"{tmp}/{arch}/ref",
                                        "--metrics-out",
                                        f"{tmp}/{arch}/ref.json"]),
                    start(arch, smoke, ["--ckpt-dir", f"{tmp}/{arch}/crash",
                                        "--inject-failure-at", "5"])]
             for arch, smoke in RESUME_ARCHS}
    done = {arch: [finish(p) for p in ps] for arch, ps in procs.items()}
    walls = {"uninterrupted_and_crash": time.perf_counter() - t0}
    for arch, ((ref_rc, ref_err), (crash_rc, crash_err)) in done.items():
        _need(ref_rc == 0, f"train launcher {arch} failed: {ref_err[-800:]}")
        _need(crash_rc == 42, f"{arch} --inject-failure-at 5 exited "
              f"{crash_rc}, not 42: {crash_err[-800:]}")
        _need(ckpt.latest_step(f"{tmp}/{arch}/crash") == 4,
              f"{arch}: the crashed run's latest checkpoint is not step 4")
    t0 = time.perf_counter()
    procs = {arch: start(arch, smoke, ["--ckpt-dir", f"{tmp}/{arch}/crash",
                                       "--resume", "--metrics-out",
                                       f"{tmp}/{arch}/res.json"])
             for arch, smoke in RESUME_ARCHS}
    resumed = {arch: finish(p) for arch, p in procs.items()}
    walls["resume"] = time.perf_counter() - t0
    out = {"walls_s": walls}
    for arch, (res_rc, res_err) in resumed.items():
        _need(res_rc == 0, f"{arch} --resume failed: {res_err[-800:]}")
        a, _, _ = ckpt.restore_flat(f"{tmp}/{arch}/ref")
        b, _, _ = ckpt.restore_flat(f"{tmp}/{arch}/crash")
        equal = sorted(a) == sorted(b) and all(
            np.array_equal(a[k], b[k]) for k in a)
        want = json.loads(pathlib.Path(f"{tmp}/{arch}/ref.json").read_text())
        got = json.loads(pathlib.Path(f"{tmp}/{arch}/res.json").read_text())
        out[arch] = {"leaves": len(a), "bitwise_equal": equal,
                     "final_loss": [want["final_loss"], got["final_loss"]],
                     "crash_rc": done[arch][1][0], "dedup": got["dedup"]}
        _need(equal, f"{arch}: the resumed run's final state differs from "
              "the uninterrupted run's")
        _need(got["final_loss"] == want["final_loss"],
              f"{arch}: final losses differ: {out[arch]['final_loss']}")
    print("train_resume", json.dumps(out), flush=True)
    return out


def _leaf_digest(ts) -> list:
    """Each tensor's digest: the int64 sum of its bit patterns and their
    sum weighted by position (two copies of a full-width state do not fit
    the card together)."""
    import torch
    out = []
    for t in ts:
        t = t.reshape(-1)
        bits = t.view(torch.int16 if t.element_size() == 2
                      else torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 1000003 + 1
        out.append((int(bits.sum()), int((bits * w).sum())))
    return out


def _pipeline_batches(cfg, batch: int, n: int, dev) -> list:
    """Phase 26's first ``n`` ``TokenPipeline`` batches (seed 0, seq
    ``LM_TRAIN_SEQ``, dedup on the card)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    it = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
        global_batch=batch, seed=0), device=dev).batches()
    return [{k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
            for _ in range(n)]


def _collectives(prof) -> dict:
    """A profiled step's collectives: the host's collective calls
    (``c10d::`` / ``nccl:`` ranges), the NCCL kernels' device time and
    count, and the device-to-device copies' (NCCL runs a one-rank
    communicator's collectives as copies)."""
    import torch
    out = {"calls": 0, "nccl_kernels": 0, "nccl_kernel_ms": 0.0,
           "dtod_copies": 0, "dtod_copy_ms": 0.0}
    for e in prof.events():
        name = e.name.lower()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            if "nccl" in name:
                out["nccl_kernels"] += 1
                out["nccl_kernel_ms"] += ms
            elif "dtod" in name.replace(" ", "").replace("-", ""):
                out["dtod_copies"] += 1
                out["dtod_copy_ms"] += ms
        elif name.startswith(("c10d::", "nccl:", "gloo:")):
            out["calls"] += 1
    return out


def _same_or_close(a: list, b: list, what: str) -> str:
    """"bitwise" when every pair of tensors is equal, "within 1e-6" when
    each differs by at most ``MESH_TOL`` of its max|·|; else the run
    fails."""
    import torch
    if all(torch.equal(x, y) for x, y in zip(a, b)):
        return "bitwise"
    for x, y in zip(a, b):
        x, y = x.float(), y.float()
        err = float((x - y).abs().max())
        _need(err <= MESH_TOL * max(float(y.abs().max()), 1e-30),
              f"{what}: the mesh differs from no mesh by {err}")
    return f"within {MESH_TOL}"


def _mesh_cell(arch: str, steps: int, dev) -> dict:
    """Phase 31a / b: ``steps`` no-mesh steps of phase 26's cell, then the
    same from the same state under a (1, 1) mesh with ZeRO."""
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import (init_train_state, make_train_step,
                                        shard_train_state)
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.utils import tree_leaves
    batch, n_mb, _ = LM_TRAIN[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=LM_TRAIN_LAYERS,
                              remat="block")
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=LM_TRAIN_STEPS + 1,
                              accum_dtype="float32")
    batches = _pipeline_batches(cfg, batch, steps, dev)
    mesh = make_host_mesh((1, 1))
    runs = []
    for use_mesh in (False, True):
        torch.cuda.empty_cache()
        state = init_train_state(cfg, 0, dev)
        ctx = mesh if use_mesh else _Null()
        with ctx, _RecordRoutes() as ids:
            state = shard_train_state(state, cfg)
            step = make_train_step(cfg, opt_cfg, n_microbatches=n_mb,
                                   shard_grads_like_opt=use_mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            metrics, walls = [], []
            for b in batches:
                t0 = time.perf_counter()
                state, m = step(state, b)
                metrics.append({k: m[k].detach().clone() for k in m})
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            launches = dict(ops.LAUNCHES)
        r = {"metrics": [{k: float(v) for k, v in m.items()}
                         for m in metrics],
             "step_walls_s": walls, "launches": launches,
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "params_host": [t.to("cpu", copy=True)
                             for _, t in tree_leaves(state.params)],
             "opt_digest": _leaf_digest(
                 [t for _, t in tree_leaves(state.opt)]),
             "routes": [t.cpu() for t in ids]}
        if use_mesh:    # one more step, profiled, for its collectives
            dist.reset_collectives()
            with mesh, torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                step(state, batches[-1])
                torch.cuda.synchronize()
            r["collectives"] = _collectives(prof)
            r["collectives"]["by_op"] = dict(dist.COLLECTIVES)
        runs.append((r, metrics))
        del state, step
    (a, ma), (b, mb) = runs
    out = {"reduced": {"n_layers": [get_config(arch).n_layers,
                                    cfg.n_layers]},
           "mesh": {"data": 1, "model": 1}, "steps": steps,
           "metrics_no_mesh": a["metrics"], "metrics_mesh": b["metrics"],
           "step_walls_no_mesh_s": a["step_walls_s"],
           "step_walls_mesh_s": b["step_walls_s"],
           "collectives_profiled_step": b["collectives"],
           "peak_memory_no_mesh_bytes": a["peak_memory_bytes"],
           "peak_memory_mesh_bytes": b["peak_memory_bytes"],
           "launches_no_mesh": a["launches"], "launches": b["launches"],
           "expert_parallel": cfg.is_moe}
    out["loss_and_grad_norm"] = _same_or_close(
        [x[k] for x in ma for k in ("loss", "grad_norm")],
        [x[k] for x in mb for k in ("loss", "grad_norm")],
        f"{arch} loss / grad norm")
    out["params"] = _same_or_close(b["params_host"], a["params_host"],
                                   f"{arch} parameters")
    out["opt_digest_equal"] = a["opt_digest"] == b["opt_digest"]
    if cfg.is_moe:
        out["routings"] = len(b["routes"])
        out["expert_ids_equal"] = _same_routes(b["routes"], a["routes"])
        _need(out["expert_ids_equal"], f"{arch}: the mesh routes tokens to "
              "other experts")
    want = {k: n * n_mb * steps for k, n in _train_launches(cfg).items()}
    _need(all(b["launches"][k] == n for k, n in want.items()),
          f"{arch} mesh: launches {b['launches']}, want {want}")
    _need(b["collectives"]["calls"] > 0,
          f"{arch} mesh: no collective ran: {b['collectives']}")
    return out


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _compression_cell(dev) -> dict:
    """Phase 31c: ``pod_compressed_value_and_grad`` under a (1, 1, 1)
    pod×data×model mesh on 31a's cell and first microbatch, against the
    port's plain quantize / dequantize of the exact gradients."""
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.models.decoder import lm_loss, place_params
    from repro_torch.train import compression as C
    from repro_torch.train.loop import reduce_gradients
    from repro_torch.models import init_params
    from repro_torch.utils import tree_leaves, tree_unflatten
    arch = "qwen2.5-14b"
    cfg = dataclasses.replace(get_config(arch), n_layers=LM_TRAIN_LAYERS,
                              remat="block")
    torch.cuda.empty_cache()
    mesh = dist.LMMesh((1, 1, 1), ("pod", "data", "model"))
    batch = {k: v[:1] for k, v in _pipeline_batches(cfg, 2, 1, dev)[0]
             .items()}
    with mesh, dist.manual_axes({"pod"}):
        params = place_params(init_params(cfg, 0, dev), cfg)
    wire = []
    inner = dist._all_gather

    def record(out, inp, group=None, **kw):
        # on one rank every axis's group is the world group: the pod
        # exchange is told by its int8 payload (the gloo test checks the
        # pod group's dtypes)
        if inp.dtype == torch.int8:
            wire.append(inp.numel())
        return inner(out, inp, group=group, **kw)

    f = C.pod_compressed_value_and_grad(
        lambda p, b: lm_loss(p, b, cfg)[0], mesh, cfg=cfg)
    dist._all_gather = record
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        loss_c, grads_c = f(params, batch)
        torch.cuda.synchronize()
    finally:
        dist._all_gather = inner
    wall = time.perf_counter() - t0
    paths, tensors = zip(*tree_leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    with mesh, dist.manual_axes({"pod"}):
        loss = lm_loss(params, batch, cfg)[0]
        flat = torch.autograd.grad(loss, tensors, allow_unused=True,
                                   materialize_grads=True)
        for t in tensors:
            t.requires_grad_(False)
        exact = reduce_gradients(tree_unflatten(paths, flat), cfg)
    del flat
    equal, worst, fp32_bytes = True, 0.0, 0
    for (path, g), (_, gc) in zip(tree_leaves(exact),
                                  tree_leaves(grads_c)):
        q, scale = C._quantize(g)
        deq = (q.float() * scale.reshape((-1,) + (1,) * g.ndim)).mean(0)
        equal &= torch.equal(deq.to(g.dtype), gc)
        err = float((deq - g.float()).abs().max())
        worst = max(worst, err / float(scale))
        fp32_bytes += 4 * g.numel()
    int8_bytes = sum(wire)
    out = {"loss_compressed": float(loss_c),
           "loss_exact": float(loss.detach()),
           "grads_equal_plain_quantized": equal,
           "max_error_over_scale": worst, "wall_s": wall,
           "int8_gathers": len(wire), "int8_bytes": int8_bytes,
           "fp32_bytes_replaced": fp32_bytes,
           "bytes_ratio": fp32_bytes / max(int8_bytes, 1)}
    _need(equal, "31c: compressed gradients differ from the plain "
          "quantize / dequantize of the exact ones")
    # half the scale, plus the fp32 rounding of g / scale and of q · scale
    # (|q| ≤ 127: 2⁻²⁴ of each, relative)
    _need(worst <= 0.5 + 127 * 2.0 ** -22, f"31c: a leaf's quantization "
          f"error is {worst} of its scale")
    _need(len(wire) == len(paths), f"31c: {len(wire)} int8 gathers for "
          f"{len(paths)} leaves")
    _need(float(loss_c) == float(loss), "31c: the pod loss differs")
    return out


def _rank_numel(rule: tuple, shape: tuple, data: int, model: int) -> int:
    """A leaf's elements on one rank of a (data, model) mesh under the tp
    layout: each dim whose entry names an axis of the mesh that divides
    it ("vocab" is ``model``) cut by that axis, as ``sanitize_spec``
    cuts it."""
    size = {"data": data, "model": model, "vocab": model, "pod": 1}
    n = 1
    for e, d in zip(tuple(rule) + (None,) * len(shape), shape):
        k = 1
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            k *= size[a]
        n *= d // k if d % k == 0 else d
    return n


def _command_r_reckoning(dev) -> dict:
    """Phase 31d: command-r-35b's 4-layer cut per rank on the (data,
    model) layouts ``MESH_LAYOUTS`` under the tp layout: bf16 parameters
    in their ``model`` blocks; under ZeRO the fp32 gradient accumulators
    and the fp32 master, m and v in the optimizer's blocks
    (``zero_sharding_entry``: data on the largest dim the rule leaves
    free; an entry that does not divide leaves its dim whole) — the
    state; plus, for the step's peak, one microbatch's bf16 gradients in
    the ``model`` blocks (whole until scattered over data) and its other
    transients, measured on the card at model width 1 (the model split
    divides the layers' intermediates too: kept whole here, an upper
    bound)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.decoder import (param_shapes,
                                            param_sharding_rules)
    from repro_torch.train.optimizer import zero_sharding_entry
    from repro_torch.utils import tree_leaves
    full = get_config("command-r-35b")
    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS, remat="block")
    shapes = dict(tree_leaves(param_shapes(cfg)))
    rules = dict(tree_leaves(param_sharding_rules(cfg)))
    n_params = sum(math.prod(s) for s in shapes.values())
    torch.cuda.empty_cache()
    params = init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ts = [t.requires_grad_() for _, t in tree_leaves(params)]
    loss, _ = lm_loss(params, _train_batch(cfg, 1, LM_TRAIN_SEQ, 0, dev),
                      cfg)
    grads = torch.autograd.grad(loss, ts, allow_unused=True,
                                materialize_grads=True)
    torch.cuda.synchronize()
    micro = torch.cuda.max_memory_allocated() - base
    gbytes = sum(g.numel() * g.element_size() for g in grads)
    del grads, ts, params, loss
    layouts = {}
    for d, m in MESH_LAYOUTS:
        p_numel = sum(_rank_numel(rules[k], shp, d, m)
                      for k, shp in shapes.items())
        o_numel = sum(_rank_numel(zero_sharding_entry(rules[k], shp), shp,
                                  d, m) for k, shp in shapes.items())
        state = 2 * p_numel + 4 * o_numel + 12 * o_numel
        peak = state + 2 * p_numel + (micro - gbytes)
        layouts[f"{d}x{m}"] = {
            "cards": d * m, "data": d, "model": m,
            "param_bytes": 2 * p_numel, "grad_bytes": 4 * o_numel,
            "opt_bytes": 12 * o_numel, "state_bytes": state,
            "microbatch_grad_bytes": 2 * p_numel,
            "step_peak_bytes": peak, "fits": peak <= CARD_BUDGET}
    least = {}
    for cards in sorted({v["cards"] for v in layouts.values()}):
        fit = [k for k, v in layouts.items()
               if v["cards"] == cards and v["fits"]]
        least[cards] = min(fit, key=lambda k: layouts[k]["step_peak_bytes"]
                           ) if fit else None
    return {"reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
            "params": n_params, "microbatch_peak_bytes": micro,
            "microbatch_grad_bytes": gbytes, "budget_bytes": CARD_BUDGET,
            "by_layout": layouts, "least_peak_layout_that_fits": least,
            "least_cards_that_fit": next(
                (c for c, k in least.items() if k is not None), None)}


def mesh_train_phase(dev) -> dict:
    """Phase 31: one NCCL rank on the card (gloo on a CPU rehearsal)."""
    import torch
    from repro_torch import dist
    dist.init_ranks("nccl" if dev.type == "cuda" else "gloo")
    cells = {**{arch: (lambda a=arch, n=steps: _mesh_cell(a, n, dev))
                for arch, steps in MESH_TRAIN.items()},
             "pod_compression": lambda: _compression_cell(dev),
             "command_r_zero": lambda: _command_r_reckoning(dev)}
    out = {}
    try:
        for name, cell in cells.items():
            out[name] = cell()
            print("mesh_train", name, json.dumps(out[name], default=float),
                  flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return out


class _RecordServe:
    """Within the ``with``: the logits of every ``prefill`` and
    ``decode_step`` the serve engine calls, and the collectives of its
    last decode step (the engine's module names wrapped; the model code
    is untouched)."""

    def __enter__(self):
        from repro_torch import dist
        from repro_torch.launch import serve
        self.logits, self.step_collectives = [], {}
        self._saved = (serve.prefill, serve.decode_step)
        prefill, decode_step = self._saved

        def record_prefill(*a, **k):
            out = prefill(*a, **k)
            self.logits.append(out[0].detach().clone())
            return out

        def record_step(*a, **k):
            dist.reset_collectives()
            out = decode_step(*a, **k)
            self.step_collectives = dict(dist.COLLECTIVES)
            self.logits.append(out[0].detach().clone())
            return out

        serve.prefill, serve.decode_step = record_prefill, record_step
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import serve
        serve.prefill, serve.decode_step = self._saved


def _mesh_serve_cell(arch: str, dev) -> dict:
    """Phases 32a and 32e: phase 15's cell of ``arch`` served without a
    mesh, under a (1, 1) data×model mesh in the tp layout (32a: the
    tensor-parallel path with every collective) and in the fsdp layout
    (32e: every layer gathered whole at use, the cache's rows over data),
    one NCCL rank, each after a warm-up: every logit of each mesh run
    against the run without one, tokens/s, the collectives of a decode
    step → {"tp": 32a's record, "fsdp": 32e's}."""
    import numpy as np
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import init_params
    n_req, max_new, n_slots = 8, 32, 4
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=LM_SERVE_LAYERS)
    torch.cuda.empty_cache()
    params = init_params(cfg, 0, dev)
    lens = np.random.default_rng(0).choice([512, 1024, 1536, 2048], n_req)
    prng = np.random.default_rng(1)
    prompts = [prng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    mesh = make_host_mesh((1, 1))
    runs = {}
    for label in ("no_mesh", "tp", "fsdp"):
        ctx = _Null() if label == "no_mesh" else mesh
        with ctx, dist.layout("tp" if label == "no_mesh" else label):
            ServeEngine(cfg, n_slots=n_slots, max_len=2560,
                        params=params).run(
                [Request(i, q, 2) for i, q in enumerate(prompts)])
            eng = ServeEngine(cfg, n_slots=n_slots, max_len=2560,
                              params=params)
            reqs = [Request(i, q, max_new) for i, q in enumerate(prompts)]
            torch.cuda.synchronize()
            ops.reset_launches()
            with _RecordServe() as rec:
                stats = eng.run(reqs)
            torch.cuda.synchronize()
        phase = "32e" if label == "fsdp" else "32a"
        _need(all(q.done and len(q.out) == max_new + 1 for q in reqs),
              f"{phase} {arch} {label}: a request was not served in full")
        runs[label] = {"stats": stats, "logits": rec.logits,
                       "collectives": rec.step_collectives,
                       "launches": dict(ops.LAUNCHES),
                       "tokens": [q.out for q in reqs]}
    kernel = "mamba_scan" if cfg.block_kind == "mamba1" else \
        "flash_attention"
    a = runs["no_mesh"]
    out = {}
    for label, phase in (("tp", "32a"), ("fsdp", "32e")):
        b = runs[label]
        _need(len(a["logits"]) == len(b["logits"]),
              f"{phase} {arch}: {len(a['logits'])} calls without a mesh, "
              f"{len(b['logits'])} with")
        r = {"reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
             "mesh": {"data": 1, "model": 1}, "layout": label,
             "prompt_lens": [int(n) for n in lens],
             "calls": len(b["logits"]),
             "logits": _same_or_close(b["logits"], a["logits"],
                                      f"{phase} {arch} logits"),
             "tokens_equal": a["tokens"] == b["tokens"],
             "tokens_per_s_no_mesh": a["stats"]["tokens_per_s"],
             "tokens_per_s_mesh": b["stats"]["tokens_per_s"],
             "wall_s_no_mesh": a["stats"]["wall_s"],
             "wall_s_mesh": b["stats"]["wall_s"],
             "collectives_a_decode_step": b["collectives"],
             "launches_mesh": {kernel: b["launches"][kernel]},
             "launches_no_mesh": {kernel: a["launches"][kernel]}}
        _need(r["tokens_equal"], f"{phase} {arch}: the mesh generated "
              "other tokens")
        _need(b["launches"][kernel] == a["launches"][kernel] > 0,
              f"{phase} {arch}: {kernel} launched {b['launches'][kernel]} "
              f"times under the mesh, {a['launches'][kernel]} without")
        _need(sum(b["collectives"].values()) > 0,
              f"{phase} {arch}: a decode step ran no collective")
        out[label] = r
    _need(out["fsdp"]["logits"] == "bitwise",
          f"32e {arch}: the fsdp layout's logits are not bitwise equal to "
          "serving without a mesh")
    del params
    return out


def _layer_params(cfg, dev, dt, seed: int) -> dict:
    """One layer's parameters (``decoder._layer_param_shapes``) drawn as
    ``init_params`` draws them, in ``dt``, without the model's tables."""
    import torch
    from repro_torch.models.decoder import _layer_param_shapes
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for blk, leaves in _layer_param_shapes(cfg).items():
        out[blk] = {}
        for name, shp in leaves.items():
            if name == "a_log":
                t = torch.log(torch.arange(1, shp[-1] + 1, device=dev,
                                           dtype=torch.float32)).expand(shp)
            elif name == "dt_bias":
                t = torch.full(shp, -4.6, device=dev)
            elif name in ("ln", "out_ln"):
                t = torch.ones(shp, device=dev)
            else:
                scale = min(1.0 / math.sqrt(shp[-2]) if len(shp) >= 2
                            else 0.02, 0.02)
                t = torch.randn(shp, generator=g, device=dev) * scale
            out[blk][name] = t.to(dt).contiguous()
    return out


def _tp_layer_cell(arch: str, dev) -> dict:
    """Phase 32c: one full-width layer of ``arch``, its tensor-parallel
    parts at ``TP_RANKS`` model ranks played in turn in this process
    (``dist.TensorParallel(TP_RANKS, rank, None)``: no collective) and
    summed here, against the same function at one rank (the unsplit
    layer), in fp32 and bf16."""
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    cfg0 = get_config(arch)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        cfg = dataclasses.replace(cfg0, n_layers=1, param_dtype=name,
                                  compute_dtype=name)
        torch.cuda.empty_cache()
        lp = _layer_params(cfg, dev, dt, 0)
        g = torch.Generator(device=dev).manual_seed(1)
        h = torch.randn((1, TP_SEQ, cfg.d_model), generator=g,
                        device=dev).to(dt)
        pos = torch.arange(TP_SEQ, device=dev)

        def part(tp):
            with torch.no_grad():
                if cfg.block_kind == "mamba1":
                    return None, S.mamba1_mix(lp["ssm"], h, cfg, tp)
                if cfg.parallel_block:
                    return L.parallel_partial(lp["attn"], lp["mlp"], h, cfg,
                                              pos, tp), None
                return (L.attention_partial(lp["attn"], h, cfg, pos, tp)
                        + L.mlp_partial(lp["mlp"], h, cfg, tp)), None

        def finish(tp, mixed, proj):
            with torch.no_grad():
                _, z, xc, _ = mixed
                return S.mamba1_scan_out(lp["ssm"], xc, z, proj, cfg, tp)[0]

        tps = [dist.TensorParallel(TP_RANKS, m, None)
               for m in range(TP_RANKS)]
        ops.reset_launches()
        if cfg.block_kind == "mamba1":
            one = dist.TensorParallel()
            _, mixed = part(one)
            want = finish(one, mixed, mixed[3])
            mixes = [part(tp)[1] for tp in tps]
            proj = sum(m[3].float() for m in mixes).to(dt)
            got = sum(finish(tp, m, proj).float()
                      for tp, m in zip(tps, mixes))
            kernel = "mamba_scan"
        else:
            want = part(dist.TensorParallel())[0]
            got = sum(part(tp)[0].float() for tp in tps)
            kernel = "flash_attention"
        torch.cuda.synchronize()
        _need(bool(torch.isfinite(got).all()), f"32c {arch} {name}: "
              "non-finite output")
        err = float((got - want.float()).abs().max())
        scale = float(want.float().abs().max())
        tol = TP_TOL[name] * scale
        out[name] = {"max_abs_err": err, "max_abs_out": scale,
                     "tolerance": tol,
                     "launches": ops.LAUNCHES[kernel]}
        _need(err <= tol, f"32c {arch} {name}: the {TP_RANKS} ranks' sum "
              f"differs from the unsplit layer by {err} > {tol}")
        del lp, h, got, want
    return {"layer": TP_LAYERS[arch], "ranks": TP_RANKS, "seq": TP_SEQ,
            "function": {"mamba1": "ssm.mamba1_mix + ssm.mamba1_scan_out",
                         "parallel": "layers.parallel_partial"}.get(
                TP_LAYERS[arch],
                "layers.attention_partial + layers.mlp_partial"),
            **out}


def _tp_kernel_cases(dev) -> dict:
    """Phase 32d: ``flash_attention`` at qwen2.5-14b's prefill shape cut
    to its heads at model widths ``TP_WIDTHS`` and ``mamba_scan`` at
    falcon-mamba-7b's cut to its channels, each against its plain
    version, timed, bounded (attention beside SDPA)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import mamba_scan as ms_k
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(0)
    att, scan = [], []
    for m in TP_WIDTHS:
        hq, hkv, s, d = 40 // m, 8 // m, 2048, 128
        q, k, v = (torch.randn((1, n, s, d), generator=g, device=dev)
                   .to(torch.bfloat16) for n in (hq, hkv, hkv))
        err = _lm_check(ops.flash_attention(q, k, v), fa_k.plain(q, k, v),
                        f"32d flash_attention at model {m}")
        bound, by = cost.bound_ms(cost.flash_attention(1, hq, hkv, s, s, d,
                                                       torch.bfloat16))
        att.append({"model": m, "shape": [1, hq, hkv, s, s, d],
                    "max_abs_err": err,
                    "ms": _time_ms(lambda: ops.flash_attention(q, k, v)),
                    "bound_ms": bound, "bound_by": by,
                    "library_ms": _time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, enable_gqa=True))})
        del q, k, v
        b, s, di, n = 1, 2048, 8192 // m, 16
        xdt = torch.randn((b, s, di), generator=g, device=dev)
        dtv = F.softplus(torch.randn((b, s, di), generator=g, device=dev)
                         - 4.6)
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).expand(di, n).contiguous()
        bm = torch.randn((b, s, n), generator=g, device=dev)
        cm = torch.randn((b, s, n), generator=g, device=dev)
        args = (xdt, dtv, a, bm, cm)
        y, h = ops.mamba_scan(*args)
        y_p, h_p = ms_k.plain(*args)
        err = max(_lm_check(y, y_p, f"32d mamba_scan y at model {m}"),
                  _lm_check(h, h_p, f"32d mamba_scan h at model {m}"))
        bound, by = cost.bound_ms(cost.mamba_scan(b, s, di, n,
                                                  torch.float32))
        scan.append({"model": m, "shape": [b, s, di, n], "max_abs_err": err,
                     "ms": _time_ms(lambda: ops.mamba_scan(*args)),
                     "bound_ms": bound, "bound_by": by, "library_ms": None})
        del args, xdt, dtv, a, bm, cm, y, h, y_p, h_p
    return {"flash_attention": att, "mamba_scan": scan}


def model_axis_phase(dev, report: dict) -> dict:
    """Phase 32: the ``model`` axis as compute. (a) Serving under a (1, 1)
    mesh with one NCCL rank; (b) phase 31a's step (which runs the
    tensor-parallel path) beside ``GATHERED_LAYERS``; (c) full-width layers
    split over ``TP_RANKS`` ranks played in turn; (d) the kernels at
    their per-rank shapes."""
    import torch
    from repro_torch import dist
    out = {}
    dist.init_ranks("nccl")
    try:
        cells = {a: _mesh_serve_cell(a, dev) for a in TP_SERVE}
    finally:
        torch.distributed.destroy_process_group()
    out["serve"] = {a: c["tp"] for a, c in cells.items()}
    out["serve_fsdp"] = {a: c["fsdp"] for a, c in cells.items()}
    for a, r in out["serve"].items():
        print("model_axis serve", a, json.dumps(r, default=float),
              flush=True)
    for a, r in out["serve_fsdp"].items():
        print("fsdp_serve", a, json.dumps(r, default=float), flush=True)
    cell = report["mesh_train"]["qwen2.5-14b"]
    out["train"] = {
        "arch": "qwen2.5-14b", "loss_and_grad_norm":
            cell["loss_and_grad_norm"], "params": cell["params"],
        "step_walls_mesh_s": cell["step_walls_mesh_s"],
        "step_walls_no_mesh_s": cell["step_walls_no_mesh_s"],
        "collective_calls_profiled_step":
            cell["collectives_profiled_step"]["calls"],
        "collectives_by_op": cell["collectives_profiled_step"]["by_op"],
        "gathered_layers": GATHERED_LAYERS}
    print("model_axis train", json.dumps(out["train"], default=float),
          flush=True)
    out["layers"] = {}
    for a in TP_LAYERS:
        out["layers"][a] = _tp_layer_cell(a, dev)
        print("model_axis layer", a, json.dumps(out["layers"][a],
                                                default=float), flush=True)
    out["kernels"] = _tp_kernel_cases(dev)
    print("model_axis kernels", json.dumps(out["kernels"], default=float),
          flush=True)
    return out


def _dryrun_cmd(arch: str, shape: str, mesh: str, *extra) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--mesh", mesh, "--out",
            str(DRYRUN_OUT), *extra]


def _dryrun_env(**more) -> dict:
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1", **more)


def start_dryrun() -> list:
    """Phase 33a: the traced cells, one background process an entry of
    ``DRYRUN_JOBS``, CUDA hidden; ``dryrun_phase`` waits for them."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(arch, _dryrun_cmd(arch, shapes, "both"))
            for arch, shapes in DRYRUN_JOBS]
    jobs.append((f"{DRYRUN_FSDP[0]}_fsdp", _dryrun_cmd(
        *DRYRUN_FSDP, "single", "--layout", "fsdp", "--tag", "fsdp")))
    procs = []
    for label, cmd in jobs:
        log = open(DRYRUN_OUT / f"{label}.log", "w")
        procs.append((label, subprocess.Popen(
            cmd, cwd=ROOT, env=_dryrun_env(CUDA_VISIBLE_DEVICES=""),
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _dryrun_record(arch: str, shape: str, mesh: str, tag: str = "") -> dict:
    from repro_torch.launch.dryrun import _cell_name
    name = _cell_name({"arch": arch, "shape": shape, "mesh": mesh,
                       "tag": tag})
    return json.loads((DRYRUN_OUT / f"{name}.json").read_text())


def dryrun_phase(procs: list) -> dict:
    """Phase 33: (a) every traced cell ``ok``, its numbers printed; (b)
    the profiled cells on the card, held to their traces."""
    out = {"cells": {}, "profile": {}}
    for arch, proc, log in procs:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT)
        log.close()
        _need(rc == 0, f"the dry run of {arch} exited {rc} "
              f"(chiprun_out/dryrun/{arch}.log)")
    cells = [(arch, shape, mesh, "") for arch, shapes in DRYRUN_JOBS
             for shape in shapes.split(",") for mesh in ("single", "multi")]
    cells += [(DRYRUN_FSDP[0], shape, "single", "fsdp")
              for shape in DRYRUN_FSDP[1].split(",")]
    for arch, shape, mesh, tag in cells:
        rec = _dryrun_record(arch, shape, mesh, tag)
        _need(rec["status"] == "ok", f"dry run {arch} × {shape} × "
              f"{mesh} {tag}: {rec.get('error')}")
        _need(rec["layout"] == (tag or "tp"), f"dry run {arch} × "
              f"{shape} × {mesh} {tag}: layout {rec['layout']}")
        rf = rec["roofline"]
        cell = {"trace_s": rec["compile_s"],
                "flops": rf["hlo_flops_per_device"],
                "bytes": rf["hlo_bytes_per_device"],
                "collectives": {k: v for k, v in rec[
                    "collectives"]["counts"].items() if v},
                "nvlink_bytes": rf["collective_bytes_nvlink"],
                "network_bytes": rf["collective_bytes_network"],
                "memory": rec["memory"],
                **{k: rf[k] for k in (
                    "compute_s", "memory_s", "collective_s",
                    "dominant", "useful_flops_ratio",
                    "step_time_lower_bound_s")},
                "microbatches": rec.get("microbatches")}
        key = "|".join(x for x in (arch, shape, mesh, tag) if x)
        out["cells"][key] = cell
        print("dryrun", arch, shape, mesh, tag or "tp",
              json.dumps(cell), flush=True)
    for (arch, shape), (band, kernels) in DRYRUN_PROFILE.items():
        t0 = time.perf_counter()
        r = subprocess.run(_dryrun_cmd(arch, shape, "single", "--profile",
                                       "--reuse-trace"), cwd=ROOT,
                           env=_dryrun_env(), capture_output=True,
                           text=True, timeout=DRYRUN_TIMEOUT)
        (DRYRUN_OUT / f"{arch}_profile.log").write_text(r.stdout + r.stderr)
        _need(r.returncode == 0, f"dry run --profile {arch} × {shape}: "
              f"exit {r.returncode}: {r.stdout[-1500:]}{r.stderr[-1500:]}")
        rec = _dryrun_record(arch, shape, "single")
        prof = rec["profile"]
        for k in kernels:
            _need(prof["launches"].get(k, 0) > 0,
                  f"dry run --profile {arch}: {k} was not launched")
        for k, bound in prof["port_kernel_bound_ms"].items():
            _need(prof["port_kernel_ms"].get(k, 0.0) >= bound,
                  f"dry run --profile {arch}: {k}'s device time "
                  f"{prof['port_kernel_ms'].get(k)} ms is below its "
                  f"traced bound {bound} ms")
        _need(prof["device_time_s"] >= prof["bound_without_collectives_s"],
              f"dry run --profile {arch}: device time "
              f"{prof['device_time_s']} s below the traced bound "
              f"{prof['bound_without_collectives_s']} s")
        _need(band[0] <= prof["peak_over_traced"] <= band[1],
              f"dry run --profile {arch}: max_memory_allocated "
              f"{prof['max_memory_allocated']} is "
              f"{prof['peak_over_traced']:.3f}× the traced peak, outside "
              f"{band}")
        res = {"seconds": time.perf_counter() - t0, "peak_band": band,
               **{k: prof[k] for k in (
                   "device_time_s", "bound_without_collectives_s",
                   "device_time_over_bound", "max_memory_allocated",
                   "traced_peak_bytes", "peak_over_traced", "launches",
                   "port_kernel_ms", "port_kernel_bound_ms", "wall_s",
                   "device_ops")},
               "step_time_lower_bound_s": rec["roofline"][
                   "step_time_lower_bound_s"]}
        out["profile"][f"{arch}|{shape}"] = res
        print("dryrun_profile", arch, shape, json.dumps(res), flush=True)
    return out


def profile_phase(ds, dev) -> dict:
    """Device time by kernel over 2 h of the paper replay (profiled)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import fast_seismic
    from repro_torch.core.detect import detect_events
    cfg = fast_seismic.config()
    n = int(2 * 3600 * cfg.fingerprint.fs)
    wave = ds.waveforms[:, :n]
    n_fp = cfg.fingerprint.n_fingerprints(n)
    scfg = fast_seismic.batch_replay_config(n_fp)
    detect_events(wave, cfg, scfg=scfg, device=dev)           # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, times, _ = detect_events(wave, cfg, scfg=scfg, device=dev)
        wall = time.perf_counter() - t0
    out = {"hours": 2, "blocks": -(-n_fp // scfg.block_fingerprints),
           "fused_step_s": times.fused_step_s,
           **_device_breakdown(prof, wall, "profile.txt")}
    print("profile", json.dumps(out), flush=True)
    return out


def _device_breakdown(prof, wall: float, name: str) -> dict:
    """A profiled window's device busy time (union of its kernels'
    spans), idle share of ``wall`` and the 15 longest kernels by total
    device time; the profiler's table goes to ``chiprun_out/<name>``."""
    import torch
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            r = e.time_range
            spans.append((r.start, r.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + r.elapsed_us()
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / name).write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=40))
    return {"wall_s": wall, "device_busy_s": busy * 1e-6,
            "idle_share": 1.0 - busy * 1e-6 / wall,
            "device_ops": len(spans),
            "top_device_us": [[k[:60], v] for k, v in top]}


def main() -> int:
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report = {"gpu": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    built = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    for name, r in built.items():
        usage = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "smem" in ln]
        print(f"built {name} in {r['seconds']:.1f}s: {' | '.join(usage)}",
              flush=True)
    dryrun_procs = start_dryrun()
    try:
        return _phases(report, dev, dryrun_procs, t_start)
    finally:
        for _, proc, log in dryrun_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _phases(report: dict, dev, dryrun_procs: list, t_start: float) -> int:
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset

    t0 = time.perf_counter()
    syn = SynthConfig(duration_s=PAPER_HOURS * 3600.0, n_stations=N_STATIONS,
                      n_sources=8, events_per_source=12,
                      repeating_noise_stations=(0,), seed=0)
    ds = make_dataset(syn)
    n_fp = fast_seismic.config().fingerprint.n_fingerprints(
        ds.waveforms.shape[1])
    report["synth_s"] = time.perf_counter() - t0

    kernels, jac = kernel_phase(ds, n_fp, dev)
    report["golden"] = golden_phase(dev)
    report["paper_parity"] = paper_parity_phase(dev)
    report["paper"] = paper_phase(ds, n_fp, dev)
    report["jaccard_replay"] = jaccard_replay_phase(
        jac, report["paper"]["pairs_emitted_per_station"], dev,
        next(k for k in kernels if k["name"] == "jaccard_popcount"))
    del jac
    report["stream_golden"] = stream_golden_phase(dev)
    report["stream_paper"], det7, record7 = stream_paper_phase(ds, dev)
    report["stream_parity"] = stream_parity_phase(ds, dev)
    report["offline_golden"] = offline_golden_phase(dev)
    report["offline_parity"] = offline_parity_phase(dev)
    report["offline_paper"], packed0 = offline_paper_phase(ds, n_fp, dev)
    kernels.append(minmax_hash_phase(packed0, dev))
    kernels.append(occurrence_filter_phase(packed0, dev))
    del packed0
    kernels += lm_kernel_phase(dev)
    report["lm_parity"] = lm_parity_phase(dev)
    report["lm_serve"] = lm_serve_phase(dev)
    report["serve"], serve_shapes = serve_phase(det7, ds, dev)
    del det7
    with tempfile.TemporaryDirectory() as tmp:
        report["snapshot"] = snapshot_phase(ds, dev, record7, tmp)
        report["elastic"] = elastic_phase(ds, dev, tmp, record7)
    report["located_batch"] = located_batch_phase(dev)
    report["locate_stack"] = locate_stack_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        report["located_stream"] = located_stream_phase(dev, tmp)
    report["serve_locate"] = serve_locate_phase(dev)
    report["bandpass"] = bandpass_phase(ds, dev)
    kernels += lm_bwd_kernel_phase(dev)
    report["embedding_bwd"] = embedding_bwd_phase(dev)
    report["lm_train_parity"] = lm_train_parity_phase(dev)
    report["lm_train"] = lm_train_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        report["train_resume"] = train_resume_phase(tmp)
    report["moe_repeat"] = moe_repeat_phase(dev)
    report["detect_step"] = detect_step_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        report["sharded_stream"] = sharded_phase(
            ds, dev, record7, report["stream_paper"], tmp)
        report["sharded_elastic"] = elastic_phase(
            ds, dev, tmp, record7, devices=[dev] * 3,
            label="sharded_elastic")
    report["detect_step_sharded"] = detect_sharded_phase(dev)
    report["mesh_train"] = mesh_train_phase(dev)
    report["model_axis"] = model_axis_phase(dev, report)
    report["dryrun"] = dryrun_phase(dryrun_procs)
    if "--profile" in sys.argv[1:]:
        report["profile"] = profile_phase(ds, dev)
    for k in kernels:
        node = report
        for key in KERNEL_PATH[k["name"]]:
            node = node[key]
        k["launches"] = node["launches"][k["name"]]
        if k["name"] in KERNEL_PATHS:
            k["launches_by_path"] = {
                path: report[path]["launches"][k["name"]]
                for path in KERNEL_PATHS[k["name"]]}
        if k["name"] in serve_shapes:
            k["serving_shape"] = serve_shapes[k["name"]]
        if k["name"] in LM_KERNEL_MODEL:
            k["launches_by_path"] = {
                path: report[path][LM_KERNEL_MODEL[k["name"]]]["launches"][
                    k["name"]] for path in ("lm_serve", "lm_train")}
        if k["name"] in LM_KERNEL_MODEL:
            # every serve and training run's count, by model
            k["launches_by_model"] = {
                path: {m: r["launches"][k["name"]]
                       for m, r in report[path].items()
                       if r["launches"].get(k["name"])}
                for path in ("lm_serve", "lm_train")}
        if "head_dim_16" in k:
            # the D = 16 kernels' launches: the card's serving (phase 14)
            # and training (phase 25) of the smoke config with head dim 16
            k["head_dim_16"]["launches_by_path"] = {
                path: report[path][D16_MODEL]["launches"].get(k["name"], 0)
                for path in ("lm_parity", "lm_train_parity")}
            _need(k["head_dim_16"]["launches_by_path"][
                "lm_train_parity"] > 0, f"{k['name']} at D = 16 was not "
                f"launched on {D16_MODEL}'s path")
    report["kernels"] = kernels
    # the Min-Max kernels also carry the plan of each shape they ran at,
    # the detection core's kernels their launches on each driver's path
    line = [{**{key: k[key] for key in KERNEL_KEYS},
             **{x: k[x] for x in ("plans", "launches_by_path",
                                  "launches_by_model", "serving_shape",
                                  "head_dim_16")
                if x in k}}
            for k in kernels]
    report["seconds"] = time.perf_counter() - t_start
    print("chip_smoke_seconds", json.dumps(report["seconds"]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(
        json.dumps(report, indent=1, default=float))
    print(json.dumps({"kernels": line}, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
