#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeprest_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it fails:

1. the card: name and power limit from nvidia-smi, torch and CUDA versions;
   TF32 off for matmuls and cuDNN;
2. build: the three CUDA sources (gru_fwd.cu with the inference and
   training forwards K1 and K2, gru_bwd.cu with the backward K3,
   gru_fwd_blocked.cu with the blocked forward K4 of the tuning sweep, all
   three including the tensor-core header gru_mma.cuh), one nvcc per
   source, all started together, into build/kernels/; ptxas's registers
   and spills of every kernel and instantiation, and of each kernel's f32
   form by its design (all four 3xTF32 on the tensor cores); the block
   plan's shared-memory mirrors and f32 launch bounds held against the
   sources' (K4 at every --quick blocking, both io dtypes, both dots), and
   its f32 plans at the main paths' shapes and K4's f32 blockings (8, 1, 1)
   and (16, 1, 1);
3. each kernel against its plain PyTorch version on the card, with the JAX
   package's kernel tolerances (forward: f32 1e-5, bf16 2e-2; gradients
   relative to each tensor's largest magnitude: f32 2e-4, bf16 2e-2): K1 at
   the flagship serving shape (E=40 experts, T=60, B=256 rows, H=128); K2,
   K3 (gate stash on and off) and the autograd Function (against torch
   autograd through the plain recurrence) at the flagship training shape
   (B=32); all at ragged shapes (E=3, T=7, B=37 at H=128 and H=96;
   E=2, T=5, B=21 at H=64: bf16 runs H/16 warps on the tensor cores) too,
   in bf16 and f32, forward and reverse; in f32 also at the main paths'
   shapes (K1 at E=88, B=8, the verdict sweeps' and the stream
   evaluation's rung; K2, K3 and the Function at E=88, B=32, the stream's
   fine-tune) and at H=40 (E=3, T=7, B=37: a last warp of the 3xTF32 forms
   with units past H), K1 and K2 (forward only: K3 refuses it) also at
   H=132 (E=2, T=4, B=9: their largest H, a last k step half past H);
4. times: K1 at the serving shape, K2 and K3 at the training shape, each
   beside its plain version, the least time the card could take (bound),
   and cuDNN's GRU as a yardstick (torch.nn.GRU with W_ih = identity on the
   projections, one module per expert: forward for K1 and K2, autograd
   backward for K3; the port never calls it); then K1, K2 and K3 in f32 at
   the table's and the main paths' shapes and K4's f32 dot at (8, 1, 1)
   and (16, 1, 1) (deeprest_tpu_torch/benchmarks/f32_kernels.py): CUDA
   events over 20 launches, the bytes, FMA and 3xTF32 bounds, K3's
   recurrence and dW kernels apart (torch.profiler), K2, K3 and K4 run
   twice for the same bits, and each form's error against an f64 run of
   the plain recurrence (held to 1e-5 forward, 2e-4 of scale for
   gradients);
5. the serving main path at full width: a seeded flagship checkpoint
   (F=512, E=40, H=128, bidirectional, bf16) written with the port's
   writer, then `python -m deeprest_tpu_torch predict` on a day of minutes
   (1,440 x 512) held against the host-loop reference over the plain
   recurrence on the card, then predict_series_many on 16 what-if series
   (384 windows);
6. the training main path at full width: a seeded three-day corpus
   (4,320 x 512 Poisson call-path counts, 40 resource series) written with
   the port's FeaturizedData, `python -m deeprest_tpu_torch train` for 2
   epochs at B=32, T=60, bf16 with the default supersteps ("auto": one
   captured CUDA graph per update, replayed; finite, falling losses; K2
   and K3 launched twice per step, replays counted; at least one capture,
   one eager update before each and every other update a replay), the
   trained checkpoint served by one `predict` call, 5 steps on the kernels
   against 5 steps through the plain recurrence from the same params
   (dropout 0), a torch.profiler breakdown of 5 eager steps; then 20
   captured steps (S=10) against 20 eager ones from the same params
   (dropout 0 and 0.5: per-step losses equal, params within 1e-6
   relative), a profile of one captured superstep (10 replays), G=4
   "exact" against "loop" (bit for bit, dropout 0.5) and "flat" against
   "loop" (2e-2 of scale, dropout 0), K2+K3 per microbatch at G·B = 128
   rows against 32, a run killed at step 27 (S=3, snapshots every 10,
   dropout 0.5) and resumed against the uninterrupted run (1e-6
   relative), and steady-state steps/s eager and captured in turns;
7. raw telemetry to what-if answers and anomaly verdicts, through the
   port's CLI alone, at the width of the reference's own deployment (the
   social network: F=128 from 60 call paths, E=88, H=128, bf16):
   `simulate` 360 minutes of the normal scenario (seed 0), `featurize`,
   `train` 2 epochs at B=32, T=60 with both baselines (K2 and K3 launched
   twice per step, the report's resrc and comp columns); `whatif` of the
   sample's mean mix over a day of minutes swept at 0.5, 1, 2 and 4 (the
   synthesizer fit on the first 120 minutes), held against the same sweep
   through the plain recurrence on the card, and estimate_many over 16
   one-day programs timed, host synthesis and device apart; `anomaly` on
   240 minutes of the crypto scenario with a cryptojacking burner on
   compose-post-service over minutes 100-160, held against the plain
   path (flagged set, first_flag_index, scores); `predict --raw` on the
   corpus's first 120 minutes equal to the first 120 rows of `predict
   --features` on the whole corpus; the phase's seconds per CLI and its
   launches per kernel;
8. the serving plane: `python -m deeprest_tpu_torch serve` in its own
   process on phase 5's flagship checkpoint, with the MicroBatcher and
   with --no-batcher: every rung's CUDA graph captured before it listens
   (4 ladder rungs, 7 fused rungs x 2 programs) and none after the load,
   `/v1/predict` on the day held against phase 5's host loop over the
   plain recurrence (2e-2 of scale), and a closed loop of
   60/60/60/77/90/117-minute requests at concurrency 1 and 16 (2 s a cell)
   (requests/s, p50/p99, coalesced_batches), its sampled answers held
   against the single-client answer to the same body (bit for bit with
   --no-batcher, 2e-2 of scale with the batcher); in-process, captured against
   eager engines bit for bit over 9 pages of 64 windows (with and
   without the delta carry), the K1 launch ledger (2 a page), windows/s
   of predict_series_many in turns and the device busy share; then
   `serve --raw --surface` on phase 7's checkpoint, its /v1/whatif,
   /v1/whatif/surface and /v1/anomaly held against an in-process
   PredictionService over phase 7's plain predictor (peaks and the
   surface within 2e-2 of scale, flagged sets equal), and the whole
   /v1/whatif series read at f32 too: f32 kernels within 2e-4 of scale of
   the f32 plain path, and the bf16 kernels no more than twice as far
   from the f32 answer as the bf16 plain path; K1's launches read from
   each server's /healthz;
9. the kernel-tuning path: K4 (gru_fwd_blocked.cu) at every blocking of
   the sweep's --quick menu that the plan admits against its plain
   version, at the fused flagship stacking (E=80, T=60, B=32, H=128) and
   a ragged shape (E=4, T=12, B=37), f32 and bf16 inputs, the bf16 dot
   (tensor cores) off and on (tolerance 1e-5 with the f32 dot, 2e-2 with
   the bf16 dot); every admitted bf16 blocking timed, K1's blocking (16
   rows, one expert, two CTAs an SM) and at least one two-expert blocking
   required, beside its plain version, its bound and cuDNN's GRU x80;
   bidirectional_gru fused
   (BIDIR_FUSED) against unfused on the card at the flagship training
   shape, forward (1 K1 launch against 2) and gradients (1 K2 and 1 K3
   against 2 each); 5 train steps with STASH_GATES off against 5 with it
   on from the same params (dropout 0); then `python -m
   deeprest_tpu_torch.benchmarks.kernel_tuning --quick`, its JSON printed
   on one line;
10. the 10k-endpoint sparse feed, quantized and exported serving, at
    full width (F=10,240 hashed call-path columns, E=40, H=128, bf16,
    K=64): a seeded day (1,440 x 10,240, 4-31 nonzero columns a row)
    through `train --sparse-feed --sparse-nnz-cap 64` for 2 epochs (K2 =
    K3 = 2 x steps); in-process 2 x 10 captured steps with the sparse feed
    against the dense feed from the same params (dropout 0: per-step losses
    equal); predict_series_many_sparse on 16 one-day series (384 windows)
    against predict_series_many of a dense predictor (bit-identical;
    windows/s in turns, host-to-device bytes a page, the busy share; the
    day against the host loop over the plain recurrence, 2e-2 of scale);
    int8 and bf16 on phase 5's flagship checkpoint (`predict --quant
    int8` too) and on the 10k one (envelope written, re-read and re-gated,
    weight bytes, a hand-tightened envelope raising QuantParityError,
    windows/s per mode in turns); `export --aot` of the flagship
    checkpoint (the graph holds the gru_fwd operator and no
    plain-recurrence op; the fleet's sidecar, which phase 13 admits, is
    written next to the checkpoint) and
    `serve --artifact` in its own process (/v1/predict on the day
    bit-identical to the in-process predictor, K1 launched); one
    /v1/predict of 60 x 10,240 through `serve --sparse-feed` equal to the
    in-process sparse answer;
11. streaming retrain on phase 7's corpus (the social network, hashed
    into capacity 512, E=88, W=60, B=32, H=128): `python -m
    deeprest_tpu_torch stream` at its defaults in f32 on a file a writer
    thread grows chunk by chunk, killed after refresh 2's checkpoint and
    run again (it resumes at refresh 2 with the same frozen metric set and
    a watermark that goes on, and refreshes at 360 buckets): finite losses,
    K2 = K3 = 2 x fine-tune steps, K1 launched by the evaluation, the
    captures and seconds of each refresh (stage, capture, fine-tune,
    evaluation, checkpoint write), the ETL stall overlapped and serial;
    in-process from the refresh-2 checkpoint, one refresh through the
    kernels against the plain recurrence (f32, dropout 0: losses and
    params within 1e-4), device memory over four refreshes at 360
    buckets (flat), one profiled; wire-fed against tailer-fed streams
    (bf16, sparse feed) bit for bit over two refreshes, and each source's
    ingest buckets/s; the drift->retrain loop on drift_bench's detection
    corpus (quick cycle) at the stream's widths in bf16 (the verdict
    enters after the shift, a refresh fires on drift, the WindowBackend
    sweep on K1 within 2e-2 of scale of the plain recurrence); `serve
    --verdict-raw --watch` on the stream's checkpoint in its own process
    (/v1/verdict 200 with states, the next stream checkpoint reloaded and
    swept, no capture after warm-up);
12. the replica plane on phase 5's checkpoint (run after phase 8):
    `serve --replicas R --admission-depth 64` with the MicroBatcher,
    process replicas at R = 2 and thread replicas at 2 (every
    worker captures its 18 graphs before its handshake and none after;
    each answer to phase 8's request mix, posted alone, bit for bit the
    single engine's; closed loops (1 s a cell) at concurrency 16 and 64
    with the
    clients in 4 spawned processes: requests/s, p50/p99, per-replica
    served counts, each worker's graphs and device memory, sampled
    answers against the single-client ones; 256 clients against depth 64
    on process R = 2); on it, with `--watch`, a worker SIGKILLed under load
    (no failed request, the probe restarts it, it serves again) and a
    newer step written under load (the workers restart one at a time,
    every answer's windows match one step, never a mix); `profile
    --seconds 1` against the thread plane under load (K1 by its symbol
    in the trace); 256 clients against depth 2 on one thread replica
    (fast 429s with Retry-After); `train --epochs 1 --profile-dir` on
    phase 6's corpus (K3 in the trace) and `measure_step_breakdown` on a
    flagship trainer;
13. the fleet tier on phase 5's checkpoint (run after phases 12 and 10): 100
    tenants (the checkpoint and copies scaled by 1 + 0.01 i; fewer, with
    the reason printed, when the host cannot pin the spilled ones) in a
    PredictorPool with budget 16 behind one plane's 18 graphs, through
    fleet_bench's arms: admission ms per tenant, 18 graphs at warm-up and
    none after, pinned host bytes beyond the spills; every tenant on phase
    8's request mix; the checkpoint's day through the pool against phase
    5's host loop over the plain recurrence (2e-2 of scale); 400 random
    accesses (spills and restores nonzero, bind ms by CUDA events, spill
    and restore ms, request p50/p99 within 100x, post-storm answers bit
    for bit, device memory flat); tenant A bit for bit with tenant B
    hammering and hot-reloaded from another thread; 2 resident and 2
    spilled tenants bit for bit their standalone predictors on their own
    graphs; `serve --replicas 2 --replica-mode thread --fleet blue=…
    --fleet green=… --no-batcher` on a copy of the checkpoint without its
    sidecar (its startup: a template admission without the sidecar, by
    stage; X-Tenant answers equal the in-process pool's, an unknown tenant
    404, /healthz's fleet view, 18 graphs and 0 after, /metrics's
    deeprest_fleet_* series); a template cold start in a fresh process
    with the sidecar phase 10's `export --aot` wrote, by stage
    (fleet_bench --cold-start);
14. the host-streamed trainer feed, the rest of `train` and the what-if
    demo (run after phase 11): 20 host-fed steps (`device_data="off"`)
    against 20 staged ones at the flagship width, captured S=10, dropout 0
    and 0.5 (per-step losses equal, params bit for bit, K2 = K3 = 40
    launches, 1 capture and 19 replays), the busy share of a host-fed
    epoch of replays, the plot arrays (`train/plots.py`
    `prediction_arrays`) on the kernels against the plain recurrence (2e-2
    of scale), steady-state steps/s host-fed and staged in turns; the 10k
    dense day under "auto" with the budget one byte under its staged
    bytes (host-fed) against the default budget (staged), 2 x 10 captured
    steps in turns (losses equal, steps/s); `train --device-data off
    --report-every 1` on the flagship corpus against `--device-data
    always` (feed "host", MAE tables every epoch, epoch losses equal at
    dropout 0) and `--plots-dir` (without matplotlib: exits naming it
    before training); the what-if demo's `precompute_results` on phase
    7's checkpoint and first 120 minutes, on the kernels and through the
    plain recurrence (4 datasets: the --quick grid's shape and
    multipliers, one seen and one unseen composition, 60 ticks; calls,
    ground truth and baselines equal, ours within 2e-2 of scale, a metric
    constant over the train split scaled in its raw unit), and the 3x seen
    dataset with the same params at f32 (2e-4), then
    `python -m deeprest_tpu_torch.demo serve` and its routes;
15. the mesh's data axis on torch.distributed (run after phase 14): (a)
    NCCL at world size 1 in this process, flagship bf16, dropout 0.5,
    captured S=10 (the all-reduce inside the captured update), 2 epochs of
    20 steps in turns against the trainer with no process group (losses and
    params bit for bit, K2 = K3 = 2 launches a replay, 1 capture and 39
    replays, steady-state steps/s of each); (b) gloo at world size 2, two
    spawned processes on the one card, flagship width, f32, dropout 0, 10
    eager steps against world size 1 on the same params (params bit-equal
    across the ranks, the first update's gradients within 1e-5 of each
    leaf's scale, losses and final params within the JAX package's
    sharded-training tolerances, K2 and K3 launched on both ranks, a
    captured superstep under gloo refused); (c) `train --mesh 1,1,1` under
    torchrun's env:// variables at world size 1 (NCCL) against phase 14's
    plain `train --device-data always` (epoch and step losses equal);
16. the mesh's expert and model axes (in a thread beside phases 7 and 8:
    its work is all in its ranks), two spawned gloo processes sharing the
    one card: (a) training on mesh 1,2,1 at the
    flagship (B=32, T=60, F=512, E=40 so 20 experts a rank, H=128, f32,
    dropout 0, 10 eager steps) and (b) on mesh 1,1,2 at F=10,240 (5 eager
    steps, each rank's w_ih [40, 5,120, 384]), each against world size 1
    on the same params (run on rank 0 while rank 1 waits): the first
    update's gradients within 1e-5 of each leaf's scale, losses and final
    params within phase 15's tolerances, K2 = K3 = two launches a step
    (one a direction) on each rank, each rank's params + Adam bytes and memory_allocated beside
    world size 1's (a model-axis rank at most 0.55 of it); (c) the
    Predictor on meshes 1,2,1 and 1,1,2 (eager, bf16) on phase 5's day
    within 2e-2 of scale of phase 5's captured one-process answer, the
    same on both ranks, K1 launched on each; K2 and K3 in f32 at E=20,
    B=32 timed after phase 15 (recorded only);
17. elastic remeshing (in a thread beside phase 12: its work is all in
    its ranks), two spawned gloo processes sharing the card, the flagship (B=32, T=60, F=512, E=40, H=128,
    bidirectional, bf16, dropout 0), 10 eager steps, a cursor snapshot
    every 2 steps, each arm in a job of its own: (a) FaultInjector({5: 1})
    on mesh 2,1,1: rank 1 leaves with DeviceLossError, rank 0 remeshes to
    1,1,1, restores step 4 and finishes; (b) rank 1 SIGKILLs itself from
    on_step at step 5: rank 0 notices through gloo, takes the census of
    the ranks that still answer (it waits out the dead one), remeshes,
    restores and finishes; each survivor bit for bit a trainer with no
    process group resuming from its restored step; (c) a 1,2,1 job losing
    rank 1 raises NoValidMeshError naming the expert axis; each arm's
    recovery seconds, restored step, K2/K3 launches and steps/s before and
    after the loss;
18. the raw side's native tools (run after phase 15): libdeeprest_etl
    built from native/featurizer.cpp into build/native/ (g++, the flags of
    native/Makefile); phase 7's corpus featurized through data/native.py
    and through the numpy featurize_buckets (its JSONL load timed apart),
    in dictionary mode and hashed into 512 columns, and a synthetic app's
    corpus (200 services, 1,000 endpoints, 200 buckets) hashed into 10,240,
    native = numpy with the JAX package's native-parity tolerances
    (traffic bit for bit, resources rtol 1e-6, invocations, vocabulary
    and capacity equal); phase 7's checkpoint serving the natively
    featurized corpus on K1, bit for bit its answers on the numpy one;
    `python -m deeprest_tpu_torch.loadgen --scenario crypto --ticks 3
    --burn-local` against stub gateways and a stub collector in this
    process (exit 0, its JSON line, one registration frame whose pid is
    the CLI's burner child running the port's burner.py);
19. `serve --mesh 1,2,1` (in a thread beside phase 10: its work is all in
    its ranks), two spawned gloo processes sharing the card, on phase 5's
    flagship checkpoint (bf16, 20 experts a rank, eager, `--no-batcher`,
    `--deadline`): rank 0 fronts HTTP and mirrors each device call to
    rank 1, which replays it; phase 5's day within 2e-2 of scale of phase
    5's captured one-process answer and within 1e-5 of scale, and bit for
    bit, of phase 16's 1,2,1 Predictor (the same fused rung); phase 8's
    mix within 2e-2 of scale of its one-process server; the `/healthz`
    digest the one-process digest; closed loops at concurrency 1 and 16
    (2 s each; sampled answers bit for bit the single-client ones;
    requests/s, p50 and p99 recorded only); K1 launched as often on both
    ranks; both ranks exit 0 at the deadline; the phase's seconds and
    each rank's peak device memory;
20. quantized serving, `--watch` and the capacity and verdict surfaces on
    the mesh, beside phases 14 and 15 (after phase 11: beside it the card
    held 80.8-81.1 GB): `serve --mesh 1,1,2 --quant
    int8 --watch 1 --surface --raw <phase 7's first 120 minutes>
    --verdict-raw <its last 90> --no-batcher` as two spawned gloo ranks
    sharing the card (eager), on phase 5's flagship params with phase 7's
    call paths spread over its 512 columns: phase 5's day within 2e-2 of
    scale of the one-process int8 predictor and every non-delta cell
    within its stored budget (the worst printed); the one-process int8
    digest; a step 1 (params x 1.1) written into the watched directory
    with the stored envelope removed, `/healthz` naming it, then the day
    within 2e-2 of the one-process int8 predictor of step 1 and its
    digest; the envelope rank 0 stored at the reload equal to the plane's
    and within its budget; `/v1/whatif/surface` (built on the request,
    `wait`) within 2e-2 of scale of a one-process service at step 1,
    keyed on step 1's digest; `/v1/verdict` swept; K1 launched as often
    on both ranks; both exit 0 at the deadline; requests/s and p50/p99 at
    concurrency 1, the reload's and the surface build's seconds, each
    rank's peak device memory and the phase's seconds (the one-process
    references run in the foreground after phase 15);
21. the replica router, admission, tenant weights, the autoscaler and the
    fleet tier on the mesh, beside phases 13 and 11: `serve --mesh
    1,2,1 --replicas 2 --admission-depth 8 --tenant-weights
    default=3,t1=1 --fleet t1=<phase 6's trained checkpoint>
    --fleet-hbm-budget 1 --autoscale --autoscale-min 2 --autoscale-max 3
    --autoscale-interval 1 --autoscale-rps-per-replica 4 --no-batcher` as
    two spawned gloo ranks sharing the card (eager; both thread replicas
    share the mesh stack on the one card; `t1` a one-device captured
    predictor on rank 0's): phase 5's day as `default` bit for bit phase
    16's 1,2,1 Predictor (as phase 19's plane) and as `t1` within 1e-5 of
    scale of a one-process captured predictor of that checkpoint; closed
    loops alternating `X-Tenant` at concurrency 1 and 8 (requests/s and
    p50/p99 per tenant); a burst of 32 against depth 8 shed with 429 and
    `Retry-After`; `default` spilled and restored (mirrored ops; their
    milliseconds); the rung graphs flat after `t1`'s first call; the
    router at the replicas the autoscaler set; rank 1's K1 launches those
    of rank 0's mesh calls and rank 0's surplus `t1`'s (its plane's
    warm-up and replays); both ranks exit 0 at the deadline.  Then `serve
    --mesh 1,2,1 --replica-mode process --replicas 2 --no-batcher`: its
    answers bit for bit a one-process captured predictor, no mirrored
    call, K1 in the workers alone, both ranks exit 0 (the one-process
    references run in the foreground after phase 20's);
22. the static analyzer (deeprest_tpu_torch/analysis) on this machine,
    which has no JAX, in processes of its own beside phase 18: `python3 -m
    deeprest_tpu_torch lint --no-cache --format json` over the port exits
    0 with 0 findings; `--list-rules` lists 40 ids (36 rules and the 4 GL
    meta rules); `python3 -m deeprest_tpu_torch.analysis --rules HY001` on
    a file with one unused import exits 1 with that one finding; the
    analyzer's modules import neither jax nor deeprest_tpu; each firing
    fixture of TX001, TX002, TX004, TX005, TX006 and JX007's capture arm
    (analysis/torch_fixtures.py, written to a directory) exits 1 with its
    rule and its silent twin 0; three hazards run on the card, each twin
    in a process of its own: TX001's replay after a rebinding answers
    with the old weight bit for bit (the copy_ twin: the new eager
    answer), TX004's output held across a second run equals the second
    call's answer (the clone twin: the first's), and JX007's `.item()`
    makes the capture raise GraphCaptureError naming the line the rule
    names (the twin's replay: eager bit for bit); the lint's and the
    phase's seconds and its processes' peak with the card's name and
    power limit;
23. the seconds of each phase, one JSON line of per-kernel numbers, then
    the device line last.

The kernel launch counts are set to 0 just before each main path (5, 6,
7, 8, 12, 10, 13, 11, 14, 15, 16, 17, 18, 19, 20, 21 and the sweep of 9;
a server or CLI process starts at 0, and phase 12 sums its workers'
ledgers and phases 15, 16, 17, 19, 20 and 21 their ranks' and workers')
and
read just after it; launches made to check or
time a kernel do not count.  A wrapper counts its launch on the host when
it is called, so a CUDA graph records the launches it holds at capture and
adds them once per replay (deeprest_tpu_torch/graphs.py).

Phases 1-5 and the timed kernels of 9 run alone.  After them, work that
does not need another's output overlaps it, to keep the script well
inside its time limit: a CLI or server process starts as soon as its
inputs exist and is read when its output is needed (CliRun), and a job
whose kernels all run in processes of its own runs in a thread
(Background): phase 7's simulate and featurize beside phase 6, its four
checkpoint CLIs beside its in-process plain path, phase 8's three
servers and phase 12's planes loading together, phase 10's export
beside the 10k training, phase 14's train CLIs and phase 15's
`train --mesh` together, phase 11's second stream run beside its
in-process checks, phase 15's gloo ranks beside phase 14's demo, phase
22's lint beside phase 18, and phases 16, 17, 19, 20 and 21 as above.  The
card's highest memory sample is printed with what each process held and
which phases ran (at once when it passes 70,000 MiB).  The host-clock numbers of an overlapped
phase are taken under that load; kernel times are not.

It exits nonzero, printing no result, without CUDA or without the package
beside it.
"""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
GRAD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # of each tensor's max |value|
FLAGSHIP = dict(E=40, T=60, B=256, H=128)        # serving: 4 pages of 64
TRAIN = dict(E=40, T=60, B=32, H=128)            # training: bench.py:37
RAGGED = dict(E=3, T=7, B=37, H=128)
RAGGED_96 = dict(E=3, T=7, B=37, H=96)           # 6 warps in bf16
RAGGED_64 = dict(E=2, T=5, B=21, H=64)           # 4 warps in bf16
CHECK_SHAPES = (("ragged", RAGGED), ("ragged H=96", RAGGED_96),
                ("ragged H=64", RAGGED_64))
# f32 only: the stream's fine-tune (K2, K3), the verdict sweeps' and the
# stream evaluation's smallest rung (K1), and H=40, where the 3xTF32 forms'
# last warp holds units past H (the bf16 forms refuse it)
STREAM_TRAIN = dict(E=88, T=60, B=32, H=128)
VERDICT = dict(E=88, T=60, B=8, H=128)
RAGGED_40 = dict(E=3, T=7, B=37, H=40)
RAGGED_132 = dict(E=2, T=4, B=9, H=132)  # f32 K1's largest H, H % 8 == 4
FUSED = dict(E=80, T=60, B=32, H=128)            # both directions stacked
TUNE_RAGGED = dict(E=4, T=12, B=37, H=128)
F, W, DAY = 512, 60, 1440
CORPUS_MINUTES = 3 * DAY
RESOURCES = ("cpu", "memory", "wiops", "wthroughput", "usage")
RAW_BUCKETS = 360                   # simulated social-network minutes
RAW_ANOMALY_BUCKETS = 240
ANOMALY_WINDOW = (100, 160)
SYNTH_BUCKETS = 120                 # the what-if synthesizer's sample
SWEEP = (0.5, 1.0, 2.0, 4.0)
# serving plane: /v1/predict request lengths in minutes (the JAX serve
# bench's 24-47 minutes at W=24, scaled to W=60), concurrencies, seconds
PLANE_REQUEST_MINUTES = (60, 60, 60, 77, 90, 117)
PLANE_CONCURRENCY = (1, 16)
PLANE_LOAD_S = 2.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def recurrence_inputs(shape: dict, dtype, seed: int = SEED):
    import numpy as np
    import torch

    e, t, b, h = shape["E"], shape["T"], shape["B"], shape["H"]
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    proj = rng.standard_normal((e, t, b, 3 * h), np.float32)
    w_hh = rng.uniform(-k, k, (e, h, 3 * h)).astype(np.float32)
    b_hh = rng.uniform(-k, k, (e, 3 * h)).astype(np.float32)
    h0 = np.zeros((e, b, h), np.float32)
    dev = torch.device("cuda")
    return (torch.from_numpy(proj).to(dev, dtype),
            torch.from_numpy(w_hh).to(dev, dtype),
            torch.from_numpy(b_hh).to(dev), torch.from_numpy(h0).to(dev))


def compare(got, want, dtype_name: str) -> tuple[float, float, bool]:
    rtol, atol = TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    ok = bool((diff <= atol + rtol * ref).all())
    return float(diff.max()), float(diff.max() / ref.max().clamp_min(1e-30)), ok


def compare_scaled(got, want, dtype_name: str) -> tuple[float, float, bool]:
    """Max |diff| against GRAD_TOL times the reference's max |value|."""
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max().clamp_min(1e-30))
    return diff, diff / scale, diff <= GRAD_TOL[dtype_name] * scale


def report_check(kernel: str, label: str, shape: dict, name: str,
                 what: str, result, tol) -> float:
    mx, rel, ok = result
    print(f"check {kernel} {label} {shape} {name} {what}: max_abs_err={mx:.3e} "
          f"max_err/max|ref|={rel:.3e} tol={tol} {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        fail(f"{kernel} disagrees with its plain version at {label} {name} "
             f"{what}")
    return mx


def check_train_kernels(cuda_gru, label: str, shape: dict, dtype) -> dict:
    """K2, K3 (stash on and off) and the autograd Function against their
    plain versions at one shape and dtype, both directions; returns the
    worst max_abs_err per kernel."""
    import torch

    name = str(dtype).removeprefix("torch.")
    worst = {"gru_fwd_train": 0.0, "gru_bwd": 0.0}
    args = recurrence_inputs(shape, dtype, seed=SEED + 1)
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    dout = torch.randn((shape["E"], shape["T"], shape["B"], shape["H"]),
                       generator=gen, device="cuda")
    for reverse in (False, True):
        got = cuda_gru.gru_fwd_train_cuda(*args, reverse=reverse)
        torch.cuda.synchronize()
        want = cuda_gru.gru_fwd_train_reference(*args, reverse=reverse)
        for out_name, g, w_ in zip(("h_all", "h_prev", "gates"), got, want):
            worst["gru_fwd_train"] = max(worst["gru_fwd_train"], report_check(
                "gru_fwd_train", label, shape, name,
                f"reverse={reverse} {out_name}", compare(g, w_, name),
                TOL[name]))
        proj, w_hh, b_hh, _ = args
        _, h_prev, gates = want
        for stash in (True, False):
            g_in = gates if stash else None
            got = cuda_gru.gru_bwd_cuda(proj, h_prev, g_in, w_hh, b_hh,
                                        dout.to(dtype), reverse=reverse)
            torch.cuda.synchronize()
            want_b = cuda_gru.gru_bwd_reference(proj, h_prev, g_in, w_hh,
                                                b_hh, dout.to(dtype),
                                                reverse=reverse)
            for out_name, g, w_ in zip(("dproj", "dW_hh", "db_hh", "dh0"),
                                       got, want_b):
                worst["gru_bwd"] = max(worst["gru_bwd"], report_check(
                    "gru_bwd", label, shape, name,
                    f"reverse={reverse} stash={stash} {out_name}",
                    compare_scaled(g, w_, name), GRAD_TOL[name]))

        def grads(fn):
            leaves = [x.clone().requires_grad_(True) for x in args]
            out = fn(*leaves, reverse)
            (out.float() * dout).sum().backward()
            return [out.detach()] + [x.grad for x in leaves]

        got = grads(cuda_gru.gru_recurrence)
        torch.cuda.synchronize()
        want = grads(cuda_gru.gru_recurrence_reference)
        for out_name, g, w_ in zip(("h_all", "dproj", "dW_hh", "db_hh", "dh0"),
                                   got, want):
            report_check("autograd Function", label, shape, name,
                         f"reverse={reverse} {out_name}",
                         compare_scaled(g, w_, name), GRAD_TOL[name])
    return worst


def phase_kernel_checks(cuda_gru) -> dict:
    """Every kernel against its plain version; returns the worst bf16
    max_abs_err at the flagship shapes per kernel."""
    import torch

    worst_bf16 = 0.0
    worst_train = {}
    for label, shape in (("flagship training", TRAIN),) + CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            worst = check_train_kernels(cuda_gru, label, shape, dtype)
            if dtype == torch.bfloat16 and shape is TRAIN:
                worst_train = worst
    for label, shape in (("stream fine-tune", STREAM_TRAIN),
                         ("ragged H=40", RAGGED_40)):
        check_train_kernels(cuda_gru, label, shape, torch.float32)
    # K2 takes H = 132 and K3 does not: the forward alone
    args = recurrence_inputs(RAGGED_132, torch.float32, seed=SEED + 1)
    for reverse in (False, True):
        got = cuda_gru.gru_fwd_train_cuda(*args, reverse=reverse)
        torch.cuda.synchronize()
        want = cuda_gru.gru_fwd_train_reference(*args, reverse=reverse)
        for out_name, g, w_ in zip(("h_all", "h_prev", "gates"), got, want):
            report_check("gru_fwd_train", "ragged H=132", RAGGED_132,
                         "float32", f"reverse={reverse} {out_name}",
                         compare(g, w_, "float32"), TOL["float32"])
    del args
    f32_only = (("verdict", VERDICT), ("ragged H=40", RAGGED_40),
                ("ragged H=132", RAGGED_132))
    for label, shape in (("flagship", FLAGSHIP),) + CHECK_SHAPES + f32_only:
        for dtype in ((torch.float32,) if (label, shape) in f32_only
                      else (torch.bfloat16, torch.float32)):
            name = str(dtype).removeprefix("torch.")
            args = recurrence_inputs(shape, dtype)
            for reverse in (False, True):
                got = cuda_gru.gru_fwd_cuda(*args, reverse=reverse)
                torch.cuda.synchronize()
                want = cuda_gru.gru_recurrence_reference(*args, reverse=reverse)
                mx, rel, ok = compare(got, want, name)
                print(f"check gru_fwd {label} {shape} {name} reverse={reverse}:"
                      f" max_abs_err={mx:.3e} max_rel_err={rel:.3e} "
                      f"tol(rtol,atol)={TOL[name]} {'ok' if ok else 'FAILED'}",
                      flush=True)
                if not ok:
                    fail(f"gru_fwd disagrees with its plain version at "
                         f"{label} {name} reverse={reverse}")
                if name == "bfloat16" and label == "flagship":
                    worst_bf16 = max(worst_bf16, mx)
            del args
    return {"gru_fwd": worst_bf16, **worst_train}


def cudnn_grus(w_hh, b_hh, dtype):
    """One torch.nn.GRU per expert computing the same recurrence on the
    projections: W_ih = identity, b_ih = 0."""
    import torch

    e, h, g3 = w_hh.shape
    grus = []
    with torch.no_grad():
        for i in range(e):
            m = torch.nn.GRU(g3, h).to("cuda", dtype)
            m.weight_ih_l0.copy_(torch.eye(g3))
            m.bias_ih_l0.zero_()
            m.weight_hh_l0.copy_(w_hh[i].t())
            m.bias_hh_l0.copy_(b_hh[i])
            m.flatten_parameters()
            grus.append(m)
    return grus


def cudnn_gru_ms(proj, w_hh, b_hh, h0, backward: bool = False):
    """cuDNN's GRU over the same recurrence, one nn.GRU call per expert.
    Forward: inference form without autograd; with ``backward``, the time
    of the autograd backward of the training forward (dproj and the weight
    gradients).  Returns (ms, the stacked forward outputs) or (None,
    reason) when cuDNN does not take the dtype."""
    import torch

    e = proj.shape[0]
    grus = cudnn_grus(w_hh, b_hh, proj.dtype)
    h0c = h0.to(proj.dtype)
    if not backward:
        def run():
            return [grus[i](proj[i], h0c[i][None])[0] for i in range(e)]
        with torch.no_grad():
            try:
                outs = run()
            except RuntimeError as exc:
                return None, f"cuDNN GRU refused {proj.dtype}: {exc}"
            return time_ms(run, iters=5), torch.stack(outs)
    x = proj.detach().requires_grad_(True)
    try:
        outs = [grus[i](x[i], h0c[i][None])[0] for i in range(e)]
    except RuntimeError as exc:
        return None, f"cuDNN GRU refused {proj.dtype}: {exc}"
    cot = [torch.ones_like(o) for o in outs]
    ms = time_ms(lambda: torch.autograd.backward(outs, cot, retain_graph=True),
                 iters=5)
    return ms, torch.stack([o.detach() for o in outs])


def bound(io_bytes: int, flops: int, dtype_name: str) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of the dtype, whichever is larger."""
    t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_times(kernel, library, dtype_name, shape, kernel_fn, plain_fn,
                 io_bytes, flops, library_ms, iters=20) -> dict:
    import torch

    kernel_ms = time_ms(kernel_fn, iters=iters)
    plain_ms = time_ms(plain_fn, iters=3, warmup=1)
    bound_ms, bound_by = bound(io_bytes, flops, dtype_name)
    print(f"times {kernel} {dtype_name} {shape}: kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}; "
          f"bytes {io_bytes}, flops {flops}) library_ms={library_ms} "
          f"({library})", flush=True)
    torch.cuda.empty_cache()
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": io_bytes, "flops": flops,
            "library_ms": library_ms}


def phase_times(cuda_gru) -> dict:
    """{kernel: {dtype name: times}} for K1 at the serving shape and K2, K3
    at the training shape."""
    import torch

    results = {"gru_fwd": {}, "gru_fwd_train": {}, "gru_bwd": {}}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        args = recurrence_inputs(FLAGSHIP, dtype)
        proj, w_hh, b_hh, h0 = args
        e, t, b, h = (FLAGSHIP[k] for k in ("E", "T", "B", "H"))
        lib_ms, lib_out = cudnn_gru_ms(*args)
        if lib_ms is None:
            print(f"library {name}: {lib_out}", flush=True)
        else:
            kern = cuda_gru.gru_fwd_cuda(*args)
            print(f"library {name}: cuDNN GRU x{e} experts agrees with the "
                  f"kernel to max |diff| "
                  f"{float((lib_out.float() - kern.float()).abs().max()):.3e}",
                  flush=True)
        results["gru_fwd"][name] = kernel_times(
            "gru_fwd", "cuDNN GRU forward x40", name, FLAGSHIP,
            lambda: cuda_gru.gru_fwd_cuda(*args),
            lambda: cuda_gru.gru_recurrence_reference(*args),
            nbytes(*args) + e * t * b * h * proj.element_size(),
            2 * e * t * b * h * 3 * h, lib_ms)
        del args, proj, w_hh, b_hh, h0, lib_out

        args = recurrence_inputs(TRAIN, dtype)
        proj, w_hh, b_hh, h0 = args
        e, t, b, h = (TRAIN[k] for k in ("E", "T", "B", "H"))
        h_all, h_prev, gates = cuda_gru.gru_fwd_train_cuda(*args)
        dout = torch.ones_like(h_all)
        flops = 2 * e * t * b * h * 3 * h
        lib_ms, _ = cudnn_gru_ms(*args)
        results["gru_fwd_train"][name] = kernel_times(
            "gru_fwd_train", "cuDNN GRU forward x40", name, TRAIN,
            lambda: cuda_gru.gru_fwd_train_cuda(*args),
            lambda: cuda_gru.gru_fwd_train_reference(*args),
            nbytes(*args, h_all, h_prev, gates), flops, lib_ms)
        lib_ms, _ = cudnn_gru_ms(*args, backward=True)
        bwd_in = (proj, h_prev, gates, w_hh, b_hh, dout)
        dproj, dw, db, dh0 = cuda_gru.gru_bwd_cuda(*bwd_in)
        results["gru_bwd"][name] = kernel_times(
            "gru_bwd", "cuDNN GRU autograd backward x40", name, TRAIN,
            lambda: cuda_gru.gru_bwd_cuda(*bwd_in),
            lambda: cuda_gru.gru_bwd_reference(*bwd_in),
            nbytes(*bwd_in, dproj, dw, db, dh0), 2 * flops, lib_ms)
        del args, proj, w_hh, b_hh, h0, h_all, h_prev, gates, dout, bwd_in
        del dproj, dw, db, dh0
        torch.cuda.empty_cache()
    for name, shapes in f32_main_path_times(cuda_gru).items():
        results.setdefault(name, {"float32": {}})["float32"]["shapes"] = shapes
    return results


def f32_main_path_times(cuda_gru) -> dict:
    """K1, K2, K3 and K4's f32 dot in f32 (3xTF32) at the table's and the
    main paths' shapes and K4's blockings (8, 1, 1) and (16, 1, 1)
    (``deeprest_tpu_torch/benchmarks/f32_kernels.py``): times, bounds,
    K3's recurrence/dW split, K2, K3 and K4 run twice for the same bits,
    and each form's error against an f64 run of the plain recurrence, held
    to the f32 tolerances (forwards 1e-5, K3 2e-4 of scale); each error's
    ratio to the plain f32 version's is printed beside it."""
    from deeprest_tpu_torch.benchmarks import f32_kernels

    results = f32_kernels.measure(cuda_gru)
    for name, shapes in results.items():
        for label, m in shapes.items():
            if "refused" in m:
                fail(f"{name} f32 {label} was refused: {m['refused']}")
            errs, plain = m["err_f64"], m["plain_err_f64"]
            split = (f" recurrence_ms={m['recurrence_ms']:.4f} "
                     f"dw_ms={m['dw_ms']:.4f}" if name == "gru_bwd" else "")
            waves = (f" ({m['ctas']} CTAs, {m['waves']} waves)"
                     if name == "gru_fwd_blocked" else "")
            ratio = max(errs[k] / max(plain[k], 1e-30) for k in errs)
            print(f"times {name} float32 {label} {m['shape']}{waves}: "
                  f"kernel_ms={m['ms']:.4f}{split} bound_ms bytes="
                  f"{m['bytes_ms']:.4f} fma={m['fma_ms']:.4f} "
                  f"3xtf32={m['tf32x3_ms']:.4f}; deterministic="
                  f"{m.get('deterministic')}; err_f64 "
                  f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (plain f32 "
                  f"{ {k: f'{v:.3e}' for k, v in plain.items()} }; at most "
                  f"{ratio:.2f}x the plain f32's)", flush=True)
            tol = GRAD_TOL["float32"] if name == "gru_bwd" \
                else TOL["float32"][0]
            if max(errs.values()) > tol:
                fail(f"{name} f32 at {label} is {max(errs.values()):.3e} of "
                     f"scale from the f64 recurrence, above {tol}")
            if "deterministic" in m and not m["deterministic"]:
                fail(f"{name} f32 at {label} gave other bits on a second "
                     "run")
    return results


# Per kernel of the kernels line: its design in bf16 (the dtype of the main
# path) and the substrings that pick that instantiation's ptxas report out
# of its source's build log (K3: the recurrence with the stash, as trained,
# and its dW kernel).
DESIGNS = {
    "gru_fwd": ("mma.sync", ("gru_fwd_mma_kernelILb0E",), None),
    "gru_fwd_train": ("mma.sync", ("gru_fwd_mma_kernelILb1E",), None),
    "gru_bwd": ("mma.sync", ("gru_bwd_mma_kernelILb1E",),
                ("gru_bwd_dw_mma_kernel",)),
    "gru_fwd_blocked": ("mma.sync",
                        ("gru_fwd_blocked_mma_kernelI13__nv_bfloat16Li1ELi1E",),
                        None),
}
# The same for each kernel's f32 instantiation, all 3xTF32 on the tensor
# cores (K4: f32 io, the f32 dot, one expert, 16 rows).
F32_DESIGNS = {
    "gru_fwd": ("3xTF32 mma.sync", ("gru_fwd_tf32_kernelILb0E",), None),
    "gru_fwd_train": ("3xTF32 mma.sync", ("gru_fwd_tf32_kernelILb1E",), None),
    "gru_bwd": ("3xTF32 mma.sync", ("gru_bwd_tf32_kernelILb1E",),
                ("gru_bwd_dw_tf32_kernel",)),
    "gru_fwd_blocked": ("3xTF32 mma.sync",
                        ("gru_fwd_blocked_tf32_kernelIfLi1ELi16E",), None),
}


def phase_build(build, cuda_gru, kernel_tuning) -> dict:
    """Build every source; print ptxas's registers and spills per kernel;
    hold the plan's shared-memory mirrors against the built entries.
    Returns {kernel name: {"registers", "spill_bytes"[, "registers_dw",
    "spill_bytes_dw"], "f32": the same of its f32 instantiation with its
    "design"}} of each kernel's bf16 instantiation."""
    import torch

    build_s = build.build_all(cuda_gru.SOURCES)
    print(f"build: {len(cuda_gru.SOURCES)} sources in {build_s:.2f} s",
          flush=True)
    usage = {}
    for src in cuda_gru.SOURCES:
        for fn, use in build.ptxas_usage(src.build_log).items():
            usage[fn] = use
            print(f"  ptxas {src.name}: {fn}: {use['registers']} registers, "
                  f"{use['spill_bytes']} bytes spilled", flush=True)

    def find(needles):
        hits = [u for fn, u in usage.items() if all(n in fn for n in needles)]
        return hits[0] if hits else {"registers": None, "spill_bytes": None}

    def regs_of(needles, dw_needles):
        out = dict(find(needles))
        if dw_needles:
            dw = find(dw_needles)
            out.update(registers_dw=dw["registers"],
                       spill_bytes_dw=dw["spill_bytes"])
        return out

    regs = {}
    for name, (_, needles, dw_needles) in DESIGNS.items():
        regs[name] = regs_of(needles, dw_needles)
    for name, (design, needles, dw_needles) in F32_DESIGNS.items():
        f32 = regs_of(needles, dw_needles)
        print(f"  f32 {name} ({design}): {f32}", flush=True)
        regs[name]["f32"] = {"design": design, **f32}
    fwd = cuda_gru.GRU_FWD_SOURCE.library()
    bwd = cuda_gru.GRU_BWD_SOURCE.library()
    blk = cuda_gru.GRU_FWD_BLOCKED_SOURCE.library()
    if (fwd.gru_fwd_tf32_max_threads(), bwd.gru_bwd_tf32_max_threads(),
            blk.gru_fwd_blocked_tf32_max_threads()) != (
            cuda_gru.TF32_FWD_MAX_THREADS, cuda_gru.TF32_BWD_MAX_THREADS,
            cuda_gru.TF32_FWD_MAX_THREADS):
        fail("block_plan's f32 launch bounds disagree with the sources")
    for h in (40, 64, 96, 128):
        for bf16 in (0, 1):
            pairs = [(fwd.gru_fwd_smem_bytes(h, bf16),
                      cuda_gru.fwd_smem_bytes(h, bool(bf16)))]
            pairs += [(bwd.gru_bwd_smem_bytes(h, bf16),
                       cuda_gru.bwd_smem_bytes(h, bool(bf16)))]
            pairs += [(blk.gru_fwd_blocked_smem_bytes(h, rows, e_blk, t_blk,
                                                      bf16, dot),
                       cuda_gru.fwd_blocked_smem_bytes(
                           h, rows, e_blk, t_blk, bool(bf16), bool(dot)))
                      for rows, e_blk, t_blk in kernel_tuning.blocking_menu(
                          FUSED["E"], FUSED["T"], FUSED["B"], h, quick=True)
                      for dot in (0, 1)]
            if any(c != py for c, py in pairs):
                fail(f"block_plan's shared-memory mirrors {pairs} disagree "
                     f"with the sources at H={h} bf16={bf16}")
    plan = cuda_gru.block_plan(TRAIN["E"], TRAIN["T"], TRAIN["B"], TRAIN["H"],
                               torch.bfloat16, training=True)
    print(f"plan: the mirrors equal the sources; flagship bf16 training: "
          f"{ {k: (v['smem_bytes'], v['ctas_per_sm'], v['waves']) for k, v in plan['kernels'].items()} } "
          f"(bytes, CTAs per SM, waves)", flush=True)
    for label, shape, training in (("K1 table", FLAGSHIP, False),
                                   ("K1 verdict", VERDICT, False),
                                   ("K2/K3 stream", STREAM_TRAIN, True)):
        plan = cuda_gru.block_plan(shape["E"], shape["T"], shape["B"],
                                   shape["H"], torch.float32,
                                   training=training)
        print(f"plan f32 {label}: "
              f"{ {k: (v['smem_bytes'], v['threads_per_cta'], v['ctas_per_sm'], v['ctas'], v['waves']) for k, v in plan['kernels'].items()} } "
              f"(bytes, threads, CTAs per SM, CTAs, waves)", flush=True)
    for rows in (8, 16):
        p = cuda_gru.block_plan(FUSED["E"], FUSED["T"], FUSED["B"], FUSED["H"],
                                torch.float32, training=False, rows=rows,
                                blocked=True, bf16_dot=False)
        print(f"plan f32 K4 ({rows},1,1) f32 dot: "
              f"{(p['smem_bytes'], p['threads_per_cta'], p['ctas_per_sm'], p['ctas'], p['waves'])} "
              f"(bytes, threads, CTAs per SM, CTAs, waves)", flush=True)
    return regs


def flagship_checkpoint(workdir: str):
    """Seeded flagship params and sidecar, written with the port's writer;
    returns (ckpt dir, traffic, delta mask)."""
    import dataclasses

    import numpy as np

    from deeprest_tpu_torch.config import ModelConfig
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.checkpoint import save_checkpoint

    e = FLAGSHIP["E"]
    cfg = ModelConfig(feature_dim=F, num_metrics=e, hidden_size=FLAGSHIP["H"],
                      num_layers=1, bidirectional=True,
                      compute_dtype="bfloat16")
    # names as bench.py builds them; every fifth resource is a level
    # (disk-usage-like) series served as integrated increments
    metric_names = [f"comp{i // 5}_res{i % 5}" for i in range(e)]
    delta = np.array([i % 5 == 4 for i in range(e)])
    rng = np.random.default_rng(SEED)
    traffic = rng.poisson(rng.uniform(0.5, 20.0, F),
                          (DAY, F)).astype(np.float32)
    y_min = rng.uniform(0.0, 1.0, e).astype(np.float32)
    extra = {
        "metric_names": metric_names,
        "x_stats": {"min": 0.0, "max": float(traffic.max())},
        "y_stats": {"min": y_min.tolist(),
                    "max": (y_min + rng.uniform(1.0, 50.0, e)).tolist()},
        "window_size": W, "feature_dim": F,
        "model_config": dataclasses.asdict(cfg), "space": None,
        "delta_mask": delta.tolist(),
    }
    ckpt = os.path.join(workdir, "ckpt")
    save_checkpoint(ckpt, init_params(cfg, seed=SEED), step=0, extra=extra)
    return ckpt, traffic, delta


def device_rows(prof) -> list:
    """(device µs, count, name) of each kernel and copy the profiler saw,
    largest first.  Device-side events only: CPU ops also carry the device
    time of the kernels they launched, and a GPU range of a user annotation
    (such as the optimizer's step) spans kernels counted on their own."""
    import torch

    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def profile_what_if(pred, series, call=None, label: str = "what-if"):
    """Where the what-if call's time goes: device time by kernel name and
    the device's busy share of the call's wall time, from torch.profiler
    over one more predict_series_many call (or ``call(series)``); returns
    (wall ms, busy ms), or None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call = call or pred.predict_series_many
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call(series)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        print(f"profile {label}: the profiler saw no device time "
              "(device breakdown not measured)", flush=True)
        return None
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} % of wall)",
          flush=True)
    for dev_us, count, key in rows[:8]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    return wall_us / 1e3, busy_us / 1e3


def phase_main_path(cuda_gru, wd: str) -> dict:
    import numpy as np
    import torch

    from deeprest_tpu_torch.serve.fused import plan_windows
    from deeprest_tpu_torch.serve.predictor import (
        Predictor, rolled_prediction_reference,
    )

    ckpt, traffic, delta = flagship_checkpoint(wd)
    feats = os.path.join(wd, "input.npz")
    np.savez(feats, traffic=traffic)
    out_path = os.path.join(wd, "preds.npz")

    for k in cuda_gru.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "deeprest_tpu_torch", "predict",
         "--ckpt-dir", ckpt, "--features", feats, "--out", out_path],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"predict CLI exited {proc.returncode}:\n{proc.stderr}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    cli_launches = int(report["kernel_launches"]["gru_fwd"])
    print(f"main predict CLI: {DAY}x{F} traffic in {cli_s:.2f} s "
          f"(process start, load, build check, predict), device "
          f"{report['device']}, gru_fwd launches {cli_launches}",
          flush=True)

    pred = Predictor.from_checkpoint(ckpt, device="cuda")
    t0 = time.perf_counter()
    pred.warm()                          # captures every rung's CUDA graph
    pred.predict_series(traffic)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    scales = np.linspace(0.5, 2.0, 16).astype(np.float32)
    scales[0] = 1.0
    series = [traffic * s for s in scales]
    t0 = time.perf_counter()
    many = pred.predict_series_many(series)
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t0
    n_windows = len(plan_windows([len(s) for s in series], W))
    print(f"main predict_series_many: 16 series, {n_windows} windows in "
          f"{many_s:.4f} s = {n_windows / many_s:.1f} windows/s "
          f"(warm-up and captures {warm_s:.3f} s); fused stats "
          f"{pred.fused.stats()}", flush=True)
    profile_what_if(pred, series)
    launches = cli_launches + cuda_gru.GRU_FWD.launches
    print(f"main gru_fwd launches: {launches} (CLI {cli_launches}, "
          f"in-process {cuda_gru.GRU_FWD.launches})", flush=True)
    if launches == 0:
        fail("the main path never launched gru_fwd")
    train_forms = (cuda_gru.GRU_FWD_TRAIN.launches
                   + cuda_gru.GRU_BWD.launches
                   + report["kernel_launches"]["gru_fwd_train"]
                   + report["kernel_launches"]["gru_bwd"])
    if train_forms:
        fail(f"serving launched {train_forms} training kernels; it "
             "must run the inference form only")

    with np.load(out_path) as z:
        got = np.asarray(z["predictions"])
    e = FLAGSHIP["E"]
    if got.shape != (DAY, e, 3) or not np.isfinite(got).all():
        fail(f"CLI predictions have shape {got.shape} or non-finite "
             "values; want finite [1440, 40, 3]")
    model = pred.model

    def plain_apply(x):
        with torch.inference_mode():
            return model(torch.from_numpy(x).cuda(),
                         recurrence=cuda_gru.gru_recurrence_reference
                         ).cpu().numpy()

    ref = rolled_prediction_reference(
        plain_apply, pred.x_stats, pred.y_stats, W, traffic,
        delta_mask=delta, median_index=pred.median_index())
    checks = {}
    for label, a in (("cli", got), ("many[0]", many[0])):
        for cols, name in ((~delta, "non-delta"), (delta, "delta")):
            diff = np.abs(a[:, cols] - ref[:, cols])
            scale = np.abs(ref[:, cols]).max()
            rel = float(diff.max() / scale)
            checks[f"{label} {name}"] = rel
            print(f"check main {label} {name} columns vs host loop over "
                  f"the plain recurrence: max_abs_err={diff.max():.4e} "
                  f"max_err/max|ref|={rel:.3e} (tol {TOL['bfloat16'][0]})",
                  flush=True)
            if rel > TOL["bfloat16"][0]:
                fail(f"main path {label} {name} columns disagree with "
                     "the reference")
    for s in many:
        if s.shape != (DAY, e, 3) or not np.isfinite(s).all():
            fail("predict_series_many gave a wrong shape or non-finite "
                 "values")
    return {"launches": launches, "windows_per_s": n_windows / many_s,
            "checks": checks, "ckpt": ckpt, "traffic": traffic,
            "delta": delta, "ref": ref, "answer": many[0]}


def train_step_flops(batch, window, features, experts, hidden, quantiles=3,
                     directions=2) -> float:
    """Analytic FLOPs per training step, as bench.py counts them: the
    input projections, the recurrence and the heads (2*M*N*K each),
    forward plus backward ~ 3x forward."""
    proj = 2 * batch * window * experts * features * 3 * hidden
    recur = 2 * batch * window * experts * hidden * 3 * hidden
    heads = 2 * batch * window * experts * (2 * directions * hidden) * quantiles
    return 3 * (directions * (proj + recur) + heads)


def flagship_corpus(path: str, minutes: int = CORPUS_MINUTES,
                    features: int = F, experts: int = TRAIN["E"]) -> str:
    """A seeded corpus of ``minutes`` x ``features`` Poisson call-path
    counts and ``experts`` resource series comp{c}_{cpu,memory,wiops,
    wthroughput,usage}: each a seeded linear map of the traffic plus noise;
    the usage series accumulate theirs (a disk-usage level, trained as
    per-bucket increments).  Written with the port's FeaturizedData;
    returns the file's path."""
    import numpy as np

    from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData

    rng = np.random.default_rng(SEED)
    traffic = rng.poisson(rng.uniform(0.5, 20.0, features),
                          (minutes, features)).astype(np.float32)
    resources = {}
    for i in range(experts):
        res = RESOURCES[i % len(RESOURCES)]
        w = rng.uniform(0.0, 1.0, features) * (rng.random(features) < 0.2)
        level = traffic @ w
        level = level + rng.normal(0.0, 0.05 * level.std(), minutes)
        if res == "usage":
            level = np.cumsum(np.abs(level)) / minutes
        resources[f"comp{i // len(RESOURCES)}_{res}"] = level.astype(
            np.float32)
    space = {"config": {"capacity": 0, "round_to": 128,
                        "hash_features": False, "hash_seed": 0x5EED},
             "vocabulary": [[f"svc{j % 16}", f"/op{j}"]
                            for j in range(features)],
             "frozen_capacity": features}
    return FeaturizedData(traffic=traffic, resources=resources,
                          invocations={},
                          space=CallPathSpace.from_dict(space)).save(path)


CHILDREN = []          # every process started with Popen, killed at exit


def stop_children() -> None:
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


atexit.register(stop_children)


class CliRun:
    """One port CLI call in its own process, started now and read later,
    so that calls that do not need each other's output overlap.
    ``seconds`` is the process's own wall time, start to exit."""

    def __init__(self, args: list, timeout: int, env: dict | None = None,
                 check: bool = True):
        import threading

        self.args = [str(a) for a in args]
        self.check = check
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "deeprest_tpu_torch", *self.args],
            cwd=REPO,
            env={**os.environ, "PYTHONPATH": REPO, **(env or {})},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        CHILDREN.append(self.proc)
        t0 = time.perf_counter()
        self.out = self.err = ""
        self.seconds = None

        def collect():
            try:
                self.out, self.err = self.proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.out, self.err = self.proc.communicate()
                self.err += f"\n(killed after {timeout} s)"
            self.seconds = time.perf_counter() - t0

        self.thread = threading.Thread(target=collect, daemon=True)
        self.thread.start()

    @property
    def returncode(self) -> int:
        self.thread.join()
        return self.proc.returncode

    def lines(self) -> list[str]:
        """Its stdout lines; the run fails if it exited other than 0."""
        if self.returncode != 0 and self.check:
            fail(f"CLI {self.args[0]} exited {self.proc.returncode}:\n"
                 f"{self.err}")
        return self.out.strip().splitlines()

    def json(self) -> dict:
        """Its last line, parsed."""
        return json.loads(self.lines()[-1])


def run_cli_lines(args: list, timeout: int) -> list[str]:
    """One port CLI call in its own process; returns its stdout lines."""
    return CliRun(args, timeout).lines()


def run_cli(args: list, timeout: int) -> dict:
    """One port CLI call in its own process; returns its last-line JSON."""
    return CliRun(args, timeout).json()


class DeviceMemory:
    """The card's memory in use by every process on it (nvidia-smi, MiB),
    sampled by a thread every ``every`` seconds; ``take_peak()`` returns
    the most seen since its last call, and ``phase_peaks`` the most seen
    while each phase in ``phases`` ran.  Overlapped phases share the card,
    so their peak is what bounds the overlap.  At each new high of the run
    (by a GiB or more) it asks what each process on the card holds;
    :meth:`top_line` describes the run's highest sample so, and a sample
    past ``ALERT_MIB`` is printed as it comes."""

    ALERT_MIB = 70_000

    def __init__(self, every: float = 2.0):
        import threading

        self._peak = 0
        self._top, self._top_apps, self._top_phases = 0, [], []
        self.phases: list = []          # the phases running now
        self.phase_peaks: dict = {}     # phase -> its peak MiB so far
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(every,),
                                       daemon=True)
        self.thread.start()

    def _run(self, every: float) -> None:
        while not self._stop.wait(every):
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60)
            if out.returncode == 0 and out.stdout.split():
                used = int(out.stdout.split()[0])
                self._peak = max(self._peak, used)
                for name in list(self.phases):
                    self.phase_peaks[name] = max(
                        used, self.phase_peaks.get(name, 0))
                if used >= self._top + 1024:
                    self._top, self._top_apps = used, self._processes()
                    self._top_phases = sorted(self.phases)
                    if used > self.ALERT_MIB:
                        print(self.top_line(), flush=True)

    @staticmethod
    def _processes() -> list:
        """``[(MiB, pid, command line), ...]`` of the card's processes,
        largest first (or one row saying why nvidia-smi listed none)."""
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
        apps = []
        for row in out.stdout.strip().splitlines():
            parts = [p.strip() for p in row.split(",")]
            if len(parts) != 2 or not parts[1].isdigit():
                continue
            try:
                with open(f"/proc/{parts[0]}/cmdline", "rb") as fh:
                    cmd = fh.read().replace(b"\0", b" ").decode()[:160]
            except OSError:
                cmd = "?"
            apps.append((int(parts[1]), parts[0], cmd.strip()))
        return sorted(apps, reverse=True) or [
            (0, "-", f"nvidia-smi listed none: {out.stdout.strip()[:160]} "
                     f"{out.stderr.strip()[:160]}")]

    def top_line(self) -> str:
        return (f"card memory {self._top} MiB in use at the run's highest "
                f"sample so far (alert past {self.ALERT_MIB}), during "
                f"{self._top_phases}, by process: "
                + "; ".join(f"pid {pid} {mib} MiB ({cmd})"
                            for mib, pid, cmd in self._top_apps))

    def take_peak(self) -> int:
        peak, self._peak = self._peak, 0
        return peak

    def stop(self) -> None:
        self._stop.set()


class Background:
    """``fn(*args)`` in a thread beside the phases that follow.  Only for
    work that launches no kernel in this process (its kernels run in
    processes of its own), so the foreground phases' launch counts stay
    their own.  ``result()`` joins it; a failure there fails the run."""

    def __init__(self, name: str, fn, *args, memory=None):
        import threading

        self.name, self.out, self.error = name, None, None
        self.seconds = None
        t0 = time.perf_counter()
        if memory is not None:
            memory.phases.append(name)

        def run():
            try:
                self.out = fn(*args)
            except BaseException as exc:         # fail() raises SystemExit
                self.error = exc
            self.seconds = time.perf_counter() - t0
            if memory is not None:
                memory.phases.remove(name)

        self.thread = threading.Thread(target=run, name=name, daemon=True)
        self.thread.start()

    def result(self, timeout: float = 900.0):
        self.thread.join(timeout)
        if self.thread.is_alive():
            fail(f"{self.name} did not finish within {timeout} s")
        if isinstance(self.error, SystemExit):
            sys.exit(self.error.code)
        if self.error is not None:
            raise self.error
        return self.out


def profile_train_steps(label: str, run, steps: int) -> float | None:
    """Where ``steps`` train steps' time goes (``run()`` takes them): device
    time by kernel and the device's busy share of their wall time, from
    torch.profiler.  Returns the busy share in percent, None when the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    if not rows:
        print(f"profile {label}: the profiler saw no device time (device "
              "breakdown not measured)", flush=True)
        return None
    busy_us = sum(r[0] for r in rows)
    share = 100 * busy_us / wall_us
    print(f"profile {label}: {steps} steps, wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms ({share:.1f} % of wall)",
          flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    return share


def flagship_trainer(data, dropout: float = 0.0, split: float = 0.40,
                     **train):
    """A flagship Trainer on the card (B=32, T=60, H=128, bf16) and the
    bundle of ``data`` at train split ``split``."""
    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    cfg = Config(model=ModelConfig(hidden_size=TRAIN["H"],
                                   dropout_rate=dropout,
                                   compute_dtype="bfloat16"),
                 train=TrainConfig(batch_size=TRAIN["B"], window_size=W,
                                   train_split=split, **train))
    bundle = prepare_dataset(data, cfg.train)
    return Trainer(cfg, F, bundle.metric_names, device="cuda"), bundle


def train_epochs(trainer, bundle, params, epochs: int = 1):
    """``epochs`` epochs of ``trainer.train_epoch`` from ``params`` (no
    evaluation); returns (state, per-step losses)."""
    import numpy as np

    state = trainer.init_state(params)
    staged = trainer.stage_dataset(bundle)
    rng = np.random.default_rng(SEED)
    losses = []
    for _ in range(epochs):
        state, _ = trainer.train_epoch(state, bundle, rng, staged)
        losses.append(trainer.last_epoch_losses)
    return state, np.concatenate(losses)


def params_rel_diff(a, b) -> tuple[float, float, bool]:
    """Worst max |a - b| / max |b| over the leaves of two states, the worst
    max |a - b|, and whether every leaf is bit-identical."""
    import torch

    rel = absd = 0.0
    same = True
    for name, want in b.params.items():
        got = a.params[name].detach()
        want = want.detach()
        d = float((got - want).abs().max())
        absd = max(absd, d)
        rel = max(rel, d / max(float(want.abs().max()), 1e-30))
        same = same and torch.equal(got, want)
    return rel, absd, same


# 20 steps of B=32 in an epoch: int((4,320 - 60) x 0.1503) = 640 windows
SPLIT_20_STEPS = 0.1503


def phase_supersteps(cuda_gru, feats: str, workdir: str) -> dict:
    """The trainer's supersteps on the card at the flagship width: captured
    against eager updates, the accumulation modes at G=4, a kill and resume,
    a profile of one captured superstep, and steady-state steps/s eager
    and captured."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.models.qrnn import init_params

    data = FeaturizedData.load(feats)
    out = {}

    # 20 captured steps (S=10) against 20 eager (S=1), dropout 0 and 0.5
    for dropout in (0.0, 0.5):
        runs = {}
        for label, s in (("eager", 1), ("captured", 10)):
            trainer, bundle = flagship_trainer(
                data, dropout, SPLIT_20_STEPS, steps_per_superstep=s)
            params = init_params(trainer.model_config, SEED)
            for k in cuda_gru.KERNELS:
                k.launches = 0
            state, losses = train_epochs(trainer, bundle, params)
            runs[label] = (trainer, state, losses,
                           {k.name: k.launches for k in cuda_gru.KERNELS})
        (tr_c, st_c, l_c, n_c), (_, st_e, l_e, n_e) = (runs["captured"],
                                                       runs["eager"])
        rel, absd, same = params_rel_diff(st_c, st_e)
        print(f"check captured (S=10) vs eager (S=1) 20 steps, dropout "
              f"{dropout}: losses equal {np.array_equal(l_c, l_e)} "
              f"(first {l_c[:3].tolist()} vs {l_e[:3].tolist()}); params max "
              f"relative difference {rel:.3e} (max abs {absd:.3e}, tol 1e-6), "
              f"bit-identical {same}; captured trainer: captures "
              f"{tr_c.captures}, replays {tr_c.replays}, dispatches "
              f"{tr_c.dispatches}; launches captured {n_c}, eager {n_e}",
              flush=True)
        if len(l_c) != 20 or not np.array_equal(l_c, l_e):
            fail(f"captured steps disagree with eager steps (dropout "
                 f"{dropout}): per-step losses differ")
        if rel > 1e-6:
            fail(f"captured params differ from eager by {rel:.3e} relative "
                 f"after 20 steps (dropout {dropout})")
        if (tr_c.captures, tr_c.replays, tr_c.dispatches) != (1, 19, 20):
            fail("the captured run did not take 1 capture, 19 replays and "
                 "20 dispatches")
        for name in ("gru_fwd_train", "gru_bwd"):
            if n_c[name] != 40 or n_e[name] != 40:
                fail(f"{name} counted {n_c[name]} (captured) and "
                     f"{n_e[name]} (eager) launches over 20 steps; want 40")
        out[f"captured_bit_identical_dropout_{dropout}"] = same
        if dropout == 0.0:
            # one captured superstep, profiled: 10 replays after the epoch
            plan = tr_c._epoch_plan(bundle.num_train_windows,
                                    np.random.default_rng(SEED), 10)
            tr_c._stage_plan(st_c, st_c.plan.staged, plan[0], plan[1], 0)

            def superstep():
                for _ in range(10):
                    tr_c._run_update(st_c, True)
                    st_c.step += 1

            out["busy_captured_pct"] = profile_train_steps(
                "train captured superstep (S=10)", superstep, 10)
        del runs, tr_c, st_c, st_e
        torch.cuda.empty_cache()

    # G=4: "exact" against "loop" with dropout 0.5 (bit for bit), "flat"
    # against "loop" with dropout 0 (bf16 tolerance)
    states = {}
    for label, mode, dropout in (("loop 0.5", "loop", 0.5),
                                 ("exact 0.5", "exact", 0.5),
                                 ("loop 0", "loop", 0.0),
                                 ("flat 0", "flat", 0.0)):
        trainer, bundle = flagship_trainer(
            data, dropout, SPLIT_20_STEPS, grad_accum_windows=4,
            grad_accum_mode=mode)
        params = init_params(trainer.model_config, SEED)
        state, losses = train_epochs(trainer, bundle, params)
        states[label] = (state, losses)
        print(f"G=4 {label}: {len(losses)} microbatches in "
              f"{trainer.dispatches} updates (captures {trainer.captures}), "
              f"losses {losses[:4].tolist()}", flush=True)
    rel, absd, same = params_rel_diff(states["exact 0.5"][0],
                                      states["loop 0.5"][0])
    equal = np.array_equal(states["exact 0.5"][1], states["loop 0.5"][1])
    print(f"check G=4 exact vs loop (dropout 0.5): losses equal {equal}, "
          f"params bit-identical {same} (max abs {absd:.3e})", flush=True)
    if not (equal and same):
        fail("G=4 'exact' is not bit-identical to 'loop'")
    worst = 0.0
    for name, want in states["loop 0"][0].params.items():
        got = states["flat 0"][0].params[name].detach()
        worst = max(worst, float((got - want.detach()).abs().max())
                    / max(float(want.detach().abs().max()), 1e-30))
    print(f"check G=4 flat vs loop (dropout 0): params max difference "
          f"{worst:.3e} of scale (tol 2e-2)", flush=True)
    if worst > 2e-2:
        fail("G=4 'flat' disagrees with 'loop'")
    out["flat_vs_loop"] = worst
    del states
    torch.cuda.empty_cache()

    # K2 + K3 per microbatch: G·B = 128 rows a launch against 32
    per = {}
    for g in (1, 4):
        shape = dict(TRAIN, B=TRAIN["B"] * g)
        args = recurrence_inputs(shape, torch.bfloat16)
        h_all, h_prev, gates = cuda_gru.gru_fwd_train_cuda(*args)
        dout = torch.ones_like(h_all)
        bwd_in = (args[0], h_prev, gates, args[1], args[2], dout)
        fwd_ms = time_ms(lambda: cuda_gru.gru_fwd_train_cuda(*args), 20)
        bwd_ms = time_ms(lambda: cuda_gru.gru_bwd_cuda(*bwd_in), 20)
        per[g] = (fwd_ms / g, bwd_ms / g)
        del args, h_all, h_prev, gates, dout, bwd_in
    gain = (sum(per[1]) / sum(per[4]))
    print(f"times K2+K3 per microbatch bf16: B=32 K2 {per[1][0]:.4f} + K3 "
          f"{per[1][1]:.4f} ms; G=4 flat (B=128) K2 {per[4][0]:.4f} + K3 "
          f"{per[4][1]:.4f} ms per microbatch: {gain:.2f}x (PR 5 sweep: "
          f"1.59x at G=4)", flush=True)
    out["flat_g4_gain"] = gain

    # kill at step 27 and resume, flagship width, dropout 0.5
    ckpt_a = os.path.join(workdir, "snap_a")
    ckpt_b = os.path.join(workdir, "snap_b")

    class Preempted(BaseException):
        pass

    def kill_at_27(step):
        if step >= 27:
            raise Preempted

    finals = {}
    for label, ckpt in (("uninterrupted", ckpt_a), ("killed", ckpt_b)):
        trainer, bundle = flagship_trainer(
            data, 0.5, steps_per_superstep=3, snapshot_every_steps=10,
            checkpoint_dir=ckpt)
        params = init_params(trainer.model_config, SEED)
        try:
            finals[label] = trainer.fit(
                bundle, state=trainer.init_state(params), num_epochs=1,
                on_step=None if label == "uninterrupted" else kill_at_27)
        except Preempted:
            print(f"killed at step {trainer.global_step}", flush=True)
    trainer, bundle = flagship_trainer(
        data, 0.5, steps_per_superstep=3, snapshot_every_steps=10,
        checkpoint_dir=ckpt_b)
    finals["resumed"] = trainer.resume_training(bundle, num_epochs=1)
    rel, absd, same = params_rel_diff(finals["resumed"][0],
                                      finals["uninterrupted"][0])
    print(f"check kill at 27 and resume (S=3, snapshots every 10, dropout "
          f"0.5): resumed from step {trainer.resumed_from_step}, "
          f"{finals['resumed'][0].step} steps; params max relative "
          f"difference {rel:.3e}, max abs {absd:.3e} (tol 1e-6), "
          f"bit-identical {same}; test loss "
          f"{finals['resumed'][1][-1].test_loss} vs "
          f"{finals['uninterrupted'][1][-1].test_loss}", flush=True)
    if "killed" in finals or trainer.resumed_from_step != 24:
        fail("the kill at step 27 did not land, or the resume did not start "
             "from the snapshot at step 24")
    if rel > 1e-6 or finals["resumed"][0].step != finals["uninterrupted"][
            0].step:
        fail("the resumed run does not end at the uninterrupted run's params")
    out["resume_rel"] = rel
    del finals, trainer
    torch.cuda.empty_cache()

    # steady-state steps/s, eager and captured, in turns
    rates = {"eager": [], "captured": []}
    for label in ("eager", "captured", "captured", "eager"):
        trainer, bundle = flagship_trainer(
            data, 0.5, steps_per_superstep=1 if label == "eager" else "auto")
        params = init_params(trainer.model_config, SEED)
        train_epochs(trainer, bundle, params, epochs=2)
        rates[label].append(trainer.throughput.steps_per_sec)
        del trainer
        torch.cuda.empty_cache()
    print(f"steady-state steps/s (2 epochs of {bundle.num_train_windows} "
          f"windows, first update excluded), in turns: eager "
          f"{rates['eager']}, captured (S=auto) {rates['captured']}",
          flush=True)
    out["steps_per_sec"] = rates
    return out


def phase_training(cuda_gru, keep: str | None = None) -> dict:
    """Phase 6; with ``keep``, its trained checkpoint is copied there."""
    import shutil

    import numpy as np

    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    e, b, h = TRAIN["E"], TRAIN["B"], TRAIN["H"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=os.path.join(REPO, "build")) as wd:
        feats = flagship_corpus(os.path.join(wd, "corpus.npz"))
        ckpt = os.path.join(wd, "ckpt")
        for k in cuda_gru.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        report = run_cli(["train", "--features", feats, "--epochs", "2",
                          "--batch-size", str(b), "--window", str(W),
                          "--compute-dtype", "bfloat16", "--ckpt-dir", ckpt,
                          "--no-baselines"], timeout=900)
        train_s = time.perf_counter() - t0
        served = run_cli(["predict", "--ckpt-dir", ckpt, "--features", feats,
                          "--out", os.path.join(wd, "preds")], timeout=600)
        if keep is not None:
            shutil.copytree(ckpt, keep)
        launches = dict(report["kernel_launches"])
        launches["gru_fwd"] += served["kernel_launches"]["gru_fwd"]
        steps = int(report["steps"])
        flops = train_step_flops(b, W, F, e, h)
        share = report["steps_per_sec"] * flops / PEAK_FLOPS["bfloat16"]
        print(f"main train CLI: {CORPUS_MINUTES}x{F} corpus, 2 epochs, "
              f"{steps} steps in {train_s:.2f} s of wall time (process "
              f"start, load, 2 evaluations and the checkpoint included); "
              f"steady state {report['steps_per_sec']:.3f} steps/s = "
              f"{100 * share:.4f} % of 989 TFLOP/s at {flops / 1e12:.4f} "
              f"TFLOP per step; epoch losses {report['epoch_losses']}; "
              f"test losses {report['test_losses']}; device "
              f"{report['device']}; launches {launches}", flush=True)
        losses = np.asarray(report["step_losses"], np.float64)
        if not np.isfinite(losses).all():
            fail("train CLI gave non-finite step losses")
        if not report["epoch_losses"][1] < report["epoch_losses"][0]:
            fail(f"epoch losses did not fall: {report['epoch_losses']}")
        for name in ("gru_fwd_train", "gru_bwd"):
            if launches[name] != 2 * steps:
                fail(f"{name} launched {launches[name]} times in {steps} "
                     f"train steps; want 2 x steps (two directions), graph "
                     f"replays counted")
        if launches["gru_fwd"] == 0:
            fail("evaluation and serving never launched gru_fwd")
        eager = report["dispatches"] - report["replays"]
        print(f"main train CLI supersteps: S={report['steps_per_superstep']}"
              f", G={report['grad_accum_windows']}; {report['dispatches']} "
              f"dispatches = {report['replays']} graph replays + {eager} "
              f"eager updates; {report['captures']} captures", flush=True)
        if report["captures"] < 1 or report["dispatches"] != steps \
                or eager != report["captures"]:
            fail("the default train run did not go through a captured graph "
                 "(want captures >= 1, one eager update before each capture "
                 "and every other update a replay)")
        mae = [v for m in report["report"].values()
               for s in m.values() for v in s.values()]
        if not np.isfinite(mae).all():
            fail("the MAE report has non-finite values")
        with np.load(served["out"]) as z:
            preds = np.asarray(z["predictions"])
        if preds.shape != (CORPUS_MINUTES, e, 3) or not np.isfinite(
                preds).all():
            fail(f"predictions of the trained checkpoint have shape "
                 f"{preds.shape} or non-finite values; want finite "
                 f"[{CORPUS_MINUTES}, {e}, 3]")
        print(f"main predict CLI on the trained checkpoint: {preds.shape}, "
              f"finite", flush=True)

        # 5 steps on the kernels against 5 through the plain recurrence
        cfg = Config(model=ModelConfig(hidden_size=h, dropout_rate=0.0,
                                       compute_dtype="bfloat16"),
                     train=TrainConfig(batch_size=b, window_size=W))
        bundle = prepare_dataset(FeaturizedData.load(feats), cfg.train)
        trainer = Trainer(cfg, F, bundle.metric_names, device="cuda")
        params = init_params(trainer.model_config, SEED)
        batches = list(trainer._batches(bundle.num_train_windows,
                                        np.random.default_rng(SEED)))
        runs = {}
        for label, recurrence in (("kernels", None),
                                  ("plain", cuda_gru.gru_recurrence_reference)):
            run = Trainer(cfg, F, bundle.metric_names, device="cuda",
                          recurrence=recurrence)
            state = run.init_state(params)
            staged = run.stage_dataset(bundle)
            runs[label] = [float(run.train_step(state, staged, sel, wt))
                           for sel, wt in batches[:5]]
        rel = max(abs(a - p) / abs(p) for a, p in zip(runs["kernels"],
                                                      runs["plain"]))
        print(f"check train 5 steps, kernels vs plain recurrence on the card "
              f"(dropout 0): {runs['kernels']} vs {runs['plain']}, max "
              f"relative difference {rel:.3e} (tol 2e-2)", flush=True)
        if rel > 2e-2:
            fail("training on the kernels disagrees with training through "
                 "the plain recurrence")

        state = trainer.init_state(params)
        staged = trainer.stage_dataset(bundle)
        for sel, wt in batches[:3]:
            trainer.train_step(state, staged, sel, wt)      # warm

        def eager_steps():
            for sel, wt in batches[3:8]:
                trainer.train_step(state, staged, sel, wt)

        busy_eager = profile_train_steps("train eager", eager_steps, 5)
        del trainer, state, staged
        supersteps = phase_supersteps(cuda_gru, feats, wd)
    return {"launches": launches, "steps": steps,
            "steps_per_sec": report["steps_per_sec"], "peak_share": share,
            "epoch_losses": report["epoch_losses"], "parity_rel": rel,
            "busy_eager_pct": busy_eager, **supersteps}


def rounded(seconds: dict) -> dict:
    return {k: round(v, 3) for k, v in seconds.items()}


def sweep_error(got: list, want: list, y_range) -> float:
    """Worst |kernel peak - plain peak| of a what-if sweep, each metric's
    error over its scale: the largest |plain peak| of that metric in the
    sweep, floored at its train-split range."""
    worst = 0.0
    for e, metric in enumerate(want[0]["peaks"]):
        plain = [r["peaks"][metric][q] for r in want for q in r["peaks"][metric]]
        kern = [r["peaks"][metric][q] for r in got for q in r["peaks"][metric]]
        scale = max(max(abs(v) for v in plain), float(y_range[e]), 1e-12)
        worst = max(worst, max(abs(a - b) for a, b in zip(kern, plain))
                    / scale)
    return worst


def start_raw_corpus(workdir: str) -> dict:
    """Phase 7's host-only head, started beside phase 6: ``simulate`` the
    social network (the reference's own deployment), then ``featurize``
    it, each in its own process; neither touches the card."""
    wd = os.path.join(workdir, "raw")
    os.makedirs(wd)
    raw = os.path.join(wd, "raw.jsonl")
    feats = os.path.join(wd, "input.npz")

    def chain():
        sim = CliRun(["simulate", "--scenario", "normal", "--seed", SEED,
                      "--ticks", RAW_BUCKETS, "--out", raw], timeout=600)
        sim.lines()
        fz = CliRun(["featurize", "--raw", raw, "--out", feats],
                    timeout=600)
        return {"fz": fz.json(), "seconds": {"simulate": sim.seconds,
                                             "featurize": fz.seconds}}

    return {"wd": wd, "raw": raw, "feats": feats,
            "job": Background("phase 7's simulate and featurize", chain)}


def phase_raw_to_answers(cuda_gru, corpus: dict) -> dict:
    """Raw telemetry in, what-if answers and anomaly verdicts out, through
    the port's CLI: simulate the social network (the reference's own
    deployment), featurize it (F=128 from 60 call paths, E=88; both
    started beside phase 6 by :func:`start_raw_corpus`), train at H=128
    with both baselines, then whatif, anomaly and predict --raw from the
    checkpoint, each held against the plain path on the card."""
    from collections import Counter

    import numpy as np
    import torch

    from deeprest_tpu_torch.data.featurize import featurize_buckets
    from deeprest_tpu_torch.data.schema import (
        load_raw_data, save_raw_data_jsonl,
    )
    from deeprest_tpu_torch.data.synthesize import TraceSynthesizer
    from deeprest_tpu_torch.serve.anomaly import AnomalyDetector
    from deeprest_tpu_torch.serve.fused import plan_windows
    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.serve.whatif import WhatIfEstimator
    from deeprest_tpu_torch.workload import SCENARIOS, Anomaly
    from deeprest_tpu_torch.workload.simulator import simulate_corpus

    names = [k.name for k in cuda_gru.MODEL_KERNELS]
    launches = dict.fromkeys(names, 0)

    def count(report):
        for k in names:
            launches[k] += int(report["kernel_launches"][k])

    secs = {}
    t_phase = time.perf_counter()
    wd, raw, feats = corpus["wd"], corpus["raw"], corpus["feats"]
    ckpt = os.path.join(wd, "ckpt")
    for k in cuda_gru.KERNELS:
        k.launches = 0

    head = corpus["job"].result()
    fz = head["fz"]
    secs.update(head["seconds"])
    sizes = (fz["capacity"], fz["observed_paths"], len(fz["metrics"]))
    print(f"main raw simulate + featurize: {fz['buckets']} buckets of the "
          f"social network (normal, seed {SEED}) -> F={sizes[0]} from "
          f"{sizes[1]} observed call paths, E={sizes[2]} metrics; "
          f"simulate {secs['simulate']:.2f} s, featurize "
          f"{secs['featurize']:.2f} s (CLI wall, process start "
          f"included)", flush=True)
    if sizes != (128, 60, 88):
        fail(f"featurize gave (F, paths, E) = {sizes}; want (128, 60, 88)")

    train = CliRun(["train", "--features", feats, "--compute-dtype",
                    "bfloat16", "--epochs", 2, "--batch-size", TRAIN["B"],
                    "--window", W, "--hidden-size", TRAIN["H"],
                    "--ckpt-dir", ckpt], timeout=900)
    # while train runs: the anomaly CLI's corpus (a cryptojacking burner
    # on compose-post-service) is simulated, and the corpus's first
    # SYNTH_BUCKETS minutes read, which the what-if synthesizer is fit on
    # (every endpoint's trace shapes, at a sixth of the load cost)
    t0 = time.perf_counter()
    crypto = simulate_corpus(
        SCENARIOS["crypto"](SEED), RAW_ANOMALY_BUCKETS,
        anomalies=[Anomaly("cryptojacking", "compose-post-service",
                           *ANOMALY_WINDOW)])
    crypto_path = os.path.join(wd, "crypto.jsonl")
    save_raw_data_jsonl(crypto, crypto_path)
    t_sim_crypto = time.perf_counter() - t0
    sample = os.path.join(wd, "sample.jsonl")
    with open(raw, encoding="utf-8") as src, \
            open(sample, "w", encoding="utf-8") as dst:
        for _, line in zip(range(SYNTH_BUCKETS), src):
            dst.write(line)
    t0 = time.perf_counter()
    buckets = load_raw_data(sample)
    t_load = time.perf_counter() - t0
    tr = train.json()
    secs["train"] = train.seconds
    count(tr)
    steps = int(tr["steps"])
    if not np.isfinite(np.asarray(tr["step_losses"], np.float64)).all():
        fail("train CLI (baselines on) gave non-finite step losses")
    for name in ("gru_fwd_train", "gru_bwd"):
        if tr["kernel_launches"][name] != 2 * steps:
            fail(f"{name} launched {tr['kernel_launches'][name]} times "
                 f"in {steps} train steps; want 2 x steps")
    methods = {m for v in tr["report"].values() for m in v}
    if methods != {"deepr", "resrc", "comp"}:
        fail(f"train report has methods {sorted(methods)}; want deepr, "
             "resrc and comp")
    medians = {m: float(np.mean([v[m]["median"]
                                 for v in tr["report"].values()]))
               for m in sorted(methods)}
    if not all(np.isfinite(list(medians.values()))):
        fail("the train report's MAE is not finite")
    print(f"main raw train CLI (baselines on): {steps} steps, epoch "
          f"losses {tr['epoch_losses']}, launches {tr['kernel_launches']}"
          f", mean median MAE per method {medians}; "
          f"{secs['train']:.2f} s (stages {rounded(tr['seconds'])})",
          flush=True)

    # the CLIs that read the checkpoint start together and run while the
    # plain path computes what they are held against, in this process:
    # whatif on the kernels against the same sweep through the plain
    # recurrence, anomaly, and predict --raw on the corpus's first
    # SYNTH_BUCKETS minutes (the sample) == the first rows of predict
    # --features on the whole corpus (featurizing is per minute and
    # those rows' windows tile alike)
    plain = Predictor.from_checkpoint(
        ckpt, device="cuda",
        recurrence=cuda_gru.gru_recurrence_reference, cuda_graphs=False)
    t0 = time.perf_counter()
    synth = TraceSynthesizer(plain.space()).fit(buckets)
    t_fit = time.perf_counter() - t0
    if len(synth.endpoints) != 7:
        fail(f"the synthesizer found endpoints {synth.endpoints}")
    # the sample's mean calls per minute of each endpoint
    calls = Counter(t.label for b in buckets for t in b.traces)
    mix = {ep: int(round(calls[ep] / len(buckets)))
           for ep in synth.endpoints}
    del buckets
    clis = {
        "whatif": CliRun(["whatif", "--ckpt-dir", ckpt, "--raw", sample,
                          "--mix", json.dumps(mix), "--ticks", DAY,
                          "--sweep", ",".join(str(f) for f in SWEEP)],
                         timeout=900),
        "anomaly": CliRun(["anomaly", "--ckpt-dir", ckpt, "--raw",
                           crypto_path], timeout=600),
        "predict --raw": CliRun(["predict", "--ckpt-dir", ckpt, "--raw",
                                 sample, "--out",
                                 os.path.join(wd, "by_raw")], timeout=600),
        "predict --features": CliRun(["predict", "--ckpt-dir", ckpt,
                                      "--features", feats, "--out",
                                      os.path.join(wd, "by_feats")],
                                     timeout=600)}
    want = WhatIfEstimator(plain, synth).sweep([mix] * DAY, list(SWEEP),
                                               seed=0)
    y_range = np.asarray(plain.y_stats.range, np.float32).reshape(-1)
    data = featurize_buckets(crypto, space=plain.space())
    if data.metric_names != plain.metric_names:
        fail("the crypto corpus's metrics differ from the checkpoint's")
    want_reports = AnomalyDetector(plain).check(data.traffic,
                                                data.targets())

    # estimate_many over 16 one-day programs on the kernels
    pred = Predictor.from_checkpoint(ckpt, device="cuda")
    est = WhatIfEstimator(pred, synth)
    programs = [[{ep: int(round(n * s)) for ep, n in mix.items()}] * DAY
                for s in np.linspace(0.5, 2.0, 16)]
    est.estimate_many_raw(programs[:1], cache=False)        # warm
    k1_before = cuda_gru.GRU_FWD.launches
    t0 = time.perf_counter()
    est.estimate_many_raw(programs, cache=False)
    torch.cuda.synchronize()
    t_many = time.perf_counter() - t0
    t0 = time.perf_counter()
    series = [synth.synthesize_series(p, seed=i)
              for i, p in enumerate(programs)]
    t_synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred.predict_series_many(series)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    n_windows = len(plan_windows([DAY] * len(programs), W))
    print(f"main raw estimate_many: 16 one-day programs, {n_windows} "
          f"windows in {t_many:.4f} s = {n_windows / t_many:.1f} "
          f"windows/s end to end; host synthesis {t_synth:.4f} s, "
          f"predict_series_many {t_pred:.4f} s = "
          f"{n_windows / t_pred:.1f} windows/s; gru_fwd launches "
          f"{cuda_gru.GRU_FWD.launches - k1_before} (in-process; the "
          f"whatif, anomaly and predict CLIs run beside it)", flush=True)
    profile_what_if(pred, series)
    del series

    wi = clis["whatif"].json()
    secs["whatif"] = clis["whatif"].seconds
    count(wi)
    if wi["kernel_launches"]["gru_fwd"] == 0:
        fail("the whatif CLI never launched gru_fwd")
    sweep_rel = sweep_error(wi["sweep"], want, y_range)
    peak = {r["factor"]: r["peaks"]["compose-post-service_cpu"]["q50"]
            for r in wi["sweep"]}
    print(f"main raw whatif CLI: mix {mix} x {DAY} ticks, sweep "
          f"{list(SWEEP)}; {secs['whatif']:.2f} s (load and fit of the "
          f"synthesizer on {SYNTH_BUCKETS} buckets included: in-process "
          f"load {t_load:.2f} s, fit {t_fit:.2f} s); gru_fwd launches "
          f"{wi['kernel_launches']['gru_fwd']}; stages "
          f"{rounded(wi['seconds'])}; compose-post-service_cpu "
          f"q50 peak per factor {peak}", flush=True)
    print(f"check main raw whatif sweep vs the plain recurrence on the "
          f"card: max_err/scale={sweep_rel:.3e} (tol "
          f"{TOL['bfloat16'][0]})", flush=True)
    if sweep_rel > TOL["bfloat16"][0]:
        fail("the whatif sweep disagrees with the plain path")

    lines = clis["anomaly"].lines()
    secs["anomaly"] = clis["anomaly"].seconds
    detail, verdict = json.loads(lines[-2]), json.loads(lines[-1])
    count(detail)
    if detail["kernel_launches"]["gru_fwd"] == 0:
        fail("the anomaly CLI never launched gru_fwd")
    flagged = sorted(r.metric for r in want_reports if r.flagged)
    firsts = [r.first_flag_index for r in want_reports]
    score_err = max(abs(r["score"] - w.score) / max(abs(w.score), 1.0)
                    for r, w in zip(detail["reports"], want_reports))
    cpu = next(r for r in detail["reports"]
               if r["metric"] == "compose-post-service_cpu")
    print(f"main raw anomaly CLI: {RAW_ANOMALY_BUCKETS} crypto buckets, "
          f"cryptojacking on compose-post-service over buckets "
          f"{ANOMALY_WINDOW[0]}-{ANOMALY_WINDOW[1]}; {secs['anomaly']:.2f}"
          f" s (simulated in-process in {t_sim_crypto:.2f} s); "
          f"{len(verdict['flagged'])} of {len(detail['reports'])} metrics "
          f"flagged; compose-post-service_cpu flagged={cpu['flagged']} "
          f"first_flag_index={cpu['first_flag_index']} score="
          f"{cpu['score']:.4f}; gru_fwd launches "
          f"{detail['kernel_launches']['gru_fwd']}; stages "
          f"{rounded(detail['seconds'])}", flush=True)
    print(f"check main raw anomaly vs the plain recurrence on the card: "
          f"flagged sets equal {sorted(verdict['flagged']) == flagged}, "
          f"first_flag_index equal "
          f"{[r['first_flag_index'] for r in detail['reports']] == firsts}"
          f", max score error {score_err:.3e} (tol "
          f"{TOL['bfloat16'][0]} of max(|score|, 1))", flush=True)
    if sorted(verdict["flagged"]) != flagged:
        fail(f"anomaly flagged {sorted(verdict['flagged'])}; the plain "
             f"path flags {flagged}")
    if [r["first_flag_index"] for r in detail["reports"]] != firsts:
        fail("anomaly first_flag_index differs from the plain path's")
    if score_err > TOL["bfloat16"][0]:
        fail("anomaly scores disagree with the plain path")

    by_raw = clis["predict --raw"].json()
    secs["predict --raw"] = clis["predict --raw"].seconds
    by_feats = clis["predict --features"].json()
    count(by_raw)
    count(by_feats)
    with np.load(by_raw["out"]) as a, np.load(by_feats["out"]) as b:
        same = np.array_equal(a["predictions"],
                              b["predictions"][:SYNTH_BUCKETS])
        shape = a["predictions"].shape
    print(f"check main raw predict --raw vs --features: {shape}, "
          f"bit-identical {same}; predict --raw {secs['predict --raw']:.2f}"
          f" s (stages {rounded(by_raw['seconds'])})", flush=True)
    if not same or shape != (SYNTH_BUCKETS, 88, 3):
        fail("predict --raw differs from predict --features")
    total = time.perf_counter() - t_phase
    print(f"main raw phase: {total:.1f} s of wall time; CLI seconds "
          f"{rounded(secs)}; launches of this "
          f"path {launches}", flush=True)
    return {"launches": launches, "seconds": secs, "total_s": total,
            "windows_per_s": n_windows / t_many, "sweep_rel": sweep_rel,
            "score_err": score_err, "ckpt": ckpt, "sample": sample,
            "raw": raw,
            "mix": mix, "plain": plain, "synth": synth,
            "crypto": (data.traffic, data.targets())}


def host_profile(pred, series) -> None:
    """Where the host's share of one predict_series_many call goes:
    cProfile's functions by their own time (C calls such as numpy's
    count in the Python function that made them)."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    pred.predict_series_many(series)
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)
    total = sum(v[2] for v in stats.stats.values())
    print(f"host profile what-if: wall {wall * 1e3:.3f} ms under cProfile, "
          f"own time of all functions {total * 1e3:.3f} ms; by function:",
          flush=True)
    for (path, line, name), (_, calls, own, _, _) in rows[:10]:
        print(f"  {own * 1e3:9.3f} ms  x{calls:<5d} "
              f"{os.path.basename(path)}:{line}({name})", flush=True)


def request_breakdown(pred, bodies: list) -> dict:
    """The host work of one /v1/predict request, in-process and without a
    socket, on the warmed captured predictor: median ms of the JSON
    parse, the service's predict (array checks, predict_series,
    ``tolist``) and the JSON encode, over every request length."""
    import numpy as np

    from deeprest_tpu_torch.serve.server import PredictionService

    service = PredictionService(pred)
    parts = {"json.loads": [], "predict": [], "json.dumps": []}
    try:
        for _ in range(5):
            for body in bodies:
                t0 = time.perf_counter()
                payload = json.loads(body)
                t1 = time.perf_counter()
                out = service.predict(payload)
                t2 = time.perf_counter()
                json.dumps(out)
                t3 = time.perf_counter()
                for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                    parts[key].append(dt * 1e3)
    finally:
        service.close()
    ms = {k: float(np.median(v)) for k, v in parts.items()}
    print(f"main plane request host work (in-process, no socket, the "
          f"closed loop's request mix): median ms {ms}", flush=True)
    return ms


def spawn_server(args: list, log_path: str):
    """``python -m deeprest_tpu_torch serve ARGS --port 0`` in its own
    process, output to ``log_path``; returns the process at once."""
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(log_path, "w", encoding="utf-8") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeprest_tpu_torch", "serve",
             *map(str, args), "--port", "0"], cwd=REPO, env=env,
            stdout=log, stderr=subprocess.STDOUT, text=True)
    CHILDREN.append(proc)
    return proc


def start_server(args: list, log_path: str, timeout: float = 300.0):
    """:func:`spawn_server`, then :func:`wait_listening`."""
    return wait_listening(spawn_server(args, log_path), args, log_path,
                          timeout)


def wait_listening(proc, args: list, log_path: str,
                   timeout: float = 300.0):
    """(process, startup JSON) once the server listens; the process is
    killed and the run fails if it does not."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(log_path, encoding="utf-8") as log:
            for line in log:
                if line.startswith('{"listening"'):
                    return proc, json.loads(line)
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    stop_server(proc)
    with open(log_path, encoding="utf-8") as log:
        fail(f"serve {args} did not listen:\n{log.read()[-6000:]}")


def stop_server(proc) -> None:
    proc.kill()
    proc.wait(timeout=60)


def http_json(url: str, payload=None, timeout: float = 300.0):
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def closed_loop(url: str, bodies: list, concurrency: int,
                seconds: float, keep: int = 4) -> dict:
    """``concurrency`` client threads each post ``bodies`` in turn to
    ``url``/v1/predict, back to back, for ``seconds``; requests/s over the
    window and p50/p99 latency in ms, and under ``samples`` the first
    ``keep`` answers to each body (its index -> raw answers)."""
    import http.client
    import threading
    import urllib.parse

    import numpy as np

    where = urllib.parse.urlsplit(url)
    lat, errors, lock = [], [], threading.Lock()
    samples = {i: [] for i in range(len(bodies))}
    stop = time.monotonic() + seconds

    def client(i):
        conn = http.client.HTTPConnection(where.hostname, where.port,
                                          timeout=120)
        k = i
        while time.monotonic() < stop:
            t0 = time.perf_counter()
            conn.request("POST", "/v1/predict", bodies[k % len(bodies)],
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answer = resp.read()
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                if resp.status != 200:
                    errors.append(resp.status)
                elif len(samples[k % len(bodies)]) < keep:
                    samples[k % len(bodies)].append(answer)
            k += 1
        conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 300)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"closed loop at concurrency {concurrency}: statuses {errors[:5]}")
    ms = np.sort(np.asarray(lat)) * 1e3
    return {"requests": len(lat), "rps": len(lat) / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "samples": samples}


def concurrent_answers(label: str, loads: dict, single: list,
                       exact: bool) -> dict:
    """The closed loops' sampled answers against the single-client answer
    to the same body: bit for bit when ``exact`` (no batcher: every
    request runs alone through its fused rung), else within the bf16
    tolerance of scale (coalesced batches change the rung, hence the
    GEMM's shape); fails the script on a disagreement."""
    import numpy as np

    worst, n = {}, 0
    for conc, load in loads.items():
        err = 0.0
        for i, answers in load.pop("samples").items():
            want = np.asarray(single[i], np.float32)
            for raw in answers:
                got = np.asarray(json.loads(raw)["predictions"], np.float32)
                if got.shape != want.shape:
                    fail(f"plane {label} concurrency {conc}: answer shape "
                         f"{got.shape}, single-client {want.shape}")
                err = max(err, float(np.abs(got - want).max())
                          / max(float(np.abs(want).max()), 1e-12))
                n += 1
        worst[conc] = err
    limit = 0.0 if exact else TOL["bfloat16"][0]
    print(f"check plane {label}: {n} sampled closed-loop answers vs the "
          f"single-client answer to the same body, max_err/max|ref| per "
          f"concurrency {worst} (tol {limit}"
          f"{', bit for bit' if exact else ''})", flush=True)
    if max(worst.values()) > limit:
        fail(f"plane {label}: concurrent answers differ from the "
             "single-client ones")
    return worst


def rel_err(got, want, cols) -> float:
    """Max |got - want| over ``cols`` over the largest |want| there."""
    import numpy as np

    got, want = np.asarray(got)[:, cols], np.asarray(want)[:, cols]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def band_peaks(estimates: dict, delta) -> dict:
    """What-if bands → the sweep's peaks (serve/whatif.py): the largest
    value, or for a delta metric (a relative level) the largest growth
    over its start."""
    import numpy as np

    out = {}
    for e, (metric, bands) in enumerate(estimates.items()):
        rel = delta is not None and bool(delta[e])
        out[metric] = {q: (max(float(np.max(v) - v[0]), 0.0) if rel
                           else float(np.max(v)))
                       for q, v in ((q, np.asarray(v)) for q, v in
                                    bands.items())}
    return out


def series_errors(got: dict, want: dict, y_range) -> dict:
    """What-if band errors over the whole series, ``(metric, quantile)`` ->
    max |got - want| over the metric's scale (its largest |plain value|,
    floored at its train-split range)."""
    import numpy as np

    out = {}
    for e, metric in enumerate(want):
        for q, w in want[metric].items():
            w = np.asarray(w, np.float64)
            g = np.asarray(got[metric][q], np.float64)
            scale = max(float(np.abs(w).max()), float(y_range[e]), 1e-12)
            out[(metric, q)] = float(np.abs(g - w).max()) / scale
    return out


def check_graphs(label: str, health: dict, warmed: int) -> dict:
    """The server's graph ledger after its load: every capture happened at
    warm-up, one per (program, rung) key warmed."""
    cache = health["jit_cache"]
    rungs = health["fused_infer"]["graphs"]["rungs"]
    ladder = (health["batcher"] or health)["shape_ladder"]
    print(f"check plane {label} graphs: {cache['captures']} captured at "
          f"warm-up for {warmed} (program, rung) keys {rungs}; "
          f"{cache['captures_after_warmup']} after warm-up; "
          f"{cache['replays']} replays; ladder rungs dispatched by requests "
          f"{ladder['compiled_rungs']}, fused rungs "
          f"{health['fused_infer']['dispatched_rungs']}", flush=True)
    if cache["captures"] != warmed or len(rungs) != warmed:
        fail(f"{label}: {cache['captures']} graphs captured for {warmed} "
             "warmed keys")
    if cache["captures_after_warmup"]:
        fail(f"{label}: {cache['captures_after_warmup']} captures after "
             "warm-up")
    return cache


def phase_serving_plane(cuda_gru, flagship: dict, raw: dict,
                        wd: str) -> dict:
    """The serve CLI on the card: the flagship checkpoint behind HTTP with
    the MicroBatcher and without it (captures, answers, closed-loop load,
    its sampled answers against single-client ones), captured against
    eager engines in-process (bit for bit, the launch ledger, windows/s
    in turns, the busy share), and the social network with --raw
    --surface held against phase 7's plain path, its what-if series also
    read at f32."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.config import SurfaceConfig
    from deeprest_tpu_torch.serve.fused import plan_windows
    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.serve.server import PredictionService
    from deeprest_tpu_torch.serve.whatif import WhatIfEstimator
    from deeprest_tpu_torch.train.checkpoint import load_params

    traffic, delta, ref = (flagship["traffic"], flagship["delta"],
                           flagship["ref"])
    e = FLAGSHIP["E"]
    launches = 0
    result = {"http": {}}
    # the JAX serve bench's mix (1-2 windows at W=24), scaled to W=60
    rng = np.random.default_rng(SEED)
    bodies = []
    for minutes in PLANE_REQUEST_MINUTES:
        lo = int(rng.integers(0, DAY - minutes))
        bodies.append(json.dumps(
            {"traffic": traffic[lo:lo + minutes].tolist()}).encode())
    # the flagship servers start together and the social one once the
    # first has stopped (two servers at a time: the social one reserves
    # ~27 GB at warm-up), each loading while another is read; this
    # process's cached blocks go back to the card first
    free_device()
    server_args = {
        "batcher": ["--ckpt-dir", flagship["ckpt"]],
        "no-batcher": ["--ckpt-dir", flagship["ckpt"], "--no-batcher"],
        "social": ["--ckpt-dir", raw["ckpt"], "--raw", raw["sample"],
                   "--surface"]}
    logs = {label: os.path.join(wd, f"serve_{label}.log")
            for label in server_args}
    procs = {label: spawn_server(server_args[label], logs[label])
             for label in ("batcher", "no-batcher")}
    for label in ("batcher", "no-batcher"):
        if label == "no-batcher":
            procs["social"] = spawn_server(server_args["social"],
                                           logs["social"])
        t_server = time.perf_counter()
        proc, start = wait_listening(procs[label], server_args[label],
                                     logs[label])
        try:
            url = start["listening"]
            warmed = start["graphs"]["captures"]
            print(f"main plane {label}: listening after load "
                  f"{start['seconds']['load']:.2f} s, warm-up (captures) "
                  f"{start['seconds']['warm']:.2f} s, {warmed} graphs",
                  flush=True)
            t0 = time.perf_counter()
            status, body = http_json(url + "/v1/predict",
                                     {"traffic": traffic.tolist()})
            day_s = time.perf_counter() - t0
            if status != 200:
                fail(f"plane {label} /v1/predict answered {status}: {body}")
            got = np.asarray(body["predictions"], np.float32)
            if got.shape != (DAY, e, 3) or not np.isfinite(got).all():
                fail(f"plane {label} predictions have shape {got.shape}")
            errs = {name: rel_err(got, ref, cols)
                    for cols, name in ((~delta, "non-delta"),
                                       (delta, "delta"))}
            print(f"check plane {label} /v1/predict {DAY}x{F} ({day_s:.2f} s "
                  f"with JSON) vs host loop over the plain recurrence: "
                  f"max_err/max|ref| {errs} (tol {TOL['bfloat16'][0]})",
                  flush=True)
            if max(errs.values()) > TOL["bfloat16"][0]:
                fail(f"plane {label} /v1/predict disagrees with the plain "
                     "path")
            single = []                  # warms the client path too
            for body_ in bodies:
                status, answer = http_json(url + "/v1/predict",
                                           json.loads(body_))
                if status != 200:
                    fail(f"plane {label} /v1/predict answered {status}")
                single.append(answer["predictions"])
            loads = {}
            for conc in PLANE_CONCURRENCY:
                loads[conc] = closed_loop(url, bodies, conc, PLANE_LOAD_S)
            concurrent_answers(label, loads, single,
                               exact=label == "no-batcher")
            status, health = http_json(url + "/healthz")
            check_graphs(label, health, warmed)
            coalesced = (health["batcher"]["coalesced_batches"]
                         if health.get("batcher") else None)
            k1 = health["kernel_launches"]["gru_fwd"]
            for conc, load in loads.items():
                print(f"main plane {label} closed loop, concurrency {conc}: "
                      f"{load['requests']} requests in {PLANE_LOAD_S} s = "
                      f"{load['rps']:.1f} requests/s, p50 "
                      f"{load['p50_ms']:.2f} ms, p99 {load['p99_ms']:.2f} ms",
                      flush=True)
            print(f"main plane {label}: coalesced_batches {coalesced}, "
                  f"gru_fwd launches {k1} (graph replays counted)",
                  flush=True)
            if k1 == 0:
                fail(f"plane {label} never launched gru_fwd")
            launches += k1
            result["http"][label] = {"loads": loads,
                                     "coalesced_batches": coalesced,
                                     "predict_err": errs}
            if label == "batcher":      # phase 12's single-engine answers
                result.update(bodies=bodies, single=single)
        finally:
            stop_server(proc)
        print(f"main plane {label}: {time.perf_counter() - t_server:.1f} s "
              "from the wait for its start", flush=True)

    # captured against eager, in-process
    t_inproc = time.perf_counter()
    captured = Predictor.from_checkpoint(flagship["ckpt"], device="cuda")
    eager = Predictor.from_checkpoint(flagship["ckpt"], device="cuda",
                                      cuda_graphs=False)
    captured.warm()
    scales = np.linspace(0.5, 2.0, 16).astype(np.float32)
    scales[0] = 1.0
    series = [traffic * s for s in scales]
    n_windows = len(plan_windows([DAY] * len(series), W))
    for pred in (eager, captured):
        pred.predict_series_many(series)                 # warm
    k1_before = cuda_gru.GRU_FWD.launches
    pages_before = captured.fused.stats()["pages"]
    captured.predict_series_many(series)
    pages = captured.fused.stats()["pages"] - pages_before
    k1 = cuda_gru.GRU_FWD.launches - k1_before
    print(f"check plane K1 ledger: {k1} gru_fwd launches for {pages} "
          f"captured pages (2 a page, bidirectional)", flush=True)
    if k1 != 2 * pages:
        fail(f"the launch ledger counted {k1} K1 launches for {pages} pages")
    rates = {"eager": [], "captured": []}
    for label in ("eager", "captured", "captured", "eager"):
        pred = captured if label == "captured" else eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_series_many(series)
        torch.cuda.synchronize()
        rates[label].append(n_windows / (time.perf_counter() - t0))
    print(f"main plane predict_series_many: 16 one-day series, {n_windows} "
          f"windows; windows/s in turns eager {rates['eager'][0]:.1f}, "
          f"captured {rates['captured'][0]:.1f}, captured "
          f"{rates['captured'][1]:.1f}, eager {rates['eager'][1]:.1f}",
          flush=True)
    busy = profile_what_if(captured, series)
    host_profile(captured, series)
    result["request_ms"] = request_breakdown(captured, bodies)
    # bit for bit over >= 8 pages: one page of 64 a call
    params = load_params(flagship["ckpt"])
    paged = {}
    for graphs in (True, False):
        with_delta = Predictor.from_checkpoint(
            flagship["ckpt"], device="cuda", coalesce_pages=1,
            cuda_graphs=graphs)
        no_delta = Predictor(
            params, with_delta.model_config, with_delta.x_stats,
            with_delta.y_stats, with_delta.metric_names, W,
            coalesce_pages=1, device="cuda", cuda_graphs=graphs)
        paged[graphs] = (with_delta, no_delta)
    many = [traffic * s for s in np.linspace(0.5, 2.0, 24)]
    n_pages = -(-len(plan_windows([DAY] * len(many), W)) // 64)
    same = {}
    for i, name in enumerate(("delta carry", "no delta")):
        for integrate in (True, False):
            got = paged[True][i].predict_series_many(many, integrate)
            want = paged[False][i].predict_series_many(many, integrate)
            same[f"{name}, integrate={integrate}"] = all(
                np.array_equal(a, b) for a, b in zip(got, want))
    del paged, many
    print(f"check plane captured vs eager engine, {n_pages} pages of 64 "
          f"windows: bit-identical {same}", flush=True)
    if not all(same.values()) or n_pages < 8:
        fail("captured engine outputs differ from the eager engine's")
    result.update(rates=rates, busy=busy, bit_identical=same,
                  windows=n_windows)
    print(f"main plane in-process: {time.perf_counter() - t_inproc:.1f} s",
          flush=True)

    # the social network with --raw --surface: its answers against phase
    # 7's plain path in-process, and the /v1/whatif series read at f32
    # too (the kernels against the plain recurrence, and the plain path's
    # own bf16 rounding), so a gap shows whether it is bf16 precision
    t_social = time.perf_counter()
    proc, start = wait_listening(procs["social"], server_args["social"],
                                 logs["social"])
    try:
        url = start["listening"]
        program = [raw["mix"]] * DAY
        payloads = {
            "/v1/whatif": {"expected_traffic": program},
            "/v1/whatif/surface": {"base_traffic": program[:2 * W],
                                   "factor": 2, "wait": True},
            "/v1/anomaly": {"traffic": raw["crypto"][0].tolist(),
                            "observed": raw["crypto"][1].tolist()}}
        answers = {}
        for route, payload in payloads.items():
            t0 = time.perf_counter()
            status, body = http_json(url + route, payload)
            if status != 200:
                fail(f"plane social {route} answered {status}: {body}")
            answers[route] = (body, time.perf_counter() - t0)
        status, health = http_json(url + "/healthz")
        check_graphs("social", health, start["graphs"]["captures"])
        k1 = health["kernel_launches"]["gru_fwd"]
        launches += k1
    finally:
        stop_server(proc)
    plain, synth = raw["plain"], raw["synth"]
    service = PredictionService(plain, synth)
    surfaces = PredictionService(
        plain, synth, surface=SurfaceConfig(enabled=True, warm_async=False))
    try:
        want = {"/v1/whatif": service.whatif_estimate(payloads["/v1/whatif"]),
                "/v1/anomaly": service.anomaly(payloads["/v1/anomaly"]),
                "/v1/whatif/surface": surfaces.whatif_surface(
                    payloads["/v1/whatif/surface"])}
    finally:
        service.close()
        surfaces.close()
    f32 = {label: WhatIfEstimator(at_dtype(plain, "float32", **kw),
                                  synth).estimate(program, seed=0)
           for label, kw in (
               ("kernels", {}),
               ("plain", {"recurrence": cuda_gru.gru_recurrence_reference,
                          "cuda_graphs": False}))}
    y_range = np.asarray(plain.y_stats.range, np.float32).reshape(-1)
    whatif = answers["/v1/whatif"][0]["estimates"]
    plain_whatif = want["/v1/whatif"]["estimates"]
    err_peaks = sweep_error([{"peaks": band_peaks(whatif, plain.delta_mask)}],
                            [{"peaks": band_peaks(plain_whatif,
                                                  plain.delta_mask)}],
                            y_range)
    readings = {
        "bf16 kernels (HTTP) vs bf16 plain": series_errors(
            whatif, plain_whatif, y_range),
        "f32 kernels vs f32 plain": series_errors(
            f32["kernels"], f32["plain"], y_range),
        "bf16 plain vs f32 plain": series_errors(
            plain_whatif, f32["plain"], y_range),
        "bf16 kernels (HTTP) vs f32 plain": series_errors(
            whatif, f32["plain"], y_range)}
    worst = max(readings["bf16 kernels (HTTP) vs bf16 plain"].items(),
                key=lambda kv: kv[1])[0]
    surf = answers["/v1/whatif/surface"][0]
    err_surface = sweep_error([surf], [want["/v1/whatif/surface"]], y_range)
    got_an = answers["/v1/anomaly"][0]
    flags_equal = (sorted(got_an["flagged"])
                   == sorted(want["/v1/anomaly"]["flagged"]))
    print(f"check plane social (F=128, E=88) vs phase 7's plain path "
          f"in-process: /v1/whatif peaks max_err/scale {err_peaks:.3e}, "
          f"/v1/whatif/surface (hit {surf['surface'].get('hit')}, parity "
          f"{surf['surface'].get('parity')}) {err_surface:.3e} (tol "
          f"{TOL['bfloat16'][0]}); /v1/anomaly flagged "
          f"{len(got_an['flagged'])} of {len(got_an['reports'])}, sets "
          f"equal {flags_equal}; seconds "
          f"{ {k: round(v[1], 3) for k, v in answers.items()} }; gru_fwd "
          f"launches {k1}", flush=True)
    print("check plane social /v1/whatif series, the whole day tick by "
          "tick, max_err/scale (at the worst HTTP-vs-plain band, "
          f"{worst[0]} {worst[1]}): " + "; ".join(
              f"{name} {max(errs.values()):.3e} ({errs[worst]:.3e})"
              for name, errs in readings.items()), flush=True)
    if max(err_peaks, err_surface) > TOL["bfloat16"][0] or not flags_equal:
        fail("the social-network plane disagrees with the plain path")
    # the series gate: at f32 the kernels compute the plain function
    # (GRAD_TOL, the repo's f32 tolerance for long sums); in bf16 they lose
    # no more to rounding than the plain path does, both read against f32
    # (the checkpoint's bf16 rounding of a near-constant increment adds up
    # over the day, so two bf16 paths may part by more than 2e-2)
    series = {k: max(v.values()) for k, v in readings.items()}
    f32_gap = series["f32 kernels vs f32 plain"]
    bf16_loss = (series["bf16 kernels (HTTP) vs f32 plain"]
                 / max(series["bf16 plain vs f32 plain"], 1e-12))
    print(f"check plane social /v1/whatif series gates: f32 kernels vs f32 "
          f"plain {f32_gap:.3e} (tol {GRAD_TOL['float32']}); bf16 kernels' "
          f"error from f32 over the bf16 plain path's {bf16_loss:.3f} "
          f"(tol 2)", flush=True)
    if f32_gap > GRAD_TOL["float32"] or bf16_loss > 2.0:
        fail("the social-network /v1/whatif series disagrees with the plain "
             "path")
    print(f"main plane social: {time.perf_counter() - t_social:.1f} s",
          flush=True)
    result.update(launches=launches, err_peaks=err_peaks,
                  err_surface=err_surface, series=series)
    return result

# -- phase 12: the replica plane --------------------------------------------

# (mode, replicas, admission depth, closed-loop concurrencies, role)
REPLICA_PLANES = (
    # (process R = 1 was cut to keep the script near 700 s with the fleet
    # phase: phase 8's single engine is the one-replica baseline; R = 4,
    # whose requests/s matched R = 2's on the card (the front sets the
    # pace), was cut for phase 16's time, its overload cell moved to R = 2)
    ("process", 2, 64, (16, 64, 256), "chaos"),  # SIGKILL, then the reload
    ("thread", 2, 64, (16, 64), "profile"),
    # the front admits a few requests at a time (PERF.md §5), so a depth
    # of 64 never binds on one card: the 429 path is driven at depth 2
    ("thread", 1, 2, (256,), "shed"),
)
REPLICA_CONCURRENCY = (16, 64)
REPLICA_OVERLOAD = 256
REPLICA_LOAD_S = 1.0
REPLICA_CLIENT_PROCS = 4            # client processes of a closed loop
REPLICA_OVERLOAD_PROCS = 8          # ... and of the overload's
RELOAD_SCALE = 1.25                 # the newer step's params, x this


def replica_health(url: str) -> dict:
    status, health = http_json(url + "/healthz", timeout=120)
    if status != 200:
        fail(f"replica plane /healthz answered {status}: {health}")
    return health


def worker_launches(health: dict) -> int:
    """K1 launches of every worker of a process plane (their own
    ledgers), or of the front of a thread plane."""
    workers = [r.get("worker") for r in health["router"]["replicas"]]
    if all(w is None for w in workers):
        return health["kernel_launches"]["gru_fwd"]
    return sum(w["kernel_launches"]["gru_fwd"] for w in workers if w)


def check_worker_graphs(label: str, health: dict, warmed: int) -> list:
    """Each worker's rung graphs (a thread plane's shared stack): every
    capture at warm-up, none after; returns each worker's device memory."""
    replicas = health["router"]["replicas"]
    if replicas[0]["kind"] == "thread":
        ledgers = [health["jit_cache"]]
        memory = [health["device_memory"]]
    else:
        ledgers = [(r["worker"] or {}).get("jit_cache") for r in replicas]
        memory = [(r["worker"] or {}).get("memory") for r in replicas]
    for ledger in ledgers:
        if ledger is None or ledger["captures"] != warmed \
                or ledger["captures_after_warmup"]:
            fail(f"replica plane {label}: graphs {ledger} (want {warmed} "
                 "captured at warm-up, none after)")
    print(f"check replica {label} graphs: {[g['captures'] for g in ledgers]}"
          f" captured at warm-up, {[g['captures_after_warmup'] for g in ledgers]}"
          f" after; device memory allocated/reserved MiB "
          f"{[(m['allocated'] >> 20, m['reserved'] >> 20) if m else None for m in memory]};"
          f" the front's {health['device_memory']}", flush=True)
    return memory


def window_verdicts(got, old, new) -> set:
    """Which step each window of one answer matches (within the bf16
    tolerance of scale): the first and the right-aligned last window."""
    import numpy as np

    out = set()
    for rows in (slice(0, W), slice(len(got) - W, len(got))):
        g, errs = got[rows], {}
        for name, want in (("old", old), ("new", new)):
            w = want[rows]
            errs[name] = float(np.abs(g - w).max()
                               / max(float(np.abs(w).max()), 1e-12))
        out.add(min(errs, key=errs.get) if min(errs.values())
                <= TOL["bfloat16"][0] else "neither")
    return out


def background_load(url: str, bodies: list, concurrency: int):
    """Client threads posting ``bodies`` in turn until stopped; returns
    (stop event, threads, records of (status, body index, answer))."""
    import http.client
    import threading
    import urllib.parse

    where = urllib.parse.urlsplit(url)
    stop, lock, records = threading.Event(), threading.Lock(), []

    def client(i):
        conn = http.client.HTTPConnection(where.hostname, where.port,
                                          timeout=120)
        k = i
        while not stop.is_set():
            j = k % len(bodies)
            k += 1
            try:
                conn.request("POST", "/v1/predict", bodies[j],
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                answer = resp.read()
            except OSError as exc:
                answer, status = repr(exc).encode(), -1
                conn.close()
                conn = http.client.HTTPConnection(where.hostname, where.port,
                                                  timeout=120)
            else:
                status = resp.status
            with lock:
                records.append((status, j, answer))
        conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(concurrency)]
    for t in threads:
        t.start()
    return stop, threads, records


def stop_load(stop, threads) -> None:
    stop.set()
    for t in threads:
        t.join(150)
    if any(t.is_alive() for t in threads):
        fail("replica plane: a client thread hung")


def wait_for(what: str, cond, timeout: float = 180.0):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            fail(f"replica plane: {what} within {timeout:.0f} s")
        time.sleep(0.25)


def replica_chaos(url: str, bodies: list, single: list) -> dict:
    """SIGKILL worker p0 of a two-worker process plane under load: its
    in-flight requests retried on p1, no 5xx, the probe restarts it and it
    serves again; returns its K1 launches before the kill."""
    import signal

    health = replica_health(url)
    victim = health["router"]["replicas"][0]
    survivor0 = health["router"]["replicas"][1]["served_requests"]
    victim_k1 = victim["worker"]["kernel_launches"]["gru_fwd"]
    stop, threads, records = background_load(url, bodies, 16)
    try:
        time.sleep(1.0)
        t_kill = time.perf_counter()
        os.kill(victim["pid"], signal.SIGKILL)

        def rejoined():
            h = replica_health(url)
            r = h["router"]["replicas"][0]
            return h if (not r["health"]["ejected"] and r["pid"]
                         != victim["pid"] and r["worker"]) else None

        health = wait_for("the killed worker rejoining", rejoined)
        rejoin_s = time.perf_counter() - t_kill
        time.sleep(1.0)                 # it serves again under the load
    finally:
        stop_load(stop, threads)
    statuses = [s for s, _, _ in records]
    bad = [s for s in statuses if s != 200]
    totals = health["router"]["health"]
    replicas = health["router"]["replicas"]
    print(f"check replica chaos: SIGKILL of p0 (pid {victim['pid']}) under "
          f"16 clients: {len(statuses)} requests, non-200 {bad[:5]} "
          f"({len(bad)}), ejections {totals['ejections']}, retries "
          f"{totals['retries']}, rejoins {totals['rejoins']} after "
          f"{rejoin_s:.1f} s (restart with its graphs captured); p1 served "
          f"{replicas[1]['served_requests'] - survivor0} meanwhile, p0 "
          f"{replicas[0]['served_requests'] - victim['served_requests']} "
          "since", flush=True)
    if bad or totals["ejections"] < 1 or totals["rejoins"] < 1:
        fail("replica plane: the killed worker was not retried around and "
             "rejoined cleanly")
    if replicas[1]["served_requests"] <= survivor0:
        fail("replica plane: the surviving worker stopped serving")
    # the rejoined worker answers bit for bit the single engine
    after = replica_health(url)["router"]["replicas"][0]["served_requests"]
    for i, body in enumerate(bodies):
        status, answer = http_json(url + "/v1/predict", json.loads(body))
        if status != 200 or answer["predictions"] != single[i]:
            fail("replica plane: an answer after the rejoin differs from "
                 "the single engine's")
    if replica_health(url)["router"]["replicas"][0]["served_requests"] \
            <= after:
        fail("replica plane: the rejoined worker serves nothing")
    return {"rejoin_s": rejoin_s, "requests": len(statuses),
            "victim_k1": victim_k1, **totals}


def replica_reload(url: str, ckpt: str, extra: dict, params: dict,
                   bodies: list) -> dict:
    """Write step 1 (params x RELOAD_SCALE) into the watched checkpoint
    under load: the workers restart one at a time, every answer is the old
    step's or the new step's (each of its windows, never a mix), and each
    worker captures only at its re-warm; returns the workers' K1 launches
    before the roll."""
    import numpy as np

    from deeprest_tpu_torch.train.checkpoint import save_checkpoint

    body = bodies[-1]                    # two windows (117 minutes)
    _, old = http_json(url + "/v1/predict", json.loads(body))
    before = replica_health(url)
    k1 = worker_launches(before)
    pids = [r["pid"] for r in before["router"]["replicas"]]
    stop, threads, records = background_load(url, [body], 8)
    try:
        time.sleep(1.0)
        t0 = time.perf_counter()
        save_checkpoint(ckpt, {k: v * RELOAD_SCALE for k, v in
                               params.items()}, step=1, extra=extra)

        def rolled():
            h = replica_health(url)
            r = h["router"]
            return h if (r["rolling_reloads"] >= 1 and all(
                x["pid"] not in pids and x["worker"]
                for x in r["replicas"])) else None

        health = wait_for("the rolling reload", rolled, timeout=240)
        roll_s = time.perf_counter() - t0
        time.sleep(1.0)
    finally:
        stop_load(stop, threads)
    _, new = http_json(url + "/v1/predict", json.loads(body))
    old = np.asarray(old["predictions"], np.float32)
    new = np.asarray(new["predictions"], np.float32)
    gap = float(np.abs(new - old).max() / np.abs(old).max())
    counts = {"old": 0, "new": 0, "mixed": 0, "non-200": 0}
    for status, _, answer in records:
        if status != 200:
            counts["non-200"] += 1
            continue
        got = np.asarray(json.loads(answer)["predictions"], np.float32)
        v = window_verdicts(got, old, new)
        counts[v.pop() if len(v) == 1 and v <= {"old", "new"}
               else "mixed"] += 1
    check_worker_graphs("after the reload", health, before["router"][
        "replicas"][0]["worker"]["jit_cache"]["captures"])
    print(f"check replica reload: step 1 (x{RELOAD_SCALE}) written under 8 "
          f"clients; both workers restarted one at a time in {roll_s:.1f} s;"
          f" answers {counts} (old and new apart by {gap:.3f} of scale)",
          flush=True)
    if counts["mixed"] or counts["non-200"] or not counts["old"] \
            or not counts["new"] or gap < 10 * TOL["bfloat16"][0]:
        fail("replica plane: the rolling reload mixed params or failed "
             "requests")
    return {"roll_s": roll_s, "answers": counts, "workers_k1": k1}


def replica_profile(url: str, bodies: list, wd: str) -> dict:
    """``profile --seconds 1`` against a thread plane under load: the
    Chrome trace holds K1's kernel by its symbol."""
    stop, threads, records = background_load(url, bodies, 8)
    try:
        time.sleep(0.5)
        out = run_cli(["profile", "--url", url, "--seconds", "1",
                       "--out-dir", os.path.join(wd, "profile")],
                      timeout=120)
    finally:
        stop_load(stop, threads)
    with open(out["trace"], encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "gru_fwd" in e.get("name", "")]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e6
    host = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("dur"):
            host[e["name"]] = host.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    print(f"check replica profile: a 1 s window under 8 clients "
          f"({len(records)} requests): {len(events)} events, {len(kernels)} "
          f"kernels ({busy * 1e3:.1f} ms of device time), K1 "
          f"{len(k1)} x {sorted({e['name'][:60] for e in k1})}; all threads "
          f"{out['all_threads']}; host ops by total ms {top}", flush=True)
    if not k1:
        fail("replica plane: the profiler window holds no K1 kernel")
    return {"events": len(events), "kernels": len(kernels),
            "k1": len(k1), "device_s": busy, "host_ms": top}


def start_profiled_train(wd: str) -> tuple[CliRun, str]:
    """``train --profile-dir`` on phase 6's corpus (one epoch traced),
    started now; returns the run and its trace directory."""
    feats = flagship_corpus(os.path.join(wd, "corpus.npz"))
    prof = os.path.join(wd, "train_profile")
    return CliRun(["train", "--features", feats, "--epochs", "1",
                   "--batch-size", str(TRAIN["B"]), "--window", str(W),
                   "--compute-dtype", "bfloat16", "--no-baselines",
                   "--profile-dir", prof], timeout=600), prof


def replica_training_tools(cuda_gru, profiled: tuple) -> dict:
    """The traced epoch of :func:`start_profiled_train` and
    ``measure_step_breakdown`` on a flagship trainer."""
    import numpy as np

    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.obs.profiler import measure_step_breakdown
    from deeprest_tpu_torch.train.trainer import Trainer

    run, prof = profiled
    report = run.json()
    train_s = run.seconds
    with open(os.path.join(prof, "trace_epoch1.json"),
              encoding="utf-8") as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "kernel"}
    ours = sorted(n[:50] for n in names if "gru_" in n)
    print(f"check replica train --profile-dir: 1 epoch ({report['steps']} "
          f"steps, {train_s:.1f} s with the process start), trace kernels "
          f"{len(names)}, ours {ours}", flush=True)
    if not any("gru_bwd" in n for n in names):
        fail("train --profile-dir: the trace holds no K3 kernel")
    rng = np.random.default_rng(SEED)
    b, e = TRAIN["B"], TRAIN["E"]
    cfg = Config(model=ModelConfig(hidden_size=TRAIN["H"], dropout_rate=0.0,
                                   compute_dtype="bfloat16"),
                 train=TrainConfig(batch_size=b, window_size=W))
    names = [f"comp{i // 5}_res{i % 5}" for i in range(e)]
    breakdown = measure_step_breakdown(
        Trainer(cfg, F, names, device="cuda"),
        rng.poisson(5.0, (b, W, F)).astype(np.float32),
        rng.random((b, W, e), np.float32), np.ones((b,), np.float32),
        steps=20, warmup=3)
    print(f"main replica step breakdown (flagship, eager steps, host "
          f"feed of fresh batches): {json.dumps(breakdown)}", flush=True)
    if breakdown["ledger"] != {"started": 3, "synced": 3}:
        fail(f"step breakdown ledger {breakdown['ledger']}")
    free_device()
    return {"train_s": train_s, "breakdown": breakdown}


def phase_replica_plane(cuda_gru, flagship: dict, plane: dict,
                        wd: str) -> dict:
    """The replica plane on the card: ``serve --replicas R`` with process
    replicas at R = 2 and thread replicas at 2, each with the
    MicroBatcher and --admission-depth 64, on phase 5's checkpoint:
    sequential answers bit for bit the single engine's (phase 8), closed
    loops at concurrency 16 and 64 (requests/s, p50/p99, per-replica
    served counts, each worker's graphs and device memory), concurrency
    256 against depth 64 on R = 2, SIGKILL of a worker under load and a
    rolling reload under load (the two-worker plane, --watch), a profiler
    window on the thread plane, fast 429s with Retry-After at 256 against
    depth 2 (one thread replica), then train --profile-dir and the step
    breakdown."""
    import shutil

    import numpy as np

    from deeprest_tpu_torch.benchmarks.serve_bench import closed_loop
    from deeprest_tpu_torch.train.checkpoint import load_params, load_sidecar

    import torch

    free_device()       # the earlier phases' cached blocks: workers need them
    print(f"main replica: this process holds "
          f"{torch.cuda.memory_reserved() >> 20} MiB of the card before the "
          f"replica servers start", flush=True)
    bodies, single = plane["bodies"], plane["single"]
    watched = os.path.join(wd, "replica_ckpt")    # the reload's own copy
    shutil.copytree(flagship["ckpt"], watched)
    launches, result = 0, {"cells": {}}
    # the first plane starts now; the others, and the traced training
    # epoch (its launches are not counted), once it listens, and they load
    # while it is read
    def spawn(mode, n, depth, role):
        args = ["--replicas", n, "--replica-mode", mode,
                "--admission-depth", depth]
        if role == "chaos":
            args += ["--watch", "1"]
        if role == "shed":
            args += ["--admission-wait-ms", 0]
        args += ["--ckpt-dir", watched if role == "chaos"
                 else flagship["ckpt"]]
        log = os.path.join(wd, f"serve_replicas_{mode}{n}_{depth}.log")
        return spawn_server(args, log), args, log

    spawned = [spawn(*(REPLICA_PLANES[0][:3] + REPLICA_PLANES[0][4:]))]
    for i, (mode, n, depth, concurrencies, role) in enumerate(
            REPLICA_PLANES):
        label = f"{mode} x{n} depth {depth}"
        t_server = time.perf_counter()
        proc, args, log = spawned[i]
        ckpt = args[-1]
        proc, start = wait_listening(proc, args, log, timeout=600)
        if i == 0:
            spawned += [spawn(m, r, d, ro)
                        for m, r, d, _, ro in REPLICA_PLANES[1:]]
            profiled = start_profiled_train(wd)
        try:
            url = start["listening"]
            graphs = start["graphs"] if mode == "process" \
                else [start["graphs"]]
            warmed = graphs[0]["captures"]
            print(f"main replica {label}: listening after a wait of "
                  f"{time.perf_counter() - t_server:.1f} s (seconds "
                  f"{json.dumps(start['seconds'])}), graphs at warm-up "
                  f"{[g['captures'] for g in graphs]}", flush=True)
            for i, body in enumerate(bodies):
                status, answer = http_json(url + "/v1/predict",
                                           json.loads(body))
                if status != 200 or answer["predictions"] != single[i]:
                    fail(f"replica {label}: the answer to body {i} is not "
                         "the single engine's, bit for bit")
            host, port = url[len("http://"):].split(":")
            loads, served = {}, []
            for conc in concurrencies:
                s0 = [r["served_requests"] for r in
                      replica_health(url)["router"]["replicas"]]
                load = closed_loop(
                    (host, int(port)), bodies, conc, REPLICA_LOAD_S,
                    procs=(REPLICA_OVERLOAD_PROCS if conc == REPLICA_OVERLOAD
                           else REPLICA_CLIENT_PROCS), keep=2)
                health = replica_health(url)
                served.append([r["served_requests"] - a for r, a in zip(
                    health["router"]["replicas"], s0)])
                load["per_replica_served"] = served[-1]
                load["admission"] = {k: health["router"]["admission"][k]
                                     for k in ("admitted", "rejected",
                                               "queued", "in_plane_p50_ms",
                                               "in_plane_p99_ms")}
                loads[conc] = load
                print(f"main replica {label} concurrency {conc}: "
                      f"{load['requests']} requests in {REPLICA_LOAD_S} s = "
                      f"{load['rps']:.1f} requests/s, p50 "
                      f"{load['p50_ms']:.2f} ms, p99 {load['p99_ms']:.2f} ms,"
                      f" 429s {load['rejected_429']} (Retry-After "
                      f"{load['retry_after']}), errors {load['errors']}, "
                      f"served per replica {served[-1]}; admission so far "
                      f"{load['admission']}", flush=True)
                if load["errors"]:
                    fail(f"replica {label}: {load['errors']} failed requests")
            overload = loads.pop(REPLICA_OVERLOAD, None)
            if overload is not None:
                overload.pop("samples")
                loads["overload"] = overload
            if role == "shed" and (not overload["rejected_429"] or overload[
                    "retry_after"] != ["0.050"] or not overload["requests"]):
                fail(f"replica {label}: no fast 429 with Retry-After at "
                     f"concurrency {REPLICA_OVERLOAD}")
            if loads.keys() & set(REPLICA_CONCURRENCY):
                concurrent_answers(f"replica {label}", {
                    c: loads[c] for c in REPLICA_CONCURRENCY}, single,
                    exact=False)
            health = replica_health(url)
            memory = check_worker_graphs(label, health, warmed)
            if any(min(s) == 0 for s in served):
                fail(f"replica {label}: a replica served nothing")
            cell = {"loads": loads, "memory": memory,
                    "front_memory": health["device_memory"]}
            if role == "chaos":
                chaos = replica_chaos(url, bodies, single)
                launches += chaos["victim_k1"]
                params = {k: v.float().cpu().numpy()
                          for k, v in load_params(ckpt).items()}
                reload = replica_reload(url, ckpt, load_sidecar(ckpt), params,
                                        bodies)
                launches += reload["workers_k1"]
                cell.update(chaos=chaos, reload=reload)
            if role == "profile":
                cell["profile"] = replica_profile(url, bodies, wd)
            k1 = worker_launches(replica_health(url))
            print(f"main replica {label}: gru_fwd launches {k1} (the "
                  f"workers' ledgers, graph replays counted); "
                  f"{time.perf_counter() - t_server:.1f} s with the start",
                  flush=True)
            if k1 == 0:
                fail(f"replica {label} never launched gru_fwd")
            launches += k1
            result["cells"][label] = cell
        finally:
            stop_server(proc)
    shutil.rmtree(watched, ignore_errors=True)
    result.update(tools=replica_training_tools(cuda_gru, profiled),
                  launches=launches)
    return result


# -- phase 13: the fleet tier -----------------------------------------------

FLEET_TENANTS = 100                 # JAX's full fleet arm
FLEET_BUDGET = 16
FLEET_PIN_MARGIN = 2                # MemAvailable over the spill, at least


def fleet_tenants(per_tenant: int) -> int:
    """JAX's 100 tenants, cut when the host cannot pin the spilled ones
    (``FLEET_PIN_MARGIN`` x their bytes must be available)."""
    avail = None
    with open("/proc/meminfo", encoding="utf-8") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    spill = (FLEET_TENANTS - FLEET_BUDGET) * per_tenant
    if avail is None or avail >= FLEET_PIN_MARGIN * spill:
        return FLEET_TENANTS
    m = FLEET_BUDGET + int(avail // (FLEET_PIN_MARGIN * per_tenant))
    print(f"fleet: cut to {m} tenants: {avail} bytes available cannot pin "
          f"{FLEET_TENANTS - FLEET_BUDGET} spilled tenants of {per_tenant} "
          f"bytes {FLEET_PIN_MARGIN} times over", flush=True)
    return max(m, FLEET_BUDGET + 2)


def tenant_post(url: str, body: bytes, tenant: str | None):
    """POST ``body`` to ``url`` with ``X-Tenant`` (none when None)."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["X-Tenant"] = tenant
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def fleet_http(ckpt: str, mix: list, want: dict, wd: str) -> int:
    """``serve --replicas 2 --replica-mode thread --no-batcher --fleet
    blue=… --fleet green=…`` on a copy of phase 5's checkpoint without its
    AOT sidecar and two scaled copies: its startup is a template admission
    without the sidecar, by stage; ``X-Tenant`` selects the model (answers
    equal the in-process pool's for the same weights), an unknown tenant
    is a 404, ``/healthz`` has the pool's view with 18 graphs on the plane
    and none after, ``/metrics`` the ``deeprest_fleet_*`` series.  Returns
    the server's K1 launches."""
    import shutil

    import numpy as np

    bare = os.path.join(wd, "fleet_bare_ckpt")
    shutil.copytree(ckpt, bare, ignore=shutil.ignore_patterns("aot"))

    # --no-batcher: every tenant's request then takes the fused path, as
    # in-process (a batcher would coalesce the default tenant's short
    # requests through the ladder's program instead)
    args = ["--ckpt-dir", bare, "--replicas", 2, "--replica-mode", "thread",
            "--no-batcher", "--fleet", f"blue={want['blue'][0]}",
            "--fleet", f"green={want['green'][0]}"]
    t0 = time.perf_counter()
    proc, start = start_server(args, os.path.join(wd, "serve_fleet.log"))
    try:
        url = start["listening"]
        graphs = start["graphs"]
        print(f"main fleet cold start without the sidecar (the fleet "
              f"server's startup): listening after "
              f"{time.perf_counter() - t0:.2f} s = interpreter, imports and "
              f"kernel library, then seconds {json.dumps(start['seconds'])} "
              f"(fleet: the plane and two more tenants' loads; warm: eager "
              f"first calls {graphs['seconds']['eager']:.4f} s, captures "
              f"{graphs['seconds']['capture']:.4f} s); graphs "
              f"{graphs['captures']}; fleet {json.dumps(start['fleet'])}",
              flush=True)
        if start["fleet"]["tenants"] != ["default", "blue", "green"] or \
                start["fleet"]["aot"]["last_reason"] != "no artifacts":
            fail(f"serve --fleet startup {start['fleet']}")
        for _ in range(2):
            for tenant in ("blue", None, "green"):
                for body, ref in zip(mix, want[tenant or "default"][1]):
                    status, answer = tenant_post(url + "/v1/predict",
                                                 body, tenant)
                    if status != 200:
                        fail(f"fleet /v1/predict ({tenant}) answered "
                             f"{status}: {answer}")
                    got = np.asarray(answer["predictions"], np.float32)
                    if not np.array_equal(got, ref):
                        fail(f"fleet /v1/predict ({tenant}) differs from "
                             "the in-process pool's answer for the same "
                             "weights")
                    if answer["tenant"]["name"] != (tenant or "default"):
                        fail(f"fleet answer names {answer['tenant']}")
        status, answer = tenant_post(url + "/v1/predict", mix[0], "ghost")
        if status != 404:
            fail(f"an unknown tenant got {status}, not 404: {answer}")
        status, health = http_json(url + "/healthz")
        pool, cache = health["fleet"]["pool"], health["jit_cache"]
        with urllib_open(url + "/metrics") as text:
            series = sorted({line.split()[0] for line in text.splitlines()
                             if line.startswith("deeprest_fleet_")})
        print(f"check fleet http: X-Tenant blue, default and green each "
              f"equal to the in-process pool's answers ({2 * len(mix)} "
              f"requests each, bit for bit); ghost 404 "
              f"({answer.get('error')}); /healthz fleet tenants "
              f"{sorted(health['fleet']['tenants'])}, pool tenants "
              f"{pool['tenants']} resident {pool['resident']}, plane "
              f"{pool['plane']}; graphs {cache['captures']} at warm-up, "
              f"{cache['captures_after_warmup']} after; /metrics {series}",
              flush=True)
        if cache["captures"] != 18 or cache["captures_after_warmup"]:
            fail(f"fleet server graphs {cache}")
        if "deeprest_fleet_tenants" not in series:
            fail(f"/metrics has no deeprest_fleet_* series: {series}")
        return health["kernel_launches"]["gru_fwd"]
    finally:
        stop_server(proc)


def urllib_open(url: str):
    """GET ``url`` as text, in a ``with``."""
    import contextlib
    import urllib.request

    @contextlib.contextmanager
    def opened():
        with urllib.request.urlopen(url, timeout=60) as resp:
            yield resp.read().decode()

    return opened()


def fleet_aot(ckpt: str) -> dict:
    """A template cold start of phase 5's checkpoint, with the sidecar
    phase 10's ``export --aot`` wrote next to it, in a fresh process, by
    stage (fleet_bench --cold-start)."""
    from deeprest_tpu_torch.serve.aot import MANIFEST_NAME, aot_dir

    if not os.path.exists(os.path.join(aot_dir(ckpt), MANIFEST_NAME)):
        fail("phase 10's export --aot wrote no sidecar next to the "
             "checkpoint")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeprest_tpu_torch.benchmarks.fleet_bench",
         "--cold-start", ckpt], cwd=REPO, env=dict(os.environ,
                                                   PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"fleet_bench --cold-start exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    stages, aot = cold["cold_start"], cold["aot"]
    rest = wall - sum(v for k, v in stages.items()
                      if k not in ("warm_eager", "warm_capture"))
    print(f"main fleet cold start with the sidecar: process {wall:.2f} s = "
          f"interpreter and imports {rest:.2f} s + "
          + ", ".join(f"{k} {v:.4f} s" for k, v in stages.items())
          + f"; graphs {cold['graphs']}; load_aot loaded {aot['loaded']}, "
          f"compile_fallbacks {aot['compile_fallbacks']}, reason "
          f"{aot['last_reason']!r}", flush=True)
    if aot["loaded"] != 0 or cold["graphs"] != 18 or \
            not aot["last_reason"].startswith("manifest verified"):
        fail(f"the sidecar export --aot wrote did not verify (or something "
             f"was labelled loaded) on the card that wrote it: {cold}")
    return {"wall_s": wall, **cold}


def phase_fleet(cuda_gru, flagship: dict, wd: str) -> dict:
    """The fleet tier on phase 5's flagship checkpoint: M tenants (the
    checkpoint and scaled copies, x(1 + 0.01 i)) behind one plane's 18
    graphs with budget 16 (fleet_bench's ledger, churn and isolation arms
    on phase 8's request mix), 4 tenants held bit for bit against their
    standalone predictors, the checkpoint's day against the host loop over
    the plain recurrence, the pool over HTTP, and a template cold start
    with and without the AOT sidecar (run after phase 10, whose ``export
    --aot`` writes it)."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.benchmarks import fleet_bench
    from deeprest_tpu_torch.serve.fleet import PredictorPool
    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.train.checkpoint import (
        load_sidecar, save_checkpoint,
    )

    t_phase = time.perf_counter()
    ckpt, traffic, delta, ref = (flagship["ckpt"], flagship["traffic"],
                                 flagship["delta"], flagship["ref"])
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    first = Predictor.from_checkpoint(ckpt, device="cuda")
    base = {k: v.detach().clone() for k, v in first.params.items()}
    per_tenant = sum(t.numel() * t.element_size()
                     for t in first.bound_state().values())
    m = fleet_tenants(per_tenant)

    def make(i: int):
        if i == 0:
            return first if first is not None else Predictor.from_checkpoint(
                ckpt, device="cuda")
        scale = float(np.float32(1.0 + 0.01 * i))
        return Predictor(
            {k: v * scale for k, v in base.items()}, first_cfg, x_stats,
            y_stats, names, W, delta_mask=delta, device="cuda")

    first_cfg, x_stats, y_stats, names = (first.model_config, first.x_stats,
                                          first.y_stats, first.metric_names)
    rng = np.random.default_rng(SEED)
    mix, bodies = [], []
    for minutes in PLANE_REQUEST_MINUTES:     # phase 8's request mix
        lo = int(rng.integers(0, DAY - minutes))
        mix.append(traffic[lo:lo + minutes])
        bodies.append(json.dumps({"traffic": mix[-1].tolist()}).encode())

    for k in cuda_gru.KERNELS:
        k.launches = 0
    pool = PredictorPool(hbm_budget=FLEET_BUDGET, aot=False)
    ledger = fleet_bench.measure_ledger(pool, make, m, mix[-1], "cuda")
    first = None                               # the pool's app000 now
    t0 = time.perf_counter()
    answers = {}
    for i in range(m):
        pred = pool.resolve(fleet_bench._name(i)).predictor()
        answers[i] = [pred.predict_series(s) for s in mix]
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    frozen = pool.assert_frozen()
    graphs = pool.resolve("app000").predictor().plane.graphs.stats()
    print(f"main fleet ledger: {m} tenants admitted in "
          f"{ledger['admit_ms_per_app']:.3f} ms each (construct + admit; the "
          f"pool's admit alone median {ledger['pool_admit_ms_median']:.3f} "
          f"ms, the first, which makes the plane, "
          f"{ledger['pool_admit_ms_first']:.3f} ms); graphs "
          f"{ledger['captures']} captured at warm-up "
          f"({graphs['seconds']['eager']:.3f} s eager first calls, "
          f"{graphs['seconds']['capture']:.3f} s captures), "
          f"{ledger['captures_after_warmup']} after, plane count {frozen} "
          f"frozen; bound slot {ledger['slot_bytes']} bytes; spilled "
          f"{ledger['spilled']} ({ledger['spill_host_bytes']} pinned bytes); "
          f"pinned bytes in use {ledger['pinned_bytes_before']} -> "
          f"{ledger['pinned_bytes_after']}, beyond the spills per tenant "
          f"{ledger['pinned_beyond_spill_per_app']}; every tenant on phase "
          f"8's mix ({len(mix) * m} requests) in {mix_s:.2f} s", flush=True)
    if ledger["captures"] != 18 or ledger["captures_after_warmup"] or \
            frozen != 18 or not ledger["ok"]:
        fail(f"fleet ledger: {ledger}")
    # the checkpoint's day through the pool against phase 5's host loop
    day = pool.resolve("app000").predictor().predict_series(traffic)
    errs = {name: rel_err(day, ref, cols)
            for cols, name in ((~delta, "non-delta"), (delta, "delta"))}
    print(f"check fleet app000 (phase 5's checkpoint) day through the pool "
          f"vs host loop over the plain recurrence: max_err/max|ref| {errs} "
          f"(tol {TOL['bfloat16'][0]})", flush=True)
    if max(errs.values()) > TOL["bfloat16"][0]:
        fail("the pool's day disagrees with the plain path")
    churn = fleet_bench.measure_churn(pool, m, mix[-1], False, "cuda")
    print(f"main fleet churn: {churn['requests']} random accesses over {m} "
          f"tenants: spills {churn['spills']}, restores {churn['restores']}; "
          f"bind ms median {churn['bind_ms_median']:.4f} p99 "
          f"{churn['bind_ms_p99']:.4f} (CUDA events), spill ms median "
          f"{churn['spill_ms_median']:.3f} p99 {churn['spill_ms_p99']:.3f}, "
          f"restore ms median {churn['restore_copy_ms_median']:.3f} p99 "
          f"{churn['restore_copy_ms_p99']:.3f} (host clock, copies landed); "
          f"request ms p50 {churn['request_ms_median']:.3f} p99 "
          f"{churn['request_ms_p99']:.3f} = {churn['p99_over_median']:.2f}x "
          f"(gate {fleet_bench.P99_FACTOR}x); post-storm bit-exact "
          f"{churn['post_storm_bit_exact']}; device bytes allocated "
          f"{churn['device_bytes_before']} -> {churn['device_bytes_after']} "
          f"({(churn['device_bytes_after'] - mem0) / per_tenant:.2f} "
          f"tenants' bytes above the phase's start, {FLEET_BUDGET} resident "
          f"+ the slot + the copy of app000's weights + the graphs' pool)",
          flush=True)
    if not churn["ok"] or abs(churn["device_bytes_after"]
                              - churn["device_bytes_before"]) > per_tenant:
        fail(f"fleet churn: {churn}")
    isolation = fleet_bench.measure_isolation(pool, make, mix[-1], m)
    print(f"check fleet isolation: {json.dumps(isolation)}", flush=True)
    if not isolation["ok"]:
        fail(f"fleet isolation: {isolation}")
    torch.cuda.synchronize()
    launches = cuda_gru.GRU_FWD.launches
    trains = cuda_gru.GRU_FWD_TRAIN.launches + cuda_gru.GRU_BWD.launches
    print(f"main fleet in-process gru_fwd launches {launches}", flush=True)
    if launches == 0 or trains:
        fail(f"fleet launches gru_fwd {launches}, training kernels {trains}")

    # 4 tenants, 2 resident and 2 spilled, against their own standalone
    # predictors on their own graphs (the check against baked addresses)
    # (the isolation arm reloaded app001 with other weights)
    resident = [i for i in range(m - 1, 1, -1)
                if pool.peek(fleet_bench._name(i)).resident][:2]
    spilled = [i for i in range(2, m)
               if not pool.peek(fleet_bench._name(i)).resident][:2]
    want = {}
    for i in resident + spilled:
        was = pool.peek(fleet_bench._name(i)).resident
        got = [pool.resolve(fleet_bench._name(i)).predictor()
               .predict_series(s) for s in mix + [traffic]]
        alone = make(i)
        alone.warm()
        ref_i = [alone.predict_series(s) for s in mix + [traffic]]
        same = all(np.array_equal(a, b) for a, b in zip(got, ref_i))
        print(f"check fleet app{i:03d} ({'resident' if was else 'spilled'}): "
              f"the pool's answers to the mix and the day bit for bit its "
              f"standalone predictor's on its own {alone.jit_cache_size()} "
              f"graphs: {same}", flush=True)
        if not same:
            fail(f"fleet tenant {i} differs from its standalone predictor")
        del alone
        free_device()
    # the HTTP plane: phase 5's checkpoint and two copies scaled as app002
    # and app003, written with the port's writer
    extra = load_sidecar(ckpt, 0)
    for name, i in (("blue", 2), ("green", 3)):
        path = os.path.join(wd, f"fleet_{name}")
        scale = float(np.float32(1.0 + 0.01 * i))
        save_checkpoint(path, {k: (v * scale).cpu() for k, v in base.items()},
                        step=0, extra=extra)
        want[name] = (path, [pool.resolve(fleet_bench._name(i)).predictor()
                             .predict_series(s) for s in mix])
    want["default"] = (ckpt, [pool.resolve("app000").predictor()
                              .predict_series(s) for s in mix])
    del pool, base
    free_device()
    server_launches = fleet_http(ckpt, bodies, want, wd)
    aot = fleet_aot(ckpt)
    total = time.perf_counter() - t_phase
    print(f"fleet phase: {total:.1f} s of wall time; gru_fwd launches "
          f"in-process {launches}, the fleet server {server_launches}",
          flush=True)
    return {"launches": launches + server_launches, "tenants": m,
            "ledger": ledger, "churn": churn, "isolation": isolation,
            "aot": aot, "total_s": total}


TENK_F, TENK_K = 10240, 64          # bench.py:37-39, tenk_bench.py:44-46
TENK_SCALES = 16                    # one-day series of the serving check
# 10 steps of B=32 in an epoch: int((1,440 - 60) x 0.2320) = 320 windows
TENK_SPLIT_10_STEPS = 0.2320


def tenk_corpus(path: str) -> str:
    """One seeded day at the 10k-endpoint width: 1,440 x 10,240 hashed
    call-path counts, each row 4 to 31 nonzero columns of counts 1-199
    (``benchmarks/tenk_bench.py::_synthetic_sparse_rows``), and 40 resource
    series as :func:`flagship_corpus` makes them.  Written with the port's
    FeaturizedData and a hashed CallPathSpace; returns the file's path."""
    import numpy as np

    from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData

    rng = np.random.default_rng(SEED)
    traffic = np.zeros((DAY, TENK_F), np.float32)
    for row in traffic:
        n = int(rng.integers(4, TENK_K // 2))
        cols = rng.choice(TENK_F, size=n, replace=False)
        row[cols] = rng.integers(1, 200, size=n)
    resources = {}
    for i in range(TRAIN["E"]):
        res = RESOURCES[i % len(RESOURCES)]
        w = rng.uniform(0.0, 1.0, TENK_F) * (rng.random(TENK_F) < 0.2)
        level = traffic @ w
        level = level + rng.normal(0.0, 0.05 * level.std(), DAY)
        if res == "usage":
            level = np.cumsum(np.abs(level)) / DAY
        resources[f"comp{i // len(RESOURCES)}_{res}"] = level.astype(
            np.float32)
    space = {"config": {"capacity": TENK_F, "round_to": 128,
                        "hash_features": True, "hash_seed": 0x5EED},
             "vocabulary": [], "frozen_capacity": TENK_F}
    return FeaturizedData(traffic=traffic, resources=resources,
                          invocations={},
                          space=CallPathSpace.from_dict(space)).save(path)


def tenk_training(cuda_gru, data) -> dict:
    """10 captured steps a feed, two epochs, sparse against dense from
    the same seeded params (dropout 0): per-step losses must be equal, as
    the densify is bit-exact.  Returns steady-state steps/s per feed."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    params = None
    out = {}
    for feed in ("sparse", "dense"):
        cfg = Config(
            model=ModelConfig(hidden_size=TRAIN["H"], dropout_rate=0.0,
                              compute_dtype="bfloat16"),
            train=TrainConfig(batch_size=TRAIN["B"], window_size=W,
                              train_split=TENK_SPLIT_10_STEPS,
                              steps_per_superstep=10,
                              sparse_feed=feed == "sparse",
                              sparse_nnz_cap=TENK_K))
        bundle = prepare_dataset(data, cfg.train)
        trainer = Trainer(cfg, TENK_F, bundle.metric_names, device="cuda")
        if params is None:
            params = init_params(trainer.model_config, seed=SEED)
        staged = trainer.stage_dataset(bundle)
        staged_bytes = (sum(t.numel() * t.element_size() for t in (
            staged[0].cols, staged[0].vals)) if feed == "sparse"
            else staged[0].numel() * staged[0].element_size())
        state = trainer.init_state(params)
        rng = np.random.default_rng(SEED)
        losses = []
        for _ in range(2):
            state, _ = trainer.train_epoch(state, bundle, rng, staged)
            losses.append(trainer.last_epoch_losses)
        out[feed] = {"losses": np.concatenate(losses),
                     "steps_per_s": trainer.throughput.steps_per_sec,
                     "captures": trainer.captures,
                     "replays": trainer.replays,
                     "staged_x_bytes": staged_bytes}
        if feed == "sparse":
            out[feed]["busy_pct"] = profile_train_steps(
                "tenk train sparse feed, one epoch of 10 replays",
                lambda: trainer.train_epoch(state, bundle, rng, staged), 10)
        print(f"tenk train {feed} feed: {len(out[feed]['losses'])} steps "
              f"(S=10, {trainer.captures} capture, {trainer.replays} "
              f"replays), steady-state {out[feed]['steps_per_s']:.2f} "
              f"steps/s, staged traffic {staged_bytes} bytes", flush=True)
        del state, staged, trainer, bundle
        free_device()
    a, b = out["sparse"]["losses"], out["dense"]["losses"]
    print(f"check tenk train sparse vs dense feed: per-step losses equal "
          f"{np.array_equal(a, b)} (max |diff| "
          f"{float(np.abs(a - b).max()):.3e}); first {a[:3].tolist()}",
          flush=True)
    if not np.isfinite(a).all() or not np.array_equal(a, b):
        fail("the sparse feed's training losses differ from the dense "
             "feed's")
    return {k: {kk: vv for kk, vv in v.items() if kk != "losses"}
            for k, v in out.items()}


def free_device() -> None:
    """Drop unreachable predictors (their engines and graphs refer back to
    them) and hand their memory, graph pools included, back to the
    card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def timed_many(call, args) -> float:
    """Seconds of one call, the device drained after it."""
    import torch

    t0 = time.perf_counter()
    call(args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def tenk_serving(cuda_gru, ckpt: str, traffic) -> dict:
    """The 16-series call (384 windows) at F=10240 through the sparse
    entry of a sparse-feed predictor and the dense entry of a dense one:
    bit-identical; windows/s in turns, host-to-device bytes a page, the
    device busy share; the day against the host loop over the plain
    recurrence."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.ops.densify import sparsify_rows
    from deeprest_tpu_torch.serve.fused import plan_windows
    from deeprest_tpu_torch.serve.predictor import (
        Predictor, rolled_prediction_reference,
    )

    sp = Predictor.from_checkpoint(ckpt, sparse_feed=True,
                                   sparse_nnz_cap=TENK_K, device="cuda")
    t0 = time.perf_counter()
    warm = sp.warm()
    warm_s = time.perf_counter() - t0
    sparse_graphs = sp.graphs.size("sparse")
    dp = Predictor.from_checkpoint(ckpt, device="cuda")
    dp.warm()
    scales = np.linspace(0.5, 2.0, TENK_SCALES).astype(np.float32)
    scales[0] = 1.0
    series = [traffic * s for s in scales]
    coo = [sparsify_rows(x, TENK_K)[:2] for x in series]
    n_windows = len(plan_windows([len(x) for x in series], W))
    runs = {"sparse": [], "dense": []}
    got = want = None
    for entry in ("sparse", "dense", "dense", "sparse"):
        if entry == "sparse":
            t = timed_many(lambda c: sp.predict_series_many_sparse(c), coo)
            got = sp.predict_series_many_sparse(coo)
        else:
            t = timed_many(lambda x: dp.predict_series_many(x), series)
            want = dp.predict_series_many(series)
        runs[entry].append(n_windows / t)
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    page = sp.fused.rungs[-1]
    h2d = {"sparse": page * W * TENK_K * 8, "dense": page * W * TENK_F * 4}
    print(f"tenk serve: {TENK_SCALES} one-day series, {n_windows} windows; "
          f"windows/s in turns sparse {runs['sparse'][0]:.1f}, dense "
          f"{runs['dense'][0]:.1f}, dense {runs['dense'][1]:.1f}, sparse "
          f"{runs['sparse'][1]:.1f}; host-to-device bytes a {page}-window "
          f"page: sparse {h2d['sparse']}, dense {h2d['dense']} "
          f"({h2d['dense'] / h2d['sparse']:.1f}x)", flush=True)
    print(f"check tenk serve sparse entry vs dense entry: bit-identical "
          f"{same}; sparse graphs captured at warm-up {sparse_graphs} "
          f"({warm['captures']} in all, {warm_s:.2f} s), after "
          f"{sp.jit_cache_stats()['captures_after_warmup']}; fused stats "
          f"sparse_pages {sp.fused.stats()['sparse_pages']}", flush=True)
    if not same:
        fail("sparse served predictions differ from the dense ones")
    if not sparse_graphs or sp.jit_cache_stats()["captures_after_warmup"]:
        fail("the sparse programs were not all captured at warm-up")
    busy = {}
    for entry, call, arg in (("sparse", sp.predict_series_many_sparse, coo),
                             ("dense", dp.predict_series_many, series)):
        prof = profile_what_if(None, arg, call=call, label=f"tenk {entry}")
        busy[entry] = (None if prof is None
                       else round(100 * prof[1] / prof[0], 1))
    model = dp.model

    def plain_apply(x):
        with torch.inference_mode():
            return model(torch.from_numpy(x).cuda(),
                         recurrence=cuda_gru.gru_recurrence_reference
                         ).cpu().numpy()

    delta = dp.delta_mask
    ref = rolled_prediction_reference(
        plain_apply, dp.x_stats, dp.y_stats, W, traffic, delta_mask=delta,
        median_index=dp.median_index())
    errs = {}
    for cols, name in ((~delta, "non-delta"), (delta, "delta")):
        diff = np.abs(got[0][:, cols] - ref[:, cols]).max()
        errs[name] = float(diff / np.abs(ref[:, cols]).max())
    print(f"check tenk serve day vs host loop over the plain recurrence: "
          f"max_err/max|ref| {errs} (tol {TOL['bfloat16'][0]})", flush=True)
    if max(errs.values()) > TOL["bfloat16"][0] or not np.isfinite(
            got[0]).all():
        fail("the 10k sparse day disagrees with the host loop")
    one_hour = sp.predict_series(traffic[:W])
    return {"sparse_windows_per_s": runs["sparse"],
            "dense_windows_per_s": runs["dense"], "h2d_page_bytes": h2d,
            "busy_pct": busy, "sparse_graphs": sparse_graphs,
            "ref_err": errs, "one_hour": one_hour}


def quant_checks(cuda_gru, ckpt: str, label: str, day) -> dict:
    """int8 and bf16 from ``ckpt``: the envelope file written at the
    first load and re-read and re-gated at a second; weight bytes against
    "off"; the day's served deviation from "off" next to the budget."""
    import numpy as np

    from deeprest_tpu_torch.ops import quantize as quant_ops
    from deeprest_tpu_torch.serve.predictor import Predictor

    off = Predictor.from_checkpoint(ckpt, device="cuda")
    base = off.predict_series(day)
    out = {"off_bytes": quant_ops.weight_bytes(off.params)}
    y_rg = np.maximum(np.asarray(off.y_stats.range, np.float32).reshape(
        1, -1, 1), 1e-12)
    delta = off.delta_mask
    del off
    free_device()
    for mode in ("int8", "bf16"):
        path = Predictor._quant_envelope_path(ckpt, mode)
        first = Predictor.from_checkpoint(ckpt, quant=mode, device="cuda")
        written = os.path.exists(path)
        second = Predictor.from_checkpoint(ckpt, quant=mode, device="cuda")
        with open(path, encoding="utf-8") as fh:
            stored = json.load(fh)
        env = second.parity_envelope
        worst = max(env["measured"].values())
        cap = max(stored["budget"].values())
        rel = np.abs(second.predict_series(day) - base) / y_rg
        dev = {"non-delta": float(rel[:, ~delta].max()),
               "delta": float(rel[:, delta].max())}
        wb = quant_ops.weight_bytes(second.params)
        print(f"check quant {label} {mode}: envelope file written "
              f"{written}, re-gated on a second load (budget equal "
              f"{env['budget'] == stored['budget']}); probe max |quant - "
              f"f32| {worst:.3e} within budget max {cap:.3e}; served day "
              f"max deviation from off, of each metric's y range, "
              f"{ {k: float(f'{v:.3e}') for k, v in dev.items()} } (delta "
              "columns integrate a day of increments); "
              f"weight bytes {wb} vs off {out['off_bytes']} "
              f"({out['off_bytes'] / wb:.2f}x fewer)", flush=True)
        if not written or env["budget"] != stored["budget"] or \
                quant_ops.check_envelope(env["measured"], stored["budget"]):
            fail(f"{label} {mode}: the envelope was not written, re-read "
                 "and met")
        if not np.isfinite(list(dev.values())).all():
            fail(f"{label} {mode}: non-finite quantized predictions")
        out[mode] = {"probe_max": worst, "budget_max": cap,
                     "day_dev": dev, "weight_bytes": wb}
        del first, second
        free_device()
    return out


def tightened_envelope_raises(ckpt: str) -> None:
    """A hand-tightened stored budget (a quarter of each measured cell)
    must make the next int8 load raise QuantParityError."""
    from deeprest_tpu_torch.ops.quantize import QuantParityError
    from deeprest_tpu_torch.serve.predictor import Predictor

    path = Predictor._quant_envelope_path(ckpt, "int8")
    with open(path, encoding="utf-8") as fh:
        original = fh.read()
    env = json.loads(original)
    env["budget"] = {k: v / 4 for k, v in env["measured"].items()}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(env, fh)
    try:
        Predictor.from_checkpoint(ckpt, quant="int8", device="cuda")
    except QuantParityError as exc:
        print(f"check quant tightened envelope: QuantParityError "
              f"({str(exc)[:120]}...)", flush=True)
    else:
        fail("a hand-tightened envelope did not raise QuantParityError")
    finally:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(original)


def phase_tenk(cuda_gru, flagship: dict, workdir: str) -> dict:
    """The 10k-endpoint sparse feed, quantized and exported serving:
    `train --sparse-feed` at F=10240, sparse against dense training and
    serving, int8 and bf16 on the flagship and 10k checkpoints, `export`
    then `serve --artifact`, and one 10k request through `serve
    --sparse-feed`."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.serve.export import GRU_OP, graph_ops
    from deeprest_tpu_torch.serve.fused import plan_windows
    from deeprest_tpu_torch.serve.predictor import Predictor

    wd = os.path.join(workdir, "tenk")
    os.makedirs(wd, exist_ok=True)
    t0 = time.perf_counter()
    feats = tenk_corpus(os.path.join(wd, "tenk.npz"))
    data = FeaturizedData.load(feats)
    print(f"tenk corpus: {DAY} x {TENK_F}, "
          f"{int((data.traffic != 0).sum(1).max())} nonzero columns in the "
          f"fullest row, written in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for k in cuda_gru.KERNELS:
        k.launches = 0
    # export the flagship checkpoint, with the fleet's AOT sidecar next to
    # it (phase 13 admits it), while the 10k training runs
    art = os.path.join(wd, "artifact")
    export = CliRun(["export", "--ckpt-dir", flagship["ckpt"], "--out", art,
                     "--aot"], timeout=600)
    ckpt = os.path.join(wd, "ckpt")
    t0 = time.perf_counter()
    report = run_cli(["train", "--features", feats, "--epochs", 2,
                      "--compute-dtype", "bfloat16", "--sparse-feed",
                      "--sparse-nnz-cap", TENK_K, "--no-baselines",
                      "--ckpt-dir", ckpt], timeout=900)
    cli_s = time.perf_counter() - t0
    kl = report["kernel_launches"]
    steps = report["steps"]
    print(f"tenk train CLI --sparse-feed: {steps} steps in {cli_s:.2f} s "
          f"(process start, load, stage, fit), epoch losses "
          f"{report['epoch_losses']}, {report['steps_per_sec']:.2f} "
          f"steps/s, captures {report['captures']}, replays "
          f"{report['replays']}, launches {kl}", flush=True)
    losses = [v for epoch in report["step_losses"] for v in epoch]
    if not np.isfinite(losses).all() or not losses:
        fail("10k sparse-feed training gave non-finite losses")
    if kl["gru_fwd_train"] != 2 * steps or kl["gru_bwd"] != 2 * steps:
        fail(f"10k training launched K2 {kl['gru_fwd_train']} and K3 "
             f"{kl['gru_bwd']} times for {steps} steps (want 2 each a step)")
    train = tenk_training(cuda_gru, data)
    serve = tenk_serving(cuda_gru, ckpt, data.traffic)
    free_device()

    # the export's servers start while the quantized checks run
    exported = export.json()
    print(f"main export --aot: sidecar {json.dumps(exported['aot'])} "
          f"({export.seconds:.2f} s, beside the 10k training)", flush=True)
    program = torch.export.load(os.path.join(art, "model.pt2"))
    ops = graph_ops(program)
    plain_ops = sorted({o for o in ops if o.startswith(
        ("aten.sigmoid", "aten.tanh"))})
    print(f"check export graph: {ops.count(GRU_OP)} {GRU_OP} nodes of "
          f"{len(ops)} calls; plain-recurrence ops {plain_ops}", flush=True)
    if ops.count(GRU_OP) != 2 or plain_ops:
        fail("the exported program does not run the recurrence through "
             "the gru_fwd operator alone")
    logs = {name: os.path.join(wd, f"serve_{name}.log")
            for name in ("artifact", "tenk")}
    args = {"artifact": ["--artifact", art, "--no-batcher"],
            "tenk": ["--ckpt-dir", ckpt, "--sparse-feed", "--sparse-nnz-cap",
                     TENK_K, "--no-batcher"]}
    procs = {}
    try:
        for name in args:
            procs[name] = spawn_server(args[name], logs[name])
        feats512 = os.path.join(wd, "flagship.npz")
        np.savez(feats512, traffic=flagship["traffic"])
        cli = run_cli(["predict", "--ckpt-dir", flagship["ckpt"],
                       "--features", feats512, "--quant", "int8", "--out",
                       os.path.join(wd, "int8.npz")], timeout=600)
        quant = {"flagship": quant_checks(cuda_gru, flagship["ckpt"],
                                          "flagship", flagship["traffic"]),
                 "tenk": quant_checks(cuda_gru, ckpt, "tenk",
                                      data.traffic)}
        tightened_envelope_raises(flagship["ckpt"])
        free_device()
        http = {}
        for name in args:
            _, startup = wait_listening(procs[name], args[name], logs[name])
            http[name] = startup
        day = flagship["traffic"]
        inproc = Predictor.from_checkpoint(flagship["ckpt"], device="cuda")
        want = inproc.predict_series(day)
        status, body = http_json(http["artifact"]["listening"]
                                 + "/v1/predict", {"traffic": day.tolist()})
        got = np.asarray(body.get("predictions"), np.float32)
        _, health = http_json(http["artifact"]["listening"] + "/healthz")
        art_k1 = health["kernel_launches"]["gru_fwd"]
        print(f"check serve --artifact: /v1/predict on the day status "
              f"{status}, bit-identical to the in-process predictor "
              f"{np.array_equal(got, want)}; /healthz gru_fwd launches "
              f"{art_k1}, graphs {health['jit_cache']}", flush=True)
        if status != 200 or not np.array_equal(got, want) or art_k1 <= 0:
            fail("the exported artifact over HTTP differs from the "
                 "in-process predictor or launched no K1")
        hour = data.traffic[:W]
        status, body = http_json(http["tenk"]["listening"] + "/v1/predict",
                                 {"traffic": hour.tolist()})
        got = np.asarray(body.get("predictions"), np.float32)
        _, health = http_json(http["tenk"]["listening"] + "/healthz")
        tenk_k1 = health["kernel_launches"]["gru_fwd"]
        same = np.array_equal(got, serve["one_hour"])
        print(f"check serve --sparse-feed at F={TENK_F}: /v1/predict of "
              f"{W} x {TENK_F} status {status}, equal to the in-process "
              f"sparse answer {same}; sparse pages "
              f"{health['fused_infer']['sparse_pages']}, captures after "
              f"warm-up {health['jit_cache']['captures_after_warmup']}, "
              f"gru_fwd launches {tenk_k1}; startup seconds "
              f"{http['tenk']['seconds']}", flush=True)
        if status != 200 or not same or not health["fused_infer"][
                "sparse_pages"] or health["jit_cache"][
                    "captures_after_warmup"]:
            fail("the 10k sparse server's answer differs from the "
                 "in-process one or left the sparse path")
    finally:
        for proc in procs.values():
            stop_server(proc)
    del inproc
    free_device()
    # windows/s of the flagship 16-series call per quant mode, in turns
    scales = np.linspace(0.5, 2.0, 16).astype(np.float32)
    scales[0] = 1.0
    series = [flagship["traffic"] * s for s in scales]
    n_windows = len(plan_windows([len(x) for x in series], W))
    preds = {m: Predictor.from_checkpoint(flagship["ckpt"], quant=m,
                                          device="cuda")
             for m in ("off", "int8", "bf16")}
    rates = {m: [] for m in preds}
    for p in preds.values():
        p.warm()
    for m in ("off", "int8", "bf16", "bf16", "int8", "off"):
        rates[m].append(n_windows / timed_many(
            preds[m].predict_series_many, series))
    print(f"quant flagship 16-series windows/s in turns: "
          f"{ {m: [round(r, 1) for r in v] for m, v in rates.items()} }",
          flush=True)
    launches = {k.name: k.launches for k in cuda_gru.MODEL_KERNELS}
    for name in launches:
        launches[name] += kl[name] + cli["kernel_launches"][name]
    launches["gru_fwd"] += art_k1 + tenk_k1
    print(f"tenk phase launches: {launches} (in-process, CLIs, servers)",
          flush=True)
    return {"launches": launches, "train": train,
            "cli_steps_per_s": report["steps_per_sec"],
            "serve": {k: v for k, v in serve.items() if k != "one_hour"},
            "quant": quant, "quant_windows_per_s": rates}


def at_dtype(pred, dtype: str, **kwargs):
    """``pred``'s params and host state served at compute dtype
    ``dtype`` on the card."""
    import dataclasses

    from deeprest_tpu_torch.serve.predictor import Predictor

    return Predictor(
        pred.model.params(),
        dataclasses.replace(pred.model_config, compute_dtype=dtype),
        pred.x_stats, pred.y_stats, pred.metric_names, pred.window_size,
        space_dict=pred.space_dict, delta_mask=pred.delta_mask,
        device="cuda", **kwargs)


def phase_blocked(cuda_gru, kernel_tuning) -> dict:
    """K4 at every blocking of the sweep's --quick menu against its plain
    version, then its times at the fused flagship stacking in bf16; returns
    the kernels-line numbers."""
    import torch

    worst = 0.0
    checked = refused = 0
    for label, shape in (("fused flagship", FUSED), ("ragged", TUNE_RAGGED)):
        e, t, b, h = (shape[k] for k in ("E", "T", "B", "H"))
        for dtype in (torch.float32, torch.bfloat16):
            args = recurrence_inputs(shape, dtype, seed=SEED + 3)
            for bf16_dot in (False, True):
                name = "bfloat16" if bf16_dot else "float32"
                want = cuda_gru.gru_fwd_blocked_reference(*args,
                                                          bf16_dot=bf16_dot)
                for rows, e_blk, t_blk in kernel_tuning.blocking_menu(
                        e, t, b, h, quick=True):
                    what = (f"E{e} rows{rows} e_blk{e_blk} t_blk{t_blk} "
                            f"{str(dtype).removeprefix('torch.')} "
                            f"{'bf16' if bf16_dot else 'f32'} dot")
                    plan = cuda_gru.block_plan(
                        e, t, b, h, dtype, training=False, rows=rows,
                        e_blk=e_blk, t_blk=t_blk, blocked=True,
                        bf16_dot=bf16_dot)
                    if not plan["fits"]:
                        refused += 1
                        print(f"check gru_fwd_blocked {label} {what}: refused "
                              f"by the plan ({plan['refusal']})", flush=True)
                        continue
                    got = cuda_gru.gru_fwd_blocked_cuda(
                        *args, e_blk=e_blk, t_blk=t_blk, bf16_dot=bf16_dot,
                        rows=rows)
                    torch.cuda.synchronize()
                    mx = report_check("gru_fwd_blocked", label, shape, name,
                                      what, compare(got, want, name),
                                      TOL[name])
                    checked += 1
                    if label == "fused flagship" and dtype == torch.bfloat16 \
                            and bf16_dot:
                        worst = max(worst, mx)
            del args, want
    if not checked:
        fail("the plan admitted no blocking of the --quick menu")
    print(f"check gru_fwd_blocked: {checked} blockings held against the plain "
          f"version, {refused} refused by the plan", flush=True)

    # times at the fused stacking, bf16 inputs and the bf16 dot
    args = recurrence_inputs(FUSED, torch.bfloat16)
    proj, w_hh, b_hh, h0 = args
    e, t, b, h = (FUSED[k] for k in ("E", "T", "B", "H"))
    times, plans = {}, {}
    for rows, e_blk, t_blk in kernel_tuning.blocking_menu(e, t, b, h,
                                                          quick=True):
        plan = cuda_gru.block_plan(e, t, b, h, torch.bfloat16, training=False,
                                   rows=rows, e_blk=e_blk, t_blk=t_blk,
                                   blocked=True, bf16_dot=True)
        if plan["fits"]:
            plans[(rows, e_blk, t_blk)] = plan
            times[(rows, e_blk, t_blk)] = time_ms(
                lambda r=rows, eb=e_blk, tb=t_blk:
                cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=eb, t_blk=tb,
                                              bf16_dot=True, rows=r),
                iters=20)
    for key, ms in times.items():
        plan = plans[key]
        print(f"times gru_fwd_blocked {FUSED} bf16 rows{key[0]} "
              f"e_blk{key[1]} t_blk{key[2]}: {ms:.4f} ms ({plan['ctas']} "
              f"CTAs, {plan['ctas_per_sm']} per SM, {plan['waves']} waves, "
              f"{plan['smem_bytes']} bytes)", flush=True)
    k1_blocking = (cuda_gru.ROW_TILE, 1, 1)
    if k1_blocking not in times:
        fail("K1's blocking (16 rows, 1 expert, 1 step) was not timed")
    if (plans[k1_blocking]["ctas_per_sm"], plans[k1_blocking]["waves"]) \
            != (2, 1):
        fail(f"K1's blocking is not planned at two CTAs an SM in one wave: "
             f"{plans[k1_blocking]}")
    if not any(e_blk == 2 for _, e_blk, _ in times):
        fail("no two-expert blocking (e_blk=2) was admitted and timed")
    fastest = min(times, key=times.get)
    lib_ms, lib_out = cudnn_gru_ms(*args)
    if lib_ms is None:
        print(f"library bfloat16 x{e}: {lib_out}", flush=True)
    out_bytes = e * t * b * h * 4                  # the f32 output
    entry = kernel_times(
        "gru_fwd_blocked", f"cuDNN GRU forward x{e}", "bfloat16", FUSED,
        lambda: cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=1, t_blk=1,
                                              bf16_dot=True,
                                              rows=cuda_gru.ROW_TILE),
        lambda: cuda_gru.gru_fwd_blocked_reference(*args, bf16_dot=True),
        nbytes(*args) + out_bytes, 2 * e * t * b * h * 3 * h, lib_ms)
    entry.update(max_abs_err=worst, fastest_ms=times[fastest],
                 fastest_blocking="rows{}_e_blk{}_t_blk{}".format(*fastest),
                 blocking_ms={"rows{}_e_blk{}_t_blk{}".format(*k): ms
                              for k, ms in times.items()})
    del args, proj, w_hh, b_hh, h0, lib_out

    # the f32 dot (3xTF32) on f32 inputs, at the first blocking the plan
    # admits
    args = recurrence_inputs(FUSED, torch.float32)
    rows, e_blk, t_blk = next(
        k for k in kernel_tuning.blocking_menu(e, t, b, h, quick=True)
        if cuda_gru.block_plan(e, t, b, h, torch.float32, training=False,
                               rows=k[0], e_blk=k[1], t_blk=k[2],
                               blocked=True, bf16_dot=False)["fits"])
    lib_ms, _ = cudnn_gru_ms(*args)
    entry["float32"] = kernel_times(
        "gru_fwd_blocked", f"cuDNN GRU forward x{e}", "float32", FUSED,
        lambda: cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=e_blk, t_blk=t_blk,
                                              rows=rows),
        lambda: cuda_gru.gru_fwd_blocked_reference(*args),
        nbytes(*args) + out_bytes, 2 * e * t * b * h * 3 * h, lib_ms)
    entry["float32"]["blocking"] = f"rows{rows}_e_blk{e_blk}_t_blk{t_blk}"
    del args
    torch.cuda.empty_cache()
    return entry


def phase_bidir(cuda_gru, kernel_tuning) -> None:
    """bidirectional_gru with BIDIR_FUSED against without, on the kernels at
    the flagship training shape in bf16: the forward (K1 launches 1 against
    2) and the gradients through K2 and K3 (1 launch each against 2)."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.ops.gru import GRUParams, init_gru_params

    gru_mod = kernel_tuning.gru_mod
    e, t, b, h = (TRAIN[k] for k in ("E", "T", "B", "H"))
    rng = np.random.default_rng(SEED + 4)
    fwd, bwd = (init_gru_params(seed, e, F, h, torch.bfloat16, device="cuda")
                for seed in (SEED + 5, SEED + 6))
    x = torch.from_numpy(rng.standard_normal((b, t, F), np.float32)).to(
        "cuda", torch.bfloat16)
    cot = torch.from_numpy(rng.standard_normal((e, b, t, 2 * h),
                                               np.float32)).cuda()
    results = {}
    default = gru_mod.BIDIR_FUSED
    try:
        for fused in (False, True):
            gru_mod.BIDIR_FUSED = fused
            counts = [kk.launches for kk in cuda_gru.MODEL_KERNELS]
            with torch.no_grad():
                out = gru_mod.bidirectional_gru(fwd, bwd, x)
            torch.cuda.synchronize()
            n_fwd = cuda_gru.GRU_FWD.launches - counts[0]
            leaves = [GRUParams(*[w.clone().requires_grad_(True) for w in p])
                      for p in (fwd, bwd)]
            xg = x.clone().requires_grad_(True)
            counts = [kk.launches for kk in cuda_gru.MODEL_KERNELS]
            y = gru_mod.bidirectional_gru(*leaves, xg)
            (y.float() * cot).sum().backward()
            torch.cuda.synchronize()
            n_train = [kk.launches - c for kk, c in
                       zip(cuda_gru.MODEL_KERNELS[1:], counts[1:])]
            want = (1, [1, 1]) if fused else (2, [2, 2])
            print(f"check bidirectional fused={fused}: gru_fwd launches "
                  f"{n_fwd} per forward, gru_fwd_train/gru_bwd launches "
                  f"{n_train} per fwd+bwd (want {want[0]} and {want[1]})",
                  flush=True)
            if (n_fwd, n_train) != want:
                fail(f"bidirectional_gru fused={fused} made {n_fwd} K1 and "
                     f"{n_train} K2/K3 launches; want {want}")
            grads = [w.grad for p in leaves for w in p] + [xg.grad]
            results[fused] = [out, y.detach()] + grads
    finally:
        gru_mod.BIDIR_FUSED = default
    names = ["forward", "fwd+bwd output"] + [
        f"d{d}_{w}" for d in ("fwd", "bwd")
        for w in ("w_ih", "w_hh", "b_ih", "b_hh")] + ["dx"]
    for name, got, want in zip(names, results[True], results[False]):
        check = (compare(got, want, "bfloat16") if name == "forward"
                 else compare_scaled(got, want, "bfloat16"))
        report_check("bidirectional fused vs unfused", "flagship training",
                     TRAIN, "bfloat16", name, check, TOL["bfloat16"])


def phase_stash_steps(cuda_gru) -> None:
    """5 train steps with STASH_GATES off (K2 writes no gates, K3
    recomputes them) against 5 with it on, from the same params, dropout 0,
    at the flagship width."""
    import numpy as np

    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    b, h = TRAIN["B"], TRAIN["H"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stash_",
                                     dir=os.path.join(REPO, "build")) as wd:
        feats = flagship_corpus(os.path.join(wd, "corpus.npz"))
        cfg = Config(model=ModelConfig(hidden_size=h, dropout_rate=0.0,
                                       compute_dtype="bfloat16"),
                     train=TrainConfig(batch_size=b, window_size=W))
        bundle = prepare_dataset(FeaturizedData.load(feats), cfg.train)
        trainer = Trainer(cfg, F, bundle.metric_names, device="cuda")
        params = init_params(trainer.model_config, SEED)
        batches = list(trainer._batches(bundle.num_train_windows,
                                        np.random.default_rng(SEED)))[:5]
        runs = {}
        default = cuda_gru.STASH_GATES
        try:
            for stash in (True, False):
                cuda_gru.STASH_GATES = stash
                state = trainer.init_state(params)
                staged = trainer.stage_dataset(bundle)
                runs[stash] = [float(trainer.train_step(state, staged, sel,
                                                        wt))
                               for sel, wt in batches]
        finally:
            cuda_gru.STASH_GATES = default
    rel = max(abs(a - p) / abs(p) for a, p in zip(runs[False], runs[True]))
    print(f"check train 5 steps, STASH_GATES off vs on (dropout 0): "
          f"{runs[False]} vs {runs[True]}, max relative difference "
          f"{rel:.3e} (tol 2e-2)", flush=True)
    if not np.isfinite(runs[False]).all() or rel > 2e-2:
        fail("training with the gate stash off disagrees with training "
             "with it on")


def phase_tuning_sweep(cuda_gru) -> dict:
    """The tuning path's entry point, `python -m
    deeprest_tpu_torch.benchmarks.kernel_tuning --quick`, in its own
    process with the launch counts at 0; returns its JSON."""
    for k in cuda_gru.KERNELS:
        k.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tuning_",
                                     dir=os.path.join(REPO, "build")) as wd:
        out = os.path.join(wd, "kernel_tuning.json")
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "deeprest_tpu_torch.benchmarks."
             "kernel_tuning", "--quick", "--out", out], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=600)
        sweep_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"kernel_tuning --quick exited {proc.returncode}:\n"
                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        with open(out, encoding="utf-8") as fh:
            sweep = json.load(fh)
    print(f"tuning sweep JSON: {json.dumps(sweep)}", flush=True)
    launches = sweep["kernel_launches"]
    print(f"main tuning sweep (--quick): {sweep_s:.2f} s of wall time "
          f"(process start and the library load included); launches "
          f"{launches}; bidirectional decision {sweep['bidir_decision']}",
          flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"the tuning sweep never launched {name}")
    for key, value in sweep.items():
        if isinstance(value, float) and not value > 0:
            fail(f"tuning sweep time {key} = {value} is not positive")
    return sweep


# Phase 11: streaming retrain (the stream at the CLI's defaults, wire =
# tailer, the drift->retrain loop, the verdict surface).
STREAM_EVERY = 60          # --refresh-buckets
# the first bucket count a refresh fires at: W + eval_holdout (8) + 2
# windows, and at least --refresh-buckets
STREAM_FIRST = max(STREAM_EVERY, W + 11)
STREAM_SMALL = STREAM_FIRST + STREAM_EVERY       # two refreshes' buckets
DRIFT_CYCLE = 30           # drift_bench's quick cycle (full: 60)
STREAM_TOL = 1e-4          # kernels vs plain refresh, f32
STREAM_RATE_BUCKETS = 30   # buckets each source's ingest rate is timed on


def stream_cli(args: list, log_path: str):
    """``python -m deeprest_tpu_torch stream ARGS`` in its own process,
    stdout piped line by line, stderr to ``log_path``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(log_path, "w", encoding="utf-8") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeprest_tpu_torch", "stream",
             *map(str, args)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=log, text=True, bufsize=1)
    CHILDREN.append(proc)
    return proc


def stream_refreshes(proc, n: int, log_path: str, feed=None,
                     timeout: float = 300.0) -> tuple[list, list]:
    """The first ``n`` refresh lines of a stream process (JSON), with its
    other stdout lines; ``feed(i)`` runs after refresh line ``i``.  The run
    fails if the process exits or times out first."""
    import select

    refreshes, other = [], []
    deadline = time.monotonic() + timeout
    while len(refreshes) < n:
        ready, _, _ = select.select([proc.stdout], [], [],
                                    max(0.0, deadline - time.monotonic()))
        line = proc.stdout.readline() if ready else ""
        if not line:
            proc.kill()
            proc.wait(timeout=60)
            with open(log_path, encoding="utf-8") as log:
                fail(f"stream gave {len(refreshes)} of {n} refreshes "
                     f"(exit {proc.returncode}):\n{''.join(other)[-3000:]}"
                     f"\n{log.read()[-6000:]}")
        if line.startswith('{"refresh"'):
            refreshes.append(json.loads(line))
            if feed is not None:
                feed(len(refreshes))
        else:
            other.append(line)
    return refreshes, other


def print_refreshes(label: str, lines: list) -> None:
    for r in lines:
        s = r["seconds"]
        other = s["finetune"] - s["capture"]
        print(f"stream {label} refresh {r['refresh']} ({r['trigger']}): "
              f"{r['buckets']} buckets, {r['steps']} fine-tune steps, "
              f"{r['captures']} captures; train_loss {r['train_loss']}, "
              f"eval_loss {r['eval_loss']}; seconds: prepare "
              f"{s['prepare']:.4f}, stage {s['stage']:.4f}, capture "
              f"{s['capture']:.4f}, fine-tune epochs less capture "
              f"{other:.4f}, eval {s['eval']:.4f}, checkpoint write "
              f"{s['checkpoint']:.4f}; "
              f"{r['steps'] / max(s['finetune'], 1e-9):.1f} steps/s in the "
              f"fine-tune; ETL stall {r['etl']['stall_s']} s", flush=True)


def stream_config(compute: str, sparse: bool = False, dropout: float = 0.5,
                  history_max: int = 4096, refresh: int = STREAM_EVERY,
                  eval_holdout: int = 8):
    """The stream CLI's defaults as (Config, StreamConfig): capacity 512,
    W=60, B=32, H=128, 2 fine-tune epochs."""
    from deeprest_tpu_torch.config import (
        Config, EtlConfig, ModelConfig, TrainConfig,
    )
    from deeprest_tpu_torch.train.stream import StreamConfig

    cfg = Config(
        model=ModelConfig(feature_dim=F, hidden_size=TRAIN["H"],
                          dropout_rate=dropout, compute_dtype=compute),
        train=TrainConfig(batch_size=TRAIN["B"], window_size=W, seed=SEED,
                          eval_stride=1, eval_max_cycles=eval_holdout,
                          log_every_steps=0, sparse_feed=sparse),
        etl=EtlConfig())
    return cfg, StreamConfig(refresh_buckets=refresh, finetune_epochs=2,
                             history_max=history_max,
                             eval_holdout=eval_holdout, poll_interval_s=0.05)


def streaming_trainer(compute: str, ckpt_dir=None, recurrence=None, **kw):
    from deeprest_tpu_torch.config import FeaturizeConfig
    from deeprest_tpu_torch.train.stream import StreamingTrainer

    cfg, sc = stream_config(compute, **kw)
    return StreamingTrainer(
        cfg, sc, ckpt_dir=ckpt_dir, device="cuda", recurrence=recurrence,
        feature_config=FeaturizeConfig(hash_features=True, capacity=F))


def stream_cli_path(cuda_gru, lines: list, wd: str, after_run1) -> dict:
    """The stream CLI at its defaults (f32) on a growing copy of phase 7's
    corpus: two refreshes, a kill, a resumed run of two more.
    ``after_run1(ckpt_r2)`` runs once refresh 2's checkpoint is copied to
    ``ckpt_r2``, before the second run starts."""
    import shutil
    import threading

    import numpy as np

    from deeprest_tpu_torch.train.checkpoint import (
        latest_step, list_steps, load_sidecar,
    )

    growing = os.path.join(wd, "growing.jsonl")
    ckpt = os.path.join(wd, "ckpt")
    chunks = [lines[:STREAM_FIRST], lines[STREAM_FIRST:STREAM_SMALL],
              lines[STREAM_SMALL:]]
    todo = threading.Semaphore(0)
    writer_done = threading.Event()

    def writer():
        # appends one chunk each time the reader asks for it
        for chunk in chunks:
            todo.acquire()
            with open(growing, "ab") as f:
                f.write(b"".join(chunk))
        writer_done.set()

    threading.Thread(target=writer, daemon=True).start()
    todo.release()                              # chunk 1 before the start
    common = ["--raw", growing, "--ckpt-dir", ckpt, "--capacity", F,
              "--window", W, "--batch-size", TRAIN["B"], "--hidden-size",
              TRAIN["H"], "--compute-dtype", "float32", "--refresh-buckets",
              STREAM_EVERY, "--finetune-epochs", 2, "--poll-interval", 0.1,
              "--max-refreshes", 3]
    log1 = os.path.join(wd, "stream_run1.log")
    t0 = time.perf_counter()
    proc = stream_cli(common, log1)
    run1, _ = stream_refreshes(
        proc, 2, log1, feed=lambda i: i == 1 and todo.release())
    proc.kill()                                  # after refresh 2's line
    proc.wait(timeout=60)
    t_run1 = time.perf_counter() - t0
    step2 = latest_step(ckpt)
    side2 = load_sidecar(ckpt, step2)
    ckpt_r2 = os.path.join(wd, "ckpt_refresh2")
    shutil.copytree(ckpt, ckpt_r2)
    print_refreshes("run 1 (overlapped ETL)", run1)
    after_run1(ckpt_r2)

    log2 = os.path.join(wd, "stream_run2.log")
    t0 = time.perf_counter()
    proc = stream_cli(common + ["--no-etl-overlap"], log2)
    run2, other = stream_refreshes(
        proc, 2, log2, feed=lambda i: i == 1 and todo.release())
    proc.kill()
    proc.wait(timeout=60)
    t_run2 = time.perf_counter() - t0
    if not writer_done.wait(30):
        fail("the stream corpus writer did not finish")
    print_refreshes("run 2 (resumed, serial ETL)", run2)
    resumed = [ln.strip() for ln in other if "resumed from" in ln]
    side3 = load_sidecar(ckpt, min(s for s in list_steps(ckpt)
                                   if s > step2))
    losses = [(r["train_loss"], r["eval_loss"]) for r in run1 + run2]
    print(f"stream CLI: run 1 {t_run1:.1f} s (killed after refresh 2), "
          f"run 2 {t_run2:.1f} s; {resumed}; frozen metrics "
          f"{len(side2['metric_names'])}; ingest watermark at refresh 2 "
          f"{side2['stream_ring_watermark']}, at refresh 3 "
          f"{side3['stream_ring_watermark']}", flush=True)
    if not np.isfinite(np.asarray(losses, np.float64)).all():
        fail(f"the stream's refresh losses are not finite: {losses}")
    if [r["refresh"] for r in run1 + run2] != [1, 2, 3, 4]:
        fail("the resumed stream did not continue at refresh 3")
    if not resumed or "refresh 2," not in resumed[0]:
        fail(f"the second stream run did not resume at refresh 2: {other}")
    if side3["metric_names"] != side2["metric_names"] \
            or len(side2["metric_names"]) != 88:
        fail("the resumed stream changed its frozen metric set")
    wm2 = side2["stream_ring_watermark"]["ingested_total"]
    wm3 = side3["stream_ring_watermark"]["ingested_total"]
    if (wm2, wm3) != (STREAM_SMALL, 2 * STREAM_SMALL):
        fail(f"ingest watermark {wm2} -> {wm3}; want {STREAM_SMALL} -> "
             f"{2 * STREAM_SMALL} (the resumed run re-reads the file)")
    launches = dict.fromkeys((k.name for k in cuda_gru.MODEL_KERNELS), 0)
    for label, run in (("run 1", run1), ("run 2", run2)):
        led = run[-1]["kernel_launches"]
        steps = sum(r["steps"] for r in run)
        print(f"stream CLI {label} launches {led} for {steps} fine-tune "
              f"steps; captures per refresh "
              f"{[r['captures'] for r in run]}", flush=True)
        for name in ("gru_fwd_train", "gru_bwd"):
            if led[name] != 2 * steps:
                fail(f"stream {label}: {name} launched {led[name]} times "
                     f"for {steps} steps; want 2 x steps")
        if led["gru_fwd"] == 0:
            fail(f"stream {label}: the evaluation never launched gru_fwd")
        for k, v in led.items():
            launches[k] += v
    return {"run1": run1, "run2": run2, "ckpt": ckpt, "ckpt_r2": ckpt_r2,
            "growing": growing, "launches": launches,
            "seconds": {"run1": t_run1, "run2": t_run2}}


def stream_in_process(cuda_gru, buckets: list, ckpt_r2: str) -> dict:
    """From the refresh-2 checkpoint (f32, dropout 0): one refresh through
    the kernels against the plain recurrence, device memory over five
    refreshes, one refresh at 360 buckets profiled."""
    import numpy as np
    import torch

    def resumed(recurrence=None, steps_per_superstep=None):
        st = streaming_trainer("float32", ckpt_dir=ckpt_r2, dropout=0.0,
                               recurrence=recurrence, history_max=RAW_BUCKETS)
        st.ckpt_dir = None                  # resume only: no writes here
        if steps_per_superstep is not None:
            import dataclasses

            st.trainer.config = dataclasses.replace(
                st.trainer.config, train=dataclasses.replace(
                    st.trainer.config.train,
                    steps_per_superstep=steps_per_superstep))
        return st

    kern = resumed()
    plain = resumed(cuda_gru.gru_recurrence_reference, steps_per_superstep=1)
    for st in (kern, plain):
        for b in buckets[:STREAM_FIRST + 9]:
            st.ingest(b)
    rk, rp = kern.refresh(), plain.refresh()
    loss_rel = max(abs(rk.train_loss - rp.train_loss) / abs(rp.train_loss),
                   abs(rk.eval_loss - rp.eval_loss) / abs(rp.eval_loss))
    prel, pabs, _ = params_rel_diff(kern.state, plain.state)
    print(f"check stream refresh kernels vs plain recurrence (f32, dropout "
          f"0, from the refresh-2 checkpoint, {rk.steps} steps): train "
          f"{rk.train_loss:.7f} vs {rp.train_loss:.7f}, eval "
          f"{rk.eval_loss:.7f} vs {rp.eval_loss:.7f}, max relative loss "
          f"difference {loss_rel:.3e}; params max_err/scale {prel:.3e} "
          f"(max abs {pabs:.3e}); tol {STREAM_TOL}", flush=True)
    if loss_rel > STREAM_TOL or prel > STREAM_TOL:
        fail("the stream refresh on the kernels disagrees with the plain "
             "recurrence")
    del plain
    free_device()

    memory, profiled = [], None
    i = STREAM_FIRST + 9
    for n in range(2, 6):
        want = RAW_BUCKETS if n == 2 else STREAM_EVERY
        for _ in range(want):
            kern.ingest(buckets[i % len(buckets)])
            i += 1
        if n == 5:
            profiled = profile_train_steps(
                "stream refresh at 360 buckets (f32)",
                lambda: memory.append(kern.refresh()), 20)
            r = memory.pop()
        else:
            r = kern.refresh()
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        memory.append((n, r.num_buckets, r.steps, r.captures,
                       torch.cuda.memory_allocated(),
                       torch.cuda.memory_reserved(),
                       stats.get("segment.all.current", 0),
                       stats.get("allocation.all.current", 0)))
    for n, nb, steps, caps, alloc, res, segs, allocs in memory:
        print(f"stream device memory after in-process refresh {n} ({nb} "
              f"buckets, {steps} steps, {caps} captures): allocated "
              f"{alloc / 2**20:.1f} MiB in {allocs} blocks, reserved "
              f"{res / 2**20:.1f} MiB in {segs} segments", flush=True)
    first, last = memory[0], memory[-1]
    grow = (last[4] - first[4], last[5] - first[5])
    print(f"check stream device memory flat from refresh 2 to 5: allocated "
          f"{grow[0] / 2**20:+.2f} MiB, reserved {grow[1] / 2**20:+.2f} MiB "
          f"(tol +1 MiB allocated, +0 reserved)", flush=True)
    if grow[0] > 2**20 or grow[1] > 0:
        fail("device memory grows across refreshes (a dropped graph's "
             "pool is not freed)")
    return {"stream": kern, "loss_rel": loss_rel, "params_rel": prel,
            "busy_pct": profiled, "memory": memory}


def stream_wire_vs_tailer(buckets: list, lines: list, wd: str) -> dict:
    """Two bf16 sparse-feed streams from the same seed, one fed by a
    SpanFirehoseReceiver through push_corpus, one by a BucketTailer, over
    the same two refreshes' buckets: params and losses bit for bit; then
    host ingest buckets/s of each source."""
    import threading

    import torch

    from deeprest_tpu_torch.data.wire import SpanFirehoseReceiver, push_corpus
    from deeprest_tpu_torch.train.stream import BucketTailer

    parts = [(0, STREAM_FIRST), (STREAM_FIRST, STREAM_SMALL)]
    path = os.path.join(wd, "tailed.jsonl")
    open(path, "wb").close()
    st_file = streaming_trainer("bfloat16", sparse=True)
    tailer = BucketTailer(path)
    gen = st_file.run(tailer, max_refreshes=2)
    res_file = []
    for lo, hi in parts:
        with open(path, "ab") as f:
            f.write(b"".join(lines[lo:hi]))
        res_file.append(next(gen))
    gen.close()
    tailer.close()

    st_wire = streaming_trainer("bfloat16", sparse=True)
    rx = SpanFirehoseReceiver("127.0.0.1", 0, space=st_wire.space).start()
    gen = st_wire.run(rx, max_refreshes=2)
    res_wire = []
    try:
        for lo, hi in parts:
            t = threading.Thread(target=push_corpus, daemon=True, args=(
                rx.address, buckets[lo:hi]), kwargs={"client_id": "smoke"})
            t.start()
            res_wire.append(next(gen))
            t.join(timeout=60)
        gen.close()
    finally:
        rx.close()
    same_loss = [(a.train_loss, a.eval_loss) == (b.train_loss, b.eval_loss)
                 for a, b in zip(res_file, res_wire)]
    diffs = {n: float((a - st_wire.state.params[n]).detach().abs().max())
             for n, a in st_file.state.params.items()}
    same = all(torch.equal(a, st_wire.state.params[n])
               for n, a in st_file.state.params.items())
    print(f"check stream wire-fed vs tailer-fed (bf16, sparse feed, "
          f"{[r.num_buckets for r in res_file]} buckets): refresh losses "
          f"equal {same_loss} ({[(r.train_loss, r.eval_loss) for r in res_file]}"
          f" vs {[(r.train_loss, r.eval_loss) for r in res_wire]}); params "
          f"bit-identical {same} (max |diff| {max(diffs.values()):.3e})",
          flush=True)
    if not (same and all(same_loss)):
        fail("wire-fed and tailer-fed streams differ")

    # host ingest rates: the tailer parses and featurizes, the wire
    # encodes, sends, decodes and featurizes
    n = STREAM_RATE_BUCKETS
    path = os.path.join(wd, "rate.jsonl")
    with open(path, "wb") as f:
        f.write(b"".join(lines[:n]))
    st = streaming_trainer("bfloat16", sparse=True)
    t0 = time.perf_counter()
    tailer = BucketTailer(path)
    got = 0
    while got < n:
        for b in tailer.poll():
            st.ingest(b)
            got += 1
    t_tail = time.perf_counter() - t0
    tailer.close()
    rx = SpanFirehoseReceiver("127.0.0.1", 0, space=st.space).start()
    try:
        t0 = time.perf_counter()
        t = threading.Thread(target=push_corpus, daemon=True, args=(
            rx.address, buckets[:n]))
        t.start()
        got = 0
        while got < n:
            items = rx.poll()
            for feat in items:
                st._ingest_featurized(feat)
            got += len(items)
            if not items:
                time.sleep(0.001)
        t_wire = time.perf_counter() - t0
        t.join(timeout=60)
    finally:
        rx.close()
    rates = {"tailer": n / t_tail, "wire": n / t_wire}
    print(f"stream ingest: {n} buckets of the social network (F=512, "
          f"sparse rows): tailer (parse + featurize) {rates['tailer']:.1f} "
          f"buckets/s, wire (encode + send + decode + featurize) "
          f"{rates['wire']:.1f} buckets/s", flush=True)
    return {"rates": rates}


def stream_drift(cuda_gru, corpus: list) -> dict:
    """The drift->retrain loop on drift_bench's detection corpus (quick
    cycle) at the stream's widths, bf16: the verdict enters after the
    shift, a refresh fires on "drift", and the WindowBackend sweeps run K1
    within 2e-2 of scale of the plain recurrence."""
    import numpy as np

    from deeprest_tpu_torch.config import QualityConfig
    from deeprest_tpu_torch.obs.quality import WindowBackend, model_apply
    from deeprest_tpu_torch.train.stream import DriftController

    cycle = DRIFT_CYCLE
    shift, total = 8 * cycle, len(corpus)
    qc = QualityConfig(
        enabled=True, sweep_every_buckets=cycle // 2,
        live_window=2 * cycle, reference_window=4 * cycle,
        min_sweep_buckets=W, sustain_enter=2, sustain_exit=2,
        drift_enter=1.0, drift_exit=0.5, calibration_enter=0.5,
        calibration_exit=0.25, retrain_cooldown_buckets=3 * cycle,
        model_warmup_refreshes=4)
    st = streaming_trainer("bfloat16", refresh=40, history_max=12 * cycle,
                           eval_holdout=2)
    controller = DriftController(st, qc)
    for k in cuda_gru.KERNELS:
        k.launches = 0
    refreshes, events, seen = [], [], 0
    t0 = time.perf_counter()
    for i, b in enumerate(corpus):
        st.ingest(b)
        if st.ready():
            refreshes.append((i, st.refresh().trigger))
        if controller.monitor is not None:
            fresh = controller.monitor.events[seen:]
            seen += len(fresh)
            events.extend((i, s, state) for _, s, state in fresh)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_gru.MODEL_KERNELS}
    enter = next((b for b, s, state in events
                  if s == "feature_drift" and state == "drift"), None)
    early = [b for b, s, state in events
             if s == "feature_drift" and state == "drift" and b < shift]
    drift_refreshes = [i for i, t in refreshes if t == "drift"]
    print(f"stream drift loop: {total} buckets (shift at {shift}, cycle "
          f"{cycle}), E={len(st.metric_names)},"
          f" {len(refreshes)} refreshes {refreshes}, drift verdict entered "
          f"at bucket {enter}, {controller.stats['sweeps']} sweeps, stats "
          f"{controller.stats}; {wall:.1f} s; launches {launches}",
          flush=True)
    if enter is None or early:
        fail(f"the drift verdict did not enter after the shift: {events}")
    if not drift_refreshes:
        fail(f"no refresh fired on drift: {refreshes}")

    # the sweeps' backend on the kernels against the plain recurrence
    backend = controller._backend()
    plain = WindowBackend(
        model_apply(st.state.model, cuda_gru.gru_recurrence_reference),
        st.state.params, st.x_stats, st.y_stats, st.metric_names,
        st.config.model.quantiles, W, delta_mask=st.current_delta_mask(),
        feature_dim=F)
    traffic = st.traffic.view()[-W:].copy()
    k1 = cuda_gru.GRU_FWD.launches
    got = backend.predict_series(traffic, integrate=False)
    k1 = cuda_gru.GRU_FWD.launches - k1
    want = plain.predict_series(traffic, integrate=False)
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    print(f"check stream drift WindowBackend sweep (K1, {k1} launches) vs "
          f"the plain recurrence: max_err/scale={err:.3e} (tol "
          f"{TOL['bfloat16'][0]})", flush=True)
    if k1 == 0 or err > TOL["bfloat16"][0]:
        fail("the drift sweep's backend disagrees with the plain path or "
             "did not launch gru_fwd")
    return {"launches": launches, "enter": enter, "refreshes": refreshes,
            "sweep_rel": err, "wall_s": wall}


def drift_corpus() -> list:
    """drift_bench's detection corpus at its quick cycle: a synthetic
    8-service app that becomes a 14-service one at bucket 8 x cycle, 14
    cycles in all (benchmarks/drift_bench.py)."""
    from deeprest_tpu_torch.workload.scenarios import normal_scenario
    from deeprest_tpu_torch.workload.simulator import (
        build_shifted_app, simulate_drift_corpus_iter,
    )

    cycle = DRIFT_CYCLE
    sc = normal_scenario(seed=SEED)
    sc.calls_per_user, sc.base_users = 0.5, 40.0
    sc.peak_range, sc.cycle_len = (56.0, 80.0), cycle
    before, after, endpoints = build_shifted_app(sc, 8, 14, 4, seed=SEED)
    return list(simulate_drift_corpus_iter(sc, 14 * cycle, 8 * cycle,
                                           before, after, endpoints))


def phase_stream(cuda_gru, raw_path: str, workdir: str) -> dict:
    """Phase 11: streaming retrain on the card (see the module
    docstring)."""
    import json as _json
    import threading

    from deeprest_tpu_torch.data.schema import Bucket

    t_phase = time.perf_counter()
    wd = os.path.join(workdir, "stream")
    os.makedirs(wd)
    with open(raw_path, "rb") as f:
        lines = f.readlines()
    if len(lines) != RAW_BUCKETS:
        fail(f"phase 7's corpus has {len(lines)} lines")
    free_device()
    # host work the in-process checks need, done while the stream CLI
    # runs in its own process: parse two refreshes' buckets, simulate the
    # drift corpus
    host = {}

    def prepare():
        t0 = time.perf_counter()
        host["buckets"] = [Bucket.from_dict(_json.loads(ln))
                           for ln in lines[:STREAM_SMALL]]
        host["parse_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host["drift"] = drift_corpus()
        host["simulate_s"] = time.perf_counter() - t0

    parts = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t0
        return out

    # the verdict surface in its own process on refresh 2's checkpoint
    # (a copy the second run does not write to), started after the first
    # run so it loads, warms and tails while the rest runs; it tails a
    # collector file of its own that grows after the reload
    log = os.path.join(wd, "serve_verdict.log")
    verdict_raw = os.path.join(wd, "verdict.jsonl")
    with open(verdict_raw, "wb") as f:
        f.write(b"".join(lines[:STREAM_SMALL]))
    server, args = [], []

    run1_done = threading.Event()
    refresh2 = []

    def spawn_verdict(ckpt_r2):
        args.extend(["--ckpt-dir", ckpt_r2, "--verdict-raw", verdict_raw,
                     "--verdict-sweep-every", 30,
                     "--verdict-live-window", 60, "--watch", 1])
        server.append(spawn_server(args, log))
        refresh2.append(ckpt_r2)
        run1_done.set()

    prep = threading.Thread(target=prepare, daemon=True)
    prep.start()
    try:
        # the stream CLI's runs go on in their own processes; the checks
        # in this process start once the first run's refresh-2 checkpoint
        # is copied, beside the second run
        stream = Background("stream CLI", part, "stream CLI",
                            stream_cli_path, cuda_gru, lines, wd,
                            spawn_verdict)
        while not run1_done.wait(1.0):
            if not stream.thread.is_alive():
                stream.result()
                fail("the stream CLI's first run ended without its "
                     "refresh-2 checkpoint")
        prep.join(timeout=300)
        if "drift" not in host:
            fail("parsing the stream's buckets or simulating the drift "
                 "corpus failed")
        buckets = host["buckets"]
        inproc = part("in-process refreshes", stream_in_process, cuda_gru,
                      buckets, refresh2[0])
        wire = part("wire vs tailer", stream_wire_vs_tailer, buckets, lines,
                    wd)
        drift = part("drift loop", stream_drift, cuda_gru, host["drift"])
        cli = stream.result()
        verdict = part("verdict surface", stream_verdict, server[0], args,
                       log, inproc["stream"], cli["ckpt_r2"], verdict_raw,
                       lines, buckets)
    finally:
        for proc in server:
            stop_server(proc)
    total = time.perf_counter() - t_phase
    launches = dict(cli["launches"])
    for name, count in drift["launches"].items():
        launches[name] += count
    launches["gru_fwd"] += verdict["gru_fwd"]
    print(f"stream phase: {total:.1f} s of wall time: {rounded(parts)} "
          f"(stream CLI runs {rounded(cli['seconds'])}; beside them, in "
          f"this process, the "
          f"parse of {STREAM_SMALL} buckets {host['parse_s']:.2f} s and the "
          f"drift corpus {host['simulate_s']:.2f} s); launches of this "
          f"path {launches}", flush=True)
    f32 = dict(cli["launches"])          # the stream CLI and the server
    f32["gru_fwd"] += verdict["gru_fwd"]
    return {"launches": launches, "f32_launches": f32,
            "total_s": total, "rates": wire["rates"],
            "busy_pct": inproc["busy_pct"]}


def stream_verdict(server, args, log, kern, ckpt: str, verdict_raw: str,
                   lines: list, buckets: list) -> dict:
    """``serve --verdict-raw`` on the stream's checkpoint: /v1/verdict 200
    with states once the reference arms, --watch picks up the next stream
    checkpoint and the ingestor rebases (sweeps go on against the fresh
    model), no capture after warm-up."""
    from deeprest_tpu_torch.train.checkpoint import latest_step

    proc, start = wait_listening(server, args, log)
    base = start["listening"]

    def sweeps_at_least(n, what):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            status, v = http_json(base + "/v1/verdict")
            if status == 200 and v.get("sweeps", 0) >= n:
                return v
            time.sleep(0.2)
        fail(f"/v1/verdict never reached {n} sweeps ({what}): {status} {v}")

    v1 = sweeps_at_least(1, "armed")
    health = http_json(base + "/healthz")[1]
    before = latest_step(ckpt)
    kern.ckpt_dir = ckpt                        # the next stream checkpoint
    for b in buckets[:STREAM_EVERY]:
        kern.ingest(b)
    r = kern.refresh()
    if latest_step(ckpt) <= before:
        fail("the in-process refresh did not write a newer step")
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        health = http_json(base + "/healthz")[1]
        if health["reloads"] >= 1:
            break
        time.sleep(0.2)
    else:
        fail(f"serve --watch never picked up step {latest_step(ckpt)}")
    with open(verdict_raw, "ab") as f:          # new traffic after the swap
        f.write(b"".join(lines[STREAM_SMALL:STREAM_SMALL + 30]))
    v2 = sweeps_at_least(v1["sweeps"] + 1, "after the reload")
    health = http_json(base + "/healthz")[1]
    cache = health["jit_cache"]
    print(f"check stream verdict surface: /v1/verdict 200, sweeps "
          f"{v1['sweeps']} -> {v2['sweeps']}, states {v2['states']}, "
          f"feature drift {v2['feature_drift']}; reloads "
          f"{health['reloads']} (step {r.checkpoint_path}); graphs "
          f"captured {cache['captures']}, after warm-up "
          f"{cache['captures_after_warmup']}; launches "
          f"{health['kernel_launches']}", flush=True)
    if sum(v2["states"].values()) != 88:
        fail(f"/v1/verdict has states for {sum(v2['states'].values())} "
             "metrics; want 88")
    if cache["captures_after_warmup"]:
        fail("the verdict server captured graphs after warm-up")
    return {"gru_fwd": health["kernel_launches"]["gru_fwd"],
            "sweeps": v2["sweeps"]}


# The host-streamed feed, the rest of `train` and the what-if demo
HOST_TURNS = ("staged", "host", "host", "staged")
HOST_SCALE_TOL = 2e-2      # kernels vs plain recurrence, of each metric's scale
# demo precompute: the --quick grid (waves at 1x and 3x, 9 seen and 9 unseen
# compositions, 120 ticks) cut to one seen and one unseen composition and
# 60 ticks (the window: the least a dataset predicts), on phase 7's first
# SYNTH_BUCKETS minutes; its host simulation sets the time
DEMO_TICKS = 60


def scaled_error(got, want, y_range) -> float:
    """Worst max |got - want| over the last axis's metrics, each over its
    scale: the largest |want| of that metric floored at its train-split
    range (``sweep_error``'s convention), a degenerate range counting as
    1: the stats pass such a metric through unchanged (``MinMaxStats``),
    so the model's unit is its raw unit, and its answers hover near 0."""
    import numpy as np

    got = np.asarray(got, np.float64).reshape(-1, len(y_range))
    want = np.asarray(want, np.float64).reshape(-1, len(y_range))
    y_range = np.asarray(y_range, np.float64)
    scale = np.maximum(np.abs(want).max(axis=0),
                       np.where(y_range == 0.0, 1.0, y_range))
    return float((np.abs(got - want).max(axis=0) / scale).max())


def host_feed_flagship(cuda_gru, data) -> dict:
    """20 host-fed steps against 20 staged ones at the flagship width
    (captured S=10, dropout 0 and 0.5: per-step losses equal, params bit
    for bit), K2/K3 launches of the host-fed run, the busy share of a
    host-fed epoch of replays, the plot arrays on the kernels against the
    plain recurrence, and steady-state steps/s host-fed and staged in
    turns."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.plots import prediction_arrays
    from deeprest_tpu_torch.train.trainer import Trainer

    out = {"launches": dict.fromkeys(
        (k.name for k in cuda_gru.MODEL_KERNELS), 0)}
    for dropout in (0.0, 0.5):
        runs = {}
        for label, device_data in (("staged", "always"), ("host", "off")):
            trainer, bundle = flagship_trainer(
                data, dropout, SPLIT_20_STEPS, steps_per_superstep=10,
                device_data=device_data)
            params = init_params(trainer.model_config, SEED)
            for k in cuda_gru.KERNELS:
                k.launches = 0
            state, losses = train_epochs(trainer, bundle, params)
            runs[label] = (trainer, state, losses,
                           {k.name: k.launches for k in cuda_gru.KERNELS})
        (tr_h, st_h, l_h, n_h), (tr_s, st_s, l_s, n_s) = (runs["host"],
                                                          runs["staged"])
        for name, count in n_h.items():
            if name in out["launches"]:
                out["launches"][name] += count
        rel, absd, same = params_rel_diff(st_h, st_s)
        equal = np.array_equal(l_h, l_s)
        print(f"check host-fed vs staged 20 steps (S=10), dropout "
              f"{dropout}: feeds {tr_h.feed}/{tr_s.feed}; losses equal "
              f"{equal} (first {l_h[:3].tolist()}); params bit-identical "
              f"{same} (max abs {absd:.3e}); host-fed captures "
              f"{tr_h.captures}, replays {tr_h.replays}, dispatches "
              f"{tr_h.dispatches}; launches host-fed {n_h}, staged {n_s}",
              flush=True)
        if tr_h.feed != "host" or tr_s.feed != "staged":
            fail("device_data off did not host-feed, or always did not "
                 "stage")
        if len(l_h) != 20 or not equal or not same:
            fail(f"host-fed training parts from staged training (dropout "
                 f"{dropout}): losses equal {equal}, params bit-identical "
                 f"{same}")
        if (tr_h.captures, tr_h.replays, tr_h.dispatches) != (1, 19, 20):
            fail("the host-fed run did not take 1 capture, 19 replays and "
                 "20 dispatches")
        for name in ("gru_fwd_train", "gru_bwd"):
            if n_h[name] != 40:
                fail(f"{name} counted {n_h[name]} launches over 20 "
                     f"host-fed steps; want 40")
        if dropout == 0.0:
            rng = np.random.default_rng(SEED)
            out["busy_host_pct"] = profile_train_steps(
                "train host-fed epoch of replays (S=10)",
                lambda: tr_h.train_epoch(st_h, bundle, rng), 20)
            plain = Trainer(tr_h.config, F, bundle.metric_names,
                            device="cuda",
                            recurrence=cuda_gru.gru_recurrence_reference)
            plain_state = plain.init_state(
                {k: v.detach() for k, v in st_h.params.items()})
            for k in cuda_gru.KERNELS:
                k.launches = 0
            got = prediction_arrays(tr_h, st_h, bundle)
            out["launches"]["gru_fwd"] += cuda_gru.KERNELS[0].launches
            want = prediction_arrays(plain, plain_state, bundle)
            y_range = np.asarray(bundle.y_stats.range,
                                 np.float64).reshape(-1)
            err = max(scaled_error(got[k], want[k], y_range)
                      for k in ("median", "lo", "hi"))
            truth_same = np.array_equal(got["truth"], want["truth"])
            print(f"check plot arrays (train/plots.py prediction_arrays, "
                  f"{got['median'].shape} median, lo, hi) kernels vs plain "
                  f"recurrence: {err:.3e} of scale (tol {HOST_SCALE_TOL}), "
                  f"truth equal {truth_same}", flush=True)
            if err > HOST_SCALE_TOL or not truth_same \
                    or not np.isfinite(got["median"]).all():
                fail("the plot arrays on the kernels part from the plain "
                     "recurrence's")
            out["plot_err"] = err
            del plain, plain_state
        del runs, tr_h, st_h, tr_s, st_s
        free_device()

    rates = {"staged": [], "host": []}
    for label in HOST_TURNS:
        trainer, bundle = flagship_trainer(
            data, 0.5, device_data="always" if label == "staged" else "off")
        train_epochs(trainer, bundle, init_params(trainer.model_config, SEED),
                     epochs=2)
        rates[label].append(trainer.throughput.steps_per_sec)
        del trainer
        free_device()
    print(f"host feed steady-state steps/s (2 epochs of "
          f"{bundle.num_train_windows} windows, S=auto, first update "
          f"excluded), in turns: staged {rates['staged']}, host-fed "
          f"{rates['host']}", flush=True)
    out["steps_per_sec"] = rates
    return out


def host_feed_tenk(cuda_gru, data) -> dict:
    """The 10k dense corpus under device_data="auto" with the budget one
    byte under its staged bytes (host-fed) against the default budget
    (staged), in turns: 2 epochs of 10 captured steps each, dropout 0,
    losses equal; steady-state steps/s of each."""
    import numpy as np

    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    staged_bytes = DAY * TENK_F * 2 + DAY * TRAIN["E"] * 4
    params = None
    losses = {"staged": [], "host": []}
    rates = {"staged": [], "host": []}
    launches = dict.fromkeys((k.name for k in cuda_gru.MODEL_KERNELS), 0)
    for label in HOST_TURNS:
        budget = staged_bytes - 1 if label == "host" else 4 << 30
        cfg = Config(
            model=ModelConfig(hidden_size=TRAIN["H"], dropout_rate=0.0,
                              compute_dtype="bfloat16"),
            train=TrainConfig(batch_size=TRAIN["B"], window_size=W,
                              train_split=TENK_SPLIT_10_STEPS,
                              steps_per_superstep=10,
                              device_data_max_bytes=budget))
        bundle = prepare_dataset(data, cfg.train)
        trainer = Trainer(cfg, TENK_F, bundle.metric_names, device="cuda")
        if params is None:
            params = init_params(trainer.model_config, seed=SEED)
        staged = trainer.stage_dataset(bundle)
        if (staged is None) != (label == "host"):
            fail(f"the 10k base ({staged_bytes} bytes) under a budget of "
                 f"{budget} did not {'host-feed' if label == 'host' else 'stage'}")
        for k in cuda_gru.KERNELS:
            k.launches = 0
        state = trainer.init_state(params)
        rng = np.random.default_rng(SEED)
        run = []
        for _ in range(2):
            state, _ = trainer.train_epoch(state, bundle, rng, staged)
            run.append(trainer.last_epoch_losses)
        for k in cuda_gru.MODEL_KERNELS:
            launches[k.name] += k.launches
        losses[label].append(np.concatenate(run))
        rates[label].append(trainer.throughput.steps_per_sec)
        if trainer.feed != ("host" if label == "host" else "staged"):
            fail(f"the 10k {label} run took the {trainer.feed} feed")
        del state, staged, trainer, bundle
        free_device()
    want = losses["staged"][0]
    equal = all(np.array_equal(a, want)
                for a in losses["host"] + losses["staged"])
    print(f"check tenk dense, auto over budget (budget {staged_bytes - 1} "
          f"bytes, one under the staged base) host-fed vs staged, 20 steps "
          f"(S=10): losses equal {equal} (first {want[:3].tolist()}); "
          f"steady-state steps/s in turns: staged {rates['staged']}, "
          f"host-fed {rates['host']}", flush=True)
    if len(want) != 20 or not np.isfinite(want).all() or not equal:
        fail("the host-fed 10k run's losses differ from the staged run's")
    return {"steps_per_sec": rates, "launches": launches}


def train_cli_flags(cuda_gru, feats: str, wd: str) -> dict:
    """`train --device-data off --report-every 1` on the flagship features
    against `--device-data always` (dropout 0: epoch losses equal), the
    MAE table every epoch, the host-fed launches, and --plots-dir: fast
    with a message naming matplotlib where it is missing, else the
    PNGs."""
    import importlib.util

    base = ["train", "--features", feats, "--epochs", "2", "--batch-size",
            str(TRAIN["B"]), "--window", str(W), "--compute-dtype",
            "bfloat16", "--dropout", "0", "--no-baselines"]
    plots = os.path.join(wd, "plots")
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    # the runs start together: off, always, --plots-dir without
    # matplotlib, and phase 15's `train --mesh 1,1,1` of the always run
    staged_args = base + ["--device-data", "always"]
    runs = {"off": CliRun(base + ["--device-data", "off", "--report-every",
                                  "1"] + (["--plots-dir", plots]
                                          if have_mpl else []), timeout=600),
            "always": CliRun(staged_args, timeout=600),
            "mesh": start_mesh_cli(staged_args)}
    if not have_mpl:
        runs["no matplotlib"] = CliRun(base + ["--plots-dir", plots],
                                       timeout=300, check=False)
    lines = runs["off"].lines()
    off_s = runs["off"].seconds
    off = json.loads(lines[-1])
    staged = runs["always"].json()
    tables = sum(line.startswith("===== ") for line in lines)
    steps = int(off["steps"])
    launches = off["kernel_launches"]
    print(f"main train CLI --device-data off --report-every 1: feed "
          f"{off['feed']}, {steps} steps, {off_s:.2f} s wall, steady state "
          f"{off['steps_per_sec']:.3f} steps/s (--device-data always "
          f"{staged['steps_per_sec']:.3f}); epoch losses {off['epoch_losses']}"
          f" vs always {staged['epoch_losses']}; {tables} metric tables "
          f"printed; launches {launches}", flush=True)
    if off["feed"] != "host" or staged["feed"] != "staged":
        fail(f"train --device-data off reported feed {off['feed']!r}, "
             f"always {staged['feed']!r}")
    if off["epoch_losses"] != staged["epoch_losses"] \
            or off["step_losses"] != staged["step_losses"]:
        fail("train --device-data off and always disagree (dropout 0)")
    if tables != 3 * TRAIN["E"]:
        fail(f"--report-every 1 printed {tables} metric tables over 2 "
             f"epochs and the final report; want {3 * TRAIN['E']}")
    for name in ("gru_fwd_train", "gru_bwd"):
        if launches[name] != 2 * steps:
            fail(f"{name} launched {launches[name]} times in {steps} "
                 "host-fed CLI steps; want 2 x steps")
    if have_mpl:
        pngs = sorted(os.listdir(plots))
        print(f"check --plots-dir: {len(pngs)} PNGs written", flush=True)
        if len(pngs) != TRAIN["E"] + 1:
            fail("--plots-dir did not write a curve and a plot a metric")
    else:
        proc = runs["no matplotlib"]
        print(f"check --plots-dir without matplotlib: exit "
              f"{proc.returncode} after {proc.seconds:.2f} s, "
              f"{proc.err.strip().splitlines()[-1:]}", flush=True)
        if proc.returncode == 0 or "matplotlib" not in proc.err \
                or "epoch" in proc.out or os.path.exists(plots):
            fail("--plots-dir without matplotlib did not fail before "
                 "training with a message naming matplotlib")
    return {"launches": launches, "steps_per_sec": off["steps_per_sec"],
            "staged_steps_per_sec": staged["steps_per_sec"],
            "mesh": runs["mesh"], "staged": staged}


def demo_precompute(cuda_gru, ckpt: str, sample: str, wd: str) -> dict:
    """The what-if demo on phase 7's checkpoint (F=128, E=88, H=128, bf16):
    precompute_results on the kernels and through the plain recurrence on
    the card, the same grid each way (calls, ground truth and baselines
    equal; ours, ours_lo and ours_hi within 2e-2 of scale), and its 3x
    seen dataset with the same params at f32 (2e-4), then `python -m
    deeprest_tpu_torch.demo serve` on the artifact and its routes."""
    import dataclasses
    import urllib.request

    import numpy as np

    from deeprest_tpu_torch.cli import _load_buckets
    from deeprest_tpu_torch.data.featurize import featurize_buckets
    from deeprest_tpu_torch.demo.precompute import (
        DemoConfig, precompute_results, save_results,
    )
    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.workload.scenarios import (
        SEEN_COMPOSITIONS, UNSEEN_COMPOSITIONS,
    )

    buckets = _load_buckets(sample)
    cfg = DemoConfig(shapes=("waves",), multipliers=(1, 3),
                     seen=SEEN_COMPOSITIONS[:1],
                     unseen=UNSEEN_COMPOSITIONS[:1], ticks=DEMO_TICKS)
    # f32 on the 3x seen dataset only, where bf16 extrapolates furthest
    cfg_f32 = dataclasses.replace(cfg, multipliers=(3,), unseen=())
    kernels = Predictor.from_checkpoint(ckpt, device="cuda")
    plain = dict(recurrence=cuda_gru.gru_recurrence_reference)
    predictors = {  # bf16 as checkpointed, and the same params at f32
        "kernels": (kernels, cfg),
        "plain": (Predictor.from_checkpoint(ckpt, device="cuda", **plain),
                  cfg),
        "kernels f32": (at_dtype(kernels, "float32"), cfg_f32),
        "plain f32": (at_dtype(kernels, "float32", cuda_graphs=False,
                               **plain), cfg_f32)}
    observed = featurize_buckets(buckets, space=kernels.space())
    y_range = np.asarray(kernels.y_stats.range, np.float64).reshape(-1)
    names = kernels.metric_names
    results, secs = {}, {}
    launches = 0
    for label, (pred, grid) in predictors.items():
        for k in cuda_gru.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        results[label] = precompute_results(pred, observed, buckets, grid)
        secs[label] = time.perf_counter() - t0
        if label == "kernels":
            launches = cuda_gru.KERNELS[0].launches
    del predictors, kernels

    def ours_error(a: str, b: str) -> float:
        worst = 0.0
        for key, ds in results[b]["datasets"].items():
            for comp, resources in ds["components"].items():
                for res, rec in resources.items():
                    m = names.index(f"{comp}_{res}")
                    mine = results[a]["datasets"][key]["components"][comp][res]
                    for s in ("ours", "ours_lo", "ours_hi"):
                        worst = max(worst, scaled_error(
                            mine[s], rec[s], y_range[m:m + 1]))
        return worst

    got, want = results["kernels"], results["plain"]
    same_host = sorted(got["datasets"]) == sorted(want["datasets"])
    for key, ds in want["datasets"].items():
        mine = got["datasets"].get(key, {})
        same_host = same_host and mine.get("calls") == ds["calls"] and all(
            mine["components"][comp][res][s] == rec[s]
            for comp, resources in ds["components"].items()
            for res, rec in resources.items()
            for s in ("groundtruth", "resrc", "comp", "observed"))
    readings = {pair: ours_error(*pair) for pair in (
        ("kernels", "plain"), ("kernels f32", "plain f32"),
        ("plain", "plain f32"), ("kernels", "plain f32"))}
    worst = readings[("kernels", "plain")]
    n = len(got["datasets"])
    print(f"check demo precompute ({n} datasets: waves x1 and x3, one seen "
          f"and one unseen composition, {DEMO_TICKS} ticks) kernels vs plain "
          f"recurrence: ours/ours_lo/ours_hi {worst:.3e} of scale (tol "
          f"{HOST_SCALE_TOL}); at f32 (x3 seen) "
          f"{readings[('kernels f32', 'plain f32')]:.3e} (tol "
          f"{GRAD_TOL['float32']}); bf16 plain vs f32 plain "
          f"{readings[('plain', 'plain f32')]:.3e}, bf16 kernels vs f32 "
          f"plain {readings[('kernels', 'plain f32')]:.3e}; calls, "
          f"groundtruth, resrc, comp, observed equal {same_host}; seconds "
          f"{ {k: round(v, 2) for k, v in secs.items()} }; K1 launches "
          f"{launches}", flush=True)
    if not same_host or worst > HOST_SCALE_TOL or n != 4 \
            or readings[("kernels f32", "plain f32")] > GRAD_TOL["float32"]:
        fail("the demo's precompute on the kernels parts from the plain "
             "recurrence's")
    if launches == 0:
        fail("demo precompute never launched gru_fwd")
    path = save_results(got, os.path.join(wd, "demo.json.gz"))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeprest_tpu_torch.demo", "serve",
         "--results", path, "--port", "0"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        first = proc.stdout.readline()
        if not first.startswith("demo at http://"):
            fail(f"demo serve did not start: {first}{proc.stdout.read()}")
        url = first.split()[2].rstrip("/")
        with urllib.request.urlopen(url + "/", timeout=30) as resp:
            page = resp.read()
        with urllib.request.urlopen(url + "/api/meta", timeout=30) as resp:
            meta = json.loads(resp.read())
        key = next(iter(got["datasets"]))
        ds = got["datasets"][key]
        with urllib.request.urlopen(
                f"{url}/api/panel?shape={ds['shape']}&multiplier="
                f"{ds['multiplier']}&group={ds['group']}&index="
                f"{ds['index']}", timeout=30) as resp:
            panel = json.loads(resp.read())
    finally:
        proc.kill()
        proc.wait(timeout=60)
    print(f"check demo serve: / {len(page)} bytes, /api/meta "
          f"multipliers {meta['multipliers']}, /api/panel {panel['key']} "
          f"with {len(panel['components'])} components", flush=True)
    if b"what-if" not in page or panel["key"] != key \
            or meta["methods"] != ["groundtruth", "resrc", "comp", "ours"]:
        fail("demo serve did not answer its routes")
    return {"launches": launches, "seconds": secs, "datasets": n,
            "ours_err": readings}


def phase_host_feed(cuda_gru, social_ckpt: str, social_sample: str,
                    workdir: str, beside_demo=None) -> dict:
    """Phase 14: the host-streamed trainer feed at the flagship width and
    on the 10k dense corpus, the `train` CLI's --device-data,
    --report-every and --plots-dir, and the what-if demo;
    ``beside_demo()``, when given, is called just before the demo (work
    that launches no kernel in this process) and its result returned
    under "beside_demo"."""
    from deeprest_tpu_torch.data.featurize import FeaturizedData

    wd = os.path.join(workdir, "host_feed")
    os.makedirs(wd)
    secs = {}
    t0 = time.perf_counter()
    feats = flagship_corpus(os.path.join(wd, "corpus.npz"))
    flagship = host_feed_flagship(cuda_gru, FeaturizedData.load(feats))
    secs["flagship"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tenk = host_feed_tenk(cuda_gru, FeaturizedData.load(
        tenk_corpus(os.path.join(wd, "tenk.npz"))))
    secs["tenk"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = train_cli_flags(cuda_gru, feats, wd)
    secs["train CLI"] = time.perf_counter() - t0
    beside = beside_demo() if beside_demo else None
    t0 = time.perf_counter()
    demo = demo_precompute(cuda_gru, social_ckpt, social_sample, wd)
    secs["demo"] = time.perf_counter() - t0
    launches = dict(flagship["launches"])
    for part in (tenk["launches"], cli["launches"]):
        for name, count in part.items():
            launches[name] += count
    launches["gru_fwd"] += demo["launches"]
    print(f"main host feed phase: seconds {rounded(secs)}; launches "
          f"{launches}", flush=True)
    return {"launches": launches, "flagship": flagship, "tenk": tenk,
            "cli": cli, "demo": demo, "seconds": secs,
            "beside_demo": beside}


# -- phase 15: the mesh's data axis -----------------------------------------

# 10 steps of B=32: int((4,320 - 60) x 0.0752) = 320 windows
SPLIT_10_STEPS = 0.0752
DP_TURNS = ("no group", "nccl", "nccl", "no group")
DP_LOSS_TOL = (2e-3, 1e-5)      # tests/test_parallel.py:80-90: rtol, atol
DP_PARAM_TOL = (5e-3, 1e-4)
DP_GRAD_TOL = 1e-5              # of each leaf's max |grad|


def free_port() -> int:
    """A free TCP port on localhost (the process group's rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_trainer(data, mesh, compute: str, dropout: float, split: float,
               features: int = F, **train):
    """A flagship-width Trainer (B=32 global, T=60, H=128, ``features``
    wide) on ``mesh`` and the bundle of ``data``."""
    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    cfg = Config(model=ModelConfig(hidden_size=TRAIN["H"],
                                   dropout_rate=dropout,
                                   compute_dtype=compute),
                 train=TrainConfig(batch_size=TRAIN["B"], window_size=W,
                                   train_split=split, **train))
    bundle = prepare_dataset(data, cfg.train)
    return Trainer(cfg, features, bundle.metric_names, mesh=mesh), bundle


def no_group_mesh():
    """The one-process mesh with no process group on card 0, for a trainer
    that must reduce nothing while this process is in a job."""
    import torch

    from deeprest_tpu_torch.config import MeshConfig
    from deeprest_tpu_torch.parallel import Mesh

    return Mesh(MeshConfig(), 0, torch.device("cuda", 0))


def dp_eager_run(trainer, bundle, params) -> dict:
    """One epoch of eager updates (S=1): per-step losses, the first
    update's (all-reduced) gradients, final params, K2/K3 launches and
    seconds."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.ops import cuda_gru

    grads = {}
    state = trainer.init_state(params)

    def on_step(global_step):
        if global_step == 1:
            grads.update({n: p.grad.detach().cpu().numpy().copy()
                          for n, p in state.model.named_parameters()})

    staged = trainer.stage_dataset(bundle)
    for k in cuda_gru.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    state, _ = trainer.train_epoch(state, bundle, np.random.default_rng(SEED),
                                   staged, on_step=on_step)
    torch.cuda.synchronize()
    return {"losses": trainer.last_epoch_losses, "grads": grads,
            "params": {n: p.detach().cpu().numpy().copy()
                       for n, p in state.params.items()},
            "launches": {k.name: k.launches for k in cuda_gru.KERNELS},
            "seconds": time.perf_counter() - t0}


def dp_rank_main(rank: int, world: int, port: int, feats: str,
                 out: str) -> None:
    """One rank of the gloo job on the card (spawned): the eager epoch of
    :func:`dp_eager_run` on this rank's slice, written to ``out``, and
    the refusal of a captured superstep under gloo."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from deeprest_tpu_torch.config import MeshConfig
    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank, backend="gloo",
                           device="cuda")
    mesh = make_mesh(MeshConfig(data=world), device="cuda")
    trainer, bundle = dp_trainer(FeaturizedData.load(feats), mesh,
                                 "float32", 0.0, SPLIT_10_STEPS,
                                 steps_per_superstep=1)
    run = dp_eager_run(trainer, bundle,
                       init_params(trainer.model_config, SEED))
    try:
        trainer._captured(10)
        refusal = ""
    except ValueError as exc:
        refusal = str(exc)
    arrays = {"losses": run["losses"], "seconds": run["seconds"],
              "refusal": np.asarray(refusal),
              "device": np.asarray(str(trainer.device)),
              "backend": np.asarray(mesh.backend)}
    arrays.update({f"launches/{k}": v for k, v in run["launches"].items()})
    arrays.update({f"params/{k}": v for k, v in run["params"].items()})
    arrays.update({f"grads/{k}": v for k, v in run["grads"].items()})
    np.savez(out, **arrays)
    torch.distributed.destroy_process_group()


def leaf_distance(got: dict, want: dict) -> float:
    """Worst max |got - want| / max |want| over the leaves."""
    import numpy as np

    return max(float(np.abs(got[k] - v).max() / max(np.abs(v).max(), 1e-30))
               for k, v in want.items())


def data_parallel_nccl(cuda_gru, data) -> dict:
    """(a) NCCL at world size 1 on the flagship, captured S=10, 2 epochs of
    20 steps, in turns against the trainer with no process group: losses
    and params bit-equal (an all-reduce over one rank is the identity),
    K2 = K3 = 2 launches a replay, the capture form, steps/s of each."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.config import MeshConfig
    from deeprest_tpu_torch.graphs import GraphCaptureError
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(init_method=f"tcp://127.0.0.1:{free_port()}",
                           world_size=1, rank=0, device="cuda")
    out = {"launches": dict.fromkeys(
        (k.name for k in cuda_gru.MODEL_KERNELS), 0)}
    try:
        mesh = make_mesh(MeshConfig(data=1), device="cuda")
        runs, rates = {}, {label: [] for label in DP_TURNS}
        for label in DP_TURNS:
            trainer, bundle = dp_trainer(
                data, mesh if label == "nccl" else no_group_mesh(),
                "bfloat16", 0.5, SPLIT_20_STEPS, steps_per_superstep=10)
            params = init_params(trainer.model_config, SEED)
            for k in cuda_gru.KERNELS:
                k.launches = 0
            try:
                state, losses = train_epochs(trainer, bundle, params, epochs=2)
            except GraphCaptureError as exc:
                fail(f"the captured update with its NCCL all-reduce did not "
                     f"capture ({label}): {exc}")
            counts = {k.name: k.launches for k in cuda_gru.KERNELS}
            ledger = {k.name: n for k, n in state.graph.launches.items()}
            rates[label].append(trainer.throughput.steps_per_sec)
            runs[label] = (trainer, state, losses, counts, ledger)
            if label == "nccl":
                for name in out["launches"]:
                    out["launches"][name] += counts[name]
            del trainer, state
            free_device()
        (tr_n, st_n, l_n, n_n, g_n) = runs["nccl"]
        (tr_p, st_p, l_p, n_p, g_p) = runs["no group"]
        rel, absd, same = params_rel_diff(st_n, st_p)
        equal = np.array_equal(l_n, l_p)
        form = "whole: the NCCL all-reduce inside the captured update"
        print(f"check data axis NCCL world size 1 (flagship bf16, dropout "
              f"0.5, captured S=10, 2 x 20 steps) vs no process group: "
              f"losses equal {equal}, params bit-identical {same} (max abs "
              f"{absd:.3e}); backend {tr_n.mesh.backend}; capture form "
              f"{form}; captures {tr_n.captures}, replays {tr_n.replays}; "
              f"graph ledger {g_n} (no group {g_p}); launches {n_n}; "
              f"steady-state steps/s in turns {rates}", flush=True)
        if not equal or not same:
            fail("data-parallel training at world size 1 (NCCL) parts from "
                 "the trainer with no process group")
        if tr_n.mesh.backend != "nccl" or (tr_n.captures, tr_n.replays) \
                != (1, 39):
            fail("the NCCL run did not take 1 capture and 39 replays")
        if g_n.get("gru_fwd_train") != 2 or g_n.get("gru_bwd") != 2:
            fail(f"the captured NCCL update holds {g_n} launches; want "
                 "K2 = K3 = 2 a replay")
        for name in ("gru_fwd_train", "gru_bwd"):
            if n_n[name] != 80:
                fail(f"{name} counted {n_n[name]} launches over 40 NCCL "
                     "steps; want 80")
        out.update(steps_per_sec=rates, capture_form=form, ledger=g_n)
        del runs
    finally:
        torch.distributed.destroy_process_group()
    free_device()
    return out


def start_gloo_ranks(workdir: str) -> dict:
    """(b)'s two spawned gloo ranks on the one card, started beside phase
    14's demo (no kernel of theirs launches in this process); returns the
    phase's directory, its corpus and the job, whose result is the ranks'
    outputs and wall seconds."""
    import multiprocessing

    import numpy as np

    wd = os.path.join(workdir, "data_parallel")
    os.makedirs(wd)
    feats = flagship_corpus(os.path.join(wd, "corpus.npz"))

    def ranks():
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        outs = [os.path.join(wd, f"dp_rank{r}.npz") for r in range(2)]
        procs = [ctx.Process(target=dp_rank_main,
                             args=(r, 2, port, feats, outs[r]))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(300)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        wall = time.perf_counter() - t0
        if [p.exitcode for p in procs] != [0, 0]:
            fail(f"gloo ranks exited {[p.exitcode for p in procs]}")
        out = []
        for path in outs:
            with np.load(path) as z:
                out.append({k: z[k] for k in z.files})
        return out, wall

    return {"wd": wd, "feats": feats,
            "job": Background("phase 15's gloo ranks", ranks)}


def data_parallel_gloo(cuda_gru, data, gloo: dict) -> dict:
    """(b) gloo at world size 2: :func:`start_gloo_ranks`'s two ranks,
    flagship width, f32, dropout 0, 10 eager steps, against world size 1
    (no group) on the same params: params bit-equal across the ranks, the
    first update's gradients within 1e-5 of each leaf's scale, losses and
    final params within JAX's sharded-training tolerances, K2 and K3
    launched on both ranks, a captured superstep refused."""
    import numpy as np

    from deeprest_tpu_torch.models.qrnn import init_params

    trainer, bundle = dp_trainer(data, no_group_mesh(), "float32", 0.0,
                                 SPLIT_10_STEPS, steps_per_superstep=1)
    single = dp_eager_run(trainer, bundle,
                          init_params(trainer.model_config, SEED))
    del trainer
    free_device()
    ranks, wall = gloo["job"].result()

    def group(r, prefix):
        return {k[len(prefix):]: v for k, v in r.items()
                if k.startswith(prefix)}

    p0, p1 = group(ranks[0], "params/"), group(ranks[1], "params/")
    across = all(np.array_equal(p0[k], p1[k]) for k in p0)
    grad_d = leaf_distance(group(ranks[0], "grads/"), single["grads"])
    param_d = leaf_distance(p0, single["params"])
    loss_d = float(np.abs(ranks[0]["losses"] - single["losses"]).max())
    loss_ok = np.allclose(ranks[0]["losses"], single["losses"],
                          rtol=DP_LOSS_TOL[0], atol=DP_LOSS_TOL[1])
    params_ok = all(np.allclose(p0[k], v, rtol=DP_PARAM_TOL[0],
                                atol=DP_PARAM_TOL[1])
                    for k, v in single["params"].items())
    launches = [group(r, "launches/") for r in ranks]
    print(f"check data axis gloo world size 2 (two processes on one card, "
          f"{ranks[0]['device']} and {ranks[1]['device']}, flagship f32, "
          f"dropout 0, {len(single['losses'])} eager steps) vs world size "
          f"1: params bit-equal across ranks {across}; first update's grads "
          f"{grad_d:.3e} of leaf scale (tol {DP_GRAD_TOL}); losses max abs "
          f"{loss_d:.3e} (rtol {DP_LOSS_TOL[0]}, atol {DP_LOSS_TOL[1]}: "
          f"{loss_ok}); final params {param_d:.3e} of leaf scale (rtol "
          f"{DP_PARAM_TOL[0]}, atol {DP_PARAM_TOL[1]}: {params_ok}); "
          f"launches rank 0 {launches[0]}, rank 1 {launches[1]}; seconds "
          f"world size 1 {single['seconds']:.2f}, ranks "
          f"{float(ranks[0]['seconds']):.2f}/{float(ranks[1]['seconds']):.2f}"
          f" ({wall:.1f} s wall with spawn); backend {ranks[0]['backend']}",
          flush=True)
    if not across or grad_d > DP_GRAD_TOL or not loss_ok or not params_ok:
        fail("gloo world size 2 parts from world size 1 beyond the stated "
             "tolerances, or its ranks' params differ")
    for r, counts in enumerate(launches):
        for name in ("gru_fwd_train", "gru_bwd"):
            if int(counts[name]) != 2 * len(single["losses"]):
                fail(f"rank {r} launched {name} {int(counts[name])} times "
                     f"in {len(single['losses'])} steps")
    if "gloo's collectives cannot be captured" not in str(
            ranks[1]["refusal"]):
        fail("a captured superstep under gloo was not refused")
    total = dict.fromkeys((k.name for k in cuda_gru.MODEL_KERNELS), 0)
    for counts in launches:
        for name in total:
            total[name] += int(counts[name])
    return {"launches": total, "grad_dist": grad_d, "param_dist": param_d,
            "loss_max_abs": loss_d,
            "rank_seconds": [float(r["seconds"]) for r in ranks]}


def start_mesh_cli(base: list) -> CliRun:
    """(c) ``train --mesh 1,1,1`` under torchrun's env:// variables at
    world size 1 (NCCL) of the plain ``train`` command ``base``, started
    now (beside phase 14's runs of ``base``)."""
    return CliRun(base + ["--mesh", "1,1,1"], timeout=300, env=dict(
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
        WORLD_SIZE="1", RANK="0", LOCAL_RANK="0"))


def data_parallel_cli(run: CliRun, plain: dict) -> dict:
    """(c) :func:`start_mesh_cli`'s run against the plain ``train``
    command (phase 14's ``--device-data always`` run, whose JSON is
    ``plain``): epoch and step losses equal."""
    lines = run.lines()
    mesh = json.loads(lines[-1])
    print(f"check train --mesh 1,1,1 (env://, world size 1): {lines[0]!r}; "
          f"mesh {mesh['mesh']}; epoch losses {mesh['epoch_losses']} vs "
          f"plain {plain['epoch_losses']}; steps/s {mesh['steps_per_sec']:.3f}"
          f" vs {plain['steps_per_sec']:.3f}; launches "
          f"{mesh['kernel_launches']}", flush=True)
    if not lines[0].startswith("distributed: process 0 of 1") \
            or "(nccl)" not in lines[0]:
        fail("train --mesh under env:// did not join an NCCL job")
    if mesh["epoch_losses"] != plain["epoch_losses"] \
            or mesh["step_losses"] != plain["step_losses"]:
        fail("train --mesh 1,1,1 in a job parts from the plain train")
    return {"launches": mesh["kernel_launches"],
            "steps_per_sec": [mesh["steps_per_sec"], plain["steps_per_sec"]]}


def phase_data_parallel(cuda_gru, host: dict) -> dict:
    """Phase 15: the mesh's data axis on torch.distributed (after phase
    14, whose plain ``train`` run (c) repeats under a job, and beside
    whose demo (b)'s gloo ranks ran)."""
    from deeprest_tpu_torch.data.featurize import FeaturizedData

    data = FeaturizedData.load(host["beside_demo"]["feats"])
    secs = {}
    t0 = time.perf_counter()
    nccl = data_parallel_nccl(cuda_gru, data)
    secs["nccl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gloo = data_parallel_gloo(cuda_gru, data, host["beside_demo"])
    secs["gloo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = data_parallel_cli(host["cli"]["mesh"], host["cli"]["staged"])
    secs["cli"] = time.perf_counter() - t0
    launches = dict(nccl["launches"])
    for part in (gloo["launches"], cli["launches"]):
        for name in launches:
            launches[name] += part[name]
    print(f"main data axis phase: seconds {rounded(secs)}; launches "
          f"{launches}", flush=True)
    return {"launches": launches, "nccl": nccl, "gloo": gloo, "cli": cli,
            "seconds": secs}


# Phase 16: the expert and model axes, two gloo ranks sharing the card.
AXES_TRAIN_MESH = (1, 2, 1)         # flagship E=40: 20 experts a rank
AXES_TENK_MESH = (1, 1, 2)          # F=10240: w_ih [40, 5120, 384] a rank
AXES_SERVE_MESHES = ((1, 2, 1), (1, 1, 2))
# 5 steps of B=32 in an epoch: int((1,440 - 60) x 0.1100) = 151 windows
TENK_SPLIT_5_STEPS = 0.1100
AXES_STATE_RATIO = 0.55             # a TP rank's params + Adam vs one device's


def state_bytes(state) -> int:
    """Bytes of a train state's params and Adam's two moments."""
    total = 0
    for p in state.model.parameters():
        total += p.numel() * p.element_size()
        for key in ("exp_avg", "exp_avg_sq"):
            m = state.optimizer.state.get(p, {}).get(key)
            if m is not None:
                total += m.numel() * m.element_size()
    return total


def axes_eager_run(trainer, bundle, params) -> dict:
    """One epoch of eager updates on ``trainer``'s mesh from the whole
    ``params``: per-step losses, the first update's gradients and the
    final params gathered whole (every rank must call it), K2/K3 launches,
    the state's bytes and ``memory_allocated`` after the epoch, seconds."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.models.qrnn import param_shapes
    from deeprest_tpu_torch.ops import cuda_gru
    from deeprest_tpu_torch.parallel.sharding import gather_params

    shapes = param_shapes(trainer.model_config)
    mesh = trainer.mesh if trainer.mesh.group is not None else None

    def whole(tensors):
        if mesh is not None:
            tensors = gather_params(mesh, tensors, shapes)
        return {n: t.detach().cpu().numpy().copy()
                for n, t in tensors.items()}

    grads = {}
    state = trainer.init_state(params)

    def on_step(global_step):
        if global_step == 1:
            grads.update(whole({n: p.grad for n, p
                                in state.model.named_parameters()}))

    staged = trainer.stage_dataset(bundle)
    for k in cuda_gru.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    state, _ = trainer.train_epoch(state, bundle, np.random.default_rng(SEED),
                                   staged, on_step=on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_gru.KERNELS}
    return {"losses": trainer.last_epoch_losses, "grads": grads,
            "params": whole(state.params), "launches": launches,
            "state_bytes": state_bytes(state),
            "allocated": torch.cuda.memory_allocated(),
            "seconds": seconds}


def axes_distances(got: dict, want: dict) -> dict:
    """The mesh run ``got`` against world size 1's ``want``: grads and
    params as worst fractions of leaf scale, losses' max |diff| and the
    DP_* tolerances' verdicts."""
    import numpy as np

    return {
        "grad_dist": leaf_distance(got["grads"], want["grads"]),
        "param_dist": leaf_distance(got["params"], want["params"]),
        "loss_max_abs": float(np.abs(got["losses"] - want["losses"]).max()),
        "loss_ok": bool(np.allclose(got["losses"], want["losses"],
                                    rtol=DP_LOSS_TOL[0],
                                    atol=DP_LOSS_TOL[1])),
        "params_ok": all(bool(np.allclose(got["params"][k], v,
                                          rtol=DP_PARAM_TOL[0],
                                          atol=DP_PARAM_TOL[1]))
                         for k, v in want["params"].items()),
        "steps": len(want["losses"])}


def axes_train_case(data, mesh_shape, features: int, split: float,
                    rank: int) -> dict:
    """One mesh's training case inside a rank of the phase-16 job: the
    eager epoch on the mesh, then (rank 0, the other rank waiting at a
    barrier) world size 1 on the same params and data, compared there:
    only numbers leave the rank."""
    import torch

    from deeprest_tpu_torch.config import MeshConfig
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MeshConfig(*mesh_shape), device="cuda")
    trainer, bundle = dp_trainer(data, mesh, "float32", 0.0, split,
                                 features=features, steps_per_superstep=1)
    params = init_params(trainer.model_config, SEED)
    run = axes_eager_run(trainer, bundle, params)
    del trainer
    free_device()
    out = {"launches": run["launches"], "state_bytes": run["state_bytes"],
           "allocated": run["allocated"], "seconds": run["seconds"],
           "experts": FLAGSHIP["E"] // mesh_shape[1],
           "features": features // mesh_shape[2]}
    if rank == 0:
        single_trainer, bundle = dp_trainer(
            data, no_group_mesh(), "float32", 0.0, split,
            features=features, steps_per_superstep=1)
        single = axes_eager_run(single_trainer, bundle, params)
        del single_trainer
        free_device()
        out.update(axes_distances(run, single),
                   single_state_bytes=single["state_bytes"],
                   single_allocated=single["allocated"],
                   single_seconds=single["seconds"])
    torch.distributed.barrier()
    return out


def axes_serve_case(mesh_shape, ckpt: str, traffic) -> dict:
    """The Predictor on ``mesh_shape`` (eager: gloo cannot be captured),
    bf16, phase 5's checkpoint and day: the answer and K1's launches."""
    import numpy as np

    from deeprest_tpu_torch.config import MeshConfig
    from deeprest_tpu_torch.ops import cuda_gru
    from deeprest_tpu_torch.serve.predictor import Predictor

    for k in cuda_gru.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(ckpt, device="cuda", cuda_graphs=False,
                                     mesh_config=MeshConfig(*mesh_shape))
    answer = np.asarray(pred.predict_series(traffic))
    out = {"answer": answer, "launches": cuda_gru.GRU_FWD.launches,
           "seconds": time.perf_counter() - t0,
           "params_digest": pred.params_digest()}
    del pred
    free_device()
    return out


def axes_rank_main(rank: int, world: int, port: int, feats: str,
                   tenk_feats: str, ckpt: str, traffic_path: str,
                   out: str) -> None:
    """One rank of phase 16's gloo job on the card (spawned): (a) the
    flagship on AXES_TRAIN_MESH, (b) the 10k width on AXES_TENK_MESH, (c)
    the Predictor on each of AXES_SERVE_MESHES; the numbers go to
    ``out`` as JSON, the answers beside it."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank, backend="gloo",
                           device="cuda")
    result = {"device": str(torch.device("cuda", torch.cuda.current_device()))}
    result["train"] = axes_train_case(FeaturizedData.load(feats),
                                      AXES_TRAIN_MESH, F, SPLIT_10_STEPS,
                                      rank)
    result["tenk"] = axes_train_case(FeaturizedData.load(tenk_feats),
                                     AXES_TENK_MESH, TENK_F,
                                     TENK_SPLIT_5_STEPS, rank)
    traffic = np.load(traffic_path)
    answers = {}
    for shape in AXES_SERVE_MESHES:
        label = "x".join(map(str, shape))
        case = axes_serve_case(shape, ckpt, traffic)
        answers[label] = case.pop("answer")
        result[f"serve {label}"] = case
    np.savez(out + ".npz", **answers)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(result, fh)
    torch.distributed.destroy_process_group()


def axes_k2_k3_ms(cuda_gru) -> dict:
    """K2 and K3 in f32 at E=20, B=32 (an expert rank's share of the
    flagship), CUDA events: recorded beside phase 4's E=40 times."""
    import torch

    shape = dict(TRAIN, E=FLAGSHIP["E"] // AXES_TRAIN_MESH[1])
    args = recurrence_inputs(shape, torch.float32)
    proj, w_hh, b_hh, _ = args
    h_all, h_prev, gates = cuda_gru.gru_fwd_train_cuda(*args)
    bwd_in = (proj, h_prev, gates, w_hh, b_hh, torch.ones_like(h_all))
    out = {"gru_fwd_train": time_ms(lambda: cuda_gru.gru_fwd_train_cuda(
        *args), iters=20),
           "gru_bwd": time_ms(lambda: cuda_gru.gru_bwd_cuda(*bwd_in),
                              iters=20)}
    del args, proj, w_hh, b_hh, h_all, h_prev, gates, bwd_in
    free_device()
    return out


def phase_expert_model_axes(cuda_gru, serving: dict, workdir: str) -> dict:
    """Phase 16: the mesh's expert and model axes, two gloo ranks sharing
    the card (run after phase 15): (a) training on AXES_TRAIN_MESH at the
    flagship, (b) on AXES_TENK_MESH at the 10k width, each against world
    size 1; (c) the Predictor on AXES_SERVE_MESHES against phase 5's
    captured one-process answer."""
    import multiprocessing

    import numpy as np

    wd = os.path.join(workdir, "expert_model_axes")
    os.makedirs(wd)
    feats = flagship_corpus(os.path.join(wd, "corpus.npz"))
    tenk_feats = tenk_corpus(os.path.join(wd, "tenk.npz"))
    traffic_path = os.path.join(wd, "day.npy")
    np.save(traffic_path, serving["traffic"])
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(wd, f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=axes_rank_main,
                         args=(r, 2, port, feats, tenk_feats,
                               serving["ckpt"], traffic_path, outs[r]))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    wall = time.perf_counter() - t0
    if [p.exitcode for p in procs] != [0, 0]:
        fail(f"phase 16's gloo ranks exited {[p.exitcode for p in procs]}")
    ranks = []
    for path in outs:
        with open(path, encoding="utf-8") as fh:
            ranks.append(json.load(fh))
    launches = dict.fromkeys((k.name for k in cuda_gru.MODEL_KERNELS), 0)
    for r in ranks:
        for case in ("train", "tenk"):
            for name in ("gru_fwd_train", "gru_bwd"):
                launches[name] += r[case]["launches"][name]
        for shape in AXES_SERVE_MESHES:
            launches["gru_fwd"] += r[f"serve {'x'.join(map(str, shape))}"][
                "launches"]
    out = {"launches": launches, "wall": wall}
    for case, shape in (("train", AXES_TRAIN_MESH),
                        ("tenk", AXES_TENK_MESH)):
        c = ranks[0][case]
        label = "x".join(map(str, shape))
        ratios = [r[case]["state_bytes"] / c["single_state_bytes"]
                  for r in ranks]
        print(f"check {case} on mesh {label} (gloo world size 2 on one card, "
              f"not NCCL across cards; f32, dropout 0, {c['steps']} eager "
              f"steps; {c['experts']} experts and {c['features']} features "
              f"a rank) vs world size 1: first update's grads "
              f"{c['grad_dist']:.3e} of leaf scale (tol {DP_GRAD_TOL}); "
              f"losses max abs {c['loss_max_abs']:.3e} (rtol "
              f"{DP_LOSS_TOL[0]}, atol {DP_LOSS_TOL[1]}: {c['loss_ok']}); "
              f"final params {c['param_dist']:.3e} of leaf scale (rtol "
              f"{DP_PARAM_TOL[0]}, atol {DP_PARAM_TOL[1]}: {c['params_ok']}); "
              f"launches rank 0 {ranks[0][case]['launches']}, rank 1 "
              f"{ranks[1][case]['launches']}; params + Adam bytes per rank "
              f"{[r[case]['state_bytes'] for r in ranks]} vs world size 1 "
              f"{c['single_state_bytes']} (ratios "
              f"{[round(x, 4) for x in ratios]}); memory_allocated per rank "
              f"{[r[case]['allocated'] for r in ranks]} vs world size 1 "
              f"{c['single_allocated']}; epoch seconds per rank "
              f"{[round(r[case]['seconds'], 3) for r in ranks]} vs "
              f"{c['single_seconds']:.3f}", flush=True)
        if c["grad_dist"] > DP_GRAD_TOL or not c["loss_ok"] \
                or not c["params_ok"]:
            fail(f"{case} on mesh {label} parts from world size 1 beyond "
                 "the stated tolerances")
        for r, rank in enumerate(ranks):
            for name in ("gru_fwd_train", "gru_bwd"):
                # one launch a direction a step
                if rank[case]["launches"][name] != 2 * c["steps"]:
                    fail(f"rank {r} launched {name} "
                         f"{rank[case]['launches'][name]} times in "
                         f"{c['steps']} steps of {case}")
        if case == "tenk" and max(ratios) > AXES_STATE_RATIO:
            fail(f"a model-axis rank holds {max(ratios):.3f} of world size "
                 f"1's params and Adam state; want at most "
                 f"{AXES_STATE_RATIO}")
        out[case] = {**c, "rank_state_bytes": [r[case]["state_bytes"]
                                                for r in ranks],
                     "rank_allocated": [r[case]["allocated"] for r in ranks],
                     "rank_seconds": [r[case]["seconds"] for r in ranks],
                     "state_ratios": ratios}
    want = serving["answer"]
    delta = serving["delta"]
    digest = None
    for shape in AXES_SERVE_MESHES:
        label = "x".join(map(str, shape))
        answers = []
        for path in outs:
            with np.load(path + ".npz") as z:
                answers.append(np.asarray(z[label]))
        errs = {}
        for cols, name in ((~delta, "non-delta"), (delta, "delta")):
            scale = np.abs(want[:, cols]).max()
            errs[name] = float(np.abs(answers[0][:, cols]
                                      - want[:, cols]).max() / scale)
        same = np.array_equal(answers[0], answers[1])
        cases = [r[f"serve {label}"] for r in ranks]
        print(f"check Predictor on mesh {label} (gloo world size 2 on one "
              f"card, eager, bf16) vs phase 5's captured one-process answer "
              f"on the day: {errs} of scale (tol {TOL['bfloat16'][0]}); "
              f"ranks' answers equal {same}; gru_fwd launches per rank "
              f"{[c['launches'] for c in cases]}; seconds per rank "
              f"{[round(c['seconds'], 3) for c in cases]}; params_digest "
              f"{cases[0]['params_digest']}", flush=True)
        if max(errs.values()) > TOL["bfloat16"][0] or not same:
            fail(f"the Predictor on mesh {label} parts from one process or "
                 "between its ranks")
        if answers[0].shape != want.shape or \
                not np.isfinite(answers[0]).all():
            fail(f"the Predictor on mesh {label} gave shape "
                 f"{answers[0].shape} or non-finite values")
        if any(c["launches"] == 0 for c in cases):
            fail(f"a rank of mesh {label} never launched gru_fwd")
        if digest is not None and cases[0]["params_digest"] != digest:
            fail("the meshes' params digests differ")
        digest = cases[0]["params_digest"]
        out[f"serve {label}"] = {"errors": errs,
                                 "launches": [c["launches"] for c in cases],
                                 "seconds": [c["seconds"] for c in cases]}
        out.setdefault("answers", {})[label] = answers[0]
    print(f"main expert and model axes phase: launches {launches}; "
          f"{wall:.1f} s wall for the job with its spawn", flush=True)
    return out


def axes_k2_k3_times(cuda_gru, times: dict) -> dict:
    """K2 and K3 in f32 at an expert rank's share of the flagship, beside
    phase 3's E=40 times; recorded only."""
    k_ms = axes_k2_k3_ms(cuda_gru)
    print(f"times K2/K3 float32 at E={FLAGSHIP['E'] // AXES_TRAIN_MESH[1]}, "
          f"B={TRAIN['B']} (an expert rank's share): gru_fwd_train "
          f"{k_ms['gru_fwd_train']:.4f} ms, gru_bwd {k_ms['gru_bwd']:.4f} ms "
          f"(E=40: {times['gru_fwd_train']['float32']['ms']:.4f}, "
          f"{times['gru_bwd']['float32']['ms']:.4f}); recorded only",
          flush=True)
    return k_ms





# Phase 17: elastic remeshing, two gloo ranks sharing the card.
ELASTIC_ARMS = ("injector", "refusal", "sigkill")   # rank 1 dies in the last
ELASTIC_K = 5                   # the global step of the loss, mid-epoch
ELASTIC_SNAPSHOT_EVERY = 2


def elastic_steps_per_sec(stamps: list) -> tuple:
    """Steps/s before and after the loss from ``on_step``'s ``(global
    step, host seconds)`` stamps, the remesh marked by None (a snapshot
    write every 2 steps included): each segment from its second step on."""
    cut = stamps.index(None) if None in stamps else len(stamps)

    def rate(seg):
        if len(seg) < 3:
            return None
        return (seg[-1][0] - seg[1][0]) / (seg[-1][1] - seg[1][1])

    return rate(stamps[:cut]), rate(stamps[cut + 1:])


def elastic_arm(arm: str, rank: int, feats: str, wd: str) -> dict:
    """One arm of phase 17 on this rank (see :func:`phase_elastic`); the
    survivor of (a) and (b) then resumes a trainer with no process group
    from its restored snapshot and holds the two runs' params and losses
    bit for bit."""
    import shutil
    import signal

    import numpy as np
    import torch

    from deeprest_tpu_torch.config import MeshConfig
    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.ops import cuda_gru
    from deeprest_tpu_torch.parallel import FaultInjector, make_mesh

    mesh = make_mesh(MeshConfig(*((1, 2, 1) if arm == "refusal"
                                  else (2, 1, 1))), device="cuda")
    ckpt = os.path.join(wd, f"{arm}_snap")
    train = dict(steps_per_superstep=1, checkpoint_dir=ckpt,
                 snapshot_every_steps=ELASTIC_SNAPSHOT_EVERY,
                 snapshot_keep=0, num_epochs=1)
    data = FeaturizedData.load(feats)
    trainer, bundle = dp_trainer(data, mesh, "bfloat16", 0.0,
                                 SPLIT_10_STEPS, elastic=True,
                                 remesh_backoff_ms=1.0, **train)
    if arm != "sigkill":
        trainer.install_fault_injector(FaultInjector({ELASTIC_K: 1}))
    params = init_params(trainer.model_config, SEED)
    stamps = []
    remesh = trainer.remesh

    def marked(*args, **kwargs):
        stamps.append(None)
        return remesh(*args, **kwargs)

    trainer.remesh = marked

    def on_step(global_step):
        torch.cuda.synchronize()
        stamps.append((global_step, time.perf_counter()))
        if arm == "sigkill" and rank == 1 and global_step == ELASTIC_K:
            os.kill(os.getpid(), signal.SIGKILL)

    for k in cuda_gru.KERNELS:
        k.launches = 0
    out = {"outcome": "done", "device": str(trainer.device)}
    t0 = time.perf_counter()
    try:
        state, hist = trainer.fit(bundle, state=trainer.init_state(params),
                                  on_step=on_step)
    except Exception as exc:        # the parent holds the outcome to the arm
        out.update(outcome=type(exc).__name__, error=str(exc))
        state = None
    torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0,
               launches={k.name: k.launches for k in cuda_gru.KERNELS},
               history=trainer.remesh_history, stamps=stamps,
               steps_per_sec=elastic_steps_per_sec(stamps),
               stood_down=trainer.stood_down)
    if state is None or trainer.stood_down:
        return out
    losses = trainer.last_epoch_losses
    restored = trainer.last_remesh["restored_step"]
    cut = os.path.join(wd, f"{arm}_cut")
    os.makedirs(cut)
    shutil.copytree(os.path.join(ckpt, f"step_{restored:08d}"),
                    os.path.join(cut, f"step_{restored:08d}"))
    ref, _ = dp_trainer(data, no_group_mesh(), "bfloat16", 0.0,
                        SPLIT_10_STEPS, **dict(train, checkpoint_dir=cut))
    ref_state, ref_hist = ref.resume_training(bundle, cut)
    got = {n: p.detach().float().cpu().numpy() for n, p in
           state.params.items()}
    want = {n: p.detach().float().cpu().numpy() for n, p in
            ref_state.params.items()}
    out.update(
        mesh=dict(trainer.mesh.shape), step=int(state.step),
        params_equal=all(np.array_equal(got[n], want[n]) for n in want),
        params_max_abs=max(float(np.abs(got[n] - want[n]).max())
                           for n in want),
        losses_equal=bool(np.array_equal(losses, ref.last_epoch_losses)),
        test_loss=[hist[-1].test_loss, ref_hist[-1].test_loss],
        finite=bool(all(np.isfinite(v).all() for v in got.values())
                    and np.isfinite(losses).all()))
    del trainer, state, ref, ref_state
    free_device()
    return out


def elastic_rank_main(rank: int, ports: list, feats: str, wd: str) -> None:
    """One rank of phase 17 (spawned): each arm in a job of its own, on
    ``ports``, its result written to ``wd/<arm>_rank<rank>.json``."""
    import torch

    sys.path.insert(0, REPO)
    from deeprest_tpu_torch.parallel import initialize_distributed
    from deeprest_tpu_torch.parallel.distributed import leave_job

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arm, port in zip(ELASTIC_ARMS, ports):
        initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                               world_size=2, rank=rank, backend="gloo",
                               device="cuda")
        result = elastic_arm(arm, rank, feats, wd)
        with open(os.path.join(wd, f"{arm}_rank{rank}.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(result, fh)
        leave_job()


def phase_elastic(cuda_gru, workdir: str) -> dict:
    """Phase 17: elastic remeshing (run after phase 16), two spawned gloo
    ranks sharing the card, the flagship (B=32, T=60, F=512, E=40, H=128,
    bidirectional, bf16, dropout 0), 10 eager steps, a cursor snapshot
    every 2, the loss at step 5: (a) ``FaultInjector({5: 1})`` on mesh
    2,1,1: rank 1 leaves with DeviceLossError, rank 0 remeshes to 1,1,1
    and finishes; (b) rank 1 SIGKILLs itself from ``on_step`` at step 5:
    rank 0 notices through gloo, takes the census, remeshes, restores and
    finishes; each survivor bit for bit ``resume_training`` with no process
    group from its restored step; (c) a 1,2,1 job losing rank 1 raises
    NoValidMeshError naming the expert axis on rank 0."""
    import multiprocessing

    wd = os.path.join(workdir, "elastic")
    os.makedirs(wd)
    feats = flagship_corpus(os.path.join(wd, "corpus.npz"))
    ctx = multiprocessing.get_context("spawn")
    ports = [free_port() for _ in ELASTIC_ARMS]
    procs = [ctx.Process(target=elastic_rank_main,
                         args=(r, ports, feats, wd)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    wall = time.perf_counter() - t0
    if [p.exitcode for p in procs] != [0, -9]:
        fail(f"phase 17's ranks exited {[p.exitcode for p in procs]}; want "
             "[0, -9] (rank 1 SIGKILLs itself in the last arm)")
    arms = {}
    for arm in ELASTIC_ARMS:
        ranks = []
        for r in range(2):
            path = os.path.join(wd, f"{arm}_rank{r}.json")
            if os.path.exists(path):
                with open(path, encoding="utf-8") as fh:
                    ranks.append(json.load(fh))
            else:
                ranks.append(None)
        arms[arm] = ranks
    launches = dict.fromkeys((k.name for k in cuda_gru.MODEL_KERNELS), 0)
    out = {"wall": wall}
    for arm, ranks in arms.items():
        for res in ranks:
            if res is not None:
                for name in launches:
                    launches[name] += res["launches"][name]
        r0, r1 = ranks
        hist = r0["history"]
        before, after = r0["steps_per_sec"]
        print(f"check elastic {arm} (gloo world size 2 on one card; "
              f"flagship bf16, dropout 0, loss at step {ELASTIC_K}): rank 0 "
              f"{r0['outcome']}, rank 1 "
              f"{'SIGKILLed' if r1 is None else r1['outcome']}; remeshes "
              f"{hist}; K2/K3 launches rank 0 "
              f"{r0['launches']['gru_fwd_train']}/{r0['launches']['gru_bwd']}"
              + ("" if r1 is None else
                 f", rank 1 {r1['launches']['gru_fwd_train']}/"
                 f"{r1['launches']['gru_bwd']}")
              + f"; steps/s before {before} after {after} (host clock "
              f"between on_step calls, snapshot writes included); "
              f"{r0['seconds']:.2f} s", flush=True)
        if arm == "refusal":
            if r0["outcome"] != "NoValidMeshError" \
                    or "expert" not in r0.get("error", ""):
                fail(f"the 1,2,1 job that lost rank 1 gave {r0['outcome']} "
                     f"({r0.get('error')}) on rank 0, not NoValidMeshError "
                     "naming the expert axis")
            out[arm] = {"error": r0["error"], "seconds": r0["seconds"]}
            continue
        print(f"check elastic {arm} survivor vs resume_training with no "
              f"process group from step {hist[0]['restored_step'] if hist else None}: "
              f"params bit-identical {r0.get('params_equal')} (max abs "
              f"{r0.get('params_max_abs')}), last epoch's losses equal "
              f"{r0.get('losses_equal')}, test loss {r0.get('test_loss')}",
              flush=True)
        if r0["outcome"] != "done" or len(hist) != 1 \
                or hist[0]["mesh"] != {"data": 1, "expert": 1, "model": 1}:
            fail(f"elastic {arm}: rank 0 {r0['outcome']} "
                 f"({r0.get('error')}), remeshes {hist}; want one remesh "
                 "to 1,1,1 and a finished run")
        if arm == "injector" and (r1 is None
                                  or r1["outcome"] != "DeviceLossError"):
            fail("elastic injector: rank 1 did not leave with "
                 "DeviceLossError")
        if not (r0["params_equal"] and r0["losses_equal"] and r0["finite"]
                and r0["step"] == 10):
            fail(f"elastic {arm}: the survivor parts from resume_training "
                 "from its restored step, or its run is not finite or "
                 "complete")
        if r0["launches"]["gru_fwd_train"] == 0 \
                or r0["launches"]["gru_bwd"] == 0:
            fail(f"elastic {arm}: K2 or K3 never launched on the survivor")
        out[arm] = {"recovery_s": hist[0]["recovery_s"],
                    "restored_step": hist[0]["restored_step"],
                    "steps_per_sec": [before, after],
                    "seconds": r0["seconds"],
                    "launches": r0["launches"]}
    print(f"main elastic phase: launches {launches}; {wall:.1f} s wall for "
          f"the job with its spawn", flush=True)
    out["launches"] = launches
    return out


# the raw side's native tools (phase 18): the social corpus hashed as the
# stream hashes it, a synthetic app's corpus hashed at the 10k tier's width
RAW_SIDE_HASH_F = 512
RAW_SIDE_SYNTH = dict(services=200, endpoints=1000, buckets=200,
                      calls_per_user=0.4)
LOADGEN_TICKS, LOADGEN_TICK_S = 3, 1.0


class StubGateway:
    """An HTTP server in this process standing in for snsd's two gateways:
    it answers every request 200 and counts them by path."""

    def __init__(self):
        import collections
        import http.server
        import threading
        import urllib.parse

        paths = self.paths = collections.Counter()
        lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def serve(self):
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)
                path = urllib.parse.urlsplit(self.path).path
                with lock:
                    paths[path] += 1
                body = (b'{"media_id": "m1"}' if path == "/upload-media"
                        else b'{"ok": true}')
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = serve

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def spec(self) -> str:
        host, port = self.server.server_address[:2]
        return f"{host}:{port}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class StubCollector:
    """A socket in this process standing in for the trace collector: it
    keeps each registration frame (4-byte big-endian length, JSON) with
    the registered process's parent pid and command line, read from /proc
    when the frame arrives."""

    def __init__(self):
        import socket
        import threading

        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.frames = []
        self.thread = threading.Thread(target=self._accept, daemon=True)
        self.thread.start()

    @property
    def spec(self) -> str:
        host, port = self.sock.getsockname()
        return f"{host}:{port}"

    def _accept(self) -> None:
        import struct

        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                data = b""
                while chunk := conn.recv(65536):
                    data += chunk
            (length,) = struct.unpack(">I", data[:4])
            frame = json.loads(data[4:4 + length])
            frame["length_ok"] = len(data) == 4 + length
            try:
                with open(f"/proc/{frame['pid']}/status",
                          encoding="utf-8") as fh:
                    frame["ppid"] = int(next(
                        ln for ln in fh if ln.startswith("PPid:")).split()[1])
                with open(f"/proc/{frame['pid']}/cmdline", "rb") as fh:
                    frame["cmdline"] = fh.read().decode().split("\0")
            except (OSError, StopIteration, KeyError) as e:
                frame["proc_error"] = repr(e)
            self.frames.append(frame)

    def close(self) -> None:
        self.sock.close()


def featurized_agreement(got, want) -> str:
    """How the native ETL's output stands against the numpy featurizer's,
    with the JAX package's native-parity tolerances (traffic bit-equal,
    resources rtol 1e-6, invocations, vocabulary and capacity equal); an
    empty string when they agree."""
    import numpy as np

    if got.traffic.shape != want.traffic.shape:
        return f"traffic shape {got.traffic.shape} != {want.traffic.shape}"
    if not np.array_equal(got.traffic, want.traffic):
        return "traffic differs"
    if got.space.frozen_capacity != want.space.capacity:
        return (f"frozen_capacity {got.space.frozen_capacity} != "
                f"{want.space.capacity}")
    if got.space.vocabulary() != want.space.vocabulary():
        return "vocabulary differs"
    if list(got.resources) != list(want.resources):
        return "metric keys differ"
    for k, v in want.resources.items():
        if not np.allclose(got.resources[k], v, rtol=1e-6, atol=0.0,
                           equal_nan=True):
            return f"resources[{k!r}] differs past rtol 1e-6"
    if set(got.invocations) != set(want.invocations):
        return "invocation components differ"
    for k, v in want.invocations.items():
        if not np.array_equal(got.invocations[k], v):
            return f"invocations[{k!r}] differs"
    return ""


def phase_raw_side(cuda_gru, raw_path: str, social_ckpt: str,
                   workdir: str) -> dict:
    """Phase 18: the raw side's native tools.  (a) ``libdeeprest_etl``
    built from native/featurizer.cpp into build/native/ (g++, the flags of
    native/Makefile); (b) phase 7's corpus featurized through
    ``data/native.py`` and through the numpy ``featurize_buckets`` (its
    JSONL load apart), in dictionary mode and hashed into 512 columns, and
    a synthetic app's corpus hashed into 10,240: native = numpy with the
    JAX package's native-parity tolerances, and in hash mode the traffic
    alone through the warm vectorized ``extract``; (c) phase 7's checkpoint
    serving the natively featurized corpus on the card through K1, bit for
    bit its answers on the numpy-featurized one; (d) ``python -m
    deeprest_tpu_torch.loadgen`` in crypto mode against stub gateways and
    a stub collector in this process: exit 0, its JSON line, one
    registration frame carrying the pid of its burner child."""
    import gc

    import numpy as np
    import torch

    from deeprest_tpu_torch.config import FeaturizeConfig
    from deeprest_tpu_torch.data import native
    from deeprest_tpu_torch.data.featurize import (
        CallPathSpace, featurize_buckets,
    )
    from deeprest_tpu_torch.data.schema import (
        load_raw_data, save_raw_data_jsonl,
    )
    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.workload import normal_scenario
    from deeprest_tpu_torch.workload.simulator import (
        build_synthetic_app, simulate_corpus,
    )

    t_phase = time.perf_counter()
    wd = os.path.join(workdir, "raw_side")
    os.makedirs(wd)
    secs = {}

    # (a) the build, from the checkout's source (a stale copy is removed
    # so the seconds are a build's)
    os.environ.pop(native.ENV_OVERRIDE, None)
    lib_path = native.library_path()
    if os.path.exists(lib_path):
        os.remove(lib_path)
    t0 = time.perf_counter()
    native.build_library()
    secs["build"] = time.perf_counter() - t0
    lib = native.load_library()
    if lib._name != lib_path or not lib_path.startswith(
            os.path.join(REPO, "build", "native") + os.sep):
        fail(f"the native ETL loaded {lib._name}; want {lib_path}")
    print(f"raw side build: {os.path.relpath(lib_path, REPO)} from "
          f"native/featurizer.cpp with {native.compiler()} "
          f"{' '.join(native.CXX_FLAGS)} in {secs['build']:.2f} s",
          flush=True)

    # (b) native against numpy, per corpus and mode
    def both(label, path, buckets, cfg):
        t0 = time.perf_counter()
        got = native.featurize_jsonl(path, cfg)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = featurize_buckets(buckets, cfg)
        t_numpy = time.perf_counter() - t0
        secs[f"{label} native"] = t_native
        secs[f"{label} numpy"] = t_numpy
        bad = featurized_agreement(got, want)
        print(f"check raw side {label}: {got.traffic.shape[0]} buckets x "
              f"F={got.traffic.shape[1]}, {len(got.resources)} metrics; "
              f"native {t_native:.3f} s, numpy featurize_buckets "
              f"{t_numpy:.3f} s (native/numpy {t_native / t_numpy:.3f}); "
              f"{'agree' if not bad else 'DISAGREE: ' + bad}", flush=True)
        if bad:
            fail(f"the native ETL disagrees with the numpy featurizer on "
                 f"{label}: {bad}")
        if cfg.hash_features:
            # the traffic alone through the vectorized path, its
            # path->column memo warm (benchmarks/etl_bench.py's native arm)
            space = CallPathSpace(config=cfg)
            for b in buckets:
                space.extract(b.traces)
            t0 = time.perf_counter()
            for b in buckets:
                space.extract(b.traces)
            t_vec = time.perf_counter() - t0
            secs[f"{label} vectorized"] = t_vec
            n = len(buckets)
            print(f"raw side {label} traffic: native {n / t_native:.1f} "
                  f"buckets/s (parse included), the warm vectorized extract "
                  f"{n / t_vec:.1f} buckets/s (parse excluded); native/"
                  f"vectorized {t_vec / t_native:.3f}", flush=True)
        return got, want

    t0 = time.perf_counter()
    buckets = load_raw_data(raw_path)
    secs["social load"] = time.perf_counter() - t0
    mb = os.path.getsize(raw_path) / 1e6
    print(f"raw side social corpus: {len(buckets)} buckets, {mb:.1f} MB of "
          f"JSONL; the numpy path's load_raw_data {secs['social load']:.3f}"
          f" s", flush=True)
    by_native, by_numpy = both("social dict", raw_path, buckets,
                               FeaturizeConfig())
    both("social hash", raw_path, buckets,
         FeaturizeConfig(hash_features=True, capacity=RAW_SIDE_HASH_F))
    del buckets

    syn = RAW_SIDE_SYNTH
    t0 = time.perf_counter()
    scn = normal_scenario(SEED)
    scn.calls_per_user = syn["calls_per_user"]
    app, endpoints = build_synthetic_app(scn, syn["services"],
                                         syn["endpoints"], SEED)
    synth_path = os.path.join(wd, "synthetic.jsonl")
    synth = simulate_corpus(scn, syn["buckets"], app=app,
                            endpoints=endpoints)
    save_raw_data_jsonl(synth, synth_path)
    secs["synthetic simulate"] = time.perf_counter() - t0
    paths = len({p for b in synth for t in b.traces for p, _ in t.walk()})
    del synth
    t0 = time.perf_counter()
    synth = load_raw_data(synth_path)
    secs["synthetic load"] = time.perf_counter() - t0
    print(f"raw side synthetic corpus: {syn['services']} services, "
          f"{syn['endpoints']} endpoints, {syn['buckets']} buckets, {paths} "
          f"distinct call paths, {os.path.getsize(synth_path) / 1e6:.1f} MB;"
          f" simulated and written in {secs['synthetic simulate']:.2f} s, "
          f"load_raw_data {secs['synthetic load']:.3f} s", flush=True)
    tenk, _ = both("synthetic hash", synth_path, synth,
                   FeaturizeConfig(hash_features=True, capacity=TENK_F))
    print(f"raw side synthetic hash: {int((tenk.traffic.sum(0) > 0).sum())}"
          f" of {TENK_F} columns hit", flush=True)
    del synth, tenk

    # (c) phase 7's checkpoint on the natively featurized corpus, on K1
    for k in cuda_gru.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(social_ckpt, device="cuda")
    space = pred.space()
    if (space.vocabulary() != by_native.space.vocabulary()
            or space.capacity != by_native.space.capacity
            or pred.metric_names != by_native.metric_names):
        fail("the natively featurized corpus's space or metrics differ "
             "from phase 7's checkpoint's")
    y_native = pred.predict_series(by_native.traffic)
    y_numpy = pred.predict_series(by_numpy.traffic)
    torch.cuda.synchronize()
    secs["serve"] = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_gru.MODEL_KERNELS}
    same = np.array_equal(y_native, y_numpy)
    print(f"check raw side served: phase 7's checkpoint on the natively "
          f"featurized corpus {y_native.shape} bit for bit the numpy "
          f"corpus's {same}, finite {bool(np.isfinite(y_native).all())}; "
          f"launches {launches}; {secs['serve']:.2f} s with the load",
          flush=True)
    if not same or not np.isfinite(y_native).all():
        fail("phase 7's checkpoint answers the natively featurized corpus "
             "differently from the numpy one")
    if launches["gru_fwd"] == 0:
        fail("serving the natively featurized corpus never launched gru_fwd")
    del pred, by_native, by_numpy
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the load generator's capture CLI against stubs
    gateway, collector = StubGateway(), StubCollector()
    try:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeprest_tpu_torch.loadgen",
             "--target", gateway.spec, "--media", gateway.spec,
             "--collector", collector.spec, "--burn-local",
             "--scenario", "crypto", "--ticks", str(LOADGEN_TICKS),
             "--tick-seconds", str(LOADGEN_TICK_S), "--seed", str(SEED)],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            out, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        secs["loadgen"] = time.perf_counter() - t0
        time.sleep(0.2)               # the collector thread's last append
        frames = list(collector.frames)
        paths_seen = dict(gateway.paths)
    finally:
        gateway.close()
        collector.close()
    if proc.returncode != 0:
        fail(f"the loadgen CLI exited {proc.returncode}:\n{err[-2000:]}")
    line = json.loads(out.strip().splitlines()[-1])
    burner_file = os.path.join(REPO, "deeprest_tpu_torch", "loadgen",
                               "burner.py")
    print(f"raw side loadgen CLI: {secs['loadgen']:.2f} s; its line {line};"
          f" gateway requests by path {paths_seen}; collector frames "
          f"{frames}", flush=True)
    if line.get("scenario") != "crypto" or "burner_failed" in line or \
            "peak_users" not in line:
        fail(f"the loadgen CLI printed {line}")
    if paths_seen.get("/wrk2-api/user/register", 0) < 96:
        fail("the loadgen CLI's warmup registered fewer than 96 users")
    if len(frames) != 1:
        fail(f"the stub collector received {len(frames)} frames; want 1")
    frame = frames[0]
    if not (frame.get("register") == "compose-post-service"
            and frame.get("length_ok") and frame.get("ppid") == proc.pid
            and burner_file in frame.get("cmdline", [])):
        fail(f"the registration frame {frame} does not carry the pid of "
             f"the CLI's ({proc.pid}) burner child running {burner_file}")
    total = time.perf_counter() - t_phase
    print(f"raw side phase: {total:.1f} s of wall time; seconds "
          f"{rounded(secs)}; launches of this path {launches}", flush=True)
    return {"launches": launches, "seconds": secs, "total_s": total}


# -- phase 19: serve --mesh over two gloo ranks sharing the card ----------

SERVE_MESH = (1, 2, 1)              # the flagship's E=40: 20 experts a rank
SERVE_MESH_DEADLINE_S = 30          # rank 0 stops this long after it listens
SERVE_MESH_LOAD_S = 2.0             # each closed-loop cell


def serve_mesh_rank_main(rank: int, port: int, ckpt: str, out: str) -> None:
    """One rank of phase 19's plane (spawned): ``serve --mesh 1,2,1
    --no-batcher --deadline`` on the card in a gloo job sharing it, its
    output to ``out + ".log"``; then its exit code, K1 launches and peak
    device memory to ``out``."""
    import contextlib

    import torch

    sys.path.insert(0, REPO)
    from deeprest_tpu_torch.cli import main
    from deeprest_tpu_torch.ops import cuda_gru
    from deeprest_tpu_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, backend="gloo",
                           device="cuda")
    with open(out + ".log", "w", encoding="utf-8") as log, \
            contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = main(["serve", "--ckpt-dir", ckpt, "--mesh",
                   ",".join(map(str, SERVE_MESH)), "--no-batcher",
                   "--port", "0", "--deadline", str(SERVE_MESH_DEADLINE_S)])
    with open(out, "w", encoding="utf-8") as fh:
        json.dump({"rc": rc, "launches": cuda_gru.GRU_FWD.launches,
                   "max_allocated": torch.cuda.max_memory_allocated(),
                   "max_reserved": torch.cuda.max_memory_reserved()}, fh)


def phase_serve_mesh(cuda_gru, serving: dict, axes: dict, plane: dict,
                     workdir: str) -> dict:
    """Phase 19: ``serve --mesh 1,2,1`` as two spawned gloo ranks sharing
    the card (eager: gloo's collectives cannot be captured), on phase 5's
    checkpoint: the day against phase 5's captured answer and phase 16's
    1,2,1 Predictor, phase 8's mix against its one-process server, the
    digest, closed loops at PLANE_CONCURRENCY, K1 on both ranks, and both
    ranks' exit at the deadline.  Its kernels launch in its ranks only."""
    import multiprocessing

    import numpy as np

    from deeprest_tpu_torch.serve.predictor import Predictor

    t0 = time.perf_counter()
    wd = os.path.join(workdir, "serve_mesh")
    os.makedirs(wd)
    label = "x".join(map(str, SERVE_MESH))
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(wd, f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=serve_mesh_rank_main,
                         args=(r, port, serving["ckpt"], outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        start = wait_ranks_listening(procs, outs, f"serve --mesh {label}")
        listened = time.perf_counter()
        url = start["listening"]
        if start["mesh"] != list(SERVE_MESH) or start["world"] != 2:
            fail(f"serve --mesh {label}'s startup line names mesh "
                 f"{start['mesh']}, world {start['world']}")
        t_day = time.perf_counter()
        status, body = http_json(url + "/v1/predict",
                                 {"traffic": serving["traffic"].tolist()})
        day_s = time.perf_counter() - t_day
        if status != 200:
            fail(f"serve --mesh {label} /v1/predict answered {status}: "
                 f"{body}")
        got = np.asarray(body["predictions"], np.float32)
        single = []
        for raw in plane["bodies"]:
            status, answer = http_json(url + "/v1/predict", json.loads(raw))
            if status != 200:
                fail(f"serve --mesh {label} /v1/predict answered {status}")
            single.append(answer["predictions"])
        loads = {conc: closed_loop(url, plane["bodies"], conc,
                                   SERVE_MESH_LOAD_S)
                 for conc in PLANE_CONCURRENCY}
        concurrent_answers(f"serve --mesh {label}", loads, single,
                           exact=True)
        status, health = http_json(url + "/healthz")
        client_s = time.perf_counter() - listened
        for p in procs:
            p.join(SERVE_MESH_DEADLINE_S + 120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    wall = time.perf_counter() - t0
    if [p.exitcode for p in procs] != [0, 0]:
        fail(f"serve --mesh {label}'s ranks exited "
             f"{[p.exitcode for p in procs]}")
    ranks = []
    for path in outs:
        with open(path, encoding="utf-8") as fh:
            ranks.append(json.load(fh))
    if [r["rc"] for r in ranks] != [0, 0]:
        fail(f"serve --mesh {label}'s ranks returned "
             f"{[r['rc'] for r in ranks]} at the deadline")
    k1 = [r["launches"] for r in ranks]
    if k1[0] == 0 or k1[0] != k1[1]:
        fail(f"serve --mesh {label}: gru_fwd launches per rank {k1}; want "
             "the same nonzero count on both")
    # the day against phase 5's captured one-process answer and phase 16's
    # 1,2,1 Predictor (the same fused rung: --no-batcher pages every
    # request, as predict_series does)
    delta, want, mesh_answer = (serving["delta"], serving["answer"],
                                axes["answers"][label])
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"serve --mesh {label} gave shape {got.shape} or non-finite "
             "values")
    errs, errs_mesh = {}, {}
    for cols, name in ((~delta, "non-delta"), (delta, "delta")):
        errs[name] = rel_err(got, want, cols)
        errs_mesh[name] = rel_err(got, mesh_answer, cols)
    same = bool(np.array_equal(got, mesh_answer))
    mix_err = max(
        float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
              .max() / max(float(np.abs(np.asarray(b)).max()), 1e-12))
        for a, b in zip(single, plane["single"]))
    digest = Predictor.from_checkpoint(serving["ckpt"], device="cuda",
                                       fused=False).params_digest()
    served = health["fleet"]["tenants"]["default"]["params_digest"]
    print(f"check serve --mesh {label} (gloo world size 2 on one card, "
          f"eager, bf16, --no-batcher) /v1/predict {DAY}x{F} ({day_s:.2f} s "
          f"with JSON): vs phase 5's captured one-process answer {errs} of "
          f"scale (tol {TOL['bfloat16'][0]}); vs phase 16's {label} "
          f"Predictor {errs_mesh} of scale (tol {TOL['float32'][0]}), bit "
          f"for bit {same}; phase 8's mix vs its one-process batcher server "
          f"{mix_err:.3e} of scale (tol {TOL['bfloat16'][0]}); /healthz "
          f"digest {served} (one process {digest}); gru_fwd launches per "
          f"rank {k1}; mirrored calls {health['mesh']['calls']}, "
          f"heartbeats {health['mesh']['heartbeats']}", flush=True)
    if (max(errs.values()) > TOL["bfloat16"][0]
            or max(errs_mesh.values()) > TOL["float32"][0] or not same
            or mix_err > TOL["bfloat16"][0] or served != digest):
        fail(f"serve --mesh {label} parts from one process or from the "
             f"{label} Predictor")
    for conc, load in loads.items():
        print(f"main serve --mesh {label} closed loop, concurrency {conc}: "
              f"{load['requests']} requests in {SERVE_MESH_LOAD_S} s = "
              f"{load['rps']:.1f} requests/s, p50 {load['p50_ms']:.2f} ms, "
              f"p99 {load['p99_ms']:.2f} ms (eager, gloo)", flush=True)
    peak = [round(r["max_reserved"] / 2**20) for r in ranks]
    print(f"main serve mesh phase: {wall:.1f} s wall (listening after "
          f"{start['seconds']}, spawn included {listened - t0:.1f} s; "
          f"clients {client_s:.1f} s; deadline {SERVE_MESH_DEADLINE_S} s); "
          f"peak device memory per rank {peak} MiB reserved "
          f"({[round(r['max_allocated'] / 2**20) for r in ranks]} "
          f"allocated); gru_fwd launches {sum(k1)}", flush=True)
    return {"launches": {"gru_fwd": sum(k1)}, "wall": wall,
            "errors": errs, "errors_mesh": errs_mesh, "bit_equal": same,
            "mix_err": mix_err, "peak_mib": peak,
            "loads": {c: {k: v for k, v in load.items()}
                      for c, load in loads.items()}}


# -- phase 20: quantized serving, --watch and the surfaces on the mesh ----

SERVE_MESH_QUANT = (1, 1, 2)        # F=512: w_ih's 256 columns a rank
SERVE_MESH_QUANT_DEADLINE_S = 75    # rank 0 stops this long after it listens
SERVE_MESH_QUANT_RELOAD = 1.1       # step 1's params, x this
SERVE_MESH_QUANT_RELOAD_LOAD_S = 10.0   # the closed loop during the reload
SERVE_MESH_QUANT_TAIL = 90          # the verdict tail: phase 7's last minutes
SERVE_MESH_QUANT_SURFACE = ("--surface", "--surface-max-axes", "2",
                            "--surface-jitter", "4")
SERVE_MESH_QUANT_VERDICT = ("--verdict-sweep-every", "30",
                            "--verdict-live-window", "60")


def serve_mesh_quant_rank_main(rank: int, port: int, args: list,
                               out: str) -> None:
    """One rank of phase 20's plane (spawned): ``serve`` with ``args`` on
    the card in a gloo job sharing it, its output to ``out + ".log"``;
    then its exit code, K1 launches and peak device memory to ``out``."""
    import contextlib

    import torch

    sys.path.insert(0, REPO)
    from deeprest_tpu_torch.cli import main
    from deeprest_tpu_torch.ops import cuda_gru
    from deeprest_tpu_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, backend="gloo",
                           device="cuda")
    with open(out + ".log", "w", encoding="utf-8") as log, \
            contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = main(["serve", *args])
    with open(out, "w", encoding="utf-8") as fh:
        json.dump({"rc": rc, "launches": cuda_gru.GRU_FWD.launches,
                   "max_allocated": torch.cuda.max_memory_allocated(),
                   "max_reserved": torch.cuda.max_memory_reserved()}, fh)


def wait_ranks_listening(procs, outs: list, label: str,
                         timeout: float = 300.0) -> dict:
    """Rank 0's startup line of a plane of spawned ranks (each writes its
    output to ``outs[r] + ".log"``); fails with the ranks' logs when it
    does not listen."""
    start = None
    deadline = time.monotonic() + timeout
    while start is None and time.monotonic() < deadline:
        time.sleep(0.2)
        if not all(p.is_alive() for p in procs):
            break
        if os.path.exists(outs[0] + ".log"):
            with open(outs[0] + ".log", encoding="utf-8") as log:
                for line in log:
                    if line.startswith('{"listening"'):
                        start = json.loads(line)
    if start is None:
        logs = ""
        for path in outs:
            if os.path.exists(path + ".log"):
                with open(path + ".log", encoding="utf-8") as log:
                    logs += log.read()[-3000:]
        fail(f"{label} did not listen:\n{logs}")
    return start


def serve_mesh_quant_checkpoint(serving: dict, social_ckpt: str,
                                wd: str) -> str:
    """Phase 20's watched checkpoint: phase 5's flagship params and stats
    at step 0, with phase 7's call paths spread over its 512 columns (its
    sidecar's space, every path ``F // paths`` columns after the last, the
    columns between held by paths no trace takes, frozen at F), so
    ``--raw`` and ``--verdict-raw`` featurize phase 7's corpus into
    columns of both model-axis ranks."""
    from deeprest_tpu_torch.train.checkpoint import (
        load_params, load_sidecar, save_checkpoint,
    )

    extra = load_sidecar(serving["ckpt"], 0)
    space = dict(load_sidecar(social_ckpt)["space"])
    paths = space["vocabulary"]
    spread = [["unused", f"/column{i}"] for i in range(F)]
    for j, path in enumerate(paths):
        spread[j * (F // len(paths))] = path
    space["vocabulary"], space["frozen_capacity"] = spread, F
    extra["space"] = space
    ckpt = os.path.join(wd, "ckpt")
    save_checkpoint(ckpt, load_params(serving["ckpt"], 0), 0, extra=extra)
    return ckpt


def write_reload_step(ckpt: str) -> None:
    """Step 1 of phase 20's checkpoint: step 0's params x
    SERVE_MESH_QUANT_RELOAD, the same sidecar.  The stored int8 envelope
    goes first, so the reload measures and stores step 1's: in bf16 the
    int8 deviation sits at the compute's rounding noise, and step 0's
    budget (2x its measured cells) refuses a step whose noise is drawn
    anew (the CPU at this shape: cells 2.6-3.8x step 0's at x1.01-1.25)."""
    from deeprest_tpu_torch.train.checkpoint import (
        load_params, load_sidecar, save_checkpoint,
    )

    os.remove(os.path.join(ckpt, "quant_parity_int8.json"))
    save_checkpoint(ckpt, {k: v * SERVE_MESH_QUANT_RELOAD
                           for k, v in load_params(ckpt, 0).items()}, 1,
                    extra=load_sidecar(ckpt, 0))


def phase_serve_mesh_quant(serving: dict, plane: dict, raw_path: str,
                           social: tuple, workdir: str) -> dict:
    """Phase 20: ``serve --mesh 1,1,2 --quant int8 --watch 1 --surface
    --raw --verdict-raw --no-batcher`` as two spawned gloo ranks sharing
    the card (eager), on phase 5's flagship with phase 7's call paths:
    phase 5's day, a closed loop at concurrency 1, step 1 written into
    the watched directory and served, a capacity surface, the verdict
    surface and both ranks' exit at the deadline.  Its kernels launch in
    its ranks only; the one-process references are
    :func:`check_serve_mesh_quant`'s, in the foreground."""
    import multiprocessing

    t0 = time.perf_counter()
    wd = os.path.join(workdir, "serve_mesh_quant")
    os.makedirs(wd)
    label = "x".join(map(str, SERVE_MESH_QUANT))
    ckpt = serve_mesh_quant_checkpoint(serving, social[0], wd)
    tail = os.path.join(wd, "tail.jsonl")
    with open(raw_path, encoding="utf-8") as src:
        lines = src.readlines()[-SERVE_MESH_QUANT_TAIL:]
    with open(tail, "w", encoding="utf-8") as dst:
        dst.writelines(lines)
    args = ["--ckpt-dir", ckpt, "--mesh", ",".join(map(str,
                                                       SERVE_MESH_QUANT)),
            "--quant", "int8", "--watch", "1", *SERVE_MESH_QUANT_SURFACE,
            "--raw", social[1], "--verdict-raw", tail,
            *SERVE_MESH_QUANT_VERDICT, "--no-batcher", "--port", "0",
            "--deadline", str(SERVE_MESH_QUANT_DEADLINE_S)]
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(wd, f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=serve_mesh_quant_rank_main,
                         args=(r, port, args, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    out = {"ckpt": ckpt, "tail": tail}
    try:
        start = wait_ranks_listening(
            procs, outs, f"serve --mesh {label} --quant int8 --watch")
        listened = time.perf_counter()
        url = start["listening"]
        if (start["mesh"] != list(SERVE_MESH_QUANT) or start["world"] != 2
                or start["quant"] != "int8" or start["verdict"] is None
                or start["surface"] is None):
            fail(f"phase 20's startup line: {start}")
        day = {"traffic": serving["traffic"].tolist()}
        status, body = http_json(url + "/v1/predict", day)
        if status != 200:
            fail(f"phase 20 /v1/predict answered {status}: {body}")
        out["day0"] = body["predictions"]
        out["health0"] = http_json(url + "/healthz")[1]
        load = closed_loop(url, plane["bodies"], 1, SERVE_MESH_LOAD_S)
        load.pop("samples")
        out["load"] = load
        with open(os.path.join(ckpt, "quant_parity_int8.json"),
                  encoding="utf-8") as fh:
            out["envelope0"] = json.load(fh)       # step 0's, stored at start
        write_reload_step(ckpt)
        t_written = time.perf_counter()
        # a client through the reload: its ops hold the front's lock one
        # at a time, so requests go on between them
        during = Background("phase 20's reload clients", closed_loop, url,
                            plane["bodies"], 1,
                            SERVE_MESH_QUANT_RELOAD_LOAD_S)
        health = None
        while time.perf_counter() - t_written < 120:
            health = http_json(url + "/healthz")[1]
            if health["mesh"]["step"] == 1:
                break
            time.sleep(0.05)
        out["reload_s"] = time.perf_counter() - t_written
        out["load_reload"] = during.result(SERVE_MESH_QUANT_RELOAD_LOAD_S
                                           + 300)
        out["load_reload"].pop("samples")
        if health is None or health["mesh"]["step"] != 1:
            fail(f"phase 20: step 1 was not served within 120 s: "
                 f"{health and health['mesh']}")
        out["health1"] = health
        status, body = http_json(url + "/v1/predict", day)
        if status != 200:
            fail(f"phase 20 /v1/predict after the reload answered {status}")
        out["day1"] = body["predictions"]
        endpoints = http_json(url + "/v1/meta")[1]["whatif_endpoints"]
        program = [{ep: 30 for ep in endpoints[:2]}] * W
        out["surface_body"] = {"base_traffic": program, "factor": 2,
                               "wait": True}
        t_surface = time.perf_counter()
        status, body = http_json(url + "/v1/whatif/surface",
                                 out["surface_body"])
        out["surface_s"] = time.perf_counter() - t_surface
        if status != 200:
            fail(f"phase 20 /v1/whatif/surface answered {status}: {body}")
        out["surface"] = body
        verdict = None
        while time.perf_counter() - t_surface < 120:
            status, verdict = http_json(url + "/v1/verdict")
            if status == 200 and verdict["sweeps"] >= 1:
                break
            time.sleep(0.2)
        if status != 200 or verdict["sweeps"] < 1:
            fail(f"phase 20 /v1/verdict: {status}, {verdict}")
        out["verdict"] = verdict
        out["health2"] = http_json(url + "/healthz")[1]
        out["client_s"] = time.perf_counter() - listened
        if out["client_s"] > SERVE_MESH_QUANT_DEADLINE_S - 5:
            fail(f"phase 20's clients took {out['client_s']:.1f} s, too "
                 f"close to the {SERVE_MESH_QUANT_DEADLINE_S}-s deadline")
        for p in procs:
            p.join(SERVE_MESH_QUANT_DEADLINE_S + 120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    out["wall"] = time.perf_counter() - t0
    out["listening_s"] = listened - t0
    if [p.exitcode for p in procs] != [0, 0]:
        fail(f"phase 20's ranks exited {[p.exitcode for p in procs]}")
    out["ranks"] = []
    for path in outs:
        with open(path, encoding="utf-8") as fh:
            out["ranks"].append(json.load(fh))
    if [r["rc"] for r in out["ranks"]] != [0, 0]:
        fail(f"phase 20's ranks returned "
             f"{[r['rc'] for r in out['ranks']]} at the deadline")
    k1 = [r["launches"] for r in out["ranks"]]
    if k1[0] == 0 or k1[0] != k1[1]:
        fail(f"phase 20: gru_fwd launches per rank {k1}; want the same "
             "nonzero count on both")
    out["launches"] = {"gru_fwd": sum(k1)}
    return out


def check_serve_mesh_quant(cuda_gru, serving: dict, social: tuple,
                           run: dict) -> dict:
    """Phase 20 against one process on the card (foreground; these
    reference launches count nowhere): the day at steps 0 and 1 against
    the one-process int8 predictor (2e-2 of scale, and every non-delta
    (metric, quantile) deviation, in the model's normalized units, within
    the budget the plane stored for that step), the envelope stored at
    the reload equal to the plane's, the digests, and the surface against
    a one-process service at step 1."""
    import numpy as np

    from deeprest_tpu_torch.config import SurfaceConfig
    from deeprest_tpu_torch.data.schema import load_raw_data
    from deeprest_tpu_torch.data.synthesize import TraceSynthesizer
    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.serve.server import PredictionService

    import shutil

    label = "x".join(map(str, SERVE_MESH_QUANT))
    delta = serving["delta"]
    with open(os.path.join(run["ckpt"], "quant_parity_int8.json"),
              encoding="utf-8") as fh:
        envelope = json.load(fh)
    # each one-process predictor measures its own envelope: in bf16 the
    # int8 deviation is near the compute's rounding noise, which another
    # order of sums (the model axis's partial sums) or other params draw
    # anew
    one_dir = run["ckpt"] + "_one_process"
    shutil.copytree(run["ckpt"], one_dir,
                    ignore=shutil.ignore_patterns("quant_parity_*"))
    errs, digests, preds = {}, {}, {}
    for step in (0, 1):
        stored = os.path.join(one_dir, "quant_parity_int8.json")
        if os.path.exists(stored):
            os.remove(stored)
        pred = Predictor.from_checkpoint(one_dir, step=step, device="cuda",
                                         quant="int8")
        want = pred.predict_series(serving["traffic"])
        got = np.asarray(run[f"day{step}"], np.float32)
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"phase 20 step {step}: shape {got.shape} or non-finite")
        errs[step] = {name: rel_err(got, want, cols) for cols, name in
                      ((~delta, "non-delta"), (delta, "delta"))}
        # the non-delta cells in the model's units against the budget
        rng = np.maximum(np.asarray(pred.y_stats.range, np.float64), 1e-12)
        dev = np.abs(got - want).max(axis=0) / rng[:, None]      # [E, Q]
        stored = envelope if step else run["envelope0"]
        ratio = max(float(dev[e, j]) / stored["budget"][
            f"{m}|q{q:g}"]
            for e, m in enumerate(pred.metric_names) if not delta[e]
            for j, q in enumerate(pred.quantiles))
        errs[step]["of budget"] = ratio
        digests[step] = pred.params_digest()
        preds[step] = pred
    served = [run[f"health{i}"]["fleet"]["tenants"]["default"][
        "params_digest"] for i in (0, 1)]
    synth = TraceSynthesizer(preds[1].space()).fit(load_raw_data(social[1]))
    svc = PredictionService(preds[1], synth, surface=SurfaceConfig(
        enabled=True, max_axes=int(SERVE_MESH_QUANT_SURFACE[2]),
        jitter=int(SERVE_MESH_QUANT_SURFACE[4])))
    try:
        one = svc.whatif_surface(run["surface_body"])
    finally:
        svc.close()
    surface_err = max(
        abs(run["surface"]["peaks"][m][q] - v)
        / max(max(abs(x) for x in one["peaks"][m].values()), 1e-12)
        for m, bands in one["peaks"].items() for q, v in bands.items())
    verdict = run["verdict"]
    states = sum(verdict["states"].values())
    # the envelope rank 0 stored at the reload, and the plane's: the same
    budget = envelope["budget"]
    parity = verdict["quant_parity"]
    over = max(v / budget[k] for k, v in parity["measured"].items())
    k1 = [r["launches"] for r in run["ranks"]]
    print(f"check serve --mesh {label} --quant int8 --watch --surface "
          f"--verdict-raw (gloo world size 2 on one card, eager, bf16, "
          f"--no-batcher): phase 5's day vs the one-process int8 "
          f"predictor at step 0 {errs[0]}, at step 1 (x"
          f"{SERVE_MESH_QUANT_RELOAD}, after the reload) {errs[1]} of "
          f"scale (tol {TOL['bfloat16'][0]}; 'of budget': the worst "
          f"non-delta cell's deviation over its stored budget, limit 1); "
          f"/healthz digests {served}, one process {[digests[0], digests[1]]}"
          f"; surface peaks vs the one-process service {surface_err:.3e} "
          f"of scale (tol {TOL['bfloat16'][0]}), params_hash "
          f"{run['surface']['surface'].get('params_hash')}; /v1/verdict "
          f"{verdict['sweeps']} sweep(s), states {verdict['states']}; "
          f"the envelope stored at the reload (step {envelope['step']}, max "
          f"{max(envelope['measured'].values()):.3e}; step 0's max "
          f"{run['health0']['quant']['parity_max']:.3e}) and the plane's "
          f"cells over its budget {over:.3f} at worst (limit 1); "
          f"gru_fwd launches per rank {k1}; mirrored calls "
          f"{run['health2']['mesh']['calls']}, reloads "
          f"{run['health2']['mesh']['reloads']}", flush=True)
    if (max(max(e["non-delta"], e["delta"]) for e in errs.values())
            > TOL["bfloat16"][0]
            or max(e["of budget"] for e in errs.values()) > 1.0
            or over > 1.0 or parity["budget"] != budget
            or envelope["step"] != 1
            or parity["measured"] != envelope["measured"]
            or served != [digests[0], digests[1]]
            or surface_err > TOL["bfloat16"][0]
            or run["surface"]["surface"].get("params_hash")
            != digests[1] + ":int8"
            or states != len(preds[1].metric_names)):
        fail(f"serve --mesh {label} --quant int8 --watch parts from one "
             "process")
    load, during = run["load"], run["load_reload"]
    peak = [round(r["max_reserved"] / 2**20) for r in run["ranks"]]
    print(f"main serve --mesh {label} --quant int8 closed loop, concurrency "
          f"1: {load['requests']} requests in {SERVE_MESH_LOAD_S} s = "
          f"{load['rps']:.1f} requests/s, p50 {load['p50_ms']:.2f} ms, "
          f"p99 {load['p99_ms']:.2f} ms (eager, gloo); reload (step "
          f"written to swapped) {run['reload_s']:.2f} s, and through its "
          f"first {SERVE_MESH_QUANT_RELOAD_LOAD_S:g} s at concurrency 1 "
          f"{during['requests']} requests = {during['rps']:.1f} "
          f"requests/s, p50 {during['p50_ms']:.2f} ms, p99 "
          f"{during['p99_ms']:.2f} ms; surface build (wait) "
          f"{run['surface_s']:.2f} s", flush=True)
    print(f"main serve mesh quant phase: {run['wall']:.1f} s wall "
          f"(listening after {run['listening_s']:.1f} s of spawn; clients "
          f"{run['client_s']:.1f} s; deadline "
          f"{SERVE_MESH_QUANT_DEADLINE_S} s); peak device memory per rank "
          f"{peak} MiB reserved "
          f"({[round(r['max_allocated'] / 2**20) for r in run['ranks']]} "
          f"allocated); gru_fwd launches {sum(k1)}", flush=True)
    del preds
    return {"errors": errs, "surface_err": surface_err, "peak_mib": peak}


# -- phase 21: the replica router, admission, tenant weights, the autoscaler
# and the fleet tier on the mesh -------------------------------------------

SERVE_MESH_PLANE = (1, 2, 1)        # the flagship's E=40: 20 experts a rank
SERVE_MESH_PLANE_DEADLINE_S = 35    # the fleet plane's seconds after listening
SERVE_MESH_PROCESS_DEADLINE_S = 12  # the process plane's
SERVE_MESH_PLANE_LOAD_S = 2.0       # each closed-loop cell
SERVE_MESH_PLANE_CONCURRENCY = (1, 8)
SERVE_MESH_PLANE_BURST = 32         # clients at once against depth 8
SERVE_MESH_PLANE_ARGS = (
    "--replicas", "2", "--admission-depth", "8", "--tenant-weights",
    "default=3,t1=1", "--fleet-hbm-budget", "1", "--autoscale",
    "--autoscale-min", "2", "--autoscale-max", "3", "--autoscale-interval",
    "1", "--autoscale-rps-per-replica", "4", "--no-batcher")


def serve_mesh_plane_rank_main(rank: int, port: int, args: list,
                               out: str) -> None:
    """One rank of a phase-21 plane (spawned): ``serve`` with ``args`` on
    the card in a gloo job sharing it, its output to ``out + ".log"``;
    then its exit code, its K1 launches, those of its warm-ups (of the
    mesh predictor and of one-device ones) and those of captured-graph
    replays outside them (on these planes the mesh serves eagerly under
    gloo, so every replay is a one-device stack's), and its peak device
    memory to ``out``."""
    import contextlib
    import threading

    import torch

    sys.path.insert(0, REPO)
    from deeprest_tpu_torch import graphs
    from deeprest_tpu_torch.cli import main
    from deeprest_tpu_torch.ops import cuda_gru
    from deeprest_tpu_torch.parallel import initialize_distributed
    from deeprest_tpu_torch.serve.predictor import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = {"warm_mesh": 0, "warm_one": 0, "replayed": 0}
    lock, warming = threading.Lock(), []
    warm, replay = Predictor.warm, graphs.CapturedGraph.replay

    def counted_warm(self):
        before = cuda_gru.GRU_FWD.launches
        warming.append(self)
        try:
            return warm(self)
        finally:
            warming.pop()
            key = "warm_one" if self.mesh is None else "warm_mesh"
            counts[key] += cuda_gru.GRU_FWD.launches - before

    def counted_replay(self):
        replay(self)
        if not warming:
            with lock:
                counts["replayed"] += self.launches.get(cuda_gru.GRU_FWD, 0)

    Predictor.warm = counted_warm
    graphs.CapturedGraph.replay = counted_replay
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, backend="gloo",
                           device="cuda")
    with open(out + ".log", "w", encoding="utf-8") as log, \
            contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = main(["serve", *args])
    with open(out, "w", encoding="utf-8") as fh:
        json.dump({"rc": rc, "launches": cuda_gru.GRU_FWD.launches, **counts,
                   "max_allocated": torch.cuda.max_memory_allocated(),
                   "max_reserved": torch.cuda.max_memory_reserved()}, fh)


def headed_post(url: str, body: bytes, tenant: str | None):
    """POST ``body`` with ``X-Tenant``: (status, JSON body, headers)."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["X-Tenant"] = tenant
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def tenant_loop(url: str, bodies: list, concurrency: int,
                seconds: float) -> dict:
    """A closed loop of ``concurrency`` client threads for ``seconds``,
    each posting ``bodies`` in turn with ``X-Tenant`` alternating between
    'default' and 't1'; per tenant the requests answered, requests/s and
    p50/p99 ms (every answer must be 200)."""
    import threading

    import numpy as np

    lats = {"default": [], "t1": []}
    bad, lock = [], threading.Lock()
    end = time.monotonic() + seconds

    def client(i):
        n = i
        while time.monotonic() < end:
            tenant = ("default", "t1")[n % 2]
            t0 = time.perf_counter()
            status, _, _ = headed_post(url + "/v1/predict",
                                       bodies[n % len(bodies)], tenant)
            with lock:
                (lats[tenant] if status == 200 else bad).append(
                    time.perf_counter() - t0 if status == 200 else status)
            n += 1

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 300)
    if bad:
        fail(f"phase 21's tenant loop got statuses {sorted(set(bad))}")
    return {t: {"requests": len(v), "rps": len(v) / seconds,
                "p50_ms": float(np.percentile(v, 50) * 1e3) if v else None,
                "p99_ms": float(np.percentile(v, 99) * 1e3) if v else None}
            for t, v in lats.items()}


def mesh_plane_burst(url: str, body: bytes) -> dict:
    """SERVE_MESH_PLANE_BURST clients at once: the statuses, and whether
    every 429 carried ``Retry-After``."""
    import threading

    barrier = threading.Barrier(SERVE_MESH_PLANE_BURST)
    got = []

    def client():
        barrier.wait(60)
        got.append(headed_post(url + "/v1/predict", body, "default"))

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(SERVE_MESH_PLANE_BURST)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    shed = [g for g in got if g[0] == 429]
    return {"statuses": sorted(g[0] for g in got), "shed": len(shed),
            "retry_after": all("Retry-After" in g[2] for g in shed)}


def spawn_mesh_plane(args: list, wd: str, name: str):
    """The two spawned gloo ranks of ``serve *args``; returns (procs,
    outs)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(wd, f"{name}{r}.json") for r in range(2)]
    procs = [ctx.Process(target=serve_mesh_plane_rank_main,
                         args=(r, port, args, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    return procs, outs


def join_mesh_plane(procs, outs: list, label: str, wait: float) -> list:
    """Both ranks' exit, each with code 0 and rc 0; returns their
    records."""
    try:
        for p in procs:
            p.join(wait)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    if [p.exitcode for p in procs] != [0, 0]:
        fail(f"{label}'s ranks exited {[p.exitcode for p in procs]}")
    ranks = []
    for path in outs:
        with open(path, encoding="utf-8") as fh:
            ranks.append(json.load(fh))
    if [r["rc"] for r in ranks] != [0, 0]:
        fail(f"{label}'s ranks returned {[r['rc'] for r in ranks]}")
    return ranks


def phase_serve_mesh_plane(serving: dict, trained: str, plane: dict,
                           workdir: str) -> dict:
    """Phase 21: ``serve --mesh 1,2,1`` with the replica router (two thread
    replicas sharing the mesh stack on the one card), admission depth 8,
    tenant weights, the autoscaler and the fleet (``t1``: phase 6's
    trained checkpoint, a one-device predictor on rank 0's card) at a
    budget of 1, as two spawned gloo ranks sharing the card (eager), on
    phase 5's flagship; then a process plane on the same mesh.  The mesh
    ``default`` verifies phase 10's one-device AOT sidecar at its
    admission (``/healthz`` ``fleet.pool.aot.last_reason``).  Its
    kernels launch in its ranks and workers only; the one-process
    references are :func:`check_serve_mesh_plane`'s, in the
    foreground."""
    import numpy as np

    t0 = time.perf_counter()
    wd = os.path.join(workdir, "serve_mesh_plane")
    os.makedirs(wd)
    label = "x".join(map(str, SERVE_MESH_PLANE))
    mesh = ",".join(map(str, SERVE_MESH_PLANE))
    args = ["--ckpt-dir", serving["ckpt"], "--mesh", mesh,
            *SERVE_MESH_PLANE_ARGS, f"--fleet=t1={trained}", "--port", "0",
            "--deadline", str(SERVE_MESH_PLANE_DEADLINE_S)]
    procs, outs = spawn_mesh_plane(args, wd, "fleet")
    day = json.dumps({"traffic": serving["traffic"].tolist()}).encode()
    try:
        start = wait_ranks_listening(procs, outs,
                                     f"phase 21's fleet plane on {label}")
        listened = time.perf_counter()
        url = start["listening"]
        if (start["mesh"] != list(SERVE_MESH_PLANE) or start["world"] != 2
                or start["fleet"]["tenants"] != ["default", "t1"]
                or not start["autoscale"]):
            fail(f"phase 21's startup line: mesh {start['mesh']}, world "
                 f"{start['world']}, fleet {start['fleet']}, autoscale "
                 f"{start['autoscale']}")
        answers, graph_counts = {}, []
        for tenant in ("default", "t1"):
            status, body, _ = headed_post(url + "/v1/predict", day, tenant)
            if status != 200:
                fail(f"phase 21 /v1/predict as {tenant}: {status} {body}")
            answers[tenant] = np.asarray(body["predictions"], np.float32)
        status, health = http_json(url + "/healthz")
        graph_counts.append(health["fleet"]["pool"]["jit_cache_size"])
        # the mesh default's check of phase 10's one-device sidecar
        aot_reason = health["fleet"]["pool"]["aot"]["last_reason"]
        print(f"check serve --mesh {label} fleet AOT sidecar (phase 10's "
              f"export --aot, one device) at the mesh default's admission: "
              f"{aot_reason}", flush=True)
        if not str(aot_reason).startswith("manifest verified"):
            fail(f"phase 21's mesh default did not verify phase 10's "
                 f"sidecar: {aot_reason}")
        bodies = [raw.encode() if isinstance(raw, str) else raw
                  for raw in plane["bodies"]]
        loads = {conc: tenant_loop(url, bodies, conc,
                                   SERVE_MESH_PLANE_LOAD_S)
                 for conc in SERVE_MESH_PLANE_CONCURRENCY}
        burst = mesh_plane_burst(url, bodies[0])
        router = {}
        for _ in range(50):
            status, health = http_json(url + "/healthz")
            router = health["router"]
            decision = router.get("autoscaler") or {}
            if decision.get("desired") == router["num_replicas"]:
                break
            time.sleep(0.2)
        graph_counts.append(health["fleet"]["pool"]["jit_cache_size"])
        client_s = time.perf_counter() - listened
    finally:
        ranks = join_mesh_plane(procs, outs, "phase 21's fleet plane",
                                SERVE_MESH_PLANE_DEADLINE_S + 120)
    pool = health["fleet"]["pool"]
    default = pool["per_tenant"]["default"]
    checks = {
        "default spilled and restored": (default["spills"] >= 1
                                         and default["restores"] >= 1),
        "graphs flat after t1's first call": (graph_counts[0]
                                              == graph_counts[1]),
        "router at the autoscaler's replicas": (
            (router.get("autoscaler") or {}).get("desired")
            == router["num_replicas"]),
        "a burst over depth 8 shed with Retry-After": (
            burst["shed"] >= 1 and burst["retry_after"]),
    }
    r0, r1 = ranks
    one_device = r0["warm_one"] + r0["replayed"]
    mesh_calls = [r0["launches"] - r0["warm_mesh"] - one_device,
                  r1["launches"] - r1["warm_mesh"]]
    checks["K1: rank 1 = rank 0's mesh calls, surplus = t1's"] = (
        r0["warm_mesh"] == r1["warm_mesh"] and mesh_calls[0] == mesh_calls[1]
        and r1["replayed"] == 0 and r0["launches"] - r1["launches"]
        == one_device and one_device > 0 and mesh_calls[0] > 0)
    print(f"check serve --mesh {label} plane (gloo world size 2 on one "
          f"card, eager, bf16, --no-batcher, two thread replicas, depth 8, "
          f"default=3,t1=1, fleet budget 1, autoscaler 2..3): {checks}; "
          f"K1 per rank {[r0['launches'], r1['launches']]} (warm-ups of "
          f"the mesh {[r0['warm_mesh'], r1['warm_mesh']]}, one-device "
          f"warm-up {r0['warm_one']} and replays {r0['replayed']} on rank "
          f"0; mirrored calls' {mesh_calls}); graphs {graph_counts}; "
          f"burst statuses {burst['statuses']}; router "
          f"{router['num_replicas']} replicas, autoscaler "
          f"{router.get('autoscaler')}; spills {pool['spills']}, restores "
          f"{pool['restores']}", flush=True)
    if not all(checks.values()):
        fail(f"phase 21's fleet plane failed {checks}")
    copy_ms = pool["plane"]["copy_ms"]
    for conc, load in loads.items():
        for tenant, cell in load.items():
            print(f"main serve --mesh {label} fleet plane closed loop, "
                  f"concurrency {conc}, tenant {tenant}: "
                  f"{cell['requests']} requests in "
                  f"{SERVE_MESH_PLANE_LOAD_S} s = {cell['rps']:.1f} "
                  f"requests/s, p50 {cell['p50_ms']:.2f} ms, p99 "
                  f"{cell['p99_ms']:.2f} ms (eager mesh, captured t1, "
                  f"gloo)", flush=True)
    print(f"main serve --mesh {label} fleet: spill ms "
          f"{[round(v, 3) for v in copy_ms['spill']]}, restore ms "
          f"{[round(v, 3) for v in copy_ms['restore']]} (the latest, host "
          f"clock, copies landed; default is the mesh tenant, so each is "
          f"a mirrored op)", flush=True)
    # the process plane: workers serve one-device predictors on rank 0's
    # card; the follower only waits
    t_proc = time.perf_counter()
    procs, outs = spawn_mesh_plane(
        ["--ckpt-dir", serving["ckpt"], "--mesh", mesh, "--replica-mode",
         "process", "--replicas", "2", "--no-batcher", "--port", "0",
         "--deadline", str(SERVE_MESH_PROCESS_DEADLINE_S)], wd, "process")
    try:
        start = wait_ranks_listening(procs, outs,
                                     f"phase 21's process plane on {label}")
        url = start["listening"]
        process_answers = []
        for _ in range(2):
            status, body, _ = headed_post(url + "/v1/predict", day, None)
            if status != 200:
                fail(f"phase 21's process plane answered {status}: {body}")
            process_answers.append(np.asarray(body["predictions"],
                                              np.float32))
        status, phealth = http_json(url + "/healthz")
    finally:
        pranks = join_mesh_plane(procs, outs, "phase 21's process plane",
                                 SERVE_MESH_PROCESS_DEADLINE_S + 120)
    workers = worker_launches(phealth)
    if (phealth["mesh"]["calls"] != 0 or workers == 0
            or [r["launches"] for r in pranks] != [0, 0]):
        fail(f"phase 21's process plane: mirrored calls "
             f"{phealth['mesh']['calls']}, the workers' K1 {workers}, the "
             f"ranks' {[r['launches'] for r in pranks]}")
    wall = time.perf_counter() - t0
    peak = [round(r["max_reserved"] / 2**20) for r in ranks]
    print(f"main serve mesh plane phase: {wall:.1f} s wall (the fleet plane "
          f"listening after {listened - t0:.1f} s, clients {client_s:.1f} "
          f"s, deadline {SERVE_MESH_PLANE_DEADLINE_S} s; the process plane "
          f"{time.perf_counter() - t_proc:.1f} s); peak device memory per "
          f"rank {peak} MiB reserved "
          f"({[round(r['max_allocated'] / 2**20) for r in ranks]} "
          f"allocated); gru_fwd launches {r0['launches'] + r1['launches']} "
          f"in the fleet plane's ranks, {workers} in the process plane's "
          f"workers", flush=True)
    return {"launches": {"gru_fwd": r0["launches"] + r1["launches"]
                         + workers},
            "answers": answers, "process": process_answers,
            "wall": wall, "peak_mib": peak, "loads": loads,
            "copy_ms": copy_ms, "checks": checks}


def check_serve_mesh_plane(axes: dict, serving: dict, trained: str,
                           run: dict) -> None:
    """Phase 21 against one process on the card (foreground; these
    reference launches count nowhere): ``default``'s day bit for bit
    phase 16's 1,2,1 Predictor (which phase 19's plane equals bit for
    bit), ``t1``'s within 1e-5 of scale of a one-process captured
    predictor of phase 6's checkpoint, and the process plane's bit for
    bit a one-process captured predictor of phase 5's (each with the
    serve CLI's knobs)."""
    import numpy as np

    from deeprest_tpu_torch.cli import build_parser
    from deeprest_tpu_torch.serve.predictor import Predictor

    label = "x".join(map(str, SERVE_MESH_PLANE))
    cli = build_parser().parse_args(["serve", "--ckpt-dir", trained])
    knobs = dict(ladder=tuple(int(r) for r in cli.batch_ladder.split(",")),
                 coalesce_groups=cli.batch_coalesce_groups, device="cuda")
    mesh_answer = axes["answers"][label]
    default = run["answers"]["default"]
    t1_want = Predictor.from_checkpoint(trained, **knobs).predict_series(
        serving["traffic"])
    one = Predictor.from_checkpoint(serving["ckpt"], **knobs)
    process_want = one.predict_series(serving["traffic"])
    t1 = run["answers"]["t1"]
    t1_err = float(np.abs(t1 - t1_want).max()
                   / max(float(np.abs(t1_want).max()), 1e-12))
    same_default = bool(np.array_equal(default, mesh_answer))
    same_process = [bool(np.array_equal(a, process_want))
                    for a in run["process"]]
    print(f"check serve --mesh {label} plane vs one process: default bit "
          f"for bit phase 16's {label} Predictor {same_default}; t1 vs a "
          f"one-process captured predictor of phase 6's checkpoint "
          f"{t1_err:.3e} of scale (tol {TOL['float32'][0]}); the process "
          f"plane's answers bit for bit a one-process captured predictor "
          f"{same_process}", flush=True)
    if (not same_default or t1_err > TOL["float32"][0]
            or not all(same_process) or not np.isfinite(t1).all()):
        fail("phase 21 parts from one process")


# -- phase 22: the static analyzer, with no JAX on the machine ------------


def lint_cli(args: list, expect: int, module: str = "deeprest_tpu_torch",
             cwd: str = REPO) -> str:
    """``python3 -m <module> <args>`` in a process of its own; fails the
    run unless it exits ``expect``.  Returns its stdout."""
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=600)
    if out.returncode != expect:
        fail(f"phase 22: python3 -m {module} {' '.join(args)} exited "
             f"{out.returncode}, not {expect}:\n{out.stdout[-2000:]}"
             f"\n{out.stderr[-2000:]}")
    return out.stdout


def lint_fixtures(workdir: str) -> dict:
    """Each fire/silent pair of TX001, TX002, TX004, TX005, TX006 and
    JX007's capture arm written to a directory and linted there with its
    rule: the firing fixture exits 1 with findings of that rule alone, the
    twin 0.  Returns ``{case: [(path, line), ...]}`` of the firings."""
    from deeprest_tpu_torch.analysis.torch_fixtures import PAIRS

    cases = ("TX001", "TX002", "TX004", "TX005", "TX006", "JX007 capture")
    fired = {}
    for case in cases:
        rule, bad, good = PAIRS[case]
        for twin, sources in (("bad", bad), ("good", good)):
            root = os.path.join(workdir, "lint_fixtures",
                                case.replace(" ", "_"), twin)
            for rel, src in sources.items():
                path = os.path.join(root, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w", encoding="utf-8") as fh:
                    fh.write(src)
            out = json.loads(lint_cli(
                ["lint", root, "--rules", rule, "--no-cache", "--format",
                 "json"], expect=1 if twin == "bad" else 0))
            found = [(x["rule"], x["path"], x["line"])
                     for x in out["findings"]]
            if twin == "bad" and (not found or any(
                    r != rule for r, _, _ in found)):
                fail(f"phase 22: {case}'s firing fixture found {found}")
            if twin == "bad":
                fired[case] = [(p, ln) for _, p, ln in found]
    print(f"lint fixtures (phase 22): {fired} fire, each silent twin "
          f"clean", flush=True)
    return fired


def lint_hazards_on_card(workdir: str, fired: dict) -> float:
    """The runtime fixtures' demos on the card, each twin in a process of
    its own (a refused capture cannot poison this one), all at once;
    fails unless each hazard shows as its rule says and each twin answers
    as eager code does, bit for bit.  Returns the children's peak
    reservation in MiB."""
    import torch

    from deeprest_tpu_torch.analysis.torch_fixtures import (
        DEMO_CHILD, PAIRS, RUNTIME,
    )

    procs = {}
    for case, rel in RUNTIME.items():
        for twin in ("bad", "good"):
            path = os.path.join(workdir, "lint_fixtures",
                                case.replace(" ", "_"), twin, rel)
            if not os.path.exists(path):
                _, bad, good = PAIRS[case]
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w", encoding="utf-8") as fh:
                    fh.write((bad if twin == "bad" else good)[rel])
            procs[(case, twin)] = subprocess.Popen(
                [sys.executable, "-c", DEMO_CHILD, path], cwd=REPO,
                env={**os.environ, "PYTHONPATH": REPO},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    res = {}
    for key, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0 or not out.strip():
            fail(f"phase 22: {key}'s demo exited {proc.returncode}: "
                 f"{err[-2000:]}")
        res[key] = json.loads(out.strip().splitlines()[-1])

    def values(key):
        got = res[key]
        if "error" in got:
            fail(f"phase 22: {key} raised {got['error']}: {got['message']}")
        return [torch.tensor(v) for v in got["values"]]

    def same(a, b) -> bool:
        return bool(torch.equal(a, b))

    replay, old, new = values(("TX001", "bad"))
    if not same(replay, old) or same(replay, new):
        fail(f"phase 22: TX001's replay after the rebinding {replay} is "
             f"not the old weight's answer {old}")
    replay, _, new = values(("TX001", "good"))
    if not same(replay, new):
        fail(f"phase 22: TX001's copy_ twin {replay} != eager {new}")
    ya, yb, a2, b2 = values(("TX004", "bad"))
    if not (same(ya, b2) and same(yb, b2)) or same(ya, a2):
        fail(f"phase 22: TX004's held output {ya} is not the second "
             f"call's answer {b2}")
    ya, yb, a2, b2 = values(("TX004", "good"))
    if not (same(ya, a2) and same(yb, b2)):
        fail(f"phase 22: TX004's clone twin {ya}, {yb} != eager {a2}, {b2}")
    bad = res[("JX007 capture", "bad")]
    (path, line), = fired["JX007 capture"]
    where = f"{os.path.basename(path)}:{line} "
    if bad.get("error") != "GraphCaptureError" or where not in bad.get(
            "message", ""):
        fail(f"phase 22: JX007's fixture names {where.strip()}, its "
             f"capture gave {bad}")
    replay, eager = values(("JX007 capture", "good"))
    if not same(replay, eager):
        fail(f"phase 22: JX007's twin replay {replay} != eager {eager}")
    print(f"lint hazards on the card (phase 22): TX001 replay after a "
          f"rebinding = the old weight's eager answer bit for bit, its "
          f"copy_ twin = the new one's; TX004 output held across a second "
          f"run = the second call's answer, its clone twin = the first's; "
          f"JX007 capture refused at {where.strip()} as the rule names "
          f"({bad['message'][:160]}), its twin's replay = eager bit for "
          f"bit", flush=True)
    return max(r["reserved_mib"] for r in res.values())


def phase_lint(workdir: str, memory: DeviceMemory) -> dict:
    """Phase 22: the port's analyzer (deeprest_tpu_torch/analysis) on a
    machine without JAX, in processes of its own: ``lint --no-cache
    --format json`` over the installed port exits 0 with 0 findings;
    ``--list-rules`` lists the 36 rules and the 4 GL meta rules; the
    module alias ``python3 -m deeprest_tpu_torch.analysis --rules HY001``
    on a file with one unused import exits 1 with that one finding; the
    analyzer's modules import neither ``jax`` nor ``deeprest_tpu``; the
    torch fixtures fire and their twins do not (:func:`lint_fixtures`);
    and three of them run their hazard on the card
    (:func:`lint_hazards_on_card`).  Its peak is the run-wide sampler's
    over the phase (``memory`` runs it as "phase 22")."""
    import re

    t0 = time.perf_counter()
    report = json.loads(lint_cli(["lint", "--no-cache", "--format", "json"],
                                 expect=0))
    lint_s = time.perf_counter() - t0
    if report["counts"]["findings"] != 0 or report["files"] < 95:
        fail(f"phase 22: the port does not lint clean: {report['counts']} "
             f"over {report['files']} files")
    ids = set(re.findall(r"^([A-Z]{2}[0-9]{3})  ",
                         lint_cli(["lint", "--list-rules"], expect=0),
                         re.MULTILINE))
    meta = {i for i in ids if i.startswith("GL")}
    tx = {i for i in ids if i.startswith("TX")}
    if len(ids) != 40 or len(meta) != 4 or len(tx) != 5:
        fail(f"phase 22: --list-rules listed {len(ids)} ids ({len(meta)} "
             f"GL, {len(tx)} TX): {sorted(ids)}")
    bad = os.path.join(workdir, "lint_unused_import.py")
    with open(bad, "w", encoding="utf-8") as f:
        f.write("import os\nprint(1)\n")
    alias = json.loads(lint_cli(
        [bad, "--rules", "HY001", "--no-cache", "--format", "json"],
        expect=1, module="deeprest_tpu_torch.analysis", cwd=workdir))
    if [(x["rule"], x["line"]) for x in alias["findings"]] != [("HY001", 1)]:
        fail(f"phase 22: the module alias found {alias['findings']}")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import importlib, pkgutil, sys\n"
         "import deeprest_tpu_torch.analysis as a\n"
         "for m in pkgutil.iter_modules(a.__path__, a.__name__ + '.'):\n"
         "    importlib.import_module(m.name)\n"
         "print(sorted(n for n in sys.modules if n == 'jax' "
         "or n.startswith(('jax.', 'deeprest_tpu.'))"
         " or n == 'deeprest_tpu'))"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    if probe.returncode != 0 or probe.stdout.strip() != "[]":
        fail(f"phase 22: the analyzer imported {probe.stdout.strip()} "
             f"{probe.stderr[-1000:]}")
    fired = lint_fixtures(workdir)
    reserved = lint_hazards_on_card(workdir, fired)
    seconds = time.perf_counter() - t0
    peak = memory.phase_peaks.get("phase 22", 0)
    print(f"lint (phase 22): 0 findings over {report['files']} files, "
          f"{report['counts']['suppressed']} suppressed; {len(ids)} rule "
          f"ids; the module alias exit 1 with one HY001; no jax or "
          f"deeprest_tpu module imported; lint {lint_s:.1f} s, phase "
          f"{seconds:.1f} s; the card's peak in use over the phase "
          f"{peak} MiB (every process on it), the hazard processes' "
          f"reservation {reserved:.0f} MiB ({card_line()})", flush=True)
    return {"files": report["files"], "lint_s": lint_s, "seconds": seconds,
            "peak_mib": peak}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "deeprest_tpu_torch")):
        print("FAIL: chip_smoke.py needs the deeprest_tpu_torch package "
              "beside it", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # The card's machine sets PYTHONDONTWRITEBYTECODE and its torch ships
    # no bytecode, so every process would compile torch (and, at its first
    # custom-op call, torch._dynamo) from source: ~13 s a process, over 30
    # processes here.  This run compiles them once, into the gitignored
    # build/pycache, and its CLI and server processes read them there.
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(REPO, "build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; chip_smoke.py runs "
              "on a GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeprest_tpu_torch.benchmarks import kernel_tuning
    from deeprest_tpu_torch.ops import build, cuda_gru

    seconds, peaks = {}, {}
    memory = DeviceMemory()

    def timed(name, fn, *args):
        memory.take_peak()
        memory.phases.append(name)
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        memory.phases.remove(name)
        peaks[name] = memory.take_peak()
        return out

    regs = timed("build", phase_build, build, cuda_gru, kernel_tuning)
    max_abs_err = timed("kernel checks", phase_kernel_checks, cuda_gru)
    times = timed("kernel times", phase_times, cuda_gru)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=os.path.join(REPO, "build")) as wd:
        serving = timed("main path", phase_main_path, cuda_gru, wd)
        # phase 7's simulate and featurize CLIs (host only) run beside
        # phase 6
        corpus = start_raw_corpus(wd)
        trained = os.path.join(wd, "trained")      # phase 21's tenant t1
        training = timed("training", phase_training, cuda_gru, trained)
        # phases 16 and 17 only spawn gloo ranks (no kernel of theirs
        # launches in this process): 16 runs beside phases 7 and 8, 17
        # beside phase 12
        axes_job = Background("phase 16", phase_expert_model_axes,
                              cuda_gru, serving, wd, memory=memory)
        raw = timed("raw to answers", phase_raw_to_answers, cuda_gru, corpus)
        raw_launches = raw["launches"]
        raw_path = raw["raw"]
        social = (raw["ckpt"], raw["sample"])
        for k in cuda_gru.KERNELS:
            k.launches = 0
        plane = timed("serving plane", phase_serving_plane, cuda_gru,
                      serving, raw, wd)
        del raw
        axes = timed("wait for phase 16", axes_job.result)
        seconds["expert and model axes (beside 7, 8)"] = round(
            axes_job.seconds, 1)
        elastic_job = Background("phase 17", phase_elastic, cuda_gru, wd,
                                 memory=memory)
        for k in cuda_gru.KERNELS:
            k.launches = 0
        replicas = timed("replica plane", phase_replica_plane, cuda_gru,
                         serving, plane, wd)
        elastic = timed("wait for phase 17", elastic_job.result)
        seconds["elastic remeshing (beside 12)"] = round(
            elastic_job.seconds, 1)
        # phase 19's ranks (its kernels launch in them only) beside 10
        mesh_job = Background("phase 19", phase_serve_mesh, cuda_gru,
                              serving, axes, plane, wd, memory=memory)
        tenk = timed("tenk sparse quant export", phase_tenk, cuda_gru,
                     serving, wd)
        serve_mesh = timed("wait for phase 19", mesh_job.result)
        seconds["serve --mesh (beside 10)"] = round(mesh_job.seconds, 1)
        # phase 21's ranks and workers (its kernels launch in them only)
        # beside 13 and 11; its one-process references after phase 20's,
        # before the reset
        plane_job = Background("phase 21", phase_serve_mesh_plane, serving,
                               trained, plane, wd, memory=memory)
        fleet = timed("fleet tier", phase_fleet, cuda_gru, serving, wd)

        # phase 20's ranks (its kernels launch in them only) beside 14 and
        # 15, after phase 11 (beside it the card held 80.8-81.1 GB), its
        # one-process references after them, before the reset
        for k in cuda_gru.KERNELS:
            k.launches = 0
        free_device()     # this process's cached blocks, back first
        stream = timed("streaming retrain", phase_stream, cuda_gru,
                       raw_path, wd)
        quant_job = Background("phase 20", phase_serve_mesh_quant, serving,
                               plane, raw_path, social, wd, memory=memory)
        # phase 15's gloo ranks run beside phase 14's demo
        host = timed("host feed, train flags and demo", phase_host_feed,
                     cuda_gru, *social, wd, lambda: start_gloo_ranks(wd))
        dp = timed("data axis", phase_data_parallel, cuda_gru, host)
        axes["k2_k3_ms_e20"] = timed("K2/K3 at an expert rank's share",
                                     axes_k2_k3_times, cuda_gru, times)
        mesh_quant = timed("wait for phase 20", quant_job.result)
        seconds["serve --mesh --quant --watch (beside 14, 15)"] = round(
            quant_job.seconds, 1)
        timed("phase 20 against one process", check_serve_mesh_quant,
              cuda_gru, serving, social, mesh_quant)
        mesh_plane = timed("wait for phase 21", plane_job.result)
        seconds["serve --mesh replicas, admission, autoscaler and fleet "
                "(beside 13, 11)"] = round(plane_job.seconds, 1)
        timed("phase 21 against one process", check_serve_mesh_plane, axes,
              serving, trained, mesh_plane)
        # phase 22's lint runs in processes of its own (no kernel) beside
        # phase 18
        lint_job = Background("phase 22", phase_lint, wd, memory,
                              memory=memory)
        for k in cuda_gru.KERNELS:
            k.launches = 0
        raw_side = timed("raw side native tools", phase_raw_side, cuda_gru,
                         raw_path, social[0], wd)
        timed("wait for phase 22", lint_job.result)
        seconds["lint (beside 18)"] = round(lint_job.seconds, 1)
    blocked = timed("blocked", phase_blocked, cuda_gru, kernel_tuning)
    timed("bidirectional", phase_bidir, cuda_gru, kernel_tuning)
    timed("stash steps", phase_stash_steps, cuda_gru)
    sweep = timed("tuning sweep", phase_tuning_sweep, cuda_gru)

    launches = dict(training["launches"])
    launches["gru_fwd"] += (serving["launches"] + plane["launches"]
                            + replicas["launches"] + fleet["launches"])
    for name, count in raw_launches.items():
        launches[name] += count
    for name, count in tenk["launches"].items():
        launches[name] += count
    for name, count in stream["launches"].items():
        launches[name] += count
    for name, count in host["launches"].items():
        launches[name] += count
    for name, count in dp["launches"].items():
        launches[name] += count
    for name, count in axes["launches"].items():
        launches[name] += count
    for name, count in elastic["launches"].items():
        launches[name] += count
    for name, count in raw_side["launches"].items():
        launches[name] += count
    launches["gru_fwd"] += serve_mesh["launches"]["gru_fwd"]
    launches["gru_fwd"] += mesh_quant["launches"]["gru_fwd"]
    launches["gru_fwd"] += mesh_plane["launches"]["gru_fwd"]
    sources = {"gru_fwd": ("gru_fwd.cu", "deeprest_tpu/ops/pallas_gru.py:156"),
               "gru_fwd_train": ("gru_fwd.cu",
                                 "deeprest_tpu/ops/pallas_gru.py:164"),
               "gru_bwd": ("gru_bwd.cu", "deeprest_tpu/ops/pallas_gru.py:298")}
    line = {"kernels": []}
    for name, (src, replaces) in sources.items():
        bf16 = times[name]["bfloat16"]
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"deeprest_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_abs_err[name],
            "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
            "library_ms": bf16["library_ms"], "design": DESIGNS[name][0],
            **{k: v for k, v in regs[name].items() if k != "f32"}})
        print(f"f32 {name}: {json.dumps({**times[name]['float32'], **regs[name]['f32']})}",
              flush=True)
    line["kernels"].append({
        "name": "gru_fwd_blocked", "route": "cuda",
        "source": "deeprest_tpu_torch/csrc/gru_fwd_blocked.cu",
        "replaces": "benchmarks/kernel_tuning.py:134",
        "launches": sweep["kernel_launches"]["gru_fwd_blocked"],
        **{k: blocked[k] for k in (
            "max_abs_err", "ms", "fastest_ms", "fastest_blocking",
            "blocking_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "design": DESIGNS["gru_fwd_blocked"][0],
        **{k: v for k, v in regs["gru_fwd_blocked"].items() if k != "f32"}})
    print(f"f32 gru_fwd_blocked: "
          f"{json.dumps({**blocked['float32'], **times['gru_fwd_blocked']['float32'], **regs['gru_fwd_blocked']['f32']})}",
          flush=True)
    print(f"main-path launches: serving gru_fwd {serving['launches']}; "
          f"training {training['launches']}; raw telemetry to answers "
          f"{raw_launches}; serving plane gru_fwd {plane['launches']} "
          f"(the servers' ledgers); replica plane gru_fwd "
          f"{replicas['launches']} (the workers' ledgers, and the killed "
          f"and reloaded workers' before they went); fleet tier gru_fwd "
          f"{fleet['launches']} ({fleet['tenants']} tenants in-process and "
          f"the fleet server's ledger); 10k sparse, quantized "
          f"and exported "
          f"{tenk['launches']}; streaming retrain {stream['launches']} "
          f"(f32: the stream CLI runs and the verdict server "
          f"{stream['f32_launches']}); host feed, train flags and demo "
          f"{host['launches']}; data axis (NCCL world size 1, both gloo "
          f"ranks, the --mesh CLI) {dp['launches']}; expert and model "
          f"axes (both gloo ranks: training on 1x2x1 and 1x1x2, the "
          f"Predictor on both) {axes['launches']}; elastic remeshing "
          f"(both gloo ranks, all three arms) {elastic['launches']}; "
          f"raw side (phase 7's checkpoint on the natively and the numpy "
          f"featurized corpus) {raw_side['launches']}; serve --mesh (both "
          f"gloo ranks: warm-up, requests and their replays) "
          f"{serve_mesh['launches']}; serve --mesh --quant int8 --watch "
          f"(both gloo ranks: warm-ups, the envelope probes, the reload, "
          f"requests, the surface and the verdict sweep) "
          f"{mesh_quant['launches']}; serve --mesh with replicas, "
          f"admission, the autoscaler and the fleet (both gloo ranks: "
          f"warm-ups, the mesh's requests and their replays, t1's one-device "
          f"plane on rank 0; the process plane's workers) "
          f"{mesh_plane['launches']}; "
          f"tuning sweep "
          f"{sweep['kernel_launches']}", flush=True)
    memory.stop()
    print(memory.top_line(), flush=True)
    print(f"seconds per phase {seconds}", flush=True)
    print(f"peak device memory per phase (MiB in use on the card by every "
          f"process, nvidia-smi every 2 s) {peaks}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
