#!/usr/bin/env python3
"""Drives the PyTorch port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # one card
    python3 chip_smoke.py --data-parallel 4    # collectives and training on 4 cards
    python3 chip_smoke.py --data-parallel 4 --launcher-only
                                   # only phase 8's drills, on 4 cards
    python3 chip_smoke.py --data-parallel 4 --model-parallel-only
                                   # only phase 9's configurations, on 4 cards
    python3 chip_smoke.py --data-parallel 4 --control-plane-only
                                   # only phase 10's checks, on 4 cards
    python3 chip_smoke.py --data-parallel 4 --zoo-only
                                   # only VGG-16 and Inception V3, on 4 cards
    python3 chip_smoke.py --data-parallel 4 --fleet-only
                                   # only the serving fleet, a replica a card
    python3 chip_smoke.py --data-parallel 4 --observability-only
                                   # only phase 14's window, merge and drill
    python3 chip_smoke.py --data-parallel 4 --store-only
                                   # only phase 15's worlds on the store
    python3 chip_smoke.py --data-only
                                   # only phases 1 and 16, on one card
    python3 chip_smoke.py --data-parallel 4 --data-only
                                   # only phase 16's data path, on 4 cards
    python3 chip_smoke.py --data-parallel 4 --autotune-only
                                   # only phase 17's tuner and sweep, on 4 cards

Phases, each of which raises (and so exits non-zero) when it fails:

1. setup: the card's name and power limit, the kernels built from the
   sources in ``horovod_tpu_torch/csrc`` (one nvcc per source, started
   together) with each build's ``ptxas -v`` lines (registers, spills,
   static shared bytes), TF32 off;
2. every kernel against its plain PyTorch version at its path's shapes,
   timed beside its bound and a library call that computes the same
   function: the paged-decode kernel (serving; its split and merge
   kernels' device ms per call from torch.profiler, beside CUDA-event ms;
   bf16 at KVH 16 and 4, f32; then at the speculative verify step's
   geometry, ``paged_decode verify geometry:``: 8 slots' tables each
   repeated K+1 = 5 times, lengths len_s+1 .. len_s+5 with one slot's
   rows past the table, its first copies bitwise the 8 rows alone; its
   bound reads each slot's K/V rows once), then
   the flash forward
   and the two flash backward kernels (training: B=8, S=2048, H=16,
   D=64, bf16, causal; plus f32, offset, fully masked and ragged cases;
   the timed line is followed by a ``forward`` line with the forward's
   TFLOP/s, share of its bound and factor against sdpa's forward, and a
   ``backward`` line with the same for each backward kernel and the
   pair),
   then the conv+BN forward and backward kernels at every distinct 1x1
   conv of ResNet-50 at 128 images (each timed beside the cuBLAS GEMMs
   alone and summed over a ResNet-50 step; plus f32 ragged and wide
   cases and bf16 ragged ones), then the stream copy bit
   for bit at bench.py's probe shape (bf16 [131072, 1024]), ragged and
   misaligned; then the stream copy's own path, the bandwidth probe
   (``bandwidth:`` line: ms and GB/s of torch's elementwise pass, copy_
   and the kernel at 1, 4, 16 and 64 rows per CTA);
3. serving at full width: the flagship TransformerLM (268M parameters,
   random weights from a seed) served through ``ServeScheduler.run`` —
   the launch counts are zeroed just before and read just after, and the
   kernel is then held against its plain version on the engine's live
   pool; then a decode profile;
4. training at full width and depth: the flagship as ``bench.py
   transformer`` builds it (batch 8 x 2048, bf16, SGD with momentum),
   one warm-up step and then ``train_loop`` steps through an NCCL world
   of one — launch counts zeroed just before and read just after, losses
   finite, at least 16 launches of each flash kernel per step; then a
   profile of one step. Then the same through
   ``make_transformer_train_step_fused`` (buckets launched from the
   gradient hooks, EpilogueSGD in each bucket's epilogue): at tier none
   its losses against the unfused step's, then at fp8_e4m3 with error
   feedback (``train fused:`` line: losses, step ms, buckets, wire and
   logical bytes). Then ResNet-50 with ``fused_conv_bn=True`` as
   ``bench.py`` trains it (224^2, bf16, 128 images, SGD with momentum
   through the bucketed, hook-launched ``DistributedOptimizer`` and
   ``data_parallel_train_step``): at least 36 launches of each conv+BN
   kernel per step, every bucket launched from the hooks, then a profile;
5. card against CPU: a 2-layer f32 serving engine (greedy tokens
   identical, logits within 1e-4), a 2-layer f32 training copy (loss,
   every gradient leaf and the parameters after two SGD steps), a small
   f32 fused ResNet (logits, running statistics, every gradient leaf, the
   parameters after two SGD steps) and the tiny f32 fused step at
   fp8_e4m3 with error feedback (losses, parameters, residual). Before
   them, the resilient loop at full width and depth (``resilient
   train:``): the flagship through ``train_loop`` and an
   ``AsyncCheckpointer`` at interval 2, uninterrupted for 1+4 steps
   (beside a PreemptionHandler that is never asked to stop), then
   from a fresh state preempted at step 3 (exit code 75, the quiesce step
   the only one committed), then a third fresh state restored and run to
   step 5,
   bitwise equal to the uninterrupted parameters and momentum; with the
   snapshot's bytes, the on-path ms of a save (call to copy landed),
   the background write s, the restore s and the share of step time
   ``HOROVOD_CKPT_INTERVAL=auto`` would pay;
6. collectives (world 1): every collective of ``ops.collectives`` and
   ``ops.sparse`` (allgather, alltoall with and without splits,
   reducescatter, ppermute, broadcast, an axis allreduce, the sparse
   allreduce) through NCCL on CUDA tensors, then ``init(mesh_shape=(1,
   1))`` and the hierarchical and two-level allreduce (also with the fp8
   codec), each equal to its plain result;
7. Horovod's PyTorch API (world 1): every ``*_async`` form at a small odd
   size and at 1 MiB, bitwise equal to its synchronous form (allgather,
   alltoall and reducescatter also on the process set [0]), ``join()``
   returning 0, Adasum as the identity, ``DistributedAdasumOptimizer``
   equal to its inner SGD bit for bit, ``SyncBatchNorm`` against batch
   norm, and the object broadcasts (``horovod api (world 1):`` line);
8. the launcher and elastic training (``launcher (world 1):`` line),
   each launch through ``python -m horovod_tpu_torch.runner.launch``
   (``hvdrun-torch``) with this file as the worker (``--worker <name>
   <spec.json>``): ``-np 1 --auto-resume 1 --ckpt-dir D`` runs the
   flagship at full width and depth through ``train_loop`` with an
   AsyncCheckpointer at interval 2, preempted at step 3 by chaos
   ``preempt_at`` (exit 75), relaunched with HVD_RESUME_ATTEMPT=1,
   restored at step 3 and run to step 5: its parameters and momentum
   bitwise phase 5's uninterrupted run (sha256 of every tensor), with
   the relaunch s (exit 75 to attempt 1's first step), the process
   start s and the restore s; then an elastic launch of one slot
   (``--min-np 1 --max-np 1 --elastic-local``) of ResNet-50
   (``fused_conv_bn=True``, 128 images) over 1,024 synthetic images
   with ``TorchState(model, optimizer, sampler)`` committed every step,
   which exits 73 once after a commit: generation 2 restores the
   committed state bitwise and finishes the epoch, every index once;
9. model parallelism in a world of one (``model parallel (world 1):``):
   the ring's per-step bodies (``ring_fwd_step``, ``ring_bwd_step``)
   with the flash kernels over four virtual ring positions of a
   full-width sequence (B=8, S=2048, H=16, D=64, bf16, causal: launches
   at nonzero offsets), assembled, against ``flash_attention`` over the
   whole sequence and its backward (FLASH_REL_TOL); then a mesh whose
   every axis has size 1 (dp, tp, sp, ep, pp), whose step (the dense
   flagship with tp, ring sp and pp, and the MoE one with ep and 8
   experts, full width, MP_PARITY_LAYERS layers) equals the plain step
   bitwise: loss and every gradient leaf;
10. the control plane in a world of one (``native core:`` and ``control
    plane (world 1):`` lines): the native core's status (built with g++),
    then ResNet-50 (``fused_conv_bn=True``, 128 images) for CP_STEPS SGD
    steps with each of its 161 gradients summed by ``allreduce_async``
    from its post-accumulate hook and then synchronized (reference
    Horovod's torch idiom, through the fusion-cycle coordinator's cycle
    thread), bitwise equal to the same steps through
    ``DistributedOptimizer``; cycles, bins, tensors and plan-cache hits
    per step; the sync of one step's gradients timed through the
    coordinator, through it at HOROVOD_FUSION_THRESHOLD=0 (one bin per
    tensor) and by the direct path (one started allreduce per
    tensor), with the host ms of a cycle and of a bin's dispatch; and a
    burst of integer-valued tensors of the gradients' shapes, exact, with
    its timeline (which must load with json);
11. the model zoo on one card (``zoo train <name>:`` lines, each after
    a ``zoo profile <name>:`` line), bf16, weights from a seed, through
    ``DistributedOptimizer`` (SGD 0.01, momentum 0.9) and
    ``data_parallel_train_step`` in an NCCL world of one, a warm-up and
    ZOO_STEPS steps each: VGG-16 at 224^2 and 128 images, Inception V3 at
    299^2 and INCEPTION_B images, and ResNet-50 with ``folded_bn=True``
    (as ``bench.py`` builds it), with plain batch norm, and with the
    space-to-depth stem and ``folded_bn``: step ms (median and range),
    images/s, peak memory, the device's busy share and kernel launches of
    a profiled step (``zoo folded_bn against batch norm:``); then the
    narrow f32 zoo card against CPU (``zoo card vs cpu``: VGG-11 at 32^2
    and ResNet-18 with both options at 64^2 in train mode, Inception V3
    at 75^2 in eval mode, then in train mode part by part against the
    CPU in f64: its stem's layers and each of its eleven blocks, outputs,
    statistics and gradients);
12. speculative serving (``spec serving:``): phase 3's traffic through
    the flagship at full width and depth in three modes, off, ngram:3
    and truncate:4 (4 of 16 layers), each at K = 4: decode tokens/s,
    decode steps, TPOT p50/p99, acceptance, the share of requests whose
    tokens equal the off run's (every request must keep every token);
    then the same prefixes through decode steps (M = 8) and one verify
    step (M = 40), each row's largest logit difference (every row must
    be bitwise its decode row), each operation of the decode body at M =
    8 and M = 40 on the same rows (which first differs bit for bit; the
    MLP's output product does, and the other products and the norms'
    means now and then by a bf16 step, so the verify step runs them in
    chunks of 8 rows, ``mlp_chunked``), and the verify step's body timed
    whole and
    chunked (device ms, launches). The truncate:4
    draft's ``propose_drafts`` must give, bitwise, the greedy tokens of a
    plain engine on the model cut to its first 4 layers. Then the
    train-to-serve handoff (``serve handoff:``): ``load_for_serving`` of
    the snapshot phase 4's preempted run committed, its parameters
    bitwise those the snapshot was taken of, and an engine built from
    them gives the tokens of one built from those parameters directly.
13. the serving fleet and the metrics export (``fleet (world 1):``):
    phase 3's traffic through ``ServingFleet`` on the flagship: a fleet
    of one gives the bare engine's tokens bitwise while a
    ``MetricsServer`` on a free local port is scraped over loopback
    (``/metrics`` with ``hvd_serve_*``, ``/healthz`` with the serving and
    fleet blocks); two replicas on the card run the drain drill (nothing
    dropped, the leaver's whole pool free), the replica_kill drill at the
    router's dispatch path twice (every request served with the bare
    tokens, the same re-admission order) and the replica_slow drill;
    decode tokens/s, TTFT and TPOT p50/p99, each replica's join seconds
    and builds.
14. observability (``observability ...`` lines): the flagship at full
    width and depth built under each HOROVOD_TPU_MATMUL_PRECISION of
    float32, tensorfloat32 and bfloat16 from the same weights and
    batches, OBS_STEPS steps each through ``train_loop`` (step ms, flash
    launches, the first loss bitwise float32's and the others within
    OBS_LOSS_TOL, the TF32 flags off again after every step) and one
    profiled step (device ms, and the CE backward's device ms: the kernels
    launched inside ``blockwise_ce.backward``); a
    HOROVOD_TRACE_PROFILE=steps:2@2 window over the fused flagship
    (``profile_attribution.json`` present, no collective events in a world
    of one, every bucket's device ms, step ms inside the window and out);
    ResNet-50 through ``allreduce_async`` with HOROVOD_NUMERICS off and on
    in turns (step ms, conv+BN launches, the aggregates' kernels per bin
    from a profiled step of each), then one step's bins dispatched under
    ``torch.cuda.set_sync_debug_mode("error")`` with a NaN in one
    gradient, which the monitor's drain names by its bin entry and
    parameter; and the run-ledger record ``shutdown`` writes, read back.
15. the compiled-artifact store (``artifact store (world 1):``): each
    incarnation a child process with an empty build directory of its own
    (``_build.BUILD_DIR`` set in the child under ``build/artifact_store``,
    removed after the phase) on one fresh store there: (a) cold, the six
    kernels built by nvcc and published (each build's seconds); (b) warm,
    all six written from the store, no nvcc, each library's sha256 the
    cold one's, each kernel held against its plain version at phase 2's
    main shapes and tolerances (ms to resolve each, compile seconds
    saved); (c) the flagship at phase 4's configuration, 2 steps through
    ``train_loop``, cold (in (a)'s child) then warm on a fresh build
    directory: ``store_step`` miss then hit, no nvcc in the warm child,
    the losses and parameters bitwise; (d) a warm fleet of one serves 4 of
    phase 3's requests, ``builds == 0``, ``store_outcomes`` hit, the tokens
    bitwise phase 3's; (e) chaos: ``store_corrupt`` (one logged miss, one
    rebuild, a republish, the steps bitwise) and ``fs_transient`` scope
    store (retried, nothing fails).
16. the data path (``data ...`` and ``estimator`` lines, after the data
    path's optional packages present): (a) ``data loader resnet50:``
    phase 4b's ResNet-50 (128 images of 224^2 a card, fused conv+BN)
    through ``train_loop``, fed once by ``AsyncDataLoaderMixin`` +
    ``ShardedArrayLoader`` from seeded host arrays (bf16, pinned staging,
    a copy stream) and once by the same batches already on the card:
    losses bitwise equal, step ms of both, ms a batch of a pinned copy,
    and from torch.profiler over loaded steps the HtoD copies' device ms
    and the part of it overlapped with kernels; each rank's rows of the
    first global batch gathered against the global batch; the conv+BN
    launch counts of the loaded run; (b) ``data service train:`` phase
    4's flagship train cell through ``train_loop`` fed by a
    ``ResilientDataIterator`` over 3 ``DataWorker`` processes (a registry
    here, an ``ElasticSampler``), once clean and once with
    ``HOROVOD_CHAOS_SPEC`` ``data_worker_kill`` (worker 1 after 2
    requests): losses bitwise equal, at least one worker death and
    reshard, the seconds from the kill to the reshard, step ms, the
    goodput input-wait share, the flash launch counts; then one pass of
    ``distribute`` over a source-sharded service, every sample once;
    (c) ``estimator:`` ``TpuEstimator.fit`` of the MNIST MLP through a
    ``TpuExecutor`` of one worker on the card, 3 epochs: the history
    decreasing, ``predict`` on the card against the CPU within
    ``DATA_PREDICT_TOL``.
17. the online tuner (``autotune ...`` lines): (a) ``autotune (world
    1):`` ResNet-50 (``fused_conv_bn=True``, 128 images) stepped through
    the coordinator from the gradient hooks (phase 10's path) with
    HOROVOD_AUTOTUNE on (warmup 1, 3 cycles a sample, 8 samples, a CSV
    log), the card synchronized before each ``StepStats.end``, until the
    tuner converges: each sample's knobs and score, the converged knobs
    (every value inside its box), the tuner's host us an update, cycles
    and conv+BN launches a step, the peak memory after the first step
    and after tuning; its losses and parameters bitwise an untuned run's
    of as many steps; then the median step ms of AT_TIMED_STEPS steps at
    the defaults and at the converged knobs, in turns; every override
    cleared after. (b) ``autotune bucket auto (world 1):``
    HOROVOD_GRADIENT_BUCKET_BYTES=auto on a fresh cache: a miss gives 25
    MiB and one warning; ``sweep_bucket_bytes`` measures the five
    candidates (a profiled step each) and caches the winner, which a
    fresh ``DistributedOptimizer`` resolves; a child process on the same
    HOROVOD_ARTIFACT_STORE gets the sweep warm, measuring nothing.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the
package, it exits non-zero and prints no result.

``--data-parallel N`` runs only the collectives and training across N
cards of one host (``--data-parallel N --resilient-only``: only the
interrupt-and-resume check of the last paragraph; ``--api-only``: only
the Horovod API world below): one process per card joins an NCCL world
through the launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``). First the collectives (``collective
<name>:`` lines): allgather (even and uneven), alltoall (even and with
splits), reducescatter (even and uneven), ppermute (a ring), broadcast on
a process set and the sparse allreduce, each at a small odd size and at
64 MiB (nccl-tests' sizes), every rank's result equal to plain torch on
every rank's input (integer values, so sums are exact), with ms and bus
bandwidth, and beside the even ones the ms of the one torch.distributed
call they map to; then ``hierarchical_allreduce`` on (cross 2, local N/2) and
``two_level_allreduce`` on (dcn 2, local N/2) equal to the flat allreduce
at 25 MiB and 256 MiB, with ms beside the flat one's. Then training, each
rank on its rows of the global batch (8 sequences of the flagship, 128
ResNet-50 images, per card). The variants: the unfused flagship, ResNet-50
with the default buckets and with one bucket after the backward
(HOROVOD_GRADIENT_BUCKET_BYTES=0), the fused flagship at tier none and
fp8_e4m3, and the fused flagship through the two-level tier
(HOROVOD_DCN_VIRTUAL_SLICES=2, HOROVOD_DCN_SCHEDULE=two_level) at tier
none and fp8_e4m3 with error feedback; the first two also on one card,
first, as the yardstick. Each ``data parallel <variant>:`` line gives step
ms, throughput, the scaling efficiency where there is a yardstick, from
one profiled step the NCCL kernels' device ms and the part of it that
overlapped compute kernels, and the schedule with its wire and DCN-stage
bytes; every rank must end with the same parameters, a two-level variant's
DCN stage must carry what the schedule predicts, and at tier none its
losses must stay within FUSED_LOSS_REL_TOL of the flat variant's. Then
Horovod's PyTorch API on N cards (``horovod api data parallel:``), one
world running ResNet-50 (``fused_conv_bn=True``, 128 images a card) as a
Horovod script does: each rank builds its own weights and takes one local
SGD step, then ``broadcast_parameters`` and ``broadcast_optimizer_state``
from rank 0 (every parameter, buffer and momentum bitwise rank 0's on
every rank), ``broadcast_object`` and ``allgather_object``; three steps
through ``DistributedAdasumOptimizer`` (the first one's combined delta
against a plain f64 Adasum of the gathered local deltas) and one of
``DistributedOptimizer(op=Adasum)``, beside three of ``op=Average``, with
step ms, images/s and the ms of the Adasum combination alone; one Adasum
step on (cross 2, local N/2) with rank N-1 joined against the
active-count rule; an uneven epoch of [3, 3, 3, 2] batches through
``grouped_allreduce_async``, ``poll``, ``synchronize`` and ``join`` (the
last step's averages against the mean over the active ranks, ``join()``
returning N-2, the next allreduce over everyone); ``SyncBatchNorm`` at
128 x 56 x 56 x 256 bf16 a card against a plain batch norm over the
gathered batch; and every ``*_async`` form at a small odd size and 64
MiB, also on the ragged set [0, 1, 2], bitwise equal to its synchronous
form. After every step every rank's parameters are bitwise equal, and
each ResNet-50 step launches each conv+BN kernel at least 36 times. Last,
the resilient check on N cards (``resilient train data parallel:``): the
fused flagship at fp8_e4m3 with error feedback through ``train_loop``,
uninterrupted with chaos ``commit_deny`` at step 4 (step 2 must stay the
only committed snapshot) beside a PreemptionHandler polling the store
every step, with the times of the steps right after a save and of the
others, preempted at step 3 (step 3 the only one committed, read after
rank 0's rotation), and resumed by a fresh
state: bitwise the uninterrupted parameters, momentum and residual on
every rank, each rank's residual its own. Every N-card world forms its
process group over a TCPStore that rank 0 binds to a port of the OS's
choosing, and stops all ranks as soon as one fails. Last, the drills of
phase 8 on N cards (``--data-parallel N --launcher-only``: only these),
each through ``hvdrun-torch``: ``launcher data parallel:`` (``-np N
--auto-resume 1``, the fused flagship at fp8_e4m3 with error feedback,
uninterrupted, then preempted at step 3 and relaunched: bitwise on every
rank, parameters, momentum and each rank's residual); ``elastic data
parallel:`` (``--min-np 2 --max-np N --elastic-local --slots 1`` over a
discovery script of N fake hosts, ResNet-50 at 128 images a card, an
ElasticSampler over 16 x 512 synthetic images, ``TorchState`` committed
every step: rank N-1 exits 1 at its fifth batch and drops its host, so
the world goes N -> N-1 after the 5 s grace, then rank 0 drops host
n(N-2) from the script and it goes N-1 -> N-2; every index of the epoch
once, every rank bitwise equal after every step, each generation
restoring its last commit bitwise, the first generation's ranks on
distinct cards; with the recovery s, the step ms at each world size and
the cards); and ``resize data parallel:`` (N ranks as hosts of 2, the
fused fp8 flagship at full width and RESIZE_LAYERS layers, chaos
``host_loss`` of host 1 at step 3: ranks 2-3 snapshot and leave, 0-1 go
on in process on a two-rank NCCL world, bitwise a cold two-rank start
from the committed snapshot and plan; with ``hvd_elastic_resize_seconds``).
Last, model parallelism on N cards (``--data-parallel N
--model-parallel-only``: only these), one world whose ranks re-init on
each configuration's mesh: tp N, sp N ring, sp N Ulysses, (tp 2, sp 2)
ring, ep N with 8 experts and pp N with 4 microbatches, each of the
flagship (no dp axis; the global batch 8 x 2048), then (dp 2, tp 2) on
four cards (4 x 2048 a dp rank, 8 heads a card). Each ``model parallel
<label>:`` line holds: the sharded step's loss and gathered gradients
against the unsharded step on the same weights (rank 0 computes that
first, keeps it on the host and frees the card) at full width and
MP_PARITY_LAYERS layers in bf16 (MP_BF16_* limits; EP at
MP_EP_PARITY_BATCH with capacity_factor = E, so no token drops) and at
the narrow width in f32 (the CPU tests' tolerances); the step at full
width and depth through ``make_transformer_train_step`` (step ms,
tokens/s, launches, also at nonzero offsets for the ring, peak memory)
and one profiled step's NCCL device ms, the part overlapped with compute,
and for the ring its exchange (SendRecv) ms against its flash kernels'
ms. (dp 2, tp 2) has a second line, ``model parallel tp2_dp2_fused:``:
``make_transformer_train_step_fused`` (the buckets of each group of sync
axes launched from the gradient hooks, the update in their epilogues)
against the unfused step, 1 + 4 steps each from the same weights and
batches: at tier none the losses within FUSED_LOSS_REL_TOL and every
rank's parameter shards within FUSED_UPDATE_REL_TOL of the update, then
at fp8_e4m3 with error feedback (losses finite, the wire trace); step ms
(median, range), tokens/s and flash launches a step of each run. Then TP
serving on a (tp N) mesh (``model parallel tpN_serve:``):
phase 3's 16 requests against the one-card engine on the same weights
(tokens agreement, the first prefill's logits within MP_LOGIT_REL_TOL,
decode tokens/s of both, paged-decode launches at H/N heads a card),
and at the narrow width in f32 every token equal. Last, the control
plane on N cards (``--data-parallel N --control-plane-only``: only this;
``control plane data parallel:`` line), where the coordinator dispatches
deterministically with the divergence check: phase 10's ResNet-50 steps,
every rank's parameters bitwise every other's and within PARAM_REL_TOL
of the ``DistributedOptimizer`` steps (another packing sums in another
order); the three syncs timed; the integer burst exact with its
timeline; the check's ms per flush at HOROVOD_DIVERGENCE_CHECK_EVERY=1
and once its interval has widened; and the drill: rank 1 enqueues a
tensor no other rank does, and every rank raises DivergenceError naming
it within HOROVOD_DIVERGENCE_TIMEOUT=CP_DIV_TIMEOUT seconds. Last, the
zoo on N cards (``--data-parallel N --zoo-only``: only these; ``zoo data
parallel <model>:`` lines): VGG-16 and Inception V3 at phase 11's batch
per card, on one card and then on N, ZOO_DP_STEPS steps each: every
rank's parameters bitwise equal after the steps, step ms, scaling
efficiency (one card's step over N's) and the NCCL kernels' device ms
of a profiled step. Last, the serving fleet on N cards
(``--data-parallel N --fleet-only``: only this; ``fleet data parallel:``
line): one process, a replica a card on its own thread, not an NCCL
world. Paged decode is held against its plain version on every card;
phase 3's 16 requests through a fleet of one and of N, every token the
bare one-card engine's, each replica's weights and pool on its own card
(``torch.cuda.memory_allocated``), decode tokens/s at 1 and N replicas
and their ratio; the autoscaler grows 1 -> N under staggered arrivals;
then one replica is killed and another drained, every request served
with the bare tokens. Last, observability on N cards (``--data-parallel N
--observability-only``: only this; ``observability data parallel:``
line): the fused flagship through ``train_loop`` with the span recorder
on and HOROVOD_TRACE_PROFILE=steps:OBS_DP_WINDOW@2: the observed overlap
ratio, exposed collective ms a step, every bucket's device ms (each
``hvd_bucket<i>`` label present), the NCCL kernels' device ms of each
profiled step, and the step ms inside the window and out; the numerics
drill through the coordinator on every rank (rank 0's NaN named on each);
then ``shutdown``: rank 0's merged trace with a track per rank and their
clock offsets, and a ledger record on every rank. Last, the artifact
store on N cards (``--data-parallel N --store-only``: only this;
``artifact store data parallel:`` line): N ranks of the data-parallel
flagship start together on a cold store, each on an empty build
directory of its own, and every entry ends valid with no rank having
read a torn one; then N ranks on the warm store run no nvcc build, and
their losses are bitwise the cold world's. Last, the data path on N
cards (``--data-parallel N --data-only``: only this; ``data loader
resnet50 data parallel:``, ``data service train data parallel rank
<r>:`` and ``estimator data parallel:`` lines): phase 16's (a) and (b)
in an N-card world (each rank's slices concatenating bitwise to the
global batch, the drill's losses bitwise on every rank, ``distribute``
feeding the N ranks every sample once), then (c) with N executor workers
over NCCL. Last, the online tuner on N cards (``--data-parallel N
--autotune-only``: only this; ``autotune data parallel:`` line): phase
17's tuned ResNet-50 steps in a deterministic world, rank 0 tuning and
the others applying its knobs at the same cycles over the c10d store:
every rank's knob history equal, the ms of a publish and of an apply a
cycle, each step's synced gradients and new parameters against a
``DistributedOptimizer`` model given the same state within
cp_resnet_steps' tolerances (another bin size may sum in another order),
every rank's parameters bitwise equal; then ``sweep_bucket_bytes`` over
the five candidates, AT_SWEEP_STEPS profiled steps each (the exposed
NCCL ms with its spread, the collectives), and every rank resolving rank
0's winner through a fresh ``DistributedOptimizer``.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
LOGIT_TOL = 1e-4
# Flash kernels against their plain versions (which widen the inputs to
# f32), held relative to the largest reference value: the unnormalized
# output and the gradients reach the hundreds at S=2048. f32 runs the FMA
# kernels, which sum in f32 in another order; bf16 runs the tensor-core
# kernels, where P and dS enter their products rounded to bf16 (2^-9).
FLASH_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# Card against CPU in training, f32: sums over 512 tokens and 1024-wide
# products in another order, relative to the leaf's largest value.
GRAD_REL_TOL = 1e-4
PARAM_REL_TOL = 1e-5
TRAIN_B, TRAIN_S = 8, 2048
# conv+BN kernels against their plain versions, relative to the largest
# reference value: bf16 outputs are rounded once to bf16 (2^-8) after f32
# sums in another order; f32 outputs differ in the order of f32 sums.
CONV_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# ResNet-50 training: images per card (in bench.py's sweep), and the
# forward GFLOP per 224^2 image of bench.py's MFU convention (x3 for
# forward and backward).
RESNET_B = 128
RESNET_FWD_FLOPS = 4.1e9
RESNET50_CONVS = 36          # 16 blocks x (conv1, conv3) + 4 projections
RESNET50_BLOCKS = (3, 4, 6, 3)
# Small f32 fused ResNet, card against CPU, relative to each leaf's largest
# value: cuDNN and the CPU sum convolutions in other orders, and batch norm
# over 32 positions in the second stage amplifies that in the gradients.
RESNET_REL_TOL = {"logits": 1e-4, "running_stats": 1e-4, "gradients": 1e-3,
                  "params_after_2_steps": 1e-4}
# The fused flagship at tier none against the unfused step. Losses,
# relative: the first loss is the same forward; later ones follow
# parameters that differ in their last f32 bits (EpilogueSGD's p - lr * m
# against torch.optim.SGD's p + (-lr) * m), which the bf16 forward can
# round to other bf16 values. Sound runs differed by 7.8e-6 at most; the
# unfused losses themselves drift by 1.6e-3 over the 1 + 4 steps, which is
# what a fused step that never updated would show.
FUSED_LOSS_REL_TOL = 1e-4
# Parameters after the 1 + 4 steps, per leaf: max |fused - unfused| over
# max |unfused - initial|. A sound run on an H100 read 1.07e-2 (the same
# last-bit differences, through five bf16 forwards and backwards); a leaf
# whose bucket was never applied reads 1.
FUSED_UPDATE_REL_TOL = 5e-2
# The tiny f32 fused step at fp8_e4m3 with error feedback, card against
# CPU: the two devices' f32 gradients differ in their last bits, so a value
# on an fp8 rounding boundary can round the other way. At most this share
# of a leaf's parameters may differ by more than 1e-5 of its largest value,
# all within 1e-3 (one wire step times the learning rate); losses 1e-5.
FP8_FLIP_SHARE = 5e-3
TINY_CFG = dict(vocab_size=256, d_model=64, n_heads=2, head_dim=32,
                n_layers=2, d_ff=128, max_seq=32)


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn(i)`` over ``iters``
    calls, after a warm-up, by CUDA events."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def paged_case(gen, *, b, h, kvh, d, page, n_max, lengths, dtype, copies):
    """``copies`` independent pools (so timed launches rotate through more
    than the 50 MB L2, as the layers of a decode step do), one block-table
    set, ragged lengths."""
    dev = torch.device("cuda")
    n_pages = b * n_max
    shape = (n_pages + 1, page, kvh, d)
    pools = [(torch.randn(shape, generator=gen, device=dev).to(dtype),
              torch.randn(shape, generator=gen, device=dev).to(dtype))
             for _ in range(copies)]
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    bt = perm.reshape(b, n_max).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pools, bt, ln


def kernel_bound_ms(q, k_pages, lengths, n_ctx, kv_lengths=None) -> float:
    """Least time for the work: K/V rows read once (only positions below
    each length), q read, the f32 output written — or its f32 operations
    at the card's f32 rate, whichever is larger. ``kv_lengths`` (default
    ``lengths``) is one length per distinct block table: where rows share
    a table, as the verify step's K+1 rows of a slot do, the function
    needs that table's K/V rows once, up to the longest of its rows."""
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    rows = int(lengths.clamp(0, n_ctx).sum())
    kv = lengths if kv_lengths is None else kv_lengths
    kv_rows = int(kv.clamp(0, n_ctx).sum())
    nbytes = (2 * kv_rows * kvh * d * k_pages.element_size()
              + q.numel() * q.element_size() + b * h * d * 4
              + 4 * b * (n_ctx // k_pages.shape[1]) + 4 * b)
    flops = 4 * rows * h * d
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


def check_kernel(fa, kvc, gen, *, kvh, dtype, timed, h=16):
    b, d, page, n_max = 8, 64, 128, 16
    lengths = [1, 2048, 300, 0, 1024, 1537, 128, 777]     # slot 3 is empty
    copies = 4 if timed else 1
    q, pools, bt, ln = paged_case(gen, b=b, h=h, kvh=kvh, d=d, page=page,
                                  n_max=n_max, lengths=lengths, dtype=dtype,
                                  copies=copies)
    kp, vp = pools[0]
    scale = d ** -0.5
    out = fa.flash_paged_decode(q, kp, vp, bt, ln, scale)
    torch.cuda.synchronize()
    ref = kvc.paged_attention_reference(q, kp, vp, bt, ln, scale)
    err = float((out - ref).abs().max())
    tag = f"paged_decode {str(dtype)[6:]} H={h} KVH={kvh}"
    log(f"{tag}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e})")
    if not torch.isfinite(out).all() or err > TOL[dtype]:
        raise AssertionError(f"{tag}: kernel disagrees with its plain "
                             f"version: max_abs_err {err}")
    if not bool((out[3] == 0).all()):
        raise AssertionError(f"{tag}: empty slot is not exact zeros")
    res = {"max_abs_err": err}
    if not timed:
        return res
    # Device ms per call from the profiler (the split and the merge kernel
    # summed), beside the CUDA-event ms over 200 back-to-back calls, which
    # at ~10-60 us a call also carries the host's launch cost.
    calls = iter(range(1 << 30))
    res["ms"] = call_device_ms(lambda: fa.flash_paged_decode(
        q, *pools[next(calls) % copies], bt, ln, scale), 20)
    res["event_ms"] = cuda_ms(lambda i: fa.flash_paged_decode(
        q, *pools[i % copies], bt, ln, scale), 200)
    res["plain_ms"] = cuda_ms(lambda i: kvc.paged_attention_reference(
        q, *pools[i % copies], bt, ln, scale), 20)
    res["bound_ms"] = kernel_bound_ms(q, kp, ln, n_max * page)
    # yardstick only: one library call over the same pages, gathered
    # beforehand (the port never calls it)
    n_ctx = n_max * page
    gathered = []
    for kpi, vpi in pools:
        kg = kpi[bt.long()].reshape(b, n_ctx, kvh, d).transpose(1, 2)
        vg = vpi[bt.long()].reshape(b, n_ctx, kvh, d).transpose(1, 2)
        gathered.append((kg.repeat_interleave(h // kvh, dim=1).contiguous(),
                         vg.repeat_interleave(h // kvh, dim=1).contiguous()))
    mask = (torch.arange(n_ctx, device=q.device)[None, :]
            < ln.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_ms"] = call_device_ms(lambda: sdpa(
        q4, *gathered[next(calls) % copies], attn_mask=mask, scale=scale),
        20)
    res["library_event_ms"] = cuda_ms(lambda i: sdpa(
        q4, *gathered[i % copies], attn_mask=mask, scale=scale), 200)
    res["bound_by"] = "bytes"
    log(f"{tag}: kernel {res['ms']:.4f} ms device ({res['event_ms']:.4f} "
        f"by events), bound {res['bound_ms']:.4f} ms ("
        f"{res['bound_ms'] / res['ms']:.1%} of it), plain "
        f"{res['plain_ms']:.4f} ms, sdpa {res['library_ms']:.4f} ms device "
        f"({res['library_event_ms']:.4f} by events), "
        f"{res['ms'] / res['library_ms']:.2f}x sdpa")
    return res


# ---------------------------------------------------------------------------
# phase 2: the flash kernels against their plain versions
# ---------------------------------------------------------------------------

def visible_pairs(s_q, s_k, q_offset, k_offset, causal) -> int:
    """(query, key) pairs the causal mask leaves visible for one (b, h)."""
    if not causal:
        return s_q * s_k
    # row i sees keys j <= q_offset + i - k_offset
    rows = torch.arange(s_q, dtype=torch.int64) + q_offset - k_offset + 1
    return int(rows.clamp(0, s_k).sum())


def flash_bounds(q, s_k, q_offset, k_offset, causal):
    """Least time of each kernel at this geometry: inputs read once,
    outputs written once, over the card's memory rate; its matrix
    products over the visible pairs at the inputs' tensor-core rate (bf16)
    or the f32 rate. Returns {kernel: (ms, bound_by, operations)}."""
    b, s_q, h, d = q.shape
    pairs = b * h * visible_pairs(s_q, s_k, q_offset, k_offset, causal)
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    es = q.element_size()
    q_bytes, kv_bytes = b * s_q * h * d * es, b * s_k * h * d * es
    stats = b * h * s_q * 4
    cases = {
        # s = q k^T and o = p v: 2 products
        "flash_fwd": (q_bytes + 2 * kv_bytes + b * s_q * h * d * 4
                      + 2 * stats, 2 * 2 * d * pairs),
        # s, dp = do v^T, dq = ds k: 3 products; q, do, k, v, lse, dD in
        "flash_bwd_dq": (2 * q_bytes + 2 * kv_bytes + 2 * stats
                         + b * s_q * h * d * 4, 3 * 2 * d * pairs),
        # s, dp, dv = p^T do, dk = ds^T q: 4 products
        "flash_bwd_dkv": (2 * q_bytes + 2 * kv_bytes + 2 * stats
                          + 2 * b * s_k * h * d * 4, 4 * 2 * d * pairs),
    }
    out = {}
    for name, (nbytes, flops) in cases.items():
        t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
        out[name] = (max(t_mem, t_ops) * 1e3,
                     "bytes" if t_mem >= t_ops else "operations", flops)
    return out


def device_rows(prof):
    """(device us, kernel name, calls) of every kernel in a profile, most
    time first. Kernel rows only: an operator's row repeats its kernels'
    device time."""
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def profiled_rows(fn, iters: int, names=(), tries: int = 3):
    """``device_rows`` of ``iters`` calls of ``fn`` under torch.profiler,
    after one warm-up call. The profiler now and then hands back no device
    events at all; such a run (or one that misses a kernel of ``names``)
    is profiled again, up to ``tries`` times in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows and all(any(n in key for _, key, _ in rows) for n in names):
            return rows
    raise AssertionError(f"profiler saw no device time for "
                         f"{list(names) or 'any kernel'}")


def kernel_device_ms(fn, names, iters: int = 5):
    """Device ms per launch of each kernel in ``names`` (a substring of
    its symbol, and of no other kernel's that ``fn`` launches) over
    ``iters`` calls of ``fn``, from torch.profiler."""
    return {name: us / 1e3 / count
            for us, key, count in profiled_rows(fn, iters, names)
            for name in names if name in key}


def call_device_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: every kernel it launches, summed over
    ``iters`` calls by torch.profiler, over ``iters``."""
    return sum(r[0] for r in profiled_rows(fn, iters)) / 1e3 / iters


def check_flash(fa, sq, gen, *, b, s_q, s_k, h, d, dtype, q_offset=0,
                k_offset=0, causal=True, timed=False):
    """The three flash kernels against ``_block_attend`` and
    ``_bwd_block_plain`` on the same inputs (widened to f32, as the
    autograd.Function does on the CPU). Returns the largest error of
    each kernel and, when ``timed``, its times and bound."""
    dev = torch.device("cuda")
    q, k, v, do = (torch.randn((b, n, h, d), generator=gen, device=dev
                               ).to(dtype) for n in (s_q, s_k, s_k, s_q))
    scale = d ** -0.5
    tag = (f"flash {str(dtype)[6:]} B={b} Sq={s_q} Sk={s_k} H={h} D={d} "
           f"offsets=({q_offset},{k_offset}) causal={causal}")
    o, m, l = fa.flash_block_attend(q, k, v, q_offset, k_offset, causal,
                                    scale)
    torch.cuda.synchronize()
    ro, rm, rl = sq._block_attend(q.float(), k.float(), v.float(), q_offset,
                                  k_offset, causal, scale)
    l_safe = rl.clamp_min(1e-30)
    lse = rm + torch.log(l_safe)
    o_norm = ro / l_safe.transpose(1, 2)[..., None]
    dD = (do.float() * o_norm).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_bwd_block(q, k, v, do, lse, dD, q_offset, k_offset,
                             causal, scale)
    torch.cuda.synchronize()
    want = sq._bwd_block_plain(q, k, v, do, lse, dD, q_offset, k_offset,
                               causal, scale)
    errs = {}
    for kname, pairs in (("flash_fwd", ((o, ro), (m, rm), (l, rl))),
                         ("flash_bwd_dq", ((got[0], want[0]),)),
                         ("flash_bwd_dkv", ((got[1], want[1]),
                                           (got[2], want[2])))):
        err = 0.0
        for a, ref in pairs:
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{tag}: {kname} gave non-finite "
                                     f"values")
            e = float((a - ref).abs().max())
            lim = FLASH_REL_TOL[dtype] * max(1.0, float(ref.abs().max()))
            if e > lim:
                raise AssertionError(f"{tag}: {kname} disagrees with its "
                                     f"plain version: {e} > {lim}")
            err = max(err, e)
        errs[kname] = err
    masked = rm <= sq.NEG_INF / 2                      # rows that see no key
    if bool(masked.any()):
        rows = masked.transpose(1, 2)                  # [B, Sq, H]
        if not (bool((m[masked] == sq.NEG_INF).all())
                and bool((l[masked] == 0).all())
                and bool((o[rows] == 0).all())
                and bool((got[0][rows] == 0).all())):
            raise AssertionError(f"{tag}: a fully masked row is not "
                                 f"exactly m=-1e30, l=0, o=0, dq=0")
    log(f"{tag}: max_abs_err " + json.dumps(
        {k_: float(f"{e_:.3e}") for k_, e_ in errs.items()})
        + f", {int(masked.sum())} fully masked rows")
    res = {"max_abs_err": errs}
    if not timed:
        return res
    args = (q_offset, k_offset, causal, scale)
    res["ms"] = kernel_device_ms(
        lambda: (fa.flash_block_attend(q, k, v, *args),
                 fa.flash_bwd_block(q, k, v, do, lse, dD, *args)),
        ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
    res["plain_fwd_ms"] = cuda_ms(lambda i: sq._block_attend(
        q.float(), k.float(), v.float(), *args), 3)
    res["plain_bwd_ms"] = cuda_ms(lambda i: sq._bwd_block_plain(
        q, k, v, do, lse, dD, *args), 3)
    res["bounds"] = flash_bounds(q, s_k, q_offset, k_offset, causal)
    # yardstick only (the port never calls it): one library call for the
    # same function on pre-transposed [B, H, S, D] tensors
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    res["library_fwd_ms"] = cuda_ms(lambda i: sdpa(
        qt, kt, vt, is_causal=causal, scale=scale), 20)

    def fwd_bwd(i):
        out = sdpa(qt, kt, vt, is_causal=causal, scale=scale)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    res["library_bwd_ms"] = cuda_ms(fwd_bwd, 20) - res["library_fwd_ms"]
    log(f"{tag}: kernels " + json.dumps(
        {k_: round(v_, 4) for k_, v_ in res["ms"].items()})
        + f" ms; plain fwd {res['plain_fwd_ms']:.3f} ms, bwd "
        f"{res['plain_bwd_ms']:.3f} ms; sdpa fwd "
        f"{res['library_fwd_ms']:.4f} ms, bwd {res['library_bwd_ms']:.4f}"
        f" ms; bounds " + json.dumps(res["bounds"]))
    ms, (bound_ms, _, flops) = res["ms"]["flash_fwd"], res["bounds"][
        "flash_fwd"]
    log(f"{tag}: forward " + json.dumps({"flash_fwd": {
        "ms": ms, "tflops": flops / ms / 1e9, "share_of_bound": bound_ms / ms,
        "x_sdpa_fwd": ms / res["library_fwd_ms"]}}))
    bwd = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        ms, (bound_ms, _, flops) = res["ms"][name], res["bounds"][name]
        bwd[name] = {"ms": ms, "tflops": flops / ms / 1e9,
                     "share_of_bound": bound_ms / ms,
                     "x_sdpa_bwd": ms / res["library_bwd_ms"]}
    pair = sum(b_["ms"] for b_ in bwd.values())
    bwd["pair"] = {
        "ms": pair,
        "share_of_bound": sum(res["bounds"][n][0] for n in bwd) / pair,
        "x_sdpa_bwd": pair / res["library_bwd_ms"]}
    log(f"{tag}: backward " + json.dumps(bwd))
    return res


def check_flash_all(fa, sq, gen):
    """Every case of the flash kernel phase; returns the timed main case
    and the largest error of each kernel over all cases."""
    train = dict(b=TRAIN_B, h=16, d=64)
    main_case = check_flash(fa, sq, gen, s_q=TRAIN_S, s_k=TRAIN_S,
                            dtype=torch.bfloat16, timed=True, **train)
    cases = [main_case["max_abs_err"]]
    cases.append(check_flash(fa, sq, gen, b=2, s_q=2048, s_k=2048, h=16,
                             d=64, dtype=torch.float32)["max_abs_err"])
    for causal in (False, True):
        cases.append(check_flash(fa, sq, gen, s_q=1024, s_k=1024,
                                 dtype=torch.bfloat16, q_offset=2048,
                                 k_offset=0, causal=causal,
                                 **train)["max_abs_err"])
    cases.append(check_flash(fa, sq, gen, b=2, s_q=1024, s_k=1024, h=16,
                             d=64, dtype=torch.bfloat16, q_offset=0,
                             k_offset=1024)["max_abs_err"])  # all masked
    cases.append(check_flash(fa, sq, gen, b=2, s_q=1000, s_k=1000, h=16,
                             d=64, dtype=torch.bfloat16)["max_abs_err"])
    worst = {k_: max(c[k_] for c in cases) for k_ in cases[0]}
    return main_case, worst


# ---------------------------------------------------------------------------
# phase 2: the conv+BN kernels against their plain versions
# ---------------------------------------------------------------------------

def resnet50_convs(batch: int = RESNET_B, image: int = 224):
    """The distinct 1x1 convs of ResNet-50 at ``batch`` images: (stage,
    what, M, K, N, prologue, stride). M counts the rows the kernel sees
    (after a strided projection subsamples them)."""
    out = []
    side = image // 4                       # after the stem and max-pool
    cin = 64
    for i, f in enumerate((64, 128, 256, 512)):
        stride = 2 if i else 1
        m_in, m_out = batch * side * side, batch * (side // stride) ** 2
        out.append((i + 1, "conv1 block 0", m_in, cin, f, False, 1))
        if i or cin != 4 * f:
            out.append((i + 1, "projection", m_out, cin, 4 * f, False,
                        stride))
        out.append((i + 1, "conv1", m_out, 4 * f, f, False, 1))
        out.append((i + 1, "conv3", m_out, f, 4 * f, True, 1))
        cin, side = 4 * f, side // stride
    return out


def resnet50_conv_count(stage: int, what: str) -> int:
    """Launches a training step makes of a distinct 1x1 conv of
    ``resnet50_convs``: a stage of B bottleneck blocks runs conv1 B - 1
    times past block 0 and conv3 B times."""
    blocks = RESNET50_BLOCKS[stage - 1]
    return {"conv1 block 0": 1, "projection": 1, "conv1": blocks - 1,
            "conv3": blocks}[what]


def conv_bounds(m, k, n, dtype):
    """Least time of each kernel: inputs read once, outputs written once,
    over the card's memory rate; its products (forward 2MKN, backward
    4MKN) at the tensor-core bf16 rate or the f32 rate. Returns {kernel:
    (ms, bound_by)}."""
    es = torch.tensor([], dtype=dtype).element_size()
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    vec = 4 * (2 * k + 2 * n)               # inv, shift, s1/ds1, s2/ds2
    cases = {"conv_bn_fwd": ((m * k + k * n + m * n) * es + vec,
                             2 * m * k * n),
             "conv_bn_bwd": ((2 * m * k + 2 * m * n + 2 * k * n) * es
                             + vec, 4 * m * k * n)}
    out = {}
    for name, (nbytes, flops) in cases.items():
        t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
        out[name] = (max(t_mem, t_ops) * 1e3,
                     "bytes" if t_mem >= t_ops else "operations")
    return out


def fwd_route(cb, m, k, n, dtype, prologue) -> str:
    """The forward's route for a shape (a tree without routes: "mma")."""
    plan = getattr(cb, "fwd_plan", None)
    return plan(m, k, n, dtype, prologue).route if plan else "mma"


def bwd_route(cb, m, k, n, dtype, prologue) -> str:
    """The backward's route for a shape (a tree without routes: "mma")."""
    plan = getattr(cb, "bwd_plan", None)
    return plan(m, k, n, dtype, prologue).route if plan else "mma"


def check_conv(cb, gen, m, k, n, prologue, dtype, tag, timed=False):
    """Both conv+BN kernels against their plain versions on the same
    inputs; each output's error against CONV_REL_TOL times its largest
    reference value (at least 1). bf16: y, dx and dw are stored in bf16
    (one rounding, 2^-8) after f32 sums in another order; f32: sums in
    another order only. The backward is linear in its three cotangents, so
    it is held to its plain version on each alone (ds1 and ds2 scaled so
    that their terms of dy_eff are as large as dy's) and then on the three
    together at training's scales. Returns {"max_abs_err": {output: (largest
    absolute error, largest share of its limit)}, "route": the backward's
    route, "fwd_route": the forward's}; when ``timed`` also both kernels'
    times by CUDA events, their plain versions', the cuBLAS GEMMs' and the
    bounds, and the forward's device ms a call by torch.profiler (its
    kernels alone: at the small shapes back-to-back calls by events read
    the host's time a call), after checking that two runs give the same
    bits (no float atomics)."""
    dev = torch.device("cuda")
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dtype)
    inv = shift = None
    if prologue:
        inv = torch.rand((k,), generator=gen, device=dev) + 0.5
        shift = torch.randn((k,), generator=gen, device=dev) * 0.1
    dy = torch.randn((m, n), generator=gen, device=dev).to(dtype)
    ds1 = torch.randn((n,), generator=gen, device=dev) * 1e-2
    ds2 = torch.randn((n,), generator=gen, device=dev) * 1e-3
    fwd = cb.conv_bn_fwd(x, w, inv, shift)
    torch.cuda.synchronize()
    y = fwd[0]
    zdy, zn = torch.zeros_like(dy), torch.zeros_like(ds1)
    cotangents = (("dy", (dy, zn, zn)),
                  ("ds1", (zdy, ds1 * 100.0, zn)),
                  ("ds2", (zdy, zn, ds2 * 500.0)),
                  ("all", (dy, ds1, ds2)))
    errs = {}

    def compare(what, got, want, names):
        for a, ref, nm in zip(got, want, names.split()):
            if ref is None:
                continue
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{tag}: {what} {nm} non-finite")
            e = float((a.float() - ref.float()).abs().max())
            lim = CONV_REL_TOL[dtype] * max(1.0,
                                            float(ref.float().abs().max()))
            if e > lim:
                raise AssertionError(f"{tag}: {what} {nm} disagrees with "
                                     f"its plain version: {e} > {lim}")
            old = errs.get(nm, (0.0, 0.0))
            errs[nm] = (max(old[0], e), max(old[1], e / lim))

    compare("conv_bn_fwd", fwd, cb.conv1x1_bn_stats_plain(x, w, inv, shift),
            "y s1 s2")
    for cot, args in cotangents:
        bwd = cb.conv_bn_bwd(x, w, inv, shift, y, *args)
        torch.cuda.synchronize()
        compare(f"conv_bn_bwd ({cot})", bwd,
                cb.conv1x1_bn_bwd_plain(x, w, inv, shift, y, *args),
                "dx dw dinv dshift")
    route = bwd_route(cb, m, k, n, dtype, prologue)
    froute = fwd_route(cb, m, k, n, dtype, prologue)
    res = {"max_abs_err": errs, "route": route, "fwd_route": froute}
    log(f"conv_bn {tag} M={m} {k}->{n} {str(dtype)[6:]}"
        f"{' prologue' if prologue else ''} (forward: {froute}, backward: "
        f"{route}): max_abs_err (share of limit) "
        + json.dumps({nm: f"{e:.3e} ({share:.3f})"
                      for nm, (e, share) in errs.items()}))
    if not timed:
        return res
    # determinism: a second run gives the same bits (no float atomics);
    # bwd is the last of the loop, all three cotangents
    fwd2 = cb.conv_bn_fwd(x, w, inv, shift)
    bwd2 = cb.conv_bn_bwd(x, w, inv, shift, y, dy, ds1, ds2)
    for a, b in zip(fwd + bwd, fwd2 + bwd2):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{tag}: two runs differ")
    names = ("conv_bn_fwd", "conv_bn_bwd")
    kernel = {"conv_bn_fwd": lambda i: cb.conv_bn_fwd(x, w, inv, shift),
              "conv_bn_bwd": lambda i: cb.conv_bn_bwd(
                  x, w, inv, shift, y, dy, ds1, ds2)}
    plain = {"conv_bn_fwd": lambda i: cb.conv1x1_bn_stats_plain(
                 x, w, inv, shift),
             "conv_bn_bwd": lambda i: cb.conv1x1_bn_bwd_plain(
                 x, w, inv, shift, y, dy, ds1, ds2)}
    # yardstick only (the port never calls it): cuBLAS on the same
    # operands, the GEMM alone — no PyTorch call computes GEMM + BN sums
    gemm = {"conv_bn_fwd": lambda i: x @ w,
            "conv_bn_bwd": lambda i: (dy @ w.t(), x.t() @ dy)}
    res["ms"] = {nm: cuda_ms(kernel[nm], 20) for nm in names}
    res["plain_ms"] = {nm: cuda_ms(plain[nm], 5) for nm in names}
    res["gemm_ms"] = {nm: cuda_ms(gemm[nm], 20) for nm in names}
    res["bounds"] = conv_bounds(m, k, n, dtype)
    res["fwd_device_ms"] = call_device_ms(lambda: kernel["conv_bn_fwd"](0),
                                          5)
    log(f"conv_bn {tag}: kernels " + json.dumps(
        {k_: round(v_, 4) for k_, v_ in res["ms"].items()})
        + f" ms (forward {res['fwd_device_ms']:.4f} ms of device time)"
        + "; plain " + json.dumps(
            {k_: round(v_, 4) for k_, v_ in res["plain_ms"].items()})
        + " ms; cuBLAS GEMM alone " + json.dumps(
            {k_: round(v_, 4) for k_, v_ in res["gemm_ms"].items()})
        + " ms; bounds " + json.dumps(res["bounds"]))
    return res


def conv_step(shapes, name):
    """Log the ``<name> over a ResNet-50 step`` line: each shape's time and
    bound times its launches a step (36 in all), launches per route, and
    per shape ms. Returns {"ms", "bound_ms", "launches"} (and the forward's
    "device_ms")."""
    rows = shapes[name]
    launches = sum(sh["launches_per_step"] for sh in rows)
    if launches != RESNET50_CONVS:
        raise AssertionError(f"{launches} conv launches a step, expected "
                             f"{RESNET50_CONVS}")
    step = {k_: sum(sh[k_] * sh["launches_per_step"] for sh in rows)
            for k_ in ("ms", "bound_ms", "device_ms") if k_ in rows[0]}
    step["launches"] = launches
    log(f"{name} over a ResNet-50 step: " + json.dumps({
        "launches": launches,
        **{k_: round(step[k_], 4) for k_ in ("ms", "device_ms", "bound_ms")
           if k_ in step},
        "share_of_bound": round(step["bound_ms"] / step["ms"], 4),
        "routes": {r: sum(sh["launches_per_step"] for sh in rows
                          if sh["route"] == r)
                   for r in sorted({sh["route"] for sh in rows})},
        "per_shape_ms": {sh["shape"]: round(sh["ms"], 4) for sh in rows}}))
    return step


def check_conv_all(cb, gen):
    """Every distinct 1x1 conv of ResNet-50 at 128 images (bf16), each
    held to its plain version and bitwise repeatable, both kernels timed at
    all 16; a ``conv_bn_fwd over a ResNet-50 step`` and a ``conv_bn_bwd
    over a ResNet-50 step`` line (``conv_step``). Then an f32 ragged case
    (3x7x7 rows, 130 -> 70, prologue), 32 -> 576 in f32 and bf16, bf16 461
    rows of 72 -> 40 with the prologue (the fused route off the 64-wide
    boxes) and bf16 6,273 rows of 72 -> 576 with the prologue (the wgmma
    forward off its row tiles, its K chunks and its column tiles). Returns
    the timed cases (the stage-1 expand conv under "main"; every shape's
    times under "fwd_shapes" and "bwd_shapes"), the step sums ("fwd_step",
    "bwd_step"), and for each output its largest absolute error and
    largest share of its limit over all cases."""
    timed, errs = {}, []
    shapes = {"conv_bn_fwd": [], "conv_bn_bwd": []}
    for stage, what, m, k, n, prologue, stride in resnet50_convs():
        tag = (f"stage {stage} {what}"
               + (f" (stride {stride})" if stride > 1 else ""))
        res = check_conv(cb, gen, m, k, n, prologue, torch.bfloat16, tag,
                         timed=True)
        errs.append(res["max_abs_err"])
        if (stage, what) == (1, "conv3"):
            timed["main"] = res
        for name, route in (("conv_bn_fwd", res["fwd_route"]),
                            ("conv_bn_bwd", res["route"])):
            bound_ms, bound_by = res["bounds"][name]
            shapes[name].append({
                "shape": tag, "m": m, "k": k, "n": n, "prologue": prologue,
                "route": route,
                "launches_per_step": resnet50_conv_count(stage, what),
                "ms": res["ms"][name], "bound_ms": bound_ms,
                "bound_by": bound_by,
                "cublas_gemms_ms": res["gemm_ms"][name],
                **({"device_ms": res["fwd_device_ms"]}
                   if name == "conv_bn_fwd" else {})})
    for name, key in (("conv_bn_fwd", "fwd"), ("conv_bn_bwd", "bwd")):
        timed[f"{key}_shapes"] = shapes[name]
        timed[f"{key}_step"] = conv_step(shapes, name)
    errs.append(check_conv(cb, gen, 147, 130, 70, True, torch.float32,
                           "ragged")["max_abs_err"])
    errs.append(check_conv(cb, gen, 64, 32, 576, False, torch.float32,
                           "wide")["max_abs_err"])
    errs.append(check_conv(cb, gen, 64, 32, 576, True, torch.bfloat16,
                           "wide")["max_abs_err"])
    errs.append(check_conv(cb, gen, 461, 72, 40, True, torch.bfloat16,
                           "ragged M, narrow")["max_abs_err"])
    errs.append(check_conv(cb, gen, 6273, 72, 576, True, torch.bfloat16,
                           "ragged M, K and N")["max_abs_err"])
    worst = {nm: (max(c[nm][0] for c in errs if nm in c),
                  max(c[nm][1] for c in errs if nm in c))
             for nm in dict.fromkeys(nm for c in errs for nm in c)}
    log("conv_bn over all cases, max_abs_err (share of limit): "
        + json.dumps({nm: f"{e:.3e} ({share:.3f})"
                      for nm, (e, share) in worst.items()}))
    return timed, worst


# ---------------------------------------------------------------------------
# phase 2: the stream-copy kernel and the bandwidth probe
# ---------------------------------------------------------------------------

PROBE_ROWS, PROBE_COLS = 131072, 1024    # bench.py's bf16 probe array


def check_stream_copy(sc, gen):
    """The stream-copy kernel against its plain version (out.copy_(x)) bit
    for bit: at the probe's shape at every tile of the probe's sweep, at
    ragged shapes and tiles, at chunks of 80,000 and 5,000 bytes, and on
    views 1..15 bytes off a 16-byte boundary; then its time at the probe's
    shape beside its bound, the plain version's and ``copy_``'s (CUDA
    events; kernel and ``copy_`` twice, interleaved)."""
    dev = torch.device("cuda")
    cases = [((PROBE_ROWS, PROBE_COLS), torch.bfloat16, t)
             for t in (None, 1, 4, 16, 64)]
    cases += [((1000, 37), torch.uint8, 3), ((777, 129), torch.float32, 64),
              ((3, 5, 7), torch.bfloat16, 1), ((300, 40000), torch.uint8, 2),
              ((4097, 1000), torch.uint8, 5)]
    err = 0.0
    for shape, dtype, tile in cases:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        if dtype != torch.uint8:
            x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        got = sc.stream_copy(x, rows_per_cta=tile)
        want = sc.stream_copy_plain(x, torch.empty_like(x))
        torch.cuda.synchronize()
        err = max(err, float((got.float() - want.float()).abs().max()))
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"stream_copy {shape} {dtype} rows/CTA "
                                 f"{tile}: differs from its plain version")
    base = torch.randint(0, 256, (1 << 18,), dtype=torch.uint8, device=dev,
                         generator=gen)
    for so, do in ((1, 1), (3, 7), (0, 8), (16, 5)):
        dst = torch.zeros(1 << 18, dtype=torch.uint8, device=dev)
        xs = base[so:so + 100000].view(1000, 100)
        sc.stream_copy(xs, dst[do:do + 100000].view(1000, 100),
                       rows_per_cta=7)
        torch.cuda.synchronize()
        if not (torch.equal(dst[do:do + 100000], base[so:so + 100000])
                and not dst[:do].any() and not dst[do + 100000:].any()):
            raise AssertionError(f"stream_copy misaligned ({so}, {do}) "
                                 f"differs from its plain version")
    log(f"stream_copy: bit-equal to its plain version over "
        f"{len(cases) + 4} cases (probe shape at every tile, ragged, "
        f"misaligned)")
    x = torch.randn((PROBE_ROWS, PROBE_COLS), device=dev, generator=gen
                    ).to(torch.bfloat16)
    y = torch.empty_like(x)
    nbytes = 2 * x.numel() * x.element_size()
    kernel_ms, lib_ms = [], []
    for _ in range(2):
        kernel_ms.append(cuda_ms(lambda i: sc.stream_copy(x, y), 20))
        lib_ms.append(cuda_ms(lambda i: y.copy_(x), 20))
    res = {"max_abs_err": err, "ms": min(kernel_ms),
           "plain_ms": cuda_ms(lambda i: sc.stream_copy_plain(x, y), 20),
           "library_ms": min(lib_ms),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(f"stream_copy bf16 [{PROBE_ROWS}, {PROBE_COLS}]: kernel "
        f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, copy_ {res['library_ms']:.4f} ms "
        f"(kernel, copy_ twice: {[round(t, 4) for t in kernel_ms]}, "
        f"{[round(t, 4) for t in lib_ms]})")
    return res


def bandwidth(sc, card):
    """The probe's main path: launch count zeroed just before
    ``bandwidth_probe`` and read just after; one ``bandwidth:`` line."""
    sc.reset_launches()
    rows = sc.bandwidth_probe("cuda", rows=PROBE_ROWS, cols=PROBE_COLS)
    launches = sc.LAUNCHES["stream_copy"]
    if launches == 0:
        raise AssertionError("the bandwidth probe launched no stream copy")
    log("bandwidth: " + json.dumps({
        "array": f"bf16 [{PROBE_ROWS}, {PROBE_COLS}]",
        "bytes_per_pass": 2 * PROBE_ROWS * PROBE_COLS * 2,
        "data_sheet_gb_s": HBM_BYTES_PER_S / 1e9, "rows": rows,
        "stream_copy_launches": launches, "card": card}))
    return launches


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------

def flagship_cfg(TransformerConfig, **kw):
    """bench.py's flagship transformer: 268M parameters."""
    base = dict(vocab_size=32768, d_model=1024, n_heads=16, head_dim=64,
                n_layers=16, d_ff=4096, max_seq=2048, dtype=torch.bfloat16,
                dp_axis=None, remat=False)
    base.update(kw)
    return TransformerConfig(**base)


def pct(xs, p) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), p))


def serve_flagship(htt, fa, kvc, card):
    from horovod_tpu_torch.serving import Request, ServeEngine, ServeScheduler
    cfg = flagship_cfg(htt.TransformerConfig)
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    eng = ServeEngine(cfg, params, device="cuda")
    rng = np.random.default_rng(0)
    warm = [Request(rid=100 + i, prompt=rng.integers(
        0, cfg.vocab_size, 40).astype(np.int32), max_new_tokens=4)
        for i in range(2)]
    ServeScheduler(eng, device="cuda").run(warm)
    torch.cuda.synchronize()

    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(64, 1025))).astype(np.int32),
        max_new_tokens=32) for i in range(16)]
    sched = ServeScheduler(eng, mode="continuous", device="cuda")
    fa.reset_launches()
    t0 = time.perf_counter()
    done = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    st = sched.stats()
    steps = st["decode_steps"]
    if len(done) != 16 or any(r.error or len(r.tokens) != 32 for r in done):
        raise AssertionError("not every request completed with 32 tokens")
    if any(not (0 <= t < cfg.vocab_size) for r in done for t in r.tokens):
        raise AssertionError("token out of the vocabulary")
    if not torch.isfinite(eng.last_logits).all():
        raise AssertionError("non-finite logits")
    if launches["paged_decode"] < cfg.n_layers * steps or steps == 0:
        raise AssertionError(
            f"paged_decode launched {launches['paged_decode']} times over "
            f"{steps} decode steps of {cfg.n_layers} layers")
    PHASE3_SERVED[:] = [(r.prompt.tolist(), list(r.tokens)) for r in
                        sorted(done, key=lambda r: r.rid)[:STORE_SERVE_N]]
    gen_tokens = st["generated_tokens"]
    ttft = [r.ttft * 1e3 for r in done]
    tpot = [t * 1e3 for r in done for t in r.tpot]
    serve = {
        "model": "flagship TransformerLM", "params": n_params,
        "requests": len(done), "prompt_tokens": int(sum(
            r.prompt.size for r in done)), "generated_tokens": gen_tokens,
        "decode_steps": steps, "mean_occupancy": st["mean_occupancy"],
        "wall_s": wall, "tokens_per_s": gen_tokens / wall,
        "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
        "tpot_ms_p50": pct(tpot, 50), "tpot_ms_p99": pct(tpot, 99),
        "paged_decode_launches": launches["paged_decode"],
        "card": card}
    log("serve: " + json.dumps(serve))

    # the kernel on the engine's live pool: 7 slots prefilled to ragged
    # lengths, slot 7 left empty (scratch block table, length 0)
    prompts = [1, 130, 257, 513, 700, 1024, 2000]
    for n in prompts:
        slot = eng.reserve(n + 1)
        eng.prefill(slot, rng.integers(0, cfg.vocab_size, n).astype(
            np.int32))
    eng.decode_step(np.zeros((eng.slots,), np.int32))
    bt, ln = eng.tables.device_views(eng.device)
    q = torch.randn((eng.slots, cfg.n_heads, cfg.head_dim), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)
                    ).to(cfg.dtype)
    err = 0.0
    for layer in (0, cfg.n_layers - 1):
        kp, vp = eng.k_pages[layer], eng.v_pages[layer]
        out = fa.flash_paged_decode(q, kp, vp, bt, ln, cfg.head_dim ** -0.5)
        ref = kvc.paged_attention_reference(q, kp, vp, bt, ln,
                                            cfg.head_dim ** -0.5)
        e = float((out - ref).abs().max())
        if e > TOL[cfg.dtype] or not bool((out[7] == 0).all()):
            raise AssertionError(f"live pool layer {layer}: kernel "
                                 f"disagrees (max_abs_err {e})")
        err = max(err, e)
    log(f"live pool (lengths {ln.tolist()}): max_abs_err {err:.3e}")
    profile_decode(eng, card)
    for slot in range(eng.slots):
        eng.release(slot)
    return launches, err


def profile_decode(eng, card, n_steps: int = 8) -> None:
    """Where a decode step's time goes: host wall time per step, device
    busy share (summed kernel time over the window) and the kernels that
    take most device time, from torch.profiler over ``n_steps`` steps of
    the engine as it stands (7 active slots)."""
    from torch.profiler import ProfilerActivity, profile
    tokens = np.zeros((eng.slots,), np.int32)
    eng.decode_step(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.decode_step(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    dev_ms = sum(r[0] for r in rows) / 1e3
    out = {"steps": n_steps, "wall_ms_per_step": wall_ms / n_steps,
           "device_ms_per_step": (dev_ms / n_steps) if rows else None,
           "device_busy_share": (dev_ms / wall_ms) if rows else None,
           "top_device_ops": [
               {"op": k[:60], "ms_per_step": us / 1e3 / n_steps,
                "calls_per_step": c / n_steps} for us, k, c in rows[:8]],
           "card": card}
    log("decode profile: " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 4: training at full width and depth
# ---------------------------------------------------------------------------

def model_flops_per_token(cfg, seq: int) -> float:
    """bench.py's MFU convention: 6 x parameters per token for the dense
    path plus 6 x L x S x d_attn for causal attention (recompute not
    counted)."""
    d_attn = cfg.n_heads * cfg.head_dim
    n_params = (cfg.vocab_size * cfg.d_model
                + cfg.n_layers * (4 * cfg.d_model * d_attn
                                  + 2 * cfg.d_model * cfg.d_ff
                                  + 2 * cfg.d_model)
                + cfg.d_model + cfg.d_model * cfg.vocab_size)
    return 6 * n_params + 6 * cfg.n_layers * seq * d_attn


def train_flagship(htt, fa, card, n_steps: int = 4):
    """The training main path: ``runtime.init()`` forms an NCCL world of
    one, then ``make_transformer_train_step`` + ``train_loop`` over
    ``n_steps`` batches after one warm-up step."""
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    ctx = htt.init()
    if ctx.backend != "nccl" or htt.size() != 1:
        raise AssertionError(f"expected an NCCL world of one, got "
                             f"{ctx.backend} x {htt.size()}")
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    init_fn, step = htt.make_transformer_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        device="cuda")
    state = init_fn(params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [tuple(torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                                   generator=gen, device="cuda")
                     for _ in range(2)) for _ in range(n_steps + 1)]
    state, loss = step(state, *batches[0])                  # warm-up
    torch.cuda.synchronize()
    warm_loss = float(loss)

    losses, stamps = [], []

    def on_step(i, st, loss_t):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss_t))

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    state, info = htt.train_loop(step, state, batches[1:], on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if info["final_step"] != n_steps + 1 or info["status"] != "completed":
        raise AssertionError(f"train_loop info {info}")
    if not all(np.isfinite(x) for x in [warm_loss] + losses):
        raise AssertionError(f"non-finite loss: {[warm_loss] + losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] < cfg.n_layers * n_steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times over {n_steps} "
                f"steps of {cfg.n_layers} layers")
    step_s = np.diff([t0] + stamps)
    tokens = TRAIN_B * TRAIN_S
    mean_s = float(step_s.mean())
    flops_tok = model_flops_per_token(cfg, TRAIN_S)
    train = {
        "model": "flagship TransformerLM", "batch": TRAIN_B,
        "seq": TRAIN_S, "steps": n_steps, "warm_loss": warm_loss,
        "losses": losses, "step_ms": [float(x) * 1e3 for x in step_s],
        "step_ms_mean": mean_s * 1e3, "tokens_per_s": tokens / mean_s,
        "mfu": tokens / mean_s * flops_tok / BF16_FLOPS_PER_S,
        "peak_memory_gb": peak_gb,
        "launches": {k_: launches[k_] for k_ in
                     ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
        "card": card}
    log("train: " + json.dumps(train))
    from horovod_tpu_torch.utils import tree as tree_util
    final = [t.detach().clone() for t in tree_util.tree_leaves(state.params)]
    profile_train_step(step, state, batches[-1], card)
    htt.shutdown()
    return launches, [warm_loss] + losses, final


def flagship_fused_step(htt, cfg, dev, seed: int):
    """The flagship through ``make_transformer_train_step_fused`` with
    ``distributed_apply(EpilogueSGD(0.01, momentum=0.9),
    sync_axes=grad_sync_axes(cfg))``, from weights of ``seed``."""
    from horovod_tpu_torch.models import transformer as tfm
    params = htt.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                               sync_axes=tfm.grad_sync_axes(cfg))
    init_fn, step = htt.make_transformer_train_step_fused(cfg, da,
                                                          device=dev)
    return init_fn(params), step


def update_rel_diff(got, want, initial) -> float:
    """The largest over the leaves of max |got - want| / max |want -
    initial|: 0 where two trajectories agree, 1 for a leaf that one of
    them left at its initial value."""
    worst = 0.0
    for g, w, i in zip(got, want, initial):
        update = float((w - i).abs().max())
        worst = max(worst, float((g - w).abs().max()) / max(update, 1e-30))
    return worst


def train_flagship_fused(htt, fa, card, unfused_losses, unfused_params,
                         n_steps: int = 4):
    """The fused flagship step (hook-launched buckets, the update in each
    bucket's epilogue), 1 + ``n_steps`` steps through an NCCL world of one
    from the unfused run's seeds: at tier none its losses and final
    parameters against the unfused step's (FUSED_LOSS_REL_TOL,
    FUSED_UPDATE_REL_TOL), then at fp8_e4m3 with error feedback (losses
    finite; wire and logical bytes, bucket count)."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.parallel import distributed as D
    from horovod_tpu_torch.utils import tree as tree_util
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    out = {}
    for tier in ("none", "fp8_e4m3"):
        knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", tier)
        htt.init()
        try:
            state, step = flagship_fused_step(htt, cfg, "cuda", seed=0)
            gen = torch.Generator(device="cuda").manual_seed(1)
            batches = [tuple(torch.randint(
                0, cfg.vocab_size, (TRAIN_B, TRAIN_S), generator=gen,
                device="cuda") for _ in range(2)) for _ in range(n_steps + 1)]
            state, loss = step(state, *batches[0])              # warm-up
            losses, stamps = [float(loss)], []
            fa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in batches[1:]:
                state, loss = step(state, *batch)
                losses.append(float(loss))                  # synchronizes
                stamps.append(time.perf_counter())
            launches = dict(fa.LAUNCHES)
            trace = D.last_wire_trace()
            final = [t.detach() for t in tree_util.tree_leaves(state.params)]
        finally:
            htt.shutdown()
            knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
        if not all(np.isfinite(x) for x in losses):
            raise AssertionError(f"fused {tier}: non-finite loss {losses}")
        if min(launches.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")) \
                < cfg.n_layers * n_steps:
            raise AssertionError(f"fused {tier}: flash launches {launches}")
        step_ms = [float(x) * 1e3 for x in np.diff([t0] + stamps)]
        res = {"tier": tier, "losses": losses, "step_ms": step_ms,
               "step_ms_mean": float(np.mean(step_ms)),
               "buckets": trace["n_buckets"],
               "wire_bytes": trace["wire_bytes"],
               "logical_bytes": trace["logical_bytes"],
               "error_feedback": trace["error_feedback"],
               "flash_launches": launches}
        if tier == "none":
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, unfused_losses))
            initial = tree_util.tree_leaves(htt.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda"))
            upd = update_rel_diff(final, unfused_params, initial)
            del initial
            res["max_rel_loss_diff_vs_unfused"] = rel
            res["max_param_diff_over_update_vs_unfused"] = upd
            if rel > FUSED_LOSS_REL_TOL or upd > FUSED_UPDATE_REL_TOL:
                raise AssertionError(
                    f"fused step at tier none: losses {losses} differ from "
                    f"the unfused step's {unfused_losses} by {rel}, "
                    f"parameters by {upd} of the update")
        elif not trace["error_feedback"] or trace["tier"] != tier:
            raise AssertionError(f"fused fp8: wire trace {trace}")
        del final
        out[tier] = res
    log("train fused: " + json.dumps({
        "model": "flagship TransformerLM", "batch": TRAIN_B, "seq": TRAIN_S,
        "optimizer": "EpilogueSGD(0.01, momentum=0.9)", "tiers": out,
        "card": card}))


def profile_train_step(step, state, batch, card,
                       label="train profile") -> None:
    """Where a training step's time goes: host wall ms, device ms (kernel
    rows only), busy share, and the top device ops, from torch.profiler
    over one step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    dev_ms = sum(r[0] for r in rows) / 1e3
    out = {"wall_ms": wall_ms,
           "device_ms": dev_ms if rows else None,
           "device_busy_share": (dev_ms / wall_ms) if rows else None,
           "kernel_launches": sum(r[2] for r in rows),
           "top_device_ops": [{"op": k_[:70], "ms": us / 1e3, "calls": c}
                              for us, k_, c in rows[:8]],
           "card": card}
    log(f"{label}: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 4b: ResNet-50 training at full width and depth
# ---------------------------------------------------------------------------

def resnet_loss(model, images, labels):
    return torch.nn.functional.cross_entropy(model(images, train=True),
                                             labels)


def resnet_step(htt, dev, seed: int):
    """``ResNet50(fused_conv_bn=True)`` (bf16 compute, f32 parameters and
    BN statistics, random weights from ``seed``), SGD(0.01, momentum 0.9)
    through ``DistributedOptimizer``, and ``data_parallel_train_step``."""
    model = htt.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         fused_conv_bn=True, device=dev, seed=seed)
    opt = htt.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.01, momentum=0.9), op=htt.Average)
    init_fn, step, put_batch = htt.data_parallel_train_step(
        resnet_loss, opt, device=dev)
    return init_fn(model), step, put_batch


def resnet_batches(put_batch, n, batch, dev, seed=1, image=224):
    """``n`` global batches of ``batch`` synthetic ``image``^2 bf16 images
    and labels (bench.py's synthetic data), made on the card from
    ``seed``; ``put_batch`` keeps this rank's rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [put_batch((
        torch.rand((batch, image, image, 3), generator=gen, device=dev
                   ).to(torch.bfloat16),
        torch.randint(0, 1000, (batch,), generator=gen, device=dev)))
        for _ in range(n)]


def train_resnet50(htt, cb, card, n_steps: int = 4):
    """The ResNet main path: ``runtime.init()`` forms an NCCL world of
    one, then one warm-up step and ``train_loop`` over ``n_steps``
    batches of 128 images, launch counts zeroed just before and read just
    after; then a profile of one step."""
    ctx = htt.init()
    if ctx.backend != "nccl" or htt.size() != 1:
        raise AssertionError(f"expected an NCCL world of one, got "
                             f"{ctx.backend} x {htt.size()}")
    state, step, put_batch = resnet_step(htt, "cuda", seed=0)
    batches = resnet_batches(put_batch, n_steps + 1, RESNET_B, "cuda")
    state, loss = step(state, *batches[0])                  # warm-up
    torch.cuda.synchronize()
    warm_loss = float(loss)
    losses, stamps = [], []

    def on_step(i, st, loss_t):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss_t))

    torch.cuda.reset_peak_memory_stats()
    cb.reset_launches()
    t0 = time.perf_counter()
    state, info = htt.train_loop(step, state, batches[1:], on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)
    fwd_routes = dict(getattr(cb, "FWD_ROUTES", {}))
    routes = dict(getattr(cb, "BWD_ROUTES", {}))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if info["final_step"] != n_steps + 1 or info["status"] != "completed":
        raise AssertionError(f"train_loop info {info}")
    if not all(np.isfinite(x) for x in [warm_loss] + losses):
        raise AssertionError(f"non-finite loss: {[warm_loss] + losses}")
    opt = state.opt_state
    if len(opt.buckets) < 2 or not all(h for _, h in opt.launch_log):
        raise AssertionError(f"expected every one of several buckets "
                             f"launched from the gradient hooks: "
                             f"{opt.launch_log}")
    for name in ("conv_bn_fwd", "conv_bn_bwd"):
        if launches[name] < RESNET50_CONVS * n_steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times over {n_steps} "
                f"steps of {RESNET50_CONVS} 1x1 convs")
    # every launch of both kernels on a wgmma route (a tree without
    # routes, as a parent measured by tools/compare_trees.py, has none to
    # check)
    for name, rts in (("conv_bn_fwd", fwd_routes), ("conv_bn_bwd", routes)):
        if rts and (rts.get("mma", 0)
                    or sum(rts.values()) != launches[name]):
            raise AssertionError(f"{name} routes {rts}: expected all "
                                 f"{launches[name]} launches on the wgmma "
                                 f"routes")
    step_s = np.diff([t0] + stamps)
    mean_s = float(step_s.mean())
    ips = RESNET_B / mean_s
    train = {
        "model": "ResNet-50 fused_conv_bn", "batch": RESNET_B,
        "image": 224, "steps": n_steps, "warm_loss": warm_loss,
        "losses": losses, "step_ms": [float(x) * 1e3 for x in step_s],
        "step_ms_mean": mean_s * 1e3, "images_per_s": ips,
        "mfu": ips * 3 * RESNET_FWD_FLOPS / BF16_FLOPS_PER_S,
        "mfu_convention": "bench.py: 3 x 4.1 GFLOP per image over 989 TF/s",
        "peak_memory_gb": peak_gb,
        "launches": {k_: launches[k_] for k_ in ("conv_bn_fwd",
                                                  "conv_bn_bwd")},
        "conv_bn_fwd_routes": fwd_routes,
        "conv_bn_bwd_routes": routes,
        "sync_buckets": len(opt.buckets),
        "buckets_launched_from_hooks": sum(h for _, h in opt.launch_log),
        "card": card}
    log("resnet train: " + json.dumps(train))
    profile_train_step(step, state, batches[-1], card,
                       label="resnet train profile")
    htt.shutdown()
    launches["conv_bn_fwd_routes"] = fwd_routes
    launches["conv_bn_bwd_routes"] = routes
    return launches


def resnet_card_vs_cpu(htt) -> None:
    """The small f32 fused ResNet of tests/test_fused_conv_bn.py
    (stage_sizes [1, 1], 8 filters, 10 classes, 2 x 32 x 32 images) with
    the same weights and batch on the CPU (plain versions) and on the card
    (the kernels): train-mode logits, running statistics, every gradient
    leaf, then the parameters after two SGD steps (0.01, momentum 0.9)."""
    from horovod_tpu_torch.models import resnet
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (2,)))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = htt.ResNet(stage_sizes=[1, 1],
                           block_cls=resnet.BottleneckBlock, num_classes=10,
                           num_filters=8, dtype=torch.float32,
                           fused_conv_bn=True, device=dev, seed=3)
        xd, yd = x.to(dev), y.to(dev)
        logits = model(xd, train=True)
        torch.nn.functional.cross_entropy(logits, yd).backward()
        stats = [b.detach().cpu().clone() for b in model.buffers()]
        grads = [p.grad.detach().cpu().clone() for p in model.parameters()]
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        opt.step()
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(xd, train=True), yd
                                          ).backward()
        opt.step()
        runs[dev] = (logits.detach().cpu(), stats, grads,
                     [p.detach().cpu() for p in model.parameters()])

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    (lc, sc, gc, pc), (lg, sg, gg, pg) = runs["cpu"], runs["cuda"]
    out = {"logits": rel(lg, lc),
           "running_stats": max(rel(a, b) for a, b in zip(sg, sc)),
           "gradients": max(rel(a, b) for a, b in zip(gg, gc)),
           "params_after_2_steps": max(rel(a, b) for a, b in zip(pg, pc))}
    log("resnet card vs cpu (small f32 fused ResNet, 2 x 32^2): worst "
        "relative difference " + json.dumps(
            {k_: float(f"{v_:.2e}") for k_, v_ in out.items()})
        + f" (tol {RESNET_REL_TOL})")
    for k_, v_ in out.items():
        if not v_ <= RESNET_REL_TOL[k_]:
            raise AssertionError(f"resnet card vs cpu: {k_} differ: {v_}")


# ---------------------------------------------------------------------------
# phase 4c: the resilient train loop at full width and depth
# ---------------------------------------------------------------------------

# Snapshots of the resilient phase go under build/ (ignored by git) and are
# deleted when the phase ends.
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "resilient_ckpt")
CKPT_INTERVAL, PREEMPT_AT = 2, 3
# The snapshot phase 12 serves from (a copy of the preempted run's), under
# build/ too; phase 12 deletes it.
HANDOFF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "serve_handoff")


def host_tree(tree):
    """A nested dict of tensors copied to the host."""
    from horovod_tpu_torch.utils import tree as tree_util
    return tree_util.tree_map(lambda t: t.detach().to("cpu", copy=True),
                              tree)
RESILIENT_WORLD_S = 420     # the N-card resilient world's deadline
CKPT_BUDGET = 0.05          # HOROVOD_CKPT_OVERHEAD_BUDGET's default


def resilient_state(htt, cfg, dev, seed: int, fused: bool):
    """A fresh flagship state and step from the weights of ``seed``: the
    unfused step with torch.optim.SGD, or the fused one (EpilogueSGD in
    the bucket epilogues, the error-feedback residual per rank)."""
    if fused:
        return flagship_fused_step(htt, cfg, dev, seed)
    params = htt.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    init_fn, step = htt.make_transformer_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        device=dev)
    return init_fn(params), step


def state_tensors(htt, state):
    """``{name: tensor}`` of a flagship state: every parameter, its
    momentum and, for the fused step with error feedback, its residual."""
    from horovod_tpu_torch.utils import tree as tree_util
    leaves = tree_util.tree_leaves(state.params)
    out = {f"param{i}": t.detach() for i, t in enumerate(leaves)}
    opt = state.opt_state
    if isinstance(opt, torch.optim.Optimizer):
        for i, t in enumerate(leaves):
            out[f"momentum{i}"] = opt.state[t]["momentum_buffer"]
    else:
        for i, t in enumerate(tree_util.tree_leaves(opt.opt.slots[0])):
            out[f"momentum{i}"] = t
        residual = tree_util.tree_leaves(opt.residual) \
            if isinstance(opt.residual, dict) else []
        for i, t in enumerate(residual):
            out[f"residual{i}"] = t
    return out


def resilient_runs(htt, fa, cfg, dev, batches, root, *, fused=False,
                   deny=None):
    """The interrupt-and-resume check through ``train_loop``:

    1. ``len(batches)`` steps uninterrupted through an AsyncCheckpointer
       at interval CKPT_INTERVAL (with chaos ``commit_deny`` at ``deny``:
       that step's commit must be abandoned and the previous snapshot
       stay the newest committed one), beside a PreemptionHandler that
       is never asked to stop and polls the store every step, so the
       step times show what its store calls pay while a save drains;
    2. a fresh state, preempted at step PREEMPT_AT (chaos ``preempt_at``
       through a PreemptionHandler): status ``preempted``, exit code 75,
       the quiesce step committed;
    3. a third fresh state whose ``train_loop`` restores that snapshot and
       runs the remaining batches.

    The committed steps are read after rank 0's rotation (a barrier
    follows its last write) and must be exactly the ones expected.

    Returns the uninterrupted and the resumed state's tensors (on the
    card), the three runs' info dicts, step times and flash launches."""
    from horovod_tpu_torch.callbacks import StepStats
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.resilience import (AsyncCheckpointer,
                                              PreemptionHandler, chaos,
                                              list_committed_steps)
    out = {"launches": [], "step_ms": []}

    def committed(ck):
        ck.wait()                  # rank 0: its commit and rotation
        if htt.size() > 1:
            htt.barrier()
        return list_committed_steps(ck.directory)

    def run(state, step, bs, ck, preemption=None):
        stamps, saved, calls, copies, reserves = [], [], [], [], []
        maybe_save, reserve = ck.maybe_save, ck.reserve

        def timed_reserve(st):       # the pinned buffers, made once
            t0 = time.perf_counter()
            reserve(st)
            reserves.append((time.perf_counter() - t0) * 1e3)

        def recorded(i, st):
            """Which steps saved (not only tried), the host ms of each
            such call and, by events around it on the current stream, the
            device ms of the copies it queued."""
            t0 = time.perf_counter()
            if dev.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            ok = maybe_save(i, st)
            if ok:
                calls.append((time.perf_counter() - t0) * 1e3)
                if dev.type == "cuda":
                    e1 = torch.cuda.Event(enable_timing=True)
                    e1.record()
                    copies.append((e0, e1))
                saved.append(i)
            return ok

        ck.maybe_save, ck.reserve = recorded, timed_reserve

        def on_step(i, st, loss):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            if not np.isfinite(float(loss)):
                raise AssertionError(f"non-finite loss {float(loss)} at "
                                     f"step {i}")

        fa.reset_launches()
        t0 = time.perf_counter()
        state, info = htt.train_loop(step, state, bs, checkpointer=ck,
                                     preemption=preemption,
                                     step_stats=StepStats(), on_step=on_step)
        launches = dict(fa.LAUNCHES)
        if dev.type == "cuda" and min(
                launches.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq",
                                             "flash_bwd_dkv")) \
                < cfg.n_layers * max(len(stamps), 1):
            raise AssertionError(f"resilient run: flash launches "
                                 f"{launches} over {len(stamps)} steps")
        out["launches"].append(launches)
        out["step_ms"].append([float(x) * 1e3
                               for x in np.diff([t0] + stamps)])
        out.setdefault("saved_steps", []).append(saved)
        out.setdefault("reserve_ms", []).append(reserves)
        out.setdefault("save_call_ms", []).append(calls)
        out.setdefault("save_copy_ms", []).append(
            [a.elapsed_time(b) for a, b in copies])
        return state, info

    n = len(batches)
    # 1: uninterrupted
    if deny is not None:
        chaos.install({"commit_deny": [deny]})
    state, step = resilient_state(htt, cfg, dev, 0, fused)
    ck = AsyncCheckpointer(os.path.join(root, "uninterrupted"),
                           interval=CKPT_INTERVAL, max_to_keep=2)
    knobs.set_override("HOROVOD_PREEMPTION_POLL_SECONDS", 0.0)
    h = PreemptionHandler(checkpointer=ck, margin=0, install_signals=False)
    try:
        state, info1 = run(state, step, batches, ck, h)
        out["uninterrupted_steps"] = committed(ck)
    finally:
        h.close()
        knobs.clear_override("HOROVOD_PREEMPTION_POLL_SECONDS")
        ck.close()
        chaos.install(None)
    if info1 != {"status": "completed", "exit_code": 0, "restored": False,
                 "start_step": 0, "final_step": n}:
        raise AssertionError(f"uninterrupted run: info {info1}")
    # the steps right after a save carry its copy; the others (less the
    # first, which warms up) run beside a draining write
    after = [i for i in out["saved_steps"][0] if i < n]
    out["after_save_ms"] = [out["step_ms"][0][i] for i in after]
    out["other_steps_ms"] = [out["step_ms"][0][i] for i in range(1, n)
                             if i not in after]
    # Several ranks save at the multiples of the interval (none deferred
    # here: two buffer sets, two saves); every save not denied commits and
    # rotation keeps the newest two. One rank saves at step 1 and then
    # whenever its last write has landed, which the timing decides.
    steps = out["uninterrupted_steps"]
    want = [s for s in range(CKPT_INTERVAL, n + 1, CKPT_INTERVAL)
            if s != deny][-2:]
    if (htt.size() > 1 and steps != want) or not 1 <= len(steps) <= 2:
        raise AssertionError(
            f"uninterrupted run (commit_deny at {deny}): committed "
            f"{steps}, want {want if htt.size() > 1 else 'one or two'}")
    ref = {k: t.clone() for k, t in state_tensors(htt, state).items()}
    del state, step
    # 2: preempted
    chaos.install({"preempt_at": PREEMPT_AT})
    state, step = resilient_state(htt, cfg, dev, 0, fused)
    pre_dir = os.path.join(root, "preempted")
    ck = AsyncCheckpointer(pre_dir, interval=CKPT_INTERVAL, max_to_keep=1)
    h = PreemptionHandler(checkpointer=ck, margin=0, install_signals=False)
    try:
        state, info2 = run(state, step, batches, ck, h)
        out["preempted_steps"] = committed(ck)
    finally:
        h.close()
        chaos.install(None)
    if info2 != {"status": "preempted", "exit_code": 75, "restored": False,
                 "start_step": 0, "final_step": PREEMPT_AT} \
            or out["preempted_steps"] != [PREEMPT_AT]:
        ck.close()
        raise AssertionError(f"preempted run: info {info2}, committed "
                             f"{out['preempted_steps']}")
    out["preempted_state"], out["preempted_ck"] = state, ck
    out["step"] = step
    # 3: restored (the caller measures on the preempted state first)
    out["ref"] = ref
    out["infos"] = [info1, info2]
    return out


def resume_run(htt, fa, cfg, dev, batches, root, res, *, fused=False):
    """Step 3 of :func:`resilient_runs`: a fresh state restored from the
    preempted run's snapshot, to the end of ``batches``; returns its
    tensors and the restore's seconds (goodput's restart phase)."""
    from horovod_tpu_torch.callbacks import StepStats
    from horovod_tpu_torch.resilience import AsyncCheckpointer
    state, step = resilient_state(htt, cfg, dev, 0, fused)
    ck = AsyncCheckpointer(os.path.join(root, "preempted"),
                           interval=CKPT_INTERVAL, max_to_keep=1)
    before = htt.goodput_report()["phases"]["restart"]
    fa.reset_launches()
    try:
        state, info3 = htt.train_loop(step, state, batches[PREEMPT_AT:],
                                      checkpointer=ck,
                                      step_stats=StepStats())
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        ck.close()
    launches = dict(fa.LAUNCHES)
    restore_s = htt.goodput_report()["phases"]["restart"] - before
    if info3 != {"status": "completed", "exit_code": 0, "restored": True,
                 "start_step": PREEMPT_AT, "final_step": len(batches)}:
        raise AssertionError(f"resumed run: info {info3}")
    got = state_tensors(htt, state)
    diff = {k: float((got[k].double() - t.double()).abs().max())
            for k, t in res["ref"].items() if not torch.equal(got[k], t)}
    res["infos"].append(info3)
    res["launches"].append(launches)
    return got, diff, restore_s


def snapshot_probe(ck, state, dev, n: int = 2):
    """The on-path cost of a snapshot (from the call until the copy has
    landed: the stream is busy with it), the copy's device time and the
    background write (serialize, sha256, write, fsync, commit) of ``n``
    saves of ``state``; the first may allocate its pinned buffers."""
    rows = []
    for i in range(n):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1000 + i, state)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        ck.wait()
        t2 = time.perf_counter()
        rows.append({"on_path_ms": (t1 - t0) * 1e3,
                     "copy_device_ms": ck.last_copy_seconds * 1e3,
                     "write_s": t2 - t1})
    return rows


def resilient_train(htt, fa, card, n_steps: int = 4,
                    device="cuda") -> tuple:
    """The resilient phase at full width and depth (``resilient train:``
    line): the flagship through ``train_loop`` in an NCCL world of one,
    uninterrupted, preempted at step PREEMPT_AT and resumed, the resumed
    parameters and momentum bitwise equal to the uninterrupted ones;
    snapshot bytes, on-path ms, write s, restore s and the share of step
    time HOROVOD_CKPT_INTERVAL=auto would pay. Returns the digests of the
    uninterrupted run's tensors (phase 8 holds the launched run to
    them) and the handoff: a copy of the preempted run's committed
    snapshot (HANDOFF_DIR) with the parameters it holds, on the host
    (phase 12 serves them)."""
    import math
    import shutil
    from horovod_tpu_torch.resilience import AsyncCheckpointer
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    ctx = htt.init(device=device)
    dev = ctx.device
    try:
        gen = torch.Generator(device=dev).manual_seed(1)
        batches = [tuple(torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                                       generator=gen, device=dev)
                         for _ in range(2)) for _ in range(n_steps + 1)]
        res = resilient_runs(htt, fa, cfg, dev, batches, CKPT_ROOT)
        state, pre_ck = res.pop("preempted_state"), res.pop("preempted_ck")
        pre_ck.close()
        # phase 12's train-to-serve handoff reads this committed snapshot;
        # the parameters it holds stay on the host beside it
        shutil.rmtree(HANDOFF_DIR, ignore_errors=True)
        shutil.copytree(os.path.join(CKPT_ROOT, "preempted"), HANDOFF_DIR)
        handoff = {"dir": HANDOFF_DIR, "step": PREEMPT_AT,
                   "params": host_tree(state.params)}
        shutil.rmtree(os.path.join(CKPT_ROOT, "uninterrupted"),
                      ignore_errors=True)
        tensors = state_tensors(htt, state)
        nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
        probe_ck = AsyncCheckpointer(os.path.join(CKPT_ROOT, "probe"),
                                     interval=0, max_to_keep=1)
        try:
            probe = snapshot_probe(probe_ck, state, dev)
            shard = os.path.join(probe_ck.directory, "step-0000001001",
                                 "shard-00000.pkl")
            shard_bytes = os.path.getsize(shard)
        finally:
            probe_ck.close()
        del state, tensors, res["step"]
        got, diff, restore_s = resume_run(htt, fa, cfg, dev, batches,
                                          CKPT_ROOT, res)
        n_params = sum(t.numel() for k, t in res["ref"].items()
                       if k.startswith("param"))
        del got
        ref_digests = digests(res.pop("ref"))
    finally:
        htt.shutdown()
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    # a step's time without a save: the median over the first two runs
    # (a save's copy lands in the step after it)
    step_s = float(np.median([x for ms in res["step_ms"][:2]
                              for x in ms])) / 1e3
    cost_s = probe[-1]["on_path_ms"] / 1e3
    interval = max(1, math.ceil(cost_s / (CKPT_BUDGET * step_s)))
    line = {
        "model": "flagship TransformerLM", "batch": TRAIN_B, "seq": TRAIN_S,
        "optimizer": "torch.optim.SGD(0.01, momentum=0.9)",
        "parameters": n_params, "steps": len(batches),
        "interval": CKPT_INTERVAL, "preempt_at": PREEMPT_AT,
        "infos": res["infos"],
        "uninterrupted_committed": res["uninterrupted_steps"],
        "preempted_committed": res["preempted_steps"],
        "resumed_bitwise_equal": not diff,
        "leaves_differing": len(diff),
        "max_abs_diff": max(diff.values()) if diff else 0.0,
        "snapshot_bytes": nbytes, "shard_file_bytes": shard_bytes,
        "snapshot_probe": probe,
        "on_path_snapshot_ms": probe[-1]["on_path_ms"],
        "write_s": probe[-1]["write_s"], "restore_s": restore_s,
        "step_ms": res["step_ms"], "step_ms_median": step_s * 1e3,
        "saved_steps": res["saved_steps"], "reserve_ms": res["reserve_ms"],
        "save_call_ms": res["save_call_ms"],
        "save_copy_ms": res["save_copy_ms"],
        "after_save_ms": res["after_save_ms"],
        "other_steps_ms": res["other_steps_ms"],
        "auto_interval": interval,
        "auto_overhead_share": cost_s / (interval * step_s),
        "overhead_share_per_save": cost_s / step_s,
        "flash_launches": res["launches"], "card": card}
    log("resilient train: " + json.dumps(line))
    if diff:
        raise AssertionError(
            f"the resumed run differs from the uninterrupted one in "
            f"{len(diff)} leaves (max abs diff {max(diff.values())})")
    return ref_digests, handoff


def resilient_rank(rank, world, ports, results, device="cuda",
                   n_steps: int = 4):
    """One rank of the N-card interrupt-and-resume check: the fused
    flagship at fp8_e4m3 with error feedback (a residual per rank). Every
    rank writes its own shard and rank 0 commits behind the c10d-store
    barrier; commit_deny at step 4 of the uninterrupted run leaves step 2
    committed; the resumed run equals the uninterrupted one bitwise on
    every rank, residuals included. Every rank puts its result on
    ``results``."""
    import faulthandler
    import shutil
    import torch.distributed as dist
    join_store_world(rank, world, ports, device)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops import flash_attention as fa
    # a rank that hangs prints every thread's stack before the deadline
    faulthandler.dump_traceback_later(RESILIENT_WORLD_S - 60, exit=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    ctx = htt.init(device=device)
    dev = ctx.device
    root = os.path.join(CKPT_ROOT, f"world{world}")
    try:
        cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                           dp_axis="dp")
        b, s = TRAIN_B, TRAIN_S
        gen = torch.Generator(device=dev).manual_seed(1)
        rows = slice(rank * b, (rank + 1) * b)
        batches = [tuple(torch.randint(0, cfg.vocab_size, (b * world, s),
                                       generator=gen, device=dev)[rows]
                         for _ in range(2)) for _ in range(n_steps + 1)]
        res = resilient_runs(htt, fa, cfg, dev, batches, root, fused=True,
                             deny=4)
        state, pre_ck = res.pop("preempted_state"), res.pop("preempted_ck")
        pre_ck.close()
        del state, res["step"]
        htt.barrier()
        if rank == 0:
            shutil.rmtree(os.path.join(root, "uninterrupted"),
                          ignore_errors=True)
        got, diff, restore_s = resume_run(htt, fa, cfg, dev, batches, root,
                                          res, fused=True)
        ref = res.pop("ref")
        residual = sum(float(t.double().abs().sum()) for k, t in
                       ref.items() if k.startswith("residual"))
        sums = htt.allgather(torch.tensor([residual], dtype=torch.float64,
                                          device=dev))
        htt.barrier()
        results.put({
            "rank": rank, "infos": res["infos"],
            "uninterrupted_committed": res["uninterrupted_steps"],
            "preempted_committed": res["preempted_steps"],
            "resumed_bitwise_equal": not diff,
            "leaves_differing": len(diff),
            "max_abs_diff": max(diff.values()) if diff else 0.0,
            "residual_leaves": sum(k.startswith("residual") for k in ref),
            "residual_abs_sum": residual,
            "residual_sums_distinct_across_ranks":
                len(set(sums.tolist())) == world,
            "restore_s": restore_s, "step_ms": res["step_ms"],
            "saved_steps": res["saved_steps"],
            "reserve_ms": res["reserve_ms"],
            "save_call_ms": res["save_call_ms"],
            "save_copy_ms": res["save_copy_ms"],
            "after_save_ms": res["after_save_ms"],
            "other_steps_ms": res["other_steps_ms"]})
    finally:
        faulthandler.cancel_dump_traceback_later()
        htt.shutdown()
        knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
        dist.destroy_process_group()


def resilient_world(n: int, card: str, **kw) -> None:
    """:func:`resilient_rank` on ``n`` cards (``resilient train data
    parallel:`` line); fails unless every rank resumed bitwise with its
    own residual."""
    out = sorted(spawn_world(resilient_rank, n, n, RESILIENT_WORLD_S,
                             **kw), key=lambda r: r["rank"])
    log("resilient train data parallel: " + json.dumps({
        "model": "flagship TransformerLM fused", "tier": "fp8_e4m3",
        "error_feedback": True, "n_cards": n, "batch_per_card": TRAIN_B,
        "seq": TRAIN_S, "commit_deny": 4, "ranks": out, "card": card}))
    for r in out:
        if not (r["resumed_bitwise_equal"] and r["residual_leaves"]
                and r["residual_sums_distinct_across_ranks"]):
            raise AssertionError(f"rank {r['rank']}: the resumed run is "
                                 f"not the uninterrupted one: {r}")


# ---------------------------------------------------------------------------
# phase 5: card against CPU
# ---------------------------------------------------------------------------

def card_vs_cpu(htt):
    from horovod_tpu_torch.serving import ServeEngine
    cfg = flagship_cfg(htt.TransformerConfig, n_layers=2,
                       dtype=torch.float32)
    cpu_params = htt.init_params(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
    gpu_params = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in cpu_params.items()}
    engines = [ServeEngine(cfg, cpu_params, device="cpu"),
               ServeEngine(cfg, gpu_params, device="cuda")]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 300, 129)]
    worst = 0.0

    def compare(what, toks):
        nonlocal worst
        a, b = (e.last_logits.float().cpu() for e in engines)
        err = float((a - b).abs().max())
        worst = max(worst, err)
        if toks[0] != toks[1] or err > LOGIT_TOL:
            raise AssertionError(f"{what}: card and CPU differ (tokens "
                                 f"{toks}, max logit diff {err})")

    last = []
    for p in prompts:
        slots = [e.reserve(p.size + 8) for e in engines]
        toks = [e.prefill(s, p) for e, s in zip(engines, slots)]
        compare(f"prefill of {p.size} tokens", toks)
        last.append(toks[0])
    active = np.zeros((engines[0].slots,), bool)
    active[:len(prompts)] = True
    for step in range(6):
        tokens = np.zeros((engines[0].slots,), np.int32)
        tokens[:len(prompts)] = last
        outs = [e.decode_step(tokens, active=active) for e in engines]
        toks = [o[active].tolist() for o in outs]
        compare(f"decode step {step}", toks)
        last = toks[0]
    log(f"card vs cpu (2-layer f32 flagship width): tokens identical, "
        f"max logit diff {worst:.3e} (tol {LOGIT_TOL:.0e})")


def train_card_vs_cpu(htt) -> None:
    """A 2-layer f32 copy of the flagship at full width, the same numpy
    parameters and batch on the CPU and on the card: the loss and every
    gradient leaf, then the parameters after two SGD steps (no collective:
    dp_axis=None)."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.utils import tree as tree_util
    cfg = flagship_cfg(htt.TransformerConfig, n_layers=2,
                       dtype=torch.float32, mlp_recompute=True)
    np_params = tree_util.tree_map(
        lambda t: t.numpy(),
        htt.init_params(cfg, torch.Generator().manual_seed(3),
                        device="cpu"))
    rng = np.random.default_rng(4)
    tokens, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 256))) for _ in range(2))
    runs = {}
    for dev in ("cpu", "cuda"):
        params = htt.params_from_numpy(np_params, device=dev)
        leaves = tree_util.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = tfm.loss_fn(cfg, params, tokens.to(dev), labels.to(dev))
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        loss = loss.detach()
        init_fn, step = htt.make_transformer_train_step(
            cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
            device=dev)
        state = init_fn(htt.params_from_numpy(np_params, device=dev))
        for _ in range(2):
            state, _ = step(state, tokens, labels)
        runs[dev] = (loss.item(), grads,
                     [t.detach().cpu() for t in
                      tree_util.tree_leaves(state.params)])

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = max(rel(a, b) for a, b in zip(g_gpu, g_cpu))
    param_rel = max(rel(a, b) for a, b in zip(p_gpu, p_cpu))
    log(f"train card vs cpu (2-layer f32 flagship width, B=2 S=256): loss "
        f"{l_gpu:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}), worst gradient "
        f"leaf rel {grad_rel:.2e} (tol {GRAD_REL_TOL:.0e}), params after "
        f"2 SGD steps rel {param_rel:.2e} (tol {PARAM_REL_TOL:.0e})")
    if not (loss_rel <= PARAM_REL_TOL and grad_rel <= GRAD_REL_TOL
            and param_rel <= PARAM_REL_TOL):
        raise AssertionError("training on the card and on the CPU differ")


def fused_card_vs_cpu(htt) -> None:
    """The tiny f32 fused step (TINY_CFG, EpilogueSGD(0.05, momentum 0.9),
    fp8_e4m3 with error feedback, small buckets) in a world of one, from
    the same numpy weights and batches on the CPU (gloo) and on the card
    (NCCL): losses, parameters and the residual after three steps."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.utils import tree as tree_util
    cfg = htt.TransformerConfig(**TINY_CFG, dtype=torch.float32,
                                dp_axis="dp")
    np_params = tree_util.tree_map(lambda t: t.numpy(), htt.init_params(
        cfg, torch.Generator().manual_seed(5), device="cpu"))
    rng = np.random.default_rng(8)
    batches = [(rng.integers(0, 256, (4, 32)), rng.integers(0, 256, (4, 32)))
               for _ in range(3)]
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", 64 * 1024)
    runs = {}
    try:
        for dev in ("cpu", "cuda"):
            htt.init(device=dev)
            try:
                da = htt.distributed_apply(
                    htt.EpilogueSGD(0.05, momentum=0.9),
                    sync_axes=tfm.grad_sync_axes(cfg))
                init_fn, step = htt.make_transformer_train_step_fused(
                    cfg, da, device=dev)
                state = init_fn(htt.params_from_numpy(np_params, device=dev))
                losses = []
                for toks, labels in batches:
                    state, loss = step(state, toks, labels)
                    losses.append(float(loss))
                runs[dev] = (losses, [t.detach().cpu() for t in
                                      tree_util.tree_leaves(state.params)],
                             [t.cpu() for t in tree_util.tree_leaves(
                                 state.opt_state.residual)])
            finally:
                htt.shutdown()
    finally:
        knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
        knobs.clear_override("HOROVOD_GRADIENT_BUCKET_BYTES")
    (lc, pc, rc), (lg, pg, rg) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    flip_share, param_rel = 0.0, 0.0
    for a, b in zip(pg, pc):
        top = max(1.0, float(b.abs().max()))
        d = (a - b).abs() / top
        flip_share = max(flip_share, float((d > 1e-5).float().mean()))
        param_rel = max(param_rel, float(d.max()))
    res_close = min(float(((a - b).abs() <= 1e-5).float().mean())
                    for a, b in zip(rg, rc))
    log(f"fused card vs cpu (tiny f32, fp8_e4m3 + error feedback, 3 steps):"
        f" loss rel {loss_rel:.2e}, params worst rel {param_rel:.2e}, "
        f"largest share of a leaf beyond 1e-5 {flip_share:.2e} (tol "
        f"{FP8_FLIP_SHARE:.0e}), residual share within 1e-5 {res_close:.4f}")
    if not (loss_rel <= 1e-5 and param_rel <= 1e-3
            and flip_share <= FP8_FLIP_SHARE and res_close >= 0.95):
        raise AssertionError("the fused fp8 step on the card and on the CPU "
                             "differ")


# ---------------------------------------------------------------------------
# the collectives: a world of one in the default run, N cards with
# --data-parallel N
# ---------------------------------------------------------------------------

def collectives_world_one(htt, dev="cuda") -> None:
    """Every collective of ``ops.collectives`` and ``ops.sparse`` through
    NCCL in a world of one, on tensors of ``dev``, each against its plain
    result exactly; then ``init(mesh_shape=(1, 1))`` with the (cross,
    local) axes and the hierarchical and two-level allreduce at one rank
    each (the two-level one also with the fp8 codec)."""
    from horovod_tpu_torch.compression import WireCodec
    from horovod_tpu_torch.ops import collectives as C
    t0 = time.perf_counter()
    htt.init(device=dev, mesh_shape=(1, 1),
             axis_names=("hvd_cross", "hvd_local"))
    try:
        from horovod_tpu_torch.runtime import get_context
        backend = get_context().backend
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(7, 3, device=dev, generator=g)
        xi = torch.randint(-9, 9, (5, 2), device=dev, generator=g,
                           dtype=torch.int32)
        dense, counts = htt.sparse_allreduce(
            x[:2], torch.tensor([1, 1], device=dev), 4, average=False)
        want_dense = torch.zeros(4, 3, device=dev)
        want_dense[1] = x[0] + x[1]
        codec = WireCodec("fp8_e4m3")
        wire, scale = codec.encode(x, world=1)
        checks = {
            "allgather": (C.allgather(x), x),
            "allgather_bf16": (C.allgather(x.bfloat16()), x.bfloat16()),
            "alltoall": (C.alltoall(x), x),
            "alltoall_splits": (C.alltoall(x, splits=[7])[0], x),
            "reducescatter": (C.reducescatter(x, htt.Sum), x),
            "reducescatter_int": (C.reducescatter(xi, htt.Sum), xi),
            "reducescatter_max": (C.reducescatter(x, htt.Max), x),
            "ppermute": (C.ppermute(x, [(0, 0)]), x),
            "broadcast": (C.broadcast(x, 0), x),
            "allreduce_axis_local": (C.allreduce(x, htt.Sum,
                                                 axis="hvd_local"), x),
            "sparse_allreduce": (dense, want_dense),
            "sparse_counts": (counts, torch.tensor(
                [0, 2, 0, 0], dtype=torch.int32, device=dev)),
            "hierarchical_allreduce": (C.hierarchical_allreduce(x[:6]),
                                       x[:6]),
            "two_level_allreduce": (C.two_level_allreduce(
                x, htt.Average, ici_axes=("hvd_local",),
                dcn_axis="hvd_cross"), x),
            "two_level_allreduce_fp8": (C.two_level_allreduce(
                x, htt.Sum, ici_axes=("hvd_local",), dcn_axis="hvd_cross",
                wire_codec=codec), codec.decode(wire, scale, x.dtype))}
        if dev == "cuda":
            torch.cuda.synchronize()
        bad = [name for name, (got, ref) in checks.items()
               if got.device != ref.device or got.dtype != ref.dtype
               or not torch.equal(got, ref)]
    finally:
        htt.shutdown()
    if bad:
        raise AssertionError(f"collectives (world 1): {bad} differ from "
                             f"their plain results")
    log("collectives (world 1): " + json.dumps({
        "backend": backend, "checked_exactly": sorted(checks),
        "seconds": round(time.perf_counter() - t0, 3)}))


def _int_valued(gen, shape, dev, dtype=torch.float32):
    """Integer values in [-1000, 1000), so every sum of a few ranks is
    exact in f32 and a comparison can be exact."""
    return torch.randint(-1000, 1000, shape, generator=gen, device=dev
                         ).to(dtype)


def coll_unit(big: bool, world: int) -> int:
    """Rows a rank's share holds: 64 MiB of 1024-wide f32 rows over the
    world, or 251 rows of 3 (a small, odd size)."""
    return COLL_BIG_BYTES // (4 * 1024 * world) if big else 251


def coll_splits(r, world, unit):
    """Rank r's alltoall send counts: unequal, ``unit`` + 0, 5 or 10."""
    return [unit + (r + d) % 3 * 5 for d in range(world)]


def coll_case_inputs(case, r, world, big, dev):
    """Rank r's input of one ``collective`` case, seeded by case, size and
    rank, so that every rank can rebuild every rank's input."""
    gen = torch.Generator(device=dev).manual_seed(
        1000 * (COLL_CASES.index(case) + 1) + 10 * r + int(big))
    cols, unit = (1024 if big else 3), coll_unit(big, world)
    rows = {"allgather": unit, "allgather_uneven": unit + 37 * r,
            "alltoall": world * unit, "reducescatter": world * unit,
            "alltoall_splits": sum(coll_splits(r, world, unit)),
            "reducescatter_uneven": world * unit + 3,
            "ppermute_ring": world * unit,
            "broadcast_process_set": world * unit}
    if case == "sparse_allreduce":
        nnz = unit + 11 * r
        return (_int_valued(gen, (nnz, cols), dev),
                torch.randint(0, 4 * unit, (nnz,), generator=gen,
                              device=dev))
    return _int_valued(gen, (rows[case], cols), dev)


def coll_run(htt, case, x, r, world, unit, ps):
    """Rank r's call of ``case`` on its input ``x``."""
    from horovod_tpu_torch.ops import collectives as C
    if case in ("allgather", "allgather_uneven"):
        return C.allgather(x)
    if case == "alltoall":
        return C.alltoall(x)
    if case == "alltoall_splits":
        return C.alltoall(x, splits=coll_splits(r, world, unit))[0]
    if case in ("reducescatter", "reducescatter_uneven"):
        return C.reducescatter(x, htt.Sum)
    if case == "ppermute_ring":
        return C.ppermute(x, [(i, (i + 1) % world) for i in range(world)])
    if case == "broadcast_process_set":
        return C.broadcast(x, root_rank=1, process_set=ps)
    if case == "sparse_allreduce":
        return htt.sparse_allreduce(x[0], x[1], 4 * unit)[0]
    raise KeyError(case)


def coll_plain(case, xs, r, world, unit):
    """Rank r's result of ``case`` in plain torch from every rank's
    input."""
    if case in ("allgather", "allgather_uneven"):
        return torch.cat(xs)
    if case == "alltoall":
        return torch.cat([x.chunk(world)[r] for x in xs])
    if case == "alltoall_splits":
        return torch.cat([x.split(coll_splits(s, world, unit))[r]
                          for s, x in enumerate(xs)])
    if case in ("reducescatter", "reducescatter_uneven"):
        total = torch.stack(xs).sum(0)
        base, rem = divmod(total.shape[0], world)
        return total.split([base + (1 if i < rem else 0)
                            for i in range(world)])[r]
    if case == "ppermute_ring":
        return xs[(r - 1) % world]
    if case == "broadcast_process_set":
        return xs[1] if r in (0, 1, 2) else xs[r]
    if case == "sparse_allreduce":
        vals = torch.cat([v for v, _ in xs])
        dense = vals.new_zeros((4 * unit, vals.shape[1]))
        return dense.index_add_(0, torch.cat([i for _, i in xs]),
                                vals) / world
    raise KeyError(case)


def coll_bytes(case, xs, r, world):
    """(nccl-tests size in bytes, bus-bandwidth factor) of ``case``:
    all-gathers count their output, reduce-scatters their input,
    all-to-alls one rank's send buffer, the rest the tensor;
    busbw = size / time x factor."""
    nb = [int(x.numel() * x.element_size()) if torch.is_tensor(x)
          else int(x[0].numel() * x[0].element_size()) for x in xs]
    ring = (world - 1) / world
    if case in ("allgather", "allgather_uneven", "sparse_allreduce"):
        return sum(nb), ring
    if case in ("alltoall", "alltoall_splits", "reducescatter",
                "reducescatter_uneven"):
        return nb[r], ring
    return nb[r], 1.0


COLL_CASES = ["allgather", "allgather_uneven", "alltoall",
              "alltoall_splits", "reducescatter", "reducescatter_uneven",
              "ppermute_ring", "broadcast_process_set", "sparse_allreduce"]
COLL_BIG_BYTES = 64 << 20
COLL_ITERS = {False: 50, True: 10}


def coll_bare(case, x, rank, world):
    """The one ``torch.distributed`` call an even case maps to, on the
    default group and the same input (None for the others): what the
    port's wrapper adds shows beside it."""
    import torch.distributed as dist
    if case == "allgather":
        out = x.new_empty((world * x.shape[0],) + x.shape[1:])
        return lambda: dist.all_gather_into_tensor(out, x)
    if case == "alltoall":
        out = torch.empty_like(x)
        return lambda: dist.all_to_all_single(out, x)
    if case == "reducescatter":
        out = x.new_empty((x.shape[0] // world,) + x.shape[1:])
        return lambda: dist.reduce_scatter_tensor(out, x)
    if case == "ppermute_ring":
        out = torch.empty_like(x)

        def ring():
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (rank + 1) % world),
                    dist.P2POp(dist.irecv, out, (rank - 1) % world)]):
                w.wait()
        return ring
    return None


def _coll_timed(fn, iters, dev):
    """ms a call of ``fn`` over ``iters`` calls, after two untimed ones
    (so allocator growth and lazy set-up stay out), by CUDA events."""
    for _ in range(2):
        fn()
    if dev != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def coll_rank(rank, world, ports, results, device="cuda"):
    """One rank of the collectives' N-card world. (a) every case at a
    small ragged size and at 64 MiB against plain torch on every rank's
    input (rebuilt from the seeds), exactly (integer values), then timed;
    (b) ``hierarchical_allreduce`` on (cross 2, local N/2) and
    ``two_level_allreduce`` on (dcn 2, local N/2) against the flat
    allreduce at 25 MiB and 256 MiB, exactly, and timed. The process
    group is made here, so each ``init`` builds its topology on it."""
    import torch.distributed as dist
    join_store_world(rank, world, ports, device)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import collectives as C
    dev = device
    try:
        htt.init(device=device)
        # rank 0, which reports the times, is a member; its root is rank 1
        ps = htt.add_process_set([0, 1, 2])
        for case in COLL_CASES:
            line = {"world": world}
            for big in (False, True):
                unit = coll_unit(big, world)
                xs = [coll_case_inputs(case, s, world, big, dev)
                      for s in range(world)]
                mine = xs[rank]
                got = coll_run(htt, case, mine, rank, world, unit, ps)
                want = coll_plain(case, xs, rank, world, unit)
                ok = torch.tensor([float(torch.equal(got, want))],
                                  device=dev)
                size, factor = coll_bytes(case, xs, rank, world)
                del got, want, xs
                htt.barrier()
                ms = _coll_timed(lambda: coll_run(htt, case, mine, rank,
                                                  world, unit, ps),
                                 COLL_ITERS[big], dev)
                tag = "64mib" if big else "small"
                bare = coll_bare(case, mine, rank, world)
                if bare is not None:
                    htt.barrier()
                    line[f"torch_dist_ms_{tag}"] = _coll_timed(
                        bare, COLL_ITERS[big], dev)
                line[f"exact_{tag}"] = bool(
                    htt.allreduce(ok, htt.Min).item() == 1.0)
                line[f"bytes_{tag}"] = size
                line[f"ms_{tag}"] = ms
                line[f"busbw_gb_s_{tag}"] = size / (ms * 1e-3) * factor / 1e9
                del mine
            if rank == 0:
                results.put(("collective " + case, line))
        htt.shutdown()
        for name, kw, fn in (
                ("hierarchical_allreduce", {"mesh_shape": (2, world // 2)},
                 lambda x: C.hierarchical_allreduce(x, htt.Sum)),
                ("two_level_allreduce", {"dcn": 2},
                 lambda x: C.two_level_allreduce(
                     x, htt.Sum, ici_axes=("hvd_local",)))):
            htt.init(device=device, **kw)
            from horovod_tpu_torch.runtime import get_context
            line = {"world": world,
                    "mesh": get_context().topology.mesh.shape}
            for mib in (25, 256):
                gen = torch.Generator(device=dev).manual_seed(rank + mib)
                x = _int_valued(gen, ((mib << 20) // 4,), dev)
                got, flat = fn(x), htt.allreduce(x, htt.Sum)
                ok = torch.tensor([float(torch.equal(got, flat))],
                                  device=dev)
                htt.barrier()
                line[f"exact_vs_flat_{mib}mib"] = bool(
                    htt.allreduce(ok, htt.Min).item() == 1.0)
                line[f"ms_{mib}mib"] = _coll_timed(lambda: fn(x), 10, dev)
                line[f"flat_ms_{mib}mib"] = _coll_timed(
                    lambda: htt.allreduce(x, htt.Sum), 10, dev)
                del x, got, flat
            if rank == 0:
                results.put(("collective " + name, line))
            htt.shutdown()
    finally:
        if htt.is_initialized():
            htt.shutdown()
        dist.destroy_process_group()


def collectives_n_cards(n, card, device="cuda") -> None:
    """``coll_rank`` in ``n`` spawned processes; one ``collective
    <name>:`` line per case, each failing the run unless exact."""
    lines = spawn_world(coll_rank, n, len(COLL_CASES) + 2, 600,
                        device=device)
    for name, line in lines:
        line["card"] = card
        log(f"{name}: " + json.dumps(line))
        if not all(v for k, v in line.items() if k.startswith("exact")):
            raise AssertionError(f"{name}: a result differs from plain "
                                 f"torch: {line}")


# ---------------------------------------------------------------------------
# --data-parallel N: the training step across N cards
# ---------------------------------------------------------------------------

def join_store_world(rank, world, ports, device) -> None:
    """Form this rank's default process group over a TCPStore that rank 0
    binds to a port the OS picks (port 0) and hands to the others through
    ``ports``, so no world races another process for a port; the
    launcher's variables are set to match."""
    import datetime
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=300)
    if rank == 0:
        store = dist.TCPStore("localhost", 0, world, True, timeout=timeout,
                              wait_for_workers=False)
        for _ in range(world - 1):
            ports.put(store.port)
    else:
        store = dist.TCPStore("localhost", ports.get(timeout=300), world,
                              False, timeout=timeout)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(store.port),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world)


def spawn_world(target, world, n_results, deadline_s, *args, **kw):
    """``target(rank, world, ports, results, *args, **kw)`` in ``world``
    spawned processes; returns the ``n_results`` items they put on
    ``results``. A rank that fails leaves the others waiting in a
    collective, so every rank is stopped as soon as one exits non-zero
    (or at the deadline), and the call raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    results, ports = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=target,
                         args=(r, world, ports, results) + args, kwargs=kw)
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = [], time.monotonic() + deadline_s
    try:
        while len(out) < n_results and time.monotonic() < deadline:
            try:
                out.append(results.get(timeout=5))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(timeout=120 if len(out) == n_results else 1)
        for p in procs:
            if p.is_alive():
                p.kill()
    if len(out) < n_results or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"a rank of the {world}-card world of {target.__name__} "
            f"failed: exit codes {[p.exitcode for p in procs]}, "
            f"{len(out)} of {n_results} results")
    return out


def merged(ivs):
    """Sorted, disjoint [start, end] intervals covering ``ivs``."""
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def nccl_overlap(prof):
    """From a profiled step's device events: the NCCL kernels' device ms,
    the part of it during which a compute kernel also ran, and the
    compute kernels' ms (copies and memsets count as neither)."""
    nccl, comp = [], []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        name = ev.name.lower()
        if b <= a or name.startswith(("memcpy", "memset")):
            continue
        (nccl if "nccl" in name else comp).append((a, b))
    comp_m, nccl_m = merged(comp), merged(nccl)
    overlap = 0.0
    for a, b in nccl_m:
        for c, d in comp_m:
            overlap += max(0.0, min(b, d) - max(a, c))
    return {"nccl_ms": sum(b - a for a, b in nccl_m) / 1e3,
            "nccl_overlapped_ms": overlap / 1e3,
            "compute_ms": sum(b - a for a, b in comp_m) / 1e3}


def dp_variant(htt, rank, world, dev, variant, n_steps):
    """Build one variant's step and its batches (this rank's rows)."""
    model = variant["model"]
    if model in ZOO:
        spec = ZOO[model]
        state, step, put_batch = zoo_step(htt, dev, model, seed=rank)
        batches = resnet_batches(put_batch, n_steps + 2,
                                 spec["batch"] * world, dev,
                                 image=spec["image"])
        return state, step, batches, spec["batch"] * world, "images"
    if model == "resnet":
        state, step, put_batch = resnet_step(htt, dev, seed=rank)
        batches = resnet_batches(put_batch, n_steps + 2, RESNET_B * world,
                                 dev)
        return state, step, batches, RESNET_B * world, "images"
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    if model == "fused":
        state, step = flagship_fused_step(htt, cfg, dev, seed=rank)
    else:
        params = htt.init_params(
            cfg, torch.Generator(device=dev).manual_seed(rank), device=dev)
        init_fn, step = htt.make_transformer_train_step(
            cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
            device=dev)
        state = init_fn(params)
    b, s = TRAIN_B, TRAIN_S
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = slice(rank * b, (rank + 1) * b)
    batches = [tuple(torch.randint(0, cfg.vocab_size, (b * world, s),
                                   generator=gen, device=dev)[rows]
                     for _ in range(2)) for _ in range(n_steps + 2)]
    return state, step, batches, b * s * world, "tokens"


def dp_rank(rank, world, ports, results, variants, device="cuda",
            n_steps=4):
    """One rank of an N-card world: each variant (``model`` transformer,
    fused or resnet, with ``knobs`` overridden while it runs) trains from
    other weights on every rank (init broadcasts rank 0's) on its rows of
    each global batch: a warm-up step, ``n_steps`` timed steps, then one
    step under torch.profiler on rank 0 (the NCCL kernels' overlap with
    compute). Rank 0 puts each variant's numbers on ``results``."""
    import torch.distributed as dist
    # the process group outlives each init, so a variant with topology
    # knobs re-inits on it
    join_store_world(rank, world, ports, device)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel import distributed as D
    from horovod_tpu_torch.utils import tree as tree_util
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    topo = None
    for variant in variants:
        for k, v in variant.get("knobs", {}).items():
            knobs.set_override(k, v)
        want = {k: v for k, v in variant.get("knobs", {}).items()
                if k in TOPOLOGY_KNOBS}
        if want != topo:
            if htt.is_initialized():
                htt.shutdown()
            ctx = htt.init(device=device)
            topo = want
        dev = ctx.device
        state, step, batches, units, unit = dp_variant(
            htt, rank, world, dev, variant, n_steps)
        state, _ = step(state, *batches[0])                # warm-up
        losses, stamps = [], []
        htt.barrier()
        t0 = time.perf_counter()
        for batch in batches[1:-1]:
            state, loss = step(state, *batch)
            losses.append(float(loss))                      # synchronizes
            stamps.append(time.perf_counter())
        htt.barrier()
        torch.cuda.synchronize()
        if rank == 0:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                tp = time.perf_counter()
                state, loss = step(state, *batches[-1])
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - tp) * 1e3
            overlap = nccl_overlap(prof)
        else:
            state, loss = step(state, *batches[-1])
        losses.append(float(loss))
        trace = D.last_wire_trace()
        predicted = (predicted_dcn_bytes(htt, state,
                                         ctx.topology.local_size)
                     if trace["schedule"] == "two_level" else 0)
        for k in variant.get("knobs", {}):
            knobs.clear_override(k)
        leaves = (list(state.params.parameters())
                  if isinstance(state.params, torch.nn.Module)
                  else tree_util.tree_leaves(state.params))
        bitwise = (same_on_every_rank(C, leaves)
                   if variant["model"] in ZOO else None)
        total = sum(float(t.detach().double().sum()) for t in leaves)
        lo = htt.allreduce(torch.tensor([total], dtype=torch.float64,
                                        device=dev), htt.Min)
        hi = htt.allreduce(torch.tensor([total], dtype=torch.float64,
                                        device=dev), htt.Max)
        if rank == 0:
            step_s = np.diff([t0] + stamps)
            results.put({
                "variant": variant["label"], "world": world,
                "losses": losses,
                "step_ms": [float(x) * 1e3 for x in step_s],
                "step_ms_mean": float(step_s.mean()) * 1e3,
                f"{unit}_per_s": units / float(step_s.mean()),
                "profiled_step_ms": prof_ms, **overlap,
                "sync_buckets": trace["n_buckets"],
                "wire_bytes": trace["wire_bytes"],
                "logical_bytes": trace["logical_bytes"],
                "schedule": trace["schedule"],
                "dcn_wire_bytes": trace["dcn_wire_bytes"],
                "dcn_wire_bytes_predicted": predicted,
                "mesh": ctx.topology.mesh.shape,
                "params_equal_across_ranks": float(lo) == float(hi),
                "params_bitwise_equal": bitwise})
        del state, step, batches
        if device == "cuda":
            torch.cuda.empty_cache()
    htt.shutdown()
    dist.destroy_process_group()


def run_world(world, variants, **kw):
    """``dp_rank`` in ``world`` spawned processes; rank 0's results, one
    per variant."""
    out = spawn_world(dp_rank, world, len(variants), 900, variants, **kw)
    return {r["variant"]: r for r in out}


def predicted_dcn_bytes(htt, state, local: int) -> int:
    """What the two-level schedule predicts each rank's DCN stage carries
    over a step: per bucket and dtype, 1/local of its elements (rounded
    up) in the wire dtype, plus a 4-byte scale on the fp8 tiers. The plan
    is the step's own (the same knobs, leaves and sync axes)."""
    from horovod_tpu_torch.models import transformer as tfm
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                               sync_axes=tfm.grad_sync_axes(cfg))
    _, leaves, sync = da._sync(state.params)
    total = 0
    for _, idxs in sync.buckets:
        by_dtype = {}
        for i in idxs:
            by_dtype[leaves[i].dtype] = (by_dtype.get(leaves[i].dtype, 0)
                                         + leaves[i].numel())
        for dtype, n in by_dtype.items():
            chunk = -(-n // local)
            codec = sync.codec
            if codec is not None and codec.compresses(dtype):
                total += chunk * codec.wire_itemsize + (4 if codec.scaled
                                                        else 0)
            else:
                total += chunk * dtype.itemsize
    return total


# Knobs read by init: a variant that sets one re-inits on the world.
TOPOLOGY_KNOBS = ("HOROVOD_DCN_VIRTUAL_SLICES", "HOROVOD_DCN_MESH",
                  "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_TORUS_ALLREDUCE",
                  "HOROVOD_TPU_MESH_SHAPE", "HOROVOD_TPU_MESH_AXES")
# The two-level tier's variants: the flagship through the bucketed sync
# (make_transformer_train_step_fused, the path that carries the wire tier;
# the unfused step's sync is one plain allreduce per dtype, as the JAX
# package's sync_gradients is) on (hvd_dcn 2, hvd_local N/2), against the
# flat "fused transformer none" of the same world.
DCN_KNOBS = {"HOROVOD_DCN_VIRTUAL_SLICES": 2,
             "HOROVOD_DCN_SCHEDULE": "two_level"}

# The --data-parallel variants: the unfused flagship and bucketed ResNet-50
# (one card as the yardstick, then N), then, on N cards only, ResNet-50 with
# one bucket after the backward, the fused flagship at tier none and
# fp8_e4m3, and the fused flagship through the two-level tier at both.
DP_YARDSTICK = [
    dict(label="transformer", model="transformer"),
    dict(label="resnet bucketed", model="resnet")]
DP_VARIANTS = DP_YARDSTICK + [
    dict(label="resnet one bucket", model="resnet",
         knobs={"HOROVOD_GRADIENT_BUCKET_BYTES": 0}),
    dict(label="fused transformer none", model="fused",
         knobs={"HOROVOD_GRADIENT_COMPRESSION": "none"}),
    dict(label="fused transformer fp8_e4m3", model="fused",
         knobs={"HOROVOD_GRADIENT_COMPRESSION": "fp8_e4m3"}),
    dict(label="fused transformer dcn2 two_level none", model="fused",
         knobs={**DCN_KNOBS, "HOROVOD_GRADIENT_COMPRESSION": "none"}),
    dict(label="fused transformer dcn2 two_level fp8_e4m3", model="fused",
         knobs={**DCN_KNOBS, "HOROVOD_GRADIENT_COMPRESSION": "fp8_e4m3",
                "HOROVOD_GRADIENT_ERROR_FEEDBACK": "1"})]


def data_parallel(n: int, card: str, **kw) -> None:
    """Every variant on ``n`` cards, the yardsticks on one card first; one
    ``data parallel <variant>:`` line each."""
    one = run_world(1, DP_YARDSTICK, **kw)
    many = run_world(n, DP_VARIANTS, **kw)
    for label, res in many.items():
        for r in ([res, one[label]] if label in one else [res]):
            if not (r["params_equal_across_ranks"]
                    and all(np.isfinite(x) for x in r["losses"])):
                raise AssertionError(f"data-parallel run failed: {r}")
        line = {"n_cards": res, "card": card}
        if "two_level" in label:
            check_two_level_variant(label, res, many)
        if label in one:
            unit = "tokens" if "transformer" in label else "images"
            line["one_card"] = one[label]
            res["scaling_efficiency"] = res[f"{unit}_per_s"] / (
                n * one[label][f"{unit}_per_s"])
        log(f"data parallel {label}: " + json.dumps(line))


def check_two_level_variant(label, res, many) -> None:
    """A two-level variant ran the tier, its DCN stage carried what the
    schedule predicts, and at tier none its losses stay within
    FUSED_LOSS_REL_TOL of the flat variant's in the same world."""
    if res["schedule"] != "two_level" or res["dcn_wire_bytes"] != \
            res["dcn_wire_bytes_predicted"] or not res["dcn_wire_bytes"]:
        raise AssertionError(f"{label}: the tier did not run as planned: "
                             f"{res}")
    if label.endswith("none"):
        flat = many["fused transformer none"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], flat))
        res["max_rel_loss_diff_vs_flat"] = rel
        if rel > FUSED_LOSS_REL_TOL:
            raise AssertionError(f"{label}: losses {res['losses']} differ "
                                 f"from the flat schedule's {flat} by {rel}")


# ---------------------------------------------------------------------------
# Horovod's PyTorch API: phase 7 (one card) and the N-card world
# ---------------------------------------------------------------------------

API_BATCHES = [3, 3, 3, 2]      # the uneven epoch's batches per rank
# The combined delta against a plain f64 Adasum of the gathered deltas,
# per leaf: ADASUM_REL_TOL of the reference's largest value (f32 dot
# products over up to 2M elements), plus two f32 ulps of the largest
# parameter (a local delta is read as new - old after the inner step, the
# combined one as new - old after the write-back, and each new was
# rounded to f32).
ADASUM_REL_TOL = 1e-4
# Averaged gradients (an f32 sum of three ranks, divided) against the f64
# mean, of each leaf's largest value.
API_MEAN_REL_TOL = 1e-6
# SyncBatchNorm (bf16 in and out, statistics in f32 as E[x^2] - mean^2)
# against a plain f32 batch norm over the gathered batch (two-pass
# variance): y and dx within two bf16 ulps of their largest value, the
# running statistics within 1e-4 of theirs.
SYNC_BN_REL_TOL = {"y": 2 ** -7, "dx": 2 ** -7, "stats": 1e-4}
SYNC_BN_SHAPE = (RESNET_B, 56, 56, 256)   # ResNet-50's stage 1, per card


def same_on_every_rank(C, tensors) -> bool:
    """True when every rank holds the same bits in ``tensors``: the bytes,
    as int32 words, equal their MIN and their MAX over the ranks (the
    join registry is not read)."""
    buf = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                     for t in tensors])
    pad = (-buf.numel()) % 4
    if pad:
        buf = torch.cat([buf, buf.new_zeros(pad)])
    words = buf.view(torch.int32)
    return bool(torch.equal(C.allreduce(words, C.ReduceOp.MIN), words)
                and torch.equal(C.allreduce(words, C.ReduceOp.MAX), words))


def plain_pairwise(a, b):
    dot, na, nb = torch.dot(a, b), torch.dot(a, a), torch.dot(b, b)
    ca = 1 - dot / (2 * na) if na > 0 else 1.0
    cb = 1 - dot / (2 * nb) if nb > 0 else 1.0
    return ca * a + cb * b


def plain_adasum(rows):
    """The XOR butterfly over the list ``rows`` (f64 vectors), plainly."""
    vals, d = list(rows), 1
    while d < len(vals):
        vals = [plain_pairwise(vals[min(r, r ^ d)], vals[max(r, r ^ d)])
                for r in range(len(vals))]
        d *= 2
    return vals[0]


def api_batch(dev, step, rank, batch, image):
    """Rank ``rank``'s synthetic images and labels of ``step``."""
    gen = torch.Generator(device=dev).manual_seed(1000 * step + rank)
    return (torch.rand((batch, image, image, 3), generator=gen, device=dev
                       ).to(torch.bfloat16),
            torch.randint(0, 1000, (batch,), generator=gen, device=dev))


def check_launches(cb, dev, what) -> dict:
    """Each conv+BN kernel launched at least RESNET50_CONVS times since the
    counts were reset (on the card; the CPU takes the plain versions)."""
    got = {k: cb.LAUNCHES[k] for k in ("conv_bn_fwd", "conv_bn_bwd")}
    if dev.type == "cuda" and min(got.values()) < RESNET50_CONVS:
        raise AssertionError(f"{what}: conv+BN launches {got}, expected >= "
                             f"{RESNET50_CONVS} each")
    return got


def leaf_errors(got, ref, rel, floor=None):
    """The largest |got - ref| over the leaves and its largest share of
    each leaf's limit, ``rel`` of the leaf's largest reference value plus
    ``floor[i]``."""
    err = share = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        e = float((g.double() - r).abs().max())
        lim = rel * float(r.abs().max()) + (floor[i] if floor else 0) + 1e-30
        err, share = max(err, e), max(share, e / lim)
    return err, share


def api_adasum_steps(htt, C, cb, D, model, sgd, rank, world, dev, sync,
                     batch, image, out):
    """Three steps through DistributedAdasumOptimizer, the first held to
    a plain f64 Adasum of the gathered local deltas; one step of
    DistributedOptimizer(op=Adasum); three of op=Average beside them."""
    import copy
    params = list(model.parameters())
    aopt = htt.DistributedAdasumOptimizer(sgd, axis="hvd")
    step_ms, launches, local, start = [], [], None, None
    for step in range(3):
        x, y = api_batch(dev, 10 + step, rank, batch, image)
        cb.reset_launches()
        sync()
        t0 = time.perf_counter()
        resnet_loss(model, x, y).backward()
        if step == 0:
            # the local deltas: the inner step alone, then undone
            start = [p.detach().clone() for p in params]
            saved = copy.deepcopy(sgd.state_dict())
            sgd.step()
            local = [p.detach().float() - s.float()
                     for p, s in zip(params, start)]
            with torch.no_grad():
                for p, s in zip(params, start):
                    p.copy_(s)
            sgd.load_state_dict(saved)
            sync()
            t0 = time.perf_counter()
        aopt.step()
        aopt.zero_grad()
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(check_launches(cb, dev, f"adasum step {step}"))
        if not same_on_every_rank(C, params):
            raise AssertionError(f"adasum step {step}: parameters differ "
                                 f"between ranks")
        if step == 0:
            combined = [p.detach().float() - s.float()
                        for p, s in zip(params, start)]
            refs = [plain_adasum(list(C.allgather(d.reshape(1, -1)).double()))
                    for d in local]
            err, share = leaf_errors(
                [c.reshape(-1) for c in combined], refs, ADASUM_REL_TOL,
                [float(s.abs().max()) * 2 ** -22 for s in start])
            out["adasum_step1_max_abs_err"] = err
            out["adasum_step1_share_of_limit"] = share
            if share > 1:
                raise AssertionError(f"adasum step 1: combined delta off "
                                     f"the plain f64 Adasum by {err} "
                                     f"({share} of the limit)")
    comb_ms = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        D._sync_leaves(local, ("hvd",), htt.Adasum, None)
        sync()
        comb_ms.append((time.perf_counter() - t0) * 1e3)
    out.update(adasum_step_ms=step_ms, adasum_launches=launches,
               adasum_combination_ms=comb_ms,
               adasum_leaves=len(params))
    # the delta optimizer leaves each rank's momentum its own
    htt.broadcast_optimizer_state(sgd, root_rank=0)
    for label, op, n in (("adasum_sync", htt.Adasum, 1),
                         ("average", htt.Average, 3)):
        dopt = htt.DistributedOptimizer(sgd, op=op)
        ms = []
        for step in range(n):
            x, y = api_batch(dev, 20 + step, rank, batch, image)
            cb.reset_launches()
            sync()
            t0 = time.perf_counter()
            resnet_loss(model, x, y).backward()
            dopt.step()
            dopt.zero_grad()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            check_launches(cb, dev, f"{label} step {step}")
            if not same_on_every_rank(C, params):
                raise AssertionError(f"{label} step {step}: parameters "
                                     f"differ between ranks")
        dopt._launcher.remove_hooks()
        out[f"{label}_step_ms"] = ms
    mean_s = float(np.mean(step_ms[1:])) / 1e3
    out["adasum_images_per_s"] = batch * world / mean_s
    out["average_images_per_s"] = batch * world / (
        float(np.mean(out["average_step_ms"][1:])) / 1e3)


def api_hierarchical_join(htt, C, model, sgd, rank, world, dev, batch,
                          image, out):
    """One Adasum step on (cross 2, local N/2) with rank N-1 joined: each
    rank's local delta combined leaf by leaf by ``allreduce(op=Adasum)``,
    held to the active-count rule computed plainly from the gathered
    deltas, then applied."""
    htt.shutdown()
    ctx = htt.init(device=dev, mesh_shape=(2, world // 2))
    if tuple(ctx.topology.flat_axes) != ("hvd_cross", "hvd_local"):
        raise AssertionError(f"mesh {ctx.topology.flat_axes}")
    params = list(model.parameters())
    x, y = api_batch(dev, 30, rank, batch, image)
    resnet_loss(model, x, y).backward()
    start = [p.detach().clone() for p in params]
    sgd.step()
    sgd.zero_grad()
    deltas = [p.detach().float() - s.float() for p, s in zip(params, start)]
    joined = world - 1
    if htt.join(joined) != -1:
        raise AssertionError("join returned before every rank joined")
    combined = [htt.allreduce(d, op=htt.Adasum) for d in deltas]
    last = htt.join()
    with torch.no_grad():
        for p, s, c in zip(params, start, combined):
            p.copy_((s.float() + c).to(p.dtype))
    local = world // 2
    refs = []
    for d in deltas:
        rows = C.allgather(d.reshape(1, -1)).double()
        means = []
        for g in range(2):
            act = [r for r in range(g * local, (g + 1) * local)
                   if r != joined]
            means.append(rows[act].sum(0) / max(len(act), 1))
        refs.append(plain_pairwise(means[0], means[1]))
    err, share = leaf_errors([c.reshape(-1) for c in combined], refs,
                             ADASUM_REL_TOL)
    if share > 1 or last != world - 2 or not same_on_every_rank(C, params):
        raise AssertionError(f"hierarchical adasum with rank {joined} "
                             f"joined: err {err} ({share} of the limit), "
                             f"join() {last}")
    out.update(hier_join_max_abs_err=err, hier_join_share_of_limit=share,
               hier_join_last=last, hier_mesh=ctx.topology.mesh.shape)
    htt.shutdown()
    htt.init(device=dev)


def api_uneven_epoch(htt, C, cb, model, sgd, rank, world, dev, sync, batch,
                     image, out):
    """The uneven epoch as a Horovod script writes it: forward, backward,
    grouped_allreduce_async of the gradients (Average), poll, synchronize,
    SGD; the ranks out of data join before the step they lack; the
    closing join() returns the last rank to join, and the next allreduce
    averages over everyone."""
    params = list(model.parameters())
    htt.broadcast_optimizer_state(sgd, root_rank=0)   # momentum was local
    waits, polled = [], []
    for step in range(max(API_BATCHES)):
        for r in range(world):
            if API_BATCHES[r % len(API_BATCHES)] == step and \
                    htt.join(r) != -1:
                raise AssertionError("join returned early")
        cb.reset_launches()
        if API_BATCHES[rank % len(API_BATCHES)] > step:
            x, y = api_batch(dev, 40 + step, rank, batch, image)
            resnet_loss(model, x, y).backward()
            check_launches(cb, dev, f"uneven epoch step {step}")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        h = htt.grouped_allreduce_async(grads, op=htt.Average)
        polled.append(htt.poll(h))
        t0 = time.perf_counter()
        avg = htt.synchronize(h)
        waits.append((time.perf_counter() - t0) * 1e3)
        if step == max(API_BATCHES) - 1:
            active = [r for r in range(world)
                      if API_BATCHES[r % len(API_BATCHES)] > step]
            refs = [C.allgather(g.reshape(1, -1)).double()[active].mean(0)
                    for g in grads]
            err, share = leaf_errors([a.reshape(-1) for a in avg], refs,
                                     API_MEAN_REL_TOL)
            out.update(uneven_last_step_max_abs_err=err,
                       uneven_last_step_share_of_limit=share)
            if share > 1:
                raise AssertionError(f"uneven epoch: averaged gradients off "
                                     f"the mean over {active} by {err}")
        for p, g in zip(params, avg):
            p.grad = g
        sgd.step()
        sgd.zero_grad()
        if not same_on_every_rank(C, params):
            raise AssertionError(f"uneven epoch step {step}: parameters "
                                 f"differ between ranks")
    last = htt.join()
    everyone = float(htt.allreduce(torch.tensor([float(rank)], device=dev),
                                   htt.Average))
    if last != world - 2 or everyone != (world - 1) / 2:
        raise AssertionError(f"join() returned {last}, the next allreduce "
                             f"{everyone}")
    from horovod_tpu_torch import metrics as M
    hist = M.get_registry().get("hvd_handle_wait_seconds")
    out.update(uneven_join_last=last, uneven_next_average=everyone,
               handle_wait_ms=waits, handle_polled_before_wait=polled,
               hvd_handle_wait_seconds_sum=hist.total_sum)


def api_sync_bn(htt, C, rank, dev, sync, shape, out):
    """SyncBatchNorm's forward, backward and running statistics against a
    plain f32 batch norm over the gathered batch; then its warm time
    beside torch's batch norm of this rank's rows."""
    gen = torch.Generator(device=dev).manual_seed(50 + rank)
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(
        torch.bfloat16).requires_grad_()
    cot = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    bn = htt.SyncBatchNorm(shape[-1], device=dev)
    sync()
    t0 = time.perf_counter()
    y = bn(x)
    y.backward(cot)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    xf = C.allgather(x.detach()).float().requires_grad_()
    dims = tuple(range(xf.dim() - 1))
    mean, var = xf.mean(dims), xf.var(dims, unbiased=False)
    yp = (xf - mean) * torch.rsqrt(var + bn.epsilon)
    yp.backward(C.allgather(cot).float())
    rows = slice(rank * shape[0], (rank + 1) * shape[0])
    yp, dxp = yp.detach(), xf.grad
    errs = {}
    for name, got, ref in (("y", y.detach(), yp[rows]), ("dx", x.grad,
                                                          dxp[rows]),
                           ("mean", bn.mean, 0.1 * mean.detach()),
                           ("var", bn.var, 0.9 + 0.1 * var.detach())):
        e = float((got.float() - ref).abs().max())
        lim = SYNC_BN_REL_TOL.get(name, SYNC_BN_REL_TOL["stats"]) * float(
            ref.abs().max())
        errs[name] = [e, e / lim]
        if e > lim:
            raise AssertionError(f"SyncBatchNorm {name}: {e} > {lim}")
    # warm: three more forward+backward passes, beside torch's batch norm
    # of this rank's rows alone (no communication) on the same bytes
    bn2 = htt.SyncBatchNorm(shape[-1], device=dev)
    xl = x.detach().permute(0, 3, 1, 2).requires_grad_()
    w = torch.ones(shape[-1], device=dev, requires_grad=True)
    warm = {"sync_bn": [], "local_batch_norm": []}
    for name, fn in (("sync_bn", lambda: bn2(x).backward(cot)),
                     ("local_batch_norm", lambda: torch.nn.functional.
                      batch_norm(xl, None, None, w, None, training=True)
                      .backward(cot.permute(0, 3, 1, 2)))):
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            warm[name].append((time.perf_counter() - t0) * 1e3)
    out.update(sync_bn_shape=list(shape), sync_bn_fwd_bwd_ms=ms,
               sync_bn_warm_fwd_bwd_ms=warm, sync_bn_err_and_share=errs)


def api_async_cases(htt, rank, world, dev, sync, big_bytes, out):
    """Every ``*_async`` collective, at a small odd size and at
    ``big_bytes`` a rank, on integer values, bitwise equal to its
    synchronous form; allgather, alltoall and reducescatter also on the
    ragged set [0, 1, 2] (in a world of one, the set [0])."""
    ps = htt.add_process_set(list(range(min(3, world))))
    checked = []
    for big in (False, True):
        cols = 1024 if big else 3
        rows = big_bytes // (4 * cols) if big else 251
        gen = torch.Generator(device=dev).manual_seed(60 + rank + 10 * big)
        x = _int_valued(gen, (rows, cols), dev)
        split = [rows // world + (1 if d < rows % world else 0)
                 for d in range(world)]
        even = x[:rows - rows % world]
        cases = [
            ("allreduce", "allreduce", (x, htt.Sum), {}),
            ("grouped_allreduce", "grouped_allreduce",
             ([x, x[:7].double()], htt.Sum), {}),
            ("allgather", "allgather", (x,), {}),
            ("allgather_uneven", "allgather", (x[:rows - rank],), {}),
            ("broadcast", "broadcast", (x, world - 1), {}),
            ("alltoall", "alltoall", (even,), {}),
            ("alltoall_splits", "alltoall", (x,), {"splits": split}),
            ("reducescatter", "reducescatter", (x, htt.Sum), {}),
            ("allgather_set012", "allgather", (x,), {"process_set": ps}),
            ("alltoall_set012", "alltoall", (x[:rows - rows % 3],),
             {"process_set": ps}),
            ("reducescatter_set012", "reducescatter", (x, htt.Sum),
             {"process_set": ps})]
        for name, fn, args, kw in cases:
            h = getattr(htt, fn + "_async")(*args, **kw)
            got = htt.synchronize(h)
            ref = getattr(htt, fn)(*args, **kw)
            got = got if isinstance(got, (list, tuple)) else [got]
            ref = ref if isinstance(ref, (list, tuple)) else [ref]
            if not (htt.poll(h) and len(got) == len(ref) and all(
                    torch.equal(g, r) for g, r in zip(got, ref))):
                raise AssertionError(f"{name} (big={big}): the async form "
                                     f"differs from the synchronous one")
            checked.append(f"{name}{'_big' if big else '_small'}")
    sync()
    out["async_equal_to_sync"] = checked


def api_rank(rank, world, ports, results, device="cuda", batch=RESNET_B,
             image=224, bn_shape=SYNC_BN_SHAPE, big_bytes=COLL_BIG_BYTES):
    """One rank of the N-card Horovod API world; rank 0 puts its numbers
    on ``results``. Every check raises on the rank that fails it."""
    import torch.distributed as dist
    join_store_world(rank, world, ports, device)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.parallel import distributed as D
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = htt.init(device=device)
    dev = ctx.device
    sync = (torch.cuda.synchronize if dev.type == "cuda" else
            (lambda: None))
    out = {"world": world, "batch_per_rank": batch, "image": image}
    t0 = time.perf_counter()
    # 1. the start of a Horovod script: own weights, a local step, then
    # rank 0's parameters, buffers and momentum everywhere
    model = htt.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         fused_conv_bn=True, device=dev, seed=rank)
    sgd = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    x, y = api_batch(dev, 0, rank, batch, image)
    resnet_loss(model, x, y).backward()
    sgd.step()
    sgd.zero_grad()
    htt.broadcast_parameters(model, root_rank=0)
    htt.broadcast_optimizer_state(sgd, root_rank=0)
    state = (list(model.parameters()) + list(model.buffers())
             + [sgd.state[p]["momentum_buffer"] for p in model.parameters()])
    obj = htt.broadcast_object({"epochs": 90, "from": rank}, root_rank=0)
    counts = htt.allgather_object(API_BATCHES[rank % len(API_BATCHES)])
    if not (same_on_every_rank(C, state) and obj == {"epochs": 90, "from": 0}
            and counts == [API_BATCHES[r % len(API_BATCHES)]
                           for r in range(world)]):
        raise AssertionError(f"broadcast: state, {obj} or {counts} differ")
    out["broadcast_tensors"] = len(state)
    # 2. Adasum (the delta optimizer, then op=Adasum), Average beside it
    api_adasum_steps(htt, C, cb, D, model, sgd, rank, world, dev, sync,
                     batch, image, out)
    # 3. hierarchical Adasum with a rank joined
    api_hierarchical_join(htt, C, model, sgd, rank, world, dev, batch,
                          image, out)
    # 4. the uneven epoch on the eager API
    api_uneven_epoch(htt, C, cb, model, sgd, rank, world, dev, sync, batch,
                     image, out)
    del model, sgd, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # 5. SyncBatchNorm at ResNet-50's stage-1 shape
    api_sync_bn(htt, C, rank, dev, sync, bn_shape, out)
    # 6. the async forms against the synchronous ones
    api_async_cases(htt, rank, world, dev, sync, big_bytes, out)
    out["seconds"] = time.perf_counter() - t0
    if rank == 0:
        results.put(out)
    htt.shutdown()
    dist.destroy_process_group()


def horovod_api_world(n, card, **kw) -> None:
    """``api_rank`` in ``n`` spawned processes; the ``horovod api data
    parallel:`` line."""
    (out,) = spawn_world(api_rank, n, 1, 900, **kw)
    out["card"] = card
    log("horovod api data parallel: " + json.dumps(out))


def horovod_api_world_one(htt, card, dev="cuda") -> None:
    """Phase 7: the same API in a world of one: every ``*_async`` form
    against its synchronous one, ``join()`` (0), Adasum (the identity),
    DistributedAdasumOptimizer against its inner SGD, SyncBatchNorm
    against batch norm, and the object broadcasts."""
    t0 = time.perf_counter()
    ctx = htt.init(device=dev)
    try:
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        out = {"backend": ctx.backend}
        api_async_cases(htt, 0, 1, ctx.device, sync, 1 << 20, out)
        g = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn(5, 3, generator=g, device=dev)
        checks = {"join": htt.join() == 0,
                  "adasum_identity": torch.equal(
                      htt.allreduce(x, op=htt.Adasum), x),
                  "broadcast_object": htt.broadcast_object({"a": 1}) ==
                  {"a": 1},
                  "allgather_object": htt.allgather_object(3) == [3]}
        torch.manual_seed(0)
        models = [torch.nn.Linear(16, 4).to(dev) for _ in range(2)]
        models[1].load_state_dict(models[0].state_dict())
        opts = [torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
                for m in models]
        opts[1] = htt.DistributedAdasumOptimizer(opts[1], axis="hvd")
        for _ in range(2):
            for m, o in zip(models, opts):
                m(x.repeat(1, 16)[:, :16]).square().sum().backward()
                o.step()
                o.zero_grad()
        checks["adasum_optimizer_equals_inner"] = all(
            torch.equal(a, b) for a, b in zip(models[0].parameters(),
                                              models[1].parameters()))
        htt.broadcast_optimizer_state(opts[1], 0)
        xb = torch.randn(8, 6, 6, 32, generator=g, device=dev)
        bn = htt.SyncBatchNorm(32, device=dev)
        yb = bn(xb).detach()
        ref = torch.nn.functional.batch_norm(
            xb.permute(0, 3, 1, 2), None, None, training=True,
            eps=bn.epsilon).permute(0, 2, 3, 1)
        out["sync_bn_max_abs_err"] = float((yb - ref).abs().max())
        checks["sync_bn_equals_batch_norm"] = out["sync_bn_max_abs_err"] \
            < 1e-4
        sync()
    finally:
        htt.shutdown()
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"horovod api (world 1): {bad} failed")
    out.update(checked=sorted(checks), seconds=time.perf_counter() - t0,
               card=card)
    log("horovod api (world 1): " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 8: the launcher and elastic training (hvdrun-torch)
# ---------------------------------------------------------------------------

# The launched workers are this file itself (``chip_smoke.py --worker
# <name> <spec.json>``), so nothing launched imports more than the port.
HERE = os.path.dirname(os.path.abspath(__file__))
LAUNCH_ROOT = os.path.join(HERE, "build", "launcher")
LAUNCH_S = 300              # one launch's deadline
# The elastic ResNet-50 drill: images per card and step, the synthetic set
# (16 x 512 images, each made on the card from a seed of its index), the
# fused flagship's depth in the resize drill (full width) and the step its
# host is lost at.
ELASTIC_IMAGES = 16 * 512
ELASTIC_ONE_IMAGES = 8 * RESNET_B
RESIZE_LAYERS = 4
RESIZE_AT, RESIZE_STEPS = 3, 6


def digests(tensors) -> dict:
    """sha256 of every tensor's bytes (``{name: hex}``): two runs are
    bitwise equal exactly when their digests are."""
    import hashlib
    out = {}
    for k, t in sorted(tensors.items()):
        t = t.detach().contiguous().cpu()
        out[k] = hashlib.sha256(
            t.view(torch.uint8).reshape(-1).numpy().tobytes()
            if t.numel() else b"").hexdigest()
    return out


def launch(argv, worker, spec, tag, timeout=LAUNCH_S):
    """Run ``hvdrun-torch <argv> -- python chip_smoke.py --worker <worker>
    <spec>`` in its own session; its output goes to ``<tag>/launcher.log``
    under LAUNCH_ROOT. Returns (exit code, seconds, the log's tail); every
    process of the launch is killed at the deadline."""
    import signal
    d = os.path.join(LAUNCH_ROOT, tag)
    os.makedirs(d, exist_ok=True)
    spec = dict(spec, out=d)
    spec_path = os.path.join(d, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *argv,
           "--", sys.executable, os.path.join(HERE, "chip_smoke.py"),
           "--worker", worker, spec_path]
    log_path = os.path.join(d, "launcher.log")
    t0 = time.perf_counter()
    with open(log_path, "wb") as out:
        p = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                             cwd=HERE, start_new_session=True)
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = 124
        finally:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    with open(log_path, "rb") as f:
        tail = f.read()[-4000:].decode(errors="replace")
    return rc, time.perf_counter() - t0, tail


def worker_records(tag, prefix=""):
    """The JSON records the workers of a launch wrote (``<prefix>*.json``
    under its directory), sorted by name."""
    d = os.path.join(LAUNCH_ROOT, tag)
    out = []
    for name in sorted(os.listdir(d)):
        if name.startswith(prefix) and name.endswith(".json") and \
                name != "spec.json":
            with open(os.path.join(d, name)) as f:
                out.append(json.load(f))
    return out


def write_record(spec, name, rec) -> None:
    path = os.path.join(spec["out"], name)
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)


class FromCommitted:
    """Batches from the newest step committed in ``directory`` on, which
    is the step ``train_loop`` has just restored when it iterates."""

    def __init__(self, batches, directory):
        self.batches, self.directory = batches, directory

    def __iter__(self):
        from horovod_tpu_torch.resilience import latest_committed_step
        return iter(self.batches[latest_committed_step(self.directory)
                                 or 0:])


def worker_train(spec) -> int:
    """A launched rank of the resilient loop: the flagship (``fused``: at
    fp8_e4m3 with error feedback) through ``train_loop`` with an
    AsyncCheckpointer at CKPT_INTERVAL over ``spec["ckpt"]``, chaos
    ``preempt_at`` PREEMPT_AT in the first attempt when ``preempt``;
    feeds its rows of the same batches as ``resilient_train``/
    ``resilient_rank``. Writes ``attempt<a>-rank<r>.json`` (info, times,
    and on completion the digests of the parameters, momentum and
    residual) and exits with the loop's exit code (75 when preempted)."""
    t_entry = time.time()
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.callbacks import StepStats
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.resilience import (AsyncCheckpointer,
                                              PreemptionHandler, chaos)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attempt = int(os.environ["HVD_RESUME_ATTEMPT"])
    fused = spec["fused"]
    if fused:
        knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    ctx = htt.init()
    dev, rank, world = ctx.device, htt.rank(), htt.size()
    t_init = time.time()
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp", **spec.get("cfg", {}))
    b, s = spec.get("batch", TRAIN_B), spec.get("seq", TRAIN_S)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = slice(rank * b, (rank + 1) * b)
    batches = [tuple(torch.randint(0, cfg.vocab_size, (b * world, s),
                                   generator=gen, device=dev)[rows]
                     for _ in range(2)) for _ in range(spec["steps"])]
    state, step = resilient_state(htt, cfg, dev, 0, fused)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_state = time.time()
    ck = AsyncCheckpointer(spec["ckpt"], interval=CKPT_INTERVAL,
                           max_to_keep=2)
    if spec.get("preempt"):
        chaos.install({"preempt_at": PREEMPT_AT})
    knobs.set_override("HOROVOD_PREEMPTION_POLL_SECONDS", 0.0)
    handler = PreemptionHandler(checkpointer=ck, margin=0,
                                install_signals=False)
    stamps = []

    def on_step(i, st, loss):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stamps.append(time.time())
        if not np.isfinite(float(loss)):
            raise AssertionError(f"non-finite loss at step {i}")

    before = htt.goodput_report()["phases"]["restart"]
    fa.reset_launches()
    try:
        state, info = htt.train_loop(step, state,
                                     FromCommitted(batches, ck.directory),
                                     checkpointer=ck, preemption=handler,
                                     step_stats=StepStats(),
                                     on_step=on_step)
    finally:
        handler.close()
        ck.close()
        chaos.install(None)
    rec = {"rank": rank, "world": world, "attempt": attempt, "info": info,
           "t_entry": t_entry, "t_init": t_init, "t_state": t_state,
           "t_first_step": stamps[0] if stamps else None,
           "step_ms": [float(x) * 1e3 for x in np.diff(stamps)],
           "restore_s": htt.goodput_report()["phases"]["restart"] - before,
           "flash_launches": dict(fa.LAUNCHES), "card": ctx.device.index}
    if info["status"] == "completed":
        rec["digests"] = digests(state_tensors(htt, state))
    if info["exit_code"]:
        rec["t_exit"] = time.time()
    write_record(spec, f"attempt{attempt}-rank{rank}.json", rec)
    htt.shutdown()
    return info["exit_code"]


def elastic_image(dev, idx):
    """The synthetic set's images and labels at ``idx``: image i is made on
    the card from seed i (bf16 224^2, bench.py's synthetic data), so every
    rank and generation sees the same image for an index."""
    g = torch.Generator(device=dev)
    xs = []
    for i in idx:
        g.manual_seed(int(i))
        xs.append(torch.rand((224, 224, 3), generator=g, device=dev))
    x = torch.stack(xs).to(torch.bfloat16)
    return x, torch.as_tensor([int(i) % 1000 for i in idx], device=dev)


def equal_across_ranks(htt, tensors) -> bool:
    """True when every rank holds the same bits in ``tensors``: the
    elementwise MAX and MIN over the ranks of their 32-bit patterns
    agree."""
    if htt.size() == 1:
        return True
    import torch.distributed as dist
    bits = torch.cat([t.detach().reshape(-1).view(torch.int32)
                      if t.element_size() == 4 else
                      t.detach().reshape(-1).to(torch.float32)
                      .view(torch.int32) for t in tensors])
    hi, lo = bits.clone(), bits.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


def worker_elastic(spec) -> int:
    """A launched elastic rank: ResNet-50 (``fused_conv_bn=True``, RESNET_B
    images a card) through DistributedOptimizer and
    ``data_parallel_train_step``, an ElasticSampler over ``spec["images"]``
    synthetic images (each step records every replica's chunk, so a lost
    rank's progress survives in its peers' snapshots), and
    ``TorchState(model, optimizer, sampler)`` committed every step inside
    ``elastic.run``; one epoch. ``spec["schedule"]`` = {"gen:rank:batch":
    code}: 1 drops this rank's host from the discovery file ``spec
    ["hosts"]`` (the host is gone) and exits before the step, 73 exits
    after the step's commit (a respawn). ``spec["drop"]`` = {"gen:rank:
    batch": host} drops ``host`` from the file after that commit (a
    voluntary shrink). After each commit the ranks agree on a pending
    topology change (a MAX over the world), so all leave at the same step.
    Records (``gen<g>-rank<r>.jsonl``): each committed step's indices
    (this rank's), ms, and whether every rank's parameters and momentum
    are bitwise equal; at a generation's start the card and whether the
    restored state is bitwise this slot's last commit."""
    t_entry = time.time()
    import pickle
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.elastic import worker as ew
    from horovod_tpu_torch.ops import conv_bn as cb
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = htt.init()
    dev = ctx.device
    g = int(os.environ["HVD_ELASTIC_GENERATION"])
    rank, world = htt.rank(), htt.size()
    path = os.path.join(spec["out"], f"gen{g}-rank{rank}.jsonl")

    def rec(r):
        r.update(gen=g, rank=rank, world=world, t=time.time())
        with open(path, "a") as f:
            f.write(json.dumps(r) + "\n")

    props = torch.cuda.get_device_properties(dev) if dev.type == "cuda" \
        else None
    state, step, _ = resnet_step(htt, dev, seed=0)
    model, opt = state.params, state.opt_state
    inner = opt.optimizer
    params = list(model.parameters())
    sampler = elastic.ElasticSampler(dataset_size=spec["images"],
                                     shuffle=True, seed=1)
    est = elastic.TorchState(model=model, optimizer=opt, sampler=sampler,
                             epoch=0)
    rec({"type": "start", "t_entry": t_entry,
         "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
         "card": str(getattr(props, "uuid", "cpu")),
         "host": ew.slot_identity()[0]})
    last_path = est._ckpt_path()
    last = None
    if last_path and os.path.exists(last_path):
        with open(last_path, "rb") as f:
            last = pickle.load(f)

    def drop_host(host):
        with open(spec["hosts"]) as f:
            hosts = [h for h in f.read().split() if h.split(":")[0] != host]
        with open(spec["hosts"], "w") as f:
            f.write("\n".join(hosts) + "\n")

    def agree_on_update():
        pending = 0
        try:
            est.check_host_updates()
        except elastic.HostsUpdatedInterrupt:
            pending = 1
        flag = htt.allreduce(torch.tensor([pending], device=dev), htt.Max)
        if int(flag[0]):
            raise elastic.HostsUpdatedInterrupt(skip_sync=False)

    @elastic.run
    def train(est):
        nonlocal state
        if g > 1:
            # every rank now holds rank 0's restored state: on rank 0 it
            # must be its slot's last commit, bit for bit (the model with
            # its running statistics, and the momentum)
            same = None
            if rank == 0:
                snap = last["arrays"]
                sd = model.state_dict()
                st = inner.state_dict()["state"]
                same = all(torch.equal(sd[k].cpu(), snap["model"][k])
                           for k in sd) and all(
                    torch.equal(st[i]["momentum_buffer"].cpu(),
                                snap["optimizer"]["state"][i]
                                ["momentum_buffer"])
                    for i in snap["optimizer"]["state"])
            rec({"type": "restored", "bitwise_last_commit": same,
                 "equal": equal_across_ranks(htt, params + [
                     inner.state[p]["momentum_buffer"] for p in params]),
                 "processed": len(set(sampler.processed_indices))})
        n_batches = -(-len(sampler) // RESNET_B)
        for b in range(n_batches):
            key = f"{g}:{rank}:{b}"
            code = spec.get("schedule", {}).get(key)
            if code == 1:
                drop_host(ew.slot_identity()[0])
                rec({"type": "crash"})
                os._exit(1)
            idx = [int(i) for i in
                   sampler.indices[b * RESNET_B:(b + 1) * RESNET_B]]
            x, y = elastic_image(dev, idx)
            cb.reset_launches()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, x, y)
            loss = float(loss)
            ms = (time.perf_counter() - t0) * 1e3
            sampler.record_batch(b, RESNET_B)
            equal = equal_across_ranks(htt, params + [
                inner.state[p]["momentum_buffer"] for p in params])
            est.save()
            rec({"type": "step", "batch": b, "idx": idx, "step_ms": ms,
                 "loss": loss, "equal": equal,
                 "conv_bn_fwd": cb.LAUNCHES.get("conv_bn_fwd", 0)})
            if code == 73:
                rec({"type": "restart"})
                sys.stdout.flush()
                os._exit(73)
            drop = spec.get("drop", {}).get(key)
            if drop:
                drop_host(drop)
            agree_on_update()
        rec({"type": "done"})

    train(est)
    htt.shutdown()
    return 0


def rebind_fused(htt, cfg, dev, state):
    """The fused flagship step built on the current world for a live
    ``state``: the step of the old world holds that world's process
    groups (and its hooks on the parameters go with it)."""
    import gc
    from horovod_tpu_torch.models import transformer as tfm
    gc.collect()
    da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                               sync_axes=tfm.grad_sync_axes(cfg))
    init_fn, step = htt.make_transformer_train_step_fused(cfg, da,
                                                          device=dev)
    fresh = init_fn(state.params)
    return fresh._replace(step=state.step, opt_state=state.opt_state), step


def resize_batch(cfg, dev, i, rank, world):
    """Step ``i``'s rows of ``rank``: TRAIN_B sequences a card of a global
    batch made on the card from seed 1000 + i."""
    gen = torch.Generator(device=dev).manual_seed(1000 + i)
    rows = slice(rank * TRAIN_B, (rank + 1) * TRAIN_B)
    return tuple(torch.randint(0, cfg.vocab_size, (TRAIN_B * world,
                                                   TRAIN_S),
                               generator=gen, device=dev)[rows]
                 for _ in range(2))


def worker_resize(spec) -> int:
    """A launched rank of the live resize: the fused flagship at
    fp8_e4m3 with error feedback (full width, RESIZE_LAYERS layers).
    ``live`` (4 ranks = 2 hosts of 2): chaos ``host_loss`` of host 1 at
    RESIZE_AT (margin 0) through a ResizeCoordinator; ranks 2-3 snapshot
    and leave, 0-1 rebuild the step on the two-rank world and go on to
    RESIZE_STEPS. ``cold`` (2 ranks): the state restored from the
    committed snapshot and plan (``restore_resized``), then the same
    steps. Writes ``<mode>-rank<r>.json`` with the digests."""
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.resilience import AsyncCheckpointer, chaos
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    knobs.set_override("HOROVOD_ELASTIC_RESIZE_MARGIN", 0)
    ctx = htt.init()
    dev, mode = ctx.device, spec["mode"]
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp", n_layers=spec["layers"])
    state, step = flagship_fused_step(htt, cfg, dev, seed=0)
    ck = AsyncCheckpointer(spec["ckpt"], interval=0)
    rec = {"mode": mode, "rank0": htt.rank(), "world0": htt.size()}
    start = 0
    try:
        if mode == "cold":
            start, state = elastic.restore_resized(spec["ckpt"], state)
            rec["restored_step"] = start
        else:
            rc = elastic.ResizeCoordinator(checkpointer=ck, host_size=2)
            chaos.install({"host_loss": {"host": 1, "at_step": RESIZE_AT}})
        for i in range(start, spec["steps"]):
            if mode == "live":
                rc.poll(i)
                if rc.check(i):
                    t0 = time.perf_counter()
                    state = rc.resize(i, state)
                    if state is elastic.LEFT:
                        rec.update(left_at=i, seconds=time.perf_counter()
                                   - t0)
                        write_record(spec, f"left-rank{rec['rank0']}.json",
                                     rec)
                        return 0
                    del step
                    state, step = rebind_fused(htt, cfg, dev, state)
                    h = M.histogram("hvd_elastic_resize_seconds")
                    rec.update(resized_at=i, world=htt.size(),
                               rank=htt.rank(),
                               resize_seconds=h.total_sum,
                               resize_count=h.total_count,
                               wall_s=time.perf_counter() - t0,
                               plan=elastic.load_plan(spec["ckpt"], i)
                               .to_json())
            state, loss = step(state, *resize_batch(cfg, dev, i, htt.rank(),
                                                    htt.size()))
            if not np.isfinite(float(loss)):
                raise AssertionError(f"non-finite loss at step {i}")
        rec["digests"] = digests(state_tensors(htt, state))
        rec.setdefault("rank", htt.rank())
        write_record(spec, f"{mode}-rank{htt.rank()}.json", rec)
    finally:
        chaos.install(None)
        ck.close()
        if htt.is_initialized():
            htt.shutdown()
    return 0


WORKERS = {"train": worker_train, "elastic": worker_elastic,
           "resize": worker_resize}


def worker_main(name, spec_path) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    return WORKERS[name](spec)


def check_launch(what, rc, tail, want=0):
    if rc != want:
        raise AssertionError(f"{what}: hvdrun-torch exited {rc} (want "
                             f"{want}); its log ends:\n{tail}")


def launched_train(n, card, ref=None, layers=None):
    """``hvdrun-torch -np n --auto-resume 1 --ckpt-dir D``: the flagship
    (fused at fp8 with error feedback on several cards) preempted at step
    PREEMPT_AT by chaos ``preempt_at`` (exit 75), relaunched with
    HVD_RESUME_ATTEMPT=1, restored at PREEMPT_AT and run to the end.
    ``ref``: the digests the uninterrupted run must reach (rank order);
    None runs the uninterrupted launch first. Returns the line's dict."""
    import shutil
    fused = n > 1
    tag = f"train{n}"
    ckpt = os.path.join(LAUNCH_ROOT, tag, "ckpt")
    shutil.rmtree(os.path.join(LAUNCH_ROOT, tag), ignore_errors=True)
    spec = {"fused": fused, "steps": 5, "ckpt": ckpt}
    if layers:
        spec["cfg"] = {"n_layers": layers}
    out = {"n_cards": n, "model": "flagship TransformerLM" +
           (" fused, fp8_e4m3, error feedback" if fused else ""),
           "steps": 5, "interval": CKPT_INTERVAL, "preempt_at": PREEMPT_AT}
    if ref is None:
        rc, sec, tail = launch(["-np", str(n), "--ckpt-dir", ckpt + "-u"],
                               "train", dict(spec, ckpt=ckpt + "-u"),
                               tag + "/uninterrupted")
        check_launch("uninterrupted launch", rc, tail)
        ref = [r["digests"] for r in sorted(
            worker_records(tag + "/uninterrupted", "attempt0"),
            key=lambda r: r["rank"])]
        out["uninterrupted_s"] = sec
    rc, sec, tail = launch(["-np", str(n), "--auto-resume", "1",
                            "--ckpt-dir", ckpt], "train",
                           dict(spec, preempt=True), tag + "/preempted")
    check_launch("preempted launch", rc, tail)
    a0 = sorted(worker_records(tag + "/preempted", "attempt0"),
                key=lambda r: r["rank"])
    a1 = sorted(worker_records(tag + "/preempted", "attempt1"),
                key=lambda r: r["rank"])
    if len(a0) != n or len(a1) != n:
        raise AssertionError(f"launch records: {len(a0)} of attempt 0, "
                             f"{len(a1)} of attempt 1, want {n} each")
    want0 = {"status": "preempted", "exit_code": 75, "restored": False,
             "start_step": 0, "final_step": PREEMPT_AT}
    want1 = {"status": "completed", "exit_code": 0, "restored": True,
             "start_step": PREEMPT_AT, "final_step": 5}
    ranks = []
    for r0, r1, d in zip(a0, a1, ref):
        diff = sorted(k for k in d if r1["digests"].get(k) != d[k])
        ranks.append({
            "rank": r0["rank"], "infos": [r0["info"], r1["info"]],
            "resumed_bitwise_equal": not diff and len(d) > 0,
            "leaves_differing": len(diff), "leaves": len(d),
            "residual_leaves": sum(k.startswith("residual") for k in d),
            "relaunch_s": r1["t_first_step"] - r0["t_exit"],
            "process_start_s": r1["t_entry"] - r0["t_exit"],
            "init_s": r1["t_init"] - r1["t_entry"],
            "state_build_s": r1["t_state"] - r1["t_init"],
            "restore_s": r1["restore_s"],
            "step_ms": [r0["step_ms"], r1["step_ms"]],
            "flash_launches": r1["flash_launches"]})
        if r0["info"] != want0 or r1["info"] != want1 or diff or not d:
            raise AssertionError(f"launched rank {r0['rank']}: {ranks[-1]}")
    if n > 1:
        res = [tuple(sorted((k, v) for k, v in d.items()
                            if k.startswith("residual"))) for d in ref]
        out["residuals_distinct_across_ranks"] = len(set(res)) == n
        if not out["residuals_distinct_across_ranks"]:
            raise AssertionError("every rank's residual is the same")
    out.update(ranks=ranks, launch_s=sec, card=card)
    shutil.rmtree(os.path.join(LAUNCH_ROOT, tag), ignore_errors=True)
    return out


def elastic_records(tag):
    recs = []
    d = os.path.join(LAUNCH_ROOT, tag)
    for name in sorted(os.listdir(d)):
        if name.endswith(".jsonl"):
            with open(os.path.join(d, name)) as f:
                recs += [json.loads(x) for x in f if x.strip()]
    return sorted(recs, key=lambda r: r["t"])


def launched_elastic(n, card, images, schedule, drop=None, grace=5.0):
    """``hvdrun-torch --min-np 2 --max-np n --elastic-local --slots 1``
    (one slot: ``--min-np 1 --max-np 1``) over a discovery script of
    fake hosts n0..n{n-1}, the workers :func:`worker_elastic`. Checks that
    every index of the epoch was processed exactly once across the
    generations (every committed step's indices over every rank), that
    every rank was bitwise equal after every step, that each generation
    restored its last commit bitwise, and that the first generation's
    ranks ran on distinct cards. Returns the line's dict."""
    import shutil
    tag = f"elastic{n}"
    d = os.path.join(LAUNCH_ROOT, tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    hosts = os.path.join(d, "hosts.txt")
    with open(hosts, "w") as f:
        f.write("\n".join(f"n{i}:1" for i in range(n)) + "\n")
    script = os.path.join(d, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts}\n")
    os.chmod(script, 0o755)
    spec = {"images": images, "hosts": hosts, "schedule": schedule,
            "drop": drop or {}}
    rc, sec, tail = launch(
        ["--min-np", str(min(2, n)), "--max-np", str(n), "--elastic-local",
         "--slots", "1", "--host-discovery-script", script,
         "--elastic-state-dir", os.path.join(d, "state"),
         "--elastic-grace-seconds", str(grace)], "elastic", spec, tag)
    check_launch(f"elastic launch of {n}", rc, tail)
    recs = elastic_records(tag)
    gens = sorted({r["gen"] for r in recs})
    steps = [r for r in recs if r["type"] == "step"]
    counts = {}
    for r in steps:
        for i in r["idx"]:
            counts[i] = counts.get(i, 0) + 1
    starts = {(r["gen"], r["rank"]): r for r in recs if r["type"] == "start"}
    first_step = {}
    for r in steps:
        first_step.setdefault(r["gen"], r["t"])
    world_of = {g: max(r["world"] for r in recs if r["gen"] == g)
                for g in gens}
    crash = [r for r in recs if r["type"] in ("crash", "restart")]
    out = {
        "model": "ResNet-50 fused_conv_bn", "images_per_card": RESNET_B,
        "images": images, "schedule": schedule, "drop": drop or {},
        "grace_s": grace, "generations": len(gens),
        "world_by_generation": [world_of[g] for g in gens],
        "indices_exactly_once": sorted(counts) == list(range(images))
        and set(counts.values()) == {1},
        "indices_seen": len(counts),
        "indices_repeated": sum(1 for v in counts.values() if v > 1),
        "ranks_bitwise_equal_every_step": all(r["equal"] for r in steps),
        "restored_bitwise_last_commit": [
            r["bitwise_last_commit"] for r in recs
            if r["type"] == "restored" and r["rank"] == 0],
        "restored_equal_across_ranks": all(
            r["equal"] for r in recs if r["type"] == "restored"),
        "cards_generation_1": [starts[(1, r)]["card"]
                               for r in range(world_of[gens[0]])],
        "visible_generation_1": [starts[(1, r)]["visible"]
                                 for r in range(world_of[gens[0]])],
        "step_ms_by_world": {
            str(w): float(np.median(ms)) if ms else None
            for w in sorted(set(world_of.values()))
            for ms in [[r["step_ms"] for r in steps
                        if r["world"] == w and r["batch"]]]},
        "recovery_s": [first_step[g] - c["t"] for c in crash
                       for g in gens if g == c["gen"] + 1
                       and g in first_step],
        "conv_bn_fwd_per_step": min(r["conv_bn_fwd"] for r in steps),
        "launch_s": sec, "card": card}
    bad = [k for k in ("indices_exactly_once",
                       "ranks_bitwise_equal_every_step",
                       "restored_equal_across_ranks") if not out[k]]
    if not all(out["restored_bitwise_last_commit"]) or \
            len(out["restored_bitwise_last_commit"]) != len(gens) - 1:
        bad.append("restored_bitwise_last_commit")
    cards = out["cards_generation_1"]
    if len(set(cards)) != len(cards) and cards[0] != "cpu":
        bad.append("distinct cards")
    if out["conv_bn_fwd_per_step"] < RESNET50_CONVS:
        bad.append("conv_bn launches")
    if bad:
        raise AssertionError(f"elastic launch of {n}: {bad} failed: {out}")
    shutil.rmtree(d, ignore_errors=True)
    return out


def launched_resize(n, card):
    """The live resize on n = 4 cards (2 hosts of 2) against a cold
    two-rank start from the committed snapshot and plan: the survivors'
    parameters, momentum and residual bitwise the cold start's."""
    import shutil
    tag = "resize"
    d = os.path.join(LAUNCH_ROOT, tag)
    shutil.rmtree(d, ignore_errors=True)
    spec = {"layers": RESIZE_LAYERS, "steps": RESIZE_STEPS,
            "ckpt": os.path.join(d, "ckpt")}
    rc, sec, tail = launch(["-np", str(n)], "resize",
                           dict(spec, mode="live"), tag + "/live")
    check_launch("live resize launch", rc, tail)
    rc, sec_cold, tail = launch(["-np", "2"], "resize",
                                dict(spec, mode="cold"), tag + "/cold")
    check_launch("cold two-rank launch", rc, tail)
    live = sorted(worker_records(tag + "/live", "live"),
                  key=lambda r: r["rank"])
    left = worker_records(tag + "/live", "left")
    cold = sorted(worker_records(tag + "/cold", "cold"),
                  key=lambda r: r["rank"])
    out = {"model": "flagship TransformerLM fused, fp8_e4m3, error "
           f"feedback, {RESIZE_LAYERS} layers", "n_cards": n,
           "host_size": 2, "host_loss_at": RESIZE_AT,
           "steps": RESIZE_STEPS, "left": sorted(r["rank0"] for r in left),
           "survivors": [{k: r.get(k) for k in (
               "rank0", "rank", "world", "resized_at", "resize_seconds",
               "resize_count", "wall_s")} for r in live],
           "restored_step": [r.get("restored_step") for r in cold],
           "launch_s": [sec, sec_cold], "card": card}
    equal = len(live) == len(cold) == 2 and all(
        a["digests"] == b["digests"] and a["digests"]
        for a, b in zip(live, cold))
    out["bitwise_equal_to_cold_start"] = equal
    out["hvd_elastic_resize_seconds"] = [r["resize_seconds"] for r in live]
    if not equal or out["left"] != [2, 3] or \
            out["restored_step"] != [RESIZE_AT, RESIZE_AT]:
        raise AssertionError(f"live resize: {out}")
    shutil.rmtree(d, ignore_errors=True)
    return out


def launcher_world_one(card, ref) -> None:
    """Phase 8 (``launcher (world 1):``): the preempted flagship relaunched
    by ``hvdrun-torch --auto-resume 1``, bitwise phase 5's uninterrupted
    run, then an elastic run of one slot that exits 73 once, its second
    generation restoring the committed TorchState bitwise."""
    line = launched_train(1, card, ref=[ref])
    line["elastic_one_slot"] = launched_elastic(
        1, card, ELASTIC_ONE_IMAGES, schedule={"1:0:2": 73})
    log("launcher (world 1): " + json.dumps(line))


def launcher_worlds(n, card) -> None:
    """The three drills on n cards: ``launcher data parallel:``,
    ``elastic data parallel:`` (4 -> 3 on a crash, 3 -> 2 on a dropped
    host) and ``resize data parallel:``."""
    log("launcher data parallel: " + json.dumps(launched_train(n, card)))
    log("elastic data parallel: " + json.dumps(launched_elastic(
        n, card, ELASTIC_IMAGES, schedule={f"1:{n - 1}:4": 1},
        drop={"2:0:2": f"n{n - 2}"})))
    log("resize data parallel: " + json.dumps(launched_resize(n, card)))


# ---------------------------------------------------------------------------
# phase 9: model parallelism (tensor, sequence, expert, pipeline; serving)
# ---------------------------------------------------------------------------

# Full-width bf16 parity of a sharded step against the unsharded one on
# the same weights: the sharded step sums in another order (a psum of
# bf16 partial products, softmax blocks merged in f32), so the loss may
# move by this share of itself and each gradient leaf by this share of
# its largest value.
MP_BF16_LOSS_REL_TOL = 5e-3
MP_BF16_GRAD_REL_TOL = 5e-2
# f32 at the narrow width: tests/test_torch_model_parallel.py's (the JAX
# file's) tolerances, EP's looser ones where experts are sharded
MP_F32_TOL = {"loss_rtol": 1e-5, "grad_atol": 2e-4, "grad_rtol": 2e-3}
MP_F32_TOL_EP = {"loss_rtol": 1e-4, "grad_atol": 5e-4, "grad_rtol": 2e-3}
MP_PARITY_LAYERS = 4        # depth of the full-width parity step
# the EP parity batch: the no-drop capacity rule (capacity_factor = E)
# makes the unsharded dispatch [T, E, T]; at 8 x 2048 tokens that is 8.6
# GB a tensor
MP_EP_PARITY_BATCH = (4, 512)
MP_NARROW = dict(vocab_size=64, d_model=32, n_heads=4, head_dim=8,
                 n_layers=4, d_ff=64, max_seq=32, remat=False)
MP_NARROW_BATCH = (8, 16)
MP_LOGIT_REL_TOL = 5e-2     # bf16 TP serving logits, share of max |logit|
MP_PROFILED_STEPS = 3       # steps profiled one by one after the timed ones
MP_CONFIGS = [
    dict(label="tp4", mesh=(4,), axes=("tp",), cfg=dict(tp_axis="tp")),
    dict(label="sp4_ring", mesh=(4,), axes=("sp",),
         cfg=dict(sp_axis="sp", attention="ring")),
    dict(label="sp4_ulysses", mesh=(4,), axes=("sp",),
         cfg=dict(sp_axis="sp", attention="ulysses")),
    dict(label="tp2_sp2_ring", mesh=(2, 2), axes=("tp", "sp"),
         cfg=dict(tp_axis="tp", sp_axis="sp", attention="ring")),
    dict(label="ep4", mesh=(4,), axes=("ep",),
         cfg=dict(ep_axis="ep", num_experts=8)),
    dict(label="pp4", mesh=(4,), axes=("pp",),
         cfg=dict(pp_axis="pp", n_microbatches=4)),
    dict(label="tp2_dp2", mesh=(2, 2), axes=("dp", "tp"),
         cfg=dict(dp_axis="dp", tp_axis="tp"), fused=True),
]
# the fused step against the unfused one: 1 + MP_FUSED_STEPS steps each
MP_FUSED_STEPS = 4
PLAIN_AXES = dict(dp_axis=None, tp_axis=None, sp_axis=None, ep_axis=None,
                  pp_axis=None)


def dev_sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def mp_loss_grads(htt, cfg, params, tokens, labels):
    """The step's loss and synced gradients of ``cfg`` on this rank's
    shards (the trainer's step without the update), gathered to the
    global tree: (loss, [f32 CPU gradient leaves])."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel import trainer
    from horovod_tpu_torch.utils import tree as tree_util
    leaves, treedef = tree_util.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    params = tree_util.tree_unflatten(treedef, leaves)
    with collectives.bind_axis(*tfm.mesh_axes(cfg)):
        loss = tfm.loss_fn(cfg, params, tokens, labels)
        grads = torch.autograd.grad(loss, leaves)
        grads = trainer.sync_gradients(
            tree_util.tree_unflatten(treedef, list(grads)),
            tfm.grad_sync_axes(cfg), trainer.mesh_world(cfg))
    if tfm.mesh_axes(cfg):
        grads = tfm.gather_params(cfg, grads)
    return float(loss.detach()), [g.float().cpu() for g in
                                  tree_util.tree_leaves(grads)]


def mp_batch(cfg, b, s, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                          device=dev) for _ in range(2)]


def mp_parity(htt, fa, rank, cfg, dev, b, s, f32_tol=None):
    """The sharded step against the unsharded one on the same weights and
    batch: rank 0 computes the unsharded loss and gradients first, keeps
    them on the host and frees the card; then every rank runs its shard.
    bf16: MP_BF16_* limits; f32: ``f32_tol`` (np.allclose-style). Returns
    rank 0's errors and the kernel launches of the sharded step."""
    import dataclasses
    from horovod_tpu_torch.models import transformer as tfm
    plain = dataclasses.replace(cfg, **PLAIN_AXES)
    params = htt.init_params(
        plain, torch.Generator(device=dev).manual_seed(3), device=dev)
    tokens, labels = mp_batch(cfg, b, s, dev, 4)
    ref = None
    if rank == 0:
        ref = mp_loss_grads(htt, plain, params, tokens, labels)
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    htt.barrier()
    fa.reset_launches()
    loss, grads = mp_loss_grads(
        htt, cfg, tfm.shard_params(cfg, params),
        tfm.shard_batch(cfg, tokens), tfm.shard_batch(cfg, labels))
    dev_sync(dev)
    launches, offsets = dict(fa.LAUNCHES), dict(fa.OFFSET_LAUNCHES)
    del params
    out = {"batch": [b, s], "n_layers": cfg.n_layers,
           "dtype": str(cfg.dtype)[6:],
           "launches": {k: launches[k] for k in
                        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
           "offset_launches": offsets}
    if rank != 0:
        return out
    ref_loss, ref_grads = ref
    if not np.isfinite(loss) or not all(bool(torch.isfinite(g).all())
                                        for g in grads):
        raise AssertionError(f"{cfg}: non-finite sharded loss or grads")
    out["loss"], out["ref_loss"] = loss, ref_loss
    out["loss_rel_err"] = abs(loss - ref_loss) / abs(ref_loss)
    worst = 0.0
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        if g.shape != r.shape:
            raise AssertionError(f"gradient leaf {i}: {tuple(g.shape)} "
                                 f"against {tuple(r.shape)}")
        if f32_tol is None:
            share = float((g - r).abs().max()) / max(
                float(r.abs().max()), 1e-30) / MP_BF16_GRAD_REL_TOL
        else:
            share = float(((g - r).abs() / (f32_tol["grad_atol"]
                                            + f32_tol["grad_rtol"]
                                            * r.abs())).max())
        worst = max(worst, share)
    out["grad_worst_share_of_limit"] = worst
    loss_lim = (MP_BF16_LOSS_REL_TOL if f32_tol is None
                else f32_tol["loss_rtol"])
    if out["loss_rel_err"] > loss_lim or worst > 1.0:
        raise AssertionError(f"sharded step disagrees with the unsharded "
                             f"one: {out}")
    return out


def mp_profile(step, state, batch, dev):
    """One step profiled on rank 0: its wall ms, the NCCL kernels' device
    ms and their overlap with compute, the point-to-point (SendRecv) part
    against the flash kernels' ms, and the top device ops. An NCCL kernel
    runs from its launch until its peers arrive, so its ms also holds the
    other ranks' lag."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, *batch)
        dev_sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = nccl_overlap(prof)
    out.update(wall_ms=wall_ms, top_device_ops=[
        {"op": k[:70], "ms": us / 1e3, "calls": c}
        for us, k, c in device_rows(prof)[:6]])
    p2p = flash = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.end - ev.time_range.start
        if "SendRecv" in ev.name:
            p2p += us
        elif "flash_" in ev.name:
            flash += us
    out.update(p2p_ms=p2p / 1e3, flash_kernels_ms=flash / 1e3)
    return state, out


def mp_timed(htt, fa, rank, cfg, dev, n_steps):
    """The configuration at full width and depth through
    make_transformer_train_step (SGD with momentum): a warm-up step,
    ``n_steps`` timed steps with the launch counts zeroed just before,
    then MP_PROFILED_STEPS steps, each profiled alone on rank 0."""
    import dataclasses
    from horovod_tpu_torch.models import transformer as tfm
    plain = dataclasses.replace(cfg, **PLAIN_AXES)
    params = tfm.shard_params(cfg, htt.init_params(
        plain, torch.Generator(device=dev).manual_seed(0), device=dev))
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    init_fn, step = htt.make_transformer_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        device=dev)
    state = init_fn(params)
    batches = [[tfm.shard_batch(cfg, t) for t in
                mp_batch(cfg, TRAIN_B, TRAIN_S, dev, 10 + i)]
               for i in range(n_steps + 1 + MP_PROFILED_STEPS)]
    state, loss = step(state, *batches[0])
    warm = float(loss)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    htt.barrier()
    fa.reset_launches()
    losses, stamps = [], []
    t0 = time.perf_counter()
    for batch in batches[1:n_steps + 1]:
        state, loss = step(state, *batch)
        losses.append(float(loss))                       # synchronizes
        stamps.append(time.perf_counter())
    launches, offsets = dict(fa.LAUNCHES), dict(fa.OFFSET_LAUNCHES)
    profs = []
    for batch in batches[n_steps + 1:]:
        htt.barrier()
        if rank == 0:
            state, prof = mp_profile(step, state, batch, dev)
            profs.append(prof)
        else:
            state, _ = step(state, *batch)
    if not all(np.isfinite(x) for x in [warm] + losses):
        raise AssertionError(f"non-finite loss: {[warm] + losses}")
    step_s = np.diff([t0] + stamps)
    out = {"step_ms": [float(x) * 1e3 for x in step_s],
           "step_ms_mean": float(step_s.mean()) * 1e3,
           "step_ms_median": float(np.median(step_s)) * 1e3,
           "step_ms_range": [float(step_s.min()) * 1e3,
                             float(step_s.max()) * 1e3],
           "tokens_per_s": TRAIN_B * TRAIN_S / float(step_s.mean()),
           "losses": [warm] + losses,
           "launches": {k: launches[k] for k in
                        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
           "flash_launches_per_step": {
               k: launches[k] / n_steps for k in
               ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
           "offset_launches": offsets,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                              if torch.device(dev).type == "cuda"
                              else None)}
    if profs:
        out["profiled_steps"] = profs
        if cfg.sp_axis and cfg.attention == "ring":
            out["ring_exchange_ms_per_step"] = [p["p2p_ms"] for p in profs]
            out["ring_kernels_ms_per_step"] = [p["flash_kernels_ms"]
                                               for p in profs]
    return out


def mp_fused(htt, fa, cfg, dev, n_steps=MP_FUSED_STEPS):
    """``make_transformer_train_step_fused`` on the configuration's mesh
    against ``make_transformer_train_step``, 1 + ``n_steps`` steps each
    from the same weights and batches (SGD(0.01, momentum=0.9) and
    EpilogueSGD(0.01, momentum=0.9)): at tier none the losses within
    FUSED_LOSS_REL_TOL and this rank's parameter shards within
    FUSED_UPDATE_REL_TOL of the unfused run's update, both the worst
    over the ranks; then at fp8_e4m3 with error feedback (losses finite,
    the wire trace). Each run's step ms (median, range), tokens/s and
    flash launches a step are of the ``n_steps`` steps after the first;
    one more step is profiled on rank 0 (``mp_profile``)."""
    import dataclasses
    import torch.distributed as dist
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel import distributed as D
    from horovod_tpu_torch.utils import tree as tree_util
    plain = dataclasses.replace(cfg, **PLAIN_AXES)
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def weights():
        return tfm.shard_params(cfg, htt.init_params(
            plain, torch.Generator(device=dev).manual_seed(0), device=dev))

    batches = [[tfm.shard_batch(cfg, t) for t in
                mp_batch(cfg, TRAIN_B, TRAIN_S, dev, 20 + i)]
               for i in range(n_steps + 2)]

    def run(fused):
        if fused:
            da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                                       sync_axes=tfm.grad_sync_axes(cfg))
            init_fn, step = htt.make_transformer_train_step_fused(
                cfg, da, device=dev)
        else:
            init_fn, step = htt.make_transformer_train_step(
                cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
                device=dev)
        state = init_fn(weights())
        state, loss = step(state, *batches[0])               # warm-up
        losses, stamps = [float(loss)], []
        htt.barrier()
        fa.reset_launches()
        dev_sync(dev)
        t0 = time.perf_counter()
        for batch in batches[1:-1]:
            state, loss = step(state, *batch)
            losses.append(float(loss))                   # synchronizes
            stamps.append(time.perf_counter())
        launches = dict(fa.LAUNCHES)
        final = [t.detach().clone() for t in
                 tree_util.tree_leaves(state.params)]
        htt.barrier()
        profiled = None
        if htt.rank() == 0:
            state, profiled = mp_profile(step, state, batches[-1], dev)
        else:
            state, _ = step(state, *batches[-1])
        if not all(np.isfinite(x) for x in losses):
            raise AssertionError(f"fused={fused}: non-finite loss {losses}")
        if min(launches.get(k, 0) for k in kernels) < n_steps:
            raise AssertionError(f"fused={fused}: flash launches "
                                 f"{launches}")
        step_s = np.diff([t0] + stamps)
        res = {"losses": losses,
               "step_ms": [float(x) * 1e3 for x in step_s],
               "step_ms_median": float(np.median(step_s)) * 1e3,
               "step_ms_range": [float(step_s.min()) * 1e3,
                                 float(step_s.max()) * 1e3],
               "tokens_per_s": TRAIN_B * TRAIN_S / float(np.median(step_s)),
               "flash_launches_per_step": {k: launches[k] / n_steps
                                           for k in kernels},
               "profiled_step": profiled}
        if fused:
            trace = D.last_wire_trace()
            res.update(tier=trace["tier"], buckets=trace["n_buckets"],
                       wire_bytes=trace["wire_bytes"],
                       logical_bytes=trace["logical_bytes"],
                       error_feedback=trace["error_feedback"])
        del state
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        return res, final

    unfused, want = run(False)
    none, got = run(True)
    initial = tree_util.tree_leaves(weights())
    worst = torch.tensor(
        [max(abs(a - b) / abs(b) for a, b in zip(none["losses"],
                                                 unfused["losses"])),
         update_rel_diff(got, want, initial)], dtype=torch.float64,
        device=dev)
    del got, want, initial
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    rel, upd = float(worst[0]), float(worst[1])
    if rel > FUSED_LOSS_REL_TOL or upd > FUSED_UPDATE_REL_TOL:
        raise AssertionError(
            f"fused step at tier none on {tfm.mesh_axes(cfg)}: losses "
            f"{none['losses']} against the unfused {unfused['losses']} "
            f"differ by {rel}, parameters by {upd} of the update")
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    try:
        fp8, _ = run(True)
    finally:
        knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
    if not fp8["error_feedback"] or fp8["tier"] != "fp8_e4m3":
        raise AssertionError(f"fused fp8 on {tfm.mesh_axes(cfg)}: wire "
                             f"trace {fp8}")
    return {"optimizer": "EpilogueSGD(0.01, momentum=0.9) against "
                         "SGD(0.01, momentum=0.9)",
            "batch": [TRAIN_B, TRAIN_S], "unfused": unfused,
            "none": none, "fp8_e4m3": fp8,
            "max_rel_loss_diff_vs_unfused": rel,
            "max_param_diff_over_update_vs_unfused": upd}


def mp_check_launches(label, cfg, res) -> None:
    """Every configuration's step ran the three flash kernels; a ring's
    also at nonzero offsets."""
    for part in ("parity", "timed"):
        got = res[part]
        if min(got["launches"].values()) < 1:
            raise AssertionError(f"{label} {part}: a flash kernel was not "
                                 f"launched: {got['launches']}")
        if cfg.get("attention") == "ring" and \
                min(got["offset_launches"].values()) < 1:
            raise AssertionError(f"{label} {part}: no flash launch at a "
                                 f"nonzero offset: {got['offset_launches']}")


def mp_serve_requests(vocab, n=16, new_tokens=32, seed=0, lo=64,
                      hi=1024):
    """Phase 3's traffic: ``n`` requests of ``lo``-``hi`` prompt tokens,
    ``new_tokens`` each."""
    from horovod_tpu_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, int(rng.integers(lo, hi + 1))).astype(np.int32),
        max_new_tokens=new_tokens) for i in range(n)]


def mp_engine_run(eng, make_reqs, dev, fa):
    """The scheduler over fresh ``make_reqs()`` (a scheduler stamps its
    requests): ({rid: tokens}, wall s, decode tokens, paged-decode
    launches)."""
    from horovod_tpu_torch.serving import ServeScheduler
    reqs = make_reqs()
    fa.reset_launches()
    dev_sync(dev)
    t0 = time.perf_counter()
    sched = ServeScheduler(eng, mode="continuous",
                           device=torch.device(dev).type)
    done = sched.run(reqs)
    dev_sync(dev)
    wall = time.perf_counter() - t0
    if any(r.error for r in done):
        raise AssertionError([r.error for r in done if r.error])
    return ({r.rid: list(r.tokens) for r in done}, wall,
            sched.stats()["generated_tokens"], fa.LAUNCHES["paged_decode"])


def mp_forced_logits(eng, make_reqs, forced):
    """Teacher-forced replay: each request's prompt prefilled, then its
    ``forced[rid]`` tokens fed one a decode step, whatever the engine
    would pick, the engine's slots filled at a time. {rid: f32 CPU logits
    [len(forced[rid]), V]}: row 0 the prefill's, row p the decode step's
    that took ``forced[rid][p - 1]``, so row p predicts token p."""
    reqs = make_reqs()
    out = {}
    for lo in range(0, len(reqs), eng.slots):
        batch = reqs[lo:lo + eng.slots]
        slots = []
        for r in batch:
            slot = eng.reserve(r.prompt.size + len(forced[r.rid]))
            eng.prefill(slot, r.prompt)
            slots.append(slot)
            out[r.rid] = [eng.last_logits.float().cpu()]
        for t in range(max(len(forced[r.rid]) for r in batch) - 1):
            tokens = np.zeros((eng.slots,), np.int32)
            active = np.zeros((eng.slots,), bool)
            for slot, r in zip(slots, batch):
                if t + 1 < len(forced[r.rid]):
                    tokens[slot], active[slot] = forced[r.rid][t], True
            eng.decode_step(tokens, active)
            logits = eng.last_logits.float().cpu()
            for slot, r in zip(slots, batch):
                if active[slot]:
                    out[r.rid].append(logits[slot])
        for slot in slots:
            eng.release(slot)
    return {rid: torch.stack(rows) for rid, rows in out.items()}


def mp_serve(htt, fa, rank, cfg, dev, make_reqs, exact):
    """TP serving against the one-card engine on the same weights: rank 0
    serves ``make_reqs()`` alone first, then replays the one-card tokens
    teacher-forced (kept on the host); then every rank's TP engine does
    both. Gates: the forced replay's logits at every prefill and decode
    position within MP_LOGIT_REL_TOL of the one-card row's largest
    (``exact``, f32: LOGIT_TOL, and every token equal), and each request
    whose free-running tokens part from one card's parts at a near tie:
    one card's logits of the two tokens within that same limit."""
    import dataclasses
    from horovod_tpu_torch.serving import ServeEngine
    plain = dataclasses.replace(cfg, **PLAIN_AXES)
    params = htt.init_params(
        plain, torch.Generator(device=dev).manual_seed(0), device=dev)
    ref = r_forced = None
    if rank == 0:
        eng = ServeEngine(plain, params, device=dev)
        ref = mp_engine_run(eng, make_reqs, dev, fa)
        r_forced = mp_forced_logits(eng, make_reqs, ref[0])
        del eng
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    r_toks = htt.broadcast_object(ref[0] if rank == 0 else None, 0)
    eng = ServeEngine(cfg, params, device=dev)
    del params
    toks, wall, gen, launches = mp_engine_run(eng, make_reqs, dev, fa)
    forced = mp_forced_logits(eng, make_reqs, r_toks)
    out = {"tp": eng.stats()["tp"], "kv_heads_per_card": eng.k_pages.shape[3],
           "requests": len(toks), "wall_s": wall,
           "decode_tokens_per_s": gen / wall,
           "paged_decode_launches": launches}
    if launches < cfg.n_layers:
        raise AssertionError(f"paged_decode launched {launches} times")
    if rank != 0:
        return out
    _, r_wall, r_gen, _ = ref
    lim = LOGIT_TOL if exact else MP_LOGIT_REL_TOL
    worst, argmax_equal, divergences = 0.0, 0, []
    for rid, r_rows in r_forced.items():
        rows = forced[rid]
        err = (rows - r_rows).abs().amax(dim=-1)
        scale = 1.0 if exact else r_rows.abs().amax(dim=-1)
        worst = max(worst, float((err / scale).max()))
        argmax_equal += int((rows.argmax(-1) == r_rows.argmax(-1)).sum())
        part = next((p for p, (a, b) in enumerate(zip(toks[rid],
                                                      r_toks[rid]))
                     if a != b), None)
        if part is not None:
            row = r_rows[part]
            gap = float(row[r_toks[rid][part]] - row[toks[rid][part]])
            divergences.append({
                "rid": rid, "position": part, "one_card_gap": gap,
                "limit": lim * (1.0 if exact else float(row.abs().max())),
                "forced_max_abs_err": float(err[part])})
    n_pos = sum(r.shape[0] for r in r_forced.values())
    first, r_first = forced[0][0], r_forced[0][0]      # request 0's prefill
    same = sum(toks[k] == r_toks[k] for k in r_toks)
    pos = [sum(a == b for a, b in zip(toks[k], r_toks[k])) for k in r_toks]
    out.update(
        first_logits_max_abs_err=float((first - r_first).abs().max()),
        first_logits_max_abs=float(r_first.abs().max()),
        forced_positions=n_pos,
        forced_logits_max_err=worst,
        forced_logits_limit=lim,
        forced_argmax_equal_share=argmax_equal / n_pos,
        requests_with_equal_tokens=same,
        equal_token_share=sum(pos) / sum(len(t) for t in r_toks.values()),
        divergences=divergences,
        one_card_decode_tokens_per_s=r_gen / r_wall)
    if worst > lim or any(d["one_card_gap"] > d["limit"]
                          for d in divergences) or \
            (exact and same != len(r_toks)):
        raise AssertionError(f"TP serving disagrees with one card: {out}")
    return out


def mp_rank(rank, world, ports, results, configs, device="cuda", n_steps=3,
            serve=True):
    """One rank of the N-card model-parallel world: each configuration on
    its mesh (``init(mesh_shape=, axis_names=)`` on the same process
    group), then TP serving on a (tp N) mesh; rank 0 puts one result per
    configuration on ``results``."""
    import dataclasses
    import torch.distributed as dist
    join_store_world(rank, world, ports, device)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for c in configs:
        ctx = htt.init(device=device, mesh_shape=c["mesh"],
                       axis_names=c["axes"])
        dev = ctx.device
        cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                           **c["cfg"])
        pcfg = dataclasses.replace(cfg, n_layers=MP_PARITY_LAYERS)
        b, s = TRAIN_B, TRAIN_S
        ncfg = htt.TransformerConfig(**{**MP_NARROW, **PLAIN_AXES,
                                        **c["cfg"]}, dtype=torch.float32)
        tol = MP_F32_TOL
        if cfg.num_experts:
            # no token dropped: the sharded capacity rule sees T / ep
            # tokens, the unsharded one T
            pcfg = dataclasses.replace(pcfg, capacity_factor=float(
                cfg.num_experts), moe_aux_weight=0.0)
            b, s = MP_EP_PARITY_BATCH
            ncfg = dataclasses.replace(ncfg, num_experts=4,
                                       capacity_factor=4.0,
                                       moe_aux_weight=0.0)
            tol = MP_F32_TOL_EP
        res = {"label": c["label"], "mesh": dict(zip(c["axes"], c["mesh"])),
               "parity": mp_parity(htt, fa, rank, pcfg, dev, b, s),
               "narrow_f32": mp_parity(htt, fa, rank, ncfg, dev,
                                       *MP_NARROW_BATCH, f32_tol=tol),
               "timed": mp_timed(htt, fa, rank, cfg, dev, n_steps)}
        mp_check_launches(c["label"], c["cfg"], res)
        if rank == 0:
            results.put(res)
        if c.get("fused"):
            res = {"label": c["label"] + "_fused", "mesh": res["mesh"],
                   **mp_fused(htt, fa, cfg, dev)}
            if rank == 0:
                results.put(res)
        htt.shutdown()
        if device == "cuda":
            torch.cuda.empty_cache()
    if serve:
        ctx = htt.init(device=device, mesh_shape=(world,), axis_names=("tp",))
        dev = ctx.device
        cfg = flagship_cfg(htt.TransformerConfig, tp_axis="tp")
        ncfg = htt.TransformerConfig(**{**MP_NARROW, **PLAIN_AXES,
                                        "tp_axis": "tp"},
                                     dtype=torch.float32)
        res = {"label": f"tp{world}_serve",
               "serve": mp_serve(
                   htt, fa, rank, cfg, dev,
                   lambda: mp_serve_requests(cfg.vocab_size), False),
               "narrow_f32": mp_serve(
                   htt, fa, rank, ncfg, dev,
                   lambda: mp_serve_requests(ncfg.vocab_size, 6, 8, seed=1,
                                             lo=4, hi=20), True)}
        htt.shutdown()
        if rank == 0:
            results.put(res)
    dist.destroy_process_group()


def model_parallel_world(n, card, configs=None, **kw) -> None:
    """Every model-parallel configuration on ``n`` cards, one ``model
    parallel <label>:`` line each."""
    configs = MP_CONFIGS if configs is None else configs
    serve = kw.get("serve", True)
    n_results = len(configs) + sum(bool(c.get("fused")) for c in configs)
    out = spawn_world(mp_rank, n, n_results + int(serve), 900, configs,
                      **kw)
    for res in out:
        log(f"model parallel {res['label']}: " + json.dumps(
            {**res, "card": card}))


def ring_virtual_positions(htt, fa, sq, dev="cuda", n=4):
    """The ring's per-step bodies with the kernels over ``n`` virtual ring
    positions of a full-width sequence (B=8, S=2048, H=16, D=64, bf16,
    causal), assembled, against flash_attention over the whole sequence
    and its backward."""
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s_all, h, d = TRAIN_B, TRAIN_S, 16, 64
    q, k, v, do = (torch.randn((b, s_all, h, d), generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(4))
    s = s_all // n
    scale = d ** -0.5
    blk = [slice(i * s, (i + 1) * s) for i in range(n)]
    kb = [k[:, x].contiguous() for x in blk]
    vb = [v[:, x].contiguous() for x in blk]

    def ring_pass():
        outs, lses = [], []
        for my in range(n):
            qb = q[:, blk[my]].contiguous()
            acc = torch.zeros(qb.shape, dtype=torch.float32, device=dev)
            m = torch.full(qb.shape[:3], float("-inf"), device=dev)
            l = torch.zeros(qb.shape[:3], device=dev)
            for t in range(n):
                src = (my - t) % n
                acc, m, l = sq.ring_fwd_step(qb, kb[src], vb[src], my * s,
                                             src * s, True, scale, acc, m, l)
            outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
            lses.append((m + torch.log(l.clamp_min(1e-30))).transpose(1, 2)
                        .contiguous())
        o = torch.cat(outs, dim=1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
        dkv = torch.zeros((2,) + k.shape, dtype=torch.float32, device=dev)
        for my in range(n):
            qb, dob = q[:, blk[my]].contiguous(), do[:, blk[my]].contiguous()
            dD = (dob.float() * o[:, blk[my]].float()).sum(-1).transpose(
                1, 2).contiguous()
            dqb = torch.zeros(qb.shape, dtype=torch.float32, device=dev)
            for src in range(n):
                acc = torch.zeros((2,) + kb[src].shape, dtype=torch.float32,
                                  device=dev)
                sq.ring_bwd_step(qb, kb[src], vb[src], dob, lses[my], dD,
                                 my * s, src * s, True, scale, dqb, acc)
                dkv[:, :, blk[src]] += acc
            dq[:, blk[my]] = dqb
        return o, dq, dkv

    def flash_pass():
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        ref = fa.flash_attention(qg, kg, vg, True, scale)
        return (ref.detach(),) + torch.autograd.grad(ref, (qg, kg, vg), do)

    def timed(fn):
        fn()                                     # warm-up
        dev_sync(dev)
        t0 = time.perf_counter()
        out = fn()
        dev_sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    fa.reset_launches()
    (o, dq, dkv), ring_ms = timed(ring_pass)
    launches, offsets = dict(fa.LAUNCHES), dict(fa.OFFSET_LAUNCHES)
    (ref, rq, rk, rv), flash_ms = timed(flash_pass)
    errs = {}
    for name, got, want in (("o", o, ref), ("dq", dq, rq),
                            ("dk", dkv[0], rk), ("dv", dkv[1], rv)):
        e = float((got.float() - want.float()).abs().max())
        lim = FLASH_REL_TOL[torch.bfloat16] * max(
            1.0, float(want.float().abs().max()))
        if not e <= lim:
            raise AssertionError(f"ring body over {n} virtual positions: "
                                 f"{name} {e} > {lim}")
        errs[name] = e
    if min(offsets.values()) < 1:
        raise AssertionError(f"no launch at a nonzero offset: {offsets}")
    return {"positions": n, "shape": [b, s_all, h, d], "max_abs_err": errs,
            "launches": launches, "offset_launches": offsets,
            "ring_wall_ms": ring_ms, "flash_wall_ms": flash_ms}


def mesh_of_ones(htt, fa, dev="cuda"):
    """A step on a mesh whose every axis has size 1 (dp, tp, sp, ep, pp)
    against the plain step (every axis None) on the same weights and
    batch, at full width and MP_PARITY_LAYERS layers: the dense model
    (tp, sp ring, pp) and the MoE one (ep, 8 experts); loss and every
    gradient leaf bitwise equal."""
    import dataclasses
    htt.init(device=dev, mesh_shape=(1, 1, 1, 1, 1),
             axis_names=("dp", "tp", "sp", "ep", "pp"))
    out = {}
    try:
        for label, kw, (b, s) in (
                ("dense", dict(dp_axis="dp", tp_axis="tp", sp_axis="sp",
                               attention="ring", pp_axis="pp"),
                 (TRAIN_B, TRAIN_S)),
                ("moe", dict(dp_axis="dp", ep_axis="ep", num_experts=8),
                 MP_EP_PARITY_BATCH)):
            cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                               n_layers=MP_PARITY_LAYERS, **kw)
            plain = dataclasses.replace(cfg, **PLAIN_AXES)
            params = htt.init_params(
                plain, torch.Generator(device=dev).manual_seed(3),
                device=dev)
            tokens, labels = mp_batch(cfg, b, s, dev, 4)
            ref = mp_loss_grads(htt, plain, params, tokens, labels)
            got = mp_loss_grads(htt, cfg, params, tokens, labels)
            equal = ref[0] == got[0] and all(
                torch.equal(a, c) for a, c in zip(ref[1], got[1]))
            if not equal:
                worst = max(float((a - c).abs().max())
                            for a, c in zip(ref[1], got[1]))
                raise AssertionError(
                    f"mesh of ones ({label}) differs from the plain step: "
                    f"loss {got[0]} vs {ref[0]}, worst grad diff {worst}")
            out[label] = {"loss": got[0], "bitwise_equal": True,
                          "leaves": len(got[1])}
            del params
    finally:
        htt.shutdown()
    return out


def model_parallel_world_one(htt, fa, sq, card, dev="cuda") -> None:
    """Phase 9 on one card: the ring's per-step body over virtual ring
    positions with the kernels, and the mesh whose axes all have size 1
    (``model parallel (world 1):`` line)."""
    line = {"ring_virtual_positions": ring_virtual_positions(htt, fa, sq,
                                                             dev),
            "mesh_of_ones": mesh_of_ones(htt, fa, dev), "card": card}
    log("model parallel (world 1): " + json.dumps(line))


# ---------------------------------------------------------------------------
# phase 10: Horovod's control plane (the fusion-cycle coordinator)
# ---------------------------------------------------------------------------

CP_STEPS = 2                # ResNet-50 SGD steps through each sync path
CP_STEP_ROUNDS = 3          # timed steps of each sync path, in turns
CP_SYNC_ITERS = 5           # timed syncs of a step's gradients, per path
CP_DIV_FLUSHES = 64         # one-tensor flushes of the cadence probe
CP_DIV_TIMEOUT = 10         # HOROVOD_DIVERGENCE_TIMEOUT of the drill
CP_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "control_plane")


def cp_hooked_sync(htt, params):
    """Reference Horovod's torch idiom through the coordinator: each
    gradient is handed to ``allreduce_async`` from its post-accumulate
    hook as the backward makes it; ``sync()`` then synchronizes every
    handle into its gradient. Returns ``(sync, hook handles)``."""
    handles = {}

    def hook(i):
        def fn(p):
            handles[i] = htt.allreduce_async(p.grad, op=htt.Average,
                                             name=f"grad.{i}")
        return fn

    hooks = [p.register_post_accumulate_grad_hook(hook(i))
             for i, p in enumerate(params)]

    def sync():
        for i, p in enumerate(params):
            p.grad.copy_(htt.synchronize(handles.pop(i)))

    return sync, hooks


def cp_direct_hooks(C, params):
    """The direct path from the same hooks (``allreduce_async`` as it was
    before the coordinator): each gradient's allreduce starts
    (``collectives.allreduce_start``) as its hook fires; ``sync()`` waits
    for each into its gradient. Returns ``(sync, hook handles)``."""
    started = {}

    def hook(i):
        def fn(p):
            started[i] = C.allreduce_start(p.grad, C.ReduceOp.AVERAGE)
        return fn

    hooks = [p.register_post_accumulate_grad_hook(hook(i))
             for i, p in enumerate(params)]

    def sync():
        for i, p in enumerate(params):
            p.grad.copy_(started.pop(i).wait())

    return sync, hooks


def cp_step_times(htt, C, model, sgd, params, rank, dev, sync, batch, image,
                  out):
    """The ms of a ResNet-50 SGD step (forward, backward, sync, update) by
    the path of its gradient sync, CP_STEP_ROUNDS steps each in turns
    after a warm-up round (median and all): ``allreduce_async`` from the
    gradient hooks through the coordinator, the direct allreduce from
    the same hooks, and ``DistributedOptimizer``; in a world of one also
    the coordinator without its cycle thread (a flush at the threshold and
    at the first wait, as with several ranks, less the check)."""
    from horovod_tpu_torch.ops.coordinator import Coordinator
    from horovod_tpu_torch.runtime.context import get_context
    ctx = get_context()

    def hooked(make):
        def install():
            hsync, hooks = make()
            return sgd, hsync, lambda: [h.remove() for h in hooks]
        return install

    def dopt():
        opt = htt.DistributedOptimizer(sgd, op=htt.Average)
        return opt, None, opt._launcher.remove_hooks

    paths = {"coordinator": hooked(lambda: cp_hooked_sync(htt, params)),
             "direct": hooked(lambda: cp_direct_hooks(C, params)),
             "distributed_optimizer": dopt}
    if ctx.size == 1:
        def no_thread():
            own = Coordinator(ctx, start_thread=False)
            own.deterministic = True
            saved, ctx.coordinator = ctx.coordinator, own
            opt, hsync, remove = paths["coordinator"]()

            def undo():
                remove()
                own.shutdown()
                ctx.coordinator = saved
            return opt, hsync, undo
        paths["coordinator_no_thread"] = no_thread
    ms = {k: [] for k in paths}
    for rnd in range(CP_STEP_ROUNDS + 1):
        x, y = api_batch(dev, 60 + rnd, rank, batch, image)
        for label, install in paths.items():
            opt, hsync, remove = install()
            try:
                sync()
                t0 = time.perf_counter()
                resnet_loss(model, x, y).backward()
                if hsync is not None:
                    hsync()
                opt.step()
                sync()
                if rnd:
                    ms[label].append((time.perf_counter() - t0) * 1e3)
            finally:
                remove()
                sgd.zero_grad()
    out["step_ms_by_path"] = {k: float(np.median(v)) for k, v in ms.items()}
    out["step_ms_by_path_all"] = ms


def cp_plan_times(sizes, out, reps=200):
    """The host us of one bin plan of the step's gradient sizes at the
    default threshold, native (``csrc/core.cc``) against the Python
    planner (median of ``reps`` calls each, in turns); both must give the
    same bins."""
    from horovod_tpu_torch import native
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops.fusion import _plan_fusion_bins_py
    thr = int(knobs.get("HOROVOD_FUSION_THRESHOLD"))
    if native.plan_fusion_bins(sizes, thr) != _plan_fusion_bins_py(sizes,
                                                                    thr):
        raise AssertionError("native and Python planners disagree")
    us = {"native": [], "python": []}
    for _ in range(reps):
        for label, fn in (("native", native.plan_fusion_bins),
                          ("python", _plan_fusion_bins_py)):
            t0 = time.perf_counter()
            fn(sizes, thr)
            us[label].append((time.perf_counter() - t0) * 1e6)
    out["plan_us"] = {k: float(np.median(v)) for k, v in us.items()}
    out["plan_sizes"] = len(sizes)


def cp_counts(ctx):
    """(cycles, bins, tensors, cache hits, cache misses) so far."""
    c = ctx.coordinator
    if c is None:
        return (0, 0, 0, 0, 0)
    return (c.stats.cycles, c.stats.dispatched_programs, c.stats.tensors,
            c.cache.hits, c.cache.misses)


def cp_hist(name):
    """(sum, count) of a histogram of the metrics registry."""
    from horovod_tpu_torch import metrics as M
    m = M.get_registry().get(name)
    return (m.total_sum, m.total_count) if m is not None else (0.0, 0)


def cp_resnet_steps(htt, C, cb, rank, world, dev, sync, batch, image, out):
    """CP_STEPS SGD steps of ResNet-50 (``fused_conv_bn=True``) through
    the coordinator (``cp_hooked_sync``) beside the same steps through
    ``DistributedOptimizer`` from the same weights. In a world of one the
    two runs go on independently and must stay bitwise equal. On several
    cards the second model takes the first's parameters, buffers and
    momentum before each step, so the steps differ only by the sync:
    another packing sums in another order, and bf16 compute would spread
    a last-bit difference through later steps. There each step's synced
    gradients must agree within API_MEAN_REL_TOL, and its new parameters
    within PARAM_REL_TOL, of each leaf's largest value; every rank's
    parameters must be bitwise every other's. Each step is timed by the
    host clock after a synchronize (forward, backward, sync and update;
    the DistributedOptimizer step likewise). Returns the coordinator's
    model's parameters, with the gradients of one more backward."""
    import copy
    from horovod_tpu_torch.runtime.context import get_context
    ctx = get_context()
    models = [htt.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                           fused_conv_bn=True, device=dev, seed=3)
              for _ in range(2)]
    params = [list(m.parameters()) for m in models]
    sgds = [torch.optim.SGD(ps, lr=0.01, momentum=0.9) for ps in params]
    dopt = htt.DistributedOptimizer(sgds[1], op=htt.Average)
    hsync, hooks = cp_hooked_sync(htt, params[0])
    per_step, step_ms, dopt_ms = [], [], []
    for step in range(CP_STEPS):
        x, y = api_batch(dev, 40 + step, rank, batch, image)
        if world > 1 and step:
            with torch.no_grad():
                for a, b in zip(models[0].state_dict().values(),
                                models[1].state_dict().values()):
                    b.copy_(a)
            # a copy: load_state_dict would share the momentum tensors
            sgds[1].load_state_dict(copy.deepcopy(sgds[0].state_dict()))
        before = cp_counts(ctx)
        cb.reset_launches()
        sync()
        t0 = time.perf_counter()
        resnet_loss(models[0], x, y).backward()
        hsync()
        sgds[0].step()
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_launches(cb, dev, f"control plane step {step}")
        after = cp_counts(ctx)
        per_step.append(dict(zip(
            ("cycles", "bins", "tensors", "cache_hits", "cache_misses"),
            (a - b for a, b in zip(after, before)))))
        sync()
        t0 = time.perf_counter()
        resnet_loss(models[1], x, y).backward()
        dopt.step()
        sync()
        dopt_ms.append((time.perf_counter() - t0) * 1e3)
        if not same_on_every_rank(C, params[0]):
            raise AssertionError(f"control plane step {step}: parameters "
                                 f"differ between ranks")
        if world == 1:
            if not all(torch.equal(a, b) for a, b in zip(*params)):
                raise AssertionError(
                    f"control plane step {step}: parameters differ from "
                    f"DistributedOptimizer's")
            out["bitwise_equal_to_distributed_optimizer"] = step + 1
        else:
            for what, got, ref, rel in (
                    ("grad", [p.grad for p in params[0]],
                     [p.grad for p in params[1]], API_MEAN_REL_TOL),
                    ("param", params[0], params[1], PARAM_REL_TOL)):
                err, share = leaf_errors(got, [r.double() for r in ref], rel)
                out[f"step{step}_{what}_max_abs_err_vs_dopt"] = err
                out[f"step{step}_{what}_share_of_limit"] = share
                if share > 1:
                    raise AssertionError(
                        f"control plane step {step}: {what}s off "
                        f"DistributedOptimizer's by {err} ({share} of the "
                        f"limit)")
        sgds[0].zero_grad()
        dopt.zero_grad()
    for h in hooks:
        h.remove()
    dopt._launcher.remove_hooks()
    out.update(per_step=per_step, step_ms=step_ms,
               distributed_optimizer_step_ms=dopt_ms,
               gradient_tensors=len(params[0]),
               gradient_bytes=sum(p.numel() * p.element_size()
                                  for p in params[0]))
    del models[1], params[1], dopt
    cp_step_times(htt, C, models[0], sgds[0], params[0], rank, dev, sync,
                  batch, image, out)
    cp_plan_times([p.numel() * p.element_size() * world
                   for p in params[0]], out)
    # one more backward leaves gradients for the timed syncs
    x, y = api_batch(dev, 50, rank, batch, image)
    resnet_loss(models[0], x, y).backward()
    del sgds
    return params[0]


def cp_sync_times(htt, C, knobs, grads, sync, out):
    """The sync of one step's gradients, timed three ways in turns
    (CP_SYNC_ITERS each, median ms): through the coordinator (every
    gradient ``allreduce_async``, then synchronized), through it with
    HOROVOD_FUSION_THRESHOLD=0 (one bin per tensor), and the direct
    path (one started allreduce per tensor, then waited). With the host
    ms of a cycle (plan plus dispatch), of a bin's dispatch, and of the
    enqueue loop (in a world of several ranks its threshold flushes run
    inside it)."""
    enqueue_ms = []

    def coord():
        t0 = time.perf_counter()
        hs = [htt.allreduce_async(g, op=htt.Average, name=f"t.{i}")
              for i, g in enumerate(grads)]
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        for h in hs:
            htt.synchronize(h)

    def direct():
        for p in [C.allreduce_start(g, C.ReduceOp.AVERAGE) for g in grads]:
            p.wait()

    def zero():
        knobs.set_override("HOROVOD_FUSION_THRESHOLD", 0)
        try:
            coord()
        finally:
            knobs.clear_override("HOROVOD_FUSION_THRESHOLD")

    ms = {"coordinator": [], "coordinator_threshold_0": [], "direct": []}
    cyc = {"coordinator": [0.0, 0], "coordinator_threshold_0": [0.0, 0]}
    disp = [0.0, 0]
    for it in range(CP_SYNC_ITERS + 1):
        for label, fn in (("coordinator", coord),
                          ("coordinator_threshold_0", zero),
                          ("direct", direct)):
            c0, d0 = cp_hist("hvd_cycle_duration_seconds"), \
                cp_hist("hvd_dispatch_seconds")
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            dt = (time.perf_counter() - t0) * 1e3
            if it == 0:
                continue            # warm-up: plans built, groups formed
            ms[label].append(dt)
            c1, d1 = cp_hist("hvd_cycle_duration_seconds"), \
                cp_hist("hvd_dispatch_seconds")
            if label in cyc:
                cyc[label][0] += c1[0] - c0[0]
                cyc[label][1] += c1[1] - c0[1]
            if label == "coordinator":
                disp[0] += d1[0] - d0[0]
                disp[1] += d1[1] - d0[1]
    # every iteration appends coord()'s then zero()'s enqueue loop; keep
    # the timed iterations' default-threshold ones
    out["coordinator_enqueue_ms"] = float(np.median(enqueue_ms[2::2]))
    out["sync_ms"] = {k: float(np.median(v)) for k, v in ms.items()}
    out["sync_ms_all"] = ms
    out["cycles_per_sync"] = {k: v[1] / CP_SYNC_ITERS for k, v in cyc.items()}
    out["cycle_host_ms"] = {k: (v[0] / v[1] * 1e3 if v[1] else None)
                            for k, v in cyc.items()}
    out["bin_dispatch_host_ms"] = disp[0] / disp[1] * 1e3 if disp[1] \
        else None


def cp_int_burst(htt, rank, world, dev, shapes, out):
    """The step's gradient shapes as a burst of integer-valued tensors
    (each rank's from its own seed), Sum through the coordinator, exact
    against the plain sum of every rank's inputs; the timeline of that
    burst, which must load with json."""
    path = os.path.join(CP_ROOT, f"timeline-rank{rank}.json")
    os.makedirs(CP_ROOT, exist_ok=True)
    htt.start_timeline(path)
    try:
        mine = []
        hs = []
        for i, shp in enumerate(shapes):
            g = torch.Generator(device=dev).manual_seed(7000 + 1000 * rank + i)
            x = _int_valued(g, shp, dev)
            mine.append(x)
            hs.append(htt.allreduce_async(x, op=htt.Sum, name=f"int.{i}"))
        got = [htt.synchronize(h) for h in hs]
    finally:
        htt.stop_timeline()
    for i, shp in enumerate(shapes):
        want = torch.zeros(shp, device=dev)
        for r in range(world):
            g = torch.Generator(device=dev).manual_seed(7000 + 1000 * r + i)
            want += _int_valued(g, shp, dev)
        if not torch.equal(got[i], want):
            raise AssertionError(f"integer burst tensor {i} {tuple(shp)}: "
                                 f"the coordinator's sum is not exact")
    events = json.load(open(path))
    cats = {e.get("cat") for e in events if isinstance(e, dict)}
    if not {"QUEUE", "DISPATCH"} <= cats:
        raise AssertionError(f"timeline {path}: categories {cats}")
    out["int_burst_exact"] = len(shapes)
    out["timeline_events"] = len(events)


def cp_divergence(htt, rank, world, knobs, dev, out):
    """The check's cost per flush (CP_DIV_FLUSHES one-tensor flushes at
    HOROVOD_DIVERGENCE_CHECK_EVERY=1: the first three, each an exchange,
    and the last 16 once the interval has widened), then two drills, in
    each of which rank 1 enqueues a tensor the others never do and every
    rank must raise DivergenceError naming it within CP_DIV_TIMEOUT
    seconds: at the widened interval, on the flush after a check (the
    others dispatch it unchecked and wait in its allreduce; rank 1 then
    enters that allreduce, so the world goes on), and on a fresh
    coordinator, where every rank checks."""
    from horovod_tpu_torch.ops.divergence import DivergenceError
    from horovod_tpu_torch.runtime.context import get_context
    ctx = get_context()
    small = torch.ones(256, device=dev)
    htt.synchronize(htt.allreduce_async(small, name="div.probe"))
    chk = ctx.coordinator.divergence_checker
    orig, rows = chk.observe, []

    def timed(idx, entries):
        t0 = time.perf_counter()
        orig(idx, entries)
        rows.append(((time.perf_counter() - t0) * 1e3,
                     chk.effective_interval, chk.checks))

    chk.observe = timed
    try:
        for _ in range(CP_DIV_FLUSHES):
            htt.synchronize(htt.allreduce_async(small, name="div.probe"))
    finally:
        chk.observe = orig
    out["divergence_check_ms_per_flush"] = {
        "interval_1": float(np.mean([r[0] for r in rows[:3]])),
        "widened": float(np.mean([r[0] for r in rows[-16:]])),
        "widened_interval": rows[-1][1], "checks": rows[-1][2],
        "flushes": len(rows)}
    knobs.set_override("HOROVOD_DIVERGENCE_TIMEOUT", CP_DIV_TIMEOUT)
    while chk._since_check != 0:        # to the flush after a check
        htt.synchronize(htt.allreduce_async(small, name="div.probe"))
    interval = chk.effective_interval
    t0 = time.perf_counter()
    try:
        if rank == 1:
            htt.allreduce_async(small, name="cp.late")
        htt.synchronize(htt.allreduce_async(small, name="div.probe"))
        raise AssertionError("a divergent enqueue at a widened interval "
                             "raised nothing")
    except DivergenceError as e:
        msg, secs = str(e), time.perf_counter() - t0
    finally:
        if rank == 1:           # the others' allreduce is in flight
            htt.allreduce(small, name="cp.release")
    if "cp.late" not in msg or secs >= CP_DIV_TIMEOUT:
        raise AssertionError(f"widened divergence drill: {secs:.1f} s, {msg}")
    out["divergence_drill_widened"] = {"interval": interval, "seconds": secs,
                                       "message": msg[:200]}
    # the drill on a fresh coordinator (a fresh key prefix)
    ctx.coordinator.shutdown()
    ctx.coordinator = None
    t0 = time.perf_counter()
    try:
        if rank == 1:
            htt.allreduce_async(small, name="cp.extra")
        htt.synchronize(htt.allreduce_async(small, name="cp.shared"))
        raise AssertionError("a divergent enqueue raised nothing")
    except DivergenceError as e:
        msg, secs = str(e), time.perf_counter() - t0
    finally:
        knobs.clear_override("HOROVOD_DIVERGENCE_TIMEOUT")
        ctx.coordinator.shutdown()
        ctx.coordinator = None
    if "cp.extra" not in msg or secs >= CP_DIV_TIMEOUT:
        raise AssertionError(f"divergence drill: {secs:.1f} s, {msg}")
    out["divergence_drill"] = {"seconds": secs, "message": msg[:160]}


def control_plane_rank(rank, world, ports, results, device="cuda",
                       batch=RESNET_B, image=224):
    """One rank of the N-card control-plane world (deterministic dispatch
    with the divergence check); rank 0 puts its numbers on ``results``."""
    import torch.distributed as dist
    join_store_world(rank, world, ports, device)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import conv_bn as cb
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = htt.init(device=device)
    dev = ctx.device
    sync = (torch.cuda.synchronize if dev.type == "cuda" else
            (lambda: None))
    out = {"world": world, "batch_per_rank": batch, "image": image}
    t0 = time.perf_counter()
    params = cp_resnet_steps(htt, C, cb, rank, world, dev, sync, batch,
                             image, out)
    out["deterministic"] = ctx.coordinator.deterministic
    cp_sync_times(htt, C, knobs, [p.grad for p in params], sync, out)
    cp_int_burst(htt, rank, world, dev, [tuple(p.shape) for p in params],
                 out)
    del params
    cp_divergence(htt, rank, world, knobs, dev, out)
    out["seconds"] = time.perf_counter() - t0
    if rank == 0:
        results.put(out)
    htt.shutdown()
    dist.destroy_process_group()


def control_plane_world(n, card, **kw) -> None:
    """``control_plane_rank`` in ``n`` spawned processes; the ``control
    plane data parallel:`` line."""
    (out,) = spawn_world(control_plane_rank, n, 1, 900, **kw)
    out["card"] = card
    log("control plane data parallel: " + json.dumps(out))


def control_plane_world_one(htt, cb, card, dev="cuda", batch=RESNET_B,
                            image=224) -> None:
    """Phase 10 in a world of one (the coordinator's cycle thread): the
    native core's status, ResNet-50 through ``allreduce_async`` from the
    gradient hooks bitwise equal to ``DistributedOptimizer``, the three
    syncs timed, and the integer burst with its timeline (``control
    plane (world 1):`` line)."""
    from horovod_tpu_torch import native
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops import collectives as C
    status = native.status()
    log("native core: " + json.dumps(status))
    if not status["available"]:
        raise AssertionError(f"native core: {status['build_error']}")
    t0 = time.perf_counter()
    ctx = htt.init(device=dev)
    try:
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        out = {"backend": ctx.backend}
        params = cp_resnet_steps(htt, C, cb, 0, 1, ctx.device, sync, batch,
                                 image, out)
        out["cycle_thread"] = ctx.coordinator._thread is not None
        cp_sync_times(htt, C, knobs, [p.grad for p in params], sync, out)
        cp_int_burst(htt, 0, 1, ctx.device, [tuple(p.shape)
                                             for p in params], out)
        del params
    finally:
        htt.shutdown()
    out.update(seconds=time.perf_counter() - t0, card=card)
    log("control plane (world 1): " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 2: the paged-decode kernel at the speculative verify geometry
# ---------------------------------------------------------------------------

SPEC_K = 4                  # HOROVOD_SERVE_SPEC_K's default
SPEC_TRUNCATE = 4           # truncate:4, 4 of the flagship's 16 layers


def check_kernel_verify(fa, kvc, gen):
    """The paged-decode kernel at the verify step's geometry: 8 slots'
    block tables each repeated K+1 = 5 times (40 rows), row i of a slot at
    length len_s + 1 + i (the decode body attends with lengths + 1), slot
    1's last three rows past n_max * page (the kernel clamps them to the
    table), slot 3 empty (length 0: exact zeros); bf16, the flagship's
    heads (H = KVH = 16, D = 64), page 128, n_max 16. Held against its
    plain version; the 40 rows' first copies must equal, bit for bit, the
    kernel on the 8 slots alone (its rows are independent of M). Device
    ms and the bound beside it: each slot's K/V rows read once (up to its
    longest row), though the kernel reads them once a row."""
    slots, k1, h, d, page, n_max = 8, SPEC_K + 1, 16, 64, 128, 16
    base = [1, 2046, 300, 0, 1024, 1537, 128, 777]
    lengths = [0 if b == 0 else b + 1 + i for b in base for i in range(k1)]
    q, pools, bt8, _ = paged_case(gen, b=slots * k1, h=h, kvh=h, d=d,
                                  page=page, n_max=n_max, lengths=lengths,
                                  dtype=torch.bfloat16, copies=1)
    kp, vp = pools[0]
    bt = bt8[:slots].repeat_interleave(k1, dim=0).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=q.device)
    scale = d ** -0.5
    out = fa.flash_paged_decode(q, kp, vp, bt, ln, scale)
    ref = kvc.paged_attention_reference(q, kp, vp, bt, ln, scale)
    err = float((out - ref).abs().max())
    first = slice(0, slots * k1, k1)
    alone = fa.flash_paged_decode(q[first].contiguous(), kp, vp,
                                  bt[first].contiguous(),
                                  ln[first].contiguous(), scale)
    res = {"rows": slots * k1, "lengths": lengths, "max_abs_err": err,
           "tol": TOL[torch.bfloat16],
           "rows_equal_at_m8_and_m40": bool(torch.equal(out[first], alone)),
           "ms": call_device_ms(lambda: fa.flash_paged_decode(
               q, kp, vp, bt, ln, scale), 20),
           "bound_ms": kernel_bound_ms(
               q, kp, ln, n_max * page,
               kv_lengths=ln.view(slots, k1).max(dim=1).values)}
    log("paged_decode verify geometry (bf16, 8 slots x K+1=5 rows, H=KVH=16,"
        " D=64): " + json.dumps(res))
    if not torch.isfinite(out).all() or err > TOL[torch.bfloat16]:
        raise AssertionError(f"paged_decode at the verify geometry "
                             f"disagrees with its plain version: {err}")
    if not bool((out[3 * k1:4 * k1] == 0).all()):
        raise AssertionError("verify geometry: empty slot is not zeros")
    return res


# ---------------------------------------------------------------------------
# phase 11: the model zoo
# ---------------------------------------------------------------------------

ZOO_STEPS = 4
# Images per card: BENCH_VGG16.json's and BENCH_INCEPTION3.json's
# batch_per_chip, RESNET_B for the ResNets.
VGG_B, INCEPTION_B = 128, 256
ZOO = {
    "vgg16": dict(model="VGG-16", image=224, batch=VGG_B,
                  fwd_gflop=15.47),
    "inception3": dict(model="Inception V3", image=299, batch=INCEPTION_B,
                       fwd_gflop=5.73),
    "resnet50_folded_bn": dict(model="ResNet-50 folded_bn (bench.py)",
                               image=224, batch=RESNET_B,
                               fwd_gflop=RESNET_FWD_FLOPS / 1e9),
    "resnet50": dict(model="ResNet-50", image=224, batch=RESNET_B,
                     fwd_gflop=RESNET_FWD_FLOPS / 1e9),
    "resnet50_s2d_folded_bn": dict(
        model="ResNet-50 space_to_depth folded_bn", image=224,
        batch=RESNET_B, fwd_gflop=RESNET_FWD_FLOPS / 1e9)}


def zoo_model(htt, name, dev, seed, **kw):
    """One of ZOO's models, bf16 compute, 1000 classes, weights from
    ``seed``."""
    from horovod_tpu_torch import models
    kw = dict(num_classes=1000, dtype=torch.bfloat16, device=dev,
              seed=seed, **kw)
    if name == "vgg16":
        return models.VGG16(image=ZOO[name]["image"], **kw)
    if name == "inception3":
        return models.InceptionV3(**kw)
    return htt.ResNet50(folded_bn="folded_bn" in name,
                        space_to_depth="s2d" in name, **kw)


def zoo_step(htt, dev, name, seed):
    """``zoo_model`` with SGD(0.01, momentum 0.9) through
    ``DistributedOptimizer`` and ``data_parallel_train_step``."""
    model = zoo_model(htt, name, dev, seed)
    opt = htt.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.01, momentum=0.9), op=htt.Average)
    init_fn, step, put_batch = htt.data_parallel_train_step(
        resnet_loss, opt, device=dev)
    return init_fn(model), step, put_batch


def zoo_train_one(htt, name, card):
    """ZOO_STEPS timed steps (after a warm-up) of one model on one card,
    then one profiled step: step ms (median, range), images/s, peak
    memory, the device's busy share and kernel launches of the profiled
    step."""
    spec = ZOO[name]
    state, step, put_batch = zoo_step(htt, "cuda", name, seed=0)
    batches = resnet_batches(put_batch, ZOO_STEPS + 2, spec["batch"],
                             "cuda", image=spec["image"])
    state, loss = step(state, *batches[0])                  # warm-up
    losses = [float(loss)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = [time.perf_counter()]
    for batch in batches[1:-1]:
        state, loss = step(state, *batch)
        losses.append(float(loss))                           # synchronizes
        stamps.append(time.perf_counter())
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_train_step(step, state, batches[-1], card,
                              label=f"zoo profile {name}")
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    ms = np.diff(stamps) * 1e3
    med = float(np.median(ms))
    n_params = sum(p.numel() for p in state.params.parameters())
    line = {
        "model": spec["model"], "parameters": n_params,
        "image": spec["image"], "batch": spec["batch"],
        "dtype": "bf16", "steps": ZOO_STEPS, "losses": losses,
        "step_ms": [float(x) for x in ms], "step_ms_median": med,
        "step_ms_range": [float(ms.min()), float(ms.max())],
        "images_per_s": spec["batch"] / med * 1e3,
        "mfu": (spec["batch"] / med * 1e3 * 3 * spec["fwd_gflop"] * 1e9
                / BF16_FLOPS_PER_S),
        "peak_memory_gb": peak_gb,
        "device_busy_share": prof["device_busy_share"],
        "kernel_launches_per_step": prof["kernel_launches"],
        "card": card}
    log(f"zoo train {name}: " + json.dumps(line))
    del state, step, batches
    torch.cuda.empty_cache()
    return line


def zoo_one_card(htt, card) -> dict:
    """Phase 11: every ZOO model through an NCCL world of one, then the
    narrow f32 models card against CPU."""
    ctx = htt.init()
    if ctx.backend != "nccl" or htt.size() != 1:
        raise AssertionError(f"expected an NCCL world of one, got "
                             f"{ctx.backend} x {htt.size()}")
    try:
        out = {name: zoo_train_one(htt, name, card) for name in ZOO}
    finally:
        htt.shutdown()
    folded = out["resnet50_folded_bn"]["step_ms_median"]
    plain = out["resnet50"]["step_ms_median"]
    log("zoo folded_bn against batch norm (ResNet-50, 128 x 224^2 bf16): "
        + json.dumps({"folded_step_ms": folded, "plain_step_ms": plain,
                      "folded_over_plain": folded / plain,
                      "s2d_folded_step_ms": out[
                          "resnet50_s2d_folded_bn"]["step_ms_median"],
                      "card": card}))
    zoo_card_vs_cpu(htt)
    return out


def zoo_card_vs_cpu(htt) -> None:
    """The narrow f32 zoo, card against CPU on the same weights and batch:
    VGG-11 at 32^2 (classifier_width 64) and ResNet-18 with the
    space-to-depth stem and folded batch norm at 64^2, each in train mode
    (logits, running statistics, every gradient); Inception V3 at 75^2,
    batch 2, in eval mode (logits and every gradient; on the initial
    running statistics), then in train mode part by part
    (``inception_blocks_card_vs_cpu``)."""
    from horovod_tpu_torch.models import inception, vgg
    cases = [
        ("VGG-11 32^2", lambda d: vgg.VGG11(
            num_classes=10, dtype=torch.float32, classifier_width=64,
            image=32, device=d, seed=3), 32, True),
        ("ResNet-18 s2d folded_bn 64^2", lambda d: htt.ResNet18(
            num_classes=10, dtype=torch.float32, space_to_depth=True,
            folded_bn=True, device=d, seed=3), 64, True),
        ("Inception V3 75^2 eval", lambda d: inception.InceptionV3(
            num_classes=10, dtype=torch.float32, device=d, seed=3), 75,
         False)]

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    result = {}
    for label, make, side, train in cases:
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.standard_normal((2, side, side, 3)).astype(
            np.float32))
        y = torch.from_numpy(rng.integers(0, 10, (2,)))
        runs = {}
        for dev in ("cpu", "cuda"):
            model = make(dev)
            logits = model(x.to(dev), train=train)
            torch.nn.functional.cross_entropy(logits, y.to(dev)).backward()
            stats = dict(model.named_buffers()) if train else {}
            runs[dev] = (logits.detach().cpu(),
                         {n: b.detach().cpu() for n, b in stats.items()},
                         [p.grad.detach().cpu() for p in model.parameters()])
        (lc, sc, gc), (lg, sg, gg) = runs["cpu"], runs["cuda"]
        res = {"logits": rel(lg, lc), "gradients": max(
            rel(a, b) for a, b in zip(gg, gc))}
        if sc:
            res["running_stats"] = max(rel(sg[n], sc[n]) for n in sc)
        result[label] = res
        for k_, v_ in res.items():
            if not v_ <= RESNET_REL_TOL[k_]:
                raise AssertionError(f"zoo card vs cpu {label}: {k_} "
                                     f"differ: {v_}")
    log("zoo card vs cpu (f32, batch 2): worst relative difference "
        + json.dumps(result) + f" (tol {RESNET_REL_TOL})")
    inception_blocks_card_vs_cpu()


# Spatial side of each Inception block's input in the train-mode check:
# batch norm then sees at least 2 x 3 x 3 positions (at 75^2 the E blocks
# see 1 x 1 maps, two positions a batch; see
# tests/test_torch_zoo_inception.py).
INCEPTION_BLOCK_SIDE = {"A": 9, "B": 9, "C": 7, "D": 7, "E": 5}
# The limit for the weight gradients of InceptionA's 5x5 convs: on a
# channels-last view at batch 2, cuDNN's f32 weight-gradient algorithm
# (torch 2.11, cuDNN 9.2, TF32 off; an H100) is 1.1e-3 to 4.1e-3 off an
# f64 reference, where NCHW-contiguous input, cuDNN off or batch 8 is
# within 2e-6 (tools/zoo_numerics.py; ROADMAP C). One bf16 step at 1.0,
# 2^-7: below what the zoo trains in.
CONV5X5_WGRAD_TOL = 2.0 ** -7


def inception_blocks_card_vs_cpu() -> None:
    """Inception V3 (f32, seed 3) in train mode on the card, part by part
    on seeded standard-normal inputs, batch 2: each layer of the stem at
    its 75^2 shapes (BasicConv_0-4 and the two 3x3/2 max pools), then each
    of the eleven InceptionA-E blocks at INCEPTION_BLOCK_SIDE. Each part is
    held against the same part, on the same parameters, on the CPU in f64:
    its output, its running statistics, and the gradients of a seeded
    weighted sum of the output (every parameter of the part, and the
    input), each relative to the reference's largest value, at ResNet's
    limits (the 5x5 kernels' gradients at CONV5X5_WGRAD_TOL).

    Why f64 and part by part: a pre-ReLU value within f32 rounding of
    zero takes the other side of the kink on one device, and the
    gradient of the whole path behind it moves by percents. The CPU's
    f32 did so once in InceptionC_1 (15.8 %; the card agreed with f64
    to 2.1e-6), and the card once in the stem run whole on its own
    post-ReLU activations (4.1 %; the CPU's f32 within 3.5e-6 of f64;
    tools/zoo_numerics.py)."""
    from horovod_tpu_torch.models import inception
    models = {d: inception.InceptionV3(num_classes=10, dtype=dt, device=d,
                                       seed=3)
              for d, dt in (("cpu", torch.float64), ("cuda", torch.float32))}
    ref = models["cpu"]

    def pool(m, x, train):
        return inception.max_pool_nhwc(x, 3, 2)

    parts, side, cin, i = [], 75, 3, 0
    for spec in ref._stem:
        if spec is None:
            parts.append((f"stem max_pool {side}^2", pool, lambda m: [],
                          (2, side, side, cin)))
            side = (side - 3) // 2 + 1
            continue
        name = f"BasicConv_{i}"
        conv = getattr(ref, name)
        parts.append((name,
                      lambda m, x, train, n=name: getattr(m, n)(x, train),
                      lambda m, n=name: [getattr(m, n)],
                      (2, side, side, cin)))
        features, kernel, strides, padding = spec
        if padding == "VALID":
            side = (side - kernel[0]) // strides[0] + 1
        cin, i = conv.out_channels, i + 1
    for name in ref.block_names:
        side = INCEPTION_BLOCK_SIDE[name[len("Inception")]]
        parts.append((name,
                      lambda m, x, train, n=name: getattr(m, n)(x, train),
                      lambda m, n=name: [getattr(m, n)],
                      (2, side, side, cin)))
        cin = getattr(ref, name).out_channels

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / max(
            float(b.abs().max()), 1e-30)

    result = {}
    for k, (label, fn, mods, shape) in enumerate(parts):
        rng = np.random.default_rng(100 + k)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        w = None
        runs = {}
        for dev, m in models.items():
            dt = torch.float64 if dev == "cpu" else torch.float32
            xd = x.detach().to(dev, dt).requires_grad_(True)     # a leaf
            y = fn(m, xd, True)
            if w is None:
                w = torch.from_numpy(rng.standard_normal(
                    tuple(y.shape)).astype(np.float32))
            (y * w.to(dev, dt)).sum().backward()
            ps = [p for mod in mods(m) for p in mod.parameters()]
            bs = [b for mod in mods(m) for b in mod.buffers()]
            runs[dev] = (y.detach().cpu(), [b.detach().cpu() for b in bs],
                         [p.grad.detach().cpu() for p in ps]
                         + [xd.grad.detach().cpu()])
        (yc, sc, gc), (yg, sg, gg) = runs["cpu"], runs["cuda"]
        five = [a.shape[:2] == (5, 5) for a in gc]
        res = {"logits": rel(yg, yc),
               "running_stats": max((rel(a, b) for a, b in zip(sg, sc)),
                                    default=0.0),
               "gradients": max(rel(a, b) for a, b, f in zip(gg, gc, five)
                                if not f)}
        tol = dict(RESNET_REL_TOL)
        if any(five):
            res["gradients_5x5_kernels"] = max(
                rel(a, b) for a, b, f in zip(gg, gc, five) if f)
            tol["gradients_5x5_kernels"] = CONV5X5_WGRAD_TOL
        result[label] = res
        for k_, v_ in res.items():
            if not v_ <= tol[k_]:
                raise AssertionError(f"Inception V3 train mode card vs cpu "
                                     f"f64 {label}: {k_} differ: {v_}")
    log("zoo card vs cpu Inception V3 train mode part by part (card f32 "
        "against cpu f64, batch 2; 'logits' is the part's output): worst "
        "relative difference " + json.dumps(result) + f" (tol "
        f"{RESNET_REL_TOL}, 5x5 kernels' gradients {CONV5X5_WGRAD_TOL})")


# ---------------------------------------------------------------------------
# phase 12: speculative serving and the train-to-serve handoff
# ---------------------------------------------------------------------------

def serve_run(eng, reqs, fa):
    """The scheduler over ``reqs`` on ``eng``: (done, stats, wall s,
    paged-decode launches), after a two-request warm-up."""
    from horovod_tpu_torch.serving import ServeScheduler
    ServeScheduler(eng, device="cuda").run(mp_serve_requests(
        eng.cfg.vocab_size, n=2, new_tokens=8, seed=9, lo=40, hi=60))
    torch.cuda.synchronize()
    sched = ServeScheduler(eng, mode="continuous", device="cuda")
    fa.reset_launches()
    t0 = time.perf_counter()
    done = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != len(reqs) or any(r.error for r in done):
        raise AssertionError([r.error for r in done if r.error])
    return done, sched.stats(), wall, fa.LAUNCHES["paged_decode"]


def op_rows_probe(eng, cfg, gen):
    """Where a verify row (M = slots * (K+1)) first departs from its decode
    row (M = slots): each operation of the decode body, in its order, on
    the same 8 input rows alone and tiled K+1 times, on layer 0's weights;
    for each, whether the first copy's rows are bitwise the rows computed
    alone, and the largest difference. ``mlp_chunked`` is the MLP as the
    verify step runs it, its output product in chunks of ``slots`` rows."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel import tensor_parallel as tp_lib
    from horovod_tpu_torch.serving import engine as E
    lp = E._layer(eng.params, 0)
    s, k1, d = eng.slots, eng.spec_k + 1, cfg.d_model
    x = torch.randn((s, d), generator=gen, device="cuda").to(cfg.dtype)
    a = torch.randn((s, cfg.n_heads * cfg.head_dim), generator=gen,
                    device="cuda").to(cfg.dtype)
    u = torch.randn((s, cfg.d_ff), generator=gen, device="cuda").to(
        cfg.dtype)
    ops = [("rmsnorm", x, lambda t: tfm._rmsnorm(t, lp["attn_norm"])),
           ("q_projection", x, lambda t: E._qkv(cfg, lp, t)[0]),
           ("o_projection", a, lambda t: tp_lib.row_parallel(
               t, lp["wo"], None)),
           ("mlp_in", x, lambda t: tp_lib.column_parallel(t, lp["w_in"])),
           ("mlp_out", u, lambda t: tp_lib.row_parallel(t, lp["w_out"],
                                                        None)),
           ("mlp", x, lambda t: E._mlp(cfg, lp, t)),
           ("mlp_chunked", x, lambda t: E._mlp(cfg, lp, t, s)),
           ("head", x, lambda t: E._gather_logits(cfg, t,
                                                  eng.params["head"]))]
    out = []
    for name, inp, fn in ops:
        alone = fn(inp)
        tiled = fn(inp.repeat(k1, 1))[:s]
        out.append({"op": name, "bitwise_equal": bool(torch.equal(alone,
                                                                  tiled)),
                    "max_abs_diff": float((alone.float() - tiled.float()
                                           ).abs().max())})
    return out


def verify_vs_decode(htt, cfg, params, reqs, off_tokens, gen):
    """The same prefixes through a decode step (M = 8) and a verify row (M
    = 40): 8 requests prefilled in a plain engine and in a speculative one
    (ngram:3, K = SPEC_K); the plain engine then decodes K+1 steps fed
    the off run's tokens, and the speculative one runs ONE verify step
    whose drafts are those tokens, so verify row (s, i) and decode step i
    of slot s see the same prefix. Per step i: the largest |logit
    difference| over the slots, and whether the rows are bitwise equal;
    then the per-operation probe, and the verify step's body timed with
    its GEMMs and norm means whole and in chunks of ``slots`` rows."""
    from horovod_tpu_torch.serving import ServeEngine
    k = SPEC_K
    off = ServeEngine(cfg, params, device="cuda")
    spec = ServeEngine(cfg, params, device="cuda", draft="ngram:3",
                       spec_k=k)
    slots = []
    for r in reqs[:off.slots]:
        for eng in (off, spec):
            s = eng.reserve(r.prompt.size + len(off_tokens[r.rid]))
            if eng.prefill(s, r.prompt) != off_tokens[r.rid][0]:
                raise AssertionError(f"request {r.rid}: prefill token "
                                     f"differs from the off run's")
        slots.append((s, r.rid))
    toks = np.zeros((off.slots, k + 1), np.int32)
    for s, rid in slots:
        toks[s] = off_tokens[rid][:k + 1]
    dec = []
    for i in range(k + 1):
        off.decode_step(toks[:, i])
        dec.append(off.last_logits.float().clone())
    spec.spec_step(toks[:, 0], toks[:, 1:])
    ver = spec.last_logits.float().reshape(off.slots, k + 1, -1)
    steps = [{"step": i, "max_abs_logit_diff": float(
        (ver[:, i] - dec[i]).abs().max()),
        "bitwise_equal": bool(torch.equal(ver[:, i], dec[i]))}
        for i in range(k + 1)]
    probe = op_rows_probe(spec, cfg, gen)
    timing = verify_body_times(spec, toks)
    del off, spec
    torch.cuda.empty_cache()
    return steps, probe, timing


def verify_body_times(eng, toks):
    """The verify step's body at its geometry (``slots * (K+1)`` rows on
    the engine's live tables) with its GEMMs and norm means whole, as
    before the repair, and in chunks of ``slots`` rows, as ``spec_step`` runs
    it: device ms and kernel launches a step from torch.profiler, and ms
    a step by CUDA events (host launch cost included)."""
    from horovod_tpu_torch.serving import engine as E
    k, s = eng.spec_k, eng.slots
    bt = np.repeat(eng.tables.tables, k + 1, axis=0)
    ln = (np.repeat(eng.tables.lengths, k + 1)
          + np.tile(np.arange(k + 1, dtype=np.int32), s)).astype(np.int32)
    args = (eng.cfg, eng.params, eng.k_pages, eng.v_pages,
            eng._tensor(bt), eng._tensor(ln),
            eng._tensor(np.asarray(toks, np.int32).reshape(-1)))
    out = {}
    with torch.inference_mode():
        for name, rows in (("whole", None), ("chunked", s)):
            def body(rows=rows):
                return E._decode_body(*args, rows=rows)
            prof = profiled_rows(body, 5)
            out[name] = {
                "device_ms": sum(r[0] for r in prof) / 1e3 / 5,
                "launches": sum(r[2] for r in prof) / 5,
                "event_ms": cuda_ms(lambda i: body(), 10)}
    out["extra_launches"] = (out["chunked"]["launches"]
                             - out["whole"]["launches"])
    return out


def truncate_draft_vs_plain(htt, cfg, params, reqs) -> dict:
    """The truncate:SPEC_TRUNCATE draft against a plain engine on the
    model cut to its first SPEC_TRUNCATE layers (the same leaves, the
    same final norm and head): 8 requests prefilled in both; the draft
    engine's ``propose_drafts`` from the full model's first token must
    give, bitwise, the tokens the plain engine decodes greedily from
    that token (its layers' K/V below the prompt's end are the full
    model's first layers'). Random weights accept no draft, so this is
    what shows the draft computes the right tokens on the card."""
    from horovod_tpu_torch.serving import ServeEngine
    n, k = SPEC_TRUNCATE, SPEC_K
    cut_cfg = flagship_cfg(htt.TransformerConfig, n_layers=n)
    cut = {**params, "layers": {name: leaf[:n] for name, leaf
                                in params["layers"].items()}}
    draft = ServeEngine(cfg, params, device="cuda",
                        draft=f"truncate:{n}", spec_k=k)
    plain = ServeEngine(cut_cfg, cut, device="cuda")
    first = np.zeros(draft.slots, np.int32)
    for r in reqs[:draft.slots]:
        s = draft.reserve(r.prompt.size + k + 1)
        first[s] = draft.prefill(s, r.prompt)
        if plain.reserve(r.prompt.size + k + 1) != s:
            raise AssertionError("truncate draft check: slots differ")
        plain.prefill(s, r.prompt)
    active = np.ones(draft.slots, bool)
    drafts = draft.propose_drafts(first, active)
    want, toks = [], first
    for _ in range(k):
        toks = plain.decode_step(toks)
        want.append(toks)
    want = np.stack(want, axis=1)
    line = {"n_layers": n, "k": k, "slots": int(draft.slots),
            "tokens_equal": bool(np.array_equal(drafts, want)),
            "last_step_logits_bitwise_equal": bool(torch.equal(
                draft.last_logits, plain.last_logits)),
            "last_step_max_abs_logit_diff": float(
                (draft.last_logits.float() - plain.last_logits.float()
                 ).abs().max())}
    del draft, plain, cut
    torch.cuda.empty_cache()
    if not line["tokens_equal"]:
        raise AssertionError(f"truncate:{n} drafts {drafts.tolist()} differ "
                             f"from the {n}-layer model's greedy tokens "
                             f"{want.tolist()}")
    return line


def spec_serving(htt, fa, card, handoff) -> dict:
    """Phase 12: the flagship at full width and depth, serve traffic (16
    requests of 64-1024 prompt tokens, 32 new tokens each, knob defaults)
    in three modes, off, ngram:3 and truncate:SPEC_TRUNCATE, each at K =
    SPEC_K, every request's tokens required equal to the off run's; then
    the verify-against-decode rows (required bitwise) and the truncated
    draft against the cut model; then the train-to-serve handoff of phase
    4's snapshot."""
    from horovod_tpu_torch.serving import ServeEngine
    cfg = flagship_cfg(htt.TransformerConfig)
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    modes = ["off", "ngram:3", f"truncate:{SPEC_TRUNCATE}"]
    runs, tokens = {}, {}
    for mode in modes:
        eng = ServeEngine(cfg, params, device="cuda", draft=mode,
                          spec_k=SPEC_K)
        done, st, wall, launches = serve_run(
            eng, mp_serve_requests(cfg.vocab_size), fa)
        tokens[mode] = {r.rid: list(r.tokens) for r in done}
        if any(len(t) != 32 for t in tokens[mode].values()):
            raise AssertionError(f"{mode}: not every request has 32 tokens")
        tpot = [t * 1e3 for r in done for t in r.tpot]
        gen_tokens = st["generated_tokens"]
        runs[mode] = {
            "decode_tokens_per_s": gen_tokens / wall, "wall_s": wall,
            "decode_steps": st["decode_steps"],
            "tokens_per_decode_step": (gen_tokens - len(done))
            / st["decode_steps"],
            "tpot_ms_p50": pct(tpot, 50), "tpot_ms_p99": pct(tpot, 99),
            "acceptance_rate": (st["spec"] or {}).get("acceptance_rate"),
            "proposed": (st["spec"] or {}).get("proposed"),
            "accepted": (st["spec"] or {}).get("accepted"),
            "paged_decode_launches": launches}
        if launches < cfg.n_layers * st["decode_steps"]:
            raise AssertionError(f"{mode}: paged_decode launched "
                                 f"{launches} times")
        del eng
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(7)
    steps, probe, verify_times = verify_vs_decode(
        htt, cfg, params, mp_serve_requests(cfg.vocab_size), tokens["off"],
        gen)
    row_diff = max(x["max_abs_logit_diff"] for x in steps)
    truncate_check = truncate_draft_vs_plain(
        htt, cfg, params, mp_serve_requests(cfg.vocab_size))
    faults = []
    for mode in modes[1:]:
        same = [rid for rid in tokens["off"]
                if tokens[mode][rid] == tokens["off"][rid]]
        runs[mode]["equal_to_off_share"] = len(same) / len(tokens["off"])
        diverged = []
        for rid, want in tokens["off"].items():
            got = tokens[mode][rid]
            p = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
            if p is None:
                continue
            diverged.append({"rid": rid, "position": p,
                             "token": got[p], "off_token": want[p]})
            faults.append((mode, diverged[-1]))
        runs[mode]["divergences"] = diverged
    first_diff = next((x for x in probe if not x["bitwise_equal"]), None)
    line = {"model": "flagship TransformerLM", "k": SPEC_K,
            "requests": 16, "new_tokens": 32, "modes": runs,
            "verify_vs_decode_rows": steps,
            "verify_vs_decode_max_abs_logit_diff": row_diff,
            "verify_body_whole_vs_chunked": verify_times,
            "first_step_max_abs_logit_diff": steps[0]["max_abs_logit_diff"],
            "op_probe_m8_vs_m40": probe,
            "first_op_that_differs": first_diff and first_diff["op"],
            "truncate_draft_vs_cut_model": truncate_check,
            "card": card}
    log("spec serving: " + json.dumps(line))
    if not all(x["bitwise_equal"] for x in steps):
        raise AssertionError(f"verify rows are not the decode rows bit for "
                             f"bit: {steps}")
    if faults:
        raise AssertionError(f"speculative tokens part from the off run: "
                             f"{faults}")
    serve_handoff(htt, cfg, handoff, fa, card)
    return line


def serve_handoff(htt, cfg, handoff, fa, card) -> None:
    """``load_for_serving`` of phase 4's committed snapshot: the restored
    parameters bitwise the ones the snapshot was taken of, and an engine
    built from them gives the tokens, bitwise, of an engine built from
    those parameters directly."""
    import shutil
    from horovod_tpu_torch.serving import ServeEngine, load_for_serving
    from horovod_tpu_torch.utils import tree as tree_util
    try:
        t0 = time.perf_counter()
        step, restored = load_for_serving(handoff["dir"], cfg,
                                          device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        direct = tree_util.tree_map(lambda t: t.to("cuda"),
                                    handoff["params"])
        ra = tree_util.flatten_dict(restored)
        da = tree_util.flatten_dict(direct)
        if step != handoff["step"] or set(ra) != set(da) or not all(
                torch.equal(ra[k], da[k]) for k in ra):
            raise AssertionError(f"handoff: step {step}, restored "
                                 f"parameters differ from the snapshot's")
        toks = []
        for p in (restored, direct):
            eng = ServeEngine(cfg, p, device="cuda")
            done, _, _, _ = serve_run(eng, mp_serve_requests(
                cfg.vocab_size, n=4, new_tokens=16, seed=3), fa)
            toks.append({r.rid: list(r.tokens) for r in done})
            del eng
        line = {"step": step, "load_s": load_s, "leaves": len(ra),
                "tokens_equal": toks[0] == toks[1], "requests": 4,
                "card": card}
        log("serve handoff: " + json.dumps(line))
        if toks[0] != toks[1]:
            raise AssertionError("handoff: the restored engine's tokens "
                                 "differ from the direct engine's")
    finally:
        shutil.rmtree(handoff["dir"], ignore_errors=True)


# ---------------------------------------------------------------------------
# --data-parallel N --zoo-only: VGG-16 and Inception V3 across cards
# ---------------------------------------------------------------------------

ZOO_DP_STEPS = 3
ZOO_DP = [dict(label="vgg16", model="vgg16"),
          dict(label="inception3", model="inception3")]


def zoo_data_parallel(n: int, card: str, **kw) -> None:
    """VGG-16 and Inception V3 at phase 11's batch per card, on one card
    and then on ``n``, ZOO_DP_STEPS timed steps each: every rank's
    parameters bitwise equal after the steps; step ms, scaling efficiency
    (one card's step over N's: the batch per card is the same) and the
    NCCL kernels' device ms of a profiled step."""
    one = run_world(1, ZOO_DP, n_steps=ZOO_DP_STEPS, **kw)
    many = run_world(n, ZOO_DP, n_steps=ZOO_DP_STEPS, **kw)
    for label, res in many.items():
        r1 = one[label]
        line = {"model": ZOO[label]["model"], "world": n,
                "batch_per_card": ZOO[label]["batch"],
                "image": ZOO[label]["image"],
                "step_ms": res["step_ms"],
                "step_ms_mean": res["step_ms_mean"],
                "one_card_step_ms_mean": r1["step_ms_mean"],
                "scaling_efficiency": r1["step_ms_mean"]
                / res["step_ms_mean"],
                "images_per_s": res["images_per_s"],
                "nccl_ms": res["nccl_ms"],
                "nccl_overlapped_ms": res["nccl_overlapped_ms"],
                "compute_ms": res["compute_ms"],
                "sync_buckets": res["sync_buckets"],
                "params_bitwise_equal": res["params_bitwise_equal"],
                "losses": res["losses"], "card": card}
        log(f"zoo data parallel {label}: " + json.dumps(line))
        if not (res["params_bitwise_equal"] and all(
                np.isfinite(x) for x in res["losses"] + r1["losses"])):
            raise AssertionError(f"zoo data parallel {label}: {line}")


# ---------------------------------------------------------------------------
# phase 13: the serving fleet and the metrics export
# ---------------------------------------------------------------------------

FLEET_SLOW_S = 0.002        # replica_slow's delay a dispatch
FLEET_STAGGER_S = 0.05      # arrival offsets of the autoscaler drill


class Scraper:
    """Scrapes ``/metrics`` and ``/healthz`` of the local metrics server
    over loopback every 50 ms while a ``with`` block runs; ``seen`` keeps
    (text, health) of each scrape."""

    def __init__(self, port: int):
        import threading
        self.port = port
        self.seen = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def get(self, path):
        import urllib.request
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                    timeout=10) as r:
            return r.read().decode()

    def _loop(self):
        while not self._stop.is_set():
            self.seen.append((self.get("/metrics"),
                              json.loads(self.get("/healthz"))))
            self._stop.wait(0.05)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def fleet_engine_maker(cfg, params, devices):
    """``make_engine`` of a fleet: replica ``rid`` serves on
    ``devices[rid % len(devices)]``."""
    from horovod_tpu_torch.serving import ServeEngine

    def make(rid):
        return ServeEngine(cfg, params, device=devices[rid % len(devices)])
    return make


def fleet_run(fleet, fa, reqs, parallel=False):
    """``fleet.run(reqs)`` with the paged-decode count set to 0 just
    before and read just after: (done, wall s, launches, decode steps)."""
    def decode_steps():
        return sum(rep.scheduler.stats()["decode_steps"]
                   for rep in fleet.replicas.values())

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    steps0 = decode_steps()
    fa.reset_launches()
    t0 = time.perf_counter()
    done = fleet.run(reqs, parallel=parallel)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    wall = time.perf_counter() - t0
    return done, wall, fa.LAUNCHES["paged_decode"], decode_steps() - steps0


def fleet_check(label, done, bare, rids=None, n_layers=16, launches=None,
                steps=None):
    """Every request served without an error, with the bare engine's
    tokens bitwise (``rids`` maps a request to its bare twin), and the
    paged-decode kernel launched on the path."""
    rids = rids or {r.rid: r.rid for r in done}
    errors = [r.error for r in done if r.error]
    if errors or len(done) != len(rids):
        raise AssertionError(f"{label}: {len(done)} of {len(rids)} served, "
                             f"errors {errors}")
    differ = [r.rid for r in done if list(r.tokens) != bare[rids[r.rid]]]
    if differ:
        raise AssertionError(f"{label}: requests {differ} differ from the "
                             f"bare engine's tokens")
    if launches is not None and (not steps or launches < n_layers * steps):
        raise AssertionError(f"{label}: paged_decode launched {launches} "
                             f"times over {steps} decode steps")


def fleet_latency(done, wall):
    gen = sum(len(r.tokens) for r in done)
    ttft = [r.ttft * 1e3 for r in done]
    tpot = [t * 1e3 for r in done for t in r.tpot]
    return {"decode_tokens_per_s": gen / wall, "wall_s": wall,
            "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
            "tpot_ms_p50": pct(tpot, 50), "tpot_ms_p99": pct(tpot, 99)}


def fleet_joins(fleet):
    return [{"replica": e["replica"], "boot_s": e["boot_s"],
             "builds": e["builds"], "reason": e["reason"]}
            for e in fleet.scale_events if e["event"] == "grow"]


def fleet_bare(htt, fa, cfg, params):
    """The bare one-card engine's tokens for the 16 requests."""
    from horovod_tpu_torch.serving import ServeEngine
    eng = ServeEngine(cfg, params, device="cuda:0")
    done, _, _, _ = serve_run(eng, mp_serve_requests(cfg.vocab_size), fa)
    del eng
    return {r.rid: list(r.tokens) for r in done}


def fleet_world_one(htt, fa, card) -> dict:
    """Phase 13: the flagship at full width and depth (bf16, seed 0) with
    phase 3's traffic (16 requests of 64-1024 prompt tokens, 32 new tokens
    each, knob defaults) through the serving fleet on one card: a fleet of
    one gives the bare engine's tokens bitwise; two replicas on the card
    run the drain drill (nothing dropped, the leaver's pool free), the
    replica_kill drill at the router's dispatch path twice (every request
    served, the same re-admission order) and the replica_slow drill; a
    MetricsServer on a free local port is scraped over loopback while the
    fleet serves (``/metrics`` with ``hvd_serve_*``, ``/healthz`` with the
    serving and fleet blocks)."""
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.resilience import chaos
    from horovod_tpu_torch.serving import Request, ReplicaState, ServingFleet
    cfg = flagship_cfg(htt.TransformerConfig)
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    bare = fleet_bare(htt, fa, cfg, params)
    make = fleet_engine_maker(cfg, params, ["cuda:0"])
    reqs = lambda: mp_serve_requests(cfg.vocab_size)   # noqa: E731
    srv = M.start_metrics_server(0, host="127.0.0.1")
    line = {"model": "flagship TransformerLM", "requests": 16,
            "new_tokens": 32, "card": card}

    # a fleet of one, scraped while it serves
    fleet = ServingFleet(make, replicas=1, max_replicas=1)
    fleet.run(mp_serve_requests(cfg.vocab_size, n=2, new_tokens=8, seed=9,
                                lo=40, hi=60))          # warm-up
    fleet.completed.clear()
    with Scraper(srv.port) as scr:
        done, wall, launches, steps = fleet_run(fleet, fa, reqs())
    fleet_check("fleet of one", done, bare, n_layers=cfg.n_layers,
                launches=launches, steps=steps)
    during = [(t, h) for t, h in scr.seen
              if h.get("fleet") and h.get("serving")]
    if not during or "hvd_serve_tokens_total" not in during[-1][0]:
        raise AssertionError(f"no /metrics and /healthz scrape with the "
                             f"serving and fleet blocks while the fleet "
                             f"served ({len(scr.seen)} scrapes)")
    health = json.loads(scr.get("/healthz"))
    if health["fleet"]["completed"] != 16 or \
            health["fleet"]["members"]["replica-0"]["state"] != "ready":
        raise AssertionError(f"/healthz fleet block: {health['fleet']}")
    line["fleet_of_one"] = {
        **fleet_latency(done, wall), "tokens_equal_bare": True,
        "paged_decode_launches": launches, "decode_steps": steps,
        "joins": fleet_joins(fleet)}
    line["scrape"] = {
        "scrapes_while_serving": len(during),
        "metrics_families_hvd_serve": sorted(
            {ln.split(" ")[2] for ln in during[-1][0].splitlines()
             if ln.startswith("# TYPE hvd_serve_")}),
        "healthz_status": health["status"],
        "healthz_blocks": sorted(health),
        "fleet_members": {m: v["state"] for m, v
                          in health["fleet"]["members"].items()}}
    del fleet

    def two(**kw):
        return ServingFleet(make, replicas=2, max_replicas=2,
                            scale_down_idle=10 ** 9, cooldown=0, **kw)

    # the drain drill
    fleet = two()
    batch = reqs()
    for r in batch:
        fleet.dispatch(r)
    fleet.cycle()
    rep = fleet.replicas[1]
    aboard = len(rep.aboard)
    fleet.drain(1, reason="drill")
    extra = Request(rid=100, prompt=batch[0].prompt.copy(),
                    max_new_tokens=32)
    fleet.dispatch(extra)
    done, wall, launches, steps = fleet_run(fleet, fa, [])
    fleet_check("drain drill", done, bare, rids={**{i: i for i in range(16)},
                                                 100: 0})
    leave = [e for e in fleet.scale_events if e["event"] == "leave"]
    if (rep.state != ReplicaState.LEFT or not aboard or not leave
            or leave[0]["pages_freed"] != rep.engine.pool.n_pages
            or getattr(extra, "_fleet_seq") in rep.aboard):
        raise AssertionError(f"drain drill: state {rep.state}, aboard "
                             f"{aboard}, leave {leave}")
    line["drain_drill"] = {
        "aboard_at_drain": aboard, "served": len(done),
        "pages_freed": leave[0]["pages_freed"],
        "pages_total": leave[0]["pages_total"], "tokens_equal_bare": True,
        "paged_decode_launches": launches}
    del fleet, rep

    # the replica_kill drill at the dispatch path, twice
    kills = []
    for _ in range(2):
        chaos.install({"replica_kill": {"replica": 1, "after_requests": 2}})
        try:
            fleet = two()
            blacklisted = []            # at the registry's death notice
            fleet.registry.register_listener(
                lambda ts, res, reg=fleet.registry: blacklisted.append(
                    reg.is_blacklisted("replica-1")))
            batch = reqs()
            for r in batch:
                r.arrival = 0.0
            done, wall, launches, steps = fleet_run(fleet, fa, batch)
        finally:
            chaos.install(None)
        fleet_check("replica_kill drill", done, bare, n_layers=cfg.n_layers,
                    launches=launches, steps=steps)
        if (fleet.replicas[1].state != ReplicaState.DEAD
                or not fleet.readmissions or blacklisted != [True]):
            raise AssertionError("replica_kill drill: replica 1 did not die "
                                 "and re-admit its requests")
        kills.append({"readmission_log": list(fleet.readmission_log),
                      **fleet_latency(done, wall)})
        del fleet
    if kills[0]["readmission_log"] != kills[1]["readmission_log"]:
        raise AssertionError(f"replica_kill drill: re-admission orders "
                             f"differ: {kills}")
    line["kill_drill"] = {"runs": kills, "tokens_equal_bare": True,
                          "readmission_order_equal": True}

    # the replica_slow drill
    chaos.install({"replica_slow": {"replica": 0, "delay": FLEET_SLOW_S,
                                    "after_requests": 1}})
    try:
        fleet = two()
        done, wall, launches, steps = fleet_run(fleet, fa, reqs())
    finally:
        chaos.install(None)
    fleet_check("replica_slow drill", done, bare, n_layers=cfg.n_layers,
                launches=launches, steps=steps)
    slow = fleet.router.stats()["slow_injected_s"]
    if slow < FLEET_SLOW_S:
        raise AssertionError(f"replica_slow drill injected {slow} s")
    line["slow_drill"] = {"slow_injected_s": slow, "tokens_equal_bare": True,
                          **fleet_latency(done, wall),
                          "joins": fleet_joins(fleet)}
    del fleet
    M.stop_exports()
    log("fleet (world 1): " + json.dumps(line))
    torch.cuda.empty_cache()
    return line


def check_kernel_on_card(fa, kvc, dev) -> float:
    """Paged decode on card ``dev`` against its plain version, at the
    main path's geometry (8 slots, ragged lengths, slot 3 empty, bf16, H =
    KVH = 16, D = 64, page 128)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, d, page, n_max = 8, 16, 64, 128, 16
    lengths = [1, 2048, 300, 0, 1024, 1537, 128, 777]
    shape = (b * n_max + 1, page, h, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    bt = torch.randperm(b * n_max, generator=gen, device=dev).reshape(
        b, n_max).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = fa.flash_paged_decode(q, kp, vp, bt, ln, d ** -0.5)
    ref = kvc.paged_attention_reference(q, kp, vp, bt, ln, d ** -0.5)
    err = float((out - ref).abs().max())
    if out.device != torch.device(dev) or err > TOL[torch.bfloat16] or \
            not bool((out[3] == 0).all()):
        raise AssertionError(f"paged_decode on {dev}: max_abs_err {err}")
    return err


def fleet_n_cards(n: int, card: str) -> None:
    """``--data-parallel N --fleet-only``: one process, a replica a card
    (``cuda:0`` .. ``cuda:N-1``), each stepped on its own thread
    (``run(parallel=True)``); not an NCCL world. The kernel is held on
    every card; every request's tokens equal the bare one-card engine's;
    each replica's weights and pool sit on its own card; decode tokens/s
    at 1 and at N replicas; the autoscaler grows 1 -> N under staggered
    arrivals; then one replica is killed and another drained."""
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import ReplicaState, ServingFleet
    from horovod_tpu_torch.serving import kv_cache as kvc
    devices = [f"cuda:{i}" for i in range(n)]
    errs = {dev: check_kernel_on_card(fa, kvc, dev) for dev in devices}
    cfg = flagship_cfg(htt.TransformerConfig)
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda:0")
    bare = fleet_bare(htt, fa, cfg, params)
    reqs = lambda: mp_serve_requests(cfg.vocab_size)   # noqa: E731
    warm = lambda: mp_serve_requests(                   # noqa: E731
        cfg.vocab_size, n=2 * n, new_tokens=8, seed=9, lo=40, hi=60)
    line = {"model": "flagship TransformerLM", "cards": n, "requests": 16,
            "new_tokens": 32, "kernel_max_abs_err_by_card": errs,
            "card": card}
    rates = {}
    for k in (1, n):
        fleet = ServingFleet(fleet_engine_maker(cfg, params, devices[:k]),
                             replicas=k, max_replicas=k,
                             scale_down_idle=10 ** 9, cooldown=0)
        fleet.run(warm(), parallel=True)
        fleet.completed.clear()
        batch = reqs()
        for r in batch:
            r.arrival = 0.0
        done, wall, launches, steps = fleet_run(fleet, fa, batch,
                                                parallel=True)
        fleet_check(f"fleet of {k}", done, bare, n_layers=cfg.n_layers,
                    launches=launches, steps=steps)
        rates[k] = {**fleet_latency(done, wall),
                    "paged_decode_launches": launches,
                    "served_by": {rep.member: rep.dispatched_count
                                  for rep in fleet.replicas.values()},
                    "joins": fleet_joins(fleet)}
        if k == n:
            placed = {}
            for rid, rep in fleet.replicas.items():
                eng = rep.engine
                devs = {str(eng.k_pages.device), str(eng.v_pages.device),
                        str(eng.params["head"].device),
                        str(eng.params["layers"]["w_out"].device)}
                need = eng.pool.nbytes() + sum(
                    t.numel() * t.element_size()
                    for t in [*eng.params["layers"].values(),
                              eng.params["embed"], eng.params["head"]])
                i = rid % n
                placed[rep.member] = {
                    "devices": sorted(devs),
                    "memory_allocated_gb": torch.cuda.memory_allocated(i)
                    / 1e9, "weights_and_pool_gb": need / 1e9}
                if devs != {devices[i]} or \
                        torch.cuda.memory_allocated(i) < need:
                    raise AssertionError(f"replica {rid}: {devs}, "
                                         f"{placed[rep.member]}")
            line["placement"] = placed
        del fleet
    line["fleet_of_1"], line[f"fleet_of_{n}"] = rates[1], rates[n]
    line["tokens_per_s_ratio"] = (rates[n]["decode_tokens_per_s"]
                                  / rates[1]["decode_tokens_per_s"])

    # the autoscaler grows 1 -> n under staggered arrivals
    fleet = ServingFleet(fleet_engine_maker(cfg, params, devices),
                         replicas=1, min_replicas=1, max_replicas=n,
                         scale_up_depth=0, scale_down_idle=10 ** 9,
                         cooldown=0)
    batch = reqs()
    for i, r in enumerate(batch):
        r.arrival = i * FLEET_STAGGER_S
    done, wall, launches, steps = fleet_run(fleet, fa, batch, parallel=True)
    fleet_check("autoscaler drill", done, bare, n_layers=cfg.n_layers,
                launches=launches, steps=steps)
    grown = fleet_joins(fleet)
    if len(fleet.live()) != n:
        raise AssertionError(f"autoscaler drill: {len(fleet.live())} "
                             f"replicas, grow events {grown}")
    # then a kill and a drain on the grown fleet, the autoscaler held
    fleet.scale_up_depth = 10 ** 9
    batch = reqs()
    for r in batch:
        r.rid += 100
        r.arrival = None
        fleet.dispatch(r)
    orphans = fleet.kill_replica(n - 1, reason="drill")
    fleet.drain(n - 2, reason="drill")
    done2, wall2, launches2, steps2 = fleet_run(fleet, fa, [],
                                                parallel=True)
    fleet_check("kill and drain drill", [r for r in done2 if r.rid >= 100],
                bare, rids={100 + i: i for i in range(16)})
    left = fleet.replicas[n - 2]
    if (fleet.replicas[n - 1].state != ReplicaState.DEAD or not orphans
            or left.state != ReplicaState.LEFT
            or left.engine.allocator.free_pages != left.engine.pool.n_pages):
        raise AssertionError(f"kill and drain drill: {fleet.stats()}")
    line["autoscaler_drill"] = {
        "grow_events": grown, **fleet_latency(done, wall),
        "served_by": {rep.member: rep.dispatched_count
                      for rep in fleet.replicas.values()}}
    line["kill_and_drain_drill"] = {
        "readmitted": [r.rid for r in orphans],
        "states": {rep.member: rep.state
                   for rep in fleet.replicas.values()},
        "pages_freed_by_leaver": left.engine.allocator.free_pages,
        "tokens_equal_bare": True, "paged_decode_launches": launches2}
    del fleet, left
    log(f"fleet data parallel: " + json.dumps(line))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: training you can look into — the matmul precision knob, the
# profile window, the numerics monitor and the run ledger
# ---------------------------------------------------------------------------

OBS_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "observability")
OBS_STEPS = 4               # flagship steps at each matmul precision
OBS_PRECISIONS = ("float32", "tensorfloat32", "bfloat16")
# The losses of the three precisions from the same weights and batches:
# the first is bitwise equal (the precision reaches only the CE backward's
# f32 products); the later ones move by the rounding of those products
# (TF32's 2^-11, bf16's 2^-8 relative) carried through SGD at lr 0.01, so
# no two settings give the same later losses bitwise, and each stays within
# OBS_LOSS_TOL of the float32 run's, on losses near ln(32768). Read on an
# H100 80GB HBM3 (700 W): tensorfloat32 9.3e-5 off, bfloat16 1.8e-4.
OBS_LOSS_TOL = 1e-3
# The CE backward's device ms at tensorfloat32 and at bfloat16 under this
# share of float32's: read 19.89 and 18.09 ms against 55.15 (0.36, 0.33)
# on the same card; a knob that reached no product would read ~1.
OBS_CE_FAST_SHARE = 0.6
OBS_RESNET_ROUNDS = 3       # ResNet-50 steps with numerics off and on, in turns
OBS_DP_WINDOW = 8           # profiled steps of the N-card window
# The numerics drill's fusion threshold: ResNet-50's 102 MB of gradients
# in more than 20 bins (19 at 4 MiB), so the default
# HOROVOD_NUMERICS_CHECK_EVERY (10) falls due at least twice inside the
# dispatch under the sync check.
OBS_DRILL_FUSION = 2 << 20
OBS_CE_LABEL = r"^blockwise_ce\.backward$"


def obs_profile(fn, tag, tries: int = 3):
    """Run ``fn()`` under torch.profiler (CPU and CUDA activity), export
    its Chrome trace under OBS_ROOT and return the trace's events, read
    back with the port's reader. A trace with no kernel events (the
    profiler now and then hands back none) is taken again, up to
    ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    from horovod_tpu_torch.tracing import profile as tp
    os.makedirs(OBS_ROOT, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    for _ in range(tries):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(OBS_ROOT, f"{tag}.trace.json")
        prof.export_chrome_trace(path)
        events = tp.read_trace_events(path)
        if tp.on_device(events) or not torch.cuda.is_available():
            return events
    raise AssertionError(f"{tag}: the profiler saw no kernel events")


def obs_device_ms(events) -> float:
    """The device ms of every kernel, memcpy and memset of a trace."""
    from horovod_tpu_torch.tracing import profile as tp
    return sum(float(e["dur"]) for e in tp.device_op_events(events)) / 1e3


def obs_flash_launches(fa, cfg, n_steps, what) -> dict:
    """Each flash kernel launched at least once a layer a step since the
    counts were reset."""
    got = {k: fa.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    if min(got.values()) < cfg.n_layers * n_steps:
        raise AssertionError(f"{what}: flash launches {got} over {n_steps} "
                             f"steps of {cfg.n_layers} layers")
    return got


def obs_flagship_batches(cfg, dev, n, rank=0, world=1, seed=1):
    """``n`` of the flagship's batches (TRAIN_B x TRAIN_S a rank), this
    rank's rows of the global one."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = slice(rank * TRAIN_B, (rank + 1) * TRAIN_B)
    return [tuple(torch.randint(0, cfg.vocab_size, (TRAIN_B * world, TRAIN_S),
                                generator=gen, device=dev)[rows]
                  for _ in range(2)) for _ in range(n)]


def obs_timed_loop(htt, step, state, batches):
    """``train_loop`` over ``batches`` with a synchronize at each step's
    end: (state, info, losses, step ms)."""
    losses, stamps = [], []

    def on_step(i, st, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, info = htt.train_loop(step, state, batches, on_step=on_step)
    if info["status"] != "completed" or info["final_step"] != len(batches):
        raise AssertionError(f"train_loop info {info}")
    return state, info, losses, [float(x) * 1e3
                                 for x in np.diff([t0] + stamps)]


def obs_precision(htt, fa, card, dev="cuda") -> dict:
    """The flagship at full width and depth (8 x 2048, bf16,
    ``mlp_recompute=True``) built under each HOROVOD_TPU_MATMUL_PRECISION
    of OBS_PRECISIONS, from the same weights and batches: OBS_STEPS steps
    through ``train_loop`` (step ms, losses, flash launches), then one
    profiled step (device ms, and the CE backward's device ms: the
    kernels launched inside its ``blockwise_ce.backward`` range). The
    caller's TF32 flags must be back after every step."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.tracing import profile as tp
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    batches = obs_flagship_batches(cfg, dev, OBS_STEPS + 1)
    out = {}
    for name in OBS_PRECISIONS:
        knobs.set_override("HOROVOD_TPU_MATMUL_PRECISION", name)
        try:
            init_fn, step = htt.make_transformer_train_step(
                cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
                device=dev)
        finally:
            knobs.clear_override("HOROVOD_TPU_MATMUL_PRECISION")
        state = init_fn(htt.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
        before = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
        fa.reset_launches()
        state, _, losses, step_ms = obs_timed_loop(htt, step, state,
                                                   batches[:OBS_STEPS])
        launches = obs_flash_launches(fa, cfg, OBS_STEPS, f"precision {name}")
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        if flags != before:
            raise AssertionError(f"precision {name}: the step left the TF32 "
                                 f"flags at {flags}, not {before}")
        events = obs_profile(lambda: step(state, *batches[OBS_STEPS]),
                             f"precision-{name}")
        ce = tp.device_seconds_by_label(events, OBS_CE_LABEL)
        if not ce:
            raise AssertionError(f"precision {name}: no kernel was labelled "
                                 f"blockwise_ce.backward in the profile")
        out[name] = {"losses": losses, "step_ms": step_ms,
                     "step_ms_mean_after_first": float(np.mean(step_ms[1:])),
                     "device_ms": obs_device_ms(events),
                     "ce_backward_device_ms": sum(ce.values()) * 1e3,
                     "launches": launches}
        del state, step, init_fn, events
        torch.cuda.empty_cache()
    ref = out["float32"]["losses"]
    # CPU products stay IEEE f32 at every setting: these hold on the card
    on_card = torch.device(dev).type == "cuda"
    for i, a in enumerate(OBS_PRECISIONS):
        for b in OBS_PRECISIONS[i + 1:]:
            if on_card and out[a]["losses"][1:] == out[b]["losses"][1:]:
                raise AssertionError(f"precision {a} and {b}: the same losses "
                                     f"{out[a]['losses']} bitwise")
    f32_ce = out["float32"]["ce_backward_device_ms"]
    for name in OBS_PRECISIONS[1:]:
        share = out[name]["ce_backward_device_ms"] / f32_ce
        out[name]["ce_backward_share_of_float32"] = share
        if on_card and share > OBS_CE_FAST_SHARE:
            raise AssertionError(f"precision {name}: CE backward "
                                 f"{out[name]['ce_backward_device_ms']} ms, "
                                 f"{share:.3f} of float32's {f32_ce}")
    for name in OBS_PRECISIONS:
        got = out[name]["losses"]
        if not all(np.isfinite(got)):
            raise AssertionError(f"precision {name}: losses {got}")
        if got[0] != ref[0]:
            raise AssertionError(f"precision {name}: first loss {got[0]} is "
                                 f"not float32's {ref[0]}")
        diff = max(abs(a - b) for a, b in zip(got, ref))
        out[name]["max_loss_diff_vs_float32"] = diff
        if diff > OBS_LOSS_TOL:
            raise AssertionError(f"precision {name}: losses {got} off "
                                 f"float32's {ref} by {diff}")
    out["loss_tol"] = OBS_LOSS_TOL
    out["ce_fast_share"] = OBS_CE_FAST_SHARE
    out["card"] = card
    log("observability precision: " + json.dumps(out))
    return out


def obs_window_one(htt, fa, card, dev="cuda") -> dict:
    """HOROVOD_TRACE_PROFILE=steps:2@2 over the fused flagship (buckets
    launched from the gradient hooks) for 5 steps through ``train_loop``
    in a world of one: the attribution file under the trace dir, no
    collective events (a world of one reduces nothing), the buckets whose
    packing ran on the device labelled (the device ms of each), and the
    step ms inside the window beside the others (the profiler slows the
    steps it traces)."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.parallel import distributed as D
    d = os.path.join(OBS_ROOT, "trace-one")
    knobs.set_override("HOROVOD_TRACE_DIR", d)
    knobs.set_override("HOROVOD_TRACE_PROFILE", "steps:2@2")
    try:
        cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                           dp_axis="dp")
        state, step = flagship_fused_step(htt, cfg, dev, seed=0)
        fa.reset_launches()
        state, _, losses, step_ms = obs_timed_loop(
            htt, step, state, obs_flagship_batches(cfg, dev, 5))
        launches = obs_flash_launches(fa, cfg, 5, "profile window")
        n_buckets = D.last_wire_trace()["n_buckets"]
    finally:
        knobs.clear_override("HOROVOD_TRACE_PROFILE")
        knobs.clear_override("HOROVOD_TRACE_DIR")
    path = os.path.join(d, "profile", "profile_attribution.json")
    with open(path) as f:
        a = json.load(f)
    # a world of one reduces nothing on the card (gloo's world of one
    # still runs its ops, on the CPU)
    cuda = torch.device(dev).type == "cuda"
    quiet = a["collective_events"] == 0 or not cuda
    if a["profiled_steps"] != 2 or not quiet or a["device_op_events"] == 0 \
            or a["device"] is not cuda:
        raise AssertionError(f"profile window (world 1): {a}")
    labels = [b["bucket"] for b in a["per_bucket"]]
    if not labels or not set(labels) <= {f"hvd_bucket{k}"
                                         for k in range(n_buckets)}:
        raise AssertionError(f"profile window (world 1): buckets {labels}, "
                             f"{n_buckets} launched")
    window = [s * 1e3 for s in a["window_step_seconds"]]
    out = {"attribution_file": os.path.relpath(path, OBS_ROOT),
           "device_reading": a["device"],
           "unlaunched_device_events": a["unlaunched_device_events"],
           "profiled_steps": a["profiled_steps"],
           "device_op_events": a["device_op_events"],
           "collective_events": a["collective_events"],
           "observed_overlap_ratio": a["observed_overlap_ratio"],
           "compute_ms_per_step": a["compute_seconds"] * 1e3 / 2,
           "buckets": n_buckets, "buckets_labelled": len(labels),
           "bucket_device_ms": [round(b["device_seconds"] * 1e3, 4)
                                for b in a["per_bucket"]],
           "step_ms": step_ms, "window_step_ms": window,
           "step_ms_outside_window": [m for i, m in enumerate(step_ms)
                                      if i not in (1, 2)],
           "losses": losses, "launches": launches, "card": card}
    del state, step
    torch.cuda.empty_cache()
    log("observability window (world 1): " + json.dumps(out))
    return out


def obs_resnet_hooks(htt, model, poison):
    """Reference Horovod's torch idiom through the coordinator, each
    gradient named by its parameter (``grad.<name>``); ``poison["i"]``
    (when set) makes that gradient's first value NaN before its
    enqueue. Returns ``(sync, hooks)``."""
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    handles = {}

    def hook(i):
        def fn(p):
            if poison.get("i") == i:
                p.grad.view(-1)[0] = float("nan")
            handles[i] = htt.allreduce_async(p.grad, op=htt.Average,
                                             name=f"grad.{names[i]}")
        return fn

    hooks = [p.register_post_accumulate_grad_hook(hook(i))
             for i, p in enumerate(params)]

    def sync():
        for i, p in enumerate(params):
            p.grad.copy_(htt.synchronize(handles.pop(i)))

    return sync, hooks


def obs_numerics(htt, cb, card, dev="cuda", batch=RESNET_B,
                 image=224) -> dict:
    """ResNet-50 (``fused_conv_bn=True``) with each gradient through
    ``allreduce_async`` from its hook (the coordinator's cycle thread):
    OBS_RESNET_ROUNDS steps with HOROVOD_NUMERICS off and on in turns
    (step ms; conv+BN launches every step), the cycle thread's host time
    in the monitor split into the aggregates and the cadence drains
    (perf_counter around ``_observe_numerics`` and the drains it runs:
    the CPU profiler does not see a thread started before it); then on a
    coordinator
    without its thread, one step whose bins (OBS_DRILL_FUSION apart) are
    dispatched under ``torch.cuda.set_sync_debug_mode("error")`` and
    torch.profiler at the default HOROVOD_NUMERICS_CHECK_EVERY, so the
    cadence's drains run inside the check (no synchronizing call on the
    dispatch path; the aggregates' launches and device ms a bin), one
    gradient poisoned with a NaN, which a drain names; then the
    aggregates of the step's gradients as one bin, one level and through
    blocks, timed in turns."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.goodput import numerics
    from horovod_tpu_torch.ops import coordinator as coord_mod
    from horovod_tpu_torch.ops.coordinator import Coordinator
    from horovod_tpu_torch.runtime.context import get_context
    from horovod_tpu_torch.tracing import profile as tp
    ctx = get_context()
    model = htt.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         fused_conv_bn=True, device=dev, seed=3)
    names = [n for n, _ in model.named_parameters()]
    sgd = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    poison = {}
    hsync, hooks = obs_resnet_hooks(htt, model, poison)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    def one_step(seed, update=True):
        x, y = api_batch(ctx.device, seed, 0, batch, image)
        resnet_loss(model, x, y).backward()
        hsync()
        if update:
            sgd.step()
        sgd.zero_grad()

    out = {"gradients": len(names)}
    ms = {"off": [], "on": []}
    spent = {"observe_s": 0.0, "drain_s": 0.0, "ids_s": 0.0, "bins": 0,
             "drains": 0, "ids": 0}
    real_observe = coord_mod._observe_numerics
    real_drain = numerics.NumericsMonitor._drain
    real_ids = numerics._ids

    def timed_ids(*a):
        # segment ids are built only for a bin layout not seen lately
        t = time.perf_counter()
        try:
            return real_ids(*a)
        finally:
            spent["ids_s"] += time.perf_counter() - t
            spent["ids"] += 1

    def timed_observe(*a):
        t = time.perf_counter()
        try:
            return real_observe(*a)
        finally:
            spent["observe_s"] += time.perf_counter() - t
            spent["bins"] += 1

    def timed_drain(self, wait):
        t = time.perf_counter()
        try:
            return real_drain(self, wait)
        finally:
            spent["drain_s"] += time.perf_counter() - t
            spent["drains"] += 1

    try:
        one_step(70)                                        # warm-up
        coord_mod._observe_numerics = timed_observe
        numerics.NumericsMonitor._drain = timed_drain
        numerics._ids = timed_ids
        for rnd in range(OBS_RESNET_ROUNDS + 1):
            for mode in ("off", "on"):
                knobs.set_override("HOROVOD_NUMERICS", mode == "on")
                try:
                    cb.reset_launches()
                    sync()
                    t0 = time.perf_counter()
                    one_step(71 + rnd)
                    sync()
                    if rnd:
                        ms[mode].append((time.perf_counter() - t0) * 1e3)
                    check_launches(cb, ctx.device, f"numerics {mode}")
                finally:
                    knobs.clear_override("HOROVOD_NUMERICS")
        coord_mod._observe_numerics = real_observe
        numerics.NumericsMonitor._drain = real_drain
        numerics._ids = real_ids
        steps_on = OBS_RESNET_ROUNDS + 1
        # per step with the monitor on (warm-up round included); every
        # drain here ran inside an observation, on the cycle thread
        out["on_step_host_split"] = {
            "bins": spent["bins"] / steps_on,
            "cadence_drains": spent["drains"] / steps_on,
            "aggregates_host_ms": (spent["observe_s"] - spent["drain_s"])
            * 1e3 / steps_on,
            "drains_host_ms": spent["drain_s"] * 1e3 / steps_on,
            # two id builds a new layout, inside the aggregates' time
            "layout_builds": spent["ids"] / 2 / steps_on,
            "layout_build_host_ms": spent["ids_s"] * 1e3 / steps_on}
        out["step_ms"] = ms
        out["step_ms_median"] = {k: float(np.median(v))
                                 for k, v in ms.items()}
        mon = numerics.get_monitor()
        out["monitor_drains_so_far"] = mon.drains if mon else None
        if mon is not None and mon.anomalies:
            raise AssertionError(f"numerics: clean steps fired "
                                 f"{mon.anomalies}")
        # the drill, on a coordinator without its thread: the bins of one
        # step dispatched under the sync debug mode at the default cadence,
        # an explicit drain after it for the rows still in flight
        own = Coordinator(ctx, start_thread=False)
        saved, ctx.coordinator = ctx.coordinator, own
        mon = numerics.NumericsMonitor()
        numerics.install(mon)
        k = len(names) // 2
        poison["i"] = k
        knobs.set_override("HOROVOD_NUMERICS", True)
        knobs.set_override("HOROVOD_FUSION_THRESHOLD", OBS_DRILL_FUSION)
        try:
            x, y = api_batch(ctx.device, 90, 0, batch, image)
            resnet_loss(model, x, y).backward()
            bins0 = own.stats.dispatched_programs
            sync()

            def dispatch():
                torch.cuda.set_sync_debug_mode("error")
                try:
                    own.run_cycle()
                finally:
                    torch.cuda.set_sync_debug_mode(0)

            events = obs_profile(dispatch, "numerics-drill", tries=1)
            dispatched = own.stats.dispatched_programs - bins0
            agg = tp.device_events_by_label(events, r"^hvd_numerics$").get(
                "hvd_numerics", [])
            observed, cadence_drains = mon._observed, mon.drains
            in_cadence = len(mon.anomalies)
            hsync()
            mon.drain()
            fired = list(mon.anomalies)
        finally:
            knobs.clear_override("HOROVOD_FUSION_THRESHOLD")
            knobs.clear_override("HOROVOD_NUMERICS")
            poison.clear()
            sgd.zero_grad()
            own.shutdown()
            ctx.coordinator = saved
        if observed != dispatched or cadence_drains < 2 \
                or cadence_drains != dispatched // mon.check_every:
            raise AssertionError(f"numerics drill: {dispatched} bins under "
                                 f"the sync check, {observed} observed, "
                                 f"{cadence_drains} cadence drains at "
                                 f"every {mon.check_every}")
        hits = [(a["step"], b) for a in fired for b in a.get("buckets", ())]
        if len(fired) != 1 or [b["label"] for _, b in hits] != [
                f"grad.{names[k]}"]:
            raise AssertionError(f"numerics drill: poisoned "
                                 f"grad.{names[k]}, fired {fired}")
        if dev == "cuda" and not agg:
            raise AssertionError("numerics drill: no kernel labelled "
                                 "hvd_numerics in the dispatch's profile")
        out["drill"] = {"poisoned": f"grad.{names[k]}",
                        "bins_dispatched_under_sync_check": dispatched,
                        "cadence_drains_under_sync_check": cadence_drains,
                        "check_every": mon.check_every,
                        "named_by_a_cadence_drain": in_cadence == 1,
                        "sync_debug_mode": "error",
                        "aggregate_launches_per_bin": len(agg) / dispatched,
                        "aggregate_device_ms_per_bin": sum(
                            float(e["dur"]) for e in agg) / 1e3 / dispatched,
                        "anomaly": fired[0]}
        # the aggregates of the step's gradients as one bin, straight to
        # the tensors' slots and through blocks, in turns (CUDA events)
        numels = [p.numel() for p in model.parameters()]
        flat = torch.randn(sum(numels), device=ctx.device)
        ms = {0: [], numerics.SEGMENT_BLOCK: []}
        for blk in (0, numerics.SEGMENT_BLOCK, numerics.SEGMENT_BLOCK, 0):
            ms[blk].append(cuda_ms(lambda i: numerics.bin_aggregates(
                flat, numels, block=blk), 10))
        out["bin_aggregates_ms"] = {
            "elements": flat.numel(), "tensors": len(numels),
            "one_level": ms[0],
            f"blocks_of_{numerics.SEGMENT_BLOCK}": ms[numerics.SEGMENT_BLOCK]}
        del flat
    finally:
        coord_mod._observe_numerics = real_observe
        numerics.NumericsMonitor._drain = real_drain
        numerics._ids = real_ids
        for h in hooks:
            h.remove()
    out["card"] = card
    log("observability numerics: " + json.dumps(out))
    return out


def observability_world_one(htt, fa, cb, card, dev="cuda") -> None:
    """Phase 14 in a world of one: the precision knob, the profile
    window, the numerics monitor on ResNet-50 and the run ledger (the
    record ``shutdown`` writes, read back)."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.goodput import ledger, numerics
    import shutil
    shutil.rmtree(OBS_ROOT, ignore_errors=True)
    os.makedirs(OBS_ROOT, exist_ok=True)
    path = os.path.join(OBS_ROOT, "ledger.jsonl")
    knobs.set_override("HOROVOD_GOODPUT_LEDGER", path)
    t0 = time.perf_counter()
    try:
        ctx = htt.init(device=dev)
        try:
            if ctx.backend != ("nccl" if dev == "cuda" else "gloo"):
                raise AssertionError(f"backend {ctx.backend}")
            obs_precision(htt, fa, card, dev)
            obs_window_one(htt, fa, card, dev)
            obs_numerics(htt, cb, card, dev)
        finally:
            htt.shutdown()
    finally:
        knobs.clear_override("HOROVOD_GOODPUT_LEDGER")
        numerics.install(None)
    rows = ledger.read_ledger(path)
    if len(rows) != 1:
        raise AssertionError(f"ledger: {len(rows)} records in {path}")
    rec = rows[0]
    want_chip = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    if rec["chip"] != want_chip or rec["world_size"] != 1 \
            or rec["numerics"]["anomalies"] != 1 \
            or len(rec["knob_fingerprint"]) != 16:
        raise AssertionError(f"ledger record: {rec}")
    log("observability ledger (world 1): " + json.dumps({
        "keys": sorted(rec), "chip": rec["chip"],
        "world_size": rec["world_size"], "numerics": rec["numerics"],
        "goodput_fraction": rec["goodput"].get("goodput_fraction"),
        "wire": rec["wire"], "seconds": time.perf_counter() - t0,
        "card": card}))


def obs_step_nccl_ms(events, label=r"^obs_step(\d+)$"):
    """Per profiled step, the NCCL kernels' device ms: the kernels that
    started inside the host range of each ``obs_step<i>`` annotation
    (each range ends in a synchronize, so its step's kernels run inside
    it)."""
    import re
    from horovod_tpu_torch.tracing import profile as tp
    pat = re.compile(label)
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    int(pat.match(e["name"]).group(1)))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and pat.match(str(e.get("name", ""))))
    coll, _ = tp.classify(events)
    out = {}
    for lo, hi, i in steps:
        out[i] = sum(float(e["dur"]) for e in coll
                     if lo <= float(e["ts"]) < hi) / 1e3
    return [out[i] for i in sorted(out)]


def observability_rank(rank, world, ports, results, device="cuda"):
    """One rank of the N-card observability world: the fused flagship
    (buckets launched from the gradient hooks) through ``train_loop``
    under HOROVOD_TRACE_PROFILE=steps:OBS_DP_WINDOW@2 with the span
    recorder on; the numerics drill through the coordinator (rank 0's
    first tensor holds a NaN; every rank's monitor names it); then
    ``shutdown`` (every rank's spans merged into rank 0's file, a ledger
    record on every rank). Rank 0 puts the numbers on ``results``."""
    import socket
    import torch.distributed as dist
    from torch.autograd.profiler import record_function
    join_store_world(rank, world, ports, device)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.goodput import ledger, numerics
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import distributed as D
    from horovod_tpu_torch.tracing import profile as tp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trace_dir = os.path.join(OBS_ROOT, "trace-dp")
    ledger_path = os.path.join(OBS_ROOT, f"ledger-dp-{rank}.jsonl")
    os.environ["HOROVOD_TRACE"] = "1"
    for k, v in (("HOROVOD_TRACE_DIR", trace_dir),
                 ("HOROVOD_TRACE_PROFILE", f"steps:{OBS_DP_WINDOW}@2"),
                 ("HOROVOD_GOODPUT_LEDGER", ledger_path)):
        knobs.set_override(k, v)
    ctx = htt.init(device=device)
    dev = ctx.device
    out = {"world": world}
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    state, step = flagship_fused_step(htt, cfg, dev, seed=rank)
    count = [0]

    def labelled(st, *batch):
        # the step's device work ends inside its range
        count[0] += 1
        with record_function(f"obs_step{count[0]}"):
            out = step(st, *batch)
            torch.cuda.synchronize()
        return out

    n = OBS_DP_WINDOW + 3
    fa.reset_launches()
    state, _, losses, step_ms = obs_timed_loop(
        htt, labelled, state, obs_flagship_batches(cfg, dev, n, rank, world))
    obs_flash_launches(fa, cfg, n, f"observability rank {rank}")
    n_buckets = D.last_wire_trace()["n_buckets"]
    prof_dir = os.path.join(trace_dir, "profile", f"rank{rank}")
    with open(os.path.join(prof_dir, "profile_attribution.json")) as f:
        a = json.load(f)
    events = tp.read_trace_events(tp.find_trace_files(prof_dir)[-1])
    nccl_ms = obs_step_nccl_ms(events)
    knobs.clear_override("HOROVOD_TRACE_PROFILE")
    del state, step, events
    torch.cuda.empty_cache()
    # the numerics drill on every rank
    knobs.set_override("HOROVOD_NUMERICS", True)
    mon = numerics.NumericsMonitor()
    numerics.install(mon)
    gen = torch.Generator(device=dev).manual_seed(5)
    xs = [torch.randn(s, generator=gen, device=dev)
          for s in ((4096, 1024), (1024,), (333, 77))]
    if rank == 0:
        xs[0][17, 3] = float("nan")
    handles = [htt.allreduce_async(x, op=htt.Average, name=f"drill.{i}")
               for i, x in enumerate(xs)]
    for h in handles:
        htt.synchronize(h)
    mon.drain()
    fired = list(mon.anomalies)
    knobs.clear_override("HOROVOD_NUMERICS")
    labels = [b["label"] for a_ in fired for b in a_["buckets"]]
    if labels != ["drill.0"]:
        raise AssertionError(f"rank {rank}: numerics drill fired {fired}")
    t_shut = time.perf_counter()
    htt.shutdown()
    out["shutdown_s"] = time.perf_counter() - t_shut
    for k in ("HOROVOD_TRACE_DIR", "HOROVOD_GOODPUT_LEDGER"):
        knobs.clear_override(k)
    numerics.install(None)
    (rec,) = ledger.read_ledger(ledger_path)
    if rec["world_size"] != world or rec["numerics"]["anomalies"] != 1:
        raise AssertionError(f"rank {rank}: ledger record {rec}")
    if rank == 0:
        merged = os.path.join(
            trace_dir, f"merged-{socket.gethostname()}-p0.trace.json")
        with open(merged) as f:
            data = json.load(f)
        tracks = sorted(e["pid"] for e in data["traceEvents"]
                        if e.get("ph") == "M"
                        and e["name"] == "process_name")
        per_track = {str(p): sum(1 for e in data["traceEvents"]
                                 if e.get("ph") == "X" and e["pid"] == p)
                     for p in tracks}
        labels = [b["bucket"] for b in a["per_bucket"]]
        want = [f"hvd_bucket{k}" for k in range(n_buckets)]
        if a["device"] is not (device == "cuda") \
                or a["observed_overlap_ratio"] is None or labels != want \
                or any(b["device_seconds"] <= 0 for b in a["per_bucket"]) \
                or tracks != list(range(world)) \
                or min(per_track.values()) == 0:
            raise AssertionError(
                f"observability data parallel: attribution {a}, tracks "
                f"{tracks} {per_track}")
        window = [s * 1e3 for s in a["window_step_seconds"]]
        out.update({
            "losses": losses, "step_ms": step_ms,
            "window_step_ms": window,
            "step_ms_outside_window": [m for i, m in enumerate(step_ms)
                                       if not 1 <= i <= OBS_DP_WINDOW],
            # the last window step's wall time less its time in the
            # window: the profiler's stop, export and attribution
            "window_close_ms": step_ms[OBS_DP_WINDOW] - window[-1],
            "profiled_steps": a["profiled_steps"],
            "device_reading": a["device"],
            "unlaunched_device_events": a["unlaunched_device_events"],
            "observed_overlap_ratio": a["observed_overlap_ratio"],
            "exposed_collective_ms_per_step":
                a["exposed_collective_seconds_per_step"] * 1e3,
            "collective_ms_per_step":
                a["collective_seconds"] * 1e3 / a["profiled_steps"],
            "collective_events": a["collective_events"],
            "buckets": len(labels), "sync_buckets": n_buckets,
            "bucket_device_ms": {b["bucket"]: b["device_seconds"] * 1e3
                                 for b in a["per_bucket"]},
            "nccl_device_ms_by_step": nccl_ms,
            "nccl_ms_spread": (max(nccl_ms) / min(nccl_ms)
                               if nccl_ms and min(nccl_ms) > 0 else None),
            "merged_tracks": tracks, "spans_per_track": per_track,
            "clock_offsets_us": data["metadata"]["clock_offsets_us"],
            "numerics_drill": fired[0],
            "ledger_keys": sorted(rec),
            "ledger_chip": rec["chip"]})
        results.put(out)
    dist.destroy_process_group()


def observability_world(n, card, **kw) -> None:
    """``observability_rank`` in ``n`` spawned processes; the
    ``observability data parallel:`` line."""
    import shutil
    shutil.rmtree(OBS_ROOT, ignore_errors=True)
    (out,) = spawn_world(observability_rank, n, 1, 900, **kw)
    out["card"] = card
    log("observability data parallel: " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 15: the compiled-artifact store
# ---------------------------------------------------------------------------

STORE_ROOT = os.path.join(HERE, "build", "artifact_store")
STORE_STEPS = 2             # flagship steps through train_loop, cold and warm
STORE_SERVE_N = 4           # phase 3's requests the warm fleet serves
STORE_CHILD_S = 600         # one incarnation's deadline
PHASE3_SERVED = []          # (prompt, tokens) of phase 3's first requests


def lib_digests(_build) -> dict:
    import hashlib
    return {n: hashlib.sha256(_build.library_path(n).read_bytes()
                              ).hexdigest() for n in _build.SOURCES}


def store_counts(_build, store) -> dict:
    st = store.stats()
    return {"builds_run": _build.builds_run,
            "resolved": dict(_build.resolved),
            "store": {k: st[k] for k in ("hits", "misses", "publishes",
                                         "errors", "compile_seconds_saved",
                                         "entries", "size_bytes")},
            "miss_reasons": dict(store.miss_reasons)}


def store_train(htt, fa, rank, world) -> dict:
    """The flagship at phase 4's configuration (full width and depth;
    ``world`` ranks of TRAIN_B rows each) through ``train_loop`` for
    STORE_STEPS steps on the store: ``store_step``, the losses (float hex)
    and a digest of the parameters after the steps, the flash launches."""
    import hashlib
    from horovod_tpu_torch.utils import tree as tree_util
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    htt.init()
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    init_fn, step = htt.make_transformer_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        device="cuda")
    state = init_fn(params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = slice(rank * TRAIN_B, (rank + 1) * TRAIN_B)
    batches = [tuple(torch.randint(0, cfg.vocab_size,
                                   (TRAIN_B * world, TRAIN_S), generator=gen,
                                   device="cuda")[rows] for _ in range(2))
               for _ in range(STORE_STEPS)]
    losses = []
    fa.reset_launches()
    t0 = time.perf_counter()
    state, info = htt.train_loop(
        step, state, batches,
        on_step=lambda i, s_, loss: losses.append(float(loss).hex()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fa.LAUNCHES[k] for k in
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    h = hashlib.sha256()
    for t in tree_util.tree_leaves(state.params):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    htt.shutdown()
    if info.get("final_step") != STORE_STEPS or any(
            launches[k] < cfg.n_layers * STORE_STEPS for k in launches):
        raise AssertionError(f"store train: info {info}, launches "
                             f"{launches}")
    return {"store_step": info.get("store_step"), "losses": losses,
            "params_sha256": h.hexdigest(), "wall_s": wall,
            "launches": launches}


def store_warm_checks(fa, kvc, sq, cb, sc) -> dict:
    """Each kernel resolved from the store held against its plain version
    at phase 2's main shapes and tolerances; the largest errors."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"paged_decode": check_kernel(
        fa, kvc, gen, kvh=16, dtype=torch.bfloat16,
        timed=False)["max_abs_err"]}
    errs.update(check_flash(fa, sq, gen, b=TRAIN_B, s_q=TRAIN_S,
                            s_k=TRAIN_S, h=16, d=64, dtype=torch.bfloat16
                            )["max_abs_err"])
    _, _, m, k, n, prologue, _ = next(
        c for c in resnet50_convs() if c[:2] == (1, "conv3"))
    conv = check_conv(cb, gen, m, k, n, prologue, torch.bfloat16,
                      "stage 1 conv3 (store)")["max_abs_err"]
    errs["conv_bn_fwd"] = max(conv[nm][0] for nm in ("y", "s1", "s2"))
    errs["conv_bn_bwd"] = max(conv[nm][0] for nm in
                              ("dx", "dw", "dinv", "dshift"))
    x = torch.randn((PROBE_ROWS, PROBE_COLS), device="cuda", generator=gen
                    ).to(torch.bfloat16)
    got = sc.stream_copy(x)
    if not torch.equal(got.view(torch.uint8), sc.stream_copy_plain(
            x, torch.empty_like(x)).view(torch.uint8)):
        raise AssertionError("store: stream_copy differs from its plain "
                             "version")
    errs["stream_copy"] = 0.0
    return errs


def store_serve(htt, fa, served) -> dict:
    """A fleet of one on the flagship (phase 3's weights) serves phase 3's
    first requests: builds, store outcomes, join seconds, the tokens."""
    from horovod_tpu_torch.serving import Request, ServingFleet
    cfg = flagship_cfg(htt.TransformerConfig)
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    fleet = ServingFleet(fleet_engine_maker(cfg, params, ["cuda:0"]),
                         replicas=1, max_replicas=1)
    eng = fleet.replicas[0].engine
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=len(t)) for i, (p, t) in enumerate(served)]
    done, wall, launches, steps = fleet_run(fleet, fa, reqs)
    # phase 3's tokens stand for the bare engine's
    fleet_check("store fleet of one", done,
                {i: list(t) for i, (_, t) in enumerate(served)},
                n_layers=cfg.n_layers, launches=launches, steps=steps)
    return {"builds": eng.builds, "store_outcomes": dict(eng.store_outcomes),
            "joins": fleet_joins(fleet), "tokens_equal_phase3": True,
            "requests": len(done), "paged_decode_launches": launches,
            "decode_steps": steps, "wall_s": wall}


def store_child(rank, world, ports, results, part, build_dir, store_dir,
                served=(), device="cuda"):
    """One incarnation of phase 15 in a process of its own: the store at
    ``store_dir``, an empty build directory (``build_dir``, with the rank
    in a world of several), then ``part``: ``cold`` (build all six and
    publish, then the flagship's steps), ``warm`` (resolve all six from
    the store and hold each against its plain version), ``train``,
    ``serve`` (``served``: phase 3's prompts and tokens), ``chaos`` or
    ``dp`` (the flagship's steps, rank ``rank`` of ``world``)."""
    from pathlib import Path
    os.environ["HOROVOD_ARTIFACT_STORE"] = store_dir
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import stream_copy as sc
    from horovod_tpu_torch.parallel import sequence as sq
    from horovod_tpu_torch.resilience import chaos
    from horovod_tpu_torch.serving import kv_cache as kvc
    from horovod_tpu_torch.store import artifact_store
    _build.BUILD_DIR = Path(build_dir + (f"-rank{rank}" if world > 1
                                         else ""))
    # the CUDA context first, so that no resolve time below pays for it
    torch.zeros(1, device=f"cuda:{rank}" if device == "cuda" else device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if world > 1:
        join_store_world(rank, world, ports, device)
    store = artifact_store.from_env()
    rec = {"rank": rank, "part": part}
    if part == "cold":
        t0 = time.perf_counter()
        rec["nvcc_s"] = _build.build_all()
        rec["build_wall_s"] = time.perf_counter() - t0
        rec["sha256"] = lib_digests(_build)
        rec["after_build"] = store_counts(_build, store)
        rec["train"] = store_train(htt, fa, rank, world)
    elif part == "warm":
        t0 = time.perf_counter()
        _build.build_all()
        rec["resolve_wall_ms"] = (time.perf_counter() - t0) * 1e3
        rec["resolve_ms"] = {n: t * 1e3 for n, t in
                             _build.resolve_seconds.items()}
        rec["sha256"] = lib_digests(_build)
        rec["after_resolve"] = store_counts(_build, store)
        rec["max_abs_err"] = store_warm_checks(fa, kvc, sq, cb, sc)
    elif part in ("train", "dp"):
        rec["train"] = store_train(htt, fa, rank, world)
    elif part == "serve":
        rec["serve"] = store_serve(htt, fa, served)
    elif part == "chaos":
        chaos.install({"store_corrupt": {"fail_first": 1}})
        _build.build_all(["flash_fwd", "flash_bwd"])
        chaos.install(None)
        rec["corrupt"] = store_counts(_build, store)
        rec["train"] = store_train(htt, fa, rank, world)
        chaos.install({"fs_transient": {"fail_first": 1, "scope": "store"}})
        before = store_counts(_build, store)
        _build.build_all(["paged_decode", "stream_copy", "conv_bn_fwd",
                          "conv_bn_bwd"])
        rec["fs_injected"] = chaos.active()._store_fs_failed
        chaos.install(None)
        rec["fs_before"], rec["fs_after"] = before, store_counts(_build,
                                                                 store)
    rec["final"] = store_counts(_build, store)
    results.put(rec)
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()


def store_incarnation(part, tag, root, store_dir, world=1, **kw):
    return spawn_world(store_child, world, world, STORE_CHILD_S, part,
                       os.path.join(root, f"build-{tag}"), store_dir, **kw)


def check_store(what, cond, detail) -> None:
    if not cond:
        raise AssertionError(f"artifact store {what}: {detail}")


def check_entries(store_dir) -> dict:
    """Every entry of the store valid (payload hashes to its header);
    the entries by kind."""
    from horovod_tpu_torch.store import artifact_store
    headers = artifact_store.read_entry_headers(store_dir)
    bad = [h["file"] for h in headers if not h["payload_ok"]]
    check_store("entries", headers and not bad, f"invalid entries {bad}")
    kinds = {}
    for h in headers:
        kinds[h["kind"]] = kinds.get(h["kind"], 0) + 1
    return {"entries": len(headers), "by_kind": kinds,
            "bytes": sum(h["payload_bytes"] for h in headers)}


def artifact_store_world_one(card) -> dict:
    """Phase 15 on one card (module docstring): five incarnations, one
    after another, on one fresh store; one ``artifact store (world 1):``
    line."""
    import shutil
    shutil.rmtree(STORE_ROOT, ignore_errors=True)
    os.makedirs(STORE_ROOT)
    store_dir = os.path.join(STORE_ROOT, "store")
    try:
        cold = store_incarnation("cold", "cold", STORE_ROOT, store_dir)[0]
        built = cold["after_build"]
        check_store("cold", built["builds_run"] == 6
                    and built["store"]["publishes"] == 6
                    and set(built["resolved"].values()) == {"built"}, built)
        check_store("cold train", cold["train"]["store_step"] == "miss",
                    cold["train"])
        warm = store_incarnation("warm", "warm", STORE_ROOT, store_dir)[0]
        res = warm["after_resolve"]
        check_store("warm", res["builds_run"] == 0
                    and res["store"]["hits"] == 6
                    and set(res["resolved"].values()) == {"store"}, res)
        check_store("warm bytes", warm["sha256"] == cold["sha256"],
                    "a library differs from the cold one")
        train = store_incarnation("train", "train", STORE_ROOT,
                                  store_dir)[0]
        check_store("warm train", train["train"]["store_step"] == "hit"
                    and train["final"]["builds_run"] == 0, train)
        check_store("warm train losses", all(
            train["train"][k] == cold["train"][k]
            for k in ("losses", "params_sha256")),
            f"{train['train']} != {cold['train']}")
        serve = store_incarnation("serve", "serve", STORE_ROOT, store_dir,
                                  served=list(PHASE3_SERVED))[0]["serve"]
        check_store("warm serve", serve["builds"] == 0
                    and serve["store_outcomes"] == {"serve_decode": "hit"},
                    serve)
        chaos_rec = store_incarnation("chaos", "chaos", STORE_ROOT,
                                      store_dir)[0]
        cor = chaos_rec["corrupt"]
        check_store("store_corrupt", cor["builds_run"] == 1
                    and cor["miss_reasons"] == {"corrupt": 1}
                    and cor["store"]["publishes"] == 1
                    and cor["resolved"] == {"flash_fwd": "built",
                                            "flash_bwd": "store"}, cor)
        check_store("store_corrupt losses", all(
            chaos_rec["train"][k] == cold["train"][k]
            for k in ("losses", "params_sha256"))
            and chaos_rec["train"]["store_step"] == "hit", chaos_rec["train"])
        fs_b, fs_a = chaos_rec["fs_before"], chaos_rec["fs_after"]
        check_store("fs_transient", chaos_rec["fs_injected"] == 1
                    and fs_a["builds_run"] == fs_b["builds_run"]
                    and fs_a["store"]["errors"] == 0
                    and fs_a["store"]["hits"] == fs_b["store"]["hits"] + 4,
                    (fs_b, fs_a))
        entries = check_entries(store_dir)
    finally:
        shutil.rmtree(STORE_ROOT, ignore_errors=True)
    line = {
        "cold": {"nvcc_s": cold["nvcc_s"], "build_wall_s":
                 cold["build_wall_s"], "publishes":
                 built["store"]["publishes"], "train": cold["train"]},
        "warm": {"hits": res["store"]["hits"],
                 "builds_run": res["builds_run"],
                 "resolve_ms": warm["resolve_ms"],
                 "resolve_wall_ms": warm["resolve_wall_ms"],
                 "compile_seconds_saved":
                     res["store"]["compile_seconds_saved"],
                 "libraries_bitwise_cold": True,
                 "max_abs_err": warm["max_abs_err"]},
        "train_warm": {**train["train"],
                       "builds_run": train["final"]["builds_run"],
                       "losses_bitwise_cold": True},
        "serve_warm": serve,
        "chaos": {"store_corrupt": {
            "miss_reasons": cor["miss_reasons"],
            "rebuilt": cor["builds_run"], "republished":
                cor["store"]["publishes"], "losses_bitwise_cold": True},
            "fs_transient": {"injected": chaos_rec["fs_injected"],
                             "errors": fs_a["store"]["errors"],
                             "retries_absorbed": True}},
        "store": entries, "card": card}
    log("artifact store (world 1): " + json.dumps(line))
    return line


def artifact_store_world(n, card, **kw) -> dict:
    """``--data-parallel N --store-only``: N ranks of the data-parallel
    flagship on a cold store, each with an empty build directory, then N
    more on the warm store; one ``artifact store data parallel:`` line."""
    import shutil
    root = STORE_ROOT + "-dp"
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    store_dir = os.path.join(root, "store")
    try:
        t0 = time.perf_counter()
        cold = sorted(store_incarnation("dp", "cold", root, store_dir,
                                        world=n, **kw),
                      key=lambda r: r["rank"])
        cold_s = time.perf_counter() - t0
        entries = check_entries(store_dir)
        for r in cold:
            f = r["final"]
            check_store(f"cold rank {r['rank']}",
                        "corrupt" not in f["miss_reasons"]
                        and f["store"]["errors"] == 0
                        and r["train"]["store_step"] == "miss", f)
        t0 = time.perf_counter()
        warm = sorted(store_incarnation("dp", "warm", root, store_dir,
                                        world=n, **kw),
                      key=lambda r: r["rank"])
        warm_s = time.perf_counter() - t0
        for c, w in zip(cold, warm):
            check_store(f"warm rank {w['rank']}",
                        w["final"]["builds_run"] == 0
                        and w["train"]["store_step"] == "hit"
                        and w["train"]["losses"] == c["train"]["losses"]
                        and w["train"]["params_sha256"]
                        == c["train"]["params_sha256"],
                        (c["train"], w["train"], w["final"]))
        entries_after = check_entries(store_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = {
        "world": n, "cold_world_s": cold_s, "warm_world_s": warm_s,
        "cold_builds_by_rank": [r["final"]["builds_run"] for r in cold],
        "cold_resolved_by_rank": [r["final"]["resolved"] for r in cold],
        "cold_miss_reasons_by_rank": [r["final"]["miss_reasons"]
                                      for r in cold],
        "warm_builds_by_rank": [r["final"]["builds_run"] for r in warm],
        "warm_resolved_by_rank": [r["final"]["resolved"] for r in warm],
        "losses_bitwise_cold_world": True,
        "losses": cold[0]["train"]["losses"],
        "step_wall_s_cold": [r["train"]["wall_s"] for r in cold],
        "step_wall_s_warm": [r["train"]["wall_s"] for r in warm],
        "store": entries, "store_after_warm": entries_after, "card": card}
    log("artifact store data parallel: " + json.dumps(line))
    return line


# ---------------------------------------------------------------------------
# phase 16: the data path (the loaders, the data service, the estimator)
# ---------------------------------------------------------------------------

DATA_STEPS = 5              # ResNet-50 steps of each run of (a), after a warm-up
DATA_H2D_ITERS = 10         # timed pinned copies of one batch's images
DATA_PROFILED_STEPS = 2     # loaded steps under torch.profiler in (a)
DATA_SERVICE_STEPS = 8      # flagship steps of each run of (b), after a warm-up
DATA_WORKERS = 3            # DataWorker processes of each run of (b)
DATA_KILL = {"data_worker_kill": {"worker": 1, "after_batches": 2}}
DATA_KEY = b"\x05" * 32     # the data service's HMAC key
DATA_EST_ROWS = 4096        # MNIST-shaped rows the estimator fits in (c)
DATA_EST_BATCH = 128
DATA_EST_EPOCHS = 3
DATA_PREDICT_TOL = 1e-4     # predict on the card against the CPU, share of
                            # the largest |logit| (f32, TF32 off)
DATA_ROOT = os.path.join(HERE, "build", "data_path")
DATA_WORLD_S = 600          # the N-card data world's deadline


def data_packages() -> dict:
    """The versions of the data path's optional packages on this machine
    (null where one is absent)."""
    import importlib.metadata
    out = {}
    for m in ("pyarrow", "fsspec", "cloudpickle"):
        try:
            out[m] = importlib.metadata.version(m)
        except importlib.metadata.PackageNotFoundError:
            out[m] = None
    return out


def copy_overlap(prof) -> dict:
    """From a profiled window's device events: the host-to-device copies'
    device ms and the part of it during which a kernel also ran."""
    copies, comp = [], []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        name = ev.name.lower()
        if b <= a or name.startswith("memset"):
            continue
        if name.startswith("memcpy"):
            if "htod" in name:
                copies.append((a, b))
            continue
        comp.append((a, b))
    copy_m, comp_m = merged(copies), merged(comp)
    overlap = sum(max(0.0, min(b, d) - max(a, c))
                  for a, b in copy_m for c, d in comp_m)
    return {"h2d_ms": sum(b - a for a, b in copy_m) / 1e3,
            "h2d_overlapped_ms": overlap / 1e3, "h2d_copies": len(copies)}


def data_resnet_run(htt, cb, dev, batches):
    """``resnet_step`` fed by ``batches`` (a loader or a list of resident
    batches): a warm-up step, then ``train_loop`` over the rest, the
    conv+BN launch counts zeroed just before it and read just after."""
    state, step, _ = resnet_step(htt, dev, seed=0)
    it = iter(batches)
    state, loss = step(state, *next(it))                    # warm-up
    torch.cuda.synchronize()
    losses, stamps = [float(loss)], []

    def on_step(i, st, loss_t):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss_t))

    cb.reset_launches()
    t0 = time.perf_counter()
    state, info = htt.train_loop(step, state, it, on_step=on_step)
    torch.cuda.synchronize()
    launches = {k: cb.LAUNCHES[k] for k in ("conv_bn_fwd", "conv_bn_bwd")}
    if info["final_step"] != DATA_STEPS + 1 or info["status"] != "completed":
        raise AssertionError(f"train_loop info {info}")
    for name, n in launches.items():
        if n < RESNET50_CONVS * DATA_STEPS:
            raise AssertionError(f"{name} launched {n} times over "
                                 f"{DATA_STEPS} steps")
    step_ms = [float(x) * 1e3 for x in np.diff([t0] + stamps)]
    return losses, step_ms, launches, state, step


def data_loader_resnet(htt, cb, rank, world, dev="cuda") -> dict:
    """(a) The ResNet-50 cell fed by ``AsyncDataLoaderMixin`` +
    ``ShardedArrayLoader`` from seeded host arrays (bf16 images, made on
    the card from a seed and moved to the host), against the same batches
    already resident on the card; the rank's rows of the first global
    batch gathered from every rank against the global batch."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.data import (AsyncDataLoaderMixin,
                                        ShardedArrayLoader)

    class Loader(AsyncDataLoaderMixin, ShardedArrayLoader):
        pass

    gb = RESNET_B * world
    n = (DATA_STEPS + 1) * gb
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.rand((n, 224, 224, 3), generator=gen, device=dev
                        ).to(torch.bfloat16).cpu()
    labels = torch.randint(0, 1000, (n,), generator=gen,
                           device=dev).cpu().numpy()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        resident = list(ShardedArrayLoader([images, labels], gb, device=dev,
                                           seed=0))
        torch.cuda.synchronize()
        order = np.arange(n)
        np.random.RandomState(0).shuffle(order)
        want = [images[torch.from_numpy(order[:gb])].to(dev),
                torch.from_numpy(labels[order[:gb]]).to(dev)]
        slices_equal = True
        for mine, whole in zip(resident[0], want):
            got = torch.empty_like(whole)
            if world > 1:
                dist.all_gather_into_tensor(got, mine.contiguous())
            else:
                got.copy_(mine)
            slices_equal &= bool(torch.equal(got, whole))
        del want
        res_losses, res_ms, _, _, _ = data_resnet_run(htt, cb, dev, resident)
        del resident
        torch.cuda.empty_cache()
        loaded_losses, loaded_ms, launches, state, step = data_resnet_run(
            htt, cb, dev, Loader([images, labels], gb, device=dev, seed=0,
                                 prefetch_depth=2))
        # one batch's images, pinned, to the card
        local = images[:RESNET_B].clone().pin_memory()
        h2d_ms = cuda_ms(lambda i: local.to(dev, non_blocking=True),
                         DATA_H2D_ITERS)
        # loaded steps under the profiler: the prefetch thread's copies
        # against the step's kernels
        loader = Loader([images, labels], gb, device=dev, seed=0,
                        prefetch_depth=2)
        loader.set_epoch(1)
        it = iter(loader)
        state, _ = step(state, *next(it))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(DATA_PROFILED_STEPS):
                state, _ = step(state, *next(it))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        it.close()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"losses_loaded": loaded_losses, "losses_resident": res_losses,
            "losses_bitwise_equal": loaded_losses == res_losses,
            "step_ms_loaded": loaded_ms, "step_ms_resident": res_ms,
            "h2d_ms_per_batch": h2d_ms,
            "h2d_gb_per_s": local.numel() * 2 / h2d_ms / 1e6,
            "batch_mb": local.numel() * 2 / 1e6,
            "profiled_steps": DATA_PROFILED_STEPS,
            "profiled_wall_ms": wall_ms, **copy_overlap(prof),
            "launches": launches, "slices_equal_global": slices_equal}


def data_worker_child(index, size, cfgs, n_samples, vocab, seed, kill,
                      stamp):
    """One data-service host process (no CUDA): a random-access
    ``DataWorker`` over the whole token dataset on ``cfgs[0]``'s registry
    and a source-sharded one over sample ids on ``cfgs[1]``'s, serving
    until the registries shut down. With ``kill`` it runs under
    ``HOROVOD_CHAOS_SPEC``, and the first kill writes its wall time to
    ``stamp``."""
    import threading
    if kill:
        os.environ["HOROVOD_CHAOS_SPEC"] = json.dumps(kill)
    from horovod_tpu_torch.data import compute_service as dcs
    samples = np.random.RandomState(seed).randint(
        0, vocab, size=(n_samples, 2, TRAIN_S)).astype(np.int64)
    kill_fn = dcs.DataWorker.kill

    def stamped_kill(self):
        if not os.path.exists(stamp):
            with open(stamp, "w") as f:
                f.write(repr(time.time()))
        kill_fn(self)

    dcs.DataWorker.kill = stamped_kill
    ra_cfg, stream_cfg = (dcs.ComputeConfig.from_dict(c) for c in cfgs)
    threading.Thread(
        target=dcs.compute_worker_fn,
        args=(stream_cfg, lambda i, n: [np.int64(k) for k in
                                        range(i, n_samples, n)]),
        kwargs={"index": index, "size": size}, daemon=True).start()
    dcs.compute_worker_fn(ra_cfg, lambda i, n: samples, index=index,
                          size=size, random_access=True)


def start_data_services(world):
    """For each run of (b) (clean, kill): two registries in this process
    and ``DATA_WORKERS`` child processes serving them."""
    from horovod_tpu_torch.data.compute_service import (ComputeConfig,
                                                        ComputeService)
    os.environ.setdefault("HVD_TPU_ADVERTISE_HOST", "127.0.0.1")
    os.makedirs(DATA_ROOT, exist_ok=True)
    ctx = torch.multiprocessing.get_context("spawn")
    n_samples = DATA_SERVICE_STEPS * TRAIN_B * world
    vocab = flagship_cfg(dict).get("vocab_size")
    specs, svcs, procs = {}, [], []
    for name, kill in (("clean", None), ("kill", DATA_KILL)):
        pair = [ComputeService(1, DATA_WORKERS, key=DATA_KEY)
                for _ in range(2)]
        svcs += pair
        cfgs = [ComputeConfig(1, DATA_WORKERS, "compute", s.start(),
                              DATA_KEY, timeout=120.0).to_dict()
                for s in pair]
        stamp = os.path.join(DATA_ROOT, f"{name}.killed")
        if os.path.exists(stamp):
            os.remove(stamp)
        for i in range(DATA_WORKERS):
            p = ctx.Process(target=data_worker_child,
                            args=(i, DATA_WORKERS, cfgs, n_samples, vocab, 7,
                                  kill, stamp), daemon=True)
            p.start()
            procs.append(p)
        specs[name] = {"cfgs": cfgs, "stamp": stamp, "kill": kill,
                       "n_samples": n_samples}
    return specs, svcs, procs


def stop_data_services(specs, svcs, procs) -> None:
    from horovod_tpu_torch.data.compute_service import ComputeConfig
    for spec in specs.values():
        for c in spec["cfgs"]:
            try:
                ComputeConfig.from_dict(c).compute_client().shutdown()
            except OSError:
                pass
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    for s in svcs:
        s.stop()


def data_counter(M, name) -> float:
    snap = M.metrics_snapshot()
    return sum(s["value"] for s in snap[name]["series"]) if name in snap \
        else 0.0


def data_service_run(htt, fa, dev, rank, world, spec) -> dict:
    """(b) The flagship train cell (phase 4's configuration) through
    ``train_loop`` fed by a ``ResilientDataIterator`` over the run's
    ``DATA_WORKERS`` workers with an ``ElasticSampler``: a warm-up step on
    a batch of its own, then ``DATA_SERVICE_STEPS`` steps, each batch
    staged to the card by ``PinnedStager``; flash launch counts zeroed
    just before the loop and read just after."""
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.data.compute_service import (
        ComputeConfig, ResilientDataIterator, data_service)
    from horovod_tpu_torch.data.data_loader import PinnedStager
    from horovod_tpu_torch.elastic.sampler import ElasticSampler
    from horovod_tpu_torch.resilience import chaos
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    params = htt.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    init_fn, step = htt.make_transformer_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        device=dev)
    state = init_fn(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    warm = tuple(torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                               generator=gen, device=dev) for _ in range(2))
    state, loss = step(state, *warm)
    torch.cuda.synchronize()
    losses, stamps, resharded_at = [float(loss)], [], []
    service = ComputeConfig.from_dict(spec["cfgs"][0])
    sampler = ElasticSampler(spec["n_samples"], shuffle=True, seed=0,
                             rank=rank, num_replicas=world)
    stager = PinnedStager(dev)
    deaths0 = data_counter(M, "hvd_data_worker_deaths_total")
    reshards0 = data_counter(M, "hvd_data_reshards_total")
    with data_service(service, rank) as workers:
        it = ResilientDataIterator(workers, sampler, TRAIN_B, key=DATA_KEY,
                                   client=service.compute_client())

    def feed():
        seen = reshards0
        for items in it:
            now = data_counter(M, "hvd_data_reshards_total")
            if now > seen:
                resharded_at.append(time.time())
                seen = now
            a = np.stack(items)
            yield stager.finish(stager.stage((a[:, 0], a[:, 1])))

    def on_step(i, st, loss_t):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss_t))

    chaos.install(spec["kill"])
    fa.reset_launches()
    g0 = htt.goodput_report()
    t0 = time.perf_counter()
    try:
        state, info = htt.train_loop(step, state, feed(), on_step=on_step)
        torch.cuda.synchronize()
    finally:
        chaos.install(None)
        it.close()
    g1 = htt.goodput_report()
    launches = {k: fa.LAUNCHES[k]
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if info["final_step"] != DATA_SERVICE_STEPS + 1 or \
            info["status"] != "completed":
        raise AssertionError(f"train_loop info {info}")
    for name, n in launches.items():
        if n < cfg.n_layers * DATA_SERVICE_STEPS:
            raise AssertionError(f"{name} launched {n} times over "
                                 f"{DATA_SERVICE_STEPS} steps")
    wait = (g1["phases"].get("input_wait", 0.0)
            - g0["phases"].get("input_wait", 0.0))
    total = g1["total_seconds"] - g0["total_seconds"]
    killed_at = None
    if os.path.exists(spec["stamp"]):
        with open(spec["stamp"]) as f:
            killed_at = float(f.read())
    del state, params
    return {"losses": losses,
            "step_ms": [float(x) * 1e3 for x in np.diff([t0] + stamps)],
            "worker_deaths": data_counter(
                M, "hvd_data_worker_deaths_total") - deaths0,
            "reshards": data_counter(M, "hvd_data_reshards_total")
            - reshards0,
            "kill_to_reshard_s": (resharded_at[0] - killed_at
                                  if killed_at and resharded_at else None),
            "input_wait_share": wait / total if total > 0 else None,
            "processed": len(set(sampler.processed_indices)),
            "launches": launches}


def data_rank_runs(htt, cb, fa, rank, world, specs, dev="cuda"):
    """(a) and (b) on one rank of an initialized world, then this rank's
    pass over the clean run's source-sharded stream (``distribute``)."""
    from horovod_tpu_torch.data.compute_service import (ComputeConfig,
                                                        distribute)
    a = data_loader_resnet(htt, cb, rank, world, dev)
    torch.cuda.empty_cache()
    b = {}
    for name in ("clean", "kill"):
        b[name] = data_service_run(htt, fa, dev, rank, world, specs[name])
        torch.cuda.empty_cache()
    ids = sorted(int(x) for x in distribute(
        ComputeConfig.from_dict(specs["clean"]["cfgs"][1]), rank,
        job="pass0"))
    return a, b, ids


def data_rank(rank, world, ports, results, specs):
    """One rank of the N-card data world."""
    join_store_world(rank, world, ports, "cuda")
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = htt.init()
    if ctx.backend != "nccl" or htt.size() != world:
        raise AssertionError(f"expected an NCCL world of {world}")
    results.put((rank,) + data_rank_runs(htt, cb, fa, rank, world, specs))
    htt.shutdown()
    torch.distributed.destroy_process_group()


def report_data(card, ranks, world, specs) -> None:
    """Check (a) and (b) on every rank and print their lines."""
    ranks = sorted(ranks, key=lambda r: r[0])
    label = "" if world == 1 else " data parallel"
    for rank, a, b, _ in ranks:
        if not a["losses_bitwise_equal"]:
            raise AssertionError(f"rank {rank}: loaded losses "
                                 f"{a['losses_loaded']} != resident "
                                 f"{a['losses_resident']}")
        if not a["slices_equal_global"]:
            raise AssertionError(f"rank {rank}: the ranks' slices do not "
                                 f"concatenate to the global batch")
        if b["clean"]["losses"] != b["kill"]["losses"]:
            raise AssertionError(f"rank {rank}: killed losses "
                                 f"{b['kill']['losses']} != clean "
                                 f"{b['clean']['losses']}")
        if b["kill"]["worker_deaths"] < 1 or b["kill"]["reshards"] < 1 \
                or b["clean"]["worker_deaths"] != 0:
            raise AssertionError(f"rank {rank}: deaths/reshards "
                                 f"{b['kill']['worker_deaths']}/"
                                 f"{b['kill']['reshards']} killed, "
                                 f"{b['clean']['worker_deaths']} clean")
    ids = sorted(i for r in ranks for i in r[3])
    n = specs["clean"]["n_samples"]
    if ids != list(range(n)):
        raise AssertionError(f"distribute served {len(ids)} ids, not each "
                             f"of {n} once")
    a = ranks[0][1]
    log(f"data loader resnet50{label}: " + json.dumps(
        {"world": world, "batch_per_card": RESNET_B, "image": 224,
         "steps": DATA_STEPS, **a,
         "step_ms_loaded_median": pct(a["step_ms_loaded"], 50),
         "step_ms_resident_median": pct(a["step_ms_resident"], 50),
         "slices_equal_global_every_rank": all(
             r[1]["slices_equal_global"] for r in ranks),
         "losses_bitwise_every_rank": all(
             r[1]["losses_bitwise_equal"] for r in ranks),
         "card": card}))
    for rank, _, b, mine in ranks:
        log(f"data service train{label} rank {rank}: " + json.dumps(
            {"world": world, "batch_per_card": TRAIN_B, "seq": TRAIN_S,
             "steps": DATA_SERVICE_STEPS, "workers": DATA_WORKERS,
             "chaos": DATA_KILL, "clean": b["clean"], "kill": b["kill"],
             "losses_bitwise_equal": b["clean"]["losses"]
             == b["kill"]["losses"],
             "distribute_ids": len(mine), "card": card}))


def estimator_run(card, n) -> None:
    """(c) ``TpuEstimator.fit`` on the MNIST MLP through a ``TpuExecutor``
    of ``n`` workers on the cards (NCCL), twice on the same pool (the
    first fit pays each worker's one-time costs: imports at the first
    optimizer step, CUDA modules, communicators), then ``predict`` on the
    card against the CPU."""
    from horovod_tpu_torch.integrations import TpuEstimator, TpuExecutor
    from horovod_tpu_torch.models.mlp import MLP
    rng = np.random.RandomState(0)
    x = rng.rand(DATA_EST_ROWS, 28, 28).astype(np.float32)
    proj = rng.randn(28 * 28, 10).astype(np.float32)
    y = np.argmax(x.reshape(len(x), -1) @ proj, axis=1).astype(np.int64)
    t0 = time.perf_counter()
    with TpuExecutor(n) as ex:
        up_s = time.perf_counter() - t0
        cards = ex.run(torch.cuda.current_device)
        est = TpuEstimator(
            MLP(device="cpu"), loss="classification",
            batch_size=DATA_EST_BATCH, epochs=DATA_EST_EPOCHS, lr=1e-3,
            num_workers=n, executor=ex)
        fit_s, models = [], []
        for _ in range(2):
            t1 = time.perf_counter()
            models.append(est.fit(x, y))
            fit_s.append(time.perf_counter() - t1)
        peak = ex.run(torch.cuda.max_memory_allocated)
    model = models[0]
    hist = model.history
    if cards != list(range(n)) or min(peak) <= 0:
        raise AssertionError(f"estimator workers on cards {cards}, peak "
                             f"bytes {peak}")
    if not all(b < a for a, b in zip(hist, hist[1:])):
        raise AssertionError(f"estimator history not decreasing: {hist}")
    on_card = model.predict(x[:256])
    on_cpu = model.predict(x[:256], device="cpu")
    err = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    if not err <= DATA_PREDICT_TOL:
        raise AssertionError(f"predict on the card vs the CPU: {err}")
    log(f"estimator{'' if n == 1 else ' data parallel'}: " + json.dumps(
        {"workers": n, "worker_cards": cards, "rows": DATA_EST_ROWS,
         "batch": DATA_EST_BATCH, "epochs": DATA_EST_EPOCHS,
         "history": hist, "pool_start_s": up_s, "fit_s": fit_s,
         "second_fit_history_equal": models[1].history == hist,
         "worker_peak_gb": [p / 2 ** 30 for p in peak],
         "predict_card_vs_cpu": err, "tolerance": DATA_PREDICT_TOL,
         "card": card}))


def data_world_one(htt, cb, fa, card) -> None:
    """Phase 16 on one card: (a) and (b) in a world of one in this
    process (the data workers start first, as processes of their own),
    then (c)."""
    log("data path packages: " + json.dumps(data_packages()))
    t0 = time.perf_counter()
    specs, svcs, procs = start_data_services(1)
    try:
        ctx = htt.init()
        if ctx.backend != "nccl" or htt.size() != 1:
            raise AssertionError("expected an NCCL world of one")
        out = (0,) + data_rank_runs(htt, cb, fa, 0, 1, specs)
        htt.shutdown()
    finally:
        stop_data_services(specs, svcs, procs)
    report_data(card, [out], 1, specs)
    torch.cuda.empty_cache()
    estimator_run(card, 1)
    log(f"data path (world 1): {time.perf_counter() - t0:.1f} s")


def data_world(n, card) -> None:
    """``--data-parallel N --data-only``: (a) and (b) in an N-card world
    (one process a card; the data workers are processes of this one),
    then (c) with N executor workers."""
    log("data path packages: " + json.dumps(data_packages()))
    t0 = time.perf_counter()
    specs, svcs, procs = start_data_services(n)
    try:
        ranks = spawn_world(data_rank, n, n, DATA_WORLD_S, specs)
    finally:
        stop_data_services(specs, svcs, procs)
    report_data(card, ranks, n, specs)
    estimator_run(card, n)
    log(f"data path (world {n}): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the online tuner and the bucket auto-resolution
# ---------------------------------------------------------------------------

AT_ROOT = os.path.join(HERE, "build", "autotune")
AT_WARMUP = 1               # HOROVOD_AUTOTUNE_WARMUP_SAMPLES of the drill
AT_STEPS_PER_SAMPLE = 3     # coordinator cycles a sample
AT_SAMPLES = 8              # HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES
AT_MAX_STEPS = 40           # ResNet-50 steps the tuner may take to converge
AT_TIMED_STEPS = 5          # steps at the defaults and at the converged knobs
AT_SWEEP_STEPS = 3          # profiled steps a bucket candidate on N cards
AT_SWEEP_STEPS_ONE = 1      # the same on one card (NCCL launches nothing)
AT_WORLD_S = 900            # the N-card world's deadline
AT_TUNED = ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_CYCLE_TIME",
            "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_TORUS_ALLREDUCE")


def at_knobs(knobs, log_path, on=True) -> None:
    """The drill's tuner settings as overrides (cleared by the caller)."""
    knobs.set_override("HOROVOD_AUTOTUNE", on)
    knobs.set_override("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", AT_WARMUP)
    knobs.set_override("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
                       AT_STEPS_PER_SAMPLE)
    knobs.set_override("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", AT_SAMPLES)
    knobs.set_override("HOROVOD_AUTOTUNE_LOG", log_path if on else "")


def at_in_box(point) -> bool:
    """Every tuned value inside the tuner's box."""
    return (0 <= int(point["HOROVOD_FUSION_THRESHOLD"]) <= 64 << 20
            and 1.0 <= float(point["HOROVOD_CYCLE_TIME"]) <= 100.0
            and all(isinstance(point[k], bool) for k in AT_TUNED[2:]))


def at_resnet_steps(htt, C, cb, rank, world, dev, batch, image, n_steps,
                    out, tuned=True):
    """ResNet-50 (``fused_conv_bn=True``, seed 3) SGD steps through the
    coordinator from the gradient hooks (``cp_hooked_sync``), each timed
    by ``StepStats`` after a synchronize: until the tuner converges (at
    most AT_MAX_STEPS) when ``n_steps`` is None, else ``n_steps``. On
    several cards a second model takes the first's state before each step
    and steps through ``DistributedOptimizer``: its synced gradients and
    new parameters are held within API_MEAN_REL_TOL / PARAM_REL_TOL
    (cp_resnet_steps' tolerances). Fills ``out`` with each step's cycles
    and conv+BN launches, the tuner's points, scores (rank 0) and host us
    an update, and the knob sync's ms; returns (losses, parameters,
    model, sgd, sync, hooks)."""
    import copy
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops.coordinator import get_coordinator
    from horovod_tpu_torch.runtime.context import get_context
    ctx = get_context()
    coord = get_coordinator(ctx)
    mgr = coord.autotune
    if tuned and not (mgr.enabled or coord._param_sync is not None):
        raise AssertionError("autotune: the coordinator does not tune")
    points, update_us, kv_ms = [], [], {"publish": [], "apply": []}
    update = mgr.update

    def timed_update(nbytes):
        t0 = time.perf_counter()
        changed = update(nbytes)
        update_us.append((time.perf_counter() - t0) * 1e6)
        if changed:
            points.append({k: knobs.get(k) for k in AT_TUNED})
        return changed

    mgr.update = timed_update
    sync_ = coord._param_sync
    if sync_ is not None:
        for name in ("publish", "apply"):
            def timed(*a, _f=getattr(sync_, name), _n=name):
                t0 = time.perf_counter()
                _f(*a)
                kv_ms[_n].append((time.perf_counter() - t0) * 1e3)
            setattr(sync_, name, timed)
    models = [htt.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                           fused_conv_bn=True, device=dev, seed=3)
              for _ in range(2 if world > 1 else 1)]
    params = [list(m.parameters()) for m in models]
    sgds = [torch.optim.SGD(ps, lr=0.01, momentum=0.9) for ps in params]
    dopt = htt.DistributedOptimizer(sgds[1], op=htt.Average) \
        if world > 1 else None
    hsync, hooks = cp_hooked_sync(htt, params[0])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    stats = htt.StepStats()
    losses, cycles, launches, errs = [], [], [], []
    step = 0
    while (step < n_steps if n_steps is not None
           else not (mgr.converged and (sync_ is None or sync_.done))
           and step < AT_MAX_STEPS):
        x, y = api_batch(dev, 70 + step, rank, batch, image)
        if dopt is not None and step:
            with torch.no_grad():
                for a, b in zip(models[0].state_dict().values(),
                                models[1].state_dict().values()):
                    b.copy_(a)
            sgds[1].load_state_dict(copy.deepcopy(sgds[0].state_dict()))
        c0 = coord.stats.cycles
        cb.reset_launches()
        sync()
        stats.begin()
        loss = resnet_loss(models[0], x, y)
        loss.backward()
        hsync()
        sgds[0].step()
        sync()
        stats.end()
        launches.append(check_launches(cb, dev, f"autotune step {step}"))
        cycles.append(coord.stats.cycles - c0)
        losses.append(loss.detach().clone())
        if dopt is not None:
            resnet_loss(models[1], x, y).backward()
            dopt.step()
            for what, got, ref, rel in (
                    ("grad", [p.grad for p in params[0]],
                     [p.grad for p in params[1]], API_MEAN_REL_TOL),
                    ("param", [p.detach() for p in params[0]],
                     [p.detach() for p in params[1]], PARAM_REL_TOL)):
                err, share = leaf_errors(got, [r.double() for r in ref], rel)
                errs.append({"step": step, "what": what, "max_abs_err": err,
                             "share_of_limit": share})
                if share > 1:
                    raise AssertionError(
                        f"autotune step {step}: {what}s off "
                        f"DistributedOptimizer's by {err} ({share} of the "
                        f"limit)")
            dopt.zero_grad()
        sgds[0].zero_grad()
        step += 1
    mgr.update = update
    if dopt is not None:
        dopt._launcher.remove_hooks()
        del models[1], params[1], sgds[1], dopt
    out.update(steps=step, cycles_per_step=cycles,
               conv_bn_launches_per_step=launches,
               tuner_update_us_median=(float(np.median(update_us))
                                       if update_us else None),
               tuner_update_us_max=max(update_us) if update_us else None,
               tuner_updates=len(update_us), points=points)
    if errs:
        out["vs_distributed_optimizer"] = {
            w: max(e["share_of_limit"] for e in errs if e["what"] == w)
            for w in ("grad", "param")}
    if sync_ is not None:
        out["kv_ms_per_cycle"] = {k: (float(np.median(v)) if v else None)
                                  for k, v in kv_ms.items()}
        out["kv_cycles"] = {k: len(v) for k, v in kv_ms.items()}
        out["history"] = json.dumps(sync_.history, sort_keys=True)
    return losses, params[0], models[0], sgds[0], hsync, hooks


def at_timed_turns(htt, model, sgd, hsync, rank, dev, batch, image,
                   converged) -> dict:
    """Median step ms (host clock, after a synchronize) of AT_TIMED_STEPS
    steps at the defaults and at the converged knobs, in turns."""
    from horovod_tpu_torch.config import knobs
    ms = {"defaults": [], "converged": []}
    for i in range(2 * AT_TIMED_STEPS + 2):
        label = ("defaults", "converged")[i % 2]
        for k in AT_TUNED:
            if label == "converged":
                knobs.set_override(k, converged[k])
            else:
                knobs.clear_override(k)
        x, y = api_batch(dev, 200 + i, rank, batch, image)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resnet_loss(model, x, y).backward()
        hsync()
        sgd.step()
        torch.cuda.synchronize()
        if i >= 2:
            ms[label].append((time.perf_counter() - t0) * 1e3)
        sgd.zero_grad()
    for k in AT_TUNED:
        knobs.clear_override(k)
    return {f"step_ms_{k}": float(np.median(v)) for k, v in ms.items()} | {
        f"step_ms_{k}_all": v for k, v in ms.items()}


def at_measure(htt, model, params, rank, dev, batch, image, steps, root):
    """``measure(bucket_bytes)`` for ``sweep_bucket_bytes``: one warm-up
    step and then ``steps`` steps, each a ``StepProfiler`` window of its
    own, through a ``DistributedOptimizer`` at that bucket size; a
    ``profiled_step_row`` each. The ranks meet at a barrier before each
    window, so no rank's NCCL kernels wait out another's trace export."""
    import shutil
    import torch.distributed as dist
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.tracing.profile import (StepProfiler,
                                                   read_trace_events)

    def measure(bucket_bytes):
        knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", bucket_bytes)
        opt = htt.DistributedOptimizer(torch.optim.SGD(params, lr=0.01),
                                       op=htt.Average)
        try:
            sizes = [sum(params[i].numel() * params[i].element_size()
                         for i in b) for b in opt.buckets]
            rows = []
            for s in range(steps + 1):
                x, y = api_batch(dev, 300 + s, rank, batch, image)
                prof = None
                if s:
                    if dist.is_initialized():
                        dist.barrier()
                    prof = StepProfiler(1, 1, log_dir=os.path.join(
                        root, f"rank{rank}-{bucket_bytes >> 20}-{s}"))
                    prof.on_step_end(0)
                resnet_loss(model, x, y).backward()
                opt.step()
                opt.zero_grad()
                if prof is not None:
                    prof.on_step_end(1)
                    rows.append(autotune.profiled_step_row(
                        read_trace_events(prof.trace_path), sizes,
                        device=dev.type == "cuda"))
                    shutil.rmtree(prof.log_dir, ignore_errors=True)
            return rows
        finally:
            opt._launcher.remove_hooks()
            knobs.clear_override("HOROVOD_GRADIENT_BUCKET_BYTES")

    return measure


def at_sweep_summary(rec) -> dict:
    """A sweep record's candidates in ms."""
    return {str(int(bb) >> 20) + "MiB": {
        "exposed_nccl_ms": r["exposed_comm_s"] * 1e3,
        "exposed_nccl_ms_spread": [v * 1e3 for v in
                                   r["exposed_comm_s_spread"]],
        "nccl_ms": r["comm_s"] * 1e3, "collectives": r["collectives"]}
        for bb, r in rec["sweep"]["candidates"].items()}


def at_resolved(htt, params) -> int:
    """The bucket size a fresh ``DistributedOptimizer`` resolved (the
    ``hvd_gradient_bucket_bytes`` gauge), its hooks removed."""
    from horovod_tpu_torch import metrics as M
    opt = htt.DistributedOptimizer(torch.optim.SGD(params, lr=0.01),
                                   op=htt.Average)
    opt._launcher.remove_hooks()
    return int(M.get_registry().get(
        "hvd_gradient_bucket_bytes").value)


def at_store_child(rank, world, ports, results, leaves, store_dir, cache,
                   workload):
    """A fresh process on the artifact store of phase 17 (b): the sweep
    of the same model and world comes warm, measuring nothing."""
    os.environ["HOROVOD_ARTIFACT_STORE"] = store_dir
    os.environ["HOROVOD_BUCKET_AUTO_CACHE"] = cache
    from horovod_tpu_torch import autotune

    def measure(bucket_bytes):
        raise AssertionError("the warm sweep measured a candidate")

    rec = autotune.sweep_bucket_bytes(measure, 1, workload=workload,
                                      leaves=leaves)
    results.put({"warm": rec["warm"],
                 "measured_candidates": rec["measured_candidates"],
                 "winner_bucket_bytes": rec["winner_bucket_bytes"],
                 "cache": autotune.bucket_cache_load()})


def at_bucket_auto_one(htt, model, params, dev, batch, image, out) -> None:
    """Phase 17 (b) in a world of one."""
    import logging
    import shutil
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.store import artifact_store
    root = os.path.join(AT_ROOT, "bucket_auto")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    store_dir = os.path.join(root, "store")
    knobs.set_override("HOROVOD_BUCKET_AUTO_CACHE",
                       os.path.join(root, "bucket_auto.json"))
    knobs.set_override("HOROVOD_ARTIFACT_STORE", store_dir)
    artifact_store.reset_for_tests()
    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda rec: warnings.append(rec.getMessage())
    logger = logging.getLogger("horovod_tpu_torch.autotune")
    logger.addHandler(handler)
    leaves = [(tuple(p.shape), p.dtype) for p in params]
    try:
        knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", "auto")
        miss = [at_resolved(htt, params) for _ in range(2)]
        if miss != [autotune.DEFAULT_BUCKET_BYTES] * 2 or len(warnings) != 1:
            raise AssertionError(f"bucket auto miss: {miss}, {warnings}")
        knobs.clear_override("HOROVOD_GRADIENT_BUCKET_BYTES")
        t0 = time.perf_counter()
        rec = autotune.sweep_bucket_bytes(
            at_measure(htt, model, params, 0, dev, batch, image,
                       AT_SWEEP_STEPS_ONE, root),
            1, workload="resnet50", leaves=leaves)
        sweep_s = time.perf_counter() - t0
        knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", "auto")
        hit = at_resolved(htt, params)
        if rec["warm"] or hit != rec["winner_bucket_bytes"]:
            raise AssertionError(f"bucket auto: sweep {rec['warm']}, "
                                 f"resolved {hit}")
        (child,) = spawn_world(
            at_store_child, 1, 1, 300,
            [(s, str(d).replace("torch.", "")) for s, d in leaves],
            store_dir, os.path.join(root, "child_cache.json"), "resnet50")
        sig = autotune.grad_signature(leaves, 1)
        if not (child["warm"] and child["measured_candidates"] == 0
                and child["winner_bucket_bytes"] == hit
                and child["cache"] == {sig: hit}):
            raise AssertionError(f"bucket auto child: {child}")
    finally:
        logger.removeHandler(handler)
        for k in ("HOROVOD_GRADIENT_BUCKET_BYTES", "HOROVOD_ARTIFACT_STORE",
                  "HOROVOD_BUCKET_AUTO_CACHE"):
            knobs.clear_override(k)
        artifact_store.reset_for_tests()
    out.update(miss_bytes=miss[0], miss_warnings=len(warnings),
               sweep_seconds=sweep_s, candidates=at_sweep_summary(rec),
               winner_bucket_bytes=rec["winner_bucket_bytes"],
               resolved_by_fresh_optimizer=hit,
               measured_candidates=rec["measured_candidates"],
               child=child)


def autotune_world_one(htt, cb, card, dev="cuda", batch=RESNET_B,
                       image=224) -> None:
    """Phase 17 in a world of one: (a) the tuned run and its untuned
    twin, the timed turns; (b) the bucket auto-resolution."""
    import shutil
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops import collectives as C
    shutil.rmtree(AT_ROOT, ignore_errors=True)
    os.makedirs(AT_ROOT)
    log_path = os.path.join(AT_ROOT, "autotune.csv")
    t0 = time.perf_counter()
    out = {"card": card}
    try:
        at_knobs(knobs, log_path)
        ctx = htt.init(device=dev)
        dev_ = ctx.device
        torch.cuda.reset_peak_memory_stats()
        tuned_out = {}
        losses, params, model, sgd, hsync, hooks = at_resnet_steps(
            htt, C, cb, 0, 1, dev_, batch, image, None, tuned_out)
        coord = ctx.coordinator
        mgr = coord.autotune
        out["peak_gb_tuned_run"] = torch.cuda.max_memory_allocated() / 1e9
        out["fusion_buffer_bytes"] = coord.buffers.nbytes()
        with open(log_path) as f:
            rows = [r.split(",") for r in f.read().strip().splitlines()]
        converged = {k: knobs.get(k) for k in AT_TUNED}
        if not mgr.converged or len(rows) != AT_SAMPLES:
            raise AssertionError(f"autotune: converged {mgr.converged}, "
                                 f"{len(rows)} CSV rows")
        if not all(at_in_box(p) for p in tuned_out["points"] + [converged]):
            raise AssertionError(f"autotune: a point outside the box: "
                                 f"{tuned_out['points']}")
        out.update(tuned_out, converged=converged,
                   scores=[float(r[1]) for r in rows])
        out.update(at_timed_turns(htt, model, sgd, hsync, 0, dev_, batch,
                                  image, converged))
        for h in hooks:
            h.remove()
        del model, sgd, params
        htt.shutdown()
        torch.cuda.empty_cache()
        # the untuned twin: as many steps from the same weights and batches
        at_knobs(knobs, log_path, on=False)
        htt.init(device=dev)
        torch.cuda.reset_peak_memory_stats()
        twin = {}
        ref, ref_params, model, _, _, hooks = at_resnet_steps(
            htt, C, cb, 0, 1, dev_, batch, image, tuned_out["steps"], twin,
            tuned=False)
        out["peak_gb_untuned_run"] = torch.cuda.max_memory_allocated() / 1e9
        out["losses"] = [float(v) for v in losses]
        if not all(torch.equal(a, b) for a, b in zip(losses, ref)):
            raise AssertionError(f"autotune: tuned losses {out['losses']} "
                                 f"differ from the untuned run's "
                                 f"{[float(v) for v in ref]}")
        out["losses_bitwise_untuned"] = len(ref)
        for h in hooks:
            h.remove()
        bucket = {}
        at_bucket_auto_one(htt, model, ref_params, dev_, batch, image,
                           bucket)
        del model, ref_params
    finally:
        htt.shutdown()
        knobs.clear_all_overrides()
    if knobs._overrides:
        raise AssertionError(f"autotune: overrides left {knobs._overrides}")
    out["overrides_cleared"] = True
    out["seconds"] = time.perf_counter() - t0
    log("autotune (world 1): " + json.dumps(out))
    bucket["card"] = card
    log("autotune bucket auto (world 1): " + json.dumps(bucket))


def autotune_rank(rank, world, ports, results, device="cuda",
                  batch=RESNET_B, image=224):
    """One rank of ``--data-parallel N --autotune-only``."""
    import torch.distributed as dist
    join_store_world(rank, world, ports, device)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.store import artifact_store
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.join(AT_ROOT, "data_parallel")
    at_knobs(knobs, os.path.join(root, f"autotune-rank{rank}.csv"))
    knobs.set_override("HOROVOD_BUCKET_AUTO_CACHE",
                       os.path.join(root, "bucket_auto.json"))
    knobs.set_override("HOROVOD_ARTIFACT_STORE", os.path.join(root, "store"))
    artifact_store.reset_for_tests()
    ctx = htt.init(device=device)
    dev = ctx.device
    out = {"rank": rank, "world": world}
    t0 = time.perf_counter()
    _, params, model, sgd, _, hooks = at_resnet_steps(
        htt, C, cb, rank, world, dev, batch, image, None, out)
    coord = ctx.coordinator
    if rank == 0:
        with open(os.path.join(root, "autotune-rank0.csv")) as f:
            out["scores"] = [float(r.split(",")[1])
                             for r in f.read().strip().splitlines()]
    out["converged"] = bool(coord.autotune.converged)
    out["tuning"] = bool(coord.autotune.enabled)
    out["sync_done"] = bool(coord._param_sync.done)
    out["knobs"] = {k: knobs.get(k) for k in AT_TUNED}
    if not same_on_every_rank(C, params):
        raise AssertionError("autotune: parameters differ between ranks")
    out["params_bitwise_equal"] = True
    out["tune_seconds"] = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    del sgd
    t0 = time.perf_counter()
    rec = autotune.sweep_bucket_bytes(
        at_measure(htt, model, params, rank, dev, batch, image,
                   AT_SWEEP_STEPS, root),
        world, workload="resnet50",
        leaves=[(tuple(p.shape), p.dtype) for p in params])
    out["sweep_seconds"] = time.perf_counter() - t0
    out["candidates"] = at_sweep_summary(rec)
    out["winner_bucket_bytes"] = rec["winner_bucket_bytes"]
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", "auto")
    out["resolved"] = at_resolved(htt, params)
    results.put(out)
    htt.shutdown()
    knobs.clear_all_overrides()
    dist.destroy_process_group()


def autotune_world(n, card, **kw) -> None:
    """``autotune_rank`` in ``n`` spawned processes; the ``autotune data
    parallel:`` line (rank 0's numbers, every rank's history and
    resolution checked equal)."""
    import shutil
    shutil.rmtree(os.path.join(AT_ROOT, "data_parallel"),
                  ignore_errors=True)
    os.makedirs(os.path.join(AT_ROOT, "data_parallel"))
    ranks = sorted(spawn_world(autotune_rank, n, n, AT_WORLD_S, **kw),
                   key=lambda r: r["rank"])
    lead = ranks[0]
    if not (lead["converged"] and lead["tuning"]
            and not any(r["tuning"] for r in ranks[1:])
            and all(r["sync_done"] for r in ranks)):
        raise AssertionError(f"autotune data parallel: not converged or "
                             f"not leader-tuned: {ranks}")
    if len({r["history"] for r in ranks}) != 1 or \
            len({json.dumps(r["knobs"], sort_keys=True)
                 for r in ranks}) != 1:
        raise AssertionError("autotune data parallel: the ranks' knob "
                             "histories differ")
    resolved = [r["resolved"] for r in ranks]
    if resolved != [lead["winner_bucket_bytes"]] * n:
        raise AssertionError(f"autotune data parallel: resolutions "
                             f"{resolved}, rank 0's winner "
                             f"{lead['winner_bucket_bytes']}")
    out = {k: v for k, v in lead.items() if k not in ("rank", "history")}
    out.update(card=card, history_cycles=len(json.loads(lead["history"])),
               histories_equal=True, resolved_every_rank=resolved,
               follower_kv_ms_per_cycle=[r["kv_ms_per_cycle"]
                                         for r in ranks[1:]],
               winners_by_rank=[r["winner_bucket_bytes"] for r in ranks])
    log("autotune data parallel: " + json.dumps(out))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if argv[:1] == ["--worker"] and len(argv) == 3:
        return worker_main(argv[1], argv[2])
    n_dp = 0
    data_one = argv == ["--data-only"]
    if data_one:
        argv = []
    resilient_only = argv[2:] == ["--resilient-only"]
    api_only = argv[2:] == ["--api-only"]
    launcher_only = argv[2:] == ["--launcher-only"]
    mp_only = argv[2:] == ["--model-parallel-only"]
    cp_only = argv[2:] == ["--control-plane-only"]
    zoo_only = argv[2:] == ["--zoo-only"]
    fleet_only = argv[2:] == ["--fleet-only"]
    obs_only = argv[2:] == ["--observability-only"]
    store_only = argv[2:] == ["--store-only"]
    data_only = argv[2:] == ["--data-only"]
    autotune_only = argv[2:] == ["--autotune-only"]
    if argv:
        if len(argv) not in (2, 3) or argv[0] != "--data-parallel" or \
                (len(argv) == 3 and not (resilient_only or api_only
                                         or launcher_only or mp_only
                                         or cp_only or zoo_only
                                         or fleet_only or obs_only
                                         or store_only or data_only
                                         or autotune_only)):
            print("usage: chip_smoke.py [--data-only | --data-parallel N "
                  "[--resilient-only | --api-only | --launcher-only | "
                  "--model-parallel-only | --control-plane-only | "
                  "--zoo-only | --fleet-only | --observability-only | "
                  "--store-only | --data-only | --autotune-only]]",
                  file=sys.stderr)
            return 2
        n_dp = int(argv[1])
        if not 2 <= n_dp <= torch.cuda.device_count():
            print(f"chip_smoke: --data-parallel {n_dp} needs 2..."
                  f"{torch.cuda.device_count()} cards", file=sys.stderr)
            return 2
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import stream_copy as sc
    from horovod_tpu_torch.parallel import sequence as sq
    from horovod_tpu_torch.serving import kv_cache as kvc

    # phase 1: setup
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: "
        + json.dumps({k: round(v, 2) for k, v in seconds.items()}))
    for name, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            log(f"  [{name}] {line}")
    # ptxas notes C75xx when it serializes or fences wgmma behind the
    # source's back (PERF.md)
    log("ptxas C75xx notes per library: " + json.dumps(
        {name: text.count("(C75") for name, text in _build.build_logs.items()}))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if n_dp:
        only = (resilient_only or api_only or launcher_only or mp_only
                or cp_only or zoo_only or fleet_only or obs_only
                or store_only or data_only or autotune_only)
        if not only:
            collectives_n_cards(n_dp, card)
            data_parallel(n_dp, card)
        if not only or api_only:
            horovod_api_world(n_dp, card)
        if not only or resilient_only:
            resilient_world(n_dp, card)
        if not only or launcher_only:
            launcher_worlds(n_dp, card)
        if not only or mp_only:
            model_parallel_world(n_dp, card)
        if not only or cp_only:
            control_plane_world(n_dp, card)
        if not only or zoo_only:
            zoo_data_parallel(n_dp, card)
        if not only or fleet_only:
            fleet_n_cards(n_dp, card)
        if not only or obs_only:
            observability_world(n_dp, card)
        if not only or store_only:
            artifact_store_world(n_dp, card)
        if not only or data_only:
            data_world(n_dp, card)
        if not only or autotune_only:
            autotune_world(n_dp, card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if data_one:
        data_world_one(htt, cb, fa, card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)

    # phase 2: every kernel against its plain version
    main_case = check_kernel(fa, kvc, gen, kvh=16, dtype=torch.bfloat16,
                             timed=True)
    errs = [main_case["max_abs_err"]]
    errs.append(check_kernel(fa, kvc, gen, kvh=4, dtype=torch.bfloat16,
                             timed=True)["max_abs_err"])
    check_kernel(fa, kvc, gen, kvh=16, dtype=torch.float32, timed=False)
    # a card's heads under TP serving at tp4 (--data-parallel 4)
    errs.append(check_kernel(fa, kvc, gen, h=4, kvh=4, dtype=torch.bfloat16,
                             timed=False)["max_abs_err"])
    # the speculative verify step's geometry (phase 12)
    verify_case = check_kernel_verify(fa, kvc, gen)
    errs.append(verify_case["max_abs_err"])
    flash_case, flash_errs = check_flash_all(fa, sq, gen)
    conv_case, conv_errs = check_conv_all(cb, gen)
    copy_case = check_stream_copy(sc, gen)
    copy_launches = bandwidth(sc, card)

    # phase 3: serving at full width
    launches, live_err = serve_flagship(htt, fa, kvc, card)
    errs.append(live_err)

    # phase 4: training at full width and depth
    train_launches, unfused_losses, unfused_params = train_flagship(
        htt, fa, card)
    train_flagship_fused(htt, fa, card, unfused_losses, unfused_params)
    del unfused_params
    resnet_launches = train_resnet50(htt, cb, card)
    uninterrupted, handoff = resilient_train(htt, fa, card)

    # phase 5: card against CPU
    card_vs_cpu(htt)
    train_card_vs_cpu(htt)
    resnet_card_vs_cpu(htt)
    fused_card_vs_cpu(htt)

    # phase 6: the collectives through NCCL in a world of one
    collectives_world_one(htt)

    # phase 7: Horovod's PyTorch API in a world of one
    horovod_api_world_one(htt, card)

    # phase 8: the launcher and elastic training in a world of one (the
    # launched processes share the card with this one)
    torch.cuda.empty_cache()
    launcher_world_one(card, uninterrupted)

    # phase 9: model parallelism in a world of one
    torch.cuda.empty_cache()
    model_parallel_world_one(htt, fa, sq, card)

    # phase 10: the control plane (the coordinator's cycle thread)
    torch.cuda.empty_cache()
    control_plane_world_one(htt, cb, card)

    # phase 11: the model zoo on one card
    torch.cuda.empty_cache()
    zoo_one_card(htt, card)

    # phase 12: speculative serving and the train-to-serve handoff
    torch.cuda.empty_cache()
    spec_serving(htt, fa, card, handoff)

    # phase 13: the serving fleet and the metrics export on one card
    torch.cuda.empty_cache()
    fleet_world_one(htt, fa, card)

    # phase 14: the matmul precision knob, the profile window, the
    # numerics monitor and the run ledger
    torch.cuda.empty_cache()
    observability_world_one(htt, fa, cb, card)

    # phase 15: the compiled-artifact store, in processes of their own
    torch.cuda.empty_cache()
    artifact_store_world_one(card)

    # phase 16: the data path: the loaders, the data service with its
    # worker-kill drill, and the estimator through the executor
    torch.cuda.empty_cache()
    data_world_one(htt, cb, fa, card)

    # phase 17: the online tuner on the coordinator's cycles and the
    # bucket auto-resolution
    torch.cuda.empty_cache()
    autotune_world_one(htt, cb, card)

    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/paged_decode.cu",
        "replaces": "horovod_tpu/ops/pallas/flash_attention.py:498",
        "launches": launches["paged_decode"],
        "max_abs_err": max(errs),
        **{k_: main_case[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "event_ms", "library_event_ms")},
        "verify_geometry": {k_: verify_case[k_] for k_ in (
            "rows", "max_abs_err", "rows_equal_at_m8_and_m40", "ms",
            "bound_ms")}}]
    # The plain backward computes dq, dk and dv in one function, and one
    # library backward computes all three: both times stand for the pair
    # (the library's on the dq row only).
    flash_rows = (
        ("flash_fwd", "flash_fwd.cu", 86, flash_case["plain_fwd_ms"],
         flash_case["library_fwd_ms"]),
        ("flash_bwd_dq", "flash_bwd.cu", 239, flash_case["plain_bwd_ms"],
         flash_case["library_bwd_ms"]),
        ("flash_bwd_dkv", "flash_bwd.cu", 285, flash_case["plain_bwd_ms"],
         None))
    for name, src, line, plain_ms, lib_ms in flash_rows:
        bound_ms, bound_by, _ = flash_case["bounds"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{src}",
            "replaces": f"horovod_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": flash_errs[name],
            "ms": flash_case["ms"][name], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    # The conv+BN rows carry the stage-1 expand conv (M = 401,408, 64 ->
    # 256, bf16, prologue), the largest of the path; no single PyTorch call
    # computes a GEMM with BN statistics, so library_ms is null (the cuBLAS
    # GEMM alone is printed beside the kernels). Its outputs' scales differ
    # by up to 1e5 (y against sum(y^2)), so beside the largest absolute
    # error over them each output's own error and its largest share of its
    # limit (CONV_REL_TOL of its largest value) are listed.
    main_conv = conv_case["main"]
    for name, line, outs in (("conv_bn_fwd", 78, "y s1 s2"),
                             ("conv_bn_bwd", 137, "dx dw dinv dshift")):
        bound_ms, bound_by = main_conv["bounds"][name]
        by_out = {nm: conv_errs[nm] for nm in outs.split()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{name}.cu",
            "replaces": f"horovod_tpu/ops/pallas/conv_bn.py:{line}",
            "launches": resnet_launches[name],
            "max_abs_err": max(e for e, _ in by_out.values()),
            "max_abs_err_by_output": {nm: e for nm, (e, _) in by_out.items()},
            "share_of_limit_by_output": {nm: s for nm, (_, s)
                                         in by_out.items()},
            "ms": main_conv["ms"][name],
            "plain_ms": main_conv["plain_ms"][name],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "resnet50_step": conv_case[f"{name[-3:]}_step"],
            "routes": resnet_launches[f"{name}_routes"]})
    # The stream copy: its main path is the bandwidth probe; timed at the
    # probe's shape (bf16 [131072, 1024]). The plain version is
    # out.copy_(x), and copy_ alone is the library yardstick.
    kernels.append({
        "name": "stream_copy", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/stream_copy.cu",
        "replaces": "bench.py:815", "launches": copy_launches,
        **{k_: copy_case[k_] for k_ in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
