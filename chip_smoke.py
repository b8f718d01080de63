#!/usr/bin/env python3
"""Drive the PyTorch port (``dmlc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--parent DIR]
    python3 chip_smoke.py --only cloud|tracker|service|faults|surface|adam [--repeat N]

Phases, each printing one JSON line; any failure exits non-zero:

1. environment: the card, torch/CUDA versions, the build times of the CUDA
   kernel library and the native parser (both built here from the
   checkout's sources; a native parser that does not build fails the run,
   no phase falls back to the numpy engine), and a plain local
   ``create_parser`` returning the fused native reader
   (``NativeStreamParser``, engine ``native``). Every later phase parses
   with it unless it names the registry stack
   (``DMLC_TPU_NO_NATIVE_READER=1``);
2. kernel K1 (``csrc/ell_matvec.cu``) and its ``dw`` kernel
   (``csrc/ell_matvec_dw.cu``) against their plain PyTorch versions at the
   shapes the JAX package cares about and a large HIGGS-shaped batch —
   values with rtol 1e-5 / atol 1e-4, ``dw`` within 1e-4 + 1e-5 of each
   slot's absolute sum and bit-identical over two launches, gradients
   through autograd — with device times beside the plain versions',
   ``F.embedding_bag``'s and ``index_add_``'s (the one PyTorch call for
   each) and the bytes bounds; ``dw`` also from unaligned inputs, which
   take its warp-bin route, timed beside the tile route; values only at
   shapes that reach K1's other branches (32 lanes a row, a table too
   wide for shared memory, a part-filled warp) and at large batches with
   a ragged last tile; with ``--parent DIR`` also the parent commit's K1,
   built from ``DIR``, timed in turns with this one (P C C P) and
   bit-equal to it up to 65,536 rows (this one's unsharded call, window
   0), within tolerance above, where the parent took a route that went;
3. the main path at full width: a HIGGS-shaped libsvm corpus (28 dense
   features; UCI dataset 280, 11,000,000 rows, cut to 2**20 rows for the
   time limit) -> create_parser -> DeviceIter(ell) -> LinearLearner ->
   fit(2 epochs) -> accuracy, with the K1 and ``dw`` launch counts of that
   run, the first 20 step losses held against the same batches on the CPU,
   and those 20 steps run twice on the card, bit-identical; the step's
   kernels hold no scatter-add;
4. one epoch of the dense layout on the same corpus through the dense
   emit (the parser's dense blocks, no CSR block), then one through the
   CSR route (each block densified on the producer), rows/s and stall
   share side by side;
5. kernel K2 (``csrc/widen_span.cu``), one launch a warm batch, against
   its plain PyTorch version (``decode_batch_plain``), bit for bit, on a
   batch of each kind a snapshot stores at the main path's widths (ELL
   8192x28; packed dense 8192x31 f32, bf16 with its widened label and
   weight, and int8 with its scale row; unpacked dense 8192x29 f32 and
   bf16), laid out as a snapshot lays them out (64-byte-aligned segments)
   and from an unaligned start, one launch counted a batch; with its device
   time beside the plain version's, the one PyTorch call computing the same
   decode where there is one (a slab's ``clone``, q8's promoting multiply),
   the bytes bound and the host's dispatch time; with ``--parent DIR`` also
   the parent commit's route (a launch of its K2 a float segment, then
   torch's cast and multiply or ``.to(float32)``), built from ``DIR`` and
   timed in turns with this one. Then K2 on one segment
   (``widen_span_cuda``) at the shapes of earlier slices (HIGGS packed
   dense 8192x30 and 8192x31, f32 and bf16; ELL values 8192x28; a
   lane-aligned 8192x1024; an odd 1000x7), from aligned and unaligned
   starts, beside ``seg.view(dtype).reshape(rows, cols).clone()``;
6. the warm main path: ``create_parser(snapshot=)`` -> ``DeviceIter(ell,
   device_decode=True)`` -> ``fit(3 epochs)`` -> ``accuracy``: epoch 1 is
   cold and writes the snapshot, epochs 2-3 and the accuracy pass decode
   each batch on the card in exactly one K2 launch (and step through K1),
   with per-epoch rows/s, stall share, decode dispatch a batch and the
   snapshot and decode counters, and a profiled window of steps fed by a
   warm device-decode epoch; then a cold plus a warm device-decode epoch of
   packed dense f32, bf16 and int8 (``snapshot_quant="int8"``), each with
   exactly one K2 launch a warm batch; the first 8 warm device-decode
   batches of each held against the host-decode warm path's, byte for byte
   (``x``, ``y`` and ``w`` too); one warm bf16 and one warm int8 batch's
   decode under ``torch.profiler``, where K2 must be the one kernel; and
   healing: a byte flipped in a warm batch of a small snapshot, the warm
   device-decode epoch equal to the cold one byte for byte after one
   pipeline restart;
7. checkpoints on the main path: on the registry stack, a cold ELL epoch
   checkpointed after 37 batches (the DeviceIter state through JSON, the
   parameters through numpy), closed and resumed in a fresh pipeline by a
   seek of the split (under 0.8 of the corpus read), to the uninterrupted
   epoch's weight and bias exactly (``torch.equal``); the same on the
   fused native reader, whose state is a count the restore replays (91
   batches after it, the weights equal, the uninterrupted epoch's weights
   equal to the registry stack's, the share of the corpus read reported);
   on phase 6's snapshot, a warm checkpoint
   and the cold one each resumed into a fresh warm device-decode pipeline:
   the remaining batches bit-equal to the uninterrupted warm epoch's, one
   K2 launch each, the same final weights; with the load time, the time to
   the first batch and the restored epoch's rows/s;
8. the bcoo layout: ``DeviceIter(layout="bcoo", batch_size=8192,
   max_nnz=28)`` -> ``LinearLearner(layout="bcoo")``, the first 20 steps
   under CUDA's sync debug mode "error" and within 1e-4 relative of the
   same batches on the CPU, the first batch's dense form equal to the CPU
   route's; a fresh epoch and an accuracy pass (above 0.9, one nnz shape
   crossed), rows/s and stall share, the step's device time on a resident
   batch beside the ELL step's, 20 of each step enqueued behind a device
   spin without waiting for it (no host sync, also none inside a library),
   the first 20 steps run twice and bit-identical (the gradient's row
   scatter has no atomics), and one epoch of natural blocks
   (``batch_size=None``) with a finite loss; then ``coo_matmul``'s two
   forward routes on one coalesced batch, torch's sparse product and the
   row scatter, in turns for a ``[D]`` and a ``[D, 8]`` table, within
   tolerance of each other, and the step on each (``coo_forward_ab``: the
   measurement that keeps the product for a batch marked coalesced);
9. ALS at ``examples/train_als.py``'s full size (4096 users, 512 items, 16
   factors, 32 ratings a row, batch 512, reg 0.05): create_parser ->
   DeviceIter(ell) -> AlsLearner -> fit(4 epochs) -> eval_loss, the epoch
   losses finite and falling, the row scatter (``csrc/row_scatter.cu``)
   launched for each step's gram and rhs (one buffer); 20 card steps and
   ``finalize_items`` run twice, bit-identical, and within 1e-4 relative
   of the same steps on the CPU; a checkpoint at batch 2 of epoch 2
   resumed in fresh objects, the loss tail byte for byte; 20 steps
   enqueued behind device spins (two groups of 10, inside the card's
   launch queue); the step's device time and host wall.
   Then the A/B of the routes for a row scatter (``index_add_``,
   ``index_put_(accumulate=True)``, the kernel) at the ALS shapes, a
   larger ALS shape, a 1-D table above ``DW_MAX_TABLE``, phase 10's and
   phase 13's shapes, and the bcoo forward's (row-ordered ids into
   ``[8192, 1]`` and ``[16384, 1]``): bits over two runs, device time, enqueue behind a
   spin, the kernel within 1e-4 + 1e-5 of each word's absolute sum of its
   plain version and bit for bit equal to the plain version that sums in
   its order (``row_scatter_add_ordered_plain``), overwriting and
   accumulating onto a table holding -0.0 words; at the 1-D
   tables wider than ``DW_MAX_TABLE`` the row scatter of ``val * g``
   against K1's ``dw`` route there (zeros + ``index_add_``), the A/B that
   decides ``dw_route``; with ``--parent DIR`` the parent commit's row
   scatter, built from ``DIR``, timed in turns with this one (P C C P)
   and bit for bit equal to it (accumulating, but where the parent turned
   a row no entry hits from -0.0 into +0.0).
   (b) The Adam update (``adam_ab``) on FM's three leaves at the KDD12
   cell's table (54,686,453 rows of 1 + 8 floats, P = 492,178,078), at
   phase 10's, and at phase 10's with every leaf one float off 16 bytes:
   the kernel (``csrc/adam_step.cu``) bit for bit equal to
   ``adam_step_ordered_plain_`` over 3 steps of sparse gradients, one
   launch a step, no host sync; its device time beside its bytes bound
   (28 bytes a parameter), the plain version's, and, timed only,
   ``torch.optim.Adam(fused=True)``'s and the foreach update's.
   (c) The Adam update with row marks (``adam_rows_ab``) at the KDD12 and
   Criteo cells' tables with a batch's ids (8192 × 10 and 8192 × 39):
   the mark equal to its plain version, the masked launch bit for bit
   equal to the full one over 3 steps of other ids; the full launch's
   device time beside its 28-byte bound, the mark's, and mark + masked
   launch beside the 24-byte bound;
10. FM on phase 3's corpus (8 factors, Adam 0.05, batch 8192): 2 epochs on
   ell and dense, 1 on bcoo, accuracy above 0.9, the row scatter's
   launches counted and the Adam kernel's (one a step); 20 card steps run
   twice and bit-identical and within 1e-4 relative of the CPU; 20 steps
   enqueued behind device spins (four groups of 5); the step's device
   time beside the linear ELL step's.
11. data parallelism through ``dmlc_tpu_torch.parallel``: (a) in a child
   process, a process group of one NCCL rank (``init_process_group`` is
   called here, as ``init_from_env`` skips a one-worker job) ->
   ``make_mesh()`` -> the ELL main path with ``mesh=``: one epoch and an
   accuracy pass (above 0.9; K1 launched once a margin, ``dw`` once a
   step), the first 20 steps bit-equal to the non-mesh learner's on the
   same batches, 20 mesh steps enqueued behind device spins (groups of
   10), the mesh step's device time beside the plain step's; (b) two NCCL
   ranks tried on the one card with a 60 s timeout (the refusal or the
   hang recorded), then two gloo ranks on it
   (``init_from_env(backend="gloo")``), twice: 20 ELL ``LinearLearner`` and
   ``FMLearner`` steps at 8192 rows a rank and one ALS epoch at phase 9's
   size with the item solve, against the card's one-process run on the
   same global batches (losses and parameters within 1e-5, items within
   rtol 1e-4 / atol 1e-5), the parameters bit-identical across the ranks
   and the two runs, and ``sync_min`` capping an epoch over uneven
   shards. gloo stages CUDA collectives through the host, so its rows/s
   is a gloo-on-one-card figure, and the spin check is (a)'s; (c) the
   port's dry run ``dmlc_tpu_torch.entry.dryrun_multichip(2)`` on the card,
   its default (gloo, as the two ranks share one card), on the JAX dry
   run's mesh ``{"data": 1, "model": 2}``: the one-step legs and a 20-step
   feature-sharded trajectory within 1e-4 of the one-process run, falling.
   Feature sharding (``LinearLearner(model_axis=)``; run after phase 14,
   as (d) reads phase 13's corpus; (b) runs in (a)'s child): (a) K1 and
   its ``dw`` on a shard window against their plain versions, at 8192x28
   over a 30-word table in two windows and 8192x10 KDD-shaped ids over two
   25,000,001-word windows of a 50,000,002-word table (values, the
   partials' sum, ``dw`` against the plain windowed version and the whole
   table's, bits twice, times and bounds), with K1's unsharded time beside
   the parent's in turns under ``--parent``; (b) the world-1 NCCL group on
   ``{"data": 1, "model": 1}``: 20 ELL and dense steps bit-identical to
   the plain learner's, 20 enqueued behind a spin; one spawn of two gloo
   ranks on ``{"data": 1, "model": 2}`` for (c) phase 3's corpus through
   ``create_parser`` -> ``DeviceIter(mesh=, shardings=)`` ->
   ``LinearLearner(model_axis="model")``, dense and ELL logistic and ELL
   softmax, 20 steps each, losses and the gathered table within 1e-5 of
   the one-process learner, the table bit-equal across the ranks, windowed
   K1 and ``dw`` launches counted on each; (d) phase 13's KDD-shaped libfm
   on the 50,000,002-word table, ELL logistic, SGD 0.1, 20 steps within
   1e-4 of the one-process learner, each rank's shard bytes and step time
   beside the one-process step's; (f) ALS at phase 9's size for 2 epochs,
   replicated over the model axis, bit-equal to the one-process run; (e)
   the dry run at four gloo ranks, ``{"data": 2, "model": 2}``.
12. the block cache and the epoch planner: (a) ``examples/train_als.py``'s
   local leg at its full size through the port's example
   (``dmlc_tpu_torch.examples.train_als``): its ``main()`` as a user runs
   it (the row scatter launched once a step, its restore line and
   ``OK``), then its pieces: epoch 0 cold and publishing the cache, epochs
   1-3 warm with ``cache_read`` time and no source byte read, the plan's
   seed 0 and epoch in ``stats()``, each warm epoch's blocks in
   ``EpochPlan(0, epoch, n).order``, falling losses, ``restore_check``'s
   loss tail byte for byte from an ``epoch_plan`` source state, 20 warm
   steps twice bit-identical, the spin check in groups of 10; (b) phase
   3's corpus and ELL main path over the block cache with
   ``shuffle_seed=1``, ``shuffle_window=4096``: a cold and two warm epochs
   and an accuracy pass (above 0.9; K1 launched once a step and an
   accuracy batch, ``dw`` once a step), rows/s, stall share, ``cache_read``
   and convert seconds an epoch, no source byte read warm, the first 20
   warm steps twice bit-identical, a checkpoint after 37 batches of warm
   epoch 1 resumed in a fresh pipeline to ``torch.equal`` weights, a byte
   flipped in a block healed by one rebuild with the stream unchanged, and
   two ``pod_sharding`` hosts' blocks disjoint with the epoch as union; (c)
   phase 6's ELL snapshot served with ``device_decode=True`` and
   ``snapshot_shuffle_seed=2`` for two warm epochs: one K2 launch a warm
   batch, each batch bit-equal to the stored batch at
   ``block_permutation(2, epoch, n)[pos]``, and a ``unit="batch"`` state
   resumed in a fresh pipeline to bit-equal batches and equal weights.
13. the formats (``run_formats``): (a) a Criteo day-0 shaped csv
    (BASELINE.json config 2: a label, 13 integer and 26 categorical
    columns; 2**20 rows) through ``create_parser(?format=csv&label_column=0)``
    and ``LinearLearner`` with Adam at 1e-3: a dense cold epoch through the
    dense emit shadow-writing a snapshot and a warm ``device_decode=True``
    epoch (one K2 launch a batch), an ELL epoch (``max_nnz=39``: K1 and
    ``dw`` once a step), and a cold epoch on the numpy engine at 1 and 4
    parse workers of the registry stack's fan-out (rows/s,
    ``parse_parallelism_efficiency``); gates: the
    first 8 dense-emit batches equal the CSR route's bit for bit, and on
    dense and ELL 20 card steps twice bit-identical, within 1e-4 of the port
    on the CPU and enqueued behind a device spin without a host sync; (b) a
    KDD2012 track 2 shaped libfm (BASELINE.json config 4: ten
    ``field:index:1`` tokens, 50,000,000 ids; 2**20 rows):
    ``LinearLearner(bcoo)`` one epoch (a row scatter a step into the whole
    table) and ``FMLearner(ell)``, 8 factors, Adam 0.05, 64 steps (two row
    scatters a step on a ``[50,000,001, 8]`` table); gates: 20 steps twice
    bit-identical on each, and the first 20 (linear) and 5 (FM) losses
    within 1e-4 of the port on the CPU from the same initial state, the
    first bcoo batch's forward (a row scatter) bit-equal to its ordered
    plain version and within tolerance of ``index_add_`` and torch's
    product; (c) ``tests/test_device.py``'s libfm XOR case, ``FMLearner(ell)`` above 0.9
    accuracy.
14. the fused native reader's own routes (``run_native_reader``) on phase
    3's and phase 13's corpora: (a) ``DeviceIter(dense, pack_aux=True)``
    through its batch repack, float32 (packed slabs, one copy a batch) and
    bfloat16, cold epochs in turns with the registry stack's dense emit,
    then a snapshot's cold and warm ``device_decode=True`` epochs (one K2
    launch a batch); the first 8 batches of both producers bit-equal, 20
    steps twice bit-identical and within 1e-4 of the CPU; (b) the
    KDD-shaped libfm as ``DeviceIter(bcoo, batch_size=None)`` natural
    blocks through its ``CooBlock`` emit on the pair and the CSR wire,
    elision off and on, beside the registry stack's RowBlock route:
    rows/s, convert seconds, stall share, the step's device time; gates:
    every block a ``CooBlock``, the row scatter once a step at least, the
    first batch equal across the wires, 20 steps twice bit-identical and
    within 1e-4 of the CPU, 20 steps enqueued behind a device spin without
    waiting, the first block's forward held as in 13 (b); (c)
    ``DeviceIter(ell)`` without ``max_nnz`` (K from each
    batch's longest row), one epoch, K1 and ``dw`` launched once a batch.
15. the convert pool, the read pool and the attribution (``run_pools``)
    on phase 3's corpus: (a) cold ELL at ``convert_workers`` 1, 2 and 4
    (``convert_ahead=4``), two epochs and an accuracy pass each: rows/s,
    stall share and busy seconds an epoch, ``stages`` / ``stage_busy`` /
    ``wall_seconds``, ``staging_ring`` and ``transfer_samples``, K1 and
    ``dw`` counted around each; gates: accuracy > 0.9, the stages summing
    to at most the wall, the first 8 batches bit-equal across the widths;
    (b) a cold epoch writes a snapshot, then two warm ``device_decode=True``
    epochs at ``snapshot_read_workers`` 1 and 2: K2 once a batch, K1 and
    ``dw`` once a step, no convert; (c) 20 steps fed by ``DeviceIter(transfer_sample=1)`` (each
    pull waits on its batch's copy event) enqueued behind a half-second
    spin on the consumer's stream, done well before it ends, with the
    epoch converted ahead, and reported with the workers running beside
    the pulls (their share of the interpreter lock); (d)
    ``DMLC_TPU_TRACE=chrome:<path>`` over a cold epoch: the trace's events
    cover every stage ``stats()["stages"]`` reports above 0;
    ``DMLC_TPU_TRACE=1``: ``torch.profiler`` (all threads) shows the
    convert, dispatch and transfer ranges.
16. the online autotuner (``run_autotune``) on phase 3's corpus: (a) cold
    ELL at ``convert_workers=1``, ``DeviceIter(autotune=True,
    autotune_interval=16)`` against the autotuner off, four epochs a side
    in turns: rows/s, stall share, ``stats()["autotune"]``'s knobs and
    last decisions, the staging ring an epoch; gates: the first 20 losses
    and the final weights bit-equal between on and off, K1 and ``dw`` once
    a step and held against their plain versions on the phase's first
    batch; then 20 steps (groups of 10) fed by an autotuned
    ``autotune_interval=4`` pipeline enqueued behind a device spin, with
    ``prefetch`` + 2 and ``convert_ahead`` + 2 forced through the
    autotuner's knobs at the 8th call and ``convert_ahead`` + 16 at the
    12th: no host sync, and the ring's workers made new pinned slots;
    (b) warm device-decode ELL from ``snapshot_read_workers=2`` with the
    autotuner, in turns with fixed widths 1 and 2, three epochs each: the
    width's trajectory, rows/s, K2 once a warm batch, losses and weights
    bit-equal to the fixed runs; (c) the registry stack's parse fan-out
    with a ``restart_policy`` under the convert pool, its split failing
    once at chunk :data:`TUNE_FAIL_CHUNK`: every batch's hash equal to the
    clean run's, ``parse_restarts`` 1.
17. the tiered artifact store and the split layer (``run_store``) on
    phase 3's corpus, in a directory of its own: (a)
    ``create_parser(path#cache)`` -> ``DeviceIter(ell)`` -> ``LinearLearner``
    for two epochs, the first writing the ``#cachefile`` chunk cache, the
    second reading only the cache with the source renamed away; gates:
    every batch's digest, the first 20 losses and the final weights
    bit-equal to the plain URI's run on the same engine (the registry
    stack), K1 and ``dw`` once a step and held against their plain
    versions on the phase's first batch, ``cache_rebuilds`` 0; rows/s and
    stall share of both epochs and the cache's bytes beside the corpus's;
    then 20 steps of the cache-only epoch behind a spin of about 2 s
    (:data:`PIPELINE_SPIN_CYCLES`) in groups of 10,
    no host sync; (b) a block cache and an ELL snapshot (``device_decode=
    True``) of the corpus beside the chunk cache: ``stats()["store"]
    ["store_bytes"]`` equals the three files' sizes (the byte gauges are
    cleared when the phase starts); a publish under a budget between the
    two larger files' sum and the total evicts the snapshot, and only it
    (cost order, on the decision ledger); the next epoch rebuilds it cold
    (``store_rebuilds_after_eviction`` 1, batch digests and losses equal to
    the first cold run's, K1 once a step); then a warm device-decode
    epoch with two read workers, a squeeze (budget 1) published from
    another thread after batch :data:`STORE_SQUEEZE_AT`: the pinned
    snapshot survives, K2 once a batch, bits equal to an unsqueezed warm
    epoch; (c) ``create_parser(path, shuffle=True, num_shuffle_parts=4,
    seed=3)`` without a block cache (the split layer's
    ``ShuffledInputSplit``): the multiset of row digests equals the plain
    run's; the same keywords with a block cache: one
    ``DeprecationWarning`` and the plan the JAX package's mapping sets
    (:data:`LEGACY_PLAN`), a cold and a warm epoch; K1 and ``dw`` once a
    step throughout. The phase prints its wall time.
18. the filesystem registry, the native host engines and the row
    iterators (``run_host_io``) on phase 3's corpus, in a directory of its
    own: (a) the corpus's bytes in ``mem://`` (``write_all``), where
    ``create_parser`` (engine ``auto``) builds the chunk feeder
    (``NativeFeedParser``) -> ``DeviceIter(ell)`` -> ``LinearLearner``,
    two epochs; gates: every batch's digest, the first 20 losses and the
    final weights bit-equal to the fused native reader's run on the local
    file (the plain local run, two epochs), K1 and ``dw`` once a step and
    held against their plain versions on a batch of the leg; a snapshot
    written over the ``mem://`` source by a cold epoch and one warm
    ``device_decode=True`` epoch from it, its batches equal to the cold
    ones, K2 once a warm batch; 20 steps of the ``mem://`` pipeline behind
    a spin of about 2 s in groups of 10, no host sync; (b) ``engine="native-batch"``
    with ``block_cache=``: the chain is a ``BlockCacheIter`` over the
    batch engine, the cold epoch writes every block through
    ``add_block_encoded`` (no ``add_block``), the warm one reads every
    block's span through ``block_encoded``; both epochs' value digests, the
    first 20 losses and the final weights bit-equal to the registry
    stack's Python-engine run (``engine="python"``: a cold epoch that
    writes a block cache of its own, a warm one from it), and the bit
    digests to the fused reader's (the native scanners read ``-0.000000``
    as +0.0 where numpy reads -0.0, in both packages); (c)
    ``create_row_block_iter(path#pages)``: a ``DiskRowIter`` as
    ``DeviceIter``'s source, epoch 1 over the pages it built, epoch 2 from
    a new one with the source renamed away; digests, losses and weights
    bit-equal to a ``BasicRowIter`` run (the corpus in memory), the page
    file's bytes; (d) host only: a RecordIO corpus of about 64 MB (records
    of 1 byte to 32 KiB, every 13th multi-part) and its index through
    ``NativeRecordIOSplit``, the shuffled ``NativeIndexedRecordIOSplit``
    and ``NativeFeedRecordIOSplit`` (the same bytes under ``mem://``): the
    records equal the Python splitters' (as a multiset under the shuffle),
    records/s of each beside the Python splitter's. Every leg of (a)-(c)
    prints rows/s and stall share beside the plain local run's and passes
    each epoch's launches through the K1 / ``dw`` (and K2) gate. The phase
    prints its wall time.
19. the cloud filesystems (``run_cloud``) in a directory of its own,
    beside ``dmlc_tpu_torch/testing/fake_cloud.py`` in a child process
    (S3 with every SigV4 signature checked, GCS, WebHDFS, Azure with every
    Shared Key signature checked, plain HTTP, served from its memory on
    127.0.0.1, each server on a listen backlog of 256; killed in a
    ``finally``), the port pointed at it through the environment. First a
    burst of :data:`CLOUD_BURST` Range GETs opened at once against its
    plain HTTP server: each done within :data:`CLOUD_BURST_LIMIT_S`, each
    accepted by it (fault C15: on ``socketserver``'s backlog of 5 a burst
    overflows the accept queue). Every urllib attempt of the phase is
    timed (:class:`_AttemptLog`) and one of :data:`CLOUD_SLOW_S` or more
    is printed on a line of its own. (a) phase 3's corpus read into memory, then uploaded
    through the port's multipart write stream
    (``open_stream("s3://bench/higgs.libsvm", "w")``, parts of 8 MiB; each
    part's wall time and the retries reported, a retry failing the
    phase), one sweep of Range GETs with no parse, then
    ``create_parser`` -> ``NativeFeedParser`` -> ``DeviceIter(ell)`` at 2
    convert workers -> ``LinearLearner``, two epochs against the fused
    reader's on the local file (digests, 20 losses, weights bit-equal),
    K1 and ``dw`` held against their plain versions on a batch of the
    leg, a snapshot over the ``s3://`` source (cold, then a warm
    ``device_decode=True`` epoch, K2 once a batch, its batches the cold
    ones'), 20 steps behind a spin of about 2 s
    (:data:`PIPELINE_SPIN_CYCLES`) in groups of 10; (b) the corpus cut to
    :data:`CLOUD_CUT_ROWS` rows, written through the port's own streams
    (the GCS media upload, the WebHDFS two-step create, the Azure block
    list, the S3 multipart; plain HTTP through the fake's control), one
    epoch each on ``http://``, ``gs://``, ``hdfs://``, ``azure://`` and
    ``s3://``, bit-equal to the fused reader's epoch on the same cut, and
    a two-file ``s3://bench/parts/`` read at ``num_parts=2``, the two
    parts' rows the corpus's; (c) an ``s3://`` epoch of (b)'s size while
    the fake serves a 503, a 429 with ``Retry-After: 0.05`` and a reset
    mid-body (:data:`CLOUD_FAULTS`): healed, bit-equal to (b)'s clean
    epoch, retries and resumes reported; then a 403 fails an epoch in
    one attempt with ``DMLCError`` ("feed failed", no batch after it); (d) a ``DeviceIter`` state taken after
    :data:`CLOUD_CKPT_AT` batches and the learner's parameters saved to
    ``s3://`` and read back into a fresh pipeline: the remaining batches
    and final weights the uninterrupted epoch's; then
    ``dmlc_tpu_torch.examples.checkpoint_resume`` on the card, its corpus
    on ``s3://``. Every epoch passes the K1 / ``dw`` (and K2) gate; the
    fake refusing a signature fails the phase. The phase prints its wall
    time, the client's attempts beside the connections each server of the
    fake accepted and served, and fails past :data:`CLOUD_LIMIT_S`.
20. the tracker (``run_tracker``): jobs launched by
    ``dmlc_tpu_torch.tracker.submit.main(["--cluster", "tpu-pod",
    "--num-workers", "2", "--host-ip", "127.0.0.1", "--", ...])``, each
    under a deadline, two ranks of this script (``--parallel-child pod``)
    sharing the card through gloo, each with a watchdog: the rabit
    rendezvous, the heartbeat with ``metrics=True``,
    ``init_from_env(backend="gloo")``, ``pod_identity``, ``sync_min`` of
    its part's batches and one epoch of the data-parallel ELL
    ``LinearLearner`` on phase 3's corpus, K1 and ``dw`` counted around
    it. (a) The ranks' weights bit-equal and within 1e-5 of the card's
    one-process learner on the same global batches; K1 and ``dw`` against
    their plain versions on rank 0's first batch; the tracker's merged pod
    table (``DMLC_METRICS_LOG_EVERY=0``) with both ranks; each rank's
    rows/s and stall share. (b) Under ``DMLC_LIVENESS_TIMEOUT=1.0`` and
    ``--local-num-attempt 3``, task 1's first life dies after the rabit
    rendezvous: the tracker logs it lost, the relaunch recovers the same
    rabit rank, and the weights are (a)'s bits. (c) ``python -m
    dmlc_tpu_torch.examples.distributed_pod`` on the card, its
    accuracies.
21. the data service (``run_service``): one dispatcher and two
    ``ParseWorker``s over localhost TCP (``LocalFleet``) serving phase 3's
    corpus in 4 parts, each leg on a thread of its own under a deadline
    (:data:`SERVICE_LEG_LIMIT_S`). (a) ``ServiceParser`` -> ``DeviceIter
    (ell)`` -> ``LinearLearner``: the delivered blocks and resume
    annotations equal the local loop over ``create_parser(path, p, 4)``
    (host digests, part by part); K1 and ``dw`` against their plain
    versions on the phase's first batch; the first 20 step losses within
    1e-4 of the same batches on the CPU; two epochs beside one of phase 3's
    local reader in the same call (rows/s, stall share, batch digests equal
    to the local reader's), the CSR frames' wire bytes; then the epoch again
    with the worker streaming to it killed after batch 43: the bits of the
    undisturbed epoch, ``service_failovers`` at least 1 and
    ``service_giveups`` 0. (b) ``register_job(..., snapshot={"batch_size":
    8192, "num_col": 29, "x_dtype": "bfloat16"})`` (29: the dense
    learner's width, its sink column included) into ``DeviceIter(dense,
    pack_aux=True, x_dtype="bfloat16", device_decode=True)`` with no
    snapshot: one K2 launch a batch, the batches bit-equal to the same job
    through ``device_decode=False``, a dense ``LinearLearner`` epoch under
    log 2, the client's payload bytes beside (a)'s, and 20 steps behind a
    spin. (c) ``dmlc_tpu_torch.examples.train_als``'s ``main([])`` at its
    full size (phase 12 (a) runs it too): its service line (parts parsed at
    most 2, giveups 0, the service-fed restore replayed bit for bit) and
    the row scatter once a step.
22. fault plans (``run_faults``), through the port's fault-injection seam
    (``dmlc_tpu_torch.io.faults``, plans :data:`FAULT_PLANS`) against the
    learners on the card, each leg printing its plan, ``fired()``, its
    counter deltas, its K1 / ``dw`` / K2 launches, its wall time and its
    bits against a clean run of the same leg in the same call. (a) Phase
    3's corpus on the fake cloud's ``http://`` (a child process, as in
    phase 19), an ELL epoch under ``read@2..3=http-503;read@9=reset``:
    weights bit-equal to the clean epoch, ``retries`` equal to ``fired()``,
    a resume, no give-up; K1 and ``dw`` against their plain versions on a
    batch read under the plan; then ``read@1=http-403``: one firing,
    ``fatal`` 1, no retry, ``DMLCError``. (b) K2's span route
    (``device_decode=True``), ELL and packed bf16 dense, snapshots written
    by a cold epoch (K2 against ``decode_batch_plain`` on a stored batch;
    the clean warm epoch's bits equal the cold epoch's), under
    ``snapshot_read@5=corrupt`` at 1 and 2 read workers: the clean warm
    epoch's bits and weights, one ``snapshot_corruptions`` and one
    ``pipeline_restarts``, one K2 launch a warm batch, every staging slot
    free at the epoch's end and a further epoch on the same iterator;
    under ``DMLC_RETRY_MAX_ATTEMPTS=1`` the plan raises, every slot is free
    after ``reset`` and a further epoch runs. (c) Phase 12's planned block
    cache, a fresh pipeline's warm epoch under ``cache_read@3=corrupt``:
    the clean warm epoch's weights, one corruption and one rebuild. (d)
    Phase 21 (a)'s fleet, a service-fed ELL epoch under
    ``dispatch_rpc~locate@2..4=conn;worker_rpc~stream@1=torn``: the clean
    epoch's weights and the pipeline's counters
    :data:`FAULT_SERVICE_WANT` (the counts both packages' clients show in
    ``tests/test_torch_faults.py``); then ``preempt~<worker 0's id>@1``: a
    notice, a drain, the bits. (e) A child interpreter (``--parallel-child
    faults_env``) with ``DMLC_FAULT_PLAN=read@1=http-503`` reads the first
    2**16 rows over ``http://`` into the ELL learner (the depth cut for
    time): one retry, the weights of this process's clean epoch on the
    same rows. (f) The clean warm ELL epoch of (b) at 2 read workers
    beside phase 6's last warm ELL epoch, rows/s, printed only.
23. the surface the earlier slices trimmed (``run_surface``), on phase 3's
    corpus: (a) ``create_parser(index_dtype=np.uint32)`` and ``np.uint64``
    on the numpy engine (``engine="python"``, whose blocks carry the
    dtype) and on the fused reader (whose native ids stay ``uint64``, as
    in the JAX package) -> ``DeviceIter(ell)`` -> ``LinearLearner``, the
    first :data:`SURFACE_STEPS` steps of each: every batch's ELL tensors,
    the losses and the weights bit-equal across the four legs, K1 and
    ``dw`` launched a step on each, K1 and ``dw`` against their plain
    versions on a batch of the ``uint32`` leg; (b) an ELL snapshot written
    by a cold epoch, then warm epochs in turns at ``verify=True``, False,
    False, True (``open_snapshot(verify=)`` -> ``SnapshotIter(raw=True)``
    -> one K2 launch a batch, ``decode_batch``): the batches of every warm
    epoch bit-equal to the cold epoch's, K2 launched once a batch, each
    epoch's rows/s printed beside the card's name and power limit; (c)
    ``segment_csr_matvec`` on CUDA tensors at HIGGS's batch (8,192 rows x
    28 ids), through the row scatter's kernel: two runs bit-equal, equal to
    ``row_scatter_add_ordered_plain`` bit for bit and to the CPU plain
    version within 1e-5, its time (CUDA events behind a spin, the median
    of 5) beside the plain route's (``index_add_``), ``torch.segment_reduce``'s
    and its bytes bound. It adds no kernel.
    Then each phase's rows/s and stall share, every phase at the default
    ``convert_workers=2``, beside PR 11's (one producer thread,
    :data:`PR11_READER`) and the registry stack's before the reader
    (``producer_change``, :data:`BEFORE_READER`).

The ``torch.profiler`` windows run after phase 15, the decode's first:
the steps' windows of phases 3 and 6 (``step``, ``step_warm``) follow it,
and a bcoo step's (``bcoo_step_profile``, device time by kernel), the ALS
and FM steps' and phase 13's libfm bcoo and FM ell steps'
(``step_profile``: device events and time by kernel a step), and how many
launches the card queues behind a spin (``launch_queue``). Phase 16 runs
after them (a window opened after a pipeline ran behind a spin can miss a
device event). Then the
run's total wall time, a ``{"kernels": [...]}`` line (launches counted on
the main paths of phases 3, 6, 7 and 11-23, the windowed ones of phase
11's feature sharding among them; the row scatter's on phases 9-14, 11 (f)
and 21 (c); the Adam kernel's on phase 10), the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present.

``--only cloud|tracker|service|faults|surface`` builds, writes phase 3's
corpus and runs phase 19, 20, 21, 22 or 23 alone ``--repeat`` times;
``--only adam`` builds, runs phase 9 (b) and (c) ``--repeat`` times, then
phase 10's ell leg; ``cloud`` first runs the burst against a
fake on a backlog of 5 and one on the default, in turns, as often. It
prints no kernels line and no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench.corpora.fixed_width import write_rows
from portbench.yardstick import HBM_BYTES_PER_S, least_seconds

HIGGS_ROWS, HIGGS_COLS = 1 << 20, 28
BATCH = 8192
K1_SHAPES = [  # (name, B, K, W)
    ("higgs", 8192, 28, 29),          # dense-in-sparse: the main path's shape
    ("tpu_band", 8192, 64, 2049),     # the old TPU kernel's band
    ("kdd_like", 8192, 16, (1 << 20) + 1),
    ("odd", 1000, 7, 101),
    ("higgs_large", 1 << 18, 28, 29),  # 58.7 MB of idx + val: bytes dominate
    ("criteo_csv", 8192, 39, 40),      # phase 13's csv ELL: K not a multiple of 4
]
K1_RTOL, K1_ATOL = 1e-5, 1e-4
K2_SHAPES = [  # (name, rows, cols, dtype)
    ("higgs_dense_f32", 8192, 30, "float32"),     # 28 features + label + weight
    ("higgs_dense_bf16", 8192, 30, "bfloat16"),
    ("dense_path_f32", 8192, 31, "float32"),      # the dense learner's 29 + 2
    ("dense_path_bf16", 8192, 31, "bfloat16"),
    ("ell_values", 8192, 28, "float32"),          # the warm ELL path's segment
    ("lane_aligned", 8192, 1024, "float32"),      # a shape the TPU kernel took
    ("odd_f32", 1000, 7, "float32"),
    ("odd_bf16", 1000, 7, "bfloat16"),
]
K2_KINDS = [  # (name, batch kind): a warm batch of each kind a snapshot stores
    ("ell", "ell"),                              # the warm main path's
    ("dense_packed_f32", "dense_packed"),        # 29 + label + weight columns
    ("dense_packed_bf16", "dense_packed"),
    ("dense_packed_q8", "dense_packed_q8"),
    ("dense_f32", "dense"),
    ("dense_bf16", "dense"),
]
K2_MAIN = "ell"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def _env(values: dict):
    """``os.environ`` with ``values`` inside the block, as it was after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def registry_stack():
    """Inside: ``create_parser`` builds the registry stack (the split, the
    text parsers, ``ParallelTextParser``) for a plain local file, not the
    fused native reader (``DMLC_TPU_NO_NATIVE_READER=1``)."""
    return _env({"DMLC_TPU_NO_NATIVE_READER": "1"})


# ---------------- phase 1: environment and builds ----------------

def build_all() -> dict:
    """Build the kernel library and the native parser concurrently."""
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.ops import _build

    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as pool:
        kern = pool.submit(_build.load_kernels)
        nat = pool.submit(native.available)
        kern.result()
        native_ok = nat.result()
    ptxas = [line.strip() for line in _build.kernel_build_log.splitlines()
             if "registers" in line or "spill" in line]
    if not native_ok:
        raise AssertionError("the native parser did not build: no phase may fall back "
                             "to the numpy engine")
    return {"build_wall_s": time.monotonic() - t0,
            "kernel_build_s": _build.kernel_build_seconds,
            "native_build_s": native.build_seconds,
            "parse_engine": "native", "ptxas": ptxas}


def assert_native_engine(tmp: str) -> dict:
    """A plain local ``create_parser`` returns the fused native reader
    (``NativeStreamParser``, engine ``native``), as the JAX package's does,
    and parses a small file."""
    from dmlc_tpu_torch import create_parser

    path = os.path.join(tmp, "engine.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1 2:0.5\n0 1:2\n")
    parser = create_parser(path)
    out = {"phase": "environment_engine", "parser": type(parser).__name__,
           "engine": getattr(parser, "engine", None),
           "rows": sum(len(b) for b in parser)}
    parser.close()
    with registry_stack():
        fallback = create_parser(path)
    out["registry_stack_parser"] = type(fallback).__name__
    fallback.close()
    os.remove(path)
    emit(out)
    if out["parser"] != "NativeStreamParser" or out["engine"] != "native" or out["rows"] != 2:
        raise AssertionError(f"create_parser did not return the fused native reader: {out}")
    return out


# ---------------- phase 2: kernel K1 against its plain version ----------------

def k1_inputs(b, k, w, seed, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn(w, generator=gen, device=device)
    table[-1] = 0.0  # the pinned-zero sink
    idx = torch.randint(0, w - 1, (b, k), generator=gen, device=device,
                        dtype=torch.int32)
    val = torch.randn((b, k), generator=gen, device=device)
    pad = torch.rand((b, k), generator=gen, device=device) < 0.25
    idx[pad] = w - 1
    val[pad] = 0.0
    return table, idx, val


def device_ms(fn, iters: int = 50, repeats: int = 5, warmup: int = 10,
              spin_cycles: int = 100_000_000) -> float:
    """Device time of one call: CUDA events around ``iters`` calls, over the
    count; the median of ``repeats`` such runs. Each run is queued behind a
    device-side spin, so the events time the device's work back to back
    and not the host's launch cost."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def bound(nbytes: int, ops: int) -> tuple:
    """The least time for the work, ``(ms, "bytes" or "operations")``: the
    bytes at the card's memory rate or the fp32 operations at its fp32
    rate, whichever takes longer."""
    bytes_ms, ops_ms = least_seconds(nbytes, 0) * 1e3, least_seconds(0, ops) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def k1_bound_ms(idx, b: int, k: int) -> tuple:
    """K1: each input byte read once (idx, val, and the table words this
    batch touches), the output written once; 2*B*K fp32 operations."""
    import torch

    touched = int(torch.unique(idx).numel())
    return bound(b * k * 8 + b * 4 + touched * 4, 2 * b * k)


def dw_bound_ms(b: int, k: int, w: int) -> tuple:
    """K1's dw: idx, val and g read once, dw written once; 2*B*K fp32
    operations."""
    return bound(b * k * 8 + b * 4 + w * 4, 2 * b * k)


def load_parent_libs(parent: str, out_dir: str) -> dict:
    """The parent commit's K1, K2 and row scatter, each built from
    ``parent``'s ``dmlc_tpu_torch/csrc/`` into a library of its own under
    ``out_dir`` (three ``nvcc`` at once), for an A/B in one run. The C
    interfaces are the parent's: ``dmlc_ell_matvec_f32(w, idx, val, out,
    B, K, lo, W, stream)``, the one-segment K2 ``dmlc_widen_span(seg, out,
    rows, cols, itemsize, stream)``, one launch a float segment, and the
    table-driven row scatter (``dmlc_row_sort_counts``, ``dmlc_row_sort``,
    ``dmlc_row_scatter_chunks`` and ``dmlc_row_scatter_f32(sorted, perm,
    src, table, head, tail, N, R, D, accumulate, stream)``). A library
    without its interface is left out, and so is its A/B."""
    import ctypes

    from dmlc_tpu_torch.ops import _build

    procs = {}
    for name in ("ell_matvec", "widen_span", "row_scatter"):
        src = os.path.join(parent, "dmlc_tpu_torch", "csrc", name + ".cu")
        lib_path = os.path.join(out_dir, f"lib{name}_parent.so")
        procs[name] = (lib_path, subprocess.Popen(
            [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the parent's {name}.cu failed to build:\n{err[-4000:]}")
        libs[name] = ctypes.CDLL(lib_path)
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    bindings = {  # library: {function: (restype, argtypes)}
        "ell_matvec": {"dmlc_ell_matvec_f32": (ctypes.c_int, [ptr] * 4 + [i64] * 4 + [ptr])},
        "widen_span": {"dmlc_widen_span": (
            ctypes.c_int, [ptr, ptr, i64, i64, ctypes.c_int, ptr])},
        "row_scatter": {
            "dmlc_row_sort_counts": (i64, [i64] * 2),
            "dmlc_row_sort": (ctypes.c_int, [ptr, i64, i64] + [ptr] * 4),
            "dmlc_row_scatter_chunks": (i64, [i64]),
            "dmlc_row_scatter_f32": (ctypes.c_int, [ptr] * 6 + [i64] * 3 + [ctypes.c_int, ptr])},
    }
    for name, functions in bindings.items():
        try:
            for fn, (restype, argtypes) in functions.items():
                getattr(libs[name], fn).restype = restype
                getattr(libs[name], fn).argtypes = argtypes
        except AttributeError:
            # another interface (a parent whose K2 decodes a whole batch,
            # as this tree's dmlc_decode_span does): no A/B for that kernel
            del libs[name]
    return libs


def parent_k1_fn(lib, table, idx, val):
    """``(run, out)`` for the parent's K1 on these inputs, unsharded."""
    import torch

    (b, k), w = idx.shape, table.shape[0]
    out = torch.empty(b, device=idx.device)

    def run():
        rc = lib.dmlc_ell_matvec_f32(table.data_ptr(), idx.data_ptr(), val.data_ptr(),
                                     out.data_ptr(), b, k, 0, w,
                                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise AssertionError(f"the parent's K1 failed to launch: {rc}")
    return run, out


def phase_k1(seed: int, parent=None) -> list:
    import torch
    import torch.nn.functional as F

    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops.sparse import EllBatch, ell_matvec

    if _build.load_kernels().dmlc_ell_dw_max_table() != k1.DW_MAX_TABLE:
        raise AssertionError("DW_MAX_TABLE differs from the dw kernel's own limit")
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for i, (name, b, k, w) in enumerate(K1_SHAPES):
        table, idx, val = k1_inputs(b, k, w, seed + i, dev)
        batch = EllBatch(idx, val, None, None)
        out = k1.ell_matvec_cuda(table, idx, val)
        ref = ell_matvec(table, batch)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=K1_RTOL, atol=K1_ATOL)
        err = float((out - ref).abs().max())
        repeatable_fwd = torch.equal(out, k1.ell_matvec_cuda(table, idx, val))
        # idx and val 4 bytes past a 16-byte boundary: no vectors, no staging
        idx_u = torch.empty(b * k + 1, dtype=torch.int32, device=dev)[1:].view(b, k)
        val_u = torch.empty(b * k + 1, device=dev)[1:].view(b, k)
        idx_u.copy_(idx)
        val_u.copy_(val)
        torch.testing.assert_close(k1.ell_matvec_cuda(table, idx_u, val_u), ref,
                                   rtol=K1_RTOL, atol=K1_ATOL)
        g = torch.randn(b, generator=torch.Generator(device=dev).manual_seed(seed + 100 + i),
                        device=dev)
        # dw on its route against the plain version (index_add_), and twice
        route = k1.dw_route(w)
        if route == "cuda":
            def dw_fn():
                return k1.ell_matvec_dw_cuda(idx, val, g, w)
        else:
            def dw_fn():
                return k1.ell_matvec_grads(table, idx, val, g, need_dval=False)[0]
        dw, dw_again = dw_fn(), dw_fn()
        dw_plain = k1.ell_matvec_grads(table, idx, val, g, need_dval=False)[0]
        torch.cuda.synchronize()
        dw_repeatable = torch.equal(dw, dw_again)
        if route == "cuda" and not (dw_repeatable and repeatable_fwd):
            raise AssertionError(f"K1 {name}: two launches differ (forward repeatable "
                                 f"{repeatable_fwd}, dw repeatable {dw_repeatable})")
        # dw sums up to B*K products per table slot, the plain version in
        # atomic (run-to-run) order: allow 1e-5 of the slot's absolute sum
        scale = torch.zeros_like(table).index_add_(
            0, idx.long().flatten(), (val * g[:, None]).abs().flatten())
        tol = K1_ATOL + K1_RTOL * scale
        dw_kernel_err = (dw - dw_plain).abs()
        if bool((dw_kernel_err > tol).any()):
            raise AssertionError(f"K1 {name}: dw differs by up to {float(dw_kernel_err.max())}")
        # dw from the unaligned copies: the warp-bin route wherever the tile
        # route would take the aligned inputs (it needs 16-byte starts), so
        # its time here sits beside the tile route's at the same shape
        dw_unaligned_ms = None
        if route == "cuda":
            dw_u = k1.ell_matvec_dw_cuda(idx_u, val_u, g, w)
            dw_u_again = k1.ell_matvec_dw_cuda(idx_u, val_u, g, w)
            torch.cuda.synchronize()
            if not torch.equal(dw_u, dw_u_again) or bool(((dw_u - dw_plain).abs() > tol).any()):
                raise AssertionError(f"K1 {name}: dw from unaligned inputs differs from the plain "
                                     f"version or between two launches")
            dw_kernel_err = torch.maximum(dw_kernel_err, (dw_u - dw_plain).abs())
            dw_unaligned_ms = device_ms(lambda: k1.ell_matvec_dw_cuda(idx_u, val_u, g, w))
        # gradients through autograd: the kernels' backward against autograd
        # through the plain version
        tw, tv = table.clone().requires_grad_(), val.clone().requires_grad_()
        (k1.EllMatvec.apply(tw, idx, tv) * g).sum().backward()
        rw, rv = table.clone().requires_grad_(), val.clone().requires_grad_()
        (ell_matvec(rw, EllBatch(idx, rv, None, None)) * g).sum().backward()
        torch.testing.assert_close(tv.grad, rv.grad, rtol=K1_RTOL, atol=K1_ATOL)
        dw_err = (tw.grad - rw.grad).abs()
        if bool((dw_err > tol).any()):
            raise AssertionError(f"K1 {name}: autograd dw differs by up to {float(dw_err.max())}")
        # embedding_bag computes the same function in one PyTorch call
        lib_out = F.embedding_bag(idx, table[:, None], per_sample_weights=val,
                                  mode="sum")[:, 0]
        torch.testing.assert_close(lib_out, ref, rtol=K1_RTOL, atol=K1_ATOL)
        ms = device_ms(lambda: k1.ell_matvec_cuda(table, idx, val))
        plain_ms = device_ms(lambda: ell_matvec(table, batch))
        library_ms = device_ms(lambda: F.embedding_bag(
            idx, table[:, None], per_sample_weights=val, mode="sum"))
        ab = {}
        if parent is not None:
            # the parent's kernel and this one in turns: P C C P
            p_run, p_out = parent_k1_fn(parent, table, idx, val)
            p_run()
            torch.testing.assert_close(p_out, ref, rtol=K1_RTOL, atol=K1_ATOL)
            kernel = lambda: k1.ell_matvec_cuda(table, idx, val)  # noqa: E731
            order = [device_ms(f) for f in (p_run, kernel, kernel, p_run)]
            # the unsharded call (lo = 0) keeps the parent's bits up to
            # 65,536 rows, where its route is the parent's; above, the
            # parent's persistent route summed in another lane order
            ab = {"parent_ms_runs": [order[0], order[3]], "change_ms_runs": order[1:3],
                  "bits_equal_to_parent": torch.equal(p_out, out)}
            if b <= 65_536 and not ab["bits_equal_to_parent"]:
                raise AssertionError(f"K1 {name}: the unsharded call's bits differ from the "
                                     "parent's")
        bound_ms, bound_by = k1_bound_ms(idx, b, k)
        # dw: the route's time, the plain version's, and index_add_ alone
        # on precomputed int64 indices and products (the one PyTorch call)
        dw_ms = device_ms(dw_fn)
        dw_plain_ms = device_ms(lambda: k1.ell_matvec_grads(table, idx, val, g,
                                                            need_dval=False))
        flat_idx, prod = idx.long().flatten(), (val * g[:, None]).flatten()
        acc = torch.zeros_like(table)
        dw_library_ms = device_ms(lambda: acc.index_add_(0, flat_idx, prod))
        dw_bound, dw_bound_by = dw_bound_ms(b, k, w)
        row = {"phase": "k1", "shape": name, "B": b, "K": k, "W": w,
               "max_abs_err": err, "dw_max_abs_err": float(dw_err.max()),
               "dw_kernel_max_abs_err": float(dw_kernel_err.max()),
               "repeatable": repeatable_fwd,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms,
               "dw_route": route, "dw_repeatable": dw_repeatable,
               "dw_ms": dw_ms, "dw_plain_ms": dw_plain_ms,
               "dw_library_ms": dw_library_ms, "dw_unaligned_ms": dw_unaligned_ms,
               "dw_bound_ms": dw_bound, "dw_bound_by": dw_bound_by,
               "dw_bound_share": dw_bound / dw_ms, **ab}
        emit(row)
        rows.append(row)
    # values only: 32 lanes a row (K > 64), a table too wide for shared
    # memory, a part-filled warp, and batches above 65,536 rows on the one
    # route with a ragged last tile: 70,001 rows of 7 words (4 lanes a row)
    # with the table in L1, and 65,600 rows of 72 (16 lanes) with it in L2
    for b, k, w in ((300, 257, 29), (1001, 5, 5000), (77, 3, 7), (70_001, 7, 101),
                    (65_600, 72, 5000)):
        table, idx, val = k1_inputs(b, k, w, seed, dev)
        torch.testing.assert_close(k1.ell_matvec_cuda(table, idx, val),
                                   ell_matvec(table, EllBatch(idx, val, None, None)),
                                   rtol=K1_RTOL, atol=K1_ATOL)
    return rows


# ---------------- phase 3: the main path ----------------

def write_higgs_corpus(path: str, rows: int, seed: int,
                       cols: int = HIGGS_COLS) -> dict:
    """A HIGGS-shaped libsvm file: ``cols`` dense real features per row
    (0-based indices, fixed-width values ``+d.dddddd``) and a binary label
    from a fixed linear rule plus noise. Formatted with numpy in bulk."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=cols)
    # one row's bytes, with the offset of each value's sign byte
    template = bytearray(b"0")
    vpos = []
    for j in range(cols):
        template += f" {j}:".encode()
        vpos.append(len(template))
        template += b"+0.000000"
    template += b"\n"
    tmpl = np.frombuffer(bytes(template), np.uint8)
    row_len, pos = len(tmpl), np.array(vpos)
    chunk = 1 << 16
    with open(path, "wb") as f:
        for start in range(0, rows, chunk):
            n = min(chunk, rows - start)
            x = rng.normal(size=(n, cols))
            y = (x @ w_true + 0.1 * rng.normal(size=n) > 0).astype(np.uint8)
            q = np.minimum(np.rint(np.abs(x) * 1e6), 9_999_999).astype(np.int64)
            buf = np.empty((n, row_len), np.uint8)
            buf[:] = tmpl
            buf[:, 0] = ord("0") + y
            buf[:, pos] = np.where(x < 0, ord("-"), ord("+"))
            buf[:, pos + 1] = ord("0") + q // 1_000_000
            for d in range(6):
                buf[:, pos + 3 + d] = ord("0") + (q // 10 ** (5 - d)) % 10
            f.write(buf.tobytes())
    return {"rows": rows, "cols": cols, "bytes": os.path.getsize(path)}


def run_main_path(path: str, device, epochs: int = 2) -> dict:
    """create_parser -> DeviceIter(ell) -> LinearLearner -> fit -> accuracy,
    as a user would call them. Returns per-epoch records and the accuracy."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    parser = create_parser(path, 0, 1, "libsvm")
    model = LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3,
                          device=device)
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=BATCH,
                    layout="ell", max_nnz=HIGGS_COLS, drop_remainder=True,
                    device=device)
    epochs_out = []
    keys = ("stall_seconds", "bytes_to_device", "source_wait_seconds",
            "convert_seconds")
    prev = {k: 0 for k in keys}

    def log(epoch, loss, nb, secs):
        now = it.stats()
        delta = {k: now[k] - prev[k] for k in keys}
        prev.update({k: now[k] for k in keys})
        rec = {"phase": "main_path", "epoch": epoch, "loss": loss, "batches": nb,
               "wall_s": secs, "rows_per_s": nb * BATCH / secs,
               "stall_s": delta["stall_seconds"],
               "stall_share": delta["stall_seconds"] / secs,
               "bytes_to_device": delta["bytes_to_device"],
               "producer_source_wait_s": delta["source_wait_seconds"],
               "producer_convert_s": delta["convert_seconds"]}
        emit(rec)
        epochs_out.append(rec)

    t0 = time.monotonic()
    model.fit(it, epochs=epochs, log_fn=log)
    t1 = time.monotonic()
    acc = model.accuracy(it)
    t2 = time.monotonic()
    engine = parser.engine
    it.close()
    return {"epochs": epochs_out, "accuracy": acc, "fit_s": t1 - t0,
            "accuracy_s": t2 - t1, "engine": engine,
            "steps": sum(e["batches"] for e in epochs_out),
            "accuracy_batches": HIGGS_ROWS // BATCH}


def compare_first_losses(path: str, device, steps: int = 20) -> dict:
    """The first ``steps`` step losses on ``device`` against the same
    batches stepped through the port on the CPU (plain route)."""
    import torch

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.ops.sparse import EllBatch

    dev_model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    cpu_model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device="cpu")
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"),
                    num_col=dev_model.device_num_col(), batch_size=BATCH,
                    layout="ell", max_nnz=HIGGS_COLS, drop_remainder=True,
                    device=device)
    pairs, dev_losses = [], []
    for _, batch in zip(range(steps), it):
        dev_loss = dev_model.step(batch)
        cpu_loss = cpu_model.step(EllBatch(*(t.cpu() for t in batch)))
        dev_losses.append(dev_loss)
        pairs.append((float(dev_loss), float(cpu_loss)))
    it.close()
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    return {"steps": len(pairs), "max_rel_diff": rel, "losses": pairs,
            "card_losses": torch.stack(dev_losses),
            "card_weight": dev_model.params.weight.detach().clone()}


def card_trajectory(path: str, device, steps: int = 20):
    """The first ``steps`` step losses and the final weight on ``device``
    alone, as :func:`compare_first_losses` steps them there."""
    import torch

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout="ell", max_nnz=HIGGS_COLS,
                    drop_remainder=True, device=device)
    losses = [model.step(batch) for _, batch in zip(range(steps), it)]
    it.close()
    return torch.stack(losses), model.params.weight.detach().clone()


def step_times(path: str, device, window: int = 40, snapshot=None) -> dict:
    """Where an ELL step's time goes.

    On a batch already on the card: the step must not synchronise the host
    (checked with CUDA's sync debug mode set to raise), its device time
    (CUDA events, queued behind a spin) and its wall time per step in a
    loop of 50 that ends in a synchronise. Then ``window`` steps fed by a
    DeviceIter under ``torch.profiler``: device time by kernel per step and
    the share of the window's wall time in which the device was busy. With
    a published ``snapshot`` the feed is its warm device-decode epoch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snapshot),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                    device_decode=snapshot is not None)
    batch = next(it)
    model.step(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            model.step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # a step is some 15 launches: runs of 10 fit in the device's launch
    # queue behind the spin, so the host never feeds the device mid-run
    dev_ms = device_ms(lambda: model.step(batch), iters=10)
    t0 = time.monotonic()
    for _ in range(50):
        model.step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) / 50 * 1e3

    it.reset()
    for _, b in zip(range(4), it):  # warm the producer before the window
        model.step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _, b in zip(range(window), it):
            model.step(b)
        torch.cuda.synchronize()
        window_s = time.monotonic() - t0
    state = it.stats()["snapshot_state"]
    it.close()
    if state != ("warm" if snapshot is not None else None):
        raise AssertionError(f"the profiled window's snapshot state is {state}")
    per_kernel: dict = {}
    spans = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] = (per_kernel.get(evt.name, 0.0)
                                    + evt.time_range.elapsed_us() / window / 1e3)
            spans.append((evt.time_range.start, evt.time_range.end))
    busy_us, reach = 0.0, float("-inf")  # union of the device's busy intervals
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"phase": "step" if snapshot is None else "step_warm",
            "step_device_ms": dev_ms, "step_wall_ms": wall_ms,
            "fed_window_steps": window, "fed_window_s": window_s,
            "fed_device_busy_share": busy_us / 1e6 / window_s,
            "profiled_device_ms_per_step": busy_us / 1e3 / window,
            "top_kernels_ms_per_step": [[name[:80], ms] for name, ms in top]}


def run_dense_epoch(path: str, device) -> dict:
    """One dense epoch through the dense emit (the parser's ``DenseBlock``s,
    no CSR block), then one through the CSR route (``set_emit_dense``
    hidden, each block densified on the producer), in the same run."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    out = {"phase": "dense"}
    for route in ("emit", "csr"):
        model = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, device=device)
        src = _Blocks(create_parser(path, 0, 1, "libsvm"), csr=route == "csr")
        it = DeviceIter(src, num_col=model.device_num_col(), batch_size=BATCH,
                        layout="dense", drop_remainder=True, device=device)
        t0 = time.monotonic()
        loss, nb = model.fit_epoch(it)
        secs = time.monotonic() - t0
        out[route] = {"loss": loss, "batches": nb, "wall_s": secs,
                      "rows_per_s": nb * BATCH / secs, "stall_s": it.stall_seconds,
                      "stall_share": it.stall_seconds / secs,
                      "producer_convert_s": it.stats()["convert_seconds"],
                      "bytes_to_device": it.bytes_to_device, "block_kinds": src.kinds}
        it.close()
    out["loss"] = out["emit"]["loss"]
    return out


# ---------------- phase 5: kernel K2 against its plain version ----------------

def k2_segments(seed: int) -> list:
    """K2 on one segment (a one-entry plan, :func:`widen_span_cuda`) at
    ``K2_SHAPES``, laid out as the snapshot spans lay them out (64 bytes
    into a u8 span) and from an unaligned start (1 byte in: loads from
    bytes), bit-exact against the plain version and the source values."""
    import torch

    from dmlc_tpu_torch.ops import device_decode as dd

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows_out = []
    for name, rows, cols, dtype_name in K2_SHAPES:
        dt = getattr(torch, dtype_name)
        iv = torch.int32 if dt == torch.float32 else torch.int16
        vals = (torch.randn(rows, cols, generator=gen, device=dev) * 1e3).to(dt)
        vals.view(-1)[:4] = torch.tensor([float("nan"), float("inf"), -0.0, -1e-30]).to(dt)
        raw = vals.view(torch.uint8).reshape(-1)
        nbytes = raw.numel()
        segs = {}
        for off in (64, 1):
            span = torch.zeros(nbytes + 128, dtype=torch.uint8, device=dev)
            span[off: off + nbytes] = raw
            segs[off] = span[off: off + nbytes]
        for off, seg in segs.items():
            out = dd.widen_span_cuda(seg, rows, cols, dt)
            plain = dd.widen_span_plain(seg, rows, cols, dt)
            torch.cuda.synchronize()
            if not (torch.equal(out.view(iv), plain.view(iv))
                    and torch.equal(out.view(iv), vals.view(iv))):
                raise AssertionError(f"K2 {name} (offset {off}) differs from its plain version")
        seg = segs[64]
        out, plain = dd.widen_span_cuda(seg, rows, cols, dt), dd.widen_span_plain(seg, rows, cols, dt)
        finite = torch.isfinite(plain.float())
        err = float((out.float() - plain.float())[finite].abs().max())
        ms = device_ms(lambda: dd.widen_span_cuda(seg, rows, cols, dt))
        unaligned_ms = device_ms(lambda: dd.widen_span_cuda(segs[1], rows, cols, dt))
        plain_ms = device_ms(lambda: dd.widen_span_plain(seg, rows, cols, dt))
        # a view alone costs the device nothing: the one PyTorch call that
        # makes the same fresh [rows, cols] tensor is the view's clone
        library_ms = device_ms(lambda: seg.view(dt).reshape(rows, cols).clone())
        bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        row = {"phase": "k2", "shape": name, "rows": rows, "cols": cols,
               "dtype": dtype_name, "bytes": nbytes, "bit_exact": True,
               "unaligned_bit_exact": True, "max_abs_err": err,
               "ms": ms, "unaligned_ms": unaligned_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "bound_share": bound_ms / ms}
        emit(row)
        rows_out.append(row)
    return rows_out


def k2_arrays(name: str, gen, dev) -> list:
    """A warm batch of kind ``name`` (``K2_KINDS``) at the main path's
    widths, on the card: float slabs with NaN, infinities and -0.0 in them
    (in the bf16 aux columns too), q8 with a scale row."""
    import torch

    b, nc = BATCH, HIGGS_COLS + 1

    def slab(cols):
        a = torch.randn(b, cols, generator=gen, device=dev) * 1e3
        a[:3, -2:] = torch.tensor([float("nan"), float("inf"), -0.0], device=dev)[:, None]
        a.view(-1)[:4] = torch.tensor([float("nan"), float("inf"), -0.0, -1e-30], device=dev)
        return a

    def col():
        return torch.randn(b, generator=gen, device=dev)

    if name == "ell":
        idx = torch.randint(0, nc, (b, HIGGS_COLS), generator=gen, device=dev, dtype=torch.int32)
        return [idx, slab(HIGGS_COLS), col(), torch.ones(b, device=dev)]
    if name == "dense_packed_q8":
        q = torch.randint(-127, 128, (b, nc + 2), generator=gen, device=dev, dtype=torch.int8)
        scale = torch.rand(nc + 2, generator=gen, device=dev) * 3
        scale[0] = 1.0
        return [q, scale]
    dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
    if name.startswith("dense_packed"):
        return [slab(nc + 2).to(dt)]
    return [slab(nc).to(dt), col(), torch.ones(b, device=dev)]


def k2_span(arrays: list, shift: int):
    """``arrays`` laid out as a snapshot batch lays them out (each segment
    64-byte aligned within the span), in a u8 span that starts ``shift``
    bytes into its allocation; returns ``(span, layout)``."""
    import torch

    names = {torch.float32: "<f4", torch.bfloat16: "bfloat16", torch.int32: "<i4",
             torch.int8: "|i1"}
    layout, parts, end = [], [], 0
    for i, a in enumerate(arrays):
        raw = a.contiguous().view(torch.uint8).reshape(-1)
        off = -(-end // 64) * 64
        layout.append((f"a{i}", names[a.dtype], off, raw.numel(), tuple(a.shape)))
        parts.append((off, raw))
        end = off + raw.numel()
    base = torch.zeros(end + 64, dtype=torch.uint8, device=arrays[0].device)
    span = base[shift: shift + end]
    for off, raw in parts:
        span[off: off + raw.numel()] = raw
    return span, tuple(layout)


def batch_tensors(batch) -> list:
    """Every tensor a consumer can take from a decoded batch: a packed
    batch's slab and its ``x``, ``y`` and ``w``, or the tuple's members."""
    if hasattr(batch, "packed"):
        return [batch.packed, *batch]
    return list(batch)


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (NaN payloads included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    iv = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[a.element_size()]
    return torch.equal(a.view(iv), b.view(iv))


def k2_moved_bytes(plan) -> int:
    """The bytes K2 must move for ``plan``: each input read once (a q8
    slab's scale row too), each output written once (a bf16 slab's aux
    columns too); views move nothing."""
    from dmlc_tpu_torch.ops import device_decode as dd

    total = 0
    for op in plan.table.ops[: plan.table.count]:
        n = op.rows * op.cols
        if op.op == dd.OP_DEQUANT_Q8:
            total += n + 4 * op.cols + 4 * n
        elif op.op == dd.OP_BF16_AUX:
            total += 2 * n * 2 + 2 * op.rows * 4
        else:
            total += 2 * n * (4 if op.op == dd.OP_COPY4 else 2)
    return total


def parent_k2_route(lib, span, layout, kind: str, num_col: int):
    """The parent's decode of one batch, as its ``DeviceIter`` issued it:
    a launch of its K2 for each 2-D float segment, views for the rest, then
    torch's ``q.to(float32) * scale`` for a q8 batch and ``.to(float32)``
    of a packed batch's label and weight. Returns the batch's tensors as
    :func:`batch_tensors` lists them."""
    import torch

    dtypes = {"<f4": torch.float32, "bfloat16": torch.bfloat16, "<i4": torch.int32,
              "|i1": torch.int8}
    stream = torch.cuda.current_stream().cuda_stream
    segs = []
    for _, dtype_str, off, nbytes, shape in layout:
        dt, seg = dtypes[dtype_str], span[off: off + nbytes]
        if len(shape) == 2 and dt in (torch.float32, torch.bfloat16):
            out = torch.empty(shape, dtype=dt, device=span.device)
            rc = lib.dmlc_widen_span(seg.data_ptr(), out.data_ptr(), shape[0], shape[1],
                                     seg.numel() // (shape[0] * shape[1]), stream)
            if rc != 0:
                raise AssertionError(f"the parent's K2 failed to launch: {rc}")
            segs.append(out)
        else:
            segs.append(seg.view(dt).view(shape))
    if kind == "dense_packed_q8":
        segs = [segs[0].to(torch.float32) * segs[1]]
    if kind.startswith("dense_packed"):
        p = segs[0]
        return [p, p[:, :num_col], p[:, num_col].to(torch.float32),
                p[:, num_col + 1].to(torch.float32)]
    return segs


def k2_kinds(seed: int, parent=None) -> list:
    """K2 on a warm batch of each kind (``K2_KINDS``), one launch for the
    whole span, against :func:`decode_batch_plain` bit for bit, from a
    64-byte-aligned and an unaligned start, with one launch counted per
    call. Device times: the kernel (aligned and not), the plain version
    (its lazy widening included), the one PyTorch call computing the same
    decode where there is one, and with ``parent`` the parent's route in
    turns with this one, P C C P; and the host's dispatch time of a
    decode."""
    import torch

    from dmlc_tpu_torch.ops import device_decode as dd

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    rows_out = []
    for name, kind in K2_KINDS:
        arrays = k2_arrays(name, gen, dev)
        nc = HIGGS_COLS + 1
        spans = {shift: k2_span(arrays, shift) for shift in (0, 1)}
        for shift, (span, layout) in spans.items():
            before = dd.launches
            got = batch_tensors(dd.decode_batch_cuda(span, layout, kind, nc))
            want = batch_tensors(dd.decode_batch_plain(span, layout, kind, nc))
            torch.cuda.synchronize()
            if dd.launches != before + 1:
                raise AssertionError(f"K2 {name}: {dd.launches - before} launches for one batch")
            if len(got) != len(want) or not all(same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K2 {name} (start {shift}) differs from decode_batch_plain")
        span, layout = spans[0]
        plan = dd.plan_for(kind, layout, nc)
        got = batch_tensors(dd.decode_batch_cuda(span, layout, kind, nc))
        want = batch_tensors(dd.decode_batch_plain(span, layout, kind, nc))
        finite = [torch.isfinite(w.float()) for w in want]
        err = max(float((g.float() - w.float())[f].abs().max()) for g, w, f in zip(got, want, finite))

        def kernel():
            return dd.decode_batch_cuda(span, layout, kind, nc)

        ms = device_ms(kernel)
        unaligned_ms = device_ms(lambda: dd.decode_batch_cuda(*spans[1], kind, nc))
        plain_ms = device_ms(lambda: batch_tensors(dd.decode_batch_plain(span, layout, kind, nc)))
        # the one PyTorch call that computes the same decode: a slab's clone
        # (the views cost the device nothing), q8's promoting multiply; a
        # bf16 packed slab with its widened aux takes no single call
        library = None
        if kind == "dense_packed_q8":
            q, scale = arrays

            def library():
                return q * scale
        elif name != "dense_packed_bf16":
            _, dtype_str, off, nbytes, shape = layout[0 if kind != "ell" else 1]
            seg, dt = span[off: off + nbytes], arrays[0 if kind != "ell" else 1].dtype

            def library():
                return seg.view(dt).reshape(shape).clone()
        if library is not None and not same_bits(library(), got[0 if kind != "ell" else 1]):
            raise AssertionError(f"K2 {name}: the library call computes another function")
        library_ms = device_ms(library) if library is not None else None
        ab = {}
        if parent is not None:
            p_tensors = parent_k2_route(parent, span, layout, kind, nc)
            if not all(same_bits(a, b) for a, b in zip(p_tensors, got)):
                raise AssertionError(f"K2 {name}: the parent's route decodes other bits")
            p_run = lambda: parent_k2_route(parent, span, layout, kind, nc)  # noqa: E731
            order = [device_ms(f) for f in (p_run, kernel, kernel, p_run)]
            ab = {"parent_ms_runs": [order[0], order[3]], "change_ms_runs": order[1:3]}
        # the host's side of one decode: the dispatch DeviceIter counts
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                kernel()
            host.append((time.perf_counter() - t0) / 200 * 1e3)
        torch.cuda.synchronize()
        nbytes = k2_moved_bytes(plan)
        bound_ms, bound_by = bound(nbytes, 0)
        row = {"phase": "k2_kind", "kind": name, "batch_kind": kind,
               "segments": [list(s[1:]) for s in layout], "entries": plan.table.count,
               "blocks": plan.table.blocks, "bytes": nbytes, "bit_exact": True,
               "unaligned_bit_exact": True, "max_abs_err": err, "ms": ms,
               "unaligned_ms": unaligned_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
               "host_dispatch_ms": statistics.median(host), **ab}
        emit(row)
        rows_out.append(row)
    return rows_out


def phase_k2(seed: int, parent=None) -> dict:
    return {"kinds": k2_kinds(seed, parent), "segments": k2_segments(seed)}


# ---------------- phase 6: the warm main path ----------------

WARM_KEYS = ("stall_seconds", "bytes_to_device", "convert_seconds",
             "snapshot_write_seconds", "snapshot_read_seconds",
             "device_decode_seconds", "device_decode_bytes")


def _epoch_logger(it, phase: str, out: list):
    """A ``fit`` log_fn recording each epoch's deltas of ``WARM_KEYS``."""
    prev = {k: 0 for k in WARM_KEYS}

    def log(epoch, loss, nb, secs):
        now = it.stats()
        d = {k: now[k] - prev[k] for k in WARM_KEYS}
        prev.update({k: now[k] for k in WARM_KEYS})
        rec = {"phase": phase, "epoch": epoch, "loss": loss, "batches": nb,
               "warm": d["device_decode_bytes"] > 0, "wall_s": secs,
               "rows_per_s": nb * BATCH / secs,
               "stall_share": d["stall_seconds"] / secs,
               "decode_dispatch_ms_per_batch": d["device_decode_seconds"] / nb * 1e3,
               **{k: d[k] for k in WARM_KEYS}}
        emit(rec)
        out.append(rec)
    return log


def _check_warm_epochs(epochs: list, first_cold: bool = True) -> int:
    """Epoch 1 cold, the rest warm with a convert delta of exactly 0.
    Returns the warm batches."""
    for e in epochs:
        if not np.isfinite(e["loss"]):
            raise AssertionError(f"{e['phase']}: non-finite loss {e['loss']}")
        if e["warm"] != (e["epoch"] > 0 or not first_cold):
            raise AssertionError(f"{e['phase']} epoch {e['epoch']}: warm={e['warm']}")
        if e["warm"] and e["convert_seconds"] != 0.0:
            raise AssertionError(f"{e['phase']} epoch {e['epoch']}: a warm epoch "
                                 f"converted for {e['convert_seconds']} s")
    return sum(e["batches"] for e in epochs if e["warm"])


def run_warm_ell(path: str, snap: str, device) -> dict:
    """The warm main path: create_parser(snapshot=) -> DeviceIter(ell,
    device_decode=True) -> fit(3) -> accuracy, with both kernels' counts
    zeroed just before and read just after."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    model = LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3,
                          device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                    device_decode=True)
    epochs: list = []
    k1.launches = k1.dw_launches = dd.launches = 0
    model.fit(it, epochs=3, log_fn=_epoch_logger(it, "warm_ell", epochs))
    dw_launches = k1.dw_launches
    before = it.stats()
    t0 = time.monotonic()
    acc = model.accuracy(it)
    acc_s = time.monotonic() - t0
    k1_launches, k2_launches = k1.launches, dd.launches
    after = it.stats()
    it.close()
    acc_warm = after["device_decode_bytes"] > before["device_decode_bytes"]
    warm_batches = _check_warm_epochs(epochs) + (HIGGS_ROWS // BATCH if acc_warm else 0)
    out = {"phase": "warm_ell", "accuracy": acc, "accuracy_s": acc_s,
           "accuracy_warm": acc_warm,
           "accuracy_convert_seconds": after["convert_seconds"] - before["convert_seconds"],
           "k2_launches": k2_launches, "k2_launches_needed": warm_batches,
           "k1_launches": k1_launches,
           "k1_launches_needed": sum(e["batches"] for e in epochs) + HIGGS_ROWS // BATCH,
           "dw_launches": dw_launches,
           "dw_launches_needed": sum(e["batches"] for e in epochs),
           "snapshot_bytes": os.path.getsize(snap)}
    emit(out)
    if not acc_warm or out["accuracy_convert_seconds"] != 0.0:
        raise AssertionError(f"the accuracy pass was not a warm device-decode pass: {out}")
    if k2_launches != warm_batches:
        raise AssertionError(f"K2 launched {k2_launches} times for {warm_batches} warm batches "
                             f"(one a batch)")
    if dw_launches < out["dw_launches_needed"]:
        raise AssertionError(f"the dw kernel launched {dw_launches} times for "
                             f"{out['dw_launches_needed']} warm ELL steps")
    if k1_launches < out["k1_launches_needed"]:
        raise AssertionError(f"K1 launched {k1_launches} times, "
                             f"the path needs {out['k1_launches_needed']}")
    if not acc > 0.9:
        raise AssertionError(f"warm ELL accuracy {acc} <= 0.9")
    return {**out, "epochs": epochs}


WARM_DENSE = {  # phase name: DeviceIter's packed dense options
    "warm_dense_float32": {"x_dtype": "float32"},
    "warm_dense_bfloat16": {"x_dtype": "bfloat16"},
    "warm_dense_q8": {"x_dtype": "float32", "snapshot_quant": "int8"},
}


def run_warm_dense(path: str, snap: str, device, phase: str) -> dict:
    """A cold and a warm device-decode epoch of packed dense batches, with
    K2's count zeroed just before and read just after."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.ops import device_decode as dd

    model = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="dense",
                    drop_remainder=True, device=device, pack_aux=True, device_decode=True,
                    **WARM_DENSE[phase])
    epochs: list = []
    dd.launches = 0
    model.fit(it, epochs=2, log_fn=_epoch_logger(it, phase, epochs))
    k2_launches = dd.launches
    it.close()
    warm_batches = _check_warm_epochs(epochs)
    out = {"phase": phase, "k2_launches": k2_launches,
           "k2_launches_needed": warm_batches, "snapshot_bytes": os.path.getsize(snap)}
    emit(out)
    if k2_launches != warm_batches:
        raise AssertionError(f"{phase}: K2 launched {k2_launches} times for "
                             f"{warm_batches} warm batches (one a batch)")
    if not epochs[-1]["loss"] < np.log(2):
        raise AssertionError(f"{phase}: warm epoch loss {epochs[-1]['loss']}")
    return {**out, "epochs": epochs}


def compare_warm_routes(path: str, snap: str, device, n: int = 8, **kw) -> dict:
    """The first ``n`` warm batches through device decode (K2) against the
    same batches through the host-decode warm path, byte for byte (a packed
    batch's slab and its ``x``, ``y`` and ``w``)."""
    from dmlc_tpu_torch import DeviceIter, create_parser

    iters = [DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                        batch_size=BATCH, drop_remainder=True, device=device,
                        device_decode=dec, **kw) for dec in (True, False)]
    pairs = list(zip(range(n), *iters))
    states = [it.stats()["snapshot_state"] for it in iters]
    for it in iters:
        it.close()
    if states != ["warm", "warm"] or len(pairs) != n:
        raise AssertionError(f"warm route comparison ran {len(pairs)} batches, states {states}")
    for i, a, b in pairs:
        ta, tb = batch_tensors(a), batch_tensors(b)
        if len(ta) != len(tb) or not all(same_bits(x, y) for x, y in zip(ta, tb)):
            raise AssertionError(f"warm batch {i}: device decode differs from host decode")
    return {"phase": "warm_routes", "layout": kw.get("layout"),
            "x_dtype": kw.get("x_dtype", "float32"),
            "snapshot_quant": kw.get("snapshot_quant"), "batches_equal": n}


def profile_decodes(snaps: dict, device, num_col: int, attempts: int = 3) -> dict:
    """One warm batch's decode from each snapshot in ``snaps`` (``{name:
    path}``; the spans already on the card), in one ``torch.profiler``
    window, with ``x, y, w`` taken from each batch: between sentinel fills,
    exactly one kernel must run for each batch, K2's (no cast, multiply or
    widening kernel). The window starts with a pause, since kernels
    launched right after the profiler starts can go unrecorded; a window
    whose trace lacks a sentinel is taken again, at most ``attempts``
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmlc_tpu_torch.io.snapshot import SnapshotReader
    from dmlc_tpu_torch.ops import device_decode as dd

    batches = {}
    for name, snap in snaps.items():
        reader = SnapshotReader(snap)
        kind, raw, layout = reader.batch_span(0)
        batches[name] = (torch.from_numpy(np.array(raw)).to(device), layout, kind)
        reader.close()
        tuple(dd.decode_batch(*batches[name], num_col))
    sentinel = torch.empty(1, device=device)
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.5)
            for batch in batches.values():
                sentinel.fill_(1.0)
                x, y, w = dd.decode_batch(*batch, num_col)
            sentinel.fill_(2.0)
            torch.cuda.synchronize()
        names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum("FillFunctor" in n for n in names) == len(batches) + 1:
            break
    else:
        raise AssertionError(f"the profiler recorded the sentinels in none of {attempts} windows")
    # the kernels between each pair of sentinels: one batch's decode
    runs, run = [], None
    for n in names:
        if "FillFunctor" in n:
            if run is not None:
                runs.append(run)
            run = []
        elif run is not None:
            run.append(n)
    out = {"phase": "decode_profile", "kernels": dict(zip(batches, runs))}
    if not all(len(r) == 1 and "decode_span" in r[0] for r in runs):
        raise AssertionError(f"a warm batch's decode ran other kernels than K2's: {out}")
    return out


SCATTER_KERNELS = ("indexFunc", "index_add", "scatter")


def check_no_scatter(step: dict) -> None:
    """No scatter-add kernel among a step's top kernels: dw is the hand
    kernel's (``index_add_`` shows as ``indexFuncLargeIndex``)."""
    names = [name for name, _ in step["top_kernels_ms_per_step"]]
    found = [n for n in names if any(s in n for s in SCATTER_KERNELS)]
    if found:
        raise AssertionError(f"{step['phase']}: scatter kernels in the step: {found}")


def run_healing(tmp: str, device, seed: int, rows: int = 8 * BATCH) -> dict:
    """A corrupt warm batch heals mid-epoch: a small HIGGS-shaped snapshot
    (8 batches) written by a cold device-decode ELL epoch, one byte flipped
    in batch 3's span, then a warm device-decode epoch that must equal the
    cold one byte for byte with one pipeline restart."""
    import torch

    from dmlc_tpu_torch import DeviceIter, create_parser
    from dmlc_tpu_torch.io.snapshot import SnapshotReader

    path = os.path.join(tmp, "healing.libsvm")
    snap = os.path.join(tmp, "healing.snapshot")
    write_higgs_corpus(path, rows, seed + 1)

    def epoch(it):
        return [[t.cpu().view(torch.uint8) for t in batch] for batch in it]

    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                    num_col=HIGGS_COLS, batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                    device_decode=True)
    cold = epoch(it)
    it.reset()
    reader = SnapshotReader(snap)
    pos = reader._batches[3]["pos"] + 100
    reader.close()
    with open(snap, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x01]))
    healed = epoch(it)
    stats = it.stats()
    it.close()
    equal = len(healed) == len(cold) and all(
        len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        for a, b in zip(healed, cold))
    out = {"phase": "healing", "batches": len(healed),
           "pipeline_restarts": stats["resilience"]["pipeline_restarts"],
           "snapshot_removed": not os.path.exists(snap), "bytes_equal_cold": equal}
    if not (equal and out["pipeline_restarts"] == 1 and out["snapshot_removed"]
            and len(cold) == rows // BATCH):
        raise AssertionError(f"a corrupt warm batch did not heal: {out}")
    return out


# ---------------- phase 7: checkpoint and resume ----------------

CKPT_AT = 37  # batches before the checkpoint


def _ell_pipeline(path: str, device, snapshot=None):
    """(parser, learner, DeviceIter) of the ELL main path, fresh; with a
    ``snapshot`` the warm device-decode feed."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    parser = create_parser(path, 0, 1, "libsvm", snapshot=snapshot)
    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                    device_decode=snapshot is not None)
    return parser, model, it


def _checkpoint(path: str, device, snapshot=None):
    """Step the first ``CKPT_AT`` batches from a fresh learner and close:
    the DeviceIter state through ``json`` and the parameters through
    numpy, as a job would write them."""
    from dmlc_tpu_torch.convert import linear_params_to_jax

    _, model, it = _ell_pipeline(path, device, snapshot)
    for _, batch in zip(range(CKPT_AT), it):
        model.step(batch)
    state = json.loads(json.dumps(it.state_dict()))
    params = linear_params_to_jax(model.params)
    it.close()
    return state, params


def _resume(path: str, device, state, params, snapshot=None, want=None) -> dict:
    """A fresh parser, DeviceIter and learner: the parameters set, the
    state loaded, the epoch finished. With ``want`` (the uninterrupted
    epoch's batches from ``CKPT_AT`` on) each batch is held against it, bit
    for bit."""
    import torch

    from dmlc_tpu_torch.convert import linear_params_from_jax
    from dmlc_tpu_torch.ops import device_decode as dd

    parser, model, it = _ell_pipeline(path, device, snapshot)
    model.set_params(linear_params_from_jax(*params, device=device))
    torch.cuda.synchronize()
    k2_before = dd.launches
    t0 = time.monotonic()
    it.load_state(state)
    t1 = time.monotonic()
    bytes_at_load = parser.bytes_read
    n, first_s, equal = 0, None, want is not None
    for batch in it:
        if first_s is None:
            first_s = time.monotonic() - t1
        model.step(batch)
        if want is not None:
            equal = equal and n < len(want) and all(
                same_bits(a, b) for a, b in zip(batch, want[n]))
        n += 1
    torch.cuda.synchronize()
    t2 = time.monotonic()
    out = {"batches_after_restore": n, "load_state_s": t1 - t0, "first_batch_s": first_s,
           "restored_rows_per_s": n * BATCH / (t2 - t1), "parser_bytes_read": parser.bytes_read,
           "parser_bytes_read_at_load": bytes_at_load,
           "snapshot_state": it.stats()["snapshot_state"], "k2_launches": dd.launches - k2_before,
           "weight": model.params.weight.detach().clone(),
           "bias": model.params.bias.detach().clone()}
    if want is not None:
        out["batches_equal"] = equal and n == len(want)
    it.close()
    return out


def _cold_restore_leg(path: str, device, corpus_bytes: int) -> dict:
    """An uninterrupted cold ELL epoch, then the same epoch checkpointed
    after ``CKPT_AT`` batches, closed and resumed in a fresh pipeline."""
    import torch

    _, model, it = _ell_pipeline(path, device)
    t0 = time.monotonic()
    batches = 0
    for batch in it:
        model.step(batch)
        batches += 1
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    it.close()
    ref_w, ref_b = model.params.weight.detach().clone(), model.params.bias.detach().clone()
    state, params = _checkpoint(path, device)
    r = _resume(path, device, state, params)
    out = {k: v for k, v in r.items() if k not in ("weight", "bias")}
    out.update(
        state_kind=state["kind"], state_batches=state["batches"],
        uninterrupted_epoch_s=cold_s, uninterrupted_rows_per_s=batches * BATCH / cold_s,
        bytes_read_share=r["parser_bytes_read"] / corpus_bytes,
        bytes_read_share_at_load=r["parser_bytes_read_at_load"] / corpus_bytes,
        weights_equal=bool(torch.equal(r["weight"], ref_w) and torch.equal(r["bias"], ref_b)))
    return {"out": out, "state": state, "params": params, "weight": ref_w, "bias": ref_b}


def run_checkpoint(path: str, snap: str, device, corpus_bytes: int) -> dict:
    """Cold ELL on the registry stack (the split and ``ParallelTextParser``):
    an uninterrupted epoch, then the same epoch checkpointed after
    ``CKPT_AT`` batches, closed, and resumed in a fresh pipeline (a seek of
    the split, under 0.8 of the corpus read); the final weight and bias
    must be ``torch.equal``. The same on the fused native reader, whose
    state is a count the restore replays (the share of the corpus read by
    the end of the restore reported): the batches after the restore and
    the final weights must equal the uninterrupted epoch's, which must
    equal the registry stack's. Warm device decode on phase 6's snapshot:
    a warm checkpoint and the cold one, each resumed into a fresh warm
    pipeline; the remaining batches bit-equal to the uninterrupted warm
    epoch's, one K2 launch each, and the final weights ``torch.equal`` to
    it (and to the cold epoch's: the same batches)."""
    import torch

    with registry_stack():
        split = _cold_restore_leg(path, device, corpus_bytes)
    cold_out, cold_state, cold_params = split["out"], split["state"], split["params"]
    ref_w, ref_b = split["weight"], split["bias"]
    emit({"phase": "checkpoint_cold_ell", "producer": "ParallelTextParser", **cold_out})
    native = _cold_restore_leg(path, device, corpus_bytes)
    native_out = native["out"]
    native_out["uninterrupted_equals_registry_stack"] = bool(
        torch.equal(native["weight"], ref_w) and torch.equal(native["bias"], ref_b))
    emit({"phase": "checkpoint_cold_ell_native", "producer": "NativeStreamParser",
          **native_out})

    # the uninterrupted warm epoch, its batches kept on the card
    _, model, it = _ell_pipeline(path, device, snap)
    want = []
    for i, batch in enumerate(it):
        model.step(batch)
        if i >= CKPT_AT:
            want.append([t.clone() for t in batch])
    warm_state_ok = it.stats()["snapshot_state"] == "warm"
    it.close()
    warm_w, warm_b = model.params.weight.detach().clone(), model.params.bias.detach().clone()
    warm_state, warm_params = _checkpoint(path, device, snap)
    warm_out = []
    for name, state, params in (("warm_to_warm", warm_state, warm_params),
                                ("cold_to_warm", cold_state, cold_params)):
        r = _resume(path, device, state, params, snap, want)
        rec = {k: v for k, v in r.items() if k not in ("weight", "bias")}
        rec.update(phase="checkpoint_warm_ell", restore=name, state_kind=state["kind"],
                   weights_equal=bool(torch.equal(r["weight"], warm_w)
                                      and torch.equal(r["bias"], warm_b)))
        emit(rec)
        warm_out.append(rec)
    cold_equals_warm = bool(torch.equal(ref_w, warm_w) and torch.equal(ref_b, warm_b))
    out = {"cold": cold_out, "native": native_out, "warm": warm_out,
           "warm_epoch_served_warm": warm_state_ok,
           "cold_epoch_equals_warm_epoch": cold_equals_warm,
           "k2_launches": sum(r["k2_launches"] for r in warm_out)}
    rest = HIGGS_ROWS // BATCH - CKPT_AT
    problems = []
    if not (cold_out["weights_equal"] and cold_out["batches_after_restore"] == rest):
        problems.append("the cold ELL restore did not finish the epoch to the same weights")
    if cold_state["kind"] != "source" or not cold_out["bytes_read_share"] < 0.8:
        problems.append("the cold ELL restore did not seek")
    if not (native_out["weights_equal"] and native_out["batches_after_restore"] == rest
            and native_out["uninterrupted_equals_registry_stack"]):
        problems.append("the native reader's restore did not finish the epoch to the same "
                        "weights")
    for r in warm_out:
        if not (r["weights_equal"] and r["batches_equal"] and r["k2_launches"] == rest
                and r["snapshot_state"] == "warm"):
            problems.append(f"the {r['restore']} restore differs")
    if not (warm_state_ok and cold_equals_warm):
        problems.append("the warm epoch was not warm, or trained other weights than the cold")
    if problems:
        raise AssertionError(f"checkpoint: {problems}: {out}")
    return out


# ---------------- phase 8: the bcoo layout ----------------

def _bcoo_pipeline(path: str, device, natural: bool = False):
    """(learner, DeviceIter) of the bcoo path, fresh; ``natural`` ships the
    parsed blocks as they come (``batch_size=None``)."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="bcoo", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=model.device_num_col(),
                    batch_size=None if natural else BATCH, layout="bcoo",
                    max_nnz=HIGGS_COLS, device=device)
    return model, it


# the spin behind a leg whose steps pull from a running pipeline, about 2 s:
# its convert workers (and phase 19's feed thread) share the interpreter
# lock with the consumer, whose 10 steps took 0.06-0.32 s of host time on
# the card's host; a step that syncs still waits the whole spin
PIPELINE_SPIN_CYCLES = 4_000_000_000
_SPIN_PIECE = 1_000_000_000  # cycles a ``torch.cuda._sleep`` call at most


def _spin(cycles: int) -> None:
    """One device-side spin of ``cycles`` on the current stream, queued in
    pieces of at most :data:`_SPIN_PIECE`."""
    import torch

    while cycles > 0:
        torch.cuda._sleep(min(cycles, _SPIN_PIECE))
        cycles -= _SPIN_PIECE


def enqueue_behind_spin(step, calls: int = 20, spin_cycles: int = 1_000_000_000,
                        group: int = None) -> dict:
    """Whether ``step`` waits for the device: ``calls`` calls enqueued
    behind a device-side spin of about half a second. A call that
    synchronises the host (also inside a library, where CUDA's sync debug
    mode cannot see it) waits for the spin, so its enqueue time is then at
    least the spin's; without one the host is done long before, and the
    stream is still busy.

    The card queues about a thousand launches (``launch_queue_depth``: 1,000
    enqueue behind a spin, 1,023 wait for it), so calls whose launches fill
    that queue wait too, sync or not. With ``group`` the calls go in groups
    of that many, each group behind a spin of its own, and the slowest
    group counts."""
    import torch

    group = group or calls
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _spin(spin_cycles)
    end.record()
    torch.cuda.synchronize()
    spin_s = start.elapsed_time(end) / 1e3
    host_s, busy = 0.0, True
    for first in range(0, calls, group):
        _spin(spin_cycles)
        t0 = time.monotonic()
        for _ in range(min(group, calls - first)):
            step()
        host_s = max(host_s, time.monotonic() - t0)
        busy = busy and not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
    return {"calls": calls, "group": group, "host_s": host_s, "spin_s": spin_s,
            "stream_busy_after": busy, "no_host_sync": busy and host_s < 0.5 * spin_s}


def run_bcoo(path: str, device, steps: int = 20) -> dict:
    """DeviceIter(bcoo) -> LinearLearner(bcoo): the first ``steps`` steps
    on the card under CUDA's sync debug mode "error" and against the same
    batches on the CPU, the first batch's dense form against the CPU
    route's; then a fresh epoch and an accuracy pass (rows/s, stall
    share, the nnz shapes crossed), the step's device time on a resident
    batch beside the ELL step's on the same rows, both steps enqueued
    behind a device spin (:func:`enqueue_behind_spin`: no host sync, also
    none the debug mode cannot see), and one epoch of natural blocks
    (``batch_size=None``)."""
    import torch

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model, it = _bcoo_pipeline(path, device)
    batches = [b for _, b in zip(range(steps), it)]
    it.close()
    torch.cuda.synchronize()
    time.sleep(0.5)  # the producer idle: only the steps run in the window
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = [model.step(b) for b in batches]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the same steps from a fresh learner: the same bits (the gradient's
    # row scatter has no atomics)
    again = LinearLearner(HIGGS_COLS, layout="bcoo", learning_rate=0.3, device=device)
    card_again = [again.step(b) for b in batches]
    repeatable = bool(torch.equal(torch.stack(card), torch.stack(card_again))
                      and torch.equal(model.params.weight, again.params.weight)
                      and torch.equal(model.params.bias, again.params.bias))
    cpu_model = LinearLearner(HIGGS_COLS, layout="bcoo", learning_rate=0.3, device="cpu")
    pairs = [(float(c), float(cpu_model.step(tuple(t.cpu() for t in b))))
             for c, b in zip(card, batches)]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    cpu_it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=HIGGS_COLS,
                        batch_size=BATCH, layout="bcoo", max_nnz=HIGGS_COLS, device="cpu")
    cpu_first = next(cpu_it)
    cpu_it.close()
    x0, y0, w0 = batches[0]
    dense_equal = bool(torch.equal(x0.to_dense().cpu(), cpu_first[0].to_dense())
                       and torch.equal(y0.cpu(), cpu_first[1])
                       and torch.equal(w0.cpu(), cpu_first[2]))
    del batches, card

    model, it = _bcoo_pipeline(path, device)
    t0 = time.monotonic()
    loss, nb = model.fit_epoch(it)
    epoch_s = time.monotonic() - t0
    stall = it.stall_seconds
    acc = model.accuracy(it)
    shapes = sorted(it.nnz_shapes)
    # the step's device time on a resident batch, bcoo and ELL, same rows
    bcoo_batch = next(it)
    it.close()
    _, ell_model, ell_it = _ell_pipeline(path, device)
    ell_batch = next(ell_it)
    ell_it.close()
    for m, b in ((model, bcoo_batch), (ell_model, ell_batch)):
        m.step(b)
    torch.cuda.synchronize()
    bcoo_ms = device_ms(lambda: model.step(bcoo_batch), iters=10)
    ell_ms = device_ms(lambda: ell_model.step(ell_batch), iters=10)
    bcoo_spin = enqueue_behind_spin(lambda: model.step(bcoo_batch))
    ell_spin = enqueue_behind_spin(lambda: ell_model.step(ell_batch))
    forward_ab = coo_forward_ab(model, bcoo_batch, 31)
    nat_model, nat_it = _bcoo_pipeline(path, device, natural=True)
    t0 = time.monotonic()
    nat_loss, nat_nb = nat_model.fit_epoch(nat_it)
    nat_s = time.monotonic() - t0
    nat_it.close()
    out = {"phase": "bcoo", "first_steps": len(pairs), "max_rel_diff": rel,
           "steps_under_sync_error": len(pairs), "card_bit_identical_twice": repeatable,
           "first_batch_dense_equal_cpu": dense_equal,
           "loss": loss, "batches": nb, "wall_s": epoch_s, "rows_per_s": nb * BATCH / epoch_s,
           "stall_s": stall, "stall_share": stall / epoch_s, "accuracy": acc,
           "nnz_shapes": shapes, "step_device_ms": bcoo_ms, "ell_step_device_ms": ell_ms,
           "step_enqueue_behind_spin": bcoo_spin, "ell_step_enqueue_behind_spin": ell_spin,
           "forward_ab": forward_ab, "natural_loss": nat_loss, "natural_batches": nat_nb, "natural_wall_s": nat_s,
           "natural_rows_per_s": HIGGS_ROWS / nat_s}
    emit(out)
    if not (len(pairs) == steps and rel <= 1e-4 and dense_equal):
        raise AssertionError(f"bcoo: the first {steps} steps or batch differ from the CPU: {pairs}")
    if not repeatable:
        raise AssertionError("bcoo: two card runs of the first steps differ")
    if not (bcoo_spin["no_host_sync"] and ell_spin["no_host_sync"]
            and forward_ab["row_scatter_step_behind_spin"]["no_host_sync"]):
        raise AssertionError(f"a step waited for the device: bcoo {bcoo_spin}, ELL {ell_spin}, "
                             f"{forward_ab}")
    if not (forward_ab["linear"]["within_tol"] and forward_ab["fm_v"]["within_tol"]):
        raise AssertionError(f"bcoo: the two forward routes disagree: {forward_ab}")
    if not (acc > 0.9 and np.isfinite(loss) and len(shapes) == 1 and np.isfinite(nat_loss)
            and nat_nb > 0):
        raise AssertionError(f"bcoo epoch failed its checks: {out}")
    return out


def coo_forward_check(x, seed: int) -> dict:
    """One forward of a real bcoo batch ``x`` that is not marked coalesced
    (so ``coo_matmul`` takes the row scatter over its rows) against a
    seeded random table: twice the same bits, bit-equal to
    ``row_scatter_add_ordered_plain`` of the same rows, and within 1e-4 +
    1e-5 of each row's absolute sum of the plain version (zeros +
    ``index_add_``) and of torch's sparse product. Comparison launches:
    the caller reads its counts before."""
    import torch

    from dmlc_tpu_torch.ops import row_scatter as rs
    from dmlc_tpu_torch.ops.sparse import coo_matmul

    dev = x.device
    w = torch.randn(x.shape[1], generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    rows, cols = x._indices()
    src = x._values()[:, None] * w[cols][:, None]
    shape = (x.shape[0], 1)
    with torch.no_grad():
        first, second = coo_matmul(x, w), coo_matmul(x, w)
        library = torch.sparse.mm(x, w[:, None])[:, 0]
    plain = rs.row_scatter_add_plain(shape, rows, src)[:, 0]
    tol = 1e-4 + 1e-5 * rs.row_scatter_add_plain(shape, rows, src.abs())[:, 0]
    err, lib_err = (first - plain).abs(), (first - library).abs()
    return {"rows": x.shape[0], "nnz": rows.numel(), "marked_coalesced": x.is_coalesced(),
            "bit_identical_twice": same_bits(first, second),
            "equal_to_ordered_plain": same_bits(
                first, rs.row_scatter_add_ordered_plain(shape, rows, src)[:, 0]),
            "max_abs_err_vs_plain": float(err.max()), "within_tol": bool((err <= tol).all()),
            "max_abs_err_vs_sparse_mm": float(lib_err.max()),
            "within_tol_sparse_mm": bool((lib_err <= tol).all())}


def coo_forward_failed(check: dict) -> bool:
    return not (not check["marked_coalesced"] and check["bit_identical_twice"]
                and check["equal_to_ordered_plain"] and check["within_tol"]
                and check["within_tol_sparse_mm"])


def coo_forward_ab(model, batch, seed: int) -> dict:
    """``coo_matmul``'s two forward routes on one coalesced batch: torch's
    sparse product (taken for a batch marked coalesced) and the row
    scatter (taken otherwise; here on the same entries, not marked), in
    turns (mm, scatter, scatter, mm), for a ``[D]`` and a ``[D, 8]`` table
    (the linear margin, FM's factors); both within 1e-4 + 1e-5 of each
    row's absolute sum; and the learner's step on each form of the batch,
    the scatter's enqueued behind a device spin. Decides whether the
    sparse product's route is kept (its forward at most 0.8x the
    scatter's on both tables, and its step faster)."""
    import torch

    from dmlc_tpu_torch.ops.sparse import coo_matmul

    x, y, wt = batch
    xu = torch.sparse_coo_tensor(x._indices(), x._values(), x.shape)
    if not x.is_coalesced() or xu.is_coalesced():
        raise AssertionError("the bcoo A/B needs a batch marked coalesced")
    gen = torch.Generator(device=x.device).manual_seed(seed)
    out = {"rows": x.shape[0], "nnz": x._nnz()}
    ab_abs = torch.sparse_coo_tensor(x._indices(), x._values().abs(), x.shape)
    for name, cols in (("linear", 1), ("fm_v", 8)):
        w = torch.randn(x.shape[1], cols, generator=gen, device=x.device)
        with torch.no_grad():
            mm, scat = coo_matmul(x, w), coo_matmul(xu, w)
            tol = 1e-4 + 1e-5 * coo_matmul(ab_abs, w.abs())

            def f_mm():
                return coo_matmul(x, w)

            def f_scat():
                return coo_matmul(xu, w)
            ms = [device_ms(f) for f in (f_mm, f_scat, f_scat, f_mm)]
        out[name] = {"sparse_mm_ms": [ms[0], ms[3]], "row_scatter_ms": ms[1:3],
                     "max_abs_diff": float((mm - scat).abs().max()),
                     "within_tol": bool(((mm - scat).abs() <= tol).all())}
    unmarked = (xu, y, wt)
    model.step(unmarked)
    torch.cuda.synchronize()
    steps = [device_ms(f, iters=10) for f in (lambda: model.step(batch),
                                              lambda: model.step(unmarked),
                                              lambda: model.step(unmarked),
                                              lambda: model.step(batch))]
    out["step_sparse_mm_ms"], out["step_row_scatter_ms"] = [steps[0], steps[3]], steps[1:3]
    # the sort adds launches to the step: in groups of 10, inside the card's
    # launch queue (enqueue_behind_spin), as phase 14's unordered steps
    out["row_scatter_step_behind_spin"] = enqueue_behind_spin(lambda: model.step(unmarked),
                                                              group=10)
    out["keep_sparse_mm"] = bool(
        all(max(out[n]["sparse_mm_ms"]) <= 0.8 * min(out[n]["row_scatter_ms"])
            for n in ("linear", "fm_v"))
        and max(out["step_sparse_mm_ms"]) < min(out["step_row_scatter_ms"]))
    return out


def launch_queue_depth(counts=(500, 1000, 1023, 1024, 1100)) -> dict:
    """How many launches the card queues behind a device spin before the
    host waits: ``n`` one-element adds enqueued behind a half-second spin,
    for each ``n`` in ``counts``."""
    import torch

    x = torch.zeros(1, device="cuda")
    fits = {}
    for n in counts:
        x.add_(1)
        fits[n] = enqueue_behind_spin(lambda: x.add_(1), calls=n)["no_host_sync"]
    return {"phase": "launch_queue", "enqueued_without_waiting": fits}


def step_profile(name: str, step, steps: int = 5, top: int = 8) -> dict:
    """Device events (kernels, copies, fills) a ``step`` issues and their
    time, from ``steps`` steps under ``torch.profiler``, the ``top`` largest
    by name. A measurement, not a check: an empty trace is reported as
    such."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.5)
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    per_kernel: dict = {}
    events = 0
    for evt in prof.events():
        # the optimizer's own range shows on the device too: not an event
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            events += 1
            per_kernel[evt.name] = (per_kernel.get(evt.name, 0.0)
                                    + evt.time_range.elapsed_us() / steps / 1e3)
    largest = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"phase": "step_profile", "step": name, "device_events_per_step": events / steps,
            "device_ms_per_step": sum(per_kernel.values()),
            "top_kernels_ms_per_step": [[k[:80], ms] for k, ms in largest]}


def bcoo_step_profile(path: str, device, steps: int = 10) -> dict:
    """Where a bcoo step's device time goes: ``steps`` steps on one
    resident batch under ``torch.profiler``, device time by kernel a step.
    A measurement, not a check: an empty trace is reported as such."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    model, it = _bcoo_pipeline(path, device)
    batch = next(it)
    it.close()
    model.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.5)
        for _ in range(steps):
            model.step(batch)
        torch.cuda.synchronize()
    per_kernel: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] = (per_kernel.get(evt.name, 0.0)
                                    + evt.time_range.elapsed_us() / steps / 1e3)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"phase": "bcoo_step_profile", "steps": steps,
            "device_ms_per_step": sum(per_kernel.values()),
            "top_kernels_ms_per_step": [[name[:80], ms] for name, ms in top]}


# ---------------- phase 9: the route for row scatters ----------------

ROW_SCATTER_SHAPES = [  # (name, B, K, D, row): B*K rows scattered into a [D, *row] table
    ("als_gram", 512, 32, 513, (16, 16)),             # train_als.py's full size, [D+1, F, F]
    ("als_rhs", 512, 32, 513, (16,)),                 # its [D+1, F] rhs
    ("als_large_gram", 8192, 32, 65_537, (16, 16)),   # a 67 MB gram
    ("als_large_rhs", 8192, 32, 65_537, (16,)),
    ("wide_1d", 8192, 16, (1 << 20) + 1, ()),         # a 1-D table above DW_MAX_TABLE
    ("fm_v", BATCH, HIGGS_COLS, HIGGS_COLS + 1, (8,)),  # phase 10's factor gradient
    ("fm_w", BATCH, HIGGS_COLS, HIGGS_COLS + 1, ()),    # and its linear weights'
    ("kdd_bcoo", BATCH, 10, 50_000_001, ()),   # phase 13's libfm: the bcoo gradient
    ("kdd_fm_v", BATCH, 10, 50_000_001, (8,)),  # and FM's factor gradient
    # phase 13/14's bcoo forward on an unordered batch: each row's 10 ids
    # in row order into [rows, 1], fixed batches and natural blocks
    ("kdd_coo_forward", BATCH, 10, BATCH, (1,)),
    ("kdd_coo_forward_natural", 2 * BATCH, 10, 2 * BATCH, (1,)),
]
ROW_SCATTER_MAIN = "als_gram"
COO_FORWARD_SHAPES = ("kdd_coo_forward", "kdd_coo_forward_natural")


def row_scatter_candidates() -> dict:
    """The routes the A/B times: ``index_add_`` (float atomics),
    ``index_put_(accumulate=True)`` (torch's sort-based kernel) and the
    port's route (a stable sort and ``csrc/row_scatter.cu``)."""
    import torch

    from dmlc_tpu_torch.ops import row_scatter as rs

    def index_add(shape, idx, src):
        return torch.zeros(shape, dtype=src.dtype, device=src.device).index_add_(0, idx, src)

    def index_put(shape, idx, src):
        return torch.zeros(shape, dtype=src.dtype, device=src.device).index_put_(
            (idx,), src, accumulate=True)

    def kernel(shape, idx, src):
        return rs.row_scatter_add(shape, idx, src)

    return {"index_add": index_add, "index_put": index_put, "row_scatter": kernel}


def row_scatter_inputs(b: int, k: int, d: int, row: tuple, seed: int, device):
    """``B*K`` int64 row ids in ``[0, D)``, a quarter of them the sink
    ``D - 1`` with zero rows (an ELL batch's pad slots), and the rows."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, d - 1, (b * k,), generator=gen, device=device)
    src = torch.randn((b * k, *row), generator=gen, device=device)
    pad = torch.rand(b * k, generator=gen, device=device) < 0.25
    idx[pad] = d - 1
    src[pad] = 0.0
    return idx, src


def coo_forward_inputs(b: int, k: int, seed: int, device):
    """A bcoo forward's row scatter: ``k`` entries for each of ``b`` rows,
    row ids ascending, the last eighth of the entries the nnz bucket's
    tail (the pad row ``b - 1``, value 0), and each entry's ``val * w``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.arange(b, device=device).repeat_interleave(k)
    src = torch.randn((b * k, 1), generator=gen, device=device)
    tail = b * k // 8
    idx[-tail:] = b - 1
    src[-tail:] = 0.0
    return idx, src


def parent_row_scatter(lib, table, idx, src, accumulate: bool):
    """The parent's row scatter (the table-driven wrapper and kernel) into
    ``table`` in place: its stable order (its counting sort up to 4,095
    rows, ``torch.sort`` of the ids clamped into ``[-1, D]`` above), then
    its two launches."""
    import torch

    rows, n, dev = table.shape[0], idx.shape[0], table.device
    width = table[0].numel() if table.dim() > 1 else 1
    ids = (idx.clamp(-1, rows) if idx.dtype == torch.int64 else idx).to(torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    counts = lib.dmlc_row_sort_counts(n, rows)
    if counts:
        order = (torch.empty(n, dtype=torch.int32, device=dev),
                 torch.empty(n, dtype=torch.int64, device=dev))
        scratch = torch.empty(counts, dtype=torch.int32, device=dev)
        rc = lib.dmlc_row_sort(ids.contiguous().data_ptr(), n, rows, scratch.data_ptr(),
                               order[0].data_ptr(), order[1].data_ptr(), stream)
        if rc != 0:
            raise AssertionError(f"the parent's row sort failed to launch: {rc}")
    else:
        order = torch.sort(ids, stable=True)
    src = src.contiguous()
    partials = torch.empty((2, lib.dmlc_row_scatter_chunks(n), width), device=dev)
    rc = lib.dmlc_row_scatter_f32(order[0].data_ptr(), order[1].data_ptr(), src.data_ptr(),
                                  table.data_ptr(), partials[0].data_ptr(),
                                  partials[1].data_ptr(), n, width, rows, int(accumulate),
                                  stream)
    if rc != 0:
        raise AssertionError(f"the parent's row scatter failed to launch: {rc}")
    return table


def neg_zero_base(shape, idx, seed: int, device):
    """A random base table with -0.0 in the first word of every 7th row
    (rows the ids hit and rows they miss), and the rows the ids hit."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn(shape, generator=gen, device=device)
    base.view(shape[0], -1)[::7, 0] = -0.0
    touched = torch.zeros(shape[0], dtype=torch.bool, device=device)
    touched[idx] = True
    return base, touched


def neg_zero_differences(parent, change, base, touched) -> tuple:
    """Where ``parent`` and ``change`` (both accumulated onto ``base``) hold
    other bits: ``(only at -0.0 words, their count)``, the first true when
    every such word is an untouched row's -0.0 that the change left as it
    was and the parent wrote as +0.0 (``*out + 0.0f``)."""
    import torch

    p, c, b = (t.view(torch.int32).view(t.shape[0], -1) for t in (parent, change, base))
    neg_zero = torch.tensor(-0.0, device=base.device).view(torch.int32)
    differ = p != c
    allowed = (~touched[:, None]) & (b == neg_zero) & (c == neg_zero) & (p == 0)
    return bool((differ & ~allowed).sum() == 0), int((differ & allowed).sum())


def row_scatter_ab(seed: int, parent=None) -> list:
    """Each candidate route for a row scatter at ``ROW_SCATTER_SHAPES``:
    its bits over two runs, its distance from ``index_add_``, its device
    time (CUDA events behind a spin, median of 5), whether 20 calls enqueue
    behind a half-second spin, and the bytes bound (``src`` and ``idx``
    read once, the table written once). The kernel must agree with the
    plain version (``index_add_``) within 1e-4 + 1e-5 of each word's
    absolute sum, give the same bits twice, and equal, bit for bit, the
    plain version that sums in its order (``row_scatter_add_ordered_plain``)
    with and without ``accumulate`` (onto a table holding -0.0 words); its
    stable order by row id (the counting sort up to 4,095 rows)
    must equal ``torch.sort(stable=True)``'s, bit for bit. At a 1-D table
    wider than ``DW_MAX_TABLE``, the row scatter of ``val * g`` is timed
    against K1's ``dw`` route there, zeros + ``index_add_``: the A/B that
    decides ``dw_route`` (the row scatter within 1.2x would take it). With ``parent`` (the parent's library), the
    parent's route and this one in turns, P C C P, and their bits: equal
    without ``accumulate``, and with it equal but where the parent turned
    an untouched row's -0.0 into +0.0."""
    import torch

    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops import row_scatter as rs

    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for i, (name, b, k, d, row) in enumerate(ROW_SCATTER_SHAPES):
        idx, src = (coo_forward_inputs(b, k, seed + i, dev) if name in COO_FORWARD_SHAPES
                    else row_scatter_inputs(b, k, d, row, seed + i, dev))
        shape = (d, *row)
        n_row = int(np.prod(row)) if row else 1
        bound_ms, bound_by = bound(b * k * (8 + 4 * n_row) + d * n_row * 4, b * k * n_row)
        plain = rs.row_scatter_add_plain(shape, idx, src)
        tol = 1e-4 + 1e-5 * rs.row_scatter_add_plain(shape, idx, src.abs())
        rec = {"phase": "row_scatter_ab", "shape": name, "B": b, "K": k, "D": d,
               "row": list(row), "bound_ms": bound_ms, "bound_by": bound_by}
        for cand, fn in row_scatter_candidates().items():
            first, second = fn(shape, idx, src), fn(shape, idx, src)
            torch.cuda.synchronize()
            err = (first - plain).abs()
            spin = enqueue_behind_spin(lambda: fn(shape, idx, src))
            rec[cand] = {"bit_identical_twice": same_bits(first, second),
                         "max_abs_diff_vs_plain": float(err.max()),
                         "within_tol": bool((err <= tol).all()),
                         "ms": device_ms(lambda: fn(shape, idx, src)),
                         "no_host_sync": spin["no_host_sync"], "spin_host_s": spin["host_s"]}
            del first, second
        del plain, tol
        # the kernel against the plain version in its own order, bit for
        # bit: overwriting, and accumulating onto a table with -0.0 words
        ordered = rs.row_scatter_add_ordered_plain(shape, idx, src)
        base, touched = neg_zero_base(shape, idx, seed + 50 + i, dev)
        kernel_acc = rs.row_scatter_cuda_(base.clone(), idx, src, accumulate=True)
        rec["ordered_plain"] = {
            "equal": same_bits(rs.row_scatter_add(shape, idx, src), ordered),
            "accumulate_equal": same_bits(
                kernel_acc, rs.row_scatter_add_ordered_plain(shape, idx, src, base))}
        if parent is not None:
            def parent_fn():
                return parent_row_scatter(parent, torch.empty(shape, device=dev), idx, src,
                                          False)

            def change_fn():
                return rs.row_scatter_add(shape, idx, src)
            order_ms = [device_ms(f) for f in (parent_fn, change_fn, change_fn, parent_fn)]
            only_neg_zero, kept = neg_zero_differences(
                parent_row_scatter(parent, base.clone(), idx, src, True), kernel_acc, base,
                touched)
            rec["parent"] = {
                "equal": same_bits(parent_fn(), ordered),
                "accumulate_equal_but_neg_zero": only_neg_zero,
                "accumulate_neg_zero_words_kept": kept,
                "parent_ms_runs": [order_ms[0], order_ms[3]], "change_ms_runs": order_ms[1:3]}
        del ordered, base, touched, kernel_acc
        # the stable order by row id against torch's stable sort of the
        # keys, bit for bit (the counting sort's route up to 4,095 rows)
        counting = _build.load_kernels().dmlc_row_sort_counts(b * k, d) > 0
        keys = rs._sort_keys(idx, d).to(torch.int32)
        order, want = rs.stable_order(idx, d), torch.sort(keys, stable=True)
        rec["sort"] = {"route": "counting" if counting else "torch.sort",
                       "equal_to_torch_sort": all(torch.equal(x, y) for x, y in zip(order, want)),
                       "ms": device_ms(lambda: rs.stable_order(idx, d)),
                       "torch_sort_ms": device_ms(lambda: torch.sort(keys, stable=True))}
        # the plain version (zeros and index_add_) and the one PyTorch call,
        # index_add_ into a table already there
        acc = torch.zeros(shape, device=dev)
        rec["plain_ms"] = device_ms(lambda: rs.row_scatter_add_plain(shape, idx, src))
        rec["library_ms"] = device_ms(lambda: acc.index_add_(0, idx, src))
        del acc
        if not row and d > k1.DW_MAX_TABLE:
            # K1's dw at this table on the row scatter (of val * g over the
            # indices) against its route, zeros + index_add_
            # (ell_matvec_grads): within 1.2x would move dw_route
            idx2, val = idx.to(torch.int32).view(b, k), src.view(b, k)
            g = torch.randn(b, generator=torch.Generator(device=dev).manual_seed(seed + 70 + i),
                            device=dev)
            w = torch.zeros(d, device=dev)

            def wide_dw():
                return rs.row_scatter_add((d,), idx2.flatten(), (val * g[:, None]).flatten())
            dw = wide_dw()
            dw_ms = device_ms(wide_dw)
            dw_plain_ms = device_ms(lambda: k1.ell_matvec_grads(w, idx2, val, g,
                                                                need_dval=False))
            rec["dw"] = {"route": k1.dw_route(d), "ms": dw_ms, "plain_ms": dw_plain_ms,
                         "vs_plain": dw_ms / dw_plain_ms,
                         "within_bar_1_2": dw_ms <= 1.2 * dw_plain_ms,
                         "bit_identical_twice": same_bits(dw, wide_dw()),
                         "equal_to_ordered_plain": same_bits(dw, rs.row_scatter_add_ordered_plain(
                             (d,), idx2.flatten(), (val * g[:, None]).flatten()))}
            del w, dw
        emit(rec)
        rows.append(rec)
        kern, ordered_rec = rec["row_scatter"], rec["ordered_plain"]
        problems = []
        if not (kern["bit_identical_twice"] and kern["within_tol"] and kern["no_host_sync"]
                and rec["sort"]["equal_to_torch_sort"]):
            problems.append(f"the kernel differs from its plain version, between two runs, "
                            f"or waited for the device: {kern}")
        if not (ordered_rec["equal"] and ordered_rec["accumulate_equal"]):
            problems.append(f"the kernel differs from its ordered plain version: {ordered_rec}")
        if "dw" in rec and not (rec["dw"]["bit_identical_twice"]
                                and rec["dw"]["equal_to_ordered_plain"]):
            problems.append(f"the wide dw: {rec['dw']}")
        if "parent" in rec and not (rec["parent"]["equal"]
                                    and rec["parent"]["accumulate_equal_but_neg_zero"]):
            problems.append(f"the parent's kernel gives other bits: {rec['parent']}")
        if problems:
            raise AssertionError(f"row_scatter {name}: {problems}")
    return rows


# ---------------- phase 9 (b): the Adam update ----------------

ADAM_SHAPES = [  # (name, W, F, offset): FM's leaves w0 [], w [W], V [W, F]
    ("kdd12_fm", 54_686_453, 8, 0),       # the KDD12 cell's table: P = 492,178,078
    ("higgs_fm", HIGGS_COLS + 1, 8, 0),    # phase 10's
    ("higgs_fm_unaligned", HIGGS_COLS + 1, 8, 1),  # every leaf one float off 16 bytes
]
ADAM_MAIN = "kdd12_fm"
ADAM_STEPS = 3  # steps the kernel is held to the ordered plain version over


def _adam_leaves(w: int, f: int, offset: int, seed: int, dev) -> list:
    """FM's three leaves (``[]``, ``[W]``, ``[W, F]``), each ``offset``
    floats into a storage of its own, drawn from ``seed``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for shape in ((), (w,), (w, f)):
        n = int(np.prod(shape)) if shape else 1
        out.append(torch.randn(n + offset, generator=gen, device=dev)[offset:].view(shape))
    return out


def _adam_grads(leaves: list, seed: int) -> list:
    """A gradient for each leaf, nine rows in ten zero (as an FM table's)."""
    import torch

    gen = torch.Generator(device=leaves[0].device).manual_seed(seed)
    out = []
    for p in leaves:
        g = torch.empty_like(p).normal_(generator=gen)
        if p.dim():
            keep = torch.rand(p.shape[0], generator=gen, device=p.device) < 0.1
            g.mul_(keep.view(-1, *([1] * (p.dim() - 1))))
        out.append(g)
    return out


def _torch_adam_ms(leaves: list, grads: list, **kw) -> float:
    """Device time of one ``torch.optim.Adam(**kw).step()`` over copies of
    ``leaves`` holding ``grads``: timed only, never called by the port."""
    import torch

    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    for p, g in zip(ps, grads):
        p.grad = g
    opt = torch.optim.Adam(ps, lr=0.05, **kw)
    ms = device_ms(opt.step, iters=20)
    del opt, ps
    torch.cuda.empty_cache()
    return ms


def adam_ab(seed: int) -> list:
    """The Adam update at ``ADAM_SHAPES``: the kernel (``csrc/adam_step.cu``,
    through ``adam_step_``) held bit for bit to ``adam_step_ordered_plain_``
    over ``ADAM_STEPS`` steps of sparse gradients (p, m and v each step), one
    launch a step for the three leaves; its device time (CUDA events behind
    a spin, the median of 5) beside its bytes bound (28 bytes a parameter),
    the plain version's, ``torch.optim.Adam(fused=True)``'s (the library's
    kernel, timed only) and the default foreach update's; and whether 20
    steps enqueue behind a half-second spin."""
    import torch

    from dmlc_tpu_torch.ops import adam

    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for i, (name, w, f, offset) in enumerate(ADAM_SHAPES):
        leaves = _adam_leaves(w, f, offset, seed + i, dev)
        n = sum(p.numel() for p in leaves)
        m, v = [torch.zeros_like(p) for p in leaves], [torch.zeros_like(p) for p in leaves]
        ours = leaves + m + v
        plain = [t.clone() for t in ours]
        equal, launched = True, 0
        for t in range(1, ADAM_STEPS + 1):
            grads = _adam_grads(leaves, seed + 100 * i + t)
            before = adam.launches
            adam.adam_step_(leaves, grads, m, v, [float(t)] * 3, lr=0.05)
            launched += adam.launches - before
            adam.adam_step_ordered_plain_(plain[:3], grads, plain[3:6], plain[6:],
                                          [float(t)] * 3, lr=0.05)
            torch.cuda.synchronize()
            equal = equal and all(same_bits(a, b) for a, b in zip(ours, plain))
            del grads
        max_abs_err = max(float((a - b).abs().max()) for a, b in zip(ours, plain))
        del plain
        torch.cuda.empty_cache()
        grads = _adam_grads(leaves, seed + 100 * i)
        steps = [float(ADAM_STEPS + 1)] * 3

        def kernel():
            adam.adam_step_(leaves, grads, m, v, steps, lr=0.05)

        def plain_fn():
            adam.adam_step_ordered_plain_(leaves, grads, m, v, steps, lr=0.05)
        # 28 bytes and 13 operations a parameter (sqrt and div counted once)
        bound_ms, bound_by = bound(28 * n, 13 * n)
        ms = device_ms(kernel, iters=20)
        spin = enqueue_behind_spin(kernel)
        rec = {"phase": "adam_ab", "shape": name, "W": w, "F": f, "offset": offset,
               "params": n, "equal_to_ordered_plain": equal, "max_abs_err": max_abs_err,
               "launches_per_step": launched / ADAM_STEPS, "ms": ms,
               "plain_ms": device_ms(plain_fn, iters=5),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "hbm_share": bound_ms / ms, "bytes_per_s": 28 * n / ms * 1e3,
               "no_host_sync": spin["no_host_sync"], "spin_host_s": spin["host_s"]}
        if offset == 0:
            rec["library_ms"] = _torch_adam_ms(leaves, grads, fused=True)
            rec["foreach_ms"] = _torch_adam_ms(leaves, grads, foreach=True)
        emit(rec)
        rows.append(rec)
        del leaves, grads, m, v, ours
        torch.cuda.empty_cache()
        if not (equal and launched == ADAM_STEPS and spin["no_host_sync"]):
            raise AssertionError(f"adam_step {name}: the kernel differs from its ordered "
                                 f"plain version, launched otherwise than once a step, or "
                                 f"waited for the device: {rec}")
    return rows


ADAM_ROWS_SHAPES = [  # (name, W, F, ids a step): a cell's table and batch
    ("kdd12_fm", 54_686_453, 8, 8192 * 10),       # P = 492,178,078
    ("criteo1tb_fm", 187_767_413, 8, 8192 * 39),  # P = 1,689,906,718
]


def _marked_grads(leaves: list, n_ids: int, gen) -> tuple:
    """A batch's int32 ids (uniform over the rows) and FM's gradients for
    them: ``w0``'s drawn, ``w``'s and ``V``'s drawn on the rows the ids
    name and +0.0 on every other row, as the row scatter leaves them."""
    import torch

    dev = leaves[0].device
    ids = torch.randint(0, leaves[1].shape[0], (n_ids,), generator=gen, device=dev,
                        dtype=torch.int32)
    grads = [torch.randn((), generator=gen, device=dev)]
    for p in leaves[1:]:
        g = torch.zeros_like(p)
        g[ids.long()] = torch.randn((n_ids, *p.shape[1:]), generator=gen, device=dev)
        grads.append(g)
    return ids, grads


def adam_rows_ab(seed: int) -> list:
    """The Adam update with row marks (``FusedAdam.step(rows=)``'s launches:
    ``mark_rows_cuda_`` then the masked ``adam_step_``) beside the full read,
    at ``ADAM_ROWS_SHAPES``: the mark equal to ``mark_rows_plain``, the
    masked launch bit for bit equal to the full one over ``ADAM_STEPS``
    steps of other ids (p, m and v each step); the device time (CUDA events
    around 50 launches behind a spin, the median of 5) of the full launch
    beside its 28-byte bound, of the mark alone, and of the mark and the
    masked launch beside the 24-byte bound; the share of rows read; and
    whether 20 marked updates enqueue behind a half-second spin."""
    import torch

    from dmlc_tpu_torch.ops import adam

    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for i, (name, w, f, n_ids) in enumerate(ADAM_ROWS_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(seed + 200 + i)
        leaves = _adam_leaves(w, f, 0, seed + 200 + i, dev)
        n = sum(p.numel() for p in leaves)
        full = [p.clone() for p in leaves]
        m, v, m_full, v_full = ([torch.zeros_like(p) for p in leaves] for _ in range(4))
        bitmap = torch.empty((w + 31) // 32, dtype=torch.int32, device=dev)
        masks = [None, bitmap, bitmap]
        equal = mark_equal = True
        marked = 0
        for t in range(1, ADAM_STEPS + 1):
            ids, grads = _marked_grads(leaves, n_ids, gen)
            adam.mark_rows_cuda_(bitmap, ids, w)
            adam.adam_step_(leaves, grads, m, v, [float(t)] * 3, lr=0.05, masks=masks)
            adam.adam_step_(full, grads, m_full, v_full, [float(t)] * 3, lr=0.05)
            torch.cuda.synchronize()
            words, rows_marked = adam.mark_rows_plain(ids, w)
            mark_equal = mark_equal and same_bits(bitmap, words)
            marked += rows_marked
            equal = equal and all(same_bits(a, b) for a, b in zip(leaves + m + v,
                                                                  full + m_full + v_full))
            del grads
        read_share = marked / (w * ADAM_STEPS)
        del full, m_full, v_full
        torch.cuda.empty_cache()
        ids, grads = _marked_grads(leaves, n_ids, gen)
        steps = [float(ADAM_STEPS + 1)] * 3

        def full_fn():
            adam.adam_step_(leaves, grads, m, v, steps, lr=0.05)

        def mark_fn():
            adam.mark_rows_cuda_(bitmap, ids, w)

        def masked_fn():
            mark_fn()
            adam.adam_step_(leaves, grads, m, v, steps, lr=0.05, masks=masks)
        bound28_ms, _ = bound(28 * n, 13 * n)
        bound24_ms, bound_by = bound(24 * n, 13 * n)
        full_ms = device_ms(full_fn)
        masked_ms = device_ms(masked_fn)
        mark_ms = device_ms(mark_fn)
        spin = enqueue_behind_spin(masked_fn)
        rec = {"phase": "adam_rows_ab", "shape": name, "W": w, "F": f, "ids": n_ids,
               "params": n, "masked_equal_to_full": equal, "mark_equal_to_plain": mark_equal,
               "rows_read_share": read_share, "full_ms": full_ms,
               "full_hbm_share_28": bound28_ms / full_ms, "masked_ms": masked_ms,
               "mark_ms": mark_ms, "bound24_ms": bound24_ms, "bound_by": bound_by,
               "masked_hbm_share_24": bound24_ms / masked_ms,
               "saved_ms": full_ms - masked_ms,
               "no_host_sync": spin["no_host_sync"], "spin_host_s": spin["host_s"]}
        emit(rec)
        rows.append(rec)
        del leaves, grads, m, v, bitmap
        torch.cuda.empty_cache()
        if not (equal and mark_equal and spin["no_host_sync"]):
            raise AssertionError(f"adam_step {name} with row marks: the masked launch differs "
                                 f"from the full one, the mark from its plain version, or a "
                                 f"marked update waited for the device: {rec}")
    return rows


# ---------------- phase 9: ALS ----------------

ALS = {"users": 4096, "items": 512, "factors": 16, "per_row": 32, "batch": 512,
       "reg": 0.05, "epochs": 4, "restore_epoch": 1, "restore_at": 2,
       "chunk_bytes": 64 << 10}  # examples/train_als.py's full run


def write_ratings_corpus(path: str, seed: int, rank: int = 4) -> dict:
    """``examples/train_als.py``'s ``synthesize`` at its full size: one
    libsvm row per user (label = user id, features = item:rating) from a
    rank-4 model, written from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    users, items, per_row = ALS["users"], ALS["items"], ALS["per_row"]
    gt_u = rng.normal(size=(users, rank)).astype(np.float32)
    gt_v = rng.normal(size=(items, rank)).astype(np.float32)
    with open(path, "w") as f:
        for uid in range(users):
            cols = rng.choice(items, size=per_row, replace=False)
            ratings = gt_u[uid] @ gt_v[cols].T
            f.write(f"{uid} " + " ".join(f"{j}:{r:.6f}" for j, r in zip(cols, ratings)) + "\n")
    return {"rows": users, "bytes": os.path.getsize(path)}


def _als_pipeline(path: str, device):
    """(learner, DeviceIter) of the ALS path, fresh, as a user builds them."""
    from dmlc_tpu_torch import AlsLearner, DeviceIter, create_parser

    model = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                       seed=0, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", chunk_bytes=ALS["chunk_bytes"]),
                    num_col=model.device_num_col(), batch_size=ALS["batch"], layout="ell",
                    max_nnz=ALS["per_row"], drop_remainder=True, device=device)
    return model, it


def _state_bits(state: dict) -> bytes:
    return b"".join(np.ascontiguousarray(state[k]).tobytes() for k in sorted(state))


def run_als(path: str, device, steps: int = 20) -> dict:
    """create_parser -> DeviceIter(ell) -> AlsLearner -> fit(4 epochs) ->
    eval_loss, with the row scatter's launches zeroed just before and read
    just after; then ``steps`` card steps (cycling over one epoch's
    batches) and ``finalize_items`` run twice from the same seed, bit for
    bit, and against the same steps on the CPU: the losses, the normal
    equations before the item solve and the items after it; each step's
    scatter into the ``[D+1, F*F+F]`` normal equations against its plain
    version on the same rows; a checkpoint at batch ``restore_at`` of epoch
    ``restore_epoch + 1`` resumed in fresh objects, its loss tail, item
    solve and the next epoch byte for byte; 20 steps enqueued behind a
    device spin; the step's device time and host wall."""
    import torch

    from dmlc_tpu_torch import AlsLearner
    from dmlc_tpu_torch.ops import row_scatter as rs
    from dmlc_tpu_torch.ops.sparse import EllBatch

    model, it = _als_pipeline(path, device)
    epochs = []

    def log(epoch, loss, nb, secs):
        epochs.append({"epoch": epoch, "loss": loss, "batches": nb, "wall_s": secs,
                       "rows_per_s": nb * ALS["batch"] / secs})

    rs.launches = 0
    t0 = time.monotonic()
    model.fit(it, epochs=ALS["epochs"], log_fn=log)
    fit_s = time.monotonic() - t0
    mse = model.eval_loss(it)
    launches = rs.launches
    batches = [EllBatch(*(t.clone() for t in b)) for b in it]  # one epoch, resident
    it.close()
    steps_run = sum(e["batches"] for e in epochs)
    scatter = {"max_abs_err": 0.0, "within_tol": True, "same_bits_as_step": True}

    def trajectory(init_state=None, dev=device):
        """The losses, the normal equations before the item solve, the
        state after it and, on the CPU, each normal-equation word's absolute
        sum. On the card each step's scatter is also held against its plain
        version (launches that compare do not count)."""
        m = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                       seed=0, device=dev)
        if init_state is not None:
            m.load_state_dict(init_state)
        losses, abs_eq = [], torch.zeros_like(m._normal_eq)
        for i in range(steps):
            b = EllBatch(*(t.to(dev) for t in batches[i % len(batches)]))
            before = m._normal_eq.clone()
            losses.append(m.step(b))
            ids, rows = m.normal_eq_rows(b, m.params.users[b.label.long()])
            if dev == "cpu":
                rs.row_scatter_add_plain_(abs_eq, ids, rows.abs())
            else:
                kern = rs.row_scatter_add_(before.clone(), ids, rows)
                plain = rs.row_scatter_add_plain_(before.clone(), ids, rows)
                tol = 1e-4 + 1e-5 * rs.row_scatter_add_plain_(before.abs(), ids, rows.abs())
                err = (kern - plain).abs()
                scatter["max_abs_err"] = max(scatter["max_abs_err"], float(err.max()))
                scatter["within_tol"] &= bool((err <= tol).all())
                scatter["same_bits_as_step"] &= same_bits(kern, m._normal_eq)
        eq = m._normal_eq.clone()
        m.finalize_items()
        return (torch.stack(losses).cpu().numpy(), eq.cpu().numpy(), abs_eq.cpu().numpy(),
                m.state_dict())

    init = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                      seed=0, device=device).state_dict()
    card_a, eq_a, _, state_a = trajectory()
    card_b, eq_b, _, state_b = trajectory()
    cpu, eq_cpu, abs_cpu, state_cpu = trajectory(init, "cpu")
    repeatable = (card_a.tobytes() == card_b.tobytes() and eq_a.tobytes() == eq_b.tobytes()
                  and _state_bits(state_a) == _state_bits(state_b))
    rel = float(np.max(np.abs(card_a - cpu) / np.maximum(np.abs(cpu), 1e-12)))
    # the normal equations within 1e-4 of each word's absolute sum (a
    # dropped or doubled entry is some 1/640 of it), the items within
    # rtol 1e-4 / atol 1e-5 of the CPU's, as the CPU parity tests hold them
    eq_rel = float(np.max(np.abs(eq_a - eq_cpu) / (abs_cpu + 1e-5)))
    items_diff = np.abs(state_a["items"] - state_cpu["items"])
    items_ok = bool(np.all(items_diff <= 1e-5 + 1e-4 * np.abs(state_cpu["items"])))

    # a checkpoint mid-epoch, resumed in fresh objects; both runs go on
    # through the item solve and the next epoch
    def rest_and_next_epoch(model, it, losses):
        losses += [model.step(b) for b in it]
        model.finalize_items()
        it.reset()
        losses += [model.step(b) for b in it]
        it.close()
        return torch.stack(losses).cpu().numpy(), model.state_dict()

    model, it = _als_pipeline(path, device)
    # the state a seek of the registry stack's split takes, or the count the
    # fused native reader's restore replays
    producer = type(it.source).__name__
    want_kind = "batches" if producer == "NativeStreamParser" else "source"
    for _ in range(ALS["restore_epoch"]):
        model.fit_epoch(it)
    losses_a, ckpt = [], None
    for batch in it:
        losses_a.append(model.step(batch))
        if len(losses_a) == ALS["restore_at"]:
            ckpt = (model.state_dict(), json.loads(json.dumps(it.state_dict())))
            break
    losses_a, ckpt_state_a = rest_and_next_epoch(model, it, losses_a)
    model, it = _als_pipeline(path, device)
    model.load_state_dict(ckpt[0])
    it.load_state(ckpt[1])
    replay, ckpt_state_b = rest_and_next_epoch(model, it, [])
    tail = losses_a[ALS["restore_at"]:]
    epoch_len = ALS["users"] // ALS["batch"]

    batch = batches[0]
    model.step(batch)
    torch.cuda.synchronize()
    # some 50 launches a step: two groups of 10 stay well inside the queue
    spin = enqueue_behind_spin(lambda: model.step(batch), group=10)
    dev_ms = device_ms(lambda: model.step(batch), iters=10)
    t0 = time.monotonic()
    for _ in range(50):
        model.step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) / 50 * 1e3
    out = {"phase": "als", "epochs": epochs, "fit_s": fit_s, "eval_mse": mse,
           "steps": steps_run, "row_scatter_launches": launches,
           "row_scatter_launches_needed": steps_run,
           "card_bit_identical_twice": repeatable, "first_steps": steps,
           "max_rel_diff_vs_cpu": rel, "normal_eq_max_diff_over_abs_sum_vs_cpu": eq_rel,
           "items_max_abs_diff_vs_cpu": float(items_diff.max()),
           "items_within_tol_of_cpu": items_ok, "main_path_scatter_vs_plain": scatter,
           "checkpoint_producer": producer, "checkpoint_state_kind": ckpt[1]["kind"],
           "checkpoint_tail_steps": len(tail),
           "checkpoint_tail_bytes_equal": tail.tobytes() == replay.tobytes(),
           "checkpoint_final_state_bytes_equal":
               _state_bits(ckpt_state_a) == _state_bits(ckpt_state_b),
           "step_device_ms": dev_ms, "step_wall_ms": wall_ms, "step_enqueue_behind_spin": spin}
    emit(out)
    losses = [e["loss"] for e in epochs]
    problems = []
    if not (all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:]))
            and np.isfinite(mse)):
        problems.append("the epoch losses are not finite and falling")
    if launches < steps_run:
        problems.append("the main path's scatters did not all take the kernel")
    if not repeatable:
        problems.append("two card runs differ")
    if not rel <= 1e-4:
        problems.append("the card's losses differ from the CPU's")
    if not (eq_rel <= 1e-4 and items_ok):
        problems.append("the card's normal equations or items differ from the CPU's")
    if not (scatter["within_tol"] and scatter["same_bits_as_step"]):
        problems.append("a step's scatter differs from its plain version or from itself")
    if not (out["checkpoint_tail_bytes_equal"] and out["checkpoint_final_state_bytes_equal"]
            and len(tail) == 2 * epoch_len - ALS["restore_at"] and ckpt[1]["kind"] == want_kind):
        problems.append("the checkpoint did not replay the loss tail, item solve and next epoch")
    if not spin["no_host_sync"]:
        problems.append("a step waited for the device")
    if problems:
        raise AssertionError(f"als: {problems}: {out}")
    return {**out, "step_fn": lambda: model.step(batch)}


# ---------------- phase 10: FM ----------------

FM_EPOCHS = {"ell": 2, "dense": 2, "bcoo": 1}


def _fm_pipeline(path: str, device, layout: str, seed: int = 0):
    """(learner, DeviceIter) of the FM path on the HIGGS-shaped corpus."""
    from dmlc_tpu_torch import DeviceIter, FMLearner, create_parser

    model = FMLearner(HIGGS_COLS, num_factors=8, layout=layout, learning_rate=0.05, seed=seed,
                      device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout=layout, max_nnz=HIGGS_COLS, drop_remainder=True,
                    device=device)
    return model, it


def _fm_params_bits(model) -> bytes:
    return b"".join(p.detach().cpu().numpy().tobytes() for p in model.params)


def run_fm(path: str, device, layout: str, steps: int = 20) -> dict:
    """FMLearner on ``layout``: fit(``FM_EPOCHS``) -> accuracy with the row
    scatter's launches zeroed just before and read just after; ``steps``
    card steps run twice from the same seed, bit for bit, and against the
    same batches on the CPU; 20 steps enqueued behind a device spin; the
    step's device time."""
    import torch

    from dmlc_tpu_torch import FMLearner
    from dmlc_tpu_torch.convert import fm_params_from_jax, fm_params_to_jax
    from dmlc_tpu_torch.ops import adam
    from dmlc_tpu_torch.ops import row_scatter as rs

    model, it = _fm_pipeline(path, device, layout)
    rs.launches = adam.launches = 0
    t0 = time.monotonic()
    losses = []
    model.fit(it, epochs=FM_EPOCHS[layout], log_fn=lambda e, loss, nb, s: losses.append(loss))
    fit_s = time.monotonic() - t0
    acc = model.accuracy(it)
    launches, adam_launches = rs.launches, adam.launches
    nb = HIGGS_ROWS // BATCH * FM_EPOCHS[layout]
    batches = [b for _, b in zip(range(steps), it)]
    it.close()

    def trajectory(dev=device, init=None):
        m = FMLearner(HIGGS_COLS, num_factors=8, layout=layout, learning_rate=0.05, seed=0,
                      device=dev)
        if init is not None:
            m.set_params(fm_params_from_jax(*init, device=dev))
        out = [m.step(tuple(t.to(dev) for t in b) if layout != "ell"
                      else type(b)(*(t.to(dev) for t in b))) for b in batches]
        return torch.stack(out).cpu().numpy(), m

    card_a, m_a = trajectory()
    card_b, m_b = trajectory()
    init = fm_params_to_jax(FMLearner(HIGGS_COLS, num_factors=8, layout=layout, seed=0,
                                      device=device).params)
    cpu, _ = trajectory("cpu", init)
    repeatable = (card_a.tobytes() == card_b.tobytes()
                  and _fm_params_bits(m_a) == _fm_params_bits(m_b))
    rel = float(np.max(np.abs(card_a - cpu) / np.maximum(np.abs(cpu), 1e-12)))
    batch = batches[0]
    m_a.step(batch)
    torch.cuda.synchronize()
    # 50-130 launches a step: groups of 5 stay well inside the launch queue
    spin = enqueue_behind_spin(lambda: m_a.step(batch), group=5)
    dev_ms = device_ms(lambda: m_a.step(batch), iters=10)
    out = {"phase": "fm", "layout": layout, "epoch_losses": losses, "fit_s": fit_s,
           "rows_per_s": nb * BATCH / fit_s, "accuracy": acc, "steps": nb,
           "row_scatter_launches": launches, "adam_launches": adam_launches,
           "card_bit_identical_twice": repeatable,
           "first_steps": len(batches), "max_rel_diff_vs_cpu": rel, "step_device_ms": dev_ms,
           "step_enqueue_behind_spin": spin}
    emit(out)
    problems = []
    if not (acc > 0.9 and all(np.isfinite(losses))):
        problems.append("accuracy <= 0.9 or a non-finite loss")
    if not repeatable:
        problems.append("two card runs differ")
    if not (len(batches) == steps and rel <= 1e-4):
        problems.append("the card's losses differ from the CPU's")
    if not spin["no_host_sync"]:
        problems.append("a step waited for the device")
    # the ell gathers' gradients (w and V) and bcoo's three products' each
    # scatter once a step; the dense path has none
    need = {"ell": 2, "bcoo": 3, "dense": 0}[layout] * nb
    if launches < need:
        problems.append(f"the row scatter launched {launches} times, the path needs {need}")
    # FusedAdam: one launch a step for the three leaves
    if adam_launches != nb:
        problems.append(f"the Adam kernel launched {adam_launches} times for {nb} steps")
    if problems:
        raise AssertionError(f"fm {layout}: {problems}: {out}")
    return {**out, "row_scatter_launches_needed": need, "step_fn": lambda: m_a.step(batch)}


# ---------------- phase 11: data parallelism ----------------

PAR = {"steps": 20, "ranks": 2, "child_timeout": 300, "nccl_timeout": 60,
       "uneven_rows": 4096}


def _par_ell(path: str, mesh, part: int, parts: int, device=None):
    """(learner, DeviceIter) of the ELL path on one rank's part (a mesh's
    device), or on ``device`` without a mesh."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, mesh=mesh, device=device)
    it = DeviceIter(create_parser(path, part, parts, "libsvm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout="ell", max_nnz=HIGGS_COLS, drop_remainder=True,
                    mesh=mesh, shardings=model.batch_shardings(), device=device)
    return model, it


def _first_batches(it, n: int) -> list:
    """The iterator's first ``n`` batches (ELL, or dense ``(x, y, w)``),
    copied, so a timed loop steps and does not parse; the iterator is
    closed."""
    from dmlc_tpu_torch.ops.sparse import EllBatch

    def clone(b):
        ts = (t.clone() for t in b)
        return EllBatch(*ts) if isinstance(b, EllBatch) else tuple(ts)

    out = [clone(b) for _, b in zip(range(n), it)]
    it.close()
    return out


def _par_dense(path: str, mesh, part: int, parts: int, device=None, model_axis=None):
    """(learner, DeviceIter) of the dense path, unpacked, on one rank's part
    (``model_axis``: feature-sharded, the rank's columns), or on ``device``
    without a mesh."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, mesh=mesh,
                          model_axis=model_axis, device=device)
    it = DeviceIter(create_parser(path, part, parts, "libsvm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout="dense", pack_aux=False, drop_remainder=True,
                    mesh=mesh, shardings=model.batch_shardings(), device=device)
    return model, it


def _bits(tensors) -> str:
    import hashlib

    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()


def parallel_world1_child(path: str, out: str) -> None:
    """Leg (a), in a process of its own: a process group of one rank.
    ``init_from_env`` skips a one-worker job, as the JAX package does, so
    this calls ``init_process_group`` itself; the data axis holds this one
    rank, so the learner issues no collective over it. The HIGGS-shaped
    main path with ``mesh=``: one epoch and an accuracy pass with K1's and
    ``dw``'s launches counted; the first 20 steps against the non-mesh
    learner on the same batches, bit for bit; 20 mesh steps enqueued behind
    a device spin; the mesh step's and the plain step's device time. Then
    feature sharding's world-1 leg on the same group (``fs_world1``)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from dmlc_tpu_torch import LinearLearner
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.parallel import make_mesh
    from dmlc_tpu_torch.parallel.distributed import exit_rank
    from dmlc_tpu_torch.parallel.launch import free_port

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, timeout=timedelta(seconds=60))
    mesh = make_mesh()
    model, it = _par_ell(path, mesh, 0, 1)
    k1.launches = k1.dw_launches = 0
    t0 = time.monotonic()
    loss, nb = model.fit_epoch(it)
    fit_s = time.monotonic() - t0
    acc = model.accuracy(it)
    launches, dw_launches = k1.launches, k1.dw_launches
    it.close()
    batches = _first_batches(_par_ell(path, None, 0, 1, device=mesh.device)[1], PAR["steps"])
    plain = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=mesh.device)
    meshed = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, mesh=mesh)
    plain_losses = torch.stack([plain.step(b) for b in batches])
    mesh_losses = torch.stack([meshed.step(b) for b in batches])
    rec = {"phase": "parallel_world1", "backend": dist.get_backend(), "loss": loss,
           "batches": nb, "fit_s": fit_s, "rows_per_s": nb * BATCH / fit_s, "accuracy": acc,
           "k1_launches": launches, "k1_launches_needed": 2 * nb, "dw_launches": dw_launches,
           "dw_launches_needed": nb,
           "first_losses_bit_equal_to_plain": torch.equal(plain_losses, mesh_losses),
           "params_bit_equal_to_plain": all(torch.equal(p, q) for p, q in
                                            zip(plain.params, meshed.params))}
    batch = batches[0]
    torch.cuda.synchronize()
    # groups of 10 steps stay well inside the card's launch queue
    rec["step_enqueue_behind_spin"] = enqueue_behind_spin(lambda: meshed.step(batch), group=10)
    rec["mesh_step_device_ms"] = device_ms(lambda: meshed.step(batch), iters=10)
    rec["plain_step_device_ms"] = device_ms(lambda: plain.step(batch), iters=10)
    dense = _first_batches(_par_dense(path, None, 0, 1, device=mesh.device)[1], PAR["steps"])
    rec["fs_world1"] = fs_world1(make_mesh({"data": 1, "model": 1}), batches, dense)
    with open(out, "w") as f:
        json.dump(rec, f)
    exit_rank()  # destroys the group and skips torch's teardown at exit


def parallel_nccl_pair_child(out_dir: str) -> None:
    """Two NCCL ranks on one card: the job's rendezvous and one
    all-reduce. NCCL is expected to refuse two ranks on one device."""
    from datetime import timedelta

    import torch

    from dmlc_tpu_torch.parallel import init_from_env, make_mesh
    from dmlc_tpu_torch.parallel.distributed import exit_rank

    contract = init_from_env(timeout=timedelta(seconds=PAR["nccl_timeout"]))
    t = make_mesh().all_reduce_(torch.ones(4, device="cuda"))
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, f"nccl_{contract.task_id}.json"), "w") as f:
        json.dump({"sum": t.tolist()}, f)
    exit_rank()


def parallel_pair_child(cfg_path: str) -> None:
    """Leg (b), one of two ranks sharing the card through gloo (named: the
    card's default, NCCL, refuses two ranks on one device). On this rank's
    parts: 20 ELL ``LinearLearner`` and ``FMLearner`` steps, one ALS epoch
    with the item solve, and ``sync_min`` over uneven shards, with K1's,
    ``dw``'s and the row scatter's launches counted."""
    from datetime import timedelta

    import torch

    from dmlc_tpu_torch import AlsLearner, DeviceIter, FMLearner, LinearLearner, create_parser
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops import row_scatter as rs
    from dmlc_tpu_torch.parallel import host_shard_info, init_from_env, make_mesh, sync_min
    from dmlc_tpu_torch.parallel.distributed import exit_rank

    cfg = json.load(open(cfg_path))
    init_from_env(backend="gloo", device=cfg["device"], timeout=timedelta(seconds=120))
    mesh = make_mesh(devices=cfg["device"])
    rank, world = host_shard_info()
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    k1.launches = k1.dw_launches = rs.launches = 0

    model, it = _par_ell(cfg["higgs"], mesh, rank, world)
    batches = _first_batches(it, PAR["steps"])
    # every rank steps as often (a shorter shard would leave its peer waiting)
    if len(batches) != PAR["steps"]:
        raise AssertionError(f"rank {rank}: {len(batches)} batches, {PAR['steps']} needed")
    sync()
    t0 = time.monotonic()
    losses = torch.stack([model.step(b) for b in batches])
    sync()
    secs = time.monotonic() - t0
    out["linear"] = {"losses": losses.tolist(), "bits": _bits(model.params),
                     "global_rows_per_s": len(batches) * BATCH * world / secs}
    fm = FMLearner(HIGGS_COLS, num_factors=8, layout="ell", learning_rate=0.05, seed=0,
                   mesh=mesh)
    fm_losses = torch.stack([fm.step(b) for b in batches])
    out["fm"] = {"losses": fm_losses.tolist(), "bits": _bits(fm.params)}

    als = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                     seed=0, mesh=mesh)
    parser = create_parser(cfg["ratings"], rank, world, "libsvm", threaded=False,
                           chunk_bytes=ALS["chunk_bytes"])
    per_epoch = sync_min(sum(len(b) for b in parser) // ALS["batch"])
    parser.close()
    it = DeviceIter(create_parser(cfg["ratings"], rank, world, "libsvm",
                                  chunk_bytes=ALS["chunk_bytes"]),
                    num_col=als.device_num_col(), batch_size=ALS["batch"], layout="ell",
                    max_nnz=ALS["per_row"], drop_remainder=True, mesh=mesh,
                    shardings=als.batch_shardings())
    als_loss, als_nb = als.fit_epoch(it, max_steps=per_epoch)
    it.close()
    out["als"] = {"loss": als_loss, "batches": als_nb, "bits": _bits(als.params)}
    out["launches"] = {"k1": k1.launches, "dw": k1.dw_launches, "row_scatter": rs.launches}

    parser = create_parser(cfg["uneven"], rank, world, "libsvm", threaded=False)
    local = sum(len(b) for b in parser) // 64
    parser.close()
    cap = sync_min(local)
    dense = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, mesh=mesh)
    it = DeviceIter(create_parser(cfg["uneven"], rank, world, "libsvm"),
                    num_col=dense.device_num_col(), batch_size=64, drop_remainder=True,
                    mesh=mesh, shardings=dense.batch_shardings())
    _, nb = dense.fit_epoch(it, max_steps=cap)
    it.close()
    out["uneven"] = {"local": local, "cap": cap, "steps": nb}
    if rank == 0:
        torch.save({"linear": [p.detach().cpu() for p in model.params],
                    "fm": [p.detach().cpu() for p in fm.params],
                    "items": als.params.items.cpu()},
                   os.path.join(cfg["out"], "params.pt"))
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    exit_rank()


def write_uneven_corpus(path: str, rows: int, seed: int) -> None:
    """Long rows first (28 features), short ones after (2): byte-range
    shards hold unequal row counts."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            x = rng.normal(size=HIGGS_COLS)
            cols = range(HIGGS_COLS) if i < rows // 2 else (0, 1)
            f.write(f"{int(x[0] + x[1] > 0)} "
                    + " ".join(f"{j}:{x[j]:.6f}" for j in cols) + "\n")


def _world1_reference(cfg: dict, device) -> dict:
    """The card's one-process run on the pair's global batches (each the
    two ranks' batches concatenated in rank order): the linear and FM
    losses and parameters after 20 steps, and the ALS items after one
    epoch and its item solve."""
    import torch

    from dmlc_tpu_torch import AlsLearner, DeviceIter, FMLearner, LinearLearner, create_parser
    from dmlc_tpu_torch.ops.sparse import EllBatch

    def cat(parts):
        return [EllBatch(*(torch.cat(ts) for ts in zip(*group))) for group in zip(*parts)]

    world = PAR["ranks"]
    batches = cat([_first_batches(_par_ell(cfg["higgs"], None, r, world, device)[1],
                                  PAR["steps"]) for r in range(world)])
    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    losses = torch.stack([model.step(b) for b in batches])
    fm = FMLearner(HIGGS_COLS, num_factors=8, layout="ell", learning_rate=0.05, seed=0,
                   device=device)
    fm_losses = torch.stack([fm.step(b) for b in batches])
    parts = []
    for r in range(world):
        it = DeviceIter(create_parser(cfg["ratings"], r, world, "libsvm",
                                      chunk_bytes=ALS["chunk_bytes"]),
                        num_col=ALS["items"], batch_size=ALS["batch"], layout="ell",
                        max_nnz=ALS["per_row"], drop_remainder=True, device=device)
        parts.append([EllBatch(*(t.clone() for t in b)) for b in it])
        it.close()
    als = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                     seed=0, device=device)
    als_batches = cat(parts)
    for b in als_batches:
        als.step(b)
    als.finalize_items()
    return {"linear": (losses.cpu(), [p.detach().cpu() for p in model.params]),
            "fm": (fm_losses.cpu(), [p.detach().cpu() for p in fm.params]),
            "items": als.params.items.cpu(), "als_batches": len(als_batches)}


def _run_pair(cfg: dict, tmp: str, name: str):
    """Leg (b)'s two gloo ranks, once: their JSON records and their
    output directory."""
    from dmlc_tpu_torch.parallel.launch import run_local

    out = os.path.join(tmp, name)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "cfg.json")
    with open(path, "w") as f:
        json.dump({**cfg, "out": out}, f)
    run_local([sys.executable, os.path.abspath(__file__), "--parallel-child", "pair", path],
              PAR["ranks"], timeout=PAR["child_timeout"])
    return ([json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(PAR["ranks"])],
            out)


def run_parallel(path: str, ratings: str, tmp: str, device, seed: int) -> dict:
    """Phase 11: data parallelism through ``dmlc_tpu_torch.parallel``.
    (a) a process group of one NCCL rank in a child process; (b) two
    NCCL ranks tried on the one card (refusal or hang recorded), then two
    gloo ranks on it, twice, against the card's one-process run on the
    same global batches; (c) the dry-run entry point on the card. gloo
    stages its collectives through the host, so the spin check is leg
    (a)'s alone."""
    import torch

    from dmlc_tpu_torch.parallel.launch import run_local

    res = {}
    out = os.path.join(tmp, "world1.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--parallel-child",
                           "world1", path, out], capture_output=True, text=True,
                          timeout=PAR["child_timeout"])
    if proc.returncode != 0:
        raise AssertionError(f"parallel leg (a) failed: {proc.stderr[-3000:]}")
    a = json.load(open(out))
    fs1 = a.pop("fs_world1")
    emit(a)
    check_world1(a)
    res["world1"] = a
    emit({"phase": "fs_world1", **fs1})
    check_fs_world1(fs1)
    res["fs_world1"] = fs1


    nccl_dir = os.path.join(tmp, "nccl_pair")
    os.makedirs(nccl_dir, exist_ok=True)
    t0 = time.monotonic()
    try:
        runs = run_local([sys.executable, os.path.abspath(__file__), "--parallel-child",
                          "nccl_pair", nccl_dir], PAR["ranks"], timeout=PAR["nccl_timeout"],
                         check=False)
        failed = [r for r in runs if r.returncode != 0]
        nccl = {"outcome": "refused" if failed else "ran",
                "message": "" if not failed else failed[0].stderr.strip()[-600:]}
    except TimeoutError as exc:
        nccl = {"outcome": "hung", "message": str(exc)[-600:]}
    nccl["seconds"] = time.monotonic() - t0
    emit({"phase": "parallel_nccl_pair", **nccl})
    res["nccl_pair"] = nccl

    cfg = {"higgs": path, "ratings": ratings, "uneven": os.path.join(tmp, "uneven.libsvm"),
           "device": str(device)}
    write_uneven_corpus(cfg["uneven"], PAR["uneven_rows"], seed)
    t0 = time.monotonic()
    run1, out1 = _run_pair(cfg, tmp, "pair1")
    pair_s = time.monotonic() - t0
    run2, out2 = _run_pair(cfg, tmp, "pair2")
    rec = check_pair(run1, run2, _world1_reference(cfg, device), out1)
    rec["pair_run_s"] = pair_s
    emit(rec)
    res["pair"] = rec

    # (c) the port's dry-run entry point as a user calls it: on the card by
    # default; two ranks share this one card, so it names gloo
    from dmlc_tpu_torch.entry import dryrun_multichip

    t0 = time.monotonic()
    dry = dryrun_multichip(PAR["ranks"], timeout=PAR["child_timeout"])
    dry = {"phase": "parallel_dryrun", "ranks": PAR["ranks"], "backend": dry["backend"],
           "legs": dry["legs"], "first_loss": dry["trajectory"][0],
           "last_loss": dry["trajectory"][-1],
           "max_abs_diff_vs_single_process": float(np.max(np.abs(
               np.array(dry["trajectory"]) - np.array(dry["single_process"])))),
           "seconds": time.monotonic() - t0}
    emit(dry)
    if dry["backend"] != ("nccl" if torch.cuda.device_count() >= PAR["ranks"] else "gloo"):
        raise AssertionError(f"parallel leg (c): unexpected backend: {dry}")
    res["dryrun"] = dry
    return res


def check_world1(a: dict) -> None:
    """Leg (a)'s gates."""
    problems = []
    if not a["accuracy"] > 0.9:
        problems.append("accuracy <= 0.9")
    if (a["k1_launches"], a["dw_launches"]) != (a["k1_launches_needed"], a["dw_launches_needed"]):
        problems.append("K1 or dw launched other than once a margin / a step")
    if not (a["first_losses_bit_equal_to_plain"] and a["params_bit_equal_to_plain"]):
        problems.append("the world-1 mesh steps differ from the plain steps' bits")
    if not a["step_enqueue_behind_spin"]["no_host_sync"]:
        problems.append("a mesh step waited for the device")
    if problems:
        raise AssertionError(f"parallel leg (a): {problems}: {a}")


def check_pair(run1: list, run2: list, ref: dict, out1: str) -> dict:
    """Leg (b)'s record and gates: the pair's two runs against each other
    and against the one-process run ``ref``."""
    import torch

    got = torch.load(os.path.join(out1, "params.pt"))
    rec = {"phase": "parallel_pair", "backend": run1[0]["backend"], "ranks": PAR["ranks"],
           "gloo_one_card_global_rows_per_s": run1[0]["linear"]["global_rows_per_s"],
           "note": "gloo stages CUDA collectives through the host: rows/s is a gloo-on-"
                   "one-card figure, not a scaling number; no spin check here"}
    for leg in ("linear", "fm"):
        losses = np.array(run1[0][leg]["losses"])
        want, want_params = ref[leg]
        rec[f"{leg}_max_rel_diff_vs_world1"] = float(np.max(
            np.abs(losses - want.numpy()) / np.maximum(np.abs(want.numpy()), 1e-12)))
        rec[f"{leg}_params_max_abs_diff_vs_world1"] = max(
            float((g - w).abs().max()) for g, w in zip(got[leg], want_params))
        rec[f"{leg}_bits_equal_across_ranks"] = len({r[leg]["bits"] for r in run1}) == 1
        rec[f"{leg}_bits_equal_across_runs"] = (
            [r[leg]["bits"] for r in run1] == [r[leg]["bits"] for r in run2]
            and run1[0][leg]["losses"] == run2[0][leg]["losses"])
    items_diff = (got["items"] - ref["items"]).abs()
    rec["als_items_max_abs_diff_vs_world1"] = float(items_diff.max())
    rec["als_items_within_tol"] = bool((items_diff <= 1e-5 + 1e-4 * ref["items"].abs()).all())
    rec["als_batches"] = [r["als"]["batches"] for r in run1]
    rec["als_bits_equal_across_ranks_and_runs"] = len(
        {r["als"]["bits"] for r in run1 + run2}) == 1
    rec["uneven"] = [r["uneven"] for r in run1]
    rec["launches"] = {k: sum(r["launches"][k] for r in run1) for k in run1[0]["launches"]}
    problems = []
    for leg in ("linear", "fm"):
        if not (rec[f"{leg}_max_rel_diff_vs_world1"] <= 1e-5
                and rec[f"{leg}_params_max_abs_diff_vs_world1"] <= 1e-5):
            problems.append(f"{leg}: the pair differs from the one-process run")
        if not (rec[f"{leg}_bits_equal_across_ranks"] and rec[f"{leg}_bits_equal_across_runs"]):
            problems.append(f"{leg}: bits differ across ranks or runs")
    if not (rec["als_items_within_tol"] and rec["als_bits_equal_across_ranks_and_runs"]
            and rec["als_batches"] == [ref["als_batches"]] * PAR["ranks"]):
        problems.append("als: the pair's items differ from the one-process run's")
    locals_ = [u["local"] for u in rec["uneven"]]
    if not (len(set(locals_)) > 1
            and all(u["cap"] == u["steps"] == min(locals_) for u in rec["uneven"])):
        problems.append("sync_min did not cap the uneven shards' epochs")
    steps = PAR["steps"] * PAR["ranks"]
    if (rec["launches"]["k1"], rec["launches"]["dw"]) != (steps, steps):
        problems.append("K1 or dw launched other than once a step on each rank")
    if problems:
        emit(rec)
        raise AssertionError(f"parallel leg (b): {problems}: {rec}")
    return rec


# ---------------- phase 11 (feature sharding): LinearLearner(model_axis=) ----------------

FS = {"model": 2, "steps": 20, "ranks": 2, "dry_ranks": 4, "child_timeout": 600,
      "kdd_lr": 0.1, "als_epochs": 2}
FS_HIGGS_LEGS = {  # leg: (layout, learner kwargs), each with model_axis="model"
    "dense_logistic": ("dense", {}),
    "ell_logistic": ("ell", {}),
    "ell_softmax": ("ell", {"objective": "softmax", "num_class": 2}),
}
FS_WINDOW_SHAPES = [  # (name, B, K, W): the table split in FS["model"] windows
    ("higgs_w30", BATCH, HIGGS_COLS, 30),       # weight_dim 30 at model 2: 15 words a rank
    # phase 13's KDD-shaped rows (KDD_FIELDS = 10 ids) over its 50,000,000
    # ids: weight_dim 50,000,002 at model 2, 25,000,001 words a rank
    ("kdd_w50m", BATCH, 10, 50_000_002),
]


def fs_world1(mesh, ell_batches: list, dense_batches: list) -> dict:
    """Phase 11 (b), on the world-1 NCCL group: ``{"data": 1, "model": 1}``
    with ``model_axis="model"``. 20 HIGGS ELL and dense steps bit-identical
    to the plain learner's on the same batches (the windowed kernels at lo =
    0; an axis of one rank issues no collective), their windowed K1 and
    ``dw`` launches counted, and 20 sharded steps enqueued behind a device
    spin in groups of 10."""
    import torch

    from dmlc_tpu_torch import LinearLearner
    from dmlc_tpu_torch.ops import ell_matvec as k1

    rec = {"mesh": mesh.shape}
    for layout, batches in (("ell", ell_batches), ("dense", dense_batches)):
        plain = LinearLearner(HIGGS_COLS, layout=layout, learning_rate=0.3, device=mesh.device)
        sharded = LinearLearner(HIGGS_COLS, layout=layout, learning_rate=0.3, mesh=mesh,
                                model_axis="model")
        plain_losses = torch.stack([plain.step(b) for b in batches])
        k1.launches = k1.dw_launches = 0
        sharded_losses = torch.stack([sharded.step(b) for b in batches])
        launches = {"k1": k1.launches, "dw": k1.dw_launches}
        rec[layout] = {
            "steps": len(batches), "launches": launches,
            "losses_bit_equal_to_plain": torch.equal(plain_losses, sharded_losses),
            "params_bit_equal_to_plain": all(torch.equal(p, q) for p, q in
                                             zip(plain.params, sharded.params)),
            "step_enqueue_behind_spin": enqueue_behind_spin(
                lambda: sharded.step(batches[0]), group=10)}
    return rec


def check_fs_world1(rec: dict) -> None:
    problems = []
    for layout, want in (("ell", FS["steps"]), ("dense", 0)):
        r = rec[layout]
        if not (r["losses_bit_equal_to_plain"] and r["params_bit_equal_to_plain"]):
            problems.append(f"{layout}: the sharded steps differ from the plain steps' bits")
        if not r["step_enqueue_behind_spin"]["no_host_sync"]:
            problems.append(f"{layout}: a sharded step waited for the device")
        if (r["launches"]["k1"], r["launches"]["dw"]) != (want, want):
            problems.append(f"{layout}: K1 / dw launched {r['launches']}, {want} each needed")
    if problems:
        raise AssertionError(f"feature sharding (b): {problems}: {rec}")


def fs_kernel_gate(seed: int, k1_main: dict, dev) -> dict:
    """Phase 11 (a): K1 and its ``dw`` on a shard window against their
    plain versions on the card, at each ``FS_WINDOW_SHAPES`` table split in
    ``FS["model"]`` windows: values within K1's tolerance, the windows'
    partials summing to the whole table's margin, ``dw`` within 1e-4 + 1e-5
    of each word's absolute sum of the plain windowed version and of the
    whole table's ``dw`` over the window, bit-identical over two launches
    on the kernel's route; device times beside the plain versions' and the
    bounds. K1's unsharded time at the main path's shape (phase 2's, with
    ``--parent`` beside its parent's in turns) is reported beside them."""
    import torch

    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops.sparse import EllBatch, ell_matvec, window_slots

    rows, err, dw_err = [], 0.0, 0.0
    for i, (name, b, k, w) in enumerate(FS_WINDOW_SHAPES):
        table, idx, val = k1_inputs(b, k, w, seed + 300 + i, dev)
        batch = EllBatch(idx, val, None, None)
        g = torch.randn(b, generator=torch.Generator(device=dev).manual_seed(seed + 400 + i),
                        device=dev)
        whole = ell_matvec(table, batch)
        dw_whole = k1.ell_matvec_grads(table, idx, val, g, need_dval=False)[0]
        width = w // FS["model"]
        partial_sum = torch.zeros_like(whole)
        for m in range(FS["model"]):
            lo = m * width
            shard = table[lo:lo + width].contiguous()
            out = k1.ell_matvec_cuda(shard, idx, val, lo)
            again = k1.ell_matvec_cuda(shard, idx, val, lo)
            ref = ell_matvec(shard, batch, lo=lo)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, rtol=K1_RTOL, atol=K1_ATOL)
            partial_sum += out
            route = k1.dw_route(width)

            def dw_plain_fn():
                return k1.ell_matvec_grads(shard, idx, val, g, need_dval=False, lo=lo)[0]

            if route == "cuda":
                def dw_fn():
                    return k1.ell_matvec_dw_cuda(idx, val, g, width, lo)
            else:
                dw_fn = dw_plain_fn
            dw, dw_again, dw_plain = dw_fn(), dw_fn(), dw_plain_fn()
            # each word's absolute sum: the same gradient of |val| and |g|
            scale = k1.ell_matvec_grads(shard, idx, val.abs(), g.abs(), need_dval=False,
                                        lo=lo)[0]
            tol = K1_ATOL + K1_RTOL * scale
            diff = torch.maximum((dw - dw_plain).abs(), (dw - dw_whole[lo:lo + width]).abs())
            repeatable = torch.equal(out, again) and torch.equal(dw, dw_again)
            if bool((diff > tol).any()) or (route == "cuda" and not repeatable):
                raise AssertionError(f"windowed dw {name} [{lo}, {lo + width}): differs by up "
                                     f"to {float(diff.max())}, repeatable {repeatable}")
            local, _, keep = window_slots(idx, val, lo, width)
            touched = int(torch.unique(local[keep]).numel())
            slots = int(keep.sum())
            bound_ms, bound_by = bound(b * k * 8 + b * 4 + touched * 4, 2 * slots)
            dw_bound, dw_bound_by = bound(b * k * 8 + b * 4 + width * 4, 2 * slots)
            row = {"phase": "fs_kernel", "shape": name, "B": b, "K": k, "W": w,
                   "window": [lo, width], "in_window_slots": slots,
                   "max_abs_err": float((out - ref).abs().max()),
                   "dw_route": route, "dw_max_abs_err": float(diff.max()),
                   "repeatable": repeatable,
                   "ms": device_ms(lambda: k1.ell_matvec_cuda(shard, idx, val, lo)),
                   "plain_ms": device_ms(lambda: ell_matvec(shard, batch, lo=lo)),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "dw_ms": device_ms(dw_fn), "dw_plain_ms": device_ms(dw_plain_fn),
                   "dw_bound_ms": dw_bound, "dw_bound_by": dw_bound_by}
            emit(row)
            rows.append(row)
            err = max(err, row["max_abs_err"])
            if route == "cuda":
                dw_err = max(dw_err, row["dw_max_abs_err"])
        torch.testing.assert_close(partial_sum, whole, rtol=K1_RTOL, atol=K1_ATOL)
        del table, dw_whole
    unsharded = {"phase": "fs_kernel_unsharded", "shape": K1_SHAPES[0][0],
                 "ms": k1_main["ms"], "parent_ms_runs": k1_main.get("parent_ms_runs"),
                 "change_ms_runs": k1_main.get("change_ms_runs"),
                 "bits_equal_to_parent": k1_main.get("bits_equal_to_parent")}
    if unsharded["parent_ms_runs"]:
        unsharded["change_over_parent"] = (statistics.median(unsharded["change_ms_runs"])
                                           / statistics.median(unsharded["parent_ms_runs"]))
        unsharded["within_5pct"] = unsharded["change_over_parent"] <= 1.05
    emit(unsharded)
    return {"rows": rows, "max_abs_err": err, "dw_max_abs_err": dw_err}


def _fs_pipeline(path: str, mesh, layout: str, kw: dict, num_col: int, max_nnz, lr: float,
                 uri_suffix: str = "", device=None):
    """(learner, DeviceIter) on the data rank's part of ``path``: with a
    mesh, feature-sharded over its model axis; without one, the one-process
    learner on ``device``."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    part, parts = (mesh.coords["data"], mesh.shape["data"]) if mesh is not None else (0, 1)
    model = LinearLearner(num_col, layout=layout, learning_rate=lr, mesh=mesh,
                          model_axis="model" if mesh is not None else None, device=device, **kw)
    it = DeviceIter(create_parser(path + uri_suffix, part, parts,
                                  "auto" if uri_suffix else "libsvm"),
                    num_col=model.device_num_col(), batch_size=BATCH, layout=layout,
                    max_nnz=max_nnz, pack_aux=False if layout == "dense" else None,
                    drop_remainder=True, mesh=mesh, shardings=model.batch_shardings(),
                    device=device)
    return model, it


def _fs_steps(model, it, steps: int):
    """``steps`` steps straight from the iterator (closed after), each on
    the host clock between two synchronisations (a gloo step's all-reduces
    in it): the losses and the median step in ms."""
    import torch

    losses, secs = [], []
    for _, b in zip(range(steps), it):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(model.step(b))
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
    it.close()
    if len(losses) != steps:
        raise AssertionError(f"{len(losses)} batches, {steps} needed")
    return [float(x) for x in losses], 1e3 * statistics.median(secs)


def _fs_als(path: str, device, mesh=None) -> dict:
    """Phase 11 (f)'s ALS at phase 9's size, ``FS["als_epochs"]`` epochs
    with the item solve: on ``mesh`` replicated over its model axis, else
    the one-process run."""
    from dmlc_tpu_torch import AlsLearner, DeviceIter, create_parser
    from dmlc_tpu_torch.ops import row_scatter as rs

    als = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                     seed=0, mesh=mesh, device=None if mesh is not None else device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", chunk_bytes=ALS["chunk_bytes"]),
                    num_col=als.device_num_col(), batch_size=ALS["batch"], layout="ell",
                    max_nnz=ALS["per_row"], drop_remainder=True, mesh=mesh,
                    shardings=als.batch_shardings(),
                    device=None if mesh is not None else device)
    rs.launches = 0
    epochs = [als.fit_epoch(it) for _ in range(FS["als_epochs"])]
    it.close()
    return {"losses": [loss for loss, _ in epochs], "batches": [nb for _, nb in epochs],
            "row_scatter": rs.launches, "bits": _bits(als.params)}


def fs_pair_child(cfg_path: str) -> None:
    """Phase 11 (c), (d) and (f): one of two gloo ranks sharing the card on
    ``{"data": 1, "model": 2}`` (NCCL takes one card a rank). (c) phase 3's
    corpus through ``create_parser`` -> ``DeviceIter(mesh=, shardings=)``
    -> ``LinearLearner(model_axis="model")``, dense and ELL logistic and
    ELL softmax, 20 steps each, the table all-gathered; (d) phase 13's
    KDD-shaped libfm on its 50,000,002-word table, 25,000,001 words a rank,
    ELL logistic, SGD 0.1, 20 steps; (f) ALS at phase 9's size for 2 epochs,
    replicated over the model axis. Windowed K1 and ``dw`` launches counted
    around each leg's steps."""
    from datetime import timedelta

    import torch

    from dmlc_tpu_torch import convert
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.parallel import host_shard_info, init_from_env, make_mesh
    from dmlc_tpu_torch.parallel.distributed import exit_rank

    cfg = json.load(open(cfg_path))
    init_from_env(backend="gloo", device=cfg["device"], timeout=timedelta(seconds=300))
    mesh = make_mesh({"data": 1, "model": FS["model"]}, devices=cfg["device"])
    rank, _ = host_shard_info()
    out = {"rank": rank, "coords": mesh.coords, "backend": torch.distributed.get_backend(),
           "higgs": {}}
    for leg, (layout, kw) in FS_HIGGS_LEGS.items():
        model, it = _fs_pipeline(cfg["higgs"], mesh, layout, kw, HIGGS_COLS,
                                 HIGGS_COLS if layout == "ell" else None, 0.3)
        k1.launches = k1.dw_launches = 0
        losses, step_ms = _fs_steps(model, it, FS["steps"])
        launches = {"k1": k1.launches, "dw": k1.dw_launches}
        weight, bias = convert.linear_params_gather_to_jax(model.params, mesh, "model")
        out["higgs"][leg] = {"losses": losses, "launches": launches, "step_ms": step_ms,
                             "shard": [model.shard_lo, model.shard_width],
                             "bytes_to_device": it.bytes_to_device,
                             "bits": _bits([torch.from_numpy(weight), torch.from_numpy(bias)])}
        if rank == 0:
            np.savez(os.path.join(cfg["out"], f"higgs_{leg}.npz"), weight=weight, bias=bias)
    model, it = _fs_pipeline(cfg["kdd"], mesh, "ell", {}, KDD_COLS, KDD_FIELDS, FS["kdd_lr"],
                             uri_suffix="?format=libfm")
    k1.launches = k1.dw_launches = 0
    losses, step_ms = _fs_steps(model, it, FS["steps"])
    out["kdd"] = {"losses": losses, "launches": {"k1": k1.launches, "dw": k1.dw_launches},
                  "step_ms": step_ms, "weight_dim": model.weight_dim,
                  "shard": [model.shard_lo, model.shard_width],
                  "shard_bytes": model.params.weight.numel() * 4}
    del model
    torch.cuda.empty_cache()
    out["als"] = _fs_als(cfg["ratings"], None, mesh)
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    exit_rank()


def _fs_reference(cfg: dict, device) -> dict:
    """The card's one-process runs on the pair's batches (the data axis is
    one rank, so the pair's ranks read what one process reads): each HIGGS
    leg, the KDD-shaped table and ALS."""
    import torch

    from dmlc_tpu_torch import convert

    ref = {"higgs": {}}
    for leg, (layout, kw) in FS_HIGGS_LEGS.items():
        model, it = _fs_pipeline(cfg["higgs"], None, layout, kw, HIGGS_COLS,
                                 HIGGS_COLS if layout == "ell" else None, 0.3, device=device)
        losses, step_ms = _fs_steps(model, it, FS["steps"])
        weight, bias = convert.linear_params_to_jax(model.params)
        ref["higgs"][leg] = {"losses": losses, "weight": weight, "bias": bias,
                             "step_ms": step_ms}
    model, it = _fs_pipeline(cfg["kdd"], None, "ell", {}, KDD_COLS, KDD_FIELDS, FS["kdd_lr"],
                             uri_suffix="?format=libfm", device=device)
    losses, step_ms = _fs_steps(model, it, FS["steps"])
    ref["kdd"] = {"losses": losses, "step_ms": step_ms,
                  "table_bytes": model.params.weight.numel() * 4}
    del model
    torch.cuda.empty_cache()
    ref["als"] = _fs_als(cfg["ratings"], device)
    return ref


def _rel_diff(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12)))


def check_fs_pair(ranks: list, ref: dict, out_dir: str) -> dict:
    """Phase 11 (c), (d), (f)'s record and gates against the one-process
    runs ``ref``."""
    rec = {"phase": "fs_pair", "backend": ranks[0]["backend"], "mesh": {"data": 1,
                                                                        "model": FS["model"]},
           "higgs": {}, "note": "gloo stages CUDA collectives through the host: the step "
                                "times are gloo-on-one-card figures"}
    problems = []
    for leg, (layout, _) in FS_HIGGS_LEGS.items():
        runs = [r["higgs"][leg] for r in ranks]
        want = ref["higgs"][leg]
        got = np.load(os.path.join(out_dir, f"higgs_{leg}.npz"))
        real = HIGGS_COLS  # words past the features: a spare one (0) and the sink
        r = {"loss_max_rel_diff": _rel_diff(runs[0]["losses"], want["losses"]),
             "table_max_abs_diff": float(np.max(np.abs(got["weight"][:real]
                                                       - want["weight"][:real]))),
             "bias_max_abs_diff": float(np.max(np.abs(got["bias"] - want["bias"]))),
             "words_past_features_zero": bool(np.all(got["weight"][real:] == 0.0)),
             "losses_equal_across_ranks": all(x["losses"] == runs[0]["losses"] for x in runs),
             "table_bits_equal_across_ranks": len({x["bits"] for x in runs}) == 1,
             "launches": [x["launches"] for x in runs], "shards": [x["shard"] for x in runs],
             "bytes_to_device": [x["bytes_to_device"] for x in runs],
             "step_ms": [x["step_ms"] for x in runs], "one_process_step_ms": want["step_ms"]}
        rec["higgs"][leg] = r
        if not (r["loss_max_rel_diff"] <= 1e-5 and r["table_max_abs_diff"] <= 1e-5
                and r["bias_max_abs_diff"] <= 1e-5 and r["words_past_features_zero"]):
            problems.append(f"{leg}: differs from the one-process learner")
        if not (r["losses_equal_across_ranks"] and r["table_bits_equal_across_ranks"]):
            problems.append(f"{leg}: the ranks disagree")
        need = FS["steps"] if leg == "ell_logistic" else 0  # softmax: the plain masked gather
        if any((x["k1"], x["dw"]) != (need, need) for x in r["launches"]):
            problems.append(f"{leg}: windowed K1 / dw launched {r['launches']}, {need} needed")
    kdd = [r["kdd"] for r in ranks]
    rec["kdd"] = {"loss_max_rel_diff": _rel_diff(kdd[0]["losses"], ref["kdd"]["losses"]),
                  "losses_equal_across_ranks": all(x["losses"] == kdd[0]["losses"]
                                                   for x in kdd),
                  "first_loss": kdd[0]["losses"][0], "last_loss": kdd[0]["losses"][-1],
                  "weight_dim": kdd[0]["weight_dim"], "shards": [x["shard"] for x in kdd],
                  "shard_bytes": [x["shard_bytes"] for x in kdd],
                  "one_process_table_bytes": ref["kdd"]["table_bytes"],
                  "step_ms": [x["step_ms"] for x in kdd],
                  "one_process_step_ms": ref["kdd"]["step_ms"],
                  "launches": [x["launches"] for x in kdd]}
    if not (rec["kdd"]["loss_max_rel_diff"] <= 1e-4
            and rec["kdd"]["losses_equal_across_ranks"]):
        problems.append("kdd: the sharded losses differ from the one-process learner's")
    if any(x["launches"]["k1"] != FS["steps"] for x in kdd):
        problems.append(f"kdd: windowed K1 launched {rec['kdd']['launches']}")
    als = [r["als"] for r in ranks]
    rec["als"] = {"losses": als[0]["losses"], "batches": als[0]["batches"],
                  "bits_equal_to_one_process": all(x["bits"] == ref["als"]["bits"]
                                                   for x in als),
                  "row_scatter": [x["row_scatter"] for x in als]}
    if not rec["als"]["bits_equal_to_one_process"]:
        problems.append("als: the replicated tables differ from the one-process run's bits")
    if problems:
        emit(rec)
        raise AssertionError(f"feature sharding: {problems}")
    return rec


def run_feature_sharding(path: str, ratings: str, kdd: str, tmp: str, device, seed: int,
                         k1_main: dict, world1: dict) -> dict:
    """Phase 11's feature sharding (``LinearLearner(model_axis=)``): (a)
    the windowed kernels against their plain versions; (b) the world-1
    NCCL leg, run by phase 11's world-1 child (``world1``); (c), (d) and (f)
    in one spawn of two gloo ranks on ``{"data": 1, "model": 2}``
    (``fs_pair_child``) against the card's one-process runs on the same
    batches; (e) the dry run at four ranks, ``{"data": 2, "model": 2}``."""
    from dmlc_tpu_torch.entry import dryrun_multichip
    from dmlc_tpu_torch.parallel.launch import run_local

    t0 = time.monotonic()
    res = {"kernels": fs_kernel_gate(seed, k1_main, device), "world1": world1}
    out = os.path.join(tmp, "fs_pair")
    os.makedirs(out, exist_ok=True)
    cfg = {"higgs": path, "kdd": kdd, "ratings": ratings, "device": str(device), "out": out}
    cfg_path = os.path.join(out, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    t1 = time.monotonic()
    run_local([sys.executable, os.path.abspath(__file__), "--parallel-child", "fs_pair",
               cfg_path], FS["ranks"], timeout=FS["child_timeout"])
    pair_s = time.monotonic() - t1
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(FS["ranks"])]
    pair = check_fs_pair(ranks, _fs_reference(cfg, device), out)
    pair["pair_spawn_s"] = pair_s
    emit(pair)
    res["pair"] = pair
    t1 = time.monotonic()
    dry = dryrun_multichip(FS["dry_ranks"], timeout=FS["child_timeout"])
    dry = {"phase": "fs_dryrun", "ranks": FS["dry_ranks"], "mesh": dry["mesh"],
           "backend": dry["backend"], "legs": dry["legs"],
           "first_loss": dry["trajectory"][0], "last_loss": dry["trajectory"][-1],
           "max_abs_diff_vs_single_process": float(np.max(np.abs(
               np.array(dry["trajectory"]) - np.array(dry["single_process"])))),
           "seconds": time.monotonic() - t1}
    emit(dry)
    if dry["mesh"] != {"data": FS["dry_ranks"] // 2, "model": 2}:
        raise AssertionError(f"feature sharding (e): the dry run's mesh: {dry}")
    res["dryrun"] = dry
    res["launches"] = {
        "k1": world1["ell"]["launches"]["k1"]
        + sum(v["k1"] for leg in pair["higgs"].values() for v in leg["launches"])
        + sum(x["k1"] for x in pair["kdd"]["launches"]),
        "dw": world1["ell"]["launches"]["dw"]
        + sum(v["dw"] for leg in pair["higgs"].values() for v in leg["launches"])
        + sum(x["dw"] for x in pair["kdd"]["launches"]),
        "row_scatter": sum(pair["als"]["row_scatter"])}
    emit({"phase": "fs_total", "wall_s": time.monotonic() - t0, "launches": res["launches"]})
    return res


def parallel_child(argv: list) -> int:
    """``chip_smoke.py --parallel-child KIND ARGS...``: one process of
    phase 11."""
    kind = argv[0]
    if kind == "world1":
        parallel_world1_child(*argv[1:])
    elif kind == "nccl_pair":
        parallel_nccl_pair_child(*argv[1:])
    elif kind == "fs_pair":
        fs_pair_child(*argv[1:])
    elif kind == "pod":
        pod_child(*argv[1:])
    elif kind == "faults_env":
        faults_env_child(*argv[1:])
    else:
        parallel_pair_child(*argv[1:])
    return 0


# ---------------- phase 12: the block cache and the epoch planner ----------------

BC = {"batch": BATCH, "seed": 1, "window": 4096, "ckpt_at": CKPT_AT, "snap_seed": 2}


def _plan_recorder(src, out: list):
    """Wrap ``src.next_block`` (the DeviceIter's producer calls it) to
    record ``(plan epoch, the block's first label)`` of each served block."""
    inner = src.next_block

    def next_block():
        block = inner()
        if block is not None:
            out.append((src.plan_state["epoch"], float(block.label[0])))
        return block

    src.next_block = next_block


def _base_bytes(src) -> int:
    """The source bytes the block cache's parser chain has read (0 before
    a cold pass built it)."""
    return src._base.bytes_read if src._base is not None else 0


def run_block_cache_als(tmp: str, device) -> dict:
    """Phase 12 (a): ``dmlc_tpu_torch.examples.train_als``'s local leg at
    its full size. First ``main([])`` as a user runs it (the row scatter's
    launches counted from 0 around it, its lines checked); then the same
    pieces (``synthesize``, ``_build``, ``restore_check``) with each epoch's
    cache state, plan epoch, ``cache_read`` delta and source bytes, and
    each warm epoch's block order held against ``EpochPlan(0, epoch, n)``;
    20 warm steps run twice, bit for bit; the spin check in groups of 10."""
    import contextlib
    import io

    import torch

    from dmlc_tpu_torch.data.epoch import EpochPlan
    from dmlc_tpu_torch.examples import train_als
    from dmlc_tpu_torch.io.block_cache import BlockCacheReader
    from dmlc_tpu_torch.ops import row_scatter as rs
    from dmlc_tpu_torch.ops.sparse import EllBatch
    from dmlc_tpu_torch.parallel import make_mesh

    cfg = train_als.config(dryrun=False, world=1)
    out_buf = io.StringIO()
    rs.launches = 0
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out_buf):
        train_als.main([])
    main_s = time.monotonic() - t0
    launches = rs.launches
    lines = out_buf.getvalue().splitlines()
    epoch_len = cfg["users"] // cfg["batch"]
    # steps of the main run: its fit, its eval pass (no scatter),
    # restore_check's two pipelines and the service leg's
    need = als_main_steps(cfg)

    path = os.path.join(tmp, "als_bc.libsvm")
    cache = os.path.join(tmp, "als.blockcache")
    train_als.synthesize(path, cfg["users"], cfg["items"], cfg["per_row"])
    mesh = make_mesh()
    model, it = train_als._build(path, cache, cfg, mesh)
    src = it.source
    served: list = []
    _plan_recorder(src, served)
    epochs = []
    prev = {"cache_read": 0.0, "base_bytes": 0}

    def log(epoch, loss, nb, secs):
        st = it.stats()
        now = {"cache_read": src.stage_seconds()["cache_read"], "base_bytes": _base_bytes(src)}
        epochs.append({"epoch": epoch, "loss": loss, "batches": nb, "wall_s": secs,
                       "rows_per_s": nb * cfg["batch"] / secs,
                       "cache_state": st["cache_state"], "plan_epoch": st["epoch"],
                       "shuffle_seed": st["shuffle_seed"],
                       "input_wait_s": st["input_wait_seconds"],
                       "cache_read_s": now["cache_read"] - prev["cache_read"],
                       "source_bytes": now["base_bytes"] - prev["base_bytes"]})
        prev.update(now)

    model.fit(it, epochs=cfg["epochs"], log_fn=log)
    mse = model.eval_loss(it)
    it.close()
    reader = BlockCacheReader(cache)
    first_labels = [float(reader.load_segments(i)["label"][0]) for i in range(reader.num_blocks)]
    num_blocks = reader.num_blocks
    reader.close()
    orders_ok = True
    for e in epochs[1:]:
        got = [lab for ep, lab in served if ep == e["epoch"]]
        want = [first_labels[i] for i in EpochPlan(0, e["epoch"], num_blocks).order]
        orders_ok &= got == want
    restore_steps = train_als.restore_check(path, cache, cfg, mesh)

    def warm_steps(n: int = 20):
        m, feed = train_als._build(path, cache, cfg, mesh)
        losses = []
        while len(losses) < n:
            for batch in feed:
                losses.append(m.step(batch))
                if len(losses) == n:
                    break
            else:
                m.finalize_items()
                feed.reset()
        feed.close()
        return torch.stack(losses).cpu().numpy(), m.state_dict()

    la, sa = warm_steps()
    lb, sb = warm_steps()
    repeatable = la.tobytes() == lb.tobytes() and _state_bits(sa) == _state_bits(sb)
    m, feed = train_als._build(path, cache, cfg, mesh)
    batch = EllBatch(*(t.clone() for t in next(iter(feed))))
    feed.close()
    m.step(batch)
    torch.cuda.synchronize()
    spin = enqueue_behind_spin(lambda: m.step(batch), group=10)
    out = {"phase": "block_cache_als", "main_s": main_s, "main_lines": lines,
           "row_scatter_launches": launches, "row_scatter_launches_needed": need,
           "epochs": epochs, "eval_mse": mse, "num_blocks": num_blocks,
           "warm_orders_equal_plan": orders_ok, "restore_steps": restore_steps,
           "warm_steps_bit_identical_twice": repeatable, "step_enqueue_behind_spin": spin,
           "reduced": "none: examples/train_als.py's full run"}
    emit(out)
    losses = [e["loss"] for e in epochs]
    problems = []
    if not (lines[-1] == "OK" and f"checkpoint/restore byte-identical over "
            f"{epoch_len - cfg['restore_at']} steps" in lines):
        problems.append("the example's main() did not print its restore line and OK")
    if launches != need:
        problems.append("the row scatter did not launch once a step")
    if not (all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:]))):
        problems.append("the epoch losses are not finite and falling")
    for e in epochs:
        warm = e["epoch"] > 0
        if (e["cache_state"] != ("warm" if warm else "cold") or e["plan_epoch"] != e["epoch"]
                or e["shuffle_seed"] != 0
                or (warm and not (e["cache_read_s"] > 0 and e["source_bytes"] == 0))):
            problems.append(f"epoch {e['epoch']}: cache state, plan or reads wrong")
    if not orders_ok:
        problems.append("a warm epoch's block order is not EpochPlan(0, epoch, n).order")
    if restore_steps != epoch_len - cfg["restore_at"]:
        problems.append("restore_check compared the wrong number of steps")
    if not repeatable:
        problems.append("20 warm steps run twice differ")
    if not spin["no_host_sync"]:
        problems.append("a step waited for the device")
    if problems:
        raise AssertionError(f"block_cache_als: {problems}: {out}")
    return out


def _bc_pipeline(path: str, cache: str, device, **kw):
    """(parser, learner, DeviceIter) of the HIGGS main path over the planned
    block cache, fresh."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    opts = dict(shuffle_seed=BC["seed"], shuffle_window=BC["window"])
    opts.update(kw)
    parser = create_parser(path, 0, 1, "libsvm", block_cache=cache, **opts)
    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device)
    return parser, model, it


def _values_key(values) -> bytes:
    """A block's identity whatever its row order: its sorted values."""
    return np.sort(np.asarray(values)).tobytes()


def run_block_cache_higgs(path: str, tmp: str, device) -> dict:
    """Phase 12 (b): the HIGGS main path over the planned block cache
    (``shuffle_seed=1``, ``shuffle_window=4096``): a cold and two warm
    epochs and an accuracy pass with K1's and ``dw``'s launches counted
    from 0, each epoch's rows/s, stall share, ``cache_read`` and convert
    seconds and source bytes; the first 20 warm steps run twice; a
    checkpoint after 37 batches of warm epoch 1 resumed in a fresh
    pipeline; a byte flipped in a block healed once with the stream
    unchanged; two hosts' shards disjoint with the epoch as their union."""
    import torch

    from dmlc_tpu_torch import create_parser
    from dmlc_tpu_torch.convert import linear_params_from_jax, linear_params_to_jax
    from dmlc_tpu_torch.io import resilience
    from dmlc_tpu_torch.io.block_cache import BlockCacheReader
    from dmlc_tpu_torch.ops import ell_matvec as k1

    cache = os.path.join(tmp, "higgs.blockcache")
    parser, model, it = _bc_pipeline(path, cache, device)
    epochs = []
    keys = ("stall_seconds", "convert_seconds")
    prev = {"stall_seconds": 0.0, "convert_seconds": 0.0, "cache_read": 0.0, "base_bytes": 0}

    def log(epoch, loss, nb, secs):
        st = it.stats()
        now = {k: st[k] for k in keys}
        now.update(cache_read=parser.stage_seconds()["cache_read"], base_bytes=_base_bytes(parser))
        d = {k: now[k] - prev[k] for k in now}
        prev.update(now)
        rec = {"phase": "block_cache_higgs", "epoch": epoch, "loss": loss, "batches": nb,
               "wall_s": secs, "rows_per_s": nb * BATCH / secs,
               "stall_share": d["stall_seconds"] / secs, "cache_state": st["cache_state"],
               "plan_epoch": st["epoch"], "cache_read_s": d["cache_read"],
               "convert_s": d["convert_seconds"], "source_bytes": d["base_bytes"],
               "input_wait_s": st["input_wait_seconds"]}
        emit(rec)
        epochs.append(rec)

    k1.launches = k1.dw_launches = 0
    model.fit(it, epochs=3, log_fn=log)
    acc = model.accuracy(it)
    launches, dw_launches = k1.launches, k1.dw_launches
    it.close()
    steps = sum(e["batches"] for e in epochs)
    acc_batches = HIGGS_ROWS // BATCH
    cache_bytes = os.path.getsize(cache)

    def first_steps(n: int = 20):
        _, m, feed = _bc_pipeline(path, cache, device)
        losses = [m.step(b) for _, b in zip(range(n), feed)]
        feed.close()
        return torch.stack(losses), m.params.weight.detach().clone()

    la, wa = first_steps()
    lb, wb = first_steps()
    repeatable = same_bits(la, lb) and same_bits(wa, wb)

    # a checkpoint after CKPT_AT batches of warm epoch 1, resumed fresh
    _, m, feed = _bc_pipeline(path, cache, device)
    for b in feed:
        m.step(b)
    feed.reset()
    state = params = None
    for i, b in enumerate(feed):
        m.step(b)
        if i + 1 == BC["ckpt_at"]:
            state = json.loads(json.dumps(feed.state_dict()))
            params = linear_params_to_jax(m.params)
    feed.close()
    _, m2, feed = _bc_pipeline(path, cache, device, shuffle_seed=None, shuffle_window=0)
    m2.set_params(linear_params_from_jax(*params, device=device))
    feed.load_state(state)
    rest = 0
    for b in feed:
        m2.step(b)
        rest += 1
    feed.close()
    resumed = bool(torch.equal(m.params.weight, m2.params.weight)
                   and torch.equal(m.params.bias, m2.params.bias))

    # a flipped byte heals once, the stream unchanged
    def epoch_batches():
        _, _, feed = _bc_pipeline(path, cache, device)
        out = [[t.clone() for t in b] for b in feed]
        feed.close()
        return out

    clean = epoch_batches()
    reader = BlockCacheReader(cache)
    pos = int(reader._blocks[reader.num_blocks // 2]["pos"]) + 100
    reader.close()
    with open(cache, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x01]))
    base = resilience.counters_snapshot()
    healed = epoch_batches()
    events = resilience.counters_delta(base)
    heal_equal = len(healed) == len(clean) and all(
        all(same_bits(x, y) for x, y in zip(a, b)) for a, b in zip(healed, clean))
    del clean, healed

    # two hosts' shards of the warm epoch
    reader = BlockCacheReader(cache)
    whole = sorted(_values_key(reader.load_segments(i)["value"])
                   for i in range(reader.num_blocks))
    reader.close()
    shards = []
    for host in range(2):
        p = create_parser(path, 0, 1, "libsvm", block_cache=cache, shuffle_seed=BC["seed"],
                          shuffle_window=BC["window"], pod_sharding=(host, 2))
        shards.append([_values_key(b.value) for b in p])
        p.close()
    flat = shards[0] + shards[1]
    shards_ok = len(set(flat)) == len(flat) and sorted(flat) == whole

    out = {"phase": "block_cache_higgs", "accuracy": acc, "steps": steps,
           "k1_launches": launches, "k1_launches_needed": steps + acc_batches,
           "dw_launches": dw_launches, "dw_launches_needed": steps,
           "cache_bytes": cache_bytes, "first_warm_steps_bit_identical_twice": repeatable,
           "checkpoint_batches_after_restore": rest, "checkpoint_weights_equal": resumed,
           "checkpoint_state_source": state["source"], "heal_events": events,
           "heal_stream_equal": heal_equal, "shard_blocks": [len(s) for s in shards],
           "shards_disjoint_union_is_epoch": shards_ok,
           "reduced": "HIGGS (UCI 280) 11,000,000 rows cut to 1,048,576 for the time limit"}
    emit(out)
    problems = []
    if not acc > 0.9:
        problems.append(f"accuracy {acc} <= 0.9")
    if launches != steps + acc_batches or dw_launches != steps:
        problems.append("K1 or dw launch counts differ from the steps")
    for e in epochs:
        warm = e["epoch"] > 0
        if (e["cache_state"] != ("warm" if warm else "cold") or e["plan_epoch"] != e["epoch"]
                or (warm and not (e["source_bytes"] == 0 and e["cache_read_s"] > 0
                                  and e["convert_s"] > 0))):
            problems.append(f"epoch {e['epoch']}: cache state, plan or reads wrong")
    if not repeatable:
        problems.append("the first 20 warm steps run twice differ")
    if not (resumed and rest == HIGGS_ROWS // BATCH - BC["ckpt_at"]
            and state["kind"] == "source" and state["source"]["kind"] == "epoch_plan"
            and state["source"]["epoch"] == 1):
        problems.append("the warm checkpoint did not resume to the same weights")
    if not (heal_equal and events.get("cache_rebuilds") == 1
            and events.get("cache_corruptions") == 1):
        problems.append("the flipped byte did not heal once with the stream unchanged")
    if not shards_ok:
        problems.append("the two hosts' shards are not disjoint with the epoch as union")
    if problems:
        raise AssertionError(f"block_cache_higgs: {problems}: {out}")
    return {**out, "epochs": epochs}


def run_shuffled_snapshot(path: str, snap: str, device) -> dict:
    """Phase 12 (c): phase 6's ELL snapshot served warm with
    ``device_decode=True`` and ``snapshot_shuffle_seed=2``: two warm epochs
    stepped through LinearLearner, K1, ``dw`` and K2 counted from 0 around
    them, each batch held bit for bit against the stored-order warm batch
    at ``block_permutation(2, epoch, n)[pos]`` (read first, not counted);
    a ``unit="batch"`` state taken after 37 batches of epoch 1 resumed in
    a fresh pipeline: the remaining batches bit-equal and the final
    weights ``torch.equal``."""
    import torch

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.convert import linear_params_from_jax, linear_params_to_jax
    from dmlc_tpu_torch.data.epoch import block_permutation
    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    def pipeline(seed):
        model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
        it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                        num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                        max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                        device_decode=True, snapshot_shuffle_seed=seed)
        return model, it

    _, it = pipeline(None)
    stored = [[t.clone() for t in b] for b in it]
    it.close()
    n = len(stored)
    model, it = pipeline(BC["snap_seed"])
    k1.launches = k1.dw_launches = dd.launches = 0
    equal, warm, state, params, tail, walls = True, True, None, None, [], []
    for ep in range(2):
        order = block_permutation(BC["snap_seed"], ep, n)
        t0 = time.monotonic()
        for pos, batch in enumerate(it):
            equal &= all(same_bits(a, b) for a, b in zip(batch, stored[order[pos]]))
            model.step(batch)
            if ep == 1 and pos + 1 == BC["ckpt_at"]:
                state = json.loads(json.dumps(it.state_dict()))
                params = linear_params_to_jax(model.params)
            elif state is not None:
                tail.append([t.clone() for t in batch])
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        warm &= it.stats()["snapshot_state"] == "warm"
        it.reset()
    k1_launches, dw_launches, k2_launches = k1.launches, k1.dw_launches, dd.launches
    it.close()
    model2, it = pipeline(None)
    model2.set_params(linear_params_from_jax(*params, device=device))
    it.load_state(state)
    resumed = []
    for b in it:
        model2.step(b)
        resumed.append([t.clone() for t in b])
    it.close()
    tail_equal = len(resumed) == len(tail) and all(
        all(same_bits(x, y) for x, y in zip(a, b)) for a, b in zip(resumed, tail))
    weights_equal = bool(torch.equal(model.params.weight, model2.params.weight)
                         and torch.equal(model.params.bias, model2.params.bias))
    out = {"phase": "shuffled_snapshot", "batches": 2 * n, "warm": warm,
           "rows_per_s": [n * BATCH / w for w in walls],
           "k2_launches": k2_launches, "k2_launches_needed": 2 * n,
           "k1_launches": k1_launches, "dw_launches": dw_launches,
           "batches_equal_stored_at_plan": equal, "state_source": state["source"],
           "resumed_batches": len(resumed), "resumed_batches_equal": tail_equal,
           "resumed_weights_equal": weights_equal}
    emit(out)
    problems = []
    if not (warm and equal):
        problems.append("a shuffled warm batch differs from the stored batch at its plan index")
    if k2_launches != 2 * n or k1_launches != 2 * n or dw_launches != 2 * n:
        problems.append("K2, K1 or dw did not launch once a warm batch")
    if not (state["source"].get("unit") == "batch" and tail_equal and weights_equal
            and len(resumed) == n - BC["ckpt_at"]):
        problems.append("the unit='batch' state did not resume bit for bit")
    if problems:
        raise AssertionError(f"shuffled_snapshot: {problems}: {out}")
    return out


# ---------------- phase 13: the csv and libfm formats ----------------

CRITEO_ROWS, CRITEO_INTS, CRITEO_CATS = 1 << 20, 13, 26
CRITEO_COLS = CRITEO_INTS + CRITEO_CATS
CRITEO_LR = 0.05
CRITEO_RANGE = (1e3, 1e5)  # the integer columns' and the categorical ids' range
KDD_ROWS, KDD_FIELDS, KDD_COLS = 1 << 20, 10, 50_000_000


class _Blocks:
    """A parser seen through: counts the blocks it hands out by kind (and
    the packed ones), and with ``csr=True`` hides ``set_emit_dense``, so a
    dense ``DeviceIter`` takes the CSR route (densified on its producer)."""

    def __init__(self, parser, csr: bool = False):
        self.parser, self.csr, self.kinds, self.packed = parser, csr, {}, 0

    def next_block(self):
        block = self.parser.next_block()
        if block is not None:
            kind = type(block).__name__
            self.kinds[kind] = self.kinds.get(kind, 0) + 1
            self.packed += bool(getattr(block, "packed", False))
        return block

    def __getattr__(self, name):
        if name == "set_emit_dense" and self.csr:
            raise AttributeError(name)
        return getattr(self.parser, name)


class _Scaled:
    """A dense or ELL ``DeviceIter`` seen through: each batch's feature
    columns divided on the card by their range (:data:`CRITEO_RANGE`), the
    feature scaling a user applies before a linear model. At the raw
    magnitudes (up to 99,999) the first Adam step moves the margin by
    thousands and the loss diverges. The kernels see the scaled batches
    as they would any other."""

    def __init__(self, it):
        import torch

        self.it = it
        # one entry a column and one for ELL's pad id (num_col), whose values are 0
        self.scale = torch.ones(it.num_col + 1, device=it.device)
        self.scale[:CRITEO_INTS] = 1 / CRITEO_RANGE[0]
        self.scale[CRITEO_INTS:CRITEO_COLS] = 1 / CRITEO_RANGE[1]

    def __iter__(self):
        from dmlc_tpu_torch.data.device import PackedDenseBatch
        from dmlc_tpu_torch.ops.sparse import EllBatch

        for b in self.it:
            if hasattr(b, "packed"):
                x = b.packed.clone()
                x[:, :b.num_col] *= self.scale[:b.num_col]
                yield PackedDenseBatch(x, b.num_col, b.aux)
            else:
                yield EllBatch(b.indices, b.values * self.scale[b.indices.long()],
                               b.label, b.weight)

    def __getattr__(self, name):
        return getattr(self.it, name)


def _digits(buf, col: int, values, ndigits: int) -> None:
    for d in range(ndigits):
        buf[:, col + d] = ord("0") + (values // 10 ** (ndigits - 1 - d)) % 10


def write_criteo_csv(path: str, rows: int, seed: int) -> dict:
    """A Criteo day-0 shaped csv (BASELINE.json config 2; the column layout
    of benchmarks/bench_csv_prefetch.py): a label, 13 integer columns in
    0-999 (three digits) and 26 categorical ids in 0-99,999 (five digits),
    comma-separated; the label is 1 when the first two integers sum past
    999."""
    width = 2 + 4 * CRITEO_INTS + 6 * CRITEO_CATS

    def fill(rng, buf):
        n = len(buf)
        ints = rng.integers(0, 1000, size=(n, CRITEO_INTS))
        cats = rng.integers(0, 100_000, size=(n, CRITEO_CATS))
        buf[:] = ord(",")
        buf[:, 0] = ord("0") + (ints[:, 0] + ints[:, 1] > 999)
        for j in range(CRITEO_INTS):
            _digits(buf, 2 + 4 * j, ints[:, j], 3)
        for j in range(CRITEO_CATS):
            _digits(buf, 2 + 4 * CRITEO_INTS + 6 * j, cats[:, j], 5)

    write_rows(path, rows, width, fill, seed)
    return {"rows": rows, "cols": 1 + CRITEO_COLS, "bytes": os.path.getsize(path)}


def write_kdd_libfm(path: str, rows: int, seed: int) -> dict:
    """A KDD2012 track 2 shaped libfm file (BASELINE.json config 4; the line
    shape of benchmarks/bench_libfm_bcoo.py): ten ``field:index:1`` tokens
    a row, field f in 0-9 and an index below 50,000,000 (eight digits); the
    label is 1 when the first two indices sum to a multiple of 3."""
    width = 2 + KDD_FIELDS * 13

    def fill(rng, buf):
        idx = rng.integers(0, KDD_COLS, size=(len(buf), KDD_FIELDS))
        buf[:] = ord(" ")
        buf[:, 0] = ord("0") + ((idx[:, 0] + idx[:, 1]) % 3 == 0)
        for f in range(KDD_FIELDS):
            col = 2 + 13 * f
            buf[:, col] = ord("0") + f
            buf[:, col + 1] = buf[:, col + 10] = ord(":")
            _digits(buf, col + 2, idx[:, f], 8)
            buf[:, col + 11] = ord("1")

    write_rows(path, rows, width, fill, seed)
    return {"rows": rows, "fields": KDD_FIELDS, "num_col": KDD_COLS,
            "bytes": os.path.getsize(path)}


def _batch_to(batch, dev):
    """A device batch of any layout, copied to ``dev``."""
    from dmlc_tpu_torch.data.device import PackedDenseBatch

    if hasattr(batch, "packed"):
        return PackedDenseBatch(batch.packed.to(dev), batch.num_col)
    return type(batch)(*(t.to(dev) for t in batch)) if hasattr(batch, "_fields") \
        else tuple(t.to(dev) for t in batch)


def _batch_tensors(batch) -> list:
    return [batch.packed] if hasattr(batch, "packed") else list(batch)


def _params_equal(a, b) -> bool:
    import torch

    return all(torch.equal(p, q) for p, q in zip(a.params, b.params))


def _loss_gates(make_model, batches, cpu_steps: int, device, init=None) -> dict:
    """``len(batches)`` steps on ``device`` twice from the same initial
    state (loss and parameter bits), and the first ``cpu_steps`` against
    the port on the CPU from that state: the largest relative loss
    difference. The CPU side runs under ``use_deterministic_algorithms``:
    by default the backward of a 1-D gather on the CPU (``index_put_``
    with ``accumulate=True``) adds in parallel with atomics once it has
    32,768 entries, so its bits change from run to run."""
    import torch

    card = []
    for _ in range(2):
        m = make_model(device)
        if init is not None:
            init(m)
        losses = torch.stack([m.step(b) for b in batches])
        card.append((losses, m))
    (la, ma), (lb, mb) = card
    repeatable = bool(torch.equal(la, lb)) and _params_equal(ma, mb)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cpu = make_model("cpu")
        if init is not None:
            init(cpu)
        pairs = [(float(c), float(cpu.step(_batch_to(b, "cpu"))))
                 for c, b in zip(la[:cpu_steps], batches)]
    finally:
        torch.use_deterministic_algorithms(was)
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    return {"card_bit_identical_twice": repeatable, "cpu_steps": len(pairs),
            "max_rel_diff_vs_cpu": rel, "first_losses": pairs[:3], "model": ma}


def _csv_model(device, layout: str):
    import torch

    from dmlc_tpu_torch import LinearLearner

    return LinearLearner(CRITEO_COLS, layout=layout, device=device,
                         optimizer=lambda p: torch.optim.Adam(p, lr=CRITEO_LR))


def _csv_pipeline(path: str, device, layout: str, snapshot=None, csr=False, **kw):
    from dmlc_tpu_torch import DeviceIter, create_parser

    model = _csv_model(device, layout)
    src = _Blocks(create_parser(path + "?format=csv&label_column=0", snapshot=snapshot, **kw),
                  csr=csr)
    it = DeviceIter(src, num_col=model.device_num_col(), batch_size=BATCH, layout=layout,
                    max_nnz=CRITEO_COLS, drop_remainder=True, device=device,
                    device_decode=snapshot is not None)
    return model, src, _Scaled(it)


def _epoch_record(it, model, leg: str, max_steps=None) -> dict:
    """One ``fit_epoch`` with its rows/s, stall share, the bytes decoded on
    the card (a warm device-decode epoch's) and the source's parse width and
    efficiency."""
    keys = ("stall_seconds", "device_decode_bytes", "convert_seconds")
    before = it.stats()
    t0 = time.monotonic()
    loss, nb = model.fit_epoch(it, max_steps=max_steps)
    secs = time.monotonic() - t0
    stats = it.stats()
    delta = {k: stats[k] - before[k] for k in keys}
    return {"leg": leg, "loss": loss, "batches": nb, "wall_s": secs,
            "rows_per_s": nb * BATCH / secs, "stall_share": delta["stall_seconds"] / secs,
            "producer_convert_s": delta["convert_seconds"],
            "device_decode_bytes": delta["device_decode_bytes"],
            "parse_workers": stats["parse_workers"],
            "parse_parallelism_efficiency": stats["parse_parallelism_efficiency"]}


def run_criteo_csv(path: str, tmp: str, device) -> dict:
    """Phase 13 (a): the Criteo-shaped csv. ``layout="dense"`` through the
    dense emit, a cold epoch shadow-writing a snapshot, then a warm epoch
    with ``device_decode=True`` (K2 once a batch); ``layout="ell"`` one
    epoch (K1 and ``dw`` once a step); the numpy engine at 1 and 4 parse
    workers. Gates: the first 8 dense-emit batches equal the CSR route's
    bit for bit; on dense and ell, 20 card steps twice bit-identical and
    within 1e-4 of the port on the CPU, and enqueued behind a device spin
    without a host sync; every epoch's loss below log 2. ``LinearLearner``
    takes Adam at :data:`CRITEO_LR` over the scaled columns
    (:class:`_Scaled`)."""
    import torch

    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    out: dict = {"phase": "formats_csv", "optimizer": f"Adam lr {CRITEO_LR}"}
    legs = []
    # the first 8 batches: the dense emit against the CSR route
    emit_b, csr_b = [], []
    for csr, sink in ((False, emit_b), (True, csr_b)):
        _, src, it = _csv_pipeline(path, device, "dense", csr=csr)
        sink.extend(b.packed.clone() for _, b in zip(range(8), it.it))
        it.close()
        sink.append(dict(src.kinds))
    kinds_emit, kinds_csr = emit_b.pop(), csr_b.pop()
    out["first8_dense_emit_equal_csr"] = len(emit_b) == 8 and all(
        torch.equal(a, b) for a, b in zip(emit_b, csr_b))
    out["block_kinds_emit_csr"] = [kinds_emit, kinds_csr]
    del emit_b, csr_b
    # dense: a cold epoch through the dense emit writing the snapshot, a warm
    # device-decode epoch from it
    snap = os.path.join(tmp, "criteo_dense.snapshot")
    model, src, it = _csv_pipeline(path, device, "dense", snapshot=snap)
    legs.append(_epoch_record(it, model, "dense_cold_emit"))
    kinds = dict(src.kinds)
    dd.launches = 0
    legs.append(_epoch_record(it, model, "dense_warm_device_decode"))
    out["k2_launches"], warm_batches = dd.launches, legs[-1]["batches"]
    it.close()
    out["dense_cold_block_kinds"] = kinds
    # ell: one epoch, K1 and dw counted around it
    model, _, it = _csv_pipeline(path, device, "ell")
    k1.launches = k1.dw_launches = 0
    legs.append(_epoch_record(it, model, "ell_cold"))
    out["k1_launches"], out["dw_launches"] = k1.launches, k1.dw_launches
    ell_steps = legs[-1]["batches"]
    it.close()
    # the numpy engine on the registry stack's parse fan-out, one cold
    # epoch at each width
    for workers in (1, 4):
        with registry_stack():
            model, _, it = _csv_pipeline(path, device, "dense", engine="python",
                                         parse_workers=workers)
        legs.append(_epoch_record(it, model, f"dense_python_w{workers}"))
        it.close()
    out["legs"] = legs
    # the gates on 20 resident batches of each layout
    for layout in ("dense", "ell"):
        _, _, it = _csv_pipeline(path, device, layout)
        batches = [b for _, b in zip(range(20), it)]
        it.close()
        gates = _loss_gates(lambda dev: _csv_model(dev, layout), batches, 20, device)
        m = gates.pop("model")
        m.step(batches[0])
        torch.cuda.synchronize()
        gates["step_enqueue_behind_spin"] = enqueue_behind_spin(lambda: m.step(batches[0]))
        out[f"{layout}_gates"] = gates
        del batches, m
    emit(out)
    problems = []
    if not out["first8_dense_emit_equal_csr"]:
        problems.append("the dense emit's first 8 batches differ from the CSR route's")
    if kinds_emit.get("RowBlock") or kinds.get("RowBlock") or not kinds.get("DenseBlock"):
        problems.append(f"the dense emit handed out CSR blocks: {kinds_emit}, {kinds}")
    if not legs[1]["device_decode_bytes"] or out["k2_launches"] != warm_batches:
        problems.append(f"K2 launched {out['k2_launches']} times for {warm_batches} warm batches")
    if out["k1_launches"] < ell_steps or out["dw_launches"] < ell_steps:
        problems.append(f"K1/dw launched {out['k1_launches']}/{out['dw_launches']} times for "
                        f"{ell_steps} steps")
    if not all(np.isfinite(leg["loss"]) and leg["loss"] < np.log(2) for leg in legs):
        problems.append(f"an epoch loss not below log 2: {[leg['loss'] for leg in legs]}")
    for layout in ("dense", "ell"):
        g = out[f"{layout}_gates"]
        if not (g["card_bit_identical_twice"] and g["cpu_steps"] == 20
                and g["max_rel_diff_vs_cpu"] <= 1e-4
                and g["step_enqueue_behind_spin"]["no_host_sync"]):
            problems.append(f"{layout}: {g}")
    if problems:
        raise AssertionError(f"formats csv: {problems}")
    return out


def _kdd_model(device, kind: str):
    import torch

    from dmlc_tpu_torch import FMLearner, LinearLearner

    if kind == "bcoo":
        return LinearLearner(KDD_COLS, layout="bcoo", device=device)
    return FMLearner(KDD_COLS, num_factors=8, layout="ell", seed=0, device=device,
                     optimizer=lambda p: torch.optim.Adam(p, lr=0.05))


def _kdd_pipeline(path: str, device, kind: str):
    from dmlc_tpu_torch import DeviceIter, create_parser

    model = _kdd_model(device, kind)
    it = DeviceIter(create_parser(path + "?format=libfm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout=kind, max_nnz=KDD_FIELDS, device=device)
    return model, it


def run_kdd_libfm(path: str, device, fm_steps: int = 64) -> dict:
    """Phase 13 (b): the KDD2012-shaped libfm. ``LinearLearner(bcoo)`` over
    50,000,000 columns, one epoch (its gradient a row scatter a step into
    the whole table); ``FMLearner(ell)``, 8 factors, Adam 0.05,
    ``fm_steps`` steps on the ``[50,000,001, 8]`` table (two row scatters a
    step); each leg's step device time on a resident batch. Gates: 20 steps
    twice bit-identical on each leg; the losses against the port on the CPU
    from the same initial state, the first 20 (linear) and 5 (FM) within
    1e-4; the first bcoo batch's forward (a row scatter: the batch is
    unordered) against its plain versions (:func:`coo_forward_check`).
    Each leg keeps a step on its resident batch (``step_fns``) for the
    profiler's window at the end of the run."""
    import torch

    from dmlc_tpu_torch.convert import fm_params_from_jax, fm_params_to_jax
    from dmlc_tpu_torch.ops import row_scatter as rs

    out: dict = {"phase": "formats_libfm"}
    step_fns = {}
    model, it = _kdd_pipeline(path, device, "bcoo")
    rs.launches = 0
    rec = _epoch_record(it, model, "linear_bcoo")
    rec["row_scatter_launches"] = rs.launches
    rec["nnz_shapes"] = sorted(it.nnz_shapes)
    batches = [b for _, b in zip(range(20), it)]
    it.close()
    rec["forward_check"] = coo_forward_check(batches[0][0], 13)
    rec["step_device_ms"] = device_ms(lambda: model.step(batches[0]), iters=10)
    step_fns["linear_bcoo"] = (lambda m, b: lambda: m.step(b))(model, batches[0])
    del model
    gates = _loss_gates(lambda dev: _kdd_model(dev, "bcoo"), batches, 20, device)
    gates.pop("model")
    out["linear_bcoo"] = {**rec, **gates}
    del batches
    torch.cuda.empty_cache()

    model, it = _kdd_pipeline(path, device, "ell")
    init = fm_params_to_jax(model.params)  # the card's initial state, for every run
    rs.launches = 0
    rec = _epoch_record(it, model, "fm_ell", max_steps=fm_steps)
    rec["row_scatter_launches"] = rs.launches
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    batches = [b for _, b in zip(range(20), it)]
    it.close()
    rec["step_device_ms"] = device_ms(lambda: model.step(batches[0]), iters=10)
    step_fns["fm_ell"] = (lambda m, b: lambda: m.step(b))(model, batches[0])
    del model
    torch.cuda.empty_cache()
    gates = _loss_gates(lambda dev: _kdd_model(dev, "ell"), batches, 5, device,
                        init=lambda m: m.set_params(fm_params_from_jax(*init, device=m.device)))
    gates.pop("model")
    out["fm_ell"] = {**rec, **gates}
    del batches, init
    torch.cuda.empty_cache()
    emit(out)
    out["step_fns"] = step_fns
    problems = []
    lin, fm = out["linear_bcoo"], out["fm_ell"]
    if lin["row_scatter_launches"] < lin["batches"]:
        problems.append(f"bcoo: the row scatter launched {lin['row_scatter_launches']} times")
    if coo_forward_failed(lin["forward_check"]):
        problems.append(f"bcoo: the forward's row scatter: {lin['forward_check']}")
    if fm["batches"] != fm_steps or fm["row_scatter_launches"] < 2 * fm_steps:
        problems.append(f"fm: {fm['batches']} steps, {fm['row_scatter_launches']} scatters")
    for name, leg, steps in (("bcoo", lin, 20), ("fm", fm, 5)):
        if not (np.isfinite(leg["loss"]) and leg["card_bit_identical_twice"]
                and leg["cpu_steps"] == steps and leg["max_rel_diff_vs_cpu"] <= 1e-4):
            problems.append(f"{name}: {leg}")
    if problems:
        raise AssertionError(f"formats libfm: {problems}")
    return out


def run_libfm_xor(tmp: str, device) -> dict:
    """Phase 13 (c): ``tests/test_device.py``'s libfm case on the card,
    ``FMLearner(ell)`` on ``field:index:1`` rows whose label is an XOR."""
    from dmlc_tpu_torch import DeviceIter, FMLearner, create_parser
    from dmlc_tpu_torch.ops import row_scatter as rs

    rng = np.random.default_rng(5)
    lines = []
    for _ in range(400):
        a, b = int(rng.integers(0, 2)), int(rng.integers(0, 2))
        lines.append(f"{a ^ b} 0:{a}:1 1:{2 + b}:1")
    path = os.path.join(tmp, "xor.libfm")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    model = FMLearner(num_col=4, num_factors=4, layout="ell", learning_rate=0.15, seed=3,
                      device=device)
    it = DeviceIter(create_parser(path + "?format=libfm", 0, 1, "auto", threaded=False),
                    num_col=model.device_num_col(), batch_size=50, layout="ell", max_nnz=2,
                    drop_remainder=True, device=device)
    rs.launches = 0
    t0 = time.monotonic()
    model.fit(it, epochs=60)
    acc = model.accuracy(it)
    it.close()
    out = {"phase": "formats_libfm_xor", "accuracy": acc, "steps": 60 * 8,
           "row_scatter_launches": rs.launches, "wall_s": time.monotonic() - t0}
    emit(out)
    if not acc > 0.9 or rs.launches < 2 * out["steps"]:
        raise AssertionError(f"libfm XOR: {out}")
    return out


def run_formats(tmp: str, device, seed: int) -> dict:
    """Phase 13: the csv and libfm formats, the dense emit and the parse
    fan-out, fed to the learners on the card."""
    from dmlc_tpu_torch import native

    t0 = time.monotonic()
    if not native.available():
        raise AssertionError("the native parser did not build")
    csv, fm = os.path.join(tmp, "criteo.csv"), os.path.join(tmp, "kdd.libfm")
    emit({"phase": "formats_corpora", "parse_engine": "native",
          "criteo": write_criteo_csv(csv, CRITEO_ROWS, seed),
          "kdd": write_kdd_libfm(fm, KDD_ROWS, seed), "write_s": time.monotonic() - t0,
          "reduced": "Criteo day 0 (about 195 M rows) and KDD2012 track 2 (about 150 M "
                     "rows) each cut to 1,048,576 rows for the time limit; widths as "
                     "published (40 csv columns; 10 libfm fields, 50 M ids)"})
    out = {"csv": run_criteo_csv(csv, tmp, device), "libfm": run_kdd_libfm(fm, device),
           "xor": run_libfm_xor(tmp, device)}
    os.remove(csv)
    out["kdd_path"] = fm  # phase 14 reads it, then removes it
    out["wall_s"] = time.monotonic() - t0
    emit({"phase": "formats_total", "wall_s": out["wall_s"]})
    return out


# ---------------- phase 14: the fused native reader ----------------

# rows/s and stall share of the same phases with the registry stack
# (``ParallelTextParser``) as the producer, before ``create_parser`` moved
# to the fused native reader: NVIDIA H100 80GB HBM3, 700.00 W (PERF.md §5)
BEFORE_READER = {
    "main_path_epoch0": (417663, 0.693), "main_path_epoch1": (436462, 0.730),
    "dense_emit": (1366423, 0.267), "dense_csr": (1168378, 0.169),
    "warm_ell_epoch0_cold": (439299, 0.727), "checkpoint_uninterrupted": (654268, None),
    "bcoo": (1059776, 0.408), "bcoo_natural": (532794, None),
    "block_cache_higgs_cold": (335378, 0.761),
    "csv_dense_cold_emit": (1132931, 0.365), "csv_ell_cold": (531930, 0.635),
    "libfm_linear_bcoo": (1158876, 0.241), "libfm_fm_ell": (592575, 0.176),
}
NATIVE_COO_LEGS = [  # (leg, csr_wire, elide_unit_values)
    ("pair", False, False), ("pair_elide", False, True),
    ("csr", True, False), ("csr_elide", True, True)]


def _fit_record(it, model, src, rows=None) -> dict:
    """One ``fit_epoch``: rows/s (``rows`` real rows, else full batches),
    stall share, the producer's convert seconds and the source's blocks."""
    keys = ("stall_seconds", "convert_seconds", "device_decode_bytes",
            "snapshot_write_seconds", "source_wait_seconds")
    before = it.stats()
    t0 = time.monotonic()
    loss, nb = model.fit_epoch(it)
    secs = time.monotonic() - t0
    after = it.stats()
    d = {k: after[k] - before[k] for k in keys}
    return {"loss": loss, "batches": nb, "wall_s": secs,
            "rows_per_s": (rows if rows is not None else nb * BATCH) / secs,
            "stall_share": d["stall_seconds"] / secs, "convert_s": d["convert_seconds"],
            "source_wait_s": d["source_wait_seconds"],
            "snapshot_write_s": d["snapshot_write_seconds"],
            "warm": d["device_decode_bytes"] > 0,
            "block_kinds": dict(src.kinds), "packed_blocks": src.packed}


def _native_dense_pipeline(path: str, device, x_dtype: str, snapshot=None):
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, device=device)
    src = _Blocks(create_parser(path, 0, 1, "libsvm", snapshot=snapshot))
    it = DeviceIter(src, num_col=model.device_num_col(), batch_size=BATCH, layout="dense",
                    drop_remainder=True, device=device, x_dtype=x_dtype, pack_aux=True,
                    device_decode=snapshot is not None)
    return model, src, it


def run_native_dense(path: str, tmp: str, device) -> dict:
    """Phase 14 (a): phase 3's HIGGS-shaped corpus, ``DeviceIter(dense,
    pack_aux=True)`` in float32 and bfloat16 through the fused reader's
    batch repack (float32: packed ``[8192, 31]`` slabs, one copy a batch;
    bfloat16: bf16 features with float32 label and weight, packed with
    the exactness check): cold epochs beside the same epochs through the
    registry stack's dense emit, in turns (reader, registry, registry,
    reader; no snapshot); then a cold epoch shadow-writing a snapshot and
    a warm ``device_decode=True`` epoch from it (one K2 launch a batch).
    Gates: the first 8 batches of the two producers bit-equal, 20 card
    steps twice bit-identical and within 1e-4 relative of the CPU, K2 once
    a warm batch, every epoch's loss below log 2."""
    from dmlc_tpu_torch import LinearLearner
    from dmlc_tpu_torch.ops import device_decode as dd

    out: dict = {"phase": "native_reader_dense", "k2_launches": 0, "k2_launches_needed": 0}
    problems = []
    for x_dtype in ("float32", "bfloat16"):
        turns = {"reader": [], "registry": []}
        for route in ("reader", "registry", "registry", "reader"):
            with registry_stack() if route == "registry" else contextlib.nullcontext():
                model, src, it = _native_dense_pipeline(path, device, x_dtype)
            turns[route].append(_fit_record(it, model, src))
            it.close()
        cold = turns["reader"][0]
        snap = os.path.join(tmp, f"native_dense_{x_dtype}.snapshot")
        model, src, it = _native_dense_pipeline(path, device, x_dtype, snapshot=snap)
        cold_snap = _fit_record(it, model, src)
        dd.launches = 0
        warm = _fit_record(it, model, src)
        k2 = dd.launches
        it.close()
        os.remove(snap)
        first = []
        for route in ("native", "registry"):
            with registry_stack() if route == "registry" else contextlib.nullcontext():
                _, _, it = _native_dense_pipeline(path, device, x_dtype)
            first.append([b.packed.clone() for _, b in zip(range(8), it)])
            it.close()
        _, _, it = _native_dense_pipeline(path, device, x_dtype)
        batches = [b for _, b in zip(range(20), it)]
        it.close()
        gates = _loss_gates(lambda dev: LinearLearner(HIGGS_COLS, layout="dense",
                                                      learning_rate=0.3, device=dev),
                            batches, 20, device)
        gates.pop("model")
        del batches
        leg = {"cold_reader": turns["reader"], "cold_registry_emit": turns["registry"],
               "cold_reader_snapshot_write": cold_snap, "warm_reader": warm,
               "k2_launches": k2, "warm_batches": warm["batches"],
               "first8_equal_registry_emit": len(first[0]) == 8 and all(
                   same_bits(a, b) for a, b in zip(*first)), **gates}
        out[x_dtype] = leg
        out["k2_launches"] += k2
        out["k2_launches_needed"] += warm["batches"]
        if not (cold["block_kinds"].get("DenseBlock") and not cold["block_kinds"].get(
                "RowBlock") and cold["packed_blocks"] == (
                    cold["block_kinds"]["DenseBlock"] if x_dtype == "float32" else 0)):
            problems.append(f"{x_dtype}: the reader's blocks {cold['block_kinds']}")
        if not (warm["warm"] and warm["convert_s"] == 0.0 and k2 == warm["batches"]):
            problems.append(f"{x_dtype}: K2 launched {k2} times for {warm['batches']} "
                            "warm batches")
        if not all(np.isfinite(r["loss"]) and r["loss"] < np.log(2)
                   for r in turns["reader"] + turns["registry"] + [cold_snap, warm]):
            problems.append(f"{x_dtype}: an epoch loss not below log 2")
        if not (leg["first8_equal_registry_emit"] and gates["card_bit_identical_twice"]
                and gates["cpu_steps"] == 20 and gates["max_rel_diff_vs_cpu"] <= 1e-4):
            problems.append(f"{x_dtype}: {leg}")
    emit(out)
    if problems:
        raise AssertionError(f"native reader dense: {problems}")
    return out


def _native_coo_pipeline(path: str, device, csr_wire: bool, elide: bool):
    from dmlc_tpu_torch import DeviceIter, create_parser

    model = _kdd_model(device, "bcoo")
    src = _Blocks(create_parser(path + "?format=libfm"))
    it = DeviceIter(src, num_col=model.device_num_col(), batch_size=None, layout="bcoo",
                    csr_wire=csr_wire, elide_unit_values=elide, device=device)
    return model, src, it


def _coo_leg(path: str, device, csr_wire: bool, elide: bool) -> dict:
    """One natural-block epoch of ``LinearLearner(bcoo)`` on the KDD-shaped
    libfm, then its first 20 batches: the step's device time on a resident
    batch, 20 steps twice and against the CPU, 20 steps enqueued behind a
    device spin (two groups of 10)."""
    import torch

    from dmlc_tpu_torch.ops import row_scatter as rs

    model, src, it = _native_coo_pipeline(path, device, csr_wire, elide)
    rs.launches = 0
    rec = _fit_record(it, model, src, rows=KDD_ROWS)
    rec["row_scatter_launches"] = rs.launches
    rec["nnz_shapes"] = sorted(it.nnz_shapes)
    it.reset()
    batches = [b for _, b in zip(range(20), it)]
    it.close()
    rec["forward_check"] = coo_forward_check(batches[0][0], 14)
    x0 = batches[0][0].coalesce()
    rec["first_batch"] = (x0.indices().clone(), x0.values().clone())
    rec["coalesced_share"] = sum(b[0].is_coalesced() for b in batches) / len(batches)
    del model
    torch.cuda.empty_cache()
    gates = _loss_gates(lambda dev: _kdd_model(dev, "bcoo"), batches, 20, device)
    m = gates.pop("model")
    m.step(batches[0])
    torch.cuda.synchronize()
    rec["step_device_ms"] = device_ms(lambda: m.step(batches[0]), iters=10)
    rec["step_enqueue_behind_spin"] = enqueue_behind_spin(lambda: m.step(batches[0]),
                                                          group=10)
    del m, batches
    torch.cuda.empty_cache()
    return {**rec, **gates}


def run_native_coo(path: str, device) -> dict:
    """Phase 14 (b): phase 13's KDD2012-shaped libfm (50,000,000 ids) as
    ``DeviceIter(bcoo, batch_size=None)`` natural blocks through the
    fused reader's COO emit (``CooBlock``: coordinates, bucket padding and
    unit-value elision built in its C++ parse threads), on the pair and
    the CSR wire, each with elision off and on, into
    ``LinearLearner(bcoo)``; beside the same natural blocks through the
    registry stack's RowBlock route (the convert on the producer). Gates,
    on each wire: every block a ``CooBlock``, the row scatter launched
    every step, the first batch equal across the wires, 20 steps twice
    bit-identical and within 1e-4 relative of the CPU, 20 steps enqueued
    behind a device spin without waiting, the first block's forward
    against its plain versions (:func:`coo_forward_check`)."""
    out: dict = {"phase": "native_reader_coo", "row_scatter_launches": 0}
    for leg, csr_wire, elide in NATIVE_COO_LEGS:
        out[leg] = _coo_leg(path, device, csr_wire, elide)
        out["row_scatter_launches"] += out[leg]["row_scatter_launches"]
    with registry_stack():
        out["rowblock"] = _coo_leg(path, device, False, False)
    ref = out["pair"].pop("first_batch")
    problems = []
    for leg, *_ in NATIVE_COO_LEGS[1:] + [("rowblock",)]:
        idx, val = out[leg].pop("first_batch")
        out[leg]["first_batch_equal_pair"] = bool(
            idx.shape == ref[0].shape and (idx == ref[0]).all() and (val == ref[1]).all())
    emit(out)
    for leg in [name for name, *_ in NATIVE_COO_LEGS] + ["rowblock"]:
        r = out[leg]
        kinds_ok = (r["block_kinds"].get("CooBlock") and not r["block_kinds"].get("RowBlock")
                    if leg != "rowblock" else not r["block_kinds"].get("CooBlock"))
        if not (kinds_ok and r["row_scatter_launches"] >= r["batches"]
                and np.isfinite(r["loss"]) and r.get("first_batch_equal_pair", True)
                and r["card_bit_identical_twice"] and r["cpu_steps"] == 20
                and r["max_rel_diff_vs_cpu"] <= 1e-4 and not coo_forward_failed(r["forward_check"])
                and r["step_enqueue_behind_spin"]["no_host_sync"]):
            problems.append(f"{leg}: {r}")
    if problems:
        raise AssertionError(f"native reader coo: {problems}")
    return out


def run_ell_per_batch_k(path: str, device) -> dict:
    """Phase 14 (c): fault C8's path, ``DeviceIter(ell)`` without
    ``max_nnz`` (K from each batch's longest row) on phase 3's corpus, one
    epoch into ``LinearLearner(ell)``: K1 and ``dw`` launched once a
    batch."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.ops import ell_matvec as k1

    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    src = _Blocks(create_parser(path))
    it = DeviceIter(src, num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    drop_remainder=True, device=device)
    k1.launches = k1.dw_launches = 0
    rec = _fit_record(it, model, src)
    out = {"phase": "native_reader_ell_per_batch_k", **rec, "k1_launches": k1.launches,
           "dw_launches": k1.dw_launches}
    it.reset()
    out["first_batch_k"] = int(next(it).indices.shape[1])
    it.close()
    emit(out)
    if not (out["k1_launches"] == out["dw_launches"] == out["batches"] > 0
            and out["first_batch_k"] == HIGGS_COLS and out["loss"] < np.log(2)):
        raise AssertionError(f"ell without max_nnz: {out}")
    return out


def run_native_reader(higgs: str, kdd: str, tmp: str, device) -> dict:
    """Phase 14: the fused native reader's own routes (module docstring)."""
    t0 = time.monotonic()
    out = {"dense": run_native_dense(higgs, tmp, device), "coo": run_native_coo(kdd, device),
           "ell": run_ell_per_batch_k(higgs, device)}
    out["wall_s"] = time.monotonic() - t0
    emit({"phase": "native_reader_total", "wall_s": out["wall_s"]})
    return out


# ---------------- phase 15: the convert pool, the read pool, the attribution ----------------

POOL_WIDTHS = (1, 2, 4)   # convert_workers of phase 15 (a)
READ_WIDTHS = (1, 2)      # snapshot_read_workers of phase 15 (b)
POOL_AHEAD = 4
# rows/s and stall share of the same phases in PR 11's chip run 2, the
# fused native reader feeding one producer thread: NVIDIA H100 80GB HBM3,
# 700.00 W (PERF.md §6)
PR11_READER = {
    "main_path_epoch0": (488332, 0.625), "main_path_epoch1": (592608, 0.647),
    "dense_emit": (1487271, 0.542), "dense_csr": (1318529, 0.765),
    "warm_ell_epoch0_cold": (538734, 0.761), "checkpoint_uninterrupted": (751091, None),
    "bcoo": (1145143, 0.483), "bcoo_natural": (613637, None),
    "block_cache_higgs_cold": (409818, 0.817),
    "csv_dense_cold_emit": (1201753, 0.521), "csv_ell_cold": (412786, 0.632),
    "libfm_linear_bcoo": (1409713, 0.195), "libfm_fm_ell": (596473, 0.106),
}
POOL_STATS = ("stages", "stage_busy", "wall_seconds", "staging_ring", "transfer_samples",
              "host_stall_seconds", "input_wait_seconds", "convert_workers", "pipeline")


def _pool_pipeline(path: str, device, convert_workers: int, snapshot=None,
                   convert_ahead: int = POOL_AHEAD, **kw):
    """Phase 3's main path with the convert pool's width named."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snapshot),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                    convert_workers=convert_workers, convert_ahead=convert_ahead, **kw)
    return model, it


def _pool_epochs(model, it, leg: str, epochs: int) -> list:
    """``fit(epochs)`` with each epoch's rows/s, stall share and busy
    seconds by stage."""
    out = []
    prev = it.stats()

    def log(epoch, loss, nb, secs):
        now = it.stats()
        rec = {"leg": leg, "epoch": epoch, "loss": loss, "batches": nb, "wall_s": secs,
               "rows_per_s": nb * BATCH / secs,
               "stall_share": (now["stall_seconds"] - prev["stall_seconds"]) / secs,
               "warm": now["device_decode_bytes"] > prev["device_decode_bytes"],
               "busy_s": {k: v - prev["stage_busy"][k] for k, v in now["stage_busy"].items()}}
        prev.update(now)
        out.append(rec)

    model.fit(it, epochs=epochs, log_fn=log)
    return out


def _check_attribution(leg: str, stats: dict) -> None:
    total = sum(stats["stages"].values())
    if not (stats["wall_seconds"] > 0 and total <= stats["wall_seconds"] * 1.02 + 1e-6):
        raise AssertionError(f"{leg}: stages sum {total} against wall {stats['wall_seconds']}")


def run_convert_pool(path: str, device) -> dict:
    """Phase 15 (a): cold ELL at each convert width, two epochs and an
    accuracy pass a width, K1 and ``dw`` counted from 0 around each; the
    first 8 batches of every width bit-equal to width 1's."""
    import torch

    from dmlc_tpu_torch.ops import ell_matvec as k1

    first = {}
    for w in POOL_WIDTHS:
        _, it = _pool_pipeline(path, device, w)
        first[w] = [[t.clone() for t in batch] for _, batch in zip(range(8), it)]
        it.close()
    same = all(len(first[w]) == 8 and all(
        torch.equal(a, b) for x, y in zip(first[w], first[1]) for a, b in zip(x, y))
        for w in POOL_WIDTHS)
    legs = []
    for w in POOL_WIDTHS:
        model, it = _pool_pipeline(path, device, w)
        k1.launches = k1.dw_launches = 0
        t0 = time.monotonic()
        epochs = _pool_epochs(model, it, f"convert_workers_{w}", 2)
        acc = model.accuracy(it)
        leg = {"phase": "convert_pool", "convert_workers": w, "convert_ahead": POOL_AHEAD,
               "epochs": epochs, "accuracy": acc, "wall_s": time.monotonic() - t0,
               "k1_launches": k1.launches, "dw_launches": k1.dw_launches,
               "steps": sum(e["batches"] for e in epochs),
               **{k: it.stats()[k] for k in POOL_STATS}}
        it.close()
        emit(leg)
        _check_attribution(f"convert_workers={w}", leg)
        if not (acc > 0.9 and all(np.isfinite(e["loss"]) for e in epochs)):
            raise AssertionError(f"convert_workers={w}: accuracy {acc}, {epochs}")
        if (leg["k1_launches"] < leg["steps"] + HIGGS_ROWS // BATCH
                or leg["dw_launches"] < leg["steps"]):
            raise AssertionError(f"convert_workers={w}: K1 {leg['k1_launches']}, "
                                 f"dw {leg['dw_launches']} for {leg['steps']} steps")
        legs.append(leg)
    out = {"phase": "convert_pool_first_batches", "widths": list(POOL_WIDTHS),
           "first_8_bit_equal": same}
    emit(out)
    if not same:
        raise AssertionError("the first 8 batches differ across convert widths")
    return {"legs": legs, "k1_launches": sum(leg["k1_launches"] for leg in legs),
            "dw_launches": sum(leg["dw_launches"] for leg in legs)}


def run_read_pool(path: str, tmp: str, device) -> dict:
    """Phase 15 (b): a cold epoch writes a snapshot; then two warm
    device-decode epochs at each read width, K2 counted from 0 around
    each: one launch a warm batch, no convert."""
    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    snap = os.path.join(tmp, "read_pool.snapshot")
    model, it = _pool_pipeline(path, device, 2, snapshot=snap, device_decode=True)
    model.fit_epoch(it)
    it.close()
    legs = []
    for w in READ_WIDTHS:
        model, it = _pool_pipeline(path, device, 2, snapshot=snap, device_decode=True,
                                   snapshot_read_workers=w)
        dd.launches = k1.launches = k1.dw_launches = 0
        epochs = _pool_epochs(model, it, f"snapshot_read_workers_{w}", 2)
        leg = {"phase": "read_pool", "snapshot_read_workers": w, "epochs": epochs,
               "k2_launches": dd.launches, "k1_launches": k1.launches,
               "dw_launches": k1.dw_launches, "batches": sum(e["batches"] for e in epochs),
               **{k: it.stats()[k] for k in POOL_STATS}}
        it.close()
        emit(leg)
        _check_attribution(f"snapshot_read_workers={w}", leg)
        if not all(e["warm"] and e["busy_s"]["convert"] == 0.0 for e in epochs):
            raise AssertionError(f"snapshot_read_workers={w}: an epoch was not warm: {epochs}")
        if leg["k2_launches"] != leg["batches"]:
            raise AssertionError(f"snapshot_read_workers={w}: K2 launched "
                                 f"{leg['k2_launches']} times for {leg['batches']} batches")
        if leg["k1_launches"] < leg["batches"] or leg["dw_launches"] < leg["batches"]:
            raise AssertionError(f"snapshot_read_workers={w}: K1 {leg['k1_launches']}, "
                                 f"dw {leg['dw_launches']} for {leg['batches']} steps")
        legs.append(leg)
    os.remove(snap)
    return {"legs": legs, **{k: sum(leg[k] for leg in legs)
                             for k in ("k1_launches", "dw_launches", "k2_launches")}}


def _spin_leg(path: str, device, convert_ahead: int) -> dict:
    """20 steps fed by ``DeviceIter(transfer_sample=1)`` enqueued behind a
    spin, after the pool was let run ``convert_ahead`` batches ahead and its
    workers parked (``settle_s``: at least 3 s)."""
    from dmlc_tpu_torch.ops import ell_matvec as k1

    model, it = _pool_pipeline(path, device, 2, transfer_sample=1,
                               convert_ahead=convert_ahead)
    model.step(next(it))
    t0 = time.monotonic()
    time.sleep(3.0)
    # then until the workers have parked on the full window (no convert
    # finished for 0.5 s): on a slow host 3 s can leave them converting,
    # and the pulls would share the interpreter lock with them, which is
    # the busy leg's case, not this one's
    last = None
    while time.monotonic() - t0 < 30.0:
        now = it.stats()["convert_seconds"]
        if now == last:
            break
        last = now
        time.sleep(0.5)
    settle_s = time.monotonic() - t0
    samples0 = it.stats()["transfer_samples"]
    k1.launches = k1.dw_launches = 0
    spin = enqueue_behind_spin(lambda: model.step(next(it)))
    out = {"convert_ahead": convert_ahead, "settle_s": settle_s, **spin,
           "transfer_samples": it.stats()["transfer_samples"] - samples0,
           "k1_launches": k1.launches, "dw_launches": k1.dw_launches}
    it.close()
    return out


def run_sampled_spin(path: str, device) -> dict:
    """Phase 15 (c): 20 steps fed by ``DeviceIter(transfer_sample=1)``
    enqueued behind a half-second spin on the consumer's stream; each pull
    waits on its batch's copy event, which the spin does not hold. Gated
    with the whole epoch converted ahead (``convert_ahead`` past its 128
    batches: the workers have stopped, so no pull shares the interpreter
    lock with them); reported beside it with 32 ahead, where the workers
    refill the window during the 20 pulls (what the lock costs the
    consumer)."""
    free = _spin_leg(path, device, HIGGS_ROWS // BATCH + 8)
    busy = _spin_leg(path, device, 32)
    out = {"phase": "sampled_transfer_spin", **free, "with_workers_running": busy,
           "k1_launches": free["k1_launches"] + busy["k1_launches"],
           "dw_launches": free["dw_launches"] + busy["dw_launches"]}
    emit(out)
    if not (free["no_host_sync"] and free["transfer_samples"] == 20
            and busy["transfer_samples"] == 20 and busy["stream_busy_after"]):
        raise AssertionError(f"sampled transfers held the steps: {out}")
    return out


def run_trace_modes(path: str, tmp: str, device) -> dict:
    """Phase 15 (d): ``DMLC_TPU_TRACE=chrome:<path>`` over a cold epoch
    writes a trace whose events cover every stage ``stats()["stages"]``
    reports above 0; ``DMLC_TPU_TRACE=1`` under ``torch.profiler`` (all
    threads) shows the convert, dispatch and transfer ranges."""
    import torch

    from dmlc_tpu_torch.utils import telemetry

    telemetry.reset_spans()  # the trace holds this leg's spans, not the run's
    trace = os.path.join(tmp, "pool.trace.json")
    with _env({"DMLC_TPU_TRACE": f"chrome:{trace}"}):
        model, it = _pool_pipeline(path, device, 2, transfer_sample=8)
        model.fit_epoch(it)
        stats = it.stats()
        it.close()
    with open(trace) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]
             if e.get("ph") == "X" and e["args"].get("pipeline") == stats["pipeline"]}
    need = {k for k, v in stats["stages"].items() if v > 0}
    with _env({"DMLC_TPU_TRACE": "1"}):
        model, it = _pool_pipeline(path, device, 2, transfer_sample=1)
        model.step(next(it))
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts, experimental_config=cfg) as prof:
            for _ in range(6):
                model.step(next(it))
            torch.cuda.synchronize()
        it.close()
    ranges = sorted(e.key for e in prof.key_averages() if e.key.startswith("dmlc_tpu."))
    out = {"phase": "trace_modes", "chrome_events": sorted(names),
           "stages_above_0": sorted(need), "trace_bytes": os.path.getsize(trace),
           "annotate_ranges": ranges}
    os.remove(trace)
    emit(out)
    if not need <= names:
        raise AssertionError(f"the chrome trace misses stages: {out}")
    if not {"dmlc_tpu.convert", "dmlc_tpu.dispatch", "dmlc_tpu.transfer"} <= set(ranges):
        raise AssertionError(f"annotate mode: the profiler shows {ranges}")
    return out


def run_pools(path: str, tmp: str, device) -> dict:
    """Phase 15 (module docstring)."""
    t0 = time.monotonic()
    out = {"convert": run_convert_pool(path, device), "read": run_read_pool(path, tmp, device),
           "spin": run_sampled_spin(path, device), "trace": run_trace_modes(path, tmp, device)}
    out["wall_s"] = time.monotonic() - t0
    emit({"phase": "pools_total", "wall_s": out["wall_s"]})
    return out


# ---------------- phase 16: the online autotuner ----------------

TUNE_EPOCHS = 4          # phase 16 (a): epochs a side
TUNE_INTERVAL = 16       # autotune_interval of (a) and (b)
TUNE_WARM_EPOCHS = 3     # phase 16 (b): warm epochs a pipeline
TUNE_FAIL_CHUNK = 178    # phase 16 (c): the split's 1 MiB chunk that fails once (of 357)


def _tuned(it) -> dict:
    """What ``stats()["autotune"]`` says now: knob values, steps, moves and
    the last decisions (None when the autotuner is off)."""
    snap = it.stats()["autotune"]
    if snap is None:
        return None
    return {"knobs": snap["knobs"], "steps": snap["steps"], "adjustments": snap["adjustments"],
            "converged": snap["converged"], "gap_stage": snap["gap_stage"],
            "last": [{k: d.get(k) for k in ("step", "action", "knob", "from", "to", "gap_stage")
                      if k in d} for d in snap["history"][-4:]]}


def _tune_epoch(model, it, leg: str, epoch: int, losses=None) -> dict:
    """One epoch stepped batch by batch (the first 20 losses kept in
    ``losses``), timed to a synchronize, then ``reset()``, which takes the
    autotuner's epoch-boundary step."""
    import torch

    before = it.stats()
    t0 = time.monotonic()
    nb = 0
    for batch in it:
        loss = model.step(batch)
        if losses is not None and len(losses) < 20:
            losses.append(loss)
        nb += 1
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    it.reset()
    now = it.stats()
    return {"leg": leg, "epoch": epoch, "batches": nb, "wall_s": secs,
            "rows_per_s": nb * BATCH / secs,
            "stall_share": (now["stall_seconds"] - before["stall_seconds"]) / secs,
            "staging_ring": now["staging_ring"], "autotune": _tuned(it)}


def _k1_on_batch(model, batch) -> dict:
    """K1 and ``dw`` on a main-path batch, over a seeded table of the
    model's width, against their plain versions (these launches are
    comparisons, made before the phase's counts are zeroed)."""
    import torch

    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops.sparse import EllBatch, ell_matvec

    idx, val = batch.indices.contiguous(), batch.values.contiguous()
    table = torch.randn(model.device_num_col(), device=idx.device,
                        generator=torch.Generator(device=idx.device).manual_seed(15))
    out = k1.ell_matvec_cuda(table, idx, val)
    ref = ell_matvec(table, EllBatch(idx, val, None, None))
    g = torch.randn(idx.shape[0], generator=torch.Generator(device=idx.device).manual_seed(16),
                    device=idx.device)
    dw = k1.ell_matvec_dw_cuda(idx, val, g, table.shape[0])
    dw_plain = k1.ell_matvec_grads(table, idx, val, g, need_dval=False)[0]
    scale = torch.zeros_like(table).index_add_(0, idx.long().flatten(),
                                               (val * g[:, None]).abs().flatten())
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=K1_RTOL, atol=K1_ATOL)
    if bool(((dw - dw_plain).abs() > K1_ATOL + K1_RTOL * scale).any()):
        raise AssertionError(f"phase 16: dw differs from its plain version by "
                             f"{float((dw - dw_plain).abs().max())}")
    return {"k1_max_abs_err": float((out - ref).abs().max()),
            "dw_max_abs_err": float((dw - dw_plain).abs().max())}


def _tune_spin(path: str, device) -> dict:
    """Phase 16 (a)'s spin check: 20 steps (groups of 10) fed by an
    autotuned ``DeviceIter(autotune_interval=4)`` enqueued behind a device
    spin of about 2 s (:data:`PIPELINE_SPIN_CYCLES`), with forced knob grows inside the window through the autotuner's
    own knobs: ``prefetch`` + 2 and ``convert_ahead`` + 2 at the 8th call,
    ``convert_ahead`` + 16 (past the ring's slack, so the workers make new
    pinned slots) at the 12th. No call may wait for the card."""
    model, it = _pool_pipeline(path, device, 1, convert_ahead=32, autotune=True,
                               autotune_interval=4)
    model.step(next(it))
    time.sleep(3.0)
    knobs = it.autotuner.knobs
    ring0 = it.stats()["staging_ring"]["depth"]
    steps0 = it.stats()["autotune"]["steps"]
    calls = [0]

    def step():
        calls[0] += 1
        if calls[0] == 8:
            knobs["prefetch"].apply(knobs["prefetch"].get() + 2)
            knobs["convert_ahead"].apply(knobs["convert_ahead"].get() + 2)
        if calls[0] == 12:
            knobs["convert_ahead"].apply(knobs["convert_ahead"].get() + 16)
        model.step(next(it))

    spin = enqueue_behind_spin(step, group=10, spin_cycles=PIPELINE_SPIN_CYCLES)
    time.sleep(1.0)  # the workers fill the wider window
    stats = it.stats()
    it.close()
    return {**spin, "ring_depth_before": ring0, "ring_depth_after": stats["staging_ring"]["depth"],
            "tuner_steps_in_window": stats["autotune"]["steps"] - steps0,
            "knobs_after": stats["autotune"]["knobs"]}


def run_tune_cold(path: str, device) -> dict:
    """Phase 16 (a): cold ELL at ``convert_workers=1``, ``autotune=True``
    (``autotune_interval=16``) against off, epoch by epoch in turns."""
    import torch

    from dmlc_tpu_torch.ops import ell_matvec as k1

    on_model, on_it = _pool_pipeline(path, device, 1, autotune=True,
                                     autotune_interval=TUNE_INTERVAL)
    off_model, off_it = _pool_pipeline(path, device, 1)
    # the kernels against their plain versions on the phase's first batch,
    # from a pipeline of its own (the legs' counts start at 0 below)
    _, probe = _pool_pipeline(path, device, 1)
    checks = _k1_on_batch(on_model, next(probe))
    probe.close()
    legs = {"on": (on_model, on_it, []), "off": (off_model, off_it, [])}
    epochs = []
    k1.launches = k1.dw_launches = 0
    for e in range(TUNE_EPOCHS):
        for side in (("on", "off") if e % 2 == 0 else ("off", "on")):
            model, it, losses = legs[side]
            rec = _tune_epoch(model, it, f"autotune_{side}", e, losses)
            emit({"phase": "autotune_cold_epoch", **rec})
            epochs.append(rec)
    launches, dw_launches = k1.launches, k1.dw_launches
    on_it.close()
    off_it.close()
    same_losses = torch.equal(torch.stack(legs["on"][2]), torch.stack(legs["off"][2]))
    same_weights = (torch.equal(on_model.params.weight, off_model.params.weight)
                    and torch.equal(on_model.params.bias, off_model.params.bias))
    steps = sum(r["batches"] for r in epochs)
    out = {"phase": "autotune_cold", "epochs_a_side": TUNE_EPOCHS,
           "autotune_interval": TUNE_INTERVAL, "convert_workers": 1,
           "first_20_losses_bit_equal": same_losses, "final_weights_bit_equal": same_weights,
           "k1_launches": launches, "dw_launches": dw_launches, "steps": steps, **checks}
    for side in ("on", "off"):
        rates = [r["rows_per_s"] for r in epochs if r["leg"] == f"autotune_{side}"]
        out[f"{side}_rows_per_s"] = rates
    out["on_over_off"] = [a / b for a, b in zip(out["on_rows_per_s"], out["off_rows_per_s"])]
    emit(out)
    if not (same_losses and same_weights and len(legs["on"][2]) == 20):
        raise AssertionError(f"autotune on and off trained to different bits: {out}")
    if launches < steps or dw_launches < steps:
        raise AssertionError(f"phase 16 (a): K1 {launches}, dw {dw_launches} for {steps} steps")
    k1.launches = k1.dw_launches = 0
    spin = _tune_spin(path, device)
    spin.update(phase="autotune_spin", k1_launches=k1.launches, dw_launches=k1.dw_launches)
    emit(spin)
    if not (spin["no_host_sync"] and spin["ring_depth_after"] > spin["ring_depth_before"]
            and spin["tuner_steps_in_window"] >= 4):
        raise AssertionError(f"the autotuned steps behind a spin: {spin}")
    out["spin"] = spin
    out["k1_launches"] += spin["k1_launches"]
    out["dw_launches"] += spin["dw_launches"]
    return out


def run_tune_warm(path: str, tmp: str, device) -> dict:
    """Phase 16 (b): warm device-decode ELL from ``snapshot_read_workers=2``
    with the autotuner, in turns with fixed widths 1 and 2, three epochs
    each over one snapshot; K2 counted around each warm epoch."""
    import torch

    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    snap = os.path.join(tmp, "autotune.snapshot")
    model, it = _pool_pipeline(path, device, 2, snapshot=snap, device_decode=True)
    model.fit_epoch(it)
    it.close()
    legs = {"tuned": _pool_pipeline(path, device, 2, snapshot=snap, device_decode=True,
                                    snapshot_read_workers=2, autotune=True,
                                    autotune_interval=TUNE_INTERVAL),
            "fixed_1": _pool_pipeline(path, device, 2, snapshot=snap, device_decode=True,
                                      snapshot_read_workers=1),
            "fixed_2": _pool_pipeline(path, device, 2, snapshot=snap, device_decode=True,
                                      snapshot_read_workers=2)}
    losses = {k: [] for k in legs}
    epochs, trajectory = [], [2]
    k2 = k1_n = dw_n = batches = 0
    order = list(legs)
    for e in range(TUNE_WARM_EPOCHS):
        for name in order[e % 3:] + order[:e % 3]:
            model, it = legs[name]
            dd.launches = k1.launches = k1.dw_launches = 0
            rec = _tune_epoch(model, it, name, e, losses[name])
            rec["k2_launches"] = dd.launches
            k2, k1_n, dw_n = k2 + dd.launches, k1_n + k1.launches, dw_n + k1.dw_launches
            batches += rec["batches"]
            emit({"phase": "autotune_warm_epoch", **rec})
            epochs.append(rec)
            if rec["k2_launches"] != rec["batches"]:
                raise AssertionError(f"phase 16 (b) {name}: K2 launched {rec['k2_launches']} "
                                     f"times for {rec['batches']} warm batches")
            if name == "tuned":
                trajectory.append(rec["autotune"]["knobs"]["snapshot_read_workers"])
    weights = {k: (m.params.weight, m.params.bias) for k, (m, _) in legs.items()}
    for _, it in legs.values():
        it.close()
    os.remove(snap)
    same = all(torch.equal(torch.stack(losses[k]), torch.stack(losses["tuned"]))
               and torch.equal(weights[k][0], weights["tuned"][0])
               and torch.equal(weights[k][1], weights["tuned"][1]) for k in legs)
    out = {"phase": "autotune_warm", "snapshot_read_workers_trajectory": trajectory,
           "rows_per_s": {k: [r["rows_per_s"] for r in epochs if r["leg"] == k] for k in legs},
           "bits_equal_to_fixed": same, "k2_launches": k2, "k1_launches": k1_n,
           "dw_launches": dw_n, "batches": batches}
    emit(out)
    if not same:
        raise AssertionError(f"phase 16 (b): the tuned warm run differs from the fixed ones")
    return out


def _restart_leg(path: str, device, fail_at) -> dict:
    """A cold ELL epoch over the registry stack's parse fan-out with a
    ``restart_policy``, its split failing once at chunk ``fail_at`` (None:
    never): each batch's hash and the pipeline's resilience counters."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.data.parsers import ParallelTextParser
    from dmlc_tpu_torch.io.resilience import RetryPolicy

    with registry_stack():
        base = create_parser(path, 0, 1, "libsvm", parse_workers=2).base
    parser = ParallelTextParser(base, num_workers=2,
                                restart_policy=RetryPolicy(max_attempts=2, seed=0))
    if fail_at is not None:
        split, real, n = base.source, base.source.next_chunk, [0]

        def next_chunk():
            n[0] += 1
            if n[0] == fail_at:
                raise ConnectionResetError("phase 16 (c): an injected split read reset")
            return real()
        split.next_chunk = next_chunk
    model = LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device, convert_workers=2)
    hashes = []
    for batch in it:
        model.step(batch)
        hashes.append(_bits(list(batch)))
    stats = it.stats()
    it.close()
    return {"hashes": hashes, "resilience": {k: v for k, v in stats["resilience"].items() if v},
            "parse_workers": stats["parse_workers"]}


def run_tune_restart(path: str, device) -> dict:
    """Phase 16 (c): one retryable error of the split under the convert
    pool's source (the parse fan-out's pool, ``restart_policy`` armed),
    mid-epoch: the batches are the clean run's, hash for hash, and the
    pool's restart counter moved."""
    from dmlc_tpu_torch.ops import ell_matvec as k1

    k1.launches = k1.dw_launches = 0
    clean = _restart_leg(path, device, None)
    healed = _restart_leg(path, device, TUNE_FAIL_CHUNK)
    out = {"phase": "autotune_restart", "fail_at_chunk": TUNE_FAIL_CHUNK,
           "batches": len(healed["hashes"]), "same_batches": healed["hashes"] == clean["hashes"],
           "clean_resilience": clean["resilience"], "healed_resilience": healed["resilience"],
           "k1_launches": k1.launches, "dw_launches": k1.dw_launches}
    emit(out)
    if not (out["same_batches"] and len(clean["hashes"]) == HIGGS_ROWS // BATCH
            and healed["resilience"].get("parse_restarts") == 1
            and not clean["resilience"]):
        raise AssertionError(f"phase 16 (c): the healed epoch: {out}")
    return out


def run_autotune(path: str, tmp: str, device) -> dict:
    """Phase 16 (module docstring)."""
    t0 = time.monotonic()
    out = {"cold": run_tune_cold(path, device), "warm": run_tune_warm(path, tmp, device),
           "restart": run_tune_restart(path, device)}
    out["wall_s"] = time.monotonic() - t0
    for key in ("k1_launches", "dw_launches"):
        out[key] = sum(out[leg][key] for leg in ("cold", "warm", "restart"))
    out["k2_launches"] = out["warm"]["k2_launches"]
    emit({"phase": "autotune_total", "wall_s": out["wall_s"], "k1_launches": out["k1_launches"],
          "dw_launches": out["dw_launches"], "k2_launches": out["k2_launches"]})
    return out


# ---------------- phase 17: the tiered artifact store and the split layer ----------------

STORE_SQUEEZE_AT = 64    # phase 17 (b): the warm batch after which the squeeze publishes
LEGACY_SHUFFLE = {"shuffle": True, "num_shuffle_parts": 4, "seed": 3}
# the plan the JAX package's create_parser maps LEGACY_SHUFFLE onto with a
# block cache: shuffle_seed = seed, shuffle_window = LEGACY_SHUFFLE_WINDOW
LEGACY_PLAN = {"shuffle_seed": 3, "window": 4096}


class _Digests:
    """Exact device-side digests of a stream of ELL batches, with no host
    sync: each row's int64 mix of its bit patterns (indices, values, label,
    weight) and each batch's order-sensitive mix of its rows'. Equal
    streams give equal digests; ``rows()`` sorts the row digests, the
    multiset of rows. With ``canonical_zero`` a value's -0.0 digests as
    +0.0 (equal values, not equal bits)."""

    def __init__(self, device, k: int = HIGGS_COLS, canonical_zero: bool = False):
        import torch

        g = torch.Generator(device="cpu").manual_seed(17)
        self._w = torch.randint(1, 1 << 31, (2 * k + 2 + BATCH,), generator=g,
                                dtype=torch.int64).to(device)
        self._k = k
        self._canonical_zero = canonical_zero
        self.batch, self.row = [], []

    def add(self, batch) -> None:
        import torch

        k, w = self._k, self._w
        b = batch.indices.shape[0]
        # -0.0 + 0.0 is +0.0, and every other value is unchanged
        values = batch.values + 0.0 if self._canonical_zero else batch.values
        r = ((batch.indices.to(torch.int64) * w[:k]).sum(1)
             + (values.contiguous().view(torch.int32).to(torch.int64) * w[k:2 * k]).sum(1)
             + batch.label.contiguous().view(torch.int32).to(torch.int64) * w[2 * k]
             + batch.weight.contiguous().view(torch.int32).to(torch.int64) * w[2 * k + 1])
        self.row.append(r)
        self.batch.append((r * w[2 * k + 2: 2 * k + 2 + b]).sum())

    def batches(self):
        import torch

        return torch.stack(self.batch).cpu()

    def rows(self):
        import torch

        return torch.sort(torch.cat(self.row)).values.cpu()


def _store_pipeline(uri: str, device, parser_kw=None, **iter_kw):
    """Phase 3's ELL main path over ``create_parser(uri, **parser_kw)``."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(uri, 0, 1, "libsvm", **(parser_kw or {})),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device, **iter_kw)
    return model, it


def _store_epoch(model, it, leg: str, digests: "_Digests", losses=None, on_batch=None) -> dict:
    """One epoch stepped batch by batch, each batch digested on the card
    (the first 20 losses kept in ``losses``; ``on_batch(n)`` called after
    batch ``n``), timed to a synchronize, then ``reset()``; K1, ``dw`` and
    K2 counted around it."""
    import torch

    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    before = it.stats()
    k1_0, dw_0, k2_0 = k1.launches, k1.dw_launches, dd.launches
    t0 = time.monotonic()
    nb = 0
    for batch in it:
        digests.add(batch)
        loss = model.step(batch)
        if losses is not None and len(losses) < 20:
            losses.append(loss)
        nb += 1
        if on_batch is not None:
            on_batch(nb)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    now = it.stats()
    it.reset()
    return {"leg": leg, "batches": nb, "wall_s": secs, "rows_per_s": nb * BATCH / secs,
            "stall_share": (now["stall_seconds"] - before["stall_seconds"]) / secs,
            "k1_launches": k1.launches - k1_0, "dw_launches": k1.dw_launches - dw_0,
            "k2_launches": dd.launches - k2_0, "snapshot_state": now["snapshot_state"],
            "store": now["store"]}


def _weights(model):
    return (model.params.weight.detach().clone(), model.params.bias.detach().clone())


def _same_weights(a, b) -> bool:
    import torch

    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _launch_gate(rec: dict, leg: str, k2: bool = False, phase: int = 17) -> None:
    if rec["k1_launches"] < rec["batches"] or rec["dw_launches"] < rec["batches"]:
        raise AssertionError(f"phase {phase} {leg}: K1 {rec['k1_launches']}, dw "
                             f"{rec['dw_launches']} for {rec['batches']} steps")
    if k2 and rec["k2_launches"] != rec["batches"]:
        raise AssertionError(f"phase {phase} {leg}: K2 launched {rec['k2_launches']} times "
                             f"for {rec['batches']} warm batches")


def run_store_cachefile(path: str, d: str, device) -> dict:
    """Phase 17 (a): ``create_parser(path#cache)`` -> ``DeviceIter(ell)`` ->
    ``LinearLearner``, two epochs: the first writes the chunk cache, the
    second reads only the cache with the source renamed away; against the
    plain URI on the same engine (the registry stack), two epochs."""
    import torch

    from dmlc_tpu_torch.io import resilience

    cache = os.path.join(d, "higgs.cache")
    with registry_stack():
        plain_model, plain_it = _store_pipeline(path, device)
    # K1 and dw against their plain versions on the phase's first batch,
    # from a pipeline of its own (the legs' counts are taken around them)
    _, probe = _store_pipeline(path, device)
    checks = _k1_on_batch(plain_model, next(probe))
    probe.close()
    res0 = resilience.counters_snapshot()
    plain_losses, plain_dig, plain_recs = [], [], []
    for e in range(2):
        dig = _Digests(device)
        plain_recs.append(_store_epoch(plain_model, plain_it, f"plain_{e}", dig, plain_losses))
        plain_dig.append(dig)
    plain_it.close()
    model, it = _store_pipeline(f"{path}#{cache}", device)
    losses, digs, recs = [], [], []
    for e in range(2):
        dig = _Digests(device)
        recs.append(_store_epoch(model, it, f"cachefile_{e}", dig, losses))
        digs.append(dig)
        if e == 0:
            os.rename(path, path + ".away")  # epoch 2 may read the cache only
    source_gone = not os.path.exists(path)
    it.close()
    # the spin leg: 20 steps of the cache-only epoch, groups of 10
    spin_model, spin_it = _store_pipeline(f"{path}#{cache}", device, convert_ahead=32)
    spin_model.step(next(spin_it))
    time.sleep(3.0)
    from dmlc_tpu_torch.ops import ell_matvec as k1

    k1_0, dw_0 = k1.launches, k1.dw_launches
    spin = enqueue_behind_spin(lambda: spin_model.step(next(spin_it)), group=10,
                               spin_cycles=PIPELINE_SPIN_CYCLES)
    spin.update(k1_launches=k1.launches - k1_0, dw_launches=k1.dw_launches - dw_0)
    spin_it.close()
    os.rename(path + ".away", path)
    res = resilience.counters_delta(res0)
    same_batches = all(torch.equal(a.batches(), b.batches()) for a, b in zip(digs, plain_dig))
    out = {"phase": "store_cachefile", "epochs": recs, "plain_epochs": plain_recs,
           "source_renamed_away_in_epoch_2": source_gone,
           "cache_bytes": os.path.getsize(cache), "corpus_bytes": os.path.getsize(path),
           "batch_hashes_equal": same_batches,
           "first_20_losses_bit_equal": (len(losses) == 20 and torch.equal(
               torch.stack(losses), torch.stack(plain_losses))),
           "final_weights_bit_equal": _same_weights(_weights(model), _weights(plain_model)),
           "cache_rebuilds": res.get("cache_rebuilds", 0),
           "cache_corruptions": res.get("cache_corruptions", 0), **checks,
           "spin": spin}
    emit(out)
    for rec in recs:
        _launch_gate(rec, rec["leg"])
    if not (source_gone and same_batches and out["first_20_losses_bit_equal"]
            and out["final_weights_bit_equal"] and out["cache_rebuilds"] == 0
            and all(r["batches"] == HIGGS_ROWS // BATCH for r in recs)):
        raise AssertionError(f"phase 17 (a): the cached epochs: {out}")
    if not spin["no_host_sync"] or spin["k1_launches"] < spin["calls"]:
        raise AssertionError(f"phase 17 (a): the cached steps behind a spin: {spin}")
    out["plain_digests"] = plain_dig[0]
    out["k1_launches"] = sum(r["k1_launches"] for r in recs) + spin["k1_launches"]
    out["dw_launches"] = sum(r["dw_launches"] for r in recs) + spin["dw_launches"]
    return out


def _squeeze_publish(d: str, name: str) -> float:
    """Publish a small block cache into ``d`` (the budget is enforced on
    publish); returns its wall seconds."""
    from dmlc_tpu_torch.io.block_cache import BlockCacheWriter

    t0 = time.monotonic()
    w = BlockCacheWriter(os.path.join(d, name), signature={"squeeze": name})
    w.add_block({"offset": np.arange(3, dtype=np.int64), "label": np.zeros(2, np.float32)},
                rows=2)
    w.finish()
    return time.monotonic() - t0


def run_store_budget(path: str, d: str, device) -> dict:
    """Phase 17 (b): the three tiers in one directory, a budget that evicts
    the snapshot first, its cold rebuild, then a warm device-decode epoch
    pinned through a squeeze published from another thread."""
    import threading

    import torch

    from dmlc_tpu_torch.io import resilience
    from dmlc_tpu_torch.store import manager as store
    from dmlc_tpu_torch.utils import telemetry

    cache = os.path.join(d, "higgs.cache")
    bc, snap = os.path.join(d, "higgs.bc"), os.path.join(d, "higgs.snapshot")
    kw = {"block_cache": bc, "snapshot": snap}
    model, it = _store_pipeline(path, device, kw, device_decode=True)
    cold_dig, cold_losses = _Digests(device), []
    cold = _store_epoch(model, it, "build_cold", cold_dig, cold_losses)
    it.close()
    sizes = {n: os.path.getsize(os.path.join(d, n))
             for n in ("higgs.cache", "higgs.bc", "higgs.snapshot")}
    store_bytes = cold["store"]["store_bytes"]
    st = store.store_for(snap)
    managed = {e["path"]: e["bytes"] for e in st.entries()}
    # a budget between the two larger artifacts' sum and the total: one
    # eviction, of the cheapest tier to rebuild, makes room
    small = sorted(sizes.values())
    budget = small[1] + small[2] + 4096 + small[0] // 2
    telemetry.reset_decisions()
    res0 = resilience.counters_snapshot()
    with _env({"DMLC_TPU_STORE_BUDGET_BYTES": str(budget)}):
        store.reset_stores()
        t0 = time.monotonic()
        _squeeze_publish(d, "squeeze1.bc")
        evict_s = time.monotonic() - t0
    ledger = [{k: e.get(k) for k in ("action", "trigger", "outcome")}
              for e in telemetry.decisions_snapshot("store")]
    evicted = [n for n in sizes if not os.path.exists(os.path.join(d, n))]
    # the next epoch rebuilds the snapshot cold (from the warm block cache)
    model, it = _store_pipeline(path, device, kw, device_decode=True)
    re_dig, re_losses = _Digests(device), []
    rebuild = _store_epoch(model, it, "rebuild_cold", re_dig, re_losses)
    it.close()
    res1 = resilience.counters_delta(res0)
    rebuilt_same = (torch.equal(re_dig.batches(), cold_dig.batches())
                    and torch.equal(torch.stack(re_losses), torch.stack(cold_losses)))
    # an unsqueezed warm device-decode epoch, then one squeezed in its middle
    warm = {}
    for leg in ("warm", "warm_squeezed"):
        model, it = _store_pipeline(path, device, kw, device_decode=True,
                                    snapshot_read_workers=2)
        dig, losses, squeeze = _Digests(device), [], {}

        def on_batch(n, leg=leg, squeeze=squeeze):
            if leg == "warm_squeezed" and n == STORE_SQUEEZE_AT:
                with _env({"DMLC_TPU_STORE_BUDGET_BYTES": "1"}):
                    t = threading.Thread(
                        target=lambda: squeeze.update(s=_squeeze_publish(d, "squeeze2.bc")))
                    t.start()
                    t.join()
                squeeze["snapshot_survived"] = os.path.exists(snap)

        rec = _store_epoch(model, it, leg, dig, losses, on_batch)
        it.close()
        warm[leg] = (rec, dig, losses, _weights(model), dict(squeeze))
    res2 = resilience.counters_delta(res0)
    w_rec, w_dig, w_losses, w_weights, _ = warm["warm"]
    s_rec, s_dig, s_losses, s_weights, squeeze = warm["warm_squeezed"]
    squeezed_same = (torch.equal(s_dig.batches(), w_dig.batches())
                     and torch.equal(torch.stack(s_losses), torch.stack(w_losses))
                     and _same_weights(s_weights, w_weights))
    out = {"phase": "store_budget", "sizes": sizes, "store_bytes": store_bytes,
           "managed": managed, "budget": budget, "evicted": evicted,
           "evict_publish_s": evict_s, "ledger": ledger, "cold": cold, "rebuild": rebuild,
           "rebuild_bit_equal_to_cold": rebuilt_same,
           "store_rebuilds_after_eviction": res1.get("store_rebuilds_after_eviction", 0),
           "store_evictions_after_budget": res1.get("store_evictions", 0),
           "warm": w_rec, "warm_squeezed": s_rec, "squeeze_s": squeeze.get("s"),
           "snapshot_survived_squeeze": squeeze.get("snapshot_survived"),
           "squeezed_bits_equal_unsqueezed": squeezed_same,
           "store_evictions": res2.get("store_evictions", 0),
           "evicted_by_squeeze": sorted(n for n in ("higgs.cache", "higgs.bc")
                                        if not os.path.exists(os.path.join(d, n)))}
    emit(out)
    if store_bytes != sum(sizes.values()) or managed != sizes:
        raise AssertionError(f"phase 17 (b): store_bytes {store_bytes} against the files "
                             f"{sizes} (manifest {managed})")
    if evicted != ["higgs.snapshot"] or out["store_evictions_after_budget"] != 1:
        raise AssertionError(f"phase 17 (b): the budget evicted {evicted}, not the snapshot")
    if not (rebuilt_same and out["store_rebuilds_after_eviction"] == 1
            and rebuild["snapshot_state"] == "cold" and os.path.exists(snap)):
        raise AssertionError(f"phase 17 (b): the snapshot's rebuild: {out}")
    _launch_gate(cold, "build_cold")
    _launch_gate(rebuild, "rebuild_cold")
    for rec in (w_rec, s_rec):
        _launch_gate(rec, rec["leg"], k2=True)
    if not (squeeze.get("snapshot_survived") and squeezed_same
            and s_rec["snapshot_state"] == "warm" and out["store_evictions"] >= 2):
        raise AssertionError(f"phase 17 (b): the pinned warm epoch through the squeeze: {out}")
    out["k1_launches"] = sum(r["k1_launches"] for r in (cold, rebuild, w_rec, s_rec))
    out["dw_launches"] = sum(r["dw_launches"] for r in (cold, rebuild, w_rec, s_rec))
    out["k2_launches"] = w_rec["k2_launches"] + s_rec["k2_launches"]
    return out


def run_store_shuffle(path: str, d: str, device, plain: "_Digests") -> dict:
    """Phase 17 (c): the split layer's legacy shuffle decorator without a
    block cache (the rows of the plain run, as a multiset), then the same
    keywords with one: the JAX package's DeprecationWarning and plan."""
    import warnings

    import torch

    model, it = _store_pipeline(path, device, dict(LEGACY_SHUFFLE))
    dig = _Digests(device)
    rec = _store_epoch(model, it, "shuffle_decorator", dig)
    it.close()
    same_rows = torch.equal(dig.rows(), plain.rows())
    reordered = not torch.equal(dig.batches(), plain.batches())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, it = _store_pipeline(path, device, dict(LEGACY_SHUFFLE,
                                                       block_cache=os.path.join(d, "shuf.bc")))
    dep = [str(w.message) for w in caught if issubclass(w.category, DeprecationWarning)]
    plan = it.source.plan_state
    mapped = {"shuffle_seed": plan["shuffle_seed"], "window": plan["window"]}
    cached = _store_epoch(model, it, "shuffle_mapped_cold", _Digests(device))
    warm = _store_epoch(model, it, "shuffle_mapped_warm", _Digests(device))
    it.close()
    out = {"phase": "store_shuffle", "decorator": rec, "rows_equal_plain": same_rows,
           "batch_order_differs_from_plain": reordered, "deprecation_warnings": dep,
           "plan": mapped, "plan_expected": LEGACY_PLAN, "mapped_cold": cached,
           "mapped_warm": warm}
    emit(out)
    for r in (rec, cached, warm):
        _launch_gate(r, r["leg"])
    if not (same_rows and rec["batches"] == HIGGS_ROWS // BATCH):
        raise AssertionError(f"phase 17 (c): the shuffled rows differ from the plain run's")
    if len(dep) != 1 or mapped != LEGACY_PLAN:
        raise AssertionError(f"phase 17 (c): the legacy mapping: {dep} {mapped}")
    out["k1_launches"] = sum(r["k1_launches"] for r in (rec, cached, warm))
    out["dw_launches"] = sum(r["dw_launches"] for r in (rec, cached, warm))
    return out


def run_store(path: str, tmp: str, device) -> dict:
    """Phase 17 (module docstring), in a directory of its own. The store's
    byte gauges are cleared first, so ``stats()["store"]["store_bytes"]``
    counts the stores this phase opens."""
    import shutil

    from dmlc_tpu_torch.store import manager as store
    from dmlc_tpu_torch.utils import telemetry

    t0 = time.monotonic()
    d = os.path.join(tmp, "store17")
    os.makedirs(d)
    store.reset_stores()
    telemetry.REGISTRY.clear(telemetry.STORE_BYTES_METRIC)
    out = {"cachefile": run_store_cachefile(path, d, device)}
    out["budget"] = run_store_budget(path, d, device)
    out["shuffle"] = run_store_shuffle(path, d, device, out["cachefile"].pop("plain_digests"))
    shutil.rmtree(d)
    store.reset_stores()
    out["wall_s"] = time.monotonic() - t0
    for key in ("k1_launches", "dw_launches"):
        out[key] = sum(out[leg][key] for leg in ("cachefile", "budget", "shuffle"))
    out["k2_launches"] = out["budget"]["k2_launches"]
    emit({"phase": "store_total", "wall_s": out["wall_s"], "k1_launches": out["k1_launches"],
          "dw_launches": out["dw_launches"], "k2_launches": out["k2_launches"]})
    return out


# ---------------- phase 18: the filesystem registry, the native engines, the row iterators ----------------

MEM_HIGGS = "mem://chip/higgs.libsvm"
REC_BYTES = 64 << 20     # phase 18 (d): the RecordIO corpus's size
REC_MULTI_EVERY = 13     # every this many records holds the magic word (multi-part)


def _plain_pair(rec: dict) -> dict:
    return {"rows_per_s": rec["rows_per_s"], "stall_share": rec["stall_share"]}


def _epochs_equal(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x.batches(), y.batches())
                                    for x, y in zip(a, b))


def _losses_equal(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) == 20 and torch.equal(torch.stack(a), torch.stack(b))


class _DigestPair:
    """Both digests of an epoch: of the bits, and of the values
    (``canonical_zero``)."""

    def __init__(self, device):
        self.bits, self.values = _Digests(device), _Digests(device, canonical_zero=True)

    def add(self, batch) -> None:
        self.bits.add(batch)
        self.values.add(batch)


def _run_epochs(model, it, legs: list, losses: list) -> tuple:
    """One epoch per leg name, each digested (bits and values); returns
    (records, bit digests, value digests)."""
    recs, pairs = [], []
    for leg in legs:
        pair = _DigestPair(it.device)
        recs.append(_store_epoch(model, it, leg, pair, losses))
        pairs.append(pair)
    return recs, [p.bits for p in pairs], [p.values for p in pairs]


def run_host_mem(path: str, tmp: str, device) -> dict:
    """Phase 18 (a): phase 3's corpus under ``mem://`` through the chunk
    feeder (``create_parser`` builds ``NativeFeedParser``) -> ``DeviceIter
    (ell)`` -> ``LinearLearner``, two epochs, against the fused native
    reader on the local file; a snapshot written over the ``mem://`` source
    and one warm ``device_decode=True`` epoch from it; 20 steps behind a
    spin."""
    from dmlc_tpu_torch.io.filesystem import MemoryFileSystem
    from dmlc_tpu_torch.io.stream import write_all

    t0 = time.monotonic()
    with open(path, "rb") as f:
        write_all(MEM_HIGGS, f.read())
    load_s = time.monotonic() - t0
    # the fused reader on the local file: the plain local run
    plain_model, plain_it = _store_pipeline(path, device)
    plain_class = type(plain_it.source).__name__
    plain_losses = []
    plain_recs, plain_digs, _ = _run_epochs(plain_model, plain_it, ["local_0", "local_1"],
                                            plain_losses)
    plain_it.close()
    # K1 and dw against their plain versions on a batch of the leg's own pipeline
    _, probe = _store_pipeline(MEM_HIGGS, device)
    checks = _k1_on_batch(plain_model, next(probe))
    probe.close()
    model, it = _store_pipeline(MEM_HIGGS, device)
    feed_class = type(it.source).__name__
    losses = []
    recs, digs, _ = _run_epochs(model, it, ["mem_0", "mem_1"], losses)
    it.close()
    # a snapshot over the mem:// source: a cold epoch writes it, a warm one
    # decodes it on the card
    snap = os.path.join(tmp, "mem_higgs.snapshot")
    snap_model, snap_it = _store_pipeline(MEM_HIGGS, device, {"snapshot": snap},
                                          device_decode=True)
    snap_recs, snap_digs, _ = _run_epochs(snap_model, snap_it, ["mem_snapshot_cold",
                                                                "mem_snapshot_warm"], [])
    snap_it.close()
    # the spin leg: 20 steps of the mem:// pipeline, groups of 10
    spin_model, spin_it = _store_pipeline(MEM_HIGGS, device, convert_ahead=32)
    spin_model.step(next(spin_it))
    time.sleep(3.0)
    from dmlc_tpu_torch.ops import ell_matvec as k1

    k1_0, dw_0 = k1.launches, k1.dw_launches
    spin = enqueue_behind_spin(lambda: spin_model.step(next(spin_it)), group=10,
                               spin_cycles=PIPELINE_SPIN_CYCLES)
    spin.update(k1_launches=k1.launches - k1_0, dw_launches=k1.dw_launches - dw_0)
    spin_it.close()
    MemoryFileSystem.reset()
    os.remove(snap)
    out = {"phase": "host_mem", "load_mem_s": load_s, "parser": feed_class,
           "plain_parser": plain_class, "epochs": recs, "plain_epochs": plain_recs,
           "plain_local": _plain_pair(plain_recs[-1]),
           "batch_hashes_equal": _epochs_equal(digs, plain_digs),
           "first_20_losses_bit_equal": _losses_equal(losses, plain_losses),
           "final_weights_bit_equal": _same_weights(_weights(model), _weights(plain_model)),
           "snapshot_epochs": snap_recs,
           "warm_batches_equal_cold": _epochs_equal(snap_digs[1:], snap_digs[:1]),
           "warm_batches_equal_local": _epochs_equal(snap_digs[1:], plain_digs[:1]),
           **checks, "spin": spin}
    emit(out)
    if feed_class != "NativeFeedParser" or plain_class != "NativeStreamParser":
        raise AssertionError(f"phase 18 (a): the parsers: {feed_class}, {plain_class}")
    for rec in recs + plain_recs + snap_recs[:1]:
        _launch_gate(rec, rec["leg"], phase=18)
    _launch_gate(snap_recs[1], "mem_snapshot_warm", k2=True, phase=18)
    if not (out["batch_hashes_equal"] and out["first_20_losses_bit_equal"]
            and out["final_weights_bit_equal"] and out["warm_batches_equal_cold"]
            and snap_recs[1]["snapshot_state"] == "warm"
            and all(r["batches"] == HIGGS_ROWS // BATCH for r in recs + snap_recs)):
        raise AssertionError(f"phase 18 (a): the mem:// epochs: {out}")
    if not spin["no_host_sync"] or spin["k1_launches"] < spin["calls"]:
        raise AssertionError(f"phase 18 (a): the mem:// steps behind a spin: {spin}")
    out["k1_launches"] = (sum(r["k1_launches"] for r in recs + plain_recs + snap_recs)
                          + spin["k1_launches"])
    out["dw_launches"] = (sum(r["dw_launches"] for r in recs + plain_recs + snap_recs)
                          + spin["dw_launches"])
    out["k2_launches"] = snap_recs[1]["k2_launches"]
    out["plain_digests"] = plain_digs
    return out


@contextlib.contextmanager
def _counted(cls, name: str, counts: dict):
    """Count the calls of ``cls.name`` inside the block (restored after)."""
    orig = getattr(cls, name)

    def wrapper(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return orig(*args, **kw)

    setattr(cls, name, wrapper)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def run_host_batch(path: str, tmp: str, device, plain: dict) -> dict:
    """Phase 18 (b): ``engine="native-batch"`` with ``block_cache=``: a cold
    epoch builds the cache through ``add_block_encoded``, a warm one reads
    it through ``block_encoded``; against the registry stack's Python
    engine (``engine="python"``), two epochs over a block cache of its own
    (the engine's parse runs once)."""
    from dmlc_tpu_torch.data.batch_parser import NativeBatchParser
    from dmlc_tpu_torch.io.block_cache import BlockCacheReader, BlockCacheWriter

    # the Python engine's run: its first epoch parses (about 40 k rows/s)
    # and writes a block cache of its own, which serves its second
    py_bc = os.path.join(tmp, "higgs_python.bc")
    py_model, py_it = _store_pipeline(path, device, {"engine": "python", "block_cache": py_bc})
    py_losses = []
    py_recs, py_bits, py_values = _run_epochs(py_model, py_it, ["python_cold", "python_warm"],
                                              py_losses)
    py_it.close()
    os.remove(py_bc)
    bc = os.path.join(tmp, "higgs_batch.bc")
    counts = {}
    model, it = _store_pipeline(path, device, {"engine": "native-batch", "block_cache": bc})
    losses = []
    with _counted(BlockCacheWriter, "add_block_encoded", counts), \
            _counted(BlockCacheWriter, "add_block", counts), \
            _counted(BlockCacheReader, "block_encoded", counts):
        cold_dig, warm_dig = _DigestPair(device), _DigestPair(device)
        cold = _store_epoch(model, it, "batch_cold", cold_dig, losses)
        built = (type(it.source).__name__, type(it.source._base).__name__,
                 type(getattr(it.source._base, "base", None)).__name__)
        warm = _store_epoch(model, it, "batch_warm", warm_dig, losses)
    it.close()
    cache_bytes = os.path.getsize(bc)
    os.remove(bc)
    out = {"phase": "host_batch", "parser": built, "epochs": [cold, warm],
           "python_epochs": py_recs, "plain_local": _plain_pair(plain["plain_local"]),
           "calls": counts, "cache_bytes": cache_bytes,
           # the native scanners read "-0.000000" as +0.0 where numpy reads
           # -0.0, in both packages: the Python engine's batches are the
           # same values, and the fused reader's the same bits
           "batch_values_equal_python": _epochs_equal([cold_dig.values, warm_dig.values],
                                                      py_values),
           "batch_bits_equal_python": _epochs_equal([cold_dig.bits, warm_dig.bits], py_bits),
           "batch_hashes_equal_local": _epochs_equal([cold_dig.bits, warm_dig.bits],
                                                     plain["plain_digests"]),
           "first_20_losses_bit_equal": _losses_equal(losses[:20], py_losses[:20]),
           "final_weights_bit_equal": _same_weights(_weights(model), _weights(py_model))}
    emit(out)
    if built[0] != "BlockCacheIter" or built[2] != NativeBatchParser.__name__:
        raise AssertionError(f"phase 18 (b): the chain built {built}")
    for rec in (cold, warm) + tuple(py_recs):
        _launch_gate(rec, rec["leg"], phase=18)
    # every cold block went to the cache as its span, every warm block came
    # back as one
    if not (counts.get("add_block_encoded", 0) > 0 and counts.get("add_block", 0) == 0
            and counts.get("block_encoded") == counts["add_block_encoded"]):
        raise AssertionError(f"phase 18 (b): the encoded span paths: {counts}")
    if not (out["batch_values_equal_python"] and out["batch_hashes_equal_local"]
            and out["first_20_losses_bit_equal"] and out["final_weights_bit_equal"]):
        raise AssertionError(f"phase 18 (b): the native-batch epochs: {out}")
    out["k1_launches"] = sum(r["k1_launches"] for r in (cold, warm) + tuple(py_recs))
    out["dw_launches"] = sum(r["dw_launches"] for r in (cold, warm) + tuple(py_recs))
    return out


def _rows_pipeline(src, device):
    from dmlc_tpu_torch import DeviceIter, LinearLearner

    model = LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(src, num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device)
    return model, it


def run_host_rows(path: str, tmp: str, device, plain: dict) -> dict:
    """Phase 18 (c): ``create_row_block_iter(path#pages)`` -> ``DiskRowIter``
    as ``DeviceIter``'s source: epoch 1 over the pages it built, epoch 2
    from a new iterator over the pages with the source renamed away;
    against a ``BasicRowIter`` run (the corpus in memory), two epochs."""
    from dmlc_tpu_torch.data.iterators import create_row_block_iter

    t0 = time.monotonic()
    basic = create_row_block_iter(path, silent=True)
    basic_load_s = time.monotonic() - t0
    classes = [type(basic).__name__]
    b_model, b_it = _rows_pipeline(basic, device)
    b_losses = []
    b_recs, b_digs, _ = _run_epochs(b_model, b_it, ["basic_0", "basic_1"], b_losses)
    b_it.close()
    del basic, b_it
    pages = os.path.join(tmp, "higgs.pages")
    t0 = time.monotonic()
    disk = create_row_block_iter(f"{path}#{pages}", silent=True)
    build_s = time.monotonic() - t0
    classes.append(type(disk).__name__)
    model, it = _rows_pipeline(disk, device)
    losses = []
    d0, dig0, _ = _run_epochs(model, it, ["pages_0"], losses)
    it.close()
    os.rename(path, path + ".away")  # the pages alone serve epoch 2
    try:
        again = create_row_block_iter(f"{path}#{pages}", silent=True)
        classes.append(type(again).__name__)
        it = _rows_pipeline(again, device)[1]
        d1, dig1, _ = _run_epochs(model, it, ["pages_1"], losses)
        it.close()
    finally:
        os.rename(path + ".away", path)
    page_bytes = os.path.getsize(pages)
    os.remove(pages)
    recs = d0 + d1
    out = {"phase": "host_rows", "iterators": classes, "basic_load_s": basic_load_s,
           "pages_build_s": build_s, "page_file_bytes": page_bytes,
           "corpus_bytes": os.path.getsize(path), "epochs": recs, "basic_epochs": b_recs,
           "plain_local": _plain_pair(plain["plain_local"]),
           "batch_hashes_equal": _epochs_equal(dig0 + dig1, b_digs),
           "batch_hashes_equal_local": _epochs_equal(dig0 + dig1, plain["plain_digests"]),
           "first_20_losses_bit_equal": _losses_equal(losses[:20], b_losses[:20]),
           "final_weights_bit_equal": _same_weights(_weights(model), _weights(b_model))}
    emit(out)
    if classes != ["BasicRowIter", "DiskRowIter", "DiskRowIter"]:
        raise AssertionError(f"phase 18 (c): the iterators: {classes}")
    for rec in recs + b_recs:
        _launch_gate(rec, rec["leg"], phase=18)
    if not (out["batch_hashes_equal"] and out["first_20_losses_bit_equal"]
            and out["final_weights_bit_equal"]):
        raise AssertionError(f"phase 18 (c): the page-cache epochs: {out}")
    out["k1_launches"] = sum(r["k1_launches"] for r in recs + b_recs)
    out["dw_launches"] = sum(r["dw_launches"] for r in recs + b_recs)
    return out


def write_recordio_corpus(path: str, seed: int) -> dict:
    """About :data:`REC_BYTES` of RecordIO: records of 1 byte to 32 KiB,
    every :data:`REC_MULTI_EVERY`-th holding the magic word (the writer
    splits it into a multi-part record), and its index at ``path.idx``."""
    from dmlc_tpu_torch.io.recordio import RECORDIO_MAGIC, write_indexed_recordio

    rng = np.random.default_rng(seed)
    magic = RECORDIO_MAGIC.to_bytes(4, "little")
    blob = rng.bytes(REC_BYTES)
    recs, pos, i = [], 0, 0
    while pos < len(blob) - (32 << 10):
        n = int(rng.integers(1, 32 << 10))
        rec = blob[pos:pos + n]
        if i % REC_MULTI_EVERY == 0:
            rec = rec[: n // 2] + magic + rec[n // 2:]
        recs.append(rec)
        pos += n
        i += 1
    with open(path, "wb") as data, open(path + ".idx", "wb") as idx:
        write_indexed_recordio(data, idx, recs)
    return {"records": len(recs), "bytes": os.path.getsize(path),
            "multi_part": sum(1 for r in recs if magic in r),
            "digest": _records_digest(recs)}


def _records_digest(records) -> list:
    import zlib

    return [(len(r), zlib.crc32(r)) for r in records]


def _drain_records(split) -> tuple:
    t0 = time.monotonic()
    out = [bytes(r) for r in split.iter_records()]
    secs = time.monotonic() - t0
    split.close()
    return out, secs


def run_host_recordio(tmp: str, seed: int) -> dict:
    """Phase 18 (d), host only: a RecordIO corpus of about 64 MB with its
    index through ``NativeRecordIOSplit``, the shuffled
    ``NativeIndexedRecordIOSplit`` and ``NativeFeedRecordIOSplit`` (the same
    bytes under ``mem://``), each against the Python splitter; records/s."""
    from dmlc_tpu_torch.io import create_input_split
    from dmlc_tpu_torch.io.filesystem import MemoryFileSystem
    from dmlc_tpu_torch.io.stream import write_all

    path = os.path.join(tmp, "corpus.rec")
    corpus = write_recordio_corpus(path, seed)
    want = corpus.pop("digest")
    with open(path, "rb") as f:
        write_all("mem://chip/corpus.rec", f.read())
    legs = {  # name: (uri, type, keywords, registry-stack keywords)
        "recordio": (path, "recordio", {}),
        "indexed_shuffled": (path, "indexed_recordio",
                             {"index_uri": path + ".idx", "shuffle": True, "seed": 5}),
        "feed_mem": ("mem://chip/corpus.rec", "recordio", {}),
    }
    out = {"phase": "host_recordio", **corpus, "legs": {}}
    ok = True
    for name, (uri, type_, kw) in legs.items():
        native_split = create_input_split(uri, 0, 1, type_, **kw)
        cls = type(native_split).__name__
        got, secs = _drain_records(native_split)
        with registry_stack():
            py_split = create_input_split(uri, 0, 1, type_, **kw)
        py_cls = type(py_split).__name__
        ref, py_secs = _drain_records(py_split)
        shuffled = kw.get("shuffle", False)
        same = (sorted(_records_digest(got)) == sorted(_records_digest(ref)) == sorted(want)
                if shuffled else _records_digest(got) == _records_digest(ref) == want)
        out["legs"][name] = {"split": cls, "python_split": py_cls, "records": len(got),
                             "records_equal": same, "records_per_s": len(got) / secs,
                             "python_records_per_s": len(ref) / py_secs,
                             "mb_per_s": corpus["bytes"] / secs / 1e6}
        ok = ok and same
    MemoryFileSystem.reset()
    emit(out)
    classes = {k: v["split"] for k, v in out["legs"].items()}
    if classes != {"recordio": "NativeRecordIOSplit",
                   "indexed_shuffled": "NativeIndexedRecordIOSplit",
                   "feed_mem": "NativeFeedRecordIOSplit"} or not ok:
        raise AssertionError(f"phase 18 (d): the RecordIO engines: {out}")
    return out


def run_host_io(path: str, tmp: str, device, seed: int) -> dict:
    """Phase 18 (module docstring), in a directory of its own."""
    import shutil

    t0 = time.monotonic()
    d = os.path.join(tmp, "hostio18")
    os.makedirs(d)
    out = {"mem": run_host_mem(path, d, device)}
    out["batch"] = run_host_batch(path, d, device, out["mem"])
    out["rows"] = run_host_rows(path, d, device, out["mem"])
    out["mem"].pop("plain_digests")
    out["recordio"] = run_host_recordio(d, seed)
    shutil.rmtree(d)
    out["wall_s"] = time.monotonic() - t0
    for key in ("k1_launches", "dw_launches"):
        out[key] = sum(out[leg][key] for leg in ("mem", "batch", "rows"))
    out["k2_launches"] = out["mem"]["k2_launches"]
    emit({"phase": "host_io_total", "wall_s": out["wall_s"], "k1_launches": out["k1_launches"],
          "dw_launches": out["dw_launches"], "k2_launches": out["k2_launches"]})
    return out


# ---------------- phase 19: the cloud filesystems ----------------

CLOUD_S3 = "s3://bench/higgs.libsvm"
CLOUD_CUT_ROWS = 1 << 16   # (b)-(d): the corpus cut for the other protocols
CLOUD_CKPT_AT = 3          # (d): batches of the cut before the checkpoint
CLOUD_UPLOAD_PIECE = 8 << 20
CLOUD_LIMIT_S = 60.0       # phase 19's wall time, the fake's start to its stop
CLOUD_SLOW_S = 5.0         # an attempt (urlopen to its response's headers) this long is logged
CLOUD_BURST = 64           # concurrent connections of the burst probe against one server
CLOUD_BURST_LIMIT_S = 5.0  # the slowest of them, at most
CLOUD_FAULTS = [  # (c): served at the n-th Range GET of an s3:// epoch
    {"proto": "s3", "action": "503", "at": 3},
    {"proto": "s3", "action": "429", "at": 7, "retry_after": "0.05"},
    {"proto": "s3", "action": "reset", "at": 12},
]


class _FakeCloudChild:
    """``dmlc_tpu_torch/testing/fake_cloud.py`` in a child process of its
    own (its own interpreter lock, standard library only, started with
    ``subprocess``: no fork after CUDA is up), serving S3, GCS, WebHDFS,
    Azure and plain HTTP from its memory on 127.0.0.1, each server on a
    listen backlog of ``backlog`` (the fake's default when None); stopped
    by :meth:`close`."""

    def __init__(self, d: str, backlog=None):
        script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dmlc_tpu_torch",
                              "testing", "fake_cloud.py")
        self.err_path = os.path.join(d, "fake_cloud.err")
        self._err = open(self.err_path, "w")
        argv = [sys.executable, script] + ([] if backlog is None else ["--backlog", str(backlog)])
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=self._err, text=True)
        line = self.proc.stdout.readline()
        if not line:
            self.close()
            raise AssertionError(f"phase 19: the fake cloud did not start: {self.stderr()}")
        info = json.loads(line)
        self.env, self.control, self.ports = info["env"], info["control"], info["ports"]

    def _call(self, method: str, path: str, body: bytes = b"") -> dict:
        import urllib.request

        req = urllib.request.Request(self.control + path, data=body or None, method=method)
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read() or b"{}")

    def put(self, proto: str, key: str, data: bytes) -> None:
        import urllib.parse

        self._call("PUT", "/put?" + urllib.parse.urlencode({"proto": proto, "key": key}), data)

    def faults(self, rules: list) -> None:
        self._call("POST", "/clear_faults")
        self._call("POST", "/faults", json.dumps(rules).encode())

    def stats(self) -> dict:
        return self._call("GET", "/stats")

    def stderr(self) -> str:
        self._err.flush()
        with open(self.err_path) as f:
            return f.read()[-2000:]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self.proc.stdout.close()
        self._err.close()


class _AttemptLog:
    """Every urllib attempt of phase 19, timed from the call of
    ``urllib.request.urlopen`` (which every cloud member, the feed thread
    and the fake's control calls make) to its response's headers, where a
    connection that no server accepts waits; while the block is open.
    Each attempt of :data:`CLOUD_SLOW_S` or more is printed on a line of
    its own with its method, path and start time."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.attempts = 0
        self.slow = []

    def __enter__(self) -> "_AttemptLog":
        import urllib.parse
        import urllib.request

        self._urlopen = urlopen = urllib.request.urlopen

        def timed(req, *args, **kw):
            start, t0 = time.time(), time.monotonic()
            outcome = "ok"
            try:
                return urlopen(req, *args, **kw)
            except BaseException as exc:
                outcome = type(exc).__name__
                raise
            finally:
                secs = time.monotonic() - t0
                with self.lock:
                    self.attempts += 1
                if secs >= CLOUD_SLOW_S:
                    url = req.full_url if hasattr(req, "full_url") else str(req)
                    rec = {"phase": "cloud_slow_attempt",
                           "method": req.get_method() if hasattr(req, "get_method") else "GET",
                           "path": urllib.parse.urlsplit(url).path,
                           "port": urllib.parse.urlsplit(url).port, "start_unix": start,
                           "seconds": secs, "outcome": outcome}
                    with self.lock:
                        self.slow.append(rec)
                    emit(rec)

        urllib.request.urlopen = timed
        return self

    def __exit__(self, *exc) -> None:
        import urllib.request

        urllib.request.urlopen = self._urlopen


def burst_probe(cloud: "_FakeCloudChild", n: int = CLOUD_BURST, timeout: float = 30.0) -> dict:
    """``n`` Range GETs opened at once (a barrier) against the fake's plain
    HTTP server: each one's seconds, the failures, and the server's
    connections accepted and served over the burst."""
    import threading
    import urllib.request

    cloud.put("http", "/burst.bin", bytes(range(256)) * 16)
    url = f"http://127.0.0.1:{cloud.ports['http']}/burst.bin"
    before = cloud.stats()["connections"]["http"]
    barrier = threading.Barrier(n)

    def one(_):
        barrier.wait()
        t0 = time.monotonic()
        try:
            req = urllib.request.Request(url, headers={"Range": "bytes=0-1023"})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                ok = len(resp.read()) == 1024
        except OSError:
            ok = False
        return time.monotonic() - t0, ok

    t0 = time.monotonic()
    with ThreadPoolExecutor(n) as ex:
        got = list(ex.map(one, range(n)))
    wall = time.monotonic() - t0
    after = cloud.stats()["connections"]["http"]
    secs = sorted(t for t, _ in got)
    return {"connections": n, "backlog": after["backlog"], "wall_s": wall,
            "max_s": secs[-1], "median_s": statistics.median(secs),
            "over_1s": sum(t > 1.0 for t in secs),
            "over_slow_s": sum(t >= CLOUD_SLOW_S for t in secs),
            "failed": sum(not ok for _, ok in got),
            "accepted": after["accepted"] - before["accepted"],
            "served": after["served"] - before["served"]}


def _range_sweep(uri: str, piece: int = 1 << 20) -> dict:
    """One pass of Range GETs over ``uri`` with no parse: the client's and
    the fake's pace without the pipeline."""
    from dmlc_tpu_torch.io.stream import open_stream

    t0 = time.monotonic()
    n = 0
    with open_stream(uri) as f:
        while True:
            data = f.read(piece)
            if not data:
                break
            n += len(data)
    secs = time.monotonic() - t0
    return {"bytes": n, "seconds": secs, "mb_per_s": n / secs / 1e6}


def _cut_bytes(path: str, rows: int) -> bytes:
    with open(path, "rb") as f:
        return b"".join(f.readline() for _ in range(rows))


def _one_epoch(uri: str, device, leg: str) -> tuple:
    """A fresh learner's one epoch over ``uri``: (record, digests, losses,
    weights, parser class)."""
    model, it = _store_pipeline(uri, device)
    parser = type(it.source).__name__
    dig, losses = _Digests(device), []
    rec = _store_epoch(model, it, leg, dig, losses)
    it.close()
    return rec, dig, losses, _weights(model), parser


def _same_losses(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) > 0 and torch.equal(torch.stack(a), torch.stack(b))


class _RowDigests(_Digests):
    """:class:`_Digests` of the rows a batch really holds (weight not 0):
    the rows of a short last batch without its padding."""

    def add(self, batch) -> None:
        super().add(batch)
        self.row[-1] = self.row[-1][batch.weight != 0]


def run_cloud_s3(path: str, cloud: "_FakeCloudChild", d: str, device) -> dict:
    """Phase 19 (a): phase 3's corpus uploaded through the port's multipart
    write stream, then ``create_parser("s3://...")`` (``NativeFeedParser``)
    -> ``DeviceIter(ell)`` at 2 convert workers -> ``LinearLearner``, two
    epochs, against the fused native reader on the local file; a snapshot
    over the ``s3://`` source (cold, then warm with K2); 20 steps behind a
    spin; one Range-GET sweep with no parse."""
    from dmlc_tpu_torch.io import resilience as res
    from dmlc_tpu_torch.io.stream import open_stream
    from dmlc_tpu_torch.ops import ell_matvec as k1

    t0 = time.monotonic()
    with open(path, "rb") as f:
        corpus = memoryview(f.read())
    read_s = time.monotonic() - t0
    base = res.counters_snapshot()
    write_s = []  # a write of CLOUD_UPLOAD_PIECE bytes: one part's upload
    t0 = time.monotonic()
    with open_stream(CLOUD_S3, "w") as dst:
        for at in range(0, len(corpus), CLOUD_UPLOAD_PIECE):
            t1 = time.monotonic()
            dst.write(corpus[at:at + CLOUD_UPLOAD_PIECE])
            write_s.append(time.monotonic() - t1)
    upload_s = time.monotonic() - t0
    upload_counters = {k: v for k, v in res.counters_delta(base).items()
                       if k in ("attempts", "retries", "giveups", "fatal")}
    del corpus
    stats = cloud.stats()
    parts = sum(len(u["parts"]) for u in stats["uploads"].values())
    sweep = _range_sweep(CLOUD_S3)
    plain_model, plain_it = _store_pipeline(path, device)
    plain_class = type(plain_it.source).__name__
    plain_losses = []
    plain_recs, plain_digs, _ = _run_epochs(plain_model, plain_it, ["local_0", "local_1"],
                                            plain_losses)
    plain_it.close()
    _, probe = _store_pipeline(CLOUD_S3, device)
    checks = _k1_on_batch(plain_model, next(probe))
    probe.close()
    model, it = _store_pipeline(CLOUD_S3, device, convert_workers=2)
    feed_class = type(it.source).__name__
    losses = []
    recs, digs, _ = _run_epochs(model, it, ["s3_0", "s3_1"], losses)
    it.close()
    snap = os.path.join(d, "s3_higgs.snapshot")
    snap_model, snap_it = _store_pipeline(CLOUD_S3, device, {"snapshot": snap},
                                          device_decode=True)
    snap_recs, snap_digs, _ = _run_epochs(snap_model, snap_it, ["s3_snapshot_cold",
                                                                "s3_snapshot_warm"], [])
    snap_it.close()
    os.remove(snap)
    spin_model, spin_it = _store_pipeline(CLOUD_S3, device, convert_ahead=32)
    spin_model.step(next(spin_it))
    time.sleep(3.0)
    k1_0, dw_0 = k1.launches, k1.dw_launches
    spin = enqueue_behind_spin(lambda: spin_model.step(next(spin_it)), group=10,
                               spin_cycles=PIPELINE_SPIN_CYCLES)
    spin.update(k1_launches=k1.launches - k1_0, dw_launches=k1.dw_launches - dw_0)
    spin_it.close()
    out = {"phase": "cloud_s3", "uri": CLOUD_S3, "corpus_read_s": read_s, "upload_s": upload_s,
           "upload_parts": parts, "upload_mb_per_s": os.path.getsize(path) / upload_s / 1e6,
           "upload_write_s": {"max": max(write_s), "median": statistics.median(write_s),
                              "over_1s": sum(w > 1.0 for w in write_s)},
           "upload_counters": upload_counters, "upload_requests": {
               k: v for k, v in stats["requests"].items() if k.startswith("s3.")},
           "range_sweep": sweep,
           "parser": feed_class, "plain_parser": plain_class, "epochs": recs,
           "plain_epochs": plain_recs, "plain_local": _plain_pair(plain_recs[-1]),
           "batch_hashes_equal": _epochs_equal(digs, plain_digs),
           "first_20_losses_bit_equal": _losses_equal(losses, plain_losses),
           "final_weights_bit_equal": _same_weights(_weights(model), _weights(plain_model)),
           "snapshot_epochs": snap_recs,
           "warm_batches_equal_cold": _epochs_equal(snap_digs[1:], snap_digs[:1]),
           "warm_batches_equal_local": _epochs_equal(snap_digs[1:], plain_digs[:1]),
           **checks, "spin": spin}
    emit(out)
    if upload_counters.get("retries"):
        # a request to the fake on this host answers in milliseconds: a
        # retry is a request that failed or hung for a whole attempt
        raise AssertionError(f"phase 19 (a): the upload retried: {upload_counters}")
    if feed_class != "NativeFeedParser" or plain_class != "NativeStreamParser":
        raise AssertionError(f"phase 19 (a): the parsers: {feed_class}, {plain_class}")
    if parts < 2:
        raise AssertionError(f"phase 19 (a): the upload took {parts} parts, not a multipart")
    for rec in recs + plain_recs + snap_recs[:1]:
        _launch_gate(rec, rec["leg"], phase=19)
    _launch_gate(snap_recs[1], "s3_snapshot_warm", k2=True, phase=19)
    if not (out["batch_hashes_equal"] and out["first_20_losses_bit_equal"]
            and out["final_weights_bit_equal"] and out["warm_batches_equal_cold"]
            and snap_recs[1]["snapshot_state"] == "warm"
            and all(r["batches"] == HIGGS_ROWS // BATCH for r in recs + snap_recs)):
        raise AssertionError(f"phase 19 (a): the s3:// epochs: {out}")
    if not spin["no_host_sync"] or spin["k1_launches"] < spin["calls"]:
        raise AssertionError(f"phase 19 (a): the s3:// steps behind a spin: {spin}")
    out["k1_launches"] = (sum(r["k1_launches"] for r in recs + plain_recs + snap_recs)
                          + spin["k1_launches"])
    out["dw_launches"] = (sum(r["dw_launches"] for r in recs + plain_recs + snap_recs)
                          + spin["dw_launches"])
    out["k2_launches"] = snap_recs[1]["k2_launches"]
    return out


def run_cloud_cut(path: str, cloud: "_FakeCloudChild", d: str, device) -> dict:
    """Phase 19 (b): the corpus cut to :data:`CLOUD_CUT_ROWS` rows, written
    through the port's own write streams (the media upload, the two-step
    WebHDFS create, the Azure block list, the S3 multipart) and served to
    one epoch each on ``http://``, ``gs://``, ``hdfs://``, ``azure://`` and
    ``s3://``, bit-equal to the fused reader's epoch on the same cut; a
    two-file ``s3://bench/parts/`` directory read at ``num_parts=2``."""
    import torch

    from dmlc_tpu_torch import DeviceIter, create_parser
    from dmlc_tpu_torch.io.stream import write_all

    cut = _cut_bytes(path, CLOUD_CUT_ROWS)
    local = os.path.join(d, "higgs_cut.libsvm")
    with open(local, "wb") as f:
        f.write(cut)
    uris = {"http": f"http://127.0.0.1:{cloud.ports['http']}/bench/higgs_cut.libsvm",
            "gs": "gs://bench/higgs_cut.libsvm", "hdfs": "hdfs://nn/bench/higgs_cut.libsvm",
            "azure": "azure://bench/higgs_cut.libsvm", "s3": "s3://bench/cut/higgs_cut.libsvm"}
    t0 = time.monotonic()
    cloud.put("http", "/bench/higgs_cut.libsvm", cut)
    for proto in ("gs", "hdfs", "azure", "s3"):
        write_all(uris[proto], cut)
    write_s = time.monotonic() - t0
    stats = cloud.stats()
    ref_rec, ref_dig, ref_losses, ref_w, ref_class = _one_epoch(local, device, "local_cut")
    legs, equal = {}, {}
    for proto, uri in uris.items():
        rec, dig, losses, w, parser = _one_epoch(uri, device, f"{proto}_cut")
        _launch_gate(rec, rec["leg"], phase=19)
        legs[proto] = {**rec, "parser": parser, "dig": dig, "losses": losses, "weights": w}
        equal[proto] = (parser == "NativeFeedParser" and rec["batches"] == ref_rec["batches"]
                        and torch.equal(dig.batches(), ref_dig.batches())
                        and _same_losses(losses, ref_losses) and _same_weights(w, ref_w))
    # two files under s3://bench/parts/, read as two parts
    half = cut.rfind(b"\n", 0, len(cut) // 2) + 1
    write_all("s3://bench/parts/part-0.libsvm", cut[:half])
    write_all("s3://bench/parts/part-1.libsvm", cut[half:])
    rows = _RowDigests(device)
    part_rows, part_classes = [], []
    for part in range(2):
        parser = create_parser("s3://bench/parts/", part, 2, "libsvm")
        part_classes.append(type(parser).__name__)
        it = DeviceIter(parser, num_col=HIGGS_COLS, batch_size=BATCH, layout="ell",
                        max_nnz=HIGGS_COLS, drop_remainder=False, device=device)
        for batch in it:
            rows.add(batch)
        it.close()
        part_rows.append(int(sum(r.numel() for r in rows.row)) - sum(part_rows))
    ref_rows = _RowDigests(device)
    it = DeviceIter(create_parser(local, 0, 1, "libsvm"), num_col=HIGGS_COLS,
                    batch_size=BATCH, layout="ell", max_nnz=HIGGS_COLS, drop_remainder=False,
                    device=device)
    for batch in it:
        ref_rows.add(batch)
    it.close()
    parts_equal = torch.equal(rows.rows(), ref_rows.rows())
    out = {"phase": "cloud_cut", "rows": CLOUD_CUT_ROWS, "bytes": len(cut), "write_s": write_s,
           "reduced": f"phase 3's corpus cut to its first {CLOUD_CUT_ROWS} rows for the "
                      "other protocols (the s3:// leg of (a) runs at full size)",
           "ref_parser": ref_class, "local_cut": _plain_pair(ref_rec),
           "legs": {p: {k: v for k, v in r.items() if k not in ("dig", "losses", "weights")}
                    for p, r in legs.items()},
           "bits_equal_local": equal, "azure_block_lists": stats["block_lists"],
           "parts": {"uri": "s3://bench/parts/", "num_parts": 2, "parsers": part_classes,
                     "rows": part_rows, "rows_equal_corpus": parts_equal}}
    emit(out)
    if not all(equal.values()):
        raise AssertionError(f"phase 19 (b): a protocol's epoch differs from the local cut: "
                             f"{equal}")
    if not parts_equal or sum(part_rows) != CLOUD_CUT_ROWS or min(part_rows) == 0:
        raise AssertionError(f"phase 19 (b): the two parts' rows: {out['parts']}")
    out["k1_launches"] = sum(r["k1_launches"] for r in legs.values())
    out["dw_launches"] = sum(r["dw_launches"] for r in legs.values())
    out["s3_leg"] = legs["s3"]
    out["uris"] = uris
    return out


def run_cloud_faults(cloud: "_FakeCloudChild", device, clean: dict) -> dict:
    """Phase 19 (c): an ``s3://`` epoch of (b)'s size while the fake serves
    a 503, a 429 with ``Retry-After: 0.05`` and a connection reset
    mid-body (:data:`CLOUD_FAULTS`): it heals, bit-equal to (b)'s clean
    epoch; then a 403 fails an epoch in one attempt with ``DMLCError``."""
    import torch

    from dmlc_tpu_torch.io import resilience as res
    from dmlc_tpu_torch.utils.check import DMLCError

    uri = "s3://bench/cut/higgs_cut.libsvm"
    cloud.faults(CLOUD_FAULTS)
    base = res.counters_snapshot()
    rec, dig, losses, w, _ = _one_epoch(uri, device, "s3_faults")
    healed = res.counters_delta(base)
    fired = [f["fired"] for f in cloud.stats()["faults"]]
    _launch_gate(rec, rec["leg"], phase=19)
    equal = (torch.equal(dig.batches(), clean["dig"].batches())
             and _same_losses(losses, clean["losses"]) and _same_weights(w, clean["weights"]))
    cloud.faults([{"proto": "s3", "action": "403", "at": 5}])
    base = res.counters_snapshot()
    model, it = _store_pipeline(uri, device)
    raised, steps = None, 0
    try:
        for batch in it:
            model.step(batch)
            steps += 1
    except DMLCError as exc:
        raised = str(exc)[:300]
    finally:
        try:
            it.close()
        except DMLCError:
            pass
    fatal = res.counters_delta(base)
    cloud.faults([])
    keys = ("attempts", "retries", "resumes", "giveups", "fatal")
    out = {"phase": "cloud_faults", "uri": uri, "faults": CLOUD_FAULTS, "fired": fired,
           "epoch": rec, "healed_counters": {k: healed[k] for k in keys},
           "bits_equal_clean": equal, "forbidden_403": {
               "raised": raised, "steps_before": steps,
               "counters": {k: fatal[k] for k in keys}}}
    emit(out)
    if fired != [1, 1, 1] or not equal or healed["retries"] != 3 or healed["giveups"]:
        raise AssertionError(f"phase 19 (c): the served faults did not heal: {out}")
    if (raised is None or not raised.startswith("feed failed") or fatal["fatal"] != 1
            or fatal["retries"] or fatal["giveups"]):
        raise AssertionError(f"phase 19 (c): the 403 did not fail in one attempt: {out}")
    out["k1_launches"], out["dw_launches"] = rec["k1_launches"], rec["dw_launches"]
    return out


def run_cloud_checkpoint(device, clean: dict) -> dict:
    """Phase 19 (d): a ``DeviceIter.state_dict()`` taken after
    :data:`CLOUD_CKPT_AT` batches of (b)'s ``s3://`` pipeline and the
    learner's parameters saved to ``s3://`` through ``open_stream`` and
    read back into a fresh pipeline: the remaining batches and the final
    weights equal the uninterrupted epoch's; then the ported
    ``checkpoint_resume`` example on the card, its corpus on ``s3://``."""
    import io as _io

    import torch

    from dmlc_tpu_torch.convert import linear_params_from_jax, linear_params_to_jax
    from dmlc_tpu_torch.examples import checkpoint_resume
    from dmlc_tpu_torch.io.stream import read_all, write_all
    from dmlc_tpu_torch.ops import ell_matvec as k1

    uri = "s3://bench/cut/higgs_cut.libsvm"
    k1_0, dw_0 = k1.launches, k1.dw_launches
    model, it = _store_pipeline(uri, device)
    dig = _Digests(device)
    for _, batch in zip(range(CLOUD_CKPT_AT), it):
        dig.add(batch)
        model.step(batch)
    state = it.state_dict()
    it.close()
    buf = _io.BytesIO()
    np.savez(buf, *linear_params_to_jax(model.params))
    write_all("s3://bench/ckpt/state.json", json.dumps(state).encode())
    write_all("s3://bench/ckpt/params.npz", buf.getvalue())
    # a fresh process would start here: everything from s3://
    state2 = json.loads(read_all("s3://bench/ckpt/state.json"))
    npz = np.load(_io.BytesIO(read_all("s3://bench/ckpt/params.npz")))
    model2, it2 = _store_pipeline(uri, device)
    model2.set_params(linear_params_from_jax(*(npz[k] for k in sorted(npz.files)),
                                             device=device))
    it2.load_state(state2)
    for batch in it2:
        dig.add(batch)
        model2.step(batch)
    it2.close()
    torch.cuda.synchronize()
    k1_n, dw_n = k1.launches - k1_0, k1.dw_launches - dw_0
    spliced = torch.equal(dig.batches(), clean["dig"].batches())
    weights = _same_weights(_weights(model2), clean["weights"])
    t0 = time.monotonic()
    example_batches = checkpoint_resume.run("s3://bench/example/train.libsvm")
    out = {"phase": "cloud_checkpoint", "uri": uri, "checkpoint_at": CLOUD_CKPT_AT,
           "state": state, "batches": len(dig.batch), "remaining_batches_equal": spliced,
           "final_weights_bit_equal": weights, "k1_launches": k1_n, "dw_launches": dw_n,
           "example": {"uri": "s3://bench/example/train.libsvm", "batches": example_batches,
                       "seconds": time.monotonic() - t0}}
    emit(out)
    if not (spliced and weights) or len(dig.batch) != CLOUD_CUT_ROWS // BATCH:
        raise AssertionError(f"phase 19 (d): the resumed s3:// epoch: {out}")
    if k1_n < len(dig.batch) or dw_n < len(dig.batch):
        raise AssertionError(f"phase 19 (d): K1 {k1_n}, dw {dw_n} for {len(dig.batch)} steps")
    return out


def run_cloud(path: str, tmp: str, device) -> dict:
    """Phase 19 (module docstring), in a directory of its own, beside the
    fake cloud in a child process (killed in a ``finally``)."""
    import shutil

    t0 = time.monotonic()
    d = os.path.join(tmp, "cloud19")
    os.makedirs(d)
    cloud = _FakeCloudChild(d)
    try:
        with _env({**cloud.env, "AZURE_BLOCK_MB": "8"}), _AttemptLog() as log:
            burst = burst_probe(cloud)
            emit({"phase": "cloud_burst", **burst})
            out = {"burst": burst, "s3": run_cloud_s3(path, cloud, d, device)}
            out["cut"] = run_cloud_cut(path, cloud, d, device)
            clean = out["cut"].pop("s3_leg")
            out["faults"] = run_cloud_faults(cloud, device, clean)
            out["checkpoint"] = run_cloud_checkpoint(device, clean)
            stats = cloud.stats()
    except BaseException:
        print(f"phase 19: fake cloud stderr: {cloud.stderr()}", file=sys.stderr)
        raise
    finally:
        cloud.close()
    shutil.rmtree(d)
    out["wall_s"] = time.monotonic() - t0
    legs = ("s3", "cut", "faults", "checkpoint")
    for key in ("k1_launches", "dw_launches"):
        out[key] = sum(out[leg][key] for leg in legs)
    out["k2_launches"] = out["s3"]["k2_launches"]
    auth, conns = stats["auth_failures"], stats["connections"]
    # each attempt is at least one connection a server of the fake accepted
    # (urllib follows WebHDFS's redirect inside one attempt); the stats
    # call's own connection is accepted and not yet served
    accepted = sum(c["accepted"] for c in conns.values())
    out["attempts"] = {"client": log.attempts, "accepted": accepted,
                       "served": sum(c["served"] for c in conns.values()),
                       "slow": len(log.slow)}
    emit({"phase": "cloud_total", "wall_s": out["wall_s"], "auth_failures": auth,
          "k1_launches": out["k1_launches"], "dw_launches": out["dw_launches"],
          "k2_launches": out["k2_launches"], "attempts": out["attempts"],
          "connections": conns, "slow_attempts": log.slow})
    if burst["failed"] or burst["max_s"] > CLOUD_BURST_LIMIT_S or burst["accepted"] != CLOUD_BURST:
        raise AssertionError(f"phase 19: the burst of {CLOUD_BURST} connections: {burst}")
    if auth:
        raise AssertionError(f"phase 19: requests the fake refused as unsigned: {auth[:5]}")
    if out["wall_s"] > CLOUD_LIMIT_S:
        raise AssertionError(f"phase 19: {out['wall_s']:.2f} s, over its {CLOUD_LIMIT_S} s")
    return out


# ---------------- phase 20: the tracker ----------------

POD = {"ranks": 2, "lr": 0.3,
       "child_timeout": 240,   # a rank ends itself past this (a watchdog in the rank)
       "group_timeout": 120,   # init_from_env's rendezvous and every collective
       "job_timeout": 300,     # the whole submit; past it the phase fails
       "liveness": "1.0", "attempts": 3, "example_timeout": 240}


def pod_child(cfg_path: str) -> None:
    """``chip_smoke.py --parallel-child pod CFG``: one rank of a phase 20
    job, launched by the port's ``tpu-pod`` backend. The rabit rendezvous
    (``WorkerClient.start``, or ``recover`` of the rank a first life
    wrote), the heartbeat with ``metrics=True``, then
    ``init_from_env(backend="gloo")`` (two ranks share the card),
    ``pod_identity``, ``sync_min`` of the part's batches and one epoch of
    the data-parallel ELL ``LinearLearner`` on this rank's part, K1 and
    ``dw`` counted around it; rank 0 holds both kernels against their plain
    versions on its first batch. With ``crash``, task 1's first life dies
    hard after the rendezvous, before the group. A watchdog ends a rank
    past ``child_timeout``: the launch joins its ranks with no deadline."""
    import threading
    from datetime import timedelta

    import torch

    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.parallel import init_from_env, make_mesh, pod_identity, sync_min
    from dmlc_tpu_torch.parallel.distributed import exit_rank
    from dmlc_tpu_torch.tracker.client import WorkerClient

    cfg = json.load(open(cfg_path))
    watchdog = threading.Timer(cfg["child_timeout"], os._exit, (124,))
    watchdog.daemon = True
    watchdog.start()
    task_id = int(os.environ["DMLC_TASK_ID"])
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
    client = WorkerClient(os.environ["DMLC_TRACKER_URI"], int(os.environ["DMLC_TRACKER_PORT"]))
    rank_file = os.path.join(cfg["out"], f"rabit_rank{task_id}")
    if cfg["crash"] and task_id == 1 and attempt == 0:
        client.start()
        with open(rank_file, "w") as f:
            f.write(str(client.rank))
        client.start_heartbeat(0.2)
        time.sleep(0.6)
        os._exit(17)  # no shutdown, no group: the tracker must see the beats stop
    if attempt > 0 and os.path.exists(rank_file):
        time.sleep(1.6)  # silent past the liveness window
        with open(rank_file) as f:
            old = int(f.read())
        assignment = client.recover(old)
        recovered = assignment.rank == old
    else:
        assignment = client.start()
        recovered = None
    client.start_heartbeat(0.25, metrics=True)
    t_group = time.monotonic()
    init_from_env(backend="gloo", timeout=timedelta(seconds=cfg["group_timeout"]))
    group_s = time.monotonic() - t_group
    rank, world = pod_identity()
    mesh = make_mesh()
    probe = _par_ell(cfg["higgs"], None, rank, world, device=mesh.device)[1]
    first = _first_batches(probe, 1)[0]
    from dmlc_tpu_torch import create_parser

    count = create_parser(cfg["higgs"], rank, world, "libsvm", threaded=False)
    local = sum(len(b) for b in count) // BATCH
    count.close()
    steps = sync_min(local)
    model, it = _par_ell(cfg["higgs"], mesh, rank, world)
    checks = _k1_on_batch(model, first) if rank == 0 else {}
    torch.cuda.synchronize()
    k1.launches = k1.dw_launches = 0
    t0 = time.monotonic()
    loss, nb = model.fit_epoch(it, max_steps=steps)
    wall = time.monotonic() - t0
    launches, dw_launches = k1.launches, k1.dw_launches
    stall = it.stall_seconds
    it.close()
    client.report_metrics()  # the epoch's stage seconds reach the tracker's table
    rec = {"rank": rank, "task_id": task_id, "attempt": attempt,
           "rabit_rank": assignment.rank, "recovered_same_rank": recovered,
           "backend": torch.distributed.get_backend(), "group_s": group_s,
           "local_batches": local, "steps": steps, "batches": nb, "loss": loss,
           "epoch_s": wall, "rows_per_s": nb * BATCH / wall, "stall_share": stall / wall,
           "k1_launches": launches, "dw_launches": dw_launches, "bits": _bits(model.params),
           **checks}
    torch.save([p.detach().cpu() for p in model.params],
               os.path.join(cfg["out"], f"params{rank}.pt"))
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    client.stop_heartbeat()
    client.shutdown()
    exit_rank()


class _LogTap:
    """The records of the ``dmlc_tpu_torch`` loggers (the tracker's and
    the launcher's) while the block is open, at INFO."""

    def __init__(self):
        import logging

        class _Handler(logging.Handler):
            def __init__(self, out):
                super().__init__(logging.INFO)
                self.out = out

            def emit(self, record):
                self.out.append((record.name, record.getMessage()))

        self.records = []
        self._handler = _Handler(self.records)

    def __enter__(self) -> "_LogTap":
        import logging

        self._logger = logging.getLogger("dmlc_tpu_torch")
        self._level = self._logger.level
        self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc) -> None:
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)

    def messages(self, needle: str) -> list:
        return [m for _, m in self.records if needle in m]


def _pod_job(path: str, tmp: str, name: str, crash: bool) -> dict:
    """One phase 20 job: ``dmlc_tpu_torch.tracker.submit.main`` with the
    ``tpu-pod`` cluster, two ranks of :func:`pod_child`, under
    :data:`POD`'s job deadline; returns the ranks' records, their
    parameters, the job's wall time and the loggers' records."""
    import threading

    import torch

    from dmlc_tpu_torch.tracker.submit import main as submit

    out = os.path.join(tmp, name)
    os.makedirs(out)
    cfg_path = os.path.join(out, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({"higgs": path, "out": out, "crash": crash,
                   "child_timeout": POD["child_timeout"],
                   "group_timeout": POD["group_timeout"]}, f)
    argv = ["--cluster", "tpu-pod", "--num-workers", str(POD["ranks"]),
            "--host-ip", "127.0.0.1"]
    env = {"DMLC_METRICS_LOG_EVERY": "0"}
    if crash:
        argv += ["--local-num-attempt", str(POD["attempts"])]
        env["DMLC_LIVENESS_TIMEOUT"] = POD["liveness"]
    argv += ["--", sys.executable, os.path.abspath(__file__), "--parallel-child", "pod",
             cfg_path]
    failure = []

    def run():
        try:
            submit(argv)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the phase
            failure.append(exc)

    with _env(env), _LogTap() as tap:
        t0 = time.monotonic()
        job = threading.Thread(target=run, daemon=True)
        job.start()
        job.join(POD["job_timeout"])
        wall = time.monotonic() - t0
    if job.is_alive():
        raise AssertionError(f"phase 20 {name}: the job ran past its {POD['job_timeout']} s "
                             "(each rank ends itself at its watchdog)")
    if failure:
        raise AssertionError(f"phase 20 {name}: the job failed: {failure[0]!r}")
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(POD["ranks"])]
    params = [torch.load(os.path.join(out, f"params{r}.pt")) for r in range(POD["ranks"])]
    return {"ranks": ranks, "params": params, "wall_s": wall, "log": tap}


def _pod_reference(path: str, steps: int, device) -> list:
    """The card's one-process learner on the job's global batches (each
    the two ranks' batches concatenated in rank order), ``steps`` steps:
    its parameters."""
    import torch

    from dmlc_tpu_torch import LinearLearner
    from dmlc_tpu_torch.ops.sparse import EllBatch

    parts = [_first_batches(_par_ell(path, None, r, POD["ranks"], device)[1], steps)
             for r in range(POD["ranks"])]
    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=POD["lr"], device=device)
    for group in zip(*parts):
        model.step(EllBatch(*(torch.cat(ts) for ts in zip(*group))))
    return [p.detach().cpu() for p in model.params]


def _pod_record(job: dict, leg: str) -> dict:
    tracker = job["log"].messages("tracker listening on")
    tables = job["log"].messages("@tracker pod telemetry")
    return {"phase": "tracker_pod", "leg": leg, "wall_s": job["wall_s"],
            "tracker": tracker[-1] if tracker else None,
            "pod_table_ranks": max((int(m.split("(")[1].split(" ")[0]) for m in tables),
                                   default=0),
            "pod_table": tables[-1].split("\n", 1)[-1] if tables else None,
            "ranks": [{k: v for k, v in r.items() if k != "bits"} for r in job["ranks"]],
            "bits_equal_across_ranks": len({r["bits"] for r in job["ranks"]}) == 1}


def run_example_pod(timeout: float) -> dict:
    """Phase 20 (c): ``python -m dmlc_tpu_torch.examples.distributed_pod``
    on the card in a session of its own (killed whole past ``timeout``);
    its accuracies."""
    import re
    import signal

    t0 = time.monotonic()
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-m", "dmlc_tpu_torch.examples.distributed_pod"],
                            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"phase 20 (c): the example ran past {timeout} s") from None
    acc = [float(a) for a in re.findall(r"accuracy ([0-9.]+)", stdout)]
    backends = re.findall(r"\] (\w+) group up", stdout)
    out = {"phase": "tracker_example", "returncode": proc.returncode, "accuracies": acc,
           "backends": backends, "finished": "pod job finished" in stdout,
           "wall_s": time.monotonic() - t0}
    emit(out)
    if proc.returncode != 0 or not out["finished"] or len(acc) != POD["ranks"]:
        raise AssertionError(f"phase 20 (c): the example failed: {out}; {stderr[-3000:]}")
    if min(acc) <= 0.9 or len(set(acc)) != 1:
        raise AssertionError(f"phase 20 (c): the example's accuracies {acc}")
    return out


def run_tracker(path: str, tmp: str, device) -> dict:
    """Phase 20 (module docstring): (a) the tracker-launched job against the
    card's one-process learner, (b) the recovery job against (a), (c) the
    ported example."""
    t0 = time.monotonic()
    a = _pod_job(path, tmp, "pod_a", crash=False)
    rec_a = _pod_record(a, "a")
    steps = a["ranks"][0]["steps"]
    ref = _pod_reference(path, steps, device)
    rec_a["max_abs_diff_vs_one_process"] = max(
        float((p - q).abs().max()) for p, q in zip(a["params"][0], ref))
    emit(rec_a)
    problems = []
    if not rec_a["bits_equal_across_ranks"]:
        problems.append("the ranks' weights differ")
    if not rec_a["max_abs_diff_vs_one_process"] <= 1e-5:
        problems.append("the weights are more than 1e-5 off the one-process learner's")
    if rec_a["pod_table_ranks"] != POD["ranks"]:
        problems.append("the tracker's pod table does not hold both ranks")
    for r in a["ranks"]:
        if r["batches"] != steps or r["backend"] != "gloo":
            problems.append(f"rank {r['rank']}: {r['batches']} batches of {steps}, "
                            f"backend {r['backend']}")
        if r["k1_launches"] < steps or r["dw_launches"] < steps:
            problems.append(f"rank {r['rank']}: K1 {r['k1_launches']}, dw {r['dw_launches']} "
                            f"launches for {steps} steps")
    if "k1_max_abs_err" not in a["ranks"][0]:
        problems.append("rank 0 did not hold K1 and dw against their plain versions")
    if problems:
        raise AssertionError(f"phase 20 (a): {problems}: {rec_a}")

    b = _pod_job(path, tmp, "pod_b", crash=True)
    rec_b = _pod_record(b, "b")
    rec_b["lost"] = b["log"].messages("missed heartbeats")
    rec_b["relaunched"] = b["log"].messages("relaunching 1/")
    rec_b["bits_equal_to_a"] = all(r["bits"] == a["ranks"][0]["bits"] for r in b["ranks"])
    emit(rec_b)
    r1 = next(r for r in b["ranks"] if r["task_id"] == 1)
    if not (rec_b["lost"] and rec_b["relaunched"] and r1["attempt"] == 1
            and r1["recovered_same_rank"] and rec_b["bits_equal_across_ranks"]
            and rec_b["bits_equal_to_a"]):
        raise AssertionError(f"phase 20 (b): the recovery: {rec_b}")

    c = run_example_pod(POD["example_timeout"])
    out = {"a": rec_a, "b": rec_b, "c": c, "wall_s": time.monotonic() - t0,
           "k1_launches": sum(r["k1_launches"] for r in a["ranks"] + b["ranks"]),
           "dw_launches": sum(r["dw_launches"] for r in a["ranks"] + b["ranks"]),
           "k1_max_abs_err": a["ranks"][0]["k1_max_abs_err"],
           "dw_max_abs_err": a["ranks"][0]["dw_max_abs_err"]}
    emit({"phase": "tracker_total", "wall_s": out["wall_s"], "k1_launches": out["k1_launches"],
          "dw_launches": out["dw_launches"]})
    return out


SERVICE_PARTS = 4          # phase 21: the corpus's parts on the fleet
SERVICE_WORKERS = 2        # parse workers of the fleet
SERVICE_KILL_AT = 43       # (a): the batch (of 128) after which a worker is killed
SERVICE_LEG_LIMIT_S = 240.0  # each leg's deadline: a hung socket fails the phase
SERVICE_PARSER = {"format": "libsvm"}


def _with_deadline(fn, seconds: float, what: str):
    """``fn()`` on a thread of its own, joined for at most ``seconds``: a
    leg that hangs (a socket nobody answers) fails the phase instead of
    eating the run's time limit."""
    import threading

    box: dict = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["exc"] = exc

    t = threading.Thread(target=run, daemon=True, name=what)
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise AssertionError(f"{what}: not done within {seconds:.0f} s")
    if "exc" in box:
        raise box["exc"]
    return box["out"]


def _block_digest(parser) -> tuple:
    """(blocks, rows, digest) of a parser's stream: every block's arrays and
    its resume annotation, hashed in order on the host."""
    import hashlib

    h, blocks, rows = hashlib.blake2b(digest_size=16), 0, 0
    while (blk := parser.next_block()) is not None:
        for arr in (blk.offset, blk.label, blk.index, blk.value, blk.weight, blk.qid):
            h.update(b"-" if arr is None else np.ascontiguousarray(arr).view(np.uint8))
        h.update(json.dumps(blk.resume_state, sort_keys=True).encode())
        blocks += 1
        rows += len(blk)
    parser.close()
    return blocks, rows, h.hexdigest()


class _Prefix:
    """The next ``n`` blocks of a parser, as a parser."""

    def __init__(self, src, n: int):
        self.src, self.n = src, n

    def next_block(self):
        if self.n == 0:
            return None
        self.n -= 1
        return self.src.next_block()

    def close(self) -> None:
        pass


def _service_pipeline(address: str, device, job=None):
    """Phase 3's ELL main path fed by the data service."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner
    from dmlc_tpu_torch.service import DEFAULT_JOB, ServiceParser

    model = LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(ServiceParser(address, job=job or DEFAULT_JOB),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device)
    return model, it


class _PackedDigests(_Digests):
    """Exact int64 mixes of each packed dense batch's bits, on the card."""

    def add(self, batch) -> None:
        import torch

        bits = batch.packed.contiguous().view(torch.int16).to(torch.int64)
        r = (bits * self._w[: bits.shape[1]]).sum(1)
        self.row.append(r)
        self.batch.append((r * self._w[2 * self._k + 2: 2 * self._k + 2 + bits.shape[0]]).sum())


def _service_csr(path: str, fleet, device) -> dict:
    """Phase 21 (a): the CSR frames into the ELL learner (module docstring)."""
    import torch

    from dmlc_tpu_torch import LinearLearner, create_parser
    from dmlc_tpu_torch.io import resilience
    from dmlc_tpu_torch.ops.sparse import EllBatch
    from dmlc_tpu_torch.service import DEFAULT_JOB, ServiceParser
    from dmlc_tpu_torch.utils import telemetry

    # the delivered blocks and annotations against the local loop over the
    # same parts, part by part (the stream cut by the local parts' counts)
    local, served = [], []
    for p in range(SERVICE_PARTS):
        local.append(_block_digest(create_parser(path, p, SERVICE_PARTS)))
    t0 = time.monotonic()
    svc = ServiceParser(fleet.address)
    for blocks, _, _ in local:
        served.append(_block_digest(_Prefix(svc, blocks)))
    tail = svc.next_block()
    drain_s = time.monotonic() - t0
    svc_bytes = svc.bytes_read
    svc.close()
    blocks_equal = local == served and tail is None
    # the first 20 losses against the same batches stepped on the CPU
    dev_model, it = _service_pipeline(fleet.address, device)
    batch0 = next(it)
    checks = _k1_on_batch(dev_model, batch0)
    it.close()
    dev_model, it = _service_pipeline(fleet.address, device)
    cpu_model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device="cpu")
    pairs = []
    for _, batch in zip(range(20), it):
        a = dev_model.step(batch)
        b = cpu_model.step(EllBatch(*(t.cpu() for t in batch)))
        pairs.append((float(a), float(b)))
    it.close()
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    # two service-fed epochs beside phase 3's local reader in this call
    wire0 = telemetry.REGISTRY.counter(telemetry.SERVICE_WIRE_SENT_METRIC, job=DEFAULT_JOB).value
    base = resilience.counters_snapshot()
    model, it = _service_pipeline(fleet.address, device)
    digs = [_Digests(device), _Digests(device)]
    recs = [_store_epoch(model, it, f"service_{e}", digs[e]) for e in range(2)]
    it.close()
    wire_sent = telemetry.REGISTRY.counter(telemetry.SERVICE_WIRE_SENT_METRIC,
                                           job=DEFAULT_JOB).value - wire0
    clean = resilience.counters_delta(base)
    lmodel, lit = _store_pipeline(path, device)
    local_dig = _Digests(device)
    local_rec = _store_epoch(lmodel, lit, "local_reader", local_dig)
    lit.close()
    # the same epoch again, the worker streaming to it killed after about a
    # third of it (the owner of the part in flight, so the stream breaks)
    base = resilience.counters_snapshot()
    kmodel, kit = _service_pipeline(fleet.address, device)
    kill_dig = _Digests(device)
    killed = []

    def kill(n):
        if n == SERVICE_KILL_AT:
            ids = [w.worker_id for w in fleet.workers]
            owner = kit.source._owner or kit.source._last_located
            index = ids.index(owner) if owner in ids else 0
            killed.append((index, ids[index]))
            fleet.kill_worker(index)

    kill_rec = _store_epoch(kmodel, kit, "service_worker_killed", kill_dig, on_batch=kill)
    kit.close()
    chaos = resilience.counters_delta(base)
    fleet.add_worker()  # back to two workers for (b)
    torch.cuda.synchronize()
    out = {"phase": "service_csr", "parts": SERVICE_PARTS, "workers": SERVICE_WORKERS,
           "local_blocks": sum(r[0] for r in local),
           "served_blocks": sum(r[0] for r in served), "rows": sum(r[1] for r in served),
           "blocks_and_annotations_equal_local": blocks_equal, "drain_s": drain_s,
           "client_payload_bytes": svc_bytes, "wire_bytes_sent_two_epochs": wire_sent,
           "first_20_max_rel_diff_vs_cpu": rel, **checks, "epochs": recs,
           "local_reader": _plain_pair(local_rec),
           "rows_per_s_vs_local": recs[-1]["rows_per_s"] / local_rec["rows_per_s"],
           "batches_equal_local_reader": _epochs_equal(digs[:1], [local_dig]),
           "epochs_bit_equal": _epochs_equal(digs[:1], digs[1:]),
           "counters": clean, "killed": kill_rec, "killed_worker": killed,
           "killed_counters": chaos,
           "killed_bits_equal": _epochs_equal([kill_dig], digs[:1])}
    emit(out)
    problems = []
    if not blocks_equal:
        problems.append("the served blocks differ from the local loop's")
    if not rel <= 1e-4:
        problems.append(f"the first 20 losses are {rel} off the CPU's")
    for rec in recs + [kill_rec, local_rec]:
        if rec["batches"] != HIGGS_ROWS // BATCH:
            problems.append(f"{rec['leg']}: {rec['batches']} batches")
        _launch_gate(rec, rec["leg"], phase=21)
    if not (out["batches_equal_local_reader"] and out["epochs_bit_equal"]):
        problems.append("the service-fed batches differ from the local reader's")
    if not out["killed_bits_equal"]:
        problems.append("the epoch with a worker killed differs from the undisturbed one")
    if chaos.get("service_failovers", 0) < 1 or chaos.get("service_giveups", 0):
        problems.append(f"the kill's counters: {chaos}")
    if clean.get("service_giveups", 0) or clean.get("service_failovers", 0):
        problems.append(f"the undisturbed epochs' counters: {clean}")
    if problems:
        raise AssertionError(f"phase 21 (a): {problems}: {out}")
    out["k1_launches"] = sum(r["k1_launches"] for r in recs + [kill_rec, local_rec])
    out["dw_launches"] = sum(r["dw_launches"] for r in recs + [kill_rec, local_rec])
    return out


def _snapshot_epoch(model, it, digests) -> dict:
    """One epoch of packed dense batches stepped batch by batch and digested
    on the card, timed to a synchronize; K2 counted around it."""
    import torch

    from dmlc_tpu_torch.ops import device_decode as dd

    k2_0 = dd.launches
    t0 = time.monotonic()
    nb, loss = 0, None
    for batch in it:
        digests.add(batch)
        loss = model.step(batch)
        nb += 1
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    st = it.stats()
    it.reset()
    return {"batches": nb, "wall_s": secs, "rows_per_s": nb * BATCH / secs,
            "loss": float(loss), "k2_launches": dd.launches - k2_0,
            "device_decode_bytes": st["device_decode_bytes"]}


def _service_snapshot(path: str, fleet, device) -> dict:
    """Phase 21 (b): the snapshot frames through ``device_decode=True`` with
    no snapshot (module docstring)."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner
    from dmlc_tpu_torch.service import ServiceParser, register_job

    num_col = HIGGS_COLS + 1  # the dense learner's width, its sink column included
    geometry = {"batch_size": BATCH, "num_col": num_col, "x_dtype": "bfloat16"}
    register_job(fleet.address, "snap", path, SERVICE_PARTS,
                 parser=SERVICE_PARSER, snapshot=geometry)

    def pipeline(decode: bool):
        model = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, device=device)
        src = ServiceParser(fleet.address, job="snap")
        it = DeviceIter(src, num_col=model.device_num_col(), batch_size=BATCH,
                        layout="dense", pack_aux=True, x_dtype="bfloat16",
                        device_decode=decode, drop_remainder=True, device=device)
        return model, it, src

    # the host route first: the workers pack each part's frames at its
    # first snapshot request, so the span route's epoch is timed warm
    hmodel, hit, _ = pipeline(False)
    host_dig = _PackedDigests(device, k=num_col + 2)
    host = _snapshot_epoch(hmodel, hit, host_dig)
    hit.close()
    model, it, src = pipeline(True)
    span_dig = _PackedDigests(device, k=num_col + 2)
    span = _snapshot_epoch(model, it, span_dig)
    snap_bytes = src.bytes_read
    it.close()
    # the spin: steps fed by the span route enqueued behind a device spin
    smodel, sit, _ = pipeline(True)
    smodel.step(next(sit))
    time.sleep(3.0)
    from dmlc_tpu_torch.ops import device_decode as dd

    k2_0 = dd.launches
    spin = enqueue_behind_spin(lambda: smodel.step(next(sit)), group=10,
                               spin_cycles=PIPELINE_SPIN_CYCLES)
    spin["k2_launches"] = dd.launches - k2_0
    sit.close()
    out = {"phase": "service_snapshot", "geometry": geometry, "span_route": span,
           "host_route": host, "bits_equal_host_route": _epochs_equal([span_dig], [host_dig]),
           "client_payload_bytes": snap_bytes, "spin": spin}
    emit(out)
    problems = []
    if span["k2_launches"] != span["batches"] or host["k2_launches"] != 0:
        problems.append(f"K2 launched {span['k2_launches']} times for {span['batches']} "
                        f"batches (host route {host['k2_launches']})")
    if span["batches"] < HIGGS_ROWS // BATCH or span["batches"] != host["batches"]:
        problems.append("the routes' batch counts")
    if not out["bits_equal_host_route"]:
        problems.append("the span route's batches differ from the host route's")
    if not (np.isfinite(span["loss"]) and span["loss"] < np.log(2)):
        problems.append(f"the dense epoch's loss {span['loss']}")
    if not spin["no_host_sync"] or spin["k2_launches"] != spin["calls"]:
        problems.append(f"the steps behind a spin: {spin}")
    if problems:
        raise AssertionError(f"phase 21 (b): {problems}: {out}")
    out["k2_launches"] = span["k2_launches"] + spin["k2_launches"]
    return out


def _service_als() -> dict:
    """Phase 21 (c): ``dmlc_tpu_torch.examples.train_als``'s ``main([])`` at
    its full size, as a user runs it; the row scatter counted around it."""
    import contextlib
    import io

    from dmlc_tpu_torch.examples import train_als
    from dmlc_tpu_torch.ops import row_scatter as rs

    cfg = train_als.config(dryrun=False, world=1)
    buf = io.StringIO()
    rs0 = rs.launches
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        train_als.main([])
    launches = rs.launches - rs0
    lines = buf.getvalue().splitlines()
    epoch_len = cfg["users"] // cfg["batch"]
    need = als_main_steps(cfg)
    svc = [ln for ln in lines if ln.startswith("service-fed:")]
    fields = dict(kv.split("=") for kv in svc[0].split()[1:] if "=" in kv) if svc else {}
    out = {"phase": "service_als", "main_s": time.monotonic() - t0, "service_line": svc,
           "row_scatter_launches": launches, "row_scatter_launches_needed": need,
           "reduced": "none: examples/train_als.py's full run"}
    emit(out)
    problems = []
    if not (lines and lines[-1] == "OK" and len(svc) == 1):
        problems.append("the example did not print its service line and OK")
    elif not (int(fields.get("parsed", 99)) <= 2 and fields.get("giveups") == "0"
              and int(fields.get("tenant_blocks", 0)) > 0):
        problems.append("parse-once or the giveups")
    if f"checkpoint/restore byte-identical over {epoch_len - cfg['restore_at']} steps" \
            not in lines:
        problems.append("the local restore line")
    if launches != need:
        problems.append("the row scatter did not launch once a step")
    if problems:
        raise AssertionError(f"phase 21 (c): {problems}: {out}")
    return out


def als_main_steps(cfg: dict) -> int:
    """The steps of ``train_als.main``: the local fit, restore_check's two
    pipelines (an epoch, the warm epoch, its replay) and the service leg's
    (an epoch, the warm epoch, its replay); the eval pass makes no scatter."""
    epoch_len = cfg["users"] // cfg["batch"]
    replay = epoch_len - cfg["restore_at"]
    return (cfg["epochs"] + 2) * epoch_len + replay + 2 * epoch_len + replay


def run_service(path: str, tmp: str, device) -> dict:
    """Phase 21 (module docstring): the data service on the card's host,
    (a) CSR frames into the ELL learner, (b) snapshot frames decoded by K2,
    (c) the ALS example's two tenants; each leg under a deadline."""
    from dmlc_tpu_torch.service import LocalFleet

    t0 = time.monotonic()
    fleet = LocalFleet(path, SERVICE_PARTS, num_workers=SERVICE_WORKERS, parser=SERVICE_PARSER)
    try:
        a = _with_deadline(lambda: _service_csr(path, fleet, device), SERVICE_LEG_LIMIT_S,
                           "phase 21 (a)")
        b = _with_deadline(lambda: _service_snapshot(path, fleet, device), SERVICE_LEG_LIMIT_S,
                           "phase 21 (b)")
    finally:
        fleet.close()
    c = _with_deadline(_service_als, SERVICE_LEG_LIMIT_S, "phase 21 (c)")
    out = {"a": a, "b": b, "c": c, "wall_s": time.monotonic() - t0,
           "k1_launches": a["k1_launches"], "dw_launches": a["dw_launches"],
           "k2_launches": b["k2_launches"], "row_scatter_launches": c["row_scatter_launches"],
           "k1_max_abs_err": a["k1_max_abs_err"], "dw_max_abs_err": a["dw_max_abs_err"]}
    emit({"phase": "service_total", "wall_s": out["wall_s"],
          "csr_wire_bytes_sent_two_epochs": a["wire_bytes_sent_two_epochs"],
          "csr_client_payload_bytes_one_epoch": a["client_payload_bytes"],
          "snapshot_client_payload_bytes_one_epoch": b["client_payload_bytes"],
          "k1_launches": out["k1_launches"], "dw_launches": out["dw_launches"],
          "k2_launches": out["k2_launches"],
          "row_scatter_launches": out["row_scatter_launches"]})
    return out


# ---------------- phase 22: fault plans ----------------

FAULT_PLANS = {  # phase 22's plans, by leg (tests/test_torch_faults.py parses each)
    "http": "read@2..3=http-503;read@9=reset",
    "http_fatal": "read@1=http-403",
    "span": "snapshot_read@5=corrupt",
    "block_cache": "cache_read@3=corrupt",
    # scoped to the client's locate and part streams, as the JAX package's
    # tests scope them: the workers' heartbeats and polls also pass through
    # dispatch_rpc, and a heartbeat's firing is swallowed without a retry
    "service": "dispatch_rpc~locate@2..4=conn;worker_rpc~stream@1=torn",
    "preempt": "preempt~{worker}@1",
    "env": "read@1=http-503",
}
# (d)'s counts under FAULT_PLANS["service"]: both packages' clients count
# these (tests/test_torch_faults.py)
FAULT_SERVICE_WANT = {"control_plane_retries": 3, "service_retries": 1}
FAULT_ENV_ROWS = 1 << 16        # (e): the rows the child reads, cut for time
FAULT_READ_WORKERS = (1, 2)     # (b): snapshot_read_workers
FAULT_LEG_LIMIT_S = 240.0       # each leg's deadline
FAULT_DRAIN_WAIT_S = 10.0       # (d): the wait for the preempted worker's drain


def _fault_line(leg: str, spec: str, fired: int, counters: dict, recs: list, wall_s: float,
                **extra) -> dict:
    """Phase 22's line for one leg: the plan, ``fired()``, the counter
    deltas, the launches of its epochs and its wall time."""
    out = {"phase": "faults", "leg": leg, "plan": spec, "fired": fired,
           "counters": {k: v for k, v in counters.items() if v},
           "k1_launches": sum(r.get("k1_launches", 0) for r in recs),
           "dw_launches": sum(r.get("dw_launches", 0) for r in recs),
           "k2_launches": sum(r.get("k2_launches", 0) for r in recs),
           "wall_s": wall_s, **extra}
    emit(out)
    return out


def run_faults_http(path: str, cloud: "_FakeCloudChild", device) -> dict:
    """Phase 22 (a): phase 3's corpus on the fake's ``http://``, one ELL
    epoch clean and one under :data:`FAULT_PLANS` ``"http"`` (bit-equal
    weights, a retry per firing, a resume, no give-up; K1 and ``dw``
    against their plain versions on a batch read under the plan); then an
    epoch under ``"http_fatal"``: one firing, ``fatal`` 1, no retry, and the
    epoch raises ``DMLCError``."""
    import torch

    from dmlc_tpu_torch.io import faults
    from dmlc_tpu_torch.io import resilience as res
    from dmlc_tpu_torch.utils.check import DMLCError

    t0 = time.monotonic()
    with open(path, "rb") as f:
        cloud.put("http", "/faults/higgs.libsvm", f.read())
    put_s = time.monotonic() - t0
    uri = f"http://127.0.0.1:{cloud.ports['http']}/faults/higgs.libsvm"
    clean, clean_dig, clean_losses, clean_w, parser = _one_epoch(uri, device, "http_clean")
    with faults.inject(FAULT_PLANS["http"]):
        model, it = _store_pipeline(uri, device)
        checks = _k1_on_batch(model, next(it))
        it.close()
    spec = FAULT_PLANS["http"]
    base = res.counters_snapshot()
    t0 = time.monotonic()
    with faults.inject(spec) as plan:
        rec, dig, losses, w, _ = _one_epoch(uri, device, "http_faulted")
    wall = time.monotonic() - t0
    delta = res.counters_delta(base)
    equal = (torch.equal(dig.batches(), clean_dig.batches())
             and _same_losses(losses, clean_losses) and _same_weights(w, clean_w))
    healed = _fault_line("a_http", spec, plan.fired(), delta, [rec], wall, parser=parser,
                         put_s=put_s, clean=_plain_pair(clean), faulted=_plain_pair(rec),
                         bits_equal_clean=equal, **checks)
    spec = FAULT_PLANS["http_fatal"]
    base = res.counters_snapshot()
    t0 = time.monotonic()
    raised, steps = None, 0
    with faults.inject(spec) as fplan:
        model, it = _store_pipeline(uri, device)
        try:
            for batch in it:
                model.step(batch)
                steps += 1
        except DMLCError as exc:
            raised = str(exc)[:300]
        finally:
            try:
                it.close()
            except DMLCError:
                pass
    fatal = res.counters_delta(base)
    failed = _fault_line("a_http_fatal", spec, fplan.fired(), fatal, [], time.monotonic() - t0,
                         raised=raised, steps_before=steps)
    problems = []
    for r in (clean, rec):
        if r["batches"] != HIGGS_ROWS // BATCH:
            problems.append(f"{r['leg']}: {r['batches']} batches")
        _launch_gate(r, r["leg"], phase=22)
    if not equal:
        problems.append("the faulted epoch's bits differ from the clean epoch's")
    if not (plan.fired() == 3 and delta["retries"] == plan.fired() and delta["resumes"] >= 1
            and delta["giveups"] == 0 and delta["fatal"] == 0):
        problems.append(f"the healed epoch's counters: fired {plan.fired()}, {healed['counters']}")
    if not (raised is not None and fplan.fired() == 1 and fatal["fatal"] == 1
            and fatal["retries"] == 0 and fatal["giveups"] == 0):
        problems.append(f"the 403: raised {raised!r}, fired {fplan.fired()}, "
                        f"{failed['counters']}")
    if problems:
        raise AssertionError(f"phase 22 (a): {problems}")
    return {"healed": healed, "fatal": failed, "clean": clean,
            "k1_launches": clean["k1_launches"] + rec["k1_launches"],
            "dw_launches": clean["dw_launches"] + rec["dw_launches"],
            "k1_max_abs_err": checks["k1_max_abs_err"],
            "dw_max_abs_err": checks["dw_max_abs_err"]}


def _slots_back(it) -> bool:
    """Every staging slot of every ring the iterator made is free, once."""
    return all(sorted(map(id, r._free)) == sorted(map(id, r._slots))
               for r in it._rings.values())


def _span_model(layout: str, device):
    """A fresh learner for (b)'s layout and the digests of its batches."""
    from dmlc_tpu_torch import LinearLearner

    if layout == "ell":
        return (LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3,
                              device=device), _Digests(device))
    return (LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, device=device),
            _PackedDigests(device))


def _span_iter(path: str, snap: str, device, layout: str, workers: int, num_col: int):
    """Phase 6's warm pipeline on K2's span route at ``workers`` read
    workers: ELL, or packed bf16 dense."""
    from dmlc_tpu_torch import DeviceIter, create_parser

    kw = (dict(layout="ell", max_nnz=HIGGS_COLS) if layout == "ell"
          else dict(layout="dense", pack_aux=True, x_dtype="bfloat16"))
    return DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap), num_col=num_col,
                      batch_size=BATCH, drop_remainder=True, device=device, device_decode=True,
                      snapshot_read_workers=workers, **kw)


def _span_epoch(model, it, leg: str, dig, may_raise: bool = False) -> dict:
    """One epoch stepped and digested batch by batch, K2's launches read
    after each batch; every staging slot checked free at the epoch's end
    (or, after a raise, after ``reset``); then ``reset()``."""
    import torch

    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.utils.check import CacheCorruptionError

    k1_0, dw_0 = k1.launches, k1.dw_launches
    marks = [dd.launches]
    t0 = time.monotonic()
    nb, raised = 0, None
    try:
        for batch in it:
            dig.add(batch)
            model.step(batch)
            nb += 1
            marks.append(dd.launches)
    except CacheCorruptionError as exc:
        if not may_raise:
            raise
        raised = str(exc)[:300]
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    slots_at_end = _slots_back(it)
    stats = it.stats()
    it.reset()
    per = np.diff(marks)
    warm = int(per.sum())
    return {"leg": leg, "batches": nb, "wall_s": secs, "rows_per_s": nb * BATCH / secs,
            "k1_launches": k1.launches - k1_0, "dw_launches": k1.dw_launches - dw_0,
            "k2_launches": warm, "warm_batches": warm,
            # one K2 launch a warm batch: a prefix of ones, then the cold rest
            "k2_once_a_warm_batch": bool(np.all(per[:warm] == 1) and np.all(per[warm:] == 0)),
            "raised": raised, "slots_back": slots_at_end if raised is None else None,
            "slots_back_after_reset": _slots_back(it),
            "resilience": {k: v for k, v in stats["resilience"].items() if v}}


def _k2_stored_check(snap: str, device, num_col: int) -> dict:
    """K2 on the stored batch the one-worker plan meets (position 4)
    against ``decode_batch_plain``, bit for bit (a comparison, outside the
    counted epochs)."""
    import torch

    from dmlc_tpu_torch.io.snapshot import SnapshotReader
    from dmlc_tpu_torch.ops import device_decode as dd

    reader = SnapshotReader(snap)
    try:
        kind, span, layout = reader.batch_span(4)
        dev_span = torch.from_numpy(np.array(span)).to(device)
    finally:
        reader.close()
    got = batch_tensors(dd.decode_batch_cuda(dev_span, layout, kind, num_col))
    want = batch_tensors(dd.decode_batch_plain(dev_span, layout, kind, num_col))
    equal = len(got) == len(want) and all(same_bits(a, b) for a, b in zip(got, want))
    if not equal:
        raise AssertionError(f"phase 22 (b): K2 differs from decode_batch_plain on {snap}")
    return {"kind": kind, "max_abs_err": 0.0}


def run_faults_span(path: str, d: str, device) -> dict:
    """Phase 22 (b): K2's span route (``device_decode=True``), ELL and
    packed bf16 dense, under :data:`FAULT_PLANS` ``"span"`` at each of
    :data:`FAULT_READ_WORKERS` read workers: healed to the clean warm
    epoch's bits and weights, one corruption and one restart, one K2 launch
    a warm batch, every staging slot back, and a further epoch on the same
    iterator; under ``DMLC_RETRY_MAX_ATTEMPTS=1`` the plan raises, every
    slot is back after ``reset`` and a further epoch runs."""
    import torch

    from dmlc_tpu_torch.io import faults

    spec = FAULT_PLANS["span"]
    out, problems = {}, []
    for layout in ("ell", "dense_bf16"):
        snap = os.path.join(d, f"{layout}.snapshot")
        model, dig = _span_model(layout, device)
        num_col = model.device_num_col()
        it = _span_iter(path, snap, device, layout, FAULT_READ_WORKERS[-1], num_col)
        build = _span_epoch(model, it, f"{layout}_build", dig)
        k2_check = _k2_stored_check(snap, device, num_col)
        cmodel, cdig = _span_model(layout, device)
        clean = _span_epoch(cmodel, it, f"{layout}_clean_warm", cdig)
        it.close()
        clean_w = _weights(cmodel)
        recs = [build, clean]
        if clean["k2_launches"] != clean["batches"] or build["k2_launches"]:
            problems.append(f"{layout}: K2 {build['k2_launches']} cold, "
                            f"{clean['k2_launches']} for {clean['batches']} warm batches")
        if not _epochs_equal([cdig], [dig]):
            problems.append(f"{layout}: the warm batches differ from the cold epoch's")
        legs = []
        for workers in FAULT_READ_WORKERS:
            for give_up in (False, True):
                env = {"DMLC_RETRY_MAX_ATTEMPTS": "1"} if give_up else {}
                with _env(env):
                    it = _span_iter(path, snap, device, layout, workers, num_col)
                    fmodel, fdig = _span_model(layout, device)
                    t0 = time.monotonic()
                    with faults.inject(spec) as plan:
                        hit = _span_epoch(fmodel, it, f"{layout}_w{workers}_"
                                          f"{'giveup' if give_up else 'heal'}", fdig,
                                          may_raise=give_up)
                    wall = time.monotonic() - t0
                    amodel, adig = _span_model(layout, device)
                    after = _span_epoch(amodel, it, f"{layout}_w{workers}_after", adig)
                    it.close()
                recs += [hit, after]
                bits = (None if give_up else _epochs_equal([fdig], [cdig])
                        and _same_weights(_weights(fmodel), clean_w))
                legs.append(_fault_line(
                    f"b_span_{hit['leg']}", spec, plan.fired(), hit["resilience"], [hit, after],
                    wall, read_workers=workers, batches=hit["batches"],
                    warm_batches=hit["warm_batches"],
                    k2_once_a_warm_batch=hit["k2_once_a_warm_batch"], raised=hit["raised"],
                    slots_back=hit["slots_back"],
                    slots_back_after_reset=hit["slots_back_after_reset"],
                    bits_equal_clean=bits, next_epoch_batches=after["batches"],
                    next_epoch_slots_back=after["slots_back"],
                    next_epoch_bits_equal=_epochs_equal([adig], [cdig])))
                line = legs[-1]
                want = ({"pipeline_giveups": 1, "snapshot_corruptions": 1} if give_up
                        else {"pipeline_restarts": 1, "snapshot_corruptions": 1})
                if (plan.fired() != 1 or hit["resilience"] != want
                        or not hit["k2_once_a_warm_batch"] or hit["warm_batches"] < 1
                        or not hit["slots_back_after_reset"]
                        or after["batches"] != HIGGS_ROWS // BATCH
                        or not after["slots_back"] or not line["next_epoch_bits_equal"]):
                    problems.append(f"{line['leg']}: {line}")
                if give_up and hit["raised"] is None:
                    problems.append(f"{line['leg']}: the plan did not raise")
                if not give_up and not (bits and hit["slots_back"]
                                        and hit["batches"] == HIGGS_ROWS // BATCH):
                    problems.append(f"{line['leg']}: healed bits {bits}, {line}")
        if layout == "ell":
            for r in recs:
                _launch_gate(r, r["leg"], phase=22)
        out[layout] = {"clean": clean, "legs": legs, "k2_check": k2_check,
                       "k1_launches": sum(r["k1_launches"] for r in recs),
                       "dw_launches": sum(r["dw_launches"] for r in recs),
                       "k2_launches": sum(r["k2_launches"] for r in recs)}
    torch.cuda.synchronize()
    if problems:
        raise AssertionError(f"phase 22 (b): {problems}")
    out["clean_rows_per_s"] = out["ell"]["clean"]["rows_per_s"]
    for key in ("k1_launches", "dw_launches", "k2_launches"):
        out[key] = out["ell"][key] + out["dense_bf16"][key]
    return out


def run_faults_block_cache(path: str, d: str, device) -> dict:
    """Phase 22 (c): phase 12's planned block cache (seed 1, window 4096)
    built by one cold epoch; a fresh pipeline's warm epoch clean and one
    under :data:`FAULT_PLANS` ``"block_cache"``: the same weights, one
    corruption and one rebuild."""
    from dmlc_tpu_torch.io import faults
    from dmlc_tpu_torch.io import resilience as res

    cache = os.path.join(d, "higgs.blockcache")
    _, model, it = _bc_pipeline(path, cache, device)
    build = _store_epoch(model, it, "bc_build", _Digests(device))
    it.close()
    _, cmodel, it = _bc_pipeline(path, cache, device)
    cdig = _Digests(device)
    clean = _store_epoch(cmodel, it, "bc_clean_warm", cdig)
    it.close()
    spec = FAULT_PLANS["block_cache"]
    base = res.counters_snapshot()
    t0 = time.monotonic()
    with faults.inject(spec) as plan:
        _, fmodel, it = _bc_pipeline(path, cache, device)
        fdig = _Digests(device)
        heal = _store_epoch(fmodel, it, "bc_heal", fdig)
        it.close()
    delta = res.counters_delta(base)
    equal = _epochs_equal([fdig], [cdig]) and _same_weights(_weights(fmodel), _weights(cmodel))
    line = _fault_line("c_block_cache", spec, plan.fired(), delta, [heal],
                       time.monotonic() - t0, bits_equal_clean=equal,
                       clean=_plain_pair(clean), faulted=_plain_pair(heal))
    for r in (build, clean, heal):
        _launch_gate(r, r["leg"], phase=22)
    if not (equal and plan.fired() == 1 and delta["cache_corruptions"] == 1
            and delta["cache_rebuilds"] == 1 and heal["batches"] == clean["batches"]):
        raise AssertionError(f"phase 22 (c): {line}")
    recs = (build, clean, heal)
    return {"line": line, "k1_launches": sum(r["k1_launches"] for r in recs),
            "dw_launches": sum(r["dw_launches"] for r in recs)}


def run_faults_service(path: str, device) -> dict:
    """Phase 22 (d): phase 21 (a)'s fleet; a clean service-fed ELL epoch,
    one under :data:`FAULT_PLANS` ``"service"`` (the weights bit-equal, the
    pipeline's counters :data:`FAULT_SERVICE_WANT`), and one under
    ``"preempt"`` naming one worker (a notice, a drain, the bits)."""
    from dmlc_tpu_torch.io import faults
    from dmlc_tpu_torch.io import resilience as res
    from dmlc_tpu_torch.service import LocalFleet

    fleet = LocalFleet(path, SERVICE_PARTS, num_workers=SERVICE_WORKERS, parser=SERVICE_PARSER)

    def epoch(leg: str, spec=None, wait_drain: bool = False):
        model, it = _service_pipeline(fleet.address, device)
        dig = _Digests(device)
        base, scoped = res.counters_snapshot(), res.counters_snapshot(it.pipeline_label)
        t0 = time.monotonic()
        with (faults.inject(spec) if spec else contextlib.nullcontext()) as plan:
            rec = _store_epoch(model, it, leg, dig)
            deadline = time.monotonic() + FAULT_DRAIN_WAIT_S
            while (wait_drain and res.counters_delta(base).get("worker_drains", 0) < 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        wall = time.monotonic() - t0
        pipeline = res.counters_delta(scoped, it.pipeline_label)
        it.close()
        return (rec, dig, _weights(model), res.counters_delta(base), pipeline,
                plan.fired() if plan else 0, wall)

    try:
        clean, cdig, cw, _, _, _, _ = _with_deadline(lambda: epoch("service_clean"),
                                                      FAULT_LEG_LIMIT_S, "phase 22 (d) clean")
        spec = FAULT_PLANS["service"]
        rec, dig, w, delta, pipeline, fired, wall = _with_deadline(
            lambda: epoch("service_chaos", spec), FAULT_LEG_LIMIT_S, "phase 22 (d) chaos")
        chaos = _fault_line("d_service", spec, fired, delta, [rec], wall,
                            pipeline_counters={k: v for k, v in pipeline.items() if v},
                            bits_equal_clean=_epochs_equal([dig], [cdig]) and _same_weights(w, cw),
                            clean=_plain_pair(clean), faulted=_plain_pair(rec))
        target = fleet.workers[0].worker_id
        pspec = FAULT_PLANS["preempt"].format(worker=target)
        prec, pdig, pw, pdelta, _, pfired, pwall = _with_deadline(
            lambda: epoch("service_preempt", pspec, wait_drain=True), FAULT_LEG_LIMIT_S,
            "phase 22 (d) preempt")
        drain = _fault_line("d_preempt", pspec, pfired, pdelta, [prec], pwall,
                            bits_equal_clean=_epochs_equal([pdig], [cdig])
                            and _same_weights(pw, cw),
                            draining=[w_.draining for w_ in fleet.workers])
    finally:
        fleet.close()
    problems = []
    for r in (clean, rec, prec):
        if r["batches"] != HIGGS_ROWS // BATCH:
            problems.append(f"{r['leg']}: {r['batches']} batches")
        _launch_gate(r, r["leg"], phase=22)
    if not chaos["bits_equal_clean"] or {
            k: pipeline.get(k, 0) for k in FAULT_SERVICE_WANT} != FAULT_SERVICE_WANT:
        problems.append(f"the chaos plan: {chaos}")
    if not (drain["bits_equal_clean"] and pfired >= 1
            and pdelta.get("preemption_notices", 0) >= 1
            and pdelta.get("worker_drains", 0) >= 1):
        problems.append(f"the preemption: {drain}")
    if problems:
        raise AssertionError(f"phase 22 (d): {problems}")
    recs = (clean, rec, prec)
    return {"chaos": chaos, "preempt": drain,
            "k1_launches": sum(r["k1_launches"] for r in recs),
            "dw_launches": sum(r["dw_launches"] for r in recs)}


def faults_env_child(cfg_path: str) -> None:
    """Phase 22 (e), in a process of its own started with
    ``DMLC_FAULT_PLAN`` set: one epoch of the cut over ``http://`` into the
    ELL learner; its plan, counters, launches and weights to ``out``."""
    import torch

    from dmlc_tpu_torch.io import faults
    from dmlc_tpu_torch.io import resilience as res

    cfg = json.load(open(cfg_path))
    dev = torch.device("cuda", torch.cuda.current_device())
    base = res.counters_snapshot()
    rec, _, _, w, parser = _one_epoch(cfg["uri"], dev, "env_child")
    plan = faults.active_plan()
    torch.save([t.cpu() for t in w], os.path.join(cfg["out"], "weights.pt"))
    keep = ("leg", "batches", "wall_s", "rows_per_s", "k1_launches", "dw_launches")
    with open(os.path.join(cfg["out"], "child.json"), "w") as f:
        json.dump({"env": os.environ.get("DMLC_FAULT_PLAN"),
                   "plan": None if plan is None else plan.spec,
                   "fired": 0 if plan is None else plan.fired(), "parser": parser,
                   "counters": res.counters_delta(base),
                   "rec": {k: rec[k] for k in keep}}, f)


def run_faults_env(path: str, cloud: "_FakeCloudChild", d: str, device) -> dict:
    """Phase 22 (e): the first :data:`FAULT_ENV_ROWS` rows on ``http://``,
    one ELL epoch in this process with no plan, then in a child interpreter
    (``--parallel-child faults_env``) with ``DMLC_FAULT_PLAN`` set to
    :data:`FAULT_PLANS` ``"env"``: its retry counted, its weights this
    process's."""
    import torch

    cut = _cut_bytes(path, FAULT_ENV_ROWS)
    cloud.put("http", "/faults/higgs_cut.libsvm", cut)
    uri = f"http://127.0.0.1:{cloud.ports['http']}/faults/higgs_cut.libsvm"
    rec, _, _, w, _ = _one_epoch(uri, device, "env_parent")
    out = os.path.join(d, "env_child")
    os.makedirs(out)
    cfg = os.path.join(out, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"uri": uri, "out": out}, f)
    spec = FAULT_PLANS["env"]
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--parallel-child", "faults_env", cfg],
        env={**os.environ, "DMLC_FAULT_PLAN": spec}, capture_output=True, text=True,
        timeout=FAULT_LEG_LIMIT_S)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 22 (e): the child exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    child = json.load(open(os.path.join(out, "child.json")))
    cw = [t.to(device) for t in torch.load(os.path.join(out, "weights.pt"))]
    equal = _same_weights(tuple(cw), w)
    line = _fault_line("e_env_child", spec, child["fired"], child["counters"], [child["rec"]],
                       wall, child_plan=child["plan"], parser=child["parser"],
                       rows=FAULT_ENV_ROWS, batches=child["rec"]["batches"],
                       reduced=f"phase 3's corpus cut to its first {FAULT_ENV_ROWS} rows "
                               "for the time limit",
                       weights_equal_parent=equal, parent=_plain_pair(rec))
    _launch_gate(child["rec"], "env_child", phase=22)
    if not (equal and child["plan"] == spec and child["fired"] == 1
            and child["counters"]["retries"] == 1 and child["counters"]["giveups"] == 0
            and child["rec"]["batches"] == rec["batches"] == FAULT_ENV_ROWS // BATCH):
        raise AssertionError(f"phase 22 (e): {line}")
    return {"line": line, "k1_launches": rec["k1_launches"] + child["rec"]["k1_launches"],
            "dw_launches": rec["dw_launches"] + child["rec"]["dw_launches"]}


def run_faults(path: str, tmp: str, device, phase6_warm_rows_per_s=None) -> dict:
    """Phase 22 (module docstring), in a directory of its own, the legs on
    ``http://`` beside the fake cloud in a child process (killed in a
    ``finally``); ``phase6_warm_rows_per_s`` is (f)'s comparison."""
    import shutil

    t0 = time.monotonic()
    d = os.path.join(tmp, "faults22")
    os.makedirs(d)
    cloud = _FakeCloudChild(d)
    try:
        a = _with_deadline(lambda: run_faults_http(path, cloud, device), FAULT_LEG_LIMIT_S,
                           "phase 22 (a)")
        e = _with_deadline(lambda: run_faults_env(path, cloud, d, device), FAULT_LEG_LIMIT_S,
                           "phase 22 (e)")
    except BaseException:
        print(f"phase 22: fake cloud stderr: {cloud.stderr()}", file=sys.stderr)
        raise
    finally:
        cloud.close()
    b = _with_deadline(lambda: run_faults_span(path, d, device), FAULT_LEG_LIMIT_S,
                       "phase 22 (b)")
    c = _with_deadline(lambda: run_faults_block_cache(path, d, device), FAULT_LEG_LIMIT_S,
                       "phase 22 (c)")
    svc = run_faults_service(path, device)
    shutil.rmtree(d)
    emit({"phase": "faults_seam_cost", "span_clean_warm_ell_rows_per_s": b["clean_rows_per_s"],
          "span_clean_read_workers": FAULT_READ_WORKERS[-1],
          "phase6_warm_ell_rows_per_s": phase6_warm_rows_per_s})
    legs = (a, b, c, svc, e)
    out = {"a": a, "b": b, "c": c, "d": svc, "e": e, "wall_s": time.monotonic() - t0,
           "k1_launches": sum(x["k1_launches"] for x in legs),
           "dw_launches": sum(x["dw_launches"] for x in legs),
           "k2_launches": b["k2_launches"],
           "k1_max_abs_err": a["k1_max_abs_err"], "dw_max_abs_err": a["dw_max_abs_err"],
           "k2_max_abs_err": max(b[k]["k2_check"]["max_abs_err"] for k in ("ell", "dense_bf16"))}
    emit({"phase": "faults_total", "wall_s": out["wall_s"], "k1_launches": out["k1_launches"],
          "dw_launches": out["dw_launches"], "k2_launches": out["k2_launches"],
          "reduced": "HIGGS (UCI 280) 11,000,000 rows cut to 1,048,576 for the time limit, "
                     f"(e) to its first {FAULT_ENV_ROWS}; 28 features as published"})
    return out


SURFACE_STEPS = 16             # phase 23 (a): steps a leg (the numpy engine's pace)
SURFACE_LEGS = [("python", "uint32"), ("python", "uint64"), ("auto", "uint32"),
                ("auto", "uint64")]  # phase 23 (a): (engine, index_dtype)
SURFACE_VERIFY = (True, False, False, True)  # phase 23 (b): warm epochs in turns
SEGMENT_RTOL = SEGMENT_ATOL = 1e-5


def _surface_dtype_leg(path: str, device, engine: str, dtype: str) -> tuple:
    """Phase 23 (a): one leg's first :data:`SURFACE_STEPS` ELL batches
    (cloned), losses and weights, with its K1 / ``dw`` launches and the
    dtype of its parser's first block."""
    import torch

    from dmlc_tpu_torch import create_parser
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops.sparse import EllBatch

    kw = {"index_dtype": getattr(np, dtype), "engine": engine}
    probe = create_parser(path, 0, 1, "libsvm", **kw)
    block_dtype = str(probe.next_block().index.dtype)
    probe.close()
    model, it = _store_pipeline(path, device, parser_kw=kw)
    parser = type(it.source).__name__
    k1_0, dw_0 = k1.launches, k1.dw_launches
    batches, losses = [], []
    t0 = time.monotonic()
    for batch in it:
        batches.append(EllBatch(*(t.clone() for t in batch)))
        losses.append(model.step(batch))
        if len(batches) == SURFACE_STEPS:
            break
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    it.close()
    rec = {"leg": f"{engine}_{dtype}", "parser": parser, "block_index_dtype": block_dtype,
           "batches": len(batches), "wall_s": secs, "rows_per_s": len(batches) * BATCH / secs,
           "k1_launches": k1.launches - k1_0, "dw_launches": k1.dw_launches - dw_0}
    return rec, batches, torch.stack(losses), _weights(model), model


def _surface_warm_epoch(snap: str, device, verify: bool, num_col: int) -> tuple:
    """Phase 23 (b): one warm epoch of the snapshot at ``verify``: its
    spans read (and, verified, crc-checked) and copied on two read
    workers, each crossed to the card and decoded by one K2 launch."""
    import torch

    from dmlc_tpu_torch.io.snapshot import SnapshotIter, open_snapshot
    from dmlc_tpu_torch.ops import device_decode as dd

    reader = open_snapshot(snap, verify=verify)
    if reader is None:
        raise AssertionError(f"phase 23 (b): {snap} did not open")

    def stage(pos, host_batch, resume, nbytes):
        _, span, layout, kind = host_batch
        return torch.from_numpy(np.array(span)), layout, kind

    it = SnapshotIter(reader, raw=True, read_workers=2, stage=stage)
    dig = _Digests(device)
    k2_0, nb = dd.launches, 0
    t0 = time.monotonic()
    try:
        while (item := it.next()) is not None:
            host, layout, kind = item
            dig.add(dd.decode_batch(host.to(device), layout, kind, num_col))
            nb += 1
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    finally:
        it.destroy()
        reader.close()
    return ({"verify": verify, "batches": nb, "wall_s": secs, "rows_per_s": nb * BATCH / secs,
             "k2_launches": dd.launches - k2_0}, dig)


def _surface_segment(device, seed: int) -> dict:
    """Phase 23 (c): ``segment_csr_matvec`` at HIGGS's batch on the card
    against its plain versions, and its times (module docstring)."""
    import torch

    from dmlc_tpu_torch.ops import row_scatter as rs
    from dmlc_tpu_torch.ops.sparse import segment_csr_matvec

    b, k = BATCH, HIGGS_COLS
    g = torch.Generator(device="cpu").manual_seed(seed + 23)
    host = (torch.randn(k + 1, generator=g), torch.arange(k, dtype=torch.int32).repeat(b),
            torch.randn(b * k, generator=g),
            torch.arange(b, dtype=torch.int32).repeat_interleave(k))
    w, index, value, rows = (t.to(device) for t in host)
    rs0 = rs.launches
    first = segment_csr_matvec(w, index, value, rows, b)
    again = segment_csr_matvec(w, index, value, rows, b)
    launched = rs.launches - rs0
    ordered = rs.row_scatter_add_ordered_plain((b,), rows, w[index.long()] * value)
    plain = segment_csr_matvec(*host, b)
    torch.cuda.synchronize()
    err = float((first.cpu() - plain).abs().max())
    index_l, rows_l = index.long(), rows.long()
    lengths = torch.full((b,), k, dtype=torch.int64, device=device)
    ms = device_ms(lambda: segment_csr_matvec(w, index, value, rows, b))
    plain_ms = device_ms(lambda: torch.zeros(b, device=device).index_add_(
        0, rows_l, w[index_l] * value))
    library_ms = device_ms(lambda: torch.segment_reduce(w[index_l] * value, "sum",
                                                         lengths=lengths))
    nbytes = (k + 1) * 4 + b * k * (4 + 4 + 4) + b * 4  # w, index, value, row ids; out
    bound_ms, bound_by = bound(nbytes, 2 * b * k)
    out = {"shape": f"{b}x{k}", "row_scatter_launches": launched,
           "bits_equal_twice": bool(torch.equal(first, again)),
           "bits_equal_ordered_plain": bool(torch.equal(first, ordered)),
           "max_abs_err_vs_cpu": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": "torch.segment_reduce",
           "bound_ms": bound_ms, "bound_by": bound_by}
    if not (out["bits_equal_twice"] and out["bits_equal_ordered_plain"] and launched == 2
            and torch.allclose(first.cpu(), plain, rtol=SEGMENT_RTOL, atol=SEGMENT_ATOL)):
        raise AssertionError(f"phase 23 (c): {out}")
    return out


def run_surface(path: str, tmp: str, device) -> dict:
    """Phase 23 (module docstring), in a directory of its own."""
    import shutil

    import torch

    t0 = time.monotonic()
    d = os.path.join(tmp, "surface23")
    os.makedirs(d)
    # (a) the index dtype through the learner
    legs, recs = {}, []
    for engine, dtype in SURFACE_LEGS:
        rec, batches, losses, weights, model = _surface_dtype_leg(path, device, engine, dtype)
        legs[rec["leg"]] = (batches, losses, weights)
        recs.append(rec)
        _launch_gate(rec, rec["leg"], phase=23)
        if rec["leg"] == "python_uint32":
            checks = _k1_on_batch(model, batches[0])
    ref_batches, ref_losses, ref_w = legs["python_uint64"]
    equal = {leg: bool(len(b) == len(ref_batches) == SURFACE_STEPS
                       and all(all(torch.equal(x, y) for x, y in zip(p, q))
                               for p, q in zip(b, ref_batches))
                       and torch.equal(losses, ref_losses) and _same_weights(w, ref_w))
             for leg, (b, losses, w) in legs.items()}
    a = {"legs": recs, "bits_equal_uint64": equal, **checks}
    emit({"phase": "surface_index_dtype", **a})
    if not all(equal.values()):
        raise AssertionError(f"phase 23 (a): batches, losses or weights differ: {equal}")
    if recs[0]["block_index_dtype"] != "uint32":
        raise AssertionError(f"phase 23 (a): the numpy engine gave {recs[0]} blocks")
    # (b) warm epochs of an ELL snapshot, verified and not
    snap = os.path.join(d, "ell.snapshot")
    model, it = _store_pipeline(path, device, parser_kw={"snapshot": snap})
    cold_dig = _Digests(device)
    cold = _store_epoch(model, it, "surface_cold", cold_dig)
    it.close()
    _launch_gate(cold, "cold", phase=23)
    warm = []
    for verify in SURFACE_VERIFY:
        rec, dig = _surface_warm_epoch(snap, device, verify, model.device_num_col())
        rec["bits_equal_cold"] = _epochs_equal([dig], [cold_dig])
        warm.append(rec)
    rates = {v: [r["rows_per_s"] for r in warm if r["verify"] == v] for v in (True, False)}
    b = {"epochs": warm, "cold_rows_per_s": cold["rows_per_s"],
         "verified_rows_per_s": statistics.median(rates[True]),
         "unverified_rows_per_s": statistics.median(rates[False]), "gpu": smi_line()}
    b["unverified_over_verified"] = b["unverified_rows_per_s"] / b["verified_rows_per_s"]
    emit({"phase": "surface_unverified_warm", **b})
    for r in warm:
        if not (r["bits_equal_cold"] and r["batches"] == cold["batches"]
                and r["k2_launches"] == r["batches"]):
            raise AssertionError(f"phase 23 (b): {r}")
    # (c) segment_csr_matvec
    c = _surface_segment(device, 0)
    emit({"phase": "surface_segment_csr_matvec", **c, "gpu": smi_line()})
    shutil.rmtree(d)
    out = {"a": a, "b": b, "c": c, "wall_s": time.monotonic() - t0,
           "k1_launches": sum(r["k1_launches"] for r in recs) + cold["k1_launches"],
           "dw_launches": sum(r["dw_launches"] for r in recs) + cold["dw_launches"],
           "k2_launches": sum(r["k2_launches"] for r in warm),
           "k1_max_abs_err": checks["k1_max_abs_err"],
           "dw_max_abs_err": checks["dw_max_abs_err"]}
    emit({"phase": "surface_total", "wall_s": out["wall_s"], "k1_launches": out["k1_launches"],
          "dw_launches": out["dw_launches"], "k2_launches": out["k2_launches"],
          "reduced": "HIGGS (UCI 280) 11,000,000 rows cut to 1,048,576 for the time limit, "
                     f"(a) to its first {SURFACE_STEPS} batches a leg; 28 features as published"})
    return out


def producer_change(now: dict) -> dict:
    """Each phase's rows/s and stall share at the default convert width
    beside PR 11's (:data:`PR11_READER`, one producer thread) and the
    registry stack's before the reader (:data:`BEFORE_READER`)."""
    rows = {k: {"rows_per_s": v[0], "stall_share": v[1],
                "pr11_rows_per_s": PR11_READER[k][0], "pr11_stall_share": PR11_READER[k][1],
                "before_rows_per_s": BEFORE_READER[k][0],
                "before_stall_share": BEFORE_READER[k][1]} for k, v in now.items()}
    out = {"phase": "producer_change",
           "producer": "NativeStreamParser (fused native reader), convert pool at 2 workers",
           "pr11": "NativeStreamParser (fused native reader), one producer thread",
           "before": "ParallelTextParser (registry stack)", "phases": rows}
    emit(out)
    return out


def run_only(which: str, repeat: int, seed: int) -> int:
    """``--only cloud|tracker|service|faults|surface``: phase 1's builds,
    phase 3's corpus, then phase 19, 20, 21, 22 or 23 ``repeat`` times, each
    in a directory of its own. ``--only adam``: phase 1's builds, phase 9
    (b)'s and (c)'s Adam A/Bs ``repeat`` times, then phase 3's corpus and
    phase 10's FM ell path. With
    ``cloud`` it also runs the burst probe against a fake whose servers
    keep ``socketserver``'s backlog of 5 and against one on the default,
    ``repeat`` times each, in turns."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    emit({**build_all(), "phase": "environment", "gpu": smi_line()})
    if which == "adam":
        for _ in range(repeat):
            adam_ab(seed)
            adam_rows_ab(seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "higgs_shaped.libsvm")
        write_higgs_corpus(path, HIGGS_ROWS, seed)
        if which == "adam":
            run_fm(path, dev, "ell")
            print(smi_line(), flush=True)
            return 0
        if which == "cloud":
            for i in range(repeat):
                for backlog in (5, None):
                    d = os.path.join(tmp, f"burst{i}_{backlog}")
                    os.makedirs(d)
                    cloud = _FakeCloudChild(d, backlog=backlog)
                    try:
                        emit({"phase": "cloud_burst_ab", "run": i, **burst_probe(cloud)})
                    finally:
                        cloud.close()
        for i in range(repeat):
            d = os.path.join(tmp, f"only{i}")
            os.makedirs(d)
            t0 = time.monotonic()
            failed = None
            try:
                {"cloud": run_cloud, "tracker": run_tracker, "service": run_service,
                 "faults": run_faults, "surface": run_surface}[which](path, d, dev)
            except AssertionError as exc:
                failed = str(exc)[:2000]
            emit({"phase": f"only_{which}", "run": i, "wall_s": time.monotonic() - t0,
                  "failed": failed})
    print(smi_line(), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: phases 2, 5 and 9 also time "
                         "its K1, its K2 route (a one-segment K2) and its row scatter "
                         "beside this one's, in turns")
    ap.add_argument("--parallel-child", nargs="+", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--only", choices=["cloud", "tracker", "service", "faults", "surface",
                                       "adam"],
                    default=None,
                    help="build, write phase 3's corpus and run phase 19, 20, 21, 22 or 23 "
                         "alone (--repeat times), or phase 9 (b)'s Adam A/B (--repeat "
                         "times) and phase 10's FM ell path; no kernels line and no "
                         "result line")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.parallel_child:
        return parallel_child(args.parallel_child)
    if args.only:
        return run_only(args.only, args.repeat, args.seed)
    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False  # the dense margin in full fp32
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = smi_line()

    # phase 1
    env = build_all()
    env.update(phase="environment", gpu=smi, torch=torch.__version__,
               cuda=torch.version.cuda, device_name=torch.cuda.get_device_name(0))
    emit(env)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        assert_native_engine(tmp)
        # phases 2 and 5 (these launches are comparisons, not the main path's)
        parent = load_parent_libs(args.parent, tmp) if args.parent else {}
        k1_rows = phase_k1(args.seed, parent.get("ell_matvec"))
        k2_rows = phase_k2(args.seed, parent.get("widen_span"))

        path = os.path.join(tmp, "higgs_shaped.libsvm")
        t0 = time.monotonic()
        corpus = write_higgs_corpus(path, HIGGS_ROWS, args.seed)
        emit({"phase": "corpus", **corpus, "write_s": time.monotonic() - t0,
              "reduced": "HIGGS (UCI 280) 11,000,000 rows cut to 1,048,576 "
                         "for the time limit; 28 features as published"})

        # phase 3: the counts are zeroed just before the main path
        k1.launches = k1.dw_launches = 0
        main_path = run_main_path(path, dev)
        launches, dw_launches = k1.launches, k1.dw_launches
        need = main_path["steps"] + main_path["accuracy_batches"]
        emit({"phase": "main_path", "accuracy": main_path["accuracy"],
              "fit_s": main_path["fit_s"], "accuracy_s": main_path["accuracy_s"],
              "parse_engine": main_path["engine"], "k1_launches": launches,
              "k1_launches_needed": need, "dw_launches": dw_launches,
              "dw_launches_needed": main_path["steps"]})
        if launches < need:
            raise AssertionError(f"K1 launched {launches} times, main path needs {need}")
        if dw_launches < main_path["steps"]:
            raise AssertionError(f"the dw kernel launched {dw_launches} times for "
                                 f"{main_path['steps']} steps")
        if not main_path["accuracy"] > 0.9:
            raise AssertionError(f"accuracy {main_path['accuracy']} <= 0.9")
        if not all(np.isfinite(e["loss"]) for e in main_path["epochs"]):
            raise AssertionError("non-finite epoch loss")

        first = compare_first_losses(path, dev)
        again_losses, again_weight = card_trajectory(path, dev)
        repeatable = (torch.equal(first["card_losses"], again_losses)
                      and torch.equal(first["card_weight"], again_weight))
        emit({"phase": "first_losses_vs_cpu", "steps": first["steps"],
              "max_rel_diff": first["max_rel_diff"], "card_bit_identical_twice": repeatable})
        if first["steps"] != 20 or not first["max_rel_diff"] <= 1e-4:
            raise AssertionError(f"first 20 losses differ from the CPU route: {first['losses']}")
        if not repeatable:
            raise AssertionError("two 20-step runs on the card differ")

        # phase 4
        dense = run_dense_epoch(path, dev)
        emit(dense)
        if not all(np.isfinite(dense[r]["loss"]) and dense[r]["loss"] < np.log(2)
                   for r in ("emit", "csr")):
            raise AssertionError(f"dense epoch loss: {dense}")
        if dense["emit"]["block_kinds"].get("RowBlock") or dense["csr"]["block_kinds"].get(
                "DenseBlock"):
            raise AssertionError(f"dense epoch routes: {dense}")

        # phase 6: the warm paths, each with its counts zeroed just before
        ell_snap = os.path.join(tmp, "ell.snapshot")
        warm_ell = run_warm_ell(path, ell_snap, dev)
        emit(compare_warm_routes(path, ell_snap, dev, num_col=HIGGS_COLS,
                                 layout="ell", max_nnz=HIGGS_COLS))
        emit(run_healing(tmp, dev, args.seed))
        warm_dense, snaps = [], {}
        for phase, opts in WARM_DENSE.items():
            snaps[phase] = os.path.join(tmp, f"{phase}.snapshot")
            warm_dense.append(run_warm_dense(path, snaps[phase], dev, phase))
            emit(compare_warm_routes(path, snaps[phase], dev, num_col=HIGGS_COLS + 1,
                                     layout="dense", pack_aux=True, **opts))
        # phase 7, its launches counted from 0
        k1.launches = k1.dw_launches = dd.launches = 0
        ckpt = run_checkpoint(path, ell_snap, dev, corpus["bytes"])
        ckpt_k1, ckpt_dw, ckpt_k2 = k1.launches, k1.dw_launches, dd.launches
        # phase 8
        bcoo = run_bcoo(path, dev)
        # phase 9: ALS at examples/train_als.py's full size, then the A/B of
        # the row scatter's routes; phase 10: FM on the HIGGS-shaped corpus.
        # Each path's row-scatter launches are counted from 0
        ratings = os.path.join(tmp, "ratings.libsvm")
        emit({"phase": "ratings_corpus", **write_ratings_corpus(ratings, args.seed),
              "reduced": "none: examples/train_als.py's full run (4096 users, 512 items, "
                         "16 factors, 32 ratings a row, batch 512)"})
        als = run_als(ratings, dev)
        rs_rows = row_scatter_ab(args.seed, parent.get("row_scatter"))
        adam_rows = adam_ab(args.seed)
        adam_rows_ab(args.seed)
        fm = {layout: run_fm(path, dev, layout) for layout in FM_EPOCHS}
        emit({"phase": "fm_vs_linear", "fm_step_device_ms": {
            k: v["step_device_ms"] for k, v in fm.items()}})
        # phase 11: data parallelism, its launches counted in its children
        par = run_parallel(path, ratings, tmp, dev, args.seed)
        par_k1 = par["world1"]["k1_launches"] + par["pair"]["launches"]["k1"]
        par_dw = par["world1"]["dw_launches"] + par["pair"]["launches"]["dw"]
        # phase 12: the block cache and the epoch planner, each leg with
        # its launches counted from 0 around its main path
        t12 = time.monotonic()
        bc_als = run_block_cache_als(tmp, dev)
        bc_higgs = run_block_cache_higgs(path, tmp, dev)
        bc_snap = run_shuffled_snapshot(path, ell_snap, dev)
        emit({"phase": "block_cache_total", "wall_s": time.monotonic() - t12})
        # phase 13: the csv and libfm formats, each leg's launches counted
        # from 0 around its main path
        formats = run_formats(tmp, dev, args.seed)
        # phase 14: the fused native reader's routes on phases 3's and 13's
        # corpora, each leg's launches counted from 0 around its main path
        native = run_native_reader(path, formats["kdd_path"], tmp, dev)
        # phase 11's feature sharding: (a) the windowed kernels, (c)-(f) on
        # phases 3's, 9's and 13's corpora ((b) ran in phase 11's world-1
        # child), each leg's launches counted around its steps
        fs = run_feature_sharding(path, ratings, formats["kdd_path"], tmp, dev, args.seed,
                                  k1_rows[0], par["fs_world1"])
        os.remove(formats["kdd_path"])
        # phase 15: the convert pool's widths, the read pool's, the sampled
        # transfer behind a spin and the trace modes, each leg's launches
        # counted from 0 around its main path
        pools = run_pools(path, tmp, dev)
        csv_legs = {leg["leg"]: leg for leg in formats["csv"]["legs"]}
        producer_change({
            **{f"main_path_epoch{e['epoch']}": (e["rows_per_s"], e["stall_share"])
               for e in main_path["epochs"]},
            "dense_emit": (dense["emit"]["rows_per_s"], dense["emit"]["stall_share"]),
            "dense_csr": (dense["csr"]["rows_per_s"], dense["csr"]["stall_share"]),
            "warm_ell_epoch0_cold": (warm_ell["epochs"][0]["rows_per_s"],
                                     warm_ell["epochs"][0]["stall_share"]),
            "checkpoint_uninterrupted": (ckpt["native"]["uninterrupted_rows_per_s"], None),
            "bcoo": (bcoo["rows_per_s"], bcoo["stall_share"]),
            "bcoo_natural": (bcoo["natural_rows_per_s"], None),
            "block_cache_higgs_cold": (bc_higgs["epochs"][0]["rows_per_s"],
                                       bc_higgs["epochs"][0]["stall_share"]),
            "csv_dense_cold_emit": (csv_legs["dense_cold_emit"]["rows_per_s"],
                                    csv_legs["dense_cold_emit"]["stall_share"]),
            "csv_ell_cold": (csv_legs["ell_cold"]["rows_per_s"],
                             csv_legs["ell_cold"]["stall_share"]),
            "libfm_linear_bcoo": (formats["libfm"]["linear_bcoo"]["rows_per_s"],
                                  formats["libfm"]["linear_bcoo"]["stall_share"]),
            "libfm_fm_ell": (formats["libfm"]["fm_ell"]["rows_per_s"],
                             formats["libfm"]["fm_ell"]["stall_share"])})
        # the profiler's windows: the decode's first (a window opened after
        # others has recorded nothing now and then), then the steps'
        emit(profile_decodes({p: snaps[p] for p in ("warm_dense_bfloat16", "warm_dense_q8")},
                             dev, HIGGS_COLS + 1))
        step = step_times(path, dev)
        check_no_scatter(step)
        step["device_busy_share_est"] = (
            step["step_device_ms"] * main_path["steps"] / 1e3 / main_path["fit_s"])
        emit(step)
        warm_step = step_times(path, dev, snapshot=ell_snap)
        warm_epoch = warm_ell["epochs"][-1]
        warm_step["device_busy_share_est"] = (
            warm_step["step_device_ms"] * warm_epoch["batches"] / 1e3 / warm_epoch["wall_s"])
        emit(warm_step)
        check_no_scatter(warm_step)
        emit(bcoo_step_profile(path, dev))
        emit(step_profile("als", als.pop("step_fn")))
        for layout, r in fm.items():
            emit(step_profile(f"fm_{layout}", r.pop("step_fn")))
        for leg, fn in formats["libfm"].pop("step_fns").items():
            emit(step_profile(f"libfm_{leg}", fn, top=12))
        emit(launch_queue_depth())
        step_ms = {"linear_ell": step["step_device_ms"],
                   **{f"fm_{k}": v["step_device_ms"] for k, v in fm.items()},
                   "als": als["step_device_ms"]}
        emit({"phase": "step_device_ms", "steps": step_ms})
        # phase 16: the autotuner on the card, each leg's launches counted
        # from 0 around its main path. It runs after the profiler windows:
        # a window opened after a pipeline ran behind a spin can miss a
        # device event (PERF.md §7)
        tune = run_autotune(path, tmp, dev)
        # phase 17: the tiered artifact store and the split layer on phase 3's
        # corpus, each leg's launches counted around its epochs
        store17 = run_store(path, tmp, dev)
        # phase 18: the filesystem registry (mem://) and the chunk feeder, the
        # native-batch engine, the row iterators and the native RecordIO
        # engines, each leg's launches counted around its epochs
        host18 = run_host_io(path, tmp, dev, args.seed)
        # phase 19: the cloud filesystems beside a fake cloud in a child
        # process, each leg's launches counted around its epochs
        cloud19 = run_cloud(path, tmp, dev)
        # phase 20: the tracker, its ranks' launches counted around their epochs
        pod20 = run_tracker(path, tmp, dev)
        # phase 21: the data service, each leg's launches counted around its epochs
        svc21 = run_service(path, tmp, dev)
        # phase 22: fault plans against the learners, each leg's launches
        # counted around its epochs (the child's in the child)
        faults22 = run_faults(path, tmp, dev, warm_ell["epochs"][-1]["rows_per_s"])
        # phase 23: the surface on the card, each leg's launches counted
        # around its epochs
        surf23 = run_surface(path, tmp, dev)

    emit({"phase": "total", "wall_s": time.monotonic() - t_start})
    k1_main = k1_rows[0]
    k2_main = next(r for r in k2_rows["kinds"] if r["kind"] == K2_MAIN)
    rs_main = next(r for r in rs_rows if r["shape"] == ROW_SCATTER_MAIN)
    adam_main = next(r for r in adam_rows if r["shape"] == ADAM_MAIN)
    emit({"kernels": [{
        "name": "ell_matvec", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/ell_matvec.cu",
        "replaces": "dmlc_tpu/ops/pallas_sparse.py:122",
        "launches": (launches + warm_ell["k1_launches"] + ckpt_k1 + par_k1
                     + bc_higgs["k1_launches"] + bc_snap["k1_launches"]
                     + formats["csv"]["k1_launches"] + native["ell"]["k1_launches"]
                     + pools["convert"]["k1_launches"] + pools["read"]["k1_launches"]
                     + pools["spin"]["k1_launches"] + fs["launches"]["k1"]
                     + tune["k1_launches"] + store17["k1_launches"] + host18["k1_launches"]
                     + cloud19["k1_launches"] + pod20["k1_launches"] + svc21["k1_launches"]
                     + faults22["k1_launches"] + surf23["k1_launches"]),
        "max_abs_err": max([r["max_abs_err"] for r in k1_rows]
                           + [fs["kernels"]["max_abs_err"], tune["cold"]["k1_max_abs_err"],
                              store17["cachefile"]["k1_max_abs_err"],
                              host18["mem"]["k1_max_abs_err"],
                              cloud19["s3"]["k1_max_abs_err"], pod20["k1_max_abs_err"],
                              svc21["k1_max_abs_err"], faults22["k1_max_abs_err"],
                              surf23["k1_max_abs_err"]]),
        "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_main["library_ms"]}, {
        "name": "ell_matvec_dw", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/ell_matvec_dw.cu",
        "replaces": "dmlc_tpu/ops/pallas_sparse.py:191",
        "launches": (dw_launches + warm_ell["dw_launches"] + ckpt_dw + par_dw
                     + bc_higgs["dw_launches"] + bc_snap["dw_launches"]
                     + formats["csv"]["dw_launches"] + native["ell"]["dw_launches"]
                     + pools["convert"]["dw_launches"] + pools["read"]["dw_launches"]
                     + pools["spin"]["dw_launches"] + fs["launches"]["dw"]
                     + tune["dw_launches"] + store17["dw_launches"] + host18["dw_launches"]
                     + cloud19["dw_launches"] + pod20["dw_launches"] + svc21["dw_launches"]
                     + faults22["dw_launches"] + surf23["dw_launches"]),
        "max_abs_err": max([r["dw_kernel_max_abs_err"] for r in k1_rows
                            if r["dw_route"] == "cuda"]
                           + [fs["kernels"]["dw_max_abs_err"], tune["cold"]["dw_max_abs_err"],
                              store17["cachefile"]["dw_max_abs_err"],
                              host18["mem"]["dw_max_abs_err"],
                              cloud19["s3"]["dw_max_abs_err"], pod20["dw_max_abs_err"],
                              svc21["dw_max_abs_err"], faults22["dw_max_abs_err"],
                              surf23["dw_max_abs_err"]]),
        "ms": k1_main["dw_ms"], "plain_ms": k1_main["dw_plain_ms"],
        "bound_ms": k1_main["dw_bound_ms"], "bound_by": k1_main["dw_bound_by"],
        "library_ms": k1_main["dw_library_ms"]}, {
        "name": "widen_span", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/widen_span.cu",
        "replaces": "dmlc_tpu/ops/device_decode.py:168",
        "launches": (warm_ell["k2_launches"] + sum(d["k2_launches"] for d in warm_dense)
                     + ckpt_k2 + bc_snap["k2_launches"] + formats["csv"]["k2_launches"]
                     + native["dense"]["k2_launches"] + pools["read"]["k2_launches"]
                     + tune["k2_launches"] + store17["k2_launches"] + host18["k2_launches"]
                     + cloud19["k2_launches"] + svc21["k2_launches"] + faults22["k2_launches"]
                     + surf23["k2_launches"]),
        "max_abs_err": max([r["max_abs_err"] for r in k2_rows["kinds"] + k2_rows["segments"]]
                           + [faults22["k2_max_abs_err"]]),
        "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"]}, {
        "name": "row_scatter", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/row_scatter.cu",
        "replaces": "dmlc_tpu/models/als.py:169",
        "launches": als["row_scatter_launches"] + sum(
            v["row_scatter_launches"] for v in fm.values())
        + par["pair"]["launches"]["row_scatter"] + bc_als["row_scatter_launches"]
        + formats["libfm"]["linear_bcoo"]["row_scatter_launches"]
        + formats["libfm"]["fm_ell"]["row_scatter_launches"]
        + formats["xor"]["row_scatter_launches"]
        + native["coo"]["row_scatter_launches"] + fs["launches"]["row_scatter"]
        + svc21["row_scatter_launches"],
        "max_abs_err": max([r["row_scatter"]["max_abs_diff_vs_plain"] for r in rs_rows]
                           + [als["main_path_scatter_vs_plain"]["max_abs_err"]]),
        "ms": rs_main["row_scatter"]["ms"], "plain_ms": rs_main["plain_ms"],
        "bound_ms": rs_main["bound_ms"], "bound_by": rs_main["bound_by"],
        "library_ms": rs_main["library_ms"]}, {
        "name": "adam_step", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/adam_step.cu",
        "replaces": "none: torch.optim.Adam's foreach update (optax.adam, left to XLA)",
        "launches": sum(v["adam_launches"] for v in fm.values()),
        "max_abs_err": max(r["max_abs_err"] for r in adam_rows),
        "ms": adam_main["ms"], "plain_ms": adam_main["plain_ms"],
        "bound_ms": adam_main["bound_ms"], "bound_by": adam_main["bound_by"],
        "library_ms": adam_main["library_ms"]}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
