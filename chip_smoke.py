"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device::

    python3 chip_smoke.py

It uses one card: the first one ``CUDA_VISIBLE_DEVICES`` names, card 0 when
that is unset. Phases (any failure exits non-zero before the result line):

1. build every CUDA kernel of ``metrics_tpu_torch/csrc`` with ``nvcc``, all
   sources at once;
2. hold each kernel against its plain PyTorch version on the card:

   a. the one-stream scan (``tie_scan``) at the shapes the binary path gives
      it and at the hazards (block edges, one tie group, masking, bucket
      offsets, a positive class above 2^24), and the 1M-element AUROC/AP
      against float64 numpy oracles;
   b. the class-batched scan (``tie_scan_rows``) at ``(1, 1)``,
      ``(3, 4097)``, ``(7, 32769)``, ``(80, 40504)`` and ``(1000, 50000)``,
      with a one-group row, a row without positives and a signed-zero row,
      and at ``(131073, 3)``, more rows than a grid's y dimension holds;
      every row must also equal the one-stream scan of that row, bit for
      bit;
   c. the weighted one-stream scan (``tie_scan_w``) at the edge sizes and at
      45,840,617 elements (the Criteo Display Advertising Challenge
      training set's rows), lognormal weights; zero weights against the
      masked unweighted scan, unit weights against the unweighted scan
      (within 1e-6), and tiny totals, which must not read as degenerate;
      10 more launches at 45,840,617 must give the same bits (the tiles'
      look-back windows differ from launch to launch);
   c′. the bucket-offset form on its path: a 1M stream cut into 4 key-range
      buckets at the sample sort's own splitter rule, ``_tie_stats`` /
      ``_tie_stats_w`` on each bucket with its lower-bucket class totals as
      offsets; the buckets must sum to the one-stream result within 1e-6;
   d. the weighted batched scan (``tie_scan_rows_w``) at the row shapes of
      b; every row must equal the weighted one-stream scan of that row, bit
      for bit, and 10 more launches at ``(1000, 50000)`` the same bits;

3. the binary main path: ``MetricCollection([Accuracy(), AUROC(pos_label=1)])``
   on ``cuda``, 10 forward batches of 100,000 seeded predictions, then
   ``compute()``, checked against numpy, with the kernel's launch count;
3b. the sharded binary path: ``MetricCollection([ShardedAUROC(...),
   ShardedAveragePrecision(...)])`` with ``capacity_per_device=45,840,617``
   and ``with_sample_weights=True`` on ``cuda``, seeded scores, labels with
   P(1) = score and lognormal weights appended in batches of 4,194,304 (the
   last short), then ``compute()``: against float64 numpy oracles, exactly
   one weighted launch per metric compute and no plain-version call on the
   card; the unweighted ``ShardedAUROC`` of the same stream equal to
   ``AUROC(pos_label=1)`` within 1e-6;
3c. the binary curves on phase 3's 1M predictions: ``ROC(pos_label=1)`` and
   ``PrecisionRecallCurve(pos_label=1)`` over the 10 batches, equal in
   length and thresholds to a float64 numpy oracle and within 1e-6 in
   their points, then ``AUC()`` of that ROC; ``AUROC(pos_label=1,
   max_fpr=0.1)`` against the McClish value of the oracle; functional
   ``auroc`` and ``average_precision`` with lognormal ``sample_weights``
   against the weighted oracle, one ``tie_scan_w`` launch each and no
   plain-version call; ``ShardedROC`` / ``ShardedPrecisionRecallCurve`` at
   world 1 equal to ``ROC`` / ``PrecisionRecallCurve``; the curve of phase
   2a's 20M stream (1,001 scores, the positive class above 2^24) with int32
   counts equal to numpy's int64 ones;
4. the multi-class main path at the ImageNet-1k validation shape (ILSVRC2012
   val: 50,000 images, 1,000 classes, 50 per class):
   ``MetricCollection([Accuracy(), AUROC(num_classes=1000),
   AveragePrecision(num_classes=1000)])`` on ``cuda``, 10 update batches of
   5,000 seeded softmax scores, then ``compute()``: Accuracy equal to
   numpy's, macro AUROC and every class's AP against float64 oracles, and
   exactly one batched launch per AUROC and per AP compute; then one
   ``forward``; then per-label AUROC at the MS-COCO 2014 val shape (40,504
   images, 80 labels) against the oracles;
4b. the sharded one-vs-rest path at the same shape and data with lognormal
   sample weights: ``ShardedAUROC`` and ``ShardedAveragePrecision`` with
   ``num_classes=1000``, ``capacity_per_device=50,000``,
   ``with_sample_weights=True`` and ``average="weighted"``; against float64
   oracles, exactly one weighted batched launch per metric compute;
4c. per-class curves on phase 4's data: ``ROC(num_classes=1000)`` and
   ``PrecisionRecallCurve(num_classes=1000)`` against the oracle for every
   class; weighted per-class ``auroc`` / ``average_precision``, one
   ``tie_scan_rows_w`` launch each; multi-label ``average="micro"`` AUROC
   at the MS-COCO shape, one ``tie_scan`` launch; the host
   synchronizations of one per-class curve compute, counted with
   ``torch.cuda.set_sync_debug_mode``, the same at C = 10 and C = 1000;
4d. the binned curves with 512 bins, binary at 1M and one-vs-rest at
   50,000 x 1,000, unweighted and weighted: histograms against numpy's
   counts (exact, or within 1e-5 relative weighted), values within 1e-6 of
   a float64 evaluation of the same histograms;
4e. the stat-score and confusion-matrix family (no scan kernel; counts in
   label space, ``label_bincount``): (a) the JAX bench's forward leg,
   ``MetricCollection([Accuracy(), Precision(num_classes=4,
   average="macro"), Recall(...), F1(...)])``, 10 forward batches of 100,000
   seeded 4-class probabilities, counts equal to numpy's and values within
   1e-6; (b) at the ImageNet-1k val shape, phase 4's data in 10 update
   batches: ``StatScores`` (macro), Precision/Recall/F1 macro and weighted,
   top-5 ``Precision``, ``ConfusionMatrix(normalize="true")``, quadratic
   ``CohenKappa``, ``MatthewsCorrcoef``, ``IoU``, ``HammingDistance``,
   Crammer-Singer ``Hinge`` and functional ``dice_score``, against float64
   oracles; (c) at the MS-COCO 2014 val shape, multi-label ``StatScores``
   (micro, macro), macro ``F1``, ``HammingDistance`` and the ``(80, 2, 2)``
   ``ConfusionMatrix``; (d) Cityscapes val, 500 images of 1024 x 2048
   pixels and 19 classes, made on the card 4 images a batch:
   ``ConfusionMatrix``, ``IoU``, macro ``StatScores`` (counts past 2^24,
   exact) and samplewise macro ``F1`` against numpy's int64 counts of
   ``target * 19 + argmax``; the host synchronizations of one update at
   C = 19 and C = 1,000 (equal), also with ``torch.bincount`` in place of
   ``label_bincount``; MCC's float32 gap to float64;
4f. the regression pack and metric arithmetic (no scan kernel), against
   float64 numpy/scipy oracles: (a) the JAX bench's regression forward leg
   (``bench.py:463-464, 535``), ``MetricCollection([MeanSquaredError(),
   MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()])``, 10
   forward batches of 100,000 seeded rows, every value within 1e-5
   relative, the shared moments computed once per batch and equal to each
   metric's own, 0 host synchronizations per update; functional
   ``mean_squared_log_error`` / ``mean_relative_error`` on the same rows and
   a 2-output adjusted ``R2Score``; (b) BASELINE config 4's 16 x 3 x 128 x
   128 images: ``psnr``, ``PSNR()`` over 4 batches, per-image ``PSNR`` and
   ``ssim`` (the banded blur); (c) the convolution blur: ``SSIM()`` over the
   Kodak PhotoCD set's shape (24 x 3 x 512 x 768, 6 batches of 4) and
   ``ssim`` over 4 x 3 x 1024 x 2048 frames. (b) and (c) run with TF32
   switched on globally (``cudnn.allow_tf32``,
   ``set_float32_matmul_precision("high")``); SSIM must stay within 1e-6 of
   float64 and the flags must read the same afterwards; one ``SSIM.update``
   causes 0 synchronizations. (d) ``MeanSquaredError() ** 0.5`` over (a),
   and ``(Precision + Recall) / 2`` (macro, 4 classes) forwarded over 4e's
   forward-leg batches, whose ``compute()`` must be the epoch's value;
4g. the retrieval family (no kernel of its own), against a float64 numpy
   oracle (a lexsort by query id, -score and position; per-query AP, RR,
   P@10, R@100; the mean over the queries with a relevant document): (a)
   BASELINE config 5, the JAX bench's retrieval leg (``bench.py:1455-1533``):
   1M rows, ids uniform over 10,000 queries, uniform scores, 5% relevant,
   ``MetricCollection([RetrievalMAP(), RetrievalMRR()])`` fed 10 batches of
   100,000, and the functional core (``ranked_group_stats``,
   ``_map_segments``, ``_mrr_segments``); (b) the host synchronizations
   and device-to-host bytes of one compute of MAP, MRR, P@10 and R@100 at
   100 and 10,000 queries over the same 1M rows (equal; a few scalars);
   (c) config 5's epoch at world 1 (``bench.py:246-270``): one update and
   one compute of Accuracy + F1, ``ShardedAUROC``, ``ShardedRetrievalMAP`` and
   ``ShardedRetrievalMRR``; (d) the MS MARCO passage ranking dev (small)
   set's shape, 6,980 queries x 1,000 candidates with 7,437 relevant rows,
   fed 100 queries a batch to MAP, MRR, P@10 and R@100, with the compute's
   peak memory, both forms of the ranking sort timed, and the functional
   forms on one query. Every value within 1e-5 of the oracle, the integers
   (relevant counts, first relevant ranks, hits in the top 10 and 100)
   equal to its, a second compute's bits equal, and the sharded metrics at
   world 1 equal to the unsharded ones bit for bit;
4h. the step engine (``MetricCollection(compiled=True)``: one CUDA graph per
   call signature; no scan kernel of its own): (a) 4e's forward leg, 10
   batches of 100,000 and the JAX bench's 1M x 4 batch, and (b) 4f's
   regression leg, each against the eager collection: values within 1e-6
   relative and counts exact every step and at the epoch, no demotion, one
   build, 0 host synchronizations in a replayed step, the forward batch ms of
   both, a replayed step's device time (steps queued behind a device sleep),
   the first step's warm-up and capture ms and the graph's pool; (c)
   the stat-score siblings' shared count: host synchronizations and device
   kernels of one eager forward of the four metrics in a collection (2
   syncs) and alone (4); (d) the binary step over phase 3's batches,
   Accuracy captured and AUROC eager (as in the JAX package: it does not
   opt into the fused forward), values equal to eager, one tie-scan launch
   per batch value and per compute; (e) a demotion: ``StatScores()`` on
   label inputs cannot infer its one-hot width inside a graph, is demoted
   with JAX's reason while Accuracy stays captured, and the card stays
   usable; (f) ``BootStrapper(Accuracy(), 20)`` with both samplers (host
   synchronizations of a draw: 0 multinomial, 1 Poisson),
   ``embedding_similarity`` at (512, 256) within 1e-5 of float64 under
   global TF32 flags (restored after), ``image_gradients`` over 4 x 3 x 1024
   x 2048 equal to numpy, ``bleu_score`` on the card equal to the CPU's;
4i. the multi-tenant cohort (``MetricCohort``: the step function vmapped over
   a tenant axis, one CUDA graph per call signature and capacity bucket; no
   scan kernel of its own): the JAX bench's cohort leg (``bench.py:539-663``:
   Accuracy + macro Precision / Recall / F1 at 4 classes, 64 rows a tenant)
   at 1, 64, 1,024 and 10,000 tenants (capacities 2, 64, 1,024, 16,384): the
   step ms, a replayed step's device time, the kernels of one graph replay
   (equal at capacities 64, 1,024 and 16,384: no per-tenant loop), the
   first step (warm-up and capture), the graph's pool and 0 host
   synchronizations a replayed step; 64 ``compiled=True`` collections
   stepped one after another on the same rows (the bench's ``COHORT_SEQ64``)
   and the two ratios; at 1,024 tenants with grid-valued rows, 3 steps with
   a ``remove_tenant`` / ``add_tenant`` and a grow to 2,048 slots between
   them: 16 sampled tenants' states and ``compute()`` equal to a compiled
   collection run alone on the same rows (counts exact, floats bit-equal),
   and the health accumulators' rows and updates equal numpy's counts; the
   regression pack as a cohort of 1,024 (states bit-equal, values within 8
   ulp); ``route_rows`` of a shuffled tagged stream of 10,000 x 64 rows
   equal to the dense layout; a cohort of ``AUROC`` refused with the
   engine's reason;
4j. the observability core (``metrics_tpu_torch.observability``): phase 3's
   binary step, phase 4h's compiled forward leg and phase 4i's cohort at
   1,024 tenants (health pinned off, so both runs replay one program), each
   run with telemetry, span tracing and the flight recorder all off and then
   all on: values and states bit-equal, 0 host synchronizations a replayed
   step with them on, the same kernels and copies a step off and on, and the
   forward / compute / step ms off and on (host clock ending in a
   synchronize, median of 5, in turns); the span recording's phases
   (canonicalize, update, compute, dispatch) and its Perfetto export, which
   must round-trip through ``json``; the engine counters equal to the
   signature arithmetic (two signatures: 2 misses, 11 hits, 13 dispatches,
   2 update calls = 2 builds) with 0 retraces at steady state, and a
   12-shape loop giving exactly one watchdog verdict, one warning and one
   flight dump that parses and carries the identity stamp; under
   ``torch.profiler`` with telemetry on, the ``tie_scan`` kernel and the
   co-sort of one north-star ``compute()`` inside the
   ``metrics_tpu.AUROC.compute`` range and every kernel of a compiled replay
   inside the engine's range, with the device ms of each range;
4k. the sync tiers (``sync_precision=``, the two-level sync, ``SyncPolicy``):
   (a) the int8 / bf16 codec on phase 4's 1,000-class x 512-bin histograms
   (``BinnedAUROC``) and a ``ConfusionMatrix(num_classes=1000)``: codes,
   scales, bf16 payloads, residuals and an 8-way merge equal to the CPU's
   bits, 0 host synchronizations (sync debug mode "error"), the codec's
   device ms (CUDA events) beside its byte bound; (b) those metrics synced
   at each tier over an 8-rank mirror world (flat) and under
   ``faultinject.simulated_pods(2, 4)`` (two-level): exact exactly 8x local,
   bf16 and int8 within their bounds, payload over wire bytes at least 2.0
   (bf16) and 3.0 (int8; the two-level path's level-1 link), the sync ms
   (host clock ending in a synchronize, median of 5); (c) the per-level
   drills on the int8 ``ConfusionMatrix``: ``flaky_level(1)`` retried to the
   clean sync's bits, ``pod_dropout(1)`` serving exactly the level-0 result
   (4x), a level-0 failure falling back to local (1x), no residual committed
   on either degradation; (d) the north-star step (Accuracy + AUROC over
   phase 3's 1M) synced through ``flaky_sync_backend(fails=2)`` under a
   ``SyncPolicy``: the unfaulted step's values, the ``tie_scan`` kernel
   launched in its ``compute()``; and exact two-level syncs sending as many
   level-1 bytes as the payload (int32 partials of int32 states);
4l. the reliability layer (``reliability``): (a) the north-star collection
   after 10 steps of 1M predictions saved to a checksummed envelope, written,
   read and strictly loaded into a fresh collection on the card, its
   ``compute()`` bit-equal, its checksum equal to the CPU copy's, the four
   ``corrupt_envelope`` modes each rejected with its typed error, and the
   save / write / read / load ms (host clock, median of 5); (b) a
   ``StateGuard`` in phase 4h's compiled regression leg: the unguarded
   replay's kernels and 0 host synchronizations, the guarded replay's one
   (its stacked finite flags), the unguarded graph unchanged after the guard
   goes off, a NaN batch under ``quarantine`` leaving every state bit-equal
   to the run without it, ``raise`` raising with the states unmoved,
   ``warn`` keeping the NaN, and the replay ms off and on; (c) a cohort of
   1,024 regression tenants under ``quarantine`` with 3 tenants poisoned:
   only those roll back (to a run without that step), the other 1,021 are
   bit-equal to the unpoisoned run, ``health()["guard_verdicts"]`` names
   exactly the 3; (d) an ``EvalSession`` over the north-star step, 20 steps
   of 1M with a checkpoint every 5, preempted at step 12: a new session
   resumes at cursor 10 and, rerun to step 20, computes bit-equal to the
   uninterrupted run with one ``tie_scan`` launch; after a torn newest
   generation the resume falls back to the one before it; the checkpoint
   steps' and the resume's ms;
   4m. ``serving/``: (a) the JAX bench's serving leg uncut (1M 4-class rows,
   the forward leg compiled, 12 steps of a host sleep of 1.5 x the blocking
   metric cost, at least 20 ms): step ms blocking and through an
   ``AsyncServingEngine`` (the drain inside the timed window), p50 / p95 /
   p99, the overhead over the measured sleep, the cold first dispatch and
   each dispatch's stage-to-device-complete ms, the values bit-equal;
   (b) the same loop with the model's time as a device sleep on the
   caller's stream, each step synchronizing that stream only: a worker on
   the caller's or the legacy default stream would show no overlap here;
   (c) ``IngestQueue``, 64 tenants x 256 rows x 8 waves into a cohort,
   directly and behind a pipeline: rows/s, values bit-equal to direct
   ``route_rows`` forwards; (d) ``EvalSession(background_checkpoints=True)``
   over phase 4l's session: the checkpointing steps' ms, submit-to-commit
   ms, the background envelope's checksum equal to the synchronous one's,
   a preemption mid background write resumed bit-equal with one
   ``tie_scan`` launch in ``compute``; (e) admission: the north-star
   collection refused (AUROC) and served blocking with one ``tie_scan``
   launch in ``compute``, the two hazard metrics refused, and ``.item()``
   on the serve loop while the worker replays without a raise;
4n. the export surface and the cost ledger (``observability/exporter.py``,
   ``costledger.py``): (a) 4m's 64-tenant health-armed cohort and 4h's
   compiled forward leg with the exporter and the ledger off and then armed
   (``exporter_scope(port=0)``, ``cost_ledger_scope()``): values, states and
   health bit-equal, the same kernels and copies a replay and a step (off
   and armed traced in turns, the pair of a round with the same multiset
   of device records; each disagreeing round's difference is printed); (b)
   that cohort served through an ``AsyncServingEngine`` while an
   ``EvalSession(background_checkpoints=True)`` over the north-star
   collection takes 10 steps of 100,000 beside it and a client thread
   scrapes ``/metrics`` and ``/healthz`` 50 times each (urllib, a timeout on
   each): every scrape parses with ``parse_prometheus_text``, carries the 64
   tenants' rows of whole steps, the session gauges and the compile and
   per-program families; scrape ms; (c) ``/healthz`` degraded after an
   injected SLO breach; (d) the serve-loop step with and without a
   concurrent scrape, in turns; (e) a worker step held behind a device
   sleep while a scrape waits on its health event: the serve loop's
   forward, allocation and launch return before the scrape, which reads
   the step it waited on (and, for comparison, the same read into pageable
   memory), and ``health()`` alone pinned and pageable; (f) the cold count
   equal to the signatures built, a forced LRU eviction counted as one warm
   build, ``engine.compile_ms`` per build; (g) the session's ``compute()``
   over 1M rows: one ``tie_scan`` launch, within 1e-5 of float64 and 1e-6
   of the plain scan;
4o. the elastic fleet (``fleet/``), every shard's cohort on the card, in two
   parts: (a), (b), (e), (h) and (f) after 4n (``_fleet_phase``), and the
   failover leg and the kills, (c), (g) and (d), last, after phase 6
   (``_fleet_failover_phase``: minutes of host work, which no profiler read
   follows): (a) the JAX bench's fleet leg (``bench.py:676-727``):
   10,000 keys over two shards and a third added, the churn ratio (bar
   0.45, equal to the rendezvous rule computed here from ``hashlib``) and
   the rescan ms; (b) 24 two-phase handoffs of ``MeanSquaredError`` tenants
   between two live shards after a warm-up move: ms a tenant, every tenant
   on exactly one side, states bit-equal; (c) the failover leg
   (``bench.py:756-915``) at 300 tenants (``FLEET_FAILOVER_TENANTS``; the
   bench's 10,000 spent 131-155 s a replicate cycle on the card's host, 1,000
   up to 47.5 s the whole leg, and
   the kill schedule at 10,000 stays on the CPU in
   ``tests/test_torch_fleet_chaos.py``): 3 leased shards, 2 rows x 8
   features a tenant a step, a replicator, the dead shard's waves 4-5
   retained by an ``IngestQueue(redelivery_window=8)``: first and delta
   replicate ms, steady lag (0), failover to the first redelivered wave,
   rows redelivered (exactly 2 x dead tenants x 2), every tenant bit-equal
   to a never-failed twin with a promoted cohort's capacity grown past its
   twin's; (g) ``/metrics`` of that fleet before and after
   the failover (OS-assigned port): the six fleet families equal the
   coordinator's and replicator's stats; (d) a kill at each yield point
   (``prepare``, ``in_flight``, ``pre_commit``, ``pre_gc``, ``recover``)
   and mid-rebalance over 300 tenants, each followed by a rebuild from
   the journals and ``recover()``: every tenant on exactly one shard, the
   stream resubmitted from step 0 folding each step once, bit-equal to the
   twin; (e) partial waves of 1, 3, half and all but one of 5,000 tenants,
   and at capacities grown by migrations and shrunk by a restore, bit-equal
   to the full-shard dispatch; (h) one full wave through
   ``FleetShard.submit_wave`` running the kernels and copies of the cohort
   stepped bare (the two traced in turns, as in 4n (a)); (f) a binary ``AUROC`` tenant of 1M predictions moved as an
   eager tenant (its envelope through ``SingleProcessBackend.stream`` as a
   CUDA ``uint8`` tensor): one ``tie_scan`` launch in its ``compute()``,
   bit-equal to the unmoved tenant's, within 1e-6 of the plain scan and
   1e-5 of float64;
4p. the host-side analysis passes (``analysis/``), after 4o's first part and
   before phase 5: (a) ``explore_crash_consistency`` and ``explore_fencing``
   with every shard's cohort on the card (each rebuilt shard checked),
   without a finding and with coverage (crash: 6 states, 25 schedules, 14
   crash points; fencing: 2 states, 16 schedules, 16 points) equal to a CPU
   run's and to the committed ``PROTOCOL_BASELINE.json``, and no
   ``tie_scan`` launch (the template metric is MSE); (b) the fleet fixtures
   ``GcBeforeDurableCoordinator``, ``UnfencedCheckpointShard`` and
   ``NonAtomicManifestWriter`` tripping exactly MTA013, MTA014 and MTL107, at
   or above the baseline's ``min_violations``, with the CPU's first
   counterexample; (c) ``hint_for_watch_key`` naming each fixture's rule;
   (d) ``lint_paths()`` over the package this run imports, under this
   machine's Python: no unsuppressed finding;
4q. the program audit and the distributed-equivalence pass
   (``analysis/program.py``, ``analysis/distributed.py``), after 4p: (a)
   ``audit_registry`` over the 29 families with their ``@cohort``,
   ``@int8`` and ``@bf16`` variants, metrics and inputs on the card, then
   the 29 base families on the CPU in the same process (cut from all 89
   after a whole smoke took 422.5 s; ``tests/test_torch_cuda.py`` compares
   all 89): no unsuppressed finding, and every base family with the same
   eligibility, findings, suppressions, MTA005 replica counts and
   bit-identity verdicts, and fingerprints (a log1p family that needs the
   8-ulp allowance on the card only is printed); the MTA006
   purity probe's ``compute()`` of ``AUROC`` and ``AveragePrecision``
   launches ``tie_scan`` once each; pass 4 (host seam, double buffer): the
   card's 80 seam budgets equal ``SEAM_BASELINE.json``'s, every
   engine-eligible family proven double-buffer safe, the CPU twin's
   budgets and verdicts the card's; pass 5 (numerics) on every entry, the
   suppressed findings the int32 families' 96 MTA010 floor findings and
   R2Score's 4 MTA011 budget findings; (b) the 22 metric fixtures trip
   exactly their rules on the card, as on the CPU
   (``BlockScaledQuantizedSync`` none); (c) ``abstract_step``, ``abstract_cohort_step``,
   ``abstract_double_buffer_step`` and the cohort's
   ``abstract_double_buffer`` of ``MeanSquaredError``, ``Precision`` and
   ``BinnedAUROC`` on the card: 0 bytes allocated by each (at its end and
   at its peak, garbage collected before and no collection inside), no
   signature built, 0 kernels and 0 copies (an agreed trace of all twelve
   beside one marker kernel holds the marker alone), and no hazard in the
   two-generation graphs; (d) ``hint_for_watch_key`` names MTA001 for
   ``NarrowAccumulator``'s engine key; (e) one compiled step (the CUDA
   graph's build) and one replay of each of the three families:
   ``first_dispatch_hazards`` over the installed states, the graph's
   buffers and the returned value is empty after both; (f) pass 5 on the
   card: every horizon equal to ``NUMERICS_BASELINE.json``'s and the CPU
   twin's, each root family's card budget, CPU budget and ceilings (over
   the committed one only where the report suppressed its MTA011), the
   float64 check of each oracle leg and the probes skipped (none on the
   card that the CPU measured), the 10 equivariance verdicts, pass 5
   alone over the 29 roots timed on the card and the CPU, and the
   ``tie_scan`` records of one pass over ``AUROC`` and
   ``AveragePrecision`` in an agreed profile (5 each);
4r. MetricSan on the card (``analysis/sanitizer.py``), after 4q: (a) under
   ``san_scope(raise_on_violation=True)``, the JAX bench's regression leg
   as a ``compiled=True`` collection (5 forward batches of 100,000, one
   build, every later step one graph replay), a 64-tenant cohort (3 steps
   and ``compute()``), an eager binary ``AUROC`` over 1M predictions (one
   ``tie_scan`` launch) and a world-size-1 sync of an exact and of an
   ``int8`` state: no violation, and every value and state bit-equal to an
   unarmed twin's; (b) a replay's and a compiled step's kernels and copies
   armed against disarmed (``_paired_device_ops``), 0 host synchronizations in an
   armed replayed step, and the AUROC compute's ``tie_scan`` launches equal;
   (c) both forms of ``donation_unsafe_engine`` on a CUDA graph (the freed
   defaults, the graph's buffers handed out): one MTA007 and one flight
   dump each; (d) ThreadSan over an armed ``AsyncServingEngine`` serve loop
   whose worker steps on its own stream: 0 races, a nonzero
   ``san.thread.watched_attrs``; (e) the host ms of a compiled step and of an
   eager forward, disarmed and armed in turns (median of 5), beside the
   card's name and power limit;
5. times on the card (CUDA events over launches queued behind a device
   sleep, so host overhead does not show, or the host clock ending in a
   synchronize for whole steps): the one-stream kernel, its plain version
   and both co-sort forms at 1M; the one-stream kernel at the 20M stream of
   phase 2a; the batched kernel, its plain version, the
   same rows as 1,000 one-stream launches and both co-sort forms at
   ``(1000, 50000)``; a forward batch and both compute steps; the weighted
   kernels and their plain versions at 45,840,617 and at ``(1000, 50000)``,
   the offset form at 1M, and both sharded compute steps; the curve family
   (host clock ending in a synchronize, one warm-up, median of 5): the ROC
   and PR-curve compute at 1M and at (1000, 50000), the ``max_fpr`` AUROC
   and the weighted functional AUROC at 1M, and one binned update at
   1M x 512 and at 50,000 x 1,000 x 512; the stat-score family's forward
   batch, ImageNet compute, Cityscapes update and compute; the regression
   leg's forward batch (in the collection and unshared) and compute,
   functional ``r2score`` / ``mean_squared_error`` at 1M, ``psnr`` /
   ``ssim`` at 16 x 3 x 128 x 128, ``SSIM.compute()`` over Kodak, ``ssim``
   at 4 x 3 x 1024 x 2048, and both blur forms (banded product and
   depthwise convolution) at 128 x 128, 512 x 768 and 1024 x 2048; phase
   4h's forward batches, compiled and eager (host clock);
6. where the time goes: ``torch.profiler`` over a binary forward batch plus
   compute, over one multi-class compute, over one weighted sharded binary
   compute, over one per-class ROC compute at (1000, 50000), over one
   forward batch of phase 4e's forward leg and one Cityscapes update, over
   one forward batch of phase 4f's regression leg and one ``ssim`` at
   4 x 3 x 1024 x 2048, over one compiled forward batch of phase 4h's
   forward leg and regression leg (one graph replay each), over one MS MARCO
   compute of phase 4g (its sort share), and over one
   call of each kernel entry (one stream at 1M,
   batched at ``(1000, 50000)``, and the two weighted ones at their paths'
   shapes), each of which must show one kernel and at most the memset of
   its scratch.

Every count read off a ``torch.profiler`` trace (kernels and copies of a
step or a replay, the kernels inside a range, one kernel an entry) reads a
trace whose count of device records a second trace of the same call agrees
on (``_steady_profile``): CUPTI has dropped records from a trace on this
card, and once showed one record more than its twin.

Prints the card's name and power limit (``nvidia-smi``), ``{"timings": ...}``
lines (phase 4o's, ``fleet_*``, on a line of its own) and a
``{"profile": ...}`` line, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits with 1 and prints no result when no
CUDA device is available.
"""
import collections
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

SEED = 0
BATCHES = 10
BATCH = 100_000
MAIN_N = BATCHES * BATCH
TIE_HEAVY_N = 1_000_003
BIG_N = 20_000_000  # with 90% positives the positive class exceeds 2^24
EDGE_SIZES = (1, 7, 32767, 32768, 32769, BATCH)

# the class-batched scan: (rows, n) shapes, the last that of the multi-class
# main path, and a batch of more rows than a grid's y dimension (65535) holds
ROW_SHAPES = ((1, 1), (3, 4097), (7, 32769), (80, 40504), (1000, 50000))
CHUNKED_ROWS = (131_073, 3)
# the Criteo Display Advertising Challenge training set: 45,840,617 rows,
# held as one weighted evaluation stream, appended in batches of 2^22
CRITEO_N = 45_840_617
SHARDED_BATCH = 4_194_304
# ILSVRC2012 val: 50,000 images, 1,000 classes, 50 images per class
IMAGENET_N, IMAGENET_C = 50_000, 1_000
MC_BATCHES = 10
# launches of a weighted kernel that must repeat the first one's bits
REPEATS = 10
# MS-COCO 2014 val: 40,504 images, 80 labels
COCO_N, COCO_C = 40_504, 80

# H100 SXM data sheet: HBM bandwidth, and the float32 and float64 rates
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

# kernel vs plain version: exact counts; the two sum the same f32 terms in
# f64 in other orders (and nvcc may contract to FMA), so the normalized
# AUROC and AP agree to well below one f32 ulp of 1
SCORE_TOL = 1e-6
# against the float64 numpy oracles: f32 scores and f32 terms
ORACLE_TOL = 1e-5
# curve points against the float64 oracle: rates of exact counts, each cast to f32 once
CURVE_TOL = 1e-6
# the binned curves' histogram resolution
NUM_BINS = 512
# the stat-score family: float32 ratios of exact counts against float64
RATIO_TOL = 1e-6
# Cityscapes val (semantic segmentation): 500 images of 1024 x 2048 pixels,
# 19 evaluation classes, fed 4 images a batch; the classes' pixel shares
# are skewed as a street scene's (road about a third, then halving)
CITY_IMAGES, CITY_BATCH, CITY_H, CITY_W, CITY_C = 500, 4, 1024, 2048, 19
CITY_SHARES = np.concatenate([[1 / 3], (2 / 3) * 0.62 ** np.arange(18) / np.sum(0.62 ** np.arange(18))])
# the regression pack (phase 4f): BASELINE.json config 4's images
# (bench.py:1458), the whole Kodak PhotoCD set's shape (24 images of
# 3 x 512 x 768, fed 4 a batch), and 4 frames of Cityscapes' 1024 x 2048
IMG_SHAPE = (16, 3, 128, 128)
KODAK_IMAGES, KODAK_BATCH, KODAK_H, KODAK_W = 24, 4, 512, 768
FRAMES = 4
# regression values against float64: float32 moment sums over 1M rows
REG_TOL = 1e-5
# the shared pass against each metric's own: the same float32 sums, added in another order
SHARE_TOL = 1e-6
# SSIM against float64 over the same VALID windows (a TF32 blur reads ~6e-5 off)
SSIM_TOL = 1e-6
# composites against float64 / the epoch's counts
COMP_TOL = 1e-6
# the banded and the convolution blur of one stack: float32 sums of the same taps in other orders
BLUR_TOL = 1e-5
# the retrieval family (phase 4g): BASELINE.json config 5, the JAX bench's
# retrieval leg (bench.py:1455-1533): 1M rows, query ids uniform over
# 10,000, uniform scores, 5% relevant; and the MS MARCO passage ranking dev
# (small) set's shape: 6,980 queries x 1,000 BM25 candidates, 7,437 relevant
# rows, 6,980 distinct query ids from [0, 1,102,000), 100 queries a batch,
# seeded noise scores with the relevant rows shifted up
RET_N, RET_Q, RET_REL = 1_000_000, 10_000, 0.05
MSMARCO_Q, MSMARCO_DOCS, MSMARCO_REL, MSMARCO_ID_SPACE = 6_980, 1_000, 7_437, 1_102_000
MSMARCO_BATCH_Q, MSMARCO_SHIFT = 100, 2.5
# retrieval means against the float64 oracle: float32 scores of exact integer ranks
RET_TOL = 1e-5
# the step engine (phase 4h): compiled against eager, the same float32 ops in the same order
ENGINE_TOL = 1e-6
# embedding_similarity against float64 at (512, 256) with TF32 switched on globally,
# relative to the largest entry (float32 sums of 256 products: ~1e-6)
EMB_TOL = 1e-5
# the multi-tenant cohort (phase 4i): the JAX bench's cohort leg (bench.py:539-663)
COHORT_SIZES = (1, 64, 1024, 10_000)
COHORT_ROWS = 64
COHORT_SEQ = 64
COHORT_CHECK = 1024
COHORT_SAMPLED = 16
# the regression values' allowance against a collection run alone (tests/bases/test_cohort.py:143)
COHORT_ULPS = 8
# the observability core (phase 4j): the cohort's tenants, the shape-polymorphic loop's shapes
OBS_TENANTS = 1024
OBS_SHAPES = 12
# timed (off, on) pairs: the medians of the first 5 and the median paired difference of all
OBS_PAIRS = 25
# the names of the port's profiler ranges: on the device timeline a range is an
# annotation spanning the kernels launched inside it, not a kernel
RANGE_PREFIXES = ("metrics_tpu.", "engine[")
# every count read off a torch.profiler trace reads a trace that a second
# non-empty trace of the same call agrees with (_steady_profile), taking at
# most this many; PROFILE_TRACES_TAKEN tallies the reads by the traces each
# took
PROFILE_TRACES_MAX = 8
PROFILE_PAD_S = 0.02
PROFILE_TRACES_TAKEN = {}
PROFILE_LAST_RECORDS = []  # the device records of each trace of the last read
# the reliability layer (phase 4l): the north-star collection's envelope after
# 10 steps, the session's 20 steps with a checkpoint every 5 and a preemption
# at step 12, the guarded cohort's tenants
RELIABILITY_ENVELOPE_STEPS = 10
RELIABILITY_SESSION_STEPS = 20
RELIABILITY_CHECKPOINT_EVERY = 5
RELIABILITY_PREEMPT_AT = 12
RELIABILITY_TENANTS = 1024
# serving (phase 4m): the JAX bench's serving leg uncut (bench.py:954-1128):
# 1M 4-class rows, 12 steps; its ingest leg, 64 tenants x 256 rows x 8 waves
SERVING_N = 1_000_000
SERVING_STEPS = 12
SERVING_TENANTS = 64
SERVING_ROWS_PER_STEP = 256
SERVING_WAVES = 8
# device cycles of the probe that converts the model's ms into a device sleep
SERVING_SLEEP_PROBE_CYCLES = 10_000_000
# serve-loop reads to the host while the worker holds a batch
SERVING_READ_STEPS = 40
# the export surface (phase 4n): /metrics and /healthz scrapes beside the
# serve loop of 4m's 64-tenant cohort, serve-loop steps with and without a
# concurrent scrape (in turns), a worker's step held behind a device sleep
EXPORTER_SCRAPES = 50
EXPORTER_STEP_PAIRS = 20
EXPORTER_HOLD_MS = 80.0
EXPORTER_TIMEOUT_S = 30.0
# phase 4o: the fleet legs of the JAX bench (bench.py:676-727, 756-915) and
# the chaos bed's size (tests/reliability/test_fleet_chaos.py:37)
FLEET_TENANTS = 10_000
# the failover leg and the kills, (c), (g) and (d), at a smaller depth: at
# 10,000 tenants its two replicate cycles took 131-155 s each on the card's
# host (the replica manifest rewritten whole a tenant, O(n^2) in a shard's
# tenants). The kill schedule at 10,000 stays on the CPU
# (tests/test_torch_fleet_chaos.py::test_kill_at_every_phase_and_mid_rebalance_10k).
# 1,000 took 23.6-47.5 s on the card's host, and 500 10.7-36.3 s of whole
# smokes of 328-399 s after the card check against an aim of 360: 300 (a
# third of 500's manifest rewrites) grows both surviving cohorts' capacity
# past their twins' (the dead shard's 96 tenants promoted onto 93 and 111)
FLEET_FAILOVER_TENANTS = 300
FLEET_MOVES = 24
FLEET_ROWS = 2
FLEET_FEATURES = 8
FLEET_REDELIVERY_WINDOW = 8
FLEET_PARTIAL_N = 5_000


def _pin_one_card() -> str:
    """Make the run see one card, the first visible one; returns its
    ``nvidia-smi`` index (or UUID). Must run before CUDA initializes."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    first = "0" if visible is None else visible.split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    return first


def _card_line(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _oracle_auroc(scores: np.ndarray, rel: np.ndarray) -> float:
    """Tie-corrected Mann-Whitney AUROC in float64."""
    s = scores.astype(np.float64)
    neg = np.sort(s[~rel])
    pos = s[rel]
    lo = np.searchsorted(neg, pos, side="left")
    hi = np.searchsorted(neg, pos, side="right")
    return (float(lo.sum()) + 0.5 * float((hi - lo).sum())) / (float(pos.size) * float(neg.size))


def _oracle_ap(scores: np.ndarray, rel: np.ndarray) -> float:
    """Tie-corrected average precision in float64 (one point per distinct score)."""
    s = scores.astype(np.float64)
    order = np.argsort(-s, kind="stable")
    s, r = s[order], rel[order]
    last = np.r_[s[1:] != s[:-1], True]
    tp = np.cumsum(r)[last].astype(np.float64)
    fp = np.cumsum(~r)[last].astype(np.float64)
    prev = np.r_[0.0, tp[:-1]]
    return float(np.sum((tp - prev) * (tp / (tp + fp))) / tp[-1])


def _oracle_weighted(scores: np.ndarray, rel: np.ndarray, weights: np.ndarray):
    """Tie-corrected weighted (AUROC, AP) in float64: one point per
    distinct score, as sklearn's ``sample_weight``."""
    s = scores.astype(np.float64)
    order = np.argsort(-s)
    s, r, w = s[order], rel[order], weights[order].astype(np.float64)
    last = np.r_[s[1:] != s[:-1], True]
    tp = np.cumsum(np.where(r, w, 0.0))[last]
    fp = np.cumsum(np.where(r, 0.0, w))[last]
    tp_prev, fp_prev = np.r_[0.0, tp[:-1]], np.r_[0.0, fp[:-1]]
    auroc = float(np.sum(0.5 * (tp + tp_prev) * (fp - fp_prev)) / (tp[-1] * fp[-1]))
    ap = float(np.sum((tp - tp_prev) * tp / np.maximum(tp + fp, 1e-300)) / tp[-1])
    return auroc, ap


def _oracle_points(scores: np.ndarray, rel: np.ndarray, weights=None):
    """One curve point per distinct score, descending: ``(fps, tps,
    thresholds)`` after a stable descending argsort, int64 counts (float64
    weight sums)."""
    order = np.argsort(-scores, kind="stable")
    s, r = scores[order], rel[order]
    last = np.r_[s[1:] != s[:-1], True]
    if weights is None:
        tps = np.cumsum(r, dtype=np.int64)
        fps = np.arange(1, s.size + 1, dtype=np.int64) - tps
    else:
        w = weights[order].astype(np.float64)
        tps, fps = np.cumsum(np.where(r, w, 0.0)), np.cumsum(np.where(r, 0.0, w))
    return fps[last], tps[last], s[last]


def _oracle_roc(scores: np.ndarray, rel: np.ndarray):
    """(fpr, tpr, thresholds) in float64 (thresholds in the scores' dtype),
    opened by the (0, 0) point at the top score plus one."""
    fps, tps, thr = _oracle_points(scores, rel)
    fpr = np.r_[0.0, fps / fps[-1]]
    tpr = np.r_[0.0, tps / tps[-1]]
    return fpr, tpr, np.r_[thr[:1] + thr.dtype.type(1), thr]


def _oracle_pr(scores: np.ndarray, rel: np.ndarray):
    """(precision, recall, thresholds): the points up to full recall in
    ascending threshold order, closed by (1, 0)."""
    fps, tps, thr = _oracle_points(scores, rel)
    stop = int(np.argmax(tps == tps[-1])) + 1
    precision = tps[:stop] / (tps[:stop] + fps[:stop])
    recall = tps[:stop] / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[:stop][::-1]


def _trapezoid(y: np.ndarray, x: np.ndarray, axis: int = -1) -> np.ndarray:
    dx = np.diff(x, axis=axis)
    return np.sum(dx * (np.take(y, range(1, y.shape[axis]), axis) + np.take(y, range(y.shape[axis] - 1), axis)) / 2,
                  axis=axis)


def _oracle_partial_auroc(fpr: np.ndarray, tpr: np.ndarray, max_fpr: float) -> float:
    """McClish-standardized partial AUROC over [0, max_fpr] in float64."""
    stop = int(np.searchsorted(fpr, max_fpr, side="right"))
    weight = (max_fpr - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    interp = tpr[stop - 1] + weight * (tpr[stop] - tpr[stop - 1])
    area = float(_trapezoid(np.r_[tpr[:stop], interp], np.r_[fpr[:stop], max_fpr]))
    min_area = 0.5 * max_fpr**2
    return 0.5 * (1 + (area - min_area) / (max_fpr - min_area))


def _oracle_histograms(scores: np.ndarray, rel: np.ndarray, num_bins: int, weights=None):
    """``(hist_pos, hist_neg)`` of ``(N,)`` or ``(N, C)`` f32 scores: numpy
    counts (float64 weight sums) of ``int(score * num_bins)`` clipped to the
    bins, one row per column."""
    columns = 1 if scores.ndim == 1 else scores.shape[1]
    bins = np.clip((scores * np.float32(num_bins)).astype(np.int64), 0, num_bins - 1)
    if scores.ndim == 2:
        bins = bins + num_bins * np.arange(columns)
    w = np.ones(scores.shape) if weights is None else np.broadcast_to(
        weights.astype(np.float64).reshape(-1, *([1] * (scores.ndim - 1))), scores.shape)
    pos = np.bincount(bins[rel], weights=w[rel], minlength=columns * num_bins).reshape(columns, num_bins)
    neg = np.bincount(bins[~rel], weights=w[~rel], minlength=columns * num_bins).reshape(columns, num_bins)
    return (pos[0], neg[0]) if scores.ndim == 1 else (pos, neg)


def _float64_binned(hist_pos: np.ndarray, hist_neg: np.ndarray):
    """(AUROC, AP, precision, recall) of histograms along the last axis,
    evaluated in float64, each class total divided out on its own."""
    zero = np.zeros((*hist_pos.shape[:-1], 1))
    tps = np.concatenate([zero, np.cumsum(hist_pos[..., ::-1].astype(np.float64), -1)], -1)
    fps = np.concatenate([zero, np.cumsum(hist_neg[..., ::-1].astype(np.float64), -1)], -1)
    tpr = tps / np.where(tps[..., -1:] > 0, tps[..., -1:], 1.0)
    fpr = fps / np.where(fps[..., -1:] > 0, fps[..., -1:], 1.0)
    auroc = np.where((tps[..., -1] == 0) | (fps[..., -1] == 0), np.nan, _trapezoid(tpr, fpr))
    predicted = tps + fps
    precision = np.where(predicted > 0, tps / np.where(predicted > 0, predicted, 1.0), 1.0)
    ap = np.where(tps[..., -1] == 0, np.nan, np.sum(np.diff(tpr, axis=-1) * precision[..., 1:], -1))
    return auroc, ap, precision, tpr


def _queued_ms(torch, fn, launches: int = 50, trials: int = 7) -> float:
    """Device time of one call: ``launches`` calls queued behind a device
    sleep (so they run back to back), timed with CUDA events; median of
    ``trials``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def _host_ms(torch, fn, trials: int = 5) -> float:
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _bound(n_elements: int, groups: int, outputs: int, weighted: bool = False):
    """(bound ms, what bounds it) of one scan: 8 bytes read per element (12
    weighted) and 16 bytes written per output; 5 operations per element
    (compare, decode, prefix) and 10 per group start (the terms: f32, or
    f64 weighted)."""
    bytes_ms = ((12 if weighted else 8) * n_elements + 16 * outputs) / HBM_BYTES_PER_S * 1e3
    ops_ms = (5 * n_elements + 10 * groups) / (F64_OPS_PER_S if weighted else F32_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _saved(collection) -> dict:
    """The collection's states as they are now: list states are copied, so
    later updates, which append to the live lists, do not reach them."""
    return {k: list(v) if isinstance(v, list) else v for k, v in collection.state_dict().items()}


def _device_ms_by_kernel(torch, prof, key: str) -> dict:
    return {
        e.key: getattr(e, key) / 1e3
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and getattr(e, key) > 0
    }


def _oracle_counts(confmat: np.ndarray):
    """int64 (tp, fp, tn, fn) per class of a confusion matrix (rows: target)."""
    tp = np.diag(confmat)
    fp, fn = confmat.sum(0) - tp, confmat.sum(1) - tp
    return tp, fp, confmat.sum() - tp - fp - fn, fn


def _safe_ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)


def _oracle_prf(tp, fp, fn, average: str = "macro"):
    """float64 (precision, recall, F1) averaged as the port averages them:
    0 where a denominator is 0; ``weighted`` by the support."""
    precision, recall = _safe_ratio(tp, tp + fp), _safe_ratio(tp, tp + fn)
    f1 = _safe_ratio(2 * precision * recall, precision + recall)
    if average == "weighted":
        w = (tp + fn) / np.sum(tp + fn)
        return tuple(float(np.sum(w * v)) for v in (precision, recall, f1))
    return tuple(float(np.mean(v)) for v in (precision, recall, f1))


def _oracle_mcc(confmat: np.ndarray) -> float:
    c = confmat.astype(np.float64)
    tk, pk, s = c.sum(0), c.sum(1), c.sum()
    return float((np.trace(c) * s - tk @ pk) / (np.sqrt(s**2 - pk @ pk) * np.sqrt(s**2 - tk @ tk)))


def _forward_leg_inputs(torch, dev):
    """The JAX bench's forward-leg batches (``bench.py:459-462``): 1M seeded
    4-class probabilities and labels, as numpy and on ``dev``."""
    rs = np.random.RandomState(SEED)
    p4_np = rs.rand(MAIN_N, 4).astype(np.float32)
    p4_np = p4_np / p4_np.sum(1, keepdims=True)
    t4_np = rs.randint(4, size=MAIN_N)
    return p4_np, t4_np, torch.from_numpy(p4_np).to(dev), torch.from_numpy(t4_np).to(dev)


def _regression_leg_inputs(torch, dev):
    """The JAX bench's regression-leg rows (``bench.py:463-464``; its
    generator draws the classification leg's batches first): 1M seeded
    ``(preds, target)``, as numpy and on ``dev``."""
    rs = np.random.RandomState(SEED)
    rs.rand(MAIN_N, 4)
    rs.randint(4, size=MAIN_N)
    t_np = (rs.randn(MAIN_N) * 3 + 1).astype(np.float32)
    p_np = t_np + rs.randn(MAIN_N).astype(np.float32)
    return p_np, t_np, torch.from_numpy(p_np).to(dev), torch.from_numpy(t_np).to(dev)


def _syncs(torch, fn):
    """The host synchronizations ``fn()`` causes, by site
    (``torch.cuda.set_sync_debug_mode("warn")``)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def _stat_score_phase(torch, dev, mc, ml):
    """Phase 4e: the stat-score and confusion-matrix family on the card.

    ``mc`` is phase 4's ImageNet-shaped ``(preds, target, scores_np,
    target_np)``, ``ml`` phase 4's MS-COCO-shaped ``(scores_np, target_np)``.
    Returns the phase's timings and what phase 6 profiles."""
    from metrics_tpu_torch import (
        F1,
        Accuracy,
        CohenKappa,
        ConfusionMatrix,
        HammingDistance,
        Hinge,
        IoU,
        MatthewsCorrcoef,
        MetricCollection,
        Precision,
        Recall,
        StatScores,
    )
    from metrics_tpu_torch.functional import dice_score
    from metrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_compute
    from metrics_tpu_torch.ops.histogram import label_bincount

    out = {}

    def check(label, got, want, tol):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = float(np.max(np.abs(got - want))) if got.size else 0.0
        if got.shape != want.shape or not np.all(np.isfinite(got)) or not err <= tol:
            raise AssertionError(f"{label}: {got.ravel()[:4]} vs oracle {want.ravel()[:4]} (max |d| {err})")
        return err

    def check_counts(label, metric, want):
        got = [getattr(metric, k).cpu().numpy() for k in ("tp", "fp", "tn", "fn")]
        for name, g, w in zip(("tp", "fp", "tn", "fn"), got, want):
            if g.dtype != np.int32 or not np.array_equal(g, w):
                raise AssertionError(f"{label}: {name} counts differ from numpy's")

    def computed_ms(coll, trials=5):
        """Host ms of compute() ending in a synchronize, cached values
        dropped; median of ``trials`` after one more call."""
        times = []
        for _ in range(trials + 1):
            for metric in coll.values():
                metric._computed = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            coll.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times[1:]))

    # a. the JAX bench's forward leg: Accuracy + macro Precision/Recall/F1 on 4 classes
    p4_np, t4_np, p4, t4 = _forward_leg_inputs(torch, dev)
    forward_leg = MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                                    Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")])
    for b in range(BATCHES):
        forward_leg(p4[b * BATCH:(b + 1) * BATCH], t4[b * BATCH:(b + 1) * BATCH])
    leg = {k: v.item() for k, v in forward_leg.compute().items()}
    am4 = p4_np.argmax(1)
    counts4 = _oracle_counts(np.bincount(t4_np * 4 + am4, minlength=16).reshape(4, 4))
    for name in ("Precision", "Recall", "F1"):
        check_counts(f"forward leg {name}", forward_leg[name], counts4)
    want_leg = dict(zip(("Precision", "Recall", "F1"), _oracle_prf(counts4[0], counts4[1], counts4[3])))
    want_leg["Accuracy"] = float(np.sum(am4 == t4_np)) / MAIN_N
    leg_err = max(check(f"forward leg {k}", leg[k], v, RATIO_TOL) for k, v in want_leg.items())
    out["forward_leg_batch_ms"] = _host_ms(torch, lambda: forward_leg(p4[:BATCH], t4[:BATCH]))
    print(f"4e. forward leg (Accuracy + macro Precision/Recall/F1, 4 classes), {BATCHES} batches of {BATCH}:"
          f" {leg}, counts exact, max |d| {leg_err:.3g}; forward batch {out['forward_leg_batch_ms']:.3f} ms")

    # b. ImageNet-1k val, 50,000 x 1,000
    mc_preds, mc_target, scores_np, target_np = mc
    n, c = scores_np.shape
    mc_batch = n // MC_BATCHES
    imagenet = MetricCollection({
        "StatScores": StatScores(reduce="macro", num_classes=c),
        **{f"{cls.__name__}_{avg}": cls(num_classes=c, average=avg)
           for avg in ("macro", "weighted") for cls in (Precision, Recall, F1)},
        "Precision_top5": Precision(num_classes=c, top_k=5),
        "ConfusionMatrix": ConfusionMatrix(c, normalize="true"),
        "CohenKappa": CohenKappa(c, weights="quadratic"),
        "MatthewsCorrcoef": MatthewsCorrcoef(c),
        "IoU": IoU(c),
        "HammingDistance": HammingDistance(),
        "Hinge": Hinge(),
    })
    for b in range(MC_BATCHES):
        imagenet.update(mc_preds[b * mc_batch:(b + 1) * mc_batch], mc_target[b * mc_batch:(b + 1) * mc_batch])
    got = imagenet.compute()
    dice = dice_score(mc_preds, mc_target).item()
    am = scores_np.argmax(1)
    confmat = np.bincount(target_np * c + am, minlength=c * c).reshape(c, c)
    tp, fp, tn, fn = _oracle_counts(confmat)
    if not np.array_equal(got["StatScores"].cpu().numpy(), np.stack([tp, fp, tn, fn, tp + fn], 1)):
        raise AssertionError("ImageNet StatScores differ from numpy's counts")
    for avg in ("macro", "weighted"):
        want = _oracle_prf(tp, fp, fn, avg)
        for cls, w in zip(("Precision", "Recall", "F1"), want):
            check(f"ImageNet {cls} {avg}", got[f"{cls}_{avg}"].item(), w, RATIO_TOL)
    row = scores_np[np.arange(n), target_np]
    ahead = (scores_np > row[:, None]).sum(1) + ((scores_np == row[:, None]) & (np.arange(c) < target_np[:, None])).sum(1)
    check("ImageNet Precision top_k=5", got["Precision_top5"].item(), np.sum(ahead < 5) / (5 * n), RATIO_TOL)
    check("ImageNet ConfusionMatrix normalize='true'", got["ConfusionMatrix"].cpu().numpy(),
          confmat / confmat.sum(1, keepdims=True), RATIO_TOL)
    cmf = confmat.astype(np.float64)
    weights = (np.arange(c)[:, None] - np.arange(c)[None, :]) ** 2.0
    expected = np.outer(cmf.sum(1), cmf.sum(0)) / cmf.sum()
    check("ImageNet CohenKappa quadratic", got["CohenKappa"].item(),
          1 - np.sum(weights * cmf) / np.sum(weights * expected), ORACLE_TOL)
    mcc_gap_imagenet = abs(got["MatthewsCorrcoef"].item() - _oracle_mcc(confmat))
    if not np.isfinite(got["MatthewsCorrcoef"].item()):
        raise AssertionError("ImageNet MatthewsCorrcoef is not finite")
    check("ImageNet IoU", got["IoU"].item(), np.mean(_safe_ratio(tp, tp + fp + fn)), RATIO_TOL)
    check("ImageNet HammingDistance", got["HammingDistance"].item(), 2 * np.sum(am != target_np) / (n * c),
          RATIO_TOL)
    others = np.where(np.arange(c) == target_np[:, None], -np.inf, scores_np).max(1)
    check("ImageNet Hinge", got["Hinge"].item(), np.mean(np.maximum(0.0, 1.0 - (row - others))), ORACLE_TOL)
    check("ImageNet dice_score", dice, np.mean(np.where((tp + fn)[1:] > 0, _safe_ratio(2 * tp, 2 * tp + fp + fn)[1:],
                                                          0.0)), RATIO_TOL)
    out["imagenet_compute_ms"] = computed_ms(imagenet)
    print(f"4e. ImageNet {n}x{c}: StatScores counts exact; Precision/Recall/F1 macro and weighted, top-5 Precision,"
          f" normalized ConfusionMatrix, quadratic CohenKappa, IoU, HammingDistance, Hinge and dice_score equal the"
          f" float64 oracles; MatthewsCorrcoef {got['MatthewsCorrcoef'].item():.7f}, gap to float64"
          f" {mcc_gap_imagenet:.3g}; compute {out['imagenet_compute_ms']:.3f} ms")
    del imagenet, got

    # c. MS-COCO 2014 val multi-label, 40,504 x 80
    ml_scores_np, ml_target_np = ml
    ml_preds, ml_target = torch.from_numpy(ml_scores_np).to(dev), torch.from_numpy(ml_target_np.astype(np.int64)).to(dev)
    lc = ml_scores_np.shape[1]
    coco = MetricCollection({
        "StatScores_micro": StatScores(reduce="micro"),
        "StatScores_macro": StatScores(reduce="macro", num_classes=lc),
        "F1": F1(num_classes=lc, average="macro"),
        "HammingDistance": HammingDistance(),
        "ConfusionMatrix": ConfusionMatrix(lc, multilabel=True),
    })
    for rows in np.array_split(np.arange(ml_scores_np.shape[0]), 4):
        coco.update(ml_preds[rows[0]:rows[-1] + 1], ml_target[rows[0]:rows[-1] + 1])
    got = coco.compute()
    pb, tb = ml_scores_np >= 0.5, ml_target_np.astype(bool)
    ml_tp, ml_fp, ml_fn = (pb & tb).sum(0), (pb & ~tb).sum(0), (~pb & tb).sum(0)
    ml_tn = pb.shape[0] - ml_tp - ml_fp - ml_fn
    per_label = np.stack([ml_tp, ml_fp, ml_tn, ml_fn, ml_tp + ml_fn], 1)
    if not (np.array_equal(got["StatScores_macro"].cpu().numpy(), per_label)
            and np.array_equal(got["StatScores_micro"].cpu().numpy(), per_label.sum(0))):
        raise AssertionError("MS-COCO StatScores differ from numpy's counts")
    cells = np.stack([np.stack([ml_tn, ml_fp], 1), np.stack([ml_fn, ml_tp], 1)], 1)
    if not np.array_equal(got["ConfusionMatrix"].cpu().numpy(), cells.astype(np.float32)):
        raise AssertionError("MS-COCO multi-label ConfusionMatrix differs from numpy's (80, 2, 2) counts")
    check("MS-COCO F1 macro", got["F1"].item(), _oracle_prf(ml_tp, ml_fp, ml_fn)[2], RATIO_TOL)
    check("MS-COCO HammingDistance", got["HammingDistance"].item(), np.mean(pb != tb), RATIO_TOL)
    print(f"4e. MS-COCO {ml_scores_np.shape[0]}x{lc} multi-label: StatScores micro/macro and the (80, 2, 2)"
          f" ConfusionMatrix exact, F1 macro {got['F1'].item():.7f} and HammingDistance"
          f" {got['HammingDistance'].item():.7f} equal the oracles")
    del coco, ml_preds, ml_target

    # d. Cityscapes val, 500 x 1024 x 2048, 19 classes, 4 images a batch, made on the card
    def city_collection():
        return MetricCollection({
            "ConfusionMatrix": ConfusionMatrix(CITY_C),
            "IoU": IoU(CITY_C),
            "StatScores": StatScores(reduce="macro", num_classes=CITY_C, mdmc_reduce="global"),
            "F1": F1(num_classes=CITY_C, average="macro", mdmc_average="samplewise"),
        })

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cdf = torch.from_numpy(np.cumsum(CITY_SHARES)).to(dev, torch.float32)
    shape = (CITY_BATCH, CITY_H, CITY_W)

    def city_batch():
        target = torch.searchsorted(cdf, torch.rand(shape, generator=gen, device=dev)).clamp_(max=CITY_C - 1)
        logits = torch.randn((CITY_BATCH, CITY_C, CITY_H, CITY_W), generator=gen, device=dev)
        logits.scatter_add_(1, target[:, None], torch.full((CITY_BATCH, 1, CITY_H, CITY_W), 3.0, device=dev))
        return torch.softmax(logits, dim=1), target

    city = city_collection()
    per_image = np.zeros((CITY_IMAGES, CITY_C * CITY_C), np.int64)
    update_ms = []
    for b in range(CITY_IMAGES // CITY_BATCH):
        preds, target = city_batch()
        torch.cuda.synchronize()
        t = time.perf_counter()
        city.update(preds, target)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t) * 1e3)
        # the oracle: numpy counts of target * 19 + argmax from uint8 maps on the host
        argmax = torch.argmax(preds, dim=1).to(torch.uint8).cpu().numpy()
        index = target.to(torch.uint8).cpu().numpy().astype(np.int16) * np.int16(CITY_C) + argmax
        for i in range(CITY_BATCH):
            per_image[b * CITY_BATCH + i] = np.bincount(index[i].ravel(), minlength=CITY_C * CITY_C)
    t = time.perf_counter()
    got = city.compute()
    torch.cuda.synchronize()
    first_compute_ms = (time.perf_counter() - t) * 1e3
    confmat = per_image.sum(0).reshape(CITY_C, CITY_C)
    if not np.array_equal(city["ConfusionMatrix"].confmat.cpu().numpy(), confmat):
        raise AssertionError("Cityscapes ConfusionMatrix state differs from numpy's int64 counts")
    if not np.array_equal(got["ConfusionMatrix"].cpu().numpy(), confmat.astype(np.float32)):
        raise AssertionError("Cityscapes float32 ConfusionMatrix differs from the float32 rounding of numpy's counts")
    tp, fp, tn, fn = _oracle_counts(confmat)
    if not np.array_equal(got["StatScores"].cpu().numpy(), np.stack([tp, fp, tn, fn, tp + fn], 1)):
        raise AssertionError("Cityscapes macro StatScores differ from numpy's int64 counts")
    if not np.max(tn) > 2**24:
        raise AssertionError("Cityscapes: no per-class count passed 2^24")
    check("Cityscapes IoU", got["IoU"].item(), np.mean(_safe_ratio(tp, tp + fp + fn)), RATIO_TOL)
    img = per_image.reshape(CITY_IMAGES, CITY_C, CITY_C)
    img_tp = np.diagonal(img, axis1=1, axis2=2)
    img_prf = [_oracle_prf(img_tp[i], img[i].sum(0) - img_tp[i], img[i].sum(1) - img_tp[i]) for i in range(CITY_IMAGES)]
    check("Cityscapes F1 macro samplewise", got["F1"].item(), np.mean([x[2] for x in img_prf]), RATIO_TOL)
    city_mcc = _matthews_corrcoef_compute(city["ConfusionMatrix"].confmat).item()
    mcc_gap_city = abs(city_mcc - _oracle_mcc(confmat))
    out["cityscapes_update_ms"] = float(np.median(update_ms))
    out["cityscapes_compute_ms"] = computed_ms(city)
    out["cityscapes_first_compute_ms"] = first_compute_ms

    # host synchronizations of one update, per metric, at C = 19 and C = 1,000
    sync_sites = {}

    def update_syncs(classes, p, t):
        found = {}
        for name, make in (
            ("StatScores", lambda: StatScores(reduce="macro", num_classes=classes, mdmc_reduce="global")),
            ("F1", lambda: F1(num_classes=classes, average="macro", mdmc_average="global")),
            ("ConfusionMatrix", lambda: ConfusionMatrix(classes)),
            ("IoU", lambda: IoU(classes)),
        ):
            make().update(p, t)
            metric = make()
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    metric.update(p, t)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
            found[name] = len(sites)
            sync_sites[f"{name}@{classes}"] = sites
        return found

    shapes = {CITY_C: (preds, target), c: (mc_preds[:mc_batch], mc_target[:mc_batch])}
    update_syncs(CITY_C, *shapes[CITY_C])  # the first counted window may see one more, from PyTorch itself
    syncs = {k: update_syncs(k, *v) for k, v in shapes.items()}
    if syncs[CITY_C] != syncs[c] or not all(syncs[c].values()):
        raise AssertionError(f"host synchronizations per update grow with the classes: {syncs} at {sync_sites}")

    def bincount_by_size(indices, length, weights=None):
        """``label_bincount`` as it was: ``torch.bincount``, which sizes its
        output from the data's min and max (0/1 weights send a label to the
        spare bucket)."""
        idx = indices.reshape(-1).to(torch.int64).clamp_min(0)
        idx = torch.where(idx < length, idx, length)
        if weights is not None:
            idx = torch.where(weights.reshape(-1).to(torch.bool), idx, length)
        return torch.bincount(idx, minlength=length + 1)[:length]

    # the modules themselves: the package names their public functions alike
    stat_scores_module = importlib.import_module("metrics_tpu_torch.functional.classification.stat_scores")
    confmat_module = importlib.import_module("metrics_tpu_torch.functional.classification.confusion_matrix")
    stat_scores_module.label_bincount = confmat_module.label_bincount = bincount_by_size
    try:
        syncs_by_size = {k: update_syncs(k, *v) for k, v in shapes.items()}
    finally:
        stat_scores_module.label_bincount = confmat_module.label_bincount = label_bincount
    cells = target.reshape(-1) * CITY_C + torch.argmax(preds, dim=1).reshape(-1)
    if not torch.equal(label_bincount(cells, CITY_C**2), torch.bincount(cells, minlength=CITY_C**2)):
        raise AssertionError("label_bincount differs from torch.bincount on the Cityscapes cells")
    out["label_bincount_cells_ms"] = _host_ms(torch, lambda: label_bincount(cells, CITY_C**2))
    out["torch_bincount_cells_ms"] = _host_ms(torch, lambda: torch.bincount(cells, minlength=CITY_C**2))
    out.update(syncs_per_update=syncs, syncs_per_update_with_torch_bincount=syncs_by_size,
               sync_sites=sync_sites, mcc_gap_imagenet=mcc_gap_imagenet, mcc_gap_cityscapes=mcc_gap_city,
               cityscapes_mcc=city_mcc, cityscapes_max_tn=int(np.max(tn)))
    print(f"4e. Cityscapes {CITY_IMAGES}x{CITY_H}x{CITY_W}, {CITY_C} classes, {CITY_IMAGES // CITY_BATCH} batches of"
          f" {CITY_BATCH}: ConfusionMatrix and macro StatScores equal numpy's int64 counts (largest tn"
          f" {int(np.max(tn))}, above 2^24), the float32 matrix its float32 rounding; IoU {got['IoU'].item():.7f},"
          f" F1 samplewise {got['F1'].item():.7f} equal float64; MCC {city_mcc:.7f}, gap to float64 {mcc_gap_city:.3g};"
          f" update {out['cityscapes_update_ms']:.3f} ms (median), compute {out['cityscapes_compute_ms']:.3f} ms;"
          f" syncs per update {syncs} (with torch.bincount {syncs_by_size}); label_bincount"
          f" {out['label_bincount_cells_ms']:.3f} ms vs torch.bincount {out['torch_bincount_cells_ms']:.3f} ms on"
          f" {cells.numel()} cells")
    return out, (forward_leg, (p4[:BATCH], t4[:BATCH])), city_collection, (preds, target)


def _gauss64(k: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange((1 - k) / 2, (1 + k) / 2, 1.0) / sigma) ** 2) / 2)
    return g / g.sum()


def _oracle_ssim(preds: np.ndarray, target: np.ndarray, data_range: float, k: int = 11, sigma: float = 1.5,
                 k1: float = 0.01, k2: float = 0.03):
    """float64 (sum, count) of the SSIM index over the VALID k x k Gaussian
    windows of ``(B, C, H, W)`` images, image by image (the windows of
    ``tests/regression/test_ssim.py``'s oracle, without its padded ring)."""
    from scipy.ndimage import correlate1d

    g, pad = _gauss64(k, sigma), k // 2
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2

    def blur(x):
        x = correlate1d(x, g, axis=-2, mode="constant")[..., pad:-pad, :]
        return correlate1d(x, g, axis=-1, mode="constant")[..., pad:-pad]

    total, count = 0.0, 0
    for p, t in zip(preds, target):
        p, t = p.astype(np.float64), t.astype(np.float64)
        mu_p, mu_t, e_pp, e_tt, e_pt = (blur(x) for x in (p, t, p * p, t * t, p * t))
        index = ((2 * mu_p * mu_t + c1) * (2 * (e_pt - mu_p * mu_t) + c2)) / (
            (mu_p**2 + mu_t**2 + c1) * (e_pp - mu_p**2 + e_tt - mu_t**2 + c2))
        total, count = total + float(index.sum()), count + index.size
    return total, count


def _regression_phase(torch, dev, leg):
    """Phase 4f: the regression pack and metric arithmetic on the card.

    ``leg`` is phase 4e's forward-leg inputs ``(p4_np, t4_np, p4, t4)``.
    Returns the phase's timings and what phase 6 profiles."""
    import contextlib

    from metrics_tpu_torch import (
        PSNR,
        SSIM,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        MetricCollection,
        Precision,
        R2Score,
        Recall,
    )
    from metrics_tpu_torch.functional import (
        mean_relative_error,
        mean_squared_error,
        mean_squared_log_error,
        psnr,
        r2score,
        ssim,
    )

    # the modules themselves: the package names its public functions alike
    sufficient_stats = importlib.import_module("metrics_tpu_torch.functional.regression.sufficient_stats")
    ssim_module = importlib.import_module("metrics_tpu_torch.functional.regression.ssim")
    out = {}

    def check(label, got, want, tol, relative=True):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        scale = np.maximum(np.abs(want), 1e-30) if relative else 1.0
        err = float(np.max(np.abs(got - want) / scale)) if got.size else 0.0
        if got.shape != want.shape or not np.all(np.isfinite(got)) or not err <= tol:
            raise AssertionError(f"{label}: {got.ravel()[:4]} vs oracle {want.ravel()[:4]} (max error {err})")
        return err

    def warm_ms(fn):
        fn()
        return _host_ms(torch, fn)

    def computed_ms(metrics, trials=5):
        """Host ms of compute() ending in a synchronize, cached values
        dropped; median of ``trials`` after one more call."""
        times = []
        for _ in range(trials + 1):
            for metric in metrics:
                metric._computed = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            for metric in metrics:
                metric.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times[1:]))

    # a. the JAX bench's regression forward leg (bench.py:463-464, :535)
    reg_p_np, reg_t_np, reg_p, reg_t = _regression_leg_inputs(torch, dev)

    def reg_collection():
        return MetricCollection([MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()])

    reg = reg_collection()
    alone = {name: type(m)() for name, m in reg.items()}  # the unshared path: each metric reads the batch
    stats_calls = []
    compute_stats = sufficient_stats._compute_stats
    sufficient_stats._compute_stats = lambda p, t: stats_calls.append(1) or compute_stats(p, t)
    share_err = 0.0
    try:
        for b in range(BATCHES):
            rows = slice(b * BATCH, (b + 1) * BATCH)
            step = reg(reg_p[rows], reg_t[rows])
            for name, metric in alone.items():
                share_err = max(share_err, check(f"shared step {name}", step[name].item(),
                                                 metric(reg_p[rows], reg_t[rows]).item(), SHARE_TOL))
    finally:
        sufficient_stats._compute_stats = compute_stats
    if len(stats_calls) != BATCHES:
        raise AssertionError(f"the collection computed the shared moments {len(stats_calls)} times in {BATCHES} batches")
    got = {k: v.item() for k, v in reg.compute().items()}
    for name, metric in alone.items():
        share_err = max(share_err, check(f"shared compute {name}", got[name], metric.compute().item(), SHARE_TOL))
    p64, t64 = reg_p_np.astype(np.float64), reg_t_np.astype(np.float64)
    d = t64 - p64
    mse = np.mean(d * d)
    data_range = max(t64.max(), 0.0) - min(t64.min(), 0.0)  # PSNR's running range starts at 0.0
    want = {
        "MeanSquaredError": mse,
        "MeanAbsoluteError": np.mean(np.abs(d)),
        "R2Score": 1 - np.sum(d * d) / np.sum((t64 - t64.mean()) ** 2),
        "PSNR": 10 * np.log10(data_range**2 / mse),
        "ExplainedVariance": 1 - np.var(d) / np.var(t64),
    }
    reg_err = max(check(f"regression leg {k}", got[k], v, REG_TOL) for k, v in want.items())
    msle = mean_squared_log_error(reg_p.abs(), reg_t.abs()).item()
    reg_err = max(reg_err, check("mean_squared_log_error", msle,
                                 np.mean((np.log1p(np.abs(p64)) - np.log1p(np.abs(t64))) ** 2), REG_TOL))
    mre = mean_relative_error(reg_p, reg_t).item()
    reg_err = max(reg_err, check("mean_relative_error", mre,
                                 np.mean(np.abs((p64 - t64) / np.where(t64 == 0, 1.0, t64))), REG_TOL))
    two = R2Score(num_outputs=2, multioutput="raw_values", adjusted=3)
    p2, t2 = reg_p.reshape(-1, 2), reg_t.reshape(-1, 2)
    for b in range(BATCHES):
        rows = slice(b * BATCH // 2, (b + 1) * BATCH // 2)
        two.update(p2[rows], t2[rows])
    d2, t2_64 = d.reshape(-1, 2), t64.reshape(-1, 2)
    n2 = d2.shape[0]
    r2_cols = 1 - np.sum(d2 * d2, 0) / np.sum((t2_64 - t2_64.mean(0)) ** 2, 0)
    two_value = two.compute().cpu().numpy()
    reg_err = max(reg_err, check("R2Score(num_outputs=2, adjusted=3)", two_value,
                                 1 - (1 - r2_cols) * (n2 - 1) / (n2 - 3 - 1), REG_TOL))
    fresh = reg_collection()
    _syncs(torch, lambda: fresh.update(reg_p[:BATCH], reg_t[:BATCH]))  # the first counted window may see one more
    update_sites = _syncs(torch, lambda: fresh.update(reg_p[:BATCH], reg_t[:BATCH]))
    forward_sites = _syncs(torch, lambda: fresh(reg_p[:BATCH], reg_t[:BATCH]))
    if update_sites:
        raise AssertionError(f"one regression collection update synchronized with the host at {update_sites}")
    print(f"4f. regression leg (MSE + MAE + R2 + PSNR + EV), {BATCHES} forward batches of {BATCH}: {got}, max"
          f" relative error {reg_err:.3g} against float64 (MSLE {msle:.7f}, relative error {mre:.5f}, 2-output"
          f" adjusted R2 {two_value}); shared pass {len(stats_calls)} times in {BATCHES} batches, equal to the"
          f" unshared values within {share_err:.3g}; syncs per update {len(update_sites)}, per forward"
          f" {len(forward_sites)} {forward_sites}")

    # b. BASELINE config 4's images (bench.py:1458, 1470-1471), under global TF32 flags
    flags = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")

    def flags_kept(label):
        if torch.get_float32_matmul_precision() != "high" or torch.backends.cudnn.allow_tf32 is not True:
            raise AssertionError(f"{label} changed the caller's TF32 flags")

    try:
        rs = np.random.RandomState(SEED + 4)
        img_t_np = rs.rand(*IMG_SHAPE).astype(np.float32)
        img_p_np = np.clip(img_t_np * 0.8 + 0.2 * rs.rand(*IMG_SHAPE), 0, 1).astype(np.float32)
        img_t, img_p = torch.from_numpy(img_t_np).to(dev), torch.from_numpy(img_p_np).to(dev)
        ip64, it64 = img_p_np.astype(np.float64), img_t_np.astype(np.float64)
        img_mse = np.mean((ip64 - it64) ** 2)
        img_err = check("psnr(data_range=1.0)", psnr(img_p, img_t, data_range=1.0).item(),
                        10 * np.log10(1.0 / img_mse), REG_TOL)
        psnr_module, psnr_images = PSNR(), PSNR(dim=(1, 2, 3), data_range=1.0, reduction="none")
        for rows in np.array_split(np.arange(IMG_SHAPE[0]), 4):
            psnr_module(img_p[rows[0]:rows[-1] + 1], img_t[rows[0]:rows[-1] + 1])
            psnr_images(img_p[rows[0]:rows[-1] + 1], img_t[rows[0]:rows[-1] + 1])
        img_range = max(it64.max(), 0.0) - min(it64.min(), 0.0)
        img_err = max(img_err, check("PSNR() over 4 batches", psnr_module.compute().item(),
                                     10 * np.log10(img_range**2 / img_mse), REG_TOL))
        img_err = max(img_err, check("PSNR(dim=(1, 2, 3), reduction='none')", psnr_images.compute().cpu().numpy(),
                                     10 * np.log10(1.0 / np.mean((ip64 - it64) ** 2, axis=(1, 2, 3))), REG_TOL))
        total, count = _oracle_ssim(img_p_np, img_t_np, 1.0)
        ssim_128 = ssim(img_p, img_t, data_range=1.0).item()
        flags_kept("ssim at 128 x 128")
        ssim_err = {"128x128": check("ssim at 16x3x128x128 (banded)", ssim_128, total / count, SSIM_TOL, False)}
        # the same blur with TF32 left on: what the gate keeps out
        full_float32 = ssim_module._full_float32
        ssim_module._full_float32 = contextlib.nullcontext
        try:
            out["ssim_128_err_with_tf32_blur"] = abs(ssim(img_p, img_t, data_range=1.0).item() - total / count)
        finally:
            ssim_module._full_float32 = full_float32
        print(f"4f. images {IMG_SHAPE}: psnr, PSNR() over 4 batches and per-image PSNR within {img_err:.3g} relative;"
              f" ssim {ssim_128:.8f}, {ssim_err['128x128']:.3g} from float64 (with a TF32 blur"
              f" {out['ssim_128_err_with_tf32_blur']:.3g})")

        # c. the convolution form: the Kodak set's shape through SSIM(), then 4 Cityscapes-size frames
        rs = np.random.RandomState(SEED + 5)
        kodak_shape = (KODAK_IMAGES, 3, KODAK_H, KODAK_W)
        kodak_t_np = rs.rand(*kodak_shape).astype(np.float32)
        kodak_p_np = np.clip(kodak_t_np * 0.8 + 0.2 * rs.rand(*kodak_shape), 0, 1).astype(np.float32)
        kodak_t, kodak_p = torch.from_numpy(kodak_t_np).to(dev), torch.from_numpy(kodak_p_np).to(dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # SSIM's buffer warning
            kodak = SSIM()
        for b in range(KODAK_IMAGES // KODAK_BATCH):
            kodak.update(kodak_p[b * KODAK_BATCH:(b + 1) * KODAK_BATCH], kodak_t[b * KODAK_BATCH:(b + 1) * KODAK_BATCH])
        ssim_kodak = kodak.compute().item()
        flags_kept("SSIM().compute() over Kodak")
        kodak_range = max(np.ptp(kodak_p_np.astype(np.float64)), np.ptp(kodak_t_np.astype(np.float64)))
        total, count = _oracle_ssim(kodak_p_np, kodak_t_np, kodak_range)
        ssim_err["512x768"] = check("SSIM() over Kodak (convolution)", ssim_kodak, total / count, SSIM_TOL, False)
        rs = np.random.RandomState(SEED + 6)
        frames_shape = (FRAMES, 3, CITY_H, CITY_W)
        frames_t_np = rs.rand(*frames_shape).astype(np.float32)
        frames_p_np = np.clip(frames_t_np * 0.8 + 0.2 * rs.rand(*frames_shape), 0, 1).astype(np.float32)
        frames_t, frames_p = torch.from_numpy(frames_t_np).to(dev), torch.from_numpy(frames_p_np).to(dev)
        ssim_frames = ssim(frames_p, frames_t, data_range=1.0).item()
        flags_kept(f"ssim at {frames_shape}")
        total, count = _oracle_ssim(frames_p_np, frames_t_np, 1.0)
        ssim_err["1024x2048"] = check(f"ssim at {frames_shape} (convolution)", ssim_frames, total / count,
                                      SSIM_TOL, False)
        print(f"4f. SSIM under TF32 flags: Kodak {kodak_shape} in {KODAK_IMAGES // KODAK_BATCH} batches"
              f" {ssim_kodak:.8f}, frames {frames_shape} {ssim_frames:.8f}; from float64: {ssim_err}; flags kept")
    finally:
        torch.set_float32_matmul_precision(flags[0])
        torch.backends.cudnn.allow_tf32 = flags[1]
    del kodak_t_np, kodak_p_np, frames_t_np, frames_p_np

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ssim_metric = SSIM()
    ssim_metric.update(img_p, img_t)
    ssim_sites = _syncs(torch, lambda: ssim_metric.update(img_p, img_t))
    if ssim_sites:
        raise AssertionError(f"one SSIM update synchronized with the host at {ssim_sites}")

    # d. metric arithmetic: forward keeps every operand's accumulation
    rmse = MeanSquaredError() ** 0.5
    for b in range(BATCHES):
        rmse(reg_p[b * BATCH:(b + 1) * BATCH], reg_t[b * BATCH:(b + 1) * BATCH])
    comp_err = check("MeanSquaredError() ** 0.5", rmse.compute().item(), got["MeanSquaredError"] ** 0.5, COMP_TOL)
    p4_np, t4_np, p4, t4 = leg
    mean_pr = (Precision(num_classes=4, average="macro") + Recall(num_classes=4, average="macro")) / 2
    for b in range(BATCHES):
        last_step = mean_pr(p4[b * BATCH:(b + 1) * BATCH], t4[b * BATCH:(b + 1) * BATCH]).item()
    counts4 = _oracle_counts(np.bincount(t4_np * 4 + p4_np.argmax(1), minlength=16).reshape(4, 4))
    precision, recall, _ = _oracle_prf(counts4[0], counts4[1], counts4[3])
    epoch_pr = mean_pr.compute().item()
    comp_err = max(comp_err, check("(Precision + Recall) / 2 after forward", epoch_pr, (precision + recall) / 2,
                                   COMP_TOL))
    print(f"4f. composition: RMSE {rmse.compute().item():.7f}; (Precision + Recall) / 2 {epoch_pr:.7f} (the epoch's;"
          f" last batch {last_step:.7f}), within {comp_err:.3g} of float64")

    # timings (phase 5): host clock ending in a synchronize, one warm-up, median of 5
    out["forward_batch_ms"] = warm_ms(lambda: reg(reg_p[:BATCH], reg_t[:BATCH]))
    out["compute_ms"] = computed_ms(list(reg.values()))
    out["forward_batch_unshared_ms"] = warm_ms(lambda: [m(reg_p[:BATCH], reg_t[:BATCH]) for m in alone.values()])
    out["r2score_1m_ms"] = warm_ms(lambda: r2score(reg_p, reg_t))
    out["mean_squared_error_1m_ms"] = warm_ms(lambda: mean_squared_error(reg_p, reg_t))
    out["psnr_16x3x128x128_ms"] = warm_ms(lambda: psnr(img_p, img_t, data_range=1.0))
    out["ssim_16x3x128x128_ms"] = warm_ms(lambda: ssim(img_p, img_t, data_range=1.0))
    out["ssim_compute_kodak_ms"] = computed_ms([kodak])
    out["ssim_4x3x1024x2048_ms"] = warm_ms(lambda: ssim(frames_p, frames_t, data_range=1.0))
    split = ssim_module._MATMUL_BLUR_MAX_DIM
    blur_diff = {}
    for label, (p, t) in (("128x128", (img_p, img_t)), ("512x768", (kodak_p, kodak_t)),
                          ("1024x2048", (frames_p, frames_t))):
        stack = torch.cat((p, t, p * p, t * t, p * t))
        blurred = {}
        for form, limit in (("banded", 1 << 30), ("conv", 0)):
            ssim_module._MATMUL_BLUR_MAX_DIM = limit
            try:
                out[f"blur_{form}_{label}_ms"] = warm_ms(
                    lambda: ssim_module._depthwise_blur(stack, (11, 11), (1.5, 1.5)))
                blurred[form] = ssim_module._depthwise_blur(stack, (11, 11), (1.5, 1.5))
            finally:
                ssim_module._MATMUL_BLUR_MAX_DIM = split
        blur_diff[label] = torch.max(torch.abs(blurred["banded"] - blurred["conv"])).item()
        del stack, blurred
    if not max(blur_diff.values()) <= BLUR_TOL:
        raise AssertionError(f"the banded and convolution blurs disagree: {blur_diff}")
    out.update(ssim_err=ssim_err, regression_max_rel_err=reg_err, shared_vs_unshared_max_rel_err=share_err,
               shared_pass_calls=len(stats_calls), syncs_per_update=len(update_sites),
               syncs_per_forward=len(forward_sites), forward_sync_sites=forward_sites,
               ssim_syncs_per_update=len(ssim_sites), composition_max_err=comp_err, blur_forms_max_abs_diff=blur_diff)
    print(f"4f. times: forward batch {out['forward_batch_ms']:.3f} ms (unshared {out['forward_batch_unshared_ms']:.3f}),"
          f" compute {out['compute_ms']:.3f} ms, ssim 128 {out['ssim_16x3x128x128_ms']:.3f} ms, Kodak compute"
          f" {out['ssim_compute_kodak_ms']:.3f} ms, frames {out['ssim_4x3x1024x2048_ms']:.3f} ms; blur banded/conv"
          + "".join(f" {k} {out[f'blur_banded_{k}_ms']:.3f}/{out[f'blur_conv_{k}_ms']:.3f}" for k in blur_diff)
          + f" ms (max |d| {max(blur_diff.values()):.3g})")
    del kodak, kodak_p, kodak_t
    return out, (reg, (reg_p[:BATCH], reg_t[:BATCH])), (frames_p, frames_t)


def _oracle_retrieval(idx: np.ndarray, preds: np.ndarray, target: np.ndarray, ks=(10, 100)) -> dict:
    """Per-query float64 oracle: a lexsort by (query id, -score, position),
    then each query's relevant count, first relevant rank, hits in the top
    k, AP, RR, P@k and R@k, and their means over the queries with a
    relevant document (``empty_target_action="skip"``)."""
    score = np.where(np.isnan(preds), -np.inf, preds.astype(np.float64))
    order = np.lexsort((np.arange(idx.size), -score, idx))
    q, rel = idx[order], target[order] > 0
    starts = np.flatnonzero(np.r_[True, q[1:] != q[:-1]])
    sizes = np.diff(np.r_[starts, q.size])
    rank = np.arange(q.size) - np.repeat(starts, sizes) + 1
    cum = np.cumsum(rel)
    within = cum - np.repeat((cum - rel)[starts], sizes)
    out = {"n_rel": np.add.reduceat(rel.astype(np.int64), starts),
           "first": np.add.reduceat(np.where(rel & (within == 1), rank, 0), starts)}
    n_rel = np.maximum(out["n_rel"], 1)
    ap = np.add.reduceat(np.where(rel, within / rank, 0.0), starts) / n_rel
    rr = np.where(out["first"] > 0, 1.0 / np.maximum(out["first"], 1), 0.0)
    kept = out["n_rel"] > 0
    out["RetrievalMAP"], out["RetrievalMRR"] = float(np.mean(ap[kept])), float(np.mean(rr[kept]))
    for k in ks:
        out[f"hits@{k}"] = np.add.reduceat((rel & (rank <= k)).astype(np.int64), starts)
        out[f"precision@{k}"] = float(np.mean(out[f"hits@{k}"][kept] / k))
        out[f"recall@{k}"] = float(np.mean(out[f"hits@{k}"][kept] / n_rel[kept]))
    out["query_ap_rr"] = (ap, rr)
    return out


def _dtoh_bytes(torch, fn, path: str):
    """(bytes, copies) of the device-to-host copies ``fn()`` makes, read
    from a ``torch.profiler`` trace written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    if not copies or any("bytes" not in e.get("args", {}) for e in copies):
        raise AssertionError(f"the trace shows {len(copies)} device-to-host copies, not all with a byte count")
    return sum(int(e["args"]["bytes"]) for e in copies), len(copies)


def _retrieval_phase(torch, dev):
    """Phase 4g: the retrieval family on the card.

    Returns the phase's timings and what phase 6 profiles."""
    from metrics_tpu_torch import (
        F1,
        Accuracy,
        MetricCollection,
        RetrievalMAP,
        RetrievalMRR,
        RetrievalPrecision,
        RetrievalRecall,
        ShardedAUROC,
        ShardedRetrievalMAP,
        ShardedRetrievalMRR,
        ShardedRetrievalPrecision,
        ShardedRetrievalRecall,
    )
    from metrics_tpu_torch.functional import (
        retrieval_average_precision,
        retrieval_precision,
        retrieval_recall,
        retrieval_reciprocal_rank,
    )

    # the modules themselves: the package names their public functions alike
    segment = importlib.import_module("metrics_tpu_torch.ops.segment")
    map_module = importlib.import_module("metrics_tpu_torch.retrieval.mean_average_precision")
    mrr_module = importlib.import_module("metrics_tpu_torch.retrieval.mean_reciprocal_rank")
    trace_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "retrieval_compute_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    out = {}

    def four(sharded_capacity=None):
        if sharded_capacity:
            return MetricCollection([ShardedRetrievalMAP(sharded_capacity), ShardedRetrievalMRR(sharded_capacity),
                                     ShardedRetrievalPrecision(sharded_capacity, k=10),
                                     ShardedRetrievalRecall(sharded_capacity, k=100)])
        return MetricCollection([RetrievalMAP(), RetrievalMRR(), RetrievalPrecision(k=10), RetrievalRecall(k=100)])

    def bits(collection):
        for metric in collection.values():
            metric._computed = None
        return {k.replace("Sharded", ""): v.cpu().numpy().tobytes() for k, v in collection.compute().items()}

    def computed_ms(collection, trials=5):
        times = []
        for _ in range(trials + 1):
            for metric in collection.values():
                metric._computed = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            collection.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times[1:]))

    def fed(collection, idx, preds, target, batch):
        """Update ``collection`` batch by batch; host ms of each update."""
        times = []
        for lo in range(0, idx.shape[0], batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            collection.update(idx[lo:lo + batch], preds[lo:lo + batch], target[lo:lo + batch])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times

    def check(label, collection, oracle):
        """Every value within RET_TOL of the float64 oracle, the integer
        quantities equal to its, a second compute's bits equal."""
        names = {"RetrievalMAP": "RetrievalMAP", "RetrievalMRR": "RetrievalMRR",
                 "RetrievalPrecision": "precision@10", "RetrievalRecall": "recall@100"}
        got = {k.replace("Sharded", ""): v.item() for k, v in collection.compute().items()}
        err = {k: abs(v - oracle[names[k]]) for k, v in got.items()}
        if not all(np.isfinite(v) for v in got.values()) or not max(err.values()) <= RET_TOL:
            raise AssertionError(f"{label}: {got} vs the float64 oracle (errors {err})")
        first = bits(collection)
        if bits(collection) != first:
            raise AssertionError(f"{label}: a second compute over the same state gave other bits")
        return got, max(err.values()), first

    def check_counts(label, idx, preds, target, oracle):
        stats = segment._ranked_query_stats(idx, preds, target)
        got = {"n_rel": stats.pos_per_group, "first": mrr_module._first_relevant_ranks(stats),
               "hits@10": segment.hits_in_topk(stats, 10)[0], "hits@100": segment.hits_in_topk(stats, 100)[0]}
        bad = [k for k, v in got.items() if not np.array_equal(v.cpu().numpy().astype(np.int64), oracle[k])]
        if bad:
            raise AssertionError(f"{label}: {bad} differ from the oracle's integers")
        return int(stats.pos_per_group.shape[0])

    # a. BASELINE config 5, the JAX bench's retrieval leg (bench.py:1455-1533):
    # MAP + MRR in a collection, 10 update batches of 100,000
    idx = torch.randint(0, RET_Q, (RET_N,), generator=gen, device=dev, dtype=torch.int32)
    scores = torch.rand(RET_N, generator=gen, device=dev)
    rel = (torch.rand(RET_N, generator=gen, device=dev) < RET_REL).to(torch.int32)
    idx_np, scores_np, rel_np = idx.cpu().numpy(), scores.cpu().numpy(), rel.cpu().numpy()
    oracle = _oracle_retrieval(idx_np, scores_np, rel_np)
    leg = MetricCollection([RetrievalMAP(), RetrievalMRR()])
    leg_updates = fed(leg, idx, scores, rel, BATCH)
    leg_values, leg_err, leg_bits = check("config 5 MAP + MRR", leg, oracle)
    leg_queries = check_counts("config 5", idx, scores, rel, oracle)
    out["config5_update_batch_ms"] = float(np.median(leg_updates))
    out["config5_compute_ms"] = computed_ms(leg)

    def core():
        stats = segment.ranked_group_stats(idx, scores, rel, RET_Q)
        return map_module._map_segments(stats), mrr_module._mrr_segments(stats), stats.pos_per_group

    ap_q, rr_q, pos = core()
    kept = (pos > 0).cpu().numpy()
    core_err = max(abs(float(ap_q.double().cpu().numpy()[kept].mean()) - oracle["RetrievalMAP"]),
                   abs(float(rr_q.double().cpu().numpy()[kept].mean()) - oracle["RetrievalMRR"]))
    if not core_err <= RET_TOL:
        raise AssertionError(f"the functional core reads {core_err} off the float64 oracle")
    core()
    out["config5_functional_core_ms"] = _host_ms(torch, core)
    print(f"4g. config 5 (1M rows, {leg_queries} queries): MAP {leg_values['RetrievalMAP']:.7f}, MRR"
          f" {leg_values['RetrievalMRR']:.7f}, within {leg_err:.3g} of float64 (functional core {core_err:.3g});"
          f" integers exact; update {out['config5_update_batch_ms']:.3f} ms a batch, compute"
          f" {out['config5_compute_ms']:.3f} ms, functional core {out['config5_functional_core_ms']:.3f} ms")

    # b. host synchronizations and device-to-host bytes of one compute, at 100
    # and 10,000 queries over the same 1M rows
    syncs, dtoh = {}, {}
    for queries in (100, RET_Q):
        collection = four()
        collection.update(idx % queries, scores, rel)
        collection.compute()  # first calls may synchronize once more
        for metric in collection.values():
            metric._computed = None
        syncs[queries] = _syncs(torch, collection.compute)
        # two traces, the one with more copies kept: CUPTI can drop a
        # record from a trace (seen on this card), never add one
        traced = []
        for _ in range(2):
            for metric in collection.values():
                metric._computed = None
            traced.append(_dtoh_bytes(torch, collection.compute, trace_path))
        dtoh[queries] = max(traced, key=lambda bc: bc[1])
        del collection
    counts_of = {q: len(s) for q, s in syncs.items()}
    if len(set(counts_of.values())) != 1 or not counts_of[RET_Q]:
        raise AssertionError(f"host syncs per compute of the four metrics grow with the queries: {syncs}")
    if max(b for b, _ in dtoh.values()) > 4096 or dtoh[100][0] != dtoh[RET_Q][0]:
        raise AssertionError(f"a compute copied an O(N) array to the host: (bytes, copies) {dtoh}")
    out.update(syncs_per_compute=counts_of[RET_Q], sync_sites=syncs[RET_Q],
               dtoh_bytes_per_compute={str(q): v[0] for q, v in dtoh.items()},
               dtoh_copies_per_compute={str(q): v[1] for q, v in dtoh.items()})
    print(f"4g. host syncs per compute of MAP + MRR + P@10 + R@100 over 1M rows: {counts_of[100]} at 100 queries,"
          f" {counts_of[RET_Q]} at {RET_Q}; device-to-host bytes {dtoh[100][0]} / {dtoh[RET_Q][0]}")

    # c. BASELINE config 5's epoch at world 1 (bench.py:246-270): one update and
    # one compute of Accuracy + F1, ShardedAUROC, ShardedRetrievalMAP / MRR
    col = MetricCollection([Accuracy(), F1()])
    sa, sm, sr = ShardedAUROC(capacity_per_device=RET_N), ShardedRetrievalMAP(RET_N), ShardedRetrievalMRR(RET_N)

    def epoch():
        for metric in (*col.values(), sa, sm, sr):
            metric.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        col.update(scores, rel)
        sa.update(scores, rel)
        sm.update(idx, scores, rel)
        sr.update(idx, scores, rel)
        values = [*col.compute().values(), sa.compute(), sm.compute(), sr.compute()]
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, values

    epoch()
    epochs = [epoch()[0] for _ in range(5)]
    _, epoch_values = epoch()
    if {"RetrievalMAP": epoch_values[3].cpu().numpy().tobytes(),
            "RetrievalMRR": epoch_values[4].cpu().numpy().tobytes()} != leg_bits:
        raise AssertionError("ShardedRetrievalMAP / MRR at world 1 differ from RetrievalMAP / MRR in their bits")
    out["config5_epoch_ms"] = float(np.median(epochs))
    out["config5_epoch_ms_runs"] = epochs
    print(f"4g. config 5 epoch (Accuracy + F1, ShardedAUROC, ShardedRetrievalMAP / MRR, 1M rows):"
          f" {out['config5_epoch_ms']:.3f} ms; the sharded retrieval values equal the unsharded bits")

    # d. the MS MARCO passage ranking dev (small) shape: 6,980 queries x 1,000
    # candidates, 7,437 relevant rows, 70 batches of 100 queries
    ids = torch.randperm(MSMARCO_ID_SPACE, generator=gen, device=dev)[:MSMARCO_Q].to(torch.int32)
    first = torch.randint(0, MSMARCO_DOCS, (MSMARCO_Q,), generator=gen, device=dev)
    grid = torch.zeros(MSMARCO_Q, MSMARCO_DOCS, dtype=torch.int32, device=dev)
    grid[torch.arange(MSMARCO_Q, device=dev), first] = 1
    extra = torch.randperm(MSMARCO_Q, generator=gen, device=dev)[:MSMARCO_REL - MSMARCO_Q]
    shift = torch.randint(1, MSMARCO_DOCS, (extra.shape[0],), generator=gen, device=dev)
    grid[extra, (first[extra] + shift) % MSMARCO_DOCS] = 1
    ms_scores = (torch.randn(MSMARCO_Q, MSMARCO_DOCS, generator=gen, device=dev) + MSMARCO_SHIFT * grid).reshape(-1)
    ms_rel = grid.reshape(-1)
    ms_idx = ids[:, None].expand(MSMARCO_Q, MSMARCO_DOCS).reshape(-1).contiguous()
    if int(ms_rel.sum()) != MSMARCO_REL:
        raise AssertionError(f"the MS MARCO shape holds {int(ms_rel.sum())} relevant rows")
    ms_np = ms_idx.cpu().numpy(), ms_scores.cpu().numpy(), ms_rel.cpu().numpy()
    ms_oracle = _oracle_retrieval(*ms_np)
    ms = four()
    ms_updates = fed(ms, ms_idx, ms_scores, ms_rel, MSMARCO_BATCH_Q * MSMARCO_DOCS)
    ms_values, ms_err, ms_bits = check("MS MARCO", ms, ms_oracle)
    ms_queries = check_counts("MS MARCO", ms_idx, ms_scores, ms_rel, ms_oracle)
    ms_sharded = four(MSMARCO_Q * MSMARCO_DOCS)
    fed(ms_sharded, ms_idx, ms_scores, ms_rel, MSMARCO_BATCH_Q * MSMARCO_DOCS)
    if bits(ms_sharded) != ms_bits:
        raise AssertionError("the sharded metrics at world 1 differ from the unsharded ones in their bits")
    del ms_sharded
    out["msmarco_update_batch_ms"] = float(np.median(ms_updates))
    out["msmarco_compute_ms"] = computed_ms(ms)
    for metric in ms.values():
        metric._computed = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms.compute()
    torch.cuda.synchronize()
    out["msmarco_compute_peak_bytes_above_state"] = torch.cuda.max_memory_allocated() - base
    out["msmarco_state_bytes"] = base
    # both formulations of the (query asc, score desc, position) permutation
    g_two, o_two = segment._lex_order_two_pass(ms_idx, ms_scores)
    g_packed, o_packed = segment._lex_order_packed(ms_idx, ms_scores)
    if not (torch.equal(g_two, g_packed) and torch.equal(o_two, o_packed)):
        raise AssertionError("the two sort forms give different permutations")
    del g_two, o_two, g_packed, o_packed
    out["msmarco_sort_two_pass_ms"] = _queued_ms(torch, lambda: segment._lex_order_two_pass(ms_idx, ms_scores), 10)
    out["msmarco_sort_packed_ms"] = _queued_ms(torch, lambda: segment._lex_order_packed(ms_idx, ms_scores), 10)
    out["sort_form_kept"] = segment._lex_order.__name__
    # the functional forms on the first query's 1,000 candidates
    q_ap, q_rr = ms_oracle["query_ap_rr"]
    q0 = int(torch.argmin(ids))  # the oracle's first query is the smallest id
    rows = slice(q0 * MSMARCO_DOCS, (q0 + 1) * MSMARCO_DOCS)
    p0, t0 = ms_scores[rows], ms_rel[rows]
    functional = {"ap": (retrieval_average_precision(p0, t0).item(), q_ap[0]),
                  "rr": (retrieval_reciprocal_rank(p0, t0).item(), q_rr[0]),
                  "p@10": (retrieval_precision(p0, t0, k=10).item(), ms_oracle["hits@10"][0] / 10),
                  "r@100": (retrieval_recall(p0, t0, k=100).item(),
                            ms_oracle["hits@100"][0] / ms_oracle["n_rel"][0])}
    fn_err = max(abs(a - b) for a, b in functional.values())
    if not fn_err <= RET_TOL:
        raise AssertionError(f"the functional forms read off the float64 oracle: {functional}")
    out.update(config5_values=leg_values, config5_max_err=leg_err, config5_core_max_err=core_err,
               msmarco_values=ms_values, msmarco_max_err=ms_err, functional_max_err=fn_err,
               msmarco_queries=ms_queries, config5_queries=leg_queries)
    print(f"4g. MS MARCO dev shape ({ms_queries} queries x {MSMARCO_DOCS}, {MSMARCO_REL} relevant):"
          + "".join(f" {k} {v:.7f}" for k, v in ms_values.items())
          + f", within {ms_err:.3g} of float64; integers exact; sharded bits equal; update"
          f" {out['msmarco_update_batch_ms']:.3f} ms a batch, compute {out['msmarco_compute_ms']:.3f} ms"
          f" (peak {out['msmarco_compute_peak_bytes_above_state'] / 2**20:.1f} MiB above the state); sorts: two"
          f" int32 {out['msmarco_sort_two_pass_ms']:.3f} ms, packed int64 {out['msmarco_sort_packed_ms']:.3f} ms")
    return out, ms


def _trace_once(torch, fn, pad):
    """One ``torch.profiler`` trace of ``fn()`` with ``pad`` seconds of idle
    card before it and of host time on each side of the call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    time.sleep(pad)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    return prof


def _record_names(torch, prof):
    """The multiset of a trace's device-record names, the ranges' own records
    left out."""
    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA
                               and not e.name.startswith(RANGE_PREFIXES))


def _record_origins(torch, prof, names):
    """``name -> {"stream S, thread T": records}`` of the device records
    named in ``names``, read off the trace's Kineto events (the launch's
    runtime call carries the thread); ``{"unavailable": ...}`` where this
    torch's events do not expose them."""
    try:
        events = prof.profiler.kineto_results.events()
        cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
        launcher = {e.correlation_id(): e.start_thread_id() for e in events
                    if e.device_type() == cpu and e.correlation_id()}
        out = {}
        for e in events:
            if e.device_type() == cuda and e.name() in names:
                thread = launcher.get(e.correlation_id(), launcher.get(e.linked_correlation_id()))
                where = out.setdefault(e.name(), collections.Counter())
                where[f"stream {e.device_resource_id()}, thread {thread}"] += 1
        return {name: dict(where) for name, where in out.items()}
    except Exception as err:  # noqa: BLE001 — a diagnostic only
        return {"unavailable": repr(err)}


def _paired_device_ops(torch, first, second, shows=None, contexts=(None, None)):
    """(kernels, copies and fills) of ``first()`` and of ``second()``, read
    off traces taken in turns — first, second, first, second — so that both
    counts come from the same stretch of the process: the counts of the
    first round whose two traces hold the same multiset of device-record
    names. ``contexts`` are context-manager factories each side's trace runs
    inside (entered before the profiler starts). A round with a trace
    without device records, or without one whose name contains ``shows``,
    is lost and doubles the pad, as in :func:`_steady_profile`. A real
    extra kernel or copy on one side shows in every trace of that side, so
    no round agrees and the check fails; a record CUPTI gains or drops in
    one trace only spoils that round. Returns ``(ops_first, ops_second,
    rounds)``: ``rounds`` lists each disagreeing round's multiset
    difference (and the records' streams and launching threads). Raises
    when no round of ``PROFILE_TRACES_MAX`` agrees, with every round's
    difference."""
    lost, rounds = 0, []
    for taken in range(1, PROFILE_TRACES_MAX + 1):
        pad = PROFILE_PAD_S * 2 ** lost
        pair = []
        for fn, ctx in zip((first, second), contexts):
            with (ctx() if ctx is not None else contextlib.nullcontext()):
                prof = _trace_once(torch, fn, pad)
            pair.append((prof, _record_names(torch, prof)))
        if any(not c or (shows is not None and not any(shows in k for k in c)) for _, c in pair):
            lost += 1
            rounds.append({"round": taken, "lost": [sum(c.values()) for _, c in pair]})
            continue
        (prof_a, a), (prof_b, b) = pair
        if a == b:
            PROFILE_TRACES_TAKEN[f"paired {taken}"] = PROFILE_TRACES_TAKEN.get(f"paired {taken}", 0) + 1
            PROFILE_TRACES_TAKEN["lost"] = PROFILE_TRACES_TAKEN.get("lost", 0) + lost
            return _ops_in(torch, prof_a), _ops_in(torch, prof_b), rounds
        only_a, only_b = dict(a - b), dict(b - a)
        rounds.append({"round": taken, "records": [sum(a.values()), sum(b.values())],
                       "first_only": only_a, "second_only": only_b,
                       "first_origins": _record_origins(torch, prof_a, set(only_a)) if only_a else {},
                       "second_origins": _record_origins(torch, prof_b, set(only_b)) if only_b else {}})
    PROFILE_TRACES_TAKEN["paired: none agreed"] = PROFILE_TRACES_TAKEN.get("paired: none agreed", 0) + 1
    PROFILE_TRACES_TAKEN["lost"] = PROFILE_TRACES_TAKEN.get("lost", 0) + lost
    raise AssertionError(f"no round of {PROFILE_TRACES_MAX} traced the two calls' device work alike: {rounds}")


def _steady_profile(torch, fn, shows=None):
    """A ``torch.profiler`` trace of ``fn()`` whose count of device records
    another trace of the same call agrees on: ``fn`` runs under the profiler
    until two traces agree, at most ``PROFILE_TRACES_MAX`` times (then the
    median trace). CUPTI has dropped records from a trace on this card (all
    of them, five times in a row; or, twice in a row, a ctypes-launched
    kernel's record but not its memset's) and once showed one record more
    than its twin; a real extra kernel or copy shows in every trace, so a
    check on the agreed trace is as strict as on a complete one. A trace
    without a device record, or without one whose name contains ``shows``
    (a kernel the call certainly launches, as the check also requires), is
    a lost trace and never agreed on. Lost traces come in runs late in a
    long process (eight in a row once, 25 s apart), and a trace once held
    the copies of a read made just before it: short windows lose their
    device records and gain their neighbours', as when the GPU's clock
    drifts from the host's one the profiler keeps records by. So the card
    idles ``PROFILE_PAD_S`` before a trace, and the window holds that much
    host time on each side of the call, doubled after each lost trace."""
    cuda = torch.autograd.DeviceType.CUDA
    traces = []
    lost = 0
    PROFILE_LAST_RECORDS.clear()
    for taken in range(1, PROFILE_TRACES_MAX + 1):
        prof = _trace_once(torch, fn, PROFILE_PAD_S * 2 ** lost)
        names = [e.name for e in prof.events() if e.device_type == cuda]
        n = len(names)
        PROFILE_LAST_RECORDS.append(n)
        if not n or (shows is not None and not any(shows in name for name in names)):
            lost += 1
            continue
        if any(m == n for m, _ in traces):
            PROFILE_TRACES_TAKEN[taken] = PROFILE_TRACES_TAKEN.get(taken, 0) + 1
            PROFILE_TRACES_TAKEN["lost"] = PROFILE_TRACES_TAKEN.get("lost", 0) + lost
            return prof
        traces.append((n, prof))
    PROFILE_TRACES_TAKEN["none agreed"] = PROFILE_TRACES_TAKEN.get("none agreed", 0) + 1
    PROFILE_TRACES_TAKEN["lost"] = PROFILE_TRACES_TAKEN.get("lost", 0) + lost
    if not traces:
        return prof
    return sorted(traces, key=lambda t: t[0])[len(traces) // 2][1]


def _is_copy(name: str) -> bool:
    """A device record of a copy or a fill: ``Memcpy ...`` / ``Memset ...``,
    and ``memcpy32_post``, the kernel a CUDA graph's copy node runs as in
    the first graph a process captures (a copy record in later ones)."""
    return name.lower().startswith(("memcpy", "memset"))


def _device_ops(torch, fn, shows=None):
    """(kernels, copies and fills) the device runs for ``fn()``, counted in
    an agreed ``torch.profiler`` trace (``fn`` runs two to eight times) that
    shows a kernel whose name contains ``shows``, where given."""
    return _ops_in(torch, _steady_profile(torch, fn, shows))


def _ops_in(torch, prof):
    """(kernels, copies and fills) of a ``torch.profiler`` trace, the
    ranges' own records left out."""
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith(RANGE_PREFIXES)]
    copies = sum(e.count for e in ops if _is_copy(e.key))
    return sum(e.count for e in ops) - copies, copies


def _engine_phase(torch, dev, binary):
    """Phase 4h: the step engine (``MetricCollection(compiled=True)``: one
    CUDA graph per call signature), the stat-score siblings' shared count,
    the wrapper and the functional extras on the card.

    ``binary`` is phase 3's ``(preds, target)`` on the card. Returns the
    phase's timings and what phase 6 profiles."""
    from metrics_tpu_torch import (
        AUROC,
        F1,
        PSNR,
        Accuracy,
        BootStrapper,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        MetricCollection,
        Precision,
        R2Score,
        Recall,
        StatScores,
    )
    from metrics_tpu_torch.functional import bleu_score, embedding_similarity, image_gradients
    from metrics_tpu_torch.ops import tie_scan

    boot_module = importlib.import_module("metrics_tpu_torch.wrappers.bootstrapping")
    out = {}

    def forward_leg(compiled):
        return MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                                 Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")],
                                compiled=compiled)

    def regression_leg(compiled):
        return MetricCollection([MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()],
                                compiled=compiled)

    def check_step(label, eager, compiled, ve, vc):
        """Values within ENGINE_TOL relative, integer states exact, float
        states within ENGINE_TOL relative."""
        worst = 0.0
        for k in ve:
            a, b = vc[k].double(), ve[k].double()
            err = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
            if not bool(torch.isfinite(a).all()) or not err <= ENGINE_TOL:
                raise AssertionError(f"{label}: compiled {k} {vc[k].tolist()} vs eager {ve[k].tolist()}")
            worst = max(worst, err)
        for name in eager.keys():
            for sname in eager[name]._defaults:
                a, b = getattr(compiled[name], sname), getattr(eager[name], sname)
                if a.is_floating_point():
                    err = float(((a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-30)).max())
                    if not err <= ENGINE_TOL:
                        raise AssertionError(f"{label}: state {name}.{sname} off eager by {err} relative")
                elif not torch.equal(a, b):
                    raise AssertionError(f"{label}: count {name}.{sname} differs from eager's")
        return worst

    def leg(label, make, batches):
        """The eager and the compiled collection over ``batches``: equality
        every step, no demotion, 0 syncs per replayed step, forward batch
        ms of both, the first step's build, the graph's pool."""
        eager, compiled = make(False), make(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vc = compiled(*batches[0])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        worst = check_step(f"{label} step 0", eager, compiled, eager(*batches[0]), vc)
        for b, batch in enumerate(batches[1:], 1):
            worst = max(worst, check_step(f"{label} step {b}", eager, compiled, eager(*batch), compiled(*batch)))
        for k, v in eager.compute().items():
            got = compiled.compute()[k]
            if not float(((got.double() - v.double()).abs() / v.double().abs().clamp_min(1e-30)).max()) <= ENGINE_TOL:
                raise AssertionError(f"{label}: epoch {k} {got.tolist()} vs eager {v.tolist()}")
        info = compiled._engine.cache_info()
        if info["eager_fallbacks"] or info["trace_count"] != 1:
            raise AssertionError(f"{label}: the engine demoted or rebuilt: {info}")
        sites = _syncs(torch, lambda: compiled(*batches[1]))
        if sites:
            raise AssertionError(f"{label}: a replayed step synchronized the host at {sites}")
        result = {
            "forward_batch_ms_compiled": _host_ms(torch, lambda: compiled(*batches[1])),
            "forward_batch_ms_eager": _host_ms(torch, lambda: eager(*batches[1])),
            # the replayed step's device time: steps queued behind a device sleep
            "replay_device_ms": _queued_ms(torch, lambda: compiled(*batches[1]), launches=20),
            "first_step_ms": first_ms,
            "warm_up_and_capture_ms": info["graph_build_ms"][0],
            "graph_pool_bytes": info["graph_pool_bytes"],
            "syncs_per_replayed_step": len(sites),
            "max_rel_err_vs_eager": worst,
        }
        print(f"4h. {label}: {len(batches)} batches compiled = eager (counts exact, max rel err {worst:.3g}),"
              f" no demotion, 0 syncs a replayed step; forward batch {result['forward_batch_ms_compiled']:.3f} ms"
              f" compiled ({result['replay_device_ms']:.3f} ms of device time) vs"
              f" {result['forward_batch_ms_eager']:.3f} ms eager; first step {first_ms:.1f} ms"
              f" (warm-up + capture {result['warm_up_and_capture_ms']:.1f} ms), graph pool"
              f" {info['graph_pool_bytes'] / 2**20:.1f} MiB")
        return result, compiled

    # a. the forward leg (phase 4e's data), then the JAX bench's 1M x 4 batch
    _, _, p4, t4 = _forward_leg_inputs(torch, dev)
    cls_batches = [(p4[b * BATCH:(b + 1) * BATCH], t4[b * BATCH:(b + 1) * BATCH]) for b in range(BATCHES)]
    out["forward_leg"], compiled_leg = leg(f"forward leg ({BATCHES} x {BATCH})", forward_leg, cls_batches)
    out["forward_leg_1m"], _ = leg(f"forward leg at {MAIN_N} x 4", forward_leg, [(p4, t4), (p4, t4)])

    # b. the regression leg (phase 4f's five metrics and rows)
    _, _, reg_p, reg_t = _regression_leg_inputs(torch, dev)
    reg_batches = [(reg_p[b * BATCH:(b + 1) * BATCH], reg_t[b * BATCH:(b + 1) * BATCH]) for b in range(BATCHES)]
    out["regression_leg"], compiled_reg = leg(f"regression leg ({BATCHES} x {BATCH})", regression_leg, reg_batches)

    # c. the stat-score siblings' count, eager: one forward of the collection
    # against the four metrics' own forwards (what the collection did before
    # the shared count)
    shared = forward_leg(False)
    alone = list(forward_leg(False).values())
    batch = cls_batches[0]
    shared(*batch)
    for m in alone:
        m(*batch)
    syncs_shared = _syncs(torch, lambda: shared(*batch))
    syncs_alone = _syncs(torch, lambda: [m(*batch) for m in alone])
    ops_shared, ops_alone = _device_ops(torch, lambda: shared(*batch)), _device_ops(torch, lambda: [m(*batch) for m in alone])
    if len(syncs_shared) != 2 or len(syncs_alone) != 4:
        raise AssertionError(f"stat-score siblings: syncs shared {syncs_shared}, alone {syncs_alone}; want 2 and 4")
    out["siblings"] = {"syncs_per_forward_shared": len(syncs_shared), "syncs_per_forward_unshared": len(syncs_alone),
                       "kernels_per_forward_shared": ops_shared[0], "kernels_per_forward_unshared": ops_alone[0],
                       "copies_per_forward_shared": ops_shared[1], "copies_per_forward_unshared": ops_alone[1],
                       "forward_batch_ms_shared": _host_ms(torch, lambda: shared(*batch)),
                       "forward_batch_ms_unshared": _host_ms(torch, lambda: [m(*batch) for m in alone])}
    print(f"4h. stat-score siblings, eager forward of 4 metrics: {out['siblings']}")

    # d. the binary step (phase 3's batches): Accuracy captured, AUROC eager
    preds, target = binary
    eager_bin = MetricCollection([Accuracy(), AUROC(pos_label=1)])
    compiled_bin = MetricCollection([Accuracy(), AUROC(pos_label=1)], compiled=True)
    for b in range(BATCHES):
        sl = slice(b * BATCH, (b + 1) * BATCH)
        ve = eager_bin(preds[sl], target[sl])
        before = tie_scan.tie_group_reduce.launches
        vc = compiled_bin(preds[sl], target[sl])
        if tie_scan.tie_group_reduce.launches != before + 1:
            raise AssertionError("binary step: AUROC's batch value did not launch the tie scan once")
        for k in ve:
            if not torch.equal(vc[k], ve[k]):
                raise AssertionError(f"binary step {b}: compiled {k} {vc[k].item()} != eager {ve[k].item()}")
    fallbacks = compiled_bin.eager_fallbacks
    if set(fallbacks) != {"AUROC"} or "does not opt into fused one-update forward" not in fallbacks["AUROC"]:
        raise AssertionError(f"binary step: eager fallbacks {fallbacks}; want AUROC alone, by its forward")
    before = tie_scan.tie_group_reduce.launches
    got = compiled_bin.compute()
    bin_launches = tie_scan.tie_group_reduce.launches - before
    want = eager_bin.compute()
    if bin_launches != 1 or any(not torch.equal(got[k], want[k]) for k in want):
        raise AssertionError(f"binary step: compute {got} vs eager {want}, {bin_launches} tie-scan launches")
    out["binary_step"] = {"eager_fallbacks": fallbacks, "compute_tie_scan_launches": bin_launches,
                          "forward_batch_ms_compiled": _host_ms(torch, lambda: compiled_bin(preds[:BATCH], target[:BATCH])),
                          "forward_batch_ms_eager": _host_ms(torch, lambda: eager_bin(preds[:BATCH], target[:BATCH]))}
    print(f"4h. binary step: Accuracy captured, {fallbacks}; values equal eager; one tie-scan launch per compute;"
          f" forward batch {out['binary_step']['forward_batch_ms_compiled']:.3f} ms compiled vs"
          f" {out['binary_step']['forward_batch_ms_eager']:.3f} ms eager")

    # e. a demotion on the card: StatScores() cannot infer the one-hot width
    # of label inputs inside a graph; Accuracy stays captured
    labels = [(t4[b * BATCH:(b + 1) * BATCH], t4[(b + 1) * BATCH:(b + 2) * BATCH].flip(0)) for b in range(3)]
    eager_dem = MetricCollection([Accuracy(), StatScores()])
    compiled_dem = MetricCollection([Accuracy(), StatScores()], compiled=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the engine's own fall-back warning
        for batch in labels:
            ve, vc = eager_dem(*batch), compiled_dem(*batch)
            for k in ve:
                if not torch.equal(vc[k], ve[k]):
                    raise AssertionError(f"demotion: compiled {k} {vc[k].tolist()} != eager {ve[k].tolist()}")
    torch.cuda.synchronize()  # no CUDA error was left behind
    reasons = compiled_dem.eager_fallbacks
    if set(reasons) != {"StatScores"} or "`num_classes` is required" not in reasons["StatScores"]:
        raise AssertionError(f"demotion: eager fallbacks {reasons}; want StatScores alone, by num_classes")
    step = compiled_dem(*labels[0])
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(v.float()).all()) for v in step.values()):
        raise AssertionError("demotion: the step after it is not finite")
    out["demotion"] = reasons
    print(f"4h. demotion: {reasons}; Accuracy captured, the card usable after it")

    # f. the wrapper and the extras
    boot_syncs = {}
    p1, t1 = cls_batches[0]
    plain = Accuracy()(p1, t1).item()
    for strategy in ("multinomial", "poisson"):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        boot = BootStrapper(Accuracy(), num_bootstraps=20, sampling_strategy=strategy, generator=gen, raw=True)
        boot.update(p1, t1)
        sampler = _syncs(torch, lambda: boot_module._bootstrap_sampler(BATCH, strategy, 20, gen, dev))
        update = _syncs(torch, lambda: boot.update(p1, t1))
        values = boot.compute()
        if len(sampler) != (0 if strategy == "multinomial" else 1):
            raise AssertionError(f"BootStrapper {strategy}: the sampler synchronized at {sampler}")
        if not abs(values["mean"].item() - plain) < 0.01 or values["raw"].shape != (20,):
            raise AssertionError(f"BootStrapper {strategy}: mean {values['mean'].item()} vs accuracy {plain}")
        boot_syncs[strategy] = {"sampler_syncs": len(sampler), "update_syncs": len(update),
                                "mean": values["mean"].item(), "std": values["std"].item()}
    rng = np.random.default_rng(SEED + 7)
    emb = torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32)).to(dev)
    flags = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    emb_err = 0.0
    try:
        for similarity in ("cosine", "dot"):
            for reduction in ("none", "sum", "mean"):
                got = embedding_similarity(emb, similarity, reduction).double()
                want = embedding_similarity(emb.double(), similarity, reduction)
                # relative to the output's largest entry: a TF32 product reads ~1e-3 off
                emb_err = max(emb_err, float((got - want).abs().max() / want.abs().max()))
        if torch.get_float32_matmul_precision() != "high" or torch.backends.cudnn.allow_tf32 is not True:
            raise AssertionError("embedding_similarity did not restore the caller's TF32 flags")
    finally:
        torch.set_float32_matmul_precision(flags[0])
        torch.backends.cudnn.allow_tf32 = flags[1]
    if not emb_err <= EMB_TOL:
        raise AssertionError(f"embedding_similarity under TF32 flags off float64 by {emb_err}")
    img_np = rng.standard_normal((FRAMES, 3, CITY_H, CITY_W), dtype=np.float32)
    dy, dx = image_gradients(torch.from_numpy(img_np).to(dev))
    want_dy = np.zeros_like(img_np)
    want_dy[..., :-1, :] = img_np[..., 1:, :] - img_np[..., :-1, :]
    want_dx = np.zeros_like(img_np)
    want_dx[..., :, :-1] = img_np[..., :, 1:] - img_np[..., :, :-1]
    if not (np.array_equal(dy.cpu().numpy(), want_dy) and np.array_equal(dx.cpu().numpy(), want_dx)):
        raise AssertionError("image_gradients differ from numpy's")
    frame = torch.from_numpy(img_np[:1]).to(dev)
    gradients_ms = _host_ms(torch, lambda: image_gradients(frame))
    translations = ["the cat is on the mat".split(), "there is a cat on the mat today".split()]
    references = [["there is a cat on the mat".split(), "a cat is on the mat".split()],
                  ["the cat is on the mat".split()]]
    bleu = {s: (bleu_score(translations, references, smooth=s).item(),
                bleu_score(translations, references, smooth=s, device="cpu").item()) for s in (False, True)}
    if any(a != b for a, b in bleu.values()):
        raise AssertionError(f"bleu_score on the card {bleu} differs from the CPU's")
    out["extras"] = {"bootstrapper_20": boot_syncs, "embedding_similarity_512x256_max_rel_err_tf32_on": emb_err,
                     "image_gradients_1x3x1024x2048_ms": gradients_ms, "bleu": bleu}
    print(f"4h. BootStrapper(Accuracy(), 20) host syncs {boot_syncs}; embedding_similarity (512, 256) under TF32"
          f" flags within {emb_err:.3g} of float64, flags restored; image_gradients at {FRAMES}x3x{CITY_H}x{CITY_W}"
          f" equal numpy; bleu_score on the card = CPU {bleu}")
    return out, {"forward_leg": (compiled_leg, cls_batches[1]), "regression_leg": (compiled_reg, reg_batches[1])}


def _cohort_replay_ops(torch, cohort):
    """(kernels, copies and fills) of one replay of the cohort's CUDA graph
    (its only program)."""
    (program,) = cohort._engine._compiled.values()
    return _device_ops(torch, program.graph.replay)


def _cohort_phase(torch, dev):
    """Phase 4i: the multi-tenant cohort (``MetricCohort``) on the card.
    Returns the phase's timings."""
    from metrics_tpu_torch import (
        AUROC,
        F1,
        PSNR,
        Accuracy,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        MetricCohort,
        MetricCollection,
        Precision,
        R2Score,
        Recall,
    )
    from metrics_tpu_torch.cohort import route_rows

    def template(compiled=False):
        return MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                                 Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")],
                                compiled=compiled)

    def regression(compiled=False):
        return MetricCollection([MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()],
                                compiled=compiled)

    def bench_rows(n, seed=SEED):
        """The JAX bench's rows (``bench.py:578-582``): probabilities over 4
        classes and labels, ``(n, 64, 4)`` and ``(n, 64)``."""
        rs = np.random.RandomState(seed)
        probs = rs.rand(n, COHORT_ROWS, 4).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        return torch.from_numpy(probs).to(dev), torch.from_numpy(rs.randint(4, size=(n, COHORT_ROWS))).to(dev)

    def grid_rows(n, seed):
        """Grid-valued rows (``tests/bases/test_cohort.py:46-66``): integer
        multinomials / 256 that sum to exactly 1, so every float sum is
        exact in any order."""
        rs = np.random.RandomState(seed)
        probs = (rs.multinomial(256, [0.25] * 4, size=(n, COHORT_ROWS)) / 256.0).astype(np.float32)
        return torch.from_numpy(probs).to(dev), torch.from_numpy(rs.randint(4, size=(n, COHORT_ROWS))).to(dev)

    out = {"sizes": {}}
    # a. the bench's sizes
    for n in COHORT_SIZES:
        cohort = MetricCohort(template(), tenants=n)
        p, t = bench_rows(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values = cohort(p, t)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        if any(v.shape != (n,) or not bool(torch.isfinite(v).all()) for v in values.values()):
            raise AssertionError(f"cohort of {n}: step values {[(k, tuple(v.shape)) for k, v in values.items()]}")
        sites = _syncs(torch, lambda: cohort(p, t))
        if sites:
            raise AssertionError(f"cohort of {n}: a replayed step synchronized the host at {sites}")
        kernels, copies = _cohort_replay_ops(torch, cohort)
        step_kernels, step_copies = _device_ops(torch, lambda: cohort(p, t))
        info = cohort.cache_info()
        if info["trace_count"] != 1 or info["eager_fallbacks"]:
            raise AssertionError(f"cohort of {n}: {info}")
        res = {
            "capacity": cohort.capacity,
            "step_ms": _host_ms(torch, lambda: cohort(p, t)),
            "replay_device_ms": _queued_ms(torch, lambda: cohort(p, t), launches=20),
            "kernels_per_replay": kernels,
            "copies_per_replay": copies,
            "kernels_per_step": step_kernels,
            "copies_per_step": step_copies,
            "first_step_ms": first_ms,
            "warm_up_and_capture_ms": info["graph_build_ms"][0],
            "graph_pool_bytes": info["graph_pool_bytes"],
            "syncs_per_replayed_step": len(sites),
        }
        out["sizes"][n] = res
        print(f"4i. cohort of {n} (capacity {cohort.capacity}): step {res['step_ms']:.3f} ms"
              f" ({res['replay_device_ms']:.3f} ms of device time), {kernels} kernels and {copies} copies a replay"
              f" ({step_kernels} and {step_copies} a step), first step {first_ms:.1f} ms (warm-up + capture"
              f" {res['warm_up_and_capture_ms']:.1f} ms), graph pool {res['graph_pool_bytes'] / 2**20:.1f} MiB,"
              " 0 syncs a replayed step")
        del cohort
    replay_kernels = {n: out["sizes"][n]["kernels_per_replay"] for n in COHORT_SIZES[1:]}
    if len(set(replay_kernels.values())) != 1:
        raise AssertionError(f"kernels per replay grow with the tenants: {replay_kernels}")

    # b. the displaced baseline: 64 compiled collections stepped one after another on the same rows
    p, t = bench_rows(COHORT_SEQ)
    cols = [template(compiled=True) for _ in range(COHORT_SEQ)]

    def seq_step():
        for i, col in enumerate(cols):
            col(p[i], t[i])

    seq_step()
    out["seq64_ms"] = _host_ms(torch, seq_step)
    out["speedup_64"] = out["seq64_ms"] / out["sizes"][COHORT_SEQ]["step_ms"]
    big, one = COHORT_SIZES[-1], COHORT_SIZES[0]
    out["sublinearity_10k"] = out["sizes"][big]["step_ms"] / (big * out["sizes"][one]["step_ms"])
    print(f"4i. {COHORT_SEQ} compiled collections one after another: {out['seq64_ms']:.3f} ms a step;"
          f" cohort speedup at {COHORT_SEQ} tenants {out['speedup_64']:.2f}x;"
          f" t_{big} / ({big} x t_{one}) = {out['sublinearity_10k']:.5f}")
    del cols

    # c. tenants equal to their collections run alone, through membership changes and a grow
    n = COHORT_CHECK
    rs = np.random.RandomState(SEED + 11)
    cohort = MetricCohort(template(), tenants=n, track_health=True)
    sampled = sorted(rs.choice(n, COHORT_SAMPLED - 1, replace=False).tolist())
    removed = sampled[0]
    alone = {s: template(compiled=True) for s in sampled}
    rows_seen = np.zeros(2 * n, np.int64)
    updates = np.zeros(2 * n, np.int64)

    def step(tenants, seed):
        p, t = grid_rows(tenants, seed)
        cohort(p, t)
        for s, col in alone.items():
            col(p[s], t[s])
        rows_seen[:tenants] += COHORT_ROWS
        updates[:tenants] += 1

    step(n, 1)
    cohort.remove_tenant(removed)
    if cohort.add_tenant() != removed:
        raise AssertionError("cohort: a freed slot was not reused")
    alone[removed] = template(compiled=True)
    rows_seen[removed] = updates[removed] = 0
    step(n, 2)
    grown = cohort.add_tenant()
    if grown != n or cohort.capacity != 2 * n:
        raise AssertionError(f"cohort: tenant {grown} at capacity {cohort.capacity}; want {n} at {2 * n}")
    alone[grown] = template(compiled=True)
    step(n + 1, 3)
    computed = cohort.compute()
    for s, col in alone.items():
        want = col.compute()
        for key, m in col.items():
            for sname in m._defaults:
                if not torch.equal(cohort._states[key][sname][s], getattr(m, sname)):
                    raise AssertionError(f"cohort tenant {s}: state {key}.{sname} differs from the collection's")
            if not torch.equal(computed[key][s], want[key]):
                raise AssertionError(f"cohort tenant {s}: {key} {computed[key][s].item()} vs {want[key].item()}")
    health = cohort.health()
    live = np.asarray(health["tenants"])
    if not (np.array_equal(health["rows_seen"], rows_seen[live]) and np.array_equal(health["updates"], updates[live])):
        raise AssertionError("cohort health: rows seen / updates differ from numpy's counts")
    out["tenants_equal_alone"] = {"sampled": len(alone), "tenants": len(cohort), "capacity": cohort.capacity,
                                  "builds": cohort.cache_info()["trace_count"]}
    print(f"4i. cohort of {n} -> {len(cohort)} tenants (capacity {cohort.capacity}), a slot freed and reused:"
          f" {len(alone)} sampled tenants' states and compute() bit-equal to compiled collections run alone;"
          " health rows / updates equal numpy's")
    del cohort, alone

    # d. the regression pack as a cohort
    cohort = MetricCohort(regression(), tenants=n)
    alone = {s: regression(compiled=True)
             for s in np.random.RandomState(SEED + 12).choice(n, COHORT_SAMPLED, replace=False).tolist()}
    worst_ulps = 0.0
    for seed in range(3):
        rs = np.random.RandomState(SEED + 20 + seed)
        p, t = (torch.from_numpy((rs.randint(0, 256, (n, COHORT_ROWS)) / 256.0).astype(np.float32)).to(dev)
                for _ in range(2))
        cohort(p, t)
        for s, col in alone.items():
            col(p[s], t[s])
    computed = cohort.compute()
    for s, col in alone.items():
        want = col.compute()
        for key, m in col.items():
            for sname in m._defaults:
                if not torch.equal(cohort._states[key][sname][s], getattr(m, sname)):
                    raise AssertionError(f"regression cohort tenant {s}: state {key}.{sname} differs")
            got, ref = np.float32(computed[key][s].item()), np.float32(want[key].item())
            ulps = abs(float(got) - float(ref)) / float(np.spacing(max(abs(got), abs(ref))))
            if not np.isfinite(got) or not ulps <= COHORT_ULPS:
                raise AssertionError(f"regression cohort tenant {s}: {key} {got} vs {ref}")
            worst_ulps = max(worst_ulps, ulps)
    out["regression_cohort_worst_ulps"] = worst_ulps
    print(f"4i. regression pack as a cohort of {n}: {len(alone)} sampled tenants' states bit-equal, values within"
          f" {worst_ulps:.2f} ulp of compiled collections run alone")
    del cohort, alone

    # e. route_rows of a shuffled tagged stream
    big = COHORT_SIZES[-1]
    rs = np.random.RandomState(SEED + 30)
    dense_p, dense_t = bench_rows(big, SEED + 31)
    ids = np.repeat(np.arange(big), COHORT_ROWS)[rs.permutation(big * COHORT_ROWS)]
    rank = np.empty_like(ids)
    rank[np.argsort(ids, kind="stable")] = np.arange(ids.size) % COHORT_ROWS  # each row's place in its tenant
    ids_t, rank_t = torch.from_numpy(ids).to(dev), torch.from_numpy(rank).to(dev)
    routed_p, routed_t = route_rows(ids_t, dense_p[ids_t, rank_t], dense_t[ids_t, rank_t], num_tenants=big)
    if not (torch.equal(routed_p, dense_p) and torch.equal(routed_t, dense_t)):
        raise AssertionError("route_rows: the routed stream differs from the dense layout")
    out["route_rows_ms"] = _host_ms(torch, lambda: route_rows(ids_t, dense_p[ids_t, rank_t], dense_t[ids_t, rank_t],
                                                              num_tenants=big))
    print(f"4i. route_rows of a shuffled {big} x {COHORT_ROWS} tagged stream equals the dense layout"
          f" ({out['route_rows_ms']:.3f} ms with its count check)")

    # f. an ineligible member
    try:
        MetricCohort(MetricCollection([AUROC(pos_label=1)]), tenants=2)
    except ValueError as err:
        if "engine-eligible" not in str(err) or "does not opt into fused one-update forward" not in str(err):
            raise
        out["auroc_refused"] = str(err)
    else:
        raise AssertionError("a cohort of AUROC was accepted")
    print(f"4i. a cohort of AUROC is refused: {out['auroc_refused']}")
    return out


def _range_kernels(torch, prof, name):
    """``[(kernel name, device ms)]`` of the device events inside the
    device-side span of every ``torch.profiler`` range called ``name``: the
    kernels launched in the range, through ATen, a ctypes entry or a graph
    replay alike."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for span in events if span.name == name
            for e in events
            if not e.name.startswith(RANGE_PREFIXES)
            and span.time_range.start <= e.time_range.start and e.time_range.end <= span.time_range.end]


def _observability_phase(torch, dev, binary):
    """Phase 4j: the observability core (telemetry, span tracing, the
    watchdog, the flight recorder) on the card. ``binary`` is phase 3's
    ``(preds, target)``. Returns the phase's timings; every recorder is off
    again when it returns."""
    import tempfile

    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch import (
        AUROC,
        F1,
        Accuracy,
        MeanSquaredError,
        MetricCohort,
        MetricCollection,
        Precision,
        Recall,
    )

    out = {}
    preds, target = binary
    ns_batches = [(preds[b * BATCH:(b + 1) * BATCH], target[b * BATCH:(b + 1) * BATCH]) for b in range(BATCHES)]
    _, _, p4, t4 = _forward_leg_inputs(torch, dev)
    leg_batches = [(p4[b * BATCH:(b + 1) * BATCH], t4[b * BATCH:(b + 1) * BATCH]) for b in range(BATCHES)]
    rs = np.random.RandomState(SEED + 40)
    probs = rs.rand(OBS_TENANTS, COHORT_ROWS, 4).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    rows = (torch.from_numpy(probs).to(dev), torch.from_numpy(rs.randint(4, size=(OBS_TENANTS, COHORT_ROWS))).to(dev))

    def forward_leg(compiled):
        return MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                                 Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")],
                                compiled=compiled)

    flight_dir = tempfile.TemporaryDirectory(dir="build")

    def recorders(on):
        if on:
            obs.enable()
            obs.enable_tracing()
            if not obs.flight_enabled():
                obs.enable_flight(flight_dir.name)
        else:
            obs.disable()
            obs.disable_tracing()
            obs.disable_flight()

    def states_of(obj):
        if isinstance(obj, MetricCohort):
            return {(n, s): v for n, d in obj._states.items() for s, v in d.items()}
        return {(k, s): torch.cat(v) if isinstance(v, list) else v
                for k in obj.keys() for s in obj[k]._defaults for v in (getattr(obj[k], s),)}

    def bit_equal(label, a, b):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"4j. {label}: {k} differs with the recorders on")

    def toggled_ms(fn):
        """Host clock ending in a synchronize, the recorders off and on in
        turns (the order flipping each pair, one warm pair first): the
        medians off and on of the first 5 pairs, and the median of all
        pairs' differences (drift between pairs cancels in a difference)."""
        times = {False: [], True: []}
        for i in range(OBS_PAIRS + 1):
            for on in (False, True) if i % 2 else (True, False):
                recorders(on)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i:
                    times[on].append((time.perf_counter() - t0) * 1e3)
        recorders(False)
        return {"off_ms": float(np.median(times[False][:5])), "on_ms": float(np.median(times[True][:5])),
                "paired_overhead_ms": float(np.median(np.subtract(times[True], times[False])))}

    workloads = {}
    try:
        # a. three workloads, every recorder off and then on: the same bits
        for on in (False, True):
            recorders(on)
            if on:
                obs.get().reset()
                obs.get_tracer().reset()
            ns = MetricCollection([Accuracy(), AUROC(pos_label=1)])
            leg = forward_leg(True)
            cohort = MetricCohort(forward_leg(False), tenants=OBS_TENANTS, track_health=False)
            values = {}
            for b, batch in enumerate(ns_batches):
                values.update({("north-star", b, k): v for k, v in ns(*batch).items()})
            values.update({("north-star", "epoch", k): v for k, v in ns.compute().items()})
            for b, batch in enumerate(leg_batches):
                values.update({("leg", b, k): v for k, v in leg(*batch).items()})
            values.update({("leg", "epoch", k): v for k, v in leg.compute().items()})
            for b in range(3):
                values.update({("cohort", b, k): v for k, v in cohort(*rows).items()})
            values.update({("cohort", "epoch", k): v for k, v in cohort.compute().items()})
            # the states before the measuring steps (each profiled count
            # steps its workload two to eight times)
            states = {("ns",) + k: v for k, v in states_of(ns).items()}
            states.update({("leg",) + k: v for k, v in states_of(leg).items()})
            states.update({("cohort",) + k: v for k, v in states_of(cohort).items()})
            sites = _syncs(torch, lambda: (leg(*leg_batches[1]), cohort(*rows)))
            if on and sites:
                raise AssertionError(f"4j. a replayed step synchronized the host with every recorder on at {sites}")
            profiled = {"leg": 0, "cohort": 0}

            def measured(key, step):
                def run():
                    profiled[key] += 1
                    step()
                return run

            ops = {"leg": _device_ops(torch, measured("leg", lambda: leg(*leg_batches[1]))),
                   "cohort": _device_ops(torch, measured("cohort", lambda: cohort(*rows)))}
            workloads[on] = {"values": values, "states": states, "syncs": len(sites), "ops": ops,
                             "objects": (ns, leg, cohort), "profiled": profiled}
            if on:
                spans = list(obs.get_tracer().spans)
                perfetto = obs.get_tracer().to_perfetto()
                counters = dict(obs.get().counters)
        recorders(False)
        off, on = workloads[False], workloads[True]
        bit_equal("values", off["values"], on["values"])
        bit_equal("states", off["states"], on["states"])
        if off["ops"] != on["ops"]:
            raise AssertionError(f"4j. kernels per replayed step: {off['ops']} off, {on['ops']} on")
        # the leg's batches, the cohort's 3 steps, one step each under the sync
        # count and one each per profiler trace
        profiled = on["profiled"]
        if (counters["engine.dispatches"] != BATCHES + 3 + 2 + profiled["leg"] + profiled["cohort"]
                or counters["cohort.dispatch_tenants"] != (4 + profiled["cohort"]) * OBS_TENANTS):
            raise AssertionError(f"4j. dispatch counters {counters}")
        ns, leg, cohort = off["objects"]
        ns_on, leg_on, cohort_on = on["objects"]
        auroc = ns["AUROC"]

        def ns_compute(m):
            m._computed = None
            return m.compute()

        timing = {
            "north_star_forward_ms": toggled_ms(lambda: ns(*ns_batches[0])),
            "north_star_compute_ms": toggled_ms(lambda: ns_compute(auroc)),
            "forward_leg_ms": toggled_ms(lambda: leg(*leg_batches[1])),
            "cohort_step_ms": toggled_ms(lambda: cohort(*rows)),
        }
        out["ms_off_on"] = timing
        out["syncs_per_replayed_step_on"] = on["syncs"]
        out["kernels_copies_per_step_off_on"] = {k: [off["ops"][k], on["ops"][k]] for k in off["ops"]}
        print(f"4j. north-star step, compiled forward leg and {OBS_TENANTS}-tenant cohort: values and states"
              " bit-equal with telemetry, tracing and the flight recorder on and off; 0 syncs a replayed step with"
              f" them on; kernels (copies) a step off/on {out['kernels_copies_per_step_off_on']}")
        print("4j. ms off / on (host clock ending in a synchronize, median of 5, in turns), and the median paired"
              f" difference of {OBS_PAIRS} pairs: " + ", ".join(
                  f"{k} {v['off_ms']:.3f} / {v['on_ms']:.3f} ({v['paired_overhead_ms']:+.3f})" for k, v in timing.items()))

        # d. the span recording of (a): its phases, and a Perfetto export that round-trips
        per_phase = {}
        for span in spans:
            per_phase[span["phase"]] = per_phase.get(span["phase"], 0) + 1
        missing = {"canonicalize", "update", "compute", "dispatch"} - set(per_phase)
        if missing:
            raise AssertionError(f"4j. the span recording lacks the phases {missing}: {per_phase}")
        if json.loads(json.dumps(perfetto)) != perfetto or perfetto["traceEvents"][0]["args"]["name"] != (
                "metrics_tpu rank 0/1"):
            raise AssertionError("4j. to_perfetto() does not round-trip through json")
        out["spans_per_phase"] = per_phase
        print(f"4j. spans per phase: {per_phase}; to_perfetto() round-trips ({len(perfetto['traceEvents'])} events)")

        # b. the engine counters are the signature arithmetic; the watchdog
        # reads 0 at steady state and fires once on a shape-polymorphic loop
        obs.get().reset()
        with obs.telemetry_scope() as tel:
            col = MetricCollection([MeanSquaredError()], compiled=True)
            a, b = torch.rand(64, device=dev), torch.rand(96, device=dev)
            for x in (a, a, b, b, a) + (a,) * 8:
                col(x, x)
            c = tel.counters
            arithmetic = (c["engine.cache_misses"], c["engine.cache_hits"], c["engine.dispatches"],
                          c["metric.MeanSquaredError.update_calls"], col._engine.trace_count)
            if arithmetic != (2, 11, 13, 2, 2) or tel.watchdog.retrace_count():
                raise AssertionError(f"4j. engine counters (misses, hits, dispatches, update calls, builds)"
                                     f" {arithmetic}, retraces {tel.watchdog.retrace_count()}")
            tel.reset()
            obs.enable_flight(flight_dir.name)
            col._engine._cache_size = 4  # the build budget max(8, cache_size) is 8
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for n in range(4, 4 + 2 * OBS_SHAPES, 2):
                    x = torch.rand(n, device=dev)
                    col(x, x)
            fired = [str(w.message) for w in caught if "recompilation watchdog" in str(w.message)]
            verdicts = [e for e in tel.events if e["kind"] == "retrace"]
            dumps = obs.get_flight().dump_paths
            obs.disable_flight()
        if len(fired) != 1 or len(verdicts) != 1 or len(dumps) != 1:
            raise AssertionError(f"4j. {OBS_SHAPES}-shape loop: {len(verdicts)} verdicts, {len(fired)} warnings,"
                                 f" {len(dumps)} dumps")
        with open(dumps[0]) as f:
            dump = json.load(f)
        if (dump["format"], dump["reason"], dump["identity"]["rank"], dump["identity"]["world_size"]) != (
                "metrics_tpu.flight_dump", "watchdog_retrace", 0, 1):
            raise AssertionError(f"4j. the flight dump: {dump['format']}, {dump['reason']}, {dump['identity']}")
        out["polymorphic_loop"] = {"verdicts": 1, "warnings": 1, "dumps": 1, "dump_events": len(dump["events"]),
                                   "verdict": verdicts[0]["reason"]}
        print("4j. engine counters = signature arithmetic (2 misses, 11 hits, 13 dispatches, 2 update calls ="
              f" 2 builds), 0 retraces at steady state; the {OBS_SHAPES}-shape loop: 1 verdict, 1 warning, 1 flight"
              f" dump ({len(dump['events'])} events, identity rank 0/1): {verdicts[0]['reason']}")

        # c. attribution under torch.profiler with telemetry on
        obs.enable()
        try:
            prof = _steady_profile(torch, lambda: ns_compute(ns_on["AUROC"]), shows="tie_scan")
            inside = _range_kernels(torch, prof, "metrics_tpu.AUROC.compute")
            names = [k for k, _ in inside]
            if not any("tie_scan" in k for k in names) or not any("RadixSort" in k for k in names):
                raise AssertionError(f"4j. the tie_scan kernel or the co-sort fell outside"
                                     f" metrics_tpu.AUROC.compute: {names}")
            # a compiled step: the copies in and the clones out run outside
            # the replay, every kernel inside it
            prof = _steady_profile(torch, lambda: leg_on(*leg_batches[1]))
            step_kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                            and not e.name.startswith(RANGE_PREFIXES) and not _is_copy(e.name)]
            replay = _range_kernels(torch, prof, leg_on._engine._watch_key)
            replay_kernels = [k for k, _ in replay if not _is_copy(k)]
            if sorted(replay_kernels) != sorted(step_kernels) or not step_kernels:
                raise AssertionError(f"4j. {len(replay_kernels)} kernels inside {leg_on._engine._watch_key},"
                                     f" the step runs {len(step_kernels)}")
        finally:
            obs.disable()
        out["attribution"] = {
            "metrics_tpu.AUROC.compute": {"kernels": sum(not _is_copy(k) for k in names),
                                          "device_events": len(inside), "device_ms": sum(ms for _, ms in inside),
                                          "tie_scan_ms": sum(ms for k, ms in inside if "tie_scan" in k),
                                          "sort_ms": sum(ms for k, ms in inside if "RadixSort" in k)},
            leg_on._engine._watch_key: {"kernels": len(replay_kernels), "device_events": len(replay),
                                        "device_ms": sum(ms for _, ms in replay)},
        }
        print("4j. attribution: " + "; ".join(f"{k}: {v['kernels']} kernels, {v['device_ms']:.4f} ms of device time"
                                              for k, v in out["attribution"].items())
              + " (the tie_scan kernel and the co-sort inside the AUROC range, every kernel of a compiled step"
                " inside the engine's)")
    finally:
        recorders(False)
        flight_dir.cleanup()
    return out


def _sync_tier_phase(torch, dev, mc, binary):
    """Phase 4k: the sync tiers on the card. ``mc`` is phase 4's
    ImageNet-shaped ``(preds, target)``, ``binary`` phase 3's ``(preds,
    target)``. Returns the phase's timings; leaves no backend or policy
    installed."""
    from metrics_tpu_torch import AUROC, Accuracy, BinnedAUROC, ConfusionMatrix, MetricCollection
    from metrics_tpu_torch import reliability
    from metrics_tpu_torch.observability import telemetry as tel_mod
    from metrics_tpu_torch.ops import tie_scan
    from metrics_tpu_torch.parallel import quantize as q
    from metrics_tpu_torch.parallel.backend import set_sync_backend
    from metrics_tpu_torch.reliability import faultinject as fi
    from metrics_tpu_torch.utilities.distributed import gather_all_tensors

    mc_preds, mc_target = mc
    out = {}

    def filled(name, precision="exact"):
        if name == "binned":
            m = BinnedAUROC(num_bins=NUM_BINS, num_classes=IMAGENET_C)
        else:
            m = ConfusionMatrix(num_classes=IMAGENET_C)
        if precision != "exact":
            m.set_sync_precision(precision)
        m.update(mc_preds, mc_target)
        m.dist_sync_fn = gather_all_tensors
        return m

    base = {name: filled(name) for name in ("binned", "confmat")}
    states = {"hist_pos": base["binned"].hist_pos, "hist_neg": base["binned"].hist_neg,
              "confmat": base["confmat"].confmat}
    torch.cuda.synchronize()

    # a. the codec at full width: the card's bits against the CPU's, no host
    # synchronization, device ms beside the byte bound
    codec = {}
    for sname, x in states.items():
        r = torch.zeros(x.shape, dtype=torch.float32, device=dev)
        x_cpu, r_cpu = x.cpu(), r.cpu()
        for precision in ("int8", "bf16"):
            pay, res = q.compensate_and_quantize(x, r, precision)
            pay_cpu, res_cpu = q.compensate_and_quantize(x_cpu, r_cpu, precision)
            for k in pay:
                if not torch.equal(pay[k].cpu(), pay_cpu[k]):
                    raise AssertionError(f"4k. {sname} {precision}: the card's {k} differ from the CPU's")
            if not torch.equal(res.cpu(), res_cpu):
                raise AssertionError(f"4k. {sname} {precision}: the card's residual differs from the CPU's")
            merged = q.merge_dequantized([pay] * 8, x.shape, x.dtype)
            if not torch.equal(merged.cpu(), q.merge_dequantized([pay_cpu] * 8, x.shape, x.dtype)):
                raise AssertionError(f"4k. {sname} {precision}: the card's merge differs from the CPU's")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                q.compensate_and_quantize(x, r, precision)
                q.merge_dequantized([pay] * 8, x.shape, x.dtype)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            n = x.numel()
            wire = q.payload_wire_nbytes(pay)
            quant_ms = _queued_ms(torch, lambda: q.compensate_and_quantize(x, r, precision), launches=20)
            merge_ms = _queued_ms(torch, lambda: q.merge_dequantized([pay] * 8, x.shape, x.dtype), launches=20)
            # bytes the codec must move: the state and the residual read, the
            # payload and the new residual written; the merge reads 8 payloads
            # and writes the state once
            quant_bytes = n * x.element_size() + 4 * n + wire + 4 * n
            merge_bytes = 8 * wire + n * x.element_size()
            codec[f"{sname}/{precision}"] = {
                "elements": n, "state_bytes": n * x.element_size(), "wire_bytes": wire,
                "quantize_ms": quant_ms, "quantize_bound_ms": quant_bytes / HBM_BYTES_PER_S * 1e3,
                "merge8_ms": merge_ms, "merge8_bound_ms": merge_bytes / HBM_BYTES_PER_S * 1e3,
            }
    out["codec"] = codec
    print(f"4k a. codec at {IMAGENET_C}x{NUM_BINS} (x2) and {IMAGENET_C}x{IMAGENET_C}: the card's codes, scales,"
          f" bf16 payloads, residuals and 8-way merges equal the CPU's, 0 host syncs; "
          + ", ".join(f"{k} {v['quantize_ms']:.4f} ms (bound {v['quantize_bound_ms']:.4f})" for k, v in codec.items()))

    # b. the metrics at each tier, flat over an 8-rank mirror world and
    # two-level under simulated_pods(2, 4): healthy results 8x local
    def locals_of(m):
        return {s: getattr(m, s).clone() for s in m._reductions if not s.endswith("__qres")}

    def check_tier(label, m, local, precision):
        for s, v in local.items():
            got = getattr(m, s)
            want = v * 8
            if precision == "exact":
                if not torch.equal(got, want):
                    raise AssertionError(f"4k. {label}: {s} is not exactly 8x local")
                continue
            # int8: per element within 2 slice partials' absmax/254 (level 1
            # quantizes two 4x partials); bf16: within 2^-8 of each partial
            part = 4 * v.to(torch.float64)
            if precision == "int8":
                blocks = torch.nn.functional.pad(part.abs().reshape(-1), (0, (-part.numel()) % 128))
                bound = (blocks.reshape(-1, 128).amax(1) / 254.0).repeat_interleave(128)[: part.numel()]
                bound = 2 * bound.reshape(part.shape) + 1.0  # integer states re-round: one count
            else:
                bound = 2 * part.abs() * 2.0 ** -8 + 1.0
            err = (got.to(torch.float64) - want.to(torch.float64)).abs()
            if bool((err > bound).any()):
                raise AssertionError(f"4k. {label}: {s} off 8x local past the {precision} bound")

    tiers = {}
    for precision in ("exact", "bf16", "int8"):
        for layout in ("flat", "two_level"):
            for name in ("binned", "confmat"):
                m = filled(name, precision)
                local = locals_of(m)
                prev = set_sync_backend(fi._MirrorBackend(8) if layout == "flat" else None)
                try:
                    pods = fi.simulated_pods(2, 4) if layout == "two_level" else contextlib.nullcontext()
                    with pods:
                        tel_mod.get().reset()
                        with tel_mod.telemetry_scope() as tel:
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            m._sync_dist()
                            torch.cuda.synchronize()
                            first_ms = (time.perf_counter() - t0) * 1e3
                        counters = {k: v for k, v in tel.counters.items() if k.startswith("sync.")}
                        check_tier(f"{name} {layout} {precision}", m, local, precision)
                        times = []
                        for _ in range(5):
                            m2 = filled(name, precision)
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            m2._sync_dist()
                            torch.cuda.synchronize()
                            times.append((time.perf_counter() - t0) * 1e3)
                finally:
                    set_sync_backend(prev)
                wire = counters["sync.wire_bytes"]
                ratio = counters["sync.payload_bytes"] / wire
                level1_ratio = (counters["sync.payload_bytes"] / counters["sync.level1.wire_bytes"]
                                if layout == "two_level" else None)
                quant_ratio = ratio if layout == "flat" else level1_ratio
                floor = {"bf16": 2.0, "int8": 3.0}.get(precision)
                if precision == "exact" and layout == "flat" and ratio != 1.0:
                    raise AssertionError(f"4k. {name} flat exact: wire bytes differ from the payload: {counters}")
                if precision == "exact" and layout == "two_level" and level1_ratio != 1.0:
                    # int32 states sum to int32 slice partials, as in JAX
                    raise AssertionError(f"4k. {name} two-level exact: level-1 bytes differ from the payload: {counters}")
                if precision != "exact" and quant_ratio < floor:
                    raise AssertionError(f"4k. {name} {layout} {precision}: payload/wire {quant_ratio} < {floor}")
                residuals = [getattr(m, r) for r in m._sync_residual_names()]
                # int8 is lossy on these states (bf16 holds counts up to 256 exactly)
                if precision == "int8" and not any(bool(r.abs().max() > 0) for r in residuals):
                    raise AssertionError(f"4k. {name} {layout} {precision}: no residual was committed")
                tiers[f"{name}/{layout}/{precision}"] = {
                    "sync_ms": float(np.median(times)), "first_sync_ms": first_ms, "counters": counters,
                    "payload_over_wire": ratio, "payload_over_level1_wire": level1_ratio,
                }
    out["tiers"] = tiers
    print("4k b. under an 8-rank mirror world (flat) and simulated_pods(2, 4): exact exactly 8x local, bf16 and"
          " int8 within their bounds; payload/wire "
          + ", ".join(f"{k} {v['payload_over_wire']:.3f}" + (f" (level 1 {v['payload_over_level1_wire']:.3f})"
                                                            if v["payload_over_level1_wire"] else "")
                      for k, v in tiers.items())
          + "; sync ms " + ", ".join(f"{k} {v['sync_ms']:.3f}" for k, v in tiers.items()))

    # c. the per-level drills on ConfusionMatrix(1000) at int8: flaky level 1
    # retried to the clean bits, a dropped slice serving the level-0 result
    # (4x), a failed level 0 falling back to local (1x); no residual
    # committed on either degradation
    drills = {}
    with fi.simulated_pods(2, 4):
        clean = filled("confmat", "int8")
        clean._sync_dist()
        m = filled("confmat", "int8")
        with fi.flaky_level(1, fails=2), reliability.sync_policy_scope(max_retries=2, backoff_s=0.001) as pol:
            m._sync_dist()
        if not (torch.equal(m.confmat, clean.confmat) and torch.equal(m.confmat__qres, clean.confmat__qres)):
            raise AssertionError("4k c. flaky level 1: the retried sync differs from the clean one")
        drills["flaky_level1"] = {"retries": pol.stats["retries"], "bit_equal_to_clean": True}
        for label, ctx, multiple in (("pod_dropout", lambda: fi.pod_dropout(1), 4),
                                     ("level0_failure", lambda: fi.flaky_level(0, fails=10**6), 1)):
            m = filled("confmat", "int8")
            local = m.confmat.clone()
            with ctx(), reliability.sync_policy_scope(max_retries=0, degraded_ok=True) as pol:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    m._sync_dist()
            if not torch.equal(m.confmat, local * multiple):
                raise AssertionError(f"4k c. {label}: the served state is not exactly {multiple}x local")
            if bool(m.confmat__qres.abs().max() > 0):
                raise AssertionError(f"4k c. {label}: a residual was committed on a degraded sync")
            drills[label] = {"multiple": multiple, "degraded": pol.stats["degraded"], "residual_untouched": True}
    out["drills"] = drills
    print(f"4k c. drills on ConfusionMatrix({IMAGENET_C}) int8: {drills}")

    # d. the north-star step (Accuracy + AUROC over 1M) synced through a flaky
    # backend under a SyncPolicy: the unfaulted values, the tie_scan kernel in
    # the faulted compute()
    preds, target = binary

    def north_star():
        col = MetricCollection([Accuracy(), AUROC(pos_label=1)])
        for b in range(BATCHES):
            col.update(preds[b * BATCH:(b + 1) * BATCH], target[b * BATCH:(b + 1) * BATCH])
        for m in col.values():
            m.dist_sync_fn = gather_all_tensors
        return col

    want = {k: v.clone() for k, v in north_star().compute().items()}
    col = north_star()
    before = tie_scan.tie_group_reduce.launches
    with fi.flaky_sync_backend(fails=2) as flaky, reliability.sync_policy_scope(max_retries=2, backoff_s=0.001) as pol:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = col.compute()
        torch.cuda.synchronize()
        faulted_ms = (time.perf_counter() - t0) * 1e3
    launches = tie_scan.tie_group_reduce.launches - before
    for k in want:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"4k d. the faulted north-star {k} differs from the unfaulted one")
    if launches < 1 or pol.stats["retries"] != 2:
        raise AssertionError(f"4k d. launches {launches}, retries {pol.stats['retries']}")
    out["north_star"] = {"values": {k: float(v) for k, v in got.items()}, "retries": pol.stats["retries"],
                         "gathers": flaky.calls, "tie_scan_launches": launches, "faulted_compute_ms": faulted_ms}
    print(f"4k d. north-star step through flaky_sync_backend(fails=2) under SyncPolicy(max_retries=2): values equal"
          f" the unfaulted step {out['north_star']['values']}, {launches} tie_scan launch(es) in compute(),"
          f" {faulted_ms:.3f} ms")
    tel_mod.get().reset()
    return out


def _reliability_phase(torch, dev, card):
    """Phase 4l: the reliability layer on the card. Returns the phase's
    timings; leaves no guard installed."""
    import tempfile

    from metrics_tpu_torch import (
        AUROC,
        PSNR,
        Accuracy,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        MetricCohort,
        MetricCollection,
        R2Score,
    )
    from metrics_tpu_torch import reliability
    from metrics_tpu_torch.ops import tie_scan
    from metrics_tpu_torch.reliability import faultinject as fi
    from metrics_tpu_torch.reliability.checkpoint import _checksum

    out = {"card": card}
    scan = tie_scan.tie_group_reduce

    def north_star():
        return MetricCollection([Accuracy(), AUROC(pos_label=1)])

    def step_batch(i):
        """Step ``i``'s 1M binary predictions, made on the card from a seed
        (a replayed step gets the same batch)."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 1000 + i)
        preds = torch.rand(MAIN_N, generator=gen, device=dev)
        target = (torch.rand(MAIN_N, generator=gen, device=dev) < preds).to(torch.int32)
        return preds, target

    def bit_equal(a, b):
        return all(torch.equal(a[k], b[k]) for k in a) and set(a) == set(b)

    def timed(fn, trials=5):
        times, result = [], None
        for _ in range(trials):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), result

    # a. the envelope of the north-star collection after 10 steps of 1M
    col = north_star()
    for i in range(RELIABILITY_ENVELOPE_STEPS):
        col(*step_batch(i))
    want = col.compute()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "north_star.npz")
        save_ms, env = timed(lambda: reliability.save_envelope(col))
        write_ms, _ = timed(lambda: reliability.write_envelope(path, env))
        read_ms, back = timed(lambda: reliability.read_envelope(path))
        fresh = [north_star() for _ in range(5)]
        load_ms, _ = timed(lambda: reliability.load_envelope(fresh.pop(), back, strict=True))
        size = os.path.getsize(path)
    loaded = north_star()
    reliability.load_envelope(loaded, back, strict=True)
    if not bit_equal(loaded.compute(), want):
        raise AssertionError(f"4l a. the loaded collection computes {loaded.compute()} vs {want}")
    cpu_col = MetricCollection([Accuracy(device="cpu"), AUROC(pos_label=1, device="cpu")])
    cpu_col.load_state_dict({k: ([x.cpu() for x in v] if isinstance(v, list) else v.cpu())
                             for k, v in col._named_states()}, strict=True)
    cpu_checksum = reliability.save_envelope(cpu_col)["checksum"]
    if not env["checksum"] == back["checksum"] == cpu_checksum == _checksum(back["payload"]):
        raise AssertionError(f"4l a. checksums {env['checksum']} / {back['checksum']} vs the CPU's {cpu_checksum}")
    rejected = {}
    for mode, exc in (("payload", reliability.CheckpointCorruptionError),
                      ("checksum", reliability.CheckpointCorruptionError),
                      ("schema", reliability.CheckpointSchemaError),
                      ("truncate", reliability.CheckpointMismatchError)):
        try:
            reliability.load_envelope(north_star(), fi.corrupt_envelope(env, mode), strict=True)
        except exc as err:
            rejected[mode] = type(err).__name__
        else:
            raise AssertionError(f"4l a. corrupt_envelope({mode!r}) loaded")
    out["envelope"] = {"steps": RELIABILITY_ENVELOPE_STEPS, "bytes": size, "checksum": env["checksum"],
                       "save_ms": save_ms, "write_ms": write_ms, "read_ms": read_ms, "load_ms": load_ms,
                       "rejected": rejected}
    print(f"4l a. [{card}] envelope of the north-star collection after {RELIABILITY_ENVELOPE_STEPS} steps of"
          f" {MAIN_N}: {size} bytes, checksum {env['checksum']} equal to the CPU copy's, compute() of the loaded"
          f" collection bit-equal, the four corruptions rejected {rejected}; save {save_ms:.1f} ms, write"
          f" {write_ms:.1f} ms, read {read_ms:.1f} ms, load {load_ms:.1f} ms (host clock, median of 5)")
    del col, loaded, cpu_col, env, back, fresh

    # b. the guard in phase 4h's compiled regression leg (float states a NaN reaches)
    _, _, rp, rt = _regression_leg_inputs(torch, dev)
    batches = [(rp[i * BATCH:(i + 1) * BATCH], rt[i * BATCH:(i + 1) * BATCH]) for i in range(BATCHES)]

    def leg():
        return MetricCollection([MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()],
                                compiled=True)

    def states(c):
        return {(k, s): getattr(m, s).clone() for k, m in c.items() for s in m._defaults}

    poisoned = fi.poison(batches[3][0], "nan", index=17)
    guard_out = {}
    clean = leg()  # the run that skips the poisoned batch
    for b in batches:
        clean(*b)
    off = leg()
    off(*batches[0])
    ops_off = _device_ops(torch, lambda: off(*batches[1]))
    syncs_off = _syncs(torch, lambda: off(*batches[1]))
    if syncs_off:
        raise AssertionError(f"4l b. an unguarded replay synchronized the host at {syncs_off}")
    guard_out["replay_ms_off"] = _host_ms(torch, lambda: off(*batches[1]))
    with reliability.guard_scope("quarantine") as guard:
        off(*batches[2])  # builds the guarded graph
        ops_on = _device_ops(torch, lambda: off(*batches[2]))
        syncs_on = _syncs(torch, lambda: off(*batches[2]))
        guard_out["replay_ms_on"] = _host_ms(torch, lambda: off(*batches[2]))
    if len(syncs_on) != 1:
        raise AssertionError(f"4l b. a guarded replay synchronized the host {len(syncs_on)} times: {syncs_on}")
    ops_off_again = _device_ops(torch, lambda: off(*batches[1]))
    if ops_off_again != ops_off or off._engine.cache_info()["compiled_signatures"] != 2:
        raise AssertionError(f"4l b. the unguarded graph changed: {ops_off} then {ops_off_again} kernels and copies")
    guard_out.update({"kernels_copies_per_replay_off": ops_off, "kernels_copies_per_replay_on": ops_on,
                      "syncs_per_replay_off": len(syncs_off), "syncs_per_replay_on": len(syncs_on)})
    quarantined = leg()
    with reliability.guard_scope("quarantine") as guard, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, b in enumerate(batches):
            quarantined(*b)
            if i == 3:
                before = states(quarantined)
                quarantined(poisoned, b[1])
                if not bit_equal(states(quarantined), before):
                    raise AssertionError("4l b. quarantine: the poisoned batch was not rolled back")
        q_stats = dict(guard.stats)
    if q_stats["quarantined"] != 5 or q_stats["violations"] != 5:
        raise AssertionError(f"4l b. quarantine stats {q_stats}: want the 5 members quarantined once")
    if not bit_equal(states(quarantined), states(clean)):
        raise AssertionError("4l b. quarantine: the run with the poisoned batch differs from the run without it")
    raised = leg()
    for b in batches[:3]:
        raised(*b)
    before = states(raised)
    with reliability.guard_scope("raise"):
        try:
            raised(poisoned, batches[3][1])
        except reliability.NonFiniteStateError:
            pass
        else:
            raise AssertionError("4l b. raise: the poisoned batch did not raise")
    if not bit_equal(states(raised), before):
        raise AssertionError("4l b. raise: the states moved")
    raised(*batches[3])  # usable
    warned = leg()
    with reliability.guard_scope("warn") as guard, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        warned(*batches[0])
        warned(poisoned, batches[3][1])
    if not bool(torch.isnan(warned["MeanSquaredError"].sum_squared_error)) or guard.stats["violations"] < 1:
        raise AssertionError("4l b. warn: the NaN was not kept")
    guard_out["quarantine_stats"] = q_stats
    out["guard_leg"] = guard_out
    print(f"4l b. [{card}] guard in the compiled regression leg ({BATCHES} x {BATCH}, 5 metrics): off"
          f" {ops_off[0]} kernels + {ops_off[1]} copies and 0 syncs a replay, on {ops_on[0]} + {ops_on[1]} and 1"
          f" sync; quarantine of a NaN batch bit-equal to the run without it ({q_stats}), raise raised with the"
          f" states unmoved, warn kept the NaN; replay {guard_out['replay_ms_off']:.3f} ms off,"
          f" {guard_out['replay_ms_on']:.3f} ms on (host clock, median of 5)")
    del clean, off, quarantined, raised, warned

    # c. the cohort's guard: 1,024 tenants, 3 poisoned
    n, bad = RELIABILITY_TENANTS, [5, 511, 1000]
    rs = np.random.RandomState(SEED + 40)
    steps = [tuple(torch.from_numpy((rs.randint(0, 256, (n, COHORT_ROWS)) / 256.0).astype(np.float32)).to(dev)
                   for _ in range(2)) for _ in range(3)]
    poisoned_p = steps[1][0].clone()
    poisoned_p[bad, 0] = float("nan")

    def regression_cohort():
        return MetricCohort(MetricCollection([MeanSquaredError(), MeanAbsoluteError()]), tenants=n,
                            track_health=True)

    unpoisoned, skipping = regression_cohort(), regression_cohort()
    for i, (p, t) in enumerate(steps):
        unpoisoned(p, t)
        if i != 1:
            skipping(p, t)
    cohort = regression_cohort()
    with reliability.guard_scope("quarantine") as guard, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cohort(*steps[0])
        cohort(poisoned_p, steps[1][1])
        cohort(*steps[2])
        c_stats = dict(guard.stats)
    health = cohort.health()
    verdicts = np.flatnonzero(health["guard_verdicts"]).tolist()
    good = torch.ones(n, dtype=torch.bool, device=dev)
    good[bad] = False
    for name, d in cohort._states.items():
        for sname, v in d.items():
            w = unpoisoned._states[name][sname]
            if not torch.equal(v[good], w[good]):
                raise AssertionError(f"4l c. an unpoisoned tenant's {name}.{sname} moved")
            if not torch.equal(v[~good], skipping._states[name][sname][~good]):
                raise AssertionError(f"4l c. the poisoned tenants' {name}.{sname} differ from a run without step 1")
    if verdicts != bad or c_stats["quarantined"] != 2:
        raise AssertionError(f"4l c. guard verdicts on slots {verdicts}, stats {c_stats}; want {bad}")
    out["cohort"] = {"tenants": n, "poisoned": bad, "guard_verdict_slots": verdicts, "stats": c_stats}
    print(f"4l c. [{card}] cohort of {n} tenants under quarantine, {len(bad)} poisoned: only they rolled back,"
          f" the other {n - len(bad)} bit-equal to the unpoisoned run, health()['guard_verdicts'] on slots"
          f" {verdicts}")
    del unpoisoned, skipping, cohort

    # d. the session: 20 steps of 1M, a checkpoint every 5, preempted at step 12
    last = RELIABILITY_SESSION_STEPS
    with tempfile.TemporaryDirectory() as d:
        straight = reliability.EvalSession(north_star(), os.path.join(d, "straight"),
                                           checkpoint_every=RELIABILITY_CHECKPOINT_EVERY)
        ckpt_ms = []
        for i in range(1, last + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            straight.step(i, *step_batch(i))
            torch.cuda.synchronize()
            if i % RELIABILITY_CHECKPOINT_EVERY == 0:
                ckpt_ms.append((time.perf_counter() - t0) * 1e3)
        want = straight.compute()
        del straight
        journal = os.path.join(d, "preempted")
        first = reliability.EvalSession(north_star(), journal, checkpoint_every=RELIABILITY_CHECKPOINT_EVERY)
        try:
            with fi.preempt_at_step(first, RELIABILITY_PREEMPT_AT):
                for i in range(1, last + 1):
                    first.step(i, *step_batch(i))
        except fi.Preempted:
            pass
        else:
            raise AssertionError("4l d. the session was not preempted")
        del first
        resumed = reliability.EvalSession(north_star(), journal, checkpoint_every=RELIABILITY_CHECKPOINT_EVERY)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cursor = resumed.resume()
        torch.cuda.synchronize()
        resume_ms = (time.perf_counter() - t0) * 1e3
        if cursor != RELIABILITY_PREEMPT_AT - RELIABILITY_PREEMPT_AT % RELIABILITY_CHECKPOINT_EVERY:
            raise AssertionError(f"4l d. resume() returned cursor {cursor}")
        for i in range(1, last + 1):
            resumed.step(i, *step_batch(i))
        zero = scan.launches
        got = resumed.compute()
        launches = scan.launches - zero
        if not bit_equal(got, want) or launches != 1:
            raise AssertionError(f"4l d. resumed compute {got} vs {want}, {launches} tie_scan launches")
        stats = dict(resumed.stats)
        del resumed
        # a torn newest generation: the resume falls back to the one before it
        fallback = reliability.EvalSession(north_star(), journal, checkpoint_every=RELIABILITY_CHECKPOINT_EVERY)
        records = fallback.journal.records()
        fi.torn_write(fallback.journal._gen_path(int(records[-1]["generation"])))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torn_cursor = fallback.resume()
        if torn_cursor != int(records[-2]["cursor"]):
            raise AssertionError(f"4l d. after a torn newest generation resume() returned {torn_cursor}")
        del fallback
    out["session"] = {"steps": last, "checkpoint_every": RELIABILITY_CHECKPOINT_EVERY,
                      "preempt_at": RELIABILITY_PREEMPT_AT, "resumed_cursor": cursor, "torn_fallback_cursor": torn_cursor,
                      "checkpoint_step_ms": ckpt_ms, "resume_ms": resume_ms, "stats": stats,
                      "compute_tie_scan_launches": launches}
    print(f"4l d. [{card}] EvalSession over the north-star step, {last} steps of {MAIN_N}, a checkpoint every"
          f" {RELIABILITY_CHECKPOINT_EVERY}, preempted at {RELIABILITY_PREEMPT_AT}: resume() -> {cursor}, the rerun's"
          f" compute() bit-equal to the uninterrupted run's ({launches} tie_scan launch), a torn newest generation"
          f" falls back to cursor {torn_cursor}; steps that checkpoint "
          + ", ".join(f"{ms:.1f}" for ms in ckpt_ms) + f" ms, resume {resume_ms:.1f} ms (host clock)")
    return out


def _serving_phase(torch, dev, card):
    """Phase 4m: ``serving/`` on the card. Returns the phase's timings;
    closes every pipeline and writer it opens."""
    import tempfile
    import threading

    from metrics_tpu_torch import (
        AUROC,
        F1,
        Accuracy,
        MetricCohort,
        MetricCollection,
        Precision,
        Recall,
        reliability,
    )
    from metrics_tpu_torch.cohort import route_rows
    from metrics_tpu_torch.engine import _flags_to_host
    from metrics_tpu_torch.metric import Metric
    from metrics_tpu_torch.observability.telemetry import LATENCY_BUCKETS_MS, Telemetry, percentile
    from metrics_tpu_torch.ops import tie_scan
    from metrics_tpu_torch.reliability import faultinject as fi
    from metrics_tpu_torch.reliability.checkpoint import read_envelope, save_envelope
    from metrics_tpu_torch.serving import AsyncServingEngine, IngestQueue

    out = {"card": card}
    scan = tie_scan.tie_group_reduce
    opened = []  # every pipeline and writer, closed before the phase returns

    def pcts(samples):
        """p50 / p95 / p99 through the shared fixed-bucket estimator (a local
        registry: the global one stays untouched)."""
        tel = Telemetry()
        for s in samples:
            tel.observe_hist("leg", s, LATENCY_BUCKETS_MS)
        return {q: percentile(tel.histograms["leg"], q) for q in (50, 95, 99)}

    def leg():
        return MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                                 Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")],
                                compiled=True)

    def states(c):
        return {(k, s): getattr(m, s) for k, m in c.items() for s in m._defaults}

    def bit_equal(a, b):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)

    def caller_sync():
        torch.cuda.current_stream().synchronize()

    try:
        # a. the JAX bench's serving leg, uncut: 1M 4-class rows, 12 steps
        rs = np.random.RandomState(0)
        probs = rs.rand(SERVING_N, 4).astype(np.float32)
        probs /= probs.sum(1, keepdims=True)
        probs = torch.from_numpy(probs).to(dev)
        target = torch.from_numpy(rs.randint(4, size=SERVING_N)).to(dev)

        def run_blocking(c):
            c(probs, target)
            caller_sync()  # blocks on the state, as the bench's block_until_ready

        blocking = leg()
        t0 = time.perf_counter()
        run_blocking(blocking)  # the cold first dispatch: build + replay
        cold_ms = (time.perf_counter() - t0) * 1e3
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            run_blocking(blocking)
            best = min(best, time.perf_counter() - t0)
        metric_ms = best * 1e3
        model_s = max(0.02, 1.5 * best)
        t0 = time.perf_counter()
        for _ in range(SERVING_STEPS):
            time.sleep(model_s)
        model_ms = (time.perf_counter() - t0) / SERVING_STEPS * 1e3

        blocking = leg()
        run_blocking(blocking)
        samples_b = []
        t0 = time.perf_counter()
        for _ in range(SERVING_STEPS):
            t1 = time.perf_counter()
            time.sleep(model_s)
            run_blocking(blocking)
            samples_b.append((time.perf_counter() - t1) * 1e3)
        step_b = (time.perf_counter() - t0) / SERVING_STEPS * 1e3

        served = leg()
        pipe = AsyncServingEngine(served)
        opened.append(pipe)
        if not pipe.is_async:
            raise AssertionError(f"4m a. the forward leg was refused: {pipe.refusal_reason}")
        pipe.forward(probs, target)  # the first dispatch, on the caller thread
        pipe.drain()
        caller_sync()
        # each dispatch's stage-to-device-complete time: an event on the
        # caller's stream before forward(), one on the dispatching stream
        # after the step is queued
        staged, finished = [], []
        real_dispatch = pipe._dispatch

        def timed_dispatch(args, kwargs):
            result = real_dispatch(args, kwargs)
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            finished.append(done)
            return result

        pipe._dispatch = timed_dispatch
        samples_a = []
        t0 = time.perf_counter()
        for _ in range(SERVING_STEPS):
            t1 = time.perf_counter()
            time.sleep(model_s)
            ready = torch.cuda.Event(enable_timing=True)
            ready.record()
            staged.append(ready)
            pipe.forward(probs, target)
            samples_a.append((time.perf_counter() - t1) * 1e3)
        pipe.drain()
        caller_sync()  # the drain and the last step's kernels inside the window
        step_a = (time.perf_counter() - t0) / SERVING_STEPS * 1e3
        pipe._dispatch = real_dispatch
        device_ms = [a.elapsed_time(b) for a, b in zip(staged, finished)]
        if len(finished) != SERVING_STEPS:
            raise AssertionError(f"4m a. {len(finished)} timed dispatches of {SERVING_STEPS}")
        if pipe.stats["dispatches"] != SERVING_STEPS + 1 or pipe.stats["inline_steps"] != 1:
            raise AssertionError(f"4m a. pipeline stats {pipe.stats}")
        if not bit_equal(served.compute(), blocking.compute()) or not bit_equal(states(served), states(blocking)):
            raise AssertionError("4m a. the async loop's values or states differ from the blocking loop's")
        pipe.close()
        pb, pa = pcts(samples_b), pcts(samples_a)
        over_b, over_a = step_b - model_ms, step_a - model_ms
        out["bench_leg"] = {
            "rows": SERVING_N, "steps": SERVING_STEPS, "cold_first_dispatch_ms": cold_ms, "metric_ms": metric_ms,
            "model_ms": model_ms, "blocking_step_ms": step_b, "async_step_ms": step_a,
            "blocking_p50_p95_p99": [pb[50], pb[95], pb[99]], "async_p50_p95_p99": [pa[50], pa[95], pa[99]],
            "blocking_overhead_ms": over_b, "async_overhead_ms": over_a,
            "overhead_ratio": over_a / over_b if over_b > 0 else None,
            "device_complete_ms": device_ms,
        }
        print(f"4m a. [{card}] the JAX bench's serving leg ({SERVING_N} 4-class rows, Accuracy + macro"
              f" Precision/Recall/F1 compiled, {SERVING_STEPS} steps, a host sleep of {model_s * 1e3:.1f} ms a step,"
              f" measured {model_ms:.3f}): cold first dispatch {cold_ms:.1f} ms, blocking metric {metric_ms:.3f} ms;"
              f" step blocking {step_b:.3f} ms (p50/p95/p99 {pb[50]:.2f}/{pb[95]:.2f}/{pb[99]:.2f}), async"
              f" {step_a:.3f} ms ({pa[50]:.2f}/{pa[95]:.2f}/{pa[99]:.2f}); overhead over the sleep blocking"
              f" {over_b:.3f} ms, async {over_a:.3f} ms; each dispatch stage-to-device-complete "
              + ", ".join(f"{ms:.2f}" for ms in device_ms) + " ms; values and states bit-equal")

        # b. the same loop with the model's work on the card
        probe_start, probe_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        probe_start.record()
        torch.cuda._sleep(SERVING_SLEEP_PROBE_CYCLES)
        probe_end.record()
        probe_end.synchronize()
        cycles = int(SERVING_SLEEP_PROBE_CYCLES * model_s * 1e3 / probe_start.elapsed_time(probe_end))

        def device_loop(step):
            times, sleeps = [], []
            for _ in range(SERVING_STEPS):
                t1 = time.perf_counter()
                before, after = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                before.record()
                torch.cuda._sleep(cycles)  # the model's work, on the caller's stream
                after.record()
                step()
                caller_sync()  # the caller's stream only
                times.append((time.perf_counter() - t1) * 1e3)
                sleeps.append(before.elapsed_time(after))
            return float(np.median(times)), float(np.median(sleeps))

        on_card = leg()
        on_card(probs, target)
        caller_sync()
        dev_b, sleep_b = device_loop(lambda: on_card(probs, target))
        served = leg()
        pipe = AsyncServingEngine(served)
        opened.append(pipe)
        pipe.forward(probs, target)
        pipe.drain()
        dev_a, sleep_a = device_loop(lambda: pipe.forward(probs, target))
        pipe.drain()
        if not bit_equal(states(served), states(on_card)):
            raise AssertionError("4m b. the async loop's states differ from the blocking loop's")
        pipe.close()
        out["device_model_leg"] = {"model_ms": model_s * 1e3, "sleep_cycles": cycles, "blocking_step_ms": dev_b,
                                   "async_step_ms": dev_a, "device_sleep_ms_blocking": sleep_b,
                                   "device_sleep_ms_async": sleep_a, "blocking_over_sleep_ms": dev_b - sleep_b,
                                   "async_over_sleep_ms": dev_a - sleep_a, "blocking_minus_async_ms": dev_b - dev_a}
        print(f"4m b. [{card}] the same loop with the model's work on the card (torch.cuda._sleep of {cycles} cycles"
              f" on the caller's stream, aimed at {model_s * 1e3:.1f} ms; each step ends in a synchronize of that"
              f" stream): the sleep alone {sleep_b:.3f} ms blocking / {sleep_a:.3f} ms async (CUDA events, median);"
              f" step blocking {dev_b:.3f} ms ({dev_b - sleep_b:+.3f} over its sleep), async {dev_a:.3f} ms"
              f" ({dev_a - sleep_a:+.3f}), blocking minus async {dev_b - dev_a:.3f} ms (host clock, median of"
              f" {SERVING_STEPS}); states bit-equal")

        # c. ingest: 64 tenants x 256 rows x 8 waves, coalesce_max=4
        tenants, rows_per_step = SERVING_TENANTS, SERVING_ROWS_PER_STEP
        chunk = tenants * rows_per_step
        ids = np.tile(np.arange(tenants, dtype=np.int32), rows_per_step)
        flat_p = rs.rand(chunk).astype(np.float32)
        flat_t = (flat_p > 0.5).astype(np.int32)
        direct = MetricCohort(Accuracy(), tenants=tenants)
        routed = route_rows(torch.from_numpy(ids).to(dev), torch.from_numpy(flat_p).to(dev),
                            torch.from_numpy(flat_t).to(dev), num_tenants=tenants)
        for _ in range(SERVING_WAVES + 1):
            direct(*routed)
        want = direct.compute()
        ingest = {}
        for mode in ("cohort", "pipeline"):
            cohort = MetricCohort(Accuracy(), tenants=tenants)
            sink = cohort
            if mode == "pipeline":
                sink = AsyncServingEngine(cohort)
                opened.append(sink)
            q = IngestQueue(sink, rows_per_step=rows_per_step, max_buffered_rows=1 << 22, coalesce_max=4)
            q.submit(ids, flat_p, flat_t)  # warm the wave's step
            if mode == "pipeline":
                sink.drain()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SERVING_WAVES):
                q.submit(ids, flat_p, flat_t)
            q.flush()
            if mode == "pipeline":
                sink.drain()
            caller_sync()
            ingest[mode] = SERVING_WAVES * chunk / (time.perf_counter() - t0)
            got = cohort.compute()
            if not torch.equal(got, want) or q.stats["admitted_rows"] != (SERVING_WAVES + 1) * chunk:
                raise AssertionError(f"4m c. {mode}: ingest values differ from direct route_rows forwards"
                                     f" ({q.stats})")
            if mode == "pipeline":
                sink.close()
        out["ingest"] = {"tenants": tenants, "rows_per_step": rows_per_step, "waves": SERVING_WAVES,
                         "rows_per_s": ingest}
        print(f"4m c. [{card}] ingest of {tenants} tenants x {rows_per_step} rows x {SERVING_WAVES} waves"
              f" (coalesce_max=4): {ingest['cohort']:.0f} rows/s into the cohort, {ingest['pipeline']:.0f} rows/s"
              f" behind an AsyncServingEngine (host clock, ending in a synchronize); the cohort's values bit-equal to"
              f" direct route_rows forwards of the same rows")

        # d. the background checkpoint: EvalSession over the north-star collection
        def north_star():
            return MetricCollection([Accuracy(), AUROC(pos_label=1)])

        def step_batch(i):
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED + 1000 + i)
            p = torch.rand(MAIN_N, generator=gen, device=dev)
            return p, (torch.rand(MAIN_N, generator=gen, device=dev) < p).to(torch.int32)

        last, every = RELIABILITY_SESSION_STEPS, RELIABILITY_CHECKPOINT_EVERY
        with tempfile.TemporaryDirectory() as d:
            straight = reliability.EvalSession(north_star(), os.path.join(d, "straight"), checkpoint_every=every,
                                               background_checkpoints=True)
            commit_ms = []  # submit to durable commit, on the writer's thread
            real_commit = straight._bg._commit_job

            def timed_commit(job):
                record = real_commit(job)
                commit_ms.append((time.perf_counter_ns() - job["t_submit_ns"]) / 1e6)
                return record

            straight._bg._commit_job = timed_commit
            ckpt_ms = []
            for i in range(1, last + 1):
                caller_sync()
                t0 = time.perf_counter()
                straight.step(i, *step_batch(i))
                caller_sync()
                if i % every == 0:
                    ckpt_ms.append((time.perf_counter() - t0) * 1e3)
            straight.flush_checkpoints()
            want = straight.compute()
            record = straight.journal.records()[-1]
            bg_checksum = read_envelope(straight.journal._gen_path(int(record["generation"])))["checksum"]
            sync_checksum = save_envelope(straight.metric)["checksum"]
            if int(record["cursor"]) != last or bg_checksum != sync_checksum:
                raise AssertionError(f"4m d. the background envelope at cursor {record['cursor']}: checksum"
                                     f" {bg_checksum} vs the synchronous {sync_checksum}")
            straight.close()
            del straight
            journal = os.path.join(d, "preempted")
            first = reliability.EvalSession(north_star(), journal, checkpoint_every=every,
                                            background_checkpoints=True)
            for i in range(1, every + 1):
                first.step(i, *step_batch(i))
            first.flush_checkpoints()
            with fi.preempt_at_step(first, RELIABILITY_PREEMPT_AT, during="background_write") as info:
                try:
                    for i in range(every + 1, last + 1):
                        if i == RELIABILITY_PREEMPT_AT:
                            first._bg.drain(raise_errors=False)  # the torn write has happened
                        first.step(i, *step_batch(i))
                except fi.Preempted:
                    pass
                else:
                    raise AssertionError("4m d. the session was not preempted")
            if info != {"preempted_at": RELIABILITY_PREEMPT_AT, "torn_writes": 1}:
                raise AssertionError(f"4m d. the drill's record {info}")
            first._bg.close()
            del first
            resumed = reliability.EvalSession(north_star(), journal, checkpoint_every=every,
                                              background_checkpoints=True)
            caller_sync()
            t0 = time.perf_counter()
            cursor = resumed.resume()
            caller_sync()
            resume_ms = (time.perf_counter() - t0) * 1e3
            if cursor != every:
                raise AssertionError(f"4m d. resume() returned cursor {cursor}; the torn write's was {2 * every}")
            for i in range(1, last + 1):
                resumed.step(i, *step_batch(i))
            zero = scan.launches
            got = resumed.compute()
            launches = scan.launches - zero
            if not bit_equal(got, want) or launches != 1:
                raise AssertionError(f"4m d. resumed compute {got} vs {want}, {launches} tie_scan launches")
            resumed.flush_checkpoints()
            stats = dict(resumed.stats)
            resumed.close()
            del resumed
        out["session"] = {"steps": last, "checkpoint_every": every, "preempt_at": RELIABILITY_PREEMPT_AT,
                          "resumed_cursor": cursor, "checkpoint_step_ms": ckpt_ms, "commit_ms": commit_ms,
                          "resume_ms": resume_ms, "stats": stats, "checksum": bg_checksum,
                          "compute_tie_scan_launches": launches}
        print(f"4m d. [{card}] EvalSession(background_checkpoints=True) over the north-star step, {last} steps of"
              f" {MAIN_N}, a checkpoint every {every}: steps that checkpoint "
              + ", ".join(f"{ms:.1f}" for ms in ckpt_ms) + " ms (host clock ending in a synchronize of the"
              " caller's stream; phase 4l's synchronous ones above), submit-to-commit "
              + ", ".join(f"{ms:.1f}" for ms in commit_ms) + f" ms; the newest envelope's checksum {bg_checksum}"
              f" equals the synchronous envelope's; preempted mid background write at step"
              f" {RELIABILITY_PREEMPT_AT}: resume() -> {cursor} in {resume_ms:.1f} ms, the rerun's compute() bit-equal"
              f" to the uninterrupted run's ({launches} tie_scan launch)")

        # e. admission
        refused = AsyncServingEngine(north_star())
        opened.append(refused)
        if refused.is_async or "'AUROC' is not engine-eligible" not in refused.refusal_reason:
            raise AssertionError(f"4m e. the north-star collection was admitted: {refused.refusal_reason}")
        reference = north_star()
        for i in range(1, 4):
            batch = step_batch(i)
            if refused.forward(*batch) is None:
                raise AssertionError("4m e. the refused pipeline returned no forward value")
            reference(*batch)
        zero = scan.launches
        got = refused.compute()
        launches_e = scan.launches - zero
        if not bit_equal(got, reference.compute()) or launches_e != 1 or refused.stats["blocking_steps"] != 3:
            raise AssertionError(f"4m e. the refused pipeline: {got}, {launches_e} tie_scan launches, {refused.stats}")
        refused.close()

        class DoubleBufferAliaser(Metric):
            _fused_forward = True

            def __init__(self):
                super().__init__()
                self._pool = torch.zeros((), device=dev)
                self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

            def update(self, x):
                self.acc = self.acc + torch.sum(x)

            def compute(self):
                return self.acc

            def reset(self):
                super().reset()
                self.acc = self._pool

        class HostReadOfDonated(Metric):
            _fused_forward = True

            def __init__(self):
                super().__init__()
                self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")
                self._last_value = None

            def update(self, x):
                self.acc = self.acc + torch.sum(x)

            def compute(self):
                self._last_value = self.acc
                return self.acc

        hazards = {}
        for cls in (DoubleBufferAliaser, HostReadOfDonated):
            pipe = AsyncServingEngine(cls())
            opened.append(pipe)
            if pipe.is_async or "MTA009" not in pipe.refusal_reason:
                raise AssertionError(f"4m e. {cls.__name__} was admitted")
            if float(pipe.forward(torch.ones(4, device=dev))) != 4.0:
                raise AssertionError(f"4m e. {cls.__name__} on the blocking path")
            hazards[cls.__name__] = pipe.refusal_reason.split("(")[1].split(" line")[0]
            pipe.close()

        # the serve loop reads values to the host while the worker replays,
        # with a new signature (built on the caller) in the middle
        served = leg()
        pipe = AsyncServingEngine(served)
        opened.append(pipe)
        short = (probs[: SERVING_N // 2], target[: SERVING_N // 2])
        pipe.forward(probs, target)
        reads = 0
        worker_busy = 0
        for i in range(SERVING_READ_STEPS):
            pipe.forward(*(short if i == SERVING_READ_STEPS // 2 else (probs, target)))
            worker_busy += pipe._outstanding > 0
            reads += int(target[i].item()) >= 0  # a synchronizing read on the serve loop
        pipe.drain()
        if worker_busy == 0 or pipe.stats["inline_steps"] != 2 or pipe.stats["errors"]:
            raise AssertionError(f"4m e. the read drill: worker busy at {worker_busy} reads, {pipe.stats}")
        pipe.close()

        # back-to-back forwards under a guard: the worker holds the engine's
        # lock until the card has run its step (the guard's flag read), here
        # behind a device sleep; the next forward must not wait for it
        with reliability.guard_scope("quarantine"):
            served = leg()
            pipe = AsyncServingEngine(served)
            opened.append(pipe)
            pipe.forward(probs, target)  # built on the caller
            step_end = []
            real_dispatch = pipe._dispatch

            def held_dispatch(args, kwargs):
                torch.cuda._sleep(4 * cycles)
                result = real_dispatch(args, kwargs)
                step_end.append(time.perf_counter())
                return result

            pipe._dispatch = held_dispatch
            pipe.forward(probs, target)
            deadline = time.perf_counter() + 10.0
            while not served._engine._lock.locked() and time.perf_counter() < deadline:
                time.sleep(0.0002)
            time.sleep(0.01)  # the worker is now waiting on the card inside its step
            t0 = time.perf_counter()
            pipe.forward(probs, target)
            t_returned = time.perf_counter()
            torch.ones(1 << 20, device=dev).add_(1)  # the serve loop's next allocation and launch
            t_launched = time.perf_counter()
            pipe.drain()
            if not step_end or not t_launched + 0.01 < step_end[0] or pipe.stats["errors"]:
                raise AssertionError(f"4m e. forward() and a launch returned {(t_launched - step_end[0]) * 1e3:+.1f} ms"
                                     f" after the worker's guarded step ended ({pipe.stats})")
            held_forward_ms = (t_returned - t0) * 1e3
            held_launch_ms = (t_launched - t_returned) * 1e3
            held_margin_ms = (step_end[0] - t_launched) * 1e3
            pipe.close()

            # why the guard reads its flags through pinned memory: a thread
            # waiting in a copy into pageable memory stalls another thread's
            # launch until the card reaches the copy; and what that read
            # costs a guarded step against the pageable one, in turns
            def stalled_launch_ms(read):
                side, x, entered = torch.cuda.Stream(), torch.ones(4, device=dev), threading.Event()

                def waiter():
                    with torch.cuda.stream(side):
                        torch.cuda._sleep(4 * cycles)
                        y = x + 1
                        entered.set()
                        read(y)

                th = threading.Thread(target=waiter)
                th.start()
                entered.wait(10.0)
                time.sleep(0.01)
                t1 = time.perf_counter()
                x.add_(0)
                ms = (time.perf_counter() - t1) * 1e3
                th.join(30.0)
                return ms

            stall_ms = {"pageable": stalled_launch_ms(lambda y: y.cpu()), "pinned": stalled_launch_ms(_flags_to_host)}
            if stall_ms["pinned"] > 10.0:
                raise AssertionError(f"4m e. a launch waited {stall_ms['pinned']:.1f} ms behind the pinned flag read")

            def guarded_step_ms():
                times = []
                for _ in range(20):
                    caller_sync()
                    t1 = time.perf_counter()
                    served(probs, target)
                    caller_sync()
                    times.append((time.perf_counter() - t1) * 1e3)
                return float(np.median(times))

            import metrics_tpu_torch.engine as engine_module

            read_ms = {"pinned": [], "pageable": []}
            try:
                for _ in range(4):
                    for how in read_ms:
                        engine_module._flags_to_host = _flags_to_host if how == "pinned" else (lambda f: f.cpu())
                        read_ms[how].append(guarded_step_ms())
            finally:
                engine_module._flags_to_host = _flags_to_host
        out["admission"] = {"north_star": refused.refusal_reason, "compute_tie_scan_launches": launches_e,
                            "hazards": hazards, "reads_while_replaying": reads, "worker_busy_at_reads": worker_busy,
                            "forward_ms_while_worker_holds_guarded_step": held_forward_ms,
                            "alloc_and_launch_ms_meanwhile": held_launch_ms,
                            "launch_ms_behind_other_threads_read": stall_ms,
                            "guarded_step_ms_by_flag_read": read_ms,
                            "returned_before_that_step_ended_ms": held_margin_ms}
        print(f"4m e. [{card}] admission: the north-star collection refused ({refused.refusal_reason}), served"
              f" on the blocking path bit-equal, its compute() {launches_e} tie_scan launch; the hazard metrics"
              f" refused ({hazards}); {reads} .item() reads on the serve loop, {worker_busy} of them while the worker"
              f" held a batch, none raised (a new signature built on the caller thread between them); under a"
              f" guard, forward() took {held_forward_ms:.3f} ms while the worker held the engine's lock on its step,"
              f" an allocation and a launch after it {held_launch_ms:.3f} ms, done {held_margin_ms:.1f} ms before"
              f" that step ended (host clock); a launch behind another thread's wait in a pageable .cpu() took"
              f" {stall_ms['pageable']:.3f} ms, behind the pinned read {stall_ms['pinned']:.3f} ms; the guarded step"
              f" (median of 20, in turns) with the pinned read "
              + " / ".join(f"{ms:.3f}" for ms in read_ms["pinned"]) + " ms, with a pageable one "
              + " / ".join(f"{ms:.3f}" for ms in read_ms["pageable"]) + " ms")
    finally:
        for thing in opened:
            thing.close()
    return out


def _exporter_phase(torch, dev, card):
    """Phase 4n: the export surface and the cost ledger on the card, beside
    a live serve loop. Returns the phase's timings; closes every pipeline,
    session and listener it opens, and turns every recorder off."""
    import gc
    import tempfile
    import threading
    import urllib.request

    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch import AUROC, F1, Accuracy, MetricCohort, MetricCollection, Precision, Recall, reliability
    from metrics_tpu_torch.cohort import route_rows
    from metrics_tpu_torch.engine import _HostMirror
    from metrics_tpu_torch.ops import tie_scan
    from metrics_tpu_torch.ops.auroc_kernel import _co_sort
    from metrics_tpu_torch.serving import AsyncServingEngine, ServingSLO

    gc.collect()  # earlier phases' cohorts and sessions leave the weak registries
    out = {"card": card}
    scan = tie_scan.tie_group_reduce
    tenants, rows_per_step = SERVING_TENANTS, SERVING_ROWS_PER_STEP
    chunk = tenants * rows_per_step
    rs = np.random.RandomState(SEED + 70)
    ids = torch.from_numpy(np.tile(np.arange(tenants, dtype=np.int32), rows_per_step)).to(dev)

    def wave():
        p = torch.from_numpy(rs.rand(chunk).astype(np.float32)).to(dev)
        return route_rows(ids, p, (p > 0.5).to(torch.int32), num_tenants=tenants)

    waves = [wave() for _ in range(4)]
    _, _, p4, t4 = _forward_leg_inputs(torch, dev)
    leg_batches = [(p4[b * BATCH:(b + 1) * BATCH], t4[b * BATCH:(b + 1) * BATCH]) for b in range(3)]

    def leg():
        return MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                                 Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")],
                                compiled=True)

    def health_cohort():
        return MetricCohort(Accuracy(), tenants=tenants, track_health=True)

    def caller_sync():
        torch.cuda.current_stream().synchronize()

    def get(url):
        with urllib.request.urlopen(url, timeout=EXPORTER_TIMEOUT_S) as r:
            return r.read().decode()

    def tenant_rows(samples, cid, family):
        return {labels["tenant"]: v for labels, v in samples[f"metrics_tpu_cohort_tenant_{family}"]
                if labels["cohort"] == cid}

    pinned_read = _HostMirror.read

    def paged_read(mirror, tensors, ready):
        """The same event-ordered read into pageable memory (the read the
        port does not make: a thread waiting in it stalls other threads)."""
        mirror.stream.wait_event(ready)
        with torch.cuda.stream(mirror.stream):
            return torch.stack([t.cpu() for t in tensors])

    # a. values, states and kernels a replay with the exporter and the ledger off, then armed
    def workload():
        cohort, col = health_cohort(), leg()
        values = [cohort(*w) for w in waves] + [v for b in leg_batches for v in col(*b).values()]
        # the states before the measuring steps (each count steps two to sixteen times)
        states = [v for d in cohort._states.values() for v in d.values()]
        states += [v for v in cohort._health.values()] + [getattr(m, s) for m in col.values() for s in m._defaults]
        health = cohort.health()
        return (cohort, col), values, states, {k: health[k] for k in ("rows_seen", "updates", "last_step")}

    @contextlib.contextmanager
    def armed_scopes():
        with obs.exporter_scope(port=0), obs.cost_ledger_scope() as ledger:
            yield ledger

    plain = workload()
    with armed_scopes() as ledger:
        armed = workload()
        entries_a = len(ledger.entries())
    for label, a, b in (("values", plain[1], armed[1]), ("states", plain[2], armed[2])):
        if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"4n a. {label} differ with the exporter and the ledger armed")
    if any(not np.array_equal(plain[3][k], armed[3][k]) for k in plain[3]):
        raise AssertionError(f"4n a. health off {plain[3]}, armed {armed[3]}")
    if entries_a != 2:
        raise AssertionError(f"4n a. the armed ledger holds {entries_a} programs; the workload built 2")
    # the kernels and copies of a replay and of a step, off and armed, traced
    # in turns (the armed side inside the scopes): the pair of a round that
    # holds the same device records
    (p_cohort, p_col), (a_cohort, a_col) = plain[0], armed[0]
    ((p_prog,), (a_prog,)) = p_cohort._engine._compiled.values(), a_cohort._engine._compiled.values()
    counts, spoiled = {}, {}
    for label, off_fn, armed_fn in (("cohort_replay", p_prog.graph.replay, a_prog.graph.replay),
                                    ("cohort", lambda: p_cohort(*waves[0]), lambda: a_cohort(*waves[0])),
                                    ("leg", lambda: p_col(*leg_batches[0]), lambda: a_col(*leg_batches[0]))):
        try:
            off, on, rounds = _paired_device_ops(torch, off_fn, armed_fn, contexts=(None, armed_scopes))
        except AssertionError as err:
            raise AssertionError(f"4n a. kernels and copies of the {label} off and armed: {err}") from None
        if off != on:  # the same records, so never; kept for the record
            raise AssertionError(f"4n a. kernels and copies of the {label} off {off}, armed {on}")
        counts[label] = off
        if rounds:
            spoiled[label] = rounds
    out["armed_vs_off"] = {"kernels_copies_per_cohort_replay": list(counts["cohort_replay"]),
                           "kernels_copies_per_step": {k: list(counts[k]) for k in ("cohort", "leg")},
                           "rounds_spoiled": spoiled}
    print(f"4n a. [{card}] a {tenants}-tenant health-armed cohort ({len(waves)} steps) and the compiled forward leg"
          f" (3 batches of {BATCH}) with the exporter and the cost ledger off, then armed: values, states and"
          f" health bit-equal; kernels and copies a cohort replay {counts['cohort_replay']}, a step"
          f" {({k: counts[k] for k in ('cohort', 'leg')})} off and armed (traced in turns: the same device"
          " records)" + (f"; rounds that disagreed first: {spoiled}" if spoiled else ""))
    del plain, armed

    opened = []
    engines = []
    try:
        with tempfile.TemporaryDirectory(dir="build") as d, obs.telemetry_scope() as tel, \
                obs.exporter_scope(port=0) as ex, obs.cost_ledger_scope() as ledger:
            base = f"http://127.0.0.1:{ex.port}"
            # b. the serve loop, a session beside it, and a client scraping both endpoints
            slo = ServingSLO(e2e_p99_ms=60_000.0, max_queue_age_ms=60_000.0, name="smoke-serving")
            cohort = health_cohort()
            engines.append(cohort._engine)
            pipe = AsyncServingEngine(cohort, slo=slo)
            opened.append(pipe)
            session = reliability.EvalSession(MetricCollection([Accuracy(), AUROC(pos_label=1)]),
                                              os.path.join(d, "session"), checkpoint_every=5,
                                              background_checkpoints=True)
            opened.append(session)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED + 71)
            session_batches = []
            for _ in range(BATCHES):
                p = torch.rand(BATCH, generator=gen, device=dev)
                session_batches.append((p, (torch.rand(BATCH, generator=gen, device=dev) < p).to(torch.int32)))
            pipe.forward(*waves[0])  # built on the caller
            scrapes, scrape_errors = [], []

            def scraper():
                try:
                    for _ in range(EXPORTER_SCRAPES):
                        for path in ("/metrics", "/healthz"):
                            t1 = time.perf_counter()
                            body = get(base + path)
                            scrapes.append((path, (time.perf_counter() - t1) * 1e3, body))
                except Exception as err:  # noqa: BLE001 - surfaced below
                    scrape_errors.append(err)

            client = threading.Thread(target=scraper, daemon=True)
            client.start()
            served = 1
            while client.is_alive() or served < len(session_batches):
                pipe.forward(*waves[served % len(waves)])
                if served <= len(session_batches):
                    session.step(served - 1, *session_batches[served - 1])
                served += 1
            client.join(EXPORTER_TIMEOUT_S)
            pipe.drain(timeout_s=EXPORTER_TIMEOUT_S)
            if scrape_errors or client.is_alive():
                raise AssertionError(f"4n b. the scrape client failed: {scrape_errors}")
            cid = str(cohort._exporter_id)
            label = str(session.journal.directory)
            metrics = [body for path, _, body in scrapes if path == "/metrics"]
            healthz = [json.loads(body) for path, _, body in scrapes if path == "/healthz"]
            if len(metrics) < EXPORTER_SCRAPES or len(healthz) < EXPORTER_SCRAPES:
                raise AssertionError(f"4n b. {len(metrics)} /metrics and {len(healthz)} /healthz scrapes")
            updates_seen = []
            for body in metrics:
                samples = obs.parse_prometheus_text(body)
                updates = tenant_rows(samples, cid, "updates")
                rows = tenant_rows(samples, cid, "rows_seen")
                last = tenant_rows(samples, cid, "last_step")
                u = set(updates.values())
                if len(updates) != tenants or len(u) != 1 or set(rows.values()) != {u.pop() * rows_per_step} \
                        or set(last.values()) != set(updates.values()):
                    raise AssertionError(f"4n b. a scrape's tenant rows: {len(updates)} tenants, updates"
                                         f" {sorted(set(updates.values()))}, rows {sorted(set(rows.values()))}")
                updates_seen.append(next(iter(updates.values())))
                for family in ("metrics_tpu_session_cursor", "metrics_tpu_session_generation",
                               "metrics_tpu_engine_compile_cold_total", "metrics_tpu_engine_programs_cold",
                               "metrics_tpu_engine_program_compiles", "metrics_tpu_engine_program_compile_ms"):
                    if family not in samples:
                        raise AssertionError(f"4n b. a scrape lacks {family}")
                if label not in {lab["journal"] for lab, _ in samples["metrics_tpu_session_cursor"]}:
                    raise AssertionError("4n b. a scrape lacks the session's gauges")
            if updates_seen != sorted(updates_seen) or any(h["status"] != "ok" for h in healthz):
                raise AssertionError(f"4n b. updates went back ({updates_seen}) or /healthz was not ok")
            metrics_ms = [ms for path, ms, _ in scrapes if path == "/metrics"]
            healthz_ms = [ms for path, ms, _ in scrapes if path == "/healthz"]
            out["scrapes"] = {"metrics": len(metrics), "healthz": len(healthz), "serve_steps": served,
                              "metrics_ms_median": float(np.median(metrics_ms)), "metrics_ms_max": max(metrics_ms),
                              "healthz_ms_median": float(np.median(healthz_ms)), "healthz_ms_max": max(healthz_ms),
                              "updates_first_last": [updates_seen[0], updates_seen[-1]]}
            print(f"4n b. [{card}] {len(metrics)} /metrics and {len(healthz)} /healthz scrapes (urllib on 127.0.0.1,"
                  f" port {ex.port} from the OS) beside {served} serve-loop steps of a {tenants}-tenant cohort"
                  f" through an AsyncServingEngine and {len(session_batches)} session steps: each parsed, {tenants}"
                  f" tenants a scrape with whole steps (updates {updates_seen[0]}..{updates_seen[-1]}, rows ="
                  f" {rows_per_step} x updates), session and compile families present, /healthz ok; scrape ms"
                  f" /metrics median {out['scrapes']['metrics_ms_median']:.3f} max {max(metrics_ms):.3f}, /healthz"
                  f" median {out['scrapes']['healthz_ms_median']:.3f} max {max(healthz_ms):.3f} (host clock)")

            # c. /healthz after an injected SLO breach
            breach = ServingSLO(e2e_p99_ms=1e-6, sustain=1, name="smoke-breach")
            breach.evaluate()
            probe = json.loads(get(base + "/healthz"))
            verdicts = {v["name"]: v for v in probe.get("serving_slo", {}).get("slos", [])}
            if probe["status"] != "degraded" or not verdicts.get("smoke-breach", {}).get("breaching"):
                raise AssertionError(f"4n c. /healthz after an injected breach: {probe}")
            del breach
            gc.collect()
            if json.loads(get(base + "/healthz"))["status"] != "ok":
                raise AssertionError("4n c. /healthz stayed degraded after the breaching SLO was dropped")
            print(f"4n c. [{card}] /healthz degraded after an injected SLO breach (smoke-breach, e2e burn"
                  f" {verdicts['smoke-breach']['burns']['e2e']:.3g}), ok again once it is dropped")

            # d. the serve-loop step with and without a concurrent scrape, in turns
            scraping, stop = threading.Event(), threading.Event()

            def background_scraper():
                while not stop.is_set():
                    if scraping.wait(0.05):
                        get(base + "/metrics")

            bg = threading.Thread(target=background_scraper, daemon=True)
            bg.start()
            step_ms = {False: [], True: []}
            try:
                for i in range(2 * EXPORTER_STEP_PAIRS + 2):
                    on = bool(i % 2) if (i // 2) % 2 else not (i % 2)
                    (scraping.set if on else scraping.clear)()
                    time.sleep(0.002)
                    caller_sync()
                    t1 = time.perf_counter()
                    pipe.forward(*waves[i % len(waves)])
                    pipe.drain(timeout_s=EXPORTER_TIMEOUT_S)
                    caller_sync()
                    if i >= 2:
                        step_ms[on].append((time.perf_counter() - t1) * 1e3)
            finally:
                stop.set()
                scraping.set()
                bg.join(EXPORTER_TIMEOUT_S)
            out["serve_step_ms"] = {"without_scrape": float(np.median(step_ms[False])),
                                    "with_scrape": float(np.median(step_ms[True]))}
            print(f"4n d. [{card}] serve-loop step (forward + drain, host clock ending in a synchronize, median of"
                  f" {EXPORTER_STEP_PAIRS}, in turns): {out['serve_step_ms']['without_scrape']:.3f} ms without a"
                  f" concurrent scrape, {out['serve_step_ms']['with_scrape']:.3f} ms with one")

            # e. a forward returns while a scrape waits on the health read (behind a device sleep)
            probe_start, probe_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            probe_start.record()
            torch.cuda._sleep(SERVING_SLEEP_PROBE_CYCLES)
            probe_end.record()
            probe_end.synchronize()
            cycles = int(SERVING_SLEEP_PROBE_CYCLES * EXPORTER_HOLD_MS / probe_start.elapsed_time(probe_end))
            real_dispatch = pipe._dispatch
            held = {}
            for how, read in (("pinned", pinned_read), ("pageable", paged_read)):
                reading, dispatched = threading.Event(), threading.Event()

                def watched(mirror, tensors, ready, read=read, reading=reading):
                    if mirror is cohort._health_mirror:
                        reading.set()
                    return read(mirror, tensors, ready)

                def hold(args, kwargs, dispatched=dispatched):
                    torch.cuda._sleep(cycles)
                    result = real_dispatch(args, kwargs)
                    dispatched.set()
                    return result

                pipe.drain(timeout_s=EXPORTER_TIMEOUT_S)
                pipe._dispatch = hold
                _HostMirror.read = watched
                try:
                    pipe.forward(*waves[0])
                    if not dispatched.wait(EXPORTER_TIMEOUT_S):
                        raise AssertionError("4n e. the worker never dispatched")
                    done = []
                    waiter = threading.Thread(target=lambda: done.append((get(base + "/metrics"),
                                                                          time.perf_counter())), daemon=True)
                    waiter.start()
                    if not reading.wait(EXPORTER_TIMEOUT_S):
                        raise AssertionError("4n e. the scrape never read the cohort's health")
                    time.sleep(0.01)  # the scrape now waits on the worker's step
                    t1 = time.perf_counter()
                    pipe.forward(*waves[1])
                    t_returned = time.perf_counter()
                    torch.ones(1 << 20, device=dev).add_(1)  # the serve loop's next allocation and launch
                    t_launched = time.perf_counter()
                    waiter.join(EXPORTER_TIMEOUT_S)
                    if not done:
                        raise AssertionError("4n e. the scrape hung")
                    pipe.drain(timeout_s=EXPORTER_TIMEOUT_S)
                finally:
                    pipe._dispatch = real_dispatch
                    _HostMirror.read = pinned_read
                held[how] = {"forward_ms": (t_returned - t1) * 1e3, "launch_ms": (t_launched - t_returned) * 1e3,
                             "returned_before_scrape_ms": (done[0][1] - t_launched) * 1e3}
                if how == "pinned":
                    samples = obs.parse_prometheus_text(done[0][0])
                    updates = set(tenant_rows(samples, cid, "updates").values())
                    if held[how]["returned_before_scrape_ms"] < 10.0 or updates != {cohort._steps - 1}:
                        raise AssertionError(f"4n e. with the pinned read: {held[how]}, the scrape read updates"
                                             f" {updates}, the step it waited on was {cohort._steps - 1}")

            # the health read alone on an idle card, pinned against pageable, in turns
            read_ms = {"pinned": [], "pageable": []}
            for i in range(20):
                for how, read in (("pinned", pinned_read), ("pageable", paged_read))[:: 1 if i % 2 else -1]:
                    _HostMirror.read = read
                    try:
                        caller_sync()
                        t1 = time.perf_counter()
                        cohort.health()
                        read_ms[how].append((time.perf_counter() - t1) * 1e3)
                    finally:
                        _HostMirror.read = pinned_read
            out["health_read"] = {"held_step": held, "idle_read_ms": {k: float(np.median(v)) for k, v in read_ms.items()},
                                  "hold_ms": EXPORTER_HOLD_MS}
            print(f"4n e. [{card}] a worker step held behind a {EXPORTER_HOLD_MS:.0f} ms device sleep, a /metrics scrape"
                  " waiting on its health event: with the pinned read the serve loop's forward took"
                  f" {held['pinned']['forward_ms']:.3f} ms and an allocation and launch"
                  f" {held['pinned']['launch_ms']:.3f} ms, returned {held['pinned']['returned_before_scrape_ms']:.1f}"
                  " ms before the scrape (which read the step it waited on); with the same read into pageable"
                  f" memory: {held['pageable']['forward_ms']:.3f} / {held['pageable']['launch_ms']:.3f} ms,"
                  f" {held['pageable']['returned_before_scrape_ms']:+.1f} ms; health() alone on an idle card"
                  f" {out['health_read']['idle_read_ms']['pinned']:.3f} ms pinned,"
                  f" {out['health_read']['idle_read_ms']['pageable']:.3f} ms pageable (median of 20, in turns)")

            # f. the ledger: cold builds = signatures built, a forced LRU eviction = one warm build
            col = leg()
            col(*leg_batches[0])  # the engine exists after the first step
            engines.append(col._engine)
            col._engine._cache_size = 1
            half = (leg_batches[1][0][: BATCH // 2], leg_batches[1][1][: BATCH // 2])
            before = (tel.counters.get("engine.compile.cold", 0), tel.counters.get("engine.compile.warm", 0))
            col(*half)  # cold, evicts the full-batch signature
            col(*leg_batches[2])  # warm: built before, evicted since
            after = (tel.counters.get("engine.compile.cold", 0), tel.counters.get("engine.compile.warm", 0))
            if (after[0] - before[0], after[1] - before[1]) != (1, 1):
                raise AssertionError(f"4n f. cold / warm builds {before} -> {after}; want one each")
            built = sum(e.trace_count for e in engines)
            seen = sum(len(e._seen_signatures) for e in engines)
            counted = (tel.counters.get("engine.compile.cold", 0), tel.counters.get("engine.compile.warm", 0))
            hist = tel.snapshot()["histograms"]["engine.compile_ms"]
            if counted != (seen, built - seen) or hist["count"] != built \
                    or tel.gauges["engine.programs.warm"] != counted[1]:
                raise AssertionError(f"4n f. cold / warm {counted}, {seen} signatures in {built} builds,"
                                     f" {hist['count']} observed")
            entries = ledger.entries()
            mine = [e for e in entries if e["engine"] == col._engine._watch_key]
            if sorted((e["compiles"], e["cold_compiles"], e["warm_compiles"]) for e in mine) != [(1, 1, 0), (2, 1, 1)]:
                raise AssertionError(f"4n f. the leg's ledger entries {mine}")
            out["ledger"] = {"cold": counted[0], "warm": counted[1], "builds": built,
                             "compile_ms": {f"{e['kind']} {e['engine']} {e['fingerprint']}":
                                            e["compile_ms_total"] / e["compiles"] for e in entries}}
            print(f"4n f. [{card}] engine.compile.cold {counted[0]} = the signatures built, a forced LRU eviction"
                  f" counted 1 warm build ({counted[1]} in all, {built} builds observed in engine.compile_ms); the"
                  f" ledger's programs, engine.compile_ms per build (warm-up, capture and the first replay's"
                  " enqueue, host clock): " + "; ".join(
                      f"{e['kind']} {e['engine']} {e['compile_ms_total'] / e['compiles']:.1f} ms x {e['compiles']}"
                      for e in entries))

            # g. the session's compute(): one tie_scan launch, against float64 and the plain version
            session.flush_checkpoints()
            zero = scan.launches
            got = session.compute()
            launches = scan.launches - zero
            auroc = session.metric["AUROC"]
            preds = torch.cat(list(auroc.preds))
            rel = torch.cat(list(auroc.target)) == 1
            key_s, pay_s = _co_sort(preds, rel.to(torch.float32))
            stats = tie_scan.tie_group_reduce_reference(key_s, pay_s).double()
            plain_auroc = float(stats[0] / stats[2] / stats[3])
            oracle = _oracle_auroc(preds.cpu().numpy(), rel.cpu().numpy())
            value = float(got["AUROC"])
            if launches != 1 or preds.numel() != MAIN_N or abs(value - oracle) > ORACLE_TOL \
                    or abs(value - plain_auroc) > SCORE_TOL:
                raise AssertionError(f"4n g. session compute: {launches} tie_scan launches over {preds.numel()}"
                                     f" rows, AUROC {value} vs float64 {oracle} and plain {plain_auroc}")
            out["session"] = {"rows": preds.numel(), "tie_scan_launches": launches, "auroc": value,
                              "err_float64": abs(value - oracle), "err_plain": abs(value - plain_auroc),
                              "checkpoints": session.stats["checkpoints"]}
            print(f"4n g. [{card}] EvalSession(background_checkpoints=True) over the north-star collection,"
                  f" {len(session_batches)} steps of {BATCH} beside the serve loop: compute() over {preds.numel()}"
                  f" rows, 1 tie_scan launch, AUROC within {abs(value - oracle):.2g} of float64 and"
                  f" {abs(value - plain_auroc):.2g} of the plain scan (ops/tie_scan.py::tie_group_reduce_reference),"
                  f" {session.stats['checkpoints']} background checkpoints")
    finally:
        for thing in opened:
            thing.close()
        _HostMirror.read = pinned_read
    return out


def _fleet_wave(keys, step):
    """The failover leg's rows (``bench.py:829-838``): 2 rows x 8 features a
    tenant, host arrays as a feeder hands them over."""
    base = np.asarray(keys, dtype=np.float64)[:, None, None]
    preds = (base * 1e-4 + step * 0.125 + np.arange(FLEET_FEATURES) * 0.01).astype(np.float32)
    preds = np.broadcast_to(preds, (len(keys), FLEET_ROWS, FLEET_FEATURES)).copy()
    target = np.broadcast_to((base * 2e-4).astype(np.float32), preds.shape).copy()
    return preds, target


def _fleet_feed(shards, steps, only=None):
    for step in steps:
        for sh in shards:
            keys = list(sh.tenants())
            if keys and (only is None or sh.name in only):
                sh.submit_wave(step, keys, *_fleet_wave(keys, step))


def _fleet_on_card(dev, shards, when, phase="4o"):
    for sh in shards:
        for member, d in sh.cohort._states.items():
            for sname, v in d.items():
                if v.device.type != dev.type:
                    raise AssertionError(f"{phase}: shard {sh.name}'s {member}.{sname} lies on {v.device} {when}")


def _fleet_by_key(torch, dev, shards, total):
    """Every tenant's stacked states gathered by fleet key on the card;
    raises unless each of ``range(total)`` lives on exactly one shard."""
    out, owners = {}, np.zeros(total, dtype=np.int64)
    for sh in shards:
        keys = list(sh.tenants())
        if not keys:
            continue
        owners[keys] += 1
        idx = torch.as_tensor(keys, device=dev)
        slots = torch.as_tensor([sh.slot_of(k) for k in keys], device=dev)
        for member, d in sh.cohort._states.items():
            for sname, v in d.items():
                dest = out.setdefault(f"{member}.{sname}",
                                      torch.zeros((total,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev))
                dest[idx] = v[slots]
    if not (owners == 1).all():
        raise AssertionError(f"4o: {int((owners == 0).sum())} tenants lost, {int((owners > 1).sum())} on two shards")
    return out


def _fleet_bit_equal(torch, got, want, what):
    if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
        bad = [k for k in want if k in got and not torch.equal(got[k], want[k])]
        raise AssertionError(f"4o {what}: states differ from the twin's in {bad or sorted(set(got) ^ set(want))}")


def _fleet_phase(torch, dev, card):
    """Phase 4o's first part, the fleet's moves on the card: placement churn
    (a), 24 handoffs (b), partial waves (e), a full wave's device work (h)
    and the migrated AUROC tenant (f). Returns its ``fleet_*`` timings;
    removes the directories it writes."""
    import gc
    import hashlib
    import itertools
    import tempfile

    from metrics_tpu_torch import AUROC, MeanSquaredError
    from metrics_tpu_torch.fleet import FleetPlacement, FleetShard, MigrationCoordinator, adopt_into, tenant_envelope
    from metrics_tpu_torch.ops import tie_scan
    from metrics_tpu_torch.ops.auroc_kernel import _co_sort
    from metrics_tpu_torch.parallel.backend import SingleProcessBackend
    from metrics_tpu_torch.reliability.checkpoint import envelope_from_bytes, envelope_to_bytes

    gc.collect()  # earlier phases' cohorts leave the weak registries
    out = {"fleet_card": card}
    scan = tie_scan.tie_group_reduce
    n = FLEET_TENANTS
    phase_t0 = time.perf_counter()

    # a. placement churn at 10,000 keys (bench.py:699-707), against the
    # rendezvous rule computed here from hashlib alone
    place = FleetPlacement(["shard-0", "shard-1"])
    homes = [place.assign(k) for k in range(n)]
    t0 = time.perf_counter()
    place.add_shard("shard-2")
    moved = sum(1 for k in range(n) if place.assign(k) != homes[k])
    reassign_ms = (time.perf_counter() - t0) * 1e3

    def hrw(names, k):
        return max(names, key=lambda s: int.from_bytes(
            hashlib.blake2b(f"{s}\x00{k}".encode(), digest_size=8).digest(), "big"))

    two, three = ["shard-0", "shard-1"], ["shard-0", "shard-1", "shard-2"]
    ref_moved = sum(1 for k in range(n) if hrw(two, k) != hrw(three, k))
    churn = moved / n
    if moved != ref_moved or not 0 < churn <= 0.45:
        raise AssertionError(f"4o a. churn {moved} / {n} (rendezvous rule: {ref_moved}); bar <= 0.45")
    out.update(fleet_churn_ratio_10k=churn, fleet_reassign_10k_ms=reassign_ms)
    print(f"4o a. [{card}] placement: {moved} of {n} keys move to a third shard (churn {churn:.4f}, bar 0.45,"
          f" equal to the rendezvous rule's count), rescan {reassign_ms:.1f} ms (host)")

    with tempfile.TemporaryDirectory(prefix="fleet-") as root:
        def shard(name):
            return FleetShard(name, MeanSquaredError(), os.path.join(root, name))

        # b. 24 two-phase handoffs between two live shards after one warm-up move (bench.py:709-726)
        src, dst = shard("b-src"), shard("b-dst")
        keys = list(range(FLEET_MOVES + 1))
        src.add_tenants(keys)
        rs = np.random.RandomState(SEED)
        src.submit_wave(0, keys, *(torch.from_numpy(rs.rand(len(keys), 64).astype(np.float32)).to(dev)
                                   for _ in range(2)))
        src.checkpoint()
        before = _fleet_by_key(torch, dev, [src], len(keys))
        coord = MigrationCoordinator(FleetPlacement(["b-src", "b-dst"]), [src, dst])
        coord.migrate(keys[0], "b-dst")  # warm-up: the first checkpoints and programs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in keys[1:]:
            coord.migrate(k, "b-dst")
        torch.cuda.synchronize()
        per_tenant_ms = (time.perf_counter() - t0) * 1e3 / FLEET_MOVES
        _fleet_bit_equal(torch, _fleet_by_key(torch, dev, [src, dst], len(keys)), before, "b. moved tenants")
        if len(src) or dst.tenants() != tuple(keys) or any(dst.cursor_of(k) != 0 for k in keys):
            raise AssertionError(f"4o b. after the moves: src {src.tenants()}, dst {dst.tenants()}")
        _fleet_on_card(dev, [src, dst], "after adoption")
        out["fleet_migration_ms_per_tenant"] = per_tenant_ms
        print(f"4o b. [{card}] {FLEET_MOVES} two-phase handoffs (drain, envelope, wire bytes, target import and"
              f" commit, source GC and commit) {per_tenant_ms:.2f} ms a tenant; every tenant on exactly one side,"
              " states bit-equal, cohorts on the card")

        # e. partial waves, bit for bit the full-shard dispatch
        part, full = shard("e-part"), shard("e-full")
        keys = list(range(FLEET_PARTIAL_N))
        for sh in (part, full):
            sh.add_tenants(keys)
            sh.submit_wave(0, keys, *_fleet_wave(keys, 0))
        sizes = {"1": 1, "3": 3, "half": FLEET_PARTIAL_N // 2, "all_but_one": FLEET_PARTIAL_N - 1}
        for step, (label, size) in enumerate(sizes.items(), start=1):
            subset = sorted(np.random.RandomState(SEED + step).choice(FLEET_PARTIAL_N, size, replace=False).tolist())
            rest = sorted(set(keys) - set(subset))
            part.submit_wave(step, subset[::-1], *_fleet_wave(subset[::-1], step))
            part.submit_wave(step, rest, *_fleet_wave(rest, step))
            full.submit_wave(step, keys, *_fleet_wave(keys, step))
            _fleet_bit_equal(torch, _fleet_by_key(torch, dev, [part], FLEET_PARTIAL_N),
                             _fleet_by_key(torch, dev, [full], FLEET_PARTIAL_N), f"e. after a partial wave of {label}")
        for sh in (part, full):  # a full wave replayed after the partial ones reads their rows
            sh.submit_wave(len(sizes) + 1, keys, *_fleet_wave(keys, len(sizes) + 1))
        _fleet_bit_equal(torch, _fleet_by_key(torch, dev, [part], FLEET_PARTIAL_N),
                         _fleet_by_key(torch, dev, [full], FLEET_PARTIAL_N), "e. a full wave after")
        # capacity grown through migrations in, and shrunk through a restore
        src, dst, twin = shard("e-src"), shard("e-dst"), shard("e-twin")
        for sh in (src, twin):
            sh.add_tenants(keys)
            sh.submit_wave(0, keys, *_fleet_wave(keys, 0))
        coord = MigrationCoordinator(FleetPlacement(["e-src", "e-dst"]), [src, dst])
        moved = keys[::97][:40]
        for k in moved:
            coord.migrate(k, "e-dst")
        stay = sorted(set(keys) - set(moved))
        for sh, ks in ((dst, moved), (src, stay)):
            sh.submit_wave(1, ks[1::2], *_fleet_wave(ks[1::2], 1))
            sh.submit_wave(1, ks, *_fleet_wave(ks, 1))
        twin.submit_wave(1, keys, *_fleet_wave(keys, 1))
        _fleet_bit_equal(torch, _fleet_by_key(torch, dev, [src, dst], FLEET_PARTIAL_N),
                         _fleet_by_key(torch, dev, [twin], FLEET_PARTIAL_N),
                         f"e. at capacities {src.cohort.capacity} and {dst.cohort.capacity} (grown)")
        grown = shard("e-src")
        grown.add_tenants(range(10 * FLEET_PARTIAL_N, 10 * FLEET_PARTIAL_N + 9_000))
        grown_cap = grown.cohort.capacity
        if not grown.restore() or grown.cohort.capacity >= grown_cap or grown.tenants() != tuple(stay):
            raise AssertionError(f"4o e. restore() left capacity {grown.cohort.capacity} (grown to {grown_cap})")
        _fleet_on_card(dev, [grown], "after restore()")
        grown.submit_wave(1, stay, *_fleet_wave(stay, 1))  # the restored generation predates step 1
        half = stay[: len(stay) // 2]
        grown.submit_wave(2, half, *_fleet_wave(half, 2))
        grown.submit_wave(2, stay, *_fleet_wave(stay, 2))
        twin.submit_wave(2, keys, *_fleet_wave(keys, 2))
        live = torch.as_tensor(stay, device=dev)
        want = {k: v[live] for k, v in _fleet_by_key(torch, dev, [twin], FLEET_PARTIAL_N).items()}
        slots = torch.as_tensor([grown.slot_of(k) for k in stay], device=dev)
        got = {f"{m}.{s}": v[slots] for m, d in grown.cohort._states.items() for s, v in d.items()}
        _fleet_bit_equal(torch, got, want, f"e. at capacity {grown.cohort.capacity} (shrunk from {grown_cap})")
        out["fleet_partial_capacities"] = {"shard": full.cohort.capacity, "grown": dst.cohort.capacity,
                                           "shrunk": grown.cohort.capacity}
        print(f"4o e. [{card}] partial waves of 1, 3, {FLEET_PARTIAL_N // 2} and {FLEET_PARTIAL_N - 1} of"
              f" {FLEET_PARTIAL_N} tenants (capacity {full.cohort.capacity}), a full wave after them, and partial"
              f" waves at capacity {dst.cohort.capacity} (grown by 40 migrations) and {grown.cohort.capacity}"
              f" (restored down from {grown_cap}): every tenant bit-equal to the full-shard dispatch")

        # h. a full wave through FleetShard.submit_wave runs the cohort's own device work
        p_dev, t_dev = (torch.from_numpy(a).to(dev) for a in _fleet_wave(keys, 0))
        steps = itertools.count(1_000)
        # traced in turns: the pair of a round that holds the same device records
        try:
            via_fleet, bare, rounds = _paired_device_ops(
                torch, lambda: full.submit_wave(next(steps), keys, p_dev, t_dev), lambda: full.cohort(p_dev, t_dev))
        except AssertionError as err:
            raise AssertionError(f"4o h. a full wave through submit_wave and the cohort stepped bare: {err}") from None
        if via_fleet != bare:  # the same records, so never; kept for the record
            raise AssertionError(f"4o h. a full wave through submit_wave ran {via_fleet} kernels and copies, the"
                                 f" cohort stepped bare {bare}")
        out["fleet_full_wave_ops"] = {"submit_wave": list(via_fleet), "cohort": list(bare), "rounds_spoiled": rounds}
        print(f"4o h. [{card}] one full wave of {FLEET_PARTIAL_N} tenants: {via_fleet[0]} kernels and {via_fleet[1]}"
              " copies through FleetShard.submit_wave, the same device records as the cohort stepped bare (traced in"
              " turns)" + (f"; rounds that disagreed first: {rounds}" if rounds else ""))

    # f. a binary AUROC tenant at the north-star size migrates as an eager tenant
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    home = AUROC(pos_label=1)
    for _ in range(BATCHES):
        p = torch.rand(BATCH, generator=gen, device=dev)
        home.update(p, (torch.rand(BATCH, generator=gen, device=dev) < p).to(torch.int32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = envelope_to_bytes(tenant_envelope(home, 4242, cursor=BATCHES - 1))
    wire = SingleProcessBackend().stream(torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev))
    if wire.device.type != dev.type or wire.dtype != torch.uint8:
        raise AssertionError(f"4o f. the envelope crossed the wire as {wire.dtype} on {wire.device}")
    moved = AUROC(pos_label=1)
    cursor = adopt_into(moved, envelope_from_bytes(wire.cpu().numpy().tobytes()))
    torch.cuda.synchronize()
    move_ms = (time.perf_counter() - t0) * 1e3
    zero = scan.launches
    value = moved.compute()
    launches = scan.launches - zero
    want = home.compute()
    preds = torch.cat(list(moved.preds))
    rel = torch.cat(list(moved.target)) == 1
    key_s, pay_s = _co_sort(preds, rel.to(torch.float32))
    stats = tie_scan.tie_group_reduce_reference(key_s, pay_s).double()
    plain = float(stats[0] / stats[2] / stats[3])
    oracle = _oracle_auroc(preds.cpu().numpy(), rel.cpu().numpy())
    if launches != 1 or cursor != BATCHES - 1 or not torch.equal(value, want) or preds.numel() != MAIN_N \
            or abs(float(value) - plain) > SCORE_TOL or abs(float(value) - oracle) > ORACLE_TOL:
        raise AssertionError(f"4o f. moved AUROC tenant: {launches} tie_scan launches, {float(value)} vs unmoved"
                             f" {float(want)}, plain {plain}, float64 {oracle}")
    out.update(fleet_auroc_move_ms=move_ms, fleet_auroc_envelope_bytes=len(blob),
               fleet_auroc_tie_scan_launches=launches, fleet_auroc_err_plain=abs(float(value) - plain),
               fleet_auroc_err_float64=abs(float(value) - oracle))
    print(f"4o f. [{card}] an AUROC tenant of {preds.numel()} predictions moved as an eager tenant (envelope of"
          f" {len(blob)} bytes through SingleProcessBackend.stream as a CUDA uint8 tensor, adopt_into) in"
          f" {move_ms:.1f} ms; its compute() launched tie_scan {launches} time, bit-equal to the unmoved tenant's,"
          f" within {abs(float(value) - plain):.2g} of the plain scan and {abs(float(value) - oracle):.2g} of"
          " float64")
    out["fleet_moves_phase_s"] = time.perf_counter() - phase_t0
    return out


def _fleet_failover_phase(torch, dev, card):
    """Phase 4o's second part, run last: the JAX bench's failover leg (c)
    with ``/metrics`` of the live fleet (g), and a kill at every yield point
    mid-rebalance (d), at ``FLEET_FAILOVER_TENANTS`` (300) tenants over the
    bench's 3 leased shards, rows, steps, redelivery window and kill points.
    Returns its ``fleet_*`` timings; removes the directories it writes and
    turns the exporter off."""
    import gc
    import tempfile
    import urllib.request

    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch import MeanSquaredError
    from metrics_tpu_torch.fleet import (
        FleetPlacement,
        FleetRebalancer,
        FleetShard,
        LeaseAuthority,
        MigrationCoordinator,
        ShardReplicator,
    )
    from metrics_tpu_torch.observability.exporter import parse_prometheus_text
    from metrics_tpu_torch.reliability.faultinject import Preempted, kill_at_migration_phase
    from metrics_tpu_torch.serving import IngestQueue

    gc.collect()
    out = {}
    n = FLEET_FAILOVER_TENANTS
    phase_t0 = time.perf_counter()

    def ms_since(t):
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    with tempfile.TemporaryDirectory(prefix="fleet-") as root:
        def shard(name, where):
            return FleetShard(name, MeanSquaredError(), os.path.join(root, where, name))

        # c. the failover leg (bench.py:756-915) at FLEET_FAILOVER_TENANTS
        names = ["s0", "s1", "s2"]
        placement = FleetPlacement(names)
        shards = {nm: shard(nm, "c") for nm in names}
        twin = [shard(nm, "c-twin") for nm in names]
        by_shard = {nm: [] for nm in names}
        for k in range(n):
            by_shard[placement.assign(k)].append(k)
        for i, nm in enumerate(names):
            shards[nm].add_tenants(by_shard[nm])
            twin[i].add_tenants(by_shard[nm])
        coord = MigrationCoordinator(placement, shards.values())
        auth = LeaseAuthority(ttl_s=3600.0)  # failover is driven, not timed out (bench.py:808-811)
        for sh in shards.values():
            sh.attach_lease(auth)
        rep = ShardReplicator(coord, authority=auth)
        reb = FleetRebalancer(coord, replicator=rep, authority=auth)
        _fleet_feed(shards.values(), (0, 1))
        for sh in shards.values():
            sh.checkpoint()
        t0 = time.perf_counter()
        for sh in shards.values():
            rep.replicate(sh)
        first_ms = ms_since(t0)
        _fleet_feed(shards.values(), (2, 3))
        t0 = time.perf_counter()
        for sh in shards.values():
            sh.checkpoint()
        commit_ms = ms_since(t0)
        t0 = time.perf_counter()
        for sh in shards.values():
            rep.replicate(sh)
        delta_ms = ms_since(t0)
        lag = rep.lag()
        if lag != 0:
            raise AssertionError(f"4o c. steady replication lag {lag} after a commit and a delta cycle")

        def scrape(port, label):
            """g. the six fleet families of a live ``/metrics`` scrape against the stats."""
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=EXPORTER_TIMEOUT_S) as r:
                samples = parse_prometheus_text(r.read().decode())
            fid = str(coord.export_id)
            want = {
                "metrics_tpu_fleet_placement_generation": {None: float(placement.generation)},
                "metrics_tpu_fleet_migrations_total": {k: float(v) for k, v in coord.migrations_by_shard().items()},
                "metrics_tpu_fleet_tenants_in_flight": {nm: 0.0 for nm in coord.shards},
                "metrics_tpu_fleet_shard_epoch": {nm: float(sh.epoch) for nm, sh in coord.shards.items()},
                "metrics_tpu_fleet_shard_replication_lag": {k: float(v) for k, v in rep.lag_by_shard().items()},
                "metrics_tpu_fleet_failovers": {None: float(rep.stats["failovers"])},
            }
            got = {name: {lbl.get("shard"): v for lbl, v in samples[name] if lbl["fleet"] == fid} for name in want}
            if got != want:
                raise AssertionError(f"4o g. {label}: /metrics fleet families {got}, the stats hold {want}")

        dead = "s0"
        dead_keys = by_shard[dead]
        slot_of = {k: shards[dead].slot_of(k) for k in dead_keys}
        key_of = {s: k for k, s in slot_of.items()}
        q = IngestQueue(shards[dead].cohort, rows_per_step=FLEET_ROWS, coalesce_max=1,
                        redelivery_window=FLEET_REDELIVERY_WINDOW)
        ids = np.repeat(np.asarray([slot_of[k] for k in dead_keys], dtype=np.int64), FLEET_ROWS)
        for step in (4, 5):
            preds, target = _fleet_wave(dead_keys, step)
            q.submit(ids, preds.reshape(-1, FLEET_FEATURES), target.reshape(-1, FLEET_FEATURES))
            _fleet_feed(shards.values(), [step], only=[nm for nm in names if nm != dead])
        _fleet_feed(twin, range(6))
        first_wave_ms = []

        def resubmit(tids, *arrs):
            step = 4 + len(resubmit.waves)
            resubmit.waves.append(step)
            order = np.argsort(np.asarray(tids), kind="stable")
            keys = [key_of[int(s)] for s in np.asarray(tids)[order][::FLEET_ROWS]]
            blocks = [np.asarray(a)[order].reshape(len(keys), FLEET_ROWS, -1) for a in arrs]
            owners = {}
            for j, k in enumerate(keys):
                owners.setdefault(coord.find_tenant(k), []).append(j)
            for nm, idx in owners.items():
                coord.shards[nm].submit_wave(step, [keys[j] for j in idx], *[b[idx] for b in blocks])
            if not first_wave_ms:
                first_wave_ms.append(ms_since(t0))

        resubmit.waves = []
        with obs.exporter_scope(port=0) as ex:
            t_scrape = time.perf_counter()
            scrape(ex.port, "before the failover")
            scrape_ms = (time.perf_counter() - t_scrape) * 1e3
            t0 = time.perf_counter()
            promoted = reb.failover(dead)
            promote_ms = ms_since(t0)
            redelivered = q.redeliver(submit=resubmit)
            scrape(ex.port, "after the failover")
        expected = 2 * len(dead_keys) * FLEET_ROWS
        deviation = abs(redelivered / expected - 1.0)
        if promoted != len(dead_keys) or redelivered != expected or deviation != 0.0:
            raise AssertionError(f"4o c. promoted {promoted} of {len(dead_keys)}, redelivered {redelivered} rows"
                                 f" of {expected}")
        _fleet_on_card(dev, coord.shards.values(), "after the promotion")
        # the promoted tenants land on grown cohorts: the bit identity below
        # holds across capacity buckets
        capacity = {nm: sh.cohort.capacity for nm, sh in coord.shards.items()}
        twin_capacity = {sh.name: sh.cohort.capacity for sh in twin if sh.name in capacity}
        if not any(capacity[nm] > twin_capacity[nm] for nm in capacity):
            raise AssertionError(f"4o c. promoted capacities {capacity} grew past none of the twin's {twin_capacity}")
        _fleet_bit_equal(torch, _fleet_by_key(torch, dev, coord.shards.values(), n),
                         _fleet_by_key(torch, dev, twin, n), "c. after the redelivered waves")
        out.update(fleet_replicate_first_ms=first_ms, fleet_commit_ms=commit_ms, fleet_replicate_delta_ms=delta_ms,
                   fleet_steady_lag=lag, fleet_failover_promote_ms=promote_ms,
                   fleet_failover_to_first_wave_ms=first_wave_ms[0], fleet_rows_redelivered=redelivered,
                   fleet_redelivery_deviation=deviation, fleet_scrape_ms=scrape_ms,
                   fleet_failover_tenants=n, fleet_promoted_capacity=capacity, fleet_twin_capacity=twin_capacity)
        print(f"4o c. [{card}] failover leg, {n} tenants over 3 shards: first replicate {first_ms:.0f} ms, commit"
              f" {commit_ms:.1f} ms, delta replicate {delta_ms:.0f} ms, steady lag {lag}; failover of {dead}"
              f" ({promoted} tenants promoted) {promote_ms:.0f} ms, to the first redelivered wave"
              f" {first_wave_ms[0]:.0f} ms; {redelivered} rows redelivered (deviation {deviation}); every tenant"
              f" bit-equal to a never-failed twin at promoted capacities {capacity} (the twin's {twin_capacity}),"
              " cohorts on the card")
        print(f"4o g. [{card}] /metrics before and after the failover: the six fleet families equal the"
              f" coordinator's and replicator's stats ({scrape_ms:.1f} ms a scrape)")
        del coord, rep, reb, shards, twin, q

        # d. a kill at every yield point mid-rebalance over FLEET_FAILOVER_TENANTS
        # (test_kill_at_every_phase_and_mid_rebalance_10k at 10,000 on the CPU),
        # recovered from the journals alone
        two = ["s0", "s1"]
        placement = FleetPlacement(two)
        homes = [placement.assign(k) for k in range(n)]

        def build(where):
            built = {nm: shard(nm, where) for nm in two}
            for nm in two:
                built[nm].add_tenants([k for k in range(n) if homes[k] == nm])
            return built

        def reopen(names_):
            fresh = {}
            for nm in names_:
                fresh[nm] = shard(nm, "d")
                fresh[nm].restore()
            return fresh

        shards, twin = build("d"), build("d-twin")
        _fleet_feed(shards.values(), range(4))
        _fleet_feed(twin.values(), range(4))
        for sh in shards.values():
            sh.checkpoint()
        recover_ms = {}
        for i, point in enumerate(MigrationCoordinator.YIELD_POINTS):
            coord = MigrationCoordinator(FleetPlacement(two), list(shards.values()))
            victim = shards["s0"].tenants()[i]
            if point == "recover":
                # strand a handoff first, then kill the recovery that replays it
                with kill_at_migration_phase(coord, "pre_commit"):
                    try:
                        coord.migrate(victim, "s1")
                    except Preempted:
                        pass
                shards = reopen(two)
                coord = MigrationCoordinator(FleetPlacement(two), list(shards.values()))
                with kill_at_migration_phase(coord, "recover") as info:
                    try:
                        coord.recover()
                    except Preempted:
                        pass
            else:
                with kill_at_migration_phase(coord, point) as info:
                    try:
                        coord.migrate(victim, "s1")
                    except Preempted:
                        pass
            if info["kills"] != 1:
                raise AssertionError(f"4o d. the kill at {point} fired {info['kills']} times")
            t0 = time.perf_counter()
            shards = reopen(two)
            coord = MigrationCoordinator(FleetPlacement(two), list(shards.values()))
            outcomes = [o[1] for o in coord.recover()]
            recover_ms[point] = ms_since(t0)
            home = "s1" if point == "pre_gc" else "s0"
            want = [] if point == "prepare" else ["completed"] if point == "pre_gc" else ["aborted"]
            if outcomes != want or not shards[home].has_tenant(victim) or coord.recover() != []:
                raise AssertionError(f"4o d. kill at {point}: recover() gave {outcomes}, tenant {victim} on"
                                     f" {coord.find_tenant(victim)}")
            _fleet_by_key(torch, dev, shards.values(), n)
        three = two + ["s2"]
        shards["s2"] = shard("s2", "d")
        placement.add_shard("s2")
        coord = MigrationCoordinator(placement, list(shards.values()))
        with kill_at_migration_phase(coord, "pre_commit", after=3) as info:
            try:
                FleetRebalancer(coord).converge(max_moves=8)
            except Preempted:
                pass
        shards = reopen(three)
        coord = MigrationCoordinator(FleetPlacement(three), list(shards.values()))
        outcomes = [o[1] for o in coord.recover()]
        if info["kills"] != 1 or len(shards["s2"]) != 3 or outcomes != ["aborted"]:
            raise AssertionError(f"4o d. mid-rebalance: {len(shards['s2'])} moves survived, recover() {outcomes}")
        if FleetRebalancer(coord).converge(max_moves=12) != 12 or len(shards["s2"]) != 15:
            raise AssertionError(f"4o d. the resumed rebalance left {len(shards['s2'])} tenants on s2")
        _fleet_on_card(dev, shards.values(), "after restore()")
        _fleet_feed(shards.values(), range(6))
        skipped = sum(sh.stats["replays_skipped"] for sh in shards.values())
        _fleet_feed(twin.values(), (4, 5))
        if skipped != 4 * n or any(sh.cursor_of(k) != 5 for sh in shards.values() for k in sh.tenants()):
            raise AssertionError(f"4o d. the resubmitted stream skipped {skipped} tenant-steps, want {4 * n}")
        _fleet_bit_equal(torch, _fleet_by_key(torch, dev, shards.values(), n),
                         _fleet_by_key(torch, dev, twin.values(), n), "d. after the resubmitted stream")
        out["fleet_recover_ms"] = recover_ms
        print(f"4o d. [{card}] a kill at each of {', '.join(MigrationCoordinator.YIELD_POINTS)} and mid-rebalance"
              f" over {n} tenants: rebuilt from the journals, recover() left every tenant on exactly one shard,"
              f" the stream resubmitted from step 0 folded each step once ({skipped} skipped), bit-equal to the"
              " twin; rebuild and recover ms " + ", ".join(f"{k} {v:.0f}" for k, v in recover_ms.items()))
    out["fleet_failover_phase_s"] = time.perf_counter() - phase_t0
    return out


def _analysis_phase(torch, dev, card):
    """Phase 4p: the port's host-side analysis passes with every shard's
    cohort on ``dev``. (a) ``explore_crash_consistency`` and
    ``explore_fencing`` over the port's real fleet: no finding, coverage
    equal to a CPU run's and to the committed ``PROTOCOL_BASELINE.json``;
    (b) the three fleet fixtures trip exactly their rules, at or above the
    baseline's ``min_violations``, with the CPU's minimal counterexample;
    (c) the watchdog's cross-link names each fixture's rule; (d)
    ``lint_paths()`` over the checkout's package has no unsuppressed
    finding. Returns its timings."""
    import inspect
    import textwrap

    from metrics_tpu_torch.analysis import fixtures as fx
    from metrics_tpu_torch.analysis import lint_paths, protocol
    from metrics_tpu_torch.analysis.lint import lint_source
    from metrics_tpu_torch.analysis.program import hint_for_watch_key
    from metrics_tpu_torch.analysis.protocol import (
        build_protocol_entry,
        counterexample_report,
        explore_crash_consistency,
        explore_fencing,
        load_protocol_baseline,
    )

    out = {}
    phase_t0 = time.perf_counter()
    where = dev.type
    baseline = load_protocol_baseline()
    entries = baseline.get("entries", {})
    if not {"crash_consistency", "fencing", *baseline.get("fixtures", ())} <= set(entries):
        raise AssertionError(f"4p: PROTOCOL_BASELINE.json lacks entries: {sorted(entries)}")

    # a. the explorers, every shard the explorers rebuild checked on the card
    real_reopen, reopened = protocol._reopen, []

    def reopen_on_card(*args, **kwargs):
        shards = real_reopen(*args, **kwargs)
        _fleet_on_card(dev, shards.values(), "when the explorer rebuilt it", phase="4p")
        reopened.append(len(shards))
        return shards

    protocol._reopen = reopen_on_card
    try:
        t0 = time.perf_counter()
        crash_ev, crash_findings = explore_crash_consistency(device=where)
        out["crash_explorer_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fence_ev, fence_findings = explore_fencing(device=where)
        out["fencing_explorer_s"] = time.perf_counter() - t0
    finally:
        protocol._reopen = real_reopen
    t0 = time.perf_counter()
    cpu_crash_ev, cpu_crash_findings = explore_crash_consistency(device="cpu")
    cpu_fence_ev, cpu_fence_findings = explore_fencing(device="cpu")
    out["cpu_explorers_s"] = time.perf_counter() - t0
    if crash_findings or fence_findings or cpu_crash_findings or cpu_fence_findings:
        raise AssertionError("4p a. the explorers found " + counterexample_report(crash_findings + fence_findings))
    coverage = {"crash_consistency": build_protocol_entry(crash_ev), "fencing": build_protocol_entry(fence_ev)}
    cpu_coverage = {"crash_consistency": build_protocol_entry(cpu_crash_ev),
                    "fencing": build_protocol_entry(cpu_fence_ev)}
    committed = {k: entries[k] for k in coverage}
    if coverage != cpu_coverage or coverage != committed or crash_ev["crash_points"] != cpu_crash_ev["crash_points"]:
        raise AssertionError(f"4p a. coverage {coverage}, on the CPU {cpu_coverage}, committed {committed}")
    out.update(coverage=coverage, shards_rebuilt=sum(reopened))
    print(f"4p a. [{card}] explore_crash_consistency and explore_fencing on the card: no finding; coverage"
          f" {coverage} equal to the CPU's and PROTOCOL_BASELINE.json's; {sum(reopened)} shard rebuilds, every"
          f" cohort on the card; {out['crash_explorer_s']:.2f} s and {out['fencing_explorer_s']:.2f} s"
          f" ({out['cpu_explorers_s']:.2f} s both on the CPU)")

    # b. the fleet fixtures trip exactly their rules
    t0 = time.perf_counter()
    tripped = {}
    runs = {
        "GcBeforeDurableCoordinator": lambda device: explore_crash_consistency(
            coordinator_cls=fx.GcBeforeDurableCoordinator, device=device)[1],
        "UnfencedCheckpointShard": lambda device: explore_fencing(
            shard_cls=fx.UnfencedCheckpointShard, device=device)[1],
    }
    for name, run in runs.items():
        cpu_findings = run("cpu")
        findings = run(where)
        want = entries[name]
        first = counterexample_report(findings).split("\n[1]")[0]
        if ({f.rule for f in findings} != {want["expected_rule"]} or len(findings) < want["min_violations"]
                or len(findings) != len(cpu_findings)
                or first != counterexample_report(cpu_findings).split("\n[1]")[0]):
            raise AssertionError(f"4p b. {name}: {len(findings)} findings {sorted({f.rule for f in findings})}"
                                 f" ({len(cpu_findings)} on the CPU), want {want}")
        tripped[name] = len(findings)
    src = "import json\nimport os\n" + textwrap.dedent(inspect.getsource(fx.NonAtomicManifestWriter))
    stripped = "\n".join(line for line in src.splitlines() if "metrics-tpu: allow" not in line)
    fired = [f for f in lint_source(stripped, "analysis/fixtures.py") if not f.suppressed]
    want = entries["NonAtomicManifestWriter"]
    if {f.rule for f in fired} != {want["expected_rule"]} or len(fired) < want["min_violations"]:
        raise AssertionError(f"4p b. NonAtomicManifestWriter fired {[str(f) for f in fired]}, want {want}")
    tripped["NonAtomicManifestWriter"] = len(fired)
    out["fixtures_s"] = time.perf_counter() - t0
    out["fixture_violations"] = tripped
    print(f"4p b. [{card}] the fleet fixtures trip exactly MTA013, MTA014 and MTL107 ({tripped}), each at or"
          " above its min_violations, the first counterexample the CPU's"
          f" ({out['fixtures_s']:.2f} s with the CPU runs)")

    # c. the watchdog's cross-link
    for name, rule in (("GcBeforeDurableCoordinator", "MTA013"), ("UnfencedCheckpointShard", "MTA014")):
        hint = hint_for_watch_key(f"engine[{name}]@cohort")
        if hint is None or rule not in hint:
            raise AssertionError(f"4p c. the hint for {name}: {hint!r}")
    print("4p c. the watchdog's hint names MTA013 and MTA014 for the fixtures' classes")

    # d. the lint over the package this run imports
    t0 = time.perf_counter()
    findings = lint_paths()
    out["lint_s"] = time.perf_counter() - t0
    live = [str(f) for f in findings if not f.suppressed]
    if live:
        raise AssertionError(f"4p d. {len(live)} unsuppressed lint findings: {live}")
    out["lint_suppressed"] = len(findings)
    print(f"4p d. lint_paths() over {os.path.dirname(protocol.__file__).rsplit(os.sep, 1)[0]} under Python"
          f" {sys.version.split()[0]}: no unsuppressed finding, {len(findings)} suppressed, {out['lint_s']:.2f} s")
    out["phase_s"] = time.perf_counter() - phase_t0
    return out


#: the metric fixtures of the program audit and the rule each trips alone
AUDIT_FIXTURE_RULES = {
    "NarrowAccumulator": "MTA001", "SuppressedNarrowAccumulator": "MTA001", "CallbackInJit": "MTA002",
    "HostSyncUpdate": "MTA002", "DonatedAlias": "MTA003", "NonCommutativeMerge": "MTA004",
    "MeanWithoutCount": "MTA004", "UnscaledInt8Psum": "MTA004", "ReplicaDependentCount": "MTA005",
    "NonIdentityReset": "MTA006", "ComputeMutatesState": "MTA006", "OrphanResidual": "MTA006",
    "UntouchedStatePassthrough": "MTA007", "UnownedLoader": "MTA007", "StaleSuppression": "MTL105",
    "SeamRegressor": "MTA008", "DoubleBufferAliaser": "MTA009", "HostReadOfDonated": "MTA009",
    "Int32RowCounter": "MTA010", "CancellingVariance": "MTA011", "EpsilonThresholdAUROC": "MTA012",
    # the positive control of the quantized merge probe: no finding
    "BlockScaledQuantizedSync": None,
}
#: the registry's suppressed findings by (rule, kind): the int32 families'
#: MTA010 floor findings and R2Score's MTA011 budget finding (its allow:
#: NUMERICS_BASELINE.json's 2^-19 is below what its formula measures)
AUDIT_SUPPRESSED = {**{("MTA010", k): 24 for k in ("base", "cohort", "int8", "bf16")},
                    **{("MTA011", k): 1 for k in ("base", "cohort", "int8", "bf16")}}
#: families whose exact tier sums log1p terms: the audit's 8-ulp allowance
AUDIT_ULP_FAMILIES = ("MeanSquaredLogError",)


def _audit_verdicts(report):
    """Per family of an ``audit_registry`` report: eligibility, findings,
    suppressions, MTA005 replica counts and bit-identity verdicts (flat and
    two-level), fingerprints, and pass 4's seam budget and double-buffer
    verdict (safe, hazard kinds)."""
    def rules(entry, bucket):
        return sorted((f["rule"], f["subject"]) for f in entry[bucket])

    verdicts = {}
    for fam, entry in report["families"].items():
        ev = entry["distributed"]
        bits = None if ev is None else (ev["bit_identical"], (ev.get("topology") or {}).get("bit_identical"))
        verdicts[fam] = {
            "eligible": entry["engine_eligible"], "findings": rules(entry, "findings"),
            "suppressed": rules(entry, "suppressed"), "replicas": None if ev is None else ev["replicas"],
            "bits": bits, "fingerprints": report.get("fingerprints", {}).get(fam),
            "host_seam": (entry["evidence"] or {}).get("host_seam"),
            "double_buffer": _double_buffer_verdict(entry),
            "numerics": _numerics_verdict(entry),
        }
    return verdicts


def _numerics_verdict(entry):
    """Pass 5's evidence of a report entry without the measured budget's
    value (float rounding may differ between devices): horizons, sites,
    the float64 verdict, skipped probes, whether a budget was measured, the
    equivariance verdict."""
    ev = (entry["evidence"] or {}).get("numerics")
    if ev is None:
        return None
    canc = ev["cancellation"]
    return {"horizons": ev["horizons"], "sites": canc["sites"], "float64": canc.get("float64"),
            "skipped": canc.get("skipped"), "measured": canc["budget"] is not None,
            "equivariance": ev["equivariance"]}


def _double_buffer_verdict(entry):
    """``(safe, hazard kinds)`` of a report entry's double-buffer evidence,
    or None for an eager-only family."""
    db = (entry["evidence"] or {}).get("double_buffer")
    return None if db is None else (db["safe"], sorted({h["kind"] for h in db["hazards"]}))


def _program_audit_phase(torch, dev, card):
    """Phase 4q: the program audit and the distributed-equivalence pass
    (``analysis/program.py``, ``analysis/distributed.py``) on ``dev``.
    (a) ``audit_registry`` over the 29 families and their cohort, int8 and
    bf16 variants, metrics and inputs on the card, then the 29 base
    families on the CPU in this process: no unsuppressed finding, the
    recorded suppressions, and per base family the same eligibility,
    findings, suppressions, MTA005 verdicts, fingerprints and pass-5
    evidence; (b) the 22 metric fixtures on the card trip exactly their
    rules, as on the CPU;
    (c) ``abstract_step``, ``abstract_cohort_step``,
    ``abstract_double_buffer_step`` and ``MetricCohort.abstract_double_buffer``
    of three families on the card launch no kernel and no copy, allocate
    nothing and build nothing, and the two-generation graphs hold no
    hazard; (d) the watchdog's hint names MTA001 for
    ``NarrowAccumulator``'s engine key; (e) one real compiled step and one
    replay of each of the three families leave states that share no storage
    with the graph's buffers, the defaults or the returned value; (f) pass
    5 on the card (:func:`_pass5_on_the_card`). Passes 4 and 5 ride (a)
    and (b): the card's 80 seam budgets equal ``SEAM_BASELINE.json``'s and
    its double-buffer verdicts and numerics evidence the CPU's. Returns its
    timings, with the ``tie_scan`` launches of (a) and of the whole phase."""
    import gc

    from metrics_tpu_torch import BinnedAUROC, MeanSquaredError, MetricCohort, Precision
    from metrics_tpu_torch.analysis import (
        audit_metric,
        audit_registry,
        composed_generation_hazards,
        flatten_seam_budget,
        hint_for_watch_key,
        load_seam_baseline,
    )
    from metrics_tpu_torch.analysis import concurrency as conc
    from metrics_tpu_torch.analysis import fixtures as fx
    from metrics_tpu_torch.engine import CompiledStepEngine
    from metrics_tpu_torch.ops import tie_scan

    out = {}
    phase_t0 = time.perf_counter()

    # a. the registry on the card, then on the CPU
    scan = tie_scan.tie_group_reduce
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # config-edge warnings from the factories
        t0 = time.perf_counter()
        before = scan.launches
        report = audit_registry(device=dev.type, quantized=True, cohort=True, fingerprints=True)
        out["registry_card_s"] = time.perf_counter() - t0
        out["tie_scan_launches_a"] = scan.launches - before
        # the CPU twin audits the base families only: a whole smoke took
        # 422.5 s with the full twin on a slow host (the aim is < 400 s);
        # tests/test_torch_cuda.py compares all 89 families
        t0 = time.perf_counter()
        cpu_report = audit_registry(device="cpu", quantized=False, cohort=False, fingerprints=True)
        out["registry_cpu_s"] = time.perf_counter() - t0
    summary = report["summary"]
    live = [f"{fam}: {f['rule']} {f['subject']}" for fam, e in report["families"].items() for f in e["findings"]]
    if summary["findings"] or live:
        raise AssertionError(f"4q a. the registry audit on the card found {live}")
    kinds = {}
    for fam in report["families"]:
        kind = fam.split("@")[1] if "@" in fam else "base"
        kinds[kind] = kinds.get(kind, 0) + 1
    card_v = {fam: v for fam, v in _audit_verdicts(report).items() if "@" not in fam}
    cpu_v = _audit_verdicts(cpu_report)
    if sorted(card_v) != sorted(cpu_v) or cpu_report["summary"]["findings"]:
        raise AssertionError(f"4q a. families on the card {summary}, on the CPU {cpu_report['summary']}")
    ulp_only, differ = [], []
    for fam in card_v:
        a, b = card_v[fam], cpu_v[fam]
        if a == b:
            continue
        if fam.split("@")[0] in AUDIT_ULP_FAMILIES and {k: v for k, v in a.items() if k != "bits"} == {
                k: v for k, v in b.items() if k != "bits"}:
            ev = report["families"][fam]["distributed"]
            ulp_only.append(f"{fam} card {a['bits']} (max state err {ev['max_state_err']!r},"
                            f" two-level {(ev.get('topology') or {}).get('max_state_err')!r}) vs CPU {b['bits']}")
            continue
        differ.append(f"{fam} on the card {a}, on the CPU {b}")
    if differ:
        raise AssertionError("4q a. " + "; ".join(differ))
    # pass 4: the card's seam budgets against the committed baseline, and
    # every engine-eligible family proven double-buffer safe
    baseline = load_seam_baseline()
    seams = {fam: v["host_seam"] for fam, v in _audit_verdicts(report).items() if v["host_seam"]}
    unequal = [fam for fam, seam in seams.items() if fam not in baseline
               or flatten_seam_budget(seam) != baseline[fam]["budget"] or seam["states"] != baseline[fam]["states"]]
    unsafe = {fam: _double_buffer_verdict(e) for fam, e in report["families"].items()
              if e["engine_eligible"] and _double_buffer_verdict(e) != (True, [])}
    if len(seams) != 80 or unequal or unsafe:
        raise AssertionError(f"4q a. {len(seams)} seam budgets; unequal to SEAM_BASELINE.json: {unequal};"
                             f" not proven double-buffer safe: {unsafe}")
    # pass 5 rides (a): numerics evidence on every entry, and the suppressed
    # findings are exactly the recorded ones
    suppressed = {}
    for fam, entry in report["families"].items():
        for f in entry["suppressed"]:
            key = (f["rule"], fam.split("@")[1] if "@" in fam else "base")
            suppressed[key] = suppressed.get(key, 0) + 1
    no_numerics = [fam for fam, e in report["families"].items() if not (e["evidence"] or {}).get("numerics")]
    if suppressed != AUDIT_SUPPRESSED or no_numerics:
        raise AssertionError(f"4q a. suppressed {suppressed}, want {AUDIT_SUPPRESSED}; no numerics evidence:"
                             f" {no_numerics}")
    out.update(families=summary["families"], family_kinds=kinds, suppressed=summary["suppressed"],
               ulp_allowance_on_the_card_only=ulp_only, seam_budgets_equal=len(seams),
               double_buffer_safe=len(seams) - len(unsafe), host_seam_sites=len(report["host_seam_sites"]))
    print(f"4q a. [{card}] audit_registry(device={dev.type!r}) over {summary['families']} families ({kinds}):"
          f" {summary['findings']} unsuppressed findings, {summary['suppressed']} suppressed,"
          f" {out['registry_card_s']:.2f} s; the CPU's base families in this process {out['registry_cpu_s']:.2f} s,"
          f" the same eligibility, findings, suppressions, MTA005 verdicts, fingerprints, seam budgets and"
          f" double-buffer verdicts for all {len(cpu_v)}"
          + (f"; needing the 8-ulp allowance on the card only: {ulp_only}" if ulp_only else "")
          + f"; pass 4: {out['seam_budgets_equal']} seam budgets equal to SEAM_BASELINE.json's,"
          f" {out['double_buffer_safe']} families proven double-buffer safe, {out['host_seam_sites']} host"
          f" crossing sites; pass 5 on every entry, suppressed by rule and kind {suppressed}")

    # b. the metric fixtures trip exactly their rules (pass 5's three included)
    t0 = time.perf_counter()
    x = np.linspace(0.0, 1.0, 8).astype(np.float32)
    for name, rule in AUDIT_FIXTURE_RULES.items():
        sets = []
        for where in ("cpu", dev.type):
            result = audit_metric(getattr(fx, name)(device=where), (torch.from_numpy(x).to(where),))
            sets.append({(f.rule, f.subject, f.suppressed) for f in result.findings + result.suppressed})
        if sets[1] != sets[0] or {r for r, _, _ in sets[1]} != ({rule} if rule else set()):
            raise AssertionError(f"4q b. {name} on the card {sorted(sets[1])}, on the CPU {sorted(sets[0])},"
                                 f" want {rule or 'no finding'} alone")
    out["fixtures_s"] = time.perf_counter() - t0
    print(f"4q b. [{card}] the {len(AUDIT_FIXTURE_RULES)} metric fixtures trip exactly their rules on the card"
          f" (BlockScaledQuantizedSync none), as on the CPU ({out['fixtures_s']:.2f} s with the CPU runs)")

    # c. the abstract steps launch, allocate and build nothing: each traced
    # once for its bytes and signatures, then all six in one profiled call
    # beside a marker kernel (a trace without a device record reads as lost)
    t0 = time.perf_counter()
    marker = torch.zeros(1, device=dev)

    def bump():
        marker.add_(1)

    prof = _steady_profile(torch, bump)
    marker_name = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA][0]
    alone = _ops_in(torch, prof)
    rng = np.random.RandomState(0x7B0)
    probs = rng.rand(32, 4).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    mc = (torch.from_numpy(probs).to(dev), torch.from_numpy(rng.randint(4, size=32)).to(dev))
    binary = (mc[0][:, 1].contiguous(), torch.from_numpy(rng.randint(2, size=32)).to(dev))
    reg = (torch.from_numpy(rng.rand(32).astype(np.float32)).to(dev),) * 2
    families = ((lambda: MeanSquaredError(device=dev), reg),
                (lambda: Precision(num_classes=4, average="macro", device=dev), mc),
                (lambda: BinnedAUROC(num_bins=16, device=dev), binary))
    traced, traces, engines = {}, [], []
    for factory, args in families:
        engine = CompiledStepEngine(factory())
        cohort = MetricCohort(factory(), tenants=4)
        engines += [engine, cohort._engine]
        name = type(engine._metrics["metric"]).__name__
        for kind, trace in (("step", lambda e=engine, a=args: e.abstract_step(*a)),
                            ("cohort_step", lambda e=engine, a=args: e.abstract_cohort_step(*a, capacity=4)),
                            ("double_buffer", lambda e=engine, a=args: e.abstract_double_buffer_step(*a)),
                            ("cohort_double_buffer", lambda c=cohort, a=args: c.abstract_double_buffer(*a))):
            # earlier phases' garbage is freed first, and no collection runs
            # inside the trace: a free of it would read as a change
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            gc.disable()
            try:
                t1 = time.perf_counter()
                graph, shapes, *counts = trace()
                ms = (time.perf_counter() - t1) * 1e3
            finally:
                gc.enable()
            allocated = torch.cuda.memory_allocated() - before
            peak = torch.cuda.max_memory_allocated() - before
            devices = {v.device.type for v in shapes[0]["metric"].values()}
            hazards = composed_generation_hazards(graph, *counts) if len(counts) == 2 else []
            if allocated or peak or devices != {"cuda"} or hazards:
                raise AssertionError(f"4q c. {name}.abstract_{kind}: {allocated} bytes allocated ({peak} at the peak),"
                                     f" states on {devices}, two-generation hazards {hazards}")
            traced[f"{name}.{kind}"] = {"ms": ms, "nodes": len(graph.graph.nodes)}
            traces.append(trace)
    ops = _device_ops(torch, lambda: (bump(), [trace() for trace in traces]), shows=marker_name)
    built = [e.cache_info() for e in engines if e.cache_info()["compiled_signatures"] or e.trace_count]
    if ops != alone or built:
        raise AssertionError(f"4q c. the {len(traces)} abstract steps beside the marker ran (kernels, copies) {ops},"
                             f" the marker alone {alone}; engines that built: {built}")
    out["abstract"] = traced
    out["abstract_s"] = time.perf_counter() - t0
    print(f"4q c. [{card}] abstract_step, abstract_cohort_step, abstract_double_buffer_step and the cohort's"
          " abstract_double_buffer of MeanSquaredError, Precision and BinnedAUROC on the card: 0 kernels and 0"
          f" copies (an agreed trace of all {len(traces)} beside one marker kernel holds the marker alone), 0 bytes"
          " allocated at the end and at the peak, no signature built, composed_generation_hazards == [] for the"
          " six two-generation graphs; ms a trace "
          + ", ".join(f"{k} {v['ms']:.1f}" for k, v in traced.items()) + f" ({out['abstract_s']:.2f} s)")

    # d. the watchdog's cross-link
    key = CompiledStepEngine(fx.NarrowAccumulator(device=dev))._watch_key
    hint = hint_for_watch_key(key)
    if hint is None or "MTA001" not in hint:
        raise AssertionError(f"4q d. the hint for {key}: {hint!r}")
    print(f"4q d. the watchdog's hint for {key}: {hint}")

    # e. the traced verdict against a real build and replay: the installed
    # states own their storage (no graph buffer, no default, no other
    # state) and the returned value shares none of it
    t0 = time.perf_counter()
    checked = []
    for factory, args in families:
        metric = factory()
        engine = CompiledStepEngine(metric, observe=False)
        defaults = {conc._storage(d) for d in metric._defaults.values()} - {None}
        for step in ("build", "replay"):
            value = engine(*args)
            states = [(s, getattr(metric, s)) for s in metric._defaults]
            hazards = conc.first_dispatch_hazards(states, conc.engine_owned(engine), defaults, value)
            if hazards:
                raise AssertionError(f"4q e. {type(metric).__name__} after its {step}: {hazards}")
        graphs = len(engine.cache_info()["graph_build_ms"])
        if graphs != 1:
            raise AssertionError(f"4q e. {type(metric).__name__} built {graphs} CUDA graphs, not one")
        checked.append(type(metric).__name__)
    torch.cuda.synchronize()
    out["replay_s"] = time.perf_counter() - t0
    print(f"4q e. [{card}] {', '.join(checked)}: one compiled step (the CUDA graph's build) and one replay each;"
          " first_dispatch_hazards over the installed states, the graph's buffers, the defaults and the returned"
          f" value == [] after both, as the traced verdict says ({out['replay_s']:.2f} s)")

    out["numerics"] = _pass5_on_the_card(torch, dev, card, report, cpu_report)
    out["tie_scan_launches"] = out["tie_scan_launches_a"] + out["numerics"]["tie_scan_launches"]
    out["phase_s"] = time.perf_counter() - phase_t0
    return out


#: tie_scan launches of one pass 5 over AUROC or AveragePrecision: the
#: budget's float32 leg and its float64 leg (which raises: the kernel's
#: result is float32) on the first probe, and the equivariance probe's base
#: and two scales
PASS5_SCAN_LAUNCHES = 5


def _pass5_on_the_card(torch, dev, card, report, cpu_report):
    """Phase 4q (f): pass 5 (``analysis/numerics.py``) on the card. The
    card's registry entries (from (a)) against the CPU twin's base entries
    and ``NUMERICS_BASELINE.json``: horizons equal, budgets at or under the
    committed ones (an over-ceiling budget only where the report suppressed
    its MTA011), the float64 check of each oracle leg, no probe skipped on
    the card that the CPU measured, no pass-5 exception swallowed. Then
    pass 5 alone over the 29 root families, timed on the card and on the
    CPU, and over AUROC and AveragePrecision under the profiler: the
    ``tie_scan`` records of one pass against the wrapper's count."""
    from metrics_tpu_torch.analysis import numerics as num
    from metrics_tpu_torch.analysis.program import registry_cases
    from metrics_tpu_torch.ops import tie_scan

    out = {}
    base = num.load_numerics_baseline()
    card_ev = {fam: e["evidence"]["numerics"] for fam, e in report["families"].items()}
    cpu_ev = {fam: e["evidence"]["numerics"] for fam, e in cpu_report["families"].items()}
    suppressed_mta011 = {fam for fam, e in report["families"].items()
                         if any(f["rule"] == "MTA011" for f in e["suppressed"])}
    problems, over = [], []
    for fam, ev in card_ev.items():
        states = sorted(k for k in ev["horizons"] if not k.startswith("__"))
        if states != base[fam]["states"] or "__approximated__" in ev["horizons"]:
            problems.append(f"{fam}: states {states} ({ev['horizons'].get('__approximated__')})")
            continue
        unequal = [s for s, h in base[fam]["horizons"].items()
                   if (ev["horizons"][s]["kind"], ev["horizons"][s]["rows"]) != (h["kind"], h["rows"])]
        canc = ev["cancellation"]
        # a swallowed exception leaves an error without the float64 verdict
        if unequal or (canc.get("error") and canc.get("float64") is not False):
            problems.append(f"{fam}: horizons unequal to NUMERICS_BASELINE.json {unequal}; {canc.get('error')}")
        if canc["budget"] is not None and canc.get("float64") is not True:
            problems.append(f"{fam}: a budget from an oracle leg that did not run in float64")
        if canc["budget"] is not None and canc["budget"] > base[fam]["error_budget"]:
            over.append(fam)
        twin = cpu_ev.get(fam)
        if twin is not None:
            tc = twin["cancellation"]
            if (twin["horizons"] != ev["horizons"] or twin["equivariance"] != ev["equivariance"]
                    or tc["sites"] != canc["sites"] or tc.get("float64") != canc.get("float64")
                    or (tc["budget"] is None) != (canc["budget"] is None)):
                problems.append(f"{fam}: the card's pass 5 {ev} against the CPU's {twin}")
            skipped_here = set(canc.get("skipped") or ()) - set(tc.get("skipped") or ())
            if skipped_here:
                problems.append(f"{fam}: probes skipped on the card that the CPU measured: {sorted(skipped_here)}")
    if problems or set(over) != suppressed_mta011:
        raise AssertionError(f"4q f. {problems}; over their committed budget {sorted(over)}, suppressed MTA011"
                             f" {sorted(suppressed_mta011)}")
    roots = sorted(cpu_ev)
    rows = []
    for fam in roots:
        c, h = card_ev[fam]["cancellation"], cpu_ev[fam]["cancellation"]
        rows.append({"family": fam, "card": c["budget"], "cpu": h["budget"],
                     "card_ceiling": None if c["budget"] is None else num.committed_budget_ceiling(c["budget"]),
                     "committed": base[fam]["error_budget"], "float64": c.get("float64"),
                     "skipped": c.get("skipped") or {}})
    out["budgets"] = rows
    equivariance = {fam: card_ev[fam]["equivariance"]["bit_stable"] for fam in roots if card_ev[fam]["equivariance"]}
    if len(equivariance) != 10 or not all(equivariance.values()):
        raise AssertionError(f"4q f. the declared families' equivariance on the card: {equivariance}")
    out["equivariance"] = equivariance
    print(f"4q f. [{card}] pass 5 on the card: every horizon of the {len(card_ev)} entries equal to"
          f" NUMERICS_BASELINE.json's and the CPU twin's for the {len(roots)} base families (shortest"
          f" {num.min_horizon_rows(card_ev)!r} rows); budgets, card / CPU / ceiling of the card's / committed:")
    for r in rows:
        if r["card"] is None:
            print(f"    {r['family']}: no float64 oracle on either (the result pins float32)")
        else:
            print(f"    {r['family']}: {r['card']!r} / {r['cpu']!r} / {r['card_ceiling']!r} / {r['committed']!r},"
                  f" float64 {r['float64']}, skipped {r['skipped'] or 'none'}"
                  + (" (over: its MTA011 suppressed by R2Score's allow)" if r["family"] in over else ""))
    print(f"4q f. the 10 declared families bit-stable on the card: {equivariance}")

    # pass 5 alone over the root families, on the card and on the CPU
    scan = tie_scan.tie_group_reduce
    for where in (dev.type, "cpu"):
        cases = registry_cases(where)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            before = scan.launches
            t0 = time.perf_counter()
            for name, factory, args in cases:
                num.check_numerics(factory(), [], [], args=args, family=name)
            if where != "cpu":
                torch.cuda.synchronize()
            out[f"pass5_{where}_s"] = time.perf_counter() - t0
            out[f"pass5_{where}_launches"] = scan.launches - before
    if out[f"pass5_{dev.type}_launches"] != 2 * PASS5_SCAN_LAUNCHES or out["pass5_cpu_launches"]:
        raise AssertionError(f"4q f. pass 5 over the roots launched tie_scan {out[f'pass5_{dev.type}_launches']}"
                             f" times on the card, {out['pass5_cpu_launches']} on the CPU")

    # the tie_scan records of one pass 5 over AUROC and AveragePrecision
    cases = {name: (factory, args) for name, factory, args in registry_cases(dev.type)}
    calls = {"n": 0}

    def scan_pass():
        calls["n"] += 1
        for name in ("AUROC", "AveragePrecision"):
            factory, args = cases[name]
            num.check_numerics(factory(), [], [], args=args, family=name)

    before = scan.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prof = _steady_profile(torch, scan_pass, shows="tie_scan")
    wrapper = (scan.launches - before) / calls["n"]
    records = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "tie_scan" in e.key)
    if records != 2 * PASS5_SCAN_LAUNCHES or wrapper != 2 * PASS5_SCAN_LAUNCHES:
        raise AssertionError(f"4q f. one pass 5 over AUROC and AveragePrecision: {records} tie_scan records in the"
                             f" profile, {wrapper} wrapper launches a pass, want {2 * PASS5_SCAN_LAUNCHES}")
    out["tie_scan_records_a_pass"] = records
    out["tie_scan_launches"] = out[f"pass5_{dev.type}_launches"] + scan.launches - before
    print(f"4q f. pass 5 alone over the 29 root families: {out[f'pass5_{dev.type}_s']:.2f} s on the card,"
          f" {out['pass5_cpu_s']:.2f} s on the CPU; one pass over AUROC and AveragePrecision: {records} tie_scan"
          f" records in an agreed profile ({calls['n']} passes traced), {wrapper:.0f} wrapper launches a pass")
    return out


SAN_STEPS = 5
SAN_TENANTS = 64
SAN_COHORT_STEPS = 3
SAN_SERVE_STEPS = 8


def _sanitizer_phase(torch, dev, card):
    """Phase 4r: MetricSan on the card. Returns the phase's timings; leaves
    the sanitizer disarmed (``Metric`` without its interceptor), every
    pipeline closed and telemetry off."""
    import tempfile

    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch import (
        AUROC,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        MetricCohort,
        MetricCollection,
        PSNR,
        R2Score,
    )
    from metrics_tpu_torch.analysis import san_scope
    from metrics_tpu_torch.engine import CompiledStepEngine
    from metrics_tpu_torch.metric import Metric
    from metrics_tpu_torch.observability import flight
    from metrics_tpu_torch.ops import tie_scan
    from metrics_tpu_torch.reliability import faultinject
    from metrics_tpu_torch.serving import AsyncServingEngine

    out = {"card": card}
    part_s = out["part_s"] = {}
    t_part = time.perf_counter()
    scan = tie_scan.tie_group_reduce
    _, _, reg_p, reg_t = _regression_leg_inputs(torch, dev)
    reg_batches = [(reg_p[b * BATCH:(b + 1) * BATCH], reg_t[b * BATCH:(b + 1) * BATCH]) for b in range(SAN_STEPS)]
    rs = np.random.RandomState(SEED + 90)
    waves = [tuple(torch.from_numpy(rs.rand(SAN_TENANTS, COHORT_ROWS).astype(np.float32)).to(dev) for _ in range(2))
             for _ in range(SAN_COHORT_STEPS)]
    scores = torch.from_numpy(np.round(rs.rand(MAIN_N), 3).astype(np.float32)).to(dev)
    labels = (torch.from_numpy(rs.rand(MAIN_N).astype(np.float32)).to(dev) < scores).to(torch.int32)

    def armed():
        return san_scope(raise_on_violation=True)

    # a. healthy runs, armed against an unarmed twin
    def workload():
        col = MetricCollection([MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()],
                               compiled=True)
        values = [v for b in reg_batches for v in col(*b).values()] + list(col.compute().values())
        cohort = MetricCohort(MetricCollection([MeanSquaredError(), MeanAbsoluteError()]), tenants=SAN_TENANTS)
        values += [v for w in waves for v in cohort(*w).values()] + list(cohort.compute().values())
        auroc = AUROC(pos_label=1)
        auroc.update(scores, labels)
        before = scan.launches
        values.append(auroc.compute())
        launches = scan.launches - before
        synced = []
        for tier in ("exact", "int8"):
            m = MeanSquaredError()
            if tier != "exact":
                m.set_sync_precision(tier)
            m.update(*reg_batches[0])
            m._sync_dist()
            synced.append(m)
        values += [getattr(m, s) for m in synced for s in m._defaults]
        states = [getattr(m, s) for m in col.values() for s in m._defaults]
        states += [v for d in cohort._states.values() for v in d.values()]
        torch.cuda.synchronize()
        return (col, cohort), values, states, launches

    plain = workload()
    with armed() as san:
        on = workload()
    if san.violations:
        raise AssertionError(f"4r a. healthy runs under MetricSan: {san.violations}")
    for label, a, b in (("values", plain[1], on[1]), ("states", plain[2], on[2])):
        if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"4r a. {label} differ with MetricSan armed")
    (p_col, p_cohort), (a_col, a_cohort) = plain[0], on[0]
    if a_col._engine.trace_count != 1 or a_col._engine.eager_fallbacks or a_cohort._engine.trace_count != 1:
        raise AssertionError(f"4r a. the armed leg built {a_col._engine.trace_count} graphs (eager:"
                             f" {a_col._engine.eager_fallbacks}), the cohort {a_cohort._engine.trace_count}")
    if plain[3] != 1 or on[3] != 1:
        raise AssertionError(f"4r b. the AUROC compute launched tie_scan {plain[3]} times unarmed, {on[3]} armed")
    print(f"4r a. [{card}] under san_scope(raise_on_violation=True): the regression leg compiled ({SAN_STEPS}"
          f" batches of {BATCH}, one build), a {SAN_TENANTS}-tenant cohort ({SAN_COHORT_STEPS} steps + compute),"
          f" AUROC over {MAIN_N} (tie_scan launched {on[3]} time, as unarmed) and world-1 syncs of an exact and"
          " an int8 state: 0 violations, values and states bit-equal to the unarmed twin's")
    part_s["a"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # b. no device work added: a replay and a step, armed against disarmed, traced in turns
    ((p_prog,), (a_prog,)) = p_col._engine._compiled.values(), a_col._engine._compiled.values()
    counts, spoiled = {}, {}
    for label, off_fn, on_fn in (("replay", p_prog.graph.replay, a_prog.graph.replay),
                                 ("step", lambda: p_col(*reg_batches[0]), lambda: a_col(*reg_batches[0]))):
        try:
            off, on_ops, rounds = _paired_device_ops(torch, off_fn, on_fn, contexts=(None, armed))
        except AssertionError as err:
            raise AssertionError(f"4r b. kernels and copies of the {label} disarmed and armed: {err}") from None
        counts[label] = off
        if rounds:
            spoiled[label] = rounds
    with armed() as san:
        syncs = _syncs(torch, lambda: a_col(*reg_batches[1]))
    if syncs or san.violations:
        raise AssertionError(f"4r b. an armed replayed step synchronized the host at {syncs} ({san.violations})")
    out["armed_vs_off"] = {k: list(v) for k, v in counts.items()}
    out["rounds_spoiled"] = spoiled
    out["syncs_per_armed_step"] = len(syncs)
    print(f"4r b. kernels and copies disarmed and armed (traced in turns: the same device records): {counts};"
          f" 0 host syncs in an armed replayed step" + (f"; rounds that disagreed first: {spoiled}" if spoiled else ""))
    del plain, on, a_col, a_cohort, a_prog, p_cohort, p_prog
    part_s["b"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # c. the injectors on a CUDA graph: one MTA007 and one dump each
    x = torch.linspace(0.0, 1.0, 4096, device=dev)
    for form in ("free", "graph"):
        with tempfile.TemporaryDirectory(dir="build") as d, flight.flight_scope(d), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with san_scope() as san:
                engine = CompiledStepEngine(MeanSquaredError())
                engine.step(x, x * 0.5)
                engine.step(x, x * 0.5)
                healthy = list(san.violations)
                with faultinject.donation_unsafe_engine(form):
                    engine.step(x, x * 0.5)
                torch.cuda.synchronize()
            dumps = [f for f in os.listdir(d) if f.startswith("flight-")]
            reasons = [json.load(open(os.path.join(d, f)))["reason"] for f in dumps]
        got = [(v["rule"], v["subject"]) for v in san.violations]
        if healthy or got != [("MTA007", "MeanSquaredError")] or reasons != ["metricsan_use_after_donate"]:
            raise AssertionError(f"4r c. donation_unsafe_engine({form!r}): violations {san.violations}, dumps {reasons}")
        out[f"injector_{form}"] = {"violations": len(got), "dumps": len(dumps)}
        del engine
    print("4r c. donation_unsafe_engine on a CUDA graph: form 'free' (defaults freed) and form 'graph' (the graph's"
          " buffers handed out without the clone) each 1 MTA007 use_after_donate on MeanSquaredError, 1 flight dump")
    part_s["c"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # d. ThreadSan over an armed serve loop, the worker on its own stream
    with obs.telemetry_scope() as tel:
        races0 = tel.counters.get("san.thread.races", 0)
        with armed() as san:
            watched = tel.gauges.get("san.thread.watched_attrs", 0)
            col = MetricCollection([MeanSquaredError(), MeanAbsoluteError()], compiled=True)
            pipe = AsyncServingEngine(col)
            try:
                for i in range(SAN_SERVE_STEPS):
                    pipe.forward(*reg_batches[i % SAN_STEPS])
                pipe.drain()
                served = col.compute()
                stats = dict(pipe.stats)
            finally:
                pipe.close()
        races = tel.counters.get("san.thread.races", 0) - races0
    if san.violations or races or watched <= 0 or stats["dispatches"] < 1:
        raise AssertionError(f"4r d. ThreadSan over the serve loop: {san.violations}, races {races}, watched"
                             f" {watched}, pipeline stats {stats}")
    if not all(bool(torch.isfinite(v)) for v in served.values()):
        raise AssertionError(f"4r d. the served collection's values {served}")
    out["threadsan"] = {"races": races, "watched_attrs": watched, "worker_dispatches": stats["dispatches"],
                        "inline_steps": stats["inline_steps"]}
    print(f"4r d. ThreadSan over an AsyncServingEngine serve loop ({SAN_SERVE_STEPS} batches, {stats['dispatches']}"
          f" stepped by the worker on its own stream): 0 races, san.thread.watched_attrs = {watched:g}")
    part_s["d"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # e. the price of arming: host ms of a compiled step (a replay) and of an
    # eager forward, disarmed and armed in turns (each armed scope's first
    # call, which probes the class's reset once, untimed)
    eager = MeanSquaredError()
    eager(*reg_batches[0])
    price = {}
    for label, fn in (("compiled_step", lambda: p_col(*reg_batches[1])),
                      ("eager_forward", lambda: eager(*reg_batches[1]))):
        off_ms, on_ms = [], []
        for _ in range(5):
            off_ms.append(_host_ms(torch, fn, trials=1))
            with armed():
                fn()
                on_ms.append(_host_ms(torch, fn, trials=1))
        price[label] = {"disarmed_ms": float(np.median(off_ms)), "armed_ms": float(np.median(on_ms))}
    out["host_ms"] = price
    part_s["e"] = time.perf_counter() - t_part
    if "__setattr__" in Metric.__dict__:
        raise AssertionError("4r: Metric keeps the sanitizer's interceptor after disarming")
    print(f"4r e. [{card}] host ms a step (median of 5), disarmed / armed: compiled step"
          f" {price['compiled_step']['disarmed_ms']:.4f} / {price['compiled_step']['armed_ms']:.4f}, eager forward"
          f" {price['eager_forward']['disarmed_ms']:.4f} / {price['eager_forward']['armed_ms']:.4f}")
    return out


def main() -> int:
    card_index = _pin_one_card()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from metrics_tpu_torch import (
        AUC,
        AUROC,
        ROC,
        Accuracy,
        AveragePrecision,
        BinnedAUROC,
        BinnedAveragePrecision,
        BinnedPrecisionRecallCurve,
        MetricCollection,
        PrecisionRecallCurve,
        ShardedAUROC,
        ShardedAveragePrecision,
        ShardedPrecisionRecallCurve,
        ShardedROC,
    )
    from metrics_tpu_torch.functional import auroc as functional_auroc
    from metrics_tpu_torch.functional import average_precision as functional_average_precision
    from metrics_tpu_torch.functional import ssim as functional_ssim
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve
    from metrics_tpu_torch.ops import _native, tie_scan
    from metrics_tpu_torch.ops.auroc_kernel import (
        _co_sort,
        _co_sort_rows,
        _ovr_relevance,
        _payload,
        _sortable_key,
        binary_auroc,
        binary_average_precision,
        masked_binary_auroc,
    )
    from metrics_tpu_torch.parallel.sample_sort import _R, _sample_idx, _tie_stats, _tie_stats_w

    def zero_counts():
        for wrapper in (tie_scan.tie_group_reduce, tie_scan.tie_group_reduce_rows):
            wrapper.launches = wrapper.weighted_launches = 0
        tie_scan.tie_group_reduce.offset_launches = 0

    def counts():
        one, rows = tie_scan.tie_group_reduce, tie_scan.tie_group_reduce_rows
        return {"tie_scan": one.launches, "tie_scan_w": one.weighted_launches, "offsets": one.offset_launches,
                "tie_scan_rows": rows.launches, "tie_scan_rows_w": rows.weighted_launches}

    # calls of the plain version on the card (the main paths must make none)
    plain_on_card = {"calls": 0, "watch": False}
    scan_reference = tie_scan._scan_reference

    def watched_scan_reference(key, *args):
        if plain_on_card["watch"] and key.device.type == "cuda":
            plain_on_card["calls"] += 1
        return scan_reference(key, *args)

    tie_scan._scan_reference = watched_scan_reference

    dev = torch.device("cuda")
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"expected one visible card, got {torch.cuda.device_count()}")
    card = _card_line(card_index)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = _native.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.2f} s")

    # ---- 2a. the one-stream kernel against its plain version --------------
    rng = np.random.default_rng(SEED)
    max_err = 0.0

    def hold(label, scores, rel, mask=None, offsets=None):
        nonlocal max_err
        preds = torch.from_numpy(scores).to(dev)
        rel_t = torch.from_numpy(rel.astype(np.float32)).to(dev)
        w = None if mask is None else torch.from_numpy(mask.astype(np.float32)).to(dev)
        key_s, pay_s = _co_sort(preds, rel_t, w)
        want = tie_scan.tie_group_reduce_reference(key_s, pay_s, offsets)
        got = tie_scan.tie_group_reduce(key_s, pay_s, offsets)
        torch.cuda.synchronize()
        g, w = got.tolist(), want.tolist()
        if g[2:] != w[2:]:
            raise AssertionError(f"{label}: counts {g[2:]} != plain {w[2:]}")
        err = [abs(g[i] - w[i]) / max(1.0, abs(w[i])) for i in (0, 1)]
        if max(err) > SCORE_TOL:
            raise AssertionError(f"{label}: area/ap {g[:2]} vs plain {w[:2]} (rel err {err})")
        ga, gp = (float(x) for x in tie_scan.auroc_ap_from_stats(got))
        wa, wp = (float(x) for x in tie_scan.auroc_ap_from_stats(want))
        for a, b in ((ga, wa), (gp, wp)):
            if np.isnan(a) != np.isnan(b) or (not np.isnan(a) and abs(a - b) > SCORE_TOL):
                raise AssertionError(f"{label}: scores ({ga}, {gp}) vs plain ({wa}, {wp})")
            if not np.isnan(a):
                max_err = max(max_err, abs(a - b))
        return want, key_s, pay_s

    for n in EDGE_SIZES:
        hold(f"n={n}", np.round(rng.standard_normal(n), 1).astype(np.float32), rng.random(n) < 0.5)
    hold("one tie group", np.zeros(40_000, np.float32), rng.random(40_000) < 0.5)
    hold("signed zeros", np.array([0.0, -0.0] * 20_000, np.float32), rng.random(40_000) < 0.5)
    scores = np.round(rng.random(TIE_HEAVY_N), 2).astype(np.float32)
    rel = rng.random(TIE_HEAVY_N) < scores
    hold("tie-heavy 1M", scores, rel)
    mask = rng.random(TIE_HEAVY_N) < 0.7
    garbage = np.where(mask, scores, np.float32(1e30)).astype(np.float32)
    hold("masked 1M", garbage, rel, mask)
    hold("offsets 1M", scores, rel, offsets=(1234.0, 777.0))
    big_scores = np.round(rng.random(BIG_N), 3).astype(np.float32)
    big_rel = rng.random(BIG_N) < 0.9
    big, big_key_s, big_pay_s = hold("20M", big_scores, big_rel)
    if not big[2].item() > 2**24:
        raise AssertionError(f"20M stream: positive count {big[2].item()} does not exceed 2^24")
    # masked elements are inert, whatever their scores
    m_t = torch.from_numpy(mask).to(dev)
    r_t = torch.from_numpy(rel.astype(np.int64)).to(dev)
    a1 = float(masked_binary_auroc(torch.from_numpy(garbage).to(dev), r_t, m_t))
    a2 = float(masked_binary_auroc(torch.from_numpy(scores).to(dev), r_t, m_t))
    # the masked-off elements move the valid ones across tiles, which only
    # reorders the sum of the same terms
    if abs(a1 - a2) > SCORE_TOL:
        raise AssertionError(f"masked AUROC moved with masked-off scores: {a1} != {a2}")
    # the 1M-element scores against float64 oracles
    s_t = torch.from_numpy(scores).to(dev)
    auroc_1m = float(binary_auroc(s_t, r_t))
    ap_1m = float(binary_average_precision(s_t, r_t))
    oracle_auroc, oracle_ap = _oracle_auroc(scores, rel), _oracle_ap(scores, rel)
    if abs(auroc_1m - oracle_auroc) > ORACLE_TOL or abs(ap_1m - oracle_ap) > ORACLE_TOL:
        raise AssertionError(f"1M: AUROC {auroc_1m} / AP {ap_1m} vs oracle {oracle_auroc} / {oracle_ap}")
    torch.cuda.synchronize()
    print(f"kernel vs plain: ok, max |d score| {max_err:.3g}; 1M AUROC {auroc_1m:.7f} (oracle {oracle_auroc:.7f}),"
          f" AP {ap_1m:.7f} (oracle {oracle_ap:.7f})")

    # ---- 2b. the class-batched kernel against its plain version ----------
    max_err_rows = 0.0

    def hold_rows(label, scores, rel):
        """Batched launch vs plain version (counts exact, area/AP and the
        scores within SCORE_TOL, NaN where the plain version has NaN) and
        vs one one-stream launch per row (bit for bit)."""
        nonlocal max_err_rows
        rows = scores.shape[0]
        preds = torch.from_numpy(scores).to(dev)
        rel_t = torch.from_numpy(rel.astype(np.float32)).to(dev)
        key_s, pay_s = _co_sort_rows(_sortable_key(preds), _payload(rel_t, None))
        want = tie_scan.tie_group_reduce_rows_reference(key_s, pay_s)
        got = tie_scan.tie_group_reduce_rows(key_s, pay_s)
        singles = torch.stack([tie_scan.tie_group_reduce(key_s[r], pay_s[r]) for r in range(rows)])
        torch.cuda.synchronize()
        bad = (got[:, 2:] != want[:, 2:]).any(1).nonzero().flatten()
        if bad.numel():
            r = int(bad[0])
            raise AssertionError(f"{label}: row {r} counts {got[r, 2:].tolist()} != plain {want[r, 2:].tolist()}")
        rel_err = (got[:, :2].double() - want[:, :2].double()).abs() / want[:, :2].double().abs().clamp_min(1.0)
        if float(rel_err.max()) > SCORE_TOL:
            raise AssertionError(f"{label}: area/ap rel err {float(rel_err.max())} > {SCORE_TOL}")
        for g, w in zip(tie_scan.auroc_ap_from_stats(got), tie_scan.auroc_ap_from_stats(want)):
            if not torch.equal(torch.isnan(g), torch.isnan(w)):
                raise AssertionError(f"{label}: NaN rows differ from the plain version's")
            d = (g - w).abs()[~torch.isnan(w)]
            if d.numel():
                if float(d.max()) > SCORE_TOL:
                    raise AssertionError(f"{label}: score diff {float(d.max())} > {SCORE_TOL}")
                max_err_rows = max(max_err_rows, float(d.max()))
        if not torch.equal(got, singles):
            r = int((got != singles).any(1).nonzero().flatten()[0])
            raise AssertionError(f"{label}: row {r} {got[r].tolist()} != one-stream launch {singles[r].tolist()}")
        return want

    def row_case(rows, n, gen=rng):
        """Seeded rows: tie-heavy (rounded) and tie-free rows alternate; rows
        0, 1 and 2 (where present) are one tie group, without positives, and
        signed zeros."""
        scores = gen.random((rows, n), dtype=np.float32)
        scores[::2] = np.round(scores[::2], 2)
        rel = gen.random((rows, n)) < 0.3
        if rows >= 3:
            scores[0] = 0.25
            rel[1] = False
            scores[2] = np.where(np.arange(n) % 2 == 0, np.float32(0.0), np.float32(-0.0))
        return scores, rel

    for rows, n in ROW_SHAPES:
        want = hold_rows(f"rows {rows}x{n}", *row_case(rows, n))
        if rows >= 3 and not (want[1, 2].item() == 0 and want[0, 3].item() > 0):
            raise AssertionError(f"rows {rows}x{n}: the special rows are not what they should be")
    hold_rows(f"rows {CHUNKED_ROWS[0]}x{CHUNKED_ROWS[1]} (past a grid's y dimension)", *row_case(*CHUNKED_ROWS))
    print(f"batched kernel vs plain and vs one-stream launches: ok at {list(ROW_SHAPES) + [CHUNKED_ROWS]},"
          f" max |d score| {max_err_rows:.3g}")

    # ---- 2c. the weighted one-stream kernel against its plain version -----
    # the phases this slice added draw from their own generator, so the
    # earlier phases keep their inputs
    rng_w = np.random.default_rng(SEED + 1)
    max_err_w = 0.0

    def check_stats(label, got, want, tol=SCORE_TOL):
        """Sums within tol relative; scores within tol, NaN where the plain
        version has NaN. Returns the largest score difference."""
        rel_err = float(((got.double() - want.double()).abs() / want.double().abs().clamp_min(1e-30)).max())
        if rel_err > tol:
            raise AssertionError(f"{label}: {got.tolist()} vs {want.tolist()} (rel err {rel_err})")
        worst = 0.0
        for g, w in zip(tie_scan.auroc_ap_from_stats(got), tie_scan.auroc_ap_from_stats(want)):
            if not torch.equal(torch.isnan(g), torch.isnan(w)):
                raise AssertionError(f"{label}: NaN scores differ")
            d = (g - w).abs()[~torch.isnan(w)]
            if d.numel():
                worst = max(worst, float(d.max()))
        if worst > tol:
            raise AssertionError(f"{label}: scores differ by {worst}")
        return worst

    def hold_weighted(label, scores, rel, weights, mask=None):
        nonlocal max_err_w
        m = None if mask is None else torch.from_numpy(mask.astype(np.float32)).to(dev)
        streams = _co_sort(torch.from_numpy(scores).to(dev), torch.from_numpy(rel.astype(np.float32)).to(dev), m,
                           torch.from_numpy(weights).to(dev))
        got = tie_scan.tie_group_reduce(*streams[:2], weights_s=streams[2])
        want = tie_scan.tie_group_reduce_reference(*streams[:2], None, streams[2])
        torch.cuda.synchronize()
        max_err_w = max(max_err_w, check_stats(label, got, want))
        return streams, got

    for n in EDGE_SIZES:
        hold_weighted(f"weighted n={n}", np.round(rng_w.standard_normal(n), 1).astype(np.float32), rng_w.random(n) < 0.5,
                      rng_w.lognormal(size=n).astype(np.float32))
    # the sharded binary path's stream: seeded scores, P(1) = score, lognormal weights
    cr_preds_np = rng_w.random(CRITEO_N, dtype=np.float32)
    cr_target_np = (rng_w.random(CRITEO_N) < cr_preds_np).astype(np.int32)
    cr_w_np = rng_w.lognormal(size=CRITEO_N).astype(np.float32)
    cr_streams, cr_stats = hold_weighted("weighted 45,840,617", cr_preds_np, cr_target_np.astype(bool), cr_w_np)
    cr_repeats = [tie_scan.tie_group_reduce(*cr_streams[:2], weights_s=cr_streams[2]) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    if not all(torch.equal(r, cr_stats) for r in cr_repeats):
        raise AssertionError("weighted 45,840,617: a repeated launch gave other bits")
    w_mask = mask.astype(np.float32)
    hold_weighted("weighted masked 1M", garbage, rel, np.where(mask, rng_w.lognormal(size=TIE_HEAVY_N), 0.0)
                  .astype(np.float32), mask)
    # zero weights equal masking; unit weights equal no weights; tiny totals are not degenerate
    unit = np.ones(TIE_HEAVY_N, np.float32)
    s1, r1, m1 = (torch.from_numpy(x).to(dev) for x in (scores, rel.astype(np.float32), w_mask))
    zero_streams = _co_sort(s1, r1, None, m1)
    zero_w = tie_scan.tie_group_reduce(*zero_streams[:2], weights_s=zero_streams[2])
    masked_u = tie_scan.tie_group_reduce(*_co_sort(s1, r1, m1))
    max_err_w = max(max_err_w, check_stats("zero weights vs masking", zero_w, masked_u))
    unit_streams = _co_sort(s1, r1, None, torch.from_numpy(unit).to(dev))
    unit_w = tie_scan.tie_group_reduce(*unit_streams[:2], weights_s=unit_streams[2])
    plain_u = tie_scan.tie_group_reduce(*unit_streams[:2])
    max_err_w = max(max_err_w, check_stats("unit weights vs no weights", unit_w, plain_u))
    if not torch.equal(unit_w[2:], plain_u[2:]):
        raise AssertionError(f"unit weights: totals {unit_w[2:].tolist()} != counts {plain_u[2:].tolist()}")
    tiny = tie_scan.tie_group_reduce(*unit_streams[:2], weights_s=unit_streams[2] * 1e-26)
    tiny_auroc, tiny_ap = (float(x) for x in tie_scan.auroc_ap_from_stats(tiny))
    if np.isnan(tiny_auroc) or abs(tiny_ap - float(tie_scan.auroc_ap_from_stats(plain_u)[1])) > ORACLE_TOL:
        raise AssertionError(f"tiny totals {tiny[2:].tolist()}: AUROC {tiny_auroc}, AP {tiny_ap}")
    torch.cuda.synchronize()
    print(f"weighted kernel vs plain: ok at {list(EDGE_SIZES) + [CRITEO_N]}, masked, zero, unit and tiny weights;"
          f" max |d score| {max_err_w:.3g}; {REPEATS} repeats at {CRITEO_N} bit-equal")

    # ---- 2c′. the bucket-offset form, on the sample sort's bucket epilogue --
    zero_counts()
    off_w_t = torch.from_numpy(rng_w.lognormal(size=TIE_HEAVY_N).astype(np.float32)).to(dev)
    shards = s1.chunk(4)  # four ranks' shards; their samples give the splitters
    samples = torch.cat([torch.sort(_sortable_key(x)).values[_sample_idx(x.numel(), dev)] for x in shards])
    splitters = torch.sort(samples).values[torch.arange(1, 4, device=dev) * _R]
    max_err_off = 0.0
    bucket_sizes = []
    for weights in (None, off_w_t):
        streams = _co_sort(s1, r1, None, weights)
        bounds = [0, *torch.searchsorted(streams[0], splitters, right=True).tolist(), TIE_HEAVY_N]
        area = ap_sum = off_p = off_n = 0.0
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = [x[lo:hi] for x in streams]
            stats = _tie_stats(*part, off_p, off_n) if weights is None else _tie_stats_w(*part, off_p, off_n)
            plain = tie_scan.tie_group_reduce_reference(*part[:2], (off_p, off_n), *part[2:]).double()
            plain[0] += off_p * plain[3]  # the area's offset term, as _tie_stats adds it
            check_stats(f"bucket [{lo}, {hi}) vs plain", torch.stack(stats), plain)
            area, ap_sum = area + float(stats[0]), ap_sum + float(stats[1])
            off_p, off_n = off_p + float(stats[2]), off_n + float(stats[3])
        whole = tie_scan.tie_group_reduce(*streams[:2], weights_s=None if weights is None else streams[2]).double()
        buckets = (area / (off_p * off_n), ap_sum / off_p)
        one = (float(whole[0] / (whole[2] * whole[3])), float(whole[1] / whole[2]))
        max_err_off = max(max_err_off, *(abs(a - b) for a, b in zip(buckets, one)))
        if max_err_off > SCORE_TOL:
            raise AssertionError(f"buckets {buckets} vs one stream {one}")
        bucket_sizes.append(np.diff(bounds).tolist())
    torch.cuda.synchronize()
    offset_launches = counts()["offsets"]
    if offset_launches != 8:
        raise AssertionError(f"the bucket epilogue made {offset_launches} offset launches, want 8 (4 buckets x 2)")
    print(f"bucket-offset form: 4 buckets {bucket_sizes[0]} sum to the one-stream AUROC/AP within"
          f" {max_err_off:.3g}, weighted and not; {offset_launches} offset launches")

    # ---- 2d. the weighted class-batched kernel against its plain version ---
    max_err_rows_w = 0.0
    for rows, n in ROW_SHAPES:
        sc, rl = row_case(rows, n, rng_w)
        wt = torch.from_numpy(rng_w.lognormal(size=(rows, n)).astype(np.float32)).to(dev)
        key_s, pay_s, w_s = _co_sort_rows(_sortable_key(torch.from_numpy(sc).to(dev)),
                                          _payload(torch.from_numpy(rl.astype(np.float32)).to(dev), None), wt)
        got = tie_scan.tie_group_reduce_rows(key_s, pay_s, weights_s=w_s)
        want = tie_scan.tie_group_reduce_rows_reference(key_s, pay_s, None, w_s)
        singles = torch.stack([tie_scan.tie_group_reduce(key_s[r], pay_s[r], weights_s=w_s[r]) for r in range(rows)])
        torch.cuda.synchronize()
        max_err_rows_w = max(max_err_rows_w, check_stats(f"weighted rows {rows}x{n}", got, want))
        if not torch.equal(got, singles):
            r = int((got != singles).any(1).nonzero().flatten()[0])
            raise AssertionError(f"weighted rows {rows}x{n}: row {r} {got[r].tolist()} != {singles[r].tolist()}")
        if (rows, n) == ROW_SHAPES[-1]:
            repeats = [tie_scan.tie_group_reduce_rows(key_s, pay_s, weights_s=w_s) for _ in range(REPEATS)]
            torch.cuda.synchronize()
            if not all(torch.equal(r, got) for r in repeats):
                raise AssertionError(f"weighted rows {rows}x{n}: a repeated launch gave other bits")
    print(f"weighted batched kernel vs plain and vs one-stream launches: ok at {list(ROW_SHAPES)},"
          f" max |d score| {max_err_rows_w:.3g}; {REPEATS} repeats at {ROW_SHAPES[-1]} bit-equal")

    # ---- 3. the binary main path -----------------------------------------
    preds_np = rng.random(MAIN_N, dtype=np.float32)
    target_np = (rng.random(MAIN_N) < preds_np).astype(np.int64)
    preds = torch.from_numpy(preds_np).to(dev)
    target = torch.from_numpy(target_np).to(dev)
    collection = MetricCollection([Accuracy(), AUROC(pos_label=1)])
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for b in range(BATCHES):
        step = collection(preds[b * BATCH:(b + 1) * BATCH], target[b * BATCH:(b + 1) * BATCH])
    t_forward = time.perf_counter() - t0
    result = collection.compute()
    torch.cuda.synchronize()
    main_path_s = time.perf_counter() - t0
    launches = tie_scan.tie_group_reduce.launches
    if launches == 0:
        raise AssertionError("the binary main path never launched the tie_scan kernel")
    if tie_scan.tie_group_reduce_rows.launches != 0:
        raise AssertionError("the binary main path launched the class-batched kernel")
    values = {k: v.item() for k, v in result.items()}
    for k, v in list(values.items()) + [(k, v.item()) for k, v in step.items()]:
        if not np.isfinite(v):
            raise AssertionError(f"main path: {k} = {v} is not finite")
    rel_np = target_np.astype(bool)
    want_acc = float(np.float32(np.sum((preds_np >= 0.5) == rel_np)) / np.float32(MAIN_N))
    want_auroc = _oracle_auroc(preds_np, rel_np)
    if values["Accuracy"] != want_acc:
        raise AssertionError(f"main path: Accuracy {values['Accuracy']} != numpy {want_acc}")
    if abs(values["AUROC"] - want_auroc) > ORACLE_TOL:
        raise AssertionError(f"main path: AUROC {values['AUROC']} vs oracle {want_auroc}")
    print(f"binary main path: {values} (numpy: Accuracy {want_acc}, AUROC {want_auroc:.7f}),"
          f" tie_scan launches {launches}, {main_path_s:.3f} s including first calls")

    # ---- 3b. the sharded binary path: one weighted stream of Criteo's rows --
    cr_preds = torch.from_numpy(cr_preds_np).to(dev)
    cr_target = torch.from_numpy(cr_target_np).to(dev).long()
    cr_w = torch.from_numpy(cr_w_np).to(dev)
    cr_batches = [slice(b, b + SHARDED_BATCH) for b in range(0, CRITEO_N, SHARDED_BATCH)]

    def only(launched, **want):
        return all(v == want.get(k, 0) for k, v in launched.items())

    sharded = MetricCollection([
        ShardedAUROC(capacity_per_device=CRITEO_N, with_sample_weights=True),
        ShardedAveragePrecision(capacity_per_device=CRITEO_N, with_sample_weights=True),
    ])
    torch.cuda.synchronize()
    zero_counts()
    plain_on_card.update(calls=0, watch=True)
    t0 = time.perf_counter()
    for sl in cr_batches:
        sharded.update(cr_preds[sl], cr_target[sl], sample_weights=cr_w[sl])
    sh_result = sharded.compute()
    torch.cuda.synchronize()
    sharded_path_s = time.perf_counter() - t0
    plain_on_card["watch"] = False
    sh_launches = counts()
    if not only(sh_launches, tie_scan_w=2) or plain_on_card["calls"]:
        raise AssertionError(
            f"sharded binary path: launches {sh_launches}, {plain_on_card['calls']} plain-version calls on the"
            " card; want exactly one weighted launch per metric compute and no plain version"
        )
    sh_values = {k: v.item() for k, v in sh_result.items()}
    cr_oracle = _oracle_weighted(cr_preds_np, cr_target_np.astype(bool), cr_w_np)
    for k, want in zip(("ShardedAUROC", "ShardedAveragePrecision"), cr_oracle):
        if not abs(sh_values[k] - want) <= ORACLE_TOL:
            raise AssertionError(f"sharded binary path: {k} {sh_values[k]} vs float64 oracle {want}")
    # without weights, the sharded metric is AUROC of the same stream
    pair = MetricCollection([ShardedAUROC(capacity_per_device=CRITEO_N), AUROC(pos_label=1)])
    for sl in cr_batches:
        pair.update(cr_preds[sl], cr_target[sl])
    pair_values = {k: v.item() for k, v in pair.compute().items()}
    if not abs(pair_values["ShardedAUROC"] - pair_values["AUROC"]) <= SCORE_TOL:
        raise AssertionError(f"unweighted ShardedAUROC {pair_values['ShardedAUROC']} != AUROC {pair_values['AUROC']}")
    del pair
    print(f"sharded binary path at {CRITEO_N}: {sh_values} (float64 oracle {cr_oracle}), launches {sh_launches},"
          f" {sharded_path_s:.3f} s including first calls; unweighted ShardedAUROC {pair_values['ShardedAUROC']:.7f}"
          f" = AUROC {pair_values['AUROC']:.7f}")

    # ---- 3c. the binary curves at 1M ---------------------------------------
    rng_c = np.random.default_rng(SEED + 2)

    def check_curve(label, got, want, tol=CURVE_TOL):
        """Equal lengths and thresholds, the two value arrays within tol."""
        g = [x.cpu().numpy() for x in got]
        if [x.shape for x in g] != [np.shape(x) for x in want]:
            raise AssertionError(f"{label}: shapes {[x.shape for x in g]} != oracle {[np.shape(x) for x in want]}")
        if not np.array_equal(g[2], want[2]):
            raise AssertionError(f"{label}: thresholds differ from the oracle's")
        err = max(float(np.max(np.abs(a.astype(np.float64) - b), initial=0.0)) for a, b in zip(g[:2], want[:2]))
        if not err <= tol:
            raise AssertionError(f"{label}: points off the oracle by {err}")
        return err

    curves = MetricCollection([ROC(pos_label=1), PrecisionRecallCurve(pos_label=1)])
    sharded_curves = MetricCollection([ShardedROC(capacity_per_device=MAIN_N),
                                       ShardedPrecisionRecallCurve(capacity_per_device=MAIN_N)])
    partial = AUROC(pos_label=1, max_fpr=0.1)
    torch.cuda.synchronize()
    zero_counts()
    plain_on_card.update(calls=0, watch=True)
    t0 = time.perf_counter()
    for b in range(BATCHES):
        sl = slice(b * BATCH, (b + 1) * BATCH)
        for coll in (curves, sharded_curves, partial):
            coll.update(preds[sl], target[sl])
    curve_values = curves.compute()
    sharded_values = sharded_curves.compute()
    partial_value = partial.compute().item()
    area = AUC()
    area.update(*curve_values["ROC"][:2])
    area_value = area.compute().item()
    w_1m_np = rng_c.lognormal(size=MAIN_N).astype(np.float32)
    w_1m = torch.from_numpy(w_1m_np).to(dev)
    before = counts()
    w_auroc_1m = functional_auroc(preds, target, pos_label=1, sample_weights=w_1m).item()
    w_auroc_launches = {k: v - before[k] for k, v in counts().items()}
    before = counts()
    w_ap_1m = functional_average_precision(preds, target, pos_label=1, sample_weights=w_1m).item()
    w_ap_launches = {k: v - before[k] for k, v in counts().items()}
    torch.cuda.synchronize()
    curves_path_s = time.perf_counter() - t0
    plain_on_card["watch"] = False
    curve_launches = counts()
    if not only(w_auroc_launches, tie_scan_w=1) or not only(w_ap_launches, tie_scan_w=1) or plain_on_card["calls"]:
        raise AssertionError(
            f"weighted functional AUROC/AP: launches {w_auroc_launches} / {w_ap_launches},"
            f" {plain_on_card['calls']} plain-version calls on the card; want one tie_scan_w launch each"
        )
    curve_err = check_curve("ROC at 1M", curve_values["ROC"], _oracle_roc(preds_np, rel_np))
    curve_err = max(curve_err, check_curve("PrecisionRecallCurve at 1M", curve_values["PrecisionRecallCurve"],
                                           _oracle_pr(preds_np, rel_np)))
    for name, mine in (("ROC", "ShardedROC"), ("PrecisionRecallCurve", "ShardedPrecisionRecallCurve")):
        if not all(torch.equal(a, b) for a, b in zip(curve_values[name], sharded_values[mine])):
            raise AssertionError(f"{mine} at world 1 differs from {name}")
    if abs(area_value - want_auroc) > ORACLE_TOL:
        raise AssertionError(f"AUC of the 1M ROC {area_value} vs oracle AUROC {want_auroc}")
    oracle_fpr, oracle_tpr, _ = _oracle_roc(preds_np, rel_np)
    want_partial = _oracle_partial_auroc(oracle_fpr, oracle_tpr, 0.1)
    if abs(partial_value - want_partial) > ORACLE_TOL:
        raise AssertionError(f"AUROC(max_fpr=0.1) {partial_value} vs McClish oracle {want_partial}")
    w_oracle_1m = _oracle_weighted(preds_np, rel_np, w_1m_np)
    if abs(w_auroc_1m - w_oracle_1m[0]) > ORACLE_TOL or abs(w_ap_1m - w_oracle_1m[1]) > ORACLE_TOL:
        raise AssertionError(f"weighted 1M: AUROC {w_auroc_1m} / AP {w_ap_1m} vs float64 oracle {w_oracle_1m}")
    # the 20M stream of phase 2a (1,001 scores, the positive class above 2^24): exact int32 counts
    big_fps, big_tps, big_thr = _binary_clf_curve(torch.from_numpy(big_scores).to(dev),
                                                  torch.from_numpy(big_rel).to(dev))
    milli = np.rint(big_scores.astype(np.float64) * 1000).astype(np.int64)
    pos_per = np.bincount(milli[big_rel], minlength=1001)[::-1]
    all_per = np.bincount(milli, minlength=1001)[::-1]
    present = all_per > 0
    value_of = np.zeros(1001, np.float32)
    value_of[milli] = big_scores
    want_tps = np.cumsum(pos_per)[present]
    want_fps = np.cumsum(all_per - pos_per)[present]
    if big_tps.dtype != torch.int32 or not (np.array_equal(big_tps.cpu().numpy(), want_tps)
                                             and np.array_equal(big_fps.cpu().numpy(), want_fps)
                                             and np.array_equal(big_thr.cpu().numpy(), value_of[::-1][present])):
        raise AssertionError("20M stream: the curve's counts or thresholds differ from numpy's int64 counts")
    if not want_tps[-1] > 2**24:
        raise AssertionError(f"20M stream: positive count {want_tps[-1]} does not exceed 2^24")
    del big_scores, big_rel, milli
    print(f"binary curves at {MAIN_N}: ROC {len(curve_values['ROC'][0])} points and PR"
          f" {len(curve_values['PrecisionRecallCurve'][0])} points equal the float64 oracle (max |d| {curve_err:.3g}),"
          f" sharded curves equal; AUC {area_value:.7f}; AUROC(max_fpr=0.1) {partial_value:.7f} (McClish oracle"
          f" {want_partial:.7f}); weighted AUROC {w_auroc_1m:.7f} / AP {w_ap_1m:.7f} (oracle {w_oracle_1m[0]:.7f} /"
          f" {w_oracle_1m[1]:.7f}), one tie_scan_w launch each; 20M curve: {len(want_tps)} points, int32 counts exact"
          f" (positives {int(want_tps[-1])}); {curves_path_s:.3f} s including first calls")

    # ---- 4. the multi-class main path, ImageNet-1k val shape --------------
    mc_target_np = rng.permutation(np.repeat(np.arange(IMAGENET_C), IMAGENET_N // IMAGENET_C))
    logits = rng.standard_normal((IMAGENET_N, IMAGENET_C), dtype=np.float32)
    logits[np.arange(IMAGENET_N), mc_target_np] += np.float32(3.0)
    logits -= logits.max(axis=1, keepdims=True)
    np.exp(logits, out=logits)
    mc_scores_np = logits / logits.sum(axis=1, keepdims=True)
    del logits
    mc_preds = torch.from_numpy(mc_scores_np).to(dev)
    mc_target = torch.from_numpy(mc_target_np).to(dev)
    mc_batch = IMAGENET_N // MC_BATCHES

    def mc_collection():
        return MetricCollection(
            [Accuracy(), AUROC(num_classes=IMAGENET_C), AveragePrecision(num_classes=IMAGENET_C)]
        )

    mc = mc_collection()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for b in range(MC_BATCHES):
        mc.update(mc_preds[b * mc_batch:(b + 1) * mc_batch], mc_target[b * mc_batch:(b + 1) * mc_batch])
    mc_result = mc.compute()
    torch.cuda.synchronize()
    mc_path_s = time.perf_counter() - t0
    rows_launches = tie_scan.tie_group_reduce_rows.launches
    if rows_launches != 2 or tie_scan.tie_group_reduce.launches != 0:
        raise AssertionError(
            f"multi-class path: {rows_launches} batched and {tie_scan.tie_group_reduce.launches} one-stream"
            " launches; want exactly one batched launch per AUROC and per AP compute"
        )
    mc_acc = mc_result["Accuracy"].item()
    mc_auroc = mc_result["AUROC"].item()
    mc_ap = torch.stack(mc_result["AveragePrecision"]).cpu().numpy().astype(np.float64)
    want_mc_acc = float(
        np.float32(np.sum(np.argmax(mc_scores_np, axis=1) == mc_target_np)) / np.float32(IMAGENET_N)
    )
    if mc_acc != want_mc_acc:
        raise AssertionError(f"multi-class path: Accuracy {mc_acc} != numpy {want_mc_acc}")
    columns = np.ascontiguousarray(mc_scores_np.T)
    oracle_aurocs = np.array([_oracle_auroc(columns[c], mc_target_np == c) for c in range(IMAGENET_C)])
    oracle_aps = np.array([_oracle_ap(columns[c], mc_target_np == c) for c in range(IMAGENET_C)])
    if not np.isfinite(mc_auroc) or abs(mc_auroc - oracle_aurocs.mean()) > ORACLE_TOL:
        raise AssertionError(f"multi-class path: macro AUROC {mc_auroc} vs oracle {oracle_aurocs.mean()}")
    ap_err = np.abs(mc_ap - oracle_aps)
    if mc_ap.shape != (IMAGENET_C,) or not np.all(ap_err <= ORACLE_TOL):
        raise AssertionError(f"multi-class path: AP of class {int(np.nanargmax(ap_err))} off by {np.nanmax(ap_err)}")
    mc.persistent(True)
    mc_saved = _saved(mc)
    mc_step = mc(mc_preds[:mc_batch], mc_target[:mc_batch])  # a batch may lack classes: NaN is allowed
    torch.cuda.synchronize()
    if len(mc_step["AveragePrecision"]) != IMAGENET_C or mc_step["AUROC"].shape != ():
        raise AssertionError("multi-class forward: unexpected output shapes")
    print(f"multi-class main path: Accuracy {mc_acc} (numpy {want_mc_acc}), macro AUROC {mc_auroc:.7f}"
          f" (oracle {oracle_aurocs.mean():.7f}), mean AP {mc_ap.mean():.7f} (oracle {oracle_aps.mean():.7f}),"
          f" max |d AP| {ap_err.max():.3g}; tie_scan_rows launches {rows_launches}, {mc_path_s:.3f} s"
          " including first calls; one forward: ok")

    # multi-label, MS-COCO 2014 val shape: per-label AUROC against the oracle
    prevalence = rng.uniform(0.005, 0.2, COCO_C)
    ml_target_np = rng.random((COCO_N, COCO_C)) < prevalence
    ml_scores_np = (1.0 / (1.0 + np.exp(-(rng.standard_normal((COCO_N, COCO_C)) + 2.0 * ml_target_np)))).astype(
        np.float32
    )
    ml = functional_auroc(
        torch.from_numpy(ml_scores_np).to(dev), torch.from_numpy(ml_target_np.astype(np.int64)).to(dev),
        num_classes=COCO_C, average=None,
    )
    ml = torch.stack(ml).cpu().numpy().astype(np.float64)
    ml_oracle = np.array([_oracle_auroc(ml_scores_np[:, c], ml_target_np[:, c]) for c in range(COCO_C)])
    ml_err = np.abs(ml - ml_oracle)
    if not np.all(ml_err <= ORACLE_TOL):
        raise AssertionError(f"multi-label: AUROC of label {int(np.nanargmax(ml_err))} off by {np.nanmax(ml_err)}")
    print(f"multi-label {COCO_N}x{COCO_C}: per-label AUROC ok, max |d| {ml_err.max():.3g}")

    # ---- 4b. the sharded one-vs-rest path, weighted, at the same shape ----
    mc_w_np = rng_w.lognormal(size=IMAGENET_N).astype(np.float32)
    mc_w = torch.from_numpy(mc_w_np).to(dev)
    ovr_kwargs = dict(num_classes=IMAGENET_C, capacity_per_device=IMAGENET_N, with_sample_weights=True,
                      average="weighted")
    ovr = MetricCollection([ShardedAUROC(**ovr_kwargs), ShardedAveragePrecision(**ovr_kwargs)])
    torch.cuda.synchronize()
    zero_counts()
    plain_on_card.update(calls=0, watch=True)
    t0 = time.perf_counter()
    for b in range(MC_BATCHES):
        sl = slice(b * mc_batch, (b + 1) * mc_batch)
        ovr.update(mc_preds[sl], mc_target[sl], sample_weights=mc_w[sl])
    ovr_result = ovr.compute()
    torch.cuda.synchronize()
    ovr_path_s = time.perf_counter() - t0
    plain_on_card["watch"] = False
    ovr_launches = counts()
    if not only(ovr_launches, tie_scan_rows_w=2) or plain_on_card["calls"]:
        raise AssertionError(
            f"sharded one-vs-rest path: launches {ovr_launches}, {plain_on_card['calls']} plain-version calls on"
            " the card; want exactly one weighted batched launch per metric compute and no plain version"
        )
    ovr_values = {k: v.item() for k, v in ovr_result.items()}
    support = np.bincount(mc_target_np, weights=mc_w_np.astype(np.float64), minlength=IMAGENET_C)
    per_class = np.array([_oracle_weighted(columns[c], mc_target_np == c, mc_w_np) for c in range(IMAGENET_C)])
    ovr_oracle = (per_class * support[:, None]).sum(0) / support.sum()
    for k, want in zip(("ShardedAUROC", "ShardedAveragePrecision"), ovr_oracle):
        if not abs(ovr_values[k] - want) <= ORACLE_TOL:
            raise AssertionError(f"sharded one-vs-rest path: {k} {ovr_values[k]} vs float64 oracle {want}")
    print(f"sharded one-vs-rest path {IMAGENET_N}x{IMAGENET_C}, weighted average: {ovr_values} (float64 oracle"
          f" {ovr_oracle.tolist()}), launches {ovr_launches}, {ovr_path_s:.3f} s including first calls")

    # ---- 4c. per-class curves at the ImageNet-1k val shape -----------------
    def host_lists(values):
        """A per-class list of device tensors as host arrays, one copy."""
        lengths = [v.numel() for v in values]
        return np.split(torch.cat(values).cpu().numpy(), np.cumsum(lengths)[:-1])

    mc_curves = MetricCollection([ROC(num_classes=IMAGENET_C), PrecisionRecallCurve(num_classes=IMAGENET_C)])
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for b in range(MC_BATCHES):
        sl = slice(b * mc_batch, (b + 1) * mc_batch)
        mc_curves.update(mc_preds[sl], mc_target[sl])
    mc_curve_values = mc_curves.compute()
    torch.cuda.synchronize()
    mc_curves_s = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"per-class curves launched a scan kernel: {counts()}")
    roc_host = [host_lists(v) for v in mc_curve_values["ROC"]]
    pr_host = [host_lists(v) for v in mc_curve_values["PrecisionRecallCurve"]]
    mc_curve_err = 0.0
    for c in range(IMAGENET_C):
        rel_c = mc_target_np == c
        for label, got, want in (("ROC", roc_host, _oracle_roc(columns[c], rel_c)),
                                 ("PR", pr_host, _oracle_pr(columns[c], rel_c))):
            g = [x[c] for x in got]
            if [x.shape for x in g] != [x.shape for x in want] or not np.array_equal(g[2], want[2]):
                raise AssertionError(f"per-class {label} of class {c}: points or thresholds differ from the oracle's")
            mc_curve_err = max(mc_curve_err, *(float(np.max(np.abs(a - b))) for a, b in zip(g[:2], want[:2])))
    if not mc_curve_err <= CURVE_TOL:
        raise AssertionError(f"per-class curves: points off the oracle by {mc_curve_err}")
    # weighted per-class AUROC / AP: one weighted batched launch each, against 4b's oracles
    zero_counts()
    plain_on_card.update(calls=0, watch=True)
    mc_w_auroc = functional_auroc(mc_preds, mc_target, num_classes=IMAGENET_C, sample_weights=mc_w, average=None)
    mc_w_auroc_launches = counts()
    zero_counts()
    mc_w_ap = functional_average_precision(mc_preds, mc_target, num_classes=IMAGENET_C, sample_weights=mc_w)
    mc_w_ap_launches = counts()
    plain_on_card["watch"] = False
    if (not only(mc_w_auroc_launches, tie_scan_rows_w=1) or not only(mc_w_ap_launches, tie_scan_rows_w=1)
            or plain_on_card["calls"]):
        raise AssertionError(f"weighted per-class AUROC/AP: launches {mc_w_auroc_launches} / {mc_w_ap_launches},"
                             f" {plain_on_card['calls']} plain-version calls; want one tie_scan_rows_w launch each")
    mc_w_err = max(float(np.max(np.abs(torch.stack(mc_w_auroc).cpu().numpy() - per_class[:, 0]))),
                   float(np.max(np.abs(torch.stack(mc_w_ap).cpu().numpy() - per_class[:, 1]))))
    if not mc_w_err <= ORACLE_TOL:
        raise AssertionError(f"weighted per-class AUROC/AP off the float64 oracles by {mc_w_err}")
    # multi-label micro at the MS-COCO shape: one stream, one unweighted launch
    zero_counts()
    micro = functional_auroc(torch.from_numpy(ml_scores_np).to(dev), torch.from_numpy(ml_target_np.astype(np.int64))
                             .to(dev), num_classes=COCO_C, average="micro").item()
    micro_launches = counts()
    want_micro = _oracle_auroc(ml_scores_np.ravel(), ml_target_np.ravel())
    if not only(micro_launches, tie_scan=1) or abs(micro - want_micro) > ORACLE_TOL:
        raise AssertionError(f"micro AUROC {micro} (oracle {want_micro}), launches {micro_launches}; want one tie_scan")

    sync_sites = {}

    def curve_syncs(classes):
        """Device-to-host synchronizations of one per-class ROC and one PR
        curve compute over the first ``classes`` columns, after a first
        compute (first calls may synchronize once more)."""
        p, t = mc_preds[:, :classes].contiguous(), mc_target % classes
        found = {}
        for name, fn in (("roc", ROC), ("pr", PrecisionRecallCurve)):
            metric = fn(num_classes=classes)
            metric.update(p, t)
            metric.compute()
            metric._computed = None
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    metric.compute()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
            found[name] = len(sites)
            sync_sites[name] = sites
        return found

    curve_syncs(10)  # the process's first counted window may see one more, from PyTorch itself
    syncs = {c: curve_syncs(c) for c in (10, IMAGENET_C)}
    if syncs[10] != syncs[IMAGENET_C] or not all(syncs[10].values()):
        raise AssertionError(f"host synchronizations per curve compute grow with the classes: {syncs}")
    print(f"per-class curves {IMAGENET_N}x{IMAGENET_C}: every class's ROC and PR curve equals the float64 oracle"
          f" (max |d| {mc_curve_err:.3g}), {mc_curves_s:.3f} s for 10 updates and compute including first calls;"
          f" weighted per-class AUROC/AP within {mc_w_err:.3g} of the oracles, one tie_scan_rows_w launch each;"
          f" micro AUROC at {COCO_N}x{COCO_C} {micro:.7f} (oracle {want_micro:.7f}), one tie_scan launch;"
          f" synchronizations per compute at C=10 and C={IMAGENET_C}: {syncs}, at {sync_sites}")

    # ---- 4d. the binned curves, 512 bins ------------------------------------
    binned_err = {"hist": 0.0, "values": 0.0}

    def check_binned(label, metrics, scores_np, rel_np_, weights_np):
        auroc_m, ap_m, pr_m = metrics
        want_pos, want_neg = _oracle_histograms(scores_np, rel_np_, NUM_BINS, weights_np)
        got_pos, got_neg = auroc_m.hist_pos.cpu().numpy(), auroc_m.hist_neg.cpu().numpy()
        for got, want in ((got_pos, want_pos), (got_neg, want_neg)):
            if weights_np is None:
                if not np.array_equal(got, want):
                    raise AssertionError(f"binned {label}: histogram counts differ from numpy's")
            else:
                rel_err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
                binned_err["hist"] = max(binned_err["hist"], rel_err)
                if not rel_err <= 1e-5:
                    raise AssertionError(f"binned {label}: weighted histograms off numpy's by {rel_err} relative")
        want_auroc, want_ap, want_precision, want_recall = _float64_binned(got_pos, got_neg)
        if scores_np.ndim == 2:
            want_auroc, want_ap = want_auroc.mean(), want_ap.mean()
        precision, recall, _ = pr_m.compute()
        errs = [abs(auroc_m.compute().item() - want_auroc), abs(ap_m.compute().item() - want_ap),
                float(np.max(np.abs(precision.cpu().numpy() - want_precision))),
                float(np.max(np.abs(recall.cpu().numpy() - want_recall)))]
        binned_err["values"] = max(binned_err["values"], *errs)
        if not max(errs) <= CURVE_TOL:
            raise AssertionError(f"binned {label}: values off the float64 evaluation by {errs}")

    mc_onehot = mc_target_np[:, None] == np.arange(IMAGENET_C)
    for label, scores_np, t_dev, rel_host, w_np, kwargs in (
        (f"binary {MAIN_N}", preds_np, target, rel_np, None, {}),
        (f"binary {MAIN_N} weighted", preds_np, target, rel_np, w_1m_np, {}),
        (f"{IMAGENET_N}x{IMAGENET_C}", mc_scores_np, mc_target, mc_onehot, None, {"num_classes": IMAGENET_C}),
        (f"{IMAGENET_N}x{IMAGENET_C} weighted", mc_scores_np, mc_target, mc_onehot, mc_w_np,
         {"num_classes": IMAGENET_C}),
    ):
        metrics = [m(num_bins=NUM_BINS, **kwargs) for m in (BinnedAUROC, BinnedAveragePrecision,
                                                            BinnedPrecisionRecallCurve)]
        p_dev = preds if scores_np.ndim == 1 else mc_preds
        extra = {} if w_np is None else {"sample_weights": torch.from_numpy(w_np).to(dev)}
        for m in metrics:
            m.update(p_dev, t_dev, **extra)
        check_binned(label, metrics, scores_np, rel_host, w_np)
    del mc_onehot
    print(f"binned curves, {NUM_BINS} bins, binary at {MAIN_N} and {IMAGENET_N}x{IMAGENET_C}, unweighted and"
          f" weighted: counts exact, weighted histograms within {binned_err['hist']:.3g} relative, values within"
          f" {binned_err['values']:.3g} of the float64 evaluation")

    # ---- 4e. the stat-score family ------------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    stat_timings, stat_leg, city_collection, city_batch = _stat_score_phase(
        torch, dev, (mc_preds, mc_target, mc_scores_np, mc_target_np), (ml_scores_np, ml_target_np)
    )
    stat_timings["phase_s"] = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"the stat-score family launched a scan kernel: {counts()}")

    # ---- 4f. the regression pack and metric arithmetic ----------------------
    t0 = time.perf_counter()
    reg_timings, reg_profile, frames = _regression_phase(torch, dev, _forward_leg_inputs(torch, dev))
    reg_timings["phase_s"] = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"the regression pack launched a scan kernel: {counts()}")

    # ---- 4g. the retrieval family -----------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    ret_timings, ms_collection = _retrieval_phase(torch, dev)
    ret_timings["phase_s"] = time.perf_counter() - t0
    ret_launches = counts()
    ret_timings["scan_launches"] = ret_launches
    if ret_launches["tie_scan"] < 1 or any(v for k, v in ret_launches.items() if k != "tie_scan"):
        raise AssertionError(f"phase 4g's scans: only the epoch's ShardedAUROC may launch one: {ret_launches}")

    # ---- 4h. the step engine, the shared count, the wrapper and extras ------
    t0 = time.perf_counter()
    engine_timings, engine_profile = _engine_phase(torch, dev, (preds, target))
    engine_timings["phase_s"] = time.perf_counter() - t0

    # ---- 4i. the multi-tenant cohort --------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    cohort_timings = _cohort_phase(torch, dev)
    cohort_timings["phase_s"] = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"the cohort launched a scan kernel: {counts()}")

    # ---- 4j. the observability core ----------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    obs_timings = _observability_phase(torch, dev, (preds, target))
    obs_timings["phase_s"] = time.perf_counter() - t0
    obs_timings["scan_launches"] = counts()
    if counts()["tie_scan"] < 1:
        raise AssertionError(f"phase 4j's north-star step launched no tie_scan kernel: {counts()}")

    # ---- 4k. the sync tiers -------------------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    tier_timings = _sync_tier_phase(torch, dev, (mc_preds, mc_target), (preds, target))
    tier_timings["phase_s"] = time.perf_counter() - t0
    tier_timings["card"] = card
    tier_timings["scan_launches"] = counts()
    if counts()["tie_scan"] < 1:
        raise AssertionError(f"phase 4k's north-star step launched no tie_scan kernel: {counts()}")

    # ---- 4l. the reliability layer --------------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    rel_timings = _reliability_phase(torch, dev, card)
    rel_timings["phase_s"] = time.perf_counter() - t0
    rel_timings["scan_launches"] = counts()
    if counts()["tie_scan"] < 1 or any(v for k, v in counts().items() if k != "tie_scan"):
        raise AssertionError(f"phase 4l's north-star steps: only tie_scan may launch, and at least once: {counts()}")

    # ---- 4m. serving ------------------------------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    srv_timings = _serving_phase(torch, dev, card)
    srv_timings["phase_s"] = time.perf_counter() - t0
    srv_timings["scan_launches"] = counts()
    if counts()["tie_scan"] < 1 or any(v for k, v in counts().items() if k != "tie_scan"):
        raise AssertionError(f"phase 4m's north-star steps: only tie_scan may launch, and at least once: {counts()}")
    print(f"4m. {srv_timings['phase_s']:.1f} s")

    # ---- 4n. the export surface and the cost ledger ----------------------------
    zero_counts()
    t0 = time.perf_counter()
    exp_timings = _exporter_phase(torch, dev, card)
    exp_timings["phase_s"] = time.perf_counter() - t0
    exp_timings["scan_launches"] = counts()
    # the session's forwards launch it for each batch value, its compute() once (checked in the phase)
    if counts()["tie_scan"] < 1 or any(v for k, v in counts().items() if k != "tie_scan"):
        raise AssertionError(f"phase 4n's session: only tie_scan may launch, and at least once: {counts()}")
    print(f"4n. {exp_timings['phase_s']:.1f} s")

    # ---- 4o, first part: the fleet's moves (its failover leg runs last) ----------
    zero_counts()
    fleet_timings = _fleet_phase(torch, dev, card)
    fleet_timings["fleet_scan_launches"] = counts()
    # the moved AUROC tenant's compute() and the unmoved one's launch it once each (checked in the phase)
    if counts()["tie_scan"] != 2 or any(v for k, v in counts().items() if k != "tie_scan"):
        raise AssertionError(f"phase 4o: the two AUROC computes launch tie_scan once each and nothing else: {counts()}")

    # ---- 4p. the analysis passes (before 4o's failover leg and phase 6) --------
    zero_counts()
    analysis_timings = _analysis_phase(torch, dev, card)
    if any(counts().values()):
        raise AssertionError(f"phase 4p launched a scan kernel (its template metric is MSE): {counts()}")
    print(f"4p. {analysis_timings['phase_s']:.1f} s")

    # ---- 4q. the program audit (before 4o's failover leg and phase 5) ----------
    zero_counts()
    audit_timings = _program_audit_phase(torch, dev, card)
    # (a): the MTA006 purity probe computes the registry's AUROC and
    # AveragePrecision once each, and pass 5 launches PASS5_SCAN_LAUNCHES
    # for each; (f) counts its own
    if (audit_timings["tie_scan_launches_a"] != 2 + 2 * PASS5_SCAN_LAUNCHES
            or counts()["tie_scan"] != audit_timings["tie_scan_launches"]
            or any(v for k, v in counts().items() if k != "tie_scan")):
        raise AssertionError(f"phase 4q: (a) launched tie_scan {audit_timings['tie_scan_launches_a']} times, want"
                             f" {2 + 2 * PASS5_SCAN_LAUNCHES}; the phase counted"
                             f" {audit_timings['tie_scan_launches']} against {counts()}")
    print(f"4q. {audit_timings['phase_s']:.1f} s")
    print(json.dumps({"timings": {"program_audit": audit_timings}}))

    # ---- 4r. MetricSan on the card -----------------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    san_timings = _sanitizer_phase(torch, dev, card)
    san_timings["phase_s"] = time.perf_counter() - t0
    san_timings["scan_launches"] = counts()
    # (a)'s two AUROC computes launch it once each, nothing else launches a scan
    if counts()["tie_scan"] != 2 or any(v for k, v in counts().items() if k != "tie_scan"):
        raise AssertionError(f"phase 4r: the two AUROC computes launch tie_scan once each and nothing else: {counts()}")
    print(f"4r. {san_timings['phase_s']:.1f} s")
    print(json.dumps({"timings": {"sanitizer": san_timings}}))

    # ---- 5. times ---------------------------------------------------------
    all_preds = torch.cat(list(collection["AUROC"].preds))
    all_rel = (torch.cat(list(collection["AUROC"].target)) == 1).to(torch.float32)
    key = _sortable_key(all_preds)
    payload = _payload(all_rel, None)
    key_s, pay_s = _co_sort(all_preds, all_rel)
    groups = int((key_s[1:] != key_s[:-1]).sum()) + 1
    kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce(key_s, pay_s))
    plain_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce_reference(key_s, pay_s))
    sort_gather_ms = _queued_ms(torch, lambda: payload[torch.sort(key)[1]])
    sort_packed_ms = _queued_ms(torch, lambda: torch.sort((key.long() << 2) | payload.long()).values)
    # the one-stream kernel on phase 2a's 20M stream, ~4,900 tiles in several waves
    big_groups = int((big_key_s[1:] != big_key_s[:-1]).sum()) + 1
    big_kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce(big_key_s, big_pay_s), launches=20, trials=5)

    # the multi-class compute's rows, (1000, 50000): its batches in order are the whole set
    rows_key = _sortable_key(mc_preds.T)
    rows_payload = _payload(_ovr_relevance(mc_target, IMAGENET_C), None)
    rows_key_s, rows_pay_s = _co_sort_rows(rows_key, rows_payload)
    rows_groups = int((rows_key_s[:, 1:] != rows_key_s[:, :-1]).sum()) + IMAGENET_C
    rows_kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce_rows(rows_key_s, rows_pay_s))
    rows_plain_ms = _queued_ms(
        torch, lambda: tie_scan.tie_group_reduce_rows_reference(rows_key_s, rows_pay_s), launches=2, trials=3
    )
    rows_single_ms = _queued_ms(
        torch, lambda: [tie_scan.tie_group_reduce(rows_key_s[r], rows_pay_s[r]) for r in range(IMAGENET_C)],
        launches=1, trials=5,
    )
    rows_sort_ms = _queued_ms(torch, lambda: _co_sort_rows(rows_key, rows_payload), launches=10)
    flat_key = (torch.arange(IMAGENET_C, device=dev)[:, None] << 32) | (rows_key.long() + 2**31)
    flat_payload = rows_payload.reshape(-1)
    rows_flat_sort_ms = _queued_ms(
        torch, lambda: flat_payload[torch.sort(flat_key.reshape(-1))[1]], launches=10
    )

    # the weighted kernels and their plain versions, at the sharded paths' shapes
    cr_key_s, cr_pay_s, cr_w_s = cr_streams
    cr_groups = int((cr_key_s[1:] != cr_key_s[:-1]).sum()) + 1
    w_kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce(cr_key_s, cr_pay_s, weights_s=cr_w_s),
                             launches=10, trials=5)
    w_plain_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce_reference(cr_key_s, cr_pay_s, None, cr_w_s),
                            launches=1, trials=3)
    rows_w_key_s, rows_w_pay_s, rows_w_s = _co_sort_rows(rows_key, rows_payload, mc_w)
    w_rows_kernel_ms = _queued_ms(
        torch, lambda: tie_scan.tie_group_reduce_rows(rows_w_key_s, rows_w_pay_s, weights_s=rows_w_s), launches=20
    )
    w_rows_plain_ms = _queued_ms(
        torch, lambda: tie_scan.tie_group_reduce_rows_reference(rows_w_key_s, rows_w_pay_s, None, rows_w_s),
        launches=1, trials=3,
    )
    # the offset form at 1M
    offsets = (1234.0, 777.0)
    off_kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce(key_s, pay_s, offsets))
    off_plain_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce_reference(key_s, pay_s, offsets),
                              launches=2, trials=3)

    def recompute_ms(coll, trials=5):
        """Host ms of compute() ending in a synchronize, the cached values
        dropped first; median of ``trials`` after one more call."""
        times = []
        for _ in range(trials + 1):
            for metric in coll.values():
                metric._computed = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            coll.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times[1:]))

    sharded_compute_ms = recompute_ms(sharded)
    ovr_compute_ms = recompute_ms(ovr)
    # the curve family: host clock ending in a synchronize, one warm-up, median of 5
    roc_1m_ms = recompute_ms(MetricCollection([curves["ROC"]]))
    pr_1m_ms = recompute_ms(MetricCollection([curves["PrecisionRecallCurve"]]))
    roc_mc_ms = recompute_ms(MetricCollection([mc_curves["ROC"]]))
    pr_mc_ms = recompute_ms(MetricCollection([mc_curves["PrecisionRecallCurve"]]))
    partial_ms = recompute_ms(MetricCollection([partial]))

    def warm_host_ms(fn):
        fn()
        return _host_ms(torch, fn)

    w_auroc_1m_ms = warm_host_ms(lambda: functional_auroc(preds, target, pos_label=1, sample_weights=w_1m))
    binned_1m = BinnedAUROC(num_bins=NUM_BINS)
    binned_mc = BinnedAUROC(num_bins=NUM_BINS, num_classes=IMAGENET_C)
    binned_update_1m_ms = warm_host_ms(lambda: binned_1m.update(preds, target))
    binned_update_mc_ms = warm_host_ms(lambda: binned_mc.update(mc_preds, mc_target))

    collection.persistent(True)
    saved = _saved(collection)

    def compute_fresh(make, state):
        # a collection restored from the saved states, so compute() has no cached value
        fresh = make()
        fresh.load_state_dict(state, strict=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fresh.compute()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def binary_collection():
        return MetricCollection([Accuracy(), AUROC(pos_label=1)])

    compute_fresh(binary_collection, saved)
    compute_ms = float(np.median([compute_fresh(binary_collection, saved) for _ in range(5)]))
    compute_fresh(mc_collection, mc_saved)
    mc_compute_ms = float(np.median([compute_fresh(mc_collection, mc_saved) for _ in range(5)]))
    forward_ms = _host_ms(torch, lambda: collection(preds[:BATCH], target[:BATCH]))
    bound_ms, bound_by = _bound(key_s.numel(), groups, 1)
    big_bound_ms, _ = _bound(BIG_N, big_groups, 1)
    rows_bound_ms, rows_bound_by = _bound(rows_key_s.numel(), rows_groups, IMAGENET_C)
    w_bound_ms, w_bound_by = _bound(CRITEO_N, cr_groups, 1, weighted=True)
    w_rows_bound_ms, w_rows_bound_by = _bound(rows_w_key_s.numel(), rows_groups, IMAGENET_C, weighted=True)
    timings = {
        "n": key_s.numel(),
        "tie_groups": groups,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "co_sort_int32_sort_gather_ms": sort_gather_ms,
        "co_sort_packed_int64_ms": sort_packed_ms,
        "forward_batch_ms": forward_ms,
        "compute_step_ms": compute_ms,
        "forward_10_batches_first_run_s": t_forward,
        "kernel_bytes": 8 * key_s.numel() + 16,
        "bound_ms": bound_ms,
        "big_n": BIG_N,
        "big_tie_groups": big_groups,
        "big_kernel_ms": big_kernel_ms,
        "big_kernel_bytes": 8 * BIG_N + 16,
        "big_bound_ms": big_bound_ms,
        "rows_shape": list(rows_key_s.shape),
        "rows_tie_groups": rows_groups,
        "rows_kernel_ms": rows_kernel_ms,
        "rows_plain_ms": rows_plain_ms,
        "rows_as_1000_one_stream_launches_ms": rows_single_ms,
        "rows_co_sort_segmented_sort_gather_ms": rows_sort_ms,
        "rows_co_sort_flat_int64_sort_gather_ms": rows_flat_sort_ms,
        "rows_kernel_bytes": 8 * rows_key_s.numel() + 16 * IMAGENET_C,
        "rows_bound_ms": rows_bound_ms,
        "multiclass_compute_step_ms": mc_compute_ms,
        "multiclass_update_10_batches_and_compute_first_run_s": mc_path_s,
        "weighted_n": CRITEO_N,
        "weighted_tie_groups": cr_groups,
        "weighted_kernel_ms": w_kernel_ms,
        "weighted_plain_ms": w_plain_ms,
        "weighted_kernel_bytes": 12 * CRITEO_N + 16,
        "weighted_bound_ms": w_bound_ms,
        "weighted_rows_kernel_ms": w_rows_kernel_ms,
        "weighted_rows_plain_ms": w_rows_plain_ms,
        "weighted_rows_kernel_bytes": 12 * rows_w_key_s.numel() + 16 * IMAGENET_C,
        "weighted_rows_bound_ms": w_rows_bound_ms,
        "offsets_kernel_ms": off_kernel_ms,
        "offsets_plain_ms": off_plain_ms,
        "sharded_binary_compute_step_ms": sharded_compute_ms,
        "sharded_binary_updates_and_compute_first_run_s": sharded_path_s,
        "sharded_ovr_compute_step_ms": ovr_compute_ms,
        "sharded_ovr_updates_and_compute_first_run_s": ovr_path_s,
        "roc_compute_1m_ms": roc_1m_ms,
        "pr_curve_compute_1m_ms": pr_1m_ms,
        "roc_compute_1000x50000_ms": roc_mc_ms,
        "pr_curve_compute_1000x50000_ms": pr_mc_ms,
        "max_fpr_auroc_compute_1m_ms": partial_ms,
        "weighted_functional_auroc_1m_ms": w_auroc_1m_ms,
        "binned_update_1m_x512_ms": binned_update_1m_ms,
        "binned_update_50000x1000_x512_ms": binned_update_mc_ms,
        "binary_curves_first_run_s": curves_path_s,
        "per_class_curves_first_run_s": mc_curves_s,
        "curve_path_launches": {"weighted_auroc_1m": w_auroc_launches, "weighted_ap_1m": w_ap_launches,
                                "weighted_auroc_1000": mc_w_auroc_launches, "weighted_ap_1000": mc_w_ap_launches,
                                "micro_auroc_coco": micro_launches, "phase_3c_in_all": curve_launches},
        "per_class_curve_syncs": {str(k): v for k, v in syncs.items()},
        "per_class_curve_sync_sites": sync_sites,
        "stat_score_family": stat_timings,
        "regression_pack": reg_timings,
        "retrieval": ret_timings,
        "step_engine": engine_timings,
        "cohort": cohort_timings,
        "observability": obs_timings,
        "sync_tiers": tier_timings,
        "reliability": rel_timings,
        "serving": srv_timings,
        "exporter": exp_timings,
        "analysis": analysis_timings,
        "card": card,
    }
    print(json.dumps({"timings": timings}))

    # ---- 6. where the time goes -------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fresh = binary_collection()
    fresh.load_state_dict(saved, strict=True)
    fresh(preds[:BATCH], target[:BATCH])  # first-call costs stay out of the window
    fresh.load_state_dict(saved, strict=True)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        fresh(preds[:BATCH], target[:BATCH])
        fresh.compute()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t) * 1e3
    averages = prof.key_averages()
    sort_key = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
    device_ms = sum(_device_ms_by_kernel(torch, prof, sort_key).values())
    print(averages.table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    print(averages.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=48))
    # the plain version at 1M, by ATen kernel
    with profile(activities=activities) as prof_plain:
        tie_scan.tie_group_reduce_reference(key_s, pay_s)
        torch.cuda.synchronize()
    print(prof_plain.key_averages().table(sort_by=sort_key, row_limit=10, max_name_column_width=48))
    # one multi-class compute step, restored from the saved states
    fresh_mc = mc_collection()
    fresh_mc.load_state_dict(mc_saved, strict=True)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_mc:
        t = time.perf_counter()
        fresh_mc.compute()
        torch.cuda.synchronize()
        mc_window_ms = (time.perf_counter() - t) * 1e3
    mc_split = _device_ms_by_kernel(torch, prof_mc, sort_key)
    print(prof_mc.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    # one weighted sharded binary compute (both metrics) at 45,840,617
    for metric in sharded.values():
        metric._computed = None
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_sh:
        t = time.perf_counter()
        sharded.compute()
        torch.cuda.synchronize()
        sh_window_ms = (time.perf_counter() - t) * 1e3
    sh_split = _device_ms_by_kernel(torch, prof_sh, sort_key)
    print(prof_sh.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    # one per-class ROC compute at (1000, 50000)
    mc_curves["ROC"]._computed = None
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_roc:
        t = time.perf_counter()
        mc_curves["ROC"].compute()
        torch.cuda.synchronize()
        roc_window_ms = (time.perf_counter() - t) * 1e3
    roc_split = _device_ms_by_kernel(torch, prof_roc, sort_key)
    print(prof_roc.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    # one forward batch of the JAX bench's forward leg (Accuracy + macro Precision/Recall/F1 at 100k)
    leg, leg_batch = stat_leg
    leg(*leg_batch)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_leg:
        t = time.perf_counter()
        leg(*leg_batch)
        torch.cuda.synchronize()
        leg_window_ms = (time.perf_counter() - t) * 1e3
    leg_split = _device_ms_by_kernel(torch, prof_leg, sort_key)
    print(prof_leg.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    print(prof_leg.key_averages().table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=48))
    # one Cityscapes update of the stat-score collection (4 images, 19 classes)
    city = city_collection()
    city.update(*city_batch)
    city = city_collection()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_city:
        t = time.perf_counter()
        city.update(*city_batch)
        torch.cuda.synchronize()
        city_window_ms = (time.perf_counter() - t) * 1e3
    city_split = _device_ms_by_kernel(torch, prof_city, sort_key)
    print(prof_city.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    # one forward batch of the JAX bench's regression leg (5 metrics at 100k), and one ssim at 4 x 3 x 1024 x 2048
    reg_coll, reg_batch = reg_profile
    windows = {}
    for label, call in (("regression_forward_batch", lambda: reg_coll(*reg_batch)),
                        ("ssim_4x3x1024x2048", lambda: functional_ssim(*frames, data_range=1.0))):
        call()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof_window:
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            window = (time.perf_counter() - t) * 1e3
        split = _device_ms_by_kernel(torch, prof_window, sort_key)
        print(prof_window.key_averages().table(sort_by=sort_key, row_limit=12, max_name_column_width=48))
        windows[label] = {"window_ms": window, "device_ms": sum(split.values()),
                          "device_busy_share": sum(split.values()) / window,
                          "device_ms_by_kernel": dict(sorted(split.items(), key=lambda kv: -kv[1])[:12])}
    # one compiled forward batch of phase 4h's forward leg and regression leg: one graph replay each
    for label, (coll, batch) in engine_profile.items():
        coll(*batch)
        torch.cuda.synchronize()
        with profile(activities=activities) as prof_window:
            t = time.perf_counter()
            coll(*batch)
            torch.cuda.synchronize()
            window = (time.perf_counter() - t) * 1e3
        split = _device_ms_by_kernel(torch, prof_window, sort_key)
        print(prof_window.key_averages().table(sort_by=sort_key, row_limit=12, max_name_column_width=48))
        print(prof_window.key_averages().table(sort_by="self_cpu_time_total", row_limit=8, max_name_column_width=48))
        windows[f"compiled_{label}_batch"] = {
            "window_ms": window, "device_ms": sum(split.values()), "device_busy_share": sum(split.values()) / window,
            "device_ms_by_kernel": dict(sorted(split.items(), key=lambda kv: -kv[1])[:12])}
    # one compute of the MS MARCO collection (MAP, MRR, P@10, R@100 over 6,980,000 rows)
    for metric in ms_collection.values():
        metric._computed = None
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_ret:
        t = time.perf_counter()
        ms_collection.compute()
        torch.cuda.synchronize()
        ret_window_ms = (time.perf_counter() - t) * 1e3
    ret_split = _device_ms_by_kernel(torch, prof_ret, sort_key)
    ret_sort_ms = sum(v for k, v in ret_split.items() if "sort" in k.lower())
    print(prof_ret.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    # one call of each kernel entry: one launch and at most the memset of its scratch
    entry_splits = {}
    for label, kernel, call in (
        ("tie_scan", "::tie_scan_kernel(", lambda: tie_scan.tie_group_reduce(key_s, pay_s)),
        ("tie_scan_rows", "::tie_scan_kernel(", lambda: tie_scan.tie_group_reduce_rows(rows_key_s, rows_pay_s)),
        ("weighted", "::tie_scan_w_kernel(", lambda: tie_scan.tie_group_reduce(cr_key_s, cr_pay_s, weights_s=cr_w_s)),
        ("weighted_rows", "::tie_scan_w_kernel(",
         lambda: tie_scan.tie_group_reduce_rows(rows_w_key_s, rows_w_pay_s, weights_s=rows_w_s)),
    ):
        prof_entry = _steady_profile(torch, call, shows=kernel)
        split = _device_ms_by_kernel(torch, prof_entry, sort_key)
        others = [k for k in split if kernel not in k]
        if len(split) - len(others) != 1 or len(others) > 1 or any("Memset" not in k for k in others):
            device = [(e.name[:40], e.device_type == torch.autograd.DeviceType.CUDA) for e in prof_entry.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA or "tie_scan" in e.name]
            raise AssertionError(f"one {label} call ran {sorted(split)}; want one kernel and at most its memset"
                                 f" (device records of each trace: {PROFILE_LAST_RECORDS}; the kept trace's"
                                 f" device events: {device[:8]})")
        entry_splits[label] = split
    print(json.dumps({"profile": {
        "window": "one forward batch of 100k + compute at 1.1M, under torch.profiler",
        "window_ms": window_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "multiclass_compute_window_ms": mc_window_ms,
        "multiclass_compute_device_ms": sum(mc_split.values()),
        "multiclass_compute_device_ms_by_kernel": dict(sorted(mc_split.items(), key=lambda kv: -kv[1])[:12]),
        "sharded_binary_compute_window_ms": sh_window_ms,
        "sharded_binary_compute_device_ms": sum(sh_split.values()),
        "sharded_binary_compute_device_ms_by_kernel": dict(sorted(sh_split.items(), key=lambda kv: -kv[1])[:12]),
        "per_class_roc_compute_window_ms": roc_window_ms,
        "per_class_roc_compute_device_ms": sum(roc_split.values()),
        "per_class_roc_compute_device_ms_by_kernel": dict(sorted(roc_split.items(), key=lambda kv: -kv[1])[:12]),
        "forward_leg_batch_window_ms": leg_window_ms,
        "forward_leg_batch_device_ms": sum(leg_split.values()),
        "forward_leg_batch_device_ms_by_kernel": dict(sorted(leg_split.items(), key=lambda kv: -kv[1])[:12]),
        "cityscapes_update_window_ms": city_window_ms,
        "cityscapes_update_device_ms": sum(city_split.values()),
        "cityscapes_update_device_ms_by_kernel": dict(sorted(city_split.items(), key=lambda kv: -kv[1])[:12]),
        "regression_forward_batch": windows["regression_forward_batch"],
        "msmarco_compute_window_ms": ret_window_ms,
        "msmarco_compute_device_ms": sum(ret_split.values()),
        "msmarco_compute_device_busy_share": sum(ret_split.values()) / ret_window_ms,
        "msmarco_compute_sort_share": ret_sort_ms / max(sum(ret_split.values()), 1e-12),
        "msmarco_compute_device_ms_by_kernel": dict(sorted(ret_split.items(), key=lambda kv: -kv[1])[:12]),
        "ssim_4x3x1024x2048": windows["ssim_4x3x1024x2048"],
        "compiled_forward_leg_batch": windows["compiled_forward_leg_batch"],
        "compiled_regression_leg_batch": windows["compiled_regression_leg_batch"],
        "kernel_device_ms_by_kernel": entry_splits["tie_scan"],
        "rows_kernel_device_ms_by_kernel": entry_splits["tie_scan_rows"],
        "weighted_kernel_device_ms_by_kernel": entry_splits["weighted"],
        "weighted_rows_kernel_device_ms_by_kernel": entry_splits["weighted_rows"],
    }}))
    kernels = [
        {
            "name": "tie_scan",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        },
        {
            "name": "tie_scan_rows",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": rows_launches,
            "max_abs_err": max_err_rows,
            "ms": rows_kernel_ms,
            "plain_ms": rows_plain_ms,
            "bound_ms": rows_bound_ms,
            "bound_by": rows_bound_by,
            "library_ms": None,
        },
        {
            "name": "tie_scan_w",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": sh_launches["tie_scan_w"],
            "max_abs_err": max_err_w,
            "ms": w_kernel_ms,
            "plain_ms": w_plain_ms,
            "bound_ms": w_bound_ms,
            "bound_by": w_bound_by,
            "library_ms": None,
        },
        {
            "name": "tie_scan_rows_w",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": ovr_launches["tie_scan_rows_w"],
            "max_abs_err": max_err_rows_w,
            "ms": w_rows_kernel_ms,
            "plain_ms": w_rows_plain_ms,
            "bound_ms": w_rows_bound_ms,
            "bound_by": w_rows_bound_by,
            "library_ms": None,
        },
        {
            # the sample sort's bucket epilogue (phase 2c′), its path on one card
            "name": "tie_scan offsets",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": offset_launches,
            "max_abs_err": max_err_off,
            "ms": off_kernel_ms,
            "plain_ms": off_plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        },
    ]
    # ---- 4o, second part: the failover leg and the kills (last: minutes of host work) ----
    zero_counts()
    fleet_timings.update(_fleet_failover_phase(torch, dev, card))
    if any(counts().values()):
        raise AssertionError(f"phase 4o's failover leg launched a scan kernel: {counts()}")
    print(f"4o. {fleet_timings['fleet_moves_phase_s'] + fleet_timings['fleet_failover_phase_s']:.1f} s")
    print(json.dumps({"timings": {"fleet": fleet_timings}}))

    reads = sum(v for k, v in PROFILE_TRACES_TAKEN.items() if k != "lost")
    print(f"profiler: {reads} counts read off an agreed trace; traces taken per count: {PROFILE_TRACES_TAKEN}"
          " (2: the first two agreed; lost: traces with no device record or without the kernel required)")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check")
    print(json.dumps({"kernels": kernels}))
    # the run used one card (pinned above)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
