#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--frames N]

Phases (any failure exits nonzero before the result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels from ``opencv_facerecognizer_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print each kernel
   instantiation's registers, spills and barriers from ``-Xptxas -v``;
3. hold each kernel against its plain PyTorch version on the card:
   the streaming match (kernel A) at Q = 512, D = 256, N = 2^20 bf16 with
   duplicate and invalid rows at k = 1, 5, 16, 17 and 64, on ragged
   galleries that end mid-tile (bf16 and f32, D = 256 and 64, fewer valid
   rows than k), and on the 2^20-row gallery stored in f32; the fused
   separable block (kernel B) at the six serving block shapes, bf16 and
   f32, at B = 512, 37 and 601 (more than two samples per persistent CTA;
   these must also equal the same samples run one per CTA, bit for bit),
   and at blocks with F = 48 and 96 (OTHER_BLOCKS). Time each at the
   serving shape: the wrapper's time by CUDA events around eager calls,
   host work included (``ms``), the kernel's device time from a CUDA
   graph of back-to-back calls (``device_ms``), its plain version and one
   PyTorch call computing the same function. The NMS keep-mask (kernel C)
   flag for flag against the plain loop at the serving shape [32, 64] and
   on tie-heavy sets (NMS_TIE_CASES, up to K = 1024), and timed at the
   serving shape;
4. serve: a ``RecognizerService`` over ``FakeConnector`` with the serving
   detector and embedder (random weights from ``--seed``), a 2^20-row
   bf16 gallery, batches of 32 256x256 uint8 frames and the fused
   embedder, every ladder rung a CUDA graph captured at warmup. Every
   frame must get one result, each step must launch kernel C once, kernel
   B six times and kernel A once (replays counted), and the faces of the
   first batch must find their own planted gallery rows; the first batch
   through the same stack in f32 must agree with the CPU (smaller
   gallery; see XCHECK_*);
5. time the steady-state serving step four ways in turns, CUDA graphs
   or eager, fused or unfused embedder: host clock with the result read
   back per step, host clock back to back, and profiled (device time by
   kernel, the card's busy share, device operations and graph launches
   per step); the capture time of each rung and the graph pool's bytes;
   the graphed and eager steps' outputs compared. One ``{"step": ...}``
   line;
9. (run after 5) async grow under load: a 2^20-row bf16 gallery with
   ``async_grow=True`` filled to GROW_HEADROOM rows short of its tier,
   steps of the phase-4 stack served back to back on a thread while the
   faces of one batch are enrolled (overflowing the tier): each step's
   host-clock ms before, during and after the grow, the grow's stages
   (``last_grow_info``) and the seconds from ``add`` to ``wait_ready``.
   Every step must return its frames' results, the subject must then be
   named at the 2^21 tier through kernels A, B and C, nothing may stay
   staged. Then adds of 2 rows within the tier (in place) against one
   whole-gallery upload at that tier. One ``{"async_grow": ...}`` line;
6. IVF: the same 2^20 rows in a gallery with a ``CoarseQuantizer``
   attached in mode ``"auto"`` (``default_nlist``, ``nprobe`` 8), as the
   reference's recognizer serves such a gallery. Build it (nlist,
   max_cell, spill, the lists' device bytes, the build's stages), enrol the
   first batch's faces after the build (the incremental path), hold the
   two-stage match with kernel A as the rerank against the same match
   with the plain rerank at Q = 512 and 32, k = 1 and 5, serve the frames
   again (one result each, planted rows found, kernel A launched, every
   step through the IVF path), time the serving step through IVF, time
   ``gallery.match`` through IVF (split into stage 1, bucket, rerank) and
   through the exact kernel at Q = 512 down to 16 on 2^18 and 2^20 rows
   (the 2^22-row timing was cut for phase 18's time), print the two-stage recall against the exact scan at 2^20, and
   run the reference's ``bench.py --ivf-smoke`` recall gate (>= 0.99).
   Its numbers are one ``{"ivf": ...}`` line;
7. cli: the serving detector and embedder (the weights of phase 4) written
   by the port's ``CNNFaceDetector.save`` and ``save_model`` (a
   ``CNNEmbedding`` in ``PredictableModel(..., NearestNeighbor(
   CosineDistance()))``), a gallery directory and a frames directory of
   PGM images (``build/cli_smoke/``); ``apps.recognize.main`` in dir mode
   on them with a 2^20-row gallery, the exact match and the fused
   embedder. Every frame must get one result, both kernels must launch,
   the first batch must agree with a direct ``RecognitionPipeline`` call
   on the loaded weights (XCHECK_*) and the ledger must close. Then the
   CLI in jsonl mode in a subprocess (``python -m``): frames, an
   ``enroll`` command, frames of one scene until ``enrolled`` comes back,
   more frames of that scene (which must come back with the enrolled
   name), ``stats``, EOF. Its numbers are one ``{"cli": ...}`` line,
   each time with the card's name and power limit: the load and embed
   seconds as the CLI's own loader logs them (the ``startup`` record of
   ``--metrics-jsonl``), and the dir run's frames/s and the jsonl run's
   latencies, which are smoke observations (64 frames in two batches,
   about 20 requests, a gallery of 8-10 rows) and no measure of
   throughput or latency.
8. durability: phase 4's stack over phase 6's IVF gallery (2^20 bf16 rows,
   its built quantizer) with a ``StateLifecycle`` (``build/state_smoke/``,
   ``keep_checkpoints`` 2, WAL fsync ``always``) attached to a
   ``RecognizerService``: the first checkpoint, 4 subjects enrolled
   through the control topic (the first grows the gallery to 2^21 rows),
   a forced checkpoint (2 GiB in flax's chunked form, and the IVF
   sidecar), 2 more subjects (WAL only), then a "crash" (the WAL closed,
   no shutdown, no checkpoint) and ``recover`` into a fresh gallery with a
   fresh quantizer. The recovery must report the checkpoint, 2 replayed
   records and the loaded sidecar, and give host mirrors, size, capacity
   and names equal to the crashed service's, and ``gallery.match`` (Q =
   512, k = 1 and 5) equal indices and sims through kernel A on the exact
   path and through the two-stage path. Then the frames again through the
   recovered gallery under ``ServiceSupervisor`` in three waves: a result
   subscriber raising once (the readback worker dies), then a state tick
   raising once with a batch in hand (the dispatch loop dies and settles
   that batch as crashed drops): two restarts, one result per frame
   outside that batch, a ledger that closes, the planted faces found,
   both kernels launched after the restarts. Then the CLI with
   ``--state-dir`` (``--capacity`` CLI_STATE_CAPACITY): enrol and SIGKILL; a second writer refused while the
   first lives; a restart names the subject (WAL replay); SIGTERM exits
   0 with a clean report; a third start recovers that checkpoint with
   nothing to replay and names the subject. Its numbers are one ``{"durability": ...}`` line: checkpoint
   and recovery seconds by stage, bytes, peak host RSS, WAL append p50 /
   max and the CLI's startup seconds, with the card's name and power
   limit; smoke observations, not measurements.

10. (run after 8) overload: the stage table of ``/attribution`` first,
   per-bucket ms of detect, crop, embed and match at buckets 8 and 32 from
   ablated prefixes of the graphed step (CUDA graphs of back-to-back
   calls), written to ``opencv_facerecognizer_tpu_torch/
   stage_quotes_h100.json`` with the card's name and power limit. Then the
   CLI (phase 7's checkpoints, ``--capacity 1048576 --match-mode exact
   --fused-embedder --batch-size 32``) on ``--source socket`` in two
   subprocesses, fed 256x256 uint8 frames from ``--seed`` as pre-encoded
   JSONL lines by a producer thread. (a) with ``--trace-sample 1.0
   --trace-jsonl --flight-dir --expo-port 0 --slo --profile-dir
   --profile-batches 8``: an unpaced burst of 256 frames (the profiled
   batches), then R, answered frames/s over a second burst of 256, then
   600 interactive frames at 0.5 R; the span split (queue wait, dispatch,
   ready wait, publish, e2e; p50, p99), ``/attribution``, ``/health`` and
   a lint of ``/prom`` (0 problems), and the profile must name kernels A,
   B and C. (The untraced run (a0), whose R this was, and (a1), spans in
   the rings only, were cut for phases 15 (d) and 18's time: the tracer's
   cost is no longer measured.) (b) 1000 deliveries at 3 R over four connections,
   one interactive in four, every twentieth repeating an answered
   ``_fid``, with ``--max-inflight-frames 256 --brownout-queue-wait-ms 20
   --shed-stale-after-ms 250 --dead-letter-journal --journal-fsync
   always`` and tracing. Gates: every run's ledger closes and no step is
   captured after warmup (the ``shutdown`` record of ``--metrics-jsonl``),
   kernels A, B and C launch in every run; in (b) the results and the
   journal hold every admitted ``_fid`` once, the dedups equal the
   repeats, the brownout rises to at least 1 and is back to 0 within 10 s
   of the burst (its lifecycle spans printed), the intake shed takes no
   interactive frame, interactive frames complete more often than bulk
   ones, and the journaled dead letters equal the count. One
   ``{"overload": ...}`` line with the run's total seconds.

11. (run after 10) ingest: (a) phase 4's stack (its graphs) serves
   ING_BATCHES batches of 32 distinct 256x256 uint8 frames back to back
   through a ``RecognizerService`` three times: the pageable path
   (``transfer_dtype`` uint8, the step copies the host frames), the
   pinned staging ring with the side-stream upload (``IngestConfig
   ("uint8")``), the pageable path again. Every batch's packed result over
   the ring must equal both pageable runs' bit for bit (a buffer or graph
   slot overwritten too early would show), the ring must allocate nothing
   past its preallocation, no step may be captured after warmup, and
   ING_PROFILE_BATCHES more batches under ``torch.profiler`` must show the
   frames crossing as ``Memcpy HtoD (Pinned -> Device)`` (the pageable
   runs show ``Pageable``), with its device time per copy; dispatch p50 of
   each run. (b) the CLI on ``--source socket`` with ``--ingest-mode
   uint8`` and with ``--ingest-mode jpeg`` (JPEG payloads of 64 seeded
   frames at quality 85, one delivery in ING_CORRUPT_EVERY truncated), spans
   in the rings (``/spans``) and the dead-letter journal: R from a burst of
   256, then 600 frames at 0.5 R and the span split with the ``upload``
   and ``decode`` spans. Every corrupt delivery must be journaled once as
   ``decode_error``, the ledger must close, and each JPEG frame's result
   must agree with a direct pipeline call on the same bytes decoded on the
   host (XCHECK_*, labels equal). One ``{"ingest": ...}`` line.
12. (run after 11) rollout: phase 4's stack over the last RO_ROWS (2^19)
   of its rows, the planted faces among them (cut from all 2^20 for phase
   15 (d)'s time), in a bf16 gallery with a ``StateLifecycle`` (``build/rollout_smoke/``, a
   first checkpoint), served through the pinned ring while a producer
   injects a batch every RO_TICK_S. A ``RolloutCoordinator`` to version 2:
   ``reembed_fn`` a seeded orthogonal rotation of the rows, ``new_embed_fn``
   the old embedder on the card (fused, kernel B) then the rotation. The
   stage (chunks of RO_CHUNK_ROWS) dies at its append (``stage: crash``)
   after RO_CRASH_AFTER_CHUNKS chunks and a new coordinator resumes it
   from the watermark; the staged rows must equal the same re-embed done
   without a crash, bit for bit. Parity reaches RO_PARITY_SAMPLES from the
   publish path's live offers. A cutover dies after its fence record
   (``cutover: crash_after_record``); ``recover`` into a fresh gallery must
   complete it from the stage. Then the cutover lands in the serving
   process. Gates: in publish order, every published result's and every
   batch's ``embedder_version`` moves from 1 to 2 once; each ladder rung's graph
   is captured again once after the cutover and never again; the planted
   faces' rows in the new space find their labels through kernel A
   (sim >= 0.99), and the recovered gallery's matches equal the served
   one's bit for bit. Numbers: stage, cutover (fence, upload, forced
   checkpoint) and recovery seconds, the stage file's bytes, and the
   serving batch's host-clock ms (inject to its last result) during the
   stage and after the cutover. One ``{"rollout": ...}`` line, with the
   run's total seconds.

13. (run after 12) cascade and registry: phase 4's stack (its detector, the
   serving embedder, fused, the 2^20-row bf16 gallery) with a stage-1
   ``FaceGate()`` (``features`` (8, 16), ``downsample`` 4, bf16, weights from
   ``--seed``: training is not ported), batches of 32 256x256 uint8 frames
   through the pinned ring, ladder (8, 32). (a) CASC_CANDIDATES seeded frames
   (half with stamped faces) are scored on the CPU in f32; a threshold is
   chosen and frames whose CPU score lies more than CASC_MARGIN from it are
   drawn into batches of 0, 6 and 20 survivors (the whole-batch exit, the 8
   rung, the 32 rung), each served CASC_REPEATS times, and a full batch
   through the same stack without the cascade as often. Gates: the card's
   stage-1 scores within CASC_SCORE_ATOL of the CPU's and the keep masks
   equal; each rejected frame published once with no faces and ``exit:
   "cascade"``; each survivor's result equal bit for bit to a direct call of
   the compacted batch at its rung; ``completed_empty`` equal to the rejects,
   the ledger closed, ``cascade_errors`` 0; one stage-1 graph a rung captured
   at warmup and nothing captured after; kernels A, B and C launched once,
   six times and once a stage-2 step. (b) a live detector swap with a
   ``StateLifecycle`` and a ``ModelRegistry`` in ``build/cascade_smoke/``
   while a producer injects a batch every REG_TICK_S: v2 (v1 plus a seeded
   perturbation of REG_PERTURB of each tensor's spread) through the parity
   window fed by the publish path, the cutover (fence, manifest, in-place
   install, cache flush, forced checkpoint) and the watch; v3 (the heatmap
   bias at -30: no face anywhere) refused by the parity gate; a swap to v4
   dying after its fence (``cutover: crash_after_record``), completed by
   ``recover``; a swap to v5 dying likewise with its staged file damaged,
   abandoned and retired by ``recover``. Gates: in publish order the
   results' and the batches' detector stamps move from 1 to 2 once, each
   result carries its batch's stamp, and each
   result equals a direct call of the version it names; no stage-2 graph
   captured (a same-architecture swap). (c) the CLI: ``--registry-swap
   cascade=2`` offline in-process, then ``--source socket`` with ``--cascade
   PATH --cascade-version 2 --state-dir --capacity`` CLI_STATE_CAPACITY in
   a subprocess: every frame
   answered, the rejects as predicted, the ledger closed, nothing captured
   after warmup. Numbers: stage-1 ms per rung (events around the graph's
   replays, and the device time of its kernels in a graph of back-to-back
   calls), the ``cascade_score`` p50, the step's host ms for the full batch
   and the 0 / 6 / 20-survivor batches, the cutover's seconds by stage and
   the worst serving batch during it. One ``{"cascade": ...}`` line.

14. (run after 13) replication: (a) in-process, a writer service with a
   ``StateLifecycle`` (fsync ``always``) and a ``ModelRegistry`` over the
   2^20-row bf16 tier (REPL_HEADROOM rows left free, so enrolments append
   within it) and a reader service with ``replica=ReadReplica(...)`` over
   its own gallery, resynced from the writer's checkpoint; each its own
   detector (v1), both graphed, a batch of 32 every REPL_TICK_S through the
   ring. REPL_SUBJECTS enrolments through the writer's control topic, one
   every REPL_ENROL_EVERY_S (the writer's producer held meanwhile), the
   port's ``--follow`` verifier over REPL_FOLLOW_S from the last
   REPL_FOLLOW_LAST of them (it must see every record); once the reader's
   lag is 0 its rows, labels, valid flags (host and card) and names equal
   the writer's bit for bit, a batch of
   the subjects' frames is equal on both services and to a direct call, an
   enrol on the reader is refused (``read_replica``) and the reader
   captured nothing for the appends. A checkpoint compacts the WAL: the
   tailer reopens without a resync. A writer's apply that fails after the
   reader applied its row: the tombstone forces one resync, and the rows
   are equal again. A detector swap v1 -> v2 on the writer (phase 13's v2,
   ``RegistrySwapCoordinator``, its forced checkpoint landing after the
   reader parked on the fence): the reader re-anchors once, installs v2,
   its detector stamps move 1 -> 2 once in publish order and each result
   equals a direct call of its version. Then, the writer idle and both
   drained, the counts are set to 0 and the reader alone serves
   REPL_ALONE_BATCHES batches: each of A, B and C launched on its path.
   Numbers: the visible latency (the writer's ``enrolled`` to the reader's
   first result naming the subject, and to the reader's apply), poll and
   apply ms, ``lag_s``, each resync's stages, the reader's worst tick
   during a resync against its p50, and for each serving resync the
   longest gap between two of the reader's results and the frames its
   batcher dropped, its re-captures, the reader's launches of A, B and C.
   (c) the port's verifier
   (``python -m ...apps.verify_checkpoint``) on (a)'s dir: rc 0, and rc 2
   on a copy (taken before the compaction) with one base64 byte of an
   acknowledged record flipped. (b) the CLI (phase 7's checkpoints, phase
   10's configuration at ``--capacity`` CLI_STATE_CAPACITY) as a writer
   and a reader on one ``--state-dir``,
   each on a socket with fixed ports (the reader starts once the writer's
   first checkpoint is on disk), and a router CLI in front of both with
   ``--router-health`` on their ``/health``, ``--router-link-deadline-s``
   REPL_LINK_DEADLINE_S and ``--router-hedge-deadline-s``
   REPL_HEDGE_DEADLINE_S: R from a burst of REPL_BURST through the router,
   REPL_DIRECT_FRAMES straight to the writer at REPL_RATE_SHARE x R, then
   REPL_TOPICS camera topics x REPL_FRAMES_PER_TOPIC interactive frames
   through the router at that rate, the reader SIGKILLed at REPL_KILL_AT of
   them; its topics fail over (within the link deadline and a health
   sweep), the reader restarts at its ports, resyncs, its link comes up
   and its topics route back; every frame is answered exactly once, and
   every answer (before the kill, through the failover, hedged, and from
   the restarted reader) equals a direct pipeline call (XCHECK_*); the
   writer and the restarted reader captured nothing after their warmups
   and launched A, B and C; an enrolment through the router
   reaches the writer; a second writer exits naming the lease; the router
   adds no process on the card (``nvidia-smi --query-compute-apps``) and
   reports no CUDA context. Numbers: e2e p50 / p99 through the router and
   direct, the failover seconds, the restarted reader's seconds to its
   first answer, the router's hedges, dedups and failovers. One
   ``{"replication": ...}`` line, with the run's total seconds.

15. (run after 14) multi-GPU, on MG_SLOTS slots of the one card (each slot
   its own stream). (a) phase 4's 2^20 rows (5% invalid) in
   bf16, Q 512 (64 planted), on ``make_mesh`` (dp, tp) = (1, 2), (1, 4) and
   (2, 2) (every shard 2^18 rows or more, so kernel A runs per shard):
   ``match_pod`` against single-device kernel A at k = 1, 5 and 17, indices
   and labels equal and sims bit for bit; a sparse layout (MG_SPARSE_ROWS
   valid rows, all in shard 0: ``-1`` and the pad label in the empty
   slots); dp x tp launches of kernel A a match; ``match_pod``'s ms (events
   around 20 eager calls) beside the single-device kernel's; a mesh
   gallery picks ``match_pod`` (C.18) and equals kernel A. (b)
   ``split_mesh(make_mesh(*pp_layout(n)))``, the CLI's own layout ((4, 2)
   for 8 slots), the serving detector and the unfused serving embedder in
   bf16 over the rows on mesh_b: the first batch against the single-device
   eager unfused step run on each dp row's frames (labels and valid equal,
   boxes within XCHECK_BOX_PX, sims within XCHECK_SIM; bit for bit
   recorded) and against it on the whole batch (labels gated, sims
   recorded: bf16 convolutions over 32 frames may take other algorithms
   than over 16); launches a batch exactly mesh_b's slots of kernel A and
   mesh_a's dp of kernel C (none of B); MG_STREAM_BATCHES batches through
   ``recognize_stream``, each once and in order; host-clock ms a batch back
   to back beside the single-device step's, in turns. (c) a
   ``RecognizerService`` over it: every frame one result, an enrolment
   lands live and names its subject. (d) the fused step over a mesh
   (ROADMAP A.11.1): ``RecognitionPipeline`` over a gallery of the rows on
   ``make_mesh`` (dp, tp) = MG_FUSED_MESHES ((1, 2) and (2, 2)), the
   serving detector and the unfused serving embedder in bf16 (a mesh
   refuses the fused one), each step key one CUDA graph (the dp rows fork
   onto their slots' streams inside it, and the shards' kernel A launches
   with them): the first batch equal bit for bit to the eager mesh step and
   to the single-device graphed unfused step run on each dp row's frames
   (each row's convolutions see the batch they see there); launches a batch
   exactly dp x tp of A, dp of C and none of B; host-clock ms a batch with a
   readback each and back to back, mesh and single device in turns; device
   ms under ``torch.profiler``; then a ``RecognizerService`` with
   ``--bucket-sizes`` MG_FUSED_LADDER (each rung captured at warmup, its
   capture ms recorded) serves 4 batches, every frame answered once (the
   first batch's planted faces recorded), and a lone frame goes out at the
   first rung dp divides (8 on dp 2: C.24). (e) the serving step across
   processes (ROADMAP A.11.2): two worker processes on the card, started
   with ``spawn``, join a ``gloo`` group of their own (NCCL refuses two
   ranks on one GPU), which ``initialize_multihost`` keeps, and bring one
   slot each to ``make_mesh``; over phase 4's rows in bf16 and the unfused
   serving stack, graphed level by level, each serves the first batch at
   (dp, tp) = MP_LAYOUTS ((1, 2): the candidates' all-gather crosses the
   processes; (2, 1): the dp result gather) and through the two-stage
   pipeline on MP_PP_LAYOUT (2, 1) (stage A on rank 0, the hop point to
   point, stage B and the gallery on rank 1). Both ranks' packed result
   must equal, bit for bit, the same layout's single-process mesh on two
   slots of the card (phase (d)'s form, computed by the parent); launches
   a batch by rank exactly A 1, C 1 at each mesh layout (A on each
   process's own shard) and A 0 / 1, C 1 / 0 in pp; kernel A against its
   plain version on each process's shard at the step's query shape; each
   rank's host-clock ms a batch back to back (MP_TIME_STEPS, after the
   parent's references are done) beside the single-process mesh's, and
   each collective's ms, bytes and bytes staged through host memory,
   timed to its end. Then (ROADMAP A.18) both run ``parallel.train``'s
   sharded ArcFace step at the HARD recipe's widths in bf16 (phase 19's
   ``sharded_step``) at MP_TRAIN_LAYOUTS ((1, 2): the softmax's statistics
   and the embeddings' gradient cross the processes; (2, 1): the gradient
   sums over dp) for MP_TRAIN_STEPS steps: both ranks' losses, replicas,
   head shards and gathered head equal, bit for bit, the single-process
   mesh on two slots (each reduction has two members); each collective's
   calls, ms (timed to its end), bytes and staged bytes by rank. A worker
   that fails or outlives MP_DEADLINE_S fails the phase, and both are
   killed. (f) the CLI's ``--parallel pp``
   refusals on this host (one card: the device count, and the three flags
   that are single-mesh only), each before any checkpoint loads. One
   ``{"multi_gpu": ...}`` line with the run's total seconds to its end.

16. (run after 15) the chaos soak (``apps.chaos_soak``). (a) ``run_soak``
   on phase 4's stack (the serving detector and fused embedder over the
   2^20-row bf16 gallery, every rung a CUDA graph captured at warmup, batch
   32 of 256x256 uint8 frames through the pinned staging ring) under a
   ``ServiceSupervisor`` and a ``Tracer`` at sample 1.0 with flight dumps:
   phase 4's frames offered at CHAOS_FPS for CHAOS_SECONDS with the
   reference's fault rates drawn from CHAOS_SEED (receive corrupt, drop
   and duplicate up to 5% each, put corrupt up to 5%, dispatch unavailable
   up to 10%, readback stuck up to 5%) and the reference's service
   settings, the service's, batcher's, metrics', pipeline's, gallery's and
   ring's locks ``DebugLock``s of one ``LockOrderMonitor``. It passes on
   the reference's criteria (the probe burst answered after ``disarm``,
   crashes equal to restarts, delivered batches equal to dispatched plus
   failed, ledger ``in_system`` 0, flight dumps that parse with their
   settle spans equal to the ledger), and: the probe's faces find their
   own frame's planted rows; no capture after warmup unless a restart
   caused it; A and C once and B six times a dispatched step (replays
   counted); the ring's pinned allocations past its preallocation equal
   its forfeits less its open heal credits; no lock-order inversion; the
   thread count back within CHAOS_THREAD_MARGIN of its count before. (b)
   one supervised crash (a result subscriber raises in the readback
   worker) with CHAOS_ADDED_ROWS rows added after the checkpoint: the
   gallery equals its checkpoint bit for bit (host mirrors and device
   rows), the restarted loop names the planted faces; the seconds from
   the crash to the restart and to the first answer, and the
   re-captures. One ``{"chaos": ...}`` line with the run's total seconds.

17. (run after 16) ``ocvf-train`` on the card (ROADMAP A.9, A.12 and the
   classic trainer). (a) the embedder variants at the serving widths,
   64x64, weights from ``--seed``, VAR_FACES faces: ``space_to_depth`` 2
   and 4, ``norm="light"``, ``block="dense"``. Each eager forward in f32
   on the card equals its plain f32 version on the CPU within XCHECK_SIM
   (the bf16 forward's cosine to it recorded); for s = 2 and 4 the fused
   forward (kernel B) against the unfused one (cosine >= VAR_FUSED_COS),
   kernel B against its plain version at every block shape the serving
   net lacks (SEP_BATCHES, bf16 and f32), and ms per forward, eager
   (events) and device time (a graph). Phase 4's detector and 2^20-row
   gallery with the s = 2 embedder, fused: a graphed step equal bit for
   bit to the eager step, then VAR_SERVE_BATCHES batches through a
   ``RecognizerService`` (A and C once, B six times a step); the fused
   pipeline refuses the light and dense variants. (b) the six classic
   rows of ``apps.measure_accuracy.CONFIGS`` (``classic_kfold``:
   ``TheTrainer`` at 10-fold on the published protocols of
   ``scripts/measure_accuracy.py``, 70x70) on the card: each row's
   accuracy within ACC_TOL of its ``BASELINE.md`` figure (ACC_BASELINE);
   LBP codes (radius 2 and 3) on the card equal to the CPU's on at least
   LBP_AGREE of pixels. (b') the oracle column of ``apps.oracle_parity``
   for ORACLE_ROWS: the framework (``TheTrainer``) on the card, the NumPy /
   SciPy oracle on the host, on the same data and folds: |delta| <=
   ORACLE_DELTA (the reference's bar) and the oracle within ACC_TOL of
   ``BASELINE.md``'s ORACLE figure. (c) ``ocvf-train-torch`` in a
   subprocess on Extended Yale-B's size (38 x 64 PGM images from
   ``make_synthetic_faces`` with the Yale-B analog's hard arguments,
   ``build/train_smoke/``) at its defaults (Fisherfaces with Tan-Triggs,
   NN, 3-fold) and with ``--model lbph`` (the kernel SVM's run is phase
   18 (e)'s ``--model auto --classifier kernel_svm``): each run's rc 0,
   its seconds by stage (its ``train stages:`` line),
   ``torch.cuda.max_memory_allocated`` and mean k-fold accuracy, and its
   checkpoint loaded on the card and on the CPU
   predicting the same labels for TRAIN_CHECK_QUERIES images. One
   ``{"train": ...}`` line with the seconds up to its end.
18. (run after 17) training on the card (ROADMAP A.13). (a) one f32 step
   from one set of weights (``--seed``) on the card and on the CPU: an
   ArcFace step at the serving widths (batch ARC_BATCH, 64x64, one set
   of augmentation draws), a ``detector_loss`` step of the serving
   detector and a ``gate_loss`` step of the default gate (DET_GRAD_BATCH
   256x256 scenes): every gradient tensor within ARC_GRAD_RTOL of the
   CPU's (relative to its largest |g|), the loss within ARC_LOSS_ATOL.
   (b) ``apps.measure_accuracy.cnn_verification`` (the HARD protocol) at
   ARC_STEPS steps of batch 192 in bf16 with augmentation, cosine decay
   and flip TTA: ms a step (CUDA events over ARC_TIME_STEPS), device ms
   and the card's busy share (``torch.profiler`` over ARC_PROFILE_STEPS
   steps), peak ``max_memory_allocated``, the mean loss of the first and
   last ARC_LOSS_WINDOW steps, verification accuracy (>= ARC_MIN_ACC),
   std and fold minimum. (c) ARC_ENROL held-out faces of each of the 48
   identities enrolled among phase 4's random rows in a 2^20-row bf16
   gallery, the others queried through ``gallery.match`` (kernel A):
   rank-1 >= ARC_RANK1_MIN; the trained net's fused forward (kernel B)
   against its unfused one (cosine >= VAR_FUSED_COS); ``finetune_embedder``
   from it on the enrolled faces (FINETUNE_STEPS steps), the serving
   feature's tensors equal bit for bit afterwards. (d) the reference's
   small detector recipe held to its bands on held-out scenes (recall and
   precision >= 0.9, matched IoU >= 0.7; ``evaluate_detector`` runs
   ``detect_batch``, kernel C), the default gate's recipe with
   ``evaluate_gate``, and the serving detector's recipe
   (``bench_serving.py:64-71``), its recall within DET_SERVING_RECALL_TOL
   of the JAX package's on the CPU (DET_SERVING_JAX_RECALL). (e)
   ``ocvf-train-torch --model cnn`` at its defaults on phase 17's Yale-B
   set and ``--model auto --classifier kernel_svm`` on AUTO_SUBJECTS x
   AUTO_PER_SUBJECT images (every family k-folded with the kernel SVM):
   rc 0, stages, peak bytes, k-fold accuracy, each checkpoint predicting
   alike on the card and the CPU. (f) the embedder gate,
   ``apps.gate_embedder.main`` on GATE_ARGV (a non-default structure,
   dense blocks, s = 2, light norm, GATE_STEPS steps of the HARD
   protocol): the row's fields, tag and config. One ``{"training": ...}``
   line with the seconds up to its end.
19. (run after 18) training over a mesh (ROADMAP A.18, ``parallel.train``).
   (a) the HARD recipe's ArcFace step (``sharded_step``: embed 256, stages
   64 / 128 / 256, 64x64, batch 192, 300 classes, augmented) in f32 over
   ``make_mesh`` (dp, tp) = SH_LAYOUTS of slots of the card against the
   one-slot step (``make_train_step``) on the same batches and draws: the
   first step's loss within SH_LOSS_RTOL and every gradient tensor within
   SH_GRAD_RTOL (relative to its largest |g|), SH_STEPS steps' losses
   within SH_LOSSES_RTOL, every replica and every dp copy of a head shard
   equal bit for bit after each step; then in bf16 ms a step (CUDA events
   over steps SH_TIME_FROM to SH_STEPS) of each layout and of the one-slot
   step under cuDNN's default choice and under its deterministic
   algorithms (which every layout runs), two rounds in turns, and one
   ``torch.profiler`` trace of each: the card's busy ms and share, its
   work, its operations and the host's launch calls a step. (b) ``entry.dryrun_multichip(4)`` on four
   slots of the card: the reference's four ``[dryrun]`` lines (the
   sharded step, the fused batch over (2, 2), pp over (1, 2) halves) and
   kernel C's launches (none of A or B: a 32-row gallery, the unfused
   embedder). (c) is phase 15 (e)'s sharded step across two processes.
   One ``{"sharded_training": ...}`` line with the run's total seconds.

The line before the last is the per-kernel JSON (kernels A, B and C, their
launches those of phase 4's serving run, of the reader alone in phase
14 (a), of the two-stage pipeline in phase 15 (b) and (c), the fused
mesh step's services in (d) and both processes' counted step in (e), of the
chaos soak in phase 16, of the s = 2 embedder's serving in phase 17
(a), of the trained nets in phase 18 (c) and (d), and of the dryrun's
recognition batches in phase 19 (b)); the last line is
``{"ok": true, "device": {...}}``. Before the per-kernel JSON,
``{"phase_s": ...}`` holds each phase's seconds.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.apps import chaos_soak
from opencv_facerecognizer_tpu_torch.apps import gate_embedder
from opencv_facerecognizer_tpu_torch.apps import measure_accuracy
from opencv_facerecognizer_tpu_torch.apps import oracle_parity
from opencv_facerecognizer_tpu_torch.apps import recognize as recognize_app
from opencv_facerecognizer_tpu_torch.models import cascade as cascade_mod
from opencv_facerecognizer_tpu_torch.models import detector as detector_mod
from opencv_facerecognizer_tpu_torch.models import embedder as embedder_mod
from opencv_facerecognizer_tpu_torch.models.classifier import NearestNeighbor
from opencv_facerecognizer_tpu_torch.models.model import PredictableModel
from opencv_facerecognizer_tpu_torch.ops.distance import CosineDistance
from opencv_facerecognizer_tpu_torch.ops import _build
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.ops import lbp as lbp_mod
from opencv_facerecognizer_tpu_torch.ops.ivf_match import (
    gather_bucket, ivf_match_topk, shortlist_cells, tie_aware_agreement)
from opencv_facerecognizer_tpu_torch.ops.nms import nms_mask, nms_mask_plain
from opencv_facerecognizer_tpu_torch.ops.sepblock import (
    fused_sep_block, fused_sep_block_plain)
from opencv_facerecognizer_tpu_torch.ops.sepblock import launch_info as sepblock_launch_info
from opencv_facerecognizer_tpu_torch.ops.streaming_match import (
    NEG_INF, match_smem_bytes, streaming_match_topk, streaming_match_topk_plain)
from opencv_facerecognizer_tpu_torch.entry import dryrun_multichip
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh
from opencv_facerecognizer_tpu_torch.parallel.pipeline import (
    RecognitionPipeline, RecognitionResult, pack_result, unpack_result)
from opencv_facerecognizer_tpu_torch.parallel.quantizer import CoarseQuantizer
from opencv_facerecognizer_tpu_torch.parallel.train import ShardedArcFaceStep
from opencv_facerecognizer_tpu_torch.runtime import expo as expo_mod
from opencv_facerecognizer_tpu_torch.runtime.connector import (
    FakeConnector, encode_frame)
from opencv_facerecognizer_tpu_torch.runtime.fakes import synthetic_frame_stream
from opencv_facerecognizer_tpu_torch.runtime.faults import FaultInjector, InjectedCrashError
from opencv_facerecognizer_tpu_torch.runtime.ingest import (
    JPEG_KEY, IngestConfig, decode_jpeg, encode_jpeg)
from opencv_facerecognizer_tpu_torch.runtime.journal import DeadLetterJournal, RotatingJournal
from opencv_facerecognizer_tpu_torch.runtime.promtext import lint_prometheus_text
from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
    CONTROL_TOPIC, FRAME_TOPIC, RESULT_TOPIC, STATUS_TOPIC, RecognizerService)
from opencv_facerecognizer_tpu_torch.runtime.registry import (
    ModelRegistry, RegistrySwapCoordinator, _file_sha256, registry_params_path)
from opencv_facerecognizer_tpu_torch.runtime.replication import TopicRouter
from opencv_facerecognizer_tpu_torch.runtime.resilience import ResiliencePolicy, ServiceSupervisor
from opencv_facerecognizer_tpu_torch.runtime.rollout import RolloutCoordinator, RolloutGateError
from opencv_facerecognizer_tpu_torch.runtime.state_store import StateLifecycle
from opencv_facerecognizer_tpu_torch.runtime import trainer as trainer_mod
from opencv_facerecognizer_tpu_torch.utils import dataset as dataset_utils
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils import native, serialization, tracing
from opencv_facerecognizer_tpu_torch.utils.debug_lock import LockOrderMonitor
from opencv_facerecognizer_tpu_torch.utils.metrics import (
    BATCHES_DISPATCHED, FRAMES_DROPPED_CRASHED, IVF_INCREMENTAL_ROWS, LOOP_CRASHES,
    SUPERVISOR_RESTARTS, Metrics)

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

GALLERY_ROWS = 1 << 20
DIM = 256
BATCH = 32
FRAME = (256, 256)
MAX_FACES = 16
#: the untrained detector's head biases. The heatmap's (flax init: -4)
#: keeps every score below the 0.3 threshold; 0 lets it report faces. The
#: size head's (init 0) gives boxes of ~0 px, whose crops are near-constant
#: and embed alike; 3 cells (~24 px) gives distinct crops, so each face's
#: embedding is told apart from the others' (measured on the CPU: cos to
#: any other face <= 0.91, to itself >= 0.999).
HEATMAP_BIAS = 0.0
SIZE_BIAS = 3.0
#: kernel A: f32 sums of the same bf16 products in another order
MATCH_ATOL = 1e-4
#: kernel A's k checked at the serving shape: the serving top-1, the
#: one-pass lists (5, 16) and the multi-pass k (17, 64, and 300: 19 passes)
MATCH_KS = (1, 5, 16, 17, 64, 300)
#: kernel B: bf16 outputs; the kernel and the plain version may round an
#: intermediate to neighbouring bf16 values: two bf16 ulps of the output
SEP_RTOL = 2.0 ** -6
#: the six (H, W, C, F, stride) blocks of the serving embedder at 64x64
SERVING_BLOCKS = [(32, 32, 32, 64, 2), (16, 16, 64, 64, 1),
                  (16, 16, 64, 128, 2), (8, 8, 128, 128, 1),
                  (8, 8, 128, 256, 2), (4, 4, 256, 256, 1)]
#: other (H, W, C, F, stride) blocks the kernel takes, F / 8 not a multiple
#: of 8 (F = 48, 96), stride 1 and 2: checked, not timed
OTHER_BLOCKS = [(32, 32, 32, 48, 2), (16, 16, 48, 48, 1), (16, 16, 48, 96, 2),
                (8, 8, 96, 96, 1), (16, 16, 96, 96, 1)]
#: kernel B's batches: the serving 512, fewer samples than CTAs (37), and
#: more than two per CTA of a full grid (601); none a multiple of the grid
SEP_BATCHES = (512, 37, 601)
#: kernel C (NMS keep-mask): the serving shape (32 images of K = 64
#: candidates: 4 x max_faces), tie-heavy sets (boxes on a half-pixel grid,
#: so IoUs land exactly on the threshold; scores rounded to 0.1) of
#: (images, K) each (the plain loop's [n, K, K] IoUs bound n at K = 1024),
#: the detector's thresholds
NMS_K = 4 * MAX_FACES
NMS_TIE_CASES = ((4096, 64), (4096, 256), (64, 1024))
NMS_IOU, NMS_SCORE = 0.4, 0.3
#: async-grow phase: rows short of the tier when the enrolment comes, steps
#: timed before the add and after the grow lands, adds timed within a tier
GROW_HEADROOM = 8
GROW_STEPS = 20
GROW_ADDS = 5
#: CPU cross-check: the first batch through the same stack computing in
#: f32 on the card and on the CPU (in bf16 the two devices' convolutions
#: round at other points, so detection decisions near a boundary differ
#: often; the bf16 serving path is held by the planted-row check and by
#: phase 3). In f32 the devices differ by f32 noise (~1e-6): boxes within
#: XCHECK_BOX_PX, sims within XCHECK_SIM. A face kept on one device only is
#: allowed only as a boundary swap: its score within XCHECK_SCORE of the
#: 0.3 threshold or of the lowest kept score (all 16 slots full), or its
#: IoU with a kept box within XCHECK_IOU of the NMS threshold. Swaps are
#: counted and printed; any other difference fails the run.
XCHECK_BOX_PX = 0.05
XCHECK_SIM = 1e-3
XCHECK_SCORE = 1e-3
XCHECK_IOU = 1e-3
#: IVF phase: the reference recognizer's quantizer (``--match-mode auto``:
#: nprobe 8, nlist from the row count); the query batches checked (the
#: serving batch's 512 face slots, and 32) and timed (down to one frame's
#: 16 slots); k checked; the other gallery size timed, match alone (the
#: reference's IVF threshold 2^18; 2^22, whose host setup took ~52 s, was
#: cut for phase 18's time); the queries' noise (perturbed gallery rows)
IVF_NPROBE = 8
IVF_QS = (512, 32)
IVF_TIME_QS = (512, 128, 32, 16)
IVF_KS = (1, 5)
IVF_OTHER_ROWS = (1 << 18,)
IVF_QUERY_NOISE = 0.05
#: the reference's ``bench.py --ivf-smoke`` recall gate: rows, dim, nlist,
#: nprobe, data seed, queries, quantizer seed, k-means iterations and
#: sample; the two-stage top-1 must agree with the exact scan (modulo
#: ties) on at least IVF_SMOKE_RECALL of the queries
IVF_SMOKE = dict(rows=16384, dim=64, nlist=128, nprobe=8, seed=11, n_q=64,
                 quantizer_seed=5, kmeans_iters=8, train_sample=8192)
IVF_SMOKE_RECALL = 0.99
#: cli phase: gallery subjects and images each (64x64 PGM), frames of the
#: dir run (two serving batches), the gallery capacity (kernel A's path),
#: frames of the jsonl run before and after the enroll command, the
#: enrolled subject's name
CLI_SUBJECTS = 4
CLI_IMAGES = 2
CLI_FRAMES = 2 * BATCH
CLI_CAPACITY = 1 << 20
#: the gallery capacity of the CLIs that keep a state dir in phases 8 and
#: 14 (b): each start, SIGTERM and resync writes or reads a checkpoint of
#: it (1 GiB at CLI_CAPACITY; cut for phase 15 (d)'s time)
CLI_STATE_CAPACITY = 1 << 18
CLI_JSONL_FRAMES = 8
CLI_ENROL_COUNT = 2
CLI_NEW_NAME = "enrolled_subject"
#: durability phase: subjects enrolled before the forced checkpoint and
#: after it (WAL only), crops each, the match's query batch and k
DUR_SUBJECTS_CHECKPOINTED = 4
DUR_SUBJECTS_WAL = 2
DUR_ENROL_COUNT = 2
DUR_Q = 512
DUR_KS = (1, 5)

#: phase 10: the stage table's buckets and graph depth; the burst that
#: measures R; the steady run (a) and the overload run (b) as shares of R;
#: one delivery in OVL_REPEAT_EVERY of (b) repeats an answered ``_fid``
OVL_QUOTE_BUCKETS = (8, 32)
OVL_QUOTE_ITERS = 10
OVL_DISTINCT_FRAMES = 64
OVL_BURST = 256
OVL_STEADY = 600
OVL_STEADY_SHARE = 0.5
OVL_OVERLOAD = 1000
OVL_OVERLOAD_SHARE = 3.0
OVL_REPEAT_EVERY = 20
OVL_PROFILE_BATCHES = 8
#: (b)'s producer connections (cameras), deliveries dealt round robin
OVL_CONNECTIONS = 4
#: the kernels' CUDA function names, as the profile shows them
OVL_KERNEL_NAMES = {"streaming_match": "match_wgmma_kernel", "sepblock": "sepblock_kernel",
                    "nms": "nms_keep_kernel"}
#: phase 11: batches of distinct frames per path (four times the 32
#: rung's ring depth of inflight + 2 = 6, so every buffer and graph slot
#: goes round several times inside the bit-for-bit comparison), batches
#: under the profiler, the flush deadline (long: every batch fills to
#: BATCH, so both paths see the same batches), the JPEG quality and one
#: corrupt delivery in ING_CORRUPT_EVERY (2%)
ING_BATCHES = 24
ING_PROFILE_BATCHES = 4
ING_FLUSH_S = 1.0
ING_JPEG_QUALITY = 85
ING_CORRUPT_EVERY = 50
#: phase 12: rows per stage chunk (64 MiB of f32 rows, 8 chunks at RO_ROWS),
#: the rows rolled out,
#: chunks staged before the scripted stage crash, the parity window's
#: sample floor, the producer's tick (one batch each) and the batches
#: awaited after the cutover
RO_CHUNK_ROWS = 1 << 16
RO_ROWS = 1 << 19
RO_CRASH_AFTER_CHUNKS = 5
RO_PARITY_SAMPLES = 64
RO_TICK_S = 0.05
RO_AFTER_BATCHES = 4
# phase 13: the cascade and the registry's swaps
#: seeded frames (half with stamped faces) scored on the CPU to draw from
CASC_CANDIDATES = 384
#: survivors of 32 in the three cascade batches: the whole-batch exit, the
#: 8 rung, the 32 rung
CASC_SURVIVORS = (0, 6, 20)
#: the card's bf16 stage-1 probabilities against the CPU's f32 (bf16 keeps 8
#: bits: the logits differ by ~1e-2, the probabilities by a quarter of that)
CASC_SCORE_ATOL = 0.01
#: a drawn frame's CPU score lies at least this far from the threshold, so
#: the card's bf16 score cannot cross it
CASC_MARGIN = 2 * CASC_SCORE_ATOL
CASC_LADDER = (8, 32)
CASC_REPEATS = 3
#: v2 of the detector: each tensor plus seeded noise of this share of its
#: spread (the swap's parity passes); the parity window's floor
REG_PERTURB = 1e-3
REG_PARITY_SAMPLES = 16
REG_TICK_S = 0.03
REG_AFTER_BATCHES = 4
#: the CLI's frames (c): the 6- and 20-survivor batches
CASC_CLI_FRAMES = 2 * BATCH

# phase 14 (replication): subjects the writer enrols, one every
# REPL_ENROL_EVERY_S; the batch tick of both services; the reader's poll;
# the verifier's --follow window
REPL_SUBJECTS = 16
REPL_HEADROOM = 64
REPL_ENROL_EVERY_S = 0.1
REPL_TICK_S = 0.03
REPL_POLL_S = 0.05
REPL_FOLLOW_S = 5.0
#: the --follow window opens before the last REPL_FOLLOW_LAST enrolments
#: (it reads the earlier records at its first poll), so it closes after
#: the last one however slow the host makes the enrolment
REPL_FOLLOW_LAST = 4
#: batches the reader serves alone, its launches counted
REPL_ALONE_BATCHES = 8
# the CLI trio: camera topics and frames per topic through the router, the
# burst that measures its rate, the share of that rate the traffic runs
# at, the router's link and hedge deadlines (the link's must exceed the
# router's 1 s health interval, which paces its pings), the direct run's
# frames, where in the traffic the reader is killed, the frames a round
# after its restart
REPL_TOPICS = 8
REPL_FRAMES_PER_TOPIC = 64
REPL_BURST = 128
REPL_RATE_SHARE = 0.5
REPL_LINK_DEADLINE_S = 2.5
REPL_HEDGE_DEADLINE_S = 0.5
REPL_DIRECT_FRAMES = 256
REPL_KILL_AT = 0.4
REPL_ROUTE_BACK_FRAMES = 8


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms: CUDA events around ``iters`` eager runs
    after ``warmup`` runs (host work between launches included)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device time of one ``fn`` in ms: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events (no host work
    between the launches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def log_ptxas(name: str) -> None:
    """One line per kernel instantiation from the build's ``-Xptxas -v``
    output: registers, barriers, spill stores/loads (dynamic shared memory
    is per launch and is logged with each kernel's timing)."""
    entry, spills = None, ""
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            entry = _demangle(line.split("'")[1])
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and entry:
            log(f"  ptxas {entry}: {line.split('info    :')[-1].strip()}; {spills}")
            entry, spills = None, ""


def _demangle(symbol: str) -> str:
    """The kernel's name and template arguments, e.g.
    ``sepblock_kernel<__nv_bfloat16, 256, 8, 8>``."""
    try:
        text = subprocess.run(["c++filt", symbol], capture_output=True, text=True,
                              timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    text = text.replace("(anonymous namespace)::", "").removeprefix("void ")
    return text.split("(")[0] or symbol


def _match_case(q, g, valid, k, what: str) -> float:
    """Kernel A against its plain version; returns the max sim error."""
    got_v, got_i = streaming_match_topk(q, g, valid, k=k)
    want_v, want_i = streaming_match_topk_plain(q, g, valid, k=k)
    torch.cuda.synchronize()
    err = (got_v - want_v).abs().max().item()
    beyond_ties = ((got_i != want_i) & ((got_v - want_v).abs() > MATCH_ATOL)).sum().item()
    sentinels_ok = torch.equal(got_i == -1, want_i == -1) and bool(
        (got_v[got_i == -1] == NEG_INF).all())
    if err > MATCH_ATOL or beyond_ties or not sentinels_ok:
        raise AssertionError(f"kernel A {what} k={k}: max sim err {err}, {beyond_ties} index "
                             f"mismatches beyond ties, sentinels equal: {sentinels_ok}")
    log(f"kernel A {what} k={k} ({streaming_match_topk.last_path} path): max |sim - plain| "
        f"{err:.3e}, index agreement {(got_i == want_i).float().mean().item():.6f}")
    return err


def check_match(dev, gen) -> dict:
    """Kernel A vs its plain version; returns the kernel's JSON entry
    fields measured here."""
    q = torch.randn(512, DIM, generator=gen)
    g = torch.randn(GALLERY_ROWS, DIM, generator=gen)
    q = q / q.norm(dim=1, keepdim=True)
    g = g / g.norm(dim=1, keepdim=True)
    g[4096:8192] = g[0:4096]            # duplicate rows: ties
    g[100000:100512] = q                # planted queries ...
    g[900000:900512] = q                # ... twice: exact ties at 1.0
    valid = torch.rand(GALLERY_ROWS, generator=gen) > 0.05
    valid[100000:100256] = False        # half the first plants invalid
    valid[900000:900512] = True
    q, g, valid = q.to(dev), g.to(dev, torch.bfloat16), valid.to(dev)
    planted = torch.where(valid[100000:100512], 100000, 900000) + torch.arange(512, device=dev)
    max_err = 0.0
    for k in MATCH_KS:
        max_err = max(max_err, _match_case(q, g, valid, k, "serving shape"))
        got_i = streaming_match_topk(q, g, valid, k=k)[1]
        if not torch.equal(got_i[:, 0].long(), planted):
            raise AssertionError(f"kernel A k={k}: planted rows not found at the lowest index")
    # ragged galleries: N one row past a tile, below one tile; fewer valid
    # rows than k
    for n, d, gdt in ((70001, DIM, torch.bfloat16), (70001, DIM, torch.float32),
                      (301, 64, torch.bfloat16), (301, 64, torch.float32)):
        q2 = torch.randn(37, d, generator=gen)
        g2 = torch.randn(n, d, generator=gen)
        q2 = (q2 / q2.norm(dim=1, keepdim=True)).to(dev)
        g2 = (g2 / g2.norm(dim=1, keepdim=True)).to(dev, gdt)
        v2 = (torch.rand(n, generator=gen) > 0.2).to(dev)
        for k in (1, 17):
            max_err = max(max_err, _match_case(q2, g2, v2, k, f"ragged N={n} D={d} {gdt}"))
        v3 = torch.zeros(n, dtype=torch.bool, device=dev)
        v3[[3, n // 2, n - 1]] = True
        max_err = max(max_err, _match_case(q2, g2, v3, 5, f"3 valid rows N={n} D={d} {gdt}"))
    # the same 2^20 rows stored in f32 (the gallery's default store dtype)
    g32 = g.float()
    for k in (1, 5):
        max_err = max(max_err, _match_case(q, g32, valid, k, "f32 gallery"))
    f32_ms = cuda_ms(lambda: streaming_match_topk(q, g32, valid, k=1), iters=5)
    f32_dev = graph_ms(lambda: streaming_match_topk(q, g32, valid, k=1), iters=5)
    log(f"kernel A f32 gallery (Q=512, D=256, N=2^20, k=1, "
        f"{streaming_match_topk.last_path} path): {f32_ms:.4f} ms eager with events, "
        f"{f32_dev:.4f} ms device time")
    del g32

    k = 1  # the serving top_k
    ms = cuda_ms(lambda: streaming_match_topk(q, g, valid, k=k))
    device_ms = graph_ms(lambda: streaming_match_topk(q, g, valid, k=k))
    for kk in MATCH_KS[1:]:
        log(f"kernel A k={kk} at the serving shape: "
            f"{cuda_ms(lambda: streaming_match_topk(q, g, valid, k=kk), iters=5):.4f} ms "
            f"eager with events, "
            f"{graph_ms(lambda: streaming_match_topk(q, g, valid, k=kk), iters=3):.4f} ms "
            f"device time")
    plain_ms = cuda_ms(lambda: streaming_match_topk_plain(q, g, valid, k=k), iters=3, warmup=1)
    qb = q.to(torch.bfloat16)

    def library():
        s = torch.matmul(qb, g.T)
        return torch.topk(torch.where(valid, s, torch.finfo(s.dtype).min), k)

    library_ms = cuda_ms(library, iters=5, warmup=1)
    nbytes = q.numel() * 4 + g.numel() * 2 + valid.numel() + q.shape[0] * k * 8
    flops = 2 * q.shape[0] * GALLERY_ROWS * DIM
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    log(f"kernel A k=1 serving shape ({streaming_match_topk.last_path} path, "
        f"{match_smem_bytes(DIM, 1, streaming_match_topk.last_path)} B shared memory per CTA): "
        f"{ms:.4f} ms eager with events, {device_ms:.4f} ms device time, "
        f"plain {plain_ms:.4f}, matmul + topk {library_ms:.4f}, bound {bound:.4f}")
    return dict(name="streaming_match", route="cuda",
                source="opencv_facerecognizer_tpu_torch/csrc/streaming_match.cu",
                replaces="opencv_facerecognizer_tpu/ops/pallas_match.py:99",
                max_abs_err=max_err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS
                else "operations", library_ms=library_ms)


def _sep_args(gen, c, f, stride, dev):
    blk = embedder_mod._SepBlock(c, f, stride)
    with torch.no_grad():
        blk.dw.weight.copy_(torch.randn(c, 1, 3, 3, generator=gen) * 0.3)
        blk.pw.weight.copy_(torch.randn(f, c, 1, 1, generator=gen) / c ** 0.5)
        for gn in (blk.gn1, blk.gn2):
            gn.weight.copy_(torch.rand(gn.weight.shape, generator=gen) + 0.5)
            gn.bias.copy_(torch.randn(gn.bias.shape, generator=gen) * 0.1)
    blk = blk.to(dev).eval()
    return blk, (blk.dw.weight, blk.gn1.weight, blk.gn1.bias, blk.pw.weight,
                 blk.gn2.weight, blk.gn2.bias)


def _sep_case(x, args, stride, res, what: str) -> float:
    """Kernel B against its plain version; returns the max error."""
    got = fused_sep_block(x, *args, stride=stride, residual=res)
    want = fused_sep_block_plain(x, *args, stride=stride, residual=res)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if got.dtype != x.dtype or not (err <= SEP_RTOL * want.float().abs().clamp(min=1.0)).all():
        raise AssertionError(f"kernel B {what}: max err {err.max().item()}")
    return err.max().item()


def _sep_streams(x, args, stride, res, what: str) -> None:
    """Kernel B over more samples than two per CTA of its grid against the
    same samples launched 100 at a time (one per CTA): a sample's
    arithmetic does not depend on the CTA or turn that runs it, so the two
    must agree bit for bit."""
    got = fused_sep_block(x, *args, stride=stride, residual=res)
    alone = torch.cat([fused_sep_block(x[i:i + 100], *args, stride=stride, residual=res)
                       for i in range(0, x.shape[0], 100)])
    if not torch.equal(got, alone):
        raise AssertionError(f"kernel B {what}: streamed samples differ from samples "
                             f"run alone (max {(got.float() - alone.float()).abs().max()})")


def check_sepblock(dev, gen) -> dict:
    """Kernel B vs its plain version at the six serving shapes and at
    OTHER_BLOCKS; the entry sums one forward's six calls."""
    b = SEP_BATCHES[0]
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, t_ops=0.0)
    max_err = 0.0
    for h, w, c, f, stride in SERVING_BLOCKS + OTHER_BLOCKS:
        res = stride == 1 and c == f
        blk, args = _sep_args(gen, c, f, stride, dev)
        what = f"{h}x{w}x{c}->{h // stride}x{w // stride}x{f} s{stride}"
        errs, xs = {}, {}
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            xs[name] = torch.randn(max(SEP_BATCHES), h, w, c, generator=gen).to(dev, dtype)
            for nb in SEP_BATCHES:
                errs[f"{name} B={nb}"] = _sep_case(xs[name][:nb], args, stride, res,
                                                   f"{what} {name} B={nb}")
            _sep_streams(xs[name], args, stride, res, f"{what} {name} B={max(SEP_BATCHES)}")
        max_err = max(max_err, *errs.values())
        x = xs["bf16"][:b]
        if (h, w, c, f, stride) not in SERVING_BLOCKS:
            log(f"kernel B {what} (checked only): max err "
                + ", ".join(f"{t} {e:.3e}" for t, e in errs.items())
                + f"; {sepblock_launch_info(x, f, stride)}")
            continue
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view: the cuDNN path's input
        plan = sepblock_launch_info(x, f, stride)
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_sep_block(x, *args, stride=stride, residual=res))
            dev_ms = graph_ms(lambda: fused_sep_block(x, *args, stride=stride, residual=res))
            plain = cuda_ms(lambda: fused_sep_block_plain(x, *args, stride=stride,
                                                          residual=res), iters=5)
            lib = cuda_ms(lambda: blk(x_nchw, torch.bfloat16), iters=10)
        p = (h // stride) * (w // stride)
        nbytes = x.numel() * 2 + b * p * f * 2 + (9 * c + 2 * c + 2 * f) * 4 + c * f * 4
        t_ops = 2 * b * p * c * f / BF16_FLOPS + (2 * 9 * b * p * c + 10 * b * p * (c + f)) / F32_FLOPS
        log(f"kernel B {what}: max err " + ", ".join(f"{t} {e:.3e}" for t, e in errs.items())
            + f"; {ms:.4f} ms eager with events, {dev_ms:.4f} ms device time (plain "
            f"{plain:.4f}, cuDNN block {lib:.4f}, bound "
            f"{max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3:.4f}); {plan}")
        tot["ms"] += ms
        tot["device_ms"] += dev_ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += nbytes
        tot["t_ops"] += t_ops
    t_bytes = tot["bytes"] / HBM_BYTES_PER_S
    log(f"kernel B, one forward (six blocks, B={b}): {tot['ms']:.4f} ms eager with events, "
        f"{tot['device_ms']:.4f} ms device time")
    return dict(name="sepblock", route="cuda",
                source="opencv_facerecognizer_tpu_torch/csrc/sepblock.cu",
                replaces="opencv_facerecognizer_tpu/ops/pallas_sepblock.py:150",
                max_abs_err=max_err, ms=tot["ms"], device_ms=tot["device_ms"],
                plain_ms=tot["plain_ms"], bound_ms=max(t_bytes, tot["t_ops"]) * 1e3,
                bound_by="bytes" if t_bytes > tot["t_ops"] else "operations",
                library_ms=tot["library_ms"])


def _nms_inputs(gen, n_img: int, k: int, dev, grid: bool):
    """Boxes [n, k, 4] and scores [n, k] on ``dev``: detector-like boxes in
    a 256x256 canvas, or (``grid``) boxes on a half-pixel grid with scores
    rounded to 0.1 (exact IoU ties at the threshold, exact score ties)."""
    if grid:
        yx = torch.randint(0, 40, (n_img, k, 2), generator=gen) * 0.5
        hw = torch.randint(1, 12, (n_img, k, 2), generator=gen) * 0.5
        scores = torch.round(torch.rand(n_img, k, generator=gen) * 10) / 10
    else:
        yx = torch.rand(n_img, k, 2, generator=gen) * 224
        hw = torch.rand(n_img, k, 2, generator=gen) * 40 + 4
        scores = torch.rand(n_img, k, generator=gen)
    return torch.cat([yx, yx + hw], -1).to(dev), scores.to(dev)


def check_nms(dev, gen) -> dict:
    """Kernel C vs its plain version (flag for flag) at the serving shape
    and on the tie-heavy sets; times the wrapper at the serving shape."""
    mismatches = 0
    cases = [(BATCH, NMS_K, False)] + [(n, k, True) for n, k in NMS_TIE_CASES]
    for n_img, k, grid in cases:
        boxes, scores = _nms_inputs(gen, n_img, k, dev, grid)
        for iou_thr, score_thr in ((NMS_IOU, NMS_SCORE), (0.5, 0.0)):
            got = nms_mask(boxes, scores, iou_thr, score_thr)
            want = nms_mask_plain(boxes, scores, iou_thr, score_thr)
            torch.cuda.synchronize()
            bad = int((got != want).sum().item())
            mismatches += bad
            log(f"kernel C {n_img} x K={k} ({'grid, ties' if grid else 'random'}) "
                f"iou {iou_thr} score {score_thr}: {bad} flags differ from the plain loop; "
                f"{got.float().mean().item():.3f} of candidates kept")
    if mismatches:
        raise AssertionError(f"kernel C: {mismatches} keep flags differ from the plain loop")
    boxes, scores = _nms_inputs(gen, BATCH, NMS_K, dev, grid=False)
    ms = cuda_ms(lambda: nms_mask(boxes, scores, NMS_IOU, NMS_SCORE))
    device_ms = graph_ms(lambda: nms_mask(boxes, scores, NMS_IOU, NMS_SCORE))
    plain_ms = cuda_ms(lambda: nms_mask_plain(boxes, scores, NMS_IOU, NMS_SCORE), iters=5)
    plain_device_ms = graph_ms(lambda: nms_mask_plain(boxes, scores, NMS_IOU, NMS_SCORE),
                               iters=3)
    # the function's bytes (boxes and scores in, the mask out) and its f32
    # operations (about 12 per IoU pair, K(K-1)/2 pairs an image)
    nbytes = BATCH * NMS_K * (16 + 4 + 1)
    t_ops = BATCH * NMS_K * (NMS_K - 1) / 2 * 12 / F32_FLOPS
    bound = max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3
    log(f"kernel C [{BATCH}, {NMS_K}] (sort + gathers + the keep kernel): {ms:.4f} ms eager "
        f"with events, {device_ms:.4f} ms device time; plain loop {plain_ms:.4f} ms eager, "
        f"{plain_device_ms:.4f} ms device time; bound {bound:.6f} ms; no single PyTorch call "
        "computes the greedy keep-mask")
    return dict(name="nms", route="cuda",
                source="opencv_facerecognizer_tpu_torch/csrc/nms.cu",
                replaces="opencv_facerecognizer_tpu/ops/nms.py:34 (lax.fori_loop, no Pallas)",
                max_abs_err=float(mismatches), ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S > t_ops else "operations",
                library_ms=None)


def build_stack(device, seed: int, gallery, dtype=torch.bfloat16, fused: bool = True,
                cuda_graphs: bool = True) -> RecognitionPipeline:
    """The serving stack on ``device``, compute in ``dtype``, weights from
    ``seed`` (the same weights on every device and dtype), the fused
    embedder unless ``fused`` is False, each step a CUDA graph unless
    ``cuda_graphs`` is False."""
    det, net = serving_nets(device, seed, dtype)
    return RecognitionPipeline(det, net, gallery,
                               face_size=embedder_mod.SERVING_FACE_SIZE,
                               fused_embedder=fused, device=device, cuda_graphs=cuda_graphs)


def serving_nets(device, seed: int, dtype=torch.bfloat16):
    """The serving detector (a bias that fires on noise) and embedder on
    ``device``, compute in ``dtype``, weights from ``seed``."""
    det = detector_mod.CNNFaceDetector(device=device, dtype=dtype,
                                       generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        det.net.heatmap.bias.fill_(HEATMAP_BIAS)
        det.net.size.bias.fill_(SIZE_BIAS)
    net = embedder_mod.FaceEmbedNet(**embedder_mod.SERVING_EMBEDDER_KWARGS,
                                    input_size=embedder_mod.SERVING_FACE_SIZE,
                                    dtype=dtype,
                                    generator=torch.Generator().manual_seed(seed + 1))
    return det, net.to(device)


def drop_stack(pipeline) -> None:
    """Unhook a pipeline from its gallery and drop its cached steps (and
    with them its graphs' pool), so a stack built for one measurement
    does not outlive it."""
    g = pipeline.gallery
    for hooks, fn in ((g.prewarm_hooks, pipeline.prewarm_capacity),
                      (g.evict_hooks, pipeline.evict_below)):
        if fn in hooks:
            hooks.remove(fn)
    pipeline._step_cache.clear()


def bf16_gallery(device, rows: np.ndarray, labels: np.ndarray) -> ShardedGallery:
    gallery = ShardedGallery(len(rows), DIM, store_dtype=torch.bfloat16, device=device)
    gallery.add(rows, labels)
    return gallery


def _iou(a, b) -> float:
    ih = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iw = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ih * iw
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-12)


def cross_check_frame(a, b, i, threshold: float, iou_threshold: float):
    """Pair the valid faces of frame ``i`` in two unpacked results by box
    (slot order may differ where two scores tie to rounding noise).
    Returns (pairs [(slot a, slot b, box diff)], boundary swaps); raises on
    a face without a partner that is not a boundary swap (see
    XCHECK_SCORE)."""
    ia = list(np.flatnonzero(a.valid[i]))
    ib = list(np.flatnonzero(b.valid[i]))
    pairs, lone = [], []
    for j in ia:
        d = [np.abs(a.boxes[i, j] - b.boxes[i, m]).max() for m in ib]
        if d and min(d) <= XCHECK_BOX_PX:
            pairs.append((j, ib.pop(int(np.argmin(d))), min(d)))
        else:
            lone.append((a, j))
    lone += [(b, m) for m in ib]
    kept = [r.boxes[i, j] for r in (a, b) for j in np.flatnonzero(r.valid[i])]
    for r, j in lone:
        score = float(r.det_scores[i, j])
        cutoff = float(r.det_scores[i][r.valid[i]].min())
        near_score = min(abs(score - threshold), abs(score - cutoff)) <= XCHECK_SCORE
        near_iou = any(abs(_iou(r.boxes[i, j], k) - iou_threshold) <= XCHECK_IOU
                       for k in kept if not np.array_equal(k, r.boxes[i, j]))
        if not (near_score or near_iou):
            raise AssertionError(f"CPU cross-check: frame {i} face at "
                                 f"{r.boxes[i, j].tolist()} (score {score}) on one "
                                 "device only, not at a decision boundary")
    return pairs, len(lone)


def step_time_ms(pipeline, batch, iters: int = 20) -> float:
    """Host-clock ms of one serving step, result back on the host."""
    for _ in range(3):
        pipeline.recognize_batch_packed(batch).cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipeline.recognize_batch_packed(batch).cpu()
    return (time.perf_counter() - t0) * 1e3 / iters


def back_to_back_ms(pipeline, batch, iters: int = 20) -> float:
    """Host-clock ms per step of ``iters`` steps queued back to back (one
    synchronize at the end): the card's time per step when the host keeps
    ahead, the host's when it does not."""
    for _ in range(3):
        pipeline.recognize_batch_packed(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipeline.recognize_batch_packed(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def host_call_ms(pipeline, frames, iters: int = 20) -> float:
    """Median host-clock ms of the serving call alone (its replays and
    copies queued; ``frames`` already on the card), the queue drained
    before each call: the host's cost of a step."""
    for _ in range(3):
        pipeline.recognize_batch_packed(frames)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.recognize_batch_packed(frames)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def _profiled(fn, steps: int):
    """(device events averaged over ``steps`` calls of ``fn``, host-clock
    ms per call, graph launches per call) from ``torch.profiler``. Only
    device-side events (kernels, copies, sets) count: an operator's row
    repeats the device time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    rows = [e for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    launches = sum(e.count for e in events if e.key == "cudaGraphLaunch") / steps
    return rows, wall_ms, launches


def profile_step(pipeline, batch, steps: int = 3, what: str = "") -> dict:
    """Device time by kernel over a few serving steps (torch.profiler), the
    card's busy share of the profiled wall time with the result read back
    per step and with the steps queued back to back, device operations and
    graph launches per step."""
    pipeline.recognize_batch_packed(batch).cpu()
    rows, wall_ms, graph_launches = _profiled(
        lambda: pipeline.recognize_batch_packed(batch).cpu(), steps)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    ops = sum(e.count for e in rows) / steps
    b2b_rows, b2b_wall_ms, _ = _profiled(lambda: pipeline.recognize_batch_packed(batch),
                                         2 * steps)
    b2b_device_ms = sum(e.self_device_time_total for e in b2b_rows) / 1e3 / (2 * steps)
    log(f"profile {what} over {steps} steps: device {device_ms:.3f} ms per step, wall "
        f"{wall_ms:.3f} ms under the profiler, card busy {device_ms / wall_ms:.1%}; "
        f"back to back {b2b_wall_ms:.3f} ms per step, card busy "
        f"{b2b_device_ms / b2b_wall_ms:.1%}; {ops:.0f} device ops and "
        f"{graph_launches:.0f} graph launches per step")
    for e in rows[:12]:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms  x{e.count // steps:<5d} "
            f"{e.key[:90]}")
    return dict(device_ms=device_ms, profiled_wall_ms=wall_ms, busy=device_ms / wall_ms,
                back_to_back_profiled_wall_ms=b2b_wall_ms,
                busy_back_to_back=b2b_device_ms / b2b_wall_ms, device_ops=ops,
                graph_launches=graph_launches)


#: (wrapper, attribute, name in the kernels' JSON) of every kernel on the path
KERNEL_COUNTERS = ((streaming_match_topk, "launches", "streaming_match"),
                   (fused_sep_block, "launches", "sepblock"),
                   (nms_mask, "launches", "nms"))


def zero_counters() -> None:
    for fn, attr, _name in KERNEL_COUNTERS:
        setattr(fn, attr, 0)
    ivf_match_topk.calls = 0


def read_launches() -> dict:
    return {name: getattr(fn, attr) for fn, attr, name in KERNEL_COUNTERS}


def run_service(pipeline, frames):
    """Serve ``frames`` through a ``RecognizerService`` over
    ``FakeConnector``; the kernels' launch counts and the two-stage match
    count are set to 0 after the warm-up (which captures the ladder's
    graphs) and read after the drain, replays included. Fails unless every
    frame gets one result and every step launched kernel C once, kernel B
    six times with the fused embedder and kernel A once on the exact
    kernel path. Returns (results, launches, service, seconds)."""
    conn = FakeConnector()
    service = RecognizerService(pipeline, conn, batch_size=BATCH, frame_shape=FRAME,
                                transfer_dtype=np.uint8, flush_timeout=0.05)
    service.start(warmup=True)
    # the path's launches: counted from here to the end of the drain
    zero_counters()
    t_serve = time.perf_counter()
    try:
        for i, frame in enumerate(frames):
            conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"i": i}})
        if not service.drain(timeout=300.0):
            raise AssertionError("service did not drain")
    finally:
        service.stop()
    serve_s = time.perf_counter() - t_serve
    launches = read_launches()
    results = conn.messages(RESULT_TOPIC)
    if len(results) != len(frames) or sorted(r["meta"]["i"] for r in results) != list(
            range(len(frames))):
        raise AssertionError("not one result per frame")
    steps = int(service.metrics.counter(BATCHES_DISPATCHED))
    g = pipeline.gallery
    exact_kernel = g.kernel_enabled(g.data.capacity) and ivf_match_topk.calls == 0
    want = {"nms": steps, "sepblock": 6 * steps if pipeline.fused_embedder else 0}
    if exact_kernel:
        want["streaming_match"] = steps
    if steps < 1 or pipeline.device.type == "cuda" and (  # the CPU launches no kernel
            any(launches[k] != n for k, n in want.items()) or min(launches.values()) < 1):
        raise AssertionError(f"launches {launches} in {steps} steps; each step must launch "
                             f"{ {k: n // max(steps, 1) for k, n in want.items()} }")
    return results, launches, service, serve_s


def check_planted(results, n_plant: int) -> float:
    """The faces of the first batch found their planted rows (labels
    0 .. n_plant - 1) at similarity >= 0.99; returns the lowest."""
    first = sorted((r for r in results if r["meta"]["i"] < BATCH),
                   key=lambda r: r["meta"]["i"])
    found = [f for r in first for f in r["faces"]]
    if len(found) != n_plant or sorted(f["label"] for f in found) != list(range(n_plant)):
        raise AssertionError("served faces of the first batch did not find their planted rows")
    if min(f["similarity"] for f in found) < 0.99:
        raise AssertionError("a planted face matched below similarity 0.99")
    return min(f["similarity"] for f in found)


def serve(dev, seed: int, n_frames: int):
    """Phases 4-5. Returns the kernels' launches in the serving run and
    what the IVF phase reuses (the stack, the gallery rows with the
    planted faces last, the frames)."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    rows = rng.standard_normal((GALLERY_ROWS, DIM), dtype=np.float32)
    labels = np.arange(GALLERY_ROWS, dtype=np.int32) + 100000
    frames = rng.integers(0, 256, (n_frames, *FRAME), dtype=np.uint8)
    # Plant the first batch's faces (their own embeddings on the card)
    # with labels 0..n-1 in the last rows of the gallery.
    gpu = build_stack(dev, seed, ShardedGallery(GALLERY_ROWS, DIM, store_dtype=torch.bfloat16,
                                                device=dev))
    _b, _s, valid, emb = gpu.embed_frames(frames[:BATCH])
    planted = emb[valid.reshape(-1)].float().cpu().numpy()
    n_plant = len(planted)
    if n_plant < BATCH:
        raise AssertionError(f"only {n_plant} faces in the first batch: nothing to check")
    rows[GALLERY_ROWS - n_plant:] = planted
    labels[GALLERY_ROWS - n_plant:] = np.arange(n_plant)
    gpu.gallery.add(rows, labels)
    log(f"setup: {GALLERY_ROWS} bf16 gallery rows ({n_plant} planted faces), "
        f"{n_frames} frames, {time.perf_counter() - t0:.1f} s")

    results, launches, service, serve_s = run_service(gpu, frames)
    log(f"kernel A's path on the serving gallery: {streaming_match_topk.last_path}")
    log(f"served {len(results)} results for {n_frames} frames in {serve_s:.3f} s; "
        f"launches {launches}; ledger {service.ledger()}")
    summary = service.metrics.summary()
    log("service latency p50 ms:", {k: round(v, 3) for k, v in summary.items()
                                    if k.endswith("_p50_ms") and v is not None})
    min_sim = check_planted(results, n_plant)
    log(f"first batch: all {n_plant} faces matched their planted rows (min sim {min_sim:.5f})")

    # CPU cross-check of the first batch in f32 (XCHECK_*): the card's stack
    # over the 2^20-row gallery, the CPU's over the planted rows among 4096
    # random ones.
    small = np.concatenate([rows[:4096], planted])
    small_labels = np.concatenate([labels[:4096], np.arange(n_plant, dtype=np.int32)])
    gpu32 = build_stack(dev, seed, gpu.gallery, dtype=torch.float32)
    cpu32 = build_stack("cpu", seed, bf16_gallery("cpu", small, small_labels),
                        dtype=torch.float32)
    a = unpack_result(gpu32.recognize_batch_packed(frames[:BATCH]).cpu().numpy(), 1)
    b = unpack_result(cpu32.recognize_batch_packed(frames[:BATCH]).numpy(), 1)
    worst_box = worst_sim = 0.0
    n_pairs = n_swaps = 0
    for i in range(BATCH):
        pairs, swaps = cross_check_frame(a, b, i, gpu.detector.score_threshold,
                                         gpu.detector.iou_threshold)
        n_pairs += len(pairs)
        n_swaps += swaps
        for j, m, dbox in pairs:
            if a.labels[i, j, 0] != b.labels[i, m, 0]:
                raise AssertionError(f"CPU cross-check: frame {i} labels differ")
            worst_box = max(worst_box, dbox)
            worst_sim = max(worst_sim, abs(a.similarities[i, j, 0] - b.similarities[i, m, 0]))
    if worst_sim > XCHECK_SIM:
        raise AssertionError(f"CPU cross-check: sim differs by {worst_sim}")
    log(f"CPU cross-check (f32): {n_pairs} faces on both devices with equal labels, max box "
        f"diff {worst_box:.4f} px (bound {XCHECK_BOX_PX}), max sim diff {worst_sim:.2e} "
        f"(bound {XCHECK_SIM}); {n_swaps} boundary swaps; valid masks equal: "
        f"{bool((a.valid == b.valid).all())}")

    # steady-state step (host frames in, packed result back on the host),
    # graphed and eager, fused embedder (kernel B) and unfused, in turns
    step = time_steps(dev, seed, gpu, frames[:BATCH], n_plant)
    return launches, dict(stack=gpu, rows=rows, labels=labels, n_plant=n_plant, frames=frames,
                          step=step)


def time_steps(dev, seed: int, gpu, batch, faces_per_batch: int) -> dict:
    """Phase 5: the serving step over ``gpu``'s gallery four ways (CUDA
    graphs or eager, fused or unfused embedder; the same weights), each by
    host clock with the result read back per step (in turns: graphed,
    eager, eager, graphed), by host clock back to back, and profiled.
    Also the capture time of each ladder rung and the graph pool's bytes
    of the serving stack ``gpu``."""
    stacks = {(True, True): gpu}
    for graphs, fused in ((True, False), (False, True), (False, False)):
        stacks[(graphs, fused)] = build_stack(dev, seed, gpu.gallery, fused=fused,
                                              cuda_graphs=graphs)
    out = {"capture_ms": {str(k[0]): v for k, v in gpu.capture_ms.items()},
           "graph_pool_bytes": gpu.graph_pool_bytes(),
           "memory_reserved_bytes": torch.cuda.memory_reserved()}
    for fused in (True, False):
        ms = {True: [], False: []}
        for graphs in (True, False, False, True):
            ms[graphs].append(step_time_ms(stacks[(graphs, fused)], batch))
        for graphs in (True, False):
            p = stacks[(graphs, fused)]
            what = f"{'graphed' if graphs else 'eager'} {'fused' if fused else 'unfused'}"
            t = float(np.mean(ms[graphs]))
            b2b = back_to_back_ms(p, batch)
            prof = profile_step(p, batch, what=what)
            out[what.replace(" ", "_")] = dict(host_ms=ms[graphs], back_to_back_ms=b2b,
                                               **prof)
            log(f"steady-state step, {what}: {[round(v, 3) for v in ms[graphs]]} ms per batch "
                f"of {BATCH} frames, host clock ({BATCH * 1e3 / t:.1f} frames/s, "
                f"{BATCH * MAX_FACES * 1e3 / t:.1f} face slots/s, "
                f"{faces_per_batch * 1e3 / t:.1f} detected faces/s); back to back "
                f"{b2b:.3f} ms per step")
    graphed = stacks[(True, True)].recognize_batch_packed(batch).clone()
    eager = stacks[(False, True)].recognize_batch_packed(batch)
    out["graphed_equals_eager"] = bool(torch.equal(graphed, eager))
    out["graphed_vs_eager_max_abs"] = float((graphed - eager).abs().max().item())
    log(f"graphed step vs eager step, same frames: equal bit for bit "
        f"{out['graphed_equals_eager']} (max |diff| {out['graphed_vs_eager_max_abs']:.3e}); "
        f"capture ms per rung {out['capture_ms']}; graph pool "
        f"{out['graph_pool_bytes']} bytes")
    for key, p in stacks.items():
        if key != (True, True):
            drop_stack(p)
    return out


def _unit_rows(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _perturbed(rows: np.ndarray, n: int, rng) -> np.ndarray:
    """``n`` unit queries: gallery rows at random indices plus noise (the
    reference's serving-distribution queries)."""
    pick = rng.choice(len(rows), n, replace=False)
    return _unit_rows(_unit_rows(rows[pick]) + IVF_QUERY_NOISE * rng.standard_normal(
        (n, rows.shape[1]), dtype=np.float32)).astype(np.float32)


def ivf_recall_gate(device) -> dict:
    """The reference's ``bench.py --ivf-smoke`` through the port on
    ``device``: a gallery of IVF_SMOKE rows in mode "ivf", perturbed
    enrolled rows as queries, the tie-aware recall of the two-stage top-1
    against the exact scan (f32, ties to the lowest index), and four rows
    enrolled after the build found at once. The data is the reference
    script's, from its seed; the k-means init is the port's own."""
    c = IVF_SMOKE
    rows, dim, n_q = c["rows"], c["dim"], c["n_q"]
    rng = np.random.default_rng(c["seed"])
    emb = rng.normal(size=(rows, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    gallery = ShardedGallery(rows, dim, device=device)
    gallery.add(emb, np.arange(rows, dtype=np.int32))
    quantizer = CoarseQuantizer(nlist=c["nlist"], nprobe=c["nprobe"], seed=c["quantizer_seed"],
                                kmeans_iters=c["kmeans_iters"], train_sample=c["train_sample"])
    gallery.attach_quantizer(quantizer, mode="ivf")
    if not quantizer.rebuild_now():
        raise AssertionError("IVF smoke gate: the quantizer build failed")
    queries = emb[:n_q] + 0.05 * rng.normal(size=(n_q, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    calls = ivf_match_topk.calls  # both matches below must go through IVF
    _l, sims_i, idx_i = gallery.match(queries, k=1)
    sims = queries @ emb.T
    idx_x = np.argmax(sims, axis=1)
    recall = tie_aware_agreement(sims_i.cpu(), idx_i.cpu(), sims[np.arange(n_q), idx_x], idx_x)
    new = rng.normal(size=(4, dim)).astype(np.float32)
    new /= np.linalg.norm(new, axis=-1, keepdims=True)
    start = gallery.size
    gallery.add(new, np.arange(rows, rows + 4, dtype=np.int32))
    _l, _s, idx_new = gallery.match(np.concatenate([new, new]), k=1)
    return dict(recall=recall, two_stage_calls=ivf_match_topk.calls - calls,
                incremental_rows_found=bool(np.array_equal(
                    idx_new[:4, 0].cpu().numpy(), np.arange(start, start + 4))),
                stats=quantizer.stats())


def build_ivf_gallery(dev, rows: np.ndarray, labels: np.ndarray, seed: int, late: int = 0):
    """A bf16 gallery of ``rows`` with a quantizer attached in mode "auto"
    (default nlist, IVF_NPROBE) and built; the last ``late`` rows are
    enrolled after the build, through the incremental path."""
    n = len(rows) - late
    gallery = ShardedGallery(len(rows), DIM, store_dtype=torch.bfloat16, device=dev)
    gallery.add(rows[:n], labels[:n])
    quantizer = CoarseQuantizer(nlist=CoarseQuantizer.default_nlist(n), nprobe=IVF_NPROBE,
                                seed=seed, auto_nlist=True, metrics=Metrics())
    gallery.attach_quantizer(quantizer, mode="auto")
    t0 = time.perf_counter()
    if not quantizer.rebuild_now():
        raise AssertionError("IVF build failed")
    build_s = time.perf_counter() - t0
    if late:
        gallery.add(rows[n:], labels[n:])
    ivf = gallery._ivf_data(gallery.data)
    if ivf is None or not gallery._ivf_enabled() or gallery.capacity != len(rows):
        raise AssertionError(f"the gallery of {len(rows)} rows does not serve through IVF")
    if quantizer.metrics.counter(IVF_INCREMENTAL_ROWS) != late:
        raise AssertionError("the late rows did not go through the incremental path")
    info = dict(rows=len(rows), nlist=ivf.nlist, max_cell=ivf.max_cell, spill_cap=ivf.spill_cap,
                spill_rows=quantizer.spill_count,
                list_bytes=sum(t.numel() * t.element_size() for t in ivf[:7]),
                build_s=build_s, **{f"{k}_s": v for k, v in quantizer.last_build_s.items()})
    log(f"IVF gallery of {len(rows)} rows: nlist {ivf.nlist}, max_cell {ivf.max_cell}, "
        f"spill {quantizer.spill_count} of {ivf.spill_cap}, lists {info['list_bytes']} B on "
        f"the card; build {build_s:.3f} s (" + ", ".join(
            f"{k} {v:.3f} s" for k, v in quantizer.last_build_s.items())
        + f"); {late} rows enrolled after the build")
    return gallery, info


def check_ivf(gallery, queries: torch.Tensor) -> float:
    """The two-stage match with kernel A as the rerank against the same
    match with the plain rerank, on the gallery's IVFDeviceData: top-1
    indices equal, the other indices equal except ties within MATCH_ATOL
    (the rule of phase 3), sims within MATCH_ATOL. Returns the max error."""
    data = gallery.data
    ivf = gallery._ivf_data(data)
    max_err = 0.0
    for qn in IVF_QS:
        q = queries[:qn]
        for k in IVF_KS:
            got_v, got_i = ivf_match_topk(q, data.valid, ivf, k=k, nprobe=IVF_NPROBE)
            want_v, want_i = ivf_match_topk(q, data.valid, ivf, k=k, nprobe=IVF_NPROBE,
                                            rerank=streaming_match_topk_plain)
            torch.cuda.synchronize()
            err = (got_v - want_v).abs().max().item()
            beyond_ties = ((got_i != want_i) & ((got_v - want_v).abs() > MATCH_ATOL)).sum().item()
            if (err > MATCH_ATOL or beyond_ties
                    or not torch.equal(got_i[:, 0], want_i[:, 0])):
                raise AssertionError(f"IVF Q={qn} k={k}: kernel A rerank differs from the "
                                     f"plain rerank (max sim err {err}, {beyond_ties} index "
                                     "mismatches beyond ties)")
            log(f"IVF two-stage Q={qn} k={k}: kernel A rerank vs plain rerank, max |sim| err "
                f"{err:.3e}, index agreement {(got_i == want_i).float().mean().item():.6f}")
            max_err = max(max_err, err)
    return max_err


def time_ivf(gallery, q: torch.Tensor, with_plain: bool = False) -> dict:
    """``gallery.match`` through IVF and through the exact kernel (mode
    "exact"), k = 1: CUDA events around eager calls (``*_ms``) and the
    device time of a CUDA graph of the calls (``*_device_ms``); the IVF
    time split into stage 1, the bucket and the rerank (kernel A), and
    kernel A's time, bound and library call at the rerank shape."""
    data = gallery.data
    ivf = gallery._ivf_data(data)
    calls = ivf_match_topk.calls
    out = dict(q=q.shape[0], rows=data.capacity)
    out["ivf_ms"] = cuda_ms(lambda: gallery.match(q, k=1), iters=10)
    if ivf_match_topk.calls == calls:
        raise AssertionError("gallery.match did not take the IVF path")
    out["ivf_device_ms"] = _graph_ms_or_none(lambda: gallery.match(q, k=1), "IVF match")
    out["stage1_ms"] = cuda_ms(lambda: shortlist_cells(q, ivf.centroids, IVF_NPROBE), iters=10)
    sel = shortlist_cells(q, ivf.centroids, IVF_NPROBE)
    out["bucket_ms"] = cuda_ms(lambda: gather_bucket(sel, data.valid, ivf), iters=10)
    _ids, bucket, bvalid = gather_bucket(sel, data.valid, ivf)
    out["rerank_ms"] = cuda_ms(lambda: streaming_match_topk(q, bucket, bvalid, k=1), iters=10)
    gallery.match_mode = "exact"
    try:
        out["exact_ms"] = cuda_ms(lambda: gallery.match(q, k=1), iters=10)
        out["exact_device_ms"] = _graph_ms_or_none(lambda: gallery.match(q, k=1),
                                                   "exact match")
    finally:
        gallery.match_mode = "auto"
    n = bucket.shape[0]
    nbytes = q.numel() * 4 + bucket.numel() * 2 + n + q.shape[0] * 8
    flops = 2 * q.shape[0] * DIM * n
    out.update(cells=int((sel < ivf.nlist).sum().item()), union_slots=sel.shape[0],
               rerank_rows=n, rerank_bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                                  flops / BF16_FLOPS) * 1e3,
               rerank_bound_by="bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS
               else "operations")
    qb = q.to(torch.bfloat16)

    def library():
        s = torch.matmul(qb, bucket.T)
        return torch.topk(torch.where(bvalid, s, torch.finfo(s.dtype).min), 1)

    out["rerank_library_ms"] = cuda_ms(library, iters=5, warmup=1)
    if with_plain:
        out["rerank_plain_ms"] = cuda_ms(
            lambda: streaming_match_topk_plain(q, bucket, bvalid, k=1), iters=3, warmup=1)
    del bucket, bvalid
    log(f"IVF match timing, {out['rows']} rows, Q={out['q']}: IVF {out['ivf_ms']:.4f} ms "
        f"(stage 1 {out['stage1_ms']:.4f}, bucket {out['bucket_ms']:.4f}, rerank "
        f"{out['rerank_ms']:.4f}; device {out['ivf_device_ms']}), exact kernel "
        f"{out['exact_ms']:.4f} ms (device {out['exact_device_ms']}); {out['cells']} of "
        f"{ivf.nlist} cells probed, rerank over {n} rows: bound {out['rerank_bound_ms']:.4f} ms "
        f"({out['rerank_bound_by']}), matmul + topk {out['rerank_library_ms']:.4f} ms"
        + (f", plain {out['rerank_plain_ms']:.4f} ms" if with_plain else ""))
    return out


def _graph_ms_or_none(fn, what: str):
    """``graph_ms`` of a few calls, or None (logged) where the calls
    cannot be captured in a CUDA graph."""
    try:
        return graph_ms(fn, iters=3)
    except RuntimeError as exc:
        log(f"{what}: device time not measured (CUDA graph capture failed: {exc})")
        torch.cuda.synchronize()
        return None


def time_random_ivf(dev, n_rows: int, seed: int) -> list:
    """``time_ivf`` at IVF_TIME_QS on a gallery of ``n_rows`` random unit
    rows (match alone), built and freed here."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + n_rows)
    rows = rng.standard_normal((n_rows, DIM), dtype=np.float32)
    q = torch.from_numpy(_perturbed(rows, max(IVF_TIME_QS), rng)).to(dev)
    gallery, build = build_ivf_gallery(dev, rows, np.arange(n_rows, dtype=np.int32), seed)
    del rows
    log(f"IVF gallery of {n_rows} rows set up in {time.perf_counter() - t0:.1f} s")
    timing = [time_ivf(gallery, q[:qn]) for qn in IVF_TIME_QS]
    del gallery
    torch.cuda.empty_cache()
    return build, timing


def ivf_phase(dev, seed: int, ctx: dict) -> dict:
    """Phase 6 (module docstring); returns the ``{"ivf": ...}`` numbers."""
    rows, labels, n_plant = ctx["rows"], ctx["labels"], ctx["n_plant"]
    gallery, build = build_ivf_gallery(dev, rows, labels, seed, late=n_plant)
    rng = np.random.default_rng(seed + 1)
    queries = torch.from_numpy(_perturbed(rows[:-n_plant], max(IVF_TIME_QS), rng)).to(dev)
    max_err = check_ivf(gallery, queries)

    stack = ctx["stack"]
    pipeline = RecognitionPipeline(stack.detector, stack.embed_net, gallery,
                                   face_size=embedder_mod.SERVING_FACE_SIZE,
                                   fused_embedder=True, device=dev)
    frames = ctx["frames"]
    results, launches, service, serve_s = run_service(pipeline, frames)
    steps = int(service.metrics.counter(BATCHES_DISPATCHED))
    if not gallery.quantizer.ready or ivf_match_topk.calls != steps or steps < 1:
        raise AssertionError(f"IVF serving: {ivf_match_topk.calls} two-stage matches in "
                             f"{steps} steps (quantizer ready: {gallery.quantizer.ready})")
    min_sim = check_planted(results, n_plant)
    log(f"IVF serving: {len(results)} results for {len(frames)} frames in {serve_s:.3f} s, "
        f"{steps} steps all through the two-stage match, launches {launches}; first batch: "
        f"all {n_plant} faces matched their planted rows (min sim {min_sim:.5f})")

    # two-stage recall against the exact scan on random rows (not gated)
    _l, sims_i, idx_i = gallery.match(queries, k=1)
    gallery.match_mode = "exact"
    _l, sims_x, idx_x = gallery.match(queries, k=1)
    gallery.match_mode = "auto"
    recall = tie_aware_agreement(sims_i.cpu(), idx_i.cpu(), sims_x.cpu(), idx_x.cpu())
    log(f"IVF recall at {GALLERY_ROWS} random rows, {queries.shape[0]} perturbed rows as "
        f"queries: {recall:.4f} of the exact scan's top-1 (not gated)")

    ivf_step = step_time_ms(pipeline, frames[:BATCH])
    log(f"IVF steady-state step (fused embedder): {ivf_step:.3f} ms per batch of {BATCH} "
        "frames, host clock")
    timing = [time_ivf(gallery, queries[:qn], with_plain=qn == max(IVF_TIME_QS))
              for qn in IVF_TIME_QS]
    ctx.update(ivf_gallery=gallery, queries=queries)  # the durability phase's
    del pipeline
    builds = [build]
    for n_rows in IVF_OTHER_ROWS:
        other_build, other_timing = time_random_ivf(dev, n_rows, seed)
        builds.append(other_build)
        timing += other_timing
    for n_rows in sorted({t["rows"] for t in timing}):
        wins = [t["q"] for t in timing if t["rows"] == n_rows and t["ivf_ms"] < t["exact_ms"]]
        log(f"IVF vs exact at {n_rows} rows: IVF faster at Q = {wins or 'none of'} "
            f"{list(IVF_TIME_QS)}")

    gate = ivf_recall_gate(dev)
    if gate["recall"] < IVF_SMOKE_RECALL or not gate["incremental_rows_found"] or (
            gate["two_stage_calls"] != 2):
        raise AssertionError(f"IVF smoke gate failed: {gate}")
    log(f"IVF smoke gate ({IVF_SMOKE['rows']} x {IVF_SMOKE['dim']}, nlist "
        f"{IVF_SMOKE['nlist']}, nprobe {IVF_SMOKE['nprobe']}): recall {gate['recall']:.4f} "
        f"(gate {IVF_SMOKE_RECALL}), rows enrolled after the build found")
    return dict(build=builds, max_abs_err=max_err, serve_launches=launches,
                serve_steps=steps, step_ms=ivf_step, recall_2p20=recall,
                smoke_recall=gate["recall"], timing=timing)


def write_pgm(path: str, img: np.ndarray) -> None:
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode() + img.astype(np.uint8).tobytes())


def write_cli_inputs(dev, seed: int, root: str):
    """The port-written checkpoints of the serving detector and embedder
    (phase 4's weights), a gallery directory and a frames directory under
    ``root``; returns (paths, frames)."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "frames"))
    rng = np.random.default_rng(seed + 7)
    det = detector_mod.CNNFaceDetector(device=dev, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        det.net.heatmap.bias.fill_(HEATMAP_BIAS)
        det.net.size.bias.fill_(SIZE_BIAS)
    paths = dict(model=os.path.join(root, "model.ckpt"), det=os.path.join(root, "det.ckpt"),
                 gallery=os.path.join(root, "gallery"), frames=os.path.join(root, "frames"),
                 metrics=os.path.join(root, "metrics.jsonl"))
    det.save(paths["det"])
    faces = rng.integers(0, 256, (CLI_SUBJECTS * CLI_IMAGES, *embedder_mod.SERVING_FACE_SIZE))
    emb = embedder_mod.CNNEmbedding(**embedder_mod.SERVING_EMBEDDER_KWARGS,
                                    input_size=embedder_mod.SERVING_FACE_SIZE,
                                    train_steps=0, seed=seed + 1, device=dev)
    model = PredictableModel(emb, NearestNeighbor(CosineDistance(), device=dev))
    model.compute(faces.astype(np.float32), np.arange(len(faces)) // CLI_IMAGES)
    serialization.save_model(paths["model"], model)
    for i, face in enumerate(faces):
        subject = os.path.join(paths["gallery"], f"subject_{i // CLI_IMAGES}")
        os.makedirs(subject, exist_ok=True)
        write_pgm(os.path.join(subject, f"{i}.pgm"), face)
    frames = rng.integers(0, 256, (CLI_FRAMES, *FRAME), dtype=np.uint8)
    for i, frame in enumerate(frames):
        write_pgm(os.path.join(paths["frames"], f"f{i:03d}.pgm"), frame)
    return paths, frames


def cli_args(paths: dict, source: str, dev) -> list:
    """The CLI's command line; the device stays the CLI's default (the
    card) unless ``dev`` is the CPU (a rehearsal)."""
    return ["--model", paths["model"], "--detector", paths["det"], "--gallery",
            paths["gallery"], "--source", source, "--capacity", str(CLI_CAPACITY),
            "--match-mode", "exact", "--fused-embedder", "--batch-size", str(BATCH),
            "--frame-size", str(FRAME[0]), str(FRAME[1]), "--metrics-jsonl", paths["metrics"],
            *(["--device", "cpu"] if dev.type == "cpu" else [])]


def metrics_records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def messages_as_result(messages, max_faces: int):
    """Published result messages (one frame each, in order) as an unpacked
    result (boxes yxyx), for ``cross_check_frame``."""
    n = len(messages)
    packed = np.zeros((n, max_faces, 8), np.float32)
    for i, msg in enumerate(messages):
        for j, face in enumerate(msg["faces"]):
            x0, y0, x1, y1 = face["box"]
            packed[i, j, :6] = (y0, x0, y1, x1, face["detection_score"], 1.0)
            packed[i, j, 6:8] = (face["label"], face["similarity"])
    return unpack_result(packed, 1)


def run_jsonl_cli(paths: dict, frames: np.ndarray, dev) -> dict:
    """The CLI in jsonl mode in a subprocess (``python -m``), stdin a pipe:
    CLI_JSONL_FRAMES frames, ``enroll``, frames of scene 0 until
    ``enrolled`` is published, CLI_JSONL_FRAMES more of scene 0,
    ``stats``, EOF. Returns the messages it printed and its exit code."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
                             *cli_args(paths, "jsonl", dev)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    out, err = [], []
    readers = [threading.Thread(target=lambda: out.extend(json.loads(l) for l in proc.stdout),
                                daemon=True),
               threading.Thread(target=lambda: err.extend(proc.stderr), daemon=True)]
    for r in readers:
        r.start()

    def send(topic, data):
        proc.stdin.write(json.dumps({"topic": topic, "data": data}) + "\n")
        proc.stdin.flush()

    def enrolled():
        return any(m["topic"] == STATUS_TOPIC and m["data"]["status"] == "enrolled" for m in out)

    seq = 0
    try:
        for i in range(CLI_JSONL_FRAMES):
            send(FRAME_TOPIC, {**encode_frame(frames[i]), "meta": {"seq": seq}})
            seq += 1
        send(CONTROL_TOPIC, {"cmd": "enroll", "subject": CLI_NEW_NAME, "count": CLI_ENROL_COUNT})
        deadline = time.monotonic() + 300
        while not enrolled() and time.monotonic() < deadline and proc.poll() is None:
            send(FRAME_TOPIC, {**encode_frame(frames[0]), "meta": {"seq": seq, "scene": 0}})
            seq += 1
            time.sleep(0.2)
        first_after = seq
        for _ in range(CLI_JSONL_FRAMES):
            send(FRAME_TOPIC, {**encode_frame(frames[0]), "meta": {"seq": seq, "scene": 0}})
            seq += 1
        send(CONTROL_TOPIC, {"cmd": "stats"})
        proc.stdin.close()
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for r in readers:
        r.join(timeout=10)
    if rc != 0:
        log("".join(err[-40:]))
    return dict(messages=out, rc=rc, sent=seq, first_after=first_after)


def cli_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 7 (module docstring); returns the ``{"cli": ...}`` numbers and
    leaves its inputs in ``ctx`` for phase 8."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_smoke")
    paths, frames = write_cli_inputs(dev, seed, root)
    ctx.update(cli_paths=paths, cli_frames=frames)
    # the native loader's one-time g++ build, timed on its own; the CLI's
    # _load_stack times the checkpoint load and the gallery embed itself
    # and logs them as its `startup` record
    t_build = time.perf_counter()
    if not native.available():
        raise AssertionError("the native image loader did not build")
    native_build_s = time.perf_counter() - t_build
    log(f"cli: native loader built in {native_build_s:.3f} s")

    streaming_match_topk.launches = 0
    fused_sep_block.launches = 0
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        # batches fill to BATCH (no deadline flush), so the first batch is
        # the first BATCH files, as the direct call below takes them
        rc = recognize_app.main(cli_args(paths, "dir", dev)
                                + ["--dir", paths["frames"], "--flush-ms", "1000"])
    launches = {"streaming_match": streaming_match_topk.launches,
                "sepblock": fused_sep_block.launches}
    results = [json.loads(line) for line in stdout.getvalue().splitlines() if line.startswith("{")]
    files = sorted(os.listdir(paths["frames"]))
    if rc != 0 or sorted(r["meta"]["file"] for r in results) != files:
        raise AssertionError(f"cli dir run: rc {rc}, {len(results)} results for {len(files)} frames")
    if dev.type == "cuda" and min(launches.values()) < 1:  # the CPU launches no kernel
        raise AssertionError(f"cli dir run: a kernel did not launch: {launches}")
    records = {r["event"]: r for r in metrics_records(paths["metrics"])}
    startup, replay, ledger = records["startup"], records["dir_replay"], \
        records["shutdown"]["ledger"]
    if ledger["in_system"] != 0 or ledger["completed"] != len(files):
        raise AssertionError(f"cli dir run: the ledger does not close: {ledger}")
    log(f"cli dir run's startup: checkpoints loaded in {startup['checkpoint_load_s']:.4f} s, "
        f"gallery directory of {startup['gallery_images']} images embedded in "
        f"{startup['gallery_embed_s']:.4f} s ({card})")

    # the first batch against a direct RecognitionPipeline call on the
    # same checkpoints and gallery directory, loaded here again
    model = serialization.load_model(paths["model"], device=dev)
    det = detector_mod.CNNFaceDetector.load(paths["det"], device=dev)
    images, labels, _ = dataset_utils.read_images(paths["gallery"],
                                                  image_size=model.feature.input_size)
    gallery_emb = model.feature.extract(images).cpu().numpy()
    gallery = ShardedGallery(CLI_CAPACITY, DIM, store_dtype=torch.bfloat16, device=dev)
    gallery.add(gallery_emb, labels)
    direct = RecognitionPipeline(det, model.feature.net, gallery,
                                 face_size=model.feature.input_size, fused_embedder=True,
                                 device=dev)
    by_file = {r["meta"]["file"]: r for r in results}
    first = [by_file[f] for f in files[:BATCH]]
    batch = frames[:BATCH].astype(np.float32)
    want = unpack_result(direct.recognize_batch_packed(batch).cpu().numpy(), 1)
    # the service's rule: a face below the similarity threshold is label -1
    threshold = recognize_app.build_parser().get_default("similarity_threshold")
    want = want._replace(labels=np.where(want.similarities >= threshold, want.labels, -1))
    got = messages_as_result(first, det.max_faces)
    worst_box = worst_sim = 0.0
    n_pairs = n_swaps = 0
    for i in range(BATCH):
        pairs, swaps = cross_check_frame(got, want, i, det.score_threshold, det.iou_threshold)
        n_pairs += len(pairs)
        n_swaps += swaps
        for j, m, dbox in pairs:
            if got.labels[i, j, 0] != want.labels[i, m, 0]:
                raise AssertionError(f"cli vs direct pipeline: frame {i} labels differ")
            worst_box = max(worst_box, dbox)
            worst_sim = max(worst_sim, abs(got.similarities[i, j, 0] - want.similarities[i, m, 0]))
    if worst_sim > XCHECK_SIM or n_pairs < BATCH:
        raise AssertionError(f"cli vs direct pipeline: {n_pairs} faces paired, sim diff {worst_sim}")
    log(f"cli dir run: {len(results)} results for {len(files)} frames, {replay['answered']} "
        f"answered in {replay['seconds']:.3f} s ({len(files) / replay['seconds']:.1f} frames/s, "
        f"{card}); launches {launches}; ledger {ledger}; first batch vs the direct pipeline: "
        f"{n_pairs} faces, labels equal, max box diff {worst_box:.4f} px, max sim diff "
        f"{worst_sim:.2e}, {n_swaps} boundary swaps")
    del direct, gallery
    torch.cuda.empty_cache()

    os.remove(paths["metrics"])
    run = run_jsonl_cli(paths, frames, dev)
    out = run["messages"]
    results = {m["data"]["meta"]["seq"]: m["data"] for m in out if m["topic"] == RESULT_TOPIC}
    statuses = [m["data"] for m in out if m["topic"] == STATUS_TOPIC]
    enrolled = [s for s in statuses if s["status"] == "enrolled"]
    if run["rc"] != 0 or sorted(results) != list(range(run["sent"])):
        raise AssertionError(f"cli jsonl run: rc {run['rc']}, {len(results)} results for "
                             f"{run['sent']} frames")
    if not enrolled or enrolled[0]["subject"] != CLI_NEW_NAME:
        raise AssertionError(f"cli jsonl run: no enrolment: {statuses}")
    later = [results[s] for s in range(run["first_after"], run["sent"])]
    if not all(CLI_NEW_NAME in {f["name"] for f in r["faces"]} for r in later):
        raise AssertionError("cli jsonl run: the enrolled subject did not come back by name")
    if not any(s["status"] == "stats" for s in statuses):
        raise AssertionError("cli jsonl run: no stats reply")
    records = {r["event"]: r for r in metrics_records(paths["metrics"])}
    jsonl_startup, shutdown = records["startup"], records["shutdown"]
    if shutdown["ledger"]["in_system"] != 0:
        raise AssertionError(f"cli jsonl run: the ledger does not close: {shutdown['ledger']}")
    e2e_p50 = shutdown["summary"]["e2e_latency_p50_ms"]
    stages = {k: round(shutdown["summary"][f"{k}_p50_ms"], 3) for k in (
        "queue_wait", "dispatch", "ready_wait", "publish", "batch_latency")}
    log(f"cli jsonl run: {len(results)} results for {run['sent']} frames, enrolled "
        f"{CLI_NEW_NAME!r} as label {enrolled[0]['label']}, named on all {len(later)} later "
        f"frames of its scene; e2e latency p50 {e2e_p50:.3f} ms, stage p50 ms {stages}; "
        f"startup in a new process: checkpoints loaded in "
        f"{jsonl_startup['checkpoint_load_s']:.4f} s, gallery "
        f"embedded in {jsonl_startup['gallery_embed_s']:.4f} s ({card}); "
        f"ledger {shutdown['ledger']}")
    return dict(card=card, native_build_s=native_build_s,
                checkpoint_load_s=startup["checkpoint_load_s"],
                gallery_embed_s=startup["gallery_embed_s"],
                gallery_images=startup["gallery_images"], dir_frames=len(files),
                dir_seconds=replay["seconds"], dir_frames_per_s=len(files) / replay["seconds"],
                dir_launches=launches, dir_ledger=ledger, xcheck_faces=n_pairs,
                xcheck_max_box_px=worst_box, xcheck_max_sim=worst_sim, xcheck_swaps=n_swaps,
                jsonl_frames=run["sent"], jsonl_e2e_p50_ms=e2e_p50, jsonl_stage_p50_ms=stages,
                jsonl_checkpoint_load_s=jsonl_startup["checkpoint_load_s"],
                jsonl_gallery_embed_s=jsonl_startup["gallery_embed_s"],
                jsonl_enrolled_label=enrolled[0]["label"], jsonl_ledger=shutdown["ledger"])

class RssPeak:
    """Peak resident set size of this process while the block runs,
    sampled from ``/proc/self/statm`` every 5 ms: ``base`` and ``peak``
    in bytes."""

    PAGE = os.sysconf("SC_PAGE_SIZE")

    @classmethod
    def now(cls) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * cls.PAGE

    def __enter__(self):
        self.base = self.peak = self.now()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, self.now())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.now())

    def numbers(self) -> dict:
        return dict(rss_start_bytes=self.base, rss_peak_bytes=self.peak,
                    rss_peak_above_start_bytes=self.peak - self.base)


def wait_for(pred, timeout: float, what: str, poll: float = 0.05):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(poll)


def enrol_through_control(conn, frame: np.ndarray, subject: str) -> None:
    """``enroll`` on the control topic, then the frame DUR_ENROL_COUNT
    times; returns once ``enrolled`` names the subject."""
    conn.inject(CONTROL_TOPIC, {"cmd": "enroll", "subject": subject, "count": DUR_ENROL_COUNT})
    for j in range(DUR_ENROL_COUNT):
        conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"enrol": subject, "j": j}})
    wait_for(lambda: any(m["status"] in ("enrolled", "enroll_failed") and m["subject"] == subject
                         for m in conn.messages(STATUS_TOPIC) if "subject" in m),
             300, f"the enrolment of {subject}")
    if not any(m["status"] == "enrolled" and m.get("subject") == subject
               for m in conn.messages(STATUS_TOPIC)):
        raise AssertionError(f"enrolment of {subject} failed: {conn.messages(STATUS_TOPIC)[-3:]}")


def timed_wal_appends(state) -> list:
    """Seconds of each WAL append of ``state`` (its fsync included)."""
    seconds = []
    real = state.wal.append_enroll

    def timed(*args, **kwargs):
        t = time.perf_counter()
        real(*args, **kwargs)
        seconds.append(time.perf_counter() - t)

    state.wal.append_enroll = timed
    return seconds


def checkpoint_file(state_dir: str) -> str:
    names = sorted(n for n in os.listdir(os.path.join(state_dir, "checkpoints"))
                   if n.endswith(".ckpt"))
    return os.path.join(state_dir, "checkpoints", names[-1])


def durable_service(dev, ctx: dict, root: str, card: str) -> dict:
    """Steps 1-3 of phase 8: checkpoint, enrol, forced checkpoint, enrol,
    "crash". Returns the crashed service's state and the numbers."""
    stack, gallery, frames = ctx["stack"], ctx["ivf_gallery"], ctx["frames"]
    if not gallery.quantizer.ready or gallery.capacity != GALLERY_ROWS:
        raise AssertionError("durability: phase 6's gallery is not the built 2^20-row one")
    pipeline = RecognitionPipeline(stack.detector, stack.embed_net, gallery,
                                   face_size=embedder_mod.SERVING_FACE_SIZE,
                                   fused_embedder=True, device=dev)
    names = [f"planted_{i}" for i in range(ctx["n_plant"])]
    # the thresholds never fire: the phase takes its checkpoints itself
    state = StateLifecycle(root, keep_checkpoints=2, checkpoint_wal_rows=1 << 30,
                           checkpoint_every_s=1e9)
    wal_s = timed_wal_appends(state)
    conn = FakeConnector()
    service = RecognizerService(pipeline, conn, batch_size=BATCH, frame_shape=FRAME,
                                transfer_dtype=np.uint8, flush_timeout=0.05,
                                subject_names=names, state_store=state)
    t0 = time.perf_counter()
    if not state.checkpoint_now(wait=True):
        raise AssertionError("durability: the first checkpoint failed")
    first = dict(state.last_checkpoint_s, seconds=time.perf_counter() - t0)
    subjects = [f"durable_{i}" for i in range(DUR_SUBJECTS_CHECKPOINTED + DUR_SUBJECTS_WAL)]
    service.start(warmup=True)
    try:
        for i, subject in enumerate(subjects[:DUR_SUBJECTS_CHECKPOINTED]):
            # frames past the first batch: their faces are not planted rows
            enrol_through_control(conn, frames[BATCH + i], subject)
        if gallery.capacity != 2 * GALLERY_ROWS:
            raise AssertionError(f"durability: the gallery did not grow ({gallery.capacity})")
        with RssPeak() as rss:
            t0 = time.perf_counter()
            if not state.checkpoint_now(wait=True):
                raise AssertionError("durability: the forced checkpoint failed")
            ckpt_seconds = time.perf_counter() - t0
        ckpt_path = checkpoint_file(root)
        ckpt = dict(state.last_checkpoint_s, seconds=ckpt_seconds,
                    file_bytes=os.path.getsize(ckpt_path), **rss.numbers())
        if (not os.path.exists(state.sidecar_path)
                or ckpt["payload_bytes"] < gallery.capacity * DIM * 4):
            raise AssertionError(f"durability: checkpoint {ckpt} without its sidecar or rows")
        for i, subject in enumerate(subjects[DUR_SUBJECTS_CHECKPOINTED:]):
            enrol_through_control(conn, frames[BATCH + DUR_SUBJECTS_CHECKPOINTED + i], subject)
        if not service.drain(timeout=300):
            raise AssertionError("durability: the service did not drain")
    finally:
        service.stop()
    state.wal.close()  # the "crash": no graceful shutdown, no final checkpoint
    log(f"durability: first checkpoint ({GALLERY_ROWS} rows) {first}; forced checkpoint of "
        f"{gallery.capacity} rows: {ckpt} ({card})")
    return dict(gallery=gallery, names=list(service.subject_names), ckpt_path=ckpt_path,
                first=first, ckpt=ckpt, wal_s=wal_s, subjects=subjects,
                ledger=service.ledger())


def recover_and_compare(dev, seed: int, ctx: dict, root: str, crashed: dict):
    """Steps 4-5: recover into a fresh gallery and quantizer on the card;
    hold the mirrors, names and matches to the crashed service's."""
    gallery = crashed["gallery"]
    g2 = ShardedGallery(8, DIM, store_dtype=torch.bfloat16, device=dev)
    g2.attach_quantizer(CoarseQuantizer(nlist=CoarseQuantizer.default_nlist(GALLERY_ROWS),
                                        nprobe=IVF_NPROBE, seed=seed, auto_nlist=True,
                                        metrics=Metrics()), mode="auto")
    names2 = []
    state2 = StateLifecycle(root, keep_checkpoints=2)
    with RssPeak() as rss:
        t0 = time.perf_counter()
        report = state2.recover(g2, names2)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    rec = dict(state2.last_recovery_s, seconds=seconds, **rss.numbers())
    if (report["recovered_checkpoint"] != crashed["ckpt_path"]
            or report["replayed_records"] != DUR_SUBJECTS_WAL
            or report.get("quantizer_sidecar") != "loaded"):
        raise AssertionError(f"durability: recovery report {report}")
    for what, a, b in zip(("embeddings", "labels", "valid", "size"), gallery.snapshot(),
                          g2.snapshot()):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"durability: recovered {what} differ")
    if g2.capacity != gallery.capacity or names2 != crashed["names"]:
        raise AssertionError(f"durability: capacity {g2.capacity} / names {names2[-8:]} differ")
    # queries: perturbed gallery rows and the enrolled subjects' own rows
    n_enrolled = len(crashed["subjects"]) * DUR_ENROL_COUNT
    size = g2.size
    enrolled = torch.from_numpy(g2.snapshot()[0][size - n_enrolled:size]).to(dev)
    q = torch.cat([ctx["queries"][:DUR_Q - n_enrolled], enrolled])
    streaming_match_topk.launches = 0
    ivf_match_topk.calls = 0
    for mode in ("exact", "auto"):
        for g in (gallery, g2):
            g.match_mode = mode
        for k in DUR_KS:
            la, sa, ia = gallery.match(q, k=k)
            lb, sb, ib = g2.match(q, k=k)
            if not (torch.equal(ia, ib) and torch.equal(sa, sb) and torch.equal(la, lb)):
                raise AssertionError(f"durability: {mode} match k={k} differs after recovery "
                                     f"({(ia != ib).sum().item()} indices)")
    launches = dict(streaming_match=streaming_match_topk.launches,
                    ivf_match_calls=ivf_match_topk.calls)
    if launches["ivf_match_calls"] != 2 * len(DUR_KS) or (
            dev.type == "cuda" and launches["streaming_match"] < 4 * len(DUR_KS)):
        raise AssertionError(f"durability: the matches did not take both paths: {launches}")
    top = ia[-n_enrolled:, 0].cpu().numpy()
    if not (top >= size - n_enrolled).all():
        raise AssertionError("durability: an enrolled row is not its own top-1 after recovery")
    log(f"durability: recovered {report['recovered_checkpoint']} + {report['replayed_records']} "
        f"WAL records, sidecar {report.get('quantizer_sidecar')}: {rec}; mirrors, capacity "
        f"{g2.capacity}, size {size} and {len(names2)} names equal; gallery.match Q={q.shape[0]} "
        f"k={list(DUR_KS)} equal bit for bit, exact and two-stage; launches {launches}")
    return g2, names2, state2, report, rec, launches


def supervised_serve(dev, ctx: dict, g2, names2, state2) -> dict:
    """Step 6: the frames again through the recovered gallery under the
    supervisor, in three waves. Wave 1: a result
    subscriber raises once, so the readback worker dies. Wave 2: the
    state tick raises once with the wave's batch in hand, so the dispatch
    loop dies and settles that batch as crashed drops (the whole wave
    unless a slow host split it). Wave 3 is served with the launch counts
    reset."""
    stack, frames, n_plant = ctx["stack"], ctx["frames"], ctx["n_plant"]
    if len(frames) < 3 * BATCH:
        raise AssertionError(f"durability: {len(frames)} frames, fewer than three batches")
    pipeline = RecognitionPipeline(stack.detector, stack.embed_net, g2,
                                   face_size=embedder_mod.SERVING_FACE_SIZE,
                                   fused_embedder=True, device=dev)
    conn = FakeConnector()
    raised = []

    def subscriber(_topic, message):
        # the last frame of wave 1: its result is recorded, then the
        # readback worker dies
        if message["meta"]["i"] == BATCH - 1 and "readback" not in raised:
            raised.append("readback")
            raise RuntimeError("injected: a result subscriber fails once")

    conn.subscribe(RESULT_TOPIC, subscriber)
    service = RecognizerService(pipeline, conn, batch_size=BATCH, frame_shape=FRAME,
                                transfer_dtype=np.uint8, flush_timeout=0.05,
                                subject_names=names2, state_store=state2)
    get_batch, tick = service.batcher.get_batch, state2.tick
    dropped = []

    def failing_tick():
        state2.tick = tick
        raised.append("dispatch")
        raise RuntimeError("injected: the state tick fails once")

    def get_batch_arming(*args, **kwargs):
        # arms the failing tick once wave 2's batch is in the loop's hands
        batch = get_batch(*args, **kwargs)
        if batch is not None and batch.metas[0]["i"] == BATCH:
            dropped.extend(m["i"] for m in batch.metas[:batch.count])
            state2.tick = failing_tick
        return batch

    service.batcher.get_batch = get_batch_arming
    sup = ServiceSupervisor(service, state=state2, poll_interval_s=0.05)
    sup.start(warmup=True)
    try:
        for wave, (lo, hi) in enumerate(((0, BATCH), (BATCH, 2 * BATCH)), 1):
            for i in range(lo, hi):
                conn.inject(FRAME_TOPIC, {**encode_frame(frames[i]), "meta": {"i": i}})
            wait_for(lambda: service.metrics.counter(SUPERVISOR_RESTARTS) >= wave, 300,
                     f"the supervisor's restart {wave}")
            if not service.drain(timeout=300):
                raise AssertionError(f"durability: wave {wave} did not drain")
        streaming_match_topk.launches = 0
        fused_sep_block.launches = 0
        for i in range(2 * BATCH, len(frames)):
            conn.inject(FRAME_TOPIC, {**encode_frame(frames[i]), "meta": {"i": i}})
        if not service.drain(timeout=300):
            raise AssertionError("durability: wave 3 did not drain")
        launches = {"streaming_match": streaming_match_topk.launches,
                    "sepblock": fused_sep_block.launches}
    finally:
        sup.stop()
    g2.quantizer.rebuild_now(wait=True, skip_if_ready=True)  # the restore's retrain
    results = conn.messages(RESULT_TOPIC)
    served = [i for i in range(len(frames)) if i not in dropped]
    if not dropped or sorted(r["meta"]["i"] for r in results) != served:
        raise AssertionError(f"durability: {len(results)} results for the {len(served)} "
                             f"frames outside the dropped batch {dropped}")
    ledger = service.ledger()
    # the batch the dispatch loop held, and wave 1's frame whose
    # subscriber raised
    if (ledger["drops_by_reason"] != {FRAMES_DROPPED_CRASHED: len(dropped) + 1}
            or ledger["in_system"] != 0 or ledger["admitted"] != len(frames)):
        raise AssertionError(f"durability: ledger after the crashes {ledger}")
    crashes = service.metrics.counter(LOOP_CRASHES)
    if raised != ["readback", "dispatch"] or sup.restarts != 2 or crashes != 2 or (
            dev.type == "cuda" and min(launches.values()) < 1):  # the CPU launches none
        raise AssertionError(f"durability: crashes {raised} / {crashes}, restarts "
                             f"{sup.restarts}, launches after them {launches}")
    min_sim = check_planted(results, n_plant)
    log(f"durability: supervised serving on the recovered gallery: {len(results)} results for "
        f"{len(frames)} frames, 2 loop crashes (readback worker, dispatch loop), 2 restarts, "
        f"launches after them {launches}; planted faces found (min sim {min_sim:.5f}); "
        f"ledger {ledger} (the batch the dispatch loop held, {len(dropped)} frames, and the "
        "raising subscriber's frame are crashed drops)")
    return dict(restarts=sup.restarts, launches_after_restart=launches, min_planted_sim=min_sim)


class CliProcess:
    """The CLI in jsonl mode in a subprocess (``python -m``) with
    ``--state-dir``; stdout messages and stderr lines are collected."""

    def __init__(self, paths: dict, dev, state_dir: str):
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
             *cli_args(paths, "jsonl", dev), "--state-dir", state_dir, "--flush-ms", "5",
             "--capacity", str(CLI_STATE_CAPACITY)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self.out, self.err = [], []
        self.first_result_s = None
        self._readers = [threading.Thread(target=self._read_out, daemon=True),
                         threading.Thread(target=lambda: self.err.extend(self.proc.stderr),
                                          daemon=True)]
        for r in self._readers:
            r.start()

    def _read_out(self):
        for line in self.proc.stdout:
            msg = json.loads(line)
            if msg["topic"] == RESULT_TOPIC and self.first_result_s is None:
                self.first_result_s = time.perf_counter() - self.t0
            self.out.append(msg)

    def send(self, topic, data):
        self.proc.stdin.write(json.dumps({"topic": topic, "data": data}) + "\n")
        self.proc.stdin.flush()

    def results(self):
        return [m["data"] for m in self.out if m["topic"] == RESULT_TOPIC]

    def named(self, seqs) -> bool:
        got = {r["meta"]["seq"]: r for r in self.results()}
        return all(s in got and CLI_NEW_NAME in {f["name"] for f in got[s]["faces"]}
                   for s in seqs)

    def finish(self, timeout: float = 300) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        for r in self._readers:
            r.join(timeout=10)
        return rc

    def stderr(self) -> str:
        return "".join(self.err)


def cli_restarts(dev, ctx: dict, root: str) -> dict:
    """Step 7: the CLI with ``--state-dir``: SIGKILL after ``enrolled``, a
    second writer refused, a restart named through WAL replay, SIGTERM
    clean, a third start from the final checkpoint."""
    frames = ctx["cli_frames"]
    state_dir = os.path.join(root, "cli")
    starts = []

    def start(tag):
        metrics = os.path.join(root, f"cli_{tag}.jsonl")
        return CliProcess(dict(ctx["cli_paths"], metrics=metrics), dev, state_dir), metrics

    def startup(proc, metrics, tag):
        records = {r["event"]: r for r in metrics_records(metrics)}
        starts.append(dict(start=tag, first_result_s=proc.first_result_s,
                           checkpoint_load_s=records["startup"]["checkpoint_load_s"],
                           gallery_embed_s=records["startup"]["gallery_embed_s"],
                           recovery_s=records["recovery"]["seconds"],
                           recovery_stages=records["recovery"]["stages"],
                           replayed_records=records["recovery"]["replayed_records"]))

    def scene(proc, seqs):
        for s in seqs:
            proc.send(FRAME_TOPIC, {**encode_frame(frames[0]), "meta": {"seq": s}})

    p1, m1 = start("first")
    try:
        scene(p1, range(CLI_JSONL_FRAMES))
        p1.send(CONTROL_TOPIC, {"cmd": "enroll", "subject": CLI_NEW_NAME,
                                "count": CLI_ENROL_COUNT})
        seq = CLI_JSONL_FRAMES
        deadline = time.monotonic() + 300
        while not any(m["topic"] == STATUS_TOPIC and m["data"]["status"] == "enrolled"
                      for m in p1.out):
            if time.monotonic() > deadline or p1.proc.poll() is not None:
                raise AssertionError("cli: no 'enrolled' before the kill:\n" + p1.stderr()[-3000:])
            scene(p1, [seq])
            seq += 1
            time.sleep(0.2)
        try:
            recognize_app.main(cli_args(ctx["cli_paths"], "jsonl", dev)
                               + ["--state-dir", state_dir])
            raise AssertionError("cli: a second writer started on a held state dir")
        except SystemExit as exc:
            if "writer lease" not in str(exc):
                raise AssertionError(f"cli: second writer: {exc}")
            second_writer = str(exc)
        p1.proc.send_signal(signal.SIGKILL)
    finally:
        p1.finish(60)
    startup(p1, m1, "first")

    p2, m2 = start("after_sigkill")
    try:
        scene(p2, range(CLI_JSONL_FRAMES))
        wait_for(lambda: p2.named(range(CLI_JSONL_FRAMES)) or p2.proc.poll() is not None, 300,
                 "the restarted CLI's results")
        if not p2.named(range(CLI_JSONL_FRAMES)):
            raise AssertionError("cli: after SIGKILL the subject is not named:\n"
                                 + p2.stderr()[-3000:])
        p2.proc.send_signal(signal.SIGTERM)
        rc2 = p2.finish(300)
    finally:
        p2.finish(60)
    err2 = p2.stderr()
    if rc2 != 0 or "shutdown: clean" not in err2 or "final checkpoint: written" not in err2:
        raise AssertionError(f"cli: SIGTERM rc {rc2}:\n{err2[-3000:]}")
    startup(p2, m2, "after_sigkill")

    p3, m3 = start("after_sigterm")
    try:
        scene(p3, range(CLI_JSONL_FRAMES))
        wait_for(lambda: len(p3.results()) >= CLI_JSONL_FRAMES or p3.proc.poll() is not None,
                 300, "the third start's results")
        p3.proc.stdin.close()
        rc3 = p3.finish(300)
    finally:
        p3.finish(60)
    startup(p3, m3, "after_sigterm")
    if rc3 != 0 or not p3.named(range(CLI_JSONL_FRAMES)):
        raise AssertionError(f"cli: third start rc {rc3}, named {p3.named(range(8))}:\n"
                             + p3.stderr()[-3000:])
    replayed = [s["replayed_records"] for s in starts]
    if replayed != [0, 1, 0]:
        raise AssertionError(f"cli: replayed records by start {replayed}")
    log(f"durability cli: SIGKILL after 'enrolled', the restart named {CLI_NEW_NAME!r} by WAL "
        f"replay, SIGTERM exited 0 clean, the third start recovered its checkpoint; second "
        f"writer refused: {second_writer}; startups {starts}")
    return dict(starts=starts, second_writer_refused=True)


def durability_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 8 (module docstring); returns the ``{"durability": ...}``
    numbers."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "state_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    steps = {}
    t = time.perf_counter()
    crashed = durable_service(dev, ctx, os.path.join(root, "service"), card)
    steps["service_s"], t = time.perf_counter() - t, time.perf_counter()
    g2, names2, state2, _report, rec, match_launches = recover_and_compare(
        dev, seed, ctx, os.path.join(root, "service"), crashed)
    del crashed["gallery"], ctx["ivf_gallery"]
    steps["recover_compare_s"], t = time.perf_counter() - t, time.perf_counter()
    supervised = supervised_serve(dev, ctx, g2, names2, state2)
    state2.close()
    del g2
    torch.cuda.empty_cache()
    steps["supervised_s"], t = time.perf_counter() - t, time.perf_counter()
    cli = cli_restarts(dev, ctx, root)
    steps["cli_s"] = time.perf_counter() - t
    wal_ms = np.asarray(crashed["wal_s"]) * 1e3
    return dict(card=card, first_checkpoint=crashed["first"], checkpoint=crashed["ckpt"],
                recovery=rec, wal_appends=len(wal_ms), wal_append_p50_ms=float(
                    np.median(wal_ms)), wal_append_max_ms=float(wal_ms.max()),
                match_launches=match_launches, supervised=supervised, cli=cli,
                service_ledger=crashed["ledger"], phase_steps=steps)


def async_grow_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 9 (module docstring); returns the ``{"async_grow": ...}``
    numbers."""
    rows, labels, frames = ctx["rows"], ctx["labels"], ctx["frames"]
    n0 = GALLERY_ROWS - GROW_HEADROOM
    gallery = ShardedGallery(GALLERY_ROWS, DIM, store_dtype=torch.bfloat16, device=dev,
                             async_grow=True)
    gallery.add(rows[:n0], labels[:n0])
    stack = ctx["stack"]
    pipe = RecognitionPipeline(stack.detector, stack.embed_net, gallery,
                               face_size=embedder_mod.SERVING_FACE_SIZE,
                               fused_embedder=True, device=dev)
    pipe.prewarm_batch_shapes([BATCH], FRAME, np.uint8)
    # the subject: the faces of one batch (its own embeddings on the card)
    subject = frames[BATCH:2 * BATCH]
    _b, _s, valid, emb = pipe.embed_frames(subject)
    faces = emb[valid.reshape(-1)].float().cpu().numpy()
    label = int(labels.max()) + 1
    if len(faces) <= GROW_HEADROOM:
        raise AssertionError(f"only {len(faces)} faces: the enrolment would not overflow")

    steps, served, stop = [], [0], threading.Event()
    errors = []

    def serve_loop():
        i = 0
        try:
            while not stop.is_set():
                batch = frames[(i % 4) * BATCH:(i % 4 + 1) * BATCH]
                t0 = time.perf_counter()
                out = pipe.recognize_batch_packed(batch).cpu()
                steps.append((t0, (time.perf_counter() - t0) * 1e3,
                              pipe.gallery.data.capacity, pipe.last_dispatch_info["cache_hit"]))
                if out.shape[0] != BATCH:
                    raise AssertionError(f"a step returned {out.shape[0]} results")
                served[0] += out.shape[0]
                i += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    zero_counters()
    worker = threading.Thread(target=serve_loop, name="grow-phase-serving", daemon=True)
    worker.start()
    try:
        wait_for(lambda: errors or len(steps) >= GROW_STEPS, 120, "steps before the grow")
        t_add = time.perf_counter()
        gallery.add(faces, np.full(len(faces), label, np.int32))
        add_ms = (time.perf_counter() - t_add) * 1e3
        staged = gallery.pending_rows
        landed = gallery.wait_ready(timeout=300)
        ready_s = time.perf_counter() - t_add
        t_landed = time.perf_counter()
        n_before_land = len(steps)
        wait_for(lambda: errors or len(steps) >= n_before_land + GROW_STEPS, 120,
                 "steps after the grow")
    finally:
        stop.set()
        worker.join(timeout=120)
    if worker.is_alive() or errors:
        raise AssertionError(f"serving during the grow failed: {errors}")
    launches = read_launches()
    info = dict(gallery.last_grow_info)
    if not landed or gallery.pending_rows or "error" in info:
        raise AssertionError(f"the grow did not land: pending {gallery.pending_rows}, {info}")
    if gallery.data.capacity != 2 * GALLERY_ROWS:
        raise AssertionError(f"capacity {gallery.data.capacity} after the grow")
    if served[0] != len(steps) * BATCH:
        raise AssertionError(f"{served[0]} results for {len(steps)} steps of {BATCH} frames")
    before = [ms for t, ms, _c, _h in steps if t < t_add]
    during = [ms for t, ms, _c, _h in steps if t_add <= t < t_landed]
    after = [ms for t, ms, cap, _h in steps if t >= t_landed and cap == 2 * GALLERY_ROWS]
    misses = sum(1 for _t, _ms, cap, hit in steps if cap == 2 * GALLERY_ROWS and not hit)
    # the subject is named at the new tier, through kernels A and B
    zero_counters()
    out = unpack_result(pipe.recognize_batch_packed(subject).cpu().numpy(), 1)
    at_tier = read_launches()
    named = out.labels[..., 0][out.valid]
    if not (named == label).all() or out.similarities[..., 0][out.valid].min() < 0.99:
        raise AssertionError("the enrolled subject's faces are not named after the grow")
    if dev.type == "cuda" and at_tier != {"streaming_match": 1, "sepblock": 6, "nms": 1}:
        raise AssertionError(f"launches at the 2^21 tier: {at_tier}")
    # an add of 2 rows within the tier (in place) against a whole-gallery
    # upload at the same tier (what every add cost before the in-place path)
    rng = np.random.default_rng(seed + 9)
    add2 = []
    for _ in range(GROW_ADDS):
        extra = _unit_rows(rng.standard_normal((2, DIM), dtype=np.float32))
        t = time.perf_counter()
        gallery.add(extra, np.full(2, label + 1, np.int32))
        add2.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    with gallery._write_lock:
        gallery._install(gallery.size)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t) * 1e3
    result = dict(
        card=card, rows_before=n0, enrolled_rows=len(faces), staged_rows=staged,
        add_ms=add_ms, add_to_ready_s=ready_s, grow_info=info, steps=len(steps),
        step_ms_before=float(np.median(before)),
        step_ms_during=dict(n=len(during), median=float(np.median(during)) if during else None,
                            max=max(during, default=None)),
        step_ms_after=float(np.median(after)), step_ms_max=max(ms for _t, ms, _c, _h in steps),
        misses_at_new_tier=misses, captures=pipe.captures, recaptures=pipe.recaptures,
        launches_while_serving=launches, launches_at_new_tier=at_tier,
        add2_in_place_ms=add2, whole_gallery_upload_ms=whole_ms)
    log(f"async grow under load ({card}): {len(faces)} rows enrolled into {n0} rows at "
        f"capacity {GALLERY_ROWS}; add returned in {add_ms:.2f} ms with {staged} rows staged, "
        f"wait_ready after {ready_s:.3f} s ({info}); steps {len(steps)}: median "
        f"{result['step_ms_before']:.3f} ms before, {result['step_ms_during']} during, "
        f"median {result['step_ms_after']:.3f} ms after; cache misses at the new tier "
        f"{misses}; launches {launches}; the subject named at 2^21 through {at_tier}")
    log(f"add of 2 rows within the 2^21 tier: {[round(v, 3) for v in add2]} ms in place; "
        f"a whole-gallery upload at the same tier {whole_ms:.1f} ms")
    drop_stack(pipe)
    return result


# ---------------------------------------------------------------------------
# Phase 10: overload control and observability of the CLI on the card


def _prefix_ms(fn, cuda: bool) -> float:
    """Device ms of one ``fn`` (a CUDA graph of back-to-back calls), or the
    host-clock mean on the CPU (a rehearsal)."""
    if cuda:
        return graph_ms(fn, iters=OVL_QUOTE_ITERS)
    fn()
    t = time.perf_counter()
    for _ in range(3):
        fn()
    return (time.perf_counter() - t) / 3 * 1e3


def stage_quotes(dev, card: str, stack, frames: np.ndarray) -> dict:
    """Per-bucket stage ms of the serving step from ablated prefixes:
    detect (the detector and its decode), + crop (crop, resize, normalize),
    + embed (the fused embedder), + match (kernel A and the pack), each
    prefix timed as a CUDA graph of back-to-back calls; a stage is its
    prefix less the one before. Written to ``expo.DEFAULT_QUOTES_PATH``
    in the layout ``expo.load_stage_quotes`` reads."""
    det, net, gallery = stack.detector, stack.embed_net, stack.gallery
    data = gallery.data
    match = gallery.match_fn(stack.top_k, data.capacity, use_ivf=False)
    face = stack.face_size
    per_batch, prefix_ms = {}, {}
    for bucket in OVL_QUOTE_BUCKETS:
        x = torch.as_tensor(frames[:bucket]).to(dev)

        def run(n, x=x):
            with torch.no_grad():
                f = x.to(torch.float32)
                boxes, scores, valid = detector_mod.decode_detections(
                    det.net(f), det.max_faces, det.score_threshold, det.iou_threshold)
                if n == 1:
                    return boxes
                crops = image_ops.batched_crop_resize(f, boxes, face)
                faces = embedder_mod.normalize_faces(crops.reshape(-1, *face), face)
                if n == 2:
                    return faces
                emb = (embedder_mod.fused_forward(net, faces) if stack.fused_embedder
                       else net(faces))
                if n == 3:
                    return emb
                labels, sims, _ = match(emb, data.embeddings, data.valid, data.labels)
                b, k = valid.shape
                return pack_result(RecognitionResult(
                    boxes=boxes, det_scores=scores, valid=valid,
                    labels=labels.reshape(b, k, -1), similarities=sims.reshape(b, k, -1)))

        ms = [0.0] + [_prefix_ms(lambda n=n: run(n), dev.type == "cuda") for n in (1, 2, 3, 4)]
        prefix_ms[bucket] = ms[1:]
        per_batch[str(bucket)] = {stage: {"ms_per_batch": max(0.0, ms[i + 1] - ms[i])}
                                  for i, stage in enumerate(expo_mod.DEVICE_STAGES)}
    table = {"card": card, "gallery_rows": int(data.capacity),
             "method": "ablated prefixes of the serving step (uint8 frames 256x256, fused "
                       "embedder, exact match), each a CUDA graph of back-to-back calls; "
                       "a stage is its prefix less the previous one",
             "script": "chip_smoke.py phase 10",
             "stage_attribution": {"per_batch": per_batch}}
    serialization.atomic_write_json(expo_mod.DEFAULT_QUOTES_PATH, table)
    log(f"stage quotes ({card}): prefix ms {prefix_ms}; written to "
        f"{os.path.relpath(expo_mod.DEFAULT_QUOTES_PATH)}")
    return dict(prefix_ms=prefix_ms, per_batch=per_batch)


def _frame_line(b64: str, meta: dict, priority: str) -> bytes:
    """One pre-encoded JSONL frame message of the socket transport."""
    return (f'{{"topic": "{FRAME_TOPIC}", "data": {{"__frame__": "{b64}", "shape": '
            f'[{FRAME[0]}, {FRAME[1]}], "dtype": "uint8", "meta": {json.dumps(meta)}, '
            f'"priority": "{priority}"}}}}\n').encode()


class SocketCli:
    """The CLI with ``--source socket --port 0`` in a subprocess and one raw
    TCP client: pre-encoded frame lines go out, result and status lines
    come back (each result with its host-clock arrival)."""

    def __init__(self, paths: dict, dev, args: list, metrics_path: str):
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        self.metrics_path = metrics_path
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
             *cli_args(dict(paths, metrics=metrics_path), "socket", dev), "--port", "0",
             *args], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=env)
        self.err = []
        self.results, self.statuses = [], []
        self.answered = {}  # fid -> arrival (perf_counter)
        self._lock = threading.Lock()
        threading.Thread(target=lambda: self.err.extend(self.proc.stderr), daemon=True).start()
        self.port = int(self.stderr_value("serving on ", 300).rsplit(":", 1)[1])
        self.expo = (int(self.stderr_value("expo endpoint: ", 10).rstrip("/").rsplit(":", 1)[1])
                     if "--expo-port" in args else None)
        self.sock = socket.create_connection(("127.0.0.1", self.port), timeout=30)
        self.sock.settimeout(None)
        #: more producer connections (cameras): each gets every result too
        #: (the transport broadcasts), which their readers discard
        self.extra = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def connect_more(self, n: int) -> None:
        for _ in range(n):
            sock = socket.create_connection(("127.0.0.1", self.port), timeout=30)
            sock.settimeout(None)
            threading.Thread(target=lambda s=sock: [None for _ in s.makefile("rb")],
                             daemon=True).start()
            self.extra.append(sock)

    def stderr_value(self, prefix: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in list(self.err):
                if line.startswith(prefix):
                    return line[len(prefix):].strip()
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"the CLI printed no {prefix!r} line: {''.join(self.err[-30:])}")

    def _read(self) -> None:
        for line in self.sock.makefile("r", encoding="utf-8"):
            msg = json.loads(line)
            now = time.perf_counter()
            with self._lock:
                if msg["topic"] == RESULT_TOPIC:
                    self.results.append(msg["data"])
                    self.answered[msg["data"]["meta"]["_fid"]] = now
                elif msg["topic"] == STATUS_TOPIC:
                    self.statuses.append(msg["data"])

    def send(self, line: bytes, conn: int = 0) -> None:
        (self.extra[conn - 1] if conn else self.sock).sendall(line)

    def n_answered(self) -> int:
        with self._lock:
            return len(self.answered)

    def get(self, path: str):
        """(HTTP status, body) of one GET on the exposition."""
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.expo}{path}",
                                        timeout=10) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read().decode()

    def get_json(self, path: str):
        return json.loads(self.get(path)[1])

    def stop(self, timeout: float = 120) -> dict:
        """SIGTERM; returns the ``shutdown`` record of ``--metrics-jsonl``."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            for sock in (self.sock, *self.extra):
                sock.close()
        if rc != 0:
            raise AssertionError(f"the CLI exited {rc}: {''.join(self.err[-40:])}")
        return {r["event"]: r for r in metrics_records(self.metrics_path)}["shutdown"]


def paced(cli: SocketCli, lines: list, rate: float) -> float:
    """Send ``lines`` at ``rate`` a second (unpaced when 0) from a producer
    thread; returns the sending seconds."""
    t = {}

    def produce():
        t0 = time.perf_counter()
        for i, line in enumerate(lines):
            if rate:
                delay = t0 + i / rate - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            cli.send(line)
        t["s"] = time.perf_counter() - t0

    worker = threading.Thread(target=produce, name="phase10-producer", daemon=True)
    worker.start()
    worker.join(timeout=600)
    return t["s"]


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else \
        float("nan")


def span_records(path: str) -> list:
    return list(RotatingJournal(path).records())


def span_split(spans: list, first_frame: int = 0) -> dict:
    """Stage times (ms) from a span journal, for frame traces from the
    ``first_frame``-th arrival on and their batches: per-frame queue wait
    and e2e (enqueue to settle), per-batch dispatch, ready wait, publish;
    and per-frame e2e by priority."""
    frames = {}
    for s in spans:
        if s.get("topic") == FRAME_TOPIC and s["trace"] > 2 * first_frame:
            frames.setdefault(s["trace"], {})[s["stage"]] = s
    batches = {f["queue_wait"]["batch"] for f in frames.values() if "queue_wait" in f}
    stage = {k: [] for k in ("dispatch", "ready_wait", "publish")}
    for s in spans:
        if s.get("topic") == "_batch" and s["trace"] in batches and s["stage"] in stage:
            stage[s["stage"]].append(s["dur"] * 1e3)
    qw, e2e, by_pri = [], [], {0: [], 1: []}
    for f in frames.values():
        if "queue_wait" in f:
            qw.append(f["queue_wait"]["dur"] * 1e3)
        settle = f.get("settle")
        if "queue_wait" in f and settle and settle["outcome"] == "completed":
            ms = (settle["t0"] - f["queue_wait"]["t0"]) * 1e3
            e2e.append(ms)
            by_pri[f["receive"].get("priority", 0)].append(ms)
    out = {k: {"p50": _pct(v, 50), "p99": _pct(v, 99), "n": len(v)}
           for k, v in (("queue_wait", qw), *stage.items(), ("e2e", e2e))}
    out["e2e_by_priority"] = {("interactive" if p == 0 else "bulk"):
                              {"p50": _pct(v, 50), "p99": _pct(v, 99), "n": len(v)}
                              for p, v in by_pri.items()}
    return out


def _serving_delta(rec: dict) -> dict:
    """Kernel launches and captures of one CLI run after its warmup."""
    return {"launches": {k: v - rec["warm"]["launches"][k] for k, v in rec["launches"].items()},
            "captures_after_warmup": rec["captures"] - rec["warm"]["captures"],
            "recaptures": rec["recaptures"]}


def _check_serving(dev, tag: str, rec: dict) -> dict:
    delta = _serving_delta(rec)
    if delta["captures_after_warmup"] or rec["summary"].get("recompiles_post_warmup"):
        raise AssertionError(f"{tag}: a step was captured after warmup: {delta}")
    if dev.type == "cuda" and min(delta["launches"].values()) < 1:
        raise AssertionError(f"{tag}: a kernel did not launch: {delta['launches']}")
    return delta


def _close_ledger(tag: str, ledger: dict) -> None:
    done = ledger["completed"] + ledger["completed_empty"] + ledger["completed_cached"]
    if ledger["in_system"] != 0 or ledger["admitted"] != done + sum(
            ledger["drops_by_reason"].values()):
        raise AssertionError(f"{tag}: the ledger does not close: {ledger}")


def _burst_rate(cli: SocketCli, lines: list, fids: list, timeout: float = 120,
                before: int = 0) -> float:
    """Answered frames a second over an unpaced burst of ``lines``, sent
    after ``before`` frames were answered."""
    t0 = time.perf_counter()
    paced(cli, lines, 0)
    wait_for(lambda: cli.n_answered() >= before + len(lines), timeout, "the burst's answers")
    with cli._lock:
        last = max(cli.answered[f] for f in fids)
    return len(lines) / (last - t0)


def steady_run(dev, paths: dict, root: str, tag: str, b64: list, rate_hint: float,
               sample: float, profile: bool = False) -> dict:
    """Phase 10 (a): a burst of OVL_BURST frames (R), then OVL_STEADY
    interactive frames at OVL_STEADY_SHARE x R (of ``rate_hint`` when
    given), with the exposition and the SLO monitor; spans at ``sample``,
    streamed to a JSONL, and the profile when ``profile``. The profile
    covers the first burst, whose R its start and export stall: R then
    comes from a second burst after the trace is written."""
    spans_path = os.path.join(root, f"{tag}_spans.jsonl")
    args = ["--trace-sample", str(sample), "--flight-dir", os.path.join(root, f"{tag}_flight"),
            "--expo-port", "0", "--slo", "--trace-jsonl", spans_path]
    if profile:
        args += ["--profile-dir", os.path.join(root, f"{tag}_profile"),
                 "--profile-batches", str(OVL_PROFILE_BATCHES)]
    cli = SocketCli(paths, dev, args, os.path.join(root, f"{tag}_metrics.jsonl"))
    try:
        burst = [_frame_line(b64[i % len(b64)], {"_fid": i}, "interactive")
                 for i in range(OVL_BURST)]
        rate = _burst_rate(cli, burst, list(range(OVL_BURST)))
        n0 = OVL_BURST
        if profile:
            # the profile covers the burst's first batches; its start and
            # its export stall the process, so the steady run waits for it
            cli.stderr_value("profile trace written to ", 300)
            again = [_frame_line(b64[i % len(b64)], {"_fid": n0 + i}, "interactive")
                     for i in range(OVL_BURST)]
            rate = _burst_rate(cli, again, list(range(n0, n0 + OVL_BURST)), before=n0)
            n0 += OVL_BURST
        steady_rate = OVL_STEADY_SHARE * (rate_hint or rate)
        steady = [_frame_line(b64[i % len(b64)], {"_fid": n0 + i}, "interactive")
                  for i in range(OVL_STEADY)]
        t_send = paced(cli, steady, steady_rate)
        wait_for(lambda: cli.n_answered() >= n0 + OVL_STEADY, 120, "the steady run's answers")
        attribution = cli.get_json("/attribution")
        status, health_body = cli.get("/health")
        prom = cli.get("/prom")[1]
        problems = lint_prometheus_text(prom)
    finally:
        rec = cli.stop()
    _close_ledger(tag, rec["ledger"])
    if rec["ledger"]["completed"] != n0 + OVL_STEADY:
        raise AssertionError(f"{tag}: {rec['ledger']} for {n0 + OVL_STEADY} frames")
    if problems:
        raise AssertionError(f"{tag}: /prom has {len(problems)} problems: {problems[:5]}")
    delta = _check_serving(dev, tag, rec)
    out = dict(rate_fps=rate, steady_fps=steady_rate, steady_send_s=t_send,
               summary_p50_ms={k: rec["summary"].get(f"{k}_p50_ms") for k in (
                   "queue_wait", "dispatch", "ready_wait", "publish", "e2e_latency")},
               health=json.loads(health_body).get("state"), health_http=status,
               attribution={k: v for k, v in attribution.items()
                            if k == "device_busy_fraction" or k.startswith("stage_share_b32")},
               prom_problems=len(problems), prom_bytes=len(prom), serving=delta)
    if sample:
        spans = span_records(spans_path)
        out["split"] = span_split(spans, first_frame=n0)
        t_lo = min(s["t0"] for s in spans if s.get("topic") == FRAME_TOPIC
                   and s["trace"] > 2 * n0)
        t_hi = max(s["t0"] + s["dur"] for s in spans if s.get("topic") == "_batch")
        out["busy_steady"] = tracing.device_busy_fraction(
            [s for s in spans if s.get("topic") == "_batch"], window_s=t_hi - t_lo, now=t_hi)
        out["spans"] = len(spans)
    if profile:
        traces = [os.path.join(root, f"{tag}_profile", n)
                  for n in os.listdir(os.path.join(root, f"{tag}_profile"))]
        text = "".join(open(p).read() for p in traces)
        named = {k: name in text for k, name in OVL_KERNEL_NAMES.items()}
        if dev.type == "cuda" and not all(named.values()):
            raise AssertionError(f"{tag}: the profile does not name every kernel: {named}")
        out.update(profile_files=len(traces), profile_names_kernels=named)
    return out


def overload_run(dev, paths: dict, root: str, b64: list, rate: float) -> dict:
    """Phase 10 (b): OVL_OVERLOAD deliveries at OVL_OVERLOAD_SHARE x R, one
    interactive in four, every twentieth repeating an answered ``_fid``;
    admission bound, brownout, stale shed and the dead-letter journal."""
    spans_path = os.path.join(root, "b_spans.jsonl")
    journal_path = os.path.join(root, "b_deadletter.jsonl")
    args = ["--max-inflight-frames", "256", "--brownout-queue-wait-ms", "20",
            "--shed-stale-after-ms", "250", "--dead-letter-journal", journal_path,
            "--journal-fsync", "always", "--trace-sample", "1.0", "--trace-jsonl", spans_path,
            "--flight-dir", os.path.join(root, "b_flight"), "--expo-port", "0", "--slo"]
    cli = SocketCli(paths, dev, args, os.path.join(root, "b_metrics.jsonl"))
    cli.connect_more(OVL_CONNECTIONS - 1)
    n_new = OVL_OVERLOAD - OVL_OVERLOAD // OVL_REPEAT_EVERY
    lines = [_frame_line(b64[i % len(b64)], {"_fid": i},
                         "interactive" if i % 4 == 0 else "bulk") for i in range(n_new)]
    repeats = []
    levels = []
    try:
        t0 = time.perf_counter()
        sent_new, owed = 0, 0
        rate_b = OVL_OVERLOAD_SHARE * rate
        for slot in range(OVL_OVERLOAD):
            delay = t0 + slot / rate_b - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if slot % OVL_REPEAT_EVERY == OVL_REPEAT_EVERY - 1:
                owed += 1
            fid = None
            if owed:
                # a repeat of a frame already answered, so surely admitted
                with cli._lock:
                    pool = sorted(set(cli.answered) - set(repeats))
                fid = pool[0] if pool else None
            conn = slot % OVL_CONNECTIONS
            if fid is not None:
                repeats.append(fid)
                cli.send(lines[fid], conn)
                owed -= 1
            elif sent_new < n_new:
                cli.send(lines[sent_new], conn)
                sent_new += 1
        for line in lines[sent_new:]:
            cli.send(line)
        while owed:
            wait_for(lambda: set(cli.answered) - set(repeats), 60, "an answer to repeat")
            with cli._lock:
                fid = min(set(cli.answered) - set(repeats))
            repeats.append(fid)
            cli.send(lines[fid])
            owed -= 1
        t_end = time.perf_counter()
        send_s = t_end - t0

        def settled():
            led = cli.get_json("/ledger")
            c = cli.get_json("/metrics")
            levels.append((time.perf_counter() - t_end, cli.get_json("/brownout")["level"]))
            rejected = sum(v for k, v in c.items() if k.startswith("frames_rejected_"))
            return (led["in_system"] == 0 and led["admitted"] + rejected
                    + c.get("frames_deduped", 0) == OVL_OVERLOAD)

        wait_for(settled, 120, "the overload run to settle", poll=0.1)
        wait_for(lambda: cli.get_json("/brownout")["level"] == 0, 10,
                 "the brownout level to return to 0 after the burst", poll=0.1)
        back_s = time.perf_counter() - t_end
    finally:
        rec = cli.stop()
    ledger = rec["ledger"]
    _close_ledger("overload", ledger)
    delta = _check_serving(dev, "overload", rec)
    journal = DeadLetterJournal(journal_path)
    dropped = [(r["reason"], f) for r in journal.records() for f in r["frames"]]
    fids = [r["meta"]["_fid"] for r in cli.results] + [f["meta"]["_fid"] for _r, f in dropped]
    if len(fids) != len(set(fids)) or len(fids) != ledger["admitted"]:
        raise AssertionError(f"overload: {len(cli.results)} results and {len(dropped)} journaled "
                             f"drops ({len(set(fids))} distinct fids) for {ledger['admitted']} "
                             "admitted frames")
    c = rec["summary"]
    if c.get("frames_deduped", 0) != len(repeats):
        raise AssertionError(f"overload: {c.get('frames_deduped')} deduped, {len(repeats)} sent")
    intake = [f for reason, f in dropped if f["stage"] == "intake.brownout"]
    if any(f["priority"] == 0 for f in intake):
        raise AssertionError("overload: the brownout intake shed an interactive frame")
    dead = sum(1 for reason, _f in dropped if reason == "dead_letter")
    if dead != c.get("frames_dead_lettered", 0):
        raise AssertionError(f"overload: {dead} journaled dead letters, "
                             f"{c.get('frames_dead_lettered')} counted")
    spans = span_records(spans_path)
    transitions = [(round(s["t0"] - spans[0]["t0"], 3), s["from_level"], s["level"],
                    s["queue_wait_ewma_ms"]) for s in spans
                   if s.get("topic") == "_lifecycle" and s["stage"] == "brownout"]
    if not any(lvl >= 1 for _t, _f, lvl, _e in transitions):
        raise AssertionError(f"overload: the brownout level never rose: {transitions}")
    split = span_split(spans)
    e2e = split["e2e_by_priority"]
    done = {r["meta"]["_fid"] for r in cli.results}
    share = {cls: sum(1 for f in range(n_new) if (f % 4 == 0) == (cls == "interactive")
                      and f in done) / sum(1 for f in range(n_new)
                                           if (f % 4 == 0) == (cls == "interactive"))
             for cls in ("interactive", "bulk")}
    # The batcher is FIFO, as in the reference: interactive and bulk frames
    # admitted together wait alike, and the stale bound caps both classes'
    # e2e, so the p99s come out alike (recorded, not gated). What the
    # design gives interactive traffic is its completions: the admission
    # reserve and the bulk-only intake shed.
    if not share["interactive"] > share["bulk"]:
        raise AssertionError(f"overload: interactive frames completed no more often than bulk "
                             f"ones: {share}")
    return dict(deliveries=OVL_OVERLOAD, repeats=len(repeats), rate_fps=OVL_OVERLOAD_SHARE * rate,
                completed_share=share,
                send_s=send_s, ledger=ledger,
                rejected={k: v for k, v in c.items() if k.startswith("frames_rejected_")},
                deduped=c.get("frames_deduped", 0), journaled={r: sum(
                    1 for reason, _f in dropped if reason == r) for r in {r for r, _ in dropped}},
                brownout_transitions=transitions, brownout_back_to_0_s=back_s,
                brownout_max_level=max(lvl for _t, _f, lvl, _e in transitions),
                e2e_by_priority=e2e, split=split, serving=delta)


def overload_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 10 (module docstring); returns the ``{"overload": ...}``
    numbers."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "overload_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    if "cli_paths" not in ctx:
        paths, _frames = write_cli_inputs(dev, seed, os.path.join(root, "cli"))
    else:
        paths = ctx["cli_paths"]
    rng = np.random.default_rng(seed + 10)
    frames = rng.integers(0, 256, (OVL_DISTINCT_FRAMES, *FRAME), dtype=np.uint8)
    b64 = [base64.b64encode(np.ascontiguousarray(f).tobytes()).decode("ascii") for f in frames]
    stack = ctx.get("stack")
    if stack is None:
        stack = build_stack(dev, seed, ShardedGallery(CLI_CAPACITY, DIM,
                                                      store_dtype=torch.bfloat16, device=dev))
    quotes = stage_quotes(dev, card, stack, frames)
    a = steady_run(dev, paths, root, "a", b64, 0.0, sample=1.0, profile=True)
    rate = a["rate_fps"]
    log(f"overload (a) ({card}): R {rate:.1f} frames/s with every span on; "
        f"{OVL_STEADY} interactive frames at "
        f"{a['steady_fps']:.1f}/s; span split ms {json.dumps(a['split'])}; busy "
        f"{a['busy_steady']:.4f}; /attribution {a['attribution']}; /health {a['health']} "
        f"({a['health_http']}); /prom problems {a['prom_problems']}; profile names kernels "
        f"{a['profile_names_kernels']}; serving {a['serving']}")
    log(f"overload (a) p50 ms (metrics windows, bursts and steady; spans in the rings "
        f"and the JSONL) ({card}): {a['summary_p50_ms']}")
    b = overload_run(dev, paths, root, b64, rate)
    log(f"overload (b) ({card}): {b['deliveries']} deliveries at {b['rate_fps']:.1f}/s in "
        f"{b['send_s']:.3f} s; ledger {b['ledger']}; rejected {b['rejected']}; deduped "
        f"{b['deduped']} of {b['repeats']} repeats; journaled {b['journaled']}; brownout "
        f"transitions (s, from, to, ewma ms) {b['brownout_transitions']}, back to 0 "
        f"{b['brownout_back_to_0_s']:.3f} s after the burst; e2e by priority "
        f"{json.dumps(b['e2e_by_priority'])}; serving {b['serving']}")
    return dict(card=card, rate_fps=rate, quotes=quotes, steady=a, overload=b,
                phase_s=time.perf_counter() - t_phase)


# ---- phase 11: the ingest staging ring, the upload and the JPEG pool ----


def _capturing_service(pipeline, **kw):
    """A ``RecognizerService`` over ``FakeConnector`` whose publish keeps a
    copy of each batch's packed result, keyed by its first frame's ``b``.
    Its batcher holds all ING_BATCHES batches injected at once (the default
    ``max_pending`` would evict past 256 frames)."""
    conn = FakeConnector()
    service = RecognizerService(pipeline, conn, batch_size=BATCH, frame_shape=FRAME,
                                flush_timeout=ING_FLUSH_S, max_pending=ING_BATCHES * BATCH,
                                **kw)
    got = {}
    real = service._publish

    def publish(packed, frames, metas, *args, **kwargs):
        if {m["b"] for m in metas[:args[0]]} != {metas[0]["b"]}:
            raise AssertionError("ingest: a batch mixed frames of two injected batches")
        got[metas[0]["b"]] = np.array(packed, copy=True)
        return real(packed, frames, metas, *args, **kwargs)

    service._publish = publish
    return service, conn, got


def _inject_batches(conn, messages, first_b: int = 0) -> None:
    for i, msg in enumerate(messages):
        conn.inject(FRAME_TOPIC, {**msg, "meta": {"b": first_b + i // BATCH, "j": i % BATCH}})


def _htod(rows) -> dict:
    """The profile's host-to-device copies: {kind: (count, device ms)}."""
    out = {}
    for e in rows:
        if e.key.startswith("Memcpy HtoD"):
            n, ms = out.get(e.key, (0, 0.0))
            out[e.key] = (n + e.count, ms + e.self_device_time_total / 1e3)
    return out


def ingest_serve(pipeline, messages: list, ingest: bool) -> dict:
    """Phase 11 (a), one path: ING_BATCHES batches of distinct frames served
    back to back through a service with the pinned ring (``ingest``) or
    the pageable path (no ring); then ING_PROFILE_BATCHES more under
    ``torch.profiler``. Returns the packed results, counters and timings."""
    kw = dict(ingest=IngestConfig("uint8")) if ingest else dict(transfer_dtype=np.uint8)
    service, conn, got = _capturing_service(pipeline, **kw)
    service.start(warmup=True)
    captures = pipeline.captures
    zero_counters()
    t0 = time.perf_counter()
    try:
        _inject_batches(conn, messages)
        if not service.drain(timeout=300.0):
            raise AssertionError("ingest: the service did not drain")
        serve_s = time.perf_counter() - t0
        launches = read_launches()
        summary = service.metrics.summary()
        counters = service.metrics.counters()
        rows = []
        if pipeline.device.type == "cuda":
            rows, _wall, _g = _profiled(lambda: (
                _inject_batches(conn, messages[:ING_PROFILE_BATCHES * BATCH], ING_BATCHES),
                service.drain(timeout=120.0)), 1)
    finally:
        service.stop()
    n_batches = len(messages) // BATCH
    if sorted(got)[:n_batches] != list(range(n_batches)):
        raise AssertionError(f"ingest: results for batches {sorted(got)}")
    if pipeline.captures != captures or counters.get(mn.RECOMPILES_POST_WARMUP, 0):
        raise AssertionError("ingest: a step was captured after warmup")
    if pipeline.device.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"ingest: a kernel did not launch: {launches}")
    htod = _htod(rows)
    out = dict(packed=got, serve_s=serve_s, launches=launches,
               dispatch_p50_ms=summary.get("dispatch_p50_ms"),
               ready_wait_p50_ms=summary.get("ready_wait_p50_ms"),
               htod={k: dict(count=n, device_ms=ms, per_copy_ms=ms / n)  # one copy a batch
                     for k, (n, ms) in htod.items()})
    if ingest:
        ring = service.ingest.staging
        out.update(staging_allocs=counters.get(mn.INGEST_STAGING_ALLOCS, 0),
                   staging_preallocated=ring.preallocated, pinned=ring.pinned,
                   upload_bytes=counters.get(mn.INGEST_UPLOAD_BYTES, 0),
                   upload_p50_ms=summary.get("ingest_upload_p50_ms"))
        if out["staging_allocs"] != ring.preallocated:
            raise AssertionError(f"ingest: the ring allocated past its preallocation: {out}")
        if pipeline.device.type == "cuda" and (
                not ring.pinned or not htod
                or any("Pageable" in k for k in htod) or not any("Pinned" in k for k in htod)):
            raise AssertionError(f"ingest: the frames did not cross from pinned memory: {htod}")
    return out


def jpeg_lines(frames: np.ndarray, quality: int, corrupt_every: int) -> tuple:
    """The JPEG fixture: each frame's JPEG bytes at ``quality``, and one
    pre-encoded JSONL frame line per delivery index ``i`` (frame ``i %
    len(frames)``); every ``corrupt_every``-th delivery carries the first
    64 bytes of its JPEG only (a truncated payload no decoder accepts).
    Returns (jpegs, line_for(i, meta, priority), is_corrupt(i))."""
    jpegs = [encode_jpeg(f, quality=quality) for f in frames]
    b64 = [base64.b64encode(j).decode("ascii") for j in jpegs]
    bad = [base64.b64encode(j[:64]).decode("ascii") for j in jpegs]

    def is_corrupt(i: int) -> bool:
        return i % corrupt_every == corrupt_every - 1

    def line_for(i: int, meta: dict, priority: str) -> bytes:
        payload = (bad if is_corrupt(i) else b64)[i % len(jpegs)]
        return (f'{{"topic": "{FRAME_TOPIC}", "data": {{"{JPEG_KEY}": "{payload}", '
                f'"meta": {json.dumps(meta)}, "priority": "{priority}"}}}}\n').encode()

    return jpegs, line_for, is_corrupt


def direct_pipeline(paths: dict, dev) -> RecognitionPipeline:
    """A ``RecognitionPipeline`` on the CLI's checkpoints and gallery
    directory, loaded here again (the direct call the CLI is held to)."""
    model = serialization.load_model(paths["model"], device=dev)
    det = detector_mod.CNNFaceDetector.load(paths["det"], device=dev)
    images, labels, _ = dataset_utils.read_images(paths["gallery"],
                                                  image_size=model.feature.input_size)
    gallery = ShardedGallery(CLI_CAPACITY, DIM, store_dtype=torch.bfloat16, device=dev)
    gallery.add(model.feature.extract(images).cpu().numpy(), labels)
    return RecognitionPipeline(det, model.feature.net, gallery,
                               face_size=model.feature.input_size, fused_embedder=True,
                               device=dev)


def cross_check_messages(direct, frames: np.ndarray, messages: list, what: str) -> dict:
    """Published results of ``frames`` (in order) against the direct
    pipeline's call on them, batch by batch (XCHECK_*; labels equal). A
    short last batch is padded to BATCH frames (repeats of its first), so
    every direct call runs at the ladder's top rung, which the served
    rungs match: a call at a batch size off the ladder (24) moved a
    similarity enough to flip a label between two near-tied subjects of
    the CLI configuration on the card."""
    threshold = recognize_app.build_parser().get_default("similarity_threshold")
    det = direct.detector
    worst_box = worst_sim = 0.0
    n_pairs = 0
    for s in range(0, len(frames), BATCH):
        batch = frames[s:s + BATCH]
        if len(batch) < BATCH:
            batch = np.concatenate([batch, np.repeat(batch[:1], BATCH - len(batch), axis=0)])
        want = unpack_result(direct.recognize_batch_packed(batch).cpu().numpy(), 1)
        want = want._replace(labels=np.where(want.similarities >= threshold, want.labels, -1))
        got = messages_as_result(messages[s:s + BATCH], det.max_faces)
        for i in range(got.valid.shape[0]):
            pairs, _swaps = cross_check_frame(got, want, i, det.score_threshold,
                                              det.iou_threshold)
            n_pairs += len(pairs)
            for j, m, dbox in pairs:
                if got.labels[i, j, 0] != want.labels[i, m, 0]:
                    raise AssertionError(
                        f"{what}: frame {s + i} labels differ: published label "
                        f"{got.labels[i, j, 0]} (similarity {got.similarities[i, j, 0]}), "
                        f"direct {want.labels[i, m, 0]} ({want.similarities[i, m, 0]}), "
                        f"threshold {threshold}")
                worst_box = max(worst_box, dbox)
                worst_sim = max(worst_sim, abs(got.similarities[i, j, 0]
                                               - want.similarities[i, m, 0]))
    if worst_sim > XCHECK_SIM or n_pairs < len(frames):
        raise AssertionError(f"{what}: {n_pairs} faces paired, sim diff {worst_sim}")
    return dict(faces=n_pairs, max_box_px=worst_box, max_sim=worst_sim)


def ingest_cli_run(dev, paths: dict, root: str, mode: str, frames: np.ndarray) -> dict:
    """Phase 11 (b), one mode: the CLI on a socket with ``--ingest-mode
    mode``, spans in the rings (``/spans``) and the dead-letter journal;
    R from a burst of OVL_BURST, then OVL_STEADY interactive frames at
    OVL_STEADY_SHARE x R; the span split with the upload and decode spans.
    In jpeg mode every ING_CORRUPT_EVERY-th delivery is corrupt."""
    journal_path = os.path.join(root, f"{mode}_deadletter.jsonl")
    args = ["--ingest-mode", mode, "--trace-sample", "1.0", "--trace-ring", "16384",
            "--expo-port", "0", "--dead-letter-journal", journal_path,
            "--journal-fsync", "always"]
    if mode == "jpeg":
        jpegs, line_for, is_corrupt = jpeg_lines(frames, ING_JPEG_QUALITY, ING_CORRUPT_EVERY)
    else:
        b64 = [base64.b64encode(np.ascontiguousarray(f).tobytes()).decode("ascii")
               for f in frames]
        jpegs, is_corrupt = None, (lambda i: False)

        def line_for(i, meta, priority):
            return _frame_line(b64[i % len(b64)], meta, priority)

    n = OVL_BURST + OVL_STEADY
    lines = [line_for(i, {"_fid": i}, "interactive") for i in range(n)]
    good = [i for i in range(n) if not is_corrupt(i)]
    cli = SocketCli(paths, dev, args, os.path.join(root, f"{mode}_metrics.jsonl"))
    try:
        t0 = time.perf_counter()
        paced(cli, lines[:OVL_BURST], 0)
        burst_good = [i for i in good if i < OVL_BURST]
        wait_for(lambda: cli.n_answered() >= len(burst_good), 120, f"{mode}: the burst's answers")
        with cli._lock:
            rate = len(burst_good) / (max(cli.answered[f] for f in burst_good) - t0)
        t_send = paced(cli, lines[OVL_BURST:], OVL_STEADY_SHARE * rate)
        wait_for(lambda: cli.n_answered() >= len(good), 120, f"{mode}: the steady answers")
        spans = [{**span, "topic": topic} for topic in (FRAME_TOPIC, "_batch")
                 for span in cli.get_json(f"/spans?topic={topic}&limit=10000")["spans"]]
    finally:
        rec = cli.stop()
    _close_ledger(mode, rec["ledger"])
    delta = _check_serving(dev, mode, rec)
    bad = [i for i in range(n) if is_corrupt(i)]
    dropped = [(r["reason"], f["meta"]["_fid"]) for r in DeadLetterJournal(journal_path).records()
               for f in r["frames"]]
    if sorted(dropped) != sorted(("decode_error", i) for i in bad):
        raise AssertionError(f"{mode}: journaled drops {dropped[:8]} for corrupt deliveries "
                             f"{bad[:8]}")
    ledger = rec["ledger"]
    if ledger["completed"] != len(good) or ledger["drops_by_reason"] != (
            {"frames_dropped_decode": float(len(bad))} if bad else {}):
        raise AssertionError(f"{mode}: ledger {ledger} for {len(good)} good and {len(bad)} "
                             f"corrupt deliveries")
    split = span_split(spans, first_frame=OVL_BURST)
    steady_tids = {s["trace"] for s in spans if s["topic"] == FRAME_TOPIC
                   and s["trace"] > 2 * OVL_BURST}
    batches = {s["batch"] for s in spans if s["topic"] == FRAME_TOPIC and s["stage"] ==
               "queue_wait" and s["trace"] in steady_tids}
    for stage, topic, keys in (("upload", "_batch", batches), ("decode", FRAME_TOPIC,
                                                                steady_tids)):
        ms = [s["dur"] * 1e3 for s in spans
              if s["topic"] == topic and s["stage"] == stage and s["trace"] in keys]
        split[stage] = {"p50": _pct(ms, 50), "p99": _pct(ms, 99), "n": len(ms)}
    if split["upload"]["n"] < 1 or (mode == "jpeg" and split["decode"]["n"] < 1):
        raise AssertionError(f"{mode}: no upload or decode spans: {split}")
    by_fid = {r["meta"]["_fid"]: r for r in cli.results}
    return dict(mode=mode, rate_fps=rate, steady_fps=OVL_STEADY_SHARE * rate,
                steady_send_s=t_send, split=split, ledger=ledger, serving=delta,
                corrupt=len(bad), journaled=len(dropped),
                summary_p50_ms={k: rec["summary"].get(f"{k}_p50_ms") for k in (
                    "queue_wait", "dispatch", "ready_wait", "publish", "e2e_latency",
                    "ingest_upload", "decode_latency")},
                jpegs=jpegs, by_fid=by_fid)


def ingest_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 11 (module docstring); returns the ``{"ingest": ...}`` numbers."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ingest_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stack = ctx["stack"]
    rng = np.random.default_rng(seed + 11)
    frames = rng.integers(0, 256, (ING_BATCHES * BATCH, *FRAME), dtype=np.uint8)
    messages = [encode_frame(f) for f in frames]
    # (a) the pageable path (the step copies the host frames), then the
    # pinned ring, then the pageable path again, over one stack (the same
    # graphs)
    runs = [ingest_serve(stack, messages, ingest) for ingest in (False, True, False)]
    plain, ring = runs[0], runs[1]
    for b in range(ING_BATCHES):
        for other in (runs[0], runs[2]):
            if not np.array_equal(ring["packed"][b], other["packed"][b]):
                raise AssertionError(f"ingest: batch {b} over the pinned ring differs from the "
                                     f"pageable path")
    served = {k: v for k, v in ring.items() if k != "packed"}
    log(f"ingest (a) ({card}): {ING_BATCHES} batches of distinct frames, the pinned ring's "
        f"results equal the pageable path's bit for bit; ring {served}; pageable path "
        f"dispatch p50 {plain['dispatch_p50_ms']}, {runs[2]['dispatch_p50_ms']} ms, HtoD "
        f"{plain['htod']}")
    # (b) the CLI on a socket in uint8 and jpeg modes
    paths = ctx.get("cli_paths")
    if paths is None:
        paths, _frames = write_cli_inputs(dev, seed, os.path.join(root, "cli"))
    cli_frames = rng.integers(0, 256, (OVL_DISTINCT_FRAMES, *FRAME), dtype=np.uint8)
    cli_runs = {mode: ingest_cli_run(dev, paths, root, mode, cli_frames)
                for mode in ("uint8", "jpeg")}
    jpeg = cli_runs["jpeg"]
    decoded = np.stack([decode_jpeg(j) for j in jpeg.pop("jpegs")])
    cli_runs["uint8"].pop("jpegs")
    by_fid = jpeg.pop("by_fid")
    cli_runs["uint8"].pop("by_fid")
    fids = [f for f in range(len(decoded)) if f in by_fid]
    direct = direct_pipeline(paths, dev)
    xcheck = cross_check_messages(direct, decoded[fids], [by_fid[f] for f in fids],
                                  "ingest jpeg vs the direct pipeline")
    drop_stack(direct)
    del direct
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for mode, run in cli_runs.items():
        log(f"ingest (b) {mode} ({card}): R {run['rate_fps']:.1f} frames/s; span split ms at "
            f"{OVL_STEADY_SHARE} R {json.dumps(run['split'])}; p50 ms {run['summary_p50_ms']}; "
            f"corrupt {run['corrupt']} journaled {run['journaled']}; ledger {run['ledger']}; "
            f"serving {run['serving']}")
    log(f"ingest (b) jpeg results vs the direct pipeline on the host-decoded bytes: {xcheck}")
    return dict(card=card, served={k: v for k, v in ring.items() if k != "packed"},
                pageable=[{k: v for k, v in r.items() if k != "packed"} for r in (runs[0],
                                                                                 runs[2])],
                cli=cli_runs, jpeg_xcheck=xcheck, phase_s=time.perf_counter() - t_phase)


# ---- phase 12: the staged re-embed, parity and the fenced cutover ----


def _l2norm(rows: np.ndarray) -> np.ndarray:
    """The rollout's row normalization (``runtime.rollout``), on the host."""
    rows = np.asarray(rows, np.float32)
    return rows / np.maximum(np.linalg.norm(rows, axis=-1, keepdims=True), 1e-12)


def stamps_move_once(stamps: list, old: int, new: int) -> bool:
    """True when a sequence of published ``embedder_version`` stamps is
    ``old`` then ``new``, with both present and nothing else."""
    if not stamps or stamps[0] != old or stamps[-1] != new:
        return False
    switch = stamps.index(new)
    return all(s == old for s in stamps[:switch]) and all(s == new for s in stamps[switch:])


def rotation(seed: int, dim: int = DIM) -> np.ndarray:
    """A seeded orthogonal [dim, dim] matrix (QR of a normal draw)."""
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(dim, dim)))
    return (q * np.sign(np.diag(r))).astype(np.float32)


def card_embed_fn(stack, rot=None):
    """Face crops [n, h, w] -> embeddings [n, D] through the stack's
    embedder on its device, fused (kernel B), then ``@ rot`` when given."""
    face = stack.face_size

    def fn(crops):
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(crops, np.float32), device=stack.device)
            emb = embedder_mod.fused_forward(stack.embed_net,
                                             embedder_mod.normalize_faces(x, face))
        out = emb.float().cpu().numpy()
        return out if rot is None else out @ rot

    return fn


class _Timed:
    """Wraps ``obj.name`` to add each call's seconds to ``seconds``."""

    def __init__(self, obj, name: str):
        self.seconds = []
        real = getattr(obj, name)

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.seconds.append(time.perf_counter() - t)

        setattr(obj, name, timed)


def rollout_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 12 (module docstring); returns the ``{"rollout": ...}`` numbers."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "rollout_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stack, frames = ctx["stack"], ctx["frames"]
    # the last RO_ROWS of phase 4's rows: the planted faces among them
    rows, labels, n_plant = ctx["rows"][-RO_ROWS:], ctx["labels"][-RO_ROWS:], ctx["n_plant"]
    gallery = ShardedGallery(RO_ROWS, DIM, store_dtype=torch.bfloat16, device=dev)
    gallery.add(rows, labels)
    pipeline = RecognitionPipeline(stack.detector, stack.embed_net, gallery,
                                   face_size=embedder_mod.SERVING_FACE_SIZE,
                                   fused_embedder=True, device=dev)
    injector = FaultInjector()
    state = StateLifecycle(root, keep_checkpoints=2, checkpoint_wal_rows=1 << 30,
                           checkpoint_every_s=1e9, fault_injector=injector)
    rot = rotation(seed + 12)
    co_kw = dict(old_embed_fn=card_embed_fn(stack), new_embed_fn=card_embed_fn(stack, rot),
                 parity_min_samples=RO_PARITY_SAMPLES, chunk_rows=RO_CHUNK_ROWS,
                 live_sample_interval_s=0.0, face_size=embedder_mod.SERVING_FACE_SIZE,
                 fault_injector=injector)
    metrics = Metrics()
    conn = FakeConnector()
    service = RecognizerService(pipeline, conn, batch_size=BATCH, frame_shape=FRAME,
                                flush_timeout=0.01, ingest=IngestConfig("uint8"),
                                state_store=state, metrics=metrics)
    t = time.perf_counter()
    if not state.checkpoint_now(wait=True):
        raise AssertionError("rollout: the first checkpoint failed")
    first_ckpt_s = time.perf_counter() - t
    published = []  # (arrival, batch tick, embedder_version) of every result
    batch_stamps = []  # the stamp of each published batch, in publish order
    real_publish = service._publish

    def publish(packed, frames, metas, count, stamp=None, *args, **kwargs):
        batch_stamps.append(stamp)
        return real_publish(packed, frames, metas, count, stamp, *args, **kwargs)

    service._publish = publish
    conn.subscribe(RESULT_TOPIC, lambda _t, m: published.append(
        (time.perf_counter(), m["meta"]["tick"], m.get("embedder_version"))))
    sent = {}
    stop, errors = threading.Event(), []
    messages = [encode_frame(f) for f in frames]

    def produce():
        tick = 0
        try:
            while not stop.is_set():
                sent[tick] = time.perf_counter()
                base = (tick % (len(frames) // BATCH)) * BATCH
                for j in range(BATCH):
                    conn.inject(FRAME_TOPIC, {**messages[base + j],
                                              "meta": {"tick": tick, "j": j}})
                tick += 1
                time.sleep(RO_TICK_S)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    service.start(warmup=True)
    captures, recaptures = pipeline.captures, pipeline.recaptures
    built = []  # (host clock, step key) of every step built after warmup
    real_build = pipeline._build_step

    def build_step(key, data, ivf):
        built.append((time.perf_counter(), key))
        return real_build(key, data, ivf)

    pipeline._build_step = build_step
    t_cutover = float("inf")
    zero_counters()
    producer = threading.Thread(target=produce, name="rollout-producer", daemon=True)
    producer.start()
    try:
        # the stage, killed partway at its append (on_stage), resumed
        co = RolloutCoordinator(state, gallery, lambda r: r @ rot, 2, **co_kw)
        service.rollout = co
        t_stage0 = time.perf_counter()
        co.run_stage(max_chunks=RO_CRASH_AFTER_CHUNKS)
        injector.script("stage", "crash")
        try:
            co.run_stage()
            raise AssertionError("rollout: the scripted stage crash did not fire")
        except InjectedCrashError:
            pass
        watermark = co.stage.watermark
        co = RolloutCoordinator(state, gallery, lambda r: r @ rot, 2, **co_kw)
        if not co.stage.resumed or co.stage.watermark != watermark:
            raise AssertionError(f"rollout: resumed at {co.stage.watermark}, not {watermark}")
        service.rollout = co
        co.run_stage()
        t_stage1 = time.perf_counter()
        stage_s = t_stage1 - t_stage0
        staged, staged_labels = co.stage.arrays()
        host = gallery.snapshot_rows(0, None)[0]
        want = np.concatenate([_l2norm(host[s:s + RO_CHUNK_ROWS] @ rot)
                               for s in range(0, RO_ROWS, RO_CHUNK_ROWS)])
        del host
        if not (np.array_equal(staged, want) and np.array_equal(staged_labels, labels)):
            raise AssertionError("rollout: the resumed stage differs from an uncrashed one")
        del want
        stage_bytes = os.path.getsize(co.stage.path)
        # parity from the live publish path, on the rollout thread
        co.start()
        wait_for(lambda: errors or co.parity.samples >= RO_PARITY_SAMPLES, 300,
                 "the parity window's sample floor")
        wait_for(lambda: co.phase == "ready", 60, "the rollout to read ready")
        parity = dict(samples=co.parity.samples, agreement=co.parity.agreement)
        # a death after the fence record: recovery completes the cutover
        injector.script("cutover", "crash_after_record")
        try:
            co.cutover()
            raise AssertionError("rollout: the scripted cutover crash did not fire")
        except InjectedCrashError:
            pass
        if gallery.embedder_version != 1:
            raise AssertionError("rollout: the crashed cutover swapped the gallery")
        g2 = ShardedGallery(8, DIM, store_dtype=torch.bfloat16, device=dev)
        restarted = StateLifecycle(root, keep_checkpoints=2)
        t = time.perf_counter()
        report = restarted.recover(g2, [])
        recover_s = time.perf_counter() - t
        recover_stages = dict(restarted.last_recovery_s)
        restarted.close()
        if (report.get("completed_cutover") or {}).get("to_version") != 2 or \
                g2.embedder_version != 2:
            raise AssertionError(f"rollout: recovery did not complete the cutover: {report}")
        # the cutover, in the serving process
        fence = _Timed(state.wal, "append_cutover")
        upload = _Timed(gallery, "load_snapshot")
        ckpt = _Timed(state, "checkpoint_now")
        t = t_cutover = time.perf_counter()
        co.cutover()
        cutover_s = time.perf_counter() - t
        t_cut = time.perf_counter()
        n_at_cut = len(published)
        wait_for(lambda: errors or len(published) >= n_at_cut + RO_AFTER_BATCHES * BATCH, 120,
                 "batches after the cutover")
    finally:
        stop.set()
        producer.join(timeout=60)
        co.stop()
        service.drain(timeout=120)
        service.stop()
    if errors:
        raise AssertionError(f"rollout: the producer failed: {errors}")
    launches = read_launches()
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"rollout: a kernel did not launch while serving: {launches}")
    # a batch publishes under one stamp; in publish order the results' and
    # the batches' stamps each move from 1 to 2 once
    stamps = [v for _t, _k, v in published]
    if not (stamps_move_once(stamps, 1, 2) and stamps_move_once(batch_stamps, 1, 2)):
        raise AssertionError(f"rollout: result stamps mixed: {stamps[:8]} ... {stamps[-8:]}; "
                             f"batches {batch_stamps[:4]} ... {batch_stamps[-4:]}")
    # each rung's graph is captured again once, after the cutover began, and
    # never again (on the CPU nothing is captured)
    keys = [k for _t, k in built]
    n_re = pipeline.recaptures - recaptures
    if (any(t < t_cutover for t, _k in built) or len(set(keys)) != len(keys)
            or n_re != len(keys) or pipeline.captures - captures != n_re
            or (dev.type == "cuda" and not 1 <= n_re <= len(service._bucket_ladder))):
        raise AssertionError(f"rollout: steps built after warmup {built} (cutover at "
                             f"{t_cutover}); recaptures {n_re}")
    # the planted faces in the new space, through kernel A on both galleries
    planted = _l2norm(rows[RO_ROWS - n_plant:] @ rot)
    q = torch.from_numpy(planted).to(dev)
    streaming_match_topk.launches = 0
    la, sa, ia = gallery.match(q, k=1)
    lb, sb, ib = g2.match(q, k=1)
    if not (torch.equal(la, lb) and torch.equal(sa, sb) and torch.equal(ia, ib)):
        raise AssertionError("rollout: the recovered cutover matches differ from the served one")
    found = la[:, 0].cpu().numpy()
    if not np.array_equal(found, np.arange(n_plant)) or float(sa.min()) < 0.99:
        raise AssertionError(f"rollout: planted rows not found after the cutover: {found[:8]}")
    if dev.type == "cuda" and streaming_match_topk.launches < 2:
        raise AssertionError("rollout: the post-cutover matches did not run kernel A")
    by_tick = {}
    for t_arr, tick, _v in published:
        by_tick[tick] = max(by_tick.get(tick, 0.0), t_arr)
    during = [(by_tick[k] - sent[k]) * 1e3 for k in by_tick
              if k in sent and t_stage0 <= sent[k] <= t_stage1]
    after = [(by_tick[k] - sent[k]) * 1e3 for k in by_tick if k in sent and sent[k] >= t_cut]
    out = dict(card=card, rows=RO_ROWS, chunk_rows=RO_CHUNK_ROWS,
               stage_s=stage_s, stage_bytes=stage_bytes, resumed_at=watermark,
               first_checkpoint_s=first_ckpt_s, parity=parity,
               cutover_s=cutover_s, fence_s=sum(fence.seconds),
               upload_s=sum(upload.seconds), checkpoint_s=sum(ckpt.seconds),
               checkpoint_stages=state.last_checkpoint_s, recover_s=recover_s,
               recover_stages=recover_stages,
               batch_ms_during_stage=dict(p50=_pct(during, 50), worst=max(during or [0.0]),
                                          n=len(during)),
               batch_ms_after_cutover=dict(p50=_pct(after, 50), n=len(after)),
               recaptures=n_re, recaptured_batches=sorted(k[0] for k in keys),
               results=len(stamps), results_v1=stamps.count(1), results_v2=stamps.count(2),
               batches_v1=batch_stamps.count(1), batches_v2=batch_stamps.count(2),
               launches=launches, ledger=service.ledger(),
               phase_s=time.perf_counter() - t_phase)
    log(f"rollout ({card}): {json.dumps(out)}")
    state.close()
    drop_stack(pipeline)
    del g2, gallery, pipeline
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---- phase 13: the cascade and the registry's swaps ----


def choose_threshold(scores: np.ndarray, n_keep: int, n_reject: int) -> float:
    """The threshold among the scores' 10th-90th percentiles that leaves the
    most room for ``n_keep`` frames at least CASC_MARGIN above it and
    ``n_reject`` at least CASC_MARGIN below it; raises when none leaves
    enough."""
    best, room = None, -1
    for q in range(10, 91):
        thr = float(np.percentile(scores, q))
        spare = min(int((scores >= thr + CASC_MARGIN).sum()) - n_keep,
                    int((scores < thr - CASC_MARGIN).sum()) - n_reject)
        if spare > room:
            best, room = thr, spare
    if room < 0:
        raise AssertionError(f"cascade: no threshold leaves {n_keep} keeps and {n_reject} "
                             f"rejects {CASC_MARGIN} from it (scores {scores.min():.4f}-"
                             f"{scores.max():.4f})")
    return best


def cascade_batches(pool: np.ndarray, scores: np.ndarray, thr: float, seed: int):
    """One batch of BATCH frames per entry of CASC_SURVIVORS, survivors at
    seeded positions: [(frames, keep mask)], drawn without repeats."""
    rng = np.random.default_rng(seed)
    keeps = list(rng.permutation(np.flatnonzero(scores >= thr + CASC_MARGIN)))
    rejects = list(rng.permutation(np.flatnonzero(scores < thr - CASC_MARGIN)))
    out = []
    for n in CASC_SURVIVORS:
        idx = [keeps.pop() for _ in range(n)] + [rejects.pop() for _ in range(BATCH - n)]
        idx = [idx[i] for i in rng.permutation(BATCH)]
        out.append((pool[idx], scores[idx] >= thr))
    return out


def face_rows(result, i: int, threshold: float) -> list:
    """Frame ``i`` of an unpacked result as the published faces' numbers
    (box x-first, detection score, label as published, similarity)."""
    out = []
    for j in np.flatnonzero(result.valid[i]):
        sim = float(result.similarities[i, j, 0])
        label = int(result.labels[i, j, 0])
        y0, x0, y1, x1 = (float(v) for v in result.boxes[i, j])
        out.append(([x0, y0, x1, y1], float(result.det_scores[i, j]),
                    label if sim >= threshold and label >= 0 else -1, sim))
    return out


def published_rows(message: dict) -> list:
    return [(f["box"], f["detection_score"], f["label"], f["similarity"])
            for f in message["faces"]]


def _inject_batch(conn, frames, meta: dict) -> float:
    """Inject one batch of pre-encoded frames; returns the host clock after
    the last put (which flushes the batch): its results' arrivals past it
    are the step's host ms."""
    messages = [encode_frame(frame) for frame in frames]
    for j, message in enumerate(messages):
        conn.inject(FRAME_TOPIC, {**message, "meta": {**meta, "j": j}})
    return time.perf_counter()


def cascade_serve(dev, stack, batches, thr: float) -> dict:
    """Phase 13 (a), the serving part: the three cascade batches
    CASC_REPEATS times through a service with the cascade, then a full
    batch as often without it; the gates on the results, the ledger, the
    captures and the launches."""
    conn = FakeConnector()
    arrived = {}  # (kind, repeat) -> [perf_counter of each result]
    conn.subscribe(RESULT_TOPIC, lambda _t, m: arrived.setdefault(
        (m["meta"]["kind"], m["meta"]["r"]), []).append(time.perf_counter()))
    metrics = Metrics()
    service = RecognizerService(stack, conn, batch_size=BATCH, frame_shape=FRAME,
                                flush_timeout=1.0, ingest=IngestConfig("uint8"),
                                bucket_sizes=CASC_LADDER, cascade_threshold=thr,
                                metrics=metrics)
    ccap0 = stack.cascade_captures
    service.start(warmup=True)
    warm = dict(captures=stack.captures, cascade=stack.cascade_captures)
    zero_counters()
    step_ms = {n: [] for n in CASC_SURVIVORS}
    try:
        for r in range(CASC_REPEATS):
            for n, (frames, _keep) in zip(CASC_SURVIVORS, batches):
                t0 = _inject_batch(conn, frames, {"kind": n, "r": r})
                wait_for(lambda: len(arrived.get((n, r), ())) >= BATCH, 60,
                         f"the {n}-survivor batch's results")
                step_ms[n].append((max(arrived[(n, r)]) - t0) * 1e3)
        if not service.drain(timeout=60):
            raise AssertionError("cascade: the service did not drain")
    finally:
        service.stop()
    launches = read_launches()
    steps = int(metrics.counter(BATCHES_DISPATCHED))
    ledger = service.ledger()
    results = conn.messages(RESULT_TOPIC)
    n_reject = CASC_REPEATS * sum(BATCH - n for n in CASC_SURVIVORS)
    _close_ledger("cascade", ledger)
    if ledger["completed_empty"] != n_reject or metrics.counter(mn.CASCADE_ERRORS):
        raise AssertionError(f"cascade: ledger {ledger}, errors "
                             f"{metrics.counter(mn.CASCADE_ERRORS)}; {n_reject} rejects")
    # on the CPU nothing is captured
    if warm["cascade"] - ccap0 != (len(CASC_LADDER) if dev.type == "cuda" else 0) or (
            stack.captures, stack.cascade_captures) != (warm["captures"], warm["cascade"]) or \
            metrics.counter(mn.RECOMPILES_POST_WARMUP):
        raise AssertionError(f"cascade: captures at warmup {stack.cascade_captures - ccap0} "
                             f"(stage 1), after warmup stage 2 "
                             f"{stack.captures - warm['captures']}, stage 1 "
                             f"{stack.cascade_captures - warm['cascade']}")
    if steps != CASC_REPEATS * sum(1 for n in CASC_SURVIVORS if n) or dev.type == "cuda" and (
            launches != {"streaming_match": steps, "sepblock": 6 * steps, "nms": steps}):
        raise AssertionError(f"cascade: {steps} steps, launches {launches}")
    # each rejected frame once, empty, exit cascade; the survivors later
    by_key = {}
    for m in results:
        key = (m["meta"]["kind"], m["meta"]["r"], m["meta"]["j"])
        if key in by_key:
            raise AssertionError(f"cascade: frame {key} published twice")
        by_key[key] = m
    for r in range(CASC_REPEATS):
        for n, (_frames, keep) in zip(CASC_SURVIVORS, batches):
            for j in range(BATCH):
                m = by_key[(n, r, j)]
                if (m.get("exit") == "cascade") == bool(keep[j]) or (
                        not keep[j] and m["faces"]):
                    raise AssertionError(f"cascade: frame {(n, r, j)} keep {keep[j]}: {m}")
    summary = metrics.summary()
    full_ms = cascade_full_batches(stack, batches[-1][0])
    return dict(results=by_key, launches=launches, steps=steps, ledger=ledger,
                stage1_captures_at_warmup=warm["cascade"] - ccap0,
                cascade_score_p50_ms=summary.get("cascade_score_p50_ms"),
                dispatch_p50_ms=summary.get("dispatch_p50_ms"),
                step_ms={"full": full_ms, **{f"survivors_{n}": v for n, v in step_ms.items()}})


def cascade_full_batches(stack, frames) -> list:
    """The host ms (inject to the last result) of a full batch through the
    same stack without the cascade, CASC_REPEATS times."""
    conn = FakeConnector()
    arrived = {}
    conn.subscribe(RESULT_TOPIC, lambda _t, m: arrived.setdefault(
        m["meta"]["r"], []).append(time.perf_counter()))
    service = RecognizerService(stack, conn, batch_size=BATCH, frame_shape=FRAME,
                                flush_timeout=1.0, ingest=IngestConfig("uint8"),
                                bucket_sizes=CASC_LADDER, cascade=False)
    service.start(warmup=True)
    out = []
    try:
        for r in range(CASC_REPEATS):
            t0 = _inject_batch(conn, frames, {"kind": "full", "r": r})
            wait_for(lambda: len(arrived.get(r, ())) >= BATCH, 60, "the full batch's results")
            out.append((max(arrived[r]) - t0) * 1e3)
        service.drain(timeout=60)
    finally:
        service.stop()
    return out


def cascade_direct(dev, stack, gate_cpu, batches, thr: float, served: dict) -> dict:
    """Phase 13 (a), after serving: the card's stage-1 scores against the
    CPU's f32, and each survivor's published result against a direct call
    of the compacted batch at its rung (comparison launches, after the
    path's counts were read)."""
    worst, faces = 0.0, 0
    for n, (frames, keep) in zip(CASC_SURVIVORS, batches):
        card = stack.cascade_scores(frames).float().cpu().numpy()
        cpu = gate_cpu.score_batch(frames).numpy()
        worst = max(worst, float(np.abs(card - cpu).max()))
        if not np.array_equal(card >= thr, keep) or not np.array_equal(cpu >= thr, keep):
            raise AssertionError(f"cascade: keep masks differ on the {n}-survivor batch")
        if not n:
            continue
        kept = np.flatnonzero(keep)
        rung = min(b for b in CASC_LADDER if b >= n)
        compacted = np.concatenate([frames[kept], frames[n:rung]])
        direct = unpack_result(stack.recognize_batch_packed(compacted).cpu().numpy(), 1)
        for r in range(CASC_REPEATS):
            for i, j in enumerate(kept):
                got = published_rows(served[(n, r, int(j))])
                if got != face_rows(direct, i, 0.3):
                    raise AssertionError(f"cascade: survivor {(n, r, int(j))} differs from "
                                         f"the direct call at rung {rung}")
                faces += len(got)
    if worst > CASC_SCORE_ATOL:
        raise AssertionError(f"cascade: stage-1 scores differ from the CPU's by {worst}")
    return dict(score_max_abs_err=worst, survivor_faces_equal=faces)


def stage1_times(dev, stack, frames) -> dict:
    """Stage-1 ms per rung: CUDA events around 20 calls of the pipeline's
    pass (graph replays, frames already on the card), and the device time
    of its kernels in a graph of 20 back-to-back eager passes."""
    out = {}
    for rung in CASC_LADDER:
        x = torch.from_numpy(np.ascontiguousarray(frames[:rung])).to(dev)
        net = stack._cascade_net
        out[rung] = dict(
            ms=cuda_ms(lambda: stack.cascade_scores(x)),
            device_ms=graph_ms(lambda: cascade_mod.frame_scores(net, x.float())))
    return out


def perturbed(params: dict, seed: int, share: float) -> dict:
    """Each tensor plus seeded normal noise of ``share`` of its spread."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in params.items():
        noise = torch.randn(v.shape, generator=gen) * (float(v.float().std()) * share
                                                        if v.numel() > 1 else share)
        out[k] = (v.float().cpu() + noise).to(v.dtype).to(v.device)
    return out


def detector_with(dev, params: dict):
    """A serving-config detector on ``dev`` holding ``params``."""
    det = detector_mod.CNNFaceDetector(device=dev)
    det.load_params(params)
    return det


def boxes_fn(det):
    """A frame's verdict as the published boxes (x-first), for the parity."""
    def fn(frame):
        b, _s, v = det.detect_batch(np.asarray(frame, np.float32)[None])
        b, v = b[0].cpu().numpy(), v[0].cpu().numpy()
        return [[float(x[1]), float(x[0]), float(x[3]), float(x[2])] for x in b[v]]
    return fn


def registry_live_swap(dev, stack, frames, root: str) -> dict:
    """Phase 13 (b): the live v2 swap under serving, the v3 refusal, the
    stamps against direct calls; returns the numbers and the state dir's
    objects for the crash checks."""
    injector = FaultInjector()
    state = StateLifecycle(root, keep_checkpoints=1, checkpoint_wal_rows=1 << 30,
                           checkpoint_every_s=1e9, fault_injector=injector)
    registry = ModelRegistry(root)
    state.attach_registry(registry)
    v1 = {k: t.detach().clone() for k, t in stack.detector.params.items()}
    v2 = perturbed(v1, 13, REG_PERTURB)
    v3 = dict(v2, **{"heatmap.bias": torch.full_like(v2["heatmap.bias"], -30.0)})
    dets = {v: detector_with(dev, p) for v, p in ((1, v1), (2, v2), (3, v3))}
    paths = {v: registry_params_path(root, "detector", v) for v in (2, 3)}
    for v, path in paths.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        dets[v].save(path)
    metrics = Metrics()
    conn = FakeConnector()
    service = RecognizerService(stack, conn, batch_size=BATCH, frame_shape=FRAME,
                                flush_timeout=0.01, ingest=IngestConfig("uint8"),
                                bucket_sizes=CASC_LADDER, state_store=state, metrics=metrics,
                                cascade=False)
    service.registry = registry
    published = []  # (arrival, tick, j, detector version) of every result
    conn.subscribe(RESULT_TOPIC, lambda _t, m: published.append(
        (time.perf_counter(), m["meta"]["tick"], m["meta"]["j"],
         (m.get("registry") or {}).get("detector"), m)))
    batches = []  # (the batch's detector stamp, its frames' (tick, j)) in publish order
    real_publish = service._publish

    def publish(packed, frames, metas, count, stamp=None, *args, **kwargs):
        batches.append((dict(stamp or ()).get("detector"),
                        [(m["tick"], m["j"]) for m in metas[:count]]))
        return real_publish(packed, frames, metas, count, stamp, *args, **kwargs)

    service._publish = publish
    timers = {name: _Timed(obj, attr) for name, obj, attr in (
        ("fence", state.wal, "append_registry_cutover"), ("manifest", registry, "install"),
        ("install", stack, "install_detector_params"), ("flush", service, "flush_model_caches"),
        ("checkpoint", state, "checkpoint_now"))}
    co = RegistrySwapCoordinator(
        state, registry, "detector", 2, old_detect_fn=boxes_fn(dets[1]),
        new_detect_fn=boxes_fn(dets[2]), params_path=paths[2],
        install_fn=lambda: stack.install_detector_params(v2, version=2),
        rollback_install_fn=lambda: stack.install_detector_params(v1, version=3),
        flush_fn=service.flush_model_caches, parity_min_samples=REG_PARITY_SAMPLES,
        watch_min_samples=REG_PARITY_SAMPLES, live_sample_interval_s=0.0, metrics=metrics)
    service.registry_swap = co
    n_bases = len(frames) // BATCH
    messages = [encode_frame(f) for f in frames]
    sent, stop, errors = {}, threading.Event(), []

    def produce():
        tick = 0
        try:
            while not stop.is_set():
                sent[tick] = time.perf_counter()
                base = (tick % n_bases) * BATCH
                for j in range(BATCH):
                    conn.inject(FRAME_TOPIC, {**messages[base + j],
                                              "meta": {"tick": tick, "j": j}})
                tick += 1
                time.sleep(REG_TICK_S)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    service.start(warmup=True)
    captures = (stack.captures, stack.cascade_captures)
    built = []
    real_build = stack._build_step

    def build_step(key, data, ivf):
        built.append(key)
        return real_build(key, data, ivf)

    stack._build_step = build_step
    zero_counters()
    producer = threading.Thread(target=produce, name="registry-producer", daemon=True)
    producer.start()
    try:
        def drained(phase):
            co.drain_live()
            return errors or co.phase == phase
        wait_for(lambda: drained("ready"), 60, "the v2 parity gate")
        parity = dict(samples=co.parity.samples, agreement=co.parity.agreement)
        t_cut0 = time.perf_counter()
        co.cutover()
        t_cut1 = time.perf_counter()
        wait_for(lambda: drained("done"), 60, "the v2 watch")
        n_at = len(published)
        wait_for(lambda: errors or len(published) >= n_at + REG_AFTER_BATCHES * BATCH, 60,
                 "batches after the v2 cutover")
        # v3 (no face anywhere): the parity gate refuses it
        co3 = RegistrySwapCoordinator(state, registry, "detector", 3,
                                      old_detect_fn=boxes_fn(dets[2]),
                                      new_detect_fn=boxes_fn(dets[3]), params_path=paths[3],
                                      parity_min_samples=REG_PARITY_SAMPLES, metrics=metrics)
        co3.score_parity(frames[:REG_PARITY_SAMPLES])
        try:
            co3.cutover()
            raise AssertionError("registry: the degraded v3 was not refused")
        except RolloutGateError:
            pass
    finally:
        stop.set()
        producer.join(timeout=60)
        service.drain(timeout=120)
        service.stop()
        del stack._build_step, stack.install_detector_params  # the wrappers above
    if errors:
        raise AssertionError(f"registry: the producer failed: {errors}")
    launches = read_launches()
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"registry: a kernel did not launch while serving: {launches}")
    if (metrics.counter(mn.REGISTRY_SWAPS_BLOCKED) != 1 or registry.version("detector") != 2
            or co.phase != "done"):
        raise AssertionError(f"registry: blocked {metrics.counter(mn.REGISTRY_SWAPS_BLOCKED)}, "
                             f"served v{registry.version('detector')}, phase {co.phase}")
    if built or (stack.captures, stack.cascade_captures) != captures:
        raise AssertionError(f"registry: graphs captured during the swap: {built}")
    # in publish order the results' and the batches' stamps move 1 -> 2 once,
    # and each result carries its batch's (a tick split across two batches
    # at the install may carry both)
    stamps = [v for _t, _k, _j, v, _m in published]
    batch_of = {key: v for v, keys in batches for key in keys}
    if (not stamps_move_once(stamps, 1, 2) or not stamps_move_once([v for v, _k in batches],
                                                                    1, 2)
            or any(batch_of.get((tick, j)) != v for _t, tick, j, v, _m in published)):
        raise AssertionError(f"registry: detector stamps mixed: {stamps[:8]} ... {stamps[-8:]}; "
                             f"batches {[v for v, _k in batches][:4]} ... "
                             f"{[v for v, _k in batches][-4:]}")
    # each result against a direct call of the version it names
    direct = {}
    for version, params in ((1, v1), (2, v2)):
        stack.install_detector_params(params, version=version)
        for base in range(n_bases):
            direct[(base, version)] = unpack_result(stack.recognize_batch_packed(
                frames[base * BATCH:(base + 1) * BATCH]).cpu().numpy(), 1)
    differ = sum(face_rows(direct[(b, 1)], j, 0.3) != face_rows(direct[(b, 2)], j, 0.3)
                 for b in range(n_bases) for j in range(BATCH))
    for _t, tick, j, v, m in published:
        if published_rows(m) != face_rows(direct[(tick % n_bases, v)], j, 0.3):
            raise AssertionError(f"registry: result {(tick, j)} stamped v{v} differs from a "
                                 f"direct call of v{v}")
    done = {}
    for t_arr, tick, _j, _v, _m in published:
        done[tick] = max(done.get(tick, 0.0), t_arr)
    during = [(done[k] - sent[k]) * 1e3 for k in done if k in sent
              and sent[k] <= t_cut1 and done[k] >= t_cut0]
    other = [(done[k] - sent[k]) * 1e3 for k in done if k in sent
             and not (sent[k] <= t_cut1 and done[k] >= t_cut0)]
    out = dict(parity=parity, cutover_s=t_cut1 - t_cut0,
               cutover_stages_s={k: sum(t.seconds) for k, t in timers.items()},
               batch_ms_during_cutover=dict(worst=max(during or [0.0]), n=len(during)),
               batch_ms_otherwise=dict(p50=_pct(other, 50), worst=max(other or [0.0]),
                                       n=len(other)),
               results=len(stamps), results_v1=stamps.count(1), results_v2=stamps.count(2),
               frames_v1_v2_differ=differ, blocked=metrics.counter(mn.REGISTRY_SWAPS_BLOCKED),
               v3_agreement=co3.parity.agreement, launches=launches, ledger=service.ledger())
    stack.install_detector_params(v2, version=2)
    return out, state, injector, dets, v1


def registry_recovery(dev, root: str, state, injector, dets) -> dict:
    """Phase 13 (b), the crash checks: a swap to v4 dying after its fence
    is completed by ``recover``; one to v5 with its staged file damaged is
    abandoned and v5 retired."""
    out = {}
    for version, damage in ((4, False), (5, True)):
        path = registry_params_path(root, "detector", version)
        dets[4].save(path)
        injector.script("cutover", "crash_after_record")
        try:
            state.perform_registry_cutover("detector", version, params_path=path,
                                           params_sha256=_file_sha256(path))
            raise AssertionError(f"registry: the crash after the v{version} fence did not fire")
        except InjectedCrashError:
            pass
        state.close()
        if ModelRegistry(root, readonly=True).version("detector") == version:
            raise AssertionError("registry: the manifest moved before recovery")
        if damage:
            with open(path, "r+b") as f:
                f.seek(16)
                f.write(b"\x00" * 16)
        state = StateLifecycle(root, fault_injector=injector)
        t = time.perf_counter()
        report = state.recover(ShardedGallery(8, DIM, store_dtype=torch.bfloat16, device=dev), [])
        out[f"recover_v{version}_s"] = time.perf_counter() - t
        manifest = ModelRegistry(root, readonly=True)
        if damage:
            ok = (manifest.version("detector") == 4
                  and manifest.describe("detector").get("retired") == version
                  and [e["to_version"] for e in report.get("abandoned_registry_swaps", [])]
                  == [version])
        else:
            ok = (manifest.version("detector") == version
                  and [e["to_version"] for e in report.get("completed_registry_swaps", [])]
                  == [version])
        if not ok:
            raise AssertionError(f"registry: recovery of the v{version} fence: "
                                 f"{manifest.stamp()} {report}")
    state.close()
    out["manifest"] = ModelRegistry(root, readonly=True).stamp()
    return out


def registry_cli(dev, paths: dict, root: str, gate, thr: float, frames, keep) -> dict:
    """Phase 13 (c): ``--registry-swap cascade=2`` offline, then the CLI on
    a socket with ``--cascade PATH --cascade-version 2``."""
    gate_path = registry_params_path(root, "cascade", 2)
    os.makedirs(os.path.dirname(gate_path), exist_ok=True)
    saved = cascade_mod.FaceGate(threshold=thr, device=dev)
    saved.load_params(gate.params)
    saved.save(gate_path)
    t = time.perf_counter()
    if recognize_app.main(["--registry-swap", "cascade=2", "--state-dir", root]) != 0:
        raise AssertionError("registry: the offline swap failed")
    swap_s = time.perf_counter() - t
    if ModelRegistry(root, readonly=True).version("cascade") != 2:
        raise AssertionError("registry: the offline swap did not install cascade v2")
    metrics_path = os.path.join(root, "cli_metrics.jsonl")
    cli = SocketCli(paths, dev, ["--state-dir", root, "--capacity", str(CLI_STATE_CAPACITY),
                                 "--cascade", gate_path,
                                 "--cascade-version", "2", "--ingest-mode", "uint8",
                                 "--bucket-sizes", *map(str, CASC_LADDER)], metrics_path)
    try:
        b64 = [base64.b64encode(np.ascontiguousarray(f).tobytes()).decode("ascii")
               for f in frames]
        for i, line in enumerate(b64):
            cli.send(_frame_line(line, {"_fid": i}, "interactive"))
        wait_for(lambda: cli.n_answered() >= len(frames), 120, "the CLI's answers")
    finally:
        rec = cli.stop()
    with cli._lock:
        exits = {r["meta"]["_fid"] for r in cli.results if r.get("exit") == "cascade"}
    want = {i for i in range(len(frames)) if not keep[i]}
    _close_ledger("cascade cli", rec["ledger"])
    if exits != want or rec["ledger"]["completed_empty"] != len(want):
        raise AssertionError(f"cascade cli: rejects {sorted(exits)} != {sorted(want)}; "
                             f"{rec['ledger']}")
    delta = _check_serving(dev, "cascade cli", rec)
    if rec["cascade_captures"] != rec["warm"]["cascade_captures"]:
        raise AssertionError("cascade cli: a stage-1 graph was captured after warmup")
    return dict(offline_swap_s=swap_s, answered=len(cli.answered), rejects=len(exits),
                ledger=rec["ledger"], **delta)


def cascade_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 13 (module docstring); returns the ``{"cascade": ...}`` numbers."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cascade_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stack = ctx["stack"]
    gate = cascade_mod.FaceGate(device=dev, generator=torch.Generator().manual_seed(seed + 13))
    gate_cpu = cascade_mod.FaceGate(dtype=torch.float32, device="cpu")
    gate_cpu.load_params({k: v.cpu() for k, v in gate.params.items()})
    pool = np.stack([f for f, _n in synthetic_frame_stream(
        CASC_CANDIDATES, FRAME, face_density=0.5, seed=seed + 13)])
    scores = gate_cpu.score_batch(pool).numpy()
    n_keep = sum(CASC_SURVIVORS)
    thr = choose_threshold(scores, n_keep, len(CASC_SURVIVORS) * BATCH - n_keep)
    batches = cascade_batches(pool, scores, thr, seed + 13)
    stack.install_cascade(gate, version=1)
    t = time.perf_counter()
    served = cascade_serve(dev, stack, batches, thr)
    serve_s = time.perf_counter() - t
    checks = cascade_direct(dev, stack, gate_cpu, batches, thr, served.pop("results"))
    times = stage1_times(dev, stack, batches[-1][0]) if dev.type == "cuda" else {}
    log(f"cascade ({card}): threshold {thr:.5f}, stage 1 {times}, {checks}, "
        f"step ms {served['step_ms']}")
    t = time.perf_counter()
    swap, state, injector, dets, v1 = registry_live_swap(
        dev, stack, ctx["frames"][:len(ctx["frames"]) // BATCH * BATCH],
        os.path.join(root, "state"))
    swap_s = time.perf_counter() - t
    dets[4] = detector_with(dev, perturbed(v1, 14, REG_PERTURB))
    t = time.perf_counter()
    recovery = registry_recovery(dev, os.path.join(root, "state"), state, injector, dets)
    recovery_s = time.perf_counter() - t
    log(f"registry ({card}): {json.dumps(swap)} {json.dumps(recovery)}")
    stack.install_detector_params({k: v.to(dev) for k, v in v1.items()}, version=1)
    t = time.perf_counter()
    cli_paths = ctx.get("cli_paths") or write_cli_inputs(
        dev, seed, os.path.join(root, "cli_inputs"))[0]
    frames, keep = (np.concatenate([b[0] for b in batches[1:]]),
                    np.concatenate([b[1] for b in batches[1:]]))
    cli = registry_cli(dev, cli_paths, os.path.join(root, "cli_state"), gate, thr,
                       frames[:CASC_CLI_FRAMES], keep[:CASC_CLI_FRAMES])
    cli_s = time.perf_counter() - t
    stack.install_cascade(None)
    out = dict(card=card, threshold=thr, score_atol=CASC_SCORE_ATOL, margin=CASC_MARGIN,
               stage1=times, **checks, **served, serve_s=serve_s, swap=swap, swap_s=swap_s,
               recovery=recovery, recovery_s=recovery_s, cli=cli, cli_s=cli_s,
               phase_s=time.perf_counter() - t_phase)
    log(f"cascade ({card}): {json.dumps(out)}")
    return out


# ---- phase 14: read replicas, the topic router and the verifier ----


class _Ticks:
    """A producer of one batch every REPL_TICK_S into each connector it
    feeds (``paused`` holds one), and each service's published results:
    (arrival, tick, j, message) by connector name."""

    def __init__(self, conns: dict, frames: np.ndarray):
        self.conns = conns
        self.messages = [encode_frame(f) for f in frames]
        self.sent = {}  # tick -> host clock of its first inject
        self.published = {name: [] for name in conns}
        self.paused = {name: threading.Event() for name in conns}
        self.stop, self.errors = threading.Event(), []
        for name, conn in conns.items():
            conn.subscribe(RESULT_TOPIC, lambda _t, m, n=name: self.published[n].append(
                (time.perf_counter(), m["meta"].get("tick"), m["meta"].get("j"), m)))
        self.thread = threading.Thread(target=self._run, name="replication-producer",
                                       daemon=True)

    def _run(self):
        tick = 0
        try:
            while not self.stop.is_set():
                t = time.perf_counter()
                for name, conn in self.conns.items():
                    if self.paused[name].is_set():
                        continue
                    self.sent.setdefault(tick, t)
                    for j, message in enumerate(self.messages):
                        conn.inject(FRAME_TOPIC, {**message, "meta": {"tick": tick, "j": j}})
                tick += 1
                time.sleep(max(0.0, REPL_TICK_S - (time.perf_counter() - t)))
        except Exception as e:  # noqa: BLE001 - reported by the phase
            self.errors.append(e)

    def tick_ms(self, name: str, windows=None) -> list:
        """Host ms from a tick's inject to its last result at ``name``, for
        the ticks sent inside one of ``windows`` ((t0, t1) pairs) if given."""
        done = {}
        for t_arr, tick, _j, _m in self.published[name]:
            if tick is not None:
                done[tick] = max(done.get(tick, 0.0), t_arr)
        return [(done[k] - self.sent[k]) * 1e3 for k in done if k in self.sent and (
            windows is None or any(a <= self.sent[k] <= b for a, b in windows))]


def _wrap_calls(obj, name: str, keep=lambda result: True) -> list:
    """Wraps ``obj.name``: each call's (start, seconds, result) for which
    ``keep(result)`` holds goes into the returned list."""
    calls = []
    real = getattr(obj, name)

    def wrapped(*args, **kwargs):
        t = time.perf_counter()
        result = real(*args, **kwargs)
        if keep(result):
            calls.append((t, time.perf_counter() - t, result))
        return result

    setattr(obj, name, wrapped)
    return calls


def faced_frames(stack, frames: np.ndarray, n: int) -> np.ndarray:
    """The indices of the first ``n`` frames in which ``stack``'s detector
    finds a face."""
    _b, _s, valid = stack.detector.detect_batch(frames.astype(np.float32))
    keep = np.flatnonzero(valid.cpu().numpy().any(axis=1))[:n]
    if len(keep) < n:
        raise AssertionError(f"replication: only {len(keep)} frames with a face")
    return keep


def galleries_equal(a, b, what: str) -> None:
    """Host mirrors (rows, labels) and device state (rows, labels, valid
    flags) of two galleries equal bit for bit, at one size and capacity."""
    ea, la, na = a.snapshot_rows(0, None)
    eb, lb, nb = b.snapshot_rows(0, None)
    da, db = a.data, b.data
    if (na != nb or a.capacity != b.capacity or not np.array_equal(ea, eb)
            or not np.array_equal(la, lb)
            or not torch.equal(da.embeddings[:na], db.embeddings[:nb])
            or not torch.equal(da.labels, db.labels) or not torch.equal(da.valid, db.valid)):
        raise AssertionError(f"replication: {what}: the reader's gallery ({nb} rows of "
                             f"{b.capacity}) differs from the writer's ({na} of {a.capacity})")


def replication_inproc(dev, seed: int, card: str, ctx: dict, root: str) -> dict:
    """Phase 14 (a): a writer and a reader service over one state dir on
    the card; enrolment and its tail, compaction, an abort after apply and
    a detector swap the reader re-anchors onto (module docstring)."""
    from opencv_facerecognizer_tpu_torch.apps import verify_checkpoint
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        ReadReplica, pipeline_model_installer)

    stack, rows, labels = ctx["stack"], ctx["rows"], ctx["labels"]
    v1 = {k: t.detach().clone() for k, t in stack.detector.params.items()}
    v2 = perturbed(v1, 13, REG_PERTURB)  # phase 13's v2

    def pipeline_over(gallery):
        return RecognitionPipeline(detector_with(dev, v1), stack.embed_net, gallery,
                                   face_size=embedder_mod.SERVING_FACE_SIZE,
                                   fused_embedder=True, device=dev)

    # the 2^20-row tier with REPL_HEADROOM rows free (random rows dropped,
    # the planted faces kept), so the enrolments append within the tier
    g_w = ShardedGallery(GALLERY_ROWS, DIM, store_dtype=torch.bfloat16, device=dev)
    g_w.add(rows[REPL_HEADROOM:], labels[REPL_HEADROOM:])
    pipe_w = pipeline_over(g_w)
    state = StateLifecycle(root, keep_checkpoints=2, checkpoint_wal_rows=1 << 30,
                           checkpoint_every_s=1e9)
    registry = ModelRegistry(root)
    state.attach_registry(registry)
    metrics_w, conn_w = Metrics(), FakeConnector()
    names_w = [f"planted_{i}" for i in range(ctx["n_plant"])]
    service_w = RecognizerService(pipe_w, conn_w, batch_size=BATCH, frame_shape=FRAME,
                                  flush_timeout=0.01, ingest=IngestConfig("uint8"),
                                  state_store=state, metrics=metrics_w, subject_names=names_w)
    service_w.registry = registry
    wal_s = timed_wal_appends(state)
    t = time.perf_counter()
    if not state.checkpoint_now(wait=True):
        raise AssertionError("replication: the writer's first checkpoint failed")
    first_ckpt_s = time.perf_counter() - t

    g_r = ShardedGallery(8, DIM, store_dtype=torch.bfloat16, device=dev)
    pipe_r = pipeline_over(g_r)
    metrics_r, conn_r, names_r = Metrics(), FakeConnector(), []
    replica = ReadReplica(root, g_r, names_r, metrics=metrics_r, poll_interval_s=REPL_POLL_S,
                          name="reader")
    replica.registry = ModelRegistry(root, metrics=metrics_r, readonly=True)
    replica.install_model = pipeline_model_installer(pipe_r)
    resyncs = _wrap_calls(replica, "resync")
    resync_drops = []  # the reader's batcher overflow during each resync
    counted_resync = replica.resync

    def resync_counting_drops():
        before = metrics_r.counter(mn.BATCHER_DROPPED_OVERFLOW)
        try:
            return counted_resync()
        finally:
            resync_drops.append(metrics_r.counter(mn.BATCHER_DROPPED_OVERFLOW) - before)

    replica.resync = resync_counting_drops
    applies = _wrap_calls(replica, "poll", keep=lambda r: bool(r and r.get("rows")))
    parks = _wrap_calls(replica, "_park")
    applied_at, lags = {}, []  # WAL seq -> host clock once applied; lag_s per apply
    real_apply = replica._apply_records

    def apply_records(records):
        out = real_apply(records)
        t_done = time.perf_counter()
        for seq in range(replica._anchor_seq + 1, replica.applied_seq + 1):
            applied_at.setdefault(seq, t_done)
        if out["rows"]:
            lags.append(replica.lag_s)
        return out

    replica._apply_records = apply_records
    t = time.perf_counter()
    first_sync = replica.resync()
    first_resync = dict(replica.last_resync_s, seconds=time.perf_counter() - t)
    galleries_equal(g_w, g_r, "the first resync")
    if replica.embedder_version != 1 or names_r != names_w:
        raise AssertionError(f"replication: first resync {first_sync}, names {names_r[:4]}")
    service_r = RecognizerService(pipe_r, conn_r, batch_size=BATCH, frame_shape=FRAME,
                                  flush_timeout=0.01, ingest=IngestConfig("uint8"),
                                  metrics=metrics_r, replica=replica)
    service_r.subject_names = names_r
    service_r.registry = replica.registry
    replica.on_registry_change = service_r.flush_model_caches

    pool = ctx["frames"][BATCH:]
    keep = faced_frames(stack, pool, REPL_SUBJECTS)
    subjects = pool[keep]
    others = np.delete(pool, keep, axis=0)
    batch = np.concatenate([subjects, others[:BATCH - len(subjects)]])
    ticks = _Ticks({"writer": conn_w, "reader": conn_r}, batch)
    enrolled_at = {}  # subject -> (host clock of its 'enrolled', WAL seq)
    conn_w.subscribe(STATUS_TOPIC, lambda _t, m: enrolled_at.setdefault(
        m.get("subject"), (time.perf_counter(), state.wal_seq))
        if m.get("status") == "enrolled" else None)
    follow = {}
    out = dict(card=card, rows=GALLERY_ROWS, first_checkpoint_s=first_ckpt_s,
               first_resync_s=first_resync)
    service_w.start(warmup=True)
    service_r.start(warmup=True)
    captures_r = (pipe_r.captures, pipe_r.recaptures)
    ticks.thread.start()
    n_parks = 0
    try:
        # 1. enrolment and its tail; the writer's producer holds meanwhile,
        # so each enrolment takes its subject's frame
        ticks.paused["writer"].set()
        follower = threading.Thread(target=lambda: follow.update(verify_checkpoint.follow_wal(
            root, duration_s=REPL_FOLLOW_S, poll_s=0.05)), daemon=True)
        t_enrol = time.perf_counter()
        for i, frame in enumerate(subjects):
            if i == len(subjects) - REPL_FOLLOW_LAST:
                follower.start()
            subject = f"replica_{i}"
            wait_for(lambda: time.perf_counter() >= t_enrol + i * REPL_ENROL_EVERY_S, 10,
                     "the enrolment tick", poll=0.002)
            conn_w.inject(CONTROL_TOPIC, {"cmd": "enroll", "subject": subject, "count": 1})
            conn_w.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"enrol": subject}})
            wait_for(lambda: ticks.errors or subject in enrolled_at, 60, f"{subject} enrolled")
        enrol_s = time.perf_counter() - t_enrol
        wait_for(lambda: replica.applied_seq == state.wal_seq and replica.lag_rows == 0, 30,
                 "the reader's tail")

        follower.join(timeout=REPL_FOLLOW_S + 30)
        # visible: the ack to the reader's first result naming the subject
        # (a random embedder names some subjects on no frame at all), and
        # the ack to the reader's apply of the row
        named_at = {}
        for t_arr, _k, _j, m in list(ticks.published["reader"]):
            for f in m["faces"]:
                if f["name"] in enrolled_at and t_arr >= enrolled_at[f["name"]][0]:
                    named_at.setdefault(f["name"], t_arr)
        visible = [(t - enrolled_at[s][0]) * 1e3 for s, t in named_at.items()]
        applied = [(applied_at[seq] - t) * 1e3 for t, seq in enrolled_at.values()]
        ticks.paused["reader"].set()
        service_r.drain(timeout=120)
        service_w.drain(timeout=120)
        galleries_equal(g_w, g_r, "after the tail")
        if names_r != list(service_w.subject_names):
            raise AssertionError(f"replication: names differ: {names_r[-4:]} vs "
                                 f"{service_w.subject_names[-4:]}")
        if (pipe_r.captures, pipe_r.recaptures) != captures_r:
            raise AssertionError("replication: the reader captured a graph for appends "
                                 "within its tier")
        # one batch holding each subject's frame: equal on both services and
        # to a direct call
        for conn in (conn_w, conn_r):
            _inject_batch(conn, batch, {"check": 1})
        wait_for(lambda: all(sum(1 for *_x, m in list(ticks.published[n])
                                 if m["meta"].get("check")) == BATCH
                             for n in ("writer", "reader")), 60, "the check batch")
        direct = unpack_result(pipe_r.recognize_batch_packed(batch).cpu().numpy(), 1)
        got = {n: {m["meta"]["j"]: m for *_x, m in ticks.published[n] if m["meta"].get("check")}
               for n in ("writer", "reader")}
        for j in range(BATCH):
            w, r = got["writer"][j], got["reader"][j]
            if w["faces"] != r["faces"] or published_rows(r) != face_rows(direct, j, 0.3):
                raise AssertionError(f"replication: check frame {j}: writer {w['faces']} "
                                     f"reader {r['faces']}")
        named = sorted({f["name"] for m in got["reader"].values() for f in m["faces"]}
                       & set(enrolled_at))
        n_status = len(conn_r.messages(STATUS_TOPIC))
        conn_r.inject(CONTROL_TOPIC, {"cmd": "enroll", "subject": "nope", "count": 1})
        refused = [m for m in conn_r.messages(STATUS_TOPIC)[n_status:]
                   if m.get("reason") == "read_replica"]
        if len(refused) != 1 or metrics_r.counter(mn.REPLICATION_ENROLL_REJECTED) != 1:
            raise AssertionError("replication: an enrol on the reader was not refused")
        out.update(subjects=len(enrolled_at), enrol_s=enrol_s, named_in_check=len(named),
                   visible_ms=dict(p50=_pct(visible, 50), max=max(visible or [float("nan")]),
                                   n=len(visible)),
                   applied_ms=dict(p50=_pct(applied, 50), max=max(applied), n=len(applied)),
                   follow={k: follow.get(k) for k in (
                       "ok", "valid_records", "valid_rows", "corrupt_records", "polls")})
        if not follow.get("ok") or follow.get("valid_records") != len(enrolled_at):
            raise AssertionError(f"replication: --follow saw {follow}")
        # a copy of the dir for the verifier's flipped byte, before the
        # compaction empties the WAL (hard links: checkpoints never change)
        copy = root + "_copy"
        shutil.copytree(root, copy, copy_function=os.link,
                        ignore=shutil.ignore_patterns("enroll.wal", "*.lease"))
        shutil.copy2(os.path.join(root, "enroll.wal"), os.path.join(copy, "enroll.wal"))
        out["copy"] = copy
        ticks.paused["writer"].clear()
        ticks.paused["reader"].clear()

        # 2. compaction: the checkpoint truncates the WAL; the tailer reopens
        # and, its rows covered, does not resync
        reopens, n_resync = replica.tailer.reopens, len(resyncs)
        t = time.perf_counter()
        if not state.checkpoint_now(wait=True):
            raise AssertionError("replication: the compaction checkpoint failed")
        out["compaction_checkpoint_s"] = time.perf_counter() - t
        wait_for(lambda: replica.tailer.reopens > reopens, 30, "the tailer's reopen")
        time.sleep(3 * REPL_POLL_S)
        if len(resyncs) != n_resync:
            raise AssertionError("replication: a covered compaction forced a resync")

        # 3. an abort after apply: the writer's apply fails after the reader
        # applied the row; the tombstone forces one resync
        phantom = _unit_rows(np.random.default_rng(seed + 14).standard_normal((1, DIM)))

        def failing_apply():
            seq = state.wal_seq
            wait_for(lambda: replica.applied_seq >= seq, 30, "the reader applying the row")
            raise RuntimeError("the writer's apply fails after the reader applied the row")

        n_resync = len(resyncs)
        try:
            state.append_enrollment(phantom.astype(np.float32),
                                    np.full(1, len(names_w), np.int32), subject="phantom",
                                    label=len(names_w), apply_fn=failing_apply)
            raise AssertionError("replication: the failing apply did not raise")
        except RuntimeError as exc:
            if "fails after" not in str(exc):
                raise
        wait_for(lambda: len(resyncs) == n_resync + 1, 60, "the abort's resync")
        if metrics_r.counter(mn.REPLICATION_ABORTS_AFTER_APPLY) != 1:
            raise AssertionError("replication: the abort after apply was not counted")
        abort_resync = dict(replica.last_resync_s, seconds=resyncs[-1][1])
        ticks.paused["writer"].set()
        ticks.paused["reader"].set()
        service_w.drain(timeout=120)
        service_r.drain(timeout=120)
        galleries_equal(g_w, g_r, "after the abort's resync")
        ticks.paused["writer"].clear()
        ticks.paused["reader"].clear()
        t_step4 = time.perf_counter()
        wait_for(lambda: any(t_arr > t_step4 for t_arr, *_x in ticks.published["reader"]),
                 30, "reader results before the swap")

        # 4. a detector swap on the writer, v1 -> v2; the reader parks on the
        # fence, re-anchors on the covering checkpoint and installs v2
        path_v2 = registry_params_path(root, "detector", 2)
        os.makedirs(os.path.dirname(path_v2), exist_ok=True)
        detector_with(dev, v2).save(path_v2)
        co = RegistrySwapCoordinator(
            state, registry, "detector", 2, old_detect_fn=boxes_fn(detector_with(dev, v1)),
            new_detect_fn=boxes_fn(detector_with(dev, v2)), params_path=path_v2,
            install_fn=lambda: pipe_w.install_detector_params(v2, version=2),
            flush_fn=service_w.flush_model_caches, parity_min_samples=REG_PARITY_SAMPLES,
            metrics=metrics_w)
        co.score_parity(batch[:REG_PARITY_SAMPLES])
        n_resync, n_parks = len(resyncs), len(parks)
        real_checkpoint = state.checkpoint_now

        def checkpoint_after_the_park(wait=False):
            # the swap's forced checkpoint lands once the reader has parked
            # on the fence (else a fast checkpoint lets it skip the park)
            wait_for(lambda: len(parks) > n_parks, 30, "the reader parking on the fence")
            return real_checkpoint(wait=wait)

        state.checkpoint_now = checkpoint_after_the_park
        t_swap = time.perf_counter()
        try:
            co.cutover()
        finally:
            state.checkpoint_now = real_checkpoint
        swap_s = time.perf_counter() - t_swap
        wait_for(lambda: len(resyncs) == n_resync + 1, 60, "the reader's re-anchor")
        t_swapped = time.perf_counter()
        wait_for(lambda: any(t_arr > t_swapped for t_arr, *_x in ticks.published["reader"]),
                 30, "reader results after the re-anchor")

        # 5. the reader's path launches the kernels: with the writer idle
        # and both drained, the counts are set to 0 and the reader alone
        # serves REPL_ALONE_BATCHES batches (no direct call, no parity
        # detection inside)
        ticks.paused["writer"].set()
        ticks.paused["reader"].set()
        service_w.drain(timeout=120)
        service_r.drain(timeout=120)
        n_alone = len(ticks.published["reader"])
        zero_counters()
        ticks.paused["reader"].clear()
        wait_for(lambda: len(ticks.published["reader"]) >= n_alone + REPL_ALONE_BATCHES * BATCH,
                 60, "the reader serving alone")
        ticks.paused["reader"].set()
        service_r.drain(timeout=120)
        launches = read_launches()
    finally:
        ticks.stop.set()
        ticks.thread.join(timeout=60)
        for service in (service_w, service_r):
            service.drain(timeout=120)
            service.stop()
    if ticks.errors:
        raise AssertionError(f"replication: the producer failed: {ticks.errors}")
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"replication: a kernel did not launch on the reader's path: "
                             f"{launches}")
    if len(parks) <= n_parks or replica.registry.version("detector") != 2:
        raise AssertionError(f"replication: the reader did not park on the fence or does not "
                             f"serve v{replica.registry.version('detector')}")
    galleries_equal(g_w, g_r, "after the re-anchor")
    # the reader's detector stamps in publish order move 1 -> 2 once, and
    # each result from the swap on equals a direct call of its version
    stamped = [(t_arr, m) for t_arr, tick, _j, m in ticks.published["reader"]
               if tick is not None and t_arr > t_step4]
    stamps = [(m.get("registry") or {}).get("detector") for _t, m in stamped]
    if not stamps_move_once(stamps, 1, 2):
        raise AssertionError(f"replication: reader stamps {stamps[:6]} ... {stamps[-6:]}")
    direct = {}
    for version, params in ((1, v1), (2, v2)):
        pipe_r.install_detector_params(params, version=version)
        direct[version] = unpack_result(pipe_r.recognize_batch_packed(batch).cpu().numpy(), 1)
    for _t, m in stamped:
        v = m["registry"]["detector"]
        if published_rows(m) != face_rows(direct[v], m["meta"]["j"], 0.3):
            raise AssertionError(f"replication: reader result {m['meta']} stamped v{v} differs "
                                 f"from a direct call of v{v}")
    windows = [(t0, t0 + dt) for t0, dt, _r in resyncs[1:]]
    during = ticks.tick_ms("reader", windows)
    # each serving resync: the longest gap between two of the reader's
    # results around it, and the frames its batcher dropped meanwhile
    arrivals = sorted(t_arr for t_arr, *_x in ticks.published["reader"])
    stalls = [dict(seconds=t1 - t0, dropped=dropped, longest_gap_ms=1e3 * max(
        (b - a for a, b in zip(arrivals, arrivals[1:]) if b >= t0 and a <= t1), default=0.0))
        for (t0, t1), dropped in zip(windows, resync_drops[1:])]
    apply_ms = [dt * 1e3 for _t, dt, _r in applies]
    wal_ms = np.asarray(wal_s) * 1e3
    out.update(
        launches=launches, abort_resync_s=abort_resync,
        reanchor_resync_s=dict(replica.last_resync_s, seconds=resyncs[-1][1]),
        resyncs=len(resyncs), parks=len(parks), swap_s=swap_s,
        swap_stamps=dict(v1=stamps.count(1), v2=stamps.count(2)),
        poll_apply_ms=dict(p50=_pct(apply_ms, 50), max=max(apply_ms or [0.0]), n=len(apply_ms)),
        lag_s=dict(p50=_pct(lags, 50), max=max(lags or [0.0]), n=len(lags)),
        wal_append_ms=dict(p50=float(np.median(wal_ms)), max=float(wal_ms.max())),
        reader_tick_ms=dict(p50=_pct(ticks.tick_ms("reader"), 50),
                            worst_during_resync=max(during or [0.0]), n_during=len(during)),
        reader_resync_stalls=stalls,
        writer_tick_ms=dict(p50=_pct(ticks.tick_ms("writer"), 50)),
        reader_recaptures=pipe_r.recaptures - captures_r[1],
        reader_ledger=service_r.ledger(), writer_ledger=service_w.ledger(),
        reader_stats=replica.stats())
    state.close()
    for p in (pipe_w, pipe_r):
        drop_stack(p)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RouterCli:
    """The CLI as a topic router (``--router``) in a subprocess, on a
    socket, with one raw client: frame lines go out on camera topics;
    results (with their host-clock arrivals, by ``meta["cid"]``) and
    statuses come back."""

    def __init__(self, paths: dict, dev, endpoints: list, healths: list):
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
             *cli_args(paths, "socket", dev), "--port", "0", "--expo-port", "0",
             "--router", ",".join(endpoints), "--router-health", ",".join(healths),
             "--router-link-deadline-s", str(REPL_LINK_DEADLINE_S),
             "--router-hedge-deadline-s", str(REPL_HEDGE_DEADLINE_S)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=env)
        self.err, self.answers, self.statuses = [], {}, []
        self._lock = threading.Lock()
        threading.Thread(target=lambda: self.err.extend(self.proc.stderr), daemon=True).start()
        self.port = int(self.stderr_value("serving on ", 120).rsplit(":", 1)[1])
        self.expo = int(self.stderr_value("router expo endpoint: ", 30)
                        .rstrip("/").rsplit(":", 1)[1])
        self.sock = socket.create_connection(("127.0.0.1", self.port), timeout=30)
        self.sock.settimeout(None)
        threading.Thread(target=self._read, daemon=True).start()

    stderr_value = SocketCli.stderr_value

    def _read(self) -> None:
        for line in self.sock.makefile("r", encoding="utf-8"):
            msg = json.loads(line)
            now = time.perf_counter()
            with self._lock:
                if msg["topic"] == RESULT_TOPIC:
                    cid = (msg["data"].get("meta") or {}).get("cid")
                    if cid is not None:
                        self.answers.setdefault(cid, []).append((now, msg["data"]))
                elif msg["topic"] == STATUS_TOPIC:
                    self.statuses.append(msg["data"])

    def send(self, topic: str, b64: str, cid, priority: str = "interactive") -> None:
        line = _frame_line(b64, {"cid": cid}, priority)
        self.sock.sendall(line.replace(f'"topic": "{FRAME_TOPIC}"'.encode(),
                                       f'"topic": "{topic}"'.encode(), 1))

    def send_control(self, data: dict) -> None:
        self.sock.sendall((json.dumps({"topic": CONTROL_TOPIC, "data": data}) + "\n").encode())

    def answered(self, cids) -> bool:
        with self._lock:
            return all(c in self.answers for c in cids)

    def replicas(self) -> list:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.expo}/replicas", timeout=10) as r:
            return json.loads(r.read())["replicas"]

    def stop(self) -> dict:
        """SIGTERM; the router's counters and registry from its stderr."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.sock.close()
        if rc != 0:
            raise AssertionError(f"the router exited {rc}: {''.join(self.err[-20:])}")
        return dict(counters=json.loads(self.stderr_value("router metrics: ", 5)),
                    registry=json.loads(self.stderr_value("router registry at shutdown: ", 5)),
                    cuda=self.stderr_value("router holds a CUDA context: ", 5))


def compute_apps() -> list:
    """One pid per process holding a CUDA context on the card
    (``nvidia-smi``; inside a container the pids may not be this
    namespace's, so callers compare counts)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _paced_send(n: int, rate: float, send) -> dict:
    """``send(i)`` for i in range(n) at ``rate`` a second; {i: send time}."""
    sent = {}
    t0 = time.perf_counter()
    for i in range(n):
        delay = t0 + i / rate - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        sent[i] = time.perf_counter()
        send(i)
    return sent


def replication_cli(dev, ctx: dict, root: str, card: str) -> dict:
    """Phase 14 (b): a writer and a reader CLI on one state dir, each on a
    socket, and a router CLI in front of both (module docstring)."""
    paths = ctx["cli_paths"]
    b64 = [base64.b64encode(np.ascontiguousarray(f).tobytes()).decode("ascii")
           for f in ctx["cli_frames"]]
    state_dir = os.path.join(root, "cli_state")
    topics = [f"camera/{k}" for k in range(REPL_TOPICS)]
    while True:
        # ports whose endpoint names split the topics between the two
        # replicas by rendezvous (each gets a quarter of them at least)
        ports = {n: (_free_port(), _free_port()) for n in ("writer", "reader")}
        names = {n: f"127.0.0.1:{ports[n][0]}" for n in ports}
        to_reader = sum(TopicRouter._weight(t, names["reader"])
                        > TopicRouter._weight(t, names["writer"]) for t in topics)
        if REPL_TOPICS // 4 <= to_reader <= REPL_TOPICS - REPL_TOPICS // 4:
            break

    def replica_cli(name, extra):
        port, expo = ports[name]
        return SocketCli(paths, dev, ["--state-dir", state_dir, "--port", str(port),
                                      "--expo-port", str(expo), "--flush-ms", "5",
                                      "--capacity", str(CLI_STATE_CAPACITY), *extra],
                         os.path.join(root, f"{name}_{time.perf_counter_ns()}.jsonl"))

    # the reader starts once the writer's first checkpoint is on disk (else
    # it would replay the WAL onto an empty gallery); both start meanwhile
    t = time.perf_counter()
    started = {}
    boot = threading.Thread(target=lambda: started.update(writer=replica_cli("writer", [])),
                            daemon=True)
    boot.start()
    wait_for(lambda: os.path.isdir(os.path.join(state_dir, "checkpoints")) and any(
        n.endswith(".ckpt") for n in os.listdir(os.path.join(state_dir, "checkpoints")))
        or not boot.is_alive(), 300, "the writer's first checkpoint")
    reader = replica_cli("reader", ["--replica-role", "reader"])
    reader_start_s = time.perf_counter() - t
    boot.join(timeout=300)
    writer = started["writer"]
    writer_start_s = time.perf_counter() - t
    router = restarted = None
    out = dict(card=card, writer_start_s=writer_start_s, reader_start_s=reader_start_s)
    apps_before = compute_apps() if dev.type == "cuda" else []
    try:
        router = RouterCli(paths, dev, [names["writer"], names["reader"]],
                           [f"http://127.0.0.1:{ports[n][1]}/health"
                            for n in ("writer", "reader")])
        # 3. a second writer on the dir (its verdict read after the traffic)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        second = subprocess.Popen(
            [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
             *cli_args(paths, "jsonl", dev), "--state-dir", state_dir],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        # R: an unpaced burst through the router
        burst = list(range(REPL_BURST))
        t0 = time.perf_counter()
        for c in burst:
            router.send(topics[c % REPL_TOPICS], b64[c % len(b64)], c)
        wait_for(lambda: router.answered(burst), 120, "the router burst")
        with router._lock:
            rate = len(burst) / (max(router.answers[c][0][0] for c in burst) - t0)
        steady = REPL_RATE_SHARE * rate
        # 4. no card for the router: routing added no process on the card
        apps_routing = compute_apps() if dev.type == "cuda" else []
        if router.proc.pid in apps_routing or len(apps_routing) != len(apps_before):
            raise AssertionError(f"replication cli: compute apps {apps_before} before the "
                                 f"router, {apps_routing} while it routes (router pid "
                                 f"{router.proc.pid})")
        # the same rate straight to the writer
        direct_sent = _paced_send(REPL_DIRECT_FRAMES, steady, lambda i: writer.send(
            _frame_line(b64[i % len(b64)], {"_fid": f"d{i}"}, "interactive")))
        wait_for(lambda: all(f"d{i}" in writer.answered for i in direct_sent), 120,
                 "the direct run")
        with writer._lock:
            direct_ms = [(writer.answered[f"d{i}"] - t) * 1e3 for i, t in direct_sent.items()]
        # as many frames at that rate through the router, both replicas up
        base = REPL_BURST
        clean = list(range(base, base + REPL_DIRECT_FRAMES))
        clean_sent = _paced_send(len(clean), steady, lambda i: router.send(
            topics[clean[i] % REPL_TOPICS], b64[clean[i] % len(b64)], clean[i]))
        wait_for(lambda: router.answered(clean), 120, "the router run")
        with router._lock:
            router_ms = [(router.answers[clean[i]][0][0] - t) * 1e3
                         for i, t in clean_sent.items()]
        # 1-2. eight topics through the router, the reader killed partway
        base = clean[-1] + 1
        traffic = list(range(base, base + REPL_TOPICS * REPL_FRAMES_PER_TOPIC))
        kill_at = int(REPL_KILL_AT * len(traffic))
        t_kill = [None]

        def send_traffic(i):
            if i == kill_at:
                reader.proc.send_signal(signal.SIGKILL)
                t_kill[0] = time.perf_counter()
            c = traffic[i]
            router.send(topics[c % REPL_TOPICS], b64[c % len(b64)], c)

        sent = _paced_send(len(traffic), steady, send_traffic)
        sent_at = {traffic[i]: t for i, t in sent.items()}
        t_kill = t_kill[0]
        t_failover = None
        deadline = time.monotonic() + 60
        while t_failover is None and time.monotonic() < deadline:
            r = {x["name"]: x for x in router.replicas()}[names["reader"]]
            if not (r["healthy"] and r["link_up"]):
                t_failover = time.perf_counter()
            time.sleep(0.01)
        if t_failover is None:
            raise AssertionError("replication cli: the router never failed the reader over")
        wait_for(lambda: router.answered(traffic), 120, "the traffic's answers")
        _out, second_err = second.communicate(timeout=300)
        if second.returncode == 0 or "writer lease" not in second_err:
            raise AssertionError(f"replication cli: a second writer started "
                                 f"(rc {second.returncode}): {second_err[-2000:]}")
        reader.proc.wait(timeout=30)
        for sock in (reader.sock, *reader.extra):
            sock.close()
        with router._lock:
            e2e_kill = [(router.answers[c][0][0] - sent_at[c]) * 1e3 for c in traffic]
        # the reader again at its ports: it resyncs, its link comes up and
        # its topics route back
        t_restart = time.perf_counter()
        restarted = replica_cli("reader", ["--replica-role", "reader"])
        restart_serving_s = time.perf_counter() - t_restart
        back = []
        cid = traffic[-1] + 1
        deadline = time.monotonic() + 120
        while not restarted.n_answered() and time.monotonic() < deadline:
            for k in range(REPL_TOPICS):
                router.send(topics[k], b64[cid % len(b64)], cid)
                back.append(cid)
                cid += 1
            time.sleep(0.1)
        if not restarted.n_answered():
            raise AssertionError("replication cli: the restarted reader got no frame")
        with restarted._lock:
            first_answer_s = min(restarted.answered.values()) - t_restart
        wait_for(lambda: router.answered(back), 120, "the frames after the restart")
        r = {x["name"]: x for x in router.replicas()}[names["reader"]]
        if not (r["healthy"] and r["link_up"] and r["topics"]):
            raise AssertionError(f"replication cli: the reader did not come back: {r}")
        # every frame answered exactly once
        every = burst + clean + traffic + back
        with router._lock:
            counts = {c: len(a) for c, a in router.answers.items()}
            firsts = {c: a[0][1] for c, a in router.answers.items()}
        if sorted(counts) != sorted(every) or any(counts[c] != 1 for c in every):
            raise AssertionError(f"replication cli: answers per frame "
                                 f"{ {c: counts.get(c, 0) for c in every if counts.get(c) != 1} }")
        # an enrolment through the router reaches the writer
        router.send_control({"cmd": "enroll", "subject": "routed_subject", "count": 1})

        def enrolled():
            if any(s.get("status") == "enrolled" for s in list(router.statuses)):
                return True
            for k in range(REPL_TOPICS):
                router.send(topics[k], b64[0], None)
            return False

        wait_for(enrolled, 120, "the routed enrolment", poll=0.2)
        enrolments = [s for s in router.statuses if s.get("status") == "enrolled"]
        if [s.get("replica") for s in enrolments] != [names["writer"]]:
            raise AssertionError(f"replication cli: enrolment statuses {enrolments}")
    finally:
        routed = router.stop() if router is not None else {}
        recs = {}
        for name, cli in (("writer", writer), ("reader", restarted)):
            if cli is not None:
                recs[name] = cli.stop()
        if reader.proc.poll() is None:
            reader.proc.kill()
    # every answer (failover, hedged and restarted-reader answers too)
    # against a direct call on the CLI's checkpoints: round r holds the
    # r-th answer of each frame index
    by_frame = {}
    for c in sorted(every):
        by_frame.setdefault(c % len(b64), []).append(c)
    check = dict(answers=0, faces=0, max_box_px=0.0, max_sim=0.0)
    for r in range(max(len(a) for a in by_frame.values())):
        idx = [i for i in sorted(by_frame) if len(by_frame[i]) > r]
        cids = [by_frame[i][r] for i in idx]
        try:
            got = cross_check_messages(ctx["cli_direct"], ctx["cli_frames"][idx],
                                       [firsts[c] for c in cids], f"replication cli round {r}")
        except AssertionError as exc:
            # which replica CLIs published each of the round's frames
            seen = {n: {(m.get("meta") or {}).get("cid") for m in list(cli.results)}
                    for n, cli in (("writer", writer), ("reader", reader),
                                   ("restarted", restarted))}
            raise AssertionError(f"{exc}; the round's frames (cid: publishers): " + ", ".join(
                f"{c}: {[n for n in seen if c in seen[n]]}" for c in cids)) from exc
        check.update(answers=check["answers"] + len(idx), faces=check["faces"] + got["faces"],
                     max_box_px=max(check["max_box_px"], got["max_box_px"]),
                     max_sim=max(check["max_sim"], got["max_sim"]))
    if check["answers"] != len(every):
        raise AssertionError(f"replication cli: {check['answers']} of {len(every)} answers "
                             f"cross-checked")
    serving = {}
    for name, rec in recs.items():
        _close_ledger(f"replication cli {name}", rec["ledger"])
        serving[name] = _check_serving(dev, f"replication cli {name}", rec)
    counters = routed["counters"]
    if routed["cuda"] != "False":
        raise AssertionError(f"replication cli: the router holds a CUDA context: {routed['cuda']}")
    out.update(rate_fps=rate, steady_fps=steady, frames=len(every),
               e2e_router_ms=dict(p50=_pct(router_ms, 50), p99=_pct(router_ms, 99),
                                  n=len(router_ms)),
               e2e_router_through_the_kill_ms=dict(p50=_pct(e2e_kill, 50),
                                                   p99=_pct(e2e_kill, 99), n=len(e2e_kill)),
               e2e_direct_ms=dict(p50=_pct(direct_ms, 50), p99=_pct(direct_ms, 99),
                                  n=len(direct_ms)),
               failover_s=t_failover - t_kill, restart_serving_s=restart_serving_s,
               restart_first_answer_s=first_answer_s, cross_check=check,
               router={k: counters.get(k, 0) for k in (
                   mn.ROUTER_ROUTED, mn.ROUTER_HEDGES, mn.ROUTER_RESULTS_DEDUPED,
                   mn.ROUTER_FAILOVERS, mn.ROUTER_RECOVERIES, mn.LINK_FAILURES,
                   mn.LINK_RECOVERIES, mn.ROUTER_HEDGE_WINS, mn.ROUTER_HEDGE_WASTED)},
               routed_by_replica={r["name"]: r["routed"] for r in routed["registry"]},
               second_writer_refused=True, compute_apps=dict(
                   before_router=len(apps_before), while_routing=len(apps_routing)),
               serving=serving)
    # within the link deadline and one 1 s health sweep (on the card; a
    # CPU rehearsal's four processes share this box's cores)
    if dev.type == "cuda" and out["failover_s"] > REPL_LINK_DEADLINE_S + 1.0:
        raise AssertionError(f"replication cli: failover took {out['failover_s']:.2f} s")
    return out


def replication_verify(root: str, copy: str):
    """Phase 14 (c): the port's verifier on (a)'s state dir (rc 0) and on
    the copy with one base64 byte of an acknowledged record flipped (rc 2),
    in two subprocesses; returns a function that waits for them and
    returns their verdicts."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    wal = os.path.join(copy, "enroll.wal")
    with open(wal) as f:
        lines = f.read().splitlines()
    k = max(i for i, line in enumerate(lines) if json.loads(line).get("kind") == "enroll")
    rec = json.loads(lines[k])
    rec["emb"] = ("B" if rec["emb"][0] != "B" else "C") + rec["emb"][1:]
    lines[k] = json.dumps(rec)
    with open(wal, "w") as f:
        f.write("\n".join(lines) + "\n")
    t = time.perf_counter()
    runs = {tag: (subprocess.Popen([sys.executable, "-m",
                                    "opencv_facerecognizer_tpu_torch.apps.verify_checkpoint",
                                    path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True, env=env), want)
            for tag, path, want in (("sound", root, 0), ("flipped", copy, 2))}
    def verdicts() -> dict:
        out = {}
        for tag, (proc, want) in runs.items():
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != want:
                raise AssertionError(f"replication verify {tag}: rc {proc.returncode}: "
                                     f"{stdout[-2000:]} {stderr[-2000:]}")
            report = json.loads(stdout)
            out[tag] = dict(rc=proc.returncode, seconds=time.perf_counter() - t,
                            checkpoints=len(report["checkpoints"]),
                            corrupt_records=(report.get("wal") or {}).get("corrupt_records"))
        return out

    return verdicts


def replication_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 14 (module docstring); returns the ``{"replication": ...}``
    numbers, (a)'s kernel launches among them."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "replication_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t = time.perf_counter()
    inproc = replication_inproc(dev, seed, card, ctx, os.path.join(root, "state"))
    inproc_s = time.perf_counter() - t
    log(f"replication (a) ({card}): {json.dumps(inproc)}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    verdicts = replication_verify(os.path.join(root, "state"), inproc.pop("copy"))
    if "cli_paths" not in ctx:
        ctx["cli_paths"], ctx["cli_frames"] = write_cli_inputs(
            dev, seed, os.path.join(root, "cli_inputs"))
    if "cli_direct" not in ctx:
        ctx["cli_direct"] = direct_pipeline(ctx["cli_paths"], dev)
    t = time.perf_counter()
    try:
        cli = replication_cli(dev, ctx, root, card)
    finally:
        verify = verdicts()  # the verifiers ran beside (b)
    cli_s = time.perf_counter() - t
    log(f"replication (b) ({card}): {json.dumps(cli)}")
    log(f"replication (c) ({card}): {json.dumps(verify)}")
    return dict(card=card, inproc=inproc, inproc_s=inproc_s, cli=cli, cli_s=cli_s,
                verify=verify, phase_s=time.perf_counter() - t_phase)

# ---------- phase 15: multi-GPU (ROADMAP A.11) ----------

#: phase 15 (a): (dp, tp) meshes over slots of one card, and the k checked
MG_MESHES = ((1, 2), (1, 4), (2, 2))
MG_KS = (1, 5, 17)
#: phase 15's slots on one card: the CLI's device count for its layout
#: over 8 cards, (4, 2), split into two (2, 2) stage meshes
MG_SLOTS = 8
MG_STREAM_BATCHES = 16
MG_TIME_BATCHES = 20
#: phase 15 (a): the sparse layout's valid rows (all in shard 0, fewer
#: than k in the others)
MG_SPARSE_ROWS = 3
#: phase 15 (d): the fused step's (dp, tp) meshes over slots of the card,
#: and its service's ladder (``--bucket-sizes``)
MG_FUSED_MESHES = ((1, 2), (2, 2))
MG_FUSED_LADDER = (1, 8, 32)




def _pod_vs_single(q, g, valid, labels, mesh, k: int, shards=None) -> float:
    """``match_pod`` on ``mesh`` (over ``shards``, the rows placed there)
    against single-device kernel A on the same rows: indices and labels
    equal, sims bit for bit. Returns the largest sim difference (0.0)."""
    from opencv_facerecognizer_tpu_torch.parallel.gallery import (
        match_pod, take_labels_with_sentinel)

    got_l, got_v, got_i = (x.to(q.device) for x in match_pod(
        q, g, valid, labels, k=k, mesh=mesh, labels_pad=-1, shards=shards))
    want_v, want_i = streaming_match_topk(q, g, valid, k=k)
    want_l = take_labels_with_sentinel(labels, want_i, -1)
    err = float((got_v - want_v).abs().max().item())
    if not (torch.equal(got_i, want_i) and torch.equal(got_l, want_l) and err == 0.0):
        raise AssertionError(
            f"multi_gpu (a) mesh {mesh.shape} k={k}: match_pod differs from single-device "
            f"kernel A: {(got_i != want_i).sum().item()} indices, "
            f"{(got_l != want_l).sum().item()} labels, max |sim diff| {err}")
    return err


def sharded_match_check(dev, ctx: dict, devices: list) -> dict:
    """Phase 15 (a) (module docstring), meshes over the first slots of
    ``devices``."""
    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery as Gallery
    from opencv_facerecognizer_tpu_torch.parallel.gallery import match_pod, shard_arrays
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh

    rows, labels = ctx["rows"], ctx["labels"]
    gen = torch.Generator().manual_seed(15)
    g = torch.from_numpy(rows).to(torch.bfloat16).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    valid = torch.ones(len(rows), dtype=torch.bool, device=dev)
    valid[torch.randperm(len(rows), generator=gen)[:len(rows) // 20].to(dev)] = False
    q = torch.randn(512, DIM, generator=gen)
    q = (q / q.norm(dim=1, keepdim=True)).to(dev)
    q[:64] = g[-64:].float()  # planted rows (of which some are invalid)
    out = {"meshes": {}}
    zero_counters()
    for dp, tp in MG_MESHES:
        mesh = make_mesh(dp=dp, tp=tp, devices=devices[:dp * tp])
        if len(rows) // tp < ShardedGallery.KERNEL_MIN_CAPACITY:
            raise AssertionError(f"multi_gpu (a): shards of {len(rows) // tp} rows take no kernel")
        shards = shard_arrays(mesh, g, valid, lab)  # views on one card, copies across cards
        errs = [_pod_vs_single(q, g, valid, lab, mesh, k, shards) for k in MG_KS]
        before = streaming_match_topk.launches
        match_pod(q, g, valid, lab, k=1, mesh=mesh, shards=shards)
        torch.cuda.synchronize()
        per_call = streaming_match_topk.launches - before
        if dev.type == "cuda" and per_call != dp * tp:  # the CPU launches no kernel
            raise AssertionError(f"multi_gpu (a) mesh ({dp}, {tp}): {per_call} kernel A "
                                 f"launches a match, want {dp * tp}")
        pod_ms = cuda_ms(lambda: match_pod(q, g, valid, lab, k=1, mesh=mesh, shards=shards))
        single_ms = cuda_ms(lambda: streaming_match_topk(q, g, valid, k=1))
        # sparse: every valid row in shard 0, fewer than k anywhere else
        sparse = torch.zeros_like(valid)
        sparse[:MG_SPARSE_ROWS] = True
        s_shards = shard_arrays(mesh, g, sparse, lab, shards.emb)
        s_l, s_v, s_i = (x.to(dev) for x in match_pod(q, g, sparse, lab, k=5, mesh=mesh,
                                                       labels_pad=-1, shards=s_shards))
        empty = s_i == -1
        if not (empty.sum(dim=1) == 5 - MG_SPARSE_ROWS).all() or not (s_l[empty] == -1).all() \
                or not (s_v[empty] == NEG_INF).all() or not (s_i[~empty] < MG_SPARSE_ROWS).all():
            raise AssertionError(f"multi_gpu (a) mesh ({dp}, {tp}): the sparse layout's empty "
                                 "slots are not -1 with the pad label")
        _pod_vs_single(q, g, sparse, lab, mesh, 5, s_shards)
        del shards, s_shards
        out["meshes"][f"{dp}x{tp}"] = dict(max_sim_diff=max(errs), launches_per_match=per_call,
                                           match_pod_ms=pod_ms, single_kernel_ms=single_ms)
        log(f"multi_gpu (a) mesh dp={dp} tp={tp} on {len(set(devices[:dp * tp]))} card(s): "
            f"match_pod equal to single-device "
            f"kernel A at k={MG_KS} (indices, labels; sims bit for bit), sparse layout -1 and "
            f"pad; {per_call} kernel A launches a match; match_pod {pod_ms:.4f} ms against "
            f"{single_ms:.4f} ms single-device (events around 20 eager calls, Q 512, k 1)")
    # the gallery's own choice on a mesh: match_pod (C.18), equal again
    mesh = make_mesh(dp=2, tp=2, devices=devices[:4])
    gal = Gallery(len(rows), DIM, store_dtype=torch.bfloat16, mesh=mesh)
    gal.load_snapshot(rows, labels, valid.cpu().numpy(), len(rows))
    if not gal.kernel_enabled() or gal.match_fn(1).__name__ != "pod":
        raise AssertionError("multi_gpu (a): the mesh gallery did not pick match_pod")
    got = [x.to(dev) for x in gal.match(q, k=5)]
    want_v, want_i = streaming_match_topk(q, g, valid, k=5)
    if not (torch.equal(got[2], want_i) and torch.equal(got[1], want_v)):
        raise AssertionError("multi_gpu (a): the mesh gallery's match differs from kernel A")
    out["gallery_match_equal"] = True
    out["launches"] = read_launches()
    del gal, g
    torch.cuda.empty_cache()
    return out


def _pp_results_close(got, want, what: str, threshold: float, iou_threshold: float,
                      sim_atol=XCHECK_SIM) -> dict:
    """pp against the single-device step, face by face (``cross_check_frame``:
    faces pair by box, since two slots may swap where scores tie to
    rounding; a face on one side only passes at a decision boundary):
    labels equal, boxes within XCHECK_BOX_PX, sims within ``sim_atol``
    (None: recorded only)."""
    a = unpack_result(pack_result(got).cpu().numpy(), 1)
    b = unpack_result(pack_result(want).cpu().numpy(), 1)
    faces = swaps = 0
    box = sim = 0.0
    for i in range(len(a.valid)):
        pairs, lone = cross_check_frame(a, b, i, threshold, iou_threshold)
        swaps += lone
        for j, m, dbox in pairs:
            if a.labels[i, j, 0] != b.labels[i, m, 0]:
                raise AssertionError(f"multi_gpu (b) {what}: frame {i} labels differ")
            faces += 1
            box = max(box, float(dbox))
            sim = max(sim, abs(float(a.similarities[i, j, 0] - b.similarities[i, m, 0])))
    if sim_atol is not None and sim > sim_atol:
        raise AssertionError(f"multi_gpu (b) {what}: sim differs by {sim}")
    return dict(faces=faces, boundary_swaps=swaps, max_box_diff=box, max_sim_diff=sim,
                valid_equal=bool((a.valid == b.valid).all()))


def pp_stack(dev, seed: int, rows, labels, devices: list):
    """The two-stage pipeline over ``devices`` in the CLI's layout
    (``split_mesh(make_mesh(*pp_layout(n)))``: (4, 2) halves for 8), the
    serving detector and the unfused serving embedder (``build_stack``'s
    weights, on ``dev``), the rows on mesh_b in bf16; and the
    single-device eager unfused stack on ``dev`` it is held against."""
    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery as Gallery
    from opencv_facerecognizer_tpu_torch.parallel import TwoStagePipeline, split_mesh
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh

    mesh_a, mesh_b = split_mesh(make_mesh(*recognize_app.pp_layout(len(devices)),
                                          devices=devices))
    gal = Gallery(len(rows), DIM, store_dtype=torch.bfloat16, mesh=mesh_b)
    gal.add(rows, labels)
    ref = build_stack(dev, seed, bf16_gallery(dev, rows, labels), fused=False,
                      cuda_graphs=False)
    pp = TwoStagePipeline(ref.detector, ref.embed_net, None, gal, mesh_a,
                          face_size=embedder_mod.SERVING_FACE_SIZE)
    return pp, ref


def fused_mesh_service(pipe, frames: np.ndarray, n_plant: int) -> dict:
    """Phase 15 (d)'s service: 4 batches through ``pipe`` (the ladder
    MG_FUSED_LADDER, each rung a graph captured at warmup), every frame
    answered once (the first batch's planted faces recorded), then a lone
    frame, which must be dispatched at the ladder's first rung that the
    mesh's dp divides (C.24). The kernels' launches counted over the run;
    ``capture_ms`` holds every rung's capture (the top rung's came before,
    at the first batch)."""
    conn = FakeConnector()
    service = RecognizerService(pipe, conn, batch_size=BATCH, frame_shape=FRAME,
                                transfer_dtype=np.uint8, flush_timeout=0.05,
                                bucket_sizes=MG_FUSED_LADDER)
    dp = pipe.mesh.shape["dp"]
    rung = min(b for b in MG_FUSED_LADDER if b % dp == 0)
    if service._bucket_ladder != sorted({b for b in MG_FUSED_LADDER
                                         if b < BATCH and b % dp == 0} | {BATCH}):
        raise AssertionError(f"multi_gpu (d): ladder {service._bucket_ladder} over dp {dp}")
    calls = _wrap_calls(pipe, "recognize_batch_packed")
    service.start(warmup=True)
    warm = len(calls)
    zero_counters()
    t0 = time.perf_counter()
    try:
        for i, frame in enumerate(frames):
            conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"i": i}})
        if not service.drain(timeout=120.0):
            raise AssertionError("multi_gpu (d): service did not drain")
        served = len(calls)
        conn.inject(FRAME_TOPIC, {**encode_frame(frames[0]), "meta": {"i": len(frames)}})
        if not service.drain(timeout=60.0):
            raise AssertionError("multi_gpu (d): service did not drain the lone frame")
    finally:
        service.stop()
        del pipe.recognize_batch_packed
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    results = conn.messages(RESULT_TOPIC)
    if sorted(r["meta"]["i"] for r in results) != list(range(len(frames) + 1)):
        raise AssertionError("multi_gpu (d): not one result per frame")
    lone = [len(c[2]) for c in calls[served:]]
    if lone != [rung]:
        raise AssertionError(f"multi_gpu (d): the lone frame went out in batches {lone}, "
                             f"want one at rung {rung}")
    steps = int(service.metrics.counter(BATCHES_DISPATCHED))
    want = {"streaming_match": steps * pipe.mesh.size, "nms": steps * dp, "sepblock": 0}
    if pipe.device.type == "cuda" and launches != want:  # the CPU launches no kernel
        raise AssertionError(f"multi_gpu (d): service launches {launches} in {steps} steps, "
                             f"want {want}")
    first = [f for r in results if r["meta"]["i"] < BATCH for f in r["faces"]]
    planted = [f["similarity"] for f in first if f["label"] < n_plant]
    return dict(frames=len(frames) + 1, steps=steps, warmup_batches=warm,
                lone_frame_rung=rung, first_batch_faces=len(first), planted_found=len(planted),
                n_plant=n_plant, min_planted_sim=min(planted, default=None),
                launches=launches, capture_ms={str(k[0]): v for k, v in pipe.capture_ms.items()},
                seconds=serve_s)


def fused_mesh_check(dev, seed: int, ctx: dict, devices: list) -> dict:
    """Phase 15 (d) (module docstring): ``RecognitionPipeline`` over
    MG_FUSED_MESHES of the first slots of ``devices``, the unfused serving
    stack over phase 4's rows in bf16, against the single-device graphed
    unfused step."""
    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery as Gallery
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh

    rows, labels, frames = ctx["rows"], ctx["labels"], ctx["frames"]
    batch = frames[:BATCH]
    single = build_stack(dev, seed, bf16_gallery(dev, rows, labels), fused=False)
    out = {"meshes": {}, "launches": dict.fromkeys(("streaming_match", "sepblock", "nms"), 0)}
    for dp, tp in MG_FUSED_MESHES:
        t = time.perf_counter()
        gal = Gallery(len(rows), DIM, store_dtype=torch.bfloat16,
                      mesh=make_mesh(dp=dp, tp=tp, devices=devices[:dp * tp]))
        gal.add(rows, labels)
        pipe = build_stack(dev, seed, gal, fused=False)
        eager = build_stack(dev, seed, gal, fused=False, cuda_graphs=False)
        if not gal.kernel_enabled():
            raise AssertionError(f"multi_gpu (d) mesh ({dp}, {tp}): shards take no kernel A")
        got = pipe.recognize_batch_packed(batch).clone()
        want = eager.recognize_batch_packed(batch)
        per = BATCH // dp
        by_row = torch.cat([single.recognize_batch_packed(batch[r * per:(r + 1) * per]).clone()
                            for r in range(dp)])
        diff = {"vs_eager": float((got - want).abs().max().item()),
                "vs_single_by_row": float((got - by_row).abs().max().item())}
        if not torch.equal(got, want):
            raise AssertionError(f"multi_gpu (d) mesh ({dp}, {tp}): the graphed step differs "
                                 f"from the eager mesh step: {diff}")
        if not torch.equal(got, by_row):
            raise AssertionError(f"multi_gpu (d) mesh ({dp}, {tp}): the graphed step differs "
                                 f"from the single-device graphed step on each dp row: {diff}")
        if not (got[..., 5] > 0.5).any():
            raise AssertionError(f"multi_gpu (d) mesh ({dp}, {tp}): no face in the first batch")
        zero_counters()
        pipe.recognize_batch_packed(batch).cpu()
        per_batch = read_launches()
        if dev.type == "cuda" and per_batch != {"streaming_match": dp * tp, "sepblock": 0,
                                               "nms": dp}:
            raise AssertionError(f"multi_gpu (d) mesh ({dp}, {tp}): launches a batch "
                                 f"{per_batch}, want A {dp * tp}, C {dp}, B 0")
        first_capture = next(iter(pipe.capture_ms.values()), None)
        # every step dropped (a tier evicted): the next capture takes fresh
        # pools (C.25) and gives the same bytes
        pipe.evict_below(gal.capacity + 1)
        if pipe._step_cache or not torch.equal(pipe.recognize_batch_packed(batch), got) \
                or pipe.captures != (2 if pipe.cuda_graphs else 0):
            raise AssertionError(f"multi_gpu (d) mesh ({dp}, {tp}): the step captured again "
                                 "after every step was evicted differs")
        rec = dict(bit_equal_eager=True, bit_equal_single_by_row=True, max_abs_diff=diff,
                   launches_per_batch=per_batch, first_capture_ms=first_capture,
                   recapture_after_evict_equal=True, readback_ms=[], back_to_back_ms=[],
                   host_call_ms=[])
        dev_batch = torch.from_numpy(batch).to(dev)
        for _ in range(2):  # mesh and single device in turns
            rec["readback_ms"] += [step_time_ms(pipe, batch), step_time_ms(single, batch)]
            rec["back_to_back_ms"] += [back_to_back_ms(pipe, batch),
                                       back_to_back_ms(single, batch)]
            if dev.type == "cuda":
                rec["host_call_ms"] += [host_call_ms(pipe, dev_batch),
                                        host_call_ms(single, dev_batch)]
        if dev.type == "cuda":
            rec["profile"] = profile_step(pipe, batch, what=f"mesh ({dp}, {tp})")
        drop_stack(eager)
        rec["service"] = fused_mesh_service(pipe, frames, ctx["n_plant"])
        for k, v in rec["service"]["launches"].items():
            out["launches"][k] += v
        drop_stack(pipe)
        del gal, pipe, eager
        rec["seconds"] = time.perf_counter() - t
        out["meshes"][f"{dp}x{tp}"] = rec
        log(f"multi_gpu (d) the fused step over mesh dp={dp} tp={tp} (slots of the card, "
            f"unfused, bf16, 2^20 rows): graphed = eager = the single-device graphed step on "
            f"each dp row's frames, bit for bit, and again after every step was evicted; "
            f"launches a batch {per_batch}; host-clock ms a batch with a readback (mesh, "
            f"single, mesh, single) {rec['readback_ms']}, back to back "
            f"{rec['back_to_back_ms']}, the call alone {rec['host_call_ms']}; "
            f"service {rec['service']}")
    out["single_device_profile"] = (profile_step(single, batch, what="single-device unfused")
                                    if dev.type == "cuda" else None)
    drop_stack(single)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


#: phase 15 (e): the serving step across two processes on the card (gloo,
#: one slot each): the mesh layouts, pp's, the steps timed back to back,
#: and the workers' deadline
MP_LAYOUTS = ((1, 2), (2, 1))
MP_PP_LAYOUT = (2, 1)
MP_TIME_STEPS = 20
MP_DEADLINE_S = 300.0


def _mp_pipeline(dev, seed: int, rows, labels, layout, pp: bool, devices):
    """The stack of phase 15 (e) over ``make_mesh(*layout, devices)``: the
    unfused serving stack in bf16 over the rows (graphed level by level),
    or with ``pp`` the two-stage pipeline over ``split_mesh`` of it, the
    gallery on its second half."""
    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery as Gallery
    from opencv_facerecognizer_tpu_torch.parallel import TwoStagePipeline, split_mesh
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*layout, devices=devices)
    mesh_a, mesh_b = split_mesh(mesh) if pp else (None, mesh)
    gal = Gallery(len(rows), DIM, store_dtype=torch.bfloat16, mesh=mesh_b)
    gal.add(rows, labels)
    if not pp:
        return build_stack(dev, seed, gal, fused=False)
    det, net = serving_nets(dev, seed)
    return TwoStagePipeline(det, net, None, gal, mesh_a, face_size=embedder_mod.SERVING_FACE_SIZE)


def _mp_drive(dev, pipe, batch, root: str, seed: int) -> dict:
    """One worker's run of one stack of phase 15 (e): the first batch
    (captured and served), one more counted for the kernels' launches,
    kernel A against its plain version on this process's shard at the
    step's query shape, then (once the parent's references are done)
    ``MP_TIME_STEPS`` steps back to back and ``MP_TIME_STEPS`` more with
    each collective timed to its end on the card."""
    gal = pipe.gallery
    comm = gal.mesh.comm
    got = pipe.recognize_batch_packed(batch).clone()
    zero_counters()
    pipe.recognize_batch_packed(batch).cpu()
    launches = read_launches()
    shard = [(e, v) for row_e, row_v in zip(gal.data.shards.emb, gal.data.shards.valid)
             for e, v in zip(row_e, row_v) if e is not None]
    err = None
    if shard and dev.type == "cuda":
        g = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn(len(batch) // gal.mesh.shape["dp"] * MAX_FACES, DIM, generator=g,
                        device=dev)
        err = _match_case(q / q.norm(dim=1, keepdim=True), *shard[0], 1,
                          f"rank {comm.rank}'s shard of {gal.mesh.shape}")
    rec = dict(packed=got.cpu(), launches=launches, shard_rows=[int(e.shape[0]) for e, _ in shard],
               match_err=err, ms=None, collectives={})
    if dev.type != "cuda":
        return rec
    end = time.monotonic() + MP_DEADLINE_S
    while not os.path.exists(os.path.join(root, "go")):
        if time.monotonic() > end:
            raise TimeoutError("multi_gpu (e): the parent's references never finished")
        time.sleep(0.05)
    rec["ms"] = back_to_back_ms(pipe, batch, iters=MP_TIME_STEPS)
    for v in comm.stats.values():
        v.clear()
    comm.sync_timing = True
    back_to_back_ms(pipe, batch, iters=MP_TIME_STEPS)
    comm.sync_timing = False
    st = comm.stats
    rec["collectives"] = {name: dict(calls_per_step=n / (MP_TIME_STEPS + 3),
                                     ms=st["seconds"][name] * 1e3 / n,
                                     bytes=st["bytes"][name] // n,
                                     staged_bytes=st["staged_bytes"][name] // n)
                          for name, n in st["calls"].items()}
    return rec


def _mp_train(dev, seed: int, layout, devices) -> dict:
    """Phase 15 (e)'s sharded ArcFace step: MP_TRAIN_STEPS steps of
    ``sharded_step`` in bf16 over ``make_mesh(*layout, devices)``, each
    collective timed to its end on the card. Returns the losses, this
    process's replicas and head shards by slot, the collectives' calls a
    step, ms, bytes and bytes staged through host memory (across
    processes), and the gathered head."""
    step = sharded_step(seed, layout, devices, torch.bfloat16)
    comm = step.mesh.comm
    if comm is not None:
        comm.sync_timing = dev.type == "cuda"
    losses = [step.step(x, y, d) for x, y, d in sharded_batches(dev, seed, MP_TRAIN_STEPS)]
    local = step.mesh.local_slots
    rec = dict(losses=torch.stack(losses).cpu(),
               nets={s.id: [p.detach().cpu() for p in step.nets[s.id].parameters()] for s in local},
               shards={s.id: step.shards[s.id].detach().cpu() for s in local}, collectives={})
    if comm is not None:
        comm.sync_timing = False
        st = comm.stats
        rec["collectives"] = {name: dict(calls_per_step=n / MP_TRAIN_STEPS,
                                         ms=st["seconds"][name] * 1e3 / n,
                                         bytes=st["bytes"][name] // n,
                                         staged_bytes=st["staged_bytes"][name] // n)
                              for name, n in st["calls"].items()}
    rec["head"] = step.gather_head().cpu()
    return rec


def cross_process_worker(rank: int, port: int, root: str, seed: int, device: str) -> None:
    """Phase 15 (e)'s process ``rank`` of two: a ``gloo`` group made here
    (two processes on one card: NCCL refuses two ranks on one GPU), which
    ``initialize_multihost`` then keeps; one slot of ``device`` a process;
    each stack of the phase driven by ``_mp_drive``; the records saved to
    ``root/rank<rank>.pt``, or the traceback to ``root/rank<rank>.err``
    and exit code 1."""
    import datetime
    import traceback

    from opencv_facerecognizer_tpu_torch.parallel.mesh import initialize_multihost

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        addr = f"127.0.0.1:{port}"
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://{addr}", world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds=MP_DEADLINE_S))
        if not initialize_multihost(addr, 2, rank):
            raise AssertionError("initialize_multihost did not keep the group")
        rows = np.load(os.path.join(root, "rows.npy"), mmap_mode="r")
        labels = np.load(os.path.join(root, "labels.npy"))
        batch = np.load(os.path.join(root, "batch.npy"))
        out = {}
        for layout, pp in [(lay, False) for lay in MP_LAYOUTS] + [(MP_PP_LAYOUT, True)]:
            pipe = _mp_pipeline(dev, seed, rows, labels, layout, pp, [dev])
            out[("pp" if pp else "mesh", layout)] = _mp_drive(dev, pipe, batch, root, seed)
            if not pp:
                drop_stack(pipe)
            del pipe
        out["train"] = {lay: _mp_train(dev, seed, lay, [dev]) for lay in MP_TRAIN_LAYOUTS}
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the phase
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def cross_process_check(dev, seed: int, ctx: dict) -> dict:
    """Phase 15 (e) (module docstring): two worker processes on the card
    (``cross_process_worker``, started with ``spawn``) serve the first
    batch over each layout of MP_LAYOUTS and pp on MP_PP_LAYOUT; each
    rank's packed result must equal the same layout's single-process mesh
    on two slots of the card (phase 15 (d)'s form) bit for bit. A worker
    that fails or outlives MP_DEADLINE_S fails the phase; both are killed
    on the way out. Returns the numbers and the workers' kernel
    launches."""
    import multiprocessing

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "xproc_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    batch = ctx["frames"][:BATCH]
    np.save(os.path.join(root, "rows.npy"), ctx["rows"])
    np.save(os.path.join(root, "labels.npy"), ctx["labels"])
    np.save(os.path.join(root, "batch.npy"), batch)
    spawn = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [spawn.Process(target=cross_process_worker, args=(r, port, root, seed, str(dev)),
                           daemon=True) for r in (0, 1)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    out = {"layouts": {}, "launches": dict.fromkeys(("streaming_match", "sepblock", "nms"), 0)}
    try:
        refs = {}
        for layout, pp in [(lay, False) for lay in MP_LAYOUTS] + [(MP_PP_LAYOUT, True)]:
            pipe = _mp_pipeline(dev, seed, ctx["rows"], ctx["labels"], layout, pp, [dev] * 2)
            refs[("pp" if pp else "mesh", layout)] = (
                pipe.recognize_batch_packed(batch).cpu(),
                back_to_back_ms(pipe, batch, iters=MP_TIME_STEPS) if dev.type == "cuda"
                else None)
            if not pp:
                drop_stack(pipe)
            del pipe
        train_refs = {lay: _mp_train(dev, seed, lay, [dev] * 2) for lay in MP_TRAIN_LAYOUTS}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        open(os.path.join(root, "go"), "w").close()  # the workers may time their steps now
        end = time.monotonic() + MP_DEADLINE_S
        while not all(p.exitcode == 0 for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > end:
                errs = [os.path.join(root, f"rank{r}.err") for r in (0, 1)]
                raise AssertionError(
                    f"multi_gpu (e): workers exited {[p.exitcode for p in procs]} or passed "
                    f"the {MP_DEADLINE_S} s deadline: "
                    + " | ".join(open(e).read() for e in errs if os.path.exists(e)))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    out["workers_s"] = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    for key, (want, ref_ms) in refs.items():
        kind, (dp, tp) = key
        per_rank = [r[key] for r in ranks]
        for rank, rec in enumerate(per_rank):
            if not torch.equal(rec["packed"], want):
                raise AssertionError(
                    f"multi_gpu (e) {kind} ({dp}, {tp}) rank {rank}: the packed result differs "
                    f"from the single-process mesh's: max |diff| "
                    f"{(rec['packed'] - want).abs().max().item()}")
        if not (want[..., 5] > 0.5).any():
            raise AssertionError(f"multi_gpu (e) {kind} ({dp}, {tp}): no face in the batch")
        a = [rec["launches"]["streaming_match"] for rec in per_rank]
        c = [rec["launches"]["nms"] for rec in per_rank]
        want_a, want_c = ([0, 1], [1, 0]) if kind == "pp" else ([1, 1], [1, 1])
        if dev.type == "cuda" and (a != want_a or c != want_c
                                   or any(rec["launches"]["sepblock"] for rec in per_rank)):
            raise AssertionError(f"multi_gpu (e) {kind} ({dp}, {tp}): launches a batch by rank "
                                 f"{[rec['launches'] for rec in per_rank]}")
        for rec in per_rank:
            for name, n in rec["launches"].items():
                out["launches"][name] += n
        out["layouts"][f"{kind} {dp}x{tp}"] = dict(
            bit_equal_single_process=True, single_process_ms=ref_ms,
            ms_by_rank=[rec["ms"] for rec in per_rank],
            launches_by_rank=[rec["launches"] for rec in per_rank],
            shard_rows_by_rank=[rec["shard_rows"] for rec in per_rank],
            kernel_a_err_by_rank=[rec["match_err"] for rec in per_rank],
            collectives_by_rank=[rec["collectives"] for rec in per_rank])
        log(f"multi_gpu (e) {kind} ({dp}, {tp}) across two processes on the card (gloo, one "
            f"slot each): both ranks' packed result equal bit for bit to the single-process "
            f"mesh on two slots; launches by rank {[rec['launches'] for rec in per_rank]}; "
            f"host-clock ms a batch back to back by rank {[rec['ms'] for rec in per_rank]} "
            f"against {ref_ms} single-process; collectives by rank "
            f"{[rec['collectives'] for rec in per_rank]}")
    out["train"] = {}
    for (dp, tp), want in train_refs.items():
        per_rank = [r["train"][(dp, tp)] for r in ranks]
        for rank, rec in enumerate(per_rank):
            same = (torch.equal(rec["losses"], want["losses"])
                    and torch.equal(rec["head"], want["head"])
                    and all(torch.equal(a, b) for i, ps in rec["nets"].items()
                            for a, b in zip(ps, want["nets"][i]))
                    and all(torch.equal(t, want["shards"][i]) for i, t in rec["shards"].items()))
            if not same:
                raise AssertionError(
                    f"multi_gpu (e) sharded ArcFace step ({dp}, {tp}) rank {rank}: differs from "
                    f"the single-process mesh's: losses {rec['losses'].tolist()} against "
                    f"{want['losses'].tolist()}")
        out["train"][f"{dp}x{tp}"] = dict(
            bit_equal_single_process=True, steps=MP_TRAIN_STEPS,
            losses=want["losses"].tolist(),
            collectives_by_rank=[rec["collectives"] for rec in per_rank])
        log(f"multi_gpu (e) sharded ArcFace step ({dp}, {tp}) across two processes (gloo, one "
            f"slot each), {MP_TRAIN_STEPS} bf16 steps of the HARD recipe: both ranks' losses, "
            f"replicas, shards and head equal bit for bit to the single-process mesh on two "
            f"slots; losses {want['losses'].tolist()}; collectives by rank "
            f"{[rec['collectives'] for rec in per_rank]}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def multi_gpu_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 15 (module docstring) over MG_SLOTS slots of ``dev``; returns
    the ``{"multi_gpu": ...}`` numbers, the pp path's kernel launches
    among them."""
    t_phase = time.perf_counter()
    devices = [dev] * MG_SLOTS
    out = {"card": card, "devices": [str(d) for d in devices]}
    t = time.perf_counter()
    out["sharded_match"] = sharded_match_check(dev, ctx, devices)
    out["sharded_match_s"] = time.perf_counter() - t

    # (b) the two-stage pipeline
    t = time.perf_counter()
    frames = ctx["frames"]
    pp, ref = pp_stack(dev, seed, ctx["rows"], ctx["labels"], devices)
    dp_a = pp.mesh_a.shape["dp"]
    batch = frames[:BATCH]
    # against the single-device step on each dp row's frames (the batch
    # each convolution sees in pp): the same kernels, so bit for bit is
    # expected; against the whole batch at once, bf16 convolutions over 32
    # frames may take other algorithms, so its sims are recorded, not gated
    got = pp.recognize_batch(batch)
    per = BATCH // dp_a
    by_row = RecognitionResult(*(torch.cat(parts) for parts in zip(*(
        ref.recognize_batch(batch[r * per:(r + 1) * per]) for r in range(dp_a)))))
    thresholds = (ref.detector.score_threshold, ref.detector.iou_threshold)
    out["pp_vs_single"] = _pp_results_close(got, by_row, "first batch by dp row", *thresholds)
    out["pp_vs_single"]["bit_equal"] = bool(torch.equal(pack_result(got).cpu(),
                                                         pack_result(by_row).cpu()))
    out["pp_vs_single_whole_batch"] = _pp_results_close(
        got, ref.recognize_batch(batch), "first batch whole", *thresholds, sim_atol=None)
    zero_counters()
    pp.recognize_batch_packed(batch).cpu()
    per_batch = read_launches()
    want = {"streaming_match": pp.mesh_b.size, "nms": dp_a, "sepblock": 0}
    if dev.type == "cuda" and per_batch != want:  # the CPU launches no kernel
        raise AssertionError(f"multi_gpu (b): launches a batch {per_batch}, want {want}")
    n_distinct = len(frames) // BATCH
    batches = [frames[(i % n_distinct) * BATCH:(i % n_distinct + 1) * BATCH]
               for i in range(MG_STREAM_BATCHES)]
    solo = [pp.recognize_batch(b) for b in batches[:n_distinct]]
    zero_counters()
    streamed = list(pp.recognize_stream(iter(batches)))
    torch.cuda.synchronize()
    stream_launches = read_launches()
    if len(streamed) != len(batches):
        raise AssertionError(f"multi_gpu (b): {len(streamed)} results for {len(batches)} batches")
    for i, res in enumerate(streamed):
        if not (torch.equal(res.labels, solo[i % n_distinct].labels)
                and torch.equal(res.valid, solo[i % n_distinct].valid)):
            raise AssertionError(f"multi_gpu (b): streamed batch {i} differs from its solo run")
    if dev.type == "cuda" and stream_launches != {k: v * len(batches)
                                                  for k, v in want.items()}:
        raise AssertionError(f"multi_gpu (b): stream launches {stream_launches}")
    ms_pp = back_to_back_ms(pp, batch, iters=MG_TIME_BATCHES)
    ms_ref = back_to_back_ms(ref, batch, iters=MG_TIME_BATCHES)
    ms_pp2 = back_to_back_ms(pp, batch, iters=MG_TIME_BATCHES)
    ms_ref2 = back_to_back_ms(ref, batch, iters=MG_TIME_BATCHES)
    out["pp"] = dict(launches_per_batch=per_batch, stream_batches=len(streamed),
                     stream_launches=stream_launches,
                     back_to_back_ms=[ms_pp, ms_pp2],
                     single_device_eager_unfused_back_to_back_ms=[ms_ref, ms_ref2])
    out["pp_s"] = time.perf_counter() - t
    log(f"multi_gpu (b) pp over {out['devices']} (mesh_a {pp.mesh_a.shape}, mesh_b "
        f"{pp.mesh_b.shape}): first batch {out['pp_vs_single']} against the single-device "
        f"unfused step on each dp row's frames, {out['pp_vs_single_whole_batch']} against it "
        f"on the whole batch; launches a batch {per_batch}; {len(streamed)} streamed batches in "
        f"order; host-clock ms a batch back to back {ms_pp:.3f}, {ms_pp2:.3f} against "
        f"{ms_ref:.3f}, {ms_ref2:.3f} for the single-device eager unfused step")

    # (c) the service over the two-stage pipeline
    t = time.perf_counter()
    names = [f"p{i}" for i in range(ctx["n_plant"])]
    conn = FakeConnector()
    service = RecognizerService(pp, conn, batch_size=BATCH, frame_shape=FRAME,
                                transfer_dtype=np.uint8, flush_timeout=0.05,
                                similarity_threshold=0.5, subject_names=names)
    service.start(warmup=True)
    zero_counters()
    try:
        served = frames[:4 * BATCH] if len(frames) >= 4 * BATCH else frames
        for i, frame in enumerate(served):
            conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"i": i}})
        if not service.drain(timeout=120.0):
            raise AssertionError("multi_gpu (c): service did not drain")
        results = conn.messages(RESULT_TOPIC)
        if sorted(r["meta"]["i"] for r in results) != list(range(len(served))):
            raise AssertionError("multi_gpu (c): not one result per frame")
        steps = int(service.metrics.counter(BATCHES_DISPATCHED))
        service_launches = read_launches()
        if dev.type == "cuda" and (service_launches["streaming_match"]
                                   != steps * want["streaming_match"]):
            raise AssertionError(f"multi_gpu (c): launches {service_launches} in {steps} steps")
        # a subject from a frame with no planted row lands live and is named
        scene = frames[BATCH + faced_frames(pp, frames[BATCH:2 * BATCH], 1)[0]]
        subject = "pp_enrolled"
        t_enrol = time.perf_counter()
        enrol_through_control(conn, scene, subject)
        enrol_s = time.perf_counter() - t_enrol
        n_before = len(conn.messages(RESULT_TOPIC))
        for j in range(BATCH):
            conn.inject(FRAME_TOPIC, {**encode_frame(scene), "meta": {"after": j}})
        if not service.drain(timeout=120.0):
            raise AssertionError("multi_gpu (c): service did not drain after the enrolment")
        after = conn.messages(RESULT_TOPIC)[n_before:]
        named = sum(any(f["name"] == subject for f in r["faces"]) for r in after)
        if named == 0:
            raise AssertionError("multi_gpu (c): the enrolled subject was named in no frame")
        ledger = service.ledger()
    finally:
        service.stop()
    if ledger["in_system"]:
        raise AssertionError(f"multi_gpu (c): ledger does not close: {ledger}")
    out["service"] = dict(frames=len(served), steps=steps, launches=service_launches,
                          enrol_s=enrol_s, named_after_enrol=named, of=len(after))
    out["service_s"] = time.perf_counter() - t
    log(f"multi_gpu (c) service: {len(served)} frames answered once in {steps} steps, "
        f"launches {service_launches}; an enrolment landed in {enrol_s:.3f} s and named "
        f"{named} of {len(after)} frames after it")

    # (d) the fused step over a mesh
    t = time.perf_counter()
    out["fused_mesh"] = fused_mesh_check(dev, seed, ctx, devices)
    out["fused_mesh_s"] = time.perf_counter() - t

    # (e) the serving step across two processes
    t = time.perf_counter()
    out["cross_process"] = cross_process_check(dev, seed, ctx)
    out["cross_process_s"] = time.perf_counter() - t

    # (f) the CLI on one card
    missing = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "no_such_ckpt")
    base = ["--model", missing, "--detector", missing, "--gallery", missing,
            "--source", "dir", "--dir", missing, "--parallel", "pp",
            *(["--device", "cpu"] if dev.type == "cpu" else [])]
    n_dev = 1 if dev.type == "cpu" else torch.cuda.device_count()
    refusals = {}
    for case, extra, text in (
            ("one_device", [], f"needs an even device count >= 2 (have {n_dev})"),
            ("fused_embedder", ["--fused-embedder"], "--fused-embedder applies to"),
            ("match_mode_ivf", ["--match-mode", "ivf"], "--match-mode ivf applies to"),
            ("cascade", ["--cascade", missing], "--cascade applies to")):
        if case == "one_device" and n_dev >= 2 and n_dev % 2 == 0:
            continue  # served on such a host: nothing to refuse
        try:
            recognize_app.main(base + extra)
        except SystemExit as exc:
            if text not in str(exc):
                raise AssertionError(f"multi_gpu (f) {case}: refused with {exc}")
            refusals[case] = str(exc)
        else:
            raise AssertionError(f"multi_gpu (f) {case}: --parallel pp was not refused")
    out["cli_refusals"] = refusals
    log(f"multi_gpu (f) the CLI on {n_dev} card(s): --parallel pp refused as the reference "
        f"refuses: {json.dumps(refusals)}")
    out["pp_launches"] = {k: stream_launches[k] + service_launches[k] for k in stream_launches}
    out["mesh_launches"] = {k: out["pp_launches"][k] + out["fused_mesh"]["launches"][k]
                            + out["cross_process"]["launches"][k] for k in stream_launches}
    drop_stack(ref)
    for hooks, fn in ((pp.gallery.prewarm_hooks, pp.prewarm_capacity),
                      (pp.gallery.evict_hooks, pp.evict_below)):
        hooks.remove(fn)
    del pp, ref, service
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------- phase 16: the chaos soak (ROADMAP A.14) ----------

#: phase 16 (a): the soak's seed (its fault rates follow from it), seconds
#: of offered frames and the offer rate
CHAOS_SEED = 7
CHAOS_SECONDS = 20.0
CHAOS_FPS = 800.0
#: threads the process may hold after the soak beyond its count before (a
#: daemon thread of another phase that is still winding down)
CHAOS_THREAD_MARGIN = 2
#: phase 16 (b): rows added after the supervisor's checkpoint (the
#: half-done enrolment a crash rolls back)
CHAOS_ADDED_ROWS = 3


def chaos_launch_check(launches: dict, steps: int, restarts: int) -> dict:
    """Kernels A and C once and B six times a dispatched step, replays
    counted; exactly so unless a restart re-captured a rung (its eager
    warm-up runs launch too), then at least so. Returns the per-step
    launches."""
    want = {"streaming_match": steps, "sepblock": 6 * steps, "nms": steps}
    ok = (all(launches[k] >= n for k, n in want.items()) if restarts
          else launches == want)
    if steps < 1 or not ok:
        raise AssertionError(f"chaos (a): launches {launches} in {steps} dispatched steps "
                             f"({restarts} restarts); want {want}")
    return {k: launches[k] / steps for k in want}


def chaos_staging_check(allocs: float, forfeits: float, ring) -> dict:
    """The pinned ring's allocations past its preallocation are forfeits
    healed: each forfeited buffer (a dead-lettered, abandoned or crashed
    batch's) opens one replacement allocation, taken when its rung runs
    out; those not taken yet are the ring's open heal credits."""
    past = int(allocs) - ring.preallocated
    open_credits = int(sum(ring._forfeited.values()))
    if past != ring.alloc_count - ring.preallocated or past + open_credits != int(forfeits):
        raise AssertionError(f"chaos (a): {past} pinned allocations past the preallocation and "
                             f"{open_credits} open heal credits for {forfeits} forfeits")
    return dict(preallocated=ring.preallocated, allocs_past_prealloc=past,
                forfeits=int(forfeits), open_heal_credits=open_credits, pinned=ring.pinned)


def chaos_thread_check(before: int, after: int, margin: int = CHAOS_THREAD_MARGIN) -> dict:
    if after > before + margin:
        raise AssertionError(f"chaos (a): {after} threads after the soak, {before} before "
                             f"(margin {margin}): a thread leaked")
    return dict(before=before, after=after, margin=margin)


def planted_ranges(stack, frames: np.ndarray) -> list:
    """Phase 4 planted the first batch's faces in frame order, labels
    0 .. n - 1: frame i's faces own labels [start_i, start_i + count_i)."""
    _b, _s, valid, _e = stack.embed_frames(frames[:BATCH])
    counts = valid.reshape(BATCH, -1).sum(1).cpu().numpy().astype(int)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return [(int(a), int(a + c)) for a, c in zip(starts, counts)]


def chaos_probe_check(probe_results: list, ranges: list, key: str = "probe") -> dict:
    """Each answered frame's faces found planted rows of its own frame
    (``ranges`` by frame index, ``meta[key]``) at similarity >= 0.99."""
    faces = 0
    for r in probe_results:
        lo, hi = ranges[r["meta"][key]]
        for f in r["faces"]:
            if not lo <= f["label"] < hi or f["similarity"] < 0.99:
                raise AssertionError(f"chaos: frame {r['meta'][key]}'s face {f} did not find "
                                     f"its planted rows [{lo}, {hi})")
            faces += 1
    if faces < 1:
        raise AssertionError("chaos: the probe found no face")
    return dict(frames=len(probe_results), faces=faces)


def _e2e_ms(sent: dict, done: dict) -> dict:
    lat = [done[k] - t for k, t in sent.items() if k in done]
    if not lat:
        return dict(n=0, p50=None, p99=None)
    return dict(n=len(lat), p50=float(np.percentile(lat, 50)) * 1e3,
                p99=float(np.percentile(lat, 99)) * 1e3)


def chaos_soak_run(dev, card: str, ctx: dict) -> dict:
    """Phase 16 (a) (module docstring): ``apps.chaos_soak.run_soak`` on
    phase 4's stack under the reference's fault rates."""
    stack, frames = ctx["stack"], ctx["frames"]
    ranges = planted_ranges(stack, frames)
    monitor = LockOrderMonitor()
    restores, done_at, at_start = [], {}, {}

    def prepare(service):
        restores.append(chaos_soak.instrument_locks(service, monitor))

        def on_result(topic, message):
            meta = message.get("meta") or {}
            key = ("seq", meta["seq"]) if "seq" in meta else ("probe", meta.get("probe"))
            done_at.setdefault(key, time.monotonic())

        service.connector.subscribe(RESULT_TOPIC, on_result)

    def on_start(service):
        # the path's launches from here (the warmup captured the rungs)
        zero_counters()
        at_start.update(captures=stack.captures, recaptures=stack.recaptures)

    handles = {}
    threads_before = threading.active_count()
    t = time.perf_counter()
    try:
        report = chaos_soak.run_soak(
            seconds=CHAOS_SECONDS, seed=CHAOS_SEED, frame_shape=FRAME, device=dev,
            pipeline=stack, batch_size=BATCH, frames=frames, offer_fps=CHAOS_FPS,
            service_kwargs=dict(ingest=IngestConfig("uint8")), prepare=prepare,
            on_start=on_start, handles=handles)
    finally:
        for restore in restores:
            restore()
    soak_s = time.perf_counter() - t
    launches = read_launches()
    if not report["ok"]:
        raise AssertionError(f"chaos (a): the soak failed: {report['failures']}")
    acct = report.get("span_accounting", {})
    if not acct or acct.get("ring_wrapped"):
        raise AssertionError(f"chaos (a): no span accounting of the final dump: {acct}")
    service = handles["service"]
    counters = report["counters"]
    restarts = int(report["supervisor_restarts"])
    probe = chaos_probe_check(handles["probe_results"], ranges)
    recaptures = dict(captures=stack.captures - at_start["captures"],
                      recaptures=stack.recaptures - at_start["recaptures"],
                      recompiles_post_warmup=counters.get(mn.RECOMPILES_POST_WARMUP, 0))
    if not restarts and any(recaptures.values()):
        raise AssertionError(f"chaos (a): a step was captured after warmup: {recaptures}")
    steps = int(counters.get(BATCHES_DISPATCHED, 0))
    per_step = chaos_launch_check(launches, steps, restarts) if dev.type == "cuda" else {}
    staging = chaos_staging_check(counters.get(mn.INGEST_STAGING_ALLOCS, 0),
                                  counters.get(mn.INGEST_STAGING_FORFEITS, 0),
                                  service.ingest.staging)
    monitor.check()
    edges = sorted(f"{a} -> {b}" for a, b in monitor.edges())
    threads = chaos_thread_check(threads_before, threading.active_count())
    sent_seq = {("seq", k): v for k, v in handles["sent_at"].items()}
    sent_probe = {("probe", k): v for k, v in handles["probe_sent_at"].items()}
    out = dict(card=card, seed=report["seed"], seconds=CHAOS_SECONDS, offer_fps=CHAOS_FPS,
               sent=report["sent"], results=report["results"], rates=report["rates"],
               injected=report["injected"], ledger=report["ledger"],
               restarts=restarts, loop_crashes=counters.get(LOOP_CRASHES, 0),
               dead_letters=dict(batches=counters.get(mn.BATCHES_DEAD_LETTERED, 0),
                                 frames=counters.get(mn.FRAMES_DEAD_LETTERED, 0)),
               counters=counters, e2e_chaos_ms=_e2e_ms(sent_seq, done_at),
               e2e_probe_ms=_e2e_ms(sent_probe, done_at), probe=probe, steps=steps,
               launches=launches, launches_per_step=per_step, recaptures=recaptures,
               staging=staging, threads=threads, lock_edges=edges,
               flight_dumps=report["flight_dumps"], span_accounting=acct, soak_s=soak_s)
    log(f"chaos (a) ({card}): {report['sent']} frames offered at {CHAOS_FPS:.0f}/s for "
        f"{CHAOS_SECONDS:.0f} s under seed {CHAOS_SEED} rates {json.dumps(report['rates'])}: "
        f"injected {report['injected']}; ledger {report['ledger']}; {restarts} restarts; "
        f"dead letters {out['dead_letters']}; {steps} steps launched {launches}; e2e ms "
        f"chaos {out['e2e_chaos_ms']} probe {out['e2e_probe_ms']}; staging {staging}; "
        f"threads {threads}; {len(edges)} lock edges, no inversion; {soak_s:.1f} s")
    return out


def chaos_restart(dev, card: str, ctx: dict) -> dict:
    """Phase 16 (b) (module docstring): one supervised crash at full width;
    the 2^20-row gallery rolled back to the checkpoint bit for bit and the
    planted faces named after the restart."""
    stack, frames, n_plant = ctx["stack"], ctx["frames"], ctx["n_plant"]
    gallery = stack.gallery
    ranges = planted_ranges(stack, frames)
    names = [f"p{i}" for i in range(n_plant)]
    crash, first_after = {"left": 1, "t": None}, {}

    class CrashOnce(FakeConnector):
        """Raises from the first result publish: the readback worker dies."""

        def publish(self, topic, message):
            if topic == RESULT_TOPIC and crash["left"]:
                crash["left"] = 0
                crash["t"] = time.monotonic()
                raise RuntimeError("result consumer blew up")
            if topic == RESULT_TOPIC and (message.get("meta") or {}).get("k") == "after":
                first_after.setdefault("t", time.monotonic())
            super().publish(topic, message)

        inject = publish

    conn = CrashOnce()
    service = RecognizerService(stack, conn, batch_size=BATCH, frame_shape=FRAME,
                                flush_timeout=0.02, ingest=IngestConfig("uint8"),
                                similarity_threshold=0.5, subject_names=names,
                                resilience=ResiliencePolicy(readback_deadline_s=5.0))
    supervisor = ServiceSupervisor(service, max_restarts=3, poll_interval_s=0.05)
    supervisor.start()
    zero_counters()
    captures0 = (stack.captures, stack.recaptures)
    try:
        snap = gallery.snapshot()  # what the supervisor's checkpoint holds
        dev_emb = gallery.data.embeddings[:snap[3]].cpu()
        dev_lab = gallery.data.labels[:snap[3]].cpu()
        rng = np.random.default_rng(16)
        gallery.add(rng.standard_normal((CHAOS_ADDED_ROWS, DIM), dtype=np.float32),
                    np.full(CHAOS_ADDED_ROWS, -7, np.int32))
        if gallery.size != snap[3] + CHAOS_ADDED_ROWS:
            raise AssertionError("chaos (b): the rows after the checkpoint did not land")
        for i in range(BATCH):
            conn.inject(FRAME_TOPIC, {**encode_frame(frames[i]), "meta": {"k": "bait", "i": i}})
        wait_for(lambda: service.metrics.counter(SUPERVISOR_RESTARTS) >= 1, 60.0,
                 "chaos (b): the supervisor's restart", poll=0.005)
        restart_s = time.monotonic() - crash["t"]
        # the frames first, the checks after: the first answer's seconds
        # are the service's, not the checks'
        for i in range(BATCH):
            conn.inject(FRAME_TOPIC, {**encode_frame(frames[i]), "meta": {"k": "after", "i": i}})
        wait_for(lambda: sum((m.get("meta") or {}).get("k") == "after"
                             for m in conn.messages(RESULT_TOPIC)) >= BATCH, 60.0,
                 "chaos (b): the answers after the restart")
        got = gallery.snapshot()
        if not (got[3] == snap[3] and all(np.array_equal(a, b) for a, b in zip(got, snap))
                and torch.equal(gallery.data.embeddings[:snap[3]].cpu(), dev_emb)
                and torch.equal(gallery.data.labels[:snap[3]].cpu(), dev_lab)):
            raise AssertionError("chaos (b): the gallery does not equal its checkpoint")
        after = [m for m in conn.messages(RESULT_TOPIC)
                 if (m.get("meta") or {}).get("k") == "after"]
        found = chaos_probe_check(after, ranges, key="i")
        named = sum(f["name"] == names[f["label"]] for r in after for f in r["faces"])
        if named != found["faces"]:
            raise AssertionError("chaos (b): a planted face was not named after the restart")
        counters = service.metrics.counters()
    finally:
        supervisor.stop()
    if counters.get(LOOP_CRASHES, 0) != 1 or supervisor.restarts != 1 or supervisor.gave_up:
        raise AssertionError(f"chaos (b): {counters.get(LOOP_CRASHES, 0)} crashes, "
                             f"{supervisor.restarts} restarts (gave up: {supervisor.gave_up})")
    out = dict(crash_to_restart_s=restart_s,
               crash_to_first_answer_s=first_after["t"] - crash["t"],
               captures=stack.captures - captures0[0],
               recaptures=stack.recaptures - captures0[1],
               recompiles_post_warmup=counters.get(mn.RECOMPILES_POST_WARMUP, 0),
               gallery_rows=int(snap[3]), added_rows=CHAOS_ADDED_ROWS,
               frames_dropped_crashed=counters.get(FRAMES_DROPPED_CRASHED, 0),
               faces_named=named, launches=read_launches())
    log(f"chaos (b) ({card}): a crash in the readback worker; the supervisor restored the "
        f"{snap[3]}-row gallery bit for bit ({CHAOS_ADDED_ROWS} rows after the checkpoint "
        f"rolled back) and restarted the loop in {restart_s:.3f} s; first answer "
        f"{out['crash_to_first_answer_s']:.3f} s after the crash; {named} planted faces named; "
        f"{out['recaptures']} re-captures, {out['captures']} captures")
    return out


def chaos_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 16 (module docstring); returns the ``{"chaos": ...}`` numbers,
    the soak's and the restart's kernel launches among them."""
    t_phase = time.perf_counter()
    out = {"card": card, "soak": chaos_soak_run(dev, card, ctx)}
    out["restart"] = chaos_restart(dev, card, ctx)
    out["launches"] = {k: out["soak"]["launches"][k] + out["restart"]["launches"][k]
                       for k in out["soak"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: phase 17 (a): the embedder variants at the serving widths (ROADMAP A.9),
#: each built from --seed: (name, FaceEmbedNet kwargs over the serving ones)
VAR_VARIANTS = (("s2", dict(space_to_depth=2)), ("s4", dict(space_to_depth=4)),
                ("light", dict(norm="light")), ("dense", dict(block="dense")))
#: faces a forward takes (batch 32 x 16 slots, the serving step's)
VAR_FACES = BATCH * MAX_FACES
#: the fused schedule against the unfused forward, both bf16, the least
#: cosine over VAR_FACES random faces: two rounding schedules (kernel B
#: keeps f32 between a block's stages, the unfused blocks round each op to
#: bf16). The serving net (s = 1) gives 0.99988 on the CPU's tiny config,
#: and the JAX package's own fused forward is 0.99984 from flax at s = 2
#: there (tests/test_torch_embedder_variants.py); s = 1 on these faces is
#: recorded beside the variants'
VAR_FUSED_COS = 0.999
#: batches the s = 2 stack serves through a ``RecognizerService``
VAR_SERVE_BATCHES = 2
#: (b) each classic row of ``apps.measure_accuracy.CONFIGS`` against its
#: figure in ``BASELINE.md``'s MEASURED block (its result key: accuracy)
ACC_BASELINE = {"eigenfaces_orl": 0.8950, "fisherfaces_yaleb": 0.8283, "lbph_lfw": 0.9250,
                "lbp_fisherfaces_yaleb": 0.9817, "lbp_fisherfaces_lfw": 0.9625,
                "lbp_fisherfaces_orl": 0.9975}
ACC_SIZE = (70, 70)
ACC_TOL = 0.01
#: (b') ``apps.oracle_parity`` rows run on the card, each with its oracle
#: figure in ``BASELINE.md``'s ORACLE block
ORACLE_ROWS = {"fisherfaces_hard": 0.8306, "lbph_hard": 0.9250}
#: the reference's agreement bar between the framework and the oracle
ORACLE_DELTA = 0.02
#: LBP codes on the card against the CPU's: a code on a float tie may flip
LBP_AGREE = 0.999
#: (c) ``ocvf-train-torch`` at Extended Yale-B's size (``BASELINE.json:8``):
#: 38 subjects x 64 images, the Yale-B analog's hard arguments
YALEB_SUBJECTS = 38
YALEB_PER_SUBJECT = 64
YALEB_FACES = dict(seed=2, illumination=0.7, noise=14.0, **measure_accuracy.HARD_POSE)
#: the CLI runs: (name, flags beyond the defaults). The kernel SVM trains
#: in phase 18 (e)'s ``--model auto --classifier kernel_svm`` run, which
#: k-folds every family with it and saves its winner with it
TRAIN_RUNS = (("fisherfaces", ()), ("lbph", ("--model", "lbph")))
#: images each checkpoint predicts on the card and on the CPU
TRAIN_CHECK_QUERIES = 64


def variant_net(dev, seed: int, kw: dict, dtype=torch.bfloat16) -> embedder_mod.FaceEmbedNet:
    """A serving-width ``FaceEmbedNet`` with ``kw`` on top, weights from
    ``seed`` (the same for every dtype and device)."""
    return embedder_mod.FaceEmbedNet(
        **{**embedder_mod.SERVING_EMBEDDER_KWARGS, **kw},
        input_size=embedder_mod.SERVING_FACE_SIZE, dtype=dtype,
        generator=torch.Generator().manual_seed(seed + 1)).to(dev).eval()


def block_shapes(net: embedder_mod.FaceEmbedNet) -> list:
    """(H, W, C, F, stride) of each stage block of ``net`` at its input size."""
    h, w = net.input_size
    s = net.space_to_depth
    h, w = h // s // net.stem.stride, w // s // net.stem.stride
    shapes = []
    for blk in net.blocks:
        c, f = blk.dw.weight.shape[0], blk.pw.weight.shape[0]
        shapes.append((h, w, c, f, blk.stride))
        h, w = h // blk.stride, w // blk.stride
    return shapes


def _min_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float().cpu() * b.float().cpu()).sum(-1).min())


def check_new_blocks(dev, gen, shapes: list) -> dict:
    """Kernel B against its plain version at block shapes the serving net
    does not have (SEP_BATCHES, bf16 and f32), each timed at B = VAR_FACES
    in bf16: events around eager calls and device time from a graph."""
    out = {}
    for h, w, c, f, stride in shapes:
        res = stride == 1 and c == f
        _blk, args = _sep_args(gen, c, f, stride, dev)
        what = f"{h}x{w}x{c}->{h // stride}x{w // stride}x{f} s{stride}"
        errs = {}
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            xs = torch.randn(max(SEP_BATCHES), h, w, c, generator=gen).to(dev, dtype)
            for nb in SEP_BATCHES:
                errs[f"{name} B={nb}"] = _sep_case(xs[:nb], args, stride, res,
                                                   f"{what} {name} B={nb}")
        x = torch.randn(VAR_FACES, h, w, c, generator=gen).to(dev, torch.bfloat16)
        entry = {"max_err": max(errs.values()), "residual": res}
        if dev.type == "cuda":
            with torch.no_grad():
                entry["ms"] = cuda_ms(lambda: fused_sep_block(x, *args, stride=stride,
                                                              residual=res))
                entry["device_ms"] = graph_ms(lambda: fused_sep_block(x, *args, stride=stride,
                                                                      residual=res))
            entry["plan"] = sepblock_launch_info(x, f, stride)
        log(f"kernel B new block {what}: max err "
            + ", ".join(f"{t} {e:.3e}" for t, e in errs.items())
            + (f"; {entry['ms']:.4f} ms eager, {entry['device_ms']:.4f} ms device time at "
               f"B={VAR_FACES}; {entry['plan']}" if "ms" in entry else ""))
        out[what] = entry
    return out


def _forward_times(dev, fn) -> dict:
    if dev.type != "cuda":
        return {}
    with torch.no_grad():
        return {"ms": cuda_ms(fn, iters=10), "device_ms": graph_ms(fn, iters=10)}


def variant_forwards(dev, seed: int, faces: np.ndarray) -> tuple:
    """Each variant's eager forward on ``dev`` (bf16 and f32) against its
    plain f32 version on the CPU; for the space-to-depth variants the
    fused forward (kernel B) against the unfused one, and the new block
    shapes. Returns ({variant: numbers}, the new block shapes)."""
    out, new_shapes = {}, []
    x_cpu = torch.as_tensor(faces)
    x = x_cpu.to(dev)
    serving = variant_net(dev, seed, {})
    with torch.no_grad():
        out["serving_s1_fused_min_cos_vs_unfused"] = _min_cos(
            embedder_mod.fused_forward(serving, x), serving(x))
    for name, kw in VAR_VARIANTS:
        plain = variant_net("cpu", seed, kw, torch.float32)
        with torch.no_grad():
            want = plain(x_cpu)
            got32 = variant_net(dev, seed, kw, torch.float32)(x)
            net = variant_net(dev, seed, kw)
            got = net(x)
        err = 1.0 - _min_cos(got32, want)
        log(f"variant {name}: f32 on {dev} vs the CPU's, 1 - min cos {err:.3e}")
        if err > XCHECK_SIM or float((got32.cpu() - want).abs().max()) > XCHECK_SIM:
            raise AssertionError(f"variant {name}: the eager f32 forward on {dev} differs from "
                                 f"the plain f32 version by 1 - cos {err:.3e}")
        entry = {"f32_one_minus_cos": err, "bf16_min_cos_vs_f32": _min_cos(got, want),
                 "eager": _forward_times(dev, lambda: net(x))}
        if dict(kw).get("space_to_depth", 1) > 1:
            with torch.no_grad():
                fused = embedder_mod.fused_forward(net, x)
            cos = _min_cos(fused, got)
            log(f"variant {name}: fused vs unfused min cos {cos}")
            if cos < VAR_FUSED_COS:
                raise AssertionError(f"variant {name}: fused forward min cos {cos} against "
                                     f"the unfused one (bar {VAR_FUSED_COS})")
            entry["fused_min_cos_vs_unfused"] = cos
            entry["fused"] = _forward_times(dev, lambda: embedder_mod.fused_forward(net, x))
            entry["blocks"] = [list(s) for s in block_shapes(net)]
            new_shapes += [s for s in block_shapes(net)
                           if list(s) not in map(list, SERVING_BLOCKS) and s not in new_shapes]
        log(f"variant {name}: {entry}")
        out[name] = entry
    return out, new_shapes


def variant_serving(dev, seed: int, ctx: dict) -> dict:
    """Phase 4's detector and 2^20-row gallery with the s = 2 embedder,
    fused: one graphed step against the eager step (bit for bit), then
    VAR_SERVE_BATCHES batches through a ``RecognizerService`` (launches
    counted from zero in ``run_service``); the light and dense variants
    refused by the fused pipeline."""
    base = ctx["stack"]
    net = variant_net(dev, seed, dict(space_to_depth=2))
    graphed = RecognitionPipeline(base.detector, net, base.gallery, face_size=base.face_size,
                                  fused_embedder=True, device=dev)
    eager = RecognitionPipeline(base.detector, net, base.gallery, face_size=base.face_size,
                                fused_embedder=True, device=dev, cuda_graphs=False)
    batch = ctx["frames"][:BATCH]
    try:
        a = graphed.recognize_batch_packed(batch)
        a = graphed.recognize_batch_packed(batch)  # a replay on the card
        b = eager.recognize_batch_packed(batch)
        if not torch.equal(a, b):
            raise AssertionError("s = 2 fused: the graphed step differs from the eager step "
                                 f"(max {(a - b).abs().max().item()})")
        results, launches, service, serve_s = run_service(
            graphed, ctx["frames"][:VAR_SERVE_BATCHES * BATCH])
        refused = {}
        for name, kw in VAR_VARIANTS:
            if "space_to_depth" in kw:
                continue
            try:
                RecognitionPipeline(base.detector, variant_net(dev, seed, kw), base.gallery,
                                    face_size=base.face_size, fused_embedder=True, device=dev)
            except ValueError as exc:
                refused[name] = str(exc)
            else:
                raise AssertionError(f"the fused pipeline took the {name} embedder")
        step = ({"graphed_host_ms": step_time_ms(graphed, batch),
                 "eager_host_ms": step_time_ms(eager, batch)} if dev.type == "cuda" else {})
    finally:
        drop_stack(graphed)
        drop_stack(eager)
    out = {"graphed_equals_eager": True, "results": len(results), "launches": launches,
           "serve_s": serve_s, "ledger": service.ledger(), "refused": refused, "step": step}
    log(f"s = 2 fused serving: {out}")
    return out


def lbp_agreement(dev, images: np.ndarray) -> dict:
    """Share of LBP codes (radius 2 and 3) equal on ``dev`` and the CPU."""
    out = {}
    for radius in (2, 3):
        got = lbp_mod.extended_lbp(torch.as_tensor(images, device=dev), radius).cpu()
        want = lbp_mod.extended_lbp(torch.as_tensor(images), radius)
        share = float((got == want).float().mean())
        if share < LBP_AGREE:
            raise AssertionError(f"LBP r={radius}: {share} of codes agree with the CPU's "
                                 f"(bar {LBP_AGREE})")
        out[f"r{radius}"] = share
    return out


def accuracy_protocols(dev) -> dict:
    """Phase 17 (b): the six classic rows of ``apps.measure_accuracy``
    on ``dev``; each accuracy within ACC_TOL of its ``BASELINE.md`` row."""
    out = {}
    for row, thunk in measure_accuracy.CONFIGS.values():
        if row not in ACC_BASELINE:
            continue  # the CNN row: phase 18 (b), and the north star alone
        want = ACC_BASELINE[row]
        t0 = time.perf_counter()
        got = thunk(dev)
        out[row] = {**got, "baseline": want, "wall_s": time.perf_counter() - t0}
        if abs(got["accuracy"] - want) > ACC_TOL:
            raise AssertionError(f"{row}: 10-fold accuracy {got['accuracy']:.4f} on {dev}, "
                                 f"BASELINE.md {want} (tolerance {ACC_TOL})")
        log(f"protocol {row}: {out[row]}")
    X, _y, _names = dataset_utils.make_synthetic_faces(
        num_subjects=30, per_subject=12, size=ACC_SIZE, **YALEB_FACES)
    out["lbp_agreement"] = lbp_agreement(dev, X)
    return out


def oracle_rows(dev) -> dict:
    """Phase 17 (b'): ``apps.oracle_parity.parity_row`` for ORACLE_ROWS,
    the framework on ``dev`` and the oracle on the host; |delta| within
    ORACLE_DELTA and the oracle within ACC_TOL of ``BASELINE.md``."""
    out = {}
    for key, want in ORACLE_ROWS.items():
        t0 = time.perf_counter()
        row = oracle_parity.parity_row(key, dev, size=ACC_SIZE)
        out[key] = {**row, "oracle_baseline": want, "wall_s": time.perf_counter() - t0}
        log(f"oracle {key}: {out[key]}")
        if abs(row["delta"]) > ORACLE_DELTA:
            raise AssertionError(f"oracle {key}: framework {row['framework']} on {dev} against "
                                 f"the oracle's {row['oracle']} (bar {ORACLE_DELTA})")
        if abs(row["oracle"] - want) > ACC_TOL:
            raise AssertionError(f"oracle {key}: {row['oracle']} against BASELINE.md's {want} "
                                 f"(tolerance {ACC_TOL})")
    return out


def write_dataset(root: str, images: np.ndarray, labels: np.ndarray, names: list) -> None:
    """``root/<subject>/<i>.pgm``, the layout ``read_images`` walks."""
    shutil.rmtree(root, ignore_errors=True)
    for i, (img, label) in enumerate(zip(images, labels)):
        subject = os.path.join(root, names[label])
        os.makedirs(subject, exist_ok=True)
        write_pgm(os.path.join(subject, f"{i:05d}.pgm"), np.clip(np.round(img), 0, 255))


def train_cli(dev, data: str, ckpt: str, flags) -> dict:
    """``ocvf-train-torch`` in a subprocess; returns its stage report, mean
    k-fold accuracy and wall seconds."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.train", data, ckpt,
           *flags, "--image-size", *map(str, ACC_SIZE),
           *(["--device", "cpu"] if dev.type == "cpu" else [])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"ocvf-train-torch {' '.join(flags)}: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    stages = [json.loads(line.split("train stages: ", 1)[1])
              for line in proc.stderr.splitlines() if line.startswith("train stages: ")]
    accs = [float(line.rsplit(" ", 1)[1]) for line in proc.stdout.splitlines()
            if line.startswith("mean k-fold accuracy: ")]
    accs += [float(line.split("(", 1)[1].split(" ", 1)[0]) for line in proc.stdout.splitlines()
             if line.startswith("selected: ")]
    if len(stages) != 1 or len(accs) != 1:
        raise AssertionError(f"ocvf-train-torch {' '.join(flags)}: no stage report or "
                             f"accuracy in its output\n{proc.stdout}\n{proc.stderr}")
    out = {"rc": proc.returncode, "wall_s": seconds, "accuracy": accs[0], **stages[0]}
    selected = [line for line in proc.stdout.splitlines() if line.startswith("selected: ")]
    if selected:
        out["selected"] = selected[0].split()[1]
        out["scores"] = {line.split(":")[0].strip(): float(line.split(":")[1].split()[0])
                         for line in proc.stdout.splitlines() if line.endswith(" k-fold")}
    return out


def checkpoint_labels_agree(dev, ckpt: str, queries: np.ndarray) -> dict:
    """The checkpoint loaded on ``dev`` and on the CPU predicts the same
    labels for ``queries``."""
    t0 = time.perf_counter()
    got, _ = serialization.load_model(ckpt, device=dev).predict(queries)
    card_s = time.perf_counter() - t0
    want, _ = serialization.load_model(ckpt, device="cpu").predict(queries)
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        raise AssertionError(f"{ckpt}: labels on {dev} differ from the CPU's on "
                             f"{int((np.asarray(got) != np.asarray(want)).sum())} queries")
    return {"queries": len(queries), "labels_equal": True, "load_predict_s": card_s}


def train_cli_phase(dev, root: str) -> dict:
    """Phase 17 (c): ``ocvf-train-torch`` on an Extended Yale-B-sized
    dataset of PGM files, the TRAIN_RUNS; each checkpoint held on the card
    against the CPU."""
    X, y, names = dataset_utils.make_synthetic_faces(
        num_subjects=YALEB_SUBJECTS, per_subject=YALEB_PER_SUBJECT, size=ACC_SIZE,
        **YALEB_FACES)
    data = os.path.join(root, "yaleb")
    t0 = time.perf_counter()
    write_dataset(data, X, y, names)
    out = {"images": len(y), "subjects": len(names), "write_s": time.perf_counter() - t0}
    queries = np.clip(np.round(X[::len(y) // TRAIN_CHECK_QUERIES][:TRAIN_CHECK_QUERIES]),
                      0, 255).astype(np.uint8).astype(np.float32)
    for name, flags in TRAIN_RUNS:
        ckpt = os.path.join(root, f"{name}.ckpt")
        run = train_cli(dev, data, ckpt, flags)
        run["checkpoint"] = checkpoint_labels_agree(dev, ckpt, queries)
        log(f"ocvf-train-torch {name}: {run}")
        out[name] = run
    return out


def train_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 17 (module docstring); returns the ``{"train": ...}`` numbers,
    the s = 2 serving run's kernel launches among them."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_smoke")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed + 17)
    faces = rng.standard_normal((VAR_FACES, *embedder_mod.SERVING_FACE_SIZE)).astype(np.float32)
    gen = torch.Generator().manual_seed(seed + 17)
    out = {"card": card}
    out["variants"], new_shapes = variant_forwards(dev, seed, faces)
    out["new_blocks"] = check_new_blocks(dev, gen, new_shapes)
    out["serving_s2"] = variant_serving(dev, seed, ctx)
    out["launches"] = out["serving_s2"]["launches"]
    t0 = time.perf_counter()
    out["protocols"] = accuracy_protocols(dev)
    out["protocols_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["oracle"] = oracle_rows(dev)
    out["oracle_s"] = time.perf_counter() - t0
    out["train_cli"] = train_cli_phase(dev, root)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------- phase 18: training on the card (ROADMAP A.13) ----------

#: (a) the card's f32 step against the CPU's, per gradient tensor relative
#: to its largest |g|: the same f32 arithmetic, cuDNN's and the CPU's
#: convolution algorithms summing in other orders (TF32 off). A depthwise
#: weight's gradient sums 192 x 16 x 16 products that largely cancel (the
#: GroupNorm after it removes their mean): the first card run measured
#: 4.7e-3 at block 2's (NVIDIA H100 80GB HBM3, 700.00 W); the bar leaves 4x. The norm-wise error of each
#: tensor is recorded beside it
ARC_GRAD_RTOL = 2e-2
#: (a) the loss of that step, absolute
ARC_LOSS_ATOL = 1e-4
#: (a) the serving widths' batch, and the detector's and gate's batches
ARC_BATCH = 192
DET_GRAD_BATCH = 16
#: (b) ArcFace steps at the HARD protocol's recipe (the reference's round-2
#: net reached 0.9342 at 2000 steps without augmentation), the steps timed
#: by CUDA events, the profiled steps, and the accuracy bar (a broken
#: trainer lands near 0.5)
ARC_STEPS = 2000
ARC_TIME_STEPS = (100, 300)
ARC_PROFILE_STEPS = 5
ARC_MIN_ACC = 0.85
#: (b) mean loss over the first and the last ARC_LOSS_WINDOW steps
ARC_LOSS_WINDOW = 100
#: (c) held-out faces of each identity enrolled (the other half query);
#: then ``finetune_embedder`` on the enrolled faces at its defaults (100
#: steps of 8 identities x 4 faces)
ARC_ENROL = 6
ARC_RANK1_MIN = 0.80
FINETUNE_STEPS = 100
#: (d) the reference's small recipes (tests/test_detector.py:60-65,
#: tests/test_cascade.py:411-417) and their held-out bands
DET_SMALL = dict(features=(8, 16, 32), head_features=32, max_faces=4, score_threshold=0.25,
                 space_to_depth=1)
DET_SMALL_TRAIN = dict(steps=250, batch_size=16, learning_rate=2e-3)
DET_BANDS = dict(recall=0.9, precision=0.9, mean_matched_iou=0.7)
GATE_TRAIN = dict(steps=300, batch_size=32)
#: (d) the serving detector's recipe (bench_serving.py:64-71) and the JAX
#: package's recall at it on the CPU, from flax's init at seed 0:
#: ``JAX_PLATFORMS=cpu python tests/reference_recipes.py serving-detector``
#: gave 125 of 126 faces, precision 1.0, matched IoU 0.8968
DET_SERVING_TRAIN = dict(num_scenes=48, scene_size=(256, 256), max_faces=8,
                         face_size_range=(24, 56), seed=7)
DET_SERVING_HELD = dict(DET_SERVING_TRAIN, num_scenes=32, seed=9)
DET_SERVING_STEPS = 150
DET_SERVING_JAX_RECALL = 125 / 126
DET_SERVING_RECALL_TOL = 0.05
#: (e) ``--model auto``'s smaller set: subjects x images; the two runs:
#: (name, dataset, flags beyond the defaults). Auto runs with the kernel
#: SVM: the one CLI run of it on the card
AUTO_SUBJECTS, AUTO_PER_SUBJECT = 12, 16
TRAINING_CLI_RUNS = (("cnn", "yaleb", ("--model", "cnn")),
                     ("auto", "auto", ("--model", "auto", "--classifier", "kernel_svm")))

#: (f) the embedder gate on a non-default structure at a short run of the
#: HARD protocol (the gate's default is 9000 steps of batch 128)
GATE_STEPS = 300
GATE_ARGV = ("--block", "dense", "--space-to-depth", "2", "--norm", "light")
GATE_TAG = "dense_s2d2_light"
#: the row's fields (``scripts/gate_embedder.py``'s)
GATE_FIELDS = ("tag", "accuracy", "std", "mean_minus_2std", "fold_min", "threshold",
               "train_s", "config", "date")
#: above chance: the structure trains (a gate's verdict needs its full run)
GATE_MIN_ACC = 0.6


def _grads_vs_cpu(dev, build, loss_of, what: str) -> dict:
    """One f32 forward and backward of ``build(device)`` on the card and on
    the CPU from the same weights and inputs: ``ok`` when each gradient
    tensor is within ARC_GRAD_RTOL of the CPU's (relative to its largest
    |g|) and the loss within ARC_LOSS_ATOL."""
    from opencv_facerecognizer_tpu_torch.utils.device import disable_tf32

    if dev.type == "cuda":
        disable_tf32()
    out = {}
    for d in (torch.device("cpu"), dev):
        net = build(d)
        t0 = time.perf_counter()
        loss = loss_of(net, d)
        loss.backward()
        if d.type == "cuda":
            torch.cuda.synchronize(d)
        out[d.type] = (loss.item(), {n: p.grad.float().cpu() for n, p in net.named_parameters()},
                       time.perf_counter() - t0)
    (l_cpu, g_cpu, s_cpu), (l_dev, g_dev, s_dev) = out["cpu"], out[dev.type]
    worst = max((float((g_dev[n] - g).abs().max() / max(float(g.abs().max()), 1e-30)), n)
                for n, g in g_cpu.items())
    worst_l2 = max(float((g_dev[n] - g).norm() / max(float(g.norm()), 1e-30))
                   for n, g in g_cpu.items())
    res = {"loss": l_dev, "loss_cpu": l_cpu, "max_grad_rel_err": worst[0],
           "worst_tensor": worst[1], "max_grad_l2_rel_err": worst_l2, "tensors": len(g_cpu),
           "step_s": s_dev, "cpu_step_s": s_cpu,
           "ok": worst[0] <= ARC_GRAD_RTOL and abs(l_dev - l_cpu) <= ARC_LOSS_ATOL}
    log(f"(a) {what}: {res}")
    return res


def train_steps_vs_cpu(dev, seed: int) -> dict:
    """Phase 18 (a): one ArcFace step at the serving widths (batch
    ARC_BATCH, 64x64, one set of augmentation draws), one ``detector_loss``
    step of the serving detector and one ``gate_loss`` step of the
    default gate (DET_GRAD_BATCH 256x256 scenes), card against CPU."""
    rng = np.random.default_rng(seed + 18)
    x = rng.standard_normal((ARC_BATCH, *embedder_mod.SERVING_FACE_SIZE)).astype(np.float32)
    y = rng.integers(0, 64, ARC_BATCH)
    head = embedder_mod.draw_head(64, DIM, seed)
    draws = embedder_mod.augment_draws(torch.Generator().manual_seed(seed), ARC_BATCH,
                                       *embedder_mod.SERVING_FACE_SIZE)

    def arc_loss(net, d):
        faces = embedder_mod.augment_transform(torch.as_tensor(x).to(d),
                                               {k: v.to(d) for k, v in draws.items()})
        return embedder_mod.arcface_loss(net(faces), torch.as_tensor(y).to(d), head.to(d), 0.5)

    out = {"arcface": _grads_vs_cpu(
        dev, lambda d: variant_net(d, seed, {}, torch.float32).train(), arc_loss,
        f"ArcFace step, batch {ARC_BATCH}")}
    scenes, boxes, counts = dataset_utils.make_synthetic_scenes(
        **dict(DET_SERVING_TRAIN, num_scenes=DET_GRAD_BATCH))
    targets = dict(zip(("heatmap", "size", "offset", "mask"),
                       detector_mod.gaussian_heatmap_targets(boxes, counts, FRAME, boxes.shape[1])))
    out["detector"] = _grads_vs_cpu(
        dev, lambda d: detector_mod.DetectorNet(
            features=(64, 64), head_features=64, space_to_depth=4, dtype=torch.float32,
            generator=torch.Generator().manual_seed(seed)).to(d),
        lambda net, d: detector_mod.detector_loss(
            net(torch.as_tensor(scenes).to(d)),
            {k: torch.as_tensor(v).to(d) for k, v in targets.items()}),
        f"detector_loss step, batch {DET_GRAD_BATCH}")
    tiles = cascade_mod.tile_targets(boxes, counts, FRAME, 4 * cascade_mod.TILE_CONV_STRIDE)
    out["gate"] = _grads_vs_cpu(
        dev, lambda d: cascade_mod.CascadeNet(
            dtype=torch.float32, generator=torch.Generator().manual_seed(seed)).to(d),
        lambda net, d: cascade_mod.gate_loss(net(torch.as_tensor(scenes).to(d)),
                                             torch.as_tensor(tiles).to(d)),
        f"gate_loss step, batch {DET_GRAD_BATCH}")
    bad = {k: v for k, v in out.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"(a) the card's step differs from the CPU's (gradient bar "
                             f"{ARC_GRAD_RTOL}, loss bar {ARC_LOSS_ATOL}): {bad}")
    return out


class StepRecorder:
    """``CNNEmbedding.train_callback``: the losses (device scalars), CUDA
    events at the two ARC_TIME_STEPS, and a ``torch.profiler`` over the
    ARC_PROFILE_STEPS steps after them with the host clock around them."""

    def __init__(self, dev):
        self.dev = dev
        self.losses = []
        self.events = {}
        self.prof = None
        self.prof_wall_s = 0.0
        self.prof_rows = []
        first, last = ARC_TIME_STEPS
        self.prof_span = (last + 10, last + 10 + ARC_PROFILE_STEPS)

    def __call__(self, i: int, loss: torch.Tensor) -> None:
        self.losses.append(loss)
        if self.dev.type != "cuda":
            return
        if i in ARC_TIME_STEPS:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[i] = ev
        start, stop = self.prof_span
        if i == start - 1:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(self.dev)
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self._t0 = time.perf_counter()
        elif i == stop - 1 and self.prof is not None:
            from torch.autograd import DeviceType

            torch.cuda.synchronize(self.dev)
            self.prof_wall_s = time.perf_counter() - self._t0
            self.prof.stop()
            self.prof_rows = [e for e in self.prof.key_averages()
                              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            self.prof = None

    def report(self, steps: int) -> dict:
        losses = torch.stack(self.losses).float().cpu().numpy() if self.losses else np.zeros(0)
        w = min(ARC_LOSS_WINDOW, len(losses))
        out = {"steps": steps, "loss_first": float(losses[:w].mean()) if w else None,
               "loss_last": float(losses[-w:].mean()) if w else None}
        first, last = ARC_TIME_STEPS
        if first in self.events and last in self.events:
            out["ms_per_step"] = self.events[first].elapsed_time(self.events[last]) / (last - first)
        if self.prof_rows:
            n = ARC_PROFILE_STEPS
            device_ms = sum(e.self_device_time_total for e in self.prof_rows) / 1e3 / n
            wall_ms = self.prof_wall_s * 1e3 / n
            out.update(device_ms_per_step=device_ms, profiled_wall_ms_per_step=wall_ms,
                       busy=device_ms / wall_ms,
                       device_ops_per_step=sum(e.count for e in self.prof_rows) / n)
            for e in sorted(self.prof_rows, key=lambda e: -e.self_device_time_total)[:8]:
                log(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms  x{e.count // n:<5d} "
                    f"{e.key[:90]}")
        return out


def arcface_run(dev, steps: int) -> tuple:
    """Phase 18 (b): ``apps.measure_accuracy.cnn_verification`` at
    ``steps`` steps on ``dev``. Returns (numbers, the trained embedder,
    the protocol's data)."""
    from opencv_facerecognizer_tpu_torch.apps import measure_accuracy

    t0 = time.perf_counter()
    data = measure_accuracy.hard_protocol()
    data_s = time.perf_counter() - t0
    emb = measure_accuracy.hard_embedder(steps, dev)
    rec = emb.train_callback = StepRecorder(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    result = measure_accuracy.cnn_verification(steps, dev, embedder=emb, data=data)
    out = {**result, "data_s": data_s, "run_s": time.perf_counter() - t0, **rec.report(steps)}
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"(b) ArcFace at the HARD protocol, {steps} steps: {out}")
    if result["accuracy"] < ARC_MIN_ACC:
        raise AssertionError(f"ArcFace: verification accuracy {result['accuracy']} after "
                             f"{steps} steps (bar {ARC_MIN_ACC})")
    return out, emb, data


def trained_embedder_served(dev, ctx: dict, emb, data) -> dict:
    """Phase 18 (c): ARC_ENROL held-out faces of each identity in a
    2^20-row bf16 gallery among phase 4's random rows, the others queried
    through ``gallery.match`` (kernel A): rank-1 identification; the
    trained net's fused forward (kernel B) against its unfused one
    (launches counted from zero); then the fine-tune."""
    _X_tr, _y_tr, X_te, y_te = data
    X_te = np.asarray(X_te, np.float32)
    y_te = np.asarray(y_te)
    enrol = np.concatenate([np.flatnonzero(y_te == c)[:ARC_ENROL] for c in np.unique(y_te)])
    query = np.setdiff1d(np.arange(len(y_te)), enrol)
    zero_counters()
    e_enrol = emb.extract(X_te[enrol]).float().cpu().numpy()
    e_query = emb.extract(X_te[query]).to(dev)
    rows = ctx["rows"][:GALLERY_ROWS - len(enrol)]
    gallery = ShardedGallery(GALLERY_ROWS, DIM, store_dtype=torch.bfloat16, device=dev)
    gallery.add(np.concatenate([rows / np.linalg.norm(rows, axis=1, keepdims=True), e_enrol]),
                np.concatenate([ctx["labels"][:len(rows)], y_te[enrol]]).astype(np.int32))
    labels, sims, _ = gallery.match(e_query, k=1)
    rank1 = float((labels[:, 0].cpu().numpy() == y_te[query]).mean())
    with torch.no_grad():
        faces = embedder_mod.normalize_faces(torch.as_tensor(X_te).to(dev), emb.input_size)
        cos = _min_cos(embedder_mod.fused_forward(emb.net, faces), emb.net(faces))
    launches = read_launches()
    del gallery
    out = {"enrolled": len(enrol), "queries": len(query), "rank1": rank1,
           "fused_min_cos_vs_unfused": cos, "launches": launches,
           "finetune": finetune_check(dev, emb, X_te[enrol], y_te[enrol])}
    log(f"(c) the trained embedder served: {out}")
    if rank1 < ARC_RANK1_MIN:
        raise AssertionError(f"rank-1 {rank1} through kernel A (bar {ARC_RANK1_MIN})")
    if cos < VAR_FUSED_COS:
        raise AssertionError(f"trained net: fused forward min cos {cos} (bar {VAR_FUSED_COS})")
    if dev.type == "cuda" and (launches["streaming_match"] < 1 or launches["sepblock"] < 6):
        raise AssertionError(f"(c) did not launch kernels A and B: {launches}")
    return out


def finetune_check(dev, emb, images: np.ndarray, labels: np.ndarray) -> dict:
    """``TheTrainer.finetune_embedder`` (FINETUNE_STEPS multibatch steps)
    from the trained embedder serving in a trainer's model: the serving
    feature's tensors equal bit for bit afterwards, the new one's moved."""
    trainer = trainer_mod.TheTrainer(model="cnn", device=dev)
    trainer.model = trainer_mod.ExtendedPredictableModel(
        emb, NearestNeighbor(CosineDistance(), device=dev), image_size=emb.input_size)
    before = {k: v.clone() for k, v in emb.net.state_dict().items()}
    head = emb._head.clone()
    tuned = []
    seconds = _timed_train(dev, lambda: tuned.append(trainer.finetune_embedder(
        images, labels, steps=FINETUNE_STEPS)))
    new = tuned[0]
    unchanged = (all(torch.equal(v, before[k]) for k, v in emb.net.state_dict().items())
                 and torch.equal(emb._head, head))
    if not unchanged:
        raise AssertionError("finetune_embedder changed the serving feature's tensors")
    moved = any(not torch.equal(v, before[k]) for k, v in new.net.state_dict().items())
    out = {"steps": FINETUNE_STEPS, "seconds": seconds, "ms_per_step": seconds * 1e3 /
           FINETUNE_STEPS, "serving_unchanged": unchanged, "copy_moved": moved}
    log(f"(c) finetune_embedder: {out}")
    return out


def _timed_train(dev, fn) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def detector_recipes(dev) -> dict:
    """Phase 18 (d): the small detector and gate recipes with the
    reference's bands, and the serving detector's recipe against the JAX
    package's recall. ``evaluate_detector`` runs ``detect_batch`` (kernel
    C); its launches are counted from zero."""
    zero_counters()
    scenes, boxes, counts = dataset_utils.make_synthetic_scenes(48, (96, 96), max_faces=2, seed=3)
    det = detector_mod.CNNFaceDetector(**DET_SMALL, device=dev)
    small = {"train_s": _timed_train(dev, lambda: det.train(scenes, boxes, counts,
                                                              **DET_SMALL_TRAIN))}
    held = dataset_utils.make_synthetic_scenes(32, (96, 96), max_faces=2, seed=99)
    small.update(detector_mod.evaluate_detector(det, *held, iou_threshold=0.5))
    small["ms_per_step"] = small["train_s"] * 1e3 / DET_SMALL_TRAIN["steps"]
    for key, bar in DET_BANDS.items():
        if not small[key] >= bar:
            raise AssertionError(f"small detector recipe: {key} {small[key]} (bar {bar}): {small}")
    g_scenes, g_boxes, g_counts = dataset_utils.make_synthetic_scenes(96, (96, 96), max_faces=2,
                                                                      seed=3)
    gate = cascade_mod.FaceGate(device=dev)
    gate_s = _timed_train(dev, lambda: gate.train(g_scenes, g_boxes, g_counts, **GATE_TRAIN))
    g_held = dataset_utils.make_synthetic_scenes(48, (96, 96), max_faces=2, seed=99)
    scores = gate.score_batch(g_held[0]).cpu().numpy()
    has = g_held[2] > 0
    gate_out = {"train_s": gate_s, "ms_per_step": gate_s * 1e3 / GATE_TRAIN["steps"],
                "face_kept": float((scores[has] >= gate.threshold).mean()),
                "facefree_rejected": float((scores[~has] < gate.threshold).mean()),
                "evaluate_gate": cascade_mod.evaluate_gate(gate, det, g_held[0],
                                                           gt_counts=g_held[2])}
    serving = detector_mod.CNNFaceDetector(max_faces=8, score_threshold=0.3, device=dev)
    train = dataset_utils.make_synthetic_scenes(**DET_SERVING_TRAIN)
    s_out = {"train_s": _timed_train(dev, lambda: serving.train(
        *train, steps=DET_SERVING_STEPS, batch_size=16))}
    s_out["ms_per_step"] = s_out["train_s"] * 1e3 / DET_SERVING_STEPS
    s_out.update(detector_mod.evaluate_detector(
        serving, *dataset_utils.make_synthetic_scenes(**DET_SERVING_HELD), iou_threshold=0.5))
    s_out["jax_cpu_recall"] = DET_SERVING_JAX_RECALL
    if abs(s_out["recall"] - DET_SERVING_JAX_RECALL) > DET_SERVING_RECALL_TOL:
        raise AssertionError(f"serving detector recipe: recall {s_out['recall']} against the JAX "
                             f"package's {DET_SERVING_JAX_RECALL} (tolerance "
                             f"{DET_SERVING_RECALL_TOL}): {s_out}")
    out = {"small": small, "gate": gate_out, "serving": s_out, "launches": read_launches()}
    log(f"(d) detector and gate recipes: {out}")
    if dev.type == "cuda" and out["launches"]["nms"] < 1:
        raise AssertionError("(d) evaluate_detector did not launch kernel C")
    return out


def train_cli_cnn(dev, root: str) -> dict:
    """Phase 18 (e): ``ocvf-train-torch --model cnn`` at its defaults on
    phase 17's Extended Yale-B-sized set, and ``--model auto --classifier
    kernel_svm`` on an AUTO_SUBJECTS x AUTO_PER_SUBJECT set; each
    checkpoint held on the card against the CPU."""
    out = {}
    X, y, names = dataset_utils.make_synthetic_faces(
        num_subjects=YALEB_SUBJECTS, per_subject=YALEB_PER_SUBJECT, size=ACC_SIZE,
        **YALEB_FACES)
    write_dataset(os.path.join(root, "yaleb"), X, y, names)
    X, y, names = dataset_utils.make_synthetic_faces(
        num_subjects=AUTO_SUBJECTS, per_subject=AUTO_PER_SUBJECT, size=ACC_SIZE, **YALEB_FACES)
    write_dataset(os.path.join(root, "auto"), X, y, names)
    for name, data, flags in TRAINING_CLI_RUNS:
        data = os.path.join(root, data)
        ckpt = os.path.join(root, f"{name}.ckpt")
        run = train_cli(dev, data, ckpt, flags)
        Xq = dataset_utils.read_images(data, image_size=ACC_SIZE)[0]
        queries = Xq[::max(1, len(Xq) // TRAIN_CHECK_QUERIES)][:TRAIN_CHECK_QUERIES]
        run["checkpoint"] = checkpoint_labels_agree(dev, ckpt, queries)
        log(f"(e) ocvf-train-torch {' '.join(flags)}: {run}")
        out[name] = run
    return out


def gate_check(dev) -> dict:
    """Phase 18 (f): ``apps.gate_embedder.main`` on GATE_ARGV at GATE_STEPS
    steps on ``dev``; the row's fields, tag and config."""
    argv = [*GATE_ARGV, "--steps", str(GATE_STEPS), "--device", str(dev)]
    t0 = time.perf_counter()
    row = gate_embedder.main(argv)
    wall_s = time.perf_counter() - t0
    cfg = row["config"]
    if (tuple(row) != GATE_FIELDS or row["tag"] != GATE_TAG or cfg["steps"] != GATE_STEPS
            or (cfg["block"], cfg["space_to_depth"], cfg["norm"]) != ("dense", 2, "light")):
        raise AssertionError(f"(f) gate_embedder's row: {row}")
    if not (GATE_MIN_ACC <= row["accuracy"] <= 1.0
            and row["mean_minus_2std"] <= row["accuracy"]
            and row["fold_min"] <= row["accuracy"]):
        raise AssertionError(f"(f) gate_embedder's figures: {row} (accuracy bar {GATE_MIN_ACC})")
    out = {**row, "wall_s": wall_s}
    log(f"(f) gate_embedder {' '.join(argv)}: {out}")
    return out


def training_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 18 (module docstring); returns the ``{"training": ...}``
    numbers, (c)'s and (d)'s kernel launches among them."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_smoke")
    os.makedirs(root, exist_ok=True)
    out = {"card": card}
    t0 = time.perf_counter()
    out["steps_vs_cpu"] = train_steps_vs_cpu(dev, seed)
    out["steps_vs_cpu_s"] = time.perf_counter() - t0
    out["arcface"], emb, data = arcface_run(dev, ARC_STEPS)
    out["served"] = trained_embedder_served(dev, ctx, emb, data)
    del emb, data
    t0 = time.perf_counter()
    out["recipes"] = detector_recipes(dev)
    out["recipes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train_cli"] = train_cli_cnn(dev, root)
    out["train_cli_s"] = time.perf_counter() - t0
    out["gate"] = gate_check(dev)
    out["launches"] = {k: out["served"]["launches"][k] + out["recipes"]["launches"][k]
                       for k in out["served"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------- phase 19: training over a mesh (ROADMAP A.18) ----------

#: phase 19 and 15 (e): the HARD recipe's embedder
#: (``apps.measure_accuracy.hard_embedder``: embed 256, stem 32, stages
#: 64 / 128 / 256 of two blocks, 64x64 faces, batch 192, lr 2e-3,
#: augmented), its head over the protocol's 300 training identities;
#: standard normal faces and random labels from ``--seed`` (no accuracy is
#: read here)
SH_NET = dict(embed_dim=256, stem_features=32, stage_features=(64, 128, 256),
              stage_blocks=(2, 2, 2))
SH_FACE = (64, 64)
SH_BATCH = 192
SH_CLASSES = 300
SH_LR = 2e-3
#: (a): the meshes of slots of the card held to the one-slot step over
#: SH_STEPS f32 steps, then timed in bf16 by CUDA events over steps
#: SH_TIME_FROM to SH_STEPS
SH_LAYOUTS = ((1, 2), (2, 1), (2, 2))
SH_STEPS = 10
SH_TIME_FROM = 3
#: (a)'s bars in f32 on one card (sums in another order): the first
#: step's loss and each gradient tensor (relative to its largest |g|), as
#: tests/test_torch_gpu.py holds them, and every step's loss (Adam carries
#: the first step's roundoff forward); read on the H100 at 0-8.3e-8,
#: 2.35e-6-3.16e-6 and 4.8e-6-2.1e-5
SH_LOSS_RTOL = 1e-5
SH_GRAD_RTOL = 1e-4
SH_LOSSES_RTOL = 1e-4
#: (a)'s traces: steps a configuration under torch.profiler
SH_TRACE_STEPS = 2
#: phase 15 (e): the sharded step's layouts across the two processes
MP_TRAIN_LAYOUTS = ((1, 2), (2, 1))
MP_TRAIN_STEPS = 3


def sharded_step(seed: int, layout, devices, dtype) -> ShardedArcFaceStep:
    """The HARD recipe's ArcFace step over ``make_mesh(*layout, devices)``
    in ``dtype``, weights and head from ``seed``."""
    mesh = make_mesh(*layout, devices=devices)
    net = embedder_mod.FaceEmbedNet(**SH_NET, dtype=dtype, input_size=SH_FACE,
                                    generator=torch.Generator().manual_seed(seed))
    head = embedder_mod.draw_head(SH_CLASSES, SH_NET["embed_dim"], seed + 1)
    return ShardedArcFaceStep(mesh, net.to(mesh.home.device), head, learning_rate=SH_LR,
                              augment=True)


def sharded_batches(dev, seed: int, n: int) -> list:
    """``n`` batches (faces, labels, augmentation draws for the whole
    batch) on ``dev``, drawn from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    return [(torch.randn(SH_BATCH, *SH_FACE, generator=gen, device=dev),
             torch.randint(0, SH_CLASSES, (SH_BATCH,), generator=gen, device=dev),
             embedder_mod.augment_draws(gen, SH_BATCH, *SH_FACE)) for _ in range(n)]


def _step_grads(step) -> dict:
    """The first local replica's gradients by name and the head's
    (its row 0 shards, in order), on the host."""
    tp = step.mesh.shape["tp"]
    first = step.mesh.local_slots[0].id
    out = {n: p.grad.detach().float().cpu() for n, p in step.nets[first].named_parameters()}
    out["head"] = torch.cat([step.shards[c].grad for c in range(tp)]).float().cpu()
    return out


def _copies_equal(step) -> bool:
    """Every replica equal to the first, every head shard to its row 0
    copy, bit for bit."""
    tp = step.mesh.shape["tp"]
    local = step.mesh.local_slots
    first = list(step.nets[local[0].id].parameters())
    return (all(torch.equal(p, q) for s in local
                for p, q in zip(step.nets[s.id].parameters(), first))
            and all(torch.equal(step.shards[s.id], step.shards[s.id % tp]) for s in local))


def sharded_vs_one_slot(dev, seed: int) -> dict:
    """Phase 19 (a), equality: SH_STEPS f32 steps of the one-slot step and
    of each layout of SH_LAYOUTS over slots of ``dev`` on the same batches
    and draws: the first step's loss and every gradient, every step's
    loss, and the copies bit-equal after every step."""
    batches = sharded_batches(dev, seed, SH_STEPS)
    one = sharded_step(seed, (1, 1), [dev], torch.float32)
    ref_losses, ref_grads = [], None
    for x, y, d in batches:
        ref_losses.append(float(one.step(x, y, d)))
        ref_grads = ref_grads or _step_grads(one)
    del one
    out = {"one_slot_losses": ref_losses}
    for layout in SH_LAYOUTS:
        step = sharded_step(seed, layout, [dev] * (layout[0] * layout[1]), torch.float32)
        losses, grads, equal = [], None, True
        for x, y, d in batches:
            losses.append(float(step.step(x, y, d)))
            grads = grads or _step_grads(step)
            equal = equal and _copies_equal(step)
        worst = max((float((grads[n] - g).abs().max() / max(float(g.abs().max()), 1e-30)), n)
                    for n, g in ref_grads.items())
        rec = dict(loss=losses[0], loss_rel_err=abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
                   max_grad_rel_err=worst[0], worst_tensor=worst[1],
                   losses_max_rel_err=max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
                   copies_bit_equal_every_step=equal, losses=losses)
        out[f"{layout[0]}x{layout[1]}"] = rec
        log(f"sharded_training (a) {layout} on slots of the card, f32, against the one-slot "
            f"step: {rec}")
        if not (equal and rec["loss_rel_err"] <= SH_LOSS_RTOL and worst[0] <= SH_GRAD_RTOL
                and rec["losses_max_rel_err"] <= SH_LOSSES_RTOL):
            raise AssertionError(f"sharded_training (a) {layout}: {rec} (bars: loss "
                                 f"{SH_LOSS_RTOL}, gradients {SH_GRAD_RTOL}, losses "
                                 f"{SH_LOSSES_RTOL}, copies bit for bit)")
        del step
    return out


@contextlib.contextmanager
def _cudnn_deterministic(on: bool):
    """cuDNN's deterministic algorithms (``on``) or its default choice
    within the block; the sharded step sets them itself on a mesh of more
    than one slot."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _sharded_ms(step, batches, deterministic: bool) -> float:
    """Ms a step by CUDA events over steps SH_TIME_FROM to the last."""
    first, last = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with _cudnn_deterministic(deterministic):
        for i, (x, y, d) in enumerate(batches, 1):
            if i == SH_TIME_FROM:
                first.record()
            step.step(x, y, d)
        last.record()
        torch.cuda.synchronize()
    return first.elapsed_time(last) / (len(batches) - SH_TIME_FROM + 1)


def _sharded_trace(step, batches, deterministic: bool) -> dict:
    """SH_TRACE_STEPS warm steps under ``torch.profiler``, per step: the
    host's ms (to the card's end), the card's busy ms (the union of its
    kernels' and copies' intervals over every stream), the sum of their
    durations (the card's work, overlap counted twice), the device
    operations and the host's kernel launch calls; the busy share. None
    where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with _cudnn_deterministic(deterministic):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for x, y, d in batches[:SH_TRACE_STEPS]:
                step.step(x, y, d)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    launches = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                  "cuLaunchKernelEx"))
    n = SH_TRACE_STEPS
    return dict(host_ms=wall_ms / n, busy_ms=busy / 1e3 / n,
                work_ms=sum(b - a for a, b in spans) / 1e3 / n,
                busy_share=busy / 1e3 / wall_ms, device_ops=len(spans) / n,
                launch_calls=launches / n)


def sharded_step_times(dev, seed: int) -> dict:
    """Phase 19 (a), time: ms a step in bf16 of the one-slot step under
    cuDNN's default choice (``1x1``) and under its deterministic
    algorithms (``1x1_det``, as every layout runs), and of each layout,
    twice each in turns (one-slot first, then the reverse order); then one
    ``torch.profiler`` trace of each (``_sharded_trace``), which splits a
    layout's gap to the one-slot step into the deterministic algorithms'
    share, the card's extra work (each tp slot embeds its row's batch) and
    the card's idle time. None off the card."""
    if dev.type != "cuda":
        return None
    batches = sharded_batches(dev, seed, SH_STEPS)
    one = sharded_step(seed, (1, 1), [dev], torch.bfloat16)
    steps = {"1x1": (one, False), "1x1_det": (one, True)}
    for dp, tp in SH_LAYOUTS:
        steps[f"{dp}x{tp}"] = (sharded_step(seed, (dp, tp), [dev] * (dp * tp), torch.bfloat16),
                               True)
    ms = {k: [] for k in steps}
    for k in [*steps, *reversed(steps)]:
        ms[k].append(_sharded_ms(steps[k][0], batches, steps[k][1]))
    log(f"sharded_training (a) bf16 ms a step (CUDA events over steps {SH_TIME_FROM}-"
        f"{SH_STEPS}, two rounds in turns): {ms}")
    try:
        traces = {k: _sharded_trace(step, batches, det) for k, (step, det) in steps.items()}
    except Exception as e:  # the profiler is an observer: a failed trace is reported as such
        traces = {"error": repr(e)}
    log(f"sharded_training (a) bf16 traces, a step ({SH_TRACE_STEPS} steps under "
        f"torch.profiler): {traces}")
    return {"ms": ms, "traces": traces}


def dryrun_check(dev) -> dict:
    """Phase 19 (b): ``dryrun_multichip(4)`` on four slots of ``dev``: its
    four lines as the reference prints them; its kernel launches (C in the
    recognition batches; A and B none: a 32-row gallery, the unfused
    embedder)."""
    zero_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(4, devices=[dev] * 4)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"sharded_training (b) {line}")
    ok = (len(lines) == 4 and lines[0] == "[dryrun] mesh: dp=2 tp=2 on 4 devices"
          and lines[1].startswith("[dryrun] sharded ArcFace train step OK, loss=")
          and np.isfinite(float(lines[1].split("loss=")[1]))
          and lines[2] == "[dryrun] fused recognition batch OK: boxes (8, 4, 4), labels (8, 4, 1)"
          and lines[3] == ("[dryrun] pipeline-parallel batch OK: stage meshes {'dp': 1, 'tp': 2} "
                           "| {'dp': 1, 'tp': 2}, labels (8, 4, 1)"))
    if not ok:
        raise AssertionError(f"sharded_training (b) dryrun_multichip's lines: {lines}")
    if dev.type == "cuda" and (launches["nms"] < 1 or launches["streaming_match"]
                               or launches["sepblock"]):
        raise AssertionError(f"sharded_training (b) dryrun_multichip's launches: {launches}")
    return {"lines": lines, "launches": launches, "seconds": seconds}


def sharded_training_phase(dev, seed: int, card: str) -> dict:
    """Phase 19 (module docstring); returns the ``{"sharded_training": ...}``
    numbers, (b)'s kernel launches among them."""
    t_phase = time.perf_counter()
    out = {"card": card}
    t = time.perf_counter()
    out["vs_one_slot"] = sharded_vs_one_slot(dev, seed)
    out["vs_one_slot_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["bf16_ms_per_step"] = sharded_step_times(dev, seed)
    out["times_s"] = time.perf_counter() - t
    out["dryrun"] = dryrun_check(dev)
    out["launches"] = out["dryrun"]["launches"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=4 * BATCH)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    t_run = t0 = time.perf_counter()
    _build.build_all()
    log(f"built {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name in _build.KERNELS:
        log_ptxas(name)
    gen = torch.Generator().manual_seed(args.seed)
    #: each phase's seconds (host clock, from the previous phase's end)
    phase_s = {"build": time.perf_counter() - t0}
    marks = [time.perf_counter()]

    def done(name):
        marks.append(time.perf_counter())
        phase_s[name] = marks[-1] - marks[-2]

    entries = [check_match(dev, gen), check_sepblock(dev, gen), check_nms(dev, gen)]
    done("1-3 kernels")
    launches, ctx = serve(dev, args.seed, args.frames)
    done("4-5 serve")
    grow = async_grow_phase(dev, args.seed, card, ctx)
    done("9 async_grow")
    ivf = ivf_phase(dev, args.seed, ctx)
    done("6 ivf")
    cli = cli_phase(dev, args.seed, card, ctx)
    done("7 cli")
    durability = durability_phase(dev, args.seed, card, ctx)
    done("8 durability")
    overload = overload_phase(dev, args.seed, card, ctx)
    done("10 overload")
    ingest = ingest_phase(dev, args.seed, card, ctx)
    done("11 ingest")
    rollout = rollout_phase(dev, args.seed, card, ctx)
    done("12 rollout")
    cascade = cascade_phase(dev, args.seed, card, ctx)
    done("13 cascade")
    replication = replication_phase(dev, args.seed, card, ctx)
    done("14 replication")
    replication_end_s = time.perf_counter() - t_run
    multi_gpu = multi_gpu_phase(dev, args.seed, card, ctx)
    done("15 multi_gpu")
    multi_gpu_end_s = time.perf_counter() - t_run
    chaos = chaos_phase(dev, args.seed, card, ctx)
    done("16 chaos")
    chaos_end_s = time.perf_counter() - t_run
    train = train_phase(dev, args.seed, card, ctx)
    done("17 train")
    train_end_s = time.perf_counter() - t_run
    training = training_phase(dev, args.seed, card, ctx)
    done("18 training")
    training_end_s = time.perf_counter() - t_run
    sharded = sharded_training_phase(dev, args.seed, card)
    sharded["across_processes"] = multi_gpu["cross_process"]["train"]
    done("19 sharded_training")
    for e in entries:
        # the main path's launches: the serving run's, the replicas', the
        # two-stage pipeline's and the fused mesh step's services', the chaos soak's, the s = 2 embedder's,
        # the trained nets' (phase 18 (c), (d)) and the dryrun's (phase 19 (b))
        e["launches"] = (launches[e["name"]] + replication["inproc"]["launches"][e["name"]]
                         + multi_gpu["mesh_launches"][e["name"]] + chaos["launches"][e["name"]]
                         + train["launches"][e["name"]] + training["launches"][e["name"]]
                         + sharded["launches"][e["name"]])
    print(json.dumps({"step": {"card": card, **ctx["step"]}}))
    print(json.dumps({"async_grow": grow}))
    print(json.dumps({"ivf": ivf}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"durability": durability}))
    print(json.dumps({"overload": overload}))
    print(json.dumps({"ingest": ingest}))
    print(json.dumps({"rollout": rollout}))
    print(json.dumps({"cascade": cascade}))
    replication["total_s"] = replication_end_s
    print(json.dumps({"replication": replication}))
    multi_gpu["total_s"] = multi_gpu_end_s
    print(json.dumps({"multi_gpu": multi_gpu}))
    chaos["total_s"] = chaos_end_s
    print(json.dumps({"chaos": chaos}))
    train["total_s"] = train_end_s
    print(json.dumps({"train": train}))
    training["total_s"] = training_end_s
    print(json.dumps({"training": training}))
    sharded["total_s"] = time.perf_counter() - t_run
    log(f"chip_smoke: total {sharded['total_s']:.1f} s")
    print(json.dumps({"sharded_training": sharded}))
    print(json.dumps({"phase_s": {"card": card, **phase_s, "total": sharded["total_s"]}}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
