"""The one registry of metric names on the shared ``Metrics`` surface:
port of ``opencv_facerecognizer_tpu/utils/metric_names.py``.

The chaos soak, the admission ledger and the tests compare counters by
name across many files; every ``incr`` / ``observe`` / ``set_gauge`` of
the port uses a constant from here (``utils.metrics`` re-exports them,
so ``metrics as mn`` reads the same names). Constants ending in
``_PREFIX`` name families with a dynamic suffix
(``frames_rejected_<reason>``). The names are the reference's, less
``cpu_fallbacks`` (the CPU fallback is not ported, ROADMAP C.7) and plus
``replication_install_errors`` (the port's, ROADMAP C.15).
"""

# counters: the admission ledger
FRAMES_ADMITTED = "frames_admitted"
FRAMES_MALFORMED = "frames_malformed"
FRAMES_PROCESSED = "frames_processed"
FRAMES_COMPLETED = "frames_completed"
#: a frame the cascade's stage 1 scored face-free: published with no faces,
#: never dispatched to the full step (a completion, not a drop)
FRAMES_COMPLETED_EMPTY = "frames_completed_empty"
FRAMES_COMPLETED_CACHED = "frames_completed_cached"
FRAMES_DROPPED = "frames_dropped"
FRAMES_DROPPED_CRASHED = "frames_dropped_crashed"
FRAMES_DROPPED_BROWNOUT = "frames_dropped_brownout"
#: an admitted compressed frame that never became pixels (a corrupt
#: payload, or the decode queue full); journaled ``decode_error`` /
#: ``decode_backlog``
FRAMES_DROPPED_DECODE = "frames_dropped_decode"
FRAMES_FAILED = "frames_failed"
FRAMES_DEAD_LETTERED = "frames_dead_lettered"
FACES_FOUND = "faces_found"
SUBJECTS_ENROLLED = "subjects_enrolled"
GALLERY_GROWN = "gallery_grown"
# admission and brownout (runtime.admission, the service's controller);
# BROWNOUT_LEVEL is a gauge; rejections and dedups sit outside the ledger
FRAMES_REJECTED_PREFIX = "frames_rejected_"
FRAMES_DEDUPED = "frames_deduped"
BROWNOUT_LEVEL = "brownout_level"
BROWNOUT_TRANSITIONS = "brownout_transitions"
BROWNOUT_RECOVERIES = "brownout_recoveries"
# the ingest staging ring and upload (runtime.ingest): allocations are the
# preallocation plus outage heals, and steady serving never moves them;
# INGEST_STAGING_FREE is a gauge, INGEST_UPLOAD a window (host enqueue s)
INGEST_STAGING_ALLOCS = "ingest_staging_allocs"
INGEST_STAGING_REUSE = "ingest_staging_reuse"
INGEST_STAGING_EXHAUSTED = "ingest_staging_exhausted"
INGEST_STAGING_FORFEITS = "ingest_staging_forfeits"
INGEST_STAGING_FREE = "ingest_staging_free"
INGEST_UPLOAD = "ingest_upload"
INGEST_UPLOAD_BYTES = "ingest_upload_bytes"
# the JPEG decode pool (runtime.ingest); DECODE_QUEUE_DEPTH is a gauge,
# DECODE_LATENCY a window
DECODE_LATENCY = "decode_latency"
DECODE_QUEUE_DEPTH = "decode_queue_depth"
DECODE_FRAMES = "decode_frames"
DECODE_ERRORS = "decode_errors"
# the cascade's stage-1 gate (models.cascade, runtime.recognizer): frames
# scored, whole batches that exited at stage 1, failed stage-1 passes (the
# batch fails open to the full step); CASCADE_SCORE is a window (host s of
# one pass with its readback); the rates and the effective threshold are
# gauges
CASCADE_FRAMES_SCORED = "cascade_frames_scored"
CASCADE_BATCH_EXITS = "cascade_batch_exits"
CASCADE_ERRORS = "cascade_errors"
CASCADE_SCORE = "cascade_score"
CASCADE_REJECT_RATE = "cascade_reject_rate"
CASCADE_PASS_RATE = "cascade_pass_rate"
CASCADE_THRESHOLD = "cascade_threshold"
# counters: dispatch and readback
BATCHES_DISPATCHED = "batches_dispatched"
BATCHES_BUCKETED = "batches_bucketed"
BATCHES_FAILED = "batches_failed"
BATCHES_DEAD_LETTERED = "batches_dead_lettered"
LOOP_CRASHES = "loop_crashes"
DISPATCH_FAILURES = "dispatch_failures"
DISPATCH_RETRIES = "dispatch_retries"
READBACK_ERRORS = "readback_errors"
DEGRADED_TRANSITIONS = "degraded_transitions"
DEGRADED_RECOVERIES = "degraded_recoveries"
# counters and gauges: the identity tracker (runtime.tracker)
TRACK_LOOKUPS = "track_lookups"
TRACK_CACHE_HITS = "track_cache_hits"
TRACK_CACHE_HIT_RATE = "track_cache_hit_rate"
TRACKS_LIVE = "tracks_live"
TRACKS_CREATED = "tracks_created"
TRACKS_CONFIRMED = "tracks_confirmed"
TRACK_REVERIFIES = "track_reverifies"
TRACK_FLUSHES_PREFIX = "track_flushes_"
TRACK_BATCH_EXITS = "track_batch_exits"
TRACK_ERRORS = "track_errors"
# counters: the wire transports (runtime.connector)
CONNECTOR_MALFORMED_LINES = "connector_malformed_lines"
CONNECTOR_PEER_DISCONNECTS = "connector_peer_disconnects"
CONNECTOR_RECONNECTS = "connector_reconnects"
CONNECTOR_RECONNECT_FAILURES = "connector_reconnect_failures"
CONNECTOR_STALLED_CLIENTS_DROPPED = "connector_stalled_clients_dropped"
# counters and gauges: the frame batcher
BATCHER_FRAMES_OFFERED = "batcher_frames_offered"
BATCHER_FRAMES_BATCHED = "batcher_frames_batched"
#: per-reason drop family: ``batcher_dropped_<reason>``
BATCHER_DROPPED_PREFIX = "batcher_dropped_"
BATCHER_DROPPED_MALFORMED = "batcher_dropped_malformed"
BATCHER_DROPPED_CLOSED = "batcher_dropped_closed"
BATCHER_DROPPED_OVERFLOW = "batcher_dropped_overflow"
BATCHER_DROPPED_STALE = "batcher_dropped_stale"
BATCHER_BATCHES_SIZE = "batcher_batches_size"
BATCHER_BATCHES_DEADLINE = "batcher_batches_deadline"
BATCHER_BUFFER_REUSE = "batcher_buffer_reuse"
BATCHER_FLUSH_DEADLINE_MS = "batcher_flush_deadline_ms"
#: a serving step whose cache entry was missing after warmup (a CUDA graph
#: captured, or re-captured, on the serving thread)
RECOMPILES_POST_WARMUP = "recompiles_post_warmup"
# latency windows (seconds)
WARMUP = "warmup"
QUEUE_WAIT = "queue_wait"
DISPATCH = "dispatch"
READY_WAIT = "ready_wait"
PUBLISH = "publish"
BATCH_LATENCY = "batch_latency"
E2E_LATENCY = "e2e_latency"
#: the same observation, interactive-priority frames only
E2E_LATENCY_INTERACTIVE = "e2e_latency_interactive"
# IVF coarse quantizer (parallel.quantizer); IVF_SPILL_ROWS is a gauge; the
# state store writes and loads the sidecars.
IVF_BUILDS = "ivf_builds"
IVF_BUILD_FAILURES = "ivf_build_failures"
IVF_RETRAINS_SKIPPED_INFLIGHT = "ivf_retrains_skipped_inflight"
IVF_INVALIDATIONS = "ivf_invalidations"
IVF_INCREMENTAL_ROWS = "ivf_incremental_rows"
IVF_SPILL_ROWS = "ivf_spill_rows"
IVF_SIDECAR_WRITES = "ivf_sidecar_writes"
IVF_SIDECAR_LOADS = "ivf_sidecar_loads"
IVF_SIDECAR_STALE = "ivf_sidecar_stale"
IVF_SIDECAR_ERRORS = "ivf_sidecar_errors"
# durable state (runtime.state_store, runtime.journal); WAL_ROWS is a gauge
JOURNAL_ERRORS = "journal_errors"
JOURNAL_RECORDS = "journal_records"
JOURNAL_FRAMES = "journal_frames"
JOURNAL_TORN_TAILS = "journal_torn_tails"
JOURNAL_SHED = "journal_shed"
CHECKPOINTS_WRITTEN = "checkpoints_written"
CHECKPOINTS_CORRUPT = "checkpoints_corrupt"
CHECKPOINTS_VERSION_SKIPPED = "checkpoints_version_skipped"
CHECKPOINT_READ_ERRORS = "checkpoint_read_errors"
CHECKPOINT_FAILURES = "checkpoint_failures"
CHECKPOINTS_SKIPPED_INFLIGHT = "checkpoints_skipped_inflight"
CHECKPOINTS_DEFERRED_PENDING = "checkpoints_deferred_pending"
CHECKPOINT_GC_ERRORS = "checkpoint_gc_errors"
WAL_APPENDS = "wal_appends"
WAL_ROWS_APPENDED = "wal_rows_appended"
WAL_ABORTS = "wal_aborts"
WAL_CORRUPT_RECORDS = "wal_corrupt_records"
WAL_SKIPPED_RECORDS = "wal_skipped_records"
WAL_REPLAYED_RECORDS = "wal_replayed_records"
WAL_REPLAYED_ROWS = "wal_replayed_rows"
WAL_TAIL_REPLAYED_ROWS = "wal_tail_replayed_rows"
WAL_TORN_TAILS_SEALED = "wal_torn_tails_sealed"
WAL_OVER_BYTES = "wal_over_bytes"
WAL_ROWS = "wal_rows"
WAL_APPEND_ERRORS = "wal_append_errors"
WAL_REGISTRY_ABORTS = "wal_registry_aborts"
STATE_RECOVERIES = "state_recoveries"
WAL_CUTOVER_RECORDS = "wal_cutover_records"
# the embedder rollout (runtime.rollout); ROLLOUT_PHASE (0 idle, 1 staging,
# 2 parity, 3 ready, 4 cutover, 5 done), the staged and total rows, the
# parity window and the embedder version are gauges
ROLLOUT_PHASE = "rollout_phase"
ROLLOUT_STAGED_ROWS = "rollout_staged_rows"
ROLLOUT_TOTAL_ROWS = "rollout_total_rows"
ROLLOUT_PARITY_AGREEMENT = "rollout_parity_agreement"
ROLLOUT_PARITY_SAMPLES = "rollout_parity_samples"
ROLLOUT_STAGE_CHUNKS = "rollout_stage_chunks"
ROLLOUT_STAGE_RESUMES = "rollout_stage_resumes"
ROLLOUT_STAGE_ERRORS = "rollout_stage_errors"
ROLLOUT_CUTOVERS = "rollout_cutovers"
ROLLOUT_CUTOVERS_COMPLETED_RECOVERY = "rollout_cutovers_completed_recovery"
ROLLOUT_CUTOVER_BLOCKED = "rollout_cutover_blocked"
ROLLOUT_ROLLBACKS = "rollout_rollbacks"
ROLLOUT_EMBEDDER_VERSION = "rollout_embedder_version"
ROLLOUT_VERSION_MISMATCHES = "rollout_version_mismatches"
ROLLOUT_VERSION_SKIPPED_ROWS = "rollout_version_skipped_rows"
ROLLOUT_REPLICA_AWAITING = "rollout_replica_awaiting"
ROLLOUT_REPLICA_REANCHORS = "rollout_replica_reanchors"
ROLLOUT_OBSERVE_ERRORS = "rollout_observe_errors"
# the model registry (runtime.registry): a version gauge per role; the
# swap's phase (runtime.registry.PHASE_CODES) and its detection-parity
# window are gauges; swaps done, refused by the parity gate, completed or
# abandoned by recovery, rolled back, the gate retrains riding a detector
# swap, the cache flushes at a cutover, failed live offers; the WAL's
# registry fences and their abandon tombstones
MODEL_VERSION_PREFIX = "model_version_"
REGISTRY_PHASE = "registry_phase"
REGISTRY_PARITY_AGREEMENT = "registry_parity_agreement"
REGISTRY_PARITY_SAMPLES = "registry_parity_samples"
REGISTRY_SWAPS = "registry_swaps"
REGISTRY_SWAPS_BLOCKED = "registry_swaps_blocked"
REGISTRY_SWAPS_COMPLETED_RECOVERY = "registry_swaps_completed_recovery"
REGISTRY_SWAPS_ABANDONED_RECOVERY = "registry_swaps_abandoned_recovery"
REGISTRY_AUTO_ROLLBACKS = "registry_auto_rollbacks"
REGISTRY_GATE_RETRAINS = "registry_gate_retrains"
REGISTRY_CACHE_FLUSHES = "registry_cache_flushes"
REGISTRY_OBSERVE_ERRORS = "registry_observe_errors"
WAL_REGISTRY_RECORDS = "wal_registry_records"
# replication (runtime.replication): the writer lease, the read replica's
# polls, applies, reopens, resyncs and refusals; REPLICATION_LAG_ROWS (WAL
# rows seen, not applied) and REPLICATION_LAG_S (the oldest applied row's
# age when it became visible) are gauges
REPLICATION_LEASE_ACQUIRED = "replication_lease_acquired"
REPLICATION_LEASE_CONFLICTS = "replication_lease_conflicts"
REPLICATION_POLLS = "replication_polls"
REPLICATION_POLL_ERRORS = "replication_poll_errors"
REPLICATION_RECORDS_APPLIED = "replication_records_applied"
REPLICATION_ROWS_APPLIED = "replication_rows_applied"
REPLICATION_CORRUPT_RECORDS = "replication_corrupt_records"
REPLICATION_WAL_REOPENS = "replication_wal_reopens"
REPLICATION_RESYNCS = "replication_resyncs"
REPLICATION_ABORTS_AFTER_APPLY = "replication_aborts_after_apply"
REPLICATION_ENROLL_REJECTED = "replication_enroll_rejected"
REPLICATION_LAG_ROWS = "replication_lag_rows"
REPLICATION_LAG_S = "replication_lag_s"
# port only (ROADMAP C.15): a reader's failed install of the weights its
# manifest names, retried alone after a backoff
REPLICATION_INSTALL_ERRORS = "replication_install_errors"
# the topic router (runtime.replication.TopicRouter): routed frames,
# ``router_rejected_<reason>``, budget spills, failovers and recoveries,
# planned drains, probe failures, hedges and their outcomes, results
# deduped at fan-in; ROUTER_REPLICAS and ROUTER_HEALTHY_REPLICAS are gauges
ROUTER_ROUTED = "router_routed"
ROUTER_BUDGET_SPILLS = "router_budget_spills"
ROUTER_FAILOVERS = "router_failovers"
ROUTER_RECOVERIES = "router_recoveries"
ROUTER_CUTOVER_DRAINS = "router_cutover_drains"
ROUTER_HEALTH_PROBE_FAILURES = "router_health_probe_failures"
ROUTER_PROBE_ERRORS = "router_probe_errors"
ROUTER_REPLICAS = "router_replicas"
ROUTER_HEALTHY_REPLICAS = "router_healthy_replicas"
ROUTER_HEDGES = "router_hedges"
ROUTER_HEDGE_WINS = "router_hedge_wins"
ROUTER_HEDGE_WASTED = "router_hedge_wasted"
ROUTER_RESULTS_DEDUPED = "router_results_deduped"
# link supervision (the router's ping/pong): heartbeats each way, link
# transitions; LINKS_DOWN and ``link_state_<replica>`` (1 up, 0 down) are
# gauges
LINK_HEARTBEATS_SENT = "link_heartbeats_sent"
LINK_HEARTBEATS_RECEIVED = "link_heartbeats_received"
LINK_STATE_PREFIX = "link_state_"
LINK_FAILURES = "link_failures"
LINK_RECOVERIES = "link_recoveries"
LINKS_DOWN = "links_down"
# the durability monitor (runtime.resilience); DURABILITY_STATE,
# DISK_FREE_BYTES and DISK_PRESSURE_STATE are gauges
DURABILITY_STATE = "durability_state"
DURABILITY_DEGRADED_TRANSITIONS = "durability_degraded_transitions"
DURABILITY_REARMS = "durability_rearms"
DURABILITY_PROBES = "durability_probes"
DURABILITY_PROBE_FAILURES = "durability_probe_failures"
DURABILITY_LEASE_CHECK_FAILURES = "durability_lease_check_failures"
ENROLLMENTS_REFUSED_DEGRADED = "enrollments_refused_degraded"
DISK_FREE_BYTES = "disk_free_bytes"
DISK_PRESSURE_STATE = "disk_pressure_state"
DISK_PRESSURE_COMPACTIONS = "disk_pressure_compactions"
DISK_PRESSURE_RETENTION_SHRINKS = "disk_pressure_retention_shrinks"
# the supervisor (runtime.resilience)
SUPERVISOR_CHECKPOINTS = "supervisor_checkpoints"
SUPERVISOR_RESTARTS = "supervisor_restarts"
SUPERVISOR_STALLS = "supervisor_stalls"
SUPERVISOR_GAVE_UP = "supervisor_gave_up"
SUPERVISOR_DURABLE_RESTORES = "supervisor_durable_restores"
# tracing, the flight recorder and the exposition (utils.tracing,
# runtime.expo); DEVICE_BUSY_FRACTION and the stage shares are gauges
TRACE_DUMPS = "trace_dumps"
TRACE_DUMP_ERRORS = "trace_dump_errors"
TRACE_DUMPS_SHED = "trace_dumps_shed"
TRACE_SPAN_ERRORS = "trace_span_errors"
TRACE_SPANS_SHED = "trace_spans_shed"
EXPO_REQUESTS = "expo_requests"
EXPO_ERRORS = "expo_errors"
#: ``stage_share_b<bucket>_<detect|crop|embed|match>``
STAGE_SHARE_PREFIX = "stage_share_"
DEVICE_BUSY_FRACTION = "device_busy_fraction"
# the SLO monitor (runtime.slo); HEALTH_STATE (0 ok, 1 warn, 2 critical)
# and the ``slo_burn_<objective>`` family are gauges
HEALTH_STATE = "health_state"
SLO_EVALUATIONS = "slo_evaluations"
SLO_TRANSITIONS = "slo_transitions"
SLO_PROBE_FAILURES = "slo_probe_failures"
SLO_TICK_ERRORS = "slo_tick_errors"
SLO_BURN_PREFIX = "slo_burn_"
SLO_EVENTS_PREFIX = "slo_events_"
#: ``transport_fault_<kind>`` (``runtime.faults``' transport boundary) and
#: ``router_rejected_<reason>``
TRANSPORT_FAULTS_PREFIX = "transport_fault_"
ROUTER_REJECTED_PREFIX = "router_rejected_"

#: the admission ledger: once the service is idle, ``frames_admitted ==
#: sum(LEDGER_COMPLETION_COUNTERS) + sum(LEDGER_DROP_COUNTERS)``, each
#: admitted frame in exactly one of them. The reference's tables, in its
#: order
LEDGER_COMPLETION_COUNTERS = (FRAMES_COMPLETED, FRAMES_COMPLETED_EMPTY,
                              FRAMES_COMPLETED_CACHED)
LEDGER_DROP_COUNTERS = (FRAMES_MALFORMED, FRAMES_DROPPED_DECODE, BATCHER_DROPPED_MALFORMED,
                        BATCHER_DROPPED_OVERFLOW, BATCHER_DROPPED_STALE,
                        BATCHER_DROPPED_CLOSED, FRAMES_DROPPED_BROWNOUT,
                        FRAMES_DEAD_LETTERED, FRAMES_FAILED, FRAMES_DROPPED_CRASHED)
#: the dynamic families the Prometheus exposition folds into labels
#: (``runtime.promtext``), the reference's table
PROM_FOLDED_PREFIXES = (FRAMES_REJECTED_PREFIX, BATCHER_DROPPED_PREFIX, SLO_EVENTS_PREFIX,
                        SLO_BURN_PREFIX, TRACK_FLUSHES_PREFIX, TRANSPORT_FAULTS_PREFIX,
                        ROUTER_REJECTED_PREFIX)


def all_names():
    """Every registered full name (prefix families excluded), sorted."""
    return sorted(v for k, v in globals().items()
                  if k.isupper() and not k.endswith("_PREFIX") and isinstance(v, str))


def all_prefixes():
    return sorted(v for k, v in globals().items()
                  if k.endswith("_PREFIX") and isinstance(v, str))
