"""The schema-version table of every serialized observability surface: the
port's copy of ``librabft_simulator_tpu/telemetry/schema.py``.

A stream or artifact written by one package is read by the other (the
tests hold both copies equal), so the versions, the digest's slot order and
the refusals are the JAX package's, verbatim.  No torch and no numpy here:
viewers import this from processes that never touch a device.
"""

from __future__ import annotations

#: Frozen schema version per serialized stream kind.  Bump an entry when any
#: field or slot of that kind is added, removed or reordered; every decoder
#: refuses a mismatch.
VERSIONS = {
    "fleet_stream": 1,     # the digest stream: plane, digest and watchdog slot orders
    "runtime_ledger": 1,   # the runtime-ledger span stream
    "serve_state": 1,      # the resident service's save/restore sidecar
    "bench_history": 1,    # the bench history rows
}

REGISTRY_VERSION = VERSIONS["fleet_stream"]
LEDGER_VERSION = VERSIONS["runtime_ledger"]
SERVE_VERSION = VERSIONS["serve_state"]
BENCH_HISTORY_VERSION = VERSIONS["bench_history"]

SUM, MAX, MIN = "sum", "max", "min"

#: The fleet digest: (slot name, how instances and shards fold it).
DIGEST_SLOTS = (
    ("halted", SUM),                # instances halted (slot 0 is the halt poll)
    ("events", SUM),                # total events processed
    ("commits", SUM),               # total per-node commit_count
    ("drops", SUM),                 # network drops
    ("overflow", SUM),              # queue/inbox overflow
    ("queue_depth_max", MAX),       # live (current) per-instance occupancy
    ("committed_round_min", MIN),   # min over all nodes' hcr
    ("committed_round_max", MAX),   # max over all nodes' hcr
    ("wd_stall", SUM),              # watchdog trip counts (0 when off)
    ("wd_queue_sat", SUM),
    ("wd_sync_jump", SUM),
    ("wd_safety_conflict", SUM),
    ("wd_round_regress", SUM),
)
DIGEST_WIDTH = len(DIGEST_SLOTS)

#: Ring-batch annotations on ``kind="row"`` lines (the ``wrap="device"``
#: dispatch, ``TimelineRecorder.record_ring``): ``ring_i`` is the row's place
#: in one outer call's retired batch, ``ring_n`` the batch size.  Absent on
#: rows polled one chunk at a time; additive, so no version bump.
RING_ROW_FIELDS = ("ring_i", "ring_n")

#: Watchdog detectors surfaced in the digest, in wd-plane counter order.
WD_DETECTORS = ("stall", "queue_sat", "sync_jump", "safety_conflict",
                "round_regress")

#: Digest slots that are monotone cumulative totals (windowed rollups
#: difference them); the rest are point-in-time gauges.
COUNTER_SLOTS = frozenset(
    name for name, agg in DIGEST_SLOTS if agg == SUM) - {"halted"}


def require_registry_version(version, what: str = "artifact") -> None:
    """Refuse to decode an artifact written under another slot-map registry
    version: decoding across versions would silently misattribute slots.
    ``None`` (a pre-versioning artifact) is a mismatch too."""
    if version != REGISTRY_VERSION:
        raise ValueError(
            f"{what}: slot-registry version {version!r} does not match this "
            f"build's v{REGISTRY_VERSION}; the telemetry plane / "
            "digest / watchdog slot maps are frozen per version and decoding "
            "across versions silently corrupts reports — regenerate the "
            "artifact with this build (or decode with the build that wrote "
            "it)")


def require_ledger_version(version, what: str = "ledger file") -> None:
    """The runtime-ledger twin of :func:`require_registry_version`."""
    if version != LEDGER_VERSION:
        raise ValueError(
            f"{what}: ledger_version {version!r} does "
            f"not match this build's v{LEDGER_VERSION}")


def require_serve_version(version, what: str = "serve sidecar") -> None:
    """The resident-service sidecar twin."""
    if version != SERVE_VERSION:
        raise ValueError(
            f"{what}: serve_version "
            f"{version} != {SERVE_VERSION} (foreign artifact)")
