"""Flight recorder: a crash-surviving on-disk ring of run events.

The telemetry layer answers "what is the run doing" while the
process is alive; nothing answers "what WAS the run doing" after a
SIGKILL or a wedged device grant takes the process with it — runs
have died leaving one error line and no timeline. The flight recorder
is the black box: a bounded, segment-rotated JSONL ring on disk that
receives every finished span, every run-ledger transition (run start /
chunk launch / chunk done / run end), periodic writer heartbeats with
counter deltas, and free-form events. ``scripts/flight_report.py`` reads
the surviving segments of a dead run, reconstructs the final timeline,
and classifies the end state (clean / preempted / wedged / crashed).

Durability model: records are enqueued from the training thread (a dict
append — never blocks, never raises; a full queue drops and counts) and
written by ONE background writer thread, the ``save_async`` shape. The
writer flushes after every drain, so a SIGKILL loses only the few
records still in the queue; segment ROTATION applies the
``atomic_write_text`` fsync discipline (fsync the finished segment, then
the directory) so completed segments survive even a machine crash — the
bound on loss is one segment. Disk use is capped at
``segments × segment_bytes``: rotation unlinks the oldest segment past
the count; the JSONL exporter routes through :func:`shift_rotate`
below for the same cap.

Env surface (see docs/env.md): ``DL4J_FLIGHT`` (``1``/``on`` records
under ``$DL4J_TELEMETRY_DIR/flight``; any other value is an explicit
directory; unset/off disables), ``DL4J_FLIGHT_SEGMENT_KB`` /
``DL4J_FLIGHT_SEGMENTS`` (segment size / count, shared with the JSONL
exporter's cap), ``DL4J_FLIGHT_HEARTBEAT_S`` (writer heartbeat period —
the signal that separates "process died" from "process alive but
stuck" in the postmortem).

Stdlib-only at import, like the rest of ``monitor/``.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.monitor.exporters import _json_default
from deeplearning4j_tpu_torch.utils.fileio import _fsync_dir

logger = logging.getLogger(__name__)

__all__ = [
    "FlightRecorder",
    "classify_end_state",
    "flight",
    "flight_dir",
    "flight_record",
    "load_flight_records",
    "max_segments",
    "segment_bytes",
    "set_flight",
    "shift_rotate",
]

DEFAULT_SEGMENT_KB = 256
DEFAULT_SEGMENTS = 8
DEFAULT_HEARTBEAT_S = 1.0

SEGMENT_RE = re.compile(r"^flight-(\d{8})\.jsonl$")

_ON = ("1", "on", "true", "yes")
_OFF = ("", "0", "off", "false", "no")


def flight_dir() -> Optional[str]:
    """Resolve ``DL4J_FLIGHT``: on-values record under
    ``$DL4J_TELEMETRY_DIR/flight``; any other non-off value is taken as
    an explicit directory; off/unset disables (None)."""
    raw = os.environ.get("DL4J_FLIGHT", "").strip()
    if raw.lower() in _OFF:
        return None
    if raw.lower() in _ON:
        from deeplearning4j_tpu_torch.monitor.exporters import telemetry_dir

        d = telemetry_dir()
        if d is None:
            logger.warning("DL4J_FLIGHT is on but DL4J_TELEMETRY_DIR is "
                           "unset; flight recording disabled")
            return None
        return os.path.join(d, "flight")
    return raw


def segment_bytes() -> int:
    """``DL4J_FLIGHT_SEGMENT_KB`` (default 256 KB): rotation threshold
    for one flight segment — also the JSONL exporter's cap unit."""
    raw = os.environ.get("DL4J_FLIGHT_SEGMENT_KB", "")
    try:
        kb = int(raw) if raw else DEFAULT_SEGMENT_KB
    except ValueError:
        kb = DEFAULT_SEGMENT_KB
    return max(1, kb) * 1024


def max_segments() -> int:
    """``DL4J_FLIGHT_SEGMENTS`` (default 8): how many segments the ring
    keeps; rotation unlinks the oldest beyond it."""
    raw = os.environ.get("DL4J_FLIGHT_SEGMENTS", "")
    try:
        n = int(raw) if raw else DEFAULT_SEGMENTS
    except ValueError:
        n = DEFAULT_SEGMENTS
    return max(2, n)


def heartbeat_s() -> float:
    """``DL4J_FLIGHT_HEARTBEAT_S`` (default 1 s): writer heartbeat
    period."""
    raw = os.environ.get("DL4J_FLIGHT_HEARTBEAT_S", "")
    try:
        v = float(raw) if raw else DEFAULT_HEARTBEAT_S
    except ValueError:
        v = DEFAULT_HEARTBEAT_S
    return max(0.01, v)


def shift_rotate(path: str, backups: int) -> None:
    """Logrotate-style shift for a single append file: ``path`` becomes
    ``path.1``, ``path.1`` becomes ``path.2``, …; the oldest backup is
    overwritten, so total files never exceed ``backups + 1``. The
    JSONL exporter routes through this to cap telemetry disk use."""
    if backups <= 0:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        return
    for i in range(backups - 1, 0, -1):
        src = f"{path}.{i}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i + 1}")
    os.replace(path, f"{path}.1")


class FlightRecorder:
    """Segment-rotated JSONL ring with a single background writer.

    ``record(kind, **payload)`` enqueues one event (never blocks, never
    raises — a full queue drops and counts); the writer thread drains
    the queue, appends JSON lines to the active ``flight-%08d.jsonl``
    segment (flushed per drain), stamps a ``flight.heartbeat`` record
    every ``heartbeat_s`` seconds carrying the counter totals that
    changed since the last beat, and rotates segments with
    fsync-file-then-directory durability. A fresh recorder always opens
    a NEW segment (never appends to a possibly-torn one).
    """

    _QUEUE_MAX = 8192

    def __init__(self, directory: str,
                 segment_bytes_: Optional[int] = None,
                 max_segments_: Optional[int] = None,
                 heartbeat_s_: Optional[float] = None,
                 metric_deltas: bool = True):
        self.directory = directory
        self.segment_bytes = (segment_bytes() if segment_bytes_ is None
                              else int(segment_bytes_))
        self.max_segments = (max_segments() if max_segments_ is None
                             else max(2, int(max_segments_)))
        self.heartbeat_s = (heartbeat_s() if heartbeat_s_ is None
                            else max(0.01, float(heartbeat_s_)))
        self.metric_deltas = metric_deltas
        self.records_written = 0
        self.segments_rotated = 0
        self.records_dropped = 0
        self.heartbeats_written = 0
        os.makedirs(directory, exist_ok=True)
        existing = _segment_indices(directory)
        self._index = (existing[-1] + 1) if existing else 1
        self._file = None
        self._size = 0
        self._last_counters: Dict[str, float] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=self._QUEUE_MAX)
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="flight-writer")
        self._thread.start()

    # -- producer side --------------------------------------------------
    def record(self, kind: str, **payload) -> None:
        """Enqueue one event. Safe from any thread; never raises."""
        if self._closed:
            return
        rec = {"kind": kind, "t_wall": time.time()}
        rec.update(payload)
        try:
            self._q.put_nowait(rec)
        except queue.Full:
            self.records_dropped += 1

    def record_span(self, span_dict: dict) -> None:
        """Forward one finished tracer span (``trace._record`` wires in
        here via :func:`flight`)."""
        self.record("span", **span_dict)

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until everything queued so far is on disk (tests and
        the bench use this before reading segments back)."""
        if self._closed:
            return True
        ev = threading.Event()
        try:
            self._q.put_nowait({"kind": "__flush__", "_event": ev})
        except queue.Full:
            return False
        return ev.wait(timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Stamp a ``flight.close`` record, drain, fsync, and retire the
        writer. Idempotent."""
        if self._closed:
            return
        self.record("flight.close")
        self._closed = True
        self._stop.set()
        try:  # wake a blocked writer
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=timeout)

    # -- writer side -----------------------------------------------------
    def _run(self) -> None:
        next_beat = time.monotonic() + self.heartbeat_s
        while True:
            timeout = max(0.01, next_beat - time.monotonic())
            batch: List[dict] = []
            try:
                item = self._q.get(timeout=timeout)
                if item is not None:
                    batch.append(item)
            except queue.Empty:
                pass
            while True:  # drain whatever else is queued, non-blocking
                try:
                    item = self._q.get_nowait()
                    if item is not None:
                        batch.append(item)
                except queue.Empty:
                    break
            try:
                if batch:
                    self._write(batch)
                if time.monotonic() >= next_beat:
                    self._write([self._heartbeat_record()])
                    self.heartbeats_written += 1
                    next_beat = time.monotonic() + self.heartbeat_s
            except Exception:  # a full disk must not kill the writer
                logger.warning("flight writer error (continuing)",
                               exc_info=True)
            if self._stop.is_set() and self._q.empty():
                break
        self._finalize()

    def _heartbeat_record(self) -> dict:
        rec = {"kind": "flight.heartbeat", "t_wall": time.time(),
               "interval_s": self.heartbeat_s}
        if self.metric_deltas:
            try:
                totals = _counter_totals()
                changed = {k: v for k, v in totals.items()
                           if self._last_counters.get(k) != v}
                self._last_counters = totals
                if changed:
                    rec["counters"] = changed
            except Exception:  # registry access is best-effort here
                pass
        return rec

    def _write(self, batch: List[dict]) -> None:
        for rec in batch:
            if rec.get("kind") == "__flush__":
                ev = rec.get("_event")
                self._sync_file(fsync=False)
                if ev is not None:
                    ev.set()
                continue
            line = json.dumps(rec, default=_json_default) + "\n"
            if self._file is not None and self._size > 0 \
                    and self._size + len(line) > self.segment_bytes:
                self._rotate()
            if self._file is None:
                self._open_segment()
            self._file.write(line)
            self._size += len(line)  # dl4j-lint: disable=lock-discipline -- writer-thread-confined: only _run() and its callees touch _size after __init__
            self.records_written += 1
        self._sync_file(fsync=False)

    def _sync_file(self, fsync: bool) -> None:
        if self._file is None:
            return
        self._file.flush()
        if fsync:
            os.fsync(self._file.fileno())

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.directory, f"flight-{index:08d}.jsonl")

    def _open_segment(self) -> None:
        self._file = open(self._segment_path(self._index), "a")  # dl4j-lint: disable=lock-discipline -- writer-thread-confined: only _run() and its callees touch _file after __init__
        self._size = 0  # dl4j-lint: disable=lock-discipline -- writer-thread-confined: only _run() and its callees touch _size after __init__

    def _rotate(self) -> None:
        # the atomic_write_text durability ritual at the segment grain:
        # the finished segment's bytes are fsynced, then its directory
        # entry — a machine crash after this point cannot lose it
        self._sync_file(fsync=True)
        self._file.close()
        _fsync_dir(self.directory)
        self._file = None  # dl4j-lint: disable=lock-discipline -- writer-thread-confined: only _run() and its callees touch _file after __init__
        self._index += 1
        self.segments_rotated += 1
        # the segment about to open counts against the cap too
        for idx in _segment_indices(self.directory)[:-(self.max_segments
                                                       - 1)]:
            try:
                os.unlink(self._segment_path(idx))
            except FileNotFoundError:
                pass

    def _finalize(self) -> None:
        try:
            self._sync_file(fsync=True)
            if self._file is not None:
                self._file.close()
                self._file = None  # dl4j-lint: disable=lock-discipline -- writer-thread-confined: _finalize runs on the writer thread itself
            _fsync_dir(self.directory)
        except OSError:
            logger.warning("flight finalize failed", exc_info=True)


def _segment_indices(directory: str) -> List[int]:
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        m = SEGMENT_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _counter_totals() -> Dict[str, float]:
    """Label-summed counter totals — the compact delta payload the
    heartbeat records (full snapshots would bloat the ring)."""
    from deeplearning4j_tpu_torch.monitor.registry import metrics

    totals: Dict[str, float] = {}
    for inst in metrics().instruments():
        if inst.kind != "counter":
            continue
        totals[inst.name] = float(sum(inst.series().values()))
    return totals


# ---------------------------------------------------------------------------
# the process-global recorder
# ---------------------------------------------------------------------------

_RECORDER: Optional[FlightRecorder] = None
_DERIVED = False
_LOCK = threading.Lock()


def flight() -> Optional[FlightRecorder]:
    """The process-global recorder, derived from ``DL4J_FLIGHT`` on
    first use; None when disabled."""
    global _RECORDER, _DERIVED
    if not _DERIVED:
        with _LOCK:
            if not _DERIVED:
                d = flight_dir()
                if d is not None:
                    try:
                        _RECORDER = FlightRecorder(d)
                    except OSError as e:
                        logger.warning("flight recorder disabled: cannot "
                                       "open %s: %s", d, e)
                        _RECORDER = None
                _DERIVED = True
    return _RECORDER


def set_flight(recorder: Optional[FlightRecorder]) -> None:
    """Install a recorder explicitly (bench, tests); ``None`` resets to
    env derivation on next use. Does NOT close the previous recorder —
    the caller that created it owns its lifecycle."""
    global _RECORDER, _DERIVED
    with _LOCK:
        _RECORDER = recorder
        _DERIVED = recorder is not None


def flight_record(kind: str, **payload) -> None:
    """One-line event record against the global recorder; no-op when
    flight recording is disabled. Chunk-boundary-only on training paths
    (dl4j-lint's host-sync rule enforces it like the profile
    readbacks)."""
    rec = flight()
    if rec is not None:
        rec.record(kind, **payload)


# ---------------------------------------------------------------------------
# postmortem side: load segments, classify the end state
# ---------------------------------------------------------------------------

#: record kinds that do NOT count as forward progress
_NON_PROGRESS_KINDS = ("flight.heartbeat",)
#: span/event names that are evidence of a stuck (not dead) process
WEDGE_EVIDENCE_NAMES = ("watchdog.stall", "grant.watchdog")
#: span/event names that mark a grant-lease RESCUE: the grant wedged and
#: was re-acquired (resilience/lease.py). A run that then finishes clean
#: classifies as ``reacquired`` — clean-with-recovery, not wedged.
REACQUIRE_EVIDENCE_NAMES = ("grant.reacquired",)
#: serve-fleet overload evidence: a graceful drain (planned retire with
#: KV-slab migration) vs. overload shedding (deadline/displacement
#: drops). Both are ORDERLY endings — the run closed clean — but a
#: postmortem must distinguish "we chose to shrink" and "we shed load"
#: from a genuinely uneventful run.
DRAIN_EVIDENCE_NAMES = ("serve.drain",)
SHED_EVIDENCE_NAMES = ("serve.shed",)
#: factor of the heartbeat interval after which continued beats with no
#: progress classify as a wedge
WEDGE_SILENCE_FACTOR = 3.0


def load_flight_records(directory: str) -> List[dict]:
    """Parse every surviving segment in index order. Torn lines (the
    write the crash interrupted) are skipped, not fatal — the postmortem
    reads what survived."""
    records: List[dict] = []
    for idx in _segment_indices(directory):
        path = os.path.join(directory, f"flight-{idx:08d}.jsonl")
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail of a killed writer
                    if isinstance(rec, dict):
                        rec["_segment"] = idx
                        records.append(rec)
        except OSError:
            continue
    return records


def _is_wedge_evidence(rec: dict) -> bool:
    if rec.get("kind") in WEDGE_EVIDENCE_NAMES:
        return True
    return (rec.get("kind") == "span"
            and rec.get("name") in WEDGE_EVIDENCE_NAMES)


def _is_reacquire_evidence(rec: dict) -> bool:
    if rec.get("kind") in REACQUIRE_EVIDENCE_NAMES:
        return True
    return (rec.get("kind") == "span"
            and rec.get("name") in REACQUIRE_EVIDENCE_NAMES)


def _is_drain_evidence(rec: dict) -> bool:
    if rec.get("kind") in DRAIN_EVIDENCE_NAMES:
        return True
    return (rec.get("kind") == "span"
            and rec.get("name") in DRAIN_EVIDENCE_NAMES)


def _is_shed_evidence(rec: dict) -> bool:
    if rec.get("kind") in SHED_EVIDENCE_NAMES:
        return True
    return (rec.get("kind") == "span"
            and rec.get("name") in SHED_EVIDENCE_NAMES)


def _is_progress(rec: dict) -> bool:
    return (rec.get("kind") not in _NON_PROGRESS_KINDS
            and not _is_wedge_evidence(rec))


def classify_end_state(records: List[dict],
                       wedge_factor: float = WEDGE_SILENCE_FACTOR) -> dict:
    """Classify how the recorded process ended, from surviving records
    alone.

    - ``clean``     — the last run closed in an orderly way (status
      ``clean``, or ``stopped`` by a user's ``on_chunk`` callback with
      no preemption latch on the timeline), or the recorder closed with
      no run in flight.
    - ``preempted`` — the run closed with a preemption latch on the
      timeline after the last run start (the latch — not the
      ``stopped`` status, which any on_chunk early-stop sets — is the
      preemption signal).
    - ``wedged``    — no closing record, and either explicit wedge
      evidence (watchdog stall / grant watchdog) follows the last
      progress record, or heartbeats kept arriving for longer than
      ``wedge_factor × interval`` after progress stopped — the process
      was alive but stuck (the grant-wedge shape).
    - ``crashed``   — records stop abruptly (heartbeats die with the
      progress), or the run closed with an error status: the process
      (or the program) died mid-work.
    - ``reacquired`` — an otherwise-clean ending whose timeline carries
      ``grant.reacquired`` evidence: a grant wedged mid-run and the
      lease rescued it. Operationally clean-with-recovery — the round
      survived — but flagged so a fleet quietly re-acquiring every run
      is visible, not folded into ``clean``.
    - ``drained``  — clean-and-planned: the timeline carries
      ``serve.drain`` evidence (a replica was gracefully retired with
      its streams migrated). Outranks ``shed-overload`` — the
      operator's decision names the run.
    - ``shed-overload`` — clean-but-degraded: the run closed orderly
      but ``serve.shed`` evidence shows load was dropped (deadline
      expiry or criticality displacement) on the way.
    """
    if not records:
        return {"end_state": "unknown", "evidence": "no records survived"}
    open_run = None
    last_close = None
    preempted = False
    for rec in records:
        kind = rec.get("kind")
        if kind == "run.start":
            open_run = rec
            preempted = False
        elif kind == "run.end":
            open_run = None
            last_close = rec
        elif (kind == "preemption.latch"
              or (kind == "span"
                  and rec.get("name") == "preemption.latch")):
            preempted = True
    last = records[-1]
    progress = [r for r in records if _is_progress(r)]
    last_progress = progress[-1] if progress else records[0]
    evidence = {
        "n_records": len(records),
        "last_record": {k: v for k, v in last.items()
                        if k not in ("_segment",)},
        "last_progress": {k: v for k, v in last_progress.items()
                          if k not in ("_segment",)},
    }
    # an orderly ending needs positive evidence: either a run actually
    # closed (run.end) with nothing started after it, or the recorder
    # itself closed with nothing in flight. A timeline with NO run and
    # no close — the shape where the grant wedges before
    # any section starts — falls through to the stuck-or-dead analysis.
    orderly = (open_run is None
               and (last_close is not None
                    or last_progress.get("kind") == "flight.close"))
    if orderly:
        status = (last_close or {}).get("status", "clean")
        # only the latch means preemption: status "stopped" alone is any
        # on_chunk callback returning True (e.g. a user's convergence
        # early-stop) — an orderly ending, not an eviction story
        if preempted:
            return {"end_state": "preempted", "evidence": evidence,
                    "status": status}
        if str(status).startswith("error"):
            return {"end_state": "crashed", "evidence": evidence,
                    "status": status}
        reacquires = sum(1 for r in records if _is_reacquire_evidence(r))
        if reacquires:
            evidence["n_reacquires"] = reacquires
            return {"end_state": "reacquired", "evidence": evidence,
                    "status": status}
        # serve-fleet orderly variants, most deliberate first: a
        # PLANNED drain outranks shedding (a drained run that also
        # shed classifies by the operator's decision, with the shed
        # count still in the evidence)
        drains = sum(1 for r in records if _is_drain_evidence(r))
        sheds = sum(1 for r in records if _is_shed_evidence(r))
        if sheds:
            evidence["n_sheds"] = sheds
        if drains:
            evidence["n_drains"] = drains
            return {"end_state": "drained", "evidence": evidence,
                    "status": status}
        if sheds:
            return {"end_state": "shed-overload", "evidence": evidence,
                    "status": status}
        return {"end_state": "clean", "evidence": evidence,
                "status": status}
    # work was in flight (a run, or a pre-run phase like grant
    # acquisition) when the records stop: stuck or dead?
    if open_run is not None:
        evidence["open_run"] = {k: v for k, v in open_run.items()
                                if k not in ("_segment",)}
    if preempted:
        # latched but never reached the chunk boundary that would have
        # stopped it cleanly — the preemption killed it mid-chunk
        evidence["note"] = "preemption latched but the run never closed"
    wedge_after_progress = any(
        _is_wedge_evidence(r) and r.get("t_wall", 0)
        >= last_progress.get("t_wall", 0) for r in records)
    # an open grant.wait marker IS wedge evidence: it is written
    # immediately before a call that can block indefinitely, and a
    # grant that returned would have produced further progress records
    open_grant = last_progress.get("kind") == "grant.wait"
    interval = DEFAULT_HEARTBEAT_S
    for r in reversed(records):
        if r.get("kind") == "flight.heartbeat":
            interval = float(r.get("interval_s", interval))
            break
    silent_s = float(last.get("t_wall", 0.0)) - float(
        last_progress.get("t_wall", 0.0))
    evidence["silent_s"] = round(silent_s, 3)
    evidence["heartbeat_interval_s"] = interval
    if (wedge_after_progress or open_grant
            or silent_s >= wedge_factor * interval):
        return {"end_state": "wedged", "evidence": evidence}
    return {"end_state": "crashed", "evidence": evidence}
