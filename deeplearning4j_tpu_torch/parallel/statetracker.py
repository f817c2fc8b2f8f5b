"""Cluster state tracking: jobs, worker updates, heartbeats.

Port of ``deeplearning4j_tpu/parallel/statetracker.py`` (the reference's
StateTracker SPI and its Hazelcast implementation). The data plane is
``torch.distributed`` collectives, so the tracker is the control plane:
work assignment, liveness, and replicated metadata. Two backends:

- ``InMemoryStateTracker`` — thread-safe in-process maps (the embedded-
  Hazelcast role; used by single-host tests).
- ``FileStateTracker`` — a directory on a shared filesystem (NFS or a
  local disk) with atomic rename writes; processes on different hosts
  coordinate through it without any extra service. Its on-disk layout
  (``jobs/``, ``beats/``, ``meta/``, ``locks/`` and ``tmp/``)
  is the JAX package's byte for byte, so a directory written by either
  package is read by the other.

Job lifecycle mirrors the reference (pending → claimed → done, with requeue
on failure).

Resilience: every FileStateTracker publish goes through the shared
``RetryPolicy`` (transient I/O errors retry with jittered backoff instead
of killing a worker) and declares the ``statetracker.write`` fault point;
``heartbeat.post`` fires on every heartbeat of either backend so chaos
tests can starve liveness tracker-agnostically.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.resilience import (
    FaultInjected,
    RetryError,
    RetryPolicy,
    faults,
)
from deeplearning4j_tpu_torch.utils.fileio import (
    atomic_write_bytes,
    atomic_write_text,
)

logger = logging.getLogger(__name__)

#: transient classes a shared-filesystem tracker may hit and injected
#: faults tests raise; ValueError covers torn non-atomic media reads
#: (json decode errors subclass it)
_TRANSIENT = (OSError, FaultInjected, ValueError)


def default_tracker_retry_policy() -> RetryPolicy:
    """Small/fast: control-plane writes are tiny, so four attempts inside
    ~0.3 s catches transient shared-fs hiccups without stalling training."""
    return RetryPolicy(max_attempts=4, base_delay_s=0.01, max_delay_s=0.1,
                       retryable=_TRANSIENT)


@dataclass
class Job:
    """A unit of work (the reference's job/Job.java: work + worker id)."""

    job_id: str
    payload: Any = None
    worker_id: Optional[str] = None
    status: str = "pending"  # pending | claimed | done | failed
    attempts: int = 0
    result: Any = None

    def to_json(self) -> Dict[str, Any]:
        return {"job_id": self.job_id, "payload": self.payload,
                "worker_id": self.worker_id, "status": self.status,
                "attempts": self.attempts, "result": self.result}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Job":
        return Job(**d)


class StateTracker:
    """SPI: what every backend provides (StateTracker.java contract —
    jobs, workerUpdates, heartbeats, replication)."""

    # --- jobs ---
    def add_job(self, payload: Any, job_id: Optional[str] = None) -> str:
        raise NotImplementedError

    def claim_job(self, worker_id: str) -> Optional[Job]:
        raise NotImplementedError

    def complete_job(self, job_id: str, result: Any = None) -> None:
        raise NotImplementedError

    def fail_job(self, job_id: str, requeue: bool = True) -> None:
        raise NotImplementedError

    def jobs(self, status: Optional[str] = None) -> List[Job]:
        raise NotImplementedError

    # --- heartbeats / liveness ---
    def heartbeat(self, worker_id: str,
                  metrics: Optional[Dict[str, Any]] = None) -> None:
        """Post liveness; ``metrics`` (optional) is a COMPACT payload
        the master's fleet view aggregates. Two payload schemas ride
        this channel today (free-form dicts by contract; these are the
        keys the aggregators look for): training workers post
        ``{step_s, jobs, last_loss, goodput_pct}``
        (``DistributedTrainer``'s fleet tick), serve replicas post
        ``{role, occupancy, queue_depth, free_slots, ttft_p50, tpot_s,
        tokens_per_sec}`` (``serving/fleet``'s router + controller).
        Payload-less beats remain fully supported (and are the cheap
        path); backends that predate the parameter still satisfy the
        liveness half of the contract."""
        raise NotImplementedError

    def last_heartbeat(self, worker_id: str) -> Optional[float]:
        raise NotImplementedError

    def heartbeat_metrics(self, worker_id: str
                          ) -> Optional[Dict[str, Any]]:
        """The metrics payload of the worker's newest beat, or None
        (payload-less beat, unknown worker, or a backend without
        payload support — the default)."""
        return None

    def workers(self) -> List[str]:
        raise NotImplementedError

    def evict_stale(self, timeout_s: float = 120.0) -> List[str]:
        """Remove workers silent for >= timeout_s and requeue their claimed
        jobs (MasterActor.java:141-171: 120 s stale-worker eviction)."""
        raise NotImplementedError

    def evict_worker(self, worker_id: str) -> bool:
        """Evict ONE named worker regardless of beat age and requeue its
        claimed jobs — the autopilot's targeted-eviction primitive (a
        flagged straggler is still beating, so ``evict_stale`` cannot
        reach it). Returns True when the worker was registered."""
        raise NotImplementedError

    # --- replicated key/value metadata (config registry role) ---
    def put_meta(self, key: str, value: Any) -> None:
        raise NotImplementedError

    def get_meta(self, key: str, default: Any = None) -> Any:
        raise NotImplementedError

    # -- worker updates (StateTracker.java workerUpdates; arrays) --------
    # every post gets its own entry (worker@nonce): a worker finishing two
    # jobs in one barrier round must contribute TWO updates, not overwrite
    def post_update(self, worker_id: str, update) -> None:
        raise NotImplementedError

    def updates(self) -> Dict[str, Any]:
        """Non-destructive snapshot (barrier peek) — loads the arrays."""
        raise NotImplementedError

    def posted_update_keys(self) -> List[str]:
        """Cheap peek: entry keys only, no array deserialization."""
        raise NotImplementedError

    @staticmethod
    def update_worker(key: str) -> str:
        """Worker id from an update-entry key (``worker@nonce``)."""
        return key.rsplit("@", 1)[0]

    def drain_updates(self) -> Dict[str, Any]:
        """Atomically take-and-remove all posted updates: an update is
        either returned to exactly one drainer or left for the next one —
        never silently dropped (the check-then-clear race)."""
        raise NotImplementedError

    def clear_updates(self) -> None:
        self.drain_updates()

    # -- binary array metadata (global params channel) -------------------
    def put_array(self, key: str, value) -> None:
        raise NotImplementedError

    def get_array(self, key: str, default: Any = None) -> Any:
        raise NotImplementedError


class InMemoryStateTracker(StateTracker):
    """Thread-safe in-process tracker (embedded-Hazelcast role)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._jobs: Dict[str, Job] = {}
        self._order: List[str] = []
        self._beats: Dict[str, float] = {}
        self._beat_metrics: Dict[str, Dict[str, Any]] = {}
        self._meta: Dict[str, Any] = {}
        self._updates: Dict[str, Any] = {}
        self._arrays: Dict[str, Any] = {}

    def add_job(self, payload: Any, job_id: Optional[str] = None) -> str:
        with self._lock:
            jid = job_id or uuid.uuid4().hex
            self._jobs[jid] = Job(jid, payload)
            self._order.append(jid)
            return jid

    def claim_job(self, worker_id: str) -> Optional[Job]:
        with self._lock:
            for jid in self._order:
                j = self._jobs[jid]
                if j.status == "pending":
                    j.status = "claimed"
                    j.worker_id = worker_id
                    j.attempts += 1
                    return Job(**j.to_json())
            return None

    def complete_job(self, job_id: str, result: Any = None) -> None:
        with self._lock:
            j = self._jobs[job_id]
            j.status = "done"
            j.result = result

    def fail_job(self, job_id: str, requeue: bool = True) -> None:
        with self._lock:
            j = self._jobs[job_id]
            j.status = "pending" if requeue else "failed"
            j.worker_id = None

    def jobs(self, status: Optional[str] = None) -> List[Job]:
        with self._lock:
            out = [self._jobs[j] for j in self._order]
            if status is not None:
                out = [j for j in out if j.status == status]
            return [Job(**j.to_json()) for j in out]

    def heartbeat(self, worker_id: str,
                  metrics: Optional[Dict[str, Any]] = None) -> None:
        faults.fault_point("heartbeat.post")
        with self._lock:
            self._beats[worker_id] = time.time()
            if metrics is not None:
                self._beat_metrics[worker_id] = dict(metrics)
            else:
                # a payload-less beat REPLACES the previous payload
                # (same overwrite semantics as the file backend's beat
                # file): heartbeat_metrics reports the newest beat, not
                # a stale snapshot from a worker whose payload_fn died
                self._beat_metrics.pop(worker_id, None)

    def last_heartbeat(self, worker_id: str) -> Optional[float]:
        with self._lock:
            return self._beats.get(worker_id)

    def heartbeat_metrics(self, worker_id: str
                          ) -> Optional[Dict[str, Any]]:
        with self._lock:
            m = self._beat_metrics.get(worker_id)
            return None if m is None else dict(m)

    def workers(self) -> List[str]:
        with self._lock:
            return sorted(self._beats)

    def evict_stale(self, timeout_s: float = 120.0) -> List[str]:
        with self._lock:
            now = time.time()
            stale = [w for w, t in self._beats.items()
                     if now - t >= timeout_s]
            for w in stale:
                del self._beats[w]
                self._beat_metrics.pop(w, None)
                for j in self._jobs.values():
                    if j.worker_id == w and j.status == "claimed":
                        j.status = "pending"
                        j.worker_id = None
            return stale

    def evict_worker(self, worker_id: str) -> bool:
        with self._lock:
            known = worker_id in self._beats
            self._beats.pop(worker_id, None)
            self._beat_metrics.pop(worker_id, None)
            for j in self._jobs.values():
                if j.worker_id == worker_id and j.status == "claimed":
                    j.status = "pending"
                    j.worker_id = None
            return known

    def put_meta(self, key: str, value: Any) -> None:
        with self._lock:
            self._meta[key] = value

    def get_meta(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._meta.get(key, default)

    def post_update(self, worker_id: str, update) -> None:
        import numpy as np

        with self._lock:
            self._updates[f"{worker_id}@{uuid.uuid4().hex[:8]}"] = (
                np.asarray(update))

    def updates(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._updates)

    def posted_update_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._updates)

    def drain_updates(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._updates)
            self._updates.clear()
            return out

    def put_array(self, key: str, value) -> None:
        import numpy as np

        with self._lock:
            self._arrays[key] = np.asarray(value)

    def get_array(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._arrays.get(key, default)


class FileStateTracker(StateTracker):
    """Directory-backed tracker for multi-process/multi-host coordination.

    Layout: ``<root>/jobs/<id>.json``, ``<root>/beats/<worker>``,
    ``<root>/meta/<key>.json``. All writes are atomic (tempfile + rename on
    the same filesystem), so concurrent readers never see partial JSON.
    Claims use kernel advisory locks (``flock``) on per-job lock files — the
    same first-writer-wins discipline the reference gets from Hazelcast
    distributed locks, with crash-release handled by the kernel (a dead
    process's lock vanishes with its fd, so no stale-lock breaking is
    needed and no two claimers can ever hold the same job).
    """

    def __init__(self, root: str,
                 retry_policy: Optional[RetryPolicy] = None):
        self.root = root
        self.retry_policy = retry_policy or default_tracker_retry_policy()
        self._lock_fds: Dict[str, int] = {}
        for sub in ("jobs", "beats", "meta", "locks", "tmp"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)

    # -- helpers --
    def _atomic_write(self, path: str, data: str,
                      durable: bool = True) -> None:
        # staged in a separate tmp/ dir so directory listings of jobs/ and
        # beats/ never see half-written entries; transient I/O failures
        # (and injected ones) retry under the policy
        def write():
            faults.fault_point("statetracker.write")
            atomic_write_text(path, data,
                              tmp_dir=os.path.join(self.root, "tmp"),
                              durable=durable)

        self.retry_policy.call(write)

    def _job_path(self, jid: str) -> str:
        return os.path.join(self.root, "jobs", jid + ".json")

    def _read_job(self, jid: str) -> Optional[Job]:
        # a decode error is a torn read on non-atomic shared media (rename
        # is atomic locally; gcsfuse/NFS caching is not) — retry it as
        # transient before concluding the job is unreadable. A missing
        # file is a definitive answer, not a fault: never retried.
        def read():
            try:
                with open(self._job_path(jid)) as f:
                    return Job.from_json(json.load(f))
            except FileNotFoundError:
                return None

        try:
            return self.retry_policy.call(read)
        except RetryError as e:  # transient class exhausted its retries
            logger.warning("job %s unreadable after retries: %s", jid, e)
            return None
        # anything non-retryable (e.g. TypeError from a schema-mismatched
        # job file) propagates: a real bug must crash loudly, not make the
        # job silently vanish from jobs()/claim_job()

    def _write_job(self, job: Job) -> None:
        self._atomic_write(self._job_path(job.job_id),
                           json.dumps(job.to_json()))

    def _try_lock(self, name: str) -> bool:
        path = os.path.join(self.root, "locks", name)
        fd = os.open(path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        self._lock_fds[name] = fd
        return True

    def _unlock(self, name: str) -> None:
        fd = self._lock_fds.pop(name, None)
        if fd is not None:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    # -- jobs --
    def add_job(self, payload: Any, job_id: Optional[str] = None) -> str:
        # time-prefixed ids preserve FIFO claim order via sorted listing
        jid = job_id or f"{time.time_ns():020d}-{uuid.uuid4().hex[:8]}"
        self._write_job(Job(jid, payload))
        return jid

    def _job_ids(self) -> List[str]:
        return sorted(p[:-5] for p in
                      os.listdir(os.path.join(self.root, "jobs"))
                      if p.endswith(".json"))

    def claim_job(self, worker_id: str) -> Optional[Job]:
        for jid in self._job_ids():
            j = self._read_job(jid)
            if j is None or j.status != "pending":
                continue
            if not self._try_lock("claim-" + jid):
                continue
            try:
                j = self._read_job(jid)  # re-read under lock
                if j is None or j.status != "pending":
                    continue
                j.status = "claimed"
                j.worker_id = worker_id
                j.attempts += 1
                self._write_job(j)
                return j
            finally:
                self._unlock("claim-" + jid)
        return None

    def complete_job(self, job_id: str, result: Any = None) -> None:
        j = self._read_job(job_id)
        if j is None:
            raise KeyError(job_id)
        j.status = "done"
        j.result = result
        self._write_job(j)

    def fail_job(self, job_id: str, requeue: bool = True) -> None:
        j = self._read_job(job_id)
        if j is None:
            raise KeyError(job_id)
        j.status = "pending" if requeue else "failed"
        j.worker_id = None
        self._write_job(j)

    def jobs(self, status: Optional[str] = None) -> List[Job]:
        out = []
        for jid in self._job_ids():
            j = self._read_job(jid)
            if j is not None and (status is None or j.status == status):
                out.append(j)
        return out

    # -- heartbeats --
    def _beat_path(self, worker_id: str) -> str:
        return os.path.join(self.root, "beats", worker_id)

    def heartbeat(self, worker_id: str,
                  metrics: Optional[Dict[str, Any]] = None) -> None:
        faults.fault_point("heartbeat.post")

        # beats bypass the statetracker.write fault point: background
        # monitor threads post them continuously, and letting them bump a
        # count-based schedule (fail_nth) installed for DATA writes would
        # make that site nondeterministic. heartbeat.post is the beats'
        # own injection site. durable=False: beats are ephemeral liveness
        # data overwritten every interval — two fsyncs per beat would
        # throttle the control plane on NFS/gcsfuse for durability nobody
        # reads back.
        #
        # Payload-less beats keep the legacy bare-float format (cheap,
        # and readable by any older coordinator); a metrics payload
        # upgrades the file to one JSON object. last_heartbeat parses
        # both, so fleets mix old and new workers freely. The timestamp
        # is stamped INSIDE write(): a beat that lands only after retry
        # backoffs must report when it landed, or the retry duration
        # ages the worker toward eviction when the filesystem — not the
        # worker — was slow.
        def write():
            body = (repr(time.time()) if metrics is None
                    else json.dumps({"t": time.time(),
                                     "metrics": dict(metrics)}))
            atomic_write_text(self._beat_path(worker_id), body,
                              tmp_dir=os.path.join(self.root, "tmp"),
                              durable=False)

        self.retry_policy.call(write)

    def _read_beat(self, worker_id: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._beat_path(worker_id)) as f:
                raw = f.read()
        except OSError:
            return None
        try:
            return {"t": float(raw), "metrics": None}
        except ValueError:
            pass
        try:
            d = json.loads(raw)
            return {"t": float(d["t"]), "metrics": d.get("metrics")}
        except (ValueError, TypeError, KeyError):
            return None  # torn write on non-atomic media: treat as absent

    def last_heartbeat(self, worker_id: str) -> Optional[float]:
        beat = self._read_beat(worker_id)
        return None if beat is None else beat["t"]

    def heartbeat_metrics(self, worker_id: str
                          ) -> Optional[Dict[str, Any]]:
        beat = self._read_beat(worker_id)
        return None if beat is None else beat["metrics"]

    def workers(self) -> List[str]:
        return sorted(os.listdir(os.path.join(self.root, "beats")))

    def evict_stale(self, timeout_s: float = 120.0) -> List[str]:
        now = time.time()
        stale = []
        for w in self.workers():
            t = self.last_heartbeat(w)
            if t is None or now - t >= timeout_s:
                stale.append(w)
                try:
                    os.unlink(self._beat_path(w))
                except FileNotFoundError:
                    # benign race: another evictor removed the beat first
                    logger.debug("beat file for %s already removed", w)
        if stale:
            dead = set(stale)
            for j in self.jobs(status="claimed"):
                if j.worker_id not in dead:
                    continue
                # requeue under the claim lock with a status re-check: a
                # merely-slow worker may complete the job concurrently, and
                # its result must not be clobbered back to pending
                if not self._try_lock("claim-" + j.job_id):
                    continue
                try:
                    cur = self._read_job(j.job_id)
                    if (cur is not None and cur.status == "claimed"
                            and cur.worker_id in dead):
                        cur.status = "pending"
                        cur.worker_id = None
                        self._write_job(cur)
                finally:
                    self._unlock("claim-" + j.job_id)
        return stale

    def evict_worker(self, worker_id: str) -> bool:
        known = worker_id in self.workers()
        try:
            os.unlink(self._beat_path(worker_id))
        except FileNotFoundError:
            pass
        dead = {worker_id}
        for j in self.jobs(status="claimed"):
            if j.worker_id not in dead:
                continue
            # same claim-lock + status re-check as evict_stale: a
            # merely-slow worker may complete the job concurrently
            if not self._try_lock("claim-" + j.job_id):
                continue
            try:
                cur = self._read_job(j.job_id)
                if (cur is not None and cur.status == "claimed"
                        and cur.worker_id in dead):
                    cur.status = "pending"
                    cur.worker_id = None
                    self._write_job(cur)
            finally:
                self._unlock("claim-" + j.job_id)
        return known

    # -- meta --
    def put_meta(self, key: str, value: Any) -> None:
        self._atomic_write(os.path.join(self.root, "meta", key + ".json"),
                           json.dumps(value))

    def get_meta(self, key: str, default: Any = None) -> Any:
        try:
            with open(os.path.join(self.root, "meta", key + ".json")) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return default

    # -- worker updates (updates/ dir of .npy; staged in tmp/, published
    # with os.replace, consumed with os.rename — every transition atomic) --
    def _updates_dir(self) -> str:
        d = os.path.join(self.root, "updates")
        os.makedirs(d, exist_ok=True)
        return d

    def _save_array(self, target: str, value) -> None:
        import numpy as np

        def write():
            faults.fault_point("statetracker.write")
            atomic_write_bytes(target,
                               lambda f: np.save(f, np.asarray(value)),
                               tmp_dir=os.path.join(self.root, "tmp"))

        self.retry_policy.call(write)

    def post_update(self, worker_id: str, update) -> None:
        name = f"{worker_id}@{uuid.uuid4().hex[:8]}.npy"
        self._save_array(os.path.join(self._updates_dir(), name), update)

    def updates(self) -> Dict[str, Any]:
        import numpy as np

        out: Dict[str, Any] = {}
        for name in self.posted_update_keys():
            try:
                out[name] = np.load(
                    os.path.join(self._updates_dir(), name + ".npy"))
            except (OSError, ValueError) as e:
                # drained or torn under concurrency: skip, but say so
                logger.warning("skipping unreadable update %s: %s", name, e)
                continue
        return out

    def posted_update_keys(self) -> List[str]:
        return sorted(n[:-4] for n in os.listdir(self._updates_dir())
                      if n.endswith(".npy"))

    def drain_updates(self) -> Dict[str, Any]:
        import numpy as np

        out: Dict[str, Any] = {}
        for name in sorted(os.listdir(self._updates_dir())):
            if not name.endswith(".npy"):
                continue
            path = os.path.join(self._updates_dir(), name)
            # rename-to-take: a concurrent replace either lands before (we
            # take the new file) or after (it stays for the next drain)
            grave = os.path.join(self.root, "tmp",
                                 f"drain-{os.getpid()}-{uuid.uuid4().hex[:8]}")
            try:
                os.rename(path, grave)
            except FileNotFoundError:
                continue  # another drainer took it
            try:
                out[name[:-4]] = np.load(grave)
            except (OSError, ValueError) as e:
                # a torn/corrupt update is DROPPED here — make that visible
                logger.warning("dropping unreadable update %s: %s", name, e)
            finally:
                try:
                    os.unlink(grave)
                except FileNotFoundError:
                    logger.debug("drain grave %s already unlinked", grave)
        return out

    # -- binary array metadata --
    def put_array(self, key: str, value) -> None:
        d = os.path.join(self.root, "arrays")
        os.makedirs(d, exist_ok=True)
        self._save_array(os.path.join(d, key + ".npy"), value)

    def get_array(self, key: str, default: Any = None) -> Any:
        import numpy as np

        try:
            return np.load(os.path.join(self.root, "arrays", key + ".npy"))
        except (OSError, ValueError):
            return default
