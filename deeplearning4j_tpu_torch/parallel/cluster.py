"""Multi-host cluster runtime: launcher, liveness, checkpoint/resume.

Port of ``deeplearning4j_tpu/parallel/cluster.py``:

- ``initialize_distributed`` joins the ranks into one
  ``torch.distributed`` world at ``coordinator_address`` over TCP (a
  ``TCPStore`` that rank 0 hosts), with retry under ``RetryPolicy`` and
  the ``distributed.init`` fault point; one process is a no-op.
- ``HeartbeatMonitor``: a background liveness thread against a
  ``StateTracker`` (``parallel/statetracker.py``).
- ``FaultTolerantTrainer``: checkpoints every N iterations in the
  ModelSerializer zip both packages read, sha256 manifest sidecars,
  ``resume`` from the newest verified checkpoint (the tracker's
  ``latest_checkpoint`` pointer among the candidates), ``save_async``
  (the state copied to the host on the calling thread, the zip written on
  a background writer), ``fit`` under a step watchdog and the preemption
  guard, ``fit_epochs`` on the chunk driver's ``on_chunk``, and
  heartbeats when given a tracker. A JAX-written checkpoint resumes here
  (its weights, updater state and cursors; the port draws from its own
  generator, which the JAX zip does not carry, so its epoch orders start
  from the configuration's seed).

Over a mesh (a ``ParallelWrapper`` handed in, every rank running the
trainer with the same directory) the checkpoint holds the whole state:
every rank takes part in gathering it, the lead of the wrapper's mesh
(rank 0, unless the mesh leaves it parked) alone writes it, and the
ranks meet at a barrier before a save returns. ``resume(mesh=)`` places
the restored state on any mesh of the current world (replicated, or the
registry's tensor-parallel shards where it has a ``model`` axis), and
``resume(fsdp=True)`` keeps this rank's FSDP shards over ``data``
(through a ``ParallelWrapper`` over ``data × model``, composed with the
tensor-parallel shards).
"""

from __future__ import annotations

import concurrent.futures
import glob
import hashlib
import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.monitor import metrics, record_counter, tracer
from deeplearning4j_tpu_torch.parallel.statetracker import StateTracker
from deeplearning4j_tpu_torch.resilience import (
    RetryError,
    RetryPolicy,
    faults,
)
from deeplearning4j_tpu_torch.resilience.preemption import PreemptionGuard
from deeplearning4j_tpu_torch.resilience.watchdog import StepWatchdog
from deeplearning4j_tpu_torch.utils.fileio import atomic_write_text

logger = logging.getLogger(__name__)

DEFAULT_EVICTION_TIMEOUT_S = 120.0  # MasterActor parity


@dataclass
class ClusterConfig:
    """Multi-host topology (maps onto ``initialize_distributed``)."""

    coordinator_address: Optional[str] = None  # "host:port"
    num_processes: int = 1
    process_id: int = 0
    heartbeat_interval_s: float = 5.0
    eviction_timeout_s: float = DEFAULT_EVICTION_TIMEOUT_S


def default_backend(device=None, world_size: int = 1) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise (the
    CPU, or ranks sharing cards: gloo carries CUDA tensors too)."""
    import torch

    from deeplearning4j_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(config: ClusterConfig, retries: int = 3,
                           retry_delay_s: float = 5.0,
                           policy: Optional[RetryPolicy] = None, *,
                           device=None) -> bool:
    """Join the multi-process world; returns True when initialized.

    Single-process configs are a no-op (False). Rank
    ``config.process_id`` of ``config.num_processes`` meets the others at
    ``coordinator_address`` (``host:port``; rank 0 hosts the
    ``TCPStore``) over :func:`default_backend` for ``device`` (default:
    the card), with the mesh's collective timeout. On CUDA each rank then
    takes card ``process_id % device_count``. Failures retry under the
    shared :class:`RetryPolicy` (``retries``/``retry_delay_s`` seed the
    default one)."""
    if config.num_processes <= 1 or config.coordinator_address is None:
        return False
    import datetime

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    if policy is None:
        policy = RetryPolicy(max_attempts=retries,
                             base_delay_s=retry_delay_s,
                             max_delay_s=4 * retry_delay_s)
    dev = resolve_device(device)
    backend = default_backend(dev, config.num_processes)
    host, _, port = config.coordinator_address.rpartition(":")
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)

    def init():
        faults.fault_point("distributed.init")
        store = dist.TCPStore(host or "127.0.0.1", int(port),
                              config.num_processes,
                              is_master=config.process_id == 0,
                              timeout=timeout)
        dist.init_process_group(backend, store=store,
                                rank=config.process_id,
                                world_size=config.num_processes,
                                timeout=timeout)

    try:
        policy.call(init)
    except RetryError as e:
        raise RuntimeError(
            f"torch.distributed init failed after {e.attempts} attempts"
        ) from e.last
    if dev.type == "cuda":
        torch.cuda.set_device(config.process_id % torch.cuda.device_count())
    return True


class HeartbeatMonitor:
    """Posts worker heartbeats on a timer; the coordinator side calls
    ``evict()`` to drop silent workers and requeue their jobs.

    ``payload_fn`` (optional) is called before every beat and its dict
    rides along as the beat's compact metrics payload (step time,
    goodput, last-chunk loss — whatever the worker wants the master's
    fleet view to see). A failing ``payload_fn`` degrades to a
    payload-less beat — liveness must never depend on telemetry — and a
    tracker whose ``heartbeat`` predates the ``metrics=`` parameter
    gets the legacy payload-less call."""

    def __init__(self, tracker: StateTracker, worker_id: str,
                 interval_s: float = 5.0,
                 eviction_timeout_s: float = DEFAULT_EVICTION_TIMEOUT_S,
                 payload_fn: Optional[Callable[[], Optional[dict]]] = None):
        self.tracker = tracker
        self.worker_id = worker_id
        self.interval_s = interval_s
        self.eviction_timeout_s = eviction_timeout_s
        self.payload_fn = payload_fn
        self._supports_metrics: Optional[bool] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_config(cls, tracker: StateTracker, worker_id: str,
                    config: ClusterConfig) -> "HeartbeatMonitor":
        return cls(tracker, worker_id,
                   interval_s=config.heartbeat_interval_s,
                   eviction_timeout_s=config.eviction_timeout_s)

    def _post(self) -> None:
        # liveness must degrade, not crash: a transient tracker error
        # (shared-fs hiccup, injected fault) skips one beat and keeps the
        # thread alive — eviction only triggers after MANY missed beats
        payload = None
        if self.payload_fn is not None:
            try:
                payload = self.payload_fn()
            except Exception:  # noqa: BLE001 — telemetry never blocks liveness
                logger.debug("heartbeat payload_fn failed for %s; "
                             "posting payload-less beat", self.worker_id,
                             exc_info=True)
        try:
            if payload is None or not self._tracker_takes_metrics():
                self.tracker.heartbeat(self.worker_id)
            else:
                self.tracker.heartbeat(self.worker_id, metrics=payload)
        except Exception:  # noqa: BLE001
            logger.warning("heartbeat post failed for %s (will retry on "
                           "next interval)", self.worker_id, exc_info=True)

    def _tracker_takes_metrics(self) -> bool:
        # signature inspection, cached, instead of catching TypeError
        # from the live call: a TypeError the tracker itself raises
        # (e.g. a non-JSON-serializable payload value) must surface as
        # a warning, not be misread as "pre-payload implementation" and
        # silently demote every future beat to payload-less
        if self._supports_metrics is None:
            import inspect

            try:
                params = inspect.signature(
                    self.tracker.heartbeat).parameters.values()
                self._supports_metrics = any(
                    p.name == "metrics"
                    or p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params)
            except (TypeError, ValueError):  # uninspectable callable
                self._supports_metrics = True
        return self._supports_metrics

    def start(self) -> "HeartbeatMonitor":
        if self._thread is not None:
            if self._thread.is_alive():
                return self
            self._thread = None  # crashed/finished thread: allow restart
        # a FRESH event captured by THIS thread's closure — stop() of a
        # previous incarnation (possibly still draining its join timeout)
        # can then never stop the new thread, and vice versa
        stop = threading.Event()
        self._stop = stop
        self._post()

        def run():
            while not stop.wait(self.interval_s):
                self._post()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"heartbeat-{self.worker_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        thread, stop = self._thread, self._stop
        if thread is None:
            return  # idempotent: stop() after stop() is a no-op
        self._thread = None
        stop.set()
        thread.join(timeout=self.interval_s + 1.0)

    def __enter__(self) -> "HeartbeatMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def evict(self, timeout_s: Optional[float] = None) -> List[str]:
        return self.tracker.evict_stale(
            timeout_s if timeout_s is not None else self.eviction_timeout_s)



def _world_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _log_failed_save(fut: "concurrent.futures.Future") -> None:
    if fut.cancelled():
        return
    exc = fut.exception()
    if exc is not None:
        logger.warning("background checkpoint write failed: %s", exc,
                       exc_info=exc)


class FaultTolerantTrainer:
    """Checkpoint/resume training loop (elastic recovery).

    Wraps any network with ``fit(DataSet)`` + the ModelSerializer contract.
    Saves ``ckpt-<iteration>.zip`` every ``checkpoint_every`` iterations and
    retains the newest ``keep`` checkpoints. ``resume()`` restores the
    newest VERIFIED checkpoint (params + updater state + iteration counter)
    so a relaunched process continues where the dead one stopped — the
    replacement for Hazelcast state replication + actor restart.

    Integrity contract: every save publishes a ``.sha256`` manifest sidecar
    (hash + size + iteration, written atomically AFTER the zip). ``resume``
    walks checkpoints newest → oldest and restores the first one whose
    bytes match its manifest and whose archive loads — a truncated or
    corrupt newest checkpoint (crash mid-write, bit-rot on shared storage)
    falls back to the next-older one instead of crashing or silently
    loading garbage. A checkpoint without a sidecar (pre-manifest writer)
    is *unverified*: it is still attempted, but any load error falls
    through to older candidates.
    """

    def __init__(self, network, checkpoint_dir: str,
                 checkpoint_every: int = 10, keep: int = 3,
                 tracker: Optional[StateTracker] = None,
                 worker_id: str = "worker-0",
                 heartbeat_interval_s: float = 5.0,
                 step_deadline_s: Optional[float] = None,
                 on_stall: Optional[Callable[[float], None]] = None):
        self.tracker = tracker
        self.network = network
        # ``network`` may be a ParallelWrapper; serialization and cursor
        # bookkeeping always target the real model underneath, while
        # fit/fit_epochs go through the handle the caller gave us
        self.model = getattr(network, "network", network)
        self.dir = checkpoint_dir
        self.every = max(1, checkpoint_every)
        self.keep = max(1, keep)
        self.worker_id = worker_id
        self.heartbeat_interval_s = heartbeat_interval_s
        self.step_deadline_s = step_deadline_s
        self.on_stall = on_stall
        self.preempted = False  # last fit/fit_epochs stopped on preemption
        self._save_executor: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self._pending_save: Optional[concurrent.futures.Future] = None
        os.makedirs(checkpoint_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def _ckpt_path(self, iteration: int) -> str:
        return os.path.join(self.dir, f"ckpt-{iteration:012d}.zip")

    @staticmethod
    def _manifest_path(ckpt_path: str) -> str:
        return ckpt_path + ".sha256"

    def checkpoints(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.dir, "ckpt-*.zip")))

    def latest_checkpoint(self) -> Optional[str]:
        cks = self.checkpoints()
        return cks[-1] if cks else None

    # -- integrity -----------------------------------------------------
    @staticmethod
    def _sha256(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    def _write_manifest(self, path: str, iteration: int) -> None:
        manifest = {
            "sha256": self._sha256(path),
            "size": os.path.getsize(path),
            "iteration": iteration,
            "format": "dl4j-tpu-ckpt-manifest-v1",
        }
        atomic_write_text(self._manifest_path(path), json.dumps(manifest))

    def verify_checkpoint(self, path: str) -> str:
        """``"ok"`` (manifest matches), ``"unverified"`` (no manifest —
        legacy writer), or ``"corrupt"`` (size/hash mismatch, i.e. a
        partial write or bit-rot)."""
        with tracer().span("checkpoint.verify",
                           path=os.path.basename(path)) as sp:
            sp.attrs["verdict"] = verdict = self._verify_impl(path)
        return verdict

    def _verify_impl(self, path: str) -> str:
        try:
            with open(self._manifest_path(path)) as f:
                manifest = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return "unverified"
        try:
            if os.path.getsize(path) != manifest.get("size"):
                return "corrupt"
            if self._sha256(path) != manifest.get("sha256"):
                return "corrupt"
        except OSError:
            return "corrupt"
        return "ok"

    # -- save / resume -------------------------------------------------
    def _write_checkpoint(self, model, path: str) -> str:
        """Serialize ``model`` (live network or host snapshot) to
        ``path`` with the full integrity ritual: tmp + rename, manifest
        sidecar, prune. Runs on the caller's thread for
        ``save`` and on the writer thread for ``save_async``. Write
        latency lands in the ``checkpoint_write_seconds`` histogram and a
        ``checkpoint.write`` span — the signal that tells a slow shared
        filesystem apart from a wedged chunk."""
        from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

        # background=True marks writes on the save_async writer thread:
        # they overlap compute, so the run ledger books them as hidden
        # rather than checkpoint badput
        with tracer().span("checkpoint.write",
                           path=os.path.basename(path),
                           iteration=model.iteration_count,
                           background=threading.current_thread().name
                           .startswith("ckpt-writer")) as sp:
            tmp = path + ".tmp"
            ModelSerializer.write_model(model, tmp, save_updater=True)
            os.replace(tmp, path)
            self._write_manifest(path, model.iteration_count)
            for old in self.checkpoints()[:-self.keep]:
                os.unlink(old)
                try:
                    os.unlink(self._manifest_path(old))
                except FileNotFoundError:
                    pass  # legacy checkpoint without a sidecar
            if self.tracker is not None:
                # the replicated pointer: found after a restart elsewhere
                self.tracker.put_meta("latest_checkpoint", path)
        metrics().histogram(
            "checkpoint_write_seconds",
            "zip + sha256 manifest + prune wall time").observe(
            sp.duration_s)
        record_counter("checkpoint_saves_total")
        return path

    def _over_mesh(self) -> bool:
        """Whether the handle trains over a world of several ranks (a
        ``ParallelWrapper``): saves then gather and its mesh's lead
        writes (:meth:`_writer`)."""
        from deeplearning4j_tpu_torch.parallel.mesh import world_size

        return hasattr(self.network, "gather") and world_size() > 1

    def _writer(self) -> bool:
        """Whether this rank writes a checkpoint over a mesh: the lead of
        the wrapper's current mesh, which holds the run's state even when
        rank 0 is parked outside it."""
        return _world_rank() == getattr(self.network, "_lead", 0)

    def save(self) -> str:
        faults.fault_point("checkpoint.save")
        self.wait_for_saves()  # never interleave with an async write
        path = self._ckpt_path(self.model.iteration_count)
        if not self._over_mesh():
            return self._write_checkpoint(self.model, path)
        snap = self._snapshot_model()  # every rank gathers
        if self._writer():
            self._write_checkpoint(snap, path)
        _barrier()
        return path

    # -- async save ----------------------------------------------------
    def _snapshot_model(self):
        """A frozen host copy of the model for the background writer: the
        same class (so ModelSerializer writes it alike), its state trees
        copied to CPU tensors once on the calling thread (waiting only for
        the chunk that produced them, never for the write), the
        generator's state and the training cursors. The live network may
        run the next chunk as soon as this returns. Models without this
        surface (TransformerLM) give None, and ``save_async`` writes
        synchronously."""
        import torch

        from deeplearning4j_tpu_torch.dtypes import tree_map

        net = self.model
        if not hasattr(net, "conf") or not hasattr(net, "updater_state"):
            return None
        host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        # over a mesh the whole trees, gathered from every rank's parts
        params, upd = (self.network.gather()
                       if hasattr(self.network, "gather")
                       else (net.params, net.updater_state))
        snap = object.__new__(type(net))
        snap.conf = net.conf
        snap.device = torch.device("cpu")
        snap.params = tree_map(host, params)
        snap.updater_state = tree_map(host, upd)
        snap.net_state = tree_map(host, net.net_state)
        snap.iteration_count = net.iteration_count
        snap._initialized = True
        gen = getattr(net, "_rng", None)
        if isinstance(gen, torch.Generator):
            snap._rng = torch.Generator(device=gen.device)
            snap._rng.set_state(gen.get_state())
        snap._lr_scale_host = getattr(net, "_lr_scale_host", 1.0)
        snap._epoch_cursor = getattr(net, "_epoch_cursor", 0)
        snap._step_cursor = getattr(net, "_step_cursor", 0)
        return snap

    def save_async(self) -> "concurrent.futures.Future":
        """``save()`` split at the device/host boundary: the device-to-host
        copy happens now (so the bytes are immutable), the zip + manifest
        write happens on a single background writer thread — the next
        chunk dispatches while the previous checkpoint serializes.
        Returns the Future of the checkpoint path; ``wait_for_saves``
        joins it. Writes are serialized on one thread, so a slow disk
        backs saves up instead of corrupting them."""
        faults.fault_point("checkpoint.save")
        # the snapshot is the only part the host BLOCKS on — its span is
        # the "how long did save_async stall training" answer
        with tracer().span("checkpoint.snapshot") as sp:
            snap = self._snapshot_model()
        metrics().histogram(
            "checkpoint_snapshot_seconds",
            "device-to-host state copy (the blocking part of save_async)"
        ).observe(sp.duration_s)
        if self._over_mesh() and not self._writer():
            # the lead writes the checkpoint; the others only gathered
            fut = concurrent.futures.Future()
            fut.set_result(self._ckpt_path(snap.iteration_count))
            return fut
        if snap is None:  # model type without the snapshot surface
            fut: concurrent.futures.Future = concurrent.futures.Future()
            try:
                fut.set_result(self._write_checkpoint(
                    self.model, self._ckpt_path(self.model.iteration_count)))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
            return fut
        if self._save_executor is None:
            self._save_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        fut = self._save_executor.submit(
            self._write_checkpoint, snap,
            self._ckpt_path(snap.iteration_count))
        # a failed background write must never vanish just because a
        # newer save superseded it before anyone joined the future
        fut.add_done_callback(_log_failed_save)
        self._pending_save = fut
        return fut

    def wait_for_saves(self, timeout: Optional[float] = None):
        """Block until the in-flight async checkpoint (if any) is on
        disk; re-raises a failed write. Returns its path or None. Also
        retires the (non-daemon) writer thread so an idle trainer never
        delays interpreter shutdown; the next ``save_async`` spins a
        fresh one."""
        fut, self._pending_save = self._pending_save, None
        if fut is None:
            return None
        try:
            return fut.result(timeout=timeout)
        finally:
            ex, self._save_executor = self._save_executor, None
            if ex is not None:
                ex.shutdown(wait=False)

    def _resume_candidates(self) -> List[str]:
        """Newest → oldest, with the tracker's replicated pointer appended
        as a last resort (it may point outside ``self.dir`` after a
        restart on another host)."""
        cands = list(reversed(self.checkpoints()))
        if self.tracker is not None:
            meta = self.tracker.get_meta("latest_checkpoint")
            if meta and meta not in cands:
                cands.append(meta)
        return cands

    def resume(self, mesh=None, fsdp: bool = False) -> bool:
        """Restore the newest checkpoint that passes integrity
        verification and loads; older checkpoints are fallbacks. Returns
        True when one was restored, False when none exists (a directory
        of corrupt checkpoints only raises: silently starting from
        scratch when state was expected is the one thing recovery must
        not do).

        Beyond the weights, resume restores the training state a
        preemption-safe checkpoint carries: the network generator's state
        (so every later epoch order and dropout draw continues the dead
        run's stream), the host LR scale and the epoch and step cursors
        ``fit``/``fit_epochs`` use to skip work already done. The zip is
        restored on the network's device.

        Elastic re-sharding: the checkpoint holds whole tensors, so it
        restores onto any mesh of the current world. ``mesh=`` places the
        restored state on it (replicated, or the registry's
        tensor-parallel shards where the mesh has a ``model`` axis);
        ``fsdp=True`` keeps this rank's FSDP shards over ``data``. A
        ``ParallelWrapper`` handle adopts the mesh (its own when none is
        given), so its next ``fit_epochs`` runs there; over a ``model``
        axis with ``fsdp=True`` it composes the two (the split leaves on
        ``model``, the rest over ``data``). Every rank of the
        world calls ``resume`` with the same arguments."""
        with tracer().span("checkpoint.resume") as resume_span:
            return self._resume_impl(mesh, fsdp, resume_span)

    def _resume_impl(self, mesh, fsdp: bool, resume_span) -> bool:
        from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

        candidates = self._resume_candidates()
        saw_corrupt = []
        for path in candidates:
            faults.fault_point("checkpoint.restore")
            if not os.path.exists(path):
                continue
            verdict = self.verify_checkpoint(path)
            if verdict == "corrupt":
                logger.warning(
                    "checkpoint %s failed integrity verification; falling "
                    "back to an older checkpoint", path)
                saw_corrupt.append(path)
                continue
            try:
                restored = ModelSerializer.restore(
                    path, load_updater=True,
                    device=getattr(self.model, "device", None))
            except Exception as e:  # noqa: BLE001 — any load error ⇒ next
                logger.warning(
                    "checkpoint %s (%s) failed to load (%s); falling back "
                    "to an older checkpoint", path, verdict, e)
                saw_corrupt.append(path)
                continue
            net = self.model
            net.params = restored.params
            net.updater_state = restored.updater_state
            net.net_state = restored.net_state
            net.iteration_count = restored.iteration_count
            for attr in ("_lr_scale_host", "_epoch_cursor", "_step_cursor"):
                if hasattr(restored, attr):
                    setattr(net, attr, getattr(restored, attr))
            # the generator's state, into the network's own generator: a
            # captured step holds that object
            net._rng.set_state(restored._rng.get_state())
            self._reshard(mesh, fsdp)
            if saw_corrupt:
                logger.warning("resumed from fallback %s (skipped %d bad "
                               "checkpoint(s))", path, len(saw_corrupt))
            resume_span.attrs.update(restored=os.path.basename(path),
                                     skipped=len(saw_corrupt))
            record_counter("checkpoint_resumes_total", outcome="restored")
            return True
        resume_span.attrs["skipped"] = len(saw_corrupt)
        if saw_corrupt:
            raise RuntimeError(
                f"all {len(saw_corrupt)} checkpoint(s) under {self.dir} "
                f"are corrupt or unloadable; refusing to silently restart "
                f"from scratch (newest: {saw_corrupt[0]})")
        return False

    def _reshard(self, mesh, fsdp: bool) -> None:
        """Place the restored whole state: on the wrapper's (or the
        given) mesh through the wrapper, else on ``mesh`` through the
        registry, or FSDP-sharded over its ``data`` axis."""
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            unshard_network_params)

        net = self.model
        if mesh is None and not hasattr(self.network, "gather"):
            return
        unshard_network_params(net)  # the restored trees are whole
        if hasattr(self.network, "gather"):
            wrapper = self.network
            wrapper.fsdp = wrapper.fsdp or fsdp
            wrapper._set_mesh(wrapper.mesh if mesh is None else mesh)
        elif fsdp:
            from deeplearning4j_tpu_torch.parallel.fsdp import shard_tree

            net.params = shard_tree(net.params, mesh)
            net.updater_state = shard_tree(net.updater_state, mesh)
        else:
            net._place_on_mesh(mesh)

    def _heartbeats(self):
        """A started :class:`HeartbeatMonitor` for this worker when the
        trainer has a tracker, else None."""
        if self.tracker is None:
            return None
        return HeartbeatMonitor(self.tracker, self.worker_id,
                                interval_s=self.heartbeat_interval_s
                                ).start()

    # ------------------------------------------------------------------
    def fit(self, data, num_epochs: int = 1,
            on_iteration: Optional[Callable[[int], None]] = None,
            preemption: Optional[PreemptionGuard] = None):
        """Epoch loop with periodic checkpointing + heartbeats. With
        ``step_deadline_s`` set, a :class:`StepWatchdog` flags steps that
        hang past the deadline (``on_stall`` picks the policy: log /
        evict / abort — default logs).

        Preemption + mid-epoch resume: pass (or default-construct via
        ``preemption=PreemptionGuard()``) a guard and the loop polls it
        per batch — on request it checkpoints synchronously and returns
        with ``self.preempted = True``. Every checkpoint records the
        STEP cursor (batches consumed in the in-progress epoch), and a
        resumed run skips exactly that many leading batches instead of
        restarting the epoch — with a deterministic iterator order this
        continues the epoch where the dead process stopped."""
        net = self.network
        model = self.model
        self.preempted = False
        watchdog = None
        monitor = self._heartbeats()
        if self.step_deadline_s is not None:
            watchdog = StepWatchdog(self.step_deadline_s,
                                    on_stall=self.on_stall).start()
        # a checkpoint taken mid-epoch stored how many batches of the
        # in-progress epoch were already consumed; skip exactly those
        skip = int(getattr(model, "_step_cursor", 0) or 0)
        try:
            if preemption is not None:
                preemption.install()
            for _ in range(num_epochs):
                if hasattr(data, "reset"):
                    data.reset()
                batches = [data] if not hasattr(data, "__iter__") else data
                for step_idx, ds in enumerate(batches):
                    if skip:
                        skip -= 1
                        continue
                    net.fit(ds)
                    model._step_cursor = step_idx + 1
                    if watchdog is not None:
                        watchdog.beat()
                    if model.iteration_count % self.every == 0:
                        self.save()
                    if on_iteration is not None:
                        on_iteration(model.iteration_count)
                    if preemption is not None and preemption.check():
                        self.save()
                        self.preempted = True
                        return self
                model._step_cursor = 0
            self.save()
        finally:
            if preemption is not None:
                preemption.uninstall()
            if watchdog is not None:
                watchdog.stop()
            if monitor is not None:
                monitor.stop()
        return self

    def fit_epochs(self, data, num_epochs: int, *,
                   chunk_epochs: Optional[int] = 1,
                   save_every_chunks: int = 1,
                   preemption: Optional[PreemptionGuard] = None,
                   **fit_kw):
        """Preemption-safe fused training: ``network.fit_epochs`` with a
        chunk-boundary hook that (a) checkpoints asynchronously every
        ``save_every_chunks`` chunks — device->host copy now, zip write
        on the background writer, the next chunk dispatching immediately
        — and (b) polls the :class:`PreemptionGuard` (SIGTERM or an
        injected ``preempt.chunk`` fault): on request it takes one final
        SYNCHRONOUS verified checkpoint and stops cleanly with
        ``self.preempted = True``.

        The resume contract is bitwise: the checkpoint carries the
        network generator's state and the epoch cursor, and each epoch's
        order and each step's draws come from that generator in turn, so
        ``resume()`` followed by the same ``fit_epochs`` call trains the
        remaining epochs on exactly the stream the uninterrupted run
        would have used, landing on identical final params. Returns the loss
        history of the epochs run in THIS process (None if none
        remained)."""
        net = self.network
        model = self.model
        self.preempted = False
        guard = preemption or PreemptionGuard()
        start = int(getattr(model, "_epoch_cursor", 0) or 0)
        if start >= num_epochs:
            logger.info("fit_epochs: checkpoint cursor already at epoch "
                        "%d of %d — nothing to do", start, num_epochs)
            return None
        model._epoch_cursor = start
        model._step_cursor = 0
        chunks = {"n": 0}

        def on_chunk(done: int) -> bool:
            # the trainer owns the ABSOLUTE cursor (done is relative to
            # this process's run); chunk boundaries are epoch-aligned
            model._epoch_cursor = start + done
            model._step_cursor = 0
            chunks["n"] += 1
            if guard.check():
                # final checkpoint must be ON DISK and verified before
                # we report a clean stop — synchronous by design
                self.save()
                self.preempted = True
                return True
            if chunks["n"] % max(1, save_every_chunks) == 0:
                self.save_async()
            return False

        monitor = self._heartbeats()
        try:
            with guard:
                hist = net.fit_epochs(data, num_epochs - start,
                                      chunk_epochs=chunk_epochs,
                                      on_chunk=on_chunk, **fit_kw)
                self.wait_for_saves()
                if not self.preempted:
                    # fallback paths (streaming / per-step) never fire
                    # on_chunk; a completed run is complete either way
                    model._epoch_cursor = num_epochs
                    self.save()
                    # the CHECKPOINT keeps cursor=num_epochs so a crash-
                    # restart loop that re-runs this job is idempotent
                    # (resume -> nothing left -> no retraining); the LIVE
                    # model resets so another interactive fit_epochs call
                    # trains again instead of silently no-oping
                    model._epoch_cursor = 0
        finally:
            if monitor is not None:
                monitor.stop()
        return hist
