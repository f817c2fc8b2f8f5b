"""Checkpoint/resume training: ``FaultTolerantTrainer``.

Port of the trainer half of ``deeplearning4j_tpu/parallel/cluster.py``
(``_log_failed_save`` and ``FaultTolerantTrainer``): checkpoints every N
iterations in the ModelSerializer zip both packages read, sha256
manifest sidecars, ``resume`` from the newest verified checkpoint,
``save_async`` (the state copied to the host on the calling thread, the
zip written on a background writer), ``fit`` under a step watchdog and
the preemption guard, and ``fit_epochs`` on the chunk driver's
``on_chunk``. A JAX-written checkpoint resumes here (its weights,
updater state and cursors; the port draws from its own generator, which
the JAX zip does not carry, so its epoch orders start from the
configuration's seed).

The multi-host runtime of that module (``ClusterConfig``,
``initialize_distributed``, ``HeartbeatMonitor``) and the trainer's
``tracker=``, ``resume(mesh=)`` and ``resume(fsdp=True)`` are ROADMAP A14.3;
they raise naming it.
"""

from __future__ import annotations

import concurrent.futures
import glob
import hashlib
import json
import logging
import os
import threading
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.monitor import metrics, record_counter, tracer
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.preemption import PreemptionGuard
from deeplearning4j_tpu_torch.resilience.watchdog import StepWatchdog
from deeplearning4j_tpu_torch.utils.fileio import atomic_write_text

logger = logging.getLogger(__name__)


def cluster_not_ported(what: str) -> NotImplementedError:
    """The error of the multi-host runtime's parts."""
    return NotImplementedError(
        f"{what} (the multi-host runtime) is not ported yet (ROADMAP A14.3)")


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
                 tracker=None,
                 worker_id: str = "worker-0",
                 heartbeat_interval_s: float = 5.0,
                 step_deadline_s: Optional[float] = None,
                 on_stall: Optional[Callable[[float], None]] = None):
        if tracker is not None:
            raise cluster_not_ported("FaultTolerantTrainer(tracker=)")
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
        metrics().histogram(
            "checkpoint_write_seconds",
            "zip + sha256 manifest + prune wall time").observe(
            sp.duration_s)
        record_counter("checkpoint_saves_total")
        return path

    def save(self) -> str:
        faults.fault_point("checkpoint.save")
        self.wait_for_saves()  # never interleave with an async write
        return self._write_checkpoint(
            self.model, self._ckpt_path(self.model.iteration_count))

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
        snap = object.__new__(type(net))
        snap.conf = net.conf
        snap.device = torch.device("cpu")
        snap.params = tree_map(host, net.params)
        snap.updater_state = tree_map(host, net.updater_state)
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
        """Newest → oldest. (The reference appends the state tracker's
        replicated pointer; the tracker is A14.3.)"""
        return list(reversed(self.checkpoints()))

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
        restored on the network's device. ``mesh=`` and ``fsdp=True``
        (re-laying the state out over a device mesh) are ROADMAP A14.3."""
        if mesh is not None or fsdp:
            raise cluster_not_ported("resume(mesh=, fsdp=)")
        with tracer().span("checkpoint.resume") as resume_span:
            return self._resume_impl(resume_span)

    def _resume_impl(self, resume_span) -> bool:
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
        return hist
