"""Iteration listeners — the observability bus around the training loop.

Port of ``deeplearning4j_tpu/optimize/listeners.py``: the same listeners
and the same ``iteration_done``/``chunk_done`` protocol, with the device
profiler on ``torch.profiler`` and the checkpoints in the port's own
layout (``utils/checkpoint.py``).

Mirror of optimize/api/IterationListener.java + listeners/
ScoreIterationListener.java (score log every N iters) and
ParamAndGradientIterationListener.java (per-param stats to file). Listeners
fire host-side after each step; anything they read (score, param norms)
waits for the device, so heavyweight listeners should run at a stride.

Fused-path protocol: the whole-epoch pipeline runs k epochs x N steps as
ONE dispatch, so per-step ``iteration_done`` firings do not exist there.
Instead the chunk driver calls ``chunk_done(model, iteration0, losses,
metrics=)`` once per chunk with the chunk's DEVICE loss history (``[k,
N]``) and, when telemetry is on, the ``[k, N, 4]`` metrics-pack history —
``iteration0`` is the global iteration count BEFORE the chunk, so
listeners reconstruct exact per-step iteration numbers across chunks and
across preemption/resume. The base-class default keeps the legacy
behavior (one ``iteration_done`` at the chunk's final count); listeners
that want per-step granularity override it and pay ONE host sync per
chunk for the whole history instead of E*N per-step ``score_value``
syncs.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import numpy as np

log = logging.getLogger("deeplearning4j_tpu_torch")


def _host_flat(losses) -> np.ndarray:
    """A chunk's loss history (a tensor on any device, or an array) as a
    flat float64 host array: the one sync per chunk."""
    if hasattr(losses, "detach"):
        losses = losses.detach().cpu().numpy()
    return np.asarray(losses, np.float64).reshape(-1)


class IterationListener:
    def iteration_done(self, model, iteration: int) -> None:
        raise NotImplementedError

    def chunk_done(self, model, iteration0: int, losses,
                   metrics=None) -> None:
        """A fused epoch chunk finished: ``losses`` is the chunk's
        ``[k, N]`` loss history (a device tensor — converting it syncs),
        ``iteration0`` the global iteration count before the chunk,
        ``metrics`` the optional ``[k, N, 4]`` metrics-pack history.
        Default: the legacy once-per-chunk ``iteration_done`` firing."""
        self.iteration_done(model, model.iteration_count)


class ScoreIterationListener(IterationListener):
    """Logs score every ``print_iterations`` (ScoreIterationListener.java).

    On the fused path ``chunk_done`` replays the chunk's loss history at
    the same stride with exact global iteration numbers — one device sync
    per chunk, not per step, and no dependence on ``model.score_value``
    (which only holds the chunk's LAST loss)."""

    def __init__(self, print_iterations: int = 10, printer: Optional[Callable] = None):
        self.print_iterations = max(1, int(print_iterations))
        self.printer = printer or (lambda msg: log.info(msg))

    def iteration_done(self, model, iteration):
        if iteration % self.print_iterations == 0:
            self.printer(f"Score at iteration {iteration} is {model.score_value}")

    def chunk_done(self, model, iteration0, losses, metrics=None):
        flat = _host_flat(losses)  # the one sync per chunk
        for j, loss in enumerate(flat):
            it = iteration0 + j + 1
            if it % self.print_iterations == 0:
                self.printer(f"Score at iteration {it} is {float(loss)}")


class ComposableIterationListener(IterationListener):
    def __init__(self, *listeners: IterationListener):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration):
        for l in self.listeners:
            l.iteration_done(model, iteration)

    def chunk_done(self, model, iteration0, losses, metrics=None):
        for l in self.listeners:
            cb = getattr(l, "chunk_done", None)
            if cb is not None:
                cb(model, iteration0, losses, metrics=metrics)
            else:
                l.iteration_done(model, model.iteration_count)


class CheckpointIterationListener(IterationListener):
    """Periodic checkpoints from inside any training loop.

    At least every ``frequency`` iterations, writes the model's full
    training state (params, updater state, net state, iteration) as a
    checkpoint keyed by iteration in the port's layout
    (``utils/checkpoint.py``); ``utils.checkpoint.restore_network``
    resumes it. ``keep`` bounds the retained checkpoints.

    Saves fire on the ``iteration - last_saved >= frequency`` stride
    (never an exact modulo: fused drivers like ``fit_steps`` jump the
    iteration count by K per firing). The port writes synchronously;
    ``close()`` is kept for the reference's API."""

    def __init__(self, directory: str, frequency: int = 100, keep: int = 3):
        self.directory = directory
        self.frequency = max(1, int(frequency))
        self.keep = keep
        self._last_saved = 0
        self._ckpt = None

    def iteration_done(self, model, iteration):
        if iteration - self._last_saved >= self.frequency:
            if self._ckpt is None:
                from deeplearning4j_tpu_torch.utils.checkpoint import (
                    NetworkCheckpointer)

                self._ckpt = NetworkCheckpointer(self.directory,
                                                 keep=self.keep)
            self._ckpt.save(model, step=iteration)
            self._last_saved = iteration

    def close(self) -> None:
        """Release the checkpointer (also runs on GC)."""
        if self._ckpt is not None:
            self._ckpt.close()
            self._ckpt = None

    def __del__(self):  # best-effort drain
        try:
            self.close()
        except Exception:
            pass


class ParamAndGradientIterationListener(IterationListener):
    """Per-parameter statistics appended to a TSV file
    (ParamAndGradientIterationListener.java, 231 LoC)."""

    def __init__(self, path: str, iterations: int = 1):
        self.path = path
        self.iterations = max(1, iterations)
        self._wrote_header = False

    def iteration_done(self, model, iteration):
        if iteration % self.iterations:
            return
        table = model.get_param_table()
        with open(self.path, "a") as f:
            if not self._wrote_header:
                f.write("iteration\tscore\tparam\tmean\tstd\tl2\n")
                self._wrote_header = True
            for name, arr in table.items():
                arr = np.asarray(arr, np.float64)
                f.write(
                    f"{iteration}\t{model.score_value}\t{name}\t"
                    f"{arr.mean():.6e}\t{arr.std():.6e}\t"
                    f"{np.linalg.norm(arr.ravel()):.6e}\n"
                )


class TimeIterationListener(IterationListener):
    """Steady-state steps/sec tracker (used by bench + perf tests)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.start_time: Optional[float] = None
        self.count = 0

    def iteration_done(self, model, iteration):
        self.count += 1
        if self.count == self.warmup:
            self.start_time = time.perf_counter()

    def chunk_done(self, model, iteration0, losses, metrics=None):
        # shape-only accounting: a [k, N] history is k*N steps and the
        # shape is known without a device sync. The first chunk is the
        # warm-up boundary (it carries the CUDA-graph capture).
        shape = getattr(losses, "shape", None) or ()
        n = int(np.prod(shape)) if shape else 1
        if self.start_time is None:
            self.start_time = time.perf_counter()
            self.count = self.warmup
        else:
            self.count += n

    def steps_per_second(self) -> float:
        if self.start_time is None or self.count <= self.warmup:
            return 0.0
        return (self.count - self.warmup) / (time.perf_counter() - self.start_time)


class ProfilerIterationListener(IterationListener):
    """``torch.profiler`` around a window of training iterations.

    The reference had no in-tree profiler (SURVEY §5); the JAX package
    traces with ``jax.profiler``. This one records the host and the
    card (CUDA activity when the network runs there) and writes a Chrome
    trace, ``trace.json``, under ``log_dir`` when the window closes. The
    trace starts after iteration ``start_iteration`` completes and stops
    after the first iteration ≥ ``end_iteration`` (so iterations
    (start, end] are captured). Call ``close()`` — or rely on the
    finalizer — if training may end mid-window. Degrades to a no-op if
    the profiler cannot start.
    """

    def __init__(self, log_dir: str, start_iteration: int = 2,
                 end_iteration: int = 5):
        if end_iteration <= start_iteration:
            raise ValueError("end_iteration must exceed start_iteration")
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.end_iteration = end_iteration
        self.active = False
        self.failed = False
        self._prof = None

    def _start(self, model) -> None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if getattr(getattr(model, "device", None), "type", "cpu") == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self.active = True

    def _stop(self) -> None:
        import os

        import torch

        prof, self._prof, self.active = self._prof, None, False
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))

    def iteration_done(self, model, iteration):
        if self.failed:
            return
        try:
            # >= comparisons: fused drivers (fit_steps) may jump the
            # iteration count past either boundary in one firing
            if (not self.active
                    and self.start_iteration <= iteration < self.end_iteration):
                self._start(model)
            elif self.active and iteration >= self.end_iteration:
                self._stop()
        except Exception as e:  # profiler unavailable: disable
            log.warning("profiler listener disabled: %s", e)
            self.failed = True
            self.active = False
            self._prof = None

    def close(self) -> None:
        """Stop and write a still-open trace (training ended mid-window)."""
        if not self.active:
            return
        try:
            self._stop()
        except Exception as e:
            log.warning("profiler stop failed: %s", e)
        self.active = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class CollectScoresIterationListener(IterationListener):
    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_value))

    def chunk_done(self, model, iteration0, losses, metrics=None):
        # per-step scores from the chunk history — previously the fused
        # path could only append the chunk's last loss
        flat = _host_flat(losses)
        for j, loss in enumerate(flat):
            it = iteration0 + j + 1
            if it % self.frequency == 0:
                self.scores.append((it, float(loss)))
