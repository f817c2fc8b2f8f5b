"""Training listeners that feed the UI server.

Port of ``deeplearning4j_tpu/ui/listeners.py``, the equivalents of the
reference's client-side UI listeners:
``ui/weights/HistogramIterationListener.java`` (POSTs a
``ModelAndGradient`` JSON snapshot to ``/weights/update?sid=`` each
iteration), ``ui/weights/ConvolutionalIterationListener.java`` (tiles
conv activations into a PNG) and ``ui/flow/FlowIterationListener.java``
(the live architecture flowchart).

Reading params or the score waits for the card, so every listener runs at
a stride (``frequency``); the "gradient" panel reports the applied
parameter update ``Δθ`` between firings rather than re-running backprop on
the host, which keeps the captured train step untouched. The fused driver
calls ``chunk_done`` once per chunk with the chunk's device loss history.

Listeners talk to an in-process ``UiServer`` directly (no HTTP) or to a
remote one over HTTP; the wire format is the reference's, so a listener of
either package can post to the server of the other.
"""

from __future__ import annotations

import base64
import json
import struct
import urllib.request
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

HIST_BINS = 30


class RemoteUiConnection:
    """POSTs JSON payloads to a UI server URL (the Jersey-client role in
    HistogramIterationListener.java:35-51)."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def post(self, route: str, payload: Any, sid: str) -> None:
        req = urllib.request.Request(
            f"{self.base_url}{route}?sid={sid}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            resp.read()


class _UiListener(IterationListener):
    """Shared plumbing: accept a UiServer instance or a URL."""

    def __init__(self, server=None, url: Optional[str] = None,
                 session_id: str = "default", frequency: int = 1):
        if server is None and url is None:
            from deeplearning4j_tpu_torch.ui.server import UiServer

            server = UiServer.get_instance()
        self._server = server
        self._conn = RemoteUiConnection(url) if url else None
        self.session_id = session_id
        self.frequency = max(1, int(frequency))

    def _post(self, kind_route: str, kind: str, payload: Any) -> None:
        payload = _json_sanitize(payload)
        if self._conn is not None:
            self._conn.post(kind_route, payload, self.session_id)
        else:
            self._server.post_update(kind, payload, sid=self.session_id)


def _json_sanitize(obj):
    """Non-finite floats → None: a diverged loss or an off-stride NaN
    metrics row must not make ``json.dumps`` emit the non-standard
    ``NaN`` token that strict UI-side parsers reject."""
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sanitize(v) for v in obj]
    return obj


def _to_host(a, dtype=None) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu")
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a, dtype)


def _array_stats(arr: np.ndarray) -> Dict[str, Any]:
    arr = _to_host(arr, np.float64).ravel()
    counts, edges = np.histogram(arr, bins=HIST_BINS)
    return {
        "mean": float(arr.mean()),
        "std": float(arr.std()),
        "min": float(arr.min()),
        "max": float(arr.max()),
        "l2": float(np.linalg.norm(arr)),
        "histogram": {"counts": counts.tolist(),
                      "edges": [float(edges[0]), float(edges[-1])]},
    }


class HistogramIterationListener(_UiListener):
    """Param/update histograms + score → /weights/update
    (HistogramIterationListener.java).

    Fused path: ``chunk_done`` posts ONE update per chunk carrying the
    chunk's per-step loss curve (and, when telemetry is on, the in-
    program metrics-pack series — grad/update/param norms + lr scale),
    so the UI score panel shows every fused step without per-step device
    syncs."""

    MAX_CURVE_POINTS = 512  # payload bound: long chunks downsample

    def __init__(self, frequency: int = 1, **kw):
        super().__init__(frequency=frequency, **kw)
        self._prev_table: Optional[Dict[str, np.ndarray]] = None

    def _payload(self, model, iteration: int) -> Dict[str, Any]:
        table = {k: _to_host(v) for k, v in model.get_param_table().items()}
        payload: Dict[str, Any] = {
            "iteration": iteration,
            "score": float(model.score_value),
            "parameters": {k: _array_stats(v) for k, v in table.items()},
        }
        if self._prev_table is not None:
            updates = {
                k: _array_stats(v - self._prev_table[k])
                for k, v in table.items() if k in self._prev_table
            }
            payload["gradients"] = updates  # applied update Δθ (see module doc)
        self._prev_table = table
        return payload

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency:
            return
        self._post("/weights/update", "weights",
                   self._payload(model, iteration))

    def chunk_done(self, model, iteration0, losses, metrics=None) -> None:
        # honor the stride like iteration_done: post only when the chunk
        # window (iteration0, iteration0 + k*N] crosses a multiple of
        # frequency. The gate reads only the SHAPE — an off-stride chunk
        # must cost neither the loss-history readback nor the
        # get_param_table() device→host sync
        shape = getattr(losses, "shape", None) or ()
        n = int(np.prod(shape)) if shape else 1
        next_due = iteration0 + self.frequency - iteration0 % self.frequency
        if next_due > iteration0 + n:
            return
        flat = _to_host(losses, np.float64).reshape(-1)
        payload = self._payload(model, model.iteration_count)
        its, vals = _downsample(iteration0 + 1, flat,
                                self.MAX_CURVE_POINTS)
        payload["loss_history"] = {"iterations": its, "losses": vals}
        if metrics is not None:
            from deeplearning4j_tpu_torch.monitor.pack import METRIC_NAMES

            m = _to_host(metrics, np.float64).reshape(
                -1, len(METRIC_NAMES))
            series = {}
            for col, name in enumerate(METRIC_NAMES):
                _, vals = _downsample(iteration0 + 1, m[:, col],
                                      self.MAX_CURVE_POINTS)
                series[name] = vals
            payload["metrics_pack"] = {"iterations": its, **series}
        self._post("/weights/update", "weights", payload)


def _downsample(it0: int, values: np.ndarray, max_points: int):
    """(iterations, values) lists with at most ``max_points`` entries —
    evenly strided so the curve's shape survives."""
    n = len(values)
    idx = (np.arange(n) if n <= max_points
           else np.linspace(0, n - 1, max_points).round().astype(int))
    return ([int(it0 + i) for i in idx],
            [float(values[i]) for i in idx])


class FlowIterationListener(_UiListener):
    """Architecture flowchart + per-layer param counts → /flow/update
    (FlowIterationListener.java:428)."""

    def __init__(self, frequency: int = 10, **kw):
        super().__init__(frequency=frequency, **kw)

    @staticmethod
    def describe(model) -> Dict[str, Any]:
        conf = model.conf
        nodes, edges = [], []
        table = model.get_param_table()
        counts: Dict[str, int] = {}
        for name, arr in table.items():
            lid = name.split("_", 1)[0]
            counts[lid] = counts.get(lid, 0) + int(_to_host(arr).size)
        if hasattr(conf, "layers") and isinstance(conf.layers, dict):
            # ComputationGraph: layers keyed by name + explicit vertex DAG
            for name in conf.topological_order:
                v = conf.vertices.get(name)
                kind = (type(conf.layers[name]).__name__
                        if name in conf.layers else
                        type(v).__name__ if v is not None else "Input")
                nodes.append({"name": name, "type": kind,
                              "params": counts.get(name, 0)})
                for src in (getattr(v, "inputs", None) or []):
                    edges.append({"from": src, "to": name})
        else:
            prev = "input"
            nodes.append({"name": "input", "type": "Input", "params": 0})
            for i, lc in enumerate(conf.layers):
                name = f"{i}_{type(lc).__name__}"
                nodes.append({"name": name, "type": type(lc).__name__,
                              "params": counts.get(str(i), 0)})
                edges.append({"from": prev, "to": name})
                prev = name
        return {"nodes": nodes, "edges": edges}

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency:
            return
        payload = self.describe(model)
        payload["iteration"] = iteration
        payload["score"] = float(model.score_value)
        self._post("/flow/update", "flow", payload)


class ConvolutionalIterationListener(_UiListener):
    """Tiles the first conv layer's activation maps on the last training
    batch into a base64 PNG → /activations/update
    (ConvolutionalIterationListener.java:587)."""

    def __init__(self, frequency: int = 10, layer_index: Optional[int] = None,
                 max_channels: int = 16, max_rows: int = 4, **kw):
        super().__init__(frequency=frequency, **kw)
        self.layer_index = layer_index
        self.max_channels = max_channels
        self.max_rows = max_rows

    def _find_conv_layer(self, model) -> Optional[int]:
        from deeplearning4j_tpu_torch.nn.conf import layers as L

        if self.layer_index is not None:
            return self.layer_index
        for i, lc in enumerate(model.conf.layers):
            if isinstance(lc, L.ConvolutionLayer):
                return i
        return None

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency:
            return
        x = getattr(model, "_last_input", None)
        if x is None:
            return
        li = self._find_conv_layer(model)
        if li is None:
            return
        acts = model.feed_forward(x[: self.max_rows])
        a = _to_host(acts[li + 1])  # feed_forward[0] is the input
        if a.ndim != 4:
            return
        tile = _tile_activations(a, self.max_channels)
        payload = {
            "iteration": iteration,
            "layer": li,
            "shape": list(a.shape),
            "image": "data:image/png;base64,"
                     + base64.b64encode(encode_png_gray(tile)).decode(),
        }
        self._post("/activations/update", "activations", payload)


def _tile_activations(a: np.ndarray, max_channels: int) -> np.ndarray:
    """(N,H,W,C) activations → one uint8 grid image (rows=examples,
    cols=channels)."""
    n, h, w, c = a.shape
    c = min(c, max_channels)
    grid = np.zeros((n * (h + 1), c * (w + 1)), np.uint8)
    for i in range(n):
        for j in range(c):
            img = a[i, :, :, j].astype(np.float64)
            lo, hi = img.min(), img.max()
            img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
            grid[i * (h + 1): i * (h + 1) + h,
                 j * (w + 1): j * (w + 1) + w] = (img * 255).astype(np.uint8)
    return grid


def encode_png_gray(img: np.ndarray) -> bytes:
    """Minimal 8-bit grayscale PNG encoder (stdlib zlib only — the reference
    leaned on javax.imageio for the same job)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))
