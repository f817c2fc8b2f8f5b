"""MetricsRegistry: counters / gauges / histograms with labels.

The seed grew observability the way the reference grew retries: ad-hoc.
``net._train_dispatches`` and ``net._eval_readbacks`` are bare attributes
per network instance, retry attempts only exist as debug log lines,
watchdog stalls live on the watchdog object, checkpoint write latency is
invisible. The registry is the one API those signals land behind: any
module does ``metrics().counter("retry_attempts_total").inc(fn="init")``
and every exporter (JSONL, Prometheus textfile, the bench summary block)
reads the same snapshot.

Design rules:

- **Process-global by default** (``metrics()``), injectable everywhere a
  caller wants isolation (tests construct private registries).
- **Instruments are cheap**: an ``inc``/``set``/``observe`` is a dict
  lookup plus a lock — safe on control-plane paths (dispatches, retries,
  checkpoints). Nothing here belongs INSIDE a jitted program; the
  device-side metrics pack (``monitor.pack``) covers that and flushes
  into this registry's world per chunk.
- **Labels are kwargs**, stored as a sorted tuple key, so
  ``c.inc(model="MLN")`` and ``c.value(model="MLN")`` always agree.
- **Type conflicts fail loudly**: re-registering a name as a different
  instrument kind raises instead of silently splitting the series.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics"]

LabelKey = Tuple[Tuple[str, str], ...]

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0, float("inf"))


def _label_key(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared label-series plumbing. Subclasses define what a series
    value is and how it mutates."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, object] = {}

    def _zero(self):
        return 0.0

    def remove(self, **labels) -> bool:
        """Drop one labeled series (e.g. an evicted fleet replica's
        per-replica gauge): a source that no longer exists must stop
        reporting as current, or dashboards and eviction audits read a
        corpse's last value as live. Returns whether the series
        existed."""
        with self._lock:
            return self._series.pop(_label_key(labels), None) is not None

    def labels(self) -> List[dict]:
        with self._lock:
            return [dict(k) for k in self._series]

    def value(self, **labels):
        with self._lock:
            return self._series.get(_label_key(labels), self._zero())

    def series(self) -> Dict[LabelKey, object]:
        with self._lock:
            return dict(self._series)


class Counter(_Instrument):
    """Monotonically increasing count (negative increments rejected)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Gauge(_Instrument):
    """Point-in-time value (can go up or down)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Histogram(_Instrument):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations ``<= le``; ``sum``/``count`` ride along)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != float("inf"):
            bounds.append(float("inf"))
        self.buckets = tuple(bounds)

    def _zero(self):
        return {"buckets": [0] * len(self.buckets), "sum": 0.0, "count": 0}

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._zero()
                self._series[key] = s
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s["buckets"][i] += 1
            s["sum"] += value
            s["count"] += 1

    @staticmethod
    def _copy(s):
        return {"buckets": list(s["buckets"]), "sum": s["sum"],
                "count": s["count"]}

    def value(self, **labels):
        with self._lock:
            s = self._series.get(_label_key(labels))
            return self._copy(s) if s is not None else self._zero()

    def series(self):
        # deep-copy under the lock: exporters iterate these dicts while a
        # background writer may be observe()-ing — a snapshot must be the
        # point-in-time view it claims, not a live (tearable) reference
        with self._lock:
            return {k: self._copy(s) for k, s in self._series.items()}


class MetricsRegistry:
    """Name -> instrument registry with snapshot/Prometheus export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"not {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def reset(self) -> None:
        """Drop every instrument (tests; a long-lived process keeps its
        counters for the life of the process, like any metrics agent)."""
        with self._lock:
            self._instruments.clear()

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready view: ``{name: {type, help, values: [{labels,
        value}, ...]}}`` — the payload the JSONL exporter and the bench
        summary block embed."""
        out = {}
        for inst in self.instruments():
            values = []
            for key, val in inst.series().items():
                values.append({"labels": dict(key), "value": val})
            out[inst.name] = {"type": inst.kind, "help": inst.help,
                              "values": values}
        return out

    def to_prometheus(self, prefix: str = "dl4j_") -> str:
        """Prometheus text exposition format (the node-exporter textfile
        collector dialect — one snapshot, no timestamps)."""
        lines = []
        for inst in self.instruments():
            full = prefix + inst.name
            if inst.help:
                lines.append(f"# HELP {full} {inst.help}")
            lines.append(f"# TYPE {full} {inst.kind}")
            for key, val in sorted(inst.series().items()):
                base_labels = dict(key)
                if inst.kind == "histogram":
                    for b, c in zip(inst.buckets, val["buckets"]):
                        le = "+Inf" if b == float("inf") else repr(b)
                        lines.append(
                            f"{full}_bucket"
                            f"{_fmt_labels({**base_labels, 'le': le})} {c}")
                    lines.append(
                        f"{full}_sum{_fmt_labels(base_labels)} "
                        f"{val['sum']}")
                    lines.append(
                        f"{full}_count{_fmt_labels(base_labels)} "
                        f"{val['count']}")
                else:
                    lines.append(
                        f"{full}{_fmt_labels(base_labels)} {val}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


_REGISTRY: Optional[MetricsRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def metrics() -> MetricsRegistry:
    """The process-global registry every in-tree instrument lands in."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY
