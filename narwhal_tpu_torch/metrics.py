"""Prometheus-style metrics: registry, counters/gauges/histograms, text
exposition, HTTP exporter.

Port copy of `narwhal_tpu/metrics.py` (the JAX package's counterpart). The PyTorch
port keeps its own copy so that it imports nothing of `narwhal_tpu`.

The reference registers ~50+ metrics per role (primary/src/metrics.rs:51-485,
worker/src/metrics.rs, consensus/src/metrics.rs:13-49) and exposes them over
HTTP (node/src/main.rs:279-285); cluster tests assert progress by scraping the
registry (test_utils/src/cluster.rs:210-269,315). We implement the same shape
in-process: a Registry of named metrics with labels, rendered in the
Prometheus text format, served by a tiny asyncio HTTP endpoint.
"""

from __future__ import annotations

import asyncio
from typing import Iterable


class _Metric:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._children: dict[tuple[str, ...], _Child] = {}

    def labels(self, *values: str) -> "_Child":
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            child = self._make_child()
            self._children[key] = child
        return child

    def _default(self) -> "_Child":
        return self.labels()

    def _make_child(self) -> "_Child":
        raise NotImplementedError


class _Child:
    pass


class _CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, by: float = 1.0) -> None:
        self.value += by


class Counter(_Metric):
    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, by: float = 1.0) -> None:
        self._default().inc(by)

    def get(self) -> float:
        return self._default().value


class _GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, by: float = 1.0) -> None:
        self.value += by

    def dec(self, by: float = 1.0) -> None:
        self.value -= by


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, by: float = 1.0) -> None:
        self._default().inc(by)

    def dec(self, by: float = 1.0) -> None:
        self._default().dec(by)

    def get(self) -> float:
        return self._default().value


class _HistogramChild(_Child):
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, label_names, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(buckets)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._default().observe(v)


class Registry:
    """One per role process, like the reference's per-role registries
    (node/src/metrics.rs)."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}

    def counter(self, name: str, help_: str = "", labels: Iterable[str] = ()) -> Counter:
        return self._register(Counter(name, help_, tuple(labels)))

    def gauge(self, name: str, help_: str = "", labels: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge(name, help_, tuple(labels)))

    def histogram(
        self, name: str, help_: str = "", labels: Iterable[str] = (), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._register(Histogram(name, help_, tuple(labels), buckets))

    def _register(self, metric: _Metric) -> _Metric:
        existing = self._metrics.get(metric.name)
        if existing is not None:
            if type(existing) is not type(metric):
                raise ValueError(f"metric {metric.name} re-registered with new type")
            return existing
        self._metrics[metric.name] = metric
        return metric

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def value(self, name: str, *label_values: str) -> float:
        """Test/assertion helper, the analog of PrimaryNodeDetails::metric
        (test_utils/src/cluster.rs:315)."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        child = m._children.get(tuple(str(v) for v in label_values))
        if child is None:
            return 0.0
        if isinstance(child, _HistogramChild):
            return child.count
        return child.value

    def render(self) -> str:
        out: list[str] = []
        for m in self._metrics.values():
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for key, child in m._children.items():
                lbl = (
                    "{" + ",".join(f'{n}="{v}"' for n, v in zip(m.label_names, key)) + "}"
                    if key
                    else ""
                )
                if isinstance(child, _HistogramChild):
                    cum = 0
                    for b, c in zip(child.buckets, child.counts):
                        cum += c
                        sep = "," if key else ""
                        base = lbl[:-1] + sep if key else "{"
                        out.append(f'{m.name}_bucket{base}le="{b}"}} {cum}')
                    base = lbl[:-1] + ("," if key else "")
                    if not key:
                        base = "{"
                    out.append(f'{m.name}_bucket{base}le="+Inf"}} {child.count}')
                    out.append(f"{m.name}_sum{lbl} {child.sum}")
                    out.append(f"{m.name}_count{lbl} {child.count}")
                else:
                    out.append(f"{m.name}{lbl} {child.value}")
        return "\n".join(out) + "\n"


def parse_exposition(text: str) -> dict[str, dict]:
    """Parse Prometheus text exposition (the exact dialect render() emits)
    into {name: {"type", "help", "samples": {label_suffix: value}}}. The
    label_suffix key is the raw '{...}' chunk ('' for unlabelled samples),
    so round-tripping a scrape is lossless for assertions and benchmark
    snapshots; _bucket/_sum/_count series fold under their base name."""
    out: dict[str, dict] = {}

    def entry(name: str) -> dict:
        return out.setdefault(
            name, {"type": "untyped", "help": "", "samples": {}}
        )

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, help_ = line[len("# HELP "):].partition(" ")
            entry(name)["help"] = help_
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            entry(name)["type"] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        series, _, raw_value = line.rpartition(" ")
        try:
            value = float(raw_value)
        except ValueError:
            continue
        name, labels = series, ""
        if "{" in series:
            name, _, rest = series.partition("{")
            labels = "{" + rest
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in out:
                base = name[: -len(suffix)]
                labels = name[len(base):] + labels
                break
        entry(base)["samples"][labels] = value
    return out


def scrape_snapshot(registry: Registry) -> dict[str, dict]:
    """Benchmark-sized scrape snapshot: the full exposition parsed back,
    minus histogram bucket series (they dominate the byte count and the
    percentile story belongs to the trace-waterfall artifacts). Counters,
    gauges, and histogram _sum/_count survive — enough for any A/B to
    recompute rates and means from the embedded record alone."""
    out = {}
    for name, entry in parse_exposition(registry.render()).items():
        samples = {
            k: v
            for k, v in entry["samples"].items()
            if not k.startswith("_bucket")
        }
        out[name] = {"type": entry["type"], "samples": samples}
    return out


async def serve_metrics(registry: Registry, host: str, port: int):
    """Minimal HTTP /metrics exporter (node/src/main.rs:279-285). Returns the
    asyncio server; the bound port is server.sockets[0].getsockname()[1]."""

    async def handle(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            writer.close()
            return
        body = registry.render().encode()
        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: text/plain; version=0.0.4\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode()
            + body
        )
        try:
            await writer.drain()
        finally:
            writer.close()

    return await asyncio.start_server(handle, host, port)
