"""Prometheus-shaped metrics facade with real and fake backends.

Reference behavior: monitoring/ (Collectors.scala:6-14, Counter.scala,
Gauge.scala, Summary.scala, PrometheusCollectors.scala:3-11,
FakeCollectors.scala:3-11). Protocol code builds metrics through the
facade and is identical in production (prometheus_client), tests, and
simulation (fakes).
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import Sequence


class Counter(abc.ABC):
    @abc.abstractmethod
    def labels(self, *values: str) -> "Counter":
        ...

    @abc.abstractmethod
    def inc(self, amount: float = 1.0) -> None:
        ...

    @abc.abstractmethod
    def get(self) -> float:
        ...


class Gauge(abc.ABC):
    @abc.abstractmethod
    def labels(self, *values: str) -> "Gauge":
        ...

    @abc.abstractmethod
    def set(self, value: float) -> None:
        ...

    @abc.abstractmethod
    def inc(self, amount: float = 1.0) -> None:
        ...

    @abc.abstractmethod
    def dec(self, amount: float = 1.0) -> None:
        ...

    @abc.abstractmethod
    def get(self) -> float:
        ...


class Summary(abc.ABC):
    @abc.abstractmethod
    def labels(self, *values: str) -> "Summary":
        ...

    @abc.abstractmethod
    def observe(self, value: float) -> None:
        ...

    def time(self):
        """Context manager observing elapsed seconds (the ``timed`` handler
        pattern, multipaxos/Leader.scala:281-293)."""
        return _SummaryTimer(self)

    @abc.abstractmethod
    def get_count(self) -> float:
        ...

    @abc.abstractmethod
    def get_sum(self) -> float:
        ...


class _SummaryTimer:
    def __init__(self, summary: Summary):
        self.summary = summary

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.summary.observe(time.perf_counter() - self._t0)
        return False


class Histogram(abc.ABC):
    """A bucketed distribution (drain-stage latencies, WAL fsyncs):
    the Prometheus exposition carries ``_bucket{le=...}``/``_sum``/
    ``_count`` samples, which promdb keeps queryable by those suffixed
    names."""

    @abc.abstractmethod
    def labels(self, *values: str) -> "Histogram":
        ...

    @abc.abstractmethod
    def observe(self, value: float) -> None:
        ...

    @abc.abstractmethod
    def get_count(self) -> float:
        ...

    @abc.abstractmethod
    def get_sum(self) -> float:
        ...


#: Event-loop-scale latency buckets (seconds): the prometheus_client
#: defaults start at 5ms -- useless for µs drain stages; these cover
#: 1µs..1s, the span between a fused kernel pass and a stalled fsync.
LATENCY_BUCKETS = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0)


class Collectors(abc.ABC):
    """Metric builders (Collectors.scala:6-14)."""

    @abc.abstractmethod
    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        ...

    @abc.abstractmethod
    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        ...

    @abc.abstractmethod
    def summary(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Summary:
        ...

    @abc.abstractmethod
    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS
                  ) -> Histogram:
        ...


# --- Fake backend (FakeCollectors.scala) ----------------------------------


@dataclasses.dataclass
class _FakeChild:
    value: float = 0.0
    count: float = 0.0


class FakeCounter(Counter):
    def __init__(self):
        self._children: dict[tuple, _FakeChild] = {}
        self._root = _FakeChild()

    def labels(self, *values: str) -> "FakeCounter":
        child = FakeCounter()
        child._root = self._children.setdefault(values, _FakeChild())
        return child

    def inc(self, amount: float = 1.0) -> None:
        self._root.value += amount

    def get(self) -> float:
        return self._root.value


class FakeGauge(Gauge):
    def __init__(self):
        self._children: dict[tuple, _FakeChild] = {}
        self._root = _FakeChild()

    def labels(self, *values: str) -> "FakeGauge":
        child = FakeGauge()
        child._root = self._children.setdefault(values, _FakeChild())
        return child

    def set(self, value: float) -> None:
        self._root.value = value

    def inc(self, amount: float = 1.0) -> None:
        self._root.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._root.value -= amount

    def get(self) -> float:
        return self._root.value


class FakeSummary(Summary):
    def __init__(self):
        self._children: dict[tuple, _FakeChild] = {}
        self._root = _FakeChild()

    def labels(self, *values: str) -> "FakeSummary":
        child = FakeSummary()
        child._root = self._children.setdefault(values, _FakeChild())
        return child

    def observe(self, value: float) -> None:
        self._root.value += value
        self._root.count += 1

    def get_count(self) -> float:
        return self._root.count

    def get_sum(self) -> float:
        return self._root.value


class FakeHistogram(Histogram):
    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        self.buckets = tuple(buckets)
        self._children: dict[tuple, "FakeHistogram"] = {}
        self._root = _FakeChild()
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last

    def labels(self, *values: str) -> "FakeHistogram":
        # Label aliasing contract (same as the other fakes): repeated
        # labels() calls with equal values share ONE child's state.
        child = self._children.get(values)
        if child is None:
            child = FakeHistogram(self.buckets)
            self._children[values] = child
        return child

    def observe(self, value: float) -> None:
        self._root.value += value
        self._root.count += 1
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def get_count(self) -> float:
        return self._root.count

    def get_sum(self) -> float:
        return self._root.value


class FakeCollectors(Collectors):
    def __init__(self):
        self.metrics: dict[str, object] = {}

    def counter(self, name, help="", labels=()):
        return self.metrics.setdefault(name, FakeCounter())

    def gauge(self, name, help="", labels=()):
        return self.metrics.setdefault(name, FakeGauge())

    def summary(self, name, help="", labels=()):
        return self.metrics.setdefault(name, FakeSummary())

    def histogram(self, name, help="", labels=(),
                  buckets=LATENCY_BUCKETS):
        return self.metrics.setdefault(name, FakeHistogram(buckets))


# --- Prometheus backend (PrometheusCollectors.scala) -----------------------


class PrometheusCollectors(Collectors):
    """Thin adapter over prometheus_client; import is deferred so sim/test
    environments never need it."""

    def __init__(self, registry=None):
        import prometheus_client  # noqa: deferred import

        self._pc = prometheus_client
        self._registry = registry or prometheus_client.REGISTRY
        self._cache: dict[str, object] = {}

    def _make(self, cls, name, help, labels):
        if name not in self._cache:
            self._cache[name] = cls(name, help or name, list(labels),
                                    registry=self._registry)
        return self._cache[name]

    def counter(self, name, help="", labels=()):
        return _PromCounter(self._make(self._pc.Counter, name, help, labels))

    def gauge(self, name, help="", labels=()):
        return _PromGauge(self._make(self._pc.Gauge, name, help, labels))

    def summary(self, name, help="", labels=()):
        return _PromSummary(self._make(self._pc.Summary, name, help, labels))

    def histogram(self, name, help="", labels=(),
                  buckets=LATENCY_BUCKETS):
        if name not in self._cache:
            self._cache[name] = self._pc.Histogram(
                name, help or name, list(labels),
                buckets=list(buckets), registry=self._registry)
        return _PromHistogram(self._cache[name])


class _PromCounter(Counter):
    def __init__(self, metric):
        self._m = metric

    def labels(self, *values):
        return _PromCounter(self._m.labels(*values))

    def inc(self, amount: float = 1.0) -> None:
        self._m.inc(amount)

    def get(self) -> float:
        return self._m._value.get()


class _PromGauge(Gauge):
    def __init__(self, metric):
        self._m = metric

    def labels(self, *values):
        return _PromGauge(self._m.labels(*values))

    def set(self, value: float) -> None:
        self._m.set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._m.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._m.dec(amount)

    def get(self) -> float:
        return self._m._value.get()


class _PromSummary(Summary):
    def __init__(self, metric):
        self._m = metric

    def labels(self, *values):
        return _PromSummary(self._m.labels(*values))

    def observe(self, value: float) -> None:
        self._m.observe(value)

    def get_count(self) -> float:
        return self._m._count.get()

    def get_sum(self) -> float:
        return self._m._sum.get()


class _PromHistogram(Histogram):
    def __init__(self, metric):
        self._m = metric

    def labels(self, *values):
        return _PromHistogram(self._m.labels(*values))

    def observe(self, value: float) -> None:
        self._m.observe(value)

    def get_count(self) -> float:
        return sum(b.get() for b in self._m._buckets) \
            if hasattr(self._m, "_buckets") else 0.0

    def get_sum(self) -> float:
        return self._m._sum.get()
