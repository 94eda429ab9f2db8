"""Drain-stage scopes, the part of ``frankenpaxos_tpu/obs/trace.py``
that the actor runtime needs (``Actor.trace_stage``).

A stage scope times one drain stage (decode, handler, quorum-kernel,
...) into the runtime drain-stage histogram when the transport carries
a ``runtime_metrics`` sink, and is a shared no-op otherwise. The
reference's ``Tracer`` (spans, Perfetto export) is not ported yet
(ROADMAP.md, queue 1): a transport with a tracer attached is refused.
"""

from __future__ import annotations

import time


class _MetricStage:
    __slots__ = ("metrics", "stage", "t0")

    def __init__(self, metrics, stage: str):
        self.metrics = metrics
        self.stage = stage
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.observe_stage(self.stage,
                                   time.perf_counter() - self.t0)
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SCOPE = _Noop()


def stage_scope(tracer, metrics, name: str):
    """The one stage-timing entry point (``Actor.trace_stage``): a
    metrics-only timer, or a shared no-op."""
    if tracer is not None:
        raise NotImplementedError(
            "tracing spans are not ported yet (ROADMAP.md queue 1, "
            "obs/trace.py Tracer)")
    if metrics is not None:
        return _MetricStage(metrics, name)
    return NOOP_SCOPE
