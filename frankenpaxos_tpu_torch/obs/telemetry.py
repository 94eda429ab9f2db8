"""paxpulse host plane: interval collection of the device counters.

Counterpart of ``frankenpaxos_tpu/obs/telemetry.py``. The device side
(``ops/telemetry.py``) accumulates counters in one flat int32 buffer
inside the pipeline state; this module is the ONLY place they cross to
the host. :func:`collect` makes exactly one device-to-host copy of that
buffer, through :func:`fetch` -- one sync per reporting interval, never
per drain.

From a snapshot the host derives:

  * ``fpx_pipeline_*`` RuntimeMetrics (obs/trace.py): committed /
    proposed / drains / pad-lane counters, per-shard committed gauges
    and the shard-skew ratio, the quorum-occupancy and watermark-lag
    histograms as labeled counters, and the proposal batch fill
    (:func:`publish`).
  * Perfetto COUNTER tracks (``ph: "C"``, :func:`counter_events`) merged
    into the trace export next to the span tracks
    (``obs.perfetto.to_chrome_trace(records, counters)``).

:class:`TelemetryReporter` packages the interval loop: hold the previous
snapshot, publish deltas to RuntimeMetrics, remember timed samples for
the counter tracks, and dump/load ``*.counters.jsonl`` next to the role
trace dumps.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, TYPE_CHECKING

from frankenpaxos_tpu_torch.ops.telemetry import (
    FIELDS,
    flat_buffer,
    lag_bucket_bounds,
)
import numpy as np
import torch

if TYPE_CHECKING:
    from frankenpaxos_tpu_torch.obs.trace import RuntimeMetrics


@dataclasses.dataclass(frozen=True)
class TelemetrySnapshot:
    """Host copy of the cumulative device counters (one collect)."""

    drains: int
    proposed: int
    shard_committed: tuple
    occupancy: tuple
    lag_hist: tuple
    pad_lanes: int

    @property
    def committed(self) -> int:
        return int(sum(self.shard_committed))

    def delta(self, prev: Optional["TelemetrySnapshot"]) \
            -> "TelemetrySnapshot":
        """The interval delta against an earlier snapshot (``None``
        means "since the zeroed state": the snapshot itself)."""
        if prev is None:
            return self
        return TelemetrySnapshot(
            drains=self.drains - prev.drains,
            proposed=self.proposed - prev.proposed,
            shard_committed=tuple(
                a - b for a, b in zip(self.shard_committed,
                                      prev.shard_committed)),
            occupancy=tuple(a - b for a, b in zip(self.occupancy,
                                                  prev.occupancy)),
            lag_hist=tuple(a - b for a, b in zip(self.lag_hist,
                                                 prev.lag_hist)),
            pad_lanes=self.pad_lanes - prev.pad_lanes)

    def shard_skew(self) -> float:
        """max/mean of per-shard committed: 1.0 is a perfectly even
        split."""
        shards = self.shard_committed
        mean = sum(shards) / max(len(shards), 1)
        return float(max(shards) / mean) if mean else 1.0

    def batch_fill(self, block_size: int) -> float:
        """Valid proposals per drain over the block: 1.0 means every
        lane carried a command."""
        denom = self.drains * block_size
        return float(self.proposed / denom) if denom else 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "TelemetrySnapshot":
        return cls(drains=int(obj["drains"]),
                   proposed=int(obj["proposed"]),
                   shard_committed=tuple(obj["shard_committed"]),
                   occupancy=tuple(obj["occupancy"]),
                   lag_hist=tuple(obj["lag_hist"]),
                   pad_lanes=int(obj["pad_lanes"]))


def fetch(buffer: torch.Tensor) -> np.ndarray:
    """The one device-to-host copy of a collect: the flat buffer as a
    host int32 array."""
    return buffer.detach().to("cpu", copy=True).numpy()


def collect(state) -> Optional[TelemetrySnapshot]:
    """ONE device-to-host copy of the pipeline's telemetry buffer.

    ``state`` is a ``bench.pipeline.PipelineState`` (or anything with a
    ``.telemetry`` field, or a bare ``TelemetryState``). Returns ``None``
    when the plane is off."""
    tel = getattr(state, "telemetry", state)
    if tel is None:
        return None
    buffer = flat_buffer(tel)
    host = fetch(buffer)
    start = buffer.data_ptr()
    values = {}
    for name in FIELDS:
        view = getattr(tel, name)
        at = (view.data_ptr() - start) // buffer.element_size()
        values[name] = host[at:at + view.numel()]
    return TelemetrySnapshot(
        drains=int(values["drains"][0]),
        proposed=int(values["proposed"][0]),
        shard_committed=tuple(int(x) for x in values["shard_committed"]),
        occupancy=tuple(int(x) for x in values["occupancy"]),
        lag_hist=tuple(int(x) for x in values["lag_hist"]),
        pad_lanes=int(values["pad_lanes"][0]))


def publish(metrics: "RuntimeMetrics", snap: TelemetrySnapshot,
            prev: Optional[TelemetrySnapshot] = None,
            block_size: Optional[int] = None) -> None:
    """Feed one interval into a ``RuntimeMetrics`` (obs/trace.py):
    counters get the delta against ``prev``, gauges (per-shard
    committed, skew, fill) the cumulative state."""
    d = snap.delta(prev)
    metrics.pipeline_interval(
        drains=d.drains, committed=d.committed, proposed=d.proposed,
        pad_lanes=d.pad_lanes, occupancy=d.occupancy,
        lag_hist=d.lag_hist, shard_committed=snap.shard_committed,
        skew=snap.shard_skew(),
        fill=(snap.batch_fill(block_size)
              if block_size else None))


def counter_events(samples: Sequence[tuple], role: str) -> list:
    """Chrome-trace COUNTER events (``ph: "C"``) from ``(t_seconds,
    snapshot)`` interval samples: per-interval committed/proposed/pad
    deltas plus the cumulative skew ratio, one track set per role.
    Merge them into the span export via ``to_chrome_trace(records,
    counters=...)``."""
    events = []
    prev = None
    for t, snap in samples:
        d = snap.delta(prev)
        prev = snap
        ts = round(float(t) * 1e6, 3)
        events.append({
            "name": f"paxpulse {role} pipeline",
            "ph": "C", "pid": 1, "ts": ts,
            "args": {"committed": d.committed, "proposed": d.proposed,
                     "pad_lanes": d.pad_lanes}})
        events.append({
            "name": f"paxpulse {role} shard skew",
            "ph": "C", "pid": 1, "ts": ts,
            "args": {"max_over_mean": round(snap.shard_skew(), 4)}})
    return events


class TelemetryReporter:
    """The reporting-interval loop for one role or bench: call
    :meth:`collect` once per interval with the live pipeline state and
    the host-side timestamp; deltas go to RuntimeMetrics (when
    attached) and timed samples accumulate for the Perfetto counter
    tracks."""

    def __init__(self, role: str, metrics=None,
                 block_size: Optional[int] = None):
        self.role = role
        self.metrics = metrics
        self.block_size = block_size
        self.samples: list = []
        self._prev: Optional[TelemetrySnapshot] = None

    def collect(self, state, t: float) -> Optional[TelemetrySnapshot]:
        snap = collect(state)
        if snap is None:
            return None
        if self.metrics is not None:
            publish(self.metrics, snap, self._prev, self.block_size)
        self.samples.append((float(t), snap))
        self._prev = snap
        return snap

    @property
    def last(self) -> Optional[TelemetrySnapshot]:
        return self._prev

    def counter_events(self) -> list:
        return counter_events(self.samples, self.role)

    def dump(self, path: str) -> None:
        """``*.counters.jsonl``: one ``{t, role, snapshot}`` line per
        interval."""
        with open(path, "w") as f:
            for t, snap in self.samples:
                f.write(json.dumps({"t": t, "role": self.role,
                                    "snapshot": snap.to_json()}) + "\n")

    def summary(self) -> dict:
        """The post-mortem / artifact JSON for the last counter state."""
        snap = self._prev
        if snap is None:
            return {"role": self.role, "collected": False}
        out = {"role": self.role, "collected": True,
               "drains": snap.drains, "proposed": snap.proposed,
               "committed": snap.committed,
               "shard_committed": list(snap.shard_committed),
               "shard_skew": round(snap.shard_skew(), 4),
               "pad_lanes": snap.pad_lanes,
               "occupancy": list(snap.occupancy),
               "lag_hist": list(snap.lag_hist),
               "lag_bucket_lower_bounds":
                   [int(b) for b in lag_bucket_bounds()]}
        if self.block_size:
            out["batch_fill"] = round(snap.batch_fill(self.block_size), 4)
        return out


def load_counters(path: str) -> list:
    """``(t, role, snapshot)`` samples from a ``*.counters.jsonl`` dump
    (tolerates a torn final line)."""
    samples = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                samples.append((float(obj["t"]), str(obj["role"]),
                                TelemetrySnapshot.from_json(
                                    obj["snapshot"])))
            except (ValueError, KeyError):
                continue
    return samples
