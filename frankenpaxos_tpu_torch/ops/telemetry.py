"""paxpulse device-plane telemetry on one GPU: counters as data.

Counterpart of ``frankenpaxos_tpu/ops/telemetry.py``. A small set of
int32 counters rides inside the pipeline state and is accumulated by the
drain itself -- in the CUDA drain K14 (``csrc/pipeline.cu``, the
``kTelemetry`` instantiation of K3's chunked drain kernel), or by :func:`quorum_pass_update`
and :func:`drain_update` in the plain version -- with no callbacks, no
clocks and no device-to-host copy until an explicit
``frankenpaxos_tpu_torch.obs.telemetry.collect`` at the reporting
interval.

Disabled means absent: the pipeline carries ``telemetry=None`` by
default and then launches K3, the drain without counters.

Counter semantics (all cumulative since :func:`make_telemetry`):

  * ``shard_committed`` -- ``[slot_shards]`` newly-chosen commands per
    slot shard (one shard on one GPU; under the sharded drain every rank
    holds every shard's entry, which the slot all-reduce fills);
  * ``proposed`` -- nonzero proposed commands;
  * ``occupancy`` -- ``[n_acceptors + 1]`` histogram: when a slot is
    first chosen, the int32 sum of its vote bytes, clipped to
    ``[0, n]``;
  * ``lag_hist`` -- ``[LAG_BUCKETS]`` histogram of the end-of-drain
    watermark lag ``(i + 1) * block_size - committed`` (int32, wrapping),
    bucketed by :func:`lag_bucket`;
  * ``pad_lanes`` -- pad-lane slots masked per drain under a
    non-divisible slot split (always 0 unsharded);
  * ``drains`` -- drains accumulated.

The six counters are int32 views into ONE flat int32 buffer
(``TelemetryState.buffer``), in the order above, followed by one private
scratch word that K14 uses as its done-counter (always 0 between
launches). One buffer makes a collect a single device-to-host copy. Every
update here is an in-place add into those views.

What each update adds is defined once: :func:`pass_deltas` and
:func:`drain_deltas` give a shard's local contributions and
:func:`close_drain` the once-per-drain lag sample and drain count.

Over slot shards (the reference's ``slot_axis``), ``slot_axis`` is the
mesh's :class:`~frankenpaxos_tpu_torch.mesh.SlotAxis` and each psum of
the reference an all-reduce over the slot subgroup. The sharded drain
does not call these ``slot_axis`` paths: its plain phases
(``bench/pipeline.py``) take the same local deltas from
:func:`pass_deltas` and :func:`drain_deltas`, carry them in its ONE slot
all-reduce per drain and end with :func:`close_drain`; its kernels
(K19-K21) compute the same deltas on the card. The ``slot_axis`` paths
are the reference's API, one all-reduce per update, kept for parity
with it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from frankenpaxos_tpu_torch.device import resolve_device
import numpy as np
import torch

#: Watermark-lag histogram buckets: 0, 1, 2, [3,4], [5,8], ... (log2).
LAG_BUCKETS = 16

#: The counters in the flat buffer's order (the scratch word follows).
FIELDS = ("shard_committed", "proposed", "occupancy", "lag_hist",
          "pad_lanes", "drains")


class TelemetryState(NamedTuple):
    shard_committed: torch.Tensor  # [slot_shards] int32
    proposed: torch.Tensor         # [] int32
    occupancy: torch.Tensor        # [n_acceptors + 1] int32
    lag_hist: torch.Tensor         # [LAG_BUCKETS] int32
    pad_lanes: torch.Tensor        # [] int32
    drains: torch.Tensor           # [] int32
    # The flat int32 storage the six counters view, plus the scratch
    # word (K14's done-counter) at its end.
    buffer: Optional[torch.Tensor] = None


#: Where each counter of a sharded state lives, in the reference's
#: ``PIPELINE_PARTITION`` idiom. The reference keeps ``shard_committed``
#: sharded over ``slot`` (each shard its own entry); here the drain's
#: slot all-reduce hands every rank every shard's entry, so every counter
#: is replicated and a gather reads any rank's copy.
TELEMETRY_PARTITION = TelemetryState(
    shard_committed=(), proposed=(), occupancy=(), lag_hist=(),
    pad_lanes=(), drains=(), buffer=())


def _shapes(num_acceptors: int, slot_shards: int) -> tuple:
    """The counters' shapes, in ``FIELDS`` order (each 0-d or 1-d)."""
    return ((slot_shards,), (), (num_acceptors + 1,), (LAG_BUCKETS,), (),
            ())


def buffer_words(num_acceptors: int, slot_shards: int = 1) -> int:
    """Words of the flat buffer: the six counters and the scratch word."""
    return slot_shards + num_acceptors + LAG_BUCKETS + 5


def _views(buffer: torch.Tensor, num_acceptors: int,
           slot_shards: int) -> TelemetryState:
    views, at = [], 0
    for shape in _shapes(num_acceptors, slot_shards):
        size = shape[0] if shape else 1
        views.append(buffer[at:at + size].view(shape))
        at += size
    return TelemetryState(*views, buffer=buffer)


def make_telemetry(num_acceptors: int, slot_shards: int = 1,
                   device=None) -> TelemetryState:
    """A zeroed telemetry state for ``num_acceptors`` acceptors over
    ``slot_shards`` slot shards, on ``device`` (``cuda`` when None).
    It only allocates, so any ``slot_shards`` is accepted here; the
    drain takes one shard."""
    buffer = torch.zeros(buffer_words(num_acceptors, slot_shards),
                         dtype=torch.int32, device=resolve_device(device))
    return _views(buffer, num_acceptors, slot_shards)


def flat_buffer(tel: TelemetryState) -> torch.Tensor:
    """The flat buffer of ``tel``, after checking that the six counters
    are int32 views of it at :func:`make_telemetry`'s offsets (what K14
    and a one-copy collect rely on); raises ``ValueError`` otherwise."""
    buffer = tel.buffer
    if buffer is None or buffer.dtype != torch.int32 or buffer.dim() != 1 \
            or not buffer.is_contiguous():
        raise ValueError("a TelemetryState needs its flat int32 buffer "
                         "(make_telemetry builds one)")
    slot_shards = tel.shard_committed.numel()
    num_acceptors = tel.occupancy.numel() - 1
    if buffer.numel() != buffer_words(num_acceptors, slot_shards):
        raise ValueError("the telemetry buffer does not match its counters")
    base, at = buffer.data_ptr(), 0
    for name, shape in zip(FIELDS, _shapes(num_acceptors, slot_shards)):
        got = getattr(tel, name)
        if got.dtype != torch.int32 or tuple(got.shape) != shape \
                or got.data_ptr() != base + 4 * at:
            raise ValueError(f"telemetry counter {name} is not a view of "
                             f"the flat buffer at its offset")
        at += shape[0] if shape else 1
    return buffer


def lag_bucket_bounds() -> np.ndarray:
    """Lower bounds of the lag buckets: bucket b counts lags in
    ``[bounds[b], bounds[b+1])`` with bucket 0 = exactly 0 and the last
    bucket open-ended. Host-side, for reporting."""
    return np.concatenate(
        ([0], 2 ** np.arange(LAG_BUCKETS - 1, dtype=np.int64)))


def lag_bucket(lag: torch.Tensor) -> torch.Tensor:
    """The bucket index of each int32 lag (a scalar, or any shape): how
    many of the bounds 2^0 ... 2^14 it reaches, by signed integer
    compares (a negative lag gives 0, the largest bucket is 15)."""
    # lag >= 2^k  <=>  lag >> k >= 1 (an arithmetic shift: a negative
    # lag stays negative); the shifts are made on the lag's device.
    shifts = torch.arange(LAG_BUCKETS - 1, dtype=torch.int32,
                          device=lag.device)
    return ((lag[..., None] >> shifts) >= 1).sum(-1, dtype=torch.int32)


def _psum(x: torch.Tensor, slot_axis) -> torch.Tensor:
    """The reference's psum over the slot axis: the identity unsharded,
    an all-reduce over the slot subgroup with a ``SlotAxis``."""
    if slot_axis is None:
        return x
    if not hasattr(slot_axis, "psum"):
        raise TypeError(f"slot_axis must be None or the mesh's SlotAxis "
                        f"(mesh.slot_axis), not {slot_axis!r}")
    return slot_axis.psum(x)


def pass_deltas(votes_count: torch.Tensor, newly: torch.Tensor,
                n_bins: int) -> tuple:
    """One quorum pass's local counter deltas: the ``[n_bins]`` int32
    occupancy histogram of the newly-chosen lanes, lane ``l`` in bin
    ``clip(votes_count[l], 0, n_bins - 1)``, and the int32 newly count
    (a scatter-add of the newly flags: nothing waits for the device)."""
    bins = votes_count.clamp(0, n_bins - 1).long()
    occ = torch.zeros(n_bins, dtype=torch.int32, device=bins.device)
    return (occ.scatter_add_(0, bins, newly.to(torch.int32)),
            newly.sum(dtype=torch.int32))


def drain_deltas(proposed_block: torch.Tensor,
                 lane_valid: Optional[torch.Tensor]) -> tuple:
    """One drain's local counter deltas: the nonzero proposals and the
    pad lanes (``~lane_valid``; 0 when it is None), each int32."""
    pad = (torch.zeros((), dtype=torch.int32, device=proposed_block.device)
           if lane_valid is None else (~lane_valid).sum(dtype=torch.int32))
    return (proposed_block != 0).sum(dtype=torch.int32), pad


def close_drain(tel: TelemetryState, lag: torch.Tensor) -> TelemetryState:
    """The once-per-drain counters, in place: one sample of the
    end-of-drain lag's bucket (``lag`` is the same on every shard) and
    the drain count."""
    bucket = lag_bucket(lag).reshape(1).long()
    tel.lag_hist.scatter_add_(0, bucket, torch.ones_like(bucket,
                                                         dtype=torch.int32))
    tel.drains.add_(1)
    return tel


def quorum_pass_update(tel: Optional[TelemetryState], *,
                       votes_count: torch.Tensor, newly: torch.Tensor,
                       slot_axis=None) -> Optional[TelemetryState]:
    """Accumulate one quorum pass, in place: ``votes_count`` is the
    ``[B]`` int32 per-lane (group-reduced) vote count and ``newly`` the
    ``[B]`` newly-chosen mask. The occupancy histogram of
    :func:`pass_deltas` is summed over the slot shards; this shard's
    entry of ``shard_committed`` gains the newly count (under a
    ``slot_axis``, every shard's entry, through one all-reduce of the
    one-hot vector). ``None`` in, ``None`` out."""
    if tel is None:
        return None
    occ, count = pass_deltas(votes_count, newly, tel.occupancy.shape[0])
    tel.occupancy.add_(_psum(occ, slot_axis))
    if slot_axis is None:
        tel.shard_committed.add_(count)
    else:
        shards = torch.zeros_like(tel.shard_committed)
        shards[slot_axis.index] = count
        tel.shard_committed.add_(_psum(shards, slot_axis))
    return tel


def drain_update(tel: Optional[TelemetryState], *,
                 proposed_block: torch.Tensor,
                 lane_valid: Optional[torch.Tensor],
                 lag: torch.Tensor,
                 slot_axis=None) -> Optional[TelemetryState]:
    """Accumulate the once-per-drain counters, in place: the nonzero
    proposals and pad lanes of :func:`drain_deltas`, each summed over the
    slot shards (no pad lanes when ``lane_valid`` is None), then
    :func:`close_drain`."""
    if tel is None:
        return None
    proposed, pad = drain_deltas(proposed_block, lane_valid)
    tel.proposed.add_(_psum(proposed, slot_axis))
    if lane_valid is not None:
        tel.pad_lanes.add_(_psum(pad, slot_axis))
    return close_drain(tel, lag)
