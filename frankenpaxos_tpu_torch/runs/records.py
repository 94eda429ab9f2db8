"""Chosen-run record helpers shared by replica roles.

The run pipeline delivers decided values as (start_slot, stride,
values) runs. Logging a run into a BufferMap log is identical across
protocols (multipaxos: stride 1; a striped log: stride = num leader
groups). ``wal_log_chosen_run`` is the WAL half.
"""

from __future__ import annotations

from typing import Callable

from frankenpaxos_tpu_torch.wal.records import WalChosenRun


def log_chosen_values(log, executed_watermark: int, start_slot: int,
                      stride: int, values) -> tuple[int, int]:
    """Put a (possibly strided) run of chosen values into ``log``.

    Slots below the executed watermark are duplicates by definition
    (everything below it is chosen and executed; the log is GC'd to
    it). Returns ``(new_count, high_slot)`` where ``high_slot`` is the
    largest slot this run newly filled, or -1 when none were new.
    Shared by the live Chosen and ChosenRun handlers.
    """
    new = 0
    high = -1
    slot = start_slot
    for value in values:
        if slot >= executed_watermark and log.get(slot) is None:
            log.put(slot, value)
            new += 1
            high = slot
        slot += stride
    return new, high


def wal_log_chosen_run(wal, log_get: Callable, start_slot: int,
                       stride: int, values, all_new: bool,
                       encode: Callable) -> None:
    """Append a freshly-logged run's NEW entries to ``wal``.

    The common case -- every slot new -- logs the inbound lazy value
    array as ONE raw-copy record; a partially-duplicate run (rare: a
    resend or post-failover overlap) falls back to per-new-slot records,
    identified by the entry this run put (``log_get(slot) is value``).
    ``encode`` is the protocol's value-array encoder.
    """
    if all_new:
        wal.append(WalChosenRun(start_slot=start_slot, stride=stride,
                                values=encode(values)))
        return
    for i, value in enumerate(values):
        slot = start_slot + i * stride
        if log_get(slot) is value:
            wal.append(WalChosenRun(start_slot=slot, stride=1,
                                    values=encode((value,))))
