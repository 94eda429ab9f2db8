"""Chosen-run record helpers shared by replica roles.

The run pipeline delivers decided values as (start_slot, stride,
values) runs. Logging a run into a BufferMap log is identical across
protocols (multipaxos: stride 1; mencius: stride = num leader groups).
The reference's WAL half (``wal_log_chosen_run``) comes with the WAL
(ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations


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
