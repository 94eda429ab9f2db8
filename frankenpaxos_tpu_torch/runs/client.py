"""Client-side retry/admission discipline for the run pipeline (the
port's copy of ``frankenpaxos_tpu/runs/client.py``): retry-budget
bookkeeping, the Rejected backoff/reissue path, and the coalesce-writes
staging machinery. A protocol's client subclasses both
mixins and keeps only its own message construction and ``self.send``
call sites (so the paxflow graphs still attribute every edge to the
protocol module).

Pending-operation states are duck-typed: any object with ``id``,
``callback``, ``resend`` (a timer), ``attempts``, and -- for operations
that can draw a Rejected -- ``backoff_pending``. States without
``backoff_pending`` (e.g. the multipaxos MaxSlot quorum phase, which
acceptors never reject) are skipped by the Rejected path via the
``getattr`` default.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.serve.backoff import RETRY_EXHAUSTED


class RetryAdmissionMixin:
    """The paxload retry discipline (serve/backoff.py, docs/SERVING.md).

    Subclass contract -- attributes set in ``__init__``:

      * ``states``: dict pseudonym -> pending-operation state,
      * ``rng``: a ``random.Random``,
      * ``_retry_budget``: int; 0 keeps the pre-paxload behavior
        (unlimited resends, Rejected = immediate-backoff retry, no cap).
        With a budget, EVERY retry (Rejected backoff or timeout
        failover) consumes it, and exhaustion completes the operation
        with ``serve.RETRY_EXHAUSTED`` -- no request wedges silently;
      * ``_retry_backoff``: a ``serve.backoff.Backoff``;

    and one hook:

      * ``_reissue(pseudonym, state)``: re-send the operation after a
        backoff expiry (the protocol's own request construction and
        ``send`` call sites live here).
    """

    def _consume_retry(self, pseudonym: int, state, kind: str) -> bool:
        """Retry-budget bookkeeping: True = proceed with the retry;
        False = the budget is exhausted and the operation just
        completed with RETRY_EXHAUSTED."""
        budget = self._retry_budget
        if budget <= 0:
            return True
        metrics = self.transport.runtime_metrics
        if state.attempts >= budget:
            state.resend.stop()
            del self.states[pseudonym]
            if metrics is not None:
                metrics.client_retry("giveup")
            state.callback(RETRY_EXHAUSTED)
            return False
        state.attempts += 1
        if metrics is not None:
            metrics.client_retry(kind)
        return True

    def _handle_rejected(self, src, rejected) -> None:
        """Admission refused these commands: the server is ALIVE but
        saturated. Back off (jittered exponential, the server's
        retry_after_ms as a floor) and re-issue to the SAME destination
        class -- unlike a timeout, no failover. Each backoff consumes
        the retry budget when one is set.

        paxfan: ``_note_shed_source`` attributes the shed to the
        SHARD that sent it -- clients with a fan router record a
        per-shard shed deadline there and return it as an extra floor,
        so one hot batcher's retry-after never delays keys pinned to
        the other shards."""
        shard_floor_s = self._note_shed_source(src, rejected)
        for pseudonym, client_id in rejected.entries:
            state = self.states.get(pseudonym)
            if state is None or client_id != getattr(state, "id", None):
                self.logger.debug(
                    f"stale Rejected entry for pseudonym {pseudonym}")
                continue
            if getattr(state, "backoff_pending", True):
                # Under overload the resend and the original both reach
                # the leader and each draws a Rejected; one backoff per
                # operation, or the budget is double-consumed and the
                # shedding leader gets duplicate reissues. The True
                # default drops states that cannot be rejected at all.
                continue
            state.resend.stop()
            if not self._consume_retry(pseudonym, state, "backoff"):
                continue
            delay_s = self._retry_backoff.delay_s(
                state.attempts - 1 if self._retry_budget > 0
                else state.attempts, self.rng,
                floor_s=max(rejected.retry_after_ms / 1000.0,
                            shard_floor_s))
            if self._retry_budget <= 0:
                # No budget: attempts still drive the backoff curve.
                state.attempts += 1
            self._schedule_reissue(pseudonym, state, delay_s)

    def _schedule_reissue(self, pseudonym: int, state,
                          delay_s: float) -> None:
        """One-shot jittered-backoff timer re-issuing ``state``'s
        operation through the ``_reissue`` hook. The closure
        re-validates the pending state at fire time: a completion (or
        a newer operation) in the backoff window makes it a no-op."""
        expected_id = state.id
        state.backoff_pending = True

        def reissue():
            current = self.states.get(pseudonym)
            if current is not state \
                    or getattr(current, "id", None) != expected_id:
                return
            current.backoff_pending = False
            self._reissue(pseudonym, current)
            current.resend.start()

        timer = self.timer(f"backoff{pseudonym}", delay_s, reissue)
        timer.start()

    def _reissue(self, pseudonym: int, state) -> None:
        raise NotImplementedError

    def _note_shed_source(self, src, rejected) -> float:
        """Hook: attribute a Rejected to its sending shard and return
        the extra per-shard backoff floor in seconds (0.0 = none).
        Default keeps the tier-wide behavior."""
        return 0.0


class StagedWriteMixin:
    """The coalesce-writes staging machinery.

    Writes staged in one event-loop pass ship as ONE array message (each
    command still gets its own slot -- transport-level coalescing, not
    slot sharing). On a real event-loop transport (TCP) the flush is
    deferred to the END of the pass via ``call_soon_threadsafe`` (write()
    may be driven from off-loop threads); SimTransport has no loop --
    there ``on_drain`` / an explicit ``flush_writes()`` ships them.

    Subclass contract: call ``_init_staging()`` in ``__init__`` and
    implement ``_flush_staged(staged)`` (destination pick + the array
    ``send`` stay in the protocol module).
    """

    def _init_staging(self) -> None:
        self._staged_writes: list = []
        self._flush_scheduled = False

    def _stage_write(self, command) -> None:
        self._staged_writes.append(command)
        loop = getattr(self.transport, "loop", None)
        if loop is not None and not self._flush_scheduled:
            self._flush_scheduled = True
            loop.call_soon_threadsafe(self._deferred_flush)

    def flush_writes(self) -> None:
        """Ship the staged writes as one array via ``_flush_staged``."""
        if not self._staged_writes:
            return
        staged, self._staged_writes = self._staged_writes, []
        self._flush_staged(staged)

    def _deferred_flush(self) -> None:
        self._flush_scheduled = False
        self.flush_writes()

    def on_drain(self) -> None:
        self.flush_writes()

    def _flush_staged(self, staged: list) -> None:
        raise NotImplementedError
