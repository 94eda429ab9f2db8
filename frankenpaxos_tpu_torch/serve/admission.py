"""Server-side admission control, queue-delay shedding, and bounded
inboxes: the port's copy of ``frankenpaxos_tpu/serve/admission.py``.

Three mechanisms, composed per role by :class:`AdmissionController`:

  * **Token bucket** -- a rate/burst cap on admitted client commands
    (the blunt front door: an aggregate-rate promise independent of
    where the commands would land in the pipeline).
  * **In-flight slot budget** -- at most ``inflight_limit`` commands
    between proposal and the chosen watermark. The LEADER feeds the
    live span (``next_slot - chosen_watermark``) via
    :meth:`AdmissionController.set_inflight` on every drain and every
    watermark advance, so admission is drain-granular: capacity frees
    the moment a drain's quorums land, not when replies trickle out.
  * **CoDel-style queue-delay shedding** -- the drain boundary is the
    queue: when a drain batch's sojourn (first delivery -> on_drain)
    stays above ``codel_target_s`` for a full ``codel_interval_s``,
    the controller enters shed mode and client-lane arrivals are
    rejected until a drain comes in under target again. Like CoDel,
    the signal is DELAY, not depth -- a deep-but-fast queue is healthy,
    a shallow-but-stalled one is not.

Rejection is explicit: :func:`reject_replies_for` turns the refused
client request into ``Rejected`` wire replies (serve/messages.py) so
clients back off instead of re-sending into the congestion
(backoff.py). Priority lanes (lanes.py) keep every mechanism away from
control-plane traffic by construction.

The whole layer is pay-for-what-you-use: a role without a controller
costs the transports one attribute load + ``is None`` test per frame
(the hook discipline of the tracer and the metrics sink).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from frankenpaxos_tpu_torch.serve.messages import (
    REASON_CODEL,
    REASON_INFLIGHT,
    REASON_NAMES,
    REASON_QUEUE,
    REASON_TOKENS,
    Rejected,
)


@dataclasses.dataclass(frozen=True)
class AdmissionOptions:
    """Per-role admission knobs. Every mechanism is off at 0 (the
    default options object admits everything and arms nothing), so a
    role constructed without explicit limits behaves exactly as before
    paxload."""

    # Token bucket: admitted client commands per second / burst depth.
    token_rate: float = 0.0          # 0 disables the bucket
    token_burst: float = 0.0         # 0 -> defaults to token_rate
    # In-flight slot budget (proposed - chosen watermark span).
    inflight_limit: int = 0          # 0 disables
    # Bounded client-lane inbox (transports enforce; see
    # SimTransport.set_inbox_policy / TcpTransport delivery).
    inbox_capacity: int = 0          # 0 = unbounded
    inbox_policy: str = "reject"     # "reject" (newest) | "drop" (oldest)
    # CoDel-style drain-sojourn shedding.
    codel_target_s: float = 0.0      # 0 disables
    codel_interval_s: float = 0.1
    # Backoff hint stamped on Rejected replies (0 = client default).
    retry_after_ms: int = 0

    def any_enabled(self) -> bool:
        return bool(self.token_rate or self.inflight_limit
                    or self.inbox_capacity or self.codel_target_s)


def options_from_flat(obj) -> Optional[AdmissionOptions]:
    """Build AdmissionOptions from an options dataclass carrying the
    flat ``admission_*`` fields (flat so the CLI's ``--options.*``
    overrides coerce them by declared type). None when nothing is
    armed -- the caller then skips building a controller entirely."""
    options = AdmissionOptions(
        token_rate=obj.admission_token_rate,
        token_burst=obj.admission_token_burst,
        inflight_limit=obj.admission_inflight_limit,
        inbox_capacity=obj.admission_inbox_capacity,
        inbox_policy=obj.admission_inbox_policy,
        codel_target_s=obj.admission_codel_target_s,
        codel_interval_s=obj.admission_codel_interval_s,
        retry_after_ms=obj.admission_retry_after_ms)
    return options if options.any_enabled() else None


class TokenBucket:
    """A monotonic-clock token bucket; ``clock`` is injectable so sims
    stay deterministic (the overload driver feeds virtual time)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float]):
        self.rate = rate
        self.burst = burst or rate
        self.clock = clock
        self.tokens = self.burst
        self._last = clock()

    def take(self, n: float = 1.0) -> bool:
        now = self.clock()
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
            self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class AdmissionController:
    """One per admitting role (leader/proxy/replica), attached as
    ``actor.admission`` so both transports find it with one attribute
    load. All methods run on the role's event loop -- no locks."""

    def __init__(self, options: AdmissionOptions, role: str = "",
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None):
        self.options = options
        self.role = role
        self.clock = clock
        self.metrics = metrics  # obs.RuntimeMetrics or None
        self.bucket = (TokenBucket(options.token_rate,
                                   options.token_burst, clock)
                       if options.token_rate else None)
        self.inflight = 0
        # CoDel state: sojourn-above-target bookkeeping.
        self._above_since: Optional[float] = None
        self.shedding = False
        self._last_feed = clock()
        # Counters (also mirrored to metrics when attached): cheap
        # plain ints readable by benches/tests without a collector.
        self.admitted = 0
        self.rejected: dict[str, int] = {}
        self.last_reason = 0

    # --- the admit decision ------------------------------------------------
    def admit(self, n: int = 1) -> bool:
        """Admit ``n`` client commands? False sets ``last_reason``.
        Order: shed mode (congestion beats rate), slot budget, bucket."""
        if self.shed_active():
            return self._reject(REASON_CODEL, n)
        limit = self.options.inflight_limit
        if limit and self.inflight + n > limit:
            return self._reject(REASON_INFLIGHT, n)
        if self.bucket is not None and not self.bucket.take(n):
            return self._reject(REASON_TOKENS, n)
        self.admitted += n
        if limit:
            self.inflight += n
        if self.metrics is not None:
            self.metrics.admission_admitted(n)
            if limit:
                self.metrics.admission_inflight(self.inflight)
        self.last_reason = 0
        return True

    def admit_up_to(self, n: int) -> int:
        """Admit as many of ``n`` client commands as the limits allow
        (0..n). A coalesced drain's array degrades gracefully: the
        prefix that fits the slot budget/bucket is served, the suffix
        is rejected -- all-or-nothing would collapse goodput the
        moment arrays outgrow the remaining budget. Rejection
        accounting for the suffix (with the binding constraint as the
        reason) happens here; ``last_reason`` reflects it."""
        if n <= 0:
            return 0
        if self.shed_active():
            self._reject(REASON_CODEL, n)
            return 0
        k = n
        reason = 0
        limit = self.options.inflight_limit
        if limit:
            avail = max(0, limit - self.inflight)
            if avail < k:
                k = avail
                reason = REASON_INFLIGHT
        if self.bucket is not None and k and not self.bucket.take(k):
            have = int(self.bucket.tokens)
            took = min(k, have)
            if took and self.bucket.take(took):
                pass
            else:
                took = 0
            if took < k:
                reason = REASON_TOKENS
            k = took
        if n - k:
            self._reject(reason or REASON_INFLIGHT, n - k)
        if k:
            self.admitted += k
            if limit:
                self.inflight += k
            if self.metrics is not None:
                self.metrics.admission_admitted(k)
                if limit:
                    self.metrics.admission_inflight(self.inflight)
            if k == n:
                self.last_reason = 0
        return k

    def _reject(self, reason: int, n: int) -> bool:
        self.last_reason = reason
        name = REASON_NAMES[reason]
        self.rejected[name] = self.rejected.get(name, 0) + n
        if self.metrics is not None:
            self.metrics.admission_rejected(name, n)
        return False

    # --- in-flight budget (watermark-tied) ---------------------------------
    def set_inflight(self, span: int) -> None:
        """The leader's live proposed-minus-chosen span: called on
        drains and ChosenWatermark advances, making the budget
        drain-granular (capacity frees when quorums land)."""
        self.inflight = max(0, span)
        if self.metrics is not None:
            self.metrics.admission_inflight(self.inflight)

    def release(self, n: int = 1) -> None:
        self.set_inflight(self.inflight - n)

    # --- CoDel-style drain-sojourn shedding --------------------------------
    def note_drain_delay(self, delay_s: float) -> None:
        """Feed one drain batch's sojourn (first delivery ->
        on_drain). Above target for a full interval -> shed mode;
        one under-target drain exits it (queues drain fast once
        arrivals stop, so recovery should too)."""
        target = self.options.codel_target_s
        if not target:
            return
        now = self.clock()
        self._last_feed = now
        if delay_s < target:
            self._above_since = None
            self.shedding = False
            return
        if self._above_since is None:
            self._above_since = now
        elif now - self._above_since >= self.options.codel_interval_s:
            self.shedding = True

    def shed_active(self) -> bool:
        """Is shed mode binding right now? Shed mode self-expires one
        CoDel interval after the last drain-sojourn observation:
        shedding every client frame pre-delivery also stops the drains
        that would report the under-target sojourn which exits shed
        mode, so without the expiry an actor whose inbound traffic is
        purely client-lane (a replica serving reads in a write-free
        period) latches shedding forever -- while the queue it was
        shedding for has long since emptied."""
        if not self.shedding:
            return False
        if (self.clock() - self._last_feed
                >= self.options.codel_interval_s):
            self.shedding = False
            self._above_since = None
        return self.shedding

    # --- bounded-inbox policy (transports call these) ----------------------
    def inbox_full(self, depth: int) -> bool:
        cap = self.options.inbox_capacity
        return bool(cap) and depth >= cap

    def note_inbox_depth(self, depth: int) -> None:
        if self.metrics is not None:
            self.metrics.admission_queue_depth(depth)

    def note_shed(self, policy: str, n: int = 1) -> None:
        name = f"shed_{policy}"
        self.rejected[name] = self.rejected.get(name, 0) + n
        if self.metrics is not None:
            self.metrics.admission_shed(policy, n)

    def retry_after_ms(self) -> int:
        return self.options.retry_after_ms


def reject_replies_for(message, retry_after_ms: int = 0,
                       reason: int = REASON_QUEUE) -> list:
    """Turn a refused client request into explicit ``Rejected``
    replies: [(client_address, Rejected)]. Handles the three shared
    request shapes (multipaxos + mencius); anything else (reads --
    which are rejected at role level where the command id is in hand)
    gets no wire reply here and falls back to client timeout."""
    name = type(message).__name__
    if name == "ClientRequest":
        cid = message.command.command_id
        return [(cid.client_address, Rejected(
            entries=((cid.client_pseudonym, cid.client_id),),
            retry_after_ms=retry_after_ms, reason=reason))]
    if name == "ClientRequestArray":
        # All commands in one array come from ONE client by
        # construction (the client stages its own writes).
        entries = tuple(
            (c.command_id.client_pseudonym, c.command_id.client_id)
            for c in message.commands)
        if not entries:
            return []
        return [(message.commands[0].command_id.client_address,
                 Rejected(entries=entries,
                          retry_after_ms=retry_after_ms, reason=reason))]
    if name == "IngestRun":
        # paxingest: a disseminator's run descriptor -- entries are
        # one-command batches spanning clients; prefer the zero-decode
        # column route, fall back to decoding (refusal is cold).
        from frankenpaxos_tpu_torch.ingest.columns import value_view

        view = value_view(message.values)
        if view is not None:
            return view.reject_entries(0, retry_after_ms, reason)
        per_client: dict = {}
        for value in message.values:
            for command in getattr(value, "commands", ()):
                cid = command.command_id
                per_client.setdefault(cid.client_address, []).append(
                    (cid.client_pseudonym, cid.client_id))
        return [(address, Rejected(entries=tuple(entries),
                                   retry_after_ms=retry_after_ms,
                                   reason=reason))
                for address, entries in per_client.items()]
    if name == "ClientRequestBatch":
        # A batcher's batch spans clients: group entries per client.
        per_client: dict = {}
        for command in message.batch.commands:
            cid = command.command_id
            per_client.setdefault(cid.client_address, []).append(
                (cid.client_pseudonym, cid.client_id))
        return [(address, Rejected(entries=tuple(entries),
                                   retry_after_ms=retry_after_ms,
                                   reason=reason))
                for address, entries in per_client.items()]
    return []
