"""WPaxos Client: object-keyed routing with steal-on-failover (the
port's copy of ``frankenpaxos_tpu/protocols/wpaxos/client.py``, on the
port's ``serve/backoff.py``).

The client keeps a per-group routing hint (home zone, highest ballot
seen) and sends each write to the hinted zone's leader. Resends ride
an RTT-adaptive timer (``geo.RttEstimator`` -- fixed timeouts
false-positive the moment links have real latency); after
``failover_after`` unanswered resends the client rotates to the next
zone's leader with ``steal=True``, making that leader steal the group
-- the liveness path for a dead home zone. ``WNotOwner`` redirects
(ballot-ordered, so a stale hint never overrides a newer one) repoint
the hint without burning the failover budget.

Latencies are recorded against the transport's VIRTUAL clock when one
exists (GeoSimTransport), so bench/geo_lt.py measures exact simulated
commit latency.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from frankenpaxos_tpu_torch.geo.rtt import RttEstimator
from frankenpaxos_tpu_torch.protocols.wpaxos.config import WPaxosConfig
from frankenpaxos_tpu_torch.protocols.wpaxos.messages import (
    Command,
    CommandId,
    WNotOwner,
    WReply,
    WRequest,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class WPaxosClientOptions:
    resend_period_s: float = 1.0
    #: Resends to one target before rotating zones with steal=True.
    failover_after: int = 2
    #: Adaptive resend deadlines from observed request RTTs.
    adaptive_timeouts: bool = True
    #: paxworld retry discipline (serve/backoff.py): total retries
    #: (timeout resends + Rejected backoffs) per op before the op
    #: concludes with RETRY_EXHAUSTED. 0 = unlimited (the pre-budget
    #: behavior every existing sim/bench keeps). When a budget is
    #: armed, write callbacks must accept the sentinel.
    retry_budget: int = 0
    #: Jittered exponential backoff applied on Rejected (a
    #: serve.backoff.Backoff); None keeps the adaptive resend timer's
    #: own pacing (the pre-paxworld behavior).
    reject_backoff: object = None
    #: This client's zone, stamped on every WRequest as
    #: ``origin_zone`` -- the adaptive-placement EWMA's feed
    #: (paxchaos). -1 (the default) stamps "unknown", which the
    #: placement policy ignores.
    zone: int = -1


@dataclasses.dataclass
class _Pending:
    command_id: CommandId
    group: int
    payload: bytes
    callback: Optional[Callable]
    target_zone: int
    resends: int = 0
    rejects: int = 0
    #: A Rejected arrived and the backoff timer is already rescheduled:
    #: a duplicate Rejected (original + resend both refused) must not
    #: double-consume the retry budget or re-widen the backoff.
    backoff_pending: bool = False
    steal: bool = False
    sent_at: float = 0.0
    first_sent_at: float = 0.0


class WPaxosClient(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: WPaxosConfig,
                 options: WPaxosClientOptions = WPaxosClientOptions(),
                 seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.options = options
        self.seed = seed
        # pseudonym -> next client_id (sequential per pseudonym).
        self._next_id: dict[int, int] = {}
        #: pseudonym -> in-flight op (one at a time per pseudonym; the
        #: harness's idle_writers contract).
        self.pending: dict[int, _Pending] = {}
        # group -> (home zone hint, ballot the hint is as-of).
        self.routing: dict[int, tuple] = {
            g: (home, home)
            for g, home in enumerate(config.initial_home)}
        self.rtt = RttEstimator()
        self._timers: dict[int, object] = {}
        # Virtual clock when the transport has one (GeoSimTransport:
        # exact simulated latencies); the wall clock otherwise -- a
        # constant would feed 0-RTT samples into the estimator and
        # collapse every resend deadline to its floor (a resend storm
        # on real TCP).
        if hasattr(transport, "now"):
            self._clock = lambda: transport.now
        else:
            import time

            self._clock = time.monotonic
        #: (group, target_zone, latency_s) per completed op -- the
        #: bench's measurement surface.
        self.latencies: list[tuple] = []
        #: RETRY_EXHAUSTED conclusions (the scenario matrix's loud,
        #: bounded degradation path).
        self.giveups = 0
        # String-seeded (sha512, process-stable) -- only the Rejected
        # backoff jitter draws from it, so budget-less clients replay
        # byte-identically to pre-paxworld.
        self._rng = random.Random(f"wpaxos-client|{address}|{seed}")

    # --- the write API ------------------------------------------------------
    def write(self, pseudonym: int, payload: bytes,
              callback: Optional[Callable] = None,
              key: Optional[bytes] = None) -> None:
        if pseudonym in self.pending:
            raise ValueError(f"pseudonym {pseudonym} already has an op")
        group = self.config.group_of_key(key if key is not None
                                         else payload)
        client_id = self._next_id.get(pseudonym, 0)
        self._next_id[pseudonym] = client_id + 1
        cid = CommandId(client_address=self.address,
                        client_pseudonym=pseudonym,
                        client_id=client_id)
        now = self._clock()
        op = _Pending(command_id=cid, group=group, payload=payload,
                      callback=callback,
                      target_zone=self.routing[group][0],
                      sent_at=now, first_sent_at=now)
        self.pending[pseudonym] = op
        self._send(op)
        self._restart_timer(pseudonym)

    def _send(self, op: _Pending) -> None:
        op.sent_at = self._clock()
        self.send(
            self.config.leader_addresses[op.target_zone],
            WRequest(group=op.group,
                     command=Command(command_id=op.command_id,
                                     command=op.payload),
                     steal=op.steal,
                     origin_zone=self.options.zone))

    def _restart_timer(self, pseudonym: int, resends: int = 0) -> None:
        delay = self.options.resend_period_s
        if self.options.adaptive_timeouts:
            delay = max(self.rtt.timeout(delay), 1e-3)
        # Exponential backoff on consecutive unanswered resends: a
        # steal in progress (or a duel resolving) needs WIDENING
        # windows, not a metronome feeding it fresh steal=True
        # requests every tick.
        delay *= min(8.0, 1.5 ** resends)
        timer = self._timers.get(pseudonym)
        if timer is None:
            timer = self.timer(f"resendWrite-{pseudonym}", delay,
                               lambda p=pseudonym: self._resend(p))
            self._timers[pseudonym] = timer
        else:
            timer.stop()
            timer.set_delay(delay)
        timer.start()

    def _resend(self, pseudonym: int) -> None:
        op = self.pending.get(pseudonym)
        if op is None:
            return
        op.backoff_pending = False
        budget = self.options.retry_budget
        if budget and op.resends + op.rejects >= budget:
            self._giveup(pseudonym)
            return
        op.resends += 1
        if op.resends % self.options.failover_after == 0:
            # The hinted zone is not answering: rotate and ask the
            # next zone's leader to steal the object group.
            op.target_zone = (op.target_zone + 1) \
                % self.config.num_zones
            op.steal = True
        self._send(op)
        self._restart_timer(pseudonym, resends=op.resends)

    def _giveup(self, pseudonym: int) -> None:
        """Retry budget exhausted: conclude LOUDLY with the sentinel
        -- never a silent wedge (docs/SERVING.md discipline)."""
        from frankenpaxos_tpu_torch.serve.backoff import RETRY_EXHAUSTED

        op = self.pending.pop(pseudonym)
        timer = self._timers.get(pseudonym)
        if timer is not None:
            timer.stop()
        self.giveups += 1
        if op.callback is not None:
            op.callback(RETRY_EXHAUSTED)

    # --- handlers -----------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, WReply):
            self._handle_reply(src, message)
        elif isinstance(message, WNotOwner):
            self._handle_not_owner(src, message)
        elif type(message).__name__ == "Rejected":
            self._handle_rejected(src, message)
        else:
            self.logger.fatal(f"unexpected client message {message!r}")

    def _handle_reply(self, src: Address, m: WReply) -> None:
        pseudonym = m.command_id.client_pseudonym
        op = self.pending.get(pseudonym)
        if op is None or op.command_id != m.command_id:
            return  # duplicate ack for a completed op
        del self.pending[pseudonym]
        timer = self._timers.get(pseudonym)
        if timer is not None:
            timer.stop()
        now = self._clock()
        self.rtt.observe(now - op.sent_at)
        self.latencies.append((op.group, op.target_zone,
                               now - op.first_sent_at))
        if op.callback is not None:
            op.callback(m.result)

    def _handle_not_owner(self, src: Address, m: WNotOwner) -> None:
        hint_zone, hint_ballot = self.routing.get(
            m.group, (m.home_zone, -1))
        if m.ballot >= hint_ballot:
            self.routing[m.group] = (m.home_zone, m.ballot)
        op = self.pending.get(m.command_id.client_pseudonym)
        if op is None or op.command_id != m.command_id:
            return
        if not op.steal:
            # Follow the redirect immediately (does not burn the
            # failover budget); a steal-mode op stays put -- the
            # stealing leader will answer.
            op.target_zone = self.routing[op.group][0]
            self._send(op)
            self._restart_timer(m.command_id.client_pseudonym)

    def _handle_rejected(self, src: Address, m) -> None:
        """paxload admission refusal: the leader is ALIVE but
        saturated -- back off (jittered exponential when
        ``reject_backoff`` is armed, honoring the server's
        retry_after hint as a floor), consume the retry budget, and
        retry the SAME leader; never treat it as a death signal (no
        steal, no failover rotation).

        (Known accepted duplication: this budget/backoff_pending/
        RETRY_EXHAUSTED state machine mirrors protocols/craq.py and
        the multipaxos/mencius retry discipline, pending the
        protocol-neutral client-layer refactor on the ROADMAP --
        change one, check the others.)"""
        for pseudonym, client_id in m.entries:
            op = self.pending.get(pseudonym)
            if op is None or op.command_id.client_id != client_id:
                continue
            op.steal = False
            if op.backoff_pending:
                continue  # duplicate refusal of one attempt
            op.rejects += 1
            budget = self.options.retry_budget
            if budget and op.resends + op.rejects >= budget:
                self._giveup(pseudonym)
                continue
            # Set UNCONDITIONALLY (cleared when the resend timer
            # fires): with no backoff armed, a duplicate refusal of
            # one attempt (original + resend both refused) must still
            # not double-consume the budget.
            op.backoff_pending = True
            backoff = self.options.reject_backoff
            if backoff is None:
                continue  # the running resend timer paces the retry
            delay = backoff.delay_s(
                op.rejects - 1, self._rng,
                floor_s=getattr(m, "retry_after_ms", 0) / 1000.0)
            timer = self._timers.get(pseudonym)
            if timer is not None:
                timer.stop()
                timer.set_delay(delay)
                timer.start()
