"""MultiPaxos Client (the port's copy of
``frankenpaxos_tpu/protocols/multipaxos/client.py``).

Reference behavior: multipaxos/Client.scala:120-1060. Per-pseudonym
pending-operation state machines with resend timers:

  * writes (writeImpl, Client.scala:563-603): ClientRequest to a random
    batcher (or the round's leader when there are no batchers); NotLeader
    bounces trigger LeaderInfoRequest round discovery.
  * linearizable reads (readImpl + handleMaxSlotReply,
    Client.scala:604-700, 851-933): MaxSlotRequest to f+1 of a random
    acceptor group (or a grid read quorum); on quorum, read at
    ``max_slot + num_groups - 1`` (grid: ``max_slot``) at a random
    replica, deferred there until executed.
  * sequential reads (Client.scala:697+): read at the largest slot this
    pseudonym has seen.
  * eventual reads (Client.scala:739+): straight to a random replica.

With ingest batchers deployed, writes go through them on a consistent
ring (``ingest/fan.py``): a session pins to one batcher, a timeout
suspects that batcher only, and a ``Rejected`` from one batcher floors
the backoff against that batcher only. With read batchers deployed, a
linearizable read goes to a random one, which amortizes the quorum round.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from frankenpaxos_tpu_torch.protocols.multipaxos.config import MultiPaxosConfig
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    ClientReply,
    ClientReplyArray,
    ClientRequest,
    ClientRequestArray,
    Command,
    CommandId,
    EventualReadRequest,
    LeaderInfoReplyClient,
    LeaderInfoRequestClient,
    MaxSlotReply,
    MaxSlotRequest,
    NotLeaderClient,
    ReadReply,
    ReadRequest,
    SequentialReadRequest,
)
from frankenpaxos_tpu_torch.roundsystem import ClassicRoundRobin
from frankenpaxos_tpu_torch.runs.client import RetryAdmissionMixin, StagedWriteMixin
from frankenpaxos_tpu_torch.runs.routing import (
    make_fan_router,
    pick_array_destination,
    pick_request_destination,
)
from frankenpaxos_tpu_torch.runtime import Actor, Collectors, FakeCollectors, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.serve.backoff import Backoff
from frankenpaxos_tpu_torch.serve.messages import Rejected

Callback = Callable[[bytes], None]


@dataclasses.dataclass(frozen=True)
class ClientOptions:
    resend_client_request_period_s: float = 10.0
    resend_max_slot_requests_period_s: float = 10.0
    resend_read_request_period_s: float = 10.0
    # Performance-debugging unsafe modes (Client.scala:42-53).
    unsafe_read_at_first_slot: bool = False
    unsafe_read_at_i: bool = False
    flush_writes_every_n: int = 1
    flush_reads_every_n: int = 1
    measure_latencies: bool = True
    # Coalesce this event-loop pass's writes into ONE ClientRequestArray
    # to the leader (each command still gets its own slot -- see
    # messages.ClientRequestArray). Flushed by on_drain / flush_writes;
    # resends still go per-request. Bypasses batchers: the array is
    # transport-level coalescing, not slot sharing.
    coalesce_writes: bool = False
    # paxload retry discipline (serve/backoff.py, docs/SERVING.md).
    # retry_budget = 0 keeps the pre-paxload behavior: unlimited
    # resends, Rejected treated as an immediate-backoff retry with no
    # cap. With a budget, EVERY retry (Rejected backoff or timeout
    # failover) consumes it, and exhaustion completes the operation
    # with serve.RETRY_EXHAUSTED -- no request ever wedges silently.
    retry_budget: int = 0
    backoff: Backoff = Backoff()


@dataclasses.dataclass
class _PendingWrite:
    id: int
    command: bytes
    callback: Callback
    resend: object
    attempts: int = 0
    backoff_pending: bool = False


@dataclasses.dataclass
class _MaxSlot:
    # No backoff_pending: while the state is _MaxSlot the only
    # outstanding requests are MaxSlotRequests to acceptors, which
    # carry no admission controller and never draw a Rejected (the
    # state becomes _PendingRead in the same handler that sends the
    # rejectable ReadRequest).
    id: int
    command: bytes
    callback: Callback
    replies: dict[tuple[int, int], int]
    resend: object
    attempts: int = 0


@dataclasses.dataclass
class _PendingRead:
    id: int
    command: bytes
    callback: Callback
    resend: object
    attempts: int = 0
    backoff_pending: bool = False
    # The in-flight read request + target replica, kept so a Rejected
    # read can be re-issued after backoff without re-deriving the slot.
    request: object = None
    replica: object = None


class Client(RetryAdmissionMixin, StagedWriteMixin, Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MultiPaxosConfig,
                 options: ClientOptions = ClientOptions(), seed: int = 0,
                 collectors: Collectors | None = None):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.options = options
        self.rng = random.Random(seed)
        collectors = collectors or FakeCollectors()
        self.metrics_replies = collectors.counter(
            "multipaxos_client_replies_received_total")
        self.round_system = ClassicRoundRobin(config.num_leaders)
        self.grid = config.quorum_grid() if config.flexible else None
        self._row_size = len(config.acceptor_addresses[0])
        self.round = 0
        self.ids: dict[int, int] = {}               # pseudonym -> next id
        self.states: dict[int, object] = {}         # pseudonym -> pending op
        self.largest_seen_slots: dict[int, int] = {}  # pseudonym -> slot
        # runs/ retry discipline + coalesce_writes staging.
        self._retry_budget = options.retry_budget
        self._retry_backoff = options.backoff
        self._init_staging()
        # paxfan: consistent ring over the ingest-batcher tier -- a
        # session key (this client, pseudonym) pins to one shard; a
        # resend timeout suspects THAT shard (its keys fail over to
        # the clockwise survivors, everyone else stays pinned); a
        # Rejected floors backoff against the shedding shard only.
        self._fan = make_fan_router(
            config,
            revive_after_s=options.resend_client_request_period_s)
        # One reusable resend timer per pseudonym (vs a fresh Timer per
        # write): timer construction was a measurable per-command cost
        # at drain widths in the thousands.
        self._write_timers: dict[int, object] = {}

    # --- public API -------------------------------------------------------
    def write(self, pseudonym: int, command: bytes,
              callback: Optional[Callback] = None) -> None:
        self._check_idle(pseudonym)
        callback = callback or (lambda _: None)
        id = self.ids.get(pseudonym, 0)
        request = ClientRequest(Command(
            CommandId(self.address, pseudonym, id), command))
        if self.options.coalesce_writes:
            # Stage for the end-of-pass array flush (runs/client.py:
            # a burst of call_soon'd closed loops, or reissues inside
            # a delivery drain, coalesce into one array).
            self._stage_write(request.command)
        else:
            self._send_client_request(request)
        timer = self._write_resend_timer(pseudonym)
        timer.start()
        self.states[pseudonym] = _PendingWrite(id, command, callback, timer)
        self.ids[pseudonym] = id + 1

    def _write_resend_timer(self, pseudonym: int):
        timer = self._write_timers.get(pseudonym)
        if timer is None:
            def resend():
                # Reads the CURRENT pending write (the timer outlives
                # individual operations). A timeout is the FAILOVER
                # signal (the leader may be gone) -- re-send on the
                # normal discovery path; with a retry budget set, the
                # failover consumes it like any other retry.
                state = self.states.get(pseudonym)
                if isinstance(state, _PendingWrite):
                    if not self._consume_retry(pseudonym, state,
                                               "failover"):
                        return
                    if self._fan is not None:
                        # paxfan: the timeout suspects THIS key's
                        # shard, so the resend below routes past it
                        # while every other key stays pinned.
                        self._fan.suspect_key(self.address, pseudonym)
                    self._send_client_request(ClientRequest(Command(
                        CommandId(self.address, pseudonym, state.id),
                        state.command)))
                    timer.start()

            timer = self.timer(
                f"resendWrite{pseudonym}",
                self.options.resend_client_request_period_s, resend)
            self._write_timers[pseudonym] = timer
        return timer

    def read(self, pseudonym: int, command: bytes,
             callback: Optional[Callback] = None) -> None:
        """Linearizable quorum read."""
        self._check_idle(pseudonym)
        callback = callback or (lambda _: None)
        id = self.ids.get(pseudonym, 0)
        if self.config.num_read_batchers > 0:
            # Let a read batcher amortize the quorum round
            # (Client.scala:665-690).
            read_request = ReadRequest(
                slot=-1,
                command=Command(CommandId(self.address, pseudonym, id),
                                command))
            batcher = self.config.read_batcher_addresses[
                self.rng.randrange(self.config.num_read_batchers)]
            self.send(batcher, read_request)

            def resend_batched():
                state = self.states.get(pseudonym)
                if not isinstance(state, _PendingRead) \
                        or not self._consume_retry(pseudonym, state,
                                                   "failover"):
                    return
                self.send(batcher, read_request)
                timer.start()

            timer = self.timer(
                f"resendRead{pseudonym}",
                self.options.resend_read_request_period_s, resend_batched)
            timer.start()
            self.states[pseudonym] = _PendingRead(id, command, callback,
                                                  timer,
                                                  request=read_request,
                                                  replica=batcher)
            self.ids[pseudonym] = id + 1
            return
        request = MaxSlotRequest(CommandId(self.address, pseudonym, id))
        if not self.config.flexible:
            group_index = self.rng.randrange(self.config.num_acceptor_groups)
            group = list(self.config.acceptor_addresses[group_index])
            quorum = self.rng.sample(group, self.config.f + 1)
            resend_to = group
        else:
            quorum = [self._acceptor_address(flat)
                      for flat in self.grid.random_read_quorum(self.rng)]
            resend_to = [a for g in self.config.acceptor_addresses
                         for a in g]
        for acceptor in quorum:
            self.send(acceptor, request)

        def resend():
            state = self.states.get(pseudonym)
            if not isinstance(state, _MaxSlot) \
                    or not self._consume_retry(pseudonym, state,
                                               "failover"):
                return
            for acceptor in resend_to:
                self.send(acceptor, request)
            timer.start()

        timer = self.timer(f"resendMaxSlot{pseudonym}",
                           self.options.resend_max_slot_requests_period_s,
                           resend)
        timer.start()
        self.states[pseudonym] = _MaxSlot(id, command, callback, {}, timer)
        self.ids[pseudonym] = id + 1

    def sequential_read(self, pseudonym: int, command: bytes,
                        callback: Optional[Callback] = None) -> None:
        self._check_idle(pseudonym)
        callback = callback or (lambda _: None)
        id = self.ids.get(pseudonym, 0)
        slot = self.largest_seen_slots.get(pseudonym, -1)
        request = SequentialReadRequest(
            slot=slot,
            command=Command(CommandId(self.address, pseudonym, id), command))
        replica = self._random_replica()
        self.send(replica, request)
        timer = self._make_read_resend_timer(pseudonym, replica, request)
        self.states[pseudonym] = _PendingRead(id, command, callback, timer,
                                              request=request,
                                              replica=replica)
        self.ids[pseudonym] = id + 1

    def eventual_read(self, pseudonym: int, command: bytes,
                      callback: Optional[Callback] = None) -> None:
        self._check_idle(pseudonym)
        callback = callback or (lambda _: None)
        id = self.ids.get(pseudonym, 0)
        request = EventualReadRequest(
            Command(CommandId(self.address, pseudonym, id), command))
        replica = self._random_replica()
        self.send(replica, request)
        timer = self._make_read_resend_timer(pseudonym, replica, request)
        self.states[pseudonym] = _PendingRead(id, command, callback, timer,
                                              request=request,
                                              replica=replica)
        self.ids[pseudonym] = id + 1

    # --- helpers ----------------------------------------------------------
    def _check_idle(self, pseudonym: int) -> None:
        if pseudonym in self.states:
            raise RuntimeError(
                f"pseudonym {pseudonym} already has a pending operation; a "
                f"client can have one pending operation per pseudonym")

    def _acceptor_address(self, flat: int) -> Address:
        return self.config.acceptor_addresses[flat // self._row_size][
            flat % self._row_size]

    def _random_replica(self) -> Address:
        return self.config.replica_addresses[
            self.rng.randrange(self.config.num_replicas)]

    def _round_leader(self) -> Address:
        return self.config.leader_addresses[
            self.round_system.leader(self.round)]

    def _send_client_request(self, request: ClientRequest) -> None:
        # runs/routing ladder: ingest disseminators absorb the fan-in
        # (ring-pinned per session -- a dead batcher costs a retry
        # plus a failover to its clockwise survivor, not a wedge) >
        # batchers > the round's leader.
        dst = pick_request_destination(
            self.config, self.rng, self._round_leader, fan=self._fan,
            key=(self.address, request.command.command_id.client_pseudonym))
        self.send(dst, request)

    def _flush_staged(self, staged: list) -> None:
        """Ship writes staged by ``coalesce_writes`` as one array (to
        an ingest disseminator when the config deploys them, else
        straight to the round's leader). The array spans many of this
        client's pseudonyms, so it rides the client-scoped ring key
        (pseudonym -1)."""
        dst = pick_array_destination(self.config, self.rng,
                                     self._round_leader, fan=self._fan,
                                     key=(self.address, -1))
        self.send(dst, ClientRequestArray(commands=tuple(staged)))

    def _note_shed_source(self, src: Address, rejected) -> float:
        """Attribute a Rejected to its ingest shard: floor reissue
        backoff against THAT shard only (runs/client.py hook)."""
        if self._fan is None:
            return 0.0
        from frankenpaxos_tpu_torch.ingest.fan import shard_of_address

        shard = shard_of_address(self.config, src)
        if shard < 0:
            return 0.0
        self._fan.note_shed(shard, rejected.retry_after_ms)
        return self._fan.floor_delay_s(shard)

    def _make_read_resend_timer(self, pseudonym: int, replica: Address,
                                request) -> object:
        def resend():
            state = self.states.get(pseudonym)
            if not isinstance(state, _PendingRead) \
                    or not self._consume_retry(pseudonym, state,
                                               "failover"):
                return
            self.send(replica, request)
            timer.start()

        timer = self.timer(f"resendRead{pseudonym}",
                           self.options.resend_read_request_period_s, resend)
        timer.start()
        return timer

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, ClientReply):
            self._handle_client_reply(src, message)
        elif isinstance(message, ClientReplyArray):
            self._handle_client_reply_array(src, message)
        elif isinstance(message, MaxSlotReply):
            self._handle_max_slot_reply(src, message)
        elif isinstance(message, ReadReply):
            self._handle_read_reply(src, message)
        elif isinstance(message, NotLeaderClient):
            self._handle_not_leader(src, message)
        elif isinstance(message, LeaderInfoReplyClient):
            self._handle_leader_info(src, message)
        elif isinstance(message, Rejected):
            self._handle_rejected(src, message)
        else:
            self.logger.fatal(f"unexpected client message {message!r}")

    # --- retry discipline (runs/client.py) --------------------------------
    # Rejected handling + backoff/reissue scheduling live in
    # RetryAdmissionMixin; only the operation re-send is ours.
    def _reissue(self, pseudonym: int, state) -> None:
        if isinstance(state, _PendingWrite):
            request = ClientRequest(Command(
                CommandId(self.address, pseudonym, state.id),
                state.command))
            if self.options.coalesce_writes:
                # Re-enter through the STAGED path: a burst of backoff
                # expiries coalesces back into one ClientRequestArray
                # instead of a retry storm of singles (the storm would
                # re-congest the very leader that just shed us).
                self._stage_write(request.command)
            else:
                self._send_client_request(request)
        elif isinstance(state, _PendingRead) and state.request is not None:
            self.send(state.replica, state.request)

    def _handle_client_reply(self, src: Address, reply: ClientReply) -> None:
        pseudonym = reply.command_id.client_pseudonym
        state = self.states.get(pseudonym)
        if not isinstance(state, _PendingWrite) \
                or reply.command_id.client_id != state.id:
            self.logger.debug(f"stale ClientReply {reply}")
            return
        state.resend.stop()
        self.largest_seen_slots[pseudonym] = max(
            self.largest_seen_slots.get(pseudonym, -1), reply.slot)
        del self.states[pseudonym]
        self.metrics_replies.inc()
        state.callback(reply.result)

    def _handle_client_reply_array(self, src: Address,
                                   array: ClientReplyArray) -> None:
        """A replica's whole drain of replies to this client in one
        message; per-entry resolution mirrors _handle_client_reply."""
        for pseudonym, client_id, slot, result in array.entries:
            state = self.states.get(pseudonym)
            if not isinstance(state, _PendingWrite) \
                    or client_id != state.id:
                self.logger.debug(
                    f"stale reply-array entry for pseudonym {pseudonym}")
                continue
            state.resend.stop()
            self.largest_seen_slots[pseudonym] = max(
                self.largest_seen_slots.get(pseudonym, -1), slot)
            del self.states[pseudonym]
            self.metrics_replies.inc()
            state.callback(result)

    def _handle_max_slot_reply(self, src: Address,
                               reply: MaxSlotReply) -> None:
        pseudonym = reply.command_id.client_pseudonym
        state = self.states.get(pseudonym)
        if not isinstance(state, _MaxSlot) \
                or reply.command_id.client_id != state.id:
            self.logger.debug(f"stale MaxSlotReply {reply}")
            return
        state.replies[(reply.group_index, reply.acceptor_index)] = reply.slot
        if not self.config.flexible:
            if len(state.replies) < self.config.f + 1:
                return
        else:
            flat = {g * self._row_size + i for g, i in state.replies}
            if not self.grid.is_superset_of_read_quorum(flat):
                return

        max_slot = max(state.replies.values())
        if self.options.unsafe_read_at_first_slot:
            slot = 0
        elif self.config.flexible or self.options.unsafe_read_at_i:
            slot = max_slot
        else:
            # Slots round-robin over groups; the true global max voted slot
            # can exceed this group's by at most num_groups - 1.
            slot = max_slot + self.config.num_acceptor_groups - 1
        request = ReadRequest(
            slot=slot,
            command=Command(CommandId(self.address, pseudonym, state.id),
                            state.command))
        replica = self._random_replica()
        self.send(replica, request)
        state.resend.stop()
        timer = self._make_read_resend_timer(pseudonym, replica, request)
        self.states[pseudonym] = _PendingRead(state.id, state.command,
                                              state.callback, timer,
                                              attempts=state.attempts,
                                              request=request,
                                              replica=replica)

    def _handle_read_reply(self, src: Address, reply: ReadReply) -> None:
        pseudonym = reply.command_id.client_pseudonym
        state = self.states.get(pseudonym)
        if not isinstance(state, _PendingRead) \
                or reply.command_id.client_id != state.id:
            self.logger.debug(f"stale ReadReply {reply}")
            return
        state.resend.stop()
        self.largest_seen_slots[pseudonym] = max(
            self.largest_seen_slots.get(pseudonym, -1), reply.slot)
        del self.states[pseudonym]
        state.callback(reply.result)

    def _handle_not_leader(self, src: Address, _: NotLeaderClient) -> None:
        for leader in self.config.leader_addresses:
            self.send(leader, LeaderInfoRequestClient())

    def _handle_leader_info(self, src: Address,
                            reply: LeaderInfoReplyClient) -> None:
        if reply.round <= self.round:
            return
        self.round = reply.round
        # Re-send every pending write to the new round's leader
        # (Client.scala handleLeaderInfoReplyClient).
        for pseudonym, state in self.states.items():
            if isinstance(state, _PendingWrite):
                self._send_client_request(ClientRequest(Command(
                    CommandId(self.address, pseudonym, state.id),
                    state.command)))
