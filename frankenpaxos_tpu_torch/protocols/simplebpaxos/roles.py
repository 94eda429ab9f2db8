"""SimpleBPaxos Leader, DepServiceNode, Proposer, and Acceptor.

The port's copy of ``frankenpaxos_tpu/protocols/simplebpaxos/roles.py``,
with ``dep_backend="cuda"`` in place of the reference's ``"tpu"``: the
Leader unions its dep-service quorum's replies on K10
(``ops/csrc/depset.cu``) on its ``device``.

Reference behavior: simplebpaxos/Leader.scala:26-280 (assign vertex, ask
dep service quorum, union deps, hand to proposer),
DepServiceNode.scala:27-230 (conflict-index lookup with per-vertex
cache), Proposer.scala:24-540 (per-vertex Paxos with round-0 phase-1
skip, vertex-rotated round robin, nack -> higher-round phase 1, noop
recovery), Acceptor.scala:22-200 (per-vertex (round, vote) state).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.protocols.epaxos import device_deps
from frankenpaxos_tpu_torch.protocols.simplebpaxos.messages import (
    ClientRequest,
    Commit,
    DependencyReply,
    DependencyRequest,
    Nack,
    NOOP,
    Noop,
    Phase1a,
    Phase1b,
    Phase2a,
    Phase2b,
    Propose,
    Recover,
    SimpleBPaxosConfig,
    VertexId,
    VertexIdPrefixSet,
    VoteValue,
)
from frankenpaxos_tpu_torch.roundsystem import RotatedClassicRoundRobin
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.statemachine import StateMachine
from frankenpaxos_tpu_torch.utils.topk import TUPLE_VERTEX_LIKE

VERTEX_LIKE = TUPLE_VERTEX_LIKE


class BPaxosLeader(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: SimpleBPaxosConfig,
                 resend_deps_period_s: float = 10.0, seed: int = 0,
                 dep_backend: str = "host", device=None):
        if dep_backend not in ("host", "cuda"):
            raise ValueError(f"dep_backend must be 'host' or 'cuda', got "
                             f"{dep_backend!r}")
        # K10's device, resolved now: "cuda" without a GPU (and no device
        # named) fails at construction, not at the first vertex.
        self.device = (resolve_device(device) if dep_backend == "cuda"
                       else None)
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.rng = random.Random(seed)
        self.resend_deps_period_s = resend_deps_period_s
        self.index = list(config.leader_addresses).index(address)
        self.next_vertex_id = 0
        # "host": per-reply VertexIdPrefixSet add_all loops. "cuda": the
        # dep-service quorum union as one K10 launch (VertexIdPrefixSet
        # IS InstancePrefixSet, so the EPaxos device_deps bridge applies
        # unchanged).
        self.dep_backend = dep_backend
        # vertex -> ("waiting", command, {node_index: reply}, timer)
        #         | ("proposed",)
        self.states: dict[VertexId, object] = {}

    def receive(self, src: Address, message) -> None:
        if isinstance(message, ClientRequest):
            self._handle_client_request(src, message)
        elif isinstance(message, DependencyReply):
            self._handle_dependency_reply(src, message)
        else:
            self.logger.fatal(f"unexpected leader message {message!r}")

    def _handle_client_request(self, src: Address,
                               request: ClientRequest) -> None:
        self._start_vertex(request.command)

    def _start_vertex(self, command) -> VertexId:
        """Allocate a vertex for ``command`` and ask a dep-service
        quorum for its dependencies (Leader.scala:120-180). Subclasses
        reuse this for non-client proposals (snapshot vertices)."""
        vertex_id = VertexId(self.index, self.next_vertex_id)
        self.next_vertex_id += 1
        dep_request = DependencyRequest(vertex_id=vertex_id,
                                        command=command)
        targets = list(self.config.dep_service_node_addresses)[
            :self.config.quorum_size]
        self.broadcast(targets, dep_request)

        def resend():
            self.broadcast(self.config.dep_service_node_addresses,
                           dep_request)
            timer.start()

        timer = self.timer(f"resendDeps {vertex_id}",
                           self.resend_deps_period_s, resend)
        timer.start()
        self.states[vertex_id] = ["waiting", command, {}, timer]
        return vertex_id

    def _handle_dependency_reply(self, src: Address,
                                 reply: DependencyReply) -> None:
        state = self.states.get(reply.vertex_id)
        if not (isinstance(state, list) and state[0] == "waiting"):
            self.logger.debug(f"DependencyReply for {reply.vertex_id} "
                              f"ignored")
            return
        state[2][reply.dep_service_node_index] = reply
        if len(state[2]) < self.config.quorum_size:
            return
        if self.dep_backend == "cuda":
            dependencies = device_deps.union_many(
                [r.dependencies for r in state[2].values()],
                len(self.config.leader_addresses), device=self.device,
                metrics=self.transport.runtime_metrics)
        else:
            dependencies = VertexIdPrefixSet(
                len(self.config.leader_addresses))
            for r in state[2].values():
                dependencies.add_all(r.dependencies)
        state[3].stop()
        self.send(self.config.proposer_addresses[self.index],
                  Propose(vertex_id=reply.vertex_id, command=state[1],
                          dependencies=dependencies))
        self.states[reply.vertex_id] = ("proposed",)


class BPaxosDepServiceNode(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: SimpleBPaxosConfig,
                 state_machine: StateMachine, top_k: int = 1):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.index = list(config.dep_service_node_addresses).index(address)
        self.conflict_index = state_machine.top_k_conflict_index(
            top_k, len(config.leader_addresses), VERTEX_LIKE)
        self.top_k = top_k
        # Deps must be deterministic per vertex across re-asks
        # (DepServiceNode.scala:130-136).
        self.dependencies_cache: dict[VertexId, VertexIdPrefixSet] = {}

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, DependencyRequest):
            self.logger.fatal(f"unexpected dep service message {message!r}")
        vertex_id = message.vertex_id
        dependencies = self.dependencies_cache.get(vertex_id)
        if dependencies is None:
            dependencies = self._compute_dependencies(vertex_id,
                                                      message.command)
            self.dependencies_cache[vertex_id] = dependencies
        self.send(src, DependencyReply(
            vertex_id=vertex_id, dep_service_node_index=self.index,
            dependencies=dependencies.copy()))

    def _compute_dependencies(self, vertex_id: VertexId,
                              command) -> VertexIdPrefixSet:
        """Conflict-index lookup for a new vertex; cached by receive so
        re-asks are deterministic. Subclasses extend (snapshot deps)."""
        payload = command.command
        if self.top_k == 1:
            dependencies = VertexIdPrefixSet.from_top_one(
                self.conflict_index.get_top_one_conflicts(payload))
        else:
            dependencies = VertexIdPrefixSet.from_top_k(
                self.conflict_index.get_top_k_conflicts(payload))
        dependencies.subtract_one(vertex_id)
        self.conflict_index.put(vertex_id, payload)
        return dependencies


@dataclasses.dataclass
class _Phase1State:
    round: int
    value: VoteValue
    phase1bs: dict[int, Phase1b]
    resend: object


@dataclasses.dataclass
class _Phase2State:
    round: int
    value: VoteValue
    phase2bs: dict[int, Phase2b]
    resend: object


@dataclasses.dataclass
class _ChosenState:
    value: VoteValue


class BPaxosProposer(Actor):
    """Per-vertex consensus. The round system is rotated so the vertex's
    own leader owns round 0 and can skip phase 1
    (Proposer.scala:151-216)."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: SimpleBPaxosConfig,
                 resend_period_s: float = 10.0, seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.rng = random.Random(seed)
        self.resend_period_s = resend_period_s
        self.index = list(config.proposer_addresses).index(address)
        self.states: dict[VertexId, object] = {}

    def _round_system(self, vertex_id: VertexId):
        return RotatedClassicRoundRobin(len(self.config.leader_addresses),
                                        vertex_id.replica_index)

    def _make_resend_timer(self, name: str, message) -> object:
        def resend():
            self.broadcast(self.config.acceptor_addresses, message)
            timer.start()

        timer = self.timer(name, self.resend_period_s, resend)
        timer.start()
        return timer

    def _propose_impl(self, vertex_id: VertexId, command_or_noop,
                      dependencies: VertexIdPrefixSet) -> None:
        if vertex_id in self.states:
            self.logger.debug(f"already proposing {vertex_id}")
            return
        value = VoteValue(command_or_noop, dependencies)
        round = self._round_system(vertex_id).next_classic_round(
            self.index, -1)
        targets = list(self.config.acceptor_addresses)[
            :self.config.quorum_size]
        if round == 0:
            phase2a = Phase2a(vertex_id=vertex_id, round=round,
                              vote_value=value)
            self.broadcast(targets, phase2a)
            self.states[vertex_id] = _Phase2State(
                round, value, {},
                self._make_resend_timer(f"resendPhase2a {vertex_id}",
                                        phase2a))
        else:
            phase1a = Phase1a(vertex_id=vertex_id, round=round)
            self.broadcast(targets, phase1a)
            self.states[vertex_id] = _Phase1State(
                round, value, {},
                self._make_resend_timer(f"resendPhase1a {vertex_id}",
                                        phase1a))

    def receive(self, src: Address, message) -> None:
        if isinstance(message, Propose):
            self._propose_impl(message.vertex_id, message.command,
                               message.dependencies)
        elif isinstance(message, Phase1b):
            self._handle_phase1b(src, message)
        elif isinstance(message, Phase2b):
            self._handle_phase2b(src, message)
        elif isinstance(message, Nack):
            self._handle_nack(src, message)
        elif isinstance(message, Recover):
            self._handle_recover(src, message)
        else:
            self.logger.fatal(f"unexpected proposer message {message!r}")

    def _handle_phase1b(self, src: Address, phase1b: Phase1b) -> None:
        state = self.states.get(phase1b.vertex_id)
        if not isinstance(state, _Phase1State):
            return
        if phase1b.round != state.round:
            self.logger.check_lt(phase1b.round, state.round)
            return
        state.phase1bs[phase1b.acceptor_id] = phase1b
        if len(state.phase1bs) < self.config.quorum_size:
            return
        max_vote_round = max(r.vote_round for r in state.phase1bs.values())
        if max_vote_round == -1:
            proposal = state.value
        else:
            proposal = next(r.vote_value for r in state.phase1bs.values()
                            if r.vote_round == max_vote_round)
        phase2a = Phase2a(vertex_id=phase1b.vertex_id, round=state.round,
                          vote_value=proposal)
        self.broadcast(
            list(self.config.acceptor_addresses)[
                :self.config.quorum_size], phase2a)
        state.resend.stop()
        self.states[phase1b.vertex_id] = _Phase2State(
            state.round, proposal, {},
            self._make_resend_timer(f"resendPhase2a {phase1b.vertex_id}",
                                    phase2a))

    def _handle_phase2b(self, src: Address, phase2b: Phase2b) -> None:
        state = self.states.get(phase2b.vertex_id)
        if not isinstance(state, _Phase2State):
            return
        if phase2b.round != state.round:
            self.logger.check_lt(phase2b.round, state.round)
            return
        state.phase2bs[phase2b.acceptor_id] = phase2b
        if len(state.phase2bs) < self.config.quorum_size:
            return
        state.resend.stop()
        self.states[phase2b.vertex_id] = _ChosenState(state.value)
        self.broadcast(self.config.replica_addresses, Commit(
            vertex_id=phase2b.vertex_id,
            command_or_noop=state.value.command_or_noop,
            dependencies=state.value.dependencies.copy()))

    def _handle_nack(self, src: Address, nack: Nack) -> None:
        state = self.states.get(nack.vertex_id)
        if state is None or isinstance(state, _ChosenState):
            return
        if nack.higher_round <= state.round:
            return
        round = self._round_system(nack.vertex_id).next_classic_round(
            self.index, nack.higher_round)
        phase1a = Phase1a(vertex_id=nack.vertex_id, round=round)
        self.broadcast(
            list(self.config.acceptor_addresses)[
                :self.config.quorum_size], phase1a)
        state.resend.stop()
        self.states[nack.vertex_id] = _Phase1State(
            round, state.value, {},
            self._make_resend_timer(f"resendPhase1a {nack.vertex_id}",
                                    phase1a))

    def _handle_recover(self, src: Address, recover: Recover) -> None:
        state = self.states.get(recover.vertex_id)
        if state is None:
            self._propose_impl(recover.vertex_id, NOOP, VertexIdPrefixSet(
                len(self.config.leader_addresses)))
        elif isinstance(state, _ChosenState):
            self.send(src, Commit(
                vertex_id=recover.vertex_id,
                command_or_noop=state.value.command_or_noop,
                dependencies=state.value.dependencies.copy()))


@dataclasses.dataclass
class _AcceptorState:
    round: int = -1
    vote_round: int = -1
    vote_value: Optional[VoteValue] = None


class BPaxosAcceptor(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: SimpleBPaxosConfig):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.index = list(config.acceptor_addresses).index(address)
        self.states: dict[VertexId, _AcceptorState] = {}

    def receive(self, src: Address, message) -> None:
        if isinstance(message, Phase1a):
            state = self.states.setdefault(message.vertex_id,
                                           _AcceptorState())
            if message.round < state.round:
                self.send(src, Nack(message.vertex_id, state.round))
                return
            state.round = message.round
            self.send(src, Phase1b(
                vertex_id=message.vertex_id, acceptor_id=self.index,
                round=message.round, vote_round=state.vote_round,
                vote_value=state.vote_value))
        elif isinstance(message, Phase2a):
            state = self.states.setdefault(message.vertex_id,
                                           _AcceptorState())
            if message.round < state.round:
                self.send(src, Nack(message.vertex_id, state.round))
                return
            state.round = message.round
            state.vote_round = message.round
            state.vote_value = message.vote_value
            self.send(src, Phase2b(vertex_id=message.vertex_id,
                                   acceptor_id=self.index,
                                   round=message.round))
        else:
            self.logger.fatal(f"unexpected acceptor message {message!r}")
