"""EPaxos Replica: leaderless generalized consensus, all roles in one.

The port's copy of ``frankenpaxos_tpu/protocols/epaxos/replica.py``,
with ``dep_backend="cuda"`` in place of the reference's ``"tpu"``: the
slow path's quorum union and the fast path's identical-deps test run on
K10 and K11 (``ops/csrc/depset.cu``) on the replica's ``device``. One
host-side difference, with the same outcome: a commit hands the
dependency graph only the dependencies the replica has not executed
(every graph treats an executed dependency as satisfied), where the
reference materializes the whole set, watermark prefixes included.

Reference behavior: epaxos/Replica.scala:390-1940. Every replica owns a
column of instances (replica_index, 0..); commands are PreAccepted with
conflict-derived dependency sets, committed on the fast path when
``fast_quorum_size`` (= n-1) replies carry identical (seq, deps), else
Accepted through a classic f+1 round; committed commands execute in
dependency-graph SCC order with exactly-once client-table semantics.
Failure recovery runs explicit-prepare ballots (Prepare/PrepareOk,
Replica.scala:1632-1940) driven by randomized recover-instance timers on
blocking dependencies.
"""

from __future__ import annotations

from collections import Counter as _Counter
import dataclasses
import random
from typing import Optional, Union

from frankenpaxos_tpu_torch.clienttable import ClientTable, Executed, NOT_EXECUTED
from frankenpaxos_tpu_torch.depgraph import make_dependency_graph
from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.protocols.epaxos import device_deps
from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    Instance,
    InstancePrefixSet,
)
from frankenpaxos_tpu_torch.protocols.epaxos.messages import (
    Accept,
    AcceptOk,
    Ballot,
    ClientReply,
    ClientRequest,
    Command,
    CommandStatus,
    Commit,
    Nack,
    NOOP,
    Noop,
    NULL_BALLOT,
    PreAccept,
    PreAcceptOk,
    Prepare,
    PrepareOk,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.statemachine import StateMachine
from frankenpaxos_tpu_torch.utils.topk import TUPLE_VERTEX_LIKE

@dataclasses.dataclass(frozen=True)
class EPaxosConfig:
    f: int
    replica_addresses: tuple

    @property
    def n(self) -> int:
        return 2 * self.f + 1

    @property
    def fast_quorum_size(self) -> int:
        return self.n - 1

    @property
    def slow_quorum_size(self) -> int:
        return self.f + 1

    def check_valid(self) -> None:
        if len(self.replica_addresses) != self.n:
            raise ValueError(
                f"need 2f+1 = {self.n} replicas, got "
                f"{len(self.replica_addresses)}")


@dataclasses.dataclass(frozen=True)
class EPaxosReplicaOptions:
    top_k_dependencies: int = 1
    execute_graph_batch_size: int = 1
    execute_graph_timer_period_s: float = 1.0
    resend_pre_accepts_period_s: float = 10.0
    default_to_slow_path_period_s: float = 10.0
    resend_accepts_period_s: float = 10.0
    resend_prepares_period_s: float = 10.0
    recover_instance_min_period_s: float = 20.0
    recover_instance_max_period_s: float = 40.0
    unsafe_skip_graph_execution: bool = False
    num_blockers: Optional[int] = 1
    # "tarjan", "incremental", or "zigzag" (the reference's ReplicaMain
    # hardwires Zigzag, epaxos/ReplicaMain.scala:127).
    dependency_graph: str = "tarjan"
    # "host": per-reply IntPrefixSet loops. "cuda": slow-path dep unions
    # and fast-path identical-deps tests as batched ops/depset.py
    # reductions (K10, K11; see device_deps.py) on the replica's device.
    dep_backend: str = "host"


@dataclasses.dataclass
class Triple:
    command_or_noop: object
    sequence_number: int
    dependencies: InstancePrefixSet


# Command log entries (Replica.scala:298-336).
@dataclasses.dataclass
class NoCommandEntry:
    ballot: Ballot


@dataclasses.dataclass
class PreAcceptedEntry:
    ballot: Ballot
    vote_ballot: Ballot
    triple: Triple


@dataclasses.dataclass
class AcceptedEntry:
    ballot: Ballot
    vote_ballot: Ballot
    triple: Triple


@dataclasses.dataclass
class CommittedEntry:
    triple: Triple


CmdLogEntry = Union[NoCommandEntry, PreAcceptedEntry, AcceptedEntry,
                    CommittedEntry]


# Leader states (Replica.scala:338-388).
@dataclasses.dataclass
class PreAccepting:
    ballot: Ballot
    command_or_noop: object
    responses: dict[int, PreAcceptOk]
    avoid_fast_path: bool
    resend_timer: object
    default_slow_timer: Optional[object] = None


@dataclasses.dataclass
class Accepting:
    ballot: Ballot
    triple: Triple
    responses: dict[int, AcceptOk]
    resend_timer: object


@dataclasses.dataclass
class Preparing:
    ballot: Ballot
    responses: dict[int, PrepareOk]
    resend_timer: object


class EPaxosReplica(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: EPaxosConfig,
                 state_machine: StateMachine,
                 options: EPaxosReplicaOptions = EPaxosReplicaOptions(),
                 seed: int = 0, device=None):
        if options.dep_backend not in ("host", "cuda"):
            raise ValueError(
                f"dep_backend must be 'host' or 'cuda', got "
                f"{options.dep_backend!r}")
        # The dep-set kernels' device: resolved now, so that "cuda"
        # without a GPU (and no device named) fails at construction, not
        # at the first slow path.
        self.device = (resolve_device(device)
                       if options.dep_backend == "cuda" else None)
        super().__init__(address, transport, logger)
        config.check_valid()
        logger.check(address in config.replica_addresses)
        self.config = config
        self.options = options
        self.state_machine = state_machine
        self.rng = random.Random(seed)
        self.index = list(config.replica_addresses).index(address)
        self.other_addresses = [a for a in config.replica_addresses
                                if a != address]

        self.cmd_log: dict[Instance, CmdLogEntry] = {}
        self.next_available_instance = 0
        self.default_ballot: Ballot = (0, self.index)
        self.largest_ballot: Ballot = (0, self.index)
        self.leader_states: dict[Instance, object] = {}
        self.dependency_graph = make_dependency_graph(
            options.dependency_graph, num_leaders=config.n, make=Instance)
        self.client_table: ClientTable = ClientTable()
        self.conflict_index = state_machine.top_k_conflict_index(
            options.top_k_dependencies, config.n, TUPLE_VERTEX_LIKE)
        self.recover_instance_timers: dict[Instance, object] = {}
        self.num_pending_committed = 0
        self.executed_count = 0
        # Every instance the dependency graph returned as executed. Each
        # graph treats an executed dependency as satisfied, so a commit
        # hands it only the dependencies above this set: a hot-key
        # command's watermark-prefix deps then cost the in-flight window,
        # not every instance below the watermark.
        self.graph_executed = InstancePrefixSet(config.n)

    # --- helpers ----------------------------------------------------------
    def _leader_ballot(self, state) -> Ballot:
        return state.ballot

    def _thrifty_others(self, n: int) -> list[Address]:
        return self.other_addresses[:n]

    def _compute_seq_deps(self, instance: Instance, command_or_noop
                          ) -> tuple[int, InstancePrefixSet]:
        if isinstance(command_or_noop, Noop):
            return 0, InstancePrefixSet(self.config.n)
        payload = command_or_noop.command
        if self.options.top_k_dependencies == 1:
            deps = InstancePrefixSet.from_top_one(
                self.conflict_index.get_top_one_conflicts(payload))
        else:
            deps = InstancePrefixSet.from_top_k(
                self.conflict_index.get_top_k_conflicts(payload))
        deps.subtract_one(instance)
        # Note: with top-k conflict indexes, true EPaxos sequence numbers
        # can't be computed; they aren't needed (Replica.scala:565-568).
        return 0, deps

    def _update_conflict_index(self, instance: Instance, value) -> None:
        if isinstance(value, Command):
            self.conflict_index.put(instance, value.command)

    def _stop_timers(self, instance: Instance) -> None:
        state = self.leader_states.get(instance)
        if isinstance(state, PreAccepting):
            state.resend_timer.stop()
            if state.default_slow_timer is not None:
                state.default_slow_timer.stop()
        elif isinstance(state, Accepting):
            state.resend_timer.stop()
        elif isinstance(state, Preparing):
            state.resend_timer.stop()

    def _check_can_overwrite(self, instance: Instance, ballot: Ballot) -> None:
        entry = self.cmd_log.get(instance)
        if isinstance(entry, CommittedEntry):
            self.logger.fatal(
                f"overwriting committed instance {instance}")
        if isinstance(entry, (PreAcceptedEntry, AcceptedEntry)):
            self.logger.check_le(entry.ballot, ballot)
            self.logger.check_le(entry.vote_ballot, ballot)
        elif isinstance(entry, NoCommandEntry):
            self.logger.check_le(entry.ballot, ballot)

    def _make_repeating_timer(self, name: str, period_s: float, body) -> object:
        def fire():
            # Re-arm BEFORE the body: a body that transitions state
            # stops this timer via _stop_timers, and re-arming after it
            # would resurrect a stopped timer -- the defaultToSlowPath
            # timer then fires in the Accepting state and trips the
            # fatal check (found by the 500x250 soak,
            # tests/soak.py epaxos/f1).
            timer.start()
            body()

        timer = self.timer(name, period_s, fire)
        timer.start()
        return timer

    # --- phase transitions (Replica.scala:634-1010) -----------------------
    def _transition_to_pre_accept(self, instance: Instance, ballot: Ballot,
                                  command_or_noop, avoid_fast_path: bool
                                  ) -> None:
        sequence_number, dependencies = self._compute_seq_deps(
            instance, command_or_noop)
        self._check_can_overwrite(instance, ballot)
        self.cmd_log[instance] = PreAcceptedEntry(
            ballot=ballot, vote_ballot=ballot,
            triple=Triple(command_or_noop, sequence_number, dependencies))
        self._update_conflict_index(instance, command_or_noop)

        pre_accept = PreAccept(instance=instance, ballot=ballot,
                               command_or_noop=command_or_noop,
                               sequence_number=sequence_number,
                               dependencies=dependencies.copy())
        targets = self._thrifty_others(self.config.fast_quorum_size - 1)
        self.broadcast(targets, pre_accept)

        self._stop_timers(instance)

        def resend():
            self.broadcast(self.other_addresses, pre_accept)

        self.leader_states[instance] = PreAccepting(
            ballot=ballot,
            command_or_noop=command_or_noop,
            responses={self.index: PreAcceptOk(
                instance=instance, ballot=ballot, replica_index=self.index,
                sequence_number=sequence_number,
                dependencies=dependencies.copy())},
            avoid_fast_path=avoid_fast_path,
            resend_timer=self._make_repeating_timer(
                f"resendPreAccepts {instance}",
                self.options.resend_pre_accepts_period_s, resend),
        )

    def _transition_to_accept(self, instance: Instance, ballot: Ballot,
                              triple: Triple) -> None:
        self._check_can_overwrite(instance, ballot)
        self.cmd_log[instance] = AcceptedEntry(ballot=ballot,
                                               vote_ballot=ballot,
                                               triple=triple)
        self._update_conflict_index(instance, triple.command_or_noop)

        accept = Accept(instance=instance, ballot=ballot,
                        command_or_noop=triple.command_or_noop,
                        sequence_number=triple.sequence_number,
                        dependencies=triple.dependencies.copy())
        self.broadcast(
            self._thrifty_others(self.config.slow_quorum_size - 1),
            accept)

        self._stop_timers(instance)

        def resend():
            self.broadcast(self.other_addresses, accept)

        self.leader_states[instance] = Accepting(
            ballot=ballot, triple=triple,
            responses={self.index: AcceptOk(instance=instance, ballot=ballot,
                                            replica_index=self.index)},
            resend_timer=self._make_repeating_timer(
                f"resendAccepts {instance}",
                self.options.resend_accepts_period_s, resend),
        )

    def _pre_accepting_slow_path(self, instance: Instance,
                                 state: PreAccepting) -> None:
        """Union deps across a classic quorum (Replica.scala:795-813)."""
        self.logger.check_ge(len(state.responses),
                             self.config.slow_quorum_size)
        if self.options.dep_backend == "cuda":
            sequence_number, dependencies = device_deps.conflict_max_many(
                [(r.sequence_number, r.dependencies)
                 for r in state.responses.values()],
                self.config.n, self.device,
                metrics=self.transport.runtime_metrics)
        else:
            sequence_number = max(r.sequence_number
                                  for r in state.responses.values())
            dependencies = InstancePrefixSet(self.config.n)
            for response in state.responses.values():
                dependencies.add_all(response.dependencies)
        self._transition_to_accept(
            instance, state.ballot,
            Triple(state.command_or_noop, sequence_number, dependencies))

    def _transition_to_prepare(self, instance: Instance) -> None:
        """Explicit-prepare recovery (Replica.scala:972-1010)."""
        self._stop_timers(instance)
        self.largest_ballot = (self.largest_ballot[0] + 1, self.index)
        ballot = self.largest_ballot
        prepare = Prepare(instance=instance, ballot=ballot)
        targets = self._thrifty_others(self.config.slow_quorum_size - 1)
        self.broadcast([*targets, self.address], prepare)

        def resend():
            self.broadcast(self.config.replica_addresses, prepare)

        self.leader_states[instance] = Preparing(
            ballot=ballot, responses={},
            resend_timer=self._make_repeating_timer(
                f"resendPrepares {instance}",
                self.options.resend_prepares_period_s, resend),
        )

    # --- commit + execution (Replica.scala:815-965) -----------------------
    def _commit(self, instance: Instance, triple: Triple,
                inform_others: bool) -> None:
        if isinstance(self.cmd_log.get(instance), CommittedEntry):
            return  # duplicate Commit
        self._stop_timers(instance)
        self.cmd_log[instance] = CommittedEntry(triple)
        self._update_conflict_index(instance, triple.command_or_noop)
        self.leader_states.pop(instance, None)

        if inform_others:
            commit = Commit(instance=instance,
                            command_or_noop=triple.command_or_noop,
                            sequence_number=triple.sequence_number,
                            dependencies=triple.dependencies.copy())
            self.broadcast(self.other_addresses, commit)

        timer = self.recover_instance_timers.pop(instance, None)
        if timer is not None:
            timer.stop()

        if self.options.unsafe_skip_graph_execution:
            self._execute_command(instance, triple.command_or_noop)
            return
        self.dependency_graph.commit(
            instance, triple.sequence_number,
            triple.dependencies.materialized_diff(self.graph_executed))
        self.num_pending_committed += 1
        if (self.num_pending_committed
                % self.options.execute_graph_batch_size == 0):
            self._execute_graph()
            self.num_pending_committed = 0

    def _execute_graph(self) -> None:
        executables, blockers = self.dependency_graph.execute(
            self.options.num_blockers)
        for blocked in blockers:
            if blocked not in self.recover_instance_timers:
                self.recover_instance_timers[blocked] = \
                    self._make_recover_timer(blocked)
        for instance in executables:
            self.graph_executed.add(instance)
            entry = self.cmd_log.get(instance)
            if not isinstance(entry, CommittedEntry):
                self.logger.fatal(
                    f"instance {instance} executable but not committed")
            self._execute_command(instance, entry.triple.command_or_noop)

    def _make_recover_timer(self, instance: Instance) -> object:
        return self._make_repeating_timer(
            f"recoverInstance {instance}",
            self.rng.uniform(self.options.recover_instance_min_period_s,
                             self.options.recover_instance_max_period_s),
            lambda: self._transition_to_prepare(instance))

    def _execute_command(self, instance: Instance, value) -> None:
        if isinstance(value, Noop):
            return
        command: Command = value
        identity = (command.client_address, command.client_pseudonym)
        executed = self.client_table.executed(identity, command.client_id)
        if executed is not NOT_EXECUTED:
            return
        output = self.state_machine.run(command.command)
        self.client_table.execute(identity, command.client_id, output)
        self.executed_count += 1
        # The instance's column owner replies (Replica.scala:946-962).
        if self.index == instance.replica_index:
            self.send(command.client_address,
                      ClientReply(client_pseudonym=command.client_pseudonym,
                                  client_id=command.client_id,
                                  result=output))

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        handlers = {
            ClientRequest: self._handle_client_request,
            PreAccept: self._handle_pre_accept,
            PreAcceptOk: self._handle_pre_accept_ok,
            Accept: self._handle_accept,
            AcceptOk: self._handle_accept_ok,
            Commit: self._handle_commit,
            Nack: self._handle_nack,
            Prepare: self._handle_prepare,
            PrepareOk: self._handle_prepare_ok,
        }
        handler = handlers.get(type(message))
        if handler is None:
            self.logger.fatal(f"unexpected epaxos message {message!r}")
        handler(src, message)

    def _handle_client_request(self, src: Address,
                               request: ClientRequest) -> None:
        command = request.command
        identity = (command.client_address, command.client_pseudonym)
        executed = self.client_table.executed(identity, command.client_id)
        if isinstance(executed, Executed):
            if executed.output is not None:
                self.send(src, ClientReply(
                    client_pseudonym=command.client_pseudonym,
                    client_id=command.client_id, result=executed.output))
            return
        instance = Instance(self.index, self.next_available_instance)
        self.next_available_instance += 1
        self._transition_to_pre_accept(instance, self.default_ballot,
                                       command, avoid_fast_path=False)

    def _yield_leadership_if_preempted(self, instance: Instance,
                                       ballot: Ballot) -> None:
        state = self.leader_states.get(instance)
        if state is not None and ballot > self._leader_ballot(state):
            self._stop_timers(instance)
            del self.leader_states[instance]

    def _handle_pre_accept(self, src: Address, pre_accept: PreAccept) -> None:
        """(Replica.scala:1159-1290)."""
        instance = pre_accept.instance
        entry = self.cmd_log.get(instance)
        nack = Nack(instance, self.largest_ballot)
        if isinstance(entry, NoCommandEntry):
            # `<` not `<=`: preparing is phase 1, pre-accepting is phase 2.
            if pre_accept.ballot < entry.ballot:
                self.send(src, nack)
                return
        elif isinstance(entry, PreAcceptedEntry):
            if pre_accept.ballot < entry.ballot:
                self.send(src, nack)
                return
            if pre_accept.ballot == entry.vote_ballot:
                # Already responded; re-send for liveness.
                self.send(src, PreAcceptOk(
                    instance=instance, ballot=pre_accept.ballot,
                    replica_index=self.index,
                    sequence_number=entry.triple.sequence_number,
                    dependencies=entry.triple.dependencies.copy()))
                return
        elif isinstance(entry, AcceptedEntry):
            if pre_accept.ballot < entry.ballot:
                self.send(src, nack)
                return
            if pre_accept.ballot == entry.vote_ballot:
                return  # already accepted in this ballot
        elif isinstance(entry, CommittedEntry):
            self.send(src, Commit(
                instance=instance,
                command_or_noop=entry.triple.command_or_noop,
                sequence_number=entry.triple.sequence_number,
                dependencies=entry.triple.dependencies.copy()))
            return

        self._yield_leadership_if_preempted(instance, pre_accept.ballot)
        self.largest_ballot = max(self.largest_ballot, pre_accept.ballot)
        timer = self.recover_instance_timers.get(instance)
        if timer is not None:
            timer.reset()

        sequence_number, dependencies = self._compute_seq_deps(
            instance, pre_accept.command_or_noop)
        sequence_number = max(sequence_number, pre_accept.sequence_number)
        dependencies.add_all(pre_accept.dependencies)
        self.cmd_log[instance] = PreAcceptedEntry(
            ballot=pre_accept.ballot, vote_ballot=pre_accept.ballot,
            triple=Triple(pre_accept.command_or_noop, sequence_number,
                          dependencies))
        self._update_conflict_index(instance, pre_accept.command_or_noop)
        self.send(src, PreAcceptOk(
            instance=instance, ballot=pre_accept.ballot,
            replica_index=self.index, sequence_number=sequence_number,
            dependencies=dependencies.copy()))

    def _handle_pre_accept_ok(self, src: Address, ok: PreAcceptOk) -> None:
        """(Replica.scala:1291-1420)."""
        state = self.leader_states.get(ok.instance)
        if not isinstance(state, PreAccepting):
            self.logger.debug(f"PreAcceptOk for {ok.instance} ignored")
            return
        if ok.ballot != state.ballot:
            self.logger.check_lt(ok.ballot, state.ballot)
            return

        old_count = len(state.responses)
        state.responses[ok.replica_index] = ok
        new_count = len(state.responses)
        slow, fast = (self.config.slow_quorum_size,
                      self.config.fast_quorum_size)
        if new_count < slow:
            return
        # First classic quorum: arm the default-to-slow-path timer while
        # waiting for a full fast quorum.
        if (not state.avoid_fast_path and old_count < slow <= new_count
                and slow < fast):
            if state.default_slow_timer is None:
                state.default_slow_timer = self._make_repeating_timer(
                    f"defaultToSlowPath {ok.instance}",
                    self.options.default_to_slow_path_period_s,
                    lambda: self._default_to_slow_path(ok.instance))
            return
        if state.avoid_fast_path and new_count >= slow:
            self._pre_accepting_slow_path(ok.instance, state)
            return
        if new_count >= fast:
            # Fast path iff n-2 non-leader replies match exactly.
            seq_deps = [(r.sequence_number, r.dependencies)
                        for i, r in state.responses.items()
                        if i != self.index]
            if (self.options.dep_backend == "cuda"
                    and len(seq_deps) == fast - 1):
                # With threshold == reply count, "count >= fast-1"
                # collapses to "all replies identical" -- one batched
                # device equality over the normalized dep sets.
                winner = (seq_deps[0]
                          if device_deps.all_identical(
                              seq_deps, self.config.n, self.device,
                              metrics=self.transport.runtime_metrics)
                          else None)
            else:
                counts = _Counter(seq_deps)
                candidates = [sd for sd, c in counts.items()
                              if c >= fast - 1]
                if candidates:
                    self.logger.check_eq(len(candidates), 1)
                winner = candidates[0] if candidates else None
            if winner is not None:
                sequence_number, dependencies = winner
                self._commit(ok.instance,
                             Triple(state.command_or_noop, sequence_number,
                                    dependencies.copy()),
                             inform_others=True)
            else:
                self._pre_accepting_slow_path(ok.instance, state)

    def _default_to_slow_path(self, instance: Instance) -> None:
        state = self.leader_states.get(instance)
        if not isinstance(state, PreAccepting):
            self.logger.fatal("defaultToSlowPath fired outside PreAccepting")
        self._pre_accepting_slow_path(instance, state)

    def _handle_accept(self, src: Address, accept: Accept) -> None:
        """(Replica.scala:1421-1512)."""
        instance = accept.instance
        entry = self.cmd_log.get(instance)
        nack = Nack(instance, self.largest_ballot)
        if isinstance(entry, (NoCommandEntry, PreAcceptedEntry)):
            if accept.ballot < entry.ballot:
                self.send(src, nack)
                return
        elif isinstance(entry, AcceptedEntry):
            if accept.ballot < entry.ballot:
                self.send(src, nack)
                return
            if accept.ballot == entry.vote_ballot:
                self.send(src, AcceptOk(instance=instance,
                                        ballot=accept.ballot,
                                        replica_index=self.index))
                return
        elif isinstance(entry, CommittedEntry):
            self.send(src, Commit(
                instance=instance,
                command_or_noop=entry.triple.command_or_noop,
                sequence_number=entry.triple.sequence_number,
                dependencies=entry.triple.dependencies.copy()))
            return

        self._yield_leadership_if_preempted(instance, accept.ballot)
        self.largest_ballot = max(self.largest_ballot, accept.ballot)
        timer = self.recover_instance_timers.get(instance)
        if timer is not None:
            timer.reset()
        self.cmd_log[instance] = AcceptedEntry(
            ballot=accept.ballot, vote_ballot=accept.ballot,
            triple=Triple(accept.command_or_noop, accept.sequence_number,
                          accept.dependencies.copy()))
        self._update_conflict_index(instance, accept.command_or_noop)
        self.send(src, AcceptOk(instance=instance, ballot=accept.ballot,
                                replica_index=self.index))

    def _handle_accept_ok(self, src: Address, ok: AcceptOk) -> None:
        state = self.leader_states.get(ok.instance)
        if not isinstance(state, Accepting):
            self.logger.debug(f"AcceptOk for {ok.instance} ignored")
            return
        if ok.ballot != state.ballot:
            self.logger.check_lt(ok.ballot, state.ballot)
            return
        state.responses[ok.replica_index] = ok
        if len(state.responses) < self.config.slow_quorum_size:
            return
        self._commit(ok.instance, state.triple, inform_others=True)

    def _handle_commit(self, src: Address, commit: Commit) -> None:
        self._commit(commit.instance,
                     Triple(commit.command_or_noop, commit.sequence_number,
                            commit.dependencies.copy()),
                     inform_others=False)

    def _handle_nack(self, src: Address, nack: Nack) -> None:
        """(Replica.scala:1577-1631): wait a random delay, then recover
        with a higher ballot (avoids dueling recoverers)."""
        self.largest_ballot = max(self.largest_ballot, nack.largest_ballot)
        state = self.leader_states.get(nack.instance)
        if state is None or state.ballot >= nack.largest_ballot:
            return
        timer = self.recover_instance_timers.get(nack.instance)
        if timer is not None:
            timer.reset()
        else:
            self.recover_instance_timers[nack.instance] = \
                self._make_recover_timer(nack.instance)

    def _handle_prepare(self, src: Address, prepare: Prepare) -> None:
        """(Replica.scala:1632-1757)."""
        instance = prepare.instance
        self.largest_ballot = max(self.largest_ballot, prepare.ballot)
        timer = self.recover_instance_timers.get(instance)
        if timer is not None:
            timer.reset()
        self._yield_leadership_if_preempted(instance, prepare.ballot)

        entry = self.cmd_log.get(instance)
        nack = Nack(instance, self.largest_ballot)
        if entry is None or isinstance(entry, NoCommandEntry):
            if entry is not None and prepare.ballot < entry.ballot:
                self.send(src, nack)
                return
            self.send(src, PrepareOk(
                ballot=prepare.ballot, instance=instance,
                replica_index=self.index, vote_ballot=NULL_BALLOT,
                status=CommandStatus.NOT_SEEN, command_or_noop=None,
                sequence_number=None, dependencies=None))
            self.cmd_log[instance] = NoCommandEntry(prepare.ballot)
        elif isinstance(entry, (PreAcceptedEntry, AcceptedEntry)):
            if prepare.ballot < entry.ballot:
                self.send(src, nack)
                return
            status = (CommandStatus.PRE_ACCEPTED
                      if isinstance(entry, PreAcceptedEntry)
                      else CommandStatus.ACCEPTED)
            self.send(src, PrepareOk(
                ballot=prepare.ballot, instance=instance,
                replica_index=self.index, vote_ballot=entry.vote_ballot,
                status=status, command_or_noop=entry.triple.command_or_noop,
                sequence_number=entry.triple.sequence_number,
                dependencies=entry.triple.dependencies.copy()))
            entry.ballot = prepare.ballot
        else:
            assert isinstance(entry, CommittedEntry)
            self.send(src, Commit(
                instance=instance,
                command_or_noop=entry.triple.command_or_noop,
                sequence_number=entry.triple.sequence_number,
                dependencies=entry.triple.dependencies.copy()))

    def _handle_prepare_ok(self, src: Address, ok: PrepareOk) -> None:
        """(Replica.scala:1759-1940)."""
        state = self.leader_states.get(ok.instance)
        if not isinstance(state, Preparing):
            self.logger.debug(f"PrepareOk for {ok.instance} ignored")
            return
        if ok.ballot != state.ballot:
            self.logger.check_lt(ok.ballot, state.ballot)
            return
        state.responses[ok.replica_index] = ok
        if len(state.responses) < self.config.slow_quorum_size:
            return

        max_vote_ballot = max(r.vote_ballot for r in state.responses.values())
        top = [r for r in state.responses.values()
               if r.vote_ballot == max_vote_ballot]

        # An Accepted vote wins outright (like a classic-round vote).
        for response in top:
            if response.status == CommandStatus.ACCEPTED:
                self._transition_to_accept(
                    ok.instance, state.ballot,
                    Triple(response.command_or_noop,
                           response.sequence_number,
                           response.dependencies.copy()))
                return

        # f matching default-ballot PreAccepts (excluding the column
        # owner) mean the fast path may have chosen it.
        matching = [
            (r.sequence_number, r.dependencies)
            for r in top
            if r.status == CommandStatus.PRE_ACCEPTED
            and r.ballot == (0, r.instance.replica_index)
            and r.replica_index != self.index
        ]
        counts = _Counter(matching)
        candidates = [sd for sd, c in counts.items() if c >= self.config.f]
        if candidates:
            self.logger.check_eq(len(candidates), 1)
            sequence_number, dependencies = candidates[0]
            pre_accepted = next(r for r in top
                                if r.status == CommandStatus.PRE_ACCEPTED)
            self._transition_to_accept(
                ok.instance, state.ballot,
                Triple(pre_accepted.command_or_noop, sequence_number,
                       dependencies.copy()))
            return

        # Otherwise restart with the seen command, or a noop.
        pre_accepted = next((r for r in top
                             if r.status == CommandStatus.PRE_ACCEPTED), None)
        if pre_accepted is not None:
            self._transition_to_pre_accept(ok.instance, state.ballot,
                                           pre_accepted.command_or_noop,
                                           avoid_fast_path=True)
        else:
            self._transition_to_pre_accept(ok.instance, state.ballot,
                                           NOOP, avoid_fast_path=True)
