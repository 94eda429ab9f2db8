"""SimpleBPaxos Replica and Client.

The port's copy of ``frankenpaxos_tpu/protocols/simplebpaxos/
replica.py``. One host-side difference, with the same outcome: a commit
hands the dependency graph only the dependencies the replica has not
executed (every graph treats an executed dependency as satisfied), where
the reference materializes the whole set, watermark prefixes included,
which costs a hot-key run time quadratic in its length.

Reference behavior: simplebpaxos/Replica.scala:33-430 (commit vertices
into the dependency graph, SCC-ordered execution, ClientTable
exactly-once, recover-vertex timers -> Recover to the vertex's
proposer), simplebpaxos/Client.scala.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from frankenpaxos_tpu_torch.clienttable import ClientTable, NOT_EXECUTED
from frankenpaxos_tpu_torch.depgraph import make_dependency_graph
from frankenpaxos_tpu_torch.protocols.simplebpaxos.messages import (
    ClientReply,
    ClientRequest,
    Command,
    Commit,
    Noop,
    Recover,
    SimpleBPaxosConfig,
    VertexId,
    VertexIdPrefixSet,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.statemachine import StateMachine


@dataclasses.dataclass
class _Committed:
    command_or_noop: object
    dependencies: object


class BPaxosReplica(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: SimpleBPaxosConfig,
                 state_machine: StateMachine,
                 execute_graph_batch_size: int = 1,
                 recover_vertex_min_period_s: float = 10.0,
                 recover_vertex_max_period_s: float = 20.0,
                 num_blockers: Optional[int] = 1, seed: int = 0,
                 dependency_graph: str = "tarjan"):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.state_machine = state_machine
        self.rng = random.Random(seed)
        self.execute_graph_batch_size = execute_graph_batch_size
        self.recover_min = recover_vertex_min_period_s
        self.recover_max = recover_vertex_max_period_s
        self.num_blockers = num_blockers
        self.index = list(config.replica_addresses).index(address)
        self.commands: dict[VertexId, _Committed] = {}
        self.dependency_graph = make_dependency_graph(
            dependency_graph,
            num_leaders=len(config.leader_addresses), make=VertexId)
        self.client_table: ClientTable = ClientTable()
        self.recover_vertex_timers: dict[VertexId, object] = {}
        self.num_pending = 0
        self.executed_count = 0
        # Every vertex the dependency graph returned as executed; a
        # commit hands the graph only the dependencies above it.
        self.graph_executed = VertexIdPrefixSet(len(config.leader_addresses))

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, Commit):
            self.logger.fatal(f"unexpected replica message {message!r}")
        vertex_id = message.vertex_id
        if vertex_id in self.commands \
                or vertex_id in self.dependency_graph.executed:
            return
        self.commands[vertex_id] = _Committed(message.command_or_noop,
                                              message.dependencies)
        timer = self.recover_vertex_timers.pop(vertex_id, None)
        if timer is not None:
            timer.stop()
        self.dependency_graph.commit(
            vertex_id, 0,
            self._unexecuted_dependencies(message.dependencies))
        self.num_pending += 1
        if self.num_pending % self.execute_graph_batch_size == 0:
            self._execute_graph()
            self.num_pending = 0

    def _unexecuted_dependencies(self, dependencies):
        """Iterable of dependencies to hand the graph: those the graph has
        not executed, so that a hot-key vertex's watermark prefix costs
        the in-flight window, not the whole history."""
        return dependencies.materialized_diff(self.graph_executed)

    def _execute_graph(self) -> None:
        executables, blockers = self.dependency_graph.execute(
            self.num_blockers)
        for blocked in blockers:
            if blocked not in self.recover_vertex_timers:
                self.recover_vertex_timers[blocked] = \
                    self._make_recover_timer(blocked)
        for vertex_id in executables:
            self.graph_executed.add(vertex_id)
            committed = self.commands.get(vertex_id)
            if committed is None:
                self.logger.fatal(f"{vertex_id} executable but unknown")
            self._execute(vertex_id, committed.command_or_noop)

    def _make_recover_timer(self, vertex_id: VertexId) -> object:
        def fire():
            # Ask the vertex's proposer to get it chosen (a noop if
            # nothing was proposed).
            self.send(self.config.proposer_addresses[
                vertex_id.replica_index % len(
                    self.config.proposer_addresses)],
                Recover(vertex_id=vertex_id))
            timer.start()

        timer = self.timer(f"recoverVertex {vertex_id}",
                           self.rng.uniform(self.recover_min,
                                            self.recover_max), fire)
        timer.start()
        return timer

    def _execute(self, vertex_id: VertexId, value) -> None:
        if isinstance(value, Noop):
            return
        command: Command = value
        identity = (command.client_address, command.client_pseudonym)
        if self.client_table.executed(identity,
                                      command.client_id) is not NOT_EXECUTED:
            return
        output = self.state_machine.run(command.command)
        self.client_table.execute(identity, command.client_id, output)
        self.executed_count += 1
        # Replies are distributed round-robin over replicas so only one
        # replica replies (Replica.scala:330-360).
        num_replicas = len(self.config.replica_addresses)
        if vertex_id.instance_number % num_replicas == self.index:
            self.send(command.client_address, ClientReply(
                client_pseudonym=command.client_pseudonym,
                client_id=command.client_id, result=output))


@dataclasses.dataclass
class _Pending:
    id: int
    command: bytes
    callback: Callable[[bytes], None]
    resend: object


class BPaxosClient(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: SimpleBPaxosConfig,
                 resend_period_s: float = 10.0, seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.rng = random.Random(seed)
        self.resend_period_s = resend_period_s
        self.ids: dict[int, int] = {}
        self.pending: dict[int, _Pending] = {}

    def propose(self, pseudonym: int, command: bytes,
                callback: Optional[Callable[[bytes], None]] = None) -> None:
        if pseudonym in self.pending:
            raise RuntimeError(f"pseudonym {pseudonym} has a pending op")
        id = self.ids.get(pseudonym, 0)
        request = ClientRequest(Command(self.address, pseudonym, id,
                                        command))
        leader = self.config.leader_addresses[
            self.rng.randrange(len(self.config.leader_addresses))]
        self.send(leader, request)

        def resend():
            target = self.config.leader_addresses[
                self.rng.randrange(len(self.config.leader_addresses))]
            self.send(target, request)
            timer.start()

        timer = self.timer(f"resend-{pseudonym}", self.resend_period_s,
                           resend)
        timer.start()
        self.pending[pseudonym] = _Pending(id, command,
                                           callback or (lambda _: None),
                                           timer)
        self.ids[pseudonym] = id + 1

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, ClientReply):
            self.logger.fatal(f"unexpected client message {message!r}")
        pending = self.pending.get(message.client_pseudonym)
        if pending is None or pending.id != message.client_id:
            return
        pending.resend.stop()
        del self.pending[message.client_pseudonym]
        pending.callback(message.result)
