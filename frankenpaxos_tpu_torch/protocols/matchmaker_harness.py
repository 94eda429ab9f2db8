"""Matchmaker MultiPaxos and Matchmaker Paxos clusters over
``SimTransport``, as the reference's tests build them
(``tests/protocols/test_matchmakermultipaxos.py``'s ``make_mmp``,
``tests/protocols/test_matchmakerpaxos.py``'s ``make_matchmaker_paxos``),
with the quorum backend and device named.

``quorum_backend="cuda"`` puts the Matchmaker MultiPaxos leaders' phase-1
checks on K6's stateless check, on ``device`` (the card when None, which
raises where there is none; ``"cpu"`` runs the plain version, as the tests
do). Matchmaker Paxos runs on the host only, as in the reference.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.protocols.matchmakermultipaxos import (
    MatchmakerMultiPaxosConfig,
    MMPAcceptor,
    MMPClient,
    MMPLeader,
    MMPMatchmaker,
    MMPReconfigurer,
    MMPReplica,
)
from frankenpaxos_tpu_torch.protocols.matchmakerpaxos import (
    Matchmaker,
    MatchmakerPaxosAcceptor,
    MatchmakerPaxosClient,
    MatchmakerPaxosConfig,
    MatchmakerPaxosLeader,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
from frankenpaxos_tpu_torch.statemachine import AppendLog


def make_mmp(f: int = 1, num_acceptors: int = 5, num_clients: int = 2,
             seed: int = 0, num_matchmakers=None,
             quorum_backend: str = "dict", device=None):
    """``(transport, config, leaders, matchmakers, reconfigurer, acceptors,
    replicas, clients)``: f + 1 leaders, ``num_matchmakers`` (2f + 1)
    matchmakers, one reconfigurer, ``num_acceptors`` acceptors, f + 1
    AppendLog replicas."""
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    config = MatchmakerMultiPaxosConfig(
        f=f,
        leader_addresses=tuple(f"leader-{i}" for i in range(f + 1)),
        matchmaker_addresses=tuple(
            f"matchmaker-{i}"
            for i in range(num_matchmakers or 2 * f + 1)),
        reconfigurer_addresses=("reconfigurer-0",),
        acceptor_addresses=tuple(
            f"acceptor-{i}" for i in range(num_acceptors)),
        replica_addresses=tuple(f"replica-{i}" for i in range(f + 1)))
    leaders = [MMPLeader(a, transport, logger, config, seed=seed + i,
                         quorum_backend=quorum_backend, device=device)
               for i, a in enumerate(config.leader_addresses)]
    matchmakers = [MMPMatchmaker(a, transport, logger, config)
                   for a in config.matchmaker_addresses]
    reconfigurer = MMPReconfigurer("reconfigurer-0", transport, logger,
                                   config)
    acceptors = [MMPAcceptor(a, transport, logger, config)
                 for a in config.acceptor_addresses]
    replicas = [MMPReplica(a, transport, logger, config, AppendLog())
                for a in config.replica_addresses]
    clients = [MMPClient(f"client-{i}", transport, logger, config,
                         seed=seed + 50 + i)
               for i in range(num_clients)]
    return (transport, config, leaders, matchmakers, reconfigurer,
            acceptors, replicas, clients)


def make_matchmaker_paxos(f: int = 1, num_acceptors=None,
                          num_clients: int = 2, seed: int = 0):
    """``(transport, config, leaders, matchmakers, acceptors, clients)``:
    f + 1 leaders, 2f + 1 matchmakers, ``num_acceptors`` (2f + 1)
    acceptors."""
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    num_acceptors = num_acceptors or (2 * f + 1)
    config = MatchmakerPaxosConfig(
        f=f,
        leader_addresses=tuple(f"leader-{i}" for i in range(f + 1)),
        matchmaker_addresses=tuple(
            f"matchmaker-{i}" for i in range(2 * f + 1)),
        acceptor_addresses=tuple(
            f"acceptor-{i}" for i in range(num_acceptors)))
    leaders = [MatchmakerPaxosLeader(a, transport, logger, config,
                                     seed=seed + i)
               for i, a in enumerate(config.leader_addresses)]
    matchmakers = [Matchmaker(a, transport, logger, config)
                   for a in config.matchmaker_addresses]
    acceptors = [MatchmakerPaxosAcceptor(a, transport, logger, config)
                 for a in config.acceptor_addresses]
    clients = [MatchmakerPaxosClient(f"client-{i}", transport, logger,
                                     config, seed=seed + 50 + i)
               for i in range(num_clients)]
    return transport, config, leaders, matchmakers, acceptors, clients
