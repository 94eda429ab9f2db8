"""Fast Paxos and Fast MultiPaxos clusters over ``SimTransport``, as the
reference's tests build them (``tests/protocols/test_small_protocols.py``'s
``make_fastpaxos``, ``tests/protocols/test_fastmultipaxos.py``'s
``make_fmp``), with the quorum backend and device named.

``quorum_backend="cuda"`` puts the leaders' (and Fast Paxos clients')
quorum checks on K6's stateless check, on ``device`` (the card when None;
``"cpu"`` runs the plain version, as the tests do).
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.protocols.fastmultipaxos import (
    FastMultiPaxosAcceptor,
    FastMultiPaxosClient,
    FastMultiPaxosConfig,
    FastMultiPaxosLeader,
    FastMultiPaxosLeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.fastpaxos import (
    FastPaxosAcceptor,
    FastPaxosClient,
    FastPaxosConfig,
    FastPaxosLeader,
)
from frankenpaxos_tpu_torch.roundsystem import RoundZeroFast
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
from frankenpaxos_tpu_torch.statemachine import AppendLog


def make_fastpaxos(f: int = 1, num_clients: int = 2,
                   quorum_backend: str = "host", device=None):
    """``(transport, leaders, acceptors, clients)``: f + 1 leaders, 2f + 1
    acceptors."""
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    config = FastPaxosConfig(
        f=f,
        leader_addresses=tuple(f"leader-{i}" for i in range(f + 1)),
        acceptor_addresses=tuple(f"acceptor-{i}" for i in range(2 * f + 1)))
    leaders = [FastPaxosLeader(a, transport, logger, config,
                               quorum_backend=quorum_backend, device=device)
               for a in config.leader_addresses]
    acceptors = [FastPaxosAcceptor(a, transport, logger, config)
                 for a in config.acceptor_addresses]
    clients = [FastPaxosClient(f"client-{i}", transport, logger, config,
                               quorum_backend=quorum_backend, device=device)
               for i in range(num_clients)]
    return transport, leaders, acceptors, clients


def make_fastmultipaxos(f: int = 1, num_clients: int = 2, seed: int = 0,
                        quorum_backend: str = "host", device=None):
    """``(transport, config, leaders, acceptors, clients)``: f + 1 leaders
    on raft election and heartbeats, 2f + 1 acceptors, round 0 fast
    (``RoundZeroFast``), AppendLog state machines."""
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    n = 2 * f + 1
    config = FastMultiPaxosConfig(
        f=f,
        leader_addresses=tuple(f"leader-{i}" for i in range(f + 1)),
        leader_election_addresses=tuple(
            f"election-{i}" for i in range(f + 1)),
        leader_heartbeat_addresses=tuple(f"lhb-{i}" for i in range(f + 1)),
        acceptor_addresses=tuple(f"acceptor-{i}" for i in range(n)),
        acceptor_heartbeat_addresses=tuple(f"ahb-{i}" for i in range(n)),
        round_system=RoundZeroFast(f + 1))
    leader_options = FastMultiPaxosLeaderOptions(
        quorum_backend=quorum_backend, device=device)
    leaders = [FastMultiPaxosLeader(a, transport, logger, config,
                                    AppendLog(), seed=seed + i,
                                    options=leader_options)
               for i, a in enumerate(config.leader_addresses)]
    acceptors = [FastMultiPaxosAcceptor(a, transport, logger, config)
                 for a in config.acceptor_addresses]
    clients = [FastMultiPaxosClient(f"client-{i}", transport, logger,
                                    config, seed=seed + 50 + i)
               for i in range(num_clients)]
    return transport, config, leaders, acceptors, clients


#: The timers a drive fires when delivery goes quiet (the reference test's
#: pump: every timer but the election's and the heartbeats').
QUIET_TIMERS_SKIPPED = ("noPing", "notEnoughVotes", "fail", "success")


def pump(transport, predicate, rounds: int = 12) -> bool:
    """Deliver everything, firing the protocol's own timers between waves,
    until ``predicate()`` holds or ``rounds`` waves have passed."""
    for _ in range(rounds):
        if predicate():
            return True
        for timer in transport.running_timers():
            if not timer.name.startswith(QUIET_TIMERS_SKIPPED):
                transport.trigger_timer(timer.id)
        transport.deliver_all()
    return predicate()
