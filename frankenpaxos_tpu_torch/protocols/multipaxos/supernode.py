"""MultiPaxos deployed in one process over real TCP (a "supernode").

The port's counterpart of ``frankenpaxos_tpu/cli.py``'s supernode role
(the reference's SuperNode mains), restricted to MultiPaxos's roles and
to the cluster layout ``frankenpaxos_tpu/deploy.py`` builds with
``cluster(f, port)``: f + 1 leaders (each with its election participant),
f + 1 proxy leaders, one group of 2f + 1 acceptors, f + 1 replicas, no
batchers and no proxy replicas, plus ``ingest_batchers`` ingest batchers
(the deployment's own ``"ingest_batchers"`` key, ``ingest/``; 0 by
default). Every role address is a loopback ``(host, port)`` on ONE
``TcpTransport``; as the reference does, every address is bound first
and the roles are then built in declaration order (ingest batcher,
leader, proxy leader, acceptor, replica), each with its own seed
(``seed`` plus its position). They are built on the transport's event
loop, so that no message reaches a half-built role. The clients run on a
second ``TcpTransport`` of their own, as a client process would.

The roles' options are their defaults apart from those named here:
``quorum_backend`` and ``tpu_pipelined`` for the ProxyLeaders (with
``"cuda"`` and ``tpu_pipelined`` the collector thread collects the
board's dispatches),
``phase1_backend`` and ``leader_admission`` (the ``admission_*``
options, as a dict) for the Leaders, and ``device`` for both (None means
``cuda``; the tests pass ``"cpu"``, which runs the plain versions).
With ingest batchers the clients write through them on the consistent
ring; without, straight to the leader, whose wire sinks take the client
frames as columns either way. The ProxyLeaders take batch frames of vote
acks through their wire sink.
``wal_dir`` gives each acceptor and replica a FileStorage WAL under
``<wal_dir>/<role>_<index>``, as the reference's ``--wal_dir`` does: one
group commit (one fsync) per role per event-loop pass, since the
transport runs each actor's ``on_drain`` once at the end of a pass. The
state machine is an ``AppendLog``. :meth:`Supernode.write_closed_loop`
drives closed-loop writes and :func:`run_arm` adds the checks::

    with Supernode(quorum_backend="cuda", tpu_pipelined=True) as node:
        figures = node.write_closed_loop(writes=4096, pseudonyms=64)
"""

from __future__ import annotations

import os
import socket
import statistics
import threading
import time

from frankenpaxos_tpu_torch.ingest import (
    IngestBatcher,
    MultiPaxosIngestRouter,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.acceptor import Acceptor
from frankenpaxos_tpu_torch.protocols.multipaxos.client import (
    Client,
    ClientOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.config import (
    DistributionScheme,
    MultiPaxosConfig,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
    executed_prefix,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.leader import (
    Leader,
    LeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import Noop
from frankenpaxos_tpu_torch.protocols.multipaxos.proxy_leader import (
    ProxyLeader,
    ProxyLeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.replica import Replica
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel
from frankenpaxos_tpu_torch.runtime.tcp_transport import TcpTransport
from frankenpaxos_tpu_torch.statemachine import AppendLog
from frankenpaxos_tpu_torch.wal import FileStorage, Wal

#: How long a build on the loop or a closed loop of writes may take.
BUILD_TIMEOUT_S = 60.0
#: Closed-loop clients a supernode's writes come from, each on its own
#: loopback address.
CLIENTS = 4
#: How often a closed loop of writes looks for a collector error while
#: it waits for its replies.
POLL_S = 0.05


class GateFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


def free_ports(n: int, host: str = "127.0.0.1") -> list:
    """``n`` distinct free loopback ports (all held open until each is
    known, so that no two are the same)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind((host, 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def cluster_config(f: int = 1, host: str = "127.0.0.1",
                   ingest_batchers: int = 0) -> MultiPaxosConfig:
    """``deploy.py``'s ``cluster(f, port)`` layout on free loopback
    ports, with ``ingest_batchers`` ingest batchers."""
    ports = iter(free_ports(4 * (f + 1) + 2 * f + 1 + ingest_batchers,
                            host))

    def port():
        return (host, next(ports))

    config = MultiPaxosConfig(
        f=f,
        batcher_addresses=[],
        ingest_batcher_addresses=[port() for _ in range(ingest_batchers)],
        read_batcher_addresses=[],
        leader_addresses=[port() for _ in range(f + 1)],
        leader_election_addresses=[port() for _ in range(f + 1)],
        proxy_leader_addresses=[port() for _ in range(f + 1)],
        acceptor_addresses=[[port() for _ in range(2 * f + 1)]],
        replica_addresses=[port() for _ in range(f + 1)],
        proxy_replica_addresses=[],
        flexible=False,
        distribution_scheme=DistributionScheme.HASH,
    )
    config.check_valid()
    return config


def on_loop(transport: TcpTransport, build):
    """Run ``build()`` on ``transport``'s event loop (where every actor of
    the transport runs); return its result or raise its exception."""
    done = threading.Event()
    box: dict = {}

    def call():
        try:
            box["value"] = build()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e
        finally:
            done.set()

    transport.loop.call_soon_threadsafe(call)
    if not done.wait(timeout=BUILD_TIMEOUT_S):
        raise RuntimeError("the event loop did not run a build in time")
    if "error" in box:
        raise box["error"]
    return box["value"]


def executed_commands(replica: Replica) -> list:
    """The commands a replica executed, in log order (noops skipped)."""
    return [command.command for value in executed_prefix(replica)
            if not isinstance(value, Noop) for command in value.commands]


class Supernode:
    """Every MultiPaxos role of one deployment on one ``TcpTransport``,
    and CLIENTS clients on another. :meth:`start` binds and
    builds, :meth:`stop` stops the collector threads and both
    transports."""

    def __init__(self, f: int = 1, *, quorum_backend: str = "dict",
                 tpu_pipelined: bool = False, phase1_backend: str = "host",
                 device=None, seed: int = 0, host: str = "127.0.0.1",
                 wal_dir: "str | None" = None, ingest_batchers: int = 0,
                 leader_admission: "dict | None" = None):
        self.f = f
        self.wal_dir = wal_dir
        self.host = host
        self.seed = seed
        self.device = device
        self.logger = FakeLogger(LogLevel.WARN)
        self.config = cluster_config(f, host, ingest_batchers)
        self.leader_options = LeaderOptions(phase1_backend=phase1_backend,
                                            **(leader_admission or {}))
        self.proxy_leader_options = ProxyLeaderOptions(
            quorum_backend=quorum_backend, tpu_pipelined=tpu_pipelined)
        self.transport: TcpTransport | None = None
        self.client_transport: TcpTransport | None = None
        self.ingest_batchers: list = []
        self.leaders: list = []
        self.proxy_leaders: list = []
        self.acceptors: list = []
        self.replicas: list = []
        self.clients: list = []

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "Supernode":
        config = self.config
        self.transport = TcpTransport(logger=self.logger)
        self.transport.start()
        self.client_transport = TcpTransport(logger=self.logger)
        self.client_transport.start()
        # Bind every role address FIRST, so that a role's construction-
        # time sends (a leader's Phase1a) find their targets listening.
        for address in (*config.ingest_batcher_addresses,
                        *config.leader_addresses,
                        *config.leader_election_addresses,
                        *config.proxy_leader_addresses,
                        *(a for group in config.acceptor_addresses
                          for a in group),
                        *config.replica_addresses):
            self.transport.listen_on(address)
        on_loop(self.transport, self._build_roles)
        client_ports = free_ports(CLIENTS, self.host)

        def build_clients():
            return [Client((self.host, port), self.client_transport,
                           self.logger, config,
                           ClientOptions(coalesce_writes=True),
                           seed=self.seed + self._count + i)
                    for i, port in enumerate(client_ports)]

        self.clients = on_loop(self.client_transport, build_clients)
        return self

    def _build_roles(self) -> None:
        """The roles in declaration order, each with its own seed."""
        config, t, log = self.config, self.transport, self.logger
        count = 0
        for i, a in enumerate(config.ingest_batcher_addresses):
            self.ingest_batchers.append(IngestBatcher(
                a, t, log, MultiPaxosIngestRouter(config), index=i,
                seed=self.seed + count))
            count += 1
        for a in config.leader_addresses:
            self.leaders.append(Leader(a, t, log, config,
                                       self.leader_options,
                                       seed=self.seed + count,
                                       device=self.device))
            count += 1
        for a in config.proxy_leader_addresses:
            self.proxy_leaders.append(ProxyLeader(
                a, t, log, config, self.proxy_leader_options,
                seed=self.seed + count, device=self.device))
            count += 1
        for group in config.acceptor_addresses:
            for a in group:
                self.acceptors.append(Acceptor(
                    a, t, log, config,
                    wal=self._wal(f"acceptor_{len(self.acceptors)}")))
                count += 1
        for i, a in enumerate(config.replica_addresses):
            self.replicas.append(Replica(a, t, log, AppendLog(), config,
                                         seed=self.seed + count,
                                         wal=self._wal(f"replica_{i}")))
            count += 1
        self._count = count

    def _wal(self, label: str) -> "Wal | None":
        if self.wal_dir is None:
            return None
        return Wal(FileStorage(os.path.join(self.wal_dir, label)))

    def stop(self) -> None:
        for proxy_leader in self.proxy_leaders:
            proxy_leader.close()
        for transport in (self.client_transport, self.transport):
            if transport is not None:
                transport.stop()

    def __enter__(self) -> "Supernode":
        try:
            return self.start()
        except BaseException:
            self.stop()
            raise

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # --- driving ----------------------------------------------------------
    def errors(self) -> list:
        """Every error either transport or a role logged, and every
        collector error of a ProxyLeader."""
        return ([m for level, m in self.logger.records
                 if level >= LogLevel.ERROR]
                + [e for p in self.proxy_leaders
                   for e in p.collector_errors])

    def serving(self) -> dict:
        """The admission and ingest counts of :func:`run_arm`'s
        ``serving`` figure (read on the transport's loop)."""
        rejected: dict = {}
        for role in (*self.leaders, *self.ingest_batchers):
            if role.admission is not None:
                for reason, n in role.admission.rejected.items():
                    rejected[reason] = rejected.get(reason, 0) + n
        ingest_counts: dict = {}
        for leader in self.leaders:
            for kind, n in leader.ingest_counts.items():
                ingest_counts[kind] = ingest_counts.get(kind, 0) + n
        ack_rows = {"sink": 0, "message": 0}
        for proxy_leader in self.proxy_leaders:
            for how, n in proxy_leader.ack_rows.items():
                ack_rows[how] += n
        return {"rejected": rejected, "ingest_counts": ingest_counts,
                "ack_rows": ack_rows,
                "sink_frames": self.transport.stat_sink_frames,
                "sink_messages": self.transport.stat_sink_messages}

    def write_closed_loop(self, writes: int, pseudonyms: int,
                          timeout_s: float = 120.0) -> dict:
        """``writes`` writes, split evenly over the clients, each client
        keeping ``pseudonyms`` writes in flight (a pseudonym issues its
        next write when its reply arrives). Returns the host seconds,
        writes/s, p50 / p99 write latency in ms, and ``replies``:
        payload -> [result, ...] (one entry a reply). A collector error
        fails it at once, since the writes of that dispatch never get
        their replies."""
        per_client = writes // len(self.clients)
        _require(per_client * len(self.clients) == writes,
                 f"{writes} writes do not split over "
                 f"{len(self.clients)} clients")
        replies: dict = {}
        latencies: list = []
        done = threading.Event()
        state = {"answered": 0}
        t = {"start": 0.0, "end": 0.0}

        def kick(c: int, client: Client) -> None:
            issued = [0]

            def issue(p: int) -> None:
                i = issued[0]
                if i >= per_client:
                    return
                issued[0] = i + 1
                payload = b"c%d.%d" % (c, i)
                t0 = time.perf_counter()

                def answered(result: bytes) -> None:
                    latencies.append(time.perf_counter() - t0)
                    replies.setdefault(payload, []).append(result)
                    state["answered"] += 1
                    if state["answered"] == writes:
                        t["end"] = time.perf_counter()
                        done.set()
                    issue(p)

                client.write(p, payload, answered)

            for p in range(min(pseudonyms, per_client)):
                issue(p)
            client.flush_writes()

        def start_all() -> None:
            t["start"] = time.perf_counter()
            for c, client in enumerate(self.clients):
                kick(c, client)

        self.client_transport.loop.call_soon_threadsafe(start_all)
        deadline = time.monotonic() + timeout_s
        while not done.wait(timeout=POLL_S):
            failed = [e for p in self.proxy_leaders
                      for e in p.collector_errors]
            _require(not failed, f"a collector failed with "
                                 f"{state['answered']} of {writes} writes "
                                 f"answered: {failed[:3]}")
            _require(time.monotonic() < deadline,
                     f"{state['answered']} of {writes} writes answered "
                     f"within {timeout_s} s")
        seconds = t["end"] - t["start"]
        ordered = sorted(latencies)
        return {
            "writes": writes,
            "clients": len(self.clients),
            "in_flight": len(self.clients) * min(pseudonyms, per_client),
            "seconds": seconds,
            "writes_per_sec": writes / seconds,
            "latency_p50_ms": 1e3 * statistics.median(ordered),
            "latency_p99_ms": 1e3 * ordered[min(len(ordered) - 1,
                                                int(0.99 * len(ordered)))],
            "replies": replies,
        }

    def wait_executed(self, commands: int, timeout_s: float = 30.0) -> bool:
        """Wait until every replica executed ``commands`` commands."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            counts = on_loop(self.transport, lambda: [
                len(r.state_machine.get()) for r in self.replicas])
            if min(counts) >= commands:
                return True
            time.sleep(0.01)
        return False


def run_arm(writes: int, pseudonyms: int, timeout_s: float = 120.0,
            **options) -> dict:
    """One supernode on ``options`` (see :class:`Supernode`) driven with
    ``writes`` closed-loop writes, with the checks: every write answered
    exactly once with its AppendLog index, the replicas' executed logs
    equal and holding every write once, and no error logged (a
    collector error included). Raises ``GateFailure`` on a failed check;
    returns the figures, ``executed`` (the set of executed payloads), the
    ProxyLeaders' vote counts by message shape and their synchronous
    trackers' drain-width histograms (empty for the other trackers), and
    ``serving``: the commands the leaders and ingest batchers refused by
    reason (``rejected``), the leaders' ingest deliveries
    (``ingest_counts``), the ProxyLeaders' vote acks by how they arrived
    (``ack_rows``: rows of batch frames through the wire sink against
    ack messages delivered one by one), and the payloads the server
    transport's wire sinks took whole (``sink_frames``, holding
    ``sink_messages`` messages)."""
    with Supernode(**options) as node:
        figures = node.write_closed_loop(writes, pseudonyms, timeout_s)
        _require(node.wait_executed(writes),
                 "the replicas did not execute every write in time")
        logs, executed, errors, shapes, widths, serving = on_loop(
            node.transport, lambda: (
                [executed_prefix(r) for r in node.replicas],
                [executed_commands(r) for r in node.replicas],
                node.errors(),
                [dict(p.votes_by_shape) for p in node.proxy_leaders],
                [dict(getattr(p.tracker, "drain_widths", {}))
                 for p in node.proxy_leaders],
                node.serving()))
    replies = figures.pop("replies")
    twice = [p for p, got in replies.items() if len(got) != 1]
    _require(not twice, f"{len(twice)} writes answered more than once")
    _require(len(replies) == writes,
             f"{len(replies)} of {writes} writes answered")
    _require(all(log == logs[0] for log in logs),
             "the replicas' executed logs differ")
    commands = executed[0]
    index = {payload: i for i, payload in enumerate(commands)}
    _require(len(index) == len(commands), "a write executed twice")
    _require(set(index) == set(replies),
             "the executed log is not the set of writes")
    wrong = [p for p, got in replies.items() if got[0] != b"%d" % index[p]]
    _require(not wrong, f"{len(wrong)} replies differ from the state "
                        f"machine's index")
    _require(not errors, f"errors were logged: {errors[:3]}")
    return {**figures, "executed": set(commands),
            "votes_by_shape": shapes, "drain_widths": widths,
            "serving": serving}
