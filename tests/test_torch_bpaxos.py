"""The port's SimpleBPaxos and SimpleGcBPaxos clusters vs the JAX
package's.

(a) ``TestSimpleBPaxos`` of ``tests/protocols/test_simplebpaxos.py`` and
the non-Simulator cases of ``tests/protocols/test_simplegcbpaxos.py``,
repeated on the port's harness, on the host backends and on the
``"cuda"`` ones at ``device="cpu"`` (the plain versions of K10 and K12).
The Simulator cases are in ``tests/test_torch_sim.py``.
(b) Cross-package parity: the same seed and proposals through the JAX
clusters with ``dep_backend="tpu"`` / ``gc_backend="tpu"`` (on JAX's
CPU backend) and the port's with ``"cuda"`` on the CPU give equal
committed ``(value, deps)`` per vertex, replies and state machines, and
in SimpleGcBPaxos equal ``gc_watermark``s and unpruned vertex sets,
through a partition and a ``CommitSnapshot`` catch-up; a GC state
carried across mid-run by ``convert.watermark_vector_from_numpy``
continues alike.
(c) A behaviour of the reference that the port reproduces on purpose:
a replica that catches up by adopting a snapshot never answers the
clients of the vertices it owed replies for.
(d) The replica's one host-side departure (the graph gets only
unexecuted dependencies), the refusals, and the bench end to end.
"""

import dataclasses

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import bpaxos_sim
from frankenpaxos_tpu_torch.protocols.epaxos import device_deps
from frankenpaxos_tpu_torch.protocols.simplebpaxos import (
    BPaxosLeader,
    SimpleBPaxosConfig,
    VertexIdPrefixSet,
)
from frankenpaxos_tpu_torch.protocols.simplebpaxos.harness import (
    gc_roles,
    make_bpaxos,
    make_gc_bpaxos,
    unpruned,
)
from frankenpaxos_tpu_torch.protocols.simplegcbpaxos import (
    GcBPaxosAcceptor,
    GcBPaxosConfig,
)
from frankenpaxos_tpu_torch.runtime import (
    FakeLogger,
    LogLevel,
    PickleSerializer,
    SimTransport,
)
from frankenpaxos_tpu_torch.statemachine import GetRequest, SetRequest
import pytest
import torch

from frankenpaxos_tpu import statemachine as jsm
from frankenpaxos_tpu.protocols import simplegcbpaxos as jgc
from frankenpaxos_tpu.protocols.simplebpaxos.replica import (
    BPaxosClient as JClient,
)
from frankenpaxos_tpu.runtime import (
    FakeLogger as JFakeLogger,
    LogLevel as JLogLevel,
    PickleSerializer as JPickleSerializer,
    SimTransport as JSimTransport,
)
from tests.protocols import test_simplebpaxos as jt, test_simplegcbpaxos as jgt

SER = PickleSerializer()
JSER = JPickleSerializer()
#: The port's device-backed options, on the plain versions.
CUDA = dict(dep_backend="cuda", device="cpu")
GC_CUDA = dict(dep_backend="cuda", gc_backend="cuda", device="cpu")


def set_bytes(key, value, ser=SER, set_request=SetRequest):
    return ser.to_bytes(set_request(((key, value),)))


# --- (a) the reference's cases, on the port ----------------------------------


@pytest.mark.parametrize("backend", ["host", "cuda"])
class TestSimpleBPaxos:
    def _make(self, backend, **kwargs):
        return make_bpaxos(dep_backend=backend, device="cpu", **kwargs)

    def test_single_command(self, backend):
        transport, _, replicas, clients = self._make(backend)
        got = []
        clients[0].propose(0, set_bytes("k", "v"), got.append)
        transport.deliver_all()
        assert len(got) == 1
        for replica in replicas:
            assert replica.state_machine.get() == {"k": "v"}

    def test_sequential_commands(self, backend):
        transport, _, replicas, clients = self._make(backend)
        got = []
        for i in range(5):
            clients[0].propose(0, set_bytes("k", str(i)), got.append)
            transport.deliver_all()
        assert len(got) == 5
        for replica in replicas:
            assert replica.state_machine.get() == {"k": "4"}

    def test_concurrent_conflicting_commands(self, backend):
        transport, _, replicas, clients = self._make(backend, num_clients=3)
        for i, client in enumerate(clients):
            client.propose(0, set_bytes("k", str(i)))
        transport.deliver_all()
        states = [r.state_machine.get() for r in replicas]
        assert states[0] == states[1]

    def test_read_after_write(self, backend):
        transport, _, replicas, clients = self._make(backend)
        clients[0].propose(0, set_bytes("x", "9"))
        transport.deliver_all()
        got = []
        clients[0].propose(0, SER.to_bytes(GetRequest(("x",))),
                           lambda r: got.append(SER.from_bytes(r)))
        transport.deliver_all()
        assert got and got[0].key_values == (("x", "9"),)

    def test_f2(self, backend):
        transport, _, replicas, clients = self._make(backend, f=2)
        got = []
        clients[0].propose(0, set_bytes("k", "v"), got.append)
        transport.deliver_all()
        assert len(got) == 1


def _gc(backend, **kwargs):
    extra = GC_CUDA if backend == "cuda" else {}
    return make_gc_bpaxos(**kwargs, **extra)


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_gc_prunes_consensus_state(backend):
    transport, _, proposers, acceptors, replicas, clients = _gc(
        backend, send_gc_every_n=3)
    got = []
    for i in range(9):
        clients[0].propose(0, set_bytes("k", str(i)), got.append)
        transport.deliver_all()
    assert len(got) == 9
    for replica in replicas:
        assert replica.state_machine.get() == {"k": "8"}
    assert any(any(w > 0 for w in a.gc_watermark) for a in acceptors)
    for role in (*acceptors, *proposers):
        for vertex_id in role.states:
            assert vertex_id.instance_number \
                >= role.gc_watermark[vertex_id.replica_index]


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_gc_still_correct_after_pruning(backend):
    transport, _, _, _, replicas, clients = _gc(backend, send_gc_every_n=2)
    for i in range(12):
        clients[0].propose(0, set_bytes("x", str(i)))
        transport.deliver_all()
    states = [r.state_machine.get() for r in replicas]
    assert all(s == {"x": "11"} for s in states)


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_snapshot_vertices_get_chosen_and_executed(backend):
    transport, _, _, _, replicas, clients = _gc(
        backend, send_gc_every_n=2, snapshot_every_n=2)
    for i in range(12):
        clients[0].propose(i, set_bytes("x", str(i)))
        transport.deliver_all()
    assert any(r.snapshot is not None for r in replicas)
    snapshots = [r.snapshot for r in replicas if r.snapshot is not None]
    for replica in replicas:
        if replica.snapshot is not None:
            assert len(replica.history) < 12
    assert all(s.state_machine for s in snapshots)


def _far_behind(transport, clients, ser, set_request, laggard="replica-2"):
    """The reference's far-behind scenario: 12 writes with the laggard
    cut off, heal, one more write, fire the laggard's recover timers.
    Returns the replies by pseudonym."""
    replies = {}
    transport.partition(laggard)
    for i in range(12):
        clients[0].propose(i, ser.to_bytes(set_request((("x", str(i)),))),
                           lambda r, i=i: replies.setdefault(i, r))
        transport.deliver_all()
    transport.heal(laggard)
    clients[0].propose(100, ser.to_bytes(set_request((("x", "final"),))),
                       lambda r: replies.setdefault(100, r))
    transport.deliver_all()
    for timer in list(transport.running_timers()):
        if timer.address == laggard \
                and timer.name.startswith("recoverVertex"):
            transport.trigger_timer(timer.id)
    transport.deliver_all()
    return replies


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_far_behind_replica_catches_up_via_commit_snapshot(backend):
    transport, config, proposers, acceptors, replicas, clients = _gc(
        backend, send_gc_every_n=2, num_replicas=3, snapshot_every_n=2)
    laggard = replicas[2]
    transport.partition("replica-2")
    for i in range(12):
        clients[0].propose(i, set_bytes("x", str(i)))
        transport.deliver_all()
    assert any(any(w > 0 for w in p.gc_watermark) for p in proposers)
    assert any(r.snapshot is not None for r in replicas[:2])
    assert laggard.state_machine.get() == {}
    transport.heal("replica-2")
    clients[0].propose(100, set_bytes("x", "final"))
    transport.deliver_all()
    for timer in list(transport.running_timers()):
        if timer.address == "replica-2" \
                and timer.name.startswith("recoverVertex"):
            transport.trigger_timer(timer.id)
    transport.deliver_all()
    assert laggard.snapshot is not None, "laggard never got a snapshot"
    assert laggard.state_machine.get() == replicas[0].state_machine.get()
    assert laggard.state_machine.get().get("x") == "final"


def test_gc_watermark_cuda_backend_matches_host():
    """The end-to-end half of ``test_gc_watermark_tpu_backend_matches_
    host``: the GC flow with K12's plain version prunes as the host
    oracle does."""
    clusters = [make_gc_bpaxos(send_gc_every_n=2, seed=5),
                make_gc_bpaxos(send_gc_every_n=2, seed=5, gc_backend="cuda",
                               device="cpu")]
    for transport, _, _, _, _, clients in clusters:
        for i in range(6):
            clients[0].propose(0, set_bytes("k", str(i)))
            transport.deliver_all()
    (_, _, proposers, *_), (_, _, proposers_c, *_) = clusters
    assert proposers[0].gc_watermark == proposers_c[0].gc_watermark
    assert proposers[0].gc_watermark[0] > 0
    assert set(proposers[0].states) == set(proposers_c[0].states)


# --- (b) cross-package parity ------------------------------------------------


def _value(command_or_noop, ser) -> tuple:
    name = type(command_or_noop).__name__
    if name == "Command":
        c = command_or_noop
        return (c.client_address, c.client_pseudonym, c.client_id,
                repr(ser.from_bytes(c.command)))
    return (name,)


def plain_committed(replica, ser) -> dict:
    """``(leader, id) -> (value, sorted deps)`` with commands decoded,
    comparable across the packages."""
    return {(int(v[0]), int(v[1])): (
        _value(c.command_or_noop, ser),
        tuple(sorted((int(a), int(b))
                     for a, b in c.dependencies.materialize())))
        for v, c in replica.commands.items()}


def plain_vertices(vertices) -> set:
    return {(int(a), int(b)) for a, b in vertices}


def _drive_simple(make, ser, set_request, rounds: int):
    """Three clients: a round of writes to two keys, then rounds on one
    shared key; returns the replicas and every reply, decoded."""
    transport, _, replicas, clients = make()
    replies = []
    for r in range(rounds):
        for i, client in enumerate(clients):
            key = f"k{i % 2}" if r == 0 else "shared"
            client.propose(r, ser.to_bytes(set_request(((key,
                                                         f"{r}.{i}"),))),
                           lambda b: replies.append(repr(ser.from_bytes(b))))
        transport.deliver_all()
    return transport, replicas, replies


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("f", [1, 2])
def test_cuda_dep_backend_matches_the_reference(f, seed):
    """The JAX cluster on ``dep_backend="tpu"`` and the port's on
    ``"cuda"`` (CPU): equal committed vertices on every replica, equal
    state machines and replies; every vertex's deps went through K10."""
    _, jreplicas, jreplies = _drive_simple(
        lambda: jt.make_bpaxos(f=f, num_clients=3, seed=seed,
                               dep_backend="tpu"),
        JSER, jsm.SetRequest, rounds=4)
    counts = bpaxos_sim.DepsetCounts()

    def make_port():
        cluster = make_bpaxos(f=f, num_clients=3, seed=seed, **CUDA)
        cluster[0].runtime_metrics = counts
        return cluster

    _, preplicas, preplies = _drive_simple(make_port, SER, SetRequest,
                                           rounds=4)
    assert preplies == jreplies and len(preplies) == 12
    assert counts.calls == 12 and counts.span_fallbacks == 0
    for jr, pr in zip(jreplicas, preplicas):
        assert plain_committed(pr, SER) == plain_committed(jr, JSER)
        assert len(pr.commands) == 12
        assert pr.state_machine.get() == jr.state_machine.get()


def jax_gc_cluster(f=1, send_gc_every_n=2, seed=0, num_replicas=3,
                   snapshot_every_n=2):
    """The reference's ``make_gc_bpaxos`` with its Leaders on
    ``dep_backend="tpu"`` (the reference harness leaves them on the
    host) and every GC role on ``gc_backend="tpu"``."""
    logger = JFakeLogger(JLogLevel.FATAL)
    transport = JSimTransport(logger)
    n = 2 * f + 1
    config = jgc.GcBPaxosConfig(
        f=f,
        leader_addresses=tuple(f"leader-{i}" for i in range(f + 1)),
        proposer_addresses=tuple(f"proposer-{i}" for i in range(f + 1)),
        dep_service_node_addresses=tuple(f"dep-{i}" for i in range(n)),
        acceptor_addresses=tuple(f"acceptor-{i}" for i in range(n)),
        replica_addresses=tuple(f"replica-{i}"
                                for i in range(num_replicas)),
        garbage_collector_addresses=tuple(f"gc-{i}"
                                          for i in range(num_replicas)))
    for i, a in enumerate(config.leader_addresses):
        jgc.GcBPaxosLeader(a, transport, logger, config, seed=seed + i,
                           dep_backend="tpu")
    for i, a in enumerate(config.proposer_addresses):
        jgc.GcBPaxosProposer(a, transport, logger, config,
                             seed=seed + 10 + i, gc_backend="tpu")
    for a in config.dep_service_node_addresses:
        jgc.GcBPaxosDepServiceNode(a, transport, logger, config,
                                   jsm.KeyValueStore(), gc_backend="tpu")
    for a in config.acceptor_addresses:
        jgc.GcBPaxosAcceptor(a, transport, logger, config, gc_backend="tpu")
    replicas = [jgc.GcBPaxosReplica(a, transport, logger, config,
                                    jsm.KeyValueStore(),
                                    send_gc_every_n=send_gc_every_n,
                                    snapshot_every_n=snapshot_every_n,
                                    seed=seed + 30 + i)
                for i, a in enumerate(config.replica_addresses)]
    for a in config.garbage_collector_addresses:
        jgc.GarbageCollector(a, transport, logger, config)
    clients = [JClient("client-0", transport, logger, config,
                       seed=seed + 50)]
    return transport, replicas, clients


def _jax_gc_roles(transport) -> list:
    return [a for a in transport.actors.values()
            if isinstance(a, (jgc.GcBPaxosProposer,
                              jgc.GcBPaxosDepServiceNode,
                              jgc.GcBPaxosAcceptor))]


def _jax_unpruned(role) -> set:
    if isinstance(role, jgc.GcBPaxosDepServiceNode):
        return plain_vertices(role.dependencies_cache)
    return plain_vertices(role.states)


def _assert_gc_clusters_equal(jt_, jreplicas, pt, preplicas) -> None:
    for jr, pr in zip(jreplicas, preplicas):
        assert plain_committed(pr, SER) == plain_committed(jr, JSER)
        assert pr.state_machine.get() == jr.state_machine.get()
        assert (pr.snapshot is None) == (jr.snapshot is None)
        if pr.snapshot is not None:
            assert pr.snapshot.id == jr.snapshot.id
        assert pr._frontier == jr._frontier
    jroles, proles = _jax_gc_roles(jt_), gc_roles(pt)
    assert [r.address for r in proles] == [r.address for r in jroles]
    for jrole, prole in zip(jroles, proles):
        assert prole.gc_watermark == jrole.gc_watermark
        assert plain_vertices(unpruned(prole)) == _jax_unpruned(jrole)


@pytest.mark.parametrize("seed", [0, 3])
def test_gc_cuda_backends_match_the_reference_through_a_catch_up(seed):
    """The far-behind scenario in both packages, every device backend
    on: equal committed vertices, states, snapshots, frontiers, replies,
    ``gc_watermark``s and unpruned sets; the laggard caught up through
    a snapshot and answers what the reference's answers."""
    jtransport, jreplicas, jclients = jax_gc_cluster(seed=seed)
    jreplies = _far_behind(jtransport, jclients, JSER, jsm.SetRequest)
    counts = bpaxos_sim.DepsetCounts()
    ptransport, _, _, _, preplicas, pclients = make_gc_bpaxos(
        send_gc_every_n=2, seed=seed, num_replicas=3, snapshot_every_n=2,
        **GC_CUDA)
    ptransport.runtime_metrics = counts
    preplies = _far_behind(ptransport, pclients, SER, SetRequest)
    assert {k: repr(SER.from_bytes(v)) for k, v in preplies.items()} \
        == {k: repr(JSER.from_bytes(v)) for k, v in jreplies.items()}
    assert preplicas[2].snapshot is not None
    assert preplicas[2].state_machine.get().get("x") == "final"
    assert counts.calls > 13 and counts.span_fallbacks == 0
    _assert_gc_clusters_equal(jtransport, jreplicas, ptransport, preplicas)


def test_gc_state_carried_mid_run_continues_alike():
    """Run both packages to mid-run, carry every JAX GC role's quorum
    watermark vector into the port's role, and continue: the carried
    vectors equal the port's own, and the two clusters stay equal."""
    jtransport, jreplicas, jclients = jax_gc_cluster(seed=1)
    ptransport, _, _, _, preplicas, pclients = make_gc_bpaxos(
        send_gc_every_n=2, seed=1, num_replicas=3, snapshot_every_n=2,
        **GC_CUDA)
    clusters = ((jtransport, jclients, JSER, jsm.SetRequest),
                (ptransport, pclients, SER, SetRequest))
    for transport, clients, ser, set_request in clusters:
        for i in range(6):
            clients[0].propose(i, ser.to_bytes(set_request(((f"k{i % 2}",
                                                             str(i)),))))
            transport.deliver_all()
    for jrole, prole in zip(_jax_gc_roles(jtransport), gc_roles(ptransport)):
        carried = convert.watermark_vector_from_numpy(
            jrole._gc_vector._watermarks)
        assert (convert.watermark_vector_to_numpy(carried)
                == convert.watermark_vector_to_numpy(prole._gc_vector)).all()
        prole._gc_vector = carried
    for transport, clients, ser, set_request in clusters:
        for i in range(6, 12):
            clients[0].propose(i, ser.to_bytes(set_request(((f"k{i % 2}",
                                                             str(i)),))))
            transport.deliver_all()
    assert any(w > 0 for r in gc_roles(ptransport) for w in r.gc_watermark)
    _assert_gc_clusters_equal(jtransport, jreplicas, ptransport, preplicas)


# --- (c) the reference's unanswered clients, reproduced ----------------------


def test_snapshot_catch_up_leaves_the_laggards_clients_unanswered():
    """A replica answers the vertices whose instance number it owns
    (``instance_number % replicas``) and skips a command its client
    table has seen without answering again. A laggard that adopts a
    peer's snapshot never executes the vertices it covers, so their
    clients stay unanswered, in both packages alike (the host backends
    here)."""
    jtransport, _, _, _, jreplicas, jclients = jgt.make_gc_bpaxos(
        send_gc_every_n=2, num_replicas=3, snapshot_every_n=2)
    jreplies = _far_behind(jtransport, jclients, JSER, jsm.SetRequest)
    ptransport, _, _, _, preplicas, pclients = make_gc_bpaxos(
        send_gc_every_n=2, num_replicas=3, snapshot_every_n=2)
    ran = bpaxos_sim.Executions(preplicas)
    preplies = _far_behind(ptransport, pclients, SER, SetRequest)
    assert sorted(preplies) == sorted(jreplies)
    missing = sorted({*range(12), 100} - set(preplies))
    lost = sorted(key[1] for key, vertex in ran.ran[0].items()
                  if vertex.instance_number % 3 == 2
                  and key not in ran.ran[2])
    assert missing == lost == [2, 5, 6, 9, 11, 100]
    assert preplicas[2].snapshot is not None
    # All three replicas still hold the same state.
    states = [r.state_machine.get() for r in preplicas]
    assert states[0] == states[1] == states[2]
    assert [r.state_machine.get() for r in jreplicas] == states


# --- (d) host-side departure, refusals, the bench ----------------------------


def test_graph_gets_only_unexecuted_dependencies():
    """Commits on one hot key: each replica hands its dependency graph
    the part of a vertex's deps it has not executed (the reference hands
    the whole set), and the cluster ends as the reference's does."""
    transport, _, replicas, clients = make_bpaxos(num_clients=3)
    handed = []
    real = replicas[0].dependency_graph.commit

    def spy(key, sequence_number, dependencies):
        dependencies = set(dependencies)
        handed.append(dependencies)
        assert not any(replicas[0].graph_executed.contains(d)
                       for d in dependencies)
        return real(key, sequence_number, dependencies)

    replicas[0].dependency_graph.commit = spy
    for r in range(6):
        for i, client in enumerate(clients):
            client.propose(r, set_bytes("hot", f"{r}{i}"), lambda _: None)
        transport.deliver_all()
    for replica in replicas:
        assert replica.executed_count == 18
        assert replica.graph_executed.materialize() == set(replica.commands)
    assert max(len(d) for d in handed) < max(
        c.dependencies.size for c in replicas[0].commands.values())
    _, jreplicas, _ = _drive_simple(
        lambda: jt.make_bpaxos(num_clients=3), JSER, jsm.SetRequest, 2)
    _, preplicas, _ = _drive_simple(lambda: make_bpaxos(num_clients=3), SER,
                                    SetRequest, 2)
    assert plain_committed(preplicas[0], SER) == \
        plain_committed(jreplicas[0], JSER)


def test_tpu_backends_are_refused():
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    config = SimpleBPaxosConfig(
        f=1, leader_addresses=("l0", "l1"), proposer_addresses=("p0", "p1"),
        dep_service_node_addresses=("d0", "d1", "d2"),
        acceptor_addresses=("a0", "a1", "a2"),
        replica_addresses=("r0", "r1"))
    with pytest.raises(ValueError, match="cuda"):
        BPaxosLeader("l0", transport, logger, config, dep_backend="tpu")
    gc_config = GcBPaxosConfig(**dataclasses.asdict(config),
                               garbage_collector_addresses=("g0", "g1"))
    with pytest.raises(ValueError, match="cuda"):
        GcBPaxosAcceptor("a0", transport, logger, gc_config,
                         gc_backend="tpu")
    for kwargs in ({"dep_backend": "tpu"}, {"gc_backend": "tpu"}):
        with pytest.raises(ValueError, match="cuda"):
            make_gc_bpaxos(**kwargs)


def test_cuda_backends_need_a_gpu_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_bpaxos(dep_backend="cuda")
    for kwargs in ({"dep_backend": "cuda"}, {"gc_backend": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_gc_bpaxos(**kwargs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bpaxos_sim.run()
    make_bpaxos(dep_backend="host")
    transport, *_ = make_gc_bpaxos(**GC_CUDA)
    assert {r.device for r in gc_roles(transport)} == {torch.device("cpu")}


def test_bpaxos_sim_end_to_end_small():
    """Every arm, both backends, every gate, on the CPU at 512 commands
    (no worker processes)."""
    result = bpaxos_sim.run("cpu", commands=512)
    assert set(result["arms"]) == set(bpaxos_sim.ARMS)
    for name, arm in result["arms"].items():
        host, cuda = arm["host"], arm["cuda"]
        assert host["depset_batch_calls"] == 0
        assert cuda["depset_batch_calls"] >= cuda["commands"]
        assert cuda["depset_span_fallbacks"] == 0
        if name == bpaxos_sim.GC_ARM:
            assert cuda["garbage_collects"] == host["garbage_collects"] > 0
            assert cuda["pruned_states"] == host["pruned_states"] > 0
            assert cuda["laggard_snapshot_id"] is not None
            assert cuda["unanswered"] == host["unanswered"]
        else:
            assert host["commands"] == cuda["commands"] == 512
    # On the CPU the wrappers run their plain versions: no launches.
    assert result["launches"] == {"union_reduce": 0, "quorum_watermark": 0}


def test_bpaxos_sim_gate_catches_wrong_dependencies(monkeypatch):
    """A K10 stand-in that drops every dependency: the cuda run no
    longer matches the host run, and a gate says so."""
    def no_deps(sets, num_leaders, device=None, metrics=None):
        if metrics is not None:
            metrics.depset_batch(len(sets))
        return VertexIdPrefixSet(num_leaders)

    monkeypatch.setattr(device_deps, "union_many", no_deps)
    monkeypatch.setattr(bpaxos_sim, "ARMS", {"simple-conflict25": 0.25})
    with pytest.raises(bpaxos_sim.GateFailure):
        bpaxos_sim.run("cpu", commands=256)
