"""The port's EPaxos cluster vs the JAX package's.

(a) The ``TestEPaxosIntegration`` cases of ``tests/protocols/
test_epaxos.py`` and its end-to-end dependency-graph case, repeated on
the port's harness, with ``dep_backend="cuda"`` on ``device="cpu"``
(the plain versions of K10 and K11) where the reference used ``"tpu"``.
The reference's ``Simulator``-based cases
(``test_simulation_committed_agreement*``) wait for the port of
``sim/`` (ROADMAP.md queue 1).
(b) Cross-package parity: the same seed and proposals through the JAX
cluster with ``dep_backend="tpu"`` (on JAX's CPU backend) and the
port's with ``dep_backend="cuda", device="cpu"`` give equal committed
triples, state machines and replies, at f = 1 and f = 2.
(c) The routing the slice rests on: at f = 1 the device path never runs
on that traffic, at f = 2 it runs on every fast-path decision; ``"tpu"``
is refused and ``"cuda"`` without a GPU raises at construction.
(d) The port's host-side copies that differ in code from the
reference's: the KeyValueStore's keyed top-k conflict index and
``InstancePrefixSet.materialize`` give the reference's answers.
(e) The cluster bench and the depset_lt twin end to end, small.
"""

import random

from frankenpaxos_tpu_torch.bench import depset_lt, epaxos_sim
from frankenpaxos_tpu_torch.compact import IntPrefixSet
from frankenpaxos_tpu_torch.protocols.epaxos import (
    EPaxosConfig,
    EPaxosReplica,
    EPaxosReplicaOptions,
)
from frankenpaxos_tpu_torch.protocols.epaxos.harness import (
    committed_log,
    committed_triples,
    make_epaxos,
)
from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    Instance,
    InstancePrefixSet,
)
from frankenpaxos_tpu_torch.runtime import (
    FakeLogger,
    LogLevel,
    PickleSerializer,
    SimTransport,
)
from frankenpaxos_tpu_torch.statemachine import (
    AppendLog,
    GetRequest,
    KeyValueStore,
    SetRequest,
)
from frankenpaxos_tpu_torch.utils.topk import TUPLE_VERTEX_LIKE
import pytest
import torch

from frankenpaxos_tpu import compact as jcompact, statemachine as jsm
from frankenpaxos_tpu.protocols.epaxos import instance_prefix_set as jips
from frankenpaxos_tpu.runtime import PickleSerializer as JPickleSerializer
from frankenpaxos_tpu.utils.topk import TUPLE_VERTEX_LIKE as JTUPLE_VERTEX_LIKE
from tests.protocols import test_epaxos as jt

SER = PickleSerializer()
JSER = JPickleSerializer()
#: The port's device-backed option, on the plain versions.
CUDA = dict(dep_backend="cuda", device="cpu")


# --- state carried across -------------------------------------------------------


def to_port(s) -> InstancePrefixSet:
    """A JAX ``InstancePrefixSet`` rebuilt as the port's, through its
    ``(watermark, values)`` columns."""
    return InstancePrefixSet(s.num_replicas, [
        IntPrefixSet(c.watermark, set(c.values)) for c in s.columns])


def to_jax(s: InstancePrefixSet):
    """The port's ``InstancePrefixSet`` rebuilt as the JAX package's."""
    return jips.InstancePrefixSet(s.num_replicas, [
        jcompact.IntPrefixSet(c.watermark, set(c.values))
        for c in s.columns])


def _plain_command(command_or_noop, ser) -> tuple:
    if not hasattr(command_or_noop, "command"):
        return ("noop",)
    c = command_or_noop
    return (c.client_address, c.client_pseudonym, c.client_id,
            repr(ser.from_bytes(c.command)))


def plain_log(triples: dict, ser, convert=lambda s: s) -> dict:
    """``(replica, number) -> (command, seq, deps)`` with the command's
    payload decoded and the deps as the port's set (``convert``), so
    that the two packages' logs compare."""
    return {(int(i[0]), int(i[1])): (_plain_command(t[0], ser), t[1],
                                     convert(t[2]))
            for i, t in triples.items()}


def test_prefix_sets_cross_and_come_back():
    rng = random.Random(7)
    for _ in range(20):
        cols = [jcompact.IntPrefixSet(rng.randrange(20),
                                      {rng.randrange(40) for _ in range(4)})
                for _ in range(3)]
        jset = jips.InstancePrefixSet(3, cols)
        port = to_port(jset)
        assert ({tuple(x) for x in port.materialize()}
                == {tuple(x) for x in jset.materialize()})
        assert to_jax(port) == jset


# --- (a) the reference's integration cases, on the port ------------------------


def run_set(transport, client, pseudonym, key, value, got=None):
    client.propose(pseudonym, SER.to_bytes(SetRequest(((key, value),))),
                   None if got is None else got.append)
    transport.deliver_all()


class TestEPaxosIntegration:
    def test_single_command(self):
        transport, _, replicas, clients = make_epaxos()
        got = []
        run_set(transport, clients[0], 0, "k", "v", got)
        assert len(got) == 1
        base = committed_triples(replicas[0])
        assert len(base) == 1
        for replica in replicas[1:]:
            assert committed_triples(replica).keys() == base.keys()

    def test_sequential_commands_execute_everywhere(self):
        transport, _, replicas, clients = make_epaxos()
        results = []
        for i in range(6):
            run_set(transport, clients[0], 0, "k", str(i), results)
        assert len(results) == 6
        for replica in replicas:
            assert replica.state_machine.get() == {"k": "5"}

    def test_conflicting_commands_from_multiple_clients(self):
        transport, _, replicas, clients = make_epaxos(num_clients=3)
        for i, client in enumerate(clients):
            client.propose(0, SER.to_bytes(SetRequest((("k", str(i)),))))
        transport.deliver_all()
        states = [r.state_machine.get() for r in replicas]
        assert states[0] == states[1] == states[2]
        assert states[0]["k"] in {"0", "1", "2"}

    def test_read_write(self):
        transport, _, replicas, clients = make_epaxos()
        run_set(transport, clients[0], 0, "x", "7")
        got = []
        clients[0].propose(0, SER.to_bytes(GetRequest(("x",))),
                           lambda r: got.append(SER.from_bytes(r)))
        transport.deliver_all()
        assert got and got[0].key_values == (("x", "7"),)

    def test_resend_deduplicated(self):
        transport, _, replicas, clients = make_epaxos(
            state_machine_factory=AppendLog)
        got = []
        clients[0].propose(0, b"only-once", got.append)
        for timer in list(transport.running_timers()):
            if timer.name.startswith("resend-"):
                transport.trigger_timer(timer.id)
        transport.deliver_all()
        assert len(got) == 1
        for replica in replicas:
            assert replica.state_machine.get().count(b"only-once") == 1

    def test_f2(self):
        transport, _, replicas, clients = make_epaxos(f=2)
        got = []
        run_set(transport, clients[0], 0, "k", "v", got)
        assert len(got) == 1

    @pytest.mark.parametrize("f", [1, 2])
    def test_cuda_dep_backend_matches(self, f):
        """dep_backend=cuda: conflicting proposals (slow-path unions on
        K10's plain version, fast-path equality on K11's) commit
        identically on every replica and match a host-backend run
        command for command."""
        runs = {}
        for backend in ("host", "cuda"):
            transport, _, replicas, clients = make_epaxos(
                f=f, num_clients=3, dep_backend=backend, device="cpu")
            for i, client in enumerate(clients):
                client.propose(0, SER.to_bytes(
                    SetRequest(((f"k{i % 2}", str(i)),))))
            transport.deliver_all()
            for i, client in enumerate(clients):
                client.propose(1, SER.to_bytes(
                    SetRequest((("shared", str(i)),))))
            transport.deliver_all()
            states = [r.state_machine.get() for r in replicas]
            assert all(s == states[0] for s in states[1:]), backend
            runs[backend] = committed_log(replicas[0])
        assert runs["host"] == runs["cuda"]


@pytest.mark.parametrize("graph", ["zigzag", "incremental"])
def test_alternate_dependency_graphs_end_to_end(graph):
    transport, _, replicas, clients = make_epaxos(dependency_graph=graph)
    for i in range(8):
        clients[i % len(clients)].propose(
            i, SER.to_bytes(SetRequest(((f"k{i % 3}", str(i)),))),
            lambda _: None)
        transport.deliver_all()
    transport.deliver_all()
    for r in replicas:
        assert r.dependency_graph.num_vertices == 0
    states = [r.state_machine.to_bytes() for r in replicas]
    assert all(s == states[0] for s in states)
    kv = replicas[0].state_machine
    reply = SER.from_bytes(kv.run(SER.to_bytes(GetRequest(("k0", "k1",
                                                           "k2")))))
    assert reply.key_values == (("k0", "6"), ("k1", "7"), ("k2", "5"))


# --- (b) cross-package parity ----------------------------------------------------


def _drive(make, set_request, ser, f: int, seed: int, rounds: int):
    """Three clients: a round of writes to two keys, then rounds on one
    shared key; returns the replicas and every reply, decoded."""
    transport, _, replicas, clients = make(f, seed)
    replies = []
    for r in range(rounds):
        for i, client in enumerate(clients):
            key = f"k{i % 2}" if r == 0 else "shared"
            client.propose(r, ser.to_bytes(set_request(((key,
                                                         f"{r}.{i}"),))),
                           lambda b: replies.append(repr(ser.from_bytes(b))))
        transport.deliver_all()
    return replicas, replies


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("f", [1, 2])
def test_cuda_backend_matches_the_reference(f, seed):
    """The JAX cluster on ``dep_backend="tpu"`` and the port's on
    ``"cuda"`` (CPU): equal committed triples on every replica, equal
    state machines and equal replies."""
    jreplicas, jreplies = _drive(
        lambda f, seed: jt.make_epaxos(f=f, num_clients=3, seed=seed,
                                       dep_backend="tpu"),
        jsm.SetRequest, JSER, f, seed, rounds=4)
    counts = epaxos_sim.DepsetCounts()

    def make_port(f, seed):
        cluster = make_epaxos(f=f, num_clients=3, seed=seed, **CUDA)
        cluster[0].runtime_metrics = counts
        return cluster

    preplicas, preplies = _drive(make_port, SetRequest, SER, f, seed,
                                 rounds=4)
    assert preplies == jreplies and len(preplies) == 12
    # At f = 2 the traffic reaches K11 on every decision and K10 on the
    # slow paths (more calls than commands); at f = 1 neither.
    assert (counts.calls > 12) if f == 2 else counts.calls == 0
    for jr, pr in zip(jreplicas, preplicas):
        want = plain_log(jt.committed_triples(jr), JSER, to_port)
        got = plain_log(committed_triples(pr), SER)
        assert got == want
        assert len(got) == 12
        assert pr.state_machine.get() == jr.state_machine.get()


# --- (c) routing -------------------------------------------------------------------


def _device_calls(f: int) -> epaxos_sim.DepsetCounts:
    transport, _, replicas, clients = make_epaxos(f=f, num_clients=3,
                                                  **CUDA)
    counts = epaxos_sim.DepsetCounts()
    transport.runtime_metrics = counts
    for r in range(3):
        for i, client in enumerate(clients):
            client.propose(r, SER.to_bytes(SetRequest((("shared",
                                                        f"{r}{i}"),))))
        transport.deliver_all()
    return counts


def test_f1_never_reaches_the_device():
    """At f = 1 the fast path counts one reply, which the host decides,
    and the slow path runs only after a recovery: 0 device calls."""
    assert _device_calls(1).calls == 0


def test_f2_reaches_the_device_on_every_decision():
    counts = _device_calls(2)
    assert counts.calls >= 9 and counts.span_fallbacks == 0


def test_tpu_backend_is_refused():
    transport = SimTransport(FakeLogger(LogLevel.FATAL))
    config = EPaxosConfig(f=1, replica_addresses=("a", "b", "c"))
    with pytest.raises(ValueError, match="cuda"):
        EPaxosReplica("a", transport, FakeLogger(LogLevel.FATAL), config,
                      KeyValueStore(), EPaxosReplicaOptions(
                          dep_backend="tpu"))


def test_cuda_backend_needs_a_gpu_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_epaxos(dep_backend="cuda")
    # The host backend needs no device; naming the CPU selects the
    # plain versions.
    make_epaxos(dep_backend="host")
    _, _, replicas, _ = make_epaxos(dep_backend="cuda", device="cpu")
    assert replicas[0].device == torch.device("cpu")


# --- (d) host-side code that differs from the reference's -----------------------


@pytest.mark.parametrize("seed", range(8))
def test_keyed_top_k_index_matches_the_reference(seed):
    """The port's KeyValueStore answers TopOne/TopK from its inverted
    index, with each posting list's maxima kept between queries; the
    reference scans every command. Same stream of puts, overwrites,
    removals and snapshots: same answers. Seeds 4-7 draw from a pool of
    3 commands, so that a vertex is often put again with the command it
    holds (the index skips that put)."""
    rng = random.Random(seed)
    keys = ["a", "b", "c", "d"]
    port = KeyValueStore().top_k_conflict_index(2, 3, TUPLE_VERTEX_LIKE)
    ref = jsm.KeyValueStore().top_k_conflict_index(2, 3, JTUPLE_VERTEX_LIKE)
    pool_rng = random.Random(seed)
    commands = [tuple(pool_rng.sample(keys, pool_rng.randrange(1, 3)))
                for _ in range(3 if seed >= 4 else 0)]

    def command():
        picked = (rng.choice(commands) if commands
                  else tuple(rng.sample(keys, rng.randrange(1, 3))))
        if rng.random() < 0.3:
            return (SER.to_bytes(GetRequest(picked)),
                    JSER.to_bytes(jsm.GetRequest(picked)))
        kvs = tuple((k, "v") for k in picked)
        return (SER.to_bytes(SetRequest(kvs)),
                JSER.to_bytes(jsm.SetRequest(kvs)))

    for _ in range(150):
        vertex = (rng.randrange(3), rng.randrange(30))
        op = rng.random()
        if op < 0.6:
            p, j = command()
            port.put(vertex, p)
            ref.put(vertex, j)
        elif op < 0.7:
            port.remove(vertex)
            ref.remove(vertex)
        elif op < 0.75:
            port.put_snapshot(vertex)
            ref.put_snapshot(vertex)
        p, j = command()
        assert port.get_conflicts(p) == ref.get_conflicts(j)
        assert (port.get_top_one_conflicts(p).get()
                == ref.get_top_one_conflicts(j).get())
        assert (port.get_top_k_conflicts(p).get()
                == ref.get_top_k_conflicts(j).get())


def test_graph_gets_only_unexecuted_dependencies():
    """Commits on one hot key: each replica hands its dependency graph
    the part of a command's deps it has not executed, and at the end it
    has executed every committed instance, as the reference does."""
    transport, _, replicas, clients = make_epaxos(f=2, num_clients=3)
    committed = []
    real = replicas[0].dependency_graph.commit

    def spy(key, sequence_number, dependencies):
        dependencies = set(dependencies)
        committed.append(dependencies)
        assert not any(replicas[0].graph_executed.contains(d)
                       for d in dependencies)
        return real(key, sequence_number, dependencies)

    replicas[0].dependency_graph.commit = spy
    for r in range(6):
        for i, client in enumerate(clients):
            client.propose(r, SER.to_bytes(SetRequest((("hot", f"{r}{i}"),))),
                           lambda _: None)
        transport.deliver_all()
    for replica in replicas:
        assert replica.executed_count == 18
        assert (replica.graph_executed.materialize()
                == set(committed_triples(replica)))
    # Later commits name the executed prefix of the hot key only through
    # their watermarks: what reached the graph is smaller than the deps.
    assert max(len(d) for d in committed) < max(
        t[2].size for t in committed_triples(replicas[0]).values())


def test_materialize_matches_the_reference():
    rng = random.Random(3)
    for _ in range(30):
        cols = [jcompact.IntPrefixSet(rng.randrange(50),
                                      {rng.randrange(90) for _ in range(6)})
                for _ in range(5)]
        jset = jips.InstancePrefixSet(5, cols)
        got = to_port(jset).materialize()
        assert got == jset.materialize()
        assert all(type(x) is Instance for x in got)


# --- (e) the benches, small --------------------------------------------------------


def test_epaxos_sim_end_to_end_small():
    """Both arms, both backends, every gate, on the CPU at 256
    commands."""
    result = epaxos_sim.run("cpu", commands=256)
    for name, arm in result["arms"].items():
        for backend in ("host", "cuda"):
            assert arm[backend]["commands"] == 256, (name, backend)
        assert arm["host"]["depset_batch_calls"] == 0
        # Every decision of the cuda run went through the device path.
        assert arm["cuda"]["depset_batch_calls"] == (
            256 + arm["cuda"]["slow_paths"])
        assert arm["cuda"]["slow_paths"] == arm["host"]["slow_paths"]
        assert arm["kernels"]["conflict_max_us"] is None  # not measured
    assert result["arms"]["conflict25"]["cuda"]["slow_paths"] > 0
    # The plain versions ran: no kernel launched.
    assert not any(result["launches"].values())


def test_epaxos_sim_gates_catch_a_wrong_reply(monkeypatch):
    """A reply that differs from the KeyValueStore's fails gate 1."""
    real = epaxos_sim.drive

    def corrupt(*args, **kwargs):
        run = real(*args, **kwargs)
        run["replies"][0] = b"wrong"
        return run

    monkeypatch.setattr(epaxos_sim, "drive", corrupt)
    with pytest.raises(epaxos_sim.GateFailure, match="KeyValueStore"):
        epaxos_sim.run("cpu", commands=64)


def test_depset_lt_end_to_end_small():
    """Both arms at two widths; the aggregates' gate ran on every drain
    (it raises otherwise)."""
    result = depset_lt.run("cpu", widths=(64, 256), blocks=1)
    assert sorted(result["pairs"]) == ["256", "64"]
    for width, pair in result["pairs"].items():
        assert pair["k10_shape"] == [int(width), 3, 32]
        assert pair["per_message"]["msgs_per_s"] > 0
    assert "decode" in result["left_out"]


def test_depset_lt_gate_catches_a_wrong_aggregate(monkeypatch):
    """A coalesced aggregate that differs from the per-message one fails
    the gate before any timing."""
    real = depset_lt.coalesced_aggregate

    def off_by_one(*args, **kwargs):
        seq, union = real(*args, **kwargs)
        return seq + 1, union

    monkeypatch.setattr(depset_lt, "coalesced_aggregate", off_by_one)
    with pytest.raises(depset_lt.GateFailure, match="differs"):
        depset_lt.run("cpu", widths=(64,), blocks=1)
