"""The port's read batchers (``protocols/multipaxos/read_batcher.py``)
against the JAX package.

(a) ``tests/protocols/test_multipaxos.py``'s two read-batcher cases on
the port's harness.
(b) The same seeded read/write traffic (``bench/read_batch_sim.py``'s
scenario: writes, linearizable, sequential and eventual reads of a
key-value store in waves) through both packages' harnesses with 2 read
batchers, under every scheme, on the ``dict`` tracker in both and on
the JAX ``tpu`` tracker against the port's ``cuda`` one on
``device="cpu"`` (synchronous, every drain on the device path, and
pipelined): equal replica logs, read
replies, BatchMaxSlotRequest counts and linearizable batches.
(c) The acceptor's BatchMaxSlotReply and the replica's batched read
admission (one sync a batch, a ``Rejected`` for each refused command)
equal the reference's on the same inputs.
(d) The bench end to end at a small size, and a supernode with read
batchers answering linearizable reads over loopback TCP.
"""

from __future__ import annotations

import threading
import types

from frankenpaxos_tpu_torch.bench import read_batch_sim as rbs
from frankenpaxos_tpu_torch.protocols.multipaxos import (
    messages as tm,
    ReadBatchingScheme,
    supernode,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import make_multipaxos
from frankenpaxos_tpu_torch.runtime import PickleSerializer
from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER
from frankenpaxos_tpu_torch.serve.admission import (
    AdmissionController,
    AdmissionOptions,
)
from frankenpaxos_tpu_torch.statemachine import (
    GetRequest,
    KeyValueStore,
    SetRequest,
)
import pytest

from frankenpaxos_tpu.protocols.multipaxos import (
    messages as jm,
    ReadBatchingScheme as JReadBatchingScheme,
)
from frankenpaxos_tpu.runtime import PickleSerializer as JPickleSerializer
from frankenpaxos_tpu.runtime.serializer import (
    DEFAULT_SERIALIZER as JSERIALIZER,
)
from frankenpaxos_tpu.serve.admission import (
    AdmissionController as JAdmissionController,
    AdmissionOptions as JAdmissionOptions,
)
from frankenpaxos_tpu.statemachine import (
    GetRequest as JGetRequest,
    KeyValueStore as JKeyValueStore,
    SetRequest as JSetRequest,
)
from tests.protocols import multipaxos_harness as jh

SER = PickleSerializer()
JAX = types.SimpleNamespace(
    make_multipaxos=jh.make_multipaxos, executed_prefix=jh.executed_prefix,
    ReadBatchingScheme=JReadBatchingScheme, KeyValueStore=JKeyValueStore,
    GetRequest=JGetRequest, SetRequest=JSetRequest,
    serializer=JPickleSerializer())
#: (JAX harness options, port harness options) per tracker.
BACKENDS = {
    "dict": (dict(quorum_backend="dict"), dict(quorum_backend="dict")),
    "sync": (dict(quorum_backend="tpu", tpu_min_device_slots=1),
             dict(quorum_backend="cuda", tpu_min_device_slots=1,
                  device="cpu")),
    "pipelined": (dict(quorum_backend="tpu", tpu_pipelined=True),
                  dict(quorum_backend="cuda", tpu_pipelined=True,
                       device="cpu")),
}
COMPARED = ("logs", "replies", "batch_max_slot_requests",
            "linearizable_batches", "ops")


# --- (a) the reference's cases on the port ----------------------------------


def _drive_reads(sim, reads, want: int) -> None:
    sim.transport.deliver_all()
    for _ in range(5):
        if len(reads) == want:
            break
        for timer in sim.transport.running_timers():
            if "Timer" in timer.name or timer.name.startswith("resendRead"):
                sim.transport.trigger_timer(timer.id)
        sim.transport.deliver_all()


def test_read_batcher_linearizable():
    sim = make_multipaxos(f=1, state_machine_factory=KeyValueStore,
                          num_read_batchers=2,
                          read_batching_scheme=ReadBatchingScheme(
                              kind="size", batch_size=2))
    client = sim.clients[0]
    client.write(0, SER.to_bytes(SetRequest((("k", "v"),))))
    sim.transport.deliver_all()
    reads = []
    # Two reads from two pseudonyms fill one batch of two.
    client.read(1, SER.to_bytes(GetRequest(("k",))),
                lambda r: reads.append(SER.from_bytes(r)))
    client.read(2, SER.to_bytes(GetRequest(("k",))),
                lambda r: reads.append(SER.from_bytes(r)))
    _drive_reads(sim, reads, 2)
    assert len(reads) == 2
    assert all(r.key_values == (("k", "v"),) for r in reads)


def test_read_batcher_adaptive():
    sim = make_multipaxos(f=1, state_machine_factory=KeyValueStore,
                          num_read_batchers=2,
                          read_batching_scheme=ReadBatchingScheme(
                              kind="adaptive"))
    client = sim.clients[0]
    client.write(0, SER.to_bytes(SetRequest((("k", "v"),))))
    sim.transport.deliver_all()
    reads = []
    client.read(1, SER.to_bytes(GetRequest(("k",))),
                lambda r: reads.append(SER.from_bytes(r)))
    sim.transport.deliver_all()
    assert len(reads) == 1
    assert reads[0].key_values == (("k", "v"),)


def test_unknown_scheme_is_refused():
    with pytest.raises(ValueError, match="unknown read batching scheme"):
        make_multipaxos(f=1, num_read_batchers=2,
                        read_batching_scheme=ReadBatchingScheme(kind="x"))


# --- (b) the same traffic through both packages -----------------------------


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("scheme", list(rbs.SCHEMES))
@pytest.mark.parametrize("seed", [0, 3])
def test_read_batch_cluster_matches_the_reference(scheme, backend, seed):
    jax_options, port_options = BACKENDS[backend]
    ref = rbs.scenario(JAX, scheme, operations=128, seed=seed,
                       **jax_options)
    port = rbs.scenario(None, scheme, operations=128, seed=seed,
                        **port_options)
    rbs.check(ref)
    rbs.check(port)
    for key in COMPARED:
        assert port[key] == ref[key], key
    assert port["batch_max_slot_requests"] > 0


@pytest.mark.parametrize("scheme", ["size", "time"])
def test_flexible_grid_read_quorums_match_the_reference(scheme):
    """With ``flexible`` the batchers read a random grid read quorum and
    resolve on ``is_superset_of_read_quorum``."""
    options = dict(flexible=True, grid_shape=(2, 2))
    ref = rbs.scenario(JAX, scheme, operations=64, seed=1, **options)
    port = rbs.scenario(None, scheme, operations=64, seed=1, **options)
    rbs.check(port)
    for key in COMPARED:
        assert port[key] == ref[key], key


# --- (c) the roles' batch handlers on the same inputs -----------------------


def _both():
    """Both packages' f = 1 clusters, settled."""
    port = make_multipaxos(f=1, coalesced=False)
    ref = jh.make_multipaxos(f=1, coalesced=False)
    port.transport.deliver_all()
    ref.transport.deliver_all()
    return port, ref


def _sent(sim, serializer) -> list:
    return [(m.dst, repr(serializer.from_bytes(m.data)))
            for m in sim.transport.messages]


def test_batch_max_slot_reply_matches_the_reference():
    port, ref = _both()
    for sim in (port, ref):
        sim.clients[0].write(0, b"w")
        sim.transport.deliver_all()
        sim.transport.messages.clear()
    for i, (pa, ra) in enumerate(zip(port.acceptors, ref.acceptors)):
        pa.receive("read-batcher-0", tm.BatchMaxSlotRequest(0, i))
        ra.receive("read-batcher-0", jm.BatchMaxSlotRequest(0, i))
    got = _sent(port, DEFAULT_SERIALIZER)
    assert got == _sent(ref, JSERIALIZER)
    assert [text for _, text in got] == [
        repr(tm.BatchMaxSlotReply(0, i, 0, i, a.max_voted_slot))
        for i, a in enumerate(port.acceptors)]
    assert max(a.max_voted_slot for a in port.acceptors) == 0


@pytest.mark.parametrize("kind", ["linearizable", "sequential", "eventual"])
@pytest.mark.parametrize("limit", [0, 3])
@pytest.mark.parametrize("deferred", [False, True])
def test_batched_read_admission_matches_the_reference(kind, limit,
                                                      deferred):
    """One batch of 8 reads (deferred past the executed watermark or
    served at once) into a replica with an in-flight limit (0: no
    admission): the same replies and Rejected entries, the same
    deferred backlog and in-flight count in both packages."""
    port, ref = _both()
    out = []
    for sim, m, controller, options, serializer in (
            (port, tm, AdmissionController, AdmissionOptions,
             DEFAULT_SERIALIZER),
            (ref, jm, JAdmissionController, JAdmissionOptions,
             JSERIALIZER)):
        replica = sim.replicas[0]
        if limit:
            replica.admission = controller(options(inflight_limit=limit),
                                           role="replica_test")
        client = sim.clients[0].address
        commands = tuple(m.Command(m.CommandId(client, i, 0), b"r")
                         for i in range(8))
        slot = replica.executed_watermark + 5 if deferred else -1
        batch = {"linearizable": m.ReadRequestBatch(slot, commands),
                 "sequential": m.SequentialReadRequestBatch(slot, commands),
                 "eventual": m.EventualReadRequestBatch(commands)}[kind]
        sim.transport.messages.clear()
        replica.receive("read-batcher-0", batch)
        out.append((_sent(sim, serializer), replica._deferred_read_count,
                    None if replica.admission is None
                    else (replica.admission.inflight,
                          dict(replica.admission.rejected))))
    assert out[0] == out[1]
    # The limit binds within the batch: 3 of the 8 admitted.
    rejected = [t for _, t in out[0][0] if t.startswith("Rejected")]
    assert len(rejected) == (5 if limit else 0)


# --- (d) the bench and the supernode ----------------------------------------


def test_bench_runs_and_gates_on_cpu():
    result = rbs.run("cpu", operations=128)
    assert result["device"] == "cpu" and result["nvidia_smi"] is None
    for scheme, arms in result["schemes"].items():
        for backend, fig in arms.items():
            assert fig["operations"] == 128
            assert fig["writes_per_sec"] > 0 and fig["reads_per_sec"] > 0
            assert fig["linearizable_batches"] > 0
            assert fig["batch_max_slot_requests"] == \
                2 * fig["linearizable_batches"]
            assert (fig["device_drains"] > 0) == (backend != "dict")
            # CPU tensors run the plain versions: no kernel launched.
            assert not any(fig["launches"].values())


def test_a_stale_read_fails_the_gate():
    run = rbs.scenario(None, "size", operations=256, seed=0)
    read = next(i for i, (kind, key, _) in enumerate(run["ops"])
                if kind == "read" and run["acked_before"][i] > 0)
    run["read_values"][read] = None
    with pytest.raises(rbs.GateFailure, match="older than"):
        rbs.check(run)


def test_supernode_read_batchers_answer_linearizable_reads():
    """Over loopback TCP: a write, then a linearizable read from every
    client through 2 read batchers (size scheme, batch size 2, a 50 ms
    timer), each answered once, the batchers' max-slot rounds at the
    acceptors."""
    node = supernode.Supernode(
        read_batchers=2, device="cpu",
        read_batching_scheme=ReadBatchingScheme(kind="size", batch_size=2,
                                                timeout_s=0.05))
    with node:
        wrote = threading.Event()
        reads: list = []
        done = threading.Event()

        def start():
            node.clients[0].write(0, b"w", lambda _: wrote.set())
            node.clients[0].flush_writes()

        node.client_transport.loop.call_soon_threadsafe(start)
        assert wrote.wait(10)

        def read_all():
            for c, client in enumerate(node.clients):
                def got(result, c=c):
                    reads.append(c)
                    if len(reads) == len(node.clients):
                        done.set()
                client.read(1, b"r", got)

        node.client_transport.loop.call_soon_threadsafe(read_all)
        assert done.wait(10)
        assert sorted(reads) == list(range(len(node.clients)))
        assert len(node.read_batchers) == 2
        rounds = supernode.on_loop(node.transport, lambda: sum(
            a.metrics_requests.labels("BatchMaxSlotRequest").get()
            for a in node.acceptors))
        assert rounds >= 2
