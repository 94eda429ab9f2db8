"""The port's wire codecs against the JAX package's: the MultiPaxos codecs
(``protocols/multipaxos/wire.py``), the dependency-run codecs
(``runs/wire.py``, tags 208/209), the EPaxos, SimpleBPaxos,
SimpleGcBPaxos and WPaxos codecs, the ``Rejected`` codec
(``serve/wire.py``), the reconfiguration codecs on the extended page
(``reconfig/wire.py``, tags 128-131, and a Phase1b that carries epochs
through tag 129), paxwire's batch envelopes and its coalescers, and the
frame lanes.

The same messages, built in each package from the same seed, encode to
EQUAL bytes through each package's ``DEFAULT_SERIALIZER``, and the port
decodes the JAX bytes to an equal message. One kind of sample carries no
cross-package case: a value that rides a pickled escape hatch as a
class of its own package (the SimpleGcBPaxos ``SnapshotMarker``; its
pickle names its module). The cases of ``tests/test_wire_codecs.py`` and
the pickle-fallback cases of ``tests/test_runtime.py`` for the ported
codecs are repeated against the port: round trips, the pickle fallback
for unregistered types, a fuzz sample for every registered codec, the
registry-wide corrupt-frame containment (with the Fast Paxos, Fast
MultiPaxos, Matchmaker MultiPaxos and Matchmaker Paxos samples), and
``set_pickle_fallback(False)``."""

import dataclasses
import importlib
import pickle
import random
import struct
import types

import frankenpaxos_tpu_torch.protocols.epaxos  # noqa: F401 - port codecs
import frankenpaxos_tpu_torch.protocols.multipaxos  # noqa: F401
from frankenpaxos_tpu_torch.protocols.multipaxos import messages as mp, wire
import frankenpaxos_tpu_torch.protocols.simplebpaxos  # noqa: F401
import frankenpaxos_tpu_torch.protocols.simplegcbpaxos  # noqa: F401
import frankenpaxos_tpu_torch.protocols.wpaxos  # noqa: F401
from frankenpaxos_tpu_torch.runtime import serializer
from frankenpaxos_tpu_torch.runtime.serializer import (
    DEFAULT_SERIALIZER,
    PickleSerializer,
)
import frankenpaxos_tpu_torch.serve  # noqa: F401
import numpy as np
import pytest

import frankenpaxos_tpu.protocols.epaxos  # noqa: F401 - JAX codecs
import frankenpaxos_tpu.protocols.multipaxos  # noqa: F401
import frankenpaxos_tpu.protocols.simplebpaxos  # noqa: F401
import frankenpaxos_tpu.protocols.simplegcbpaxos  # noqa: F401
import frankenpaxos_tpu.protocols.wpaxos  # noqa: F401
import frankenpaxos_tpu.serve  # noqa: F401

PKGS = ("frankenpaxos_tpu_torch", "frankenpaxos_tpu")


def _ns(pkg: str) -> types.SimpleNamespace:
    """One package's modules, by the same names."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return types.SimpleNamespace(
        mp=mod("protocols.multipaxos.messages"),
        mpwire=mod("protocols.multipaxos.wire"),
        em=mod("protocols.epaxos.messages"),
        ips=mod("protocols.epaxos.instance_prefix_set"),
        bp=mod("protocols.simplebpaxos.messages"),
        gc=mod("protocols.simplegcbpaxos"),
        wp=mod("protocols.wpaxos.messages"),
        geo=mod("geo.epochs"),
        serve=mod("serve.messages"),
        lanes=mod("serve.lanes"),
        paxwire=mod("runtime.paxwire"),
        runs=mod("runs.wire"),
        native=mod("native"),
        ser=mod("runtime.serializer"),
        rc=mod("reconfig"),
        fp=mod("protocols.fastpaxos"),
        fmp=mod("protocols.fastmultipaxos"),
        ingest=mod("ingest.messages"),
    )


PORT, REF = _ns(PKGS[0]), _ns(PKGS[1])


def codec_samples(ns, cross: bool = True) -> list:
    """One message of every ported codec (the samples of
    ``tests/test_wire_codecs.py``), built from ``ns``'s classes. With
    ``cross=False`` the samples that cannot cross packages are added."""
    mp, em, bp = ns.mp, ns.em, ns.bp
    cid = mp.CommandId(("10.0.0.1", 9000), 2, 7)
    command = mp.Command(cid, b"payload")
    batch = mp.CommandBatch((command,))
    edeps = ns.ips.InstancePrefixSet(2)
    edeps.add(ns.ips.Instance(0, 1))
    ecommand = em.Command("c", 0, 1, b"xyz")
    bdeps = bp.VertexIdPrefixSet(2)
    bdeps.add(bp.VertexId(0, 1))
    bcommand = bp.Command("client-0", 1, 2, b"p")
    Instance = ns.ips.Instance
    seg1 = ns.ser.DEFAULT_SERIALIZER.to_bytes(
        mp.Phase2b(group_index=1, acceptor_index=2, slot=1 << 40, round=3))
    seg2 = ns.ser.DEFAULT_SERIALIZER.to_bytes(
        mp.ClientRequest(mp.Command(mp.CommandId("client-1", 0, 1),
                                    b"x" * 100)))
    gc_watermark = bp.VertexIdPrefixSet(2)
    gc_watermark.add(bp.VertexId(0, 0))
    gc_watermark.add(bp.VertexId(1, 0))
    gc_watermark.add(bp.VertexId(1, 3))
    samples = [
        mp.Phase2b(group_index=1, acceptor_index=2, slot=9, round=3),
        mp.Phase2a(slot=5, round=0, value=batch),
        mp.Chosen(slot=9, value=mp.NOOP),
        mp.ClientRequest(command),
        mp.ClientRequestBatch(batch),
        mp.ClientReply(cid, 17, b"result"),
        mp.ChosenWatermark(slot=42),
        mp.Phase2bRange(group_index=0, acceptor_index=1,
                        slot_start_inclusive=3, slot_end_exclusive=9,
                        round=0),
        mp.Phase2bVotes(group_index=0, acceptor_index=1,
                        packed=ns.native.pack_votes2(
                            np.arange(4, dtype=np.int64),
                            np.zeros(4, dtype=np.int32))),
        mp.ClientRequestArray(commands=(command,)),
        mp.Phase2aRun(start_slot=5, round=2, values=(batch, mp.NOOP)),
        mp.ChosenRun(start_slot=9, values=(mp.NOOP, batch)),
        mp.ClientReplyArray(entries=((0, 1, 5, b"r0"),)),
        mp.MaxSlotRequest(command_id=cid),
        mp.MaxSlotReply(command_id=cid, group_index=1, acceptor_index=2,
                        slot=4),
        mp.ReadRequest(slot=5, command=command),
        mp.SequentialReadRequest(slot=-1, command=command),
        mp.EventualReadRequest(command=command),
        mp.ReadReplyBatch(batch=(mp.ReadReply(cid, 9, b"r1"),)),
        mp.ClientReplyBatch(batch=(mp.ClientReply(cid, 11, b"x"),)),
        mp.ReadRequestBatch(slot=5, commands=(command,)),
        mp.SequentialReadRequestBatch(slot=-1, commands=(command,)),
        mp.EventualReadRequestBatch(commands=(command, command)),
        mp.BatchMaxSlotRequest(read_batcher_index=1, read_batcher_id=7),
        mp.BatchMaxSlotReply(read_batcher_index=1, read_batcher_id=7,
                             group_index=0, acceptor_index=2,
                             slot=1 << 40),
        mp.NotLeaderClient(),
        mp.LeaderInfoRequestClient(),
        mp.LeaderInfoReplyClient(round=9),
        mp.NotLeaderBatcher(
            client_request_batch=mp.ClientRequestBatch(batch)),
        mp.LeaderInfoRequestBatcher(),
        mp.LeaderInfoReplyBatcher(round=2),
        mp.Phase1a(round=3, chosen_watermark=64),
        mp.Phase1b(group_index=0, acceptor_index=1, round=3,
                   info=(mp.Phase1bSlotInfo(slot=5, vote_round=1,
                                            vote_value=batch),
                         mp.Phase1bSlotInfo(slot=6, vote_round=2,
                                            vote_value=mp.NOOP)),
                   epochs=()),
        mp.Nack(round=7),
        mp.Recover(slot=99),
        ns.mpwire.Phase2bAckBatch(ranges=((5, 9, 1, 0, 2),
                                          (11, 12, 1, 0, 2))),
        ns.paxwire.FrameBatch((seg1, seg1, seg2)),
        ns.paxwire.ClientFrameBatch((seg2,)),
        ns.serve.Rejected(entries=((2, 7), (3, 9)), retry_after_ms=250,
                          reason=2),
        em.PreAccept(Instance(0, 4), (1, 0), ecommand, 7, edeps),
        em.PreAcceptOk(Instance(0, 4), (1, 0), 2, 7, edeps),
        em.Accept(Instance(0, 4), (1, 0), em.NOOP, 7, edeps),
        em.AcceptOk(Instance(0, 4), (1, 0), 2),
        em.Commit(Instance(0, 4), ecommand, 7, edeps),
        em.ClientRequest(ecommand),
        em.ClientReply(0, 1, b"r"),
        em.Prepare(instance=Instance(0, 5), ballot=(2, 1)),
        em.Nack(instance=Instance(1, 3), largest_ballot=(4, 0)),
        em.PrepareOk(ballot=(2, 1), instance=Instance(0, 5),
                     replica_index=1, vote_ballot=(1, 0),
                     status=em.CommandStatus.ACCEPTED,
                     command_or_noop=ecommand, sequence_number=7,
                     dependencies=edeps),
        bp.ClientRequest(bcommand),
        bp.DependencyRequest(bp.VertexId(0, 3), bcommand),
        bp.DependencyReply(bp.VertexId(0, 3), 1, bdeps),
        bp.Propose(bp.VertexId(1, 0), bcommand, bdeps),
        bp.Phase2a(bp.VertexId(1, 0), 4, bp.VoteValue(bcommand, bdeps)),
        bp.Phase2b(bp.VertexId(1, 0), 2, 4),
        bp.Commit(bp.VertexId(1, 0), bcommand, bdeps),
        bp.ClientReply(1, 2, b"result"),
        bp.Phase1a(vertex_id=bp.VertexId(0, 3), round=2),
        bp.Phase1b(vertex_id=bp.VertexId(0, 3), acceptor_id=1, round=2,
                   vote_round=1, vote_value=bp.VoteValue(bcommand, bdeps)),
        bp.Nack(vertex_id=bp.VertexId(1, 9), higher_round=4),
        bp.Recover(vertex_id=bp.VertexId(1, 9)),
        ns.gc.SnapshotRequest(),
        ns.gc.CommitSnapshot(
            id=4, watermark=gc_watermark.to_dict(),
            state_machine=b"\x00register state",
            client_table={"kv": [{
                "client": (("10.0.0.1", 5000), 2),
                "largest_id": 7,
                "largest_output": b"ok",
                "executed_ids": {"watermark": 6, "values": [7]},
            }]}),
        ns.runs.PreAcceptOkRun(
            num_leaders=2,
            headers=((0, 4, 1, 0, 2, 7), (1, 9, 1, 0, 2, 3)),
            watermarks=(1, 0, 2, 1), counts=(1, 0, 2, 0),
            values=(3, 5, 6)),
        ns.runs.DepReplyRun(
            num_leaders=2, headers=((0, 3, 1), (1, 5, 2)),
            watermarks=(2, 1, 0, 0), counts=(0, 1, 1, 0), values=(4, 2)),
    ]
    rc = ns.rc
    commit = rc.EpochCommit(epoch=3, start_slot=999, f=1, round=7,
                            members=("m0", ("10.0.0.7", 80), "m2"))
    samples += [
        rc.Reconfigure(members=("x", ("10.0.0.7", 80), "z")),
        commit,
        rc.EpochAck(epoch=3, round=7),
        rc.EpochPhase2aRun(epoch=2, start_slot=17, round=1,
                           values=(batch, mp.NOOP)),
        mp.Phase1b(group_index=0, acceptor_index=2, round=7,
                   info=(mp.Phase1bSlotInfo(slot=1000, vote_round=7,
                                            vote_value=batch),),
                   epochs=(commit, rc.EpochCommit(
                       epoch=4, start_slot=2000, f=1, round=7,
                       members=("m0", "m2", "m3")))),
    ]
    wp = ns.wp
    wentry = ns.geo.GeoEpoch(group=2, epoch=3, start_slot=17, home_zone=1,
                             ballot=7)
    samples += [
        wp.WRequest(group=2, command=command, steal=True),
        wp.WReply(command_id=cid, group=2, slot=9, result=b"r"),
        wp.WNotOwner(group=2, command_id=cid, home_zone=1, ballot=4),
        wp.Steal(group=2),
        wp.WPhase1a(group=2, ballot=7, epoch=3),
        wp.WPhase1b(group=2, ballot=7, epoch=3, acceptor=5,
                    votes=(wp.WVote(slot=4, ballot=1, value=batch),
                           wp.WVote(slot=5, ballot=2, value=mp.NOOP)),
                    epochs=(wentry,)),
        wp.WPhase2a(group=2, slot=9, ballot=7, value=batch),
        wp.WPhase2b(group=2, slot=9, ballot=7, acceptor=5),
        wp.WNack(group=2, ballot=8, home_zone=0),
        wp.WChosen(group=2, slot=9, value=batch),
        wp.WEpochCommit(entry=wentry),
        wp.WEpochAck(group=2, epoch=3),
        wp.WRecover(group=2, slot=4),
    ]
    ig = ns.ingest
    run = ig.IngestRun(batcher_index=1, values=(batch,), seq=5)
    samples += [
        run,
        ig.IngestRun(batcher_index=2, seq=9,
                     values=ns.mpwire.decode_value_array(
                         ns.mpwire.encode_value_array((batch, batch)))),
        ig.NotLeaderIngest(group_index=0, run=run),
        ig.IngestCredit(group_index=0, watermark_seq=5),
    ]
    if not cross:
        samples += [
            bp.Propose(bp.VertexId(1, 0), ns.gc.SnapshotMarker(), bdeps),
            bp.Commit(bp.VertexId(1, 0), ns.gc.SnapshotMarker(), bdeps),
        ]
    return samples


def seeded_samples(ns, seed: int, n: int) -> list:
    """``n`` random MultiPaxos messages of the hot and failover paths,
    drawn from ``random.Random(seed)`` (so both packages draw the same
    messages)."""
    mp = ns.mp
    rng = random.Random(seed)

    def address():
        if rng.random() < 0.2:
            return f"client-{rng.randrange(8)}"
        return (f"10.0.{rng.randrange(4)}.{rng.randrange(256)}",
                rng.randrange(1 << 16))

    def command(addr=None):
        return mp.Command(mp.CommandId(addr or address(), rng.randrange(64),
                                       rng.randrange(1 << 40)),
                          bytes(rng.randrange(256)
                                for _ in range(rng.randrange(24))))

    def value():
        if rng.random() < 0.2:
            return mp.NOOP
        return mp.CommandBatch(tuple(command()
                                     for _ in range(rng.randrange(1, 4))))

    out = []
    for _ in range(n):
        kind = rng.randrange(12)
        slot, rnd = rng.randrange(1 << 40), rng.randrange(1 << 20)
        if kind == 0:
            out.append(mp.Phase2b(group_index=rng.randrange(4),
                                  acceptor_index=rng.randrange(8),
                                  slot=slot, round=rnd))
        elif kind == 1:
            out.append(mp.Phase2a(slot=slot, round=rnd, value=value()))
        elif kind == 2:
            out.append(mp.Chosen(slot=slot, value=value()))
        elif kind == 3:
            out.append(mp.ClientRequest(command()))
        elif kind == 4:
            addr = address()
            out.append(mp.ClientRequestArray(commands=tuple(
                command(addr) for _ in range(rng.randrange(1, 6)))))
        elif kind == 5:
            out.append(mp.Phase2aRun(start_slot=slot, round=rnd,
                                     values=tuple(value() for _ in range(
                                         rng.randrange(1, 9)))))
        elif kind == 6:
            out.append(mp.ChosenRun(start_slot=slot, values=tuple(
                value() for _ in range(rng.randrange(1, 9)))))
        elif kind == 7:
            out.append(mp.ClientReplyArray(entries=tuple(
                (rng.randrange(64), rng.randrange(1 << 40), slot + i,
                 b"%d" % rng.randrange(1 << 20))
                for i in range(rng.randrange(1, 6)))))
        elif kind == 8:
            out.append(mp.Phase2bRange(
                group_index=rng.randrange(4), acceptor_index=rng.randrange(8),
                slot_start_inclusive=slot,
                slot_end_exclusive=slot + rng.randrange(1, 4096),
                round=rnd))
        elif kind == 9:
            k = rng.randrange(1, 64)
            slots = np.array([rng.randrange(1 << 40) for _ in range(k)],
                             dtype=np.int64)
            rounds = np.array([rng.randrange(1 << 20) for _ in range(k)],
                              dtype=np.int32)
            out.append(mp.Phase2bVotes(
                group_index=rng.randrange(4), acceptor_index=rng.randrange(8),
                packed=ns.native.pack_votes2(slots, rounds)))
        elif kind == 10:
            out.append(mp.Phase1b(
                group_index=0, acceptor_index=rng.randrange(8), round=rnd,
                info=tuple(mp.Phase1bSlotInfo(slot=slot + i,
                                              vote_round=rng.randrange(rnd
                                                                       + 1),
                                              vote_value=value())
                           for i in range(rng.randrange(0, 5))),
                epochs=()))
        else:
            out.append(mp.ClientReply(mp.CommandId(address(),
                                                   rng.randrange(64),
                                                   rng.randrange(1 << 40)),
                                      slot, b"r%d" % rng.randrange(99)))
    return out


def _same(decoded, message) -> bool:
    if dataclasses.is_dataclass(message):
        return type(decoded) is type(message) and decoded == message
    return decoded == message


# --- equal bytes across the packages ----------------------------------------


@pytest.mark.parametrize("i", range(len(codec_samples(PORT))),
                         ids=lambda i: type(codec_samples(PORT)[i]).__name__)
def test_every_ported_codec_gives_the_references_bytes(i):
    port = codec_samples(PORT)[i]
    ref = codec_samples(REF)[i]
    assert type(port).__name__ == type(ref).__name__
    data = DEFAULT_SERIALIZER.to_bytes(port)
    assert data[0] < 128, type(port).__name__
    assert data == REF.ser.DEFAULT_SERIALIZER.to_bytes(ref)
    assert _same(DEFAULT_SERIALIZER.from_bytes(data), port)
    # The port's frame classifier agrees with the reference's.
    assert PORT.lanes.frame_lane(data) == REF.lanes.frame_lane(data)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_multipaxos_messages_give_the_references_bytes(seed):
    ports = seeded_samples(PORT, seed, 150)
    refs = seeded_samples(REF, seed, 150)
    for port, ref in zip(ports, refs):
        data = REF.ser.DEFAULT_SERIALIZER.to_bytes(ref)
        assert DEFAULT_SERIALIZER.to_bytes(port) == data, port
        decoded = DEFAULT_SERIALIZER.from_bytes(data)
        assert _same(decoded, port), port
        # A lazily decoded run re-encodes as a raw copy of those bytes.
        assert DEFAULT_SERIALIZER.to_bytes(decoded) == data


def test_every_registered_port_codec_is_a_reference_codec():
    """The port registers a subset of the reference's tags, each for the
    message type of the same name."""
    ref = REF.ser._CODECS_BY_TAG
    for tag, codec in serializer._CODECS_BY_TAG.items():
        assert tag in ref, tag
        assert codec.message_type.__name__ == \
            ref[tag].message_type.__name__, tag


@pytest.mark.parametrize("seed", range(3))
def test_coalescers_give_the_references_bytes(seed):
    """paxwire's ack and reply coalescers (MultiPaxos) and the dep-run
    coalescers (EPaxos / BPaxos) fold the same payload runs into equal
    bytes; the port expands them back into the messages sent."""
    rng = random.Random(seed)
    acks = [(rng.randrange(64), rng.randrange(3), 0, rng.randrange(3))
            for _ in range(200)]
    runs = []
    for ns in (PORT, REF):
        ser = ns.ser.DEFAULT_SERIALIZER
        phase2bs = [ser.to_bytes(ns.mp.Phase2b(group_index=g,
                                               acceptor_index=a, slot=s,
                                               round=r))
                    for s, r, g, a in acks]
        replies = [ser.to_bytes(ns.mp.ClientReplyArray(entries=tuple(
            (k, i, 100 + i, b"r%d" % i) for i in range(k + 1))))
            for k in range(5)]
        deps = ns.ips.InstancePrefixSet(3)
        widths = random.Random(seed)
        for leader in range(3):
            for i in range(widths.randrange(1, 6)):
                deps.add(ns.ips.Instance(leader, i))
        oks = [ser.to_bytes(ns.em.PreAcceptOk(
            ns.ips.Instance(i % 3, i), (1, 0), 2, i, deps))
            for i in range(6)]
        bdeps = ns.bp.VertexIdPrefixSet(2)
        bdeps.add(ns.bp.VertexId(1, 4))
        dreps = [ser.to_bytes(ns.bp.DependencyReply(
            ns.bp.VertexId(0, i), 1, bdeps)) for i in range(5)]
        coalesce = ns.paxwire._COALESCERS
        runs.append((coalesce[1](phase2bs), coalesce[118](replies),
                     coalesce[15](oks), coalesce[23](dreps)))
    assert runs[0] == runs[1]
    assert all(run is not None for run in runs[0])
    ack_batch = DEFAULT_SERIALIZER.from_bytes(runs[0][0])
    expanded = list(ack_batch.__wire_expand__(DEFAULT_SERIALIZER))
    votes = set()
    for m in expanded:
        if isinstance(m, mp.Phase2b):
            votes.add((m.slot, m.round, m.group_index, m.acceptor_index))
        else:
            votes.update((s, m.round, m.group_index, m.acceptor_index)
                         for s in range(m.slot_start_inclusive,
                                        m.slot_end_exclusive))
    assert votes == set(acks)


@pytest.mark.parametrize("seed", range(3))
def test_flush_plans_give_the_references_segments(seed):
    """A connection's pending entries plan to equal writev segments in
    both packages: batch frames, coalesced acks, singletons, order."""
    plans = []
    for ns in (PORT, REF):
        r = random.Random(seed)
        ser = ns.ser.DEFAULT_SERIALIZER
        entries = []
        for message in seeded_samples(ns, seed, 60):
            header = b"10.0.0.%d:%d" % (r.randrange(2), 9000)
            entries.append((header, ser.to_bytes(message), 0, 0))
            if r.random() < 0.3:  # runs of acks to coalesce
                for k in range(r.randrange(2, 9)):
                    entries.append((header, ser.to_bytes(ns.mp.Phase2b(
                        group_index=0, acceptor_index=1, slot=k, round=0)),
                        0, 0))
        plan = ns.paxwire.plan_flush(entries)
        plans.append((b"".join(plan.segments), plan.frames, plan.messages,
                      plan.nbytes, plan.coalesced_acks))
    assert plans[0] == plans[1]


# --- tests/test_wire_codecs.py, repeated against the port --------------------

HOT_MESSAGES = [
    mp.Phase2b(group_index=1, acceptor_index=2, slot=1 << 40, round=3),
    mp.Phase2b(group_index=0, acceptor_index=0, slot=0, round=-1),
    mp.Phase2a(slot=5, round=0, value=mp.CommandBatch((mp.Command(
        mp.CommandId(("10.0.0.1", 5000), 2, 7), b"hello"),))),
    mp.Phase2a(slot=5, round=2, value=mp.NOOP),
    mp.Chosen(slot=9, value=mp.NOOP),
    mp.Chosen(slot=9, value=mp.CommandBatch((
        mp.Command(mp.CommandId("sim-client", 0, 0), b""),
        mp.Command(mp.CommandId(("h", 80), 1, 2), b"\x00\xff" * 64)))),
    mp.ClientRequest(mp.Command(mp.CommandId("client-1", 0, 1),
                                b"x" * 100)),
    mp.ClientRequestBatch(mp.CommandBatch((mp.Command(
        mp.CommandId("c", 1, 2), b"p"),))),
    mp.ClientReply(mp.CommandId(("h", 1), 0, 4), 17, b"result"),
    mp.ChosenWatermark(slot=42),
]


@pytest.mark.parametrize("message", HOT_MESSAGES,
                         ids=lambda m: type(m).__name__)
def test_binary_round_trip(message):
    data = DEFAULT_SERIALIZER.to_bytes(message)
    assert data[0] < 128
    assert DEFAULT_SERIALIZER.from_bytes(data) == message


def test_read_path_codecs_round_trip():
    cid = mp.CommandId(("10.0.0.1", 9000), 3, 44)
    sim_cid = mp.CommandId("Client 1", 0, 7)
    command = mp.Command(cid, b"get-k")
    for message in [
        mp.MaxSlotRequest(command_id=cid),
        mp.MaxSlotRequest(command_id=sim_cid),
        mp.MaxSlotReply(command_id=cid, group_index=1, acceptor_index=2,
                        slot=1 << 40),
        mp.ReadRequest(slot=5, command=command),
        mp.SequentialReadRequest(slot=-1, command=command),
        mp.EventualReadRequest(command=command),
        mp.ReadReplyBatch(batch=(mp.ReadReply(cid, 9, b"r1"),
                                 mp.ReadReply(sim_cid, 10, b""))),
        mp.ReadReplyBatch(batch=()),
        mp.ClientReplyBatch(batch=(mp.ClientReply(cid, 11, b"x" * 100),)),
    ]:
        data = DEFAULT_SERIALIZER.to_bytes(message)
        assert data[0] < 128, type(message).__name__
        assert DEFAULT_SERIALIZER.from_bytes(data) == message


@dataclasses.dataclass(frozen=True)
class _NotOnAnyWire:
    x: int


def test_unregistered_types_fall_back_to_pickle():
    message = _NotOnAnyWire(7)
    data = DEFAULT_SERIALIZER.to_bytes(message)
    assert data[0] >= 128
    assert DEFAULT_SERIALIZER.from_bytes(data) == message


def test_pickled_stream_from_legacy_sender_decodes():
    legacy = PickleSerializer().to_bytes(HOT_MESSAGES[0])
    assert DEFAULT_SERIALIZER.from_bytes(legacy) == HOT_MESSAGES[0]


def test_binary_encoding_is_compact_and_stable():
    message = mp.Phase2b(group_index=3, acceptor_index=4, slot=258, round=7)
    data = DEFAULT_SERIALIZER.to_bytes(message)
    assert len(data) == 25
    assert data[0] == 1
    assert data[1:9] == (258).to_bytes(8, "little")
    assert data[9:17] == (7).to_bytes(8, "little")
    assert len(data) < len(pickle.dumps(message)) / 3


@pytest.mark.parametrize("cross", [True, False])
def test_protocol_codecs_round_trip(cross):
    """Every sample (EPaxos, BPaxos and the GcBPaxos SnapshotMarker
    escape hatch included) round-trips through the port's codecs."""
    for message in codec_samples(PORT, cross):
        data = DEFAULT_SERIALIZER.to_bytes(message)
        assert data[0] < 128, type(message).__name__
        assert _same(DEFAULT_SERIALIZER.from_bytes(data), message), message


def test_run_pipeline_codecs_round_trip_and_reject_hostile_counts():
    cmd = lambda p, i: mp.Command(  # noqa: E731
        mp.CommandId(("10.0.0.1", 9000), p, i), b"payload-%d" % i)
    messages = [
        mp.ClientRequestArray(commands=(cmd(0, 0), cmd(1, 7))),
        mp.Phase2aRun(start_slot=5, round=2,
                      values=(mp.CommandBatch((cmd(0, 0),)), mp.NOOP,
                              mp.CommandBatch((cmd(1, 1), cmd(2, 2))))),
        mp.ChosenRun(start_slot=9,
                     values=(mp.NOOP, mp.CommandBatch((cmd(3, 3),)))),
        mp.ClientReplyArray(entries=((0, 1, 5, b"r0"), (2, 3, 6, b"r1"))),
    ]
    for message in messages:
        data = DEFAULT_SERIALIZER.to_bytes(message)
        decoded = DEFAULT_SERIALIZER.from_bytes(data)
        assert type(decoded) is type(message)
        if hasattr(message, "values"):
            assert tuple(decoded.values) == tuple(message.values)
            assert isinstance(decoded.values, wire.LazyValueArray)
            assert DEFAULT_SERIALIZER.to_bytes(decoded) == data
        else:
            assert decoded == message
    run = mp.Phase2aRun(start_slot=0, round=0, values=(mp.NOOP,))
    data = bytearray(DEFAULT_SERIALIZER.to_bytes(run))
    struct.pack_into("<i", data, 17, 1 << 30)
    with pytest.raises(ValueError):
        DEFAULT_SERIALIZER.from_bytes(bytes(data))
    data = bytearray(DEFAULT_SERIALIZER.to_bytes(run))
    struct.pack_into("<i", data, 21, 1 << 20)
    with pytest.raises(ValueError):
        DEFAULT_SERIALIZER.from_bytes(bytes(data))
    payload = struct.pack("<i", 0) + b"\x01" + struct.pack("<i", 1000)
    data = (bytes([wire.Phase2aRunCodec.tag]) + struct.pack("<qq", 0, 0)
            + struct.pack("<ii", 1, len(payload)) + payload)
    decoded = DEFAULT_SERIALIZER.from_bytes(data)
    with pytest.raises(ValueError):
        list(decoded.values)


def fast_codec_samples(ns) -> list:
    """One message of every Fast Paxos and Fast MultiPaxos codec (their
    cross-package bytes are held in ``tests/test_torch_fast_wire.py``)."""
    fp, fmp = ns.fp, ns.fmp
    command = fmp.Command(fmp.CommandId(("h", 5), 3), b"x")
    return [
        fp.ProposeRequest("v"), fp.ProposeReply("chosen"), fp.Phase1a(4),
        fp.Phase1b(4, 0, 0, "fast"), fp.Phase2a(4, "v"), fp.Phase2b(2, 4),
        fmp.ProposeRequest(command),
        fmp.ProposeReply(command.command_id, b"r", round=2),
        fmp.Phase2a(slot=5, round=1, value=command),
        fmp.Phase2b(acceptor_id=0, slot=5, round=1, vote=command),
        fmp.Phase2bBuffer((fmp.Phase2b(acceptor_id=0, slot=5, round=1,
                                       vote=fmp.NOOP),)),
        fmp.ValueChosen(slot=5, value=command),
        fmp.Phase1bNack(acceptor_id=1, round=3),
    ]


def _by_tag() -> dict:
    from tests import test_torch_matchmaker_wire as mw

    by_tag: dict = {}
    for message in codec_samples(PORT, cross=False) + \
            fast_codec_samples(PORT) + mw.samples(mw.PORT):
        data = DEFAULT_SERIALIZER.to_bytes(message)
        tag = data[0] if data[0] else 128 + data[1]
        by_tag.setdefault(tag, message)
    return by_tag


def test_every_registered_codec_has_a_fuzz_sample():
    missing = sorted(set(serializer._CODECS_BY_TAG) - set(_by_tag()))
    assert not missing, [(t, type(serializer._CODECS_BY_TAG[t]).__name__)
                         for t in missing]


def test_registry_wide_corrupt_frame_containment():
    """Single-byte and truncation corruption over every registered
    codec's frame: decode yields garbage or ValueError, never another
    exception type."""
    rng = random.Random(13)
    for tag, message in sorted(_by_tag().items()):
        data = DEFAULT_SERIALIZER.to_bytes(message)
        assert type(DEFAULT_SERIALIZER.from_bytes(data)) is type(message)
        for _ in range(40 if len(data) > 2 else 10):
            corrupt = bytearray(data)
            mode = rng.random()
            if mode < 0.5 and len(corrupt) > 1:
                corrupt[rng.randrange(1, len(corrupt))] ^= \
                    1 << rng.randrange(8)
            elif mode < 0.8 and len(corrupt) > 1:
                corrupt[rng.randrange(1, len(corrupt))] = 0xFF
            else:
                corrupt = corrupt[:rng.randrange(1, len(corrupt) + 1)]
            try:
                got = DEFAULT_SERIALIZER.from_bytes(bytes(corrupt))
                values = getattr(got, "values", None)
                if values is not None:
                    list(values)
            except ValueError:
                pass


def test_run_pipeline_codecs_fuzz():
    rng = random.Random(7)
    for trial, message in enumerate(m for m in seeded_samples(PORT, 7, 400)
                                    if isinstance(m, (mp.Phase2aRun,
                                                      mp.ChosenRun))):
        data = DEFAULT_SERIALIZER.to_bytes(message)
        decoded = DEFAULT_SERIALIZER.from_bytes(data)
        assert tuple(decoded.values) == tuple(message.values), trial
        assert DEFAULT_SERIALIZER.to_bytes(decoded) == data, trial
        corrupt = bytearray(data)
        corrupt[rng.randrange(1, len(corrupt))] ^= 0xFF
        try:
            d2 = DEFAULT_SERIALIZER.from_bytes(bytes(corrupt))
            if hasattr(d2, "values"):
                list(d2.values)
        except ValueError:
            pass


def test_wpaxos_codecs_round_trip():
    from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch
    from frankenpaxos_tpu_torch.protocols.wpaxos import messages as wp

    cid = wp.CommandId(("10.0.0.1", 9000), 2, 7)
    sim_cid = wp.CommandId("client-0", 0, 3)
    command = wp.Command(cid, b"geo-payload")
    batch = wp.CommandBatch((command,))
    entry = GeoEpoch(group=1, epoch=2, start_slot=64, home_zone=2,
                     ballot=5)
    for message in [
        wp.WRequest(group=1, command=command),
        wp.WRequest(group=1, command=wp.Command(sim_cid, b""), steal=True),
        wp.WReply(command_id=cid, group=1, slot=64, result=b"ok"),
        wp.WNotOwner(group=1, command_id=sim_cid, home_zone=2, ballot=5),
        wp.Steal(group=3),
        wp.WPhase1a(group=1, ballot=5, epoch=2),
        wp.WPhase1b(group=1, ballot=5, epoch=2, acceptor=7, votes=(),
                    epochs=(entry,)),
        wp.WPhase1b(group=1, ballot=5, epoch=2, acceptor=7,
                    votes=(wp.WVote(slot=3, ballot=2, value=batch),
                           wp.WVote(slot=4, ballot=2, value=wp.NOOP)),
                    epochs=()),
        wp.WPhase2a(group=1, slot=64, ballot=5, value=batch),
        wp.WPhase2a(group=1, slot=64, ballot=5, value=wp.NOOP),
        wp.WPhase2b(group=1, slot=64, ballot=5, acceptor=7),
        wp.WNack(group=1, ballot=8, home_zone=0),
        wp.WChosen(group=1, slot=64, value=batch),
        wp.WEpochCommit(entry=entry),
        wp.WEpochAck(group=1, epoch=2),
        wp.WRecover(group=1, slot=12),
    ]:
        data = DEFAULT_SERIALIZER.to_bytes(message)
        assert data[0] == 0, type(message).__name__  # extended page
        assert DEFAULT_SERIALIZER.from_bytes(data) == message


def test_wpaxos_request_is_client_lane():
    from frankenpaxos_tpu_torch.protocols.wpaxos import messages as wp
    from frankenpaxos_tpu_torch.serve.lanes import (
        frame_lane,
        LANE_CLIENT,
        LANE_CONTROL,
    )

    command = wp.Command(wp.CommandId("c", 0, 1), b"x")
    request = DEFAULT_SERIALIZER.to_bytes(wp.WRequest(group=0,
                                                      command=command))
    assert frame_lane(request) == LANE_CLIENT
    for message in [wp.WPhase1a(group=0, ballot=1, epoch=1),
                    wp.WPhase2b(group=0, slot=1, ballot=1, acceptor=0),
                    wp.Steal(group=0),
                    wp.WEpochAck(group=0, epoch=1)]:
        data = DEFAULT_SERIALIZER.to_bytes(message)
        assert frame_lane(data) == LANE_CONTROL, type(message).__name__


# --- the pickle fallback flag (tests/test_runtime.py, repeated) -------------


class TestPickleFallbackFlag:
    def teardown_method(self):
        serializer.set_pickle_fallback(True)

    def test_decode_refuses_pickle_frames_when_disabled(self):
        s = serializer.HybridSerializer()
        frame = pickle.dumps(("anything",), protocol=pickle.HIGHEST_PROTOCOL)
        assert s.from_bytes(frame) == ("anything",)
        serializer.set_pickle_fallback(False)
        with pytest.raises(ValueError, match="pickle fallback disabled"):
            s.from_bytes(frame)

    def test_encode_refuses_unregistered_types_when_disabled(self):
        s = serializer.HybridSerializer()
        assert s.to_bytes(("unregistered",))
        serializer.set_pickle_fallback(False)
        with pytest.raises(ValueError, match="no codec registered"):
            s.to_bytes(("unregistered",))

    def test_registered_codecs_still_work_when_disabled(self):
        serializer.set_pickle_fallback(False)
        for message in codec_samples(PORT):
            data = DEFAULT_SERIALIZER.to_bytes(message)
            assert _same(DEFAULT_SERIALIZER.from_bytes(data), message)

    def test_escape_hatches_respect_the_flag(self):
        from frankenpaxos_tpu_torch.protocols.simplebpaxos import (
            wire as sbp_wire,
        )

        out = bytearray()
        wire._put_address(out, frozenset({1}))
        assert wire._take_address(bytes(out), 0)[0] == frozenset({1})
        out2 = bytearray()
        sbp_wire._put_command(out2, ("sentinel",))
        assert sbp_wire._take_command(bytes(out2), 0)[0] == ("sentinel",)
        serializer.set_pickle_fallback(False)
        with pytest.raises(ValueError, match="pickle fallback disabled"):
            wire._take_address(bytes(out), 0)
        with pytest.raises(ValueError, match="pickle fallback disabled"):
            wire._put_address(bytearray(), frozenset({1}))
        with pytest.raises(ValueError, match="pickle fallback disabled"):
            sbp_wire._take_command(bytes(out2), 0)
