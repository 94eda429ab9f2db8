"""The port's Matchmaker MultiPaxos codecs (``protocols/
matchmakermultipaxos_wire.py``: tags 48-52, and 181-189 and 195-199 on the
extended page) and Matchmaker Paxos codecs (its part of
``protocols/baseline_wire.py``, tags 103-112) against the JAX package's.

The Matchmaker cases of ``tests/test_wire_codecs.py`` (the steady-state
round trips, the baseline protocols' Matchmaker Paxos messages, the COD301
tranches 4 and 5 with every quorum-system kind and the guarded-pickle
hatch, the registry fuzz samples, the hostile index values and the
corrupt-frame containment) run against the port, and the same messages,
built in each package, encode to EQUAL bytes through each package's
``DEFAULT_SERIALIZER``; the port decodes the JAX bytes to an equal message
of its own class.
"""

import importlib
import random
import types

import frankenpaxos_tpu_torch.protocols.matchmakermultipaxos  # noqa: F401
import frankenpaxos_tpu_torch.protocols.matchmakerpaxos  # noqa: F401
from frankenpaxos_tpu_torch.runtime import serializer
from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER
import pytest

import frankenpaxos_tpu.protocols.matchmakermultipaxos  # noqa: F401
import frankenpaxos_tpu.protocols.matchmakerpaxos  # noqa: F401

#: The tags these codecs take, on both packages.
MATCHMAKER_TAGS = ({48, 49, 50, 51, 52} | set(range(181, 190))
                   | set(range(195, 200)) | set(range(103, 113)))


def _ns(pkg: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return types.SimpleNamespace(
        mmp=mod("protocols.matchmakermultipaxos"),
        mp=mod("protocols.matchmakerpaxos"),
        ser=mod("runtime.serializer"))


PORT, REF = _ns("frankenpaxos_tpu_torch"), _ns("frankenpaxos_tpu")


def samples(ns) -> list:
    """``tests/test_wire_codecs.py``'s Matchmaker MultiPaxos and Matchmaker
    Paxos messages, built from ``ns``'s classes."""
    mmp, mp = ns.mmp, ns.mp
    command = mmp.Command(mmp.CommandId(("h", 5), 1, 3), b"x")
    mc = mmp.MatchmakerConfiguration(
        epoch=3, reconfigurer_index=0, matchmaker_indices=(0, 1, 2))
    mc2 = mmp.MatchmakerConfiguration(
        epoch=4, reconfigurer_index=1, matchmaker_indices=(3, 4, 5))
    configs = (
        (0, {"kind": "simple_majority", "members": [0, 1, 2]}),
        (2, {"kind": "unanimous_writes", "members": [3, 4]}),
        (4, {"kind": "grid", "grid": [[0, 1, 2], [3, 4, 5]]}),
        (6, {"kind": "zone_grid", "grid": [[0, 1], [2, 3], [4, 5]]}),
        (8, {"kind": "grid", "grid": []}),
    )
    return [
        # test_matchmakermultipaxos_codecs_round_trip
        mmp.ClientRequest(command),
        mmp.Phase2a(slot=5, round=1, value=command),
        mmp.Phase2a(slot=5, round=1, value=mmp.NOOP),
        mmp.Phase2b(slot=5, round=1, acceptor_index=2),
        mmp.Chosen(slot=5, value=command),
        mmp.ClientReply(mmp.CommandId("c", 0, 1), b"r"),
        # test_cod301_burn_down_tranche4_round_trip
        mmp.Stopped(epoch=0),
        mmp.GarbageCollect(matchmaker_configuration=mc,
                           gc_watermark=1 << 40),
        mmp.GarbageCollectAck(epoch=3, matchmaker_index=2, gc_watermark=0),
        mmp.MatchPhase1a(matchmaker_configuration=mc, round=9),
        mmp.MatchPhase1b(epoch=3, round=9, matchmaker_index=1,
                         vote_round=-1, vote_value=None),
        mmp.MatchPhase1b(epoch=3, round=9, matchmaker_index=1,
                         vote_round=4, vote_value=mc2),
        mmp.MatchPhase2a(matchmaker_configuration=mc, round=9, value=mc2),
        mmp.MatchPhase2b(epoch=3, round=9, matchmaker_index=0),
        mmp.MatchChosen(value=mc2),
        mmp.MatchNack(epoch=3, round=9),
        # test_cod301_burn_down_tranche5_round_trip
        mmp.Stop(matchmaker_configuration=mc),
        mmp.StopAck(matchmaker_index=1, epoch=3, gc_watermark=1 << 40,
                    configurations=configs),
        mmp.StopAck(matchmaker_index=0, epoch=0, gc_watermark=-1,
                    configurations=()),
        mmp.Bootstrap(epoch=4, reconfigurer_index=1, gc_watermark=0,
                      configurations=configs),
        mmp.BootstrapAck(matchmaker_index=2, epoch=4),
        mmp.ReconfigureMatchmakers(matchmaker_configuration=mc,
                                   new_matchmaker_indices=()),
        mmp.ReconfigureMatchmakers(matchmaker_configuration=mc,
                                   new_matchmaker_indices=(5, 6, 7)),
        # test_baseline_protocol_codecs_round_trip's Matchmaker Paxos
        mp.ClientRequest("v"), mp.ClientReply("chosen"),
        mp.MatchRequest(mp.AcceptorGroup(
            2, {"kind": "simple_majority", "members": [2, 0, 1]})),
        mp.MatchReply(2, 1, (
            mp.AcceptorGroup(0, {"kind": "grid",
                                 "grid": [[0, 1], [2, 3]]}),
            mp.AcceptorGroup(1, {"kind": "unanimous_writes",
                                 "members": [4, 5]}))),
        mp.MatchReply(3, 0, ()),
        mp.Phase1a(2), mp.Phase1b(2, 0, None),
        mp.Phase1b(2, 1, mp.Phase1bVote(0, "old")),
        mp.Phase2a(2, "v"), mp.Phase2b(2, 1),
        mp.MatchmakerNack(5), mp.AcceptorNack(6),
        mp.ClientRequest("héllo " * 20),
    ]


def _same(decoded, message) -> bool:
    return type(decoded) is type(message) and decoded == message


@pytest.mark.parametrize("i", range(len(samples(PORT))),
                         ids=lambda i: f"{i}-{type(samples(PORT)[i]).__name__}")
def test_codecs_give_the_references_bytes(i):
    port, ref = samples(PORT)[i], samples(REF)[i]
    assert type(port).__name__ == type(ref).__name__
    data = DEFAULT_SERIALIZER.to_bytes(port)
    assert data[0] < 128, type(port).__name__
    assert data == REF.ser.DEFAULT_SERIALIZER.to_bytes(ref)
    assert _same(DEFAULT_SERIALIZER.from_bytes(data), port)
    assert REF.ser.DEFAULT_SERIALIZER.from_bytes(data) == ref


def _random_qs(rng) -> dict:
    kind = rng.choice(["simple_majority", "unanimous_writes", "grid",
                       "zone_grid"])
    if kind in ("grid", "zone_grid"):
        cols = rng.randrange(1, 4)
        return {"kind": kind, "grid": [
            [rng.randrange(1 << 12) for _ in range(cols)]
            for _ in range(rng.randrange(0, 4))]}
    return {"kind": kind, "members": [rng.randrange(1 << 12)
                                      for _ in range(rng.randrange(6))]}


@pytest.mark.parametrize("seed", range(3))
def test_seeded_messages_give_the_references_bytes(seed):
    """Random slots, rounds, epochs, ids, payloads, configuration logs and
    vote kinds."""
    def build(ns, rng):
        mmp, mp = ns.mmp, ns.mp
        out = []
        for _ in range(60):
            cid = mmp.CommandId(rng.choice(["c", ("h", rng.randrange(99))]),
                                rng.randrange(8), rng.randrange(1 << 50))
            value = mmp.NOOP if rng.random() < 0.3 else mmp.Command(
                cid, bytes(rng.randrange(256)
                           for _ in range(rng.randrange(40))))
            slot, rnd = rng.randrange(1 << 40), rng.randrange(-1, 1 << 20)
            mc = mmp.MatchmakerConfiguration(
                rng.randrange(1 << 30), rng.randrange(-1, 4),
                tuple(rng.randrange(1 << 10)
                      for _ in range(rng.randrange(6))))
            configs = tuple((rng.randrange(1 << 20), _random_qs(rng))
                            for _ in range(rng.randrange(4)))
            kind = rng.randrange(9)
            if kind == 0:
                out.append(mmp.Phase2a(slot=slot, round=rnd, value=value))
            elif kind == 1:
                out.append(mmp.Chosen(slot=slot, value=value))
            elif kind == 2:
                out.append(mmp.ClientReply(cid, b"r%d" % slot))
            elif kind == 3:
                out.append(mmp.MatchPhase1b(
                    epoch=mc.epoch, round=rnd, matchmaker_index=2,
                    vote_round=rnd - 1,
                    vote_value=None if rng.random() < 0.5 else mc))
            elif kind == 4:
                out.append(mmp.StopAck(matchmaker_index=rng.randrange(5),
                                       epoch=mc.epoch, gc_watermark=rnd,
                                       configurations=configs))
            elif kind == 5:
                out.append(mmp.Bootstrap(epoch=mc.epoch,
                                         reconfigurer_index=0,
                                         gc_watermark=rnd,
                                         configurations=configs))
            elif kind == 6:
                out.append(mmp.GarbageCollect(mc, rnd))
            elif kind == 7:
                groups = tuple(mp.AcceptorGroup(r, qs) for r, qs in configs
                               if qs["kind"] != "zone_grid")
                out.append(mp.MatchReply(rnd, rng.randrange(5), groups))
            else:
                out.append(mp.Phase1b(rnd, rng.randrange(5), None
                                      if rng.random() < 0.5 else
                                      mp.Phase1bVote(rnd - 1, "v%d" % slot)))
        return out

    ports = build(PORT, random.Random(seed))
    refs = build(REF, random.Random(seed))
    for port, ref in zip(ports, refs):
        data = REF.ser.DEFAULT_SERIALIZER.to_bytes(ref)
        assert DEFAULT_SERIALIZER.to_bytes(port) == data, port
        assert _same(DEFAULT_SERIALIZER.from_bytes(data), port), port


def test_matchmaker_codecs_are_the_references():
    """Each Matchmaker tag is registered on both packages, for the
    message type of the same name, and every registered port codec is
    the reference's codec of its tag."""
    ref = REF.ser._CODECS_BY_TAG
    for tag in MATCHMAKER_TAGS:
        assert tag in serializer._CODECS_BY_TAG, tag
        assert serializer._CODECS_BY_TAG[tag].message_type.__module__ \
            .startswith("frankenpaxos_tpu_torch.protocols.matchmaker")
    for tag, codec in serializer._CODECS_BY_TAG.items():
        assert tag in ref, tag
        assert type(codec).__name__ == type(ref[tag]).__name__, tag
        assert codec.message_type.__name__ == \
            ref[tag].message_type.__name__, tag


def test_exotic_quorum_dicts_take_the_guarded_pickle_hatch():
    """An unknown quorum-system kind rides the guarded pickle: it round
    trips with the fallback on and is refused at the sender with it
    off, while the structured kinds stay binary."""
    mmp = PORT.mmp
    exotic = mmp.StopAck(
        matchmaker_index=1, epoch=3, gc_watermark=2,
        configurations=((1, {"kind": "weighted", "weights": {"a": 2}}),))
    data = DEFAULT_SERIALIZER.to_bytes(exotic)
    assert data[0] == 0
    assert DEFAULT_SERIALIZER.from_bytes(data) == exotic
    plain = samples(PORT)[17]
    serializer.set_pickle_fallback(False)
    try:
        with pytest.raises(ValueError, match="pickle fallback"):
            DEFAULT_SERIALIZER.to_bytes(exotic)
        assert DEFAULT_SERIALIZER.from_bytes(
            DEFAULT_SERIALIZER.to_bytes(plain)) == plain
    finally:
        serializer.set_pickle_fallback(True)


def test_hostile_index_values_are_refused():
    """Matchmaker index VALUES are validated at decode: a negative or huge
    index dies as a corrupt frame (ValueError)."""
    import struct

    mc = PORT.mmp.MatchmakerConfiguration(3, 0, (0, 1, 2))
    data = bytearray(DEFAULT_SERIALIZER.to_bytes(PORT.mmp.MatchChosen(mc)))
    for bad in (-1, 1 << 20):
        corrupt = bytearray(data)
        corrupt[2 + 16:2 + 20] = struct.pack("<i", bad)
        with pytest.raises(ValueError, match="hostile matchmaker index"):
            DEFAULT_SERIALIZER.from_bytes(bytes(corrupt))


def test_corrupt_frames_are_contained():
    """Single-byte and truncation corruption of every Matchmaker codec's
    frame: decode yields garbage or ValueError, never another exception."""
    rng = random.Random(22)
    for message in samples(PORT):
        data = DEFAULT_SERIALIZER.to_bytes(message)
        for _ in range(40):
            corrupt = bytearray(data)
            mode = rng.random()
            if mode < 0.5 and len(corrupt) > 2:
                corrupt[rng.randrange(2, len(corrupt))] ^= \
                    1 << rng.randrange(8)
            elif mode < 0.8 and len(corrupt) > 2:
                corrupt[rng.randrange(2, len(corrupt))] = 0xFF
            else:
                corrupt = corrupt[:rng.randrange(1, len(corrupt) + 1)]
            try:
                DEFAULT_SERIALIZER.from_bytes(bytes(corrupt))
            except ValueError:
                pass
