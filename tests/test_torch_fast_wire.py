"""The port's Fast Paxos codecs (its part of ``protocols/baseline_wire.py``,
tags 90-95) and Fast MultiPaxos codecs (``protocols/fastmultipaxos_wire.py``,
tags 70-75 and 157 on the extended page) against the JAX package's.

The Fast Paxos and Fast MultiPaxos cases of ``tests/test_wire_codecs.py``
(the steady-state round trips, the hot-loop codecs with the any /
anySuffix markers, the baseline protocols' Fast Paxos messages with the
"any" value, the fuzz samples and the corrupt-frame containment) run
against the port, and the same messages, built in each package, encode to
EQUAL bytes through each package's ``DEFAULT_SERIALIZER``; the port
decodes the JAX bytes to an equal message of its own class.
"""

import dataclasses
import importlib
import random
import types

import frankenpaxos_tpu_torch.protocols.fastmultipaxos  # noqa: F401
import frankenpaxos_tpu_torch.protocols.fastpaxos  # noqa: F401
from frankenpaxos_tpu_torch.runtime import serializer
from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER
import pytest

import frankenpaxos_tpu.protocols.fastmultipaxos  # noqa: F401
import frankenpaxos_tpu.protocols.fastpaxos  # noqa: F401

#: The tags these codecs take, on both packages.
FAST_TAGS = {90, 91, 92, 93, 94, 95, 70, 71, 72, 73, 74, 75, 157}


def _ns(pkg: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return types.SimpleNamespace(
        fp=mod("protocols.fastpaxos"), fmp=mod("protocols.fastmultipaxos"),
        ser=mod("runtime.serializer"))


PORT, REF = _ns("frankenpaxos_tpu_torch"), _ns("frankenpaxos_tpu")


def samples(ns) -> list:
    """``tests/test_wire_codecs.py``'s Fast Paxos and Fast MultiPaxos
    messages, built from ``ns``'s classes."""
    fp, fmp = ns.fp, ns.fmp
    command = fmp.Command(fmp.CommandId(("h", 5), 3), b"x")
    return [
        # test_steady_wire_codecs_round_trip
        fmp.ProposeRequest(command),
        fmp.ProposeReply(fmp.CommandId(("h", 5), 3), b"r", round=2),
        # test_fastmultipaxos_hot_loop_codecs_round_trip
        fmp.Phase2a(slot=5, round=1, value=command),
        fmp.Phase2a(slot=5, round=1, value=fmp.NOOP),
        fmp.Phase2a(slot=5, round=1, any=True),
        fmp.Phase2a(slot=5, round=1, any_suffix=True),
        fmp.Phase2a(slot=5, round=1),
        fmp.Phase2b(acceptor_id=0, slot=5, round=1, vote=command),
        fmp.Phase2bBuffer((
            fmp.Phase2b(acceptor_id=0, slot=5, round=1, vote=command),
            fmp.Phase2b(acceptor_id=1, slot=6, round=1, vote=fmp.NOOP))),
        fmp.ValueChosen(slot=5, value=command),
        # the fuzz sample of the extended page, and wider values
        fmp.Phase1bNack(acceptor_id=1, round=3),
        fmp.ProposeRequest(fmp.Command(fmp.CommandId("client-7", 1 << 40),
                                       b"\x00\xff" * 70)),
        fmp.ValueChosen(slot=(1 << 40) + 3, value=fmp.NOOP),
        fmp.Phase2bBuffer(()),
        # test_baseline_protocol_codecs_round_trip's Fast Paxos messages
        fp.ProposeRequest("v"), fp.ProposeReply("chosen"),
        fp.Phase1a(4), fp.Phase1b(4, 0, 0, "fast"),
        fp.Phase1b(4, 2, -1, None),
        fp.Phase2a(4, None),  # None = the distinguished "any" value
        fp.Phase2a(4, "v"), fp.Phase2b(2, 4),
        fp.ProposeRequest("héllo " * 20),
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


@pytest.mark.parametrize("seed", range(3))
def test_seeded_messages_give_the_references_bytes(seed):
    """Random slots, rounds, ids, payloads and vote kinds."""
    def build(ns, rng):
        fp, fmp = ns.fp, ns.fmp
        out = []
        for _ in range(60):
            cid = fmp.CommandId(rng.choice(["c", ("h", rng.randrange(99))]),
                                rng.randrange(1 << 50))
            value = fmp.NOOP if rng.random() < 0.3 else fmp.Command(
                cid, bytes(rng.randrange(256)
                           for _ in range(rng.randrange(40))))
            slot, rnd = rng.randrange(1 << 40), rng.randrange(-1, 1 << 20)
            kind = rng.randrange(6)
            if kind == 0:
                out.append(fmp.Phase2a(slot=slot, round=rnd, value=value))
            elif kind == 1:
                out.append(fmp.Phase2b(acceptor_id=rng.randrange(5),
                                       slot=slot, round=rnd, vote=value))
            elif kind == 2:
                out.append(fmp.ValueChosen(slot=slot, value=value))
            elif kind == 3:
                out.append(fmp.ProposeReply(cid, b"r%d" % slot, round=rnd))
            elif kind == 4:
                out.append(fp.Phase1b(rnd, rng.randrange(5), rnd - 1,
                                      None if rng.random() < 0.5
                                      else "v%d" % slot))
            else:
                out.append(fp.Phase2a(rnd, None if rng.random() < 0.5
                                      else "v%d" % slot))
        return out

    ports = build(PORT, random.Random(seed))
    refs = build(REF, random.Random(seed))
    for port, ref in zip(ports, refs):
        data = REF.ser.DEFAULT_SERIALIZER.to_bytes(ref)
        assert DEFAULT_SERIALIZER.to_bytes(port) == data, port
        assert _same(DEFAULT_SERIALIZER.from_bytes(data), port), port


def test_fast_codecs_are_the_references():
    """Each fast tag is registered on both packages, for the message type
    of the same name; the port's Fast Paxos and Paxos-shaped messages
    decode to their own classes."""
    ref = REF.ser._CODECS_BY_TAG
    for tag in FAST_TAGS:
        assert tag in serializer._CODECS_BY_TAG, tag
        assert serializer._CODECS_BY_TAG[tag].message_type.__name__ == \
            ref[tag].message_type.__name__, tag
        assert serializer._CODECS_BY_TAG[tag].message_type.__module__ \
            .startswith("frankenpaxos_tpu_torch.")
    data = DEFAULT_SERIALIZER.to_bytes(PORT.fp.Phase1a(3))
    assert data[0] == 92
    assert type(DEFAULT_SERIALIZER.from_bytes(data)) is PORT.fp.Phase1a
    nack = DEFAULT_SERIALIZER.to_bytes(PORT.fmp.Phase1bNack(1, 3))
    assert nack[:2] == bytes((0, 157 - 128))


def test_pickled_fast_messages_round_trip():
    """The Phase 1 / election traffic of Fast MultiPaxos has no codec and
    pickles, as in the reference."""
    fmp = PORT.fmp
    for message in (
            fmp.Phase1a(round=3, chosen_watermark=2, chosen_slots=(4, 6)),
            fmp.Phase1b(acceptor_id=1, round=3, votes=(
                fmp.Phase1bVote(slot=4, vote_round=0, value=fmp.NOOP),)),):
        data = DEFAULT_SERIALIZER.to_bytes(message)
        assert data[0] >= 128
        assert DEFAULT_SERIALIZER.from_bytes(data) == message
    assert dataclasses.is_dataclass(fmp.Phase1b)


def test_corrupt_frames_are_contained():
    """Single-byte and truncation corruption of every fast codec's frame:
    decode yields garbage or ValueError, never another exception."""
    rng = random.Random(21)
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
