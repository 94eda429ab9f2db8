"""The port's native wire codec (``frankenpaxos_tpu_torch/native``): its
own ``codec.cpp`` built by ``g++`` into the port's ``_build`` directory,
byte-identical to its Python fallback and to the JAX package's codec on
seeded inputs (frames, frame scans, batch headers and scans, the ingest
and reply column scans, vote packs), and the cases of
``tests/test_native_codec.py`` and ``tests/test_native_parity.py``
repeated against the port, hostile counts included."""

import ctypes
import os
import random
import struct
import subprocess
import threading

from frankenpaxos_tpu_torch import native
import frankenpaxos_tpu_torch.protocols.multipaxos  # noqa: F401 - codecs
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    ClientRequest,
    ClientRequestArray,
    Command,
    CommandBatch,
    CommandId,
    Phase2bVotes,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    encode_value_array,
    LazyValueArray,
    Phase2bVotesCodec,
)
from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER
from frankenpaxos_tpu_torch.runtime.tcp_transport import _encode_frame
import numpy as np
import pytest

from frankenpaxos_tpu import native as jnative
import frankenpaxos_tpu.protocols.multipaxos  # noqa: F401 - JAX codecs


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert lib is not None, native.load_error()
    return lib


class _fallback:
    """Temporarily force the port's pure-Python path."""

    def __enter__(self):
        self._lib = native._lib
        native._lib = None
        native._load_failed = True

    def __exit__(self, *exc):
        native._lib = self._lib
        native._load_failed = self._lib is None


def _verdict(fn, *args, **kwargs):
    """``("ok", result)``, ``("none", None)`` or ``("corrupt", None)``."""
    try:
        out = fn(*args, **kwargs)
    except ValueError:
        return "corrupt", None
    return ("none", None) if out is None else ("ok", out)


def _equal(a, b) -> bool:
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b) and np.asarray(a).dtype == \
            np.asarray(b).dtype
    return a == b


def _three(name: str, *args, **kwargs):
    """The port's native, the port's fallback and the JAX package's
    result of ``native.<name>`` on the same inputs; all three equal."""
    port = _verdict(getattr(native, name), *args, **kwargs)
    with _fallback():
        fallback = _verdict(getattr(native, name), *args, **kwargs)
    ref = _verdict(getattr(jnative, name), *args, **kwargs)
    assert port[0] == fallback[0] == ref[0], (name, port[0], fallback[0],
                                              ref[0])
    assert _equal(port[1], fallback[1]) and _equal(port[1], ref[1]), name
    return port


def _rand_bytes(rng: random.Random, lo: int = 0, hi: int = 200) -> bytes:
    return bytes(rng.randrange(256) for _ in range(rng.randrange(lo, hi)))


# --- the build ---------------------------------------------------------------


def test_library_is_the_ports_own_build(lib):
    """Built from the port's codec.cpp into the port's _build directory,
    keyed by a hash of the source; never the JAX package's library."""
    path = native.library_path()
    assert lib._name == path
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.startswith(os.path.dirname(native.__file__))
    assert os.path.basename(path).startswith("libfpxcodec-")
    assert jnative._LIB != path
    assert native.load_error() is None
    with open(native._SRC, "rb") as f:
        port_src = f.read()
    with open(jnative._SRC, "rb") as f:
        ref_src = f.read()
    # The port's copy differs from the reference in its header comment
    # only: the code below it is the same, line for line.
    strip = [line for line in port_src.splitlines()
             if not line.startswith(b"//")]
    assert strip == [line for line in ref_src.splitlines()
                     if not line.startswith(b"//")]


def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    """Builders that start at once (test workers) take turns on the lock
    file: one library, no temporary file left behind."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    target = native.library_path()
    errors = []

    def build():
        try:
            native._build(target)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert sorted(os.listdir(tmp_path)) == [".lock",
                                            os.path.basename(target)]
    assert hasattr(ctypes.CDLL(target), "fpx_scan_batch")


def test_load_reports_a_failed_build(tmp_path, monkeypatch):
    """A source that does not compile: load() returns None and says why,
    and every entry point runs its fallback."""
    bad = tmp_path / "codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "_load_error", None)
    assert native.load() is None
    assert "CalledProcessError" in native.load_error()
    assert native.encode_frame(b"h:1", b"x") == \
        jnative.encode_frame(b"h:1", b"x")


def test_build_from_source_succeeds_clean(tmp_path):
    out = tmp_path / "libfpxcodec.so"
    subprocess.run(["g++", *native.CXX_FLAGS, "-o", str(out), native._SRC],
                   check=True, capture_output=True)
    assert os.path.getsize(out) > 0
    built = ctypes.CDLL(str(out))
    assert hasattr(built, "fpx_scan_batch")
    assert hasattr(built, "fpx_batch_header")


# --- test_native_codec.py, repeated -----------------------------------------


def test_encode_frame_matches_tcp_transport_format(lib):
    assert native.encode_frame(b"127.0.0.1:9000", b"payload-bytes") == \
        _encode_frame(("127.0.0.1", 9000), b"payload-bytes")


def test_encode_decode_roundtrip(lib):
    payloads = [b"a", b"bb" * 100, b"", b"xyz"]
    blob = native.encode_frames(b"h:1", payloads)
    frames, consumed = native.scan_frames(blob)
    assert consumed == len(blob)
    assert len(frames) == len(payloads)
    for (start, end), payload in zip(frames, payloads):
        (hlen,) = struct.unpack_from(">I", blob, start)
        assert blob[start + 4:start + 4 + hlen] == b"h:1"
        assert blob[start + 4 + hlen:end] == payload


def test_scan_partial_frame(lib):
    frame = native.encode_frame(b"h:1", b"abcdef")
    frames, consumed = native.scan_frames(frame[:-2])
    assert frames == [] and consumed == 0


def test_oversized_frame_rejected(lib):
    with pytest.raises(ValueError):
        native.encode_frame(b"h:1", b"x" * (10 * 1024 * 1024 + 1))
    with pytest.raises(ValueError):
        native.scan_frames(struct.pack(">I", 10 * 1024 * 1024 + 1) + b"x")


def test_vote_batch_roundtrip(lib):
    rng = np.random.default_rng(0)
    slots = rng.integers(0, 1 << 20, 1000).astype(np.int32)
    nodes = rng.integers(0, 6, 1000).astype(np.int32)
    rounds = rng.integers(-1, 5, 1000).astype(np.int32)
    packed = native.pack_votes(slots, nodes, rounds)
    assert len(packed) == 4 + 12 * 1000
    s, n, r = native.unpack_votes(packed)
    np.testing.assert_array_equal(s, slots)
    np.testing.assert_array_equal(n, nodes)
    np.testing.assert_array_equal(r, rounds)


def test_pack_votes2_round_trip_native_and_fallback(lib):
    slots = np.array([3, 5, 9, 1 << 40], dtype=np.int64)
    rounds = np.array([0, 0, 2, 7], dtype=np.int32)
    packed = native.pack_votes2(slots, rounds)
    assert len(packed) == 4 + 12 * 4
    s, r = native.unpack_votes2(packed)
    assert list(s) == list(slots) and list(r) == list(rounds)
    with _fallback():
        assert native.pack_votes2(slots, rounds) == packed
        s2, r2 = native.unpack_votes2(packed)
    assert list(s2) == list(slots) and list(r2) == list(rounds)


def test_unpack_votes2_rejects_hostile_count_without_allocating(lib):
    hostile = struct.pack("<I", 0xFFFFFFFF) + b"\x00" * 24
    for impl in (native, jnative):
        with pytest.raises(ValueError):
            impl.unpack_votes2(hostile)
        with pytest.raises(ValueError):
            impl.unpack_votes(hostile)
        with pytest.raises(ValueError):
            impl.check_votes2(b"\x01")
    with _fallback():
        with pytest.raises(ValueError):
            native.unpack_votes2(hostile)
    codec = Phase2bVotesCodec()
    out = bytearray()
    codec.encode(out, Phase2bVotes(group_index=0, acceptor_index=1,
                                   packed=hostile))
    with pytest.raises(ValueError):
        codec.decode(bytes(out), 0)


# --- test_native_parity.py, repeated against the port and the reference -----


def test_encode_frame_parity_fuzz(lib):
    rng = random.Random(11)
    for _ in range(200):
        header = b"10.0.0.%d:%d" % (rng.randrange(256),
                                    rng.randrange(1 << 16))
        _three("encode_frame", header, _rand_bytes(rng))


def test_encode_frames_parity_fuzz(lib):
    rng = random.Random(12)
    for _ in range(60):
        header = b"h:%d" % rng.randrange(1 << 16)
        _three("encode_frames", header,
               [_rand_bytes(rng) for _ in range(rng.randrange(1, 20))])


def test_scan_frames_parity_fuzz_with_torn_and_corrupt_tails(lib):
    rng = random.Random(13)
    for trial in range(120):
        blob = b"".join(native.encode_frame(b"h:%d" % rng.randrange(9999),
                                            _rand_bytes(rng))
                        for _ in range(rng.randrange(0, 12)))
        mode = trial % 3
        if mode == 1 and blob:
            blob = blob[:rng.randrange(len(blob))]
        elif mode == 2 and len(blob) > 4:
            corrupt = bytearray(blob)
            corrupt[rng.randrange(4)] ^= 1 << rng.randrange(8)
            blob = bytes(corrupt)
        offset = rng.randrange(4)
        _three("scan_frames", bytearray(b"\x00" * offset + blob),
               offset=offset)


def test_scan_frames_max_frames_parity(lib):
    buf = bytearray(native.encode_frame(b"h:1", b"x") * 10)
    kind, got = _three("scan_frames", buf, max_frames=4)
    assert kind == "ok" and len(got[0]) == 4


def test_batch_header_parity_fuzz(lib):
    rng = random.Random(14)
    for _ in range(100):
        _three("batch_header", rng.choice((150, 151, 152, 255)),
               [rng.randrange(1 << 16) for _ in range(rng.randrange(0, 64))])


def test_scan_batch_parity_fuzz_with_torn_and_corrupt_tails(lib):
    rng = random.Random(15)
    for trial in range(200):
        segs = [_rand_bytes(rng, 0, 60) for _ in range(rng.randrange(0, 10))]
        payload = native.batch_header(150, [len(s) for s in segs]) \
            + b"".join(segs)
        mode = trial % 3
        if mode == 1 and len(payload) > 3:
            payload = payload[:rng.randrange(2, len(payload))]
        elif mode == 2 and len(payload) > 3:
            corrupt = bytearray(payload)
            corrupt[rng.randrange(2, len(corrupt))] ^= 1 << rng.randrange(8)
            payload = bytes(corrupt)
        _three("scan_batch", payload, 2)


def test_scan_batch_rejects_hostile_counts(lib):
    """A count that claims more segments than the payload holds raises
    before anything is sized by it, in all three implementations."""
    for payload in (b"\x00\x16" + struct.pack("<I", 0xFFFFFFFF),
                    b"\x00\x16" + struct.pack("<I", 3) + b"\x00" * 4,
                    b"\x00\x16\x01"):
        assert _three("scan_batch", payload, 2)[0] == "corrupt"


def _client_batch_payload(rng: random.Random, n: int,
                          exotic: bool = False) -> bytes:
    """A ClientFrameBatch payload of client-write segments (tag-4 singles
    and tag-115 arrays), built through the port's codecs."""
    segs = []
    for _ in range(n):
        address = (f"10.0.{rng.randrange(4)}.{rng.randrange(4)}",
                   9000 + rng.randrange(4))
        if exotic and rng.random() < 0.3:
            address = f"sim-client-{rng.randrange(3)}"
        if rng.random() < 0.3:
            commands = tuple(
                Command(CommandId(address, rng.randrange(8),
                                  rng.randrange(1 << 20)),
                        _rand_bytes(rng, 0, 30))
                for _ in range(rng.randrange(1, 5)))
            segs.append(DEFAULT_SERIALIZER.to_bytes(
                ClientRequestArray(commands=commands)))
        else:
            segs.append(DEFAULT_SERIALIZER.to_bytes(ClientRequest(Command(
                CommandId(address, rng.randrange(8), rng.randrange(1 << 20)),
                _rand_bytes(rng, 0, 40)))))
    return bytes(native.batch_header(151, [len(s) for s in segs])
                 + b"".join(segs))


def test_ingest_scan_parity_fuzz_with_torn_and_corrupt_tables(lib):
    rng = random.Random(21)
    for trial in range(300):
        payload = _client_batch_payload(rng, rng.randrange(0, 12),
                                        exotic=trial % 5 == 4)
        mode = trial % 3
        if mode == 1 and len(payload) > 3:
            payload = payload[:rng.randrange(2, len(payload))]
        elif mode == 2 and len(payload) > 3:
            corrupt = bytearray(payload)
            corrupt[rng.randrange(2, len(corrupt))] ^= 1 << rng.randrange(8)
            payload = bytes(corrupt)
        _three("ingest_scan", payload, 2)


def test_value_columns_parity_fuzz(lib):
    rng = random.Random(22)
    for trial in range(200):
        payload = _client_batch_payload(rng, rng.randrange(1, 10))
        raw, cols = native.ingest_scan(payload, 2)
        n = len(cols)
        if trial % 3 == 1 and len(raw) > 5:
            raw = raw[:rng.randrange(4, len(raw))]
        elif trial % 3 == 2 and len(raw) > 5:
            corrupt = bytearray(raw)
            corrupt[rng.randrange(len(corrupt))] ^= 1 << rng.randrange(8)
            raw = bytes(corrupt)
        _three("value_columns", raw, n)


def test_ingest_scan_matches_canonical_value_array_encoder(lib):
    rng = random.Random(23)
    for _ in range(30):
        payload = _client_batch_payload(rng, rng.randrange(1, 16))
        raw, cols = native.ingest_scan(payload, 2)
        decoded = tuple(LazyValueArray(raw, len(cols)))
        assert all(isinstance(v, CommandBatch) and len(v.commands) == 1
                   for v in decoded)
        canon = encode_value_array(decoded)
        n, nbytes = struct.unpack_from("<ii", canon, 0)
        assert n == len(cols)
        assert canon[8:8 + nbytes] == raw


def test_reply_columns_parity_fuzz_with_torn_and_corrupt_tails(lib):
    rng = random.Random(24)
    for trial in range(200):
        entries = [(rng.randrange(1 << 20), rng.randrange(1 << 20),
                    rng.randrange(1 << 30), _rand_bytes(rng, 0, 20))
                   for _ in range(rng.randrange(0, 10))]
        payload = bytearray(b"\x76" + struct.pack("<i", len(entries)))
        for p, c, s, result in entries:
            payload += struct.pack("<qqqI", p, c, s, len(result)) + result
        if trial % 3 == 1 and len(payload) > 2:
            payload = payload[:rng.randrange(1, len(payload))]
        elif trial % 3 == 2 and len(payload) > 2:
            payload[rng.randrange(1, len(payload))] ^= 1 << rng.randrange(8)
        _three("reply_columns", bytes(payload), 1)


def test_vote_pack_parity(lib):
    rng = np.random.default_rng(7)
    slots64 = rng.integers(0, 1 << 40, 100, dtype=np.int64)
    rounds = rng.integers(0, 1 << 20, 100).astype(np.int32)
    kind, packed = _three("pack_votes2", slots64, rounds)
    _three("unpack_votes2", packed)
    slots = rng.integers(0, 1 << 20, 100).astype(np.int32)
    nodes = rng.integers(0, 6, 100).astype(np.int32)
    kind, packed = _three("pack_votes", slots, nodes, rounds)
    _three("unpack_votes", packed)
    _three("check_votes2", native.pack_votes2(slots64, rounds))
