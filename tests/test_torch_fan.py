"""The port's twin of ``tests/test_fan.py`` (paxfan): the consistent
batcher ring, the client-side shard router, and the batcher's descriptor
pipelining window -- and their parity with the JAX package.

The load-bearing property: ring membership changes move ONLY the keys
that must move. A dead batcher's keys fail over to its clockwise
survivors; every other key keeps its pinned shard, and a rejoin restores
exactly the original placement. Placement is part of the output, so the
port's ring must put the same keys on the same shards as the
reference's, through a death and a rejoin. Left out: the reference's
``deployed_twin`` registry case (its bench suite, ROADMAP.md queue 1
item 11).
"""

from __future__ import annotations

import random

from frankenpaxos_tpu_torch.ingest import (
    BatcherRing,
    IngestBatcher,
    IngestBatcherOptions,
    MultiPaxosIngestRouter,
    parse_client_batch,
    ShardRouter,
    stable_key,
)
from frankenpaxos_tpu_torch.ingest.messages import IngestCredit, IngestRun
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
import pytest

from tests.test_torch_ingest import _client_batch, _request


def _keys(n: int, seed: int = 0) -> list:
    rng = random.Random(seed)
    return [stable_key(("10.0.0.%d" % rng.randrange(64), 9000),
                       rng.randrange(1 << 20)) for _ in range(n)]


# --- ring stability properties ----------------------------------------------


@pytest.mark.parametrize("num_batchers", [2, 3, 4, 7])
def test_ring_death_moves_only_the_dead_shards_keys(num_batchers):
    ring = BatcherRing(num_batchers)
    keys = _keys(2000, seed=num_batchers)
    before = [ring.owner(k) for k in keys]
    for dead in range(num_batchers):
        alive = frozenset(s for s in range(num_batchers) if s != dead)
        after = [ring.owner(k, alive) for k in keys]
        for k, b, a in zip(keys, before, after):
            if b == dead:
                # The dead shard's keys fail over to SOME survivor.
                assert a in alive, (dead, k)
            else:
                # Everyone else stays pinned -- the stability half.
                assert a == b, (dead, k)


def test_ring_rejoin_restores_the_exact_original_placement():
    ring = BatcherRing(4)
    keys = _keys(1000, seed=9)
    before = [ring.owner(k) for k in keys]
    degraded = [ring.owner(k, frozenset({0, 2, 3})) for k in keys]
    assert degraded != before  # shard 1 owned some keys
    rejoined = [ring.owner(k, frozenset(range(4))) for k in keys]
    assert rejoined == before


def test_ring_double_death_is_still_minimal_motion():
    ring = BatcherRing(5)
    keys = _keys(1500, seed=3)
    before = [ring.owner(k) for k in keys]
    alive = frozenset({0, 2, 4})
    after = [ring.owner(k, alive) for k in keys]
    for b, a in zip(before, after):
        if b in alive:
            assert a == b
        else:
            assert a in alive


def test_ring_arc_share_sums_to_one_and_is_roughly_even():
    for n in (2, 4, 8):
        share = BatcherRing(n).arc_share()
        assert len(share) == n
        assert abs(sum(share) - 1.0) < 1e-9
        # 64 vnodes keep the skew modest; the deployed gauge charts
        # the exact structural value.
        assert max(share) < 3.0 / n


def test_stable_key_is_deterministic_and_token_shaped():
    a = stable_key(("10.0.0.1", 9000), 7)
    assert a == stable_key(("10.0.0.1", 9000), 7)
    assert a != stable_key(("10.0.0.1", 9000), 8)
    assert a != stable_key(("10.0.0.2", 9000), 7)
    # Integer client tokens take the packed-pair path; both shapes
    # yield 64-bit hashes.
    b = stable_key(3, 7)
    assert 0 <= a < (1 << 64) and 0 <= b < (1 << 64)


# --- the client-side shard router --------------------------------------------


def test_shard_router_suspect_remaps_only_that_shards_keys():
    now = [0.0]
    router = ShardRouter(4, revive_after_s=5.0, now=lambda: now[0])
    sessions = [("c%d" % (i % 16), i) for i in range(600)]
    before = [router.route(c, p) for c, p in sessions]
    dead = before[0]
    failovers_before = router.failovers
    router.suspect(dead)
    after = [router.route(c, p) for c, p in sessions]
    moved = 0
    for b, a in zip(before, after):
        if b == dead:
            assert a != dead
            moved += 1
        else:
            assert a == b
    assert moved > 0
    assert router.failovers > failovers_before
    assert dead not in router.alive_shards()
    # Past the revive horizon the suspect expires: original placement.
    now[0] = 6.0
    assert [router.route(c, p) for c, p in sessions] == before
    assert dead in router.alive_shards()


def test_shard_router_shed_floor_is_per_shard():
    now = [0.0]
    router = ShardRouter(3, revive_after_s=5.0, now=lambda: now[0])
    router.note_shed(1, retry_after_ms=250)
    assert router.floor_delay_s(1) > 0.0
    assert router.floor_delay_s(0) == 0.0
    assert router.floor_delay_s(2) == 0.0
    # Shedding keeps the shard PINNED (its keys stay put -- backoff,
    # not failover).
    assert 1 in router.alive_shards()
    now[0] = 1.0
    assert router.floor_delay_s(1) == 0.0


# --- descriptor pipelining (the batcher window) ------------------------------


class _Cfg:
    num_leaders = 1
    leader_addresses = ["leader-0"]


def _make_batcher(transport, window: int, **kwargs) -> IngestBatcher:
    logger = FakeLogger(LogLevel.FATAL)
    kwargs.setdefault("flush_period_s", 0.0)
    return IngestBatcher(
        "batcher-0", transport, logger, MultiPaxosIngestRouter(_Cfg),
        options=IngestBatcherOptions(pipeline_window=window, **kwargs))


def _runs_sent(transport) -> list:
    from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER

    runs = []
    for m in transport.messages:
        if m.dst != "leader-0":
            continue
        decoded = DEFAULT_SERIALIZER.from_bytes(m.data)
        if isinstance(decoded, IngestRun):
            runs.append(decoded)
    return runs


def _feed(batcher, start: int, n: int) -> None:
    colrun = parse_client_batch(_client_batch(
        [_request(i) for i in range(start, start + n)]))
    batcher._handle_client_columns("client", colrun)
    batcher.flush_ingest()


def test_pipelining_ships_ahead_up_to_the_window_then_queues():
    transport = SimTransport(FakeLogger(LogLevel.FATAL))
    batcher = _make_batcher(transport, window=2)
    # Three column runs, no credits: only the window ships.
    for i in range(3):
        _feed(batcher, i * 4, 4)
    runs = _runs_sent(transport)
    assert len(runs) == 2, "window=2 must bound un-credited runs"
    assert [r.seq for r in runs] == [0, 1]
    assert len(batcher._window_queue[0]) == 1
    assert batcher._inflight[0] == {0, 1}


def test_credit_watermark_drains_prefix_and_reopens_window():
    transport = SimTransport(FakeLogger(LogLevel.FATAL))
    batcher = _make_batcher(transport, window=2)
    for i in range(4):
        _feed(batcher, i * 4, 4)
    assert len(_runs_sent(transport)) == 2
    # Watermark credit acks EVERY seq <= 1 in one reply.
    batcher.receive("leader-0", IngestCredit(group_index=0,
                                             watermark_seq=1))
    assert batcher._inflight[0] == {2, 3}
    assert len(_runs_sent(transport)) == 4
    batcher.receive("leader-0", IngestCredit(group_index=0,
                                             watermark_seq=3))
    assert not batcher._inflight[0]
    assert not batcher._window_queue[0]


def test_stalled_window_voids_after_stall_ticks_and_ships():
    transport = SimTransport(FakeLogger(LogLevel.FATAL))
    batcher = _make_batcher(transport, window=1, pipeline_stall_ticks=3,
                            flush_period_s=0.01)
    for i in range(2):
        _feed(batcher, i * 4, 4)
    assert len(_runs_sent(transport)) == 1
    # No credit ever arrives (the leader crashed and its relaunch lost
    # the window state): consecutive blocked ticks void the window.
    for _ in range(3):
        batcher._timer_flush()
    assert len(_runs_sent(transport)) == 2


def test_window_zero_disables_pipelining_bound():
    transport = SimTransport(FakeLogger(LogLevel.FATAL))
    batcher = _make_batcher(transport, window=0)
    for i in range(5):
        _feed(batcher, i * 4, 4)
    assert len(_runs_sent(transport)) == 5


# --- parity with the JAX package -----------------------------------------

import numpy as np  # noqa: E402

from frankenpaxos_tpu.ingest import fan as ref_fan  # noqa: E402


def _seeded_tokens(seed: int, n: int) -> list:
    """``n`` (client token, pseudonym) pairs of every token shape the
    transports use: ints, loopback (host, port) tuples, strings."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            token = int(rng.integers(-2**62, 2**62))
        elif kind == 1:
            token = ("10.0.%d.%d" % (int(rng.integers(0, 256)),
                                     int(rng.integers(0, 256))),
                     int(rng.integers(1024, 65536)))
        else:
            token = "client-%d" % int(rng.integers(0, 10**6))
        out.append((token, int(rng.integers(-1, 2**20))))
    return out


@pytest.mark.parametrize("num_batchers", [1, 2, 3, 5])
def test_ring_owners_equal_the_references_through_death_and_rejoin(
        num_batchers):
    tokens = _seeded_tokens(num_batchers, 10 ** 4)
    keys = [stable_key(t, p) for t, p in tokens]
    assert keys == [ref_fan.stable_key(t, p) for t, p in tokens]
    port, ref = BatcherRing(num_batchers), ref_fan.BatcherRing(num_batchers)
    assert port.arc_share() == ref.arc_share()
    dead = num_batchers - 1
    survivors = set(range(num_batchers)) - {dead}
    for alive in (None, survivors or None, None):  # whole, death, rejoin
        assert [port.owner(k, alive) for k in keys] == \
            [ref.owner(k, alive) for k in keys]


@pytest.mark.parametrize("num_batchers", [2, 4])
def test_shard_router_equals_the_references_through_death_and_rejoin(
        num_batchers):
    """The same route / suspect / revive / shed script on both routers,
    on one injected clock: the same shards, failovers and floors."""
    tokens = _seeded_tokens(10 + num_batchers, 10 ** 4)
    routers = []
    for cls in (ShardRouter, ref_fan.ShardRouter):
        now = [0.0]
        routers.append((cls(num_batchers, revive_after_s=1.0,
                            now=lambda now=now: now[0]), now))
    trace = [[], []]
    for j, (router, now) in enumerate(routers):
        for i, (token, pseudonym) in enumerate(tokens):
            if i == 2000:
                router.suspect_key(token, pseudonym)   # a death
            if i == 4000:
                router.note_shed(0, 250)
            if i == 6000:
                now[0] += 0.5
            if i == 8000:
                now[0] += 0.6                          # revived: rejoin
            trace[j].append((router.route(token, pseudonym),
                             router.floor_delay_s(0)))
        trace[j].append((router.failovers, router.routed,
                         sorted(router.alive_shards())))
    assert trace[0] == trace[1]
