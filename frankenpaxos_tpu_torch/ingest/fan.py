"""paxfan: the scale-out fan-in plane -- a consistent batcher ring (the
port's copy of ``frankenpaxos_tpu/ingest/fan.py``; the same keys land on
the same shards).

HT-Paxos (PAPERS.md) is a scale-OUT dissemination design, so this module turns the batcher tier into N
shards behind *client-side* consistent routing:

  * :class:`BatcherRing` -- classic consistent hashing with virtual
    nodes over the batcher indices. Keys are a stable 64-bit hash of
    ``(client token, pseudonym)`` (:func:`stable_key`), so a session
    pins to one batcher and its descriptor runs stay ordered behind a
    single shard's pipeline window. The hash is
    ``PYTHONHASHSEED``-proof (blake2b, not ``hash()``): every client
    process and every batcher computes the SAME ring.
  * :class:`ShardRouter` -- the per-client routing state machine on
    top of the ring: shard liveness (a timed-out shard's keys remap to
    the clockwise survivors -- failover costs retries, never acked
    loss, because replica client tables dedupe resends) and per-shard
    shed backoff (a ``serve.Rejected`` from one shard floors reissue
    delays against THAT shard only; every other key keeps its pinned
    batcher and its cadence).

Ring-stability contract (property-tested in tests/test_torch_fan.py):

  * removing a batcher moves ONLY the dead batcher's keys;
  * a rejoin is minimal-motion: exactly the keys that failed over
    come back, nothing else moves.

Both fall out of consistent hashing -- liveness is an overlay on one
immutable point set, so the clockwise-successor relation never
changes under death/rejoin.
"""

from __future__ import annotations

import bisect
import hashlib
import struct
import time
from typing import Iterable, Optional

_QQ = struct.Struct("<qq")
_QI = struct.Struct("<qi")


def _h64(data: bytes) -> int:
    """Stable 64-bit hash (blake2b-8): deterministic across processes
    and interpreter launches, unlike ``hash()``."""
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "little")


def stable_key(client_token, pseudonym: int) -> int:
    """The ring key for one session: a stable 64-bit hash of
    ``(client_token, pseudonym)``. ``client_token`` is whatever names
    the client durably -- an int, or the stringified client address
    (tuples/strings are encoded via repr, which is stable for the
    address shapes the transports use)."""
    if isinstance(client_token, int):
        return _h64(_QQ.pack(client_token, pseudonym))
    return _h64(repr(client_token).encode() + _QQ.pack(0, pseudonym))


class BatcherRing:
    """Consistent-hash ring over ``num_batchers`` shards.

    The point set is immutable after construction; death/rejoin is a
    liveness OVERLAY (``alive`` at lookup time), which is what makes
    remapping minimal: a key's clockwise successor chain never
    changes, only how far along it the lookup walks.
    """

    __slots__ = ("num_batchers", "vnodes", "_points", "_owners")

    def __init__(self, num_batchers: int, vnodes: int = 64):
        if num_batchers <= 0:
            raise ValueError("BatcherRing needs at least one batcher")
        self.num_batchers = num_batchers
        self.vnodes = vnodes
        pairs = sorted(
            (_h64(_QI.pack(v, b)), b)
            for b in range(num_batchers) for v in range(vnodes))
        self._points = [p for p, _ in pairs]
        self._owners = [o for _, o in pairs]

    def owner(self, key_hash: int,
              alive: Optional[Iterable[int]] = None) -> int:
        """The shard owning ``key_hash``: the first clockwise vnode
        whose batcher is in ``alive`` (all batchers when None). With
        every shard dead the primary owner is returned -- routing
        somewhere beats wedging, and the resend path retries."""
        points = self._points
        start = bisect.bisect_right(points, key_hash) % len(points)
        if alive is None:
            return self._owners[start]
        alive_set = alive if isinstance(alive, (set, frozenset)) \
            else set(alive)
        owners = self._owners
        n = len(owners)
        for step in range(n):
            owner = owners[(start + step) % n]
            if owner in alive_set:
                return owner
        return owners[start]

    def arc_share(self) -> list:
        """Fraction of the hash space each batcher owns -- the ring's
        STRUCTURAL routing skew (observed skew rides the
        fpx_runtime_ingest_shard_routed_cmds_total counters). Shares
        sum to 1.0."""
        span = [0] * self.num_batchers
        points, owners = self._points, self._owners
        full = 1 << 64
        for i, point in enumerate(points):
            prev = points[i - 1] if i else points[-1] - full
            span[owners[i]] += point - prev
        return [s / full for s in span]


class ShardRouter:
    """Client-side routing state over a :class:`BatcherRing`.

    Two per-shard overlays, deliberately distinct:

      * ``suspect(i)`` -- the shard looks DEAD (request timeout, a
        connection error): its keys fail over to clockwise survivors
        until ``revive_after_s`` elapses. Counted in ``failovers``.
      * ``note_shed(i, retry_after_ms)`` -- the shard is ALIVE but
        shedding (``serve.Rejected``): keys stay pinned (remapping a
        shedding shard's load onto its neighbors turns one hot shard
        into N), and ``floor_delay_s(i)`` floors reissue backoff for
        that shard only.
    """

    __slots__ = ("ring", "revive_after_s", "_dead_until", "_shed_until",
                 "failovers", "routed", "_now")

    def __init__(self, num_batchers: int, *, vnodes: int = 64,
                 revive_after_s: float = 1.0, now=time.monotonic):
        self.ring = BatcherRing(num_batchers, vnodes)
        self.revive_after_s = revive_after_s
        self._dead_until = [0.0] * num_batchers
        self._shed_until = [0.0] * num_batchers
        self.failovers = 0
        self.routed = 0
        self._now = now

    def alive_shards(self) -> frozenset:
        t = self._now()
        alive = frozenset(
            i for i, until in enumerate(self._dead_until) if until <= t)
        # All suspected: treat the ring as whole again (suspicion is
        # advisory; a stale verdict must never wedge routing).
        return alive or frozenset(range(self.ring.num_batchers))

    def route(self, client_token, pseudonym: int) -> int:
        """The live shard index for one session key."""
        self.routed += 1
        return self.ring.owner(stable_key(client_token, pseudonym),
                               self.alive_shards())

    def suspect(self, index: int) -> None:
        """Mark a shard dead for ``revive_after_s`` (timeout-driven);
        its keys remap until it revives."""
        if 0 <= index < len(self._dead_until):
            self._dead_until[index] = self._now() + self.revive_after_s
            self.failovers += 1

    def suspect_key(self, client_token, pseudonym: int) -> int:
        """A request for this key timed out: suspect the shard that
        CURRENTLY owns it (so the resend's route() walks past it) and
        return the suspected index."""
        owner = self.ring.owner(stable_key(client_token, pseudonym),
                                self.alive_shards())
        self.suspect(owner)
        return owner

    def revive(self, index: int) -> None:
        """Positive evidence the shard is back (a reply arrived)."""
        if 0 <= index < len(self._dead_until):
            self._dead_until[index] = 0.0

    def note_shed(self, index: int, retry_after_ms: int) -> None:
        if 0 <= index < len(self._shed_until):
            self._shed_until[index] = max(
                self._shed_until[index],
                self._now() + retry_after_ms / 1000.0)

    def floor_delay_s(self, index: int) -> float:
        """Remaining shed backoff against ONE shard (0.0 when clear)."""
        if not 0 <= index < len(self._shed_until):
            return 0.0
        return max(0.0, self._shed_until[index] - self._now())


def shard_of_address(config, address) -> int:
    """Map a peer address back to its ingest-batcher index, or -1 --
    how clients attribute a ``Rejected``/timeout to a shard."""
    try:
        return config.ingest_batcher_addresses.index(address)
    except (ValueError, AttributeError):
        return -1
