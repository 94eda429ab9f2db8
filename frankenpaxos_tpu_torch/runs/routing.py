"""ClientRequest routing for the run pipeline (the port's copy of
``frankenpaxos_tpu/runs/routing.py``).

The paxingest destination ladder the multipaxos and mencius clients
each hard-coded: ingest disseminators absorb client fan-in when the
config deploys them (a resend re-rolls the pick, so a dead batcher
costs a retry, not a wedge), plain batchers come next, and the
protocol's own leader-selection rule is the fallback. Protocols that
route differently (per-group leaders, rounds) pass that rule in as
``leader_fallback`` -- the ladder itself is protocol-neutral.

paxfan: with a :class:`~frankenpaxos_tpu_torch.ingest.fan.ShardRouter`
(``fan``) and a session key, the ingest tier is no longer a random
pick -- the key pins to one batcher on the consistent ring, a dead
batcher's keys fail over to clockwise survivors, and every other key
keeps its shard. The random pick remains the keyless fallback (and
the single-batcher degenerate case routes identically either way).
"""

from __future__ import annotations

import random
from typing import Callable, Optional


def make_fan_router(config, *, revive_after_s: float = 1.0):
    """A ShardRouter over the config's ingest tier, or None when the
    config deploys no ingest batchers (the ladder falls through)."""
    if getattr(config, "num_ingest_batchers", 0) <= 0:
        return None
    from frankenpaxos_tpu_torch.ingest.fan import ShardRouter

    return ShardRouter(config.num_ingest_batchers,
                       revive_after_s=revive_after_s)


def pick_request_destination(config, rng: random.Random,
                             leader_fallback: Callable,
                             fan=None, key: Optional[tuple] = None):
    """Destination for a single ClientRequest:
    ingest batchers (ring-pinned when ``fan``+``key`` are given,
    random otherwise) > batchers > ``leader_fallback()``."""
    if getattr(config, "num_ingest_batchers", 0) > 0:
        if fan is not None and key is not None:
            return config.ingest_batcher_addresses[
                fan.route(key[0], key[1])]
        return config.ingest_batcher_addresses[
            rng.randrange(config.num_ingest_batchers)]
    if getattr(config, "num_batchers", 0) > 0:
        return config.batcher_addresses[
            rng.randrange(config.num_batchers)]
    return leader_fallback()


def pick_array_destination(config, rng: random.Random,
                           leader_fallback: Callable,
                           fan=None, key: Optional[tuple] = None):
    """Destination for a staged ClientRequestArray: ingest batchers >
    ``leader_fallback()``. Arrays bypass plain batchers -- they are
    already transport-level coalesced, and the batcher tier only
    re-buckets singles. A staged array spans many pseudonyms of one
    client, so its ring key is the client-scoped sentinel the caller
    passes (conventionally ``(client_token, -1)``)."""
    if getattr(config, "num_ingest_batchers", 0) > 0:
        if fan is not None and key is not None:
            return config.ingest_batcher_addresses[
                fan.route(key[0], key[1])]
        return config.ingest_batcher_addresses[
            rng.randrange(config.num_ingest_batchers)]
    return leader_fallback()
