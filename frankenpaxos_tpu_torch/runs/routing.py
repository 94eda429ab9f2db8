"""ClientRequest routing for the run pipeline.

The port's copy of ``frankenpaxos_tpu/runs/routing.py``: plain batchers
absorb client fan-in when the config deploys them, and the protocol's
own leader-selection rule (``leader_fallback``) is the fallback. The
reference's first rung, the ingest disseminators and their consistent
ring (``ingest/``), is not ported yet: a config that deploys ingest
batchers is refused (ROADMAP.md queue 1 item 8.2: ingest fabric).
"""

from __future__ import annotations

import random
from typing import Callable


def _refuse_ingest(config) -> None:
    if getattr(config, "num_ingest_batchers", 0) > 0:
        raise NotImplementedError(
            "ingest batchers are not ported yet (ROADMAP.md queue 1 "
            "item 8.2: ingest fabric)")


def pick_request_destination(config, rng: random.Random,
                             leader_fallback: Callable):
    """Destination for a single ClientRequest: a random batcher, else
    ``leader_fallback()``."""
    _refuse_ingest(config)
    if getattr(config, "num_batchers", 0) > 0:
        return config.batcher_addresses[
            rng.randrange(config.num_batchers)]
    return leader_fallback()


def pick_array_destination(config, rng: random.Random,
                           leader_fallback: Callable):
    """Destination for a staged ClientRequestArray: ``leader_fallback()``.
    Arrays bypass plain batchers -- they are already transport-level
    coalesced, and the batcher tier only re-buckets singles."""
    _refuse_ingest(config)
    return leader_fallback()
