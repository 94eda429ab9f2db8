"""The wire-to-device ingest leg: the lane router of the sharded drain
(``shard.py``). The rest of the reference's ``ingest/`` (the paxwire
column scan) is not ported yet (ROADMAP.md queue 1 item 8.2)."""

from frankenpaxos_tpu_torch.ingest.shard import (
    command_ids,
    place_block,
    route_block,
)

__all__ = ["command_ids", "place_block", "route_block"]
