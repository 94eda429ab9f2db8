"""paxingest: the wire-to-device ingestion plane (the port's copy of
``frankenpaxos_tpu/ingest/``).

Host-side Python between ``recv()`` and the vote board costs one codec
dispatch, one ``Command`` object and one handler call PER MESSAGE. This
package removes that layer with two pieces:

  * **Zero-object decode** (:mod:`ingest.columns` over
    ``native.ingest_scan``): a paxwire ``ClientFrameBatch`` arriving on
    the wire scans ONCE into SoA descriptor columns (addr_idx,
    pseudonym, client_id, value offset/length) plus the run pipeline's
    canonical value-array segment -- byte-identical to what
    ``wire._put_value_array`` would produce, so the resulting
    ``LazyValueArray`` re-encodes as a raw copy all the way to the
    acceptors. The control-plane twin, :func:`parse_ack_batch`, lands a
    batch frame of vote acks as range rows for the ProxyLeader's
    quorum tracker (the card's board on the ``"cuda"`` backend).

  * **Disseminator/sequencer split** (:class:`ingest.IngestBatcher`,
    the HT-Paxos shape): batcher roles absorb client fan-in, run the
    serve/ admission discipline at the edge, pre-encode drain-granular
    runs, and hand the MultiPaxos leader pre-batched
    :class:`~ingest.messages.IngestRun` descriptors -- the ordering
    leader's event loop touches only run metadata. Batchers are WAL-free
    by design: a batcher death costs client retries, never acked-write
    loss (the replica client table keeps resends exactly-once).
    :mod:`ingest.fan` spreads the clients over several batchers on a
    consistent ring.

Actors opt into the fast path by declaring ``wire_sinks`` (see
:class:`frankenpaxos_tpu_torch.runtime.actor.Actor`); the TCP transport
hands matching undecoded frame payloads straight to the sink. Mencius's
router waits for Mencius (ROADMAP.md queue 1 item 9) and raises.
:mod:`ingest.shard` routes a drain block's command ids to the slot
shards of a mesh.
"""

# Importing registers the run-descriptor codecs (tags 204-205, 210) with
# the hybrid serializer -- without them IngestRun would silently pickle.
from frankenpaxos_tpu_torch.ingest import wire as _wire  # noqa: E402,F401
from frankenpaxos_tpu_torch.ingest.batcher import (  # noqa: F401
    IngestBatcher,
    IngestBatcherOptions,
    MenciusIngestRouter,
    MultiPaxosIngestRouter,
)
from frankenpaxos_tpu_torch.ingest.columns import (  # noqa: F401
    AckColumns,
    ColumnRun,
    parse_ack_batch,
    parse_client_batch,
    value_view,
)
from frankenpaxos_tpu_torch.ingest.fan import (  # noqa: F401
    BatcherRing,
    shard_of_address,
    ShardRouter,
    stable_key,
)
from frankenpaxos_tpu_torch.ingest.messages import (  # noqa: F401
    IngestCredit,
    IngestRun,
    NotLeaderIngest,
)
from frankenpaxos_tpu_torch.ingest.shard import (  # noqa: F401
    command_ids,
    place_block,
    route_block,
)
