"""Live reconfiguration in the port, the counterpart of
``frankenpaxos_tpu/reconfig/``:

  * ``reconfig.epoch`` -- ``EpochConfig`` / ``EpochStore``: epoch id ->
    acceptor set + QuorumSpec, watermark-partitioned over slot space,
    persisted through ``wal.records.WalEpoch``.
  * ``reconfig.messages`` / ``reconfig.wire`` -- the config-change
    command flow (Reconfigure -> EpochCommit -> EpochAck, epoch-tagged
    EpochPhase2aRun proposals), fixed-layout codecs on the wire's
    extended tag page (128-131); importing this package registers them.
  * ``reconfig.tracker`` -- ``EpochQuorumTracker``: address-keyed,
    epoch-segmented vote counting (the dict oracle, or the card's
    ``EpochSegmentedChecker``: K6 counts a drain's votes, K7 reshapes
    the board when an epoch is added).

The MultiPaxos roles drive them: the Leader proposes epoch e+1, runs
Phase 1 with both configs and hands over at a watermark; acceptors WAL
each epoch before they ack it; ProxyLeaders route and count each run
under its slot's epoch.
"""

from frankenpaxos_tpu_torch.reconfig.epoch import EpochConfig, EpochStore
from frankenpaxos_tpu_torch.reconfig.messages import (
    EpochAck,
    EpochCommit,
    EpochPhase2aRun,
    Reconfigure,
)
from frankenpaxos_tpu_torch.reconfig.tracker import EpochQuorumTracker
# Importing the wire module registers the extended-page codecs.
from frankenpaxos_tpu_torch.reconfig.wire import (
    decode_epoch_config,
    encode_epoch_config,
)

__all__ = ["EpochAck", "EpochCommit", "EpochConfig", "EpochPhase2aRun",
           "EpochQuorumTracker", "EpochStore", "Reconfigure",
           "decode_epoch_config", "encode_epoch_config"]
