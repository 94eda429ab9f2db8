"""Live reconfiguration in the port: the epoch store (``epoch``),
epoch-segmented vote counting (``tracker``) and the messages
(``messages``), the counterparts of ``frankenpaxos_tpu/reconfig/``. The
wire codecs (``reconfig/wire.py``) come with actor-side reconfiguration
(ROADMAP.md queue 1 item 4); until then these messages pickle."""

from frankenpaxos_tpu_torch.reconfig.epoch import EpochConfig, EpochStore
from frankenpaxos_tpu_torch.reconfig.messages import (
    EpochAck,
    EpochCommit,
    EpochPhase2aRun,
    Reconfigure,
)
from frankenpaxos_tpu_torch.reconfig.tracker import EpochQuorumTracker

#: The reconfiguration messages the port's MultiPaxos roles refuse.
RECONFIG_MESSAGES = (Reconfigure, EpochCommit, EpochAck, EpochPhase2aRun)

__all__ = ["EpochAck", "EpochCommit", "EpochConfig", "EpochPhase2aRun",
           "EpochQuorumTracker", "EpochStore", "RECONFIG_MESSAGES",
           "Reconfigure"]
