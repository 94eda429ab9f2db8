"""Live reconfiguration in the port: the epoch store (``epoch``) and
epoch-segmented vote counting (``tracker``), the counterparts of
``frankenpaxos_tpu/reconfig/epoch.py`` and ``tracker.py``. The wire
codecs and messages wait for the port of the host runtime."""

from frankenpaxos_tpu_torch.reconfig.epoch import EpochConfig, EpochStore
from frankenpaxos_tpu_torch.reconfig.tracker import EpochQuorumTracker

__all__ = ["EpochConfig", "EpochQuorumTracker", "EpochStore"]
