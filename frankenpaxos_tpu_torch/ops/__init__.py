"""Device kernels of the port: the vote board, the quorum checkers and
the epoch / multi-config checkers (``quorum.py``), the Phase-1 recovery
reduction and the modal reply count (``value.py``), the dependency-set
algebra (``depset.py``), the watermarks (``watermark.py``) and the
telemetry counters of the drain (``telemetry.py``).

CUDA sources live in ``csrc/`` and are built at first use by
``_build``; nothing is compiled when this package is imported.
"""

from frankenpaxos_tpu_torch.ops.quorum import (
    EpochSegmentedChecker,
    make_vote_board,
    MultiConfigQuorumChecker,
    TpuQuorumChecker,
    VoteBoard,
)

__all__ = ["EpochSegmentedChecker", "MultiConfigQuorumChecker",
           "TpuQuorumChecker", "VoteBoard", "make_vote_board"]
