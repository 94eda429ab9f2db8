"""Device kernels of the port: the dense vote board and quorum checker.

CUDA sources live in ``csrc/`` and are built at first use by
``_build``; nothing is compiled when this package is imported.
"""

from frankenpaxos_tpu_torch.ops.quorum import (
    make_vote_board,
    TpuQuorumChecker,
    VoteBoard,
)

__all__ = ["TpuQuorumChecker", "VoteBoard", "make_vote_board"]
