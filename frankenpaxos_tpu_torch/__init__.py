"""frankenpaxos_tpu_torch: the PyTorch + CUDA port of frankenpaxos_tpu.

The JAX package ``frankenpaxos_tpu`` is the reference; this package
reimplements its device hot path for one NVIDIA Hopper GPU (H100):

  * ``quorums/`` -- the quorum systems in factored ``QuorumSpec`` form
    (the port's own copy; pure numpy);
  * ``ops/quorum.py`` -- the dense vote board and ``TpuQuorumChecker``,
    with the quorum predicate (K1) and the dense board update (K2) as
    hand-written CUDA kernels in ``ops/csrc/``;
  * ``bench/pipeline.py`` -- the device-resident MultiPaxos
    steady-state drain (K3), looped by ``run_steps``;
  * ``bench/headline.py`` -- the single-GPU headline benchmark;
  * ``protocols/multipaxos/`` with ``runtime/`` -- the MultiPaxos
    cluster of actors over ``SimTransport``: the ProxyLeaders' vote
    tracking on the vote board, the Leader's Phase-1 recovery on K8
    (``ops/value.py``); ``bench/multipaxos_sim.py`` drives it;
  * ``protocols/epaxos/`` with ``ops/depset.py`` -- EPaxos over
    ``SimTransport``, its replicas' dependency decisions on K10
    ``conflict_max`` and K11 ``all_equal`` (K9 ``normalized`` is the
    row normalization both share); ``bench/epaxos_sim.py`` and
    ``bench/depset_lt.py`` drive it;
  * ``convert.py`` -- state carried across from the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where each kernel's plain PyTorch version runs instead. The package
imports ``torch`` and ``numpy`` and never ``jax`` or ``frankenpaxos_tpu``.
"""
