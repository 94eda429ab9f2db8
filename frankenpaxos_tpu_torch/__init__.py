"""frankenpaxos_tpu_torch: the PyTorch + CUDA port of frankenpaxos_tpu.

The JAX package ``frankenpaxos_tpu`` is the reference; this package
reimplements its device hot path for one NVIDIA Hopper GPU (H100):

  * ``quorums/`` -- the quorum systems in factored ``QuorumSpec`` form
    (the port's own copy; pure numpy);
  * ``ops/quorum.py`` -- the dense vote board and ``TpuQuorumChecker``,
    with the quorum predicate (K1) and the dense board update (K2) as
    hand-written CUDA kernels in ``ops/csrc/``;
  * ``bench/pipeline.py`` -- the device-resident MultiPaxos
    steady-state drain (K3): ``run_steps`` runs a run of drains as ONE
    launch of the chunked drain kernel; ``bench/block_sweep.py`` sweeps
    its block size;
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
  * ``ops/telemetry.py`` with ``obs/telemetry.py`` -- the telemetry
    plane: counters the drain accumulates (K14, the telemetry-on twin of
    K3) and their one-copy collection; ``bench/telemetry_overhead.py``
    holds the drain against a pinned telemetry-off copy
    (``bench/pipeline_baseline.py``), and ``bench/libbench.py`` times the
    host data structures and the depset / watermark kernels;
  * ``mesh.py`` with ``bench/pipeline.py``'s sharded drain -- the drain
    over a ``(group, slot)`` mesh of ``torch.distributed`` ranks, split
    at the reference's psums into K19-K21; ``bench/multichip.py`` spawns
    the ranks, ``bench/multichip_lt.py`` holds the mesh against one
    device, and ``ingest/shard.py`` routes a block's lanes to their
    shards;
  * ``convert.py`` -- state carried across from the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where each kernel's plain PyTorch version runs instead. The package
imports ``torch`` and ``numpy`` and never ``jax`` or ``frankenpaxos_tpu``.
"""
