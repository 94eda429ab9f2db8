#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero and prints no result):

  1. device: the card's name, and ``nvidia-smi``'s name and power limit;
  2. build: compiles every kernel of ``frankenpaxos_tpu_torch/ops/csrc``
     (one ``nvcc`` per source, in parallel) and prints the seconds;
  3. K1 ``quorum_hit`` against its plain version, exact: every form
     (majorities of 1-16 acceptors, the register forms, and of 17, the
     runtime loop; two overlapping groups under any and all, no group, a
     weighted group; the 2x3, 3x3, permuted 2x3 and 3x1 grids, write
     and read; the zone grid) at B = 1, 15, 16, 63, 64, 1007, 4096 and
     32768, on 0/1 votes and arbitrary bytes, contiguous, transposed,
     offset 1, 7 and 15 bytes off a 16-byte boundary, and with a row
     stride that is not a multiple of 16; then the staged entry
     (``TpuQuorumChecker.check_block``, and three segments side by side
     through ``stage_block`` / ``check_staged``) against a checker on the
     CPU;
  4. K2 ``record_block`` against its plain version: a
     ``TpuQuorumChecker`` at window 2^20 through 64 record_block calls of
     width 32768 with ring wrap, round preemption and stale owners; the
     newly masks and the whole board must be equal after every call;
     then K2's run entry (``record_block_run``, one launch a run of
     blocks) against ``record_block_run_plain`` in every form of phase
     3's predicates, on random mid-flight boards: runs of 1-9 blocks at
     unaligned columns, at the ring end, across the int32 wrap, with
     bytes 0-255, preemption, claims, stale owners and a block over an
     earlier one's columns (another launch); and the checker's staged
     run (``dense_run``: one staged call with the held releases ahead of
     the launch) against a checker on the CPU, a K4 call between runs;
  5. the chunked drain kernel, one launch a run: K3 (telemetry off), K14
     (telemetry on) and the re-pinned copy, at window 2^20, block 2^15,
     one run after another (each resuming the one before): majority-3
     runs of 1, 2, 3, 64 and 4096 drains from drain 0 and of 1, 2, 3,
     128, 4096 and 32768 from 2^31 - 70, the 2x3 grid 1, 2, 3, 64 and
     4096 from 0 and 1, 2, 3 and 4096 from 2^31 - 70 (the 128- and
     4096-drain runs from 2^31 - 70 cross the int32 wrap inside one
     launch), against the plain drain loop: every field of K3 and K14
     and every counter of K14 equal to the plain version's after every
     run, and K3 equal to the pinned copy bit for bit;
  6. K4 ``record_and_check`` against its plain version: 64 calls of
     64-4096 lanes at window 2^20 per spec (majority-3, 2x3 grid) on a
     mid-flight board, with duplicate slots, stale owners, ring wrap,
     round preemption and padding lanes; newly masks and boards equal
     after every call; K4's run (``record_and_check_run``, one launch a
     run of chunks) against ``record_and_check_run_plain`` in every form
     of phase 3's predicates at runs of 1, 4 and 48 chunks of 1-256
     lanes, duplicates inside and across chunks, slots and nodes out of
     range, true slots across 2^31 - 1; then the pipelined tracker on the
     card (each drain ONE staged call, ``fpx_board_run_staged``: its
     dense blocks and scatter chunks in order) against the same tracker
     on the CPU, on tracker_lt's mixed stream (chunks of older, newer and
     the drain's round, bursts, ring-end remainders between dense runs)
     and on its first 2^16 slots at window 2^20: every drain's reports
     equal, the boards equal (error 0), one staged call a drain, and at
     most one K4 launch a sparse segment;
  7. K5 ``release`` against its plain version at window 2^20; its
     all-valid form (``release_all``) against ``release_all_plain`` at
     1-4096 lanes, from aligned and unaligned slot arrays; and a card
     checker's held releases against a CPU checker's (a release, then a
     vote a window on, K4, several releases before one call, a reshape,
     ``flush_releases``), boards equal after each;
  8. K6 ``check_batch_multi`` alone and ``record_and_check_epochs``
     against their plain versions: three epochs over a 5-node union,
     window 2^14 (the epoch tracker's), one-chunk calls of 64-1024
     lanes, and of 1024 (workspace in shared memory past 48 KB) and
     8192 (workspace in device memory); then the run (one launch a run
     of 256-lane chunks) against the plain version called chunk by
     chunk: runs of 1, 2 and 48 chunks with duplicates inside and across
     chunks, stale owners, ring wrap, preemption, slots and nodes out of
     range and pad lanes, a chunk across each epoch boundary, true slots
     across the int32 wrap, a ragged last chunk, the same run without
     its pad lanes (equal), and the tracker's staged entry
     (``EpochSegmentedChecker.record_and_check_run``, 48 chunks a call)
     against a checker on the CPU, also right behind a release (K5) and
     an epoch reshape (K7) queued on the current stream behind a sleep;
  9. K7 ``reshape_columns`` against its plain version, exact: the
     [3, 2^14] (tracker_lt's handover) and [3, 2^20] boards and rows of
     1000 and 2^14 + 5 bytes to widened, permuted and shrunk universes,
     through maps past N_old (clamped), below -1 and longer than the 64
     rows that cross in the call's packed block; each map in the call
     (numpy), on the card and into ``out=``; a block off the 16-byte
     grid; a launch inside a side stream's context;
  10. K8 ``safe_values`` against its plain version, exact, at [2^13, 3],
     [2^16, 3], [2^16, 6], a ragged last tile ([2^13 + 77, 3]) and
     N = 1, 2, 5, 9 (the generic form) and 17 (the wide form), with
     forced ties, all-NO_VOTE rows, INT32_MIN / INT32_MAX rounds and the
     Leader's padding rows: the lean wrapper, into ``out=`` and on
     matrices off the 16-byte grid; the Leader's staged entry (the
     kernel reading and writing pinned blocks in place), on
     ``recovery_matrices``'s prefilled views and on other arrays;
  11. the main path, with every kernel's launch count set to 0 first:
     the headline (``frankenpaxos_tpu_torch.bench.headline``) at full
     size for both arms (2^30 commits each, commit count checked; each
     run of 32768 drains is ONE launch of K3, each latency sample one
     launch), a
     ``TpuQuorumChecker`` drain loop at window 2^20 (check_block,
     check_batch, record_block) checked against the host oracle, and
     ``bench/tracker_lt.py`` at full width (window 2^20, 2^20 slots per
     arm: sync, pipelined, 2x3 grid, epoch handover), every arm checked
     against its dict oracle; K1-K7 must each have launched;
  12. the MultiPaxos cluster path, with every count set to 0 again
     first: ``bench/multipaxos_sim.py`` at full width and cut depth
     (2^13 steady writes on the synchronous tracker, a failover of 2^13
     writes whose recovery runs K8 on [2^13, 3], both cut from the
     bench's 2^16 to hold the smoke's time; 2^14 writes on the
     pipelined tracker whose last
     wave has one acceptor's votes straggle across a failover), every
     write answered with its state machine result, both replicas'
     logs equal, K8's recovery equal to the host path's; K1, K2, K4
     and K8 must each have launched on the arms' traffic (K4 on the
     pipelined arm's straggling votes; K5 runs only in the pipelined
     trackers' construction prewarm, as no role releases the board);
  13. K9 ``normalized``, K10 ``union_reduce`` / ``conflict_max`` and
     K11 ``all_equal`` against their plain versions: exact, at
     [4096, 5, 2048] (arbitrary bytes), [4096, 3, 32] (depset_lt's),
     [3, 5, 8], [5, 5, 2048] and [1, 1, 37], and K10 and K11 also at the
     cluster paths' [2, 2, 8 / 64 / 2048] and [4, 5, 8], rows wider than
     K10's shared chunk ([3, 2, 10000], [64, 2, 9000]) and W = 37 over
     64 and 600 rows (the large batches take K10's and K11's cluster
     forms), 0/1 and arbitrary bytes, with window bases near 2^31 - 1 and
     negative watermarks, and ``all_equal`` cases that are equal only
     after normalization; the staged entries (``union_packed`` in seq
     mode, ``all_equal_packed``: one call a decision) on packed blocks
     holding the same batches, against the same plain versions;
  14. the EPaxos path, with every count set to 0 again first:
     ``bench/epaxos_sim.py`` (f = 2, five replicas, 64 closed-loop
     pairs, arms conflict2 and conflict25, each on the host and the
     cuda backend; every command answered once with its KeyValueStore
     result, the replicas' logs and states equal, the cuda run's log
     and replies equal the host run's) and ``bench/depset_lt.py``
     (widths 256, 1024, 4096, aggregates equal on every drain; the
     host runs go to two worker processes beside the cuda runs); K10
     ``conflict_max`` and K11 ``all_equal`` must each have launched on
     the cluster's traffic (each decision one staged call);
  15. K12 ``quorum_watermark`` and K13 ``contiguous_prefix_length``
     against their plain versions: exact. K12 at n in {1, 2, 3, 5, 7,
     9, 31, 32, 33, 64, 65, 128, 1001} and B in {1, 4096, 2^16}, and at
     n in {1025, 2500} (rows taken in tiles) and B in {1, 4096}, every
     quorum size in [1, n] (a spread of them above 65), per-row sizes
     and the out-of-range 0, -1 and n + 1, values near +-2^31 and ties,
     strided rows, an ``out=`` buffer written and returned; a launch
     inside a side stream's context ordered on that stream; its vector
     form on int64 matrices that wrap to int32, in shapes that grow and
     shrink between calls. K13
     on libbench's [4096] (one False in the middle), [4096, 3] rows,
     arbitrary bytes and signed types, all-true rows long enough for
     many tiles, and an empty last axis; then in every form and element
     type: the first zero at each byte of a 16-byte word and at each
     side of the CTA form's tile boundaries, values outside {0, 1}
     before and after it (-1, products that wrap to 0, int64 high bits),
     rows 1-15 elements off the 16-byte grid, strided and transposed
     rows, the switch-over shapes (L 16 / 17, 512 / 513, 511 words / one
     more element, rows about the CTA grid of 528), ``out=`` written and
     returned, a launch inside a
     side stream's context ordered on that stream, and the form the C
     entry launches equal to ``prefix_form``'s;
  16. the BPaxos path, with every count set to 0 again first:
     ``bench/bpaxos_sim.py`` at full width (f = 1, 64 pairs; arms
     simple-conflict2, simple-conflict25 and gc, each on the host and
     the cuda backends, 2^13 commands each, cut from the bench's 2^14 to
     hold the smoke's time; the gc arm's replica 2 partitioned for the
     first half and caught up through a peer's CommitSnapshot); every
     gate of the bench passes, and K10 ``union_reduce`` (one staged
     call a Leader's decision) and K12 ``quorum_watermark`` must each
     have launched on the cluster's traffic;
  17. the same three kernels in their other forms, against the plain
     loop: at the full width, runs of 1, 3 and 64 drains from 2^31 - 40
     for majority-5, the 2x3 read grid, a permuted 2x3 write grid, a 3x3
     grid, a 3x1 grid, WPaxos's 3x3 zone grid (three groups), two
     overlapping groups and 17 acceptors (the memory path); at
     window/block 1 to 6 (1 and 2: the blocks alias, the memory path; 3
     and 4: the register carry's GC-zeroed next and ahead columns; 3, 5
     and 6: rings that jump at the int32 wrap): runs of 1, 2, 3 and 40
     drains from drain 0 and from 2^31 - 20 (the 40-drain run crosses
     the wrap), both specs; the counters re-adding to the committed
     count; telemetry-on runs of 1, 64 and 4096 drains under
     ``torch.cuda.set_sync_debug_mode("error")`` (any hidden sync
     raises) and one ``collect``; and a K3 and a K14 run launched inside
     a side stream's context, behind work that copies the state it
     resumes, ordered on that stream;
  18. the telemetry path, with every count set to 0 first: the
     telemetry-overhead twin (``bench/telemetry_overhead.py``) at the
     reference's widths 2^12/2^8 and 2^13/2^9 and the headline width
     2^20/2^15, the reference's ``--smoke`` knobs, through
     ``measure_width``; the arms must agree (the 3% gate is printed as
     measured, not enforced); every arm advances one launch a chunk; K3,
     K14 and the pinned copy must each have launched;
  19. K15 ``count_matching_replies`` against its plain version: exact, S
     in {1, 4096, 2^16} x N in {1, 2, 3, 5, 7, 16}, with ties, rows with
     no valid reply, ids near +-2^31, and an empty S;
  20. K16 (``union``, ``intersect``, ``compact``) and K17 (``equal``,
     ``size``, ``contains``) against their plain versions: exact, on
     libbench's [4096, 3, 64] and the shapes of phase 13, window bases
     near 2^31 - 1 and below 0, 0/1 and arbitrary bytes, aliased
     inputs, every broadcast shape of ``executed``, leaders -1 and >= L
     and ids on both sides of the window; then K16's union at W in {1,
     15, 16, 17, 37, 64, 2048} and [B, L] in {[33, 3], [64, 4]},
     watermarks near +-2^31, aliased and distinct inputs, views 1-15
     bytes off the 16-byte grid, ``out=`` with its own tail base and
     into ``a`` itself;
  21. the libbench path, with every count set to 0 first: the libbench
     twin (``bench/libbench.py``) at the reference's sizes; K10, K12,
     K13 and K16's ``union`` must each have launched;
  22. K18 ``link_keep_mask`` against its plain version: exact, at 1000
     zones (a [1001, 1001] up-matrix with about 20% of its links down)
     for n in {1, 15, 16, 17, 31, 32, 33, 500, 4096, 65536}, ids at
     every edge of JAX's index rule (-1, -Z-1, <= -Z-2, Z, > Z); on
     views whose start is 1-15 elements off a 16-byte boundary at ragged
     lengths, src, dst and an ``out=`` buffer offset alike and apart;
     a launch inside a side stream's context ordered on that stream;
     the transport-facing ``link_keep_mask_cuda`` equal to it (also at
     ragged lengths after a longer wave), its result writable and not
     aliased by the next call, and a partition between two calls (a new
     ``up_matrix``) changing exactly the cut link's frames;
  23. the geo path, with every count set to 0 first: the geo_lt twin
     (``bench/geo_lt.py``: WPaxos, 3 regions x 3-acceptor rows, 6
     groups, 3 clients, the arms home_zone, static_single_leader, steal,
     hot_objects and flat at the reference's sizes) on the dict and the
     cuda quorum backends, the cuda run's link mask on K18; the
     reference's gates on the dict run, the virtual-time gates on the
     cuda run, and the cuda run's acks, virtual latencies and replicas'
     group sequences EQUAL to the dict run's; K5 and K6 must have
     launched on its traffic, and K7 never (the grid universe is fixed);
  24. the storm twin (``bench/sim_core_ab.py``), on the same count: the
     reference's 1000-zone GeoStorm (bursts of 500, 60 rounds) on the
     jittered and the jitter-free topology, and a 32,768-frame FIFO
     backlog over the geo transport, each with the numpy mask and K18 in
     alternating blocks; delivery projections and sink counts identical
     across masks; the wave-size histograms; K18 must have launched on
     the geo path (phases 23-24);
  25. the sharded path, with every count set to 0 in each rank first:
     four ranks spawned on the card (built first; gloo, as they share
     one card -- NCCL refuses two ranks on one GPU), at the headline's
     full width (window 2^20, block 2^15) on the meshes (1, 4)
     majority-3, (1, 3) majority-3 (b_local 10923, one pad lane per
     block), (2, 2) 2x3 grid (whole rows per group shard: the fused row
     path) and (3, 1) 2x3 grid (rows straddle the shards: the psum'd
     matmul), each telemetry off and on: K19 ``shard_vote_count``, K20
     ``shard_commit`` and K21 ``shard_fold`` against their plain versions
     phase by phase for 3 drains and ``sharded_step`` against
     ``sharded_step_plain`` for 2 more and ``sharded_run`` against
     ``sharded_run_plain`` for a run of 8 (error 0); then 40 drains
     through ``make_sharded_step`` (the 32-block ring wraps) and, from a
     fresh state, 40 through ``make_sharded_runner`` in runs of 8 (one
     slot all-reduce and one K21 a run), the launch counts read (K21's
     equal to the runs), and each gathered state equal bit for bit to the
     unsharded drain's (K3, K14 with telemetry) after the same 40
     drains; then the per-drain split (K19, K20, K21 device time, the two
     all-reduces' host time) and a run's (host ms of a run of 8, its
     phases, its all-reduces); with two or more cards, the same on one
     rank per card over NCCL; then, in this process, K19 against
     ``shard_vote_count_plain`` and K20 against ``shard_commit_plain``
     (into random rows of the slot table) in every instantiated form
     (majorities of 1-16 acceptors, two groups over two acceptors, whole
     rows of three, write and read) and the generic template, telemetry
     off and on, on up to four ranks of each mesh, boards of arbitrary
     bytes, rings of 16, 1 and 2 blocks (and the four meshes at 2^20 /
     2^15), drains from 0 and across the int32 wrap; and K21's run fold
     against ``shard_fold_plain`` over 1, 8, 64 and 256 rows from drain
     0 and across the wrap, telemetry off and on (error 0);
  26. the sharded vote board's path (``bench/multichip_board.py``'s
     ``check_board``), on four ranks that share the card over gloo (and,
     with two or more cards, one rank per card over NCCL): first each
     kernel on every rank's shard against its plain version (K1; K2 on
     4096-wide blocks across the shard edges of the 2^20 window; K4 on
     256 straggler lanes, some outside the window; K5; K6 and K7 on the
     epoch board; the pinned K19-K21 copies phase by phase: error 0);
     then, with every count set to 0 in each rank, the ProxyLeader's
     tracker at its default window 2^20 with its board split over the
     mesh (``TpuQuorumTracker(mesh=)``), fed ``bench/tracker_lt.py``'s
     stream made on every rank: pipelined majority-3 over 2^20 slots on
     (1, 4), pipelined majority-3 and 2x3 grid over 2^18 slots on (2, 2),
     the synchronous tracker over 2^16 slots on (1, 4) -- every drain's
     reports equal to the unsharded port tracker's and the dict oracle's,
     and the gathered board equal to the unsharded board; then on (1, 4)
     ``EpochSegmentedChecker(mesh=)`` across a mid-window handover that
     grows the universe (window 2^14), ``GeoQuorumTracker(mesh=)`` on the
     ZoneGrid stream, ``union_reduce_sharded`` at [4096, 3, 64] and the
     pinned drain's mesh form (40 drains at 2^20 / 2^15, equal to the
     unsharded pinned K3 copy); K1, K2, K4-K7 and the pinned copies must
     each have launched; the per-drain host ms split into the
     all-reduces' and the kernels' time;
  27. the block sweep (``bench/block_sweep.py``): blocks 2^12-2^17 at
     window 2^20, one timed run each after a warm run (the reference's
     three cut to one), a short per-drain latency distribution, and the
     best block under the 50 us target;
  28. the host time of K18's and K12's wrappers and transport-facing
     entries, of the EPaxos / BPaxos decisions on K10 and K11 (the sims'
     own calls replayed), and of the WPaxos leaders' ``release`` and
     ``drain`` calls on ``GeoQuorumTracker`` (a geo_lt cuda run's calls
     replayed), whole and split by function under ``cProfile``
     (``bench/call_split.py``);
     per-kernel figures at the main paths' shapes: CUDA-event time per
     call over many calls (K12 and K18 in turns with their library call:
     kernel, library, library, kernel, six blocks of 400 calls each, the
     medians), the device time (the profiler's; for K3, K14 and the
     pinned copy, whose call is one launch of a run of 1024 drains, CUDA
     events around single launches, the median of 21), the plain
     version's time, the time of one PyTorch call that computes the same
     function where there is one (``torch.kthvalue`` for K12,
     ``up[src, dst]`` for K18), the two entries' host ms per call, the
     bound (bytes / 3.35 TB/s vs integer operations / 67 T/s, the
     larger; each input read once and each output written once, so a
     drain run's bytes are its state's, read and written once, with the
     reference's (5N+17)·B bytes a drain beside it as
     ``reference_bytes``) and the launches of phases 11, 12, 14, 16, 18,
     21, 23-24, 25, 26, 29 and 31 (K13's and K16 union's rows with the form
     they run; K3, K14 and the pinned copy with their drains
     beside their launches, each figure per drain too, and the device µs
     a drain of every form of phases 5 and 17), printed as one
     ``{"kernels": [...]}`` line; before it, each headline arm's timed
     run split into host and device time (CUDA events around the same
     run) and the share of it the device sat idle. The K1, K6 and K10
     rows also carry ``bench/launch_shapes.py``'s figures at the shapes
     the paths launch them (K1 at N = 3 and the synchronous tracker's
     buckets, with the staged entry's host time; K6 on one chunk and on
     a drain's run of 48 chunks, with the epoch checker's; K10 at the
     BPaxos Leader's [2, 2, W] and depset_lt's [4096, 3, 32], in seq mode
     at [4, 5, 8], K11 at [3, 5, 8]; K2 at the pipelined tracker's
     buckets 64-4096, 32768, the 2x3 grid, the sharded rank and a
     drain's run of three blocks; K5 at the leaders' 1-16 lanes, 256 and
     4096, both forms; K4 on a 256-lane chunk and runs of 1, 4 and 48,
     and a drain's board updates whole; K19-K21 at rank 0 of each
     sharded mesh, telemetry off and on, with K19's and K20's forms, and
     K21 folding runs of 1, 8, 64 and 256 drains), and the K10 / K11 rows the
     staged entries' error and each decision's host time. K8's row is
     the Leader's staged call at [2^13, 3] (the kernel reading and
     writing pinned host memory, so its bound is the bytes over the host
     link at 64 GB/s each way; its plain version takes the same numpy in
     and out), with the lean tensor wrapper at [2^16, 3] in device
     memory as its ``lean_wrapper`` figures;
  29. MultiPaxos over real loopback TCP
     (``protocols/multipaxos/supernode.py``), with every count set to 0
     first and the native wire codec loaded (else it fails): first, a
     checker built on this thread records one vote behind a long sleep
     queued on this thread's stream, then a TcpTransport's event-loop
     thread records a second vote for the same slot, which must choose
     it (the two threads' calls ordered on one stream); then f = 1 in
     ``deploy.py``'s ``cluster(1, ...)`` layout (2 leaders, 2 proxy
     leaders, 3 acceptors, 2 replicas on one TcpTransport; 4 clients on
     another), 2^12 closed-loop writes an arm (64 in flight a client),
     the Leaders on ``phase1_backend="cuda"``, the ProxyLeaders on the
     ``"dict"`` tracker, the ``"cuda"`` tracker synchronous and the
     ``"cuda"`` tracker pipelined (its collector thread); in every arm
     each write answered once with its AppendLog index, the replicas'
     executed logs equal and complete, no error and no collector error
     logged; each cuda arm's executed set equal to the dict arm's, K1
     launched on the synchronous arm's traffic and K2 on the pipelined
     arm's; writes/s and p50 / p99 write latency per arm; its launches
     join the kernels line's rows (path ``tcp_cluster``). The clients'
     frames reach the Leaders' wire sinks as columns, and the
     ProxyLeaders' batch frames of acks their ack-columns sink;
  30. the transport_lt twin (``bench/transport_lt.py``) at widths 16, 256
     and 1024, one rep: per_frame against batched against ingest (the
     wire sink's columns) cmds/s, syscalls/cmd, frames/cmd and
     bytes/drain; a lost or wrong reply or a logged error fails it; the
     reference's two gates printed, not enforced;
  31. the reconfigured MultiPaxos cluster (``bench/reconfig_sim.py``),
     with every count set to 0 first: f = 1, every acceptor and replica
     on a FileStorage WAL in a temporary directory (real fsyncs), the
     ProxyLeaders' main board at 2^20 and the epoch board at 2^14; 5
     writes, a replacement acceptor, acceptor 2 crashed, ``Reconfigure``,
     20 writes, acceptor 1 crashed, 5 writes, a failover whose leader
     must discover epoch 1 from the Phase1bs, 5 writes; a dict run and
     three arms on the card (the synchronous tracker, the pipelined one,
     ``epoch_quorums`` with ``epoch_tag_runs``): every write answered
     once and executed exactly once, both replicas' logs equal, the
     synchronous and epoch_quorums arms' logs equal to the dict run's,
     and K6 (the epoch tracker's staged drains) and K7 (epoch 1's
     reshape of the epoch board, [3, 2^14] -> [4, 2^14]) each launched
     in every arm; writes/s, K6's host µs a drain and the fsync ms per
     sync per arm; its launches join the kernels line's rows (path
     ``reconfig_cluster``);
  32. Fast Paxos and Fast MultiPaxos on K6's stateless check: first K6's
     stateless form against ``check_batch_multi_plain``, exact, at
     [1, 3] and [1, 5] (K = 1, the fast_flexible classic spec: every
     0/1 row through ``MultiCheck.check_word``, the staged one-row
     call), [256, 4] (K = 2, also with weighted masks) and [2^16, 5]
     (K = 3): through ``MultiCheck.check`` (0/1 rows, bools, weighted
     int32 rows, a Fortran-order strided view, config indices below,
     inside and past [0, K)) and the tensor wrapper on the card
     (contiguous and strided), with each shape's call, device, plain and
     bound figures; then Fast Paxos f = 1 on
     ``quorum_backend="cuda"`` (the fast path, a two-client conflict
     race, and random interleavings), its chosen values and replies
     equal to the ``"host"`` run of the same seed; then, with every count
     set to 0 first, ``bench/fast_sim.py``: f = 1 (3 acceptors, 2
     leaders) and f = 2 (5 acceptors, fast quorum 4), FAST_CLIENTS
     closed-loop clients, FAST_COMMANDS commands an arm on ``"host"``
     and ``"cuda"`` (every command answered once, every leader's log
     equal and complete, the cuda logs and replies equal the host run's,
     K6's stateless launches equal the cuda checks and above 0);
     commands/s and the median host µs a check per arm; its launches
     join the kernels line's rows (path ``fast_cluster``);
  33. Matchmaker MultiPaxos on K6's stateless check: first K6's stateless
     form against ``check_batch_multi_plain``, exact, at the leader's
     phase-1 shapes [K, N] = [1, 6], [3, 6], [2, 10] and [4, 10]
     (``launch_shapes.matchmaker_specs``: the read specs of
     SimpleMajority, Grid and UnanimousWrites reindexed over the pool),
     and at [8, 10] and [3, 40], whose planes the staged calls read from
     the card, for every responder set of the pool (512 random ones over
     40), through
     ``MultiConfigQuorumChecker.check_all`` (one word under every plane,
     one staged call) and ``check_batch`` of the K equal rows (the
     reference's body), each shape's call (in turns), device, plain and
     bound figures; then, with every count set to 0 first,
     ``bench/matchmaker_sim.py`` at f = 1 (6 acceptors, 3 matchmakers)
     and f = 2 (10 acceptors, 5 matchmakers), MATCHMAKER_WRITES writes
     an arm on ``"dict"`` and ``"cuda"`` through repeated acceptor
     reconfigurations and a matchmaker epoch change (every write
     answered once, the replicas' logs equal, the cuda logs and replies
     equal the dict run's, K6's stateless launches equal the cuda
     phase-1 checks and above 0); writes/s, the host µs a check and the
     checker set-up µs a phase 1 per arm; its launches join the kernels
     line's rows (path ``mmp_cluster``);
  34. the ingest fabric and admission over TCP on the card, with every
     count set to 0 first: phase 29's supernode and arms with
     INGEST_BATCHERS ingest batchers in front of the leaders (the
     clients on their consistent ring) and the Leaders'
     ``admission_inflight_limit`` at half the writes in flight
     (INGEST_INFLIGHT_LIMIT); the clients retry without limit on their
     default backoff. In every arm phase 29's checks (each write
     answered once with its AppendLog index, the replicas' logs equal
     and complete, no error and no collector error), and Rejected > 0,
     IngestRuns received by the leaders > 0 and vote-ack rows through
     the ProxyLeaders' wire sink > 0; each cuda arm's executed set
     equal to the dict arm's and K1 / K2 launched on its traffic;
     writes/s, p50 / p99, the Rejected count, the ack rows by sink
     against per message, and K1 / K2 launches a write beside phase
     29's; its launches join the kernels line's rows (path
     ``ingest_tcp``);
  35. MultiPaxos with read batchers on the card
     (``bench/read_batch_sim.py``), with every count set to 0 first: the
     harness's f = 1 over SimTransport with 2 read batchers, 2 clients x
     32 pseudonyms, a KeyValueStore over 8 keys, 2^10 operations an arm
     in waves (writes and linearizable reads, and under ``size`` and
     ``time`` also sequential and eventual reads), under the ``size``
     (batch size 10), ``time`` and ``adaptive`` schemes, each on the
     ProxyLeaders' ``"dict"`` tracker and the ``"cuda"`` tracker
     synchronous and pipelined: every operation answered once, every
     linearizable read at least as new as the writes acknowledged before
     it was issued, the replicas' logs equal, the cuda arms' logs and
     read replies equal the dict arm's, K1 launched on the synchronous
     arms and K2 on the pipelined ones; reads/s, writes/s and reads per
     BatchMaxSlotRequest batch per arm; its launches join the kernels
     line's rows (path ``read_batch_cluster``);
  36. MultiPaxos over TCP traced (``bench/traced_tcp.py``), with every
     count set to 0 first: phase 29's supernode and arms at 2^10 writes
     an arm, both transports with a ``Tracer`` at sample rate 1.0, a
     flight-recorder ring and a ``.trace.jsonl`` sink each in a
     temporary directory: phase 29's checks, spans recorded, one
     ``stage:quorum-kernel`` span under every ProxyLeader drain span and
     at least one per tracker drain that called the card, a write's
     causal chain from its client through a ProxyLeader's quorum-kernel
     stage to the reply back at the client, ``to_chrome_trace`` JSON that
     loads,
     every flight ring read back, each cuda arm's executed set equal to
     the dict arm's and K1 / K2 launched on its traffic; writes/s
     against phase 29's and the per-stage latency breakdown (p50 / p99)
     per arm; its launches join the kernels line's rows (path
     ``traced_tcp``).

The last line is ``{"ok": true, "device": {...}}``.
"""

import itertools
import json
import os
import random
import re
import statistics
import sys
import time
import warnings

import frankenpaxos_tpu_torch
from frankenpaxos_tpu_torch import native
from frankenpaxos_tpu_torch.bench import (
    block_sweep,
    bpaxos_sim,
    call_split,
    depset_lt,
    epaxos_sim,
    fast_sim,
    geo_lt,
    headline,
    launch_shapes,
    libbench,
    matchmaker_sim,
    multichip,
    multichip_board,
    multipaxos_sim,
    pipeline as tp,
    pipeline_baseline as tpin,
    read_batch_sim,
    reconfig_sim,
    sim_core_ab,
    telemetry_overhead,
    traced_tcp,
    tracker_lt,
    transport_lt,
)
from frankenpaxos_tpu_torch.device import nvidia_smi_line
from frankenpaxos_tpu_torch.geo import GeoTopology
from frankenpaxos_tpu_torch.mesh import Mesh
from frankenpaxos_tpu_torch.obs import telemetry as tobs
from frankenpaxos_tpu_torch.ops import (
    _build,
    depset as td,
    quorum as tq,
    simwave as tsw,
    value as tv,
    watermark as tw,
)
from frankenpaxos_tpu_torch.protocols import fast_harness
from frankenpaxos_tpu_torch.protocols.multipaxos import (
    quorum_tracker as qt,
    supernode,
)
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority, ZoneGrid
from frankenpaxos_tpu_torch.quorums.spec import ALL, ANY, pad_specs, QuorumSpec
from frankenpaxos_tpu_torch.runs.quorums import fast_flexible_specs
from frankenpaxos_tpu_torch.runtime import FakeLogger
from frankenpaxos_tpu_torch.runtime.tcp_transport import TcpTransport
import numpy as np
import torch

WINDOW = 1 << 20
BLOCK = 1 << 15
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
#: H100 SXM host link, PCIe Gen5 x16: 64 GB/s each way (NVIDIA's data
#: sheet: 128 GB/s both ways), for a kernel that reads pinned host memory.
PCIE_BYTES_PER_S = 64e9
INT_OPS_PER_S = 67e12       # H100 non-tensor float32 peak, used for int ops
SEED = 20261017
#: Slice 3's steady and failover arms, cut from the bench's 2^16 writes
#: so that the whole smoke stays near its earlier time with the EPaxos
#: path added (depth only: the cluster's width is the bench's).
CLUSTER_WRITES = 1 << 13
#: The BPaxos arms' commands, cut from the bench's 2^14 (depth only).
BPAXOS_COMMANDS = 1 << 13
#: When the smoke started (``phase``'s clock).
T0 = time.perf_counter()


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(n: int, msg: str) -> None:
    """Phase ``n``'s line, with the seconds since the smoke started."""
    log(f"[{n}/36] {msg} (at {time.perf_counter() - T0:.1f} s)")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def specs() -> dict:
    return {
        "majority3": SimpleMajority(range(3)).write_spec(),
        "majority5": SimpleMajority(range(5)).write_spec(),
        "grid2x3_write": Grid([[0, 1, 2], [3, 4, 5]]).write_spec(),
        "grid_perm_write": Grid([[0, 2, 4], [1, 3, 5]]).write_spec(),
        "grid2x3_read": Grid([[0, 1, 2], [3, 4, 5]]).read_spec(),
    }


def predicate(spec, dev):
    return tq.make_predicate(*spec.as_arrays(), device=dev)


#: K1's widths: one column, around one and four 16-column vectors, the
#: tracker's smallest and largest buckets, the main path's block, and a
#: ragged width.
K1_WIDTHS = (1, 15, 16, 63, 64, 1007, 4096, BLOCK)


def k1_predicates() -> dict:
    """Every form of K1, by name: ``(masks, thresholds, combine_any)``.
    Majorities of 1-16 acceptors (the one-group register forms) and 17
    (the runtime loop), groups (two overlapping, any and all; none; a
    weighted group), and the grids: 2x3, 3x3 and permuted 2x3, write and
    read, 3x1 (rows of one), WPaxos's zone grid (three groups)."""
    out = {}
    for n in range(1, 18):
        spec = SimpleMajority(range(n)).write_spec()
        out[f"majority{n}"] = spec.as_arrays()
    grids = {"2x3": [[0, 1, 2], [3, 4, 5]],
             "3x3": [[0, 1, 2], [3, 4, 5], [6, 7, 8]],
             "perm2x3": [[0, 2, 4], [1, 3, 5]],
             "3x1": [[0], [1], [2]]}
    for name, rows in grids.items():
        out[f"grid{name}_write"] = Grid(rows).write_spec().as_arrays()
        out[f"grid{name}_read"] = Grid(rows).read_spec().as_arrays()
    out["zonegrid3x3"] = ZoneGrid(grids["3x3"]).write_spec().as_arrays()
    two = np.array([[1, 1, 1, 0, 0], [0, 0, 1, 1, 1]])
    out["groups2_all"] = (two, np.array([2, 2]), False)
    out["groups2_any"] = (two, np.array([3, 2]), True)
    out["groups0_all"] = (np.zeros((0, 3), np.int32), np.zeros(0), False)
    out["groups0_any"] = (np.zeros((0, 3), np.int32), np.zeros(0), True)
    out["weighted"] = (np.array([[2, 1, 1, 1]]), np.array([3]), False)
    return out


def _k1_views(votes: torch.Tensor, rng) -> dict:
    """The layouts K1 reads, each a view of ``votes`` [N, B] (equal
    values): contiguous; transposed (check_batch's [B, N] rows); offset
    1, 7 and 15 bytes off a 16-byte boundary with aligned rows (a head of
    scalar columns, then vectors, then a tail); and rows whose stride is
    not a multiple of 16 (every column scalar)."""
    n, b = votes.shape
    out = {"contiguous": votes, "transposed": votes.t().contiguous().t()}
    for off in (1, 7, 15):
        width = (b + off + 31) // 16 * 16
        big = torch.from_numpy(rng.integers(0, 256, (n, width),
                                            dtype=np.uint8)).to(votes.device)
        big[:, off:off + b] = votes
        out[f"offset{off}"] = big[:, off:off + b]
    big = torch.zeros((n, b + 3), dtype=torch.uint8, device=votes.device)
    big[:, :b] = votes
    out["stride+3"] = big[:, :b]
    return out


def phase_k1(dev, rng) -> int:
    """K1 against its plain version, exact: every form of
    ``k1_predicates`` at every width of ``K1_WIDTHS``, on 0/1 votes and on
    arbitrary bytes, in every layout of ``_k1_views``; then the staged
    entry (``TpuQuorumChecker.check_block``, and several segments side by
    side through ``stage_block`` / ``check_staged``) against a checker on
    the CPU."""
    worst = 0
    for name, (masks, thresholds, any_) in k1_predicates().items():
        pred = tq.make_predicate(masks, thresholds, any_, device=dev)
        n = pred.num_nodes
        for b in K1_WIDTHS:
            for kind in ("0/1", "bytes"):
                blk = (rng.random((n, b)) < 0.5).astype(np.uint8) \
                    if kind == "0/1" \
                    else rng.integers(0, 256, (n, b), dtype=np.uint8)
                votes = torch.from_numpy(blk).to(dev)
                for layout, view in _k1_views(votes, rng).items():
                    got = tq.quorum_hit(view, pred)
                    want = tq.quorum_hit_plain(view, pred)
                    err = max_abs_err(got, want)
                    worst = max(worst, err)
                    require(err == 0, f"K1 differs from plain on {name} "
                                      f"B={b} {kind} {layout}")
    for name in ("majority3", "grid2x3_write", "grid3x3_read",
                 "zonegrid3x3", "majority17"):
        masks, thresholds, any_ = k1_predicates()[name]
        spec = QuorumSpec(masks, thresholds, ANY if any_ else ALL,
                          tuple(range(masks.shape[1])))
        on_card = tq.TpuQuorumChecker(spec, window=1 << 12, device=dev)
        on_host = tq.TpuQuorumChecker(spec, window=1 << 12, device="cpu")
        for b in (1, 63, 64, 1007, 4096):
            blk = rng.integers(0, 3, (spec.num_nodes, b), dtype=np.uint8)
            err = int((on_card.check_block(blk)
                       != on_host.check_block(blk)).sum())
            worst = max(worst, err)
            require(err == 0, f"K1's staged entry differs on {name} B={b}")
        # The synchronous tracker's form: segments of 64, 4096 and 1024
        # columns side by side in one staged block, one call.
        total = 64 + 4096 + 1024
        blk = rng.integers(0, 2, (spec.num_nodes, total), dtype=np.uint8)
        for checker in (on_card, on_host):
            checker.stage_block(total)[...] = blk
        got = on_card.check_staged(total).copy()
        err = int((got != on_host.check_staged(total)).sum())
        worst = max(worst, err)
        require(err == 0, f"K1's staged segments differ on {name}")
    torch.cuda.synchronize(dev)
    return worst


def _boards_equal(a: tq.VoteBoard, b: tq.VoteBoard) -> int:
    return max(max_abs_err(x, y) for x, y in zip(a, b))


def phase_k2(dev, rng) -> int:
    worst = 0
    for name in ("majority3", "grid2x3_write"):
        spec = specs()[name]
        n = spec.num_nodes
        checker = tq.TpuQuorumChecker(spec, window=WINDOW, device=dev)
        plain = tq.make_vote_board(WINDOW, n, device=dev)
        pred = predicate(spec, dev)
        frontier = 0
        kinds = {"wrap": 0, "preempt": 0, "stale": 0}
        for step in range(32):
            vote_round = 1
            if step % 4 == 1:          # same range, a newer round
                start_slot = frontier
                vote_round = 2 + step
                kinds["preempt"] += 1
            elif step % 4 == 3 and frontier >= WINDOW:
                start_slot = frontier - WINDOW  # the column moved past it
                kinds["stale"] += 1
            else:
                frontier += int(rng.integers(1, 9)) * BLOCK \
                    + int(rng.integers(0, BLOCK))
                frontier -= max(0, frontier % WINDOW + BLOCK - WINDOW)
                start_slot = frontier
                kinds["wrap"] += frontier >= WINDOW
            if step % 5 == 4:
                blk = rng.integers(0, 256, (n, BLOCK), dtype=np.uint8)
            else:
                blk = (rng.random((n, BLOCK)) < 0.6).astype(np.uint8)
            with warnings.catch_warnings():  # the stale calls warn
                warnings.simplefilter("ignore", RuntimeWarning)
                newly = checker.record_block_async(start_slot, blk,
                                                   vote_round)
            want = tq.record_block_plain(
                plain, start_slot % WINDOW, start_slot,
                torch.from_numpy(blk).to(dev), vote_round, pred)
            err = max(max_abs_err(newly, want),
                      _boards_equal(checker.board, plain))
            worst = max(worst, err)
            require(err == 0, f"K2 differs from plain on {name} at call "
                              f"{step}")
        require(all(kinds.values()), f"K2 sequence lacks a case: {kinds}")
    torch.cuda.synchronize(dev)
    return max(worst, _k2_runs(dev, rng))


#: K2's run form: block widths (one column, around one and four 16-column
#: vectors, the pipelined tracker's buckets, ragged ones) on a 2^16-column
#: ring, and the runs a form is held on.
K2_RUN_WIDTHS = (1, 15, 16, 17, 63, 64, 200, 256, 1007, 1024, 4096)
K2_RUN_WINDOW = 1 << 16
K2_RUNS = 6


def _k2_run_blocks(rng, window: int, step: int) -> tuple:
    """One run's ``(columns, true starts, widths, rounds)``: 1-9 blocks at
    columns off the 16-byte grid, the last one at the ring end on even
    steps; slot numbers small (owners on a random board go stale), large,
    or crossing 2^31 - 1 inside a block (the int32 wrap), by step; and on
    odd steps a block repeated over the first one's columns in a newer
    round (the table starts another launch)."""
    nb = int(rng.integers(1, 10))
    kind = step % 3
    cols, trues, widths = [], [], []
    at = int(rng.integers(0, window // 2))
    for k in range(nb):
        width = int(rng.choice(K2_RUN_WIDTHS))
        col = at + int(rng.integers(0, 40))
        if col + width > window or (k == nb - 1 and step % 2 == 0):
            col = window - width
        true = (col + int(rng.integers(0, 2)) * window if kind == 0
                else col + window * int(rng.integers(2, 2**30 // window))
                if kind == 1 else 2**31 - 1 - width // 2)
        cols.append(col)
        trues.append(true)
        widths.append(width)
        at = col + width
    rounds = [int(r) for r in rng.integers(0, 3, size=nb)]
    if step % 2 and nb > 1:
        cols.append(cols[0])
        trues.append(trues[0])
        widths.append(widths[0])
        rounds.append(rounds[0] + 1)
    return cols, trues, widths, rounds


def _k2_runs(dev, rng) -> int:
    """K2's run entry (``record_block_run``, one launch, more where the
    table starts one) against ``record_block_run_plain`` on the card,
    exact, in every form of ``k1_predicates`` (majorities of 1-16
    acceptors and 17, groups, grids, the zone grid): ``K2_RUNS`` runs a
    form on random mid-flight boards (claims, stale owners, preemption),
    vote bytes 0/1 and 0-255, unaligned starts, the ring end, the int32
    wrap and overlapping blocks; then the checker's staged run
    (``dense_run``) against a checker on the CPU, with releases held
    before it and a K4 call between runs. Returns the largest error."""
    worst = 0
    window = K2_RUN_WINDOW
    overlaps = wraps = ends = 0
    for name, arrays in k1_predicates().items():
        n = np.asarray(arrays[0]).shape[1]
        pred = tq.make_predicate(*arrays, device=dev)
        board_k, board_p = _random_board(rng, n, window, dev)
        for step in range(K2_RUNS):
            cols, trues, widths, rounds = _k2_run_blocks(rng, window, step)
            table, stride = tq.run_table(cols, widths, rounds, window, trues)
            bytes_ = step % 3 == 1
            blocks = torch.from_numpy(
                rng.integers(0, 256, (n, stride), dtype=np.uint8) if bytes_
                else (rng.random((n, stride)) < 0.6).astype(np.uint8)
            ).to(dev)
            got = tq.record_block_run(board_k, table, blocks, pred)
            want = tq.record_block_run_plain(board_p, table, blocks, pred)
            overlaps += int(table[1:, 5].sum()) if len(table) > 1 else 0
            wraps += int(any(t + w > 2**31 for t, w in zip(trues, widths)))
            ends += int(((table[:, 0] + table[:, 2]) == window).any())
            err = max(max_abs_err(got, want), _boards_equal(board_k, board_p))
            worst = max(worst, err)
            require(err == 0, f"K2's run differs from plain on {name} at "
                              f"run {step}")
    require(overlaps and wraps and ends,
            f"K2's runs lack a case: {overlaps} overlaps, {wraps} wraps, "
            f"{ends} ring ends")
    # The staged run: a card checker against a CPU one, releases held
    # ahead of the run, a K4 call (which flushes them) between runs.
    for name in ("majority3", "grid2x3_write", "grid_perm_write"):
        spec = specs()[name]
        card = tq.TpuQuorumChecker(spec, window=window, device=dev)
        host = tq.TpuQuorumChecker(spec, window=window, device="cpu")
        frontier = 5000
        for step in range(8):
            spans = []
            at = frontier
            for _ in range(int(rng.integers(1, 5))):
                width = int(rng.choice((64, 256, 1024, 4096)))
                spans.append((at, width, int(rng.integers(0, 2))))
                at += width + int(rng.integers(0, 30))
            fills = [(rng.random((spec.num_nodes, w)) < 0.6).astype(
                np.uint8) for _, w, _ in spans]
            released = np.arange(frontier - 3000, frontier - 2000)
            cut = (int(rng.integers(1, 1000)), int(rng.integers(1, 50)))
            for c in (card, host):
                c.release(released[:cut[0]])
                c.release(released[-cut[1]:])
            results = []
            for c in (card, host):
                run = c.dense_run(spans)
                for (s, w, _), fill, off in zip(spans, fills, run.offsets):
                    run.block[:, off:off + w] = fill
                res = run.dispatch()
                results.append([res.wait()[o:o + w].copy()
                                for o, (_, w, _) in zip(run.offsets, spans)])
                res.free()
            err = max(int((a != b).sum()) for a, b in zip(*results))
            if step % 3 == 2:  # a K4 call behind held releases
                for c in (card, host):
                    c.release(np.arange(frontier, frontier + 64))
                lanes = [frontier + np.arange(64), np.zeros(64, np.int32)]
                got = card.record_and_check(*lanes)
                want = host.record_and_check(*lanes)
                err = max(err, int((got != want).sum()))
            err = max(err, _boards_equal(card.board, tq.VoteBoard(
                *(t.to(dev) for t in host.board))))
            worst = max(worst, err)
            require(err == 0, f"K2's staged run differs from the CPU "
                              f"checker on {name} at drain {step}")
            frontier = at
    torch.cuda.synchronize(dev)
    return worst


#: K5's all-valid form: widths around one thread's four lanes, the
#: leaders' few slots, and the prewarm's 4096.
K5_ALL_WIDTHS = (1, 3, 4, 5, 16, 17, 256, 4096)


def _k5_all(dev, rng) -> int:
    """K5's all-valid form (``release_all``) against
    ``release_all_plain``: every width of ``K5_ALL_WIDTHS`` on slots with
    duplicates, negatives and ones out of range, from an aligned and an
    unaligned (one element in) slot array; then the held releases of a
    card checker against a CPU one: a release before a vote for slot +
    window in the next call, before K4, before a reshape, several before
    one call, and ``flush_releases``, boards compared after each."""
    worst = 0
    board_k, board_p = _random_board(rng, 3, WINDOW, dev)
    for width in K5_ALL_WIDTHS:
        for offset in (0, 1):
            slots = rng.integers(-WINDOW - 8, WINDOW + 8,
                                 size=width + offset).astype(np.int32)
            slots[offset + width // 2:] = slots[offset]
            s = torch.from_numpy(slots).to(dev)[offset:]
            tq.release_all(board_k, s)
            tq.release_all_plain(board_p, s)
            err = _boards_equal(board_k, board_p)
            worst = max(worst, err)
            require(err == 0, f"K5's all-valid form differs at {width} "
                              f"lanes, offset {offset}")
    spec = specs()["majority3"]
    window = 1 << 12
    card = tq.TpuQuorumChecker(spec, window=window, device=dev)
    host = tq.TpuQuorumChecker(spec, window=window, device="cpu")

    def both(what, fn):
        nonlocal worst
        got = [fn(c) for c in (card, host)]
        err = 0
        if got[0] is not None:
            err = int((np.asarray(got[0]) != np.asarray(got[1])).sum())
        err = max(err, _boards_equal(card.board, tq.VoteBoard(
            *(t.to(dev) for t in host.board))))
        worst = max(worst, err)
        require(err == 0, f"held releases differ from the CPU: {what}")

    block = np.ones((3, 64), np.uint8)
    both("record", lambda c: c.record_block(100, block))
    both("release, then slot + window", lambda c: (
        c.release(np.arange(100, 164)),
        c.record_block(100 + window, block))[1])
    both("release, then K4", lambda c: (
        c.release(np.arange(100 + window, 130 + window)),
        c.record_and_check(np.arange(110 + window, 140 + window),
                           np.ones(30, np.int32)))[1])
    both("several releases, then K2", lambda c: (
        c.release([130 + window]), c.release(np.arange(150, 160) + window),
        c.release(np.arange(140, 150) + window),
        c.record_block(130 + window, block))[3])
    both("release, then reshape", lambda c: (
        c.release(np.arange(100, 200) + window),
        c.reshape(SimpleMajority(range(4)).write_spec()))[1])
    both("release, then flush_releases", lambda c: (
        c.release(np.arange(0, window, 7)), c.flush_releases())[1])
    torch.cuda.synchronize(dev)
    return worst


#: Phase 5's runs of the chunked drain kernel at the full width, per spec
#: and first drain, each sequence run one chunk after another (each
#: resumes the one before): from 2^31 - 70 the 128- and the 4096-drain
#: runs cross the int32 wrap inside one launch, and majority-3's
#: 32768-drain run resumes past it. The plain loop takes about 1.4 ms a
#: drain on the card, so the longest run is held on one spec.
DRAIN_CHUNKS = {
    "majority3": {0: (1, 2, 3, 64, 4096),
                  2**31 - 70: (1, 2, 3, 128, 4096, 32768)},
    "grid2x3_write": {0: (1, 2, 3, 64, 4096), 2**31 - 70: (1, 2, 3, 4096)},
}
#: The three drain kernels, by the name of their row in the kernels line.
DRAIN_KERNELS = ("steady_state_step", "steady_state_step_telemetry",
                 "steady_state_step_baseline")


def _fields_err(a, b) -> int:
    """Largest difference over the seven drain fields of two states."""
    return max(max_abs_err(x, y) for x, y in zip(a[:7], b[:7]))


def _drain_states(window: int, n: int, dev) -> tuple:
    """Fresh states for K3, K14, the pinned copy and the plain drain (the
    plain one carries the counters, so that one plain loop holds all
    three kernels)."""
    return (tp.make_state(window, n, device=dev),
            tp.make_state(window, n, telemetry=True, device=dev),
            tpin.make_state(window, n, device=dev),
            tp.make_state(window, n, telemetry=True, device=dev))


def _run_chunks(states, arrays, pred, first: int, chunks, where: str,
                worst: dict) -> int:
    """Runs ``chunks`` one after another from drain ``first`` through K3,
    K14 and the pinned copy (one launch a chunk each) and drain by drain
    through the plain version; after every chunk every field of K3 and
    K14 and every counter of K14 must equal the plain version's, and the
    pinned copy must equal K3 bit for bit. Returns the drains run."""
    k3, k14, pinned, plain = states
    at = first
    for chunk in chunks:
        tp.run_steps_from(k3, at, chunk, BLOCK, *arrays)
        tp.run_steps_from(k14, at, chunk, BLOCK, *arrays)
        tpin.run_steps_from(pinned, at, chunk, BLOCK, *arrays)
        for k in range(chunk):
            tp.steady_state_step_plain(plain, tp._wrap32(at + k), BLOCK, pred)
        errs = {"steady_state_step": _fields_err(k3, plain),
                "steady_state_step_telemetry": max(
                    _fields_err(k14, plain),
                    max_abs_err(k14.telemetry.buffer,
                                plain.telemetry.buffer)),
                "steady_state_step_baseline": _fields_err(pinned, k3)}
        for kernel, err in errs.items():
            worst[kernel] = max(worst[kernel], err)
            require(err == 0, f"{kernel} differs on {where}, the "
                              f"{chunk}-drain run from drain {at}: error "
                              f"{err}")
        at = tp._wrap32(at + chunk)
    return sum(chunks)


def phase_k3(dev) -> dict:
    """K3, K14 and the pinned copy, one launch a run, against the plain
    drain loop at the full width: the runs of ``DRAIN_CHUNKS``,
    majority-3 and the 2x3 grid."""
    worst = dict.fromkeys(DRAIN_KERNELS, 0)
    for name, runs in DRAIN_CHUNKS.items():
        spec = specs()[name]
        arrays = headline.spec_arrays(spec)
        for first, chunks in runs.items():
            states = _drain_states(WINDOW, spec.num_nodes, dev)
            drains = _run_chunks(states, arrays,
                                 tp.predicate_for(*arrays, dev), first,
                                 chunks, f"{name} W={WINDOW}", worst)
            committed = int(states[0].committed)
            require(committed > (drains - 4) * BLOCK,
                    f"K3 {name} committed only {committed} in {drains} "
                    f"drains")
    torch.cuda.synchronize(dev)
    return worst


def _random_board(rng, n: int, window: int, dev) -> tuple:
    """Two equal mid-flight boards (kernel's, plain version's) with
    arbitrary vote bytes, rounds, chosen bits and owners."""
    arrays = (rng.integers(0, 3, size=(n, window), dtype=np.uint8),
              rng.integers(-1, 4, size=window).astype(np.int32),
              rng.random(window) < 0.2,
              rng.integers(-1, 2 * window, size=window).astype(np.int32))
    return tuple(tq.VoteBoard(*(torch.from_numpy(a.copy()).to(dev)
                                for a in arrays)) for _ in range(2))


def _sparse_lanes(rng, window: int, n: int, frontier: int, b: int,
                  kinds: dict) -> np.ndarray:
    """One batch of ``b`` lanes: duplicate slots, stragglers a window or
    more behind the frontier (stale owners), newer slots a window ahead
    (ring wrap, reclaim), rounds 0-3 (preemption), a few nodes outside
    ``[0, n)``, a few slots outside ``[0, window)`` (JAX's index rules)
    and padding lanes (slot 0, not valid) at the end."""
    true = frontier - rng.integers(0, 4 * b, size=b)
    jump = rng.choice([0, 0, 0, 0, window, -window], size=b)
    true = np.maximum(true + jump, 0)
    true[rng.integers(0, b, size=b // 4)] = true[0]
    nodes = rng.integers(0, n, size=b)
    odd = rng.random(b) < 0.02
    nodes[odd] = rng.integers(-n - 1, n + 1, size=int(odd.sum()))
    rounds = rng.integers(0, 4, size=b)
    valid = np.ones(b, dtype=bool)
    pad = int(rng.integers(0, b // 8 + 1))
    if pad:
        valid[-pad:] = False
        true[-pad:] = 0
    slots = true % window
    far = (rng.random(b) < 0.01) & valid
    slots[far] += rng.choice([-2, -1, 1], size=int(far.sum())) * window
    kinds["dup"] += int(len(np.unique(true[valid])) < int(valid.sum()))
    kinds["stale"] += int((jump < 0).any())
    kinds["wrap"] += int((true >= window).any())
    kinds["pad"] += int(pad > 0)
    kinds["preempt"] += int((rounds > 0).any())
    kinds["range"] += int(far.any())
    return tq.pack_lanes(slots, true, nodes, rounds, valid)


def phase_k4(dev, rng) -> int:
    """K4 against its plain version: window 2^20, 64 calls of 64-4096
    lanes per spec; newly masks and boards equal after every call."""
    worst = 0
    for name in ("majority3", "grid2x3_write"):
        spec = specs()[name]
        n = spec.num_nodes
        pred = predicate(spec, dev)
        board_k, board_p = _random_board(rng, n, WINDOW, dev)
        kinds = dict.fromkeys(("dup", "stale", "wrap", "pad", "preempt",
                               "range"), 0)
        frontier = WINDOW // 2
        for step in range(64):
            b = int(rng.integers(64, 4097))
            frontier += int(rng.integers(0, 2 * b))
            lanes = torch.from_numpy(_sparse_lanes(
                rng, WINDOW, n, frontier, b, kinds)).to(dev)
            got = tq.record_and_check(board_k, lanes, pred)
            want = tq.record_and_check_plain(board_p, lanes, pred)
            err = max(max_abs_err(got, want), _boards_equal(board_k, board_p))
            worst = max(worst, err)
            require(err == 0, f"K4 differs from plain on {name} at call "
                              f"{step}")
        require(all(kinds.values()), f"K4 sequence lacks a case: {kinds}")
    torch.cuda.synchronize(dev)
    return worst


#: K4's runs in phase 6: 1, 4 and 48 chunks of 1-256 lanes (the tracker's
#: chunk is at most 256), one launch a run.
K4_RUNS = (1, 4, 48)


def _k4_runs(dev, rng) -> int:
    """K4's run (``record_and_check_run``, one launch a run) against
    ``record_and_check_run_plain`` in every form of phase 3's predicates,
    on a mid-flight 2^20 board: runs of 1, 4 and 48 chunks of 1-256
    lanes with duplicates inside and across chunks, stale owners, ring
    wrap, preemption, slots and nodes out of range, pad lanes and a
    chunk of true slots across 2^31 - 1; newly and the board equal after
    every run."""
    worst = 0
    for name, (masks, thresholds, any_) in k1_predicates().items():
        pred = tq.make_predicate(masks, thresholds, any_, device=dev)
        n = pred.num_nodes
        board_k, board_p = _random_board(rng, n, WINDOW, dev)
        kinds = dict.fromkeys(("dup", "stale", "wrap", "pad", "preempt",
                               "range"), 0)
        frontier = WINDOW // 2
        for chunks in K4_RUNS:
            sizes = rng.integers(1, 257, size=chunks)
            sizes[0] = 256
            parts = []
            for b in sizes.tolist():
                frontier += int(rng.integers(0, 2 * b))
                parts.append(_sparse_lanes(rng, WINDOW, n, frontier, b,
                                           kinds))
            # One chunk of true slots across 2^31 - 1 (they wrap to int32).
            b = int(sizes[-1])
            true = 2**31 - 1 - b // 2 + rng.integers(0, b, size=b)
            parts[-1] = tq.pack_lanes(true % WINDOW, true,
                                      rng.integers(0, n, size=b),
                                      rng.integers(0, 4, size=b),
                                      np.ones(b, bool))
            lanes = torch.from_numpy(np.concatenate(parts, axis=1)).to(dev)
            bounds = tq.chunk_bounds(sizes.tolist())
            got = tq.record_and_check_run(board_k, lanes, bounds, pred)
            want = tq.record_and_check_run_plain(board_p, lanes, bounds,
                                                 pred)
            err = max(max_abs_err(got, want), _boards_equal(board_k, board_p))
            worst = max(worst, err)
            require(err == 0, f"K4's run differs from plain on {name} at "
                              f"{chunks} chunks")
        require(all(kinds.values()), f"K4 runs lack a case: {kinds}")
    torch.cuda.synchronize(dev)
    return worst


class _Counted:
    """Counts the calls of a staged C entry (``tq._BOARD_STAGED`` and
    ``tq._K2_STAGED``) while it is in place."""

    def __init__(self, entries: dict):
        self.entries, self.calls, self.fns = entries, {}, {}

    def __enter__(self):
        for key, entry in self.entries.items():
            fn = entry.fn or entry.resolve()
            self.fns[key], self.calls[key] = fn, 0

            def counted(block, fn=fn, key=key):
                self.calls[key] += 1
                return fn(block)
            entry.fn = counted
        return self

    def __exit__(self, *exc):
        for key, entry in self.entries.items():
            entry.fn = self.fns[key]


#: Phase 6's pipelined drains: tracker_lt's mixed stream (every kind of
#: scatter part, ring-end remainders) and the first 2^16 slots of its
#: stream at the ProxyLeader's window.
K4_DRAIN_SLOTS = 1 << 16


def _k4_drains(dev) -> tuple[int, dict]:
    """The pipelined tracker on the card (each drain ONE staged call:
    ``fpx_board_run_staged``, or K2's run where a drain has no chunk)
    against the same tracker on the CPU: per drain the same reports, the
    boards equal after the stream (error 0). With the counts set to 0
    after the trackers' prewarm: every drain one staged call, and at most
    one K4 launch a sparse segment."""
    config = tracker_lt.make_config()
    worst, out = 0, {}
    for name, stream, window in (
            ("mixed", tracker_lt.make_mixed_stream(SEED % 997),
             tracker_lt.MIXED_WINDOW),
            ("tracker_lt", tracker_lt.make_stream(K4_DRAIN_SLOTS, 3),
             WINDOW)):
        card, host = (qt.TpuQuorumTracker(config, window=window,
                                          pipelined=True, device=d)
                      for d in (dev, "cpu"))
        torch.cuda.synchronize(dev)
        reset_launches()
        segments = chunks = dispatches = 0
        with _Counted({"board": tq._BOARD_STAGED,
                       "k2": tq._K2_STAGED}) as counted:
            for d, events in enumerate(stream):
                got, want = [], []
                for t, out_ in ((card, got), (host, want)):
                    tracker_lt.replay(t, [events], 3)
                    while (x := t.take_dispatch()) is not None:
                        if t is card:
                            dispatches += 1
                            shape = [i[0] for _, items, _ in x
                                     for i in items]
                            chunks += shape.count("votes")
                            segments += sum(
                                1 for k, kind in enumerate(shape)
                                if kind == "votes"
                                and (k == 0 or shape[k - 1] != "votes"))
                        out_.extend(t.collect(x))
                require(got == want, f"the staged drain differs from a CPU "
                                     f"tracker on {name} at drain {d}")
                require(sum(counted.calls.values()) == dispatches,
                        f"{name}: drain {d} was not one staged call")
        k4 = tq.record_and_check.launches
        require(k4 <= segments, f"{name}: {k4} K4 launches for {segments} "
                                f"sparse segments")
        err = _boards_equal(card.checker.board, tq.VoteBoard(
            *(t.to(dev) for t in host.checker.board)))
        worst = max(worst, err)
        require(err == 0, f"{name}: the staged drain's board differs")
        out[name] = {"drains": len(stream), "dispatches": dispatches,
                     "staged_calls": dict(counted.calls),
                     "sparse_chunks": chunks, "sparse_segments": segments,
                     "k4_launches": k4,
                     "k2_launches": tq.record_block.launches}
    return worst, out


def phase_k5(dev, rng) -> int:
    """K5 against its plain version: window 2^20, all-valid batches with
    duplicate, negative and out-of-range slots, and mixed valid flags on
    distinct slots."""
    worst = 0
    board_k, board_p = _random_board(rng, 3, WINDOW, dev)
    for step in range(16):
        b = 4096
        if step % 2:
            slots = rng.permutation(WINDOW)[:b].astype(np.int32)
            valid = rng.random(b) < 0.5
        else:
            slots = rng.integers(-WINDOW - 8, WINDOW + 8,
                                 size=b).astype(np.int32)
            slots[: b // 4] = slots[0]
            valid = np.ones(b, dtype=bool)
        s, v = (torch.from_numpy(x).to(dev) for x in (slots, valid))
        tq.release(board_k, s, v)
        tq.release_plain(board_p, s, v)
        err = _boards_equal(board_k, board_p)
        worst = max(worst, err)
        require(err == 0, f"K5 differs from plain at call {step}")
    torch.cuda.synchronize(dev)
    return max(worst, _k5_all(dev, rng))


EPOCH_WINDOW = 1 << 14   # the ProxyLeader's epoch tracker window


def epoch_planes(dev):
    """Three epochs over a 5-node union (majorities of (0,1,2), (0,1,3),
    (1,3,4)) starting at slots 0, 3000 and 9000."""
    universe = tuple(range(5))
    epoch_specs = [SimpleMajority(m).write_spec().reindexed(universe)
                   for m in ((0, 1, 2), (0, 1, 3), (1, 3, 4))]
    planes = tq.make_multi_predicate(*pad_specs(epoch_specs), device=dev)
    boundaries = torch.tensor([3000, 9000], dtype=torch.int32, device=dev)
    return planes, boundaries


def phase_k6(dev, rng) -> dict:
    """K6 against its plain version: ``check_batch_multi`` alone (0/1 and
    arbitrary int32 rows, config indices in and out of range), then 64
    epoch-segmented scatters at window 2^14 across both boundaries."""
    planes, boundaries = epoch_planes(dev)
    k = planes.masks.shape[0]
    worst_multi = 0
    for b in (1, 256, 4096, 65536):
        present = (rng.random((b, 5)) < 0.5).astype(np.int32)
        present[: b // 8] = rng.integers(-2**31, 2**31 - 1,
                                         size=(b // 8, 5))
        idx = rng.integers(-k - 1, k + 2, size=b).astype(np.int32)
        p, i = (torch.from_numpy(x).to(dev) for x in (present, idx))
        for view in (p, p.t().contiguous().t()):
            err = max_abs_err(tq.check_batch_multi(view, i, planes),
                              tq.check_batch_multi_plain(view, i, planes))
            worst_multi = max(worst_multi, err)
            require(err == 0, f"K6 check_batch_multi differs at B={b}")
    worst = 0
    board_k, board_p = _random_board(rng, 5, EPOCH_WINDOW, dev)
    kinds = dict.fromkeys(("dup", "stale", "wrap", "pad", "preempt",
                           "range"), 0)
    frontier = 2000
    for step in range(64):
        b = int(rng.integers(64, 1025))
        frontier += int(rng.integers(0, 800))
        lanes = torch.from_numpy(_sparse_lanes(
            rng, EPOCH_WINDOW, 5, frontier, b, kinds)).to(dev)
        got = tq.record_and_check_epochs(board_k, lanes, boundaries, planes)
        want = tq.record_and_check_epochs_plain(board_p, lanes, boundaries,
                                                planes)
        err = max(max_abs_err(got, want), _boards_equal(board_k, board_p))
        worst = max(worst, err)
        require(err == 0, f"K6 differs from plain at call {step}")
    require(frontier > 9000 and all(kinds.values()),
            f"K6 sequence lacks a case: frontier {frontier}, {kinds}")
    # One call of a chunk whose workspace takes shared memory past 48 KB
    # (1024 lanes) and one whose workspace is a device buffer (8192).
    for b in (1024, 8192):
        frontier += b
        lanes = torch.from_numpy(_sparse_lanes(
            rng, EPOCH_WINDOW, 5, frontier, b, kinds)).to(dev)
        got = tq.record_and_check_epochs(board_k, lanes, boundaries, planes)
        want = tq.record_and_check_epochs_plain(board_p, lanes, boundaries,
                                                planes)
        err = max(max_abs_err(got, want), _boards_equal(board_k, board_p))
        worst = max(worst, err)
        require(err == 0, f"K6 differs from plain on {b} lanes")
    worst = max(worst, _k6_runs(dev, rng, planes, boundaries))
    torch.cuda.synchronize(dev)
    return {"record_and_check_epochs": worst,
            "check_batch_multi": worst_multi}


#: The epoch tracker's chunk.
K6_CHUNK = 256
#: GPU cycles of the sleep queued ahead of the K5 or K7 work that a staged
#: K6 drain must wait for (tens of ms: longer than the host's share).
K6_QUEUED_SLEEP_CYCLES = 100_000_000


def _wrap_lanes(rng, window: int, b: int) -> np.ndarray:
    """``b`` lanes whose true slots cross the int32 wrap (from 2^31 - b/4,
    two votes a slot): slots taken % window before the wrap, true slots
    wrapped into int32 by ``pack_lanes``."""
    true = (1 << 31) - b // 4 + np.arange(b) // 2
    return tq.pack_lanes(true % window, true, rng.integers(0, 5, size=b),
                         rng.integers(0, 2, size=b), np.ones(b, bool))


def _k6_runs(dev, rng, planes, boundaries) -> int:
    """K6's run (one launch a run of chunks) against the plain version
    called chunk by chunk in order: runs of 1, 2 and 48 chunks of 256
    lanes with duplicates inside and across chunks, stale owners, ring
    wrap, preemption, slots and nodes out of range and pad lanes; a
    chunk across each epoch boundary; true slots across the int32 wrap;
    a ragged last chunk; pad lanes removed changing nothing; and the
    tracker's staged entry (``EpochSegmentedChecker.record_and_check_run``)
    against a checker on the CPU."""
    worst = 0
    board_k, board_p = _random_board(rng, 5, EPOCH_WINDOW, dev)

    def check(lanes_np, what, chunk=K6_CHUNK):
        nonlocal worst
        lanes = torch.from_numpy(lanes_np).to(dev)
        got = tq.record_and_check_epochs_run(board_k, lanes, boundaries,
                                             planes, chunk)
        want = torch.cat([tq.record_and_check_epochs_plain(
            board_p, lanes[:, at:at + chunk], boundaries, planes)
            for at in range(0, lanes.shape[1], chunk)])
        err = max(max_abs_err(got, want), _boards_equal(board_k, board_p))
        worst = max(worst, err)
        require(err == 0, f"K6's run differs from plain chunks: {what}")
        return got

    kinds = dict.fromkeys(("dup", "stale", "wrap", "pad", "preempt",
                           "range"), 0)
    for frontier, chunks in ((2000, 1), (3100, 2), (6000, 48), (9050, 1),
                             (12000, 48)):
        check(_sparse_lanes(rng, EPOCH_WINDOW, 5, frontier,
                            chunks * K6_CHUNK, kinds),
              f"{chunks} chunks at {frontier}")
    require(all(kinds.values()), f"K6 runs lack a case: {kinds}")
    check(_wrap_lanes(rng, EPOCH_WINDOW, 4 * K6_CHUNK), "the int32 wrap")
    check(_sparse_lanes(rng, EPOCH_WINDOW, 5, 13000, 5 * K6_CHUNK - 37,
                        kinds), "a ragged last chunk")
    # Pad lanes are inert: the same run with and without them.
    lanes = _sparse_lanes(rng, EPOCH_WINDOW, 5, 14000, 3 * K6_CHUNK, kinds)
    pads = lanes[4] == 0
    require(pads.any(), "the pad-lane run has no pad lane")
    snapshot = [t.clone() for t in board_k]
    padded = check(lanes, "pad lanes").cpu().numpy()
    after = [t.clone() for t in board_k]
    for t, saved in zip(board_k, snapshot):
        t.copy_(saved)
    for t, saved in zip(board_p, snapshot):
        t.copy_(saved)
    bare = tq.record_and_check_epochs_run(
        board_k, torch.from_numpy(np.ascontiguousarray(
            lanes[:, ~pads])).to(dev), boundaries, planes,
        K6_CHUNK).cpu().numpy()
    err = max(_boards_equal(tq.VoteBoard(*after), board_k),
              int(padded[pads].sum()))
    worst = max(worst, err)
    require(err == 0, "K6: pad lanes changed the board or reported")
    # The pads sit at the end: the other lanes keep their chunks.
    require(bool((padded[~pads] == bare).all()),
            "K6: removing pad lanes changed newly")
    for t, saved in zip(board_p, after):
        t.copy_(saved)

    # The tracker's staged entry: 48 chunks a drain, a handover inside.
    universe = tuple(range(5))
    specs_ = [SimpleMajority(m).write_spec().reindexed(universe)
              for m in ((0, 1, 2), (0, 1, 3))]
    card = tq.EpochSegmentedChecker(specs_, [0, 5000], window=EPOCH_WINDOW,
                                    device=dev)
    host = tq.EpochSegmentedChecker(specs_, [0, 5000], window=EPOCH_WINDOW,
                                    device="cpu")
    for frontier in (4000, 5100, 9000):
        lanes = _sparse_lanes(rng, EPOCH_WINDOW, 5, frontier,
                              48 * K6_CHUNK, kinds)
        live = lanes[4] != 0
        slots, nodes, rounds = (lanes[1, live].astype(np.int64),
                                lanes[2, live], lanes[3, live])
        got = card.record_and_check_run(slots, nodes, rounds)
        want = host.record_and_check_run(slots, nodes, rounds)
        err = max(int((got != want).sum()), _boards_equal(
            card.board, tq.VoteBoard(*(t.to(dev) for t in host.board))))
        worst = max(worst, err)
        require(err == 0, f"K6's staged entry differs at {frontier}")

    # The staged entry runs behind the caller's queued work: a release
    # (K5) and an epoch that widens the universe (K7's reshape) queued on
    # the current stream behind a sleep, then a drain at once; the drain
    # must see both, as the checker on the CPU does. The released slots
    # are voted again, so they are newly chosen only after the release.
    def queued(what, queue, slots, nodes):
        nonlocal worst
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(K6_QUEUED_SLEEP_CYCLES)
        queue(card)
        got = card.record_and_check_run(slots, nodes, None)
        queue(host)
        want = host.record_and_check_run(slots, nodes, None)
        require(want.any(), f"K6's queued {what} case chooses nothing")
        err = max(int((got != want).sum()), _boards_equal(
            card.board, tq.VoteBoard(*(t.to(dev) for t in host.board))))
        worst = max(worst, err)
        require(err == 0, f"K6's staged entry ran ahead of a {what} "
                          f"queued before it")

    chosen = np.unique(slots[want])
    queued("release", lambda c: c.release(chosen), np.repeat(chosen, 4),
           np.tile(np.arange(4, dtype=np.int32), chosen.size))
    # Node 5 widens the universe (0 .. 4) by column 5.
    wide = SimpleMajority((0, 1, 5)).write_spec()
    fresh = np.arange(12000, 12100, dtype=np.int64)
    queued("reshape", lambda c: c.add_epoch(wide, 12000),
           np.repeat(fresh, 3),
           np.tile(np.asarray([0, 1, 5], np.int32), fresh.size))
    return worst


#: K7's boards: the epoch board's [3, 2^14] (tracker_lt's handover) and
#: [3, 2^20]; rows that are not a multiple of 16 bytes.
K7_WIDTHS = (EPOCH_WINDOW, WINDOW)
K7_ODD_WIDTHS = (1000, EPOCH_WINDOW + 5)
#: (old universe, new universe): widened and permuted, shrunk, permuted.
K7_UNIVERSES = (((0, 1, 2), (2, 0, 3, 1)), ((0, 1, 2), (1, 2)),
                ((5, 9, 2), (2, 5, 9)))
#: Maps past N_old (clamped), below -1, and past the 64 rows that cross
#: in K7's packed block.
K7_MAPS = ((7, 0, -3, 2, 3), tuple(range(-2, 62)),
           tuple(range(-1, 99)), tuple(np.arange(300) % 7 - 2))


def phase_k7(dev, rng) -> int:
    """K7 against its plain version, exact: the [3, 2^14] and [3, 2^20]
    boards to widened, permuted and shrunk universes and through maps
    past N_old, below -1 and longer than 64 rows, each map in the call
    (numpy), on the card (a tensor) and into ``out=``; rows of 1000 and
    2^14 + 5 bytes and a block off the 16-byte grid (the byte form); a
    launch inside a side stream's context."""
    worst = 0

    def check(block, cmap, what):
        nonlocal worst
        cmap_np = np.asarray(cmap, dtype=np.int32)
        cmap_t = torch.from_numpy(cmap_np).to(dev)
        want = tq.reshape_columns_plain(block, cmap_t)
        out = torch.full_like(want, 77)
        for form, got in (("host map", tq.reshape_columns(block, cmap_np)),
                          ("device map", tq.reshape_columns(block, cmap_t)),
                          ("out=", tq.reshape_columns(block, cmap_np,
                                                      out=out))):
            err = max_abs_err(got, want)
            worst = max(worst, err)
            require(err == 0, f"K7 differs from plain ({form}) for {what}")
        require(tq.reshape_columns(block, cmap_np, out=out) is out,
                "K7 did not return its out= tensor")

    for width in K7_WIDTHS + K7_ODD_WIDTHS:
        block = torch.from_numpy(rng.integers(
            0, 256, size=(3, width), dtype=np.uint8)).to(dev)
        for old, new in K7_UNIVERSES:
            check(block, tq.epoch_column_map(old, new),
                  f"[3, {width}]: {old} -> {new}")
        for cmap in K7_MAPS:
            check(block, cmap, f"[3, {width}]: a map of {len(cmap)} rows")
    flat = torch.from_numpy(rng.integers(0, 256, size=3 * 4096 + 3,
                                         dtype=np.uint8)).to(dev)
    for cmap in K7_MAPS[:2]:
        check(flat[3:].view(3, 4096), cmap, "a block off the 16-byte grid")
    # The handover's block rewritten on a side stream just before the
    # launch.
    stale = torch.zeros((3, EPOCH_WINDOW), dtype=torch.uint8, device=dev)
    fresh = torch.from_numpy(rng.integers(0, 256, size=(3, EPOCH_WINDOW),
                                          dtype=np.uint8)).to(dev)
    cmap = tq.epoch_column_map((0, 1, 2), (0, 1, 2, 3))
    side_stream_check(dev, "reshape_columns", stale, fresh,
                      lambda: tq.reshape_columns(stale, cmap),
                      tq.reshape_columns_plain(fresh,
                                               torch.from_numpy(cmap)
                                               .to(dev)))
    torch.cuda.synchronize(dev)
    return worst


RECOVERY_ROWS = 1 << 16  # the cluster bench's recovery window
FAILOVER_ROWS = 1 << 13  # the smoke's failover window (phase 12)
#: K8's shapes: the smoke's and the bench's failover windows, the 2x3
#: grid's columns, a ragged last tile, and the generic and wide forms.
K8_CASES = ((1 << 13, 3), (RECOVERY_ROWS, 3), (RECOVERY_ROWS, 6),
            ((1 << 13) + 77, 3), (5000, 1), (4097, 2), (3001, 5), (2999, 9),
            (1031, 17))
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _k8_inputs(rng, n: int, dev, pad: int = 4096, rows: int = RECOVERY_ROWS):
    """[rows, n] rounds in [-1, 3] (ties everywhere, 1/8 all-NO_VOTE
    rows, 1/8 rows at one round, 1/16 of the rounds at INT32_MIN or
    INT32_MAX) and ids, with the last ``pad`` rows the Leader's padding
    (NO_VOTE, id 0)."""
    s = rows
    rounds = rng.integers(-1, 4, size=(s, n)).astype(np.int32)
    ids = rng.integers(0, 1 << 20, size=(s, n)).astype(np.int32)
    rounds[rng.random(s) < 0.125] = tv.NO_VOTE
    same = rng.random(s) < 0.125
    rounds[same] = rng.integers(0, 4, size=(int(same.sum()), 1))
    extreme = rng.random((s, n)) < 1 / 16
    rounds[extreme] = np.where(rng.random(int(extreme.sum())) < 0.5,
                               INT32_MIN, INT32_MAX)
    rounds[-pad:] = tv.NO_VOTE
    ids[-pad:] = 0
    return (torch.from_numpy(rounds).to(dev),
            torch.from_numpy(ids).to(dev))


def phase_k8(dev, rng) -> dict:
    """K8 against its plain version, exact, at every shape of
    ``K8_CASES``: the lean wrapper (also into ``out=``, and on matrices
    off the 16-byte grid: the scalar loads), and the Leader's staged
    entry (the kernel reading and writing the pinned blocks in place) on
    ``recovery_matrices``'s views and on other arrays; returns
    ``{"safe_values": worst wrapper error, "safe_values_staged": worst
    staged error}``."""
    worst = {"safe_values": 0, "safe_values_staged": 0}

    def note(key, got, want, what):
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        worst[key] = max(worst[key], err)
        require(err == 0, f"K8 differs from plain: {what}")

    for rows, n in K8_CASES:
        pad = min(4096, rows // 4)
        rounds, ids = _k8_inputs(rng, n, dev, pad=pad, rows=rows)
        want = tv.safe_values_plain(rounds, ids)
        what = f"[{rows}, {n}]"
        got = tv.safe_values(rounds, ids)
        note("safe_values", got, want, what)
        require(not got[0][-pad:].any(), "K8 voted on a padding row")
        out = (torch.ones(rows, dtype=torch.bool, device=dev),
               torch.full((rows,), 7, dtype=torch.int32, device=dev))
        got = tv.safe_values(rounds, ids, out=out)
        require(got[0] is out[0] and got[1] is out[1],
                "K8 did not return its out= tensors")
        note("safe_values", got, want, what + " out=")
        flat = torch.empty(2 * rows * n + 2, dtype=torch.int32,
                           device=dev)
        r_off = flat[1:1 + rows * n].view(rows, n)
        i_off = flat[1 + rows * n:1 + 2 * rows * n].view(rows, n)
        r_off.copy_(rounds)
        i_off.copy_(ids)
        note("safe_values", tv.safe_values(r_off, i_off), want,
             what + " off the 16-byte grid")
        r_np, i_np = rounds.cpu().numpy(), ids.cpu().numpy()
        want_np = tuple(t.cpu() for t in want)
        views = tv.recovery_matrices(rows, n, dev)
        require(all((v == fill).all() for v, fill in
                    zip(views, (tv.NO_VOTE, 0))),
                "recovery_matrices did not prefill its views")
        views[0][...], views[1][...] = r_np, i_np
        for arrays in (views, (r_np, i_np)):
            got = tv.safe_values_staged(*arrays, device=dev)
            note("safe_values_staged",
                 tuple(torch.from_numpy(a) for a in got), want_np,
                 f"{what} staged")
    torch.cuda.synchronize(dev)
    return worst


#: [B, L, W] shapes of K9-K11's comparison: the cluster's fast and slow
#: path ([3, 5, 8], [5, 5, 2048] at the span limit), depset_lt's
#: [4096, 3, 32], a wide arbitrary batch and an odd width.
DEPSET_SHAPES = ((4096, 5, 2048), (4096, 3, 32), (3, 5, 8), (5, 5, 2048),
                 (1, 1, 37))


def _depset_batch(rng, shape, base: int, kind: str, dev) -> td.DepSetBatch:
    """Watermarks around the window at ``base``; tail bytes 0/1 at 90%
    (long runs), or arbitrary."""
    b, l, w = shape
    wm = np.clip(base + rng.integers(-16, w + 16, size=(b, l)),
                 -2**31, 2**31 - 1).astype(np.int32)
    if kind == "bits":
        tails = (rng.random((b, l, w)) < 0.9).astype(np.uint8)
    else:
        tails = rng.integers(0, 256, size=(b, l, w), dtype=np.uint8)
    return td.DepSetBatch(torch.from_numpy(wm).to(dev),
                          torch.from_numpy(tails).to(dev),
                          torch.tensor(base, dtype=torch.int32).to(dev))


def _aliased(batch: td.DepSetBatch, rng) -> td.DepSetBatch:
    """Every row written as row 0's normalized set: rows b >= 1 move up
    to 8 ids below the watermark into tail bytes, so the rows are equal
    only after normalization (exactly so for 0/1 bytes)."""
    n = td.normalized_plain(td.DepSetBatch(*(t.cpu() for t in batch)))
    b, l, w = n.tails.shape
    base = int(n.tail_base)
    top = np.repeat(n.watermarks[:1].numpy().astype(np.int64), b, axis=0)
    tails = np.repeat(n.tails[:1].numpy(), b, axis=0)
    low = np.maximum(top - rng.integers(0, 9, size=(b, l)), base)
    move = (low < top) & (top - base <= w)
    move[0] = False
    pos = np.arange(w)[None, None, :]
    tails[move[:, :, None] & (pos >= (low - base)[:, :, None])
          & (pos < (top - base)[:, :, None])] = 1
    wm = np.where(move, low, top).astype(np.int32)
    dev = batch.tails.device
    return td.DepSetBatch(torch.from_numpy(wm).to(dev),
                          torch.from_numpy(tails).to(dev),
                          n.tail_base.to(dev))


#: K10's and K11's extra shapes: the cluster paths' launch shapes (the
#: BPaxos Leader's [2, 2, W], the EPaxos slow path's [4, 5, 8]), rows
#: wider than K10's shared chunk (8192 bytes; with a cluster), and W = 37
#: (byte words) over many rows, with a cluster.
K10_K11_SHAPES = ((2, 2, 8), (2, 2, 64), (2, 2, 2048), (4, 5, 8),
                  (3, 2, 10000), (64, 2, 9000), (64, 3, 37), (600, 2, 37))


def _staged(batch: td.DepSetBatch, seqs) -> tuple:
    """The staged entries on the same batch: ``(union_packed`` in seq
    mode when ``seqs`` is given, ``all_equal_packed)`` of a packed block
    on the batch's card holding its arrays."""
    b, l, w = batch.tails.shape
    out = []
    for s in (seqs, None):
        p = td.packed(b, l, w, 0 if s is None else s.shape[0],
                      batch.tails.device)
        p.watermarks[...] = batch.watermarks.cpu().numpy()
        p.tails[...] = batch.tails.cpu().numpy()
        p.tail_base[...] = int(batch.tail_base)
        if s is not None:
            p.seqs[:] = s.cpu().numpy()
            seq, wm, tails = td.union_packed(p)
            out.append((torch.tensor(seq, dtype=torch.int32),
                        torch.from_numpy(wm.copy()),
                        torch.from_numpy(tails.copy())))
        else:
            out.append(torch.tensor(td.all_equal_packed(p)))
    return tuple(out)


def phase_depset(dev, rng) -> dict:
    """K9, K10 (both modes) and K11 against their plain versions, exact,
    at every shape of ``DEPSET_SHAPES`` and ``K10_K11_SHAPES`` (K9 at
    the first) for window bases in the middle, near 2^31 - 1 and below 0
    (negative watermarks), bits and arbitrary bytes; K11 also on batches
    equal only after normalization, and with one byte changed; the
    staged entries (``union_packed`` in seq mode, ``all_equal_packed``)
    on the same batches, against the same plain versions."""
    worst = dict.fromkeys(("normalized", "union_reduce", "conflict_max",
                           "all_equal", "union_staged", "all_equal_staged"),
                          0)
    seen = {"equal": 0, "unequal": 0}

    def check(name, got, want):
        err = max(max_abs_err(a.cpu(), b.cpu()) for a, b in zip(got, want))
        worst[name] = max(worst[name], err)
        require(err == 0, f"{name} differs from plain at {shape} base "
                          f"{base} ({kind})")

    for shape in DEPSET_SHAPES + K10_K11_SHAPES:
        w = shape[2]
        for base in (1000, 2**31 - 1 - w // 2, -w // 2 - 5):
            for kind in ("bits", "bytes"):
                batch = _depset_batch(rng, shape, base, kind, dev)
                if shape in DEPSET_SHAPES:
                    check("normalized", td.normalized(batch),
                          td.normalized_plain(batch))
                check("union_reduce", td.union_reduce(batch),
                      td.union_reduce_plain(batch))
                seqs = torch.from_numpy(rng.integers(
                    -2**31, 2**31, size=shape[0], dtype=np.int64)
                    .astype(np.int32)).to(dev)
                got_seq, got = td.conflict_max(seqs, batch)
                want_seq, want = td.conflict_max_plain(seqs, batch)
                want_row = (want_seq, want.watermarks[0], want.tails[0])
                check("conflict_max", (got_seq, *got),
                      (want_seq, *want))
                cases = [batch, _aliased(batch, rng)]
                changed = _aliased(batch, rng)
                if shape[0] > 1:
                    changed.tails[-1, -1, -1] ^= 1
                    cases.append(changed)
                for i, case in enumerate(cases):
                    got, want = td.all_equal(case), td.all_equal_plain(case)
                    check("all_equal", (got,), (want,))
                    seen["equal" if bool(want) else "unequal"] += 1
                    if shape[0] * shape[1] * shape[2] > 1 << 22:
                        continue  # the staged block: up to 4 MB a call
                    union_row, equal = _staged(case, seqs)
                    if i == 0:
                        check("union_staged", union_row, want_row)
                    check("all_equal_staged", (equal,), (want,))
    require(all(seen.values()), f"K11 cases lack an outcome: {seen}")
    torch.cuda.synchronize(dev)
    return worst


#: K12's row widths and batch sizes (n 3 and B 1..2^16 cover the GC
#: roles' [leaders, replicas] = [2, 3] and wider deployments; 31-33,
#: 64-65, 128 and 1001 the warp kernel's edges: one lane per element,
#: several per lane, up to 1024 in one tile of registers).
WATERMARK_WIDTHS = (1, 2, 3, 5, 7, 9, 31, 32, 33, 64, 65, 128, 1001)
WATERMARK_ROWS = (1, 4096, 1 << 16)
#: Widths above 1024, which the warp kernel takes in tiles of 1024
#: against the row read again by chunks of 32, at these batch sizes.
WATERMARK_TILED_WIDTHS = (1025, 2500)
WATERMARK_TILED_ROWS = (1, 4096)
#: Widths above this are held at a spread of quorum sizes, not at every
#: size in [1, n].
WATERMARK_EVERY_Q = 65
INT32_EXTREMES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2,
                           2**31 - 1], dtype=np.int32)


def _quorum_sizes(n: int) -> list:
    """Every size in [1, n] up to ``WATERMARK_EVERY_Q``, else a spread;
    and the out-of-range 0, -1 and n + 1."""
    inside = range(1, n + 1) if n <= WATERMARK_EVERY_Q else sorted(
        {1, 2, 3, n // 3, n // 2, n // 2 + 1, n - 2, n - 1, n})
    return [*inside, 0, -1, n + 1]


def _busy(dev) -> None:
    """Enqueue some milliseconds of matrix products on the current
    stream, so that work queued behind them waits."""
    a = torch.ones((4096, 4096), device=dev)
    for _ in range(8):
        a @ a


def side_stream_check(dev, name: str, stale, fresh, launch, want) -> None:
    """A launch inside ``with torch.cuda.stream(s):`` must be ordered on
    ``s``: ``fresh`` is copied into the input ``stale`` on ``s`` behind
    some milliseconds of work, and the launch that follows on ``s`` must
    read it (a launch on another stream would read the stale input)."""
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize(dev)
    with torch.cuda.stream(side):
        require(_build.stream_handle(dev.index) == side.cuda_stream,
                f"{name}: the stream handle does not follow "
                f"torch.cuda.stream")
        _busy(dev)
        stale.copy_(fresh)
        got = launch()
    side.synchronize()
    require(torch.equal(got, want),
            f"{name} launched inside a side stream's context was not "
            f"ordered on that stream")
    torch.cuda.synchronize(dev)


def phase_watermark(dev, rng) -> dict:
    """K12 and K13 against their plain versions, exact: K12 at every
    width of ``WATERMARK_WIDTHS`` and batch of ``WATERMARK_ROWS``, and
    of ``WATERMARK_TILED_WIDTHS`` and ``WATERMARK_TILED_ROWS``, for
    every quorum size in [1, n], per-row sizes, and 0, -1, n + 1, with a
    quarter of the rows near +-2^31; its vector form on int64 matrices
    that wrap; K13 on bool, byte and signed rows of every kind the
    reference's tests and libbench use."""
    worst = {"quorum_watermark": 0, "contiguous_prefix_length": 0}

    def check(name, got, want, what):
        err = max_abs_err(got, want)
        worst[name] = max(worst[name], err)
        require(got.shape == want.shape and err == 0,
                f"{name} differs from plain at {what}")

    cases = [(n, b) for n in WATERMARK_WIDTHS for b in WATERMARK_ROWS]
    cases += [(n, b) for n in WATERMARK_TILED_WIDTHS
              for b in WATERMARK_TILED_ROWS]
    for n, b in cases:
        w = rng.integers(-1000, 1000, size=(b, n)).astype(np.int32)
        w[: b // 4] = rng.choice(INT32_EXTREMES, size=(b // 4, n))
        w[b // 4: b // 2] = rng.integers(0, 3, size=(b // 2 - b // 4, n))
        wt = torch.from_numpy(w).to(dev)
        for q in _quorum_sizes(n):
            check("quorum_watermark", tw.quorum_watermark(wt, q),
                  tw.quorum_watermark_plain(wt, q), f"n={n} B={b} q={q}")
        per_row = torch.from_numpy(rng.integers(
            -1, n + 2, size=b).astype(np.int32)).to(dev)
        check("quorum_watermark", tw.quorum_watermark(wt, per_row),
              tw.quorum_watermark_plain(wt, per_row),
              f"n={n} B={b} per-row q")
        # The vector form's strided read: columns of a [n, B] matrix.
        cols = wt.t().contiguous()
        check("quorum_watermark", tw.quorum_watermark(cols.t(), 1),
              tw.quorum_watermark_plain(wt, 1), f"n={n} B={b} strided")
        # The out= buffer: written and returned itself.
        out = torch.full((b,), 7, dtype=torch.int32, device=dev)
        got = tw.quorum_watermark(cols.t(), (n + 1) // 2, out=out)
        require(got is out, "quorum_watermark(out=) returned another "
                "tensor")
        check("quorum_watermark", out,
              tw.quorum_watermark_plain(wt, (n + 1) // 2),
              f"n={n} B={b} strided, out=")
    # The transport of a GC fold: 4096 rows of 5, the input rewritten on
    # a side stream just before the launch.
    stale = torch.zeros((4096, 5), dtype=torch.int32, device=dev)
    fresh = torch.from_numpy(rng.integers(-1000, 1000, size=(4096, 5))
                             .astype(np.int32)).to(dev)
    side_stream_check(dev, "quorum_watermark", stale, fresh,
                      lambda: tw.quorum_watermark(stale, 3),
                      tw.quorum_watermark_plain(fresh, 3))
    for shape in ((3, 2), (5, 3), (64, 7), (33, 5), (1001, 3), (1025, 2),
                  (3, 1), (2, 40), (0, 3), (5, 3)):
        m = rng.integers(0, 1 << 34, size=shape, dtype=np.int64)
        for q in range(1, max(shape[0], 1) + 1):
            got = tw.quorum_watermark_vector(m, q, device=dev)
            want = tw.quorum_watermark_vector(m, q, device="cpu")
            require(np.array_equal(got, want),
                    f"quorum_watermark_vector differs from plain at "
                    f"{shape} q={q}")
    w = np.array([[2**31 + 5, 1], [3, 2**32 + 7], [2**33, 4]], np.int64)
    require(tw.quorum_watermark_vector(w, 2, device=dev).tolist() == [0, 4],
            "quorum_watermark_vector does not wrap int64 as the reference")

    present = np.ones(4096, dtype=bool)
    present[2048] = False
    rows = np.ones((4096, 3), dtype=bool)
    rows[rng.integers(0, 4096, size=600), rng.integers(0, 3, size=600)] = 0
    cases = [present, rows,
             np.array([2, 3, 1, 0], np.uint8),
             rng.integers(0, 4, size=(4096, 64)).astype(np.uint8),
             rng.integers(-3, 4, size=(1024, 40)).astype(np.int8),
             rng.integers(-3, 4, size=(1024, 40)).astype(np.int16),
             rng.integers(1, 70000, size=(1024, 40)).astype(np.int32),
             rng.integers(-2**40, 2**40, size=(1024, 5)),
             np.ones((64, 100003), dtype=bool),
             np.ones((3, 0), dtype=bool), np.zeros((0, 5), dtype=bool)]
    for x in cases:
        xt = torch.from_numpy(x).to(dev)
        check("contiguous_prefix_length", tw.contiguous_prefix_length(xt),
              tw.contiguous_prefix_length_plain(xt),
              f"{x.dtype} {tuple(x.shape)}")
    require(int(tw.contiguous_prefix_length(
        torch.from_numpy(present).to(dev))) == 2048,
        "K13 misses libbench's prefix of 2048")
    _k13_forms(dev, rng, check)
    torch.cuda.synchronize(dev)
    return worst


#: K13's element types, and the elements a CTA tile of each takes in the
#: vector form (512 threads x 4 words of 16 bytes) and the scalar form
#: (512 x 8 elements): ``csrc/watermark.cu``.
K13_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
              torch.int64)
K13_SCALAR_TILE = 4096
#: Row counts about the CTA form's grid of 528 CTAs (more rows loop).
K13_CTA_ROWS = (1, 3, 528, 529)


def _k13_vector_tile(dtype) -> int:
    size = torch.empty(0, dtype=dtype).element_size()
    return 512 * 4 * (16 // size)


def _k13_rows(rng, dtype, length: int, tile: int) -> np.ndarray:
    """All-ones rows of ``length`` elements with the first zero at each
    byte of a 16-byte word, at each side of the first two tile
    boundaries, and nowhere; for integer types also values outside {0,
    1} before and after the first zero (-1 for signed types), products
    that wrap to 0, int64 values whose low 32 bits are 0 or 1, and
    random rows."""
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    at = [2048 + k for k in range(16)]
    at += [t + d for t in (tile, 2 * tile) for d in (-1, 0, 1)
           if 0 <= t + d < length]
    rows = []
    for a in at + [None]:
        r = np.ones(length, np_dtype)
        if a is not None:
            r[a] = 0
        rows.append(r)
    if dtype is not torch.bool:
        for other, zero in ((5, 40), (50, 7), (tile + 3, tile + 9),
                            (tile - 1, tile + 2), (length - 2, None)):
            if other < length and (zero is None or zero < length):
                r = np.ones(length, np_dtype)
                r[other] = 3
                if zero is not None:
                    r[zero] = 0
                rows.append(r)
        if np_dtype.kind == "i":
            r = np.ones(length, np_dtype)
            r[min(tile + 5, length - 2)] = -1
            r[length - 1] = 0
            rows.append(r)
        if np_dtype.itemsize >= 4:
            r = np.ones(length, np_dtype)
            r[3] = r[min(tile + 4, length - 1)] = 1 << 16
            rows.append(r)
        if np_dtype == np.int64:
            r = np.full(length, (1 << 32) + 1, np_dtype)
            r[min(tile + 11, length - 1)] = 1 << 32
            rows.append(r)
        lo = -2 if np_dtype.kind == "i" else 0
        rows.append(rng.integers(lo, 3, size=length).astype(np_dtype))
        r = rng.integers(1, 3, size=length).astype(np_dtype)
        r[: min(tile + 20, length - 1)] = 1
        rows.append(r)
    else:
        rows.append(rng.random(length) < 0.9999)
    return np.stack(rows)


def _k13_forms(dev, rng, check) -> None:
    """K13 in every form against its plain version, exact: the first
    zero at each byte of a 16-byte word and at each side of the tiles'
    boundaries, values outside {0, 1} before and after it, in every
    element type; rows that start 1-15 bytes off the 16-byte grid (the
    vector form's head word) and strided rows (the scalar form); every
    form's switch-over shapes (L 16 / 17, 512 / 513, rows about the
    CTA grid); ``out=`` written and returned; a launch inside a side
    stream's context ordered on that stream. The form the C entry
    launches equals ``prefix_form`` on every input."""
    def run(xt, what):
        form = tw.prefix_form(xt)
        require(tw.prefix_form_launched(xt) == form,
                f"K13's C form {tw.prefix_form_launched(xt)} is not "
                f"prefix_form's {form} at {what}")
        check("contiguous_prefix_length", tw.contiguous_prefix_length(xt),
              tw.contiguous_prefix_length_plain(xt), f"{what} ({form})")
        return form

    seen = set()
    for dtype in K13_DTYPES:
        tile = _k13_vector_tile(dtype)
        # Two tiles and a ragged third, rows 37 elements longer than a
        # multiple of 16 bytes apart: every row's head word differs.
        x = torch.from_numpy(_k13_rows(rng, dtype, 2 * tile + 37,
                                       tile)).to(dev)
        seen.add(run(x, f"{dtype} rows of two tiles"))
        flat = x.reshape(-1)
        for off in range(1, 16):
            seen.add(run(flat[off:off + 2 * tile + 37],
                         f"{dtype} row {off} elements off"))
        # Strided rows: the scalar form's tiles.
        xs = torch.from_numpy(_k13_rows(rng, dtype, 2 * K13_SCALAR_TILE + 37,
                                        K13_SCALAR_TILE)).to(dev)
        wide = torch.zeros((xs.shape[0], 2 * xs.shape[1]), dtype=dtype,
                           device=dev)
        wide[:, ::2] = xs
        seen.add(run(wide[:, ::2], f"{dtype} strided rows"))
        seen.add(run(xs.t().contiguous().t(), f"{dtype} transposed rows"))
        # The switch-overs: L 16 / 17 (thread / warp), 512 / 513 (warp /
        # CTA), 528 (a multiple of 16 bytes), a tile of one word a thread
        # or four (511 words / one more element), rows about the CTA grid.
        words = 511 * (16 // torch.empty(0, dtype=dtype).element_size())
        for length in (1, 16, 17, 40, 512, 513, 528, words, words + 1):
            for rows in K13_CTA_ROWS:
                xr = rng.integers(0, 2, size=(rows, length)).astype(
                    torch.empty(0, dtype=dtype).numpy().dtype)
                xr[:, : length - length // 8] = 1
                if dtype is not torch.bool:
                    xr[rows // 2, length // 3] = 2
                seen.add(run(torch.from_numpy(xr).to(dev),
                             f"{dtype} [{rows}, {length}]"))
    require(seen == set(tw.PREFIX_FORMS),
            f"K13's forms run: {sorted(seen)}")
    # out=: written and returned itself, in every form.
    for shape in ((4096, 3), (1024, 40), (64, 600), (600,)):
        xt = torch.from_numpy(rng.random(shape) < 0.998).to(dev)
        out = torch.full(shape[:-1], 7, dtype=torch.int32, device=dev)
        got = tw.contiguous_prefix_length(xt, out=out)
        require(got is out, "contiguous_prefix_length(out=) returned "
                "another tensor")
        check("contiguous_prefix_length", out,
              tw.contiguous_prefix_length_plain(xt), f"{shape} out=")
    # libbench's row rewritten on a side stream just before the launch.
    stale = torch.ones(4096, dtype=torch.bool, device=dev)
    fresh = stale.clone()
    fresh[2048] = False
    side_stream_check(dev, "contiguous_prefix_length", stale, fresh,
                      lambda: tw.contiguous_prefix_length(stale),
                      tw.contiguous_prefix_length_plain(fresh))


#: Every kernel wrapper, by the name of its row in the kernels line.
WRAPPERS = {
    "quorum_hit": tq.quorum_hit,
    "record_block": tq.record_block,
    "steady_state_step": tp.steady_state_step,
    "record_and_check": tq.record_and_check,
    "release": tq.release,
    "record_and_check_epochs": tq.record_and_check_epochs,
    "check_batch_multi": tq.check_batch_multi,
    "reshape_columns": tq.reshape_columns,
    "safe_values": tv.safe_values,
    "normalized": td.normalized,
    "union_reduce": td.union_reduce,
    "conflict_max": td.conflict_max,
    "all_equal": td.all_equal,
    "quorum_watermark": tw.quorum_watermark,
    "contiguous_prefix_length": tw.contiguous_prefix_length,
    "steady_state_step_telemetry": tp.telemetry_drain,
    "steady_state_step_baseline": tpin.steady_state_step,
    "count_matching_replies": tv.count_matching_replies,
    "union": td.union,
    "intersect": td.intersect,
    "compact": td.compact,
    "equal": td.equal,
    "size": td.size,
    "contains": td.contains,
    "link_keep_mask": tsw.link_keep_mask_tensor,
    "shard_vote_count": tp.shard_vote_count,
    "shard_commit": tp.shard_commit,
    "shard_fold": tp.shard_fold,
    **multichip_board.PINNED_KERNELS,
}
#: The kernels of the main path, K1-K7 (check_batch_multi, K6's
#: stateless predicate, is not on it: it runs on the fast path).
MAIN_PATH = ("quorum_hit", "record_block", "steady_state_step",
             "record_and_check", "release", "record_and_check_epochs",
             "reshape_columns")


#: The runs whose launches the kernels line counts: phases 11, 12, 14,
#: 16, 18, 21, 23-24, 25, 26, 29, 31, 32, 33, 34, 35 and 36
#: (``*_traffic`` entries of ``launches_by_path`` are subsets of these).
MAIN_PATHS = ("headline_and_tracker", "cluster", "epaxos", "bpaxos",
              "telemetry", "libbench", "geo", "sharded", "sharded_board",
              "tcp_cluster", "reconfig_cluster", "fast_cluster",
              "mmp_cluster", "ingest_tcp", "read_batch_cluster",
              "traced_tcp")
#: The kernels of the telemetry path (phase 18) and of the libbench path
#: (phase 21).
TELEMETRY_PATH = ("steady_state_step", "steady_state_step_telemetry",
                  "steady_state_step_baseline")
LIBBENCH_PATH = ("quorum_watermark", "contiguous_prefix_length", "union",
                 "union_reduce")
#: The kernels of the geo path (phases 23-24): K5 and K6 from the WPaxos
#: leaders' trackers, K18 from the geo transport's waves.
GEO_PATH = ("release", "record_and_check_epochs", "link_keep_mask")
#: The kernels of the sharded path (phase 25): K19-K21.
SHARDED_PATH = multichip.SHARDED_KERNELS
#: Phase 25's meshes, ``(group, slot, spec)``, at the full width.
SHARDED_MESHES = multichip.CHECK_MESHES
#: Drains per mesh: the 32-block ring wraps.
SHARDED_DRAINS = 40
#: Drains per run of the runner's arm (multichip_lt's runs).
SHARDED_RUN = 8


def _rows(batch: td.DepSetBatch) -> int:
    """Bytes of a batch's watermarks and tails."""
    return 4 * batch.watermarks.numel() + batch.tails.numel()


def _shape(batch: td.DepSetBatch) -> str:
    return "[B, L, W] = " + str(list(batch.tails.shape))


def reset_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
        if hasattr(wrapper, "drains"):
            wrapper.drains = 0


#: ``{path: {drain kernel: drains}}``: the drains K3, K14 and the pinned
#: copy ran on the paths that drive them from this process (phases 11 and
#: 18), beside their launches.
DRAINS_BY_PATH: dict = {}


def record_drains(path: str) -> None:
    DRAINS_BY_PATH[path] = {name: WRAPPERS[name].drains
                            for name in DRAIN_KERNELS}


def phase_cluster(dev) -> tuple[dict, dict]:
    """The MultiPaxos cluster path at full width; its gates raise inside
    ``multipaxos_sim.run``. The counts read after it include the
    pipelined trackers' construction prewarm; the launch gate reads the
    arms' traffic alone."""
    reset_launches()
    try:
        result = multipaxos_sim.run(dev, writes=CLUSTER_WRITES,
                                    burst=CLUSTER_WRITES)
    except multipaxos_sim.GateFailure as exc:
        raise SmokeFailure(f"cluster: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    traffic = result["launches"]
    require(all(traffic[name] > 0
                for name in multipaxos_sim.CLUSTER_KERNELS),
            f"a kernel of the cluster path never launched on its "
            f"traffic: {traffic}")
    return result, launches


def phase_epaxos(dev) -> tuple[dict, dict, dict]:
    """The EPaxos path: the cluster bench and the depset_lt twin; their
    gates raise inside ``run``. K10 and K11 must have launched on the
    cluster's traffic."""
    reset_launches()
    try:
        cluster = epaxos_sim.run(dev)
        pairs = depset_lt.run(dev)
    except (epaxos_sim.GateFailure, depset_lt.GateFailure) as exc:
        raise SmokeFailure(f"epaxos: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    traffic = cluster["launches"]
    require(all(traffic[name] > 0 for name in epaxos_sim.CLUSTER_KERNELS),
            f"a kernel of the EPaxos path never launched on its traffic: "
            f"{traffic}")
    return cluster, pairs, launches


def phase_bpaxos(dev) -> tuple[dict, dict]:
    """The BPaxos path: the cluster bench's three arms; its gates raise
    inside ``run``. K10 and K12 must have launched on the cluster's
    traffic."""
    reset_launches()
    try:
        result = bpaxos_sim.run(dev, commands=BPAXOS_COMMANDS)
    except bpaxos_sim.GateFailure as exc:
        raise SmokeFailure(f"bpaxos: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    traffic = result["launches"]
    require(all(traffic[name] > 0 for name in bpaxos_sim.CLUSTER_KERNELS),
            f"a kernel of the BPaxos path never launched on its traffic: "
            f"{traffic}")
    return result, launches


def phase_main_path(dev, rng) -> tuple[dict, dict, dict]:
    reset_launches()
    result = headline.measure(dev, latency_budget_s=10.0)
    spec = specs()["majority3"]
    checker = tq.TpuQuorumChecker(spec, window=WINDOW, device=dev)
    chosen = 0
    for d in range(64):
        arrivals = (rng.random((3, BLOCK)) < 0.6).astype(np.uint8)
        hits = checker.check_block(arrivals)
        require(np.array_equal(hits, spec.evaluate(arrivals.T)),
                f"check_block disagrees with the host oracle at drain {d}")
        require(np.array_equal(checker.check_batch(arrivals.T), hits),
                "check_batch disagrees with check_block")
        newly = checker.record_block(d * BLOCK, arrivals)
        require(np.array_equal(newly, hits),
                f"record_block disagrees with the host oracle at drain {d}")
        chosen += int(newly.sum())
    result["checker_chosen"] = chosen
    # The ProxyLeader's vote path at full width: every arm is checked
    # against its dict oracle inside run() (a mismatch raises).
    votes = tracker_lt.run(dev)
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    record_drains("headline_and_tracker")
    require(all(launches[name] > 0 for name in MAIN_PATH),
            f"a kernel of the main path never launched: {launches}")
    return result, votes, launches

#: Starts of phase 17's runs: drain 0, and near 2^31 (the index, the
#: proposals and the lag wrap as int32; each 40-drain run crosses the wrap
#: inside one launch).
TELEMETRY_STARTS = (0, 2**31 - 20)
#: Phase 17's boards and chunks at window/block 1 to 6: at 1 and 2 the
#: new, old and GC blocks alias (the occupancy is read after pass 1 and
#: again after pass 2 on one column) and the kernel takes its memory path;
#: at 3 and 4 the register carry's next and ahead columns are zeroed by a
#: GC before their drain instead of loaded; at 3, 5 and 6 (rings that are
#: not a power of two) a run that crosses the int32 wrap takes the memory
#: path, the others the register carry.
TELEMETRY_RUNS = tuple((ratio * BLOCK, (1, 2, 3, 40))
                       for ratio in range(1, 7))
#: Phase 17's other predicates at the full width, each a register form
#: of its own that the headline's two shapes do not take: a group of 5, a
#: 2x3 read grid, a 2x3 write grid through a permutation, a 3x3 grid, a
#: 3x1 grid (run as one row of the other kind), WPaxos's 3x3 zone grid
#: (a majority of every row: three groups) and two overlapping groups (the
#: loop over groups), and a board of 17 acceptors (the memory path); runs
#: of ``OTHER_CHUNKS`` one after another.
OTHER_FORMS = ("majority5", "grid2x3_read", "grid_perm_write",
               "grid3x3_write", "grid3x1_write", "zonegrid3x3", "groups2",
               "majority17")
OTHER_CHUNKS = (1, 3, 64)


def form_specs() -> dict:
    """The headline's two specs and phase 17's other forms, by name."""
    return {**specs(),
            "grid3x3_write": Grid([[0, 1, 2], [3, 4, 5],
                                   [6, 7, 8]]).write_spec(),
            "grid3x1_write": Grid([[0], [1], [2]]).write_spec(),
            "zonegrid3x3": ZoneGrid([[0, 1, 2], [3, 4, 5],
                                     [6, 7, 8]]).write_spec(),
            "groups2": QuorumSpec(np.array([[1, 1, 0], [0, 1, 1]]),
                                  np.array([1, 1]), ALL, (0, 1, 2)),
            "majority17": SimpleMajority(range(17)).write_spec()}


def drain_forms(dev) -> dict:
    """Device µs a drain of each drain kernel in each form at the full
    width (``launch_ms`` of a run of ``FIGURE_DRAINS`` drains, over the
    drains): the headline's two and phase 17's other forms."""
    out = {name: {} for name in DRAIN_KERNELS}
    # Some milliseconds of drains first, so that the card's clocks have
    # ramped up before the first form is timed.
    warm = tp.make_state(WINDOW, 3, device=dev)
    tp.run_steps_from(warm, 0, 1 << 15, BLOCK,
                      *headline.spec_arrays(specs()["majority3"]))
    for form, spec in form_specs().items():
        if form not in ("majority3", "grid2x3_write") + OTHER_FORMS:
            continue
        arrays = headline.spec_arrays(spec)
        for name, module, telemetry in (
                ("steady_state_step", tp, False),
                ("steady_state_step_telemetry", tp, True),
                ("steady_state_step_baseline", tpin, False)):
            kw = {"telemetry": True} if telemetry else {}
            state = module.make_state(WINDOW, spec.num_nodes, device=dev,
                                      **kw)
            at = [0]

            def run():
                module.run_steps_from(state, at[0], FIGURE_DRAINS, BLOCK,
                                      *arrays)
                at[0] += FIGURE_DRAINS
            out[name][form] = launch_ms(run, 7) * 1e3 / FIGURE_DRAINS
    return out


def _nonzero_proposals(first: int, drains: int) -> int:
    """Host count of the proposals ``lane * 7 + i * 13 + 1`` that are not
    0 as int32 (they wrap)."""
    lanes = np.arange(BLOCK, dtype=np.int64)
    return int(sum(((lanes * 7 + i * 13 + 1) % 2**32 != 0).sum()
                   for i in range(first, first + drains)))


def _clone(state):
    """A copy of a drain state, counters included."""
    tel = state.telemetry
    copy = tp.PipelineState(*(t.clone() for t in state[:7]))
    if tel is None:
        return copy
    fresh = tp.make_telemetry(tel.occupancy.numel() - 1,
                              device=tel.buffer.device)
    fresh.buffer.copy_(tel.buffer)
    return copy._replace(telemetry=fresh)


def phase_telemetry(dev) -> dict:
    """The aliasing ratios and the kernel's other forms (K3, K14 and the
    pinned copy against the plain loop, as phase 5 does), the counters
    re-adding, no hidden sync on the telemetry-on runs, one collect, and
    a run inside a side stream's context ordered on that stream."""
    worst = dict.fromkeys(DRAIN_KERNELS, 0)
    others = form_specs()
    for name in OTHER_FORMS:
        spec = others[name]
        arrays = headline.spec_arrays(spec)
        states = _drain_states(WINDOW, spec.num_nodes, dev)
        drains = _run_chunks(states, arrays, tp.predicate_for(*arrays, dev),
                             2**31 - 40, OTHER_CHUNKS, f"{name} W={WINDOW}",
                             worst)
        committed = int(states[0].committed)
        require(committed > (drains - 4) * BLOCK,
                f"K3 {name} committed only {committed} in {drains} drains")
    for (name, n), (window, chunks), first in itertools.product(
            (("majority3", 3), ("grid2x3_write", 6)), TELEMETRY_RUNS,
            TELEMETRY_STARTS):
        arrays = headline.spec_arrays(specs()[name])
        states = _drain_states(window, n, dev)
        at = f"{name} W={window}"
        drains = _run_chunks(states, arrays, tp.predicate_for(*arrays, dev),
                             first, chunks, at, worst)
        on = states[1]
        snap = tobs.collect(on)
        committed = int(on.committed)
        require(snap.drains == drains and sum(snap.lag_hist) == drains
                and sum(snap.occupancy) == committed
                and snap.shard_committed == (committed,)
                and snap.proposed == _nonzero_proposals(first, drains)
                and snap.pad_lanes == 0
                and committed > (drains - 4) * BLOCK,
                f"K14's counters do not re-add on {at} from {first}: "
                f"{snap}, committed {committed}")
    # No hidden sync on telemetry-on runs: under the sync debug mode any
    # synchronising CUDA call raises. Then one collect.
    arrays = headline.spec_arrays(specs()["majority3"])
    state = tp.make_state(WINDOW, 3, telemetry=True, device=dev)
    tp.run_steps_from(state, 0, 1, BLOCK, *arrays)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        at = 1
        for chunk in (1, 64, 4096):
            tp.run_steps_from(state, at, chunk, BLOCK, *arrays)
            at += chunk
    finally:
        torch.cuda.set_sync_debug_mode("default")
    snap = tobs.collect(state)
    require(snap.drains == at and snap.committed == int(state.committed),
            f"collect after the guarded runs: {snap}")
    # A run launched inside ``with torch.cuda.stream(s):`` is ordered on
    # s: the state it resumes is copied in on s behind some milliseconds
    # of work (a launch on another stream would read a stale state), and
    # K14's scratch is the side stream's own.
    for telemetry in (False, True):
        src = tp.make_state(WINDOW, 3, telemetry=telemetry, device=dev)
        tp.run_steps_from(src, 0, 10, BLOCK, *arrays)
        want = tp.run_steps_from(_clone(src), 10, 3, BLOCK, *arrays)
        target = tp.make_state(WINDOW, 3, telemetry=telemetry, device=dev)
        side = torch.cuda.Stream(dev)
        torch.cuda.synchronize(dev)
        with torch.cuda.stream(side):
            require(_build.stream_handle(dev.index) == side.cuda_stream,
                    "the drain's stream handle does not follow "
                    "torch.cuda.stream")
            _busy(dev)
            for dst, got in zip(target[:7], src[:7]):
                dst.copy_(got)
            if telemetry:
                target.telemetry.buffer.copy_(src.telemetry.buffer)
            tp.run_steps_from(target, 10, 3, BLOCK, *arrays)
        side.synchronize()
        err = _fields_err(target, want)
        if telemetry:
            err = max(err, max_abs_err(target.telemetry.buffer,
                                       want.telemetry.buffer))
        require(err == 0, f"a run (telemetry {telemetry}) launched inside "
                          f"a side stream's context was not ordered on "
                          f"that stream")
    torch.cuda.synchronize(dev)
    return worst


def phase_overhead(dev) -> tuple[dict, dict]:
    """The telemetry path: the overhead twin at the reference's widths
    and the headline width, with the reference's ``--smoke`` knobs."""
    reset_launches()
    result = telemetry_overhead.run(
        dev, smoke=True,
        widths=(*telemetry_overhead.WIDTHS, (WINDOW, BLOCK)))
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    record_drains("telemetry")
    require(all(row["arms_agree"] for row in result["pairs"].values()),
            f"the overhead arms disagree: {result['pairs']}")
    require(all(launches[name] > 0 for name in TELEMETRY_PATH),
            f"a kernel of the telemetry path never launched: {launches}")
    return result, launches


REPLY_ROWS = (1, 4096, 1 << 16)
REPLY_WIDTHS = (1, 2, 3, 5, 7, 16)


def phase_k15(dev, rng) -> int:
    """K15 against its plain version, exact: ids from a few values (ties
    everywhere) with an eighth near +-2^31, 30% of the replies invalid,
    an eighth of the rows with none valid; and an empty S."""
    worst = 0
    seen = {"tie": 0, "none_valid": 0}
    for s in REPLY_ROWS:
        for n in REPLY_WIDTHS:
            ids = rng.integers(0, 4, size=(s, n)).astype(np.int32)
            far = rng.random((s, n)) < 0.125
            ids[far] = rng.choice(INT32_EXTREMES, size=int(far.sum()))
            valid = rng.random((s, n)) < 0.7
            valid[rng.random(s) < 0.125] = False
            it, vt = (torch.from_numpy(x).to(dev) for x in (ids, valid))
            got = tv.count_matching_replies(it, vt)
            want = tv.count_matching_replies_plain(it, vt)
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
            worst = max(worst, err)
            require(err == 0, f"K15 differs from plain at S={s} N={n}")
            counts = got[1].cpu().numpy()
            seen["none_valid"] += int((counts == 0).any())
            seen["tie"] += int(n >= 2 and (counts * 2 <= n).any())
    empty = torch.zeros((0, 3), dtype=torch.int32, device=dev)
    modal, count = tv.count_matching_replies(empty, empty.bool())
    require(modal.shape == (0,) and count.shape == (0,),
            "K15 on an empty batch")
    require(all(seen.values()), f"K15 cases lack an outcome: {seen}")
    torch.cuda.synchronize(dev)
    return worst


#: libbench's dependency batch, then phase 13's shapes.
PAIR_SHAPES = ((4096, 3, 64),) + DEPSET_SHAPES


def phase_depset_rest(dev, rng) -> dict:
    """K16 and K17 in every mode against their plain versions, exact."""
    names = ("union", "intersect", "compact", "equal", "size", "contains")
    worst = dict.fromkeys(names, 0)
    seen = {"equal": 0, "unequal": 0}

    def check(name, got, want, what):
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        worst[name] = max(worst[name], err)
        require(err == 0, f"{name} differs from plain at {what}")

    for shape in PAIR_SHAPES:
        b, l, w = shape
        for base in (1 << 16, 2**31 - 1 - w // 2, -w // 2 - 5):
            for kind in ("bits", "bytes"):
                what = f"{shape} base {base} ({kind})"
                x = _depset_batch(rng, shape, base, kind, dev)
                y = _depset_batch(rng, shape, base, kind, dev)
                nx = td.normalized(x)
                for p, q in ((x, y), (x, x), (nx, nx)):
                    check("union", td.union(p, q), td.union_plain(p, q),
                          what)
                    check("intersect", td.intersect(p, q),
                          td.intersect_plain(p, q), what)
                    eq = td.equal(p, q)
                    check("equal", eq, td.equal_plain(p, q), what)
                    seen["equal"] += int(eq.any())
                    seen["unequal"] += int((~eq).any())
                check("size", td.size(x), td.size_plain(x), what)
                for executed in (
                        np.int32(base + w // 2),
                        rng.integers(base - 8, base + w + 8, size=l),
                        rng.integers(base - 8, base + w + 8, size=(1, l)),
                        rng.integers(base - 8, base + w + 8, size=(b, l))):
                    ex = torch.from_numpy(np.array(np.clip(
                        np.asarray(executed, np.int64), -2**31,
                        2**31 - 1), dtype=np.int32)).to(dev)
                    check("compact", td.compact(x, ex),
                          td.compact_plain(x, ex), f"{what} executed "
                          f"{tuple(ex.shape)}")
                leader = torch.from_numpy(rng.integers(
                    -1, l + 1, size=b).astype(np.int32)).to(dev)
                vid = torch.from_numpy(np.clip(
                    base + rng.integers(-w, 2 * w, size=b), -2**31,
                    2**31 - 1).astype(np.int32)).to(dev)
                check("contains", td.contains(x, leader, vid),
                      td.contains_plain(x, leader, vid), what)
                for lead, v in ((-1, base - 1), (l, base + w - 1),
                                (l + 3, base + w)):
                    v = min(max(v, -2**31), 2**31 - 1)
                    check("contains", td.contains(x, lead, v),
                          td.contains_plain(x, lead, v), f"{what} scalar")
    require(all(seen.values()), f"K17 equal lacks an outcome: {seen}")
    _union_cases(dev, rng, check)
    torch.cuda.synchronize(dev)
    return worst


#: K16 union's tail widths (a byte, around one 16-byte word, a prime,
#: libbench's 64 and the cap 2048) and its ``[B, L]`` (B * L not a
#: multiple of 4, and one that is).
UNION_WIDTHS = (1, 15, 16, 17, 37, 64, 2048)
UNION_ROWS = ((33, 3), (64, 4))


def _offset_batch(batch: td.DepSetBatch, wm_off: int, tail_off: int
                  ) -> td.DepSetBatch:
    """The same batch in contiguous views whose watermarks start
    ``wm_off`` int32s and tails ``tail_off`` bytes past an allocation
    (off the 16-byte grid unless 0)."""
    wm, tails, base = batch
    w_store = torch.empty(wm.numel() + wm_off, dtype=torch.int32,
                          device=wm.device)
    t_store = torch.empty(tails.numel() + tail_off, dtype=torch.uint8,
                          device=tails.device)
    w_view = w_store[wm_off:].view(wm.shape)
    t_view = t_store[tail_off:].view(tails.shape)
    w_view.copy_(wm)
    t_view.copy_(tails)
    return td.DepSetBatch(w_view, t_view, base)


def _union_cases(dev, rng, check) -> None:
    """K16's union against its plain version, exact: every width of
    ``UNION_WIDTHS`` at both ``UNION_ROWS``, watermarks near +-2^31,
    0/1 and arbitrary bytes; aliased (one batch on both sides: read
    once) and distinct inputs; views 1-15 bytes off the 16-byte grid
    (the scalar path), a and b apart and alike; ``out=`` with its own
    tail base (written with a's), and into a itself."""
    for b, l in UNION_ROWS:
        for w in UNION_WIDTHS:
            for kind in ("bits", "bytes"):
                what = f"union [{b}, {l}, {w}] ({kind})"
                x = _depset_batch(rng, (b, l, w), 1 << 16, kind, dev)
                y = _depset_batch(rng, (b, l, w), 1 << 16, kind, dev)
                for batch in (x, y):
                    ext = torch.from_numpy(rng.choice(
                        INT32_EXTREMES, size=(b, l // 2 + 1))).to(dev)
                    batch.watermarks[:, : l // 2 + 1] = ext
                for p, q in ((x, x), (x, y)):
                    check("union", td.union(p, q), td.union_plain(p, q),
                          what)
                for wm_off, tail_off in ((1, 1), (0, 7), (3, 15), (2, 0)):
                    xo = _offset_batch(x, wm_off, tail_off)
                    yo = _offset_batch(y, (wm_off + 1) % 4, tail_off)
                    for p, q in ((xo, xo), (xo, yo), (xo, y)):
                        check("union", td.union(p, q),
                              td.union_plain(p, q),
                              f"{what} views off by {wm_off} int32s, "
                              f"{tail_off} bytes")
                want = td.union_plain(x, y)
                out = td.DepSetBatch(
                    torch.full_like(x.watermarks, 7),
                    torch.full_like(x.tails, 7),
                    torch.tensor(-1, dtype=torch.int32, device=dev))
                require(td.union(x, y, out=out) is out,
                        "union(out=) returned another batch")
                check("union", out, want, f"{what} out=")
                inplace = td.DepSetBatch(x.watermarks.clone(),
                                         x.tails.clone(), x.tail_base)
                require(td.union(inplace, y, out=inplace) is inplace,
                        "union(out=a) returned another batch")
                check("union", inplace, want, f"{what} into a")


def phase_libbench(dev) -> tuple[dict, dict]:
    """The libbench path: the twin at the reference's sizes."""
    reset_launches()
    result = libbench.run(dev)
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    require(all(launches[name] > 0 for name in LIBBENCH_PATH),
            f"a kernel of the libbench path never launched: {launches}")
    return result, launches



#: K18's zones (the storm's topology) and wave sizes (1-31: a wave
#: shorter than the 16-frame head, 8-frame groups, and ragged tails).
K18_ZONES = 1000
K18_WAVES = (1, 15, 16, 17, 31, 32, 33, 500, 4096, 1 << 16)
#: Ragged lengths of the offset views, and of the transport entry.
K18_RAGGED = (1, 15, 16, 17, 31, 33, 500)


def _k18_ids(rng, n: int, z: int) -> tuple:
    """A wave's zone ids in [-1, Z-1] with every edge of JAX's index
    rule placed at both ends of the source and destination columns."""
    edges = np.array([-1, -z - 1, -z - 2, -5 * z, -2**31, z, z + 1, 7 * z,
                      2**31 - 1], np.int32)
    src = rng.integers(-1, z, n).astype(np.int32)
    dst = rng.integers(-1, z, n).astype(np.int32)
    k = min(n, len(edges))
    src[:k] = edges[:k]
    dst[n - k:] = edges[len(edges) - k:]
    return src, dst


def _k18_up(rng, z: int) -> np.ndarray:
    up = rng.random((z + 1, z + 1)) >= 0.2
    up[z, :] = True
    up[:, z] = True
    return up


def phase_k18(dev, rng) -> int:
    """K18 against its plain version (on the card and on the host), the
    transport-facing entry against it, a partition between two calls,
    and the result's ownership."""
    worst = 0
    z = K18_ZONES
    up = _k18_up(rng, z)
    up_t = torch.from_numpy(up).to(dev)
    for n in K18_WAVES:
        src, dst = _k18_ids(rng, n, z)
        src_t, dst_t = (torch.from_numpy(a).to(dev) for a in (src, dst))
        got = tsw.link_keep_mask_tensor(src_t, dst_t, up_t)
        want = tsw.link_keep_mask_plain(src_t, dst_t, up_t)
        host = tsw.link_keep_mask_plain(torch.from_numpy(src),
                                        torch.from_numpy(dst),
                                        torch.from_numpy(up))
        err = max_abs_err(got, want)
        worst = max(worst, err, max_abs_err(got.cpu(), host))
        require(err == 0 and torch.equal(got.cpu(), host),
                f"link_keep_mask differs from plain at n={n}")
        entry = tsw.link_keep_mask_cuda(src, dst, up)
        require(np.array_equal(entry, host.numpy()),
                f"link_keep_mask_cuda differs from plain at n={n}")
    # Views whose start is 1-15 elements off a 16-byte boundary, with
    # src, dst and out offset alike (a head, 8-frame groups and a tail)
    # and apart (no common aligned frame: every frame scalar).
    for n in K18_RAGGED:
        src, dst = _k18_ids(rng, n + 16, z)
        src_t, dst_t = (torch.from_numpy(a).to(dev) for a in (src, dst))
        out_t = torch.zeros(n + 16, dtype=torch.bool, device=dev)
        for off in range(1, 16):
            for d_off, o_off in ((off, off), (off, 0), ((off + 1) % 16, off),
                                 (0, (off * 7) % 16)):
                s_v, d_v = src_t[off:off + n], dst_t[d_off:d_off + n]
                want = tsw.link_keep_mask_plain(s_v, d_v, up_t)
                got = tsw.link_keep_mask_tensor(s_v, d_v, up_t)
                into = tsw.link_keep_mask_tensor(s_v, d_v, up_t,
                                                 out=out_t[o_off:])
                err = max(max_abs_err(got, want), max_abs_err(into, want))
                worst = max(worst, err)
                require(err == 0 and into.data_ptr() == out_t[o_off:]
                        .data_ptr(),
                        f"link_keep_mask differs from plain at n={n}, "
                        f"offsets src {off} dst {d_off} out {o_off}")
        # The transport entry at ragged lengths, each after a longer
        # wave (its reused buffers hold a stale tail).
        tsw.link_keep_mask_cuda(*_k18_ids(rng, 4096, z), up)
        entry = tsw.link_keep_mask_cuda(src[:n], dst[:n], up)
        require(np.array_equal(entry, tsw.link_keep_mask_plain(
            torch.from_numpy(src[:n]), torch.from_numpy(dst[:n]),
            torch.from_numpy(up)).numpy()),
            f"link_keep_mask_cuda differs from plain at n={n}")
    # The FIFO arm's wave, its ids rewritten on a side stream just before
    # the launch (from the sentinel row, every link up, to live ids).
    n = sim_core_ab.FIFO_DEPTH
    src, dst = _k18_ids(rng, n, z)
    stale = torch.full((n,), -1, dtype=torch.int32, device=dev)
    fresh = torch.from_numpy(src).to(dev)
    dst_t = torch.from_numpy(dst).to(dev)
    side_stream_check(dev, "link_keep_mask", stale, fresh,
                      lambda: tsw.link_keep_mask_tensor(stale, dst_t, up_t),
                      tsw.link_keep_mask_plain(fresh, dst_t, up_t))
    # A partition between two calls: the topology hands out a new
    # up-matrix, and the cut link's frames (both ways) flip to dropped.
    topo = GeoTopology({f"r{i}": [f"z{i}-{j}" for j in range(10)]
                        for i in range(z // 10)}, seed=SEED)
    a, b = topo.zones[3], topo.zones[517]
    ia, ib = 3, 517
    src = rng.integers(-1, z, 4096).astype(np.int32)
    dst = rng.integers(-1, z, 4096).astype(np.int32)
    src[:64:2], dst[:64:2] = ia, ib
    src[1:64:2], dst[1:64:2] = ib, ia
    before = tsw.link_keep_mask_cuda(src, dst, topo.up_matrix())
    keep = before.copy()
    require(before.flags.writeable and before.all(),
            "link_keep_mask_cuda on a healed topology dropped a frame")
    topo.partition_link(a, b)
    after = tsw.link_keep_mask_cuda(src, dst, topo.up_matrix())
    cut = ((src == ia) & (dst == ib)) | ((src == ib) & (dst == ia))
    require(np.array_equal(after, ~cut),
            "a partition between two calls did not change exactly the cut "
            "link's frames")
    require(np.array_equal(before, keep),
            "the next call overwrote an earlier result")
    after &= False  # the transport ANDs its partition mask in place
    again = tsw.link_keep_mask_cuda(src, dst, topo.up_matrix())
    require(np.array_equal(again, ~cut),
            "an in-place edit of a result reached the next call")
    torch.cuda.synchronize(dev)
    return worst


def phase_geo(dev) -> tuple[dict, dict, dict]:
    """The geo path: the geo_lt twin, then the storm twin, on one count;
    their gates raise inside ``run``. K5, K6 and K18 must have launched,
    and K7 never."""
    reset_launches()
    try:
        geo = geo_lt.run(dev)
        storm = sim_core_ab.run(dev)
    except (geo_lt.GateFailure, sim_core_ab.GateFailure) as exc:
        raise SmokeFailure(f"geo: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    require(all(launches[name] > 0 for name in GEO_PATH),
            f"a kernel of the geo path never launched: {launches}")
    require(launches["reshape_columns"] == 0,
            f"K7 ran on the geo path, whose grid universe is fixed: "
            f"{launches}")
    return geo, storm, launches


def phase_sharded(dev) -> tuple[dict, dict, dict]:
    """The sharded path on four ranks that share the card (and on one
    rank per card where there are two or more cards): the gates raise
    inside ``multichip.check``. Returns the figures, the summed launches
    of the path and each kernel's largest error."""
    del dev
    reset_launches()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    errors = dict.fromkeys(SHARDED_PATH, 0)
    cases = {}

    def record(world, group, slot, spec, telemetry, key):
        try:
            ranks = multichip.check(world, group, slot, spec, telemetry,
                                    window=WINDOW, block=BLOCK,
                                    drains=SHARDED_DRAINS,
                                    run_drains=SHARDED_RUN)
        except multichip.WorldFailure as exc:
            raise SmokeFailure(f"sharded: {exc}") from exc
        for r in ranks:
            for name in SHARDED_PATH:
                launches[name] += r["launches"][name] \
                    + r["run_launches"][name]
                errors[name] = max(errors[name], r["errors"][name])
        cases[key] = multichip.check_summary(ranks)

    t0 = time.perf_counter()
    with multichip.RankWorld(4, device_type="cuda") as world:
        backend = world.backend
        spawn_s = time.perf_counter() - t0
        for group, slot, spec in SHARDED_MESHES:
            for telemetry in (False, True):
                record(world, group, slot, spec, telemetry,
                       f"{group}x{slot} {spec} telemetry "
                       f"{'on' if telemetry else 'off'}")
    nccl = "not run: one card (NCCL takes one rank per card)"
    cards = torch.cuda.device_count()
    if cards >= 2:
        k = min(cards, 4)
        with multichip.RankWorld(k, device_type="cuda") as world:
            require(world.backend == "nccl",
                    f"{k} ranks on {cards} cards chose {world.backend}")
            for telemetry in (False, True):
                record(world, 1, k, "majority3", telemetry,
                       f"1x{k} majority3 telemetry "
                       f"{'on' if telemetry else 'off'} over nccl")
        nccl = f"1x{k} over nccl, one rank per card"
    return ({"backend": backend, "ranks": 4, "spawn_s": spawn_s,
             "cases": cases, "nccl": nccl}, launches, errors)


#: K19's structures held in phase 25 in one process, no ranks: ((group,
#: slot), spec) -- majorities of 3k acceptors over three group shards
#: (a shard of k = 1-16 acceptors and one group: the one-group forms; a
#: majority of one or two acceptors is a grid to the reference's gate),
#: 17 acceptors whole (generic), the 2x3 grid over three group shards (two
#: groups) and two (whole write rows; and read rows), the four meshes of
#: the sharded path, and structures of no form (a permuted grid, a 2x3
#: grid whole, a 3x3 grid whole, one acceptor).
ROWS2x3 = [[0, 1, 2], [3, 4, 5]]
K19_CASES = ([((3, 1), SimpleMajority(range(3 * k)).write_spec())
              for k in range(1, 17)]
             + [((1, 1), SimpleMajority(range(n)).write_spec())
                for n in (1, 17)]
             + [((3, 1), Grid(ROWS2x3).write_spec()),
                ((2, 2), Grid(ROWS2x3).write_spec()),
                ((2, 1), Grid(ROWS2x3).read_spec()),
                ((1, 4), SimpleMajority(range(3)).write_spec()),
                ((1, 3), SimpleMajority(range(3)).write_spec()),
                ((2, 2), Grid([[0, 2, 4], [1, 3, 5]]).write_spec()),
                ((1, 4), Grid(ROWS2x3).write_spec()),
                ((3, 1), Grid([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
                 .read_spec()),
                ((1, 1), Grid([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
                 .write_spec())])
#: (window, block) of each case: a ring of 16 blocks, one block (the old
#: block is the new one) and two; and the sharded path's full width.
K19_SIZES = ((4096, 256), (256, 256), (512, 256))
#: Drains of each run: from 0 and across the int32 wrap.
K19_STARTS = (0, 2**31 - 2)
K19_DRAINS = 3


def _k19_forms(dev, rng) -> tuple[int, dict]:
    """K19 in every instantiated form and the generic template against
    ``shard_vote_count_plain``, one process (a phase alone needs no
    collective): each case of ``K19_CASES`` on up to four of its mesh's
    ranks, telemetry off and on, at ``K19_SIZES`` (and the four sharded
    meshes at window 2^20, block 2^15), boards of arbitrary vote bytes,
    three drains from 0 and from 2^31 - 2; the partials, the vote board
    and the commands equal after every drain (error 0). Returns the
    error and the forms run."""
    worst, forms = 0, {}
    for (group, slot), spec in K19_CASES:
        n = spec.num_nodes
        pred = tq.make_predicate(*spec.as_arrays(), device=dev)
        sizes = K19_SIZES
        if (group, slot) in ((1, 4), (1, 3)) or n == 6 and group > 1 \
                and spec.combine == ALL:
            sizes = sizes + ((WINDOW, BLOCK),)
        for rank in range(min(group * slot, 4)):
            mesh = Mesh(group, slot, rank, dev)
            for (window, block), telemetry in itertools.product(
                    sizes, (False, True)):
                states = [tp.make_sharded_state(mesh, window, block, n,
                                                telemetry=telemetry)[0]
                          for _ in range(2)]
                votes = torch.from_numpy(rng.integers(
                    0, 256, size=tuple(states[0].votes.shape),
                    dtype=np.uint8)).to(dev)
                for st in states:
                    st.votes.copy_(votes)
                plans = [tp.make_shard_plan(mesh, block, pred,
                                            telemetry=telemetry)
                         for _ in range(2)]
                form = tp.shard_form(plans[0])
                forms[str(form)] = forms.get(str(form), 0) + 1
                for start in K19_STARTS:
                    for k in range(K19_DRAINS):
                        i = tp._wrap32(start + k)
                        tp.shard_vote_count(states[0], i, plans[0])
                        tp.shard_vote_count_plain(states[1], i, plans[1])
                        err = max(max_abs_err(plans[0].parts, plans[1].parts),
                                  max_abs_err(states[0].votes,
                                              states[1].votes),
                                  max_abs_err(states[0].commands,
                                              states[1].commands))
                        worst = max(worst, err)
                        require(err == 0, f"K19 {form} differs from plain "
                                          f"on ({group}, {slot}) rank "
                                          f"{rank}, W={window} B={block} "
                                          f"telemetry {telemetry}, drain "
                                          f"{i}")
    torch.cuda.synchronize(dev)
    want = {str(("groups", k, 1)) for k in range(1, 17)} | {
        str(("groups", 2, 2)), str(("rows", 3, 3))}
    require(want <= set(forms) and any("generic" in f for f in forms),
            f"K19's forms not all run: {sorted(forms)}")
    return worst, forms


def _k20_forms(dev, rng) -> tuple[int, dict]:
    """K20 in every instantiated form and the generic template against
    ``shard_commit_plain``, one process: each case of ``K19_CASES`` on up
    to four of its mesh's ranks, telemetry off and on, at ``K19_SIZES``
    (rings of 16, 1 and 2 blocks; and the sharded meshes at window 2^20,
    block 2^15), boards of arbitrary vote bytes, chosen flags and
    commands, group-reduced partials of arbitrary counts (the occupancy
    clamps below 0 and past n included), three drains from 0 and from
    2^31 - 2, each into a random row of the slot table; the board, the
    slot columns and the whole table equal after every drain (error 0).
    Returns the error and the forms run."""
    worst, forms = 0, {}
    for (group, slot), spec in K19_CASES:
        n = spec.num_nodes
        pred = tq.make_predicate(*spec.as_arrays(), device=dev)
        sizes = K19_SIZES
        if (group, slot) in ((1, 4), (1, 3)) or n == 6 and group > 1 \
                and spec.combine == ALL:
            sizes = sizes + ((WINDOW, BLOCK),)
        for rank in range(min(group * slot, 4)):
            mesh = Mesh(group, slot, rank, dev)
            for (window, block), telemetry in itertools.product(
                    sizes, (False, True)):
                states = [tp.make_sharded_state(mesh, window, block, n,
                                                telemetry=telemetry)[0]
                          for _ in range(2)]
                w_local = states[0].votes.shape[1]
                fill = {"votes": rng.integers(0, 256, size=tuple(
                            states[0].votes.shape), dtype=np.uint8),
                        "chosen": rng.random(w_local) < 0.3,
                        "commands": rng.integers(-2**31, 2**31, size=w_local,
                                                 dtype=np.int64
                                                 ).astype(np.int32)}
                for st in states:
                    for name, values in fill.items():
                        getattr(st, name).copy_(torch.from_numpy(values))
                plans = [tp.make_shard_plan(mesh, block, pred,
                                            telemetry=telemetry)
                         for _ in range(2)]
                form = tp.commit_form(plans[0])
                forms[str(form)] = forms.get(str(form), 0) + 1
                for start in K19_STARTS:
                    for k in range(K19_DRAINS):
                        i = tp._wrap32(start + k)
                        parts = torch.from_numpy(rng.integers(
                            -1, n + 3, size=tuple(plans[0].parts.shape),
                            dtype=np.int64).astype(np.int32)).to(dev)
                        row = int(rng.integers(0, tp.RUN_ROWS))
                        for plan in plans:
                            plan.parts.copy_(parts)
                        tp.shard_commit(states[0], i, plans[0], row)
                        tp.shard_commit_plain(states[1], i, plans[1], row)
                        err = max([max_abs_err(plans[0].slot, plans[1].slot)]
                                  + [max_abs_err(getattr(states[0], f),
                                                 getattr(states[1], f))
                                     for f in ("votes", "chosen",
                                               "commands", "results")])
                        worst = max(worst, err)
                        require(err == 0, f"K20 {form} differs from plain "
                                          f"on ({group}, {slot}) rank "
                                          f"{rank}, W={window} B={block} "
                                          f"telemetry {telemetry}, drain "
                                          f"{i}, row {row}")
    torch.cuda.synchronize(dev)
    want = {str(("groups", k, 1)) for k in range(1, 17)} | {
        str(("groups", 2, 2)), str(("rows", 3, 3))}
    require(want <= set(forms) and any("generic" in f for f in forms),
            f"K20's forms not all run: {sorted(forms)}")
    return worst, forms


#: K21's runs in phase 25: a drain, runs of 8 and 64, the table's cap.
K21_RUNS = (1, 8, 64, tp.RUN_ROWS)


def _k21_runs(dev, rng) -> tuple[int, dict]:
    """K21's run fold against ``shard_fold_plain`` over ``K21_RUNS``
    rows, telemetry off and on, on rank 1 of a (1, 4) mesh of five
    acceptors: tables of random words (half of them anywhere in int32),
    committed, sm_state and the counters random, the run starting at
    drain 0 and at 2^31 - 20 (the index wraps inside the longer runs);
    the scalars, the telemetry buffer and the whole table (the folded
    rows zeroed) equal (error 0). Returns the error and the runs."""
    spec = SimpleMajority(range(5)).write_spec()
    pred = tq.make_predicate(*spec.as_arrays(), device=dev)
    mesh = Mesh(1, 4, 1, dev)
    worst, runs = 0, {}
    for telemetry, k, start in itertools.product(
            (False, True), K21_RUNS, (0, 2**31 - 20)):
        pairs = []
        plan0 = tp.make_shard_plan(mesh, BLOCK, pred, telemetry=telemetry)
        shape = tuple(plan0.slot.shape)
        table = np.where(rng.random(shape) < 0.5,
                         rng.integers(-2**31, 2**31, size=shape),
                         rng.integers(0, 4096, size=shape)).astype(np.int32)
        scalars = rng.integers(-2**31, 2**31, size=3).astype(np.int32)
        tel = rng.integers(0, 1 << 20, size=64).astype(np.int32)
        for _ in range(2):
            state, _ = tp.make_sharded_state(mesh, 1 << 16, BLOCK, 5,
                                             telemetry=telemetry)
            plan = tp.make_shard_plan(mesh, BLOCK, pred, telemetry=telemetry)
            plan.slot.copy_(torch.from_numpy(table))
            for t, v in zip(state[4:7], scalars):
                t.fill_(int(v))
            if telemetry:
                buf = state.telemetry.buffer
                buf.copy_(torch.from_numpy(tel[:buf.numel()]))
            pairs.append((state, plan))
        tp.shard_fold(pairs[0][0], start, pairs[0][1], k)
        tp.shard_fold_plain(pairs[1][0], start, pairs[1][1], k)
        (a, pa), (b, pb) = pairs
        err = max([max_abs_err(x, y) for x, y in zip(a[4:7], b[4:7])]
                  + [max_abs_err(pa.slot, pb.slot)]
                  + ([max_abs_err(a.telemetry.buffer, b.telemetry.buffer)]
                     if telemetry else []))
        worst = max(worst, err)
        require(err == 0, f"K21 over {k} rows from drain {start}, telemetry "
                          f"{telemetry}, differs from plain")
        runs[k] = runs.get(k, 0) + 1
    torch.cuda.synchronize(dev)
    return worst, runs


def _shard_kernel_figures(dev, rng) -> dict:
    """K1, K2, K4 and K6 at the shapes one rank's shard of phase 26's
    (1, 4) meshes gives them: wrapper call time (CUDA events), device
    time (profiler), the plain version's time and the bound. K1 on the
    synchronous tracker's 4096-slot drain (whole on every rank); K2 on a
    4096-slot block of the 2^18-column local window; K4 on a 256-lane
    chunk of it; K6 on a 256-lane chunk of the epoch board's 2^12-column
    local window (N = 4, K = 2)."""
    spec = specs()["majority3"]
    n = spec.num_nodes
    pred = predicate(spec, dev)
    g = pred.masks.shape[0]
    w_local, e_local, width, chunk = WINDOW // 4, EPOCH_WINDOW // 4, 4096, 256
    votes = torch.from_numpy(
        (rng.random((n, width)) < 0.6).astype(np.uint8)).to(dev)
    k2_k, k2_p = (tq.make_vote_board(w_local, n, device=dev)
                  for _ in range(2))
    (k4_k, k4_p), k4_lanes, k4_cols = _sparse_case(dev, rng, n, w_local,
                                                  chunk)
    universe = tuple(range(4))
    planes = tq.make_multi_predicate(*pad_specs(
        [SimpleMajority(m).write_spec().reindexed(universe)
         for m in ((0, 1, 2), (0, 1, 3))]), device=dev)
    kk, kg, kn = planes.masks.shape
    plane_bytes = 4 * kk * kg * kn + 4 * kk * kg + kk + 4 * (kk - 1)
    bounds = torch.tensor([EPOCH_WINDOW // 2], dtype=torch.int32,
                          device=dev)
    (k6_k, k6_p), k6_lanes, k6_cols = _sparse_case(dev, rng, kn, e_local,
                                                  chunk)
    cases = (
        ("quorum_hit", lambda: tq.quorum_hit(votes, pred),
         lambda: tq.quorum_hit_plain(votes, pred), "quorum_hit_kernel",
         (n + 1) * width, (2 * g * n + 2 * g) * width,
         f"N={n} B={width}"),
        ("record_block",
         lambda: tq.record_block(k2_k, 0, 0, votes, 0, pred),
         lambda: tq.record_block_plain(k2_p, 0, 0, votes, 0, pred),
         "record_block_run_kernel", (3 * n + 19) * width,
         (6 * n + 2 * g * n + 30) * width,
         f"N={n} B={width} w_local={w_local}"),
        ("record_and_check",
         lambda: tq.record_and_check(k4_k, k4_lanes, pred),
         lambda: tq.record_and_check_plain(k4_p, k4_lanes, pred),
         "record_and_check_run_kernel", 21 * chunk + 2 * (9 + n) * k4_cols,
         (40 + 2 * g * n) * chunk, f"N={n} B={chunk} w_local={w_local}"),
        ("record_and_check_epochs",
         lambda: tq.record_and_check_epochs(k6_k, k6_lanes, bounds, planes),
         lambda: tq.record_and_check_epochs_plain(k6_p, k6_lanes, bounds,
                                                  planes),
         "record_and_check_epochs_run_kernel",
         21 * chunk + 2 * (9 + kn) * k6_cols + plane_bytes,
         (42 + 2 * kg * kn) * chunk,
         f"N={kn} K={kk} B={chunk} w_local={e_local}"),
    )
    out = {}
    for name, fn, plain, kname, nbytes, ops, shape in cases:
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / INT_OPS_PER_S * 1e3
        out[name] = {"ms": time_ms(fn, 2000), "plain_ms": time_ms(plain, 100),
                     "device_ms": device_ms(fn, kname),
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations", "library_ms": None, "shape": shape}
    return out


def _board_summary(result: dict, figures: dict) -> dict:
    """Phase 26's figures: per tracker arm (rank 0) the drains, host ms
    per drain, all-reduces per drain and their share of the drain (each
    all-reduce's synchronised host ms times the count), and the kernels'
    device ms per drain (rank 0's launches per drain times each kernel's
    device time at the shard's shape); the slowest rank's ms per drain;
    the all-reduce's ms alone."""
    ranks = result["ranks"]
    lead = next(r for r in ranks if r["rank"] == 0)
    reduce_ms = lead["allreduce_ms"]
    arms = {}
    for name, arm in lead["arms"].items():
        drains = arm["drains"]
        per_drain = arm["allreduces"] / drains
        # A dense part's all-reduce carries up to 4096 bytes, a sparse
        # part's 256: bound the share by the wider one.
        kernels = sum(arm["launches"][k] / drains
                      * (figures[k]["device_ms"] or figures[k]["ms"])
                      for k in figures if arm["launches"].get(k))
        arms[name] = {
            "drains": drains, "chosen": arm["chosen"],
            "run_s": arm["run_s"], "drain_ms_median": arm["drain_ms_median"],
            "drain_ms_mean": arm["drain_ms_mean"],
            "drain_ms_mean_slowest_rank": max(
                r["arms"][name]["drain_ms_mean"] for r in ranks
                if name in r["arms"]),
            "allreduces_per_drain": per_drain,
            "allreduce_ms_per_drain_at_most": per_drain * reduce_ms[4096],
            "kernels_device_ms_per_drain": kernels,
            "launches_rank0": arm["launches"]}
    return {"backend": lead["backend"], "ranks": len(ranks),
            "allreduce_ms_rank0": reduce_ms, "arms": arms,
            "expectations_s": result["expect_s"],
            "shard_kernels": figures}


def phase_sharded_board(dev, rng) -> tuple[dict, dict, dict]:
    """The sharded vote board's path on four ranks that share the card
    (and on one rank per card where there are two or more cards); the
    gates raise inside ``multichip_board.check_board``. Returns the
    figures, the summed launches of the path and each kernel's largest
    error against its plain version."""
    reset_launches()
    errors: dict = {}
    t0 = time.perf_counter()

    def run(world, **kw):
        try:
            result = multichip_board.check_board(world, device=dev, **kw)
        except multichip.WorldFailure as exc:
            raise SmokeFailure(f"sharded board: {exc}") from exc
        for r in result["ranks"]:
            for name, err in (r["errors"] or {}).items():
                errors[name] = max(errors.get(name, 0), err)
        return result

    with multichip.RankWorld(4, device_type="cuda") as world:
        spawn_s = time.perf_counter() - t0
        result = run(world)
    launches = {name: result["launches"].get(name, 0) for name in WRAPPERS}
    summary = _board_summary(result, _shard_kernel_figures(dev, rng))
    summary["spawn_s"] = spawn_s
    summary["nccl"] = "not run: one card (NCCL takes one rank per card)"
    cards = torch.cuda.device_count()
    if cards >= 2:
        k = min(cards, 4)
        with multichip.RankWorld(k, device_type="cuda") as world:
            require(world.backend == "nccl",
                    f"{k} ranks on {cards} cards chose {world.backend}")
            arms = {f"{name} 1x{k}": ((1, k), *arm[1:]) for name, arm in
                    multichip_board.BOARD_ARMS.items()}
            nccl = run(world, arms=arms, side=(1, k))
        summary["nccl"] = {
            "ranks": k, "backend": "nccl",
            "allreduce_ms_rank0": next(r for r in nccl["ranks"]
                                       if r["rank"] == 0)["allreduce_ms"],
            "drain_ms_median": {name: arm["drain_ms_median"] for name, arm in
                                next(r for r in nccl["ranks"] if r["rank"]
                                     == 0)["arms"].items()}}
    return summary, launches, errors


def time_ms(fn, iters: int, warm: int = 20) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: The in-turn order of phase 28's kernel-against-library timing (K18
#: also with the main path's reused out= buffer), repeated
#: ``TURN_ROUNDS`` times: each of the three gets six blocks.
TURN_ORDER = ("kernel", "library", "out", "out", "library", "kernel")
TURN_ROUNDS = 3
TURN_CALLS = 400


def in_turns(fns: dict) -> dict:
    """CUDA-event ms per call of each of ``fns`` (keyed as in
    ``TURN_ORDER``), timed in blocks of ``TURN_CALLS`` calls in turns;
    ``{key: (median of its blocks, [blocks])}``."""
    for fn in fns.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    blocks = {key: [] for key in fns}
    for _ in range(TURN_ROUNDS):
        for key in TURN_ORDER:
            if key not in fns:
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(TURN_CALLS):
                fns[key]()
            end.record()
            end.synchronize()
            blocks[key].append(start.elapsed_time(end) / TURN_CALLS)
    return {key: (statistics.median(b), b) for key, b in blocks.items()}


def device_ms(fn, kernel: str, iters: int = 200):
    """Mean device time of ``kernel`` from the profiler's CUDA trace, or
    None when the trace shows no device time for it."""
    from torch.profiler import profile, ProfilerActivity

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if kernel in evt.key and evt.count:
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = getattr(evt, "cuda_time_total", 0)
            if total:
                return total / evt.count / 1e3
    return None


#: Drains per run where the drain kernels are timed alone (phase 28's
#: rows): the telemetry twin's chunk, one launch a run.
FIGURE_DRAINS = 1024
#: Launches timed one by one for a drain row's device time.
FIGURE_LAUNCHES = 21


def launch_ms(fn, launches: int = FIGURE_LAUNCHES) -> float:
    """Device ms of one call of ``fn`` that is ONE long launch: CUDA
    events recorded on the stream right before and after each of
    ``launches`` calls (after one warm call), the median. A millisecond
    of sleep is queued ahead of each start event, so the launch is
    enqueued before the start event runs and the events bracket the
    kernel alone, not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(launches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_block_sweep(dev) -> dict:
    """The block-size frontier (``bench/block_sweep.py``) at cut
    repeats: every block size of the reference at window 2^20, one timed
    run each after a warm run, a short latency distribution."""
    return block_sweep.run(dev, repeats=1, latency_budget_s=2.0,
                           target_samples=64)


def _sparse_case(dev, rng, n: int, window: int, b: int):
    """Two fresh boards and one chunk of ``b`` straggler lanes (distinct
    slots behind a frontier, valid, round 0), as the tracker sends K4
    and K6; also the count of distinct columns the chunk touches."""
    true = rng.choice(window, size=b, replace=False).astype(np.int64)
    lanes = torch.from_numpy(tq.pack_lanes(
        true % window, true, rng.integers(0, n, size=b),
        np.zeros(b, np.int32), np.ones(b, bool))).to(dev)
    boards = [tq.make_vote_board(window, n, device=dev) for _ in range(2)]
    return boards, lanes, len(np.unique(true % window))


def phase_figures(dev, rng, paths: dict, errors: dict) -> list:
    """Per kernel at the main paths' shapes: wrapper call time (CUDA
    events), device time (profiler), the plain version's time, and the
    bound from the bytes and integer operations the call needs.
    ``paths`` maps each path's name to its launch counts."""
    spec = specs()["majority3"]
    n = spec.num_nodes
    pred = predicate(spec, dev)
    g = pred.masks.shape[0]
    votes = torch.from_numpy(
        (rng.random((n, BLOCK)) < 0.6).astype(np.uint8)).to(dev)
    board_k = tq.make_vote_board(WINDOW, n, device=dev)
    board_p = tq.make_vote_board(WINDOW, n, device=dev)
    # K3, K14 and the pinned copy: one call is a run of FIGURE_DRAINS
    # drains (one launch); the plain versions run them drain by drain.
    forms = drain_forms(dev)
    drain_arrays = headline.spec_arrays(spec)
    drain_at = {}

    def drain_run(key, state, run):
        drain_at[key] = 0

        def call():
            run(state, drain_at[key], FIGURE_DRAINS, BLOCK, *drain_arrays)
            drain_at[key] = tp._wrap32(drain_at[key] + FIGURE_DRAINS)
        return call

    def drain_plain(key, state, step):
        drain_at[key] = 0

        def call():
            for k in range(FIGURE_DRAINS):
                step(state, tp._wrap32(drain_at[key] + k), BLOCK, pred)
            drain_at[key] = tp._wrap32(drain_at[key] + FIGURE_DRAINS)
        return call

    k3 = drain_run("k3", tp.make_state(WINDOW, n, device=dev),
                   tp.run_steps_from)
    k3_plain = drain_plain("k3p", tp.make_state(WINDOW, n, device=dev),
                           tp.steady_state_step_plain)

    # K4: one scatter chunk of the pipelined tracker (max_chunk lanes).
    chunk = 256
    (k4_k, k4_p), k4_lanes, k4_cols = _sparse_case(dev, rng, n, WINDOW,
                                                  chunk)
    # K5: the pipelined prewarm's release of max_dense columns.
    rel = 4096
    k5_k, k5_p = (tq.make_vote_board(WINDOW, n, device=dev)
                  for _ in range(2))
    k5_slots = torch.arange(rel, dtype=torch.int32, device=dev)
    k5_valid = torch.ones(rel, dtype=torch.bool, device=dev)
    # K6: the epoch tracker after the handover: N = 4, K = 2, window 2^14.
    universe = tuple(range(4))
    planes = tq.make_multi_predicate(*pad_specs(
        [SimpleMajority(m).write_spec().reindexed(universe)
         for m in ((0, 1, 2), (0, 1, 3))]), device=dev)
    kk, kg, kn = planes.masks.shape
    plane_bytes = 4 * kk * kg * kn + 4 * kk * kg + kk + 4 * (kk - 1)
    bounds = torch.tensor([EPOCH_WINDOW // 2], dtype=torch.int32,
                          device=dev)
    (k6_k, k6_p), k6_lanes, k6_cols = _sparse_case(dev, rng, kn,
                                                  EPOCH_WINDOW, chunk)
    present = torch.from_numpy(
        (rng.random((chunk, kn)) < 0.6).astype(np.int32)).to(dev)
    cfg = torch.from_numpy(rng.integers(0, kk, size=chunk).astype(
        np.int32)).to(dev)
    # K7: the epoch board's reshape at the handover, [3, W] -> [4, W].
    k7_block = torch.from_numpy((rng.random((3, EPOCH_WINDOW)) < 0.5)
                                .astype(np.uint8)).to(dev)
    k7_cmap_np = np.asarray([0, 1, 2, -1], dtype=np.int32)
    k7_cmap = torch.from_numpy(k7_cmap_np).to(dev)

    # K8: the Leader's staged call on the smoke's failover window,
    # [2^13, 3], written into recovery_matrices' pinned views as the
    # Leader writes them (its row); the lean wrapper on the bench's
    # window, [2^16, 3] (the row's secondary figures).
    k8_rounds, k8_ids = _k8_inputs(rng, n, dev)
    k8_np = tuple(t.cpu().numpy() for t in _k8_inputs(
        rng, n, dev, pad=FAILOVER_ROWS // 4, rows=FAILOVER_ROWS))
    k8_views = tv.recovery_matrices(FAILOVER_ROWS, n, dev)
    k8_views[0][...], k8_views[1][...] = k8_np

    def k8_plain():
        got = tv.safe_values_plain(*(torch.from_numpy(a).to(dev)
                                     for a in k8_np))
        return tuple(t.cpu().numpy() for t in got)

    # K9/K10: depset_lt's drain batch, [4096, 3, 32]; K10 in seq mode:
    # the cluster's slow-path quorum, [4, 5, 8]; K11: the fast path's
    # three identical replies, [3, 5, 8] (every byte compared).
    lt_batch = _depset_batch(rng, (4096, 3, 32), 1000, "bits", dev)
    slow = _depset_batch(rng, (4, 5, 8), 1000, "bits", dev)
    slow_seqs = torch.zeros(4, dtype=torch.int32, device=dev)
    one = _depset_batch(rng, (1, 5, 8), 1000, "bits", dev)
    fast = td.DepSetBatch(one.watermarks.repeat(3, 1),
                          one.tails.repeat(3, 1, 1), one.tail_base)
    depset_cu = "frankenpaxos_tpu_torch/ops/csrc/depset.cu"
    depset_ref = "frankenpaxos_tpu/ops/depset.py"

    # K12: a GC role's fold, the f + 1 = 2 quorum watermark of the
    # [replicas, leaders] = [3, 2] frontier matrix, read by columns.
    frontiers = torch.from_numpy(rng.integers(
        0, 1 << 14, size=(3, 2)).astype(np.int32)).to(dev)
    k12_rows, k12_q = frontiers.t(), 2
    k12_b, k12_n = k12_rows.shape
    require(torch.equal(torch.kthvalue(k12_rows, k12_n - k12_q + 1,
                                       dim=-1).values,
                        tw.quorum_watermark(k12_rows, k12_q)),
            "torch.kthvalue does not compute K12's function")
    # K13: libbench's [4096] present vector, one False in the middle;
    # the prefix (2048 + the zero) is read, one int32 written.
    k13 = torch.ones(4096, dtype=torch.bool, device=dev)
    k13[2048] = False
    watermark_cu = "frankenpaxos_tpu_torch/ops/csrc/watermark.cu"
    watermark_ref = "frankenpaxos_tpu/ops/watermark.py"
    library = {"quorum_watermark": lambda: torch.kthvalue(
        k12_rows, k12_n - k12_q + 1, dim=-1)}

    # K14 and the pinned K3 copy: the headline's drain, telemetry on, and
    # the overhead bench's baseline arm; the counters are n + 22 words.
    k14 = drain_run("k14", tp.make_state(WINDOW, n, telemetry=True,
                                         device=dev), tp.run_steps_from)
    k14_plain = drain_plain("k14p", tp.make_state(WINDOW, n, telemetry=True,
                                                  device=dev),
                            tp.steady_state_step_plain)
    pinned = drain_run("pin", tpin.make_state(WINDOW, n, device=dev),
                       tpin.run_steps_from)
    pinned_plain = drain_plain("pinp", tpin.make_state(WINDOW, n,
                                                       device=dev),
                               tpin.steady_state_step_plain)
    tel_words = 4 * tp.make_telemetry(n, device=dev).buffer.numel()
    # The drain state's bytes: votes and chosen (N + 1 a slot), commands
    # and results (8 a slot), three int32 scalars.
    state_bytes = (n + 9) * WINDOW + 12
    k3_ops = (2 * (10 * n + 2 * g * n + 8) + 30) * BLOCK
    # K15 at S = 2^16, N = 5: ids from a few values, 70% valid.
    k15_s, k15_n = 1 << 16, 5
    k15_ids = torch.from_numpy(rng.integers(
        0, 4, size=(k15_s, k15_n)).astype(np.int32)).to(dev)
    k15_valid = torch.from_numpy(rng.random((k15_s, k15_n)) < 0.7).to(dev)
    # K16 / K17: libbench's [4096, 3, 64] batch at tail base 2^16 (K16's
    # union is libbench's call); executed per column, [L]; a leader and
    # a vid per row.
    lib_a = _depset_batch(rng, (4096, 3, 64), 1 << 16, "bits", dev)
    lib_b = _depset_batch(rng, (4096, 3, 64), 1 << 16, "bits", dev)
    lib_rows = lib_a.watermarks.shape[0]
    lib_exec = torch.from_numpy(rng.integers(
        (1 << 16) - 8, (1 << 16) + 72, size=3).astype(np.int32)).to(dev)
    lib_leader = torch.from_numpy(rng.integers(
        0, 3, size=lib_rows).astype(np.int32)).to(dev)
    lib_vid = torch.from_numpy(rng.integers(
        (1 << 16) - 64, (1 << 16) + 128, size=lib_rows).astype(
        np.int32)).to(dev)
    lib_cells = lib_a.tails.numel() + lib_a.watermarks.numel()

    # K18: the FIFO arm's wave, 32768 frames over the storm's [1001, 1001]
    # up-matrix; the library call takes in-range ids as int64. Bytes:
    # the ids and the mask (9 per frame) and each distinct matrix entry
    # the wave gathers (JAX's index rule applied), read once.
    k18_n = sim_core_ab.FIFO_DEPTH
    k18_up_np = _k18_up(rng, K18_ZONES)
    k18_up = torch.from_numpy(k18_up_np).to(dev)
    k18_src_np, k18_dst_np = (rng.integers(0, K18_ZONES + 1, k18_n)
                              .astype(np.int32) for _ in range(2))
    k18_src, k18_dst = (torch.from_numpy(a).to(dev)
                        for a in (k18_src_np, k18_dst_np))
    k18_src_l, k18_dst_l = k18_src.long(), k18_dst.long()
    require(torch.equal(k18_up[k18_src_l, k18_dst_l],
                        tsw.link_keep_mask_tensor(k18_src, k18_dst, k18_up)),
            "up[src, dst] does not compute K18's function")
    k18_pairs = len(np.unique(k18_src_np.astype(np.int64)
                              * (K18_ZONES + 1) + k18_dst_np))
    library["link_keep_mask"] = lambda: k18_up[k18_src_l, k18_dst_l]
    k18_out = torch.empty(k18_n, dtype=torch.bool, device=dev)
    with_out = {"link_keep_mask": lambda: tsw.link_keep_mask_tensor(
        k18_src, k18_dst, k18_up, out=k18_out)}

    # K19-K21: rank 0's shard of phase 25's (1, 4) majority-3 mesh
    # (b_local 8192 of a 2^18-slot local window), telemetry off. A phase
    # alone needs no collective, so a mesh without process groups serves.
    sh_mesh = Mesh(1, 4, 0, dev)
    sh_b, sh_s = tp.local_block(BLOCK, 4)[0], 4
    sh_states = {key: tp.make_sharded_state(sh_mesh, WINDOW, BLOCK, n)[0]
                 for key in ("k19", "p19", "k20", "p20", "k21", "p21")}
    sh_plans = {key: tp.make_shard_plan(sh_mesh, BLOCK, pred)
                for key in sh_states}
    sh_at = dict.fromkeys(sh_states, 0)

    def shard_call(key, fn):
        def run():
            fn(sh_states[key], sh_at[key], sh_plans[key])
            sh_at[key] += 1
        return run

    sh_rows = sh_plans["k19"].parts.shape[1]
    # The pinned copies on the same shard.
    pin_states = {key: tpin.make_sharded_state(sh_mesh, WINDOW, BLOCK, n)[0]
                  for key in ("k19", "p19", "k20", "p20", "k21", "p21")}
    pin_plans = {key: tpin.make_shard_plan(sh_mesh, BLOCK, pred)
                 for key in pin_states}
    pin_at = dict.fromkeys(pin_states, 0)

    def pinned_call(key, fn):
        def run():
            fn(pin_states[key], pin_at[key], pin_plans[key])
            pin_at[key] += 1
        return run

    pinned_cu = "frankenpaxos_tpu_torch/ops/csrc/pipeline_sharded_baseline.cu"
    pinned_ref = "frankenpaxos_tpu/bench/pipeline_baseline.py"
    sharded_cu = "frankenpaxos_tpu_torch/ops/csrc/pipeline_sharded.cu"
    sharded_ref = "frankenpaxos_tpu/bench/pipeline.py"
    sh_shape = f"N={n} b_local={sh_b} w_local={WINDOW // sh_s}, mesh (1, 4)"

    quorum, epoch = (f"frankenpaxos_tpu_torch/ops/csrc/{f}.cu"
                     for f in ("quorum", "epoch"))
    ref = "frankenpaxos_tpu/ops/quorum.py"
    cases = [
        # name, kernel fn, plain fn, device kernel name, bytes, int ops,
        # source, replaces, shape
        ("quorum_hit", lambda: tq.quorum_hit(votes, pred),
         lambda: tq.quorum_hit_plain(votes, pred), "quorum_hit_kernel",
         (n + 1) * BLOCK, (2 * g * n + 2 * g) * BLOCK, quorum, f"{ref}:77",
         f"N={n} B={BLOCK}"),
        ("record_block",
         lambda: tq.record_block(board_k, 0, 0, votes, 0, pred),
         lambda: tq.record_block_plain(board_p, 0, 0, votes, 0, pred),
         "record_block_run_kernel", (3 * n + 19) * BLOCK,
         (6 * n + 2 * g * n + 30) * BLOCK, quorum, f"{ref}:267",
         f"N={n} B={BLOCK} W={WINDOW}"),
        # K3 (and K14, the pinned copy) per run of FIGURE_DRAINS drains:
        # the state read once and written once, and each drain's integer
        # operations (the reference's (5N+17)·B bytes a drain go beside
        # the row as reference_bytes).
        ("steady_state_step", k3, k3_plain, "run_steps_kernel",
         2 * state_bytes, k3_ops * FIGURE_DRAINS,
         "frankenpaxos_tpu_torch/ops/csrc/pipeline.cu",
         "frankenpaxos_tpu/bench/pipeline.py:145 (run_steps L341, "
         "run_steps_from L358)",
         f"N={n} B={BLOCK} W={WINDOW}, {FIGURE_DRAINS} drains a run"),
        # Lanes (20 B each) and newly (1 B) plus, per distinct column,
        # owner, round, chosen and N vote bytes read and written.
        ("record_and_check",
         lambda: tq.record_and_check(k4_k, k4_lanes, pred),
         lambda: tq.record_and_check_plain(k4_p, k4_lanes, pred),
         "record_and_check_run_kernel", 21 * chunk + 2 * (9 + n) * k4_cols,
         (40 + 2 * g * n) * chunk,
         "frankenpaxos_tpu_torch/ops/csrc/sparse.cuh",
         f"{ref}:214 (_apply_sparse_votes L170)",
         f"N={n} B={chunk} W={WINDOW}"),
        # K5's all-valid form (every checker's): the slots read, each
        # reset column's N + 9 bytes written.
        ("release", lambda: tq.release_all(k5_k, k5_slots),
         lambda: tq.release_all_plain(k5_p, k5_slots),
         "release_all_kernel", 4 * rel + (9 + n) * rel, (8 + n) * rel,
         "frankenpaxos_tpu_torch/ops/csrc/release.cuh", f"{ref}:327",
         f"N={n} B={rel} W={WINDOW}"),
        ("record_and_check_epochs",
         lambda: tq.record_and_check_epochs(k6_k, k6_lanes, bounds, planes),
         lambda: tq.record_and_check_epochs_plain(k6_p, k6_lanes, bounds,
                                                  planes),
         "record_and_check_epochs_run_kernel",
         21 * chunk + 2 * (9 + kn) * k6_cols + plane_bytes,
         (42 + 2 * kg * kn) * chunk, epoch, f"{ref}:237",
         f"N={kn} K={kk} B={chunk} W={EPOCH_WINDOW}"),
        ("check_batch_multi",
         lambda: tq.check_batch_multi(present, cfg, planes),
         lambda: tq.check_batch_multi_plain(present, cfg, planes),
         "multi_row_kernel", (4 * kn + 5) * chunk + plane_bytes,
         (2 * kg * kn + kg) * chunk, epoch, f"{ref}:359",
         f"N={kn} K={kk} B={chunk}"),
        ("reshape_columns",
         lambda: tq.reshape_columns(k7_block, k7_cmap_np),
         lambda: tq.reshape_columns_plain(k7_block, k7_cmap),
         "reshape_columns_kernel", (3 + 4) * EPOCH_WINDOW,
         4 * EPOCH_WINDOW, epoch, f"{ref}:441",
         f"[3, {EPOCH_WINDOW}] -> [4, {EPOCH_WINDOW}]"),
        # The Leader's staged call: both matrices read once from pinned
        # host memory, a bool and an int32 a row written back there
        # (bound: the link, ``over_pcie``); N - 1 compares and a select
        # per row. Its plain version takes the same numpy in and out.
        ("safe_values",
         lambda: tv.safe_values_staged(*k8_views, device=dev), k8_plain,
         "safe_values_kernel", (8 * n + 5) * FAILOVER_ROWS,
         2 * n * FAILOVER_ROWS, "frankenpaxos_tpu_torch/ops/csrc/value.cu",
         "frankenpaxos_tpu/ops/value.py:19",
         f"S={FAILOVER_ROWS} N={n}, the Leader's staged call"),
        # K9-K11: the batch read once (B*L*(4+W) bytes), the output
        # written once; a few integer operations per tail byte.
        ("normalized", lambda: td.normalized(lt_batch),
         lambda: td.normalized_plain(lt_batch), "depset_normalized_kernel",
         2 * _rows(lt_batch) + 4, 4 * lt_batch.tails.numel(), depset_cu,
         f"{depset_ref}:74", _shape(lt_batch)),
        ("union_reduce", lambda: td.union_reduce(lt_batch),
         lambda: td.union_reduce_plain(lt_batch),
         "depset_union_reduce_kernel",
         _rows(lt_batch) + 4 + _rows(lt_batch) // lt_batch.tails.shape[0],
         2 * lt_batch.tails.numel(), depset_cu, f"{depset_ref}:97",
         _shape(lt_batch)),
        ("conflict_max", lambda: td.conflict_max(slow_seqs, slow),
         lambda: td.conflict_max_plain(slow_seqs, slow),
         "depset_union_reduce_kernel",
         _rows(slow) + 8 + 4 * slow.tails.shape[0]
         + _rows(slow) // slow.tails.shape[0],
         2 * slow.tails.numel() + slow.tails.shape[0], depset_cu,
         f"{depset_ref}:168", _shape(slow)),
        ("all_equal", lambda: td.all_equal(fast),
         lambda: td.all_equal_plain(fast), "depset_all_equal_kernel",
         _rows(fast) + 5, 8 * fast.tails.numel(), depset_cu,
         f"{depset_ref}:114", _shape(fast)),
        # K12: every watermark read once, one int32 written per row; two
        # compares and two adds per pair of a row's elements.
        ("quorum_watermark", lambda: tw.quorum_watermark(k12_rows, k12_q),
         lambda: tw.quorum_watermark_plain(k12_rows, k12_q),
         "quorum_watermark_kernel", 4 * k12_b * k12_n + 4 * k12_b,
         4 * k12_b * k12_n * k12_n, watermark_cu, f"{watermark_ref}:17",
         f"[B, n] = [{k12_b}, {k12_n}] (strided), q = {k12_q}"),
        # K13: the prefix up to its first zero read, an int32 written; a
        # multiply and an add per element read.
        ("contiguous_prefix_length",
         lambda: tw.contiguous_prefix_length(k13),
         lambda: tw.contiguous_prefix_length_plain(k13),
         "prefix_cta_kernel", 2049 + 4, 2 * 2049, watermark_cu,
         f"{watermark_ref}:38", "[4096] bool, first False at 2048"),
        # K14: K3's bytes and operations, the counters read and written
        # once, a vote sum and a bin add per newly-chosen lane.
        ("steady_state_step_telemetry", k14, k14_plain,
         "run_steps_kernel", 2 * (state_bytes + tel_words),
         (k3_ops + 2 * (n + 2) * BLOCK) * FIGURE_DRAINS,
         "frankenpaxos_tpu_torch/ops/csrc/pipeline.cu",
         "frankenpaxos_tpu/bench/pipeline.py:145 (ops/telemetry.py:99, "
         ":108, :136)",
         f"N={n} B={BLOCK} W={WINDOW}, telemetry on, {FIGURE_DRAINS} "
         f"drains a run"),
        ("steady_state_step_baseline", pinned, pinned_plain,
         "run_steps_kernel", 2 * state_bytes, k3_ops * FIGURE_DRAINS,
         "frankenpaxos_tpu_torch/ops/csrc/pipeline_baseline.cu",
         "frankenpaxos_tpu/bench/pipeline_baseline.py:76 (run_steps_from "
         "L201)", f"N={n} B={BLOCK} W={WINDOW}, {FIGURE_DRAINS} drains a "
         f"run"),
        # K15: ids (4 B) and valid (1 B) read, two int32 written per row;
        # N^2 compares, ANDs and adds per row.
        ("count_matching_replies",
         lambda: tv.count_matching_replies(k15_ids, k15_valid),
         lambda: tv.count_matching_replies_plain(k15_ids, k15_valid),
         "count_matching_replies_kernel", (5 * k15_n + 8) * k15_s,
         3 * k15_n * k15_n * k15_s,
         "frankenpaxos_tpu_torch/ops/csrc/value.cu",
         "frankenpaxos_tpu/ops/value.py:40", f"S={k15_s} N={k15_n}"),
        # K16: two batches read, one written (compact: one batch and
        # `executed`; union, timed on libbench's aliased call, one batch
        # read); K17: one batch read (two for equal), 1 or 4 bytes
        # written per row; contains reads a watermark, a byte, a leader
        # and a vid per row.
        ("union", lambda: td.union(lib_a, lib_a),
         lambda: td.union_plain(lib_a, lib_a), "depset_union_kernel",
         2 * _rows(lib_a) + 4, 2 * lib_cells, depset_cu,
         f"{depset_ref}:49", _shape(lib_a) + " (libbench's, aliased)"),
        ("intersect", lambda: td.intersect(lib_a, lib_b),
         lambda: td.intersect_plain(lib_a, lib_b), "depset_pair_kernel",
         3 * _rows(lib_a) + 4, 12 * lib_cells, depset_cu,
         f"{depset_ref}:181", _shape(lib_a)),
        ("compact", lambda: td.compact(lib_a, lib_exec),
         lambda: td.compact_plain(lib_a, lib_exec), "depset_pair_kernel",
         2 * _rows(lib_a) + 4 * 3 + 4, 6 * lib_cells, depset_cu,
         f"{depset_ref}:213", _shape(lib_a) + ", executed [L]"),
        ("equal", lambda: td.equal(lib_a, lib_b),
         lambda: td.equal_plain(lib_a, lib_b), "depset_query_kernel",
         2 * _rows(lib_a) + lib_rows, 2 * lib_cells, depset_cu,
         f"{depset_ref}:129", _shape(lib_a)),
        ("size", lambda: td.size(lib_a), lambda: td.size_plain(lib_a),
         "depset_query_kernel", _rows(lib_a) + 4 * lib_rows, lib_cells,
         depset_cu, f"{depset_ref}:161", _shape(lib_a)),
        ("contains", lambda: td.contains(lib_a, lib_leader, lib_vid),
         lambda: td.contains_plain(lib_a, lib_leader, lib_vid),
         "depset_query_kernel", (4 + 1 + 8 + 1) * lib_rows + 4,
         12 * lib_rows, depset_cu, f"{depset_ref}:137 (contains L148)",
         _shape(lib_a) + ", a leader and a vid per row"),
        # K18: two id loads, a wrap, two clamps, a multiply-add and a
        # compare per frame.
        ("link_keep_mask",
         lambda: tsw.link_keep_mask_tensor(k18_src, k18_dst, k18_up),
         lambda: tsw.link_keep_mask_plain(k18_src, k18_dst, k18_up),
         "link_keep_mask_kernel", 9 * k18_n + k18_pairs, 8 * k18_n,
         "frankenpaxos_tpu_torch/ops/csrc/simwave.cu",
         "frankenpaxos_tpu/ops/simwave.py:79 (_link_keep_jax L107)",
         f"n={k18_n} over [{K18_ZONES + 1}, {K18_ZONES + 1}] bool"),
        # K19: per lane, both passes' N vote bytes read and written, a
        # command and the R partial rows of both passes written; an
        # arrival hash per vote and G * N multiply-adds per pass. K20:
        # per lane both passes' partials and chosen bytes, the old
        # command read, a result and the GC column (N + 1) written. K21:
        # the slot words and three scalars read and written.
        ("shard_vote_count", shard_call("k19", tp.shard_vote_count),
         shard_call("p19", tp.shard_vote_count_plain),
         "shard_vote_count_kernel", (4 * n + 4 + 8 * sh_rows) * sh_b,
         (2 * (10 * n + 2 * g * n) + 10) * sh_b, sharded_cu,
         f"{sharded_ref}:145 (make_sharded_step L494, psums L271-275)",
         sh_shape),
        ("shard_commit", shard_call("k20", tp.shard_commit),
         shard_call("p20", tp.shard_commit_plain), "shard_commit_kernel",
         (8 * sh_rows + 4 + 8 + n + 1) * sh_b + 8 * (sh_s + 1),
         (2 * (2 * g + 6) + n + 10) * sh_b, sharded_cu,
         f"{sharded_ref}:145 (L276-322 after the group psum)", sh_shape),
        ("shard_fold", shard_call("k21", tp.shard_fold),
         shard_call("p21", tp.shard_fold_plain), "shard_fold_kernel",
         8 * (sh_s + 1) + 24, 4 * (sh_s + 1) + 20, sharded_cu,
         f"{sharded_ref}:145 (L282-313 after the slot psum)",
         f"S={sh_s}, telemetry off"),
        # The pinned copies of K19-K21 (the pinned drain's mesh form):
        # K19's and K20's work without the telemetry rows, K21's.
        ("shard_vote_count_baseline",
         pinned_call("k19", tpin.shard_vote_count),
         pinned_call("p19", tpin.shard_vote_count_plain),
         "shard_vote_count_baseline_kernel", (4 * n + 4 + 8 * g) * sh_b,
         (2 * (10 * n + 2 * g * n) + 10) * sh_b, pinned_cu,
         f"{pinned_ref}:76 (L76-80 with axes; psums L154-L185)", sh_shape),
        ("shard_commit_baseline", pinned_call("k20", tpin.shard_commit),
         pinned_call("p20", tpin.shard_commit_plain),
         "shard_commit_baseline_kernel",
         (8 * g + 4 + 8 + n + 1) * sh_b + 8 * (sh_s + 1),
         (2 * (2 * g + 6) + n + 10) * sh_b, pinned_cu,
         f"{pinned_ref}:76 (L160-L185 after the group psum)", sh_shape),
        ("shard_fold_baseline", pinned_call("k21", tpin.shard_fold),
         pinned_call("p21", tpin.shard_fold_plain),
         "shard_fold_baseline_kernel", 8 * (sh_s + 1) + 24,
         4 * (sh_s + 1) + 20, pinned_cu,
         f"{pinned_ref}:76 (L169, L185 after the slot psum)",
         f"S={sh_s}"),
    ]
    # Rows whose kernel reads and writes pinned host memory: the bytes
    # that cross the host link each way, which bound them.
    over_pcie = {"safe_values": (8 * n * FAILOVER_ROWS, 5 * FAILOVER_ROWS)}
    out = []
    for (name, fn, plain, kname, nbytes, ops, source, replaces,
         shape) in cases:
        turns = None
        if name in library:
            # In turns with the library call (and the out= form).
            turns = in_turns({"kernel": fn, "library": library[name],
                              **({"out": with_out[name]}
                                 if name in with_out else {})})
            ms, library_ms = turns["kernel"][0], turns["library"][0]
        elif name in DRAIN_KERNELS:
            ms, library_ms = time_ms(fn, 200), None
        else:
            ms, library_ms = time_ms(fn, 2000), None
        if name in DRAIN_KERNELS:
            # A run of FIGURE_DRAINS plain drains takes about a second.
            plain_ms = time_ms(plain, 1, warm=1)
            dev_ms = launch_ms(fn)
        else:
            plain_ms = time_ms(plain, 200)
            dev_ms = device_ms(fn, kname)
        bytes_ms = (max(over_pcie[name]) / PCIE_BYTES_PER_S
                    if name in over_pcie
                    else nbytes / HBM_BYTES_PER_S) * 1e3
        ops_ms = ops / INT_OPS_PER_S * 1e3
        by_path = {path: counts.get(name, 0)
                   for path, counts in paths.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.get(path, 0) for path in MAIN_PATHS),
            "launches_by_path": by_path,
            "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "device_ms": dev_ms, "bytes": nbytes,
            "shape": shape,
        })
        if name in DRAIN_KERNELS:
            per = FIGURE_DRAINS
            by_drains = {path: counts.get(name, 0)
                         for path, counts in DRAINS_BY_PATH.items()}
            ref_bytes = (5 * n + 17) * BLOCK * per
            out[-1].update({
                "device_ms_source": "cuda events around one launch "
                                    f"(median of {FIGURE_LAUNCHES})",
                "reference_bytes": ref_bytes,
                "reference_bound_ms": ref_bytes / HBM_BYTES_PER_S * 1e3,
                "device_us_per_drain_by_form": forms[name],
                "drains_per_call": per,
                "drains": sum(by_drains.values()),
                "drains_by_path": by_drains,
                "ms_per_drain": ms / per,
                "device_us_per_drain": dev_ms * 1e3 / per,
                "bound_us_per_drain": max(bytes_ms, ops_ms) * 1e3 / per,
                "plain_ms_per_drain": plain_ms / per,
            })
        if name in over_pcie:
            out[-1]["bound_rate"] = (
                f"the host link, {PCIE_BYTES_PER_S / 1e9:g} GB/s each way "
                f"(PCIe Gen5 x16): {over_pcie[name][0]} bytes up, "
                f"{over_pcie[name][1]} down")
        if turns is not None:
            out[-1]["in_turns_ms_blocks"] = {k: b for k, (_, b) in
                                            turns.items()}
            if "out" in turns:
                out[-1]["ms_out"] = turns["out"][0]
    # The transport-facing calls (numpy in, through reused pinned
    # staging, one staged ctypes call, numpy out): host clock per call.
    # K18 at the FIFO wave; K12's vector form on the GC roles' [3, 2].
    frontiers_np = frontiers.cpu().numpy().astype(np.int64)
    for name, call in (
            ("link_keep_mask",
             lambda: tsw.link_keep_mask_cuda(k18_src_np, k18_dst_np,
                                             k18_up_np)),
            ("quorum_watermark",
             lambda: tw.quorum_watermark_vector(frontiers_np, k12_q))):
        call()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        row = next(r for r in out if r["name"] == name)
        row["entry_ms"] = (time.perf_counter() - t0) / 2000 * 1e3
    # K1 at the synchronous tracker's buckets (N = 3) with its staged
    # entry's host time, K6 on one chunk and on a drain's run of 48
    # chunks with the epoch checker's, K10 at the BPaxos Leader's
    # [2, 2, W] (bench/launch_shapes.py).
    shapes = launch_shapes.kernels(dev)
    for name, key, fig in (("quorum_hit", "at_launch_shapes", "k1"),
                           ("record_and_check_epochs", "at_launch_shapes",
                            "k6"),
                           ("union_reduce", "at_launch_shapes", "k10"),
                           ("conflict_max", "at_launch_shapes", "k10_seq"),
                           ("all_equal", "at_launch_shapes", "k11")):
        next(r for r in out if r["name"] == name)[key] = shapes[fig]
    # K2 at the pipelined tracker's buckets, the grid, the sharded rank
    # and a drain's run; K5 at the leaders' widths (bench/launch_shapes.py
    # --parts board).
    board = launch_shapes.board_kernels(dev)
    for name, fig in (("record_block", "k2"), ("release", "k5"),
                      ("record_and_check", "k4")):
        next(r for r in out if r["name"] == name)["at_launch_shapes"] = \
            board[fig]
    # A pipelined drain's board updates whole (K2 and K4 in one staged
    # call), and K19-K21 at rank 0 of each sharded mesh, telemetry off and
    # on, K21 also over runs (--parts sharded).
    next(r for r in out if r["name"] == "record_and_check")[
        "drain_at_launch_shapes"] = board["drain"]
    sharded = launch_shapes.sharded_kernels(dev)
    for name, form in (("shard_vote_count", "form"),
                       ("shard_commit", "commit_form"),
                       ("shard_fold", None)):
        next(r for r in out if r["name"] == name)["at_launch_shapes"] = {
            key: {"form": fig.get(form), "b_local": fig["b_local"],
                  **fig[name]} for key, fig in sharded.items()}
    # K21 folding runs of 1, 8, 64 and 256 drains in one launch each.
    next(r for r in out if r["name"] == "shard_fold")["runs_at_launch_shapes"] \
        = {key: fig["shard_fold_run"] for key, fig in sharded.items()}
    # The forms K7 and K8 run at their rows' shapes, and where the
    # Leader's staged K8 call reads its inputs.
    next(r for r in out if r["name"] == "reshape_columns")["form"] = (
        "16-byte words, the map in the call's block")
    k8_row = next(r for r in out if r["name"] == "safe_values")
    k8_row["form"] = (f"a CTA a tile of 256 rows, N = {n} form, 16-byte "
                      f"loads of the pinned block in place (the staged "
                      f"call: no copy)")
    require(all(np.array_equal(a, b) for a, b in zip(
        tv.safe_values_staged(*k8_views, device=dev), k8_plain())),
            "K8's staged call differs from plain at its row's inputs")
    # The lean tensor wrapper at the bench's window, in device memory
    # (tests, benches and the smoke call it; the path does not).
    lean = (lambda: tv.safe_values(k8_rounds, k8_ids))
    lean_bytes = (8 * n + 5) * RECOVERY_ROWS
    k8_row["lean_wrapper"] = {
        "shape": f"S={RECOVERY_ROWS} N={n}", "ms": time_ms(lean, 2000),
        "plain_ms": time_ms(lambda: tv.safe_values_plain(k8_rounds,
                                                         k8_ids), 200),
        "device_ms": device_ms(lean, "safe_values_kernel"),
        "bound_ms": max(lean_bytes / HBM_BYTES_PER_S,
                        2 * n * RECOVERY_ROWS / INT_OPS_PER_S) * 1e3,
        "bound_by": "bytes", "bytes": lean_bytes,
        "max_abs_err": errors["safe_values"]}
    # The forms K13 and K16's union run at their rows' shapes.
    next(r for r in out if r["name"] == "contiguous_prefix_length")[
        "form"] = tw.prefix_form(k13)
    next(r for r in out if r["name"] == "union")["form"] = (
        "aliased: the batch read once, 16-byte words")
    # The staged entries (one call a decision): their error against the
    # plain versions in phase 13.
    for name, staged in (("union_reduce", "union_staged"),
                         ("conflict_max", "union_staged"),
                         ("all_equal", "all_equal_staged")):
        next(r for r in out if r["name"] == name)["staged_max_abs_err"] = \
            errors[staged]
    k8_row["max_abs_err"] = errors["safe_values_staged"]
    return out


#: Phase 29's load: the supernode's ``CLIENTS`` closed-loop clients, each
#: with TCP_PSEUDONYMS writes in flight, TCP_WRITES writes an arm.
TCP_WRITES = 1 << 12
TCP_PSEUDONYMS = 64
TCP_ARMS = {
    "dict": dict(quorum_backend="dict", phase1_backend="cuda"),
    "cuda_sync": dict(quorum_backend="cuda", phase1_backend="cuda"),
    "cuda_pipelined": dict(quorum_backend="cuda", tpu_pipelined=True,
                           phase1_backend="cuda"),
}
#: The kernel each cuda arm must launch on its traffic.
TCP_ARM_KERNEL = {"cuda_sync": "quorum_hit", "cuda_pipelined": "record_block"}
#: Phase 29's queued sleep: long enough that a board call left unordered
#: behind it would run first.
TCP_QUEUED_SLEEP_CYCLES = 200_000_000


def _tcp_stream_order(dev) -> dict:
    """A tracker's board is used from two host threads under TCP: built
    (and prewarmed) where the roles are built, drained on the transport's
    event-loop thread. Both threads' current stream must be one stream,
    so that every board call is ordered: a checker built here records
    acceptor 0's vote for slot 5 behind a long sleep on this thread's
    stream, and then, on a TcpTransport's loop thread, acceptor 1's vote
    for the same slot. Ordered, the loop thread's call chooses the slot
    (it sees both votes) and this thread's does not; unordered, the loop
    thread's call would run first and choose nothing."""
    spec = specs()["majority3"]
    checker = tq.TpuQuorumChecker(spec, window=4096, device=dev)
    transport = TcpTransport(logger=FakeLogger())
    transport.start()
    try:
        index = dev.index or 0
        here = _build.stream_handle(index)
        there = supernode.on_loop(transport,
                                   lambda: _build.stream_handle(index))
        require(here == there, f"the event-loop thread's current stream "
                f"{there} is not this thread's {here}")

        def vote(node: int):
            run = checker.board_run([("dense", [(0, 64, 0)])])
            run.block[node, int(run.offsets[0]) + 5] = 1
            return run.dispatch()

        torch.cuda._sleep(TCP_QUEUED_SLEEP_CYCLES)
        first = vote(0)
        second = supernode.on_loop(transport, lambda: vote(1))
        loop_chose = bool(supernode.on_loop(
            transport, lambda: second.wait()[5]))
        main_chose = bool(first.wait()[5])
        first.free()
        second.free()
    finally:
        transport.stop()
    require(loop_chose and not main_chose,
            f"board calls from two threads were not ordered: the loop "
            f"thread's call chose {loop_chose}, this thread's {main_chose}")
    return {"stream": here, "loop_thread_chose": loop_chose,
            "main_thread_chose": main_chose}


def phase_tcp(dev) -> tuple[dict, dict, dict]:
    """MultiPaxos over real loopback TCP on the card
    (``protocols/multipaxos/supernode.py``): f = 1 in ``deploy.py``'s
    ``cluster(1, ...)`` layout, the native codec loaded, TCP_WRITES
    closed-loop writes an arm. ``supernode.run_arm`` checks each arm
    (every write answered once, the replicas' logs equal and complete, no
    error and no collector error logged); here each cuda arm's executed
    set must equal the dict arm's and launch its kernel. The launch counts
    are set to 0 first and read after the three arms."""
    require(native.load() is not None,
            f"the native codec did not load: {native.load_error()}")
    stream = _tcp_stream_order(dev)
    reset_launches()
    arms: dict = {}
    executed: dict = {}
    for arm, options in TCP_ARMS.items():
        before = {name: w.launches for name, w in WRAPPERS.items()}
        try:
            result = supernode.run_arm(TCP_WRITES, TCP_PSEUDONYMS,
                                       device=dev, **options)
        except supernode.GateFailure as exc:
            raise SmokeFailure(f"tcp {arm}: {exc}") from exc
        executed[arm] = result.pop("executed")
        result["launches"] = {name: w.launches - before[name]
                              for name, w in WRAPPERS.items()
                              if w.launches - before[name]}
        arms[arm] = result
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    for arm, kernel in TCP_ARM_KERNEL.items():
        require(executed[arm] == executed["dict"],
                f"tcp {arm}: the executed commands differ from the dict "
                f"arm's")
        require(arms[arm]["launches"].get(kernel, 0) > 0,
                f"tcp {arm}: {kernel} never launched on the arm's traffic: "
                f"{arms[arm]['launches']}")
    return {"arms": arms, "writes": TCP_WRITES,
            "native_codec": native.library_path(),
            "stream_order": stream}, launches, executed


#: Phase 34: phase 29's supernode with ingest batchers in front of the
#: leaders and the leaders' in-flight budget at half the writes in
#: flight.
INGEST_BATCHERS = 2
INGEST_INFLIGHT_LIMIT = supernode.CLIENTS * TCP_PSEUDONYMS // 2


def phase_ingest(dev, tcp: dict) -> tuple[dict, dict]:
    """Phase 34: the ingest fabric and admission over TCP on the card
    (``protocols/multipaxos/supernode.py`` with ``ingest_batchers`` and
    ``leader_admission``). ``supernode.run_arm`` checks each arm as in
    phase 29; here every arm must also draw Rejected replies, deliver
    IngestRuns to the leaders and feed vote-ack rows through the
    ProxyLeaders' wire sink, and each cuda arm must equal the dict arm's
    executed set and launch its kernel. ``tcp`` is phase 29's result,
    for the launches a write beside it. The launch counts are set to 0
    first and read after the three arms."""
    reset_launches()
    arms: dict = {}
    executed: dict = {}
    for arm, options in TCP_ARMS.items():
        before = {name: w.launches for name, w in WRAPPERS.items()}
        try:
            result = supernode.run_arm(
                TCP_WRITES, TCP_PSEUDONYMS, device=dev,
                ingest_batchers=INGEST_BATCHERS,
                leader_admission={
                    "admission_inflight_limit": INGEST_INFLIGHT_LIMIT},
                **options)
        except supernode.GateFailure as exc:
            raise SmokeFailure(f"ingest {arm}: {exc}") from exc
        executed[arm] = result.pop("executed")
        result["launches"] = {name: w.launches - before[name]
                              for name, w in WRAPPERS.items()
                              if w.launches - before[name]}
        serving = result["serving"]
        result["rejected_commands"] = sum(serving["rejected"].values())
        require(result["rejected_commands"] > 0,
                f"ingest {arm}: no write was Rejected: {serving}")
        require(serving["ingest_counts"].get("IngestRun", 0) > 0,
                f"ingest {arm}: the leaders received no IngestRun: "
                f"{serving}")
        require(serving["ack_rows"]["sink"] > 0,
                f"ingest {arm}: no vote-ack row went through the "
                f"ProxyLeaders' wire sink: {serving}")
        arms[arm] = result
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    for arm, kernel in TCP_ARM_KERNEL.items():
        require(executed[arm] == executed["dict"],
                f"ingest {arm}: the executed commands differ from the "
                f"dict arm's")
        got = arms[arm]["launches"].get(kernel, 0)
        require(got > 0, f"ingest {arm}: {kernel} never launched on the "
                         f"arm's traffic: {arms[arm]['launches']}")
        was = tcp["arms"][arm]["launches"].get(kernel, 0)
        arms[arm]["kernel_launches_per_write"] = {
            "kernel": kernel, "phase_34": got / TCP_WRITES,
            "phase_29": was / TCP_WRITES}
    return {"arms": arms, "writes": TCP_WRITES,
            "ingest_batchers": INGEST_BATCHERS,
            "admission_inflight_limit": INGEST_INFLIGHT_LIMIT}, launches


def phase_read_batch(dev) -> tuple[dict, dict]:
    """Phase 35: MultiPaxos with read batchers on the card
    (``bench/read_batch_sim.py``); its gates raise inside ``run``. The
    launch counts are set to 0 first and read after every arm."""
    reset_launches()
    try:
        result = read_batch_sim.run(dev)
    except read_batch_sim.GateFailure as exc:
        raise SmokeFailure(f"read batchers: {exc}") from exc
    return result, {name: w.launches for name, w in WRAPPERS.items()}


def phase_traced(dev, tcp: dict) -> tuple[dict, dict]:
    """Phase 36: MultiPaxos over TCP with every transport traced
    (``bench/traced_tcp.py``); its gates raise inside ``run``. Each cuda
    arm must also launch its kernel; ``tcp`` is phase 29's result, for
    the untraced writes/s beside the traced. The launch counts are set
    to 0 first and read after the three arms."""
    reset_launches()
    arms: dict = {}
    for arm in traced_tcp.ARMS:
        before = {name: w.launches for name, w in WRAPPERS.items()}
        try:
            result = traced_tcp.run(dev, arms=(arm,))["arms"][arm]
        except traced_tcp.GateFailure as exc:
            raise SmokeFailure(f"traced tcp: {exc}") from exc
        result["launches"] = {name: w.launches - before[name]
                              for name, w in WRAPPERS.items()
                              if w.launches - before[name]}
        result["untraced_writes_per_sec"] = \
            tcp["arms"][arm]["writes_per_sec"]
        arms[arm] = result
    for arm, kernel in TCP_ARM_KERNEL.items():
        require(arms[arm]["executed"] == arms["dict"]["executed"],
                f"traced tcp {arm}: the executed commands differ from the "
                f"dict arm's")
        require(arms[arm]["launches"].get(kernel, 0) > 0,
                f"traced tcp {arm}: {kernel} never launched on the arm's "
                f"traffic: {arms[arm]['launches']}")
    for result in arms.values():
        result["executed"] = len(result["executed"])
    return ({"arms": arms, "writes": traced_tcp.WRITES,
             "sample_rate": supernode.TRACE_SAMPLE_RATE},
            {name: w.launches for name, w in WRAPPERS.items()})


def phase_transport(dev) -> dict:
    """The transport_lt twin, short: widths 16, 256 and 1024, one rep;
    a lost reply, a wrong reply or a logged error fails it inside
    ``run``."""
    try:
        return transport_lt.run(transport_lt.SMOKE_WIDTHS, reps=1,
                                smoke=True)
    except transport_lt.GateFailure as exc:
        raise SmokeFailure(f"transport_lt: {exc}") from exc


def phase_reconfig(dev) -> tuple[dict, dict]:
    """The reconfigured cluster (``bench/reconfig_sim.py``) on the card:
    its gates raise inside ``run`` (K6 and K7 launched in every arm among
    them). The launch counts are set to 0 first and read after the dict
    run and the three arms."""
    reset_launches()
    try:
        result = reconfig_sim.run(dev)
    except reconfig_sim.GateFailure as exc:
        raise SmokeFailure(f"reconfig_sim: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    for arm, figures in result["arms"].items():
        if arm == "dict":
            continue
        require(all(figures["launches"][k] > 0
                    for k in reconfig_sim.PATH_KERNELS),
                f"reconfig {arm}: K6 or K7 never launched: "
                f"{figures['launches']}")
    return result, launches


#: Phase 32's Fast MultiPaxos load: closed-loop clients and commands an
#: arm (the bench's own, not cut).
FAST_CLIENTS = fast_sim.CLIENTS
FAST_COMMANDS = fast_sim.COMMANDS
#: K6's stateless shapes: ``(rows, nodes, planes, weighted masks)``.
K6S_SHAPES = ((1, 3, 1, False), (1, 5, 1, False), (256, 4, 2, False),
              (256, 4, 2, True), (1 << 16, 5, 3, False))


def _k6s_planes(n: int, k: int, weighted: bool) -> tuple:
    """The planes of one of ``K6S_SHAPES``: the Fast Paxos classic spec
    (K = 1), else ``launch_shapes.fast_planes``, weighted 1-3."""
    if k == 1:
        spec = fast_flexible_specs(n, n // 2 + 1, n).classic
        return pad_specs([spec])
    masks, thresholds, combine_any = pad_specs(launch_shapes.fast_planes(
        n, k))
    if weighted:
        masks = masks.astype(np.int32) * np.arange(1, n + 1) % 4
    return masks, thresholds, combine_any


def _k6_stateless(dev, rng) -> tuple[int, dict]:
    """K6's stateless form against ``check_batch_multi_plain`` (on the
    CPU), exact, at ``K6S_SHAPES``; the worst error and each shape's
    figures."""
    worst, figures = 0, {}
    for b, n, k, weighted in K6S_SHAPES:
        planes_np = _k6s_planes(n, k, weighted)
        multi = tq.MultiCheck(*planes_np, device=dev)
        cpu = tq.make_multi_predicate(*planes_np, device="cpu")
        require(multi.bits == (not weighted),
                f"K6 stateless planes {n, k, weighted}: bits {multi.bits}")

        def plain(rows, idx):
            return tq.check_batch_multi_plain(
                torch.from_numpy(np.asarray(rows).astype(np.int32)),
                torch.from_numpy(np.asarray(idx).astype(np.int32)),
                cpu).numpy()

        def err(got, rows, idx, what):
            e = int((np.asarray(got) != plain(rows, idx)).sum())
            require(e == 0, f"K6 stateless differs at [{b}, {n}] K={k} "
                            f"weighted={weighted}: {what}")
            return e

        rows01 = (rng.random((b, n)) < 0.5).astype(np.int32)
        rowsw = rng.integers(-2**31, 2**31 - 1, size=(b, n)).astype(np.int32)
        rowsw[: b // 2] = rng.integers(-2, 4, size=(b // 2, n))
        idx = rng.integers(-k - 1, k + 2, size=b).astype(np.int32)
        cases = {"0/1": rows01, "bool": rows01.astype(bool),
                 "weighted": rowsw, "strided": np.asfortranarray(rows01)}
        for what, rows in cases.items():
            worst = max(worst, err(multi.check(rows, idx), rows, idx,
                                   f"staged {what}"))
            p = torch.from_numpy(np.asarray(rows).astype(np.int32)).to(dev)
            i = torch.from_numpy(idx).to(dev)
            for view in (p, p.t().contiguous().t()):
                worst = max(worst, err(
                    tq.check_batch_multi(view, i, multi.planes).cpu(),
                    rows, idx, f"tensor {what}"))
        if b == 1 and multi.bits:
            for word in range(1 << n):
                row = np.array([[(word >> j) & 1 for j in range(n)]])
                worst = max(worst, err([multi.check_word(word)], row,
                                       [0], f"check_word {word}"))
        # Figures: the staged call (one row: check_word, the SpecChecker's
        # call; else a batch of 0/1 rows), the tensor wrapper, the plain
        # version on the card, the bound.
        if b == 1:
            words = [int(w) for w in rng.integers(0, 1 << n, size=64)]
            at = [0]

            def staged():
                at[0] = (at[0] + 1) & 63
                return multi.check_word(words[at[0]])
        else:
            def staged():
                return multi.check(rows01, idx)
        calls = 2000 if b < 1024 else 200
        staged()
        t0 = time.perf_counter()
        for _ in range(calls):
            staged()
        staged_ms = (time.perf_counter() - t0) / calls * 1e3
        p = torch.from_numpy(rows01).to(dev)
        i = torch.from_numpy(idx).to(dev)
        planes_dev = multi.planes
        tensor = (lambda: tq.check_batch_multi(p, i, planes_dev))
        figures[f"[{b}, {n}] K={k}" + (" weighted" if weighted else "")] = {
            "staged_ms": staged_ms,
            "staged_device_ms": device_ms(staged, "multi_", 200),
            "staged_form": ("check_word: the word and planes in the "
                            "launch's parameters" if b == 1 else
                            "MultiCheck.check on the pinned block"),
            "tensor_ms": time_ms(tensor, 2000),
            "tensor_device_ms": device_ms(tensor, "multi_", 200),
            "plain_ms": time_ms(lambda: tq.check_batch_multi_plain(
                p, i, planes_dev), 200),
            "bound_ms": (4 * n + 5) * b / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": (4 * n + 5) * b,
            "bits": multi.bits}
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    figures["floor"] = {"fill_[1]_device_ms": device_ms(
        lambda: one.fill_(1), "FillFunctor", 200)}
    return worst, figures


def _fast_paxos_runs(dev) -> dict:
    """Fast Paxos f = 1 on the host backend and on the card, the same
    drives: the fast path, a two-client conflict race (the timers fired
    until both are answered), and random interleavings; each card run's
    chosen values and replies equal the host run's."""
    def drive(backend, device, kind, seed=0):
        transport, leaders, _, clients = fast_harness.make_fastpaxos(
            quorum_backend=backend, device=device, num_clients=3)
        got = []
        if kind == "fast_path":
            transport.deliver_all()
            clients[0].propose("fast", got.append)
            transport.deliver_all()
        elif kind == "race":
            transport.deliver_all()
            clients[0].propose("a", got.append)
            clients[1].propose("b", got.append)
            transport.deliver_all()
            for _ in range(10):
                if len(got) == 2:
                    break
                for timer in transport.running_timers():
                    transport.trigger_timer(timer.id)
                transport.deliver_all()
        else:
            rng = random.Random(seed)
            for c, client in enumerate(clients):
                client.propose(f"v{c}", got.append)
            for _ in range(600):
                cmd = transport.generate_command(rng)
                if cmd is None:
                    break
                transport.run_command(cmd)
        return {"replies": got,
                "leaders": [l.chosen_value for l in leaders],
                "clients": [c.chosen_value for c in clients]}

    out = {}
    for kind, seeds in (("fast_path", [0]), ("race", [0]),
                        ("interleaved", range(8))):
        for seed in seeds:
            host = drive("host", None, kind, seed)
            card = drive("cuda", dev, kind, seed)
            require(card == host, f"Fast Paxos {kind} seed {seed}: the "
                                  f"card's run {card} != the host's {host}")
            chosen = {v for v in host["leaders"] + host["clients"]
                      if v is not None}
            require(len(chosen) <= 1, f"Fast Paxos {kind}: {chosen}")
            out[f"{kind}/{seed}"] = host["replies"]
    require(out["fast_path/0"] == ["fast"], "Fast Paxos fast path")
    require(len(out["race/0"]) == 2 and len(set(out["race/0"])) == 1,
            f"Fast Paxos race: {out['race/0']}")
    return out


def phase_fast(dev, rng) -> tuple[dict, dict, int]:
    """Phase 32: K6's stateless form at its shapes, Fast Paxos on the
    card, then the Fast MultiPaxos closed loop (``bench/fast_sim.py``)
    with every count set to 0 first; its gates raise inside ``run``."""
    worst, figures = _k6_stateless(dev, rng)
    paxos = _fast_paxos_runs(dev)
    reset_launches()
    try:
        result = fast_sim.run(dev, commands=FAST_COMMANDS,
                              clients=FAST_CLIENTS)
    except fast_sim.GateFailure as exc:
        raise SmokeFailure(f"fast_sim: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    require(launches["check_batch_multi"] > 0,
            "K6's stateless check never launched on the fast path")
    result["k6_stateless"] = figures
    result["fast_paxos"] = paxos
    return result, launches, worst


#: Phase 33's K6 shapes, ``(K prior configurations, N acceptors)``: a
#: Matchmaker MultiPaxos leader's phase-1 check at the vldb20 pools.
MATCHMAKER_SHAPES = launch_shapes.MATCHMAKER_SHAPES
#: Two more shapes whose planes' cells do not fit the kernel's parameters,
#: so the staged calls read the planes from the card: K = 8 over the
#: 10-acceptor pool (word form), K = 3 over 40 (no word form, the batch of
#: equal rows); 512 random responder sets for the second.
MATCHMAKER_CARD_PLANES = ((8, 10), (3, 40))
#: matchmaker_sim's writes an arm and backend (its default: depth only,
#: the widths are the bench's).
MATCHMAKER_WRITES = matchmaker_sim.WRITES


def _k6_matchmaker(dev, rng) -> tuple[int, dict]:
    """K6's stateless check at the Matchmaker leader's shapes, against
    ``check_batch_multi_plain`` on the CPU, exact: for every responder set
    of the pool, ``MultiConfigQuorumChecker.check_all`` (one word under
    every plane) and ``check_batch`` of the K equal rows under
    ``arange(K)`` (the reference's body); the worst error and each
    shape's figures."""
    worst, figures = 0, {}
    for k, n in MATCHMAKER_SHAPES + MATCHMAKER_CARD_PLANES:
        specs = launch_shapes.matchmaker_specs(k, n)
        checker = tq.MultiConfigQuorumChecker(specs, device=dev)
        require(checker.multi.bits == (n <= 32),
                f"K6 matchmaker planes [{k}, {n}]: bits {checker.multi.bits}")
        cpu = tq.make_multi_predicate(*pad_specs(specs), device="cpu")
        idx = np.arange(k, dtype=np.int32)
        words = range(1 << n) if n <= 10 else [
            int(w) for w in rng.integers(0, 1 << n, size=512,
                                         dtype=np.int64)]
        for word in words:
            nodes = [i for i in range(n) if word >> i & 1]
            rows = np.zeros((k, n), dtype=np.int32)
            rows[:, nodes] = 1
            want = tq.check_batch_multi_plain(
                torch.from_numpy(rows), torch.from_numpy(idx), cpu).numpy()
            for what, got in (("check_all", checker.check_all(nodes)),
                              ("check_batch", checker.check_batch(rows,
                                                                  idx))):
                e = int((np.asarray(got) != want).sum())
                require(e == 0, f"K6 stateless differs at [{k}, {n}]: "
                                f"{what} of {nodes}")
                worst = max(worst, e)
        sets = [[i for i in range(n) if w >> i & 1]
                for w in rng.integers(0, 1 << n, size=64, dtype=np.int64)]
        at = [0]

        def nodes():
            at[0] = (at[0] + 1) & 63
            return sets[at[0]]

        def one_word():
            return checker.check_all(nodes())

        def reference():
            present = np.zeros((k, n), dtype=np.uint8)
            present[:, nodes()] = 1
            return checker.check_batch(present, idx)

        host = {}
        for name, fn in (("check_all", one_word), ("check_batch", reference),
                         ("check_batch", reference), ("check_all", one_word)):
            fn()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            host.setdefault(name, []).append(
                (time.perf_counter() - t0) / 2000 * 1e3)
        p = torch.ones((k, n), dtype=torch.int32, device=dev)
        i = torch.from_numpy(idx).to(dev)
        planes_dev = checker.planes
        figures[f"[{k}, {n}]"] = {
            "staged_ms": min(host["check_all"]),
            "staged_ms_turns": host["check_all"],
            "staged_device_ms": device_ms(one_word, "multi_", 200),
            "staged_form": "check_all: one word under every plane, the "
                           "word, indices and planes in the launch's "
                           "parameters",
            "check_batch_ms": min(host["check_batch"]),
            "check_batch_ms_turns": host["check_batch"],
            "check_batch_device_ms": device_ms(reference, "multi_", 200),
            "plain_ms": time_ms(lambda: tq.check_batch_multi_plain(
                p, i, planes_dev), 200),
            # The word (or the K rows) and K indices read, K answer
            # bytes written.
            "bound_ms": ((4 if n <= 32 else 4 * n * k) + 5 * k)
            / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "bytes": (4 if n <= 32 else 4 * n * k) + 5 * k,
            "planes": [type(qs).__name__ for qs in
                       launch_shapes.matchmaker_systems(k, n)],
            "groups": checker.multi.g}
    return worst, figures


def phase_matchmaker(dev, rng) -> tuple[dict, dict, int]:
    """Phase 33: K6's stateless check at the Matchmaker leader's shapes,
    then the Matchmaker MultiPaxos closed loop
    (``bench/matchmaker_sim.py``) with every count set to 0 first; its
    gates raise inside ``run``."""
    worst, figures = _k6_matchmaker(dev, rng)
    reset_launches()
    try:
        result = matchmaker_sim.run(dev, writes=MATCHMAKER_WRITES)
    except matchmaker_sim.GateFailure as exc:
        raise SmokeFailure(f"matchmaker_sim: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    checks = sum(runs["cuda"]["phase1_checks"]
                 for runs in result["arms"].values())
    require(launches["check_batch_multi"] == checks > 0,
            f"K6's stateless launches {launches['check_batch_multi']} on "
            f"the matchmaker path != its {checks} phase-1 checks")
    result["k6_stateless"] = figures
    return result, launches, worst


def add_path_launches(kernels: list, path: str, counts: dict) -> None:
    """Count a path run after the per-kernel figures into their rows."""
    for row in kernels:
        row["launches_by_path"][path] = counts.get(row["name"], 0)
        row["launches"] = sum(row["launches_by_path"].get(p, 0)
                              for p in MAIN_PATHS)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.abspath(frankenpaxos_tpu_torch.__file__).startswith(
            os.path.join(here, "")):
        print("chip_smoke: frankenpaxos_tpu_torch is not the checkout's "
              "own package", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    try:
        name = torch.cuda.get_device_name(dev)
        smi = nvidia_smi_line()
        phase(1, f"device: {name} ({torch.cuda.device_count()} "
            f"visible), torch {torch.__version__}, cuda {torch.version.cuda}")
        require(smi is not None, "nvidia-smi gave no name and power limit")
        log(smi)

        seconds = _build.build()
        phase(2, f"build: {seconds:.1f} s")
        for lib in _build.SIGNATURES:
            for line in _build.build_log(lib).splitlines():
                if re.search(r"registers|spill", line):
                    log(f"      {lib}: {line.strip()}")

        errors = {"quorum_hit": phase_k1(dev, rng)}
        phase(3, f"K1 quorum_hit == plain ({len(k1_predicates())} forms, "
            f"B in {list(K1_WIDTHS)}, 0/1 and arbitrary bytes, contiguous, "
            f"transposed, offset and strided; the staged entry)")
        errors["record_block"] = phase_k2(dev, rng)
        phase(4, f"K2 record_block == plain (64 calls, W={WINDOW}); its run "
            f"entry == record_block_run_plain in {len(k1_predicates())} "
            f"forms x {K2_RUNS} runs, the staged run == a CPU checker")
        errors.update(phase_k3(dev))
        phase(5, f"K3 and K14 (one launch a run) == the plain drains, K3 "
            f"== the pinned copy, at W={WINDOW}: runs of "
            + "; ".join(f"{name} {list(c)} from {first}"
                        for name, runs in DRAIN_CHUNKS.items()
                        for first, c in runs.items()))
        k4_drains_err, k4_drains = _k4_drains(dev)
        errors["record_and_check"] = max(phase_k4(dev, rng),
                                         _k4_runs(dev, rng), k4_drains_err)
        phase(6, f"K4 record_and_check == plain (64 calls of 64-4096 "
            f"lanes x 2 specs, W={WINDOW}); its run == "
            f"record_and_check_run_plain in {len(k1_predicates())} forms "
            f"at {list(K4_RUNS)} chunks; the pipelined tracker's staged "
            f"drain == a CPU tracker, one staged call a drain, K4 "
            f"launches <= sparse segments: "
            + ", ".join(f"{k}: {v['dispatches']} drains, staged calls "
                        f"{v['staged_calls']}, {v['sparse_chunks']} chunks "
                        f"in {v['sparse_segments']} segments, K4 launches "
                        f"{v['k4_launches']}" for k, v in k4_drains.items()))
        errors["release"] = phase_k5(dev, rng)
        phase(7, f"K5 release == plain (16 calls of 4096 lanes, "
            f"W={WINDOW}); release_all == plain at {list(K5_ALL_WIDTHS)} "
            f"lanes; held releases == a CPU checker's")
        errors.update(phase_k6(dev, rng))
        phase(8, f"K6 check_batch_multi and record_and_check_epochs == "
            f"plain (3 epochs, 5-node union, W={EPOCH_WINDOW}; one-chunk "
            f"calls of 64-8192 lanes; runs of 1-48 chunks of {K6_CHUNK} "
            f"== plain chunk calls, the int32 wrap, pad lanes; the staged "
            f"entry)")
        errors["reshape_columns"] = phase_k7(dev, rng)
        phase(9, f"K7 reshape_columns == plain ([3, B] for B in "
            f"{list(K7_WIDTHS + K7_ODD_WIDTHS)} to {len(K7_UNIVERSES)} "
            f"universes and maps of {[len(m) for m in K7_MAPS]} rows, the "
            f"map in the call, on the card and into out=; off the grid; a "
            f"side stream)")
        errors.update(phase_k8(dev, rng))
        phase(10, f"K8 safe_values == plain at {list(K8_CASES)} (ties, "
            f"NO_VOTE rows, INT32_MIN / INT32_MAX, out=, off the grid), "
            f"the staged entry (the pinned blocks in place) too")

        result, votes, launches = phase_main_path(dev, rng)
        phase(11, f"main path on {name} ({smi}): headline "
            f"{result['value']} cmds/s majority-3, "
            f"{result['grid_cmds_per_sec']} cmds/s grid 2x3; mean drain "
            f"{result['mean_quorum_batch_latency_us']} us; the timed runs' "
            f"host / device us a drain and device idle share: "
            + ", ".join(f"{arm} {fig['host_us_per_drain']} / "
                        f"{fig['device_us_per_drain']}, "
                        f"{fig['device_idle_share']}"
                        for arm, fig in result["timed_run"].items())
            + f"; p50 "
            f"{result['p50_drain_latency_us']} us, p99 "
            f"{result['p99_drain_latency_us']} us; tracker_lt votes/s "
            + ", ".join(f"{arm} {fig['votes_per_sec']:.0f}"
                        for arm, fig in votes["arms"].items())
            + f"; measured min_device_slots "
            f"{votes['measured_min_device_slots']}; launches {launches}")
        log(json.dumps({"headline": result}))
        log(json.dumps({"tracker_lt": votes}))

        cluster, cluster_launches = phase_cluster(dev)
        arms = cluster["arms"]
        phase(12, f"cluster on {name} ({smi}): committed writes/s "
            + ", ".join(f"{arm} {fig['writes_per_sec']:.0f}"
                        for arm, fig in arms.items())
            + f"; K8 recovery {arms['failover']['recovery']['shape']}; "
            f"launches {cluster_launches}, of them by the arms' traffic "
            f"{cluster['launches']}")
        log(json.dumps({"cluster": cluster}))

        errors.update(phase_depset(dev, rng))
        phase(13, f"K9 normalized, K10 union_reduce / conflict_max, K11 "
            f"all_equal == plain at {list(DEPSET_SHAPES)} and K10, K11 and "
            f"their staged entries at {list(K10_K11_SHAPES)}, bases near "
            f"2^31 - 1 and below 0")

        epaxos, pairs, epaxos_launches = phase_epaxos(dev)
        phase(14, f"EPaxos on {name} ({smi}): committed commands/s "
            + ", ".join(f"{arm} {b} {fig[b]['commands_per_sec']:.0f}"
                        for arm, fig in epaxos["arms"].items()
                        for b in ("host", "cuda"))
            + "; depset_lt coalesced/per_message "
            + ", ".join(f"{w}: {p['throughput_ratio']:.2f}x"
                        for w, p in pairs["pairs"].items())
            + f"; launches {epaxos_launches}, of them by the cluster's "
            f"traffic {epaxos['launches']}")
        log(json.dumps({"epaxos": epaxos}))
        log(json.dumps({"depset_lt": pairs}))

        errors.update(phase_watermark(dev, rng))
        phase(15, f"K12 quorum_watermark == plain at n in "
            f"{list(WATERMARK_WIDTHS)}, B in {list(WATERMARK_ROWS)}, and "
            f"n in {list(WATERMARK_TILED_WIDTHS)}, B in "
            f"{list(WATERMARK_TILED_ROWS)} (tiled), every "
            f"quorum size, per-row and out-of-range sizes, int64 that "
            f"wraps; K13 contiguous_prefix_length == plain on bool, byte "
            f"and signed rows, in its forms {list(tw.PREFIX_FORMS)} at "
            f"their switch-overs, tile edges, views off the 16-byte grid, "
            f"strided rows, out= and a side stream")

        bpaxos, bpaxos_launches = phase_bpaxos(dev)
        phase(16, f"BPaxos on {name} ({smi}): committed commands/s "
            + ", ".join(f"{arm} {b} {fig[b]['commands_per_sec']:.0f}"
                        for arm, fig in bpaxos["arms"].items()
                        for b in ("host", "cuda"))
            + f"; launches {bpaxos_launches}, of them by the cluster's "
            f"traffic {bpaxos['launches']}")
        log(json.dumps({"bpaxos": bpaxos}))

        for kernel, err in phase_telemetry(dev).items():
            errors[kernel] = max(errors[kernel], err)
        phase(17, f"K3, K14 == plain, K3 == the pinned copy in the other "
            f"forms ({list(OTHER_FORMS)}, runs {list(OTHER_CHUNKS)}) and "
            f"at window/block 1-6 ((W, runs) {list(TELEMETRY_RUNS)} x 2 "
            f"specs x "
            f"starts {list(TELEMETRY_STARTS)}); the counters re-add; no "
            f"sync under set_sync_debug_mode('error'); one collect; runs "
            f"inside a side stream's context ordered on it")

        overhead, overhead_launches = phase_overhead(dev)
        phase(18, f"telemetry overhead on {name} ({smi}): "
            + ", ".join(f"{row['window']}/{row['block']}: off/baseline "
                        f"{row['off_over_baseline_ratio']} "
                        f"{row['off_over_baseline_ratio_range']}, on/off "
                        f"{row['on_over_off_ratio']} "
                        f"{row['on_over_off_ratio_range']}"
                        for row in overhead["pairs"].values())
            + f"; gate_passed {overhead['gate_passed']} (measured, not "
            f"enforced); launches {overhead_launches}")
        log(json.dumps({"telemetry_overhead": overhead}))

        errors["count_matching_replies"] = phase_k15(dev, rng)
        phase(19, f"K15 count_matching_replies == plain at S in "
            f"{list(REPLY_ROWS)}, N in {list(REPLY_WIDTHS)}, and S = 0")

        errors.update(phase_depset_rest(dev, rng))
        phase(20, f"K16 union / intersect / compact, K17 equal / size / "
            f"contains == plain at {list(PAIR_SHAPES)}; union at W in "
            f"{list(UNION_WIDTHS)}, aliased, off the 16-byte grid, out=")

        lib, lib_launches = phase_libbench(dev)
        phase(21, f"libbench on {name} ({smi}): launches {lib_launches}")
        log(json.dumps({"libbench": lib}))

        errors["link_keep_mask"] = phase_k18(dev, rng)
        phase(22, f"K18 link_keep_mask == plain at {K18_ZONES} zones, n in "
            f"{list(K18_WAVES)}, every JAX index edge; the numpy entry "
            f"equal, writable and unaliased; a partition between two calls "
            f"flips exactly the cut link")

        geo, storm, geo_launches = phase_geo(dev)
        phase(23, f"WPaxos over geo on {name} ({smi}): "
            + ", ".join(
                f"{b}: home p50/WAN "
                f"{run['home_zone']['home_p50_over_wan_rtt']:.4f}, steal/WAN "
                f"{run['steal']['steal_latency_over_wan_rtt']:.4f}, flat "
                f"geo/multipaxos "
                f"{run['flat']['geo_over_multipaxos_ratio_median']:.3f}, "
                f"geo/plain {run['flat']['geo_over_plain_ratio_median']:.3f}"
                f", {run['seconds']:.1f} s, waves >= 32: "
                f"{run['latency_arms_waves']['waves_at_least_vector_min']}"
                f" + {run['flat']['waves_at_least_vector_min']}, launches "
                f"{run['launches']}"
                for b, run in geo["backends"].items())
            + "; cuda == dict exactly")
        log(json.dumps({"geo_lt": geo}))
        phase(24, f"storm twin on {name} ({smi}): "
            + "; ".join(
                f"{arm}: events/s "
                + ", ".join(f"{m} {r:.0f}"
                            for m, r in fig["events_per_s"].items())
                + f", waves {fig['wave_size_histogram']}, >= 32: "
                f"{fig['waves_at_least_vector_min']}, K18 launches per "
                f"block {fig['k18_launches_per_block']}"
                for arm, fig in storm["arms"].items())
            + f"; projections identical; geo-path launches K5 "
            f"{geo_launches['release']}, K6 "
            f"{geo_launches['record_and_check_epochs']}, K7 "
            f"{geo_launches['reshape_columns']}, K18 "
            f"{geo_launches['link_keep_mask']}")
        log(json.dumps({"sim_core_ab": storm}))

        sharded, sharded_launches, sharded_errors = phase_sharded(dev)
        errors.update(sharded_errors)
        k19_err, k19_forms = _k19_forms(dev, rng)
        errors["shard_vote_count"] = max(errors["shard_vote_count"],
                                         k19_err)
        log(f"      K19 == shard_vote_count_plain in every form (runs per "
            f"form): {k19_forms}")
        k20_err, k20_forms = _k20_forms(dev, rng)
        errors["shard_commit"] = max(errors["shard_commit"], k20_err)
        log(f"      K20 == shard_commit_plain in every form (runs per "
            f"form): {k20_forms}")
        k21_err, k21_runs = _k21_runs(dev, rng)
        errors["shard_fold"] = max(errors["shard_fold"], k21_err)
        log(f"      K21 == shard_fold_plain on runs of {list(k21_runs)} "
            f"rows")
        phase(25, f"sharded drain on {name} ({smi}): backend "
            f"{sharded['backend']}, {sharded['ranks']} ranks on one card "
            f"(spawned in {sharded['spawn_s']:.1f} s); K19-K21 == plain "
            f"(error 0), the gathered state == the unsharded drain's after "
            f"{SHARDED_DRAINS} drains at W={WINDOW}, B={BLOCK}, by step "
            f"and by runs of {SHARDED_RUN} (one K21 a run); per-drain "
            f"ms (rank 0: K19, K20, K21 device; the all-reduces host), "
            f"then a run's host ms a drain and its all-reduces: "
            + "; ".join(
                f"{key}: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in
                    (fig["device_ms_rank0"] or {}).items())
                + f", psum_group {fig['split_ms_rank0']['psum_group']:.4g}"
                f", psum_slot {fig['split_ms_rank0']['psum_slot']:.4g}"
                f"; run {fig['run_ms_per_drain_rank0']:.4g} a drain, "
                f"{fig['run_allreduces']} all-reduces a run"
                for key, fig in sharded["cases"].items())
            + f"; {sharded['nccl']}; launches "
            + str({k: sharded_launches[k] for k in SHARDED_PATH}))
        log(json.dumps({"sharded": sharded}))

        board, board_launches, board_errors = phase_sharded_board(dev, rng)
        for kernel, err in board_errors.items():
            errors[kernel] = max(errors.get(kernel, 0), err)
        phase(26, f"sharded vote board on {name} ({smi}): backend "
            f"{board['backend']}, {board['ranks']} ranks on one card "
            f"(spawned in {board['spawn_s']:.1f} s); kernels == plain on "
            f"every shard (error 0); every drain == the unsharded tracker "
            f"== the dict oracle, boards equal, at W={WINDOW}; all-reduce "
            f"ms (rank 0, 256 / 4096 B) "
            f"{board['allreduce_ms_rank0'][256]:.4g} / "
            f"{board['allreduce_ms_rank0'][4096]:.4g}; per-drain ms: "
            + "; ".join(
                f"{arm}: {fig['drain_ms_median']:.4g} (all-reduces "
                f"{fig['allreduces_per_drain']:.3g} per drain, <= "
                f"{fig['allreduce_ms_per_drain_at_most']:.4g} ms; kernels "
                f"{fig['kernels_device_ms_per_drain']:.3g} ms)"
                for arm, fig in board["arms"].items())
            + f"; {board['nccl'] if isinstance(board['nccl'], str) else 'nccl run'}"
            f"; launches " + str({k: v for k, v in board_launches.items()
                                  if v}))
        log(json.dumps({"sharded_board": board}))

        sweep = phase_block_sweep(dev)
        phase(27, f"block sweep on {name} ({smi}), W={WINDOW}, one timed "
            f"run a block: "
            + ", ".join(f"{r['block_slots']}: {r['cmds_per_sec']:.4g} "
                        f"cmds/s, mean {r['drain_latency_us']:.4g} us, p50 "
                        f"{r['p50_drain_latency_us']} us"
                        for r in sweep["rows"])
            + f"; best under {block_sweep.TARGET_US} us: "
            f"{sweep['chosen_block']}")
        log(json.dumps({"block_sweep": sweep}))

        log(json.dumps({"drain_breakdown": result["timed_run"]}))
        split = call_split.split(dev, parts=("k12_k18", "depset", "board"))
        log(json.dumps({"call_split": split}))
        kernels = phase_figures(dev, rng, {
            "headline_and_tracker": launches, "cluster": cluster_launches,
            "cluster_traffic": cluster["launches"],
            "epaxos": epaxos_launches,
            "epaxos_traffic": epaxos["launches"],
            "bpaxos": bpaxos_launches,
            "bpaxos_traffic": bpaxos["launches"],
            "telemetry": overhead_launches,
            "libbench": lib_launches, "geo": geo_launches,
            "sharded": sharded_launches,
            "sharded_board": board_launches}, errors)
        # Each decision path's host ms a call (one staged call each):
        # bench/call_split.py's replay of the sims' own calls.
        for kernel, path in (("union_reduce", "union_many"),
                             ("conflict_max", "conflict_max_many"),
                             ("all_equal", "all_identical")):
            next(r for r in kernels if r["name"] == kernel)[
                "decision_host_ms"] = split["paths"][path]["whole_ns"] / 1e6
        turns = {row["name"]: row for row in kernels
                 if "in_turns_ms_blocks" in row}
        # The board paths' host split (bench/call_split.py --paths board):
        # the geo leaders' release and drain calls.
        next(r for r in kernels if r["name"] == "release")[
            "geo_host_ns_per_call"] = split["board"]["whole_ns_per_call"]
        shapes = {name: next(r for r in kernels if r["name"] == name)[
            "at_launch_shapes"] for name in ("record_block", "release",
                                             "record_and_check",
                                             "shard_vote_count",
                                             "shard_commit")}
        fold_runs = next(r for r in kernels if r["name"] == "shard_fold")[
            "runs_at_launch_shapes"]
        phase(28, f"per-kernel figures on {name} ({smi}); in turns, ms "
            f"per call: "
            + "; ".join(f"{k} {row['ms']:.5f}"
                        + (f" (out= {row['ms_out']:.5f})" if "ms_out" in row
                           else "")
                        + f" vs library {row['library_ms']:.5f}, device "
                        f"{row['device_ms']} vs bound {row['bound_ms']:.4g},"
                        f" entry {row['entry_ms']:.5f}"
                        for k, row in turns.items())
            + "; K2 at the tracker's shapes (call / device us): "
            + ", ".join(f"{k} {v['call_ms'] * 1e3:.2f} / "
                        f"{(v['device_ms'] or 0) * 1e3:.3f}"
                        for k, v in shapes["record_block"].items())
            + "; K5 at the leaders' widths: "
            + ", ".join(f"{k} {v['call_ms'] * 1e3:.2f} / "
                        f"{(v['device_ms'] or 0) * 1e3:.3f}"
                        for k, v in shapes["release"].items())
            + "; K4 on chunks and runs: "
            + ", ".join(f"{k} {v['call_ms'] * 1e3:.2f} / "
                        f"{(v['device_ms'] or 0) * 1e3:.3f} x "
                        f"{v['launches_per_call']}"
                        for k, v in shapes["record_and_check"].items())
            + "; K19 at each mesh's rank 0 (call / device us): "
            + ", ".join(f"{k} {v['call_ms'] * 1e3:.2f} / "
                        f"{(v['device_ms'] or 0) * 1e3:.3f}"
                        for k, v in shapes["shard_vote_count"].items())
            + "; K20 likewise: "
            + ", ".join(f"{k} {v['call_ms'] * 1e3:.2f} / "
                        f"{(v['device_ms'] or 0) * 1e3:.3f}"
                        for k, v in shapes["shard_commit"].items())
            + "; K21 a run of 1 / 8 / 64 / 256 drains (device us, (1, 4)): "
            + ", ".join(f"{t} " + " / ".join(
                f"{(r['device_ms_per_run'] or 0) * 1e3:.3f}"
                for r in fold_runs[f"1x4 majority3 telemetry {t}"].values())
                for t in ("off", "on"))
            + "; whole calls (host ns): "
            + ", ".join(f"{k} {v['whole_ns']:.0f}"
                        for k, v in split["paths"].items())
            + f"; {time.perf_counter() - T0:.1f} s so far")

        tcp, tcp_launches, _ = phase_tcp(dev)
        add_path_launches(kernels, "tcp_cluster", tcp_launches)
        phase(29, f"MultiPaxos over TCP on {name} ({smi}), native codec "
            f"{tcp['native_codec']}: {TCP_WRITES} writes an arm, "
            f"{supernode.CLIENTS} clients x {TCP_PSEUDONYMS} in flight; "
            + "; ".join(f"{arm} {fig['writes_per_sec']:.0f} writes/s, p50 "
                        f"{fig['latency_p50_ms']:.3f} ms, p99 "
                        f"{fig['latency_p99_ms']:.3f} ms, launches "
                        f"{fig['launches']}"
                        for arm, fig in tcp["arms"].items())
            + f"; each cuda arm's executed set == the dict arm's; board "
            f"calls from the main and the event-loop thread ordered on "
            f"one stream; launches "
            + str({k: v for k, v in tcp_launches.items() if v}))
        log(json.dumps({"tcp_cluster": tcp}))
        lt = phase_transport(dev)
        phase(30, f"transport_lt on {name} ({smi}): "
            + "; ".join(f"{w}: per_frame {p['per_frame']['cmds_per_s']:.0f}"
                        f" / batched {p['batched']['cmds_per_s']:.0f} "
                        f"cmds/s ({p['throughput_ratio']:.2f}x) / ingest "
                        f"{p['ingest']['cmds_per_s']:.0f} "
                        f"({p['ingest_ratio']:.2f}x), "
                        f"syscalls/cmd "
                        f"{p['per_frame']['syscalls_per_cmd']:.4f} -> "
                        f"{p['batched']['syscalls_per_cmd']:.4f} "
                        f"({p['syscall_reduction']:.1f}x), frames/cmd "
                        f"{p['batched']['frames_per_cmd']:.4f}, bytes/drain "
                        f"{p['batched']['bytes_per_drain']:.0f}"
                        for w, p in lt["pairs"].items())
            + f"; the reference's gates (measured, not enforced): "
            f"batched >= 2x at >= 256 {lt['gates']['throughput_2x_passed']}"
            f", syscalls/cmd 10x lower at 1024 "
            f"{lt['gates']['syscalls_10x_passed']}; "
            f"{time.perf_counter() - T0:.1f} s in all")
        log(json.dumps({"transport_lt": lt}))
        reconfig, reconfig_launches = phase_reconfig(dev)
        add_path_launches(kernels, "reconfig_cluster", reconfig_launches)
        phase(31, f"the reconfigured MultiPaxos cluster on {name} ({smi}):"
            f" {reconfig['writes']} writes an arm over FileStorage WALs, "
            f"epoch 1 through a replacement, a second crash and a failover "
            f"that discovers it; "
            + "; ".join(f"{arm} {fig['writes_per_sec']:.1f} writes/s, "
                        f"K6 {fig['epoch_tracker_drains']} staged drains "
                        + (f"at {fig['epoch_drain_host_us']:.1f} us host"
                           if fig["epoch_drain_host_us"] is not None
                           else "")
                        + f", {fig['fsyncs']} fsyncs at "
                        f"{fig['fsync_ms_per_sync']:.3f} ms, launches "
                        f"{fig['launches']}"
                        for arm, fig in reconfig["arms"].items())
            + f"; logs equal the dict run's in "
            f"{reconfig['logs_equal_the_dict_run']}; launches "
            + str({k: v for k, v in reconfig_launches.items() if v}))
        log(json.dumps({"reconfig_cluster": reconfig}))
        fast, fast_launches, k6s_err = phase_fast(dev, rng)
        add_path_launches(kernels, "fast_cluster", fast_launches)
        k6s = fast["k6_stateless"]
        row = next(r for r in kernels if r["name"] == "check_batch_multi")
        at13 = k6s["[1, 3] K=1"]
        row.update({
            # The fast path's launch shape: a leader's check at f = 1,
            # one staged call (the tensor wrapper's [256, 4] figures of
            # phase 28 stay under "tensor_256x4").
            "tensor_256x4": {k: row[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "shape")},
            "ms": at13["staged_ms"], "device_ms": at13["staged_device_ms"],
            "plain_ms": at13["plain_ms"], "bound_ms": at13["bound_ms"],
            "bound_by": "bytes", "bytes": at13["bytes"],
            "shape": "[1, 3] K=1 G=1 (SpecChecker.check: one staged call)",
            "max_abs_err": max(row["max_abs_err"], k6s_err),
            "at_shapes": k6s,
            "check_host_us_p50": {
                arm: runs["cuda"]["check_host_us_p50"]
                for arm, runs in fast["arms"].items()}})
        phase(32, f"Fast Paxos and Fast MultiPaxos on {name} ({smi}): K6 "
            f"stateless == plain at "
            + ", ".join(f"{key} (staged {fig['staged_ms'] * 1e3:.2f} us, "
                        f"device {(fig['staged_device_ms'] or 0) * 1e3:.3f}"
                        f" us; tensor {fig['tensor_ms'] * 1e3:.2f} us, "
                        f"device {(fig['tensor_device_ms'] or 0) * 1e3:.3f}"
                        f" us; bound {fig['bound_ms'] * 1e3:.4f} us)"
                        for key, fig in k6s.items() if key != "floor")
            + f"; floor {(k6s['floor']['fill_[1]_device_ms'] or 0) * 1e3:.3f}"
            f" us; Fast Paxos on the card == host "
            f"({len(fast['fast_paxos'])} drives); fast_sim "
            f"{FAST_COMMANDS} commands x {FAST_CLIENTS} clients: "
            + "; ".join(f"{arm} {b} {fig['commands_per_sec']:.0f} cmds/s, "
                        f"checks {fig['checks']}, K6 "
                        f"{fig['check_batch_multi_launches']}, host "
                        f"{fig['check_host_us_p50']:.2f} us a check (p50)"
                        for arm, runs in fast["arms"].items()
                        for b, fig in runs.items())
            + f"; the cuda logs and replies == the host runs'; launches "
            + str({k: v for k, v in fast_launches.items() if v})
            + f"; {time.perf_counter() - T0:.1f} s in all")
        log(json.dumps({"fast_cluster": fast}))
        t33 = time.perf_counter()
        mmp, mmp_launches, k6m_err = phase_matchmaker(dev, rng)
        add_path_launches(kernels, "mmp_cluster", mmp_launches)
        k6m = mmp["k6_stateless"]
        row["max_abs_err"] = max(row["max_abs_err"], k6m_err)
        row["at_matchmaker_shapes"] = k6m
        row["check_host_us_p50"].update({
            f"mmp_{arm}": runs["cuda"]["check_host_us"]["p50"]
            for arm, runs in mmp["arms"].items()})
        phase(33, f"Matchmaker MultiPaxos on {name} ({smi}): K6 stateless "
            f"== plain at "
            + ", ".join(f"{key} {'/'.join(fig['planes'])} (check_all "
                        f"{fig['staged_ms'] * 1e3:.2f} us, device "
                        f"{(fig['staged_device_ms'] or 0) * 1e3:.3f} us; "
                        f"check_batch {fig['check_batch_ms'] * 1e3:.2f} us, "
                        f"device "
                        f"{(fig['check_batch_device_ms'] or 0) * 1e3:.3f} "
                        f"us; plain {fig['plain_ms'] * 1e3:.2f} us; bound "
                        f"{fig['bound_ms'] * 1e3:.4f} us)"
                        for key, fig in k6m.items())
            + f", every responder set; matchmaker_sim {MATCHMAKER_WRITES} "
            f"writes an arm: "
            + "; ".join(f"{arm} {b} {fig['writes_per_sec']:.0f} writes/s, "
                        f"{fig['configurations']} configurations, epoch "
                        f"{fig['matchmaker_epoch']}, phase-1 checks "
                        f"{fig['phase1_checks']}, K6 "
                        f"{fig['check_batch_multi_launches']}, host "
                        f"{fig['check_host_us']['p50']:.2f} us a check "
                        f"(p50)"
                        + (f", set-up {fig['setup_host_us']['mean']:.1f} "
                           f"us a phase 1, {fig['checker_builds']} builds "
                           f"at {fig['build_host_us']['p50']:.1f} us, K "
                           f"{fig['k_counts']}" if b == "cuda" else "")
                        for arm, runs in mmp["arms"].items()
                        for b, fig in runs.items())
            + f"; the cuda logs and replies == the dict runs'; launches "
            + str({k: v for k, v in mmp_launches.items() if v})
            + f"; phase 33 {time.perf_counter() - t33:.1f} s; "
            f"{time.perf_counter() - T0:.1f} s in all")
        log(json.dumps({"mmp_cluster": mmp}))
        t34 = time.perf_counter()
        ingest, ingest_launches = phase_ingest(dev, tcp)
        add_path_launches(kernels, "ingest_tcp", ingest_launches)
        phase(34, f"the ingest fabric and admission over TCP on {name} "
            f"({smi}): {TCP_WRITES} writes an arm, {supernode.CLIENTS} "
            f"clients x {TCP_PSEUDONYMS} in flight through "
            f"{INGEST_BATCHERS} ingest batchers, the leaders' in-flight "
            f"limit {INGEST_INFLIGHT_LIMIT}; "
            + "; ".join(
                f"{arm} {fig['writes_per_sec']:.0f} writes/s (phase 29 "
                f"{tcp['arms'][arm]['writes_per_sec']:.0f}), p50 "
                f"{fig['latency_p50_ms']:.3f} ms, p99 "
                f"{fig['latency_p99_ms']:.3f} ms, Rejected "
                f"{fig['rejected_commands']} commands, IngestRuns "
                f"{fig['serving']['ingest_counts'].get('IngestRun', 0)}, "
                f"ack rows by sink / per message "
                f"{fig['serving']['ack_rows']['sink']} / "
                f"{fig['serving']['ack_rows']['message']}, votes "
                f"{fig['votes_by_shape']}, launches {fig['launches']}"
                + (f", {fig['kernel_launches_per_write']['kernel']} a "
                   f"write {fig['kernel_launches_per_write']['phase_34']:.4f}"
                   f" (phase 29 "
                   f"{fig['kernel_launches_per_write']['phase_29']:.4f})"
                   if "kernel_launches_per_write" in fig else "")
                for arm, fig in ingest["arms"].items())
            + f"; each cuda arm's executed set == the dict arm's; launches "
            + str({k: v for k, v in ingest_launches.items() if v})
            + f"; phase 34 {time.perf_counter() - t34:.1f} s; "
            f"{time.perf_counter() - T0:.1f} s in all")
        log(json.dumps({"ingest_tcp": ingest}))
        t35 = time.perf_counter()
        reads, reads_launches = phase_read_batch(dev)
        add_path_launches(kernels, "read_batch_cluster", reads_launches)
        phase(35, f"MultiPaxos with read batchers on {name} ({smi}): "
            f"{reads['operations']} operations an arm, "
            f"{reads['read_batchers']} read batchers; "
            + "; ".join(
                f"{scheme} {backend} {fig['writes_per_sec']:.0f} writes/s "
                f"{fig['reads_per_sec']:.0f} reads/s, "
                f"{fig['batch_max_slot_requests']} BatchMaxSlotRequests, "
                + (f"{fig['reads_per_batch']:.2f} reads a batch"
                   if fig["reads_per_batch"] is not None else "no batch")
                + f", device drains {fig['device_drains']}, launches "
                f"{fig['launches']}"
                for scheme, arms in reads["schemes"].items()
                for backend, fig in arms.items())
            + f"; the cuda logs and replies == the dict arms'; launches "
            + str({k: v for k, v in reads_launches.items() if v})
            + f"; phase 35 {time.perf_counter() - t35:.1f} s; "
            f"{time.perf_counter() - T0:.1f} s in all")
        log(json.dumps({"read_batch_cluster": reads}))
        t36 = time.perf_counter()
        traced, traced_launches = phase_traced(dev, tcp)
        add_path_launches(kernels, "traced_tcp", traced_launches)
        for arm, fig in traced["arms"].items():
            log(f"      traced {arm} latency breakdown (stage: count, p50 / "
                f"p99 us): " + "; ".join(
                    f"{stage}: {row['count']}, {row['p50_us']} / "
                    f"{row['p99_us']}"
                    for stage, row in fig["breakdown"].items())
                + f"; the longest spans (us): {fig['slowest_spans']}")
        phase(36, f"MultiPaxos over TCP traced on {name} ({smi}): "
            f"{traced['writes']} writes an arm, sample rate "
            f"{traced['sample_rate']}; "
            + "; ".join(
                f"{arm} {fig['writes_per_sec']:.0f} writes/s (untraced, "
                f"phase 29: {fig['untraced_writes_per_sec']:.0f}), p50 "
                f"{fig['latency_p50_ms']:.3f} ms, p99 "
                f"{fig['latency_p99_ms']:.3f} ms (after the first round "
                f"{fig['latency_p50_ms_steady']:.3f} / "
                f"{fig['latency_p99_ms_steady']:.3f}; phase 29's "
                f"{tcp['arms'][arm]['latency_p50_ms_steady']:.3f} / "
                f"{tcp['arms'][arm]['latency_p99_ms_steady']:.3f}), loops "
                f"busy {fig['loop_busy_share']}, {fig['spans']} spans, "
                f"quorum-kernel spans {sum(fig['quorum_kernel_spans'].values())}"
                f" / device drains {sum(fig['device_drains'].values())}, "
                f"flight records {fig['flight_records']}, launches "
                f"{fig['launches']}"
                for arm, fig in traced["arms"].items())
            + f"; a write's chain from its client through a "
            f"ProxyLeader's quorum-kernel stage to the reply in every arm; "
            f"launches "
            + str({k: v for k, v in traced_launches.items() if v})
            + f"; phase 36 {time.perf_counter() - t36:.1f} s; "
            f"{time.perf_counter() - T0:.1f} s in all")
        log(json.dumps({"traced_tcp": traced}, default=str))
        print(json.dumps({"kernels": kernels}), flush=True)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
