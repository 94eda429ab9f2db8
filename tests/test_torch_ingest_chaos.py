"""The port's twin of ``tests/protocols/test_ingest_chaos.py``
(paxingest chaos): MultiPaxos clusters whose clients route every write
through WAL-free ingest batchers, explored under the WAL chaos oracle
(mutual prefix compatibility, chosen-uniqueness per slot, exactly-once
execution) with batcher crash/restart interleaved with acceptor and
replica crashes, partitions and leader changes -- on the port's
``MultiPaxosWalSimulated`` (``tests/test_torch_reconfig_cluster.py``),
with the dict oracle and the cuda backends on the CPU. The line being
held: a batcher death may cost client retries, but never an acked write
and never a duplicate execution.
"""

import dataclasses
import random

from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
    crash_restart_ingest_batcher,
    make_multipaxos,
)
from frankenpaxos_tpu_torch.sim import Simulator
import pytest

from tests.test_torch_reconfig_cluster import (
    backend,
    BACKENDS,
    MultiPaxosWalSimulated,
)


@dataclasses.dataclass(frozen=True)
class CrashIngestCmd:
    index: int


@dataclasses.dataclass(frozen=True)
class FlushIngestCmd:
    index: int


class MultiPaxosIngestSimulated(MultiPaxosWalSimulated):
    """The WAL chaos matrix with the ingest plane in front: every
    client write flows client -> IngestBatcher -> leader as a
    pre-encoded run, and batchers crash/restart (empty -- they are
    WAL-free) alongside the durable roles."""

    def new_system(self, seed):
        sim = super().new_system(seed)
        assert sim.ingest_batchers, (
            "ingest chaos sims need num_ingest_batchers >= 1")
        return sim

    def generate_command(self, sim, rng: random.Random):
        # Batcher-specific chaos/flush on top of the WAL matrix's mix.
        if rng.random() < 0.15:
            return CrashIngestCmd(
                rng.randrange(len(sim.ingest_batchers)))
        staged = [i for i, b in enumerate(sim.ingest_batchers)
                  if b._staged_commands or b._staged_columns]
        if staged and rng.random() < 0.3:
            return FlushIngestCmd(rng.choice(staged))
        return super().generate_command(sim, rng)

    def run_command(self, sim, command):
        if isinstance(command, CrashIngestCmd):
            crash_restart_ingest_batcher(sim, command.index)
            return sim
        if isinstance(command, FlushIngestCmd):
            sim.ingest_batchers[command.index].flush_ingest()
            return sim
        return super().run_command(sim, command)


@pytest.mark.parametrize("kwargs", [
    dict(f=1, num_ingest_batchers=2),
    dict(f=1, num_ingest_batchers=2, coalesced=True),
    dict(f=2, num_ingest_batchers=3, coalesced="mixed"),
    # paxfan scale-out: a 4-shard ring with a 1-run descriptor window
    # -- every ship blocks on an IngestCredit watermark, so batcher
    # kills interleaved with partitions and leader changes exercise
    # the credit/void/resend machinery, not just staging loss.
    dict(f=1, num_ingest_batchers=4, ingest_pipeline_window=1),
], ids=["f1", "f1-coalesced", "f2-mixed", "f1-ring4-window1"])
def test_ingest_chaos_no_divergence(kwargs, backend):
    """The reference's regression-smoke scale."""
    simulated = MultiPaxosIngestSimulated(**kwargs, **backend)
    failure = Simulator(simulated, run_length=150, num_runs=10).run(seed=0)
    assert failure is None, str(failure)


@pytest.mark.parametrize("arm", sorted(BACKENDS))
def test_batcher_death_costs_retries_never_acked_loss(arm):
    """Deterministic version of the oracle's headline: stage writes at
    a batcher, kill it BEFORE it flushes (staged commands die), and
    drive the clients' resend timers -- every write still completes
    exactly once."""
    sim = make_multipaxos(f=1, num_ingest_batchers=2, num_clients=2,
                          wal=True, seed=11, **BACKENDS[arm])
    acked: list = []
    for i in range(6):
        sim.clients[i % 2].write(i % 4 if i < 4 else i, b"w%d" % i,
                                 lambda r, i=i: acked.append(i))
    # The writes are staged (or in flight to) batchers; kill both
    # before any flush timer fires.
    crash_restart_ingest_batcher(sim, 0)
    crash_restart_ingest_batcher(sim, 1)
    sim.transport.deliver_all_coalesced(max_steps=2000)
    # Anything lost in the dead batchers comes back via client resends.
    for _ in range(4):
        for t in list(sim.transport.running_timers()):
            if t.name.startswith(("resendWrite", "ingestFlush")):
                t.run()
        sim.transport.deliver_all_coalesced(max_steps=2000)
        if len(acked) == 6:
            break
    assert sorted(acked) == list(range(6)), acked
    # Exactly-once: no replica executed a payload twice.
    for replica in sim.replicas:
        seq = replica.state_machine.get()
        assert len(set(seq)) == len(seq), seq


def test_flush_cmd_available_on_staged_batchers():
    """The chaos generator's staged-batcher probe reads real state."""
    sim = make_multipaxos(f=1, num_ingest_batchers=1, num_clients=1,
                          seed=0)
    sim.clients[0].write(0, b"w0")
    # The write is in flight to the batcher; deliver just the message
    # layer without draining (adversarial mode), then check staging.
    rng = random.Random(0)
    for _ in range(50):
        cmd = sim.transport.generate_command(rng)
        if cmd is None:
            break
        sim.transport.run_command(cmd)
        if sim.ingest_batchers[0]._staged_commands:
            break
    batcher = sim.ingest_batchers[0]
    if batcher._staged_commands:
        batcher.flush_ingest()
        assert not batcher._staged_commands
