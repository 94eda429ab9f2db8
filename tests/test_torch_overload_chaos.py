"""The port's twin of ``tests/protocols/test_overload_chaos.py``
(paxload overload chaos): offered load far past ARMED admission
control, combined with kill-restart and live reconfigurations, under the
chosen-uniqueness oracle -- on the port's ``MultiPaxosReconfigSimulated``
(``tests/test_torch_reconfig_cluster.py``), with the dict oracle and
the cuda backends on the CPU.

Two arms:

  * ``MultiPaxosOverloadSimulated`` -- the randomized run: write BURSTS that overflow
    the in-flight budget and the bounded inbox interleaved with
    crash_restart, partitions, leader changes, and member swaps. On
    top of the inherited oracles (SM prefix compatibility,
    exactly-once, per-slot chosen uniqueness) it asserts that no
    ACKED write is ever missing from the executed state and that no
    CONTROL-plane frame is ever refused by a bounded inbox.
  * a deterministic conclusion test -- overload + SIGKILL-style
    crash_restart + reconfigure, then settle: EVERY issued request
    must end in an ack, or in the explicit bounded-retry
    RETRY_EXHAUSTED conclusion. Nothing wedges silently.

Only the clock-free admission mechanisms are armed here (in-flight
slot budget + bounded inbox): the token bucket and CoDel read a clock,
which would make the randomized runs non-replayable
(tests/test_torch_serve.py checks those against a scripted clock).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
    add_replacement_acceptor,
    crash_restart_acceptor,
    make_multipaxos,
)
from frankenpaxos_tpu_torch.reconfig import Reconfigure
from frankenpaxos_tpu_torch.serve.backoff import RETRY_EXHAUSTED
from frankenpaxos_tpu_torch.serve.lanes import frame_lane, LANE_CONTROL
from frankenpaxos_tpu_torch.sim import Simulator
import pytest

from tests.test_torch_reconfig_cluster import (
    backend,
    BACKENDS,
    MultiPaxosReconfigSimulated,
    WriteCmd,
)

#: Deterministic admission knobs (no token bucket / CoDel: those read
#: a clock; see module docstring). Tight enough that bursts overflow.
ARMED = dict(admission_inflight_limit=4, admission_inbox_capacity=8,
             admission_inbox_policy="reject")


@dataclasses.dataclass
class BurstCmd:
    """An open-loop pressure spike: many writes staged at once, far
    past the in-flight budget -- the overload the admission layer
    exists to shed."""

    client: int
    pseudonyms: tuple
    counter_base: int


class MultiPaxosOverloadSimulated(MultiPaxosReconfigSimulated):
    """Reconfig chaos + overload pressure + armed admission."""

    def __init__(self, **harness_kwargs):
        harness_kwargs.setdefault("leader_admission", dict(ARMED))
        harness_kwargs.setdefault("client_retry_budget", 3)
        super().__init__(**harness_kwargs)

    def new_system(self, seed):
        sim = super().new_system(seed)
        sim._acked = []
        sim._concluded = {}
        sim._control_shed = []
        # Control-plane frames must NEVER be refused by the bounded
        # inbox: observe every admission decision at the transport.
        original = sim.transport._admit_to_inbox

        def checked(src, dst, data):
            admitted = original(src, dst, data)
            if not admitted and frame_lane(data) == LANE_CONTROL:
                sim._control_shed.append((src, dst))
            return admitted

        sim.transport._admit_to_inbox = checked
        return sim

    def generate_command(self, sim, rng: random.Random):
        if rng.random() < 0.15:
            client = rng.randrange(len(sim.clients))
            busy = sim.clients[client].states
            pseudonyms = tuple(p for p in range(4, 24) if p not in busy)
            if pseudonyms:
                sim._counter += len(pseudonyms)
                return BurstCmd(client, pseudonyms,
                                sim._counter - len(pseudonyms))
        return super().generate_command(sim, rng)

    def run_command(self, sim, command):
        if isinstance(command, BurstCmd):
            client = sim.clients[command.client]
            for i, pseudonym in enumerate(command.pseudonyms):
                if pseudonym in client.states:
                    continue
                self._tracked_write(sim, command.client, pseudonym,
                                    b"b%d" % (command.counter_base + i))
            client.flush_writes()
            return sim
        if isinstance(command, WriteCmd):
            client = sim.clients[command.client]
            if command.pseudonym not in client.states:
                self._tracked_write(sim, command.client,
                                    command.pseudonym, command.payload)
            return sim
        return super().run_command(sim, command)

    def _tracked_write(self, sim, client: int, pseudonym: int,
                       payload: bytes) -> None:
        def conclude(result, key=(client, pseudonym, payload)) -> None:
            sim._concluded[key] = result
            if result is not RETRY_EXHAUSTED:
                sim._acked.append(key[2])

        sim.clients[client].write(pseudonym, payload, conclude)

    def state_invariant(self, sim) -> Optional[str]:
        error = super().state_invariant(sim)
        if error is not None:
            return error
        if sim._control_shed:
            return ("control-plane frame refused by a bounded inbox: "
                    f"{sim._control_shed[0]}")
        executed: set = set()
        for replica in sim.replicas:
            executed.update(replica.state_machine.get())
        lost = [p for p in sim._acked if p not in executed]
        if lost:
            return f"acked writes missing from every replica: {lost[:3]}"
        return None


@pytest.mark.parametrize("kwargs", [dict(f=1),
                                    dict(f=1, coalesced=True)],
                         ids=["f1", "f1-coalesced"])
def test_simulation_overload_chaos_no_divergence(kwargs, backend):
    """The reference's regression-smoke scale."""
    simulated = MultiPaxosOverloadSimulated(**kwargs, **backend)
    failure = Simulator(simulated, run_length=150, num_runs=10).run(seed=0)
    assert failure is None, str(failure)


# --- deterministic conclusion scenario ----------------------------------


def _settle(sim, done, max_waves: int = 200) -> None:
    for _ in range(max_waves):
        sim.transport.deliver_all_coalesced(max_steps=500)
        if done():
            return
        for timer in list(sim.transport.running_timers()):
            if timer.name in ("recover",) \
                    or timer.name.startswith(("backoff", "resendWrite",
                                              "resendClientRequest",
                                              "resendEpochCommit",
                                              "resendEpochSync",
                                              "resendPhase1as")):
                sim.transport.trigger_timer(timer.id)
        for client in sim.clients:
            client.flush_writes()
    raise AssertionError("overload scenario did not settle")


@pytest.mark.parametrize("arm", sorted(BACKENDS))
def test_overload_kill_reconfigure_every_request_concludes(arm):
    """The reference's safety acceptance in sim form: 10x-style burst
    load against a tight admission budget, an acceptor SIGKILLed and
    restarted mid-burst, a live member swap, a second kill -- and at
    settle EVERY request has an explicit conclusion (ack or
    RETRY_EXHAUSTED), every acked write is executed exactly once, and
    the control plane (Phase1/epoch traffic driving the recovery)
    was never shed behind the client-lane flood."""
    sim = make_multipaxos(
        f=1, coalesced=True, wal=True, num_clients=2,
        leader_admission=dict(ARMED),
        client_retry_budget=6, **BACKENDS[arm])
    control_shed = []
    original = sim.transport._admit_to_inbox

    def checked(src, dst, data):
        admitted = original(src, dst, data)
        if not admitted and frame_lane(data) == LANE_CONTROL:
            control_shed.append((src, dst))
        return admitted

    sim.transport._admit_to_inbox = checked

    results: dict = {}
    issued = 0

    def write_burst(count: int) -> None:
        nonlocal issued
        for _ in range(count):
            client = issued % 2
            # 2x32 distinct sessions: with the in-flight budget
            # actually binding (admitted-but-pending work counts),
            # earlier writes stay pending across bursts, and reusing
            # their pseudonyms would silently shrink the offered load.
            pseudonym = issued // 2 % 32
            payload = b"ov%d" % issued
            if pseudonym in sim.clients[client].states:
                continue
            sim.clients[client].write(
                pseudonym, payload,
                (lambda r, k=(payload,): results.__setitem__(k, r)))
            issued += 1
        for c in sim.clients:
            c.flush_writes()

    # Overload: 32 writes against an in-flight budget of 4.
    write_burst(32)
    sim.transport.deliver_all_coalesced(max_steps=200)
    # SIGKILL-style crash + restart of an acceptor mid-overload.
    crash_restart_acceptor(sim, 0)
    write_burst(8)
    sim.transport.deliver_all_coalesced(max_steps=200)
    # Live member swap under pressure.
    leader = next(ld for ld in sim.leaders
                  if type(ld.state).__name__ == "_Phase2")
    members = list(leader.epochs.current().members)
    replacement = "acceptor-0-r0"
    members[0] = replacement
    add_replacement_acceptor(sim, tuple(members), replacement)
    for ld in sim.leaders:
        ld.receive("chaos-admin", Reconfigure(members=tuple(members)))
    write_burst(8)
    sim.transport.deliver_all_coalesced(max_steps=300)
    # Second kill: progress now depends on the swapped-in member.
    crash_restart_acceptor(sim, 1)
    write_burst(8)

    _settle(sim, lambda: (len(results) == issued
                          and not any(c.states for c in sim.clients)))

    assert len(results) == issued and issued >= 40
    acked = [k[0] for k, r in results.items() if r is not RETRY_EXHAUSTED]
    giveups = [k for k, r in results.items() if r is RETRY_EXHAUSTED]
    # Overload against a budget of 4 with a finite retry budget MUST
    # shed something, and chaos must not turn sheds into silence.
    assert acked, "nothing was ever admitted"
    for replica in sim.replicas:
        seq = replica.state_machine.get()
        assert len(set(seq)) == len(seq)  # exactly-once
    executed = set()
    for replica in sim.replicas:
        executed.update(replica.state_machine.get())
    lost = [p for p in acked if p not in executed]
    assert not lost, f"acked writes lost: {lost[:3]}"
    assert not control_shed, control_shed
    # The leader's admission layer did real work during the run.
    active = [ld for ld in sim.leaders if ld.admission is not None
              and (ld.admission.rejected or ld.admission.admitted)]
    assert active
    del giveups  # explicit conclusions; count is seed-dependent
