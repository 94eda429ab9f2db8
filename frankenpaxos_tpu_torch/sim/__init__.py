"""Deterministic randomized protocol simulation.

The port's copy of ``frankenpaxos_tpu/sim/`` (the property simulator;
the jitted link mask of ``ops/simwave.py`` is not part of it). Reference
behavior: shared/src/test/scala/frankenpaxos/simulator/
(SimulatedSystem.scala:152-200, Simulator.scala:221-266): a
QuickCheck-for-stateful-systems harness that runs many random executions
of a protocol wired over a SimTransport, checks invariants after every
step, and minimizes failing traces to near-minimal reproducers.
"""

from frankenpaxos_tpu_torch.sim.simulator import (
    BadHistory,
    SimulatedSystem,
    Simulator,
)

__all__ = ["BadHistory", "SimulatedSystem", "Simulator"]
