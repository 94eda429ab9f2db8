"""SimulatedSystem / Simulator: property-based testing with minimization.

The port's copy of ``frankenpaxos_tpu/sim/simulator.py``; it holds no
device code.

Reference behavior: simulator/SimulatedSystem.scala:152-200 (define a
system, command generation, command execution, and three invariant
hooks) and simulator/Simulator.scala:221-266 (run ``num_runs`` random
executions of ``run_length`` commands, check invariants after every
step, and on failure shrink the trace to a near-minimal reproducer,
reporting the seed).

Every protocol test wires all roles over one SimTransport in-process and
interleaves protocol commands (e.g. client writes) with transport
commands (deliver any in-flight message, fire any running timer) --
implicitly exploring reordering, duplication-by-resend, and loss.
"""

from __future__ import annotations

import abc
import dataclasses
import random
from typing import Any, Generic, Optional, Sequence, TypeVar

System = TypeVar("System")
Command = TypeVar("Command")


@dataclasses.dataclass
class BadHistory(Generic[Command]):
    """A failing run: the seed that found it, the (minimized) command
    trace, and the invariant violation."""

    seed: int
    history: list
    error: str

    def __str__(self):
        lines = [f"seed: {self.seed}", f"error: {self.error}", "history:"]
        lines.extend(f"  [{i}] {c!r}" for i, c in enumerate(self.history))
        return "\n".join(lines)


class SimulatedSystem(abc.ABC, Generic[System, Command]):
    """A system under randomized test (SimulatedSystem.scala:152-200)."""

    @abc.abstractmethod
    def new_system(self, seed: int) -> System:
        """Fresh system; all nondeterminism seeded from ``seed``."""

    @abc.abstractmethod
    def generate_command(self, system: System,
                         rng: random.Random) -> Optional[Command]:
        """A random next command, or None if nothing can happen."""

    @abc.abstractmethod
    def run_command(self, system: System, command: Command) -> System:
        """Execute a command. Must tolerate commands that no longer apply
        (needed for trace minimization replays)."""

    def state_invariant(self, system: System) -> Optional[str]:
        """Checked after every step; return an error string on violation."""
        return None

    def step_invariant(self, old_state: Any,
                       new_state: Any) -> Optional[str]:
        """Relates consecutive states (e.g. "logs only grow")."""
        return None

    def history_invariant(self, states: Sequence[Any]) -> Optional[str]:
        """Checked over the whole run's state sequence at the end."""
        return None

    def get_state(self, system: System) -> Any:
        """Projection handed to step/history invariants. Must be an
        immutable snapshot if step/history invariants are used."""
        return None


class Simulator(Generic[System, Command]):
    def __init__(self, sim: SimulatedSystem[System, Command],
                 run_length: int = 100, num_runs: int = 100,
                 minimize: bool = True):
        self.sim = sim
        self.run_length = run_length
        self.num_runs = num_runs
        self.minimize = minimize
        #: Commands executed across every run this instance performed,
        #: including minimization replays (they are part of the work a
        #: soak pays for); divided by wall time, the simulator's
        #: throughput.
        self.commands_run = 0

    def run(self, seed: int = 0) -> Optional[BadHistory]:
        """Run ``num_runs`` random executions; return the first failure
        (minimized), or None if all runs pass
        (Simulator.scala:221-241)."""
        for i in range(self.num_runs):
            run_seed = seed + i
            failure = self._run_once(run_seed)
            if failure is not None:
                if self.minimize:
                    failure = self._minimize(run_seed, failure)
                return failure
        return None

    # --- one run ----------------------------------------------------------
    def _run_once(self, seed: int) -> Optional[BadHistory]:
        rng = random.Random(seed)
        system = self.sim.new_system(seed)
        history: list = []
        return self._check_run(seed, system, history, rng=rng)

    def _replay(self, seed: int, trace: list) -> Optional[BadHistory]:
        system = self.sim.new_system(seed)
        return self._check_run(seed, system, list(trace), rng=None)

    def _check_run(self, seed: int, system, history: list,
                   rng: Optional[random.Random]) -> Optional[BadHistory]:
        executed: list = []
        states = [self.sim.get_state(system)]

        def fail(error: str) -> BadHistory:
            return BadHistory(seed, executed, error)

        error = self.sim.state_invariant(system)
        if error:
            return fail(f"initial state invariant: {error}")

        steps = self.run_length if rng is not None else len(history)
        for step in range(steps):
            if rng is not None:
                command = self.sim.generate_command(system, rng)
                if command is None:
                    break
            else:
                command = history[step]
            executed.append(command)
            self.commands_run += 1
            system = self.sim.run_command(system, command)
            states.append(self.sim.get_state(system))

            error = self.sim.state_invariant(system)
            if error:
                return fail(f"state invariant: {error}")
            error = self.sim.step_invariant(states[-2], states[-1])
            if error:
                return fail(f"step invariant: {error}")

        error = self.sim.history_invariant(states)
        if error:
            return fail(f"history invariant: {error}")
        return None

    # --- shrinking (Simulator.scala:243-266) ------------------------------
    def _minimize(self, seed: int, failure: BadHistory) -> BadHistory:
        """Greedy delta debugging: drop chunks (halving down to single
        commands) while the replayed trace still fails."""
        trace = list(failure.history)
        best = failure
        chunk = max(1, len(trace) // 2)
        while chunk >= 1:
            i = 0
            progress = False
            while i < len(trace):
                candidate = trace[:i] + trace[i + chunk:]
                replayed = self._replay(seed, candidate)
                if replayed is not None:
                    trace = candidate
                    best = replayed
                    progress = True
                else:
                    i += chunk
            if not progress:
                chunk //= 2
        return best
