"""StateMachine / TypedStateMachine / ConflictIndex contracts.

Reference behavior: statemachine/StateMachine.scala:11-46 (run, conflicts,
to_bytes/from_bytes snapshots, conflict_index, top_k_conflict_index),
TypedStateMachine.scala:70+ (typed I/O over byte serializers),
ConflictIndex.scala:43-66 (put/put_snapshot/remove/get_conflicts and the
top-one/top-k variants used by the BPaxos dependency services).
"""

from __future__ import annotations

import abc
from typing import Generic, Hashable, TypeVar

from frankenpaxos_tpu_torch.runtime.serializer import PickleSerializer, Serializer
from frankenpaxos_tpu_torch.utils.topk import TopK, TopOne, VertexIdLike

K = TypeVar("K", bound=Hashable)
I = TypeVar("I")
O = TypeVar("O")


class ConflictIndex(abc.ABC, Generic[K, I]):
    """Map from command keys to commands that answers "which stored
    commands conflict with this one?" (ConflictIndex.scala:43-66)."""

    @abc.abstractmethod
    def put(self, key: K, command: I) -> None:
        ...

    @abc.abstractmethod
    def put_snapshot(self, key: K) -> None:
        """A snapshot conflicts with everything, including snapshots."""

    def remove(self, key: K) -> None:
        raise NotImplementedError

    def get_conflicts(self, command: I) -> set[K]:
        raise NotImplementedError

    def get_top_one_conflicts(self, command: I) -> TopOne[K]:
        raise NotImplementedError

    def get_top_k_conflicts(self, command: I) -> TopK[K]:
        raise NotImplementedError


class StateMachine(abc.ABC):
    """A deterministic state machine over byte commands."""

    @abc.abstractmethod
    def run(self, input: bytes) -> bytes:
        ...

    @abc.abstractmethod
    def conflicts(self, first_command: bytes, second_command: bytes) -> bool:
        """Whether the two commands fail to commute in some state."""

    @abc.abstractmethod
    def to_bytes(self) -> bytes:
        """Snapshot (does not mutate state)."""

    @abc.abstractmethod
    def from_bytes(self, snapshot: bytes) -> None:
        """Replace state with a snapshot from ``to_bytes``."""

    def conflict_index(self) -> ConflictIndex:
        return NaiveConflictIndex(self.conflicts)

    def top_k_conflict_index(self, k: int, num_leaders: int,
                             like: VertexIdLike) -> ConflictIndex:
        return NaiveTopKConflictIndex(self.conflicts, k, num_leaders, like)


class NaiveConflictIndex(ConflictIndex):
    """O(n) scan per get_conflicts; the default the reference also ships
    (StateMachine.scala:36-39)."""

    SNAPSHOT = object()

    def __init__(self, conflicts):
        self._conflicts = conflicts
        self._commands: dict = {}

    def put(self, key, command) -> None:
        self._commands[key] = command

    def put_snapshot(self, key) -> None:
        self._commands[key] = NaiveConflictIndex.SNAPSHOT

    def remove(self, key) -> None:
        self._commands.pop(key, None)

    def get_conflicts(self, command) -> set:
        return {k for k, c in self._commands.items()
                if c is NaiveConflictIndex.SNAPSHOT
                or self._conflicts(c, command)}


class NaiveTopKConflictIndex(NaiveConflictIndex):
    """Same scan, but folds conflicts into TopOne/TopK per-leader maxima
    (the shape BPaxos dep services consume)."""

    def __init__(self, conflicts, k: int, num_leaders: int,
                 like: VertexIdLike):
        super().__init__(conflicts)
        self.k = k
        self.num_leaders = num_leaders
        self.like = like

    def get_top_one_conflicts(self, command) -> TopOne:
        top = TopOne(self.num_leaders, self.like)
        for key in self.get_conflicts(command):
            top.put(key)
        return top

    def get_top_k_conflicts(self, command) -> TopK:
        top = TopK(self.k, self.num_leaders, self.like)
        for key in self.get_conflicts(command):
            top.put(key)
        return top


class TypedStateMachine(StateMachine, Generic[I, O]):
    """A state machine with typed inputs/outputs, adapted to bytes via
    serializers (TypedStateMachine.scala:70+)."""

    input_serializer: Serializer = PickleSerializer()
    output_serializer: Serializer = PickleSerializer()

    @abc.abstractmethod
    def typed_run(self, input: I) -> O:
        ...

    @abc.abstractmethod
    def typed_conflicts(self, first_command: I, second_command: I) -> bool:
        ...

    def run(self, input: bytes) -> bytes:
        return self.output_serializer.to_bytes(
            self.typed_run(self.input_serializer.from_bytes(input)))

    def conflicts(self, first_command: bytes, second_command: bytes) -> bool:
        return self.typed_conflicts(
            self.input_serializer.from_bytes(first_command),
            self.input_serializer.from_bytes(second_command))

    def typed_conflict_index(self) -> ConflictIndex:
        return NaiveConflictIndex(self.typed_conflicts)


def state_machine_by_name(name: str) -> StateMachine:
    """CLI selection by name (StateMachine.scala:48-59)."""
    from frankenpaxos_tpu_torch.statemachine.impls import (
        AppendLog, KeyValueStore, Noop, Register)

    machines = {
        "AppendLog": AppendLog,
        "KeyValueStore": KeyValueStore,
        "Noop": Noop,
        "Register": Register,
    }
    if name not in machines:
        raise ValueError(
            f"{name} is not one of {', '.join(sorted(machines))}")
    return machines[name]()
