"""State machine implementations: AppendLog, KeyValueStore, Noop, Register.

Reference behavior: statemachine/AppendLog.scala:10+ (append string,
return index; everything conflicts), KeyValueStore.scala:38+ (get/set
batches; conflicts iff key sets intersect and at least one writes;
inverted-index conflict index), Noop.scala:10+, Register.scala:10+,
ReadableAppendLog.scala.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional, Union

from frankenpaxos_tpu_torch.statemachine.base import (
    ConflictIndex,
    StateMachine,
    TypedStateMachine,
)
from frankenpaxos_tpu_torch.utils.topk import TopK, TopOne, VertexIdLike


class AppendLog(StateMachine):
    """Append the command; output its log index. All commands conflict."""

    def __init__(self):
        self.xs: list[bytes] = []

    def __repr__(self):
        return f"AppendLog({self.xs!r})"

    def get(self) -> list[bytes]:
        return list(self.xs)

    def run(self, input: bytes) -> bytes:
        self.xs.append(input)
        return str(len(self.xs) - 1).encode()

    def conflicts(self, first_command: bytes, second_command: bytes) -> bool:
        return True

    def to_bytes(self) -> bytes:
        return pickle.dumps(self.xs)

    def from_bytes(self, snapshot: bytes) -> None:
        self.xs = pickle.loads(snapshot)

    def conflict_index(self) -> ConflictIndex:
        return _AllConflictIndex()

    def top_k_conflict_index(self, k, num_leaders, like) -> ConflictIndex:
        return _AllTopKConflictIndex(k, num_leaders, like)


class _AllConflictIndex(ConflictIndex):
    """Everything conflicts: the index is just the key set
    (AppendLog.scala:34-51)."""

    def __init__(self):
        self.keys: set = set()

    def put(self, key, command) -> None:
        self.keys.add(key)

    def put_snapshot(self, key) -> None:
        self.keys.add(key)

    def remove(self, key) -> None:
        self.keys.discard(key)

    def get_conflicts(self, command) -> set:
        return set(self.keys)


class _AllTopKConflictIndex(ConflictIndex):
    """Everything conflicts: maintain the TopOne/TopK directly
    (AppendLog.scala:53+); O(1) per op, no key set."""

    def __init__(self, k: int, num_leaders: int, like: VertexIdLike):
        self.k = k
        self._top = (TopOne(num_leaders, like) if k == 1
                     else TopK(k, num_leaders, like))

    def put(self, key, command) -> None:
        self._top.put(key)

    def put_snapshot(self, key) -> None:
        self._top.put(key)

    def get_top_one_conflicts(self, command) -> TopOne:
        assert self.k == 1
        return self._top

    def get_top_k_conflicts(self, command) -> TopK:
        assert self.k != 1
        return self._top


class Noop(StateMachine):
    """Ignores every command; nothing conflicts (Noop.scala:10+)."""

    def run(self, input: bytes) -> bytes:
        return b""

    def conflicts(self, first_command: bytes, second_command: bytes) -> bool:
        return False

    def to_bytes(self) -> bytes:
        return b""

    def from_bytes(self, snapshot: bytes) -> None:
        pass


class Register(StateMachine):
    """A single register; every write conflicts (Register.scala:10+)."""

    def __init__(self):
        self.x: bytes = b""

    def __repr__(self):
        return f"Register({self.x!r})"

    def get(self) -> bytes:
        return self.x

    def run(self, input: bytes) -> bytes:
        self.x = input
        return input

    def conflicts(self, first_command: bytes, second_command: bytes) -> bool:
        return True

    def to_bytes(self) -> bytes:
        return self.x

    def from_bytes(self, snapshot: bytes) -> None:
        self.x = snapshot


# --- KeyValueStore ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GetRequest:
    keys: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class SetRequest:
    key_values: tuple[tuple[str, str], ...]


KeyValueStoreInput = Union[GetRequest, SetRequest]


@dataclasses.dataclass(frozen=True)
class GetReply:
    key_values: tuple[tuple[str, Optional[str]], ...]


@dataclasses.dataclass(frozen=True)
class SetReply:
    pass


def _keys_of(input: KeyValueStoreInput) -> set[str]:
    if isinstance(input, GetRequest):
        return set(input.keys)
    return {k for k, _ in input.key_values}


class KeyValueStore(TypedStateMachine[KeyValueStoreInput, object]):
    """Batched get/set KV store (KeyValueStore.scala:38+). Gets don't
    conflict with gets; anything involving a set conflicts iff key sets
    intersect."""

    def __init__(self):
        self.kvs: dict[str, str] = {}

    def __repr__(self):
        return f"KeyValueStore({self.kvs!r})"

    def get(self) -> dict[str, str]:
        return dict(self.kvs)

    def typed_run(self, input: KeyValueStoreInput):
        if isinstance(input, GetRequest):
            return GetReply(tuple((k, self.kvs.get(k)) for k in input.keys))
        for k, v in input.key_values:
            self.kvs[k] = v
        return SetReply()

    def typed_conflicts(self, first_command: KeyValueStoreInput,
                        second_command: KeyValueStoreInput) -> bool:
        if isinstance(first_command, GetRequest) and isinstance(
                second_command, GetRequest):
            return False
        return bool(_keys_of(first_command) & _keys_of(second_command))

    def to_bytes(self) -> bytes:
        return pickle.dumps(self.kvs)

    def from_bytes(self, snapshot: bytes) -> None:
        self.kvs = pickle.loads(snapshot)

    def conflict_index(self) -> ConflictIndex:
        return _KvConflictIndex(self.input_serializer)

    def typed_conflict_index(self) -> ConflictIndex:
        return _KvConflictIndex(None)


class _KvConflictIndex(ConflictIndex):
    """Inverted indexes: per key, who gets it and who sets it
    (KeyValueStore.scala typedConflictIndex)."""

    def __init__(self, serializer):
        self._serializer = serializer
        self.gets: dict[str, set] = {}
        self.sets: dict[str, set] = {}
        self.commands: dict = {}
        self.snapshots: set = set()

    def _decode(self, command):
        if self._serializer is None:
            return command
        return self._serializer.from_bytes(command)

    def put(self, key, command) -> None:
        self.remove(key)
        input = self._decode(command)
        self.commands[key] = input
        index = self.gets if isinstance(input, GetRequest) else self.sets
        for k in _keys_of(input):
            index.setdefault(k, set()).add(key)

    def put_snapshot(self, key) -> None:
        self.remove(key)
        self.snapshots.add(key)

    def remove(self, key) -> None:
        input = self.commands.pop(key, None)
        self.snapshots.discard(key)
        if input is None:
            return
        index = self.gets if isinstance(input, GetRequest) else self.sets
        for k in _keys_of(input):
            index.get(k, set()).discard(key)

    def get_conflicts(self, command) -> set:
        input = self._decode(command)
        conflicts = set(self.snapshots)
        if isinstance(input, GetRequest):
            for k in input.keys:
                conflicts |= self.sets.get(k, set())
        else:
            for k, _ in input.key_values:
                conflicts |= self.sets.get(k, set())
                conflicts |= self.gets.get(k, set())
        return conflicts


class ReadableAppendLog(AppendLog):
    """AppendLog whose inputs distinguish reads from appends
    (ReadableAppendLog.scala): a command starting with ``b"r:"`` reads the
    whole log without mutating it (used by read-scaling benchmarks)."""

    def run(self, input: bytes) -> bytes:
        if input.startswith(b"r:"):
            return pickle.dumps(self.xs)
        return super().run(input)

    def conflicts(self, first_command: bytes, second_command: bytes) -> bool:
        # Two reads commute; anything involving an append conflicts.
        return not (first_command.startswith(b"r:")
                    and second_command.startswith(b"r:"))
