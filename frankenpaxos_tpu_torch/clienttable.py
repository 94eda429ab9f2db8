"""ClientTable: exactly-once semantics for out-of-order executors.

Reference behavior: clienttable/ClientTable.scala:135+. Clients annotate
commands with monotonically-increasing ids. Simple protocols (MultiPaxos)
execute each client's commands in id order, but generalized protocols
(EPaxos/BPaxos) may execute them out of order, so per client we keep:

  * the full set of executed ids as an IntPrefixSet (compacts to a
    watermark in the common in-order case), and
  * the output of the *largest* executed id (the only one a live client
    can still be waiting on).
"""

from __future__ import annotations

import dataclasses
from typing import Generic, Hashable, Optional, TypeVar

from frankenpaxos_tpu_torch.compact import IntPrefixSet

A = TypeVar("A", bound=Hashable)
O = TypeVar("O")


class NotExecuted:
    """Sentinel: the command has not been executed; go ahead."""

    def __repr__(self):
        return "NotExecuted"


NOT_EXECUTED = NotExecuted()


@dataclasses.dataclass(frozen=True)
class Executed(Generic[O]):
    """The command already executed. ``output`` is cached only if this is
    the client's largest executed id (ClientTable.scala:62-83)."""

    output: Optional[O]


@dataclasses.dataclass
class _ClientState(Generic[O]):
    largest_id: int
    largest_output: O
    executed_ids: IntPrefixSet


class ClientTable(Generic[A, O]):
    def __init__(self):
        self._table: dict[A, _ClientState[O]] = {}

    def __repr__(self):
        return f"ClientTable({self._table!r})"

    def executed(self, client: A, client_id: int):
        """NOT_EXECUTED | Executed(output or None); see module docstring."""
        state = self._table.get(client)
        if state is None or not state.executed_ids.contains(client_id):
            return NOT_EXECUTED
        if client_id == state.largest_id:
            return Executed(state.largest_output)
        return Executed(None)

    def execute(self, client: A, client_id: int, output: O) -> None:
        """Record an execution. Callers must have checked ``executed``
        first; re-recording an id is a bug (fail-stop, like the
        reference's check)."""
        state = self._table.get(client)
        if state is None:
            state = _ClientState(largest_id=client_id, largest_output=output,
                                 executed_ids=IntPrefixSet())
            self._table[client] = state
        if state.executed_ids.add(client_id):
            raise ValueError(
                f"client {client!r} id {client_id} executed twice")
        if client_id >= state.largest_id:
            state.largest_id = client_id
            state.largest_output = output

    def to_dict(self) -> dict:
        """Wire form (ClientTableProto)."""
        return {
            "kv": [
                {
                    "client": client,
                    "largest_id": s.largest_id,
                    "largest_output": s.largest_output,
                    "executed_ids": s.executed_ids.to_dict(),
                }
                for client, s in self._table.items()
            ]
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ClientTable":
        table = cls()
        for kv in d["kv"]:
            table._table[kv["client"]] = _ClientState(
                largest_id=kv["largest_id"],
                largest_output=kv["largest_output"],
                executed_ids=IntPrefixSet.from_dict(kv["executed_ids"]),
            )
        return table
