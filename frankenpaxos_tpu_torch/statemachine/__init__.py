"""Deterministic replicated state machines + conflict detection.

Reference behavior: statemachine/ (StateMachine.scala:11-46,
TypedStateMachine.scala:70+, ConflictIndex.scala:43-66, AppendLog.scala:10+,
KeyValueStore.scala:38+, Noop.scala:10+, Register.scala:10+).
"""

from frankenpaxos_tpu_torch.statemachine.base import (
    ConflictIndex,
    NaiveConflictIndex,
    state_machine_by_name,
    StateMachine,
    TypedStateMachine,
)
from frankenpaxos_tpu_torch.statemachine.impls import (
    AppendLog,
    GetReply,
    GetRequest,
    KeyValueStore,
    Noop,
    ReadableAppendLog,
    Register,
    SetReply,
    SetRequest,
)

__all__ = [
    "AppendLog",
    "ConflictIndex",
    "GetReply",
    "GetRequest",
    "KeyValueStore",
    "NaiveConflictIndex",
    "Noop",
    "ReadableAppendLog",
    "Register",
    "SetReply",
    "SetRequest",
    "StateMachine",
    "TypedStateMachine",
    "state_machine_by_name",
]
