"""The port's host runtime: actors, the simulated transport, timers,
loggers, serializers and metrics collectors (the counterpart of
``frankenpaxos_tpu/runtime/``). The TCP transport and paxwire's batch
layer are ``runtime.tcp_transport`` and ``runtime.paxwire``, imported by
name (they pull in the serving lanes and the native codec).

The load-bearing invariant (Transport.scala:37-40): every transport is a
single-threaded event loop -- ``receive`` and timer callbacks run
serially. Protocols are deterministic, lock-free state machines; the
parallelism lives in the batched device kernels they call.
"""

from frankenpaxos_tpu_torch.runtime.actor import Actor, Chan
from frankenpaxos_tpu_torch.runtime.logger import (
    FakeLogger,
    FileLogger,
    Logger,
    LogLevel,
    PrintLogger,
)
from frankenpaxos_tpu_torch.runtime.monitoring import (
    Collectors,
    Counter,
    FakeCollectors,
    FakeHistogram,
    Gauge,
    Histogram,
    PrometheusCollectors,
    Summary,
)
from frankenpaxos_tpu_torch.runtime.serializer import (
    PickleSerializer,
    Serializer,
)
from frankenpaxos_tpu_torch.runtime.sim_transport import (
    SimTimer,
    SimTransport,
)
from frankenpaxos_tpu_torch.runtime.transport import Timer, Transport

__all__ = [
    "Actor",
    "Chan",
    "Collectors",
    "Counter",
    "FakeCollectors",
    "FakeHistogram",
    "FakeLogger",
    "FileLogger",
    "Gauge",
    "Histogram",
    "LogLevel",
    "Logger",
    "PickleSerializer",
    "PrintLogger",
    "PrometheusCollectors",
    "Serializer",
    "SimTimer",
    "SimTransport",
    "Summary",
    "Timer",
    "Transport",
]
