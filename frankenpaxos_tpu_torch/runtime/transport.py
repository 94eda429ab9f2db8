"""Transport contracts of the port (the counterpart of
``frankenpaxos_tpu/runtime/transport.py``).

Only ``Address`` is ported so far; ``MultiPaxosConfig`` needs it. The
``Transport`` and ``Timer`` contracts and the actor runtime come with
the port of the host runtime.
"""

from __future__ import annotations

from typing import Hashable

# Addresses are opaque hashable values; each transport documents its
# concrete address type (host:port tuples for TCP, strings for sim).
Address = Hashable
