"""transport_lt: paired A/B of the paxwire batched TcpTransport against
the per-frame baseline (the port's twin of
``frankenpaxos_tpu/bench/transport_lt.py``).

    python -m frankenpaxos_tpu_torch.bench.transport_lt [--smoke] \\
        [--out FILE]

Per in-flight width, the SAME closed-loop request/reply workload runs
over two real-TCP transport pairs in one process:

  * ``per_frame``: ``TcpTransport(batching=False)``, one encoded frame
    and one flush per ``send`` (the deployed transport before paxwire);
  * ``batched``: the default paxwire path: per-event-loop-pass flushes,
    batch frames over adjacent same-type payloads, one scatter/gather
    writev per peer per pass.

The workload is the deployed wire's own message shapes (MultiPaxos
``ClientRequest`` -> ``ClientReply`` through the registered fixed-layout
codecs), ``width`` pipelined commands, closed loop: every reply issues
the next request. Both arms pay the same codec, delivery and handler
costs; only the frame, flush and syscall layer differs. Recorded per
arm: end-to-end cmds/s on the host clock, syscalls/cmd (the transports'
own counters: one per writev or write call; asyncio issues one ``send``
per uncongested write), wire frames/cmd, and bytes/drain (batched bytes
per flush). Each pair is best-of-``reps`` on fresh transports, the arm
order alternated. A third arm, ``ingest``, rides along as the reference's
does: the batched transport with a server whose wire sinks take each
client batch frame whole as columns (``ingest/columns.py``) and answer
it with ONE ``ClientReplyArray`` (no per-message decode); its replies
carry no results, so only their ids are checked.

A run fails (raises) when any reply is lost (a closed loop that does not
finish within its deadline), when a reply answers no outstanding
request or answers one twice, or when a transport logged an error (a
frame that did not decode drops its connection with an error). It
prints the reference's two gates, which are measurements, not checks:
batched >= 2x per_frame throughput at every width >= 256, and
syscalls/cmd at least 10x lower at 1024 in flight. It prints ONE JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import threading
import time

from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    ClientReply,
    ClientReplyArray,
    ClientRequest,
    Command,
    CommandId,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger
from frankenpaxos_tpu_torch.runtime.actor import Actor
from frankenpaxos_tpu_torch.runtime.logger import LogLevel
from frankenpaxos_tpu_torch.runtime.tcp_transport import TcpTransport

WIDTHS = (16, 64, 256, 1024, 4096)
SMOKE_WIDTHS = (16, 256, 1024)
ARMS = ("per_frame", "batched", "ingest")
#: A closed loop that has not finished by then lost a reply.
DEADLINE_S = 120.0


class GateFailure(RuntimeError):
    pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _EchoServer(Actor):
    """Replies per request: the reply stream is what the batched
    transport coalesces into batch frames."""

    def receive(self, src, message):
        self.send(src, ClientReply(
            command_id=message.command.command_id, slot=0,
            result=message.command.command))


class _ColumnEchoServer(Actor):
    """The ingest arm's server: whole client batch frames land as SoA
    columns through the wire sink (ingest/columns.py) and each frame
    draws ONE ClientReplyArray -- no per-message decode, no Command
    objects."""

    def __init__(self, address, transport, logger):
        super().__init__(address, transport, logger)
        from frankenpaxos_tpu_torch.ingest.columns import (
            parse_client_array,
            parse_client_batch,
        )

        self.wire_sinks = {
            151: (parse_client_batch, self._handle_columns),
            115: (parse_client_array, self._handle_columns),
            4: (parse_client_array, self._handle_columns),
        }

    def _handle_columns(self, src, colrun) -> None:
        cols = colrun.cols
        self.send(src, ClientReplyArray(entries=tuple(
            (int(p), int(c), 0, b"")
            for p, c in zip(cols[:, 1], cols[:, 2]))))

    def receive(self, src, message):
        # Fallback for shapes the sink declines.
        _EchoServer.receive(self, src, message)


class _LoadClient(Actor):
    """Closed loop: ``width`` pipelined commands; each reply issues the
    next request until ``total`` have been acknowledged. A reply must
    answer an outstanding request, with that request's payload."""

    def __init__(self, address, transport, logger, server, width,
                 total):
        super().__init__(address, transport, logger)
        self.server = server
        self.width = width
        self.total = total
        self.sent = 0
        self.acked = 0
        self.outstanding: set = set()
        self.wrong = 0
        self.t0 = 0.0
        self.t1 = 0.0
        self.done = threading.Event()

    def start(self) -> None:
        def kick():
            self.t0 = time.perf_counter()
            for _ in range(min(self.width, self.total)):
                self._send_next()

        self.transport.loop.call_soon_threadsafe(kick)

    def _send_next(self) -> None:
        i = self.sent
        self.sent += 1
        self.outstanding.add(i)
        self.send(self.server, ClientRequest(Command(
            CommandId(self.address, 0, i), b"w%010d" % i)))

    def receive(self, src, message) -> None:
        if isinstance(message, ClientReplyArray):
            # The ingest arm acks a whole frame in one array, without
            # results.
            ids = [entry[1] for entry in message.entries]
        else:
            ids = [message.command_id.client_id]
            if message.result != b"w%010d" % ids[0]:
                self.wrong += 1
        for i in ids:
            if i not in self.outstanding:
                self.wrong += 1
            self.outstanding.discard(i)
        self.acked += len(ids)
        if self.acked >= self.total:
            self.t1 = time.perf_counter()
            self.done.set()
        else:
            for _ in range(min(len(ids), self.total - self.sent)):
                self._send_next()


def run_arm(arm: str, width: int, total: int) -> dict:
    batching = arm != "per_frame"
    logger = FakeLogger(LogLevel.ERROR)
    server_addr = ("127.0.0.1", _free_port())
    client_addr = ("127.0.0.1", _free_port())
    server_t = TcpTransport(server_addr, logger, batching=batching)
    client_t = TcpTransport(client_addr, logger, batching=batching)
    server_t.start()
    try:
        client_t.start()
        (_ColumnEchoServer if arm == "ingest" else _EchoServer)(
            server_addr, server_t, logger)
        client = _LoadClient(client_addr, client_t, logger,
                             server_addr, width, total)
        client.start()
        finished = client.done.wait(timeout=DEADLINE_S)
    finally:
        server_t.stop()
        client_t.stop()
    if not finished:
        raise GateFailure(f"{arm} at {width} in flight: {client.acked} of "
                          f"{total} replies arrived (a reply was lost)")
    if client.wrong:
        raise GateFailure(f"{arm} at {width} in flight: {client.wrong} "
                          f"replies answered no outstanding request")
    errors = [m for _, m in logger.records]
    if errors:
        raise GateFailure(f"{arm} at {width} in flight: the transports "
                          f"logged {errors[:3]}")
    elapsed = client.t1 - client.t0
    syscalls = server_t.stat_syscalls + client_t.stat_syscalls
    frames = server_t.stat_frames + client_t.stat_frames
    flushes = server_t.stat_flushes + client_t.stat_flushes
    batch_bytes = server_t.stat_batch_bytes + client_t.stat_batch_bytes
    return {
        "arm": arm,
        "batching": batching,
        "in_flight": width,
        "num_commands": total,
        "elapsed_s": elapsed,
        "cmds_per_s": total / elapsed,
        "syscalls": syscalls,
        "syscalls_per_cmd": syscalls / total,
        "frames": frames,
        "frames_per_cmd": frames / total,
        "flushes": flushes,
        "bytes_per_drain": (batch_bytes / flushes
                            if batching and flushes else None),
        "coalesced_acks": (server_t.stat_coalesced_acks
                           + client_t.stat_coalesced_acks),
    }


def run_pair(width: int, total: int, reps: int) -> dict:
    """Best-of-``reps`` for each arm on fresh transports, the order
    alternated so drift lands on every arm alike."""
    best: dict = {}
    for rep in range(reps):
        arms = ARMS if rep % 2 == 0 else tuple(reversed(ARMS))
        for arm in arms:
            stats = run_arm(arm, width, total)
            if arm not in best \
                    or stats["cmds_per_s"] > best[arm]["cmds_per_s"]:
                best[arm] = stats
    pair = dict(best)
    pair["throughput_ratio"] = (best["batched"]["cmds_per_s"]
                                / best["per_frame"]["cmds_per_s"])
    pair["ingest_ratio"] = (best["ingest"]["cmds_per_s"]
                            / best["per_frame"]["cmds_per_s"])
    pair["syscall_reduction"] = (
        best["per_frame"]["syscalls_per_cmd"]
        / max(best["batched"]["syscalls_per_cmd"], 1e-12))
    return pair


def evaluate_gates(pairs: dict) -> dict:
    """The reference's two gates over the measured pairs."""
    throughput = {str(w): pairs[w]["throughput_ratio"]
                  for w in pairs if w >= 256}
    syscalls_at_1024 = (pairs[1024]["syscall_reduction"]
                        if 1024 in pairs else None)
    throughput_passed = all(r >= 2.0 for r in throughput.values())
    syscalls_passed = (syscalls_at_1024 is not None
                       and syscalls_at_1024 >= 10.0)
    return {
        "throughput_ratio_at_ge_256": throughput,
        "throughput_2x_passed": throughput_passed,
        "syscall_reduction_at_1024": syscalls_at_1024,
        "syscalls_10x_passed": syscalls_passed,
        "gate_passed": throughput_passed and syscalls_passed,
    }


def commands_for(width: int, smoke: bool) -> int:
    return min(max(width * 30, 2000), 8000 if smoke else 40000)


def run(widths=WIDTHS, reps: int = 3, smoke: bool = False) -> dict:
    """Every width's pair and the reference's gates; raises
    ``GateFailure`` on a lost or wrong reply or a logged error."""
    pairs = {w: run_pair(w, commands_for(w, smoke), reps) for w in widths}
    smi = None
    try:
        import torch

        if torch.cuda.is_available():
            from frankenpaxos_tpu_torch.device import nvidia_smi_line

            smi = nvidia_smi_line()
    except ImportError:
        pass
    return {
        "benchmark": "transport_lt",
        "methodology": (
            "paired real-TCP closed-loop A/B in one process: per width, "
            "the same ClientRequest->ClientReply workload over "
            "TcpTransport(batching=False) vs the paxwire batched "
            "default, and the ingest arm (the batched transport, the "
            "server's wire sinks taking each client batch frame as "
            "columns, one ClientReplyArray a frame); best-of-reps per arm on fresh transports, arm "
            "order alternated; syscalls = the transports' writev/write "
            "counters; bytes_per_drain = batched bytes per flush pass"),
        "host_nvidia_smi": smi,
        "smoke": smoke,
        "reps": reps,
        "pairs": {str(w): pairs[w] for w in sorted(pairs)},
        "gates": evaluate_gates(pairs),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="write the JSON result here too")
    parser.add_argument("--smoke", action="store_true",
                        help="widths 16, 256, 1024 and fewer commands")
    parser.add_argument("--reps", type=int, default=None)
    args = parser.parse_args(argv)
    widths = SMOKE_WIDTHS if args.smoke else WIDTHS
    reps = args.reps if args.reps is not None else (1 if args.smoke
                                                    else 3)
    result = run(widths, reps, args.smoke)
    line = json.dumps(result, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
