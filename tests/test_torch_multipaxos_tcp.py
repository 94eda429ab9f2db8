"""MultiPaxos deployed over the port's TcpTransport on loopback
(``protocols/multipaxos/supernode.py``), on the CPU: f = 1 in
``deploy.py``'s ``cluster(1, ...)`` layout, four closed-loop clients, a
few hundred writes an arm. The arms are the ProxyLeaders' ``"dict"``
tracker and the ``"cuda"`` tracker on ``device="cpu"`` (the plain
versions) in its synchronous and pipelined modes; the pipelined arm
collects on the ProxyLeaders' collector threads. In every arm each
write is answered exactly once with its AppendLog index, the replicas'
executed logs are equal and hold every write once, nothing logged an
error, and each cuda arm executed the same set of commands as the dict
arm."""

import sys
import threading
import time

from frankenpaxos_tpu_torch.protocols.multipaxos import supernode
from frankenpaxos_tpu_torch.protocols.multipaxos.proxy_leader import (
    ProxyLeader,
    ProxyLeaderOptions,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel
from frankenpaxos_tpu_torch.runtime.tcp_transport import TcpTransport
import pytest
import torch

WRITES = 384
PSEUDONYMS = 16
ARMS = {
    "dict": dict(quorum_backend="dict"),
    "cuda-sync": dict(quorum_backend="cuda", device="cpu",
                      phase1_backend="cuda"),
    "cuda-pipelined": dict(quorum_backend="cuda", tpu_pipelined=True,
                           device="cpu", phase1_backend="cuda"),
}


@pytest.fixture(scope="module")
def dict_arm():
    return supernode.run_arm(WRITES, PSEUDONYMS, timeout_s=60,
                             **ARMS["dict"])


def test_dict_arm_answers_every_write(dict_arm):
    assert dict_arm["writes"] == WRITES
    assert len(dict_arm["executed"]) == WRITES
    assert dict_arm["in_flight"] == 4 * PSEUDONYMS
    assert dict_arm["writes_per_sec"] > 0
    assert 0 < dict_arm["latency_p50_ms"] <= dict_arm["latency_p99_ms"]


@pytest.mark.parametrize("arm", ["cuda-sync", "cuda-pipelined"])
def test_cuda_arm_executes_the_dict_arms_commands(dict_arm, arm):
    result = supernode.run_arm(WRITES, PSEUDONYMS, timeout_s=60,
                               **ARMS[arm])
    assert result["executed"] == dict_arm["executed"]
    votes = sum(sum(shapes.values()) for shapes in result["votes_by_shape"])
    assert votes >= 2 * WRITES  # a write quorum of f + 1 = 2 acks a slot


def test_pipelined_arm_under_frequent_thread_switches():
    """The collector thread and the event loop share each tracker: with
    the interpreter switching threads every 10 µs, every write is still
    answered once and the logs agree (``run_arm``'s checks)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        result = supernode.run_arm(512, 32, timeout_s=90,
                                   **ARMS["cuda-pipelined"])
    finally:
        sys.setswitchinterval(interval)
    assert len(result["executed"]) == 512


def test_the_collector_thread_replaces_the_old_refusal():
    """A pipelined cuda ProxyLeader on a threaded transport is built
    (the port refused it before) with one daemon collector thread, and
    :meth:`ProxyLeader.close` stops it."""
    config = supernode.cluster_config(1)
    t = TcpTransport(logger=FakeLogger())
    t.start()
    try:
        before = threading.active_count()
        pl = ProxyLeader(config.proxy_leader_addresses[0], t, FakeLogger(),
                         config, ProxyLeaderOptions(
                             quorum_backend="cuda", tpu_pipelined=True,
                             tpu_window=1 << 12), device="cpu")
        assert pl._flush_timer is None
        assert pl._collector_thread.is_alive()
        assert threading.active_count() == before + 1
        pl.close()
        assert not pl._collector_thread.is_alive()
    finally:
        t.stop()


def test_a_collector_error_is_logged_and_kept():
    """A dispatch whose collect fails is not swallowed: the error is
    logged and kept on the ProxyLeader, which the deployment's checks
    read."""
    config = supernode.cluster_config(1)
    t = TcpTransport(logger=FakeLogger())
    t.start()
    logger = FakeLogger(LogLevel.WARN)
    try:
        pl = ProxyLeader(config.proxy_leader_addresses[0], t, logger,
                         config, ProxyLeaderOptions(
                             quorum_backend="cuda", tpu_pipelined=True,
                             tpu_window=1 << 12), device="cpu")

        def broken(dispatch):
            raise RuntimeError("device lost")

        pl.tracker.collect = broken
        pl._collector.put("a dispatch")
        pl.close()
        assert pl.collector_errors == ["RuntimeError('device lost')"]
        assert any("cuda collect failed" in m and level == LogLevel.ERROR
                   for level, m in logger.records)
    finally:
        t.stop()


def _pipelined_proxy_leader(t, logger):
    config = supernode.cluster_config(1)
    return ProxyLeader(config.proxy_leader_addresses[0], t, logger, config,
                       ProxyLeaderOptions(quorum_backend="cuda",
                                          tpu_pipelined=True,
                                          tpu_window=1 << 12),
                       device="cpu")


def _set_device_as_torch_does(calls):
    """A stand-in for ``torch.cuda.set_device`` that refuses a card with
    no index, as torch's ``_get_device_index(optional=False)`` does."""
    def set_device(device):
        if device.index is None:
            raise ValueError(f"Expected a torch.device with a specified "
                             f"index or an integer, but got:{device}")
        calls.append(device)
    return set_device


def test_the_collector_selects_a_card_named_without_an_index(monkeypatch):
    """A tracker on ``"cuda"`` (what ``device=None`` resolves to) has no
    card index: the collector thread is given the building thread's
    current card, so its ``set_device`` succeeds and it collects."""
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        _set_device_as_torch_does(calls))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    t = TcpTransport(logger=FakeLogger())
    t.start()
    try:
        pl = _pipelined_proxy_leader(t, FakeLogger())
        pl.close()
        monkeypatch.setattr(pl.tracker.checker, "device",
                            torch.device("cuda"))
        device = pl._collect_device()
        assert device == torch.device("cuda", 0)
        collected = []
        pl.tracker.collect = lambda dispatch: collected.append(dispatch)
        pl._collector.put("a dispatch")
        pl._collector.put(None)
        thread = threading.Thread(target=pl._collect_loop, args=(device,),
                                  daemon=True)
        thread.start()
        thread.join(timeout=10)
        assert not thread.is_alive()
        assert calls == [torch.device("cuda", 0)]
        assert collected == ["a dispatch"]
        assert pl.collector_errors == []
    finally:
        t.stop()


def test_a_failed_card_selection_is_kept_and_collection_goes_on(
        monkeypatch):
    """If the collector thread cannot select its card, the error is kept
    in ``collector_errors`` (the thread does not die silently) and the
    queued dispatches are still collected."""
    monkeypatch.setattr(torch.cuda, "set_device",
                        _set_device_as_torch_does([]))
    t = TcpTransport(logger=FakeLogger())
    t.start()
    logger = FakeLogger(LogLevel.WARN)
    try:
        pl = _pipelined_proxy_leader(t, logger)
        pl.close()
        collected = []
        pl.tracker.collect = lambda dispatch: collected.append(dispatch)
        pl._collector.put("a dispatch")
        pl._collector.put(None)
        thread = threading.Thread(target=pl._collect_loop,
                                  args=(torch.device("cuda"),), daemon=True)
        thread.start()
        thread.join(timeout=10)
        assert not thread.is_alive()
        assert len(pl.collector_errors) == 1
        assert pl.collector_errors[0].startswith("ValueError(")
        assert collected == ["a dispatch"]
        assert any("cuda collect failed" in m and level == LogLevel.ERROR
                   for level, m in logger.records)
    finally:
        t.stop()


def test_a_collector_error_fails_the_closed_loop_at_once():
    """When the collectors fail, the writes of their dispatches are never
    answered: the closed loop fails on the first collector error instead
    of waiting out its timeout."""
    def broken(dispatch):
        raise RuntimeError("device lost")

    with supernode.Supernode(**ARMS["cuda-pipelined"]) as node:
        for proxy_leader in node.proxy_leaders:
            proxy_leader.tracker.collect = broken
        t0 = time.monotonic()
        with pytest.raises(supernode.GateFailure,
                           match="a collector failed"):
            node.write_closed_loop(64, 8, timeout_s=60)
        assert time.monotonic() - t0 < 30
