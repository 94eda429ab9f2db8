"""The adaptive election and heartbeat deadlines of the port against the
JAX package (``tests/test_geo.py``'s jitter-tolerant failure detection):
the same seeded runs over the geo simulator in both packages, the
heartbeat's false deaths and the basic election's spurious seizures
counted exactly, the derived deadlines compared, and the rule that a
failover gap is not an RTT sample. The Raft election's adaptive deadline
is held to the reference on the same ping sequences."""

from __future__ import annotations

import types

from frankenpaxos_tpu_torch import (
    election as pelection,
    geo as pgeo,
    heartbeat as pheartbeat,
    runtime as pruntime,
)
from frankenpaxos_tpu_torch.election import basic as pbasic, raft as praft
import pytest

from frankenpaxos_tpu import (
    election as jelection,
    geo as jgeo,
    heartbeat as jheartbeat,
    runtime as jruntime,
)
from frankenpaxos_tpu.election import basic as jbasic, raft as jraft

PORT = types.SimpleNamespace(geo=pgeo, heartbeat=pheartbeat,
                             election=pelection, basic=pbasic, raft=praft,
                             runtime=pruntime)
JAX = types.SimpleNamespace(geo=jgeo, heartbeat=jheartbeat,
                            election=jelection, basic=jbasic, raft=jraft,
                            runtime=jruntime)
PACKAGES = {"port": PORT, "jax": JAX}


def _watched(pkg):
    class Watched(pkg.heartbeat.HeartbeatParticipant):
        """Records false-death verdicts (peer removed from ``alive``)."""

        def __init__(self, *args, **kwargs):
            self.deaths: list = []
            super().__init__(*args, **kwargs)

        def _fail(self, index):
            before = self.addresses[index] in self.alive
            super()._fail(index)
            if before and self.addresses[index] not in self.alive:
                self.deaths.append((index, self.clock()))

    return Watched


def run_heartbeat(pkg, adaptive: bool, kill_peer: bool = False,
                  seed: int = 5):
    """Two participants across a HIGH-JITTER WAN link, fail deadline
    configured below the link's worst-case RTT."""
    topo = pkg.geo.GeoTopology({"us": ["us-a"], "eu": ["eu-a"]},
                               cross_region_s=0.04, jitter=4.0, seed=seed)
    logger = pkg.runtime.FakeLogger(pkg.runtime.LogLevel.FATAL)
    transport = pkg.geo.GeoSimTransport(topo, logger)
    clock = lambda: int(transport.now * 1e9)  # noqa: E731
    options = pkg.heartbeat.HeartbeatOptions(
        fail_period_s=0.1, success_period_s=0.05, num_retries=2,
        adaptive=adaptive)
    addresses = ["hb-us", "hb-eu"]
    topo.place("hb-us", "us-a"), topo.place("hb-eu", "eu-a")
    watched = _watched(pkg)
    participants = [
        watched(a, transport, transport.logger,
                [b for b in addresses if b != a], options=options,
                clock=clock)
        for a in addresses]
    transport.run_for(10.0)
    if kill_peer:
        transport.crash("hb-eu")
        transport.run_for(10.0)
    return participants


def run_election(pkg, adaptive: bool, seed: int = 11):
    topo = pkg.geo.GeoTopology({"us": ["us-a"], "eu": ["eu-a"]},
                               cross_region_s=0.04, jitter=4.0, seed=seed)
    logger = pkg.runtime.FakeLogger(pkg.runtime.LogLevel.FATAL)
    transport = pkg.geo.GeoSimTransport(topo, logger)
    options = pkg.basic.ElectionOptions(ping_period_s=0.1,
                                        no_ping_timeout_min_s=0.15,
                                        no_ping_timeout_max_s=0.2,
                                        adaptive=adaptive)
    addresses = ["el-us", "el-eu"]
    topo.place("el-us", "us-a"), topo.place("el-eu", "eu-a")
    participants = [
        pkg.basic.ElectionParticipant(
            a, transport, transport.logger, addresses,
            initial_leader_index=0, options=options, seed=i,
            clock=lambda: transport.now)
        for i, a in enumerate(addresses)]
    seizures: list = []
    participants[1].register(
        lambda leader_index: seizures.append(leader_index))
    transport.run_for(20.0)
    return participants, seizures


# --- (a) tests/test_geo.py's cases on the port ---------------------------------


class TestJitterTolerantHeartbeat:
    def test_fixed_deadline_false_positives_under_jitter(self):
        us, eu = run_heartbeat(PORT, adaptive=False)
        assert us.deaths, \
            "expected the fixed deadline to false-positive under " \
            "4x-jitter WAN RTT"

    def test_adaptive_deadline_rides_out_jitter(self):
        us, eu = run_heartbeat(PORT, adaptive=True)
        assert us.deaths == [] and eu.deaths == []
        assert us.unsafe_alive() == {"hb-eu"}
        # The derived deadline grew past the configured constant.
        assert us.fail_timers[0].delay_s > 0.1

    def test_adaptive_still_detects_real_death(self):
        us, _ = run_heartbeat(PORT, adaptive=True, kill_peer=True)
        assert us.unsafe_alive() == set()


class TestJitterTolerantElection:
    def test_fixed_timeout_seizes_leadership_under_jitter(self):
        _, seizures = run_election(PORT, adaptive=False)
        assert seizures, \
            "expected a spurious leadership seizure: ping-gap jitter " \
            "exceeds the fixed no-ping window"

    def test_adaptive_timeout_holds_steady(self):
        participants, seizures = run_election(PORT, adaptive=True)
        assert seizures == []
        assert participants[1].leader_index == 0
        # The derived deadline grew past the fixed window.
        assert participants[1].no_ping_timer.delay_s > 0.2


def failover_gap(pkg) -> tuple:
    """Steady pings from leader 0, 300 s of silence, then a NEW leader's
    pings: the no-ping deadline before and after."""
    transport = pkg.runtime.SimTransport(
        pkg.runtime.FakeLogger(pkg.runtime.LogLevel.FATAL))
    t = [0.0]
    follower = pkg.basic.ElectionParticipant(
        "el-1", transport, transport.logger, ["el-0", "el-1", "el-2"],
        initial_leader_index=0,
        options=pkg.basic.ElectionOptions(ping_period_s=0.1, adaptive=True),
        seed=1, clock=lambda: t[0])
    for _ in range(10):
        t[0] += 0.1
        follower.receive("el-0", pkg.basic.ElectionPing(round=0,
                                                        leader_index=0))
    steady = follower.no_ping_timer.delay_s
    t[0] += 300.0
    follower.receive("el-2", pkg.basic.ElectionPing(round=1, leader_index=2))
    t[0] += 0.1
    follower.receive("el-2", pkg.basic.ElectionPing(round=1, leader_index=2))
    return steady, follower.no_ping_timer.delay_s


def test_adaptive_election_ignores_failover_gap():
    """A NEW leader's first ping (or a ping after a non-follower period)
    must not feed the outage-sized silence into the gap estimator."""
    steady, after = failover_gap(PORT)
    assert steady < 5.0
    assert after < 5.0, "failover gap poisoned the adaptive deadline"


# --- (b) the same seeded runs in both packages --------------------------------


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_heartbeat_runs_match_the_reference(adaptive, seed):
    runs = {name: run_heartbeat(pkg, adaptive, seed=seed)
            for name, pkg in PACKAGES.items()}
    for name in ("port", "jax"):
        runs[name] = [(p.deaths, sorted(p.unsafe_alive()),
                       [t.delay_s for t in p.fail_timers])
                      for p in runs[name]]
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("seed", [5, 9])
def test_heartbeat_death_detection_matches_the_reference(seed):
    runs = {name: [(p.deaths, sorted(p.unsafe_alive()))
                   for p in run_heartbeat(pkg, True, kill_peer=True,
                                          seed=seed)]
            for name, pkg in PACKAGES.items()}
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][1] == []


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_election_runs_match_the_reference(adaptive, seed):
    runs = {}
    for name, pkg in PACKAGES.items():
        participants, seizures = run_election(pkg, adaptive, seed=seed)
        runs[name] = (seizures, [p.leader_index for p in participants],
                      [p.no_ping_timer.delay_s for p in participants])
    assert runs["port"] == runs["jax"]


def test_failover_gap_matches_the_reference():
    assert failover_gap(PORT) == failover_gap(JAX)


def raft_gaps(pkg, gaps, outage_at=None) -> list:
    """A Raft follower of leader r-0 fed pings ``gaps`` seconds apart
    (after ``outage_at`` pings, a 300 s silence and then a new leader
    r-2's pings in round 1): its no-ping deadline after every ping."""
    transport = pkg.runtime.SimTransport(
        pkg.runtime.FakeLogger(pkg.runtime.LogLevel.FATAL))
    t = [0.0]
    follower = pkg.raft.RaftElectionParticipant(
        "r-1", transport, transport.logger, ["r-0", "r-1", "r-2"],
        leader="r-0", options=pkg.raft.RaftElectionOptions(adaptive=True),
        seed=3, clock=lambda: t[0])
    delays = []
    leader, rnd = "r-0", 0
    for i, gap in enumerate(gaps):
        if i == outage_at:
            t[0] += 300.0
            leader, rnd = "r-2", 1
        t[0] += gap
        follower.receive(leader, pkg.raft.RaftPing(round=rnd))
        delays.append((follower.state, follower._timer.delay_s))
    return delays


@pytest.mark.parametrize("outage_at", [None, 6])
def test_raft_adaptive_deadline_matches_the_reference(outage_at):
    gaps = [0.1, 0.12, 0.3, 0.09, 0.5, 0.11, 0.1, 0.2, 0.1, 0.13]
    port = raft_gaps(PORT, gaps, outage_at)
    assert port == raft_gaps(JAX, gaps, outage_at)
    # The derived deadline follows the gaps; an outage is not a sample.
    assert all(state == "follower" for state, _ in port)
    assert max(delay for _, delay in port[1:]) < 5.0
