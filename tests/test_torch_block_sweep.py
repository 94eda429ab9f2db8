"""The block-size frontier twin (``bench/block_sweep.py``) on the CPU at
a tiny size: every block size measured, each timed run checked against
the warm run's committed count, and the frontier picked under the
latency target as the reference picks it."""

import json

from frankenpaxos_tpu_torch.bench import block_sweep
import pytest
import torch

from frankenpaxos_tpu.bench import block_sweep as jsweep


def test_block_sweep_runs_small_on_cpu(monkeypatch):
    for name, value in (("WINDOW", 256), ("BLOCKS", (32, 64)),
                        ("WORK", 4096), ("MIN_ITERS", 16)):
        monkeypatch.setattr(block_sweep, name, value)
    result = block_sweep.run("cpu", repeats=2, latency_budget_s=0.1,
                             target_samples=24)
    assert result["suite"] == "block_sweep"
    assert [r["block_slots"] for r in result["rows"]] == [32, 64]
    for row in result["rows"]:
        assert len(row["runs"]) == 2
        # max(MIN_ITERS, WORK // block) drains, each committing a block.
        assert row["iters"] == 4096 // row["block_slots"]
        assert abs(row["committed"] - row["iters"] * row["block_slots"]) \
            <= 2 * row["block_slots"]
        assert row["cmds_per_sec"] == min(r["cmds_per_sec"]
                                          for r in row["runs"])
        assert row["latency_samples"] >= 24
    eligible = [r for r in result["rows"]
                if r["drain_latency_us"] < block_sweep.TARGET_US]
    best = max(eligible or result["rows"], key=lambda r: r["cmds_per_sec"])
    assert result["chosen_block"] == best["block_slots"]
    assert result["target_met"] == bool(eligible)
    assert result["device"] == "cpu" and result["nvidia_smi"] is None
    json.dumps(result)


def test_block_sweep_keeps_the_reference_grid():
    assert block_sweep.BLOCKS == tuple(jsweep.BLOCKS)
    assert (block_sweep.WORK, block_sweep.MIN_ITERS) == (1 << 30, 2048)
    assert block_sweep.WINDOW == jsweep.WINDOW
    assert block_sweep.TARGET_US == jsweep.TARGET_US
    assert block_sweep.NUM_ACCEPTORS == jsweep.NUM_ACCEPTORS


def test_block_sweep_refuses_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        block_sweep.run()
