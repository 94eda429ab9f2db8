"""K8 ``safe_values`` of the port vs the JAX package's ``safe_values``.

The port's plain PyTorch version (what a CPU tensor runs) must be
bit-identical to the JAX program on the same ``[S, N]`` matrices, made
with numpy from a seed: ties between equal rounds go to the first
column, a row with no vote returns ``value_ids[row, 0]`` with
``has_vote`` false, the Leader's pow2 padding rows (all ``NO_VOTE``, id
0) behave the same way, N is 3 (majority of 3) or 6 (2x3 grid), and the
outputs are bool and int32. The kernel itself runs only on the card
(``chip_smoke.py`` holds it against this plain version).
"""

from frankenpaxos_tpu_torch.ops import value as tv
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import value as jv


def _matrices(seed: int, s: int, n: int, pad: int = 0):
    """Rounds in [-1, 3] (many ties), ids in [0, 50), ~1/8 all-NO_VOTE
    rows, rows with every acceptor at one round, and ``pad`` Leader-style
    padding rows (NO_VOTE rounds, id 0) at the end."""
    rng = np.random.default_rng(seed)
    rounds = rng.integers(-1, 4, size=(s, n)).astype(np.int32)
    ids = rng.integers(0, 50, size=(s, n)).astype(np.int32)
    rounds[rng.random(s) < 0.125] = tv.NO_VOTE
    same = rng.random(s) < 0.125
    rounds[same] = rng.integers(0, 4, size=(int(same.sum()), 1))
    if pad:
        rounds = np.concatenate(
            [rounds, np.full((pad, n), tv.NO_VOTE, np.int32)])
        ids = np.concatenate([ids, np.zeros((pad, n), np.int32)])
    return rounds, ids


def _both(rounds, ids):
    jh, jc = jv.safe_values(rounds, ids)
    th, tc = tv.safe_values(torch.from_numpy(rounds),
                            torch.from_numpy(ids))
    return (np.asarray(jh), np.asarray(jc)), (th, tc)


@pytest.mark.parametrize("n", [3, 6])
@pytest.mark.parametrize("s", [1, 64, 4096])
def test_plain_is_bit_identical_to_jax(s, n):
    rounds, ids = _matrices(s * 10 + n, s, n)
    (jh, jc), (th, tc) = _both(rounds, ids)
    assert th.dtype == torch.bool and tc.dtype == torch.int32
    assert th.shape == (s,) and tc.shape == (s,)
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tc.numpy(), jc)


@pytest.mark.parametrize("n", [3, 6])
def test_ties_go_to_the_first_column(n):
    rounds = np.full((n, n), 2, np.int32)
    for row in range(n):
        rounds[row, :row] = 1   # the first maximum sits at column `row`
    ids = np.arange(n * n, dtype=np.int32).reshape(n, n)
    (jh, jc), (th, tc) = _both(rounds, ids)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tc.numpy(), ids[np.arange(n), np.arange(n)])
    assert th.numpy().all() and jh.all()


@pytest.mark.parametrize("n", [3, 6])
def test_no_vote_rows_return_the_first_id(n):
    rounds = np.full((5, n), tv.NO_VOTE, np.int32)
    ids = np.arange(5 * n, dtype=np.int32).reshape(5, n) + 7
    (jh, jc), (th, tc) = _both(rounds, ids)
    assert not th.numpy().any() and not jh.any()
    np.testing.assert_array_equal(tc.numpy(), ids[:, 0])
    np.testing.assert_array_equal(tc.numpy(), jc)


@pytest.mark.parametrize("n", [3, 6])
def test_leader_padding_rows_match(n):
    """The Leader pads S to a power of two with NO_VOTE rounds and id 0
    (leader.py); the padded matrix agrees row for row."""
    rounds, ids = _matrices(99 + n, 1000, n, pad=24)
    (jh, jc), (th, tc) = _both(rounds, ids)
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert not th.numpy()[1000:].any()
    assert not tc.numpy()[1000:].any()


def test_extreme_rounds_match():
    """int32 extremes, rounds below NO_VOTE included (arbitrary inputs
    follow the reference's argmax too)."""
    rng = np.random.default_rng(5)
    rounds = rng.choice(np.array([-2**31, -2, -1, 0, 2**31 - 1], np.int32),
                        size=(512, 3)).astype(np.int32)
    ids = rng.integers(-2**31, 2**31 - 1, size=(512, 3)).astype(np.int32)
    (jh, jc), (th, tc) = _both(rounds, ids)
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tc.numpy(), jc)


def test_cpu_tensors_never_launch():
    launches = tv.safe_values.launches
    rounds, ids = _matrices(1, 64, 3)
    tv.safe_values(torch.from_numpy(rounds), torch.from_numpy(ids))
    assert tv.safe_values.launches == launches


def test_wrapper_checks_its_inputs():
    ok = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tv.safe_values(ok.to(torch.int64), ok)
    with pytest.raises(ValueError, match="int32"):
        tv.safe_values(ok, torch.zeros((4, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="at least one"):
        tv.safe_values(torch.zeros((4, 0), dtype=torch.int32),
                       torch.zeros((4, 0), dtype=torch.int32))
    # Neither CPU nor CUDA: refused, never handed to the plain version.
    meta = torch.zeros((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="never a mix|kernels take"):
        tv.safe_values(meta, meta)


# --- K15 count_matching_replies ---------------------------------------------


def _replies(seed: int, s: int, n: int):
    """Reply ids from a few values (many ties and repeats) with ~1/8 of
    the ids near +-2^31, ~30% of replies invalid, and ~1/8 of the rows
    with no valid reply at all."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, size=(s, n)).astype(np.int32)
    far = rng.random((s, n)) < 0.125
    ids[far] = rng.choice(np.array([-2**31, -2**31 + 1, 2**31 - 2,
                                    2**31 - 1], np.int32),
                          size=int(far.sum()))
    valid = rng.random((s, n)) < 0.7
    valid[rng.random(s) < 0.125] = False
    return ids, valid


def _both_replies(ids, valid):
    jm, jc = jv.count_matching_replies(ids, valid)
    tm, tc = tv.count_matching_replies(torch.from_numpy(ids),
                                       torch.from_numpy(valid))
    assert tm.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    return tm, tc


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 16])
@pytest.mark.parametrize("s", [1, 64, 4096])
def test_count_matching_replies_matches_jax(s, n):
    ids, valid = _replies(s * 100 + n, s, n)
    tm, tc = _both_replies(ids, valid)
    plain = tv.count_matching_replies_plain(torch.from_numpy(ids),
                                            torch.from_numpy(valid))
    assert torch.equal(plain[0], tm) and torch.equal(plain[1], tc)


def test_count_matching_replies_ties_and_empty_rows():
    """Ties go to the first column with the highest count; a row with no
    valid reply gives (ids[s, 0], 0); an invalid reply never counts,
    even when its id matches a valid one."""
    ids = np.array([[7, 8, 7, 8],     # tie 2-2: the first (7) wins
                    [8, 7, 7, 8],     # tie 2-2: 8 wins at column 0
                    [5, 6, 6, 6],     # 6 three times
                    [9, 9, 9, 9],     # no valid reply
                    [4, 3, 3, 4]],    # column 0 invalid: 3 twice wins
                   np.int32)
    valid = np.ones_like(ids, dtype=bool)
    valid[3] = False
    valid[4, 0] = False
    tm, tc = _both_replies(ids, valid)
    assert tm.tolist() == [7, 8, 6, 9, 3]
    assert tc.tolist() == [2, 2, 3, 0, 2]


def test_count_matching_replies_edges():
    # S = 0: empty outputs; N = 0 raises (JAX's argmax of an empty axis).
    tm, tc = _both_replies(np.zeros((0, 3), np.int32),
                           np.zeros((0, 3), bool))
    assert tm.shape == (0,) and tc.shape == (0,)
    with pytest.raises(ValueError):
        jv.count_matching_replies(np.zeros((2, 0), np.int32),
                                  np.zeros((2, 0), bool))
    with pytest.raises(ValueError, match="at least one"):
        tv.count_matching_replies(torch.zeros((2, 0), dtype=torch.int32),
                                  torch.zeros((2, 0), dtype=torch.bool))
    with pytest.raises(ValueError, match="bool"):
        tv.count_matching_replies(torch.zeros((2, 3), dtype=torch.int32),
                                  torch.zeros((2, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="int32"):
        tv.count_matching_replies(torch.zeros((2, 3), dtype=torch.int64),
                                  torch.zeros((2, 3), dtype=torch.bool))
    meta = torch.zeros((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tv.count_matching_replies(meta, meta.bool())
    launches = tv.count_matching_replies.launches
    ids, valid = _replies(3, 64, 5)
    tv.count_matching_replies(torch.from_numpy(ids), torch.from_numpy(valid))
    assert tv.count_matching_replies.launches == launches


class _Recorder:
    """Stands in for the kernel library: records each call's arguments,
    launches nothing, returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 0

        return call


def test_count_matching_replies_kernel_path(monkeypatch):
    """The kernel path, forced on CPU tensors with a stand-in library:
    the arguments match the C signature, one launch counts once, an
    empty batch launches nothing."""
    from frankenpaxos_tpu_torch.ops import _build

    recorder = _Recorder()
    monkeypatch.setattr(tv, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "library", lambda name: recorder)
    monkeypatch.setattr(_build, "stream_args", lambda device: (0, None))
    monkeypatch.setattr(tv.count_matching_replies, "launches", 0)
    ids = torch.zeros((6, 5), dtype=torch.int32)
    tv.count_matching_replies(ids, ids.bool())
    tv.count_matching_replies(ids[:0], ids[:0].bool())
    assert len(recorder.calls) == 1
    entry, args = recorder.calls[0]
    assert entry == "fpx_count_matching_replies"
    assert len(args) == len(_build.SIGNATURES["value"][entry])
    assert args[2:4] == (6, 5)
    assert tv.count_matching_replies.launches == 1
    with pytest.raises(ValueError, match="contiguous"):
        tv.count_matching_replies(ids.t().contiguous().t(), ids.bool())
