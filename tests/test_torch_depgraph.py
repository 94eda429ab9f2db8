"""The port's ``depgraph/`` and ``compact.py`` against the cases of
``tests/test_depgraph.py`` and ``tests/test_compact.py`` (repeated here on
the port's copies), plus cross-package agreement: the same randomized
commit and execute sequence gives the same execution order and blockers
in the JAX package's graphs and the port's."""

import random

from frankenpaxos_tpu_torch.compact import FakeCompactSet, IntPrefixSet
from frankenpaxos_tpu_torch.depgraph import (
    IncrementalTarjanDependencyGraph,
    make_dependency_graph,
    NaiveDependencyGraph,
    TarjanDependencyGraph,
    ZigzagTarjanDependencyGraph,
)
import pytest

from frankenpaxos_tpu import compact as jcompact, depgraph as jdepgraph

# --- the cases of tests/test_depgraph.py -------------------------------------

IMPLS = [TarjanDependencyGraph, NaiveDependencyGraph,
         IncrementalTarjanDependencyGraph]


def valid_execution_order(executed, committed_deps, executed_before=()):
    """Check compatibility: for every executed key, every dependency is
    executed before it unless part of the same component... we check the
    weaker global property: deps appear earlier or belong to a cycle."""
    position = {k: i for i, k in enumerate(executed)}
    known = set(executed) | set(executed_before)
    for key in executed:
        for dep in committed_deps.get(key, ()):
            if dep in known and dep in position and position[dep] > position[key]:
                # dep executed after key: only legal within one SCC;
                # verified separately via component tests.
                return False
    return True


@pytest.mark.parametrize("impl", IMPLS)
class TestBasics:
    def test_empty(self, impl):
        g = impl()
        assert g.execute() == ([], set())

    def test_single_no_deps(self, impl):
        g = impl()
        g.commit("a", 0, set())
        assert g.execute() == (["a"], set())
        # Never returned twice.
        assert g.execute() == ([], set())

    def test_chain(self, impl):
        g = impl()
        g.commit("b", 1, {"a"})
        g.commit("a", 0, set())
        executables, blockers = g.execute()
        assert executables == ["a", "b"]
        assert blockers == set()

    def test_blocked_on_uncommitted(self, impl):
        g = impl()
        g.commit("b", 1, {"a"})
        executables, blockers = g.execute()
        assert executables == []
        assert blockers == {"a"}
        g.commit("a", 0, set())
        assert g.execute() == (["a", "b"], set())

    def test_cycle_is_one_component(self, impl):
        g = impl()
        g.commit("a", 0, {"b"})
        g.commit("b", 1, {"a"})
        components, blockers = g.execute_by_component()
        assert components == [["a", "b"]]  # sorted by (seq, key)
        assert blockers == set()

    def test_cycle_ordered_by_sequence_number(self, impl):
        g = impl()
        g.commit("a", 5, {"b"})
        g.commit("b", 1, {"a"})
        components, _ = g.execute_by_component()
        assert components == [["b", "a"]]

    def test_component_depends_on_uncommitted(self, impl):
        g = impl()
        g.commit("a", 0, {"b"})
        g.commit("b", 1, {"a", "z"})
        executables, blockers = g.execute()
        assert executables == []
        assert blockers == {"z"}

    def test_executed_dep_is_satisfied(self, impl):
        g = impl()
        g.commit("a", 0, set())
        assert g.execute() == (["a"], set())
        g.commit("b", 1, {"a"})  # a already executed
        assert g.execute() == (["b"], set())

    def test_update_executed(self, impl):
        g = impl()
        g.commit("b", 1, {"a"})
        g.update_executed({"a"})
        assert g.execute() == (["b"], set())

    def test_diamond(self, impl):
        g = impl()
        g.commit("d", 3, {"b", "c"})
        g.commit("b", 1, {"a"})
        g.commit("c", 2, {"a"})
        g.commit("a", 0, set())
        executables, _ = g.execute()
        assert set(executables) == {"a", "b", "c", "d"}
        assert executables.index("a") < executables.index("b")
        assert executables.index("a") < executables.index("c")
        assert executables.index("b") < executables.index("d")
        assert executables.index("c") < executables.index("d")

    def test_num_vertices(self, impl):
        g = impl()
        g.commit("a", 0, {"x"})
        assert g.num_vertices == 1
        g.commit("x", 0, set())
        g.execute()
        assert g.num_vertices == 0


def test_deep_chain_no_recursion_limit():
    g = TarjanDependencyGraph()
    n = 50000
    for i in range(n):
        g.commit(i, i, {i - 1} if i > 0 else set())
    executables, blockers = g.execute()
    assert executables == list(range(n))
    assert blockers == set()


def test_randomized_impls_agree():
    """Both implementations execute the same keys with compatible orders
    under random commit/execute interleavings."""
    rng = random.Random(42)
    for trial in range(30):
        tarjan = TarjanDependencyGraph()
        naive = NaiveDependencyGraph()
        n = 40
        keys = list(range(n))
        deps = {k: {rng.randrange(n) for _ in range(rng.randrange(4))} - {k}
                for k in keys}
        rng.shuffle(keys)
        executed_t: list = []
        executed_n: list = []
        for step, key in enumerate(keys):
            tarjan.commit(key, key, deps[key])
            naive.commit(key, key, deps[key])
            if rng.random() < 0.3:
                et, _ = tarjan.execute()
                en, _ = naive.execute()
                assert set(et) == set(en), (trial, step)
                executed_t.extend(et)
                executed_n.extend(en)
        et, bt = tarjan.execute()
        en, bn = naive.execute()
        assert set(et) == set(en)
        assert bt == bn
        executed_t.extend(et)
        executed_n.extend(en)
        assert set(executed_t) == set(executed_n)
        # All committed keys eventually executed (all deps committed).
        assert set(executed_t) == set(range(n))


def test_blockers_limit():
    g = TarjanDependencyGraph()
    for i in range(10):
        g.commit(f"v{i}", i, {f"missing{i}"})
    _, blockers = g.execute(num_blockers=3)
    assert 1 <= len(blockers) <= 4


def test_incremental_resumes_after_pause():
    """A paused walk resumes where it stopped and never redoes work."""
    g = IncrementalTarjanDependencyGraph()
    g.commit("c", 2, {"b"})
    g.commit("b", 1, {"a"})
    executables, blockers = g.execute()
    assert executables == []
    assert blockers == {"a"}
    # Resume: a commits, the paused walk completes the whole chain.
    g.commit("a", 0, set())
    assert g.execute() == (["a", "b", "c"], set())


def test_incremental_at_most_one_blocker_per_call():
    g = IncrementalTarjanDependencyGraph()
    g.commit("x", 0, {"mx"})
    g.commit("y", 1, {"my"})
    _, blockers = g.execute()
    assert len(blockers) == 1


# --- Zigzag (vertex-id keys: (leader_index, id) tuples) -------------------

class TestZigzag:
    def test_single_column_in_order(self):
        g = ZigzagTarjanDependencyGraph(num_leaders=1)
        g.commit((0, 0), 0, set())
        g.commit((0, 1), 1, {(0, 0)})
        # A drained column (no committed ids above the watermark) is not
        # a blocker; only genuine holes are.
        assert g.execute() == ([(0, 0), (0, 1)], set())
        assert g.execute() == ([], set())

    def test_hole_is_a_blocker_even_without_dependents(self):
        """A missing id with committed ids above it in the same column is
        reported as a blocker even if nothing depends on it -- the id
        space is dense by construction, so the hole hides a real
        instance the protocol must recover."""
        g = ZigzagTarjanDependencyGraph(num_leaders=2)
        g.commit((0, 0), 0, set())
        g.commit((0, 2), 2, set())
        executables, blockers = g.execute()
        assert executables == [(0, 0)]
        assert blockers == {(0, 1)}

    def test_zigzag_across_columns(self):
        g = ZigzagTarjanDependencyGraph(num_leaders=2)
        g.commit((0, 0), 0, {(1, 0)})
        g.commit((1, 0), 1, set())
        g.commit((1, 1), 2, {(0, 0)})
        executables, _ = g.execute()
        assert executables.index((1, 0)) < executables.index((0, 0))
        assert executables.index((0, 0)) < executables.index((1, 1))
        assert set(executables) == {(0, 0), (1, 0), (1, 1)}

    def test_cycle_across_columns(self):
        g = ZigzagTarjanDependencyGraph(num_leaders=2)
        g.commit((0, 0), 5, {(1, 0)})
        g.commit((1, 0), 1, {(0, 0)})
        components, blockers = g.execute_by_component()
        assert components == [[(1, 0), (0, 0)]]  # sorted by (seq, key)
        assert blockers == set()

    def test_blocked_column_resumes(self):
        g = ZigzagTarjanDependencyGraph(num_leaders=1)
        g.commit((0, 1), 1, set())
        executables, blockers = g.execute()
        assert executables == []
        assert blockers == {(0, 0)}
        g.commit((0, 0), 0, set())
        assert g.execute() == ([(0, 0), (0, 1)], set())

    def test_update_executed_advances_watermark(self):
        g = ZigzagTarjanDependencyGraph(num_leaders=1)
        g.commit((0, 1), 1, {(0, 0)})
        g.update_executed({(0, 0)})
        assert g.execute() == ([(0, 1)], set())

    def test_garbage_collection_drops_prefix(self):
        g = ZigzagTarjanDependencyGraph(num_leaders=1, grow_size=4,
                                        gc_every_n_commands=8)
        for i in range(32):
            g.commit((0, i), i, {(0, i - 1)} if i else set())
            g.execute()
        assert g.num_vertices == 0
        assert g.vertices[0].watermark > 0

    def test_ineligible_dependency_chain(self):
        g = ZigzagTarjanDependencyGraph(num_leaders=2)
        g.commit((0, 0), 0, {(1, 5)})  # depends deep into column 1
        executables, blockers = g.execute()
        assert executables == []
        assert (1, 5) in blockers

    def test_deep_chain_no_recursion_limit(self):
        g = ZigzagTarjanDependencyGraph(num_leaders=1, grow_size=1000)
        n = 50000
        # Reverse chain: vertex i depends on i+1, so strongConnect from
        # the watermark descends the full depth.
        for i in range(n):
            g.commit((0, i), i, {(0, i + 1)} if i < n - 1 else set())
        executables, blockers = g.execute()
        assert len(executables) == n
        assert blockers == set()


def test_randomized_zigzag_agrees_with_tarjan():
    """Zigzag executes the same vertex sets as the from-scratch Tarjan
    over random dense vertex-id graphs (mirrors
    ZigzagTarjanDependencyGraphTest.scala's cross-impl agreement)."""
    rng = random.Random(7)
    for trial in range(20):
        num_leaders = rng.randrange(1, 4)
        per_leader = 15
        zigzag = ZigzagTarjanDependencyGraph(num_leaders=num_leaders)
        tarjan = TarjanDependencyGraph()
        keys = [(l, i) for l in range(num_leaders) for i in range(per_leader)]
        deps = {k: {rng.choice(keys) for _ in range(rng.randrange(3))} - {k}
                for k in keys}
        rng.shuffle(keys)
        executed_z: set = set()
        executed_t: set = set()
        for key in keys:
            zigzag.commit(key, key[1], deps[key])
            tarjan.commit(key, key[1], deps[key])
            if rng.random() < 0.3:
                executed_z.update(zigzag.execute()[0])
                executed_t.update(tarjan.execute()[0])
        executed_z.update(zigzag.execute()[0])
        executed_t.update(tarjan.execute()[0])
        # All committed; both must drain everything.
        assert executed_z == executed_t == set(deps)


def test_randomized_incremental_agrees_with_tarjan():
    rng = random.Random(13)
    for trial in range(20):
        inc = IncrementalTarjanDependencyGraph()
        tarjan = TarjanDependencyGraph()
        n = 40
        keys = list(range(n))
        deps = {k: {rng.randrange(n) for _ in range(rng.randrange(4))} - {k}
                for k in keys}
        rng.shuffle(keys)
        executed_i: set = set()
        executed_t: set = set()
        for key in keys:
            inc.commit(key, key, deps[key])
            tarjan.commit(key, key, deps[key])
            if rng.random() < 0.3:
                executed_i.update(inc.execute()[0])
                executed_t.update(tarjan.execute()[0])
        # Tarjan drains in one call; incremental may need several (one
        # blocker -- hence one resume -- per call).
        executed_t.update(tarjan.execute()[0])
        for _ in range(n + 1):
            got, blockers = inc.execute()
            executed_i.update(got)
            if not got and not blockers:
                break
        assert executed_i == executed_t == set(range(n))


def test_zigzag_no_starvation_across_columns_with_hole():
    """A hole in one column must not stop other columns from executing
    (regression: an early num_blockers exit starved later columns)."""
    g = ZigzagTarjanDependencyGraph(num_leaders=2)
    g.commit((0, 1), 1, set())  # hole at (0, 0)
    g.commit((1, 0), 0, set())
    executables, blockers = g.execute_by_component(num_blockers=1)
    assert [(1, 0)] in executables
    assert blockers == {(0, 0)}


# --- the cases of tests/test_compact.py --------------------------------------


def test_basic_add_contains():
    s = IntPrefixSet()
    assert not s.contains(0)
    assert s.add(0) is False       # wasn't present
    assert s.add(0) is True        # now it is
    assert s.watermark == 1        # compacted into watermark
    s.add(2)
    assert s.contains(2)
    assert not s.contains(1)
    s.add(1)
    assert s.watermark == 3        # 0,1,2 all compacted
    assert s.uncompacted_size == 0


def test_from_watermark_and_set():
    s = IntPrefixSet(3, {5, 7})
    assert s.contains(0) and s.contains(2)
    assert not s.contains(3)
    assert s.contains(5) and s.contains(7)
    assert s.size == 5
    assert s.materialize() == {0, 1, 2, 5, 7}


def test_compaction_on_construction():
    s = IntPrefixSet(2, {2, 3, 6})
    assert s.watermark == 4
    assert s.values == {6}


def test_union_diff():
    a = IntPrefixSet(3, {5})
    b = IntPrefixSet(1, {2, 8})
    u = a.union(b)
    assert u.materialize() == {0, 1, 2, 5, 8}
    d = a.diff(b)
    assert d.materialize() == {1, 5}  # a = {0,1,2,5}; b = {0,2,8}


def test_subtract_one_below_watermark():
    s = IntPrefixSet(4, set())
    s.subtract_one(2)
    assert s.materialize() == {0, 1, 3}
    assert s.watermark == 2  # re-compacted prefix 0,1


def test_subset_is_monotone():
    s = IntPrefixSet(3, {10})
    sub = s.subset()
    assert sub.materialize() <= s.materialize()
    s.add(3)
    assert sub.materialize() <= s.materialize()


def test_copy_is_equal_and_independent():
    s = IntPrefixSet(3, {5, 7})
    c = s.copy()
    assert c == s and c.values is not s.values
    c.add(3)
    c.add(4)
    assert (c.watermark, c.values) == (6, {7})
    assert (s.watermark, s.values) == (3, {5, 7})


def test_wire_roundtrip():
    s = IntPrefixSet(3, {7, 9})
    back = IntPrefixSet.from_dict(s.to_dict())
    assert back == s


def test_randomized_vs_set_oracle():
    rng = random.Random(99)
    s = IntPrefixSet()
    oracle: set[int] = set()
    for _ in range(500):
        op = rng.random()
        x = rng.randrange(40)
        if op < 0.6:
            assert s.add(x) == (x in oracle)
            oracle.add(x)
        elif op < 0.8:
            s.subtract_one(x)
            oracle.discard(x)
        else:
            other_vals = {rng.randrange(40) for _ in range(3)}
            other = IntPrefixSet.from_set(other_vals)
            if rng.random() < 0.5:
                s.add_all(other)
                oracle |= other_vals
            else:
                s.subtract_all(other)
                oracle -= other_vals
        assert s.materialize() == oracle
        assert s.size == len(oracle)
        for probe in range(45):
            assert s.contains(probe) == (probe in oracle)


def test_diff_iterator_matches_materialized():
    rng = random.Random(5)
    for _ in range(50):
        a = IntPrefixSet(rng.randrange(10),
                         {rng.randrange(30) for _ in range(5)})
        b = IntPrefixSet(rng.randrange(10),
                         {rng.randrange(30) for _ in range(5)})
        assert set(a.materialized_diff(b)) == a.materialize() - b.materialize()


def test_fake_compact_set():
    s = FakeCompactSet([1, 2])
    assert s.add(1) is True
    assert s.add(5) is False
    assert s.union(FakeCompactSet([9])).materialize() == {1, 2, 5, 9}
    assert s.diff(FakeCompactSet([2])).materialize() == {1, 5}



# --- cross-package agreement ---------------------------------------------------


@pytest.mark.parametrize("name", ["tarjan", "incremental", "naive", "zigzag"])
@pytest.mark.parametrize("seed", range(3))
def test_graphs_agree_with_the_reference(name, seed):
    """One randomized stream of commits (dependencies on earlier and
    later vertices, some never committed) and executes gives the same
    executables, in the same order, and the same blockers in both
    packages."""
    rng = random.Random(seed)
    kwargs = dict(num_leaders=3, make=lambda l, i: (l, i)) \
        if name == "zigzag" else {}
    port = make_dependency_graph(name, **kwargs)
    ref = jdepgraph.make_dependency_graph(name, **kwargs)
    next_id = [0, 0, 0]
    for _ in range(120):
        leader = rng.randrange(3)
        key = (leader, next_id[leader])
        next_id[leader] += 1
        deps = {(rng.randrange(3), rng.randrange(max(1, next_id[leader] + 2)))
                for _ in range(rng.randrange(4))}
        deps.discard(key)
        seq = rng.randrange(5)
        port.commit(key, seq, set(deps))
        ref.commit(key, seq, set(deps))
        if rng.random() < 0.3:
            blockers = rng.choice([None, 1, 2])
            assert port.execute(blockers) == ref.execute(blockers)
    assert port.execute(None) == ref.execute(None)
    assert port.num_vertices == ref.num_vertices


@pytest.mark.parametrize("seed", range(3))
def test_int_prefix_sets_agree_with_the_reference(seed):
    """The same random adds, unions, subtractions and diffs leave equal
    (watermark, values) in both packages' IntPrefixSets."""
    rng = random.Random(seed)
    port, ref = IntPrefixSet(), jcompact.IntPrefixSet()
    for _ in range(400):
        op = rng.random()
        x = rng.randrange(64)
        if op < 0.5:
            assert port.add(x) == ref.add(x)
        elif op < 0.7:
            w, vals = rng.randrange(32), {rng.randrange(64) for _ in range(3)}
            port.add_all(IntPrefixSet(w, vals))
            ref.add_all(jcompact.IntPrefixSet(w, vals))
        elif op < 0.85:
            port.subtract_one(x)
            ref.subtract_one(x)
        else:
            vals = {rng.randrange(64) for _ in range(4)}
            assert (sorted(port.materialized_diff(IntPrefixSet(0, vals)))
                    == sorted(ref.materialized_diff(
                        jcompact.IntPrefixSet(0, vals))))
        assert (port.watermark, port.values) == (ref.watermark, ref.values)
        assert port.contains(x) == ref.contains(x)
