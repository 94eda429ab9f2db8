"""Dependency graphs for generalized consensus (EPaxos/BPaxos executors).

Reference behavior: depgraph/ (DependencyGraph.scala:127-193 abstract API;
TarjanDependencyGraph.scala:149+ the fast one; Jgrapht/ScalaGraph
library-backed variants used as oracles in tests). Commit command
vertices with dependency sets; emit strongly-connected components in
reverse topological order for execution.
"""

from frankenpaxos_tpu_torch.depgraph.base import DependencyGraph
from frankenpaxos_tpu_torch.depgraph.incremental import (
    IncrementalTarjanDependencyGraph,
)
from frankenpaxos_tpu_torch.depgraph.naive import NaiveDependencyGraph
from frankenpaxos_tpu_torch.depgraph.tarjan import TarjanDependencyGraph
from frankenpaxos_tpu_torch.depgraph.zigzag import ZigzagTarjanDependencyGraph

def make_dependency_graph(name: str, *, num_leaders: int = None,
                          make=None, key_sort=None) -> DependencyGraph:
    """Select an implementation by name, the way the reference's role
    mains do (epaxos/ReplicaMain.scala:12-14,127 hardwires Zigzag;
    DependencyGraphTest runs every impl). ``num_leaders`` and ``make``
    are required by "zigzag", whose keys must decompose into dense
    per-leader (leader_index, id) vertex ids."""
    if name == "tarjan":
        return TarjanDependencyGraph(key_sort)
    if name == "incremental":
        return IncrementalTarjanDependencyGraph(key_sort)
    if name == "naive":
        return NaiveDependencyGraph(key_sort)
    if name == "zigzag":
        if num_leaders is None:
            raise ValueError("zigzag needs num_leaders")
        return ZigzagTarjanDependencyGraph(
            num_leaders, make=make or (lambda l, i: (l, i)),
            key_sort=key_sort)
    raise ValueError(f"unknown dependency graph {name!r}")


__all__ = [
    "DependencyGraph",
    "IncrementalTarjanDependencyGraph",
    "NaiveDependencyGraph",
    "TarjanDependencyGraph",
    "ZigzagTarjanDependencyGraph",
    "make_dependency_graph",
]
