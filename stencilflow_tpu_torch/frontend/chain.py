"""Kernel-chain DAG construction and traversal.

TPU-native re-think of the reference's ``KernelChainGraph``
(stencilflow/kernel_chain_graph.py:243-272,417-455): nodes are
field names (inputs, kernels, outputs), edges connect producers to consumers
by name matching.  We keep the graph as plain adjacency dicts (no networkx)
and expose topological order, cycle diagnostics, and the downward-closed cut
enumeration used for pipeline partitioning (``parallel/pipeline.py``).

Copied from ``stencilflow_tpu/frontend/chain.py`` with no change of
meaning (less ``cut_edges``, which nothing in the port uses): the port
cannot import the JAX package, whose ``__init__`` imports jax.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterator, List, Sequence, Set, Tuple

from .. import ir


class CycleError(ValueError):
    def __init__(self, cycle: Sequence[str]):
        self.cycle = list(cycle)
        super().__init__(f"Cycle detected: {self.cycle}")


@dataclasses.dataclass
class ChainGraph:
    """Dependency DAG of one stencil program.

    ``edges[u]`` lists consumers of field ``u``; ``redges[v]`` lists the
    producer fields kernel ``v`` reads.  Output sink nodes are implicit: a
    program output is simply a kernel listed in ``program.outputs``.
    """
    program: ir.Program
    edges: Dict[str, List[str]]
    redges: Dict[str, List[str]]
    order: List[str]  # topological: inputs first, then kernels

    @classmethod
    def build(cls, program: ir.Program) -> "ChainGraph":
        edges: Dict[str, List[str]] = {n: [] for n in program.inputs}
        redges: Dict[str, List[str]] = {}
        for kname in program.kernels:
            edges.setdefault(kname, [])
        for kname, kspec in program.kernels.items():
            producers = kspec.input_fields()
            redges[kname] = producers
            for p in producers:
                edges[p].append(kname)
        order = cls._topological_order(program, edges, redges)
        return cls(program, edges, redges, order)

    @staticmethod
    def _topological_order(program, edges, redges) -> List[str]:
        indeg = {n: 0 for n in edges}
        for v, preds in redges.items():
            indeg[v] = len(preds)
        # seed with inputs first (stable order: inputs in JSON order, then
        # kernels in JSON order)
        ready = [n for n in program.inputs if indeg[n] == 0]
        ready += [n for n in program.kernels if indeg[n] == 0]
        order: List[str] = []
        queue = list(ready)
        while queue:
            n = queue.pop(0)
            order.append(n)
            for succ in edges[n]:
                indeg[succ] -= 1
                if indeg[succ] == 0:
                    queue.append(succ)
        if len(order) != len(edges):
            remaining = [n for n in edges if n not in set(order)]
            cycle = ChainGraph._find_cycle(remaining, redges)
            raise CycleError(cycle)
        return order

    @staticmethod
    def _find_cycle(candidates, redges) -> List[str]:
        cand = set(candidates)
        seen: Set[str] = set()
        for start in candidates:
            path: List[str] = []
            on_path: Dict[str, int] = {}
            node = start
            while node in cand and node not in seen:
                if node in on_path:
                    return path[on_path[node]:]
                on_path[node] = len(path)
                path.append(node)
                preds = [p for p in redges.get(node, []) if p in cand]
                if not preds:
                    break
                node = preds[0]
            seen.update(path)
        return list(candidates)

    # ------------------------------------------------------------------
    @property
    def kernel_order(self) -> List[str]:
        return [n for n in self.order if n in self.program.kernels]

    def consumers(self, field: str) -> List[str]:
        return self.edges.get(field, [])

    def producers(self, kernel: str) -> List[str]:
        return self.redges.get(kernel, [])

    def edge_list(self) -> List[Tuple[str, str]]:
        return [(u, v) for u, succs in self.edges.items() for v in succs]

    # ------------------------------------------------------------------
    def enumerate_cuts(self) -> Iterator[FrozenSet[str]]:
        """Enumerate non-trivial downward-closed kernel subsets ("before"
        halves of a pipeline cut), reference: kernel_chain_graph.py:116-160.

        A cut set S is valid if every kernel predecessor of a kernel in S is
        also in S.  Yields each valid S (excluding the empty and full sets).
        """
        kernels = self.kernel_order
        n = len(kernels)
        if n > 20:
            raise ValueError("cut enumeration is exponential; refusing for "
                             f"{n} kernels — use partition heuristics instead")
        idx = {k: i for i, k in enumerate(kernels)}
        pred_masks = []
        for k in kernels:
            m = 0
            for p in self.producers(k):
                if p in idx:
                    m |= 1 << idx[p]
            pred_masks.append(m)
        for mask in range(1, (1 << n) - 1):
            ok = True
            for i in range(n):
                if mask & (1 << i) and (pred_masks[i] & ~mask):
                    ok = False
                    break
            if ok:
                yield frozenset(kernels[i] for i in range(n)
                                if mask & (1 << i))
