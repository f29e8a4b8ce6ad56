"""In-RAM bidirected unitig graph for simplification (UnitigGraph2 equivalent).

The port of metamdbg_tpu/graph/filter_graph.py. It is a pointer-chasing
walk over host lists and numpy, as in the JAX package, and runs on the
host whatever the pipeline's device. Mirrors src/graph/Graph.hpp:151-2813 exactly (single-thread semantics):
- unitig u has oriented indices 2u (forward) / 2u+1 (reverse);
- per-orientation successor lists; predecessors(t) = rc of successors(rc(t));
- node merge keeps the absorbing node's name, concatenates the oriented
  `unitig_merge` paths (Graph.hpp:1689-1989), merges sorted abundance vectors
  and recomputes the float median (Graph.hpp:253-288,294-334);
- list surgery (erase / in-place replace) preserves order, because downstream
  tie-breaks iterate these lists in order.

Float semantics: `_abundance` is a float32; the median uses double math for
the even case then rounds to float32 (UnitigNode::computeMedianAbundance).
"""

import collections
import struct

import numpy as np


def rc(index: int) -> int:
    return index ^ 1


class FilterNode:
    __slots__ = ("name", "nb_minimizers", "abundances", "abundance",
                 "succ_fwd", "succ_rev", "unitig_merge", "is_reversed",
                 "is_edge_node")

    def __init__(self, name: int, nb_minimizers: int):
        self.name = name
        self.nb_minimizers = nb_minimizers
        self.abundances = np.zeros(0, np.uint32)   # sorted ascending
        self.abundance = np.float32(0.0)
        self.succ_fwd: list = []
        self.succ_rev: list = []
        self.unitig_merge: list = []
        self.is_reversed = False
        self.is_edge_node = False

    def compute_median(self):
        a = self.abundances
        n = a.shape[0]
        if n == 0:
            return np.float32(0.0)
        if n % 2 == 0:
            return np.float32((float(a[n // 2 - 1]) + float(a[n // 2])) / 2.0)
        return np.float32(a[n // 2])

    def length(self, spacing_mean) -> int:
        """UnitigNode::getLength (Graph.hpp:222-226): u64 trunc of f32 product."""
        return int(np.float32(self.nb_minimizers - 1) * np.float32(spacing_mean))


class FilterGraph:
    def __init__(self, k: int, spacing_mean: float, kminmer_length: float):
        self.k = k
        self.spacing_mean = np.float32(spacing_mean)
        self.kminmer_length = np.float32(kminmer_length)
        self.unitigs: list[FilterNode | None] = []
        # Vectorized mirrors of the per-node scalars the simplification
        # scans need (abundance/nb_minimizers/alive/successor counts).
        # None until sync_arrays() is called; the surgery methods keep them
        # in sync once built, so ProgressiveAbundanceFilter's full-graph
        # scans are numpy ops instead of per-node Python loops.
        self._alive: np.ndarray | None = None
        self._ab: np.ndarray | None = None
        self._nbmin: np.ndarray | None = None
        self._nsucc: np.ndarray | None = None

    # -- vectorized mirrors --------------------------------------------------
    def sync_arrays(self):
        """(Re)build the numpy mirrors from the per-node objects."""
        n = len(self.unitigs)
        alive = np.zeros(n, bool)
        ab = np.zeros(n, np.float32)
        nbmin = np.zeros(n, np.int64)
        nsucc = np.zeros(2 * n, np.int32)
        for i, u in enumerate(self.unitigs):
            if u is None:
                continue
            alive[i] = True
            ab[i] = u.abundance
            nbmin[i] = u.nb_minimizers
            nsucc[2 * i] = len(u.succ_fwd)
            nsucc[2 * i + 1] = len(u.succ_rev)
        self._alive, self._ab = alive, ab
        self._nbmin, self._nsucc = nbmin, nsucc

    def alive_array(self) -> np.ndarray:
        """Alive unitig names as an int64 array (requires sync_arrays)."""
        return np.nonzero(self._alive)[0]

    def _set_succ(self, index: int, new_list: list):
        """Replace successors(index) in place, updating the count mirror."""
        node = self.unitigs[index // 2]
        lst = node.succ_rev if index % 2 else node.succ_fwd
        lst[:] = new_list
        if self._nsucc is not None:
            self._nsucc[index] = len(lst)

    def erase_succ(self, index: int, value: int):
        """Remove every `value` from successors(index) (order-preserving)."""
        node = self.unitigs[index // 2]
        lst = node.succ_rev if index % 2 else node.succ_fwd
        self._set_succ(index, [x for x in lst if x != value])

    def clear_succ(self, name: int):
        node = self.unitigs[name]
        node.succ_fwd = []
        node.succ_rev = []
        if self._nsucc is not None:
            self._nsucc[2 * name] = 0
            self._nsucc[2 * name + 1] = 0

    def _mirror_kill(self, name: int):
        if self._alive is not None:
            self._alive[name] = False
            self._nsucc[2 * name] = 0
            self._nsucc[2 * name + 1] = 0

    # -- construction -------------------------------------------------------
    @classmethod
    def from_unitig_graph(cls, graph, spacing_mean: float, kminmer_length: float):
        """From a freshly built graph.mdbg.UnitigGraph (nodes in deterministic
        order, successors per oriented index; abundances per unitig)."""
        fg = cls(graph.k, spacing_mean, kminmer_length)
        fg.unitigs = [None] * graph.n_unitigs
        for u in range(graph.n_unitigs):
            node = FilterNode(u, len(graph.sequences[u]))
            ab = np.sort(np.asarray(graph.abundances[u], np.uint32))
            node.abundances = ab
            node.abundance = node.compute_median()
            if node.abundance == 0:
                node.abundance = np.float32(1.0)
            node.succ_fwd = sorted(graph.successors[2 * u])
            node.succ_rev = sorted(graph.successors[2 * u + 1])
            fg.unitigs[u] = node
        return fg

    # -- accessors ----------------------------------------------------------
    def node(self, name: int) -> FilterNode | None:
        return self.unitigs[name]

    def successors(self, index: int) -> list:
        node = self.unitigs[index // 2]
        return node.succ_rev if index % 2 else node.succ_fwd

    def predecessors(self, index: int) -> list:
        return [rc(s) for s in self.successors(rc(index))]

    def nb_successors(self, index: int) -> int:
        return len(self.successors(index))

    def nb_predecessors(self, index: int) -> int:
        return len(self.successors(rc(index)))

    # -- surgery ------------------------------------------------------------
    def remove_node(self, node: FilterNode):
        """Graph.hpp:1170-1228 removeNode + removeEdges both orientations."""
        for is_rev in (False, True):
            index = node.name * 2 + (1 if is_rev else 0)
            to_remove = rc(index)
            for succ in self.successors(index):
                self.erase_succ(rc(succ), to_remove)
        self.unitigs[node.name] = None
        self._mirror_kill(node.name)

    def merge_node(self, index1: int, index2: int):
        """Graph.hpp:1689-1989 mergeNode: oriented unitig index1 absorbs index2."""
        rev1 = bool(index1 % 2)
        rev2 = bool(index2 % 2)
        name1, name2 = index1 // 2, index2 // 2
        u1 = self.unitigs[name1]
        u2 = self.unitigs[name2]

        if not u1.unitig_merge:
            u1.is_reversed = rev1
            u1.unitig_merge = [index1]
        if u1.is_reversed != rev1:
            u1.is_reversed = rev1
            u1.unitig_merge = [rc(x) for x in u1.unitig_merge[::-1]]

        if not u2.unitig_merge:
            u1.unitig_merge.append(index2)
        elif u2.is_reversed != rev2:
            u1.unitig_merge.extend(rc(x) for x in u2.unitig_merge[::-1])
        else:
            u1.unitig_merge.extend(u2.unitig_merge)

        # mergeWith (Graph.hpp:294-334)
        merged = np.sort(np.concatenate([u1.abundances, u2.abundances]))
        u1.abundances = merged
        u1.abundance = u1.compute_median()
        if u1.abundance == 0:
            u1.abundance = np.float32(1.0)
        u1.nb_minimizers += u2.nb_minimizers - self.k + 1

        # rewire: successors of index2 replace rc(index2) -> rc(index1)
        to_replace = rc(index2)
        replacement = rc(index1)
        for succ in self.successors(index2):
            snode = self.unitigs[succ // 2]
            lst = snode.succ_fwd if succ % 2 else snode.succ_rev
            lst[:] = [replacement if x == to_replace else x for x in lst]

        succ2 = list(self.successors(index2))
        self._set_succ(index1, succ2)

        self.unitigs[name2] = None
        self._mirror_kill(name2)
        if self._alive is not None:
            self._ab[name1] = u1.abundance
            self._nbmin[name1] = u1.nb_minimizers

    def recompact_index(self, index: int):
        """Graph.hpp:1438-1485: merge forward while single succ/pred chain."""
        while True:
            succs = self.successors(index)
            if len(succs) != 1:
                return
            preds = self.predecessors(succs[0])
            if len(preds) != 1 or succs[0] == preds[0]:
                return
            self.merge_node(index, succs[0])

    def recompact_node(self, node: FilterNode):
        """Graph.hpp:1380-1385: reverse orientation first, then forward."""
        self.recompact_index(node.name * 2 + 1)
        if self.unitigs[node.name] is not None:
            self.recompact_index(node.name * 2)

    # -- predicates ---------------------------------------------------------
    def is_circular(self, node: FilterNode) -> bool:
        """Graph.hpp:2553-2566."""
        idx = node.name * 2
        succs = self.successors(idx)
        preds = self.predecessors(idx)
        return ((node.nb_minimizers - self.k + 1) > 1 and len(succs) == 1
                and len(preds) == 1 and succs[0] == idx and preds[0] == idx)

    def is_repeat_side(self, node: FilterNode) -> bool:
        """Graph.hpp:2568-2602."""
        if (node.nb_minimizers - self.k + 1) > self.k * 2:
            return False
        if not node.succ_fwd or not node.succ_rev:
            return False
        idx = node.name * 2
        succs = self.successors(idx)
        preds = self.predecessors(idx)
        for s in succs:
            if s // 2 == node.name:
                continue
            for p in preds:
                if p // 2 == node.name:
                    continue
                if s == p:
                    return True
        return False

    def alive_names(self) -> list:
        return [i for i, u in enumerate(self.unitigs) if u is not None]

    # -- GFA export ---------------------------------------------------------
    def save_gfa(self, path: str):
        """UnitigGraph2::save (Graph.hpp:2126-2418): S/L lines in component
        BFS order plus the `.unitigs.nodepath` records used by toMinspace to
        fill in minimizer sequences."""
        nodepath = open(path + ".unitigs.nodepath", "wb")
        out = open(path, "w")
        visited: set = set()
        for node in self.unitigs:
            if node is None or node.name in visited:
                continue
            q = collections.deque([2 * node.name])
            while q:
                index = q.popleft()
                name = index // 2
                if name in visited:
                    continue
                visited.add(name)
                u = self.unitigs[name]
                ori1 = "-" if index % 2 else "+"
                length = u.length(self.spacing_mean)
                out.write(f"S\tutg{name}\t*\tLN:i:{length}\t"
                          f"dp:i:{u.abundance}\n")
                unitigs = u.unitig_merge if u.unitig_merge else [index]
                nodepath.write(struct.pack("<IB", len(unitigs), 0))
                nodepath.write(np.asarray(unitigs, np.uint32).tobytes())
                for s in self.successors(index):
                    ori2 = "-" if s % 2 else "+"
                    out.write(f"L\tutg{name}\t{ori1}\tutg{s // 2}\t{ori2}\t1M\n")
                    q.append(s)
                for p in self.predecessors(index):
                    ori2 = "-" if p % 2 else "+"
                    out.write(f"L\tutg{p // 2}\t{ori2}\tutg{name}\t{ori1}\t1M\n")
                    q.append(p)
        out.close()
        nodepath.close()
