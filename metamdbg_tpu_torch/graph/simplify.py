"""Progressive abundance filter: superbubble + tip removal + cutoff sweep.

The port of metamdbg_tpu/graph/simplify.py: host code on the FilterGraph,
as in the JAX package, with its float32 arithmetic kept exactly (the
cutoff ladder t *= 1.1 and the tip lengths are float32, never float64).
Mirrors src/graph/ProgressiveAbundanceFilter.hpp (single-thread semantics,
which is the reference's deterministic mode):

- simplifyProgressive (hpp:1864-1920): loop { simplify(); dump state per new
  cutoff; removeAbundanceNoQueue } until fixpoint;
- simplify (hpp:2000-2170): superbubble pass + tip pass until stable;
- SuperbubbleRemoverOld (hpp:69-1334): per >1-successor source in scan order,
  BFS superbubble test, Bellman-Ford best path kept, interior removed,
  neighbors recompacted sorted by BubbleSideComparatorRev;
- TipRemover (hpp:1335-1673): ordered set keyed by (nbMinimizers, abundance,
  oriented-index desc), disconnect tip, recompact predecessors in sorted
  order;
- removeAbundanceNoQueue (hpp:2183-2343): geometric cutoff t *= 1.1 (float32,
  step capped +10), drop nodes with abundance < t, recompact neighbors;
- dumpUnitigs (hpp:2521-2642): per-cutoff snapshot of surviving unitig paths
  to filter/unitigs_<i>.bin.
"""

import collections
import heapq
import os
import struct

import numpy as np

from .filter_graph import FilterGraph, rc

F32 = np.float32


class ProgressiveAbundanceFilter:

    def __init__(self, graph: FilterGraph, out_dir: str,
                 max_bubble_length: int = 50000, max_tip_length: int = 50000,
                 remove_bubble: bool = True, gen_graph: bool = False):
        self.g = graph
        self.out_dir = out_dir
        self.max_bubble_length = max_bubble_length
        self.max_tip_length = max_tip_length
        self.remove_bubble = remove_bubble
        self.gen_graph = gen_graph
        self.cutoff_index = 0
        self.cutoff_values: list[float] = []   # cutoff per dumped index
        self.valid_nodes: list = []
        self.current_cutoff = 0.0

    # ------------------------------------------------------------------
    def execute(self):
        g = self.g
        g.sync_arrays()
        ab_alive = g._ab[g._alive]
        max_abundance = F32(ab_alive.max()) if ab_alive.size else F32(0.0)
        max_abundance = min(max_abundance, F32(10000.0))

        current_cutoff = F32(0.0)
        dumped = set()
        while True:
            is_modification = self.simplify()
            if float(current_cutoff) not in dumped:
                dumped.add(float(current_cutoff))
                if current_cutoff == 0 and self.gen_graph:
                    self.g.save_gfa(os.path.join(self.out_dir,
                                                 "assembly_graph.gfa"))
                self.dump_unitigs(float(current_cutoff))
            nb_removed, current_cutoff = self.remove_abundance(max_abundance)
            if nb_removed > 0:
                is_modification = True
            if not is_modification:
                break

    # ------------------------------------------------------------------
    def simplify(self) -> bool:
        g = self.g
        max_len_kminmer = int(F32(g.kminmer_length) * np.float64(2.25))
        max_tip = max(self.max_tip_length, max_len_kminmer)
        max_bubble = max(self.max_bubble_length, max_len_kminmer)

        is_modification = False
        while True:
            is_mod_sub = False
            self.valid_nodes = g.alive_array()

            if self.remove_bubble:
                if self._remove_superbubbles(max_bubble):
                    is_modification = True
                    is_mod_sub = True

            if self._remove_tips(max_tip):
                is_modification = True
                is_mod_sub = True

            if not is_mod_sub:
                break
        return is_modification

    # -- superbubbles ---------------------------------------------------
    def _remove_superbubbles(self, max_length) -> bool:
        g = self.g
        # Vectorized source scan: per alive name in order, fwd then rev
        # orientation with >1 successors (row-major flatten keeps that order).
        valid = self.valid_nodes
        valid = valid[g._alive[valid]]
        idx2 = 2 * valid
        pair = np.stack([idx2, idx2 + 1], axis=1)
        mask = np.stack([g._nsucc[idx2] > 1, g._nsucc[idx2 + 1] > 1], axis=1)
        queue = pair[mask].tolist()

        is_unitig_bubble: set = set()
        bubbles = []
        for index in queue:
            node = g.unitigs[index // 2]
            if node is None or g.nb_successors(index) <= 1:
                continue
            found, exit_idx = self._is_superbubble(index, max_length)
            if not found:
                continue
            if exit_idx == rc(index):
                continue  # loop side of an inverse repeat
            if exit_idx in g.successors(index):
                continue  # direct edge source->exit
            if index < exit_idx:
                removed = self._collapse(index, exit_idx)
                for x in removed:
                    is_unitig_bubble.add(x // 2)
                bubbles.append((index, exit_idx))
            else:
                removed = self._collapse(rc(exit_idx), rc(index))
                for x in removed:
                    is_unitig_bubble.add(x // 2)
                bubbles.append((rc(exit_idx), rc(index)))

        all_to_remove: set = set()
        for src, ext in bubbles:
            if src // 2 in is_unitig_bubble or ext // 2 in is_unitig_bubble:
                continue
            for x in self._collapse(src, ext):
                all_to_remove.add(x)

        is_modification = False
        recompact: set = set()
        for index in sorted(all_to_remove):  # set order deterministic: sorted
            name = index // 2
            if g.unitigs[name] is None:
                continue
            succs = list(g.successors(index))
            preds = g.predecessors(index)
            g.remove_node(g.unitigs[name])
            is_modification = True
            for p in preds:
                if g.unitigs[p // 2] is not None:
                    recompact.add(p)
            for s in succs:
                if g.unitigs[s // 2] is not None:
                    recompact.add(rc(s))

        self._recompact_sorted(recompact)
        return is_modification

    def _is_superbubble(self, source: int, max_length):
        """SuperbubbleRemoverOld::isSuperbubble (hpp:608-775)."""
        g = self.g
        is_visited = set()
        seen = set()
        queue = collections.deque()
        queue.append((source, 0))

        while queue:
            v, nb_min = queue.popleft()
            v_succ = g.successors(v)
            if self.cutoff_index == 0 and len(v_succ) > 5:
                return False, 0
            if F32(nb_min) * g.spacing_mean > F32(max_length):
                return False, 0
            is_visited.add(v)
            seen.discard(v)
            if not v_succ:
                return False, 0  # abort tip
            for u in v_succ:
                if u not in is_visited:
                    seen.add(u)
                else:
                    return False, 0  # cycle within superbubble
            for u in v_succ:
                preds = g.predecessors(u)
                if all(p in is_visited for p in preds):
                    nb = g.unitigs[u // 2].nb_minimizers - (g.k - 1)
                    queue.append((u, nb_min + nb))
                if len(queue) == 1 and len(seen) == 1 and queue[0][0] in seen:
                    t = next(iter(seen))
                    if source not in g.successors(t):
                        return True, t
                    return False, 0  # cycle including s
        return False, 0

    def _collapse(self, source: int, exit_idx: int) -> list:
        """collapseSuperbubble2 (hpp:956-1031): interior minus best path."""
        g = self.g
        interior = self._collect_superbubble_nodes(source, exit_idx)
        keep = self._bellman_ford(source, exit_idx, interior)
        return [x for x in interior if x not in keep]

    def _collect_superbubble_nodes(self, source: int, exit_idx: int) -> list:
        """BFS interior collection in visit order (hpp:1167-1208)."""
        g = self.g
        nodes = []
        visited = {source, exit_idx}
        q = collections.deque([source])
        while q:
            v = q.popleft()
            for u in g.successors(v):
                if u in visited:
                    continue
                q.append(u)
                visited.add(u)
                nodes.append(u)
        return nodes

    def _bellman_ford(self, source: int, exit_idx: int, interior: list) -> set:
        """hpp:1213-1288: heaviest path by abundance sum, with abundance
        cutoffs [1, .75, .5, .25, 0] x min(source, exit) abundance."""
        g = self.g
        nodes = list(interior) + [source]
        base = min(float(g.unitigs[source // 2].abundance),
                   float(g.unitigs[exit_idx // 2].abundance))
        absum_cache: dict = {}

        def absum(name: int) -> int:
            s = absum_cache.get(name)
            if s is None:
                s = int(g.unitigs[name].abundances.sum(dtype=np.int64))
                absum_cache[name] = s
            return s

        keep: set = set()
        for cutoff in (1.0, 0.75, 0.5, 0.25, 0.0):
            min_ab = F32(base * cutoff)
            if not self._is_reachable(source, exit_idx, min_ab):
                continue
            parent: dict = {}
            # dist: interior+source start at +inf (None), source 0; any other
            # key (the exit) is default-created at 0 on first access, matching
            # the reference's unordered_map operator[] (hpp:1240-1269)
            dist = {u: None for u in nodes}
            dist[source] = 0
            for uu in nodes:
                if g.unitigs[uu // 2].abundance < min_ab:
                    continue
                for u in nodes:
                    if g.unitigs[u // 2].abundance < min_ab:
                        continue
                    if dist.get(u) is None:
                        continue
                    for v in g.successors(u):
                        if g.unitigs[v // 2].abundance < min_ab:
                            continue
                        if v not in dist:
                            dist[v] = 0  # operator[] default
                        w = -absum(v // 2)
                        nd = dist[u] + w
                        if dist[v] is None or nd < dist[v]:
                            parent[v] = u
                            dist[v] = nd
            cur = exit_idx
            while True:
                keep.add(cur)
                cur = parent[cur]
                if cur == source:
                    break
            break
        return keep

    def _is_reachable(self, source: int, dest: int, min_ab) -> bool:
        """DFS through nodes with abundance >= min_ab (hpp:1291-1330)."""
        g = self.g
        visited = set()
        stack = [source]
        while stack:
            v = stack.pop()
            if v in visited:
                continue
            visited.add(v)
            for u in g.successors(v):
                if u == dest:
                    return True
                if g.unitigs[u // 2].abundance < min_ab:
                    continue
                stack.append(u)
        return False

    # -- tips -----------------------------------------------------------
    def _tip_index(self, node, max_length):
        """isTipAny (hpp:1632-1671): returns oriented tip index or None."""
        g = self.g
        if node is None:
            return None
        if node.length(g.spacing_mean) > max_length:
            return None
        for idx in (2 * node.name, 2 * node.name + 1):
            if not g.successors(idx) and g.successors(rc(idx)):
                return idx
        return None

    def _remove_tips(self, max_length) -> bool:
        """TipRemover (hpp:1400-1629) with its exact queue ordering."""
        g = self.g
        # std::set<TipData, TipComparator2>: nbMinimizers asc, abundance asc,
        # startNode (oriented tip index) DESC; dedup on full key.
        # Vectorized candidate scan (same predicate as _tip_index).
        valid = self.valid_nodes
        valid = valid[g._alive[valid]]
        nbmin = g._nbmin[valid]
        lengths = ((nbmin - 1).astype(np.float32)
                   * g.spacing_mean).astype(np.int64)
        ok = lengths <= max_length
        v = valid[ok]
        nb = nbmin[ok]
        nf = g._nsucc[2 * v]
        nr = g._nsucc[2 * v + 1]
        tip_f = (nf == 0) & (nr > 0)
        tip_r = (nr == 0) & (nf > 0)
        tip_idx_arr = np.where(tip_f, 2 * v,
                               np.where(tip_r, 2 * v + 1, -1))
        sel = tip_idx_arr >= 0
        members: set = {
            (int(n), float(a), -int(t), int(name))
            for n, a, t, name in zip(nb[sel], g._ab[v[sel]],
                                     tip_idx_arr[sel], v[sel])
        }
        # min-pop over a std::set == heap + lazy membership (min(queue) per
        # pop was O(|queue|) and dominated whole-graph simplification).
        heap = list(members)
        heapq.heapify(heap)

        def queue_add(key):
            if key not in members:
                members.add(key)
                heapq.heappush(heap, key)

        is_modification = False
        nb_removed = 0
        while members:
            key = heapq.heappop(heap)
            if key not in members:
                continue
            members.discard(key)
            name = key[3]
            node = g.unitigs[name]
            if node is None:
                continue
            tip_idx = self._tip_index(node, max_length)
            if tip_idx is None:
                continue
            is_modification = True
            nb_removed += 1

            preds = sorted(g.predecessors(tip_idx))
            for p in preds:
                pnode = g.unitigs[p // 2]
                if pnode is None:
                    continue
                g.erase_succ(p, tip_idx)
            for p in preds:
                pnode = g.unitigs[p // 2]
                if pnode is None:
                    continue
                g.recompact_index(p)
                tip2 = self._tip_index(pnode, max_length)
                if tip2 is not None:
                    queue_add((pnode.nb_minimizers, float(pnode.abundance),
                               -tip2, pnode.name))
            g.clear_succ(name)
        return is_modification

    # -- abundance cutoff ------------------------------------------------
    def remove_abundance(self, max_abundance):
        """removeAbundanceNoQueue (hpp:2183-2343)."""
        g = self.g
        nb_removed = 0
        t = F32(1.1)
        current_cutoff = min(t, F32(max_abundance))

        valid = np.asarray(self.valid_nodes, np.int64)
        while t < max_abundance:
            current_cutoff = t
            recompact: set = set()
            # Vectorized sub-cutoff scan; removals within a pass only kill
            # the candidate itself and abundances are static until the
            # deferred recompaction below, so the precomputed set is exact.
            cand_mask = g._alive[valid] & (g._ab[valid] < t)
            for name in valid[cand_mask].tolist():
                node = g.unitigs[name]
                if node is None:
                    continue
                index = 2 * name
                preds = g.predecessors(index)
                succs = list(g.successors(index))
                g.remove_node(node)
                for p in preds:
                    if g.unitigs[p // 2] is not None:
                        recompact.add(p)
                for s in succs:
                    if g.unitigs[s // 2] is not None:
                        recompact.add(rc(s))
                nb_removed += 1

            self._recompact_sorted(recompact)

            new_t = t * (F32(1.0) + F32(0.1))
            step = min(new_t - t, F32(10.0))
            t = t + step
            if nb_removed > 0:
                break
        self.current_cutoff = float(current_cutoff)
        return nb_removed, current_cutoff

    def _recompact_sorted(self, recompact: set):
        """Sort by BubbleSideComparatorRev: nbMinimizers asc, index desc
        (hpp:40-47,2283-2307), then recompact each oriented index."""
        g = self.g
        vec = []
        for index in recompact:
            node = g.unitigs[index // 2]
            if node is None:
                continue
            vec.append((node.nb_minimizers, -index))
        vec.sort()
        for _, neg_index in vec:
            index = -neg_index
            if g.unitigs[index // 2] is None:
                continue
            g.recompact_index(index)

    # -- dumping ----------------------------------------------------------
    def dump_unitigs(self, cutoff: float):
        """hpp:2521-2642; record: u32 n, u8 isCircular, u8 isRepeatSide,
        f32 abundance, u32 nbMinimizers, u32 path[n]."""
        g = self.g
        path = f"{self.out_dir}/filter/unitigs_{self.cutoff_index}.bin"
        with open(path, "wb") as f:
            for name, node in enumerate(g.unitigs):
                if node is None:
                    continue
                if not node.succ_fwd and not node.succ_rev and node.abundance == 1:
                    continue
                unitigs = node.unitig_merge if node.unitig_merge else [2 * name]
                f.write(struct.pack("<IBB", len(unitigs),
                                    1 if g.is_circular(node) else 0,
                                    1 if g.is_repeat_side(node) else 0))
                f.write(struct.pack("<fI", node.abundance, node.nb_minimizers))
                f.write(np.asarray(unitigs, np.uint32).tobytes())
        self.cutoff_values.append(cutoff)
        self.cutoff_index += 1
