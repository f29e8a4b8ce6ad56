"""k -> k+1 multiplex pass (k > firstK+1): re-solve junctions on the previous
unitig graph instead of rebuilding from reads.

The port of metamdbg_tpu/graph/multiplex.py (method there, after
src/graph/CreateMdbg.cpp:386-476 and computeNextUnitigGraph,
cpp:3712-5714). What is table work runs on the pass's device: every window
hash goes through kernel KW (kernels/window_hash.py), and the refined
previous-abundance overlay, the min-of-adjacent abundances, the
first-occurrence dedup and every lookup are torch sorts, segment maxima
and searches. The graph surgery from `_solve_edges` on stays host code,
as in the JAX package. Its hashes are batched: the count makes one KW
launch a pass, over the reads' stream kept on the device (`ReadsCache`)
and the pass's host sequences; each later step hashes and looks up every
k-window it may ask about in one launch, and memoizes the answers
(`_km_abundances`).
"""

import collections
import logging
import os
import struct

import numpy as np
import torch

from ..count.kminmers import PairTable, flat_window_hashes, pair_heads, \
    sort_pairs
from ..count.refined import overlay_refined
from ..io import records
from ..kernels import window_hash
from ..utils import spans
from . import gio
from .filter_graph import FilterGraph, FilterNode, rc

F32 = np.float32
log = logging.getLogger("metamdbg_tpu_torch")


def first_occurrence_table(h1, h2, values) -> PairTable:
    """The k-min-mer table IndexKminmerFunctor builds, where the first
    insert of a key wins: a stable sort keeps input order within a key, so
    each run's head is the winner."""
    order = sort_pairs(h1, h2)
    h1, h2, values = h1[order], h2[order], values[order]
    head = pair_heads(h1, h2)
    return PairTable(h1[head], h2[head], values[head], presorted=True)


class ReadsCache:
    """What the ~100 multiplex passes of one run share: the minimizer reads
    of read_data_corrected.txt, parsed once per file identity, their u32
    stream on the device (a KW `Stream`, uploaded once), and their
    window-hash planes there. Pass k computes the reads' width-k plane, and
    pass k+1 reuses it as its width-(k-1) plane. A change of the file
    (path, mtime or size) drops everything."""

    def __init__(self):
        self.key = None
        self.items: list = []
        self.planes: dict = {}
        self.stream: window_hash.Stream | None = None

    def reads(self, path: str):
        key = (path, os.path.getmtime(path), os.path.getsize(path))
        if key != self.key:
            self.key = key
            self.planes = {}
            self.stream = None
            self.items = [(r.minimizers, 1 if r.is_circular else 0)
                          for r in records.read_read_data(path, False)]
        return self.items

    def reads_stream(self, path: str, device) -> window_hash.Stream:
        """The reads' minimizers as a KW stream on `device`."""
        items = self.reads(path)
        device = window_hash._device(device)
        if self.stream is None or self.stream.device != device:
            self.planes = {}
            self.stream = window_hash.Stream([m for m, _ in items]).to(device)
        return self.stream


class MultiplexPass:

    def __init__(self, out_dir: str, k: int, params: records.Parameters,
                 device, cache: ReadsCache | None = None):
        self.out_dir = out_dir
        self.k = k
        self.k_prev = k - 1
        self.params = params
        self.device = torch.device(device)
        self.cache = cache if cache is not None else ReadsCache()
        self.km: PairTable | None = None    # hash128 -> abundance (>= 2)
        self._memo: dict = {}               # window bytes -> abundance or 0
        self.sequences: list = []           # unitigName -> minimizer seq
        self.graph: FilterGraph | None = None

    # ------------------------------------------------------------------
    def run(self):
        """The pass, each phase in a span `multiplex.<phase>` (the device
        work of a phase ends in the host syncs inside it)."""
        seconds = {}
        for name, phase in (("count", self._count_kminmers),
                            ("load", self._load_prev_graph),
                            ("edges", self._solve_edges),
                            ("unsupported", self._remove_unsupported),
                            ("small", self._solve_small_unitigs),
                            ("write", self._write_unitigs)):
            with spans.span("multiplex." + name) as s:
                s.add("k", self.k)
                phase()
            seconds[name] = s.seconds
        log.debug("multiplex k=%d phases: %s", self.k, " ".join(
            f"{n} {t:.3f}s" for n, t in seconds.items()))

    # ------------------------------------------------------------------
    def _refined_nodes(self):
        """loadRefinedAbundances' inputs (cpp:3401-3709): the previous
        pass's abundance table with cnt==1 dropped (keys (N, 2), values),
        and the refined nodes' sequences and abundances in file order."""
        keys, counts = gio.read_kminmer_abundances(
            os.path.join(self.out_dir, "kminmerData_abundance_prev.txt"))
        keep = counts != 1
        base = torch.from_numpy(np.ascontiguousarray(keys[keep])
                                .view(np.int64).reshape(-1, 2)).to(self.device)
        base_v = torch.from_numpy(counts[keep].astype(np.int64)).to(
            self.device)

        with open(os.path.join(self.out_dir,
                               "unitigGraph.nodes.refined_abundances.bin"),
                  "rb") as f:
            refined = dict(struct.iter_unpack("<II", f.read()))
        nodes = [(seq, idx // 2) for seq, idx in gio.read_unitig_nodes(
            os.path.join(self.out_dir, "unitigGraph_prev.nodes.bin"))
            if idx // 2 in refined]
        return (base, base_v, [seq for seq, _ in nodes],
                [refined[name] for _, name in nodes])

    def _refined_prev_index(self, base, base_v, overlay, abundances
                            ) -> PairTable:
        """The previous pass's table overlaid by each refined node's window
        hashes `overlay` (h1, h2, offsets) in file order
        (count/refined.overlay_refined)."""
        ov_h1, ov_h2, ov_off = overlay
        ab = torch.tensor(abundances, dtype=torch.int64, device=self.device)
        ov_ab = torch.repeat_interleave(ab, ov_off[1:] - ov_off[:-1],
                                        output_size=ov_h1.shape[0])
        return overlay_refined(base[:, 0], base[:, 1], base_v,
                               ov_h1, ov_h2, ov_ab)

    def _hash_planes(self, reads_path: str, refined_seqs: list,
                     contig_seqs: list):
        """Every window hash the count needs, in one KW launch: the refined
        nodes at k-1, the reads at k-1 unless the previous pass left that
        plane in the cache, the contigs at k-1, the reads and the contigs
        at k. Returns (refined, reads at k-1, contigs at k-1, reads at k,
        contigs at k), each (h1, h2, window offsets)."""
        reads = self.cache.reads_stream(reads_path, self.device)
        host = window_hash.Stream(refined_seqs + contig_seqs)
        n_ref, kp, k = len(refined_seqs), self.k_prev, self.k
        cached = self.cache.planes.get(kp)
        segs = [window_hash.Segment(host, kp, hi=n_ref)]
        if cached is None:
            segs.append(window_hash.Segment(reads, kp))
        segs += [window_hash.Segment(host, kp, lo=n_ref),
                 window_hash.Segment(reads, k),
                 window_hash.Segment(host, k, lo=n_ref)]
        planes = window_hash.hash_segments(segs, self.device)
        if cached is not None:
            planes.insert(1, cached)
        self.cache.planes.pop(kp, None)  # the next pass needs width k
        self.cache.planes[k] = planes[3]
        return planes

    def _count_kminmers(self):
        """IndexKminmerFunctor over reads then previous contigs
        (cpp:436-445); writes kminmerData_abundance.txt + small contigs."""
        base, base_v, refined_seqs, refined_ab = self._refined_nodes()
        reads_path = os.path.join(self.out_dir, "read_data_corrected.txt")
        read_items = self.cache.reads(reads_path)
        contig_items = [(r.minimizers, 1 if r.is_circular else 0)
                        for r in records.read_read_data(
                            os.path.join(self.out_dir, "unitig_data.txt"),
                            False)]
        n_reads = len(read_items)
        items = read_items + contig_items
        overlay, *planes = self._hash_planes(
            reads_path, refined_seqs, [m for m, _ in contig_items])
        prev = self._refined_prev_index(base, base_v, overlay, refined_ab)

        def sweep(reads, contigs):
            """Window hashes of reads + contigs at one width."""
            (rh1, rh2, roff), (ch1, ch2, coff) = reads, contigs
            return (torch.cat([rh1, ch1]), torch.cat([rh2, ch2]),
                    torch.cat([roff, roff[-1] + coff[1:]]))

        hp1, hp2, offp = sweep(planes[0], planes[1])
        ab_prev, _ = prev.lookup(hp1, hp2, 1)

        lens = np.fromiter((m.shape[0] for m, _ in items), np.int64,
                           len(items))
        nwin_k = np.maximum(lens - self.k + 1, 0)
        nwin_p = np.maximum(lens - self.k_prev + 1, 0)

        # small contigs: no k-window but a prev-window (so exactly one: the
        # length is k_prev), extracting, k > 8
        small_path = os.path.join(self.out_dir, "smallContigs",
                                  f"smallContigs_k{self.k}.bin")
        with open(small_path, "wb") as small_file:
            if self.k > 8:
                small = n_reads + np.flatnonzero(
                    (nwin_k[n_reads:] <= 0) & (nwin_p[n_reads:] > 0))
                offp_h = offp.cpu().numpy()
                ab0 = ab_prev[torch.from_numpy(offp_h[small]).to(
                    self.device)].tolist()
                for i, a in zip(small.tolist(), ab0):
                    if a > 1:
                        m, circ = items[i]
                        small_file.write(struct.pack("<IB", m.shape[0], circ))
                        small_file.write(m.astype(np.uint32).tobytes())

        # abundance per k-window = min of the two spanning prev windows: for
        # item i, k-window j pairs prev windows (j, j+1); globally that is
        # every prev window except each item's last one. An item without a
        # k-window has at most one prev window, its last, so it adds none.
        keep = torch.ones(ab_prev.shape[0], dtype=torch.bool,
                          device=self.device)
        last = offp[1:][torch.from_numpy(nwin_p > 0).to(self.device)] - 1
        keep[last] = False
        x = torch.nonzero(keep).flatten()
        minab = torch.minimum(ab_prev[x], ab_prev[x + 1])

        hk1, hk2, _ = sweep(planes[2], planes[3])
        if hk1.shape[0] != minab.shape[0]:
            raise AssertionError("k-window and prev-window counts disagree")

        sel = minab > 1
        self.km = first_occurrence_table(hk1[sel], hk2[sel], minab[sel])

        # set semantics; the table is in unsigned key order
        gio.write_abundance_records(
            os.path.join(self.out_dir, "kminmerData_abundance.txt"),
            gio.key_bytes(self.km.h1, self.km.h2), self.km.values)

    def _km_abundances(self, seqs: list) -> list:
        """The k-min-mer table's abundance of each host window's normalized
        hash128, 0 where absent (stored abundances are >= 2). Windows not
        memoized yet are hashed and looked up in one KW launch."""
        todo = {}
        for s in seqs:
            b = s.tobytes()
            if b not in self._memo:
                todo[b] = s
        if todo:
            width = self.k
            if any(s.shape[0] != width for s in todo.values()):
                raise ValueError(f"every queried window must have width "
                                 f"{width}")
            h1, h2, _ = flat_window_hashes(list(todo.values()), width,
                                           self.device)
            vals, _ = self.km.lookup(h1, h2, 0)
            self._memo.update(zip(todo, vals.tolist()))
        return [self._memo[s.tobytes()] for s in seqs]

    # ------------------------------------------------------------------
    def _load_prev_graph(self):
        g = FilterGraph(self.k_prev, self.params.minimizer_spacing_mean,
                        self.params.kminmer_length_mean)
        nodes = gio.read_unitig_nodes(
            os.path.join(self.out_dir, "unitigGraph_prev.nodes.bin"))
        g.unitigs = [None] * len(nodes)
        self.sequences = [None] * len(nodes)
        for seq, idx in nodes:
            node = FilterNode(idx // 2, seq.shape[0])
            g.unitigs[idx // 2] = node
            self.sequences[idx // 2] = np.asarray(seq, np.uint32)
        for idx, ab in gio.read_unitig_abundances(
                os.path.join(self.out_dir,
                             "unitigGraph_prev.nodes.abundances.bin")):
            node = g.unitigs[idx // 2]
            node.abundances = np.sort(np.asarray(ab, np.uint32))
            node.abundance = node.compute_median()
            if node.abundance == 0:
                node.abundance = F32(1.0)
        edges = gio.read_unitig_edges(
            os.path.join(self.out_dir,
                         "unitigGraph_prev.edges.successors.bin"))
        for oriented, succ in edges.items():
            node = g.unitigs[oriented // 2]
            if oriented % 2:
                node.succ_rev = sorted(succ.tolist())
            else:
                node.succ_fwd = sorted(succ.tolist())
        self.graph = g

    # ------------------------------------------------------------------
    def _oriented_seq(self, index: int) -> np.ndarray:
        seq = self.sequences[index // 2]
        return seq[::-1] if index % 2 else seq

    def _longest_overlap(self, seq1, edge1: bool, seq2, edge2: bool) -> int:
        """longestOverlap2 (hpp:2981-2986)."""
        kp = self.k_prev
        if seq1.shape[0] == kp and seq2.shape[0] == kp:
            return kp - 1
        if edge1 or edge2:
            return self.k - 1
        return kp - 1

    def _create_edge_node(self, minimizers: np.ndarray) -> FilterNode:
        """createEdgeNode (cpp:4911-5046)."""
        g = self.graph
        name = len(g.unitigs)
        node = FilterNode(name, minimizers.shape[0])
        node.is_edge_node = True
        g.unitigs.append(node)
        self.sequences.append(np.asarray(minimizers, np.uint32))
        ab = self._km_abundances([minimizers])[0] or 1
        node.abundances = np.array([ab], np.uint32)
        node.abundance = node.compute_median()
        return node

    def _add_successor(self, frm: int, to: int):
        node = self.graph.unitigs[frm // 2]
        (node.succ_rev if frm % 2 else node.succ_fwd).append(to)

    def _remove_successor(self, frm: int, to: int):
        node = self.graph.unitigs[frm // 2]
        lst = node.succ_rev if frm % 2 else node.succ_fwd
        lst[:] = [x for x in lst if x != to]

    # ------------------------------------------------------------------
    def _doublet(self, index: int, succ: int) -> np.ndarray:
        """Last prev-k window of the source + head of the successor."""
        kp = self.k_prev
        return np.concatenate([self._oriented_seq(index)[-kp:][:1],
                               self._oriented_seq(succ)[:kp]])

    def _solve_edges(self):
        g = self.graph
        kp = self.k_prev
        nodes = [n for n in g.unitigs
                 if n is not None and n.nb_minimizers != kp]
        # every doublet the walk can ask about joins two nodes of the
        # loaded graph (edge nodes are marked processed as they are made):
        # hash and look them all up in one launch
        self._km_abundances([
            self._doublet(index, succ) for node in nodes
            for index in (2 * node.name, 2 * node.name + 1)
            for succ in g.successors(index)
            if g.unitigs[succ // 2].nb_minimizers != kp])
        processed: set = set()
        for node in nodes:
            for index in (2 * node.name, 2 * node.name + 1):
                for succ in list(g.successors(index)):
                    if g.unitigs[succ // 2].nb_minimizers == kp:
                        continue
                    if succ // 2 in processed:
                        continue
                    doublet = self._doublet(index, succ)
                    if self._km_abundances([doublet])[0] >= 2:
                        edge_node = self._create_edge_node(doublet)
                        processed.add(edge_node.name)
                        eidx = 2 * edge_node.name
                        self._add_successor(index, eidx)
                        self._add_successor(rc(eidx), rc(index))
                        self._add_successor(eidx, succ)
                        self._add_successor(rc(succ), rc(eidx))
                    self._remove_successor(index, succ)
                    self._remove_successor(rc(succ), rc(index))
            processed.add(node.name)

    def _remove_unsupported(self):
        g = self.graph
        nodes = [n for n in g.unitigs if n is not None]
        h1, h2, offs = flat_window_hashes(
            [self.sequences[n.name] for n in nodes], self.k, self.device)
        _, hit = self.km.lookup(h1, h2, 0)
        csum = torch.zeros(hit.shape[0] + 1, dtype=torch.int64,
                           device=self.device)
        torch.cumsum((~hit).to(torch.int64), 0, out=csum[1:])
        misses = (csum[offs[1:]] - csum[offs[:-1]]).cpu().numpy()
        for i in np.flatnonzero(misses > 0).tolist():
            g.remove_node(nodes[i])

    def _solve_small_unitigs(self):
        g = self.graph
        kp = self.k_prev
        small = [n for n in g.unitigs
                 if n is not None and n.nb_minimizers == kp]
        # the triplets of the graph as it stands; the ones made later, with
        # edge nodes this loop creates, are hashed as they come
        self._km_abundances([t for node in small
                             for t in self._triplets(node)[1]])
        for node in small:
            self._solve_small_unitig(node)

    def _triplets(self, node: FilterNode):
        """(neighbours, triplets): every predecessor then every successor of
        a small unitig other than itself, each with the k-window joining it
        to the unitig (a minimizer of the neighbour on the joining side)."""
        g = self.graph
        index = 2 * node.name
        minimizers = self.sequences[node.name]
        out, trips = [], []
        for p in g.predecessors(index):
            if p == index:
                continue
            pmin = self._oriented_seq(p)
            ov = self._longest_overlap(pmin, g.unitigs[p // 2].is_edge_node,
                                       minimizers, node.is_edge_node)
            out.append((p, True))
            trips.append(np.concatenate(
                [pmin[pmin.shape[0] - ov - 1: pmin.shape[0] - ov],
                 minimizers]))
        for s in g.successors(index):
            if s == index:
                continue
            smin = self._oriented_seq(s)
            ov = self._longest_overlap(minimizers, node.is_edge_node,
                                       smin, g.unitigs[s // 2].is_edge_node)
            out.append((s, False))
            trips.append(np.concatenate([minimizers, smin[ov: ov + 1]]))
        return out, trips

    def _solve_small_unitig(self, node: FilterNode):
        """solveSmallUnitigsSub2 (cpp:4489-4752)."""
        g = self.graph
        index = 2 * node.name
        neighbours, trips = self._triplets(node)
        abs_ = self._km_abundances(trips)
        supported = [(x, is_pred, t) for (x, is_pred), t, a
                     in zip(neighbours, trips, abs_) if a]

        edge_nodes: dict = {}
        for p, is_pred, seq in supported:
            if not is_pred or (p, index) in edge_nodes:
                continue
            en = self._create_edge_node(seq)
            edge_nodes[(p, index)] = en
            eidx = 2 * en.name
            self._add_successor(p, eidx)
            self._add_successor(rc(eidx), rc(p))
        for s, is_pred, seq in supported:
            if is_pred or (index, s) in edge_nodes:
                continue
            en = self._create_edge_node(seq)
            edge_nodes[(index, s)] = en
            eidx = 2 * en.name
            self._add_successor(eidx, s)
            self._add_successor(rc(s), rc(eidx))

        for p, is_pred, _ in supported:
            enp = edge_nodes.get((p, index)) if is_pred else None
            if enp is None:
                continue
            for s, s_is_pred, _ in supported:
                if s_is_pred:
                    continue
                ens = edge_nodes.get((index, s))
                if ens is None:
                    continue
                self._add_successor(2 * enp.name, 2 * ens.name)
                self._add_successor(rc(2 * ens.name), rc(2 * enp.name))

        g.remove_node(node)

    # ------------------------------------------------------------------
    def _merged_sequence(self, node: FilterNode) -> np.ndarray:
        """unitigsToMinimizers over the (possibly reversed) merge list
        (hpp:3415-3513)."""
        unitigs = node.unitig_merge if node.unitig_merge else [2 * node.name]
        if node.is_reversed:
            unitigs = [rc(x) for x in unitigs[::-1]]
        out = None
        prev = None
        for idx in unitigs:
            m = self._oriented_seq(idx)
            if out is None:
                out = m
            else:
                if (prev.shape[0] == self.k and m.shape[0] == self.k
                        and np.array_equal(prev, m)):
                    ov = self.k
                else:
                    ov = self.k - 1
                out = np.concatenate([out, m[ov:]])
            prev = m
        return out

    def _write_unitigs(self):
        g = self.graph
        kp = self.k_prev

        # iterate live array: nodes merged away mid-loop are skipped (cpp:5163)
        for i in range(len(g.unitigs)):
            if g.unitigs[i] is not None:
                g.recompact_node(g.unitigs[i])
        for i in range(len(g.unitigs)):
            node = g.unitigs[i]
            if node is not None and not node.unitig_merge \
                    and node.nb_minimizers == kp:
                g.remove_node(node)

        new_name = {}
        for node in g.unitigs:
            if node is not None:
                new_name[node.name] = len(new_name)

        nb_nodes = 0
        merged = []
        with open(os.path.join(self.out_dir, "unitigGraph.nodes.bin"),
                  "wb") as f:
            for node in g.unitigs:
                if node is None:
                    continue
                seq = self._merged_sequence(node)
                merged.append(seq)
                f.write(struct.pack("<I", seq.shape[0]))
                f.write(seq.astype(np.uint32).tobytes())
                f.write(struct.pack("<I", 2 * new_name[node.name]))
                nb_nodes += 1

        # edges: BFS per component from forward orientation (cpp:5348-5505)
        nb_edges = 0
        visited: set = set()
        with open(os.path.join(self.out_dir,
                               "unitigGraph.edges.successors.bin"),
                  "wb") as f:
            for node in g.unitigs:
                if node is None or node.name in visited:
                    continue
                q = collections.deque([2 * node.name])
                while q:
                    index = q.popleft()
                    name = index // 2
                    if name in visited:
                        continue
                    visited.add(name)
                    succs = list(g.successors(index))
                    preds = g.predecessors(index)
                    new_index = 2 * new_name[name] + (index % 2)
                    succ2 = []
                    for s in succs:
                        q.append(s)
                        succ2.append(2 * new_name[s // 2] + (s % 2))
                    pred2 = []
                    for p in preds:
                        q.append(p)
                        pred2.append(rc(2 * new_name[p // 2] + (p % 2)))
                    f.write(struct.pack("<II", new_index, len(succ2)))
                    f.write(np.asarray(succ2, np.uint32).tobytes())
                    f.write(struct.pack("<I", len(pred2)))
                    f.write(np.asarray(pred2, np.uint32).tobytes())
                    nb_edges += len(succ2) + len(pred2)

        # abundances (cpp:5574-5657): one flat window-hash sweep over the
        # written sequences, one batched lookup, 1 where absent
        h1, h2, offs = flat_window_hashes(merged, self.k, self.device)
        ab, _ = self.km.lookup(h1, h2, 1)
        ab = ab.cpu().numpy().astype(np.uint32)
        offs = offs.cpu().numpy()
        with open(os.path.join(self.out_dir,
                               "unitigGraph.nodes.abundances.bin"),
                  "wb") as f:
            for i in range(len(merged)):
                a = ab[offs[i]:offs[i + 1]]
                f.write(struct.pack("<II", 2 * i, a.shape[0]))
                f.write(a.tobytes())

        gio.write_unitig_stats(os.path.join(self.out_dir,
                                            "unitigGraph.stats.bin"),
                               nb_nodes, nb_edges)


def run_graph_multiplex_pass(out_dir: str, k: int,
                             params: records.Parameters, device,
                             cache: ReadsCache | None = None):
    mp = MultiplexPass(out_dir, k, params, device, cache)
    mp.run()
    return mp
