"""MDBG construction: k-min-mer nodes -> compacted unitig graph.

The port of metamdbg_tpu/graph/mdbg.py (method there, after
src/graph/CreateMdbg.cpp:1178-3287). The tables live on the nodes' device:
the raw (k-1)-overlap keys are hashed by kernel KW, and the sort-merge
join, the degrees and the chain pointers are torch ops. The walks that
spell unitigs out of the chain pointers stay host Python, as in the JAX
package, because they chase pointers.

- adjacency: successor(x) = all y with seq(x)[1:] == seq(y)[:-1], over the
  2N oriented k-min-mers, joined on 128-bit hashes of the raw overlaps;
- unitig compaction via chain pointers (outdeg(x)==1 and indeg(next)==1);
- circular unitigs anchored at the member with the smallest normalized
  hash128, read in that member's normalized orientation;
- deterministic renaming: normalized unitig sequences sorted by hash128;
- unitig-level edges: successors(t) = oriented unitigs s with
  first(s)[:-1] == last(t)[1:], excluding the hairpin s == rc(t).
"""

import dataclasses

import numpy as np
import torch

from ..count.kminmers import PairTable, flat_window_hashes, pair_heads, \
    sort_pairs, stream
from ..kernels import window_hash
from ..kernels.window_hash import hash_rows


def _join(keys_a, keys_b):
    """All pairs (i, j) with keys_a[i] == keys_b[j], each keys a (h1, h2)
    pair of tensors. Pairs come in the JAX package's order: by key in
    unsigned order, then for each i ascending, every j ascending."""
    (a1, a2), (b1, b2) = keys_a, keys_b
    na, nb = a1.shape[0], b1.shape[0]
    dev = a1.device
    if na == 0 or nb == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),) * 2
    h1, h2 = torch.cat([a1, b1]), torch.cat([a2, b2])
    is_b = torch.arange(na + nb, device=dev) >= na
    idx = torch.cat([torch.arange(na, device=dev),
                     torch.arange(nb, device=dev)])
    # a's before b's and indices ascending already: a stable sort by key
    # keeps that order inside each key
    order = sort_pairs(h1, h2)
    h1, h2, is_b, idx = h1[order], h2[order], is_b[order], idx[order]
    head = pair_heads(h1, h2)
    gid = torch.cumsum(head.to(torch.int64), 0) - 1
    n_groups = int(gid[-1]) + 1
    cb = torch.zeros(n_groups, dtype=torch.int64, device=dev).index_add_(
        0, gid, is_b.to(torch.int64))
    starts = torch.nonzero(head).flatten()
    ca = torch.diff(torch.cat([starts, starts.new_tensor([na + nb])])) - cb
    pairs = ca * cb
    total = int(pairs.sum())
    g = torch.repeat_interleave(torch.arange(n_groups, device=dev), pairs,
                                output_size=total)
    local = torch.arange(total, device=dev) - (torch.cumsum(pairs, 0)
                                               - pairs)[g]
    ia = local // cb[g]
    ib = local % cb[g]
    return idx[starts[g] + ia], idx[starts[g] + ca[g] + ib]


@dataclasses.dataclass
class UnitigGraph:
    """Compacted unitig graph in array form.

    unitig u (0..U-1) has oriented indices 2u (forward) / 2u+1 (reverse).
    sequences[u] is the deterministic normalized minimizer sequence (host
    u32 array).
    """
    k: int
    sequences: list                  # U arrays of u32 minimizers
    successors: list                 # 2U lists of oriented indices
    abundances: list | None = None   # U arrays of per-kminmer abundance

    @property
    def n_unitigs(self):
        return len(self.sequences)

    def n_edges(self):
        return sum(len(s) for s in self.successors)


def build_unitig_graph(nodes: torch.Tensor, k: int) -> UnitigGraph:
    """nodes: (N, k) normalized unique k-min-mers (int64 u32 values)."""
    n = nodes.shape[0]
    if n == 0:
        return UnitigGraph(k, [], [])
    dev = nodes.device
    # oriented node x in [0, 2n): seq(2i)=nodes[i], seq(2i+1)=reversed
    oriented = torch.stack([nodes, nodes.flip(1)], dim=1).reshape(2 * n, k)
    src, dst = _join(hash_rows(oriented, 1),          # seq[1:]
                     hash_rows(oriented, 0, k - 1))   # seq[:-1]

    outdeg = torch.bincount(src, minlength=2 * n)
    indeg = torch.bincount(dst, minlength=2 * n)
    # chain pointer: x -> y iff outdeg[x]==1 and indeg[y]==1
    nxt = torch.full((2 * n,), -1, dtype=torch.int64, device=dev)
    single_out = outdeg[src] == 1
    cand, cand_dst = src[single_out], dst[single_out]
    ok = indeg[cand_dst] == 1
    nxt[cand[ok]] = cand_dst[ok]
    prv = torch.full_like(nxt, -1)
    linked = torch.nonzero(nxt >= 0).flatten()
    prv[nxt[linked]] = linked

    sequences = _extract_unitigs(oriented.cpu().numpy().astype(np.uint32),
                                 nxt.cpu().numpy(), prv.cpu().numpy(), k, dev)
    sequences = _deterministic_order(sequences, dev)
    successors = _unitig_edges(sequences, k, dev)
    return UnitigGraph(k, sequences, successors)


def _is_reversed(seq: np.ndarray) -> bool:
    """Whether KmerVec::normalize takes the reverse of a host sequence (a
    palindrome takes it)."""
    rev = seq[::-1]
    neq = np.flatnonzero(seq != rev)
    return not (neq.shape[0] and seq[neq[0]] < rev[neq[0]])


def _normalize_seq(seq: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(seq[::-1]) if _is_reversed(seq) else seq


def _extract_unitigs(oriented: np.ndarray, nxt: np.ndarray, prv: np.ndarray,
                     k: int, device) -> list:
    """Maximal chain paths + cycles -> unitig minimizer sequences (both
    orientations produced, deduplicated by normalized form)."""
    n2 = oriented.shape[0]
    visited = np.zeros(n2, bool)
    sequences = {}

    def add_sequence(seq: np.ndarray):
        norm = _normalize_seq(seq)
        sequences[norm.tobytes()] = norm

    def spell(path):
        if len(path) == 1:
            return oriented[path[0]].copy()
        return np.concatenate([oriented[path[0]], oriented[path[1:], -1]])

    # linear paths: start at nodes with no chain-predecessor
    for s in np.flatnonzero(prv < 0).tolist():
        path = [s]
        visited[s] = True
        x = s
        while nxt[x] >= 0:
            x = nxt[x]
            if x == s or visited[x]:
                break  # safety (shouldn't happen for linear)
            path.append(x)
            visited[x] = True
        add_sequence(spell(path))

    # cycles: remaining unvisited nodes with nxt pointers, spelled in one
    # batch and added in the order they are found
    found = []  # a spelled degenerate chain, or a cycle's node list
    for s in np.flatnonzero(~visited).tolist():
        if visited[s]:
            continue
        cycle = [s]
        visited[s] = True
        x = nxt[s]
        while x != s and x >= 0 and not visited[x]:
            cycle.append(x)
            visited[x] = True
            x = nxt[x]
        # x != s: degenerate (hairpin chain)
        found.append(spell(cycle) if x != s else cycle)
    canonical = iter(_canonical_cycles(
        oriented, [c for c in found if isinstance(c, list)], k, device))
    for c in found:
        add_sequence(next(canonical) if isinstance(c, list) else c)

    return list(sequences.values())


def _canonical_cycles(oriented: np.ndarray, cycles: list, k: int,
                      device) -> list:
    """Rotate/orient each circular unitig per computeUnitigNode2
    (src/graph/CreateMdbg.hpp:2733-2795): anchor at the member k-min-mer with
    the smallest normalized hash128, oriented so the anchor reads in its
    normalized form; spelled as anchor + subsequent last-minimizers. One KW
    launch hashes every cycle's members, and a second the reversed walks of
    the cycles whose anchor reads reversed."""
    if not cycles:
        return []
    members = [oriented[c] for c in cycles]        # (C, k) walk orientation
    h1, h2, _ = flat_window_hashes(
        [row for m in members for row in m], k, device)
    h1 = h1.cpu().numpy().view(np.uint64)
    h2 = h2.cpu().numpy().view(np.uint64)
    starts = np.concatenate([[0], np.cumsum([len(c) for c in cycles])])
    best, flip = [], []
    for i, m in enumerate(members):
        lo, hi = starts[i], starts[i + 1]
        # the smallest pair, the first of equal ones (a stable order)
        b = int(np.lexsort((h2[lo:hi], h1[lo:hi]))[0])
        best.append(b)
        if _is_reversed(m[b]):
            # the anchor reads reversed: walk the reversed orientation and
            # find the anchor again (same normalized hash)
            flip.append((i, h1[lo + b], h2[lo + b]))
            members[i] = np.ascontiguousarray(m[::-1, ::-1])
    if flip:
        g1, g2, _ = flat_window_hashes(
            [row for i, _, _ in flip for row in members[i]], k, device)
        g1 = g1.cpu().numpy().view(np.uint64)
        g2 = g2.cpu().numpy().view(np.uint64)
        at = 0
        for i, a1, a2 in flip:
            n = members[i].shape[0]
            best[i] = int(np.flatnonzero((g1[at:at + n] == a1)
                                         & (g2[at:at + n] == a2))[0])
            at += n
    out = []
    for m, b in zip(members, best):
        rolled = np.roll(m, -b, axis=0)
        out.append(np.concatenate([rolled[0], rolled[1:, -1]]))
    return out


def _deterministic_order(sequences: list, device) -> list:
    """Sort normalized unitig sequences by hash128 ascending
    (computeDeterministicUnitigs, src/graph/CreateMdbg.cpp:1038-1049): one KW
    launch with one width per sequence."""
    if not sequences:
        return sequences
    cat, lens = stream(sequences, device)
    starts = torch.cumsum(lens, 0) - lens
    h1, h2 = window_hash.hash_windows(cat, starts, lens, normalize=False)
    return [sequences[i] for i in sort_pairs(h1, h2).tolist()]


def _unitig_edges(sequences: list, k: int, device) -> list:
    """successors[t] for all 2U oriented unitigs; t=2u forward, 2u+1 reversed.

    Edge t -> s iff last(t)[1:] == first(s)[:-1]; hairpin s == rc(t) excluded
    (the two skip rules in getSuccessors_unitig, CreateMdbg.cpp:2499,2512).
    """
    u = len(sequences)
    successors = [[] for _ in range(2 * u)]
    if u == 0:
        return successors
    cat, lens = stream(sequences, device)
    ar = torch.arange(k, device=device)
    seq_off = torch.cumsum(lens, 0) - lens
    heads = cat[seq_off[:, None] + ar]                 # seq[:k]
    tails = cat[(seq_off + lens - k)[:, None] + ar]    # seq[-k:]
    firsts = torch.stack([heads, tails.flip(1)], dim=1).reshape(2 * u, k)
    lasts = torch.stack([tails, heads.flip(1)], dim=1).reshape(2 * u, k)
    src, dst = _join(hash_rows(lasts, 1), hash_rows(firsts, 0, k - 1))
    keep = dst != (src ^ 1)  # exclude t -> rc(t)
    for s, d in zip(src[keep].tolist(), dst[keep].tolist()):
        successors[s].append(d)
    return successors


def compute_unitig_abundances(graph: UnitigGraph, solid_rows: torch.Tensor,
                              solid_counts: torch.Tensor):
    """Per-kminmer abundance vectors (dumpUnitigAbundances,
    src/graph/CreateMdbg.cpp:3289-3399): solid lookup else 1, one batched
    lookup over every unitig's windows."""
    dev = solid_rows.device
    h1, h2, offsets = flat_window_hashes(graph.sequences, graph.k, dev)
    table = PairTable(*hash_rows(solid_rows), solid_counts)
    vals, _ = table.lookup(h1, h2, 1)
    vals = vals.cpu().numpy().astype(np.uint32)
    offsets = offsets.cpu().numpy()
    graph.abundances = [vals[offsets[i]:offsets[i + 1]]
                        for i in range(len(graph.sequences))]
    return graph.abundances
