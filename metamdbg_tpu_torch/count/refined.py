"""Refined abundances for the k -> k+1 re-count (second multi-k pass).

The port of metamdbg_tpu/count/refined.py, after
CreateMdbg::loadRefinedAbundances (src/graph/CreateMdbg.cpp:3401-3709) and
KminmerCounter::getRefinedAbundance (src/graph/CreateMdbg.hpp:3933-4005):

- start from the previous pass's solid abundances (hash128 -> count,
  abundance 1 entries skipped);
- per previous unitig with a refined (contig-level) abundance: all its
  constituent prev-k k-min-mers get the refined value (or 0 when refined==1,
  which marks them weak, and only where the key is already present);
- a new (k+1)-min-mer's abundance = min over its constituent prev-k
  k-min-mers; any miss or 0 constituent -> 1 (-> dropped as non-solid).

The JAX package builds the second pass's table with a Python dict and the
multiplex pass's with sorted arrays; both have the semantics of
`overlay_refined`, which the port uses for both.
"""

import numpy as np
import torch

from ..kernels import window_hash
from .kminmers import PairTable, flat_window_hashes, pair_heads, sort_pairs


def overlay_refined(base_h1, base_h2, base_v, ov_h1, ov_h2, ov_ab):
    """The table loadRefinedAbundances builds, vectorized: the base entries,
    then each overlay entry in order. An overlay value != 1 sets the key
    (inserting it if absent); a value of 1 sets it to 0 only if the key is
    already present. Last wins, so a zeroer fires iff it comes after the
    key's last setter. Returns a PairTable of int64 values."""
    h1 = torch.cat([base_h1, ov_h1])
    h2 = torch.cat([base_h2, ov_h2])
    val = torch.cat([base_v, ov_ab])
    is_setter = val != 1
    is_setter[:base_h1.shape[0]] = True
    # insertion order is array order: a stable sort keeps it inside a key
    order = sort_pairs(h1, h2)
    h1, h2, val, is_setter = h1[order], h2[order], val[order], is_setter[order]
    t = h1.shape[0]
    if t == 0:
        return PairTable(h1, h2, val, presorted=True)
    head = pair_heads(h1, h2)
    gid = torch.cumsum(head.to(torch.int64), 0) - 1
    pos = torch.arange(t, dtype=torch.int64, device=h1.device)
    n_groups = int(gid[-1]) + 1
    neg = torch.full((n_groups,), -1, dtype=torch.int64, device=h1.device)
    last_set = neg.clone().scatter_reduce_(
        0, gid, torch.where(is_setter, pos, -1), "amax")
    last_zero = neg.clone().scatter_reduce_(
        0, gid, torch.where(is_setter, -1, pos), "amax")
    present = last_set >= 0
    value = torch.where(last_zero > last_set, 0, val[last_set.clamp(min=0)])
    heads = torch.nonzero(head).flatten()[present]
    return PairTable(h1[heads], h2[heads], value[present], presorted=True)


class RefinedAbundanceIndex:
    """hash128 -> abundance lookup backed by a sorted PairTable."""

    def __init__(self, table: PairTable):
        self.table = table

    @classmethod
    def build(cls, prev_abundance_keys, prev_abundance_counts,
              prev_unitig_nodes, refined_abundances: dict, k_prev: int,
              device):
        """prev_abundance_*: (N,2) u64 keys and u32 counts from
        kminmerData_abundance_prev.txt; prev_unitig_nodes: list of
        (seq, unitigIndex) from unitigGraph_prev.nodes.bin;
        refined_abundances: unitigName -> u32."""
        keep = prev_abundance_counts != 1
        keys = torch.from_numpy(
            np.ascontiguousarray(prev_abundance_keys[keep]).view(np.int64)
            .reshape(-1, 2)).to(device)
        base_v = torch.from_numpy(
            prev_abundance_counts[keep].astype(np.int64)).to(device)
        nodes = [(seq, idx // 2) for seq, idx in prev_unitig_nodes
                 if idx // 2 in refined_abundances]
        ov_h1, ov_h2, ov_off = flat_window_hashes([s for s, _ in nodes],
                                                  k_prev, device)
        ab = torch.tensor([refined_abundances[name] for _, name in nodes],
                          dtype=torch.int64, device=device)
        ov_ab = torch.repeat_interleave(ab, ov_off[1:] - ov_off[:-1],
                                        output_size=ov_h1.shape[0])
        return cls(overlay_refined(keys[:, 0], keys[:, 1], base_v,
                                   ov_h1, ov_h2, ov_ab))

    def lookup(self, h1, h2):
        """(values, found) for query pairs."""
        return self.table.lookup(h1, h2, 0)

    def refined_abundance_rows(self, rows: torch.Tensor, k_prev: int):
        """getRefinedAbundance for each (N, k) row: min over constituent
        prev-k normalized windows; miss or 0 -> 1."""
        n, k = rows.shape
        nw = k - k_prev + 1
        dev = rows.device
        starts = (torch.arange(n, device=dev)[:, None] * k
                  + torch.arange(nw, device=dev)).reshape(-1)
        h1, h2 = window_hash.hash_windows(rows.contiguous().view(-1), starts,
                                          k_prev, normalize=True)
        vals, found = self.lookup(h1, h2)
        vals, found = vals.reshape(n, nw), found.reshape(n, nw)
        bad = (~found | (vals == 0)).any(dim=1)
        return torch.where(bad, 1, vals.min(dim=1).values)
