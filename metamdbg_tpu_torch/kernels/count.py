"""Kernel K2: row counting, as torch ops on the tensor's device.

The port of metamdbg_tpu/kernels/count_jax.py (`_sort_rows`,
`count_unique_rows_device`) and of count/kminmers._count_unique_rows_host:
the lexicographic sort of an (N, k) table of u32 values (first column most
significant) and its head-of-run mask, which give the unique rows and
their counts. The JAX function is XLA with no Pallas, so torch's sort is
its port: stable sort passes, least-significant key first, with two u32
columns packed into one int64 key per pass. A packed key can reach the
int64 sign bit, so its sign bit is flipped before the sort, which makes the
signed order of the keys their unsigned order.

Rows are int64 tensors holding u32 values (CPU torch has no unsigned
compares). `launches` counts the calls of count_unique_rows on the card
(each a few sorts, gathers and a scan); the CPU counts nothing.
"""

import torch

SIGN = -(1 << 63)
launches = 0


def reset_counts():
    global launches
    launches = 0


def sort_rows_lex(rows: torch.Tensor) -> torch.Tensor:
    """Indices sorting the rows lexicographically, ties in input order
    (the order of np.lexsort over the columns)."""
    n, k = rows.shape
    order = torch.arange(n, dtype=torch.int64, device=rows.device)
    j = k - 1
    while j >= 0:
        if j >= 1:
            key = ((rows[:, j - 1] << 32) | rows[:, j]) ^ SIGN
        else:
            key = rows[:, 0]
        perm = torch.sort(key[order], stable=True).indices
        order = order[perm]
        j -= 2
    return order


def row_heads(s: torch.Tensor) -> torch.Tensor:
    """Head-of-run mask of a sorted row table."""
    head = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    head[1:] = (s[1:] != s[:-1]).any(dim=1)
    return head


def count_unique_rows(rows: torch.Tensor):
    """Group identical rows: (unique rows in lexicographic order, int64
    counts)."""
    global launches
    launches += rows.device.type == "cuda"
    n = rows.shape[0]
    if n == 0:
        return rows, torch.zeros(0, dtype=torch.int64, device=rows.device)
    s = rows[sort_rows_lex(rows)]
    starts = torch.nonzero(row_heads(s)).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([n])])
    return s[starts], ends - starts
