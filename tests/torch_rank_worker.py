"""One rank of a torch.distributed run of the port's sharded functions, on
the CPU over gloo, for tests/test_torch_parallel.py (in the manner of
tests/multihost_worker.py).

    python tests/torch_rank_worker.py CASES.pkl OUT_DIR

with METAMDBG_TPU_DISTRIBUTED=1 and METAMDBG_TPU_COORDINATOR /
NUM_PROCESSES / PROCESS_ID set. CASES.pkl holds plain numpy inputs; the
rank runs every case through the port (K5's count_table, K6's pair_join,
the first pass and the correction mapper with the group, the POA fan-out)
and writes its results to OUT_DIR/rank<R>.pkl. The JAX package and jax are
refused in this process, and `os.fork` raises.
"""

import importlib.abc
import os
import pickle
import sys


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "metamdbg_tpu"):
            raise ImportError(name + " is refused in a rank worker")
        return None


def _no_fork():
    raise RuntimeError("a rank worker forked")


def _u64(t):
    return t.numpy().view("uint64")


def main(cases_path, out_dir):
    import datetime

    import numpy as np
    import torch

    from metamdbg_tpu_torch import parallel
    from metamdbg_tpu_torch.correction import mapper
    from metamdbg_tpu_torch.graph import stage
    from metamdbg_tpu_torch.io import records
    from metamdbg_tpu_torch.parallel import count_table, pair_join
    from metamdbg_tpu_torch.parallel import polish_mesh

    # a collective that one rank never enters fails the test in a minute
    parallel.TIMEOUT = datetime.timedelta(seconds=60)
    # the ranks share the host's cores: one thread each, no pools spinning
    torch.set_num_threads(1)
    cpu = parallel.ensure_distributed("cpu")
    group = parallel.production_group()
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    rank = parallel.describe()["rank"]
    res = {"describe": parallel.describe(), "grouped": group is not None,
           "k5": {}, "k6": {}, "first_pass": {}, "mapper": {}, "polish": {}}

    for name, (reads, k) in cases["k5"].items():
        h1, h2, counts = count_table.count_table(
            [np.asarray(r, np.uint32) for r in reads], k, cpu, group)
        res["k5"][name] = (np.stack([_u64(h1), _u64(h2)], 1),
                           counts.numpy())
    for name, (tbl, queries) in cases["k6"].items():
        counts, matches = pair_join.pair_join(
            torch.from_numpy(tbl.view(np.int64)),
            torch.from_numpy(queries.view(np.int64)), group)
        res["k6"][name] = (counts.numpy(), matches.numpy())
    for name, (reads, k) in cases["first_pass"].items():
        d = os.path.join(out_dir, f"first_pass_{name}_rank{rank}")
        os.makedirs(d)
        stage.run_graph_first_pass(d, k, 0, cpu, reads=reads, group=group)
        res["first_pass"][name] = {
            n: open(os.path.join(d, n), "rb").read()
            for n in cases["first_pass_artifacts"]}
    for name, (reads, chunk, band) in cases["mapper"].items():
        path = os.path.join(out_dir, f"mapper_{name}_rank{rank}.bin")
        mapper.run_read_mapper(
            [records.MinimizerRead(i, m, p, d, None)
             for i, (m, p, d) in enumerate(reads)], chunk, band, cpu,
            alignment_path=path, group=group)
        res["mapper"][name] = open(path, "rb").read()
    for name, batch in cases["polish"].items():
        res["polish"][name] = polish_mesh.polish_windows_distributed(
            batch, n_threads=1, group=group)
    res["activity"] = parallel.activity
    parallel.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"),
              "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    sys.meta_path.insert(0, _Refuse())
    os.fork = _no_fork
    main(sys.argv[1], sys.argv[2])
