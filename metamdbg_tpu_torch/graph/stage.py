"""Stage `graph`, first and second pass: minimizer reads -> counted
k-min-mers -> compacted unitig graph, mirroring `metaMDBG graph`
(src/graph/CreateMdbg.cpp:168-598).

The port of metamdbg_tpu/graph/stage.py; its mesh argument is a group of
ranks here (`group`, parallel/__init__.py). Counting, hashing and lookups
run on `device`; the artifacts are the JAX package's, byte for byte.
"""

import os
import shutil
import struct

from ..count import refined as refined_mod
from ..count.kminmers import batch_extract_kminmers, count_kminmers, \
    count_kminmers_sharded, count_unique_rows
from ..io import records
from . import gio, mdbg


def load_minimizer_reads(path: str):
    """Minimizer arrays from a read_data_corrected.txt-format file."""
    return [r.minimizers
            for r in records.read_read_data(path, with_quality=False)]


def _write_graph(out_dir: str, graph: mdbg.UnitigGraph):
    gio.write_unitig_nodes(os.path.join(out_dir, "unitigGraph.nodes.bin"),
                           graph.sequences)
    gio.write_unitig_edges(
        os.path.join(out_dir, "unitigGraph.edges.successors.bin"),
        graph.successors)
    gio.write_unitig_abundances(
        os.path.join(out_dir, "unitigGraph.nodes.abundances.bin"),
        graph.abundances)
    gio.write_unitig_stats(os.path.join(out_dir, "unitigGraph.stats.bin"),
                           graph.n_unitigs, graph.n_edges())
    os.makedirs(os.path.join(out_dir, "smallContigs"), exist_ok=True)


def _write_kminmers(out_dir: str, rows, counts, init_name: str):
    gio.write_kminmer_rows(os.path.join(out_dir, "kminmerData_min.txt"), rows)
    path = os.path.join(out_dir, "kminmerData_abundance.txt")
    gio.write_kminmer_abundances(path, rows, counts)
    shutil.copyfile(path, os.path.join(out_dir, init_name))


def run_graph_second_pass(out_dir: str, k: int, params: records.Parameters,
                          device):
    """`metaMDBG graph` at k == firstK+1 (src/graph/CreateMdbg.cpp:386-416):
    full re-count over reads + previous contigs with refined abundances;
    no rescue."""
    reads = load_minimizer_reads(os.path.join(out_dir,
                                              "read_data_corrected.txt"))
    contigs = load_minimizer_reads(os.path.join(out_dir, "unitig_data.txt"))

    prev_keys, prev_counts = gio.read_kminmer_abundances(
        os.path.join(out_dir, "kminmerData_abundance_prev.txt"))
    prev_nodes = gio.read_unitig_nodes(
        os.path.join(out_dir, "unitigGraph_prev.nodes.bin"))
    with open(os.path.join(out_dir,
                           "unitigGraph.nodes.refined_abundances.bin"),
              "rb") as f:
        refined_abundances = dict(struct.iter_unpack("<II", f.read()))
    index = refined_mod.RefinedAbundanceIndex.build(
        prev_keys, prev_counts, prev_nodes, refined_abundances, k - 1,
        device)

    rows, _, _, _ = batch_extract_kminmers(reads + contigs, k, device)
    uniq, _ = count_unique_rows(rows)
    abundances = index.refined_abundance_rows(uniq, k - 1)
    solid = abundances > 1
    all_rows, all_counts = uniq[solid], abundances[solid]

    _write_kminmers(out_dir, all_rows, all_counts,
                    f"kminmerData_abundance_init_k{k}.txt")
    graph = mdbg.build_unitig_graph(all_rows, k)
    mdbg.compute_unitig_abundances(graph, all_rows, all_counts)
    _write_graph(out_dir, graph)
    open(os.path.join(out_dir, "smallContigs", f"smallContigs_k{k}.bin"),
         "wb").close()
    return graph


def run_graph_first_pass(out_dir: str, k: int, min_abundance: int, device,
                         reads=None, group=None):
    """Returns the UnitigGraph; writes all stage artifacts into out_dir.

    With `group` (two or more ranks, parallel.production_group()), the
    count runs through the sharded count table (K5); the artifacts are the
    one-rank path's, byte for byte."""
    if reads is None:
        reads = load_minimizer_reads(os.path.join(out_dir,
                                                  "read_data_corrected.txt"))
    if group is not None:
        counts = count_kminmers_sharded(group, reads, k, device,
                                        min_abundance)
    else:
        counts = count_kminmers(reads, k, device, min_abundance)
    _write_kminmers(out_dir, counts["all_rows"], counts["all_counts"],
                    "kminmerData_abundance_init.txt")
    graph = mdbg.build_unitig_graph(counts["all_rows"], k)
    mdbg.compute_unitig_abundances(graph, counts["solid_rows"],
                                   counts["solid_counts"])
    _write_graph(out_dir, graph)
    open(os.path.join(out_dir, "smallContigs", f"smallContigs_k{k}.bin"),
         "wb").close()
    return graph
