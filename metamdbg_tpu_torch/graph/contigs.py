"""Stage `contig` + `toMinspace`: simplification -> contigs.nodepath ->
minimizer-space sequences.

The port of metamdbg_tpu/graph/contigs.py: host code over the on-disk
graph, as in the JAX package. Mirrors
src/assembly/GenerateContigs.hpp:264-830 and
src/toBasespace/ToMinspace.hpp:148-632.
"""

import os
import shutil
import struct

import numpy as np

from ..io import records
from . import gio
from .filter_graph import FilterGraph, FilterNode
from .simplify import ProgressiveAbundanceFilter

F32 = np.float32


def load_filter_graph(out_dir: str, params: records.Parameters) -> FilterGraph:
    """UnitigGraph2::load (src/graph/Graph.hpp:420-900) from gio files."""
    fg = FilterGraph(params.kminmer_size, params.minimizer_spacing_mean,
                     params.kminmer_length_mean)
    nodes = gio.read_unitig_nodes(os.path.join(out_dir, "unitigGraph.nodes.bin"))
    n = len(nodes)
    fg.unitigs = [None] * n
    for seq, idx in nodes:
        node = FilterNode(idx // 2, seq.shape[0])
        fg.unitigs[idx // 2] = node
    for idx, ab in gio.read_unitig_abundances(
            os.path.join(out_dir, "unitigGraph.nodes.abundances.bin")):
        node = fg.unitigs[idx // 2]
        node.abundances = np.sort(np.asarray(ab, np.uint32))
        node.abundance = node.compute_median()
        if node.abundance == 0:
            node.abundance = F32(1.0)
    edges = gio.read_unitig_edges(
        os.path.join(out_dir, "unitigGraph.edges.successors.bin"))
    for oriented, succ in edges.items():
        node = fg.unitigs[oriented // 2]
        if oriented % 2:
            node.succ_rev = sorted(succ.tolist())
        else:
            node.succ_fwd = sorted(succ.tolist())
    return fg


def run_contig_stage(out_dir: str, params: records.Parameters,
                     max_bubble_length: int = 50000, max_tip_length: int = 50000,
                     gen_graph: bool = False):
    """`metaMDBG contig` (non-final): filter + contigs.nodepath + refined
    abundances + multiplex backups."""
    os.makedirs(os.path.join(out_dir, "filter"), exist_ok=True)
    fg = load_filter_graph(out_dir, params)
    paf = ProgressiveAbundanceFilter(fg, out_dir, max_bubble_length,
                                     max_tip_length, gen_graph=gen_graph)
    paf.execute()
    node_abundances = generate_contigs(out_dir, paf, params)
    dump_refined_abundances(out_dir, params, node_abundances)
    return paf


def generate_contigs(out_dir: str, paf: ProgressiveAbundanceFilter,
                     params: records.Parameters):
    """generateContigs3 (GenerateContigs.hpp:549-757)."""
    k = params.kminmer_size
    processed: set = set()
    node_abundances: dict = {}
    with open(os.path.join(out_dir, "contigs.nodepath"), "wb") as out:
        for i in range(len(paf.cutoff_values) - 1, -1, -1):
            cutoff = paf.cutoff_values[i]
            min_ab = F32(F32(cutoff) / F32(0.5))
            path = os.path.join(out_dir, "filter", f"unitigs_{i}.bin")
            for rec in _read_filter_records(path):
                size, is_circ, is_repeat, ab, nb_min, node_path = rec
                if F32(ab) < min_ab:
                    continue
                if any((x // 2) in processed for x in node_path):
                    continue
                if is_circ and nb_min - k + 1 > 1:
                    nb_min += 1
                out.write(struct.pack("<IB", node_path.shape[0], is_circ))
                out.write(node_path.tobytes())
                for x in node_path.tolist():
                    processed.add(x // 2)
                    node_abundances[x // 2] = (float(ab), int(nb_min))
    return node_abundances


def _read_filter_records(path: str):
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        size, is_circ, is_repeat = struct.unpack_from("<IBB", data, off)
        off += 6
        ab, nb_min = struct.unpack_from("<fI", data, off)
        off += 8
        node_path = np.frombuffer(data, np.uint32, size, off)
        off += 4 * size
        yield size, is_circ, is_repeat, ab, nb_min, node_path


def dump_refined_abundances(out_dir: str, params: records.Parameters,
                            node_abundances: dict):
    """GenerateContigs::dumpUnitigAbundances (hpp:759-808). Reference writes
    in unordered_map order; we write sorted by name (set semantics)."""
    k = params.kminmer_size
    with open(os.path.join(out_dir, "unitigGraph.nodes.refined_abundances.bin"),
              "wb") as f:
        for name in sorted(node_abundances):
            ab, nb_nodes = node_abundances[name]
            abundance = int(np.ceil(ab))
            if nb_nodes - k + 1 > k:
                abundance = max(abundance, 2)
            f.write(struct.pack("<II", name, abundance))

    cp = shutil.copyfile
    cp(os.path.join(out_dir, "unitigGraph.nodes.bin"),
       os.path.join(out_dir, "unitigGraph_prev.nodes.bin"))
    cp(os.path.join(out_dir, "kminmerData_abundance.txt"),
       os.path.join(out_dir, "kminmerData_abundance_prev.txt"))
    if params.kminmer_size > params.kminmer_size_first:
        for name in ("unitigGraph.edges.successors.bin",
                     "unitigGraph.nodes.abundances.bin",
                     "unitigGraph.stats.bin"):
            cp(os.path.join(out_dir, name),
               os.path.join(out_dir, name.replace("unitigGraph", "unitigGraph_prev")))
    if params.kminmer_size == 21:
        d = os.path.join(out_dir, "contigGraph")
        os.makedirs(d, exist_ok=True)
        for name in ("parameters.gz", "unitigGraph.nodes.bin",
                     "unitigGraph.edges.successors.bin",
                     "unitigGraph.nodes.abundances.bin", "unitigGraph.stats.bin"):
            cp(os.path.join(out_dir, name), os.path.join(d, name))


# ---------------------------------------------------------------------------
# toMinspace
# ---------------------------------------------------------------------------

def run_to_minspace(out_dir: str, nodepath_file: str, output_file: str,
                    nodes_file: str, params: records.Parameters):
    """`metaMDBG toMinspace` (ToMinspace.hpp:148-632): expand unitig index
    paths into flat minimizer sequences."""
    k = params.kminmer_size
    seqs: dict = {}
    for seq, idx in gio.read_unitig_nodes(nodes_file):
        seqs[idx // 2] = np.asarray(seq, np.uint32)

    with open(nodepath_file, "rb") as f:
        data = f.read()
    out = open(output_file, "wb")
    off = 0
    while off < len(data):
        (size,) = struct.unpack_from("<I", data, off)
        off += 4
        is_circ = data[off]
        off += 1
        node_path = np.frombuffer(data, np.uint32, size, off)
        off += 4 * size

        minimizers = _expand_path(node_path, seqs, k)
        if is_circ and minimizers.shape[0] > k:
            minimizers = np.append(minimizers, minimizers[k - 1])
        out.write(struct.pack("<IB", minimizers.shape[0], is_circ))
        out.write(minimizers.astype(np.uint32).tobytes())
    out.close()

    # snapshot for RepeatRemover (ToMinspace.hpp:181-185)
    if params.kminmer_size == params.kminmer_size_first + 1:
        shutil.copyfile(output_file,
                        output_file + f".init.k{params.kminmer_size}")


def _expand_path(node_path: np.ndarray, seqs: dict, k: int) -> np.ndarray:
    """unitigSequenceToMinimizerSequence (ToMinspace.hpp:418-632): k-1 overlap,
    except identical k-length unitigs overlap fully (longestOverlap2)."""
    parts = []
    prev = None
    for idx in node_path.tolist():
        m = seqs[idx // 2]
        if idx % 2:
            m = m[::-1]
        if prev is None:
            parts.append(m)
        else:
            if (prev.shape[0] == k and m.shape[0] == k
                    and np.array_equal(prev, m)):
                overlap = k
            else:
                overlap = k - 1
            parts.append(m[overlap:])
        prev = m
    if not parts:
        return np.zeros(0, np.uint32)
    return np.concatenate(parts)
