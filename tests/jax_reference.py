"""The JAX package's stages as the reference for chip_smoke.py, run host-only
(METAMDBG_TPU_HOST_ONLY=1) with every `jax` and `jaxlib` import refused, so
that they run on a machine that has no JAX. chip_smoke.py runs this file in
a subprocess and compares what it writes with the port's artifacts; the
port's own process never imports `metamdbg_tpu`.

    python tests/jax_reference.py read_selection READS OUT_DIR
    python tests/jax_reference.py graph WORK PARAMS_DIR FIRST_K LAST_K
    python tests/jax_reference.py basespace WORK READS OUT_FASTA
    python tests/jax_reference.py correction READS OUT_DIR
    python tests/jax_reference.py gfa OUT_DIR K REFERENCE...

- `read_selection`: read selection (HiFi, the asm defaults) into OUT_DIR.
- `graph`: the minimizer-space stages pass by pass in WORK, which holds
  read_data_corrected.txt, with PARAMS_DIR/k<k>.gz as each pass's
  parameters, in the order of pipeline/asm.py; prints one JSON object, the
  sha256 of each pass's artifacts (chip_smoke.pass_digests) by k.
- `basespace`: post-processing (derepSmall, removeOverlaps, removeRepeats)
  and toBasespace on WORK, a tmp dir as the last pass left it, with the
  last pass's WORK/parameters.gz, on one thread (the JAX package's fork
  workers hang after OpenMP has started, ROADMAP.md Queue 3); writes
  OUT_FASTA.
- `correction`: ONT read selection (correction not skipped) into OUT_DIR,
  then read correction on one thread with the parameters the asm gives it
  (pipeline/asm.py:make_params at the first k); prints one JSON object,
  {"checksum": the correction checksum}.
- `gfa`: the `gfa` and `map` subcommands on OUT_DIR, an assembly output
  directory (a copy: they write into it): `gfa OUT_DIR 0`, whose listing
  goes to stdout, `gfa OUT_DIR K --coverage --readpath` and `map OUT_DIR K
  --references REFERENCE...`; then prints one JSON object, each
  subcommand's wall in seconds.
"""

import importlib.abc
import json
import os
import sys

import numpy as np


class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(name + " is blocked in this process")
        return None


def read_selection(fq, out):
    from metamdbg_tpu.io import records
    from metamdbg_tpu.sketch import read_selection as rs

    rs.run_read_selection(
        [fq], out, records.Parameters(minimizer_size=15,
                                      density_assembly=0.005,
                                      density_correction=0.025,
                                      use_homopolymer_compression=True),
        skip_correction=True)


def graph(work, params_dir, first_k, last_k):
    from chip_smoke import pass_digests
    from metamdbg_tpu.graph import contigs, multiplex, stage
    from metamdbg_tpu.io import records

    first_k, last_k = int(first_k), int(last_k)
    out = {}
    for k in range(first_k, last_k + 1):
        p = records.Parameters.load(os.path.join(params_dir, f"k{k}.gz"))
        p.save(os.path.join(work, "parameters.gz"))
        if k == first_k:
            stage.run_graph_first_pass(work, k, 0)
        elif k == first_k + 1:
            stage.run_graph_second_pass(work, k, p)
        else:
            multiplex.run_graph_multiplex_pass(work, k, p)
        contigs.run_contig_stage(work, p, 50000, 50000)
        name = "contig_data_init.txt" if k == last_k else "unitig_data.txt"
        contigs.run_to_minspace(work, os.path.join(work, "contigs.nodepath"),
                                os.path.join(work, name),
                                os.path.join(work, "unitigGraph.nodes.bin"),
                                p)
        out[k] = pass_digests(work, k, first_k, k == last_k)
    print(json.dumps(out))


def basespace(work, fq, out_fasta):
    from metamdbg_tpu.basespace import postprocess, reconstruct
    from metamdbg_tpu.io import records

    params = records.Parameters.load(os.path.join(work, "parameters.gz"))
    postprocess.run_derep_small(work, params, params.kminmer_size_first,
                                params.kminmer_size)
    postprocess.run_remove_overlaps(work, params)
    postprocess.run_remove_repeats(work, params)
    # the asm's floors: max(50, --min-contig-length), max(1, coverage)
    reconstruct.run_to_basespace(work, [fq], out_fasta, params, 50, 1.0,
                                 None, n_threads=1)


def correction(fq, out):
    from metamdbg_tpu.constants import compute_last_k
    from metamdbg_tpu.correction import stage as correction_stage
    from metamdbg_tpu.io import records
    from metamdbg_tpu.sketch import read_selection as rs

    with open(os.path.join(out, "input.txt"), "w") as f:
        f.write(os.path.abspath(fq) + "\n")
    first_k, density = 4, 0.005
    params = records.Parameters(minimizer_size=15, density_assembly=density,
                                density_correction=0.025,
                                use_homopolymer_compression=False,
                                data_type=1)
    stats = rs.run_read_selection([fq], out, params)
    spacing = 1 / np.float32(density)
    params = records.Parameters(
        minimizer_size=15, kminmer_size=first_k, density_assembly=density,
        kminmer_size_first=first_k, minimizer_spacing_mean=float(spacing),
        kminmer_length_mean=float(spacing * np.float32(first_k - 1)),
        kminmer_overlap_mean=float(spacing * np.float32(first_k - 1)
                                   - spacing),
        kminmer_size_prev=first_k,
        kminmer_size_last=compute_last_k(density, stats.n50, first_k, 0),
        mean_read_length=stats.n50, density_correction=0.025,
        use_homopolymer_compression=False, data_type=1, snpmer_size=21)
    checksum = correction_stage.run_read_correction(out, params, 0.96, 1000,
                                                    n_threads=1)
    print(json.dumps({"checksum": int(checksum)}))


def gfa(out, k, *references):
    import time

    from metamdbg_tpu.__main__ import main

    walls = {}
    for name, args in (("gfa0", ["gfa", out, "0"]),
                       ("gfa", ["gfa", out, k, "--coverage", "--readpath"]),
                       ("map", ["map", out, k, "--references",
                                *references])):
        t0 = time.perf_counter()
        main(args)
        walls[name] = time.perf_counter() - t0
    print(json.dumps(walls))


PHASES = {"read_selection": read_selection, "graph": graph,
          "basespace": basespace, "correction": correction, "gfa": gfa}


if __name__ == "__main__":
    sys.meta_path.insert(0, _BlockJax())
    os.environ["METAMDBG_TPU_HOST_ONLY"] = "1"
    PHASES[sys.argv[1]](*sys.argv[2:])
