"""CLI: ``python -m metamdbg_tpu_torch asm --out-dir DIR --in-hifi reads.fastq.gz``,
``python -m metamdbg_tpu_torch gfa DIR [K]`` and
``python -m metamdbg_tpu_torch map DIR K --references genome.fasta``.

The `asm`, `gfa` and `map` subcommands of metamdbg_tpu with the same
arguments, plus ``--device {cuda,cpu}`` (default cuda) on each. `cuda`
needs a usable NVIDIA GPU and raises at startup without one; `cpu` runs
the kernels' plain torch versions. `asm` and `gfa` take ``--threads``.
``asm --trace-out PATH`` writes the program's spans (utils/spans.py) as
Chrome trace JSON.

`asm` runs as N ranks when METAMDBG_TPU_DISTRIBUTED is set (the variables
of metamdbg_tpu_torch/parallel/__init__.py; an --out-dir per rank): every
rank writes the one-rank run's files, and the group is torn down at exit.
"""

import argparse
import logging
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="metamdbg_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    asm = sub.add_parser("asm", help="assemble long reads")
    asm.add_argument("--out-dir", "-o", required=True)
    asm.add_argument("--in-hifi", nargs="+", default=None,
                     help="PacBio HiFi read filename(s)")
    asm.add_argument("--in-ont", nargs="+", default=None,
                     help="Nanopore R10.4+ read filename(s)")
    asm.add_argument("--threads", "-t", type=int, default=1,
                     help="threads of the native host libraries (OpenMP, "
                          "where the compiler has it); nothing forks")
    asm.add_argument("--min-read-quality", type=float, default=0.0)
    asm.add_argument("--min-contig-length", type=int, default=50)
    asm.add_argument("--min-contig-coverage", type=float, default=1)
    asm.add_argument("--k-min-size", type=int, default=15,
                     dest="minimizer_size")
    asm.add_argument("--density-assembly", type=float, default=0.005)
    asm.add_argument("--density-correction", type=float, default=0.025)
    asm.add_argument("--max-k", type=int, default=0)
    asm.add_argument("--min-abundance", type=int, default=0)
    asm.add_argument("--max-bubble-length", type=int, default=50000)
    asm.add_argument("--max-tip-length", type=int, default=50000)
    asm.add_argument("--skip-correction", action="store_true")
    asm.add_argument("--all-assembly-graph", action="store_true",
                     help="generate assembly graph at each multi-k iteration"
                          " (higher disk usage)")
    asm.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where the ported stages run (default cuda)")
    asm.add_argument("--trace-out", default=None, metavar="PATH",
                     help="record the program's spans for the whole run "
                          "and write them to PATH as Chrome trace JSON")

    gfa = sub.add_parser("gfa", help="export assembly graphs")
    gfa.add_argument("out_dir", help="assembly output dir (with tmp/)")
    gfa.add_argument("k", type=int, nargs="?", default=0,
                     help="k of the graph to export (0 = list available)")
    gfa.add_argument("--output", default=None)
    gfa.add_argument("--coverage", action="store_true",
                     help="recompute unitig coverage")
    gfa.add_argument("--readpath", action="store_true",
                     help="generate path of reads in the assembly graph")
    gfa.add_argument("--threads", "-t", type=int, default=1,
                     help="threads of the native host libraries in the "
                          "unitigs' read tiling")
    gfa.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where the kernels run (default cuda)")

    mp = sub.add_parser("map", help="color an assembly graph by references")
    mp.add_argument("out_dir", help="assembly output dir (with tmp/)")
    mp.add_argument("k", type=int, help="k of the saved graph to color")
    mp.add_argument("--references", nargs="+", required=True,
                    help="reference genome fasta file(s)")
    mp.add_argument("--output-prefix", default=None)
    mp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernels run (default cuda)")

    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    if args.command == "gfa":
        from metamdbg_tpu_torch.pipeline.gfa import run_gfa
        run_gfa(args.out_dir, args.k, args.output,
                recompute_coverage=args.coverage, read_path=args.readpath,
                device=args.device, n_threads=max(1, args.threads))
        return 0
    if args.command == "map":
        from metamdbg_tpu_torch.pipeline.mapref import run_map
        run_map(args.out_dir, args.k, args.references, args.output_prefix,
                device=args.device)
        return 0

    if bool(args.in_hifi) == bool(args.in_ont):
        parser.error("choose exactly one of --in-hifi / --in-ont")
    reads = args.in_hifi or args.in_ont
    missing = [r for r in reads if not os.path.isfile(r)]
    if missing:
        parser.error("read file not found: " + ", ".join(missing))

    from metamdbg_tpu_torch import parallel
    from metamdbg_tpu_torch.pipeline.asm import Pipeline
    from metamdbg_tpu_torch.utils import spans
    if args.trace_out:
        spans.record_all()
    pipeline = Pipeline(args.out_dir, reads,
                        platform="hifi" if args.in_hifi else "ont",
                        device=args.device,
                        min_read_quality=args.min_read_quality,
                        max_k=args.max_k,
                        min_abundance=args.min_abundance,
                        max_bubble_length=args.max_bubble_length,
                        max_tip_length=args.max_tip_length,
                        minimizer_size=args.minimizer_size,
                        density_assembly=args.density_assembly,
                        density_correction=args.density_correction,
                        min_contig_length=args.min_contig_length,
                        min_contig_coverage=args.min_contig_coverage,
                        skip_correction=args.skip_correction,
                        all_assembly_graph=args.all_assembly_graph,
                        n_threads=args.threads)
    try:
        pipeline.run()
    finally:
        parallel.shutdown()
        if args.trace_out:
            spans.write_chrome_trace(args.trace_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
