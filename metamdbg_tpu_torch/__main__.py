"""CLI: ``python -m metamdbg_tpu_torch asm --out-dir DIR --in-hifi reads.fastq.gz``.

The `asm` subcommand of metamdbg_tpu with the same flags, plus
``--device {cuda,cpu}`` (default cuda). `cuda` needs a usable NVIDIA GPU
and raises at startup without one; `cpu` runs the kernels' plain torch
versions. The `gfa` and `map` subcommands are not ported yet.
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

    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    if bool(args.in_hifi) == bool(args.in_ont):
        parser.error("choose exactly one of --in-hifi / --in-ont")
    reads = args.in_hifi or args.in_ont
    missing = [r for r in reads if not os.path.isfile(r)]
    if missing:
        parser.error("read file not found: " + ", ".join(missing))

    from metamdbg_tpu_torch.pipeline.asm import Pipeline
    Pipeline(args.out_dir, reads,
             platform="hifi" if args.in_hifi else "ont",
             device=args.device,
             min_read_quality=args.min_read_quality, max_k=args.max_k,
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
             n_threads=args.threads).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
