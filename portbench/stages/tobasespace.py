"""toBasespace as one unit: `basespace.reconstruct.run_to_basespace` over
one sample's minimizer-space contig and its reads.

A sample is one strain's genome at its full size with `unit_mbp` of its
reads. The reads' minimizer-space files are the reference's read
selection of them; the contig is the genome, sketched like the reads, so
it stands for the contig that post-processing hands toBasespace.
"""

import os
from types import SimpleNamespace

from . import READ_FILE, asm_options, link_inputs, make_params

CONTIGS = "contig_data_init_small.txt.norepeats"
INPUTS = ("read_data_init.txt", CONTIGS, READ_FILE)
OUTPUT = "contigs.fasta.gz"
# the reference in the program's place with one stated guarantee broken:
# one polish pass and no refinement pass, where the configuration states
# two and the refinement
CONTROL_ENV = {"METAMDBG_TPU_POLISH_PASSES": "1",
               "METAMDBG_TPU_POLISH_REFINE": "0"}


def finish(cfg, cell, d, genome):
    """The sample's minimizer-space files: the reads' (the reference's
    read selection) and the contig's; returns the meta the stage needs."""
    from ..reference.constants import compute_last_k
    from ..reference.io import records
    from ..reference.sketch import read_selection

    params = make_params(records, cfg, 4, 4, 0, 0)
    stats = read_selection.run_read_selection(
        [os.path.join(d, READ_FILE)], d, params,
        skip_correction=cfg["platform"] == "hifi")
    opt = asm_options(cfg)
    sketched = read_selection._sketch_chunk(
        [SimpleNamespace(seq=genome)], params.minimizer_size,
        params.density_assembly, params.use_homopolymer_compression, None)
    with records.ReadDataWriter(os.path.join(d, CONTIGS),
                                with_quality=False) as w:
        for i, (mins, _, _, _) in enumerate(sketched):
            w.write(records.MinimizerRead(i, mins, None, None, None))
    return {"nb_reads": int(stats.nb_reads), "n50": int(stats.n50),
            "last_k": int(compute_last_k(opt["density_assembly"], stats.n50,
                                         4, 0))}


def _params(records, cfg, unit):
    k = unit["last_k"]
    return make_params(records, cfg, k, k - 1, k, unit["n50"])


def run_unit(ctx, unit, work):
    """The program's toBasespace on the unit, in `work`."""
    from metamdbg_tpu_torch.basespace import reconstruct
    from metamdbg_tpu_torch.io import records
    from metamdbg_tpu_torch.utils import threadmap

    opt = asm_options(ctx.cfg)
    link_inputs(unit["dir"], work, INPUTS)
    with threadmap.stage_pool(opt["threads"]):
        reconstruct.run_to_basespace(
            work, [os.path.join(work, READ_FILE)],
            os.path.join(work, OUTPUT), _params(records, ctx.cfg, unit),
            ctx.device, opt["min_contig_length"], opt["min_contig_coverage"],
            opt["threads"])


def reference(cfg, unit, work):
    """The reference's toBasespace on the unit, in `work`."""
    from ..reference.basespace import reconstruct
    from ..reference.io import records

    opt = asm_options(cfg)
    link_inputs(unit["dir"], work, INPUTS)
    reconstruct.run_to_basespace(
        work, [os.path.join(work, READ_FILE)], os.path.join(work, OUTPUT),
        _params(records, cfg, unit), opt["min_contig_length"],
        opt["min_contig_coverage"], None, n_threads=opt["threads"])
