"""Read selection as one unit: `sketch.read_selection.run_read_selection`
over one sample's reads, as an asm's first stage runs it.

A sample is `unit_mbp` of one strain's reads as gzipped fastq, the form
users' read files come in; the unit is the reads themselves, so the
set-up makes no minimizer-space inputs. Every file the stage writes is
compared: `read_data_init.txt`, `read_stats.txt`,
`repetitiveMinimizers.bin` and, where the palindromes are purged,
`read_data_corrected.txt`.
"""

import os

from . import READ_FILE, link_inputs, make_params

OUTPUT = "read_data_init.txt"
# the reference in the program's place with one stated guarantee broken:
# homopolymer compression off, which --in-hifi states (`reference` below
# reads it)
HPC_VAR = "PORTBENCH_READSELECTION_HPC"
CONTROL_ENV = {HPC_VAR: "0"}


def finish(cfg, cell, d, genome):
    """Nothing beside the reads."""
    return {}


def _params(records, cfg):
    """The parameters the asm hands read selection (k 4, no last k and no
    mean read length yet)."""
    return make_params(records, cfg, 4, 4, 0, 0)


def _skip_correction(cfg) -> bool:
    """As the asm sets it: HiFi skips read correction."""
    return cfg["platform"] == "hifi"


def run_unit(ctx, unit, work):
    """The program's read selection on the unit's reads, in `work`."""
    from metamdbg_tpu_torch.io import records
    from metamdbg_tpu_torch.sketch import read_selection

    link_inputs(unit["dir"], work, (READ_FILE,))
    read_selection.run_read_selection(
        [os.path.join(work, READ_FILE)], work, _params(records, ctx.cfg),
        ctx.device, skip_correction=_skip_correction(ctx.cfg))


def reference(cfg, unit, work):
    """The reference's read selection on the unit's reads, in `work`."""
    from ..reference.io import records
    from ..reference.sketch import read_selection

    link_inputs(unit["dir"], work, (READ_FILE,))
    params = _params(records, cfg)
    if os.environ.get(HPC_VAR) == "0":
        params.use_homopolymer_compression = False
    read_selection.run_read_selection(
        [os.path.join(work, READ_FILE)], work, params,
        skip_correction=_skip_correction(cfg))
