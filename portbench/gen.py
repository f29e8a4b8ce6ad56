"""Synthetic communities and their reads, made from a seed.

A copy of `tests/datagen.py` (`random_genome`, `mutate`, `sample_reads`,
`make_metagenome`, `metagenome_reads`) with the error model of
`tools/scale_run.py:DATASETS` (substitutions, single-base insertions and
deletions, Phred qualities around a mean), kept here so that later changes
to either file do not move the benchmark. Changes: every random stream
comes from a `numpy.random.SeedSequence` of (seed, unit, ...), so any
whole number up to 2**63 is a seed and units are independent; and a
sample is one strain's genome at its full size with its reads.
"""

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in (b"AT", b"TA", b"CG", b"GC"):
    _COMP[_a] = _b


def rng_for(*keys) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(k) for k in keys]))


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


def mutate(seq: np.ndarray, rng, sub_rate: float, ins_rate: float = 0.0,
           del_rate: float = 0.0) -> np.ndarray:
    """Substitutions, then single-base insertions and deletions."""
    if sub_rate > 0:
        length = seq.shape[0]
        nerr = rng.binomial(length, sub_rate)
        if nerr:
            pos = rng.integers(0, length, size=nerr)
            seq[pos] = BASES[(np.searchsorted(BASES, seq[pos])
                              + rng.integers(1, 4, size=nerr)) % 4]
    if ins_rate > 0 or del_rate > 0:
        r = rng.random(seq.shape[0])
        keep = r >= del_rate
        ins = (r < del_rate + ins_rate) & keep
        out = seq[keep]
        ins_pos = np.flatnonzero(ins[keep])
        if ins_pos.size:
            out = np.insert(out, ins_pos,
                            BASES[rng.integers(0, 4, size=ins_pos.size)])
        seq = out
    return seq


def genome(strain: dict, repeat_len: int, seed: int, unit: int):
    """One strain's genome at its full size (`genome_mb`), random from
    (seed, unit), with the seed's repeat family inserted 2-3 times, each
    copy mutated at 2% (the repeats of tests/datagen.py:make_metagenome)."""
    repeat = BASES[rng_for(seed, 1 << 20).integers(0, 4, size=repeat_len)]
    size = int(round(strain["genome_mb"] * 1e6))
    grng = rng_for(seed, unit, 0)
    g = BASES[grng.integers(0, 4, size=size)]
    for _ in range(int(grng.integers(2, 4))):
        rep = mutate(repeat.copy(), grng, 0.02)
        pos = int(grng.integers(0, max(size - rep.shape[0], 1)))
        piece = rep[:g[pos:pos + rep.shape[0]].shape[0]]
        g[pos:pos + piece.shape[0]] = piece
    return g


def sample_reads(genome: np.ndarray, coverage: float, reads: dict, rng):
    """Yields (seq, qual) from a circular genome at `coverage`: lengths
    normal around `mean_len` (sd a sixth, at least 200), errors by
    `mutate`, half reverse-complemented, qualities normal around `mean_q`
    (sd 3, clipped to 3-60)."""
    n = genome.shape[0]
    total = int(n * coverage)
    mean_len = reads["mean_len"]
    emitted = 0
    while emitted < total:
        length = max(200, int(rng.normal(mean_len, mean_len / 6)))
        start = int(rng.integers(0, n))
        seq = genome[(start + np.arange(length)) % n]
        seq = mutate(seq.copy(), rng, reads["sub_rate"], reads["ins_rate"],
                     reads["del_rate"])
        if rng.random() < 0.5:
            seq = revcomp(seq)
        qual = np.clip(rng.normal(reads["mean_q"], 3, size=seq.shape[0]), 3,
                       60).astype(np.uint8) + 33
        yield seq, qual
        emitted += length


def write_sample(path: str, cfg: dict, seed: int, unit: int,
                 strain: int, mbp: float):
    """One sample: the genome of the configuration's strain `strain`, and
    `mbp` of its reads (depth `mbp` over the genome's length), as fastq at
    gzip level 1 (as users' read files come) into `path`. Returns (the
    genome, the read bases)."""
    import gzip
    import os

    g = genome(cfg["strains"][strain], cfg["repeat_len"], seed, unit)
    rng = rng_for(seed, unit, 1)
    bases = 0
    with gzip.open(path + ".tmp", "wb", compresslevel=1) as f:
        for rid, (seq, qual) in enumerate(
                sample_reads(g, mbp * 1e6 / g.shape[0], cfg["reads"], rng)):
            f.write(b"@r%d\n%s\n+\n%s\n"
                    % (rid, seq.tobytes(), qual.tobytes()))
            bases += seq.shape[0]
    os.replace(path + ".tmp", path)
    return g, bases
