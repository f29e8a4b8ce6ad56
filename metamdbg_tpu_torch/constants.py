"""Method constants, mirrored from the reference implementation.

Every constant cites the reference file:line it mirrors
(reference: GaetanBenoitDev/metaMDBG v1.4). These values define the *method*;
the implementation around them shares no code with the reference.
"""

import numpy as np

# ---------------------------------------------------------------------------
# Type system (src/utils/kmer/Kmer.hpp:22-26, src/Commons.hpp:61-64)
# ---------------------------------------------------------------------------
MINIMIZER_DTYPE = np.uint32      # MinimizerType = u_int32_t
READ_DTYPE = np.uint32           # ReadType
UNITIG_DTYPE = np.uint32         # UnitigType
ABUNDANCE_DTYPE = np.uint32      # AbundanceType

# ---------------------------------------------------------------------------
# Sketching (src/pipeline/AssemblyPipeline.hpp:116-118,201-202, Kmer.hpp:1352-1362)
# ---------------------------------------------------------------------------
MINIMIZER_SIZE_DEFAULT = 15      # AssemblyPipeline.hpp:116; capped at 16 (:202)
MINIMIZER_SIZE_MAX = 16
DENSITY_ASSEMBLY_DEFAULT = 0.005   # AssemblyPipeline.hpp:117
DENSITY_CORRECTION_DEFAULT = 0.025  # AssemblyPipeline.hpp:125
MINIMIZER_SEED = 42              # Kmer.hpp:1355 (MurmurHash3_x64_128 seed)
KMERVEC_SEED = 0                 # Commons.hpp:961 (hash128 seed)
TRIM_BPS = 1                     # Kmer.hpp:1362: skip 1 k-mer position each end

# Base encoding: code = (ascii >> 1) & 3  (Kmer.hpp:462, GATB convention)
# => A=0, C=1, T=2, G=3 ; complement table comp_NT = {2,3,0,1} (Kmer.hpp:31)
BASE_A, BASE_C, BASE_T, BASE_G = 0, 1, 2, 3
COMP_NT = np.array([2, 3, 0, 1], dtype=np.uint8)

# ---------------------------------------------------------------------------
# Read selection filters (src/readSelection/ReadSelection.hpp)
# ---------------------------------------------------------------------------
COMPLEXITY_WINDOW = 64           # ReadSelection.hpp:890 computeSequenceComplexity(seq, 64, 32)
COMPLEXITY_STEP = 32
COMPLEXITY_MAX_SCORE = 5.0       # ReadSelection.hpp:894: score > 5 => drop read
REPETITIVE_MINIMIZER_FRACTION = 1e-5   # ReadSelection.hpp:513
REPETITIVE_MINIMIZER_MAX_READS = 1_000_000  # ReadSelection.hpp:509

# ---------------------------------------------------------------------------
# Multi-k ladder (src/Commons.hpp:1726-1741,1986-1998; AssemblyPipeline.hpp:490)
# ---------------------------------------------------------------------------
K_FIRST = 4                      # AssemblyPipeline.hpp:490 (first k-min-mer size)
MULTIK_STEP = 1                  # Commons.hpp:1986 getMultikStep: always 1
LASTK_READLEN_FACTOR = 2.0       # Commons.hpp:1727: lastK = N50 * density * 2


def compute_last_k(density_assembly: float, n50_read_length: int,
                   first_k: int = K_FIRST, max_k: int = 0) -> int:
    """Commons.hpp:1726-1741 computeLastK."""
    last_k = int(n50_read_length * np.float32(density_assembly) * np.float32(2.0))
    if max_k > 0:
        last_k = max_k
    return max(last_k, first_k + 2)


# ---------------------------------------------------------------------------
# Graph simplification (src/graph/ProgressiveAbundanceFilter.hpp, AssemblyPipeline.hpp:120-121)
# ---------------------------------------------------------------------------
ABUNDANCE_CUTOFF_START = 1.1     # ProgressiveAbundanceFilter.hpp outer loop start
ABUNDANCE_CUTOFF_FACTOR = 1.1    # geometric step t *= 1.1
ABUNDANCE_CUTOFF_MAX_STEP = 10.0  # capped additive step +10
MAX_BUBBLE_LENGTH_DEFAULT = 50_000  # AssemblyPipeline.hpp:120
MAX_TIP_LENGTH_DEFAULT = 50_000     # AssemblyPipeline.hpp:121
TIP_KMINMER_FACTOR = 2.25        # ProgressiveAbundanceFilter.hpp:2005-2011
CONTIG_MIN_ABUNDANCE_FACTOR = 0.5  # GenerateContigs.hpp:575: abundance >= cutoff/0.5

# ---------------------------------------------------------------------------
# Platform presets (src/pipeline/AssemblyPipeline.hpp:292-325)
# ---------------------------------------------------------------------------
PLATFORM_HIFI = 0
PLATFORM_NANOPORE = 1

PRESET_HIFI = dict(
    data_type=PLATFORM_HIFI,
    read_correction_min_identity=0.99,
    read_correction_min_overlap=1000,
    min_read_quality=0.0,
    contig_derep_identity=0.99,
    use_homopolymer_compression=True,
    use_read_correction=False,
    polishing_coverage=50,
)
PRESET_NANOPORE = dict(
    data_type=PLATFORM_NANOPORE,
    read_correction_min_identity=0.96,
    read_correction_min_overlap=1000,
    min_read_quality=0.0,
    contig_derep_identity=0.99,
    use_homopolymer_compression=False,
    use_read_correction=True,
    polishing_coverage=100,
)

SNPMER_SIZE = 21                 # AssemblyPipeline.hpp:207

# Contig flags (record `isCircular` byte)
CONTIG_LINEAR = 0
CONTIG_CIRCULAR = 1

# Correction / mapping thresholds (src/readSelection/ReadCorrection.hpp:5088-5094)
CORRECTION_MIN_OVERLAP = 1000
CORRECTION_MIN_IDENTITY_ONT = 0.96

# Polishing (src/toBasespace/ContigPolisher.hpp:134-137, ToBasespace2.hpp:100-104)
POLISH_WINDOW_LENGTH = 500
POLISH_MAX_FRAGMENTS_PER_WINDOW = 100
POLISH_QUALITY_THRESHOLD = 10
STITCH_MIN_OVERLAP = 500
STITCH_MAX_HANG = 200
STITCH_MIN_IDENTITY = 0.9
STITCH_INT_FRAC = 0.8
POA_MATCH, POA_MISMATCH, POA_GAP = 3, -5, -4  # ContigPolisher.hpp:2141 spoa params
