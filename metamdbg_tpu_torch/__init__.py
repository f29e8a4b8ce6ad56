"""metamdbg_tpu_torch — the PyTorch/CUDA port of metamdbg_tpu.

A second package beside `metamdbg_tpu` (the JAX reference, which does not
change). It runs the same `asm` pipeline and writes the same on-disk
artifacts byte for byte. Every stage runs on an explicit torch `device`,
with every kernel of the JAX package on its path rewritten by hand for
NVIDIA Hopper. Nothing here imports jax or `metamdbg_tpu`.

Layout:
    constants.py  method constants (copied from the JAX package)
    utils/        stats, murmur64/128 in int64 bit patterns, the exact u64 cut
    io/           record formats, native library bindings, fastq/fasta
    sketch/       read selection: RLE, tile packing, filters, palindromes
    correction/   ONT read correction: read mapper, partitions, native POA
    count/        k-min-mer counting and refined abundances
    graph/        graph passes, the multi-k ladder, simplification, contigs
    basespace/    post-processing and toBasespace (mapping, tiling, polish)
    kernels/      CUDA kernels (csrc/), their plain torch versions, nvcc build
    pipeline/     the `asm` orchestrator
"""

__version__ = "0.1.0"
