// Kernel K1: minimizer sketch with in-row compaction, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// metamdbg_tpu/kernels/sketch_pallas.py:_sketch_kernel and its XLA twin
// metamdbg_tpu/kernels/sketch.py:sketch_batch_compact_packed (the
// production sketcher of read selection). Plain version:
// metamdbg_tpu_torch/kernels/sketch.py:sketch_tiles_reference.
//
// For each row of u8 base codes (0..3; >= 4 marks a bad base or a tile
// separator) and each window start x in [0, nk), nk = L - l + 1:
//   fwd  = the 2-bit l-mer, first base most significant (l <= 16);
//   rev  = its reverse complement (code ^ 2, base j at bits 2j);
//   a window holding a code >= 4 is invalid (the bad base counts as 0);
//   value = fwd if fwd < rev else rev (ties go to the reverse, dir = 1);
//   h = low 64 bits of MurmurHash3_x64_128(value as an 8-byte key, 42);
//   the window is selected iff it is valid and h < thr (the exact u64 cut
//   of the density, computed on the host).
// The row's selected windows are written in ascending position order to
// the front of the row's output: position (i32), value (u32), dir (u8),
// the first `cap` of them, and counts[row] holds the true number.
//
// What bounds it on this card: integer operations, not bytes. A window
// reads one byte and costs 60 integer operations by the algorithm (the
// murmur64 finalizer is 44 of them): 23 multiply-adds for the FMA pipe, 29
// logic operations, funnel and right shifts and compares for the INT32
// pipe, and 8 adds and left shifts that either pipe takes, so at best 30 a
// pipe; its output is a few bytes per selected window. The compiled code
// issues ~97 instructions a window, the murmur64 alone ~50 (29 of them
// IMADs: ptxas moves adds and shifts onto the FMA pipe), so instruction
// issue, not a pipe, sets the pace. The
// design keeps the card full and spends nothing but the sketch:
//   - a thread-block cluster of 8 blocks of 128 threads per row: 4,096
//     blocks for a (512, 16384) batch, and each thread owns 16 consecutive
//     windows. The blocks of a row exchange their selection counts through
//     distributed shared memory (each reads the others' totals after a
//     cluster barrier), which gives each its offset in the row's output in
//     one launch, without a second pass or a look-back;
//   - each thread loads its 16 + l - 1 bases with two 16-byte loads
//     straight into registers (no shared-memory staging; a row's last
//     thread, or an unaligned row, reads bytes);
//   - with l a template parameter (15, the main path's; 0 for a run-time l)
//     the roll over the bases unrolls fully: the 16 canonical values are
//     computed first and their 16 hashes then run as independent chains,
//     which the compiler interleaves;
//   - the selection of the 16 windows is a bit mask and the directions
//     another, so the write of the selected windows reads the values from
//     registers and never rolls or hashes again; a block-wide exclusive
//     scan of the per-thread counts (warp shuffles, then one warp over the
//     warp totals) gives each thread its offset within the block, which
//     keeps the JAX stable-sort order without a sort.
// Rows longer than 8 * 2048 windows are walked in rounds with a carried
// offset. Overflow rows (count > cap) are relaunched by the wrapper with
// cap = nk.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                  // blocks per row
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 16;                    // windows per thread per round
constexpr int kRound = kThreads * kSpan;     // windows per block per round
constexpr int kRowRound = kCluster * kRound;  // windows per row per round
static_assert(kSpan == 16, "a thread loads its 16 + l - 1 <= 31 bases with "
              "two aligned 16-byte loads");

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDull;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ull;
  k ^= k >> 33;
  return k;
}

// MurmurHash3_x64_128 of one 8-byte key below 2^32, seed 42; the low 64
// bits (MurmurHash3.cpp:246-322 with len = 8: no blocks, k1 = key, k2 = 0).
__device__ __forceinline__ uint64_t murmur64(uint32_t key) {
  uint64_t h1 = 42, h2 = 42;
  uint64_t k1 = (uint64_t)key * 0x87C37B91114253D5ull;  // 32 x 64 bits
  k1 = rotl64(k1, 31);
  k1 *= 0x4CF5AD432745937Full;
  h1 ^= k1;
  h1 ^= 8;
  h2 ^= 8;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

// Exclusive scan of v over the block; *total receives the block sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    int si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, si, o);
      if (lane >= o) si += y;
    }
    if (lane < kWarps) warp_sums[lane] = si - s;
    if (lane == kWarps - 1) *total = si;
  }
  __syncthreads();
  return warp_sums[warp] + incl - v;
}

// Bases [x0, x0 + 32) of the row as 8 little-endian words; past L reads 4.
__device__ __forceinline__ void load_bases(const uint8_t* __restrict__ src,
                                           int L, int x0, bool aligned,
                                           uint32_t (&b)[8]) {
  if (aligned && x0 + 32 <= L) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + x0));
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + x0 + 16));
    b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
    b[4] = v.x; b[5] = v.y; b[6] = v.z; b[7] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = x0 + 4 * j + k;
      const uint32_t c = g < L ? src[g] : 4u;
      word |= c << (8 * k);
    }
    b[j] = word;
  }
}

// kL > 0: l = kL, known at compile time; kL = 0: l = l_rt.
template <int kL>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
sketch_tiles_kernel(const uint8_t* __restrict__ codes, int L, int l_rt,
                    uint64_t thr, int select_all, int cap,
                    int32_t* __restrict__ positions,
                    uint32_t* __restrict__ values,
                    uint8_t* __restrict__ dirs,
                    int32_t* __restrict__ counts) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_total;   // this block's selections in the round
  __shared__ int s_before;  // those of the row's earlier blocks
  __shared__ int s_all;     // those of the whole row

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / kCluster;
  const int l = kL > 0 ? kL : l_rt;
  const uint8_t* src = codes + (size_t)row * L;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const size_t out_base = (size_t)row * cap;
  const int nk = L - l + 1;
  const uint32_t kmask = l == 16 ? 0xFFFFFFFFu : ((1u << (2 * l)) - 1u);
  const int top = 2 * (l - 1);
  int carry = 0;

  for (int r0 = 0; r0 < nk; r0 += kRowRound) {
    const int x0 = r0 + rank * kRound + threadIdx.x * kSpan;
    const int n_win = min(kSpan, nk - x0);  // may be <= 0
    uint32_t vals[kSpan];
    uint32_t mask = 0, dirbits = 0;
    if (n_win > 0) {
      uint32_t b[8];
      load_bases(src, L, x0, aligned, b);
      uint32_t fwd = 0, rev = 0, valid = 0;
      int last_bad = -1;  // index of the last bad base seen
#pragma unroll
      for (int i = 0; i < kSpan + l - 1; ++i) {
        uint32_t c = (b[i >> 2] >> (8 * (i & 3))) & 0xFFu;
        if (c >= 4) {
          last_bad = i;
          c = 0;
        }
        fwd = ((fwd << 2) | c) & kmask;
        rev = (rev >> 2) | ((c ^ 2u) << top);
        const int w = i - (l - 1);  // window w covers bases w .. i
        if (w >= 0) {
          vals[w] = fwd < rev ? fwd : rev;
          dirbits |= (uint32_t)(fwd >= rev) << w;
          valid |= (uint32_t)(last_bad < w) << w;
        }
      }
#pragma unroll
      for (int w = 0; w < kSpan; ++w) {
        const bool hit = select_all || murmur64(vals[w]) < thr;
        mask |= (uint32_t)hit << w;
      }
      mask &= valid & (n_win < kSpan ? (1u << n_win) - 1u : 0xFFFFFFFFu);
    }

    const int off0 = block_exclusive_scan(__popc(mask), s_warp, &s_total);
    cluster.sync();  // every block's s_total is visible to the cluster
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int t = lane < kCluster
                        ? *cluster.map_shared_rank(&s_total, lane) : 0;
      int incl = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const int before = __shfl_sync(0xffffffffu, incl - t, rank);
      const int all = __shfl_sync(0xffffffffu, incl, kCluster - 1);
      if (lane == 0) {
        s_before = before;
        s_all = all;
      }
    }
    __syncthreads();

    if (mask) {
      int off = carry + s_before + off0;
#pragma unroll
      for (int w = 0; w < kSpan; ++w) {
        if ((mask >> w) & 1u) {
          if (off < cap) {
            positions[out_base + off] = x0 + w;
            values[out_base + off] = vals[w];
            dirs[out_base + off] = (uint8_t)((dirbits >> w) & 1u);
          }
          ++off;
        }
      }
    }
    carry += s_all;
    // no block rewrites its s_total, or exits, while another may read it
    cluster.sync();
  }
  if (rank == 0 && threadIdx.x == 0) counts[row] = carry;
}

}  // namespace

extern "C" int sketch_tiles_launch(const void* codes, int n_rows, int L,
                                   int l, unsigned long long thr,
                                   int select_all, int cap, void* positions,
                                   void* values, void* dirs, void* counts,
                                   void* stream) {
  if (n_rows > 0) {
    const unsigned grid = (unsigned)n_rows * kCluster;
    cudaStream_t s = (cudaStream_t)stream;
    if (l == 15) {
      sketch_tiles_kernel<15><<<grid, kThreads, 0, s>>>(
          (const uint8_t*)codes, L, l, (uint64_t)thr, select_all, cap,
          (int32_t*)positions, (uint32_t*)values, (uint8_t*)dirs,
          (int32_t*)counts);
    } else {
      sketch_tiles_kernel<0><<<grid, kThreads, 0, s>>>(
          (const uint8_t*)codes, L, l, (uint64_t)thr, select_all, cap,
          (int32_t*)positions, (uint32_t*)values, (uint8_t*)dirs,
          (int32_t*)counts);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sketch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
