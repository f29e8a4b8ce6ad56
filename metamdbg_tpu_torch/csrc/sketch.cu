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
// What bounds it on this card: integer throughput, not bytes. Each window
// reads one byte and costs about ten 64-bit multiplies (each several
// 32-bit IMADs on Hopper) plus shifts and xors for the hash. The design
// spends no instruction that is not the hash:
//   - one block per row; the row is staged once into shared memory with
//     coalesced loads, padded every 64 bytes so that the threads' strided
//     byte reads fall in distinct banks;
//   - each thread owns 64 consecutive windows and rolls fwd/rev in
//     uint32_t registers after an l-1 base warm-up (2 shifts per base,
//     not l);
//   - the selection of the 64 windows is kept as one 64-bit mask in a
//     register, so the second sweep, which writes the selected windows,
//     re-rolls only the span between the first and last selected window
//     and never hashes again;
//   - a block-wide exclusive scan of the per-thread counts (warp shuffles,
//     then one warp over the warp totals) gives every thread its output
//     offset, which keeps the JAX stable-sort order without a sort.
// Rows longer than 256 * 64 windows are walked in rounds with a carried
// offset. Overflow rows (count > cap) are relaunched by the wrapper with
// cap = nk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 64;                  // windows per thread per round
constexpr int kPad = 4;                    // shared bytes after every span
constexpr int kStride = kSpan + kPad;
constexpr int kRound = kThreads * kSpan;   // windows per block round

__device__ __forceinline__ int sidx(int x) { return x + (x / kSpan) * kPad; }

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

// MurmurHash3_x64_128 of one 8-byte key, seed 42; the low 64 bits
// (MurmurHash3.cpp:246-322 with len = 8: no blocks, k1 = key, k2 = 0).
__device__ __forceinline__ uint64_t murmur64(uint64_t key) {
  uint64_t h1 = 42, h2 = 42;
  uint64_t k1 = key * 0x87C37B91114253D5ull;
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

__global__ void __launch_bounds__(kThreads)
sketch_tiles_kernel(const uint8_t* __restrict__ codes, int L, int l,
                    uint64_t thr, int select_all, int cap,
                    int32_t* __restrict__ positions,
                    uint32_t* __restrict__ values,
                    uint8_t* __restrict__ dirs,
                    int32_t* __restrict__ counts) {
  __shared__ uint8_t s_codes[(kThreads + 1) * kStride];
  __shared__ int s_warp[kWarps];
  __shared__ int s_total;

  const int row = blockIdx.x;
  const uint8_t* src = codes + (size_t)row * L;
  const size_t out_base = (size_t)row * cap;
  const int nk = L - l + 1;
  const uint32_t kmask = l == 16 ? 0xFFFFFFFFu : ((1u << (2 * l)) - 1u);
  const int top = 2 * (l - 1);
  const int x0 = threadIdx.x * kSpan;  // first round-local window of this thread
  int carry = 0;

  for (int r0 = 0; r0 < nk; r0 += kRound) {
    // bases [r0, r0 + kRound + l - 1) of the row; past its end reads as bad
    for (int x = threadIdx.x; x < kRound + l - 1; x += kThreads) {
      const int g = r0 + x;
      s_codes[sidx(x)] = g < L ? src[g] : 4;
    }
    __syncthreads();

    const int n_win = min(kSpan, nk - r0 - x0);  // may be <= 0
    uint64_t mask = 0;
    if (n_win > 0) {
      uint32_t fwd = 0, rev = 0;
      int last_bad = -1;  // round-local index of the last bad base seen
      for (int i = 0; i < l - 1 + n_win; ++i) {
        const int x = x0 + i;
        uint32_t c = s_codes[sidx(x)];
        if (c >= 4) {
          last_bad = x;
          c = 0;
        }
        fwd = ((fwd << 2) | c) & kmask;
        rev = (rev >> 2) | ((c ^ 2u) << top);
        const int w = i - (l - 1);  // window x0 + w covers bases x0 + w .. x
        if (w >= 0) {
          const uint32_t v = fwd < rev ? fwd : rev;
          const bool hit = select_all || murmur64(v) < thr;
          if (hit && last_bad < x0 + w) mask |= 1ull << w;
        }
      }
    }

    const int off0 = block_exclusive_scan(__popcll(mask), s_warp, &s_total);
    const int total = s_total;

    if (mask) {
      const int w_first = __ffsll((long long)mask) - 1;
      const int w_last = 63 - __clzll((long long)mask);
      int off = carry + off0;
      uint32_t fwd = 0, rev = 0;
      for (int i = w_first; i <= w_last + l - 1; ++i) {
        uint32_t c = s_codes[sidx(x0 + i)];
        if (c >= 4) c = 0;
        fwd = ((fwd << 2) | c) & kmask;
        rev = (rev >> 2) | ((c ^ 2u) << top);
        const int w = i - (l - 1);
        if (w >= w_first && ((mask >> w) & 1ull)) {
          if (off < cap) {
            positions[out_base + off] = r0 + x0 + w;
            values[out_base + off] = fwd < rev ? fwd : rev;
            dirs[out_base + off] = fwd < rev ? 0 : 1;
          }
          ++off;
        }
      }
    }
    carry += total;
    __syncthreads();  // s_codes, s_warp and s_total are rewritten next round
  }
  if (threadIdx.x == 0) counts[row] = carry;
}

}  // namespace

extern "C" int sketch_tiles_launch(const void* codes, int n_rows, int L,
                                   int l, unsigned long long thr,
                                   int select_all, int cap, void* positions,
                                   void* values, void* dirs, void* counts,
                                   void* stream) {
  if (n_rows > 0) {
    sketch_tiles_kernel<<<n_rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, L, l, (uint64_t)thr, select_all, cap,
        (int32_t*)positions, (uint32_t*)values, (uint8_t*)dirs,
        (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sketch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
