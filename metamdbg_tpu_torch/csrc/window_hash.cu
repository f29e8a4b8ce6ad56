// Kernel KW: canonical k-min-mer hashing of windows of a minimizer stream,
// for Hopper (sm_90a).
//
// Replaces the JAX package's three copies of one operation: the XLA
// function metamdbg_tpu/parallel/count_table.py:_window_hash_pairs, the host
// SIMD loops native/sketch.cpp:window_hash_batch and row_hash_batch, and
// the numpy normalize_rows + murmur128_u32rows they are held against. Plain
// version: metamdbg_tpu_torch/kernels/window_hash.py:hash_windows_reference.
//
// For each window i, of width w_i = widths ? widths[i] : w, starting at
// cat[starts[i]] (u32 values carried in int64 slots):
//   normalize = 1: the window is made canonical as KmerVec::normalize does
//     (src/Commons.hpp:886-916): at the first index j where
//     cat[s+j] != cat[s+w-1-j], the reversed copy is taken iff its value
//     there is smaller; a palindrome takes the reversed copy, the same
//     bytes;
//   normalize = 0: the window is hashed as it lies (raw rows);
//   the chosen copy is hashed as 4*w little-endian bytes with
//   MurmurHash3_x64_128, seed 0 (KmerVec::hash128, src/Commons.hpp:956-969),
//   and h1, h2 are stored as the u64 bits of int64 outputs.
// A window that reaches outside [0, n_cat) sets *flag = token + 1, a width
// below 1 *flag = token + 2 (its outputs are meaningless); the wrapper
// reads the flag after the outputs and raises. With no error the flag is
// not written, so a launch needs no memset before it.
//
// What bounds it on this card: integer operations once w > ~26, bytes
// below, for a launch large enough to fill the card. A 16-byte murmur
// block costs 22 multiply-adds (FMA pipe), 12 INT32-only operations and 4
// adds that either pipe takes, ~58 SASS instructions, w/4 blocks a window;
// the finalizer 16 + 16 + 8. The chain of one window is serial (each block's h1, h2 depend
// on the last). The main path's launches are small (most hold 4,096-65,536
// windows: fewer blocks than the card has SMs at the low end), and there
// the card's fixed cost of a launch, ~3 us, sets the time.
// The design is one thread per window, one kernel for one width or one
// width per window, the words read through L1 (neighbouring windows share
// w-1 of them), the direction found by a scan from both ends and the
// 16-byte blocks fed in the chosen order. Measured on the card against it
// (tools/kernel_variants.py, numbers in PERF.md): a block that staged its
// span of the stream in shared memory after a block-wide min/max of its
// starts; two windows per thread with interleaved chains; each block's 4
// words loaded as one run and ordered with selects, unrolled 1-8 deep;
// L2 prefetch ahead of the loads. Each was faster on some synthetic shape
// and slower on the planes of the ladder, which are the main path.
// The range check is the kernel's too: each thread checks its window, so
// the wrapper runs no reduction of its own and waits for the card once per
// call, for the flag.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutside = 1, kBadWidth = 2;  // *flag - token on an error

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

__device__ __forceinline__ uint64_t mix_k1(uint64_t k1) {
  k1 *= 0x87C37B91114253D5ull;
  k1 = rotl64(k1, 31);
  return k1 * 0x4CF5AD432745937Full;
}

__device__ __forceinline__ uint64_t mix_k2(uint64_t k2) {
  k2 *= 0x4CF5AD432745937Full;
  k2 = rotl64(k2, 33);
  return k2 * 0x87C37B91114253D5ull;
}

__global__ void __launch_bounds__(kThreads)
window_hash_kernel(const int64_t* __restrict__ cat, int64_t n_cat,
                   const int64_t* __restrict__ starts,
                   const int64_t* __restrict__ widths, int64_t n, int w_all,
                   int normalize, int64_t* __restrict__ out_h1,
                   int64_t* __restrict__ out_h2, int64_t* __restrict__ flag,
                   int64_t token) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t start = starts[i];
  const int64_t w64 = widths ? widths[i] : w_all;
  // a bad window hashes width 0 and reads nothing: no branch leaves the
  // hashing early, which keeps the compiled loop that of a plain window
  const bool bad_width = w64 < 1;
  const bool bad = bad_width || start < 0 || start > n_cat - w64;
  const int w = bad ? 0 : (int)w64;
  const int64_t* s = cat + (bad ? 0 : start);

  bool rev = false;
  if (normalize) {
    rev = true;  // a palindrome hashes its reversed copy (the same bytes)
    for (int j = 0; j < w - 1 - j; ++j) {
      const uint32_t a = (uint32_t)s[j];
      const uint32_t b = (uint32_t)s[w - 1 - j];
      if (a != b) {
        rev = b < a;
        break;
      }
    }
  }
  // word j of the chosen copy; the reversed copy reads from the far end
  const int64_t* p = rev ? s + (w - 1) : s;
  const int step = rev ? -1 : 1;
  auto word_at = [&](int j) -> uint64_t { return (uint32_t)p[j * step]; };

  uint64_t h1 = 0, h2 = 0;
  const int nblocks = w / 4;
  for (int b = 0; b < nblocks; ++b) {
    const int j = 4 * b;
    h1 ^= mix_k1(word_at(j) | (word_at(j + 1) << 32));
    h1 = rotl64(h1, 27);
    h1 += h2;
    h1 = h1 * 5 + 0x52DCE729ull;
    h2 ^= mix_k2(word_at(j + 2) | (word_at(j + 3) << 32));
    h2 = rotl64(h2, 31);
    h2 += h1;
    h2 = h2 * 5 + 0x38495AB5ull;
  }
  const int base = 4 * nblocks;
  const int rem = w - base;
  if (rem == 3) h2 ^= mix_k2(word_at(base + 2));  // len & 15 == 12
  if (rem >= 1) {
    uint64_t k1 = word_at(base);
    if (rem >= 2) k1 |= word_at(base + 1) << 32;
    h1 ^= mix_k1(k1);
  }
  const uint64_t length = 4ull * (uint64_t)w;
  h1 ^= length;
  h2 ^= length;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  h2 += h1;
  out_h1[i] = (int64_t)h1;
  out_h2[i] = (int64_t)h2;
  if (bad) *flag = token + (bad_width ? kBadWidth : kOutside);
}

}  // namespace

// out: (2n + 1) int64 words, h1 then h2 then the flag word.
extern "C" int window_hash_launch(const void* cat, long long n_cat,
                                  const void* starts, const void* widths,
                                  long long n, int w, int normalize, void* out,
                                  long long token, void* stream) {
  if (n > 0) {
    int64_t* h = (int64_t*)out;
    const long long blocks = (n + kThreads - 1) / kThreads;
    window_hash_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)cat, (int64_t)n_cat, (const int64_t*)starts,
        (const int64_t*)widths, (int64_t)n, w, normalize, h, h + n, h + 2 * n,
        (int64_t)token);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* window_hash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
