// Kernel KW: canonical k-min-mer hashing of windows of a minimizer stream,
// for Hopper (sm_90a).
//
// Replaces the JAX package's three copies of one operation: the XLA
// function metamdbg_tpu/parallel/count_table.py:_window_hash_pairs, the host
// SIMD loops native/sketch.cpp:window_hash_batch and row_hash_batch, and
// the numpy normalize_rows + murmur128_u32rows they are held against. Plain
// versions: metamdbg_tpu_torch/kernels/window_hash.py:hash_windows_reference
// and hash_segments_reference.
//
// Each window of width w, words s[0..w) (u32 values):
//   normalize = 1: the window is made canonical as KmerVec::normalize does
//     (src/Commons.hpp:886-916): at the first index j where
//     s[j] != s[w-1-j], the reversed copy is taken iff its value there is
//     smaller; a palindrome takes the reversed copy, the same bytes;
//   normalize = 0: the window is hashed as it lies (raw rows);
//   the chosen copy is hashed as 4*w little-endian bytes with
//   MurmurHash3_x64_128, seed 0 (KmerVec::hash128, src/Commons.hpp:956-969),
//   and h1, h2 are stored as the u64 bits of int64 outputs.
//
// Two ways to name the windows, one kernel each:
// - explicit starts (window_hash_kernel): one start per window into a
//   stream of u32 values carried in int64 slots, one width for all or one
//   per window. A window that reaches outside [0, n_cat) sets
//   *flag = token + 1, a width below 1 *flag = token + 2 (its outputs are
//   meaningless); the wrapper reads the flag after the outputs and raises.
//   With no error the flag is not written, so a launch needs no memset. Row
//   slices (hash_rows) and per-window widths (whole unitigs) take it.
// - segments (window_hash_segments_kernel): every w-window of every
//   sequence of a stream of u32 words (int32 slots holding the bits), the
//   sequences named by their word offsets. A segment is a range of the
//   sequences of one stream, with its width, its normalize bit and its
//   place in the output; one launch takes any number of them, read from a
//   descriptor table (kSeg* below). The windows of a segment are cut into
//   tiles of kThreads; a block walks over tiles with a grid-stride loop,
//   the grid sized to the card (every SM at its resident blocks). The
//   host lists the segment's sequences that have windows (at a large w
//   most reads have none), with each one's first window and the word where
//   its window 0 starts, and names the listed sequence of each warp's
//   first window. A warp's 32 consecutive windows then lie in at most 32
//   listed sequences: the warp loads their entries in one coalesced step,
//   and each lane finds its window's sequence among them by a binary
//   search over shuffles, without another trip to memory. Every window
//   lies inside its sequence by construction, and the wrapper checks the
//   descriptors on the host, where they are built: this mode has no flag
//   and no wait. It reads 4 bytes a word where the explicit mode reads 8,
//   and no start array. Measured against two designs that searched over
//   every sequence of the segment (PERF.md, PR 13): each thread in device
//   memory between per-tile bounds (~10 dependent loads a window against
//   the explicit mode's 2), and a warp over 31 sequences at a time (a
//   load a step across reads without windows); on launches of the
//   ladder's size they took 1.35x and 2.1x the explicit mode's time.
//
// What bounds it on this card: integer operations once w > ~26, bytes
// below, for a launch large enough to fill the card. A 16-byte murmur
// block costs 22 multiply-adds (FMA pipe), 12 INT32-only operations and 4
// adds that either pipe takes, ~58 SASS instructions, w/4 blocks a window;
// the finalizer 16 + 16 + 8. The chain of one window is serial (each
// block's h1, h2 depend on the last). The ladder's calls are small (most
// hold 4,096-65,536 windows: fewer blocks than the card has SMs at the low
// end), and there the card's fixed cost of a launch, ~3 us, sets the time:
// the segmented mode exists to make one launch of a pass's several planes.
// The hashing is one thread per window, the words read through L1
// (neighbouring windows share w-1 of them), the direction found by a scan
// from both ends and the 16-byte blocks fed in the chosen order. Measured
// on the card against it (tools/kernel_variants.py, numbers in PERF.md): a
// block that staged its span of the stream in shared memory after a
// block-wide min/max of its starts; two windows per thread with
// interleaved chains; each block's 4 words loaded as one run and ordered
// with selects, unrolled 1-8 deep; L2 prefetch ahead of the loads. Each was
// faster on some synthetic shape and slower on the planes of the ladder,
// which are the main path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutside = 1, kBadWidth = 2;  // *flag - token on an error
// a segment's descriptor: kSegWords int64 words (kernels/window_hash.py
// builds them, in this order)
constexpr int kSegWords = 10;
constexpr int kSegWordsPtr = 0;  // address of the stream's u32 words
constexpr int kSegLiveWin = 1;   // address of the first window (int64) of
                                 // each listed sequence, then n_win: n_live
                                 // + 1, from 0
constexpr int kSegLiveBase = 2;  // address of the word (int64) where each
                                 // one's window 0 starts, less its first
                                 // window's index: n_live
constexpr int kSegWarpSeq = 3;   // address of the listed sequence (int64) of
                                 // each 32nd window, the first of a warp's
constexpr int kSegNLive = 4;
constexpr int kSegNWin = 5;
constexpr int kSegWidth = 6;
constexpr int kSegNormalize = 7;
constexpr int kSegOut = 8;       // first output index of the segment
constexpr int kSegTile0 = 9;     // first tile of the segment in the launch
constexpr unsigned kAll = 0xFFFFFFFFu;

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

// (h1, h2) of the window s[0..w) of u32 values held in Word slots (int64
// or int32: the low 32 bits are the value); w = 0 reads nothing.
template <typename Word>
__device__ __forceinline__ void hash_window(const Word* __restrict__ s,
                                            int w, bool normalize,
                                            uint64_t& out1, uint64_t& out2) {
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
  const Word* p = rev ? s + (w - 1) : s;
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
  out1 = h1;
  out2 = h2;
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
  uint64_t h1, h2;
  hash_window(cat + (bad ? 0 : start), w, normalize != 0, h1, h2);
  out_h1[i] = (int64_t)h1;
  out_h2[i] = (int64_t)h2;
  if (bad) *flag = token + (bad_width ? kBadWidth : kOutside);
}

__global__ void __launch_bounds__(kThreads)
window_hash_segments_kernel(const int64_t* __restrict__ segs, int n_seg,
                            int64_t n_tiles, int64_t* __restrict__ out_h1,
                            int64_t* __restrict__ out_h2) {
  const int lane = threadIdx.x & 31;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // the segment: the last whose first tile is at most this one (the
    // wrapper leaves out segments without windows)
    int lo = 0, hi = n_seg - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (segs[mid * kSegWords + kSegTile0] <= tile) lo = mid;
      else hi = mid - 1;
    }
    const int64_t* d = segs + lo * kSegWords;
    const int64_t n_win = d[kSegNWin];
    const int64_t t = (tile - d[kSegTile0]) * kThreads + threadIdx.x;
    if (t - lane >= n_win) continue;  // the whole warp is past the end
    const int64_t* live_win = (const int64_t*)d[kSegLiveWin];
    const int64_t* live_base = (const int64_t*)d[kSegLiveBase];
    const int64_t n_live = d[kSegNLive];
    // the window's listed sequence: the last with live_win[s] <= t. The
    // warp's first window lies in listed sequence `base`; lane j holds the
    // entries of base + j, and each lane searches them over shuffles (they
    // rise with j; past the list they read as infinite). 32 windows lie in
    // at most 32 listed sequences, so the loop runs once; it would go on
    // to the next 32 otherwise.
    int64_t base = ((const int64_t*)d[kSegWarpSeq])[(t - lane) >> 5];
    int64_t start = 0;
    bool done = t >= n_win;
    while (__any_sync(kAll, !done)) {
      const int64_t j = base + lane;
      const bool in = j < n_live;
      const int64_t first = in ? live_win[j] : INT64_MAX;
      const int64_t end = in ? live_win[j + 1] : INT64_MAX;
      const int64_t at = in ? live_base[j] : 0;
      int k = 0;  // live_win[base] <= t for every lane not done
      for (int step = 16; step > 0; step >>= 1) {
        const int64_t v = __shfl_sync(kAll, first, k + step);
        if (v <= t) k += step;
      }
      const int64_t end_k = __shfl_sync(kAll, end, k);
      const int64_t at_k = __shfl_sync(kAll, at, k);
      if (!done && t < end_k) {
        start = at_k + t;
        done = true;
      }
      base += 32;
    }
    if (t >= n_win) continue;
    const uint32_t* words = (const uint32_t*)d[kSegWordsPtr];
    uint64_t h1, h2;
    hash_window(words + start, (int)d[kSegWidth], d[kSegNormalize] != 0, h1,
                h2);
    const int64_t o = d[kSegOut] + t;
    out_h1[o] = (int64_t)h1;
    out_h2[o] = (int64_t)h2;
  }
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

// segs: n_seg descriptors of kSegWords int64 words on the card, each with
// windows, in tile order; out: (2 n_total) int64 words, h1 then h2.
extern "C" int window_hash_segments_launch(const void* segs, int n_seg,
                                           long long n_tiles, void* out,
                                           long long n_total, void* stream) {
  if (n_tiles > 0) {
    static int grid_cap = 0;  // the card's SMs x resident blocks per SM
    if (grid_cap == 0) {
      int device = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&device);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, window_hash_segments_kernel, kThreads, 0);
      grid_cap = sms * (per_sm > 0 ? per_sm : 1);
    }
    const long long blocks = n_tiles < grid_cap ? n_tiles : grid_cap;
    int64_t* h = (int64_t*)out;
    window_hash_segments_kernel<<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
        (const int64_t*)segs, n_seg, (int64_t)n_tiles, h, h + n_total);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* window_hash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
