// What the two chain-DP kernels share, K3 (chain_contig.cu, the
// read-vs-contig DP) and K4 (chain_dp.cu, the correction read mapper's DP),
// for Hopper (sm_90a): how a block finds its groups and brings their anchors
// into shared memory.
//
// Block b takes per_block consecutive groups, per_block chosen at launch so
// that they hold about a tile of anchors (block_groups: no search of the
// offsets). The anchors of those that fit in `cap` form one contiguous span,
// which TMA bulk copies bring into shared memory (span_range, bulk_load), so
// every device-memory load of an input is a coalesced one; groups past the
// span run from device memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace chain_band {

// --- PTX helpers: the TMA bulk copy and its mbarrier ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: an mbarrier expecting one arrival (with its bytes).
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread, before its bulk copies: the arrival, and the bytes the copies
// will bring.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16) from 16-byte-aligned device memory `src` to
// 16-byte-aligned shared memory `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, uintptr_t src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every thread: wait until the barrier's phase `parity` has completed. A
// copy that never completes faults the kernel (after 2^22 polls, each of
// which may wait a little) rather than hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 22)) __trap();
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// --- end of PTX helpers ---

// The 16-byte-aligned device-memory range that holds elements [lo, hi) of an
// array of `es`-byte elements at `base`: its start, its bytes (a multiple of
// 16) and the number of elements before lo in it. The range reaches at most
// 15 bytes past either end of the elements, which stays inside the array's
// allocation: PyTorch's CUDA allocator hands out 512-byte-aligned blocks of
// whole multiples of 512 bytes.
struct Range {
  uintptr_t src;
  uint32_t bytes;
  int pad;
};

__device__ __forceinline__ Range span_range(const void* base, int64_t lo,
                                            int64_t hi, int es) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base) + (uintptr_t)(lo * es);
  const uintptr_t b = reinterpret_cast<uintptr_t>(base) + (uintptr_t)(hi * es);
  const uintptr_t a16 = a & ~(uintptr_t)15;
  const uintptr_t b16 = (b + 15) & ~(uintptr_t)15;
  return {a16, (uint32_t)(b16 - a16), (int)((a - a16) / es)};
}

// Shared memory for `cap` staged elements of `es` bytes, with room for the
// alignment of both ends; a multiple of 16 when cap is.
__host__ __device__ constexpr int staged_bytes(int cap, int es) {
  return cap * es + 32;
}

// A block's groups: [g0, g1), `per_block` consecutive groups (the launch
// picks per_block so that a block's groups hold about a tile of anchors);
// [g0, g_span) are those whose anchors fit in `cap` staged anchors, the span
// [lo, hi); the rest, [g_span, g1), run from device memory.
struct Tile {
  int64_t g0, g_span, g1, lo, hi;
};

// Every thread of a block of NT: the block's Tile. The groups that fit are a
// prefix (offsets rise), counted NT at a time with __syncthreads_count.
template <int NT>
__device__ __forceinline__ Tile block_groups(const int64_t* offsets,
                                             int64_t n_groups,
                                             int64_t per_block, int cap) {
  Tile t;
  t.g0 = (int64_t)blockIdx.x * per_block;
  t.g1 = min(t.g0 + per_block, n_groups);
  t.lo = offsets[t.g0];
  int64_t fit = 0;
  for (int64_t base = t.g0; base < t.g1; base += NT) {
    const int64_t g = base + threadIdx.x;
    fit += __syncthreads_count(g < t.g1 && offsets[g + 1] - t.lo <= cap);
  }
  t.g_span = t.g0 + fit;
  t.hi = offsets[t.g_span];
  return t;
}

}  // namespace chain_band
