// Shared declarations of the port's CUDA kernels.
//
// Every kernel is exported through a plain C launcher that takes raw device
// pointers and PyTorch's current stream, launches without synchronising and
// without allocating, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.  Packed hypervectors arrive as uint32_t
// words (the int32 tensors of the port carry the same bits).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HDC_EXPORT extern "C" __attribute__((visibility("default")))

// The most dynamic shared memory a block can have on this card (227 KB).
#define HDC_MAX_SMEM 232448

// Size a launch whose dynamic shared memory may exceed the 48 KB default.
template <typename Kernel>
static inline cudaError_t hdc_set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Asynchronous global -> shared copies (cp.async): every thread issues its
// part, a commit closes a group, and a wait lets at most N groups stay in
// flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bulk copies by the Tensor Memory Accelerator: one thread asks for a
// contiguous range, and an mbarrier in shared memory counts its bytes in.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Wait for the phase of `bar` with this parity; a copy that never lands
// traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 22)) __trap();
  }
}

// Table slabs.  A slab is the rows of eight channels [c0, c0 + 8) of a
// (C, K, W) uint32 table: codes 0..Kc-1 (Kc = min(K, 256): uint8 codes
// never reach further) and words [w0, w0 + wn), laid out (8, Kc, ws) in
// shared memory, ws = wn rounded up to even so that a lane can read two
// words at once; channels past C are left out.  `flat` (ws == wn == W,
// Kc == K, 16-byte aligned rows): the slab is one contiguous range of the
// table, and thread 0 has the TMA copy it, a bulk copy per channel,
// completing on `bar` (the caller waits there).  Otherwise every thread
// copies words with cp.async (the caller commits and waits).
__device__ __forceinline__ void stage_slab(uint32_t* dst, const uint32_t* tab, int c0,
                                           int C, int K, int W, int Kc, int w0, int wn,
                                           int ws, bool flat, uint64_t* bar) {
  const int nq = min(8, C - c0);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (flat) {
    if (tid == 0) {
      const unsigned bytes = (unsigned)(K * W * 4);
      const uint32_t* src = tab + (long long)c0 * K * W;
      // the slab's last reads (generic proxy) come before the TMA's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(bar)),
                   "r"(bytes * nq)
                   : "memory");
      for (int q = 0; q < nq; ++q)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
            "%2, [%3];\n" ::"r"(smem_addr(dst + q * K * W)),
            "l"(src + (long long)q * K * W), "r"(bytes), "r"(smem_addr(bar))
            : "memory");
    }
  } else {
    const int n = nq * Kc * wn;
    for (int i = tid; i < n; i += nt) {
      const int row = i / wn, part = i - row * wn;
      const int q = row / Kc, code = row - q * Kc;
      cp_async4(dst + row * ws + part, tab + ((long long)(c0 + q) * K + code) * W + w0 + part);
    }
  }
}

// Out-of-alphabet codes clamp to K - 1: four packed uint8 codes at once
// with __vminu4 against this word (nothing to clamp from K = 256).
static inline uint32_t codes_kmax4(int K) {
  return K >= 256 ? 0xffffffffu : (uint32_t)(K - 1) * 0x01010101u;
}

__host__ __device__ static inline size_t slab_words(int K, int ws) {
  return (size_t)8 * (K < 256 ? K : 256) * ws;
}

// 32 x 32 bit transpose across a warp: lane j holds word j on entry; on
// exit lane b holds the word whose bit j is bit b of lane j's entry word
// (hv.bit_transpose32's LSB-first cycle order).  Each stage swaps the
// off-diagonal blocks of size s between lanes j and j ^ s: five shuffles in
// place of 32 ballots.
__device__ __forceinline__ uint32_t warp_transpose32(uint32_t v, int lane) {
  const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u,
                             0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t m = masks[i];  // the bits b with b & s == 0
    const uint32_t t = __shfl_xor_sync(0xffffffffu, v, s);
    v = (lane & s) ? ((v & ~m) | ((t & ~m) >> s)) : ((v & m) | ((t & m) << s));
  }
  return v;
}
