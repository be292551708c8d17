// Hopper pieces of the persistent-LSTM kernels: tensor-core products of
// the exchanged recurrent rows, fed by cp.async copies issued several
// chunks ahead. Used by the bf16 routes of K4 (lstm_fused_bwd.cu), K1
// (lstm_cell.cu) and K2 (lstm_cell_bwd.cu); lstm_common.cuh keeps the
// CUDA-core pieces of the other bodies.
//
// The product. A block owns a few hidden units; each phase it contracts the
// exchanged rows X [B, K] (bf16, written by every block before the grid
// barrier) with the block's weight rows Wu [n, K] (bf16, resident in
// shared memory): out[r, j] = sum_k X[r, k] * Wu[j, k], f32 accumulation.
// `mma.sync` m16n8k16 takes A = 16 rows of X and B = 8 weight rows.
//
// Fragments straight from 16-byte loads. A sum over k does not depend on
// the order of k, so each 32-wide chunk of k is fed to two m16n8k16 steps
// in a permuted order under which lane (g, t) of a warp (g = lane / 4,
// t = lane % 4) needs exactly the 8 consecutive values at k = 32c + 8t of
// its rows (g and g + 8 of X, weight row g): one 16-byte load each. Step s
// takes 32-bit words 2s and 2s + 1 of those 16 bytes as the fragment's
// "k = 2t, 2t+1" and "k = 2t+8, 2t+9" halves, for A and B alike, so both
// operands see the same permutation and the product is the plain sum.
//
// Memory model. X was written with ordinary stores by other blocks before
// a grid.sync(). cp.async (not the bulk/TMA form) runs in the generic proxy,
// so the barrier's fence orders those stores before these copies and no
// fence.proxy.async is needed; .cg reads through L2 only (L1 is not
// coherent across SMs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dl4j {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only.
__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes global -> shared (data written by an earlier kernel: L1 may hold it).
__device__ __forceinline__ void cp_async4_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a . b, one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                          unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The two m16n8k16 steps of one 32-wide k chunk: lo/hi are lane (g, t)'s
// 16 bytes of X rows g and g + 8, w its 16 bytes of weight row g.
__device__ __forceinline__ void mma_chunk32(float (&d)[4], const uint4& lo, const uint4& hi,
                                            const uint4& w) {
  mma_16816(d, lo.x, hi.x, lo.y, hi.y, w.x, w.y);
  mma_16816(d, lo.z, hi.z, lo.w, hi.w, w.z, w.w);
}

// Row stride (elements) of a resident [n][K] bf16 weight slice: K padded so
// that consecutive rows start 64 bytes apart modulo 128, which makes each
// quarter-warp's 16-byte loads (rows g, g+1 at the same k) conflict-free.
__host__ __device__ __forceinline__ int padded_row(int K) { return K % 64 == 0 ? K + 32 : K; }

// ---- One m-tile's product, for the one-layer bodies (K1, K2) ----

// Bytes of one ring stage of rows_product: rows g and g + 8 of one 32-wide
// chunk of X, 16 bytes a lane.
constexpr int kRowsStageBytes = 2 * 32 * 16;

// One warp's share of out[r, n] = sum_k X[r, k] * Wr[n, k] for the 16 rows
// r = 16m .. 16m+15 of X [B, K] (bf16 in global memory, written by other
// blocks before a grid barrier) and 8 * NT weight rows Wr resident in
// shared memory (bf16, row stride WP; n-tile nt is rows 8nt .. 8nt+7). The
// warp takes the 32-wide k chunks kg, kg + KG, ... < ceil(K / 32). X's
// 16-byte pieces at k >= K read as zeros (Wr holds zeros there), so K need
// only be a multiple of 8. Each lane copies its pieces of rows g and g + 8
// with cp.async.cg into a ring of STAGES chunks (all of them in flight
// before the first wait) and reads back only its own, and the warp leaves
// its [16 x 8NT] f32 partial tile at the start of the ring, row-major.
// Rows past B read row B - 1: their sums are never to be used.
template <int NT, int STAGES>
__device__ __forceinline__ void rows_product(const __nv_bfloat16* x, int B, int K,
                                             const __nv_bfloat16* w_s, int WP, int kg, int KG,
                                             int m, unsigned char* ring) {
  static_assert(NT * 16 * 8 * sizeof(float) <= STAGES * kRowsStageBytes, "the tile fits the ring");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* xa = x + (size_t)min(16 * m + g, B - 1) * K + 8 * t;
  const __nv_bfloat16* xb = x + (size_t)min(16 * m + g + 8, B - 1) * K + 8 * t;
  const __nv_bfloat16* w0 = w_s + (size_t)g * WP + 8 * t;
  const int n = ((K + 31) / 32 - kg + KG - 1) / KG;
  unsigned char* mine = ring + lane * 16;
  auto issue = [&](int i) {
    if (i < n) {
      const int k0 = 32 * (kg + i * KG);
      unsigned char* d = mine + (i % STAGES) * kRowsStageBytes;
      if (k0 + 8 * t < K) {
        cp_async16_cg(d, xa + k0);
        cp_async16_cg(d + 512, xb + k0);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(d + 512) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };
  float acc[NT][4] = {};
#pragma unroll
  for (int i = 0; i < STAGES; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 1>();  // chunk i has landed (this lane's own copies)
    const unsigned char* d = mine + (i % STAGES) * kRowsStageBytes;
    const uint4 lo = *reinterpret_cast<const uint4*>(d);
    const uint4 hi = *reinterpret_cast<const uint4*>(d + 512);
    const __nv_bfloat16* w = w0 + 32 * (kg + i * KG);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_chunk32(acc[nt], lo, hi, *reinterpret_cast<const uint4*>(w + (size_t)8 * nt * WP));
    issue(i + STAGES);  // refills the slot just read
  }
  cp_async_wait<0>();
  __syncwarp();  // every lane's copies have landed before the tile overwrites the ring
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(part + g * 8 * NT + 8 * nt + 2 * t) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(part + (g + 8) * 8 * NT + 8 * nt + 2 * t) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

}  // namespace dl4j
