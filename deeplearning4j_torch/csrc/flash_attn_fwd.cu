// K5: flash-attention forward (FlashAttention-2 online softmax) -> o, lse.
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/flash_attention.py
// `_fwd_kernel` (wrapper `_fwd`), bit for bit in its semantics:
//   s = (q . k^T) * scale   in f32 from operands in their own type
//   causal: k position > q position -> s = -1e30; key mask <= 0 -> -1e30
//   online softmax over key tiles: m, l (l sums the UNDROPPED p),
//   acc = acc * alpha + bf16(drop(p)) . v   (p rounded to v's type)
//   o = acc / l; lse = m + log(l); a row with no visible key: o = 0,
//   lse = -1e30 (the backward's s-guard then zeroes its gradients)
// Dropout keeps a cell by the counter hash of `_keep_from_coords` over the
// global (bh, q_off + i, k_off + j), identical in K6 and K7.
//
// What bounds it on an H100: operations. At b=4, h=8, T=8192, d=64 causal
// it does 2 x 2 x 32 x 8192^2 / 2 x 64 = 275 GFLOP of bf16 products (0.28
// ms at 989 TFLOP/s) against 134 MB of q, k, v, o (0.04 ms at 3.35 TB/s).
//
// Design (simple first): one block of four warps per (64 query rows, bh);
// the block stages its q tile once, then walks the key tiles, causal
// blocks past the diagonal skipped (heaviest query tiles scheduled first).
// Each warp owns 16 query rows: S = Q K^T by mma.sync into registers, the
// online softmax on the accumulators (row stats reduced over the quad that
// holds a row), P written to a per-warp shared tile in v's type, then
// O += P V from shared memory with V staged transposed. No cp.async
// pipelining, wgmma or TMA yet: those are for the PR that makes it fast.
#include "flash_common.cuh"

namespace dl4j_flash {

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ km, T* __restrict__ o, float* __restrict__ lse,
                 Params p) {
  constexpr int LD = DP + Pad<T>::v, LT = BN + Pad<T>::v;
  constexpr int NT = BN / 8, ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [BM][LD]
  T* ks = qs + BM * LD;                // [BN][LD]
  T* vt = ks + BN * LD;                // [DP][LT]   v transposed
  T* ps = vt + DP * LT;                // [kWarps][16][LT]
  float* kms = reinterpret_cast<float*>(ps + kWarps * 16 * LT);  // [BN]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int T_ = p.Tq, d = p.d, bh = blockIdx.y;
  const int nq = T_ / BM;
  const int qt = p.causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BM;
  const size_t base = (size_t)bh * T_ * d;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t hbh = hash_bh(p.seed, bh);
  T* pw = ps + warp * 16 * LT;

  load_tile<T, BM, DP, false>(qs, LD, q + base + (size_t)q0 * d, d);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[ND][4];
  zero(acc);

  const int nk = p.causal ? (q0 + BM - 1) / BN + 1 : T_ / BN;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BN, DP, false>(ks, LD, k + base + (size_t)k0 * d, d);
    load_tile<T, BN, DP, true>(vt, LT, v + base + (size_t)k0 * d, d);
    if (km != nullptr)
      for (int i = threadIdx.x; i < BN; i += blockDim.x) kms[i] = km[(size_t)bh * T_ + k0 + i];
    __syncthreads();

    float s[NT][4];
    zero(s);
    tile_mma<T, NT, DP>(s, qs + warp * 16 * LD, LD, ks, LD, lane);

    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * p.scale;
        if (p.causal && k0 + c > row0 + 8 * r) x = kNeg;
        if (km != nullptr && !(kms[c] > 0.f)) x = kNeg;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        float pr = expf(s[n][e] - m[r]);
        rs[r] += pr;
        if (p.rate > 0.f)
          pr = keep_cell(hbh, (uint32_t)p.q_off + row0 + 8 * r, (uint32_t)p.k_off + k0 + c, p.rate)
                   ? pr * p.inv_keep : 0.f;
        s[n][e] = pr;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
    store_tile<T, NT>(pw, LT, s, lane);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    __syncwarp();
    tile_mma<T, ND, BN>(acc, pw, LT, vt, LT, lane);
    __syncwarp();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = m[r] > 0.5f * kNeg;
    const float lr = fmaxf(l[r], 1e-30f);
    inv[r] = valid ? 1.0f / lr : 0.f;
    if (t == 0) lse[(size_t)bh * T_ + row0 + 8 * r] = valid ? m[r] + logf(lr) : kNeg;
  }
  store_rows<T, ND>(o + base + (size_t)(q0 + warp * 16) * d, d, acc, inv, lane);
}

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, const void* km, void* o, void* lse,
               const Params& p, cudaStream_t stream) {
  constexpr int LD = DP + Pad<T>::v, LT = BN + Pad<T>::v;
  const size_t smem = (size_t)(BM * LD + BN * LD + DP * LT + kWarps * 16 * LT) * sizeof(T)
                      + BN * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DP>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3(p.Tq / BM, p.bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(km), static_cast<T*>(o), static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

template <typename T>
int run_fwd(const void* q, const void* k, const void* v, const void* km, void* o, void* lse,
            const Params& p, cudaStream_t stream) {
  DL4J_FLASH_BY_DP(T, launch_fwd, q, k, v, km, o, lse, p, stream);
}

}  // namespace dl4j_flash

// Plain C entry bound with ctypes: q, k, v, o [bh, T, d] in one type (bf16
// when is_bf16, else f32), lse [bh, T] f32, km [bh, T] f32 or null. T a
// multiple of 64, d <= 256 (<= 128 for f32). Returns a cudaError_t.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v, const void* km,
                              void* o, void* lse, int bh, int T, int d, int is_bf16, float scale,
                              int causal, float rate, float inv_keep, int seed, int q_off,
                              int k_off, void* stream) {
  using namespace dl4j_flash;
  const Params p{bh, T, T, d, scale, causal, rate, inv_keep, seed, q_off, k_off};
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return run_fwd<bf16>(q, k, v, km, o, lse, p, s);
  return run_fwd<float>(q, k, v, km, o, lse, p, s);
}
