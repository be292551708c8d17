// K6: the flash-attention backward (FlashAttention-2) for dq; K7 (dk/dv)
// is flash_attn_dkv.cu, with the same recomputation.
//
// K6 replaces the Pallas kernel `_dq_kernel` (wrapper `dq_block`) of
// deeplearning4j_tpu/ops/flash_attention.py, K7 `_dkv_kernel` (wrapper
// `dkv_block`). Both recompute the probabilities from the forward's global
// log-sum-exp, with delta = rowsum(do * o) formed outside (`rowwise_delta`):
//   s = (q . k^T) * scale, causal and key-mask cells -> -1e30
//   p = s > -0.5e30 ? exp(s - lse) : 0     (the s-guard: a row with no
//                                           visible key gets exactly 0)
//   dp = (do . v^T) * keep / (1 - rate)    (dropout regenerated by the hash)
//   ds = p * (dp - delta) * scale
//   K6: dq = T(ds) . k                      (ds rounded to k's type)
//   K7: dv = T(p * keep / (1 - rate))^T . do,  dk = T(ds)^T . q
// Causal positions are local to the call (k position <= q position, as the
// TPU kernels compare them), the dropout coordinates global (q_off, k_off),
// so the ring can call both on shards with Tq != Tk.
//
// What bounds them on an H100: operations. At b=4, h=8, T=8192, d=64
// causal, K6 runs three products (s, dp, dq: 412 GFLOP, 0.42 ms at 989
// TFLOP/s) and K7 four (s, dp, dv, dk: 550 GFLOP, 0.56 ms), against 170 and
// 203 MB of operands and results (0.05 and 0.06 ms at 3.35 TB/s).
//
// Design (simple first, as K5): four warps own 64 rows (queries in K6,
// keys in K7) and stream the other side in 64-row tiles through shared
// memory, causal tiles that no row can see skipped. K7 computes the
// transposed scores s^T = k . q^T, so that each warp's rows are its own
// keys and dk/dv accumulate in registers over the query tiles without
// atomics; K6 accumulates dq the same way over key tiles. The operands a
// product needs transposed (k in K6; q and do in K7) are staged twice.
#include "flash_common.cuh"

namespace dl4j_flash {

// ------------------------------------------------------------------- K6
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ km, const T* __restrict__ dout,
                const float* __restrict__ delta, const float* __restrict__ lse, T* __restrict__ dq,
                Params p) {
  constexpr int LD = DP + Pad<T>::v, LT = BN + Pad<T>::v;
  constexpr int NT = BN / 8, ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [BM][LD]
  T* dos = qs + BM * LD;               // [BM][LD]
  T* ks = dos + BM * LD;               // [BN][LD]
  T* vs = ks + BN * LD;                // [BN][LD]
  T* kt_s = vs + BN * LD;              // [DP][LT]   k transposed
  T* ps = kt_s + DP * LT;              // [kWarps][16][LT]
  float* kms = reinterpret_cast<float*>(ps + kWarps * 16 * LT);  // [BN]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int d = p.d, bh = blockIdx.y;
  const int nq = p.Tq / BM;
  const int qt = p.causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BM;
  const size_t qbase = (size_t)bh * p.Tq * d, kbase = (size_t)bh * p.Tk * d;
  const int row0 = q0 + warp * 16 + g;
  const uint32_t hbh = hash_bh(p.seed, bh);
  T* pw = ps + warp * 16 * LT;

  load_tile<T, BM, DP, false>(qs, LD, q + qbase + (size_t)q0 * d, d);
  load_tile<T, BM, DP, false>(dos, LD, dout + qbase + (size_t)q0 * d, d);
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = lse[(size_t)bh * p.Tq + row0 + 8 * r];
    del_r[r] = delta[(size_t)bh * p.Tq + row0 + 8 * r];
  }
  float acc[ND][4];
  zero(acc);

  const int nk_all = p.Tk / BN;
  const int nk = p.causal ? min(nk_all, (q0 + BM - 1) / BN + 1) : nk_all;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<T, BN, DP, false>(ks, LD, k + kbase + (size_t)k0 * d, d);
    load_tile<T, BN, DP, true>(kt_s, LT, k + kbase + (size_t)k0 * d, d);
    load_tile<T, BN, DP, false>(vs, LD, v + kbase + (size_t)k0 * d, d);
    if (km != nullptr)
      for (int i = threadIdx.x; i < BN; i += blockDim.x) kms[i] = km[(size_t)bh * p.Tk + k0 + i];
    __syncthreads();

    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    tile_mma<T, NT, DP>(s, qs + warp * 16 * LD, LD, ks, LD, lane);
    tile_mma<T, NT, DP>(dp, dos + warp * 16 * LD, LD, vs, LD, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * p.scale;
        if (p.causal && k0 + c > row0 + 8 * r) x = kNeg;
        if (km != nullptr && !(kms[c] > 0.f)) x = kNeg;
        const float pr = x > 0.5f * kNeg ? expf(x - lse_r[r]) : 0.f;
        float dpv = dp[n][e];
        if (p.rate > 0.f)
          dpv = keep_cell(hbh, (uint32_t)p.q_off + row0 + 8 * r, (uint32_t)p.k_off + k0 + c, p.rate)
                    ? dpv * p.inv_keep : 0.f;
        s[n][e] = pr * (dpv - del_r[r]) * p.scale;  // ds
      }
    store_tile<T, NT>(pw, LT, s, lane);
    __syncwarp();
    tile_mma<T, ND, BN>(acc, pw, LT, kt_s, LT, lane);
    __syncwarp();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T, ND>(dq + qbase + (size_t)(q0 + warp * 16) * d, d, acc, one, lane);
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* km, const void* dout,
              const void* delta, const void* lse, void* dq, const Params& p, cudaStream_t stream) {
  constexpr int LD = DP + Pad<T>::v, LT = BN + Pad<T>::v;
  const size_t smem = (size_t)(2 * BM * LD + 2 * BN * LD + DP * LT + kWarps * 16 * LT) * sizeof(T)
                      + BN * sizeof(float);
  auto kernel = flash_dq_kernel<T, DP>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3(p.Tq / BM, p.bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(km), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<const float*>(lse), static_cast<T*>(dq), p);
  return (int)cudaGetLastError();
}

template <typename T>
int run_dq(const void* q, const void* k, const void* v, const void* km, const void* dout,
           const void* delta, const void* lse, void* dq, const Params& p, cudaStream_t stream) {
  DL4J_FLASH_BY_DP(T, launch_dq, q, k, v, km, dout, delta, lse, dq, p, stream);
}

}  // namespace dl4j_flash

// Plain C entries bound with ctypes: q, do [bh, Tq, d], k, v [bh, Tk, d]
// and the gradients in one type (bf16 when is_bf16, else f32); delta, lse
// [bh, Tq] f32; km [bh, Tk] f32 or null. Tq, Tk multiples of 64, d <= 256
// (<= 128 for f32). Each returns a cudaError_t.
extern "C" int dl4j_flash_dq(const void* q, const void* k, const void* v, const void* km,
                             const void* dout, const void* delta, const void* lse, void* dq,
                             int bh, int Tq, int Tk, int d, int is_bf16, float scale, int causal,
                             float rate, float inv_keep, int seed, int q_off, int k_off,
                             void* stream) {
  using namespace dl4j_flash;
  const Params p{bh, Tq, Tk, d, scale, causal, rate, inv_keep, seed, q_off, k_off};
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return run_dq<bf16>(q, k, v, km, dout, delta, lse, dq, p, s);
  return run_dq<float>(q, k, v, km, dout, delta, lse, dq, p, s);
}
