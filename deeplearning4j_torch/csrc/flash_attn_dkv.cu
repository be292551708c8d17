// K7: the flash-attention backward (FlashAttention-2) for dk and dv.
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/flash_attention.py
// `_dkv_kernel` (wrapper `dkv_block`). The semantics, bounds and design
// it shares with K6 are in flash_attn_dq.cu's note; K7 itself computes
// the transposed scores s^T = k . q^T, so that each warp's rows are its
// own keys and dk/dv accumulate in registers over the query tiles
// without atomics (q and do are staged twice, the second time
// transposed for dv = pd^T . do and dk = ds^T . q).
#include "flash_common.cuh"

namespace dl4j_flash {

// ------------------------------------------------------------------- K7
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ km, const T* __restrict__ dout,
                 const float* __restrict__ delta, const float* __restrict__ lse,
                 T* __restrict__ dk, T* __restrict__ dv, Params p) {
  constexpr int LD = DP + Pad<T>::v, LT = BN + Pad<T>::v;
  constexpr int NT = BN / 8, ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [BM][LD]
  T* vs = ks + BM * LD;                // [BM][LD]
  T* qs = vs + BM * LD;                // [BN][LD]
  T* dos = qs + BN * LD;               // [BN][LD]
  T* qt_s = dos + BN * LD;             // [DP][LT]   q transposed
  T* dot_s = qt_s + DP * LT;           // [DP][LT]   do transposed
  T* ps = dot_s + DP * LT;             // [kWarps][16][LT]
  float* lses = reinterpret_cast<float*>(ps + kWarps * 16 * LT);  // [BN]
  float* dels = lses + BN;                                        // [BN]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int d = p.d, bh = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * BM;
  const size_t qbase = (size_t)bh * p.Tq * d, kbase = (size_t)bh * p.Tk * d;
  const int row0 = k0 + warp * 16 + g;  // this thread's keys: row0, row0 + 8
  const uint32_t hbh = hash_bh(p.seed, bh);
  T* pw = ps + warp * 16 * LT;

  load_tile<T, BM, DP, false>(ks, LD, k + kbase + (size_t)k0 * d, d);
  load_tile<T, BM, DP, false>(vs, LD, v + kbase + (size_t)k0 * d, d);
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = km == nullptr || km[(size_t)bh * p.Tk + row0 + 8 * r] > 0.f;
  float dk_acc[ND][4], dv_acc[ND][4];
  zero(dk_acc);
  zero(dv_acc);

  // causal: a query tile is visible iff its last row reaches k0
  const int first = p.causal ? k0 / BN : 0;
  for (int qt = first; qt < p.Tq / BN; ++qt) {
    const int q0 = qt * BN;
    __syncthreads();
    load_tile<T, BN, DP, false>(qs, LD, q + qbase + (size_t)q0 * d, d);
    load_tile<T, BN, DP, true>(qt_s, LT, q + qbase + (size_t)q0 * d, d);
    load_tile<T, BN, DP, false>(dos, LD, dout + qbase + (size_t)q0 * d, d);
    load_tile<T, BN, DP, true>(dot_s, LT, dout + qbase + (size_t)q0 * d, d);
    for (int i = threadIdx.x; i < BN; i += blockDim.x) {
      lses[i] = lse[(size_t)bh * p.Tq + q0 + i];
      dels[i] = delta[(size_t)bh * p.Tq + q0 + i];
    }
    __syncthreads();

    float s[NT][4], dp[NT][4];  // transposed: rows keys, columns queries
    zero(s);
    zero(dp);
    tile_mma<T, NT, DP>(s, ks + warp * 16 * LD, LD, qs, LD, lane);
    tile_mma<T, NT, DP>(dp, vs + warp * 16 * LD, LD, dos, LD, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * p.scale;
        if (p.causal && row0 + 8 * r > q0 + c) x = kNeg;
        if (!key_ok[r]) x = kNeg;
        const float pr = x > 0.5f * kNeg ? expf(x - lses[c]) : 0.f;
        float pd = pr, dpv = dp[n][e];
        if (p.rate > 0.f) {
          const bool kp = keep_cell(hbh, (uint32_t)p.q_off + q0 + c, (uint32_t)p.k_off + row0 + 8 * r,
                                    p.rate);
          pd = kp ? pr * p.inv_keep : 0.f;
          dpv = kp ? dpv * p.inv_keep : 0.f;
        }
        s[n][e] = pd;
        dp[n][e] = pr * (dpv - dels[c]) * p.scale;  // ds
      }
    store_tile<T, NT>(pw, LT, s, lane);
    __syncwarp();
    tile_mma<T, ND, BN>(dv_acc, pw, LT, dot_s, LT, lane);
    __syncwarp();
    store_tile<T, NT>(pw, LT, dp, lane);
    __syncwarp();
    tile_mma<T, ND, BN>(dk_acc, pw, LT, qt_s, LT, lane);
    __syncwarp();
  }
  const float one[2] = {1.f, 1.f};
  const size_t out = kbase + (size_t)(k0 + warp * 16) * d;
  store_rows<T, ND>(dk + out, d, dk_acc, one, lane);
  store_rows<T, ND>(dv + out, d, dv_acc, one, lane);
}

template <typename T, int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* km, const void* dout,
               const void* delta, const void* lse, void* dk, void* dv, const Params& p,
               cudaStream_t stream) {
  constexpr int LD = DP + Pad<T>::v, LT = BN + Pad<T>::v;
  const size_t smem = (size_t)(2 * BM * LD + 2 * BN * LD + 2 * DP * LT + kWarps * 16 * LT)
                          * sizeof(T) + 2 * BN * sizeof(float);
  auto kernel = flash_dkv_kernel<T, DP>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3(p.Tk / BM, p.bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(km), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<const float*>(lse), static_cast<T*>(dk),
      static_cast<T*>(dv), p);
  return (int)cudaGetLastError();
}

template <typename T>
int run_dkv(const void* q, const void* k, const void* v, const void* km, const void* dout,
            const void* delta, const void* lse, void* dk, void* dv, const Params& p,
            cudaStream_t stream) {
  DL4J_FLASH_BY_DP(T, launch_dkv, q, k, v, km, dout, delta, lse, dk, dv, p, stream);
}

}  // namespace dl4j_flash

// Plain C entries bound with ctypes: q, do [bh, Tq, d], k, v [bh, Tk, d]
// and the gradients in one type (bf16 when is_bf16, else f32); delta, lse
// [bh, Tq] f32; km [bh, Tk] f32 or null. Tq, Tk multiples of 64, d <= 256
// (<= 128 for f32). Each returns a cudaError_t.
extern "C" int dl4j_flash_dkv(const void* q, const void* k, const void* v, const void* km,
                              const void* dout, const void* delta, const void* lse, void* dk,
                              void* dv, int bh, int Tq, int Tk, int d, int is_bf16, float scale,
                              int causal, float rate, float inv_keep, int seed, int q_off,
                              int k_off, void* stream) {
  using namespace dl4j_flash;
  const Params p{bh, Tq, Tk, d, scale, causal, rate, inv_keep, seed, q_off, k_off};
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return run_dkv<bf16>(q, k, v, km, dout, delta, lse, dk, dv, p, s);
  return run_dkv<float>(q, k, v, km, dout, delta, lse, dk, dv, p, s);
}
