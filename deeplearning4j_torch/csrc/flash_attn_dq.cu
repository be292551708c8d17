// K6: the flash-attention backward (FlashAttention-2) for dq; K7 (dk/dv)
// is flash_attn_dkv.cu, with the same recomputation.
//
// K6 replaces the Pallas kernel `_dq_kernel` (wrapper `dq_block`) of
// deeplearning4j_tpu/ops/flash_attention.py, K7 `_dkv_kernel` (wrapper
// `dkv_block`). Both recompute the probabilities from the forward's global
// log-sum-exp, with delta = rowsum(do * o) formed outside (`rowwise_delta`):
//   s = (q . k^T) * scale, causal and key-mask cells -> -1e30
//   p = s > -0.5e30 ? exp(s - lse) : 0     (the s-guard: a row with no
//                                           visible key gets exactly 0;
//                                           the wgmma route forms it as
//                                           exp2(s log2e - lse log2e) and
//                                           gives every masked cell 0)
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
// Design for bf16 operands with a head width that pads to 64 or 128 (the
// main path; the shared pieces are in flash_hopper.cuh): a block owns 128
// queries, 64 for each of two consumer warpgroups, whose q and do tiles
// stay in shared memory, blocks with the most causal work first. The
// producer warp streams the 64-key tiles of k and v (and the key mask) by
// TMA through a ring of kStages stages, stopping at the last tile a causal
// row can see. Per tile a consumer issues s = q . k^T and dp = do . v^T as
// two wgmma groups (q, do the resident A, the k and v stages the K-major
// B); while dp is formed it turns s into p in the accumulator registers,
// then ds, rounded to bf16 as the register A fragments of dq += ds . k,
// whose B is the same k stage read MN-major: nothing is staged transposed.
// A tile's dq products finish before its stage is released (on an H100,
// letting them run under the next tile's scores gained at most 3% at
// d = 64 and lost about 30% at d = 128).
//
// f32 operands (wgmma would round them to TF32) and other bf16 widths keep
// the body written first (CUDA-core / mma.sync below): four warps own 64
// queries and stream 64-key tiles through shared memory, k staged twice
// (the second time transposed) for dq = ds . k.
#include "flash_hopper.cuh"

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

// ------------------------------------------------------- K6, wgmma route
namespace hopper {

// Shared memory of one block, in bytes from a 1024-byte aligned base.
template <int DP>
struct DqLayout {
  static constexpr int TB = kRows * DP * 2;             // one 64-row tile
  static constexpr int Q = 0;                           // [2][TB], resident
  static constexpr int DO = Q + 2 * TB;                 // [2][TB], resident
  static constexpr int K = DO + 2 * TB;                 // [kStages][TB]
  static constexpr int V = K + kStages * TB;            // [kStages][TB]
  static constexpr int KM = V + kStages * TB;           // [kStages][64] f32 key mask
  static constexpr int BAR = KM + kStages * kRows * 4;  // full, empty [kStages]; res
  static constexpr int BYTES = BAR + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ km, const float* __restrict__ delta,
               const float* __restrict__ lse, T* __restrict__ dq, Params p) {
  static_assert(sizeof(T) == 2 && (DP == 64 || DP == 128), "bf16, d padded to 64 or 128");
  using L = DqLayout<DP>;
  constexpr int NC = DP / 64, KS = DP / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* sp = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR, empty = full + 8 * kStages, res = empty + 8 * kStages;
  const int bh = blockIdx.y;
  const int nb = (p.Tq + kBlockRows - 1) / kBlockRows;
  const int q0 = (p.causal ? nb - 1 - (int)blockIdx.x : (int)blockIdx.x) * kBlockRows;
  const int nk_all = p.Tk / kRows;
  const int last_q = min(q0 + kBlockRows, p.Tq) - 1;
  const int nk = p.causal ? min(nk_all, last_q / kRows + 1) : nk_all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(res, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumerThreads / 128) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(res, 4 * NC * kChunkBytes);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load(base + L::Q + w * L::TB + c * kChunkBytes, &tq, res, 64 * c, q0 + kRows * w, bh);
          tma_load(base + L::DO + w * L::TB + c * kChunkBytes, &tdo, res, 64 * c, q0 + kRows * w,
                   bh);
        }
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages, k0 = it * kRows;
        const uint32_t bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar, 2 * NC * kChunkBytes + (km != nullptr ? kRows * 4 : 0));
        for (int c = 0; c < NC; ++c) {
          tma_load(base + L::K + s * L::TB + c * kChunkBytes, &tk, bar, 64 * c, k0, bh);
          tma_load(base + L::V + s * L::TB + c * kChunkBytes, &tv, bar, 64 * c, k0, bh);
        }
        if (km != nullptr)
          bulk_load(base + L::KM + s * kRows * 4, km + (size_t)bh * p.Tk + k0, kRows * 4, bar);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + kRows * wg;       // the warpgroup's first query
    const int row0 = qw0 + 16 * warp + g;  // the thread's queries: row0, row0 + 8
    const bool valid = qw0 < p.Tq;
    const uint32_t hbh = hash_bh(p.seed, bh);
    const float scale_log2 = p.scale * kLog2e;
    float lse_l2[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};
    if (valid) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse_l2[r] = lse[(size_t)bh * p.Tq + row0 + 8 * r] * kLog2e;
        del_r[r] = delta[(size_t)bh * p.Tq + row0 + 8 * r];
      }
    }
    float acc[NC][32], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      st[i] = dpt[i] = 0.f;
#pragma unroll
      for (int h = 0; h < NC; ++h) acc[h][i] = 0.f;
    }
    uint32_t da[4][4];
    const uint32_t qt = base + L::Q + wg * L::TB, dot = base + L::DO + wg * L::TB;
    mbar_wait(res, 0);
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages, k0 = it * kRows;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      if (!valid || (p.causal && k0 > qw0 + kRows - 1)) {  // no query sees this tile
        release(empty + 8 * s);
        continue;
      }
      const uint32_t kst = base + L::K + s * L::TB, vs = base + L::V + s * L::TB;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_ss(st, kmajor(qt, ks), kmajor(kst, ks), ks);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_ss(dpt, kmajor(dot, ks), kmajor(vs, ks), ks);
      wgmma_commit();
      wgmma_wait<1>();  // s is in
      fence_regs(st);

      const float* kms = km != nullptr ? reinterpret_cast<const float*>(sp + L::KM + s * kRows * 4)
                                       : nullptr;
      const bool diag = p.causal && k0 + kRows - 1 > qw0;  // a key past a query
      // pass 1, while dp is formed: p into st
      with_flags(kms != nullptr, diag, [&](auto masked, auto on_diag) {
        constexpr bool kMasked = decltype(masked)::value, kDiag = decltype(on_diag)::value;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c0 = 8 * j + 2 * t;
          bool kok[2] = {true, true};
          if constexpr (kMasked) {
            const float2 m2 = *reinterpret_cast<const float2*>(kms + c0);
            kok[0] = m2.x > 0.f;
            kok[1] = m2.y > 0.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, r = e >> 1, key = k0 + c0 + (e & 1), qry = row0 + 8 * r;
            const bool vis = kok[e & 1] && !(kDiag && key > qry);
            st[i] = vis ? exp2f(fmaf(st[i], scale_log2, -lse_l2[r])) : 0.f;
          }
        }
      });
      wgmma_wait<0>();  // dp is in
      fence_regs(dpt);
      // pass 2: ds into the A fragments da
      const auto ds_pass = [&](auto drop) {
        constexpr bool kDrop = decltype(drop)::value;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, r = e >> 1;
            float dpv = dpt[i];
            if constexpr (kDrop)
              dpv = keep_cell(hbh, (uint32_t)p.q_off + row0 + 8 * r,
                              (uint32_t)p.k_off + k0 + 8 * j + 2 * t + (e & 1), p.rate)
                        ? dpv * p.inv_keep : 0.f;
            ds[e] = st[i] * (dpv - del_r[r]) * p.scale;
          }
          da[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
          da[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
        }
      };
      if (p.rate > 0.f) ds_pass(std::true_type{});
      else ds_pass(std::false_type{});
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[h], da[kk], mnmajor(kst, h, kk));
      wgmma_commit();
      wgmma_wait<0>();
      release(empty + 8 * s);
    }
#pragma unroll
    for (int h = 0; h < NC; ++h) fence_regs(acc[h]);
    if (valid) store_acc<NC>(dq + (size_t)bh * p.Tq * p.d, acc, row0, p.Tq, p.d, t);
  }
}

template <typename T, int DP>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* km, const void* dout,
                    const void* delta, const void* lse, void* dq, const Params& p,
                    cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = make_map(&tq, q, p.bh, p.Tq, p.d)) || (err = make_map(&tk, k, p.bh, p.Tk, p.d))
      || (err = make_map(&tv, v, p.bh, p.Tk, p.d)) || (err = make_map(&tdo, dout, p.bh, p.Tq, p.d)))
    return err;
  constexpr int smem = DqLayout<DP>::BYTES;
  auto kernel = flash_dq_wgmma<T, DP>;
  if ((err = set_smem(kernel, smem))) return err;
  kernel<<<dim3((p.Tq + kBlockRows - 1) / kBlockRows, p.bh), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(km), static_cast<const float*>(delta),
      static_cast<const float*>(lse), static_cast<T*>(dq), p);
  return (int)cudaGetLastError();
}

inline int run_dq_wgmma(const void* q, const void* k, const void* v, const void* km,
                        const void* dout, const void* delta, const void* lse, void* dq,
                        const Params& p, cudaStream_t stream) {
  if (p.d <= 64) return launch_dq_wgmma<bf16, 64>(q, k, v, km, dout, delta, lse, dq, p, stream);
  return launch_dq_wgmma<bf16, 128>(q, k, v, km, dout, delta, lse, dq, p, stream);
}

}  // namespace hopper

}  // namespace dl4j_flash

// Plain C entries bound with ctypes: q, do [bh, Tq, d], k, v [bh, Tk, d]
// and the gradients in one type (bf16 when is_bf16, else f32); delta, lse
// [bh, Tq] f32; km [bh, Tk] f32 or null. Tq, Tk multiples of 64, d <= 256
// (<= 128 for f32). The route is static: bf16 with d in (32, 128] and a
// multiple of 8 takes the wgmma kernel, everything else the body above.
// Returns a cudaError_t.
extern "C" int dl4j_flash_dq(const void* q, const void* k, const void* v, const void* km,
                             const void* dout, const void* delta, const void* lse, void* dq,
                             int bh, int Tq, int Tk, int d, int is_bf16, float scale, int causal,
                             float rate, float inv_keep, int seed, int q_off, int k_off,
                             void* stream) {
  using namespace dl4j_flash;
  const Params p{bh, Tq, Tk, d, scale, causal, rate, inv_keep, seed, q_off, k_off};
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper::wgmma_route(is_bf16, d))
    return hopper::run_dq_wgmma(q, k, v, km, dout, delta, lse, dq, p, s);
  if (is_bf16) return run_dq<bf16>(q, k, v, km, dout, delta, lse, dq, p, s);
  return run_dq<float>(q, k, v, km, dout, delta, lse, dq, p, s);
}
