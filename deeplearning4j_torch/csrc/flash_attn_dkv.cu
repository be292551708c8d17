// K7: the flash-attention backward (FlashAttention-2) for dk and dv.
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/flash_attention.py
// `_dkv_kernel` (wrapper `dkv_block`). The semantics and bounds it shares
// with K6 are in flash_attn_dq.cu's note; K7 computes the transposed
// scores s^T = k . q^T, so that a consumer's rows are its own keys and
// dk/dv accumulate in registers over the query tiles without atomics.
//
// Design for bf16 operands with a head width that pads to 64 or 128 (the
// main path; the shared pieces are in flash_hopper.cuh): a block owns 128
// keys, 64 for each of two consumer warpgroups, whose k and v tiles stay in
// shared memory. The producer warp streams the 64-query tiles of q and do,
// with their lse and delta, by TMA through a ring of kStages stages. Per
// tile a consumer forms s^T = k . q^T and dp^T = v . do^T with wgmma (k, v
// the resident A, the q and do stages the K-major B), then p^T, the
// dropped pd^T and ds^T in the accumulator registers, rounded to bf16 as
// the register A fragments of dv += pd^T . do and dk += ds^T . q, whose B
// is the same q and do stage read MN-major: nothing is staged transposed.
// A tile's products finish before its stage is released and the next
// tile's scores start: letting the dv/dk products run under the next
// tile's scores, the stage released a tile later, made K7 slower on an
// H100 (1.95 ms against 1.73-1.75 at the TransformerLM's shape); so did
// splitting the tile into a p pass under the dp product and a ds pass
// under the dv product, as K6 does (2.16 ms; it is 21% faster at d = 128).
//
// f32 operands (wgmma would round them to TF32) and other bf16 widths keep
// the CUDA-core / mma.sync body below, written first: four warps own 64
// keys and stage q and do twice (the second time transposed) per tile.
#include "flash_hopper.cuh"

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

// ------------------------------------------------------- K7, wgmma route
namespace hopper {

// Shared memory of one block, in bytes from a 1024-byte aligned base.
template <int DP>
struct DkvLayout {
  static constexpr int TB = kRows * DP * 2;               // one 64-row tile
  static constexpr int K = 0;                             // [2][TB], resident
  static constexpr int V = K + 2 * TB;                    // [2][TB], resident
  static constexpr int Q = V + 2 * TB;                    // [kStages][TB]
  static constexpr int DO = Q + kStages * TB;             // [kStages][TB]
  static constexpr int LSE = DO + kStages * TB;           // [kStages][64] f32
  static constexpr int DEL = LSE + kStages * kRows * 4;   // [kStages][64] f32
  static constexpr int BAR = DEL + kStages * kRows * 4;   // full, empty [kStages]; kv
  static constexpr int BYTES = BAR + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ km, const float* __restrict__ delta,
                const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv, Params p) {
  static_assert(sizeof(T) == 2 && (DP == 64 || DP == 128), "bf16, d padded to 64 or 128");
  using L = DkvLayout<DP>;
  constexpr int NC = DP / 64, KS = DP / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* sp = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR, empty = full + 8 * kStages, kv = empty + 8 * kStages;
  const int bh = blockIdx.y, k0 = blockIdx.x * kBlockRows;
  const int nq = p.Tq / kRows;
  // causal: query tiles before the one holding query k0 see none of the keys
  const int first = p.causal ? min(k0 / kRows, nq) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(kv, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumerThreads / 128) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(kv, 4 * NC * kChunkBytes);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load(base + L::K + w * L::TB + c * kChunkBytes, &tk, kv, 64 * c, k0 + kRows * w, bh);
          tma_load(base + L::V + w * L::TB + c * kChunkBytes, &tv, kv, 64 * c, k0 + kRows * w, bh);
        }
      for (int it = 0; first + it < nq; ++it) {
        const int s = it % kStages, q0 = (first + it) * kRows;
        const uint32_t bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar, 2 * NC * kChunkBytes + 2 * kRows * 4);
        for (int c = 0; c < NC; ++c) {
          tma_load(base + L::Q + s * L::TB + c * kChunkBytes, &tq, bar, 64 * c, q0, bh);
          tma_load(base + L::DO + s * L::TB + c * kChunkBytes, &tdo, bar, 64 * c, q0, bh);
        }
        bulk_load(base + L::LSE + s * kRows * 4, lse + (size_t)bh * p.Tq + q0, kRows * 4, bar);
        bulk_load(base + L::DEL + s * kRows * 4, delta + (size_t)bh * p.Tq + q0, kRows * 4, bar);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kw0 = k0 + kRows * wg;       // the warpgroup's first key
    const int key0 = kw0 + 16 * warp + g;  // the thread's keys: key0, key0 + 8
    const uint32_t hbh = hash_bh(p.seed, bh);
    const float scale_log2 = p.scale * kLog2e;
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      key_ok[r] = key0 + 8 * r < p.Tk
                  && (km == nullptr || km[(size_t)bh * p.Tk + key0 + 8 * r] > 0.f);
    float dk_acc[NC][32], dv_acc[NC][32], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      st[i] = dpt[i] = 0.f;
#pragma unroll
      for (int h = 0; h < NC; ++h) dk_acc[h][i] = dv_acc[h][i] = 0.f;
    }
    uint32_t pa[4][4], da[4][4];
    const uint32_t kt = base + L::K + wg * L::TB, vt = base + L::V + wg * L::TB;
    mbar_wait(kv, 0);
    for (int it = 0; first + it < nq; ++it) {
      const int s = it % kStages, q0 = (first + it) * kRows;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      if (kw0 >= p.Tk || (p.causal && kw0 > q0 + kRows - 1)) {  // no key sees this tile
        release(empty + 8 * s);
        continue;
      }
      const uint32_t qs = base + L::Q + s * L::TB, dos = base + L::DO + s * L::TB;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_ss(st, kmajor(kt, ks), kmajor(qs, ks), ks);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_ss(dpt, kmajor(vt, ks), kmajor(dos, ks), ks);
      wgmma_commit();
      wgmma_wait<0>();  // s^T and dp^T are in
      fence_regs(st);
      fence_regs(dpt);

      const float* ls = reinterpret_cast<const float*>(sp + L::LSE + s * kRows * 4);
      const float* dl = reinterpret_cast<const float*>(sp + L::DEL + s * kRows * 4);
      const bool diag = p.causal && kw0 + kRows - 1 > q0;  // a key past a query
      // p^T, pd^T and ds^T, rounded to bf16 into the A fragments pa and da
      with_flags(p.rate > 0.f, diag, [&](auto drop, auto on_diag) {
        constexpr bool kDrop = decltype(drop)::value, kDiag = decltype(on_diag)::value;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c0 = 8 * j + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + c0);
          const float2 d2 = *reinterpret_cast<const float2*>(dl + c0);
          float pd[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, r = e >> 1, qry = q0 + c0 + (e & 1), key = key0 + 8 * r;
            const bool vis = key_ok[r] && !(kDiag && key > qry);
            const float pr =
                vis ? exp2f(fmaf(st[i], scale_log2, -((e & 1) ? l2.y : l2.x) * kLog2e)) : 0.f;
            float dpv = dpt[i];
            pd[e] = pr;
            if constexpr (kDrop) {
              const bool kp =
                  keep_cell(hbh, (uint32_t)p.q_off + qry, (uint32_t)p.k_off + key, p.rate);
              pd[e] = kp ? pr * p.inv_keep : 0.f;
              dpv = kp ? dpv * p.inv_keep : 0.f;
            }
            ds[e] = pr * (dpv - ((e & 1) ? d2.y : d2.x)) * p.scale;
          }
          pa[j >> 1][2 * (j & 1)] = pack_bf16(pd[0], pd[1]);
          pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(pd[2], pd[3]);
          da[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
          da[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
        }
      });
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv_acc[h], pa[kk], mnmajor(dos, h, kk));
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk_acc[h], da[kk], mnmajor(qs, h, kk));
      wgmma_commit();
      wgmma_wait<0>();
      release(empty + 8 * s);
    }
#pragma unroll
    for (int h = 0; h < NC; ++h) {
      fence_regs(dk_acc[h]);
      fence_regs(dv_acc[h]);
    }
    if (kw0 < p.Tk) {
      const size_t out = (size_t)bh * p.Tk * p.d;
      store_acc<NC>(dk + out, dk_acc, key0, p.Tk, p.d, t);
      store_acc<NC>(dv + out, dv_acc, key0, p.Tk, p.d, t);
    }
  }
}

template <typename T, int DP>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* km,
                     const void* dout, const void* delta, const void* lse, void* dk, void* dv,
                     const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = make_map(&tq, q, p.bh, p.Tq, p.d)) || (err = make_map(&tk, k, p.bh, p.Tk, p.d))
      || (err = make_map(&tv, v, p.bh, p.Tk, p.d)) || (err = make_map(&tdo, dout, p.bh, p.Tq, p.d)))
    return err;
  constexpr int smem = DkvLayout<DP>::BYTES;
  auto kernel = flash_dkv_wgmma<T, DP>;
  if ((err = set_smem(kernel, smem))) return err;
  kernel<<<dim3((p.Tk + kBlockRows - 1) / kBlockRows, p.bh), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(km), static_cast<const float*>(delta),
      static_cast<const float*>(lse), static_cast<T*>(dk), static_cast<T*>(dv), p);
  return (int)cudaGetLastError();
}

inline int run_dkv_wgmma(const void* q, const void* k, const void* v, const void* km,
                         const void* dout, const void* delta, const void* lse, void* dk,
                         void* dv, const Params& p, cudaStream_t stream) {
  if (p.d <= 64) return launch_dkv_wgmma<bf16, 64>(q, k, v, km, dout, delta, lse, dk, dv, p, stream);
  return launch_dkv_wgmma<bf16, 128>(q, k, v, km, dout, delta, lse, dk, dv, p, stream);
}

}  // namespace hopper

}  // namespace dl4j_flash

// Plain C entries bound with ctypes: q, do [bh, Tq, d], k, v [bh, Tk, d]
// and the gradients in one type (bf16 when is_bf16, else f32); delta, lse
// [bh, Tq] f32; km [bh, Tk] f32 or null. Tq, Tk multiples of 64, d <= 256
// (<= 128 for f32). The route is static: bf16 with d in (32, 128] and a
// multiple of 8 takes the wgmma kernel, everything else the mma.sync
// body. Returns a cudaError_t.
extern "C" int dl4j_flash_dkv(const void* q, const void* k, const void* v, const void* km,
                              const void* dout, const void* delta, const void* lse, void* dk,
                              void* dv, int bh, int Tq, int Tk, int d, int is_bf16, float scale,
                              int causal, float rate, float inv_keep, int seed, int q_off,
                              int k_off, void* stream) {
  using namespace dl4j_flash;
  const Params p{bh, Tq, Tk, d, scale, causal, rate, inv_keep, seed, q_off, k_off};
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper::wgmma_route(is_bf16, d))
    return hopper::run_dkv_wgmma(q, k, v, km, dout, delta, lse, dk, dv, p, s);
  if (is_bf16) return run_dkv<bf16>(q, k, v, km, dout, delta, lse, dk, dv, p, s);
  return run_dkv<float>(q, k, v, km, dout, delta, lse, dk, dv, p, s);
}
