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
// Beside the products it takes one exponential per score cell, about
// 1.08e9 at that shape: 16 a clock per SM on the special-function units is
// 0.26 ms at 1.98 GHz, as long as the products, so the softmax of one
// tile has to run under the products of another.
//
// Design for bf16 operands whose head width pads to 64 or 128 (the main
// path; the pieces it shares with K6/K7 are in flash_hopper.cuh): a block
// of 384 threads owns 128 queries, 64 for each of two consumer warpgroups,
// whose q tiles are loaded once by TMA. The grid's x is the batch x head,
// so that every bh's heaviest causal blocks go first. One producer thread
// streams the key tiles of k and v (and the key mask) by TMA through a
// ring of STAGES full/empty mbarrier stages, stopping at the last tile the
// block's last row can see. Per tile a consumer forms s = q . k^T with
// wgmma (both operands K-major in shared memory; q negated by the
// product's A scale when the scale is negative) and runs the online
// softmax in the accumulator registers: masked cells to -1e30, the row max
// over the quad that holds a row, then p = 2^(s * scale * log2(e) - m *
// scale * log2(e)) as one FFMA and one EX2 a cell (FA3's folding of the
// scale), l summed per thread and reduced once at the end. p, dropped, is
// rounded to bf16 in pairs as the register A fragment of o += p . v,
// whose B is the v stage read MN-major: nothing is staged transposed and
// p never leaves registers. The causal test runs only on the tile that
// crosses a warpgroup's diagonal (and the length test on a 128-key tile
// past T), the key-mask and dropout tests only when they apply:
// compile-time copies of the cell loop (`with_flags`). The epilogue
// writes lse = m * |scale| + ln l in natural-log units. No atomics.
//
// Overlap (as FA3 arranges it within a warpgroup): tile n's s = q . k^T
// and tile n-1's o += p . v are issued together, o rescaled between the two
// issues, and tile n's softmax runs while p . v is in the tensor cores; a
// stage is released once both of its products are done, so a consumer
// holds two stages and the ring needs three. At d = 64 the score tile is
// 128 keys (m64n128k16: half the per-tile row-max, rescale and barrier
// work a key); at d = 128 it stays 64 keys, within ptxas's 168 registers.
// On an H100 (perf_flash_ab.py; PERF.md) these choices took the d = 64
// main path from 0.88 ms (64-key tiles, no overlap) to 0.72 ms, and the
// folded scale to 0.67; the two warpgroups taking turns at issuing their
// products on named barriers (FA3's ping-pong) gained nothing on top, two
// stages starved the overlap, and taking some exponentials on the FMA
// pipes, or skipping the rescale by a warp vote, made it slower: with two
// consumer warps a sub-partition the softmax is bound by its instructions'
// latency and issue, not by the EX2 unit.
//
// A warpgroup multiplies only the tiles its rows can see and waits for
// and releases the rest: the empty barriers count one arrival from every
// consumer warp for every tile (warpgroup 0 sees one causal 64-key tile
// fewer than warpgroup 1; with T an odd multiple of 64, warpgroup 1's
// rows lie wholly past the end).
//
// f32 operands (wgmma would round them to TF32) and other bf16 widths keep
// the body written first (mma.sync / CUDA cores, below): one block of four
// warps per (64 query rows, bh) stages its q tile once and walks the key
// tiles, each warp owning 16 query rows: S = Q K^T by mma.sync into
// registers, the online softmax on the accumulators, P written to a
// per-warp shared tile in v's type, then O += P V from shared memory with
// V staged transposed.
#include "flash_hopper.cuh"

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

// ------------------------------------------------------- K5, wgmma route
namespace hopper {

// Tile shape per padded head width (the note at the top says why).
template <int DP>
struct FwdConfig {
  static constexpr int KN = DP == 64 ? 128 : 64;  // keys per tile
  static constexpr int STAGES = 3;                // key tiles in flight
};

// Shared memory of one block, in bytes from a 1024-byte aligned base. A key
// tile of KN rows is DP/64 chunks of [KN rows][64 columns], each loaded as
// KN/64 TMA boxes of 64 rows, so that a 128-row chunk is contiguous.
template <int DP, int KN, int STAGES>
struct FwdLayout {
  static constexpr int TB = kRows * DP * 2;             // one 64-row q tile
  static constexpr int KB = KN * DP * 2;                // one key tile of k or v
  static constexpr int Q = 0;                           // [2][TB], resident
  static constexpr int K = Q + 2 * TB;                  // [STAGES][KB]
  static constexpr int V = K + STAGES * KB;             // [STAGES][KB]
  static constexpr int KM = V + STAGES * KB;            // [STAGES][KN] f32 key mask
  static constexpr int BAR = KM + STAGES * KN * 4;      // full, empty [STAGES]; res
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const float* __restrict__ km,
                bf16* __restrict__ o, float* __restrict__ lse, Params p) {
  constexpr int KN = FwdConfig<DP>::KN, STAGES = FwdConfig<DP>::STAGES;
  static_assert(DP == 64 || DP == 128, "d padded to 64 or 128");
  static_assert(KN == 64 || (KN == 128 && DP == 64), "128-key tiles at d <= 64 only");
  using L = FwdLayout<DP, KN, STAGES>;
  constexpr int NC = DP / 64, KS = DP / 16, NS = KN / 16, RB = KN / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* sp = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES, res = empty + 8 * STAGES;
  const int T = p.Tq, bh = blockIdx.x;  // x = bh: every bh's heaviest blocks first
  const int nb = (T + kBlockRows - 1) / kBlockRows;
  const int q0 = (p.causal ? nb - 1 - (int)blockIdx.y : (int)blockIdx.y) * kBlockRows;
  const int nk_all = (T + KN - 1) / KN;
  const int nk = p.causal ? min(nk_all, (min(q0 + kBlockRows, T) - 1) / KN + 1) : nk_all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
      mbar_expect_tx(res, 2 * NC * kChunkBytes);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load(base + L::Q + w * L::TB + c * kChunkBytes, &tq, res, 64 * c, q0 + kRows * w, bh);
      for (int it = 0; it < nk; ++it) {
        const int s = it % STAGES, k0 = it * KN;
        const uint32_t bar = full + 8 * s;
        // the key mask of the keys < T (a 128-key tile may end past T)
        const int mbytes = km != nullptr ? min(KN, T - k0) * 4 : 0;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, 2 * RB * NC * kChunkBytes + mbytes);
        for (int c = 0; c < NC; ++c)
          for (int h = 0; h < RB; ++h) {
            const uint32_t off = s * L::KB + c * KN * 128 + h * kChunkBytes;
            tma_load(base + L::K + off, &tk, bar, 64 * c, k0 + kRows * h, bh);
            tma_load(base + L::V + off, &tv, bar, 64 * c, k0 + kRows * h, bh);
          }
        if (mbytes) bulk_load(base + L::KM + s * KN * 4, km + (size_t)bh * T + k0, mbytes, bar);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + kRows * wg;       // the warpgroup's first query
    const int row0 = qw0 + 16 * warp + g;  // the thread's queries: row0, row0 + 8
    const bool valid = qw0 < T;
    // the tiles this warpgroup multiplies; it waits for and releases the rest
    const int nw = !valid ? 0 : p.causal ? min(nk, (qw0 + kRows - 1) / KN + 1) : nk;
    const uint32_t hbh = hash_bh(p.seed, bh);
    // s is formed as sign(scale) * q . k^T (the product negates q for a
    // negative scale), so that its row max is the max of s * scale and p =
    // 2^(s * sl2 - m * sl2) is one FFMA and one EX2 a cell; sl2 is kept off
    // 0 so that masked cells (-1e30) still come out 0
    const bool neg = p.scale < 0.f;
    const float sl2 = fmaxf(fabsf(p.scale) * kLog2e, 1e-20f);
    const uint32_t qt = base + L::Q + wg * L::TB;

    float acc[NC][32], st[KN / 2];
    uint32_t pa[NS][4];
    // m: the row max of s (kNeg until a key is visible); alpha rescales the
    // row's o and l from the previous max to the new one
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) st[i] = 0.f;
#pragma unroll
    for (int h = 0; h < NC; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

    const auto issue_s = [&](int it) {
      const uint32_t kst = base + L::K + (it % STAGES) * L::KB;
      wgmma_fence();
      if (neg) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) wgmma_ss<-1>(st, kmajor(qt, ks), kmajor(kst, ks), ks);
      } else {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) wgmma_ss(st, kmajor(qt, ks), kmajor(kst, ks), ks);
      }
      wgmma_commit();
    };
    const auto issue_o = [&](int it) {
      const uint32_t vs = base + L::V + (it % STAGES) * L::KB;
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) wgmma_rs(acc[h], pa[kk], mnmajor(vs, h, kk));
      wgmma_commit();
    };
    const auto wait_full = [&](int it) { mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1); };
    const auto release_tile = [&](int it) { release(empty + 8 * (it % STAGES)); };

    // the scores of tile it (in st): masked cells to -1e30, the running max
    // m and alpha, st -> the undropped p, the thread's share of l
    const auto softmax = [&](int it) {
      const int k0 = it * KN;
      const float* kms = km != nullptr
                             ? reinterpret_cast<const float*>(sp + L::KM + (it % STAGES) * KN * 4)
                             : nullptr;
      // a key past one of the warpgroup's queries, or past T
      const bool edge = (p.causal && k0 + KN - 1 > qw0) || k0 + KN > T;
      float mx[2] = {kNeg, kNeg};
      with_flags(kms != nullptr, edge, [&](auto masked, auto on_edge) {
        constexpr bool kMasked = decltype(masked)::value, kEdge = decltype(on_edge)::value;
#pragma unroll
        for (int j = 0; j < KN / 8; ++j) {
          const int c0 = 8 * j + 2 * t;
          bool kok[2] = {true, true};
          if constexpr (kMasked) {
            const float2 m2 = *reinterpret_cast<const float2*>(kms + c0);
            kok[0] = m2.x > 0.f;
            kok[1] = m2.y > 0.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, r = e >> 1, key = k0 + c0 + (e & 1);
            if constexpr (kMasked || kEdge) {
              bool vis = kok[e & 1];
              if constexpr (kEdge) vis = vis && key < T && !(p.causal && key > row0 + 8 * r);
              if (!vis) st[i] = kNeg;
            }
            mx[r] = fmaxf(mx[r], st[i]);
          }
        }
      });
      float ms[2];  // m * sl2, 0 while no key is visible (masked cells then give 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = ex2((m[r] - mn) * sl2);
        m[r] = mn;
        ms[r] = mn == kNeg ? 0.f : mn * sl2;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        const int r = (i >> 1) & 1;
        st[i] = ex2(fmaf(st[i], sl2, -ms[r]));
        rs[r] += st[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    };
    // p of tile it, dropped, into the register A fragments pa
    const auto pack = [&](int it) {
      const auto run = [&](auto drop) {
        constexpr bool kDrop = decltype(drop)::value;
#pragma unroll
        for (int j = 0; j < KN / 8; ++j) {
          float pv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[e] = st[4 * j + e];
            if constexpr (kDrop)
              pv[e] = keep_cell(hbh, (uint32_t)p.q_off + row0 + 8 * (e >> 1),
                                (uint32_t)p.k_off + it * KN + 8 * j + 2 * t + (e & 1), p.rate)
                          ? pv[e] * p.inv_keep : 0.f;
          }
          pa[j >> 1][2 * (j & 1)] = pack_bf16(pv[0], pv[1]);
          pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(pv[2], pv[3]);
        }
      };
      if (p.rate > 0.f) run(std::true_type{});
      else run(std::false_type{});
    };
    const auto rescale = [&] {
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] *= alpha[(i >> 1) & 1];
    };
    const auto o_done = [&] {  // after the wait for o += p . v
#pragma unroll
      for (int h = 0; h < NC; ++h) fence_regs(acc[h]);
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) fence_regs(pa[kk]);
    };

    // Tile it's s = q . k^T and tile it-1's o += p . v are issued together,
    // and tile it's softmax runs while the second is in the tensor cores;
    // o is rescaled between the two issues (as FA3 arranges it). A stage is
    // released when both of its products are done.
    mbar_wait(res, 0);
    if (nw > 0) {
      wait_full(0);
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(st);
      softmax(0);
      pack(0);
    }
    for (int it = 1; it < nw; ++it) {
      wait_full(it);
      issue_s(it);
      rescale();  // by tile it-1's alpha; o += p . v of tile it-2 is done
      issue_o(it - 1);
      wgmma_wait<1>();  // s is in; p . v of the tile before still runs
      fence_regs(st);
      softmax(it);
      wgmma_wait<0>();
      o_done();
      release_tile(it - 1);
      pack(it);
    }
    if (nw > 0) {
      rescale();
      issue_o(nw - 1);
      wgmma_wait<0>();
      o_done();
      release_tile(nw - 1);
    }
    for (int it = nw; it < nk; ++it) {  // tiles no query of this warpgroup sees
      wait_full(it);
      release_tile(it);
    }

    if (valid) {
      float inv[2], lrow[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool seen = m[r] > 0.5f * kNeg;  // the row has a visible key
        const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
        inv[r] = seen ? 1.0f / lr : 0.f;
        lrow[r] = seen ? m[r] * fabsf(p.scale) + logf(lr) : kNeg;
      }
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] *= inv[(i >> 1) & 1];
      store_acc<NC>(o + (size_t)bh * T * p.d, acc, row0, T, p.d, t);
      if (t == 0) {
        lse[(size_t)bh * T + row0] = lrow[0];
        lse[(size_t)bh * T + row0 + 8] = lrow[1];
      }
    }
  }
}

template <int DP>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, const void* km, void* o,
                     void* lse, const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = make_map(&tq, q, p.bh, p.Tq, p.d)) || (err = make_map(&tk, k, p.bh, p.Tq, p.d))
      || (err = make_map(&tv, v, p.bh, p.Tq, p.d)))
    return err;
  constexpr int smem = FwdLayout<DP, FwdConfig<DP>::KN, FwdConfig<DP>::STAGES>::BYTES;
  auto kernel = flash_fwd_wgmma<DP>;
  if ((err = set_smem(kernel, smem))) return err;
  const dim3 grid(p.bh, (p.Tq + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<const float*>(km),
                                           static_cast<bf16*>(o), static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

inline int run_fwd_wgmma(const void* q, const void* k, const void* v, const void* km, void* o,
                         void* lse, const Params& p, cudaStream_t stream) {
  if (p.d <= 64) return launch_fwd_wgmma<64>(q, k, v, km, o, lse, p, stream);
  return launch_fwd_wgmma<128>(q, k, v, km, o, lse, p, stream);
}

}  // namespace hopper

}  // namespace dl4j_flash

// Plain C entry bound with ctypes: q, k, v, o [bh, T, d] in one type (bf16
// when is_bf16, else f32), lse [bh, T] f32, km [bh, T] f32 or null. T a
// multiple of 64, d <= 256 (<= 128 for f32). The route is static: bf16
// with d in (32, 128] and a multiple of 8 takes the wgmma kernel,
// everything else the body written first. Returns a cudaError_t.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v, const void* km,
                              void* o, void* lse, int bh, int T, int d, int is_bf16, float scale,
                              int causal, float rate, float inv_keep, int seed, int q_off,
                              int k_off, void* stream) {
  using namespace dl4j_flash;
  const Params p{bh, T, T, d, scale, causal, rate, inv_keep, seed, q_off, k_off};
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper::wgmma_route(is_bf16, d)) return hopper::run_fwd_wgmma(q, k, v, km, o, lse, p, s);
  if (is_bf16) return run_fwd<bf16>(q, k, v, km, o, lse, p, s);
  return run_fwd<float>(q, k, v, km, o, lse, p, s);
}

// 1 when the forward of bf16 operands with head width d takes the wgmma/TMA
// kernel, 0 when it takes the mma.sync body (f32, other widths).
extern "C" int dl4j_flash_fwd_wgmma(int is_bf16, int d) {
  return dl4j_flash::hopper::wgmma_route(is_bf16, d) ? 1 : 0;
}
