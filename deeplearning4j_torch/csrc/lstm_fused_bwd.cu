// K4: fused BPTT of two stacked unmasked LSTM layers (the backward of K3).
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/lstm_fused.py
// `_bwd2_kernel` (wrapper `_bwd2_call`, called by `_lstm2_bwd`).
//
// What it computes, walking t = T-1 .. 0 and carrying (dh1, dc1, dh2, dc2)
// from dhcT, with the unmasked cell gradient of lstm_cell_bwd.cu:
//   layer 2:  dz2[t] = cell_bwd(dy[t] + dh2, dc2; g2[t], c2[t], c2[t-1])
//             dh2 = bf16(dz2[t]) . RW2^T
//   layer 1:  dz1[t] = cell_bwd(dh1 + bf16(dz2[t]) . W2^T, dc1; g1, c1)
//             dh1 = bf16(dz1[t]) . RW1^T
// (c[t-1] is c0 at t = 0), plus both layers' peephole sums, and writes
// dz1, dz2, the state gradients dhc0 and dpeep. dRW1, dW2, dRW2 and db2 are
// products over the whole sequence, formed outside.
//
// What bounds it on an H100: the dependency chain (two cells per step,
// each needing the whole dz of the step after); the three weights (6 MB at
// H=512 bf16) stay resident. Both bodies split the hidden units over the
// blocks of one cooperative grid and run the layers as a reverse wavefront,
// as K3 runs forward: phase p computes layer 2 at step T-1-p and layer 1 at
// step T-p. Both need only the dz1 and dz2 that phase p-1 published, so one
// grid.sync() serves both layers and each phase makes three products of the
// exchanged rows: dz2 . RW2^T and dz2 . W2^T from one read of dz2, and
// dz1 . RW1^T. T+1 phases, and one more product for dh1 at the end. dz1 and
// dz2 cross blocks through a two-slot buffer each in the weights' type.
//
// Two bodies, chosen statically by the C entry (dl4j_lstm2_bwd_tc names
// the choice):
//
// * Tensor cores (bf16 weights, B <= 64, H % 8 == 0, the grid resident in
//   clusters of two): 4 units a block (128 blocks at H=512), 512 threads.
//   With every block reading all of k, the exchange bounds the phase:
//   each SM reads the whole 512 KB of dz1 and dz2, 64 MB a phase from L2
//   over the grid. So the two blocks of a cluster share 8 units, and each
//   takes every other 32-wide chunk of k for all 8: half the exchange per
//   SM (PERF.md has the variants that showed it). Its
//   partial sums for the pair's units reach the other block through
//   distributed shared memory after a cluster barrier, and each block adds
//   both halves (rank 0's, then rank 1's) for its own 4 units.
//   The products run on `mma.sync` m16n8k16 (lstm_hopper.cuh): A = 16
//   exchanged dz rows, B = 8 resident weight rows, so the n-tiles are RW2,
//   W2 (both from dz2) and RW1 (from dz1), 8 units each. Warp w takes
//   m-tile w % MT and every KG-th of the block's chunks (MT = ceil(B/16),
//   KG = 16/MT), copies its rows of each chunk with cp.async.cg into a
//   private ring of kTcStages chunks (all of them in flight before the
//   first wait), and leaves a partial [16 x 24] tile in shared memory; the
//   cell threads add the partial tiles in a fixed order (no atomics: two
//   launches are bitwise equal). Threads 0-255 run layer 2's cells,
//   256-511 layer 1's, one element (row, unit) each, keeping dh, dc and
//   the peephole sums in registers. Each thread's reserve for the next
//   phase (4 gates, c, c_prev, dy) is copied into shared memory by cp.async
//   before the barrier, off the chain.
// * CUDA cores (f32 weights, and any shape the first does not take): HB
//   units a block, the smallest that keeps the grid resident; [HB][4H] rows
//   of RW1, W2, RW2 in shared memory (48 KB at HB=4 bf16); row_dot reads
//   the exchanged rows through L2 in 8-wide chunks and every weight element
//   once per row; the reserve is read after the barrier.
#include "lstm_common.cuh"
#include "lstm_hopper.cuh"

namespace dl4j {

// The pick of row_dot's kMaxHB partial sums that belongs to lane s.
__device__ __forceinline__ float lane_pick(const float (&a)[kMaxHB], int s) {
  float v = 0.0f;
#pragma unroll
  for (int u = 0; u < kMaxHB; ++u)
    if (u == s) v = a[u];
  return v;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
lstm2_bwd_kernel(const float* __restrict__ dy,    // [T, B, H] gradient of ys2
                 const float* __restrict__ g1,    // [T, B, 4H] layer-1 gates reserve
                 const float* __restrict__ c1,    // [T, B, H] layer-1 c sequence
                 const float* __restrict__ g2,    // [T, B, 4H]
                 const float* __restrict__ c2,    // [T, B, H]
                 const W* __restrict__ rw1,       // [H, 4H]
                 const W* __restrict__ w2,        // [H, 4H]
                 const W* __restrict__ rw2,       // [H, 4H]
                 const float* __restrict__ peep,  // [6, H] (layer 1 pi,pf,po; layer 2) or null
                 const float* __restrict__ c0,    // [2, B, H] (c1, c2 before step 0)
                 const float* __restrict__ dhcT,  // [4, B, H] (dh1, dc1, dh2, dc2)
                 W* dzx,                          // [2 layers][2 slots][B, 4H] exchange
                 float* __restrict__ dz1,         // [T, B, 4H]
                 float* __restrict__ dz2,         // [T, B, 4H]
                 float* __restrict__ dhc0,        // [4, B, H]
                 float* __restrict__ dpeep,       // [6, H] or null
                 int T, int B, int H, int HB) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 4 * H, E = B * HB;
  const size_t BH = (size_t)B * H, BK = (size_t)B * K;
  W* rw1_s = reinterpret_cast<W*>(smem);  // [HB][4H] each
  W* w2_s = rw1_s + (size_t)HB * K;
  W* rw2_s = w2_s + (size_t)HB * K;
  float* dh1_s = reinterpret_cast<float*>(rw2_s + (size_t)HB * K);  // [B][HB] each
  float* dc1_s = dh1_s + E;
  float* dh2_s = dc1_s + E;
  float* dc2_s = dh2_s + E;
  float* q_s = dc2_s + E;  // dz2 . W2^T: layer 1's input from layer 2
  float* dp_s = q_s + E;   // [B*HB][6] peephole partial sums
  W* x1 = dzx;             // dz1 slots
  W* x2 = dzx + 2 * BK;    // dz2 slots
  const int u0 = blockIdx.x * HB;
  const float* p1 = peep;
  const float* p2 = peep ? peep + 3 * H : nullptr;

  load_unit_rows(rw1_s, rw1, H, HB, u0);
  load_unit_rows(w2_s, w2, H, HB, u0);
  load_unit_rows(rw2_s, rw2, H, HB, u0);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const size_t at = (size_t)(e / HB) * H + u0 + e % HB;
    dh1_s[e] = dhcT[at];
    dc1_s[e] = dhcT[BH + at];
    dh2_s[e] = dhcT[2 * BH + at];
    dc2_s[e] = dhcT[3 * BH + at];
    q_s[e] = 0.0f;
    for (int k = 0; k < 6; ++k) dp_s[6 * e + k] = 0.0f;
  }
  const W* const w_l2[2] = {rw2_s, w2_s};
  const W* const w_l1[1] = {rw1_s};

  for (int p = 0; p <= T; ++p) {
    const bool l2 = p < T, l1 = p >= 1;  // layer 2 at step T-1-p, layer 1 at step T-p
    const int t2 = T - 1 - p, t1 = T - p;
    if (p >= 1) {
      grid.sync();  // phase p-1's dz1 and dz2 are published; also a block barrier
      const W* y2 = x2 + (size_t)((p - 1) & 1) * BK;  // dz2 at step T-p
      const W* y1 = x1 + (size_t)((p - 1) & 1) * BK;  // dz1 at step T-p+1
      const bool has1 = p >= 2;
      for (int it = threadIdx.x; it < dot_items(B); it += blockDim.x) {
        const int r = it / kSplit, s = it % kSplit;
        float a2[2][kMaxHB] = {}, a1[1][kMaxHB] = {};
        if (r < B) {
          row_dot<W, 2>(y2 + (size_t)r * K, w_l2, K, HB, s, a2);
          if (has1) row_dot<W, 1>(y1 + (size_t)r * K, w_l1, K, HB, s, a1);
        }
        lane_reduce<2>(a2);
        if (has1) lane_reduce<1>(a1);
        if (r < B && s < HB) {
          const int e = r * HB + s;
          dh2_s[e] = lane_pick(a2[0], s);
          q_s[e] = lane_pick(a2[1], s);
          if (has1) dh1_s[e] = lane_pick(a1[0], s);
        }
      }
      __syncthreads();
    }
    W* o1 = x1 + (size_t)(p & 1) * BK;
    W* o2 = x2 + (size_t)(p & 1) * BK;
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      const int r = e / HB, hu = u0 + e % HB;
      const size_t at = (size_t)r * H + hu;
      if (l2) {
        const float* g = g2 + ((size_t)t2 * B + r) * K;
        const float c_prev = t2 > 0 ? c2[(size_t)(t2 - 1) * BH + at] : c0[BH + at];
        const float c_out = c2[(size_t)t2 * BH + at];
        const CellGrad d = cell_bwd(g[hu], g[H + hu], g[2 * H + hu], g[3 * H + hu], c_out, c_prev,
                                    dy[(size_t)t2 * BH + at] + dh2_s[e], dc2_s[e], p2,
                                    p2 ? p2 + H : nullptr, p2 ? p2 + 2 * H : nullptr, hu);
        float* dzr = dz2 + ((size_t)t2 * B + r) * K;
        W* xr = o2 + (size_t)r * K;
        dzr[hu] = d.dzi;
        dzr[H + hu] = d.dzf;
        dzr[2 * H + hu] = d.dzo;
        dzr[3 * H + hu] = d.dzg;
        store_w(xr + hu, d.dzi);
        store_w(xr + H + hu, d.dzf);
        store_w(xr + 2 * H + hu, d.dzo);
        store_w(xr + 3 * H + hu, d.dzg);
        dc2_s[e] = d.dc_prev;
        if (p2 != nullptr) {
          dp_s[6 * e + 3] += d.dzi * c_prev;
          dp_s[6 * e + 4] += d.dzf * c_prev;
          dp_s[6 * e + 5] += d.dzo * c_out;
        }
      }
      if (l1) {
        const float* g = g1 + ((size_t)t1 * B + r) * K;
        const float c_prev = t1 > 0 ? c1[(size_t)(t1 - 1) * BH + at] : c0[at];
        const float c_out = c1[(size_t)t1 * BH + at];
        const CellGrad d = cell_bwd(g[hu], g[H + hu], g[2 * H + hu], g[3 * H + hu], c_out, c_prev,
                                    dh1_s[e] + q_s[e], dc1_s[e], p1, p1 ? p1 + H : nullptr,
                                    p1 ? p1 + 2 * H : nullptr, hu);
        float* dzr = dz1 + ((size_t)t1 * B + r) * K;
        W* xr = o1 + (size_t)r * K;
        dzr[hu] = d.dzi;
        dzr[H + hu] = d.dzf;
        dzr[2 * H + hu] = d.dzo;
        dzr[3 * H + hu] = d.dzg;
        store_w(xr + hu, d.dzi);
        store_w(xr + H + hu, d.dzf);
        store_w(xr + 2 * H + hu, d.dzo);
        store_w(xr + 3 * H + hu, d.dzg);
        dc1_s[e] = d.dc_prev;
        if (p1 != nullptr) {
          dp_s[6 * e] += d.dzi * c_prev;
          dp_s[6 * e + 1] += d.dzf * c_prev;
          dp_s[6 * e + 2] += d.dzo * c_out;
        }
      }
    }
  }
  // dh1 before step 0 = bf16(dz1_0) . RW1^T (dz1_0 was published in phase T)
  grid.sync();
  const W* y1 = x1 + (size_t)(T & 1) * BK;
  for (int it = threadIdx.x; it < dot_items(B); it += blockDim.x) {
    const int r = it / kSplit, s = it % kSplit;
    float a1[1][kMaxHB] = {};
    if (r < B) row_dot<W, 1>(y1 + (size_t)r * K, w_l1, K, HB, s, a1);
    lane_reduce<1>(a1);
    if (r < B && s < HB) dh1_s[r * HB + s] = lane_pick(a1[0], s);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const size_t at = (size_t)(e / HB) * H + u0 + e % HB;
    dhc0[at] = dh1_s[e];
    dhc0[BH + at] = dc1_s[e];
    dhc0[2 * BH + at] = dh2_s[e];
    dhc0[3 * BH + at] = dc2_s[e];
  }
  if (dpeep != nullptr) {
    for (int q = threadIdx.x; q < 6 * HB; q += blockDim.x) {
      const int k = q / HB, u = q % HB;
      float sum = 0.0f;
      for (int r = 0; r < B; ++r) sum += dp_s[6 * (r * HB + u) + k];
      dpeep[(size_t)k * H + u0 + u] = sum;
    }
  }
}

// Hidden units a block of the CUDA-core body (0 when no grid fits), and its
// dynamic shared memory.
template <typename W>
int units_per_block(int B, int H, size_t* smem) {
  auto smem_for = [&](int hb) {
    if (hb > kMaxHB) return (size_t)-1;  // row_dot keeps kMaxHB sums per thread
    return (size_t)3 * hb * 4 * H * sizeof(W) + (size_t)B * hb * 11 * sizeof(float);
  };
  return pick_units_per_block(lstm2_bwd_kernel<W>, H, smem_for, smem);
}

template <typename W>
int launch2_bwd(const void* dy, const void* g1, const void* c1, const void* g2, const void* c2,
                const void* rw1, const void* w2, const void* rw2, const void* peep,
                const void* c0, const void* dhcT, void* dzx, void* dz1, void* dz2, void* dhc0,
                void* dpeep, int T, int B, int H, cudaStream_t stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  auto kernel = lstm2_bwd_kernel<W>;
  size_t smem = 0;
  int HB = units_per_block<W>(B, H, &smem);
  if (HB == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* dy_ = static_cast<const float*>(dy);
  const float* g1_ = static_cast<const float*>(g1);
  const float* c1_ = static_cast<const float*>(c1);
  const float* g2_ = static_cast<const float*>(g2);
  const float* c2_ = static_cast<const float*>(c2);
  const W* rw1_ = static_cast<const W*>(rw1);
  const W* w2_ = static_cast<const W*>(w2);
  const W* rw2_ = static_cast<const W*>(rw2);
  const float* peep_ = static_cast<const float*>(peep);
  const float* c0_ = static_cast<const float*>(c0);
  const float* dhcT_ = static_cast<const float*>(dhcT);
  W* dzx_ = static_cast<W*>(dzx);
  float* dz1_ = static_cast<float*>(dz1);
  float* dz2_ = static_cast<float*>(dz2);
  float* dhc0_ = static_cast<float*>(dhc0);
  float* dpeep_ = static_cast<float*>(dpeep);
  void* args[] = {&dy_, &g1_, &c1_, &g2_, &c2_, &rw1_, &w2_, &rw2_, &peep_, &c0_,
                  &dhcT_, &dzx_, &dz1_, &dz2_, &dhc0_, &dpeep_, &T, &B, &H, &HB};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(H / HB), dim3(kThreads),
                                                args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// ---- Tensor-core body (bf16 weights) ----

constexpr int kTcUnits = 4;                 // hidden units whose cells a block runs
constexpr int kTcCluster = 2;               // blocks sharing a unit set, each half of k
constexpr int kTcClusterUnits = kTcUnits * kTcCluster;  // 8: one n-tile a weight
constexpr int kTcStages = 3;                // 32-wide k chunks in flight a warp
constexpr int kTcWarps = kThreads / 32;     // 16
constexpr int kTcMaxB = 64;                 // 4 m-tiles; B * kTcUnits <= kThreads / 2
constexpr int kTcStageBytes = 4 * 32 * 16;  // dz2 rows g, g+8 and dz1 rows g, g+8: 16 B a lane
constexpr int kTcCols = 3 * kTcClusterUnits;  // partial tile: dh2 0-7, q 8-15, dh1 16-23
constexpr int kTcReserve = 8;               // reserve floats a thread: i, f, o, g, c, c_prev, dy

// k chunks (32 wide) of a block of cluster rank q: global chunks q, q + 2, ...
__host__ __device__ __forceinline__ int tc_chunks(int H, int q) {
  return (H / 8 - q + kTcCluster - 1) / kTcCluster;
}

// Shared memory: the cluster's weight rows RW2 | W2 | RW1 (8 units each) at
// this block's k chunks (padded row stride), each warp's ring of kTcStages
// chunks (its partial tile and, at the end, the peephole sums reuse it),
// each thread's reserve.
__host__ __device__ __forceinline__ size_t tc_smem(int H) {
  return (size_t)3 * kTcClusterUnits * padded_row(32 * tc_chunks(H, 0)) * sizeof(__nv_bfloat16) +
         (size_t)kTcWarps * kTcStages * kTcStageBytes + (size_t)kTcReserve * kThreads * sizeof(float);
}

// This warp's products of one phase: the [16 x 24] partial tile of rows
// 16m .. 16m+15 over its block's local k chunks kg, kg + KG, ... (global
// chunk 2j + q) of y2 . [RW2 | W2]^T (columns 0-15) and y1 . RW1^T
// (columns 16-23) for the cluster's 8 units, left at the start of the
// warp's ring. Rows past B read row B-1 and are never used.
__device__ __forceinline__ void tc_products(const __nv_bfloat16* y2, const __nv_bfloat16* y1,
                                            const __nv_bfloat16* w_s, int WP, int B, int K,
                                            int q, int nloc, int m, int kg, int KG,
                                            unsigned char* ring) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t ra = (size_t)min(16 * m + g, B - 1) * K + 8 * t;
  const size_t rb = (size_t)min(16 * m + g + 8, B - 1) * K + 8 * t;
  const __nv_bfloat16* w0 = w_s + (size_t)g * WP + 8 * t;  // n-tile n: row 8n + g
  const int n = (nloc - kg + KG - 1) / KG;
  unsigned char* mine = ring + lane * 16;
  auto issue = [&](int i) {
    if (i < n) {
      const int off = 32 * (kTcCluster * (kg + i * KG) + q);
      unsigned char* d = mine + (i % kTcStages) * kTcStageBytes;
      cp_async16_cg(d, y2 + ra + off);
      cp_async16_cg(d + 512, y2 + rb + off);
      cp_async16_cg(d + 1024, y1 + ra + off);
      cp_async16_cg(d + 1536, y1 + rb + off);
    }
    cp_async_commit();
  };
  float acc[3][4] = {};
#pragma unroll
  for (int i = 0; i < kTcStages; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kTcStages - 1>();  // chunk i has landed (this lane's own copies)
    const unsigned char* d = mine + (i % kTcStages) * kTcStageBytes;
    const uint4 x2a = *reinterpret_cast<const uint4*>(d);
    const uint4 x2b = *reinterpret_cast<const uint4*>(d + 512);
    const uint4 x1a = *reinterpret_cast<const uint4*>(d + 1024);
    const uint4 x1b = *reinterpret_cast<const uint4*>(d + 1536);
    const __nv_bfloat16* w = w0 + 32 * (kg + i * KG);
    const uint4 wr2 = *reinterpret_cast<const uint4*>(w);
    const uint4 ww2 = *reinterpret_cast<const uint4*>(w + (size_t)8 * WP);
    const uint4 wr1 = *reinterpret_cast<const uint4*>(w + (size_t)16 * WP);
    mma_chunk32(acc[0], x2a, x2b, wr2);
    mma_chunk32(acc[1], x2a, x2b, ww2);
    mma_chunk32(acc[2], x1a, x1b, wr1);
    issue(i + kTcStages);  // refills the slot just read
  }
  cp_async_wait<0>();
  __syncwarp();  // every lane's copies have landed before the tile overwrites the ring
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) {
    *reinterpret_cast<float2*>(part + g * kTcCols + 8 * nt + 2 * t) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(part + (g + 8) * kTcCols + 8 * nt + 2 * t) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
lstm2_bwd_tc_kernel(const float* __restrict__ dy, const float* __restrict__ g1,
                    const float* __restrict__ c1, const float* __restrict__ g2,
                    const float* __restrict__ c2, const __nv_bfloat16* __restrict__ rw1,
                    const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ rw2,
                    const float* __restrict__ peep, const float* __restrict__ c0,
                    const float* __restrict__ dhcT, __nv_bfloat16* dzx,
                    float* __restrict__ dz1, float* __restrict__ dz2, float* __restrict__ dhc0,
                    float* __restrict__ dpeep, int T, int B, int H) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HB = kTcUnits, CU = kTcClusterUnits, half = kThreads / 2;
  const int K = 4 * H;
  const size_t BH = (size_t)B * H, BK = (size_t)B * K;
  const int q = (int)cluster.block_rank(), nloc = tc_chunks(H, q);
  const int WP = padded_row(32 * tc_chunks(H, 0));
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // RW2 | W2 | RW1 rows
  unsigned char* rings = smem + (size_t)3 * CU * WP * sizeof(__nv_bfloat16);
  float* res_s = reinterpret_cast<float*>(rings + (size_t)kTcWarps * kTcStages * kTcStageBytes);
  // the other block's partial tiles, through distributed shared memory
  const unsigned char* peer_rings = cluster.map_shared_rank(rings, q ^ 1);
  const int u0 = blockIdx.x * HB, cu0 = u0 - q * HB, tid = threadIdx.x, warp = tid / 32;

  // the cluster's 8 units' rows of RW2, W2, RW1 at this block's k chunks
  for (int i = tid; i < 3 * CU * nloc * 4; i += blockDim.x) {
    const int row = i / (nloc * 4), j = i % (nloc * 4) / 4, v = i % 4;
    const __nv_bfloat16* src = row < CU ? rw2 : row < 2 * CU ? w2 : rw1;
    *reinterpret_cast<uint4*>(w_s + (size_t)row * WP + 32 * j + 8 * v) = __ldg(
        reinterpret_cast<const uint4*>(src + (size_t)(cu0 + row % CU) * K +
                                       32 * (kTcCluster * j + q) + 8 * v));
  }

  // product role: m-tile m, local k chunks kg, kg + KG, ...
  const int MT = (B + 15) / 16, KG = kTcWarps / MT;
  const int m = warp % MT, kg = warp / MT;
  const bool mma_warp = warp < MT * KG;
  unsigned char* ring = rings + (size_t)warp * kTcStages * kTcStageBytes;

  // cell role: element e = (row r, unit u) of layer 2 (threads below half)
  // or layer 1
  const bool layer2 = tid < half;
  const int e = layer2 ? tid : tid - half;
  const bool cell_on = e < B * HB;
  const int r = e / HB, u = e % HB, hu = u0 + u, uc = q * HB + u;
  const size_t at = (size_t)r * H + hu;
  const float* gs = layer2 ? g2 : g1;
  const float* cs = layer2 ? c2 : c1;
  const float* c0l = c0 + (layer2 ? BH : 0);
  float* dzo = layer2 ? dz2 : dz1;
  __nv_bfloat16* xo = dzx + (layer2 ? 2 : 0) * BK + (size_t)r * K + hu;
  const bool peeps = peep != nullptr;
  float pv[3] = {0.0f, 0.0f, 0.0f};
  float dh = 0.0f, dc = 0.0f, qv = 0.0f, dp[3] = {0.0f, 0.0f, 0.0f};
  if (cell_on) {
    if (peeps)
      for (int k = 0; k < 3; ++k) pv[k] = peep[(size_t)((layer2 ? 3 : 0) + k) * H + hu];
    dh = dhcT[(layer2 ? 2 : 0) * BH + at];
    dc = dhcT[(layer2 ? 3 : 1) * BH + at];
  }

  // Copy this thread's reserve for phase p into res_s (one group, possibly
  // empty): layer 2 at step T-1-p, layer 1 at step T-p.
  auto prefetch = [&](int p) {
    const int ts = layer2 ? T - 1 - p : T - p;
    if (cell_on && ts >= 0 && ts < T) {
      const float* grow = gs + ((size_t)ts * B + r) * K + hu;
      for (int j = 0; j < 4; ++j) cp_async4_ca(res_s + j * kThreads + tid, grow + (size_t)j * H);
      cp_async4_ca(res_s + 4 * kThreads + tid, cs + (size_t)ts * BH + at);
      cp_async4_ca(res_s + 5 * kThreads + tid, ts > 0 ? cs + (size_t)(ts - 1) * BH + at : c0l + at);
      if (layer2) cp_async4_ca(res_s + 6 * kThreads + tid, dy + (size_t)ts * BH + at);
    }
    cp_async_commit();
  };
  // sum at (r, col) of both blocks' KG partial tiles: rank 0's, then rank
  // 1's, each in warp order (the same order in both blocks; no atomics)
  auto partial = [&](int col) {
    float s = 0.0f;
    for (int rr = 0; rr < kTcCluster; ++rr) {
      const unsigned char* base = rr == q ? rings : peer_rings;
#pragma unroll 4
      for (int k = 0; k < KG; ++k)
        s += reinterpret_cast<const float*>(base + (size_t)(k * MT + r / 16) * kTcStages *
                                                       kTcStageBytes)[(r % 16) * kTcCols + col];
    }
    return s;
  };

  prefetch(0);
  __syncthreads();  // the weight rows are resident
  for (int p = 0; p <= T; ++p) {
    if (p >= 1) {
      grid.sync();  // phase p-1's dz1 and dz2 are published; the peer is done with the tiles
      const size_t slot = (size_t)((p - 1) & 1) * BK;
      if (mma_warp)
        tc_products(dzx + 2 * BK + slot, dzx + slot, w_s, WP, B, K, q, nloc, m, kg, KG, ring);
      cluster.sync();  // both blocks' partial tiles are written
      if (cell_on) {
        if (layer2) {
          dh = partial(uc);
        } else {
          qv = partial(CU + uc);
          if (p >= 2) dh = partial(2 * CU + uc);  // dz1 exists from phase 1 on
        }
      }
    }
    cp_async_wait<0>();  // this thread's reserve for phase p
    const int ts = layer2 ? T - 1 - p : T - p;
    if (cell_on && ts >= 0 && ts < T) {
      float rv[7];
      for (int j = 0; j < 7; ++j) rv[j] = res_s[j * kThreads + tid];
      const float din = layer2 ? rv[6] + dh : dh + qv;
      const CellGrad d = cell_bwd(rv[0], rv[1], rv[2], rv[3], rv[4], rv[5], din, dc,
                                  peeps ? &pv[0] : nullptr, peeps ? &pv[1] : nullptr,
                                  peeps ? &pv[2] : nullptr, 0);
      float* zr = dzo + ((size_t)ts * B + r) * K + hu;
      zr[0] = d.dzi;
      zr[H] = d.dzf;
      zr[2 * H] = d.dzo;
      zr[3 * H] = d.dzg;
      __nv_bfloat16* xr = xo + (size_t)(p & 1) * BK;
      store_w(xr, d.dzi);
      store_w(xr + H, d.dzf);
      store_w(xr + 2 * H, d.dzo);
      store_w(xr + 3 * H, d.dzg);
      dc = d.dc_prev;
      if (peeps) {
        dp[0] += d.dzi * rv[5];
        dp[1] += d.dzf * rv[5];
        dp[2] += d.dzo * rv[4];
      }
    }
    prefetch(p + 1);  // lands during the barrier and the products
  }
  // dh1 before step 0 = bf16(dz1_0) . RW1^T (dz1_0 was published in phase T)
  grid.sync();
  if (mma_warp)
    tc_products(dzx + 2 * BK + (size_t)(T & 1) * BK, dzx + (size_t)(T & 1) * BK, w_s, WP, B, K,
                q, nloc, m, kg, KG, ring);
  cluster.sync();
  if (cell_on && !layer2) dh = partial(2 * CU + uc);
  cp_async_wait<0>();
  if (cell_on) {
    dhc0[(layer2 ? 2 : 0) * BH + at] = dh;
    dhc0[(layer2 ? 3 : 1) * BH + at] = dc;
  }
  cluster.sync();  // the peer has read these tiles: they may be reused, and the block may exit
  if (peeps) {
    float* dp_s = reinterpret_cast<float*>(rings);  // [layer 1, layer 2][B * HB][3]
    if (cell_on)
      for (int k = 0; k < 3; ++k) dp_s[((layer2 ? B * HB : 0) + e) * 3 + k] = dp[k];
    __syncthreads();
    for (int qi = tid; qi < 6 * HB; qi += blockDim.x) {
      const int k = qi / HB, uu = qi % HB, l = k / 3;
      float sum = 0.0f;
      for (int rr = 0; rr < B; ++rr) sum += dp_s[((l ? B * HB : 0) + rr * HB + uu) * 3 + k % 3];
      dpeep[(size_t)k * H + u0 + uu] = sum;
    }
  }
}

static cudaLaunchConfig_t tc_config(int H, cudaStream_t stream, cudaLaunchAttribute (&at)[2]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H / kTcUnits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = tc_smem(H);
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  at[1].id = cudaLaunchAttributeClusterDimension;
  at[1].val.clusterDim.x = kTcCluster;
  at[1].val.clusterDim.y = 1;
  at[1].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cfg;
}

// Whether the tensor-core body takes this shape on the current device (and
// the kernel's shared-memory limit set for it): every cluster of the grid
// must be resident at once for the grid barrier.
bool tc_fits(int B, int H) {
  if (H % 8 || B < 1 || B > kTcMaxB) return false;
  int dev = 0, max_smem = 0, clusters = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = tc_smem(H);
  if (smem > (size_t)max_smem) return false;
  if (cudaFuncSetAttribute(lstm2_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return false;
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg = tc_config(H, 0, at);
  cfg.attrs = &at[1];  // the cluster shape alone
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(&clusters, lstm2_bwd_tc_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return (long)clusters * kTcCluster >= H / kTcUnits;
}

int launch2_bwd_tc(const void* dy, const void* g1, const void* c1, const void* g2, const void* c2,
                   const void* rw1, const void* w2, const void* rw2, const void* peep,
                   const void* c0, const void* dhcT, void* dzx, void* dz1, void* dz2, void* dhc0,
                   void* dpeep, int T, int B, int H, cudaStream_t stream) {
  cudaLaunchAttribute at[2];
  const cudaLaunchConfig_t cfg = tc_config(H, stream, at);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, lstm2_bwd_tc_kernel, static_cast<const float*>(dy), static_cast<const float*>(g1),
      static_cast<const float*>(c1), static_cast<const float*>(g2), static_cast<const float*>(c2),
      static_cast<const __nv_bfloat16*>(rw1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(rw2), static_cast<const float*>(peep),
      static_cast<const float*>(c0), static_cast<const float*>(dhcT),
      static_cast<__nv_bfloat16*>(dzx), static_cast<float*>(dz1), static_cast<float*>(dz2),
      static_cast<float*>(dhc0), static_cast<float*>(dpeep), T, B, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dl4j

// Plain C entry bound with ctypes. w_bf16 selects the type of rw1/w2/rw2
// and of the dz exchange buffer dzx [2, 2, B, 4H] (bf16 or f32); every
// other tensor is f32 and contiguous; peep/dpeep are both set or both
// null. bf16 weights at a shape the tensor-core body takes launch it
// (dl4j_lstm2_bwd_tc), everything else the CUDA-core body. Returns a
// cudaError_t (0 on success).
extern "C" int dl4j_lstm2_bwd(const void* dy, const void* g1, const void* c1, const void* g2,
                              const void* c2, const void* rw1, const void* w2, const void* rw2,
                              int w_bf16, const void* peep, const void* c0, const void* dhcT,
                              void* dzx, void* dz1, void* dz2, void* dhc0, void* dpeep, int T,
                              int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16 && dl4j::tc_fits(B, H))
    return dl4j::launch2_bwd_tc(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT, dzx, dz1, dz2,
                                dhc0, dpeep, T, B, H, s);
  if (w_bf16)
    return dl4j::launch2_bwd<__nv_bfloat16>(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT,
                                            dzx, dz1, dz2, dhc0, dpeep, T, B, H, s);
  return dl4j::launch2_bwd<float>(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT, dzx, dz1,
                                  dz2, dhc0, dpeep, T, B, H, s);
}

// 1 when dl4j_lstm2_bwd takes the tensor-core body for these weights and
// this shape on the current device, 0 when the CUDA-core body.
extern "C" int dl4j_lstm2_bwd_tc(int w_bf16, int B, int H) {
  return w_bf16 && dl4j::tc_fits(B, H) ? 1 : 0;
}

// Hidden units a block of the body dl4j_lstm2_bwd launches for these
// weights and this shape on the current device (the grid has H / units
// blocks; 0 when no grid fits).
extern "C" int dl4j_lstm2_bwd_units(int w_bf16, int B, int H) {
  size_t smem = 0;
  if (w_bf16 && dl4j::tc_fits(B, H)) return dl4j::kTcUnits;
  return w_bf16 ? dl4j::units_per_block<__nv_bfloat16>(B, H, &smem)
                : dl4j::units_per_block<float>(B, H, &smem);
}
