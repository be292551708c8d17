// Shared pieces of the persistent-LSTM kernels: the forwards (lstm_cell.cu,
// lstm_fused.cu) and their BPTT backwards (lstm_cell_bwd.cu,
// lstm_fused_bwd.cu).
//
// All four split the hidden units over the blocks of one cooperative
// grid: block k owns units [k*HB, (k+1)*HB) and ALL FOUR gate columns of
// them (i|f|o|g are four contiguous H-blocks of the [H, 4H] weights), so
// the cell update (and its gradient) is local to the block. Only the
// recurrent operand crosses blocks, through global memory (L2-resident at
// these sizes) and a grid.sync(): h_t in the forwards, dz_t in the
// backwards.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace dl4j {

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// Copy the block's gate columns of a [H, 4H] weight into shared memory.
// Local column j = gate*HB + unit; rows k are grouped by eight so that one
// 16-byte (bf16) load gives a thread eight consecutive k of its column:
// dst[((k/8)*G + j)*8 + k%8]. H must be a multiple of 8.
template <typename W>
__device__ void load_gate_slice(W* dst, const W* __restrict__ src, int H, int HB, int u0) {
  const int G = 4 * HB;
  for (int idx = threadIdx.x; idx < H * G; idx += blockDim.x) {
    const int k = idx / G, j = idx % G;
    dst[((k / 8) * G + j) * 8 + k % 8] = src[(size_t)k * 4 * H + (j / HB) * H + u0 + (j % HB)];
  }
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// h [B, H] f32 in global memory -> shared memory in the weights' type (the
// gemm operand cast, round to nearest). __ldcg reads through L2 only:
// another block wrote these values, and L1 is not coherent across SMs.
// n is a multiple of 4 and src 16-byte aligned; eight 16-byte loads per
// thread are in flight at once, since each waits on L2 latency.
template <typename W>
__device__ void load_h(W* dst, const float* src, int n) {
  constexpr int U = 8;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const int n4 = n / 4;
  for (int base = threadIdx.x; base < n4; base += U * blockDim.x) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n4) v[u] = __ldcg(s4 + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n4) store4(dst + 4 * i, v[u]);
    }
  }
}

// Eight consecutive values of a tensor that another block wrote in this
// launch: read through L2 only (__ldcg), 16-byte aligned.
__device__ __forceinline__ void load8_cg(const float* p, float (&f)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8_cg(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(b[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(b[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// sum_k h[r, k] * w[k, j] over k < H in order, f32 accumulation; h_row is
// one [H] row, w a slice laid out by load_gate_slice.
template <typename W>
__device__ __forceinline__ float dot_col(const W* h_row, const W* w, int H, int G, int j) {
  float acc = 0.0f;
  for (int k8 = 0; k8 < H / 8; ++k8) {
    float hv[8], wv[8];
    load8(h_row + k8 * 8, hv);
    load8(w + ((size_t)k8 * G + j) * 8, wv);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(hv[i], wv[i], acc);
  }
  return acc;
}

struct CellOut {
  float h, c;
  float i, f, o, g;  // post-activation gates: the BPTT reserve
};

// One LSTM cell from pre-activations (Graves peepholes when pi != nullptr):
// zi,zf += c*pi,pf; c_new = f*c + i*g; zo += c_new*po; h = o*tanh(c_new).
__device__ __forceinline__ CellOut cell(float zi, float zf, float zo, float zg, float c,
                                        const float* pi, const float* pf, const float* po,
                                        int hu) {
  if (pi != nullptr) {
    zi = zi + c * pi[hu];
    zf = zf + c * pf[hu];
  }
  const float i = sigm(zi), f = sigm(zf), g = tanhf(zg);
  const float cn = f * c + i * g;
  if (po != nullptr) zo = zo + cn * po[hu];
  const float o = sigm(zo);
  return {o * tanhf(cn), cn, i, f, o, g};
}

// Write a cell's gates into a [.., 4H] reserve row at unit hu (i|f|o|g).
__device__ __forceinline__ void store_gates(float* row, int H, int hu, const CellOut& s) {
  row[hu] = s.i;
  row[H + hu] = s.f;
  row[2 * H + hu] = s.o;
  row[3 * H + hu] = s.g;
}

struct CellGrad {
  float dzi, dzf, dzo, dzg;  // pre-activation gradients
  float dc_prev;             // gradient to c_{t-1} through this cell
};

// BPTT of one cell (the math of the JAX _bwd_kernel): dh and dc are the
// gradients reaching h_t and c_t (already scaled by the step mask where
// there is one), i/f/o/g the saved gates, c_cand the pre-mask c_t and
// c_prev = c_{t-1}. Peephole terms when pi != nullptr.
__device__ __forceinline__ CellGrad cell_bwd(float i, float f, float o, float g, float c_cand,
                                             float c_prev, float dh, float dc, const float* pi,
                                             const float* pf, const float* po, int hu) {
  const float tc = tanhf(c_cand);
  const float dzo = dh * tc * o * (1.0f - o);
  float dcc = dc + dh * o * (1.0f - tc * tc);
  if (po != nullptr) dcc = dcc + dzo * po[hu];
  const float dzi = dcc * g * i * (1.0f - i);
  const float dzf = dcc * c_prev * f * (1.0f - f);
  const float dzg = dcc * i * (1.0f - g * g);
  float dcp = dcc * f;
  if (pi != nullptr) dcp = dcp + dzi * pi[hu] + dzf * pf[hu];
  return {dzi, dzf, dzo, dzg, dcp};
}

// The backward's recurrent product, dh[r, u] = sum_k bf16(dz[r, k]) *
// W[u0 + u, k] over k < K = 4H, for all HB units of the block at once.
// kSplit consecutive lanes share one row r, each taking every kSplit-th
// 8-wide chunk of k (a warp reads four rows' 128-byte runs of dz through
// L2 and the matching 128 bytes of each weight row from shared memory,
// conflict-free); lane_reduce then folds the kSplit partial sums.
constexpr int kSplit = 8;
constexpr int kMaxHB = 8;  // accumulators per thread and weight slice

// acc[n][u] += dz_row[k] * w[n][u * K + k] over this lane's chunks.
template <typename W, int N>
__device__ __forceinline__ void row_dot(const W* dz_row, const W* const (&w)[N], int K, int HB,
                                        int s, float (&acc)[N][kMaxHB]) {
  for (int c = s; c < K / 8; c += kSplit) {
    float dv[8];
    load8_cg(dz_row + c * 8, dv);
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int u = 0; u < kMaxHB; ++u) {
        if (u < HB) {
          float wv[8];
          load8(w[n] + (size_t)u * K + c * 8, wv);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[n][u] = fmaf(dv[q], wv[q], acc[n][u]);
        }
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void lane_reduce(float (&acc)[N][kMaxHB]) {
#pragma unroll
  for (int off = kSplit / 2; off > 0; off /= 2)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int u = 0; u < kMaxHB; ++u) acc[n][u] += __shfl_xor_sync(0xffffffffu, acc[n][u], off);
}

// Copy rows [u0, u0 + HB) of a [H, 4H] weight into shared memory as
// [HB][4H] (the layout row_dot reads).
template <typename W>
__device__ void load_unit_rows(W* dst, const W* __restrict__ src, int H, int HB, int u0) {
  const int K = 4 * H;
  for (int idx = threadIdx.x; idx < HB * K; idx += blockDim.x)
    dst[idx] = src[(size_t)(u0 + idx / K) * K + idx % K];
}

__device__ __forceinline__ void store_w(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_w(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Work items of row_dot: kSplit lanes per row, padded to whole warps so
// that every lane of a warp takes part in the shuffles.
__host__ __device__ __forceinline__ int dot_items(int B) { return (B * kSplit + 31) / 32 * 32; }

constexpr int kThreads = 512;

// Smallest HB dividing H for which H/HB blocks of `kernel` can all be
// resident at once (a cooperative launch needs that). smem_for(HB) gives
// the dynamic shared memory per block. Returns 0 when nothing fits.
template <typename K, typename F>
int pick_units_per_block(K kernel, int H, F smem_for, size_t* smem_out) {
  int dev = 0, sms = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int hb = 1; hb <= H; ++hb) {
    if (H % hb) continue;
    const size_t smem = smem_for(hb);
    if (smem > (size_t)max_smem) return 0;  // grows with hb: nothing larger fits
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
        cudaSuccess)
      return 0;
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
        cudaSuccess)
      return 0;
    if ((long)per_sm * sms >= H / hb) {
      *smem_out = smem;
      return hb;
    }
  }
  return 0;
}

}  // namespace dl4j

extern "C" const char* dl4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
