// Device functions shared by the port's Hopper kernels.
//
// gather_distance.cu, edge_select.cu, hop.cu and prune.cu each include this
// header and compile into their own shared library (kernels/_build.py).
// The helpers here are the two halves of a beam-search hop:
//   * row_dots: one warp computes x.x and x.q of one f32 row in f32, lanes
//     strided over 16-byte loads (a d=128 row is 512 B, four sectors).
//     This replaces the TPU kernels' diagonal-extract MXU product, which
//     computed bb x bb dots to keep the diagonal.
//   * warp_select_edges: Algorithm 1's edge improvisation for one frontier
//     node by one warp (the semantics of kernels/ref.py::select_edges).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RT_API extern "C" __attribute__((visibility("default")))

RT_API const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace rt {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMetricL2 = 0;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// x.x and x.q of one row, reduced over the warp (every lane gets both).
// `vec4` (uniform) says x and q are 16-byte aligned and d % 4 == 0.
__device__ __forceinline__ void row_dots(const float* __restrict__ x,
                                         const float* __restrict__ q, int d,
                                         bool vec4, float& xx, float& xq) {
  const int lane = threadIdx.x & 31;
  float a = 0.f, b = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int k = lane; k < (d >> 2); k += 32) {
      const float4 xv = __ldg(x4 + k);
      const float4 qv = q4[k];
      a = fmaf(xv.x, xv.x, a);
      a = fmaf(xv.y, xv.y, a);
      a = fmaf(xv.z, xv.z, a);
      a = fmaf(xv.w, xv.w, a);
      b = fmaf(xv.x, qv.x, b);
      b = fmaf(xv.y, qv.y, b);
      b = fmaf(xv.z, qv.z, b);
      b = fmaf(xv.w, qv.w, b);
    }
  } else {
    for (int k = lane; k < d; k += 32) {
      const float xv = __ldg(x + k);
      a = fmaf(xv, xv, a);
      b = fmaf(xv, q[k], b);
    }
  }
  xx = warp_sum(a);
  xq = warp_sum(b);
}

// l2: ||x||^2 - 2 x.q + ||q||^2 (2*xq is exact, so a contracted fma rounds
// the same as the plain version's separate ops); ip: -x.q.
__device__ __forceinline__ float combine(float xx, float xq, float qq,
                                         int metric) {
  return metric == kMetricL2 ? (xx - 2.0f * xq) + qq : -xq;
}

// Block-wide copy of one query row into shared memory.
__device__ __forceinline__ void load_query(const float* __restrict__ q,
                                           float* qs, int d) {
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = q[k];
}

// ||q||^2 of a shared-memory row, reduced over one warp.
__device__ __forceinline__ float warp_norm2(const float* qs, int d) {
  float a = 0.f;
  for (int k = threadIdx.x & 31; k < d; k += 32) a = fmaf(qs[k], qs[k], a);
  return warp_sum(a);
}

// Algorithm 1 edge improvisation for frontier node `us` and inclusive rank
// range [L, R], by one warp. nbrs is the packed int32[n, layers, m] table.
// Writes out[0..m_out) (shared memory of this warp): the first m_out
// DISTINCT valid ids of u's edge block in flat-position order, -1 padded.
// That is exactly ref.select_edges' lazy dedup, whose priority is the flat
// position and whose every step wipes all copies of the id it took.
//
// Validity (ref.edge_scan_valid): lane `l` evaluates layer l's segment
// closed forms; a ballot gives the first fully covered layer ft and the
// skip-layer set, so layer l is scanned iff l <= ft and not skipped.
// Requires layers <= 32 (the wrapper checks logn <= 30).
__device__ void warp_select_edges(const int* __restrict__ nbrs, int n,
                                  int layers, int m, int logn, int us, int L,
                                  int R, bool skip_layers, int m_out,
                                  int* out) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  if (us >= 0) {  // uniform over the warp
    const int u = us;
    bool terminal = false, skip = false;
    if (lane < layers) {
      const int s = logn - lane;
      const int lo = (u >> s) << s;
      const int hi = lo + (1 << s) - 1;
      terminal = lo >= L && hi <= R;
      if (skip_layers && lane < logn) {
        const int s2 = s - 1;  // the child segment, at layer lane + 1
        const int lo2 = (u >> s2) << s2;
        const int hi2 = lo2 + (1 << s2) - 1;
        skip = max(lo2, L) == max(lo, L) && min(hi2, R) == min(hi, R);
      }
    }
    const unsigned tmask = __ballot_sync(kFull, terminal);
    const int ft = tmask ? __ffs(tmask) - 1 : 0;
    const unsigned lmask =
        __ballot_sync(kFull, lane < layers && lane <= ft && !skip);

    const int K = layers * m;
    const int* blk = nbrs + static_cast<size_t>(min(u, n - 1)) * K;
    for (int base = 0; base < K && cnt < m_out; base += 32) {
      const int p = base + lane;
      int f = -1;
      int valid = 0;
      if (p < K) {
        f = __ldg(blk + p);
        valid = ((lmask >> (p / m)) & 1u) && f >= 0 && f >= L && f <= R &&
                f != u;
      }
      bool dup = false;
      if (valid)
        for (int i = 0; i < cnt; ++i) dup |= out[i] == f;
      // strictly-earlier lanes of this chunk holding the same valid id
#pragma unroll
      for (int j = 0; j < 31; ++j) {
        const int fj = __shfl_sync(kFull, f, j);
        const int vj = __shfl_sync(kFull, valid, j);
        dup |= j < lane && vj && fj == f;
      }
      const bool keep = valid && !dup;
      const unsigned bal = __ballot_sync(kFull, keep);
      const int rank = __popc(bal & ((1u << lane) - 1u));
      if (keep && cnt + rank < m_out) out[cnt + rank] = f;
      cnt = min(m_out, cnt + __popc(bal));
      __syncwarp();
    }
  }
  for (int i = cnt + lane; i < m_out; i += 32) out[i] = -1;
  __syncwarp();
}

}  // namespace rt
