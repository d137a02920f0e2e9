// Device functions shared by the port's Hopper kernels.
//
// gather_distance.cu, edge_select.cu, hop.cu and prune.cu each include this
// header and compile into their own shared library (kernels/_build.py).
// The helpers here are the two halves of a beam-search hop:
//   * row_dots<LAYOUT>: one warp decodes one stored row (f32, bf16, f16,
//     int8 + scale, or PQ codes + codebook) in registers and computes x.x
//     and x.q in f32. It replaces the TPU kernels' row DMA + in-VMEM
//     decode + diagonal-extract MXU product; gather_distance.cu and hop.cu
//     both call it, so the fused and the composed hop decode and sum in
//     the same order.
//   * warp_select_edges: Algorithm 1's edge improvisation for one frontier
//     node by one warp (the semantics of kernels/ref.py::select_edges).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// The stored layouts of a vector table (kernels/gather_distance.py
// ::LAYOUTS gives the same codes).
enum Layout : int { kF32 = 0, kBF16 = 1, kF16 = 2, kInt8 = 3, kPQ = 4 };

// One vector table as the kernels read it.
//   f32 / bf16 / f16: data = rows [n, d];
//   int8: data = codes int8[n, d], aux = scales f32[n];
//   PQ:   data = codes uint8[n, sub], aux = codebook f32[sub, 256, d/sub].
// `vec` (uniform) says the vector loads below are aligned: 16 B for f32
// rows and PQ centroids, 8 B for half rows, 4 B for int8 rows, with d (PQ:
// d/sub) a multiple of 4. The C entries compute it (rows_vec).
struct Rows {
  const void* data;
  const float* aux;
  int d;
  int sub;
  bool vec;
};

__host__ __forceinline__ bool rows_vec(int layout, const void* data,
                                       const void* aux, int d, int sub) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(data);
  switch (layout) {
    case kF32: return d % 4 == 0 && p % 16 == 0;
    case kBF16:
    case kF16: return d % 4 == 0 && p % 8 == 0;
    case kInt8: return d % 4 == 0 && p % 4 == 0;
    default:
      return sub > 0 && (d / sub) % 4 == 0 &&
             reinterpret_cast<uintptr_t>(aux) % 16 == 0;
  }
}

__device__ __forceinline__ float half_bits(unsigned short h, bool bf16) {
  return bf16 ? __bfloat162float(__ushort_as_bfloat16(h))
              : __half2float(__ushort_as_half(h));
}

// x.x and x.q of row `id` of `t`, decoded to f32 in registers and reduced
// over the warp (every lane gets both); q is the f32 query in shared
// memory, 16-byte aligned. Every layout sums in f32 with fmaf, lanes
// strided over the row:
//   f32:  one 16-byte load per lane (a d=128 row is 512 B);
//   bf16/f16: one 8-byte load of four halves per lane (256 B), widened
//         exactly;
//   int8: one char4 per lane (128 B) and the row's scale; x = float(c) *
//         scale rounded once (__fmul_rn: never contracted), as
//         storage.decode_rows computes it;
//   PQ:   lane j takes subspace j (and j + 32, ...): its code byte (the
//         32-byte code row is one coalesced read) and its centroid from
//         the codebook in global memory, which L1/L2 keep, 16 B at a time.
template <int LAYOUT>
__device__ __forceinline__ void row_dots(const Rows& t, int id,
                                         const float* __restrict__ q,
                                         float& xx, float& xq) {
  const int lane = threadIdx.x & 31;
  const int d = t.d;
  float a = 0.f, b = 0.f;
  if constexpr (LAYOUT == kF32) {
    const float* x = static_cast<const float*>(t.data) +
                     static_cast<size_t>(id) * d;
    if (t.vec) {
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
  } else if constexpr (LAYOUT == kBF16 || LAYOUT == kF16) {
    constexpr bool bf = LAYOUT == kBF16;
    const unsigned short* x = static_cast<const unsigned short*>(t.data) +
                              static_cast<size_t>(id) * d;
    if (t.vec) {
      const uint2* x2 = reinterpret_cast<const uint2*>(x);
      const float4* q4 = reinterpret_cast<const float4*>(q);
      for (int k = lane; k < (d >> 2); k += 32) {
        const uint2 raw = __ldg(x2 + k);
        const float v0 = half_bits(raw.x & 0xffffu, bf);
        const float v1 = half_bits(raw.x >> 16, bf);
        const float v2 = half_bits(raw.y & 0xffffu, bf);
        const float v3 = half_bits(raw.y >> 16, bf);
        const float4 qv = q4[k];
        a = fmaf(v0, v0, a);
        a = fmaf(v1, v1, a);
        a = fmaf(v2, v2, a);
        a = fmaf(v3, v3, a);
        b = fmaf(v0, qv.x, b);
        b = fmaf(v1, qv.y, b);
        b = fmaf(v2, qv.z, b);
        b = fmaf(v3, qv.w, b);
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        const float xv = half_bits(__ldg(x + k), bf);
        a = fmaf(xv, xv, a);
        b = fmaf(xv, q[k], b);
      }
    }
  } else if constexpr (LAYOUT == kInt8) {
    const signed char* x = static_cast<const signed char*>(t.data) +
                           static_cast<size_t>(id) * d;
    const float s = __ldg(t.aux + id);
    if (t.vec) {
      const char4* x4 = reinterpret_cast<const char4*>(x);
      const float4* q4 = reinterpret_cast<const float4*>(q);
      for (int k = lane; k < (d >> 2); k += 32) {
        const char4 c = __ldg(x4 + k);
        const float v0 = __fmul_rn(static_cast<float>(c.x), s);
        const float v1 = __fmul_rn(static_cast<float>(c.y), s);
        const float v2 = __fmul_rn(static_cast<float>(c.z), s);
        const float v3 = __fmul_rn(static_cast<float>(c.w), s);
        const float4 qv = q4[k];
        a = fmaf(v0, v0, a);
        a = fmaf(v1, v1, a);
        a = fmaf(v2, v2, a);
        a = fmaf(v3, v3, a);
        b = fmaf(v0, qv.x, b);
        b = fmaf(v1, qv.y, b);
        b = fmaf(v2, qv.z, b);
        b = fmaf(v3, qv.w, b);
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        const float xv = __fmul_rn(static_cast<float>(__ldg(x + k)), s);
        a = fmaf(xv, xv, a);
        b = fmaf(xv, q[k], b);
      }
    }
  } else {  // kPQ
    const int sub = t.sub;
    const int dsub = d / sub;
    const unsigned char* codes = static_cast<const unsigned char*>(t.data) +
                                 static_cast<size_t>(id) * sub;
    for (int j = lane; j < sub; j += 32) {
      const int c = __ldg(codes + j);
      const float* cw = t.aux + (static_cast<size_t>(j) * 256 + c) * dsub;
      const float* qj = q + j * dsub;
      if (t.vec) {
        for (int k = 0; k < dsub; k += 4) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(cw + k));
          const float4 qv = *reinterpret_cast<const float4*>(qj + k);
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
        for (int k = 0; k < dsub; ++k) {
          const float xv = __ldg(cw + k);
          a = fmaf(xv, xv, a);
          b = fmaf(xv, qj[k], b);
        }
      }
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
