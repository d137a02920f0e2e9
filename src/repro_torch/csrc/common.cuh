// Device functions shared by the port's Hopper kernels.
//
// gather_distance.cu, edge_select.cu, hop.cu and prune.cu each include this
// header and compile into their own shared library (kernels/_build.py).
// The helpers here are the two halves of a beam-search hop:
//   * warp_dists<LAYOUT, VPL>: the distances of a work list of stored rows
//     to one query row by one warp, with R rows in flight: it issues every
//     load of its R rows (f32, bf16, f16, int8 + scale, or PQ codes +
//     codebook) before the first FMA, decodes in registers, and reduces
//     the R rows' x.x and x.q together in one transposed butterfly
//     (warp_sums). It replaces the TPU kernels' row
//     DMA + in-VMEM decode + diagonal-extract MXU product; gather_distance.cu
//     and hop.cu both call it, so the fused and the composed hop decode and
//     sum in the same order;
//   * warp_select_staged: Algorithm 1's edge improvisation for one
//     frontier node by one warp (the semantics of kernels/ref.py::
//     select_edges): the ids of the layers it scans (warp_scan_layers)
//     copied into shared memory at once, then selected there
//     (warp_select); edge_select.cu and hop.cu both call it.
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
// the most warps a CTA of gather_distance.cu or hop.cu runs
constexpr int kMaxWarps = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// N warp sums at once (N a power of two up to 32), each by warp_sum's
// xor tree: at level o, while more than one sum is left, lanes with bit o
// clear keep the first half of the sums and add the partner's copy of it,
// lanes with bit o set the second half, so one shuffle serves two sums;
// then the levels left run on one sum. Each add is own + partner's, as in
// warp_sum, so every sum is bit-identical to warp_sum of its values. Lane
// l ends with sum l / (32 / N).
template <int N, int O>
__device__ __forceinline__ void warp_sums_from(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool hi = lane & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float keep = hi ? v[N / 2 + i] : v[i];
        const float send = hi ? v[i] : v[N / 2 + i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      warp_sums_from<N / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      warp_sums_from<1, O / 2>(v, lane);
    }
  }
}

template <int N>
__device__ __forceinline__ float warp_sums(float (&v)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: 1..32, 2^k");
  warp_sums_from<N, 16>(v, lane);
  return v[0];
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// ---- asynchronous copies, global -> shared (no registers, no wait until
// copy_async_wait) -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// every copy this thread issued has landed (visible to it; a barrier or
// __syncwarp makes them visible to the others)
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One f32 row of d from global memory into shared memory (16-byte
// aligned), by the 32 lanes of one warp, asynchronously.
__device__ __forceinline__ void warp_copy_row_async(const float* src,
                                                    float* dst, int d) {
  const int lane = threadIdx.x & 31;
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = lane; i < (d >> 2); i += 32)
      copy16_async(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = lane; i < d; i += 32) copy4_async(dst + i, src + i);
  }
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
// d/sub) a multiple of 4. The C entries compute it (rows_vec;
// kernels/gather_distance.py::rows_vec mirrors it).
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

// The row-width instantiation of a table (VPL): d / 128 where that is 1 or
// 8 and the rows are dense and aligned (rows_vec), else 0, a loop over any
// d (kernels/gather_distance.py::vpl_of mirrors it).
__host__ inline int vpl_of(int layout, int d, bool vec) {
  if (layout == kPQ || !vec || d % 128) return 0;
  return d / 128 == 1 || d / 128 == 8 ? d / 128 : 0;
}

// Rows a warp keeps in flight in warp_dists, by layout and VPL (the
// 4-element units a lane reads of one row: 1 at d = 128, 8 at d = 1,024,
// 0 a loop over any d): 16 registers of row data a lane (a unit is 4
// registers in f32, 2 in bf16/f16 and, with its row's scale, in int8), at
// least 1 row and at most 8, so that a kernel fits 64 registers a thread
// and an SM holds 32 warps.
// kernels/gather_distance.py::rows_in_flight mirrors it for the launch
// plan's split of a query row's slots.
template <int LAYOUT, int VPL>
__host__ __device__ constexpr int rows_in_flight() {
  constexpr int unit = LAYOUT == kF32 ? 4 : 2;
  constexpr int fit = 16 / ((VPL > 0 ? VPL : 1) * unit);
  return LAYOUT == kPQ || VPL == 0 ? 4 : fit < 1 ? 1 : fit > 8 ? 8 : fit;
}

// Launch bounds of gather_distance.cu and hop.cu: at most 64 registers a
// thread (32 warps an SM).
constexpr int kMinWarpsPerSM = 32;

__device__ __forceinline__ float half_bits(unsigned short h, bool bf16) {
  return bf16 ? __bfloat162float(__ushort_as_bfloat16(h))
              : __half2float(__ushort_as_half(h));
}

// Four consecutive elements of a stored dense row: `Raw` is what one
// vector load brings (f32: 16 B; bf16/f16: 8 B; int8: 4 B), `quad`
// decodes it to f32 exactly (int8: float(c) * scale rounded once,
// __fmul_rn: never contracted, as storage.decode_rows computes it), `elem`
// loads and decodes element k alone.
template <int LAYOUT>
struct Dense;
template <>
struct Dense<kF32> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const void* row, int k) {
    return __ldg(static_cast<const float4*>(row) + k);
  }
  static __device__ __forceinline__ float4 quad(Raw r, float) { return r; }
  static __device__ __forceinline__ float elem(const void* row, int k,
                                               float) {
    return __ldg(static_cast<const float*>(row) + k);
  }
  static constexpr int kBytes = 4;
};
template <int LAYOUT>
struct DenseHalf {
  using Raw = uint2;
  static constexpr bool kBf = LAYOUT == kBF16;
  static __device__ __forceinline__ Raw load(const void* row, int k) {
    return __ldg(static_cast<const uint2*>(row) + k);
  }
  static __device__ __forceinline__ float4 quad(Raw r, float) {
    return make_float4(half_bits(r.x & 0xffffu, kBf), half_bits(r.x >> 16, kBf),
                       half_bits(r.y & 0xffffu, kBf),
                       half_bits(r.y >> 16, kBf));
  }
  static __device__ __forceinline__ float elem(const void* row, int k,
                                               float) {
    return half_bits(__ldg(static_cast<const unsigned short*>(row) + k), kBf);
  }
  static constexpr int kBytes = 2;
};
template <>
struct Dense<kBF16> : DenseHalf<kBF16> {};
template <>
struct Dense<kF16> : DenseHalf<kF16> {};
template <>
struct Dense<kInt8> {
  using Raw = char4;
  static __device__ __forceinline__ Raw load(const void* row, int k) {
    return __ldg(static_cast<const char4*>(row) + k);
  }
  static __device__ __forceinline__ float4 quad(Raw c, float s) {
    return make_float4(__fmul_rn(static_cast<float>(c.x), s),
                       __fmul_rn(static_cast<float>(c.y), s),
                       __fmul_rn(static_cast<float>(c.z), s),
                       __fmul_rn(static_cast<float>(c.w), s));
  }
  static __device__ __forceinline__ float elem(const void* row, int k,
                                               float s) {
    return __fmul_rn(
        static_cast<float>(__ldg(static_cast<const signed char*>(row) + k)),
        s);
  }
  static constexpr int kBytes = 1;
};

__device__ __forceinline__ void fma_quad(float4 x, float4 q, float& a,
                                         float& b) {
  a = fmaf(x.x, x.x, a);
  a = fmaf(x.y, x.y, a);
  a = fmaf(x.z, x.z, a);
  a = fmaf(x.w, x.w, a);
  b = fmaf(x.x, q.x, b);
  b = fmaf(x.y, q.y, b);
  b = fmaf(x.z, q.z, b);
  b = fmaf(x.w, q.w, b);
}

// Each lane's partial x.x (a) and x.q (b) of R stored rows (id[r] < 0: no
// row, a = b = 0) against one query row q (f32, shared memory, 16-byte
// aligned). Lanes stride over a row in 4-element units (lane, lane
// + 32, ...) and each sums its units in increasing order with fmaf; PQ:
// lane j takes subspace j (and j + 32, ...), its code byte and then its
// centroid from the codebook in global memory, which L1/L2 keep. With VPL
// > 0 every load of the R rows is issued before the first FMA; with VPL =
// 0 the loads of the R rows' k-th units go out together.
template <int LAYOUT, int VPL, int R>
__device__ __forceinline__ void rows_dots(const Rows& t, const int (&id)[R],
                                          const float* q, float (&a)[R],
                                          float (&b)[R]) {
  const int lane = threadIdx.x & 31;
  const int d = t.d;
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = b[r] = 0.f;
  if constexpr (LAYOUT == kPQ) {
    const int sub = t.sub, dsub = d / sub;
    const unsigned char* codes = static_cast<const unsigned char*>(t.data);
    for (int j = lane; j < sub; j += 32) {
      const float* cw[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = id[r] >= 0
                          ? __ldg(codes + static_cast<size_t>(id[r]) * sub + j)
                          : 0;
        cw[r] = t.aux + (static_cast<size_t>(j) * 256 + c) * dsub;
      }
      if (t.vec) {
        for (int k = 0; k < dsub; k += 4) {
          float4 x[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (id[r] >= 0) x[r] = __ldg(reinterpret_cast<const float4*>(cw[r] + k));
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (id[r] >= 0)
              fma_quad(x[r],
                       *reinterpret_cast<const float4*>(q + j * dsub + k),
                       a[r], b[r]);
        }
      } else {
        for (int k = 0; k < dsub; ++k) {
          float x[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (id[r] >= 0) x[r] = __ldg(cw[r] + k);
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (id[r] >= 0) {
              a[r] = fmaf(x[r], x[r], a[r]);
              b[r] = fmaf(x[r], q[j * dsub + k], b[r]);
            }
        }
      }
    }
  } else {
    using D = Dense<LAYOUT>;
    const char* base = static_cast<const char*>(t.data);
    const void* row[R];
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      row[r] = base + static_cast<size_t>(id[r] >= 0 ? id[r] : 0) * d *
                          D::kBytes;
      s[r] = 1.f;
      if constexpr (LAYOUT == kInt8)
        if (id[r] >= 0) s[r] = __ldg(t.aux + id[r]);
    }
    if constexpr (VPL > 0) {
      typename D::Raw u[R][VPL];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (id[r] >= 0) {
#pragma unroll
          for (int i = 0; i < VPL; ++i)
            u[r][i] = D::load(row[r], lane + 32 * i);
        }
      }
      const float4* q4 = reinterpret_cast<const float4*>(q);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (id[r] >= 0) {
#pragma unroll
          for (int i = 0; i < VPL; ++i)
            fma_quad(D::quad(u[r][i], s[r]), q4[lane + 32 * i], a[r], b[r]);
        }
    } else if (t.vec) {
      for (int k = lane; k < (d >> 2); k += 32) {
        typename D::Raw u[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (id[r] >= 0) u[r] = D::load(row[r], k);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (id[r] >= 0)
            fma_quad(D::quad(u[r], s[r]),
                     reinterpret_cast<const float4*>(q)[k], a[r], b[r]);
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        float x[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (id[r] >= 0) x[r] = D::elem(row[r], k, s[r]);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (id[r] >= 0) {
            a[r] = fmaf(x[r], x[r], a[r]);
            b[r] = fmaf(x[r], q[k], b[r]);
          }
      }
    }
  }
}

// l2: ||x||^2 - 2 x.q + ||q||^2 (2*xq is exact, so a contracted fma rounds
// the same as the plain version's separate ops); ip: -x.q.
__device__ __forceinline__ float combine(float xx, float xq, float qq,
                                         int metric) {
  return metric == kMetricL2 ? (xx - 2.0f * xq) + qq : -xq;
}

// ||q||^2 of a shared-memory row, reduced over one warp.
__device__ __forceinline__ float warp_norm2(const float* qs, int d) {
  float a = 0.f;
  for (int k = threadIdx.x & 31; k < d; k += 32) a = fmaf(qs[k], qs[k], a);
  return warp_sum(a);
}

// The distances of items first, first + stride, ... of a work list
// against one query row q (shared memory) with ||q||^2 = qq, by one warp:
// item i is stored row wid[i], its result goes to out[wpos[i]] (global
// memory). The warp takes R = rows_in_flight items at a time (rows_dots)
// and reduces their 2R sums in one warp_sums: lane l < 16 holds x.x of
// item l / (16 / R), lane l ^ 16 its x.q, and the first lane of each item
// stores it.
template <int LAYOUT, int VPL>
__device__ __forceinline__ void warp_dists(const Rows& t, const int* wid,
                                           const int* wpos, int count,
                                           int first, int stride,
                                           const float* q, float qq,
                                           int metric, float* out) {
  constexpr int R = rows_in_flight<LAYOUT, VPL>();
  const int lane = threadIdx.x & 31;
  for (; first < count; first += stride) {
    int id[R];
#pragma unroll
    for (int r = 0; r < R; ++r) id[r] = first + r < count ? wid[first + r] : -1;
    float a[R], b[R];
    rows_dots<LAYOUT, VPL, R>(t, id, q, a, b);
    float v[2 * R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = a[r];
      v[R + r] = b[r];
    }
    const float xx = warp_sums(v, lane);
    const float xq = __shfl_xor_sync(kFull, xx, 16);
    constexpr int per = 16 / R;
    const int i = first + lane / per;
    if (lane < 16 && lane % per == 0 && i < count)
      out[wpos[i]] = combine(xx, xq, qq, metric);
  }
}

// The layers Algorithm 1 scans for frontier node u over inclusive rank
// range [L, R], as a bit mask (uniform over the warp; ref.edge_scan_valid):
// lane `l` evaluates layer l's segment closed forms; a ballot gives the
// first fully covered layer ft and the skip-layer set, and layer l is
// scanned iff l <= ft and not skipped. Requires layers <= 32 (the wrappers
// check logn <= 30).
__device__ __forceinline__ unsigned warp_scan_layers(int u, int L, int R,
                                                     int layers, int logn,
                                                     bool skip_layers) {
  const int lane = threadIdx.x & 31;
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
  return __ballot_sync(kFull, lane < layers && lane <= ft && !skip);
}

// Algorithm 1's selection for frontier node u and range [L, R], by one
// warp: writes out[0..m_out) (shared memory of this warp), the first m_out
// DISTINCT valid ids in position order, -1 padded. That is exactly
// ref.select_edges' lazy dedup, whose priority is the flat position and
// whose every step wipes all copies of the id it took. fetch(p, scanned)
// gives the id at position p < npos and whether its layer is scanned; an
// id is valid when scanned, >= 0, in [L, R] and not u. The warp reads 32
// positions a step and stops once m_out ids are out; an id is dropped when
// emitted before or held by an earlier lane of the step (__match_any_sync).
template <class Fetch>
__device__ __forceinline__ void warp_select(Fetch fetch, int npos, int u,
                                            int L, int R, int m_out,
                                            int* out) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int base = 0; base < npos && cnt < m_out; base += 32) {
    const int p = base + lane;
    int f = -1;
    bool valid = false;
    if (p < npos) {
      bool scanned;
      f = fetch(p, scanned);
      valid = scanned && f >= 0 && f >= L && f <= R && f != u;
    }
    bool dup = false;
    if (valid)
      for (int i = 0; i < cnt; ++i) dup |= out[i] == f;
    const unsigned same = __match_any_sync(kFull, valid ? f : -1 - lane);
    dup |= (same & lanes_below(lane)) != 0;
    const bool keep = valid && !dup;
    const unsigned bal = __ballot_sync(kFull, keep);
    const int rank = __popc(bal & lanes_below(lane));
    if (keep && cnt + rank < m_out) out[cnt + rank] = f;
    cnt = min(m_out, cnt + __popc(bal));
    __syncwarp();
  }
  for (int i = cnt + lane; i < m_out; i += 32) out[i] = -1;
  __syncwarp();
}

// Whether the scanned layers' ids can be copied 16 bytes at a time: m a
// multiple of 4 (so every layer and every K-int shared slice starts on 16
// bytes) and the table 16-byte aligned. Host side.
inline bool edge_copy_vec(const int* nbrs, int m) {
  return m % 4 == 0 && reinterpret_cast<uintptr_t>(nbrs) % 16 == 0;
}

// Algorithm 1 edge improvisation for frontier node `us` and inclusive rank
// range [L, R], by one warp, from u's packed edge block of the int32[n,
// layers, m] table: finds the layers it scans (warp_scan_layers), copies
// just those layers' ids into `eb` (shared memory, K = layers * m ints,
// 16-byte aligned when `vec`: edge_copy_vec) by cp.async, all at once,
// then runs the selection on shared memory (warp_select) into out[0 ..
// m_out) (shared memory). `lw`: 32 ints of shared memory for the scanned
// layers' indices. Two dependent round trips: the caller's (u, L, R), then
// the ids. An inactive row (us < 0) scans no layer and gives m_out -1s.
// hop.cu and edge_select.cu both call it, so the fused and the composed
// hop select on one code path.
__device__ __forceinline__ void warp_select_staged(
    const int* __restrict__ nbrs, int n, int layers, int m, int logn,
    bool skip_layers, bool vec, int us, int L, int R, int m_out, int* eb,
    int* lw, int* out) {
  const int lane = threadIdx.x & 31;
  const unsigned lmask =
      us >= 0 ? warp_scan_layers(us, L, R, layers, logn, skip_layers) : 0u;
  const int nl = __popc(lmask);
  if ((lmask >> lane) & 1u) lw[__popc(lmask & lanes_below(lane))] = lane;
  __syncwarp();
  const int* src =
      nbrs + static_cast<size_t>(min(max(us, 0), n - 1)) * layers * m;
  if (vec) {
    const int m4 = m >> 2;
    for (int i = lane; i < nl * m4; i += 32) {
      const int li = i / m4, c = (i - li * m4) * 4;
      copy16_async(eb + li * m + c, src + lw[li] * m + c);
    }
  } else {
    for (int i = lane; i < nl * m; i += 32) {
      const int li = i / m;
      copy4_async(eb + i, src + lw[li] * m + (i - li * m));
    }
  }
  copy_async_wait();
  __syncwarp();
  warp_select(
      [&](int p, bool& scanned) {
        scanned = true;
        return eb[p];
      },
      nl * m, us, L, R, m_out, out);
}

}  // namespace rt
