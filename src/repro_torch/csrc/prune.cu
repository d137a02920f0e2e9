// alpha-RNG construction prune, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/prune.py::_prune_kernel (line 44;
// pallas_call at line 234). Semantics: the port's kernels/ref.py::prune:
// first-occurrence dedup in (du, position) order, then at most m sweeps
// that each take the live candidate with the least (class, du, position)
// (class 0 unsuppressed, class 1 the HNSW fill of suppressed survivors);
// a class-0 pick is a keep and suppresses every candidate j with
// alpha * cc_j < du_j, cc_j = max(xx_j - 2 x_j.x_p + xx_p, 0), the same
// expansion and compare as the plain version.
//
// Bound on the H100: memory. Each build node reads C candidate rows (d*4
// bytes), ids and distances, and writes m ids; its flops are at most
// m*C*2d, about m/2 flops per byte read, far below the card's 20. The
// least time is B*C*(d*4+8) + B*m*4 bytes over the memory rate. Design:
// one block per build node; its candidate rows are gathered ONCE with
// 16-byte loads, ||x||^2 reduced on the way in, and the sweeps take a
// block-wide lexicographic argmin over (class, du, pos) by warp shuffles,
// then one warp per live, not yet suppressed candidate computes the keep's
// cc column (a row already suppressed stays so: skipping it changes
// nothing).
//
// Where the rows live. The first `staged` candidate rows are copied into
// dynamic shared memory; the rest stay in global memory and the sweeps
// read them there (L2). While all C rows fit (C=80 or 128 at d=128: 40-64
// KB) staged == C, as at model widths they do not: C=144 rows of d=1024
// are 576 KB, C=128 of d=8192 4 MB, against 227 KB per block. A keep whose
// row is not staged is first copied into a one-row buffer, so x_p is
// always read from shared memory. Every dot runs the same lane-strided
// fmaf loop and warp reduction wherever its row lives, so `staged` never
// changes a result (kernels/prune.py::smem_plan picks it).
//
// Stored layouts (the codec body, TPU prune.py:95-105, set-up :207-219):
// the table may be f32, bf16, f16, int8 codes with a per-row scale, or PQ
// codes with their codebook (csrc/common.cuh::Rows). A row is decoded once,
// as it is gathered: bf16/f16 widen exactly, int8 is code * scale rounded
// once (__fmul_rn, as storage.decode_rows computes it), PQ reads each
// subspace's centroid from the codebook in global memory (L1/L2 keep it;
// never copied per block). A staged row goes into shared memory as f32, so
// smem_plan is the same for every layout; an unstaged row is decoded in
// the sweep with the same loads and the same fmaf order. The bound then
// counts the stored row width: bf16/f16 rows are half, int8 rows a quarter
// (plus 4 bytes of scale), PQ rows one byte per subspace.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned char kValid = 1, kSupp = 2, kTaken = 4, kDup = 8;

struct Key {
  int cls;
  float du;
  int pos;
};

__device__ __forceinline__ bool less(const Key& a, const Key& b) {
  if (a.cls != b.cls) return a.cls < b.cls;
  if (a.du != b.du) return a.du < b.du;
  return a.pos < b.pos;
}

__device__ __forceinline__ Key warp_min(Key k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Key other{__shfl_xor_sync(rt::kFull, k.cls, o),
              __shfl_xor_sync(rt::kFull, k.du, o),
              __shfl_xor_sync(rt::kFull, k.pos, o)};
    if (less(other, k)) k = other;
  }
  return k;
}

// Element loads of one stored row, decoded to f32 (s: the row's int8 scale,
// 1 otherwise). load4 reads elements 4k..4k+3 with one vector load; it is
// called only where t.vec says the rows are aligned for it.
template <int LAYOUT>
__device__ __forceinline__ float row_scale(const rt::Rows& t, int row) {
  if constexpr (LAYOUT == rt::kInt8) return __ldg(t.aux + row);
  return 1.f;
}

template <int LAYOUT>
__device__ __forceinline__ float load1(const rt::Rows& t, int row, int k,
                                       float s) {
  const size_t base = static_cast<size_t>(row) * t.d;
  if constexpr (LAYOUT == rt::kF32) {
    return __ldg(static_cast<const float*>(t.data) + base + k);
  } else if constexpr (LAYOUT == rt::kBF16 || LAYOUT == rt::kF16) {
    return rt::half_bits(
        __ldg(static_cast<const unsigned short*>(t.data) + base + k),
        LAYOUT == rt::kBF16);
  } else if constexpr (LAYOUT == rt::kInt8) {
    return __fmul_rn(
        static_cast<float>(__ldg(static_cast<const signed char*>(t.data) +
                                 base + k)),
        s);
  } else {  // kPQ: subspace j's centroid, element k - j*dsub
    const int dsub = t.d / t.sub;
    const int j = k / dsub;
    const int c = __ldg(static_cast<const unsigned char*>(t.data) +
                        static_cast<size_t>(row) * t.sub + j);
    return __ldg(t.aux + (static_cast<size_t>(j) * 256 + c) * dsub +
                 (k - j * dsub));
  }
}

template <int LAYOUT>
__device__ __forceinline__ float4 load4(const rt::Rows& t, int row, int k4,
                                        float s) {
  const size_t base = static_cast<size_t>(row) * t.d;
  if constexpr (LAYOUT == rt::kF32) {
    return __ldg(reinterpret_cast<const float4*>(
                     static_cast<const float*>(t.data) + base) + k4);
  } else if constexpr (LAYOUT == rt::kBF16 || LAYOUT == rt::kF16) {
    constexpr bool bf = LAYOUT == rt::kBF16;
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
                                static_cast<const unsigned short*>(t.data) +
                                base) + k4);
    return make_float4(rt::half_bits(raw.x & 0xffffu, bf),
                       rt::half_bits(raw.x >> 16, bf),
                       rt::half_bits(raw.y & 0xffffu, bf),
                       rt::half_bits(raw.y >> 16, bf));
  } else if constexpr (LAYOUT == rt::kInt8) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(
                              static_cast<const signed char*>(t.data) +
                              base) + k4);
    return make_float4(__fmul_rn(static_cast<float>(c.x), s),
                       __fmul_rn(static_cast<float>(c.y), s),
                       __fmul_rn(static_cast<float>(c.z), s),
                       __fmul_rn(static_cast<float>(c.w), s));
  } else {  // kPQ: four elements of one subspace (dsub % 4 == 0)
    const int dsub = t.d / t.sub;
    const int k = 4 * k4;
    const int j = k / dsub;
    const int c = __ldg(static_cast<const unsigned char*>(t.data) +
                        static_cast<size_t>(row) * t.sub + j);
    return __ldg(reinterpret_cast<const float4*>(
        t.aux + (static_cast<size_t>(j) * 256 + c) * dsub + (k - j * dsub)));
  }
}

// x.y of one candidate row with the keep's row xp (shared memory), lanes
// strided over d, reduced over the warp: the row in shared memory ...
__device__ __forceinline__ float row_dot(const float* xj, const float* xp,
                                         int d, int vec4, int lane) {
  float a = 0.f;
  if (vec4) {
    const float4* a4 = reinterpret_cast<const float4*>(xj);
    const float4* b4 = reinterpret_cast<const float4*>(xp);
    for (int k = lane; k < (d >> 2); k += 32) {
      const float4 u = a4[k], v = b4[k];
      a = fmaf(u.x, v.x, a);
      a = fmaf(u.y, v.y, a);
      a = fmaf(u.z, v.z, a);
      a = fmaf(u.w, v.w, a);
    }
  } else {
    for (int k = lane; k < d; k += 32) a = fmaf(xj[k], xp[k], a);
  }
  return rt::warp_sum(a);
}

// ... or stored in global memory, decoded on the fly: the same sum in the
// same order.
template <int LAYOUT>
__device__ __forceinline__ float row_dot_ldg(const rt::Rows& t, int row,
                                             const float* xp, int vec4,
                                             int lane) {
  const int d = t.d;
  const float s = row_scale<LAYOUT>(t, row);
  float a = 0.f;
  if (vec4) {
    const float4* b4 = reinterpret_cast<const float4*>(xp);
#pragma unroll 4
    for (int k = lane; k < (d >> 2); k += 32) {
      const float4 u = load4<LAYOUT>(t, row, k, s), v = b4[k];
      a = fmaf(u.x, v.x, a);
      a = fmaf(u.y, v.y, a);
      a = fmaf(u.z, v.z, a);
      a = fmaf(u.w, v.w, a);
    }
  } else {
    for (int k = lane; k < d; k += 32)
      a = fmaf(load1<LAYOUT>(t, row, k, s), xp[k], a);
  }
  return rt::warp_sum(a);
}

template <int LAYOUT>
__global__ void __launch_bounds__(kThreads)
prune_kernel(const int* __restrict__ cand_ids,
             const float* __restrict__ cand_dists, const rt::Rows t,
             int* __restrict__ out, int C, int n, int m, float alpha,
             int fill, int vec4, int staged) {
  extern __shared__ float4 smem4[];
  const int d = t.d;
  const int dp = (d + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem4);   // [staged][dp]
  float* xk = xs + static_cast<size_t>(staged) * dp;  // [dp] if staged < C
  float* xx = xk + (staged < C ? dp : 0);        // [C]
  float* du = xx + C;                            // [C]
  int* ids = reinterpret_cast<int*>(du + C);     // [C]
  unsigned char* flags = reinterpret_cast<unsigned char*>(ids + C);  // [C]
  __shared__ Key red[kWarps];
  __shared__ Key pick;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* bid = cand_ids + static_cast<size_t>(b) * C;
  const float* bdu = cand_dists + static_cast<size_t>(b) * C;
  int* bout = out + static_cast<size_t>(b) * m;

  // gather the candidate rows once (staging the first `staged`);
  // ||x||^2 on the way in
  for (int c = warp; c < C; c += kWarps) {
    const int id = bid[c];
    const float dc = bdu[c];
    const bool stage = c < staged;  // uniform over the warp
    float* dst = xs + static_cast<size_t>(c) * dp;
    float a = 0.f;
    if (id >= 0) {  // uniform over the warp
      const int row = min(id, n - 1);
      const float s = row_scale<LAYOUT>(t, row);
      if (vec4) {
        float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
        for (int k = lane; k < (d >> 2); k += 32) {
          const float4 v = load4<LAYOUT>(t, row, k, s);
          if (stage) d4[k] = v;
          a = fmaf(v.x, v.x, a);
          a = fmaf(v.y, v.y, a);
          a = fmaf(v.z, v.z, a);
          a = fmaf(v.w, v.w, a);
        }
      } else {
        for (int k = lane; k < d; k += 32) {
          const float v = load1<LAYOUT>(t, row, k, s);
          if (stage) dst[k] = v;
          a = fmaf(v, v, a);
        }
      }
    }
    a = rt::warp_sum(a);
    if (lane == 0) {
      xx[c] = a;
      du[c] = dc;
      ids[c] = id;
      flags[c] = (id >= 0 && isfinite(dc)) ? kValid : 0;
    }
  }
  __syncthreads();

  // first-occurrence dedup in (du, position) order
  for (int j = threadIdx.x; j < C; j += kThreads) {
    if (!(flags[j] & kValid)) continue;
    const int idj = ids[j];
    const float dj = du[j];
    for (int i = 0; i < C; ++i) {
      if (i != j && (flags[i] & kValid) && ids[i] == idj &&
          (du[i] < dj || (du[i] == dj && i < j))) {
        flags[j] |= kDup;
        break;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C; j += kThreads)
    if (flags[j] & kDup) flags[j] = 0;
  __syncthreads();

  for (int step = 0; step < m; ++step) {
    Key best{2, INFINITY, 1 << 30};
    for (int j = threadIdx.x; j < C; j += kThreads) {
      const unsigned char f = flags[j];
      if (!(f & kValid) || (f & kTaken)) continue;
      const int cls = (f & kSupp) ? (fill ? 1 : 2) : 0;
      if (cls == 2) continue;
      const Key k{cls, du[j], j};
      if (less(k, best)) best = k;
    }
    best = warp_min(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      Key k = lane < kWarps ? red[lane] : Key{2, INFINITY, 1 << 30};
      k = warp_min(k);
      if (lane == 0) pick = k;
    }
    __syncthreads();
    const Key p = pick;
    if (p.cls == 2) {  // nothing left: the rest of the row is -1
      for (int i = step + threadIdx.x; i < m; i += kThreads) bout[i] = -1;
      break;
    }
    if (threadIdx.x == 0) bout[step] = ids[p.pos];
    if (p.cls == 0) {  // a keep: its cc column suppresses the live rest
      const float* xp = xs + static_cast<size_t>(p.pos) * dp;
      if (p.pos >= staged) {  // uniform: decode the keep's row in first
        const int row = min(ids[p.pos], n - 1);
        const float s = row_scale<LAYOUT>(t, row);
        for (int k = threadIdx.x; k < d; k += kThreads)
          xk[k] = load1<LAYOUT>(t, row, k, s);
        xp = xk;
        __syncthreads();
      }
      const float xxp = xx[p.pos];
      for (int j = warp; j < C; j += kWarps) {
        const unsigned char f = flags[j];
        // uniform over the warp; a suppressed row stays suppressed
        if (!(f & kValid) || (f & (kTaken | kSupp))) continue;
        const float xy =
            j < staged
                ? row_dot(xs + static_cast<size_t>(j) * dp, xp, d, vec4, lane)
                : row_dot_ldg<LAYOUT>(t, min(ids[j], n - 1), xp, vec4, lane);
        if (lane == 0) {
          const float cc = fmaxf((xx[j] - 2.0f * xy) + xxp, 0.0f);
          if (alpha * cc < du[j]) flags[j] |= kSupp;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) flags[p.pos] |= kTaken;
    __syncthreads();
  }
}

template <int LAYOUT>
int launch(const void* cand_ids, const void* cand_dists, const rt::Rows& t,
           void* out, int B, int C, int n, int m, float alpha, int fill,
           int vec4, int staged, cudaStream_t stream) {
  const int dp = (t.d + 3) & ~3;
  const size_t smem =
      (static_cast<size_t>(staged) + (staged < C ? 1 : 0)) * dp *
          sizeof(float) +
      static_cast<size_t>(C) * (2 * sizeof(float) + sizeof(int) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      prune_kernel<LAYOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  prune_kernel<LAYOUT><<<B, kThreads, smem, stream>>>(
      static_cast<const int*>(cand_ids), static_cast<const float*>(cand_dists),
      t, static_cast<int*>(out), C, n, m, alpha, fill, vec4, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cand_ids int32[B, C], cand_dists f32[B, C], a vector table of `layout`
// (csrc/common.cuh::Layout: data = rows or codes, aux = int8 scales or the
// PQ codebook, sub = PQ subspaces) -> out int32[B, m]. Stages the first
// `staged` (<= C) candidate rows in shared memory as f32: staged*dp*4
// bytes, dp*4 more for the keep-row buffer when staged < C, and C*13 for
// the per-candidate state.
RT_API int rt_prune(const void* cand_ids, const void* cand_dists,
                    const void* data, const void* aux, void* out, int B,
                    int C, int d, int n, int sub, int layout, int m,
                    float alpha, int fill, int staged, void* stream) {
  const rt::Rows t{data, static_cast<const float*>(aux), d, sub,
                   rt::rows_vec(layout, data, aux, d, sub)};
  // the order of every sum, staged or not: float4 groups where the stored
  // rows take vector loads (rows_vec), else one element per lane step
  const int vec4 = t.vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case rt::kF32:
      return launch<rt::kF32>(cand_ids, cand_dists, t, out, B, C, n, m, alpha,
                              fill, vec4, staged, s);
    case rt::kBF16:
      return launch<rt::kBF16>(cand_ids, cand_dists, t, out, B, C, n, m,
                               alpha, fill, vec4, staged, s);
    case rt::kF16:
      return launch<rt::kF16>(cand_ids, cand_dists, t, out, B, C, n, m, alpha,
                              fill, vec4, staged, s);
    case rt::kInt8:
      return launch<rt::kInt8>(cand_ids, cand_dists, t, out, B, C, n, m,
                               alpha, fill, vec4, staged, s);
    case rt::kPQ:
      return launch<rt::kPQ>(cand_ids, cand_dists, t, out, B, C, n, m, alpha,
                             fill, vec4, staged, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
