// Blockwise (flash) attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (line 34; pallas_call at line 147). Semantics: that kernel's, variant for
// variant: causal or bidirectional, GQA (kv head h // (Hq / Hkv)), a
// sliding window (key j seen by query i iff i - window < j), a logit
// softcap (cap * tanh(s / cap)), q_offset (absolute position of query row
// 0), ragged Sq / Skv (keys at or past Skv masked). The online softmax
// keeps the running max m, sum l and accumulator acc in f32 and returns
// acc / max(l, 1e-30) in q's dtype, so a row that sees no key (possible
// only with a window and a large q_offset) is 0, as on the TPU; the plain
// version kernels/ref.py::attention returns the mean of V there instead.
//
// Bound on the H100: at the embed path's S = 32 memory (q, k, v and out
// read and written once, 4*S*Dh flops per (query, key) pair against 2*Dh
// bytes per row); at S = 4096 the operations. This first kernel computes on
// the CUDA cores in f32, not on the tensor cores (wgmma and TMA are later
// work), so its ceiling is the f32 rate, not the bf16 peak the bound uses.
// Design: one block of 4 warps per (b*Hq + h, 32-row query tile); the query
// tile (pre-scaled) and each 32-key K/V tile are staged in shared memory as
// f32, rows padded by 4 floats so that the lanes' 16-byte loads of 32
// different rows hit distinct banks. Each warp owns 8 query rows: lane j
// scores key j against the 8 rows, the row statistics reduce over the warp
// by shuffles, and each lane accumulates P.V into the 4 (Dh <= 128) or 8
// (Dh <= 256) output columns it owns. Whole key tiles above the causal
// diagonal or outside the window are never loaded. Shared memory is
// 96 * (Dh + 4) * 4 bytes: 67.6 KB at Dh = 128, 133 KB at Dh = 256.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block
constexpr int kBK = 32;                // keys per tile: one per lane
constexpr float kNeg = -1e30f;         // the TPU kernel's mask value

enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, g, Sq, Skv, Dh;
  // element strides of batch, head and position (the last dim is dense)
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  float scale;
  int causal;
  int window;       // <= 0: none
  int has_softcap;
  float softcap;
  int q_offset;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(rt::kFull, v, o));
  return v;
}

// rows [r0, r0 + nrows) x Dh of one (batch, head) slab, as f32 times `mul`,
// zero outside [0, limit) x [0, Dh), into s[nrows][ld]
template <typename T>
__device__ __forceinline__ void stage(float* s, int ld, const T* __restrict__ src,
                                      long long ss, int r0, int nrows,
                                      int limit, int Dh, int Dp, float mul) {
  for (int i = threadIdx.x; i < nrows * Dp; i += kThreads) {
    const int r = i / Dp, c = i - r * Dp;
    const int row = r0 + r;
    float x = 0.f;
    if (row < limit && c < Dh) x = to_f(src[row * ss + c]) * mul;
    s[r * ld + c] = x;
  }
}

// NT: float4 column chunks per lane (Dp <= 128 * NT)
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int Dp = (p.Dh + 3) & ~3;
  const int ld = Dp + 4;
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][ld]
  float* ks = qs + kBQ * ld;                     // [kBK][ld]
  float* vs = ks + kBK * ld;                     // [kBK][ld]

  const int bh = blockIdx.x;                     // b * Hq + h
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int kvh = h / p.g;                       // (b*Hq + h) // g, per b
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qsrc = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* ksrc = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vsrc = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;

  stage(qs, ld, qsrc, p.qss, q0, kBQ, p.Sq, p.Dh, Dp, p.scale);

  // the key range any row of this tile can see
  const int qpos0 = q0 + p.q_offset;
  int k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, max(qpos0 + kBQ, 0));
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, qpos0 - p.window + 1);

  const int r0 = warp * kRows;
  float m[kRows], l[kRows];
  float4 acc[kRows][NT];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = (k_lo / kBK) * kBK; kt < k_hi; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage(ks, ld, ksrc, p.kss, kt, kBK, p.Skv, p.Dh, Dp, 1.f);
    stage(vs, ld, vsrc, p.vss, kt, kBK, p.Skv, p.Dh, Dp, 1.f);
    __syncthreads();

    // lane = key: scores against the warp's rows, f32 fmaf over Dh
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * ld);
    for (int c = 0; c < (Dp >> 2); ++c) {
      const float4 kk = krow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(qs + (r0 + r) * ld)[c];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int kpos = kt + lane;
    float pr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = qpos0 + r0 + r;
      float x = s[r];
      if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
      bool ok = kpos < p.Skv;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      x = ok ? x : kNeg;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float pv = ok ? expf(x - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rt::warp_sum(pv);
      m[r] = m_new;
      pr[r] = pv;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        acc[r][t].x *= corr;
        acc[r][t].y *= corr;
        acc[r][t].z *= corr;
        acc[r][t].w *= corr;
      }
    }

    // acc += P.V over the tile's keys, lane-owned column chunks
    for (int j = 0; j < kBK; ++j) {
      float4 vv[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int c = lane + 32 * t;
        vv[t] = c < (Dp >> 2)
                    ? reinterpret_cast<const float4*>(vs + j * ld)[c]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(rt::kFull, pr[r], j);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          acc[r][t].x = fmaf(pj, vv[t].x, acc[r][t].x);
          acc[r][t].y = fmaf(pj, vv[t].y, acc[r][t].y);
          acc[r][t].z = fmaf(pj, vv[t].z, acc[r][t].z);
          acc[r][t].w = fmaf(pj, vv[t].w, acc[r][t].w);
        }
      }
    }
  }

  T* out = static_cast<T*>(p.o) + static_cast<long long>(bh) * p.Sq * p.Dh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = 4 * (lane + 32 * t);
      T* dst = out + static_cast<long long>(row) * p.Dh + c;
      const float4 a = acc[r][t];
      if (c + 0 < p.Dh) dst[0] = from_f<T>(a.x / denom);
      if (c + 1 < p.Dh) dst[1] = from_f<T>(a.y / denom);
      if (c + 2 < p.Dh) dst[2] = from_f<T>(a.z / denom);
      if (c + 3 < p.Dh) dst[3] = from_f<T>(a.w / denom);
    }
  }
}

template <typename T, int NT>
int launch(const Params& p, int BH, int Sq, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  flash_kernel<T, NT><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int BH, int Sq, size_t smem, cudaStream_t st) {
  if ((p.Dh + 3) / 4 <= 32) return launch<T, 1>(p, BH, Sq, smem, st);
  return launch<T, 2>(p, BH, Sq, smem, st);
}

}  // namespace

// q [B, Hq, Sq, Dh], k / v [B, Hkv, Skv, Dh] (any batch, head and position
// strides, in elements; the last dim dense), all of one dtype (0 f32,
// 1 bf16, 2 f16) -> o [B, Hq, Sq, Dh] dense, in that dtype. Dh <= 256,
// Hq % Hkv == 0; window <= 0 means none; softcap applies when has_softcap.
RT_API int rt_flash_attention(const void* q, const void* k, const void* v,
                              void* o, int dtype, int B, int Hq, int Hkv,
                              int Sq, int Skv, int Dh, long long qsb,
                              long long qsh, long long qss, long long ksb,
                              long long ksh, long long kss, long long vsb,
                              long long vsh, long long vss, float scale,
                              int causal, int window, int has_softcap,
                              float softcap, int q_offset, void* stream) {
  Params p{q,   k,   v,   o,   Hq,  Hq / Hkv, Sq,     Skv,
           Dh,  qsb, qsh, qss, ksb, ksh,      kss,    vsb,
           vsh, vss, scale, causal, window, has_softcap, softcap, q_offset};
  const int Dp = (Dh + 3) & ~3;
  const size_t smem = static_cast<size_t>(kBQ + 2 * kBK) * (Dp + 4) *
                      sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch<float>(p, B * Hq, Sq, smem, st);
    case kBF16: return dispatch<__nv_bfloat16>(p, B * Hq, Sq, smem, st);
    case kF16: return dispatch<__half>(p, B * Hq, Sq, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
