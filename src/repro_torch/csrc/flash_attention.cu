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
// read and written once); at S = 4096 the operations, 4 * pairs * Dh at
// the bf16 tensor-core peak (989 TFLOP/s): 0.0695 ms for B 1, Hq 16, Dh
// 128, causal; in f32, three tf32 products of that work at the TF32 peak
// (495 TFLOP/s), the least full-precision f32 can take on this card. Three
// bodies, chosen by dtype and head dim alone:
//   * bf16 / f16 with Dh % 16 == 0 (every config's head dim): the
//     tensor-core body below (namespace tc): wgmma fed by a TMA ring, P
//     split into hi and lo halves so that P.V keeps 16 bits of P. The
//     split makes its own floor 1.5x the function's: 0.104 ms at S = 4096.
//   * f32 with Dh % 4 == 0 (TMA's 16-byte strides): the 3xTF32 body
//     (namespace x3): the tensor-core body's tiling and TMA loads, both
//     products as three tf32 wgmmas on big / small halves of each value.
//   * 16-bit inputs with another head dim, and f32 with Dh % 4 != 0: the
//     CUDA-core body, f32 FMAs: one block of 4 warps per (b*Hq + h, 32-row
//     query tile); the query tile (pre-scaled) and each 32-key K/V tile
//     staged in shared memory as f32, rows padded by 4 floats; each warp
//     owns 8 query rows, lane j scores key j, row statistics reduce over
//     the warp by shuffles, each lane accumulates P.V into the 4 (Dh <=
//     128) or 8 (Dh <= 256) output columns it owns. Shared memory 96 * (Dh
//     + 4) * 4 bytes.
// All skip whole key tiles above the causal diagonal or outside the
// window.
#include "common.cuh"
#include "hopper.cuh"

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

// Dynamic shared memory of one block of the CUDA-core body
// (kernels/flash_attention.py::cuda_cores_smem mirrors it): the query tile
// and one K and one V tile, rows of Dh rounded up to 4 plus 4 floats.
size_t cuda_cores_smem(int Dh) {
  const int Dp = (Dh + 3) & ~3;
  return static_cast<size_t>(kBQ + 2 * kBK) * (Dp + 4) * sizeof(float);
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
  const size_t smem = cuda_cores_smem(Dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch<float>(p, B * Hq, Sq, smem, st);
    case kBF16: return dispatch<__nv_bfloat16>(p, B * Hq, Sq, smem, st);
    case kF16: return dispatch<__half>(p, B * Hq, Sq, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body: bf16 / f16 inputs with Dh % 16 == 0 (Dh <= 256).
//
// One warpgroup (128 threads) per 64-row query tile. Rows are either 64
// positions of one head, or -- when Sq <= 32 -- the Sq positions of P
// query heads that share one kv head (P = min(g, 64 / Sq)), so that a GQA
// group reads its K/V tile once (the embed path: g = 2, S = 32, 64 rows).
// Q (once) and each 32-key K/V tile come by TMA into 128-byte-swizzled
// shared memory, Dh split into 64-column chunks (a head dim that is not a
// multiple of 64 is zero-filled to DP by the tensor map); K/V go into a
// ring of two stages on mbarriers, so tile j+2's copy runs under tile j+1's
// products. A block needs 48 KB at Dh 128 (96 KB at 256), so four share an
// SM and one block's softmax runs under another's wgmmas. S = Q.K^T is a
// wgmma with f32 accumulation (the products of 16-bit values are exact);
// the scale, softcap, masks and the online softmax (exp2 of
// log2(e)-scaled logits) work on the f32 fragment in registers, row
// statistics over the 4 threads of a quad; a masked logit is -inf, so a
// zero-filled key past Skv gets p = 0, never just a zero score. P is split
// into P_hi = T(p) and P_lo = T(p - P_hi), and both go into the P.V wgmma
// from registers (V's tile as loaded, MN-major): 16 bits of p (22 for
// f16) where one rounding would keep 8, at 1.5x the tensor-core work. The
// output, acc / max(l, 1e-30) in T, is staged in shared memory and written
// in 16-byte stores.

namespace tc {

constexpr int kThreads = 128;
constexpr int kRows = 64;
constexpr int kKeys = 32;              // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;
  int Hq, Hkv, g, Sq, Skv, Dh;
  int P;                 // query heads packed in one tile
  int RQ;                // positions per head in one tile (P * RQ <= 64)
  int tpg;               // tiles per kv head: ceil(g / P)
  float scale;
  int causal, window, has_softcap;
  float softcap;
  int q_offset;
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the low part of a hi/lo split: x - T(x), rounded to T
template <typename T>
__device__ __forceinline__ float rest(float x) {
  return x - to_f(from_f<T>(x));
}

// The key tiles a tile of query positions [q0, q0 + RQ) can see, as the
// first tile's key kt0 and the count; qlo and qhi the tile's first and
// last absolute positions.
struct KeyTiles {
  int qlo, qhi, kt0, ntiles;
};

__device__ __forceinline__ KeyTiles key_tiles(const Params& p, int q0) {
  KeyTiles t;
  t.qlo = q0 + p.q_offset;
  t.qhi = min(q0 + p.RQ, p.Sq) - 1 + p.q_offset;
  int k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, max(t.qhi + 1, 0));
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, t.qlo - p.window + 1);
  t.kt0 = (k_lo / kKeys) * kKeys;
  t.ntiles = k_hi > t.kt0 ? (k_hi - t.kt0 + kKeys - 1) / kKeys : 0;
  return t;
}

// The online softmax over the S fragment of the key tile at kt (logits
// times `mul`, then the softcap, in log2 units), in place: p written over
// the logits, m and l updated, each row's correction factor returned in
// corr. Masks are applied only on a tile that crosses Skv, the diagonal
// or the window's edge; a masked logit is -inf, so a zero-filled key past
// Skv gets p = 0, never just a zero score.
__device__ __forceinline__ void online_softmax(float (&s)[kKeys / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2],
                                               const Params& p, float mul,
                                               const KeyTiles& kr, int kt,
                                               const int (&qpos)[2],
                                               int quad) {
  const bool need_mask =
      kt + kKeys > p.Skv || (p.causal && kt + kKeys - 1 > kr.qlo) ||
      (p.window > 0 && kt <= kr.qhi - p.window);
  const float ml2 = mul * kLog2e;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNeg;
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[4 * jj + 2 * i + c];
        if (p.has_softcap) {
          x *= mul;
          x = p.softcap * tanhf(x / p.softcap) * kLog2e;
        } else {
          x *= ml2;
        }
        if (need_mask) {
          const int kpos = kt + 8 * jj + 2 * quad + c;
          bool ok = kpos < p.Skv;
          if (p.causal) ok = ok && kpos <= qpos[i];
          if (p.window > 0) ok = ok && kpos > qpos[i] - p.window;
          x = ok ? x : -INFINITY;
        }
        s[4 * jj + 2 * i + c] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(rt::kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(rt::kFull, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    corr[i] = exp2f(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // a masked logit is -inf: exp2 gives 0 even while m is kNeg
        const float pv = exp2f(s[4 * jj + 2 * i + c] - m_new);
        s[4 * jj + 2 * i + c] = pv;
        sum += pv;
      }
    }
    l[i] = l[i] * corr[i] + sum;
    m[i] = m_new;
  }
}

// DP: Dh rounded up to a multiple of 64
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Params p) {
  constexpr int NC = DP / 64;                    // 64-column chunks
  constexpr uint32_t kQBytes = NC * kRows * 128;  // Q's buffer
  constexpr uint32_t kKVBytes = NC * kKeys * 128;   // one of K or V
  constexpr int kSAcc = kKeys / 2, kOAcc = DP / 2, kKSteps = kKeys / 16;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* kv = qs + kQBytes;                    // stage s: K then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv + 4 * kKVBytes);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;                     // [2]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  int bx = blockIdx.x;
  const int tg = bx % p.tpg;
  bx /= p.tpg;
  const int kvh = bx % p.Hkv;
  const int b = bx / p.Hkv;
  const int h0 = kvh * p.g + tg * p.P;           // first query head
  const int q0 = blockIdx.y * p.RQ;              // first position
  const KeyTiles kr = key_tiles(p, q0);          // the keys it can see
  const int kt0 = kr.kt0, ntiles = kr.ntiles;

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    sm90::mbar_init(&full[0], 1);
    sm90::mbar_init(&full[1], 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    // the Q box is P heads x RQ positions: P * RQ of the 64 rows
    sm90::mbar_arrive_expect_tx(bar_q, NC * p.P * p.RQ * 128);
    for (int c = 0; c < NC; ++c)
      sm90::tma_load_4d(qs + c * kRows * 128, &qmap, bar_q, 64 * c, q0, h0,
                       b);
    for (int s = 0; s < 2 && s < ntiles; ++s) {
      uint8_t* ks = kv + 2 * s * kKVBytes;
      sm90::mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
      for (int c = 0; c < NC; ++c) {
        sm90::tma_load_4d(ks + c * kKeys * 128, &kmap, &full[s], 64 * c,
                         kt0 + s * kKeys, kvh, b);
        sm90::tma_load_4d(ks + kKVBytes + c * kKeys * 128, &vmap, &full[s],
                         64 * c, kt0 + s * kKeys, kvh, b);
      }
    }
  }

  // this thread's two rows (accumulator rows r and r + 8)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + (lane >> 2) + 8 * i;
    qpos[i] = q0 + (r % p.RQ) + p.q_offset;
  }
  const int quad = lane & 3;

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[kOAcc];
#pragma unroll
  for (int e = 0; e < kOAcc; ++e) o[e] = 0.f;

  sm90::mbar_wait(bar_q, 0);
  const uint32_t qaddr = sm90::smem_u32(qs);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j & 1;
    const int kt = kt0 + j * kKeys;
    sm90::mbar_wait(&full[s], (j >> 1) & 1);
    const uint32_t kaddr = sm90::smem_u32(kv + 2 * s * kKVBytes);
    const uint32_t vaddr = kaddr + kKVBytes;

    // S = Q.K^T over Dh, 16 columns a step
    float sacc[kSAcc];
#pragma unroll
    for (int e = 0; e < kSAcc; ++e) sacc[e] = 0.f;
    sm90::fence_regs(sacc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk * 16 < p.Dh) {
        const uint32_t off = (kk & 3) << 5;   // 32 bytes a step
        sm90::wgmma_ss<kKeys, T>(
            sacc, sm90::desc_kmajor(qaddr + (kk >> 2) * kRows * 128 + off),
            sm90::desc_kmajor(kaddr + (kk >> 2) * kKeys * 128 + off), 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);

    // online softmax on the fragment: logits in log2 units
    float corr[2];
    online_softmax(sacc, m, l, corr, p, p.scale, kr, kt, qpos, quad);
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      o[4 * jj + 0] *= corr[0];
      o[4 * jj + 1] *= corr[0];
      o[4 * jj + 2] *= corr[1];
      o[4 * jj + 3] *= corr[1];
    }

    // P as the A fragments of the P.V steps, split into hi and lo
    uint32_t ahi[kKSteps][4], alo[kKSteps][4];
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sacc[8 * kk + 2 * r], x1 = sacc[8 * kk + 2 * r + 1];
        ahi[kk][r] = pack2<T>(x0, x1);
        alo[kk][r] = pack2<T>(rest<T>(x0), rest<T>(x1));
      }
    }
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint64_t dv =
          sm90::desc_mnmajor(vaddr + kk * 16 * 128, kKeys * 128);
      sm90::wgmma_rs<DP, T>(o, ahi[kk], dv, 1);
      sm90::wgmma_rs<DP, T>(o, alo[kk], dv, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);

    // every warp is done with stage s: refill it with tile j + 2
    __syncthreads();
    if (tid == 0 && j + 2 < ntiles) {
      uint8_t* ks = kv + 2 * s * kKVBytes;
      sm90::mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
      for (int c = 0; c < NC; ++c) {
        sm90::tma_load_4d(ks + c * kKeys * 128, &kmap, &full[s], 64 * c,
                         kt + 2 * kKeys, kvh, b);
        sm90::tma_load_4d(ks + kKVBytes + c * kKeys * 128, &vmap, &full[s],
                         64 * c, kt + 2 * kKeys, kvh, b);
      }
    }
  }

  // out = acc / max(l, 1e-30) in T, staged row-major in shared memory
  // (the Q and K/V buffers are free: every copy was consumed)
  __syncthreads();
  constexpr int ld = DP + 8;                     // T elements per row
  T* stage = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(rt::kFull, li, 1);
    li += __shfl_xor_sync(rt::kFull, li, 2);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int r = 16 * warp + (lane >> 2) + 8 * i;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(stage + r * ld + 8 * jj + 2 * quad) =
          pack2<T>(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(p.o);
  const int rows = min(p.P * p.RQ, kRows);
  const int c8 = p.Dh / 8;                       // 16-byte pieces per row
  for (int e = tid; e < rows * c8; e += kThreads) {
    const int r = e / c8, c = e - r * c8;
    const int hd = r / p.RQ, pos = q0 + r % p.RQ;
    if (pos >= p.Sq || tg * p.P + hd >= p.g) continue;
    const long long row =
        (static_cast<long long>(b) * p.Hq + h0 + hd) * p.Sq + pos;
    *reinterpret_cast<uint4*>(out + row * p.Dh + 8 * c) =
        *reinterpret_cast<const uint4*>(stage + r * ld + 8 * c);
  }
}

// shared memory of one block: 1 KB for alignment, Q, two K/V stages and
// three barriers (kernels/flash_attention.py::plan_tc computes the same)
template <int DP>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(DP / 64) * 128 * (64 + 4 * kKeys) + 64;
}

constexpr int kMaxDevices = 64;

template <typename T, int DP>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, const Params& p, dim3 grid,
           cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[kMaxDevices] = {};   // once a device
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_tc_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  flash_tc_kernel<T, DP><<<grid, kThreads, smem, st>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const CUtensorMap& qm, const CUtensorMap& km,
             const CUtensorMap& vm, const Params& p, int DP, dim3 grid,
             cudaStream_t st) {
  switch (DP) {
    case 64: return launch<T, 64>(qm, km, vm, p, grid, st);
    case 128: return launch<T, 128>(qm, km, vm, p, grid, st);
    case 192: return launch<T, 192>(qm, km, vm, p, grid, st);
    case 256: return launch<T, 256>(qm, km, vm, p, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The 3xTF32 body: f32 inputs with Dh % 4 == 0 (Dh <= 256).
//
// The tensor-core body's structure at f32: one warpgroup per 64-row query
// tile, GQA heads packed into the tile at Sq <= 32 (the same plan, so a
// group reads each K/V tile once), Q loaded once and each 32-key K/V tile
// brought by TMA, Dh split into 32-column chunks of 128-byte rows in the
// 128-byte swizzle (a head dim that is not a multiple of 64 is zero-filled
// to DP by the tensor map), tiles above the diagonal or outside the window
// skipped. Both products run on the tensor cores in full f32 precision,
// as csrc/distance.cu computes its f32 dots: each value a is split into
// big = cvt.rna.tf32(a) and small = a - big (exact in f32), and three tf32
// products with f32 accumulation, small.big + big.small + big.big, stand
// for a.b (the dropped small.small and the hardware's truncation of small
// to tf32 leave about 2^-21 of |a b| a product):
//   * S = (scale Q).K^T: Q is scaled, then split once into its big half
//     (over the landed tile) and its small half; each K tile is split as it
//     lands, big over the tile and small into the scratch tile X. m64n32k8
//     wgmmas from shared memory, both operands K-major. The big product
//     and the two small ones accumulate apart: the tensor cores truncate
//     an accumulator at every step, and one accumulator for all three
//     put the largest error of the card's f32 grid at 7.2e-6 of the 1e-5
//     gate (2.4e-6 to 5.3e-6 apart; NVIDIA H100 80GB HBM3).
//   * O += P.V: tf32 has no transposed operand, so V's tile ([keys][Dh],
//     MN-major for P.V) is split and transposed by the threads, chunk by
//     chunk over its own bytes: V^T's big half over the landed tile (a
//     32-column chunk of V is 32 keys x 128 bytes, and the 32 rows of V^T
//     it becomes are 32 x 128 bytes, so each chunk maps onto itself) and
//     its small half into X once the S products are done with K's. P stays
//     in registers as the A fragment, split as it is there. The k8 A
//     fragment holds columns l%4 and l%4 + 4 of a thread's rows where the
//     accumulator gives it columns 2(l%4) and 2(l%4) + 1, so the keys of
//     each 8-key step are taken in the order 0 2 4 6 1 3 5 7, and V^T's
//     rows are written in that order: no shuffle. m64nDPk8 wgmmas, A from
//     registers.
// Shared memory, the arithmetic that fixes the design: in f32 a tile is
// twice the 16-bit body's and each operand needs its small half beside it,
// so at DP 128: Q and its small half 64 KB, the K and V tiles 16 KB each
// and X 16 KB, 112 KB, plus 64 bytes of barriers and 896 of alignment
// headroom (from a 128-byte-aligned base to the 1,024-byte boundary the
// swizzle needs): 115,648 B, so two blocks share an SM (2 x (115,648 +
// 1,024 reserved) <= 233,472); at DP 256, 230,336 B, one block. A second
// K/V stage would cost 32 KB at DP 128 and leave one block an SM; instead
// K's tile is refilled with tile j + 1 as soon as the S products of tile j
// are done, and V's as soon as its P.V products are, and the other block
// on the SM runs while this one waits. X takes K's small half, then V^T's.
// The output, acc / max(l, 1e-30), is staged in shared memory (rows padded
// by 8 floats) and written in 16-byte stores.

namespace x3 {

constexpr int kThreads = 128;
constexpr int kRows = 64;
constexpr int kKeys = tc::kKeys;       // keys per K/V tile (32)
constexpr uint32_t kAlignPad = 896;    // 128-byte base -> 1,024-byte boundary

// byte offsets of one block's buffers at DP (f32 tiles of 128-byte rows)
template <int DP>
struct Layout {
  static constexpr uint32_t kQ = kRows * DP * 4;    // Q, then its big half
  static constexpr uint32_t kKV = kKeys * DP * 4;   // a K or V tile
  static constexpr uint32_t kQs = kQ;               // Q's small half
  static constexpr uint32_t kK = 2 * kQ;            // K, then its big half
  static constexpr uint32_t kV = kK + kKV;          // V, then V^T's big half
  static constexpr uint32_t kX = kV + kKV;          // K's small half, V^T's
  static constexpr uint32_t kBars = kX + kKV;       // 3 mbarriers
  static constexpr uint32_t kEnd = kBars + 64;
};

// dynamic shared memory of one block
// (kernels/flash_attention.py::tf32x3_smem computes the same)
template <int DP>
constexpr size_t tf32x3_smem() {
  return static_cast<size_t>(Layout<DP>::kEnd) + kAlignPad;
}

// a 16-byte piece of f32 values times `mul`, split: big over the values
// at `big`, small at `small`
__device__ __forceinline__ void split4(uint8_t* big, uint8_t* small, float4 v,
                                       float mul) {
  const float a[4] = {v.x * mul, v.y * mul, v.z * mul, v.w * mul};
  uint32_t bw[4], sw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bw[i] = sm90::tf32_rna(a[i]);
    sw[i] = __float_as_uint(a[i] - __uint_as_float(bw[i]));
  }
  *reinterpret_cast<uint4*>(big) = make_uint4(bw[0], bw[1], bw[2], bw[3]);
  *reinterpret_cast<uint4*>(small) = make_uint4(sw[0], sw[1], sw[2], sw[3]);
}

// a tile of `rows` rows x DP columns, split in place (times `mul`), its
// small half at the same offsets from `small`; rows from `live` on are
// written as zeros
template <int DP>
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* small,
                                           int rows, int live, float mul) {
  for (int e = threadIdx.x; e < rows * (DP / 32) * 8; e += kThreads) {
    const int pc = e & 7, r = (e >> 3) % rows, c = (e >> 3) / rows;
    const uint32_t off = c * rows * 128 + sm90::swz128(r, pc);
    float4 v = *reinterpret_cast<const float4*>(tile + off);
    if (r >= live) v = make_float4(0.f, 0.f, 0.f, 0.f);
    split4(tile + off, small + off, v, mul);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_x3_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const tc::Params p) {
  using Lay = Layout<DP>;
  constexpr int NC = DP / 32;                     // 32-column chunks
  constexpr uint32_t kTileTx = NC * kKeys * 128;  // bytes of a K or V tile
  constexpr int kSAcc = kKeys / 2, kOAcc = DP / 2, kKSteps = kKeys / 8;

  extern __shared__ __align__(128) uint8_t smem_x3[];
  const uint32_t raw = sm90::smem_u32(smem_x3);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  if (pad > kAlignPad) __trap();                  // the plan's headroom
  uint8_t* smem = smem_x3 + pad;
  uint8_t* qb = smem;
  uint8_t* qsm = smem + Lay::kQs;
  uint8_t* kt_s = smem + Lay::kK;
  uint8_t* vt_s = smem + Lay::kV;
  uint8_t* xs = smem + Lay::kX;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + Lay::kBars);
  uint64_t* bar_k = bar_q + 1;
  uint64_t* bar_v = bar_q + 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  int bx = blockIdx.x;
  const int tg = bx % p.tpg;
  bx /= p.tpg;
  const int kvh = bx % p.Hkv;
  const int b = bx / p.Hkv;
  const int h0 = kvh * p.g + tg * p.P;           // first query head
  const int q0 = blockIdx.y * p.RQ;              // first position
  const tc::KeyTiles kr = tc::key_tiles(p, q0);  // the keys it can see
  const int kt0 = kr.kt0, ntiles = kr.ntiles;

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    sm90::mbar_init(bar_k, 1);
    sm90::mbar_init(bar_v, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    // the Q box is P heads x RQ positions: P * RQ of the 64 rows
    sm90::mbar_arrive_expect_tx(bar_q, NC * p.P * p.RQ * 128);
    for (int c = 0; c < NC; ++c)
      sm90::tma_load_4d(qb + c * kRows * 128, &qmap, bar_q, 32 * c, q0, h0,
                       b);
    if (ntiles > 0) {
      sm90::mbar_arrive_expect_tx(bar_k, kTileTx);
      sm90::mbar_arrive_expect_tx(bar_v, kTileTx);
      for (int c = 0; c < NC; ++c) {
        sm90::tma_load_4d(kt_s + c * kKeys * 128, &kmap, bar_k, 32 * c, kt0,
                         kvh, b);
        sm90::tma_load_4d(vt_s + c * kKeys * 128, &vmap, bar_v, 32 * c, kt0,
                         kvh, b);
      }
    }
  }

  // this thread's two rows (accumulator rows r and r + 8)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + (lane >> 2) + 8 * i;
    qpos[i] = q0 + (r % p.RQ) + p.q_offset;
  }
  const int quad = lane & 3;
  // V's split: this lane's key (row of the landed chunk) and the column of
  // V^T it becomes, keys of an 8-key step in the P fragment's order
  const int vkey = (lane & ~7) | ((lane & 7) >> 1) | ((lane & 1) << 2);

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[kOAcc];
#pragma unroll
  for (int e = 0; e < kOAcc; ++e) o[e] = 0.f;

  sm90::mbar_wait(bar_q, 0);
  split_tile<DP>(qb, qsm, kRows, min(p.P * p.RQ, kRows), p.scale);
  const uint32_t qa = sm90::smem_u32(qb), qsa = sm90::smem_u32(qsm);
  const uint32_t ka = sm90::smem_u32(kt_s), va = sm90::smem_u32(vt_s);
  const uint32_t xa = sm90::smem_u32(xs);

  for (int j = 0; j < ntiles; ++j) {
    const int kt = kt0 + j * kKeys;
    sm90::mbar_wait(bar_k, j & 1);
    split_tile<DP>(kt_s, xs, kKeys, kKeys, 1.f);
    sm90::fence_proxy_async();       // the splits' writes, seen by wgmma
    __syncthreads();

    // S = (scale Q).K^T over Dh, 8 columns a step, three products a step:
    // big.big into sacc, the two small products into ssm (the tensor
    // cores truncate an accumulator at every step, so the large one takes
    // Dh / 8 truncations, not three times as many), added once at the end
    float sacc[kSAcc], ssm[kSAcc];
#pragma unroll
    for (int e = 0; e < kSAcc; ++e) sacc[e] = ssm[e] = 0.f;
    sm90::fence_regs(sacc);
    sm90::fence_regs(ssm);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      if (kk * 8 < p.Dh) {
        const uint32_t qo = (kk >> 2) * kRows * 128 + ((kk & 3) << 5);
        const uint32_t ko = (kk >> 2) * kKeys * 128 + ((kk & 3) << 5);
        sm90::wgmma_ss_m64n32k8_tf32(ssm, sm90::desc_kmajor(qsa + qo),
                                     sm90::desc_kmajor(ka + ko), 1);
        sm90::wgmma_ss_m64n32k8_tf32(ssm, sm90::desc_kmajor(qa + qo),
                                     sm90::desc_kmajor(xa + ko), 1);
        sm90::wgmma_ss_m64n32k8_tf32(sacc, sm90::desc_kmajor(qa + qo),
                                     sm90::desc_kmajor(ka + ko), 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);
    sm90::fence_regs(ssm);
#pragma unroll
    for (int e = 0; e < kSAcc; ++e) sacc[e] += ssm[e];

    // every warp is done with K's tile and X: refill K with tile j + 1
    __syncthreads();
    if (tid == 0 && j + 1 < ntiles) {
      sm90::mbar_arrive_expect_tx(bar_k, kTileTx);
      for (int c = 0; c < NC; ++c)
        sm90::tma_load_4d(kt_s + c * kKeys * 128, &kmap, bar_k, 32 * c,
                         kt + kKeys, kvh, b);
    }

    // online softmax on the fragment: logits (already scaled) in log2
    // units
    float corr[2];
    tc::online_softmax(sacc, m, l, corr, p, 1.f, kr, kt, qpos, quad);
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      o[4 * jj + 0] *= corr[0];
      o[4 * jj + 1] *= corr[0];
      o[4 * jj + 2] *= corr[1];
      o[4 * jj + 3] *= corr[1];
    }

    // V's tile, split and transposed chunk by chunk over its own bytes:
    // lane = key, warp w reads pieces w and w + 4 (conflict-free), writes
    // V^T rows 4 * piece + e at column vkey (conflict-free: the lanes'
    // columns are a permutation of the 32)
    sm90::mbar_wait(bar_v, j & 1);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint8_t* ch = vt_s + c * kKeys * 128;
      float4 vv[2];
#pragma unroll
      for (int it = 0; it < 2; ++it)
        vv[it] = *reinterpret_cast<const float4*>(
            ch + sm90::swz128(lane, warp + 4 * it));
      __syncthreads();               // chunk c is read before it is written
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const float a[4] = {vv[it].x, vv[it].y, vv[it].z, vv[it].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * (warp + 4 * it) + e;   // row of V^T in the chunk
          const uint32_t off = n * 128 + (((vkey >> 2) ^ (n & 7)) << 4) +
                               ((vkey & 3) << 2);
          const uint32_t bw = sm90::tf32_rna(a[e]);
          *reinterpret_cast<uint32_t*>(ch + off) = bw;
          *reinterpret_cast<float*>(xs + c * kKeys * 128 + off) =
              a[e] - __uint_as_float(bw);
        }
      }
    }
    sm90::fence_proxy_async();
    __syncthreads();

    // P as the A fragments of the P.V steps (keys 2q and 2q + 1 of a step
    // as its columns q and q + 4), split into big and small
    uint32_t pb[kKSteps][4], ps[kKSteps][4];
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const float f[4] = {sacc[4 * kk], sacc[4 * kk + 2], sacc[4 * kk + 1],
                          sacc[4 * kk + 3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pb[kk][r] = sm90::tf32_rna(f[r]);
        ps[kk][r] = __float_as_uint(f[r] - __uint_as_float(pb[kk][r]));
      }
    }
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint64_t vb = sm90::desc_kmajor(va + kk * 32);
      const uint64_t vs = sm90::desc_kmajor(xa + kk * 32);
      sm90::wgmma_rs_tf32<DP>(o, ps[kk], vb, 1);
      sm90::wgmma_rs_tf32<DP>(o, pb[kk], vs, 1);
      sm90::wgmma_rs_tf32<DP>(o, pb[kk], vb, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);

    // every warp is done with V's tile and X: refill V with tile j + 1
    __syncthreads();
    if (tid == 0 && j + 1 < ntiles) {
      sm90::mbar_arrive_expect_tx(bar_v, kTileTx);
      for (int c = 0; c < NC; ++c)
        sm90::tma_load_4d(vt_s + c * kKeys * 128, &vmap, bar_v, 32 * c,
                         kt + kKeys, kvh, b);
    }
  }

  // out = acc / max(l, 1e-30), staged row-major in shared memory (Q's
  // buffers are free: the last S product has read them)
  __syncthreads();
  constexpr int ld = DP + 8;                     // floats per staged row
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(rt::kFull, li, 1);
    li += __shfl_xor_sync(rt::kFull, li, 2);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int r = 16 * warp + (lane >> 2) + 8 * i;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj)
      *reinterpret_cast<float2*>(stage + r * ld + 8 * jj + 2 * quad) =
          make_float2(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
  }
  __syncthreads();
  float* out = static_cast<float*>(p.o);
  const int rows = min(p.P * p.RQ, kRows);
  const int c4 = p.Dh / 4;                       // 16-byte pieces per row
  for (int e = tid; e < rows * c4; e += kThreads) {
    const int r = e / c4, c = e - r * c4;
    const int hd = r / p.RQ, pos = q0 + r % p.RQ;
    if (pos >= p.Sq || tg * p.P + hd >= p.g) continue;
    const long long row =
        (static_cast<long long>(b) * p.Hq + h0 + hd) * p.Sq + pos;
    *reinterpret_cast<float4*>(out + row * p.Dh + 4 * c) =
        *reinterpret_cast<const float4*>(stage + r * ld + 4 * c);
  }
}

static_assert(64 * (256 + 8) * 4 <= 2 * Layout<256>::kQ,
              "the staged output fits Q's buffers");
static_assert(tf32x3_smem<256>() <= 232448, "one block at DP 256");
static_assert(2 * (tf32x3_smem<128>() + 1024) <= 233472,
              "two blocks an SM at DP 128");

constexpr int kMaxDevices = 64;

template <int DP>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, const tc::Params& p, dim3 grid,
           cudaStream_t st) {
  constexpr size_t smem = tf32x3_smem<DP>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[kMaxDevices] = {};   // once a device
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_x3_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  flash_x3_kernel<DP><<<grid, kThreads, smem, st>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const CUtensorMap& qm, const CUtensorMap& km,
             const CUtensorMap& vm, const tc::Params& p, int DP, dim3 grid,
             cudaStream_t st) {
  switch (DP) {
    case 64: return launch<64>(qm, km, vm, p, grid, st);
    case 128: return launch<128>(qm, km, vm, p, grid, st);
    case 192: return launch<192>(qm, km, vm, p, grid, st);
    case 256: return launch<256>(qm, km, vm, p, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace x3

namespace {

// The tensor maps of q, k and v for the TMA bodies: boxes of `inner`
// elements (128 bytes) by RQ positions by P heads for q, by tc::kKeys keys
// for k and v; strides in elements.
int qkv_maps(CUtensorMap* qm, CUtensorMap* km, CUtensorMap* vm,
             CUtensorMapDataType ty, uint64_t es, uint32_t inner,
             const void* q, const void* k, const void* v, int B, int Hq,
             int Hkv, int Sq, int Skv, int Dh, long long qsb, long long qsh,
             long long qss, long long ksb, long long ksh, long long kss,
             long long vsb, long long vsh, long long vss, int P, int RQ) {
  const uint64_t qd[4] = {uint64_t(Dh), uint64_t(Sq), uint64_t(Hq),
                          uint64_t(B)};
  const uint64_t qst[3] = {qss * es, qsh * es, qsb * es};
  const uint32_t qbox[4] = {inner, uint32_t(RQ), uint32_t(P), 1};
  // Skv = 0 still needs a valid map; no tile is ever loaded then
  const uint64_t kd[4] = {uint64_t(Dh), uint64_t(Skv > 0 ? Skv : 1),
                          uint64_t(Hkv), uint64_t(B)};
  const uint64_t kst[3] = {kss * es, ksh * es, ksb * es};
  const uint64_t vst[3] = {vss * es, vsh * es, vsb * es};
  const uint32_t kbox[4] = {inner, uint32_t(tc::kKeys), 1, 1};
  int rc = sm90_tensor_map_4d(qm, ty, q, qd, qst, qbox);
  if (rc == 0) rc = sm90_tensor_map_4d(km, ty, k, kd, kst, kbox);
  if (rc == 0) rc = sm90_tensor_map_4d(vm, ty, v, kd, vst, kbox);
  return rc;
}

}  // namespace

// The tensor-core body: q [B, Hq, Sq, Dh], k / v [B, Hkv, Skv, Dh] of bf16
// (dtype 1) or f16 (2), Dh % 16 == 0 and <= 256, strides in elements (the
// last dim dense; every other stride a multiple of 16 bytes, the pointers
// 16-byte aligned) -> o dense. The tiling comes from the wrapper's plan
// (kernels/flash_attention.py::plan_tc): DP, P heads of RQ positions per
// tile, and the grid (B * Hkv * ceil(g / P), ceil(Sq / RQ)).
RT_API int rt_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int Dh, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, float scale, int causal, int window,
    int has_softcap, float softcap, int q_offset, int DP, int P, int RQ,
    int grid_x, int grid_y, void* stream) {
  if (dtype != kBF16 && dtype != kF16) return cudaErrorInvalidValue;
  const int g = Hq / Hkv;
  tc::Params p{o, Hq, Hkv, g, Sq, Skv, Dh, P, RQ, (g + P - 1) / P, scale,
               causal, window, has_softcap, softcap, q_offset};
  const CUtensorMapDataType ty = dtype == kBF16
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  alignas(64) CUtensorMap qm, km, vm;
  const int rc = qkv_maps(&qm, &km, &vm, ty, 2, 64, q, k, v, B, Hq, Hkv, Sq,
                          Skv, Dh, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
                          vss, P, RQ);
  if (rc != 0) return rc;
  const dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return tc::dispatch<__nv_bfloat16>(qm, km, vm, p, DP, grid, st);
  return tc::dispatch<__half>(qm, km, vm, p, DP, grid, st);
}

// The 3xTF32 body: f32 q, k and v (dtype 0), Dh % 4 == 0 and <= 256, the
// strides and pointers as the tensor-core body takes them, the tiling from
// the same plan (kernels/flash_attention.py::plan_tc with the f32 dtype).
RT_API int rt_flash_attention_tf32x3(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int Dh, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, float scale, int causal, int window,
    int has_softcap, float softcap, int q_offset, int DP, int P, int RQ,
    int grid_x, int grid_y, void* stream) {
  if (dtype != kF32) return cudaErrorInvalidValue;
  const int g = Hq / Hkv;
  tc::Params p{o, Hq, Hkv, g, Sq, Skv, Dh, P, RQ, (g + P - 1) / P, scale,
               causal, window, has_softcap, softcap, q_offset};
  alignas(64) CUtensorMap qm, km, vm;
  const int rc = qkv_maps(&qm, &km, &vm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                          32, q, k, v, B, Hq, Hkv, Sq, Skv, Dh, qsb, qsh, qss,
                          ksb, ksh, kss, vsb, vsh, vss, P, RQ);
  if (rc != 0) return rc;
  return x3::dispatch(qm, km, vm, p, DP, dim3(grid_x, grid_y),
                      static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of one block of each body, exported for the
// wrapper's Python mirrors (kernels/flash_attention.py::cuda_cores_smem,
// tc_smem, tf32x3_smem): the CUDA-core body's at head dim Dh, the
// tensor-core and 3xTF32 bodies' at DP (Dh rounded up to 64; -1 for a DP
// they have no instantiation of).
RT_API long long rt_flash_smem(int Dh) {
  return static_cast<long long>(cuda_cores_smem(Dh));
}

RT_API long long rt_flash_tc_smem(int DP) {
  switch (DP) {
    case 64: return static_cast<long long>(tc::smem_bytes<64>());
    case 128: return static_cast<long long>(tc::smem_bytes<128>());
    case 192: return static_cast<long long>(tc::smem_bytes<192>());
    case 256: return static_cast<long long>(tc::smem_bytes<256>());
    default: return -1;
  }
}

RT_API long long rt_flash_tf32x3_smem(int DP) {
  switch (DP) {
    case 64: return static_cast<long long>(x3::tf32x3_smem<64>());
    case 128: return static_cast<long long>(x3::tf32x3_smem<128>());
    case 192: return static_cast<long long>(x3::tf32x3_smem<192>());
    case 256: return static_cast<long long>(x3::tf32x3_smem<256>());
    default: return -1;
  }
}
