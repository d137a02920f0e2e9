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
// 128, causal. Two bodies, chosen by dtype and head dim alone:
//   * bf16 / f16 with Dh % 16 == 0 (every config's head dim): the
//     tensor-core body below (namespace tc): wgmma fed by a TMA ring, P
//     split into hi and lo halves so that P.V keeps 16 bits of P. The
//     split makes its own floor 1.5x the function's: 0.104 ms at S = 4096.
//   * f32, and 16-bit inputs with another head dim: the CUDA-core body,
//     f32 FMAs: one block of 4 warps per (b*Hq + h, 32-row query tile);
//     the query tile (pre-scaled) and each 32-key K/V tile staged in
//     shared memory as f32, rows padded by 4 floats; each warp owns 8
//     query rows, lane j scores key j, row statistics reduce over the warp
//     by shuffles, each lane accumulates P.V into the 4 (Dh <= 128) or 8
//     (Dh <= 256) output columns it owns. Shared memory 96 * (Dh + 4) * 4
//     bytes.
// Both skip whole key tiles above the causal diagonal or outside the
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

  // the key range any row of this tile can see
  const int qlo = q0 + p.q_offset;
  const int qhi = min(q0 + p.RQ, p.Sq) - 1 + p.q_offset;
  int k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, max(qhi + 1, 0));
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, qlo - p.window + 1);
  const int kt0 = (k_lo / kKeys) * kKeys;
  const int ntiles = k_hi > kt0 ? (k_hi - kt0 + kKeys - 1) / kKeys : 0;

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
  const float sl2 = p.scale * kLog2e;

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

    // masks are needed only on a tile that crosses Skv, the diagonal or
    // the window's edge
    const bool need_mask =
        kt + kKeys > p.Skv || (p.causal && kt + kKeys - 1 > qlo) ||
        (p.window > 0 && kt <= qhi - p.window);

    // online softmax on the fragment: logits in log2 units
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sacc[4 * jj + 2 * i + c];
          if (p.has_softcap) {
            x *= p.scale;
            x = p.softcap * tanhf(x / p.softcap) * kLog2e;
          } else {
            x *= sl2;
          }
          if (need_mask) {
            const int kpos = kt + 8 * jj + 2 * quad + c;
            bool ok = kpos < p.Skv;
            if (p.causal) ok = ok && kpos <= qpos[i];
            if (p.window > 0) ok = ok && kpos > qpos[i] - p.window;
            x = ok ? x : -INFINITY;
          }
          sacc[4 * jj + 2 * i + c] = x;
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
          const float pv = exp2f(sacc[4 * jj + 2 * i + c] - m_new);
          sacc[4 * jj + 2 * i + c] = pv;
          sum += pv;
        }
      }
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
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
  const uint64_t es = 2;
  alignas(64) CUtensorMap qm, km, vm;
  const uint64_t qd[4] = {uint64_t(Dh), uint64_t(Sq), uint64_t(Hq),
                          uint64_t(B)};
  const uint64_t qst[3] = {qss * es, qsh * es, qsb * es};
  const uint32_t qbox[4] = {64, uint32_t(RQ), uint32_t(P), 1};
  // Skv = 0 still needs a valid map; no tile is ever loaded then
  const uint64_t kd[4] = {uint64_t(Dh), uint64_t(Skv > 0 ? Skv : 1),
                          uint64_t(Hkv), uint64_t(B)};
  const uint64_t kst[3] = {kss * es, ksh * es, ksb * es};
  const uint64_t vst[3] = {vss * es, vsh * es, vsb * es};
  const uint32_t kbox[4] = {64, uint32_t(tc::kKeys), 1, 1};
  int rc = sm90_tensor_map_4d(&qm, ty, q, qd, qst, qbox);
  if (rc == 0) rc = sm90_tensor_map_4d(&km, ty, k, kd, kst, kbox);
  if (rc == 0) rc = sm90_tensor_map_4d(&vm, ty, v, kd, vst, kbox);
  if (rc != 0) return rc;
  const dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return tc::dispatch<__nv_bfloat16>(qm, km, vm, p, DP, grid, st);
  return tc::dispatch<__half>(qm, km, vm, p, DP, grid, st);
}

// The dynamic shared memory of one block of each body, exported for the
// wrapper's Python mirrors (kernels/flash_attention.py::cuda_cores_smem,
// plan_tc): the CUDA-core body's at head dim Dh, the tensor-core body's
// at DP (Dh rounded up to 64; -1 for a DP it has no instantiation of).
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
