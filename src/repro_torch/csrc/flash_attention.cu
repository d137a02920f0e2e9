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
// (495 TFLOP/s), the least full-precision f32 can take on this card. Two
// bodies, chosen by dtype alone, at every head dim from 1 to 256 (zero-
// filled to DP, Dh rounded up to 64):
//   * bf16 / f16: the tensor-core body (namespace tc): wgmma, P split into
//     hi and lo halves so that P.V keeps 16 bits of P. The split makes its
//     own floor 1.5x the function's: 0.104 ms at S = 4096.
//   * f32: the 3xTF32 body (namespace x3): the tensor-core body's tiling,
//     both products as three tf32 wgmmas on big / small halves of each
//     value.
// Two loaders fill either body's shared memory, a template parameter of
// each kernel, chosen by the inputs' pointers and strides alone
// (kernels/flash_attention.py::loader_of):
//   * TMA where q, k and v have 16-byte aligned pointers and every stride
//     a multiple of 16 bytes: one thread asks for each tile, completion on
//     mbarriers, columns past Dh and rows past Skv written as zeros by the
//     tensor map;
//   * cp.async otherwise (a row of Dh values that is no multiple of 16
//     bytes -- 16-bit Dh % 8 != 0, f32 Dh % 4 != 0 -- in the projections'
//     transposed layout, or a view off 16 bytes): every thread copies 16-,
//     8- or 4-byte pieces (2-byte loads where a 16-bit view allows no
//     wider) into exactly the bytes TMA's 128-byte swizzle writes, zeros
//     past Dh, Skv and Sq in the same instructions (tc::load_tile),
//     completion by cp.async.wait_group and a block barrier.
// Both skip whole key tiles above the causal diagonal or outside the
// window, and store the output in the widest pieces its rows allow.
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;         // the TPU kernel's mask value

enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Loader : int { kLoadTma = 0, kLoadCpAsync = 1 };

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

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core body: bf16 / f16 inputs, any head dim up to 256.
//
// One warpgroup (128 threads) per 64-row query tile. Rows are either 64
// positions of one head, or -- when Sq <= 32 -- the Sq positions of P
// query heads that share one kv head (P = min(g, 64 / Sq)), so that a GQA
// group reads its K/V tile once (the embed path: g = 2, S = 32, 64 rows).
// Q (once) and each 32-key K/V tile come into 128-byte-swizzled shared
// memory, Dh split into 64-column chunks and zero-filled to DP, by TMA or
// by the cp.async loader (load_tile); K/V go into a ring of two stages, so
// tile j+2's copy runs under tile j+1's products. A block needs 48 KB at
// Dh 128 (96 KB at 256), so four share an SM and one block's softmax runs
// under another's wgmmas. S = Q.K^T is a wgmma with f32 accumulation (the
// products of 16-bit values are exact), k16 steps past Dh skipped;
// the scale, softcap, masks and the online softmax (exp2 of
// log2(e)-scaled logits) work on the f32 fragment in registers, row
// statistics over the 4 threads of a quad; a masked logit is -inf, so a
// zero-filled key past Skv gets p = 0, never just a zero score. P is split
// into P_hi = T(p) and P_lo = T(p - P_hi), and both go into the P.V wgmma
// from registers (V's tile as loaded, MN-major): 16 bits of p (22 for
// f16) where one rounding would keep 8, at 1.5x the tensor-core work. The
// output, acc / max(l, 1e-30) in T, is staged in shared memory and written
// in 16-byte stores where a row of Dh values is a multiple of 16 bytes,
// else in the widest pieces it is a multiple of (store_rows).

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

// The cp.async loader's inputs, a kernel parameter of their own (the TMA
// loader reads q, k and v through its tensor maps and never touches
// them): pointers, byte strides of batch, head and position, and each
// tensor's copy width in bytes (16, 8, 4 or 2), which divides its pointer
// and every stride it steps.
struct Src {
  const uint8_t* q;
  const uint8_t* k;
  const uint8_t* v;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  int uq, uk, uv;
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

// ---- the cp.async loader ---------------------------------------------------

// U bytes from src to dst, the first n of them read and the rest written as
// zeros: cp.async (16 bytes through L2, 4 and 8 through L1), or at U = 2 a
// plain load and store, which cp.async has no size for
template <int U>
__device__ __forceinline__ void copy_piece(uint8_t* dst, const uint8_t* src,
                                           int n) {
  if constexpr (U == 16) {
    sm90::cp_async16(dst, src, n);
  } else if constexpr (U == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        n ? __ldg(reinterpret_cast<const unsigned short*>(src))
          : static_cast<unsigned short>(0);
  } else {
    sm90::cp_async_ca<U>(dst, src, n);
  }
}

// `rows` rows of a tile into `dst` byte for byte as TMA's 128-byte swizzle
// writes them: NC chunks of 128-byte rows (chunk c at c * rows * 128, its
// 16-byte unit u of row r at swz128(r, u)), row r's bytes [0, row_bytes)
// from row_of(r) and zeros past them up to NC * 128 bytes; a row
// row_of gives as nullptr (a key past Skv, a query past Sq) all zeros.
// Consecutive threads take consecutive U-byte pieces of a row. `any`: a
// U-aligned global address for a piece that reads nothing.
template <int NC, int U, typename RowOf>
__device__ __forceinline__ void load_rows(uint8_t* dst, int rows,
                                          int row_bytes, const uint8_t* any,
                                          RowOf row_of) {
  constexpr int kPieces = NC * 128 / U;          // pieces of a row
  for (int e = threadIdx.x; e < rows * kPieces; e += kThreads) {
    const int r = e / kPieces, ob = (e - r * kPieces) * U;
    const uint8_t* src = row_of(r);
    const int n = src == nullptr ? 0 : min(max(row_bytes - ob, 0), U);
    copy_piece<U>(dst + (ob >> 7) * rows * 128 +
                      sm90::swz128(r, (ob >> 4) & 7) + (ob & 15),
                  n ? src + ob : any, n);
  }
}

// load_rows at the copy width u of the tensor the rows come from
template <int NC, typename RowOf>
__device__ __forceinline__ void load_tile(uint8_t* dst, int rows,
                                          int row_bytes, int u,
                                          const uint8_t* any, RowOf row_of) {
  switch (u) {
    case 16: load_rows<NC, 16>(dst, rows, row_bytes, any, row_of); break;
    case 8: load_rows<NC, 8>(dst, rows, row_bytes, any, row_of); break;
    case 4: load_rows<NC, 4>(dst, rows, row_bytes, any, row_of); break;
    default: load_rows<NC, 2>(dst, rows, row_bytes, any, row_of); break;
  }
}

// A tile of kKeys keys from kt of K's or V's rows (`base`: this batch
// and kv head, `ss` bytes a key), keys past Skv zero
template <int NC>
__device__ __forceinline__ void load_keys(uint8_t* dst, const uint8_t* base,
                                          long long ss, int u, int kt,
                                          int Skv, int row_bytes) {
  load_tile<NC>(dst, kKeys, row_bytes, u, base,
                [=](int r) -> const uint8_t* {
                  return kt + r < Skv ? base + (kt + r) * ss : nullptr;
                });
}

// The 64-row query tile: row r is head h0 + r / RQ (of the tile's P, and
// of the `heads` the GQA group has from h0 on), position q0 + r % RQ;
// `base` is this batch's q, heads sh and positions ss bytes apart. Rows
// past P * RQ, positions past Sq and heads past the group are zero.
template <int NC>
__device__ __forceinline__ void load_queries(uint8_t* dst, const uint8_t* base,
                                             long long sh, long long ss,
                                             int u, int h0, int q0, int P,
                                             int RQ, int Sq, int heads,
                                             int row_bytes) {
  load_tile<NC>(dst, kRows, row_bytes, u, base,
                [=](int r) -> const uint8_t* {
                  const int hd = r / RQ, pos = q0 + r - hd * RQ;
                  if (hd >= P || pos >= Sq || hd >= heads) return nullptr;
                  return base + (h0 + hd) * sh + pos * ss;
                });
}

// ---- the epilogue's stores -------------------------------------------------

template <int U>
struct Piece;
template <> struct Piece<16> { using type = uint4; };
template <> struct Piece<8> { using type = uint2; };
template <> struct Piece<4> { using type = uint32_t; };
template <> struct Piece<2> { using type = uint16_t; };

// The staged rows of one query tile (row r at stage + r * ld bytes, ld a
// multiple of 16) to out [B * Hq * Sq rows of row_bytes], in U-byte
// stores: tile row r is head h0 + r / RQ, position q0 + r % RQ, and is
// written where the position is below Sq and the head one of the `heads`
// the GQA group has from h0 on.
template <int U>
__device__ __forceinline__ void store_rows_u(uint8_t* out,
                                             const uint8_t* stage, int ld,
                                             int rows, int row_bytes,
                                             long long row0, int RQ, int q0,
                                             int Sq, int heads) {
  using V = typename Piece<U>::type;
  const int per = row_bytes / U;
  for (int e = threadIdx.x; e < rows * per; e += kThreads) {
    const int r = e / per, c = e - r * per;
    const int hd = r / RQ, pos = q0 + r % RQ;
    if (pos >= Sq || hd >= heads) continue;
    const long long row = row0 + static_cast<long long>(hd) * Sq + pos;
    *reinterpret_cast<V*>(out + row * row_bytes + c * U) =
        *reinterpret_cast<const V*>(stage + r * ld + c * U);
  }
}

// store_rows_u at the widest U that row_bytes is a multiple of: out is
// dense and 16-byte aligned, so every row starts on such a multiple.
// row0: the row of out of head h0, position 0.
__device__ __forceinline__ void store_rows(uint8_t* out, const uint8_t* stage,
                                           int ld, int rows, int row_bytes,
                                           long long row0, int RQ, int q0,
                                           int Sq, int heads) {
  if (row_bytes % 16 == 0)
    store_rows_u<16>(out, stage, ld, rows, row_bytes, row0, RQ, q0, Sq,
                     heads);
  else if (row_bytes % 8 == 0)
    store_rows_u<8>(out, stage, ld, rows, row_bytes, row0, RQ, q0, Sq,
                    heads);
  else if (row_bytes % 4 == 0)
    store_rows_u<4>(out, stage, ld, rows, row_bytes, row0, RQ, q0, Sq,
                    heads);
  else
    store_rows_u<2>(out, stage, ld, rows, row_bytes, row0, RQ, q0, Sq,
                    heads);
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

// DP: Dh rounded up to a multiple of 64; kTma: the loader (TMA, or
// cp.async)
template <typename T, int DP, bool kTma>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Params p,
                const Src src) {
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

  // the cp.async loader: K and V's rows of this (batch, kv head); every
  // thread issues its pieces of a tile, and each stage's copies are one
  // commit group
  const int row_bytes = p.Dh * static_cast<int>(sizeof(T));
  const uint8_t* kg = src.k + b * src.ksb + kvh * src.ksh;
  const uint8_t* vg = src.v + b * src.vsb + kvh * src.vsh;

  if constexpr (kTma) {
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
        sm90::tma_load_4d(qs + c * kRows * 128, &qmap, bar_q, 64 * c, q0,
                          h0, b);
      for (int s = 0; s < 2 && s < ntiles; ++s) {
        uint8_t* ks = kv + 2 * s * kKVBytes;
        sm90::mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        for (int c = 0; c < NC; ++c) {
          sm90::tma_load_4d(ks + c * kKeys * 128, &kmap, &full[s], 64 * c,
                            kt0 + s * kKeys, kvh, b);
          sm90::tma_load_4d(ks + kKVBytes + c * kKeys * 128, &vmap,
                            &full[s], 64 * c, kt0 + s * kKeys, kvh, b);
        }
      }
    }
  } else {
    // groups: Q with tile 0, then tile 1 (empty where there is none)
    load_queries<NC>(qs, src.q + b * src.qsb, src.qsh, src.qss, src.uq, h0,
                     q0, p.P, p.RQ, p.Sq, p.g - tg * p.P, row_bytes);
    for (int s = 0; s < 2; ++s) {
      if (s < ntiles) {
        uint8_t* ks = kv + 2 * s * kKVBytes;
        load_keys<NC>(ks, kg, src.kss, src.uk, kt0 + s * kKeys, p.Skv,
                      row_bytes);
        load_keys<NC>(ks + kKVBytes, vg, src.vss, src.uv, kt0 + s * kKeys,
                      p.Skv, row_bytes);
      }
      sm90::cp_async_commit();
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

  if constexpr (kTma) sm90::mbar_wait(bar_q, 0);
  const uint32_t qaddr = sm90::smem_u32(qs);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j & 1;
    const int kt = kt0 + j * kKeys;
    if constexpr (kTma) {
      sm90::mbar_wait(&full[s], (j >> 1) & 1);
    } else {
      // tile j (and at j = 0 Q) has landed; tile j + 1 may be in flight.
      // cp.async writes through the generic proxy, wgmma reads through
      // the async one: each thread fences its own copies, then the block
      // meets
      sm90::cp_async_wait<1>();
      sm90::fence_proxy_async();
      __syncthreads();
    }
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
    if constexpr (kTma) {
      if (tid == 0 && j + 2 < ntiles) {
        uint8_t* ks = kv + 2 * s * kKVBytes;
        sm90::mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        for (int c = 0; c < NC; ++c) {
          sm90::tma_load_4d(ks + c * kKeys * 128, &kmap, &full[s], 64 * c,
                            kt + 2 * kKeys, kvh, b);
          sm90::tma_load_4d(ks + kKVBytes + c * kKeys * 128, &vmap,
                            &full[s], 64 * c, kt + 2 * kKeys, kvh, b);
        }
      }
    } else {
      if (j + 2 < ntiles) {
        uint8_t* ks = kv + 2 * s * kKVBytes;
        load_keys<NC>(ks, kg, src.kss, src.uk, kt + 2 * kKeys, p.Skv,
                      row_bytes);
        load_keys<NC>(ks + kKVBytes, vg, src.vss, src.uv, kt + 2 * kKeys,
                      p.Skv, row_bytes);
      }
      sm90::cp_async_commit();
    }
  }

  // out = acc / max(l, 1e-30) in T, staged row-major in shared memory
  // (the Q and K/V buffers are free: every copy was consumed; with no key
  // tile, cp.async copies of Q may still be landing)
  if constexpr (!kTma) sm90::cp_async_wait<0>();
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
  store_rows(static_cast<uint8_t*>(p.o), smem,
             ld * static_cast<int>(sizeof(T)), min(p.P * p.RQ, kRows),
             row_bytes, (static_cast<long long>(b) * p.Hq + h0) * p.Sq, p.RQ,
             q0, p.Sq, p.g - tg * p.P);
}

// shared memory of one block: 1 KB for alignment, Q, two K/V stages and
// three barriers (kernels/flash_attention.py::plan_tc computes the same)
template <int DP>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(DP / 64) * 128 * (64 + 4 * kKeys) + 64;
}

constexpr int kMaxDevices = 64;

template <typename T, int DP, bool kTma>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, const Params& p, const Src& src,
           dim3 grid, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[kMaxDevices] = {};   // once a device
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_tc_kernel<T, DP, kTma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  flash_tc_kernel<T, DP, kTma><<<grid, kThreads, smem, st>>>(qm, km, vm, p,
                                                             src);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_by(const CUtensorMap& qm, const CUtensorMap& km,
              const CUtensorMap& vm, const Params& p, const Src& src,
              dim3 grid, bool tma, cudaStream_t st) {
  return tma ? launch<T, DP, true>(qm, km, vm, p, src, grid, st)
             : launch<T, DP, false>(qm, km, vm, p, src, grid, st);
}

template <typename T>
int dispatch(const CUtensorMap& qm, const CUtensorMap& km,
             const CUtensorMap& vm, const Params& p, const Src& src, int DP,
             dim3 grid, bool tma, cudaStream_t st) {
  switch (DP) {
    case 64: return launch_by<T, 64>(qm, km, vm, p, src, grid, tma, st);
    case 128: return launch_by<T, 128>(qm, km, vm, p, src, grid, tma, st);
    case 192: return launch_by<T, 192>(qm, km, vm, p, src, grid, tma, st);
    case 256: return launch_by<T, 256>(qm, km, vm, p, src, grid, tma, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The 3xTF32 body: f32 inputs, any head dim up to 256.
//
// The tensor-core body's structure at f32: one warpgroup per 64-row query
// tile, GQA heads packed into the tile at Sq <= 32 (the same plan, so a
// group reads each K/V tile once), Q loaded once and each 32-key K/V tile
// brought by TMA or by the cp.async loader (tc::load_tile), Dh split into
// 32-column chunks of 128-byte rows in the 128-byte swizzle and
// zero-filled to DP, tiles above the diagonal or outside the window
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
// by 8 floats) and written as the tensor-core body writes its own
// (tc::store_rows).

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

template <int DP, bool kTma>
__global__ void __launch_bounds__(kThreads)
flash_x3_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const tc::Params p, const tc::Src src) {
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

  // the cp.async loader: a tile of K's or V's keys from kt; each tile's
  // copies are one commit group, in the order Q, K 0, V 0, then K j + 1
  // and V j + 1 as iteration j frees their buffers, so the wait for the
  // one before the newest (wait_group 1) is the wait for the tile needed
  const int row_bytes = p.Dh * 4;
  const uint8_t* kg = src.k + b * src.ksb + kvh * src.ksh;
  const uint8_t* vg = src.v + b * src.vsb + kvh * src.vsh;

  if constexpr (kTma) {
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
        sm90::tma_load_4d(qb + c * kRows * 128, &qmap, bar_q, 32 * c, q0,
                          h0, b);
      if (ntiles > 0) {
        sm90::mbar_arrive_expect_tx(bar_k, kTileTx);
        sm90::mbar_arrive_expect_tx(bar_v, kTileTx);
        for (int c = 0; c < NC; ++c) {
          sm90::tma_load_4d(kt_s + c * kKeys * 128, &kmap, bar_k, 32 * c,
                            kt0, kvh, b);
          sm90::tma_load_4d(vt_s + c * kKeys * 128, &vmap, bar_v, 32 * c,
                            kt0, kvh, b);
        }
      }
    }
  } else {
    tc::load_queries<NC>(qb, src.q + b * src.qsb, src.qsh, src.qss, src.uq,
                         h0, q0, p.P, p.RQ, p.Sq, p.g - tg * p.P,
                         row_bytes);
    sm90::cp_async_commit();
    if (ntiles > 0)
      tc::load_keys<NC>(kt_s, kg, src.kss, src.uk, kt0, p.Skv, row_bytes);
    sm90::cp_async_commit();
    if (ntiles > 0)
      tc::load_keys<NC>(vt_s, vg, src.vss, src.uv, kt0, p.Skv, row_bytes);
    sm90::cp_async_commit();
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

  // Q's pre-scale and split only once Q has landed
  if constexpr (kTma) {
    sm90::mbar_wait(bar_q, 0);
  } else {
    sm90::cp_async_wait<2>();
    __syncthreads();
  }
  split_tile<DP>(qb, qsm, kRows, min(p.P * p.RQ, kRows), p.scale);
  const uint32_t qa = sm90::smem_u32(qb), qsa = sm90::smem_u32(qsm);
  const uint32_t ka = sm90::smem_u32(kt_s), va = sm90::smem_u32(vt_s);
  const uint32_t xa = sm90::smem_u32(xs);

  for (int j = 0; j < ntiles; ++j) {
    const int kt = kt0 + j * kKeys;
    // (cp.async: K's tile, V's may be in flight; the split reads it
    // through the generic proxy and writes what wgmma reads, then fences)
    if constexpr (kTma) {
      sm90::mbar_wait(bar_k, j & 1);
    } else {
      sm90::cp_async_wait<1>();
      __syncthreads();
    }
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
    if constexpr (kTma) {
      if (tid == 0 && j + 1 < ntiles) {
        sm90::mbar_arrive_expect_tx(bar_k, kTileTx);
        for (int c = 0; c < NC; ++c)
          sm90::tma_load_4d(kt_s + c * kKeys * 128, &kmap, bar_k, 32 * c,
                            kt + kKeys, kvh, b);
      }
    } else {
      if (j + 1 < ntiles)
        tc::load_keys<NC>(kt_s, kg, src.kss, src.uk, kt + kKeys, p.Skv,
                          row_bytes);
      sm90::cp_async_commit();
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
    if constexpr (kTma) {
      sm90::mbar_wait(bar_v, j & 1);
    } else {
      sm90::cp_async_wait<1>();      // V's tile; K's next may be in flight
      __syncthreads();
    }
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
    if constexpr (kTma) {
      if (tid == 0 && j + 1 < ntiles) {
        sm90::mbar_arrive_expect_tx(bar_v, kTileTx);
        for (int c = 0; c < NC; ++c)
          sm90::tma_load_4d(vt_s + c * kKeys * 128, &vmap, bar_v, 32 * c,
                            kt + kKeys, kvh, b);
      }
    } else {
      if (j + 1 < ntiles)
        tc::load_keys<NC>(vt_s, vg, src.vss, src.uv, kt + kKeys, p.Skv,
                          row_bytes);
      sm90::cp_async_commit();
    }
  }

  // out = acc / max(l, 1e-30), staged row-major in shared memory (Q's
  // buffers are free: the last S product has read them; with no key
  // tile, empty groups are all that may be pending)
  if constexpr (!kTma) sm90::cp_async_wait<0>();
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
  tc::store_rows(static_cast<uint8_t*>(p.o), smem, ld * 4,
                 min(p.P * p.RQ, kRows), row_bytes,
                 (static_cast<long long>(b) * p.Hq + h0) * p.Sq, p.RQ, q0,
                 p.Sq, p.g - tg * p.P);
}

static_assert(64 * (256 + 8) * 4 <= 2 * Layout<256>::kQ,
              "the staged output fits Q's buffers");
static_assert(tf32x3_smem<256>() <= 232448, "one block at DP 256");
static_assert(2 * (tf32x3_smem<128>() + 1024) <= 233472,
              "two blocks an SM at DP 128");

constexpr int kMaxDevices = 64;

template <int DP, bool kTma>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, const tc::Params& p, const tc::Src& src,
           dim3 grid, cudaStream_t st) {
  constexpr size_t smem = tf32x3_smem<DP>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[kMaxDevices] = {};   // once a device
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_x3_kernel<DP, kTma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  flash_x3_kernel<DP, kTma><<<grid, kThreads, smem, st>>>(qm, km, vm, p,
                                                          src);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_by(const CUtensorMap& qm, const CUtensorMap& km,
              const CUtensorMap& vm, const tc::Params& p, const tc::Src& src,
              dim3 grid, bool tma, cudaStream_t st) {
  return tma ? launch<DP, true>(qm, km, vm, p, src, grid, st)
             : launch<DP, false>(qm, km, vm, p, src, grid, st);
}

int dispatch(const CUtensorMap& qm, const CUtensorMap& km,
             const CUtensorMap& vm, const tc::Params& p, const tc::Src& src,
             int DP, dim3 grid, bool tma, cudaStream_t st) {
  switch (DP) {
    case 64: return launch_by<64>(qm, km, vm, p, src, grid, tma, st);
    case 128: return launch_by<128>(qm, km, vm, p, src, grid, tma, st);
    case 192: return launch_by<192>(qm, km, vm, p, src, grid, tma, st);
    case 256: return launch_by<256>(qm, km, vm, p, src, grid, tma, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace x3

namespace {

// The tensor maps of q, k and v for the TMA loader: boxes of `inner`
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

// Both bodies' entries take q [B, Hq, Sq, Dh], k / v [B, Hkv, Skv, Dh] of
// one dtype, Dh <= 256, strides in elements (the last dim dense) -> o
// dense, 16-byte aligned. The tiling comes from the wrapper's plan
// (kernels/flash_attention.py::plan_tc): DP, P heads of RQ positions per
// tile, and the grid (B * Hkv * ceil(g / P), ceil(Sq / RQ)). The loader
// from loader_of: kLoadTma where every pointer is 16-byte aligned and
// every stride a multiple of 16 bytes; kLoadCpAsync otherwise, with each
// tensor's copy width uq, uk, uv (copy_bytes: 16, 8, 4 or 2 bytes,
// dividing its pointer and every stride of a dim longer than 1).
int run(int body, const void* q, const void* k, const void* v, void* o,
        int B, int Hq, int Hkv, int Sq, int Skv, int Dh, long long qsb,
        long long qsh, long long qss, long long ksb, long long ksh,
        long long kss, long long vsb, long long vsh, long long vss,
        float scale, int causal, int window, int has_softcap, float softcap,
        int q_offset, int DP, int P, int RQ, int grid_x, int grid_y,
        int loader, int uq, int uk, int uv, void* stream) {
  if (loader != kLoadTma && loader != kLoadCpAsync)
    return cudaErrorInvalidValue;
  const int es = body == kF32 ? 4 : 2;
  const int g = Hq / Hkv;
  const tc::Params p{o, Hq, Hkv, g, Sq, Skv, Dh, P, RQ, (g + P - 1) / P,
                     scale, causal, window, has_softcap, softcap, q_offset};
  const tc::Src src{static_cast<const uint8_t*>(q),
                    static_cast<const uint8_t*>(k),
                    static_cast<const uint8_t*>(v),
                    qsb * es, qsh * es, qss * es, ksb * es, ksh * es,
                    kss * es, vsb * es, vsh * es, vss * es, uq, uk, uv};
  alignas(64) CUtensorMap qm, km, vm;
  const bool tma = loader == kLoadTma;
  if (tma) {
    const CUtensorMapDataType ty =
        body == kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
        : body == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    const int rc = qkv_maps(&qm, &km, &vm, ty, es, 128 / es, q, k, v, B, Hq,
                            Hkv, Sq, Skv, Dh, qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, P, RQ);
    if (rc != 0) return rc;
  } else {
    memset(&qm, 0, sizeof(qm));   // passed, never read
    km = vm = qm;
  }
  const dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == kF32)
    return x3::dispatch(qm, km, vm, p, src, DP, grid, tma, st);
  if (body == kBF16)
    return tc::dispatch<__nv_bfloat16>(qm, km, vm, p, src, DP, grid, tma,
                                       st);
  return tc::dispatch<__half>(qm, km, vm, p, src, DP, grid, tma, st);
}

}  // namespace

// The tensor-core body: bf16 (dtype 1) or f16 (2) q, k and v, as run()
// takes them.
RT_API int rt_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int Dh, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, float scale, int causal, int window,
    int has_softcap, float softcap, int q_offset, int DP, int P, int RQ,
    int grid_x, int grid_y, int loader, int uq, int uk, int uv,
    void* stream) {
  if (dtype != kBF16 && dtype != kF16) return cudaErrorInvalidValue;
  return run(dtype, q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, qsb, qsh, qss, ksb,
             ksh, kss, vsb, vsh, vss, scale, causal, window, has_softcap,
             softcap, q_offset, DP, P, RQ, grid_x, grid_y, loader, uq, uk,
             uv, stream);
}

// The 3xTF32 body: f32 q, k and v (dtype 0), as run() takes them.
RT_API int rt_flash_attention_tf32x3(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int Dh, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, float scale, int causal, int window,
    int has_softcap, float softcap, int q_offset, int DP, int P, int RQ,
    int grid_x, int grid_y, int loader, int uq, int uk, int uv,
    void* stream) {
  if (dtype != kF32) return cudaErrorInvalidValue;
  return run(dtype, q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, qsb, qsh, qss, ksb,
             ksh, kss, vsb, vsh, vss, scale, causal, window, has_softcap,
             softcap, q_offset, DP, P, RQ, grid_x, grid_y, loader, uq, uk,
             uv, stream);
}

// The dynamic shared memory of one block of each body at DP (Dh rounded up
// to 64; -1 for a DP it has no instantiation of), either loader, exported
// for the wrapper's Python mirrors (kernels/flash_attention.py::tc_smem,
// tf32x3_smem).
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
