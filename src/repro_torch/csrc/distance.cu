// All-pairs distance, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/distance.py::_dist_kernel (line
// 26; pallas_call at line 79). Semantics: the port's kernels/ref.py::
// pairwise_dist: q[Bq, D] x x[N, D] -> f32[Bq, N], l2 ``‖q‖² − 2q·x +
// ‖x‖²`` or ip ``−q·x``, with f32, bf16 or f16 inputs. One kernel template
// on the tensor cores, two bodies by input type:
//
// f32 inputs, "tf32x3". Bound on the H100: 3 * 2*Bq*N*D flops at the TF32
// peak (495 TFLOP/s) or the bytes (inputs read once, 4*Bq*N written), the
// larger: 1.552 ms at 1,000 x 1M, d = 128 (operations), 0.0229 ms at the
// roofline's 64 x 100,000 (bytes).
// bf16 / f16 inputs, "wgmma". Bound: 2*Bq*N*D at the 16-bit tensor peak
// (989 TFLOP/s) or the bytes, the larger: 1.270 ms at 1,000 x 1M, d = 128,
// set by the 4 GB f32 output, so the epilogue's store rate decides the
// time.
//
// Design: one warpgroup (128 threads) per block, as many blocks as the
// card holds at once, persistent: block b walks output tiles b, b + grid,
// ... of 64 x 128 (queries x rows of x). Tile t is query tile t % nqt of x
// block t / nqt, so the query tiles of one x block (16 at Bq = 1,000) run
// on neighbouring blocks at once: x comes from device memory once and from
// L2 for the others. D is walked in chunks of 128 bytes a row (32 f32 or
// 64 16-bit values), the chunks of all of a block's tiles as one stream:
// 16-byte cp.async copies (zero-filled outside Bq, N and D) keep the next
// chunk in flight in a two-stage ring in the 128-byte swizzle; where D or
// a pointer does not allow 16-byte copies (e.g. d = 131), element loads
// fill the stage instead. Each chunk has one pass over its values by all
// threads, which sums their squares in f32 into the row norms (the half
// types' products are exact in f32; their pass runs for l2 only) and,
// for f32, splits each value a into big = cvt.rna.tf32(a), written over
// a, and small = a - big (exact in f32), in a buffer laid out alike.
// Then the wgmmas with f32 accumulation: f32 runs three tf32 products
// (m64n128k8) big.big + big.small + small.big -- the dropped small.small
// and the hardware's truncation of small to tf32 leave about 2^-21 of
// |a_i b_i| a product, far inside 1e-5 of ‖q‖² + ‖x‖²; bf16 / f16 run one
// m64n128k16 product, exact products summed in f32, held to the
// half-type gate against the exact dot (kernels/distance.py::half_gate).
// One block's pass runs under the others' wgmmas. After a tile's last
// chunk the epilogue passes the accumulator through the ring stage the
// wgmmas just read, so that each warp writes (qq - 2 dot) + xx (or -dot)
// as whole 512-byte row segments with 16-byte streaming stores (the
// accumulator's own layout gives a quad of threads 32 contiguous bytes of
// a row, 8 rows a store), while the next tile's first chunk is already
// copying.
//
// Nothing is padded or copied outside the kernel.
#include "common.cuh"
#include "hopper.cuh"

#include <algorithm>
#include <cstring>
#include <type_traits>

namespace tc {

constexpr int kBM = 64;        // queries per tile: the wgmma's M
constexpr int kBN = 128;       // rows of x per tile: its N
constexpr int kThreads = 128;
// one ring stage: q then x, 128-byte rows (f32: the split's big parts
// replace the values in place); two stages, then (f32) the small parts,
// laid out alike
constexpr int kQBytes = kBM * 128, kXBytes = kBN * 128;
constexpr int kStage = kQBytes + kXBytes;

template <typename T>
constexpr bool kSplit = std::is_same<T, float>::value;  // 3xTF32
template <typename T>
constexpr int kNorms = (kSplit<T> ? 3 : 2) * kStage;
template <typename T>
constexpr size_t kSmem = 1024 + kNorms<T> + (kBM + kBN) * sizeof(float);
// the epilogue: each warp's 8 x 128 half of its accumulator rows, rows
// padded to 136 floats (conflict-free float2 writes and float4 reads), in
// the current ring stage
constexpr int kOutPad = kBN + 8;
static_assert(4 * 8 * kOutPad * 4 <= kStage, "staged epilogue fits a stage");

// piece c (16 bytes: 16 / sizeof(T) values from k) of source row `grow`
// into row `row` of a ring stage's tile, zeros outside [0, nrows) x [0,
// D): a cp.async (VEC: 16-byte rows and pointers) or element loads
template <typename T, bool VEC>
__device__ __forceinline__ void copy_piece(uint8_t* tile, const T* src,
                                           int row, int grow, int nrows,
                                           int c, int k, int D) {
  constexpr int P = 16 / sizeof(T);
  using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
  uint8_t* dst = tile + sm90::swz128(row, c);
  const bool in = grow < nrows && k < D;
  const T* p = src + static_cast<size_t>(in ? grow : 0) * D;
  if constexpr (VEC) {
    sm90::cp_async16(dst, in ? p + k : src, in ? 16 : 0);
  } else {
    const Raw* pr = reinterpret_cast<const Raw*>(p);
    Raw e[P];
#pragma unroll
    for (int i = 0; i < P; ++i) e[i] = in && k + i < D ? pr[k + i] : Raw(0);
    uint4 v;
    memcpy(&v, e, sizeof(v));
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

// a piece's tf32 split: big at `big + off` (over the values), small at
// `small + off`; returns its sum of squares
__device__ __forceinline__ float split_piece(uint8_t* big, uint8_t* small,
                                             uint32_t off, float4 v) {
  const float a[4] = {v.x, v.y, v.z, v.w};
  uint32_t bw[4], rw[4];
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sq = fmaf(a[i], a[i], sq);
    bw[i] = sm90::tf32_rna(a[i]);
    rw[i] = __float_as_uint(a[i] - __uint_as_float(bw[i]));
  }
  *reinterpret_cast<uint4*>(big + off) = make_uint4(bw[0], bw[1], bw[2],
                                                    bw[3]);
  *reinterpret_cast<uint4*>(small + off) = make_uint4(rw[0], rw[1], rw[2],
                                                      rw[3]);
  return sq;
}

// a 16-bit piece's sum of squares (8 values, f32 FMAs in k order)
template <typename T>
__device__ __forceinline__ float sq_piece(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f;
    if constexpr (std::is_same<T, __half>::value)
      f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    else
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    sq = fmaf(f.x, f.x, sq);
    sq = fmaf(f.y, f.y, sq);
  }
  return sq;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dist_kernel(const T* __restrict__ q, const T* __restrict__ x,
            float* __restrict__ out, int Bq, int N, int D, int metric,
            int nqt, int ntiles, bool out_vec) {
  constexpr int kChunk = 128 / sizeof(T);   // values per 128-byte row
  constexpr int P = 16 / sizeof(T);         // values per 16-byte piece
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  uint8_t* sm = smem + 2 * kStage;                   // f32: the small parts
  float* qn = reinterpret_cast<float*>(smem + kNorms<T>);
  float* xn = qn + kBM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool l2 = metric == rt::kMetricL2;
  // copies and the per-chunk pass: piece c of rows rb + 16 i
  const int c = tid & 7, rb = tid >> 3;
  constexpr int kQI = kBM / 16, kXI = kBN / 16;
  const int nk = (D + kChunk - 1) / kChunk;
  const int my_tiles =
      (ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * nk;    // chunks this block walks

  auto tile_of = [&](int g, int& r0, int& c0) {
    const int t = blockIdx.x + (g / nk) * gridDim.x;
    r0 = (t % nqt) * kBM;
    c0 = (t / nqt) * kBN;
  };
  // chunk g of the stream into ring stage g % 2, one commit group a call
  // (empty past the end) so that wait_group counts chunks
  auto fetch = [&](int g) {
    if (g < total) {
      int r0, c0;
      tile_of(g, r0, c0);
      const int k = (g % nk) * kChunk + P * c;
      uint8_t* stage = ring + (g & 1) * kStage;
#pragma unroll
      for (int i = 0; i < kQI; ++i)
        copy_piece<T, VEC>(stage, q, rb + 16 * i, r0 + rb + 16 * i, Bq, c,
                           k, D);
#pragma unroll
      for (int i = 0; i < kXI; ++i)
        copy_piece<T, VEC>(stage + kQBytes, x, rb + 16 * i,
                           c0 + rb + 16 * i, N, c, k, D);
    }
    sm90::cp_async_commit();
  };

  float acc[kBN / 2];
  float qss[kQI], xss[kXI];
#pragma unroll
  for (int i = 0; i < kQI; ++i) qss[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kXI; ++i) xss[i] = 0.f;

  fetch(0);
  for (int g = 0; g < total; ++g) {
    const int kc = g % nk;
    sm90::cp_async_wait<0>();           // chunk g has landed
    sm90::fence_proxy_async();
    __syncthreads();
    fetch(g + 1);                      // into chunk g - 1's free stage

    uint8_t* stage = ring + (g & 1) * kStage;
    const int k0 = kc * kChunk;
    if constexpr (kSplit<T>) {
      // the pass over chunk g: norms and the split, big parts in place
#pragma unroll
      for (int i = 0; i < kQI + kXI; ++i) {
        const bool isq = i < kQI;
        const int row = rb + 16 * (isq ? i : i - kQI);
        const uint32_t off = (isq ? 0 : kQBytes) + sm90::swz128(row, c);
        const float4 v = *reinterpret_cast<const float4*>(stage + off);
        const float sq = split_piece(stage, sm, off, v);
        if (isq) qss[i] += sq;
        else xss[i - kQI] += sq;
      }
      sm90::fence_proxy_async();
      __syncthreads();

      const uint32_t big = sm90::smem_u32(stage);
      const uint32_t small = sm90::smem_u32(sm);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        if (k0 + kk * 8 < D) {
          const uint32_t off = kk * 32;
          const uint64_t qbig = sm90::desc_kmajor(big + off);
          const uint64_t qsm = sm90::desc_kmajor(small + off);
          const uint64_t xbig = sm90::desc_kmajor(big + kQBytes + off);
          const uint64_t xsm = sm90::desc_kmajor(small + kQBytes + off);
          // a tile's first product overwrites the accumulator
          sm90::wgmma_ss_m64n128k8_tf32(acc, qsm, xbig, kc > 0 || kk > 0);
          sm90::wgmma_ss_m64n128k8_tf32(acc, qbig, xsm, 1);
          sm90::wgmma_ss_m64n128k8_tf32(acc, qbig, xbig, 1);
        }
      }
    } else {
      if (l2) {  // the norms; the products of 16-bit values are exact
#pragma unroll
        for (int i = 0; i < kQI + kXI; ++i) {
          const bool isq = i < kQI;
          const int row = rb + 16 * (isq ? i : i - kQI);
          const uint32_t off = (isq ? 0 : kQBytes) + sm90::swz128(row, c);
          const float sq =
              sq_piece<T>(*reinterpret_cast<const uint4*>(stage + off));
          if (isq) qss[i] += sq;
          else xss[i - kQI] += sq;
        }
      }
      const uint32_t base = sm90::smem_u32(stage);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        if (k0 + kk * 16 < D) {
          const uint32_t off = kk * 32;
          // a tile's first product overwrites the accumulator
          sm90::wgmma_ss<kBN, T>(acc, sm90::desc_kmajor(base + off),
                                 sm90::desc_kmajor(base + kQBytes + off),
                                 kc > 0 || kk > 0);
        }
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (kc != nk - 1) continue;

    // the epilogue of this tile
    int r0, c0;
    tile_of(g, r0, c0);
#pragma unroll
    for (int i = 0; i < kQI; ++i) {   // 8 lanes hold the pieces of a row
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        qss[i] += __shfl_xor_sync(rt::kFull, qss[i], o);
      if (c == 0) qn[rb + 16 * i] = qss[i];
      qss[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kXI; ++i) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        xss[i] += __shfl_xor_sync(rt::kFull, xss[i], o);
      if (c == 0) xn[rb + 16 * i] = xss[i];
      xss[i] = 0.f;
    }
    __syncthreads();
    // through this warp's part of the current stage (the wgmmas that read
    // it are done; the next chunk copies into the other): 8 rows of the
    // accumulator at a time, then each row as 32 lanes x 16 bytes, so
    // that a store instruction writes 512 contiguous bytes of a row
    float* buf = reinterpret_cast<float*>(stage) + warp * 8 * kOutPad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        *reinterpret_cast<float2*>(buf + (lane >> 2) * kOutPad + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      __syncwarp();
      const int cl = 4 * lane, col = c0 + cl;
      const float4 xq = *reinterpret_cast<const float4*>(xn + cl);
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int rl = 16 * warp + 8 * i + rr;
        const int r = r0 + rl;
        if (r >= Bq) break;
        const float qq = qn[rl];
        const float4 d4 =
            *reinterpret_cast<const float4*>(buf + rr * kOutPad + cl);
        // l2 as the plain version orders it: (qq - 2 dot) + xx
        float4 v;
        v.x = l2 ? (qq - 2.0f * d4.x) + xq.x : -d4.x;
        v.y = l2 ? (qq - 2.0f * d4.y) + xq.y : -d4.y;
        v.z = l2 ? (qq - 2.0f * d4.z) + xq.z : -d4.z;
        v.w = l2 ? (qq - 2.0f * d4.w) + xq.w : -d4.w;
        float* orow = out + static_cast<size_t>(r) * N;
        if (out_vec && col + 3 < N) {
          __stcs(reinterpret_cast<float4*>(orow + col), v);
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (col + u < N) __stcs(orow + col + u, e[u]);
        }
      }
      __syncwarp();
    }
  }
  sm90::cp_async_wait<0>();
}

constexpr int kMaxDevices = 64;

// `smem`: the block's dynamic shared memory as the wrapper planned it
// (kernels/distance.py::plan), at least kSmem<T>
template <typename T, bool VEC>
int launch(const void* q, const void* x, void* out, int Bq, int N, int D,
           int metric, int smem, cudaStream_t stream) {
  auto* kern = dist_kernel<T, VEC>;
  const int nqt = (Bq + kBM - 1) / kBM;
  const long long tiles =
      static_cast<long long>(nqt) * ((N + kBN - 1) / kBN);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0x7fffffffLL || dev >= kMaxDevices ||
      smem < static_cast<int>(kSmem<T>))
    return static_cast<int>(cudaErrorInvalidValue);
  // once a device and size: the shared-memory opt-in and the blocks the
  // card holds at once
  static int resident[kMaxDevices] = {};
  static int planned[kMaxDevices] = {};
  if (resident[dev] == 0 || planned[dev] != smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, kThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    resident[dev] = sms * std::max(per_sm, 1);
    planned[dev] = smem;
  }
  const long long blocks =
      std::min(tiles, static_cast<long long>(resident[dev]));
  const bool out_vec =
      N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x),
      static_cast<float*>(out), Bq, N, D, metric, nqt,
      static_cast<int>(tiles), out_vec);
  return static_cast<int>(cudaGetLastError());
}

// vec: 16-byte copies (the wrapper's plan: D a multiple of a 16-byte
// piece's values, both pointers 16-byte aligned), else element loads
template <typename T>
int launch_any(const void* q, const void* x, void* out, int Bq, int N, int D,
               int metric, int vec, int smem, cudaStream_t stream) {
  return vec ? launch<T, true>(q, x, out, Bq, N, D, metric, smem, stream)
             : launch<T, false>(q, x, out, Bq, N, D, metric, smem, stream);
}

}  // namespace tc

// q [Bq, D] and x [N, D], both of `dtype` (0 f32, 1 bf16, 2 f16) ->
// out f32[Bq, N]; metric 0 l2, 1 ip; vec and smem as the wrapper planned
// them. ceil(Bq / 64) * ceil(N / 128) tiles (at most 2^31 - 1) over as
// many blocks as the card holds at once.
RT_API int rt_pairwise_dist(const void* q, const void* x, void* out, int Bq,
                            int N, int D, int dtype, int metric, int vec,
                            int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return tc::launch_any<float>(q, x, out, Bq, N, D, metric, vec, smem,
                                   s);
    case 1:
      return tc::launch_any<__nv_bfloat16>(q, x, out, Bq, N, D, metric, vec,
                                           smem, s);
    case 2:
      return tc::launch_any<__half>(q, x, out, Bq, N, D, metric, vec, smem,
                                    s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The least dynamic shared memory a block of rt_pairwise_dist takes for
// inputs of `dtype` (kSmem), exported for kernels/distance.py::smem_of;
// -1 for a dtype it does not take.
RT_API long long rt_pairwise_smem(int dtype) {
  switch (dtype) {
    case 0: return static_cast<long long>(tc::kSmem<float>);
    case 1: return static_cast<long long>(tc::kSmem<__nv_bfloat16>);
    case 2: return static_cast<long long>(tc::kSmem<__half>);
    default: return -1;
  }
}
