// All-pairs distance, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/distance.py::_dist_kernel (line
// 26; pallas_call at line 79). Semantics: the port's kernels/ref.py::
// pairwise_dist: q[Bq, D] x x[N, D] -> f32[Bq, N], l2 ``‖q‖² − 2q·x +
// ‖x‖²`` or ip ``−q·x``, with f32, bf16 or f16 inputs. Two bodies, chosen
// by dtype:
//
// f32 inputs: the tensor cores, 3xTF32 (namespace tc). Bound on the H100:
// 3 * 2*Bq*N*D flops at the TF32 peak (495 TFLOP/s) or the bytes (inputs
// read once, 4*Bq*N written), the larger: 1.552 ms at 1,000 x 1M, d = 128
// (operations), 0.0229 ms at the roofline's 64 x 100,000 (bytes). Design:
// one warpgroup (128 threads) per block, three blocks to an SM (74.5 KB
// of shared memory and 128 registers a thread each), persistent: block b
// walks output tiles b, b + grid, ... of 64 x 128 (queries x rows of x),
// neighbouring blocks on the same x rows at once so that they come from
// L2 after the first read. D is walked in chunks of 32 values (128 bytes) a
// row, the chunks of all of a block's tiles as one stream: 16-byte cp.async
// copies (zero-filled outside Bq, N and D) keep the next chunk in flight in
// a two-stage ring in the 128-byte swizzle; where D or a pointer is not
// 16-byte aligned (e.g. d = 131), element loads fill the stage instead.
// Each chunk has one pass over its values by all threads, which sums their
// squares in f32 into the row norms and splits each value a into big =
// cvt.rna.tf32(a), written over a, and small = a - big (exact in f32), in
// a buffer laid out alike; then the tf32 wgmmas (m64n128k8) accumulate
// big.big + big.small + small.big in f32. The dropped small.small and the
// hardware's truncation of small to tf32 leave about 2^-21 of |a_i b_i| a
// product, far inside 1e-5 of ‖q‖² + ‖x‖². One block's pass runs under
// the others' wgmmas. After a tile's last chunk the epilogue writes (qq -
// 2 dot) + xx (or -dot) straight from the accumulator, a quad of threads
// 32 contiguous bytes of a row (streaming stores), while the next tile's
// first chunk is already copying.
//
// bf16 / f16 inputs: the CUDA cores (namespace simt), every dot one f32
// FMA chain in k order -- the plain version's (cuBLAS's) order and
// rounding, which the half types' card gate (one bf16 ulp plus 1e-5 of
// the plain version's output) needs where -q.x cancels to near 0: a
// bf16/f16 wgmma body, whose sums run in another order, was built and
// differed there by up to 1.4e-4 (PERF.md, section 6). Bound: 2*Bq*N*D
// at the 16-bit tensor peak (989 TFLOP/s) or the bytes, the larger (1.270
// ms at 1,000 x 1M, by bytes); on the CUDA cores the f32 FMA rate (67
// TFLOP/s) caps this body at 3.8 ms there. Design: one block of 256 threads per 64x64
// output tile; K-tiles of 32 columns of q and x loaded with their rows'
// lanes on consecutive addresses, widened to f32 and staged in shared
// memory ([64][33], the pad keeps every access conflict-free); each thread
// keeps a 4x4 register tile of dots (q rows ty + 16i, x rows tx + 16j)
// and runs f32 FFMAs. The norm terms accumulate in the same K-loop, two
// warps summing one staged row each.
//
// Nothing is padded or copied outside the kernels.
#include "common.cuh"
#include "hopper.cuh"

#include <algorithm>

namespace simt {


constexpr int kTile = 64;     // output rows and columns per block
constexpr int kK = 32;        // K columns per staged tile
constexpr int kThreads = 256;
constexpr int kPad = kK + 1;

template <typename T>
__device__ __forceinline__ float widen(T v);
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dist_kernel(const T* __restrict__ q, const T* __restrict__ x,
            float* __restrict__ out, int Bq, int N, int D, int metric) {
  __shared__ float qs[kTile][kPad];
  __shared__ float xs[kTile][kPad];
  __shared__ float qn[kTile];
  __shared__ float xn[kTile];

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // threads 0-63: ‖q row t‖²; 64-127: ‖x row t-64‖²

  for (int k0 = 0; k0 < D; k0 += kK) {
    // stage: element e = t + 256 s of each 64x32 tile is (row e/32, col
    // e%32), so a warp reads 32 consecutive columns of one row
#pragma unroll
    for (int s = 0; s < kTile * kK / kThreads; ++s) {
      const int e = t + s * kThreads;
      const int row = e / kK, col = e % kK;
      const int k = k0 + col;
      const int qr = r0 + row, xr = c0 + row;
      qs[row][col] = (qr < Bq && k < D)
                         ? widen(q[static_cast<size_t>(qr) * D + k])
                         : 0.f;
      xs[row][col] = (xr < N && k < D)
                         ? widen(x[static_cast<size_t>(xr) * D + k])
                         : 0.f;
    }
    __syncthreads();
    if (t < 2 * kTile) {  // warps 0-3: the norms, same K-loop
      const float* r = t < kTile ? qs[t] : xs[t - kTile];
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) nrm = fmaf(r[kk], r[kk], nrm);
    }
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (t < kTile) qn[t] = nrm;
  else if (t < 2 * kTile) xn[t - kTile] = nrm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= Bq) continue;
    float* orow = out + static_cast<size_t>(r) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= N) continue;
      const float dot = acc[i][j];
      // l2 as the plain version orders it: (qq - 2 dot) + xx (2*dot is
      // exact, so a contracted fma rounds the same)
      orow[c] = metric == rt::kMetricL2
                    ? (qn[ty + 16 * i] - 2.0f * dot) + xn[tx + 16 * j]
                    : -dot;
    }
  }
}

template <typename T>
int launch_simt(const void* q, const void* x, void* out, int Bq, int N, int D,
           int metric, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (Bq + kTile - 1) / kTile);
  dist_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x),
      static_cast<float*>(out), Bq, N, D, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

namespace tc {

constexpr int kBM = 64;        // queries per tile: the wgmma's M
constexpr int kBN = 128;       // rows of x per tile: its N
constexpr int kThreads = 128;
constexpr int kChunk = 32;     // f32 values per 128-byte row chunk
// one ring stage: q then x, 128-byte rows (the split's big parts replace
// the values in place); two stages, then the small parts, laid out alike
constexpr int kQBytes = kBM * 128, kXBytes = kBN * 128;
constexpr int kStage = kQBytes + kXBytes;
constexpr int kNorms = 3 * kStage;
constexpr size_t kSmem = 1024 + kNorms + (kBM + kBN) * sizeof(float);

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

// piece c (4 values from k) of source row `grow` into row `row` of a ring
// stage's tile, zeros outside [0, nrows) x [0, D): a cp.async (VEC: D % 4
// == 0 and 16-byte aligned pointers) or element loads
template <bool VEC>
__device__ __forceinline__ void copy_piece(uint8_t* tile, const float* src,
                                           int row, int grow, int nrows,
                                           int c, int k, int D) {
  uint8_t* dst = tile + sm90::swz128(row, c);
  const bool in = grow < nrows && k < D;
  const float* p = src + static_cast<size_t>(in ? grow : 0) * D;
  if constexpr (VEC) {
    sm90::cp_async16(dst, in ? p + k : src, in ? 16 : 0);
  } else {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = in && k + i < D ? p[k + i] : 0.f;
    *reinterpret_cast<float4*>(dst) = make_float4(e[0], e[1], e[2], e[3]);
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
    bw[i] = tf32_rna(a[i]);
    rw[i] = __float_as_uint(a[i] - __uint_as_float(bw[i]));
  }
  *reinterpret_cast<uint4*>(big + off) = make_uint4(bw[0], bw[1], bw[2],
                                                    bw[3]);
  *reinterpret_cast<uint4*>(small + off) = make_uint4(rw[0], rw[1], rw[2],
                                                      rw[3]);
  return sq;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
dist_kernel(const float* __restrict__ q, const float* __restrict__ x,
            float* __restrict__ out, int Bq, int N, int D, int metric,
            int nqt, int ntiles, bool out_vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  uint8_t* sm = smem + 2 * kStage;                   // the small parts
  float* qn = reinterpret_cast<float*>(smem + kNorms);
  float* xn = qn + kBM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
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
      const int k = (g % nk) * kChunk + 4 * c;
      uint8_t* stage = ring + (g & 1) * kStage;
#pragma unroll
      for (int i = 0; i < kQI; ++i)
        copy_piece<VEC>(stage, q, rb + 16 * i, r0 + rb + 16 * i, Bq, c, k,
                        D);
#pragma unroll
      for (int i = 0; i < kXI; ++i)
        copy_piece<VEC>(stage + kQBytes, x, rb + 16 * i, c0 + rb + 16 * i,
                        N, c, k, D);
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

    // the pass over chunk g: norms and the split, big parts in place
    uint8_t* stage = ring + (g & 1) * kStage;
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
    const int k0 = kc * kChunk;
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
    // straight from the accumulator: a quad writes 32 contiguous bytes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = 16 * warp + (lane >> 2) + 8 * i;
      const int r = r0 + rl;
      if (r >= Bq) continue;
      const float qq = qn[rl];
      float* orow = out + static_cast<size_t>(r) * N;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int cl = 8 * j + 2 * (lane & 3), col = c0 + cl;
        const float d0 = acc[4 * j + 2 * i], d1 = acc[4 * j + 2 * i + 1];
        // l2 as the plain version orders it: (qq - 2 dot) + xx
        const float v0 =
            metric == rt::kMetricL2 ? (qq - 2.0f * d0) + xn[cl] : -d0;
        const float v1 =
            metric == rt::kMetricL2 ? (qq - 2.0f * d1) + xn[cl + 1] : -d1;
        if (out_vec && col + 1 < N) {
          __stcs(reinterpret_cast<float2*>(orow + col), make_float2(v0, v1));
        } else {
          if (col < N) __stcs(orow + col, v0);
          if (col + 1 < N) __stcs(orow + col + 1, v1);
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
}

constexpr int kMaxDevices = 64;

template <bool VEC>
int launch(const void* q, const void* x, void* out, int Bq, int N, int D,
           int metric, cudaStream_t stream) {
  auto* kern = dist_kernel<VEC>;
  const int nqt = (Bq + kBM - 1) / kBM;
  const long long tiles =
      static_cast<long long>(nqt) * ((N + kBN - 1) / kBN);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0x7fffffffLL || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  // once a device: the shared-memory opt-in and the blocks it holds at once
  static int resident[kMaxDevices] = {};
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(kSmem))) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, kThreads, kSmem)) != cudaSuccess)
      return static_cast<int>(err);
    resident[dev] = sms * std::max(per_sm, 1);
  }
  const long long blocks =
      std::min(tiles, static_cast<long long>(resident[dev]));
  const bool out_vec =
      N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  kern<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<float*>(out), Bq, N, D, metric, nqt,
      static_cast<int>(tiles), out_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// q [Bq, D] and x [N, D], both of `dtype` (0 f32, 1 bf16, 2 f16) ->
// out f32[Bq, N]; metric 0 l2, 1 ip. f32: ceil(Bq / 64) * ceil(N / 128)
// tiles (at most 2^31 - 1) over as many blocks as the card holds at once;
// bf16 / f16: one block per 64 x 64 tile, Bq <= 65535 * 64.
RT_API int rt_pairwise_dist(const void* q, const void* x, void* out, int Bq,
                            int N, int D, int dtype, int metric,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      const bool vec = D % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
      return vec ? tc::launch<true>(q, x, out, Bq, N, D, metric, s)
                 : tc::launch<false>(q, x, out, Bq, N, D, metric, s);
    }
    case 1:
      return simt::launch_simt<__nv_bfloat16>(q, x, out, Bq, N, D, metric,
                                              s);
    case 2: return simt::launch_simt<__half>(q, x, out, Bq, N, D, metric, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
