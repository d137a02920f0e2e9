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
// least time is B*C*(d*4+8) + B*m*4 bytes over the memory rate. What keeps
// a kernel from it is (a) reading a row more than once per node and (b)
// the m dependent sweeps, each a block-wide argmin and a column of dots.
//
// Design. Every candidate row is read into the SM once per node, decoded
// to f32, bar the partial regime's unstaged rows and the table's lazy
// columns below (block: f32 rows by cp.async, every row of a warp in
// flight at once, the codec layouts through registers, four rows at a
// time; table: kRows rows at a time through registers). One CTA a node;
// kernels/prune.py::smem_plan picks one of three regimes per (C, d):
//   * block (all C rows staged; d = 128, three CTAs an SM): each warp
//     finds a sweep's pick by scanning the candidates' (du, position)
//     order (block_sweeps), its dots read the staged rows, and one
//     __syncthreads ends the sweep;
//   * table (prune_table_kernel below; d = 1,024-3,072): stages only the
//     16 kept candidates nearest by (du, position) and streams every row
//     once through a [C, 16] table of their dots, so a sweep whose keep is
//     among the 16 reads its column and no row at all;
//   * partial (neither fits, e.g. d = 4,096 and up): the block regime's
//     sweeps with only the first `staged` rows in shared memory; the
//     other rows stay in global memory and are decoded again in each
//     sweep's dots (row_dot_ldg).
// A thread-block cluster of 2-8 CTAs a node, every row staged across
// their shared memory, was built and measured slower than the table at
// d = 1,024 (PERF.md §6), and is not kept.
// One barrier per sweep: candidate j is owned by warp j % warps for
// everything -- its gather, its dedup, its key, its dots and its flags --
// so nothing but the pick crosses warps. In the table regime each warp
// reduces its keys (two redux.sync), writes one entry to a double-buffered
// red[step & 1], passes the one barrier, and reduces every entry itself,
// so every warp knows the pick; the warp whose own key it was marks it
// taken. A warp issues the dots of its live rows eight at a time (four at
// a time in the 4-warp variant, whose registers are bounded for five CTAs
// an SM): groups of four FMA chains sharing each load of the keep's row,
// each group summed in one transposed butterfly (warp_sum4: 6 shuffles
// for 4).
//
// Every sum has one order, whatever the regime: each dot and ||x||^2 is
// the lane-strided fmaf loop (float4 groups where the stored rows take
// vector loads, else one element per lane step) followed by
// rt::warp_sum's xor-butterfly tree, and warp_sum4 evaluates that same
// tree for each of its four sums (an f32 add is commutative, so which lane
// of a pair adds is immaterial). A dot's result never depends on where its
// row lives or with which rows it is grouped; so the regime and `staged`
// never change a kept id.
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
#include "hopper.cuh"

namespace {

constexpr int kMaxWarps = 8;  // threads per CTA: 32 * warps, warps <= 8
constexpr unsigned char kValid = 1, kSupp = 2, kTaken = 4;

// A sweep key (class, du, position) as two words compared in order: hi =
// class << 16 | the top half of du's order-preserving bits, lo = their
// bottom half << 16 | position (C < 65,536, smem_plan). Equal du give
// equal bits (-0 is made +0 first), so the order is the plain version's.
struct Key {
  uint32_t hi, lo;
};

__device__ __forceinline__ Key make_key(int cls, float du, int pos) {
  const uint32_t u = __float_as_uint(du + 0.0f);
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return Key{(static_cast<uint32_t>(cls) << 16) | (o >> 16),
             (o << 16) | static_cast<uint32_t>(pos)};
}

__device__ __forceinline__ Key no_key() {  // class 2: nothing to take
  return Key{(2u << 16) | 0xffffu, 0xffffffffu};
}

__device__ __forceinline__ bool less(Key a, Key b) {
  return a.hi != b.hi ? a.hi < b.hi : a.lo < b.lo;
}

__device__ __forceinline__ Key warp_min(Key k) {
  const uint32_t hi = __reduce_min_sync(rt::kFull, k.hi);
  return Key{hi, __reduce_min_sync(rt::kFull,
                                   k.hi == hi ? k.lo : 0xffffffffu)};
}

// Four warp sums at once, each by rt::warp_sum's tree: level 16 pairs sums
// (0, 1) and (2, 3), level 8 pairs the two halves' survivors, and levels
// 4, 2, 1 run on eight lanes a sum. Lane l ends with sum slot_of(l).
__device__ __forceinline__ float warp_sum4(float a0, float a1, float a2,
                                           float a3, int lane) {
  const bool h16 = lane & 16, h8 = lane & 8;
  float x0 = h16 ? a1 : a0, y0 = h16 ? a0 : a1;
  float x1 = h16 ? a3 : a2, y1 = h16 ? a2 : a3;
  x0 += __shfl_xor_sync(rt::kFull, y0, 16);
  x1 += __shfl_xor_sync(rt::kFull, y1, 16);
  float x = h8 ? x1 : x0;
  const float y = h8 ? x0 : x1;
  x += __shfl_xor_sync(rt::kFull, y, 8);
  x += __shfl_xor_sync(rt::kFull, x, 4);
  x += __shfl_xor_sync(rt::kFull, x, 2);
  x += __shfl_xor_sync(rt::kFull, x, 1);
  return x;
}

__device__ __forceinline__ int slot_of(int lane) {
  return ((lane >> 3) & 1) * 2 + ((lane >> 4) & 1);
}

__device__ __forceinline__ void fma4(float& a, float4 u, float4 v) {
  a = fmaf(u.x, v.x, a);
  a = fmaf(u.y, v.y, a);
  a = fmaf(u.z, v.z, a);
  a = fmaf(u.w, v.w, a);
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

// x.xp of up to four staged rows (r1..r3 may be null) with the keep's row
// xp, both in shared memory: four fmaf chains that share each load of xp,
// lanes strided over d, summed by warp_sum4; lane l gets row slot_of(l)'s.
__device__ __forceinline__ float dots4(const float* r0, const float* r1,
                                       const float* r2, const float* r3,
                                       const float* xp, int d, int vec4,
                                       int lane) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (vec4) {
    const float4* p4 = reinterpret_cast<const float4*>(xp);
#pragma unroll 2
    for (int k = lane; k < (d >> 2); k += 32) {
      const float4 v = p4[k];
      fma4(a0, reinterpret_cast<const float4*>(r0)[k], v);
      if (r1) fma4(a1, reinterpret_cast<const float4*>(r1)[k], v);
      if (r2) fma4(a2, reinterpret_cast<const float4*>(r2)[k], v);
      if (r3) fma4(a3, reinterpret_cast<const float4*>(r3)[k], v);
    }
  } else {
    for (int k = lane; k < d; k += 32) {
      const float v = xp[k];
      a0 = fmaf(r0[k], v, a0);
      if (r1) a1 = fmaf(r1[k], v, a1);
      if (r2) a2 = fmaf(r2[k], v, a2);
      if (r3) a3 = fmaf(r3[k], v, a3);
    }
  }
  return warp_sum4(a0, a1, a2, a3, lane);
}

// x.xp of one row stored in global memory (the partial regime and the
// table's lazy columns), decoded on the fly: the same sum in the same order.
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
    for (int k = lane; k < (d >> 2); k += 32)
      fma4(a, load4<LAYOUT>(t, row, k, s), b4[k]);
  } else {
    for (int k = lane; k < d; k += 32)
      a = fmaf(load1<LAYOUT>(t, row, k, s), xp[k], a);
  }
  return rt::warp_sum(a);
}

// Dynamic shared memory of one staged-rows CTA (kernels/prune.py::
// smem_bytes computes the same): the staged rows [staged][dp] f32, the
// keep's row [dp] where staged < C (the partial regime), and 17 B a
// candidate: xx, du, ids [C], the kept candidates in (du, position) order
// and each one's place in it [C] (int16 each), flags [C].
__host__ __device__ __forceinline__ size_t smem_bytes(int C, int d,
                                                      int staged) {
  const size_t dp = (d + 3) & ~3;
  return (static_cast<size_t>(staged) + (staged < C ? 1 : 0)) * dp * 4 +
         static_cast<size_t>(C) * 17;
}

// The sweeps of one staged-rows CTA. Every candidate's rank in (du,
// position) order among the kept ones is computed once; a class-0 pick is
// then the first candidate in that order past the last keep that is not
// suppressed, and a class-1 pick (the fill) the first suppressed one past
// the last fill, so every warp finds the pick itself by one scan of the
// order, with no argmin and no exchange. Keeps are taken in increasing
// rank and only rows ranked after the keep are suppressed, so a row before
// the scan's pointer never changes and none is marked taken. The one
// barrier a sweep follows the dots: the next scan sees every warp's
// suppressions. Rows at positions >= staged (the partial regime) stay in
// global memory: an unstaged keep's row is decoded into xk, and the dots
// of unstaged rows read them again (row_dot_ldg); kPart compiles that in.
template <int LAYOUT, bool kSmall, bool kPart>
__device__ __forceinline__ void block_sweeps(
    const rt::Rows& t, const float* xs, float* xk, const float* xx,
    const float* sdu, const int* sid, short* ord, short* rk,
    unsigned char* flags, int* bout, int C, int n, int m, float alpha,
    int fill, int dp, int vec4, int staged, int W, int warp, int lane,
    int mine, int mst) {
  const int d = t.d;
  __syncthreads();  // every warp's dedup flags
  // each kept candidate's rank (one lane a candidate against all C)
  for (int i = lane; i < mine; i += 32) {
    const int c = warp + W * i;
    int r = 0x7fff;
    if (flags[c] & kValid) {
      const float dj = sdu[c];
      r = 0;
#pragma unroll 8
      for (int q = 0; q < C; ++q) {
        const float dq = sdu[q];
        r += (flags[q] & kValid) && (dq < dj || (dq == dj && q < c));
      }
      ord[r] = static_cast<short>(c);
    }
    rk[c] = static_cast<short>(r);
  }
  __syncthreads();
  int next0 = 0, next1 = 0;  // the scans' pointers into the order
  for (int step = 0; step < m; ++step) {
    int ip = -1, cls = 2;
    for (; next0 < C; next0 += 32) {  // class 0: kept, not suppressed
      const int c = next0 + lane < C ? ord[next0 + lane] : -1;
      const unsigned bal =
          __ballot_sync(rt::kFull, c >= 0 && !(flags[c] & kSupp));
      if (bal) {
        ip = next0 + __ffs(bal) - 1;
        cls = 0;
        next0 = ip + 1;
        break;
      }
    }
    if (cls == 2 && fill) {
      for (; next1 < C; next1 += 32) {  // class 1: suppressed, not filled
        const int c = next1 + lane < C ? ord[next1 + lane] : -1;
        const unsigned bal =
            __ballot_sync(rt::kFull, c >= 0 && (flags[c] & kSupp));
        if (bal) {
          ip = next1 + __ffs(bal) - 1;
          cls = 1;
          next1 = ip + 1;
          break;
        }
      }
    }
    if (cls == 2) {  // nothing left: the rest of the row is -1
      for (int i = step + threadIdx.x; i < m; i += blockDim.x) bout[i] = -1;
      break;
    }
    const int pp = ord[ip];
    if (threadIdx.x == 0) bout[step] = sid[pp];
    if (cls == 0) {  // a keep: its cc column suppresses the rows after it
      const float* xp = xs + static_cast<size_t>(pp) * dp;
      if (kPart && pp >= staged) {  // uniform over the CTA: decode it
        const int row = min(sid[pp], n - 1);
        const float s = row_scale<LAYOUT>(t, row);
        if (vec4) {
          for (int k = threadIdx.x; k < (d >> 2); k += blockDim.x)
            reinterpret_cast<float4*>(xk)[k] = load4<LAYOUT>(t, row, k, s);
        } else {
          for (int k = threadIdx.x; k < d; k += blockDim.x)
            xk[k] = load1<LAYOUT>(t, row, k, s);
        }
        __syncthreads();
        xp = xk;
      }
      const float xxp = xx[pp];
      for (int i0 = 0; i0 < mine; i0 += 32) {
        const int i = i0 + lane;
        bool live = false;
        if (i < mine) {
          const int c = warp + W * i;
          live = (flags[c] & kValid) && !(flags[c] & kSupp) && rk[c] > ip;
        }
        unsigned sm = __ballot_sync(rt::kFull, live), gm = 0u;
        if constexpr (kPart) {  // this warp's row i is staged where i < mst
          const int ns = mst - i0;
          gm = ns >= 32 ? 0u : ns > 0 ? sm & ~((1u << ns) - 1u) : sm;
          sm &= ~gm;
        }
        constexpr int kGroup = kSmall ? 4 : 8;
        while (sm) {  // staged rows, kGroup at a time (one or two dots4)
          int c[kGroup];
          const float* r[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            c[g] = sm ? warp + W * (i0 + __ffs(sm) - 1) : -1;
            sm &= sm - 1;
            r[g] = c[g] >= 0 ? xs + static_cast<size_t>(c[g]) * dp : nullptr;
          }
          float xy[kGroup / 4];
          xy[0] = dots4(r[0], r[1], r[2], r[3], xp, d, vec4, lane);
          if constexpr (kGroup == 8)
            xy[1] = r[4] ? dots4(r[4], r[5], r[6], r[7], xp, d, vec4, lane)
                         : 0.f;
          const int g = slot_of(lane);
#pragma unroll
          for (int h = 0; h < kGroup / 4; ++h) {
            const int cg = g == 0   ? c[4 * h]
                           : g == 1 ? c[4 * h + 1]
                           : g == 2 ? c[4 * h + 2]
                                    : c[4 * h + 3];
            if ((lane & 7) == 0 && cg >= 0) {
              const float cc = fmaxf((xx[cg] - 2.0f * xy[h]) + xxp, 0.0f);
              if (alpha * cc < sdu[cg]) flags[cg] |= kSupp;
            }
          }
        }
        if constexpr (kPart) {
          while (gm) {  // rows left in global memory
            const int cg = warp + W * (i0 + __ffs(gm) - 1);
            gm &= gm - 1;
            const float xy =
                row_dot_ldg<LAYOUT>(t, min(sid[cg], n - 1), xp, vec4, lane);
            if (lane == 0) {
              const float cc = fmaxf((xx[cg] - 2.0f * xy) + xxp, 0.0f);
              if (alpha * cc < sdu[cg]) flags[cg] |= kSupp;
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// kSmall: at most 4 warps and several CTAs an SM (the block regime at
// d = 128), so registers are bounded for five CTAs an SM. kPart: the
// partial regime (staged < C), compiled apart: its global-memory rows in
// the block regime's sweeps cost that regime 5-9% at d = 128 (PERF.md §6).
template <int LAYOUT, bool kSmall, bool kPart>
__global__ void __launch_bounds__(kSmall ? 128 : kMaxWarps * 32,
                                  kSmall ? 5 : 1)
prune_kernel(const int* __restrict__ cand_ids,
             const float* __restrict__ cand_dists, const rt::Rows t,
             int* __restrict__ out, int C, int n, int m, float alpha,
             int fill, int vec4, int staged) {
  extern __shared__ float4 smem4[];
  const int d = t.d;
  const int dp = (d + 3) & ~3;
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* xs = reinterpret_cast<float*>(smem4);
  float* xk = xs + static_cast<size_t>(staged) * dp;
  float* xx = xk + (staged < C ? dp : 0);
  float* sdu = xx + C;
  int* sid = reinterpret_cast<int*>(sdu + C);
  short* ord = reinterpret_cast<short*>(sid + C);
  short* rk = ord + C;
  unsigned char* flags = reinterpret_cast<unsigned char*>(rk + C);

  const size_t b = blockIdx.x;  // the build node
  const int* bid = cand_ids + b * C;
  const float* bdu = cand_dists + b * C;
  int* bout = out + b * m;
  // this warp's positions are warp + W*i for i < mine, the first `mst` of
  // them staged (positions < staged)
  const int mine = C > warp ? (C - warp + W - 1) / W : 0;
  const int mst = staged > warp ? (staged - warp + W - 1) / W : 0;

  // the first of this thread's ids and du in flight before the copies
  const int id0 = threadIdx.x < C ? bid[threadIdx.x] : -1;
  const float du0 = threadIdx.x < C ? bdu[threadIdx.x] : 0.f;
  // f32 rows: every staged row of this warp in flight at once (cp.async,
  // no registers), before anything waits
  constexpr bool kCopy = LAYOUT == rt::kF32;
  if (kCopy && vec4) {
    const float* data = static_cast<const float*>(t.data);
    for (int i0 = 0; i0 < mst; i0 += 32) {
      // 32 rows' ids in one load, then each row's copies
      const int il = i0 + lane;
      const int idl = il < mst ? __ldg(bid + warp + W * il) : -1;
      for (int j = 0; j < min(32, mst - i0); ++j) {
        const int id = __shfl_sync(rt::kFull, idl, j);
        if (id < 0) continue;  // uniform over the warp
        const float* src = data + static_cast<size_t>(min(id, n - 1)) * d;
        float* dst = xs + static_cast<size_t>(warp + W * (i0 + j)) * dp;
        for (int k = lane; k < (d >> 2); k += 32)
          sm90::cp_async16(dst + 4 * k, src + 4 * k, 16);
      }
    }
    sm90::cp_async_commit();
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sid[i] = i == threadIdx.x ? id0 : bid[i];
    sdu[i] = i == threadIdx.x ? du0 : bdu[i];
    ord[i] = -1;
  }
  __syncthreads();
  // gather this warp's rows once, four at a time, ||x||^2 on the way in:
  // f32 rows from the staged copies, others decoded from global memory
  // (and staged when i < mst)
  if (kCopy && vec4) {
    sm90::cp_async_wait<0>();
    __syncwarp();
  }
  for (int i0 = 0; i0 < mine; i0 += 4) {
    int row[4];
    float s[4];
    bool live[4];
    float* rs[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int i = i0 + g;
      const int id = i < mine ? sid[warp + W * i] : -1;
      live[g] = id >= 0;  // uniform over the warp
      row[g] = live[g] ? min(id, n - 1) : 0;
      s[g] = live[g] ? row_scale<LAYOUT>(t, row[g]) : 1.f;
      rs[g] = live[g] && i < mst
                  ? xs + static_cast<size_t>(warp + W * i) * dp
                  : nullptr;
    }
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec4) {
      // decoded rows: more loads in flight where registers allow
      constexpr int kUnroll = kSmall ? 2 : 4;
#pragma unroll kUnroll
      for (int k = lane; k < (d >> 2); k += 32) {
        float4 v[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          v[g] = !live[g] ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : (kCopy && rs[g]) ? reinterpret_cast<const float4*>(rs[g])[k]
                                    : load4<LAYOUT>(t, row[g], k, s[g]);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (!kCopy && rs[g]) reinterpret_cast<float4*>(rs[g])[k] = v[g];
          fma4(a[g], v[g], v[g]);
        }
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        float v[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          v[g] = live[g] ? load1<LAYOUT>(t, row[g], k, s[g]) : 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (rs[g]) rs[g][k] = v[g];
          a[g] = fmaf(v[g], v[g], a[g]);
        }
      }
    }
    const float sum = warp_sum4(a[0], a[1], a[2], a[3], lane);
    const int i = i0 + slot_of(lane);
    if ((lane & 7) == 0 && i < mine) xx[warp + W * i] = sum;
  }
  // first-occurrence dedup in (du, position) order, one lane a candidate
  // against all C (no early exit, so the unrolled loads are independent)
  for (int i = lane; i < mine; i += 32) {
    const int c = warp + W * i;
    const int idj = sid[c];
    const float dj = sdu[c];
    bool dup = false;
#pragma unroll 8
    for (int q = 0; q < C; ++q) {
      const float dq = sdu[q];
      dup |= sid[q] == idj && q != c && isfinite(dq) &&
             (dq < dj || (dq == dj && q < c));
    }
    flags[c] = idj >= 0 && isfinite(dj) && !dup ? kValid : 0;
  }
  __syncwarp();
  block_sweeps<LAYOUT, kSmall, kPart>(t, xs, xk, xx, sdu, sid, ord, rk,
                                      flags, bout, C, n, m, alpha, fill, dp,
                                      vec4, staged, W, warp, lane, mine, mst);
}

// ---- the table regime --------------------------------------------------
//
// One CTA a node stages only the kK valid candidates nearest by (du,
// position), the ones the sweeps most likely keep, and streams every
// candidate row once from global memory through a [C, kK] block of dots
// with them (register tiles of kRows rows x kK keeps a warp, each dot the
// same lane-strided fmaf chain and butterfly as everywhere else). A keep
// among the kK then suppresses from its column of the table, with no row
// read in the sweep; a keep beyond them (a lazy column) is decoded into a
// one-row buffer and dotted with the live rows read again from global
// memory. A node takes (kK + 1) rows + 78 B a candidate of shared memory
// instead of C rows.
constexpr int kK = 16;  // table columns: kernels/prune.py::TABLE_K

// Dynamic shared memory of one table CTA (kernels/prune.py::table_bytes):
// red [2][kMaxWarps], the staged rows [min(C, kK)][dp] and the lazy keep's
// row [dp] (f32), the table [C][kK] f32, xx, du, ids [C], the slot of
// each candidate [C] (int8, -1 outside the kK) and flags [C], the
// position of each slot [kK].
__host__ __device__ __forceinline__ size_t table_bytes(int C, int d) {
  const size_t dp = (d + 3) & ~3;
  return static_cast<size_t>(2) * kMaxWarps * 16 +
         (static_cast<size_t>(min(C, kK)) + 1) * dp * 4 +
         static_cast<size_t>(C) * (kK * 4 + 14) + kK * 4;
}

template <int LAYOUT, bool kSmall>
__global__ void __launch_bounds__(kSmall ? 128 : 256, kSmall ? 6 : 2)
prune_table_kernel(const int* __restrict__ cand_ids,
                   const float* __restrict__ cand_dists, const rt::Rows t,
                   int* __restrict__ out, int C, int n, int m, float alpha,
                   int fill, int vec4) {
  constexpr int kRows = kSmall ? 2 : 4;  // rows a register tile
  extern __shared__ float4 smem4[];
  const int d = t.d;
  const int dp = (d + 3) & ~3;
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = min(C, kK);

  uint4* red = reinterpret_cast<uint4*>(smem4);
  float* xs = reinterpret_cast<float*>(red + 2 * kMaxWarps);
  float* xk = xs + static_cast<size_t>(nk) * dp;
  float* tab = xk + dp;                       // [C][kK]
  float* xx = tab + static_cast<size_t>(C) * kK;
  float* sdu = xx + C;
  int* sid = reinterpret_cast<int*>(sdu + C);
  int* kpos = sid + C;                        // [kK]
  signed char* slot = reinterpret_cast<signed char*>(kpos + kK);
  unsigned char* flags = reinterpret_cast<unsigned char*>(slot + C);

  const size_t b = blockIdx.x;
  const int* bid = cand_ids + b * C;
  const float* bdu = cand_dists + b * C;
  int* bout = out + b * m;
  // this warp's candidates are warp + W*i, i < mine
  const int mine = C > warp ? (C - warp + W - 1) / W : 0;

  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sid[i] = bid[i];
    sdu[i] = bdu[i];
  }
  for (int r = threadIdx.x; r < kK; r += blockDim.x) kpos[r] = -1;
  __syncthreads();
  // first-occurrence dedup in (du, position) order, one lane a candidate
  for (int i = lane; i < mine; i += 32) {
    const int c = warp + W * i;
    const int idj = sid[c];
    const float dj = sdu[c];
    bool dup = false;
#pragma unroll 8
    for (int q = 0; q < C; ++q) {
      const float dq = sdu[q];
      dup |= sid[q] == idj && q != c && isfinite(dq) &&
             (dq < dj || (dq == dj && q < c));
    }
    flags[c] = idj >= 0 && isfinite(dj) && !dup ? kValid : 0;
  }
  __syncthreads();
  // each kept candidate's rank in (du, position) order; the first kK get
  // a slot of the table
  for (int i = lane; i < mine; i += 32) {
    const int c = warp + W * i;
    int r = kK;
    if (flags[c] & kValid) {
      const float dj = sdu[c];
      r = 0;
#pragma unroll 8
      for (int q = 0; q < C; ++q) {
        const float dq = sdu[q];
        r += (flags[q] & kValid) && (dq < dj || (dq == dj && q < c));
      }
    }
    slot[c] = r < kK ? r : -1;
    if (r < kK) kpos[r] = c;
  }
  __syncthreads();
  // the slots' rows, decoded to f32 (a slot past the kept count stays
  // empty and its column unused)
  for (int r = warp; r < nk; r += W) {
    const int c = kpos[r];
    if (c < 0) continue;  // uniform over the warp
    const int row = min(sid[c], n - 1);
    const float sc = row_scale<LAYOUT>(t, row);
    float* dst = xs + static_cast<size_t>(r) * dp;
    if (vec4) {
      for (int k = lane; k < (d >> 2); k += 32)
        reinterpret_cast<float4*>(dst)[k] = load4<LAYOUT>(t, row, k, sc);
    } else {
      for (int k = lane; k < d; k += 32) dst[k] = load1<LAYOUT>(t, row, k, sc);
    }
  }
  __syncthreads();
  // every row once: ||x||^2 and its dots with the kK slots, kRows rows a
  // tile; the sums are the dots of the other regimes, term for term
  for (int i0 = 0; i0 < mine; i0 += kRows) {
    int row[kRows];
    float sc[kRows];
    bool live[kRows];
    float a[kRows][kK + 1];  // [kK]: ||x||^2
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      const int i = i0 + g;
      const int id = i < mine ? sid[warp + W * i] : -1;
      live[g] = id >= 0;  // uniform over the warp
      row[g] = live[g] ? min(id, n - 1) : 0;
      sc[g] = live[g] ? row_scale<LAYOUT>(t, row[g]) : 1.f;
#pragma unroll
      for (int r = 0; r <= kK; ++r) a[g][r] = 0.f;
    }
    if (vec4) {
      const float4* x4 = reinterpret_cast<const float4*>(xs);
      const int dp4 = dp >> 2;
#pragma unroll 2
      for (int k = lane; k < (d >> 2); k += 32) {
        float4 u[kRows];
#pragma unroll
        for (int g = 0; g < kRows; ++g) {
          u[g] = live[g] ? load4<LAYOUT>(t, row[g], k, sc[g])
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          fma4(a[g][kK], u[g], u[g]);
        }
#pragma unroll
        for (int r = 0; r < kK; ++r) {
          if (r >= nk) break;  // C < kK: no row staged there
          const float4 v = x4[r * dp4 + k];
#pragma unroll
          for (int g = 0; g < kRows; ++g) fma4(a[g][r], u[g], v);
        }
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        float u[kRows];
#pragma unroll
        for (int g = 0; g < kRows; ++g) {
          u[g] = live[g] ? load1<LAYOUT>(t, row[g], k, sc[g]) : 0.f;
          a[g][kK] = fmaf(u[g], u[g], a[g][kK]);
        }
#pragma unroll
        for (int r = 0; r < kK; ++r) {
          if (r >= nk) break;
          const float v = xs[r * dp + k];
#pragma unroll
          for (int g = 0; g < kRows; ++g) a[g][r] = fmaf(u[g], v, a[g][r]);
        }
      }
    }
    // the (kK + 1) * kRows sums, four at a time: sum q is row q % kRows,
    // column q / kRows (column kK: ||x||^2)
#pragma unroll
    for (int q0 = 0; q0 < (kK + 1) * kRows; q0 += 4) {
      float v[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int q = q0 + s;
        v[s] = q < (kK + 1) * kRows ? a[q % kRows][q / kRows] : 0.f;
      }
      const float sum = warp_sum4(v[0], v[1], v[2], v[3], lane);
      const int q = q0 + slot_of(lane);
      const int i = i0 + q % kRows;
      if ((lane & 7) == 0 && q < (kK + 1) * kRows && i < mine) {
        const int c = warp + W * i;
        if (q / kRows == kK) xx[c] = sum;
        else tab[static_cast<size_t>(c) * kK + q / kRows] = sum;
      }
    }
  }
  __syncwarp();

  for (int step = 0; step < m; ++step) {
    Key best = no_key();
    for (int i = lane; i < mine; i += 32) {
      const int c = warp + W * i;
      const unsigned char f = flags[c];
      if (!(f & kValid) || (f & kTaken)) continue;
      const int cls = (f & kSupp) ? (fill ? 1 : 2) : 0;
      if (cls == 2) continue;
      const Key k = make_key(cls, sdu[c], c);
      if (less(k, best)) best = k;
    }
    best = warp_min(best);
    uint4* rb = red + (step & 1) * kMaxWarps;
    if (lane == 0) rb[warp] = make_uint4(best.hi, best.lo, 0u, 0u);
    __syncthreads();
    Key p = no_key();
    for (int i = 0; i < W; ++i) {  // every lane, W entries
      const uint4 x = rb[i];
      const Key k{x.x, x.y};
      if (less(k, p)) p = k;
    }
    const int cls = p.hi >> 16;
    if (cls == 2) {  // nothing left: the rest of the row is -1
      for (int i = step + threadIdx.x; i < m; i += blockDim.x) bout[i] = -1;
      break;
    }
    const int pp = p.lo & 0xffffu;
    if (threadIdx.x == 0) bout[step] = sid[pp];
    if (best.hi == p.hi && best.lo == p.lo && lane == 0)
      flags[pp] |= kTaken;
    __syncwarp();
    if (cls == 0) {  // a keep: its cc column suppresses the live rest
      const float xxp = xx[pp];
      const int r = slot[pp];
      if (r >= 0) {  // from the table, one lane a candidate
        for (int i = lane; i < mine; i += 32) {
          const int c = warp + W * i;
          const unsigned char f = flags[c];
          if (!(f & kValid) || (f & (kTaken | kSupp))) continue;
          const float xy = tab[static_cast<size_t>(c) * kK + r];
          const float cc = fmaxf((xx[c] - 2.0f * xy) + xxp, 0.0f);
          if (alpha * cc < sdu[c]) flags[c] |= kSupp;
        }
      } else {  // a lazy column: the keep's row, then the live rows again
        const int prow = min(sid[pp], n - 1);
        const float ps = row_scale<LAYOUT>(t, prow);
        if (vec4) {
          for (int k = threadIdx.x; k < (d >> 2); k += blockDim.x)
            reinterpret_cast<float4*>(xk)[k] = load4<LAYOUT>(t, prow, k, ps);
        } else {
          for (int k = threadIdx.x; k < d; k += blockDim.x)
            xk[k] = load1<LAYOUT>(t, prow, k, ps);
        }
        __syncthreads();
        for (int i0 = 0; i0 < mine; i0 += 32) {
          const int i = i0 + lane;
          bool live = false;
          if (i < mine) {
            const unsigned char f = flags[warp + W * i];
            live = (f & kValid) && !(f & (kTaken | kSupp));
          }
          unsigned gm = __ballot_sync(rt::kFull, live);
          while (gm) {
            const int c = warp + W * (i0 + __ffs(gm) - 1);
            gm &= gm - 1;
            const float xy = row_dot_ldg<LAYOUT>(t, min(sid[c], n - 1), xk,
                                                 vec4, lane);
            if (lane == 0) {
              const float cc = fmaxf((xx[c] - 2.0f * xy) + xxp, 0.0f);
              if (alpha * cc < sdu[c]) flags[c] |= kSupp;
            }
          }
        }
      }
    }
    __syncwarp();
  }
}

template <int LAYOUT>
int launch_table(const void* cand_ids, const void* cand_dists,
                 const rt::Rows& t, void* out, int B, int C, int n, int m,
                 float alpha, int fill, int vec4, int warps,
                 cudaStream_t stream) {
  if (warps < 1 || warps > kMaxWarps || C >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = table_bytes(C, t.d);
  auto kern = warps <= 4 ? prune_table_kernel<LAYOUT, true>
                         : prune_table_kernel<LAYOUT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B, 32 * warps, smem, stream>>>(
      static_cast<const int*>(cand_ids), static_cast<const float*>(cand_dists),
      t, static_cast<int*>(out), C, n, m, alpha, fill, vec4);
  return static_cast<int>(cudaGetLastError());
}

template <int LAYOUT>
int launch(const void* cand_ids, const void* cand_dists, const rt::Rows& t,
           void* out, int B, int C, int n, int m, float alpha, int fill,
           int vec4, int staged, int warps, cudaStream_t stream) {
  if (warps < 1 || warps > kMaxWarps || staged < 0 || staged > C ||
      C >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(C, t.d, staged);
  auto kern = staged < C   ? prune_kernel<LAYOUT, false, true>
              : warps <= 4 ? prune_kernel<LAYOUT, true, false>
                           : prune_kernel<LAYOUT, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B, 32 * warps, smem, stream>>>(
      static_cast<const int*>(cand_ids), static_cast<const float*>(cand_dists),
      t, static_cast<int*>(out), C, n, m, alpha, fill, vec4, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cand_ids int32[B, C], cand_dists f32[B, C], a vector table of `layout`
// (csrc/common.cuh::Layout: data = rows or codes, aux = int8 scales or the
// PQ codebook, sub = PQ subspaces) -> out int32[B, m], one CTA of
// 32 * `warps` threads a node. `table` != 0: the table regime
// (table_bytes); else the first `staged` of the C rows staged in shared
// memory as f32, the rest read from global memory (smem_bytes). Returns
// cudaErrorInvalidValue for a plan it cannot run and the launch's error
// otherwise.
RT_API int rt_prune(const void* cand_ids, const void* cand_dists,
                    const void* data, const void* aux, void* out, int B,
                    int C, int d, int n, int sub, int layout, int m,
                    float alpha, int fill, int table, int staged,
                    int warps, void* stream) {
  const rt::Rows t{data, static_cast<const float*>(aux), d, sub,
                   rt::rows_vec(layout, data, aux, d, sub)};
  // the order of every sum, staged or not: float4 groups where the stored
  // rows take vector loads (rows_vec), else one element per lane step
  const int vec4 = t.vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_PRUNE(L)                                                          \
  (table ? launch_table<L>(cand_ids, cand_dists, t, out, B, C, n, m, alpha,  \
                           fill, vec4, warps, s)                             \
         : launch<L>(cand_ids, cand_dists, t, out, B, C, n, m, alpha, fill,  \
                     vec4, staged, warps, s))
  switch (layout) {
    case rt::kF32: return RT_PRUNE(rt::kF32);
    case rt::kBF16: return RT_PRUNE(rt::kBF16);
    case rt::kF16: return RT_PRUNE(rt::kF16);
    case rt::kInt8: return RT_PRUNE(rt::kInt8);
    case rt::kPQ: return RT_PRUNE(rt::kPQ);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_PRUNE
}
