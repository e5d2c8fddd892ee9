// three_interpolate forward: out[q, c] = w0*p[i0, c] + w1*p[i1, c] + w2*p[i2, c],
// optionally followed in the same output row by the row's skip features.
//
// Replaces: pointnet2_tpu/ops/pallas/interpolate.py:48 `_ti_kernel`
//           (reached through `_ti_fwd`, interpolate.py:68-109, and
//           `three_interpolate_pallas`, interpolate.py:187-192), and the
//           feature-propagation concat after it (pointnet2_tpu/nn/pointnet.py
//           FeaturePropagation: `concatenate([interpolated, points1], -1)`).
//
// Semantics: the inverse-distance blend of three gathered feature rows per
// query, accumulated in float32 in the order j = 0, 1, 2 with a rounding
// after every product and sum (no FMA), as the plain PyTorch version does.
// With a skip source (b, n, c1), read through its batch and row strides, the
// output is (b, n, c + c1): the blend in channels [0, c), the skip row copied
// into [c, c + c1), which is torch.cat([blend, skip], -1) bit for bit.
//
// What bounds it on the H100: bytes. Each output element costs 5 flops and 4
// bytes written, far below the card's 20 flops a byte; the (B, N, C) output
// is most of the traffic, and the (B, M, C) feature rows, read three times a
// query, stay in the 50 MB L2. Writing the skip into the same rows saves the
// concat its own read and write of the blend (at FP4, B=8: 33.5 MB each).
//
// Design: one warp takes one output row. Lanes 0-2 read the row's three
// indices and weights once and the warp shares them by shuffle; there is one
// integer division a row (its cloud), none an element. The lanes walk the
// channels with 16-byte loads and stores where the source rows and the output
// rows are 16-byte aligned (C and C + C1 multiples of 4), else with 4-byte
// ones, consecutive lanes on consecutive floats: FP4's output row of 128 + 3
// floats takes the 4-byte path, which on the H100 ran faster there (51
// against 70 us at B=16, PERF.md) than 16-byte loads with each lane storing
// its 4 floats apart. The skip row is copied after the blend, 16 bytes at a
// time where it and its place in the output are aligned. The TPU kernel
// instead builds a dense (tile, M) weight block and multiplies it on the MXU,
// because Mosaic has no vector gather; on this card that would do M/3 times
// the work for nothing.
//
// Features in bfloat16 (the bf16 precision modes): `points` and the skip are
// each float32 or bfloat16, and the output is the concat's promoted type
// (bfloat16 only if both are). A gathered element is widened to float32
// exactly, the weights stay float32 (rounded to bfloat16 first when the
// caller asks, as the "default" precision does for bfloat16 points), the
// blend is the float32 blend above, and it is rounded once to the points'
// type, then stored in the output's (exact when that is wider). So a
// bfloat16 result equals the plain version's bit for bit. The 16-byte
// route takes 8 bfloat16 values a lane and access (C and C + C1 multiples
// of 8); a float32 output of bfloat16 points stores those 8 as two 16-byte
// stores. The skip is copied 16 bytes at a time only where it already has
// the output's type; a bfloat16 skip in a float32 row is widened element by
// element. In bfloat16 the output bytes halve, and so does the byte bound.
//
// ---------------------------------------------------------------------------
// three_interpolate backward (second entry, pn2_three_interpolate_grad):
//   dpoints[m, c] = sum over the pairs (q, j) with idx[q, j] == m of
//                   weight[q, j] * g[q, c]          (ThreeInterpolateGrad).
//
// Replaces: pointnet2_tpu/ops/pallas/interpolate.py:112 `_ti_bwd_kernel`
//           (launched by `_ti_bwd`, interpolate.py:137-184, from the
//           custom_vjp at interpolate.py:187-218).
//
// Semantics: each element is summed in one fixed order, that of the plain
// version (ops.core.three_interpolate_grad, three index_add_ calls): slot
// j = 0, 1, 2, and within a slot the queries in ascending order, from +0.0,
// each product rounded before its add (`__fmul_rn`, `__fadd_rn`). So the
// result equals the plain version bit for bit wherever that sums serially:
// on the CPU, and on the card under torch.use_deterministic_algorithms for
// rows wider than 32 floats (for narrower rows PyTorch's deterministic
// index_add_ adds each call's sum of a row's addends to the row instead).
// Two runs give the same bits. A row no pair names is +0.0. An index outside
// [0, M) adds nothing (the plain version raises on one).
//
// What bounds it on the H100: bytes. The (B, N, C) cotangent is read once
// (67 MB at FP4, batch 16), the (B, M, C) result written once; 2 flops a
// product. The index below moves a few bytes a pair (0.4 M pairs at FP4).
//
// Design: gather by destination row instead of scattering by source, in
// three kernels. The first zeroes a counter a destination row (b * M + idx).
// The second gives each of the 3 * B * N pairs a slot of its row by an
// integer atomic (the counts do not depend on the order) and, up to kSlots =
// 64 a row, leaves the pair's key j * N + q in the row's bucket; the slots'
// order changes from run to run, but keys are unique in a row. The third
// takes one warp a destination row and 128-channel chunk: it sorts the
// bucket's keys in the lanes (a bitonic sort of 32, or of two 32s and a
// merge), which puts them in (j, q) order, then walks them, loading the g
// rows of 8 keys ahead of their ordered adds (enough loads in flight to cover
// L2's latency), 4 channels a lane: 16-byte loads of g and stores of dpoints
// where both are aligned (C, g's strides and pointers multiples of 4 floats),
// else 4-byte accesses 32 floats apart; g is read through its batch and row
// strides (autograd hands over a channel slice of the FP concat's cotangent,
// read in place). A row of more than 64 keys (none at the model's shapes:
// 12 to 24 on average, 51 at most measured at FP4) scans its cloud's pairs
// for slot 0, 1, 2 in query order instead, which is the order of the sum.
// In bfloat16 (g, dpoints or both; dpoints has the type of the forward's
// points): the same keys, order and float32 sums, each g element widened
// exactly, the weight rounded to bfloat16 first when the caller asks, and
// each result rounded once to dpoints' type. The vector route then moves 4
// channels a lane as 8 bytes of bfloat16 (C and g's strides multiples of 4).
//
// Every row is written with plain stores; one no pair names is +0.0. A g row
// is read once for each of its up to three destination rows: at FP4 that is
// about 200 MB out of L2, which bounds this design near 40 us at B=16 where
// the op's bytes allow 23. The index is built in the backward rather than in
// the forward's ThreeInterpolate: the eval path, which never takes the
// backward, pays nothing for it. Measured on the H100 (PERF.md): a block a
// cloud building a packed index (counts, scan, fill in shared memory) took
// 34 us at FP4 (16 blocks); a bucket a (row, slot j) cut the fill from 17 to
// 14 us there but slowed the sum from 50 to 61; one warp a row over all its
// channels left the small levels latency-bound. The TPU kernel has no vector
// scatter, so it builds a dense (tile, N) block of W^T with three
// compare-selects and multiplies it on the MXU; here that would do N/3 times
// the work. The design
// before this one scattered with float atomics into a zero-filled result,
// whose last bits followed the atomics' order.

#include <climits>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// v in T, rounded to nearest even (exact for float).
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// The value of T nearest v, as a float.
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  return to_f32(from_f32<T>(v));
}

// N consecutive elements of T, 16-byte aligned (4 floats or 8 bfloat16 in
// one access; 4 bfloat16 in one 8-byte access), as floats and back.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  static_assert(N * sizeof(T) == 16 || N * sizeof(T) == 8, "one 8- or 16-byte access");
  if constexpr (std::is_same_v<T, float>) {
    static_assert(N == 4, "float32: 4 a 16-byte access");
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    using Word = std::conditional_t<N == 8, uint4, uint2>;
    const Word x = *reinterpret_cast<const Word*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  static_assert(N * sizeof(T) == 16 || N * sizeof(T) == 8, "one 8- or 16-byte access");
  if constexpr (std::is_same_v<T, float>) {
    static_assert(N == 4, "float32: 4 a 16-byte access");
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    using Word = std::conditional_t<N == 8, uint4, uint2>;
    Word x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<Word*>(p) = x;
  }
}

__device__ __forceinline__ float blend(float w0, float a, float w1, float b, float w2, float c) {
  float acc = __fmul_rn(w0, a);
  acc = __fadd_rn(acc, __fmul_rn(w1, b));
  return __fadd_rn(acc, __fmul_rn(w2, c));
}

// TP: the points' type, TS: the skip's, TO: the output's (the wider of the
// two). kVec: one 16-byte load of points a lane and step (16 / sizeof(TP)
// channels), the same channels stored as 16-byte stores of TO; else one
// element a lane. Grid: ceil(rows / (threads / 32)) blocks of `threads`, a
// warp a row; out rows out_stride elements apart. round_w: the weights are
// rounded to bfloat16 before the blend.
template <typename TP, typename TS, typename TO, bool kVec>
__global__ void three_interpolate_kernel(const TP* __restrict__ points,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ weight, int m,
                                         int n, int c, int rows,
                                         TO* __restrict__ out, int out_stride,
                                         const TS* __restrict__ skip,
                                         long long skip_stride_b, long long skip_stride_n,
                                         int c1, bool skip_vec, bool round_w) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: the shuffles below see all 32 lanes
  int iv = 0;
  float wv = 0.f;
  if (lane < 3) {
    iv = idx[(size_t)row * 3 + lane];
    wv = weight[(size_t)row * 3 + lane];
    if (round_w) wv = round_as<bf16>(wv);
  }
  const int i0 = __shfl_sync(0xffffffffu, iv, 0);
  const int i1 = __shfl_sync(0xffffffffu, iv, 1);
  const int i2 = __shfl_sync(0xffffffffu, iv, 2);
  const float w0 = __shfl_sync(0xffffffffu, wv, 0);
  const float w1 = __shfl_sync(0xffffffffu, wv, 1);
  const float w2 = __shfl_sync(0xffffffffu, wv, 2);
  const int bi = row / n;
  const TP* pb = points + (size_t)bi * m * c;
  const TP* p0 = pb + (size_t)i0 * c;
  const TP* p1 = pb + (size_t)i1 * c;
  const TP* p2 = pb + (size_t)i2 * c;
  TO* o = out + (size_t)row * out_stride;
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(TP);  // channels a lane and step
    constexpr int kO = 16 / sizeof(TO);  // of them, in one store of TO
    for (int ch = kE * lane; ch < c; ch += 32 * kE) {
      float a[kE], b[kE], d[kE], r[kE];
      load_vec<TP, kE>(p0 + ch, a);
      load_vec<TP, kE>(p1 + ch, b);
      load_vec<TP, kE>(p2 + ch, d);
#pragma unroll
      for (int e = 0; e < kE; ++e) r[e] = round_as<TP>(blend(w0, a[e], w1, b[e], w2, d[e]));
#pragma unroll
      for (int s = 0; s < kE; s += kO) store_vec<TO, kO>(o + ch + s, r + s);
    }
  } else {
    for (int ch = lane; ch < c; ch += 32) {
      o[ch] = from_f32<TO>(round_as<TP>(
          blend(w0, to_f32(p0[ch]), w1, to_f32(p1[ch]), w2, to_f32(p2[ch]))));
    }
  }
  if (skip != nullptr) {
    const TS* s = skip + bi * skip_stride_b + (long long)(row - bi * n) * skip_stride_n;
    TO* os = o + c;
    if constexpr (std::is_same_v<TS, TO>) {
      constexpr int kS = 16 / sizeof(TS);
      if (skip_vec) {
        for (int ch = kS * lane; ch < c1; ch += 32 * kS) {
          *reinterpret_cast<uint4*>(os + ch) = *reinterpret_cast<const uint4*>(s + ch);
        }
      } else {
        for (int ch = lane; ch < c1; ch += 32) os[ch] = s[ch];
      }
    } else {  // a bfloat16 skip in a float32 row: widened, exactly
      for (int ch = lane; ch < c1; ch += 32) os[ch] = from_f32<TO>(to_f32(s[ch]));
    }
  }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGradThreads = 256;  // the backward's blocks; the sum's: 8 warps
constexpr int kSlots = 64;         // keys a row's bucket holds: two a lane
constexpr int kChunk = 128;        // channels a warp of the sum takes: 4 a lane
constexpr int kSumUnroll = 8;      // keys a warp of the sum loads ahead of their ordered adds

// Row counters zeroed: count[0, len).
__global__ void three_interpolate_grad_zero_kernel(int* __restrict__ count, int len) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < len; i += gridDim.x * blockDim.x) count[i] = 0;
}

// Pair t = (b * n + q) * 3 + j takes a slot of its row b * m + idx[t] (an
// integer atomic: the row's count does not depend on the order) and, while
// the bucket has room, leaves its key j * n + q there. A pair naming no row
// of [0, m) is left out.
__global__ void three_interpolate_grad_fill_kernel(const int* __restrict__ idx, int m, int n,
                                                   int pairs, int* __restrict__ count,
                                                   int* __restrict__ bucket) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const int row = idx[t];
  if ((unsigned)row >= (unsigned)m) return;
  const int bq = t / 3;
  const int b = bq / n;
  const int q = bq - b * n;
  const size_t r = (size_t)b * m + row;
  const int slot = atomicAdd(count + r, 1);
  if (slot < kSlots) bucket[r * kSlots + slot] = (t - 3 * bq) * n + q;
}

// Bitonic sort across the warp, ascending (descending with kDown): lane s
// ends with the s-th key.
template <bool kDown = false>
__device__ __forceinline__ int warp_sort(int key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) {
      const int other = __shfl_xor_sync(kFull, key, d);
      const bool keep_min = (((lane & k) == 0) == ((lane & d) == 0)) != kDown;
      key = keep_min ? min(key, other) : max(key, other);
    }
  }
  return key;
}

// A bitonic sequence across the warp, sorted ascending.
__device__ __forceinline__ int warp_merge(int key, int lane) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int other = __shfl_xor_sync(kFull, key, d);
    key = (lane & d) == 0 ? min(key, other) : max(key, other);
  }
  return key;
}

// Adds w_t * g[q_t] for the keys t < len that the lanes hold (lane t: the
// weight wv and the offset gv of g's row), in lane order, into the lane's
// kChunk / 32 channels from ch0. Lanes past len hold weight 0 and offset 0:
// their rows are loaded (g's first row of the cloud) but never added.
template <typename TG, bool kVec>
__device__ __forceinline__ void add_rows(float (&acc)[kChunk / 32], const TG* gb, float wv,
                                         long long gv, int len, int ch0, int c, int lane) {
  constexpr int kPerLane = kChunk / 32;
  for (int t0 = 0; t0 < len; t0 += kSumUnroll) {
    float ws[kSumUnroll];
    float v[kSumUnroll][kPerLane];
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
      const int src = (t0 + u) & 31;
      ws[u] = __shfl_sync(kFull, wv, src);
      const TG* gr = gb + __shfl_sync(kFull, gv, src);
      if constexpr (kVec) {
        const int ch = ch0 + kPerLane * lane;
        if (ch < c) {
          load_vec<TG, kPerLane>(gr + ch, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) v[u][i] = 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int ch = ch0 + lane + 32 * i;
          v[u][i] = ch < c ? to_f32(gr[ch]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
      if (t0 + u < len) {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(ws[u], v[u][i]));
      }
    }
  }
}

// One warp a destination row r = b * m + row and a chunk of kChunk channels
// from ch0 (chunks warps a row). Up to kSlots keys: the bucket's, sorted in
// the lanes (two a lane). More: the cloud's pairs scanned in (j, q) order,
// which is the order of the sum, so nothing is sorted. TG: g's type, TD:
// dpoints'. kVec: 4 channels a lane in one access of g and one of dpoints
// (16 bytes of float32, 8 of bfloat16). round_w: the weights rounded to
// bfloat16 before their products.
template <typename TG, typename TD, bool kVec>
__global__ void three_interpolate_grad_sum_kernel(const TG* __restrict__ g, long long g_stride_b,
                                                  long long g_stride_n, const int* __restrict__ idx,
                                                  const float* __restrict__ weight,
                                                  const int* __restrict__ count_of,
                                                  const int* __restrict__ bucket, int m, int n, int c,
                                                  int rows, int chunks, TD* __restrict__ dpoints,
                                                  bool round_w) {
  constexpr int kPerLane = kChunk / 32;
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= (long long)rows * chunks) return;  // a whole warp: the shuffles below see all 32 lanes
  const int r = (int)(w / chunks);
  const int ch0 = (int)(w - (long long)r * chunks) * kChunk;
  const int b = r / m;
  const int row = r - b * m;
  const int count = count_of[r];
  const TG* gb = g + b * g_stride_b;
  const float* wb = weight + (size_t)b * n * 3;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
  if (count <= kSlots) {
    const int* keys = bucket + (size_t)r * kSlots;
    int lo = lane < count ? keys[lane] : INT_MAX;
    int hi = 32 + lane < count ? keys[32 + lane] : INT_MAX;
    if (count > 32) {  // sort both halves, the second descending, then merge the bitonic 64
      lo = warp_sort(lo, lane);
      hi = warp_sort<true>(hi, lane);
      const int a = min(lo, hi);
      hi = warp_merge(max(lo, hi), lane);
      lo = warp_merge(a, lane);
    } else {
      lo = warp_sort(lo, lane);
    }
    for (int half = 0; half < 2 && 32 * half < count; ++half) {
      const int len = min(32, count - 32 * half);
      float wv = 0.f;
      long long gv = 0;
      if (lane < len) {
        const int k = half ? hi : lo;
        const int j = k >= 2 * n ? 2 : (k >= n ? 1 : 0);
        const int q = k - j * n;
        wv = wb[q * 3 + j];
        if (round_w) wv = round_as<bf16>(wv);
        gv = q * g_stride_n;
      }
      add_rows<TG, kVec>(acc, gb, wv, gv, len, ch0, c, lane);
    }
  } else {
    const int* ib = idx + (size_t)b * n * 3;
    for (int j = 0; j < 3; ++j) {
      for (int q0 = 0; q0 < n; q0 += 32) {
        const int q = q0 + lane;
        const bool hit = q < n && ib[q * 3 + j] == row;
        const unsigned mask = __ballot_sync(kFull, hit);
        if (mask == 0u) continue;
        // The hits, in lane (query) order, gathered into the low lanes: lane t
        // takes the t-th hit.
        const int len = __popc(mask);
        float wv = hit ? wb[q * 3 + j] : 0.f;
        if (round_w) wv = round_as<bf16>(wv);
        long long gv = hit ? q * g_stride_n : 0;
        int from = 0, rank = 0;
        for (unsigned bits = mask; bits; bits &= bits - 1u, ++rank) {
          if (rank == lane) from = __ffs(bits) - 1;
        }
        wv = __shfl_sync(kFull, wv, from);
        gv = __shfl_sync(kFull, gv, from);
        if (lane >= len) {
          wv = 0.f;
          gv = 0;
        }
        add_rows<TG, kVec>(acc, gb, wv, gv, len, ch0, c, lane);
      }
    }
  }
  TD* out = dpoints + (size_t)r * c;
  if constexpr (kVec) {
    const int ch = ch0 + kPerLane * lane;
    if (ch < c) store_vec<TD, kPerLane>(out + ch, acc);
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int ch = ch0 + lane + 32 * i;
      if (ch < c) out[ch] = from_f32<TD>(acc[i]);
    }
  }
}

template <typename TP, typename TS, typename TO>
void launch_forward(const void* points, const int* idx, const float* weight, int m, int n, int c,
                    int rows, void* out, int out_stride, const void* skip, long long skip_stride_b,
                    long long skip_stride_n, int c1, bool vec, bool skip_vec, bool round_w, int blocks,
                    int threads, cudaStream_t s) {
  const TP* p = static_cast<const TP*>(points);
  TO* o = static_cast<TO*>(out);
  const TS* k = static_cast<const TS*>(skip);
  if (vec) {
    three_interpolate_kernel<TP, TS, TO, true><<<blocks, threads, 0, s>>>(
        p, idx, weight, m, n, c, rows, o, out_stride, k, skip_stride_b, skip_stride_n, c1, skip_vec,
        round_w);
  } else {
    three_interpolate_kernel<TP, TS, TO, false><<<blocks, threads, 0, s>>>(
        p, idx, weight, m, n, c, rows, o, out_stride, k, skip_stride_b, skip_stride_n, c1, false,
        round_w);
  }
}

template <typename TG, typename TD>
void launch_grad_sum(const void* g, long long g_stride_b, long long g_stride_n, const int* idx,
                     const float* weight, const int* count, const int* bucket, int m, int n, int c,
                     int rows, int chunks, void* dpoints, bool vec, bool round_w, unsigned blocks,
                     cudaStream_t s) {
  const TG* gp = static_cast<const TG*>(g);
  TD* out = static_cast<TD*>(dpoints);
  if (vec) {
    three_interpolate_grad_sum_kernel<TG, TD, true><<<blocks, kGradThreads, 0, s>>>(
        gp, g_stride_b, g_stride_n, idx, weight, count, bucket, m, n, c, rows, chunks, out, round_w);
  } else {
    three_interpolate_grad_sum_kernel<TG, TD, false><<<blocks, kGradThreads, 0, s>>>(
        gp, g_stride_b, g_stride_n, idx, weight, count, bucket, m, n, c, rows, chunks, out, round_w);
  }
}

}  // namespace

extern "C" {

// points (b, m, c), idx (b, n, 3) i32, weight (b, n, 3) f32 -> out (b, n, c + c1),
// rows out_stride = c + c1 elements apart: the blend in [0, c) and, when skip
// is not null, the skip rows (b, n, c1), their channels adjacent, batch and
// row strides in elements, in [c, c + c1). points_bf16 / skip_bf16: points /
// skip are bfloat16, else float32; out is bfloat16 when points are and the
// skip (if any) is too, else float32. round_w: the weights are rounded to
// bfloat16 before the blend. vec: 16-byte loads and stores (points and out
// 16-byte aligned, c and out_stride multiples of 16 bytes' worth of points);
// skip_vec: the skip is copied 16 bytes at a time (vec, the skip of out's
// type, aligned, its strides and c1 multiples of 16 bytes' worth). A warp a
// row, blocks of `threads`.
// Returns cudaGetLastError() after the launch.
int pn2_three_interpolate(const void* points, const int* idx, const float* weight,
                          int b, int m, int n, int c, void* out, int out_stride,
                          const void* skip, long long skip_stride_b, long long skip_stride_n,
                          int c1, int points_bf16, int skip_bf16, int round_w, int vec,
                          int skip_vec, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool out_bf16 = points_bf16 && (skip == nullptr || skip_bf16);
  if (threads < 32 || threads > 1024 || threads % 32 || (skip_vec && !vec) ||
      (skip_vec && (skip_bf16 != 0) != out_bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = b * n;
  const int per_block = threads >> 5;
  const int blocks = (rows + per_block - 1) / per_block;
  cudaStream_t s = (cudaStream_t)stream;
  const bool v = vec != 0, sv = skip_vec != 0, rw = round_w != 0;
  if (!points_bf16 && !(skip != nullptr && skip_bf16)) {
    launch_forward<float, float, float>(points, idx, weight, m, n, c, rows, out, out_stride, skip,
                                        skip_stride_b, skip_stride_n, c1, v, sv, rw, blocks, threads, s);
  } else if (!points_bf16) {
    launch_forward<float, bf16, float>(points, idx, weight, m, n, c, rows, out, out_stride, skip,
                                       skip_stride_b, skip_stride_n, c1, v, sv, rw, blocks, threads, s);
  } else if (out_bf16) {
    launch_forward<bf16, bf16, bf16>(points, idx, weight, m, n, c, rows, out, out_stride, skip,
                                     skip_stride_b, skip_stride_n, c1, v, sv, rw, blocks, threads, s);
  } else {
    launch_forward<bf16, float, float>(points, idx, weight, m, n, c, rows, out, out_stride, skip,
                                       skip_stride_b, skip_stride_n, c1, v, sv, rw, blocks, threads, s);
  }
  return (int)cudaGetLastError();
}

// g (b, n, c), idx (b, n, 3) i32, weight (b, n, 3) f32 -> dpoints (b, m, c),
// every element written; g_bf16 / d_bf16: g / dpoints are bfloat16, else
// float32. g's channels lie next to each other; its batch and row strides,
// in elements, are g_stride_b and g_stride_n (n * c and c when it is
// contiguous), so a cotangent that is a channel slice of a wider tensor is
// read where it lies. scratch holds b * m * (1 + kSlots) ints (each row's
// count and its bucket of keys). round_w: the weights are rounded to
// bfloat16 before their products. vec: 4 channels a lane in one access (g
// and dpoints aligned to it, c and the strides multiples of 4). 3 * b * n
// and b * m * c must fit in an int. Returns the first CUDA error, or 0.
int pn2_three_interpolate_grad(const void* g, long long g_stride_b, long long g_stride_n,
                               const int* idx, const float* weight,
                               int b, int m, int n, int c, void* dpoints, int* scratch,
                               int g_bf16, int d_bf16, int round_w, int vec,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = b * m;
  const int pairs = 3 * b * n;
  int* count = scratch;
  int* bucket = scratch + rows;
  const int zero_blocks = min((rows + kGradThreads - 1) / kGradThreads, 4096);
  three_interpolate_grad_zero_kernel<<<zero_blocks, kGradThreads, 0, s>>>(count, rows);
  three_interpolate_grad_fill_kernel<<<(pairs + kGradThreads - 1) / kGradThreads, kGradThreads, 0, s>>>(
      idx, m, n, pairs, count, bucket);
  const int chunks = (c + kChunk - 1) / kChunk;
  const long long warps = (long long)rows * chunks;
  const long long blocks = (warps + (kGradThreads >> 5) - 1) / (kGradThreads >> 5);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool v = vec != 0, rw = round_w != 0;
  const unsigned nb = (unsigned)blocks;
  if (!g_bf16 && !d_bf16) {
    launch_grad_sum<float, float>(g, g_stride_b, g_stride_n, idx, weight, count, bucket, m, n, c, rows,
                                  chunks, dpoints, v, rw, nb, s);
  } else if (!g_bf16) {
    launch_grad_sum<float, bf16>(g, g_stride_b, g_stride_n, idx, weight, count, bucket, m, n, c, rows,
                                 chunks, dpoints, v, rw, nb, s);
  } else if (d_bf16) {
    launch_grad_sum<bf16, bf16>(g, g_stride_b, g_stride_n, idx, weight, count, bucket, m, n, c, rows,
                                chunks, dpoints, v, rw, nb, s);
  } else {
    launch_grad_sum<bf16, float>(g, g_stride_b, g_stride_n, idx, weight, count, bucket, m, n, c, rows,
                                 chunks, dpoints, v, rw, nb, s);
  }
  return (int)cudaGetLastError();
}

const char* pn2_three_interpolate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_three_interpolate_grad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
