// The four ball-query design probes: row 2's function (the exact ball query)
// by first-k min sweeps over key rows, and row 7's function (the ball query
// over x-sorted windows) on windows cut beforehand.
//
// Replaces: tools/bq_i16_probe.py:36 `_kernel` (reached through `bq`, :69-106,
//           call :88), entry `pn2_bq_keys` (int32 keys, or int16 with i16 = 1);
//           tools/bq_fat_probe.py:53 `_kernel` (reached through `bq_fat`,
//           :97-130, call :110), entry `pn2_bq_fat` (tm = 128 or 256);
//           tools/bq_cond_probe.py:62 (row 7's `_ball_query_sliced_kernel`
//           in `make_nocond`, :22-84, and behind the `lax.cond` of
//           `make_dummycond`, :87-131) and tools/bq_sliced_decomp_probe.py:69
//           (the same kernel in `kernel_only`, :67-89), entry
//           `pn2_ball_query_precut` (with and without `fits`).
//
// Semantics, all (csrc/ballquery.cu's): a point is in the ball when its
// float32 difference-form squared distance ((dx*dx + dy*dy) + dz*dz, each
// step rounded) is strictly below r2, the float32 square of float32(radius).
// Per query the picks are the nsample smallest keys of the in-ball columns,
// ascending; unused slots repeat the first pick, or 0 for an empty ball; the
// count is min(#in-ball, nsample). The keys of `pn2_bq_keys` and
// `pn2_bq_fat` are the column indices (the first nsample in dataset order:
// row 2); those of `pn2_ball_query_precut` are the window columns' original
// indices, a column counting only where that index is below n (row 7).
//
// What bounds them on the H100: operations, about 9 a (query, column) pair
// that can hit (rows 2 and 7). The TPU kernels build each query's whole key
// row and extract the picks by nsample full-width min sweeps over it; the
// first two entries keep that formulation on purpose (it is what the probes
// measure), so they sit above row 2's bound by the sweeps.
//
// Design of `pn2_bq_keys`: one warp a query, its key row in shared memory
// (the cloud is read from device memory, where the L2 holds it). The warp
// builds the row: column j's key is j where it is in the ball, else n; then
// it makes up to nsample passes, each a full-width sweep in which every lane
// takes the min of its words and `__reduce_min_sync` gives the row's min, the
// pass's pick; the lane holding that key sets it to n. int32 keys take a word
// a column; int16 keys two columns a word (low half first), which the sweep
// folds with the packed 16-bit minima of sm_90 (`__vimin3_u16x2`, two words
// an instruction; `__vminu2` for an odd last word) and widens to 32 bits for
// the warp reduction, as the TPU kernel does for its cross-lane step. At
// N = 8192 a row is 32 KB in int32 and 16 KB in int16: 7 against 14 warps in
// a block's 227 KB. A sweep that finds n ends the row (every later sweep
// finds n too); both widths stop by that rule.
//
// Design of `pn2_bq_fat`: one block of 16 warps a tile of tm queries of one
// cloud (the TPU kernel's tile, the axis the probe varies). The cloud goes by
// in 128-column chunks, in order: the block stages the chunk's coordinates,
// builds the (tm, 128) int32 keys in shared memory (64 KB at tm = 128, 128 KB
// at 256) and adds each query's in-ball count; then each warp takes its
// queries, and each query that still needs picks extracts the chunk's hits by
// min sweeps over its 128 keys until a sweep finds n. The block stops once
// all tm queries have nsample picks: the count is capped, so the counts and
// picks are exact (row 2's early stop).
//
// Design of `pn2_ball_query_precut`: the tiles kernel of window_bq.cuh (rows
// 7 and 8) on a window that lies apart, (3, w) coordinates and (w) original
// indices a (cloud, tile): `PrecutColumns` reads them, and the header's
// x-span search and scans run on it as they are. Each tile's queries are
// split over blocks of warps (row 7's plan), every warp finds its block's
// x-span and the block stages it in shared memory as 16-byte quads when the
// window fits a block's buffer, and each warp scans a query's own span. With
// a non-null `fits`, a block that reads 0 there writes the other branch's
// zeros and returns: the device-side form of `lax.cond(fits, sliced, dummy)`,
// with no host read and no second launch.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "window_bq.cuh"

namespace {

using pn2_window::dist2;
using pn2_window::kFull;
using pn2_window::kMaxSharedWindow;
using pn2_window::kMaxSlots;

constexpr int kMaxShared = 232448;  // H100: 227 KB of dynamic shared memory a block
constexpr int kKeysMaxWarps = 16;
constexpr int kChunk = 128;  // the fat kernel's columns a chunk
constexpr int kFatWarps = 16;

// ---- pn2_bq_keys ----------------------------------------------------------

// Grid (ceil(m / warps), b), `warps` warps a block, one query a warp; dynamic
// shared memory warps * words * 4 bytes, words = n (int32) or ceil(n / 2)
// (int16, n <= 32767).
template <bool kI16>
__global__ void __launch_bounds__(kKeysMaxWarps * 32)
    bq_keys_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2, int n, int m,
                   float r2, int nsample, int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ unsigned key_rows[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = kI16 ? (n + 1) >> 1 : n;
  unsigned* row = key_rows + (size_t)warp * words;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= m) return;  // a whole warp; the block never synchronises
  const int cloud = blockIdx.y;
  const size_t at = (size_t)cloud * m + q;
  const float qx = xyz2[at * 3 + 0];
  const float qy = xyz2[at * 3 + 1];
  const float qz = xyz2[at * 3 + 2];
  const float* pts = xyz1 + (size_t)cloud * n * 3;

  // The keys: word i in lane i mod 32, so a sweep's reads share no bank.
  int count = 0;
  for (int base = 0; base < words; base += 32) {
    const int i = base + lane;
    if (kI16) {
      bool in0 = false, in1 = false;
      if (i < words) {
        const int j0 = 2 * i, j1 = 2 * i + 1;
        in0 = dist2(qx, qy, qz, pts[3 * j0], pts[3 * j0 + 1], pts[3 * j0 + 2]) < r2;
        in1 = j1 < n && dist2(qx, qy, qz, pts[3 * j1], pts[3 * j1 + 1], pts[3 * j1 + 2]) < r2;
        row[i] = (unsigned)(in0 ? j0 : n) | ((unsigned)(in1 ? j1 : n) << 16);
      }
      count += __popc(__ballot_sync(kFull, in0)) + __popc(__ballot_sync(kFull, in1));
    } else {
      bool in = false;
      if (i < words) {
        in = dist2(qx, qy, qz, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]) < r2;
        row[i] = in ? (unsigned)i : (unsigned)n;
      }
      count += __popc(__ballot_sync(kFull, in));
    }
  }
  __syncwarp();

  int* out = idx + at * nsample;
  unsigned first = 0u;
  int picks = 0;
  for (; picks < nsample; ++picks) {
    unsigned least;
    if (kI16) {
      unsigned acc = 0xffffffffu;
      int i = lane;
      for (; i + 32 < words; i += 64) acc = __vimin3_u16x2(acc, row[i], row[i + 32]);
      if (i < words) acc = __vminu2(acc, row[i]);
      least = min(acc & 0xffffu, acc >> 16);
    } else {
      least = UINT_MAX;
      for (int i = lane; i < words; i += 32) least = min(least, row[i]);
    }
    const unsigned key = __reduce_min_sync(kFull, least);
    if (key >= (unsigned)n) break;
    if (picks == 0) first = key;
    if (lane == 0) out[picks] = (int)key;
    // The key is its own column: one lane holds it.
    if (kI16) {
      const unsigned i = key >> 1;
      if (lane == (int)(i & 31u)) {
        const unsigned shift = (key & 1u) * 16u;
        row[i] = (row[i] & ~(0xffffu << shift)) | ((unsigned)n << shift);
      }
    } else if (lane == (int)(key & 31u)) {
      row[key] = (unsigned)n;
    }
    __syncwarp();
  }
  for (int s = picks + lane; s < nsample; s += 32) out[s] = (int)first;
  if (lane == 0) cnt[at] = min(count, nsample);
}

template <bool kI16>
cudaError_t launch_keys(const float* xyz1, const float* xyz2, int b, int n, int m, float r2,
                        int nsample, int warps, int* idx, int* cnt, cudaStream_t stream) {
  const size_t words = kI16 ? (size_t)(n + 1) / 2 : (size_t)n;
  const size_t smem = (size_t)warps * words * 4;
  if (b < 1 || b > 65535 || n < 1 || m < 1 || nsample < 1 || warps < 1 || warps > kKeysMaxWarps ||
      smem > (size_t)kMaxShared || (kI16 && n > 32767))
    return cudaErrorInvalidValue;
  auto* kernel = &bq_keys_kernel<kI16>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((m + warps - 1) / warps), (unsigned)b);
  kernel<<<grid, warps * 32, smem, stream>>>(xyz1, xyz2, n, m, r2, nsample, idx, cnt);
  return cudaGetLastError();
}

// ---- pn2_bq_fat -----------------------------------------------------------

// Grid (ceil(m / kTm), b), kFatWarps warps a block; dynamic shared memory
// kTm * kChunk * 4 bytes of keys.
template <int kTm>
__global__ void __launch_bounds__(kFatWarps * 32)
    bq_fat_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2, int n, int m,
                  float r2, int nsample, int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ int fat_keys[];  // (kTm, kChunk)
  __shared__ float cx[kChunk], cy[kChunk], cz[kChunk];
  __shared__ float qx[kTm], qy[kTm], qz[kTm];
  __shared__ int picks[kTm], hits[kTm], firsts[kTm];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cloud = blockIdx.y;
  const int q0 = blockIdx.x * kTm;
  const float* pts = xyz1 + (size_t)cloud * n * 3;

  for (int i = threadIdx.x; i < kTm; i += blockDim.x) {
    const int q = q0 + i;
    if (q < m) {
      const size_t at = (size_t)cloud * m + q;
      qx[i] = xyz2[at * 3 + 0];
      qy[i] = xyz2[at * 3 + 1];
      qz[i] = xyz2[at * 3 + 2];
    }
    picks[i] = q < m ? 0 : nsample;  // a row past m needs nothing
    hits[i] = 0;
    firsts[i] = 0;
  }

  // A thread builds column threadIdx.x % kChunk of every (blockDim / kChunk)-th
  // query row: a warp's 32 lanes share the row, so one ballot counts its hits.
  const int col = threadIdx.x & (kChunk - 1);
  const int row_step = blockDim.x / kChunk;
  for (int base = 0; base < n; base += kChunk) {
    __syncthreads();  // the last chunk's keys and coordinates are no longer read
    if (threadIdx.x < kChunk) {
      const int j = base + threadIdx.x;
      if (j < n) {
        cx[threadIdx.x] = pts[3 * j];
        cy[threadIdx.x] = pts[3 * j + 1];
        cz[threadIdx.x] = pts[3 * j + 2];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x / kChunk; i < kTm; i += row_step) {
      bool in = false;
      if (picks[i] < nsample && base + col < n)
        in = dist2(qx[i], qy[i], qz[i], cx[col], cy[col], cz[col]) < r2;
      fat_keys[i * kChunk + col] = in ? base + col : n;
      const unsigned ball = __ballot_sync(kFull, in);
      if (lane == 0 && ball != 0u) atomicAdd(&hits[i], __popc(ball));
    }
    __syncthreads();
    for (int i = warp; i < kTm; i += kFatWarps) {
      int got = picks[i];
      if (got >= nsample) continue;
      int* keys = fat_keys + i * kChunk;
      int* out = idx + ((size_t)cloud * m + q0 + i) * nsample;
      while (got < nsample) {
        const int least = min(min(keys[lane], keys[lane + 32]), min(keys[lane + 64], keys[lane + 96]));
        const int key = __reduce_min_sync(kFull, least);
        if (key >= n) break;
        if (lane == 0) {
          out[got] = key;
          if (got == 0) firsts[i] = key;
        }
        ++got;
        if (lane == ((key - base) & 31)) keys[key - base] = n;
        __syncwarp();
      }
      if (lane == 0) picks[i] = got;
    }
    __syncthreads();
    bool more = false;
    for (int i = threadIdx.x; i < kTm; i += blockDim.x) more |= picks[i] < nsample;
    if (!__syncthreads_or(more)) break;  // every query has nsample picks: the rest is capped
  }
  __syncthreads();
  for (int i = warp; i < kTm; i += kFatWarps) {
    const int q = q0 + i;
    if (q >= m) break;
    const size_t at = (size_t)cloud * m + q;
    for (int s = picks[i] + lane; s < nsample; s += 32) idx[at * nsample + s] = firsts[i];
    if (lane == 0) cnt[at] = min(hits[i], nsample);
  }
}

template <int kTm>
cudaError_t launch_fat(const float* xyz1, const float* xyz2, int b, int n, int m, float r2,
                       int nsample, int* idx, int* cnt, cudaStream_t stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || nsample < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)kTm * kChunk * 4;
  auto* kernel = &bq_fat_kernel<kTm>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((m + kTm - 1) / kTm), (unsigned)b);
  kernel<<<grid, kFatWarps * 32, smem, stream>>>(xyz1, xyz2, n, m, r2, nsample, idx, cnt);
  return cudaGetLastError();
}

// ---- pn2_ball_query_precut ------------------------------------------------

// One (cloud, tile)'s cut window: coordinates (3, w), a row each of x, y and
// z, and each column's original index. A column whose index is not below n
// is never in the ball (the TPU kernel's `keys_orig < n`): its y reads +inf,
// which leaves the x order, and so the x-span search, as it is.
struct PrecutColumns {
  const float* win;
  const int* orig;
  int w;
  int n;
  __device__ __forceinline__ float xat(int j) const { return win[j]; }
  __device__ __forceinline__ void get(int j, float& cx, float& cy, float& cz, int& o) const {
    o = orig[j];
    cx = win[j];
    cy = o < n ? win[w + j] : INFINITY;
    cz = win[2 * w + j];
  }
  __device__ __forceinline__ float4 quad(int j) const {
    float cx, cy, cz;
    int o;
    get(j, cx, cy, cz, o);
    return make_float4(cx, cy, cz, __int_as_float(o));
  }
};

// Grid (t * split, b), `warps` warps a block; 16 * w bytes of dynamic shared
// memory when `staged` (w <= kMaxSharedWindow), else none. win (b, t, 3, w),
// permw (b, t, w), q_tiles (b, t, tm, 3) sorted by x within each tile; fits
// null or one int; idx (b, t, tm, nsample), cnt (b, t, tm). Block (tile,
// part) takes queries [part * tm / split, (part + 1) * tm / split) of the
// tile. kSlots: nsample <= 32, the list in registers; else in the output rows.
template <bool kSlots>
__global__ void ball_query_precut_kernel(const float* __restrict__ win, const int* __restrict__ permw,
                                         const float* __restrict__ q_tiles, const int* __restrict__ fits,
                                         int t, int tm, int w, int n, int split, bool staged,
                                         float r2, int nsample, int* __restrict__ idx,
                                         int* __restrict__ cnt) {
  extern __shared__ float4 quads[];
  const int tile = blockIdx.x / split;
  const int part = blockIdx.x - tile * split;
  const size_t bt = (size_t)blockIdx.y * t + tile;
  const int per_block = tm / split;
  const size_t q0 = bt * tm + (size_t)part * per_block;
  if (fits != nullptr && *fits == 0) {  // the guard's other branch
    for (int i = threadIdx.x; i < per_block * nsample; i += blockDim.x) idx[q0 * nsample + i] = 0;
    for (int i = threadIdx.x; i < per_block; i += blockDim.x) cnt[q0 + i] = 0;
    return;
  }
  const PrecutColumns window{win + bt * 3 * w, permw + bt * w, w, n};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  const int2 span =
      pn2_window::x_span(window, 0, w, q_tiles[q0 * 3], q_tiles[(q0 + per_block - 1) * 3], r2, lane);
  const pn2_window::SharedQuads shared{quads, span.x};
  if (staged) {
    for (int j = span.x + threadIdx.x; j < span.y; j += blockDim.x) quads[j - span.x] = window.quad(j);
    __syncthreads();
  }

  for (int qi = warp; qi < per_block; qi += warps) {
    const size_t q = q0 + qi;
    const float qx = q_tiles[q * 3 + 0];
    const float qy = q_tiles[q * 3 + 1];
    const float qz = q_tiles[q * 3 + 2];
    const int2 cols = staged ? pn2_window::x_span(shared, span.x, span.y, qx, qx, r2, lane)
                             : pn2_window::x_span(window, span.x, span.y, qx, qx, r2, lane);
    int c;
    if constexpr (kSlots) {
      int key, col, count;
      if (staged) {
        pn2_window::scan_slots(shared, cols.x, cols.y, qx, qy, qz, r2, nsample, lane, key, col, count);
      } else {
        pn2_window::scan_slots(window, cols.x, cols.y, qx, qy, qz, r2, nsample, lane, key, col, count);
      }
      c = count < nsample ? count : nsample;
      const int first_key = __shfl_sync(kFull, key, 0);
      if (lane < nsample) idx[q * nsample + lane] = lane < c ? key : (c > 0 ? first_key : 0);
    } else {
      int* out = idx + q * nsample;
      const int count = staged ? pn2_window::scan_list(shared, cols.x, cols.y, qx, qy, qz, r2, nsample, lane, out)
                               : pn2_window::scan_list(window, cols.x, cols.y, qx, qy, qz, r2, nsample, lane, out);
      c = count < nsample ? count : nsample;
      const int first_key = c > 0 ? out[0] : 0;
      __syncwarp();
      for (int s = c + lane; s < nsample; s += 32) out[s] = first_key;
    }
    if (lane == 0) cnt[q] = c;
  }
}

cudaError_t launch_precut(const float* win, const int* permw, const float* q_tiles, const int* fits,
                          int b, int t, int tm, int w, int n, float r2, int nsample, int split,
                          int warps, int* idx, int* cnt, cudaStream_t stream) {
  if (b < 1 || b > 65535 || t < 1 || tm < 1 || w < 1 || n < 1 || nsample < 1 || split < 1 ||
      tm % split || warps < 1 || warps > 32 || (long long)t * split > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool staged = w <= kMaxSharedWindow;
  const size_t smem = staged ? (size_t)w * 16 : 0;
  auto* kernel = nsample <= kMaxSlots ? &ball_query_precut_kernel<true> : &ball_query_precut_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(t * split), (unsigned)b);
  kernel<<<grid, warps * 32, smem, stream>>>(win, permw, q_tiles, fits, t, tm, w, n, split, staged, r2,
                                             nsample, idx, cnt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz1 (b, n, 3), xyz2 (b, m, 3) f32 -> idx (b, m, nsample), cnt (b, m) i32:
// row 2's function by first-k sweeps over int32 keys (i16 = 0) or int16 keys
// (i16 = 1, n <= 32767). `warps` warps a block, one query a warp, each with
// a row of n (int32) or ceil(n / 2) (int16) words in shared memory (warps x
// row <= 232448 bytes). b <= 65535. Returns cudaGetLastError() after the launch.
int pn2_bq_keys(const float* xyz1, const float* xyz2, int b, int n, int m, float r2, int nsample,
                int i16, int warps, int* idx, int* cnt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = i16 ? launch_keys<true>(xyz1, xyz2, b, n, m, r2, nsample, warps, idx, cnt, (cudaStream_t)stream)
            : launch_keys<false>(xyz1, xyz2, b, n, m, r2, nsample, warps, idx, cnt, (cudaStream_t)stream);
  return (int)err;
}

// The same function, tm = 128 or 256 queries a block sharing 128-column
// chunks of keys. Same arguments as pn2_bq_keys, with tm in place of i16 and
// warps.
int pn2_bq_fat(const float* xyz1, const float* xyz2, int b, int n, int m, float r2, int nsample,
               int tm, int* idx, int* cnt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tm == 128) {
    err = launch_fat<128>(xyz1, xyz2, b, n, m, r2, nsample, idx, cnt, (cudaStream_t)stream);
  } else if (tm == 256) {
    err = launch_fat<256>(xyz1, xyz2, b, n, m, r2, nsample, idx, cnt, (cudaStream_t)stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// win (b, t, 3, w) f32 and permw (b, t, w) i32: each tile's cut window of the
// x-sorted cloud (coordinates, original indices); q_tiles (b, t, tm, 3) f32
// sorted by x; fits null, or one i32 on the device (0: every output is 0) ->
// idx (b, t, tm, nsample), cnt (b, t, tm) i32: row 7's function on the cut
// windows. `split` blocks a tile (tm % split == 0) of `warps` warps (1 to 32).
// Returns cudaGetLastError() after the launch.
int pn2_ball_query_precut(const float* win, const int* permw, const float* q_tiles, const int* fits,
                          int b, int t, int tm, int w, int n, float r2, int nsample, int split,
                          int warps, int* idx, int* cnt, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_precut(win, permw, q_tiles, fits, b, t, tm, w, n, r2, nsample, split, warps, idx,
                            cnt, (cudaStream_t)stream);
}

const char* pn2_bq_keys_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_bq_fat_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_ball_query_precut_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
