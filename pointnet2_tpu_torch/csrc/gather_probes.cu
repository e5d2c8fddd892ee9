// The four gather design probes: the SA grouping gather, out[b, r, :] =
// points[b, idx[b, r], :], with the indices reaching the row copies four ways.
//
// Replaces: tools/gather_probe.py:40 (`_gather_kernel`, :24, reached through
//           `gather_pallas`, :35), entry `pn2_gather_rows`: the indices read
//           from memory, row by row;
//           tools/sp_gather_probe.py:75 (`_sp_row_kernel`, :50, through
//           `sp_row_gather`, :63), entry `pn2_gather_rows_staged`: a tile's
//           indices staged on chip before its row copies;
//           tools/sp_gather_probe.py:137 (`_sp_win_kernel`, :84, through
//           `sp_win_gather`, :101), entry `pn2_gather_window_staged`: a
//           tile's window of rows staged on chip, rows copied by relative
//           index;
//           tools/fused_gather_probe.py:46 (`_vmem_idx_gather_kernel`, :27,
//           through `vmem_idx_gather`, :41), entry `pn2_gather_fused_idx`: the
//           indices written on chip, emitted, and read back for the copies;
//           tools/wingather_out4d_probe.py:186 (`_window_gather_kernel_4d`,
//           :53, in `project_group_sliced_4d`, :72), entry
//           `pn2_gather_window_out4d`: row 9's window gather with the two
//           window blocks staged, writing (b, m, k, c) by (query, pick).
//
// Semantics, all four: a row copy with no arithmetic, so the output equals
// `take_along_axis` (the port's `group_points`) bit for bit. Every index must
// lie in [0, n) (for the window entry: every relative index in [0, 2w) and
// every block index in [0, n / w)); the kernels do not check it.
//
// What bounds them on the H100: bytes. Each output row is written once, each
// distinct source row the indices name is read once, the indices once (and
// written once more by the fused entry): at the gather probe's shape (64
// clouds of 8192 x 64 floats, 32768 indices a cloud) 537 MB written and about
// 140 MB read, 0.20 ms at 3.35 TB/s.
//
// What the TPU kernels do, and what differs here. Each TPU program holds the
// whole cloud, (1, n, c), as one VMEM block and copies one row a loop step
// from it. A cloud of 8192 x 64 floats is 2 MB, beyond the 227 KB of shared
// memory a block can have, so the first, second and fourth entries read their
// rows from device memory through the L2 (which holds the cloud), as row 9
// (`wingather.cu`, `pn2_window_gather`) does; what the probes vary is how the
// indices reach the copies, and that is what the entries keep:
// - `pn2_gather_rows`: one block a (cloud, tile of tr rows), the TPU grid;
//   each row's lanes read its index straight from device memory (`__ldg`);
// - `pn2_gather_rows_staged`: the block first copies its tile's tr indices
//   into shared memory (a cooperative load and `__syncthreads()`, the card's
//   analogue of scalar prefetch into SMEM), then copies the rows as above,
//   each index read from shared memory;
// - `pn2_gather_fused_idx`: the block's threads write the tile's indices into
//   shared memory (standing for indices a fused ball query computes on chip),
//   `__syncthreads()`, write them out as the second output from that copy,
//   and copy the rows by the indices read back from it. On the TPU this did
//   not legalize (a scalar read of a VMEM value); the card has no such limit.
// The row copy of all three: a row's 16-byte vectors (float4 where c is a
// multiple of 4 and both arrays are 16-byte aligned, else single floats) go
// to kLanes consecutive lanes (the smallest power of two covering them, at
// most 16; wider rows loop), each thread holding kRowUnroll rows whose loads
// it issues before any store; stores are coalesced and evict-first, as row
// 9's. 1024 threads a block, so that the few blocks of the staged shapes (64
// at 8 clouds of 32768 rows) still keep megabytes in flight.
//
// `pn2_gather_window_staged<kVec, kUnroll>`: the points are sorted by x and
// each tile of tm queries has its tm * k indices inside [kblk * w, kblk * w
// + 2w). The TPU program lands the two w-row blocks kblk and min(kblk + 1,
// nblk - 1) in one (2w, c) VMEM scratch and copies the tile's rows out of it
// by the relative index rel = idx - kblk * w. Two blocks of 4096 rows are
// 256 KB at c = 8 and 1 MB at c = 32, past a block's shared memory at every
// width the probe runs. So the window is staged in channel slices of 16
// bytes: the block first stages the tile's tm * k relative indices in shared
// memory, then for each slice of 4 channels it stages the (2w) rows' slice
// (2w x 16 bytes: 128 KB at w = 4096), synchronises, and copies each output
// row's slice from shared memory by its relative index; the next slice
// overwrites the window after a barrier. The two blocks are staged as the
// TPU kernel stages them, the second clamped at the cloud's last block (a
// duplicate there that no relative index reads). The window is read once a
// slice, from the L2, and the output is written a 16-byte slice of a row at a
// time (whole 32-byte sectors only where c = 4 or 8). kUnroll (4, 8 or 16) is
// the rows in flight a thread, the card's counterpart of the loop unroll the
// probe sweeps. PERF.md section 6 has their times beside their bounds and
// row 9's: on one H100 at 700 W no staging beat row 9.
//
// `pn2_gather_window_out4d<kVec>`: the TPU program stages the same two
// blocks (wblk rows each, the second clamped) and writes each pick as a
// (1, 1, c) slab at out[0, r / k, r % k, :], its window row rel read from
// SMEM with an unroll of 4; the caller computes rel = pos + (lo - kblk *
// wblk) from the ball query's window columns. The card's layout of (b, m, k,
// c) is the flat (b, t, tm * k, c) one, so what differs from
// `pn2_gather_window_staged` is the addressing: rel comes in as it is, and
// the block's warps take one query each (query q of the tile, warp q mod 8),
// their lanes the query's picks (looping where k > 32; lanes past k idle
// where k < 32), each warp holding 4 queries in flight (the probe's unroll)
// and writing its query's (k, 16 bytes) slab a slice: the card's form of the
// TPU kernel's (1, 1, c) slab a pick. At the probe's shape (n = 8192, a
// 3072-column window) wblk = 4096, and the two blocks are the whole cloud,
// 1 MB at c = 32: the window is staged a 16-byte channel slice at a time, as
// above (128 KB a slice, 16 KB of relative indices).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 1024;   // threads a block of the three row kernels
constexpr int kRowUnroll = 4;       // rows in flight a thread there
constexpr int kWinThreads = 256;    // threads a block of the window kernel
constexpr int kMaxShared = 232448;  // H100: 227 KB of dynamic shared memory a block
constexpr int kMaxGridY = 65535;

struct GlobalIndex {  // the index of row r read from device memory
  const int* p;
  __device__ __forceinline__ int operator()(int r) const { return __ldg(p + r); }
};

struct SharedIndex {  // the index of row r read from shared memory
  const int* p;
  __device__ __forceinline__ int operator()(int r) const { return p[r]; }
};

// dst[r, :] = src[at(r), :] for r < rows, rows of cv vectors, kLanes lanes a row.
template <typename V, int kLanes, typename Index>
__device__ __forceinline__ void copy_rows(const V* __restrict__ src, Index at, int rows, int cv,
                                          V* __restrict__ dst) {
  constexpr int kRowsPass = kRowThreads / kLanes;
  const int lane = threadIdx.x % kLanes;
  for (int first = threadIdx.x / kLanes; first < rows; first += kRowsPass * kRowUnroll) {
    int off[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int r = first + u * kRowsPass;
      off[u] = r < rows ? at(r) * cv : 0;
    }
#pragma unroll 1
    for (int c = lane; c < cv; c += kLanes) {  // once where the row fits its lanes
      V v[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (first + u * kRowsPass < rows) v[u] = __ldg(src + off[u] + c);
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int r = first + u * kRowsPass;
        if (r < rows) __stcs(dst + r * cv + c, v[u]);
      }
    }
  }
}

// Grid (r / tr, b): block (tile, cloud) copies rows [tile * tr, tile * tr + tr).
template <typename V, int kLanes>
__global__ void __launch_bounds__(kRowThreads)
    gather_rows_kernel(const V* __restrict__ pts, const int* __restrict__ idx, int n, int r, int tr,
                       int cv, V* __restrict__ out) {
  const long long first = (long long)blockIdx.y * r + (long long)blockIdx.x * tr;
  copy_rows<V, kLanes>(pts + (long long)blockIdx.y * n * cv, GlobalIndex{idx + first}, tr, cv,
                       out + first * cv);
}

// As gather_rows_kernel, the tile's indices staged first (tr ints of dynamic shared memory).
template <typename V, int kLanes>
__global__ void __launch_bounds__(kRowThreads)
    gather_rows_staged_kernel(const V* __restrict__ pts, const int* __restrict__ idx, int n, int r,
                              int tr, int cv, V* __restrict__ out) {
  extern __shared__ int tile_idx[];
  const long long first = (long long)blockIdx.y * r + (long long)blockIdx.x * tr;
  for (int i = threadIdx.x; i < tr; i += kRowThreads) tile_idx[i] = __ldg(idx + first + i);
  __syncthreads();
  copy_rows<V, kLanes>(pts + (long long)blockIdx.y * n * cv, SharedIndex{tile_idx}, tr, cv,
                       out + first * cv);
}

// As gather_rows_staged_kernel, the indices also written out, (b, 1, r), from
// the on-chip copy before the rows are copied by it.
template <typename V, int kLanes>
__global__ void __launch_bounds__(kRowThreads)
    gather_fused_idx_kernel(const V* __restrict__ pts, const int* __restrict__ idx, int n, int r,
                            int tr, int cv, V* __restrict__ out, int* __restrict__ idx_out) {
  extern __shared__ int tile_idx[];
  const long long first = (long long)blockIdx.y * r + (long long)blockIdx.x * tr;
  for (int i = threadIdx.x; i < tr; i += kRowThreads) tile_idx[i] = __ldg(idx + first + i);
  __syncthreads();
  for (int i = threadIdx.x; i < tr; i += kRowThreads) idx_out[first + i] = tile_idx[i];
  copy_rows<V, kLanes>(pts + (long long)blockIdx.y * n * cv, SharedIndex{tile_idx}, tr, cv,
                       out + first * cv);
}

enum class Arrival { kGlobal, kStaged, kFused };

// Lets `kernel` take `smem` bytes of dynamic shared memory (past 48 KB it must ask).
template <typename Kernel>
cudaError_t allow_shared(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <Arrival kArrival, typename V, int kLanes>
cudaError_t launch_rows(const float* pts, const int* idx, int b, int n, int r, int tr, int cv,
                        float* out, int* idx_out, cudaStream_t stream) {
  const dim3 grid((unsigned)(r / tr), (unsigned)b);
  const size_t smem = kArrival == Arrival::kGlobal ? 0 : (size_t)tr * sizeof(int);
  const V* p = reinterpret_cast<const V*>(pts);
  V* o = reinterpret_cast<V*>(out);
  if constexpr (kArrival == Arrival::kGlobal) {
    gather_rows_kernel<V, kLanes><<<grid, kRowThreads, 0, stream>>>(p, idx, n, r, tr, cv, o);
  } else if constexpr (kArrival == Arrival::kStaged) {
    auto* kernel = &gather_rows_staged_kernel<V, kLanes>;
    const cudaError_t err = allow_shared(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kRowThreads, smem, stream>>>(p, idx, n, r, tr, cv, o);
  } else {
    auto* kernel = &gather_fused_idx_kernel<V, kLanes>;
    const cudaError_t err = allow_shared(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kRowThreads, smem, stream>>>(p, idx, n, r, tr, cv, o, idx_out);
  }
  return cudaGetLastError();
}

template <Arrival kArrival, typename V>
cudaError_t launch_lanes(int lanes, const float* pts, const int* idx, int b, int n, int r, int tr,
                         int cv, float* out, int* idx_out, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_rows<kArrival, V, 1>(pts, idx, b, n, r, tr, cv, out, idx_out, s);
    case 2: return launch_rows<kArrival, V, 2>(pts, idx, b, n, r, tr, cv, out, idx_out, s);
    case 4: return launch_rows<kArrival, V, 4>(pts, idx, b, n, r, tr, cv, out, idx_out, s);
    case 8: return launch_rows<kArrival, V, 8>(pts, idx, b, n, r, tr, cv, out, idx_out, s);
    case 16: return launch_rows<kArrival, V, 16>(pts, idx, b, n, r, tr, cv, out, idx_out, s);
    default: return cudaErrorInvalidValue;
  }
}

template <Arrival kArrival>
cudaError_t launch_route(const float* pts, const int* idx, int b, int n, int r, int tr, int c, int vec,
                         int lanes, float* out, int* idx_out, cudaStream_t s) {
  if (b < 1 || b > kMaxGridY || n < 1 || c < 1 || tr < 1 || r % tr ||
      (kArrival != Arrival::kGlobal && (size_t)tr * sizeof(int) > (size_t)kMaxShared))
    return cudaErrorInvalidValue;
  if (r == 0) return cudaSuccess;
  if (vec) {
    const bool aligned = c % 4 == 0 && reinterpret_cast<uintptr_t>(pts) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!aligned) return cudaErrorInvalidValue;
    return launch_lanes<kArrival, float4>(lanes, pts, idx, b, n, r, tr, c / 4, out, idx_out, s);
  }
  return launch_lanes<kArrival, float>(lanes, pts, idx, b, n, r, tr, c, out, idx_out, s);
}

// ---- pn2_gather_window_staged ---------------------------------------------

// Slice s (channels 4s .. 4s + 3) of a row of c floats; channels past c read 0.
template <bool kVec>
__device__ __forceinline__ float4 load_slice(const float* __restrict__ row, int s, int c) {
  if constexpr (kVec) return __ldg(reinterpret_cast<const float4*>(row) + s);
  const int ch = 4 * s;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = __ldg(row + ch);
  if (ch + 1 < c) v.y = __ldg(row + ch + 1);
  if (ch + 2 < c) v.z = __ldg(row + ch + 2);
  if (ch + 3 < c) v.w = __ldg(row + ch + 3);
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store_slice(float* __restrict__ row, int s, int c, float4 v) {
  if constexpr (kVec) {
    __stcs(reinterpret_cast<float4*>(row) + s, v);
  } else {
    const int ch = 4 * s;
    __stcs(row + ch, v.x);
    if (ch + 1 < c) __stcs(row + ch + 1, v.y);
    if (ch + 2 < c) __stcs(row + ch + 2, v.z);
    if (ch + 3 < c) __stcs(row + ch + 3, v.w);
  }
}

// Slice s of the window's 2w rows into `window`: rows [k0 * w, k0 * w + w)
// of the cloud `src`, then rows [k1 * w, k1 * w + w); kUnroll rows in flight
// a thread. Every thread of a block of kWinThreads calls it.
template <bool kVec, int kUnroll>
__device__ __forceinline__ void stage_window_slice(const float* __restrict__ src, int k0, int k1, int w,
                                                   int c, int s, float4* __restrict__ window) {
  for (int j0 = threadIdx.x; j0 < 2 * w; j0 += kWinThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWinThreads;
      if (j < 2 * w) v[u] = load_slice<kVec>(src + (j < w ? k0 * w + j : k1 * w + j - w) * c, s, c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWinThreads;
      if (j < 2 * w) window[j] = v[u];
    }
  }
}

// Grid (t, b): block (tile, cloud) writes the tile's trk = tm * k output rows.
// Dynamic shared memory: the window slice, 2w float4, then the trk relative indices.
template <bool kVec, int kUnroll>
__global__ void __launch_bounds__(kWinThreads)
    gather_window_staged_kernel(const float* __restrict__ pts, const int* __restrict__ rel,
                                const int* __restrict__ kblk, int n, int c, int tiles, int trk, int w,
                                float* __restrict__ out) {
  extern __shared__ float4 window[];
  int* rel_s = reinterpret_cast<int*>(window + 2 * w);
  const int tile = blockIdx.y * tiles + blockIdx.x;
  const int k0 = __ldg(kblk + tile);
  const int k1 = min(k0 + 1, n / w - 1);  // the TPU kernel's edge clamp
  const float* src = pts + (long long)blockIdx.y * n * c;
  const long long row0 = (long long)tile * trk;  // the tile's first output row
  float* dst = out + row0 * c;
  for (int i = threadIdx.x; i < trk; i += kWinThreads) rel_s[i] = __ldg(rel + row0 + i);
  const int slices = (c + 3) / 4;
  for (int s = 0; s < slices; ++s) {
    __syncthreads();  // the relative indices are in place; the last slice's reads are done
    stage_window_slice<kVec, kUnroll>(src, k0, k1, w, c, s, window);
    __syncthreads();
    for (int r0 = threadIdx.x; r0 < trk; r0 += kWinThreads * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kWinThreads;
        if (r < trk) v[u] = window[rel_s[r]];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kWinThreads;
        if (r < trk) store_slice<kVec>(dst + r * c, s, c, v[u]);
      }
    }
  }
}

template <bool kVec, int kUnroll>
cudaError_t launch_window(const float* pts, const int* rel, const int* kblk, int b, int n, int c,
                          int tiles, int trk, int w, float* out, size_t smem, cudaStream_t stream) {
  auto* kernel = &gather_window_staged_kernel<kVec, kUnroll>;
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)tiles, (unsigned)b), kWinThreads, smem, stream>>>(pts, rel, kblk, n, c, tiles,
                                                                            trk, w, out);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_unroll(int unroll, const float* pts, const int* rel, const int* kblk, int b, int n,
                          int c, int tiles, int trk, int w, float* out, size_t smem, cudaStream_t s) {
  switch (unroll) {
    case 4: return launch_window<kVec, 4>(pts, rel, kblk, b, n, c, tiles, trk, w, out, smem, s);
    case 8: return launch_window<kVec, 8>(pts, rel, kblk, b, n, c, tiles, trk, w, out, smem, s);
    case 16: return launch_window<kVec, 16>(pts, rel, kblk, b, n, c, tiles, trk, w, out, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- pn2_gather_window_out4d ---------------------------------------------

constexpr int kOut4dUnroll = 4;  // queries in flight a warp: the probe's unroll

// Grid (t, b): block (tile, cloud) writes the tile's tm queries' (k, c) slabs.
// Dynamic shared memory: the window slice, 2 wblk float4, then the tile's
// tm * k relative indices. Warp w takes queries w, w + 8, ...; lane l of a
// query's warp its picks l, l + 32, ...
template <bool kVec>
__global__ void __launch_bounds__(kWinThreads)
    gather_window_out4d_kernel(const float* __restrict__ pts, const int* __restrict__ rel,
                               const int* __restrict__ kblk, int n, int c, int tiles, int tm, int k,
                               int wblk, float* __restrict__ out) {
  constexpr int kWarps = kWinThreads / 32;
  extern __shared__ float4 window[];
  const int trk = tm * k;
  int* rel_s = reinterpret_cast<int*>(window + 2 * wblk);
  const int tile = blockIdx.y * tiles + blockIdx.x;
  const int k0 = __ldg(kblk + tile);
  const int k1 = min(k0 + 1, n / wblk - 1);  // the TPU kernel's edge clamp (map1, :165-166)
  const float* src = pts + (long long)blockIdx.y * n * c;
  const long long q_first = (long long)tile * tm;  // the tile's first query of (b, m)
  float* dst = out + q_first * k * c;
  for (int i = threadIdx.x; i < trk; i += kWinThreads) rel_s[i] = __ldg(rel + q_first * k + i);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slices = (c + 3) / 4;
  for (int s = 0; s < slices; ++s) {
    __syncthreads();  // the relative indices are in place; the last slice's reads are done
    stage_window_slice<kVec, kOut4dUnroll>(src, k0, k1, wblk, c, s, window);
    __syncthreads();
    for (int q0 = warp; q0 < tm; q0 += kWarps * kOut4dUnroll) {
      for (int kk = lane; kk < k; kk += 32) {
        float4 v[kOut4dUnroll];
#pragma unroll
        for (int u = 0; u < kOut4dUnroll; ++u) {
          const int q = q0 + u * kWarps;
          if (q < tm) v[u] = window[rel_s[q * k + kk]];
        }
#pragma unroll
        for (int u = 0; u < kOut4dUnroll; ++u) {
          const int q = q0 + u * kWarps;
          if (q < tm) store_slice<kVec>(dst + ((long long)q * k + kk) * c, s, c, v[u]);
        }
      }
    }
  }
}

template <bool kVec>
cudaError_t launch_out4d(const float* pts, const int* rel, const int* kblk, int b, int n, int c, int t,
                         int tm, int k, int wblk, float* out, size_t smem, cudaStream_t stream) {
  auto* kernel = &gather_window_out4d_kernel<kVec>;
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)t, (unsigned)b), kWinThreads, smem, stream>>>(pts, rel, kblk, n, c, t, tm, k, wblk,
                                                                        out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pts (b, n, c) f32, idx (b, r) i32 -> out (b, r, c) f32: out[b, i] =
// pts[b, idx[b, i]], one block a (cloud, tile of tr rows), each index read
// from device memory. (vec, lanes): 16-byte vectors (c % 4 == 0, both arrays
// 16-byte aligned) or floats, 1-16 lanes a row (ops/cuda/wingather.py `plan`).
// b <= 65535, r % tr == 0. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int pn2_gather_rows(const float* pts, const int* idx, int b, int n, int r, int tr, int c, int vec,
                    int lanes, float* out, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_route<Arrival::kGlobal>(pts, idx, b, n, r, tr, c, vec, lanes, out, nullptr,
                                             (cudaStream_t)stream);
}

// The same function, each tile's tr indices staged in shared memory first.
// Same arguments as pn2_gather_rows (tr * 4 bytes <= 232448).
int pn2_gather_rows_staged(const float* pts, const int* idx, int b, int n, int r, int tr, int c,
                           int vec, int lanes, float* out, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_route<Arrival::kStaged>(pts, idx, b, n, r, tr, c, vec, lanes, out, nullptr,
                                             (cudaStream_t)stream);
}

// The same function, the indices also written to idx_out (b, 1, r) i32 from
// the tile's on-chip copy, which the row copies then read. Same arguments as
// pn2_gather_rows_staged, plus idx_out.
int pn2_gather_fused_idx(const float* pts, const int* idx, int b, int n, int r, int tr, int c, int vec,
                         int lanes, float* out, int* idx_out, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_route<Arrival::kFused>(pts, idx, b, n, r, tr, c, vec, lanes, out, idx_out,
                                            (cudaStream_t)stream);
}

// pts (b, n, c) f32 sorted by x, rel (b, t, trk) i32 relative indices in
// [0, 2w), kblk (b, t) i32 block indices in [0, n / w) -> out (b, t * trk, c)
// f32: out[b, tile * trk + i] = pts[b, row of window position rel[b, tile, i]],
// the window being blocks kblk and min(kblk + 1, n / w - 1) of w rows. vec: c %
// 4 == 0 and both arrays 16-byte aligned; unroll 4, 8 or 16; b <= 65535;
// n % w == 0; 2w * 16 + trk * 4 <= 232448 bytes. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.
int pn2_gather_window_staged(const float* pts, const int* rel, const int* kblk, int b, int n, int c,
                             int t, int trk, int w, int vec, int unroll, float* out, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)2 * w * sizeof(float4) + (size_t)trk * sizeof(int);
  if (b < 1 || b > kMaxGridY || c < 1 || t < 1 || trk < 1 || w < 1 || n < w || n % w ||
      smem > (size_t)kMaxShared)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    const bool aligned = c % 4 == 0 && reinterpret_cast<uintptr_t>(pts) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!aligned) return (int)cudaErrorInvalidValue;
    return (int)launch_unroll<true>(unroll, pts, rel, kblk, b, n, c, t, trk, w, out, smem, s);
  }
  return (int)launch_unroll<false>(unroll, pts, rel, kblk, b, n, c, t, trk, w, out, smem, s);
}

// pts (b, n, c) f32 sorted by x, rel (b, t, 1, tm * k) i32 window rows in
// [0, 2 wblk), kblk (b, t) i32 block indices in [0, n / wblk) -> out (b, t *
// tm, k, c) f32: out[b, tile * tm + q, kk] = pts[b, row of window position
// rel[b, tile, 0, q * k + kk]], the window being blocks kblk and min(kblk + 1,
// n / wblk - 1) of wblk rows. vec: c % 4 == 0 and both arrays 16-byte
// aligned; b <= 65535; n % wblk == 0; 2 wblk * 16 + tm * k * 4 <= 232448
// bytes. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.
int pn2_gather_window_out4d(const float* pts, const int* rel, const int* kblk, int b, int n, int c, int t,
                            int tm, int k, int wblk, int vec, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)2 * wblk * sizeof(float4) + (size_t)tm * k * sizeof(int);
  if (b < 1 || b > kMaxGridY || c < 1 || t < 1 || tm < 1 || k < 1 || wblk < 1 || n < wblk || n % wblk ||
      smem > (size_t)kMaxShared)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    const bool aligned = c % 4 == 0 && reinterpret_cast<uintptr_t>(pts) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!aligned) return (int)cudaErrorInvalidValue;
    return (int)launch_out4d<true>(pts, rel, kblk, b, n, c, t, tm, k, wblk, out, smem, s);
  }
  return (int)launch_out4d<false>(pts, rel, kblk, b, n, c, t, tm, k, wblk, out, smem, s);
}

const char* pn2_gather_rows_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_gather_rows_staged_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_gather_fused_idx_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_gather_window_staged_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_gather_window_out4d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
