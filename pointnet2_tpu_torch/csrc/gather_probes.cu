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
// lie in [0, n) (for the window entries: every relative index in [0, 2w) and
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
// The two window entries, `pn2_gather_window_staged` (P11) and
// `pn2_gather_window_out4d` (P14), are one routine, `span_gather`. The points
// are sorted by x and each tile's picks lie in its window: the TPU programs
// land blocks kblk and min(kblk + 1, nblk - 1) of w rows (P14: wblk) in one
// (2w, c) VMEM scratch and copy each pick's row out of it by its window
// position rel. Position rel is cloud row g = rel < w ? kblk * w + rel :
// k1 * w + rel - w (k1 the clamped second block: a clamped tile's rel past w
// reads the duplicate block, as the TPU kernel and the plain versions do), so
// a tile's picks name rows of one run [g_lo, g_hi] of the cloud, its span.
// P11 computes rel = idx - kblk * w in its wrapper; P14 takes rel = pos + lo
// - kblk * wblk as the caller gives it. P14's (b, m, k, c) output is the same
// memory as P11's flat (b, t * tm * k, c) rows, so the entries differ in
// their launch count, unroll and TPU site only.
//
// What bounds them on the H100: bytes. Each output row written once, each
// tile's span read once, the relative indices read once: at `eval32` and at
// P14's probe shape (8 clouds, 8 tiles of 4096 picks, 32 channels, spans of
// about 3072 rows) 33.5 MB written and 25 MB of spans read, most of them from
// the L2 (the clouds are 8 MB): about 0.015-0.02 ms. Row 9 (`wingather.cu`),
// which reads each pick's row through the L2 with no staging, is the floor.
//
// The design, against what held the first port of these kernels (a block a
// tile staging the whole 2w window 16 bytes of every row at a time):
// - The span, not the window, split over blocks. The grid is (t * splits,
//   b): every block of a tile loads the tile's trk relative indices, turns
//   them into cloud rows in shared memory and reduces g_lo, g_hi (every block
//   of the tile gets the same values); block j stages part j of the span, a
//   run of whole rows, so the span is read once in all and no cluster is
//   needed. `plan` (ops/cuda/gather_probes.py) takes splits so that t * b *
//   splits is about two blocks an SM.
// - Whole rows by TMA bulk copies. A part is staged a chunk of chunk_rows
//   rows at a time into a ring of three chunks (kRingStages); one thread
//   issues each chunk's `cp.async.bulk` onto the chunk's mbarrier, and the
//   block copies chunk s out while chunks s + 1 and s + 2 land (the stage is
//   refilled after the barrier that ends chunk s). A bulk copy needs 16-byte
//   aligned addresses and sizes: where the rows are not 16-byte vectors (c %
//   4 != 0 or an unaligned array, the `vec` route of row 9's plan) the block
//   stages each chunk with a cooperative load instead, a run of floats, one
//   chunk at a time.
// - Whole output rows, each once. The block lists its own picks (those whose
//   row lies in its part) once, then for each chunk the picks whose row lies
//   in the chunk (a warp ballot, the lanes' prefix count, one shared atomic a
//   warp), and copies those rows out whole: row 9's lanes (kLanes lanes a
//   row, 16-byte vectors from shared memory), kUnroll rows in flight a thread
//   (P11's unroll 4, 8 or 16; P14 the probe's 4), evict-first stores in whole
//   sectors.
// - Shared memory no longer grows with w: the ring, its mbarriers, 128 bytes
//   of counts, and the tile's trk rows (4 bytes a pick) and two lists of
//   16-bit pick positions (2 + 2 bytes a pick): 16 KB x 3 + 32 KB = 80 KB at
//   trk = 4096 and 16 KB chunks, so two blocks an SM. trk <= 65536 (16-bit
//   positions) and the whole within the 232448 bytes a block can have.
// - Registers for two blocks an SM (__launch_bounds__(256, 2): at most 128).
//   ptxas -v, sm_90a: the bulk route 63 / 80 / 128 registers at unroll 4 / 8
//   / 16 (48 / 79 / 128 at one lane a row), the cooperative route 78 / 93 /
//   106 (80 / 79 / 105 at one lane); P14 63 and 78 (48 at one lane); no
//   spill. Shared memory is dynamic only: the budget above.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 1024;   // threads a block of the three row kernels
constexpr int kRowUnroll = 4;       // rows in flight a thread there
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

// ---- The window gathers: pn2_gather_window_staged, pn2_gather_window_out4d --

constexpr int kSpanThreads = 256;  // threads a block of the window gathers
constexpr int kSpanBlocksPerSm = 2;  // the plan's wave: registers for two blocks an SM
constexpr int kSpanWarps = kSpanThreads / 32;
constexpr int kRingStages = 3;     // chunks of the bulk route's ring (the cooperative route stages one)
constexpr int kSpanMisc = 128;     // bytes: the list counts and the warps' least and greatest rows
constexpr int kMaxSpanPicks = 65536;  // a tile's picks, listed as 16-bit positions
static_assert(kMaxShared < (1 << 20), "a chunk that fits shared memory fits one mbarrier phase's count");
constexpr int kOut4dUnroll = 4;    // rows in flight a thread of P14: the probe's unroll

// What a block of the window gathers reads: cloud blockIdx.y, tile blockIdx.x
// / splits, part blockIdx.x % splits of the tile's span.
struct SpanArgs {
  const float* pts;  // (b, n, c), x-sorted
  const int* rel;    // (b, t, trk): window positions in [0, 2w)
  const int* kblk;   // (b, t): each tile's first block
  int n, c, tiles, trk, w;
  int splits, chunk_rows;
  float* out;        // (b, t * trk, c)
};

// The shared memory of a block: the ring of `stages` (kRingStages on the
// bulk route, else 1) chunks of chunk_rows rows, its mbarriers, kSpanMisc bytes of counts, then the tile's trk cloud
// rows (int) and two lists of trk 16-bit pick positions (the block's own
// picks, and a chunk's).
__host__ __device__ inline size_t span_ring_bytes(int c, int chunk_rows, int stages) {
  return ((size_t)stages * chunk_rows * c * sizeof(float) + 15) / 16 * 16;
}

__host__ __device__ inline size_t span_shared_bytes(int c, int trk, int chunk_rows, int stages) {
  return span_ring_bytes(c, chunk_rows, stages) + (size_t)stages * sizeof(uint64_t) + kSpanMisc +
         (size_t)trk * (sizeof(int) + 2 * sizeof(uint16_t));
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {  // one arrival a phase: the issuing thread's
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(bar)), "r"(1) : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, int parity) {
  const uint32_t addr = shared_address(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completing on `bar`, which
// is told to expect them. One thread calls it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const uint32_t b = shared_address(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(bytes), "r"(b)
               : "memory");
}

// Appends `value` to `list` where `take`, in lane order within the warp: a
// ballot, the lanes' prefix count, one shared atomic a warp. Every lane of
// the warp calls it.
__device__ __forceinline__ void append(uint16_t* list, int* count, bool take, int value) {
  const unsigned ballot = __ballot_sync(0xffffffffu, take);
  if (!ballot) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (take) list[base + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)value;
}

// Output rows list[0 .. listed) of the tile, whole, from the chunk staged at
// `stage` (cloud rows from c_lo): kLanes lanes a row, kUnroll rows in flight
// a thread, evict-first stores.
template <typename V, int kLanes, int kUnroll>
__device__ __forceinline__ void copy_listed(const V* stage, const uint16_t* list, int listed, const int* rows,
                                            int c_lo, int cv, V* __restrict__ dst) {
  constexpr int kRowsPass = kSpanThreads / kLanes;
  const int lane = threadIdx.x % kLanes;
  for (int first = threadIdx.x / kLanes; first < listed; first += kRowsPass * kUnroll) {
    int from[kUnroll], to[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = first + u * kRowsPass;
      const int i = j < listed ? list[j] : 0;
      from[u] = (rows[i] - c_lo) * cv;
      to[u] = i * cv;
    }
#pragma unroll 1
    for (int v = lane; v < cv; v += kLanes) {  // once where the row fits its lanes
      V x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (first + u * kRowsPass < listed) x[u] = stage[from[u] + v];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (first + u * kRowsPass < listed) __stcs(dst + to[u] + v, x[u]);
      }
    }
  }
}

template <bool kBulk>
__host__ __device__ constexpr int span_stages() { return kBulk ? kRingStages : 1; }

// The window gathers' one routine. kBulk: rows of 16-byte vectors staged by
// TMA bulk copies into a ring of kRingStages chunks; else rows of floats
// staged by a cooperative load, one chunk at a time.
template <bool kBulk, int kLanes, int kUnroll>
__device__ __forceinline__ void span_gather(const SpanArgs& a) {
  using V = typename std::conditional<kBulk, float4, float>::type;
  constexpr int kStages = span_stages<kBulk>();
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t ring_bytes = span_ring_bytes(a.c, a.chunk_rows, kStages);
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes);
  int* counts = reinterpret_cast<int*>(smem + ring_bytes + kStages * sizeof(uint64_t));  // [0], [1]: chunk lists
  int* owned_count = counts + 2;
  int* warp_lo = counts + 3;
  int* warp_hi = warp_lo + kSpanWarps;
  int* rows = counts + kSpanMisc / sizeof(int);  // each pick's cloud row
  uint16_t* own = reinterpret_cast<uint16_t*>(rows + a.trk);
  uint16_t* list = own + a.trk;

  const int tile_x = blockIdx.x / a.splits;
  const int part = blockIdx.x - tile_x * a.splits;
  const int tile = blockIdx.y * a.tiles + tile_x;
  const int k0 = __ldg(a.kblk + tile);
  const int k1 = min(k0 + 1, a.n / a.w - 1);  // the TPU kernel's edge clamp
  const long long row0 = (long long)tile * a.trk;  // the tile's first output row
  const float* src = a.pts + (long long)blockIdx.y * a.n * a.c;
  const int cv = kBulk ? a.c / 4 : a.c;
  V* dst = reinterpret_cast<V*>(a.out + row0 * a.c);
  const int tid = threadIdx.x;

  if (tid == 0) {
    counts[0] = counts[1] = *owned_count = 0;
    if constexpr (kBulk) {
      for (int s = 0; s < kStages; ++s) mbarrier_init(bars + s);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // Each pick's cloud row, and the tile's least and greatest: its span.
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll 4
  for (int i = tid; i < a.trk; i += kSpanThreads) {
    const int r = __ldg(a.rel + row0 + i);
    const int g = r < a.w ? k0 * a.w + r : k1 * a.w + (r - a.w);
    rows[i] = g;
    lo = min(lo, g);
    hi = max(hi, g);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((tid & 31) == 0) {
    warp_lo[tid >> 5] = lo;
    warp_hi[tid >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int wp = 0; wp < kSpanWarps; ++wp) {
    lo = min(lo, warp_lo[wp]);
    hi = max(hi, warp_hi[wp]);
  }
  // This block's part of the span: whole rows [p_lo, p_hi), in chunks.
  const int per = (hi - lo + a.splits) / a.splits;
  const int p_lo = lo + part * per;
  const int p_hi = min(p_lo + per, hi + 1);
  if (p_lo >= p_hi) return;  // the same for every thread; nothing is in flight
  const int chunks = (p_hi - p_lo + a.chunk_rows - 1) / a.chunk_rows;
  const int chunk_floats = a.chunk_rows * a.c;
  auto issue = [&](int s) {
    const int c_lo = p_lo + s * a.chunk_rows;
    const uint32_t bytes = (uint32_t)(min(a.chunk_rows, p_hi - c_lo) * a.c * sizeof(float));
    bulk_load(ring + (s % kStages) * chunk_floats, src + (long long)c_lo * a.c, bytes, bars + s % kStages);
  };
  if constexpr (kBulk) {
    if (tid == 0) {
      for (int s = 0; s < min(kStages, chunks); ++s) issue(s);
    }
  }
  // The block's own picks: those whose row lies in its part.
  for (int i0 = 0; i0 < a.trk; i0 += kSpanThreads) {
    const int i = i0 + tid;
    const bool mine = i < a.trk && rows[i] >= p_lo && rows[i] < p_hi;
    append(own, owned_count, mine, i);
  }
  __syncthreads();
  const int owned = *owned_count;
  for (int s = 0; s < chunks; ++s) {
    const int c_lo = p_lo + s * a.chunk_rows;
    const int c_hi = min(c_lo + a.chunk_rows, p_hi);
    float* stage = ring + (s % kStages) * chunk_floats;
    int* count = counts + (s & 1);
    // The other list count was last read before the previous iteration's
    // closing barrier and is next added to after this one's.
    if (tid == 0) counts[(s + 1) & 1] = 0;
    if constexpr (!kBulk) {  // rows [c_lo, c_hi) are one run of floats of the cloud
      const float* from = src + (long long)c_lo * a.c;
      const int floats = (c_hi - c_lo) * a.c;
      for (int f = tid; f < floats; f += kSpanThreads) stage[f] = __ldg(from + f);
    }
    for (int j0 = 0; j0 < owned; j0 += kSpanThreads) {
      const int j = j0 + tid;
      int i = 0;
      bool in = false;
      if (j < owned) {
        i = own[j];
        in = rows[i] >= c_lo && rows[i] < c_hi;
      }
      append(list, count, in, i);
    }
    __syncthreads();  // the chunk's list (and, cooperatively, its rows) are in place
    const int listed = *count;
    if constexpr (kBulk) mbarrier_wait(bars + s % kStages, (s / kStages) & 1);
    copy_listed<V, kLanes, kUnroll>(reinterpret_cast<const V*>(stage), list, listed, rows, c_lo, cv, dst);
    __syncthreads();  // the stage and the list are read
    if constexpr (kBulk) {
      if (tid == 0 && s + kStages < chunks) issue(s + kStages);
    }
  }
}

// Grid (t * splits, b). P11: kUnroll rows in flight a thread (4, 8 or 16).
template <bool kBulk, int kLanes, int kUnroll>
__global__ void __launch_bounds__(kSpanThreads, kSpanBlocksPerSm) gather_window_staged_kernel(SpanArgs a) {
  span_gather<kBulk, kLanes, kUnroll>(a);
}

// Grid (t * splits, b). P14: the same routine at the probe's unroll.
template <bool kBulk, int kLanes>
__global__ void __launch_bounds__(kSpanThreads, kSpanBlocksPerSm) gather_window_out4d_kernel(SpanArgs a) {
  span_gather<kBulk, kLanes, kOut4dUnroll>(a);
}

template <bool kOut4d, bool kBulk, int kLanes, int kUnroll>
cudaError_t launch_span(const SpanArgs& a, int b, cudaStream_t stream) {
  auto* kernel = &gather_window_staged_kernel<kBulk, kLanes, kUnroll>;
  if constexpr (kOut4d) kernel = &gather_window_out4d_kernel<kBulk, kLanes>;
  const size_t smem = span_shared_bytes(a.c, a.trk, a.chunk_rows, span_stages<kBulk>());
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)(a.tiles * a.splits), (unsigned)b), kSpanThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kOut4d, bool kBulk, int kLanes>
cudaError_t launch_span_unroll(int unroll, const SpanArgs& a, int b, cudaStream_t s) {
  if constexpr (kOut4d) {
    return launch_span<true, kBulk, kLanes, kOut4dUnroll>(a, b, s);
  } else {
    switch (unroll) {
      case 4: return launch_span<false, kBulk, kLanes, 4>(a, b, s);
      case 8: return launch_span<false, kBulk, kLanes, 8>(a, b, s);
      case 16: return launch_span<false, kBulk, kLanes, 16>(a, b, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <bool kOut4d, bool kBulk>
cudaError_t launch_span_lanes(int lanes, int unroll, const SpanArgs& a, int b, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_span_unroll<kOut4d, kBulk, 1>(unroll, a, b, s);
    case 2: return launch_span_unroll<kOut4d, kBulk, 2>(unroll, a, b, s);
    case 4: return launch_span_unroll<kOut4d, kBulk, 4>(unroll, a, b, s);
    case 8: return launch_span_unroll<kOut4d, kBulk, 8>(unroll, a, b, s);
    case 16: return launch_span_unroll<kOut4d, kBulk, 16>(unroll, a, b, s);
    default: return cudaErrorInvalidValue;
  }
}

// Checks what both entries share and launches. vec: the bulk route (c % 4 ==
// 0, both arrays 16-byte aligned), else the cooperative one.
template <bool kOut4d>
cudaError_t launch_window(const SpanArgs& a, int b, int vec, int lanes, int unroll, cudaStream_t s) {
  if (b < 1 || b > kMaxGridY || a.c < 1 || a.tiles < 1 || a.trk < 1 || a.trk > kMaxSpanPicks || a.w < 1 ||
      a.n < a.w || a.n % a.w || a.splits < 1 || (long long)a.tiles * a.splits > 0x7fffffffLL ||
      a.chunk_rows < 1 || a.chunk_rows > kMaxShared ||
      span_shared_bytes(a.c, a.trk, a.chunk_rows, vec ? span_stages<true>() : span_stages<false>()) >
          (size_t)kMaxShared)
    return cudaErrorInvalidValue;
  if (vec) {
    const bool aligned = a.c % 4 == 0 && reinterpret_cast<uintptr_t>(a.pts) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
    if (!aligned) return cudaErrorInvalidValue;
    return launch_span_lanes<kOut4d, true>(lanes, unroll, a, b, s);
  }
  return launch_span_lanes<kOut4d, false>(lanes, unroll, a, b, s);
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

// pts (b, n, c) f32 sorted by x, rel (b, t, trk) i32 window positions in
// [0, 2w), kblk (b, t) i32 block indices in [0, n / w) -> out (b, t * trk, c)
// f32: out[b, tile * trk + i] = pts[b, row of window position rel[b, tile, i]],
// the window being blocks kblk and min(kblk + 1, n / w - 1) of w rows. A grid
// of (t * splits, b) blocks, each staging its part of the tile's span in
// chunks of chunk_rows rows (ops/cuda/gather_probes.py `plan`). vec: the
// bulk route (c % 4 == 0 and both arrays 16-byte aligned; a ring of three
// chunks), else the cooperative one (a chunk at a time); lanes 1-16 a row
// (ops/cuda/wingather.py `plan`); unroll 4, 8 or 16; b <= 65535; n % w ==
// 0; trk <= 65536; the shared memory of `span_shared_bytes` <= 232448. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.
int pn2_gather_window_staged(const float* pts, const int* rel, const int* kblk, int b, int n, int c,
                             int t, int trk, int w, int vec, int lanes, int unroll, int splits,
                             int chunk_rows, float* out, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SpanArgs a{pts, rel, kblk, n, c, t, trk, w, splits, chunk_rows, out};
  return (int)launch_window<false>(a, b, vec, lanes, unroll, (cudaStream_t)stream);
}

// pts (b, n, c) f32 sorted by x, rel (b, t, 1, tm * k) i32 window rows in
// [0, 2 wblk), kblk (b, t) i32 block indices in [0, n / wblk) -> out (b, t *
// tm, k, c) f32: out[b, tile * tm + q, kk] = pts[b, row of window position
// rel[b, tile, 0, q * k + kk]], the window being blocks kblk and min(kblk + 1,
// n / wblk - 1) of wblk rows. The routine of pn2_gather_window_staged with
// trk = tm * k and the probe's unroll of 4; the same arguments otherwise.
int pn2_gather_window_out4d(const float* pts, const int* rel, const int* kblk, int b, int n, int c, int t,
                            int tm, int k, int wblk, int vec, int lanes, int splits, int chunk_rows,
                            float* out, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tm < 1 || k < 1 || (long long)tm * k > kMaxSpanPicks) return (int)cudaErrorInvalidValue;
  const SpanArgs a{pts, rel, kblk, n, c, t, tm * k, wblk, splits, chunk_rows, out};
  return (int)launch_window<true>(a, b, vec, lanes, kOut4dUnroll, (cudaStream_t)stream);
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
