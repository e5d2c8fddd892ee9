// three_interpolate forward: out[q, c] = w0*p[i0, c] + w1*p[i1, c] + w2*p[i2, c].
//
// Replaces: pointnet2_tpu/ops/pallas/interpolate.py:48 `_ti_kernel`
//           (reached through `_ti_fwd`, interpolate.py:68-109, and
//           `three_interpolate_pallas`, interpolate.py:187-192).
//
// Semantics: the inverse-distance blend of three gathered feature rows per
// query, accumulated in float32 in the order j = 0, 1, 2 with a rounding
// after every product and sum (no FMA), as the plain PyTorch version does.
//
// What bounds it on the H100: bytes. Each output element costs 5 flops and 4
// bytes written, far below the card's 20 flops a byte; the (B, N, C) output
// is most of the traffic, and the (B, M, C) feature rows, read three times a
// query, stay in the 50 MB L2.
//
// Design: a gather-blend, one thread per output element, consecutive threads
// on consecutive channels, so the writes and the row reads are coalesced and
// a warp reads each query's three indices and weights at one address. The TPU
// kernel instead builds a dense (tile, M) weight block and multiplies it on
// the MXU, because Mosaic has no vector gather; on this card that would do
// M/3 times the work for nothing.
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
// What bounds it on the H100: bytes. The (B, N, C) cotangent is read once
// (67 MB at FP4, batch 16), the (B, M, C) result is an eighth to a quarter of
// that and stays in L2 while it is summed; 2 flops a product.
//
// Design: a scatter-add with float atomics. The result is zero-filled on the
// stream (part of the call), then one thread per element of g, consecutive
// threads on consecutive channels, reads its g once (through g's own batch
// and row strides: autograd hands over a channel slice of the concat's
// cotangent, which is read in place, not copied) and issues three
// `atomicAdd(float)` into the three rows its query names. A warp's 32 atomics
// go to 32 consecutive floats of one row, which the L2 takes as one
// transaction. The TPU kernel has no vector scatter, so it builds a dense
// (tile, N) block of W^T with three compare-selects and multiplies it on the
// MXU; here that would do N/3 times the work. The alternative, a counting
// sort of idx into per-row lists summed in a fixed order, is deterministic
// but needs three more passes; this one was chosen because it is one short
// kernel whose only cost is the order: the addends of an element (about
// 3*N/M of them, 12 to 24 on the train path) are summed in the order the
// atomics arrive, which changes from run to run, so the result is held to
// its plain version within a tolerance, not bit for bit. Products are
// rounded before they are added (`__fmul_rn`; an atomic cannot fuse).
// An index outside [0, M) adds nothing (the plain version raises on one).

#include <cuda_runtime.h>

namespace {

__global__ void three_interpolate_kernel(const float* __restrict__ points,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ weight, int m,
                                         int n, int c, int total,
                                         float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ch = t % c;
  const int q = t / c;  // b * n + row
  const float* p = points + (size_t)(q / n) * m * c + ch;
  const int* iq = idx + (size_t)q * 3;
  const float* wq = weight + (size_t)q * 3;
  float acc = __fmul_rn(wq[0], p[(size_t)iq[0] * c]);
  acc = __fadd_rn(acc, __fmul_rn(wq[1], p[(size_t)iq[1] * c]));
  acc = __fadd_rn(acc, __fmul_rn(wq[2], p[(size_t)iq[2] * c]));
  out[t] = acc;
}

__global__ void three_interpolate_grad_kernel(const float* __restrict__ g,
                                              long long g_stride_b,
                                              long long g_stride_n,
                                              const int* __restrict__ idx,
                                              const float* __restrict__ weight,
                                              int m, int n, int c, int total,
                                              float* __restrict__ dpoints) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ch = t % c;
  const int q = t / c;  // b * n + row
  const int bi = q / n;
  float* d = dpoints + (size_t)bi * m * c + ch;
  const int* iq = idx + (size_t)q * 3;
  const float* wq = weight + (size_t)q * 3;
  const float gv = g[bi * g_stride_b + (q - bi * n) * g_stride_n + ch];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int row = iq[j];
    if ((unsigned)row < (unsigned)m) atomicAdd(d + (size_t)row * c, __fmul_rn(wq[j], gv));
  }
}

}  // namespace

extern "C" {

// points (b, m, c), idx (b, n, 3) i32, weight (b, n, 3) f32 -> out (b, n, c) f32.
// b * n * c must fit in an int. Returns cudaGetLastError() after the launch.
int pn2_three_interpolate(const float* points, const int* idx, const float* weight,
                          int b, int m, int n, int c, float* out, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int total = b * n * c;
  const int blocks = (int)(((long long)total + threads - 1) / threads);
  three_interpolate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      points, idx, weight, m, n, c, total, out);
  return (int)cudaGetLastError();
}

// g (b, n, c) f32, idx (b, n, 3) i32, weight (b, n, 3) f32 -> dpoints (b, m, c) f32,
// which is zero-filled here, on the same stream, before the atomics.
// g's channels lie next to each other; its batch and row strides, in
// elements, are g_stride_b and g_stride_n (n * c and c when it is contiguous),
// so a cotangent that is a channel slice of a wider tensor is read where it
// lies. b * n * c must fit in an int. Returns the first CUDA error, or 0.
int pn2_three_interpolate_grad(const float* g, long long g_stride_b, long long g_stride_n,
                               const int* idx, const float* weight,
                               int b, int m, int n, int c, float* dpoints, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(dpoints, 0, (size_t)b * m * c * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int total = b * n * c;
  const int blocks = (int)(((long long)total + threads - 1) / threads);
  three_interpolate_grad_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, g_stride_b, g_stride_n, idx, weight, m, n, c, total, dpoints);
  return (int)cudaGetLastError();
}

const char* pn2_three_interpolate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_three_interpolate_grad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
