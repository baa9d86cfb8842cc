// The Mosaic bias-broadcast probe on Hopper.
//
// Replaces the Pallas kernel of scripts/probe_mosaic_bias_fault.py::main: a
// loop of `trips` steps over acc [P, Q] (from 0.1) of
//   h = [acc, 1 - acc] @ w[p, :2, :] + b[p]      (case "bias": a batched
//                                                 [Q, 2] x [2, M] product and
//                                                 the [1, M] bias broadcast
//                                                 that faulted Mosaic)
//   h = [acc, 1 - acc, 1] @ [w[p, :2, :]; b[p]]  (case "fold": the bias as a
//                                                 third weight row)
//   acc = tanh(h[:, 0] + 1e-3 acc)
// and out [P, 128] = acc in the first Q columns, zeros after.  The wrapper
// and the plain PyTorch version are in ionflux_torch/ops/bias_probe.py.
//
// Design: one thread block per member p and one thread per (row, column) of
// the [Q, M] product, so every trip computes the whole product and its bias
// broadcast, not only the column that feeds acc; the product goes through
// shared memory, where the row's column-0 thread reads it back for the tanh
// update.  What bounds it on this card: neither bytes nor operations (6.3
// MFLOP and 48 KB at the probe's P = 64, Q = 16, M = 16) but the 64
// dependent trips of two block barriers each, and the launch.
// Sums use round-to-nearest intrinsics (no FMA contraction), in the order
// of the plain version's product.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kOutCols = 128;

__global__ void bias_probe_kernel(const float* w, const float* b, float* out,
                                  int q, int m, int trips, int fold) {
  extern __shared__ float smem[];
  float* acc = smem;      // [Q]
  float* h = smem + q;    // [Q, M]
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = tid / m, col = tid % m;
  const float* wp = w + (size_t)p * 3 * m;
  // this thread's column of the weights: rows 0 and 1 of w[p], then b[p]
  const float wb[3] = {wp[col], wp[m + col], b[(size_t)p * m + col]};
  if (tid < q) acc[tid] = 0.1f;
  __syncthreads();
  for (int i = 0; i < trips; ++i) {
    const float a = acc[row];
    const float x[3] = {a, __fsub_rn(1.f, a), 1.f};
    float hv;
    if (fold) {
      hv = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) hv = __fadd_rn(hv, __fmul_rn(x[k], wb[k]));
    } else {
      hv = __fadd_rn(__fmul_rn(x[0], wb[0]), __fmul_rn(x[1], wb[1]));
      hv = __fadd_rn(hv, wb[2]);
    }
    h[tid] = hv;
    __syncthreads();
    if (col == 0) acc[row] = tanhf(__fadd_rn(h[tid], __fmul_rn(1e-3f, a)));
    __syncthreads();
  }
  for (int c = tid; c < kOutCols; c += blockDim.x)
    out[(size_t)p * kOutCols + c] = c < q ? acc[c] : 0.f;
}

}  // namespace

extern "C" int ionflux_bias_probe(const float* w, const float* b, float* out,
                                  int p, int q, int m, int trips, int fold,
                                  void* stream) {
  if (p < 1 || q < 1 || m < 1 || q > kOutCols || q * m > 1024 || trips < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)q * (m + 1);
  bias_probe_kernel<<<p, q * m, smem, static_cast<cudaStream_t>(stream)>>>(
      w, b, out, q, m, trips, fold);
  return (int)cudaGetLastError();
}

extern "C" const char* ionflux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
