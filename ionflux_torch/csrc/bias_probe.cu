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
// Design: the function is P x Q independent row recurrences.  Row (p, r)
// reads only its own acc and column 0 of member p's weights and bias, so one
// thread runs one row's whole chain: its acc lives in a register, its three
// column-0 weights are loaded once, and the 64 trips run with no block
// barrier, no shared memory and nothing exchanged between lanes (no
// shuffle is needed either).  A warp holds 32 / Q members' rows (two at the
// probe's Q = 16), one warp per block, all P x Q rows in one launch.  The
// other M - 1 columns of the product feed nothing the probe returns; the
// JAX body forms them only because the broadcast is what it probes, and
// this kernel does not form them.  Each row's column 0 is computed with the
// same round-to-nearest operations in the same order as the first design's
// (which formed the whole [Q, M] product in shared memory), so its results
// are those of that kernel bit for bit, and tanhf is the accurate one.
//
// What bounds it on this card: the chain of one row, 64 trips of (1 - acc,
// a product, two or three sums, tanhf), each step waiting on the last; the
// work is ~0.5 MFLOP and ~33 KB (PERF.md restates the bound and the chain
// floor).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kOutCols = 128;
constexpr int kWarp = 32;

__global__ void __launch_bounds__(kWarp)
    bias_probe_kernel(const float* w, const float* b, float* out, int p,
                      int q, int m, int trips, int fold) {
  const int l = blockIdx.x * kWarp + threadIdx.x;
  if (l >= p * q) return;
  const int mem = l / q, row = l % q;
  const float* wp = w + (size_t)mem * 3 * m;
  // column 0 of rows 0 and 1 of w[p], and of b[p]
  const float w0 = __ldg(wp), w1 = __ldg(wp + m), bb = __ldg(b + (size_t)mem * m);
  float acc = 0.1f;
  for (int i = 0; i < trips; ++i) {
    const float x1 = __fsub_rn(1.f, acc);
    float hv;
    if (fold) {
      hv = __fadd_rn(0.f, __fmul_rn(acc, w0));
      hv = __fadd_rn(hv, __fmul_rn(x1, w1));
      hv = __fadd_rn(hv, __fmul_rn(1.f, bb));
    } else {
      hv = __fadd_rn(__fmul_rn(acc, w0), __fmul_rn(x1, w1));
      hv = __fadd_rn(hv, bb);
    }
    acc = tanhf(__fadd_rn(hv, __fmul_rn(1e-3f, acc)));
  }
  float* o = out + (size_t)mem * kOutCols;
  o[row] = acc;
  for (int c = q + row; c < kOutCols; c += q) o[c] = 0.f;
}

}  // namespace

extern "C" int ionflux_bias_probe(const float* w, const float* b, float* out,
                                  int p, int q, int m, int trips, int fold,
                                  void* stream) {
  if (p < 1 || q < 1 || m < 1 || q > kOutCols || trips < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (p * q + kWarp - 1) / kWarp;
  bias_probe_kernel<<<blocks, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      w, b, out, p, q, m, trips, fold);
  return (int)cudaGetLastError();
}

extern "C" const char* ionflux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
