// K1: a batch of tridiagonal systems by the Thomas algorithm.
//
// No Pallas kernel: it replaces the two lax.scan recurrences of
// ionflux/ops/spline.py::tridiag_solve (forward elimination, back
// substitution), which the on-device derivative surface
// (ionflux/surface.py::estimate_gate_surface_ondevice) runs once per
// constant-voltage segment for the not-a-knot cubic spline.  In PyTorch ops
// each sample of the recurrence would be launches of its own.  The wrapper
// and the plain PyTorch version are in ionflux_torch/ops/spline.py.
//
// Layout: the systems are packed one after another in dl, d, du, b
// (float32); system i starts at start[i] and has len[i] rows.  cp and dp are
// the wrapper's scratch of the same length; x the solution.  Per system, in
// the reference's order:
//   cp[0] = du[0] / d[0],  dp[0] = b[0] / d[0]
//   den = d[j] - dl[j] cp[j-1];  cp[j] = du[j] / den;
//   dp[j] = (b[j] - dl[j] dp[j-1]) / den                      j = 1 .. n-1
//   x[n-1] = dp[n-1];  x[j] = dp[j] - cp[j] x[j+1]            j = n-2 .. 0
// every product and sum rounded on its own (no fused multiply-add), as the
// plain version computes it, so the two agree bit for bit.
//
// Design: one thread per system, a batch (the segments of a protocol) in one
// launch.  What bounds it: each system's chain of 2 n dependent steps (a
// divide each in the forward pass), not the bytes (7 floats a row, ~2 MB for
// an 80,001-sample protocol): the longest segment sets the time.

#include <cuda_runtime.h>

namespace {

__global__ void thomas_kernel(const float* __restrict__ dl,
                              const float* __restrict__ d,
                              const float* __restrict__ du,
                              const float* __restrict__ b,
                              float* __restrict__ x, float* __restrict__ cp,
                              float* __restrict__ dp,
                              const long long* __restrict__ start,
                              const int* __restrict__ len, int n_sys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_sys) return;
  const long long s = start[i];
  const int n = len[i];
  if (n < 1) return;
  float c = __fdiv_rn(du[s], d[s]);
  float e = __fdiv_rn(b[s], d[s]);
  cp[s] = c;
  dp[s] = e;
  for (int j = 1; j < n; ++j) {
    const long long k = s + j;
    const float l = dl[k];
    const float den = __fsub_rn(d[k], __fmul_rn(l, c));
    c = __fdiv_rn(du[k], den);
    e = __fdiv_rn(__fsub_rn(b[k], __fmul_rn(l, e)), den);
    cp[k] = c;
    dp[k] = e;
  }
  float xn = e;
  x[s + n - 1] = xn;
  for (int j = n - 2; j >= 0; --j) {
    const long long k = s + j;
    xn = __fsub_rn(dp[k], __fmul_rn(cp[k], xn));
    x[k] = xn;
  }
}

}  // namespace

extern "C" int ionflux_thomas(const float* dl, const float* d,
                              const float* du, const float* b, float* x,
                              float* cp, float* dp, const long long* start,
                              const int* len, int n_sys, void* stream) {
  if (n_sys < 1) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 32;
  thomas_kernel<<<(n_sys + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      dl, d, du, b, x, cp, dp, start, len, n_sys);
  return (int)cudaGetLastError();
}

extern "C" const char* ionflux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
