// K2: symmetric eigendecomposition of small matrices by cyclic Jacobi.
//
// No Pallas kernel: it replaces jnp.linalg.eigh inside the device-resident
// CMA-ES of ionflux/fit/cmaes.py::cmaes_onchip (one n x n covariance per
// generation, n = 4 for the d0 fit).  XLA computes eigh on the TPU by Jacobi
// sweeps too.  PyTorch's torch.linalg.eigh on a CUDA tensor reads its
// status on the host after the solve, which a CUDA graph capture refuses and
// which would put a host round trip into every generation; this kernel makes
// no host read, so a whole chunk of generations captures as one graph.  The
// wrapper and the plain PyTorch version are in
// ionflux_torch/ops/sym_eig.py.
//
// Algorithm (Golub & Van Loan, Alg. 8.5.2, cyclic-by-row): sweeps over the
// pairs p < q in row order; a pair whose |a_pq| is above 1e-8 sqrt(|a_pp
// a_qq|) is rotated to zero (A <- J^T A J, V <- V J); the sweeps stop when
// one rotated nothing, or after max_sweeps.  The eigenvalues (the diagonal)
// are then sorted ascending, stably, and V's columns with them, as eigh
// returns them.  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn, no fused multiply-add), in the plain version's
// order, so the two agree to the last bit.
//
// Design: one block of one warp per matrix; A and V in shared memory; lane
// 0 computes each rotation, lane k < n applies it to row and column k.
// What bounds it: the chain of n (n - 1) / 2 dependent rotations per sweep
// (a square root and two divides each) and a barrier after each phase; the
// work is ~100 FLOP per rotation, far below any rate of the card.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kWarp = 32;

__global__ void sym_eig_kernel(const float* __restrict__ a_in,
                               float* __restrict__ w_out,
                               float* __restrict__ v_out, int n,
                               int max_sweeps) {
  __shared__ float a[kMaxN][kMaxN];
  __shared__ float v[kMaxN][kMaxN];
  __shared__ float rot[2];         // c, s of the current pair
  __shared__ int rotate;           // the current pair is rotated
  __shared__ int any;              // this sweep rotated a pair
  const int k = threadIdx.x;
  const float* src = a_in + (size_t)blockIdx.x * n * n;
  for (int i = k; i < n * n; i += kWarp) {
    a[i / n][i % n] = src[i];
    v[i / n][i % n] = (i / n == i % n) ? 1.0f : 0.0f;
  }
  __syncwarp();
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    if (k == 0) any = 0;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        __syncwarp();                    // every lane has read the last pair
        if (k == 0) {
          const float app = a[p][p], aqq = a[q][q], apq = a[q][p];
          const float thr = __fmul_rn(1e-8f, sqrtf(fabsf(__fmul_rn(app, aqq))));
          rotate = fabsf(apq) > thr;
          float c = 1.0f, s = 0.0f;
          if (rotate) {
            const float theta = __fdiv_rn(__fsub_rn(aqq, app),
                                          __fmul_rn(2.0f, apq));
            const float root = sqrtf(__fadd_rn(__fmul_rn(theta, theta), 1.0f));
            const float t = theta >= 0.0f
                                ? __fdiv_rn(1.0f, __fadd_rn(theta, root))
                                : __fdiv_rn(-1.0f, __fadd_rn(-theta, root));
            c = __fdiv_rn(1.0f, sqrtf(__fadd_rn(__fmul_rn(t, t), 1.0f)));
            s = __fmul_rn(t, c);
            any = 1;
          }
          rot[0] = c;
          rot[1] = s;
        }
        __syncwarp();
        if (!rotate) continue;           // the same for every lane
        const float c = rot[0], s = rot[1];
        if (k < n) {                     // columns p, q: A <- A J
          const float x = a[k][p], y = a[k][q];
          a[k][p] = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
          a[k][q] = __fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y));
        }
        __syncwarp();
        if (k < n) {                     // rows p, q: A <- J^T A
          const float x = a[p][k], y = a[q][k];
          a[p][k] = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
          a[q][k] = __fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y));
        }
        __syncwarp();
        if (k == 0) {
          a[p][q] = 0.0f;
          a[q][p] = 0.0f;
        }
        if (k < n) {                     // V <- V J
          const float x = v[k][p], y = v[k][q];
          v[k][p] = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
          v[k][q] = __fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y));
        }
        __syncwarp();
      }
    }
    __syncwarp();
    const int rotated = any;
    __syncwarp();                        // read before lane 0 resets it
    if (!rotated) break;
  }
  __syncwarp();
  // ascending, stable: eigenvalue i goes to its rank among the others
  if (k < n) {
    const float dk = a[k][k];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float dj = a[j][j];
      rank += (dj < dk) || (dj == dk && j < k);
    }
    float* w = w_out + (size_t)blockIdx.x * n;
    float* vo = v_out + (size_t)blockIdx.x * n * n;
    w[rank] = dk;
    for (int i = 0; i < n; ++i) vo[i * n + rank] = v[i][k];
  }
}

}  // namespace

extern "C" int ionflux_sym_eig(const float* a, float* w, float* v, int m,
                               int n, int max_sweeps, void* stream) {
  if (m < 1 || n < 1 || n > kMaxN || max_sweeps < 1)
    return (int)cudaErrorInvalidValue;
  sym_eig_kernel<<<m, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      a, w, v, n, max_sweeps);
  return (int)cudaGetLastError();
}

extern "C" const char* ionflux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
