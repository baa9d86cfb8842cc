// Fused DP5(4) solves of NN-f / NN-d gate models on Hopper.
//
// Replaces four TPU kernels of ionflux/ops/pallas_solve.py:
//   fused_nnf_solve_ft          (one shared MLP x B protocols: P = 1, no cull)
//   fused_nnf_popsweep_solve_ft (P member MLPs x Q protocols, pace cull;
//                                also in its mxu_bf16 mode)
//   fused_nnf_pop_solve_ft      (P member MLPs x 1 protocol: the Q = 1 case)
// with trip_kernel, and
//   fused_nnf_solve             (the adaptive while-loop sweep)
// with while_kernel (see there).  The wrappers and the plain PyTorch versions
// of the same algorithms are in ionflux_torch/ops/fused_solve.py.
//
// Design.  One persistent cooperative launch per solve.  Block (member m,
// row tile) owns up to RT protocol rows of member m.  Every trip, each block
// evaluates the 6 new DP5 stages of its lanes: per stage an MLP pass of
// [RT, width] activations (shared memory, double-buffered) against the
// member's row-major [in, out] f32 weights, streamed from L2/global memory.
// The launch shares ONE step controller: each block writes its lanes' max
// live error ratio to partial[seq & 1][block], the grid synchronises, and
// every block reduces all partials itself and runs the same f32 controller
// algebra, so t, h and accept agree everywhere with no further traffic.
// Early exit and the pace cull happen at block ends, as in the reference.
//
// What bounds it on this card: operations.  The MLP is 6 * 2 * sum(in*out)
// FLOPs per lane per trip (2.4 MFLOP at the trained 200-wide, 7-layer
// width), run as f32 FMA on the CUDA cores: the kernel takes f32 weights and
// TF32 would leave the plain version's arithmetic.  The records, the only
// output, are ~16 floats per lane per trip, far below that in bytes.  What
// the design does about it: all lane state stays in shared memory for the
// whole solve, each member's weights (0.8 MB f32) stay L2-resident, only the
// record stream goes to HBM, and one grid barrier per trip is the only
// traffic between blocks.  What it does not do yet: a block's RT rows run
// the 42 dependent layer passes of a trip one after another on one SM, so a
// launch with few blocks (the sweep: one block for B <= 32) uses a sliver of
// the card.  chip_smoke.py measures each kernel against this bound; the
// numbers are in PERF.md.
//
// mxu_bf16 (WT = __nv_bfloat16): the weights are packed bf16, which halves
// their L2-resident bytes; each layer's input is rounded to bf16 where it is
// written; products and sums stay f32 (a product of two bf16 values is exact
// in f32).  The biases stay f32 (the wrapper has rounded them to bf16 values
// where the reference does).  With WT = float this is the f32 path.
//
// Arithmetic follows the plain version's f32 order: the stage combinations,
// error norm and controller use round-to-nearest intrinsics so the compiler
// cannot contract them into FMAs; build without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 16;

struct Partial {
  float max_ratio;
  int alive;
};

struct Args {
  const float* vpad;     // [Q, n_pad] knot voltages, end-padded
  const float* y0;       // [P, Q, 2]
  const void* w;         // [P, w_stride] of WT: W0, W1, ... row-major [in, out]
  const float* b;        // [P, b_stride]: b0, b1, ...
  float* rec_sc;         // [trips, 2]  (t, h_eff)
  float* rec_y;          // [trips, P, Q, 2]
  float* rec_k;          // [trips, 7, P, Q, 2]
  int* n_out;            // [2]  (n_acc or -max(n_acc, 1), n_valid)
  uint8_t* alive_out;    // [P, Q]
  Partial* part;         // [2, gridDim.x]
  long long w_stride, b_stride;
  int n_layers;
  int sizes[kMaxLayers + 1];
  int wmax;
  int p, q, n_pad, rt, tiles, trips, block, cull, has_base, max_steps;
  float t0, inv_dt, h0, t_end, span, rtol, atol, trips_f;
  float p1, p2, p3, p4, p5, p6, p7, p8;
};

// Dormand-Prince 5(4) tableau, each entry the f32 rounding of its f64 value
#define F(x) ((float)(x))
__constant__ float kC[7] = {0.f, F(1.0 / 5), F(3.0 / 10), F(4.0 / 5),
                            F(8.0 / 9), 1.f, 1.f};
__constant__ float kA[7][7] = {
    {0, 0, 0, 0, 0, 0, 0},
    {F(1.0 / 5), 0, 0, 0, 0, 0, 0},
    {F(3.0 / 40), F(9.0 / 40), 0, 0, 0, 0, 0},
    {F(44.0 / 45), F(-56.0 / 15), F(32.0 / 9), 0, 0, 0, 0},
    {F(19372.0 / 6561), F(-25360.0 / 2187), F(64448.0 / 6561),
     F(-212.0 / 729), 0, 0, 0},
    {F(9017.0 / 3168), F(-355.0 / 33), F(46732.0 / 5247), F(49.0 / 176),
     F(-5103.0 / 18656), 0, 0},
    {F(35.0 / 384), 0, F(500.0 / 1113), F(125.0 / 192), F(-2187.0 / 6784),
     F(11.0 / 84), 0}};
__constant__ float kBErr[7] = {
    F(35.0 / 384 - 5179.0 / 57600), F(0.0 - 0.0),
    F(500.0 / 1113 - 7571.0 / 16695), F(125.0 / 192 - 393.0 / 640),
    F(-2187.0 / 6784 - -92097.0 / 339200), F(11.0 / 84 - 187.0 / 2100),
    F(0.0 - 1.0 / 40)};
#undef F

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// NaN-propagating max (torch.maximum / jnp.maximum semantics)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// V(t) for protocol row `row`: clamped linear interpolation, no fallback
__device__ float voltage(const Args& a, int row, float t) {
  const float x = mul(sub(t, a.t0), a.inv_dt);
  int ii = (int)floorf(x);
  ii = min(max(ii, 0), a.n_pad - 130);
  const float w = sub(x, (float)ii);
  const float* vr = a.vpad + (size_t)row * a.n_pad;
  const float v0 = vr[ii], v1 = vr[ii + 1];
  return add(v0, mul(w, sub(v1, v0)));
}

// A weight as f32: bf16 widens exactly (its bits are the top half of the f32)
__device__ __forceinline__ float wload(const float* p) { return __ldg(p); }
__device__ __forceinline__ float wload(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// A layer input as the MLP consumes it: itself in f32, rounded to the
// nearest bf16 (ties to even, as torch's cast) under mxu_bf16
template <typename WT>
__device__ __forceinline__ float mlp_in(float x) { return x; }
template <>
__device__ __forceinline__ float mlp_in<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// MLP over the RT activation rows in `src` (row stride wmax; the caller has
// passed them through mlp_in).  Returns the buffer holding the [RT, 1]
// output.  All threads of the block call it.
template <int RT, typename WT>
__device__ float* mlp(const Args& a, const WT* wm, const float* bm,
                      float* src, float* dst, int nr) {
  const int ld = a.wmax;
  const WT* W = wm;
  const float* B = bm;
  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.sizes[l], dout = a.sizes[l + 1];
    const bool last = l == a.n_layers - 1;
    if (dout == 1) {
      // one output column: warp 0 splits the k sum over its lanes
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.f;
        for (int k = lane; k < din; k += 32) {
          const float wk = wload(W + k);
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(src[r * ld + k], wk, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
        }
        if (lane == 0) {
          const float bj = __ldg(B);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            if (r < nr) {
              float x = acc[r] + bj;
              if (!last) x = mlp_in<WT>(x >= 0.f ? x : 0.01f * x);
              dst[r * ld] = x;
            }
          }
        }
      }
    } else {
      for (int j = threadIdx.x; j < dout; j += kThreads) {
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.f;
        for (int k = 0; k < din; ++k) {
          const float wk = wload(W + (size_t)k * dout + j);
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(src[r * ld + k], wk, acc[r]);
        }
        const float bj = __ldg(B + j);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < nr) {
            float x = acc[r] + bj;
            if (!last) x = mlp_in<WT>(x >= 0.f ? x : 0.01f * x);
            dst[r * ld + j] = x;
          }
        }
      }
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
    W += (size_t)din * dout;
    B += dout;
  }
  return src;
}

template <int RT>
struct Smem {
  float* h0;     // [RT, wmax]
  float* h1;     // [RT, wmax]
  float* k;      // [7, RT, 2]
  float* y;      // [RT, 2]
  float* f;      // [RT, 2]
  float* yi;     // [RT, 2]
  float* v;      // [RT]
  float* rprev;  // [RT]
  int* alive;    // [RT]
  int* pend;     // [RT]

  __device__ Smem(float* base, int wmax) {
    h0 = base;
    h1 = h0 + RT * wmax;
    k = h1 + RT * wmax;
    y = k + 7 * RT * 2;
    f = y + RT * 2;
    yi = f + RT * 2;
    v = yi + RT * 2;
    rprev = v + RT;
    alive = reinterpret_cast<int*>(rprev + RT);
    pend = alive + RT;
  }

  static size_t bytes(int wmax) {
    return sizeof(float) * ((size_t)2 * RT * wmax + 7 * RT * 2 + 3 * RT * 2 +
                            2 * RT) + sizeof(int) * 2 * RT;
  }
};

// f(t, ysrc) for this block's lanes into kdst [RT, 2]
template <int RT, typename WT>
__device__ void rhs(const Args& a, const Smem<RT>& s, const WT* wm,
                    const float* bm, int row0, int nr, float t,
                    const float* ysrc, float* kdst) {
  const int tid = threadIdx.x;
  if (tid < nr) {
    const float v = voltage(a, row0 + tid, t);
    s.v[tid] = v;
    s.h0[tid * a.wmax + 0] = mlp_in<WT>(__fdiv_rn(v, 100.f));
    s.h0[tid * a.wmax + 1] = mlp_in<WT>(ysrc[tid * 2]);
  }
  __syncthreads();
  const float* out = mlp<RT, WT>(a, wm, bm, s.h0, s.h1, nr);
  if (tid < nr) {
    const float v = s.v[tid];
    const float ga = ysrc[tid * 2], gr = ysrc[tid * 2 + 1];
    float dadt = __fdiv_rn(out[tid * a.wmax], 1000.f);
    if (a.has_base) {
      const float k1 = mul(a.p1, expf(mul(a.p2, v)));
      const float k2 = mul(a.p3, expf(mul(-a.p4, v)));
      dadt = sub(add(dadt, mul(k1, sub(1.f, ga))), mul(k2, ga));
    }
    const float k3 = mul(a.p5, expf(mul(a.p6, v)));
    const float k4 = mul(a.p7, expf(mul(-a.p8, v)));
    kdst[tid * 2] = dadt;
    kdst[tid * 2 + 1] = add(mul(-k3, gr), mul(k4, sub(1.f, gr)));
  }
  __syncthreads();
}

// One DP5 attempt of this block's lanes from (t, s.y) with first stage s.f
// and step h_eff: the 7 stages into s.k.  All threads call it.
template <int RT, typename WT>
__device__ void attempt(const Args& a, const Smem<RT>& s, const WT* wm,
                        const float* bm, int row0, int nr, float t,
                        float h_eff) {
  const int tid = threadIdx.x;
  if (tid < nr) {
    s.k[tid * 2] = s.f[tid * 2];
    s.k[tid * 2 + 1] = s.f[tid * 2 + 1];
  }
  for (int si = 1; si < 7; ++si) {
    if (tid < nr) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float acc = s.y[tid * 2 + c];
        for (int sj = 0; sj < si; ++sj)
          if (kA[si][sj] != 0.f)
            acc = add(acc, mul(mul(h_eff, kA[si][sj]),
                               s.k[(sj * RT + tid) * 2 + c]));
        s.yi[tid * 2 + c] = acc;
      }
    }
    __syncthreads();
    rhs<RT, WT>(a, s, wm, bm, row0, nr, add(t, mul(kC[si], h_eff)), s.yi,
                s.k + si * RT * 2);
  }
}

// Lane tid's y1 and scaled error norm sqrt(mean((err / scale)^2)) after
// attempt(); sc gets the two scales
template <int RT>
__device__ float lane_error(const Args& a, const Smem<RT>& s, int tid,
                            float h_eff, float y1[2], float sc[2]) {
  float e[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float yc = s.y[tid * 2 + c];
    float y1c = yc, err = 0.f;
#pragma unroll
    for (int sj = 0; sj < 7; ++sj) {
      const float k = s.k[(sj * RT + tid) * 2 + c];
      if (kA[6][sj] != 0.f) y1c = add(y1c, mul(mul(h_eff, kA[6][sj]), k));
      if (kBErr[sj] != 0.f) err = add(err, mul(mul(h_eff, kBErr[sj]), k));
    }
    y1[c] = y1c;
    sc[c] = add(a.atol, mul(a.rtol, nanmax(fabsf(yc), fabsf(y1c))));
    e[c] = __fdiv_rn(err, sc[c]);
  }
  return __fsqrt_rn(__fdiv_rn(add(mul(e[0], e[0]), mul(e[1], e[1])), 2.f));
}

// Record row i for lane tid: its start y and the 7 stages (rows of pq2
// floats; lane_off is the lane's offset in a row)
template <int RT>
__device__ void record(const Args& a, const Smem<RT>& s, int tid, size_t i,
                       size_t pq2, size_t lane_off) {
  a.rec_y[i * pq2 + lane_off] = s.y[tid * 2];
  a.rec_y[i * pq2 + lane_off + 1] = s.y[tid * 2 + 1];
#pragma unroll
  for (int sj = 0; sj < 7; ++sj) {
    float* kr = a.rec_k + (i * 7 + sj) * pq2 + lane_off;
    kr[0] = s.k[(sj * RT + tid) * 2];
    kr[1] = s.k[(sj * RT + tid) * 2 + 1];
  }
}

// Grid-wide (max, sum) of one value per block.  All threads call it; the
// block's values are read from thread 0.  Slots alternate by `seq` parity:
// a block can only overwrite a slot after every block has passed the
// barrier that follows the last read of it.  The max propagates NaN.
__device__ void grid_reduce(const Args& a, cg::grid_group& grid, int& seq,
                            float lmax, int lcnt, float* gmax, int* gcnt,
                            float* red_m, int* red_c) {
  Partial* slots = a.part + (size_t)(seq & 1) * gridDim.x;
  if (threadIdx.x == 0) {
    slots[blockIdx.x].max_ratio = lmax;
    slots[blockIdx.x].alive = lcnt;
  }
  grid.sync();
  if (threadIdx.x < 32) {
    float m = 0.f;
    int c = 0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += 32) {
      m = nanmax(m, __ldcg(&slots[b].max_ratio));
      c += __ldcg(&slots[b].alive);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
      c += __shfl_xor_sync(0xffffffffu, c, o);
    }
    if (threadIdx.x == 0) {
      *red_m = m;
      *red_c = c;
    }
  }
  __syncthreads();
  *gmax = *red_m;
  *gcnt = *red_c;
  __syncthreads();
  ++seq;
}

// (max of m, sum of c) over warp 0's threads, valid in thread 0; every
// lane of a block is in warp 0 (RT <= 32).  The values are >= 0 or NaN, so
// 0 is the neutral max; the max propagates NaN.
__device__ __forceinline__ void block_stats(float m, int c, float* lmax,
                                            int* lcnt) {
  if (threadIdx.x < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
      c += __shfl_xor_sync(0xffffffffu, c, o);
    }
    *lmax = m;
    *lcnt = c;
  }
}

template <int RT, typename WT>
__global__ void __launch_bounds__(kThreads, 1) trip_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float red_m;
  __shared__ int red_c;
  const Smem<RT> s(smem, a.wmax);

  const int tid = threadIdx.x;
  const int member = blockIdx.x / a.tiles;
  const int row0 = (blockIdx.x % a.tiles) * a.rt;
  const int nr = min(a.rt, a.q - row0);
  const bool lane = tid < nr;
  const WT* wm = static_cast<const WT*>(a.w) + (size_t)member * a.w_stride;
  const float* bm = a.b + (size_t)member * a.b_stride;
  const size_t pq2 = (size_t)a.p * a.q * 2;
  const size_t lane_off = ((size_t)member * a.q + row0 + tid) * 2;
  int seq = 0;

  // ---- initial state: dead lanes (non-finite y0 or f0) reset to rest ----
  if (lane) {
    s.y[tid * 2] = a.y0[lane_off];
    s.y[tid * 2 + 1] = a.y0[lane_off + 1];
  }
  __syncthreads();
  rhs<RT, WT>(a, s, wm, bm, row0, nr, a.t0, s.y, s.f);
  bool alive_l = false;
  if (lane) {
    alive_l = finite(s.y[tid * 2]) && finite(s.y[tid * 2 + 1]) &&
              finite(s.f[tid * 2]) && finite(s.f[tid * 2 + 1]);
    if (!alive_l) {
      s.y[tid * 2] = 0.f;
      s.y[tid * 2 + 1] = 1.f;
      s.f[tid * 2] = 0.f;
      s.f[tid * 2 + 1] = 0.f;
    }
    s.alive[tid] = alive_l;
    s.pend[tid] = 0;
    s.rprev[tid] = 0.f;
  }
  float lmax = 0.f, gmax;
  int lcnt = 0, gcnt;
  block_stats(0.f, alive_l, &lmax, &lcnt);
  grid_reduce(a, grid, seq, lmax, lcnt, &gmax, &gcnt, &red_m, &red_c);

  float t = a.t0, h = a.h0;
  int n_acc = 0, blk = 0;
  const int n_blocks = a.trips / a.block;
  while (blk < n_blocks && t < a.t_end && gcnt > 0) {
    for (int j = 0; j < a.block; ++j) {
      const size_t i = (size_t)blk * a.block + j;
      const float h_eff = fmaxf(fminf(h, sub(a.t_end, t)), 1e-8f);
      attempt<RT, WT>(a, s, wm, bm, row0, nr, t, h_eff);

      float r = 0.f, rc = 0.f, y1[2] = {0.f, 0.f};
      bool bad = false;
      if (lane) {
        float sc[2];
        r = lane_error<RT>(a, s, tid, h_eff, y1, sc);
        r = add(r, mul(add(sc[0], sc[1]), 0.f));
        bad = !(r < INFINITY);
        rc = bad ? 3.4e38f : r;
        record<RT>(a, s, tid, i, pq2, lane_off);  // this trip's attempt
      }
      if (blockIdx.x == 0 && tid == 0) {
        a.rec_sc[i * 2] = t;
        a.rec_sc[i * 2 + 1] = h_eff;
      }
      const bool on = lane && s.alive[tid];
      block_stats(on ? rc : 0.f, on, &lmax, &lcnt);
      grid_reduce(a, grid, seq, lmax, lcnt, &gmax, &gcnt, &red_m, &red_c);
      const float ratio = gmax;
      const bool accept = ratio <= 1.f;
      if (lane) {
        const bool pass = !bad && r <= 1.f;
        const bool al = s.alive[tid] && (pass || h_eff > 2e-7f);
        s.alive[tid] = al;
        if (accept && al) {
          s.y[tid * 2] = y1[0];
          s.y[tid * 2 + 1] = y1[1];
          s.f[tid * 2] = s.k[(6 * RT + tid) * 2];
          s.f[tid * 2 + 1] = s.k[(6 * RT + tid) * 2 + 1];
        }
        s.rprev[tid] = rc;
      }
      if (accept) {
        t = add(t, h_eff);
        ++n_acc;
      }
      const float factor =
          mul(0.9f, expf(mul(-0.2f, logf(fmaxf(ratio, 1e-10f)))));
      h = mul(h_eff, fminf(fmaxf(factor, 0.2f), accept ? 10.f : 1.f));
      __syncthreads();
    }
    if (a.cull && lane) {
      // pace cull (see ops/fused_solve.py): two blocks in a row as a
      // candidate kill a lane
      const float spent = (float)((blk + 1) * a.block);
      const float frac_spent = __fdiv_rn(spent, a.trips_f);
      const float t_frac = __fdiv_rn(sub(t, a.t0), a.span);
      const float pace =
          __fdiv_rn(sub(a.t_end, t), fmaxf(sub(a.trips_f, spent), 1.f));
      const float h_lane = mul(
          h, expf(mul(-0.2f, logf(fmaxf(s.rprev[tid], 1e-30f)))));
      const bool behind =
          frac_spent >= 0.5f && t_frac < sub(frac_spent, 0.3f);
      const bool cand = behind && h_lane < mul(0.3f, pace);
      if (cand && s.pend[tid]) s.alive[tid] = 0;
      s.pend[tid] = cand;
    }
    __syncthreads();
    const bool on = lane && s.alive[tid];
    block_stats(0.f, on, &lmax, &lcnt);
    grid_reduce(a, grid, seq, lmax, lcnt, &gmax, &gcnt, &red_m, &red_c);
    ++blk;
  }

  if (lane) a.alive_out[(size_t)member * a.q + row0 + tid] = s.alive[tid] ? 1 : 0;
  if (blockIdx.x == 0 && tid == 0) {
    a.n_out[0] = t >= a.t_end ? n_acc : -max(n_acc, 1);
    a.n_out[1] = blk * a.block;
  }
}

// ---------------------------------------------------------------------------
// The adaptive while-loop sweep (replaces pallas_solve.py::fused_nnf_solve).
//
// One shared f32 NN-f net (P = 1) over Q = B <= 128 rows from rest, the same
// row tiling, attempt and error norm as trip_kernel, but the reference's
// first-generation semantics: no per-lane death and no blocks.  Each step
// the grid reduces (the NaN-propagating max of the lanes' error norms, the
// count of lanes whose y1 is non-finite), and every block runs the same f32
// controller on them:
//   accept = ratio <= 1 && no non-finite y1 && ratio finite;
// a NaN norm (a poisoned lane) rejects the step with factor 0.2 and keeps
// rejecting until max_steps.  Only accepted steps are recorded, at row
// n_acc, once the grid has decided.  The loop test uses only values every
// block holds identically (t, n_acc, the step count), so every block leaves
// the loop at the same step and no block is left waiting at a grid barrier.
// A lane's y is only ever replaced by a y1 that passed the finite test, so
// the reference's all(isfinite(y)) terms of the loop and outcome tests hold
// throughout and are not reduced.  a.trips is max_rec.
//
// What bounds it on this card: operations, as trip_kernel; on healthy
// inputs it takes trip_kernel's accepted steps and about its rejected ones,
// and one grid barrier per step.
// ---------------------------------------------------------------------------
template <int RT>
__global__ void __launch_bounds__(kThreads, 1) while_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float red_m;
  __shared__ int red_c;
  const Smem<RT> s(smem, a.wmax);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * a.rt;
  const int nr = min(a.rt, a.q - row0);
  const bool lane = tid < nr;
  const float* wm = static_cast<const float*>(a.w);
  const size_t pq2 = (size_t)a.q * 2;
  const size_t lane_off = ((size_t)row0 + tid) * 2;
  int seq = 0;

  if (lane) {
    s.y[tid * 2] = 0.f;
    s.y[tid * 2 + 1] = 1.f;
  }
  __syncthreads();
  rhs<RT, float>(a, s, wm, a.b, row0, nr, a.t0, s.y, s.f);

  float t = a.t0, h = a.h0, lmax = 0.f, gmax;
  int n_acc = 0, n_step = 0, lcnt = 0, gcnt;
  bool go = true;
  while (go) {
    const float h_eff = nanmax(fminf(h, sub(a.t_end, t)), 1e-8f);
    attempt<RT, float>(a, s, wm, a.b, row0, nr, t, h_eff);
    float r = 0.f, y1[2] = {0.f, 0.f};
    bool fin = true;
    if (lane) {
      float sc[2];
      r = lane_error<RT>(a, s, tid, h_eff, y1, sc);
      fin = finite(y1[0]) && finite(y1[1]);
    }
    block_stats(r, lane && !fin, &lmax, &lcnt);
    grid_reduce(a, grid, seq, lmax, lcnt, &gmax, &gcnt, &red_m, &red_c);
    const float ratio = gmax;
    const bool accept = ratio <= 1.f && gcnt == 0 && finite(ratio);
    if (accept) {
      if (lane) {
        record<RT>(a, s, tid, n_acc, pq2, lane_off);
        s.y[tid * 2] = y1[0];
        s.y[tid * 2 + 1] = y1[1];
        s.f[tid * 2] = s.k[(6 * RT + tid) * 2];
        s.f[tid * 2 + 1] = s.k[(6 * RT + tid) * 2 + 1];
      }
      if (blockIdx.x == 0 && tid == 0) {
        a.rec_sc[(size_t)n_acc * 2] = t;
        a.rec_sc[(size_t)n_acc * 2 + 1] = h_eff;
      }
      t = add(t, h_eff);
      ++n_acc;
    }
    float factor = mul(0.9f, expf(mul(-0.2f, logf(nanmax(ratio, 1e-10f)))));
    if (!finite(factor)) factor = 0.2f;
    h = mul(h_eff, fminf(fmaxf(factor, 0.2f), accept ? 10.f : 1.f));
    ++n_step;
    go = t < a.t_end && n_step < a.max_steps && n_acc < a.trips;
    __syncthreads();
  }

  if (blockIdx.x == 0 && tid == 0) {
    a.n_out[0] = t >= a.t_end ? n_acc : -n_acc;
    a.n_out[1] = n_step;
  }
}

// One cooperative launch of `kern` over `grid` blocks, after checking that
// they can all be resident at once (the grid barrier needs it)
template <typename Kern>
cudaError_t launch_coop(Kern kern, Args& a, int grid, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((void*)kern, dim3(grid), dim3(kThreads),
                                     args, smem, stream);
}

template <int RT>
cudaError_t launch_trip(Args& a, bool bf16, cudaStream_t stream) {
  const size_t smem = Smem<RT>::bytes(a.wmax);
  const int grid = a.p * a.tiles;
  return bf16 ? launch_coop(trip_kernel<RT, __nv_bfloat16>, a, grid, smem,
                            stream)
              : launch_coop(trip_kernel<RT, float>, a, grid, smem, stream);
}

template <int RT>
cudaError_t launch_while(Args& a, cudaStream_t stream) {
  return launch_coop(while_kernel<RT>, a, a.tiles, Smem<RT>::bytes(a.wmax),
                     stream);
}

// The fields both entry points fill the same way; false if out of range
bool init_args(Args& a, const float* vpad, const int* sizes, int n_layers,
               int p, int q, int n_pad, int rt, const float* scal) {
  if (n_layers < 1 || n_layers > kMaxLayers || rt < 1 || rt > 32 || p < 1 ||
      q < 1)
    return false;
  a = Args{};
  a.vpad = vpad;
  a.n_layers = n_layers;
  a.wmax = 0;
  for (int l = 0; l <= n_layers; ++l) {
    a.sizes[l] = sizes[l];
    a.wmax = a.wmax > sizes[l] ? a.wmax : sizes[l];
  }
  a.p = p;
  a.q = q;
  a.n_pad = n_pad;
  a.rt = rt;
  a.tiles = (q + rt - 1) / rt;
  a.t0 = scal[0];
  a.inv_dt = scal[1];
  a.h0 = scal[2];
  a.t_end = scal[3];
  a.span = scal[4];
  a.rtol = scal[5];
  a.atol = scal[6];
  a.trips_f = scal[7];
  a.p1 = scal[8];
  a.p2 = scal[9];
  a.p3 = scal[10];
  a.p4 = scal[11];
  a.p5 = scal[12];
  a.p6 = scal[13];
  a.p7 = scal[14];
  a.p8 = scal[15];
  return true;
}

}  // namespace

extern "C" int ionflux_trip_solve(
    const float* vpad, const float* y0, const void* w, long long w_stride,
    const float* b, long long b_stride, int bf16, float* rec_sc, float* rec_y,
    float* rec_k, int* n_out, uint8_t* alive_out, void* partial,
    const int* sizes, int n_layers, int p, int q, int n_pad, int rt,
    int trips, int block, int cull, int has_base, const float* scal,
    void* stream) {
  Args a;
  if (!init_args(a, vpad, sizes, n_layers, p, q, n_pad, rt, scal) ||
      block < 1 || trips % block != 0)
    return (int)cudaErrorInvalidValue;
  a.y0 = y0;
  a.w = w;
  a.b = b;
  a.w_stride = w_stride;
  a.b_stride = b_stride;
  a.rec_sc = rec_sc;
  a.rec_y = rec_y;
  a.rec_k = rec_k;
  a.n_out = n_out;
  a.alive_out = alive_out;
  a.part = static_cast<Partial*>(partial);
  a.trips = trips;
  a.block = block;
  a.cull = cull;
  a.has_base = has_base;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rt <= 8)
    err = launch_trip<8>(a, bf16 != 0, s);
  else if (rt <= 16)
    err = launch_trip<16>(a, bf16 != 0, s);
  else
    err = launch_trip<32>(a, bf16 != 0, s);
  return (int)err;
}

extern "C" int ionflux_while_solve(
    const float* vpad, const float* w, const float* b, float* rec_sc,
    float* rec_y, float* rec_k, int* n_out, void* partial, const int* sizes,
    int n_layers, int q, int n_pad, int rt, int max_rec, int max_steps,
    const float* scal, void* stream) {
  Args a;
  if (!init_args(a, vpad, sizes, n_layers, 1, q, n_pad, rt, scal) ||
      max_rec < 1 || max_steps < 1)
    return (int)cudaErrorInvalidValue;
  a.w = w;
  a.b = b;
  a.rec_sc = rec_sc;
  a.rec_y = rec_y;
  a.rec_k = rec_k;
  a.n_out = n_out;
  a.part = static_cast<Partial*>(partial);
  a.trips = max_rec;
  a.max_steps = max_steps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rt <= 8)
    err = launch_while<8>(a, s);
  else if (rt <= 16)
    err = launch_while<16>(a, s);
  else
    err = launch_while<32>(a, s);
  return (int)err;
}

extern "C" const char* ionflux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
