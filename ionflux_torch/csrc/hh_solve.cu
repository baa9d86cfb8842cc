// Candidate-HH population solves on Hopper: B <= 128 per-lane parameter sets
// [B, 8] on ONE shared protocol.
//
// Replaces two TPU kernels:
//   ionflux/ops/pallas_solve.py::fused_hh_pop_solve_ft  (hh_trip_kernel:
//     adaptive DP5(4) on one shared step clock, y0 carry, per-lane death,
//     binding-ratio pace cull; the CMA-ES whole-trace objective's kernel)
//   ionflux/ops/pallas_rk4.py::fused_hh_rk4             (hh_rk4_kernel:
//     fixed-step RK4, n_sub substeps per output interval)
// The wrappers and the plain PyTorch versions are in
// ionflux_torch/ops/hh_solve.py.
//
// Design.  The whole population fits one thread block: one thread per lane,
// its 8 rate parameters, state and the 7 DP5 stages in registers.  The RHS is
// four expf and a few multiplies; the shared protocol's V(t) is one clamped
// linear interpolation per stage that every thread reads from the same
// address.  The trip kernel's shared controller needs the max error ratio
// over live lanes every trip: a warp shuffle, one partial per warp in shared
// memory (two buffers, alternating by trip, so one __syncthreads per trip
// suffices), then every thread reduces the partials itself and runs the same
// f32 controller algebra, so t, h and accept agree with no further traffic.
// It is an ordinary launch: no cooperative grid, no grid barrier.  Every
// trip's own attempt (t, h_eff, start y, 7 stages) goes straight to HBM as
// float2 stores, coalesced over lanes; phase 2 (dense output) stays in torch
// ops.  The RK4 kernel writes its trace [n_out, B, 2] directly.
//
// What bounds them on this card: for the trip kernel bytes, barely (16
// floats of records per lane per trip against ~100 operations); for RK4
// operations.  Neither bound is near: both are one block on one of 132 SMs
// running a long chain of dependent steps, so they are latency-bound (expf,
// the dependent voltage load, one block barrier per trip).  That is the
// shape of the work, B <= 128 lanes on one step clock; chip_smoke.py
// measures each against its bound and PERF.md keeps the numbers.
//
// Arithmetic follows the plain versions' f32 order: round-to-nearest
// intrinsics so the compiler cannot contract multiply-adds into FMAs; build
// without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 128;

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

// V(t) of the shared protocol: linear interpolation between knots, the knot
// index clamped to [0, hi]; no out-of-domain fallback
__device__ __forceinline__ float voltage(const float* v, int hi, float t0,
                                         float inv_dt, float t) {
  const float x = mul(sub(t, t0), inv_dt);
  int ii = (int)floorf(x);
  ii = min(max(ii, 0), hi);
  const float w = sub(x, (float)ii);
  const float v0 = __ldg(v + ii), v1 = __ldg(v + ii + 1);
  return add(v0, mul(w, sub(v1, v0)));
}

// d[a, r]/dt of one lane's candidate HH at voltage v
__device__ __forceinline__ void hh_rhs(const float (&p)[8], float v, float a,
                                       float r, float* da, float* dr) {
  const float k1 = mul(p[0], expf(mul(p[1], v)));
  const float k2 = mul(p[2], expf(mul(-p[3], v)));
  const float k3 = mul(p[4], expf(mul(p[5], v)));
  const float k4 = mul(p[6], expf(mul(-p[7], v)));
  *da = sub(mul(k1, sub(1.f, a)), mul(k2, a));
  *dr = add(mul(-k3, r), mul(k4, sub(1.f, r)));
}

struct TripArgs {
  const float* vpad;    // [n_pad] knot voltages, end-padded
  const float* params;  // [B, 8]
  const float* y0;      // [B, 2]
  float* rec_sc;        // [trips, 2]  (t, h_eff)
  float* rec_y;         // [trips, B, 2]
  float* rec_k;         // [trips, 7, B, 2]
  int* n_out;           // [2]  (n_acc or -max(n_acc, 1), n_valid)
  uint8_t* alive_out;   // [B]
  int b, n_pad, trips, block;
  float t0, inv_dt, h0, t_end, span, rtol, atol, trips_f;
};

__global__ void __launch_bounds__(kMaxLanes, 1) hh_trip_kernel(TripArgs a) {
  __shared__ float red[2][kMaxLanes / 32];
  const int lane = threadIdx.x;
  const bool on = lane < a.b;
  const int warp = lane >> 5;
  const int n_warps = blockDim.x >> 5;
  const int hi = a.n_pad - 130;
  float2* rec_y = reinterpret_cast<float2*>(a.rec_y);
  float2* rec_k = reinterpret_cast<float2*>(a.rec_k);

  float p[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) p[c] = on ? a.params[lane * 8 + c] : 0.f;
  float y[2] = {0.f, 1.f}, f[2];
  if (on) {
    y[0] = a.y0[lane * 2];
    y[1] = a.y0[lane * 2 + 1];
  }
  hh_rhs(p, voltage(a.vpad, hi, a.t0, a.inv_dt, a.t0), y[0], y[1], &f[0],
         &f[1]);
  // lanes arriving non-finite, or with a non-finite RHS at the start, are
  // dead from the start and reset to rest
  bool alive = on && isfinite(y[0]) && isfinite(y[1]) && isfinite(f[0]) &&
               isfinite(f[1]);
  if (!alive) {
    y[0] = 0.f;
    y[1] = 1.f;
    f[0] = 0.f;
    f[1] = 0.f;
  }

  float t = a.t0, h = a.h0, r_prev = 0.f;
  bool pend = false;
  int n_acc = 0, blk = 0, seq = 0;
  const int n_blocks = a.trips / a.block;
  int any_alive = __syncthreads_or(alive);
  while (blk < n_blocks && t < a.t_end && any_alive) {
    for (int j = 0; j < a.block; ++j) {
      const size_t i = (size_t)blk * a.block + j;
      const float h_eff = fmaxf(fminf(h, sub(a.t_end, t)), 1e-8f);
      float k[7][2];
      k[0][0] = f[0];
      k[0][1] = f[1];
#pragma unroll
      for (int si = 1; si < 7; ++si) {
        float yi[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float acc = y[c];
#pragma unroll
          for (int sj = 0; sj < si; ++sj)
            if (kA[si][sj] != 0.f)
              acc = add(acc, mul(mul(h_eff, kA[si][sj]), k[sj][c]));
          yi[c] = acc;
        }
        const float v = voltage(a.vpad, hi, a.t0, a.inv_dt,
                                add(t, mul(kC[si], h_eff)));
        hh_rhs(p, v, yi[0], yi[1], &k[si][0], &k[si][1]);
      }

      float y1[2], sc[2], e[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float y1c = y[c], err = 0.f;
#pragma unroll
        for (int sj = 0; sj < 7; ++sj) {
          if (kA[6][sj] != 0.f)
            y1c = add(y1c, mul(mul(h_eff, kA[6][sj]), k[sj][c]));
          if (kBErr[sj] != 0.f)
            err = add(err, mul(mul(h_eff, kBErr[sj]), k[sj][c]));
        }
        y1[c] = y1c;
        sc[c] = add(a.atol, mul(a.rtol, nanmax(fabsf(y[c]), fabsf(y1c))));
        e[c] = __fdiv_rn(err, sc[c]);
      }
      float r = __fsqrt_rn(
          __fdiv_rn(add(mul(e[0], e[0]), mul(e[1], e[1])), 2.f));
      // NaN-poison r with scale * 0 so a non-finite y1 reads as bad too
      r = add(r, mul(add(sc[0], sc[1]), 0.f));
      const bool bad = !(r < INFINITY);
      const float rc = bad ? 3.4e38f : r;

      // record this trip's own attempt: start y and the 7 stages
      if (on) {
        rec_y[i * a.b + lane] = make_float2(y[0], y[1]);
#pragma unroll
        for (int sj = 0; sj < 7; ++sj)
          rec_k[(i * 7 + sj) * a.b + lane] = make_float2(k[sj][0], k[sj][1]);
      }
      if (lane == 0) {
        a.rec_sc[i * 2] = t;
        a.rec_sc[i * 2 + 1] = h_eff;
      }

      // the launch's ratio: max over LIVE lanes (r_c >= 0, so 0 is neutral)
      float m = alive ? rc : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if ((lane & 31) == 0) red[seq & 1][warp] = m;
      __syncthreads();
      float ratio = 0.f;
      for (int w = 0; w < n_warps; ++w) ratio = fmaxf(ratio, red[seq & 1][w]);
      ++seq;

      const bool accept = ratio <= 1.f;
      const bool pass = !bad && r <= 1.f;
      alive = alive && (pass || h_eff > 2e-7f);
      if (accept && alive) {
        y[0] = y1[0];
        y[1] = y1[1];
        f[0] = k[6][0];
        f[1] = k[6][1];
      }
      if (accept) {
        t = add(t, h_eff);
        ++n_acc;
      }
      const float factor =
          mul(0.9f, expf(mul(-0.2f, logf(fmaxf(ratio, 1e-10f)))));
      h = mul(h_eff, fminf(fmaxf(factor, 0.2f), accept ? 10.f : 1.f));
      r_prev = rc;
    }
    // pace cull, binding-ratio form: once half the trips are spent and t lags
    // the trip fraction by > 0.3, a lane whose last error ratio is > 0.01
    // binds the shared controller; two blocks in a row as a candidate kill it
    const float spent = (float)((blk + 1) * a.block);
    const float frac_spent = __fdiv_rn(spent, a.trips_f);
    const float t_frac = __fdiv_rn(sub(t, a.t0), a.span);
    const bool behind = frac_spent >= 0.5f && t_frac < sub(frac_spent, 0.3f);
    const bool cand = behind && r_prev > 0.01f;
    if (cand && pend) alive = false;
    pend = cand;
    any_alive = __syncthreads_or(alive);
    ++blk;
  }

  if (on) a.alive_out[lane] = alive ? 1 : 0;
  if (lane == 0) {
    a.n_out[0] = t >= a.t_end ? n_acc : -max(n_acc, 1);
    a.n_out[1] = blk * a.block;
  }
}

struct Rk4Args {
  const float* v;       // [n_knots]
  const float* params;  // [B, 8]
  float* out;           // [n_out, B, 2]
  int b, n_knots, n_out, n_sub;
  float t0, inv_dt, dt_out, h, half_h, h6, a0, r0;
};

__global__ void __launch_bounds__(kMaxLanes, 1) hh_rk4_kernel(Rk4Args a) {
  const int lane = threadIdx.x;
  if (lane >= a.b) return;
  const int hi = a.n_knots - 2;
  float2* out = reinterpret_cast<float2*>(a.out);
  float p[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) p[c] = a.params[lane * 8 + c];
  float ya = a.a0, yr = a.r0;
  out[lane] = make_float2(ya, yr);
  for (int oi = 1; oi < a.n_out; ++oi) {
    const float tbase = add(a.t0, mul((float)(oi - 1), a.dt_out));
    for (int i = 0; i < a.n_sub; ++i) {
      const float t = add(tbase, mul((float)i, a.h));
      const float v_a = voltage(a.v, hi, a.t0, a.inv_dt, t);
      const float v_b = voltage(a.v, hi, a.t0, a.inv_dt, add(t, a.half_h));
      const float v_c = voltage(a.v, hi, a.t0, a.inv_dt, add(t, a.h));
      float k1[2], k2[2], k3[2], k4[2];
      hh_rhs(p, v_a, ya, yr, &k1[0], &k1[1]);
      hh_rhs(p, v_b, add(ya, mul(a.half_h, k1[0])),
             add(yr, mul(a.half_h, k1[1])), &k2[0], &k2[1]);
      hh_rhs(p, v_b, add(ya, mul(a.half_h, k2[0])),
             add(yr, mul(a.half_h, k2[1])), &k3[0], &k3[1]);
      hh_rhs(p, v_c, add(ya, mul(a.h, k3[0])), add(yr, mul(a.h, k3[1])),
             &k4[0], &k4[1]);
      ya = add(ya, mul(a.h6, add(add(add(k1[0], mul(2.f, k2[0])),
                                     mul(2.f, k3[0])), k4[0])));
      yr = add(yr, mul(a.h6, add(add(add(k1[1], mul(2.f, k2[1])),
                                     mul(2.f, k3[1])), k4[1])));
    }
    out[(size_t)oi * a.b + lane] = make_float2(ya, yr);
  }
}

int threads_for(int b) { return ((b + 31) / 32) * 32; }

}  // namespace

// scal: t0, 1/dt_knot, h0, t_end, t_end - t0, rtol, atol, (float)trips
extern "C" int ionflux_hh_trip_solve(
    const float* vpad, const float* params, const float* y0, float* rec_sc,
    float* rec_y, float* rec_k, int* n_out, uint8_t* alive_out, int b,
    int n_pad, int trips, int block, const float* scal, void* stream) {
  if (b < 1 || b > kMaxLanes || n_pad < 131 || block < 1 || trips < block ||
      trips % block != 0)
    return (int)cudaErrorInvalidValue;
  TripArgs a;
  a.vpad = vpad;
  a.params = params;
  a.y0 = y0;
  a.rec_sc = rec_sc;
  a.rec_y = rec_y;
  a.rec_k = rec_k;
  a.n_out = n_out;
  a.alive_out = alive_out;
  a.b = b;
  a.n_pad = n_pad;
  a.trips = trips;
  a.block = block;
  a.t0 = scal[0];
  a.inv_dt = scal[1];
  a.h0 = scal[2];
  a.t_end = scal[3];
  a.span = scal[4];
  a.rtol = scal[5];
  a.atol = scal[6];
  a.trips_f = scal[7];
  hh_trip_kernel<<<1, threads_for(b), 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// scal: t0, 1/dt_knot, dt_out, h, h/2, h/6, a0, r0
extern "C" int ionflux_hh_rk4(const float* v, const float* params, float* out,
                              int b, int n_knots, int n_out, int n_sub,
                              const float* scal, void* stream) {
  if (b < 1 || b > kMaxLanes || n_knots < 2 || n_out < 1 || n_sub < 1)
    return (int)cudaErrorInvalidValue;
  Rk4Args a;
  a.v = v;
  a.params = params;
  a.out = out;
  a.b = b;
  a.n_knots = n_knots;
  a.n_out = n_out;
  a.n_sub = n_sub;
  a.t0 = scal[0];
  a.inv_dt = scal[1];
  a.dt_out = scal[2];
  a.h = scal[3];
  a.half_h = scal[4];
  a.h6 = scal[5];
  a.a0 = scal[6];
  a.r0 = scal[7];
  hh_rk4_kernel<<<1, threads_for(b), 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* ionflux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
