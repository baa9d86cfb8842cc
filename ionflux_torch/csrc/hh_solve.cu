// Candidate-HH population solves on Hopper: B <= 128 per-lane parameter sets
// [B, 8] on ONE shared protocol.
//
// Replaces two TPU kernels:
//   ionflux/ops/pallas_solve.py::fused_hh_pop_solve_ft  (hh_trip_kernel:
//     adaptive DP5(4) on one shared step clock, y0 carry, per-lane death,
//     binding-ratio pace cull; the CMA-ES whole-trace objective's kernel)
//   ionflux/ops/pallas_rk4.py::fused_hh_rk4             (hh_rk4_kernel:
//     fixed-step RK4, n_sub substeps per output interval)
// The wrappers, their geometry rules and the plain PyTorch versions are in
// ionflux_torch/ops/hh_solve.py.
//
// What bounds them on this card.  Neither comes near its bound by bytes or
// operations: a lane's state advances through a long chain of dependent f32
// operations, one step (trip kernel) or one substep (RK4) after another, so
// the floor is that chain's latency.  Everything that is not the state's
// own arithmetic is kept off it:
//
// * The HH right-hand side is da/dt = k1 (1 - a) - k2 a, dr/dt = -k3 r +
//   k4 (1 - r), whose rates k1..k4 = p0 e^(p1 v), p2 e^(-p3 v), p4 e^(p5 v),
//   p6 e^(-p7 v) depend on the voltage and the lane's parameters only, never
//   on the state.  A DP5 trip's six stages sit at five distinct times (the
//   last two at c = 1), so a trip needs 5 voltages and 20 rates per lane,
//   all known once the controller has set (t, h_eff): none of that work
//   needs to wait on, or hold up, the lane's chain.
//
// hh_trip_kernel: one block (the shared clock needs the launch's max error
// ratio every trip), warp-specialised (ops/hh_solve.py::hh_trip_geometry):
//   * chain warps, the first ceil(B / 32): thread l runs lane l's state
//     through the six stage sums, y1, the error norm and the ratio, with no
//     expf and no global load; writes the trip's record (start y, 7 stages)
//     to shared memory; reduces the launch's max ratio (__reduce_max_sync on
//     the bits: the ratios are >= +0 and never NaN, so the integer order is
//     the float order; a named barrier among the chain warps past 32 lanes);
//     runs the controller, and warp 0's lanes 0..4 load the next trip's
//     five stage voltages into shared memory;
//   * helper warps after them, G threads per lane: on the voltages, they
//     compute the lane's 20 rates into shared memory (j-major, so a warp's
//     stores hit distinct banks); then, while the chain runs, copy the
//     previous trip's records to device memory (float2 stores, coalesced
//     over lanes; two record slots alternate by trip).
// Two named barriers hand over per trip, each an arrive on one side and a
// sync on the other (voltages ready; rates ready), so no warp waits on work
// it does not need; nothing but the chain, the controller and the voltage
// loads is on the trip's critical path.  The chain warps store nothing to
// device memory inside the loop: the helpers write every record, the
// trip's (t, h_eff) included.  Measured with clock64() (PERF.md), a trip at
// 8 lanes is ~1,000 cycles of chain, ~150 of controller and ~450 of
// publishing (~300 of them the knot load from L2); the chain part grows
// with the lanes (~2,100 cycles at 128).
//
// hh_rk4_kernel: lanes share nothing (no clock), so they spread over
// blocks, kRk4Lanes per block (ops/hh_solve.py::rk4_geometry).  Warp 0 holds
// one consumer thread per lane; the other warps are producers, thread p
// owning (lane, rate q) pairs q = 0..11 (the 12 distinct rates of an RK4
// substep: k1..k4 at t, t + h/2, t + h; k2 and k3 share t + h/2).  They
// fill chunks of kChunk substeps into a two-slot shared-memory ring; an
// mbarrier per slot says full (producer arrivals) and one says empty (the
// consumer warp's arrival), so producers run up to two chunks ahead.  A
// consumer's substep is the RK4 stage sums alone, from three 16-byte
// shared-memory loads of its rates; every n_sub substeps it stores the
// state, [n_out, B, 2].
//
// Arithmetic follows the plain versions' f32 order: round-to-nearest
// intrinsics so the compiler cannot contract multiply-adds into FMAs, each
// value computed by the same operations in the same order whatever the
// layout (scripts/time_fit_torch.py hashes the records and traces of two
// checkouts); build without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 128;
constexpr int kMaxThreads = 512;   // hh_solve.py: MAX_THREADS
constexpr int kRates = 20;         // 5 stage voltages x k1..k4
constexpr int kRecs = 8;           // start y and 7 stages, float2 each
constexpr int kRk4Rates = 12;      // 3 voltages x k1..k4
constexpr int kChunk = 32;         // RK4 substeps per ring slot
constexpr int kRk4Lanes = 2;       // RK4 lanes per block (hh_solve.py:
                                   // RK4_LANES)

// Dormand-Prince 5(4) tableau, each entry the f32 rounding of its f64
// value; a compile-time constant, so the zero entries drop out of the
// unrolled sums and the others become immediates
struct Tab {
  float c[7], a[7][7], e[7];
};
#define F(x) ((float)(x))
__host__ __device__ constexpr Tab tableau() {
  return Tab{
      {0.f, F(1.0 / 5), F(3.0 / 10), F(4.0 / 5), F(8.0 / 9), 1.f, 1.f},
      {{0, 0, 0, 0, 0, 0, 0},
       {F(1.0 / 5), 0, 0, 0, 0, 0, 0},
       {F(3.0 / 40), F(9.0 / 40), 0, 0, 0, 0, 0},
       {F(44.0 / 45), F(-56.0 / 15), F(32.0 / 9), 0, 0, 0, 0},
       {F(19372.0 / 6561), F(-25360.0 / 2187), F(64448.0 / 6561),
        F(-212.0 / 729), 0, 0, 0},
       {F(9017.0 / 3168), F(-355.0 / 33), F(46732.0 / 5247), F(49.0 / 176),
        F(-5103.0 / 18656), 0, 0},
       {F(35.0 / 384), 0, F(500.0 / 1113), F(125.0 / 192),
        F(-2187.0 / 6784), F(11.0 / 84), 0}},
      {F(35.0 / 384 - 5179.0 / 57600), F(0.0 - 0.0),
       F(500.0 / 1113 - 7571.0 / 16695), F(125.0 / 192 - 393.0 / 640),
       F(-2187.0 / 6784 - -92097.0 / 339200), F(11.0 / 84 - 187.0 / 2100),
       F(0.0 - 1.0 / 40)}};
}
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

// A lane's rates as (factor, exponent coefficient) pairs: k_r = pa[r] *
// expf(pb[r] * v) with pb = (p1, -p3, p5, -p7) (the negation is exact)
struct Coef {
  float pa[4], pb[4];
  __device__ void load(const float* p, bool on) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[r] = on ? p[2 * r] : 0.f;
      const float e = on ? p[2 * r + 1] : 0.f;
      pb[r] = (r & 1) ? -e : e;
    }
  }
  // rate r (a compile-time constant where the caller's loop is unrolled)
  __device__ __forceinline__ float rate(int r, float v) const {
    const float a = r == 0 ? pa[0] : r == 1 ? pa[1] : r == 2 ? pa[2] : pa[3];
    const float b = r == 0 ? pb[0] : r == 1 ? pb[1] : r == 2 ? pb[2] : pb[3];
    return mul(a, expf(mul(b, v)));
  }
};

// d[a, r]/dt of one lane from its rates k1..k4 at the stage's voltage
__device__ __forceinline__ void hh_deriv(float k1, float k2, float k3,
                                         float k4, float a, float r,
                                         float* da, float* dr) {
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

// Named barriers of the trip kernel (0 is __syncthreads): kVolts, the
// chain warps' stage voltages (and whether a next trip runs) are in shared
// memory; kRates, the helpers' rates are; kChain, among the chain warps.
// bar.arrive releases this thread's shared-memory writes to whoever
// bar.syncs on the same barrier.
constexpr int kVolts = 1, kRatesReady = 2, kChain = 3;

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// barrier among n threads that also ORs their predicates
__device__ __forceinline__ bool named_or(int id, int n, bool pred) {
  int r;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.s32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\n"
      "selp.s32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(r)
      : "r"((int)pred), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// G helper threads per lane (threads past the chain warps): helper h serves
// lane h % B as member h / B and computes its rates j = member, member + G,
// ... < 20 and copies its records q = member, member + G, ... < 8.
template <int G>
__global__ void __launch_bounds__(kMaxThreads, 1) hh_trip_kernel(TripArgs a) {
  __shared__ float rates[kRates][kMaxLanes];     // rate j of lane l: [j][l]
  __shared__ float2 recs[2][kRecs][kMaxLanes];   // by trip parity
  __shared__ __align__(16) float volts[8];       // 5 stage voltages, go
                                                 // flag, t, h_eff
  __shared__ __align__(16) unsigned red[4];      // a partial per chain warp
  const int tid = threadIdx.x, wl = tid & 31, warp = tid >> 5;
  const int chain_warps = (a.b + 31) >> 5, n_chain = 32 * chain_warps;
  const int n_all = blockDim.x;
  const int hi = a.n_pad - 130;

  if (tid >= n_chain) {
    // ---- helpers: the rates of each trip, then the last trip's records --
    const int h = tid - n_chain, lane = h % a.b, g = h / a.b;
    const bool on = g < G;
    Coef co;
    co.load(a.params + lane * 8, on);
    float2* rec_y = reinterpret_cast<float2*>(a.rec_y);
    float2* rec_k = reinterpret_cast<float2*>(a.rec_k);
    for (size_t k = 0;; ++k) {
      named_sync(kVolts, n_all);
      const bool go = volts[5] != 0.f;
      if (go && h == 0) {  // trip k starts at t with step h_eff
        a.rec_sc[k * 2] = volts[6];
        a.rec_sc[k * 2 + 1] = volts[7];
      }
      if (go) {
#pragma unroll
        for (int j0 = 0; j0 < kRates; j0 += G) {
          const int q = j0 + g;
          if (on && q < kRates) rates[q][lane] = co.rate(q & 3, volts[q >> 2]);
        }
        named_arrive(kRatesReady, n_all);
      }
      if (k > 0 && on) {  // the records of trip k - 1
        const size_t i = k - 1;
#pragma unroll
        for (int q0 = 0; q0 < kRecs; q0 += G) {
          const int q = q0 + g;
          if (q >= kRecs) break;
          const float2 r = recs[i & 1][q][lane];
          if (q == 0)
            rec_y[i * a.b + lane] = r;
          else
            rec_k[(i * 7 + q - 1) * a.b + lane] = r;
        }
      }
      if (!go) return;
    }
  }

  // ---- chain warps: thread l runs lane l's chain and the controller ----
  const int lane = tid;
  const bool chain = lane < a.b;
  constexpr Tab T = tableau();
  Coef co;
  co.load(a.params + (chain ? lane : 0) * 8, chain);
  float y[2] = {0.f, 1.f}, f[2] = {0.f, 0.f};
  bool alive = false;
  if (chain) {
    y[0] = a.y0[lane * 2];
    y[1] = a.y0[lane * 2 + 1];
    const float v = voltage(a.vpad, hi, a.t0, a.inv_dt, a.t0);
    hh_deriv(co.rate(0, v), co.rate(1, v), co.rate(2, v), co.rate(3, v),
             y[0], y[1], &f[0], &f[1]);
    // lanes arriving non-finite, or with a non-finite RHS at the start, are
    // dead from the start and reset to rest
    alive = isfinite(y[0]) && isfinite(y[1]) && isfinite(f[0]) &&
            isfinite(f[1]);
    if (!alive) {
      y[0] = 0.f;
      y[1] = 1.f;
      f[0] = 0.f;
      f[1] = 0.f;
    }
  }
  if (tid < 4) red[tid] = 0u;  // slots past chain_warps stay 0
  const bool any0 = chain_warps == 1 ? __any_sync(0xffffffffu, alive)
                                     : named_or(kChain, n_chain, alive);

  float t = a.t0, h = a.h0, r_prev = 0.f;
  bool pend = false;
  int n_acc = 0, blk = 0;
  const int n_blocks = a.trips / a.block;
  bool go = blk < n_blocks && t < a.t_end && any0;
  // publish the next trip's stage voltages (lane s < 5 of warp 0: stage
  // s + 1's), whether it runs, its t and h_eff: volts[0..7]
  const float c_lane = wl == 0 ? T.c[1] : wl == 1 ? T.c[2] : wl == 2 ? T.c[3]
                     : wl == 3 ? T.c[4] : wl == 4 ? T.c[5] : 0.f;
  auto publish = [&]() {
    if (warp == 0) {
      const float h_eff = fmaxf(fminf(h, sub(a.t_end, t)), 1e-8f);
      float x = voltage(a.vpad, hi, a.t0, a.inv_dt,
                        add(t, mul(c_lane, h_eff)));
      x = wl == 5 ? (go ? 1.f : 0.f) : wl == 6 ? t : wl == 7 ? h_eff : x;
      if (wl < 8) volts[wl] = x;
    }
    named_arrive(kVolts, n_all);
  };
  publish();
  for (size_t i = 0, j = 1; go; ++i, ++j) {  // j: trips into the block
    const float h_eff = fmaxf(fminf(h, sub(a.t_end, t)), 1e-8f);
    named_sync(kRatesReady, n_all);

    float rc = 0.f, y1[2] = {0.f, 0.f}, f1[2] = {0.f, 0.f};
    bool live = false;  // the lane was live when this trip began
    if (chain) {
      float rt[kRates];  // all 20 loads issued before the chain needs them
#pragma unroll
      for (int q = 0; q < kRates; ++q) rt[q] = rates[q][lane];
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
            if (T.a[si][sj] != 0.f)
              acc = add(acc, mul(mul(h_eff, T.a[si][sj]), k[sj][c]));
          yi[c] = acc;
        }
        const int s = (si < 5 ? si : 5) - 1;  // stage 6 reuses stage 5's
        hh_deriv(rt[4 * s], rt[4 * s + 1], rt[4 * s + 2], rt[4 * s + 3],
                 yi[0], yi[1], &k[si][0], &k[si][1]);
      }
      float sc[2], e[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float y1c = y[c], err = 0.f;
#pragma unroll
        for (int sj = 0; sj < 7; ++sj) {
          if (T.a[6][sj] != 0.f)
            y1c = add(y1c, mul(mul(h_eff, T.a[6][sj]), k[sj][c]));
          if (T.e[sj] != 0.f)
            err = add(err, mul(mul(h_eff, T.e[sj]), k[sj][c]));
        }
        y1[c] = y1c;
        sc[c] = add(a.atol, mul(a.rtol, nanmax(fabsf(y[c]), fabsf(y1c))));
        // a zero error skips the division's slow path: 0 / sc is +0 for
        // any positive sc, and a NaN sc poisons r below anyway
        e[c] = err == 0.f ? 0.f : __fdiv_rn(err, sc[c]);
      }
      // x / 2 and x * 0.5 round the same exact value: identical bits
      float r = __fsqrt_rn(mul(add(mul(e[0], e[0]), mul(e[1], e[1])), 0.5f));
      // NaN-poison r with scale * 0 so a non-finite y1 reads as bad too
      r = add(r, mul(add(sc[0], sc[1]), 0.f));
      const bool bad = !(r < INFINITY);
      rc = bad ? 3.4e38f : r;

      // this trip's own attempt, for the helpers to copy: start y and the
      // 7 stages
      recs[i & 1][0][lane] = make_float2(y[0], y[1]);
#pragma unroll
      for (int sj = 0; sj < 7; ++sj)
        recs[i & 1][sj + 1][lane] = make_float2(k[sj][0], k[sj][1]);

      live = alive;
      const bool pass = !bad && r <= 1.f;
      alive = alive && (pass || h_eff > 2e-7f);
      f1[0] = k[6][0];
      f1[1] = k[6][1];
      r_prev = rc;
    }
    // the launch's ratio: max over LIVE lanes (rc >= +0 and never NaN: the
    // bits order as the floats; 0 is neutral)
    unsigned m =
        __reduce_max_sync(0xffffffffu, __float_as_uint(live ? rc : 0.f));
    if (chain_warps > 1) {
      if (wl == 0) red[warp] = m;
      named_sync(kChain, n_chain);
      const uint4 pr = *reinterpret_cast<const uint4*>(red);
      m = max(max(pr.x, pr.y), max(pr.z, pr.w));
    }
    const float ratio = __uint_as_float(m);
    const bool accept = ratio <= 1.f;
    if (accept && alive) {  // alive is false off the chain lanes
      y[0] = y1[0];
      y[1] = y1[1];
      f[0] = f1[0];
      f[1] = f1[1];
    }
    if (accept) {
      t = add(t, h_eff);
      ++n_acc;
    }
    const float factor =
        mul(0.9f, expf(mul(-0.2f, logf(fmaxf(ratio, 1e-10f)))));
    h = mul(h_eff, fminf(fmaxf(factor, 0.2f), accept ? 10.f : 1.f));

    if (j == (size_t)a.block) {
      j = 0;
      // pace cull, binding-ratio form: once half the trips are spent and t
      // lags the trip fraction by > 0.3, a lane whose last error ratio is
      // > 0.01 binds the shared controller; two blocks in a row as a
      // candidate kill it
      if (chain) {
        const float spent = (float)((blk + 1) * a.block);
        const float frac_spent = __fdiv_rn(spent, a.trips_f);
        const float t_frac = __fdiv_rn(sub(t, a.t0), a.span);
        const bool behind =
            frac_spent >= 0.5f && t_frac < sub(frac_spent, 0.3f);
        const bool cand = behind && r_prev > 0.01f;
        if (cand && pend) alive = false;
        pend = cand;
      }
      const bool any = chain_warps == 1
                           ? __any_sync(0xffffffffu, alive)
                           : named_or(kChain, n_chain, alive);
      ++blk;
      go = blk < n_blocks && t < a.t_end && any;
    }
    publish();
  }

  if (chain) a.alive_out[lane] = alive ? 1 : 0;
  if (tid == 0) {
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival (release: this thread's shared-memory writes before it are
// seen by whoever completes a wait on the phase)
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the mbarrier's phase with this parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Block: warp 0 the consumers (thread l runs lane l0 + l), warps 1.. the
// producers.  Slot s of the ring holds chunk c = s, s + 2, ...; chunk c is
// the substeps u = c kChunk .. of the launch, u = (oi - 1) n_sub + i.
constexpr int kRk4Producers = (kRk4Lanes * kRk4Rates + 31) / 32 * 32;
constexpr int kRk4Threads = 32 + kRk4Producers;

__global__ void __launch_bounds__(kRk4Threads, 1) hh_rk4_kernel(Rk4Args a) {
  constexpr int slot = kChunk * kRk4Lanes * kRk4Rates;
  __shared__ __align__(16) float ring[2 * slot];  // [2][kChunk][lanes][12]
  __shared__ uint64_t full[2], empty[2];
  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kRk4Lanes, nl = min(kRk4Lanes, a.b - l0);
  const int n_prod = kRk4Producers;
  const int hi = a.n_knots - 2;
  const int total = (a.n_out - 1) * a.n_sub;
  const int chunks = (total + kChunk - 1) / kChunk;
  if (tid == 0) {
    bar_init(&full[0], n_prod);
    bar_init(&full[1], n_prod);
    bar_init(&empty[0], 1);
    bar_init(&empty[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 32) {
    // ---- producers: (lane, q) pairs p, p + n_prod, ... ----
    const int p = tid - 32;
    for (int c = 0; c < chunks; ++c) {
      const int s = c & 1;
      if (c >= 2) bar_wait(&empty[s], ((c >> 1) - 1) & 1);
      float* buf = ring + s * slot;
      const int u0 = c * kChunk, un = min(kChunk, total - u0);
      for (int e = p; e < nl * kRk4Rates; e += n_prod) {
        const int l = e / kRk4Rates, q = e - l * kRk4Rates;
        const int vi = q >> 2;  // 0: t, 1: t + h/2, 2: t + h
        Coef co;
        co.load(a.params + (size_t)(l0 + l) * 8, true);
        int oi = u0 / a.n_sub + 1, ii = u0 - (oi - 1) * a.n_sub;
        for (int k = 0; k < un; ++k) {
          const float tbase = add(a.t0, mul((float)(oi - 1), a.dt_out));
          const float tt = add(tbase, mul((float)ii, a.h));
          const float tv = vi == 0 ? tt : add(tt, vi == 1 ? a.half_h : a.h);
          buf[(k * kRk4Lanes + l) * kRk4Rates + q] =
              co.rate(q & 3, voltage(a.v, hi, a.t0, a.inv_dt, tv));
          if (++ii == a.n_sub) {
            ii = 0;
            ++oi;
          }
        }
      }
      bar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers: the RK4 chain of lane l0 + tid ----
  const bool on = tid < nl;
  float2* out = reinterpret_cast<float2*>(a.out);
  float ya = a.a0, yr = a.r0;
  if (on) out[l0 + tid] = make_float2(ya, yr);
  int oi = 1, ii = 0;
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    bar_wait(&full[s], (c >> 1) & 1);
    const float* buf = ring + s * slot + tid * kRk4Rates;
    const int un = min(kChunk, total - c * kChunk);
    if (on) {
      for (int k = 0; k < un; ++k) {
        const float4* rk =
            reinterpret_cast<const float4*>(buf + k * kRk4Lanes * kRk4Rates);
        const float4 ra = rk[0], rb = rk[1], rc = rk[2];  // at t, t+h/2, t+h
        float k1[2], k2[2], k3[2], k4[2];
        hh_deriv(ra.x, ra.y, ra.z, ra.w, ya, yr, &k1[0], &k1[1]);
        hh_deriv(rb.x, rb.y, rb.z, rb.w, add(ya, mul(a.half_h, k1[0])),
                 add(yr, mul(a.half_h, k1[1])), &k2[0], &k2[1]);
        hh_deriv(rb.x, rb.y, rb.z, rb.w, add(ya, mul(a.half_h, k2[0])),
                 add(yr, mul(a.half_h, k2[1])), &k3[0], &k3[1]);
        hh_deriv(rc.x, rc.y, rc.z, rc.w, add(ya, mul(a.h, k3[0])),
                 add(yr, mul(a.h, k3[1])), &k4[0], &k4[1]);
        ya = add(ya, mul(a.h6, add(add(add(k1[0], mul(2.f, k2[0])),
                                       mul(2.f, k3[0])), k4[0])));
        yr = add(yr, mul(a.h6, add(add(add(k1[1], mul(2.f, k2[1])),
                                       mul(2.f, k3[1])), k4[1])));
        if (++ii == a.n_sub) {
          out[(size_t)oi * a.b + l0 + tid] = make_float2(ya, yr);
          ii = 0;
          ++oi;
        }
      }
    }
    __syncwarp();
    if (tid == 0) bar_arrive(&empty[s]);
  }
}

}  // namespace

// scal: t0, 1/dt_knot, h0, t_end, t_end - t0, rtol, atol, (float)trips.
// group: the helper threads per lane that hh_solve.py::hh_trip_geometry
// picks; layout gets (group, threads, chain warps) as launched.
extern "C" int ionflux_hh_trip_solve(
    const float* vpad, const float* params, const float* y0, float* rec_sc,
    float* rec_y, float* rec_k, int* n_out, uint8_t* alive_out, int b,
    int n_pad, int trips, int block, int group, const float* scal,
    int* layout, void* stream) {
  // the chain warps, then the helpers
  const int threads = (b + 31) / 32 * 32 + (b * group + 31) / 32 * 32;
  if (b < 1 || b > kMaxLanes || n_pad < 131 || block < 1 || trips < block ||
      trips % block != 0 || group < 1 || threads > kMaxThreads)
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {  // the rule's choices (hh_solve.py: TRIP_GROUPS)
    case 20: hh_trip_kernel<20><<<1, threads, 0, s>>>(a); break;
    case 10: hh_trip_kernel<10><<<1, threads, 0, s>>>(a); break;
    case 5: hh_trip_kernel<5><<<1, threads, 0, s>>>(a); break;
    case 4: hh_trip_kernel<4><<<1, threads, 0, s>>>(a); break;
    case 3: hh_trip_kernel<3><<<1, threads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  layout[0] = group;
  layout[1] = threads;
  layout[2] = (b + 31) / 32;
  return (int)cudaGetLastError();
}

// scal: t0, 1/dt_knot, dt_out, h, h/2, h/6, a0, r0.  layout gets (lanes per
// block, blocks, threads) as launched.
extern "C" int ionflux_hh_rk4(const float* v, const float* params, float* out,
                              int b, int n_knots, int n_out, int n_sub,
                              const float* scal, int* layout, void* stream) {
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
  const int blocks = (b + kRk4Lanes - 1) / kRk4Lanes;
  hh_rk4_kernel<<<blocks, kRk4Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  layout[0] = kRk4Lanes;
  layout[1] = blocks;
  layout[2] = kRk4Threads;
  return (int)cudaGetLastError();
}

extern "C" const char* ionflux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
