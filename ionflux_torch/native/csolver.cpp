// Native host ODE solver: the port's own copy of ionflux/native/csolver.cpp
// (the same source, compiled with the same flags, so both packages compute
// the same numbers).  A C++ adaptive Dormand-Prince 5(4) integrator for the
// HH (2-state) and Markov (6-state) IKr models with piecewise-linear
// voltage-protocol lookup, dense quartic output, a wall-clock watchdog (the
// reference's Myokit ProgressReporter timeout, train-d0.py:143-155), and
// inf-trace failure sentinels (train-d0.py:427-438); the rebuild of the
// reference's optional Myokit/CVODE fast path (train-d0.py:128-297).
//
// Exposed through a plain C ABI and bound with ctypes
// (ionflux_torch/native/__init__.py); a host-side oracle and the d0 fit's
// --myokit objective.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <chrono>
#include <limits>
#include <vector>

namespace {

constexpr int kStages = 7;

// Dormand-Prince 5(4) tableau (Hairer I, Table 5.2)
constexpr double kC[kStages] = {0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0, 1.0};
constexpr double kA[kStages][kStages] = {
    {},
    {1.0 / 5},
    {3.0 / 40, 9.0 / 40},
    {44.0 / 45, -56.0 / 15, 32.0 / 9},
    {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729},
    {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656},
    {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84},
};
constexpr double kBErr[kStages] = {
    35.0 / 384 - 5179.0 / 57600,   0.0,
    500.0 / 1113 - 7571.0 / 16695, 125.0 / 192 - 393.0 / 640,
    -2187.0 / 6784 + 92097.0 / 339200,
    11.0 / 84 - 187.0 / 2100,      -1.0 / 40,
};
// Shampine dense-output polynomial (powers theta..theta^4)
constexpr double kP[kStages][4] = {
    {1.0, -8048581381.0 / 2820520608, 8663915743.0 / 2820520608,
     -12715105075.0 / 11282082432},
    {0, 0, 0, 0},
    {0, 131558114200.0 / 32700410799, -68118460800.0 / 10900136933,
     87487479700.0 / 32700410799},
    {0, -1754552775.0 / 470086768, 14199869525.0 / 1410260304,
     -10690763975.0 / 1880347072},
    {0, 127303824393.0 / 49829197408, -318862633887.0 / 49829197408,
     701980252875.0 / 199316789632},
    {0, -282668133.0 / 205662961, 2019193451.0 / 616988883,
     -1453857185.0 / 822651844},
    {0, 40617522.0 / 29380423, -110615467.0 / 29380423,
     69997945.0 / 29380423},
};

struct Protocol {
  double t0, dt;
  const double* v;
  int64_t n;
  double at(double t) const {  // linear interp, -80 mV fallback
    double x = (t - t0) / dt;
    if (x < 0.0 || x > double(n - 1)) return -80.0;
    int64_t i = int64_t(x);
    if (i > n - 2) i = n - 2;
    double w = x - double(i);
    return v[i] + w * (v[i + 1] - v[i]);
  }
};

// dy/dt for the 8-parameter HH model (train-s1.py:169-175)
inline void hh_rhs(const double* p, double v, const double* y, double* dy) {
  const double k1 = p[0] * std::exp(p[1] * v);
  const double k2 = p[2] * std::exp(-p[3] * v);
  const double k3 = p[4] * std::exp(p[5] * v);
  const double k4 = p[6] * std::exp(-p[7] * v);
  dy[0] = k1 * (1.0 - y[0]) - k2 * y[0];
  dy[1] = -k3 * y[1] + k4 * (1.0 - y[1]);
}

// dy/dt for the 12-parameter 3-state Markov model (train-d1.py:173-187)
inline void markov_rhs(const double* p, double v, const double* y, double* dy) {
  const double a1 = p[0] * std::exp(p[1] * v);
  const double b1 = p[2] * std::exp(-p[3] * v);
  const double bh = p[4] * std::exp(p[5] * v);
  const double ah = p[6] * std::exp(-p[7] * v);
  const double a2 = p[8] * std::exp(p[9] * v);
  const double b2 = p[10] * std::exp(-p[11] * v);
  const double c1 = y[0], c2 = y[1], i = y[2], ic1 = y[3], ic2 = y[4], o = y[5];
  dy[0] = a1 * c2 + ah * ic1 + b2 * o - (b1 + bh + a2) * c1;
  dy[1] = b1 * c1 + ah * ic2 - (a1 + bh) * c2;
  dy[2] = a2 * ic1 + bh * o - (b2 + ah) * i;
  dy[3] = a1 * ic2 + bh * c1 + b2 * i - (b1 + ah + a2) * ic1;
  dy[4] = b1 * ic1 + bh * c2 - (ah + a1) * ic2;
  dy[5] = a2 * c1 + ah * i - (b2 + bh) * o;
}

template <int S, typename RHS>
int solve(const RHS& rhs, const double* params, const Protocol& proto,
          const double* y0, const double* ts, int64_t n_ts, double* out,
          double rtol, double atol, int64_t max_steps, double timeout_s) {
  using clock = std::chrono::steady_clock;
  const auto start = clock::now();
  const double t_end = ts[n_ts - 1];
  double t = ts[0];
  double y[S], y1[S], k[kStages][S], yi[S], err[S];
  std::memcpy(y, y0, sizeof(y));
  rhs(params, proto.at(t), y, k[0]);

  // Hairer starting step
  double h = 1e-2;
  {
    double d0 = 0, d1 = 0;
    for (int s = 0; s < S; ++s) {
      const double sc = atol + rtol * std::fabs(y[s]);
      d0 += (y[s] / sc) * (y[s] / sc);
      d1 += (k[0][s] / sc) * (k[0][s] / sc);
    }
    d0 = std::sqrt(d0 / S);
    d1 = std::sqrt(d1 / S);
    if (d0 >= 1e-5 && d1 >= 1e-5) h = 0.01 * d0 / d1;
    if (!(h > 0) || !std::isfinite(h)) h = 1e-6;
  }

  int64_t oi = 0;
  out[oi * S + 0] = y[0];
  for (int s = 1; s < S; ++s) out[oi * S + s] = y[s];
  ++oi;

  const double inf = std::numeric_limits<double>::infinity();
  int64_t n_step = 0;
  while (t < t_end) {
    if (++n_step > max_steps) goto fail;
    if (timeout_s > 0 &&
        std::chrono::duration<double>(clock::now() - start).count() > timeout_s)
      goto fail;
    double h_eff = std::min(h, t_end - t);
    if (h_eff < 1e-14 * std::max(1.0, std::fabs(t_end))) goto fail;

    for (int i = 1; i < kStages; ++i) {
      for (int s = 0; s < S; ++s) {
        double acc = y[s];
        for (int j = 0; j < i; ++j) acc += h_eff * kA[i][j] * k[j][s];
        yi[s] = acc;
      }
      rhs(params, proto.at(t + kC[i] * h_eff), yi, k[i]);
    }
    double ratio2 = 0.0;
    bool finite = true;
    for (int s = 0; s < S; ++s) {
      double acc = y[s], e = 0.0;
      for (int j = 0; j < kStages; ++j) {
        acc += h_eff * kA[6][j] * k[j][s];
        e += h_eff * kBErr[j] * k[j][s];
      }
      y1[s] = acc;
      err[s] = e;
      if (!std::isfinite(acc)) finite = false;
      const double sc = atol + rtol * std::max(std::fabs(y[s]), std::fabs(acc));
      ratio2 += (e / sc) * (e / sc);
    }
    const double ratio = std::sqrt(ratio2 / S);
    const bool accept = finite && ratio <= 1.0;

    if (accept) {
      // dense output for every requested time in (t, t+h_eff]
      while (oi < n_ts && ts[oi] <= t + h_eff + 1e-12) {
        double th = (ts[oi] - t) / h_eff;
        if (th < 0) th = 0;
        if (th > 1) th = 1;
        const double tp[4] = {th, th * th, th * th * th, th * th * th * th};
        for (int s = 0; s < S; ++s) {
          double acc = y[s];
          for (int j = 0; j < kStages; ++j) {
            double bj = 0.0;
            for (int m = 0; m < 4; ++m) bj += kP[j][m] * tp[m];
            acc += h_eff * bj * k[j][s];
          }
          out[oi * S + s] = acc;
        }
        ++oi;
      }
      t += h_eff;
      std::memcpy(y, y1, sizeof(y));
      std::memcpy(k[0], k[kStages - 1], sizeof(k[0]));  // FSAL
    }
    double factor = 0.9 * std::pow(std::max(ratio, 1e-10), -0.2);
    if (!std::isfinite(factor)) factor = 0.2;
    factor = std::min(factor, accept ? 10.0 : 1.0);
    factor = std::max(factor, 0.2);
    h = h_eff * factor;
  }
  while (oi < n_ts) {  // trailing duplicates of t_end
    for (int s = 0; s < S; ++s) out[oi * S + s] = y[s];
    ++oi;
  }
  return 0;

fail:
  for (int64_t i = 0; i < n_ts * S; ++i) out[i] = inf;
  return 1;
}

}  // namespace

extern "C" {

// returns 0 on success; 1 on failure (out filled with inf — the timeout
// sentinel semantics of train-d0.py:427-438)
int ionflux_solve_hh(const double* params8, double proto_t0, double proto_dt,
                     const double* knots, int64_t n_knots, const double* y0,
                     const double* ts, int64_t n_ts, double* out, double rtol,
                     double atol, int64_t max_steps, double timeout_s) {
  Protocol proto{proto_t0, proto_dt, knots, n_knots};
  return solve<2>(hh_rhs, params8, proto, y0, ts, n_ts, out, rtol, atol,
                  max_steps, timeout_s);
}

int ionflux_solve_markov(const double* params12, double proto_t0,
                         double proto_dt, const double* knots,
                         int64_t n_knots, const double* y0, const double* ts,
                         int64_t n_ts, double* out, double rtol, double atol,
                         int64_t max_steps, double timeout_s) {
  Protocol proto{proto_t0, proto_dt, knots, n_knots};
  return solve<6>(markov_rhs, params12, proto, y0, ts, n_ts, out, rtol, atol,
                  max_steps, timeout_s);
}

}  // extern "C"
