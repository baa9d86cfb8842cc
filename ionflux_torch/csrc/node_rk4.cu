// Neural-ODE training through a fixed-step RK4 solve of NN-f on Hopper: the
// solve's forward pass and its vector-Jacobian product, one launch each.
//
// Replaces no TPU kernel.  JAX differentiates odeint_rk4 (ionflux/solver/
// fixed.py, each output interval under jax.checkpoint) through XLA; the port
// ran the same algorithm as two captured CUDA graphs of solver/fixed.py::
// _interval (its forward and its vector-Jacobian product, ~3,500 kernels a
// replay), replayed once per output interval each (scripts/
// train_neural_ode_torch.py::Trainer).  These two kernels run the same
// arithmetic for a whole solve per launch.  The wrapper, the size rule and
// the plain PyTorch versions are in ionflux_torch/ops/node_rk4.py.
//
// The model (nnf_rhs): da/dt = MLP([V / 100, a]) / 1000 with LeakyReLU 0.01
// on every hidden layer, dr/dt = -k3 r + k4 (1 - r), k3 = p5 exp(p6 V), k4 =
// p7 exp(-p8 V), V(t) the protocol's linear interpolation (protocols.
// voltage: clamped index, the holding voltage outside the domain).  Each
// output interval [t0, t1] takes n_sub classic RK4 steps of h = (t1 - t0) /
// n_sub from t0 + i h, as _interval does, in the same f32 operations
// (round-to-nearest intrinsics, so nothing is contracted into an FMA): only
// the MLP's sum order differs from the graphs' (build without
// --use_fast_math).
//
// node_fwd: one solve from y0; writes ys [n_t, 2] and every substep's
// starting state [n_t - 1, n_sub, 2].
// node_vjp: the solve's vector-Jacobian product for the cotangent g_ys of
// ys: the intervals last first, each interval's substeps in reverse.  The
// substeps' 4 stages are recomputed from their stored starting states,
// kBatch (4) substeps at a time as the rows of one layer pass (they are
// independent given their starts), keeping every layer's input on chip;
// then each substep's reverse pass of stages 4..1: the LeakyReLU
// derivative, the transposed products, the r-gate's scalar linear
// cotangent (r's rate depends on neither a nor the net), and the stage
// cotangents of RK4 (k3 += h gu4, k2 += h/2 gu3, k1 += h/2 gu2).  The
// parameter gradient of an interval is summed on chip and added into the
// output once per interval, as the graph path adds each interval's VJP into
// its accumulator; g_ys[k] is added at each output boundary.
//
// Design.  One thread-block cluster of C blocks (C = 8 or 16, the wrapper's
// size rule ops/node_rk4.py::node_cluster), one per SM, 256 threads each.
//
//   * Weights: block `rank` holds its rank's row of ops/fused_solve.py::
//     _cluster_pack (as mlp_cluster in fused_solve.cu: the column slices
//     [rank cols, (rank + 1) cols) of every hidden layer, [in, cols] then
//     the biases, layer 0 and the last layer whole), copied into shared
//     memory once per launch by one bulk copy per layer (the TMA engine) on
//     one mbarrier.  The published 2 -> 200 x 6 -> 1 net is 802 KB; at C =
//     16 a row is 59.5 KB.
//   * Shared memory per block, node_vjp (node_fwd keeps only the weights,
//     one row of layer inputs and the stage voltages): the weight row, the
//     interval's gradient in the same layout, every layer's input for the 4
//     stages of kBatch substeps [4][L][wmax][kBatch], the stages' output
//     cotangents of this block's own columns [4][L][cmax], a reduce buffer
//     [C][cmax] a layer and two scalar buffers [C], the interval's stage
//     voltages and substep states: 212 KB at C = 16 for the published net.
//     At C = 8 its two rows alone take 216 KB of the 227 KB a block may
//     have, so the size rule takes the smallest of 8 and 16 that fits (16
//     is the non-portable cluster size; the launch sets the attribute; C =
//     8 ran node_fwd no faster, 48.1 against 47.4 ms).  The gradient stays
//     in shared memory, not in registers, so any net the rule admits runs
//     with one instantiation.
//   * Forward layer pass: layer 0 (2 inputs) is computed whole in every
//     block.  A hidden layer: each of the block's columns is summed by KS
//     lanes of one warp (KS the largest power of two <= 32 with cols x KS <=
//     256: 16 lanes of ~13 k each at C = 16), each over a k-strided part,
//     then added by a fixed xor-shuffle tree (every lane of the group ends
//     with the same bits: a + b == b + a); + bias, LeakyReLU; lane q of the
//     group stores the output into the layer-input buffer of blocks q, q +
//     KS, ... (st.async through DSMEM, one store of all the rows).  The
//     last layer (one output) is whole in every block: warp 0, lane-strided
//     k, the same tree.  Every block thus holds bit-identical layer inputs,
//     and every thread of every block runs the replicated scalar state (a,
//     r, t, the stage combinations) in registers with the same bits.
//   * Reverse layer pass: the last layer's input cotangent for the block's
//     own part, locally; a hidden layer l: thread k sums W_l[k][c] dz[c]
//     over the block's own columns c (its partial of W dz) and stores it
//     into the reduce buffer of the block that owns k (in layer l-1's
//     column partition: its slice, or for layer 0 ceil(out / C) rounded to
//     2); the owner adds the C partials in rank order: the same result on
//     every run.  Layer 0: warp 0 sums W0[1][j] dz0[j] over the block's own
//     j by the shuffle tree and stores it into every block's scalar buffer;
//     every thread adds the C partials in rank order: d/da of the net's
//     input, identical everywhere.  5 exchanges a forward evaluation and 6
//     a reverse one for the published net.
//   * Exchanges: each receive buffer has an mbarrier; a store completes 4
//     bytes of its transaction count (st.async ... mbarrier::complete_tx),
//     and the receiving block waits for the bytes it expects, not for the
//     cluster.  Each phase is armed (arrive.expect_tx) by thread 0 right
//     after the phase before completed, before any store of it can arrive:
//     the first version armed at the wait, so stores could come first, and
//     its C = 16 launch hung.  Against one cluster barrier per exchange the
//     update took 0.168 against 0.229 s.
//   * Weight and bias gradients: outer products on each block's own columns
//     (layer 0 and the last layer by the partition above, the last bias at
//     rank 0), no exchange: after stage 1's reverse pass, one rank-4 update
//     of the interval's gradient from the 4 stages' layer inputs and
//     cotangents.  At the end of an interval each block adds its row into
//     the output (stored on the first interval) and clears it.  The output
//     is in the packed layout: the wrapper reads each parameter from its
//     owner's row (ops/node_rk4.py::grad_index).
//   * Buffer reuse: a block's stores into a peer's buffer wait on data from
//     every block, so no block runs more than one exchange ahead of
//     another: the layer inputs are per stage slot (4 evaluations apart),
//     the reduce buffers per layer (a stage apart), the scalar buffers
//     alternate.  A substep's gradient update runs before its last store,
//     which lets the peers go on and, after a batch's last substep,
//     overwrite the layer inputs.  Every block leaves through a final
//     cluster barrier.
//
// What bounds it on this card: the dependent chain, not operations or
// bytes.  A solve is 9,600 right-hand sides, each a chain of 7 layer passes
// (5 of them exchanges); the 1.16e10 FLOP an update of the published net
// take 0.17 ms at the card's f32 peak, far under the chain.  A layer pass
// is ~13 dependent FMAs from shared memory, a 4-level shuffle tree and one
// exchange (the stores, their arrival, the wake): ~0.75 us, of which the
// FMAs are ~0.15 us and the shuffles ~0.08 us (PERF.md).
// node_vjp adds the batched recompute and 6 exchanges per reverse stage.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 16;
constexpr int kMaxCluster = 16;
constexpr int kMaxSub = 64;
constexpr int kBatch = 4;      // substeps node_vjp recomputes together
constexpr int kColsStep = 2;   // CLUSTER_COLS in ops/fused_solve.py
constexpr size_t kSmemMax = 232448 - 1024;   // a block's dynamic budget

struct Args {
  const float* w;      // [C, cl_floats]: _cluster_pack's rows
  const float* knots;  // [n_knots] protocol voltages
  const float* p_t0;   // the protocol's t0 and dt (device scalars)
  const float* p_dt;
  const float* ts;     // [n_t] output times
  const float* y0;     // [2]
  float* ys;           // [n_t, 2] (node_fwd)
  float* ystart;       // [n_t - 1, n_sub, 2] (written by node_fwd)
  const float* g_ys;   // [n_t, 2] (node_vjp)
  float* grad;         // [C, cl_floats] (node_vjp)
  int n_knots, n_t, n_sub, n_layers, csize, cl_floats;
  int sizes[kMaxLayers + 1];
  int cl_off[kMaxLayers], cl_cols[kMaxLayers];
  int own[kMaxLayers];  // the partition width of layer l's outputs, l < L-1
  int ks[kMaxLayers];   // lanes that sum one column of hidden layer l
  int wmax, cmax;       // the widest layer input, the widest own part
  float p5, p6, p7, p8, holding;
};

// The dynamic shared memory, in floats, in this order; the layer inputs
// hold `rt` rows (1 in node_fwd, kBatch in node_vjp)
struct Offs {
  int w, g, x, d, r, a, vst, yst, total;
};

__host__ __device__ Offs offsets(const Args& a, bool vjp) {
  const int rt = vjp ? kBatch : 1;
  Offs o;
  int p = 0;
  o.w = p;
  p += a.cl_floats;
  o.g = p;
  p += vjp ? a.cl_floats : 0;
  o.x = p;
  p += 4 * a.n_layers * a.wmax * rt;
  o.d = p;
  p += vjp ? 4 * a.n_layers * a.cmax : 0;
  o.r = p;
  p += vjp ? a.n_layers * a.csize * a.cmax : 0;
  o.a = p;
  p += vjp ? 2 * a.csize : 0;
  o.vst = p;
  p += 4 * a.n_sub;
  o.yst = p;
  p += vjp ? 2 * a.n_sub : 0;
  o.total = p;
  return o;
}

// Each exchange's receive buffer has an mbarrier (static shared memory):
// X(s, l) one per stage slot and layer input, R(l) one per layer, A(b) one
// each
constexpr int kBars = 5 * kMaxLayers + 2;

// A block's buffers.  X(s, l): layer l's input at stage slot s, element
// (k, row) at k * rt + row; D(s, l): the cotangent of layer l's outputs on
// this block's own columns; R(l): the partials of layer l's transposed
// product, [C][cmax]; A(b): the scalar partials, [C].
struct Lay {
  float *w, *g, *x, *d, *r, *a, *vst, *yst;
  int L, wmax, cmax, C, rt;
  uint64_t* mb;  // kBars mbarriers
  __device__ float* X(int s, int l) const {
    return x + (s * L + l) * wmax * rt;
  }
  __device__ float* D(int s, int l) const { return d + (s * L + l) * cmax; }
  __device__ float* R(int l) const { return r + l * C * cmax; }
  __device__ float* A(int b) const { return a + b * C; }
  __device__ uint64_t* barX(int s, int l) const { return mb + s * L + l; }
  __device__ uint64_t* barR(int l) const { return mb + 4 * kMaxLayers + l; }
  __device__ uint64_t* barA(int b) const {
    return mb + 5 * kMaxLayers + b;
  }
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : mul(0.01f, x);
}

// The LeakyReLU's derivative applied to a cotangent, from the layer's
// output y (y >= 0 exactly where its input is, but for inputs so small
// that 0.01 x underflows to -0)
__device__ __forceinline__ float leaky_vjp(float y, float g) {
  return y >= 0.f ? g : mul(g, 0.01f);
}

// The r-gate's rates k3, k4 at V
__device__ __forceinline__ float rate3(const Args& a, float V) {
  return mul(a.p5, expf(mul(a.p6, V)));
}
__device__ __forceinline__ float rate4(const Args& a, float V) {
  return mul(a.p7, expf(mul(-a.p8, V)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Store x[0..RT) at shared address `addr` of block `rank` of the cluster,
// and complete 4 RT bytes of the transaction count of that block's
// mbarrier at `bar` (the same offsets in every block; 16-byte aligned for
// RT = 4)
template <int RT>
__device__ __forceinline__ void st_peer(uint32_t addr, uint32_t bar,
                                        int rank, const float* x) {
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra)
               : "r"(addr), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb)
               : "r"(bar), "r"(rank));
  if constexpr (RT == 4)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
        "{%1, %2, %3, %4}, [%5];\n" ::"r"(ra),
        "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "r"(rb)
        : "memory");
  else
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
        "[%2];\n" ::"r"(ra),
        "f"(x[0]), "r"(rb)
        : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], "
      "%2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Arm an mbarrier's phase for `bytes` of stores: its one arrival
__device__ __forceinline__ void arm(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Receive an exchange of `bytes` (none: nothing to wait for): every
// thread waits for the phase of this parity, then thread 0 arms the next
// phase for the same bytes.  A phase is armed before any store of it can
// arrive: the stores of the next phase follow this block's own later
// stores, which follow a __syncthreads after the arming.  A wait that
// never ends (a byte count that does not match the stores) traps instead
// of hanging the card.
__device__ void receive(uint64_t* bar, uint32_t bytes, uint32_t parity) {
  if (bytes == 0) return;
  const uint32_t b = smem_addr(bar);
  for (uint32_t n = 0; !bar_try(b, parity); ++n)
    if (n > (1u << 24)) {
      printf("node_rk4: block %d thread %d waits on mbarrier %d parity %u "
             "for %u bytes\n", (int)blockIdx.x, (int)threadIdx.x,
             (int)(b & 0xffff), parity, bytes);
      __trap();
    }
  if (threadIdx.x == 0) arm(bar, bytes);
}

// The bytes a block receives in the exchange of layer input l (l >= 2),
// a row, and in the reduce of layer l's transposed product
__device__ __forceinline__ uint32_t x_bytes(const Args& a, int l) {
  return 4u * a.sizes[l];
}
__device__ __forceinline__ uint32_t r_bytes(const Args& a, int l, int rank) {
  const int ow = a.own[l - 1];
  return 4u * a.csize * max(0, min(ow, a.sizes[l] - rank * ow));
}

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

// Copy this block's row of the packed weights into m.w, one bulk copy per
// layer on one mbarrier, and wait for it; initialise and arm the
// exchanges' mbarriers; then every block of the cluster runs before any
// block stores into a peer
__device__ void load_weights(const Args& a, const Lay& m, uint64_t* bar,
                             int rank, bool vjp) {
  if (threadIdx.x == 0) {
    const uint32_t b = smem_addr(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    for (int i = 0; i < kBars; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(m.mb + i))
                   : "memory");
    for (int s = 0; s < 4; ++s)
      for (int l = 2; l < a.n_layers; ++l)
        arm(m.barX(s, l), m.rt * x_bytes(a, l));
    if (vjp) {
      for (int l = 1; l < a.n_layers - 1; ++l)
        if (r_bytes(a, l, rank)) arm(m.barR(l), r_bytes(a, l, rank));
      arm(m.barA(0), 4u * a.csize);
      arm(m.barA(1), 4u * a.csize);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(a.cl_floats * 4)
        : "memory");
    const float* src = a.w + (size_t)rank * a.cl_floats;
    for (int l = 0; l < a.n_layers; ++l) {
      const int end = l + 1 < a.n_layers ? a.cl_off[l + 1] : a.cl_floats;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(m.w + a.cl_off[l])),
          "l"(src + a.cl_off[l]), "r"((end - a.cl_off[l]) * 4), "r"(b)
          : "memory");
    }
  }
  __syncthreads();
  bar_wait(bar, 0);
  cluster_barrier();
}

// V(t): protocols.voltage's clamped linear interpolation, the holding
// voltage outside the knots' domain
__device__ float voltage(const Args& a, float t, float pt0, float pdt) {
  const float x = __fdiv_rn(sub(t, pt0), pdt);
  const int n = a.n_knots;
  if (!(x >= 0.f && x <= (float)(n - 1))) return a.holding;
  const int i = min((int)floorf(x), n - 2);
  const float w = sub(x, (float)i);
  const float lo = a.knots[i], hi = a.knots[i + 1];
  return add(lo, mul(w, sub(hi, lo)));
}

// The interval's stage voltages into m.vst [n_sub][4] (t0 + i h, + h / 2
// twice, + h, as _rk4_step forms them); all threads call it
__device__ void stage_voltages(const Args& a, const Lay& m, float t0,
                               float h) {
  const int tid = threadIdx.x;
  if (tid < 4 * a.n_sub) {
    const int i = tid >> 2, s = tid & 3;
    const float ti = add(t0, mul((float)i, h));
    const float t = s == 0   ? ti
                    : s == 3 ? add(ti, h)
                             : add(ti, mul(0.5f, h));
    m.vst[tid] = voltage(a, t, *a.p_t0, *a.p_dt);
  }
}

template <int RT>
__device__ __forceinline__ void load_rows(const float* p, float* x) {
  if constexpr (RT == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < RT; ++r) x[r] = p[r];
  }
}

// One hidden layer l at stage slot s for RT rows: this block's columns of
// leaky(x W + b) into every block's X(s, l + 1), then receive the layer
// from every block
template <int RT>
__device__ void hidden_fwd(const Args& a, const Lay& m, int rank, int s,
                           int l, uint32_t ph) {
  const int din = a.sizes[l], dout = a.sizes[l + 1];
  const int cols = a.cl_cols[l], KS = a.ks[l];
  const float* W = m.w + a.cl_off[l];
  const float* x = m.X(s, l);
  float* out = m.X(s, l + 1);
  const int j0 = rank * cols;
  const int nown = max(0, min(cols, dout - j0));
  const int tid = threadIdx.x, q = tid & (KS - 1);
  for (int c0 = 0; c0 < cols; c0 += kThreads / KS) {
    const int c = c0 + tid / KS;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    if (c < nown) {
      const float* wc = W + c;
#pragma unroll 4
      for (int k = q; k < din; k += KS) {
        const float w = wc[k * cols];
        float xv[RT];
        load_rows<RT>(x + k * RT, xv);
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(xv[r], w, acc[r]);
      }
    }
    for (int o = KS >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    }
    if (c < nown) {
      const float bias = W[din * cols + c];
      float y[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) y[r] = leaky(acc[r] + bias);
      const uint32_t addr = smem_addr(out + (j0 + c) * RT);
      const uint32_t bar = smem_addr(m.barX(s, l + 1));
      for (int b = q; b < a.csize; b += KS) st_peer<RT>(addr, bar, b, y);
    }
  }
  receive(m.barX(s, l + 1), RT * x_bytes(a, l + 1), ph);
}

// The MLP at stage slot s on the RT rows (V[r] / 100, ua[r]): its outputs
// into outv[0..RT) (the same bits in every thread of every block).  All
// threads call it.
template <int RT>
__device__ void mlp_fwd(const Args& a, const Lay& m, int rank, int s,
                        const float* V, const float* ua, float* outv,
                        uint32_t ph) {
  const int L = a.n_layers, tid = threadIdx.x;
  float x0a[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) x0a[r] = __fdiv_rn(V[r], 100.f);
  {
    float* X0 = m.X(s, 0);
    if (tid == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        X0[r] = x0a[r];
        X0[RT + r] = ua[r];
      }
    }
    const float* W = m.w + a.cl_off[0];
    const int cols = a.cl_cols[0], dout = a.sizes[1];
    float* out = m.X(s, 1);
    for (int j = tid; j < dout; j += kThreads) {
      const float w0 = W[j], w1 = W[cols + j], bias = W[2 * cols + j];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float acc = fmaf(x0a[r], w0, 0.f);
        acc = fmaf(ua[r], w1, acc);
        out[j * RT + r] = leaky(acc + bias);
      }
    }
  }
  __syncthreads();
  for (int l = 1; l < L - 1; ++l) hidden_fwd<RT>(a, m, rank, s, l, ph);
  if (tid < 32) {
    const int din = a.sizes[L - 1];
    const float* W = m.w + a.cl_off[L - 1];
    const float* x = m.X(s, L - 1);
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    for (int k = tid; k < din; k += 32) {
      float xv[RT];
      load_rows<RT>(x + k * RT, xv);
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = fmaf(xv[r], W[k], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      for (int o = 16; o > 0; o >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
      if (tid == 0) outv[r] = acc[r] + W[din];
    }
  }
  __syncthreads();
}

// f at stage slot s for RT rows from the states (ua, ur) at voltages V:
// (da/dt, dr/dt) into (ka, kr)
template <int RT>
__device__ __forceinline__ void stage(const Args& a, const Lay& m, int rank,
                                      int s, const float* V, const float* ua,
                                      const float* ur, float* ka, float* kr,
                                      float* outv, uint32_t ph) {
  mlp_fwd<RT>(a, m, rank, s, V, ua, outv, ph);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    ka[r] = __fdiv_rn(outv[r], 1000.f);
    kr[r] = add(mul(-rate3(a, V[r]), ur[r]),
                mul(rate4(a, V[r]), sub(1.f, ur[r])));
  }
}

// The 4 stages of RT RK4 substeps from (ya, yr) at the stage voltages
// v4[r][4], each stage's layer inputs kept in X(s, .); with `step`, the
// new states into (ya, yr).  ph: the parity of the layer-input buffers'
// mbarriers, which complete once a call.
template <int RT>
__device__ void stages(const Args& a, const Lay& m, int rank,
                       const float* const* v4, float h, float* ya, float* yr,
                       bool step, float* outv, uint32_t ph) {
  const float hh = mul(0.5f, h);
  float V[RT], ua[RT], ur[RT], ka[RT], kr[RT], sa[RT], sr[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    V[r] = v4[r][0];
    ua[r] = ya[r];
    ur[r] = yr[r];
  }
  stage<RT>(a, m, rank, 0, V, ua, ur, ka, kr, outv, ph);
#pragma unroll
  for (int r = 0; r < RT; ++r) {  // k1 + 2 k2 + 2 k3 + k4, as it forms
    sa[r] = ka[r];
    sr[r] = kr[r];
  }
  for (int s = 1; s < 4; ++s) {
    const float c = s == 3 ? h : hh;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      V[r] = v4[r][s];
      ua[r] = add(ya[r], mul(c, ka[r]));
      ur[r] = add(yr[r], mul(c, kr[r]));
    }
    stage<RT>(a, m, rank, s, V, ua, ur, ka, kr, outv, ph);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      sa[r] = add(sa[r], s == 3 ? ka[r] : mul(2.f, ka[r]));
      sr[r] = add(sr[r], s == 3 ? kr[r] : mul(2.f, kr[r]));
    }
  }
  if (step) {
    const float h6 = __fdiv_rn(h, 6.f);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      ya[r] = add(ya[r], mul(h6, sa[r]));
      yr[r] = add(yr[r], mul(h6, sr[r]));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) node_fwd(Args a) {
  extern __shared__ __align__(128) float sm[];
  __shared__ uint64_t wbar, bars[kBars];
  __shared__ float outv[1];
  const Offs o = offsets(a, false);
  const Lay m{sm + o.w, nullptr, sm + o.x, nullptr, nullptr, nullptr,
              sm + o.vst, nullptr, a.n_layers, a.wmax, a.cmax, a.csize,
              1, bars};
  const int rank = blockIdx.x % a.csize, tid = threadIdx.x;
  const bool writer = rank == 0 && tid == 0;
  load_weights(a, m, &wbar, rank, false);

  float ya = a.y0[0], yr = a.y0[1];
  if (writer) {
    a.ys[0] = ya;
    a.ys[1] = yr;
  }
  for (int k = 0; k + 1 < a.n_t; ++k) {
    const float t0 = a.ts[k], t1 = a.ts[k + 1];
    const float h = __fdiv_rn(sub(t1, t0), (float)a.n_sub);
    stage_voltages(a, m, t0, h);
    __syncthreads();
    for (int i = 0; i < a.n_sub; ++i) {
      if (writer) {
        float* st = a.ystart + ((size_t)k * a.n_sub + i) * 2;
        st[0] = ya;
        st[1] = yr;
      }
      const float* v4 = m.vst + 4 * i;
      stages<1>(a, m, rank, &v4, h, &ya, &yr, true, outv,
                (uint32_t)(k * a.n_sub + i) & 1u);
    }
    if (writer) {
      a.ys[(k + 1) * 2] = ya;
      a.ys[(k + 1) * 2 + 1] = yr;
    }
    __syncthreads();  // every stage voltage is read before the next fill
  }
  // no block leaves while a peer may still store into its shared memory
  cluster_barrier();
}

// The interval gradient's rank-4 update from the substep's 4 stages (row
// `row` of the layer inputs): the outer products on this block's own
// columns (see the header)
__device__ void grad_update(const Args& a, const Lay& m, int rank,
                            int row) {
  const int L = a.n_layers, tid = threadIdx.x, rt = m.rt;
  for (int l = 1; l < L - 1; ++l) {
    const int din = a.sizes[l], cols = a.cl_cols[l];
    const int nown = max(0, min(cols, a.sizes[l + 1] - rank * cols));
    float* G = m.g + a.cl_off[l];
    const float *D0 = m.D(0, l), *D1 = m.D(1, l), *D2 = m.D(2, l),
                *D3 = m.D(3, l);
    for (int k = tid; k < din; k += kThreads) {
      const int e = k * rt + row;
      const float x0 = m.X(0, l)[e], x1 = m.X(1, l)[e], x2 = m.X(2, l)[e],
                  x3 = m.X(3, l)[e];
      float* Gk = G + k * cols;
      for (int c = 0; c < nown; ++c) {
        float g = Gk[c];
        g = fmaf(x3, D3[c], g);
        g = fmaf(x2, D2[c], g);
        g = fmaf(x1, D1[c], g);
        g = fmaf(x0, D0[c], g);
        Gk[c] = g;
      }
    }
    for (int c = tid; c < nown; c += kThreads) {
      float* gb = G + din * cols + c;
      *gb = add(add(add(add(*gb, D3[c]), D2[c]), D1[c]), D0[c]);
    }
  }
  {  // layer 0: rows V / 100 and a and the bias, this block's columns
    const int cols = a.cl_cols[0], ow = a.own[0], j0 = rank * ow;
    const int nown = max(0, min(ow, a.sizes[1] - j0));
    float* G = m.g + a.cl_off[0];
    for (int t = tid; t < 3 * nown; t += kThreads) {
      const int k = t / nown, c = t - k * nown;
      float* g = G + k * cols + j0 + c;
      float v = *g;
      for (int s = 3; s >= 0; --s)
        v = k < 2 ? fmaf(m.X(s, 0)[k * rt + row], m.D(s, 0)[c], v)
                  : add(v, m.D(s, 0)[c]);
      *g = v;
    }
  }
  {  // the last layer: this block's part of its input, the bias at rank 0
    const int ow = a.own[L - 2], k0 = rank * ow, din = a.sizes[L - 1];
    const int nown = max(0, min(ow, din - k0));
    float* G = m.g + a.cl_off[L - 1];
    for (int c = tid; c < nown; c += kThreads) {
      const int k = k0 + c;
      float v = G[k];
      for (int s = 3; s >= 0; --s)
        v = fmaf(m.X(s, L - 1)[k * rt + row], m.D(s, L - 1)[0], v);
      G[k] = v;
    }
    if (rank == 0 && tid == 0) {
      float v = G[din];
      for (int s = 3; s >= 0; --s) v = add(v, m.D(s, L - 1)[0]);
      G[din] = v;
    }
  }
}

// The MLP's reverse pass at stage slot s, row `row`, for the cotangent ca
// of da/dt: every layer's output cotangent on this block's own columns
// into D(s, .), and d/da of the net's input (the same bits in every thread
// of every block).  With `last`, the substep's gradient update runs before
// the final exchange, whose stores let the peers go on and, after a
// batch's last row, overwrite the layer inputs it reads.  ab: the scalar
// buffer next written; rph, aph: the reduce and scalar mbarriers'
// parities.
__device__ float mlp_vjp(const Args& a, const Lay& m, int rank, int s,
                         int row, float ca, bool last, int& ab,
                         uint32_t& rph, uint32_t& aph) {
  const int L = a.n_layers, tid = threadIdx.x, C = a.csize, rt = m.rt;
  const float dl = __fdiv_rn(ca, 1000.f);
  {  // the last layer's input, this block's part
    const int lh = L - 2, ow = a.own[lh], k0 = rank * ow;
    const int din = a.sizes[L - 1];
    const float* W = m.w + a.cl_off[L - 1];
    const float* x = m.X(s, L - 1);
    if (tid == 0) m.D(s, L - 1)[0] = dl;
    if (tid < ow) {
      const int k = k0 + tid;
      m.D(s, lh)[tid] =
          k < din ? leaky_vjp(x[k * rt + row], mul(W[k], dl)) : 0.f;
    }
  }
  __syncthreads();
  for (int l = L - 2; l >= 1; --l) {
    const int din = a.sizes[l], cols = a.cl_cols[l], ow = a.own[l - 1];
    const int nown = max(0, min(cols, a.sizes[l + 1] - rank * cols));
    const float* W = m.w + a.cl_off[l];
    const float* D = m.D(s, l);
    float* R = m.R(l);
    const uint32_t bar = smem_addr(m.barR(l));
    for (int k = tid; k < din; k += kThreads) {
      const float* wk = W + k * cols;
      float p = 0.f;
      for (int c = 0; c < nown; ++c) p = fmaf(wk[c], D[c], p);
      const int q = k / ow;
      st_peer<1>(smem_addr(R + rank * a.cmax + (k - q * ow)), bar, q, &p);
    }
    receive(m.barR(l), r_bytes(a, l, rank), (rph >> l) & 1u);
    rph ^= 1u << l;
    if (tid < ow) {
      const int k = rank * ow + tid;
      float dz = 0.f;
      if (k < din) {
        float dx = R[tid];
        for (int b = 1; b < C; ++b) dx = add(dx, R[b * a.cmax + tid]);
        dz = leaky_vjp(m.X(s, l)[k * rt + row], dx);
      }
      m.D(s, l - 1)[tid] = dz;
    }
    __syncthreads();
  }
  float* A = m.A(ab);
  if (last) {
    grad_update(a, m, rank, row);
    __syncthreads();
  }
  if (tid < 32) {  // layer 0: sum over j of W0[1][j] dz0[j], this block's j
    const int ow = a.own[0], j0 = rank * ow;
    const int nown = max(0, min(ow, a.sizes[1] - j0));
    const float* W1 = m.w + a.cl_off[0] + a.cl_cols[0] + j0;
    const float* D = m.D(s, 0);
    float p = 0.f;
    for (int c = tid; c < nown; c += 32) p = fmaf(W1[c], D[c], p);
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    const uint32_t bar = smem_addr(m.barA(ab));
    for (int b = tid; b < C; b += 32)
      st_peer<1>(smem_addr(A + rank), bar, b, &p);
  }
  receive(m.barA(ab), 4u * C, (aph >> ab) & 1u);
  aph ^= 1u << ab;
  float ga = A[0];
  for (int b = 1; b < C; ++b) ga = add(ga, A[b]);
  ab ^= 1;
  return ga;
}

__global__ void __launch_bounds__(kThreads, 1) node_vjp(Args a) {
  extern __shared__ __align__(128) float sm[];
  __shared__ uint64_t wbar, bars[kBars];
  __shared__ float outv[kBatch];
  const Offs o = offsets(a, true);
  const Lay m{sm + o.w, sm + o.g, sm + o.x, sm + o.d, sm + o.r, sm + o.a,
              sm + o.vst, sm + o.yst, a.n_layers, a.wmax, a.cmax, a.csize,
              kBatch, bars};
  const int rank = blockIdx.x % a.csize, tid = threadIdx.x;
  for (int e = tid; e < a.cl_floats; e += kThreads) m.g[e] = 0.f;
  load_weights(a, m, &wbar, rank, true);

  int ab = 0;                 // the scalar buffer next written
  uint32_t rph = 0, aph = 0;  // the reduce and scalar mbarriers' parities,
                              // a bit each
  uint32_t xph = 0;           // the layer-input buffers' parity
  float ga = a.g_ys[(a.n_t - 1) * 2], gr = a.g_ys[(a.n_t - 1) * 2 + 1];
  for (int k = a.n_t - 2; k >= 0; --k) {
    const float t0 = a.ts[k], t1 = a.ts[k + 1];
    const float h = __fdiv_rn(sub(t1, t0), (float)a.n_sub);
    const float hh = mul(0.5f, h), h6 = __fdiv_rn(h, 6.f);
    stage_voltages(a, m, t0, h);
    if (tid < 2 * a.n_sub) m.yst[tid] = a.ystart[(size_t)k * a.n_sub * 2 + tid];
    __syncthreads();
    // the substeps in batches of kBatch, last first: each batch's stages
    // recomputed together (row r: substep i0 + r; a short batch repeats
    // its last substep), then each substep's reverse pass, last first
    for (int i0 = (a.n_sub - 1) / kBatch * kBatch; i0 >= 0; i0 -= kBatch) {
      const int rows = min(kBatch, a.n_sub - i0);
      float ya[kBatch], yr[kBatch];
      const float* v4[kBatch];
      for (int r = 0; r < kBatch; ++r) {
        const int i = i0 + min(r, rows - 1);
        ya[r] = m.yst[2 * i];
        yr[r] = m.yst[2 * i + 1];
        v4[r] = m.vst + 4 * i;
      }
      stages<kBatch>(a, m, rank, v4, h, ya, yr, false, outv, xph);
      xph ^= 1u;
      for (int r = rows - 1; r >= 0; --r) {
        const float* V = v4[r];
        // the reverse pass of y' = y + h/6 (k1 + 2 k2 + 2 k3 + k4)
        const float sa = mul(ga, h6), sr = mul(gr, h6);
        float ka[4] = {sa, mul(sa, 2.f), mul(sa, 2.f), sa};
        float kr[4] = {sr, mul(sr, 2.f), mul(sr, 2.f), sr};
        float gya = ga, gyr = gr;
        for (int s = 3; s >= 0; --s) {
          const float gua =
              mlp_vjp(a, m, rank, s, r, ka[s], s == 0, ab, rph, aph);
          const float gur = sub(mul(kr[s], -rate3(a, V[s])),
                                mul(kr[s], rate4(a, V[s])));
          gya = add(gya, gua);
          gyr = add(gyr, gur);
          if (s > 0) {  // u_s = y + c h k_{s-1}: c = 1 at stage 4, 1/2 else
            const float c = s == 3 ? h : hh;
            ka[s - 1] = add(ka[s - 1], mul(gua, c));
            kr[s - 1] = add(kr[s - 1], mul(gur, c));
          }
        }
        ga = gya;
        gr = gyr;
      }
    }
    // the interval's gradient into the output, then cleared
    float* out = a.grad + (size_t)rank * a.cl_floats;
    const bool first = k == a.n_t - 2;
    for (int e = tid; e < a.cl_floats; e += kThreads) {
      out[e] = first ? m.g[e] : add(out[e], m.g[e]);
      m.g[e] = 0.f;
    }
    ga = add(ga, a.g_ys[k * 2]);
    gr = add(gr, a.g_ys[k * 2 + 1]);
    __syncthreads();
  }
  cluster_barrier();
}

// The layout and partition fields from the wrapper's geometry; false if
// the net or the geometry is out of range: 2 inputs, 1 output, every other
// layer at least 2 wide, 2..16 blocks, the geometry ops/fused_solve.py::
// cluster_geometry gives (16-byte words, layer 0 and the last whole)
bool init_args(Args& a, const int* sizes, int n_layers, int csize,
               const int* cgeom, int cl_floats, int n_knots, int n_t,
               int n_sub, const float* scal) {
  if (n_layers < 2 || n_layers > kMaxLayers || csize < 2 ||
      csize > kMaxCluster || cl_floats < 4 || cl_floats % 4 || n_knots < 2 ||
      n_t < 2 || n_sub < 1 || n_sub > kMaxSub)
    return false;
  a = Args{};
  a.n_layers = n_layers;
  a.csize = csize;
  a.cl_floats = cl_floats;
  a.n_knots = n_knots;
  a.n_t = n_t;
  a.n_sub = n_sub;
  for (int l = 0; l <= n_layers; ++l) a.sizes[l] = sizes[l];
  if (sizes[0] != 2 || sizes[n_layers] != 1) return false;
  a.wmax = 0;
  a.cmax = 1;
  for (int l = 0; l < n_layers; ++l) {
    const int din = sizes[l], dout = sizes[l + 1];
    const int off = cgeom[2 * l], cols = cgeom[2 * l + 1];
    const int end = l + 1 < n_layers ? cgeom[2 * l + 2] : cl_floats;
    const bool last = l == n_layers - 1;
    if ((!last && dout < 2) || off % 4 || end > cl_floats || cols < 1 ||
        end - off < (din + 1) * cols)
      return false;
    if (l == 0 ? cols < dout || cols >= dout + kColsStep
        : last ? cols != 1
               : cols % kColsStep || cols * csize < dout || cols >= dout)
      return false;
    a.cl_off[l] = off;
    a.cl_cols[l] = cols;
    a.wmax = a.wmax > din ? a.wmax : din;
    if (!last) {
      const int per = (dout + csize - 1) / csize;
      a.own[l] = l == 0 ? (per + kColsStep - 1) / kColsStep * kColsStep : cols;
      if (a.own[l] > kThreads) return false;
      a.cmax = a.cmax > a.own[l] ? a.cmax : a.own[l];
      int ks = 32;
      while (ks > 1 && ks * cols > kThreads) ks >>= 1;
      a.ks[l] = ks;
    }
  }
  a.p5 = scal[0];
  a.p6 = scal[1];
  a.p7 = scal[2];
  a.p8 = scal[3];
  a.holding = scal[4];
  return true;
}

// One launch of `kern` as one cluster of a.csize blocks
cudaError_t launch(void (*kern)(Args), Args& a, size_t smem,
                   cudaStream_t stream) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.csize > 8 &&
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return err;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.csize;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int most = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&most, (const void*)kern,
                                            &cfg)) != cudaSuccess)
    return err;
  if (most < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {&a};
  return cudaLaunchKernelExC(&cfg, (const void*)kern, args);
}

}  // namespace

extern "C" int ionflux_node_rk4_fwd(
    const float* w, const float* knots, const float* p_t0, const float* p_dt,
    int n_knots, const float* ts, int n_t, const float* y0, float* ys,
    float* ystart, const int* sizes, int n_layers, int csize,
    const int* cgeom, int cl_floats, int n_sub, const float* scal,
    void* stream) {
  Args a;
  if (!init_args(a, sizes, n_layers, csize, cgeom, cl_floats, n_knots, n_t,
                 n_sub, scal))
    return (int)cudaErrorInvalidValue;
  a.w = w;
  a.knots = knots;
  a.p_t0 = p_t0;
  a.p_dt = p_dt;
  a.ts = ts;
  a.y0 = y0;
  a.ys = ys;
  a.ystart = ystart;
  return (int)launch(node_fwd, a, 4 * (size_t)offsets(a, false).total,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int ionflux_node_rk4_vjp(
    const float* w, const float* knots, const float* p_t0, const float* p_dt,
    int n_knots, const float* ts, int n_t, const float* ystart,
    const float* g_ys, float* grad, const int* sizes, int n_layers,
    int csize, const int* cgeom, int cl_floats, int n_sub, const float* scal,
    void* stream) {
  Args a;
  if (!init_args(a, sizes, n_layers, csize, cgeom, cl_floats, n_knots, n_t,
                 n_sub, scal))
    return (int)cudaErrorInvalidValue;
  a.w = w;
  a.knots = knots;
  a.p_t0 = p_t0;
  a.p_dt = p_dt;
  a.ts = ts;
  a.ystart = const_cast<float*>(ystart);
  a.g_ys = g_ys;
  a.grad = grad;
  return (int)launch(node_vjp, a, 4 * (size_t)offsets(a, true).total,
                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* ionflux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
