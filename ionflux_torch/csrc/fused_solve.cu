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
// evaluates the 6 new DP5 stages of its lanes: per stage one MLP pass of its
// RT activation rows (shared memory, double-buffered) against the member's
// weights.  The launch shares ONE step controller: each block writes its
// lanes' max live error ratio to partial[seq & 1][block], the grid
// synchronises, and every block reduces all partials itself and runs the same
// f32 controller algebra, so t, h and accept agree everywhere with no further
// traffic.  Early exit and the pace cull happen at block ends, as in the
// reference.  The MLP is 6 * sum(in * out) MACs per lane per trip (1.2 M at
// the trained 200-wide, 7-layer width); the records, the only output, are ~16
// floats per lane per trip.
//
// Three layer passes.  mlp(), the first: thread j owns output column j and
// walks k, loading W[k][j] from L2 per k and feeding RT FMAs from row-major
// activations.  That pass waits on one weight load per k-step, with few
// loads in flight per SM: the sweeps ran on it at ~7.8 us per 200-wide layer
// on one SM, 1,300x their bound, and the population launches, which stream a
// different member's 0.8 MB of f32 weights through every block, at ~6% FMA
// issue (PERF.md).  It stays for sweep nets whose slices do not fit a
// cluster's shared memory (the wrapper's size rule, see mlp_cluster()), and
// for population launches whose layers no ring tile holds (past 11,512 wide
// in f32, 952 in bf16; the wrapper's launch_plan): there at the largest row
// tile whose two activation buffers fit a block, with bf16 weights in the
// mxu_bf16 mode.  One f32 row's two buffers fill a block's shared memory at
// ~28,900 wide, the stated limit of both passes.
//
// The sweeps (B2, B6: one net, P = 1) take mlp_cluster(), chosen by the
// wrapper's size rule (ops/fused_solve.py::sweep_cluster):
//
//   * A row tile runs on a thread-block cluster of C blocks (8; 16 takes
//     the non-portable cluster size and was no faster, PERF.md), one per
//     SM.  Block `rank` owns columns [rank cols, (rank + 1) cols) of every
//     hidden layer: the wrapper packs those column slices (weights
//     row-major [in, cols], then the cols biases), and layer 0 and the
//     last layer whole, as one contiguous 16-byte-aligned row per rank
//     (cluster_geometry, _cluster_pack).  The block copies its row into
//     shared memory once per launch, one bulk copy per layer (the TMA
//     engine) on one mbarrier: 105 KB at C = 8 for the trained 200-wide,
//     7-layer net, whose 802 KB no single SM holds.  No weight is read
//     from L2 or HBM inside the trip loop.
//   * Every block holds the full layer input, k-major [k][RT + 4], in
//     three exchange buffers.  A hidden layer: each block sums its slice's
//     outputs (one fmaf chain over k = 0..in-1 from 0, + bias, leaky, as
//     mlp(); a thread task is 2 rows x 2 columns, 4 x 2 at 32 rows), stores
//     them into every peer's buffer through DSMEM (mapa +
//     st.shared::cluster), and the cluster meets at one barrier
//     (arrive.release / wait.acquire).  The exchanges of an evaluation
//     write e0 and e1 in turn and the last one e2, which only the last
//     layer reads: so one barrier per layer also ends every read of the
//     buffer the next exchange writes, across evaluations too.
//   * Layer 0 (2 inputs) and the last layer (one output) are whole in
//     every block and computed there without an exchange: 5 exchanges per
//     evaluation, 30 per trip, for the 7-layer net.  Layer 0 writes e1,
//     which no peer writes before the first exchange's barrier.  The last
//     layer runs in mlp()'s order (warp 0, lane-strided k, the same shuffle
//     tree), so the records are bit-identical to mlp()'s.  A hidden layer
//     one wide takes mlp() instead (the size rule).
//   * Lane state, stage combinations, error norm and controller are
//     replicated in every block of the cluster: the same inputs in the same
//     order give the same bits, so nothing else is exchanged.  Rank 0
//     writes the records, n_out and alive.  Row tiles of several clusters
//     (B > 32) share one controller through grid_reduce with one partial
//     per cluster, in a launch with the cluster and cooperative attributes
//     together; one cluster needs no grid barrier at all, since each block
//     already holds every lane's values.  Every block leaves through a
//     final cluster barrier, so no peer still stores into a block that
//     has left.
//
//   What bounds it on this card: at the sweeps' 7 rows, each exchange is
//   a 200-long dependent fmaf chain from shared memory, held by the
//   shared-memory loads that feed it (two per link per task), then the
//   DSMEM stores and the barrier, 30 exchanges per trip; at 32 rows the
//   FMAs of a block's slice (160 k at C = 8) add their issue time.  At 7
//   rows the chains are ~40% of a trip, the barriers, the last layers and
//   the lane work the rest; it runs at ~340x the trip's FLOP bound
//   (PERF.md, scripts/probe_cluster_pass_torch.py).
//
// The popsweep and the population solve (B1, B4) take mlp_ring(), chosen by
// the entry point (the wrapper's `ring` flag), never by P:
//
//   * The weights a block reads in a trip are known before it starts: layers
//     0..L-1 of its member, over and over.  The wrapper packs each layer in
//     chunks of at most 64 KB (k-rows of [in, out4] in f32; [out8, k + 8]
//     slices of the transposed layer in bf16), each one contiguous and
//     16-byte aligned, and a ring of kStages stages in dynamic shared memory
//     receives them, one 1-D bulk copy (cp.async.bulk, the TMA engine) per
//     chunk, completing an mbarrier per stage.  Thread 0 issues; the ring
//     runs kStages - 1 chunks ahead of the product across layer, stage, trip
//     and grid-barrier boundaries, since the sequence never depends on the
//     activations.  A chunk is handed over by a wait on its stage's barrier
//     and one __syncthreads, which also frees the stage of the chunk before
//     it.  The kernel waits for the chunks in flight before it returns.
//     (Per-thread 16-byte cp.async copies of the same chunks were slower,
//     held by their issue whether the weights fit the L2 or not; PERF.md.)
//   * f32 (CUDA cores, FMA): activations are k-major [k][RT + 4]; each
//     thread owns tiles of 2 rows x 4 columns of a layer (1 x 4 at RT = 1)
//     and sums k in one fixed order from shared memory whatever RT or
//     q_split is, so q_split stays bit-identical.  RT = 1 (the population
//     solve) is a mat-vec bounded by the weight bytes the ring streams.
//   * The popsweep pads Q to a power of two with copies of its last row;
//     the pass computes only the real rows (q_real) and a padded lane takes
//     the MLP output of the last real row, its input bit for bit.
//   * mxu_bf16 (tensor cores): mma.sync m16n8k16 bf16 x bf16 -> f32; the A
//     fragments are the block's rows (16 per tile, exactly the padded Q = 16;
//     two tiles at 32), built from the bf16-valued f32 activations, the B
//     fragments the packed transposed weights; f32 sums, the f32 bias added
//     after the product, the layer input rounded to bf16 where it is written
//     (the reference's mxu_bf16 semantics).  k is zero-padded to 16 in the
//     weights and in the activations.
//   * Any width the block's shared memory holds: the threads cover 256
//     columns of a layer per pass over a chunk; a wider layer takes several
//     passes, each parking its running sums in the output buffer between
//     chunks, so every sum runs in the same order as in registers.  The
//     wrapper's size rule (ops/fused_solve.py::ring_row_tile) picks the row
//     tile whose stages and activation buffers fit (500-wide nets keep 32
//     rows).
//   * Split over a cluster (mlp_ring_split, f32, 8 or more rows), where the
//     widest layer takes more than one column pass (the wrapper's
//     ring_split): there one block walks each chunk of its member once a
//     pass, and the members leave most SMs idle.  A (member, row tile)
//     runs on a cluster of C blocks (2..4, the largest whose clusters the
//     card holds at once); block `rank` streams its own row: layer 0 and
//     the last layer whole, every other layer's columns [rank cols, (rank
//     + 1) cols) as k-rows of [in, cols] (_ring_split_pack).  Each sliced
//     layer's outputs go, after bias and leaky, into every block's next
//     buffer through DSMEM, and the cluster meets at one barrier a layer;
//     a slice takes one pass of the block's threads.  Every output's sum is
//     the unsplit pass's fmaf chain over k = 0..in-1 in one block, and the
//     lane state, controller and records are replicated in every block of
//     the cluster as in mlp_cluster(): the records equal the unsplit
//     launch's bit for bit.  Rank 0 writes them; one controller partial
//     per cluster; the cluster and cooperative attributes together.
//
// What bounds B1 and B4 on this card: per trip each block streams its
// member's weights six times (6 x 0.8 MB f32, 6 x 0.45 MB bf16).  At P = 64
// the f32 set is 51.5 MB, just under the 52.4 MB (50 MiB) L2, yet B4 (one
// row) runs at ~0.1 ms per trip, the time of 310 MB from HBM, so much of it
// comes from HBM all the same.  B1 f32 at 16 rows adds ~0.1 ms of FMAs from
// shared memory to it; bf16 adds its mma.sync pass to the copies and chunk
// handovers.  Whether the set fits the L2 does not decide the split: 200-
// wide members (one column pass) run 6-15% slower split at 40-66 members,
// below and above the L2's size alike, and 500-wide members (two passes)
// 2.0-3.3x faster, 40 s07 members inside the L2 as 40 s08 members (10 MB
// each) outside it, where one block's ring moves ~20 GB/s unsplit.
// chip_smoke.py and scripts/probe_ring_pass_torch.py measure it; the numbers
// are in PERF.md.
//
// Arithmetic follows the plain version's f32 order: the stage combinations,
// error norm and controller use round-to-nearest intrinsics so the compiler
// cannot contract them into FMAs; build without --use_fast_math.  Only the
// MLP's sum order parts kernel and plain.

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
  const void* w;         // [P, w_stride] of WT: mlp(): W0, W1, ... row-major
                         // [in, out]; mlp_ring(): the chunked packing
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
  // mlp_ring only: per layer, its offset in a member's packed row (elements
  // of WT), its chunk depth in k and its number of chunks; the ring's stage
  // size in bytes (a multiple of 16)
  int ring_off[kMaxLayers], ring_kc[kMaxLayers], ring_nch[kMaxLayers];
  int stage_bytes;
  int q_real;  // rows before the popsweep's padding (copies of row
               // q_real - 1); the ring pass computes no padded row it can copy
  // mlp_cluster only: blocks per cluster (1 for the other passes), per
  // layer its offset in a rank's packed row (floats) and its columns per
  // block, and the floats of a rank's row
  int csize;
  int cl_off[kMaxLayers], cl_cols[kMaxLayers];
  int cl_floats;
  int cl_ex;  // layers exchanged per evaluation (the hidden ones)
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

// A layer input as the MLP consumes it: itself in f32, rounded to the
// nearest bf16 (ties to even, as torch's cast) under mxu_bf16
template <typename WT>
__device__ __forceinline__ float mlp_in(float x) { return x; }
template <>
__device__ __forceinline__ float mlp_in<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : 0.01f * x;
}

// A weight as the sum takes it: f32, or a bf16 weight widened (exact)
__device__ __forceinline__ float ldw(const float* w) { return __ldg(w); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* w) {
  return __bfloat162float(*w);
}

// mlp(): MLP over the RT activation rows in `src` (row stride wmax), weights
// of WT row-major [in, out] from global memory.  Returns the buffer holding
// the [RT, 1] output.  All threads of the block call it.  The sweeps' pass
// for nets too large for a cluster, and the population launches' pass for
// layers too wide for the ring (the wrapper's size rule): in bf16 every
// product of a bf16 weight and a bf16-valued input is exact in f32, the sums
// are f32, and each hidden layer's output is rounded to bf16 where it is
// written (the mxu_bf16 semantics).
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
          const float wk = ldw(W + k);
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
              if (!last) x = mlp_in<WT>(leaky(x));
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
          const float wk = ldw(W + (size_t)k * dout + j);
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(src[r * ld + k], wk, acc[r]);
        }
        const float bj = __ldg(B + j);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < nr) {
            float x = acc[r] + bj;
            if (!last) x = mlp_in<WT>(leaky(x));
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

// ---------------------------------------------------------------------------
// The population launches' layer pass (B1, B4): weights through a ring of
// shared-memory stages by bulk copies, the product from shared memory.
// ---------------------------------------------------------------------------

constexpr int kStages = 3;  // RING_STAGES in ops/fused_solve.py

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Activation row stride of the ring pass (k-major [k][RTS]): RT + 4 keeps
// 16-byte row groups aligned and spreads the mma A-fragment loads over the
// banks; one row needs no padding.
template <int RT>
__host__ __device__ constexpr int ring_rts() { return RT == 1 ? 1 : RT + 4; }

// Rows per f32 thread tile: 4 columns x TR rows per thread.  Two rows keep
// every thread of the block busy at RT >= 8 (four rows per tile measured
// 25% slower at RT = 16: fewer independent FMA chains; PERF.md, PR 4).
template <int RT>
__host__ __device__ constexpr int ring_tr() {
  return RT == 1 ? 1 : 2;
}

// Where chunk c of layer l lies: its source offset in the member's packed
// row (elements of WT) and its bytes, one contiguous block both in global
// and in its stage.
//   f32:  up to kc k-rows of [in, round4(out)], row-major;
//   bf16: the [round8(out), kcc + 8] slice of the transposed layer for
//         k in [c kc, c kc + kcc), k zero-padded to a multiple of 16 and
//         each row to kcc + 8 (so a warp's B-fragment loads hit distinct
//         banks);
//   SPLIT (mlp_ring_split, f32): up to kc k-rows of [in, cl_cols[l]], the
//         rank's columns.
struct Chunk {
  int src, bytes;
};

template <typename WT, bool SPLIT = false>
__device__ __forceinline__ Chunk chunk_at(const Args& a, int l, int c) {
  const int din = a.sizes[l], dout = a.sizes[l + 1], kc = a.ring_kc[l];
  Chunk ch;
  if (sizeof(WT) == 4) {
    const int cols = SPLIT ? a.cl_cols[l] : round_up(dout, 4);
    ch.src = a.ring_off[l] + c * kc * cols;
    ch.bytes = min(kc, din - c * kc) * cols * 4;
  } else {
    const int d8 = round_up(dout, 8);
    ch.src = a.ring_off[l] + c * d8 * (kc + 8);
    ch.bytes = d8 * (min(kc, round_up(din, 16) - c * kc) + 8) * 2;
  }
  return ch;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The ring: chunk g of the block's endless sequence (layers 0..L-1 of its
// member, chunk by chunk, over and over) lands in stage g % kStages, by one
// bulk copy (the TMA engine) that completes the stage's mbarrier phase
// (g / kStages) & 1.  Chunks 0..g + kStages - 2 have been issued when chunk
// g is acquired.
struct Ring {
  unsigned char* base;  // kStages stages of a.stage_bytes
  uint64_t* bar;        // kStages mbarriers, one per stage
  int g;                // the next chunk the product takes
  int pl, pc;           // the next chunk to issue: layer, chunk
  int rows;             // the block's rows the product computes (>= 1)
  int rank;             // split pass: the block's rank in its cluster
  int ex;               // split pass: the exchanges made so far
};

// Issue the next chunk into the stage chunk g - 1 had.  All threads call it
// (the cursor stays uniform); thread 0 issues.
template <typename WT, bool SPLIT = false>
__device__ __forceinline__ void ring_issue(const Args& a, const WT* wm,
                                           Ring& rg) {
  if (threadIdx.x == 0) {
    const Chunk ch = chunk_at<WT, SPLIT>(a, rg.pl, rg.pc);
    const int stage = (rg.g + kStages - 1) % kStages;
    const uint32_t bar = smem_addr(rg.bar + stage);
    // the stage's last generic reads are ordered before the async write
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(ch.bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(
            smem_addr(rg.base + stage * a.stage_bytes)),
        "l"(wm + ch.src), "r"(ch.bytes), "r"(bar)
        : "memory");
  }
  if (++rg.pc == a.ring_nch[rg.pl]) {
    rg.pc = 0;
    rg.pl = rg.pl + 1 == a.n_layers ? 0 : rg.pl + 1;
  }
}

// Start the ring: set up the barriers and issue the first kStages - 1
// chunks.  All threads call it.
template <typename WT, bool SPLIT = false>
__device__ void ring_start(const Args& a, const WT* wm, Ring& rg,
                           unsigned char* base, uint64_t* bar) {
  rg.base = base;
  rg.bar = bar;
  rg.pl = rg.pc = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bar + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < kStages - 1; ++i) {
    rg.g = i + 1 - kStages;  // so that chunk i goes to stage i
    ring_issue<WT, SPLIT>(a, wm, rg);
  }
  rg.g = 0;
}

// Wait for chunk g, free the stage of chunk g - 1 to the copy of chunk
// g + kStages - 1, and return chunk g's stage.  All threads call it.
template <typename WT, bool SPLIT = false>
__device__ __forceinline__ const unsigned char* ring_acquire(const Args& a,
                                                             const WT* wm,
                                                             Ring& rg) {
  const int stage = rg.g % kStages;
  bar_wait(rg.bar + stage, (rg.g / kStages) & 1);
  __syncthreads();  // every thread is done with chunk g - 1
  ring_issue<WT, SPLIT>(a, wm, rg);
  ++rg.g;
  return rg.base + stage * a.stage_bytes;
}

// Wait for the chunks still in flight: no copy may outlive the block
__device__ void ring_drain(Ring& rg) {
  for (int i = 0; i < kStages - 1; ++i) {
    const int g = rg.g + i;
    bar_wait(rg.bar + g % kStages, (g / kStages) & 1);
  }
}

// The cluster passes' exchange (mlp_cluster, mlp_ring_split): one barrier
// of every thread of every block of the cluster, which orders the DSMEM
// stores before it against the reads after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Store x[0..TR) at shared address `addr` of every block of the cluster
// (the same offset in each block's window; 8- or 16-byte aligned for TR =
// 2 or 4)
template <int TR>
__device__ __forceinline__ void push(uint32_t addr, const float* x,
                                     int csize) {
  for (int q = 0; q < csize; ++q) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r)
                 : "r"(addr), "r"(q));
    if constexpr (TR == 4)
      asm volatile(
          "st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(r),
          "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3])
          : "memory");
    else if constexpr (TR == 2)
      asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(r),
                   "f"(x[0]), "f"(x[1])
                   : "memory");
    else
      asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(r), "f"(x[0])
                   : "memory");
  }
}

template <int TR>
__device__ __forceinline__ void load_rows(const float* p, float* x) {
  if constexpr (TR % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TR; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x;
      x[i + 1] = v.y;
      x[i + 2] = v.z;
      x[i + 3] = v.w;
    }
  } else if constexpr (TR == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The k-sum of one f32 thread tile over kn k-rows of a chunk: acc[r][c] +=
// x[row r][k] * w[k][col c], k in order, from the tile's first input row xp
// (k-major, row stride RTS) and first weight column wp (row stride ldw)
template <int RTS, int TR>
__device__ __forceinline__ void tile_f32(const float* xp, const float* wp,
                                         int kn, int ldw,
                                         float (&acc)[TR][4]) {
#pragma unroll 8
  for (int kk = 0; kk < kn; ++kk) {
    const float4 wv = *reinterpret_cast<const float4*>(wp + kk * ldw);
    float x[TR];
    load_rows<TR>(xp + kk * RTS, x);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      acc[r][0] = fmaf(x[r], wv.x, acc[r][0]);
      acc[r][1] = fmaf(x[r], wv.y, acc[r][1]);
      acc[r][2] = fmaf(x[r], wv.z, acc[r][2]);
      acc[r][3] = fmaf(x[r], wv.w, acc[r][3]);
    }
  }
}

// One layer of the f32 ring pass: [RT, din] (k-major in src) x [din, dout]
// + bias into dst.  Thread task t owns rows tr*TR.. and columns cg*4..;
// every output's sum runs k = 0..din-1 in order.  A pass over a chunk
// covers NT * kThreads tasks (256 columns; 1,024 at RT = 1); a wider layer takes
// several passes over each chunk, each task's running sums parked in dst
// between chunks (stored and reloaded as they are, so the sum is the same
// fmaf chain as in registers).  SPLIT (mlp_ring_split): a sliced layer is
// the block's columns [j0, j0 + cl_cols[l]) of it, in one pass (the
// wrapper's ring_split_fits), each output stored into every block of the
// cluster; a whole layer is the unsplit pass's, from the rank's row.
template <int RT, bool SPLIT = false>
__device__ void ring_layer_f32(const Args& a, const float* wm, Ring& rg,
                               int l, const float* B, const float* src,
                               float* dst, bool last) {
  constexpr int RTS = ring_rts<RT>(), TR = ring_tr<RT>();
  // tiles per thread and pass: RT / TR row groups x 64 column groups
  constexpr int NT = (RT / TR * 64 + kThreads - 1) / kThreads;
  const int din = a.sizes[l], dout = a.sizes[l + 1], kc = a.ring_kc[l];
  int ncg, ldw, j0 = 0;
  bool sliced = false;
  if constexpr (SPLIT) {
    ldw = a.cl_cols[l];
    ncg = ldw / 4;
    sliced = ldw < dout;
    if (sliced) j0 = rg.rank * ldw;
  } else {
    ncg = round_up(dout, 4) / 4;
    ldw = ncg * 4;
  }
  const int passes = (RT / TR * ncg + NT * kThreads - 1) / (NT * kThreads);
  if (passes == 1) {
    int tr[NT], cg[NT];
    bool on[NT];
    float acc[NT][TR][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int t = threadIdx.x + i * kThreads;
      tr[i] = t / ncg;
      cg[i] = t - tr[i] * ncg;
      on[i] = tr[i] * TR < rg.rows;
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][r][c] = 0.f;
    }
    for (int c = 0; c < a.ring_nch[l]; ++c) {
      const float* w = reinterpret_cast<const float*>(
          ring_acquire<float, SPLIT>(a, wm, rg));
      const int k0 = c * kc, kn = min(kc, din - k0);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (!on[i]) continue;
        tile_f32<RTS, TR>(src + k0 * RTS + tr[i] * TR, w + cg[i] * 4, kn,
                          ldw, acc[i]);
      }
    }
    if constexpr (SPLIT) {
      if (sliced) {  // a hidden layer: bias, leaky, into every block
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if (!on[i]) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + cg[i] * 4 + c;
            if (j >= dout) continue;
            const float bj = __ldg(B + j);
            float x[TR];
#pragma unroll
            for (int r = 0; r < TR; ++r) x[r] = leaky(acc[i][r][c] + bj);
            push<TR>(smem_addr(dst + j * RTS + tr[i] * TR), x, a.csize);
          }
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (!on[i]) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = cg[i] * 4 + c;
        if (j >= dout) continue;
        const float bj = __ldg(B + j);
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          float x = acc[i][r][c] + bj;
          if (!last) x = leaky(x);
          dst[j * RTS + tr[i] * TR + r] = x;
        }
      }
    }
    return;
  }
  // wider than 256 columns: the running sums of column j, row r wait in
  // dst[j * RTS + r] (round4(dout) <= round16(wmax) columns fit it); only
  // the thread that owns a task touches its slots
  for (int c = 0; c < a.ring_nch[l]; ++c) {
    const float* w = reinterpret_cast<const float*>(
        ring_acquire<float, SPLIT>(a, wm, rg));
    const int k0 = c * kc, kn = min(kc, din - k0);
    for (int ps = 0; ps < passes; ++ps) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int t = threadIdx.x + (ps * NT + i) * kThreads;
        const int tr = t / ncg, cg = t - tr * ncg;
        if (tr * TR >= rg.rows) continue;
        float* slot = dst + cg * 4 * RTS + tr * TR;
        float acc[TR][4];
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = c == 0 ? 0.f : slot[q * RTS + r];
        tile_f32<RTS, TR>(src + k0 * RTS + tr * TR, w + cg * 4, kn, ldw,
                          acc);
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) slot[q * RTS + r] = acc[r][q];
      }
    }
  }
  for (int ps = 0; ps < passes; ++ps) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int t = threadIdx.x + (ps * NT + i) * kThreads;
      const int tr = t / ncg, cg = t - tr * ncg;
      if (tr * TR >= rg.rows) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = cg * 4 + q;
        if (j >= dout) continue;
        const float bj = __ldg(B + j);
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          float x = dst[j * RTS + tr * TR + r] + bj;
          if (!last) x = leaky(x);
          dst[j * RTS + tr * TR + r] = x;
        }
      }
    }
  }
}

// The mma k-steps of one chunk of the bf16 ring pass for the n-tiles
// warp + 8 (i0 + i), i < 4, of every row tile: A from the block's rows in
// src (bf16-rounded f32, k-major), B from the chunk's [n, kcc + 8] slices
template <int RT>
__device__ __forceinline__ void mma_chunk(const float* src,
                                          const __nv_bfloat16* w, int k0,
                                          int kcc, int rows, int nt, int i0,
                                          float (&acc)[RT > 16 ? 2 : 1][4][4]) {
  constexpr int RTS = ring_rts<RT>(), MT = RT > 16 ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int sst = kcc + 8, steps = kcc / 16;
  for (int s = 0; s < steps; ++s) {
    const int kb = k0 + s * 16 + 2 * t;
    uint32_t af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m * 16 >= rows) break;
      const int r0 = m * 16 + g, r1 = r0 + 8;
      const float* x0 = src + kb * RTS;
      const float* x8 = src + (kb + 8) * RTS;
      af[m][0] = bf16x2(x0[r0], x0[RTS + r0]);
      af[m][1] = r1 < RT ? bf16x2(x0[r1], x0[RTS + r1]) : 0u;
      af[m][2] = bf16x2(x8[r0], x8[RTS + r0]);
      af[m][3] = r1 < RT ? bf16x2(x8[r1], x8[RTS + r1]) : 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = warp + 8 * (i0 + i);
      if (n >= nt) continue;
      const __nv_bfloat16* wr = w + (n * 8 + g) * sst + s * 16 + 2 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + 8);
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m * 16 < rows)
          asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(acc[m][i][0]), "+f"(acc[m][i][1]), "+f"(acc[m][i][2]),
              "+f"(acc[m][i][3])
            : "r"(af[m][0]), "r"(af[m][1]), "r"(af[m][2]), "r"(af[m][3]),
              "r"(b0), "r"(b1));
    }
  }
}

// One layer of the bf16 ring pass on the tensor cores: mma.sync m16n8k16,
// A = the block's rows (MT tiles of 16; rows past RT read as 0; tiles past
// rg.rows skipped), B = the packed transposed weights.  In a pass over a
// chunk warp w owns the n-tiles w, w + 8, ..., w + 24 (256 columns); a
// wider layer takes several passes over each chunk, the accumulators parked
// in dst between chunks (stored and reloaded as they are: the mma's f32
// sums continue unchanged).  Writes the bf16-rounded inputs of the next
// layer, zero in the k padding up to a multiple of 16.
template <int RT>
__device__ void ring_layer_bf16(const Args& a, const __nv_bfloat16* wm,
                                Ring& rg, int l, const float* B,
                                const float* src, float* dst, bool last) {
  constexpr int RTS = ring_rts<RT>(), MT = RT > 16 ? 2 : 1;
  const int dout = a.sizes[l + 1], kc = a.ring_kc[l];
  const int din16 = round_up(a.sizes[l], 16), nt = round_up(dout, 8) / 8;
  const int passes = (nt + 31) / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
  for (int c = 0; c < a.ring_nch[l]; ++c) {
    const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(
        ring_acquire<__nv_bfloat16>(a, wm, rg));
    const int k0 = c * kc, kcc = min(kc, din16 - k0);
    if (passes == 1) {
      mma_chunk<RT>(src, w, k0, kcc, rg.rows, nt, 0, acc);
      continue;
    }
    for (int ps = 0; ps < passes; ++ps) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = m * 16 + g + (e >> 1) * 8;
            const int j = (warp + 8 * (4 * ps + i)) * 8 + 2 * t + (e & 1);
            acc[m][i][e] = c > 0 && r < rg.rows && j < dout
                               ? dst[j * RTS + r] : 0.f;
          }
      mma_chunk<RT>(src, w, k0, kcc, rg.rows, nt, 4 * ps, acc);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = m * 16 + g + (e >> 1) * 8;
            const int j = (warp + 8 * (4 * ps + i)) * 8 + 2 * t + (e & 1);
            if (r < rg.rows && j < dout) dst[j * RTS + r] = acc[m][i][e];
          }
    }
  }
  if (passes == 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = warp + 8 * i;
        if (n >= nt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m * 16 + g + (e >> 1) * 8, j = n * 8 + 2 * t + (e & 1);
          if (r >= rg.rows || j >= dout) continue;
          float x = acc[m][i][e] + __ldg(B + j);
          if (!last) x = mlp_in<__nv_bfloat16>(leaky(x));
          dst[j * RTS + r] = x;
        }
      }
  } else {
    __syncthreads();  // the parked sums of every warp are in dst
    for (int j = threadIdx.x; j < dout; j += kThreads) {
      const float bj = __ldg(B + j);
      for (int r = 0; r < rg.rows; ++r) {
        float x = dst[j * RTS + r] + bj;
        if (!last) x = mlp_in<__nv_bfloat16>(leaky(x));
        dst[j * RTS + r] = x;
      }
    }
  }
  const int pad = (round_up(dout, 16) - dout) * rg.rows;
  for (int p = threadIdx.x; p < pad; p += kThreads)
    dst[(dout + p / rg.rows) * RTS + p % rg.rows] = 0.f;
}

// The ring pass over all layers; src holds the layer-0 input (k-major, rows
// 0..1; in bf16 zero up to 16).  Returns the buffer holding the [1, RT]
// output.  All threads of the block call it.
template <int RT, typename WT>
__device__ float* mlp_ring(const Args& a, const WT* wm, const float* bm,
                           Ring& rg, float* src, float* dst) {
  const float* B = bm;
  for (int l = 0; l < a.n_layers; ++l) {
    const bool last = l == a.n_layers - 1;
    if constexpr (sizeof(WT) == 4)
      ring_layer_f32<RT>(a, wm, rg, l, B, src, dst, last);
    else
      ring_layer_bf16<RT>(a, wm, rg, l, B, src, dst, last);
    B += a.sizes[l + 1];
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  __syncthreads();
  return src;
}

// ---------------------------------------------------------------------------
// The sweeps' layer pass (B2, B6): weights in a cluster's shared memory,
// activations exchanged through DSMEM (see the header).
// ---------------------------------------------------------------------------

// The kernels' layer passes: mlp(), mlp_ring(), mlp_cluster(),
// mlp_ring_split()
enum Pass { kGlobal = 0, kRing = 1, kCluster = 2, kSplit = 3 };

// A cluster-pass thread task: TR rows x kClusterCols columns, TR = 2 at 8
// and 16 rows, 4 at 32.  Each k-step loads the task's weights and inputs
// once from shared memory for TR x kClusterCols FMAs: at the sweeps' 7 rows
// the loads, not the FMAs, pace the chains (PERF.md,
// scripts/probe_cluster_pass_torch.py).  A slice's columns are a multiple
// of kClusterCols (CLUSTER_COLS in ops/fused_solve.py).
constexpr int kClusterCols = 2;
template <int RT>
__host__ __device__ constexpr int cluster_tr() { return RT < 32 ? 2 : 4; }

// A block's shared state.  The activation buffers h0, h1 hold element
// (row r, column k) at r * ld_r + k * ld_k: row-major [RT, wmax] for mlp(),
// k-major [round16(wmax), ring_rts] for mlp_ring(); for mlp_cluster() h0 is
// the layer-0 input and h1 the output, [2, ring_rts] each, k-major, and the
// exchange buffers e0, e1, e2 are [wmax, ring_rts]; w is its slice of the
// weights (cluster pass only).  mlp_ring_split() has h0, h1 as
// mlp_cluster() and two exchange buffers e0, e1 [round16(wmax),
// ring_rts].
template <int RT>
struct Smem {
  float* e0;
  float* e1;
  float* e2;
  float* h0;
  float* h1;
  const float* w;
  float* k;      // [7, RT, 2]
  float* y;      // [RT, 2]
  float* f;      // [RT, 2]
  float* yi;     // [RT, 2]
  float* v;      // [RT]
  float* rprev;  // [RT]
  int* alive;    // [RT]
  int* pend;     // [RT]
  int ld_r, ld_k;

  __device__ Smem(float* base, const Args& a, int pass,
                  const float* weights) {
    ld_r = pass != kGlobal ? 1 : a.wmax;
    ld_k = pass != kGlobal ? ring_rts<RT>() : 1;
    e0 = base;
    e1 = e0 + ex(a.wmax, pass);
    e2 = e1 + ex(a.wmax, pass);
    h0 = e2 + (pass == kCluster ? ex(a.wmax, pass) : 0);
    h1 = h0 + act(a.wmax, pass);
    w = weights;
    k = h1 + act(a.wmax, pass);
    y = k + 7 * RT * 2;
    f = y + RT * 2;
    yi = f + RT * 2;
    v = yi + RT * 2;
    rprev = v + RT;
    alive = reinterpret_cast<int*>(rprev + RT);
    pend = alive + RT;
  }

  // floats of one activation buffer, of one exchange buffer
  __host__ __device__ static int act(int wmax, int pass) {
    return pass == kCluster || pass == kSplit ? 2 * ring_rts<RT>()
           : pass == kRing ? round_up(wmax, 16) * ring_rts<RT>()
                           : RT * wmax;
  }
  __host__ __device__ static int ex(int wmax, int pass) {
    return pass == kCluster ? wmax * ring_rts<RT>()
           : pass == kSplit ? round_up(wmax, 16) * ring_rts<RT>()
                            : 0;
  }

  // (ops/fused_solve.py::cluster_smem_bytes and ring_split_smem_bytes
  // repeat this for the size rules)
  static size_t bytes(int wmax, int pass) {
    return sizeof(float) * ((size_t)2 * act(wmax, pass) +
                            (size_t)(pass == kCluster ? 3 : 2) *
                                ex(wmax, pass) +
                            7 * RT * 2 + 3 * RT * 2 + 2 * RT) +
           sizeof(int) * 2 * RT;
  }
};

// The split ring pass over all layers (B1's popsweep where the widest layer
// takes more than one column pass; see the header).  s.h0 holds the layer-0 input (k-major,
// the rows of rhs()); returns s.h1, holding the [RT] output.  Layer l
// streams the rank's row through the ring: layer 0 whole into the exchange
// buffer the next exchange reads, each sliced layer its columns into every
// block's other buffer, then one cluster barrier; the last layer whole from
// the last exchange's buffer into s.h1.  Exchange n (rg.ex, counted across
// evaluations) writes e[n & 1] and layer 0 before it e[(n + 1) & 1], so
// one barrier a layer orders both hazards: a block arrives only after it
// has read its input and stored its outputs, and the buffer exchange n
// writes was last read by exchange n - 1, before the barrier n - 1.  All
// threads of every block of the cluster call it.
template <int RT>
__device__ float* mlp_ring_split(const Args& a, const Smem<RT>& s,
                                 const float* wm, const float* bm, Ring& rg) {
  const float* B = bm;
  const float* src = s.h0;
  for (int l = 0; l < a.n_layers; ++l) {
    const bool last = l == a.n_layers - 1;
    const bool sliced = a.cl_cols[l] < a.sizes[l + 1];
    float* dst = last ? s.h1 : (rg.ex + !sliced) & 1 ? s.e1 : s.e0;
    ring_layer_f32<RT, true>(a, wm, rg, l, B, src, dst, last);
    if (sliced) {
      cluster_barrier();
      ++rg.ex;
    }
    B += a.sizes[l + 1];
    src = dst;
  }
  __syncthreads();
  return s.h1;
}

// Copy this block's slice of the weights (its rank's packed row) into s.w,
// one bulk copy per layer on one mbarrier, and wait for it.  All threads
// call it, once per launch.
template <int RT>
__device__ void cluster_load(const Args& a, const Smem<RT>& s, uint64_t* bar,
                             int rank) {
  if (threadIdx.x == 0) {
    const uint32_t b = smem_addr(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(a.cl_floats * 4)
        : "memory");
    const float* src = static_cast<const float*>(a.w) +
                       (size_t)rank * a.cl_floats;
    for (int l = 0; l < a.n_layers; ++l) {
      const int end = l + 1 < a.n_layers ? a.cl_off[l + 1] : a.cl_floats;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s.w + a.cl_off[l])),
          "l"(src + a.cl_off[l]), "r"((end - a.cl_off[l]) * 4), "r"(b)
          : "memory");
    }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  bar_wait(bar, 0);
  // every block of the cluster runs before any block stores into it
  cluster_barrier();
}

// The cluster pass over all layers (see the header).  s.h0 holds the
// layer-0 input (k-major, rows 0..nr-1); returns s.h1, holding the [RT]
// output.  All threads of every block of the cluster call it.
template <int RT>
__device__ float* mlp_cluster(const Args& a, const Smem<RT>& s, int nr) {
  constexpr int RTS = ring_rts<RT>(), TR = cluster_tr<RT>(), RG = RT / TR;
  constexpr int TC = kClusterCols;
  const int rank = blockIdx.x % a.csize;
  const float* src = s.h0;
  int n_ex = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.sizes[l], dout = a.sizes[l + 1], cols = a.cl_cols[l];
    const float* W = s.w + a.cl_off[l];  // [din, cols], then cols biases
    if (dout == 1) {
      // the last layer, in every block: warp 0 splits the k sum over its
      // lanes exactly as mlp() does
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.f;
        for (int k = lane; k < din; k += 32) {
          const float wk = W[k];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(src[k * RTS + r], wk, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
        }
        if (lane == 0) {
          const float bj = W[din];
#pragma unroll
          for (int r = 0; r < RT; ++r)
            if (r < nr) s.h1[r] = acc[r] + bj;
        }
      }
      __syncthreads();
    } else {
      // layer 0, whole in every block, into e1 (no peer writes e1 before
      // the first exchange's barrier); a hidden layer: this block's
      // columns, pushed to every block, into e0, e1 in turn and e2 for the
      // evaluation's last exchange
      const bool whole = cols >= dout;
      float* dst = whole                 ? s.e1
                   : n_ex == a.cl_ex - 1 ? s.e2
                   : n_ex & 1            ? s.e1
                                         : s.e0;
      const int j0 = whole ? 0 : rank * cols, ncg = cols / TC;
      for (int t = threadIdx.x; t < RG * ncg; t += kThreads) {
        const int rg = t / ncg, c0 = (t - rg * ncg) * TC;
        const int r0 = rg * TR, j = j0 + c0;
        if (r0 >= nr || j >= dout) continue;
        float acc[TC][TR];
#pragma unroll
        for (int c = 0; c < TC; ++c)
#pragma unroll
          for (int r = 0; r < TR; ++r) acc[c][r] = 0.f;
        const float* xp = src + r0;
        const float* wp = W + c0;
        // 32 k-steps' loads in flight before their FMAs: 10% faster than 8
        // at the sweeps' 7 rows (PERF.md)
#pragma unroll 32
        for (int k = 0; k < din; ++k) {
          float w[TC], x[TR];
          load_rows<TC>(wp + k * cols, w);
          load_rows<TR>(xp + k * RTS, x);
#pragma unroll
          for (int c = 0; c < TC; ++c)
#pragma unroll
            for (int r = 0; r < TR; ++r) acc[c][r] = fmaf(x[r], w[c], acc[c][r]);
        }
        float bj[TC];
        load_rows<TC>(W + din * cols + c0, bj);
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          if (j + c >= dout) break;
          float y[TR];
#pragma unroll
          for (int r = 0; r < TR; ++r) y[r] = leaky(acc[c][r] + bj[c]);
          float* out = dst + (j + c) * RTS + r0;
          if (whole) {
#pragma unroll
            for (int r = 0; r < TR; ++r) out[r] = y[r];
          } else {
            push<TR>(smem_addr(out), y, a.csize);
          }
        }
      }
      if (whole) {
        __syncthreads();
      } else {
        cluster_barrier();
        ++n_ex;
      }
      src = dst;
    }
  }
  return s.h1;
}

// f(t, ysrc) for this block's lanes into kdst [RT, 2], through the layer
// pass PASS names
template <int RT, typename WT, int PASS>
__device__ void rhs(const Args& a, const Smem<RT>& s, const WT* wm,
                    const float* bm, Ring& rg, int row0, int nr, float t,
                    const float* ysrc, float* kdst) {
  constexpr bool RING = PASS == kRing || PASS == kSplit;
  const int tid = threadIdx.x;
  if (tid < nr) {
    const float v = voltage(a, row0 + tid, t);
    s.v[tid] = v;
    s.h0[tid * s.ld_r] = mlp_in<WT>(__fdiv_rn(v, 100.f));
    s.h0[tid * s.ld_r + s.ld_k] = mlp_in<WT>(ysrc[tid * 2]);
    if (RING && sizeof(WT) == 2)  // the mma's k padding of layer 0
      for (int c = 2; c < 16; ++c) s.h0[tid * s.ld_r + c * s.ld_k] = 0.f;
  }
  __syncthreads();
  const float* out;
  if constexpr (PASS == kCluster)
    out = mlp_cluster<RT>(a, s, nr);
  else if constexpr (PASS == kSplit)
    out = mlp_ring_split<RT>(a, s, wm, bm, rg);
  else if constexpr (RING)
    out = mlp_ring<RT, WT>(a, wm, bm, rg, s.h0, s.h1);
  else
    out = mlp<RT, WT>(a, wm, bm, s.h0, s.h1, nr);
  if (tid < nr) {
    const float v = s.v[tid];
    const float ga = ysrc[tid * 2], gr = ysrc[tid * 2 + 1];
    // a padded row (a copy of row rg.rows - 1, so its MLP input is that
    // row's bit for bit) takes that row's output
    const int ro = RING ? min(tid, rg.rows - 1) : tid;
    float dadt = __fdiv_rn(out[ro * s.ld_r], 1000.f);
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
template <int RT, typename WT, int PASS>
__device__ void attempt(const Args& a, const Smem<RT>& s, const WT* wm,
                        const float* bm, Ring& rg, int row0, int nr, float t,
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
    rhs<RT, WT, PASS>(a, s, wm, bm, rg, row0, nr,
                      add(t, mul(kC[si], h_eff)), s.yi, s.k + si * RT * 2);
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

// Grid-wide (max, sum) of one value per unit: a block, or in the cluster
// pass a cluster, whose blocks hold the same values and whose rank 0 writes
// them.  All threads call it; the block's values are read from thread 0.
// Slots alternate by `seq` parity: a block can only overwrite a slot after
// every block has passed the barrier that follows the last read of it.  The
// max propagates NaN.  One cluster alone needs no barrier: its values are
// the launch's.
__device__ void grid_reduce(const Args& a, cg::grid_group& grid, int& seq,
                            float lmax, int lcnt, float* gmax, int* gcnt,
                            float* red_m, int* red_c) {
  const int units = gridDim.x / a.csize;
  if (a.csize > 1 && units == 1) {
    if (threadIdx.x == 0) {
      *red_m = lmax;
      *red_c = lcnt;
    }
    __syncthreads();
    *gmax = *red_m;
    *gcnt = *red_c;
    __syncthreads();
    return;
  }
  Partial* slots = a.part + (size_t)(seq & 1) * units;
  if (threadIdx.x == 0 && blockIdx.x % a.csize == 0) {
    slots[blockIdx.x / a.csize].max_ratio = lmax;
    slots[blockIdx.x / a.csize].alive = lcnt;
  }
  grid.sync();
  if (threadIdx.x < 32) {
    float m = 0.f;
    int c = 0;
    for (int b = threadIdx.x; b < units; b += 32) {
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

// PASS picks the layer pass: mlp_ring() (B1, B4; its stages lead the
// dynamic shared memory), mlp_ring_split() (B1 in f32 on clusters, its
// stages leading too), mlp_cluster() (B2, f32; its weight slice leads)
// or mlp() (B2, f32)
template <int RT, typename WT, int PASS>
__global__ void __launch_bounds__(kThreads, 1) trip_kernel(Args a) {
  constexpr bool SPLIT = PASS == kSplit;
  constexpr bool RING = PASS == kRing || SPLIT, CLUSTER = PASS == kCluster;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ float red_m;
  __shared__ int red_c;
  __shared__ uint64_t ring_bar[kStages];
  const int lead = RING      ? kStages * a.stage_bytes
                   : CLUSTER ? a.cl_floats * 4
                             : 0;
  const Smem<RT> s(reinterpret_cast<float*>(dyn + lead), a, PASS,
                   reinterpret_cast<const float*>(dyn));

  const int tid = threadIdx.x;
  // a unit is a block, or a cluster of a.csize blocks (consecutive in x)
  const int unit = blockIdx.x / a.csize;
  const bool writer = blockIdx.x % a.csize == 0;
  const int member = unit / a.tiles;
  const int row0 = (unit % a.tiles) * a.rt;
  const int nr = min(a.rt, a.q - row0);
  const bool lane = tid < nr;
  // the split pass streams the rank's row of its member
  const WT* wm = static_cast<const WT*>(a.w) +
                 (SPLIT ? (size_t)member * a.csize + blockIdx.x % a.csize
                        : (size_t)member) *
                     a.w_stride;
  const float* bm = a.b + (size_t)member * a.b_stride;
  const size_t pq2 = (size_t)a.p * a.q * 2;
  const size_t lane_off = ((size_t)member * a.q + row0 + tid) * 2;
  int seq = 0;
  Ring rg{};
  rg.rows = max(1, min(nr, a.q_real - row0));
  if (RING) ring_start<WT, SPLIT>(a, wm, rg, dyn, ring_bar);
  if (CLUSTER) cluster_load<RT>(a, s, ring_bar, blockIdx.x % a.csize);
  if (SPLIT) {
    rg.rank = blockIdx.x % a.csize;
    // every block of the cluster runs before any block stores into it
    cluster_barrier();
  }

  // ---- initial state: dead lanes (non-finite y0 or f0) reset to rest ----
  if (lane) {
    s.y[tid * 2] = a.y0[lane_off];
    s.y[tid * 2 + 1] = a.y0[lane_off + 1];
  }
  __syncthreads();
  rhs<RT, WT, PASS>(a, s, wm, bm, rg, row0, nr, a.t0, s.y, s.f);
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
      attempt<RT, WT, PASS>(a, s, wm, bm, rg, row0, nr, t, h_eff);

      float r = 0.f, rc = 0.f, y1[2] = {0.f, 0.f};
      bool bad = false;
      if (lane) {
        float sc[2];
        r = lane_error<RT>(a, s, tid, h_eff, y1, sc);
        r = add(r, mul(add(sc[0], sc[1]), 0.f));
        bad = !(r < INFINITY);
        rc = bad ? 3.4e38f : r;
        if (writer) record<RT>(a, s, tid, i, pq2, lane_off);  // this attempt
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

  if (lane && writer)
    a.alive_out[(size_t)member * a.q + row0 + tid] = s.alive[tid] ? 1 : 0;
  if (blockIdx.x == 0 && tid == 0) {
    a.n_out[0] = t >= a.t_end ? n_acc : -max(n_acc, 1);
    a.n_out[1] = blk * a.block;
  }
  // the ring runs kStages - 1 chunks ahead: let no copy outlive the block
  if (RING) ring_drain(rg);
  // no block leaves while a peer may still store into its shared memory
  if (CLUSTER || SPLIT) cluster_barrier();
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
// and one grid barrier per step (none with one cluster).  It takes
// trip_kernel's layer passes but the ring: PASS is kCluster or kGlobal.
// ---------------------------------------------------------------------------
template <int RT, int PASS>
__global__ void __launch_bounds__(kThreads, 1) while_kernel(Args a) {
  constexpr bool CLUSTER = PASS == kCluster;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ float red_m;
  __shared__ int red_c;
  __shared__ uint64_t cl_bar;
  const int lead = CLUSTER ? a.cl_floats * 4 : 0;
  const Smem<RT> s(reinterpret_cast<float*>(dyn + lead), a, PASS,
                   reinterpret_cast<const float*>(dyn));
  Ring rg{};  // unused: no ring here

  const int tid = threadIdx.x;
  const bool writer = blockIdx.x % a.csize == 0;
  const int row0 = blockIdx.x / a.csize * a.rt;
  const int nr = min(a.rt, a.q - row0);
  const bool lane = tid < nr;
  const float* wm = static_cast<const float*>(a.w);
  const size_t pq2 = (size_t)a.q * 2;
  const size_t lane_off = ((size_t)row0 + tid) * 2;
  int seq = 0;
  if (CLUSTER) cluster_load<RT>(a, s, &cl_bar, blockIdx.x % a.csize);

  if (lane) {
    s.y[tid * 2] = 0.f;
    s.y[tid * 2 + 1] = 1.f;
  }
  __syncthreads();
  rhs<RT, float, PASS>(a, s, wm, a.b, rg, row0, nr, a.t0, s.y, s.f);

  float t = a.t0, h = a.h0, lmax = 0.f, gmax;
  int n_acc = 0, n_step = 0, lcnt = 0, gcnt;
  bool go = true;
  while (go) {
    const float h_eff = nanmax(fminf(h, sub(a.t_end, t)), 1e-8f);
    attempt<RT, float, PASS>(a, s, wm, a.b, rg, row0, nr, t, h_eff);
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
        if (writer) record<RT>(a, s, tid, n_acc, pq2, lane_off);
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
  if (CLUSTER) cluster_barrier();
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

// The configuration of a launch of `kern` over `units` clusters of `csize`
// blocks (the cluster attribute; the cooperative one in at[1] for the
// caller to add), after setting the kernel's shared memory, and how many
// such clusters the card holds at once
template <typename Kern>
cudaError_t cluster_config(Kern kern, int csize, int units, size_t smem,
                           cudaLaunchAttribute (&at)[2],
                           cudaLaunchConfig_t& cfg, int* most) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (csize > 8 &&
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return err;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = csize;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg = {};
  cfg.gridDim = dim3(units * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(most, (const void*)kern, &cfg);
}

// One launch of `kern` over `units` clusters of a.csize blocks, after
// checking that they can all be resident at once.  Several clusters share
// a grid barrier, so their launch is cooperative too: the runtime takes the
// cluster dimension and the cooperative attribute together
// (scripts/probe_cluster_launch_torch.py).
template <typename Kern>
cudaError_t launch_cluster(Kern kern, Args& a, int units, size_t smem,
                           cudaStream_t stream) {
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg;
  int most = 0;
  cudaError_t err = cluster_config(kern, a.csize, units, smem, at, cfg,
                                   &most);
  if (err != cudaSuccess) return err;
  if (most < units) return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  cfg.numAttrs = units > 1 ? 2 : 1;
  void* args[] = {&a};
  return cudaLaunchKernelExC(&cfg, (const void*)kern, args);
}

template <int RT, int PASS>
size_t trip_smem(const Args& a) {
  return Smem<RT>::bytes(a.wmax, PASS) +
         (PASS == kRing || PASS == kSplit ? (size_t)kStages * a.stage_bytes
          : PASS == kCluster              ? (size_t)a.cl_floats * 4
                                          : 0);
}

// Whether each sliced layer of the split pass takes one pass of the
// block's threads at RT rows (ring_layer_f32 keeps no running sums of a
// sliced layer)
template <int RT>
bool split_one_pass(const Args& a) {
  constexpr int TR = ring_tr<RT>();
  constexpr int NT = (RT / TR * 64 + kThreads - 1) / kThreads;
  for (int l = 0; l < a.n_layers; ++l)
    if (a.cl_cols[l] < a.sizes[l + 1] &&
        RT / TR * (a.cl_cols[l] / 4) > NT * kThreads)
      return false;
  return true;
}

template <int RT, int PASS>
cudaError_t launch_trip(Args& a, bool bf16, cudaStream_t stream) {
  const size_t smem = trip_smem<RT, PASS>(a);
  const int grid = a.p * a.tiles;
  if constexpr (PASS == kCluster || PASS == kSplit) {
    if (PASS == kSplit && !split_one_pass<RT>(a))
      return cudaErrorInvalidValue;
    return launch_cluster(trip_kernel<RT, float, PASS>, a, grid, smem,
                          stream);
  } else {
    if (!bf16) return launch_coop(trip_kernel<RT, float, PASS>, a, grid,
                                  smem, stream);
    if constexpr (PASS == kGlobal || (PASS == kRing && RT > 1))
      return launch_coop(trip_kernel<RT, __nv_bfloat16, PASS>, a, grid, smem,
                         stream);
    return cudaErrorInvalidValue;  // bf16 through the ring needs RT >= 8
  }
}

// The trip kernel at row-tile instantiation RT, through the pass the entry
// point asks for
template <int RT>
cudaError_t launch_trip_rt(Args& a, int ring, bool bf16, cudaStream_t s) {
  if (ring && a.csize > 1) return launch_trip<RT, kSplit>(a, false, s);
  if (ring) return launch_trip<RT, kRing>(a, bf16, s);
  if (a.csize > 1) return launch_trip<RT, kCluster>(a, false, s);
  return launch_trip<RT, kGlobal>(a, bf16, s);
}

// The clusters of csize blocks of the split pass's kernel at RT rows, at
// its shared memory for layers up to wmax wide and stages of stage_bytes,
// that the card holds at once
template <int RT>
cudaError_t split_clusters(int csize, int wmax, int stage_bytes, int* most) {
  Args a{};
  a.wmax = wmax;
  a.stage_bytes = stage_bytes;
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg;
  return cluster_config(trip_kernel<RT, float, kSplit>, csize, 1,
                        trip_smem<RT, kSplit>(a), at, cfg, most);
}

template <int RT>
cudaError_t launch_while(Args& a, cudaStream_t stream) {
  if (a.csize > 1)
    return launch_cluster(while_kernel<RT, kCluster>, a, a.tiles,
                          Smem<RT>::bytes(a.wmax, kCluster) +
                              (size_t)a.cl_floats * 4,
                          stream);
  return launch_coop(while_kernel<RT, kGlobal>, a, a.tiles,
                     Smem<RT>::bytes(a.wmax, kGlobal), stream);
}

// The cluster pass's fields from the wrapper's geometry (csize blocks per
// cluster; per layer its offset and columns; a rank's floats); false if the
// net or the geometry is out of its range: P = 1, every hidden layer at
// least 2 wide, 2..16 blocks, each layer's slice a whole number of 16-byte
// words that covers its columns and bias, layer 0 and the last layer whole,
// the others sliced
bool init_cluster(Args& a, int csize, const int* cgeom, int cl_floats) {
  a.csize = 1;
  a.cl_ex = 0;
  if (csize <= 1) return true;
  if (csize > 16 || a.p != 1 || cl_floats < 4 || cl_floats % 4) return false;
  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.sizes[l], dout = a.sizes[l + 1];
    const int off = cgeom[2 * l], cols = cgeom[2 * l + 1];
    const int end = l + 1 < a.n_layers ? cgeom[2 * l + 2] : cl_floats;
    // whole in every block: layer 0 (cols = out) and the last (out 1)
    const bool whole = l == 0 || dout == 1;
    if (off % 4 || end - off < (din + 1) * cols || cols < 1 ||
        (dout == 1) != (l == a.n_layers - 1) ||
        (dout > 1 && cols % kClusterCols) ||
        (whole ? cols < dout || cols >= dout + kClusterCols
               : cols * csize < dout || cols >= dout))
      return false;
    a.cl_off[l] = off;
    a.cl_cols[l] = cols;
    a.cl_ex += !whole;
  }
  a.csize = csize;
  a.cl_floats = cl_floats;
  return true;
}

// The split ring pass's fields (csize blocks per cluster; per layer its
// columns per block in cgeom[2 l + 1]); false if out of range: 2..8 blocks,
// layer 0 and the last layer whole (round4(out) columns), every other layer
// sliced: a multiple of 4 columns (the f32 tile's column group), fewer than
// its outputs, csize slices covering them
bool init_split(Args& a, int csize, const int* cgeom) {
  a.csize = 1;
  if (csize <= 1) return true;
  if (csize > 8) return false;
  for (int l = 0; l < a.n_layers; ++l) {
    const int dout = a.sizes[l + 1], cols = cgeom[2 * l + 1];
    const bool whole = l == 0 || l == a.n_layers - 1;
    if (cols % 4 || (whole ? cols != round_up(dout, 4)
                           : cols >= dout || cols * csize < dout))
      return false;
    a.cl_cols[l] = cols;
  }
  a.csize = csize;
  return true;
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
  a.csize = 1;
  return true;
}

}  // namespace

extern "C" int ionflux_trip_solve(
    const float* vpad, const float* y0, const void* w, long long w_stride,
    const float* b, long long b_stride, int bf16, float* rec_sc, float* rec_y,
    float* rec_k, int* n_out, uint8_t* alive_out, void* partial,
    const int* sizes, int n_layers, int p, int q, int n_pad, int rt,
    int trips, int block, int cull, int has_base, const float* scal,
    int ring, const int* geom, int stage_bytes, int q_real, int csize,
    const int* cgeom, int cl_floats, void* stream) {
  Args a;
  // csize > 1: the sweeps' cluster pass, or with the ring its split
  if (!init_args(a, vpad, sizes, n_layers, p, q, n_pad, rt, scal) ||
      block < 1 || trips % block != 0 || (csize > 1 && bf16) ||
      !(ring ? init_split(a, csize, cgeom)
             : init_cluster(a, csize, cgeom, cl_floats)) ||
      (a.csize > 1 && ring && rt == 1))
    return (int)cudaErrorInvalidValue;
  if (ring) {
    // geom: (offset, chunk depth, chunks) per layer, from the wrapper's
    // packing, in 16-byte stages (the launch refuses a block whose stages
    // and activation buffers exceed the shared memory it may take)
    if (stage_bytes < 16 || stage_bytes % 16)
      return (int)cudaErrorInvalidValue;
    for (int l = 0; l < n_layers; ++l) {
      a.ring_off[l] = geom[3 * l];
      a.ring_kc[l] = geom[3 * l + 1];
      a.ring_nch[l] = geom[3 * l + 2];
      if (a.ring_kc[l] < 1 || a.ring_nch[l] < 1)
        return (int)cudaErrorInvalidValue;
    }
    a.stage_bytes = stage_bytes;
    a.q_real = q_real < 1 || q_real > q ? q : q_real;
  }
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
  if (ring && rt == 1 && !bf16)
    err = launch_trip<1, kRing>(a, false, s);
  else if (!ring && rt == 1 && a.csize == 1)  // mlp() at one row per block
    err = launch_trip<1, kGlobal>(a, bf16 != 0, s);
  else if (rt <= 8)
    err = launch_trip_rt<8>(a, ring, bf16 != 0, s);
  else if (rt <= 16)
    err = launch_trip_rt<16>(a, ring, bf16 != 0, s);
  else
    err = launch_trip_rt<32>(a, ring, bf16 != 0, s);
  return (int)err;
}

extern "C" int ionflux_while_solve(
    const float* vpad, const float* w, const float* b, float* rec_sc,
    float* rec_y, float* rec_k, int* n_out, void* partial, const int* sizes,
    int n_layers, int q, int n_pad, int rt, int max_rec, int max_steps,
    const float* scal, int csize, const int* cgeom, int cl_floats,
    void* stream) {
  Args a;
  if (!init_args(a, vpad, sizes, n_layers, 1, q, n_pad, rt, scal) ||
      max_rec < 1 || max_steps < 1 ||
      !init_cluster(a, csize, cgeom, cl_floats))
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

// The clusters of csize blocks of the split ring pass's kernel at rt rows
// (its instantiation), for layers up to wmax wide and ring stages of
// stage_bytes, that the current device holds at once: the wrapper's size
// rule (ops/fused_solve.py::ring_split) asks once per device and shape
extern "C" int ionflux_ring_split_clusters(int rt, int csize, int wmax,
                                           int stage_bytes, int* most) {
  *most = 0;
  if (rt < 1 || rt > 32 || csize < 2 || csize > 8 || wmax < 1 ||
      stage_bytes < 16 || stage_bytes % 16)
    return (int)cudaErrorInvalidValue;
  if (rt <= 8) return (int)split_clusters<8>(csize, wmax, stage_bytes, most);
  if (rt <= 16)
    return (int)split_clusters<16>(csize, wmax, stage_bytes, most);
  return (int)split_clusters<32>(csize, wmax, stage_bytes, most);
}

extern "C" const char* ionflux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
