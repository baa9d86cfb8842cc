#!/usr/bin/env python
"""What the card offers the sweeps' cluster layer pass: a probe of
thread-block clusters on one H100.

    python3 scripts/probe_cluster_launch_torch.py [--rounds 20000]

Builds a small CUDA source (below) with nvcc into ``ionflux_torch/_build/``
and reports, as one JSON line beside the card's name and power limit:

- ``max_clusters``: ``cudaOccupancyMaxActiveClusters`` for clusters of 8
  and 16 blocks of 256 threads at 160 KB and at 227 KB of dynamic shared
  memory (one block per SM);
- ``launch``: for each cluster size and 1, 4 and the most co-resident
  clusters, whether ``cudaLaunchKernelEx`` takes the cluster dimension
  together with the cooperative attribute, and whether a kernel so launched
  sees its DSMEM stores after each cluster barrier and passes
  ``grid.sync()`` (counted errors must be 0);
- ``us_per_exchange``: the microseconds of one exchange as the cluster
  pass makes it (every block stores its slice of a layer, ``words`` floats,
  into every peer's shared memory, then one cluster barrier), for the
  slices of a 200-wide layer at 8 and 32 rows, and the same with a
  ``grid.sync()`` after each barrier over 4 clusters (CUDA events over
  ``--rounds`` exchanges in one launch).

Without a card it exits with an error.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void st_peer(uint32_t addr, int rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// rounds of: store my `words` floats into slot `rank` of every peer's
// buffer (rounds alternate two buffers), one cluster barrier, optionally
// check every slot, optionally one grid.sync() with a counter check
__global__ void __launch_bounds__(256, 1)
probe_kernel(int rounds, int words, int use_grid, int verify, int* counter,
             int* errors) {
  extern __shared__ __align__(128) float buf[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  if (use_grid && !cg::this_grid().is_valid()) {
    if (threadIdx.x == 0) atomicAdd(errors, 1000000);
    return;
  }
  for (int w = threadIdx.x; w < 2 * cs * words; w += blockDim.x) buf[w] = -1.f;
  cluster_barrier();
  for (int it = 0; it < rounds; ++it) {
    float* dst = buf + (it & 1) * cs * words;
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      const uint32_t a = smem_addr(dst + rank * words + w);
      const float v = (float)((it % 1000) * 1000 + rank * 16 + (w & 15));
      for (int q = 0; q < cs; ++q) st_peer(a, q, v);
    }
    cluster_barrier();
    if (verify)
      for (int w = threadIdx.x; w < cs * words; w += blockDim.x) {
        const int q = w / words, i = w - q * words;
        if (dst[w] != (float)((it % 1000) * 1000 + q * 16 + (i & 15)))
          atomicAdd(errors, 1);
      }
    if (use_grid) {
      if (threadIdx.x == 0) atomicAdd(counter, 1);
      cg::this_grid().sync();
      if (threadIdx.x == 0 &&
          atomicAdd(counter, 0) < (it + 1) * (int)gridDim.x)
        atomicAdd(errors, 1);
      cg::this_grid().sync();
    }
  }
  cluster_barrier();
}

static cudaLaunchConfig_t config(int csize, int clusters, int smem,
                                 cudaLaunchAttribute* at, int coop,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * clusters);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = csize;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = coop;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cfg;
}

static cudaError_t prepare(int csize, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || csize <= 8) return err;
  return cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

extern "C" int probe_max_clusters(int csize, int smem, int* out) {
  cudaError_t err = prepare(csize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg = config(csize, 1, smem, at, 0, 0);
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)probe_kernel, &cfg);
}

extern "C" int probe_launch(int csize, int clusters, int smem, int coop,
                            int rounds, int words, int use_grid, int verify,
                            int* counter, int* errors, void* stream) {
  cudaError_t err = prepare(csize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg = config(csize, clusters, smem, at, coop,
                                  static_cast<cudaStream_t>(stream));
  void* args[] = {&rounds, &words, &use_grid, &verify, &counter, &errors};
  err = cudaLaunchKernelExC(&cfg, (const void*)probe_kernel, args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


def _library():
    from ionflux_torch.ops import _build

    digest = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
    path = os.path.join(_build.BUILD_DIR, f"libprobe_cluster_{digest}.so")
    if not os.path.exists(path):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        src = path[:-3] + ".cu"
        with open(src, "w") as fh:
            fh.write(SOURCE)
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", path,
                              src], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
        print(out.stdout + out.stderr, file=sys.stderr, flush=True)
    lib = ctypes.CDLL(path)
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.probe_max_clusters.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.probe_launch.argtypes = [i32] * 8 + [ptr, ptr, ptr]
    lib.probe_error_string.argtypes = [i32]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def main(rounds: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_cluster_launch_torch: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as C

    lib = _library()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    smem_small, smem_full = 160 * 1024, 232448

    def launch(csize, clusters, coop, rounds, words, use_grid, verify):
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.probe_launch(csize, clusters, smem_small, coop, rounds,
                               words, use_grid, verify, counter.data_ptr(),
                               errors.data_ptr(), stream)
        torch.cuda.synchronize()
        return err, int(errors.item())

    most = {}
    for csize in (8, 16):
        for smem in (smem_small, smem_full):
            n = ctypes.c_int(-1)
            err = lib.probe_max_clusters(csize, smem, ctypes.byref(n))
            most[f"C={csize} smem={smem}"] = (
                n.value if err == 0 else lib.probe_error_string(err).decode())
    runs = {}
    for csize in (8, 16):
        top = most[f"C={csize} smem={smem_small}"]
        for clusters in sorted({1, 4, top if isinstance(top, int) else 1}):
            err, bad = launch(csize, clusters, 1, 50, 200, 1, 1)
            runs[f"C={csize} clusters={clusters} cooperative"] = dict(
                launch=lib.probe_error_string(err).decode(), errors=bad)
        err, bad = launch(csize, 1, 0, 50, 800, 0, 1)
        runs[f"C={csize} clusters=1 plain"] = dict(
            launch=lib.probe_error_string(err).decode(), errors=bad)

    def per_round(csize, clusters, words, use_grid):
        launch(csize, clusters, use_grid, 100, words, use_grid, 0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err, _ = launch(csize, clusters, use_grid, rounds, words, use_grid, 0)
        end.record()
        end.synchronize()
        if err:
            return lib.probe_error_string(err).decode()
        return start.elapsed_time(end) * 1e3 / rounds

    timing = {}
    for csize in (8, 16):
        cs = -(-200 // csize)
        for rows in (8, 32):
            timing[f"C={csize} rows={rows} ({cs * rows} words)"] = per_round(
                csize, 1, cs * rows, 0)
        timing[f"C={csize} rows=8, grid.sync over 4 clusters"] = per_round(
            csize, 4, cs * 8, 1)
    out = {"card": C.device_line(), "max_clusters": most, "launch": runs,
           "us_per_exchange": timing, "rounds": rounds}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20000)
    main(ap.parse_args().rounds)
