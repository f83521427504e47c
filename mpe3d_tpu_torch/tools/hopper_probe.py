"""What the H100 gives the two kernel designs of the port's fp64 projection
and bf16 lifter: the fp64 tensor-core rate of each mma.sync shape, and how
fast blocks stream device memory into shared memory with cp.async and with
bulk (TMA) copies.

    python3 -m mpe3d_tpu_torch.tools.hopper_probe

Builds one CUDA program with ``nvcc`` into ``mpe3d_tpu_torch/_build/`` and
prints one line per measurement, after the card's name and power limit.
Needs a CUDA card and ``nvcc`` (``PATH`` or ``$CUDA_HOME/bin``).

* fp64 ``mma.sync`` (m8n8k4 from sm_80; m16n8k4, m16n8k8, m16n8k16 from
  sm_90): 2 blocks an SM of 4 or 8 warps, 8 independent accumulators a
  warp, operands in registers; TFLOP/s from CUDA events.
* streaming: each block reads 2 MB through an 8-stage ring of 4 or 16 KB
  stages in shared memory, with 16-byte ``cp.async`` from 256 threads, or
  with one bulk copy a stage completed on an ``mbarrier``; at 132, 66 and
  33 blocks; TB/s and GB/s an SM.
"""

from __future__ import annotations

import subprocess
import sys

from mpe3d_tpu_torch.ops import _build

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

// 8 accumulators a warp; SHAPE = k of m16n8k (4, 8, 16), 0 for m8n8k4
template <int SHAPE>
__global__ void mma_loop(double* out, int iters) {
  double d[8][4] = {};
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 1e-3 + i;
  for (int i = 0; i < 4; ++i) b[i] = blockIdx.x * 1e-3 + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (SHAPE == 4)
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
            "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
            : "+d"(d[c][0]), "+d"(d[c][1]), "+d"(d[c][2]), "+d"(d[c][3])
            : "d"(a[0]), "d"(a[1]), "d"(b[0]));
      else if (SHAPE == 8)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+d"(d[c][0]), "+d"(d[c][1]), "+d"(d[c][2]), "+d"(d[c][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
              "d"(b[1]));
      else if (SHAPE == 16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, "
            "{%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
            : "+d"(d[c][0]), "+d"(d[c][1]), "+d"(d[c][2]), "+d"(d[c][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
              "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
              "d"(b[2]), "d"(b[3]));
      else
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
            : "+d"(d[c][0]), "+d"(d[c][1]) : "d"(a[0]), "d"(b[0]));
    }
  }
  double s = 0;
  for (int c = 0; c < 8; ++c)
    for (int e = 0; e < 4; ++e) s += d[c][e];
  if (s == 123.456) out[0] = s;   // keeps the loop
}

__device__ __forceinline__ uint32_t su32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

constexpr int STAGES = 8;

// block b streams bytes [b * per, (b + 1) * per) through the ring with
// 16-byte cp.async from every thread
__global__ void cpasync_stream(const char* src, size_t per, int sb,
                               int* sink) {
  extern __shared__ __align__(128) char sm[];
  const char* base = src + blockIdx.x * per;
  const int n = per / sb;
  int acc = 0;
  auto issue = [&](int i) {
    if (i < n) {
      const uint32_t dst = su32(sm + (i % STAGES) * sb);
      for (int o = threadIdx.x * 16; o < sb; o += blockDim.x * 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(dst + o), "l"(base + (size_t)i * sb + o)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
    __syncthreads();
    acc += sm[(i % STAGES) * sb + threadIdx.x];
    __syncthreads();
    issue(i + STAGES - 1);
  }
  if (acc == 12345) sink[0] = acc;
}

// the same with one bulk copy a stage from thread 0, completed on an
// mbarrier
__global__ void bulk_stream(const char* src, size_t per, int sb, int* sink) {
  extern __shared__ __align__(128) char sm[];
  __shared__ __align__(8) uint64_t bar[STAGES];
  const char* base = src + blockIdx.x * per;
  const int n = per / sb;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(su32(&bar[s])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {
    if (i < n && threadIdx.x == 0) {
      const int s = i % STAGES;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
          :: "r"(su32(&bar[s])), "r"(sb) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(su32(sm + s * sb)), "l"(base + (size_t)i * sb), "r"(sb),
             "r"(su32(&bar[s])) : "memory");
    }
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  int acc = 0;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
          "[%1], %2; selp.u32 %0, 1, 0, p; }\n"
          : "=r"(done) : "r"(su32(&bar[s])), "r"(parity) : "memory");
    acc += sm[s * sb + threadIdx.x];
    __syncthreads();
    issue(i + STAGES - 1);
  }
  if (acc == 12345) sink[0] = acc;
}

template <typename F>
float time_ms(F run, cudaEvent_t e0, cudaEvent_t e1) {
  run();
  cudaDeviceSynchronize();
  cudaEventRecord(e0);
  run();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  double* out;
  cudaMalloc(&out, 8);
  const int iters = 2000;
  const char* names[] = {"m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16"};
  const int shapes[] = {0, 4, 8, 16};
  for (int si = 0; si < 4; ++si)
    for (int warps : {4, 8}) {
      const dim3 grid(sms * 2), block(32 * warps);
      const int shape = shapes[si];
      const float ms = time_ms([&] {
        if (shape == 4) mma_loop<4><<<grid, block>>>(out, iters);
        else if (shape == 8) mma_loop<8><<<grid, block>>>(out, iters);
        else if (shape == 16) mma_loop<16><<<grid, block>>>(out, iters);
        else mma_loop<0><<<grid, block>>>(out, iters);
      }, e0, e1);
      const double fma = shape ? 16.0 * 8 * shape : 256.0;
      const double flops = 2.0 * fma * 8 * iters * grid.x * warps;
      printf("mma f64 %s, %d warps a block: %.3f ms, %.1f TFLOP/s (%s)\n",
             names[si], warps, ms, flops / ms / 1e9,
             cudaGetErrorString(cudaGetLastError()));
    }
  const size_t per = 2 << 20;   // bytes a block
  char* buf;
  cudaMalloc(&buf, per * sms);
  cudaMemset(buf, 1, per * sms);
  int* sink;
  cudaMalloc(&sink, 4);
  for (int bulk = 0; bulk < 2; ++bulk)
    for (int sb : {4096, 16384})
      for (int nb : {sms, sms / 2, sms / 4}) {
        const size_t smem = STAGES * sb;
        cudaFuncSetAttribute(bulk ? (const void*)bulk_stream
                                  : (const void*)cpasync_stream,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        const float ms = time_ms([&] {
          if (bulk) bulk_stream<<<nb, 256, smem>>>(buf, per, sb, sink);
          else cpasync_stream<<<nb, 256, smem>>>(buf, per, sb, sink);
        }, e0, e1);
        printf("%s, %d-byte stages, %d blocks x %zu KB: %.3f ms, %.2f TB/s,"
               " %.1f GB/s an SM (%s)\n", bulk ? "bulk copy" : "cp.async",
               sb, nb, per >> 10, ms, (double)per * nb / ms / 1e9,
               (double)per / ms / 1e6,
               cudaGetErrorString(cudaGetLastError()));
      }
  return 0;
}
"""


def main() -> int:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "hopper_probe.cu"
    exe = _build.BUILD_DIR / "hopper_probe"
    cu.write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", "-o", str(exe), str(cu)], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
