"""Latency and throughput of the tensor-core instructions of the GP-predict
kernel's product, on the card.

    python3 scripts/torch_mma_microbench.py

Compiles a small CUDA program (the source is below) with ``ops/_build.py``'s
compiler and target into ``build/compare/mma_microbench`` and runs it. For
each instruction, ``mma.sync`` m16n8k8 TF32 (f32 sums), m8n8k4 f64, and
the CUDA-core FFMA / DFMA for scale, it prints:

- latency: cycles from one instruction to the next that depends on it,
  one warp, one chain (``clock64``);
- cycles per instruction per SM sub-partition (SMSP) with ``warps``
  warps an SM, each running ``chains`` independent chains (all 132 SMs
  busy, CUDA events): the issue rate the kernel can hope for at its 16
  warps an SM.

Prints the card's name and power limit first. Needs the card and ``nvcc``.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from cbfssm_tpu_torch.ops import _build  # noqa: E402

SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kIters = 4096;

template <int kOp> struct Chain;
// 0: mma m16n8k8 tf32, 1: mma m8n8k4 f64, 2: FFMA, 3: DFMA
template <> struct Chain<0> {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t a[4], b[2];
    __device__ void init(uint32_t s) {
        for (int i = 0; i < 4; ++i) a[i] = s + i;
        b[0] = s;
        b[1] = s + 1;
    }
    __device__ __forceinline__ void step() {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
    __device__ float out() const { return c[0] + c[1] + c[2] + c[3]; }
};
template <> struct Chain<1> {
    double c[2] = {0.0, 0.0};
    double a = 0.0, b = 1e-30;
    __device__ void init(uint32_t s) { a = 1e-30 * s; }
    __device__ __forceinline__ void step() {
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
                     "{%0,%1};\n" : "+d"(c[0]), "+d"(c[1]) : "d"(a), "d"(b));
    }
    __device__ float out() const { return (float)(c[0] + c[1]); }
};
template <> struct Chain<2> {
    float c = 0.f, a = 0.f, b = 1.0001f;
    __device__ void init(uint32_t s) { a = 1e-9f * s; }
    __device__ __forceinline__ void step() {
        asm volatile("fma.rn.f32 %0, %1, %2, %0;" : "+f"(c) : "f"(a), "f"(b));
    }
    __device__ float out() const { return c; }
};
template <> struct Chain<3> {
    double c = 0.0, a = 0.0, b = 1.0001;
    __device__ void init(uint32_t s) { a = 1e-9 * s; }
    __device__ __forceinline__ void step() {
        asm volatile("fma.rn.f64 %0, %1, %2, %0;" : "+d"(c) : "d"(a), "d"(b));
    }
    __device__ float out() const { return (float)c; }
};

template <int kOp, int kChains>
__global__ void run(float* sink, long long* cycles) {
    Chain<kOp> ch[kChains];
    for (int i = 0; i < kChains; ++i) ch[i].init(threadIdx.x + i);
    __syncwarp();
    const long long t0 = clock64();
    for (int it = 0; it < kIters; ++it) {
#pragma unroll
        for (int i = 0; i < kChains; ++i) ch[i].step();
    }
    const long long t1 = clock64();
    float s = 0.f;
    for (int i = 0; i < kChains; ++i) s += ch[i].out();
    sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
    if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

template <int kOp, int kChains>
void measure(const char* name, float* sink, long long* cycles, int sms) {
    long long host = 0;
    run<kOp, kChains><<<1, 32>>>(sink, cycles);
    cudaMemcpy(&host, cycles, sizeof(host), cudaMemcpyDeviceToHost);
    const double latency = (double)host / kIters / kChains;
    for (int warps : {4, 8, 16}) {
        cudaEvent_t a, b;
        cudaEventCreate(&a); cudaEventCreate(&b);
        run<kOp, kChains><<<sms, 32 * warps>>>(sink, cycles);
        cudaEventRecord(a);
        run<kOp, kChains><<<sms, 32 * warps>>>(sink, cycles);
        cudaEventRecord(b);
        cudaEventSynchronize(b);
        float ms = 0.f;
        cudaEventElapsedTime(&ms, a, b);
        int khz = 0;
        cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
        const double per_smsp = (double)warps * kIters * kChains / 4;  // instructions an SMSP
        const double cyc = ms * 1e-3 * khz * 1e3 / per_smsp;
        printf("%s chains %d: latency %.1f cycles (one warp, %d chain(s)); %d warps an SM: "
               "%.2f cycles per instruction per SMSP (%.3f ms)\n",
               name, kChains, kChains == 1 ? latency : (double)host / kIters, kChains, warps, cyc,
               ms);
        cudaEventDestroy(a); cudaEventDestroy(b);
    }
}

int main() {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    float* sink; long long* cycles;
    cudaMalloc(&sink, sizeof(float) * sms * 512);
    cudaMalloc(&cycles, sizeof(long long));
    measure<0, 1>("mma.m16n8k8.tf32", sink, cycles, sms);
    measure<0, 4>("mma.m16n8k8.tf32", sink, cycles, sms);
    measure<1, 1>("mma.m8n8k4.f64", sink, cycles, sms);
    measure<1, 4>("mma.m8n8k4.f64", sink, cycles, sms);
    measure<2, 1>("fma.f32", sink, cycles, sms);
    measure<2, 8>("fma.f32", sink, cycles, sms);
    measure<3, 1>("fma.f64", sink, cycles, sms);
    measure<3, 8>("fma.f64", sink, cycles, sms);
    const cudaError_t err = cudaDeviceSynchronize();
    printf("%s\n", cudaGetErrorString(err));
    return err == cudaSuccess ? 0 : 1;
}
"""


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = ROOT / "build" / "compare"
    out.mkdir(parents=True, exist_ok=True)
    src, exe = out / "mma_microbench.cu", out / "mma_microbench"
    src.write_text(SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc_path(), *flags, "-o", str(exe), str(src)], check=True)
    sys.exit(subprocess.run([str(exe)]).returncode)


if __name__ == "__main__":
    main()
