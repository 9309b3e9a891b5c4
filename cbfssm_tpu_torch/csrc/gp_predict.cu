// Fused sparse-GP predictive for NVIDIA Hopper (sm_90a).
//
// Replaces cbfssm_tpu/ops/pallas/gp_predict.py::_kernel and
// ::_kernel_with_residuals (the two Pallas TPU kernels launched by
// _pallas_forward). For N query rows x [N, DI] against M inducing points
// it computes
//
//   xs   = x * inv_ls
//   d2   = max(|xs|^2 - 2 xs.zs^T + |zs|^2, 0)
//   kmn  = kvar * exp(-d2 / 2)                      [N, M]
//   w    = kmn @ kinv                               [N, M]
//   mean = kmn @ alpha                              [N, D]
//   var  = max(kvar - sum_m kmn*w, 0) + (w*w) @ var_q   [N, D]
//
// The gp_predict_* entry points write only mean and var. The
// gp_predict_residuals_* entry points (the forward of the training path,
// whose analytic backward needs kmn and w) also write kmn [N, M] and
// w [N, M]; one template, switched by kResiduals, serves both.
//
// Design. One block per tile of TN rows; rows are independent, so
// nothing is reduced across blocks and the ragged last tile is bounded by
// its own row count (no padding of N, M, DI or D). The M-side operands
// (zs, |zs|^2, inv_ls, kinv, alpha, var_q) are staged in dynamic shared
// memory; kmn and w of the tile live in shared memory too. Phase 1 fills
// kmn, phase 2 forms w = kmn @ kinv (one thread per (row, column), an
// FMA loop over M), phase 3 gives each warp whole rows and reduces
// qf, mean and the variance term with warp shuffles. Accumulation is in
// the storage type (IEEE f32 or f64 FMA; no tensor cores, so no TF32).
// Both clamps of the TPU kernel are kept (d2 >= 0, kvar - qf >= 0).
//
// What bounds it. Per row about 2*M*M + 2*M*(DI + 2*D) + ... ~ 21.6
// kFLOP at M = 100, DI = 6, D = 2; a recognition step of RoboMove serving
// at batch 32 (N = 12,800 rows) is ~0.28 GFLOP, microseconds of work on
// this card. The kernel is therefore bound by launch latency and by the
// shared-memory traffic of the phase-2 loop (two shared loads per FMA),
// not by device memory: x, mean and var are a few hundred KB. Staging
// kinv costs M*M elements per block (40 KB in f32 at M = 100), which is
// why it needs dynamic shared memory above the 48 KB static limit.
//
// With residuals the block also copies its tile's kmn and w rows out of
// shared memory after phase 2: 2*N*M elements of writes (10.2 MB in f32
// at N = 12,800, M = 100; ~3 us at 3.35 TB/s), issued as contiguous
// stores in which neighbouring threads take neighbouring columns. Its
// least time is still set by the operations (~4.4 us at the f32
// CUDA-core peak against ~3.2 us of device-memory traffic).
//
// Later work, not done here: register tiling or tensor cores (3xTF32 /
// wgmma) for the phase-2 product, TMA staging of kinv, and CUDA graphs
// over the 399 steps of one request, which remove the launch latency
// that dominates at these sizes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

template <typename T, bool kResiduals>
__global__ void __launch_bounds__(kThreads)
gp_predict_kernel(const T* __restrict__ x, const T* __restrict__ zs,
                  const T* __restrict__ inv_ls, const T* __restrict__ kvar_ptr,
                  const T* __restrict__ kinv, const T* __restrict__ alpha,
                  const T* __restrict__ var_q, T* __restrict__ mean_out,
                  T* __restrict__ var_out, T* __restrict__ kmn_out,
                  T* __restrict__ w_out, int n, int m, int di, int d, int tn) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_zs = reinterpret_cast<T*>(smem_raw);  // [m, di]
    T* s_zn = s_zs + m * di;                   // [m]
    T* s_ils = s_zn + m;                       // [di]
    T* s_kinv = s_ils + di;                    // [m, m]
    T* s_alpha = s_kinv + m * m;               // [m, d]
    T* s_varq = s_alpha + m * d;               // [m, d]
    T* s_xs = s_varq + m * d;                  // [tn, di]
    T* s_xn = s_xs + tn * di;                  // [tn]
    T* s_kmn = s_xn + tn;                      // [tn, m]
    T* s_w = s_kmn + tn * m;                   // [tn, m]

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * tn;
    const int rows = min(tn, n - row0);
    const T kvar = *kvar_ptr;

    // ---- stage the M-side operands and the tile's scaled rows ----
    for (int i = tid; i < di; i += kThreads) s_ils[i] = inv_ls[i];
    for (int i = tid; i < m * di; i += kThreads) s_zs[i] = zs[i];
    for (int i = tid; i < m * m; i += kThreads) s_kinv[i] = kinv[i];
    for (int i = tid; i < m * d; i += kThreads) {
        s_alpha[i] = alpha[i];
        s_varq[i] = var_q[i];
    }
    __syncthreads();
    for (int i = tid; i < rows * di; i += kThreads) {
        s_xs[i] = x[(size_t)row0 * di + i] * s_ils[i % di];
    }
    for (int j = tid; j < m; j += kThreads) {
        T acc = T(0);
        for (int k = 0; k < di; ++k) acc += s_zs[j * di + k] * s_zs[j * di + k];
        s_zn[j] = acc;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
        T acc = T(0);
        for (int k = 0; k < di; ++k) acc += s_xs[r * di + k] * s_xs[r * di + k];
        s_xn[r] = acc;
    }
    __syncthreads();

    // ---- phase 1: kmn = kvar * exp(-0.5 * max(d2, 0)) ----
    for (int i = tid; i < rows * m; i += kThreads) {
        const int r = i / m, j = i - r * m;
        T cross = T(0);
        for (int k = 0; k < di; ++k) cross += s_xs[r * di + k] * s_zs[j * di + k];
        T d2 = s_xn[r] - T(2) * cross + s_zn[j];
        d2 = d2 > T(0) ? d2 : T(0);
        s_kmn[i] = kvar * exp_t(T(-0.5) * d2);
    }
    __syncthreads();

    // ---- phase 2: w = kmn @ kinv ----
    for (int i = tid; i < rows * m; i += kThreads) {
        const int r = i / m, j = i - r * m;
        const T* krow = s_kmn + r * m;
        T acc = T(0);
        for (int k = 0; k < m; ++k) acc += krow[k] * s_kinv[k * m + j];
        s_w[i] = acc;
    }
    __syncthreads();

    // ---- residuals: the tile's rows of kmn and w are one contiguous
    // span of rows * m elements in each [N, M] output ----
    if constexpr (kResiduals) {
        const size_t base = (size_t)row0 * m;
        for (int i = tid; i < rows * m; i += kThreads) {
            kmn_out[base + i] = s_kmn[i];
            w_out[base + i] = s_w[i];
        }
    }

    // ---- phase 3: one warp per row: qf, mean, variance ----
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < rows; r += kWarps) {
        const T* krow = s_kmn + r * m;
        const T* wrow = s_w + r * m;
        T qf = T(0);
        for (int k = lane; k < m; k += 32) qf += krow[k] * wrow[k];
        qf = warp_sum(qf);
        T base = kvar - qf;
        base = base > T(0) ? base : T(0);
        const size_t out = (size_t)(row0 + r) * d;
        for (int c = 0; c < d; ++c) {
            T mu = T(0), vq = T(0);
            for (int k = lane; k < m; k += 32) {
                mu += krow[k] * s_alpha[k * d + c];
                vq += wrow[k] * wrow[k] * s_varq[k * d + c];
            }
            mu = warp_sum(mu);
            vq = warp_sum(vq);
            if (lane == 0) {
                mean_out[out + c] = mu;
                var_out[out + c] = base + vq;
            }
        }
    }
}

// Rows per block: smaller tiles when N is small, so that the launch
// still spreads over the card's 132 SMs.
int tile_rows(int n) {
    if (n >= 64 * 132) return 64;
    if (n >= 32 * 132) return 32;
    return 16;
}

template <typename T>
size_t smem_bytes(int m, int di, int d, int tn) {
    const size_t elems = (size_t)m * di + m + di + (size_t)m * m + 2 * (size_t)m * d +
                         (size_t)tn * di + tn + 2 * (size_t)tn * m;
    return elems * sizeof(T);
}

template <typename T, bool kResiduals>
int launch(const T* x, const T* zs, const T* inv_ls, const T* kvar,
           const T* kinv, const T* alpha, const T* var_q, T* mean, T* var,
           T* kmn, T* w, int n, int m, int di, int d, void* stream) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    // halve the row tile until the block fits; a kinv too large for
    // shared memory at any tile is refused by cudaFuncSetAttribute below
    int tn = tile_rows(n);
    while (tn > 8 && smem_bytes<T>(m, di, d, tn) > (size_t)limit) tn /= 2;
    const size_t bytes = smem_bytes<T>(m, di, d, tn);
    err = cudaFuncSetAttribute(
        gp_predict_kernel<T, kResiduals>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + tn - 1) / tn;
    gp_predict_kernel<T, kResiduals><<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, kmn, w, n, m, di, d, tn);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry points (bound with ctypes). Each returns the CUDA error
// code of the launch: 0 on success. The kernel runs on `stream` and the
// call does not synchronize.
int gp_predict_f32(const float* x, const float* zs, const float* inv_ls,
                   const float* kvar, const float* kinv, const float* alpha,
                   const float* var_q, float* mean, float* var, int n, int m,
                   int di, int d, void* stream) {
    return launch<float, false>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, nullptr,
                                nullptr, n, m, di, d, stream);
}

int gp_predict_f64(const double* x, const double* zs, const double* inv_ls,
                   const double* kvar, const double* kinv, const double* alpha,
                   const double* var_q, double* mean, double* var, int n, int m,
                   int di, int d, void* stream) {
    return launch<double, false>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, nullptr,
                                 nullptr, n, m, di, d, stream);
}

// As gp_predict_*, and also writes kmn [N, M] and w [N, M] (row-major).
int gp_predict_residuals_f32(const float* x, const float* zs, const float* inv_ls,
                             const float* kvar, const float* kinv, const float* alpha,
                             const float* var_q, float* mean, float* var, float* kmn,
                             float* w, int n, int m, int di, int d, void* stream) {
    return launch<float, true>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, kmn, w, n,
                               m, di, d, stream);
}

int gp_predict_residuals_f64(const double* x, const double* zs, const double* inv_ls,
                             const double* kvar, const double* kinv, const double* alpha,
                             const double* var_q, double* mean, double* var, double* kmn,
                             double* w, int n, int m, int di, int d, void* stream) {
    return launch<double, true>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, kmn, w,
                                n, m, di, d, stream);
}

const char* gp_predict_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
