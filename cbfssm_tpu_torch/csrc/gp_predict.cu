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
// Accumulation is in the storage type with IEEE FMA (no tensor cores, so
// no TF32). Both clamps of the TPU kernel are kept.
//
// Lanes. The *_lanes entry points run L independent predicts in one
// launch, the counterpart of the batched pallas_call that jax.vmap makes
// of the two TPU kernels (multi-seed and sweep training): every operand
// and output carries a leading lane axis (x [L, N, DI], zs [L, M, DI],
// inv_ls [L, DI], kvar [L], kinv [L, M, M], alpha and var_q [L, M, D];
// mean and var [L, N, D], kmn and w [L, N, M]), the grid is (blocks a
// lane, L) and blockIdx.y picks the lane, whose block offsets every
// pointer by it. The row tile is chosen from the L * N rows of the whole
// launch; the M cap (gp_predict_max_m) holds per lane. The plain entry
// points are the L = 1 case.
//
// Design. One block of 256 threads per tile of TN rows; rows are
// independent, so nothing is reduced across blocks, and the ragged last
// tile is bounded by its own row count. Nothing is padded in device
// memory; inside shared memory M is padded to Mp, a multiple of the
// 4-wide micro-tile, with zero kinv rows and columns and zero kmn
// entries, and no padded column is ever written out.
//  - Staging: zs, kinv, alpha, var_q and the tile's rows of x are read in
//    one pass of 16-byte loads (float4 / double2), up to 12 a thread in
//    flight before any is stored (inv_ls, DI values, is loaded before
//    the pass and stored after it). kinv keeps its layout (16-byte
//    stores) when M is a multiple of 4; zs, alpha, var_q and x are stored
//    transposed, so that the loops below read them on neighbouring words.
//  - Phase 1: each thread computes a 4 x 4 micro-tile of kmn from two
//    16-byte loads per input dimension (4 rows of xs, 4 columns of zs)
//    and stores it row-major with 16-byte stores.
//  - Phase 2, w = kmn @ kinv, register-tiled: each thread owns a 4 x 4
//    micro-tile of w in registers. Per 4 steps of k it makes 8 16-byte
//    loads (4 rows of kmn, 4 rows of kinv) and 64 FMAs: two shared loads
//    per 16 FMAs, where one output a thread takes two per FMA.
//    Neighbouring threads take neighbouring column groups, so the kinv
//    loads are contiguous and the kmn loads broadcast; the micro-tile is
//    stored row-major with 16-byte stores on neighbouring addresses.
//  - Phase 3: one warp per row. Each lane sums, in one pass over its
//    columns, qf, the D mean columns and the D variance columns (and,
//    with residuals, writes the row's kmn and w, neighbouring lanes on
//    neighbouring addresses). One shuffle tree then reduces the 1 + 2*D
//    values together as a reduce-scatter: 10 shuffles at D = 2 and 17 at
//    D = 4 with the broadcast of qf (25 and 45 as one tree per value).
//    D above 4 is taken 4 columns at a time.
//  - The row stride of kmn and w in shared memory is an odd number of
//    16-byte chunks, so that 16-byte stores of neighbouring rows fall on
//    distinct banks.
//
// Tiles. TN is a multiple of 4 chosen from the rows of the launch (N, or
// L * N with lanes): the smallest for which the grid has at most
// kBlocksPerSm = 2 blocks per SM, so that the main-path
// shapes fill the card's 132 SMs in one wave; a tile that does not fit
// the opt-in shared-memory limit shrinks by 4 rows until it does. All of
// kinv is staged, so M is capped: gp_predict_max_m gives the largest M
// that fits at the smallest tile, and the wrappers refuse a larger one.
// D = 0 (no output column) is allowed; N must be positive (the
// wrappers return empty outputs at N = 0 without calling in).
// __launch_bounds__(256, 2) holds a thread to 128 registers, so that two
// blocks fit an SM. At M = 100, DI = 6 (dynamic shared memory per block;
// the last two rows are the serving path at batch 1, whose grids are
// smaller than the card):
//
//   shape                   TN  blocks  f32 bytes  f64 bytes  blocks/SM (f32, f64)
//   N = 12,800, D = 2       52     247     87,488    176,624  2, 1
//   N =  1,600, D = 4        8     200     52,656    105,552  2, 2
//   N =    400, D = 2        4     100     47,744     95,600  1 (grid < SMs)
//   N =     50, D = 4        4      13     49,344     98,800  1 (grid < SMs)
//
// Every block re-stages kinv, 40 KB in f32 from L2: 9.9 MB per launch at
// N = 12,800, 8.0 MB at N = 1,600. Measured on an H100 (f32, CUDA-graph
// replay): a tile of 52 rows beat 4, 16, 32, 36 and 64 at N = 12,800; at
// N = 1,600, 8 rows beat 4 and 32 and were within 7 % of 16; at N = 400
// and N = 50, 4 rows beat 8 and 16 (a block takes about as long at 4
// rows as at 16, so more, smaller blocks finish sooner).
//
// What bounds it. Per row ~2*M*M + 2*M*(DI + 2*D) + ~9*M operations:
// ~0.28 GFLOP at N = 12,800 (4.4 us at the f32 CUDA-core peak), against
// ~3.2 us of device-memory traffic with residuals (kmn and w, 10.2 MB).
// On an H100 it takes 5x the operation bound at N = 12,800 and ~18x at
// N = 1,600, so neither bound holds it: it is bound by latency, with two
// blocks of 8 warps an SM (128 registers a thread). Per-phase clock64()
// readings of an instrumented build put phase 2 first at N = 12,800, at
// about 40 % of the FMA rate, then phase 3 and staging; at N = 1,600
// staging, the re-read of kinv from L2 by every block, comes first, then
// phase 2.
//
// Later work, not done here: cp.async/TMA staging, persistent blocks
// that stage kinv once per SM, 3xTF32 mma/wgmma or f64 DMMA for phase 2,
// alpha folded into phase 2, CUDA graphs over the steps of a request,
// a fused backward kernel.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;     // micro-tile rows and columns
constexpr int kMaxD = 4;  // output columns reduced in one pass
constexpr int kMaxTileRows = 64;
constexpr int kBlocksPerSm = 2;

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

__host__ __device__ __forceinline__ int round_up(int a, int b) { return (a + b - 1) / b * b; }

// A row stride (in elements, a multiple of the 16-byte vector) that is an
// odd number of 16-byte chunks.
template <typename T>
__host__ __device__ __forceinline__ int skew(int cols) {
    constexpr int kV = 16 / sizeof(T);
    const int ld = round_up(cols, kV);
    return (ld / kV) % 2 == 0 ? ld + kV : ld;
}

// Offsets (in elements) of the shared-memory regions; each starts on a
// 16-byte boundary. Computed alike on the host (size) and the device.
struct Layout {
    int mp, ldm;
    int zs, zn, ils, alpha, varq, kinv, xs, xn, kmn, w, total;
};

template <typename T>
__host__ __device__ __forceinline__ Layout layout(int m, int di, int d, int tn) {
    constexpr int kV = 16 / sizeof(T);
    Layout l;
    l.mp = round_up(m, kR);
    l.ldm = skew<T>(l.mp);
    l.zs = 0;
    l.zn = l.zs + di * l.mp;
    l.ils = l.zn + l.mp;
    l.alpha = l.ils + round_up(di, kV);
    l.varq = l.alpha + round_up(d * m, kV);
    l.kinv = l.varq + round_up(d * m, kV);
    l.xs = l.kinv + l.mp * l.mp;
    l.xn = l.xs + di * tn;
    l.kmn = l.xn + tn;
    l.w = l.kmn + tn * l.ldm;
    l.total = l.w + tn * l.ldm;
    return l;
}

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

template <typename Put> __device__ __forceinline__ void put_vec(const Put& put, int e, float4 v) {
    put(e, v.x); put(e + 1, v.y); put(e + 2, v.z); put(e + 3, v.w);
}
template <typename Put> __device__ __forceinline__ void put_vec(const Put& put, int e, double2 v) {
    put(e, v.x); put(e + 1, v.y);
}

// One source of the staging pass: `count` elements at `src`, stored
// through put(element, value), or as 16-byte vectors at `flat` where the
// shared layout is the source's own; `vecs` of them are loaded as 16-byte
// vectors (none when src is not 16-byte aligned).
template <typename T, typename Put>
struct Source {
    const T* src;
    T* flat;
    int count, vecs;
    Put put;
};

template <typename T> struct Identity { using type = T; };

template <typename T, typename Put>
__device__ __forceinline__ Source<T, Put> source(const T* src, int count,
                                                 typename Identity<T>::type* flat, Put put) {
    constexpr int kV = 16 / sizeof(T);
    return {src, flat, count, reinterpret_cast<uintptr_t>(src) % 16 == 0 ? count / kV : 0, put};
}

template <typename T, typename Put, typename V>
__device__ __forceinline__ void store_vec(const Source<T, Put>& s, int i, V v) {
    if (s.flat != nullptr) {
        reinterpret_cast<V*>(s.flat)[i] = v;
    } else {
        put_vec(s.put, i * (int)(16 / sizeof(T)), v);
    }
}

// The elements of a source that were not loaded as vectors.
template <typename T, typename Put>
__device__ __forceinline__ void stage_tail(const Source<T, Put>& s) {
    constexpr int kV = 16 / sizeof(T);
    for (int i = s.vecs * kV + threadIdx.x; i < s.count; i += kThreads) s.put(i, __ldg(s.src + i));
}

// Stage five sources into shared memory in one pass over the 16-byte
// vectors of all of them: each thread issues up to kBatch loads before
// it stores any, so that the pass waits on device memory about once,
// not once per source. The scalar tails follow.
template <typename T, typename P0, typename P1, typename P2, typename P3, typename P4>
__device__ __forceinline__ void stage(const Source<T, P0>& s0, const Source<T, P1>& s1,
                                      const Source<T, P2>& s2, const Source<T, P3>& s3,
                                      const Source<T, P4>& s4) {
    using V = typename Vec<T>::type;
    constexpr int kBatch = 12;
    const int e0 = s0.vecs, e1 = e0 + s1.vecs, e2 = e1 + s2.vecs, e3 = e2 + s3.vecs,
              e4 = e3 + s4.vecs;
    for (int i0 = threadIdx.x; i0 < e4; i0 += kBatch * kThreads) {
        V v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kThreads;
            if (i < e4) {
                const V* p = i < e0   ? reinterpret_cast<const V*>(s0.src) + i
                             : i < e1 ? reinterpret_cast<const V*>(s1.src) + (i - e0)
                             : i < e2 ? reinterpret_cast<const V*>(s2.src) + (i - e1)
                             : i < e3 ? reinterpret_cast<const V*>(s3.src) + (i - e2)
                                      : reinterpret_cast<const V*>(s4.src) + (i - e3);
                v[u] = __ldg(p);
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kThreads;
            if (i < e0) store_vec(s0, i, v[u]);
            else if (i < e1) store_vec(s1, i - e0, v[u]);
            else if (i < e2) store_vec(s2, i - e1, v[u]);
            else if (i < e3) store_vec(s3, i - e2, v[u]);
            else if (i < e4) store_vec(s4, i - e3, v[u]);
        }
    }
    stage_tail(s0);
    stage_tail(s1);
    stage_tail(s2);
    stage_tail(s3);
    stage_tail(s4);
}

// One level of the reduce-scatter of reduce_row, then the next: the lanes whose
// `off` bit is set keep values [kHalf, 2 kHalf) and send [0, kHalf); the
// others keep the lower half. The kept half ends in v[0 .. kHalf).
template <int kHalf, typename T, int kP>
__device__ __forceinline__ void scatter(T (&v)[kP], int lane, int off) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
        const T send = upper ? v[j] : v[j + kHalf];
        const T keep = upper ? v[j + kHalf] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    if constexpr (kHalf > 1) scatter<kHalf / 2>(v, lane, off / 2);
}

// Phase 3 for one row and kD output columns. One pass over the row
// gives each lane its partial sums of the 1 + 2*kD values (qf, the kD
// mean columns, the kD variance columns), padded to kP, a power of two.
// One shuffle tree then reduces them together: at each of its first
// log2(kP) levels every lane sends half of its values to its partner and
// keeps the other half (kP - 1 shuffles in all, not one tree of 5 per
// value), so that each lane ends with one value, whose index is its lane
// number's top log2(kP) bits; the last 5 - log2(kP) levels finish the sum.
// The lanes that hold a mean or variance column write it. `first` (the
// first group of columns) also sets `base` and, with residuals, writes
// the row of kmn and w.
template <int kD, bool kResiduals, typename T>
__device__ __forceinline__ void reduce_row(const T* krow, const T* wrow, const T* al,
                                           const T* vq, int m, bool first, T kvar, T& base,
                                           T* mean_row, T* var_row, T* kmn_row, T* w_row,
                                           int lane) {
    constexpr int kN = 1 + 2 * kD;
    constexpr int kP = kN <= 4 ? 4 : kN <= 8 ? 8 : 16;
    constexpr int kLanes = 32 / kP;  // lanes that end with the same value
    T v[kP] = {};  // qf, mean[kD], vq[kD], zero padding
    for (int k = lane; k < m; k += 32) {
        const T kk = krow[k], ww = wrow[k];
        if (kResiduals && first) {
            kmn_row[k] = kk;
            w_row[k] = ww;
        }
        v[0] = fma_t(kk, ww, v[0]);
        const T w2 = ww * ww;
#pragma unroll
        for (int c = 0; c < kD; ++c) {
            v[1 + c] = fma_t(kk, al[c * m + k], v[1 + c]);
            v[1 + kD + c] = fma_t(w2, vq[c * m + k], v[1 + kD + c]);
        }
    }
    scatter<kP / 2>(v, lane, 16);
#pragma unroll
    for (int off = kLanes / 2; off >= 1; off /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    const T qf = __shfl_sync(0xffffffffu, v[0], 0);  // index 0 is on lanes 0 .. kLanes - 1
    if (first) base = kvar - qf > T(0) ? kvar - qf : T(0);
    const int idx = lane / kLanes;
    if (lane % kLanes == 0) {
        if (idx >= 1 && idx <= kD) mean_row[idx - 1] = v[0];
        else if (idx > kD && idx <= 2 * kD) var_row[idx - kD - 1] = base + v[0];
    }
}

template <typename T, bool kResiduals>
__global__ void __launch_bounds__(kThreads, 2)
gp_predict_kernel(const T* __restrict__ x, const T* __restrict__ zs,
                  const T* __restrict__ inv_ls, const T* __restrict__ kvar_ptr,
                  const T* __restrict__ kinv, const T* __restrict__ alpha,
                  const T* __restrict__ var_q, T* __restrict__ mean_out,
                  T* __restrict__ var_out, T* __restrict__ kmn_out,
                  T* __restrict__ w_out, int n, int m, int di, int d, int tn) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const Layout L = layout<T>(m, di, d, tn);
    T* s_zs = smem + L.zs;        // [di, mp] (transposed)
    T* s_zn = smem + L.zn;        // [mp]
    T* s_ils = smem + L.ils;      // [di]
    T* s_alpha = smem + L.alpha;  // [d, m] (transposed)
    T* s_varq = smem + L.varq;    // [d, m] (transposed)
    T* s_kinv = smem + L.kinv;    // [mp, mp], zero beyond m
    T* s_xs = smem + L.xs;        // [di, tn] (transposed)
    T* s_xn = smem + L.xn;        // [tn]
    T* s_kmn = smem + L.kmn;      // [tn, ldm], zero beyond rows x m
    T* s_w = smem + L.w;          // [tn, ldm]
    const int mp = L.mp, ldm = L.ldm;

    // this block's lane: every operand and output is offset by it
    const size_t lane_id = blockIdx.y;
    x += lane_id * n * di;
    zs += lane_id * m * di;
    inv_ls += lane_id * di;
    kvar_ptr += lane_id;
    kinv += lane_id * m * m;
    alpha += lane_id * m * d;
    var_q += lane_id * m * d;
    mean_out += lane_id * n * d;
    var_out += lane_id * n * d;
    if (kResiduals) {
        kmn_out += lane_id * n * m;
        w_out += lane_id * n * m;
    }

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * tn;
    const int rows = min(tn, n - row0);
    const int warp = tid >> 5, lane = tid & 31;
    const T kvar = *kvar_ptr;
    const T ils = tid < di ? __ldg(inv_ls + tid) : T(0);  // in flight during staging

    // ---- stage the M-side operands and the tile's rows of x (one pass),
    // then scale x by inv_ls and take the squared norms ----
    stage(source(zs, m * di, nullptr, [&](int e, T v) { s_zs[(e % di) * mp + e / di] = v; }),
          source(kinv, m * m, mp == m ? s_kinv : nullptr,
                 [&](int e, T v) { s_kinv[(e / m) * mp + e % m] = v; }),
          source(alpha, m * d, nullptr, [&](int e, T v) { s_alpha[(e % d) * m + e / d] = v; }),
          source(var_q, m * d, nullptr, [&](int e, T v) { s_varq[(e % d) * m + e / d] = v; }),
          source(x + (size_t)row0 * di, rows * di, nullptr,
                 [&](int e, T v) { s_xs[(e % di) * tn + e / di] = v; }));
    if (tid < di) s_ils[tid] = ils;
    for (int i = tid + kThreads; i < di; i += kThreads) s_ils[i] = __ldg(inv_ls + i);
    for (int i = tid; i < (mp - m) * mp; i += kThreads) s_kinv[m * mp + i] = T(0);
    for (int i = tid; i < m * (mp - m); i += kThreads) {
        s_kinv[(i / (mp - m)) * mp + m + i % (mp - m)] = T(0);
    }
    __syncthreads();
    for (int j = tid; j < m; j += kThreads) {
        T acc = T(0);
        for (int k = 0; k < di; ++k) acc = fma_t(s_zs[k * mp + j], s_zs[k * mp + j], acc);
        s_zn[j] = acc;
    }
    for (int r = tid; r < rows; r += kThreads) {
        T acc = T(0);
        for (int k = 0; k < di; ++k) {
            const T v = s_xs[k * tn + r] * s_ils[k];
            s_xs[k * tn + r] = v;
            acc = fma_t(v, v, acc);
        }
        s_xn[r] = acc;
    }
    __syncthreads();

    // ---- phase 1: kmn = kvar * exp(-0.5 * max(d2, 0)), a 4 x 4
    // micro-tile a thread, neighbouring threads on neighbouring column
    // groups. Zero outside rows x m (the padding that phase 2 reads):
    // entries there read unset shared memory and are replaced by the
    // select ----
    const int nrg = (rows + kR - 1) / kR;  // row groups of 4
    const int ncg = mp / kR;               // column groups of 4
    for (int i = tid; i < nrg * ncg; i += kThreads) {
        const int rg = i / ncg, cg = i - rg * ncg;
        const int r0 = rg * kR, c0 = cg * kR;
        T cross[kR][kR] = {};
        for (int k = 0; k < di; ++k) {
            T a[kR], b[kR];
            load4(s_xs + k * tn + r0, a);
            load4(s_zs + k * mp + c0, b);
#pragma unroll
            for (int p = 0; p < kR; ++p) {
#pragma unroll
                for (int q = 0; q < kR; ++q) cross[p][q] = fma_t(a[p], b[q], cross[p][q]);
            }
        }
        T xn[kR], zn[kR];
        load4(s_xn + r0, xn);
        load4(s_zn + c0, zn);
#pragma unroll
        for (int p = 0; p < kR; ++p) {
            T out[kR];
#pragma unroll
            for (int q = 0; q < kR; ++q) {
                T d2 = xn[p] - T(2) * cross[p][q] + zn[q];
                d2 = d2 > T(0) ? d2 : T(0);
                const T kv = kvar * exp_t(T(-0.5) * d2);
                out[q] = r0 + p < rows && c0 + q < m ? kv : T(0);
            }
            store4(s_kmn + (r0 + p) * ldm + c0, out);
        }
    }
    __syncthreads();

    // ---- phase 2: w = kmn @ kinv, a 4 x 4 micro-tile a thread in
    // registers; per 4 steps of k, 8 16-byte loads (4 rows of kmn, 4 rows
    // of kinv) feed 64 FMAs. Neighbouring threads take neighbouring
    // column groups: their kinv loads are contiguous, their kmn loads
    // broadcast ----
    for (int i = tid; i < nrg * ncg; i += kThreads) {
        const int rg = i / ncg, cg = i - rg * ncg;
        const T* a_ptr = s_kmn + rg * kR * ldm;
        const T* b_ptr = s_kinv + cg * kR;
        T acc[kR][kR] = {};
        for (int k = 0; k < mp; k += kR) {
            T a[kR][kR], b[kR][kR];
#pragma unroll
            for (int p = 0; p < kR; ++p) load4(a_ptr + p * ldm + k, a[p]);
#pragma unroll
            for (int u = 0; u < kR; ++u) load4(b_ptr + (k + u) * mp, b[u]);
#pragma unroll
            for (int u = 0; u < kR; ++u) {
#pragma unroll
                for (int p = 0; p < kR; ++p) {
#pragma unroll
                    for (int q = 0; q < kR; ++q) acc[p][q] = fma_t(a[p][u], b[u][q], acc[p][q]);
                }
            }
        }
#pragma unroll
        for (int p = 0; p < kR; ++p) store4(s_w + (rg * kR + p) * ldm + cg * kR, acc[p]);
    }
    __syncthreads();

    // ---- phase 3: one warp per row (reduce_row), kMaxD output columns
    // at a time ----
    for (int r = warp; r < rows; r += kWarps) {
        const T* krow = s_kmn + r * ldm;
        const T* wrow = s_w + r * ldm;
        T* mean_row = mean_out + (size_t)(row0 + r) * d;
        T* var_row = var_out + (size_t)(row0 + r) * d;
        T* kmn_row = kResiduals ? kmn_out + (size_t)(row0 + r) * m : nullptr;
        T* w_row = kResiduals ? w_out + (size_t)(row0 + r) * m : nullptr;
        T base = T(0);
        for (int c0 = 0; c0 < d; c0 += kMaxD) {
            const T* al = s_alpha + c0 * m;
            const T* vq = s_varq + c0 * m;
            const bool first = c0 == 0;
            switch (min(kMaxD, d - c0)) {
                case 1:
                    reduce_row<1, kResiduals>(krow, wrow, al, vq, m, first, kvar, base,
                                              mean_row + c0, var_row + c0, kmn_row, w_row, lane);
                    break;
                case 2:
                    reduce_row<2, kResiduals>(krow, wrow, al, vq, m, first, kvar, base,
                                              mean_row + c0, var_row + c0, kmn_row, w_row, lane);
                    break;
                case 3:
                    reduce_row<3, kResiduals>(krow, wrow, al, vq, m, first, kvar, base,
                                              mean_row + c0, var_row + c0, kmn_row, w_row, lane);
                    break;
                default:
                    reduce_row<4, kResiduals>(krow, wrow, al, vq, m, first, kvar, base,
                                              mean_row + c0, var_row + c0, kmn_row, w_row, lane);
                    break;
            }
        }
        if (kResiduals && d == 0) {
            // no output column, so reduce_row did not run: write the
            // residual rows here
            for (int k = lane; k < m; k += 32) {
                kmn_row[k] = krow[k];
                w_row[k] = wrow[k];
            }
        }
    }
}

template <typename T>
size_t smem_bytes(int m, int di, int d, int tn) {
    return (size_t)layout<T>(m, di, d, tn).total * sizeof(T);
}

// Rows per block: the smallest multiple of 4 (at most kMaxTileRows) that
// gives at most kBlocksPerSm blocks per SM over `rows`, the rows of all
// lanes of the launch.
int tile_rows(long long rows, int sms) {
    const long long per_block = (rows + kBlocksPerSm * sms - 1) / (kBlocksPerSm * sms);
    const long long tile = (per_block + kR - 1) / kR * kR;
    return (int)std::min<long long>(kMaxTileRows, std::max<long long>(kR, tile));
}

// Per device, looked up once: the opt-in shared-memory limit of a block
// and the number of SMs (0 until looked up).
constexpr int kMaxDevices = 64;
std::atomic<int> g_smem_limit[kMaxDevices];
std::atomic<int> g_sm_count[kMaxDevices];
std::mutex g_attr_mutex;

cudaError_t device_limits(int dev, int* limit, int* sms) {
    *limit = g_smem_limit[dev].load(std::memory_order_relaxed);
    *sms = g_sm_count[dev].load(std::memory_order_relaxed);
    if (*limit > 0 && *sms > 0) return cudaSuccess;
    cudaError_t err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_smem_limit[dev].store(*limit, std::memory_order_relaxed);
    g_sm_count[dev].store(*sms, std::memory_order_relaxed);
    return cudaSuccess;
}

// Raise the kernel's dynamic shared-memory attribute on `dev` to `bytes`
// unless an earlier launch already set at least that much.
template <typename T, bool kResiduals>
cudaError_t reserve_smem(int dev, size_t bytes) {
    static std::atomic<size_t> reserved[kMaxDevices];
    if (bytes <= reserved[dev].load(std::memory_order_acquire)) return cudaSuccess;
    std::lock_guard<std::mutex> lock(g_attr_mutex);
    if (bytes <= reserved[dev].load(std::memory_order_relaxed)) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        gp_predict_kernel<T, kResiduals>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err == cudaSuccess) reserved[dev].store(bytes, std::memory_order_release);
    return err;
}

// The current device's index and limits.
cudaError_t current_limits(int* dev, int* limit, int* sms) {
    cudaError_t err = cudaGetDevice(dev);
    if (err != cudaSuccess) return err;
    if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
    return device_limits(*dev, limit, sms);
}

// The largest M whose block, at the smallest row tile, fits `limit`
// bytes of shared memory (the block grows with M).
template <typename T>
int max_m(int di, int d, int limit) {
    int m = 0;
    while (smem_bytes<T>(m + 1, di, d, kR) <= (size_t)limit) ++m;
    return m;
}

// `lanes` independent predicts (lane-major operands, see the top of the
// file); lanes = 1 is the plain call.
template <typename T, bool kResiduals>
int launch(const T* x, const T* zs, const T* inv_ls, const T* kvar,
           const T* kinv, const T* alpha, const T* var_q, T* mean, T* var,
           T* kmn, T* w, int lanes, int n, int m, int di, int d, void* stream) {
    if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidConfiguration;
    int dev = 0, limit = 0, sms = 0;
    cudaError_t err = current_limits(&dev, &limit, &sms);
    if (err != cudaSuccess) return (int)err;
    // shrink the row tile until the block fits; a kinv too large for
    // shared memory at any tile (M above max_m) is refused by
    // cudaFuncSetAttribute below
    int tn = tile_rows((long long)lanes * n, sms);
    while (tn > kR && smem_bytes<T>(m, di, d, tn) > (size_t)limit) tn -= kR;
    const size_t bytes = smem_bytes<T>(m, di, d, tn);
    err = reserve_smem<T, kResiduals>(dev, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + tn - 1) / tn, lanes);
    gp_predict_kernel<T, kResiduals><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
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
                                nullptr, 1, n, m, di, d, stream);
}

int gp_predict_f64(const double* x, const double* zs, const double* inv_ls,
                   const double* kvar, const double* kinv, const double* alpha,
                   const double* var_q, double* mean, double* var, int n, int m,
                   int di, int d, void* stream) {
    return launch<double, false>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, nullptr,
                                 nullptr, 1, n, m, di, d, stream);
}

// As gp_predict_*, and also writes kmn [N, M] and w [N, M] (row-major).
int gp_predict_residuals_f32(const float* x, const float* zs, const float* inv_ls,
                             const float* kvar, const float* kinv, const float* alpha,
                             const float* var_q, float* mean, float* var, float* kmn,
                             float* w, int n, int m, int di, int d, void* stream) {
    return launch<float, true>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, kmn, w, 1,
                               n, m, di, d, stream);
}

int gp_predict_residuals_f64(const double* x, const double* zs, const double* inv_ls,
                             const double* kvar, const double* kinv, const double* alpha,
                             const double* var_q, double* mean, double* var, double* kmn,
                             double* w, int n, int m, int di, int d, void* stream) {
    return launch<double, true>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, kmn, w,
                                1, n, m, di, d, stream);
}

// `lanes` independent predicts in one launch: as gp_predict_* and
// gp_predict_residuals_*, with a leading lane axis on every operand and
// output (see the top of the file).
int gp_predict_lanes_f32(const float* x, const float* zs, const float* inv_ls,
                         const float* kvar, const float* kinv, const float* alpha,
                         const float* var_q, float* mean, float* var, int lanes, int n,
                         int m, int di, int d, void* stream) {
    return launch<float, false>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, nullptr,
                                nullptr, lanes, n, m, di, d, stream);
}

int gp_predict_lanes_f64(const double* x, const double* zs, const double* inv_ls,
                         const double* kvar, const double* kinv, const double* alpha,
                         const double* var_q, double* mean, double* var, int lanes, int n,
                         int m, int di, int d, void* stream) {
    return launch<double, false>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, nullptr,
                                 nullptr, lanes, n, m, di, d, stream);
}

int gp_predict_residuals_lanes_f32(const float* x, const float* zs, const float* inv_ls,
                                   const float* kvar, const float* kinv, const float* alpha,
                                   const float* var_q, float* mean, float* var, float* kmn,
                                   float* w, int lanes, int n, int m, int di, int d,
                                   void* stream) {
    return launch<float, true>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, kmn, w,
                               lanes, n, m, di, d, stream);
}

int gp_predict_residuals_lanes_f64(const double* x, const double* zs, const double* inv_ls,
                                   const double* kvar, const double* kinv, const double* alpha,
                                   const double* var_q, double* mean, double* var, double* kmn,
                                   double* w, int lanes, int n, int m, int di, int d,
                                   void* stream) {
    return launch<double, true>(x, zs, inv_ls, kvar, kinv, alpha, var_q, mean, var, kmn, w,
                                lanes, n, m, di, d, stream);
}

const char* gp_predict_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The largest M (inducing points) the kernels take at (DI, D) on the
// current device, in float64 when `f64` is nonzero, else float32: all of
// kinv and the smallest row tile must fit the block's opt-in shared
// memory. A negative value is minus a CUDA error code.
int gp_predict_max_m(int f64, int di, int d) {
    int dev = 0, limit = 0, sms = 0;
    const cudaError_t err = current_limits(&dev, &limit, &sms);
    if (err != cudaSuccess) return -(int)err;
    return f64 ? max_m<double>(di, d, limit) : max_m<float>(di, d, limit);
}

}  // extern "C"
