// Fused sparse-GP predictive for NVIDIA Hopper (sm_90a).
//
// Replaces cbfssm_tpu/ops/pallas/gp_predict.py::_kernel and
// ::_kernel_with_residuals (the two Pallas TPU kernels launched by
// _pallas_forward, and the batched pallas_call that jax.vmap makes of
// each). For N query rows x [N, DI] against M inducing points it computes
//
//   xs   = x * inv_ls
//   d2   = max(|xs|^2 - 2 xs.zs^T + |zs|^2, 0)
//   kmn  = kvar * exp(-d2 / 2)                      [N, M]
//   [w | mean] = kmn @ [kinv | alpha]               [N, M + D]
//   var  = max(kvar - sum_m kmn*w, 0) + (w*w) @ var_q   [N, D]
//
// The gp_predict_* entry points write only mean and var. The
// gp_predict_residuals_* entry points (the forward of the training path,
// whose analytic backward needs kmn and w) also write kmn [N, M] and
// w [N, M]; one template, switched by kResiduals, serves both. Both
// clamps of the TPU kernel are kept.
//
// Precision. The TPU kernel runs its products at Precision.HIGHEST, a
// multi-pass emulation of f32 on its matrix unit. Here the product
// [w | mean] runs on the tensor cores: in float64 as DMMA (mma.sync
// m8n8k4 .f64), in float32 as 3xTF32 (mma.sync m16n8k8 .tf32). Each f32
// operand is split into a TF32 high part (rounded to nearest) and a low
// part (the remainder: rounded to nearest for kmn, read by the tensor
// core's TF32 truncation for [kinv | alpha]), and lo*hi + hi*lo + hi*hi
// is summed; lo*lo, below f32's rounding, is dropped. Plain TF32 is not
// used. The tensor core's own sum covers one k-step (8 products in f32,
// 4 in f64): each k-step's result is added to the running sum with one
// IEEE add in registers, so that the long sum rounds as a CUDA-core sum
// does. Everything else (norms, the cross-Gram, exp, the partial sums
// of qf and the variances) is IEEE arithmetic in the storage type.
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
// Design. One block of 256 threads (8 warps) per tile of TN rows; rows
// are independent, so nothing is reduced across blocks, and the ragged
// last tile is bounded by its own row count.
//  - Staging, asynchronous (cp.async: 16-byte copies where both sides
//    allow it, else one element a copy), in two groups. Group 1 is what
//    phase 1 needs: the tile's rows of x, zs (both transposed) and
//    inv_ls. Group 2 is the rest: kinv with alpha beside it, the B
//    operand [kinv | alpha] (row k holds kinv[k, :] then alpha[k, :]),
//    and var_q (transposed). The block waits for group 1 only, scales x,
//    takes the norms and runs phase 1 while group 2 is in flight, and
//    waits for group 2 just before phase 2.
//  - Phase 1: one thread per (row, 4 columns) of kmn, a thread keeping
//    its columns over the rows: DI steps of one xs load (a broadcast) and
//    one 16-byte zs load, then the clamp and exp, one 16-byte store to
//    shared memory and, with residuals, the row of kmn out. Columns M ..
//    Kp (Kp = M rounded up to the mma depth) are stored as zeros: the
//    padding phase 2 reads.
//  - Phase 2, on the tensor cores: [w | mean] = kmn @ [kinv | alpha].
//    A work item is one mma row tile (16 rows in f32, 8 in f64) by two
//    neighbouring 8-column tiles (one at the right edge), the warps
//    taking the items in turn: at TN 4-8 (one row tile, 7 column pairs
//    at M + D = 102-104) seven of the eight warps hold mma tiles. A
//    fragments are read from kmn in shared memory (in f32 each lane's
//    two k indices of a step are neighbouring columns, one 8-byte load a
//    row), B fragments from [kinv | alpha], each split on the fly. kinv
//    rows past M read as zero in registers; rows past the tile read the
//    tile's last row and columns past M + D whatever lies there, and
//    neither is stored.
//  - The item's epilogue (phase 3 fused into it): each lane writes its
//    sums out as w (with residuals) or mean, and for the item's 16
//    columns of w the partial qf (sum of kmn * w) and variance sums (of
//    w^2 * var_q) of its rows, reduced over the row's 4 lanes by a
//    two-level shuffle reduce-scatter, 4 values at a time, into shared
//    memory. After a barrier, one thread per (row, variance column)
//    adds the partial sums of the ceil(M / 16) column groups in order
//    and writes var = max(kvar - qf, 0) + the variance sum.
//  - Every sum a row's result depends on runs in the same order whatever
//    N, L and TN are and whichever block, warp or lane holds the row: the
//    k-steps of phase 2 in order (an mma output depends only on its own
//    row of A and column of B), the partial sums by column group. So a
//    lane of a lane launch equals the single entry, and a row block
//    equals the same rows in a larger launch, bit for bit.
//
// Shared memory (one block, elements of the storage type): [kinv | alpha]
// M x ldb; kmn TN x ldk; var_q D x M; then phase 1's operands (zs DI x
// Kp, |zs|^2, inv_ls, xs DI x TN, |xs|^2), whose space the partial sums
// (TN x ceil(M / 16) x (1 + D)) take over once phase 1 is done. Nothing
// is padded in device memory. The leading dimensions make the fragment
// loads hit 32 distinct banks: ldb = 4 (mod 8); ldk = 8 (mod 16) in f32,
// 4 (mod 8) in f64. At M = 100, DI = 6 (the last two rows are the
// serving path at batch 1, whose grids are smaller than the card):
//
//   shape                   TN  blocks  f32 bytes  f64 bytes  blocks/SM (f32, f64)
//   N = 12,800, D = 2       52     247     70,032    138,336  2, 1
//   N =  1,600, D = 4        8     200     51,296    102,096  2, 2
//   N =    400, D = 2        4     100     48,720     97,072  1 (grid < SMs)
//   N =     50, D = 4        4      13     49,520     98,672  1 (grid < SMs)
//
// Registers (nvcc -Xptxas -v, sm_90a): float value 109, float residuals
// 102, double value 107, double residuals 115; no spill and no stack
// frame in any instantiation (the earlier FMA design held 128 and
// spilled in three of the four).
//
// Tiles. TN is a multiple of 4 chosen from the rows of the launch (N, or
// L * N with lanes): the smallest for which the grid has at most
// kBlocksPerSm = 2 blocks per SM, so that the main-path shapes fill the
// card's 132 SMs in one wave; a tile that does not fit the opt-in
// shared-memory limit shrinks by 4 rows until it does. All of kinv is
// staged, so M is capped: gp_predict_max_m gives the largest M that fits
// at the smallest tile, and the wrappers refuse a larger one. D = 0 (no
// output column) is allowed; N must be positive (the wrappers return
// empty outputs at N = 0 without calling in). __launch_bounds__(256, 2)
// holds a thread to 128 registers, so that two blocks fit an SM.
//
// What bounds it. Per row 2*M*(M + D) operations in the product and
// ~2*M*(DI + D) + ~9*M elsewhere: at N = 12,800 0.26 GFLOP at 3xTF32's
// rate (a third of TF32's 495 TFLOP/s) and 0.03 GFLOP at the f32
// CUDA-core peak, 2.1 us together (chip_smoke.bound), against ~3.2 us
// of device-memory traffic with residuals (kmn and w, 10.2 MB).
// Neither holds it on an H100: it is bound by the tensor cores' rate
// for mma.sync and by latency. mma.sync m16n8k8 TF32 sustains about one
// instruction per 7 cycles per SM sub-partition there (a 4-chain, 16-
// warp microbenchmark), so 3xTF32 is at most ~1.7x the f32 FMA rate,
// less the padding of the last 16-row tile (52 rows take 64). Measured
// at N = 12,800 (float32, CUDA-graph replay, H100 80GB HBM3 at 700 W,
// leaving out one part at a time): phase 2's k-loop ~9.9 us of 20.6, of
// which 3xTF32's two extra products ~3.9 us; the epilogue ~3.0 us;
// phase 1 ~2.7 us; phase 3 ~0.4 us; the asynchronous staging hides
// ~1.3 us of the copies. In float64 phase 1 leads (~9 us of 43: exp).
//
// Later work, not done here: persistent blocks that stage kinv once per
// SM and walk their tiles (every block re-stages kinv from L2, 40 KB in
// f32: 9.9 MB a launch at N = 12,800, 8.0 MB at N = 1,600), or a cluster
// with TMA multicast of kinv; wgmma (full-rate tensor cores; the split
// operands would then have to sit in shared memory); CUDA graphs over
// the steps of a request; a fused backward kernel.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;     // row-tile granularity; phase 1's columns per thread
constexpr int kMaxTileRows = 64;
constexpr int kBlocksPerSm = 2;
constexpr int kTileN = 8;  // columns of an mma tile (both types)

// The mma shape of phase 2: rows and depth of one tile.
template <typename T> struct Mma;
template <> struct Mma<float> { static constexpr int kM = 16, kK = 8; };  // m16n8k8 .tf32
template <> struct Mma<double> { static constexpr int kM = 8, kK = 4; };  // m8n8k4 .f64

__host__ __device__ __forceinline__ int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The smallest value >= v that is r modulo `mod`.
__host__ __device__ __forceinline__ int at_residue(int v, int mod, int r) {
    return v + ((r - v % mod) % mod + mod) % mod;
}

// Offsets (in elements) of the shared-memory regions; each starts on a
// 16-byte boundary. Computed alike on the host (size) and the device.
struct Layout {
    int kp, np, ldb, ldk;
    int kb, kmn, varq, zs, zn, ils, xs, xn, part, total;
};

template <typename T>
__host__ __device__ __forceinline__ Layout layout(int m, int di, int d, int tn) {
    constexpr int kV = 16 / sizeof(T);
    Layout l;
    l.kp = round_up(m, Mma<T>::kK);
    l.np = (m + 2 * kTileN - 1) / (2 * kTileN);
    l.ldb = at_residue(m + d, 8, 4);
    l.ldk = sizeof(T) == 4 ? at_residue(l.kp, 16, 8) : at_residue(l.kp, 8, 4);
    // B rows past M are not stored (they read as zero); B columns past
    // M + D are read and never used, up to 15 elements past the region
    // (into kmn's)
    l.kb = 0;
    l.kmn = l.kb + round_up(m * l.ldb, kV);
    l.varq = l.kmn + round_up(tn * l.ldk, kV);
    l.zs = l.varq + round_up(d * m, kV);
    l.zn = l.zs + round_up(di * l.kp, kV);
    l.ils = l.zn + l.kp;
    l.xs = l.ils + round_up(di, kV);
    l.xn = l.xs + round_up(di * tn, kV);
    l.part = l.zs;  // phase 2's partial sums take over phase 1's operands
    const int p1_end = l.xn + round_up(tn, kV);
    const int part_end = l.part + round_up(tn * l.np * (1 + d), kV);
    l.total = p1_end > part_end ? p1_end : part_end;
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

// ---- asynchronous copies (cp.async) ----

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (kBytes == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(kBytes)
                     : "memory");
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Calls f(i, q, r) for the i = threadIdx.x, threadIdx.x + kThreads, ...
// below count, with q = i / cols and r = i % cols kept by additions (one
// division a thread, not one a call).
template <typename F>
__device__ __forceinline__ void for_each_2d(int count, int cols, F f) {
    int i = threadIdx.x, q = i / cols, r = i - q * cols;
    const int dq = kThreads / cols, dr = kThreads - dq * cols;
    for (; i < count; i += kThreads) {
        f(i, q, r);
        q += dq;
        r += dr;
        if (r >= cols) {
            r -= cols;
            ++q;
        }
    }
}

// `rows` rows of `cols` contiguous elements of src (row stride cols) to
// shared rows dst + r * ld: 16-byte copies where src and dst are 16-byte
// aligned and cols and ld multiples of the vector, else one element a
// copy. With `transposed`, element (r, c) goes to dst[c * ld + r] instead
// (one element a copy).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, int rows, int cols,
                                          bool transposed = false) {
    constexpr int kV = 16 / sizeof(T);
    if (rows * cols == 0) return;
    if (!transposed && cols % kV == 0 && ld % kV == 0 &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
        const int vecs = cols / kV;
        for_each_2d(rows * vecs, vecs, [&](int, int r, int c) {
            cp_async<16>(dst + r * ld + c * kV, src + r * cols + c * kV);
        });
    } else {
        for_each_2d(rows * cols, cols, [&](int i, int r, int c) {
            cp_async<sizeof(T)>(dst + (transposed ? c * ld + r : r * ld + c), src + i);
        });
    }
}

// ---- tensor-core products ----

// A TF32 value of v (to nearest, ties away from zero): add half a TF32
// unit to the bits, then clear the 13 low bits.
__device__ __forceinline__ uint32_t tf32_near(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// The split of an A operand (kmn): v ~ hi + lo, both TF32 to nearest;
// |v - hi - lo| <= 2^-23 |v|.
__device__ __forceinline__ void split_a(float v, uint32_t& hi, uint32_t& lo) {
    hi = tf32_near(v);
    lo = tf32_near(v - __uint_as_float(hi));
}

// The split of a B operand ([kinv | alpha]): hi as for A, lo = v - hi
// exactly in f32, of which the tensor core takes the top 19 bits (TF32);
// |v - hi - lo| < 2^-21 |v|.
__device__ __forceinline__ void split_b(float v, uint32_t& hi, uint32_t& lo) {
    hi = tf32_near(v);
    lo = __float_as_uint(v - __uint_as_float(hi));
}

// c += a @ b on one m16n8k8 tile (TF32 operands, f32 sum).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a @ b on one m8n8k4 tile (f64).
__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
        : "+d"(c[0]), "+d"(c[1])
        : "d"(a), "d"(b));
}

// The product's operands and outputs, for one block.
template <typename T>
struct Product {
    const T* kmn;   // A [rows, kp] (ld ldk), zero in columns m .. kp
    const T* kb;    // B [m, m + d] (ld ldb): kinv | alpha
    const T* varq;  // [d, m]
    T* part;        // [rows, np, 1 + d]: per 16 columns of w, a row's qf and variance sums
    T* mean;        // [rows, d] in device memory, from the block's first row
    T* w;           // [rows, m] in device memory (with residuals), from the block's first row
    int rows, m, d, kp, ldk, ldb, np;
};

// Reduce kP values over the 4 lanes of a quad (lanes 4g .. 4g + 3) as a
// two-level reduce-scatter: lane t ends with the sums of values
// [(t / 2) kP / 2 + (t % 2) kP / 4, + kP / 4) in v[0 .. kP / 4), with
// 3 kP / 4 shuffles in all.
template <int kP, typename T>
__device__ __forceinline__ void quad_scatter(T (&v)[kP], int t) {
    constexpr int kH = kP / 2, kQ = kP / 4;
    const bool up2 = (t & 2) != 0, up1 = (t & 1) != 0;
#pragma unroll
    for (int i = 0; i < kH; ++i) {
        const T send = up2 ? v[i] : v[i + kH];
        v[i] = (up2 ? v[i + kH] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 2);
    }
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
        const T send = up1 ? v[i] : v[i + kQ];
        v[i] = (up1 ? v[i + kQ] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 1);
    }
}

// The epilogue of one work item: kRows rows a lane (g, and g + 8 with
// two), two 8-column tiles, and in each the columns 2t, 2t + 1 (acc[j]
// holds them row by row). Writes the sums out as w (with residuals) or
// mean, and, for the item's 16 columns of w, each row's partial qf (sum
// of kmn * w) and variance sums (of w^2 * var_q) to p.part, taken 4
// values at a time over the 4 lanes of the row. Every lane of the warp
// calls it; rows past the tile write nothing.
template <bool kResiduals, int kRows, typename T>
__device__ __forceinline__ void item_epilogue(const Product<T>& p, int r0, int n0, int lane,
                                              const T (&acc)[2][2 * kRows]) {
    const int g = lane >> 2, t = lane & 3;
    // the lane's 4 columns e = (tile j, column q) = (e / 2, e % 2)
    int cols[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) cols[e] = n0 + (e >> 1) * kTileN + 2 * t + (e & 1);
    if (p.d > 0 && n0 < p.m) {  // the same for the whole warp
        // w and kmn at the lane's columns, zero past m
        T wv[kRows][4], kv[kRows][4];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const T* krow = p.kmn + min(r0 + g + 8 * i, p.rows - 1) * p.ldk;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool in = cols[e] < p.m;
                wv[i][e] = in ? acc[e >> 1][2 * i + (e & 1)] : T(0);
                kv[i][e] = in ? krow[cols[e]] : T(0);
            }
        }
        constexpr int kP = 4 * kRows;
        for (int c0 = 0; c0 <= p.d; c0 += 4) {  // values c0 .. c0 + 4 of qf, var[0], var[1], ...
            T v[kP];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int value = c0 + u;
                T vq[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    vq[e] = value >= 1 && value <= p.d && cols[e] < p.m
                                ? p.varq[(value - 1) * p.m + cols[e]] : T(0);
                }
#pragma unroll
                for (int i = 0; i < kRows; ++i) {
                    T s = value == 0 ? kv[i][0] * wv[i][0] : wv[i][0] * wv[i][0] * vq[0];
#pragma unroll
                    for (int e = 1; e < 4; ++e) {
                        s = value == 0 ? fma_t(kv[i][e], wv[i][e], s)
                                       : fma_t(wv[i][e] * wv[i][e], vq[e], s);
                    }
                    v[4 * i + u] = s;
                }
            }
            quad_scatter(v, t);
#pragma unroll
            for (int e = 0; e < kRows; ++e) {
                const int idx = (t >> 1) * (kP / 2) + (t & 1) * (kP / 4) + e;
                const int r = r0 + g + 8 * (idx / 4), value = c0 + idx % 4;
                if (r < p.rows && value <= p.d) {
                    p.part[(r * p.np + n0 / (2 * kTileN)) * (1 + p.d) + value] = v[e];
                }
            }
        }
    }
    // the sums out: w (with residuals) or mean
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int r = r0 + g + 8 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const T v = acc[e >> 1][2 * i + (e & 1)];
            if (r < p.rows && cols[e] < p.m) {
                if (kResiduals) p.w[r * p.m + cols[e]] = v;
            } else if (r < p.rows && cols[e] < p.m + p.d) {
                p.mean[r * p.d + cols[e] - p.m] = v;
            }
        }
    }
}

// One work item in float32: rows r0 .. r0 + 16 by columns n0 .. n0 +
// 8 kNT (kNT 8-column tiles: two, or one at the right edge), 3xTF32.
// Lane (g, t) = (lane / 4, lane % 4) holds A at rows g, g + 8 and B at
// column g of each tile; its two k indices of a step, mma's t and t + 4,
// are taken at k0 + 2t and k0 + 2t + 1 of both A and B (the same 8
// products, so that A loads 2 neighbouring words); it ends with the sums
// at rows g, g + 8 and columns 2t, 2t + 1 of each tile. Rows past the
// tile read the tile's last row and are not written.
template <bool kResiduals, int kNT>
__device__ __forceinline__ void product_item(const Product<float>& p, int r0, int n0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const int e0 = min(r0 + g, p.rows - 1) * p.ldk + 2 * t;
    const int e1 = min(r0 + g + 8, p.rows - 1) * p.ldk + 2 * t;
    const float* b = p.kb + 2 * t * p.ldb + n0 + g;
    float acc[2][4] = {};
    // one k-step into s; in the last one (`edge`), B rows past m read as
    // zero
    auto step = [&](int k0, bool edge, float (&s)[2][4]) {
        const float2 x0 = *reinterpret_cast<const float2*>(p.kmn + e0 + k0);
        const float2 x1 = *reinterpret_cast<const float2*>(p.kmn + e1 + k0);
        uint32_t ahi[4], alo[4];
        split_a(x0.x, ahi[0], alo[0]);
        split_a(x1.x, ahi[1], alo[1]);
        split_a(x0.y, ahi[2], alo[2]);
        split_a(x1.y, ahi[3], alo[3]);
        const float* bk = b + k0 * p.ldb;
        const bool lo_ok = !edge || k0 + 2 * t < p.m, hi_ok = !edge || k0 + 2 * t + 1 < p.m;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
            uint32_t bhi[2], blo[2];
            split_b(lo_ok ? bk[j * kTileN] : 0.f, bhi[0], blo[0]);
            split_b(hi_ok ? bk[p.ldb + j * kTileN] : 0.f, bhi[1], blo[1]);
            mma_tf32(s[j], alo, bhi);
            mma_tf32(s[j], ahi, blo);
            mma_tf32(s[j], ahi, bhi);
        }
    };
    // the tensor core sums each k-step from zero; the sums are added to
    // acc in registers, in k order
    auto step_add = [&](int k0, bool edge) {
        float s[2][4] = {};
        step(k0, edge, s);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] += s[j][i];
        }
    };
    const int full = p.m / 8 * 8;
    int k0 = 0;
#pragma unroll 2
    for (; k0 < full; k0 += 8) step_add(k0, false);
    if (k0 < p.kp) step_add(k0, true);
    item_epilogue<kResiduals, 2>(p, r0, n0, lane, acc);
}

// One work item in float64: rows r0 .. r0 + 8 by columns n0 .. n0 +
// 8 kNT (kNT 8-column tiles), DMMA. Lane (g, t) holds A at row g and
// column t of each k-step, B at row t and column g of each tile, and
// ends with the sums at row g and columns 2t, 2t + 1 of each tile.
template <bool kResiduals, int kNT>
__device__ __forceinline__ void product_item(const Product<double>& p, int r0, int n0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const double* a = p.kmn + min(r0 + g, p.rows - 1) * p.ldk + t;
    const double* b = p.kb + t * p.ldb + n0 + g;
    double acc[2][2] = {};
    auto step = [&](int k0, bool edge) {
        const double av = a[k0];
        const bool ok = !edge || k0 + t < p.m;
        const double* bk = b + k0 * p.ldb;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
            double s[2] = {0.0, 0.0};
            mma_f64(s, av, ok ? bk[j * kTileN] : 0.0);
            acc[j][0] += s[0];
            acc[j][1] += s[1];
        }
    };
    const int full = p.m / 4 * 4;
    int k0 = 0;
#pragma unroll 4
    for (; k0 < full; k0 += 4) step(k0, false);
    if (k0 < p.kp) step(k0, true);
    item_epilogue<kResiduals, 1>(p, r0, n0, lane, acc);
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
    T* s_kb = smem + L.kb;      // [m, ldb]: kinv | alpha
    T* s_kmn = smem + L.kmn;    // [tn, ldk], zero in columns m .. kp
    T* s_varq = smem + L.varq;  // [d, m] (transposed)
    T* s_zs = smem + L.zs;      // [di, kp] (transposed)
    T* s_zn = smem + L.zn;      // [kp]
    T* s_ils = smem + L.ils;    // [di]
    T* s_xs = smem + L.xs;      // [di, tn] (transposed)
    T* s_xn = smem + L.xn;      // [tn]
    T* s_part = smem + L.part;  // [tn, np, 1 + d], over zs .. xn after phase 1
    const int kp = L.kp;

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

    // ---- staging: group 1 (phase 1's operands), group 2 (the rest) ----
    copy_rows(s_xs, tn, x + (size_t)row0 * di, rows, di, true);
    copy_rows(s_zs, kp, zs, m, di, true);
    copy_rows(s_ils, di, inv_ls, 1, di);
    cp_async_commit();
    copy_rows(s_kb, L.ldb, kinv, m, m);
    copy_rows(s_kb + m, L.ldb, alpha, m, d);
    copy_rows(s_varq, m, var_q, m, d, true);
    cp_async_commit();
    const T kvar = *kvar_ptr;

    // ---- group 1 in: scale x by inv_ls, take the squared norms ----
    cp_async_wait<1>();
    __syncthreads();
    for (int j = tid; j < m; j += kThreads) {
        T acc = T(0);
        for (int k = 0; k < di; ++k) acc = fma_t(s_zs[k * kp + j], s_zs[k * kp + j], acc);
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

    // ---- phase 1: kmn = kvar * exp(-0.5 * max(d2, 0)), one (row, 4
    // columns) a thread: a thread keeps its columns and steps over rows,
    // neighbouring threads on neighbouring columns of one row. Zero in
    // columns m .. kp (the padding that phase 2 reads): entries there
    // read unset shared memory and are replaced by the select. With
    // residuals the row of kmn is also written out ----
    {
        const int groups = kp / kR;              // 4-column groups of a row
        const int in_flight = kThreads / groups;  // rows stepped at once
        const int c0 = (tid % groups) * kR;
        const bool kmn_vec = kResiduals && m % kR == 0 &&
                             reinterpret_cast<uintptr_t>(kmn_out) % 16 == 0;
        for (int r = tid / groups; r < rows && tid < in_flight * groups; r += in_flight) {
            T cross[kR] = {};
            for (int k = 0; k < di; ++k) {
                const T a = s_xs[k * tn + r];
                T b[kR];
                load4(s_zs + k * kp + c0, b);
#pragma unroll
                for (int q = 0; q < kR; ++q) cross[q] = fma_t(a, b[q], cross[q]);
            }
            T zn[kR];
            load4(s_zn + c0, zn);
            const T xn = s_xn[r];
            T out[kR];
#pragma unroll
            for (int q = 0; q < kR; ++q) {
                T d2 = xn - T(2) * cross[q] + zn[q];
                d2 = d2 > T(0) ? d2 : T(0);
                const T kv = kvar * exp_t(T(-0.5) * d2);
                out[q] = c0 + q < m ? kv : T(0);
            }
            store4(s_kmn + r * L.ldk + c0, out);
            if (kResiduals) {
                T* dst = kmn_out + (size_t)(row0 + r) * m + c0;
                if (kmn_vec && c0 < m) {
                    store4(dst, out);
                } else if (!kmn_vec) {
#pragma unroll
                    for (int q = 0; q < kR; ++q) {
                        if (c0 + q < m) dst[q] = out[q];
                    }
                }
            }
        }
    }

    // ---- group 2 in: phase 2, [w | mean] = kmn @ [kinv | alpha] on the
    // tensor cores, an item (one mma row tile by two column tiles) a
    // warp in turn, each item writing its w and mean and its rows'
    // partial qf and variance sums ----
    cp_async_wait<0>();
    __syncthreads();
    {
        constexpr int kM = Mma<T>::kM;
        const Product<T> p{s_kmn, s_kb, s_varq, s_part, mean_out + (size_t)row0 * d,
                           kResiduals ? w_out + (size_t)row0 * m : nullptr,
                           rows, m, d, kp, L.ldk, L.ldb, L.np};
        const int pairs = (m + d + 2 * kTileN - 1) / (2 * kTileN);
        const int items = (rows + kM - 1) / kM * pairs;
        for (int i = warp; i < items; i += kWarps) {
            const int mi = i / pairs, n0 = (i - mi * pairs) * 2 * kTileN;
            if (n0 + kTileN < m + d) {
                product_item<kResiduals, 2>(p, mi * kM, n0, lane);
            } else {  // the last pair has one tile
                product_item<kResiduals, 1>(p, mi * kM, n0, lane);
            }
        }
    }
    __syncthreads();

    // ---- phase 3: var = max(kvar - qf, 0) + (w*w) @ var_q from the
    // partial sums, a (row, column) a thread, the 16-column groups in
    // order ----
    if (d > 0) {
        for_each_2d(rows * d, d, [&](int, int r, int c) {
            const T* part = s_part + r * L.np * (1 + d);
            T qf = T(0), v = T(0);
            for (int k = 0; k < L.np; ++k) {
                qf += part[k * (1 + d)];
                v += part[k * (1 + d) + 1 + c];
            }
            var_out[(size_t)(row0 + r) * d + c] = (kvar - qf > T(0) ? kvar - qf : T(0)) + v;
        });
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
