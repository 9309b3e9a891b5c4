// Native host data pipeline of cbfssm_tpu_torch (the port's own copy of
// the JAX package's native/hostloader.cpp, the same three functions).
//
// The device path is PyTorch and CUDA; the host side keeps it fed:
//
//  1. window_gather: sliding-window extraction [E, T, D] -> [W, L, D]
//     (the windowing of every float64 dataset; multi-threaded memcpy).
//  2. unwrap_angles: the sequential euler-angle jump filter of the
//     Voliro log loader (a carried-dependency loop that numpy cannot
//     vectorize; reference semantics in cbfssm/datasets/voliro_loader.py
//     :141-158).
//  3. normalize_cast: fused (x - mean) / std with float64 -> float32
//     conversion, an ingest utility for serving hosts that receive raw
//     f64 telemetry. The training pipeline normalizes once at dataset
//     build time in f64, so it has no call site in the package.
//
// A plain C ABI consumed via ctypes (cbfssm_tpu_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather windows of length L from each experiment's time axis.
// x: [n_exp, t_len, dim] row-major; starts: [n_starts] window offsets
// (shared across experiments); out: [n_exp * n_starts, L, dim].
void window_gather_f64(const double* x, int64_t n_exp, int64_t t_len,
                       int64_t dim, const int64_t* starts, int64_t n_starts,
                       int64_t win_len, double* out) {
  const int64_t row_bytes = dim * static_cast<int64_t>(sizeof(double));
  const int64_t win_elems = win_len * dim;
  int64_t n_threads =
      std::min<int64_t>(std::thread::hardware_concurrency() > 0
                            ? std::thread::hardware_concurrency()
                            : 1,
                        n_exp * n_starts);
  if (n_threads < 1) n_threads = 1;

  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t w = begin; w < end; ++w) {
      const int64_t e = w / n_starts;
      const int64_t s = starts[w % n_starts];
      const double* src = x + (e * t_len + s) * dim;
      double* dst = out + w * win_elems;
      std::memcpy(dst, src, static_cast<size_t>(win_len * row_bytes));
    }
  };

  const int64_t total = n_exp * n_starts;
  if (n_threads == 1) {
    worker(0, total);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (total + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t begin = t * chunk;
    const int64_t end = std::min(total, begin + chunk);
    if (begin >= end) break;
    threads.emplace_back(worker, begin, end);
  }
  for (auto& th : threads) th.join();
}

// In-place euler-angle jump filter. vec: [t_len, n_cols] row-major.
// Matches the reference's asymmetric unwrap exactly: a positive jump
// subtracts 2*pi; a negative jump first tries +pi, then +2*pi.
void unwrap_angles_f64(double* vec, int64_t t_len, int64_t n_cols,
                       double threshold) {
  const double two_pi = 2.0 * M_PI;
  for (int64_t k = 0; k < n_cols; ++k) {
    double prev = vec[k];
    for (int64_t i = 1; i < t_len; ++i) {
      double v = vec[i * n_cols + k];
      double cand;
      if (v - prev > threshold) {
        cand = v - two_pi;
      } else if (v - prev < -threshold) {
        cand = v + M_PI;
        if (cand - prev < -threshold) cand = v + two_pi;
      } else {
        cand = v;
      }
      vec[i * n_cols + k] = cand;
      prev = cand;
    }
  }
}

// Fused z-score + downcast: out_f32 = (x - mean) / std. x: [n, dim].
void normalize_cast_f32(const double* x, int64_t n, int64_t dim,
                        const double* mean, const double* std_dev,
                        float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double* row = x + i * dim;
    float* dst = out + i * dim;
    for (int64_t d = 0; d < dim; ++d) {
      dst[d] = static_cast<float>((row[d] - mean[d]) / std_dev[d]);
    }
  }
}

}  // extern "C"
