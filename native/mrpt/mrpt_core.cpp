// Ferrenberg-Swendsen multihistogram core — native OpenMP implementation.
//
// Reference parity: the upstream mrpt family (SURVEY.md §3 "mrpt family",
// expected src/mrpt.cpp) runs its self-consistency iteration and
// reweighting sums as OpenMP-parallel C++ loops; this is the JAX-framework
// equivalent, driving the same log-domain math as analysis/mrpt.py's
// NumPy fallback without materializing the (S, R) sample-by-parameter
// matrix (at 32 replicas x 100k samples that matrix is ~0.8 GB per
// iteration in NumPy; here the working set is one S-vector).
//
// Exposed via ctypes (no pybind11 in this image): plain C ABI, f64 in/out.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC mrpt_core.cpp
//        -o libmrpt_core.so     (see Makefile; analysis/_native.py builds
//        on demand and falls back to NumPy when no compiler is present)

#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// log denominator of the FS weight for one sample:
//   den_s = logsumexp_j( log_n_j + f_j - r_j * a_s )
inline double log_den(double a_s, const double* r, const double* lognf,
                      int R) {
    double m = -INFINITY;
    for (int j = 0; j < R; ++j) {
        double z = lognf[j] - r[j] * a_s;
        if (z > m) m = z;
    }
    double s = 0.0;
    for (int j = 0; j < R; ++j) s += std::exp(lognf[j] - r[j] * a_s - m);
    return m + std::log(s);
}

}  // namespace

extern "C" {

// Self-consistent free-energy solve. f (length R, f[0] pinned to 0) is
// updated in place; returns the number of iterations used (== max_iter if
// not converged to tol).
int fs_solve(const double* a, int64_t S, const double* r,
             const double* log_n, int R, double* f, double tol,
             int max_iter) {
    std::vector<double> lognf(R), den(S), mx(R), acc(R), f_new(R);
    int it = 0;
    for (it = 0; it < max_iter; ++it) {
        for (int j = 0; j < R; ++j) lognf[j] = log_n[j] + f[j];

        // pass 1: per-sample log denominators + per-parameter maxima of
        // (-r_k a_s - den_s), for a log-domain-safe accumulation
        for (int k = 0; k < R; ++k) mx[k] = -INFINITY;
#pragma omp parallel
        {
            std::vector<double> mx_loc(R, -INFINITY);
#pragma omp for schedule(static)
            for (int64_t s = 0; s < S; ++s) {
                double d = log_den(a[s], r, lognf.data(), R);
                den[s] = d;
                for (int k = 0; k < R; ++k) {
                    double z = -r[k] * a[s] - d;
                    if (z > mx_loc[k]) mx_loc[k] = z;
                }
            }
#pragma omp critical
            for (int k = 0; k < R; ++k)
                if (mx_loc[k] > mx[k]) mx[k] = mx_loc[k];
        }

        // pass 2: f_new_k = -(mx_k + log sum_s exp(-r_k a_s - den_s - mx_k))
        for (int k = 0; k < R; ++k) acc[k] = 0.0;
#pragma omp parallel
        {
            std::vector<double> acc_loc(R, 0.0);
#pragma omp for schedule(static)
            for (int64_t s = 0; s < S; ++s) {
                for (int k = 0; k < R; ++k)
                    acc_loc[k] += std::exp(-r[k] * a[s] - den[s] - mx[k]);
            }
#pragma omp critical
            for (int k = 0; k < R; ++k) acc[k] += acc_loc[k];
        }
        for (int k = 0; k < R; ++k) f_new[k] = -(mx[k] + std::log(acc[k]));
        double f0 = f_new[0];
        double delta = 0.0;
        for (int k = 0; k < R; ++k) {
            f_new[k] -= f0;
            double d = std::fabs(f_new[k] - f[k]);
            if (d > delta) delta = d;
            f[k] = f_new[k];
        }
        if (delta < tol) return it + 1;
    }
    return it;
}

// Log FS weights at a target parameter:
//   lw[s] = -r_target * a_s - logsumexp_j(log_n_j + f_j - r_j a_s)
void fs_log_weights(const double* a, int64_t S, const double* r,
                    const double* log_n, const double* f, int R,
                    double r_target, double* lw) {
    std::vector<double> lognf(R);
    for (int j = 0; j < R; ++j) lognf[j] = log_n[j] + f[j];
#pragma omp parallel for schedule(static)
    for (int64_t s = 0; s < S; ++s)
        lw[s] = -r_target * a[s] - log_den(a[s], r, lognf.data(), R);
}

// Reweighted expectations of `M` observable series at `T` target
// parameters in one pass: out[t*M + m] = <O_m>(r_targets[t]).
// obs: (M, S) row-major.
void fs_curve(const double* a, int64_t S, const double* r,
              const double* log_n, const double* f, int R,
              const double* r_targets, int T, const double* obs, int M,
              double* out) {
    std::vector<double> den(S);
#pragma omp parallel for schedule(static)
    for (int64_t s = 0; s < S; ++s) {
        std::vector<double> lognf(R);
        for (int j = 0; j < R; ++j) lognf[j] = log_n[j] + f[j];
        den[s] = log_den(a[s], r, lognf.data(), R);
    }
    for (int t = 0; t < T; ++t) {
        double rt = r_targets[t];
        double m = -INFINITY;
#pragma omp parallel for reduction(max : m) schedule(static)
        for (int64_t s = 0; s < S; ++s) {
            double z = -rt * a[s] - den[s];
            if (z > m) m = z;
        }
        std::vector<double> num(M, 0.0);
        double wsum = 0.0;
#pragma omp parallel
        {
            std::vector<double> num_loc(M, 0.0);
            double wsum_loc = 0.0;
#pragma omp for schedule(static)
            for (int64_t s = 0; s < S; ++s) {
                double w = std::exp(-rt * a[s] - den[s] - m);
                wsum_loc += w;
                for (int o = 0; o < M; ++o)
                    num_loc[o] += w * obs[(int64_t)o * S + s];
            }
#pragma omp critical
            {
                wsum += wsum_loc;
                for (int o = 0; o < M; ++o) num[o] += num_loc[o];
            }
        }
        for (int o = 0; o < M; ++o) out[(int64_t)t * M + o] = num[o] / wsum;
    }
}

}  // extern "C"
