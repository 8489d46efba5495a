// Single-core fp64 CPU baseline for the BSS determinantal QMC sweep.
//
// Purpose: the reference C++ (Armadillo + BLAS, single-threaded) could not
// be built (source mount empty — SURVEY.md §0), so this program is the
// measured denominator for BASELINE.md: the same algorithm the JAX path
// runs — B = diag(e^{alpha s}) expK propagators, per-site Metropolis with
// Sherman-Morrison rank-1 Green updates (BLAS dger), dense wraps (dgemm),
// QR/UdV stabilization every s slices with the same unitary-sandwich pair
// formula — in idiomatic BLAS/LAPACK C++, one core.
//
// Build: see Makefile (links scipy's bundled OpenBLAS64, 64-bit ints).
// Run:   ./dqmc_baseline [L beta m s n_pairs]   -> one JSON line on stdout.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <random>
#include <vector>

using i64 = long long;

extern "C" {
void scipy_dgemm_64_(const char*, const char*, const i64*, const i64*,
                     const i64*, const double*, const double*, const i64*,
                     const double*, const i64*, const double*, double*,
                     const i64*);
void scipy_dger_64_(const i64*, const i64*, const double*, const double*,
                    const i64*, const double*, const i64*, double*,
                    const i64*);
void scipy_dgeqrf_64_(const i64*, const i64*, double*, const i64*, double*,
                      double*, const i64*, i64*);
void scipy_dorgqr_64_(const i64*, const i64*, const i64*, double*,
                      const i64*, const double*, double*, const i64*, i64*);
void scipy_dgesv_64_(const i64*, const i64*, double*, const i64*, i64*,
                     double*, const i64*, i64*);
void scipy_dsyev_64_(const char*, const char*, const i64*, double*, const i64*,
                     double*, double*, const i64*, i64*);
}

// column-major n x n matrices
struct Mat {
  i64 n = 0;
  std::vector<double> a;
  explicit Mat(i64 n_ = 0) : n(n_), a(n_ * n_, 0.0) {}
  double& operator()(i64 i, i64 j) { return a[i + j * n]; }
  double operator()(i64 i, i64 j) const { return a[i + j * n]; }
  static Mat eye(i64 n) {
    Mat m(n);
    for (i64 i = 0; i < n; ++i) m(i, i) = 1.0;
    return m;
  }
};

static void gemm(const Mat& A, const Mat& B, Mat& C, bool ta = false,
                 bool tb = false) {
  const i64 n = A.n;
  const char TA = ta ? 'T' : 'N', TB = tb ? 'T' : 'N';
  const double one = 1.0, zero = 0.0;
  scipy_dgemm_64_(&TA, &TB, &n, &n, &n, &one, A.a.data(), &n, B.a.data(), &n,
                  &zero, C.a.data(), &n);
}

struct UDV {
  Mat U, V;
  std::vector<double> d;
  explicit UDV(i64 n = 0) : U(Mat::eye(n)), V(Mat::eye(n)), d(n, 1.0) {}
};

// QR-based UdV of C (destroyed); R-diagonal signs folded into U.
static void udv(Mat C, UDV& out) {
  const i64 n = C.n;
  std::vector<double> tau(n), signs(n);
  i64 info = 0, lwork = 64 * n;
  std::vector<double> work(lwork);
  scipy_dgeqrf_64_(&n, &n, C.a.data(), &n, tau.data(), work.data(), &lwork,
                   &info);
  for (i64 j = 0; j < n; ++j) {
    double rjj = C(j, j);
    signs[j] = (rjj >= 0) ? 1.0 : -1.0;
    out.d[j] = std::fabs(rjj);
    double inv = (out.d[j] == 0) ? 1.0 : signs[j] / out.d[j];
    for (i64 k = 0; k < n; ++k) out.V(j, k) = (k >= j) ? C(j, k) * inv : 0.0;
  }
  scipy_dorgqr_64_(&n, &n, &n, C.a.data(), &n, tau.data(), work.data(),
                   &lwork, &info);
  for (i64 j = 0; j < n; ++j)
    for (i64 i = 0; i < n; ++i) out.U(i, j) = C(i, j) * signs[j];
}

// G = U2 [d1max(d1max^-1 U1^T U2 d2max^-1 + d1min V1 V2^T d2min)d2max]^-1
//        U1^T   — identical formula to detqmc.linalg.udv.
static void green_pair(const UDV& L, const UDV& Rt, Mat& G) {
  const i64 n = G.n;
  Mat t1(n), t2(n), t3(n);
  gemm(L.U, Rt.U, t1, true, false);
  gemm(L.V, Rt.V, t2, false, true);
  for (i64 j = 0; j < n; ++j) {
    double d2max = std::max(Rt.d[j], 1.0), d2min = std::min(Rt.d[j], 1.0);
    for (i64 i = 0; i < n; ++i) {
      double d1max = std::max(L.d[i], 1.0), d1min = std::min(L.d[i], 1.0);
      t1(i, j) = t1(i, j) / d1max / d2max + d1min * t2(i, j) * d2min;
    }
  }
  UDV g(n);
  udv(t1, g);
  for (i64 j = 0; j < n; ++j) {
    double d1max = std::max(L.d[j], 1.0);
    for (i64 i = 0; i < n; ++i) t2(i, j) = g.U(j, i) / g.d[i] / d1max;
  }
  std::vector<i64> ipiv(n);
  i64 info = 0;
  scipy_dgesv_64_(&n, &n, g.V.a.data(), &n, ipiv.data(), t2.a.data(), &n,
                  &info);
  Mat U2s = Rt.U;
  for (i64 j = 0; j < n; ++j) {
    double d2max = std::max(Rt.d[j], 1.0);
    for (i64 i = 0; i < n; ++i) U2s(i, j) /= d2max;
  }
  gemm(U2s, t2, t3);
  gemm(t3, L.U, G, false, true);
}

struct Sim {
  i64 L, N, m, s, K;
  double t_hop = 1.0, U = 4.0, mu = 0.0, beta, dtau, alpha;
  Mat expK, expKinv;
  Mat G[2];                       // spin up/down Green functions
  std::vector<double> field;      // m x N
  std::vector<UDV> stack[2];      // consumed/emitted per sweep direction
  std::vector<UDV> left_store[2];
  std::mt19937_64 rng{12345};
  std::uniform_real_distribution<double> u01{0.0, 1.0};
  Mat t1, t2;

  Sim(i64 L_, double beta_, i64 m_, i64 s_)
      : L(L_), N(L_ * L_), m(m_), s(s_), K(m_ / s_), beta(beta_),
        dtau(beta_ / m_), expK(L_ * L_), expKinv(L_ * L_), t1(L_ * L_),
        t2(L_ * L_) {
    alpha = std::acosh(std::exp(dtau * U / 2.0));
    build_expK();
    G[0] = Mat(N);
    G[1] = Mat(N);
    field.resize(m * N);
    for (auto& f : field) f = (u01(rng) < 0.5) ? -1.0 : 1.0;
    for (int sg = 0; sg < 2; ++sg) {
      stack[sg].assign(K + 1, UDV(N));
      left_store[sg].assign(K + 1, UDV(N));
    }
    rebuild_stacks();
  }

  void build_expK() {
    Mat Km(N);
    for (i64 y = 0; y < L; ++y)
      for (i64 x = 0; x < L; ++x) {
        i64 i = y * L + x;
        Km(i, y * L + (x + 1) % L) -= t_hop;
        Km(i, y * L + (x + L - 1) % L) -= t_hop;
        Km(i, ((y + 1) % L) * L + x) -= t_hop;
        Km(i, ((y + L - 1) % L) * L + x) -= t_hop;
      }
    std::vector<double> w(N);
    i64 info = 0, lwork = 64 * N;
    std::vector<double> work(lwork);
    const char jobz = 'V', uplo = 'L';
    scipy_dsyev_64_(&jobz, &uplo, &N, Km.a.data(), &N, w.data(), work.data(),
                    &lwork, &info);
    Mat tmp(N);
    for (i64 j = 0; j < N; ++j)
      for (i64 i = 0; i < N; ++i)
        tmp(i, j) = Km(i, j) * std::exp(-dtau * (w[j] - mu));
    gemm(tmp, Km, expK, false, true);
    for (i64 j = 0; j < N; ++j)
      for (i64 i = 0; i < N; ++i)
        tmp(i, j) = Km(i, j) * std::exp(dtau * (w[j] - mu));
    gemm(tmp, Km, expKinv, false, true);
  }

  double ev(i64 l, i64 i, int sg) const {
    double sgn = sg == 0 ? 1.0 : -1.0;
    return std::exp(sgn * alpha * field[(l - 1) * N + i]);
  }

  void b_mult_left(i64 l, int sg, Mat& X) {  // X <- B_l X
    gemm(expK, X, t1);
    for (i64 j = 0; j < N; ++j)
      for (i64 i = 0; i < N; ++i) X(i, j) = ev(l, i, sg) * t1(i, j);
  }
  void bT_mult_left(i64 l, int sg, Mat& X) {  // X <- B_l^T X
    for (i64 j = 0; j < N; ++j)
      for (i64 i = 0; i < N; ++i) t1(i, j) = ev(l, i, sg) * X(i, j);
    gemm(expK, t1, X, true, false);
  }
  void wrap_up(i64 l, int sg) {  // G <- B G B^{-1}
    gemm(G[sg], expKinv, t1);
    for (i64 j = 0; j < N; ++j)
      for (i64 i = 0; i < N; ++i) t1(i, j) /= ev(l, j, sg);
    gemm(expK, t1, t2);
    for (i64 j = 0; j < N; ++j)
      for (i64 i = 0; i < N; ++i) G[sg](i, j) = ev(l, i, sg) * t2(i, j);
  }
  void wrap_down(i64 l, int sg) {  // G <- B^{-1} G B
    for (i64 j = 0; j < N; ++j)
      for (i64 i = 0; i < N; ++i)
        t1(i, j) = G[sg](i, j) / ev(l, i, sg) * ev(l, j, sg);
    gemm(t1, expK, t2);
    gemm(expKinv, t2, G[sg]);
  }

  i64 update_slice(i64 l) {  // both spins coupled through the accept
    i64 acc = 0;
    const i64 one = 1;
    std::vector<double> u(N), w(N);
    for (i64 i = 0; i < N; ++i) {
      double sO = field[(l - 1) * N + i];
      double delta[2], R[2];
      for (int sg = 0; sg < 2; ++sg) {
        double sgn = sg == 0 ? 1.0 : -1.0;
        delta[sg] = std::exp(-2.0 * sgn * alpha * sO) - 1.0;
        R[sg] = 1.0 + delta[sg] * (1.0 - G[sg](i, i));
      }
      if (u01(rng) < std::fabs(R[0] * R[1])) {
        for (int sg = 0; sg < 2; ++sg) {
          double coef = -delta[sg] / R[sg];
          for (i64 k = 0; k < N; ++k) u[k] = G[sg](k, i);
          for (i64 k = 0; k < N; ++k) w[k] = -G[sg](i, k);
          w[i] += 1.0;
          scipy_dger_64_(&N, &N, &coef, u.data(), &one, w.data(), &one,
                         G[sg].a.data(), &N);
        }
        field[(l - 1) * N + i] = -sO;
        ++acc;
      }
    }
    return acc;
  }

  void refactor(UDV& cur, Mat& lazy) {
    Mat C = lazy;
    for (i64 j = 0; j < N; ++j)
      for (i64 i = 0; i < N; ++i) C(i, j) *= cur.d[j];
    UDV f(N);
    udv(C, f);
    Mat Vnew(N);
    gemm(f.V, cur.V, Vnew);
    cur.U = f.U;
    cur.d = f.d;
    cur.V = Vnew;
    lazy = cur.U;
  }

  void rebuild_stacks() {  // right stack (transposed) from field; G = G(0)
    for (int sg = 0; sg < 2; ++sg) {
      stack[sg][K] = UDV(N);
      UDV cur(N);
      Mat lazy = cur.U;
      for (i64 k = K; k >= 1; --k) {
        for (i64 l = k * s; l > (k - 1) * s; --l) bT_mult_left(l, sg, lazy);
        refactor(cur, lazy);
        stack[sg][k - 1] = cur;
      }
      UDV eye(N);
      green_pair(eye, stack[sg][0], G[sg]);
    }
  }

  double sweep_pair(i64* acc_total) {
    double dev = 0.0;
    Mat Gold(N);
    // ---- up sweep: consume right stack, emit left_store
    UDV curL[2] = {UDV(N), UDV(N)};
    Mat lazyL[2] = {curL[0].U, curL[1].U};
    for (i64 k = 1; k <= K; ++k) {
      for (i64 l = (k - 1) * s + 1; l <= k * s; ++l) {
        for (int sg = 0; sg < 2; ++sg) wrap_up(l, sg);
        *acc_total += update_slice(l);
        for (int sg = 0; sg < 2; ++sg) b_mult_left(l, sg, lazyL[sg]);
      }
      for (int sg = 0; sg < 2; ++sg) {
        refactor(curL[sg], lazyL[sg]);
        left_store[sg][k] = curL[sg];
        Gold = G[sg];
        green_pair(curL[sg], stack[sg][k], G[sg]);
        for (i64 idx = 0; idx < N * N; ++idx)
          dev = std::max(dev, std::fabs(Gold.a[idx] - G[sg].a[idx]));
      }
    }
    // ---- down sweep: consume left_store, emit right stack
    UDV curR[2] = {UDV(N), UDV(N)};
    Mat lazyR[2] = {curR[0].U, curR[1].U};
    for (i64 k = K; k >= 1; --k) {
      for (i64 l = k * s; l >= (k - 1) * s + 1; --l) {
        *acc_total += update_slice(l);
        for (int sg = 0; sg < 2; ++sg) {
          bT_mult_left(l, sg, lazyR[sg]);
          wrap_down(l, sg);
        }
      }
      for (int sg = 0; sg < 2; ++sg) {
        refactor(curR[sg], lazyR[sg]);
        Gold = G[sg];
        green_pair(left_store[sg][k - 1], curR[sg], G[sg]);
        for (i64 idx = 0; idx < N * N; ++idx)
          dev = std::max(dev, std::fabs(Gold.a[idx] - G[sg].a[idx]));
        stack[sg][k - 1] = curR[sg];
      }
    }
    for (int sg = 0; sg < 2; ++sg) stack[sg][K] = UDV(N);
    return dev;
  }
};

// deterministic 64-bit LCG field for the Python parity selftest
static double lcg_u01(uint64_t& st) {
  st = st * 6364136223846793005ULL + 1442695040888963407ULL;
  return double(st >> 11) * (1.0 / 9007199254740992.0);
}

int main(int argc, char** argv) {
  if (argc > 1 && strcmp(argv[1], "selftest") == 0) {
    // ./dqmc_baseline selftest L beta m s out.bin: G_up from the LCG
    // field (column-major f64) for tests/test_sdw_baseline.py's Hubbard
    // parity gate
    i64 L = atoll(argv[2]);
    double beta = atof(argv[3]);
    i64 m = atoll(argv[4]), s = atoll(argv[5]);
    Sim sim(L, beta, m, s);
    uint64_t st = 42;
    for (i64 t = 0; t < m * sim.N; ++t)
      sim.field[t] = (lcg_u01(st) < 0.5) ? -1.0 : 1.0;
    sim.rebuild_stacks();
    FILE* f = fopen(argv[6], "wb");
    fwrite(sim.G[0].a.data(), sizeof(double), sim.G[0].a.size(), f);
    fclose(f);
    printf("{\"selftest\": \"G_up written\", \"N\": %lld}\n", sim.N);
    return 0;
  }
  i64 L = argc > 1 ? atoll(argv[1]) : 8;
  double beta = argc > 2 ? atof(argv[2]) : 8.0;
  i64 m = argc > 3 ? atoll(argv[3]) : 80;
  i64 s = argc > 4 ? atoll(argv[4]) : 4;
  i64 n_pairs = argc > 5 ? atoll(argv[5]) : 10;

  Sim sim(L, beta, m, s);
  i64 acc = 0;
  sim.sweep_pair(&acc);  // warmup / thermal start
  sim.sweep_pair(&acc);

  acc = 0;
  double dev = 0.0;
  struct timespec ts0, ts1;
  clock_gettime(CLOCK_MONOTONIC, &ts0);
  for (i64 p = 0; p < n_pairs; ++p) dev = std::max(dev, sim.sweep_pair(&acc));
  clock_gettime(CLOCK_MONOTONIC, &ts1);
  double dt = (ts1.tv_sec - ts0.tv_sec) + 1e-9 * (ts1.tv_nsec - ts0.tv_nsec);

  double sweeps_per_sec = 2.0 * n_pairs / dt;
  double occ = 0.0;
  for (int sg = 0; sg < 2; ++sg)
    for (i64 i = 0; i < sim.N; ++i) occ += 1.0 - sim.G[sg](i, i);
  occ /= sim.N;
  printf(
      "{\"metric\": \"cpu_baseline_L%lld_beta%g_sweeps_per_sec\", "
      "\"value\": %.4f, \"unit\": \"sweeps/s\", \"green_dev\": %.3e, "
      "\"acc_rate\": %.3f, \"occupancy\": %.6f}\n",
      L, beta, sweeps_per_sec, dev,
      double(acc) / (2.0 * n_pairs * 2 * sim.m * sim.N) * 2.0, occ);
  return 0;
}
