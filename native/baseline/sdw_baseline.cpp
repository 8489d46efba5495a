// Single-core fp64 CPU baseline for the O(3) SDW determinantal QMC sweep.
//
// Purpose: BASELINE.md's denominator for the SDW lines (the reference's
// main scientific payload, expected src/detsdwopdim.cpp — mount empty, see
// SURVEY.md §0). Same algorithm class as the JAX path's bench config:
// full opdim-3 chain on the complex 4N-dim fermion matrix, dense per-band
// e^{-dtau K} (zgemm wraps), per-site box-proposal Metropolis with the
// 4x4 block det ratio and rank-4 Woodbury Green updates (zgemm), QR/UdV
// stabilization every s slices with the identical stable pair formula
// (complex mirror of dqmc_baseline.cpp / detqmc.linalg.udv).
//
// Conventions match detqmc/models/sdw.py exactly (verified by the
// selftest mode + tests/test_sdw_baseline.py):
//   B_l = D_V(phi_l) expK, orbital-major basis (x_up, x_dn, y_up, y_dn),
//   D_V site blocks [[ch 1_2, c Phi], [c Phi, ch 1_2]], Phi = phi . sigma,
//   ch = cosh(dtau lam |phi|), c = sign sinh(dtau lam |phi|)/|phi|,
//   per-band hoppings (txhor, txver, tyhor, tyver) = (-1, -0.5, -0.5, -1),
//   mu = -0.5; accept weight |det A| e^{-dS_boson}, A = 1 + Delta(1-G_II).
//
// Build: make sdw_baseline (links scipy's OpenBLAS64).
// Run:   ./sdw_baseline [L beta m s n_pairs r]      -> one JSON line.
//        ./sdw_baseline selftest L beta m s out.bin -> G from the LCG
//        field (column-major complex128) for the Python parity test.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <random>
#include <vector>

using i64 = long long;
using cd = std::complex<double>;

extern "C" {
void scipy_zgemm_64_(const char*, const char*, const i64*, const i64*,
                     const i64*, const cd*, const cd*, const i64*, const cd*,
                     const i64*, const cd*, cd*, const i64*);
void scipy_zgeqrf_64_(const i64*, const i64*, cd*, const i64*, cd*, cd*,
                      const i64*, i64*);
void scipy_zungqr_64_(const i64*, const i64*, const i64*, cd*, const i64*,
                      const cd*, cd*, const i64*, i64*);
void scipy_zgesv_64_(const i64*, const i64*, cd*, const i64*, i64*, cd*,
                     const i64*, i64*);
void scipy_dsyev_64_(const char*, const char*, const i64*, double*,
                     const i64*, double*, double*, const i64*, i64*);
}

// column-major n x n complex matrices
struct Mat {
  i64 n = 0;
  std::vector<cd> a;
  explicit Mat(i64 n_ = 0) : n(n_), a(n_ * n_, cd(0.0)) {}
  cd& operator()(i64 i, i64 j) { return a[i + j * n]; }
  cd operator()(i64 i, i64 j) const { return a[i + j * n]; }
  static Mat eye(i64 n) {
    Mat m(n);
    for (i64 i = 0; i < n; ++i) m(i, i) = 1.0;
    return m;
  }
};

static void gemm(const Mat& A, const Mat& B, Mat& C, char ta = 'N',
                 char tb = 'N') {
  const i64 n = A.n;
  const cd one = 1.0, zero = 0.0;
  scipy_zgemm_64_(&ta, &tb, &n, &n, &n, &one, A.a.data(), &n, B.a.data(), &n,
                  &zero, C.a.data(), &n);
}

struct UDV {
  Mat U, V;
  std::vector<double> d;
  explicit UDV(i64 n = 0) : U(Mat::eye(n)), V(Mat::eye(n)), d(n, 1.0) {}
};

// QR-based UdV of C (destroyed); |R|-diagonal split off, R-diagonal
// phases folded into U (any valid UdV of the same product yields the
// same Green function — phase fixing is for conditioning only).
static void udv(Mat C, UDV& out) {
  const i64 n = C.n;
  std::vector<cd> tau(n), phases(n);
  i64 info = 0, lwork = 64 * n;
  std::vector<cd> work(lwork);
  scipy_zgeqrf_64_(&n, &n, C.a.data(), &n, tau.data(), work.data(), &lwork,
                   &info);
  for (i64 j = 0; j < n; ++j) {
    cd rjj = C(j, j);
    double ab = std::abs(rjj);
    phases[j] = (ab == 0) ? cd(1.0) : rjj / ab;
    out.d[j] = ab;
    cd inv = (ab == 0) ? cd(1.0) : std::conj(phases[j]) / ab;
    for (i64 k = 0; k < n; ++k)
      out.V(j, k) = (k >= j) ? C(j, k) * inv : cd(0.0);
  }
  scipy_zungqr_64_(&n, &n, &n, C.a.data(), &n, tau.data(), work.data(),
                   &lwork, &info);
  for (i64 j = 0; j < n; ++j)
    for (i64 i = 0; i < n; ++i) out.U(i, j) = C(i, j) * phases[j];
}

// G = U2 [d1max(d1max^-1 U1^H U2 d2max^-1 + d1min V1 V2^H d2min)d2max]^-1
//        U1^H  — complex mirror of detqmc.linalg.udv's pair formula.
static void green_pair(const UDV& L, const UDV& Rt, Mat& G) {
  const i64 n = G.n;
  Mat t1(n), t2(n), t3(n);
  gemm(L.U, Rt.U, t1, 'C', 'N');
  gemm(L.V, Rt.V, t2, 'N', 'C');
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
    for (i64 i = 0; i < n; ++i)
      t2(i, j) = std::conj(g.U(j, i)) / g.d[i] / d1max;
  }
  std::vector<i64> ipiv(n);
  i64 info = 0;
  scipy_zgesv_64_(&n, &n, g.V.a.data(), &n, ipiv.data(), t2.a.data(), &n,
                  &info);
  Mat U2s = Rt.U;
  for (i64 j = 0; j < n; ++j) {
    double d2max = std::max(Rt.d[j], 1.0);
    for (i64 i = 0; i < n; ++i) U2s(i, j) /= d2max;
  }
  gemm(U2s, t2, t3);
  gemm(t3, L.U, G, 'N', 'C');
}

// 4x4 complex LU with partial pivoting: determinant + solve A X = B
// (B 4 columns) — the per-site det-ratio/Woodbury block math.
static cd lu4_det_solve(cd A[4][4], cd B[4][4]) {
  int piv[4] = {0, 1, 2, 3};
  cd det = 1.0;
  for (int k = 0; k < 4; ++k) {
    int p = k;
    for (int i = k + 1; i < 4; ++i)
      if (std::abs(A[i][k]) > std::abs(A[p][k])) p = i;
    if (p != k) {
      for (int j = 0; j < 4; ++j) std::swap(A[k][j], A[p][j]);
      for (int j = 0; j < 4; ++j) std::swap(B[k][j], B[p][j]);
      std::swap(piv[k], piv[p]);
      det = -det;
    }
    det *= A[k][k];
    cd inv = (A[k][k] == cd(0.0)) ? cd(0.0) : 1.0 / A[k][k];
    for (int i = k + 1; i < 4; ++i) {
      cd f = A[i][k] * inv;
      A[i][k] = f;
      for (int j = k + 1; j < 4; ++j) A[i][j] -= f * A[k][j];
      for (int j = 0; j < 4; ++j) B[i][j] -= f * B[k][j];
    }
  }
  // back substitution
  for (int j = 0; j < 4; ++j)
    for (int i = 3; i >= 0; --i) {
      cd s = B[i][j];
      for (int k = i + 1; k < 4; ++k) s -= A[i][k] * B[k][j];
      B[i][j] = (A[i][i] == cd(0.0)) ? cd(0.0) : s / A[i][i];
    }
  return det;
}

struct Sim {
  i64 L, N, dim, m, s, K;
  double beta, dtau;
  // model constants (defaults of detqmc.models.sdw.SDWConfig)
  double lam = 1.0, u = 1.0, c = 1.0, r = 0.5, mu = -0.5;
  double txhor = -1.0, txver = -0.5, tyhor = -0.5, tyver = -1.0;
  double box_w = 1.0;
  std::vector<cd> expKb[2], expKbi[2];  // per band (x, y), N x N (real-
                                        // valued, stored complex for zgemm)
  Mat G;
  std::vector<double> phi;                  // m x N x 3
  std::vector<i64> nb;                      // N x 4 (+x, -x, +y, -y)
  std::vector<UDV> stack, left_store;
  cd phase{1.0, 0.0};
  std::mt19937_64 rng{12345};
  std::uniform_real_distribution<double> u01{0.0, 1.0};
  Mat kscr;  // kinetic-apply scratch (kin_left/kin_right only)

  Sim(i64 L_, double beta_, i64 m_, i64 s_, double r_)
      : L(L_), N(L_ * L_), dim(4 * L_ * L_), m(m_), s(s_), K(m_ / s_),
        beta(beta_), dtau(beta_ / m_), r(r_), G(4 * L_ * L_),
        kscr(4 * L_ * L_) {
    build_expK();
    build_nb();
    phi.assign(m * N * 3, 0.0);
    for (auto& p : phi) p = (u01(rng) - 0.5);
    stack.assign(K + 1, UDV(dim));
    left_store.assign(K + 1, UDV(dim));
    rebuild_stacks();
  }

  void build_nb() {
    nb.resize(N * 4);
    for (i64 y = 0; y < L; ++y)
      for (i64 x = 0; x < L; ++x) {
        i64 i = y * L + x;
        nb[i * 4 + 0] = y * L + (x + 1) % L;
        nb[i * 4 + 1] = y * L + (x + L - 1) % L;
        nb[i * 4 + 2] = ((y + 1) % L) * L + x;
        nb[i * 4 + 3] = ((y + L - 1) % L) * L + x;
      }
  }

  void build_expK() {
    // bands: 0 = x band (tx=txhor along x, ty=txver along y), 1 = y band
    double tx[2] = {txhor, tyhor}, ty[2] = {txver, tyver};
    for (int b = 0; b < 2; ++b) {
      std::vector<double> Km(N * N, 0.0);
      for (i64 y = 0; y < L; ++y)
        for (i64 x = 0; x < L; ++x) {
          i64 i = y * L + x;
          Km[i + (y * L + (x + 1) % L) * N] -= tx[b];
          Km[i + (y * L + (x + L - 1) % L) * N] -= tx[b];
          Km[i + (((y + 1) % L) * L + x) * N] -= ty[b];
          Km[i + (((y + L - 1) % L) * L + x) * N] -= ty[b];
        }
      std::vector<double> w(N);
      i64 info = 0, lwork = 64 * N;
      std::vector<double> work(lwork);
      const char jobz = 'V', uplo = 'L';
      scipy_dsyev_64_(&jobz, &uplo, &N, Km.data(), &N, w.data(), work.data(),
                      &lwork, &info);
      expKb[b].assign(N * N, 0.0);
      expKbi[b].assign(N * N, 0.0);
      for (i64 i = 0; i < N; ++i)
        for (i64 j = 0; j < N; ++j) {
          double sp = 0.0, sm = 0.0;
          for (i64 k = 0; k < N; ++k) {
            double vv = Km[i + k * N] * Km[j + k * N];
            sp += vv * std::exp(-dtau * (w[k] - mu));
            sm += vv * std::exp(dtau * (w[k] - mu));
          }
          expKb[b][i + j * N] = sp;
          expKbi[b][i + j * N] = sm;
        }
    }
  }

  // X <- expK X (or inverse): per-orbital N x N band block times the
  // complex (dim, dim) operand, bands (x, x, y, y), zgemm per block
  void kin_left(Mat& X, bool inv) {
    const cd one = 1.0, zero = 0.0;
    const char nt = 'N';
    for (int o = 0; o < 4; ++o) {
      const cd* E = (inv ? expKbi[o / 2] : expKb[o / 2]).data();
      scipy_zgemm_64_(&nt, &nt, &N, &dim, &N, &one, E, &N, &X.a[o * N],
                      &dim, &zero, &kscr.a[o * N], &dim);
    }
    std::swap(X.a, kscr.a);
  }
  void kin_right(Mat& X, bool inv) {
    const cd one = 1.0, zero = 0.0;
    const char nt = 'N';
    for (int o = 0; o < 4; ++o) {
      const cd* E = (inv ? expKbi[o / 2] : expKb[o / 2]).data();
      scipy_zgemm_64_(&nt, &nt, &dim, &N, &N, &one, &X.a[o * N * dim], &dim,
                      E, &N, &zero, &kscr.a[o * N * dim], &dim);
    }
    std::swap(X.a, kscr.a);
  }

  // per-site 4x4 exp(sign dtau V(phi)) block (closed form, SURVEY.md §9)
  void ev_block(const double* p, double sign, cd B4[4][4]) const {
    double nrm = std::sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
    double a = dtau * lam * nrm;
    double ch = std::cosh(a);
    double sh_over = (nrm > 0) ? std::sinh(a) / nrm : dtau * lam;
    double cf = sign * sh_over;
    // Phi = phi . sigma = [[pz, px - i py], [px + i py, -pz]]
    cd off00 = cf * p[2], off01 = cf * cd(p[0], -p[1]);
    cd off10 = cf * cd(p[0], p[1]), off11 = -cf * p[2];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) B4[i][j] = 0.0;
    B4[0][0] = ch;
    B4[1][1] = ch;
    B4[2][2] = ch;
    B4[3][3] = ch;
    B4[0][2] = off00;
    B4[0][3] = off01;
    B4[1][2] = off10;
    B4[1][3] = off11;
    B4[2][0] = off00;  // Phi is Hermitian: Phi^H = Phi
    B4[2][1] = off01;
    B4[3][0] = off10;
    B4[3][1] = off11;
  }

  // X <- D_V X (block-diagonal per site; sign selects B vs B^{-1} factor)
  void dv_left(i64 l, double sign, Mat& X) {
    cd B4[4][4];
    for (i64 i = 0; i < N; ++i) {
      ev_block(&phi[((l - 1) * N + i) * 3], sign, B4);
      for (i64 j = 0; j < dim; ++j) {
        cd x0 = X(i, j), x1 = X(N + i, j), x2 = X(2 * N + i, j),
           x3 = X(3 * N + i, j);
        X(i, j) = B4[0][0] * x0 + B4[0][2] * x2 + B4[0][3] * x3;
        X(N + i, j) = B4[1][1] * x1 + B4[1][2] * x2 + B4[1][3] * x3;
        X(2 * N + i, j) = B4[2][0] * x0 + B4[2][1] * x1 + B4[2][2] * x2;
        X(3 * N + i, j) = B4[3][0] * x0 + B4[3][1] * x1 + B4[3][3] * x3;
      }
    }
  }
  // X <- X D_V
  void dv_right(Mat& X, i64 l, double sign) {
    cd B4[4][4];
    for (i64 i = 0; i < N; ++i) {
      ev_block(&phi[((l - 1) * N + i) * 3], sign, B4);
      cd* c0 = &X.a[(0 * N + i) * dim];
      cd* c1 = &X.a[(1 * N + i) * dim];
      cd* c2 = &X.a[(2 * N + i) * dim];
      cd* c3 = &X.a[(3 * N + i) * dim];
      for (i64 k = 0; k < dim; ++k) {
        cd x0 = c0[k], x1 = c1[k], x2 = c2[k], x3 = c3[k];
        c0[k] = x0 * B4[0][0] + x2 * B4[2][0] + x3 * B4[3][0];
        c1[k] = x1 * B4[1][1] + x2 * B4[2][1] + x3 * B4[3][1];
        c2[k] = x0 * B4[0][2] + x1 * B4[1][2] + x2 * B4[2][2];
        c3[k] = x0 * B4[0][3] + x1 * B4[1][3] + x3 * B4[3][3];
      }
    }
  }

  void b_mult_left(i64 l, Mat& X) {  // X <- B_l X = D_V expK X
    kin_left(X, false);
    dv_left(l, -1.0, X);
  }
  void bH_mult_left(i64 l, Mat& X) {  // X <- B_l^H X = expK D_V X
    dv_left(l, -1.0, X);               // D_V Hermitian, expK symmetric real
    kin_left(X, false);
  }
  void wrap_up(i64 l) {  // G <- B_l G B_l^{-1} (all applies in place)
    kin_left(G, false);
    dv_left(l, -1.0, G);
    kin_right(G, true);
    dv_right(G, l, +1.0);
  }
  void wrap_down(i64 l) {  // G <- B_l^{-1} G B_l
    dv_left(l, +1.0, G);
    kin_left(G, true);
    dv_right(G, l, -1.0);
    kin_right(G, false);
  }

  double local_action(i64 l, i64 i, const double* pi) const {
    i64 lp = (l % m) + 1, lm = ((l - 2 + m) % m) + 1;  // 1-based wrap
    const double* up = &phi[((lp - 1) * N + i) * 3];
    const double* dn = &phi[((lm - 1) * N + i) * 3];
    double tau_t = 0.0, grad = 0.0, p2 = 0.0;
    for (int o = 0; o < 3; ++o) {
      double du = pi[o] - up[o], dd = pi[o] - dn[o];
      tau_t += du * du + dd * dd;
      p2 += pi[o] * pi[o];
    }
    tau_t /= 2.0 * c * c * dtau * dtau;
    for (int d = 0; d < 4; ++d) {
      const double* pn = &phi[((l - 1) * N + nb[i * 4 + d]) * 3];
      for (int o = 0; o < 3; ++o) {
        double dd = pi[o] - pn[o];
        grad += dd * dd;
      }
    }
    grad *= 0.5;
    double pot = 0.5 * r * p2 + 0.25 * u * p2 * p2;
    return dtau * (tau_t + grad + pot);
  }

  i64 update_slice(i64 l) {
    i64 acc = 0;
    const i64 four = 4;
    const cd onec = 1.0, m1c = -1.0;
    std::vector<cd> Gcols(dim * 4), T4(4 * dim);
    for (i64 i = 0; i < N; ++i) {
      double* po = &phi[((l - 1) * N + i) * 3];
      double pn[3];
      for (int o = 0; o < 3; ++o) pn[o] = po[o] + box_w * (2.0 * u01(rng) - 1.0);
      double dS = local_action(l, i, pn) - local_action(l, i, po);
      cd En[4][4], Eoi[4][4], Delta[4][4], A[4][4];
      ev_block(pn, -1.0, En);
      ev_block(po, +1.0, Eoi);
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) {
          cd s_ = 0.0;
          for (int k = 0; k < 4; ++k) s_ += En[a][k] * Eoi[k][b];
          Delta[a][b] = s_ - ((a == b) ? 1.0 : 0.0);
        }
      i64 idx[4] = {i, N + i, 2 * N + i, 3 * N + i};
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) {
          cd s_ = 0.0;
          for (int k = 0; k < 4; ++k) {
            cd m_ = ((k == b) ? cd(1.0) : cd(0.0)) - G(idx[k], idx[b]);
            s_ += Delta[a][k] * m_;
          }
          A[a][b] = s_ + ((a == b) ? 1.0 : 0.0);
        }
      cd M4[4][4];
      std::memcpy(M4, Delta, sizeof(M4));
      cd R = lu4_det_solve(A, M4);  // A destroyed; M4 = A^{-1} Delta
      double w = std::abs(R) * std::exp(-dS);
      if (u01(rng) < w) {
        // Woodbury rank-4: G -= G[:,I] M4 (1 - G)[I,:]
        for (int b = 0; b < 4; ++b)
          for (i64 k = 0; k < dim; ++k) Gcols[k + b * dim] = G(k, idx[b]);
        for (i64 k = 0; k < dim; ++k)
          for (int a = 0; a < 4; ++a) {
            cd s_ = 0.0;
            for (int b = 0; b < 4; ++b) {
              cd rw = ((idx[b] == k) ? cd(1.0) : cd(0.0)) - G(idx[b], k);
              s_ += M4[a][b] * rw;
            }
            T4[a + k * 4] = s_;
          }
        scipy_zgemm_64_("N", "N", &dim, &dim, &four, &m1c, Gcols.data(),
                        &dim, T4.data(), &four, &onec, G.a.data(), &dim);
        for (int o = 0; o < 3; ++o) po[o] = pn[o];
        phase *= R / std::abs(R);
        ++acc;
      }
    }
    return acc;
  }

  void refactor(UDV& cur, Mat& lazy) {
    Mat C = lazy;
    for (i64 j = 0; j < dim; ++j)
      for (i64 i = 0; i < dim; ++i) C(i, j) *= cur.d[j];
    UDV f(dim);
    udv(C, f);
    Mat Vnew(dim);
    gemm(f.V, cur.V, Vnew);
    cur.U = f.U;
    cur.d = f.d;
    cur.V = Vnew;
    lazy = cur.U;
  }

  void rebuild_stacks() {  // right stack (daggered) from field; G = G(0)
    stack[K] = UDV(dim);
    UDV cur(dim);
    Mat lazy = cur.U;
    for (i64 k = K; k >= 1; --k) {
      for (i64 l = k * s; l > (k - 1) * s; --l) bH_mult_left(l, lazy);
      refactor(cur, lazy);
      stack[k - 1] = cur;
    }
    UDV eye(dim);
    green_pair(eye, stack[0], G);
  }

  double sweep_pair(i64* acc_total) {
    double dev = 0.0;
    Mat Gold(dim);
    // ---- up sweep: consume right stack, emit left_store
    UDV curL(dim);
    Mat lazyL = curL.U;
    for (i64 k = 1; k <= K; ++k) {
      for (i64 l = (k - 1) * s + 1; l <= k * s; ++l) {
        wrap_up(l);
        *acc_total += update_slice(l);
        b_mult_left(l, lazyL);
      }
      refactor(curL, lazyL);
      left_store[k] = curL;
      Gold = G;
      green_pair(curL, stack[k], G);
      for (i64 idx = 0; idx < dim * dim; ++idx)
        dev = std::max(dev, std::abs(Gold.a[idx] - G.a[idx]));
    }
    // ---- down sweep: consume left_store, emit right stack
    UDV curR(dim);
    Mat lazyR = curR.U;
    for (i64 k = K; k >= 1; --k) {
      for (i64 l = k * s; l >= (k - 1) * s + 1; --l) {
        *acc_total += update_slice(l);
        bH_mult_left(l, lazyR);
        wrap_down(l);
      }
      refactor(curR, lazyR);
      Gold = G;
      green_pair(left_store[k - 1], curR, G);
      for (i64 idx = 0; idx < dim * dim; ++idx)
        dev = std::max(dev, std::abs(Gold.a[idx] - G.a[idx]));
      stack[k - 1] = curR;
    }
    stack[K] = UDV(dim);
    return dev;
  }
};

// deterministic 64-bit LCG field for the Python parity selftest
static double lcg_u01(uint64_t& st) {
  st = st * 6364136223846793005ULL + 1442695040888963407ULL;
  return double(st >> 11) * (1.0 / 9007199254740992.0);
}

int main(int argc, char** argv) {
  if (argc > 1 && std::strcmp(argv[1], "selftest") == 0) {
    i64 L = atoll(argv[2]);
    double beta = atof(argv[3]);
    i64 m = atoll(argv[4]), s = atoll(argv[5]);
    Sim sim(L, beta, m, s, 0.5);
    uint64_t st = 42;
    for (i64 t = 0; t < m * sim.N * 3; ++t)
      sim.phi[t] = lcg_u01(st) - 0.5;
    sim.rebuild_stacks();
    FILE* f = fopen(argv[6], "wb");
    fwrite(sim.G.a.data(), sizeof(cd), sim.G.a.size(), f);
    fclose(f);
    printf("{\"selftest\": \"G written\", \"dim\": %lld}\n", sim.dim);
    return 0;
  }
  i64 L = argc > 1 ? atoll(argv[1]) : 4;
  double beta = argc > 2 ? atof(argv[2]) : 4.0;
  i64 m = argc > 3 ? atoll(argv[3]) : 40;
  i64 s = argc > 4 ? atoll(argv[4]) : 4;
  i64 n_pairs = argc > 5 ? atoll(argv[5]) : 5;
  double r = argc > 6 ? atof(argv[6]) : 0.5;

  Sim sim(L, beta, m, s, r);
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
  for (i64 i = 0; i < sim.dim; ++i) occ += 1.0 - std::real(sim.G(i, i));
  occ /= sim.N;
  printf(
      "{\"metric\": \"cpu_sdw_baseline_L%lld_beta%g_sweeps_per_sec\", "
      "\"value\": %.4f, \"unit\": \"sweeps/s\", \"green_dev\": %.3e, "
      "\"acc_rate\": %.3f, \"occupancy\": %.6f, \"phase_re\": %.6f}\n",
      L, beta, sweeps_per_sec, dev,
      double(acc) / (2.0 * n_pairs * sim.m * sim.N), occ,
      std::real(sim.phase));
  return 0;
}
