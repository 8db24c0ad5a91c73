// gtop_core: native host-side engine for the JAX trajectory framework.
//
// Role in the architecture: the device path (JAX/XLA) owns batched solving;
// this library owns the host side — low-latency single solves on CPU,
// oracle-grade double-precision verification, and fast fixture/EDT
// generation for data loading.  It re-implements the reference pipeline
// (EpicOne1/grad_traj_optimization) from its mathematical definition:
//
//  * exact 1-D squared EDT by the lower-envelope-of-parabolas method and
//    the separable z->y->x 3-D transform (reference src/sdf_map.cpp:266-368),
//    multithreaded across independent lines;
//  * trilinear distance/gradient sampling with the reference's
//    -resolution/2 offset and clamped corners (src/sdf_map.cpp:185-242);
//  * quintic Hermite seeding and the smoothness/collision penalty with
//    analytic gradient (src/grad_traj_optimizer.cpp:281-448), using the
//    same float32-stable unit-time kernel factorization as the JAX path
//    (core/poly.py) — no dense 6m x 6m inverses;
//  * the same deterministic projected adaptive gradient descent as
//    opt/descent.py (replacing the reference's NLopt back-end).
//
// C ABI only; Python binds via ctypes (grad_traj_optimization_tpu/native.py).

#include <sched.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr double kFreeDist = 10000.0;  // reference distance-buffer init
constexpr double kInf = std::numeric_limits<double>::infinity();

// ---------------------------------------------------------------------------
// Exact 1-D squared distance transform (lower envelope of parabolas).
// ---------------------------------------------------------------------------
void dt1d(const double* f, int n, double* d, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    double s;
    while (true) {
      s = ((f[q] + double(q) * q) - (f[v[k]] + double(v[k]) * v[k])) /
          (2.0 * q - 2.0 * v[k]);
      if (s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    d[q] = (double(q) - v[k]) * (double(q) - v[k]) + f[v[k]];
  }
}

void parallel_for(int n, const std::function<void(int, int)>& fn) {
  int nt = std::max(1u, std::thread::hardware_concurrency());
  // one thread per CPU this process may run on, not per CPU of the host
  cpu_set_t allowed;
  if (sched_getaffinity(0, sizeof(allowed), &allowed) == 0)
    nt = std::max(1, std::min(nt, CPU_COUNT(&allowed)));
  nt = std::min(nt, n > 0 ? n : 1);
  std::vector<std::thread> threads;
  int chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int lo = t * chunk;
    int hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

inline int64_t flat(int x, int y, int z, int ny, int nz) {
  return (int64_t(x) * ny + y) * nz + z;
}

}  // namespace

extern "C" {

// cfg-array ABI version of gtop_solve (bump when cfg fields are added
// or entry points change so stale .so files fail loudly)
int gtop_abi_version() { return 6; }

// Exact unsigned EDT of an occupancy grid (x-major layout, matching the
// reference's x*ny*nz + y*nz + z).  out in meters, min-capped at 10000.
void gtop_edt(const float* occ, int nx, int ny, int nz, float resolution,
              float* out) {
  const int64_t n = int64_t(nx) * ny * nz;
  std::vector<double> tmp1(n), tmp2(n);

  // pass 1 along z
  parallel_for(nx * ny, [&](int lo, int hi) {
    std::vector<double> f(nz), d(nz);
    std::vector<int> v(nz);
    std::vector<double> zb(nz + 1);
    for (int xy = lo; xy < hi; ++xy) {
      int x = xy / ny, y = xy % ny;
      for (int z = 0; z < nz; ++z)
        f[z] = occ[flat(x, y, z, ny, nz)] > 0.5f ? 0.0 : 1e30;
      dt1d(f.data(), nz, d.data(), v.data(), zb.data());
      for (int z = 0; z < nz; ++z) tmp1[flat(x, y, z, ny, nz)] = d[z];
    }
  });

  // pass 2 along y
  parallel_for(nx * nz, [&](int lo, int hi) {
    std::vector<double> f(ny), d(ny);
    std::vector<int> v(ny);
    std::vector<double> zb(ny + 1);
    for (int xz = lo; xz < hi; ++xz) {
      int x = xz / nz, z = xz % nz;
      for (int y = 0; y < ny; ++y) f[y] = tmp1[flat(x, y, z, ny, nz)];
      dt1d(f.data(), ny, d.data(), v.data(), zb.data());
      for (int y = 0; y < ny; ++y) tmp2[flat(x, y, z, ny, nz)] = d[y];
    }
  });

  // pass 3 along x, metric conversion + cap
  parallel_for(ny * nz, [&](int lo, int hi) {
    std::vector<double> f(nx), d(nx);
    std::vector<int> v(nx);
    std::vector<double> zb(nx + 1);
    for (int yz = lo; yz < hi; ++yz) {
      int y = yz / nz, z = yz % nz;
      for (int x = 0; x < nx; ++x) f[x] = tmp2[flat(x, y, z, ny, nz)];
      dt1d(f.data(), nx, d.data(), v.data(), zb.data());
      for (int x = 0; x < nx; ++x) {
        double dist = double(resolution) * std::sqrt(d[x]);
        out[flat(x, y, z, ny, nz)] = float(std::min(dist, kFreeDist));
      }
    }
  });
}

// Trilinear distance + gradient; out-of-map -> dist = -1, grad = 0.
void gtop_trilinear(const float* dist, int nx, int ny, int nz,
                    const float* origin, float resolution,
                    const float* queries, int n_queries, float* out_d,
                    float* out_g) {
  const double res = resolution;
  const double inv = 1.0 / res;
  auto get = [&](int x, int y, int z) -> double {
    x = std::clamp(x, 0, nx - 1);
    y = std::clamp(y, 0, ny - 1);
    z = std::clamp(z, 0, nz - 1);
    return dist[flat(x, y, z, ny, nz)];
  };
  parallel_for(n_queries, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      const float* q = queries + 3 * i;
      bool ok = true;
      for (int a = 0; a < 3; ++a) {
        double size = (a == 0 ? nx : a == 1 ? ny : nz) * res;
        if (!(q[a] > origin[a] + 1e-4 && q[a] < origin[a] + size - 1e-4))
          ok = false;
      }
      if (!ok) {
        out_d[i] = -1.0f;
        out_g[3 * i] = out_g[3 * i + 1] = out_g[3 * i + 2] = 0.0f;
        continue;
      }
      int idx[3];
      double diff[3];
      for (int a = 0; a < 3; ++a) {
        double pm = q[a] - 0.5 * res;
        idx[a] = int(std::floor((pm - origin[a]) * inv));
        double idx_pos = (idx[a] + 0.5) * res + origin[a];
        diff[a] = (q[a] - idx_pos) * inv;
      }
      double vals[2][2][2];
      for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b)
          for (int c = 0; c < 2; ++c)
            vals[a][b][c] = get(idx[0] + a, idx[1] + b, idx[2] + c);

      double v00 = (1 - diff[0]) * vals[0][0][0] + diff[0] * vals[1][0][0];
      double v01 = (1 - diff[0]) * vals[0][0][1] + diff[0] * vals[1][0][1];
      double v10 = (1 - diff[0]) * vals[0][1][0] + diff[0] * vals[1][1][0];
      double v11 = (1 - diff[0]) * vals[0][1][1] + diff[0] * vals[1][1][1];
      double v0 = (1 - diff[1]) * v00 + diff[1] * v10;
      double v1 = (1 - diff[1]) * v01 + diff[1] * v11;
      out_d[i] = float((1 - diff[2]) * v0 + diff[2] * v1);

      out_g[3 * i + 2] = float((v1 - v0) * inv);
      out_g[3 * i + 1] = float(
          ((1 - diff[2]) * (v10 - v00) + diff[2] * (v11 - v01)) * inv);
      double gx =
          (1 - diff[2]) * (1 - diff[1]) * (vals[1][0][0] - vals[0][0][0]) +
          (1 - diff[2]) * diff[1] * (vals[1][1][0] - vals[0][1][0]) +
          diff[2] * (1 - diff[1]) * (vals[1][0][1] - vals[0][0][1]) +
          diff[2] * diff[1] * (vals[1][1][1] - vals[0][1][1]);
      out_g[3 * i] = float(gx * inv);
    }
  });
}

// ---------------------------------------------------------------------------
// Penalty solver (double precision, deterministic).
// ---------------------------------------------------------------------------

namespace {

struct Mat {
  std::vector<double> a;
  int r = 0, c = 0;
  Mat() = default;
  Mat(int r_, int c_) : a(size_t(r_) * c_, 0.0), r(r_), c(c_) {}
  double& operator()(int i, int j) { return a[size_t(i) * c + j]; }
  double operator()(int i, int j) const { return a[size_t(i) * c + j]; }
};

// unit-time Hermite inverse & snap kernel (same factorization as poly.py)
void unit_kernels(double a1inv[6][6], double ksnap[6][6]) {
  double fact[6] = {1, 1, 2, 6, 24, 120};
  double a1[6][6] = {};
  for (int i = 0; i < 3; ++i) {
    a1[2 * i][i] = fact[i];
    for (int j = i; j < 6; ++j) a1[2 * i + 1][j] = fact[j] / fact[j - i];
  }
  // invert 6x6 by Gauss-Jordan
  double aug[6][12] = {};
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) aug[i][j] = a1[i][j];
    aug[i][6 + i] = 1.0;
  }
  for (int col = 0; col < 6; ++col) {
    int piv = col;
    for (int rr = col + 1; rr < 6; ++rr)
      if (std::fabs(aug[rr][col]) > std::fabs(aug[piv][col])) piv = rr;
    std::swap(aug[piv], aug[col]);
    double p = aug[col][col];
    for (int j = 0; j < 12; ++j) aug[col][j] /= p;
    for (int rr = 0; rr < 6; ++rr) {
      if (rr == col) continue;
      double fctr = aug[rr][col];
      for (int j = 0; j < 12; ++j) aug[rr][j] -= fctr * aug[col][j];
    }
  }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) a1inv[i][j] = aug[i][6 + j];

  double q1[6][6] = {};
  for (int i = 3; i < 6; ++i)
    for (int j = 3; j < 6; ++j)
      q1[i][j] = double(i * (i - 1) * (i - 2)) * j * (j - 1) * (j - 2) /
                 (i + j - 5);
  for (int r0 = 0; r0 < 6; ++r0)
    for (int c0 = 0; c0 < 6; ++c0) {
      double s = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j)
          s += a1inv[i][r0] * q1[i][j] * a1inv[j][c0];
      ksnap[r0][c0] = s;
    }
}

const int kOrd[6] = {0, 0, 1, 1, 2, 2};

struct Deps {
  int m = 0, ndp = 0, ndim = 0;
  Mat L;            // 6m x ndim
  Mat R;            // ndim x ndim
  std::vector<double> T;
};

int dmap_slot(int s, int i, int e, int m) {
  int w = s + e;
  if (w == 0) return i;
  if (w == m) return 3 + i;
  return 6 + 3 * (w - 1) + i;
}

Deps build_deps(const std::vector<double>& T) {
  double a1inv[6][6], ksnap[6][6];
  unit_kernels(a1inv, ksnap);
  Deps d;
  d.m = int(T.size());
  d.ndp = 3 * d.m - 3;
  d.ndim = 3 * d.m + 3;
  d.T = T;
  d.L = Mat(6 * d.m, d.ndim);
  d.R = Mat(d.ndim, d.ndim);
  for (int s = 0; s < d.m; ++s) {
    double ainv[6][6], msnap[6][6];
    for (int j = 0; j < 6; ++j)
      for (int r0 = 0; r0 < 6; ++r0)
        ainv[j][r0] = a1inv[j][r0] * std::pow(T[s], kOrd[r0] - j);
    for (int r0 = 0; r0 < 6; ++r0)
      for (int c0 = 0; c0 < 6; ++c0)
        msnap[r0][c0] =
            ksnap[r0][c0] * std::pow(T[s], kOrd[r0] + kOrd[c0] - 5);
    int slot[6];
    for (int i = 0; i < 3; ++i)
      for (int e = 0; e < 2; ++e) slot[2 * i + e] = dmap_slot(s, i, e, d.m);
    for (int j = 0; j < 6; ++j)
      for (int b = 0; b < 6; ++b) d.L(6 * s + j, slot[b]) += ainv[j][b];
    for (int p = 0; p < 6; ++p)
      for (int q = 0; q < 6; ++q)
        d.R(slot[p], slot[q]) += msnap[p][q];
  }
  return d;
}

struct SolveCfg {
  double ws, wc, alpha, d0, r, bos, vos, aos, mean_v, init_time;
  double lr0, lr_grow, lr_shrink, lr_min, lr_max;
  int n_samples, iters1, iters2, steps_mask;  // steps_mask: 1|2 bits
  double cost_eps, grad_eps, vel_eps, t_offset;
  int step_rule_bb;  // 1 = Barzilai-Borwein, 0 = multiplicative adaptive
  int accept_window;  // nonmonotone acceptance window (1 = monotone)
  int seed_mode;      // 0 = reference, 1 = min_snap, 2 = dual
  int dual_ms_iters;  // step-2 budget of the min-snap arm (0 = iters2)
  int dual_ms_window; // min-snap arm accept window (0 = accept_window)
  int polish_iters;   // dual post-race polish restart (0 = off)
  // velocity/acceleration penalties (grad_traj_optimizer.cpp:517-535;
  // usage :382-407, weights wv = wa = 1 fixed at :412); 0 disables
  double alpha_v, v0, r_v, alpha_a, a0, r_a;
};

// Gaussian elimination with partial pivoting: solve A x = b in place
// (A n x n row-major, overwritten).  n = 3m-3 stays tiny (< 100).
void solve_dense(std::vector<double>& A, std::vector<double>& b, int n) {
  for (int k = 0; k < n; ++k) {
    int piv = k;
    for (int i = k + 1; i < n; ++i)
      if (std::fabs(A[i * n + k]) > std::fabs(A[piv * n + k])) piv = i;
    if (piv != k) {
      for (int j = 0; j < n; ++j) std::swap(A[k * n + j], A[piv * n + j]);
      std::swap(b[k], b[piv]);
    }
    double d = A[k * n + k];
    if (std::fabs(d) < 1e-300) continue;
    for (int i = k + 1; i < n; ++i) {
      double f = A[i * n + k] / d;
      if (f == 0.0) continue;
      for (int j = k; j < n; ++j) A[i * n + j] -= f * A[k * n + j];
      b[i] -= f * b[k];
    }
  }
  for (int k = n - 1; k >= 0; --k) {
    double acc = b[k];
    for (int j = k + 1; j < n; ++j) acc -= A[k * n + j] * b[j];
    double d = A[k * n + k];
    b[k] = (std::fabs(d) < 1e-300) ? 0.0 : acc / d;
  }
}

struct MapRef {
  const float* dist;
  int nx, ny, nz;
  float origin[3];
  float res;
};

void trilinear_one(const MapRef& mp, const double* q, double* dd,
                   double* gg) {
  float qf[3] = {float(q[0]), float(q[1]), float(q[2])};
  float od, og[3];
  gtop_trilinear(mp.dist, mp.nx, mp.ny, mp.nz, mp.origin, mp.res, qf, 1,
                 &od, og);
  *dd = od;
  gg[0] = og[0];
  gg[1] = og[1];
  gg[2] = og[2];
}

// cost + gradient, reference formula (grad_traj_optimizer.cpp:281-448)
double cost_and_grad(const Deps& dp_deps, const MapRef& mp,
                     const SolveCfg& cfg, const double* Df /*3x6*/,
                     const double* dp /*3 x ndp*/, int step,
                     double* grad /*3 x ndp, may be null*/) {
  const int m = dp_deps.m, ndp = dp_deps.ndp, ndim = dp_deps.ndim;
  double ws = (step == 1) ? 0.0 : cfg.ws;
  double wc = cfg.wc;

  // d vectors per axis
  std::vector<double> d(3 * ndim);
  for (int ax = 0; ax < 3; ++ax) {
    for (int j = 0; j < 6; ++j) d[ax * ndim + j] = Df[ax * 6 + j];
    for (int j = 0; j < ndp; ++j) d[ax * ndim + 6 + j] = dp[ax * ndp + j];
  }

  double cost_smooth = 0.0;
  std::vector<double> g_smooth(3 * ndp, 0.0);
  for (int ax = 0; ax < 3; ++ax) {
    const double* dx = &d[ax * ndim];
    for (int i = 0; i < ndim; ++i) {
      double rd = 0;
      for (int j = 0; j < ndim; ++j) rd += dp_deps.R(i, j) * dx[j];
      cost_smooth += dx[i] * rd;
      if (i >= 6)
        g_smooth[ax * ndp + (i - 6)] = 2.0 * rd;  // 2 (R d)_p
    }
  }

  // coefficients: coe[s][ax][j] = sum_a L(6s+j, a) d[ax][a]
  std::vector<double> coe(size_t(m) * 3 * 6, 0.0);
  for (int s = 0; s < m; ++s)
    for (int ax = 0; ax < 3; ++ax)
      for (int j = 0; j < 6; ++j) {
        double acc = 0;
        for (int a = 0; a < ndim; ++a)
          acc += dp_deps.L(6 * s + j, a) * d[ax * ndim + a];
        coe[(size_t(s) * 3 + ax) * 6 + j] = acc;
      }

  double cost_colli = 0.0;
  double cost_vel = 0.0, cost_acc = 0.0;
  std::vector<double> g_colli(3 * ndp, 0.0);
  std::vector<double> g_va(3 * ndp, 0.0);
  // velocity/acceleration penalties: the reference's commented usage
  // block (grad_traj_optimizer.cpp:382-407) replicated loop-for-loop,
  // including its quirks: no sign(v)/sign(a) in the penalty gradients
  // (:517-535) and cv/ca carrying the LAST axis's value into the
  // gradient loop.  Step 2 only (:385); wv = wa = 1 (:412).
  const bool use_va =
      step == 2 && (cfg.alpha_v != 0.0 || cfg.alpha_a != 0.0);
  if (std::fabs(wc) >= 1e-4) {
    for (int s = 0; s < m; ++s) {
      double Ts = dp_deps.T[s];
      double dt = Ts / cfg.n_samples;
      for (int k = 0; k < cfg.n_samples; ++k) {
        double t = cfg.t_offset + k * dt;
        if (t >= Ts) break;
        double tv[6];
        tv[0] = 1;
        for (int j = 1; j < 6; ++j) tv[j] = tv[j - 1] * t;
        double vrow[6] = {0, 1, 2 * tv[1], 3 * tv[2], 4 * tv[3], 5 * tv[4]};
        double arow[6] = {0, 0, 2, 6 * tv[1], 12 * tv[2], 20 * tv[3]};

        double pos[3], vel[3], acc3[3];
        for (int ax = 0; ax < 3; ++ax) {
          const double* c = &coe[(size_t(s) * 3 + ax) * 6];
          double pv = 0, vv = 0, av = 0;
          for (int j = 0; j < 6; ++j) {
            pv += c[j] * tv[j];
            vv += c[j] * vrow[j];
            av += c[j] * arow[j];
          }
          pos[ax] = pv;
          vel[ax] = vv;
          acc3[ax] = av;
        }
        double vel_norm = std::sqrt(vel[0] * vel[0] + vel[1] * vel[1] +
                                    vel[2] * vel[2]) +
                          cfg.vel_eps;
        double dist, gradd[3];
        trilinear_one(mp, pos, &dist, gradd);
        double cd = cfg.alpha * std::exp(-(dist - cfg.d0) / cfg.r);
        double gd = -cd / cfg.r;
        cost_colli += cd * vel_norm * dt;

        double cv = 0.0, ca = 0.0;
        if (use_va) {
          for (int ax = 0; ax < 3; ++ax) {
            cv = cfg.alpha_v *
                 std::exp((std::fabs(vel[ax]) - cfg.v0) / cfg.r_v);
            cost_vel += cv * vel_norm * dt;
            ca = cfg.alpha_a *
                 std::exp((std::fabs(acc3[ax]) - cfg.a0) / cfg.r_a);
            cost_acc += ca * vel_norm * dt;
          }
        }
        if (grad) {
          // TL = tv * Ldp, TVL = vrow * Ldp rows (Ldp = L[6s.., 6:])
          for (int p = 0; p < ndp; ++p) {
            double TL = 0, TVL = 0, TAL = 0;
            for (int j = 0; j < 6; ++j) {
              TL += tv[j] * dp_deps.L(6 * s + j, 6 + p);
              TVL += vrow[j] * dp_deps.L(6 * s + j, 6 + p);
              TAL += arow[j] * dp_deps.L(6 * s + j, 6 + p);
            }
            for (int ax = 0; ax < 3; ++ax) {
              g_colli[ax * ndp + p] +=
                  (gd * gradd[ax] * cd * vel_norm * TL +
                   cd * (vel[ax] / vel_norm) * TVL) *
                  dt;
              if (use_va) {
                double gv = (cfg.alpha_v / cfg.r_v) *
                            std::exp((std::fabs(vel[ax]) - cfg.v0) /
                                     cfg.r_v);
                double ga = (cfg.alpha_a / cfg.r_a) *
                            std::exp((std::fabs(acc3[ax]) - cfg.a0) /
                                     cfg.r_a);
                g_va[ax * ndp + p] +=
                    (gv * vel_norm * TVL +
                     cv * (vel[ax] / vel_norm) * TVL + ga * vel_norm * TAL +
                     ca * (vel[ax] / vel_norm) * TVL) *
                    dt;
              }
            }
          }
        }
      }
    }
  }

  double cost = ws * cost_smooth + wc * cost_colli + cost_vel + cost_acc +
                cfg.cost_eps;
  if (grad) {
    for (int i = 0; i < 3 * ndp; ++i)
      grad[i] = ws * g_smooth[i] + wc * g_colli[i] + g_va[i] +
                cfg.grad_eps;
  }
  return cost;
}

}  // namespace

// Full deterministic solve.  waypoints: (m+1) x 3 row-major.  Returns the
// final cost; writes coeff (m x 3 x 6 ascending powers) and seg times.
double gtop_solve(const float* dist, int nx, int ny, int nz,
                  const float* origin, float resolution,
                  const double* waypoints, int n_waypoints,
                  const double* cfg_arr, double* out_coeff,
                  double* out_times) {
  SolveCfg cfg;
  const double* c = cfg_arr;
  cfg.ws = c[0]; cfg.wc = c[1]; cfg.alpha = c[2]; cfg.d0 = c[3];
  cfg.r = c[4]; cfg.bos = c[5]; cfg.vos = c[6]; cfg.aos = c[7];
  cfg.mean_v = c[8]; cfg.init_time = c[9]; cfg.lr0 = c[10];
  cfg.lr_grow = c[11]; cfg.lr_shrink = c[12]; cfg.lr_min = c[13];
  cfg.lr_max = c[14]; cfg.n_samples = int(c[15]); cfg.iters1 = int(c[16]);
  cfg.iters2 = int(c[17]); cfg.steps_mask = int(c[18]);
  cfg.cost_eps = c[19]; cfg.grad_eps = c[20]; cfg.vel_eps = c[21];
  cfg.t_offset = c[22]; cfg.step_rule_bb = int(c[23]);
  cfg.accept_window = std::max(1, int(c[24]));
  cfg.seed_mode = int(c[25]);
  cfg.dual_ms_iters = int(c[26]);
  cfg.alpha_v = c[27]; cfg.v0 = c[28]; cfg.r_v = c[29];
  cfg.alpha_a = c[30]; cfg.a0 = c[31]; cfg.r_a = c[32];
  cfg.polish_iters = int(c[33]);
  cfg.dual_ms_window = int(c[34]);

  MapRef mp{dist, nx, ny, nz, {origin[0], origin[1], origin[2]},
            resolution};

  const int m = n_waypoints - 1;
  std::vector<double> T(m);
  for (int i = 0; i < m; ++i) {
    double len = 0;
    for (int a = 0; a < 3; ++a) {
      double dd = waypoints[3 * i + a] - waypoints[3 * (i + 1) + a];
      len += dd * dd;
    }
    T[i] = std::sqrt(len) / cfg.mean_v + (i == 0 ? cfg.init_time : 0.0);
  }
  Deps deps = build_deps(T);
  const int ndp = deps.ndp;

  double Df[18] = {};
  for (int ax = 0; ax < 3; ++ax) {
    Df[ax * 6 + 0] = waypoints[ax];
    Df[ax * 6 + 3] = waypoints[3 * m + ax];
  }
  std::vector<double> dpv(3 * size_t(std::max(ndp, 1)), 0.0);
  for (int w = 1; w < m; ++w)
    for (int ax = 0; ax < 3; ++ax)
      dpv[ax * ndp + 3 * (w - 1)] = waypoints[3 * w + ax];

  // bounds
  std::vector<double> lb(3 * size_t(std::max(ndp, 1))),
      ub(3 * size_t(std::max(ndp, 1)));
  for (int i = 0; i < ndp; ++i) {
    for (int ax = 0; ax < 3; ++ax) {
      if (i % 3 == 0) {
        double wpt = waypoints[3 * (i / 3 + 1) + ax];
        lb[ax * ndp + i] = wpt - cfg.bos;
        ub[ax * ndp + i] = wpt + cfg.bos;
      } else if (i % 3 == 1) {
        lb[ax * ndp + i] = -cfg.vos;
        ub[ax * ndp + i] = cfg.vos;
      } else {
        lb[ax * ndp + i] = -cfg.aos;
        ub[ax * ndp + i] = cfg.aos;
      }
    }
  }
  auto clip = [&](std::vector<double>& v) {
    for (int i = 0; i < 3 * ndp; ++i)
      v[i] = std::clamp(v[i], lb[i], ub[i]);
  };

  // min-snap seed: dp* = -Rpp^-1 Rfp^T df per axis (core/qp.min_snap_dp)
  auto minsnap_seed = [&]() {
    std::vector<double> dp(3 * size_t(std::max(ndp, 1)), 0.0);
    for (int ax = 0; ax < 3 && ndp > 0; ++ax) {
      std::vector<double> A(size_t(ndp) * ndp);
      std::vector<double> b(size_t(ndp), 0.0);
      for (int i = 0; i < ndp; ++i)
        for (int j = 0; j < ndp; ++j)
          A[size_t(i) * ndp + j] = deps.R(6 + i, 6 + j);
      for (int p = 0; p < ndp; ++p) {
        double acc = 0;
        for (int f = 0; f < 6; ++f) acc += deps.R(f, 6 + p) * Df[ax * 6 + f];
        b[size_t(p)] = -acc;
      }
      solve_dense(A, b, ndp);
      for (int p = 0; p < ndp; ++p) dp[size_t(ax) * ndp + p] = b[size_t(p)];
    }
    return dp;
  };

  // the full multi-phase descent from one seed (iters2 parameterized so
  // the dual min-snap arm can run a shorter step-2 budget)
  auto run_schedule = [&](std::vector<double> dpv, int iters2_budget,
                          int steps_mask, int w_override = 0) {
    if (ndp > 0) clip(dpv);
    double final_cost = 0.0;
    for (int step : {1, 2}) {
    if (!(steps_mask & step)) continue;
    int iters = (step == 1) ? cfg.iters1 : iters2_budget;
    if (ndp == 0) {
      final_cost = cost_and_grad(deps, mp, cfg, Df, dpv.data(), step,
                                 nullptr);
      continue;
    }
    // fused scheme (mirrors opt/descent.py): one cost+grad evaluation per
    // iteration, gradient cached across rejected steps; step size follows
    // the configured rule (Barzilai-Borwein spectral or multiplicative).
    // Acceptance compares against the max of the last accept_window
    // accepted costs (1 = strict monotone); the best iterate is carried
    // separately and returned.
    std::vector<double> g(3 * ndp), g2(3 * ndp), cand(3 * ndp);
    double cost =
        cost_and_grad(deps, mp, cfg, Df, dpv.data(), step, g.data());
    bool use_bb = cfg.step_rule_bb != 0;
    double gn0 = 0;
    for (double x : g) gn0 += x * x;
    gn0 = std::sqrt(gn0) + 1e-12;
    double lr = use_bb ? cfg.lr0 / gn0 : cfg.lr0;
    double scale = 1.0;
    const int W = w_override > 0 ? w_override : cfg.accept_window;
    std::vector<double> hist(size_t(W), cost);
    int ptr = 0;
    double best_c = cost;
    std::vector<double> best_dp = dpv;
    for (int it = 0; it < iters; ++it) {
      double stepsz;
      if (use_bb) {
        stepsz = lr * scale;
      } else {
        double gn = 0;
        for (double x : g) gn += x * x;
        gn = std::sqrt(gn) + 1e-12;
        stepsz = lr / gn;
      }
      for (int i = 0; i < 3 * ndp; ++i)
        cand[i] = std::clamp(dpv[i] - stepsz * g[i], lb[i], ub[i]);
      double c2 =
          cost_and_grad(deps, mp, cfg, Df, cand.data(), step, g2.data());
      double ref = *std::max_element(hist.begin(), hist.end());
      bool accept = c2 < ref;
      if (use_bb) {
        if (accept) {
          double sy = 0, yy = 0;
          for (int i = 0; i < 3 * ndp; ++i) {
            double s = cand[i] - dpv[i];
            double y = g2[i] - g[i];
            sy += s * y;
            yy += y * y;
          }
          lr = std::clamp(std::fabs(sy) / std::max(yy, 1e-20), cfg.lr_min,
                          cfg.lr_max);
          scale = 1.0;
        } else {
          scale = std::max(scale * cfg.lr_shrink, 1e-8);
        }
      } else {
        if (accept) {
          lr = std::min(lr * cfg.lr_grow, cfg.lr_max);
        } else {
          lr = std::max(lr * cfg.lr_shrink, cfg.lr_min);
        }
      }
      if (c2 < best_c) {
        best_c = c2;
        best_dp = cand;
      }
      if (accept) {
        hist[size_t(ptr)] = c2;
        ptr = (ptr + 1) % W;
        dpv.swap(cand);
        g.swap(g2);
        cost = c2;
      }
    }
    dpv = best_dp;
    final_cost = best_c;
    }
    return std::make_pair(final_cost, dpv);
  };

  double final_cost;
  if (cfg.seed_mode == 1) {
    auto r = run_schedule(minsnap_seed(), cfg.iters2, cfg.steps_mask);
    final_cost = r.first;
    dpv = std::move(r.second);
  } else if (cfg.seed_mode == 2) {
    // dual: race both seeds, keep the better arm (solver._combine_dual)
    int it_ms = cfg.dual_ms_iters > 0 ? cfg.dual_ms_iters : cfg.iters2;
    auto ra = run_schedule(dpv, cfg.iters2, cfg.steps_mask);
    auto rb = run_schedule(minsnap_seed(), it_ms, cfg.steps_mask,
                           cfg.dual_ms_window);
    bool a_ok = std::isfinite(ra.first);
    bool b_ok = std::isfinite(rb.first);
    if (b_ok && (!a_ok || rb.first < ra.first)) {
      final_cost = rb.first;
      dpv = std::move(rb.second);
    } else {
      final_cost = ra.first;
      dpv = std::move(ra.second);
    }
    if (cfg.polish_iters > 0) {
      // post-race polish restart from the winner (step 2 only; fresh
      // BB state — mirrors solver._merge_polish / golden optimize())
      auto rp = run_schedule(dpv, cfg.polish_iters, 2);
      if (std::isfinite(rp.first) && rp.first < final_cost) {
        final_cost = rp.first;
        dpv = std::move(rp.second);
      }
    }
  } else {
    auto r = run_schedule(dpv, cfg.iters2, cfg.steps_mask);
    final_cost = r.first;
    dpv = std::move(r.second);
  }

  // coefficients out
  std::vector<double> d(3 * size_t(deps.ndim));
  for (int ax = 0; ax < 3; ++ax) {
    for (int j = 0; j < 6; ++j) d[ax * deps.ndim + j] = Df[ax * 6 + j];
    for (int j = 0; j < ndp; ++j)
      d[ax * deps.ndim + 6 + j] = dpv[ax * ndp + j];
  }
  for (int s = 0; s < m; ++s)
    for (int ax = 0; ax < 3; ++ax)
      for (int j = 0; j < 6; ++j) {
        double acc = 0;
        for (int a = 0; a < deps.ndim; ++a)
          acc += deps.L(6 * s + j, a) * d[ax * deps.ndim + a];
        out_coeff[(size_t(s) * 3 + ax) * 6 + j] = acc;
      }
  for (int s = 0; s < m; ++s) out_times[s] = T[s];
  return final_cost;
}

// Threaded batch solve: `batch` waypoint sets against per-scenario
// grids (n_grids == batch) or ONE shared grid (n_grids == 1 — the
// reference's own one-map-many-queries shape, opti_node.cpp:60-97).
// gtop_solve is reentrant (no file-scope state — deliberately unlike
// the reference's TrajectoryGenerator, SURVEY.md quirk 6), so scenarios
// simply fan out over hardware threads.  Layouts: waypoints
// (batch, n_wp, 3); out_coeff (batch, m, 3, 6); out_times (batch, m);
// out_costs (batch).
void gtop_solve_batch(const float* dist, int n_grids, int nx, int ny,
                      int nz, const float* origin, float resolution,
                      const double* waypoints, int n_wp, int batch,
                      const double* cfg_arr, double* out_coeff,
                      double* out_times, double* out_costs) {
  const int m = n_wp - 1;
  const int64_t nvox = int64_t(nx) * ny * nz;
  parallel_for(batch, [&](int lo, int hi) {
    for (int b = lo; b < hi; ++b) {
      const float* dist_b = dist + (n_grids == 1 ? 0 : int64_t(b) * nvox);
      out_costs[b] = gtop_solve(
          dist_b, nx, ny, nz, origin, resolution,
          waypoints + int64_t(b) * n_wp * 3, n_wp, cfg_arr,
          out_coeff + int64_t(b) * m * 3 * 6,
          out_times + int64_t(b) * m);
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact kinodynamic A* (host-side front-end, reference algorithm).
// ---------------------------------------------------------------------------
//
// Faithful re-implementation of the reference KinodynamicAstar search
// (kinodynamic_astar.cpp:17-315): priority-queue A* over (position,
// velocity) states with acceleration primitives (5^3 inputs, z-halved),
// voxel-hash dedup, Pontryagin heuristic via exact quartic roots, and a
// cubic one-shot to the goal.  The device path uses a batched beam variant
// (search/kinodynamic.py); this exact version serves host-side seeding
// and parity checks of the beam's output quality.

#include <map>
#include <queue>
#include <unordered_map>

namespace {

struct KNode {
  double state[6];
  double g = 0, f = 0;
  double time = 0;
  int parent = -1;
  double u[3] = {0, 0, 0};
  double tau = 0;
};

void k_transit(const double* s0, const double* u, double tau, double* s1) {
  for (int a = 0; a < 3; ++a) {
    s1[a] = s0[a] + s0[3 + a] * tau + 0.5 * u[a] * tau * tau;
    s1[3 + a] = s0[3 + a] + u[a] * tau;
  }
}

int cubic_real(double a, double b, double c, double d, double* out) {
  double a2 = b / a, a1 = c / a, a0 = d / a;
  double Q = (3 * a1 - a2 * a2) / 9.0;
  double R = (9 * a1 * a2 - 27 * a0 - 2 * a2 * a2 * a2) / 54.0;
  double D = Q * Q * Q + R * R;
  if (D > 0) {
    double S = std::cbrt(R + std::sqrt(D));
    double T = std::cbrt(R - std::sqrt(D));
    out[0] = -a2 / 3 + S + T;
    return 1;
  }
  double theta = std::acos(std::clamp(
      R / std::sqrt(std::max(-(Q * Q * Q), 1e-300)), -1.0, 1.0));
  double sq = 2 * std::sqrt(std::max(-Q, 0.0));
  out[0] = sq * std::cos(theta / 3) - a2 / 3;
  out[1] = sq * std::cos((theta + 2 * M_PI) / 3) - a2 / 3;
  out[2] = sq * std::cos((theta + 4 * M_PI) / 3) - a2 / 3;
  return 3;
}

int quartic_real(double a, double b, double c, double d, double e,
                 double* out) {
  double a3 = b / a, a2 = c / a, a1 = d / a, a0 = e / a;
  double ys[3];
  cubic_real(1, -a2, a1 * a3 - 4 * a0, 4 * a2 * a0 - a1 * a1 - a3 * a3 * a0,
             ys);
  double y1 = ys[0];
  double r = a3 * a3 / 4 - a2 + y1;
  if (r < 0) return 0;
  double R = std::sqrt(r);
  double Dq, Eq;
  if (R != 0) {
    Dq = 0.75 * a3 * a3 - R * R - 2 * a2 +
         0.25 * (4 * a3 * a2 - 8 * a1 - a3 * a3 * a3) / R;
    Eq = 0.75 * a3 * a3 - R * R - 2 * a2 -
         0.25 * (4 * a3 * a2 - 8 * a1 - a3 * a3 * a3) / R;
  } else {
    double inner = std::sqrt(std::max(y1 * y1 - 4 * a0, 0.0));
    Dq = 0.75 * a3 * a3 - 2 * a2 + 2 * inner;
    Eq = 0.75 * a3 * a3 - 2 * a2 - 2 * inner;
  }
  int n = 0;
  if (Dq >= 0) {
    double Dv = std::sqrt(Dq);
    out[n++] = -a3 / 4 + R / 2 + Dv / 2;
    out[n++] = -a3 / 4 + R / 2 - Dv / 2;
  }
  if (Eq >= 0) {
    double Ev = std::sqrt(Eq);
    out[n++] = -a3 / 4 - R / 2 + Ev / 2;
    out[n++] = -a3 / 4 - R / 2 - Ev / 2;
  }
  return n;
}

double k_heuristic(const double* x1, const double* x2, double w_time,
                   double max_vel, double* opt_time) {
  double dp[3] = {x2[0] - x1[0], x2[1] - x1[1], x2[2] - x1[2]};
  const double* v0 = x1 + 3;
  const double* v1 = x2 + 3;
  double dpdp = dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2];
  double c1 = -36 * dpdp;
  double c2 = 0, c3 = 0;
  for (int a = 0; a < 3; ++a) {
    c2 += 24 * (v0[a] + v1[a]) * dp[a];
    c3 += -4 * (v0[a] * v0[a] + v0[a] * v1[a] + v1[a] * v1[a]);
  }
  double roots[5];
  int n = quartic_real(w_time, 0, c3, c2, c1, roots);
  double t_bar =
      std::max({std::fabs(dp[0]), std::fabs(dp[1]), std::fabs(dp[2])}) /
      max_vel;
  roots[n++] = t_bar;
  double best = 1e17, t_d = t_bar;
  for (int i = 0; i < n; ++i) {
    double t = roots[i];
    if (!(t >= t_bar) || !std::isfinite(t)) continue;
    double c = -c1 / (3 * t * t * t) - c2 / (2 * t * t) - c3 / t +
               w_time * t;
    if (c < best) {
      best = c;
      t_d = t;
    }
  }
  *opt_time = t_d;
  return (1.0 + 1.0 / 10000.0) * best;
}

double k_dist_at(const float* dist, int nx, int ny, int nz,
                 const float* origin, float res, const double* p) {
  int ix = int(std::floor((p[0] - origin[0]) / res));
  int iy = int(std::floor((p[1] - origin[1]) / res));
  int iz = int(std::floor((p[2] - origin[2]) / res));
  if (ix < 0 || ix >= nx || iy < 0 || iy >= ny || iz < 0 || iz >= nz)
    return -1.0;
  return dist[flat(ix, iy, iz, ny, nz)];
}

bool k_shot_ok(const float* dist, int nx, int ny, int nz,
               const float* origin, float res, const double* s1,
               const double* s2, double t_d, double margin) {
  double dp[3], dv[3];
  for (int a = 0; a < 3; ++a) {
    dp[a] = s2[a] - s1[a];
    dv[a] = s2[3 + a] - s1[3 + a];
  }
  double ca[3], cb[3];
  for (int a = 0; a < 3; ++a) {
    ca[a] = (1.0 / 6.0) * (-12.0 / (t_d * t_d * t_d) * (dp[a] - s1[3 + a] * t_d) +
                           6.0 / (t_d * t_d) * dv[a]);
    cb[a] = 0.5 * (6.0 / (t_d * t_d) * (dp[a] - s1[3 + a] * t_d) -
                   2.0 / t_d * dv[a]);
  }
  for (int k = 1; k <= 10; ++k) {
    double t = t_d * k / 10.0;
    double p[3];
    for (int a = 0; a < 3; ++a)
      p[a] = s1[a] + s1[3 + a] * t + cb[a] * t * t + ca[a] * t * t * t;
    if (k_dist_at(dist, nx, ny, nz, origin, res, p) <= margin) return false;
  }
  return true;
}

}  // namespace

// Exact kinodynamic A*.  cfg: [max_acc, max_vel, max_tau, w_time,
// lambda_heu, margin, max_nodes, goal_r].  Outputs knot states of the
// best branch: out_knots (max_knots x 9: pos, vel, acc) and
// out_times (max_knots).  Returns number of knots (including the goal
// knot when the one-shot succeeded) or 0 if no path.
extern "C" int gtop_kino_search(const float* dist, int nx, int ny, int nz,
                     const float* origin, float resolution,
                     const double* start, const double* goal,
                     const double* cfg, double* out_knots,
                     double* out_times, int max_knots) {
  const double max_acc = cfg[0], max_vel = cfg[1], max_tau = cfg[2];
  const double w_time = cfg[3], lambda_heu = cfg[4], margin = cfg[5];
  const int max_nodes = int(cfg[6]);
  const double goal_r = cfg[7];
  const int check_num = 5;

  std::vector<KNode> nodes;
  nodes.reserve(max_nodes + 8);
  // open set: (f, node index); voxel hash -> best node index
  std::priority_queue<std::pair<double, int>,
                      std::vector<std::pair<double, int>>,
                      std::greater<>> open;
  std::unordered_map<int64_t, int> table;

  auto vox_key = [&](const double* p) -> int64_t {
    int ix = int(std::floor((p[0] - origin[0]) / resolution));
    int iy = int(std::floor((p[1] - origin[1]) / resolution));
    int iz = int(std::floor((p[2] - origin[2]) / resolution));
    return (int64_t(ix) * ny + iy) * nz + iz;
  };

  KNode s;
  std::memcpy(s.state, start, 6 * sizeof(double));
  double t_opt;
  s.f = lambda_heu * k_heuristic(start, goal, w_time, max_vel, &t_opt);
  nodes.push_back(s);
  open.push({s.f, 0});
  table[vox_key(start)] = 0;

  int best_leaf = -1;
  double best_total = 1e18;
  std::vector<double> accs;
  for (int i = -2; i <= 2; ++i) accs.push_back(max_acc * i / 2.0);

  while (!open.empty() && int(nodes.size()) < max_nodes) {
    auto [f_pop, cur] = open.top();
    open.pop();
    if (f_pop > nodes[cur].f + 1e-9) continue;  // stale entry

    // one-shot attempt near the goal
    double dg = 0;
    for (int a = 0; a < 3; ++a) {
      double dd = nodes[cur].state[a] - goal[a];
      dg += dd * dd;
    }
    if (std::sqrt(dg) < goal_r) {
      double t_shot;
      k_heuristic(nodes[cur].state, goal, w_time, max_vel, &t_shot);
      t_shot = std::max(t_shot, 1e-2);
      if (k_shot_ok(dist, nx, ny, nz, origin, resolution,
                    nodes[cur].state, goal, t_shot, margin)) {
        best_leaf = cur;
        best_total = nodes[cur].g;
        break;
      }
    }

    for (double ax : accs)
      for (double ay : accs)
        for (double az : accs) {
          double u[3] = {ax, ay, 0.5 * az};  // z halved, as reference
          double tau = max_tau;
          double nstate[6];
          k_transit(nodes[cur].state, u, tau, nstate);

          // bounds & velocity feasibility
          bool ok = true;
          for (int a = 0; a < 3 && ok; ++a) {
            double lo = origin[a];
            double size = (a == 0 ? nx : a == 1 ? ny : nz) * resolution;
            if (nstate[a] <= lo + 1e-3 || nstate[a] >= lo + size - 1e-3)
              ok = false;
            if (std::fabs(nstate[3 + a]) > max_vel) ok = false;
          }
          if (!ok) continue;
          // same-voxel prune
          if (vox_key(nstate) == vox_key(nodes[cur].state)) continue;
          // collision sweep
          for (int k = 1; k <= check_num && ok; ++k) {
            double xt[6];
            k_transit(nodes[cur].state, u, tau * k / check_num, xt);
            if (k_dist_at(dist, nx, ny, nz, origin, resolution, xt) <=
                margin)
              ok = false;
          }
          if (!ok) continue;

          double g2 = nodes[cur].g +
                      (u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + w_time) *
                          tau;
          double h2 =
              lambda_heu *
              k_heuristic(nstate, goal, w_time, max_vel, &t_opt);
          double f2 = g2 + h2;

          int64_t key = vox_key(nstate);
          auto it = table.find(key);
          if (it != table.end()) {
            if (f2 >= nodes[it->second].f) continue;
            // better path into this voxel: update node
            KNode& nd = nodes[it->second];
            std::memcpy(nd.state, nstate, 6 * sizeof(double));
            nd.g = g2;
            nd.f = f2;
            nd.parent = cur;
            std::memcpy(nd.u, u, 3 * sizeof(double));
            nd.tau = tau;
            nd.time = nodes[cur].time + tau;
            open.push({f2, it->second});
          } else {
            KNode nd;
            std::memcpy(nd.state, nstate, 6 * sizeof(double));
            nd.g = g2;
            nd.f = f2;
            nd.parent = cur;
            std::memcpy(nd.u, u, 3 * sizeof(double));
            nd.tau = tau;
            nd.time = nodes[cur].time + tau;
            nodes.push_back(nd);
            table[key] = int(nodes.size()) - 1;
            open.push({f2, int(nodes.size()) - 1});
          }
        }
  }

  if (best_leaf < 0) return 0;

  // backtrack
  std::vector<int> chain;
  for (int i = best_leaf; i >= 0; i = nodes[i].parent) chain.push_back(i);
  std::reverse(chain.begin(), chain.end());
  int n = int(chain.size());
  int extra = 1;  // goal knot
  int total = std::min(n + extra, max_knots);
  int skip = n + extra - total;  // drop oldest if over capacity
  int w = 0;
  for (int i = skip; i < n; ++i, ++w) {
    const KNode& nd = nodes[chain[i]];
    for (int a = 0; a < 3; ++a) {
      out_knots[9 * w + a] = nd.state[a];
      out_knots[9 * w + 3 + a] = nd.state[3 + a];
      out_knots[9 * w + 6 + a] = nd.u[a];
    }
    out_times[w] = (i + 1 < n) ? nodes[chain[i + 1]].tau : 0.0;
  }
  // final knot: goal with one-shot duration
  double t_shot;
  k_heuristic(nodes[best_leaf].state, goal, w_time, max_vel, &t_shot);
  t_shot = std::max(t_shot, 1e-2);
  if (w > 0) out_times[w - 1] = t_shot;
  for (int a = 0; a < 3; ++a) {
    out_knots[9 * w + a] = goal[a];
    out_knots[9 * w + 3 + a] = goal[3 + a];
    out_knots[9 * w + 6 + a] = 0.0;
  }
  out_times[w] = 0.0;
  return w + 1;
}

// ---------------------------------------------------------------------------
// Exact hybrid A* (host reference): the compare2 front-end.
//
// Port of the reference HybridAStarPathFinder::searchPath
// (hybrid_astar.cpp:219-446) with its expansion (getNeighbor :521-714,
// getNeighborInit :1377-1447), Pontryagin heuristic (:778-814, its
// tie_breaker = 1.0001 makes the factor (1+tie_breaker) = 2.0001 —
// twice the kino variant's 1.0001), geometric heuristic options
// (:148-186, available but unwired in the reference's active flow),
// and the fixed-end-velocity cubic one-shot shotHeu (:1023-1101).
// Structure is our own: a voxel-hash node store + std::multimap open
// list instead of the reference's dense GridNodePtr*** grid (identical
// semantics — untouched voxels are "new").
// ---------------------------------------------------------------------------

namespace {

struct HNode {
  double state[6];
  double g = 0, f = 0;
  double opt_time = 0;   // Pontryagin optimal time toward the goal
  double dur = 0;        // duration of the edge INTO this node
  double input[3] = {0, 0, 0};
  int64_t came = -1;     // parent voxel key (-1 = root)
  int id = 0;            // 0 new, 1 open, -1 closed
  std::multimap<double, int64_t>::iterator it;
};

// raw Pontryagin minimum cost (shared by both A* variants; the callers
// apply their own tie-breaker factor)
double pontryagin_cost(const double* x1, const double* x2, double w_time,
                       double max_vel, double* opt_time) {
  double dp[3] = {x2[0] - x1[0], x2[1] - x1[1], x2[2] - x1[2]};
  const double* v0 = x1 + 3;
  const double* v1 = x2 + 3;
  double dpdp = dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2];
  double c1 = -36 * dpdp;
  double c2 = 0, c3 = 0;
  for (int a = 0; a < 3; ++a) {
    c2 += 24 * (v0[a] + v1[a]) * dp[a];
    c3 += -4 * (v0[a] * v0[a] + v0[a] * v1[a] + v1[a] * v1[a]);
  }
  double roots[5];
  int n = quartic_real(w_time, 0, c3, c2, c1, roots);
  double t_bar =
      std::max({std::fabs(dp[0]), std::fabs(dp[1]), std::fabs(dp[2])}) /
      max_vel;
  roots[n++] = t_bar;
  double best = 1e17, t_d = t_bar;
  for (int i = 0; i < n; ++i) {
    double t = roots[i];
    if (!(t >= t_bar) || !std::isfinite(t)) continue;
    double c = -c1 / (3 * t * t * t) - c2 / (2 * t * t) - c3 / t +
               w_time * t;
    if (c < best) {
      best = c;
      t_d = t;
    }
  }
  *opt_time = t_d;
  return best;
}

// hybrid_astar.cpp:148-186 — index-space geometric heuristics
double h_geom_heu(int mode, const int* i1, const int* i2) {
  double dx = std::abs(i1[0] - i2[0]);
  double dy = std::abs(i1[1] - i2[1]);
  double dz = std::abs(i1[2] - i2[2]);
  if (mode == 2) return dx + dy + dz;                       // Manhattan
  if (mode == 3) return std::sqrt(dx * dx + dy * dy + dz * dz);  // Euclid
  // diagonal (the reference getHeu default)
  double diag = std::min({dx, dy, dz});
  dx -= diag;
  dy -= diag;
  dz -= diag;
  double h = 0.0;
  if (dx == 0)
    h = std::sqrt(3.0) * diag + std::sqrt(2.0) * std::min(dy, dz) +
        std::fabs(dy - dz);
  if (dy == 0)
    h = std::sqrt(3.0) * diag + std::sqrt(2.0) * std::min(dx, dz) +
        std::fabs(dx - dz);
  if (dz == 0)
    h = std::sqrt(3.0) * diag + std::sqrt(2.0) * std::min(dx, dy) +
        std::fabs(dx - dy);
  return h;
}

// Free-end-velocity minimum-acceleration cubic shot
// (HybridAStarPathFinder::getOptimalTime / getShotTrajectory,
// hybrid_astar.cpp:902-967).  The optimal duration minimizes the
// acceleration integral 3 ||v0 T - dp||^2 / T^3 over the positive roots
// of its derivative quadratic 3 v0.v0 T^2 - 12 dp.v0 T + 9 dp.dp, then
// stretches per axis so the implied end velocity stays within
// (2.5/3) max_vel (ve evaluated ONCE from the pre-stretch T, :942-948).
// The reference leaves two cases UB (a == 0 quadratic divides by zero;
// opti_time uninitialized when no positive root exists); both are
// defined here exactly as in the JAX port (search/kinodynamic.py
// free_end_vel_shot): linear root when a ~ 0, fallback T = 1.
void free_shot(const double* p0, const double* p1, const double* v0,
               double max_vel, double* coef /*(3,4) asc powers*/,
               double* T_out, double* v1_out) {
  double dp[3];
  for (int a = 0; a < 3; ++a) dp[a] = p1[a] - p0[a];
  double A = 0, Bq = 0, Cq = 0;
  for (int a = 0; a < 3; ++a) {
    A += 3.0 * v0[a] * v0[a];
    Bq += -12.0 * dp[a] * v0[a];
    Cq += 9.0 * dp[a] * dp[a];
  }
  double roots[3];
  int nr = 0;
  if (std::fabs(A) > 1e-12) {
    double disc = Bq * Bq - 4 * A * Cq;
    if (disc >= 0) {
      double sq = std::sqrt(disc);
      roots[nr++] = (-Bq + sq) / (2 * A);
      roots[nr++] = (-Bq - sq) / (2 * A);
    }
  } else if (std::fabs(Bq) > 1e-12) {
    roots[nr++] = -Cq / Bq;
  }
  double T = kInf, best = kInf;
  for (int i = 0; i < nr; ++i) {
    if (!(roots[i] > 0)) continue;
    double t = roots[i];
    double td = std::max(t, 1e-9);
    double c = 0;
    for (int a = 0; a < 3; ++a) {
      double r = v0[a] * t - dp[a];
      c += r * r;
    }
    c = 3.0 * c / (td * td * td);
    if (c < best) {
      best = c;
      T = t;
    }
  }
  if (!std::isfinite(T)) T = 1.0;  // degenerate dp = 0 (JAX-port fallback)
  // per-axis end-velocity feasibility stretch, ve from the PRE-stretch T
  double ve[3];
  for (int a = 0; a < 3; ++a)
    ve[a] = v0[a] + 3.0 * (dp[a] - v0[a] * T) / (2.0 * T);
  for (int a = 0; a < 3; ++a) {
    if (ve[a] > (2.5 / 3.0) * max_vel) {
      double Tp = 3.0 * dp[a] / (2.0 * (max_vel + 0.5 * v0[a]));
      if (Tp > T) T = Tp;
    }
  }
  for (int a = 0; a < 3; ++a) {
    double r = dp[a] - v0[a] * T;
    v1_out[a] = v0[a] + 3.0 * r / (2.0 * T);
    coef[4 * a + 0] = p0[a];
    coef[4 * a + 1] = v0[a];
    coef[4 * a + 2] = 3.0 * r / (2.0 * T * T);
    coef[4 * a + 3] = -r / (2.0 * T * T * T);
  }
  *T_out = T;
}

}  // namespace

// Free-end-velocity one-shot, exposed for exact-port cross-checks
// against the JAX port (search/kinodynamic.py free_end_vel_shot).
extern "C" void gtop_free_shot(const double* p0, const double* p1,
                               const double* v0, double max_vel,
                               double* coef, double* T_out, double* v1_out) {
  free_shot(p0, p1, v0, max_vel, coef, T_out, v1_out);
}

// Exact hybrid A* search (compare2's front-end).
//
// cfg: [max_acc, max_vel, max_tau, w_time, lambda_heu, horizon,
//       max_iters, init_max_tau, use_init (0/1), heu_mode
//       (0 kinodynamic / 1 diag / 2 manhattan / 3 euclid),
//       clearance_margin (reference hard-codes 0.2, :644),
//       shot_mode (0 fixed-end-vel shotHeu :1023-1101;
//       1 free-end-vel freeEndVelShot :969-1021 — present in the
//       reference but unwired from searchPath; the goal knot then
//       carries the shot's free end velocity)]
// start: 9 doubles = state (pos, vel) + start acceleration (init mode
// expands with um = start_acc, hybrid_astar.cpp:1377-1447).
// out_status: 0 NO_PATH, 1 REACH_END, 2 REACH_HORIZON
//   (hybrid_astar.h:13-15).
// Returns the number of knots written (pos, vel, acc rows of
// out_knots; out_times has n-1 durations), 0 on NO_PATH.
extern "C" int gtop_hybrid_search(const float* dist, int nx, int ny, int nz,
                                  const float* origin, float resolution,
                                  const double* start, const double* goal,
                                  const double* cfg, double* out_knots,
                                  double* out_times, int max_knots,
                                  int* out_status) {
  const double max_acc = cfg[0], max_vel = cfg[1], max_tau = cfg[2];
  const double w_time = cfg[3], lambda_heu = cfg[4], horizon = cfg[5];
  const int max_iters = int(cfg[6]);
  const double init_max_tau = cfg[7];
  const bool use_init = cfg[8] > 0.5;
  const int heu_mode = int(cfg[9]);
  const double margin = cfg[10];
  const int shot_mode = int(cfg[11]);
  const double tie_breaker = 1.0 + 1.0 / 10000.0;  // hybrid_astar.h:94
  *out_status = 0;

  auto vox = [&](const double* p, int* i3) {
    i3[0] = int(std::floor((p[0] - origin[0]) / resolution));
    i3[1] = int(std::floor((p[1] - origin[1]) / resolution));
    i3[2] = int(std::floor((p[2] - origin[2]) / resolution));
  };
  auto in_grid = [&](const int* i3) {
    return i3[0] >= 0 && i3[0] < nx && i3[1] >= 0 && i3[1] < ny &&
           i3[2] >= 0 && i3[2] < nz;
  };
  auto key_of = [&](const int* i3) -> int64_t {
    return (int64_t(i3[0]) * ny + i3[1]) * nz + i3[2];
  };
  auto dist_at_idx = [&](const int* i3) -> double {
    return dist[flat(i3[0], i3[1], i3[2], ny, nz)];
  };

  int end_idx[3], start_idx[3];
  vox(goal, end_idx);
  vox(start, start_idx);
  if (!in_grid(start_idx) || !in_grid(end_idx)) return 0;

  // heuristic of a state toward the goal (also yields the Pontryagin
  // optimal time the one-shot needs, regardless of heu_mode)
  auto heu_of = [&](const double* x, double* opt_t) {
    double raw = pontryagin_cost(x, goal, w_time, max_vel, opt_t);
    if (heu_mode == 0) return (1.0 + tie_breaker) * raw;
    int i3[3];
    vox(x, i3);
    return tie_breaker * h_geom_heu(heu_mode, i3, end_idx);
  };

  std::unordered_map<int64_t, HNode> nodes;
  std::multimap<double, int64_t> open;

  HNode s;
  std::memcpy(s.state, start, 6 * sizeof(double));
  s.g = 0;
  s.f = lambda_heu * heu_of(start, &s.opt_time);
  s.id = 1;
  int64_t start_key = key_of(start_idx);
  s.it = open.insert({s.f, start_key});
  nodes[start_key] = s;

  struct Cand {
    double state[6];
    double edge, heu, opt_time, dur;
    double input[3];
  };

  bool is_shot_succ = false;
  double t_shot = 0.0;
  double shot_end_vel[3] = {0, 0, 0};  // free-end-vel shot's v1
  int64_t terminate_key = -1;
  bool first_expand = use_init;
  int num_iter = 0;

  while (!open.empty() && num_iter < max_iters) {
    ++num_iter;
    int64_t cur_key = open.begin()->second;
    HNode& cur = nodes[cur_key];

    int cur_idx[3];
    vox(cur.state, cur_idx);
    const int difference = 5;  // hybrid_astar.cpp:283
    bool near_end = std::abs(cur_idx[0] - end_idx[0]) <= difference &&
                    std::abs(cur_idx[1] - end_idx[1]) <= difference &&
                    std::abs(cur_idx[2] - end_idx[2]) <= difference;
    double dx0 = cur.state[0] - start[0], dy0 = cur.state[1] - start[1],
           dz0 = cur.state[2] - start[2];
    bool reach_horizon =
        std::sqrt(dx0 * dx0 + dy0 * dy0 + dz0 * dz0) >= horizon;

    if (reach_horizon || near_end) {
      if (near_end && shot_mode == 1) {
        // freeEndVelShot (:969-1021): min-acc cubic to the goal
        // POSITION with free end velocity; samples spaced ~sqrt(3)*res
        // along the shot, checked against OCCUPANCY (:1004-1013)
        double cf[12], T, v1[3];
        free_shot(cur.state, goal, cur.state + 3, max_vel, cf, &T, v1);
        double dpn = 0;
        for (int a = 0; a < 3; ++a)
          dpn += (goal[a] - cur.state[a]) * (goal[a] - cur.state[a]);
        int step = (int)std::ceil(std::sqrt(dpn) /
                                  (std::sqrt(3.0) * resolution));
        double t_delta = T / std::max(step, 1);
        bool ok = true;
        for (double time = t_delta; time <= T && ok; time += t_delta) {
          double p[3];
          int i3[3];
          for (int a = 0; a < 3; ++a)
            p[a] = cf[4 * a] + cf[4 * a + 1] * time +
                   cf[4 * a + 2] * time * time +
                   cf[4 * a + 3] * time * time * time;
          vox(p, i3);
          if (!in_grid(i3) || dist_at_idx(i3) <= 0.0) ok = false;
        }
        if (ok) {
          is_shot_succ = true;
          t_shot = std::max(T, 1e-2);
          for (int a = 0; a < 3; ++a) shot_end_vel[a] = v1[a];
        }
      } else if (near_end) {
        // shotHeu (:1023-1101): fixed-end-velocity cubic over the
        // node's stored Pontryagin optimal time; 10 forward samples
        // checked against OCCUPANCY (not the 0.2 clearance — :1096)
        double t_d = std::max(cur.opt_time, 1e-2);
        double dp[3], dv[3], ca[3], cb[3];
        for (int a = 0; a < 3; ++a) {
          dp[a] = goal[a] - cur.state[a];
          dv[a] = goal[3 + a] - cur.state[3 + a];
          ca[a] = (1.0 / 6.0) *
                  (-12.0 / (t_d * t_d * t_d) * (dp[a] - cur.state[3 + a] * t_d) +
                   6.0 / (t_d * t_d) * dv[a]);
          cb[a] = 0.5 * (6.0 / (t_d * t_d) * (dp[a] - cur.state[3 + a] * t_d) -
                         2.0 / t_d * dv[a]);
        }
        bool ok = true;
        for (int k = 1; k <= 10 && ok; ++k) {
          double t = t_d * k / 10.0;
          double p[3];
          int i3[3];
          for (int a = 0; a < 3; ++a)
            p[a] = cur.state[a] + cur.state[3 + a] * t + cb[a] * t * t +
                   ca[a] * t * t * t;
          vox(p, i3);
          if (!in_grid(i3) || dist_at_idx(i3) <= 0.0) ok = false;
        }
        if (ok) {
          is_shot_succ = true;
          t_shot = t_d;
        }
      }
      terminate_key = cur_key;
      if (near_end) {
        if (cur.came < 0 && !is_shot_succ) {
          *out_status = 0;  // NO_PATH (:326-329)
          return 0;
        }
        *out_status = 1;  // REACH_END
      } else {
        *out_status = 2;  // REACH_HORIZON
      }
      break;
    }

    open.erase(open.begin());
    cur.id = -1;

    // expansion: per-diff-voxel best candidate by edge+heu
    // (the reference Neighbors container, hybrid_astar.h:28-64)
    std::map<int64_t, Cand> cands;
    auto consider = [&](const double* x1, const double* um, double tau) {
      int i3[3];
      vox(x1, i3);
      int64_t diff_key = key_of(i3);
      Cand c;
      std::memcpy(c.state, x1, 6 * sizeof(double));
      c.edge = (um[0] * um[0] + um[1] * um[1] + um[2] * um[2] + w_time) *
               tau;
      c.heu = lambda_heu * heu_of(x1, &c.opt_time);
      c.dur = tau;
      std::memcpy(c.input, um, 3 * sizeof(double));
      auto it = cands.find(diff_key);
      if (it == cands.end() || c.edge + c.heu < it->second.edge + it->second.heu)
        cands[diff_key] = c;
    };

    if (first_expand) {
      // init-mode expansion (:1377-1447): um = start_acc, 8 durations
      first_expand = false;
      const double* um = start + 6;
      for (int k = 1; k <= 8; ++k) {
        double tau = init_max_tau * k / 8.0;
        double x1[6];
        k_transit(cur.state, um, tau, x1);
        int i3[3];
        vox(x1, i3);
        if (!in_grid(i3)) continue;
        if (std::fabs(x1[3]) > max_vel || std::fabs(x1[4]) > max_vel ||
            std::fabs(x1[5]) > max_vel)
          continue;
        if (key_of(i3) == cur_key) continue;
        bool occ = false;
        for (int j = 1; j <= 10 && !occ; ++j) {
          double xt[6];
          int it3[3];
          k_transit(cur.state, um, tau * j / 10.0, xt);
          vox(xt, it3);
          if (!in_grid(it3) || dist_at_idx(it3) <= margin) occ = true;
        }
        if (occ) continue;
        consider(x1, um, tau);
      }
    } else {
      // 5^3 accelerations, um_z halved, single duration max_tau; the
      // reference `break`s (not continues) out of the innermost az
      // loop on the first infeasible candidate (:606-666) — a real
      // behavioral quirk, replicated
      const int check_num = 10;
      for (int iax = -2; iax <= 2; ++iax)
        for (int iay = -2; iay <= 2; ++iay)
          for (int iaz = -2; iaz <= 2; ++iaz) {
            double um[3] = {max_acc * iax / 2.0, max_acc * iay / 2.0,
                            0.5 * max_acc * iaz / 2.0};
            double x1[6];
            k_transit(cur.state, um, max_tau, x1);
            int i3[3];
            vox(x1, i3);
            if (!in_grid(i3)) break;
            if (std::fabs(x1[3]) > max_vel || std::fabs(x1[4]) > max_vel ||
                std::fabs(x1[5]) > max_vel)
              break;
            if (key_of(i3) == cur_key) continue;
            if (dist_at_idx(i3) <= 0.0) break;  // occupancy (:639)
            bool occ = false;
            for (int j = 1; j < check_num && !occ; ++j) {
              double xt[6];
              int it3[3];
              k_transit(cur.state, um, max_tau * j / check_num, xt);
              vox(xt, it3);
              if (!in_grid(it3) || dist_at_idx(it3) <= margin) occ = true;
            }
            if (occ) break;
            consider(x1, um, max_tau);
          }
    }

    // relaxation (:356-440): new nodes open; open nodes update when
    // tentative_g <= g; closed nodes never touched
    for (auto& [nb_key, c] : cands) {
      double tentative_g = cur.g + c.edge;
      auto nit = nodes.find(nb_key);
      if (nit == nodes.end() || nit->second.id == 0) {
        HNode nd;
        std::memcpy(nd.state, c.state, 6 * sizeof(double));
        nd.g = tentative_g;
        nd.f = tentative_g + c.heu;
        nd.opt_time = c.opt_time;
        nd.dur = c.dur;
        std::memcpy(nd.input, c.input, 3 * sizeof(double));
        nd.came = cur_key;
        nd.id = 1;
        nd.it = open.insert({nd.f, nb_key});
        nodes[nb_key] = nd;
      } else if (nit->second.id == 1 && tentative_g <= nit->second.g) {
        HNode& nd = nit->second;
        std::memcpy(nd.state, c.state, 6 * sizeof(double));
        nd.g = tentative_g;
        nd.f = tentative_g + c.heu;
        nd.opt_time = c.opt_time;
        nd.dur = c.dur;
        std::memcpy(nd.input, c.input, 3 * sizeof(double));
        nd.came = cur_key;
        open.erase(nd.it);
        nd.it = open.insert({nd.f, nb_key});
      }
    }
  }

  if (terminate_key < 0) {
    *out_status = 0;
    return 0;
  }

  // knot extraction (getKinoTrajMat, :1103-1161): chain start ->
  // terminate (+ goal when the shot landed; goal knot carries ZERO
  // velocity exactly as the reference writes it, :1117-1120)
  std::vector<int64_t> chain;
  for (int64_t k = terminate_key; k >= 0; k = nodes[k].came)
    chain.push_back(k);
  std::reverse(chain.begin(), chain.end());
  int n = int(chain.size());
  int extra = is_shot_succ ? 1 : 0;
  int total = std::min(n + extra, max_knots);
  int skip = n + extra - total;
  int w = 0;
  for (int i = skip; i < n; ++i, ++w) {
    const HNode& nd = nodes[chain[i]];
    for (int a = 0; a < 3; ++a) {
      out_knots[9 * w + a] = nd.state[a];
      out_knots[9 * w + 3 + a] = nd.state[3 + a];
      // acc = input of the segment LEAVING this knot (:1129-1149)
      out_knots[9 * w + 6 + a] =
          (i + 1 < n) ? nodes[chain[i + 1]].input[a] : 0.0;
    }
    if (i + 1 < n) out_times[w] = nodes[chain[i + 1]].dur;
  }
  if (is_shot_succ && w < max_knots) {
    out_times[w - 1 >= 0 ? w - 1 : 0] = t_shot;
    for (int a = 0; a < 3; ++a) {
      out_knots[9 * w + a] = goal[a];
      // shot_mode 0: the reference writes a ZERO goal velocity
      // (getKinoTrajMat, hybrid_astar.cpp:1117); shot_mode 1 carries
      // the free shot's end velocity (end_vel usage :1264-1269)
      out_knots[9 * w + 3 + a] = shot_end_vel[a];
      out_knots[9 * w + 6 + a] = 0.0;
    }
    ++w;
  }
  return w;
}

// ---------------------------------------------------------------------------
// Safe-ball informed RRT* with the receding-horizon tree API — the native
// engine for the reference's rrtPathFinder (path_finder.{h,cpp}) /
// rrgPathFinder machinery, mirroring the semantics of the Python planner
// (grad_traj_optimization_tpu/search/rrt.py RRTPlanner) node for node:
//
//  * nodes are safe balls (center + EDT-derived clearance radius,
//    rrgPathFinder.cpp:96-110); edges require overlapping balls;
//  * goal-biased uniform sampling, switching to the informed prolate
//    spheroid once a solution exists (path_finder.cpp:420-478);
//  * choose-parent + rewire insertion (:480-509, 592-705);
//  * resetRoot/costRecast mid-flight root commits (:302-375);
//  * RRTpathReEvaluate/ReConnect/treeRepair under map changes
//    (:1065-1554): shrink-only radii, branch cuts, orphan reconnection,
//    best-path re-evaluation, repair sampling around failure regions.
//
// RNG streams differ from the NumPy planner (std::mt19937_64 vs PCG64),
// so cross-checks are behavioral (corridor validity, repair routing),
// not bitwise.  C ABI: handle-based so the tree persists across calls —
// the replan loop holds ONE tree for the whole flight.
// ---------------------------------------------------------------------------

#include <random>

namespace {

struct RRTTree {
  // map
  std::vector<float> dist;
  int nx = 0, ny = 0, nz = 0;
  double origin[3] = {0, 0, 0}, res = 0.1, size[3] = {0, 0, 0};
  // params
  double steer_len, min_radius, goal_bias, radius_margin;
  double goal[3];
  // nodes (flat SoA, exactly the Python layout)
  std::vector<std::array<double, 3>> centers;
  std::vector<double> radii, costs;
  std::vector<int> parents;
  std::vector<char> valid;
  int root = 0;
  std::vector<int> goal_nodes;  // EndList analogue
  int best_goal_node = -1;
  double best_cost = kInf;
  bool commit_end = false;
  std::mt19937_64 rng;

  double dist_at(const double* p) const {  // rrt.py::_dist_at
    int ix = (int)std::floor((p[0] - origin[0]) / res);
    int iy = (int)std::floor((p[1] - origin[1]) / res);
    int iz = (int)std::floor((p[2] - origin[2]) / res);
    if (ix < 0 || iy < 0 || iz < 0 || ix >= nx || iy >= ny || iz >= nz)
      return -1.0;
    return dist[((size_t)ix * ny + iy) * nz + iz];
  }
  double clearance(const double* p) const {
    return dist_at(p) - radius_margin;
  }

  double urand() {
    return std::uniform_real_distribution<double>(0.0, 1.0)(rng);
  }
  double nrand() { return std::normal_distribution<double>(0.0, 1.0)(rng); }

  // goal-biased / informed-spheroid sample (path_finder.cpp:420-478)
  void sample(double* out) {
    if (urand() < goal_bias) {
      for (int a = 0; a < 3; ++a) out[a] = goal[a];
      return;
    }
    if (std::isfinite(best_cost)) {
      const auto& rc = centers[root];
      double a1[3], c_min = 0.0;
      for (int a = 0; a < 3; ++a) {
        a1[a] = goal[a] - rc[a];
        c_min += a1[a] * a1[a];
      }
      c_min = std::sqrt(c_min);
      double c_best = std::max(best_cost, c_min + 1e-6);
      double center[3];
      for (int a = 0; a < 3; ++a) {
        center[a] = 0.5 * (rc[a] + goal[a]);
        a1[a] /= std::max(c_min, 1e-9);
      }
      double r1 = c_best / 2.0;
      double r23 = std::sqrt(std::max(c_best * c_best - c_min * c_min,
                                      1e-9)) / 2.0;
      // orthonormal frame with first axis a1 (rrt.py::_frame)
      double e[3] = {1, 0, 0};
      if (std::fabs(a1[0]) > 0.9) { e[0] = 0; e[1] = 1; }
      double b[3] = {a1[1] * e[2] - a1[2] * e[1],
                     a1[2] * e[0] - a1[0] * e[2],
                     a1[0] * e[1] - a1[1] * e[0]};
      double nb = std::sqrt(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
      for (int a = 0; a < 3; ++a) b[a] /= nb;
      double c2[3] = {a1[1] * b[2] - a1[2] * b[1],
                      a1[2] * b[0] - a1[0] * b[2],
                      a1[0] * b[1] - a1[1] * b[0]};
      for (int tries = 0; tries < 1000; ++tries) {
        double u[3] = {nrand(), nrand(), nrand()};
        double nu = std::sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
        double scale = std::cbrt(urand()) / std::max(nu, 1e-300);
        for (int a = 0; a < 3; ++a) u[a] *= scale;
        bool ok = true;
        for (int a = 0; a < 3; ++a) {
          out[a] = center[a] + a1[a] * (r1 * u[0]) + b[a] * (r23 * u[1]) +
                   c2[a] * (r23 * u[2]);
          if (!(out[a] > origin[a] && out[a] < origin[a] + size[a]))
            ok = false;
        }
        if (ok) return;
      }
      // pathological spheroid (entirely off-map): fall through to uniform
    }
    for (int a = 0; a < 3; ++a) out[a] = origin[a] + urand() * size[a];
  }

  // steer + choose-parent + rewire (rrt.py::_try_insert;
  // path_finder.cpp:480-509, 592-705).  Returns new index or -1.
  int try_insert(double x0, double x1, double x2) {
    double x[3] = {x0, x1, x2};
    const size_t n = centers.size();
    // nearest valid node
    int near = -1;
    double d2n = kInf;
    for (size_t i = 0; i < n; ++i) {
      if (!valid[i]) continue;
      double dx = centers[i][0] - x[0], dy = centers[i][1] - x[1],
             dz = centers[i][2] - x[2];
      double d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < d2n) { d2n = d2; near = (int)i; }
    }
    double dn = std::sqrt(d2n);
    if (near < 0 || !std::isfinite(dn) || dn < 1e-9) return -1;
    double s = std::min(1.0, steer_len / dn);
    for (int a = 0; a < 3; ++a)
      x[a] = centers[near][a] + (x[a] - centers[near][a]) * s;

    double r = clearance(x);
    if (r < min_radius) return -1;

    // connectable = valid && ball overlap; parent = min cost + d
    std::vector<double> d(n);
    int parent = -1;
    double new_cost = kInf;
    for (size_t i = 0; i < n; ++i) {
      double dx = centers[i][0] - x[0], dy = centers[i][1] - x[1],
             dz = centers[i][2] - x[2];
      d[i] = std::sqrt(dx * dx + dy * dy + dz * dz);
      if (valid[i] && d[i] <= radii[i] + r) {
        double c = costs[i] + d[i];
        if (c < new_cost) { new_cost = c; parent = (int)i; }
      }
    }
    if (parent < 0 || !std::isfinite(new_cost)) return -1;

    centers.push_back({x[0], x[1], x[2]});
    radii.push_back(r);
    parents.push_back(parent);
    costs.push_back(new_cost);
    valid.push_back(1);
    int i_new = (int)centers.size() - 1;

    // rewire improved neighbors through the new node
    for (size_t j = 0; j < n; ++j) {
      if ((int)j == root || !valid[j] || d[j] > radii[j] + r) continue;
      if (costs[j] > new_cost + d[j]) {
        parents[j] = i_new;
        costs[j] = new_cost + d[j];
      }
    }

    // goal reachable from the new ball? (EndList bookkeeping)
    double dg = std::sqrt((goal[0] - x[0]) * (goal[0] - x[0]) +
                          (goal[1] - x[1]) * (goal[1] - x[1]) +
                          (goal[2] - x[2]) * (goal[2] - x[2]));
    if (dg <= r) {
      goal_nodes.push_back(i_new);
      if (new_cost + dg < best_cost) {
        best_cost = new_cost + dg;
        best_goal_node = i_new;
      }
    }
    return i_new;
  }

  std::vector<std::vector<int>> children_adjacency() const {
    std::vector<std::vector<int>> ch(centers.size());
    for (size_t j = 0; j < centers.size(); ++j)
      if ((int)j != root && valid[j] && parents[j] >= 0)
        ch[parents[j]].push_back((int)j);
    return ch;
  }

  void subtree_mark(int i, const std::vector<std::vector<int>>& ch,
                    std::vector<char>& mark) const {
    std::vector<int> stack{i};
    mark[i] = 1;
    while (!stack.empty()) {
      int a = stack.back();
      stack.pop_back();
      for (int b : ch[a])
        if (!mark[b]) { mark[b] = 1; stack.push_back(b); }
    }
  }

  void recompute_costs() {  // costRecast analogue (top-down refresh)
    auto ch = children_adjacency();
    std::vector<char> seen(centers.size(), 0);
    if (valid[root]) {
      costs[root] = 0.0;
      seen[root] = 1;
      std::vector<int> stack{root};
      while (!stack.empty()) {
        int a = stack.back();
        stack.pop_back();
        for (int b : ch[a]) {
          if (seen[b]) continue;
          double dx = centers[a][0] - centers[b][0],
                 dy = centers[a][1] - centers[b][1],
                 dz = centers[a][2] - centers[b][2];
          costs[b] = costs[a] + std::sqrt(dx * dx + dy * dy + dz * dz);
          seen[b] = 1;
          stack.push_back(b);
        }
      }
    }
    for (size_t i = 0; i < centers.size(); ++i)
      if (valid[i] && !seen[i]) valid[i] = 0;
  }

  void reevaluate_best() {  // feasibleEndList scan
    std::vector<int> kept;
    for (int i : goal_nodes) {
      if (!valid[i]) continue;
      double dx = goal[0] - centers[i][0], dy = goal[1] - centers[i][1],
             dz = goal[2] - centers[i][2];
      if (std::sqrt(dx * dx + dy * dy + dz * dz) <= radii[i])
        kept.push_back(i);
    }
    goal_nodes.swap(kept);
    best_goal_node = -1;
    best_cost = kInf;
    for (int i : goal_nodes) {
      double dx = goal[0] - centers[i][0], dy = goal[1] - centers[i][1],
             dz = goal[2] - centers[i][2];
      double c = costs[i] + std::sqrt(dx * dx + dy * dy + dz * dz);
      if (c < best_cost) { best_cost = c; best_goal_node = i; }
    }
  }

  std::vector<int> chain_of(int i) const {
    // Bounded by node count: a rewire against stale descendant costs
    // could in principle attach an ancestor under its own descendant
    // (parent cycle); an unbounded walk would then hang the process
    // inside gtop_rrt_path_len/reset_root.  A cycle is truncated at
    // n nodes instead (the traced path is garbage but finite; the
    // caller's validity checks reject it).
    std::vector<int> chain{i};
    const size_t n = parents.size();
    while (parents[chain.back()] >= 0 && chain.size() <= n)
      chain.push_back(parents[chain.back()]);
    std::reverse(chain.begin(), chain.end());
    return chain;
  }
};

}  // namespace

extern "C" {

void* gtop_rrt_create(const float* dist, int nx, int ny, int nz,
                      const double* origin, double res, const double* start,
                      const double* goal, double steer_len, double min_radius,
                      double goal_bias, double radius_margin, uint64_t seed) {
  RRTTree* t = new RRTTree();
  t->dist.assign(dist, dist + (size_t)nx * ny * nz);
  t->nx = nx;
  t->ny = ny;
  t->nz = nz;
  t->res = res;
  for (int a = 0; a < 3; ++a) {
    t->origin[a] = origin[a];
    t->goal[a] = goal[a];
  }
  t->size[0] = nx * res;
  t->size[1] = ny * res;
  t->size[2] = nz * res;
  t->steer_len = steer_len;
  t->min_radius = min_radius;
  t->goal_bias = goal_bias;
  // default margin: max(0.15, 0.87*res) — the cell-center EDT
  // overestimates clearance to the obstacle region by up to
  // res*sqrt(3)/2 (reference margin 0.15, rrgPathFinder.cpp:96-110)
  t->radius_margin =
      radius_margin >= 0.0 ? radius_margin : std::max(0.15, 0.87 * res);
  t->rng.seed(seed);
  double r0 = t->clearance(start);
  t->centers.push_back({start[0], start[1], start[2]});
  t->radii.push_back(std::max(r0, min_radius));
  t->parents.push_back(-1);
  t->costs.push_back(0.0);
  t->valid.push_back(1);
  return t;
}

void gtop_rrt_destroy(void* h) { delete (RRTTree*)h; }

// RRTpathFind sampling rounds; returns 1 if a path to goal exists.
int gtop_rrt_grow(void* h, int iters) {
  RRTTree* t = (RRTTree*)h;
  double x[3];
  for (int k = 0; k < iters; ++k) {
    t->sample(x);
    t->try_insert(x[0], x[1], x[2]);
  }
  return std::isfinite(t->best_cost) ? 1 : 0;
}

double gtop_rrt_best_cost(void* h) { return ((RRTTree*)h)->best_cost; }
int gtop_rrt_commit_end(void* h) { return ((RRTTree*)h)->commit_end ? 1 : 0; }

int gtop_rrt_n_nodes(void* h) {
  RRTTree* t = (RRTTree*)h;
  int n = 0;
  for (char v : t->valid) n += v ? 1 : 0;
  return n;
}

// Path length including the appended goal point (0 if no path).
int gtop_rrt_path_len(void* h) {
  RRTTree* t = (RRTTree*)h;
  if (t->best_goal_node < 0) return 0;
  return (int)t->chain_of(t->best_goal_node).size() + 1;
}

// tracePath/getPath (path_finder.cpp:806-887): waypoints + radii.
void gtop_rrt_get_path(void* h, double* path, double* radii_out) {
  RRTTree* t = (RRTTree*)h;
  if (t->best_goal_node < 0) return;
  std::vector<int> chain = t->chain_of(t->best_goal_node);
  size_t k = 0;
  for (int i : chain) {
    for (int a = 0; a < 3; ++a) path[3 * k + a] = t->centers[i][a];
    radii_out[k] = t->radii[i];
    ++k;
  }
  for (int a = 0; a < 3; ++a) path[3 * k + a] = t->goal[a];
  radii_out[k] = std::max(t->clearance(t->goal), t->min_radius);
}

// Current root ball (center, radius) — what the Python planner returns
// as its length-1 "path" when the goal is unreached (rrt.py result()).
void gtop_rrt_root(void* h, double* out_center, double* out_radius) {
  RRTTree* t = (RRTTree*)h;
  for (int a = 0; a < 3; ++a) out_center[a] = t->centers[t->root][a];
  *out_radius = t->radii[t->root];
}

// resetRoot/costRecast (path_finder.cpp:302-375): commit a new root as
// the vehicle advances.  Returns 1 on success (including the terminal
// commit_end case), 0 if no containing path ball was found.
int gtop_rrt_reset_root(void* h, const double* target) {
  RRTTree* t = (RRTTree*)h;
  if (t->best_goal_node < 0) return 0;
  std::vector<int> chain = t->chain_of(t->best_goal_node);
  int end = chain.back();
  {
    double dx = t->centers[end][0] - target[0],
           dy = t->centers[end][1] - target[1],
           dz = t->centers[end][2] - target[2];
    if (std::sqrt(dx * dx + dy * dy + dz * dz) < t->radii[end]) {
      t->commit_end = true;  // almost at the final target
      return 1;
    }
  }
  int new_root = -1;
  for (auto it = chain.rbegin(); it != chain.rend(); ++it) {
    int i = *it;  // closest-to-goal containing node wins
    double dx = t->centers[i][0] - target[0],
           dy = t->centers[i][1] - target[1],
           dz = t->centers[i][2] - target[2];
    if (std::sqrt(dx * dx + dy * dy + dz * dz) < t->radii[i] - 0.1) {
      new_root = i;
      break;
    }
  }
  if (new_root < 0 || new_root == t->root) return new_root == t->root;
  auto ch = t->children_adjacency();
  std::vector<char> keep(t->centers.size(), 0);
  t->subtree_mark(new_root, ch, keep);
  for (size_t i = 0; i < t->centers.size(); ++i)
    if (t->valid[i] && !keep[i]) t->valid[i] = 0;
  t->parents[new_root] = -1;
  t->root = new_root;
  t->recompute_costs();
  t->reevaluate_best();
  return 1;
}

// RRTpathReEvaluate + ReConnect + treeRepair (path_finder.cpp:1065-1554)
// under a changed map; returns 1 if a path to goal survives/is repaired.
int gtop_rrt_update_map(void* h, const float* dist, int repair_iters) {
  RRTTree* t = (RRTTree*)h;
  t->dist.assign(dist, dist + (size_t)t->nx * t->ny * t->nz);
  const size_t n = t->centers.size();
  std::vector<std::array<double, 4>> repair;  // (center, r_old)

  // 1. shrink-only radius refresh; cut failed nodes + branches
  auto adj = t->children_adjacency();
  std::vector<char> cut(n, 0);
  for (size_t i = 0; i < n; ++i) {
    if (!t->valid[i]) continue;
    double new_r =
        std::min(t->radii[i], t->clearance(t->centers[i].data()));
    t->radii[i] = new_r;
    if (new_r < t->min_radius && (int)i != t->root) {
      repair.push_back({t->centers[i][0], t->centers[i][1],
                        t->centers[i][2], std::max(new_r, t->min_radius)});
      std::fill(cut.begin(), cut.end(), 0);
      t->subtree_mark((int)i, adj, cut);
      for (size_t j = 0; j < n; ++j)
        if (cut[j]) t->valid[j] = 0;
    }
  }

  // 2. BFS from root over still-overlapping edges -> reachable set
  auto ch = t->children_adjacency();
  std::vector<char> reach(n, 0);
  std::vector<int> stack;
  if (t->valid[t->root]) {
    reach[t->root] = 1;
    stack.push_back(t->root);
  }
  auto gap = [&](int i, int j) {
    double dx = t->centers[i][0] - t->centers[j][0],
           dy = t->centers[i][1] - t->centers[j][1],
           dz = t->centers[i][2] - t->centers[j][2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
  };
  while (!stack.empty()) {
    int i = stack.back();
    stack.pop_back();
    for (int j : ch[i]) {
      if (!t->valid[j] || reach[j]) continue;
      if (gap(i, j) <= t->radii[i] + t->radii[j]) {
        reach[j] = 1;
        stack.push_back(j);
      }
    }
  }

  // 3. ReConnect rounds: orphaned valid subtree roots find a new parent
  //    among reachable nodes (localReConnect analogue)
  std::vector<int> orphans;
  for (size_t i = 0; i < n; ++i)
    if (t->valid[i] && !reach[i]) orphans.push_back((int)i);
  bool progress = true;
  while (progress && !orphans.empty()) {
    progress = false;
    std::vector<int> still;
    for (int i : orphans) {
      if (reach[i]) continue;
      int best_j = -1;
      double best_c = kInf;
      for (size_t j = 0; j < n; ++j) {
        if (!reach[j]) continue;
        double g = gap(i, (int)j);
        if (g <= t->radii[j] + t->radii[i]) {
          double c = t->costs[j] + g;
          if (c < best_c) { best_c = c; best_j = (int)j; }
        }
      }
      if (best_j >= 0) {
        t->parents[i] = best_j;
        reach[i] = 1;
        // the orphan's own intact subtree comes along
        std::vector<int> st{i};
        while (!st.empty()) {
          int a = st.back();
          st.pop_back();
          for (int b : ch[a]) {
            if (t->valid[b] && !reach[b] &&
                gap(a, b) <= t->radii[a] + t->radii[b]) {
              reach[b] = 1;
              st.push_back(b);
            }
          }
        }
        progress = true;
      } else {
        still.push_back(i);
      }
    }
    orphans.swap(still);
  }
  for (int i : orphans) {
    if (t->valid[i])
      repair.push_back({t->centers[i][0], t->centers[i][1], t->centers[i][2],
                        std::max(t->radii[i], t->min_radius)});
    t->valid[i] = 0;
  }

  t->recompute_costs();
  t->reevaluate_best();

  // 4. treeRepair: spend insertion attempts near the failure regions
  if (!repair.empty() && repair_iters > 0) {
    int per = std::max(1, repair_iters / (int)repair.size());
    for (const auto& rg : repair) {
      for (int k = 0; k < per; ++k) {
        double p[3] = {rg[0] + t->nrand() * rg[3],
                       rg[1] + t->nrand() * rg[3],
                       rg[2] + t->nrand() * rg[3]};
        t->try_insert(p[0], p[1], p[2]);
      }
    }
    t->reevaluate_best();
  }
  return std::isfinite(t->best_cost) ? 1 : 0;
}

}  // extern "C"
