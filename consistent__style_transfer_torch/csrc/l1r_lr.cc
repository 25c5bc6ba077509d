// L1-regularised logistic regression on the host: liblinear's newGLMNET
// (solve_l1r_lr; Yuan, Ho & Lin, JMLR 2012), a line-for-line port of the
// Python solver evaluate/lexicon.py::_solve_l1r_lr, in float64 throughout.
//
// Minimises ||w||_1 + C * sum_i log(1 + exp(-y_i w.x_i)) over a CSC matrix
// X (l rows, n columns, the bias a last column of value 1), y_i = +-1. Each
// Newton iteration takes the gradient and the diagonal of the Hessian over
// every feature with liblinear's outer shrinking, then runs coordinate
// descent on the quadratic model over the active set (inner shrinking, the
// inner stopping rule with inner_eps *= 0.25 after a one-pass solve, steps
// clamped to +-10), then an Armijo line search along the step (sigma 0.01,
// at most 20 halvings; after a failed search exp(X.w) is recomputed from w).
// Constants: nu 1e-12, 1000 inner passes, max_newton_iter Newton iterations;
// the stopping tolerance eps comes from the caller.
//
// The coordinate order of each inner pass is a Fisher-Yates shuffle of the
// active set, from the last position down, each position's index drawn as
// splitmix64() mod (position + 1), the generator seeded with `seed`. It is
// neither liblinear's (C rand()) nor the Python solver's (numpy's
// default_rng): the problem is degenerate, so fits under different orders
// agree on the objective and the selected features, not weight for weight.
//
// C interface, bound with ctypes (evaluate/l1r_native.py). Built with g++
// as host C++17; no CUDA: each coordinate step reads xTd, which the one
// before it wrote.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
};

void shuffle(std::vector<int64_t>& a, SplitMix64& rng) {
  for (size_t i = a.size(); i > 1; --i) std::swap(a[i - 1], a[rng.next() % i]);
}

}  // namespace

// Returns the Newton iterations run (>= 0), or -1 on bad sizes. w_out (n)
// receives the weights; *inner_out the inner passes summed over the Newton
// iterations.
extern "C" int tpust_l1r_lr(int64_t l, int64_t n, const int64_t* indptr, const int32_t* indices,
                            const double* data, const double* y, double C, double eps,
                            int max_newton_iter, uint64_t seed, double* w_out,
                            int64_t* inner_out) {
  if (l <= 0 || n <= 0 || indptr[0] != 0) return -1;
  const double nu = 1e-12, sigma = 0.01, inf = std::numeric_limits<double>::infinity();
  const int max_inner = 1000, max_linesearch = 20;
  const int64_t nnz = indptr[n];
  SplitMix64 rng{seed};

  std::vector<double> w(n, 0.0), wpd(n, 0.0), xjneg_sum(n, 0.0), Hdiag(n), Grad(n);
  std::vector<double> exp_wTx(l, 1.0), exp_wTx_new(l), tau(l), D(l), xTd(l), dx(nnz);
  for (int64_t j = 0; j < n; ++j)
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k)
      xjneg_sum[j] += data[k] * (y[indices[k]] < 0 ? C : 0.0);
  for (int64_t i = 0; i < l; ++i) {
    tau[i] = C / (1.0 + exp_wTx[i]);
    D[i] = C * exp_wTx[i] / ((1.0 + exp_wTx[i]) * (1.0 + exp_wTx[i]));
  }

  double w_norm = 0.0, inner_eps = 1.0, Gmax_old = inf, Gnorm1_init = -1.0;
  int newton_iter = 0;
  int64_t inner_total = 0;
  std::vector<int64_t> active, qp_active, kept;
  while (newton_iter < max_newton_iter) {
    // outer pass: gradient, diagonal Hessian, violations, outer shrinking
    active.clear();
    double Gmax_new = 0.0, Gnorm1_new = 0.0;
    for (int64_t j = 0; j < n; ++j) {
      double h = 0.0, g = 0.0;
      for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
        const double v = data[k];
        h += v * v * D[indices[k]];
        g += v * tau[indices[k]];
      }
      Hdiag[j] = nu + h;
      Grad[j] = xjneg_sum[j] - g;
      const double Gp = Grad[j] + 1.0, Gn = Grad[j] - 1.0;
      double viol;
      if (w[j] > 0) {
        viol = std::fabs(Gp);
      } else if (w[j] < 0) {
        viol = std::fabs(Gn);
      } else if (Gp < 0) {
        viol = -Gp;
      } else if (Gn > 0) {
        viol = Gn;
      } else if (Gp > Gmax_old / l && Gn < -Gmax_old / l) {
        continue;  // outer shrinking
      } else {
        viol = 0.0;
      }
      active.push_back(j);
      Gmax_new = std::max(Gmax_new, viol);
      Gnorm1_new += viol;
    }
    if (newton_iter == 0) Gnorm1_init = Gnorm1_new;
    if (Gnorm1_new <= eps * Gnorm1_init) break;

    // coordinate descent on the quadratic model, over the active set
    std::fill(xTd.begin(), xTd.end(), 0.0);
    for (int64_t k = 0; k < nnz; ++k) dx[k] = data[k] * D[indices[k]];
    qp_active = active;
    double QP_Gmax_old = inf;
    int inner = 0;
    while (inner < max_inner) {
      double QP_Gmax_new = 0.0, QP_Gnorm1_new = 0.0;
      const double bound = QP_Gmax_old / l;
      kept.clear();
      shuffle(qp_active, rng);
      for (const int64_t j : qp_active) {
        const int64_t a = indptr[j], b = indptr[j + 1];
        double dot = 0.0;
        for (int64_t k = a; k < b; ++k) dot += dx[k] * xTd[indices[k]];
        const double G = Grad[j] + (wpd[j] - w[j]) * nu + dot;
        const double H = Hdiag[j], wj = wpd[j];
        const double gp = G + 1.0, gn = G - 1.0;
        double v;
        if (wj == 0) {
          if (gp < 0) {
            v = -gp;
          } else if (gn > 0) {
            v = gn;
          } else if (gp > bound && gn < -bound) {
            continue;  // inner shrinking
          } else {
            v = 0.0;
          }
        } else if (wj > 0) {
          v = std::fabs(gp);
        } else {
          v = std::fabs(gn);
        }
        kept.push_back(j);
        QP_Gmax_new = std::max(QP_Gmax_new, v);
        QP_Gnorm1_new += v;
        double z;
        if (gp < H * wj) {
          z = -gp / H;
        } else if (gn > H * wj) {
          z = -gn / H;
        } else {
          z = -wj;
        }
        if (std::fabs(z) < 1e-12) continue;
        z = std::min(std::max(z, -10.0), 10.0);
        wpd[j] = wj + z;
        for (int64_t k = a; k < b; ++k) xTd[indices[k]] += z * data[k];
      }
      ++inner;
      if (QP_Gnorm1_new <= inner_eps * Gnorm1_init) {
        if (kept.size() == active.size()) break;  // inner stopping
        qp_active = active;  // reactivate the set
        QP_Gmax_old = inf;
        continue;
      }
      qp_active.swap(kept);
      QP_Gmax_old = QP_Gmax_new;
    }
    inner_total += inner;

    // Armijo line search along wpd - w
    double delta = 0.0, w_norm_new = 0.0, negsum_xTd = 0.0;
    for (int64_t j = 0; j < n; ++j) {
      delta += Grad[j] * (wpd[j] - w[j]);
      w_norm_new += std::fabs(wpd[j]);
    }
    delta += w_norm_new - w_norm;
    for (int64_t i = 0; i < l; ++i)
      if (y[i] < 0) negsum_xTd += xTd[i];
    negsum_xTd *= C;
    int num_linesearch = 0;
    for (; num_linesearch < max_linesearch; ++num_linesearch) {
      double loss = 0.0;
      for (int64_t i = 0; i < l; ++i) {
        const double exp_xTd = std::exp(xTd[i]);
        exp_wTx_new[i] = exp_wTx[i] * exp_xTd;
        loss += C * std::log((1.0 + exp_wTx_new[i]) / (exp_xTd + exp_wTx_new[i]));
      }
      const double cond = w_norm_new - w_norm + negsum_xTd - sigma * delta + loss;
      if (cond <= 0) {
        w_norm = w_norm_new;
        w = wpd;
        exp_wTx.swap(exp_wTx_new);
        for (int64_t i = 0; i < l; ++i) {
          tau[i] = C / (1.0 + exp_wTx[i]);
          D[i] = C * exp_wTx[i] / ((1.0 + exp_wTx[i]) * (1.0 + exp_wTx[i]));
        }
        break;
      }
      w_norm_new = 0.0;
      for (int64_t j = 0; j < n; ++j) {
        wpd[j] = (w[j] + wpd[j]) * 0.5;
        w_norm_new += std::fabs(wpd[j]);
      }
      delta *= 0.5;
      negsum_xTd *= 0.5;
      for (int64_t i = 0; i < l; ++i) xTd[i] *= 0.5;
    }
    if (num_linesearch == max_linesearch) {  // too many steps: exp(w.x) from w
      std::fill(exp_wTx.begin(), exp_wTx.end(), 0.0);
      for (int64_t j = 0; j < n; ++j)
        for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) exp_wTx[indices[k]] += w[j] * data[k];
      for (int64_t i = 0; i < l; ++i) exp_wTx[i] = std::exp(exp_wTx[i]);
    }
    if (inner == 1) inner_eps *= 0.25;
    ++newton_iter;
    Gmax_old = Gmax_new;
  }
  std::copy(w.begin(), w.end(), w_out);
  *inner_out = inner_total;
  return newton_iter;
}
