// IMU preintegration whiteners — native host runtime.
//
// The covariance recursion of factors.imu.preintegrate_with_cov (Forster
// TRO'17 eq. 62-63, GTSAM continuous-time noise semantics: sigma^2/dt per
// sample) evaluated at zero bias for every keyframe interval, followed by
// inv(chol(P)): the function of graph/builder.py::compute_imu_whiteners,
// which stays the port's main path; tests/test_torch_surface.py holds the
// two together.
//
// Build: g++ -O3 -shared -fPIC whitener.cpp -o libuslam_whitener.so, run at
// first use by uslam_tpu_torch/native/__init__.py into uslam_tpu_torch/_build/
// (the JAX package's uslam_tpu/native/whitener.cpp, copied unchanged below).

#include <cmath>
#include <cstring>
#include <cstdint>

namespace {

using Mat3 = double[9];   // row-major 3x3
using Mat9 = double[81];  // row-major 9x9

inline void mat3_mul(const double* a, const double* b, double* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0.0;
      for (int k = 0; k < 3; ++k) s += a[i * 3 + k] * b[k * 3 + j];
      out[i * 3 + j] = s;
    }
}

inline void mat3_mul_bt(const double* a, const double* b, double* out) {
  // a @ b^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0.0;
      for (int k = 0; k < 3; ++k) s += a[i * 3 + k] * b[j * 3 + k];
      out[i * 3 + j] = s;
    }
}

inline void hat(const double* w, double* h) {
  h[0] = 0.0;   h[1] = -w[2]; h[2] = w[1];
  h[3] = w[2];  h[4] = 0.0;   h[5] = -w[0];
  h[6] = -w[1]; h[7] = w[0];  h[8] = 0.0;
}

// Rodrigues Exp(w) and SO(3) left Jacobian Jl(w).
inline void exp_and_left_jacobian(const double* w, double* R, double* Jl) {
  const double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const double th = std::sqrt(th2);
  double s, c, j2;
  if (th < 1e-8) {
    s = 1.0 - th2 / 6.0;
    c = 0.5 - th2 / 24.0;
    j2 = 1.0 / 6.0 - th2 / 120.0;
  } else {
    s = std::sin(th) / th;
    c = (1.0 - std::cos(th)) / th2;
    j2 = (th - std::sin(th)) / (th2 * th);
  }
  Mat3 H, H2;
  hat(w, H);
  mat3_mul(H, H, H2);
  for (int i = 0; i < 9; ++i) {
    const double eye = (i % 4 == 0) ? 1.0 : 0.0;
    R[i] = eye + s * H[i] + c * H2[i];
    Jl[i] = eye + c * H[i] + j2 * H2[i];
  }
}

// P <- A P A^T + Q for 9x9 (generic; A is small enough that exploiting its
// block sparsity is not worth the code).
inline void propagate(const double* A, double* P, const double* Q) {
  Mat9 AP, APA;
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 9; ++j) {
      double s = 0.0;
      for (int k = 0; k < 9; ++k) s += A[i * 9 + k] * P[k * 9 + j];
      AP[i * 9 + j] = s;
    }
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 9; ++j) {
      double s = 0.0;
      for (int k = 0; k < 9; ++k) s += AP[i * 9 + k] * A[j * 9 + k];
      APA[i * 9 + j] = s + Q[i * 9 + j];
    }
  std::memcpy(P, APA, sizeof(Mat9));
}

// Lower Cholesky of SPD 9x9, then L^{-1} by forward substitution.
inline void chol_inv(double* P, double* out) {
  Mat9 L;
  std::memset(L, 0, sizeof(Mat9));
  for (int i = 0; i < 9; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = P[i * 9 + j];
      for (int k = 0; k < j; ++k) s -= L[i * 9 + k] * L[j * 9 + k];
      if (i == j)
        L[i * 9 + i] = std::sqrt(s);
      else
        L[i * 9 + j] = s / L[j * 9 + j];
    }
  }
  // Solve L X = I column by column.
  std::memset(out, 0, sizeof(Mat9));
  for (int col = 0; col < 9; ++col) {
    for (int i = col; i < 9; ++i) {
      double s = (i == col) ? 1.0 : 0.0;
      for (int k = col; k < i; ++k) s -= L[i * 9 + k] * out[k * 9 + col];
      out[i * 9 + col] = s / L[i * 9 + i];
    }
  }
}

}  // namespace

extern "C" void imu_whiteners(
    const double* acc,   // (F, S, 3)
    const double* gyro,  // (F, S, 3)
    const double* dt,    // (F, S)
    int64_t F, int64_t S,
    double accel_cov, double gyro_cov, double integration_cov,
    double* out          // (F, 9, 9) inv(chol(P))
) {
  for (int64_t f = 0; f < F; ++f) {
    Mat3 R = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    Mat9 P;
    std::memset(P, 0, sizeof(Mat9));
    for (int64_t k = 0; k < S; ++k) {
      const double h = dt[f * S + k];
      if (!(h > 0.0)) continue;
      const double* a = acc + (f * S + k) * 3;
      const double* w = gyro + (f * S + k) * 3;
      const double wh[3] = {-w[0] * h, -w[1] * h, -w[2] * h};
      Mat3 dR, Jl_neg;
      exp_and_left_jacobian(wh, dR, Jl_neg);
      Mat3 Rh, RRh;
      hat(a, Rh);
      for (int i = 0; i < 9; ++i) Rh[i] *= h;
      mat3_mul(R, Rh, RRh);

      Mat9 A;
      std::memset(A, 0, sizeof(Mat9));
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          A[i * 9 + j] = dR[i * 3 + j];                    // Exp(wdt)^T
          A[(i + 3) * 9 + j] = -RRh[i * 3 + j];
          A[(i + 6) * 9 + j] = -0.5 * RRh[i * 3 + j] * h;
        }
      for (int i = 0; i < 3; ++i) {
        A[(i + 3) * 9 + (i + 3)] = 1.0;
        A[(i + 6) * 9 + (i + 3)] = h;
        A[(i + 6) * 9 + (i + 6)] = 1.0;
      }

      Mat3 Gg, Gav, Gap;
      for (int i = 0; i < 9; ++i) {
        Gg[i] = Jl_neg[i] * h;
        Gav[i] = R[i] * h;
        Gap[i] = 0.5 * R[i] * h * h;
      }
      const double inv_h = 1.0 / std::max(h, 1e-9);
      Mat3 Qgg, Qvv, Qvp, Qpp;
      mat3_mul_bt(Gg, Gg, Qgg);
      mat3_mul_bt(Gav, Gav, Qvv);
      mat3_mul_bt(Gav, Gap, Qvp);
      mat3_mul_bt(Gap, Gap, Qpp);

      Mat9 Q;
      std::memset(Q, 0, sizeof(Mat9));
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          Q[i * 9 + j] = gyro_cov * inv_h * Qgg[i * 3 + j];
          Q[(i + 3) * 9 + (j + 3)] = accel_cov * inv_h * Qvv[i * 3 + j];
          Q[(i + 3) * 9 + (j + 6)] = accel_cov * inv_h * Qvp[i * 3 + j];
          Q[(i + 6) * 9 + (j + 3)] = accel_cov * inv_h * Qvp[j * 3 + i];
          Q[(i + 6) * 9 + (j + 6)] = accel_cov * inv_h * Qpp[i * 3 + j];
        }
      for (int i = 0; i < 3; ++i)
        Q[(i + 6) * 9 + (i + 6)] += integration_cov * h;

      propagate(A, P, Q);
      Mat3 Rn;
      mat3_mul_bt(R, dR, Rn);  // R <- R @ dR^T = R @ Exp(wdt)
      std::memcpy(R, Rn, sizeof(Mat3));
    }
    for (int i = 0; i < 9; ++i) P[i * 9 + i] += 1e-10;
    chol_inv(P, out + f * 81);
  }
}
