// Native host-side runtime kernels for admm_tpu.
//
// Equivalent of the reference's host compute layer: the
// hand-written AVX standardization kernels (reference:
// src/Linalg/AVX.h:360-530 — get_ss_avx / standardize_vec_avx) and the
// sparse coefficient-matrix packer (reference: src/Lasso.cpp:22-30,
// write_beta_matrix).  Device-side math lives in XLA; these
// kernels serve the host data path: preparing feeds and packing results
// without round-tripping through Python loops.
//
// Design notes:
//  * plain portable C++ with OpenMP; -O3 -march=native lets the compiler
//    emit the same AVX/FMA the reference hand-codes;
//  * exported as a C ABI for ctypes (no pybind11 in this image);
//  * all buffers are caller-allocated; packers return element counts.

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Column-wise fused mean/sd (1/n denominator, glmnet convention) and
// in-place standardization of a column-major n x p matrix.
// flag semantics match DataStd (reference: src/DataStd.h:21-29):
//   0: no-op  1: scale only  2: center only  3: center + scale
void admm_standardize_cols(double* X, int64_t n, int64_t p, int flag,
                           double* mean_out, double* scale_out) {
    if (flag == 0) {
        for (int64_t j = 0; j < p; ++j) { mean_out[j] = 0.0; scale_out[j] = 1.0; }
        return;
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t j = 0; j < p; ++j) {
        double* col = X + j * n;
        double s = 0.0;
        for (int64_t i = 0; i < n; ++i) s += col[i];
        const double mean = s / double(n);
        // Centered two-pass variance: E[x^2]-E[x]^2 cancels
        // catastrophically for large-mean columns (same fix as the
        // device path, admm_tpu/data/standardize.py::_sd_n).
        double css = 0.0;
        for (int64_t i = 0; i < n; ++i) {
            const double c = col[i] - mean;
            css += c * c;
        }
        const double sd = std::sqrt(css / double(n));
        // Relative zero-variance guard: a constant column's computed sd
        // is rounding noise ~eps*|mean|, not exactly 0.
        const double floor_ = 8.0 * 2.220446049250313e-16 * std::fabs(mean);
        const bool center = (flag & 2) != 0;
        const bool scale = (flag & 1) != 0;
        const bool sd_ok = sd > floor_;
        const double m = center ? mean : 0.0;
        const double inv = scale && sd_ok ? 1.0 / sd : 1.0;
        mean_out[j] = m;
        scale_out[j] = scale && sd_ok ? sd : 1.0;
        for (int64_t i = 0; i < n; ++i)
            col[i] = (col[i] - m) * inv;
    }
}

// Vector mean/sd with the same convention; standardizes in place per flag.
void admm_standardize_vec(double* y, int64_t n, int flag, double* mean_out,
                          double* scale_out) {
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) s += y[i];
    const double mean = s / double(n);
    double css = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const double c = y[i] - mean;
        css += c * c;
    }
    const double sd_c = std::sqrt(css / double(n));
    const double floor_ = 8.0 * 2.220446049250313e-16 * std::fabs(mean);
    double m = 0.0, sd = 1.0;
    if (flag == 1) {  // scale by sd about the mean, do not center
        sd = sd_c > floor_ ? sd_c : 1.0;
    } else if (flag >= 2) {  // center, then scale by rms of centered
        m = mean;
        sd = sd_c > floor_ ? sd_c : 1.0;
    }
    *mean_out = m;
    *scale_out = sd;
    if (flag != 0) {
        const double inv = 1.0 / sd;
        for (int64_t i = 0; i < n; ++i) y[i] = (y[i] - m) * inv;
    }
}

// Pack a dense row-major (nlambda, p+1) coefficient-path matrix
// (column 0 = intercept) into CSC arrays of the reference's
// (p+1) x nlambda sparse beta layout (reference: src/Lasso.cpp:22-30).
// Returns nnz.  indptr has nlambda+1 entries; indices/data must have
// room for nlambda*(p+1) entries (worst case).
int64_t admm_pack_beta_csc(const double* dense, int64_t nlambda,
                           int64_t p1, double drop_tol, int64_t* indptr,
                           int32_t* indices, double* data) {
    int64_t nnz = 0;
    indptr[0] = 0;
    for (int64_t l = 0; l < nlambda; ++l) {
        const double* row = dense + l * p1;
        for (int64_t i = 0; i < p1; ++i) {
            const double v = row[i];
            if (i == 0 ? v != 0.0 : std::fabs(v) > drop_tol) {
                indices[nnz] = int32_t(i);
                data[nnz] = v;
                ++nnz;
            }
        }
        indptr[l + 1] = nnz;
    }
    return nnz;
}

int admm_native_version() { return 2; }

}  // extern "C"
