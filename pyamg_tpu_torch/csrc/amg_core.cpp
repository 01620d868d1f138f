// Host kernels of the setup phase: the sequential graph algorithms and the
// single-pass CSR transforms that the AMG setup runs on the CPU while the card
// waits.  Flat extern-C entry points over raw CSR arrays, bound with ctypes by
// pyamg_tpu_torch/amg_core; every function has an index-width-generic body
// and, where scipy's native int32 index arrays are common, an `_i32` entry
// beside the int64 one so that no index array is widened on the way in.
//
//   * standard_aggregation     -- 3-pass greedy aggregation
//   * naive_aggregation        -- single-pass greedy aggregation
//   * gauss_seidel_indexed     -- ordered in-place Gauss-Seidel sweep
//   * gauss_seidel_sweeps      -- natural-order sweeps, iteration loop inside
//   * first_fit_coloring       -- greedy first-fit vertex coloring
//   * dia_offsets, csr_to_dia  -- CSR to diagonal storage in two passes
//   * identity_minus_rowscaled -- S = I - c D^-1 A on A's own pattern
//   * classical_strength       -- classical strength of connection, one pass
//
// Build: g++ -O3 -shared -fPIC -std=c++17 [-fopenmp] amg_core.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

using I = int64_t;

// ---------------------------------------------------------------------------
// 3-pass greedy standard aggregation over a strength graph (CSR, no diag
// needed).  labels out: aggregate id or -1 (isolated); roots out (size n,
// first *n_roots entries valid).
// ---------------------------------------------------------------------------
template <typename Ix>
static void standard_aggregation_impl(I n, const Ix* Cp, const Ix* Cj,
                          I* labels, I* roots, I* n_roots) {
    std::fill(labels, labels + n, (I)-1);
    I next = 0, nr = 0;

    // pass 1
    for (I i = 0; i < n; i++) {
        if (labels[i] != -1) continue;
        bool has_nbr = false, free_nbhd = true;
        for (I jj = Cp[i]; jj < Cp[i + 1]; jj++) {
            I j = Cj[jj];
            if (j == i) continue;
            has_nbr = true;
            if (labels[j] != -1) { free_nbhd = false; break; }
        }
        if (!has_nbr) { labels[i] = -2; continue; }    // isolated
        if (free_nbhd) {
            labels[i] = next;
            roots[nr++] = i;
            for (I jj = Cp[i]; jj < Cp[i + 1]; jj++) {
                I j = Cj[jj];
                if (j != i) labels[j] = next;
            }
            next++;
        }
    }
    // pass 2: join a neighboring aggregate
    std::vector<I> join(n, -1);
    for (I i = 0; i < n; i++) {
        if (labels[i] != -1) continue;
        for (I jj = Cp[i]; jj < Cp[i + 1]; jj++) {
            I j = Cj[jj];
            if (j != i && labels[j] >= 0) { join[i] = labels[j]; break; }
        }
    }
    for (I i = 0; i < n; i++)
        if (join[i] >= 0) labels[i] = join[i];
    // pass 3: leftovers seed new aggregates
    for (I i = 0; i < n; i++) {
        if (labels[i] != -1) continue;
        labels[i] = next;
        roots[nr++] = i;
        for (I jj = Cp[i]; jj < Cp[i + 1]; jj++) {
            I j = Cj[jj];
            if (j != i && labels[j] == -1) labels[j] = next;
        }
        next++;
    }
    for (I i = 0; i < n; i++)
        if (labels[i] == -2) labels[i] = -1;
    *n_roots = nr;
}

extern "C" {

void standard_aggregation(I n, const I* Cp, const I* Cj,
                          I* labels, I* roots, I* n_roots) {
    standard_aggregation_impl<I>(n, Cp, Cj, labels, roots, n_roots);
}

void standard_aggregation_i32(I n, const int32_t* Cp, const int32_t* Cj,
                              I* labels, I* roots, I* n_roots) {
    standard_aggregation_impl<int32_t>(n, Cp, Cj, labels, roots, n_roots);
}

// single-pass greedy aggregation
void naive_aggregation(I n, const I* Cp, const I* Cj,
                       I* labels, I* roots, I* n_roots) {
    std::fill(labels, labels + n, (I)-1);
    I next = 0, nr = 0;
    for (I i = 0; i < n; i++) {
        if (labels[i] != -1) continue;
        labels[i] = next;
        roots[nr++] = i;
        for (I jj = Cp[i]; jj < Cp[i + 1]; jj++) {
            I j = Cj[jj];
            if (labels[j] == -1) labels[j] = next;
        }
        next++;
    }
    *n_roots = nr;
}

// ---------------------------------------------------------------------------
// in-place Gauss-Seidel over an ordered index list (CSR, double)
// ---------------------------------------------------------------------------
void gauss_seidel_indexed(I n_idx, const I* order,
                          const I* Ap, const I* Aj, const double* Ax,
                          double* x, const double* b) {
    for (I t = 0; t < n_idx; t++) {
        I i = order[t];
        double diag = 0.0, rsum = 0.0;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            I j = Aj[jj];
            if (j == i) diag = Ax[jj];
            else rsum += Ax[jj] * x[j];
        }
        if (diag != 0.0) x[i] = (b[i] - rsum) / diag;
    }
}

// Natural-order GS sweeps with the iteration loop inside the call: one
// library crossing per relaxation call instead of one per sweep.
// mode: 0=forward, 1=backward, 2=symmetric.
}  // extern "C"

template <typename Ix>
static void gauss_seidel_sweeps_impl(I n, const Ix* Ap, const Ix* Aj,
                         const double* Ax,
                         double* x, const double* b, I iterations, I mode) {
    auto fwd = [&]() {
        for (I i = 0; i < n; i++) {
            double diag = 0.0, rsum = 0.0;
            for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
                I j = Aj[jj];
                if (j == i) diag = Ax[jj];
                else rsum += Ax[jj] * x[j];
            }
            if (diag != 0.0) x[i] = (b[i] - rsum) / diag;
        }
    };
    auto bwd = [&]() {
        for (I i = n - 1; i >= 0; i--) {
            double diag = 0.0, rsum = 0.0;
            for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
                I j = Aj[jj];
                if (j == i) diag = Ax[jj];
                else rsum += Ax[jj] * x[j];
            }
            if (diag != 0.0) x[i] = (b[i] - rsum) / diag;
        }
    };
    for (I it = 0; it < iterations; it++) {
        if (mode == 0 || mode == 2) fwd();
        if (mode == 1 || mode == 2) bwd();
    }
}

extern "C" {

void gauss_seidel_sweeps(I n, const I* Ap, const I* Aj, const double* Ax,
                         double* x, const double* b, I iterations, I mode) {
    gauss_seidel_sweeps_impl<I>(n, Ap, Aj, Ax, x, b, iterations, mode);
}

void gauss_seidel_sweeps_i32(I n, const int32_t* Ap, const int32_t* Aj,
                             const double* Ax, double* x, const double* b,
                             I iterations, I mode) {
    gauss_seidel_sweeps_impl<int32_t>(n, Ap, Aj, Ax, x, b, iterations, mode);
}

// ---------------------------------------------------------------------------
// greedy first-fit vertex coloring: one pass in index order, each vertex
// takes the smallest color unused by its already-colored neighbors.
// Produces at most max_degree+1 colors -- usually fewer than Jones-Plassmann
// rounds, which also means fewer sequential sub-sweeps in the multicolor
// device smoothers.
// ---------------------------------------------------------------------------
void first_fit_coloring(I n, const I* Ap, const I* Aj, int32_t* colors) {
    I max_deg = 0;
    for (I i = 0; i < n; i++) max_deg = std::max(max_deg, Ap[i + 1] - Ap[i]);
    std::vector<I> mark(static_cast<size_t>(max_deg) + 2,
                        std::numeric_limits<I>::max());
    for (I i = 0; i < n; i++) colors[i] = -1;
    for (I i = 0; i < n; i++) {
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            const int32_t cj = colors[Aj[jj]];
            if (cj >= 0 && static_cast<size_t>(cj) < mark.size()) mark[cj] = i;
        }
        int32_t c = 0;
        while (mark[c] == i) c++;
        colors[i] = c;
    }
}

// ---------------------------------------------------------------------------
// CSR -> DIA conversion in two single-stream passes:
//   dia_offsets  -- discover the distinct diagonals (sorted); returns count
//                   or -1 if more than max_offsets
//   csr_to_dia_f64 / _f32 -- scatter values into caller-zeroed (k, n)
//                   diagonal arrays, casting once on the fly
// ---------------------------------------------------------------------------
}  // extern "C"

template <typename Ix>
static I dia_offsets_impl(I n, I m, const Ix* Ap, const Ix* Aj,
                          I max_offsets, I* offsets_out) {
    std::vector<char> present(n + m + 1, 0);
    for (I i = 0; i < n; i++)
        for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++)
            present[(I)Aj[jj] - i + n] = 1;
    I k = 0;
    for (I t = 0; t < (I)present.size(); t++) {
        if (!present[t]) continue;
        if (k >= max_offsets) return -1;
        offsets_out[k++] = t - n;
    }
    return k;
}

template <typename Ix, typename T>
static void csr_to_dia_impl(I n, I m, const Ix* Ap, const Ix* Aj,
                            const double* Ax,
                            I k, const I* offsets, T* diags) {
    std::vector<int32_t> lut(n + m + 1, -1);
    for (I t = 0; t < k; t++) lut[offsets[t] + n] = (int32_t)t;
    for (I i = 0; i < n; i++)
        for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            const I slot = lut[(I)Aj[jj] - i + n];
            diags[slot * n + i] = (T)Ax[jj];
        }
}

extern "C" {

I dia_offsets(I n, I m, const I* Ap, const I* Aj,
              I max_offsets, I* offsets_out) {
    return dia_offsets_impl<I>(n, m, Ap, Aj, max_offsets, offsets_out);
}

I dia_offsets_i32(I n, I m, const int32_t* Ap, const int32_t* Aj,
                  I max_offsets, I* offsets_out) {
    return dia_offsets_impl<int32_t>(n, m, Ap, Aj, max_offsets,
                                     offsets_out);
}

void csr_to_dia_f64(I n, I m, const I* Ap, const I* Aj, const double* Ax,
                    I k, const I* offsets, double* diags) {
    csr_to_dia_impl<I, double>(n, m, Ap, Aj, Ax, k, offsets, diags);
}

void csr_to_dia_f32(I n, I m, const I* Ap, const I* Aj, const double* Ax,
                    I k, const I* offsets, float* diags) {
    csr_to_dia_impl<I, float>(n, m, Ap, Aj, Ax, k, offsets, diags);
}

void csr_to_dia_f64_i32(I n, I m, const int32_t* Ap, const int32_t* Aj,
                        const double* Ax, I k, const I* offsets,
                        double* diags) {
    csr_to_dia_impl<int32_t, double>(n, m, Ap, Aj, Ax, k, offsets, diags);
}

void csr_to_dia_f32_i32(I n, I m, const int32_t* Ap, const int32_t* Aj,
                        const double* Ax, I k, const I* offsets,
                        float* diags) {
    csr_to_dia_impl<int32_t, float>(n, m, Ap, Aj, Ax, k, offsets, diags);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// S = I - c * diag(Dinv) * A on A's own pattern (row scaling): the
// prolongation-smoother matrix of the structured SA path.  Returns the
// number of rows holding a stored diagonal (callers fall back to an
// explicit SpADD when < n).  Association matches the numpy expression
// ((-c) * Dinv_i) * A_ij bit-for-bit.
// ---------------------------------------------------------------------------
template <typename Ix>
static I identity_minus_rowscaled_impl(I n, const Ix* Ap, const Ix* Aj,
                                       const double* Ax, const double* Dinv,
                                       double c, double* Sx) {
    I diag_rows = 0;
    for (I i = 0; i < n; i++) {
        const double s = (-c) * Dinv[i];
        bool has_diag = false;
        for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            double v = s * Ax[jj];
            if ((I)Aj[jj] == i) { v += 1.0; has_diag = true; }
            Sx[jj] = v;
        }
        diag_rows += has_diag;
    }
    return diag_rows;
}

// ---------------------------------------------------------------------------
// classical strength of connection with the magnitude, the filter and the
// row scaling in ONE pass: keep j == i or |a_ij| >= theta * max_{k != i}
// |a_ik|, store |a_ij|, scale each row so its largest kept entry is 1.
// Stored zeros are dropped.  A sorted CSR; emits CSR S (capacity A.nnz).
// Returns nnz written.
// ---------------------------------------------------------------------------
template <typename Ix>
static I classical_strength_impl(I n, const Ix* Ap, const Ix* Aj,
                     const double* Ax,
                     double theta, Ix* Sp, Ix* Sj, double* Sx) {
    I nnz = 0;
    Sp[0] = 0;
    for (I i = 0; i < n; i++) {
        double rowmax = 0.0;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++)
            if (Aj[jj] != i) rowmax = std::max(rowmax, std::fabs(Ax[jj]));
        const double thresh = theta * rowmax;
        const I row_start = nnz;
        double kept_max = 0.0;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            const double m = std::fabs(Ax[jj]);
            if (m == 0.0) continue;                  // eliminate_zeros
            if (Aj[jj] != i && m < thresh) continue;
            Sj[nnz] = Aj[jj];
            Sx[nnz++] = m;
            kept_max = std::max(kept_max, m);
        }
        if (kept_max != 0.0) {
            const double s = 1.0 / kept_max;
            for (I jj = row_start; jj < nnz; jj++) Sx[jj] *= s;
        }
        Sp[i + 1] = nnz;
    }
    return nnz;
}

extern "C" {

I identity_minus_rowscaled(I n, const I* Ap, const I* Aj, const double* Ax,
                           const double* Dinv, double c, double* Sx) {
    return identity_minus_rowscaled_impl<I>(n, Ap, Aj, Ax, Dinv, c, Sx);
}

I identity_minus_rowscaled_i32(I n, const int32_t* Ap, const int32_t* Aj,
                               const double* Ax, const double* Dinv,
                               double c, double* Sx) {
    return identity_minus_rowscaled_impl<int32_t>(n, Ap, Aj, Ax, Dinv, c,
                                                  Sx);
}

I classical_strength(I n, const I* Ap, const I* Aj, const double* Ax,
                     double theta, I* Sp, I* Sj, double* Sx) {
    return classical_strength_impl<I>(n, Ap, Aj, Ax, theta, Sp, Sj, Sx);
}

I classical_strength_i32(I n, const int32_t* Ap, const int32_t* Aj,
                         const double* Ax, double theta,
                         int32_t* Sp, int32_t* Sj, double* Sx) {
    return classical_strength_impl<int32_t>(n, Ap, Aj, Ax, theta, Sp, Sj,
                                            Sx);
}

}  // extern "C"
