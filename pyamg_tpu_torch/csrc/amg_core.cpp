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
//   * gauss_seidel_kaczmarz    -- Kaczmarz row projections (Gauss-Seidel on
//                                 A A^H), forward order
//   * first_fit_coloring       -- greedy first-fit vertex coloring
//   * dia_offsets, csr_to_dia  -- CSR to diagonal storage in two passes
//   * identity_minus_rowscaled -- S = I - c D^-1 A on A's own pattern
//   * weak_axis_filter         -- A without its strong-axis couplings
//                                 (jacobi_weak prolongation smoothing)
//   * classical_strength       -- classical strength of connection, one pass
//   * bsr_gauss_seidel         -- block Gauss-Seidel sweep over BSR storage
//   * masked_spgemm_rr         -- (A B) on a given CSR pattern only
//   * constraint_project,      -- the energy-minimization CG's projection
//     pattern_gram                U B = 0 and its per-row Gram matrices
//   * masked_spgemm_bsr,       -- the same three on a block pattern, for
//     constraint_project_bsr,     the blocked (BSR) energy CG
//     pattern_gram_bsr
//   * rs_cf_splitting          -- Ruge-Stuben C/F splitting
//   * identity_minus_scaled,   -- I - c M and I - c A D^-1 on the operand's
//     identity_minus_colscaled    own pattern (the evolution measure's step)
//   * pattern_values           -- A's values on a sorted pattern
//   * evolution_nulldim1,      -- the evolution measure's one-candidate fit,
//     distance_filter,            its distance filter and its fused tail
//     evolution_epilogue
//   * direct_interpolation,    -- classical interpolation, one pass each
//     standard_interpolation
//   * thomas_lines             -- batched tridiagonal solves (line smoothers)
//   * bellman_ford             -- shortest |weight| distances from a seed set
//                                 (Lloyd aggregation)
//   * bfs_levels               -- breadth-first levels from one seed
//   * drake_matching_core      -- path-growing weighted matching (pairwise
//                                 aggregation)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 [-fopenmp] amg_core.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
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

// Gauss-Seidel on the normal equations A A^H (Kaczmarz): each row in turn,
// x += omega (b_i - a_i x) / |a_i|^2 a_i; a row of zeros is skipped.
template <typename Ix>
static void gauss_seidel_kaczmarz_impl(I n, const Ix* Ap, const Ix* Aj,
                                       const double* Ax, double* x,
                                       const double* b, double omega) {
    for (I i = 0; i < n; i++) {
        double rn = 0.0, ri = b[i];
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            rn += Ax[jj] * Ax[jj];
            ri -= Ax[jj] * x[Aj[jj]];
        }
        if (rn == 0.0) continue;
        double c = omega * ri / rn;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++)
            x[Aj[jj]] += c * Ax[jj];
    }
}

extern "C" {

void gauss_seidel_kaczmarz(I n, const I* Ap, const I* Aj, const double* Ax,
                           double* x, const double* b, double omega) {
    gauss_seidel_kaczmarz_impl<I>(n, Ap, Aj, Ax, x, b, omega);
}

void gauss_seidel_kaczmarz_i32(I n, const int32_t* Ap, const int32_t* Aj,
                               const double* Ax, double* x, const double* b,
                               double omega) {
    gauss_seidel_kaczmarz_impl<int32_t>(n, Ap, Aj, Ax, x, b, omega);
}

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
// Weak-axis stencil filter of the structured path's jacobi_weak smoother:
// keep only the entries whose NODE offset moves along no uncoarsened
// (coarsened_desc[k] == 0) grid axis, written as compacted CSR.  The node
// offset is split over the axes in descending-stride order with
// dk = rint(rem / stride) (round half to even, as np.rint) and
// rem -= dk * stride, as the numpy form does.  Returns the output nnz.
// ---------------------------------------------------------------------------
template <typename Ix>
static I weak_axis_filter_impl(I n, const Ix* Ap, const Ix* Aj,
                               const double* Ax, I q, I naxes,
                               const int64_t* strides_desc,
                               const int64_t* coarsened_desc,
                               Ix* Bp, Ix* Bj, double* Bx) {
    I out = 0;
    Bp[0] = 0;
    for (I i = 0; i < n; i++) {
        const int64_t node_i = i / q;
        for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            int64_t rem = (int64_t)Aj[jj] / q - node_i;
            bool keep = true;
            for (I k = 0; k < naxes; k++) {
                const double s = (double)strides_desc[k];
                const int64_t dk = (int64_t)std::nearbyint((double)rem / s);
                rem -= dk * strides_desc[k];
                if (!coarsened_desc[k] && dk != 0) { keep = false; break; }
            }
            if (keep) {
                Bj[out] = Aj[jj];
                Bx[out] = Ax[jj];
                out++;
            }
        }
        Bp[i + 1] = (Ix)out;
    }
    return out;
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

I weak_axis_filter(I n, const I* Ap, const I* Aj, const double* Ax,
                   I q, I naxes, const int64_t* strides_desc,
                   const int64_t* coarsened_desc,
                   I* Bp, I* Bj, double* Bx) {
    return weak_axis_filter_impl<I>(n, Ap, Aj, Ax, q, naxes, strides_desc,
                                    coarsened_desc, Bp, Bj, Bx);
}

I weak_axis_filter_i32(I n, const int32_t* Ap, const int32_t* Aj,
                       const double* Ax, I q, I naxes,
                       const int64_t* strides_desc,
                       const int64_t* coarsened_desc,
                       int32_t* Bp, int32_t* Bj, double* Bx) {
    return weak_axis_filter_impl<int32_t>(n, Ap, Aj, Ax, q, naxes,
                                          strides_desc, coarsened_desc,
                                          Bp, Bj, Bx);
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

// ---------------------------------------------------------------------------
// block Gauss-Seidel sweep over BSR storage: for each block row i in
// [start, stop) by step,  x_i = Dinv_i * (b_i - sum_{j != i} A_ij x_j).
// data: (nnzb, bs, bs) row-major blocks; Dinv: (nb, bs, bs).
// ---------------------------------------------------------------------------
extern "C" {

void bsr_gauss_seidel(I nb, I bs,
                      const I* indptr, const I* indices, const double* data,
                      const double* Dinv,
                      double* x, const double* b,
                      I start, I stop, I step) {
    (void)nb;
    const I bb = bs * bs;
    std::vector<double> rhs(bs);
    for (I i = start; step > 0 ? i < stop : i > stop; i += step) {
        for (I k = 0; k < bs; k++) rhs[k] = b[i * bs + k];
        for (I jj = indptr[i]; jj < indptr[i + 1]; jj++) {
            const I j = indices[jj];
            if (j == i) continue;
            const double* blk = data + jj * bb;
            const double* xj = x + j * bs;
            for (I r = 0; r < bs; r++) {
                double acc = 0.0;
                for (I c = 0; c < bs; c++) acc += blk[r * bs + c] * xj[c];
                rhs[r] -= acc;
            }
        }
        const double* dinv = Dinv + i * bb;
        double* xi = x + i * bs;
        for (I r = 0; r < bs; r++) {
            double acc = 0.0;
            for (I c = 0; c < bs; c++) acc += dinv[r * bs + c] * rhs[c];
            xi[r] = acc;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// masked (pattern-restricted) sparse product, row-scatter form:
// C_ij = sum_k A_ik B_kj for (i, j) in C's pattern only.  Row i tags its
// output slots in a dense slot map; A row i's entries stream B's rows into
// the tagged slots.  All three operands CSR; Cx must be caller-zeroed.
// ---------------------------------------------------------------------------
template <typename Ix>
static void masked_spgemm_rr_impl(I n_row, I n_col,
                                  const Ix* Ap, const Ix* Aj,
                                  const double* Ax,
                                  const Ix* Bp, const Ix* Bj,
                                  const double* Bx,
                                  const Ix* Cp, const Ix* Cj, double* Cx) {
    std::vector<int64_t> slot(n_col, -1);
    for (I i = 0; i < n_row; i++) {
        for (Ix cc = Cp[i]; cc < Cp[i + 1]; cc++) slot[Cj[cc]] = cc;
        for (Ix ka = Ap[i]; ka < Ap[i + 1]; ka++) {
            const Ix k = Aj[ka];
            const double a = Ax[ka];
            for (Ix kb = Bp[k]; kb < Bp[k + 1]; kb++) {
                const int64_t s = slot[Bj[kb]];
                if (s >= 0) Cx[s] += a * Bx[kb];
            }
        }
        for (Ix cc = Cp[i]; cc < Cp[i + 1]; cc++) slot[Cj[cc]] = -1;
    }
}

// ---------------------------------------------------------------------------
// in-place constraint projection of pattern values so that U B = 0 row by
// row (skipping fmask == 0 rows, which are zeroed):
//   ub    = sum_{e in row} vals[e] * B[col[e], :]
//   coef  = BtBinv[i] @ ub
//   vals[e] -= coef . B[col[e], :]
// ---------------------------------------------------------------------------
template <typename Ix>
static void constraint_project_impl(Ix n, I k,
                                    const Ix* Pp, const Ix* Pj,
                                    const double* B,        // (ncols, k)
                                    const double* BtBinv,   // (n, k, k)
                                    const uint8_t* fmask,   // nullable (n,)
                                    double* vals) {
    constexpr I KMAX = 16;
    #pragma omp parallel for schedule(static)
    for (Ix i = 0; i < n; ++i) {
        double ub[KMAX], coef[KMAX];
        const Ix s = Pp[i], e = Pp[i + 1];
        if (fmask && !fmask[i]) {
            for (Ix p = s; p < e; ++p) vals[p] = 0.0;
            continue;
        }
        for (I t = 0; t < k; ++t) ub[t] = 0.0;
        for (Ix p = s; p < e; ++p) {
            const double v = vals[p];
            const double* brow = B + (size_t)Pj[p] * k;
            for (I t = 0; t < k; ++t) ub[t] += v * brow[t];
        }
        const double* M = BtBinv + (size_t)i * k * k;
        for (I t = 0; t < k; ++t) {
            double acc = 0.0;
            for (I l = 0; l < k; ++l) acc += M[t * k + l] * ub[l];
            coef[t] = acc;
        }
        for (Ix p = s; p < e; ++p) {
            const double* brow = B + (size_t)Pj[p] * k;
            double acc = 0.0;
            for (I t = 0; t < k; ++t) acc += coef[t] * brow[t];
            vals[p] -= acc;
        }
    }
}

// per-row Gram matrices over a CSR pattern: out[i] = sum_{e in row i}
// B_e B_e^T, without the padded (n, L, k) gather numpy pays.
template <typename Ix>
static void pattern_gram_impl(Ix n, I k,
                              const Ix* Pp, const Ix* Pj,
                              const double* B,      // (ncols, k)
                              double* out) {        // (n, k, k)
    #pragma omp parallel for schedule(static)
    for (Ix i = 0; i < n; ++i) {
        double* G = out + (size_t)i * k * k;
        for (I t = 0; t < k * k; ++t) G[t] = 0.0;
        for (Ix p = Pp[i]; p < Pp[i + 1]; ++p) {
            const double* brow = B + (size_t)Pj[p] * k;
            for (I t = 0; t < k; ++t) {
                const double bt = brow[t];
                for (I l = t; l < k; ++l)
                    G[t * k + l] += bt * brow[l];
            }
        }
        for (I t = 0; t < k; ++t)       // symmetrize the upper triangle
            for (I l = 0; l < t; ++l)
                G[t * k + l] = G[l * k + t];
    }
}

// ---------------------------------------------------------------------------
// blocked energy-minimization kernels: the energy CG on a node-blocked
// problem keeps every iterate as dense (R x Cb) blocks on the BLOCK pattern,
// with one Gram per block row (all R scalar rows of a block row share the
// same column set).
// ---------------------------------------------------------------------------

// C = (A @ B) restricted to C's BLOCK pattern.  A: (nbr x nbr) blocks RxR
// row-major; B, C: (nbr x nbc) blocks RxCb.  Cx must be caller-zeroed.
// RT/CT > 0 bake the block shape in at compile time (the dispatcher
// instantiates the elasticity shapes); -1 reads the runtime arguments.
template <int RT, int CT, typename Ix>
static void masked_spgemm_bsr_body(I nbr, I nbc, I R_, I Cb_,
                                   const Ix* Ap, const Ix* Aj,
                                   const double* Ax,
                                   const Ix* Bp, const Ix* Bj,
                                   const double* Bx,
                                   const Ix* Cp, const Ix* Cj, double* Cx) {
    const I R = RT > 0 ? (I)RT : R_;
    const I Cb = CT > 0 ? (I)CT : Cb_;
    std::vector<int64_t> slot(nbc, -1);
    for (I i = 0; i < nbr; i++) {
        for (Ix cc = Cp[i]; cc < Cp[i + 1]; cc++) slot[Cj[cc]] = cc;
        for (Ix ka = Ap[i]; ka < Ap[i + 1]; ka++) {
            const double* a = Ax + (size_t)ka * R * R;
            const Ix k = Aj[ka];
            for (Ix kb = Bp[k]; kb < Bp[k + 1]; kb++) {
                const int64_t s = slot[Bj[kb]];
                if (s < 0) continue;
                const double* b = Bx + (size_t)kb * R * Cb;
                double* c = Cx + (size_t)s * R * Cb;
                for (I r = 0; r < R; r++)
                    for (I t = 0; t < R; t++) {
                        const double av = a[r * R + t];
                        for (I q = 0; q < Cb; q++)
                            c[r * Cb + q] += av * b[t * Cb + q];
                    }
            }
        }
        for (Ix cc = Cp[i]; cc < Cp[i + 1]; cc++) slot[Cj[cc]] = -1;
    }
}

template <typename Ix>
static void masked_spgemm_bsr_impl(I nbr, I nbc, I R, I Cb,
                                   const Ix* Ap, const Ix* Aj,
                                   const double* Ax,
                                   const Ix* Bp, const Ix* Bj,
                                   const double* Bx,
                                   const Ix* Cp, const Ix* Cj, double* Cx) {
    // R = spatial dofs, Cb = rigid-body-mode count (2D / 3D elasticity)
    if (R == 2 && Cb == 3)
        masked_spgemm_bsr_body<2, 3, Ix>(nbr, nbc, R, Cb, Ap, Aj, Ax,
                                         Bp, Bj, Bx, Cp, Cj, Cx);
    else if (R == 2 && Cb == 2)
        masked_spgemm_bsr_body<2, 2, Ix>(nbr, nbc, R, Cb, Ap, Aj, Ax,
                                         Bp, Bj, Bx, Cp, Cj, Cx);
    else if (R == 3 && Cb == 6)
        masked_spgemm_bsr_body<3, 6, Ix>(nbr, nbc, R, Cb, Ap, Aj, Ax,
                                         Bp, Bj, Bx, Cp, Cj, Cx);
    else if (R == 3 && Cb == 3)
        masked_spgemm_bsr_body<3, 3, Ix>(nbr, nbc, R, Cb, Ap, Aj, Ax,
                                         Bp, Bj, Bx, Cp, Cj, Cx);
    else
        masked_spgemm_bsr_body<-1, -1, Ix>(nbr, nbc, R, Cb, Ap, Aj, Ax,
                                           Bp, Bj, Bx, Cp, Cj, Cx);
}

// in-place projection of BLOCKED pattern values so that U @ B == 0 row by
// row.  vals: (nnzb, R, Cb); B: (nbc*Cb, k) scalar coarse candidates; G:
// (nbr, k, k) per-block-row Gram pinv; fmask: nullable per-SCALAR-row keep
// mask.
template <typename Ix>
static void constraint_project_bsr_impl(I nbr, I R, I Cb, I k,
                                        const Ix* Pp, const Ix* Pj,
                                        const double* B,
                                        const double* G,
                                        const uint8_t* fmask,
                                        double* vals) {
    constexpr I KMAX = 16;
    const I rc = R * Cb;
    #pragma omp parallel for schedule(static)
    for (I i = 0; i < nbr; i++) {
        double ub[KMAX], coef[KMAX];
        const Ix s = Pp[i], e = Pp[i + 1];
        const double* M = G + (size_t)i * k * k;
        for (I r = 0; r < R; r++) {
            if (fmask && !fmask[i * R + r]) {
                for (Ix p = s; p < e; p++) {
                    double* v = vals + (size_t)p * rc + (size_t)r * Cb;
                    for (I q = 0; q < Cb; q++) v[q] = 0.0;
                }
                continue;
            }
            for (I t = 0; t < k; t++) ub[t] = 0.0;
            for (Ix p = s; p < e; p++) {
                const double* v = vals + (size_t)p * rc + (size_t)r * Cb;
                const double* brow = B + (size_t)Pj[p] * Cb * k;
                for (I q = 0; q < Cb; q++)
                    for (I t = 0; t < k; t++)
                        ub[t] += v[q] * brow[q * k + t];
            }
            for (I t = 0; t < k; t++) {
                double acc = 0.0;
                for (I l = 0; l < k; l++) acc += M[t * k + l] * ub[l];
                coef[t] = acc;
            }
            for (Ix p = s; p < e; p++) {
                double* v = vals + (size_t)p * rc + (size_t)r * Cb;
                const double* brow = B + (size_t)Pj[p] * Cb * k;
                for (I q = 0; q < Cb; q++) {
                    double acc = 0.0;
                    for (I t = 0; t < k; t++)
                        acc += coef[t] * brow[q * k + t];
                    v[q] -= acc;
                }
            }
        }
    }
}

// per-BLOCK-row Gram over a block pattern: out[i] = sum over the scalar
// columns {Pj[p]*Cb + q} of B_col B_col^T.
template <typename Ix>
static void pattern_gram_bsr_impl(I nbr, I Cb, I k,
                                  const Ix* Pp, const Ix* Pj,
                                  const double* B,     // (nbc*Cb, k)
                                  double* out) {       // (nbr, k, k)
    #pragma omp parallel for schedule(static)
    for (I i = 0; i < nbr; i++) {
        double* G = out + (size_t)i * k * k;
        for (I t = 0; t < k * k; t++) G[t] = 0.0;
        for (Ix p = Pp[i]; p < Pp[i + 1]; p++) {
            const double* brows = B + (size_t)Pj[p] * Cb * k;
            for (I q = 0; q < Cb; q++) {
                const double* brow = brows + (size_t)q * k;
                for (I t = 0; t < k; t++) {
                    const double bt = brow[t];
                    for (I l = t; l < k; l++)
                        G[t * k + l] += bt * brow[l];
                }
            }
        }
        for (I t = 0; t < k; t++)
            for (I l = 0; l < t; l++)
                G[t * k + l] = G[l * k + t];
    }
}

extern "C" {

void masked_spgemm_rr(I n_row, I n_col,
                      const I* Ap, const I* Aj, const double* Ax,
                      const I* Bp, const I* Bj, const double* Bx,
                      const I* Cp, const I* Cj, double* Cx) {
    masked_spgemm_rr_impl<I>(n_row, n_col, Ap, Aj, Ax, Bp, Bj, Bx,
                             Cp, Cj, Cx);
}

void masked_spgemm_rr_i32(I n_row, I n_col,
                          const int32_t* Ap, const int32_t* Aj,
                          const double* Ax,
                          const int32_t* Bp, const int32_t* Bj,
                          const double* Bx,
                          const int32_t* Cp, const int32_t* Cj, double* Cx) {
    masked_spgemm_rr_impl<int32_t>(n_row, n_col, Ap, Aj, Ax, Bp, Bj, Bx,
                                   Cp, Cj, Cx);
}

void constraint_project(I n, I k, const I* Pp, const I* Pj,
                        const double* B, const double* BtBinv,
                        const uint8_t* fmask, double* vals) {
    constraint_project_impl<I>(n, k, Pp, Pj, B, BtBinv, fmask, vals);
}

void constraint_project_i32(I n, I k, const int32_t* Pp, const int32_t* Pj,
                            const double* B, const double* BtBinv,
                            const uint8_t* fmask, double* vals) {
    constraint_project_impl<int32_t>((int32_t)n, k, Pp, Pj, B, BtBinv,
                                     fmask, vals);
}

void pattern_gram(I n, I k, const I* Pp, const I* Pj,
                  const double* B, double* out) {
    pattern_gram_impl<I>(n, k, Pp, Pj, B, out);
}

void pattern_gram_i32(I n, I k, const int32_t* Pp, const int32_t* Pj,
                      const double* B, double* out) {
    pattern_gram_impl<int32_t>((int32_t)n, k, Pp, Pj, B, out);
}

void masked_spgemm_bsr(I nbr, I nbc, I R, I Cb,
                       const I* Ap, const I* Aj, const double* Ax,
                       const I* Bp, const I* Bj, const double* Bx,
                       const I* Cp, const I* Cj, double* Cx) {
    masked_spgemm_bsr_impl<I>(nbr, nbc, R, Cb, Ap, Aj, Ax,
                              Bp, Bj, Bx, Cp, Cj, Cx);
}

void masked_spgemm_bsr_i32(I nbr, I nbc, I R, I Cb,
                           const int32_t* Ap, const int32_t* Aj,
                           const double* Ax,
                           const int32_t* Bp, const int32_t* Bj,
                           const double* Bx,
                           const int32_t* Cp, const int32_t* Cj,
                           double* Cx) {
    masked_spgemm_bsr_impl<int32_t>(nbr, nbc, R, Cb, Ap, Aj, Ax,
                                    Bp, Bj, Bx, Cp, Cj, Cx);
}

void constraint_project_bsr(I nbr, I R, I Cb, I k,
                            const I* Pp, const I* Pj, const double* B,
                            const double* G, const uint8_t* fmask,
                            double* vals) {
    constraint_project_bsr_impl<I>(nbr, R, Cb, k, Pp, Pj, B, G, fmask,
                                   vals);
}

void constraint_project_bsr_i32(I nbr, I R, I Cb, I k,
                                const int32_t* Pp, const int32_t* Pj,
                                const double* B, const double* G,
                                const uint8_t* fmask, double* vals) {
    constraint_project_bsr_impl<int32_t>(nbr, R, Cb, k, Pp, Pj, B, G,
                                         fmask, vals);
}

void pattern_gram_bsr(I nbr, I Cb, I k, const I* Pp, const I* Pj,
                      const double* B, double* out) {
    pattern_gram_bsr_impl<I>(nbr, Cb, k, Pp, Pj, B, out);
}

void pattern_gram_bsr_i32(I nbr, I Cb, I k,
                          const int32_t* Pp, const int32_t* Pj,
                          const double* B, double* out) {
    pattern_gram_bsr_impl<int32_t>(nbr, Cb, k, Pp, Pj, B, out);
}

}  // extern "C"

// ===========================================================================
// Classical (Ruge-Stuben) AMG and the evolution strength measure
// ===========================================================================

// ---------------------------------------------------------------------------
// Ruge-Stuben first-pass C/F splitting.  S (dependencies, CSR, no diagonal)
// and T = S^T (influences) as index arrays; splitting out: 1 = C, 0 = F.
// Interval-list form: nodes live in one permutation array grouped by their
// weight lambda, a weight change is an O(1) swap to an interval boundary,
// and the scan walks the permutation from the high end.  Which tie is taken
// and where a re-weighted node lands decide the coarse grids of the deeper
// levels, so the boundary moves are part of the result.
// ---------------------------------------------------------------------------
template <typename Ix>
static void rs_cf_splitting_impl(I n, const Ix* Sp, const Ix* Sj,
                                 const Ix* Tp, const Ix* Tj,
                                 int32_t* splitting) {
    const int32_t U = -1, F = 0, C = 1;
    std::vector<I> lambda(n);
    for (I i = 0; i < n; i++) lambda[i] = Tp[i + 1] - Tp[i];

    std::vector<I> ivl_start(n + 2, 0), ivl_len(n + 2, 0);
    std::vector<I> at_pos(n), pos_of(n);
    for (I i = 0; i < n; i++) ivl_len[lambda[i]]++;
    for (I v = 0, acc = 0; v <= n; v++) {
        ivl_start[v] = acc;
        acc += ivl_len[v];
        ivl_len[v] = 0;
    }
    for (I i = 0; i < n; i++) {
        I p = ivl_start[lambda[i]] + ivl_len[lambda[i]]++;
        at_pos[p] = i;
        pos_of[i] = p;
    }

    std::fill(splitting, splitting + n, U);
    // isolated nodes (no influences, or only a stored self-loop) are F
    for (I i = 0; i < n; i++)
        if (lambda[i] == 0 || (lambda[i] == 1 && Tj[Tp[i]] == i))
            splitting[i] = F;

    auto swap_nodes = [&](I pa, I pb) {
        pos_of[at_pos[pa]] = pb;
        pos_of[at_pos[pb]] = pa;
        std::swap(at_pos[pa], at_pos[pb]);
    };

    for (I scan = n - 1; scan >= 0; scan--) {
        I i = at_pos[scan];
        ivl_len[lambda[i]]--;
        if (splitting[i] == F) continue;
        splitting[i] = C;
        // undecided influences of i become F; their dependencies gain
        // weight (moved to the tail boundary of their interval)
        for (I jj = Tp[i]; jj < Tp[i + 1]; jj++) {
            I j = Tj[jj];
            if (splitting[j] != U) continue;
            splitting[j] = F;
            for (I kk = Sp[j]; kk < Sp[j + 1]; kk++) {
                I k = Sj[kk];
                if (splitting[k] != U || lambda[k] >= n - 1) continue;
                I lv = lambda[k];
                I tail = ivl_start[lv] + ivl_len[lv] - 1;
                swap_nodes(pos_of[k], tail);
                ivl_len[lv]--;
                ivl_len[lv + 1]++;
                ivl_start[lv + 1] = tail;
                lambda[k]++;
            }
        }
        // undecided dependencies of i lose weight (moved to the head
        // boundary of their interval)
        for (I jj = Sp[i]; jj < Sp[i + 1]; jj++) {
            I j = Sj[jj];
            if (splitting[j] != U || lambda[j] == 0) continue;
            I lv = lambda[j];
            I head = ivl_start[lv];
            swap_nodes(pos_of[j], head);
            ivl_len[lv]--;
            ivl_len[lv - 1]++;
            ivl_start[lv]++;
            ivl_start[lv - 1] = ivl_start[lv] - ivl_len[lv - 1];
            lambda[j]--;
        }
    }
    for (I i = 0; i < n; i++)
        splitting[i] = (splitting[i] == C) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// S = I - c*M on M's own CSR pattern in one value pass (+1 at the stored
// diagonal), and S = I - c*A*diag(Dinv) (column scaling: for an exactly
// symmetric A, the transpose of I - c D^-1 A without a CSC conversion;
// -(c * (A_ij * Dinv_j)) associates as the transpose route does, so both
// give the same bits).  Each returns the number of rows with a stored
// diagonal; the caller falls back to a sparse sum when it is short of n.
// ---------------------------------------------------------------------------
template <typename Ix>
static I identity_minus_scaled_impl(I n, const Ix* Ap, const Ix* Aj,
                                    const double* Ax, double c, double* Sx) {
    I diag_rows = 0;
    for (I i = 0; i < n; i++) {
        bool has_diag = false;
        for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            double v = -c * Ax[jj];
            if ((I)Aj[jj] == i) { v += 1.0; has_diag = true; }
            Sx[jj] = v;
        }
        diag_rows += has_diag;
    }
    return diag_rows;
}

template <typename Ix>
static I identity_minus_colscaled_impl(I n, const Ix* Ap, const Ix* Aj,
                                       const double* Ax, const double* Dinv,
                                       double c, double* Sx) {
    I diag_rows = 0;
    for (I i = 0; i < n; i++) {
        bool has_diag = false;
        for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            double v = -c * (Ax[jj] * Dinv[Aj[jj]]);
            if ((I)Aj[jj] == i) { v += 1.0; has_diag = true; }
            Sx[jj] = v;
        }
        diag_rows += has_diag;
    }
    return diag_rows;
}

// ---------------------------------------------------------------------------
// out[kc] = A[i, Cj[kc]] for every entry of the sorted pattern C, by a
// two-pointer merge over each sorted A row; returns the number of pattern
// entries absent from A (the caller then takes scipy's ``multiply``).
// ---------------------------------------------------------------------------
template <typename Ix>
static I pattern_values_impl(I n, const Ix* Cp, const Ix* Cj,
                             const Ix* Ap, const Ix* Aj, const double* Ax,
                             double* out) {
    I missing = 0;
    for (I i = 0; i < n; i++) {
        Ix ka = Ap[i];
        const Ix ka_end = Ap[i + 1];
        for (Ix kc = Cp[i]; kc < Cp[i + 1]; kc++) {
            const Ix col = Cj[kc];
            while (ka < ka_end && Aj[ka] < col) ka++;
            if (ka < ka_end && Aj[ka] == col) {
                out[kc] = Ax[ka];
            } else {
                out[kc] = 0.0;
                missing++;
            }
        }
    }
    return missing;
}

// ---------------------------------------------------------------------------
// evolution strength with one candidate b: the fitted value at column j of
// row i is zhat = b_j z_ii / b_i and the stored value becomes the misfit
// |1 - zhat/z|, or 0 where the fit points against z or is below 1e-4 of
// it; misfits below `tiny` become 1e-4.  In place on Ax.
// ---------------------------------------------------------------------------
template <typename Ix>
static void evolution_nulldim1_impl(I n, const Ix* Ap, const Ix* Aj,
                                    double* Ax, const double* b1,
                                    double tiny) {
    for (I i = 0; i < n; i++) {
        double zii = 0.0;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++)
            if (Aj[jj] == i) { zii = Ax[jj]; break; }
        const double coeff = zii / b1[i];
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            const double z = Ax[jj];
            const double zhat = coeff * b1[Aj[jj]];
            const double ratio = zhat / z;          // IEEE: inf/nan ok
            const double misfit = std::abs(1.0 - ratio);
            const bool aligned = zhat * z >= 0.0;
            const bool significant = std::abs(ratio) >= 1e-4;
            double out = (aligned && significant) ? misfit : 0.0;
            if (out > 0.0 && out < tiny) out = 1e-4;
            if (!(out == out)) out = 0.0;           // NaN (z == zhat == 0)
            Ax[jj] = out;
        }
    }
}

// ---------------------------------------------------------------------------
// relative distance filter: keep off-diagonal S_ij < epsilon * min_k S_ik,
// set the stored diagonal to 1, zero the rest (the caller compacts).
// ---------------------------------------------------------------------------
template <typename Ix>
static void distance_filter_impl(I n, const Ix* Ap, const Ix* Aj, double* Ax,
                                 double epsilon) {
    for (I i = 0; i < n; i++) {
        double dmin = std::numeric_limits<double>::infinity();
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++)
            if (Aj[jj] != i && Ax[jj] < dmin) dmin = Ax[jj];
        const double thresh = epsilon * dmin;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            if (Aj[jj] == i) Ax[jj] = 1.0;
            else if (!(Ax[jj] < thresh)) Ax[jj] = 0.0;
        }
    }
}

// ---------------------------------------------------------------------------
// the tail of the evolution measure in one call: distance filter in place,
// the filtered transpose by a counting scatter, then per row the union
// 0.5 (a + a^T) with a forced unit diagonal, inverted and scaled so that
// its largest entry is 1.  Output capacity 2 nnz + n; returns nnz.
// ---------------------------------------------------------------------------
template <typename Ix>
static I evolution_epilogue_impl(I n, const Ix* Ap, const Ix* Aj, double* Ax,
                                 double eps, int symmetrize,
                                 Ix* Op, Ix* Oj, double* Ox) {
    const double inf = std::numeric_limits<double>::infinity();
    for (I i = 0; i < n; i++) {
        double dmin = inf;
        for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++)
            if ((I)Aj[jj] != i && Ax[jj] < dmin) dmin = Ax[jj];
        const double thresh = eps * dmin;
        for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            if ((I)Aj[jj] == i) Ax[jj] = 1.0;
            else if (!(Ax[jj] < thresh)) Ax[jj] = 0.0;
        }
    }

    std::vector<Ix> Tp(n + 1, 0);
    std::vector<Ix> Tj;
    std::vector<double> Tx;
    if (symmetrize) {
        for (I i = 0; i < n; i++)
            for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++)
                if (Ax[jj] != 0.0) Tp[(I)Aj[jj] + 1]++;
        for (I t = 0; t < n; t++) Tp[t + 1] += Tp[t];
        Tj.resize(Tp[n]);
        Tx.resize(Tp[n]);
        std::vector<Ix> fill(Tp.begin(), Tp.end() - 1);
        for (I i = 0; i < n; i++)
            for (Ix jj = Ap[i]; jj < Ap[i + 1]; jj++)
                if (Ax[jj] != 0.0) {
                    const Ix pos = fill[(I)Aj[jj]]++;
                    Tj[pos] = (Ix)i;
                    Tx[pos] = Ax[jj];
                }
    }

    I nnz = 0;
    Op[0] = 0;
    for (I i = 0; i < n; i++) {
        const I row_start = nnz;
        Ix ka = Ap[i], ea = Ap[i + 1];
        Ix kt = symmetrize ? Tp[i] : ea;
        const Ix et = symmetrize ? Tp[i + 1] : ea;
        bool wrote_diag = false;
        while (true) {
            while (ka < ea && Ax[ka] == 0.0) ka++;       // skip dropped
            const bool ha = ka < ea, ht = kt < et;
            if (!ha && !ht) break;
            I ja = ha ? (I)Aj[ka] : n, jt = ht ? (I)Tj[kt] : n;
            I j; double v;
            if (ja == jt)      { v = 0.5 * (Ax[ka] + Tx[kt]); j = ja;
                                 ka++; kt++; }
            else if (ja < jt)  { v = symmetrize ? 0.5 * Ax[ka] : Ax[ka];
                                 j = ja; ka++; }
            else               { v = 0.5 * Tx[kt]; j = jt; kt++; }
            if (!wrote_diag && j >= i) {
                if (j == i) { v = 1.0; wrote_diag = true; }
                else { Oj[nnz] = (Ix)i; Ox[nnz++] = 1.0; wrote_diag = true; }
            }
            Oj[nnz] = (Ix)j;
            Ox[nnz++] = v;
        }
        if (!wrote_diag) { Oj[nnz] = (Ix)i; Ox[nnz++] = 1.0; }
        double mx = 0.0;
        for (I t = row_start; t < nnz; t++) {
            Ox[t] = 1.0 / Ox[t];
            const double a = std::abs(Ox[t]);
            if (a > mx) mx = a;
        }
        if (mx != 0.0) {
            const double s = 1.0 / mx;
            for (I t = row_start; t < nnz; t++) Ox[t] *= s;
        }
        Op[i + 1] = (Ix)nnz;
    }
    return nnz;
}

// ---------------------------------------------------------------------------
// direct interpolation in one pass.  F row i: alpha = (sum of all negative
// off-diagonal a_ij) / (the same over strong C neighbours), beta likewise
// for the positive ones (all positive off-diagonal mass lumped into the
// diagonal when no strong C neighbour is positive); P_ij = -(alpha or
// beta) / d_i * a_ij over the strong C neighbours j.  C row i: a 1 at
// cmap[i].  A sorted CSR, C the strength pattern (sorted; values unused).
// Capacity C.nnz + n; returns nnz.
// ---------------------------------------------------------------------------
template <typename Ix>
static I direct_interpolation_impl(I n,
                                   const Ix* Ap, const Ix* Aj,
                                   const double* Ax,
                                   const Ix* Cp, const Ix* Cj,
                                   const int32_t* splitting, const Ix* cmap,
                                   Ix* Pp, Ix* Pj, double* Px) {
    I nnz = 0;
    Pp[0] = 0;
    for (I i = 0; i < n; i++) {
        if (splitting[i] == 1) {
            Pj[nnz] = cmap[i];
            Px[nnz++] = 1.0;
            Pp[i + 1] = nnz;
            continue;
        }
        double diag = 0.0, sum_all_neg = 0.0, sum_all_pos = 0.0;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            const double x = Ax[jj];
            if (Aj[jj] == i) diag += x;
            else if (x < 0.0) sum_all_neg += x;
            else sum_all_pos += x;
        }
        double ssn = 0.0, ssp = 0.0;
        const I ae = Ap[i + 1];
        I a = Ap[i];
        for (I cc = Cp[i]; cc < Cp[i + 1]; cc++) {
            const I j = Cj[cc];
            if (j == i || splitting[j] != 1) continue;
            while (a < ae && Aj[a] < j) a++;
            if (a < ae && Aj[a] == j) {
                const double x = Ax[a];
                if (x < 0.0) ssn += x; else ssp += x;
            }
        }
        const bool no_pos = (ssp == 0.0);
        const double d = diag + (no_pos ? sum_all_pos : 0.0);
        const double alpha = (ssn != 0.0) ? sum_all_neg / ssn : 0.0;
        const double beta = no_pos ? 0.0 : sum_all_pos / ssp;
        const double negc = -alpha / d;   // d == 0 -> inf, as in numpy
        const double posc = -beta / d;
        a = Ap[i];
        for (I cc = Cp[i]; cc < Cp[i + 1]; cc++) {
            const I j = Cj[cc];
            if (j == i || splitting[j] != 1) continue;
            while (a < ae && Aj[a] < j) a++;
            if (a < ae && Aj[a] == j) {
                const double x = Ax[a];
                Pj[nnz] = cmap[j];
                Px[nnz++] = (x < 0.0 ? negc : posc) * x;
            }
        }
        Pp[i + 1] = nnz;
    }
    return nnz;
}

// ---------------------------------------------------------------------------
// standard (distance-two) interpolation in one pass.  F row i:
// P_ik = -(a_ik + sum_j (a_ij / denom_ij) a_jk) / d_i over the strong C
// neighbours k of i, j over its strong F neighbours, denom_ij = sum of
// a_jm over j's strong C neighbours m shared with i; a zero denominator
// lumps a_ij into d_i = a_ii + (weak off-diagonal mass of row i) + lump.
// C row i: a 1 at cmap[i]; a row with d_i == 0 emits nothing.  A and S
// (A's values on the strength pattern) sorted CSR.  Returns nnz.
// ---------------------------------------------------------------------------
template <typename Ix>
static I standard_interpolation_impl(I n,
                                     const Ix* Ap, const Ix* Aj,
                                     const double* Ax,
                                     const Ix* Sp, const Ix* Sj,
                                     const double* Sx,
                                     const int32_t* splitting,
                                     const Ix* cmap,
                                     Ix* Pp, Ix* Pj, double* Px) {
    std::vector<double> contrib(n, 0.0);
    std::vector<char> inCi(n, 0);
    I nnz = 0;
    Pp[0] = 0;
    for (I i = 0; i < n; i++) {
        if (splitting[i] == 1) {
            Pj[nnz] = cmap[i];
            Px[nnz++] = 1.0;
            Pp[i + 1] = nnz;
            continue;
        }
        for (I jj = Sp[i]; jj < Sp[i + 1]; jj++) {
            const I j = Sj[jj];
            if (j != i && splitting[j] == 1) inCi[j] = 1;
        }
        double lump = 0.0;
        for (I jj = Sp[i]; jj < Sp[i + 1]; jj++) {
            const I j = Sj[jj];
            if (j == i || splitting[j] == 1) continue;  // strong F only
            double denom = 0.0;
            for (I kk = Sp[j]; kk < Sp[j + 1]; kk++) {
                const I m = Sj[kk];
                if (m != j && splitting[m] == 1 && inCi[m]) denom += Sx[kk];
            }
            if (denom == 0.0) { lump += Sx[jj]; continue; }
            const double bij = Sx[jj] / denom;
            for (I kk = Sp[j]; kk < Sp[j + 1]; kk++) {
                const I m = Sj[kk];
                if (m != j && splitting[m] == 1 && inCi[m])
                    contrib[m] += bij * Sx[kk];
            }
        }
        double diag = 0.0, offA = 0.0;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            if (Aj[jj] == i) diag += Ax[jj];
            else offA += Ax[jj];
        }
        double offS = 0.0;
        for (I jj = Sp[i]; jj < Sp[i + 1]; jj++)
            if (Sj[jj] != i) offS += Sx[jj];
        const double d = diag + (offA - offS) + lump;
        if (d != 0.0) {
            for (I jj = Sp[i]; jj < Sp[i + 1]; jj++) {
                const I k = Sj[jj];
                if (k == i || splitting[k] != 1) continue;
                Pj[nnz] = cmap[k];
                Px[nnz++] = -(Sx[jj] + contrib[k]) / d;
            }
        }
        for (I jj = Sp[i]; jj < Sp[i + 1]; jj++) {
            const I j = Sj[jj];
            inCi[j] = 0;
            contrib[j] = 0.0;
        }
        Pp[i + 1] = nnz;
    }
    return nnz;
}

// ---------------------------------------------------------------------------
// batched Thomas solve of independent tridiagonal lines, the inner solve of
// the host line relaxations: all arrays (nlines, L) row-major, R
// overwritten with the solution; a zero pivot is taken as 1, as the numpy
// form does.
// ---------------------------------------------------------------------------
static void thomas_lines_impl(I nlines, I L,
                              const double* dl, const double* dm,
                              const double* du, double* R, double* cp) {
    #pragma omp parallel for schedule(static)
    for (I l = 0; l < nlines; l++) {
        const double* a = dl + (size_t)l * L;
        const double* b = dm + (size_t)l * L;
        const double* c = du + (size_t)l * L;
        double* x = R + (size_t)l * L;
        double* w = cp + (size_t)l * L;
        double den = b[0] == 0.0 ? 1.0 : b[0];
        w[0] = c[0] / den;
        x[0] = x[0] / den;
        for (I i = 1; i < L; i++) {
            den = b[i] - a[i] * w[i - 1];
            if (den == 0.0) den = 1.0;
            w[i] = c[i] / den;
            x[i] = (x[i] - a[i] * x[i - 1]) / den;
        }
        for (I i = L - 2; i >= 0; i--)
            x[i] -= w[i] * x[i + 1];
    }
}

extern "C" {

void rs_cf_splitting(I n, const I* Sp, const I* Sj, const I* Tp,
                     const I* Tj, int32_t* splitting) {
    rs_cf_splitting_impl<I>(n, Sp, Sj, Tp, Tj, splitting);
}

void rs_cf_splitting_i32(I n, const int32_t* Sp, const int32_t* Sj,
                         const int32_t* Tp, const int32_t* Tj,
                         int32_t* splitting) {
    rs_cf_splitting_impl<int32_t>(n, Sp, Sj, Tp, Tj, splitting);
}

I identity_minus_scaled(I n, const I* Ap, const I* Aj, const double* Ax,
                        double c, double* Sx) {
    return identity_minus_scaled_impl<I>(n, Ap, Aj, Ax, c, Sx);
}

I identity_minus_scaled_i32(I n, const int32_t* Ap, const int32_t* Aj,
                            const double* Ax, double c, double* Sx) {
    return identity_minus_scaled_impl<int32_t>(n, Ap, Aj, Ax, c, Sx);
}

I identity_minus_colscaled(I n, const I* Ap, const I* Aj, const double* Ax,
                           const double* Dinv, double c, double* Sx) {
    return identity_minus_colscaled_impl<I>(n, Ap, Aj, Ax, Dinv, c, Sx);
}

I identity_minus_colscaled_i32(I n, const int32_t* Ap, const int32_t* Aj,
                               const double* Ax, const double* Dinv,
                               double c, double* Sx) {
    return identity_minus_colscaled_impl<int32_t>(n, Ap, Aj, Ax, Dinv, c,
                                                  Sx);
}

I pattern_values(I n, const I* Cp, const I* Cj, const I* Ap, const I* Aj,
                 const double* Ax, double* out) {
    return pattern_values_impl<I>(n, Cp, Cj, Ap, Aj, Ax, out);
}

I pattern_values_i32(I n, const int32_t* Cp, const int32_t* Cj,
                     const int32_t* Ap, const int32_t* Aj,
                     const double* Ax, double* out) {
    return pattern_values_impl<int32_t>(n, Cp, Cj, Ap, Aj, Ax, out);
}

void evolution_nulldim1(I n, const I* Ap, const I* Aj, double* Ax,
                        const double* b1, double tiny) {
    evolution_nulldim1_impl<I>(n, Ap, Aj, Ax, b1, tiny);
}

void evolution_nulldim1_i32(I n, const int32_t* Ap, const int32_t* Aj,
                            double* Ax, const double* b1, double tiny) {
    evolution_nulldim1_impl<int32_t>(n, Ap, Aj, Ax, b1, tiny);
}

void distance_filter(I n, const I* Ap, const I* Aj, double* Ax,
                     double epsilon) {
    distance_filter_impl<I>(n, Ap, Aj, Ax, epsilon);
}

void distance_filter_i32(I n, const int32_t* Ap, const int32_t* Aj,
                         double* Ax, double epsilon) {
    distance_filter_impl<int32_t>(n, Ap, Aj, Ax, epsilon);
}

I evolution_epilogue(I n, const I* Ap, const I* Aj, double* Ax, double eps,
                     I symmetrize, I* Op, I* Oj, double* Ox) {
    return evolution_epilogue_impl<I>(n, Ap, Aj, Ax, eps, (int)symmetrize,
                                      Op, Oj, Ox);
}

I evolution_epilogue_i32(I n, const int32_t* Ap, const int32_t* Aj,
                         double* Ax, double eps, I symmetrize,
                         int32_t* Op, int32_t* Oj, double* Ox) {
    return evolution_epilogue_impl<int32_t>(n, Ap, Aj, Ax, eps,
                                            (int)symmetrize, Op, Oj, Ox);
}

I direct_interpolation(I n, const I* Ap, const I* Aj, const double* Ax,
                       const I* Cp, const I* Cj, const int32_t* splitting,
                       const I* cmap, I* Pp, I* Pj, double* Px) {
    return direct_interpolation_impl<I>(n, Ap, Aj, Ax, Cp, Cj, splitting,
                                        cmap, Pp, Pj, Px);
}

I direct_interpolation_i32(I n, const int32_t* Ap, const int32_t* Aj,
                           const double* Ax, const int32_t* Cp,
                           const int32_t* Cj, const int32_t* splitting,
                           const int32_t* cmap, int32_t* Pp, int32_t* Pj,
                           double* Px) {
    return direct_interpolation_impl<int32_t>(n, Ap, Aj, Ax, Cp, Cj,
                                              splitting, cmap, Pp, Pj, Px);
}

I standard_interpolation(I n, const I* Ap, const I* Aj, const double* Ax,
                         const I* Sp, const I* Sj, const double* Sx,
                         const int32_t* splitting, const I* cmap,
                         I* Pp, I* Pj, double* Px) {
    return standard_interpolation_impl<I>(n, Ap, Aj, Ax, Sp, Sj, Sx,
                                          splitting, cmap, Pp, Pj, Px);
}

I standard_interpolation_i32(I n, const int32_t* Ap, const int32_t* Aj,
                             const double* Ax, const int32_t* Sp,
                             const int32_t* Sj, const double* Sx,
                             const int32_t* splitting, const int32_t* cmap,
                             int32_t* Pp, int32_t* Pj, double* Px) {
    return standard_interpolation_impl<int32_t>(n, Ap, Aj, Ax, Sp, Sj, Sx,
                                                splitting, cmap, Pp, Pj,
                                                Px);
}

void thomas_lines(I nlines, I L, const double* dl, const double* dm,
                  const double* du, double* R, double* cp) {
    thomas_lines_impl(nlines, L, dl, dm, du, R, cp);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Greedy path-growing weighted matching (Drake and Hougardy): grow paths
// from each start in turn along the heaviest edge to an unused node, taking
// every other edge; two covers (starts ascending and descending), the
// heavier kept.  match out: the partner, or -1.
// ---------------------------------------------------------------------------
static double grow_cover(I n, const I* Ap, const I* Aj, const double* w,
                         const I* start_order, I* match) {
    std::vector<char> used(n, 0);
    std::fill(match, match + n, (I)-1);
    double total = 0.0;
    for (I t = 0; t < n; t++) {
        I s = start_order[t];
        if (used[s]) continue;
        I x = s;
        bool take = true;
        while (true) {
            used[x] = 1;
            I best_j = -1;
            double best_w = -1.0;
            for (I kk = Ap[x]; kk < Ap[x + 1]; kk++) {
                I j = Aj[kk];
                if (j != x && !used[j] && w[kk] > best_w) {
                    best_w = w[kk];
                    best_j = j;
                }
            }
            if (best_j < 0) break;
            if (take) {
                match[x] = best_j;
                match[best_j] = x;
                total += best_w;
            }
            take = !take;
            x = best_j;
        }
    }
    return total;
}

extern "C" {

// Bellman-Ford (a FIFO of the nodes whose distance fell) from a seed set over
// the edge weights |Ax|: dist out, and nearest out, the seed each node's
// shortest path starts at (-1 where none reaches)
void bellman_ford(I n, const I* Ap, const I* Aj, const double* Ax,
                  I n_seeds, const I* seeds, double* dist, I* nearest) {
    const double INF = std::numeric_limits<double>::infinity();
    for (I i = 0; i < n; i++) { dist[i] = INF; nearest[i] = -1; }
    std::queue<I> q;
    std::vector<char> inq(n, 0);
    for (I s = 0; s < n_seeds; s++) {
        dist[seeds[s]] = 0.0;
        nearest[seeds[s]] = seeds[s];
        q.push(seeds[s]);
        inq[seeds[s]] = 1;
    }
    while (!q.empty()) {
        I i = q.front(); q.pop(); inq[i] = 0;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            I j = Aj[jj];
            double nd = dist[i] + std::fabs(Ax[jj]);
            if (nd < dist[j]) {
                dist[j] = nd;
                nearest[j] = nearest[i];
                if (!inq[j]) { q.push(j); inq[j] = 1; }
            }
        }
    }
}

// breadth-first levels from one seed (-1 where unreached) and the visiting
// order, *n_order entries of it
void bfs_levels(I n, const I* Ap, const I* Aj, I seed, I* level, I* order,
                I* n_order) {
    std::fill(level, level + n, (I)-1);
    I cnt = 0;
    std::queue<I> q;
    level[seed] = 0;
    q.push(seed);
    while (!q.empty()) {
        I i = q.front(); q.pop();
        order[cnt++] = i;
        for (I jj = Ap[i]; jj < Ap[i + 1]; jj++) {
            I j = Aj[jj];
            if (level[j] < 0) { level[j] = level[i] + 1; q.push(j); }
        }
    }
    *n_order = cnt;
}

void drake_matching_core(I n, const I* Ap, const I* Aj, const double* w,
                         I* match) {
    std::vector<I> fwd(n), bwd(n);
    for (I i = 0; i < n; i++) { fwd[i] = i; bwd[i] = n - 1 - i; }
    std::vector<I> m1(n), m2(n);
    double t1 = grow_cover(n, Ap, Aj, w, fwd.data(), m1.data());
    double t2 = grow_cover(n, Ap, Aj, w, bwd.data(), m2.data());
    std::memcpy(match, (t1 >= t2) ? m1.data() : m2.data(), sizeof(I) * n);
}

}  // extern "C"
