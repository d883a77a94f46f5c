// host_ops.cpp — native host-side runtime kernels (C ABI, ctypes-loaded).
//
// The host layer of nbody_streams_tpu_torch, a copy of the JAX package's
// nbody_streams_tpu/native/host_ops.cpp (the reference ships NumPy Morton
// sorting, reference: viz/sph_kernels.py:63-111).  These are host hot
// spots that sit off the card:
//
//   morton_argsort : 64-bit interleaved-key spatial sort (SPH locality,
//                    snapshot layout) — OpenMP key build + std::sort
//   knn_radius     : k-nearest-neighbour distances via a uniform grid
//                    hash (SPH smoothing lengths) — OpenMP over particles
//
// Built with g++ -O3 -fopenmp at first use by native/__init__.py (no
// -march=native, so the library runs on any x86-64 host) and loaded with
// ctypes; a build or load failure raises there.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Morton (Z-order) argsort
// ---------------------------------------------------------------------------

static inline uint64_t spread3(uint64_t v) {
    // spread 21 bits to every third bit position
    v &= 0x1fffff;
    v = (v | v << 32) & 0x1f00000000ffffULL;
    v = (v | v << 16) & 0x1f0000ff0000ffULL;
    v = (v | v << 8)  & 0x100f00f00f00f00fULL;
    v = (v | v << 4)  & 0x10c30c30c30c30c3ULL;
    v = (v | v << 2)  & 0x1249249249249249ULL;
    return v;
}

// pos: (n, 3) float64, out_idx: (n,) int64 — permutation sorting points
// along the Z-order curve.
int morton_argsort(const double* pos, int64_t n, int64_t* out_idx) {
    if (n <= 0) return 0;
    double lo[3] = {pos[0], pos[1], pos[2]};
    double hi[3] = {pos[0], pos[1], pos[2]};
    for (int64_t i = 0; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            double v = pos[3 * i + d];
            if (v < lo[d]) lo[d] = v;
            if (v > hi[d]) hi[d] = v;
        }
    }
    double inv[3];
    for (int d = 0; d < 3; ++d) {
        double span = hi[d] - lo[d];
        inv[d] = span > 0 ? (2097151.0 / span) : 0.0;  // 2^21 - 1
    }

    std::vector<std::pair<uint64_t, int64_t>> keys(n);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint64_t kx = (uint64_t)((pos[3 * i + 0] - lo[0]) * inv[0]);
        uint64_t ky = (uint64_t)((pos[3 * i + 1] - lo[1]) * inv[1]);
        uint64_t kz = (uint64_t)((pos[3 * i + 2] - lo[2]) * inv[2]);
        keys[i] = {spread3(kx) | (spread3(ky) << 1) | (spread3(kz) << 2),
                   i};
    }
    std::sort(keys.begin(), keys.end());
    for (int64_t i = 0; i < n; ++i) out_idx[i] = keys[i].second;
    return 0;
}

// ---------------------------------------------------------------------------
// Grid-hash k-nearest-neighbour distances (3-D)
// ---------------------------------------------------------------------------

// pos: (n, 3) float64; out_h: (n,) float64 = distance to the k-th
// nearest neighbour (excluding self).  Uniform grid with expanding ring
// search; cell size from the mean density.
int knn_radius(const double* pos, int64_t n, int k, double* out_h) {
    if (n <= 0) return 0;
    if (k >= n) k = (int)n - 1;
    if (k < 1) k = 1;

    // robust grid box: 5th-95th percentile per dimension (subsampled);
    // outliers clamp into the edge cells.  Sizing the grid to the full
    // bounding box makes clustered data pathological (dense core cells,
    // huge empty tails).
    double lo[3], hi[3];
    {
        int64_t stride = std::max((int64_t)1, n / 20000);
        std::vector<double> sample;
        sample.reserve(n / stride + 1);
        for (int d = 0; d < 3; ++d) {
            sample.clear();
            for (int64_t i = 0; i < n; i += stride)
                sample.push_back(pos[3 * i + d]);
            std::sort(sample.begin(), sample.end());
            size_t m = sample.size();
            lo[d] = sample[(size_t)(0.05 * (m - 1))];
            hi[d] = sample[(size_t)(0.95 * (m - 1))];
            if (hi[d] <= lo[d]) {
                lo[d] = sample.front();
                hi[d] = sample.back();
            }
        }
    }
    double span[3];
    for (int d = 0; d < 3; ++d)
        span[d] = std::max(hi[d] - lo[d], 1e-300);
    // aim for ~ k/4 particles per cell — over the EFFECTIVE dims only.
    // Coplanar/collinear inputs have one or more ~0 spans; including
    // them in the volume drives the cell size to ~0, which both
    // over-refines the live dims (observed: 27 s for a 500-point disc)
    // and makes span/cell overflow int — a UB double->int cast
    // (observed: INT_MIN, one cell, O(n^2) queries).
    double max_span = std::max(span[0], std::max(span[1], span[2]));
    double measure = 1.0;
    int eff = 0;
    bool live[3];
    for (int d = 0; d < 3; ++d) {
        live[d] = span[d] > 1e-9 * max_span;
        if (live[d]) { measure *= span[d]; ++eff; }
    }
    double cell = std::pow(measure * (0.25 * k) / (0.9 * (double)n),
                           1.0 / eff);
    int ncell[3];
    int64_t total_cells = 1;
    for (int d = 0; d < 3; ++d) {
        double ratio = live[d] && cell > 0.0 ? span[d] / cell : 1.0;
        if (!(ratio >= 1.0)) ratio = 1.0;        // NaN/inf/sub-1 -> 1
        if (ratio > 256.0) ratio = 256.0;
        ncell[d] = (int)ratio;
        total_cells *= ncell[d];
    }

    auto cell_of = [&](int64_t i, int* c) {
        for (int d = 0; d < 3; ++d) {
            int v = (int)((pos[3 * i + d] - lo[d]) / span[d] * ncell[d]);
            c[d] = std::min(std::max(v, 0), ncell[d] - 1);
        }
    };
    auto cell_id = [&](const int* c) {
        return ((int64_t)c[0] * ncell[1] + c[1]) * ncell[2] + c[2];
    };

    // counting sort into cells
    std::vector<int64_t> counts(total_cells + 1, 0);
    std::vector<int64_t> which(n);
    for (int64_t i = 0; i < n; ++i) {
        int c[3];
        cell_of(i, c);
        which[i] = cell_id(c);
        counts[which[i] + 1]++;
    }
    for (int64_t c = 0; c < total_cells; ++c) counts[c + 1] += counts[c];
    std::vector<int64_t> order(n);
    {
        std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
        for (int64_t i = 0; i < n; ++i) order[cursor[which[i]]++] = i;
    }

    double cw[3];
    for (int d = 0; d < 3; ++d) cw[d] = span[d] / ncell[d];

#pragma omp parallel
    {
        std::vector<double> best(k);
#pragma omp for schedule(dynamic, 256)
        for (int64_t i = 0; i < n; ++i) {
            int c0[3];
            cell_of(i, c0);
            // distance from the point to its cell walls, per direction
            // (positive even for clamped outliers sitting outside the
            // box) — feeds an exact per-dim ring lower bound below
            double dminus[3], dplus[3];
            for (int d = 0; d < 3; ++d) {
                double cl = lo[d] + c0[d] * cw[d];
                double ch = cl + cw[d];
                double v = pos[3 * i + d];
                dminus[d] = std::max(v - cl, 0.0);
                dplus[d] = std::max(ch - v, 0.0);
            }
            int found = 0;
            double worst = 1e300;
            // expanding shells of cells
            int max_ring = std::max(ncell[0],
                                    std::max(ncell[1], ncell[2]));
            for (int ring = 0; ring <= max_ring; ++ring) {
                // exact shell lower bound: every shell cell has SOME
                // dim at offset +-ring; the distance is at least the
                // point's distance along that dim.  Directional, so a
                // clamped outlier's bound GROWS with its offset instead
                // of being discounted by it (the old scalar -excess
                // form scanned ~excess/cw extra rings per outlier —
                // 70 s at 600k Gaussian points from the 10% tails).
                if (ring > 0) {
                    double nearest = 1e300;
                    for (int d = 0; d < 3; ++d) {
                        if (c0[d] - ring >= 0)
                            nearest = std::min(
                                nearest, (double)(ring - 1) * cw[d]
                                             + dminus[d]);
                        if (c0[d] + ring < ncell[d])
                            nearest = std::min(
                                nearest, (double)(ring - 1) * cw[d]
                                             + dplus[d]);
                    }
                    if (nearest == 1e300)
                        break;              // no cells at this ring on
                    if (found >= k && nearest > std::sqrt(worst))
                        break;
                }
                // enumerate the shell directly, clamped to the grid:
                // a full (2r+1)^3 cube scan with a skip test costs
                // O(r^3) per ring even when (e.g.) the z grid is one
                // cell thick or the query sits at a grid corner —
                // observed as effectively O(n^2) on thin-disc inputs
                int dx0 = std::max(-ring, -c0[0]);
                int dx1 = std::min(ring, ncell[0] - 1 - c0[0]);
                int dy0 = std::max(-ring, -c0[1]);
                int dy1 = std::min(ring, ncell[1] - 1 - c0[1]);
                int dz0 = std::max(-ring, -c0[2]);
                int dz1 = std::min(ring, ncell[2] - 1 - c0[2]);
                auto scan_cell = [&](int dx, int dy, int dz) {
                    int c[3] = {c0[0] + dx, c0[1] + dy, c0[2] + dz};
                    int64_t cid = cell_id(c);
                    for (int64_t p = counts[cid];
                         p < counts[cid + 1]; ++p) {
                        int64_t j = order[p];
                        if (j == i) continue;
                        double d2 = 0;
                        for (int d = 0; d < 3; ++d) {
                            double dd = pos[3 * i + d] - pos[3 * j + d];
                            d2 += dd * dd;
                        }
                        if (found < k) {
                            best[found++] = d2;
                            if (found == k) {
                                std::make_heap(best.begin(), best.end());
                                worst = best.front();
                            }
                        } else if (d2 < worst) {
                            std::pop_heap(best.begin(), best.end());
                            best[k - 1] = d2;
                            std::push_heap(best.begin(), best.end());
                            worst = best.front();
                        }
                    }
                };
                for (int dx = dx0; dx <= dx1; ++dx)
                    for (int dy = dy0; dy <= dy1; ++dy) {
                        if (std::max(std::abs(dx), std::abs(dy))
                                == ring) {
                            // side face: the full clamped dz column
                            for (int dz = dz0; dz <= dz1; ++dz)
                                scan_cell(dx, dy, dz);
                        } else {
                            // interior column: only the two end caps
                            if (-ring >= dz0) scan_cell(dx, dy, -ring);
                            if (ring != -ring && ring <= dz1)
                                scan_cell(dx, dy, ring);
                        }
                    }
            }
            out_h[i] = found ? std::sqrt(
                found < k ? *std::max_element(best.begin(),
                                              best.begin() + found)
                          : worst)
                             : 0.0;
        }
    }
    return 0;
}

int nbody_host_alive(void) { return 1; }

}  // extern "C"
