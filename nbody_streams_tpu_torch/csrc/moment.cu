// Tensor-core (moment) forms of the all-pairs kernel for Hopper (sm_90a),
// bound to Python with ctypes.
//
// moment_tile_kernel replaces the matrix-unit forms of the TPU kernel
// _direct_kernel (nbody_streams_tpu/ops/pallas_direct.py:301, its tile body
// _tile_sum :171-298):
// - kernel M, the moment form (mxu=True, acc; :244-269): a_i = P_i[0:3] -
//   x_i P_i[3] with P = S @ B, S(targets x sources) the pair factors and
//   B = G m [x y z 1] (FOLD) or S = G m f and B = [x y z 1] (fold_mass =
//   False, the target_drift tier).  On the path as the sorted base pass
//   (SKIP) of tile_config {'mxu': True} and target_drift, and as the
//   ring's far tiles (the two-set form, folded).  Both take the Newtonian
//   law, the only law their callers give them (a far block has r > h for
//   every pair), and neither holds a self pair: the band holds the sorted
//   path's, and a far block is never the targets' own, so the self mask
//   of _mask_self_lanes (:159-168) is not built.
// - kernel F, FAST (mxu_r2, the float32_fast tier; :211-227, hoisted at
//   :338-343): r^2 = max(a_t + (b_s - 2 x_t . x_s), dx_x^2 + eps2), with
//   a_t = |x_t|^2 + eps2, b_s = |x_s|^2 and the cross term x_t . x_s on the
//   tensor cores, then the moments as kernel M (acc), or the potential's
//   row sum with B = G m (pot).  The clamp keeps the JAX form's guarantee:
//   r^2 >= dx_x^2 + eps2, so a far outlier's expansion error can never
//   reach a divergent factor (tests/test_pallas.py:384-426).
// The pot row sum of the non-fast form (mxu=True, :275-293) has no kernel
// here: on this card each thread of the potential forms (direct.cu) sums
// its own targets' rows, so there is no cross-lane reduction for the
// tensor cores to take over; the callers route it to those forms.
//
// Layout (direct_math.cuh): a block of MOM_THREADS threads covers BLOCK
// targets, one warp 16 of them.  Per step of 8 staged sources a warp issues
// an mma m16n8k8: A = S (16 targets x 8 sources), B = the moments (8
// sources x 8 columns, 4 used), D += A B.  Lane (g, t) = (lane / 4,
// lane % 4) computes exactly the pair factors of its A fragment, targets g
// and g + 8 against sources 2t and 2t + 1 of the step: A's contraction
// index is permuted (k = t <-> source 2t, k = t + 4 <-> source 2t + 1) and
// B's rows are loaded at the same permuted sources, so that FAST's cross
// term, an mma whose D fragment holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1), feeds the moment product without a shuffle.  Every
// product is 3xTF32 (mma_3xtf32): a single TF32 pass would keep ~3 digits.
// Sources are staged as direct.cu stages them, plus their moment rows
// (and FAST's coordinate rows) split into TF32 hi/lo once per source; rows
// are padded to ROW words so that a warp's B loads hit 16 distinct banks.
// Each step of 8 sources sums into a fresh fragment, added to the tile's
// moments in fp32, and each staged tile of BLOCK sources to the running
// moments with a Kahan two-sum across tiles (KAHAN), as _direct_kernel
// :360-365 does across its source superblocks.  SKIP and
// the source-stream splits are direct_tile_kernel's; every split writes
// its (total, comp) moments to scratch, and moment_finalise_kernel adds
// them in the fixed order s = 0..S-1 (Kahan) and finalises a_i = P[0:3] -
// x_i P[3] once per target, with the product and the difference rounded
// apart as the plain version and the JAX form round them.  The caller
// centres the coordinates (the finalisation cancels as |x| / |dx|).
//
// What bounds it: per pair the Newtonian factor (r^2, one MUFU rsqrt, a
// cube: 12 FP32 operations counting an FMA as two, 7 of them r^2 for FAST)
// and the TF32 split of the factor (2); the mass multiply and the three
// accumulating FMAs of direct_tile_kernel's 19 move to the tensor cores:
// 48 TF32 FLOPs a pair (3 passes of 16 x 8 x 8, half of B's columns
// padding), 96 with FAST's cross term, at 495 TFLOP/s dense.  The MUFU
// rsqrt (one a pair at 4.18e12/s) is then the largest of the three times,
// above the FP32 and tensor times.  What the design does about it: the
// warp-synchronous mma.sync form takes the accumulation off the FP32 pipe
// and nothing else; not done: wgmma, TMA, a persistent schedule.

#include <cstdint>

#include "direct_math.cuh"

namespace {

using namespace nbody;

constexpr int MOM_WARPS = BLOCK / 16;        // 16 targets a warp
constexpr int MOM_THREADS = 32 * MOM_WARPS;
constexpr int ROW = BLOCK + 8;               // padded staged row (banks)

struct MomTile {
  float x[BLOCK], y[BLOCK], z[BLOCK], gm[BLOCK], pre[BLOCK];
  float bs[BLOCK];                           // FAST: |x_s|^2
  uint32_t b_hi[4][ROW], b_lo[4][ROW];       // moment column c of a source
  uint32_t c_hi[3][ROW], c_lo[3][ROW];       // FAST: coordinate c
};

// The moment columns of one source: G m [x y z 1] (FOLD) or [x y z 1]
// (acc), G m (pot; the other columns zero).
template <int MODE, bool FOLD, bool FAST>
__device__ __forceinline__ void stage_moments(MomTile& s,
                                              const float* __restrict__ src,
                                              int ns, int j0) {
  const int k = threadIdx.x;
  if (k >= BLOCK) return;
  const int j = j0 + k;
  const float x = src[j], y = src[ns + j], z = src[2 * ns + j];
  const float gm = src[3 * ns + j];
  s.x[k] = x;
  s.y[k] = y;
  s.z[k] = z;
  s.gm[k] = gm;
  s.pre[k] = src[4 * ns + j];
  float m[4];
  if (MODE == ACC) {
    m[0] = FOLD ? __fmul_rn(gm, x) : x;
    m[1] = FOLD ? __fmul_rn(gm, y) : y;
    m[2] = FOLD ? __fmul_rn(gm, z) : z;
    m[3] = FOLD ? gm : 1.f;
  } else {
    m[0] = gm;
    m[1] = m[2] = m[3] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) split_tf32(m[c], s.b_hi[c][k], s.b_lo[c][k]);
  if (FAST) {
    split_tf32(x, s.c_hi[0][k], s.c_lo[0][k]);
    split_tf32(y, s.c_hi[1][k], s.c_lo[1][k]);
    split_tf32(z, s.c_hi[2][k], s.c_lo[2][k]);
    // b_s = x*x + (y*y + z*z), each operation rounded (pallas_direct :218)
    s.bs[k] = __fadd_rn(__fmul_rn(x, x),
                        __fadd_rn(__fmul_rn(y, y), __fmul_rn(z, z)));
  }
}

// a_t = x*x + (y*y + (z*z + eps2)), each operation rounded (:342)
__device__ __forceinline__ float norm2_eps(const Target& t, float eps2) {
  return __fadd_rn(__fmul_rn(t.x, t.x),
                   __fadd_rn(__fmul_rn(t.y, t.y),
                             __fadd_rn(__fmul_rn(t.z, t.z), eps2)));
}

__device__ __forceinline__ float coord(const Target& t, int c) {
  return c == 0 ? t.x : (c == 1 ? t.y : (c == 2 ? t.z : 0.f));
}

// The Newtonian pair factor of target tg and staged source j: the force
// factor (acc; times G m without FOLD) or the potential factor (pot).
template <int MODE, bool FOLD>
__device__ __forceinline__ float factor(const MomTile& s, const Target& tg,
                                        int j, float r2) {
  const float pre = pair_pre<NEWTONIAN>(tg.pre, s.pre[j]);
  const float f = MODE == ACC ? force_pre<NEWTONIAN>(r2, pre)
                              : pot_pre<NEWTONIAN>(r2, pre);
  return MODE == ACC && !FOLD ? s.gm[j] * f : f;
}

// Kernels M and F (see the header): the moments of every target against
// its split's share of the source tiles, to the split's scratch.
template <int MODE, bool FOLD, bool KAHAN, bool SKIP, bool FAST>
__global__ void __launch_bounds__(MOM_THREADS)
moment_tile_kernel(const float* __restrict__ tgt, int nt,
                   const float* __restrict__ src, int ns,
                   const int* __restrict__ start, int tm, int tn, int nb,
                   float eps2, float* __restrict__ part) {
  __shared__ MomTile s;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ia = blockIdx.x * BLOCK + (threadIdx.x >> 5) * 16 + g;
  const int ib = ia + 8;
  const Target ta = load_target(tgt, nt, ia), tb = load_target(tgt, nt, ib);
  // FAST: the cross term's A fragment, rows g and g + 8 of T = [x y z 0..]
  // (columns t + 4 are padding), and a_t of both targets
  uint32_t x_hi[4] = {0u, 0u, 0u, 0u}, x_lo[4] = {0u, 0u, 0u, 0u};
  float at_a = 0.f, at_b = 0.f;
  if (FAST) {
    split_tf32(coord(ta, t), x_hi[0], x_lo[0]);
    split_tf32(coord(tb, t), x_hi[1], x_lo[1]);
    at_a = norm2_eps(ta, eps2);
    at_b = norm2_eps(tb, eps2);
  }
  const int tiles = ns / BLOCK;
  int band_lo, band_n;
  band_tiles<SKIP>(start, tm, tn, nb, tiles, band_lo, band_n);
  int k_lo, k_hi;
  split_range(tiles - band_n, k_lo, k_hi);
  constexpr int W = MODE == ACC ? 4 : 1;
  float total[4] = {0.f, 0.f, 0.f, 0.f}, comp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = k_lo; k < k_hi; ++k) {
    const int j0 = tile_of(k, band_lo, band_n) * BLOCK;
    __syncthreads();  // the previous tile is consumed
    stage_moments<MODE, FOLD, FAST>(s, src, ns, j0);
    __syncthreads();
    float d[4] = {0.f, 0.f, 0.f, 0.f};  // this tile's moments
#pragma unroll 2
    for (int k8 = 0; k8 < BLOCK; k8 += 8) {
      const int j_lo = k8 + 2 * t, j_hi = j_lo + 1;
      // the four cells of the lane's A fragment, in fragment order:
      // (g, j_lo), (g + 8, j_lo), (g, j_hi), (g + 8, j_hi)
      float r2[4];
      if (FAST) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        const int row = t < 3 ? t : 2;
        const uint32_t b_hi[2] = {t < 3 ? s.c_hi[row][k8 + g] : 0u, 0u};
        const uint32_t b_lo[2] = {t < 3 ? s.c_lo[row][k8 + g] : 0u, 0u};
        mma_3xtf32(c, x_hi, x_lo, b_hi, b_lo);
        // c = x_t . x_s at (g, j_lo), (g, j_hi), (g + 8, j_lo), (g + 8, j_hi)
        const float cross[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? j_lo : j_hi;
          const float dxx = s.x[j] - ((e & 1) ? tb.x : ta.x);
          r2[e] = fmaxf(((e & 1) ? at_b : at_a) + (s.bs[j] - 2.f * cross[e]),
                        dxx * dxx + eps2);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? j_lo : j_hi;
          const Target& q = (e & 1) ? tb : ta;
          const float dx = s.x[j] - q.x;
          const float dy = s.y[j] - q.y;
          const float dz = s.z[j] - q.z;
          r2[e] = dx * dx + (dy * dy + (dz * dz + eps2));
        }
      }
      uint32_t a_hi[4], a_lo[4];
      split_tf32(factor<MODE, FOLD>(s, ta, j_lo, r2[0]), a_hi[0], a_lo[0]);
      split_tf32(factor<MODE, FOLD>(s, tb, j_lo, r2[1]), a_hi[1], a_lo[1]);
      split_tf32(factor<MODE, FOLD>(s, ta, j_hi, r2[2]), a_hi[2], a_lo[2]);
      split_tf32(factor<MODE, FOLD>(s, tb, j_hi, r2[3]), a_hi[3], a_lo[3]);
      // B rows at the permuted sources: b = {B[j_lo][g], B[j_hi][g]},
      // zero past the W moment columns
      const int col = g & 3;
      const bool live = g < W;
      const uint32_t b_hi[2] = {live ? s.b_hi[col][j_lo] : 0u,
                                live ? s.b_hi[col][j_hi] : 0u};
      const uint32_t b_lo[2] = {live ? s.b_lo[col][j_lo] : 0u,
                                live ? s.b_lo[col][j_hi] : 0u};
      // a fresh fragment a step, added to the tile's moments in fp32
      // (rounded to nearest): the tensor cores do not round their sums to
      // nearest, and a bias carried through a tile's 24 products grows
      // linearly, where the finalisation amplifies it as |x| / |dx|
      // (2.1e-6 of the plain version at the bench case with one fragment
      // a tile, 6.2e-7 with one a step: PERF.md §6)
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(e, a_hi, a_lo, b_hi, b_lo);
#pragma unroll
      for (int c = 0; c < 4; ++c) d[c] += e[c];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (KAHAN) kahan_add(total[e], comp[e], d[e]);
      else total[e] += d[e];
    }
  }
  // d's cells: (ia, 2t), (ia, 2t + 1), (ib, 2t), (ib, 2t + 1)
  const long long n = static_cast<long long>(nt) * W;
  float* tot = part + blockIdx.y * n;
  float* cmp = tot + gridDim.y * n;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = e < 2 ? ia : ib;
    const int c = 2 * t + (e & 1);
    if (i < nt && c < W) {
      tot[static_cast<long long>(i) * W + c] = total[e];
      cmp[static_cast<long long>(i) * W + c] = comp[e];
    }
  }
}

// The S splits' moments added in the order s = 0..S-1 (combine_kernel's
// order), then a_i = P[0:3] - x_i P[3] (acc) or phi_i = P[0] (pot).
template <int MODE, bool KAHAN>
__global__ void __launch_bounds__(256)
moment_finalise_kernel(const float* __restrict__ part,
                       const float* __restrict__ tgt, int nt, int splits,
                       float* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= nt) return;
  constexpr int W = MODE == ACC ? 4 : 1;
  const long long n = static_cast<long long>(nt) * W;
  const float* comps = part + static_cast<long long>(splits) * n;
  float p[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const long long e = static_cast<long long>(i) * W + c;
    float total = part[e], comp = comps[e];
    for (int s = 1; s < splits; ++s) {
      const long long k = static_cast<long long>(s) * n + e;
      if (KAHAN) {
        comp += comps[k];
        kahan_add(total, comp, part[k]);
      } else {
        total += part[k];
      }
    }
    p[c] = total;
  }
  if constexpr (MODE == ACC) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * i + c] = __fsub_rn(p[c], __fmul_rn(tgt[c * nt + i], p[3]));
  } else {
    out[i] = p[0];
  }
}

struct MomArgs {
  const float* tgt;
  int nt;
  const float* src;
  int ns;
  const int* start;
  int tm, tn, nb;
  float eps2;
  int splits;
  float* part;
  float* out;
};

template <int MODE, bool FOLD, bool KAHAN, bool SKIP, bool FAST>
void launch_moment(const MomArgs& a, cudaStream_t stream) {
  const dim3 grid((a.nt + BLOCK - 1) / BLOCK, a.splits);
  moment_tile_kernel<MODE, FOLD, KAHAN, SKIP, FAST>
      <<<grid, MOM_THREADS, 0, stream>>>(a.tgt, a.nt, a.src, a.ns, a.start,
                                         a.tm, a.tn, a.nb, a.eps2, a.part);
  moment_finalise_kernel<MODE, KAHAN><<<(a.nt + 255) / 256, 256, 0, stream>>>(
      a.part, a.tgt, a.nt, a.splits, a.out);
}

// The sorted base pass (SKIP): M folded or not, F acc and pot.
template <bool KAHAN>
void launch_base(int mode, bool fold, bool fast, const MomArgs& a,
                 cudaStream_t s) {
  if (mode == POT)
    launch_moment<POT, true, KAHAN, true, true>(a, s);
  else if (fast && fold)
    launch_moment<ACC, true, KAHAN, true, true>(a, s);
  else if (fast)
    launch_moment<ACC, false, KAHAN, true, true>(a, s);
  else if (fold)
    launch_moment<ACC, true, KAHAN, true, false>(a, s);
  else
    launch_moment<ACC, false, KAHAN, true, false>(a, s);
}

}  // namespace

extern "C" {

// Kernels M and F and their finalisation, Newtonian law; returns
// cudaGetLastError() after both launches (0 on success).  `part` is the
// (2, S, nt * W) float scratch, W = 4 (acc) or 1 (pot), for every S.  The
// forms built: with nb > 0 (the sorted base pass) M acc folded or not, F
// (fast) acc folded or not and F pot; with nb == 0 the two-set acc,
// folded.
int nbody_moment(int mode, int kahan, int fold, int fast, int nb,
                 const float* tgt, int nt, const float* src, int ns,
                 const int* start, int tm, int tn, float eps2, int splits,
                 float* part, float* out, void* stream) {
  const bool base = nb > 0;
  if ((mode != ACC && mode != POT) || nt <= 0 || ns <= 0 ||
      ns % BLOCK != 0 || nb < 0 || splits < 1 || splits > 65535 ||
      part == nullptr ||
      (base && (start == nullptr || tm <= 0 || tn % BLOCK != 0)) ||
      (!base && (mode != ACC || !fold || fast)) ||
      (mode == POT && !fast))
    return static_cast<int>(cudaErrorInvalidValue);
  const MomArgs a{tgt, nt, src, ns, start, tm, tn, nb, eps2, splits, part,
                  out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (base) {
    if (kahan) launch_base<true>(mode, fold, fast, a, s);
    else launch_base<false>(mode, fold, fast, a, s);
  } else if (kahan) {
    launch_moment<ACC, true, true, false, false>(a, s);
  } else {
    launch_moment<ACC, true, false, false, false>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
