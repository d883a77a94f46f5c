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
// Layout and step loop: moment_math.cuh (tile_moments).  A block of two
// warps covers BLOCK targets, 32 a warp in two 16-row groups, and stages
// BLOCK sources a tile, one a thread, double-buffered: a tile's sources are
// loaded into registers while the previous tile is summed, split at
// staging (the moment rows, FAST's coordinate rows), and one barrier a
// tile separates the buffers.  Each step of 8 sources sums into a fresh
// fragment, added to the tile's moments in fp32, and each tile to the
// running moments with a Kahan two-sum across tiles (KAHAN), as
// _direct_kernel :360-365 does across its source superblocks.  The hi and
// lo column sums (lanes t and t ^ 2) are added once at the end, by a
// two-sum that keeps the compensation exact.  SKIP and the source-stream
// splits are direct_tile_kernel's; every split writes its (total, comp)
// moments to scratch, and moment_finalise_kernel adds them in the fixed
// order s = 0..S-1 (Kahan) and finalises a_i = P[0:3] - x_i P[3] once per
// target, with the product and the difference rounded apart as the plain
// version and the JAX form round them.  The caller centres the
// coordinates (the finalisation cancels as |x| / |dx|).
//
// What bounds it: per pair one MUFU rsqrt (4.18e12/s on the card) is the
// largest of its three pipe times; the FP32 work (dx and r^2, 9 operations
// counting an FMA as two, F's expanded r^2 7; the cube 2; the split's
// subtraction 1; the add of the step's fragment 1) and the tensor work (32
// TF32 FLOPs a pair: two passes of m16n8k8 over 16 x 8 pairs, 64 with F's
// cross term) come below it.  On the card the kernel runs at the speed of
// its own step loop (tile_sol_moment_kernel in roofline.cu runs the same
// loop on a resident tile; PERF.md), and that loop is bound by issuing its
// FP32 and integer instructions and waiting on them: taking the mma passes
// or the rsqrt out of it moves its time by a few percent (PERF.md).  So
// the design cuts instructions a pair: the split in integer operations with
// lo fed raw (3 instructions where cvt.rna.tf32 takes 7); 3xTF32 in two mma
// passes (B's lo halves in its otherwise idle columns 4-7, F's coordinates'
// lo in the contraction's idle half); B's rows pre-split, unpredicated and
// zero-padded, one 8-byte load a step (F's cross term one 16-byte load);
// two target groups a warp sharing each step's loads, with two independent
// mma chains.  Not done: wgmma (its asynchrony would overlap the tensor
// work, which is not what bounds the loop), TMA, a persistent schedule.

#include "moment_math.cuh"

namespace {

using namespace nbody;

// Kernels M and F (see the header): the moments of every target against
// its split's share of the source tiles, to the split's scratch.
template <int MODE, bool FOLD, bool KAHAN, bool SKIP, bool FAST>
__global__ void __launch_bounds__(MOM_THREADS)
moment_tile_kernel(const float* __restrict__ tgt, int nt,
                   const float* __restrict__ src, int ns,
                   const int* __restrict__ start, int tm, int tn, int nb,
                   float eps2, float* __restrict__ part) {
  __shared__ MomTile s[2];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // group h's rows: row0 + 16 h (a) and row0 + 16 h + 8 (b)
  const int row0 = blockIdx.x * BLOCK + (threadIdx.x >> 5) * 16 * GROUPS + g;
  MomGroup q[GROUPS];
#pragma unroll
  for (int h = 0; h < GROUPS; ++h)
    q[h] = mom_group<FAST>(load_target(tgt, nt, row0 + 16 * h),
                           load_target(tgt, nt, row0 + 16 * h + 8), eps2);
  const int tiles = ns / BLOCK;
  int band_lo, band_n;
  band_tiles<SKIP>(start, tm, tn, nb, tiles, band_lo, band_n);
  int k_lo, k_hi;
  split_range(tiles - band_n, k_lo, k_hi);
  constexpr int W = MODE == ACC ? 4 : 1;
  float total[GROUPS][4] = {}, comp[GROUPS][4] = {};
  float v[4];
  if (k_lo < k_hi)
    load_source(src, ns, tile_of(k_lo, band_lo, band_n) * BLOCK + threadIdx.x,
                v);
  for (int k = k_lo; k < k_hi; ++k) {
    // buffer k & 1 was last read two tiles ago, before the last barrier
    MomTile& buf = s[k & 1];
    stage_source<MODE, FOLD, FAST>(buf, v);
    __syncthreads();
    if (k + 1 < k_hi)  // the next tile's loads fly while this one is summed
      load_source(src, ns,
                  tile_of(k + 1, band_lo, band_n) * BLOCK + threadIdx.x, v);
    float d[GROUPS][4];  // this tile's moments
    tile_moments<MODE, FOLD, FAST>(buf, q, eps2, d);
#pragma unroll
    for (int h = 0; h < GROUPS; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (KAHAN) kahan_add(total[h][e], comp[h][e], d[h][e]);
        else total[h][e] += d[h][e];
      }
    }
  }
  // lane t holds columns 2t, 2t + 1 of the 8-column product; lane t ^ 2
  // the other half of the same moments.  Cells: (a, 2t), (a, 2t + 1),
  // (b, 2t), (b, 2t + 1); lanes t = 0, 1 write moments 2t, 2t + 1.
  const long long n = static_cast<long long>(nt) * W;
  float* tot = part + blockIdx.y * n;
  float* cmp = tot + gridDim.y * n;
#pragma unroll
  for (int h = 0; h < GROUPS; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float t_o = __shfl_xor_sync(0xffffffffu, total[h][e], 2);
      const float c_o = __shfl_xor_sync(0xffffffffu, comp[h][e], 2);
      float sum, err;
      two_sum(total[h][e], t_o, sum, err);
      const int i = row0 + 16 * h + (e < 2 ? 0 : 8);
      const int c = 2 * t + (e & 1);
      if (i < nt && c < W) {
        tot[static_cast<long long>(i) * W + c] = sum;
        cmp[static_cast<long long>(i) * W + c] = (comp[h][e] + c_o) - err;
      }
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
