// The tensor-core moment tile, shared by moment.cu (kernels M and F) and
// roofline.cu (tile_sol_moment_kernel, M's speed of light), so that both
// run the identical step loop, as tile_sum in direct_math.cuh is shared by
// direct_tile_kernel and tile_sol_kernel.
//
// Layout: a block of MOM_THREADS = BLOCK threads (two warps) covers BLOCK
// targets and stages BLOCK sources a tile, one a thread.  A warp holds 32
// targets as GROUPS = 2 groups of 16 rows; per step of 8 staged sources it
// issues, for each group, an mma m16n8k8 with A = S (16 targets x 8
// sources) and B = the moments (8 sources x 8 columns).  Lane (g, t) =
// (lane / 4, lane % 4) computes exactly the pair factors of its A
// fragments, targets g and g + 8 of each group against sources 2t and
// 2t + 1 of the step: A's contraction index is permuted (k = t <-> source
// 2t, k = t + 4 <-> source 2t + 1) and B's rows are read at the same
// permuted sources, so that FAST's cross term, an mma whose D fragment
// holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), feeds the
// moment product without a shuffle.  Both groups share a step's source
// and B loads.
//
// Every product is 3xTF32 in two passes (direct_math.cuh): the moments
// through B's columns (mma_3xtf32_cols: columns 0-3 the hi halves of the W
// <= 4 moment columns, 4-7 their lo halves; lanes t = 2, 3 therefore hold
// the lo sums of lanes t = 0, 1, added at the end), FAST's cross term
// x_t . x_s through the contraction (mma_3xtf32_k4: 3 coordinates hi, then
// lo).  The sources' moment and coordinate rows are split once a tile at
// staging; a step reads a lane's two B cells with one 8-byte load, and
// FAST's two cross-term B operands with one 16-byte load (rows padded to
// BROW words and CROW operands: each phase of a warp's load hits distinct
// banks).
//
// Each step sums into a fresh fragment, added to the tile's moments in
// fp32 (rounded to nearest): the tensor cores do not round their sums to
// nearest, and a bias carried through a tile's products grows linearly,
// where the finalisation amplifies it as |x| / |dx| (2.1e-6 of the plain
// version at the bench case with one fragment a tile, 6.2e-7 with one a
// step: PERF.md §6).
#pragma once

#include <cstdint>

#include "direct_math.cuh"

namespace nbody {

constexpr int GROUPS = 2;                    // 16-target groups a warp
constexpr int MOM_WARPS = BLOCK / (16 * GROUPS);
constexpr int MOM_THREADS = 32 * MOM_WARPS;  // == BLOCK: a source a thread
constexpr int BROW = BLOCK + 8;              // padded B row (words)
constexpr int CROW = BLOCK + 2;              // padded coordinate row (uint4)
static_assert(MOM_THREADS == BLOCK, "one staged source a thread");

struct MomTile {
  float4 pos[BLOCK];                  // x, y, z, G m of a source
  __align__(8) float bs[BLOCK];       // FAST: |x_s|^2
  __align__(8) uint32_t bm[8][BROW];  // moment column c: hi in row c, lo
                                      // in row c + 4 (zero past W)
  uint4 cc[4][CROW];                  // FAST: coordinate c of a source as
                                      // the cross term's B operands {hi,
                                      // hi} and {lo, 0}; row 3 zero
};

// One source's row of the (5, ns) operand: x, y, z, G m (the Newtonian
// law reads no softening).  Loaded a tile ahead, into registers.
__device__ __forceinline__ void load_source(const float* __restrict__ src,
                                            int ns, int j, float v[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = src[c * ns + j];
}

// Stage the thread's source v into s: its coordinates and mass, its moment
// columns G m [x y z 1] (FOLD) or [x y z 1] (acc), G m (pot; the other
// columns zero), split hi/lo, and FAST's coordinates split and |x_s|^2.
template <int MODE, bool FOLD, bool FAST>
__device__ __forceinline__ void stage_source(MomTile& s, const float v[4]) {
  const int k = threadIdx.x;
  const float x = v[0], y = v[1], z = v[2], gm = v[3];
  s.pos[k] = make_float4(x, y, z, gm);
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
  for (int c = 0; c < 4; ++c) split_tf32(m[c], s.bm[c][k], s.bm[c + 4][k]);
  if (FAST) {
    const float xyz[3] = {x, y, z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t hi, lo;
      split_tf32(xyz[c], hi, lo);
      s.cc[c][k] = make_uint4(hi, hi, lo, 0u);
    }
    s.cc[3][k] = make_uint4(0u, 0u, 0u, 0u);
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

// The Newtonian pair factor: the force factor (acc; times the source's
// G m without FOLD) or the potential factor (pot).
template <int MODE, bool FOLD>
__device__ __forceinline__ float factor(float r2, float gm) {
  const float f = MODE == ACC ? force_pre<NEWTONIAN>(r2, 0.f)
                              : pot_pre<NEWTONIAN>(r2, 0.f);
  return MODE == ACC && !FOLD ? gm * f : f;
}

// A lane's targets in one group: rows g (a) and g + 8 (b); for FAST the
// cross term's A fragment x = {hi(a), hi(b), lo(a), lo(b)} of coordinate t
// (zero for t = 3) and a_t of both targets.
struct MomGroup {
  Target a, b;
  uint32_t x[4];
  float at_a, at_b;
};

template <bool FAST>
__device__ __forceinline__ MomGroup mom_group(const Target& a,
                                              const Target& b, float eps2) {
  MomGroup q{a, b, {0u, 0u, 0u, 0u}, 0.f, 0.f};
  if (FAST) {
    const int t = threadIdx.x & 3;
    split_tf32(coord(a, t), q.x[0], q.x[2]);
    split_tf32(coord(b, t), q.x[1], q.x[3]);
    q.at_a = norm2_eps(a, eps2);
    q.at_b = norm2_eps(b, eps2);
  }
  return q;
}

// The moments of one staged tile of BLOCK sources into the lane's
// fragments d[h], h the group: cells (a, 2t), (a, 2t + 1), (b, 2t),
// (b, 2t + 1) of the 8-column product, columns 0-3 the hi sums of the
// moment columns and 4-7 their lo sums (zero past W).
template <int MODE, bool FOLD, bool FAST>
__device__ __forceinline__ void tile_moments(const MomTile& s,
                                             const MomGroup (&q)[GROUPS],
                                             float eps2,
                                             float (&d)[GROUPS][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < GROUPS; ++h)
    d[h][0] = d[h][1] = d[h][2] = d[h][3] = 0.f;
#pragma unroll 4
  for (int k8 = 0; k8 < BLOCK; k8 += 8) {
    const int j_lo = k8 + 2 * t;
    const float4 p_lo = s.pos[j_lo], p_hi = s.pos[j_lo + 1];
    const uint2 bv = *reinterpret_cast<const uint2*>(&s.bm[g][j_lo]);
    const uint32_t b[2] = {bv.x, bv.y};  // {B[j_lo][g], B[j_hi][g]}
    float2 bs = make_float2(0.f, 0.f);
    uint4 cc = make_uint4(0u, 0u, 0u, 0u);
    if (FAST) {
      bs = *reinterpret_cast<const float2*>(&s.bs[j_lo]);
      cc = s.cc[t][k8 + g];
    }
#pragma unroll
    for (int h = 0; h < GROUPS; ++h) {
      // the four cells of the lane's A fragment, in fragment order:
      // (a, j_lo), (b, j_lo), (a, j_hi), (b, j_hi)
      float r2[4];
      if (FAST) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32_k4(c, q[h].x, cc);
        // c = x_t . x_s at (a, j_lo), (a, j_hi), (b, j_lo), (b, j_hi)
        const float cross[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xs = e < 2 ? p_lo.x : p_hi.x;
          const float b_s = e < 2 ? bs.x : bs.y;
          const float dxx = xs - ((e & 1) ? q[h].b.x : q[h].a.x);
          r2[e] = fmaxf(((e & 1) ? q[h].at_b : q[h].at_a) +
                            (b_s - 2.f * cross[e]),
                        dxx * dxx + eps2);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 p = e < 2 ? p_lo : p_hi;
          const Target& tg = (e & 1) ? q[h].b : q[h].a;
          const float dx = p.x - tg.x;
          const float dy = p.y - tg.y;
          const float dz = p.z - tg.z;
          r2[e] = dx * dx + (dy * dy + (dz * dz + eps2));
        }
      }
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(factor<MODE, FOLD>(r2[e], e < 2 ? p_lo.w : p_hi.w),
                   a_hi[e], a_lo[e]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // a fresh fragment a step
      mma_3xtf32_cols(acc, a_hi, a_lo, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) d[h][e] += acc[e];
    }
  }
}

// (s, err) with s + err == a + b exactly (Knuth's two-sum).
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& err) {
  s = a + b;
  const float bb = s - a;
  err = (a - (s - bb)) + (b - bb);
}

}  // namespace nbody
