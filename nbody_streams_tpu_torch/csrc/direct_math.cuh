// Pair arithmetic of the all-pairs kernels, shared by direct.cu (the force
// kernels), moment.cu (their tensor-core forms) and roofline.cu
// (tile_sol_kernel, their speed of light), so that all run the identical
// instructions.
//
// Layout: targets are (4, nt) float32 rows x, y, z, pre; sources are
// (5, ns) float32 rows x, y, z, G*m, pre with ns a multiple of BLOCK (zero
// padded: zero mass contributes exactly nothing).  `pre` is the per-particle
// softening quantity of _soft_pre: 1/h (inf for h = 0) for the spline,
// h^2 otherwise.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace nbody {

constexpr int BLOCK = 64;  // targets per block == sources per staged tile

enum Kind { NEWTONIAN = 0, PLUMMER = 1, DEHNEN_K1 = 2, DEHNEN_K2 = 3,
            SPLINE = 4 };
enum Mode { ACC = 0, POT = 1 };

// rsqrt.approx with denormals flushed: MUFU.RSQ alone.  The IEEE form
// (rsqrtf) adds a range check and a scale before and after the MUFU, one
// FSETP and two FMUL a pair, that change only a denormal argument; every
// r^2 here is >= eps2 (1e-15 on the main path), so both give the same bits.
// Only this instruction flushes: the build keeps IEEE denormals (no -ftz,
// no fast-math) for the Kahan terms and everything else.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Pair softening from the per-particle quantities: h_eff = max(h_i, h_j)
// is min(1/h_i, 1/h_j) for the spline and max(h_i^2, h_j^2) otherwise.
template <int KIND>
__device__ __forceinline__ float pair_pre(float pi, float pj) {
  return KIND == SPLINE ? fminf(pi, pj) : fmaxf(pi, pj);
}

// force factor w with a_i += G m_j w (x_j - x_i); mirrors _force_pre
template <int KIND>
__device__ __forceinline__ float force_pre(float r2, float pre) {
  if (KIND == PLUMMER) {
    const float inv = rsqrt_ftz(r2 + pre);
    return inv * inv * inv;
  } else if (KIND == DEHNEN_K1) {
    const float inv = rsqrt_ftz(r2 + pre);
    const float inv_d = inv * inv;
    const float inv_d32 = inv_d * inv;
    return inv_d32 + 1.5f * pre * (inv_d32 * inv_d);
  } else if (KIND == DEHNEN_K2) {
    const float inv = rsqrt_ftz(r2 + pre);
    const float inv_d = inv * inv;
    const float inv_d32 = inv_d * inv;
    const float inv_d52 = inv_d32 * inv_d;
    return inv_d32 + 1.5f * pre * inv_d52 +
           3.75f * (pre * pre) * (inv_d52 * inv_d);
  } else if (KIND == NEWTONIAN) {
    const float inv = rsqrt_ftz(r2);
    return inv * inv * inv;
  } else {  // SPLINE, pre = 1/h_eff (inf for h = 0: q = inf selects newton)
    const float inv_r = rsqrt_ftz(r2);
    const float r = r2 * inv_r;
    const float newton = inv_r * inv_r * inv_r;
    const float hinv = pre;
    const float h3inv = hinv * hinv * hinv;
    const float q = r * hinv;
    const float q2 = q * q;
    const float inner = h3inv * (q2 * (32.0f * q - 38.4f) +
                                 10.666666666666666f);
    const float outer =
        h3inv * (21.333333333333333f +
                 q * (-48.0f + q * (38.4f - 10.666666666666667f * q))) -
        0.0666666666666667f * newton;
    const float soft = q <= 0.5f ? inner : outer;
    return q >= 1.0f ? newton : soft;
  }
}

// potential factor u with phi_i += G m_j u; mirrors _pot_pre
template <int KIND>
__device__ __forceinline__ float pot_pre(float r2, float pre) {
  if (KIND == PLUMMER) {
    return -rsqrt_ftz(r2 + pre);
  } else if (KIND == DEHNEN_K1) {
    const float inv = rsqrt_ftz(r2 + pre);
    const float inv_d32 = inv * inv * inv;
    return -inv - 0.5f * pre * inv_d32;
  } else if (KIND == DEHNEN_K2) {
    const float inv = rsqrt_ftz(r2 + pre);
    const float inv_d32 = inv * inv * inv;
    const float inv_d52 = inv_d32 * inv * inv;
    return -inv - 0.5f * pre * inv_d32 - 0.375f * (pre * pre) * inv_d52;
  } else if (KIND == NEWTONIAN) {
    return -rsqrt_ftz(r2);
  } else {  // SPLINE: q^2 nesting of the inner branch (ops/kernels.py)
    const float inv_r = rsqrt_ftz(r2);
    const float r = r2 * inv_r;
    const float newton = -inv_r;
    const float hinv = pre;
    const float q = r * hinv;
    const float q2 = q * q;
    const float inner =
        (-2.8f + q2 * (5.333333333333333f + q2 * (6.4f * q - 9.6f))) * hinv;
    const float outer =
        (-3.2f + q2 * (10.666666666666666f +
                       q * (-16.0f + q * (9.6f - 2.1333333333333333f * q)))) *
            hinv +
        0.06666666666666667f * inv_r;
    const float soft = q <= 0.5f ? inner : outer;
    return q >= 1.0f ? newton : soft;
  }
}

// Tensor-core products (moment_math.cuh).  A TF32 operand keeps 10 of
// fp32's 23 mantissa bits, so one TF32 product keeps about three decimal
// digits: the Hopper form of the TPU's bf16 operand trap (the JAX package
// pins every matrix-unit contraction to Precision.HIGHEST for it).  Every
// product is therefore 3xTF32: each operand is split as hi + lo
// (split_tf32), and hi.hi, hi.lo and lo.hi all reach the fp32 fragment;
// only lo.lo (~2^-22 relative) may be dropped.  The two forms below pack
// the three products into two mma instructions, one through the columns of
// B, one through the contraction; mma_tf32_1pass is the one place that
// issues the instruction, and only they call it (tests/test_torch_moment.py
// holds csrc/ to that).
//
// The split: hi is a rounded to TF32 (nearest, ties away: add half a TF32
// ulp to the bits, clear the 13 low bits; two integer operations, where
// cvt.rna.tf32.f32 compiles to four with an infinity guard), lo = a - hi
// exactly in fp32.  lo goes to the tensor cores as it is: they read the
// top 19 bits of a TF32 operand and ignore the 13 low ones (the compiler
// itself leaves them unmasked when cvt.rna's result only feeds an mma),
// so lo is truncated there, an error below 2^-21 |a| of either sign.  A
// factor that is inf (r^2 = 0) keeps hi = inf and lo = NaN, as the cvt
// form did; no path hands the moment forms a zero r^2.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += A(16x8, row) B(8x8, col) in one TF32 pass: m16n8k8, g = lane / 4,
// t = lane % 4; a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]} (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32).
__device__ __forceinline__ void mma_tf32_1pass(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 through B's columns, for a product of at most 4 columns: B's
// columns 0-3 hold the hi halves of those columns and 4-7 their lo halves
// (b = {B[t][g], B[t+4][g]}, split at staging).  Then D's columns c and
// c + 4 hold lo.hi + hi.hi and lo.lo + hi.lo of column c; the caller adds
// them (the lanes t and t ^ 2).  The small product first.
__device__ __forceinline__ void mma_3xtf32_cols(float d[4],
                                                const uint32_t a_hi[4],
                                                const uint32_t a_lo[4],
                                                const uint32_t b[2]) {
  mma_tf32_1pass(d, a_lo, b);
  mma_tf32_1pass(d, a_hi, b);
}

// 3xTF32 through the contraction, for a contraction of at most 4: A's
// columns 0-3 hold the hi halves of A and 4-7 its lo halves (a = {hi[g][t],
// hi[g+8][t], lo[g][t], lo[g+8][t]}); b = {hi, hi, lo, 0}, B's row t,
// column g split, as the two passes' B operands (staged so, one load).
// The first pass sums hi.lo (B's lo against A's hi, zero against A's lo),
// the second hi.hi + lo.hi.
__device__ __forceinline__ void mma_3xtf32_k4(float d[4], const uint32_t a[4],
                                              const uint4& b) {
  const uint32_t lo[2] = {b.z, b.w}, hi[2] = {b.x, b.y};
  mma_tf32_1pass(d, a, lo);
  mma_tf32_1pass(d, a, hi);
}

// Kahan two-sum: (total, comp) += delta
__device__ __forceinline__ void kahan_add(float& total, float& comp,
                                          float delta) {
  const float y = delta - comp;
  const float t = total + y;
  comp = (t - total) - y;
  total = t;
}

// The source-stream splits and the band skip of direct.cu and moment.cu.
// Split s of S's share [lo, hi) of n units: the shares differ by one unit
// at most, and they tile [0, n) in order.
__device__ __forceinline__ void split_range(int n, int& lo, int& hi) {
  const long long s = blockIdx.y, S = gridDim.y;
  lo = static_cast<int>(s * n / S);
  hi = static_cast<int>((s + 1) * n / S);
}

__device__ __forceinline__ int clamp_tile(long long k, int tiles) {
  return static_cast<int>(k < 0 ? 0 : (k > tiles ? tiles : k));
}

// With SKIP, the tiles [band_lo, band_lo + band_n) of the block's band
// rows [start[t], start[t] + nb) of tn sources, t the block's band tile.
template <bool SKIP>
__device__ __forceinline__ void band_tiles(const int* __restrict__ start,
                                           int tm, int tn, int nb, int tiles,
                                           int& band_lo, int& band_n) {
  band_lo = band_n = 0;
  if (SKIP) {
    const int per_row = tn / BLOCK;
    const long long lo = static_cast<long long>(
        start[(blockIdx.x * BLOCK) / tm]) * per_row;
    const long long hi = lo + static_cast<long long>(nb) * per_row;
    band_lo = clamp_tile(lo, tiles);
    band_n = clamp_tile(hi, tiles) - band_lo;
  }
}

// The source tile of the split-local index k: the tiles outside the band,
// in order.
__device__ __forceinline__ int tile_of(int k, int band_lo, int band_n) {
  return k < band_lo ? k : k + band_n;
}

struct Target {
  float x, y, z, pre;
};

__device__ __forceinline__ Target load_target(const float* tgt, int nt,
                                              int i) {
  Target t{0.f, 0.f, 0.f, 0.f};
  if (i < nt) {
    t.x = tgt[i];
    t.y = tgt[nt + i];
    t.z = tgt[2 * nt + i];
    t.pre = tgt[3 * nt + i];
  }
  return t;
}

struct Tile {
  float x[BLOCK], y[BLOCK], z[BLOCK], gm[BLOCK], pre[BLOCK];
};

// Stage sources [j0, j0 + BLOCK) into shared memory (one per thread).
__device__ __forceinline__ void stage(Tile& s, const float* src, int ns,
                                      int j0) {
  const int j = j0 + threadIdx.x;
  s.x[threadIdx.x] = src[j];
  s.y[threadIdx.x] = src[ns + j];
  s.z[threadIdx.x] = src[2 * ns + j];
  s.gm[threadIdx.x] = src[3 * ns + j];
  s.pre[threadIdx.x] = src[4 * ns + j];
}

// Plain FP32 sum of the accelerations of one staged tile into p[0..2].
template <int KIND>
__device__ __forceinline__ void tile_sum(const Tile& s, const Target& t,
                                         float eps2, float p[3]) {
#pragma unroll 8
  for (int k = 0; k < BLOCK; ++k) {
    const float dx = s.x[k] - t.x;
    const float dy = s.y[k] - t.y;
    const float dz = s.z[k] - t.z;
    const float r2 = dx * dx + (dy * dy + (dz * dz + eps2));
    const float pre = pair_pre<KIND>(t.pre, s.pre[k]);
    const float w = s.gm[k] * force_pre<KIND>(r2, pre);
    p[0] += w * dx;
    p[1] += w * dy;
    p[2] += w * dz;
  }
}

// BLOCK staged sources in shared memory, one pointer a row.
struct Rows {
  const float *x, *y, *z, *gm, *pre;
};

__device__ __forceinline__ Rows rows_of(const Tile& s) {
  return Rows{s.x, s.y, s.z, s.gm, s.pre};
}

// Plain FP32 sum of the potential of BLOCK staged sources on TPT targets a
// thread, each into p[a] in k order; thread l holds the block's targets
// l + a * BLOCK / TPT.  A term goes in as one FFMA, G m u and the sum
// rounded once, where the plain version rounds the product and then the
// sum: a term differs from it by at most one ulp of the term.  MASK, for
// the block's diagonal tile only (the one whose first source index is the
// block's first target index), zeroes the pair k = l + a * BLOCK / TPT,
// the target's own index; every other tile runs the loop without the test.
// For the Plummer law the caller has added eps2 to both sides' h^2 (pre):
// max(h_i^2 + eps2, h_j^2 + eps2) is max(h_i^2, h_j^2) + eps2 exactly
// (rounding is monotone), so r^2 + eps2 + h^2 takes one add fewer, summed
// in another order (within an ulp or two of r2 + pre).
template <int KIND, bool MASK, int TPT>
__device__ __forceinline__ void pot_sum(const Rows& s, const Target* t,
                                        float eps2, float* p) {
#pragma unroll 8
  for (int k = 0; k < BLOCK; ++k) {
    const float xs = s.x[k], ys = s.y[k], zs = s.z[k];
    const float gs = s.gm[k], ps = s.pre[k];
#pragma unroll
    for (int a = 0; a < TPT; ++a) {
      const float dx = xs - t[a].x;
      const float dy = ys - t[a].y;
      const float dz = zs - t[a].z;
      float u;
      if constexpr (KIND == PLUMMER) {
        u = -rsqrt_ftz(dx * dx + (dy * dy + (dz * dz + fmaxf(t[a].pre, ps))));
      } else {
        const float r2 = dx * dx + (dy * dy + (dz * dz + eps2));
        u = pot_pre<KIND>(r2, pair_pre<KIND>(t[a].pre, ps));
      }
      const bool self =
          MASK && k == static_cast<int>(threadIdx.x) + a * (BLOCK / TPT);
      p[a] = fmaf(gs, self ? 0.f : u, p[a]);
    }
  }
}

}  // namespace nbody
