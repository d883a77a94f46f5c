// Pair arithmetic of the all-pairs kernels, shared by direct.cu (the force
// kernels) and roofline.cu (tile_sol_kernel, their speed of light), so that
// both run the identical instructions.
//
// Layout: targets are (4, nt) float32 rows x, y, z, pre; sources are
// (5, ns) float32 rows x, y, z, G*m, pre with ns a multiple of BLOCK (zero
// padded: zero mass contributes exactly nothing).  `pre` is the per-particle
// softening quantity of _soft_pre: 1/h (inf for h = 0) for the spline,
// h^2 otherwise.
#pragma once

#include <cuda_runtime.h>

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

// Kahan two-sum: (total, comp) += delta
__device__ __forceinline__ void kahan_add(float& total, float& comp,
                                          float delta) {
  const float y = delta - comp;
  const float t = total + y;
  comp = (t - total) - y;
  total = t;
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

// Plain FP32 sum of one staged tile into p[0..2] (acc) or p[0] (pot).
// Potential mode zeroes the self pair (global source index == i).
template <int KIND, int MODE>
__device__ __forceinline__ void tile_sum(const Tile& s, const Target& t,
                                         int i, int j0, bool mask_self,
                                         float eps2, float p[3]) {
#pragma unroll 8
  for (int k = 0; k < BLOCK; ++k) {
    const float dx = s.x[k] - t.x;
    const float dy = s.y[k] - t.y;
    const float dz = s.z[k] - t.z;
    const float r2 = dx * dx + (dy * dy + (dz * dz + eps2));
    const float pre = pair_pre<KIND>(t.pre, s.pre[k]);
    if (MODE == ACC) {
      const float w = s.gm[k] * force_pre<KIND>(r2, pre);
      p[0] += w * dx;
      p[1] += w * dy;
      p[2] += w * dz;
    } else {
      const float u = s.gm[k] * pot_pre<KIND>(r2, pre);
      p[0] += (mask_self && j0 + k == i) ? 0.f : u;
    }
  }
}

}  // namespace nbody
