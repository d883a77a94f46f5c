// All-pairs gravity kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// direct_tile_kernel replaces the TPU kernel _direct_kernel
// (nbody_streams_tpu/ops/pallas_direct.py:301, launched by _pallas_direct
// :449 with skip_band and by _call_kernel :476 without).  band_kernel
// replaces _band_kernel (pallas_direct.py:494, launched by
// _pallas_band_correction :615).
//
// What bounds them: arithmetic.  A pair costs about 20 FP32 operations plus
// one MUFU rsqrt; the source set of the 64k bench case is 1.3 MB and sits in
// L2 (50 MB), and each block re-reads it through shared memory, so device
// memory traffic is a few bytes per thousand pairs.
//
// What the simple design does about it: the textbook shared-memory tiling
// (one thread per target, BLOCK sources staged per step, every source
// reused by BLOCK targets from shared memory), selects instead of branches
// in the softening laws, and no fast-math: rsqrtf is the one approximate
// instruction (<= 2 ulp).  The sum is plain FP32 over one staged tile and
// a register Kahan two-sum across tiles, as _direct_kernel:360-365 sums
// within and across its source superblocks.  Where the TPU multiplied the
// skipped band rows by zero because its vector unit cannot branch per tile
// (pallas_direct.py:304-309), this kernel skips them: the branch is
// uniform across the block, because a block's targets lie in one band tile.
// Not done yet: several threads per target (occupancy at N = 64k is one
// quarter of the card), wgmma, TMA, and fusing the base and band passes.
//
// Layout: targets are (4, nt) float32 rows x, y, z, pre; sources are
// (5, ns) float32 rows x, y, z, G*m, pre with ns a multiple of BLOCK (zero
// padded: zero mass contributes exactly nothing).  `pre` is the per-particle
// softening quantity of _soft_pre: 1/h (inf for h = 0) for the spline,
// h^2 otherwise.  Output is (nt, 3) row-major for accelerations, (nt,) for
// potentials.  Kernels launch on the caller's stream, allocate nothing and
// do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 64;  // targets per block == sources per staged tile

enum Kind { NEWTONIAN = 0, PLUMMER = 1, DEHNEN_K1 = 2, DEHNEN_K2 = 3,
            SPLINE = 4 };
enum Mode { ACC = 0, POT = 1 };

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
    const float inv = rsqrtf(r2 + pre);
    return inv * inv * inv;
  } else if (KIND == DEHNEN_K1) {
    const float inv = rsqrtf(r2 + pre);
    const float inv_d = inv * inv;
    const float inv_d32 = inv_d * inv;
    return inv_d32 + 1.5f * pre * (inv_d32 * inv_d);
  } else if (KIND == DEHNEN_K2) {
    const float inv = rsqrtf(r2 + pre);
    const float inv_d = inv * inv;
    const float inv_d32 = inv_d * inv;
    const float inv_d52 = inv_d32 * inv_d;
    return inv_d32 + 1.5f * pre * inv_d52 +
           3.75f * (pre * pre) * (inv_d52 * inv_d);
  } else if (KIND == NEWTONIAN) {
    const float inv = rsqrtf(r2);
    return inv * inv * inv;
  } else {  // SPLINE, pre = 1/h_eff (inf for h = 0: q = inf selects newton)
    const float inv_r = rsqrtf(r2);
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
    return -rsqrtf(r2 + pre);
  } else if (KIND == DEHNEN_K1) {
    const float inv = rsqrtf(r2 + pre);
    const float inv_d32 = inv * inv * inv;
    return -inv - 0.5f * pre * inv_d32;
  } else if (KIND == DEHNEN_K2) {
    const float inv = rsqrtf(r2 + pre);
    const float inv_d32 = inv * inv * inv;
    const float inv_d52 = inv_d32 * inv * inv;
    return -inv - 0.5f * pre * inv_d32 - 0.375f * (pre * pre) * inv_d52;
  } else if (KIND == NEWTONIAN) {
    return -rsqrtf(r2);
  } else {  // SPLINE: q^2 nesting of the inner branch (ops/kernels.py)
    const float inv_r = rsqrtf(r2);
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

template <int MODE>
__device__ __forceinline__ void store(float* out, int nt, int i,
                                      const float a[3]) {
  if (i >= nt) return;
  if (MODE == ACC) {
    out[3 * i] = a[0];
    out[3 * i + 1] = a[1];
    out[3 * i + 2] = a[2];
  } else {
    out[i] = a[0];
  }
}

// Rows 1 and 2 of the kernel table: every target against every source
// tile, with SKIP the source rows [start[t] * tn, (start[t] + nb) * tn) of
// the block's band tile t left out (the band pass covers them).
template <int KIND, int MODE, bool KAHAN, bool SKIP>
__global__ void __launch_bounds__(BLOCK)
direct_tile_kernel(const float* __restrict__ tgt, int nt,
                   const float* __restrict__ src, int ns,
                   const int* __restrict__ start, int tm, int tn, int nb,
                   int mask_self, float eps2, float* __restrict__ out) {
  __shared__ Tile s;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const Target t = load_target(tgt, nt, i);
  int skip_lo = 0, skip_hi = 0;
  if (SKIP) {
    skip_lo = start[(blockIdx.x * BLOCK) / tm] * tn;
    skip_hi = skip_lo + nb * tn;
  }
  constexpr int W = MODE == ACC ? 3 : 1;
  float total[3] = {0.f, 0.f, 0.f};
  float comp[3] = {0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < ns; j0 += BLOCK) {
    if (SKIP && j0 >= skip_lo && j0 < skip_hi) continue;  // block-uniform
    __syncthreads();  // the previous tile is consumed
    stage(s, src, ns, j0);
    __syncthreads();
    float p[3] = {0.f, 0.f, 0.f};
    tile_sum<KIND, MODE>(s, t, i, j0, mask_self != 0, eps2, p);
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (KAHAN) kahan_add(total[c], comp[c], p[c]);
      else total[c] += p[c];
    }
  }
  store<MODE>(out, nt, i, total);
}

// Row 3: the full spline over each target tile's nb band rows of tn
// sources, plain FP32 within a row and Kahan across rows (_band_kernel).
template <int MODE, bool KAHAN>
__global__ void __launch_bounds__(BLOCK)
band_kernel(const float* __restrict__ tgt, int nt,
            const float* __restrict__ src, int ns,
            const int* __restrict__ start, int tm, int tn, int nb,
            int mask_self, float eps2, float* __restrict__ out) {
  __shared__ Tile s;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const Target t = load_target(tgt, nt, i);
  const int row0 = start[(blockIdx.x * BLOCK) / tm];
  if (row0 < 0 || row0 + nb > ns / tn) {  // never read outside the sources
    const float nan3[3] = {__int_as_float(0x7fc00000),
                           __int_as_float(0x7fc00000),
                           __int_as_float(0x7fc00000)};
    store<MODE>(out, nt, i, nan3);
    return;  // block-uniform: before any barrier
  }
  constexpr int W = MODE == ACC ? 3 : 1;
  float total[3] = {0.f, 0.f, 0.f};
  float comp[3] = {0.f, 0.f, 0.f};
  for (int b = 0; b < nb; ++b) {
    float p[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c < tn; c += BLOCK) {
      const int j0 = (row0 + b) * tn + c;
      __syncthreads();
      stage(s, src, ns, j0);
      __syncthreads();
      tile_sum<SPLINE, MODE>(s, t, i, j0, mask_self != 0, eps2, p);
    }
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (KAHAN) kahan_add(total[c], comp[c], p[c]);
      else total[c] += p[c];
    }
  }
  store<MODE>(out, nt, i, total);
}

struct Args {
  const float* tgt;
  int nt;
  const float* src;
  int ns;
  const int* start;
  int tm, tn, nb, mask_self;
  float eps2;
  float* out;
};

template <int KIND, int MODE, bool KAHAN, bool SKIP>
void launch_direct(const Args& a, cudaStream_t stream) {
  const int grid = (a.nt + BLOCK - 1) / BLOCK;
  direct_tile_kernel<KIND, MODE, KAHAN, SKIP><<<grid, BLOCK, 0, stream>>>(
      a.tgt, a.nt, a.src, a.ns, a.start, a.tm, a.tn, a.nb, a.mask_self,
      a.eps2, a.out);
}

template <int KIND, int MODE>
void launch_direct_flags(bool kahan, bool skip, const Args& a,
                         cudaStream_t stream) {
  if (kahan) {
    if (skip) launch_direct<KIND, MODE, true, true>(a, stream);
    else launch_direct<KIND, MODE, true, false>(a, stream);
  } else {
    if (skip) launch_direct<KIND, MODE, false, true>(a, stream);
    else launch_direct<KIND, MODE, false, false>(a, stream);
  }
}

template <int KIND>
void launch_direct_mode(int mode, bool kahan, bool skip, const Args& a,
                        cudaStream_t stream) {
  if (mode == ACC) launch_direct_flags<KIND, ACC>(kahan, skip, a, stream);
  else launch_direct_flags<KIND, POT>(kahan, skip, a, stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int nbody_direct(int kind, int mode, int kahan, int nb, const float* tgt,
                 int nt, const float* src, int ns, const int* start, int tm,
                 int tn, int mask_self, float eps2, float* out,
                 void* stream) {
  if (kind < NEWTONIAN || kind > SPLINE || (mode != ACC && mode != POT) ||
      nt <= 0 || ns <= 0 || ns % BLOCK != 0 || (nb > 0 && start == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{tgt, nt, src, ns, start, tm, tn, nb, mask_self, eps2, out};
  const bool skip = nb > 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case NEWTONIAN: launch_direct_mode<NEWTONIAN>(mode, kahan, skip, a, s);
      break;
    case PLUMMER: launch_direct_mode<PLUMMER>(mode, kahan, skip, a, s);
      break;
    case DEHNEN_K1: launch_direct_mode<DEHNEN_K1>(mode, kahan, skip, a, s);
      break;
    case DEHNEN_K2: launch_direct_mode<DEHNEN_K2>(mode, kahan, skip, a, s);
      break;
    default: launch_direct_mode<SPLINE>(mode, kahan, skip, a, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

int nbody_band(int mode, int kahan, int nb, const float* tgt, int nt,
               const float* src, int ns, const int* start, int tm, int tn,
               int mask_self, float eps2, float* out, void* stream) {
  if ((mode != ACC && mode != POT) || nt <= 0 || nb <= 0 ||
      ns % BLOCK != 0 || tn % BLOCK != 0 || start == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (nt + BLOCK - 1) / BLOCK;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == ACC) {
    if (kahan) band_kernel<ACC, true><<<grid, BLOCK, 0, s>>>(
        tgt, nt, src, ns, start, tm, tn, nb, mask_self, eps2, out);
    else band_kernel<ACC, false><<<grid, BLOCK, 0, s>>>(
        tgt, nt, src, ns, start, tm, tn, nb, mask_self, eps2, out);
  } else {
    if (kahan) band_kernel<POT, true><<<grid, BLOCK, 0, s>>>(
        tgt, nt, src, ns, start, tm, tn, nb, mask_self, eps2, out);
    else band_kernel<POT, false><<<grid, BLOCK, 0, s>>>(
        tgt, nt, src, ns, start, tm, tn, nb, mask_self, eps2, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int nbody_block_size() { return BLOCK; }

const char* nbody_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
