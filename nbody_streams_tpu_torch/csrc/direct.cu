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
// Layout and pair arithmetic: direct_math.cuh.  Output is (nt, 3) row-major
// for accelerations, (nt,) for potentials.  Kernels launch on the caller's
// stream, allocate nothing and do not synchronise.

#include "direct_math.cuh"

namespace {

using namespace nbody;

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
