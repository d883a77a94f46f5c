// All-pairs gravity kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// direct_tile_kernel replaces the TPU kernel _direct_kernel
// (nbody_streams_tpu/ops/pallas_direct.py:301, launched by _pallas_direct
// :449 with skip_band and by _call_kernel :476 without).  band_kernel
// replaces _band_kernel (pallas_direct.py:494, launched by
// _pallas_band_correction :615).
//
// What bounds them: arithmetic.  A pair costs about 19 FP32 operations
// (Newtonian; ~43 for the spline) with one MUFU rsqrt among them; the
// source set of the 64k bench case is 1.3 MB and sits in L2 (50 MB), and
// each block re-reads it through shared memory, so device memory traffic
// is a few bytes per thousand pairs.
//
// What the design does about it: the textbook shared-memory tiling (one
// thread per target, BLOCK sources staged per step, every source reused by
// BLOCK targets from shared memory), selects instead of branches in the
// softening laws, and no fast-math: rsqrt_ftz is the one approximate
// instruction (<= 2 ulp, the IEEE rsqrtf's bits for every normal r^2).
// One block per BLOCK targets fills a quarter of the card at N = 64k, so
// each target block's source stream is split across S blocks (gridDim.y):
// split s sums its share of the source tiles (base pass) or band rows
// (band pass) into a partial (total, comp), plain FP32 over one staged
// tile or band row and a Kahan two-sum across them, as _direct_kernel
// :360-365 sums within and across its source superblocks.  For S > 1 the
// partials go to scratch and a second small launch (combine_kernel)
// adds them in the fixed order s = 0..S-1, Kahan for the Kahan tiers, so
// the sum is the same from run to run; S = 1 writes the output directly.
// The host picks S (cuda_direct.split_count).  Where the TPU multiplied
// the skipped band rows by zero because its vector unit cannot branch per
// tile (pallas_direct.py:304-309), the base pass walks only the tiles
// outside its band; the band is uniform across a block, because a block's
// targets lie in one band tile.  Not done: wgmma, TMA, cp.async staging,
// and fusing the base and band passes.
//
// Layout and pair arithmetic: direct_math.cuh.  Output is (nt, 3) row-major
// for accelerations, (nt,) for potentials; the scratch of S > 1 is
// (2, S, nt * W) floats, totals then compensations, W = 3 or 1.  Kernels
// launch on the caller's stream, allocate nothing and do not synchronise.

#include "direct_math.cuh"

namespace {

using namespace nbody;

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

// The block's result for target i: to out when the grid has one split,
// else (total, comp) to split blockIdx.y of the scratch.
template <int MODE>
__device__ __forceinline__ void store(float* out, float* part, int nt, int i,
                                      const float total[3],
                                      const float comp[3]) {
  if (i >= nt) return;
  constexpr int W = MODE == ACC ? 3 : 1;
  if (gridDim.y == 1) {
#pragma unroll
    for (int c = 0; c < W; ++c) out[W * i + c] = total[c];
    return;
  }
  const long long n = static_cast<long long>(nt) * W;
  float* t = part + blockIdx.y * n + W * i;
  float* e = t + gridDim.y * n;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    t[c] = total[c];
    e[c] = comp[c];
  }
}

template <int W, bool KAHAN>
__device__ __forceinline__ void accumulate(float total[3], float comp[3],
                                           const float p[3]) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (KAHAN) kahan_add(total[c], comp[c], p[c]);
    else total[c] += p[c];
  }
}

// Rows 1 and 2 of the kernel table: every target against its split's share
// of the source tiles, with SKIP the tiles of rows [start[t], start[t] + nb)
// of tn sources of the block's band tile t left out (the band pass covers
// them) and the tiles outside them shared evenly among the splits.
template <int KIND, int MODE, bool KAHAN, bool SKIP>
__global__ void __launch_bounds__(BLOCK)
direct_tile_kernel(const float* __restrict__ tgt, int nt,
                   const float* __restrict__ src, int ns,
                   const int* __restrict__ start, int tm, int tn, int nb,
                   int mask_self, float eps2, float* __restrict__ part,
                   float* __restrict__ out) {
  __shared__ Tile s;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const Target t = load_target(tgt, nt, i);
  const int tiles = ns / BLOCK;
  int band_lo = 0, band_n = 0;  // the band's tiles [band_lo, +band_n)
  if (SKIP) {
    const int per_row = tn / BLOCK;
    const long long lo = static_cast<long long>(
        start[(blockIdx.x * BLOCK) / tm]) * per_row;
    const long long hi = lo + static_cast<long long>(nb) * per_row;
    band_lo = clamp_tile(lo, tiles);
    band_n = clamp_tile(hi, tiles) - band_lo;
  }
  int k_lo, k_hi;
  split_range(tiles - band_n, k_lo, k_hi);
  constexpr int W = MODE == ACC ? 3 : 1;
  float total[3] = {0.f, 0.f, 0.f};
  float comp[3] = {0.f, 0.f, 0.f};
  for (int k = k_lo; k < k_hi; ++k) {
    const int j0 = (k < band_lo ? k : k + band_n) * BLOCK;
    __syncthreads();  // the previous tile is consumed
    stage(s, src, ns, j0);
    __syncthreads();
    float p[3] = {0.f, 0.f, 0.f};
    tile_sum<KIND, MODE>(s, t, i, j0, mask_self != 0, eps2, p);
    accumulate<W, KAHAN>(total, comp, p);
  }
  store<MODE>(out, part, nt, i, total, comp);
}

// Row 3: the full spline over the split's share of each target tile's nb
// band rows of tn sources, plain FP32 within a row and Kahan across rows
// (_band_kernel).
template <int MODE, bool KAHAN>
__global__ void __launch_bounds__(BLOCK)
band_kernel(const float* __restrict__ tgt, int nt,
            const float* __restrict__ src, int ns,
            const int* __restrict__ start, int tm, int tn, int nb,
            int mask_self, float eps2, float* __restrict__ part,
            float* __restrict__ out) {
  __shared__ Tile s;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const Target t = load_target(tgt, nt, i);
  const int row0 = start[(blockIdx.x * BLOCK) / tm];
  if (row0 < 0 || row0 + nb > ns / tn) {  // never read outside the sources
    const float nan3[3] = {__int_as_float(0x7fc00000),
                           __int_as_float(0x7fc00000),
                           __int_as_float(0x7fc00000)};
    const float zero3[3] = {0.f, 0.f, 0.f};
    store<MODE>(out, part, nt, i, nan3, zero3);
    return;  // block-uniform: before any barrier
  }
  int b_lo, b_hi;
  split_range(nb, b_lo, b_hi);
  constexpr int W = MODE == ACC ? 3 : 1;
  float total[3] = {0.f, 0.f, 0.f};
  float comp[3] = {0.f, 0.f, 0.f};
  for (int b = b_lo; b < b_hi; ++b) {
    float p[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c < tn; c += BLOCK) {
      const int j0 = (row0 + b) * tn + c;
      __syncthreads();
      stage(s, src, ns, j0);
      __syncthreads();
      tile_sum<SPLINE, MODE>(s, t, i, j0, mask_self != 0, eps2, p);
    }
    accumulate<W, KAHAN>(total, comp, p);
  }
  store<MODE>(out, part, nt, i, total, comp);
}

// The partials of S splits, n floats each, added in the order s = 0..S-1:
// out = total_0 + ... + total_{S-1}, compensated with every comp_s for
// the Kahan tiers (the running comp takes comp_s before total_s is added).
template <bool KAHAN>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ part, int n, int splits,
               float* __restrict__ out) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  const float* comps = part + static_cast<long long>(splits) * n;
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
  out[e] = total;
}

struct Args {
  const float* tgt;
  int nt;
  const float* src;
  int ns;
  const int* start;
  int tm, tn, nb, mask_self;
  float eps2;
  int splits;
  float* part;
  float* out;
};

dim3 grid(const Args& a) {
  return dim3((a.nt + BLOCK - 1) / BLOCK, a.splits);
}

// The second launch of S > 1: the partials into out.
void launch_combine(bool kahan, int mode, const Args& a,
                    cudaStream_t stream) {
  if (a.splits == 1) return;
  const int n = a.nt * (mode == ACC ? 3 : 1);
  const int blocks = (n + 255) / 256;
  if (kahan)
    combine_kernel<true><<<blocks, 256, 0, stream>>>(a.part, n, a.splits,
                                                     a.out);
  else
    combine_kernel<false><<<blocks, 256, 0, stream>>>(a.part, n, a.splits,
                                                      a.out);
}

template <int KIND, int MODE, bool KAHAN, bool SKIP>
void launch_direct(const Args& a, cudaStream_t stream) {
  direct_tile_kernel<KIND, MODE, KAHAN, SKIP><<<grid(a), BLOCK, 0, stream>>>(
      a.tgt, a.nt, a.src, a.ns, a.start, a.tm, a.tn, a.nb, a.mask_self,
      a.eps2, a.part, a.out);
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

template <int MODE>
void launch_band(bool kahan, const Args& a, cudaStream_t stream) {
  if (kahan) band_kernel<MODE, true><<<grid(a), BLOCK, 0, stream>>>(
      a.tgt, a.nt, a.src, a.ns, a.start, a.tm, a.tn, a.nb, a.mask_self,
      a.eps2, a.part, a.out);
  else band_kernel<MODE, false><<<grid(a), BLOCK, 0, stream>>>(
      a.tgt, a.nt, a.src, a.ns, a.start, a.tm, a.tn, a.nb, a.mask_self,
      a.eps2, a.part, a.out);
}

// IEEE rsqrtf and rsqrt_ftz side by side, for the card test that holds
// them equal on normal arguments.
__global__ void rsqrt_pair_kernel(const float* __restrict__ x, int n,
                                  float* __restrict__ ieee,
                                  float* __restrict__ ftz) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  ieee[i] = rsqrtf(x[i]);
  ftz[i] = rsqrt_ftz(x[i]);
}

bool bad_splits(int splits, const float* part) {
  return splits < 1 || splits > 65535 || (splits > 1 && part == nullptr);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 on success).
// `splits` is the grid's S; for S > 1 `part` is the (2, S, nt * W) float
// scratch and a combine launch follows the kernel.
int nbody_direct(int kind, int mode, int kahan, int nb, const float* tgt,
                 int nt, const float* src, int ns, const int* start, int tm,
                 int tn, int mask_self, float eps2, int splits, float* part,
                 float* out, void* stream) {
  if (kind < NEWTONIAN || kind > SPLINE || (mode != ACC && mode != POT) ||
      nt <= 0 || ns <= 0 || ns % BLOCK != 0 || (nb > 0 && start == nullptr) ||
      (nb > 0 && (tm <= 0 || tn % BLOCK != 0)) || bad_splits(splits, part))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{tgt, nt, src, ns, start, tm, tn, nb, mask_self, eps2,
               splits, part, out};
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
  launch_combine(kahan, mode, a, s);
  return static_cast<int>(cudaGetLastError());
}

int nbody_band(int mode, int kahan, int nb, const float* tgt, int nt,
               const float* src, int ns, const int* start, int tm, int tn,
               int mask_self, float eps2, int splits, float* part,
               float* out, void* stream) {
  if ((mode != ACC && mode != POT) || nt <= 0 || nb <= 0 || tm <= 0 ||
      tn <= 0 || ns % BLOCK != 0 || tn % BLOCK != 0 || start == nullptr ||
      bad_splits(splits, part))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{tgt, nt, src, ns, start, tm, tn, nb, mask_self, eps2,
               splits, part, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == ACC) launch_band<ACC>(kahan, a, s);
  else launch_band<POT>(kahan, a, s);
  launch_combine(kahan, mode, a, s);
  return static_cast<int>(cudaGetLastError());
}

int nbody_rsqrt_pair(const float* x, int n, float* ieee, float* ftz,
                     void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rsqrt_pair_kernel<<<(n + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, n, ieee, ftz);
  return static_cast<int>(cudaGetLastError());
}

int nbody_block_size() { return BLOCK; }

const char* nbody_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
