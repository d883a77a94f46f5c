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
// The potential forms (MODE == POT: the CylSpline fit's two-set call,
// bound_phi's friction potential, system_energy) do a pair in ~10 FP32
// operations and one MUFU rsqrt, so the loop's own overhead weighs more
// than in the acceleration forms.  What keeps it small:
// - the self mask (pairs at identical index) runs only on the block's
//   diagonal tile, the one source tile that can hold j == i for the
//   block's targets (tiles start at multiples of BLOCK); every other tile,
//   and every tile of a call without the mask, runs the loop without the
//   compare and select;
// - each term goes into the sum as one FFMA, and the Plummer law adds
//   eps2 to h^2 as it is loaded, one add a pair fewer (pot_sum);
// - direct_tile_kernel stages POT_GROUPS tiles per barrier pair with
//   16-byte loads, and each thread holds POT_TPT targets, so that every
//   staged source in a register serves POT_TPT pairs (one target a
//   thread, or a cap of 64 registers, measured slower on the H100).
// A block still covers BLOCK targets, so the grid, the split count, the
// band tile and the diagonal tile are those of the acceleration forms.
// The sum per target keeps its order: plain FP32 over each tile in k
// order, a Kahan step between tiles, the fixed-order combine over splits.
// The acceleration forms keep their own instruction sequence.
//
// Layout and pair arithmetic: direct_math.cuh.  Output is (nt, 3) row-major
// for accelerations, (nt,) for potentials; the scratch of S > 1 is
// (2, S, nt * W) floats, totals then compensations, W = 3 or 1.  Kernels
// launch on the caller's stream, allocate nothing and do not synchronise.
// The sources are 16-byte aligned (the potential forms load float4s).

#include <cstdint>

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

// The potential forms of direct_tile_kernel: POT_TPT targets a thread,
// POT_THREADS threads a block of BLOCK targets, POT_GROUPS tiles staged a
// barrier pair.
constexpr int POT_TPT = 2;
constexpr int POT_THREADS = BLOCK / POT_TPT;
constexpr int POT_GROUPS = 4;

struct alignas(16) Groups {  // row r of staged tile g at row[r][g * BLOCK]
  float row[5][POT_GROUPS * BLOCK];
};

// Stage the split's tiles k .. k + n - 1 (n <= POT_GROUPS) with one float4
// of a row a load; for the Plummer law h^2 + eps2 (pot_sum).
template <int KIND>
__device__ __forceinline__ void stage_groups(Groups& s,
                                             const float* __restrict__ src,
                                             int ns, int k, int n,
                                             int band_lo, int band_n,
                                             float eps2) {
  constexpr int Q = BLOCK / 4;            // float4s of a tile's row
  constexpr int PER_ROW = POT_GROUPS * Q;
  static_assert(5 * PER_ROW % POT_THREADS == 0, "whole trips");
#pragma unroll
  for (int m = 0; m < 5 * PER_ROW / POT_THREADS; ++m) {
    const int e = m * POT_THREADS + threadIdx.x;
    const int r = e / PER_ROW, g = (e / Q) % POT_GROUPS, q = e % Q;
    if (g < n) {
      const int j0 = tile_of(k + g, band_lo, band_n) * BLOCK;
      float4 v = reinterpret_cast<const float4*>(src + r * ns + j0)[q];
      if (KIND == PLUMMER && r == 4) {
        v.x += eps2;
        v.y += eps2;
        v.z += eps2;
        v.w += eps2;
      }
      reinterpret_cast<float4*>(s.row[r] + g * BLOCK)[q] = v;
    }
  }
}

template <int KIND, bool KAHAN, bool SKIP>
__device__ __forceinline__ void direct_pot(
    const float* __restrict__ tgt, int nt, const float* __restrict__ src,
    int ns, const int* __restrict__ start, int tm, int tn, int nb,
    int mask_self, float eps2, float* __restrict__ part,
    float* __restrict__ out) {
  __shared__ Groups s;
  const int i0 = blockIdx.x * BLOCK + threadIdx.x;
  Target t[POT_TPT];
#pragma unroll
  for (int a = 0; a < POT_TPT; ++a) {
    t[a] = load_target(tgt, nt, i0 + a * POT_THREADS);
    if (KIND == PLUMMER) t[a].pre += eps2;  // as stage_groups
  }
  const int tiles = ns / BLOCK;
  int band_lo, band_n;
  band_tiles<SKIP>(start, tm, tn, nb, tiles, band_lo, band_n);
  int k_lo, k_hi;
  split_range(tiles - band_n, k_lo, k_hi);
  // the block's diagonal tile: j0 == its first target index
  const int diag = mask_self ? static_cast<int>(blockIdx.x) : -1;
  float total[POT_TPT], comp[POT_TPT];
#pragma unroll
  for (int a = 0; a < POT_TPT; ++a) total[a] = comp[a] = 0.f;
  for (int k = k_lo; k < k_hi; k += POT_GROUPS) {
    const int n = min(POT_GROUPS, k_hi - k);
    __syncthreads();  // the previous tiles are consumed
    stage_groups<KIND>(s, src, ns, k, n, band_lo, band_n, eps2);
    __syncthreads();
    for (int g = 0; g < n; ++g) {
      const Rows rows{s.row[0] + g * BLOCK, s.row[1] + g * BLOCK,
                      s.row[2] + g * BLOCK, s.row[3] + g * BLOCK,
                      s.row[4] + g * BLOCK};
      float p[POT_TPT];
#pragma unroll
      for (int a = 0; a < POT_TPT; ++a) p[a] = 0.f;
      if (tile_of(k + g, band_lo, band_n) == diag)
        pot_sum<KIND, true, POT_TPT>(rows, t, eps2, p);
      else
        pot_sum<KIND, false, POT_TPT>(rows, t, eps2, p);
#pragma unroll
      for (int a = 0; a < POT_TPT; ++a) {
        if (KAHAN) kahan_add(total[a], comp[a], p[a]);
        else total[a] += p[a];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < POT_TPT; ++a)
    store<POT>(out, part, nt, i0 + a * POT_THREADS, &total[a], &comp[a]);
}

// Rows 1, 2 and 2b of the kernel table: every target against its split's
// share of the source tiles, with SKIP the band's tiles left out (the band
// pass covers them) and the tiles outside them shared evenly among the
// splits.  MODE == POT runs direct_pot.
template <int KIND, int MODE, bool KAHAN, bool SKIP>
__global__ void __launch_bounds__(MODE == ACC ? BLOCK : POT_THREADS)
direct_tile_kernel(const float* __restrict__ tgt, int nt,
                   const float* __restrict__ src, int ns,
                   const int* __restrict__ start, int tm, int tn, int nb,
                   int mask_self, float eps2, float* __restrict__ part,
                   float* __restrict__ out) {
  if constexpr (MODE == POT) {
    direct_pot<KIND, KAHAN, SKIP>(tgt, nt, src, ns, start, tm, tn, nb,
                                  mask_self, eps2, part, out);
  } else {
    __shared__ Tile s;
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    const Target t = load_target(tgt, nt, i);
    const int tiles = ns / BLOCK;
    int band_lo, band_n;
    band_tiles<SKIP>(start, tm, tn, nb, tiles, band_lo, band_n);
    int k_lo, k_hi;
    split_range(tiles - band_n, k_lo, k_hi);
    float total[3] = {0.f, 0.f, 0.f};
    float comp[3] = {0.f, 0.f, 0.f};
    for (int k = k_lo; k < k_hi; ++k) {
      const int j0 = tile_of(k, band_lo, band_n) * BLOCK;
      __syncthreads();  // the previous tile is consumed
      stage(s, src, ns, j0);
      __syncthreads();
      float p[3] = {0.f, 0.f, 0.f};
      tile_sum<KIND>(s, t, eps2, p);
      accumulate<3, KAHAN>(total, comp, p);
    }
    store<ACC>(out, part, nt, i, total, comp);
  }
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
  // the block's diagonal tile (potential forms): j0 == its first target
  const int diag = mask_self ? static_cast<int>(blockIdx.x) * BLOCK : -1;
  float total[3] = {0.f, 0.f, 0.f};
  float comp[3] = {0.f, 0.f, 0.f};
  for (int b = b_lo; b < b_hi; ++b) {
    float p[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c < tn; c += BLOCK) {
      const int j0 = (row0 + b) * tn + c;
      __syncthreads();
      stage(s, src, ns, j0);
      __syncthreads();
      if constexpr (MODE == ACC)
        tile_sum<SPLINE>(s, t, eps2, p);
      else if (j0 == diag)
        pot_sum<SPLINE, true, 1>(rows_of(s), &t, eps2, p);
      else
        pot_sum<SPLINE, false, 1>(rows_of(s), &t, eps2, p);
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
  direct_tile_kernel<KIND, MODE, KAHAN, SKIP>
      <<<grid(a), MODE == ACC ? BLOCK : POT_THREADS, 0, stream>>>(
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
      nt <= 0 || ns <= 0 || ns % BLOCK != 0 ||
      reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
      (nb > 0 && start == nullptr) ||
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
