// Device helpers shared by the kernels (lw_megakernel.cu, sw_megakernel.cu,
// lw_prep.cu, mlp.cu): the tiled MLP with its weights read through the cache
// or streamed through shared memory, the totplnk interpolation, the cloud
// lookup, and the per-level spectral sums.
//
// Layout rules of the fused kernels: one thread block per column, layer
// groups of one thread per g-point (threads at g >= ngpt only help with the
// MLP and the reductions). Weights are (n_in, n_out) row-major in device
// memory; neighbouring threads take neighbouring output columns, so every
// weight load is coalesced.
//
// The tiled MLP ("the tiled MLP" below) keeps the rows of a pass k-major in
// shared memory, so that a thread reads its rows of one k as float4s that the
// whole warp shares, and gives each thread a register tile of rows x output
// columns: 16 to 32 multiply-adds for 3 load instructions. The fused kernels
// take kMegaRows rows per pass and softsign; the generic MLP kernel (mlp.cu)
// sets the rows of a pass and the activation as template parameters.
//
// Arithmetic is IEEE float32, compiled without --use_fast_math ('/' and
// sqrtf correctly rounded, expf within 2 ulp), with two exceptions: the SW
// kernel's two-stream coefficients are evaluated in double
// (sw_megakernel.cu), and so is the LW transmittance (rte::transmittance).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace rte {

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90

// One 3-layer MLP: softsign, softsign, linear. The first layer is split into
// the rows that multiply the layer-varying features (w1a) and the rows that
// multiply the per-column constant features (w1c).
struct Mlp3 {
  const float* w1a;    // (n_in, h1)
  const float* w1c;    // (nc, h1)
  const float* b1;     // (h1)
  const float* w2;     // (h1, h2)
  const float* b2;     // (h2)
  const float* w3;     // (h2, nout)
  const float* b3;     // (nout)
  const float* omean;  // (nout) output standardization
  const float* ostd;   // (nout)
  int h1, h2, nout;
};

__device__ __forceinline__ float softsign(float x) { return x / (1.0f + fabsf(x)); }

// The fused kernels' hidden activation, as the tiled MLP's default.
struct Softsign {
  __device__ __forceinline__ float operator()(float x) const { return softsign(x); }
};

// s_hc[j] = sum_k cf[k] * w1c[k, j]: the constant features' share of the
// first-layer pre-activation, once per column. No barrier.
__device__ inline void mlp_const_part(const Mlp3& m, const float* cf, int nc, float* s_hc) {
  for (int j = threadIdx.x; j < m.h1; j += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < nc; ++k) acc = fmaf(cf[k], m.w1c[k * m.h1 + j], acc);
    s_hc[j] = acc;
  }
}

// a / b for finite b > 0, the IEEE quotient. The divide's straight-line code
// is for operands in the normal range; a zero numerator sends the whole warp
// through its slow path, and in cloud-free cells the numerators of the SW
// cloud combine are zero (measured: 8% of that mode's time).
__device__ __forceinline__ float div_or_zero(float a, float b) {
  return a != 0.0f ? (a != 0.0f ? a : 1.0f) / b : a;
}

// (ystd*y + ymean)**8: the optical-depth postprocessing before col_dry.
__device__ __forceinline__ float tau_post(float y, float ystd, float ymean) {
  const float yt = ystd * y + ymean;
  const float y2 = yt * yt;
  const float y4 = y2 * y2;
  return y4 * y4;
}

// The fused kernels' input and cloud modes (template parameter of both).
enum MegaMode {
  kClear = 0,     // stacked scaled features, gases only
  kCldLut = 1,    // + clouds from lwp/iwp/rel/rei through the LUT, in the kernel
  kCldBands = 2,  // + clouds as band-resolved lanes computed outside
  kLanes = 3,     // clear-sky, one array per feature (LW: raw, transformed here)
};

// One (nlay, ncol) array per input feature, passed by value with the
// kLanes kernel's arguments. ``code`` is the LW raw-lane transform: 0
// identity, 1 log, 2 fourth root.
constexpr int kMaxLanes = 32;
struct LaneList {
  const float* p[kMaxLanes];
  int code[kMaxLanes];
};

// A kernel instance takes the lane list and the cloud tables among its
// arguments only in the mode that reads them; the others take this instead.
struct Unused {};

// Cloud-optics lookup tables, one per phase: (nsize, 3 * nband) rows of
// [extinction | single-scattering albedo | asymmetry] on an even grid of
// effective radius starting at ``off`` with spacing ``step``. They stay in
// device memory and are read through the cache (a few KB, shared by every
// block).
struct CloudLut {
  const float* liq;
  const float* ice;
  int n_liq, n_ice, nband;
  float liq_off, liq_step, ice_off, ice_step;
};

template <int kMode>
using CloudLutOf = std::conditional_t<kMode == kCldLut, CloudLut, Unused>;
template <int kMode>
using LaneListOf = std::conditional_t<kMode == kLanes, LaneList, Unused>;

// One phase's band-b (tau, tau*ssa, tau*ssa*g) from water path wp and
// effective radius re: linear in radius, index clamped to [0, nsize-2],
// fraction NOT clamped, tau masked by wp > 0 (a cell without cloud has
// re = 0 and a large negative fraction; the mask zeroes it).
__device__ __forceinline__ void cloud_lut_phase(const float* tab, int nsize, int nband, int b,
                                                float off, float step, float wp, float re,
                                                float& t, float& ts, float& tsg) {
  const float fidx = (re - off) / step;
  const float i0f = fminf(fmaxf(floorf(fidx), 0.0f), (float)(nsize - 2));
  const float frac = fidx - i0f;
  const float* lo = tab + (size_t)((int)i0f) * 3 * nband + b;
  const float* hi = lo + 3 * nband;
  const float e_lo = __ldg(lo), s_lo = __ldg(lo + nband), a_lo = __ldg(lo + 2 * nband);
  const float e = e_lo + frac * (__ldg(hi) - e_lo);
  const float s = s_lo + frac * (__ldg(hi + nband) - s_lo);
  const float a = a_lo + frac * (__ldg(hi + 2 * nband) - a_lo);
  t = wp > 0.0f ? wp * e : 0.0f;
  ts = t * s;
  tsg = ts * a;
}

// The band-b Planck radiance at temperature t: reference interpolate1D
// (index = trunc toward zero clamped to [0, ntab-2], fraction NOT clamped)
// over the table tab (ntab, nband) and its forward differences dtab
// (ntab-1, nband).
struct PlanckTab {
  const float* tab;
  const float* dtab;
  int nband, ntab;
  float t_min, t_delta;
};

// The LW transmittance exp(-tl) in double, rounded once: float32 expf is
// within 2 ulp but high by 0.095 ulp on average, a bias that the g-point
// sums and the sweeps accumulate (ROADMAP Queue 3 F7). The twins take it
// so too (ops/lw_solver.transmittance).
__device__ __forceinline__ float transmittance(float tl) { return (float)exp(-(double)tl); }

__device__ __forceinline__ float planck_interp(const PlanckTab& p, float t, int b) {
  const float val0 = (t - p.t_min) / p.t_delta;
  const int itr = (int)val0;  // truncation toward zero
  const int i0 = min(max(itr, 0), p.ntab - 2);
  const float frac = val0 - (float)itr;
  return __ldg(p.tab + i0 * p.nband + b) + frac * __ldg(p.dtab + i0 * p.nband + b);
}

// out[r] = scale * sum_g s_f[r, g] (+ add[r]) for r < nrow: one warp per
// row, kSumRows rows of a warp at a time so that their loads and shuffle
// chains overlap; each row's sum has the same fixed order whatever the block
// size. The caller places a barrier before (s_f complete) and after (if out
// is shared memory read by others).
constexpr int kSumRows = 4;
__device__ inline void level_sums(const float* s_f, int nrow, int ngpt, float scale,
                                  const float* add, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarp = blockDim.x >> 5;
  for (int r0 = warp; r0 < nrow; r0 += kSumRows * nwarp) {
    // rows past nrow repeat the last row and store nothing
    const float* row[kSumRows];
    float acc[kSumRows];
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) {
      row[u] = s_f + min(r0 + u * nwarp, nrow - 1) * ngpt;
      acc[u] = 0.0f;
    }
    for (int g = lane; g < ngpt; g += 32) {
#pragma unroll
      for (int u = 0; u < kSumRows; ++u) acc[u] += row[u][g];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kSumRows; ++u) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kSumRows; ++u) {
        const int r = r0 + u * nwarp;
        if (r < nrow) out[r] = acc[u] * scale + (add ? add[r] : 0.0f);
      }
    }
  }
}

// ---- the tiled MLP ---------------------------------------------------------
//
// A block of the fused kernels is a few layer groups of kGroup threads; each
// group takes a contiguous share of the column's layers through the MLP,
// kMegaRows layers per pass, with scratch of its own. Activations are
// k-major in shared memory, s[k * kRowStride + row]: the kRowPad floats
// between two k keep the float4 stores of neighbouring output columns on
// different banks, and the loads are broadcasts (every thread of a warp reads
// the same rows). A thread holds a register tile of rows x neighbouring
// output columns: kTileR x kTileC in the hidden layers (one float2 weight
// load and two float4 activation loads for 16 multiply-adds), kOutR x kOutC
// in the last layer (one float4 weight load, 32 multiply-adds), sized so that
// all 128 threads of a group hold a tile. The path from shared memory or L1
// to the registers delivers 32 words a clock to an SM, broadcast or not, so
// a tile of R x C costs R + C words per k for R * C multiply-adds: larger
// tiles load less, but they leave warps without work, and on an H100 the
// warps in flight count for more (scripts/tune_megakernel_tiles.py, PERF.md).
// Every output's sum runs over k in ascending order in one accumulator with
// fmaf, as cuBLAS rounds. The streamed functions below take the rows of a
// pass as the template parameter kPassRows (the stride from one k to the next
// is kPassRows + kRowPad) and the hidden activation as a functor; the
// defaults are the fused kernels'.
constexpr int kGroup = 128;    // threads of one layer group: one per g-point
constexpr int kMaxGroups = 4;  // layer groups of a block: at most 512 threads
constexpr int kMegaRows = 16;  // layers per MLP pass of a group
constexpr int kRowPad = 4;
constexpr int kRowStride = kMegaRows + kRowPad;  // floats from one k to the next
constexpr int kTileR = 8;   // hidden layers: rows of a thread's register tile
constexpr int kTileC = 2;   //                output columns of it
constexpr int kOutR = 8;    // last layer: rows of a thread's register tile
constexpr int kOutC = 4;    //             output columns of it (one float4 weight load)

// Threads per block, layer groups, layers per group, layers per MLP pass and
// dynamic shared memory of a fused kernel's launch, decided by launch_plan in
// ops/cuda/lw_megakernel.py / sw_megakernel.py (ops/cuda/build.py mirrors the
// struct) and checked again by the launch entries.
struct MegaPlan {
  int threads, groups, layers_per_group, rows_per_pass, smem_bytes;
  int slab_floats;  // of one of the two weight buffers (0: weights read through the cache)
};

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// What every launch entry holds a plan to, whatever the kernel: returns
// false if the plan's geometry is not one the kernels are compiled for.
inline bool plan_geometry_ok(const MegaPlan& p, int nlay, int ngpt, size_t smem) {
  return p.groups >= 1 && p.groups <= kMaxGroups && p.threads == p.groups * kGroup &&
         p.rows_per_pass == kMegaRows && p.layers_per_group >= 1 &&
         (long long)p.layers_per_group * p.groups >= nlay && ngpt >= 1 && ngpt <= kGroup &&
         smem == (size_t)p.smem_bytes && smem <= (size_t)kMaxSmem;
}

// Barrier of one layer group (barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(kGroup) : "memory");
}

// Rows [l0, l0 + kMegaRows) of x (nlay, ncol, n_in) for column col into
// s_x[k][row]; rows at or past lend repeat row lend - 1, so that every row of
// the pass computes on real values and only the stores are guarded. No
// barrier.
__device__ inline void load_rows_kmajor(const float* x, int l0, int lend, int ncol, int col,
                                        int n_in, float* s_x, int gtid) {
  for (int i = gtid; i < kMegaRows * n_in; i += kGroup) {
    const int r = i / n_in, k = i - r * n_in;
    const int l = min(l0 + r, lend - 1);
    s_x[k * kRowStride + r] = x[((size_t)l * ncol + col) * n_in + k];
  }
}

// load_rows_kmajor for one array per feature. With ``scale`` (2, n_in) =
// [min; 1/(max - min)] the lanes are raw: transform by code, then
// (x - min) * inv. Without it they are already scaled.
__device__ inline void load_rows_lanes_kmajor(const LaneList& lanes, const float* scale, int l0,
                                              int lend, int ncol, int col, int n_in, float* s_x,
                                              int gtid) {
  for (int i = gtid; i < kMegaRows * n_in; i += kGroup) {
    const int k = i / kMegaRows, r = i - k * kMegaRows;
    const int l = min(l0 + r, lend - 1);
    float v = lanes.p[k][(size_t)l * ncol + col];
    if (scale != nullptr) {
      const int code = lanes.code[k];
      if (code == 1) v = logf(v);
      else if (code == 2) v = sqrtf(sqrtf(v));
      v = (v - __ldg(scale + k)) * __ldg(scale + n_in + k);
    }
    s_x[k * kRowStride + r] = v;
  }
}

// C neighbouring weights of row k: one vector load where the row length and
// the base address allow it (kVec), else scalar loads with columns at or
// past n_out read as 0. kLdg: the row is in device memory and is read
// through the read-only cache; else it is in a shared-memory slab.
template <int C, bool kVec, bool kLdg>
__device__ __forceinline__ void load_weights(const float* __restrict__ wk, int c0, int n_out,
                                             float (&w)[C]) {
  if constexpr (kVec && C == 2) {
    const float2* q = reinterpret_cast<const float2*>(wk + c0);
    const float2 v = kLdg ? __ldg(q) : *q;
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (kVec && C == 4) {
    const float4* q = reinterpret_cast<const float4*>(wk + c0);
    const float4 v = kLdg ? __ldg(q) : *q;
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      w[c] = c0 + c < n_out ? (kLdg ? __ldg(wk + c0 + c) : wk[c0 + c]) : 0.0f;
  }
}

// R rows of one k as float4s (s points at the tile's first row of k = 0).
template <int R, int kStride = kRowStride>
__device__ __forceinline__ void load_rows_of_k(const float* s, int k, float (&x)[R]) {
  const float4* p = reinterpret_cast<const float4*>(s + k * kStride);
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 v = p[q];
    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
  }
}

// acc[c][r] += sum over k in [k0, k0 + kc) of s_in[k][r] * w[k - k0, c0 + c],
// in ascending k: w points at row k0 of the weights (device memory if kLdg,
// else a shared-memory slab that starts at row k0).
template <int R, int C, bool kVec, bool kRank1, bool kLdg, int kStride = kRowStride>
__device__ __forceinline__ void tile_k_loop(const float* __restrict__ w, int k0, int kc, int n_out,
                                            int c0, const float* s_in, float (&acc)[C][R]) {
#pragma unroll 4
  for (int k = 0; k < kc; ++k) {
    float x[R], wv[C];
    load_rows_of_k<R, kStride>(s_in, k0 + k, x);
    load_weights<C, kVec, kLdg>(w + (size_t)k * n_out, c0, n_out, wv);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[c][r] = kRank1 ? __fadd_rn(acc[c][r], __fmul_rn(x[r], wv[c]))
                           : fmaf(x[r], wv[c], acc[c][r]);
  }
}

// A tile's accumulators before the k loop, and its rows' activations after.
template <int R, int C, bool kRank1>
__device__ __forceinline__ void tile_begin(const float* __restrict__ bias, const float* s_hc,
                                           int n_out, int c0, float (&acc)[C][R], float (&hc)[C],
                                           float (&b)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = min(c0 + c, n_out - 1);
    hc[c] = s_hc != nullptr ? s_hc[j] : 0.0f;
    b[c] = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[c][r] = kRank1 ? hc[c] + b[c] : 0.0f;
  }
}

template <int R, int C, bool kRank1, int kStride = kRowStride, class Act = Softsign>
__device__ __forceinline__ void tile_end(const float (&acc)[C][R], const float (&hc)[C],
                                         const float (&b)[C], bool has_hc, int n_out, int c0,
                                         float* s_tile, Act act = Act()) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c0 + c >= n_out) break;
    float4* out = reinterpret_cast<float4*>(s_tile + c * kStride);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = acc[c][4 * q + i];
        v[i] = act(kRank1 ? a : has_hc ? (a + hc[c]) + b[c] : a + b[c]);
      }
      out[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One hidden layer for the kMegaRows rows of a pass: s_in[k][row] (n_in) ->
// s_out[j][row] = act(sum_k s_in[k][row] * w[k, j] (+ s_hc[j]) + bias[j])
// for j < n_out, by ``nthr`` threads of which this is number ``tid``: each
// takes tiles of R rows x C neighbouring output columns. s_hc is the
// per-column constant features' share of the first layer (mlp_const_part),
// null for the other layers. kRank1 takes the first layer as the raw-lane
// Pallas kernel does: starting from the const block's share plus the bias,
// one rounded product and one rounded sum per feature, in feature order (no
// fused multiply-add), so that the raw-lane mode rounds as its plain version
// does. The caller places a barrier before (s_in complete) and after (s_out
// read by others).
template <int R, int C, bool kRank1>
__device__ inline void mlp_layer_tiled(const float* __restrict__ w, const float* __restrict__ bias,
                                       const float* s_hc, int n_in, int n_out, const float* s_in,
                                       float* s_out, int tid, int nthr) {
  static_assert(kMegaRows % R == 0 && R % 4 == 0, "row tiles are float4s of a pass");
  constexpr int kRowTiles = kMegaRows / R;
  const int nct = (n_out + C - 1) / C;
  const bool vec = n_out % C == 0 && (reinterpret_cast<size_t>(w) & (sizeof(float) * C - 1)) == 0;
  for (int t = tid; t < nct * kRowTiles; t += nthr) {
    const int rt = t / nct, c0 = (t - rt * nct) * C;
    float acc[C][R], hc[C], b[C];
    tile_begin<R, C, kRank1>(bias, s_hc, n_out, c0, acc, hc, b);
    const float* s_rows = s_in + rt * R;
    if (vec) tile_k_loop<R, C, true, kRank1, true>(w, 0, n_in, n_out, c0, s_rows, acc);
    else tile_k_loop<R, C, false, kRank1, true>(w, 0, n_in, n_out, c0, s_rows, acc);
    tile_end<R, C, kRank1>(acc, hc, b, s_hc != nullptr, n_out, c0,
                           s_out + c0 * kRowStride + rt * R);
  }
}

// The last layer (no activation) for the kMegaRows rows of a pass, by ``nthr``
// threads of which this is number ``tid``: tiles of R rows x C neighbouring
// output columns as in mlp_layer_tiled; ``end(row0, col, sums)`` takes the R
// finished sums (before the bias) of output column ``col`` for the rows
// row0.. of the pass. The caller places a barrier before (s_in complete).
template <int R, int C, class End>
__device__ __forceinline__ void mlp_last_tiled(const float* __restrict__ w, int n_in, int n_out,
                                               const float* s_in, int tid, int nthr, End end) {
  static_assert(kMegaRows % R == 0 && R % 4 == 0, "row tiles are float4s of a pass");
  constexpr int kRowTiles = kMegaRows / R;
  const int nct = (n_out + C - 1) / C;
  const bool vec = n_out % C == 0 && (reinterpret_cast<size_t>(w) & (sizeof(float) * C - 1)) == 0;
  for (int t = tid; t < nct * kRowTiles; t += nthr) {
    const int rt = t / nct, c0 = (t - rt * nct) * C;
    float acc[C][R];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][r] = 0.0f;
    const float* s_rows = s_in + rt * R;
    if (vec) tile_k_loop<R, C, true, false, true>(w, 0, n_in, n_out, c0, s_rows, acc);
    else tile_k_loop<R, C, false, false, true>(w, 0, n_in, n_out, c0, s_rows, acc);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c0 + c < n_out) end(rt * R, c0 + c, acc[c]);
  }
}

// ---- weights through shared memory -------------------------------------------
//
// The LW net's weights (206 KB) do not fit what a block's fields leave of
// the SM's L1, so read through the cache every layer group streams them from
// L2 again, and the k loops wait on those loads. Instead the whole block
// copies each weight matrix once per pass, slab by slab (consecutive rows k,
// contiguous in device memory), with cp.async into one of two shared-memory
// buffers while every group computes on the other: one block barrier per
// slab, and the k loops read weights at shared-memory latency.
struct WeightStream {
  float* buf;       // 2 x slab_floats, 16-byte aligned
  int slab_floats;  // a multiple of 4
  int cur;          // the buffer that holds (or is receiving) the slab consumed next
};

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool bytes16) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes16) asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  else asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// Every thread of the block: start the copy of n floats at src into buffer
// ``into``. 16-byte pieces where the address and the count allow.
__device__ inline void stream_issue(const WeightStream& ws, int into, const float* src, int n) {
  float* dst = ws.buf + into * ws.slab_floats;
  if ((reinterpret_cast<size_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) cp_async(dst + i, src + i, true);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async(dst + i, src + i, false);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Rows of (n_in, n_out) weights that one slab holds, and the floats of the
// first slab.
__device__ __forceinline__ int slab_rows(const WeightStream& ws, int n_out) {
  return ws.slab_floats / n_out;
}
__device__ __forceinline__ int first_slab_floats(const WeightStream& ws, int n_in, int n_out) {
  return min(slab_rows(ws, n_out), n_in) * n_out;
}

// Walk the slabs of the weights w (n_in, n_out); every thread of the block
// calls this, in the same order. On entry the first slab is on its way into
// buffer ws.cur. Per slab: wait for it, block barrier (which also orders the
// previous layer's activations before this layer's reads), start the copy of
// the next slab into the other buffer (after the last slab: the first slab of
// ``next``, the matrix the caller walks next, or nothing if null), then
// body(slab, k0, kc) for the rows [k0, k0 + kc) it holds.
template <class Body>
__device__ __forceinline__ void stream_slabs(WeightStream& ws, const float* w, int n_in, int n_out,
                                             const float* next, int next_n_in, int next_n_out,
                                             Body body) {
  const int ks = slab_rows(ws, n_out);
  for (int k0 = 0; k0 < n_in; k0 += ks) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (k0 + ks < n_in)
      stream_issue(ws, ws.cur ^ 1, w + (size_t)(k0 + ks) * n_out, min(ks, n_in - k0 - ks) * n_out);
    else if (next != nullptr)
      stream_issue(ws, ws.cur ^ 1, next, first_slab_floats(ws, next_n_in, next_n_out));
    body(ws.buf + ws.cur * ws.slab_floats, k0, min(ks, n_in - k0));
    ws.cur ^= 1;
  }
}

// mlp_layer_tiled with the weights streamed through shared memory, for kPassRows
// rows a pass: called by every thread of the block (tid, nthr: this thread's
// number among the threads that share s_in / s_out, its layer group or the
// block). Ends without a barrier: the next stream_slabs places one.
template <int R, int C, bool kRank1, int kPassRows = kMegaRows, class Act = Softsign>
__device__ inline void mlp_layer_staged(WeightStream& ws, const float* __restrict__ w,
                                        const float* __restrict__ bias, const float* s_hc, int n_in,
                                        int n_out, const float* s_in, float* s_out, int tid,
                                        int nthr, const float* next, int next_n_in,
                                        int next_n_out, Act act = Act()) {
  static_assert(kPassRows % R == 0 && R % 4 == 0, "row tiles are float4s of a pass");
  constexpr int kRowTiles = kPassRows / R, kStride = kPassRows + kRowPad;
  const int nct = (n_out + C - 1) / C, ntiles = nct * kRowTiles;
  const bool vec = n_out % C == 0;
  // a thread keeps one tile's sums across the slabs; more tiles than threads
  // stream the weights again
  for (int t0 = 0; t0 < ntiles; t0 += nthr) {
    const int t = t0 + tid;
    const bool has = t < ntiles;
    const int rt = has ? t / nct : 0, c0 = has ? (t - rt * nct) * C : 0;
    const bool last = t0 + nthr >= ntiles;
    float acc[C][R], hc[C], b[C];
    tile_begin<R, C, kRank1>(bias, s_hc, n_out, c0, acc, hc, b);
    const float* s_rows = s_in + rt * R;
    stream_slabs(ws, w, n_in, n_out, last ? next : w, last ? next_n_in : n_in,
                 last ? next_n_out : n_out, [&](const float* slab, int k0, int kc) {
                   if (!has) return;
                   if (vec)
                     tile_k_loop<R, C, true, kRank1, false, kStride>(slab, k0, kc, n_out, c0,
                                                                     s_rows, acc);
                   else
                     tile_k_loop<R, C, false, kRank1, false, kStride>(slab, k0, kc, n_out, c0,
                                                                      s_rows, acc);
                 });
    if (has)
      tile_end<R, C, kRank1, kStride>(acc, hc, b, s_hc != nullptr, n_out, c0,
                                      s_out + c0 * kStride + rt * R, act);
  }
}

// mlp_last_tiled with the weights streamed through shared memory, for kPassRows
// rows a pass: called by every thread of the block, with its number among the
// threads that share s_in.
template <int R, int C, int kPassRows = kMegaRows, class End>
__device__ __forceinline__ void mlp_last_staged(WeightStream& ws, const float* __restrict__ w,
                                                int n_in, int n_out, const float* s_in, int tid,
                                                int nthr, const float* next, int next_n_in,
                                                int next_n_out, End end) {
  static_assert(kPassRows % R == 0 && R % 4 == 0, "row tiles are float4s of a pass");
  constexpr int kRowTiles = kPassRows / R, kStride = kPassRows + kRowPad;
  const int nct = (n_out + C - 1) / C, ntiles = nct * kRowTiles;
  const bool vec = n_out % C == 0;
  for (int t0 = 0; t0 < ntiles; t0 += nthr) {
    const int t = t0 + tid;
    const bool has = t < ntiles;
    const int rt = has ? t / nct : 0, c0 = has ? (t - rt * nct) * C : 0;
    const bool last = t0 + nthr >= ntiles;
    float acc[C][R];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][r] = 0.0f;
    const float* s_rows = s_in + rt * R;
    stream_slabs(ws, w, n_in, n_out, last ? next : w, last ? next_n_in : n_in,
                 last ? next_n_out : n_out, [&](const float* slab, int k0, int kc) {
                   if (!has) return;
                   if (vec)
                     tile_k_loop<R, C, true, false, false, kStride>(slab, k0, kc, n_out, c0,
                                                                    s_rows, acc);
                   else
                     tile_k_loop<R, C, false, false, false, kStride>(slab, k0, kc, n_out, c0,
                                                                     s_rows, acc);
                 });
    if (has) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c0 + c < n_out) end(rt * R, c0 + c, acc[c]);
    }
  }
}

// Phase A's first loop of the LW kernels (lw_megakernel.cu, lw_prep.cu): a
// "lw_both" net (Mlp3, weights streamed) over this layer group's layers
// [lbeg, lend), kMegaRows a pass; every group runs every pass (the weights'
// slabs are the block's), and a group with no layer left computes on repeated
// rows and stores nothing. load(l0) fills s_x with the rows from l0
// (load_rows_kmajor or load_rows_lanes_kmajor). The last layer leaves (ystd*y
// + ymean)**8 of the tau columns in s_y8 and the square of the
// Planck-fraction columns in s_pf, each (nlay, ngpt); after it the stream
// copies the first layer for the next pass, nothing at the end. On entry the
// first slab of m.w1a is on its way; ends without a barrier.
template <bool kRank1, class Load>
__device__ __forceinline__ void lw_both_nets(WeightStream& ws, const Mlp3& m, const float* s_hc,
                                             int n2d, int ngpt, int lbeg, int lend,
                                             int layers_per_group, float* s_x, float* s_h1,
                                             float* s_h2, float* s_y8, float* s_pf, int gtid,
                                             Load load) {
  const int npass = (layers_per_group + kMegaRows - 1) / kMegaRows;
  for (int pass = 0; pass < npass; ++pass) {
    const int l0 = lbeg + pass * kMegaRows;
    load(l0);
    mlp_layer_staged<kTileR, kTileC, kRank1>(ws, m.w1a, m.b1, s_hc, n2d, m.h1, s_x, s_h1, gtid,
                                             kGroup, m.w2, m.h1, m.h2);
    mlp_layer_staged<kTileR, kTileC, false>(ws, m.w2, m.b2, nullptr, m.h1, m.h2, s_h1, s_h2, gtid,
                                            kGroup, m.w3, m.h2, m.nout);
    const bool more = pass + 1 < npass;
    mlp_last_staged<kOutR, kOutC>(
        ws, m.w3, m.h2, m.nout, s_h2, gtid, kGroup, more ? m.w1a : nullptr, n2d, m.h1,
        [&](int row0, int c, const float (&sum)[kOutR]) {
          const float b = __ldg(m.b3 + c);
          if (c < ngpt) {
            const float ostd = __ldg(m.ostd + c), omean = __ldg(m.omean + c);
#pragma unroll
            for (int r = 0; r < kOutR; ++r)
              if (l0 + row0 + r < lend)
                s_y8[(l0 + row0 + r) * ngpt + c] = tau_post(sum[r] + b, ostd, omean);
          } else {
#pragma unroll
            for (int r = 0; r < kOutR; ++r) {
              const float y = sum[r] + b;
              if (l0 + row0 + r < lend) s_pf[(l0 + row0 + r) * ngpt + c - ngpt] = y * y;
            }
          }
        });
  }
}

}  // namespace rte
