// Device helpers shared by the fused clear-sky kernels (lw_megakernel.cu,
// sw_megakernel.cu): the 3-layer softsign MLP evaluated for a few layers of
// one column at a time, the totplnk interpolation, and the per-level
// spectral sums.
//
// Layout rules: one thread block per column, one thread per g-point
// (kThreads >= ngpt; threads at g >= ngpt only help with the MLP hidden
// layers and the reductions). Weights are (n_in, n_out) row-major in device
// memory and are read through the cache: neighbouring threads read
// neighbouring output columns, so every weight load is coalesced.
//
// Arithmetic is IEEE float32, compiled without --use_fast_math (expf, '/'
// and sqrtf correctly rounded), with one exception: the SW kernel's
// two-stream coefficients are evaluated in double (sw_megakernel.cu).
#pragma once

#include <cuda_runtime.h>

namespace rte {

constexpr int kThreads = 128;  // threads per block: one per g-point
constexpr int kRows = 4;       // layers per MLP pass: each weight load serves kRows rows
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

// s_hc[j] = sum_k cf[k] * w1c[k, j]: the constant features' share of the
// first-layer pre-activation, once per column. No barrier.
__device__ inline void mlp_const_part(const Mlp3& m, const float* cf, int nc, float* s_hc) {
  for (int j = threadIdx.x; j < m.h1; j += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < nc; ++k) acc = fmaf(cf[k], m.w1c[k * m.h1 + j], acc);
    s_hc[j] = acc;
  }
}

// Hidden layers for kRows rows: s_x (kRows, n_in) -> s_h2 (kRows, h2) via
// s_h1 (kRows, h1). The caller makes s_x and s_hc visible first; this
// function ends with a barrier, after which s_h2 is readable by all.
__device__ inline void mlp_hidden(const Mlp3& m, const float* s_x, int n_in, const float* s_hc,
                                  float* s_h1, float* s_h2) {
  for (int j = threadIdx.x; j < m.h1; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < n_in; ++k) {
      const float w = __ldg(m.w1a + k * m.h1 + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(s_x[r * n_in + k], w, acc[r]);
    }
    const float hc = s_hc[j], b = __ldg(m.b1 + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) s_h1[r * m.h1 + j] = softsign((acc[r] + hc) + b);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m.h2; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < m.h1; ++k) {
      const float w = __ldg(m.w2 + k * m.h2 + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(s_h1[r * m.h1 + k], w, acc[r]);
    }
    const float b = __ldg(m.b2 + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) s_h2[r * m.h2 + j] = softsign(acc[r] + b);
  }
  __syncthreads();
}

// Raw output column o of the last layer for the kRows rows.
__device__ inline void mlp_out(const Mlp3& m, const float* s_h2, int o, float y[kRows]) {
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int k = 0; k < m.h2; ++k) {
    const float w = __ldg(m.w3 + k * m.nout + o);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(s_h2[r * m.h2 + k], w, acc[r]);
  }
  const float b = __ldg(m.b3 + o);
#pragma unroll
  for (int r = 0; r < kRows; ++r) y[r] = acc[r] + b;
}

// (ystd*y + ymean)**8: the optical-depth postprocessing before col_dry.
__device__ __forceinline__ float tau_post(float y, float ystd, float ymean) {
  const float yt = ystd * y + ymean;
  const float y2 = yt * yt;
  const float y4 = y2 * y2;
  return y4 * y4;
}

// Rows [l0, l0 + kRows) of the layer-major feature array x (nlay, ncol, n_in)
// for column col into s_x (kRows, n_in); rows past nlay are zero. No barrier.
__device__ inline void load_rows(const float* x, int l0, int nlay, int ncol, int col, int n_in,
                                 float* s_x) {
  for (int i = threadIdx.x; i < kRows * n_in; i += blockDim.x) {
    const int r = i / n_in, k = i - r * n_in;
    const int l = l0 + r;
    s_x[i] = l < nlay ? x[((size_t)l * ncol + col) * n_in + k] : 0.0f;
  }
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

__device__ __forceinline__ float planck_interp(const PlanckTab& p, float t, int b) {
  const float val0 = (t - p.t_min) / p.t_delta;
  const int itr = (int)val0;  // truncation toward zero
  const int i0 = min(max(itr, 0), p.ntab - 2);
  const float frac = val0 - (float)itr;
  return __ldg(p.tab + i0 * p.nband + b) + frac * __ldg(p.dtab + i0 * p.nband + b);
}

// out[r] = scale * sum_g s_f[r, g] (+ add[r]) for r < nrow: one warp per
// row, fixed summation order. The caller places a barrier before (s_f
// complete) and after (if out is shared memory read by others).
__device__ inline void level_sums(const float* s_f, int nrow, int ngpt, float scale,
                                  const float* add, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarp = blockDim.x >> 5;
  for (int r = warp; r < nrow; r += nwarp) {
    float acc = 0.0f;
    for (int g = lane; g < ngpt; g += 32) acc += s_f[r * ngpt + g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[r] = acc * scale + (add ? add[r] : 0.0f);
  }
}

}  // namespace rte
