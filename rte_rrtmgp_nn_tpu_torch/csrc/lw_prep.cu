// LW front end for one column per thread block: NN gas optics (3-layer
// softsign "both" net -> tau, Planck fraction), transmittance and the
// no-scattering layer sources from band Planck values interpolated outside
// the kernel. It writes exactly the three layer-major fields the broadband
// sweeps read (transmittance, down and up source) and the surface source.
//
// Replaces rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py::lw_prep_pallas
// (_prep_kernel on _phase_a_sources). Same physics: predict_nn_lw +
// compute_planck_source_nn + the source prologue of lw_solver_noscat, single
// diffusivity angle (reference mo_gas_optics_kernels.F90:690-862, 615-683;
// mo_rte_solver_kernels.F90:119-330). tau, the Planck fraction and the
// g-point Planck sources never reach device memory.
//
// It is the fused LW kernel's phase A (lw_megakernel.cu) with the band
// Planck values read instead of interpolated and the three fields stored
// instead of kept in shared memory: one block per column, one thread per
// g-point, kRows layers per MLP pass (common.cuh). A thread owns a g-point
// and knows its band, so the band -> g-point expansion is an index. The
// source at a layer's lower level takes the Planck fraction of the layer
// below, which is the level-top source of that layer: walking down the
// column, a layer's down source is stored one step later, when that product
// exists, from four values kept in registers. A warp stores 128 contiguous
// bytes of each field per layer.
//
// What bounds it on an H100: the MLP, about 51k FMAs per (layer, column)
// with the 18->128->128->256 net, each needing a weight from L1/L2 (the
// weights, 206 KB, never leave the cache); the 166 MB it writes at 1800 x
// 60 x 128 would take a tenth of that time. Shared memory holds only the
// MLP's rows (5 KB), so registers set the residency. The launch bounds state
// four blocks per SM (ptxas takes 92 registers, no spill); unlike the fused
// kernel this one barely reads the stated residency: 64 to 106 registers at
// 8 to 1 blocks per SM time within 4% of each other on an H100
// (scripts/tune_lw_prep_residency.py, PERF.md), so FMA issue and the weight
// loads bound it, not latency for want of warps.
#include "common.cuh"

using rte::kRows;
using rte::Mlp3;

// The launch entry's first argument; ops/cuda/build.py mirrors it field by
// field.
struct LwPrepArgs {
  const float* x;         // (nlay, ncol, nf) scaled features, layer-major
  const float* col_dry;   // (nlay, ncol)
  const float* b_lay;     // (nlay, ncol, nband) band Planck values at the layer temperatures
  const float* b_lev;     // (nlay+1, ncol, nband) at the level temperatures
  const float* b_sfc;     // (ncol, nband) at the surface temperature
  const int* gpt2band;    // (ngpt)
  float* trans;           // (nlay, ncol, ngpt)
  float* src_dn;          // (nlay, ncol, ngpt)
  float* src_up;          // (nlay, ncol, ngpt)
  float* sfc_src;         // (ncol, ngpt)
  int ncol, nlay, nf, ngpt, nband;
  float d_secant, tau_thresh;
};

namespace {

constexpr int kBlocksPerSm = 4;

__global__ void __launch_bounds__(rte::kThreads, kBlocksPerSm)
lw_prep_kernel(const LwPrepArgs a, const Mlp3 m) {
  extern __shared__ float smem[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const int nlay = a.nlay, ncol = a.ncol, ngpt = a.ngpt, nband = a.nband;
  float* s_x = smem;                  // (kRows, nf)
  float* s_hc = s_x + kRows * a.nf;   // (h1): no per-column constant block here, zeros
  float* s_h1 = s_hc + m.h1;          // (kRows, h1)
  float* s_h2 = s_h1 + kRows * m.h1;  // (kRows, h2)

  for (int j = threadIdx.x; j < m.h1; j += blockDim.x) s_hc[j] = 0.0f;

  const bool active = g < ngpt;
  const int band = active ? a.gpt2band[g] : 0;
  // the previous layer's terms for its down source, which needs this
  // layer's level-top source (lev_b(l) = lev_t(l+1))
  float p_omt = 0.0f, p_tf = 0.0f, p_lay = 0.0f, p_pf = 0.0f;

  for (int l0 = 0; l0 < nlay; l0 += kRows) {
    rte::load_rows(a.x, l0, nlay, ncol, col, a.nf, s_x);
    __syncthreads();
    rte::mlp_hidden(m, s_x, a.nf, s_hc, s_h1, s_h2);
    if (active) {
      float yt[kRows], yp[kRows];
      rte::mlp_out(m, s_h2, g, yt);
      rte::mlp_out(m, s_h2, ngpt + g, yp);
      const float ostd = __ldg(m.ostd + g), omean = __ldg(m.omean + g);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int l = l0 + r;
        if (l >= nlay) break;
        const size_t lc = (size_t)l * ncol + col;
        const float tl = rte::tau_post(yt[r], ostd, omean) * a.col_dry[lc] * a.d_secant;
        const float pf = yp[r] * yp[r];
        const float trans = expf(-tl);
        const float fact = tl > a.tau_thresh ? (1.0f - trans) / tl - trans
                                             : tl * (0.5f - (1.0f / 3.0f) * tl);
        const float lay = pf * __ldg(a.b_lay + lc * nband + band);
        const float lev_t = pf * __ldg(a.b_lev + lc * nband + band);
        const float omt = 1.0f - trans, tf = 2.0f * fact;
        a.trans[lc * ngpt + g] = trans;
        a.src_up[lc * ngpt + g] = omt * lev_t + tf * (lay - lev_t);
        if (l > 0) a.src_dn[(lc - ncol) * ngpt + g] = p_omt * lev_t + p_tf * (p_lay - lev_t);
        p_omt = omt; p_tf = tf; p_lay = lay; p_pf = pf;
      }
    }
  }

  if (active) {
    // bottom layer: its own Planck fraction at the bottom level
    const size_t lc = (size_t)(nlay - 1) * ncol + col;
    const float bot = p_pf * __ldg(a.b_lev + (lc + ncol) * nband + band);
    a.src_dn[lc * ngpt + g] = p_omt * bot + p_tf * (p_lay - bot);
    a.sfc_src[(size_t)col * ngpt + g] = p_pf * __ldg(a.b_sfc + (size_t)col * nband + band);
  }
}

// Dynamic shared memory of one block.
size_t smem_bytes(int nf, int h1, int h2) {
  return sizeof(float) * ((size_t)rte::kRows * (nf + h1 + h2) + h1);
}

}  // namespace

// The structs are read on the host. ``net->w1a`` is the whole first layer
// (nf, h1); w1c is not read.
extern "C" int lw_prep_launch(const LwPrepArgs* args, const rte::Mlp3* net, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const LwPrepArgs& a = *args;
  const Mlp3& m = *net;
  if (a.ngpt > rte::kThreads || a.ncol <= 0 || a.nlay <= 0 || m.nout != 2 * a.ngpt)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.nf, m.h1, m.h2);
  if (smem > (size_t)rte::kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(lw_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  lw_prep_kernel<<<a.ncol, rte::kThreads, smem, (cudaStream_t)stream>>>(a, m);
  return (int)cudaGetLastError();
}
