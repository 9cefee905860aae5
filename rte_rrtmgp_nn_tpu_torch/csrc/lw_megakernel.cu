// Fused LW clear-sky pipeline for one column per thread block: NN gas
// optics (3-layer softsign "both" net -> tau, Planck fraction), Planck
// sources with the totplnk interpolation in the kernel, and the
// no-scattering broadband transport (down sweep, surface, up sweep).
//
// Replaces rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py::lw_clearsky_mega4
// (_mega4_kernel). Same physics: predict_nn_lw + compute_planck_source_nn +
// lw_solver_noscat broadband, single diffusivity angle, zero incident flux
// (reference mo_gas_optics_kernels.F90:615-683, 690-862;
// mo_rte_solver_kernels.F90:119-330).
//
// What bounds it on an H100: the MLP, about 50k FMAs per (layer, column)
// with the 18->128->128->256 net, 5.4 GFMA at 1800 x 60, with every FMA
// needing a weight. The weights (206 KB) stay in L2/L1; the design reuses
// each weight load for kRows layers (register blocking), so the kernel is
// bound by L1 load bandwidth and FMA issue, not by device memory (the
// inputs are ~20 floats per (layer, column), the outputs 2 per level).
// The per-layer fields (transmittance, both sources: 3 x nlay x ngpt floats,
// 92 KB at 60 x 128) live in shared memory, so tau, pfrac and the g-point
// sources never reach device memory; that caps residency at two blocks per
// SM. The two sweeps are per-thread recurrences; the per-level spectral sums
// are taken once after the sweeps, one warp per level.
#include "common.cuh"

namespace {

using rte::kRows;
using rte::Mlp3;
using rte::PlanckTab;

struct LwArgs {
  const float* x;        // (nlay, ncol, n2d) scaled layer-varying features
  const float* cf;       // (ncol, nc) scaled per-column constant features
  const float* col_dry;  // (nlay, ncol)
  const float* tlay;     // (nlay, ncol) [K]
  const float* tlev;     // (nlay+1, ncol) [K]
  const float* tsfc;     // (ncol) [K]
  const float* emis;     // (ncol, ngpt)
  const int* gpt2band;   // (ngpt)
  float* up;             // (ncol, nlay+1)
  float* dn;             // (ncol, nlay+1)
  int ncol, nlay, n2d, nc, ngpt;
  float d_secant, two_pi_w, tau_thresh;
};

__global__ void __launch_bounds__(rte::kThreads)
lw_mega_kernel(const LwArgs a, const Mlp3 m, const PlanckTab p) {
  extern __shared__ float smem[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const int nlay = a.nlay, ncol = a.ncol, ngpt = a.ngpt;
  float* s_trans = smem;                        // (nlay, ngpt)
  float* s_dn = s_trans + nlay * ngpt;          // (nlay, ngpt): src_dn, then radiance at level l+1
  float* s_up = s_dn + nlay * ngpt;             // (nlay+1, ngpt): src_up, then radiance at level l
  float* s_x = s_up + (nlay + 1) * ngpt;        // (kRows, n2d)
  float* s_hc = s_x + kRows * a.n2d;            // (h1)
  float* s_h1 = s_hc + m.h1;                    // (kRows, h1)
  float* s_h2 = s_h1 + kRows * m.h1;            // (kRows, h2)

  rte::mlp_const_part(m, a.cf + (size_t)col * a.nc, a.nc, s_hc);

  const bool active = g < ngpt;
  const int band = active ? a.gpt2band[g] : 0;
  // previous layer's terms for its down source, which needs this layer's
  // level-top source (lev_b(l) = lev_t(l+1))
  float p_omt = 0.0f, p_tf = 0.0f, p_lay = 0.0f, p_pf = 0.0f;

  // ---- phase A: MLP + transmittance + sources, kRows layers at a time ----
  for (int l0 = 0; l0 < nlay; l0 += kRows) {
    rte::load_rows(a.x, l0, nlay, ncol, col, a.n2d, s_x);
    __syncthreads();
    rte::mlp_hidden(m, s_x, a.n2d, s_hc, s_h1, s_h2);
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
        const float lay = pf * rte::planck_interp(p, a.tlay[lc], band);
        const float lev_t = pf * rte::planck_interp(p, a.tlev[lc], band);
        const float omt = 1.0f - trans, tf = 2.0f * fact;
        s_trans[l * ngpt + g] = trans;
        s_up[l * ngpt + g] = omt * lev_t + tf * (lay - lev_t);
        if (l > 0) s_dn[(l - 1) * ngpt + g] = p_omt * lev_t + p_tf * (p_lay - lev_t);
        p_omt = omt; p_tf = tf; p_lay = lay; p_pf = pf;
      }
    }
  }

  if (active) {
    // bottom layer: its own Planck fraction at the bottom level
    const float bot = p_pf * rte::planck_interp(p, a.tlev[(size_t)nlay * ncol + col], band);
    s_dn[(nlay - 1) * ngpt + g] = p_omt * bot + p_tf * (p_lay - bot);
    const float sfc_src = p_pf * rte::planck_interp(p, a.tsfc[col], band);

    // ---- phase B: top-down sweep (zero incident radiance) ----------------
    float rad = 0.0f;
    for (int l = 0; l < nlay; ++l) {
      rad = s_trans[l * ngpt + g] * rad + s_dn[l * ngpt + g];
      s_dn[l * ngpt + g] = rad;
    }
    // ---- phase C: surface emission/reflection, bottom-up sweep -----------
    const float e = a.emis[(size_t)col * ngpt + g];
    rad = rad * (1.0f - e) + e * sfc_src;
    s_up[nlay * ngpt + g] = rad;
    for (int l = nlay - 1; l >= 0; --l) {
      rad = s_trans[l * ngpt + g] * rad + s_up[l * ngpt + g];
      s_up[l * ngpt + g] = rad;
    }
  }
  __syncthreads();

  // ---- per-level spectral sums ------------------------------------------
  float* up = a.up + (size_t)col * (nlay + 1);
  float* dn = a.dn + (size_t)col * (nlay + 1);
  if (threadIdx.x == 0) dn[0] = 0.0f;
  rte::level_sums(s_dn, nlay, ngpt, a.two_pi_w, nullptr, dn + 1);
  rte::level_sums(s_up, nlay + 1, ngpt, a.two_pi_w, nullptr, up);
}

}  // namespace

// Dynamic shared memory of one block (the wrapper checks it against the card).
extern "C" size_t lw_clearsky_mega4_smem_bytes(int nlay, int n2d, int h1, int h2, int ngpt) {
  return sizeof(float) * ((size_t)nlay * ngpt * 2 + (size_t)(nlay + 1) * ngpt +
                          rte::kRows * (n2d + h1 + h2) + h1);
}

extern "C" int lw_clearsky_mega4_launch(
    const float* x, const float* cf, const float* col_dry, const float* tlay,
    const float* tlev, const float* tsfc, const float* emis,
    const float* w1a, const float* w1c, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, const float* omean,
    const float* ostd, const float* tab, const float* dtab, const int* gpt2band,
    float* up, float* dn,
    int ncol, int nlay, int n2d, int nc, int h1, int h2, int ngpt, int nband, int ntab,
    float t_min, float t_delta, float d_secant, float two_pi_w, float tau_thresh,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ngpt > rte::kThreads || ncol <= 0 || nlay <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = lw_clearsky_mega4_smem_bytes(nlay, n2d, h1, h2, ngpt);
  if (smem > (size_t)rte::kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(lw_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  LwArgs a{x, cf, col_dry, tlay, tlev, tsfc, emis, gpt2band, up, dn,
           ncol, nlay, n2d, nc, ngpt, d_secant, two_pi_w, tau_thresh};
  Mlp3 m{w1a, w1c, b1, w2, b2, w3, b3, omean, ostd, h1, h2, 2 * ngpt};
  PlanckTab p{tab, dtab, nband, ntab, t_min, t_delta};
  lw_mega_kernel<<<ncol, rte::kThreads, smem, (cudaStream_t)stream>>>(a, m, p);
  return (int)cudaGetLastError();
}

