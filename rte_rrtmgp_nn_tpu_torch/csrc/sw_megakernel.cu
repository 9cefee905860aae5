// Fused SW clear-sky pipeline for one column per thread block: the
// absorption and Rayleigh NN nets -> tau, ssa; PIFM two-stream coefficients
// (asymmetry g = 0); the direct beam; the surface-to-top albedo/source
// sweep; the top-down diffuse flux sweep.
//
// Replaces rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py::
// sw_clearsky_megakernel (_sw_mega_kernel). Same physics: predict_nn_sw +
// sw_solver_2stream broadband (reference mo_gas_optics_kernels.F90:869-1018;
// mo_rte_solver_kernels.F90:385-692, sw_two_stream_source :1364-1480,
// adding :1526-1637; clear-sky NN asymmetry zero, rrtmgp_rfmip_sw.F90:
// 542-569). The coefficients follow the staged _sw_two_stream_coeffs form,
// evaluated in float64 (see phase A); everything else is float32.
//
// What bounds it on an H100: the two MLPs (7->48->48->112 each, ~16k FMAs
// per (layer, column), 1.7 GFMA at 1800 x 60) share the weight-reuse design
// of the LW kernel (kRows layers per weight load, weights from L1/L2), and
// the six per-layer fields (rdif, tdif, the two direct-beam sources, the
// cumulative albedo and the adding denominator: 6 x nlay x ngpt floats,
// 161 KB at 60 x 112) live in shared memory, which allows one block per SM.
// Nothing per g-point reaches device memory. The direct beam is
// exp(-cumulative tau/mu0), one exp per level, not a running product of
// per-layer exps (which would compound the exp's rounding over the column).
// Night columns arrive with mu0 = 1; the driver zeroes their fluxes.
#include "common.cuh"

namespace {

using rte::kRows;
using rte::Mlp3;

struct SwArgs {
  const float* x;        // (nlay, ncol, n2d) scaled layer-varying features
  const float* cf;       // (ncol, nc) scaled per-column constant features
  const float* col_dry;  // (nlay, ncol)
  const float* mu0;      // (ncol) cosine of the solar zenith angle
  const float* inc_dir;  // (ncol, ngpt) TOA direct flux, already times mu0
  const float* inc_dif;  // (ncol, ngpt) TOA diffuse flux
  const float* alb_dir;  // (ncol, ngpt)
  const float* alb_dif;  // (ncol, ngpt)
  float* up;             // (ncol, nlay+1)
  float* dn;             // (ncol, nlay+1) total (diffuse + direct)
  float* dir;            // (ncol, nlay+1)
  int ncol, nlay, n2d, nc, ngpt;
  float k_min, eps;  // eps: the float64 guard of the k*mu0 = 1 resonance
};

__global__ void __launch_bounds__(rte::kThreads)
sw_mega_kernel(const SwArgs a, const Mlp3 ma, const Mlp3 mr) {
  extern __shared__ float smem[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const int nlay = a.nlay, ncol = a.ncol, ngpt = a.ngpt;
  const int nf = nlay * ngpt;
  const int h1 = max(ma.h1, mr.h1), h2 = max(ma.h2, mr.h2);
  float* s_rdif = smem;           // (nlay, ngpt)
  float* s_tdif = s_rdif + nf;    // (nlay, ngpt)
  float* s_a = s_tdif + nf;       // rdir -> direct-beam src_up -> src below the layer
  float* s_b = s_a + nf;          // tdir -> direct-beam src_dn -> diffuse dn at level l+1
  float* s_d = s_b + nf;          // 1 / (1 - rdif * alb_below)
  float* s_c = s_d + nf;          // (nlay+1, ngpt): tau/mu0 -> direct flux -> alb below -> up at level l+1
  float* s_top = s_c + nf + ngpt; // (2, ngpt): level-0 diffuse dn and up
  float* s_dir = s_top + 2 * ngpt;  // (nlay+1) broadband direct flux
  float* s_x = s_dir + nlay + 1;  // (kRows, n2d)
  float* s_hca = s_x + kRows * a.n2d;  // (ma.h1)
  float* s_hcr = s_hca + ma.h1;   // (mr.h1)
  float* s_h1 = s_hcr + mr.h1;    // (kRows, h1)
  float* s_h2 = s_h1 + kRows * h1;  // (kRows, h2)

  const float* cf = a.cf + (size_t)col * a.nc;
  rte::mlp_const_part(ma, cf, a.nc, s_hca);
  rte::mlp_const_part(mr, cf, a.nc, s_hcr);

  const bool active = g < ngpt;
  const float mu0 = a.mu0[col];
  const float mu0_inv = 1.0f / mu0;

  // ---- phase A: both nets -> tau, ssa -> PIFM coefficients -------------
  for (int l0 = 0; l0 < nlay; l0 += kRows) {
    rte::load_rows(a.x, l0, nlay, ncol, col, a.n2d, s_x);
    __syncthreads();
    float ya[kRows], yr[kRows];
    rte::mlp_hidden(ma, s_x, a.n2d, s_hca, s_h1, s_h2);
    if (active) rte::mlp_out(ma, s_h2, g, ya);
    rte::mlp_hidden(mr, s_x, a.n2d, s_hcr, s_h1, s_h2);
    if (!active) continue;
    rte::mlp_out(mr, s_h2, g, yr);
    const float std_a = __ldg(ma.ostd + g), mean_a = __ldg(ma.omean + g);
    const float std_r = __ldg(mr.ostd + g), mean_r = __ldg(mr.omean + g);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int l = l0 + r;
      if (l >= nlay) break;
      const float cd = a.col_dry[(size_t)l * ncol + col];
      const float tau_abs = rte::tau_post(ya[r], std_a, mean_a) * cd;
      const float tau_ray = rte::tau_post(yr[r], std_r, mean_r) * cd;
      const float tau = tau_abs + tau_ray;
      const float ssa = tau > 0.0f ? tau_ray / tau : 0.0f;
      // Zdunkowski PIFM with g = 0 (gamma3 = gamma4 = 1/2), evaluated in
      // double: rdir and tdir are 0/0 forms at the resonance k*mu0 = 1, and
      // in float32 a column whose mu0 sits within ~1e-4 of 1/k in every
      // layer (ssa constant down the column) is off by up to ~10 W/m2. This
      // departs from the Pallas kernel, which is float32 throughout; its
      // cost on an H100 is in PERF.md.
      const double ssa_d = ssa, mu0_d = mu0, tau_d = tau;
      const double gamma1 = (8.0 - ssa_d * 5.0) * 0.25;
      const double gamma2 = (3.0 * ssa_d) * 0.25;
      const double alpha1 = gamma1 * 0.5 + gamma2 * 0.5;
      const double alpha2 = gamma1 * 0.5 + gamma2 * 0.5;
      const double k = sqrt(fmax((gamma1 - gamma2) * (gamma1 + gamma2), (double)a.k_min));
      const double tnoscat = exp(-tau_d / mu0_d);
      const double e1 = exp(-tau_d * k);
      const double e2 = e1 * e1;
      const double k2e = 2.0 * k * e1;
      const double rt_term = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2));
      const float rdif = (float)(rt_term * gamma2 * (1.0 - e2));
      const float tdif = (float)(rt_term * k2e);
      const double k_mu = k * mu0_d;
      const double k_mu2 = k_mu * k_mu;
      const double k_g = k * 0.5;
      const double one_m = 1.0 - k_mu2;
      const double denom = fabs(one_m) >= (double)a.eps ? one_m : (double)a.eps;
      const double rt2 = ssa_d * rt_term / denom;
      double rdir = rt2 * ((1.0 - k_mu) * (alpha2 + k_g)
                           - (1.0 + k_mu) * (alpha2 - k_g) * e2
                           - k2e * (0.5 - alpha2 * mu0_d) * tnoscat);
      double tdir = rt2 * (k2e * (0.5 + alpha1 * mu0_d)
                           - tnoscat * ((1.0 + k_mu) * (alpha1 + k_g)
                                        - (1.0 - k_mu) * (alpha1 - k_g) * e2));
      rdir = fmin(fmax(rdir, 0.0), 1.0 - tnoscat);
      tdir = fmin(fmax(tdir, 0.0), 1.0 - tnoscat - rdir);
      const int i = l * ngpt + g;
      s_rdif[i] = rdif;
      s_tdif[i] = tdif;
      s_a[i] = (float)rdir;
      s_b[i] = (float)tdir;
      s_c[i] = tau * mu0_inv;
    }
  }

  // ---- phase B: direct beam, exp(-cumulative optical path) ---------------
  float dsfc = 0.0f;
  if (active) {
    const float inc = a.inc_dir[(size_t)col * ngpt + g];
    float path = 0.0f;
    for (int l = 0; l < nlay; ++l) {
      const int i = l * ngpt + g;
      const float dinc = inc * expf(-path);
      const float step = s_c[i];
      s_c[i] = dinc;
      s_a[i] *= dinc;  // src_up
      s_b[i] *= dinc;  // src_dn
      path += step;
    }
    dsfc = inc * expf(-path);
    s_c[nf + g] = dsfc;
  }
  __syncthreads();
  rte::level_sums(s_c, nlay + 1, ngpt, 1.0f, nullptr, s_dir);
  __syncthreads();

  if (active) {
    // ---- phase C: surface-to-top cumulative albedo and source ------------
    const size_t cg = (size_t)col * ngpt + g;
    float alb = a.alb_dif[cg];
    float src = dsfc * a.alb_dir[cg];
    for (int l = nlay - 1; l >= 0; --l) {
      const int i = l * ngpt + g;
      const float rd = s_rdif[i], td = s_tdif[i];
      const float d = 1.0f / (1.0f - rd * alb);
      const float src_new = s_a[i] + td * d * (src + alb * s_b[i]);
      const float alb_new = rd + td * td * alb * d;
      s_c[i] = alb;
      s_a[i] = src;
      s_d[i] = d;
      alb = alb_new;
      src = src_new;
    }
    // ---- phase D: top-down diffuse flux sweep ------------------------------
    float fdn = a.inc_dif[cg];
    s_top[g] = fdn;
    s_top[ngpt + g] = fdn * alb + src;
    for (int l = 0; l < nlay; ++l) {
      const int i = l * ngpt + g;
      fdn = (s_tdif[i] * fdn + s_rdif[i] * s_a[i] + s_b[i]) * s_d[i];
      s_b[i] = fdn;
      s_c[i] = fdn * s_c[i] + s_a[i];
    }
  }
  __syncthreads();

  // ---- per-level spectral sums ------------------------------------------
  const size_t o = (size_t)col * (nlay + 1);
  rte::level_sums(s_top, 1, ngpt, 1.0f, s_dir, a.dn + o);
  rte::level_sums(s_b, nlay, ngpt, 1.0f, s_dir + 1, a.dn + o + 1);
  rte::level_sums(s_top + ngpt, 1, ngpt, 1.0f, nullptr, a.up + o);
  rte::level_sums(s_c, nlay, ngpt, 1.0f, nullptr, a.up + o + 1);
  for (int l = threadIdx.x; l <= nlay; l += blockDim.x) a.dir[o + l] = s_dir[l];
}

}  // namespace

// Dynamic shared memory of one block (the wrapper checks it against the card).
extern "C" size_t sw_clearsky_megakernel_smem_bytes(int nlay, int n2d, int h1a, int h2a,
                                                    int h1r, int h2r, int ngpt) {
  const int h1 = h1a > h1r ? h1a : h1r, h2 = h2a > h2r ? h2a : h2r;
  return sizeof(float) * ((size_t)6 * nlay * ngpt + 3 * (size_t)ngpt + nlay + 1 +
                          rte::kRows * (n2d + h1 + h2) + h1a + h1r);
}

extern "C" int sw_clearsky_megakernel_launch(
    const float* x, const float* cf, const float* col_dry, const float* mu0,
    const float* inc_dir, const float* inc_dif, const float* alb_dir, const float* alb_dif,
    const float* a_w1a, const float* a_w1c, const float* a_b1, const float* a_w2,
    const float* a_b2, const float* a_w3, const float* a_b3, const float* a_omean,
    const float* a_ostd,
    const float* r_w1a, const float* r_w1c, const float* r_b1, const float* r_w2,
    const float* r_b2, const float* r_w3, const float* r_b3, const float* r_omean,
    const float* r_ostd,
    float* up, float* dn, float* dir,
    int ncol, int nlay, int n2d, int nc, int h1a, int h2a, int h1r, int h2r, int ngpt,
    float k_min, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ngpt > rte::kThreads || ncol <= 0 || nlay <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sw_clearsky_megakernel_smem_bytes(nlay, n2d, h1a, h2a, h1r, h2r, ngpt);
  if (smem > (size_t)rte::kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(sw_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  SwArgs a{x, cf, col_dry, mu0, inc_dir, inc_dif, alb_dir, alb_dif, up, dn, dir,
           ncol, nlay, n2d, nc, ngpt, k_min, eps};
  Mlp3 ma{a_w1a, a_w1c, a_b1, a_w2, a_b2, a_w3, a_b3, a_omean, a_ostd, h1a, h2a, ngpt};
  Mlp3 mr{r_w1a, r_w1c, r_b1, r_w2, r_b2, r_w3, r_b3, r_omean, r_ostd, h1r, h2r, ngpt};
  sw_mega_kernel<<<ncol, rte::kThreads, smem, (cudaStream_t)stream>>>(a, ma, mr);
  return (int)cudaGetLastError();
}
