// Fused SW pipeline for one column per thread block: the absorption and
// Rayleigh NN nets -> tau, ssa; optional clouds; PIFM two-stream
// coefficients (asymmetry g = 0 without clouds); the direct beam; the
// surface-to-top albedo/source sweep; the top-down diffuse flux sweep.
//
// Replaces rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py::
// sw_clearsky_megakernel (_sw_mega_kernel), with its cld_fields + cld_lut
// and cld_bands options and its input_mode="lanes". Same physics:
// predict_nn_sw + sw_solver_2stream broadband (reference
// mo_gas_optics_kernels.F90:869-1018; mo_rte_solver_kernels.F90:385-692,
// sw_two_stream_source :1364-1480, adding :1526-1637; clear-sky NN asymmetry
// zero, rrtmgp_rfmip_sw.F90:542-569); clouds as cloud_optics
// (mo_cloud_optics.F90 compute_all_from_table) + delta_scale + increment
// (inc_2stream_by_2stream_bybnd, mo_optical_props_kernels.F90:269-305). The
// coefficients follow the staged _sw_two_stream_coeffs form, evaluated in
// float64 (see phase A); everything else is float32.
//
// One kernel, four modes (rte::MegaMode, a template parameter): clear-sky;
// clouds from (lwp, iwp, rel, rei) through the lookup tables here, with the
// delta scaling in its subtraction form; clouds as band lanes of the
// delta-scaled (tau, tau*ssa, tau*ssa*g) computed outside; clear-sky with
// one array per scaled feature. A thread owns one
// g-point and knows its band, so the band -> g-point expansion is an index.
// With clouds the coefficients take the general-g gammas, still in float64.
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

using rte::kRows;
using rte::Mlp3;

// The launch entry's first argument; ops/cuda/build.py mirrors it field by
// field.
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
  float cld_eps;     // float32's eps: the guard of the cloud combine's divides
  const int* gpt2band;  // (ngpt), cloud modes
  int nband;            // cloud modes
  // kCldLut: water paths and effective radii, each (nlay, ncol)
  const float* lwp;
  const float* iwp;
  const float* rel;
  const float* rei;
  // kCldBands: delta-scaled tau, tau*ssa, tau*ssa*g, each (nlay, ncol, nband)
  const float* cld_tau;
  const float* cld_ts;
  const float* cld_tsg;
};

namespace {

template <int kMode>
__global__ void __launch_bounds__(rte::kThreads)
sw_mega_kernel(const SwArgs a, const Mlp3 ma, const Mlp3 mr,
               const rte::CloudLutOf<kMode> c, const rte::LaneListOf<kMode> lanes) {
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
  constexpr bool kCloudy = kMode == rte::kCldLut || kMode == rte::kCldBands;
  const int band = (kCloudy && active) ? a.gpt2band[g] : 0;

  // ---- phase A: both nets -> tau, ssa -> PIFM coefficients -------------
  for (int l0 = 0; l0 < nlay; l0 += kRows) {
    if constexpr (kMode == rte::kLanes)
      rte::load_rows_lanes(lanes, nullptr, l0, nlay, ncol, col, a.n2d, s_x);
    else
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
      const size_t lc = (size_t)l * ncol + col;
      const float cd = a.col_dry[lc];
      const float tau_abs = rte::tau_post(ya[r], std_a, mean_a) * cd;
      const float tau_ray = rte::tau_post(yr[r], std_r, mean_r) * cd;
      const float tau_gas = tau_abs + tau_ray;
      const float ssa_gas = tau_gas > 0.0f ? tau_ray / tau_gas : 0.0f;
      float tau = tau_gas, ssa = ssa_gas, asy = 0.0f;
      if constexpr (kCloudy) {
        // band values of the delta-scaled cloud tau, tau*ssa, tau*ssa*g
        float tc, tsc, tgc;
        if constexpr (kMode == rte::kCldLut) {
          float lt, lts, ltsg, it, its, itsg;
          rte::cloud_lut_phase(c.liq, c.n_liq, c.nband, band, c.liq_off, c.liq_step,
                               a.lwp[lc], a.rel[lc], lt, lts, ltsg);
          rte::cloud_lut_phase(c.ice, c.n_ice, c.nband, band, c.ice_off, c.ice_step,
                               a.iwp[lc], a.rei[lc], it, its, itsg);
          // phase sum, then delta scaling with f = g^2 in subtraction form:
          // with u = (tau*ssa*g)^2 / (tau*ssa) all three products lose u
          const float tau_b = lt + it, taussa = lts + its, tsg = ltsg + itsg;
          const float u = tsg * (tsg / fmaxf(a.cld_eps, taussa));
          tc = tau_b - u;
          tsc = taussa - u;
          tgc = tsg - u;
        } else {
          const size_t i = lc * a.nband + band;
          tc = a.cld_tau[i];
          tsc = a.cld_ts[i];
          tgc = a.cld_tsg[i];
        }
        // increment the gas properties (asymmetry 0) by the cloud's
        tau = tau_gas + tc;
        const float tauscat = tau_gas * ssa_gas + tsc;
        asy = tgc / fmaxf(a.cld_eps, tauscat);
        ssa = tauscat / fmaxf(a.cld_eps, tau);
      }
      // Zdunkowski PIFM (without clouds g = 0: gamma3 = gamma4 = 1/2),
      // evaluated in double: rdir and tdir are 0/0 forms at the resonance
      // k*mu0 = 1, and in float32 a column whose mu0 sits within ~1e-4 of
      // 1/k in every layer (ssa constant down the column) is off by up to
      // ~10 W/m2. This departs from the Pallas kernel, which is float32
      // throughout; its cost on an H100 is in PERF.md.
      const double ssa_d = ssa, mu0_d = mu0, tau_d = tau;
      double gamma1, gamma2, gamma3, gamma4;
      if constexpr (kCloudy) {
        const double g_d = asy;
        gamma1 = (8.0 - ssa_d * (5.0 + 3.0 * g_d)) * 0.25;
        gamma2 = 3.0 * (ssa_d * (1.0 - g_d)) * 0.25;
        gamma3 = (2.0 - 3.0 * mu0_d * g_d) * 0.25;
        gamma4 = 1.0 - gamma3;
      } else {
        gamma1 = (8.0 - ssa_d * 5.0) * 0.25;
        gamma2 = (3.0 * ssa_d) * 0.25;
        gamma3 = 0.5;
        gamma4 = 0.5;
      }
      const double alpha1 = gamma1 * gamma4 + gamma2 * gamma3;
      const double alpha2 = gamma1 * gamma3 + gamma2 * gamma4;
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
      const double k_g3 = k * gamma3, k_g4 = k * gamma4;
      const double one_m = 1.0 - k_mu2;
      const double denom = fabs(one_m) >= (double)a.eps ? one_m : (double)a.eps;
      const double rt2 = ssa_d * rt_term / denom;
      double rdir = rt2 * ((1.0 - k_mu) * (alpha2 + k_g3)
                           - (1.0 + k_mu) * (alpha2 - k_g3) * e2
                           - k2e * (gamma3 - alpha2 * mu0_d) * tnoscat);
      double tdir = rt2 * (k2e * (gamma4 + alpha1 * mu0_d)
                           - tnoscat * ((1.0 + k_mu) * (alpha1 + k_g4)
                                        - (1.0 - k_mu) * (alpha1 - k_g4) * e2));
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

template <int kMode>
static int launch_mode(const SwArgs& a, const Mlp3& ma, const Mlp3& mr,
                       const rte::CloudLutOf<kMode>& c, const rte::LaneListOf<kMode>& lanes,
                       size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sw_mega_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sw_mega_kernel<kMode><<<a.ncol, rte::kThreads, smem, stream>>>(a, ma, mr, c, lanes);
  return (int)cudaGetLastError();
}

// mode: rte::MegaMode. The cloud modes read gpt2band and nband; kCldLut reads
// lwp/iwp/rel/rei and ``cloud``; kCldBands reads cld_tau/cld_ts/cld_tsg;
// kLanes reads ``lanes`` (the n2d scaled features, one array each) and
// ignores x. The structs are read on the host; pointers the mode does not
// read may be null.
extern "C" int sw_clearsky_megakernel_launch(
    const SwArgs* args, const rte::Mlp3* abs_net, const rte::Mlp3* ray_net,
    const rte::CloudLut* cloud, const rte::LaneList* lanes,
    int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SwArgs& a = *args;
  const Mlp3& ma = *abs_net;
  const Mlp3& mr = *ray_net;
  if (a.ngpt > rte::kThreads || a.ncol <= 0 || a.nlay <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sw_clearsky_megakernel_smem_bytes(a.nlay, a.n2d, ma.h1, ma.h2, mr.h1, mr.h2, a.ngpt);
  if (smem > (size_t)rte::kMaxSmem) return (int)cudaErrorInvalidValue;
  const rte::Unused none{};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case rte::kClear: return launch_mode<rte::kClear>(a, ma, mr, none, none, smem, st);
    case rte::kCldLut:
      if (cloud == nullptr || cloud->n_liq < 2 || cloud->n_ice < 2)
        return (int)cudaErrorInvalidValue;
      return launch_mode<rte::kCldLut>(a, ma, mr, *cloud, none, smem, st);
    case rte::kCldBands: return launch_mode<rte::kCldBands>(a, ma, mr, none, none, smem, st);
    case rte::kLanes:
      if (lanes == nullptr || a.n2d > rte::kMaxLanes) return (int)cudaErrorInvalidValue;
      return launch_mode<rte::kLanes>(a, ma, mr, none, *lanes, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}
