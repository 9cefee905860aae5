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
// What bounds it on an H100, and what the design does about it. The work per
// column is small next to the card's rates (two 7->48->48->112 nets, ~16k
// FMAs per (layer, column); ~400 double-precision instructions per (layer,
// g-point) for the coefficients), and the per-layer fields must stay in
// shared memory (five fields of nlay x ngpt floats: rdif, tdif, the two
// direct-beam sources and the cumulative albedo, 134 KB at 60 x 112), so one
// column is resident per SM and the kernel is bound by latency: a warp
// issues an instruction every four to five clocks whatever the code offers,
// so the time is instructions per warp over warps in flight. Hence a block
// is up to four layer groups of 128 threads (16 warps for the one column
// where the first version had 4): each group takes a contiguous quarter of
// the layers through phase A with its own MLP scratch and its own named
// barrier, and never waits for another group. Within a group warps 0-1 take
// the absorption net and warps 2-3 the Rayleigh net on the same rows (the
// tiled MLP of common.cuh: rows k-major in shared memory, register tiles of 8
// rows x 2 columns in the hidden layers and 8 x 4 in the last, weights
// through L1: the two nets are 64 KB), and leave (ystd*y + ymean)**8 of both
// in shared memory. The coefficients are a second loop over the group's
// real layers, one thread per g-point, two layers per trip, so that two
// double-precision chains interleave and no padded row is computed; the
// column's col_dry and cloud fields wait in shared memory, read once. The
// adding denominator 1 / (1 - rdif * albedo below) is not stored: the flux
// sweep recomputes it (one divide per cell off the sweep's dependency chain),
// which frees 27 KB at 60 x 112, and that is what lets four groups' MLP
// scratch (64 KB) fit beside the fields. The double-precision loop runs at
// the rate of the card's float64 units, so nothing in it may leave the
// divide's straight-line code: a zero numerator (tau = 0, ssa = 0, a
// cloud-free cell's cloud terms) sends the whole warp through the divide's
// slow-path subroutine, which cost the warps that held such cells half again
// the loop's time and every group the wait for them; the loop multiplies by
// 1 / mu0, lets ssa multiply a quotient, and guards the float32 divides of
// zero (rte::div_or_zero). The direct beam is exp(-cumulative tau/mu0), one
// exp per level, not a running product of per-layer exps (which would
// compound the exp's rounding over the column): the running sum of the path
// is one thread per g-point, the exponentials and the sources that hang on
// them are taken by every group for its own layers. The albedo sweep and the
// flux sweep stay one thread per g-point (4 warps of the 16), four layers at a
// time in straight-line code; with the direct beam and its level sums they
// are a quarter of the kernel's time, the two recurrences 18% together: the
// next thing to redesign. The level sums use every warp, four levels of a warp at a
// time. Nothing per g-point reaches device memory. Night columns arrive with
// mu0 = 1; the caller zeroes their fluxes. Times, registers, the phases'
// shares (scripts/tune_megakernel_tiles.py times copies of the kernel that stop
// after a phase) and the alternatives measured on an H100: PERF.md.
#include "common.cuh"

using rte::kGroup;
using rte::kMegaRows;
using rte::kRowStride;
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

// Floats of one layer group's MLP scratch: the feature rows and both nets'
// two hidden layers, k-major.
__host__ __device__ inline int group_floats(int n2d, int h1a, int h2a, int h1r, int h2r) {
  return kRowStride * (n2d + h1a + h1r + h2a + h2r);
}

// Floats of the column's per-layer scalars kept in shared memory: col_dry
// and room for the four cloud fields.
__host__ __device__ inline int column_floats(int nlay) { return 5 * nlay; }

// Dynamic shared memory of one block; ops/cuda/sw_megakernel.py launch_plan
// computes the same number.
size_t smem_bytes(int groups, int nlay, int n2d, int h1a, int h2a, int h1r, int h2r, int ngpt) {
  return sizeof(float) * ((size_t)groups * group_floats(n2d, h1a, h2a, h1r, h2r) +
                          rte::align4(h1a) + rte::align4(h1r) + column_floats(nlay) +
                          (size_t)5 * nlay * ngpt + 3 * (size_t)ngpt + nlay + 1);
}

template <int kMode>
__global__ void __launch_bounds__(rte::kMaxGroups * kGroup, 1)
sw_mega_kernel(const SwArgs a, const Mlp3 ma, const Mlp3 mr, const int layers_per_group,
               const rte::CloudLutOf<kMode> c, const rte::LaneListOf<kMode> lanes) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int col = blockIdx.x;
  const int group = threadIdx.x / kGroup, gtid = threadIdx.x - group * kGroup;
  const int ngroups = blockDim.x / kGroup;
  const int g = gtid;
  const int nlay = a.nlay, ncol = a.ncol, ngpt = a.ngpt;
  const int nf = nlay * ngpt;
  const int gfl = group_floats(a.n2d, ma.h1, ma.h2, mr.h1, mr.h2);
  float* s_x = smem + group * gfl;              // (n2d, kRowStride), this group's
  float* s_h1a = s_x + kRowStride * a.n2d;      // (ma.h1, kRowStride)
  float* s_h1r = s_h1a + kRowStride * ma.h1;    // (mr.h1, kRowStride)
  float* s_h2a = s_h1r + kRowStride * mr.h1;    // (ma.h2, kRowStride)
  float* s_h2r = s_h2a + kRowStride * ma.h2;    // (mr.h2, kRowStride)
  float* s_hca = smem + ngroups * gfl;          // (ma.h1)
  float* s_hcr = s_hca + rte::align4(ma.h1);    // (mr.h1)
  float* s_cd = s_hcr + rte::align4(mr.h1);     // (nlay) col_dry of this column
  float* s_cld = s_cd + nlay;                   // (4, nlay): lwp, iwp, rel, rei (kCldLut)
  float* s_rdif = s_cd + column_floats(nlay);   // (nlay, ngpt)
  float* s_tdif = s_rdif + nf;    // (nlay, ngpt)
  float* s_a = s_tdif + nf;       // abs net's y**8 -> rdir -> direct-beam src_up -> src below the layer
  float* s_b = s_a + nf;          // Rayleigh net's y**8 -> tdir -> direct-beam src_dn -> diffuse dn at level l+1
  float* s_c = s_b + nf;          // (nlay+1, ngpt): tau/mu0 -> direct flux -> alb below -> up at level l+1
  float* s_top = s_c + nf + ngpt; // (2, ngpt): level-0 diffuse dn and up
  float* s_dir = s_top + 2 * ngpt;  // (nlay+1) broadband direct flux

  const float* cf = a.cf + (size_t)col * a.nc;
  rte::mlp_const_part(ma, cf, a.nc, s_hca);
  rte::mlp_const_part(mr, cf, a.nc, s_hcr);
  // this column's per-layer scalars: read once here, coalesced over layers,
  // so that the per-layer loop below does not wait on device memory
  for (int l = threadIdx.x; l < nlay; l += blockDim.x) {
    const size_t lc = (size_t)l * ncol + col;
    s_cd[l] = a.col_dry[lc];
    if constexpr (kMode == rte::kCldLut) {
      s_cld[l] = a.lwp[lc];
      s_cld[nlay + l] = a.iwp[lc];
      s_cld[2 * nlay + l] = a.rel[lc];
      s_cld[3 * nlay + l] = a.rei[lc];
    }
  }
  __syncthreads();

  const bool active = g < ngpt;
  const float mu0 = a.mu0[col];
  const float mu0_inv = 1.0f / mu0;
  constexpr bool kCloudy = kMode == rte::kCldLut || kMode == rte::kCldBands;
  const int band = (kCloudy && active) ? a.gpt2band[g] : 0;
  const int lbeg = min(group * layers_per_group, nlay);
  const int lend = min(lbeg + layers_per_group, nlay);

  // ---- phase A, first loop: both nets -> (ystd*y + ymean)**8 of each -------
  // warps 0-1 of the group: the absorption net's hidden layers; warps 2-3:
  // the Rayleigh net's
  const int half = gtid / (kGroup / 2), htid = gtid - half * (kGroup / 2);
  const float* w1 = half ? mr.w1a : ma.w1a;
  const float* b1 = half ? mr.b1 : ma.b1;
  const float* w2 = half ? mr.w2 : ma.w2;
  const float* b2 = half ? mr.b2 : ma.b2;
  const int h1 = half ? mr.h1 : ma.h1, h2 = half ? mr.h2 : ma.h2;
  const float* s_hc = half ? s_hcr : s_hca;
  float* s_h1 = half ? s_h1r : s_h1a;
  float* s_h2 = half ? s_h2r : s_h2a;
  for (int l0 = lbeg; l0 < lend; l0 += kMegaRows) {
    if constexpr (kMode == rte::kLanes)
      rte::load_rows_lanes_kmajor(lanes, nullptr, l0, lend, ncol, col, a.n2d, s_x, gtid);
    else
      rte::load_rows_kmajor(a.x, l0, lend, ncol, col, a.n2d, s_x, gtid);
    rte::group_sync(group);
    rte::mlp_layer_tiled<rte::kTileR, rte::kTileC, false>(w1, b1, s_hc, a.n2d, h1, s_x, s_h1,
                                                          htid, kGroup / 2);
    rte::group_sync(group);
    rte::mlp_layer_tiled<rte::kTileR, rte::kTileC, false>(w2, b2, nullptr, h1, h2, s_h1, s_h2,
                                                          htid, kGroup / 2);
    rte::group_sync(group);
    // a net's last layer leaves (ystd*y + ymean)**8 in a field: the same
    // halves of the group take a net each
    {
      const float* w3 = half ? mr.w3 : ma.w3;
      const float* b3 = half ? mr.b3 : ma.b3;
      const float* ostds = half ? mr.ostd : ma.ostd;
      const float* omeans = half ? mr.omean : ma.omean;
      float* s_field = half ? s_b : s_a;
      rte::mlp_last_tiled<rte::kOutR, rte::kOutC>(
          w3, h2, ngpt, s_h2, htid, kGroup / 2,
          [&](int row0, int c, const float (&sum)[rte::kOutR]) {
            const float b = __ldg(b3 + c), ostd = __ldg(ostds + c), omean = __ldg(omeans + c);
#pragma unroll
            for (int r = 0; r < rte::kOutR; ++r)
              if (l0 + row0 + r < lend)
                s_field[(l0 + row0 + r) * ngpt + c] = rte::tau_post(sum[r] + b, ostd, omean);
          });
    }
  }
  rte::group_sync(group);  // the group's cells are complete for its g-point threads

  // ---- phase A, second loop: tau, ssa (+ clouds) -> PIFM coefficients ------
  // over this group's layers, one thread per g-point
  if (active) {
    // The double-precision divide leaves its straight-line code for a
    // subroutine when its numerator is zero or tiny, and takes the whole warp
    // along: a cell with tau = 0 or ssa = 0 (the demo nets give both) cost its
    // warp half again the loop's time. So no numerator here can be zero: the
    // path is tau times 1 / mu0, and ssa multiplies a quotient.
    const double mu0_inv_d = 1.0 / (double)mu0;
#pragma unroll 2
    for (int l = lbeg; l < lend; ++l) {
      const int i = l * ngpt + g;
      const float cd = s_cd[l];
      const float tau_abs = s_a[i] * cd;
      const float tau_ray = s_b[i] * cd;
      const float tau_gas = tau_abs + tau_ray;
      // (a cell without optical depth divides 1 by 1 and drops the quotient:
      // 0 / 0 would send its whole warp through the divide's slow path)
      const bool has_tau = tau_gas > 0.0f;
      const float ssa_gas = has_tau ? (has_tau ? tau_ray : 1.0f) / (has_tau ? tau_gas : 1.0f)
                                    : 0.0f;
      float tau = tau_gas, ssa = ssa_gas, asy = 0.0f;
      if constexpr (kCloudy) {
        // band values of the delta-scaled cloud tau, tau*ssa, tau*ssa*g
        float tc, tsc, tgc;
        if constexpr (kMode == rte::kCldLut) {
          float lt, lts, ltsg, it, its, itsg;
          rte::cloud_lut_phase(c.liq, c.n_liq, c.nband, band, c.liq_off, c.liq_step,
                               s_cld[l], s_cld[2 * nlay + l], lt, lts, ltsg);
          rte::cloud_lut_phase(c.ice, c.n_ice, c.nband, band, c.ice_off, c.ice_step,
                               s_cld[nlay + l], s_cld[3 * nlay + l], it, its, itsg);
          // phase sum, then delta scaling with f = g^2 in subtraction form:
          // with u = (tau*ssa*g)^2 / (tau*ssa) all three products lose u
          const float tau_b = lt + it, taussa = lts + its, tsg = ltsg + itsg;
          const float u = tsg * rte::div_or_zero(tsg, fmaxf(a.cld_eps, taussa));
          tc = tau_b - u;
          tsc = taussa - u;
          tgc = tsg - u;
        } else {
          const size_t ib = ((size_t)l * ncol + col) * a.nband + band;
          tc = a.cld_tau[ib];
          tsc = a.cld_ts[ib];
          tgc = a.cld_tsg[ib];
        }
        // increment the gas properties (asymmetry 0) by the cloud's
        tau = tau_gas + tc;
        const float tauscat = tau_gas * ssa_gas + tsc;
        asy = rte::div_or_zero(tgc, fmaxf(a.cld_eps, tauscat));
        ssa = rte::div_or_zero(tauscat, fmaxf(a.cld_eps, tau));
      }
      // Zdunkowski PIFM (without clouds g = 0: gamma3 = gamma4 = 1/2),
      // evaluated in double: rdir and tdir are 0/0 forms at the resonance
      // k*mu0 = 1, and in float32 a column whose mu0 sits within ~1e-4 of
      // 1/k in every layer (ssa constant down the column) is off by up to
      // ~10 W/m2. This departs from the Pallas kernel, which is float32
      // throughout. A form that keeps double only where |1 - (k*mu0)^2| < t
      // was measured (scripts/probe_sw_float64_guard.py): up to t = 0.1 it
      // is beyond the SW bound from float64 (2.8e-2 W/m2 at 0.1); t = 0.3 is
      // within it at 1.2e-2, about thirty times this form's distance, with
      // 16% of the cells, so a lane of nearly every warp, still in double.
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
      const double tnoscat = exp(-tau_d * mu0_inv_d);
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
      const double rt2 = ssa_d * (rt_term / denom);
      double rdir = rt2 * ((1.0 - k_mu) * (alpha2 + k_g3)
                           - (1.0 + k_mu) * (alpha2 - k_g3) * e2
                           - k2e * (gamma3 - alpha2 * mu0_d) * tnoscat);
      double tdir = rt2 * (k2e * (gamma4 + alpha1 * mu0_d)
                           - tnoscat * ((1.0 + k_mu) * (alpha1 + k_g4)
                                        - (1.0 - k_mu) * (alpha1 - k_g4) * e2));
      rdir = fmin(fmax(rdir, 0.0), 1.0 - tnoscat);
      tdir = fmin(fmax(tdir, 0.0), 1.0 - tnoscat - rdir);
      s_rdif[i] = rdif;
      s_tdif[i] = tdif;
      s_a[i] = (float)rdir;
      s_b[i] = (float)tdir;
      s_c[i] = tau * mu0_inv;
    }
  }
  __syncthreads();

  // The sweeps are recurrences down the column, one thread per g-point (four
  // warps). Each walks the column kChunk layers at a time in straight-line
  // code: all of a chunk's operands are loaded first, then its steps run in
  // registers and store, so that loads, address arithmetic, the exponentials
  // and the stores of neighbouring steps can overlap; the layers left over
  // take single steps.
  constexpr int kChunk = 4;
  const int sg = threadIdx.x;  // this thread's g-point in the sweeps
  const bool sweeper = sg < ngpt;

  // ---- phase B: direct beam, exp(-cumulative optical path) ---------------
  // The path down to each level is a running sum, one thread per g-point;
  // the exponentials and the sources that hang on it are not a recurrence:
  // every group takes them for its own layers.
  if (sweeper) {
    float path = 0.0f;
    float* pc = s_c + sg;
    int l = 0;
#pragma unroll 1
    for (; l + kChunk <= nlay; l += kChunk, pc += kChunk * ngpt) {
      float t[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) t[j] = pc[j * ngpt];
      float q[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        q[j] = path;
        path += t[j];
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) pc[j * ngpt] = q[j];
    }
    for (; l < nlay; ++l, pc += ngpt) {
      const float t = pc[0];
      pc[0] = path;
      path += t;
    }
    pc[0] = path;  // row nlay: the path to the surface
  }
  __syncthreads();
  if (active) {
    const float inc = a.inc_dir[(size_t)col * ngpt + g];
#pragma unroll 4
    for (int l = lbeg; l < lend; ++l) {
      const int i = l * ngpt + g;
      const float dinc = inc * expf(-s_c[i]);
      s_c[i] = dinc;
      s_a[i] *= dinc;  // rdir -> src_up
      s_b[i] *= dinc;  // tdir -> src_dn
    }
    if (group == ngroups - 1) s_c[nf + g] = inc * expf(-s_c[nf + g]);  // the flux at the surface
  }
  __syncthreads();
  rte::level_sums(s_c, nlay + 1, ngpt, 1.0f, nullptr, s_dir);
  __syncthreads();

  if (sweeper) {
    // ---- phase C: surface-to-top cumulative albedo and source ------------
    const size_t cg = (size_t)col * ngpt + sg;
    float alb = a.alb_dif[cg];
    float src = s_c[nf + sg] * a.alb_dir[cg];
    const float fdn_top = a.inc_dif[cg];
    {
      const int top = (nlay - 1) * ngpt + sg;
      float *prd = s_rdif + top, *ptd = s_tdif + top, *pa = s_a + top, *pb = s_b + top,
            *pc = s_c + top;
      auto step = [&](float rd, float td, float su, float sd, int o) {
        const float d = 1.0f / fmaf(-rd, alb, 1.0f);
        const float src_new = su + td * d * (src + alb * sd);
        const float alb_new = rd + td * td * alb * d;
        pc[o] = alb;
        pa[o] = src;
        alb = alb_new;
        src = src_new;
      };
      int l = nlay;
#pragma unroll 1
      for (; l >= kChunk; l -= kChunk, prd -= kChunk * ngpt, ptd -= kChunk * ngpt,
                          pa -= kChunk * ngpt, pb -= kChunk * ngpt, pc -= kChunk * ngpt) {
        float rd[kChunk], td[kChunk], su[kChunk], sd[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          rd[j] = prd[-j * ngpt]; td[j] = ptd[-j * ngpt]; su[j] = pa[-j * ngpt]; sd[j] = pb[-j * ngpt];
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) step(rd[j], td[j], su[j], sd[j], -j * ngpt);
      }
      for (; l > 0; --l, prd -= ngpt, ptd -= ngpt, pa -= ngpt, pb -= ngpt, pc -= ngpt)
        step(prd[0], ptd[0], pa[0], pb[0], 0);
    }
    // ---- phase D: top-down diffuse flux sweep ------------------------------
    // the adding denominator again, from the operands phase C had
    float fdn = fdn_top;
    s_top[sg] = fdn;
    s_top[ngpt + sg] = fdn * alb + src;
    float *prd = s_rdif + sg, *ptd = s_tdif + sg, *pa = s_a + sg, *pb = s_b + sg, *pc = s_c + sg;
    auto step = [&](float rd, float td, float below, float sb, float sd, int o) {
      const float d = 1.0f / fmaf(-rd, below, 1.0f);
      fdn = (td * fdn + rd * sb + sd) * d;
      pb[o] = fdn;
      pc[o] = fdn * below + sb;
    };
    int l = 0;
#pragma unroll 1
    for (; l + kChunk <= nlay; l += kChunk, prd += kChunk * ngpt, ptd += kChunk * ngpt,
                               pa += kChunk * ngpt, pb += kChunk * ngpt, pc += kChunk * ngpt) {
      float rd[kChunk], td[kChunk], below[kChunk], sb[kChunk], sd[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        rd[j] = prd[j * ngpt]; td[j] = ptd[j * ngpt]; below[j] = pc[j * ngpt];
        sb[j] = pa[j * ngpt]; sd[j] = pb[j * ngpt];
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) step(rd[j], td[j], below[j], sb[j], sd[j], j * ngpt);
    }
    for (; l < nlay; ++l, prd += ngpt, ptd += ngpt, pa += ngpt, pb += ngpt, pc += ngpt)
      step(prd[0], ptd[0], pc[0], pa[0], pb[0], 0);
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

template <int kMode>
static int launch_mode(const SwArgs& a, const Mlp3& ma, const Mlp3& mr, const rte::MegaPlan& plan,
                       const rte::CloudLutOf<kMode>& c, const rte::LaneListOf<kMode>& lanes,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sw_mega_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  sw_mega_kernel<kMode><<<a.ncol, plan.threads, plan.smem_bytes, stream>>>(
      a, ma, mr, plan.layers_per_group, c, lanes);
  return (int)cudaGetLastError();
}

// mode: rte::MegaMode. The cloud modes read gpt2band and nband; kCldLut reads
// lwp/iwp/rel/rei and ``cloud``; kCldBands reads cld_tau/cld_ts/cld_tsg;
// kLanes reads ``lanes`` (the n2d scaled features, one array each) and
// ignores x. ``plan`` is launch_plan's geometry (ops/cuda/sw_megakernel.py),
// refused unless it is one this file is compiled for and its shared memory
// is what the kernel lays out. The structs are read on the host; pointers
// the mode does not read may be null.
extern "C" int sw_clearsky_megakernel_launch(
    const SwArgs* args, const rte::Mlp3* abs_net, const rte::Mlp3* ray_net,
    const rte::MegaPlan* plan, const rte::CloudLut* cloud, const rte::LaneList* lanes,
    int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SwArgs& a = *args;
  const Mlp3& ma = *abs_net;
  const Mlp3& mr = *ray_net;
  const rte::MegaPlan& pl = *plan;
  if (a.ncol <= 0 || a.nlay <= 0 || ma.nout != a.ngpt || mr.nout != a.ngpt)
    return (int)cudaErrorInvalidValue;
  if (pl.groups < 1 || pl.groups > rte::kMaxGroups) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(pl.groups, a.nlay, a.n2d, ma.h1, ma.h2, mr.h1, mr.h2, a.ngpt);
  if (pl.slab_floats != 0 || !rte::plan_geometry_ok(pl, a.nlay, a.ngpt, smem))
    return (int)cudaErrorInvalidValue;
  const rte::Unused none{};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case rte::kClear: return launch_mode<rte::kClear>(a, ma, mr, pl, none, none, st);
    case rte::kCldLut:
      if (cloud == nullptr || cloud->n_liq < 2 || cloud->n_ice < 2)
        return (int)cudaErrorInvalidValue;
      return launch_mode<rte::kCldLut>(a, ma, mr, pl, *cloud, none, st);
    case rte::kCldBands: return launch_mode<rte::kCldBands>(a, ma, mr, pl, none, none, st);
    case rte::kLanes:
      if (lanes == nullptr || a.n2d > rte::kMaxLanes) return (int)cudaErrorInvalidValue;
      return launch_mode<rte::kLanes>(a, ma, mr, pl, none, *lanes, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int kMode>
static int resident_blocks(const rte::MegaPlan& plan, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(sw_mega_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sw_mega_kernel<kMode>, plan.threads, plan.smem_bytes);
}

// *blocks: how many blocks of the kernel in ``mode`` the device keeps resident
// on one SM at the plan's threads and shared memory, as the runtime reckons it
// from the compiled function's registers.
extern "C" int sw_clearsky_megakernel_blocks_per_sm(const rte::MegaPlan* plan, int mode, int device,
                                                    int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (mode) {
    case rte::kClear: return resident_blocks<rte::kClear>(*plan, blocks);
    case rte::kCldLut: return resident_blocks<rte::kCldLut>(*plan, blocks);
    case rte::kCldBands: return resident_blocks<rte::kCldBands>(*plan, blocks);
    case rte::kLanes: return resident_blocks<rte::kLanes>(*plan, blocks);
  }
  return (int)cudaErrorInvalidValue;
}
