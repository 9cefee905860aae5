// K11: the broadband shortwave two-stream + adding solve of general optical
// properties (tau, ssa, g), one column per block, one thread a g-point: the
// PIFM coefficients in double, each rounded once to float as
// ops/sw_solver.pifm_coefficients rounds them; the direct beam exp(-sum of
// tau / mu0) down the column; the surface-to-top sweep of albedo and source;
// the top-to-surface flux sweep; the spectral sums at every level. The twin,
// which CPU tensors take, is ops/sw_solver.sw_2stream_broadband. Reference
// parity: mo_rte_solver_kernels.F90 sw_solver_2stream (:541-692),
// sw_two_stream_source (:1364-1480), adding (:1526-1637).
//
// What bounds it: the layer recurrences, which are sequential in each
// (column, g-point). The per-layer coefficients and sources of the downward
// pass are kept for the two sweeps in a scratch field (rdif, tdif, the
// direct-beam sources, then the albedo and source below each layer) that a
// block reads back in its own g-point's addresses; each level's spectral
// sums are one block reduction.
#include <cuda_runtime.h>

struct Sw2StreamArgs {
  const float* tau;      // (ncol, nlay, ngpt)
  const float* ssa;      // (ncol, nlay, ngpt)
  const float* g;        // (ncol, nlay, ngpt)
  const float* mu0;      // (ncol)
  const float* inc_flux; // (ncol, ngpt) TOA direct flux before the mu0 weighting
  const float* alb_dir;  // (ncol, ngpt)
  const float* alb_dif;  // (ncol, ngpt)
  const float* inc_dif;  // (ncol, ngpt) or null (0)
  float* scratch;        // (ncol, 5, nlay, ngpt)
  float* up;             // (ncol, nlay+1) broadband
  float* dn;             // (ncol, nlay+1) broadband, diffuse + direct
  float* dir;            // (ncol, nlay+1) broadband direct
  int ncol, nlay, ngpt, top_at_1;
  double k_min;          // floor on the eigenvalue k (config.k_min)
  double eps;            // the resonance guard: float64's eps
};

namespace {

constexpr int kMaxWarps = 32;

// Sum of v over the block; the total reaches thread 0 only. Two barriers,
// so the shared words may be reused at once.
__device__ __forceinline__ float block_sum(float v, float* s_warp) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += s_warp[w];
  __syncthreads();
  return total;
}

struct Coeffs {
  float rdif, tdif, rdir, tdir;
};

// ops/sw_solver.sw_two_stream_coeffs in double, rounded once to float.
__device__ __forceinline__ Coeffs pifm(double tau, double ssa, double g, double mu0,
                                       double k_min, double eps) {
  const double mu0_inv = 1.0 / mu0;
  const double gamma1 = (8.0 - ssa * (5.0 + 3.0 * g)) * 0.25;
  const double gamma2 = 3.0 * (ssa * (1.0 - g)) * 0.25;
  const double k = sqrt(fmax((gamma1 - gamma2) * (gamma1 + gamma2), k_min));
  const double gamma3 = (2.0 - 3.0 * mu0 * g) * 0.25;
  const double gamma4 = 1.0 - gamma3;
  const double alpha1 = gamma1 * gamma4 + gamma2 * gamma3;
  const double alpha2 = gamma1 * gamma3 + gamma2 * gamma4;
  const double tnoscat = exp(-tau * mu0_inv);
  const double e1 = exp(-tau * k);
  const double e2 = e1 * e1;
  const double k2e = 2.0 * k * e1;
  const double rt_term = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2));
  const double k_mu = k * mu0;
  const double k_g3 = k * gamma3, k_g4 = k * gamma4;
  const double one_m = 1.0 - k_mu * k_mu;
  const double rt2 = ssa * rt_term / (fabs(one_m) >= eps ? one_m : eps);
  double rdir = rt2 * ((1.0 - k_mu) * (alpha2 + k_g3) - (1.0 + k_mu) * (alpha2 - k_g3) * e2 -
                       k2e * (gamma3 - alpha2 * mu0) * tnoscat);
  double tdir = rt2 * (k2e * (gamma4 + alpha1 * mu0) -
                       tnoscat * ((1.0 + k_mu) * (alpha1 + k_g4) -
                                  (1.0 - k_mu) * (alpha1 - k_g4) * e2));
  rdir = fmin(fmax(rdir, 0.0), 1.0 - tnoscat);
  tdir = fmin(fmax(tdir, 0.0), 1.0 - tnoscat - rdir);
  Coeffs c;
  c.rdif = (float)(rt_term * gamma2 * (1.0 - e2));
  c.tdif = (float)(rt_term * k2e);
  c.rdir = (float)rdir;
  c.tdir = (float)tdir;
  return c;
}

__global__ void __launch_bounds__(1024) sw_2stream_kernel(Sw2StreamArgs a) {
  __shared__ float s_warp[kMaxWarps];
  const int col = blockIdx.x, g = threadIdx.x, nlay = a.nlay, ngpt = a.ngpt;
  const bool on = g < ngpt;
  const int gg = on ? g : 0;
  const size_t cg = (size_t)col * ngpt + gg;
  const size_t plane = (size_t)nlay * ngpt;
  float* rdif_s = a.scratch + (size_t)col * 5 * plane + gg;  // then the albedo below
  float* tdif_s = rdif_s + plane;
  float* sup_s = tdif_s + plane;   // the direct-beam source up; then the source below
  float* sdn_s = sup_s + plane;
  float* alb_s = sdn_s + plane;
  float* up = a.up + (size_t)col * (nlay + 1);
  float* dn = a.dn + (size_t)col * (nlay + 1);
  float* dir_bb = a.dir + (size_t)col * (nlay + 1);
  // output level of canonical (top-at-0) level k; input layer of layer l
  auto lev = [&](int k) { return a.top_at_1 ? k : nlay - k; };
  auto lay = [&](int l) { return a.top_at_1 ? l : nlay - 1 - l; };

  const float mu0 = a.mu0[col];
  const float mu0_inv = 1.0f / mu0;
  const float top = on ? a.inc_flux[cg] * mu0 : 0.0f;
  // downward: direct beam, coefficients and direct-beam sources
  float beam = top, depth = 0.0f;
  float s = block_sum(beam, s_warp);
  if (threadIdx.x == 0) dir_bb[lev(0)] = s;
  for (int l = 0; l < nlay; ++l) {
    float next = 0.0f;
    if (on) {
      const size_t i = ((size_t)col * nlay + lay(l)) * ngpt + g;
      const float t = a.tau[i];
      const Coeffs c = pifm(t, a.ssa[i], a.g[i], mu0, a.k_min, a.eps);
      depth += t * mu0_inv;
      next = top * expf(-depth);
      const size_t o = (size_t)l * ngpt;
      rdif_s[o] = c.rdif;
      tdif_s[o] = c.tdif;
      sup_s[o] = c.rdir * beam;
      sdn_s[o] = c.tdir * beam;
    }
    beam = next;
    s = block_sum(beam, s_warp);
    if (threadIdx.x == 0) dir_bb[lev(l + 1)] = s;
  }
  // surface to top: the albedo and source of the stack below each level
  float alb = on ? a.alb_dif[cg] : 0.0f;
  float src = on ? beam * a.alb_dir[cg] : 0.0f;
  if (on) {
    for (int l = nlay - 1; l >= 0; --l) {
      const size_t o = (size_t)l * ngpt;
      const float r = rdif_s[o], t = tdif_s[o], su = sup_s[o], sd = sdn_s[o];
      alb_s[o] = alb;
      sup_s[o] = src;
      const float d = 1.0f / (1.0f - r * alb);
      const float alb_new = r + t * t * alb * d;
      src = su + t * d * (src + alb * sd);
      alb = alb_new;
    }
  }
  // top to surface: the fluxes and their spectral sums
  float fdn = on && a.inc_dif != nullptr ? a.inc_dif[cg] : 0.0f;
  const float s_dn = block_sum(fdn, s_warp);
  const float s_up = block_sum(on ? fdn * alb + src : 0.0f, s_warp);
  if (threadIdx.x == 0) {
    dn[lev(0)] = s_dn + dir_bb[lev(0)];
    up[lev(0)] = s_up;
  }
  for (int l = 0; l < nlay; ++l) {
    float fup = 0.0f;
    if (on) {
      const size_t o = (size_t)l * ngpt;
      const float r = rdif_s[o], alb_b = alb_s[o], src_b = sup_s[o];
      const float d = 1.0f / (1.0f - r * alb_b);
      fdn = (tdif_s[o] * fdn + r * src_b + sdn_s[o]) * d;
      fup = fdn * alb_b + src_b;
    }
    const float sd = block_sum(on ? fdn : 0.0f, s_warp);
    const float su = block_sum(fup, s_warp);
    if (threadIdx.x == 0) {
      dn[lev(l + 1)] = sd + dir_bb[lev(l + 1)];
      up[lev(l + 1)] = su;
    }
  }
}

}  // namespace

// Launch K11 on ``stream``, one block a column. Returns a cudaError_t.
extern "C" int sw_2stream_launch(const Sw2StreamArgs* args, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Sw2StreamArgs& a = *args;
  if (a.ncol <= 0 || a.nlay <= 0 || a.ngpt <= 0 || a.ngpt > 32 * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const int threads = ((a.ngpt + 31) / 32) * 32;
  sw_2stream_kernel<<<a.ncol, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
