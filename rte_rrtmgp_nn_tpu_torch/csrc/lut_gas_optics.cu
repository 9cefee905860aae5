// K10: the lookup-table gas optics of one (column, layer) row per block, in
// one launch: the interpolation state (temperature, pressure, and the eta of
// each flavor's key-species pair), the major absorbers' trilinear
// interpolation, the minor absorbers of the row's atmosphere scaled by
// density or complement, and, by mode, the Planck fraction (LW) or the
// Rayleigh optical depth with the total tau and the single-scattering albedo
// (SW). Reference parity: mo_gas_optics_kernels.F90 interpolation (:47-144),
// gas_optical_depths_major / _minor (:150-462), compute_tau_rayleigh
// (:469-511), the Planck fraction of compute_Planck_source (:514-611) and
// combine_2str (:1170-1272), as ops/gas_optics_lut.py states them in tensor
// ops (the twin, which CPU tensors take).
//
// What bounds it: gathers. Each element reads 8 corners of kmajor (and 8 of
// the Planck-fraction table or 4 of krayl, 4 a minor), all from tables of
// a few MB that stay in L2; one thread a g-point keeps the corners of a warp
// in neighbouring addresses. The row's scalars (indices, weights, the minor
// scalings) are formed once a thread, in float32, in the twin's order.
#include <cuda_runtime.h>

struct LutArgs {
  const float* play;      // (ncol, nlay) Pa
  const float* tlay;      // (ncol, nlay) K
  const float* col_gas;   // (ncol, nlay, ncg): dry air, then the gases
  const float* kmajor;    // (ntemp, npres+1, neta, ngpt)
  const float* ktab;      // LW: pfracin like kmajor; SW: krayl (2, ntemp, neta, ngpt)
  const float* vmr_ref;   // (2, ncg, ntemp)
  const float* temp_ref;  // (ntemp)
  const int* flavor;      // (nflav, 2) col_gas indices of the key-species pair
  const int* gflav;       // (ngpt, 2) flavor of a g-point: lower, upper atmosphere
  const float* kminor_lo; // (ntemp, neta, ncontrib_lo)
  const float* kminor_up; // (ntemp, neta, ncontrib_up)
  // (nminor, kMinorCols): upper (0 lower, 1 upper), gpt_s, gpt_e, kminor_start,
  // flavor, idx_minor, idx_minor_scaling (-1 none), flags (1 density,
  // 2 complement); the lower intervals first, each atmosphere in its order
  const int* minor;
  float* tau;             // (ncol, nlay, ngpt)
  float* out2;            // LW: pfrac; SW: ssa; (ncol, nlay, ngpt)
  int nrow, ngpt, ncg, ntemp, npres, neta, nminor, ncontrib_lo, ncontrib_up, idx_h2o;
  float t_shift;          // temp_ref_min - temp_ref_delta
  float t_delta;          // temp_ref_delta
  float p_log0;           // log(press_ref[0])
  float p_log_delta;      // press_ref_log_delta (negative)
  float p_trop_log;       // log(press_ref_trop)
  float mix_min;          // 2 * float32 tiny
};

namespace {

constexpr int kModeLw = 0;  // outputs tau, pfrac
constexpr int kModeSw = 1;  // outputs tau (absorption + Rayleigh), ssa
constexpr int kMinorCols = 8;  // ints a minor interval: see LutArgs::minor

struct Eta {
  int j;
  float f, mix;
};

// The eta index, weight and column mix of flavor ``flav`` at the row's
// temperature level jt (interpolation, :112-140).
__device__ __forceinline__ Eta eta_of(const LutArgs& a, const float* cg, int flav, int itropo,
                                      int jt) {
  const int i0 = a.flavor[2 * flav], i1 = a.flavor[2 * flav + 1];
  const float* v = a.vmr_ref + itropo * a.ncg * a.ntemp;
  const float ratio = v[i0 * a.ntemp + jt] / v[i1 * a.ntemp + jt];
  const float g1 = cg[i0];
  Eta e;
  e.mix = __fadd_rn(g1, __fmul_rn(ratio, cg[i1]));
  const float eta = e.mix > a.mix_min ? g1 / e.mix : 0.5f;
  const float loc = __fmul_rn(eta, (float)(a.neta - 1));
  e.j = min(max((int)loc, 0), a.neta - 2);
  e.f = __fsub_rn(loc, (float)e.j);
  return e;
}

template <int kMode>
__global__ void __launch_bounds__(256) lut_gas_optics_kernel(LutArgs a) {
  const int row = blockIdx.x;
  if (row >= a.nrow) return;
  const float* cg = a.col_gas + (size_t)row * a.ncg;
  const float tl = a.tlay[row], pl = a.play[row];
  // the row's temperature and pressure indices and weights
  const int jtemp =
      min(max((int)(__fsub_rn(tl, a.t_shift) / a.t_delta) - 1, 0), a.ntemp - 2);
  const float ftemp = __fsub_rn(tl, a.temp_ref[jtemp]) / a.t_delta;
  const float plog = logf(pl);
  const float locp = __fsub_rn(plog, a.p_log0) / a.p_log_delta;
  const int jpress = min(max((int)locp, 0), a.npres - 2);
  const float fpress = __fsub_rn(locp, (float)jpress);
  const bool tropo = plog > a.p_trop_log;
  const int itropo = tropo ? 0 : 1;
  const float ft[2] = {1.0f - ftemp, ftemp};
  const float fp[2] = {1.0f - fpress, fpress};
  // the minors' per-row factors
  const float vmr_fact = 1.0f / cg[0];
  const float dry_fact = 1.0f / (1.0f + __fmul_rn(cg[a.idx_h2o], vmr_fact));
  const float dens = __fmul_rn(0.01f, pl) / tl;

  for (int g = threadIdx.x; g < a.ngpt; g += blockDim.x) {
    const int flav = a.gflav[2 * g + itropo];
    Eta e[2];
    e[0] = eta_of(a, cg, flav, itropo, jtemp);
    e[1] = eta_of(a, cg, flav, itropo, jtemp + 1);
    float tau = 0.0f, frac = 0.0f;
    for (int dt = 0; dt < 2; ++dt) {
      const int jt = jtemp + dt;
      for (int dp = 0; dp < 2; ++dp) {
        const size_t base =
            ((size_t)(jt * (a.npres + 1) + jpress + itropo + dp) * a.neta + e[dt].j) * a.ngpt + g;
        for (int de = 0; de < 2; ++de) {
          const float we = de ? e[dt].f : 1.0f - e[dt].f;
          const float kval = a.kmajor[base + (size_t)de * a.ngpt];
          tau = __fadd_rn(tau, __fmul_rn(
              __fmul_rn(__fmul_rn(__fmul_rn(e[dt].mix, ft[dt]), fp[dp]), we), kval));
          if (kMode == kModeLw) {
            const float pval = a.ktab[base + (size_t)de * a.ngpt];
            frac = __fadd_rn(frac, __fmul_rn(__fmul_rn(__fmul_rn(ft[dt], fp[dp]), we), pval));
          }
        }
      }
    }
    for (int m = 0; m < a.nminor; ++m) {
      const int* mi = a.minor + kMinorCols * m;
      if (mi[0] != itropo || g < mi[1] || g >= mi[2]) continue;
      float scaling = cg[mi[5]];
      if (mi[7] & 1) {
        scaling = __fmul_rn(scaling, dens);
        if (mi[6] > 0) {
          const float f = __fmul_rn(__fmul_rn(cg[mi[6]], vmr_fact), dry_fact);
          scaling = __fmul_rn(scaling, (mi[7] & 2) ? 1.0f - f : f);
        }
      }
      const float* km = itropo ? a.kminor_up : a.kminor_lo;
      const int nc = itropo ? a.ncontrib_up : a.ncontrib_lo;
      const int col = mi[3] + g - mi[1];
      float contrib = 0.0f;
      for (int dt = 0; dt < 2; ++dt) {
        const Eta em = eta_of(a, cg, mi[4], itropo, jtemp + dt);
        for (int de = 0; de < 2; ++de) {
          const float we = de ? em.f : 1.0f - em.f;
          const float kval = km[(size_t)((jtemp + dt) * a.neta + em.j + de) * nc + col];
          contrib = __fadd_rn(contrib, __fmul_rn(__fmul_rn(we, ft[dt]), kval));
        }
      }
      tau = __fadd_rn(tau, __fmul_rn(scaling, contrib));
    }
    const size_t out = (size_t)row * a.ngpt + g;
    if (kMode == kModeLw) {
      a.tau[out] = tau;
      a.out2[out] = frac;
    } else {
      float k = 0.0f;
      for (int dt = 0; dt < 2; ++dt) {
        const size_t base = ((size_t)(itropo * a.ntemp + jtemp + dt) * a.neta + e[dt].j) * a.ngpt + g;
        for (int de = 0; de < 2; ++de) {
          const float we = de ? e[dt].f : 1.0f - e[dt].f;
          k = __fadd_rn(k, __fmul_rn(__fmul_rn(ft[dt], we), a.ktab[base + (size_t)de * a.ngpt]));
        }
      }
      const float ray = __fmul_rn(k, __fadd_rn(cg[a.idx_h2o], cg[0]));
      const float tot = __fadd_rn(tau, ray);
      a.tau[out] = tot;
      a.out2[out] = tot > 0.0f ? ray / tot : 0.0f;
    }
  }
}

}  // namespace

// Launch K10 on ``stream``: mode 0 LW (tau, Planck fraction), 1 SW (tau,
// ssa). Returns a cudaError_t.
extern "C" int lut_gas_optics_launch(const LutArgs* args, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const LutArgs& a = *args;
  if (a.nrow <= 0 || a.ngpt <= 0 || a.neta < 2 || a.ntemp < 2 || a.npres < 2 ||
      (mode != kModeLw && mode != kModeSw))
    return (int)cudaErrorInvalidValue;
  const int threads = a.ngpt >= 256 ? 256 : ((a.ngpt + 31) / 32) * 32;
  if (mode == kModeLw)
    lut_gas_optics_kernel<kModeLw><<<a.nrow, threads, 0, (cudaStream_t)stream>>>(a);
  else
    lut_gas_optics_kernel<kModeSw><<<a.nrow, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
