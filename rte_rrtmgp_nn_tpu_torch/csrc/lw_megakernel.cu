// Fused LW pipeline for one column per thread block: NN gas optics
// (3-layer softsign "both" net -> tau, Planck fraction), optional cloud
// absorption, Planck sources with the totplnk interpolation in the kernel,
// and the no-scattering broadband transport (down sweep, surface, up sweep).
//
// Replaces rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py::lw_clearsky_mega4
// (_mega4_kernel, with its cld_fields + cld_lut and cld_tau_band options)
// and ::lw_clearsky_mega5 (_mega5_kernel, raw input lanes; its mxu_first
// variant is the same arithmetic). Same physics: predict_nn_lw +
// compute_planck_source_nn + lw_solver_noscat broadband, single diffusivity
// angle, zero incident flux (reference mo_gas_optics_kernels.F90:615-683,
// 690-862; mo_rte_solver_kernels.F90:119-330); clouds as cloud_optics
// (mo_cloud_optics.F90 compute_all_from_table, 1scl branch) + increment
// (increment_1scalar_by_1scalar_bybnd).
//
// One kernel, four modes (rte::MegaMode, a template parameter): clear-sky;
// clouds from (lwp, iwp, rel, rei) through the lookup tables here; clouds
// as band lanes of absorption tau; clear-sky on raw input lanes, one array
// per feature, transformed and scaled while the feature rows are filled.
// A thread owns one g-point and knows its band, so the band -> g-point
// expansion of the cloud tau is an index. The cloud modes add a few scalar
// loads per layer and nothing to shared memory.
//
// What bounds it on an H100, and what the design does about it. The MLP:
// about 51k FMAs per (layer, column) with the 18->128->128->256 net, 5.6
// GFMA at 1800 x 60, every one needing a weight and an activation in a
// register. The inputs and outputs are a few floats per (layer, column), so
// device memory is idle; what bound the first version was load instructions
// (one weight load and four scalar shared-memory loads for four FMAs) and, at
// two blocks of four warps per SM, their latency. This version runs the
// tiled MLP of common.cuh: the rows of a pass are k-major in shared memory,
// so a thread reads eight rows of one k as two float4s that its whole warp
// shares; it takes two neighbouring output columns of a hidden layer as one
// float2 weight load (16 FMAs for 3 loads) and four of the last layer as
// one float4 (32 FMAs for 3 loads). A block is up to four layer groups of
// 128 threads, each taking a contiguous quarter of the layers with scratch
// of its own: 16 warps per SM, one block (fields 92.7 KB, 4 x 21.9 KB of
// scratch and 2 x 24 KB of weight slabs at 60 x 128). The weights (206 KB)
// do not fit what that leaves of L1, so the block copies them once per pass
// through two shared-memory slabs with cp.async while all groups compute
// (common.cuh, "weights through shared memory"); read through the cache
// instead, the same tiles were slower (PERF.md). What is left is issue: a
// warp issues an instruction every four to five clocks whatever the code
// offers, so the time is instructions per warp over warps in flight; larger
// register tiles load fewer words but leave warps idle, and lost.
// The per-layer fields (transmittance, both sources: 3 x nlay x ngpt floats)
// live in shared memory, so tau, pfrac and the g-point sources never reach
// device memory. The net leaves (ystd*y + ymean)**8 and the Planck fraction
// in two of the fields; a second loop over the group's real layers, one
// thread per g-point, turns them into transmittance and sources in place (no
// padded row is computed), with the column's col_dry, temperatures and cloud
// fields waiting in shared memory, read once.
// A layer's down source needs the level-top source of the layer below,
// lev_b(l) = lev_t(l+1): inside a group it is carried in a register down the
// walk; across a group boundary the group above computes the same rounded
// product from the same two operands (the fraction the group below left in
// shared memory, read before anything is overwritten), so the value is bit
// for bit the one the group below uses as its lev_t. The two sweeps are
// per-thread recurrences (four warps), four layers at a time in
// straight-line code; the per-level spectral sums are taken once after the
// sweeps, by every warp, one warp per level. Times, registers, the phases'
// shares and the alternatives measured on an H100: PERF.md.
#include "common.cuh"

using rte::kGroup;
using rte::kRowStride;
using rte::Mlp3;
using rte::PlanckTab;

// The launch entry's first argument; ops/cuda/build.py mirrors it field by
// field.
struct LwArgs {
  const float* x;        // (nlay, ncol, n2d) scaled layer-varying features
  const float* cf;       // (ncol, nc) scaled per-column constant features
  const float* col_dry;  // (nlay, ncol)
  const float* tlay;     // (nlay, ncol) [K]; kLanes: lane 0
  const float* tlev;     // (nlay+1, ncol) [K]
  const float* tsfc;     // (ncol) [K]
  const float* emis;     // (ncol, ngpt)
  const int* gpt2band;   // (ngpt)
  float* up;             // (ncol, nlay+1)
  float* dn;             // (ncol, nlay+1)
  int ncol, nlay, n2d, nc, ngpt;
  float d_secant, two_pi_w, tau_thresh;
  // kCldLut: water paths and effective radii, each (nlay, ncol)
  const float* lwp;
  const float* iwp;
  const float* rel;
  const float* rei;
  const float* cld_band;  // kCldBands: (nlay, ncol, nband) cloud absorption tau
  const float* scale;     // kLanes: (2, n2d) [min; 1 / (max - min)] of the raw lanes
};

namespace {

// Floats of one layer group's MLP scratch: the feature rows and the two
// hidden layers, k-major.
__host__ __device__ inline int group_floats(int n2d, int h1, int h2) {
  return kRowStride * (n2d + h1 + h2);
}

// Floats of the column's per-layer scalars kept in shared memory: col_dry,
// the layer and level temperatures and room for the four cloud fields.
__host__ __device__ inline int column_floats(int nlay) { return 7 * nlay + 1; }

// Dynamic shared memory of one block; ops/cuda/lw_megakernel.py launch_plan
// computes the same number.
size_t smem_bytes(int groups, int slab_floats, int nlay, int n2d, int h1, int h2, int ngpt) {
  return sizeof(float) * ((size_t)groups * group_floats(n2d, h1, h2) + rte::align4(h1) +
                          2 * (size_t)slab_floats + rte::align4(column_floats(nlay)) +
                          (size_t)3 * nlay * ngpt + ngpt);
}

// One block per SM (the plan's shared memory allows no second one at the
// sizes the drivers use): up to 512 threads at up to 128 registers.
template <int kMode>
__global__ void __launch_bounds__(rte::kMaxGroups * kGroup, 1)
lw_mega_kernel(const LwArgs a, const Mlp3 m, const PlanckTab p, const int layers_per_group,
               const int slab_floats, const rte::CloudLutOf<kMode> c,
               const rte::LaneListOf<kMode> lanes) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int col = blockIdx.x;
  const int group = threadIdx.x / kGroup, gtid = threadIdx.x - group * kGroup;
  const int ngroups = blockDim.x / kGroup;
  const int g = gtid;
  const int nlay = a.nlay, ncol = a.ncol, ngpt = a.ngpt;
  const int gfl = group_floats(a.n2d, m.h1, m.h2);
  float* s_x = smem + group * gfl;              // (n2d, kRowStride), this group's
  float* s_h1 = s_x + kRowStride * a.n2d;       // (h1, kRowStride)
  float* s_h2 = s_h1 + kRowStride * m.h1;       // (h2, kRowStride)
  float* s_hc = smem + ngroups * gfl;           // (h1)
  float* s_slab = s_hc + rte::align4(m.h1);     // (2, slab_floats): the weights' two buffers
  float* s_cd = s_slab + 2 * slab_floats;       // (nlay) col_dry of this column
  float* s_tlay = s_cd + nlay;                  // (nlay)
  float* s_tlev = s_tlay + nlay;                // (nlay+1)
  float* s_cld = s_tlev + nlay + 1;             // (4, nlay): lwp, iwp, rel, rei (kCldLut)
  float* s_trans = s_cd + rte::align4(column_floats(nlay));  // (nlay, ngpt): (ystd*y + ymean)**8, then transmittance
  float* s_dn = s_trans + nlay * ngpt;          // (nlay, ngpt): Planck fraction, src_dn, then radiance at level l+1
  float* s_up = s_dn + nlay * ngpt;             // (nlay+1, ngpt): src_up (row nlay: the surface source), then radiance at level l

  // the weights' first slab starts on its way before anything else
  rte::WeightStream ws{s_slab, slab_floats, 0};
  rte::stream_issue(ws, 0, m.w1a, rte::first_slab_floats(ws, a.n2d, m.h1));

  rte::mlp_const_part(m, a.cf + (size_t)col * a.nc, a.nc, s_hc);
  // this column's per-layer scalars: read once here, coalesced over layers,
  // so that the per-layer loop below does not wait on device memory
  for (int l = threadIdx.x; l <= nlay; l += blockDim.x) {
    s_tlev[l] = a.tlev[(size_t)l * ncol + col];
    if (l < nlay) {
      const size_t lc = (size_t)l * ncol + col;
      s_cd[l] = a.col_dry[lc];
      s_tlay[l] = a.tlay[lc];
      if constexpr (kMode == rte::kCldLut) {
        s_cld[l] = a.lwp[lc];
        s_cld[nlay + l] = a.iwp[lc];
        s_cld[2 * nlay + l] = a.rel[lc];
        s_cld[3 * nlay + l] = a.rei[lc];
      }
    }
  }
  __syncthreads();

  const bool active = g < ngpt;
  const int band = active ? a.gpt2band[g] : 0;
  const int lbeg = min(group * layers_per_group, nlay);
  const int lend = min(lbeg + layers_per_group, nlay);

  // ---- phase A, first loop: the net, kMegaRows layers of each group a pass --
  // (y**8 of the tau columns into s_trans, the Planck fraction into s_dn)
  rte::lw_both_nets<kMode == rte::kLanes>(
      ws, m, s_hc, a.n2d, ngpt, lbeg, lend, layers_per_group, s_x, s_h1, s_h2, s_trans, s_dn,
      gtid, [&](int l0) {
        if constexpr (kMode == rte::kLanes)
          rte::load_rows_lanes_kmajor(lanes, a.scale, l0, lend, ncol, col, a.n2d, s_x, gtid);
        else
          rte::load_rows_kmajor(a.x, l0, lend, ncol, col, a.n2d, s_x, gtid);
      });
  __syncthreads();

  // The level-top source of the first layer of the group below, from the
  // Planck fraction that group left: read before any group overwrites its
  // fractions with sources.
  float lev_below = 0.0f;
  if (active && lbeg < lend && lend < nlay)
    lev_below = __fmul_rn(s_dn[lend * ngpt + g], rte::planck_interp(p, s_tlev[lend], band));
  __syncthreads();

  // ---- phase A, second loop: transmittance and sources, in place ----------
  if (active && lbeg < lend) {
    float pf = s_dn[lbeg * ngpt + g];
    float lev_t = __fmul_rn(pf, rte::planck_interp(p, s_tlev[lbeg], band));
    for (int l = lbeg; l < lend; ++l) {
      const int i = l * ngpt + g;
      const float y8 = s_trans[i];
      float tl;
      if constexpr (kMode == rte::kCldLut) {
        // absorption tau = tau - tau*ssa per phase, added before the
        // diffusivity factor
        float lt, lts, it, its, unused;
        rte::cloud_lut_phase(c.liq, c.n_liq, c.nband, band, c.liq_off, c.liq_step,
                             s_cld[l], s_cld[2 * nlay + l], lt, lts, unused);
        rte::cloud_lut_phase(c.ice, c.n_ice, c.nband, band, c.ice_off, c.ice_step,
                             s_cld[nlay + l], s_cld[3 * nlay + l], it, its, unused);
        tl = (y8 * s_cd[l] + ((lt - lts) + (it - its))) * a.d_secant;
      } else if constexpr (kMode == rte::kCldBands) {
        tl = (y8 * s_cd[l] + a.cld_band[((size_t)l * ncol + col) * p.nband + band]) * a.d_secant;
      } else if constexpr (kMode == rte::kLanes) {
        tl = y8 * (s_cd[l] * a.d_secant);  // the raw-lane kernel's grouping
      } else {
        tl = y8 * s_cd[l] * a.d_secant;
      }
      const float trans = rte::transmittance(tl);
      const float fact = tl > a.tau_thresh ? (1.0f - trans) / tl - trans
                                           : tl * (0.5f - (1.0f / 3.0f) * tl);
      const float lay = __fmul_rn(pf, rte::planck_interp(p, s_tlay[l], band));
      // the source at the level below: the next layer's level-top source;
      // the bottom layer takes its own Planck fraction at the bottom level
      float pf_next = pf, lev_b;
      if (l + 1 < lend) {
        pf_next = s_dn[i + ngpt];
        lev_b = __fmul_rn(pf_next, rte::planck_interp(p, s_tlev[l + 1], band));
      } else if (l + 1 < nlay) {
        lev_b = lev_below;
      } else {
        lev_b = __fmul_rn(pf, rte::planck_interp(p, s_tlev[l + 1], band));
        s_up[nlay * ngpt + g] = __fmul_rn(pf, rte::planck_interp(p, a.tsfc[col], band));
      }
      const float omt = 1.0f - trans, tf = 2.0f * fact;
      s_trans[i] = trans;
      s_up[i] = omt * lev_t + tf * (lay - lev_t);
      s_dn[i] = omt * lev_b + tf * (lay - lev_b);
      pf = pf_next;
      lev_t = lev_b;
    }
  }
  __syncthreads();

  // The sweeps are recurrences down and up the column, one thread per
  // g-point (four warps). Each walks the column kChunk layers at a time in
  // straight-line code: a chunk's operands are loaded first, then its steps
  // run in registers and store; the layers left over take single steps.
  constexpr int kChunk = 4;
  const int sg = threadIdx.x;  // this thread's g-point in the sweeps
  if (sg < ngpt) {
    // ---- phase B: top-down sweep (zero incident radiance) ----------------
    const float e = a.emis[(size_t)col * ngpt + sg];
    float rad = 0.0f;
    float *pt = s_trans + sg, *pd = s_dn + sg;
    int l = 0;
#pragma unroll 1
    for (; l + kChunk <= nlay; l += kChunk, pt += kChunk * ngpt, pd += kChunk * ngpt) {
      float tr[kChunk], sd[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) { tr[j] = pt[j * ngpt]; sd[j] = pd[j * ngpt]; }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        rad = tr[j] * rad + sd[j];
        pd[j * ngpt] = rad;
      }
    }
    for (; l < nlay; ++l, pt += ngpt, pd += ngpt) {
      rad = pt[0] * rad + pd[0];
      pd[0] = rad;
    }
    // ---- phase C: surface emission/reflection, bottom-up sweep -----------
    float* pu = s_up + nlay * ngpt + sg;  // row nlay: the surface source
    rad = rad * (1.0f - e) + e * pu[0];
    pu[0] = rad;
    pt -= ngpt;
    pu -= ngpt;  // row nlay - 1
#pragma unroll 1
    for (l = nlay; l >= kChunk; l -= kChunk, pt -= kChunk * ngpt, pu -= kChunk * ngpt) {
      float tr[kChunk], su[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) { tr[j] = pt[-j * ngpt]; su[j] = pu[-j * ngpt]; }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        rad = tr[j] * rad + su[j];
        pu[-j * ngpt] = rad;
      }
    }
    for (; l > 0; --l, pt -= ngpt, pu -= ngpt) {
      rad = pt[0] * rad + pu[0];
      pu[0] = rad;
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

template <int kMode>
static int launch_mode(const LwArgs& a, const Mlp3& m, const PlanckTab& p, const rte::MegaPlan& plan,
                       const rte::CloudLutOf<kMode>& c, const rte::LaneListOf<kMode>& lanes,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lw_mega_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  lw_mega_kernel<kMode><<<a.ncol, plan.threads, plan.smem_bytes, stream>>>(
      a, m, p, plan.layers_per_group, plan.slab_floats, c, lanes);
  return (int)cudaGetLastError();
}

// mode: rte::MegaMode. kCldLut reads lwp/iwp/rel/rei and ``cloud``; kCldBands
// reads cld_band; kLanes reads ``lanes`` (n2d raw lanes, lane 0 the layer
// temperature, which tlay also points at) and scale, and ignores x. ``plan``
// is launch_plan's geometry (ops/cuda/lw_megakernel.py), refused unless it is
// one this file is compiled for and its shared memory is what the kernel
// lays out. The structs are read on the host; pointers the mode does not
// read may be null.
extern "C" int lw_clearsky_mega4_launch(
    const LwArgs* args, const rte::Mlp3* net, const rte::PlanckTab* planck,
    const rte::MegaPlan* plan, const rte::CloudLut* cloud, const rte::LaneList* lanes,
    int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const LwArgs& a = *args;
  const Mlp3& m = *net;
  const rte::MegaPlan& pl = *plan;
  if (a.ncol <= 0 || a.nlay <= 0 || m.nout != 2 * a.ngpt) return (int)cudaErrorInvalidValue;
  if (pl.groups < 1 || pl.groups > rte::kMaxGroups) return (int)cudaErrorInvalidValue;
  // a slab holds whole rows of the widest layer, in 16-byte pieces
  const int widest = max(max(m.h1, m.h2), m.nout);
  if (pl.slab_floats < widest || pl.slab_floats % 4 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(pl.groups, pl.slab_floats, a.nlay, a.n2d, m.h1, m.h2, a.ngpt);
  if (!rte::plan_geometry_ok(pl, a.nlay, a.ngpt, smem)) return (int)cudaErrorInvalidValue;
  const rte::Unused none{};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case rte::kClear: return launch_mode<rte::kClear>(a, m, *planck, pl, none, none, st);
    case rte::kCldLut:
      if (cloud == nullptr || cloud->n_liq < 2 || cloud->n_ice < 2)
        return (int)cudaErrorInvalidValue;
      return launch_mode<rte::kCldLut>(a, m, *planck, pl, *cloud, none, st);
    case rte::kCldBands:
      return launch_mode<rte::kCldBands>(a, m, *planck, pl, none, none, st);
    case rte::kLanes:
      if (lanes == nullptr || a.n2d > rte::kMaxLanes) return (int)cudaErrorInvalidValue;
      return launch_mode<rte::kLanes>(a, m, *planck, pl, none, *lanes, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int kMode>
static int resident_blocks(const rte::MegaPlan& plan, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(lw_mega_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, lw_mega_kernel<kMode>, plan.threads, plan.smem_bytes);
}

// *blocks: how many blocks of the kernel in ``mode`` the device keeps resident
// on one SM at the plan's threads and shared memory, as the runtime reckons it
// from the compiled function's registers.
extern "C" int lw_clearsky_mega4_blocks_per_sm(const rte::MegaPlan* plan, int mode, int device,
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
