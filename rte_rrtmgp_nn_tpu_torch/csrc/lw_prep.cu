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
// What bounds it on an H100: the MLP, about 51k FMAs per (layer, column)
// with the 18->128->128->256 net, 5.6 GFMA at 1800 x 60, each needing a
// weight and an activation in a register; the 166 MB it writes would take a
// tenth of that time. The first version ran the MLP 4 layers at a time with
// one weight load from the cache and four scalar shared-memory loads per
// four FMAs. This one is the fused LW kernel's phase A (lw_megakernel.cu,
// common.cuh lw_both_nets): up to four layer groups of 128 threads, each
// taking a contiguous share of the layers through the tiled MLP, 16 layers
// a pass, with k-major scratch of its own; the weights are copied once per
// pass into two shared-memory slabs with cp.async while all groups compute
// (WeightStream). The net leaves (ystd*y + ymean)**8 and the Planck fraction
// in two (nlay, ngpt) shared-memory fields; then one thread per g-point walks
// its group's layers, forms the transmittance and both sources from the band
// Planck values (a thread knows its g-point's band, so the band -> g-point
// expansion is an index) and stores them, a warp 128 contiguous bytes per
// field and layer. The source at a layer's lower level is the level-top
// source of the layer below, pf(l+1) * B_lev(l+1): the fields stay in shared
// memory to the end, so at a group boundary the group above forms the same
// rounded product from the same operands as the group below, bit for bit.
// The geometry comes from lw_prep_plan (ops/cuda/lw_prep.py), checked again
// by the launch entry.
#include "common.cuh"

using rte::kGroup;
using rte::kRowStride;
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

// Floats of one layer group's MLP scratch: the feature rows and the two
// hidden layers, k-major.
__host__ __device__ inline int group_floats(int nf, int h1, int h2) {
  return kRowStride * (nf + h1 + h2);
}

// Dynamic shared memory of one block; ops/cuda/lw_prep.py lw_prep_plan
// computes the same number: the groups' scratch, the weights' two slabs, the
// column's col_dry and the two (nlay, ngpt) fields.
size_t smem_bytes(int groups, int slab_floats, int nlay, int nf, int h1, int h2, int ngpt) {
  return sizeof(float) * ((size_t)groups * group_floats(nf, h1, h2) + 2 * (size_t)slab_floats +
                          rte::align4(nlay) + (size_t)2 * nlay * ngpt);
}

__global__ void __launch_bounds__(rte::kMaxGroups * kGroup, 1)
lw_prep_kernel(const LwPrepArgs a, const Mlp3 m, const int layers_per_group,
               const int slab_floats) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int col = blockIdx.x;
  const int group = threadIdx.x / kGroup, gtid = threadIdx.x - group * kGroup;
  const int ngroups = blockDim.x / kGroup;
  const int g = gtid;
  const int nlay = a.nlay, ncol = a.ncol, ngpt = a.ngpt, nband = a.nband;
  const int gfl = group_floats(a.nf, m.h1, m.h2);
  float* s_x = smem + group * gfl;              // (nf, kRowStride), this group's
  float* s_h1 = s_x + kRowStride * a.nf;        // (h1, kRowStride)
  float* s_h2 = s_h1 + kRowStride * m.h1;       // (h2, kRowStride)
  float* s_slab = smem + ngroups * gfl;         // (2, slab_floats): the weights' two buffers
  float* s_cd = s_slab + 2 * slab_floats;       // (nlay) col_dry of this column
  float* s_y8 = s_cd + rte::align4(nlay);       // (nlay, ngpt): (ystd*y + ymean)**8
  float* s_pf = s_y8 + nlay * ngpt;             // (nlay, ngpt): Planck fraction

  // the weights' first slab starts on its way before anything else
  rte::WeightStream ws{s_slab, slab_floats, 0};
  rte::stream_issue(ws, 0, m.w1a, rte::first_slab_floats(ws, a.nf, m.h1));
  for (int l = threadIdx.x; l < nlay; l += blockDim.x) s_cd[l] = a.col_dry[(size_t)l * ncol + col];

  const int lbeg = min(group * layers_per_group, nlay);
  const int lend = min(lbeg + layers_per_group, nlay);
  // ---- the net: y**8 of the tau columns into s_y8, the fraction into s_pf ---
  rte::lw_both_nets<false>(ws, m, nullptr, a.nf, ngpt, lbeg, lend, layers_per_group, s_x, s_h1,
                           s_h2, s_y8, s_pf, gtid, [&](int l0) {
                             rte::load_rows_kmajor(a.x, l0, lend, ncol, col, a.nf, s_x, gtid);
                           });
  __syncthreads();  // every group's fields (and col_dry) complete

  // ---- transmittance and sources, stored -------------------------------------
  if (g >= ngpt || lbeg >= lend) return;
  const int band = a.gpt2band[g];
  const float* b_lev = a.b_lev + (size_t)col * nband + band;  // level l at b_lev[l * ncol * nband]
  const size_t lev_step = (size_t)ncol * nband;
  float pf = s_pf[lbeg * ngpt + g];
  float lev_t = __fmul_rn(pf, __ldg(b_lev + lbeg * lev_step));
  for (int l = lbeg; l < lend; ++l) {
    const int i = l * ngpt + g;
    const size_t lc = (size_t)l * ncol + col;
    const float tl = s_y8[i] * s_cd[l] * a.d_secant;
    const float trans = rte::transmittance(tl);
    const float fact = tl > a.tau_thresh ? (1.0f - trans) / tl - trans
                                         : tl * (0.5f - (1.0f / 3.0f) * tl);
    const float lay = __fmul_rn(pf, __ldg(a.b_lay + lc * nband + band));
    // the source at the level below: the next layer's level-top source (in
    // this group or the next); the bottom layer takes its own fraction at the
    // bottom level
    const float pf_next = l + 1 < nlay ? s_pf[i + ngpt] : pf;
    const float lev_b = __fmul_rn(pf_next, __ldg(b_lev + (l + 1) * lev_step));
    const float omt = 1.0f - trans, tf = 2.0f * fact;
    a.trans[lc * ngpt + g] = trans;
    a.src_up[lc * ngpt + g] = omt * lev_t + tf * (lay - lev_t);
    a.src_dn[lc * ngpt + g] = omt * lev_b + tf * (lay - lev_b);
    if (l + 1 == nlay)
      a.sfc_src[(size_t)col * ngpt + g] = __fmul_rn(pf, __ldg(a.b_sfc + (size_t)col * nband + band));
    pf = pf_next;
    lev_t = lev_b;
  }
}

}  // namespace

// ``plan`` is lw_prep_plan's geometry (ops/cuda/lw_prep.py), refused unless
// it is one this file is compiled for and its shared memory is what the
// kernel lays out. The structs are read on the host. ``net->w1a`` is the
// whole first layer (nf, h1); w1c is not read.
extern "C" int lw_prep_launch(const LwPrepArgs* args, const rte::Mlp3* net,
                              const rte::MegaPlan* plan, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const LwPrepArgs& a = *args;
  const Mlp3& m = *net;
  const rte::MegaPlan& pl = *plan;
  if (a.ncol <= 0 || a.nlay <= 0 || m.nout != 2 * a.ngpt || pl.groups < 1 ||
      pl.groups > rte::kMaxGroups)
    return (int)cudaErrorInvalidValue;
  // a slab holds whole rows of the widest layer, in 16-byte pieces
  const int widest = max(max(m.h1, m.h2), m.nout);
  if (pl.slab_floats < widest || pl.slab_floats % 4 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(pl.groups, pl.slab_floats, a.nlay, a.nf, m.h1, m.h2, a.ngpt);
  if (!rte::plan_geometry_ok(pl, a.nlay, a.ngpt, smem)) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(lw_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  lw_prep_kernel<<<a.ncol, pl.threads, pl.smem_bytes, (cudaStream_t)stream>>>(
      a, m, pl.layers_per_group, pl.slab_floats);
  return (int)cudaGetLastError();
}

// *blocks: how many blocks of the kernel the device keeps resident on one SM
// at the plan's threads and shared memory (the runtime's occupancy call).
// ``mode`` is not read: the kernel has one.
extern "C" int lw_prep_blocks_per_sm(const rte::MegaPlan* plan, int mode, int device,
                                     int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  (void)mode;
  err = cudaFuncSetAttribute(lw_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan->smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lw_prep_kernel, plan->threads,
                                                            plan->smem_bytes);
}
