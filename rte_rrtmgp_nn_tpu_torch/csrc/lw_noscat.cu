// LW no-scattering broadband transport (K7): per (column, g-point, angle)
// the optical path and its transmittance, the linear-in-tau sources, the down
// sweep from the incident radiance, surface reflection and emission, the up
// sweep, and the per-level spectral sums times 2*pi*w, summed over the call's
// angles (angle 0 first, as ops/lw_solver.py adds them). Two modes of one
// template:
//   angles: tau, the layer source and the level source, column-major
//     (col, lay, gpt) with any column and layer strides; 1-4 Gauss angles as
//     scalar secants and weights, or one angle with per-(column, g-point)
//     secants (the optimal-angle path); an incident flux or radiance, or none.
//   fields: transmittance and both sources already formed, layer-major
//     (lay, col, gpt) as K6 (lw_prep.cu) writes them; one angle, weight 1/2,
//     no incident radiance; nothing to form, the walk alone.
//
// Replaces rte_rrtmgp_nn_tpu/ops/pallas/lw_solver.py::lw_noscat_broadband_pallas
// (_down_kernel, _up_kernel, _layer_step), called there once per angle; the
// fields mode is the JAX package's lw_broadband_sweeps (ops/lw_solver.py:387)
// behind lw_prep_pallas. Same physics as the reference's lw_solver_noscat
// (mo_rte_solver_kernels.F90:119-330) and lw_source_noscat (:742-776). The
// Pallas kernel's two calls, layer chunks and padding are Mosaic scheduling.
//
// What bounds it on an H100: device memory. The fields are 3 x 4 B per
// (layer, column, g-point), 166 MB at 1800 x 60 x 128, about 0.05 ms at
// 3.35 TB/s, whatever the number of angles; the arithmetic is ~40 operations
// per (layer, g-point, angle). A column's walk keeps 2 x angles floats per
// (layer, g-point) between its down and up sweeps (60 KB per angle at 60 x
// 128), so few columns fit an SM; one thread per g-point walking the whole
// column leaves 4-8 warps an SM on long dependent chains (on an H100 that
// was slower than reading the fields twice with 64 warps an SM; PERF.md).
// The design:
// - One block takes one column with `segments` threads per g-point: thread
//   (s, g) owns `seg_layers` consecutive layers. The layer recurrence
//   rad' = T rad + S is affine, so each thread first forms its layers'
//   trans, factor and sources and their composite map (A, B) over its
//   layers, the block exchanges the maps, and each thread then walks its own
//   layers from the radiance it folds from the maps above it (down) or below
//   it (up). Up to 1024 threads work on one column; every angle of the call
//   is in the same thread, and a block's own composites and sums leave room
//   for a second block an SM where the shared memory allows.
// - Each element of the fields leaves device memory once per call: a thread
//   loads its layers with independent loads up front (3 x seg_layers + 1 in
//   flight per thread). (trans, src_up) of each (layer, g-point, angle) are formed once
//   and kept in shared memory for the up sweep, src_dn in registers.
// - Where the column's (trans, src_up) do not all fit the shared memory, the
//   layers go in tiers of segments x seg_layers: the bottom `kept_tiers`
//   keep theirs, the tiers above reuse one scratch tier and recompute theirs
//   from device memory in the up sweep (NoscatPlan, decided by
//   ops/cuda/lw_solver.py lw_noscat_plan and checked again here).
// - The per-level spectral sums: a thread's seg_layers levels are summed over
//   the warp in one transpose reduction, the warps' partials over g-points
//   and then over the angles (angle 0 first) in a fixed order after a
//   barrier. No atomics: a launch on the same inputs gives the same bits.
// Arithmetic is IEEE float32 ('/' correctly rounded, no --use_fast_math),
// but for the transmittance (rte::transmittance, in double).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxGpt = 256;   // g-points of a column
constexpr int kMaxAngles = 4;  // Gauss angles of one call
constexpr int kModeAngles = 0, kModeFields = 1;

}  // namespace

struct NoscatArgs {
  const float* f0;    // angles: tau (col, lay, gpt); fields: trans (lay, col, gpt)
  const float* f1;    // angles: layer source; fields: src_dn
  const float* f2;    // angles: level source (col, lay+1, gpt); fields: src_up
  const float* emis;  // (ncol, ngpt)
  const float* sfc;   // (ncol, ngpt) surface source
  const float* ds;    // (ncol, ngpt) secants of the one angle, or null: secant[]
  const float* inc;   // (ncol, ngpt) incident flux or radiance, or null: none
  float* up;          // (ncol, nlay+1)
  float* dn;          // (ncol, nlay+1)
  int col_stride0, lay_stride0, col_stride1, lay_stride1, col_stride2, lay_stride2;
  int ncol, nlay, ngpt, nang;
  float secant[kMaxAngles];
  float two_pi_w[kMaxAngles];
  float inc_div[kMaxAngles];  // angle a starts from inc / inc_div[a]
  float tau_thresh;
};

// Launch geometry (ops/cuda/lw_solver.py NoscatPlan): `segments` threads per
// g-point (threads = segments x g-points rounded up to a warp), each walking
// `seg_layers` (4, 8 or 16) layers; tiers of segments x seg_layers layers, the
// bottom `kept_tiers` of which keep (trans, src_up) in shared memory.
struct NoscatPlan {
  int threads;
  int seg_layers;
  int segments;
  int kept_tiers;
  int angles;
  int smem_bytes;
};

namespace {

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// The plan's rules; ops/cuda/lw_solver.py lw_noscat_plan takes the same
// (and a test reads these lines): threads x seg_layers within a register
// budget of 8192 per block, and at most 1024 threads; the kept layers are
// those of the bottom `kept` tiers; one scratch tier while any tier is not
// kept.
__host__ __device__ inline int noscat_max_threads(int seg_layers) { return imin(8192 / seg_layers, 1024); }
__host__ __device__ inline int noscat_tiers(int nlay, int tier) { return (nlay + tier - 1) / tier; }
__host__ __device__ inline int noscat_kept_layers(int nlay, int tier, int kept) {
  return imax(nlay - (noscat_tiers(nlay, tier) - kept) * tier, 0);
}
__host__ __device__ inline int noscat_smem_floats(int nlay, int gp, int nang, int seg_layers,
                                                  int segments, int kept) {
  return (noscat_kept_layers(nlay, seg_layers * segments, kept)
          + imin(noscat_tiers(nlay, seg_layers * segments) - kept, 1) * seg_layers * segments)
             * 2 * nang * gp
         + segments * nang * 2 * gp + 2 * nang * gp + (seg_layers * segments + 1) * nang * (gp / 32);
}

// trans and the source factor of one layer at optical path tl, and the
// source leaving the layer towards a level of source b_lev.
__device__ __forceinline__ void trans_fact(float tl, float tau_thresh, float& trans, float& fact) {
  trans = rte::transmittance(tl);
  fact = tl > tau_thresh ? (1.0f - trans) / tl - trans : tl * (0.5f - (1.0f / 3.0f) * tl);
}
__device__ __forceinline__ float layer_src(float trans, float fact, float b_lay, float b_lev) {
  return (1.0f - trans) * b_lev + 2.0f * fact * (b_lay - b_lev);
}

// The sums over a warp of v[u][k] for L levels at once: each exchange over a
// lane bit halves the values a lane holds (N of them before it), so that
// after those over bits 4 down to log2(32 / L) each lane holds one level's
// sum over a group of lanes, level lane / (32 / L), in v[0]; the exchanges
// over the lower bits finish it. A template step per bit keeps every index
// a constant, so v stays in registers.
template <int N, int OFF, int L, int NA>
__device__ __forceinline__ void transpose_sums(float (&v)[L][NA], int lane) {
  if constexpr (N > 1) {
    const bool h = lane & OFF;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
#pragma unroll
      for (int k = 0; k < NA; ++k) {
        const float keep = h ? v[i + N / 2][k] : v[i][k], send = h ? v[i][k] : v[i + N / 2][k];
        v[i][k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
    }
    transpose_sums<N / 2, OFF / 2, L, NA>(v, lane);
  } else if constexpr (OFF > 0) {
#pragma unroll
    for (int k = 0; k < NA; ++k) v[0][k] += __shfl_xor_sync(0xffffffffu, v[0][k], OFF);
    transpose_sums<1, OFF / 2, L, NA>(v, lane);
  }
}

template <int NA>
__device__ __forceinline__ void warp_sums(float (&v)[NA]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NA; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
}

template <int NA, int MODE, int L>
__global__ void __launch_bounds__(8192 / L < 1024 ? 8192 / L : 1024)
lw_noscat_kernel(const NoscatArgs a, const NoscatPlan p) {
  extern __shared__ float smem[];
  const int nlay = a.nlay, col = blockIdx.x, nseg = p.segments;
  const int gp = blockDim.x / nseg, ngw = gp >> 5;
  const int tid = threadIdx.x, g = tid % gp, seg = tid / gp, gw = g >> 5, lane = tid & 31;
  const bool active = g < a.ngpt;
  const int tier = L * nseg, tiers = noscat_tiers(nlay, tier);
  const int keep_from = (tiers - p.kept_tiers) * tier;  // layers from it on keep their rows
  constexpr int R = 2 * NA;  // rows of a layer: trans and src_up per angle
  float* const kept = smem;
  float* const scratch = kept + (size_t)noscat_kept_layers(nlay, tier, p.kept_tiers) * R * gp;
  float* const comp = scratch + (p.kept_tiers < tiers ? (size_t)tier * R * gp : 0);  // (nseg, NA, 2, gp)
  float* const carry = comp + (size_t)nseg * NA * 2 * gp;  // (2, NA, gp): ping-pong
  float* const part = carry + 2 * NA * gp;                 // (tier + 1, NA, ngw)
  // the (trans, src_up) rows of a thread's layers l0.. at g-point g: a
  // thread's layers never straddle a tier, so they are consecutive
  auto rows = [&](int l0) {
    return (l0 >= keep_from ? kept + (size_t)(l0 - keep_from) * R * gp
                            : scratch + (size_t)(l0 - l0 / tier * tier) * R * gp) + g;
  };
  const float* f0 = a.f0 + (long long)col * a.col_stride0 + g;
  const float* f1 = a.f1 + (long long)col * a.col_stride1 + g;
  const float* f2 = a.f2 + (long long)col * a.col_stride2 + g;
  float* const up = a.up + (size_t)col * (nlay + 1);
  float* const dn = a.dn + (size_t)col * (nlay + 1);

  const size_t cg = (size_t)col * a.ngpt + g;
  float emis = 0.0f, sfc = 0.0f, d[NA], rad0[NA];
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    d[k] = a.secant[k];
    rad0[k] = 0.0f;
  }
  if (active) {
    emis = a.emis[cg];
    sfc = a.sfc[cg];
    if (a.ds != nullptr) d[0] = a.ds[cg];
    if (a.inc != nullptr) {
      const float inc = a.inc[cg];
#pragma unroll
      for (int k = 0; k < NA; ++k) rad0[k] = inc / a.inc_div[k];
    }
  }

  // A thread's layers' (trans, src_up) into their rows and, if asked, their
  // src_dn; for the angles mode trans and the sources are formed here, once.
  auto form = [&](int l0, int nl, float (&sdn)[L][NA], bool want_dn) {
    float x0[L], x1[L], x2[L + 1];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const long long l = min(l0 + u, nlay - 1);
      if (u < nl) {
        x0[u] = __ldg(f0 + l * a.lay_stride0);
        x1[u] = __ldg(f1 + l * a.lay_stride1);
        x2[u] = __ldg(f2 + l * a.lay_stride2);
      }
    }
    if (MODE == kModeAngles) x2[L] = __ldg(f2 + (long long)min(l0 + nl, nlay) * a.lay_stride2);
    float* const rbase = rows(l0);
#pragma unroll
    for (int u = 0; u < L; ++u) {
      if (u < nl) {
        float* r = rbase + u * R * gp;
        if (MODE == kModeAngles) {
          // a layer's bottom level is the next layer's top; the last
          // layer's is x2[L]
          const float lev_bot = u + 1 < nl ? x2[u + 1] : x2[L];
#pragma unroll
          for (int k = 0; k < NA; ++k) {
            float trans, fact;
            trans_fact(x0[u] * d[k], a.tau_thresh, trans, fact);
            r[2 * k * gp] = trans;
            r[(2 * k + 1) * gp] = layer_src(trans, fact, x1[u], x2[u]);
            if (want_dn) sdn[u][k] = layer_src(trans, fact, x1[u], lev_bot);
          }
        } else {
          r[0] = x0[u];
          r[gp] = x2[u];
          sdn[u][0] = x1[u];
        }
      }
    }
  };

  // ---- down sweep, tier by tier from the top ---------------------------------
  int par = 0;  // carry[par] holds the radiance entering the tier
#pragma unroll 1
  for (int t = 0; t < tiers; ++t) {
    const int l0 = t * tier + seg * L, nl = max(0, min(L, nlay - l0));
    const int nt = min(tier, nlay - t * tier);  // layers in the tier
    float sdn[L][NA], A[NA], B[NA], rad[NA];
    const float* const rbase = rows(l0);
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      A[k] = 1.0f;
      B[k] = 0.0f;
    }
    if (active) {
      form(l0, nl, sdn, true);
#pragma unroll
      for (int u = 0; u < L; ++u) {
        if (u < nl) {
          const float* r = rbase + u * R * gp;
#pragma unroll
          for (int k = 0; k < NA; ++k) {
            const float trans = r[(MODE == kModeAngles ? 2 * k : 0) * gp];
            A[k] *= trans;
            B[k] = trans * B[k] + sdn[u][k];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      comp[((size_t)(seg * NA + k) * 2) * gp + g] = A[k];
      comp[((size_t)(seg * NA + k) * 2 + 1) * gp + g] = B[k];
    }
    if (t == 0 && seg == 0) {
      float v[NA];
#pragma unroll
      for (int k = 0; k < NA; ++k) v[k] = rad0[k];
      warp_sums(v);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NA; ++k) part[k * ngw + gw] = v[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NA; ++k) rad[k] = t == 0 ? rad0[k] : carry[(par * NA + k) * gp + g];
    for (int s2 = 0; s2 < seg; ++s2) {
#pragma unroll
      for (int k = 0; k < NA; ++k)
        rad[k] = comp[((size_t)(s2 * NA + k) * 2) * gp + g] * rad[k]
                 + comp[((size_t)(s2 * NA + k) * 2 + 1) * gp + g];
    }
    float rb[L][NA];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      if (active && u < nl) {
        const float* r = rbase + u * R * gp;
#pragma unroll
        for (int k = 0; k < NA; ++k)
          rad[k] = r[(MODE == kModeAngles ? 2 * k : 0) * gp] * rad[k] + sdn[u][k];
      }
#pragma unroll
      for (int k = 0; k < NA; ++k) rb[u][k] = active ? rad[k] : 0.0f;
    }
    if (nl > 0 && l0 + nl == t * tier + nt) {  // the tier's bottom layer: its radiance goes on
#pragma unroll
      for (int k = 0; k < NA; ++k) carry[((par ^ 1) * NA + k) * gp + g] = rad[k];
    }
    transpose_sums<L, 16, L, NA>(rb, lane);
    const int u = lane / (32 / L);
    if (lane % (32 / L) == 0 && u < nl) {
#pragma unroll
      for (int k = 0; k < NA; ++k) part[((size_t)(seg * L + 1 + u) * NA + k) * ngw + gw] = rb[0][k];
    }
    __syncthreads();
    // levels t * tier + i, i in 1..nt (and 0 at the top)
    for (int i = tid + (t == 0 ? 0 : 1); i <= nt; i += blockDim.x) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NA; ++k) {
        float s = 0.0f;
        for (int w = 0; w < ngw; ++w) s += part[((size_t)i * NA + k) * ngw + w];
        acc = k == 0 ? s * a.two_pi_w[0] : acc + s * a.two_pi_w[k];
      }
      dn[t * tier + i] = acc;
    }
    par ^= 1;
    __syncthreads();
  }

  // ---- surface, then the up sweep, tier by tier from the bottom --------------
  float rad_sfc[NA];
#pragma unroll
  for (int k = 0; k < NA; ++k)
    rad_sfc[k] = active ? carry[(par * NA + k) * gp + g] * (1.0f - emis) + emis * sfc : 0.0f;
#pragma unroll 1
  for (int t = tiers - 1; t >= 0; --t) {
    const int l0 = t * tier + seg * L, nl = max(0, min(L, nlay - l0));
    const int nt = min(tier, nlay - t * tier);
    float A[NA], B[NA], rad[NA];
    const float* const rbase = rows(l0);
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      A[k] = 1.0f;
      B[k] = 0.0f;
    }
    if (active) {
      if (t * tier < keep_from) {  // a tier without kept rows: form them again
        float unused[L][NA];
        form(l0, nl, unused, false);
      }
#pragma unroll
      for (int u = L - 1; u >= 0; --u) {
        if (u < nl) {
          const float* r = rbase + u * R * gp;
#pragma unroll
          for (int k = 0; k < NA; ++k) {
            const float trans = r[(MODE == kModeAngles ? 2 * k : 0) * gp];
            A[k] *= trans;
            B[k] = trans * B[k] + r[(MODE == kModeAngles ? 2 * k + 1 : 1) * gp];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      comp[((size_t)(seg * NA + k) * 2) * gp + g] = A[k];
      comp[((size_t)(seg * NA + k) * 2 + 1) * gp + g] = B[k];
    }
    if (t == tiers - 1 && seg == 0) {  // level nlay: the surface
      float v[NA];
#pragma unroll
      for (int k = 0; k < NA; ++k) v[k] = rad_sfc[k];
      warp_sums(v);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NA; ++k) part[((size_t)nt * NA + k) * ngw + gw] = v[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NA; ++k) rad[k] = t == tiers - 1 ? rad_sfc[k] : carry[(par * NA + k) * gp + g];
    for (int s2 = nseg - 1; s2 > seg; --s2) {
#pragma unroll
      for (int k = 0; k < NA; ++k)
        rad[k] = comp[((size_t)(s2 * NA + k) * 2) * gp + g] * rad[k]
                 + comp[((size_t)(s2 * NA + k) * 2 + 1) * gp + g];
    }
    float rb[L][NA];
#pragma unroll
    for (int u = L - 1; u >= 0; --u) {
      if (active && u < nl) {
        const float* r = rbase + u * R * gp;
#pragma unroll
        for (int k = 0; k < NA; ++k)
          rad[k] = r[(MODE == kModeAngles ? 2 * k : 0) * gp] * rad[k]
                   + r[(MODE == kModeAngles ? 2 * k + 1 : 1) * gp];
      }
#pragma unroll
      for (int k = 0; k < NA; ++k) rb[u][k] = active ? rad[k] : 0.0f;
    }
    if (seg == 0) {  // the tier's top layer: its radiance goes on
#pragma unroll
      for (int k = 0; k < NA; ++k) carry[((par ^ 1) * NA + k) * gp + g] = rad[k];
    }
    transpose_sums<L, 16, L, NA>(rb, lane);
    const int u = lane / (32 / L);
    if (lane % (32 / L) == 0 && u < nl) {
#pragma unroll
      for (int k = 0; k < NA; ++k) part[((size_t)(seg * L + u) * NA + k) * ngw + gw] = rb[0][k];
    }
    __syncthreads();
    // levels t * tier + i, i in 0..nt - 1 (and nt at the surface)
    for (int i = tid; i < nt + (t == tiers - 1 ? 1 : 0); i += blockDim.x) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NA; ++k) {
        float s = 0.0f;
        for (int w = 0; w < ngw; ++w) s += part[((size_t)i * NA + k) * ngw + w];
        acc = k == 0 ? s * a.two_pi_w[0] : acc + s * a.two_pi_w[k];
      }
      up[t * tier + i] = acc;
    }
    par ^= 1;
    __syncthreads();
  }
}

using KernelFn = void (*)(NoscatArgs, NoscatPlan);

template <int MODE, int L>
KernelFn pick_angles(int nang) {
  if (MODE == kModeFields) return nang == 1 ? lw_noscat_kernel<1, kModeFields, L> : nullptr;
  switch (nang) {
    case 1: return lw_noscat_kernel<1, kModeAngles, L>;
    case 2: return lw_noscat_kernel<2, kModeAngles, L>;
    case 3: return lw_noscat_kernel<3, kModeAngles, L>;
    case 4: return lw_noscat_kernel<4, kModeAngles, L>;
    default: return nullptr;
  }
}

template <int MODE>
KernelFn pick_seg_layers(int nang, int seg_layers) {
  switch (seg_layers) {
    case 4: return pick_angles<MODE, 4>(nang);
    case 8: return pick_angles<MODE, 8>(nang);
    case 16: return pick_angles<MODE, 16>(nang);
    default: return nullptr;
  }
}

// The kernel instance of a plan and mode, or null if the plan is not one
// the kernel is compiled for.
KernelFn pick(const NoscatPlan* p, int mode) {
  if (mode == kModeAngles) return pick_seg_layers<kModeAngles>(p->angles, p->seg_layers);
  if (mode == kModeFields) return pick_seg_layers<kModeFields>(p->angles, p->seg_layers);
  return nullptr;
}

// The plan's rules for a column of nlay layers and ngpt g-points: whole
// warps of g-points per segment, no more segments than layers need, the
// threads within the instance's bound, and the shared memory what the kernel
// lays out.
bool plan_ok(const NoscatPlan* p, int nlay, int ngpt, int nang) {
  const int gp = (ngpt + 31) / 32 * 32, L = p->seg_layers;
  return p->angles == nang && p->segments >= 1 && (p->segments - 1) * L < nlay
         && p->threads == gp * p->segments && p->threads <= noscat_max_threads(L)
         && p->kept_tiers >= 0 && p->kept_tiers <= noscat_tiers(nlay, L * p->segments)
         && p->smem_bytes == 4 * noscat_smem_floats(nlay, gp, nang, L, p->segments, p->kept_tiers)
         && p->smem_bytes <= rte::kMaxSmem;
}

}  // namespace

extern "C" int lw_noscat_broadband_launch(const NoscatArgs* a, const NoscatPlan* p, int mode,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->ngpt <= 0 || a->ngpt > kMaxGpt || a->ncol <= 0 || a->nlay <= 0 || a->nang <= 0
      || a->nang > kMaxAngles || (a->ds != nullptr && a->nang != 1)
      || (mode == kModeFields && (a->nang != 1 || a->ds != nullptr || a->inc != nullptr))
      || !plan_ok(p, a->nlay, a->ngpt, a->nang))
    return (int)cudaErrorInvalidValue;
  const KernelFn fn = pick(p, mode);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fn<<<a->ncol, p->threads, p->smem_bytes, (cudaStream_t)stream>>>(*a, *p);
  return (int)cudaGetLastError();
}

// Blocks of the plan's kernel instance that one SM keeps resident (the
// runtime's occupancy call). ``mode``: 0 angles, 1 fields.
extern "C" int lw_noscat_broadband_blocks_per_sm(const NoscatPlan* plan, int mode, int device,
                                                 int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const KernelFn fn = pick(plan, mode);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, plan->threads,
                                                            plan->smem_bytes);
}
