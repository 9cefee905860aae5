// Generic-depth MLP for NN gas optics with three epilogues:
//   both (K3): one "lw_both" net, tau = (ystd*y + ymean)^8 * col_dry on the
//              first ngpt outputs and pfrac = y^2 on the rest;
//   tau  (K4): one net, tau on all outputs;
//   sw   (K5): an absorption and a Rayleigh net on the same scaled inputs,
//              tau_tot = tau_abs + tau_ray, ssa = tau_ray / tau_tot where
//              tau_tot > 0, else 0.
//
// Replaces rte_rrtmgp_nn_tpu/ops/pallas/mlp.py::fused_predict_lw_both
// (_lw_both_kernel), ::fused_predict_tau (_tau_kernel) and ::fused_predict_sw
// (_sw_kernel), all on _apply_layers: any depth up to kMaxLayers, any of the
// seven activations of models/network.py between the layers, the last
// layer linear. Reference postprocessing: mod_network_rrtmgp.F90:125-409.
//
// What bounds it on an H100: FMA issue and the loads that feed it. The LW
// demo net (18 -> 128 -> 128 -> 256) is 51k FMAs per row, 5.6 GFMA at
// 1800 x 60 rows, each FMA needing a weight and an activation in a
// register; the bytes from device memory are small (18 inputs in, 2 x 128
// outputs out per row). The first version read every weight through the
// cache for a tile of 32 rows (206 KB of LW weights beside 64 KB of
// activations do not fit L1, so each k waited on L2) at 166 registers, one
// block of 8 warps per SM, with column slots fixed at 64 x 4 (a 48-wide
// layer used 48 of 256). This one is the fused kernels' tiled MLP
// (common.cuh) over the whole block: a block of the plan's threads takes
// kRows rows (the plan's choice of 32, 64 or 128, the most rows each weight
// copy can feed without idle threads); the rows' activations are k-major in
// shared memory, ping-ponged between layers (no hidden activation reaches
// device memory), so a thread reads its 8 rows of one k as two float4s its
// warp shares; the weights are copied once per block into two shared-memory
// slabs with cp.async while the block computes on the other (WeightStream);
// every thread holds a register tile of 8 rows x 2 neighbouring columns in
// the hidden layers and 8 x 4 in the last one (8 x 2 there when the 8 x 4
// tiles would leave half the threads idle; the plan reckons with the same
// rule). Tiles are (row tile, column tile) pairs walked by all threads, so
// a 48-wide layer keeps them busy when the rows are many. At 120 registers
// an SM holds 16 warps: as one block, every barrier and every wait for a
// weight slab stalls the SM, so the plan takes two blocks of 256 threads
// where their shared memory fits (K3 and K5 12-18% faster on an H100 than
// one of 512, scripts/tune_megakernel_tiles.py) and one of 512 (kThreads)
// where it does not. Ragged last tiles repeat the last row and store nothing for it.
// Every sum runs over k ascending in one accumulator with fmaf, across the
// slabs too (as cuBLAS rounds); IEEE float32 throughout: no TF32 or tensor
// cores, expf (within 2 ulp) and correctly rounded division (no
// --use_fast_math).
//
// K5's second net reads tau_abs back from out0: the thread that stores
// (row, j) of the absorption net's last layer takes the same (row, j) of the
// Rayleigh net's, since both nets' last layers have the same width and rows
// and so the same tiles in the same order.
#include <cuda_runtime.h>

#include "common.cuh"

constexpr int kMaxLayers = 8;    // deepest net (config.MLP_KERNEL_MAX_LAYERS)
constexpr int kMaxDims = kMaxLayers + 1;
constexpr int kMaxWidth = 512;   // widest input or hidden layer (config.MLP_KERNEL_MAX_WIDTH)
constexpr int kThreads = 512;    // the most threads per block
constexpr int kTileRows = 8;     // rows of a thread's register tile

// One net as the launch entry reads it: per layer the weights (n_in, n_out)
// row-major and the bias, then the output mean and std (dims[nlayers]);
// act[i] is the activation after layer i < nlayers - 1 (the order of
// models/network.py ACTIVATIONS). ops/cuda/build.py mirrors it field by
// field; the wrapper makes it once per model.
struct MlpNet {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  const float* omean;
  const float* ostd;
  int nlayers;
  int dims[kMaxDims];
  int act[kMaxLayers];
};

// Threads, rows per block, the widest input or hidden layer, dynamic shared
// memory and the floats of each of the two weight slabs: decided by
// mlp_launch_plan in ops/cuda/mlp.py (ops/cuda/build.py mirrors the struct)
// and checked again by the launch entry.
struct MlpPlan {
  int threads, rows, width, smem_bytes, slab_floats;
};

namespace {

enum Epilogue { kBoth = 0, kTau = 1, kSw = 2 };

struct Nets {
  MlpNet net[2];
};

// The seven activations, rounded as the plain PyTorch ops round them
// (hard_sigmoid's 0.2 x + 0.5 is two roundings there, so it is not
// contracted into one FMA here). The code is the layer's, uniform over the
// block; it is read once per output, after the k loop.
struct Activation {
  int code;
  __device__ __forceinline__ float operator()(float x) const {
    switch (code) {
      case 1: return fmaxf(x, 0.0f);                                // relu
      case 2: return 1.0f / (1.0f + expf(-x));                      // sigmoid
      case 3: return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, x), 0.5f), 0.0f), 1.0f);  // hard_sigmoid
      case 4: return x / (fabsf(x) + 1.0f);                         // softsign
      case 5: return tanhf(x);                                      // tanh
      case 6: return expf(-(x * x));                                // gaussian
      default: return x;                                            // linear
    }
  }
};

// The last layer's register tile is 8 x 4 unless 8 x 2 tiles take fewer
// rounds of the block's threads for the same work (each 8 x 4 round is twice
// an 8 x 2 one): ops/cuda/mlp.py last_tile_columns is the same rule.
__host__ __device__ inline bool last_tile_wide(int rows, int n_out, int threads) {
  const int row_tiles = rows / kTileRows;
  const int rounds4 = (row_tiles * ((n_out + 3) / 4) + threads - 1) / threads;
  const int rounds2 = (row_tiles * ((n_out + 1) / 2) + threads - 1) / threads;
  return 2 * rounds4 <= rounds2;
}

// Rows [row0, row0 + kRows) of x (rows, nin) into s[k][row]; rows at or past
// ``rows`` repeat the last row. No barrier.
template <int kRows>
__device__ inline void load_tile(const float* __restrict__ x, int row0, int rows, int nin,
                                 float* s) {
  for (int i = threadIdx.x; i < kRows * nin; i += blockDim.x) {
    const int r = i / nin, k = i - r * nin;
    s[k * (kRows + rte::kRowPad) + r] = x[(size_t)min(row0 + r, rows - 1) * nin + k];
  }
}

template <int kRows>
__global__ void __launch_bounds__(kThreads, 1)
mlp_kernel(const float* __restrict__ x, const float* __restrict__ col_dry,
           const __grid_constant__ Nets nets, float* __restrict__ out0, float* __restrict__ out1,
           int rows, int width, int slab_floats, int epilogue) {
  extern __shared__ float4 smem4[];
  constexpr int kStride = kRows + rte::kRowPad;
  float* const buf0 = reinterpret_cast<float*>(smem4);  // (width, kStride), k-major
  float* const buf1 = buf0 + width * kStride;
  rte::WeightStream ws{buf1 + width * kStride, slab_floats, 0};
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nnet = epilogue == kSw ? 2 : 1;

  const MlpNet& first = nets.net[0];
  rte::stream_issue(ws, 0, first.w[0], rte::first_slab_floats(ws, first.dims[0], first.dims[1]));
  for (int inet = 0; inet < nnet; ++inet) {
    const MlpNet& n = nets.net[inet];
    const int L = n.nlayers;
    // the first net's last layer may have read buf0
    if (inet > 0) __syncthreads();
    load_tile<kRows>(x, row0, rows, n.dims[0], buf0);
    for (int layer = 0; layer < L; ++layer) {
      const float* in = layer & 1 ? buf1 : buf0;
      float* out = layer & 1 ? buf0 : buf1;
      const int din = n.dims[layer], dout = n.dims[layer + 1];
      // what the stream copies after this layer: the next layer, the next
      // net's first, or nothing
      const MlpNet* nx = layer + 1 < L ? &n : inet + 1 < nnet ? &nets.net[inet + 1] : nullptr;
      const int nl = layer + 1 < L ? layer + 1 : 0;
      const float* next = nx ? nx->w[nl] : nullptr;
      const int next_in = nx ? nx->dims[nl] : 0, next_out = nx ? nx->dims[nl + 1] : 0;
      if (layer + 1 < L) {
        rte::mlp_layer_staged<kTileRows, 2, false, kRows>(
            ws, n.w[layer], n.b[layer], nullptr, din, dout, in, out, tid, nthr, next, next_in,
            next_out, Activation{n.act[layer]});
        continue;
      }
      // the last layer is linear; its epilogue writes device memory
      const float* bias = n.b[layer];
      auto end = [&](int r0, int j, const auto& sum) {
        const float b = __ldg(bias + j), omean = __ldg(n.omean + j), ostd = __ldg(n.ostd + j);
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          const int row = row0 + r0 + r;
          if (row >= rows) break;
          const float y = sum[r] + b;
          if (epilogue == kBoth) {
            const int ngpt = dout >> 1;
            if (j < ngpt)
              out0[(size_t)row * ngpt + j] = rte::tau_post(y, ostd, omean) * col_dry[row];
            else
              out1[(size_t)row * ngpt + (j - ngpt)] = y * y;
          } else {
            const size_t o = (size_t)row * dout + j;
            const float tau = rte::tau_post(y, ostd, omean) * col_dry[row];
            if (inet == 0) {
              out0[o] = tau;  // K5: tau_abs, read back by this thread for the Rayleigh net
            } else {
              const float tot = out0[o] + tau;
              out0[o] = tot;
              out1[o] = tot > 0.0f ? rte::div_or_zero(tau, tot) : 0.0f;
            }
          }
        }
      };
      if (last_tile_wide(kRows, dout, nthr))
        rte::mlp_last_staged<kTileRows, 4, kRows>(ws, n.w[layer], din, dout, in, tid, nthr, next,
                                                  next_in, next_out, end);
      else
        rte::mlp_last_staged<kTileRows, 2, kRows>(ws, n.w[layer], din, dout, in, tid, nthr, next,
                                                  next_in, next_out, end);
    }
  }
}

bool net_ok(const MlpNet& n) {
  if (n.nlayers < 1 || n.nlayers > kMaxLayers || n.omean == nullptr || n.ostd == nullptr)
    return false;
  for (int i = 0; i <= n.nlayers; ++i) {
    if (n.dims[i] <= 0) return false;
    if (i == n.nlayers) break;
    if (n.w[i] == nullptr || n.b[i] == nullptr || n.dims[i] > kMaxWidth || n.act[i] < 0 ||
        n.act[i] > 6)
      return false;
  }
  return true;
}

// Dynamic shared memory of one block; ops/cuda/mlp.py mlp_launch_plan
// computes the same number: two (width, rows + kRowPad) activation buffers
// and the two weight slabs.
size_t smem_bytes(int rows, int width, int slab_floats) {
  return sizeof(float) * (2 * (size_t)width * (rows + rte::kRowPad) + 2 * (size_t)slab_floats);
}

// The widest input or hidden layer of the nets, and the widest layer output.
void widths(const Nets& nets, int nnet, int* width, int* widest_out) {
  *width = *widest_out = 0;
  for (int i = 0; i < nnet; ++i)
    for (int l = 0; l < nets.net[i].nlayers; ++l) {
      *width = max(*width, nets.net[i].dims[l]);
      *widest_out = max(*widest_out, nets.net[i].dims[l + 1]);
    }
}

template <int kRows>
int launch_rows(const float* x, const float* col_dry, const Nets& nets, float* out0, float* out1,
                int rows, const MlpPlan& p, int epilogue, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kRows - 1) / kRows;
  mlp_kernel<kRows><<<blocks, p.threads, p.smem_bytes, stream>>>(
      x, col_dry, nets, out0, out1, rows, p.width, p.slab_floats, epilogue);
  return (int)cudaGetLastError();
}

template <int kRows>
int resident(const MlpPlan& p, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mlp_kernel<kRows>, p.threads,
                                                            p.smem_bytes);
}

}  // namespace

// epilogue: 0 = both (K3), 1 = tau (K4), 2 = sw (K5; the Rayleigh net in
// net_b). Outputs (rows, ngpt): out0 = tau (K5: tau_tot), out1 = pfrac (K3)
// or ssa (K5), unused by K4. ``plan`` is mlp_launch_plan's geometry
// (ops/cuda/mlp.py), refused unless its threads are whole warps up to
// kThreads, its rows are compiled here, its width is the nets' and its
// shared memory is what the kernel lays out. The structs are read on the
// host.
extern "C" int mlp_predict_launch(int epilogue, const float* x, const float* col_dry,
                                  const MlpNet* net_a, const MlpNet* net_b, const MlpPlan* plan,
                                  float* out0, float* out1, int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || epilogue < kBoth || epilogue > kSw || net_a == nullptr || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nnet = epilogue == kSw ? 2 : 1;
  Nets nets{};
  nets.net[0] = *net_a;
  if (!net_ok(nets.net[0])) return (int)cudaErrorInvalidValue;
  const int la = net_a->nlayers;
  if (epilogue == kSw) {
    if (net_b == nullptr || !net_ok(*net_b)) return (int)cudaErrorInvalidValue;
    nets.net[1] = *net_b;
    if (net_b->dims[0] != net_a->dims[0] || net_b->dims[net_b->nlayers] != net_a->dims[la])
      return (int)cudaErrorInvalidValue;
  }
  if (epilogue == kBoth && (net_a->dims[la] & 1)) return (int)cudaErrorInvalidValue;
  const MlpPlan& p = *plan;
  int width, widest_out;
  widths(nets, nnet, &width, &widest_out);
  const size_t smem = smem_bytes(p.rows, p.width, p.slab_floats);
  // a slab holds whole rows of the widest layer output, in 16-byte pieces
  if (p.threads < 32 || p.threads % 32 != 0 || p.threads > kThreads || p.width != width ||
      p.slab_floats < widest_out ||
      p.slab_floats % 4 != 0 || smem != (size_t)p.smem_bytes || smem > (size_t)rte::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.rows) {
    case 32: return launch_rows<32>(x, col_dry, nets, out0, out1, rows, p, epilogue, st);
    case 64: return launch_rows<64>(x, col_dry, nets, out0, out1, rows, p, epilogue, st);
    case 128: return launch_rows<128>(x, col_dry, nets, out0, out1, rows, p, epilogue, st);
  }
  return (int)cudaErrorInvalidValue;
}

// *blocks: how many blocks of the kernel the device keeps resident on one SM
// at the plan's threads and shared memory, as the runtime reckons it from the
// compiled function's registers. ``mode`` is not read (the plan's rows pick
// the function).
extern "C" int mlp_predict_blocks_per_sm(const MlpPlan* plan, int mode, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  (void)mode;
  switch (plan->rows) {
    case 32: return resident<32>(*plan, blocks);
    case 64: return resident<64>(*plan, blocks);
    case 128: return resident<128>(*plan, blocks);
  }
  return (int)cudaErrorInvalidValue;
}
