"""The NN gas-optics MLPs in one CUDA kernel (``csrc/mlp.cu``) with three
epilogues, and their plain PyTorch twins:

  - ``fused_predict_lw_both`` (K3): one "lw_both" net -> (tau, pfrac);
  - ``fused_predict_tau`` (K4): one net -> tau;
  - ``fused_predict_sw`` (K5): absorption + Rayleigh nets -> (tau_tot, ssa).

Replaces rte_rrtmgp_nn_tpu/ops/pallas/mlp.py (``_lw_both_kernel``,
``_tau_kernel``, ``_sw_kernel`` on ``_apply_layers``). What bounds the
kernel on an H100 and how its design answers it is written at the top of
the CUDA source: FMA issue and the loads feeding it; a block takes a tile of
rows through every layer with the activations k-major in shared memory and
the weights streamed through two shared-memory slabs, each thread a register
tile of rows x columns. ``mlp_launch_plan`` decides the threads and rows
per block and the shared memory from the nets' widths (two blocks of 256
threads an SM where they fit); the launch entry checks it again.
Generic depth (up to config.MLP_KERNEL_MAX_LAYERS) and width (up to
config.MLP_KERNEL_MAX_WIDTH for the input and hidden layers); a wider or
deeper net raises. ``kernel_net`` is the net as the kernel reads it, made
once per model and kept with it.

x is (..., n_inputs) scaled features and col_dry (...,); outputs are
(..., ngpt). The wrappers launch the kernel for CUDA tensors and run the
plain twin for CPU tensors; they never fall back on CUDA. ``LAUNCHES``
counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...config import (MLP_KERNEL_MAX_LAYERS, MLP_KERNEL_MAX_WIDTH, mlp_kernel_refusal,
                       refuse_grad)
from ...models.network import ACTIVATIONS, NNModel
from ...utils.timing import span
from . import build
from .lw_megakernel import MAX_SLAB_FLOATS, MAX_SMEM, MIN_SLAB_ROWS, ROW_PAD, _check, _smem_limit

# kernel launches per wrapper (not plain-path calls)
LAUNCHES = {"fused_predict_lw_both": 0, "fused_predict_tau": 0, "fused_predict_sw": 0}
# activation codes of csrc/mlp.cu Activation: the order of ACTIVATIONS
ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}
_EPILOGUE = {"fused_predict_lw_both": 0, "fused_predict_tau": 1, "fused_predict_sw": 2}
# the kernel's geometry constants (csrc/mlp.cu)
THREADS = 512                 # kThreads: the most threads per block
TILE_ROWS = 8                 # kTileRows: rows of a thread's register tile
ROW_CHOICES = (32, 64, 128)   # the rows per block mlp_kernel is compiled for
# the threads per block the plan takes, by preference: two blocks of 256 on
# an SM where their shared memory fits (one block's barriers and weight
# waits then overlap the other's work), else one of 512; 16 warps an SM
# either way (120 registers a thread)
THREAD_CHOICES = (256, THREADS)
BLOCK_RESERVED_SMEM = 1024    # shared memory the runtime keeps for each resident block


class MlpLaunchPlan(NamedTuple):
    """The MLP kernel's launch geometry (csrc/mlp.cu MlpPlan): a block of
    ``threads`` takes ``rows`` rows; ``width`` is the widest input or
    hidden layer, the height of each of the two activation buffers;
    ``slab_floats`` the size of each of the two shared-memory buffers the
    weights stream through."""
    threads: int
    rows: int
    width: int
    smem_bytes: int
    slab_floats: int


def last_tile_columns(rows: int, n_out: int, threads: int) -> int:
    """Output columns of a thread's register tile in the last layer (csrc/
    mlp.cu last_tile_wide): 4, unless 8 x 2 tiles take fewer rounds of the
    block's threads for the same work (a round of 8 x 4 tiles costs two of
    8 x 2)."""
    rounds = lambda c: -(-(rows // TILE_ROWS) * -(-n_out // c) // threads)
    return 4 if 2 * rounds(4) <= rounds(2) else 2


def _slot_steps(dims, rows: int, threads: int) -> float:
    """Multiply-add slots the block's threads spend per row of the tile on
    one net, idle ones included: per layer the rounds of tiles over the
    threads times the tile's multiply-adds times the layer's inputs."""
    steps = 0
    for i, (n_in, n_out) in enumerate(zip(dims[:-1], dims[1:])):
        c = 2 if i + 2 < len(dims) else last_tile_columns(rows, n_out, threads)
        rounds = -(-(rows // TILE_ROWS) * -(-n_out // c) // threads)
        steps += rounds * TILE_ROWS * c * n_in
    return steps / rows


@functools.lru_cache(maxsize=64)
def mlp_launch_plan(dims_a: tuple, dims_b: tuple | None = None,
                    smem_limit: int = MAX_SMEM) -> MlpLaunchPlan:
    """Launch geometry of the MLP kernel for one net of widths ``dims_a``
    (inputs, hidden..., outputs) or two (``dims_b``, K5). The threads per
    block are the first of THREAD_CHOICES for which a plan fits: as many
    blocks as make 512 threads must share the SM's shared memory
    (``smem_limit``, what one block may take, plus BLOCK_RESERVED_SMEM is
    the SM's). Of the rows per block the kernel is compiled for, those whose
    two activation buffers and two weight slabs (MAX_SLAB_FLOATS, at least
    MIN_SLAB_ROWS rows of the widest layer output) fit that share, the one
    whose tiles leave the fewest thread slots idle per row (ties: the fewer
    rows). Raises ValueError in words when a net is deeper or wider than the
    kernel takes or nothing fits."""
    nets = [tuple(dims_a)] + ([tuple(dims_b)] if dims_b is not None else [])
    for d in nets:
        if len(d) < 2 or min(d) < 1:
            raise ValueError(f"mlp_kernel: net widths {d} must be positive, at least one layer")
        if len(d) - 1 > MLP_KERNEL_MAX_LAYERS:
            raise ValueError(f"mlp_kernel: a {len(d) - 1}-layer net is deeper than the kernel's "
                             f"{MLP_KERNEL_MAX_LAYERS} layers")
        if max(d[:-1]) > MLP_KERNEL_MAX_WIDTH:
            raise ValueError(f"mlp_kernel: a layer {max(d[:-1])} wide is wider than the "
                             f"kernel's {MLP_KERNEL_MAX_WIDTH}")
    width = max(max(d[:-1]) for d in nets)
    widest_out = max(max(d[1:]) for d in nets)
    min_slab = (MIN_SLAB_ROWS * widest_out + 3) & ~3
    for threads in THREAD_CHOICES:
        share = (smem_limit + BLOCK_RESERVED_SMEM) * threads // THREADS - BLOCK_RESERVED_SMEM
        best = None
        for rows in ROW_CHOICES:
            acts = 4 * 2 * width * (rows + ROW_PAD)
            slab = min(max(MAX_SLAB_FLOATS, min_slab), (share - acts) // 8 & ~3)
            if slab < min_slab:
                continue
            cost = sum(_slot_steps(d, rows, threads) for d in nets)
            if best is None or cost < best[0]:
                best = (cost, MlpLaunchPlan(threads, rows, width, acts + 8 * slab, slab))
        if best is not None:
            return best[1]
    raise ValueError(
        f"mlp_kernel: the nets are too wide: two activation buffers {width} wide take "
        f"{8 * width * (ROW_CHOICES[0] + ROW_PAD)} B at {ROW_CHOICES[0]} rows and the "
        f"weights' two slabs {8 * min_slab} B (rows of a {widest_out}-wide layer), a block "
        f"may use {share} B of shared memory")


def _pow8(y):
    y2 = y * y
    y4 = y2 * y2
    return y4 * y4


def fused_predict_tau_plain(model: NNModel, x: torch.Tensor, col_dry: torch.Tensor):
    """tau = (ystd*y + ymean)**8 * col_dry, y the raw net output."""
    y = model.output_std * model.apply_raw(x) + model.output_mean
    return _pow8(y) * col_dry[..., None]


def fused_predict_lw_both_plain(model: NNModel, x: torch.Tensor, col_dry: torch.Tensor):
    """(tau, pfrac) of a "lw_both" net: tau from the first half of the raw
    outputs, pfrac = y**2 from the second."""
    raw = model.apply_raw(x)
    ngpt = model.n_outputs // 2
    y = model.output_std[:ngpt] * raw[..., :ngpt] + model.output_mean[:ngpt]
    return _pow8(y) * col_dry[..., None], raw[..., ngpt:] * raw[..., ngpt:]


def fused_predict_sw_plain(model_abs: NNModel, model_ray: NNModel, x: torch.Tensor,
                           col_dry: torch.Tensor):
    """(tau_tot, ssa): both nets on the same inputs, ssa = tau_ray / tau_tot
    where tau_tot > 0, else 0."""
    tau_abs = fused_predict_tau_plain(model_abs, x, col_dry)
    tau_ray = fused_predict_tau_plain(model_ray, x, col_dry)
    tau_tot = tau_abs + tau_ray
    pos = tau_tot > 0
    return tau_tot, torch.where(pos, tau_ray / torch.where(pos, tau_tot, 1.0), 0.0)


def kernel_net(name: str, m: NNModel, dev) -> build.MlpNet:
    """The net as the kernel on ``dev`` reads it (csrc/mlp.cu MlpNet: each
    layer's weight and bias, the output mean and std, the widths and the
    activation codes), after checking each tensor. Made once and kept with
    the model (``NNModel.kernel_net``, dropped when to() / double() replace
    its tensors), so a call packs nothing. The kept net holds the tensors'
    data pointers, so an in-place change (an optimizer step) is read by the
    next launch; it is made again when a tensor was swapped for another
    (``p.data = t``, a new Parameter): ``NNModel.tensor_key`` differs."""
    key = m.tensor_key()
    kept = m.kernel_net
    if kept is not None and kept[0] == dev and kept[1] == key:
        return kept[2]
    with span("rte.kernel_net.miss"):
        why = mlp_kernel_refusal([m])
        if why:
            raise ValueError(f"{name}: {why}")
        n_out = m.n_outputs
        for i, (w, b) in enumerate(zip(m.weights, m.biases)):
            _check(f"weights[{i}]", w, (m.dims[i], m.dims[i + 1]), torch.float32, dev)
            _check(f"biases[{i}]", b, (m.dims[i + 1],), torch.float32, dev)
        for vname in ("output_mean", "output_std"):
            v = getattr(m, vname)
            if v is None:
                raise ValueError(f"{name}: the model has no {vname}")
            _check(vname, v, (n_out,), torch.float32, dev)
        net = build.MlpNet(omean=m.output_mean.data_ptr(), ostd=m.output_std.data_ptr(),
                           nlayers=m.n_layers)
        for i, (w, b) in enumerate(zip(m.weights, m.biases)):
            net.w[i], net.b[i] = w.data_ptr(), b.data_ptr()
        net.dims[:m.n_layers + 1] = m.dims
        net.act[:m.n_layers] = [ACT_CODES[a] for a in m.activations]
        m.kernel_net = (dev, key, net)
    return net


def _launch(name: str, nets, x, col_dry, ngpt: int, n_out: int):
    """Check the inputs, launch the kernel with ``name``'s epilogue, and
    return its n_out (rows, ngpt) outputs reshaped to x's leading shape."""
    refuse_grad(name, *nets, x, col_dry)
    dev = x.device
    index, stream = build.launch_target(name, dev)
    lead = tuple(x.shape[:-1])
    nin = nets[0].n_inputs
    rows = x.numel() // nin if nin else 0
    _check("x", x, lead + (nin,), torch.float32, dev)
    _check("col_dry", col_dry, lead, torch.float32, dev)
    if rows == 0 or rows >= 2**31:
        raise ValueError(f"{name}: {rows} rows; the kernel takes 1 to 2**31-1")
    structs = [kernel_net(name, m, dev) for m in nets]
    plan = mlp_launch_plan(*(tuple(m.dims) for m in nets), smem_limit=_smem_limit(dev))
    outs = [torch.empty(lead + (ngpt,), dtype=torch.float32, device=dev) for _ in range(2)]
    ref = ctypes.byref
    err = build.library().mlp_predict_launch(
        _EPILOGUE[name], x.data_ptr(), col_dry.data_ptr(), ref(structs[0]),
        ref(structs[1]) if len(structs) > 1 else None, ref(build.MlpPlan(*plan)),
        outs[0].data_ptr(), outs[1].data_ptr(), rows, index, stream)
    build.check(err, f"{name} launch")
    LAUNCHES[name] += 1
    return outs[:n_out]


def fused_predict_lw_both(model: NNModel, x: torch.Tensor, col_dry: torch.Tensor):
    """(tau, pfrac) of a "lw_both" net (K3); arguments as
    fused_predict_lw_both_plain. CPU tensors take the twin."""
    if x.device.type == "cpu":
        return fused_predict_lw_both_plain(model, x, col_dry)
    if model.n_outputs % 2:
        raise ValueError(f"fused_predict_lw_both: {model.n_outputs} outputs is not 2 x ngpt")
    return tuple(_launch("fused_predict_lw_both", [model], x, col_dry,
                         model.n_outputs // 2, 2))


def fused_predict_tau(model: NNModel, x: torch.Tensor, col_dry: torch.Tensor):
    """tau of one net (K4); arguments as fused_predict_tau_plain. CPU
    tensors take the twin."""
    if x.device.type == "cpu":
        return fused_predict_tau_plain(model, x, col_dry)
    return _launch("fused_predict_tau", [model], x, col_dry, model.n_outputs, 1)[0]


def fused_predict_sw(model_abs: NNModel, model_ray: NNModel, x: torch.Tensor,
                     col_dry: torch.Tensor):
    """(tau_tot, ssa) of the absorption and Rayleigh nets (K5); arguments
    as fused_predict_sw_plain. CPU tensors take the twin."""
    if x.device.type == "cpu":
        return fused_predict_sw_plain(model_abs, model_ray, x, col_dry)
    if (model_abs.n_inputs, model_abs.n_outputs) != (model_ray.n_inputs, model_ray.n_outputs):
        raise ValueError("fused_predict_sw: the absorption and Rayleigh nets differ in "
                         f"inputs or outputs ({model_abs.dims} vs {model_ray.dims})")
    return tuple(_launch("fused_predict_sw", [model_abs, model_ray], x, col_dry,
                         model_abs.n_outputs, 2))
