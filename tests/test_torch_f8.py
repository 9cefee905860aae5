"""Weights that change in place (ROADMAP Queue 3 F8), and the kernels'
refusal of gradients.

F8: the fused routes keep the first layer's rows as the kernels take them
(``split_first_layer``: copies) and the MLP kernel keeps the net's data
pointers (``kernel_net``). An optimizer step, ``load_state_dict`` or an
EMA update changes a weight in place; a swap (``p.data = t``) replaces it.
After either, the fused routes' fluxes equal those of a fresh model with
the same weights (0.0 W/m2: the same float32 operations), and differ from
the first call's. On the CPU the fused routes run the kernels' plain twins
(the K1 / K2 twins with ``use_megakernel=True``), which read the same kept
splits as the kernels.

Gradients: no kernel has a backward (the JAX package has no backward
kernel either), so a CUDA call with grad enabled and an input or weight
that requires grad is refused in words, naming the kernel. Off the CPU the
wrappers are reached here with meta tensors (shape and dtype, no data): the
refusal comes before the launch, and under ``torch.no_grad()`` the same call
goes on to the launch.
"""
import copy

import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu_torch.config import config_override, grad_refusal, refuse_grad
from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable, lw_spectral_g128, sw_spectral_g112
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
from test_torch_core import CPU, LW_MODEL, SW_MODEL

DATA = rfmip_data_from_arrays(synthesize_rfmip(12, 10, 0))


def _lw(model):
    with config_override(use_megakernel=True):
        return rfmip.rfmip_clear_sky_lw(DATA, [model], device=CPU)


def _sw(abs_model, ray_model):
    with config_override(use_megakernel=True):
        return rfmip.rfmip_clear_sky_sw(DATA, [abs_model, ray_model], device=CPU)


def _fresh(path, like):
    """A freshly loaded model with ``like``'s weights and biases."""
    m = load_model_netcdf(path, device=CPU)
    m.load_state_dict(like.state_dict())
    return m


def _flux_gap(a, b) -> float:
    return max(float((a.flux_up - b.flux_up).abs().max()),
               float((a.flux_dn - b.flux_dn).abs().max()))


def test_lw_fused_route_follows_an_in_place_weight_change():
    """The reproduction of F8: with the split kept from the first call, the
    changed model gave the old model's fluxes bit for bit, 12.64 W/m2 from
    a fresh copy of the same weights."""
    m = load_model_netcdf(LW_MODEL, device=CPU)
    before = _lw(m)
    assert m.first_layer_splits
    with torch.no_grad():
        m.weights[0].mul_(1.05)
    after = _lw(m)
    assert _flux_gap(after, _lw(_fresh(LW_MODEL, m))) == 0.0
    assert _flux_gap(after, before) > 1.0


def test_sw_fused_route_follows_an_in_place_weight_change():
    ab, ray = load_model_netcdf(SW_MODEL, device=CPU), load_model_netcdf(SW_MODEL, device=CPU)
    before = _sw(ab, ray)
    with torch.no_grad():
        ab.weights[0].mul_(1.05)
        ray.weights[0].add_(0.01)
    after = _sw(ab, ray)
    assert _flux_gap(after, _sw(_fresh(SW_MODEL, ab), _fresh(SW_MODEL, ray))) == 0.0
    assert _flux_gap(after, before) > 1e-2


def test_fused_route_follows_load_state_dict_and_a_swapped_tensor():
    m = load_model_netcdf(LW_MODEL, device=CPU)
    other = load_model_netcdf(LW_MODEL, device=CPU)
    with torch.no_grad():
        other.weights[0].mul_(0.97)
    first = _lw(m)
    m.load_state_dict(other.state_dict())
    assert _flux_gap(_lw(m), _lw(other)) == 0.0
    assert _flux_gap(_lw(m), first) > 1.0
    # a swap: the parameter holds another tensor
    m.weights[0].data = (m.weights[0] * 1.02).detach()
    assert _flux_gap(_lw(m), _lw(_fresh(LW_MODEL, m))) == 0.0


def test_kernel_net_follows_a_swapped_tensor_and_keeps_an_in_place_one():
    """The MLP kernel's net holds data pointers: an in-place step is read
    through them (the same net), a swapped tensor makes a new net that
    points at it."""
    m = load_model_netcdf(LW_MODEL, device=CPU)
    net = mlp.kernel_net("test", m, CPU)
    with torch.no_grad():
        m.weights[1].mul_(1.01)
        m.biases[2].add_(0.5)
    assert mlp.kernel_net("test", m, CPU) is net
    m.weights[1].data = m.weights[1].detach().clone()
    again = mlp.kernel_net("test", m, CPU)
    assert again is not net and again.w[1] == m.weights[1].data_ptr()
    m.biases[0] = torch.nn.Parameter(m.biases[0].detach().clone(), requires_grad=False)
    third = mlp.kernel_net("test", m, CPU)
    assert third is not again and third.b[0] == m.biases[0].data_ptr()
    assert mlp.kernel_net("test", m, CPU) is third


def test_split_is_not_kept_for_autograd_and_gradients_reach_the_first_layer():
    """With grad enabled and a weight that requires grad the split is cut at
    every call and not kept, so the K1 twin on the CPU differentiates to
    every layer, as often as it is called."""
    m = load_model_netcdf(LW_MODEL, device=CPU)
    for p in m.parameters():
        p.requires_grad_(True)
    for _ in range(2):
        m.zero_grad()
        _lw(m).flux_up.mean().backward()
        assert not m.first_layer_splits
        assert all(float(p.grad.abs().sum()) > 0 for p in m.parameters())
    with torch.no_grad():
        _lw(m)
    assert m.first_layer_splits


# -- the kernels' refusal of gradients -----------------------------------------

def test_grad_refusal_words():
    w = torch.zeros(3, requires_grad=True)
    m = load_model_netcdf(LW_MODEL, device=CPU)
    assert grad_refusal("k", torch.zeros(3), None, 2.0, m) == ""
    why = grad_refusal("lw_clearsky_mega4[clear]", torch.zeros(3), [None, (w,)])
    assert why.startswith("lw_clearsky_mega4[clear]: ") and "no backward" in why
    with torch.no_grad():
        assert grad_refusal("k", w) == ""
    m.weights[2].requires_grad_(True)
    assert "torch.no_grad()" in grad_refusal("fused_predict_lw_both", m)
    with pytest.raises(ValueError, match="^k: an input or weight requires grad"):
        refuse_grad("k", [m])
    refuse_grad("k", m.input_min)


class _Reached(Exception):
    pass


def _meta(x):
    return x.to("meta") if torch.is_tensor(x) else x


def _trainable_meta(model):
    m = copy.deepcopy(model).to("meta")
    for p in m.parameters():
        p.requires_grad_(True)
    return m


def _cases():
    lw = load_model_netcdf(LW_MODEL, device=CPU)
    sw = load_model_netcdf(SW_MODEL, device=CPU)
    spec = lw_spectral_g128()
    table = PlanckTable.compute(spec.band_lims_wvn_array, device=CPU)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spectral_g112()), dtype=torch.float32)
    lw_args, _ = fused.lw_args([lw], table, spec, *rfmip.lw_canonical_inputs(DATA, spec, CPU))
    sw_args, _ = fused.sw_args([sw, sw], None,
                               *rfmip.sw_fused_inputs(solar, *rfmip.sw_canonical_inputs(DATA, CPU)))
    x = torch.rand(12, 10, 18)
    col_dry = torch.rand(12, 10)
    tau = torch.rand(4, 5, 8)
    lev, sfc = torch.rand(4, 6, 8), torch.rand(4, 8)
    lwm, swm = _trainable_meta(lw), _trainable_meta(sw)
    k6_in = torch.rand(10, 12, 18)
    return {
        "lw_clearsky_mega4[clear]": lambda: k1.lw_clearsky_mega4(
            lwm, *map(_meta, lw_args[1:])),
        "sw_clearsky_megakernel[clear]": lambda: k2.sw_clearsky_megakernel(
            swm, swm, *map(_meta, sw_args[2:])),
        "fused_predict_lw_both": lambda: mlp.fused_predict_lw_both(lwm, _meta(x), _meta(col_dry)),
        "fused_predict_tau": lambda: mlp.fused_predict_tau(lwm, _meta(x), _meta(col_dry)),
        "fused_predict_sw": lambda: mlp.fused_predict_sw(swm, swm, _meta(x[..., :7]),
                                                         _meta(col_dry)),
        "lw_prep": lambda: k6.lw_prep(lwm, _meta(k6_in), _meta(col_dry.T), *map(_meta, (
            table.interpolate(torch.rand(10, 12) * 100 + 200),
            table.interpolate(torch.rand(11, 12) * 100 + 200),
            table.interpolate(torch.rand(12) * 100 + 200), spec.gpt2band_tensor(CPU)))),
        "lw_noscat_broadband[angles]": lambda: k7.lw_noscat_broadband_angles(
            _meta(tau).requires_grad_(True), *map(_meta, (tau, lev, sfc, sfc)), [1.66], [0.5]),
    }


@pytest.mark.parametrize("kernel", [
    "lw_clearsky_mega4[clear]", "sw_clearsky_megakernel[clear]", "fused_predict_lw_both",
    "fused_predict_tau", "fused_predict_sw", "lw_prep", "lw_noscat_broadband[angles]"])
def test_cuda_wrappers_refuse_gradients_before_the_launch(kernel, monkeypatch):
    """Each kernel's wrapper, off the CPU, with grad enabled and a weight or
    input that requires grad: ValueError naming the kernel, before anything
    reaches the launch. Under torch.no_grad() the same call reaches it."""
    def launch_target(name, dev):
        raise _Reached(name)

    monkeypatch.setattr(build, "launch_target", launch_target)
    call = _cases()[kernel]
    with pytest.raises(ValueError, match=rf"^{kernel.replace('[', '.').replace(']', '.')}: "
                                         "an input or weight requires grad"):
        call()
    with torch.no_grad(), pytest.raises(_Reached):
        call()
