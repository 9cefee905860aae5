"""scripts/torch_dryrun_multichip.py on two gloo ranks on the CPU (a 1 x 2
('col', 'gpt') mesh): stage 1's training step with the batch split over
the ranks and the gradients averaged by all_reduce equals one process's
step on the whole batch (rtol 1e-6, float32 sums in another order); stage
2's g-point-split broadband (each rank's 64 of 128 g-points through the
output-feature split of the demo net, its Planck sources and transport,
then all_reduce over 'gpt') matches the unsplit staged LW core within
LW_ATOL, 2e-3 W/m2; stage 3's fused core over 'col' matches it too (the
script's own check). The g-point mapping of a rank's block against the
whole one."""
import os
import sys

import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable, lw_spectral_g128
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
from rte_rrtmgp_nn_tpu_torch.training.train import create_train_state, init_model, make_train_step
from test_torch_core import CPU, LW_MODEL

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
import torch_dryrun_multichip as D  # noqa: E402

NCOL, NLAY, LW_ATOL = 6, 10, 2e-3


@pytest.fixture(scope="module")
def ranks():
    return D.run(2, "cpu", NCOL, NLAY)


def test_train_step_split_over_ranks_equals_one_process(ranks):
    model = init_model([18, 16, 16, 32], torch.Generator().manual_seed(0), device="cpu")
    state, _ = create_train_state(model)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(16, 18)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=(16, 32)), dtype=torch.float32)
    state, loss = make_train_step()(state, x, y)
    for out in ranks:
        assert out["losses"] == [out["loss"]] * 2
        np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-6)
        for a, b in zip(out["weights"], model.weights):
            np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-6, atol=1e-7)


def test_gpt_split_broadband_matches_the_unsplit_core(ranks):
    data = rfmip_data_from_arrays(synthesize_rfmip(NCOL, NLAY, 0))
    spec = lw_spectral_g128()
    model = load_model_netcdf(LW_MODEL, device=CPU)
    table = PlanckTable.compute(spec.band_lims_wvn_array, device=CPU)
    ref = rfmip._lw_core([model], table, spec, *rfmip.lw_staged_inputs(data, spec, CPU),
                         top_at_1=data.top_at_1, n_gauss_angles=1, scan_mode="sequential")
    assert [r["gpts"] for r in ranks] == [(0, 64), (64, 64)]
    for out in ranks:
        assert out["mesh"] == {"col": 1, "gpt": 2} and out["cols"] == (0, NCOL)
        np.testing.assert_allclose(out["up"], ref.flux_up.numpy(), rtol=0, atol=LW_ATOL)
        np.testing.assert_allclose(out["dn"], ref.flux_dn.numpy(), rtol=0, atol=LW_ATOL)
        assert out["mega_err"] <= LW_ATOL
        np.testing.assert_allclose(out["dn_mega"], ref.flux_dn.numpy(), rtol=0, atol=LW_ATOL)


def test_gpt_subset_mapping_and_block_model():
    spec = lw_spectral_g128()
    sub = spec.gpt_subset(60, 100)
    assert sub.ngpt == 40 and sub.nband == spec.nband
    np.testing.assert_array_equal(sub.gpt2band, spec.gpt2band[60:100])
    model = load_model_netcdf(LW_MODEL, device=CPU)
    block = D.gpt_block_model(model, 60, 100)
    x = torch.rand(5, model.weights[0].shape[0])
    with torch.no_grad():
        whole, part = model.apply_raw(x), block.apply_raw(x)
    np.testing.assert_allclose(part[:, :40].numpy(), whole[:, 60:100].numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(part[:, 40:].numpy(), whole[:, 188:228].numpy(), rtol=1e-6,
                               atol=1e-6)
