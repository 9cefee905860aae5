"""The port's training step (training/train.py) against the JAX package's.

Both start from the same numpy init and take the same numpy batches, in
float64 on both sides: Adam (with and without optax's cosine decay), and
COCOB, each for 5 steps with the MSE loss (alpha 0) and the hybrid loss
(alpha 0.85). Loss and weights agree to rtol 1e-9 (the two frameworks'
float64 roundings; Adam divides by sqrt(v) + eps, where float32 runs would
part within a few steps). Also the output scalings, the standardization,
the losses, the schedule and the init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rte_rrtmgp_nn_tpu.models import network as jnet
from rte_rrtmgp_nn_tpu.training import train as jtrain
from rte_rrtmgp_nn_tpu_torch.models.network import nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.testing import random_gas_optics_net_arrays
from rte_rrtmgp_nn_tpu_torch.training import train as ptrain

RTOL = 1e-9
F64 = torch.float64
DIMS = (7, 16, 16, 12)
ACTS = ("softsign", "softsign", "linear")
NPAIRS, STEPS = 16, 5


def _pair(seed=3):
    """The same float64 net in both packages; the port's trainable."""
    ws, bs, acts, names, mn, mx, om, os_ = random_gas_optics_net_arrays(DIMS, ACTS, seed)
    f = lambda a: jnp.asarray(np.asarray(a, np.float64))
    jm = jnet.NNModel(tuple(map(f, ws)), tuple(map(f, bs)), acts, names, f(mn), f(mx),
                      f(om), f(os_))
    pm = nn_model_from_arrays(ws, bs, acts, names, mn, mx, om, os_, device="cpu", dtype=F64)
    for p in pm.parameters():
        p.requires_grad_(True)
    return jm, pm


def _batches(seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (2 * NPAIRS, DIMS[0])), rng.normal(0, 1, (2 * NPAIRS, DIMS[-1])))
            for _ in range(STEPS)]


def _pair_idx():
    return np.stack([np.arange(NPAIRS), np.arange(NPAIRS) + NPAIRS], axis=1)


def _jax_optimizer(kind, lr):
    if kind == "adam":
        return optax.adam(lr)
    if kind == "adam_cosine":
        return optax.adam(optax.cosine_decay_schedule(lr, 4, alpha=1e-2))
    return jtrain.cocob()


def _port_state(kind, pm, lr):
    if kind == "cocob":
        return ptrain.TrainState(pm, ptrain.Cocob(pm.parameters()))
    opt = torch.optim.Adam(pm.parameters(), lr=lr, eps=1e-8)
    sched = (ptrain.scheduled(opt, ptrain.cosine_decay_schedule(lr, 4, alpha=1e-2))
             if kind == "adam_cosine" else None)
    return ptrain.TrainState(pm, opt, scheduler=sched)


@pytest.mark.parametrize("alpha", [0.0, 0.85], ids=["mse", "hybrid"])
@pytest.mark.parametrize("kind", ["adam", "adam_cosine", "cocob"])
def test_train_step_matches_jax_for_five_steps(kind, alpha):
    """The cosine schedule decays over 4 steps, so the 5th step is at the
    floor (alpha): optax reads its count before incrementing it, and
    ``scheduled`` gives the k-th update schedule(k) (0-based) too."""
    lr = 3e-2
    jm, pm = _pair()
    opt = _jax_optimizer(kind, lr)
    jstate = jtrain.TrainState(jm, opt.init(jm), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(opt, alpha=alpha))
    pstate = _port_state(kind, pm, lr)
    pstep = ptrain.make_train_step(alpha=alpha)
    jidx, pidx = jnp.asarray(_pair_idx()), torch.as_tensor(_pair_idx())
    for k, (x, y) in enumerate(_batches()):
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jidx)
        pstate, ploss = pstep(pstate, torch.as_tensor(x), torch.as_tensor(y), pidx)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=RTOL, err_msg=f"step {k}")
    assert pstate.step == int(jstate.step) == STEPS
    for i in range(3):
        np.testing.assert_allclose(pstate.model.weights[i].detach().numpy(),
                                   np.asarray(jstate.model.weights[i]), rtol=RTOL, atol=1e-15)
        np.testing.assert_allclose(pstate.model.biases[i].detach().numpy(),
                                   np.asarray(jstate.model.biases[i]), rtol=RTOL, atol=1e-15)
    # the scalings are buffers: no step changes them
    np.testing.assert_array_equal(pstate.model.output_mean.numpy(), np.asarray(jm.output_mean))


def test_scheduled_rates_are_optax_counts():
    """The rate of update k (0-based) is optax's schedule(k); past the
    decay it stays at alpha * lr."""
    lr, T = 1e-3, 7
    sched = optax.cosine_decay_schedule(lr, T, alpha=1e-2)
    mine = ptrain.cosine_decay_schedule(lr, T, alpha=1e-2)
    p = torch.nn.Parameter(torch.zeros(2, dtype=F64))
    opt = torch.optim.Adam([p], lr=lr)
    lam = ptrain.scheduled(opt, mine)
    for k in range(T + 3):
        np.testing.assert_allclose(mine(k), float(sched(k)), rtol=1e-6)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], mine(k), rtol=1e-12)
        p.grad = torch.ones_like(p)
        opt.step()
        lam.step()
    assert mine(T + 5) == pytest.approx(1e-2 * lr)
    with pytest.raises(ValueError):
        ptrain.cosine_decay_schedule(lr, 0)


def test_output_scalings_and_standardization_match_jax(rng):
    tau = rng.lognormal(-3, 2, (5, 6, 4))
    col_dry = rng.uniform(1e20, 1e24, (5, 6))
    np.testing.assert_allclose(
        ptrain.scale_outputs_tau(torch.as_tensor(tau), torch.as_tensor(col_dry)).numpy(),
        np.asarray(jtrain.scale_outputs_tau(jnp.asarray(tau), jnp.asarray(col_dry))), rtol=1e-14)
    pf = rng.uniform(0, 1, (7, 4))
    np.testing.assert_allclose(ptrain.scale_outputs_pfrac(torch.as_tensor(pf)).numpy(),
                               np.asarray(jtrain.scale_outputs_pfrac(jnp.asarray(pf))),
                               rtol=1e-15)
    y = rng.normal(2.0, 3.0, (9, 8, 5))
    for got, ref in zip(ptrain.standardize_coeffs(y), jtrain.standardize_coeffs(y)):
        np.testing.assert_array_equal(got, ref)
    # the global std is the population std (ddof 0), not torch.std's ddof 1
    assert ptrain.standardize_coeffs(y)[1][0] == pytest.approx(np.std(y))
    assert ptrain.standardize_coeffs(y)[1][0] != pytest.approx(float(torch.as_tensor(y).std()))


def test_losses_match_jax(rng):
    pred, target = rng.normal(0, 1, (10, 3)), rng.normal(0, 1, (10, 3))
    idx = np.array([[0, 5], [1, 6], [2, 9]])
    P, T, I = torch.as_tensor(pred), torch.as_tensor(target), torch.as_tensor(idx)
    J = lambda a: jnp.asarray(a)
    for got, ref in (
        (ptrain.mse_loss(P, T), jtrain.mse_loss(J(pred), J(target))),
        (ptrain.expdiff_loss(P, T, I), jtrain.expdiff_loss(J(pred), J(target), J(idx))),
        (ptrain.hybrid_loss(P, T, I, 0.85), jtrain.hybrid_loss(J(pred), J(target), J(idx), 0.85)),
    ):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-14)


def test_init_model_is_he_init_and_trainable():
    """Normal weights of std sqrt(2 / fan-in), zero biases, softsign hidden
    and linear output; weights and biases require grad, the scaling
    coefficients are buffers; the same generator seed gives the same net."""
    dims = [7, 256, 256, 128]
    g = torch.Generator().manual_seed(0)
    m = ptrain.init_model(dims, g, input_min=np.zeros(7), input_max=np.ones(7),
                          output_mean=np.zeros(128), output_std=np.ones(128), device="cpu")
    assert m.dims == dims and m.activations == ("softsign", "softsign", "linear")
    assert m.input_names == tuple(f"x{i}" for i in range(7))
    for w, n_in in zip(m.weights, dims[:-1]):
        assert w.requires_grad and w.dtype == torch.float32
        assert float(w.detach().std()) == pytest.approx(np.sqrt(2.0 / n_in), rel=0.05)
    assert all(b.requires_grad and not b.any() for b in m.biases)
    assert [n for n, _ in m.named_parameters()] == [
        "weights.0", "weights.1", "weights.2", "biases.0", "biases.1", "biases.2"]
    m2 = ptrain.init_model(dims, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.weights, m2.weights))
    assert m2.output_mean is None and torch.equal(m2.input_max, torch.ones(7))


def test_init_model_has_no_default_device():
    """The device is a required keyword, as load_model_netcdf's: no
    constructor of the port picks the CPU for its caller."""
    with pytest.raises(TypeError, match="device"):
        ptrain.init_model([3, 4, 2], torch.Generator().manual_seed(0))


def test_create_train_state_is_adam_on_the_weights():
    _, pm = _pair()
    state, opt = ptrain.create_train_state(pm, learning_rate=1e-3)
    assert isinstance(opt, torch.optim.Adam) and state.optimizer is opt and state.step == 0
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"]) == (1e-3, (0.9, 0.999), 1e-8)
    assert len(g["params"]) == 6
