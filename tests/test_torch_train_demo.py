"""scripts/torch_train_demo.py and torch_train_demo_sw.py against the JAX
package's scripts/train_demo.py and train_demo_sw.py, on the CPU.

The files are made under a temp dir: an RFMIP file of 11 experiments x 4
sites x 60 layers (testing.write_rfmip_file; experiment 10 is in the scored
forcing pairs), the in-repo stand-ins as teachers (the 128-wide g-128 LW
demo net; the SW absorption demo net as both SW teachers) and, per demo,
one student saved by the port (init_model from seed 0, 16 wide) that both
packages start from through --init-from: jax.random and torch.Generator
draw different inits. Then the batches (numpy default_rng(0)), Adam, the
cosine schedule and the loss are the same, and 2 epochs x 3 steps of 64
pairs differ by float32 rounding alone.

The JAX script runs as a subprocess with JAX_PLATFORMS=cpu (64-bit off, as
run as a script; this suite's conftest turns it on in process), loaded
through importlib with its file constants pointed at the temp files and
its train_with_radiation_eval wrapped to write the loop's history as JSON.
The port runs in this process with --device cpu.

Held, port against JAX: each epoch's loss to rtol LOSS_RTOL; each epoch's
8 metrics within LW 2e-3 / SW 2e-2 (HR MAE in K/day, the others W/m2: the
flux bounds, which the metrics inherit); the best epoch; the saved file's
name; its weights, every one within 2 x steps x lr (one Adam step moves a
weight by about lr at most, so two runs whose gradient components near 0
take opposite signs part by at most that) and WEIGHT_SHARE of them within
WEIGHT_ATOL. Measured on this suite's CPU: losses within 4.7e-7 relative,
metrics within 1.7e-4 (LW) and 1.7e-3 (SW), every weight within 2.4e-7,
the file names equal. A run from the fresh init alone trains (below).
"""
import glob
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf, save_model_netcdf
from rte_rrtmgp_nn_tpu_torch.training.train import init_model
from rte_rrtmgp_nn_tpu_torch.utils import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
ART = os.path.join(ROOT, "artifacts")
LW_TEACHER = os.path.join(ART, "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc")
SW_TEACHER = os.path.join(ART, "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc")
NEXP, NSITES, NLAY = 11, 4, 60
EPOCHS, STEPS, PAIRS, HIDDEN, LR = 2, 3, 64, 16, 1e-3
LOSS_RTOL = 1e-5
METRIC_ATOL = {"lw": 2e-3, "sw": 2e-2}
WEIGHT_ATOL, WEIGHT_SHARE = 1e-5, 0.999

# loads a JAX script by path, sets its module constants, wraps
# train_with_radiation_eval to dump the loop's history, and runs main()
JAX_RUNNER = r"""
import importlib.util, json, sys
path, consts, argv, history = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]), sys.argv[4]
spec = importlib.util.spec_from_file_location("jax_script", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
for k, v in consts.items():
    setattr(mod, k, v)
if history:
    inner = mod.train_with_radiation_eval
    def wrapped(*a, **kw):
        result = inner(*a, **kw)
        with open(history, "w") as f:
            json.dump(result.history, f)
        return result
    mod.train_with_radiation_eval = wrapped
sys.argv = [path] + argv
sys.exit(mod.main() or 0)
"""


def run_jax(script: str, consts: dict, argv: list, cwd, history: str = "",
            ok: bool = True) -> subprocess.CompletedProcess:
    """scripts/<script> of the JAX package in a subprocess on the CPU with
    its module constants set to ``consts``; requires exit status 0 unless
    ``ok`` is False."""
    r = subprocess.run([sys.executable, "-c", JAX_RUNNER, os.path.join(SCRIPTS, script),
                        json.dumps(consts), json.dumps(argv), history], cwd=cwd,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
                       text=True, timeout=600)
    if ok:
        assert r.returncode == 0, r.stderr[-3000:]
    return r


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"port_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def saved_student(path: str, teacher_path: str) -> str:
    """A fresh HIDDEN-wide student of the teacher's widths and scalings,
    written where both packages load it."""
    t = load_model_netcdf(teacher_path, device="cpu")
    m = init_model([t.n_inputs, HIDDEN, HIDDEN, t.n_outputs], torch.Generator().manual_seed(0),
                   input_names=t.input_names, input_min=t.input_min, input_max=t.input_max,
                   output_mean=t.output_mean, output_std=t.output_std, device="cpu")
    save_model_netcdf(path, m)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    T.write_rfmip_file(str(d / "rfmip.nc"), NEXP, NSITES, NLAY, seed=0)
    (d / "models").mkdir()
    for name in cli.SW_MODEL_FILES:
        shutil.copy(SW_TEACHER, d / "models" / name)
    saved_student(str(d / "student-lw.nc"), LW_TEACHER)
    saved_student(str(d / "student-sw.nc"), SW_TEACHER)
    return d


DEMOS = {
    "lw": ("train_demo.py", "torch_train_demo",
           lambda d: {"TEACHER": LW_TEACHER, "RFMIP": str(d / "rfmip.nc")},
           lambda d: ["--teacher", LW_TEACHER, "--rfmip", str(d / "rfmip.nc")]),
    "sw": ("train_demo_sw.py", "torch_train_demo_sw",
           lambda d: {"T_ABS": str(d / "models" / cli.SW_MODEL_FILES[0]),
                      "T_RAY": str(d / "models" / cli.SW_MODEL_FILES[1]),
                      "RFMIP": str(d / "rfmip.nc")},
           lambda d: ["--models-dir", str(d / "models"), "--rfmip", str(d / "rfmip.nc")]),
}


def common_args(out_dir, init_from=None) -> list:
    args = ["--epochs", str(EPOCHS), "--steps-per-epoch", str(STEPS), "--batch-pairs",
            str(PAIRS), "--hidden", str(HIDDEN), "--lr", str(LR), "--out-dir", str(out_dir)]
    return args + (["--init-from", str(init_from)] if init_from else [])


def closing_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(("best radiation score", "vs teacher"))]


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_demo_matches_the_jax_script(files, band, capsys):
    jax_script, port_script, consts, paths = DEMOS[band]
    student = files / f"student-{band}.nc"
    hist = files / f"history-{band}.json"
    jout = run_jax(jax_script, consts(files), common_args(files / f"jax-{band}", student),
                   files, history=str(hist)).stdout
    capsys.readouterr()
    port = load_script(port_script).run(
        [*paths(files), *common_args(files / f"port-{band}", student), "--device", "cpu"])
    pout = capsys.readouterr().out
    jhist = json.loads(hist.read_text())
    assert len(port.history) == len(jhist) == EPOCHS
    for p, j in zip(port.history, jhist):
        assert p["epoch"] == j["epoch"]
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(p["metrics"], j["metrics"], rtol=0, atol=METRIC_ATOL[band])
    assert port.best_epoch == int(re.search(r"at epoch (\d+)", jout).group(1))
    # the lines a user reads: the epochs', the save's and the two closing ones
    epoch_line = re.compile(r"epoch \d+: loss [0-9.]+ radiation_score [0-9.]+")
    assert len(epoch_line.findall(pout)) == len(epoch_line.findall(jout)) == EPOCHS
    assert [ln.split()[:3] for ln in closing_lines(pout)] == \
        [ln.split()[:3] for ln in closing_lines(jout)] and len(closing_lines(pout)) == 2
    (jpath,) = glob.glob(str(files / f"jax-{band}" / "*.nc"))
    (ppath,) = glob.glob(str(files / f"port-{band}" / "*.nc"))
    assert os.path.basename(ppath) == os.path.basename(jpath)
    jm, pm = load_model_netcdf(jpath, device="cpu"), load_model_netcdf(ppath, device="cpu")
    assert pm.dims == jm.dims
    delta = torch.cat([(a - b).abs().flatten() for a, b in
                       zip([*pm.weights, *pm.biases], [*jm.weights, *jm.biases])])
    assert float(delta.max()) <= 2 * EPOCHS * STEPS * LR
    assert float((delta <= WEIGHT_ATOL).double().mean()) >= WEIGHT_SHARE


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_demo_from_the_fresh_init_trains(files, band, capsys):
    """Without --init-from, from the port's own He init (torch.Generator
    seed 0), 4 epochs of 30 steps: the loss falls; LW: the best epoch's
    radiation score beats epoch 0's; SW: the heating-rate MAE falls, while
    the TOA and the N2O / CH4 surface forcing biases (normalized by 0.2 and
    0.02 W/m2) grow over these first steps and the score with them, as the
    JAX script's do from the same init (ROADMAP Queue 3 F13). The best net
    is saved under the JAX template."""
    _, port_script, _, paths = DEMOS[band]
    out = files / f"fresh-{band}"
    args = ["--epochs", "4", "--steps-per-epoch", "30", "--batch-pairs", str(PAIRS),
            "--hidden", str(HIDDEN), "--out-dir", str(out), "--device", "cpu"]
    res = load_script(port_script).run([*paths(files), *args])
    h = res.history
    assert all(np.isfinite(e["score"]) for e in h) and h[-1]["loss"] < h[0]["loss"]
    if band == "lw":
        assert res.best_score < h[0]["score"]
    else:
        assert h[-1]["metrics"][0] < h[0]["metrics"][0]
    prefix = {"lw": "lw-g128-demo_both", "sw": "sw-g112-demo_absorption"}[band]
    (path,) = glob.glob(str(out / f"{prefix}_{HIDDEN}_{HIDDEN}_HR_*_FRC_*.nc"))
    assert load_model_netcdf(path, device="cpu").dims[1:3] == [HIDDEN, HIDDEN]


def test_lw_demo_refuses_a_student_of_another_width(files, capsys):
    """--init-from with a net whose hidden width is not --hidden exits with
    status 2 before training (the JAX script asserts)."""
    _, port_script, _, paths = DEMOS["lw"]
    args = common_args(files / "refused", files / "student-lw.nc")
    args[args.index("--hidden") + 1] = str(HIDDEN * 2)
    with pytest.raises(SystemExit) as e:
        load_script(port_script).run([*paths(files), *args, "--device", "cpu"])
    assert e.value.code == 2
    assert f"--init-from hidden size {HIDDEN} != --hidden {2 * HIDDEN}" in capsys.readouterr().err
