"""The port's command line (``tpinn_torch.cli``, ``python -m tpinn_torch``)
against tpinn's, on the CPU.

- ``problems`` prints tpinn's lines, line for line.
- ``train`` (plain, ``--stages 2``, ``--recipe``, ``--ensemble``,
  ``--march``, ``--patches``), ``invert`` and ``system``: both packages'
  training entries replaced by stubs, the same command line through both
  CLIs (the port's with ``--device cpu``), and the captured calls held
  against each other: the same entry, problem, TrainSpec (``pad_features``
  included: the CLI keeps tpinn's flag and its default of 3), InverseSpec
  or PatchSpec, window count and keyword arguments, and the same JSON
  line.  Problems are compared field by field with their callables on
  seeded float32 points at rtol 1e-6, atol 1e-6
  (tests/torch_spec_compare.py).
- ``--checkpoint-every 5`` raises the NotImplementedError that cites
  ROADMAP.md item 9; ``serve`` and ``app`` hand over with ``--device``.
- ``python -m tpinn_torch problems`` in a subprocess, which loads no
  module of jax or tpinn.
"""

import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import tpinn.cli as jcli
import tpinn.core.ensemble as jensemble
import tpinn.core.inverse as jinverse
import tpinn.core.march as jmarch
import tpinn.core.patch as jpatch
import tpinn.core.system as jsystem
import tpinn.core.train as jtrain
import tpinn_torch.cli as tcli
import tpinn_torch.core.ensemble as tensemble
import tpinn_torch.core.inverse as tinverse
import tpinn_torch.core.march as tmarch
import tpinn_torch.core.patch as tpatch
import tpinn_torch.core.system as tsystem
import tpinn_torch.core.train as ttrain
from torch_spec_compare import assert_same_argument

REPO = Path(__file__).resolve().parent.parent
ENTRIES = ("run_training", "run_time_marching", "run_ensemble_training",
           "run_patched", "run_inverse", "run_system")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_problems_lines_equal_tpinn(capsys):
    jcli.main(["problems"])
    want = capsys.readouterr().out
    tcli.main(["problems"])
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 16      # 13 presets, 3 systems


def _window(rel_l2):
    return types.SimpleNamespace(rel_l2=rel_l2)


RESULT = types.SimpleNamespace(
    rel_l2=0.25, history=np.arange(15.0).reshape(3, 5),
    windows=[_window(0.5), _window(0.75)], rel_l2_members=[0.5, 0.125],
    weights=np.array([0.25, 0.75]), coef={"lam": 0.875},
    coef_adam={"lam": 0.625}, rel_l2_fields=(0.1, 0.2, 0.3))


@pytest.fixture
def captured(monkeypatch):
    """Both packages' training entries replaced by stubs that record their
    arguments: {"port": [...], "tpinn": [...]} of (name, args, kwargs)."""
    calls = {"port": [], "tpinn": []}

    def stub(pkg, name):
        def record(*args, **kwargs):
            calls[pkg].append((name, args, kwargs))
            return RESULT
        return record

    for pkg, mods in (
            ("port", (ttrain, tmarch, tensemble, tpatch, tinverse, tsystem)),
            ("tpinn", (jtrain, jmarch, jensemble, jpatch, jinverse,
                       jsystem))):
        for mod, name in zip(mods, ENTRIES):
            monkeypatch.setattr(mod, name, stub(pkg, name))
    return calls


ARGV = {
    "train": ["train", "--problem", "poisson_2d", "--adam", "30",
              "--lbfgs", "9", "--depth", "3", "--width", "16", "--out",
              "runs/p2d"],
    "train_two_stages": ["train", "--problem", "annulus_laplace",
                         "--stages", "2", "--n-col", "500", "--seed", "7",
                         "--weight-f", "0.05", "--f64-polish", "--resume"],
    "train_pad_0": ["train", "--problem", "burgers_1d", "--pad-features",
                    "0", "--weight-df", "0.5", "--n-band", "0"],
    "recipe": ["train", "--problem", "annulus_laplace", "--recipe",
               "--adam", "1"],
    "recipe_heat": ["train", "--problem", "heat_2d", "--recipe"],
    "recipe_march": ["train", "--problem", "convection_1d", "--recipe"],
    "recipe_ensemble": ["train", "--problem", "poisson_1d", "--recipe",
                        "--ensemble", "2"],
    "ensemble": ["train", "--problem", "heat_2d", "--ensemble", "3",
                 "--out", "runs/ens"],
    "march": ["train", "--problem", "heat_2d", "--march", "4"],
    "march_axis": ["train", "--problem", "wave_1d", "--march", "2",
                   "--march-axis", "t", "--stages", "2"],
    "patches": ["train", "--problem", "helmholtz_2d", "--patches", "6x6"],
    "patches_1d": ["train", "--problem", "poisson_1d", "--patches", "8",
                   "--depth", "2", "--width", "16"],
    "invert": ["invert", "--problem", "heat_2d", "--equation",
               "u_t - lam*u_xx", "--param", "lam=0.3", "--out", "runs/inv"],
    "invert_two": ["invert", "--problem", "poisson_2d", "--equation",
                   "k*u_xx + m*u_yy + 2*pi**2*sin(pi*x)*sin(pi*y)",
                   "--param", "k=0.5", "--param", " m =2", "--n-obs", "64",
                   "--obs-noise", "0.01", "--obs-weight", "2",
                   "--obs-seed", "3"],
    "invert_eigen": ["invert", "--problem", "poisson_1d", "--equation",
                     "u_xx + lam*u", "--param", "lam=8", "--normalize",
                     "0.5"],
    "system": ["system", "--name", "kovasznay", "--adam", "20"],
    "system_recipe": ["system", "--name", "taylor_green", "--recipe",
                      "--out", "runs/tg"],
    "system_recipe_seed": ["system", "--name", "kovasznay", "--recipe",
                           "--seed", "5", "--n-band", "10",
                           "--weight-f", "0.5"],
}


@pytest.mark.parametrize("case", list(ARGV))
def test_cli_builds_tpinns_specs(case, captured, capsys):
    jcli.main(ARGV[case])
    want = capsys.readouterr().out
    tcli.main(ARGV[case] + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert json.loads(got) == json.loads(want)
    (name_t, args_t, kw_t), = captured["port"]
    (name_j, args_j, kw_j), = captured["tpinn"]
    assert name_t == name_j
    assert kw_t.pop("device") == "cpu"
    assert kw_t == kw_j
    assert len(args_t) == len(args_j)
    for a, b in zip(args_t, args_j):
        assert_same_argument(a, b)


@pytest.mark.parametrize("argv", [
    ["train", "--problem", "heat_2d", "--recipe", "--patches", "2x2"],
    ["train", "--problem", "heat_2d", "--march", "2", "--ensemble", "2"],
    ["invert", "--problem", "heat_2d", "--equation", "u_t - lam*u_xx",
     "--param", "lam"],
    ["system", "--name", "no_such_system"],
])
def test_cli_refuses_as_tpinn(argv, captured):
    raised = []
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises((SystemExit, KeyError)) as e:
            main(argv + extra)
        raised.append((e.type, str(e.value)))
    assert raised[0] == raised[1]
    assert captured == {"port": [], "tpinn": []}


def test_spec_functions_are_the_cli_path():
    """train_spec, invert_spec and system_spec return what `train`,
    `invert` and `system` train (held against tpinn above): their fields
    on a parsed command line."""
    parse = tcli.build_parser().parse_args
    problem, spec = tcli.train_spec(parse(ARGV["patches"]))
    assert problem.name == "helmholtz_2d" and spec.pad_features == 3
    assert (spec.stages[0].depth, spec.stages[0].width) == (6, 50)
    problem, inv, spec = tcli.invert_spec(parse(ARGV["invert_eigen"]))
    assert problem.exact is None and inv.normalize == 0.5
    assert inv.params == ("lam",) and inv.init == (8.0,)
    problem, spec = tcli.system_spec(parse(ARGV["system_recipe"]))
    assert (spec.n_col, spec.stages[0].adam_epochs) == (8000, 10000)
    assert parse(["train", "--problem", "x"]).device == "cuda"


@pytest.mark.parametrize("extra", [[], ["--recipe"]])
def test_checkpoint_every_raises_item_9(extra, tmp_path, capsys):
    """--checkpoint-every, refused before mid-Adam checkpoints were
    ported (item 9), now works: without --recipe a run writes
    adam_state_stage_1.npz and --resume continues from it; with --recipe
    the recipe's spec takes the field (checked without training it)."""
    argv = ["train", "--problem", "poisson_1d", "--checkpoint-every", "5",
            "--device", "cpu"] + extra
    if extra:
        from tpinn_torch import problems

        _, spec = tcli.train_spec(tcli.build_parser().parse_args(argv))
        _, recipe = problems.get_recipe("poisson_1d")
        assert spec == dataclasses.replace(recipe, checkpoint_every=5)
        return
    out = tmp_path / "run"
    argv += ["--adam", "12", "--lbfgs", "3", "--depth", "2", "--width",
             "8", "--n-col", "64", "--n-band", "16", "--n-adaptive", "16",
             "--n-bd", "8", "--out", str(out)]
    tcli.main(argv)
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    state = np.load(out / "adam_state_stage_1.npz")
    assert json.loads(bytes(state["__meta__"]).decode())["done"] == 12
    (out / "params_stage_1.npz").unlink()
    tcli.main(argv + ["--resume"])
    captured = capsys.readouterr()
    assert "resuming Adam mid-stage at step 12/12" in captured.err
    again = json.loads(captured.out.strip().splitlines()[-1])
    assert again["rel_l2"] == first["rel_l2"]


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["train", "--problem", "poisson_1d", "--adam", "1"])


def test_serve_and_app_hand_over_with_the_device(monkeypatch):
    import tpinn_torch.app.lite as lite
    import tpinn_torch.app.serve as serve

    seen = []
    monkeypatch.setattr(serve, "main", lambda: seen.append(list(sys.argv)))
    monkeypatch.setattr(lite, "serve", lambda **kw: seen.append(kw))
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    tcli.main(["serve", "--checkpoint", "c.npz", "--problem", "poisson_1d",
               "--device", "cpu"])
    tcli.main(["serve", "--checkpoint", "sys.npz", "--port", "9000"])
    tcli.main(["app", "--port", "8123", "--data-root", "d"])
    assert seen == [
        ["serve", "--checkpoint", "c.npz", "--port", "8060", "--device",
         "cpu", "--problem", "poisson_1d"],
        ["serve", "--checkpoint", "sys.npz", "--port", "9000", "--device",
         "cuda"],
        {"port": 8123, "data_root": "d", "device": "cuda"}]


def test_module_entry_loads_no_jax(capsys):
    """`python -m tpinn_torch problems` prints tpinn's lines; it and every
    module of the calculator and the CLI load neither jax nor tpinn."""
    jcli.main(["problems"])
    want = capsys.readouterr().out.splitlines()
    out = subprocess.run([sys.executable, "-m", "tpinn_torch", "problems"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == want
    code = ("import sys, runpy; sys.argv = ['tpinn_torch', 'problems']; "
            "runpy.run_module('tpinn_torch', run_name='__main__'); "
            "import tpinn_torch.cli, tpinn_torch.app, tpinn_torch.app.lite, "
            "tpinn_torch.app.controller, tpinn_torch.app.figure_data, "
            "tpinn_torch.app.presets, tpinn_torch.utils.logging; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'tpinn')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "[]"
