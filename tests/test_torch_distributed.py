"""The port's training entry points on a mesh: two gloo ranks on the CPU.

Every rank runs the same ``run_*`` call with a ``(1, 2)`` mesh from
``tpinn_torch.parallel.make_mesh`` (``(2, 1)`` for the patch-parallel
case) in a subprocess worker (tests/torch_mesh_worker.py, suite "runs",
one launch for every case, a timeout on it, torch on one thread), as
tpinn's multi-process launch does (tests/test_distributed.py).  Each
case, at a size that is quick in torch: the ranks end with bitwise equal
parameters, rank 0 alone writes files (every npz write counted), the
first loss rows are within rtol 1e-5 of one process at the same counts
(the shards' partial sums change order, so later rows drift apart), and
the run is finite.  The cases: tpinn's meshed run_training
(test_run_training_with_mesh, with mid-stage checkpoints) and run_system
(the inverse oscillator), run_inverse (heat's diffusivity),
run_time_marching with causal weighting (its first window's rows),
run_ensemble_training (its first member's), and the two mesh cases of
tests/test_patch.py (points mesh; patches split over the ensemble axis).
Then the run_training case resumed on its mesh from its phase file (bit
for bit), and tests/test_distributed.py's two-process multislice
gradient.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_mesh_worker as W  # noqa: E402

FIRST_ROWS = 5
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_runs")
    return root, W.launch("runs", 2, root, timeout=300)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """Each case in this process, unmeshed, at the same counts."""
    root = tmp_path_factory.mktemp("single_runs")
    out = {}
    for name in W.RUNS:
        hist, params, rel, _ = W.run_entry(name, None, root / name)
        out[name] = (np.asarray(hist), W.digest(params), rel)
    return root, out


@pytest.mark.parametrize("name", W.RUNS)
def test_meshed_run_matches_one_process(meshed, single, name):
    _, ranks = meshed
    (s0, a0), (s1, a1) = ranks
    assert s0[name]["digest"] == s1[name]["digest"]
    np.testing.assert_array_equal(a0[f"{name}/history"],
                                  a1[f"{name}/history"])
    assert s0[name]["writes"] > 0 and s1[name]["writes"] == 0
    hist1, _, rel1 = single[1][name]
    hist = a0[f"{name}/history"]
    assert hist.shape[1] == hist1.shape[1]
    np.testing.assert_allclose(hist[:FIRST_ROWS], hist1[:FIRST_ROWS],
                               rtol=RTOL, atol=1e-7)
    assert np.isfinite(hist).all()
    assert s0[name]["rel_l2"] is not None and np.isfinite(s0[name]["rel_l2"])
    assert rel1 is not None and np.isfinite(rel1)
    assert s0[name]["sharded"] == (name == "patch_ensemble")


def test_meshed_files_match_one_process(meshed, single):
    """Rank 0's files are the one-process run's set, and the mid-stage
    phase file holds the GLOBAL point set (a resume on any mesh reads
    it)."""
    root, _ = meshed
    root1, _ = single
    for name in W.RUNS:
        got = sorted(p.relative_to(root / name).as_posix()
                     for p in (root / name).rglob("*") if p.is_file())
        want = sorted(p.relative_to(root1 / name).as_posix()
                      for p in (root1 / name).rglob("*") if p.is_file())
        assert got == want, name
    with np.load(root / "train" / "adam_state_stage_1.npz") as a, \
            np.load(root1 / "train" / "adam_state_stage_1.npz") as b:
        assert a["leaf:data/x_col"].shape == b["leaf:data/x_col"].shape
        assert json.loads(bytes(a["__meta__"]).decode())["done"] == 40


def test_meshed_resume_from_the_global_phase_file(meshed):
    """The train case run again with resume=True from its phase file (the
    end of its Adam loop) on the same mesh: it resumes at step 40 and ends
    with the uninterrupted run's parameters, bit for bit, on both ranks."""
    _, ranks = meshed
    for summary, _ in ranks:
        assert summary["train_resumed"]["resumed"]
        assert summary["train_resumed"]["digest"] == summary["train"]["digest"]


def test_two_process_multislice_gradient_matches(meshed):
    """tests/test_distributed.py's check: each process stands in for one
    slice of make_multislice_mesh, and the sharded gradient equals one
    process's; both controllers hold the same replicated gradient."""
    _, ranks = meshed
    (s0, a0), (s1, a1) = ranks
    assert s0["multislice"]["shape"] == {"ensemble": 1, "points": 2}
    assert s0["multislice"]["ranks"] == [[0, 1]]
    assert s0["multislice"]["checksum"] == s1["multislice"]["checksum"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 3)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((3, 16)) / 4)
                          .astype(np.float32)).requires_grad_(True)
    w2 = torch.from_numpy((rng.standard_normal((16, 1)) / 4)
                          .astype(np.float32)).requires_grad_(True)
    val = torch.mean((torch.tanh(x @ w1) @ w2) ** 2)
    g1, g2 = torch.autograd.grad(val, (w1, w2))
    want = torch.cat([g1.reshape(-1), g2.reshape(-1)]).numpy()
    assert float(np.abs(a0["multislice/grad"] - want).max()) < 1e-6
