"""Field-by-field comparison of what tpinn and tpinn_torch build: problems
(ProblemSpec, SystemSpec), TrainSpecs and plain spec dataclasses.

Plain fields must be equal.  Callables (the analytic oracle, a BC group's
``value_fn``, a residual weight or mask) are evaluated on the same seeded
float32 points in both packages and held at rtol 1e-6, atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

RTOL = ATOL = 1e-6


def points(lo, hi, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(np.asarray(lo, float), np.asarray(hi, float),
                       (n, len(lo))).astype(np.float32)


def assert_close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got)),
                               np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def assert_problem_equal(tp, jp, n=64, seed=0):
    """Every field of a ProblemSpec or SystemSpec, callables on points."""
    names = [f.name for f in dataclasses.fields(jp)]
    assert [f.name for f in dataclasses.fields(tp)] == names
    z = points(jp.lb, jp.ub, n, seed)
    for name in names:
        a, b = getattr(tp, name), getattr(jp, name)
        if name == "bc_groups":
            assert len(a) == len(b)
            for k, (ga, gb) in enumerate(zip(a, b)):
                for f in dataclasses.fields(gb):
                    if f.name != "value_fn":
                        assert getattr(ga, f.name) == getattr(gb, f.name), \
                            (k, f.name)
                assert (ga.value_fn is None) == (gb.value_fn is None), k
                zg = points(gb.lo, gb.hi, n, seed + 1 + k)
                assert_close(ga.target(torch.from_numpy(zg)),
                             gb.target(jnp.asarray(zg)), f"group {k}")
        elif callable(a) or callable(b):
            assert callable(a) and callable(b), name
            assert_close(a(torch.from_numpy(z)), b(jnp.asarray(z)), name)
        else:
            assert a == b, (name, a, b)


# StageSpec fields of the port alone (its PirateNet), with their defaults:
# a port spec that tpinn can also build leaves them there
PORT_ONLY_STAGE = {"pirate_blocks": 0, "weight_fact": None}


def field_names(spec):
    """The dataclass's field names that tpinn's counterpart has."""
    return [f.name for f in dataclasses.fields(spec)
            if f.name not in PORT_ONLY_STAGE]


def tpinn_asdict(spec) -> dict:
    """``dataclasses.asdict`` of a port TrainSpec or StageSpec in tpinn's
    fields: each port-only StageSpec field is asserted at its default and
    left out."""
    d = dataclasses.asdict(spec)
    for st in d["stages"] if "stages" in d else [d]:
        for name, default in PORT_ONLY_STAGE.items():
            assert st.pop(name) == default, (name, st)
    return d


def assert_spec_equal(ts, js, skip=()):
    """Every field of a TrainSpec (its stages field by field) but those
    named in ``skip``."""
    names = [f.name for f in dataclasses.fields(js)]
    assert [f.name for f in dataclasses.fields(ts)] == names
    for name in names:
        if name in skip:
            continue
        a, b = getattr(ts, name), getattr(js, name)
        if name == "stages":
            assert [tpinn_asdict(s) for s in a] == [
                dataclasses.asdict(s) for s in b]
        else:
            assert a == b, (name, a, b)


def assert_dataclass_equal(a, b):
    """Two plain spec dataclasses (InverseSpec, PatchSpec) of the same
    fields and values."""
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def assert_same_argument(a, b):
    """One argument of a captured call: a problem, a TrainSpec, another
    spec dataclass or a plain value."""
    kind = type(b).__name__
    assert type(a).__name__ == kind
    if kind in ("ProblemSpec", "SystemSpec"):
        assert_problem_equal(a, b)
    elif kind == "TrainSpec":
        assert_spec_equal(a, b)
    elif dataclasses.is_dataclass(b):
        assert_dataclass_equal(a, b)
    else:
        assert a == b
