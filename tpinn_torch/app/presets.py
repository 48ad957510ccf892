"""UI payloads for the problem presets: autofill values for the web form
(tpinn.app.presets over ``tpinn_torch.problems``).

Maps each ProblemSpec onto the reference UI's field schema (equation,
domain box, BC groups with numeric-or-expression u values, sensible
training defaults).  1-D presets are expressed on an (x, t) product domain
— the solution is constant along the dummy axis, which the solver handles
naturally.
"""

from __future__ import annotations

from typing import Dict, List

from tpinn_torch import problems


def _bc_entry(grp, dim: int) -> Dict:
    lo = list(grp.lo) + [0.0] * (2 - dim)
    hi = list(grp.hi) + [1.0] * (2 - dim)
    u = grp.value_expr if grp.value_expr is not None else grp.value
    return {"x_min": lo[0], "x_max": hi[0], "y_min": lo[1], "y_max": hi[1],
            "u": u}


def preset_payload(name: str) -> Dict:
    p = problems.get_problem(name)
    dim = p.dim
    # fold a separate forcing term into the equation via "lhs = rhs" so the
    # UI's single equation box carries the full residual
    equation = f"{p.equation} = {p.source}" if p.source else p.equation
    payload = {
        "name": name,
        "equation": equation,
        "domain": {
            "x_min": p.lb[0], "x_max": p.ub[0],
            "y_min": p.lb[1] if dim == 2 else 0.0,
            "y_max": p.ub[1] if dim == 2 else 1.0,
        },
        "bcs": [_bc_entry(g, dim) for g in p.bc_groups],
        "scl": 1.0,
        "epsil": 1.0,
        "has_oracle": p.exact is not None,
        "train": _recipe_train_fields(name),
    }
    return payload


def _recipe_train_fields(name: str) -> Dict | None:
    """UI training-field autofill from the preset's best-known recipe
    (tpinn_torch/problems/recipes.py).  Only the fields the reference form
    schema can carry; the full recipe (VP rounds, polish, Fourier
    features, curricula) is the --recipe CLI path.  The rel-L2 in the note
    is tpinn's record of the recipe on a TPU (Recipe.expected_rel_l2)."""
    from tpinn_torch.problems.recipes import RECIPES

    rec = RECIPES.get(name)
    if rec is None:
        return None
    s1 = rec.spec.stages[0]
    return {
        "n_col": rec.spec.n_col, "n_bd": rec.spec.n_bd,
        "n_add": rec.spec.n_adaptive,
        # the UI keeps the reference's swapped network_size keys
        # (software.py:667-668 + :193 — "depth" is units/layer):
        "depth": s1.width, "width": s1.depth,
        "adam": s1.adam_epochs, "lbfgs": s1.lbfgs_epochs,
        "wf": rec.spec.lw[0], "wdf": rec.spec.lw[1],
        "lsq_polish": rec.spec.lsq_polish,
        "deflation": rec.spec.deflation,
        "note": (f"Recipe prefilled (run {rec.run_tag}, "
                 f"{rec.expected_rel_l2:.1e} rel-L2 on TPU). Full recipe "
                 f"incl. VP polish/curriculum: python -m tpinn_torch train "
                 f"--problem {name} --recipe"),
    }


def _ui_expressible(p) -> bool:
    """The web form carries a 2-D box, numeric-or-expression DIRICHLET BC
    values and an optional residual-weight expression: presets with d >= 3,
    callable masks (non-box domains), value_fn-only BC groups, or operator
    (non-Dirichlet) groups — wave_1d's u_t velocity IC — are CLI/API-only
    (the reference form is Dirichlet-only too, software.py:283-297)."""
    if p.dim > 2:
        return False
    if callable(p.residual_weight) or p.eval_mask is not None:
        return False
    return all((g.value_fn is None or g.value_expr is not None)
               and g.operator is None
               for g in p.bc_groups)


def preset_names() -> List[str]:
    return sorted(
        n for n in problems.PRESETS if _ui_expressible(problems.get_problem(n))
    )


def oracle_names() -> List[str]:
    """Presets usable as UI inverse-mode observation oracles: exactly 2-D
    (the UI problem is always 2-D; run_pinn_training rejects a dimension
    mismatch) with an analytic solution to label observations.  The ONE
    source the page renders from."""
    return sorted(
        n for n in problems.PRESETS
        if problems.get_problem(n).exact is not None
        and problems.get_problem(n).dim == 2
    )
