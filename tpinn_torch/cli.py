"""Command-line interface of the port: train presets, identify
coefficients, train systems, launch the calculator, serve checkpoints.

    python -m tpinn_torch train --problem poisson_2d --adam 8000 \
        --lbfgs 3000 --out out/poisson2d [--stages 2] [--f64-polish] \
        [--resume] [--device cuda]
    python -m tpinn_torch problems            # list presets
    python -m tpinn_torch app [--port 8050]   # the online PDE calculator
    python -m tpinn_torch serve --checkpoint out/params_stage_1.npz \
        --problem poisson_2d
    python -m tpinn_torch invert --problem heat_2d \
        --equation "u_t - lam*u_xx" --param lam=0.3

The subcommands, flags and defaults are tpinn's (``tpinn.cli``), with
``--device`` (default "cuda"; "cuda" fails without a card) for
``--platform``.  ``train_spec``, ``invert_spec`` and ``system_spec`` build
what a ``train``, ``invert`` or ``system`` command line trains, so that
other code builds a CLI configuration in this one place.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def cmd_problems(args):
    from tpinn_torch import problems
    from tpinn_torch.problems.recipes import RECIPES
    from tpinn_torch.problems.systems import SYSTEM_PRESETS

    for name in sorted(problems.PRESETS):
        p = problems.PRESETS[name]()
        rec = RECIPES.get(name)
        gate = (f"   recipe: {rec.expected_rel_l2:.1e} rel-L2 "
                f"(run {rec.run_tag})" if rec else "")
        print(f"{name:18s} {p.equation}   coords={p.coords} "
              f"domain={list(zip(p.lb, p.ub))}{gate}")

    for name in sorted(SYSTEM_PRESETS):
        s = SYSTEM_PRESETS[name]()
        eqs = "; ".join(s.equations)
        print(f"{name:18s} [system {'/'.join(s.fields)}] {eqs}   "
              f"coords={s.coords} domain={list(zip(s.lb, s.ub))}")


def train_spec(args):
    """(problem, TrainSpec) of a ``train`` command line: the preset's
    recipe with ``--recipe`` (sizing flags ignored), else one stage of
    ``--depth`` x ``--width`` (a second 6x50 sin stage with ``--stages
    2``)."""
    from tpinn_torch import problems
    from tpinn_torch.core.train import StageSpec, TrainSpec

    if args.recipe and args.patches:
        raise SystemExit("--recipe and --patches are exclusive: recipes "
                         "are single-net configs (drop one)")
    if args.march and (args.patches or args.ensemble > 1 or args.recipe):
        raise SystemExit("--march composes windows sequentially; combine "
                         "it with --patches/--ensemble/--recipe per "
                         "window is not supported (drop one)")
    if args.recipe:
        problem, spec = problems.get_recipe(args.problem)
        if args.checkpoint_every > 0:
            spec = dataclasses.replace(
                spec, checkpoint_every=args.checkpoint_every)
        return problem, spec

    stages = [StageSpec(depth=args.depth, width=args.width, scl=1.0,
                        epsil=1.0, adam_epochs=args.adam,
                        lbfgs_epochs=args.lbfgs)]
    if args.stages == 2:
        stages.append(StageSpec(depth=6, width=50, act_first="sin",
                                adam_epochs=3 * args.adam,
                                lbfgs_epochs=3 * args.lbfgs,
                                sample_scale=2.0))
    spec = TrainSpec(
        n_col=args.n_col, n_band=args.n_band, n_adaptive=args.n_adaptive,
        n_bd=args.n_bd, lw=(args.weight_f, args.weight_df),
        stages=tuple(stages), seed=args.seed,
        pad_features=args.pad_features,
        lbfgs_dtype="float64" if args.f64_polish else None,
        checkpoint_every=args.checkpoint_every,
    )
    return problems.get_problem(args.problem), spec


def cmd_train(args):
    from tpinn_torch.core import train

    problem, spec = train_spec(args)
    run = dict(output_dir=args.out, print_log=True, resume=args.resume,
               device=args.device)
    if args.ensemble > 1:
        from tpinn_torch.core.ensemble import run_ensemble_training

        res = run_ensemble_training(problem, spec, n_members=args.ensemble,
                                    **run)
        print(json.dumps({
            "problem": args.problem,
            **({"recipe": True} if args.recipe else {}),
            "ensemble": args.ensemble,
            "rel_l2": res.rel_l2,
            "rel_l2_members": res.rel_l2_members,
            "weights": [float(v) for v in res.weights],
        }))
        return
    if args.recipe:
        from tpinn_torch.problems.recipes import find_recipe

        rec_march = find_recipe(args.problem)[1].march
        if rec_march:
            from tpinn_torch.core.march import run_time_marching

            mres = run_time_marching(problem, spec, rec_march, **run)
            print(json.dumps({
                "problem": args.problem, "recipe": True,
                "march": rec_march, "rel_l2": mres.rel_l2,
                "rel_l2_windows": [r.rel_l2 for r in mres.windows],
            }))
            return
        res = train.run_training(problem, spec, **run)
        print(json.dumps({
            "problem": args.problem, "recipe": True,
            "rel_l2": res.rel_l2,
            "steps": int(res.history.shape[0]),
        }))
        return
    if args.march:
        from tpinn_torch.core.march import run_time_marching

        res = run_time_marching(problem, spec, args.march,
                                axis=args.march_axis, **run)
        print(json.dumps({
            "problem": args.problem, "march": args.march,
            "axis": args.march_axis,
            "rel_l2": res.rel_l2,
            "rel_l2_windows": [r.rel_l2 for r in res.windows],
        }))
        return
    if args.patches:
        from tpinn_torch.core.patch import PatchSpec, run_patched

        n = tuple(int(v) for v in args.patches.lower().split("x"))
        res = run_patched(problem, spec, PatchSpec(n=n), **run)
        print(json.dumps({
            "problem": args.problem, "patches": list(n),
            "rel_l2": res.rel_l2,
        }))
        return
    res = train.run_training(problem, spec, **run)
    print(json.dumps({
        "problem": args.problem,
        "rel_l2": res.rel_l2,
        "final_loss": float(res.history[-1, 0]) if len(res.history) else None,
        "steps": int(res.history.shape[0]),
    }))


def invert_spec(args):
    """(problem, InverseSpec, TrainSpec) of an ``invert`` command line:
    the preset with its equation replaced by ``--equation`` (in eigen
    mode, ``--normalize`` > 0, its oracle dropped: it solves the original
    equation), one stage of ``--depth`` x ``--width`` on 3 padded
    features."""
    from tpinn_torch import problems
    from tpinn_torch.core.inverse import InverseSpec
    from tpinn_torch.core.train import StageSpec, TrainSpec

    names, inits = [], []
    for spec_str in args.param:
        if "=" not in spec_str:
            raise SystemExit(f"--param expects NAME=INIT, got {spec_str!r}")
        n, v = spec_str.split("=", 1)
        names.append(n.strip())
        inits.append(float(v))

    problem = dataclasses.replace(problems.get_problem(args.problem),
                                  equation=args.equation)
    if args.normalize > 0:
        problem = dataclasses.replace(problem, exact=None)
    inv = InverseSpec(params=tuple(names), init=tuple(inits),
                      n_obs=args.n_obs, obs_noise=args.obs_noise,
                      obs_weight=args.obs_weight, obs_seed=args.obs_seed,
                      normalize=args.normalize)
    spec = TrainSpec(
        n_col=args.n_col, n_band=args.n_band, n_adaptive=args.n_adaptive,
        n_bd=args.n_bd, lw=(args.weight_f, 0.0), seed=args.seed,
        pad_features=3,
        stages=(StageSpec(depth=args.depth, width=args.width, scl=1.0,
                          epsil=1.0, adam_epochs=args.adam,
                          lbfgs_epochs=args.lbfgs),),
    )
    return problem, inv, spec


def cmd_invert(args):
    from tpinn_torch.core.inverse import run_inverse

    problem, inv, spec = invert_spec(args)
    res = run_inverse(problem, inv, spec, print_log=True,
                      output_dir=args.out, device=args.device)
    print(json.dumps({
        "problem": args.problem, "equation": args.equation,
        "coef": res.coef, "coef_adam": res.coef_adam,
        "rel_l2": res.rel_l2, "n_obs": args.n_obs,
        "obs_noise": args.obs_noise,
    }))


_SYSTEM_SIZING = ("adam", "lbfgs", "depth", "width", "n_col", "n_adaptive",
                  "n_bd")


def system_spec(args):
    """(SystemSpec, TrainSpec) of a ``system`` command line: one stage on
    3 padded features, sized by the flags or, with ``--recipe``, by
    ``SYSTEM_RECIPES[--name]``."""
    from tpinn_torch.core.train import StageSpec, TrainSpec
    from tpinn_torch.problems.systems import SYSTEM_RECIPES, get_system

    problem = get_system(args.name)
    size = {k: getattr(args, k) for k in _SYSTEM_SIZING}
    if args.recipe:
        rec = SYSTEM_RECIPES.get(args.name)
        if rec is None:
            raise SystemExit(f"no system recipe for {args.name!r}")
        size = {k: rec[k] for k in _SYSTEM_SIZING}
    spec = TrainSpec(
        n_col=size["n_col"], n_band=args.n_band,
        n_adaptive=size["n_adaptive"], n_bd=size["n_bd"],
        lw=(args.weight_f, 0.0), seed=args.seed, pad_features=3,
        stages=(StageSpec(depth=size["depth"], width=size["width"], scl=1.0,
                          epsil=1.0, adam_epochs=size["adam"],
                          lbfgs_epochs=size["lbfgs"]),),
    )
    return problem, spec


def cmd_system(args):
    from tpinn_torch.core.system import run_system

    problem, spec = system_spec(args)
    res = run_system(problem, spec, print_log=True, output_dir=args.out,
                     device=args.device)
    print(json.dumps({
        "system": args.name, "rel_l2": res.rel_l2,
        "rel_l2_fields": (list(res.rel_l2_fields)
                          if res.rel_l2_fields else None),
    }))


def cmd_app(args):
    from tpinn_torch.app import lite

    lite.serve(port=args.port, data_root=args.data_root, device=args.device)


def cmd_serve(args):
    from tpinn_torch.app import serve as serve_mod

    sys.argv = ["serve", "--checkpoint", args.checkpoint, "--port",
                str(args.port), "--device", args.device]
    if args.problem:
        sys.argv += ["--problem", args.problem]
    serve_mod.main()


def _device(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' fails without a card")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpinn_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("problems", help="list problem presets")

    t = sub.add_parser("train", help="train a preset")
    t.add_argument("--problem", required=True)
    t.add_argument("--adam", type=int, default=8000)
    t.add_argument("--lbfgs", type=int, default=3000)
    t.add_argument("--depth", type=int, default=6)
    t.add_argument("--width", type=int, default=50)
    t.add_argument("--stages", type=int, default=1, choices=(1, 2))
    t.add_argument("--n-col", type=int, default=3000)
    t.add_argument("--n-band", type=int, default=500)
    t.add_argument("--n-adaptive", type=int, default=1000)
    t.add_argument("--n-bd", type=int, default=100)
    t.add_argument("--weight-f", type=float, default=1.0)
    t.add_argument("--weight-df", type=float, default=0.0)
    t.add_argument("--seed", type=int, default=1234)
    t.add_argument("--out", default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--checkpoint-every", type=int, default=0,
                   help="save resumable mid-Adam state every N steps "
                        "(TrainSpec.checkpoint_every); 0 = final params "
                        "only. With --resume, a killed run restarts at "
                        "the last saved chunk")
    t.add_argument("--f64-polish", action="store_true")
    _device(t)
    t.add_argument("--recipe", action="store_true",
                   help="use the preset's best-known gate-meeting config "
                        "(tpinn_torch.problems.get_recipe); sizing flags "
                        "ignored")
    t.add_argument("--pad-features", type=int, default=3,
                   help="FeatureMap.pad_to minimum input width (tpinn's "
                        "default 3, model class unchanged; 0 disables)")
    t.add_argument("--patches", default=None,
                   help="overlapping-patch decomposition (FBPINN-style): "
                        "patches per axis, e.g. '8' (1-D) or '4x4' (2-D); "
                        "the --depth/--width net is PER PATCH")
    t.add_argument("--ensemble", type=int, default=1,
                   help="train K seed-varied members and serve their "
                        "residual-min-norm convex combination "
                        "(core.ensemble.run_ensemble_training); the "
                        "combination record lands in OUT/ensemble.json")
    t.add_argument("--march", type=int, default=0,
                   help="time-marching (seq2seq): train N sequential "
                        "windows along --march-axis, each handed the "
                        "previous window's terminal state as its IC "
                        "(core.march.run_time_marching); the composite "
                        "record lands in OUT/march.json")
    t.add_argument("--march-axis", default="t",
                   help="evolution coordinate for --march")

    i = sub.add_parser(
        "invert",
        help="identify unknown PDE coefficients from observations "
             "(tpinn_torch.core.inverse): the preset supplies domain/BCs/"
             "oracle, --equation restates the physics with named unknowns, "
             "--param NAME=INIT declares them")
    i.add_argument("--problem", required=True,
                   help="preset providing domain/BCs/analytic solution")
    i.add_argument("--equation", required=True,
                   help="equation with unknown coefficients, e.g. "
                        "'u_t - lam*u_xx'")
    i.add_argument("--param", action="append", required=True,
                   metavar="NAME=INIT",
                   help="unknown coefficient + initial guess (repeatable)")
    i.add_argument("--n-obs", type=int, default=200)
    i.add_argument("--normalize", type=float, default=0.0,
                   help="EIGEN mode: > 0 replaces observations with a "
                        "mean-square amplitude pin (e.g. 0.5 for sin "
                        "eigenfunctions); the unknown coefficient "
                        "converges to an eigenvalue near its init")
    i.add_argument("--obs-noise", type=float, default=0.0)
    i.add_argument("--obs-weight", type=float, default=1.0)
    i.add_argument("--obs-seed", type=int, default=0)
    i.add_argument("--adam", type=int, default=4000)
    i.add_argument("--lbfgs", type=int, default=3000)
    i.add_argument("--depth", type=int, default=4)
    i.add_argument("--width", type=int, default=32)
    i.add_argument("--n-col", type=int, default=2000)
    i.add_argument("--n-band", type=int, default=0)
    i.add_argument("--n-adaptive", type=int, default=500)
    i.add_argument("--n-bd", type=int, default=100)
    i.add_argument("--weight-f", type=float, default=1.0)
    i.add_argument("--seed", type=int, default=1234)
    _device(i)
    i.add_argument("--out", default=None,
                   help="write a servable checkpoint (params_stage_1.npz "
                        "with the identified equation/coefficients in the "
                        "meta) + inverse.json record")

    y = sub.add_parser(
        "system",
        help="train a coupled-system benchmark preset "
             "(tpinn_torch.core.system; e.g. Navier-Stokes Kovasznay flow)")
    y.add_argument("--name", required=True,
                   help="system preset (see `problems`)")
    y.add_argument("--adam", type=int, default=6000)
    y.add_argument("--lbfgs", type=int, default=4000)
    y.add_argument("--depth", type=int, default=5)
    y.add_argument("--width", type=int, default=64)
    y.add_argument("--n-col", type=int, default=4000)
    y.add_argument("--n-band", type=int, default=0)
    y.add_argument("--n-adaptive", type=int, default=1000)
    y.add_argument("--n-bd", type=int, default=150)
    y.add_argument("--weight-f", type=float, default=1.0)
    y.add_argument("--seed", type=int, default=1234)
    y.add_argument("--recipe", action="store_true",
                   help="use the preset's best-known measured config "
                        "(problems.systems.SYSTEM_RECIPES)")
    _device(y)
    y.add_argument("--out", default=None,
                   help="write a servable multi-field checkpoint + "
                        "system.json record")

    a = sub.add_parser("app", help="launch the web calculator")
    a.add_argument("--port", type=int, default=8050)
    a.add_argument("--data-root", default="data")
    _device(a)

    s = sub.add_parser("serve", help="serve a trained checkpoint")
    s.add_argument("--checkpoint", required=True)
    s.add_argument("--problem", default=None,
                   help="problem preset (optional for a system or inverse "
                        "checkpoint, whose meta describes it)")
    s.add_argument("--port", type=int, default=8060)
    _device(s)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"problems": cmd_problems, "train": cmd_train, "app": cmd_app,
     "serve": cmd_serve, "invert": cmd_invert,
     "system": cmd_system}[args.cmd](args)


if __name__ == "__main__":
    main()
