"""Loss-and-gradient evaluations per complete L-BFGS iterate (lbfgs.eval spans inside lbfgs.iter spans)."""

from benchmark.harness.spans import evals_per_iter


def read(ctx):
    return evals_per_iter(ctx)
