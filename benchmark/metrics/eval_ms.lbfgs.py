"""The mean self time of the complete L-BFGS evaluations (span lbfgs.eval, less the spans inside it)."""

from benchmark.harness.spans import mean_self_ms


def read(ctx):
    return mean_self_ms(ctx, "lbfgs.eval")
