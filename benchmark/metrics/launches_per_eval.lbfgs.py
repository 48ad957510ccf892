"""Device operations per L-BFGS loss-and-gradient evaluation in the traced stretch."""

from benchmark.harness.layer import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx)
