"""Host reads of a device scalar (read. spans) inside the complete L-BFGS iterates, per evaluation inside them."""

from benchmark.harness.spans import reads_per_eval


def read(ctx):
    return reads_per_eval(ctx)
