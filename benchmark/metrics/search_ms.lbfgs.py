"""The complete L-BFGS iterates' time outside their evaluations (two-loop, line search, reads' waits) per evaluation inside them."""

from benchmark.harness.spans import search_ms


def read(ctx):
    return search_ms(ctx)
