"""The self time of the Adam step's loss (span adam.forward, less the spans inside it) per traced step."""

from benchmark.harness.spans import self_per_unit


def read(ctx):
    return self_per_unit(ctx, "adam.forward")
