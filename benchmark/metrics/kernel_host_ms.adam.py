"""The host path of kernels B1 and B2 (spans b1.launch and b2.launch) per traced Adam step."""

from benchmark.harness.spans import time_per_unit


def read(ctx):
    return time_per_unit(ctx, "b1.launch", "b2.launch")
