"""The hard-BC lift's and bubble's partials (span partials.lift_bubble) per traced Adam step."""

from benchmark.harness.spans import time_per_unit


def read(ctx):
    return time_per_unit(ctx, "partials.lift_bubble")
