"""The mean time of the Adam phase's resample (span adam.resample) in the traced stretch."""

from benchmark.harness.spans import mean_duration_ms


def read(ctx):
    return mean_duration_ms(ctx, "adam.resample")
