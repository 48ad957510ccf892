"""Rank 0's device time in NCCL kernels per Adam step."""

from benchmark.harness.layer import nccl_ms_per_unit


def read(ctx):
    return nccl_ms_per_unit(ctx)
