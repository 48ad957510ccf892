"""Kernel B1's share of its roofline over the traced Adam steps (the density refresh's calls counted at its grid)."""

from benchmark.harness.layer import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b1")
