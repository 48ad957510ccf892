"""Kernel B2's share of its roofline over the traced Adam steps."""

from benchmark.harness.layer import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b2")
