"""The share of the traced L-BFGS evaluations in which no operation runs on the card."""

from benchmark.harness.layer import idle_pct


def read(ctx):
    return idle_pct(ctx)
