"""The L-BFGS evaluation's model operations (B1's and B2's counts) per second over the card's TF32 peak, in percent."""

from benchmark.harness.layer import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
