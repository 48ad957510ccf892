"""The model's operations in one training step (or one loss-and-gradient
evaluation) at N points: the network's Taylor-2 forward (kernel B1's
count) and its parameter gradient (kernel B2's count).  The hard-BC lift
and bubble, the loss and the update are elementwise and left out, so the
share of the peak is a lower bound of what the step computes.
"""

from benchmark.work import b1, b2


def operations(n, depth, width, n_features, d, n_streams):
    args = (n, depth, width, n_features, d, n_streams)
    return b1.work(*args)[1] + b2.work(*args)[1]
