"""The model's operations in one Adam step of a PirateNet at N points: the
dense products of its Taylor-2 forward over the streams the residual
needs (u, u_x, u_xx and u_t for Allen–Cahn: S = 4) and of their parameter
gradient.  Each multiply-add is 2 FLOP, and each product is taken three
times (forward, the input's cotangent, the weight's gradient) but for the
Fourier projection's cotangent, which the points do not need.  The
gating, the skips, the hard-IC ansatz, the loss and the update are
elementwise and left out, so the count is the float32 algorithm's
minimum, whatever implements it, and its share of the peak is a lower
bound of what the step computes.
"""


def macs(width, blocks, n_features, out_dim=1):
    """Multiply-adds of one forward stream at one point: the Fourier
    projection (n_features x width/2), the two gates and three layers a
    block (width x width each), the output (width x out_dim)."""
    w = width
    return n_features * (w // 2) + (2 + 3 * blocks) * w * w + w * out_dim


def operations(n, width, blocks, n_features, n_streams, out_dim=1):
    m = macs(width, blocks, n_features, out_dim)
    return 2 * n * n_streams * (3 * m - n_features * (width // 2))
