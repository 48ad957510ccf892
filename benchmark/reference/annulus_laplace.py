"""The annulus Laplace problem, written out by hand for the reference.

Polar coordinates z = (r, t) on r in [0.1, 1], t in [0, 2 pi); the net
sees (2 (r - 0.1) / 0.9 - 1, cos t, sin t); the hard-BC ansatz is
u = (1 - r) / 0.9 + (r - 0.1)(1 - r) N, which is 1 at r = 0.1 and 0 at
r = 1 for any N; the residual of Laplace's equation in polar coordinates
is u_rr + u_r / r + u_tt / r^2.
"""

import torch


def features(z):
    r, t = z[:, 0:1], z[:, 1:2]
    return torch.cat([2.0 * (r - 0.1) / (1.0 - 0.1) - 1.0, torch.cos(t),
                      torch.sin(t)], dim=1)


def lift(z):
    return (1.0 - z[:, 0:1]) / 0.9


def bubble(z):
    r = z[:, 0:1]
    return (r - 0.1) * (1.0 - r)


def residual(z, u, du, d2):
    r = z[:, 0:1]
    return d2[:, 0:1] + du[:, 0:1] / r + d2[:, 1:2] / (r * r)
