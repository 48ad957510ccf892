"""The unit-cube Poisson problem, written out by hand for the reference.

z = (x, y, z) in [0, 1]^3; the net sees 2 z - 1; the hard-BC ansatz is
u = x(1 - x) y(1 - y) z(1 - z) N, zero on every face for any N; the
residual is u_xx + u_yy + u_zz + 3 pi^2 sin(pi x) sin(pi y) sin(pi z)
(the exact solution is sin(pi x) sin(pi y) sin(pi z)).
"""

import math

import torch


def features(z):
    return 2.0 * z - 1.0


def lift(z):
    return torch.zeros_like(z[:, 0:1])


def bubble(z):
    return torch.prod(z * (1.0 - z), dim=1, keepdim=True)


def residual(z, u, du, d2):
    s = torch.prod(torch.sin(math.pi * z), dim=1, keepdim=True)
    return d2.sum(dim=1, keepdim=True) + 3.0 * math.pi ** 2 * s
