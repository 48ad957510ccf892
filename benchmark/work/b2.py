"""Work of one call of kernel B2 (the parameter gradient of B1's streams:
the Taylor-2 backward of a plain dense net over N points and S streams,
with the sum of its per-block partial gradients): its device kernels'
names, and the bytes and operations the call needs.

Bytes: the points and the cotangents read, the weights read and the
gradient written, each once.  Operations: 2 FLOP per multiply-add of the
products the function needs: X = H W of the hidden layers, H^T dX of
every layer, dX W^T of every layer but the first (the points get no
cotangent).  The count is the float32 algorithm's, whatever implements
it.
"""

KERNELS = ("taylor2_bwd_kernel", "sum_partials")


def work(n, depth, width, n_features, d, n_streams):
    """``(bytes, operations)`` of one call at ``n`` points."""
    w, L = width, depth
    n_par = n_features * w + w + (L - 1) * (w * w + w) + w + 1
    n_bytes = 4 * (n * (d + n_streams) + 2 * n_par)
    n_ops = 2 * n * n_streams * (2 * n_features * w + 3 * (L - 1) * w * w
                                 + 2 * w)
    return n_bytes, n_ops
