"""Work of one call of kernel B1 (the Taylor-2 forward of a plain dense
net over N points and S streams): its device kernels' names, and the
bytes and operations the call needs.

Bytes: the points read, the weights read and the [N, S] streams written,
each once.  Operations: 2 FLOP per multiply-add of every layer's product
on every stream.  The count is the float32 algorithm's, whatever
implements it.
"""

KERNELS = ("taylor2_fwd_kernel",)


def work(n, depth, width, n_features, d, n_streams):
    """``(bytes, operations)`` of one call at ``n`` points."""
    w, L = width, depth
    n_par = n_features * w + w + (L - 1) * (w * w + w) + w + 1
    n_bytes = 4 * (n * (d + n_streams) + n_par)
    n_ops = 2 * n * n_streams * (n_features * w + (L - 1) * w * w + w)
    return n_bytes, n_ops
