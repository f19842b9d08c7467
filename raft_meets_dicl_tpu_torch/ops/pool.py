"""Window pooling for NHWC tensors (counterpart of
``raft_meets_dicl_tpu/ops/pool.py``: ``avg_pool2d`` and ``max_pool2d``)."""

import torch.nn.functional as F


def avg_pool2d(x, window=2):
    """Average pool over the H, W axes of an (..., H, W, C) tensor with
    stride ``window``, 'VALID' windows (a ragged last row or column is
    dropped).

    Computed in the input's dtype as the JAX ``lax.reduce_window`` sum is:
    the window's elements are added one at a time in row-major window
    order, each sum rounded to the dtype, then divided by window². Under
    the bf16 policy this differs from a float32-accumulated mean
    (``corr._pool2x_spatial``), and ``raft/fs`` pools its f2 pyramid with
    this one.
    """
    ho = x.shape[-3] // window * window
    wo = x.shape[-2] // window * window
    total = None
    for i in range(window):
        for j in range(window):
            part = x[..., i:ho:window, j:wo:window, :]
            total = part if total is None else total + part
    return total / (window * window)


def max_pool2d(x, window=2, stride=None):
    """Max pool over the H, W axes of a (B, H, W, C) tensor, 'VALID'
    windows of ``window`` at ``stride`` (default ``window``). A maximum is
    exact in any order, so this equals the JAX ``lax.reduce_window``."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return y.permute(0, 2, 3, 1)
