"""Window pooling for NHWC tensors (counterpart of
``raft_meets_dicl_tpu/ops/pool.py::avg_pool2d``)."""


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
