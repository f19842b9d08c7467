"""Backwards warping via flow, NHWC (counterpart of the JAX
``models/common/warp.py``): the ``ops/warp.py`` function, which
``tests/test_torch_port_dicl_family.py`` holds against the JAX module's,
mask and ``eps`` included."""

from ...ops.warp import warp_backwards

__all__ = ["warp_backwards"]
