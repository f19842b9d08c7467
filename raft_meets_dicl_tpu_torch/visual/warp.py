"""Backwards-warp preview: resample img2 by the estimated flow.

Host-facing wrapper over the port's warp op, ``ops/warp.py``, on CPU
tensors (counterpart of ``raft_meets_dicl_tpu/visual/warp.py``; reference
src/visual/warp.py:6-14).
"""

import numpy as np
import torch

from ..ops import warp as _warp


def warp_backwards(img2, flow, eps=1e-5):
    """Warp a single HWC image by an HW2 flow field; returns HWC numpy."""
    est, _mask = _warp.warp_backwards(
        torch.from_numpy(np.asarray(img2, np.float32)[None]),
        torch.from_numpy(np.asarray(flow, np.float32)[None]),
        eps=eps,
    )
    return est[0].numpy()
