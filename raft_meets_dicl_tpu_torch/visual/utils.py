"""Small color-layout helpers (own copy of
``raft_meets_dicl_tpu/visual/utils.py``; reference src/visual/utils.py)."""

import numpy as np


def rgba_to_bgra(rgba):
    """RGBA → BGRA channel swap for cv2 writers."""
    return np.ascontiguousarray(np.asarray(rgba)[..., [2, 1, 0, 3]])
