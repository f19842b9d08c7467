"""Environment knobs the port reads (the port's own copy of the part of
``raft_meets_dicl_tpu/utils/env.py`` it needs).

Only ``RMD_FS_VOLUME_GIB`` is ported: the ``raft/fs`` budget, in GiB per
device, for materialized correlation volumes (default 4.0; 0 puts every
pyramid level on the windowed-correlation kernel). An unset or empty
variable gives the default, as in the JAX package.
"""

import os

FS_VOLUME_GIB_DEFAULT = 4.0


def get_float(name, default=FS_VOLUME_GIB_DEFAULT):
    """The knob's value as a float, ``default`` when unset or empty."""
    value = os.environ.get(name)
    return default if value in (None, "") else float(value)
