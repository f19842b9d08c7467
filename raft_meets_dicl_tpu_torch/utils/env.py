"""Environment knobs the port reads (the port's own copy of the part of
``raft_meets_dicl_tpu/utils/env.py`` it needs).

- ``RMD_FS_VOLUME_GIB``: the ``raft/fs`` budget, in GiB per device, for
  materialized correlation volumes (default 4.0; 0 puts every pyramid
  level on the windowed-correlation kernel). An unset or empty variable
  gives the default, as in the JAX package.
- ``RMD_ASYNC_CHECKPOINT``: a switch, on unless set to ``0``: checkpoints
  are encoded and written on a background thread (0 = the whole save on
  the training loop's thread).
- ``RMD_ITERATIONS``: the recurrence iteration override of ``main
  evaluate`` (0 or unset = the model config's; ``--iterations`` wins).
- ``RMD_EVAL_BUCKETS``: ``main evaluate``'s shape buckets, ``group`` or
  an ``HxW`` list (``--buckets`` wins).
"""

import os

FS_VOLUME_GIB_DEFAULT = 4.0


def get_float(name, default=FS_VOLUME_GIB_DEFAULT):
    """The knob's value as a float, ``default`` when unset or empty."""
    value = os.environ.get(name)
    return default if value in (None, "") else float(value)


def get_int(name, default=0):
    """The knob's value as an int, ``default`` when unset or empty."""
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def get_str(name):
    """The knob's raw string, None when unset or empty."""
    value = os.environ.get(name)
    return None if value in (None, "") else value


def get_bool(name):
    """A switch: on unless the variable is ``0``."""
    return os.environ.get(name) != "0"
