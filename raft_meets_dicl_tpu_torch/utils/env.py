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
- ``RMD_WIRE_FORMAT``: the host→device wire format (``f32``, ``bf16``,
  ``u8``) of ``main train`` (``--wire-format`` wins, then this, then the
  environment config's ``wire`` section), ``main evaluate``
  (``--wire-format`` wins) and ``main serve`` (``--wire-format``, then
  the serve config's ``wire-format`` key, then this).
- ``RMD_WIRE_BF16`` is not read: JAX's legacy bf16 image put for
  mixed-precision models is not ported, since the port's bf16 policy
  rounds the images at the first convolutions anyway, and the step is bit
  for bit the same with and without it
  (``tests/test_torch_port_wire.py``).
- ``RMD_LOADER_RETRIES``: decode attempts of a failing sample after the
  first, before a neighbour is substituted (default 2).
- ``RMD_BAD_SAMPLE_BUDGET``: substituted samples a loader may take in its
  life before it aborts (default 16; 0 turns healing off: the first
  failure raises).
- ``RMD_LOADER_PROCS``: decode processes of the training loader (0 or
  unset: the stage's or environment's ``num_workers``; ``--loader-procs``
  wins).
"""

import os

FS_VOLUME_GIB_DEFAULT = 4.0
LOADER_RETRIES_DEFAULT = 2
BAD_SAMPLE_BUDGET_DEFAULT = 16


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
