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
- ``RMD_NONFINITE``: the non-finite step policy of ``main train``
  (``raise``, ``skip``, ``rollback``; ``--nonfinite`` wins, then this,
  then the environment config's ``nonfinite`` section). A policy name
  here takes the policy's default limits.
- ``RMD_ACCUMULATE``: in-step gradient accumulation of ``main train``,
  microbatches per optimizer step (``--accumulate`` wins, then this, then
  the environment config's ``parallel.accumulate``).
- ``RMD_FINITE_CHECK_EVERY``: steps between two reads of the pending
  steps' scalars (loss, finite flag, skip count, norms) by the trainer
  (default 10; 1 reads every step, which makes the non-finite policies'
  count of consecutive trips exact).
- ``RMD_FAULT`` / ``RMD_FAULT_STATE``: fault injection
  (``testing.faults``).
- ``RMD_LADDER``: the iteration ladder's rung budgets of ``main serve
  --ladder`` given bare (default ``4,8,12``; ``--ladder RUNGS`` and the
  serve config's ``ladder`` key win).
- ``RMD_LADDER_THRESHOLD``: the flow-delta norm (coarse-grid px) below
  which the balanced class stops escalating (default 0.1;
  ``--ladder-threshold`` and the config's ``ladder-threshold`` win).
- ``RMD_QUANT``: the quantized matching tier of the fast serve class
  (``u8`` or ``i8``; unset or ``off``: full precision; ``--quant`` and the
  config's ``quant`` key win).
- ``RMD_QUANT_CLIP``: the fraction of each level's abs-max the quantized
  range spans (default 1.0; values beyond it saturate).
- ``RMD_VIDEO_SESSIONS``: the capacity of a video server's per-client
  session cache (default 64; least recently used past it).
- ``RMD_VIDEO_SESSION_TTL_S``: idle seconds before a video session's
  carry expires (default 30.0).
- ``RMD_VIDEO_WARM_ITERATIONS``: the warm-start program's iterations of a
  video session without a ladder (default 4; with one its bottom rung).
"""

import os

FS_VOLUME_GIB_DEFAULT = 4.0
LOADER_RETRIES_DEFAULT = 2
BAD_SAMPLE_BUDGET_DEFAULT = 16

# the registered defaults of the knobs read without an explicit one (JAX's
# ``_k`` declarations)
_DEFAULTS = {
    "RMD_FS_VOLUME_GIB": FS_VOLUME_GIB_DEFAULT,
    "RMD_LADDER": "4,8,12",
    "RMD_LADDER_THRESHOLD": 0.1,
    "RMD_QUANT_CLIP": 1.0,
    "RMD_VIDEO_SESSIONS": 64,
    "RMD_VIDEO_SESSION_TTL_S": 30.0,
    "RMD_VIDEO_WARM_ITERATIONS": 4,
}


def get_float(name, default=None):
    """The knob's value as a float; when unset or empty, ``default``, else
    the knob's registered default."""
    value = os.environ.get(name)
    if value in (None, ""):
        return _DEFAULTS.get(name) if default is None else default
    return float(value)


def get_int(name, default=None):
    """The knob's value as an int; when unset or empty, ``default``, else
    the knob's registered default, else 0."""
    value = os.environ.get(name)
    if value in (None, ""):
        return _DEFAULTS.get(name, 0) if default is None else default
    return int(value)


def get_str(name):
    """The knob's raw string; its registered default (None for most) when
    unset or empty."""
    value = os.environ.get(name)
    return _DEFAULTS.get(name) if value in (None, "") else value


def get_bool(name):
    """A switch: on unless the variable is ``0``."""
    return os.environ.get(name) != "0"
