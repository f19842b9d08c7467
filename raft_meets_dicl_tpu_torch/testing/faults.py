"""Fault injection for exercising the recovery paths end to end (the
port's copy of ``raft_meets_dicl_tpu/testing/faults.py``).

Armed via ``RMD_FAULT``, a comma-separated list of directives::

    RMD_FAULT="nan_update@step=3,nan_update@step=4"
    RMD_FAULT="nan_update@step=7;times=2"

Each directive is ``name@key=value;key=value...``; a directive fires when
every parameter it pins (other than ``times``) equals the call site's
value, once unless ``times`` raises the budget. With ``RMD_FAULT_STATE``
set to a shared directory a fired directive leaves a marker file there,
and every process honors it (once across processes).

The port consults one directive:

``nan_update@step=N``
    ``strategy.training.TrainingContext.run_instance`` poisons the
    learning rate it passes to the train step with NaN at optimizer step
    N: the update goes NaN exactly as a NaN-gradient batch's would, which
    trips the non-finite guard.

The JAX package's other directives (``sigterm``, ``corrupt_checkpoint``,
``kill_worker``, ``decode_error``, ``serve_*``, ``kill_replica``,
``hang_replica``, ``slow_replica``) parse here too, and fire nowhere: their
call sites belong to the ops plane (ROADMAP slice 7 item 7).
:func:`corrupt_file` is the JAX helper that flips bits in a file.

Everything here is inert unless ``RMD_FAULT`` is set.
"""

import threading
from pathlib import Path

from ..utils import env

_lock = threading.Lock()
# parsed spec cache: {spec string: [ (name, params dict), ... ]}
_parsed = {}
# per-process fire counts: {(name, param key): count}
_fired = {}


def _parse(spec):
    directives = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, rest = part.partition("@")
        params = {}
        for kv in rest.split(";"):
            if not kv:
                continue
            k, _, v = kv.partition("=")
            try:
                params[k.strip()] = int(v)
            except ValueError:
                params[k.strip()] = v.strip()
        directives.append((name.strip(), params))
    return directives


def _directives():
    spec = env.get_str("RMD_FAULT")
    if not spec:
        return ()
    with _lock:
        if spec not in _parsed:
            _parsed[spec] = _parse(spec)
        return _parsed[spec]


def active():
    """Whether any fault directive is armed (cheap env check)."""
    return bool(env.get_str("RMD_FAULT"))


def reset():
    """Forget per-process fire counts (test isolation)."""
    with _lock:
        _fired.clear()
        _parsed.clear()


def _marker(name, params):
    state = env.get_str("RMD_FAULT_STATE")
    if not state:
        return None
    key = "-".join(f"{k}{v}" for k, v in sorted(params.items()))
    return Path(state) / f"fired-{name}-{key}"


def fire(name, **match):
    """Consume one firing of directive ``name`` if its parameters match.

    ``match`` gives the call site's current coordinates (``step=``,
    ``index=``, ``nth=``); a directive fires when every parameter it
    pins (other than ``times``) equals the given value. Returns the
    directive's params dict when it fires, else None.
    """
    if not active():
        return None
    for dname, params in _directives():
        if dname != name:
            continue
        if any(params.get(k) != v for k, v in match.items() if k in params):
            continue
        times = params.get("times", 1)
        key = (name, tuple(sorted(params.items())))
        marker = _marker(name, params)
        with _lock:
            if marker is not None:
                # cross-process once-only: the marker directory is the
                # shared consumed-state (a respawned decode worker must
                # not re-fire on the resubmitted sample)
                try:
                    marker.touch(exist_ok=False)
                except FileExistsError:
                    continue
                except OSError:
                    continue
            else:
                if _fired.get(key, 0) >= times:
                    continue
                _fired[key] = _fired.get(key, 0) + 1
        return params
    return None


def corrupt_file(path, flips=8, offset=64):
    """Flip ``flips`` bits spread across the file's payload region.

    Deterministic (position-derived) so tests are reproducible; starts
    at ``offset`` to land in the serialized payload rather than the
    header magic, and clusters near the start so truncated/partial
    reads also see the damage.
    """
    path = Path(path)
    raw = bytearray(path.read_bytes())
    if len(raw) <= offset:
        offset = 0
    span = max(1, len(raw) - offset)
    for i in range(flips):
        pos = offset + (i * 97) % span
        raw[pos] ^= 1 << (i % 8)
    path.write_bytes(bytes(raw))
    return path
