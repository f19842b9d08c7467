"""Hook protocol: config-constructible observers of the training process
(counterpart of ``raft_meets_dicl_tpu/inspect/hooks/common.py``).

A hook declares what it needs and the inspector provides it:

- ``needs_intermediates``: at the hook's ``frequency`` the inspector runs
  an auxiliary forward (no gradient, ``train=False``, the model's frozen
  batch-norm setting) with ``register_forward_hook``s on the modules the
  hook names, and hands it one reduction of each captured activation
  (:meth:`Hook.reduce`, computed on the device as the forward runs, all
  fetched in one copy) through ``on_intermediates``;
- ``needs_grads``: the train step returns its gradients and the hook
  receives them, by parameter name, every step (``on_grads``).

Modules are named by their flax paths, as in the JAX package's configs
(``FeatureEncoderS3_0._Stem_0``); ``convert.activation_points`` resolves
them to this package's modules. The captured names and their order are
JAX's: its ``flatten_intermediates`` walks a capture tree whose keys the
jit sorted, so a module's children come in sorted order before its own
output (``__call__``), and a module called more than once, or returning a
tuple, gives one entry per call or element (``name.0``, ``name.1``).

``when`` ('training' | 'validation' | 'all') gates which phases a hook is
active in, as in JAX; ``register``/``Handle.remove`` keep the same
activation lifecycle shape.
"""

import torch


class Handle:
    def __init__(self, hook):
        self.hook = hook

    def remove(self):
        self.hook.active = False


class Hook:
    type = None
    needs_intermediates = False
    needs_grads = False

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(
                f"invalid hook type '{cfg['type']}', expected '{cls.type}'"
            )

    @classmethod
    def from_config(cls, cfg):
        from . import activation, anomaly

        types = [
            activation.ActivationStats,
            anomaly.ActivationAnomalyDetector,
            anomaly.GradientAnomalyDetector,
        ]
        types = {t.type: t for t in types}

        return types[cfg["type"]].from_config(cfg)

    def __init__(self, when):
        if when not in ("training", "validation", "all"):
            raise ValueError(f"invalid hook attribute 'when': '{when}'")
        self.when = when
        self.active = False

    def get_config(self):
        raise NotImplementedError

    def register(self, ctx, writer) -> Handle:
        self.active = True
        return Handle(self)

    def wants(self, name):
        """Whether the hook reads the activations captured at ``name`` (a
        flax module path, or one with an output's index); all of them by
        default."""
        return True

    def reduce(self, x):
        """The 1-d float64 device tensor the hook reads of one captured
        activation ``x``."""
        raise NotImplementedError

    def on_intermediates(self, log, ctx, named):
        """Called with ``[(name, shape, values)]``: each captured
        activation's flax name, its shape and :meth:`reduce` of it as a
        numpy array, in JAX's order."""

    def on_grads(self, log, ctx, grads):
        """Called with the gradients by parameter name (device tensors)."""


def matches(name, target):
    """JAX's target rule: the module itself or anything below it."""
    return name == target or name.startswith(target + ".")


def _order(name):
    """JAX's order of a flattened capture tree: sorted keys at every
    level, a module's own output under its ``__call__`` key."""
    parts = tuple(name.split("."))
    return parts if name == "__call__" else parts + ("__call__",)


class _Leaf:
    def __init__(self, values, shape):
        self.values = values
        self.shape = shape


def _walk(node, name, out):
    """JAX's ``flatten_intermediates`` over one module's calls."""
    if isinstance(node, dict):
        for k, v in node.items():
            _walk(v, f"{name}.{k}", out)
    elif isinstance(node, (tuple, list)):
        if len(node) == 1:
            _walk(node[0], name, out)
        else:
            for i, v in enumerate(node):
                _walk(v, f"{name}.{i}", out)
    elif isinstance(node, _Leaf):
        out.append((name, node))


@torch.no_grad()
def capture_activations(forward, module, points, names, hooks):
    """Run ``forward()`` with forward hooks on ``module``'s submodules at
    the flax ``names`` (``points``: ``convert.activation_points``) and
    return ``[(hook, [(name, shape, values)])]``: per hook, the captured
    activations it wants, each reduced on the device by its ``reduce``,
    fetched in one device->host copy."""
    modules = dict(module.named_modules())
    sites = {}
    for name in names:
        sites.setdefault(points[name], [])

    def reduced(y):
        if torch.is_tensor(y):
            if not y.is_floating_point():
                return None
            return _Leaf([h.reduce(y) for h in hooks], tuple(y.shape))
        if isinstance(y, (tuple, list)):
            return [reduced(v) for v in y]
        if isinstance(y, dict):
            return {k: reduced(v) for k, v in y.items()}
        return None

    handles = []
    for (path, kind), calls in sites.items():
        mod = modules[path]
        if kind == "output":
            handles.append(mod.register_forward_hook(
                lambda m, args, out, calls=calls: calls.append(reduced(out))))
        else:
            handles.append(mod.register_forward_pre_hook(
                lambda m, args, calls=calls: calls.append(reduced(args[0]))))
    try:
        forward()
    finally:
        for h in handles:
            h.remove()

    flat = []
    for name in sorted(names, key=_order):
        _walk(sites[points[name]], name, flat)

    values = [v for _, leaf in flat for v in leaf.values]
    host = torch.cat(values).cpu().numpy() if values else None
    out, k = [], 0
    sizes = [[len(v) for v in leaf.values] for _, leaf in flat]
    per_hook = [[] for _ in hooks]
    for (name, leaf), lens in zip(flat, sizes):
        for j, n in enumerate(lens):
            per_hook[j].append((name, leaf.shape, host[k:k + n]))
            k += n
    for hook, named in zip(hooks, per_hook):
        out.append((hook, [e for e in named if hook.wants(e[0])]))
    return out
