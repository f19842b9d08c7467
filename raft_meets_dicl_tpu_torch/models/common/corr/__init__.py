"""Correlation-module factory (counterpart of the JAX ``corr/__init__.py``).

``make_cmod`` builds the cost-volume module of the hybrid models; all share
the call ``(f1, f2, coords, dap=True, train=..., frozen_bn=...) -> (B, H,
W, output_dim)`` in NHWC, with window channels ordered by
``ops.corr.window_delta``. Only ``dicl`` is ported; ``dicl-1x1``,
``dicl-emb`` and ``dot`` refuse, naming their ROADMAP item.
"""

from . import common, dicl

_LATER = {
    "dicl-1x1": "ROADMAP slice 4, item 1",
    "dicl-emb": "ROADMAP slice 4, item 2",
    "dot": "ROADMAP slice 4, item 3",
}


def _refuse_later(cmod_type):
    if cmod_type in _LATER:
        raise NotImplementedError(
            f"correlation module type '{cmod_type}' is not ported yet "
            f"({_LATER[cmod_type]})")
    raise ValueError(f"unknown correlation module type '{cmod_type}'")


def make_cmod(type, feature_dim, radius, dap_init="identity",
              norm_type="batch", **kwargs):
    if type != "dicl":
        _refuse_later(type)
    return dicl.CorrelationModule(feature_dim=feature_dim, radius=radius,
                                  dap_init=dap_init, norm_type=norm_type,
                                  **kwargs)


def make_flow_regression(cmod_type, type, radius, **kwargs):
    if cmod_type != "dicl":
        _refuse_later(cmod_type)
    if type == "softargmax":
        return dicl.SoftArgMaxFlowRegression(radius=radius, **kwargs)
    if type == "softargmax+dap":
        return dicl.SoftArgMaxFlowRegressionWithDap(radius=radius, **kwargs)
    raise ValueError(
        f"unknown flow regression type '{type}' for correlation module "
        f"'{cmod_type}'")


__all__ = ["common", "dicl", "make_cmod", "make_flow_regression"]
