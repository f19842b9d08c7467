"""Correlation-module factory (counterpart of the JAX ``corr/__init__.py``).

``make_cmod`` builds the cost-volume module of the hybrid models; all share
the call ``(f1, f2, coords, dap=True, train=..., frozen_bn=...) -> (B, H,
W, output_dim)`` in NHWC, with window channels ordered by
``ops.corr.window_delta``: ``dicl``, ``dicl-1x1``, ``dicl-emb`` and
``dot``, each with its soft-argmax readouts.
"""

from . import common, dicl, dicl_1x1, dicl_emb, dot

_CMODS = {
    "dicl": dicl.CorrelationModule,
    "dicl-1x1": dicl_1x1.CorrelationModule,
    "dicl-emb": dicl_emb.CorrelationModule,
    "dot": dot.CorrelationModule,
}

_REGRESSIONS = {
    "dicl": (dicl.SoftArgMaxFlowRegression,
             dicl.SoftArgMaxFlowRegressionWithDap),
    "dicl-1x1": (dicl_1x1.SoftArgMaxFlowRegression,
                 dicl_1x1.SoftArgMaxFlowRegressionWithDap),
    "dicl-emb": (dicl_emb.SoftArgMaxFlowRegression,
                 dicl_emb.SoftArgMaxFlowRegressionWithDap),
    "dot": (dot.SoftArgMaxFlowRegression, dot.SoftArgMaxFlowRegressionWithDap),
}


def make_cmod(type, feature_dim, radius, dap_init="identity",
              norm_type="batch", **kwargs):
    if type == "dot":
        return dot.CorrelationModule(radius=radius, dap_init=dap_init,
                                     **kwargs)
    if type not in _CMODS:
        raise ValueError(f"unknown correlation module type '{type}'")
    return _CMODS[type](feature_dim=feature_dim, radius=radius,
                        dap_init=dap_init, norm_type=norm_type, **kwargs)


def make_flow_regression(cmod_type, type, radius, **kwargs):
    if cmod_type not in _REGRESSIONS:
        raise ValueError(f"unknown correlation module type '{cmod_type}' "
                         "for flow regression")
    softargmax, with_dap = _REGRESSIONS[cmod_type]
    if type == "softargmax":
        return softargmax(radius=radius, **kwargs)
    if type == "softargmax+dap":
        return with_dap(radius=radius, **kwargs)
    raise ValueError(
        f"unknown flow regression type '{type}' for correlation module "
        f"'{cmod_type}'")


__all__ = ["common", "dicl", "dicl_1x1", "dicl_emb", "dot", "make_cmod",
           "make_flow_regression"]
