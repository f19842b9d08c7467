"""DICL correlation module with a 1x1-conv MatchingNet (counterpart of the
JAX ``corr/dicl_1x1.py``): the lookup of ``corr/dicl.py`` (the window
sampler kernel), then three 1x1 conv blocks and a biased 1x1 head per
displacement (``blocks.dicl.MatchingNet1x1``), on the unstacked (f1,
window) pair, and the DAP. Layout and names as ``corr/dicl.py`` (``mnet``,
``dap``).
"""

from ..blocks.dicl import MatchingNet1x1
from . import dicl
from .common import SoftArgMaxFlowRegression, SoftArgMaxFlowRegressionWithDap

__all__ = ["CorrelationModule", "SoftArgMaxFlowRegression",
           "SoftArgMaxFlowRegressionWithDap"]


class CorrelationModule(dicl.CorrelationModule):
    mnet_type = MatchingNet1x1
