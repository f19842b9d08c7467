"""Inspector config loading (counterpart of
``raft_meets_dicl_tpu/inspect/config.py``)."""

from .. import utils
from . import summary


def load(cfg):
    if not isinstance(cfg, dict):
        return summary.InspectorSpec.from_config(utils.config.load(cfg))
    return summary.InspectorSpec.from_config(cfg)
