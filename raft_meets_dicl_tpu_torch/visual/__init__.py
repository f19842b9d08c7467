"""Flow visualization (counterpart of ``raft_meets_dicl_tpu/visual``: the
Middlebury color coding the inspector's images use)."""

from .flow_mb import color_wheel, flow_to_rgba

__all__ = ["color_wheel", "flow_to_rgba"]
