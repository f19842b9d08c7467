"""Multi-level sequence loss (counterpart of the JAX ``loss/mlseq.py``).

Per-level weight alpha x per-iteration weight gamma^(n-i-1), each flow
upsampled to the target resolution (align-corners bilinear with the
displacements rescaled) and penalized by an L-ord distance over valid
pixels.
"""

import torch

from ....ops.upsample import interpolate_bilinear
from ...config import register_loss
from ...model import Loss


def upsample_flow_to(flow, shape):
    """align-corners bilinear resize of a (B, H, W, 2) flow to (H', W'),
    rescaling the displacement values by the size ratio."""
    _, fh, fw, _ = flow.shape
    th, tw = shape
    if (fh, fw) == (th, tw):
        return flow

    flow = interpolate_bilinear(flow, (th, tw))
    return flow * torch.tensor([tw / fw, th / fh], dtype=flow.dtype,
                               device=flow.device)


@register_loss
class MultiLevelSequenceLoss(Loss):
    type = "raft+dicl/mlseq"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("arguments", {}))

    def __init__(self, arguments={}):
        super().__init__(arguments)

    def get_config(self):
        default_args = {
            "ord": 1,
            "gamma": 0.8,
            "alpha": (1.0, 0.5),
            "scale": 1.0,
        }
        return {"type": self.type, "arguments": default_args | self.arguments}

    def compute(self, model, result, target, valid, ord=1, gamma=0.8,
                alpha=(0.4, 1.0), scale=1.0):
        th, tw = target.shape[1:3]
        valid_f = valid.float()
        denom = torch.clamp(valid_f.sum(), min=1.0)

        loss = 0.0
        for i_level, level in enumerate(result):
            n = len(level)
            for i_seq, flow in enumerate(level):
                weight = alpha[i_level] * gamma ** (n - i_seq - 1)

                flow = upsample_flow_to(flow, (th, tw))
                dist = torch.linalg.vector_norm(flow - target, ord=float(ord),
                                                dim=-1)
                loss = loss + weight * (dist * valid_f).sum() / denom

        return loss * scale
