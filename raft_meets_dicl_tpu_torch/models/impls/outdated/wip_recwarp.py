"""``wip/warp/2``, coarse-to-fine recurrent warping units (a kept
experiment), PyTorch port: forward and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/outdated/
wip_recwarp.py``: a GA-Net p26 pyramid (1/4..1/64), and per level, coarse
to fine, a unit that samples frame 2's features on the displaced window
around the current coordinates, runs its MatchingNet (on the unstacked
pair, as the DICL hybrids do) and DAP and moves the coordinates by the
soft-argmin of the cost; ``iterations[i]`` times at level i (finest
first), the coordinates resized between levels. The public layout is the
JAX one: images (B, H, W, 3), flows (B, H, W, 2), channel 0 = x; the
output is the per-iteration flow list, coarsest first (the result holds
it finest first).

The coordinates carry a gradient through every unit, and the shipped
windows have radii 2 and 3: the ``sample_window`` kernel gives the centres
no gradient and is built for radius 4. So this model samples with the
plain differentiable ``ops.sample.sample_window``, on the card as on the
CPU, the counterpart of the XLA op the JAX module calls (no Pallas kernel
there).

Names: ``fnet``, ``rfu.{i}`` (``mnet``, ``dap``)
(``convert.wip_recwarp_rules``).
"""

import torch
import torch.nn as nn

from ....ops.sample import sample_window
from ....ops.upsample import interpolate_bilinear
from ...common.blocks.dicl import DisplacementAwareProjection, MatchingNet
from ...common.encoders.dicl import FeatureEncoderGa
from ...common.grid import coordinate_grid
from ...common.util import init_parameters
from ...config import register_model
from ...model import Model, ModelAdapter, Result
from ..dicl import _resize_flow, soft_argmin_flow

_LEVELS = 5  # 1/4 .. 1/64


class _RecurrentFlowUnit(nn.Module):
    """Window-sampled cost -> DAP -> soft-argmin coordinate update."""

    def __init__(self, feature_channels, disp_range):
        super().__init__()
        ru, rv = disp_range
        if ru != rv:
            raise ValueError(f"disp-range {list(disp_range)}: square "
                             "displacement windows only")
        self.radius = ru
        self.mnet = MatchingNet(feature_channels)
        self.dap = DisplacementAwareProjection(ru)

    def forward(self, feat1, feat2, coords, dap=True, train=False,
                frozen_bn=False):
        # the plain sampler, on purpose: the coordinates need its gradient
        # and the radius is not the kernel's (module docstring)
        window = sample_window(feat2, coords, self.radius)
        cost = self.mnet((feat1, window), train, frozen_bn)  # (B, H, W, K, K)
        if dap:
            cost = self.dap(cost)
        return coords + soft_argmin_flow(cost)


class WipRecWarpModule(nn.Module):
    """The coarse-to-fine recurrent warping network."""

    def __init__(self, feature_channels=32, disp=((3, 3),) * _LEVELS):
        super().__init__()
        self.fnet = FeatureEncoderGa(output_dim=feature_channels, depth=6,
                                     out_levels=(1, 2, 3, 4, 5))
        self.rfu = nn.ModuleList(
            _RecurrentFlowUnit(feature_channels, tuple(disp[i]))
            for i in range(_LEVELS))

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def forward(self, img1, img2, train=False, frozen_bn=False,
                iterations=(1,) * _LEVELS, dap=True):
        """img1, img2: (B, H, W, 3), H and W divisible by 128 (the config
        pads to it). Returns the per-iteration flows, coarse to fine."""
        f1, f2 = self.fnet((img1.permute(0, 3, 1, 2),
                            img2.permute(0, 3, 1, 2)), train, frozen_bn)
        f1 = [f.permute(0, 2, 3, 1) for f in f1]        # finest first, NHWC
        f2 = [f.permute(0, 2, 3, 1) for f in f2]

        b = img1.shape[0]
        coords = coordinate_grid(b, *f1[-1].shape[1:3], device=img1.device)

        out = []
        for i in range(_LEVELS - 1, -1, -1):  # coarse -> fine
            h2, w2 = f1[i].shape[1:3]
            h1, w1 = coords.shape[1:3]
            if (h1, w1) != (h2, w2):
                coords = interpolate_bilinear(coords, (h2, w2)) * torch.tensor(
                    [w2 / w1, h2 / h1], dtype=coords.dtype,
                    device=coords.device)
            coords0 = coordinate_grid(b, h2, w2, device=img1.device)

            for _ in range(iterations[i]):
                coords = self.rfu[i](f1[i], f2[i], coords, dap=dap,
                                     train=train, frozen_bn=frozen_bn)
                out.append(coords - coords0)
        return out


@register_model
class WipRecWarp(Model):
    """``wip/warp/2``."""

    type = "wip/warp/2"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            feature_channels=p.get("feature-channels", 32),
            disp=p.get("disp-range", [(3, 3)] * _LEVELS),
            arguments=cfg.get("arguments", {}),
        )

    def __init__(self, feature_channels=32, disp=((3, 3),) * _LEVELS,
                 arguments={}):
        self.feature_channels = feature_channels
        self.disp = tuple(tuple(d) for d in disp)

        super().__init__(
            WipRecWarpModule(feature_channels=feature_channels,
                             disp=self.disp),
            arguments=arguments,
        )

    def get_config(self):
        default_args = {"iterations": [1] * _LEVELS, "dap": True}
        return {
            "type": self.type,
            "parameters": {
                "feature-channels": self.feature_channels,
                "disp-range": [list(d) for d in self.disp],
            },
            "arguments": default_args | self.arguments,
        }

    def get_adapter(self) -> ModelAdapter:
        return WipRecWarpAdapter(self)


class WipRecWarpAdapter(ModelAdapter):
    def wrap_result(self, result, original_shape) -> Result:
        return WipRecWarpResult(result, original_shape)


class WipRecWarpResult(Result):
    """The per-iteration flows, finest first; ``final()`` resizes the
    finest to the input's size."""

    def __init__(self, output, shape):
        super().__init__()
        self.result = list(reversed(output))
        self.shape = shape

    def output(self, batch_index=None):
        if batch_index is None:
            return self.result
        return [x[batch_index:batch_index + 1] for x in self.result]

    def final(self):
        return _resize_flow(self.result[0].detach(), self.shape)

    def intermediate_flow(self):
        return self.result
