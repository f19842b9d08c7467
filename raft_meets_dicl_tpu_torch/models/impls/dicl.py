"""DICL baseline (``dicl/baseline``, ``dicl/64to8``) and its multiscale
loss, PyTorch port: forward and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/dicl.py``
("Displacement-Invariant Matching Cost Learning for Accurate Optical Flow
Estimation", Wang et al.): GA-Net features (``encoders.dicl``) and a
coarse-to-fine ladder, levels 6..2 (``64to8``: 6..3). At each level the
second frame's features are warped by the upsampled coarser flow, every
integer displacement of the level's range is stacked with frame 1
(``displaced_pair_volume``), a MatchingNet gives its cost, a DAP mixes the
costs, a soft-argmin reads the flow, and a dilated context net refines it.
No kernel: the JAX module reaches none. Public layout: images (B, H, W,
3), flows (B, H, W, 2), channel 0 = x; the output is the list of level
flows, finest first (with ``raw`` each level's pre-context flow after it).

Names follow the DICL-Flow reference (``scripts/chkpt_convert.py``'s
``_dicl_rules``): ``feature``, ``matching{L}.match.{i}``, ``dap{L}``,
``context_net{L}.{i}``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.upsample import interpolate_bilinear, upsample_flow_2x
from ..common import warp
from ..common.blocks.dicl import BasicConv, cost_volume, matching_input
from ..common.encoders.dicl import FeatureEncoderGa
from ..common.util import Conv2d, init_parameters
from ..config import register_loss, register_model
from ..model import Loss, Model, ModelAdapter, Result

# (channels, dilation) per context layer by level (levels below 3 take
# level 3's); a 3x3 conv to the 2 flow channels follows
_CONTEXT_PLANS = {
    3: ((64, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1)),
    4: ((64, 1), (128, 2), (128, 4), (64, 8), (32, 1)),
    5: ((64, 1), (128, 2), (64, 4), (32, 1)),
    6: ((64, 1), (64, 2), (32, 1)),
}


def flow_entropy(cost, eps=1e-9):
    """Normalized entropy of the displacement distribution: cost (B, H, W,
    du, dv) -> (B, H, W, 1)."""
    b, h, w, du, dv = cost.shape
    p = torch.softmax(cost.reshape(b, h, w, du * dv), dim=-1)
    plogp = -p * torch.log(p.clamp(eps, 1.0 - eps))
    return (plogp.sum(dim=-1) / math.log(du * dv))[..., None]


def soft_argmin_flow(cost):
    """Soft-argmin flow: cost (B, H, W, du, dv), du indexing the x
    displacement, dv the y one -> (B, H, W, 2) flow (u, v)."""
    b, h, w, du, dv = cost.shape
    ru, rv = (du - 1) // 2, (dv - 1) // 2
    prob = torch.softmax(cost.reshape(b, h, w, du * dv), dim=-1)
    prob = prob.reshape(b, h, w, du, dv)
    disp_u = torch.arange(-ru, ru + 1, dtype=cost.dtype, device=cost.device)
    disp_v = torch.arange(-rv, rv + 1, dtype=cost.dtype, device=cost.device)
    u = torch.einsum("bhwuv,u->bhw", prob, disp_u)
    v = torch.einsum("bhwuv,v->bhw", prob, disp_v)
    return torch.stack((u, v), dim=-1)


def displaced_pair_volume(feat1, feat2, disp_range):
    """(B, du, dv, H, W, 2C): at displacement (i - ru, j - rv) the second
    half holds ``feat2[p + d]`` (zero outside), and a hypothesis whose
    displaced features sum to exactly 0 (out of bounds, a hole) is zeroed
    whole; the sum is taken on a copy without gradient."""
    b, h, w, c = feat1.shape
    ru, rv = disp_range
    du, dv = 2 * ru + 1, 2 * rv + 1
    f2p = F.pad(feat2, (0, 0, ru, ru, rv, rv))
    shifted = torch.stack([
        torch.stack([f2p[:, j:j + h, i:i + w, :] for j in range(dv)], dim=1)
        for i in range(du)], dim=1)                     # (B, du, dv, H, W, C)
    valid = shifted.detach().sum(dim=-1, keepdim=True) != 0
    f1 = feat1[:, None, None].expand(shifted.shape)
    return torch.cat((f1 * valid, shifted * valid), dim=-1)


class MatchingNet(nn.Module):
    """The DICL-Flow matching net (``match``): the hybrid models'
    hourglass (``blocks.dicl.MatchingNet``) with the reference's ``conv`` /
    ``bn`` names, on the stacked volume (B, du, dv, H, W, 2C) -> cost (B,
    H, W, du, dv) float32."""

    def __init__(self, feature_dim):
        super().__init__()
        self.match = nn.Sequential(
            BasicConv(2 * feature_dim, 96),
            BasicConv(96, 128, stride=2),
            BasicConv(128, 128),
            BasicConv(128, 64),
            BasicConv(64, 32, num_groups=4, transposed=True),
            Conv2d(32, 1, 3),  # with bias, like the reference
        )

    def forward(self, mvol, train=False, frozen_bn=False):
        x, dims = matching_input(mvol)
        *blocks, out = self.match
        for block in blocks:
            x = block(x, train, frozen_bn)
        return cost_volume(out(x), dims)


def _context_net(level, input_dim):
    layers, c_in = [], input_dim
    for ch, dil in _CONTEXT_PLANS[min(max(level, 3), 6)]:
        layers.append(BasicConv(c_in, ch, dilation=dil))
        c_in = ch
    layers.append(Conv2d(c_in, 2, 3))  # with bias, like the reference
    return nn.Sequential(*layers)


class DiclModule(nn.Module):
    """The coarse-to-fine DICL ladder over ``levels`` (coarsest first in the
    loop; flow level L reads encoder level L - 1, H/2^L)."""

    def __init__(self, disp_ranges, dap_init="identity", feature_channels=32,
                 levels=(6, 5, 4, 3, 2)):
        super().__init__()
        if dap_init not in ("identity", "standard"):
            raise ValueError(f"unknown init value '{dap_init}'")
        self.levels = tuple(sorted(levels, reverse=True))
        self.disp_ranges = {lvl: tuple(disp_ranges[f"level-{lvl}"])
                            for lvl in self.levels}
        self.feature = FeatureEncoderGa(
            output_dim=feature_channels, depth=6,
            out_levels=tuple(lvl - 1 for lvl in sorted(levels)))
        for lvl in self.levels:
            ru, rv = self.disp_ranges[lvl]
            k2 = (2 * ru + 1) * (2 * rv + 1)
            setattr(self, f"matching{lvl}", MatchingNet(feature_channels))
            setattr(self, f"dap{lvl}", Conv2d(
                k2, k2, 1, bias=False,
                init="identity" if dap_init == "identity" else "lecun"))
            setattr(self, f"context_net{lvl}",
                    _context_net(lvl, feature_channels + 6))

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def _level(self, lvl, img1, feat1, feat2, flow_coarse, raw, dap, ctx,
               scale, train, frozen_bn):
        """One level: (flow, the pre-context flow if ``raw`` else None)."""
        b, h, w, _ = feat1.shape
        flow_up = None
        if flow_coarse is not None:
            flow_up = upsample_flow_2x(flow_coarse).detach()
            feat2, _ = warp.warp_backwards(feat2, flow_up)

        mvol = displaced_pair_volume(feat1, feat2, self.disp_ranges[lvl])
        cost = getattr(self, f"matching{lvl}")(mvol, train, frozen_bn)
        if dap:
            du, dv = cost.shape[-2:]
            proj = getattr(self, f"dap{lvl}")(
                cost.reshape(b, h, w, du * dv).permute(0, 3, 1, 2))
            cost = proj.permute(0, 2, 3, 1).reshape(b, h, w, du, dv)

        flow = soft_argmin_flow(cost)
        if flow_up is not None:
            flow = flow + flow_up
        flow_raw = flow if raw else None

        if ctx:
            img = interpolate_bilinear(img1, (h, w))
            entr = flow_entropy(cost).detach()
            ctxf = torch.cat((flow.detach(), entr, feat1, img), dim=-1)
            x = ctxf.permute(0, 3, 1, 2)
            *blocks, out = getattr(self, f"context_net{lvl}")
            for block in blocks:
                x = block(x, train, frozen_bn)
            flow = flow + out(x).permute(0, 2, 3, 1) * scale
        return flow, flow_raw

    def forward(self, img1, img2, train=False, frozen_bn=False, raw=False,
                dap=True, ctx=True, context_scale=None):
        """img1, img2: (B, H, W, 3), H and W divisible by 2^max(levels)
        (the configs pad to 128). Returns the level flows, finest first."""
        context_scale = context_scale or {f"level-{lvl}": 1.0
                                          for lvl in self.levels}
        finest = min(self.levels)
        f1, f2 = self.feature((img1.permute(0, 3, 1, 2),
                               img2.permute(0, 3, 1, 2)), train, frozen_bn)
        f1 = [f.permute(0, 2, 3, 1) for f in f1]         # finest first, NHWC
        f2 = [f.permute(0, 2, 3, 1) for f in f2]

        flow, out = None, []
        for lvl in self.levels:
            flow, flow_raw = self._level(
                lvl, img1, f1[lvl - finest], f2[lvl - finest], flow, raw, dap,
                ctx, context_scale[f"level-{lvl}"], train, frozen_bn)
            out = [flow, flow_raw] + out
        return [f for f in out if f is not None]


class _DiclModel(Model):
    """The config wrapper of both ladders."""

    levels = None

    def __init__(self, disp_ranges, dap_init="identity", feature_channels=32,
                 arguments={}, on_epoch_args={}, on_stage_args={}):
        self.disp_ranges = dict(disp_ranges)
        self.dap_init = dap_init
        self.feature_channels = feature_channels
        super().__init__(
            DiclModule(disp_ranges=dict(disp_ranges), dap_init=dap_init,
                       feature_channels=feature_channels, levels=self.levels),
            arguments=arguments,
            on_epoch_arguments=on_epoch_args,
            on_stage_arguments=on_stage_args,
        )

    def _config(self):
        return {
            "type": self.type,
            "parameters": {
                "feature-channels": self.feature_channels,
                "displacement-range": self.disp_ranges,
                "dap-init": self.dap_init,
            },
            "arguments": {
                "raw": False,
                "dap": True,
                "context_scale": {f"level-{lvl}": 1.0 for lvl in self.levels},
            } | self.arguments,
        }

    def get_adapter(self) -> ModelAdapter:
        return DiclAdapter(self)


@register_model
class Dicl(_DiclModel):
    """``dicl/baseline``: levels 6..2 over the p26 GA-Net features."""

    type = "dicl/baseline"
    levels = (6, 5, 4, 3, 2)

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            disp_ranges=p["displacement-range"],
            dap_init=p.get("dap-init", "identity"),
            feature_channels=p.get("feature-channels", 32),
            arguments=cfg.get("arguments", {}),
            on_epoch_args=cfg.get("on-epoch", {}),
            on_stage_args=cfg.get("on-stage", {"freeze_batchnorm": False}),
        )

    def __init__(self, disp_ranges, dap_init="identity", feature_channels=32,
                 arguments={}, on_epoch_args={},
                 on_stage_args={"freeze_batchnorm": False}):
        super().__init__(disp_ranges, dap_init, feature_channels, arguments,
                         on_epoch_args, on_stage_args)

    def get_config(self):
        return self._config() | {
            "on-stage": {"freeze_batchnorm": False} | self.on_stage_arguments,
            "on-epoch": dict(self.on_epoch_arguments),
        }


@register_model
class Dicl64to8(_DiclModel):
    """``dicl/64to8``: the DICL ladder stopped at 1/8, levels 6..3."""

    type = "dicl/64to8"
    levels = (6, 5, 4, 3)

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            disp_ranges=p["displacement-range"],
            dap_init=p.get("dap-init", "identity"),
            feature_channels=p.get("feature-channels", 32),
            arguments=cfg.get("arguments", {}),
        )

    def get_config(self):
        return self._config()


class DiclAdapter(ModelAdapter):
    def wrap_result(self, result, original_shape) -> Result:
        return DiclResult(result, original_shape)


def _resize_flow(flow, shape):
    """align-corners bilinear resize of a (B, h, w, 2) flow to ``shape``,
    the displacements scaled by the size ratio."""
    _, fh, fw, _ = flow.shape
    th, tw = shape
    flow = interpolate_bilinear(flow, (th, tw))
    return flow * torch.tensor([tw / fw, th / fh], dtype=flow.dtype,
                               device=flow.device)


class DiclResult(Result):
    """The level flows, finest (1/4) first."""

    def __init__(self, output, target_shape):
        super().__init__()
        self.result = output
        self.shape = target_shape  # (H, W) of the input images

    def output(self, batch_index=None):
        if batch_index is None:
            return self.result
        return [x[batch_index:batch_index + 1] for x in self.result]

    def final(self):
        return _resize_flow(self.result[0].detach(), self.shape)

    def intermediate_flow(self):
        return self.result


@register_loss
class MultiscaleLoss(Loss):
    """``dicl/multiscale``: weighted per-level distances of the flows
    upsampled to the target, averaged over the levels."""

    type = "dicl/multiscale"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("arguments", {}))

    def __init__(self, arguments={}):
        super().__init__(arguments)

    def get_config(self):
        default_args = {"ord": 2, "mode": "bilinear"}
        return {"type": self.type, "arguments": default_args | self.arguments}

    def compute(self, model, result, target, valid, weights, ord=2,
                mode="bilinear", valid_range=None):
        if mode != "bilinear":
            raise ValueError(f"unsupported upsampling mode '{mode}'")

        shape = tuple(target.shape[1:3])
        valid_f = valid.float()

        loss = 0.0
        for i, flow in enumerate(result):
            flow = _resize_flow(flow, shape)

            mask = valid_f
            if valid_range is not None:
                mask = mask * (target[..., 0].abs() < valid_range[i][0])
                mask = mask * (target[..., 1].abs() < valid_range[i][1])

            if ord == "robust":
                # the robust norm of the original DICL implementation
                dist = ((flow - target).abs().sum(dim=-1) + 1e-8) ** 0.4
            else:
                dist = torch.linalg.vector_norm(flow - target, ord=float(ord),
                                                dim=-1)

            mean = (dist * mask).sum() / torch.clamp(mask.sum(), min=1.0)
            loss = loss + weights[i] * mean

        return loss / len(result)
