"""``wip/warp/1``, coarse-to-fine warping with a recurrent level unit (a
kept experiment), and the ``wip/warp/multiscale`` losses, PyTorch port:
forward and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/outdated/wip_warp.py``:
a GA-Net p26 pyramid (1/4..1/64), then coarse to fine one shared level
unit: frame 2's features warped backwards by the flow (its gradient
stopped), every integer displacement of ``disp_range`` stacked with frame
1 (``displaced_pair_volume``), that level's MatchingNet and DAP, a motion
encoder, a separable GRU (hidden 96) and a soft-argmin flow head. Between
levels the flow doubles (bilinear 2x) and the hidden state goes up half
nearest, half bilinear doubled. No kernel: the JAX module reaches none.
The public layout is the JAX one: images (B, H, W, 3), flows (B, H, W,
2), channel 0 = x; the result is a dict (``flow``: the level flows,
finest first; ``f1``, ``f2``; with ``corr_loss_examples`` the example
costs of ``raft_cl.example_costs``).

The flow head scores the (5, 5) displacement range whatever the model's
``disp_range``, as the JAX unit builds it with its default
(``_HEAD_RANGE``).

Names: ``fnet``, ``rlu`` (``cvnets.{i}``, ``daps.{i}``, ``menet.{0,1,2}``,
``gru``, ``fhead.{0,1}``) (``convert.wip_warp_rules``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ....ops.upsample import interpolate_bilinear, upsample_flow_2x
from ...common import warp
from ...common.blocks.dicl import DisplacementAwareProjection, MatchingNet
from ...common.encoders.dicl import FeatureEncoderGa
from ...common.util import Conv2d, init_parameters
from ...config import register_loss, register_model
from ...model import Loss, Model, ModelAdapter, Result
from ..dicl import _resize_flow, displaced_pair_volume, soft_argmin_flow
from ..raft import SepConvGru
from .raft_cl import corr_hinge, corr_mse, example_costs

_LEVELS = 5  # 1/4 .. 1/64
# the flow head's displacement range, whatever the model's: the JAX unit
# builds its head with the default
_HEAD_RANGE = (5, 5)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nearest_resize(x, size):
    """Nearest resize of ``x`` (B, H, W, C) to ``size``: row i of the
    output reads row ``i * H // nh``."""
    h, w = x.shape[1:3]
    nh, nw = size
    iy = torch.arange(nh, device=x.device) * h // nh
    ix = torch.arange(nw, device=x.device) * w // nw
    return x[:, iy][:, :, ix]


class _MotionEncoder(nn.Sequential):
    """Cost volume + frame-1 features + flow -> motion features: three 3x3
    convs, leaky relus between."""

    def __init__(self, input_dim, output_channels):
        super().__init__(Conv2d(input_dim, 128, 3), Conv2d(128, 128, 3),
                         Conv2d(128, output_channels, 3))

    def forward(self, cvol, cmap, flow):
        b, h, w, du, dv = cvol.shape
        x = _nchw(torch.cat((cvol.reshape(b, h, w, du * dv), cmap, flow),
                            dim=-1))
        first, second, out = self
        x = F.leaky_relu(first(x))
        x = F.leaky_relu(second(x))
        return _nhwc(out(x))


class _ScoreFlowHead(nn.Sequential):
    """Hidden state (NCHW) -> scores over _HEAD_RANGE's displacements (two
    1x1 convs, leaky relus) -> the soft-argmin delta flow (B, H, W, 2)."""

    def __init__(self, input_dim):
        du, dv = (2 * r + 1 for r in _HEAD_RANGE)
        super().__init__(Conv2d(input_dim, 256, 1), Conv2d(256, du * dv, 1))

    def forward(self, x):
        b, _, h, w = x.shape
        du, dv = (2 * r + 1 for r in _HEAD_RANGE)
        first, second = self
        score = F.leaky_relu(second(F.leaky_relu(first(x))))
        return soft_argmin_flow(_nhwc(score).reshape(b, h, w, du, dv))


class _RecurrentLevelUnit(nn.Module):
    """Warp -> per-level cost volume -> motion encoder -> GRU -> flow
    head."""

    def __init__(self, disp_range, feat_channels, hidden_dim):
        super().__init__()
        self.disp_range = tuple(disp_range)
        du, dv = (2 * r + 1 for r in self.disp_range)
        self.cvnets = nn.ModuleList(MatchingNet(feat_channels)
                                    for _ in range(_LEVELS))
        self.daps = nn.ModuleList(DisplacementAwareProjection(self.disp_range)
                                  for _ in range(_LEVELS))
        self.menet = _MotionEncoder(du * dv + feat_channels + 2, 96 - 2)
        self.gru = SepConvGru(hidden_dim, 96)
        self.fhead = _ScoreFlowHead(hidden_dim)

    def forward(self, fmap1, fmap2, h, flow, i, train=False, frozen_bn=False):
        """fmap1, fmap2 (B, H, W, C); h (B, hidden, H, W); flow (B, H, W,
        2). Returns the new hidden state and flow."""
        fmap2, _ = warp.warp_backwards(fmap2, flow.detach())

        mvol = displaced_pair_volume(fmap1, fmap2, self.disp_range)
        cvol = self.cvnets[i](mvol, train, frozen_bn)   # (B, H, W, du, dv)
        cvol = self.daps[i](cvol)

        x = torch.cat((self.menet(cvol, fmap1, flow), flow), dim=-1)
        h = self.gru(h, _nchw(x))
        return h, flow + self.fhead(h)


class WipWarpModule(nn.Module):
    """The coarse-to-fine warping network."""

    def __init__(self, disp_range=(5, 5), feat_channels=32, hidden_dim=96):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.fnet = FeatureEncoderGa(output_dim=feat_channels, depth=6,
                                     out_levels=(1, 2, 3, 4, 5))
        self.rlu = _RecurrentLevelUnit(disp_range, feat_channels, hidden_dim)

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def forward(self, img1, img2, train=False, frozen_bn=False,
                corr_loss_examples=False):
        """img1, img2: (B, H, W, 3), H and W divisible by 128 (the config
        pads to it). Returns the result dict."""
        f1, f2 = self.fnet((_nchw(img1), _nchw(img2)), train, frozen_bn)
        f1 = [_nhwc(f) for f in f1]                      # finest first, NHWC
        f2 = [_nhwc(f) for f in f2]

        b = img1.shape[0]
        h6, w6 = f1[-1].shape[1:3]
        flow = torch.zeros((b, h6, w6, 2), dtype=torch.float32,
                           device=img1.device)
        h = torch.zeros((b, self.hidden_dim, h6, w6), dtype=torch.float32,
                        device=img1.device)

        out = []
        for li in range(_LEVELS - 1, -1, -1):  # coarse -> fine
            size = tuple(f1[li].shape[1:3])
            if size != tuple(flow.shape[1:3]):
                flow = upsample_flow_2x(flow)
                c = self.hidden_dim // 2
                hn = _nhwc(h)
                h = _nchw(torch.cat((
                    _nearest_resize(hn[..., :c], size),
                    interpolate_bilinear(hn[..., c:], size) * 2.0), dim=-1))

            h, flow = self.rlu(f1[li], f2[li], h, flow, li, train, frozen_bn)
            out.append(flow)

        result = {"flow": out[::-1], "f1": f1, "f2": f2}  # finest first
        if corr_loss_examples:
            result["corr_pos"], result["corr_neg"] = example_costs(
                self.rlu.cvnets, _LEVELS, f1 + f2, train, frozen_bn)
        return result


@register_model
class WipWarp(Model):
    """``wip/warp/1``."""

    type = "wip/warp/1"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            disp_range=tuple(p.get("disp-range", (5, 5))),
            arguments=cfg.get("arguments", {}),
        )

    def __init__(self, disp_range=(5, 5), arguments={}):
        self.disp_range = tuple(disp_range)
        super().__init__(WipWarpModule(disp_range=self.disp_range),
                         arguments=arguments)

    def get_config(self):
        return {
            "type": self.type,
            "parameters": {"disp-range": list(self.disp_range)},
            "arguments": dict(self.arguments),
        }

    def get_adapter(self) -> ModelAdapter:
        return WipAdapter(self)


class WipAdapter(ModelAdapter):
    def wrap_result(self, result, original_shape) -> Result:
        return WipResult(result, original_shape)


class WipResult(Result):
    """The result dict, level flows finest first; ``final()`` resizes the
    finest to the input's size."""

    def __init__(self, output, target_shape):
        super().__init__()
        self.result = output
        self.shape = target_shape

    def output(self, batch_index=None):
        if batch_index is None:
            return self.result
        return {k: [x[batch_index:batch_index + 1] for x in v]
                for k, v in self.result.items()}

    def final(self):
        return _resize_flow(self.result["flow"][0].detach(), self.shape)

    def intermediate_flow(self):
        return self.result["flow"]


@register_loss
class WipMultiscaleLoss(Loss):
    """``wip/warp/multiscale``: weighted per-level distances of the flows
    resized to the target, averaged over the levels."""

    type = "wip/warp/multiscale"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("arguments", {}))

    def __init__(self, arguments={}):
        super().__init__(arguments)

    def get_config(self):
        default_args = {"ord": 2, "mode": "bilinear", "alpha": 1.0}
        return {"type": self.type, "arguments": default_args | self.arguments}

    def _flow_loss(self, result, target, valid, weights, ord, mode,
                   valid_range):
        if mode != "bilinear":
            raise ValueError(f"unsupported upsampling mode '{mode}'")

        shape = tuple(target.shape[1:3])
        valid_f = valid.float()

        loss = 0.0
        flows = result["flow"]
        for i, flow in enumerate(flows):
            flow = _resize_flow(flow, shape)

            mask = valid_f
            if valid_range is not None:
                mask = mask * (target[..., 0].abs() < valid_range[i][0])
                mask = mask * (target[..., 1].abs() < valid_range[i][1])

            if ord == "robust":
                dist = ((flow - target).abs().sum(dim=-1) + 1e-8) ** 0.4
            else:
                dist = torch.linalg.vector_norm(flow - target, ord=float(ord),
                                                dim=-1)

            mean = (dist * mask).sum() / torch.clamp(mask.sum(), min=1.0)
            loss = loss + weights[i] * mean

        return loss / len(flows)

    def compute(self, model, result, target, valid, weights, ord=2,
                mode="bilinear", alpha=1.0, valid_range=None):
        # ``alpha`` is taken and unused, as in the JAX loss: every
        # multiscale variant's config carries it
        return self._flow_loss(result, target, valid, weights, ord, mode,
                               valid_range)


@register_loss
class WipMultiscaleCorrHingeLoss(WipMultiscaleLoss):
    """``wip/warp/multiscale+corr_hinge``; needs the model argument
    ``corr_loss_examples=True``."""

    type = "wip/warp/multiscale+corr_hinge"

    def get_config(self):
        default_args = {"ord": 2, "mode": "bilinear", "margin": 1.0,
                        "alpha": 1.0}
        return {"type": self.type, "arguments": default_args | self.arguments}

    def compute(self, model, result, target, valid, weights, ord=2,
                mode="bilinear", margin=1.0, alpha=1.0, valid_range=None):
        return self._flow_loss(result, target, valid, weights, ord, mode,
                               valid_range) \
            + alpha * corr_hinge(result, margin)


@register_loss
class WipMultiscaleCorrMseLoss(WipMultiscaleLoss):
    """``wip/warp/multiscale+corr_mse``; needs the model argument
    ``corr_loss_examples=True``."""

    type = "wip/warp/multiscale+corr_mse"

    def get_config(self):
        default_args = {"ord": 2, "mode": "bilinear", "alpha": 1.0}
        return {"type": self.type, "arguments": default_args | self.arguments}

    def compute(self, model, result, target, valid, weights, ord=2,
                mode="bilinear", alpha=1.0, valid_range=None):
        return self._flow_loss(result, target, valid, weights, ord, mode,
                               valid_range) + alpha * corr_mse(result)
