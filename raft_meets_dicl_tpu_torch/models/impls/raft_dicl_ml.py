"""RAFT+DICL multi-level lookup hybrid (``raft+dicl/ml``), PyTorch port:
forward and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/raft_dicl_ml.py``.
Asymmetric encoders: frame 1 as a dilated feature stack, every level at
1/8 (``StackEncoder``), frame 2 as a strided pyramid (``PyramidEncoder``),
both over a RAFT s3 base of 256 channels (``encoder-type: raft-cnn``); or
one s3 encoder with frame 2 avg- or max-pooled per level
(``raft-avgpool`` / ``raft-maxpool``). Each iteration samples every level
of frame 2 around one 1/8 flow (the window sampler kernel at H/8·2^-i,
the coords divided by 2^i), runs the level's MatchingNet (shared with
``share-dicl``) and a DAP per level (``dap-type: separate``) or one over
all levels (``full``), and feeds the RAFT update block.

The MatchingNets run one level after the other, the JAX reference loop:
under live batch norm that is the order of its running-statistics updates
(the JAX batched path is off there and on the CPU). Each iteration starts
from the carried flow with its gradient stopped, and ``corr_grad_stop``
stops the gradient into the cost; in a train step each iteration's
correlation module is checkpointed (``corr.common.checkpointed``, the JAX
``nn.remat`` keeping only ``corr_features``). Public layout: images (B, H,
W, 3), flows (B, H, W, 2), channel 0 = x.

Names (``convert.ml_rules``): ``fnet`` (the s3 base), ``stack`` and
``pyramid`` (``out{i}`` heads: ``conv1``, ``norm1``, ``conv2``;
``res{i}`` residual blocks), ``cnet``, ``corr`` (``mnet_{i}`` or ``mnet``,
``dap_{i}`` or ``dap``, ``dap_full``), ``corr_reg`` (the raft readout,
``dap.{i}``), ``update_block``, ``upnet``. The ladder carry
(``flow_init``, ``hidden_init``, ``return_state``) is the JAX module's
(``models/common/carry.py``); with ``return_state`` only the last
iteration is upsampled.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.pool import avg_pool2d, max_pool2d
from ..common.blocks.dicl import DisplacementAwareProjection, MatchingNet
from ..common.blocks.raft import ResidualBlock
from ..common.carry import (initial_flow, initial_hidden, rung_state,
                            upsample_iterations)
from ..common.corr.common import checkpointed, sample_window_fast
from ..common.encoders.raft import FeatureEncoderS3
from ..common.grid import coordinate_grid
from ..common.norm import make_norm2d
from ..common.util import Conv2d, init_parameters
from ..config import register_model
from ..model import Model, ModelAdapter
from .raft import RaftAdapter, UpdateBlock, make_flow_regression
from .raft_dicl_ctf import Up8Network


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class _OutputNet(nn.Module):
    """Level head: dilated 3x3 conv (128), norm, relu, 1x1 conv."""

    def __init__(self, input_dim, output_dim, dilation=1, norm_type="batch"):
        super().__init__()
        self.conv1 = Conv2d(input_dim, 128, 3, dilation=dilation,
                            init="kaiming")
        self.norm1 = make_norm2d(norm_type, 128, 8)
        self.conv2 = Conv2d(128, output_dim, 1, init="kaiming")

    def forward(self, x, train=False, frozen_bn=False):
        x = F.relu(self.norm1(self.conv1(x), train and not frozen_bn))
        return self.conv2(x)


class _LevelEncoder(nn.Module):
    """Heads ``out0..`` over a chain of residual blocks ``res1..``: level
    0 reads the input, level i the i-th block's output."""

    def __init__(self, output_dim, levels, norm_type, channels, strides,
                 dilations):
        super().__init__()
        if not 1 <= levels <= 4:
            raise ValueError("levels must be between 1 and 4 (inclusive)")
        self.levels = levels
        self.out0 = _OutputNet(256, output_dim, 1, norm_type)
        c_in = 256
        for lvl in range(1, levels):
            setattr(self, f"res{lvl}", ResidualBlock(
                c_in, channels[lvl - 1], norm_type, stride=strides))
            c_in = channels[lvl - 1]
            setattr(self, f"out{lvl}", _OutputNet(
                c_in, output_dim, dilations[lvl], norm_type))

    def forward(self, x, train=False, frozen_bn=False):
        outs = [self.out0(x, train, frozen_bn)]
        for lvl in range(1, self.levels):
            x = getattr(self, f"res{lvl}")(x, train, frozen_bn)
            outs.append(getattr(self, f"out{lvl}")(x, train, frozen_bn))
        return tuple(outs)


class StackEncoder(_LevelEncoder):
    """Frame-1 stack: every level at 1/8, dilation 2^level."""

    def __init__(self, output_dim, levels=4, norm_type="batch"):
        super().__init__(output_dim, levels, norm_type, (256, 256, 256), 1,
                         (1, 2, 4, 8))


class PyramidEncoder(_LevelEncoder):
    """Frame-2 pyramid: strided stages of 384 / 576 / 864 channels."""

    def __init__(self, output_dim, levels=4, norm_type="batch"):
        super().__init__(output_dim, levels, norm_type, (384, 576, 864), 2,
                         (1, 1, 1, 1))


class MlCorrelationModule(nn.Module):
    """The multi-level DICL lookup around one 1/8 flow: per level the window
    of frame 2's level (the sampler kernel), the level's MatchingNet on the
    unstacked (f1, window) pair, and the DAP; costs concatenated level by
    level, (B, H, W, levels·(2r+1)²) float32."""

    def __init__(self, feature_dim, levels, radius, dap_init="identity",
                 dap_type="separate", norm_type="batch", share=False,
                 dtype=None):
        super().__init__()
        if dap_type not in ("full", "separate"):
            raise ValueError(f"DAP type '{dap_type}' not supported")
        self.levels = levels
        self.radius = radius
        self.dap_type = dap_type
        self.share = share
        self.compute_dtype = dtype
        k2 = (2 * radius + 1) ** 2

        def mnet():
            return MatchingNet(feature_dim, norm_type=norm_type, dtype=dtype)

        def dap():
            return DisplacementAwareProjection(radius, init=dap_init)

        if share:
            self.mnet = mnet()
            if dap_type == "separate":
                self.dap = dap()
        else:
            for i in range(levels):
                setattr(self, f"mnet_{i}", mnet())
                if dap_type == "separate":
                    setattr(self, f"dap_{i}", dap())
        if dap_type == "full":
            self.dap_full = Conv2d(
                levels * k2, levels * k2, 1, bias=False,
                init="identity" if dap_init == "identity" else "lecun")

    def _level(self, name, i):
        return getattr(self, name if self.share else f"{name}_{i}")

    def forward(self, fmap1, fmap2, coords, dap=True, mask_costs=(),
                train=False, frozen_bn=False):
        b, h, w, _ = coords.shape
        k = 2 * self.radius + 1

        out = []
        for i, (f1, f2) in enumerate(zip(fmap1, fmap2)):
            window = sample_window_fast(f2, coords / 2**i, self.radius)
            if self.compute_dtype is not None:
                f1 = f1.to(self.compute_dtype)
                window = window.to(self.compute_dtype)
            cost = self._level("mnet", i)((f1, window), train, frozen_bn)
            if i + 3 in mask_costs:
                cost = torch.zeros_like(cost)
            if dap and self.dap_type == "separate":
                cost = self._level("dap", i)(cost)
            out.append(cost.reshape(b, h, w, k * k))
        out = torch.cat(out, dim=-1)

        if dap and self.dap_type == "full":
            out = _nhwc(self.dap_full(_nchw(out)))
        return out


class RaftPlusDiclMlModule(nn.Module):
    """RAFT+DICL multi-level network."""

    def __init__(self, dropout=0.0, mixed_precision=False, corr_levels=4,
                 corr_radius=4, corr_channels=32, context_channels=128,
                 recurrent_channels=128, dap_init="identity",
                 dap_type="separate", encoder_norm="instance",
                 context_norm="batch", mnet_norm="batch",
                 encoder_type="raft-cnn", share_dicl=False,
                 corr_reg_type="softargmax", corr_reg_args=None):
        super().__init__()
        self.hidden_dim = recurrent_channels
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.encoder_type = encoder_type
        self.dap_type = dap_type
        self.share_dicl = share_dicl

        dt = torch.bfloat16 if mixed_precision else None
        self.compute_dtype = dt

        if encoder_type == "raft-cnn":
            self.fnet = FeatureEncoderS3(output_dim=256,
                                         norm_type=encoder_norm, dropout=0,
                                         dtype=dt)
            self.stack = StackEncoder(corr_channels, corr_levels,
                                      encoder_norm)
            self.pyramid = PyramidEncoder(corr_channels, corr_levels,
                                          encoder_norm)
        elif encoder_type in ("raft-avgpool", "raft-maxpool"):
            self.fnet = FeatureEncoderS3(output_dim=corr_channels,
                                         norm_type=encoder_norm, dropout=0,
                                         dtype=dt)
        else:
            raise ValueError(f"unknown encoder type: '{encoder_type}'")

        self.cnet = FeatureEncoderS3(
            output_dim=recurrent_channels + context_channels,
            norm_type=context_norm, dropout=dropout, dtype=dt)
        self.corr = MlCorrelationModule(
            corr_channels, corr_levels, corr_radius, dap_init=dap_init,
            dap_type=dap_type, norm_type=mnet_norm, share=share_dicl,
            dtype=dt)
        self.corr_reg = make_flow_regression(corr_reg_type, corr_levels,
                                             corr_radius,
                                             **(corr_reg_args or {}))
        k2 = (2 * corr_radius + 1) ** 2
        self.update_block = UpdateBlock(corr_levels * k2, recurrent_channels,
                                        context_channels, dtype=dt)
        self.upnet = Up8Network(recurrent_channels, dtype=dt)

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def _features(self, x1, x2, train, frozen_bn):
        """Per-level frame-1 and frame-2 features, NHWC float32
        (contiguous: the sampler kernel reads f2 in place)."""
        f1, f2 = self.fnet((x1, x2), train, frozen_bn)
        f1, f2 = f1.float(), f2.float()
        if self.encoder_type == "raft-cnn":
            fmap1 = self.stack(f1, train, frozen_bn)
            fmap2 = self.pyramid(f2, train, frozen_bn)
        else:
            pool = (avg_pool2d if self.encoder_type == "raft-avgpool"
                    else max_pool2d)
            f1 = _nhwc(f1)
            fmap1 = (f1,) * self.corr_levels
            fmap2 = [_nhwc(f2)]
            for _ in range(1, self.corr_levels):
                fmap2.append(pool(fmap2[-1], 2))
            return fmap1, tuple(f.contiguous() for f in fmap2)
        return (tuple(_nhwc(f).contiguous() for f in fmap1),
                tuple(_nhwc(f).contiguous() for f in fmap2))

    def forward(self, img1, img2, train=False, frozen_bn=False, iterations=12,
                dap=True, upnet=True, corr_flow=False, corr_grad_stop=False,
                flow_init=None, hidden_init=None, mask_costs=(),
                return_state=False):
        """img1, img2: (B, H, W, 3). Returns the per-iteration (B, H, W, 2)
        flows; with ``corr_flow`` each level's soft-argmax flows first,
        coarse to fine, then the flows. The ladder carry is
        raft/baseline's: ``flow_init``, ``hidden_init`` and
        ``return_state``."""
        hdim = self.hidden_dim
        levels = self.corr_levels
        k = 2 * self.corr_radius + 1
        x1, x2 = _nchw(img1), _nchw(img2)

        fmap1, fmap2 = self._features(x1, x2, train, frozen_bn)
        ctx = self.cnet(x1, train, frozen_bn)
        h = (initial_hidden(hidden_init, ctx) if hidden_init is not None
             else torch.tanh(ctx[:, :hdim]))
        x = F.relu(ctx[:, hdim:])

        b, hc, wc, _ = fmap1[0].shape
        coords0 = coordinate_grid(b, hc, wc, device=img1.device)
        flow = start = initial_flow(flow_init, b, hc, wc, img1.device)
        mask_costs = tuple(mask_costs)

        def cost(coords, *fmaps):
            return self.corr(fmaps[:levels], fmaps[levels:], coords, dap=dap,
                             mask_costs=mask_costs, train=train,
                             frozen_bn=frozen_bn)

        flows, hiddens, corr_flows = [], [], []
        for _ in range(iterations):
            prev = flow.detach()
            coords1 = coords0 + prev
            corr = checkpointed(self.corr, cost, coords1, *fmap1, *fmap2)
            if corr_flow:
                # the raft readout takes per-level (dy, dx) windows; the
                # flat channels are (level, dx, dy)
                windows = [corr[..., i * k * k:(i + 1) * k * k]
                           .reshape(b, hc, wc, k, k).transpose(3, 4)
                           for i in range(levels)]
                corr_flows.append([prev + d for d in self.corr_reg(windows)])
            if corr_grad_stop:
                corr = corr.detach()

            h, d = self.update_block(h, x, _nchw(corr), _nchw(prev))
            flow = coords1 + _nhwc(d) - coords0
            flows.append(flow)
            hiddens.append(h)

        out = upsample_iterations(self.upnet, hiddens, flows,
                                  tuple(img1.shape[1:3]), upnet,
                                  last_only=return_state)
        if corr_flow:
            per_level = [[cf[lvl] for cf in corr_flows]
                         for lvl in range(levels)]
            out = [*reversed(per_level), out]  # coarse to fine, then final
        if return_state:
            return out, rung_state(flows, start, h)
        return out


@register_model
class RaftPlusDiclMl(Model):
    """``raft+dicl/ml``."""

    type = "raft+dicl/ml"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            dropout=float(p.get("dropout", 0.0)),
            mixed_precision=bool(p.get("mixed-precision", False)),
            corr_levels=p.get("corr-levels", 4),
            corr_radius=p.get("corr-radius", 4),
            corr_channels=p.get("corr-channels", 32),
            context_channels=p.get("context-channels", 128),
            recurrent_channels=p.get("recurrent-channels", 128),
            dap_init=p.get("dap-init", "identity"),
            dap_type=p.get("dap-type", "separate"),
            encoder_norm=p.get("encoder-norm", "instance"),
            context_norm=p.get("context-norm", "batch"),
            mnet_norm=p.get("mnet-norm", "batch"),
            encoder_type=p.get("encoder-type", "raft-cnn"),
            share_dicl=p.get("share-dicl", False),
            corr_reg_type=p.get("corr-reg-type", "softargmax"),
            corr_reg_args=p.get("corr-reg-args", {}),
            arguments=cfg.get("arguments", {}),
            on_stage_args=cfg.get("on-stage", {"freeze_batchnorm": True}),
            on_epoch_args=cfg.get("on-epoch", {}),
        )

    def __init__(self, dropout=0.0, mixed_precision=False, corr_levels=4,
                 corr_radius=4, corr_channels=32, context_channels=128,
                 recurrent_channels=128, dap_init="identity",
                 dap_type="separate", encoder_norm="instance",
                 context_norm="batch", mnet_norm="batch",
                 encoder_type="raft-cnn", share_dicl=False,
                 corr_reg_type="softargmax", corr_reg_args={}, arguments={},
                 on_epoch_args={}, on_stage_args={"freeze_batchnorm": True}):
        self.dropout = dropout
        self.mixed_precision = mixed_precision
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.corr_channels = corr_channels
        self.context_channels = context_channels
        self.recurrent_channels = recurrent_channels
        self.dap_init = dap_init
        self.dap_type = dap_type
        self.encoder_norm = encoder_norm
        self.context_norm = context_norm
        self.mnet_norm = mnet_norm
        self.encoder_type = encoder_type
        self.share_dicl = share_dicl
        self.corr_reg_type = corr_reg_type
        self.corr_reg_args = dict(corr_reg_args)

        super().__init__(
            RaftPlusDiclMlModule(
                dropout=dropout, mixed_precision=mixed_precision,
                corr_levels=corr_levels, corr_radius=corr_radius,
                corr_channels=corr_channels,
                context_channels=context_channels,
                recurrent_channels=recurrent_channels, dap_init=dap_init,
                dap_type=dap_type, encoder_norm=encoder_norm,
                context_norm=context_norm, mnet_norm=mnet_norm,
                encoder_type=encoder_type, share_dicl=share_dicl,
                corr_reg_type=corr_reg_type,
                corr_reg_args=dict(corr_reg_args),
            ),
            arguments=arguments,
            on_epoch_arguments=on_epoch_args,
            on_stage_arguments=on_stage_args,
        )

    def get_config(self):
        default_args = {
            "iterations": 12,
            "dap": True,
            "upnet": True,
            "corr_flow": False,
            "corr_grad_stop": False,
            "mask_costs": [],
        }
        return {
            "type": self.type,
            "parameters": {
                "dropout": self.dropout,
                "mixed-precision": self.mixed_precision,
                "corr-levels": self.corr_levels,
                "corr-radius": self.corr_radius,
                "corr-channels": self.corr_channels,
                "context-channels": self.context_channels,
                "recurrent-channels": self.recurrent_channels,
                "dap-init": self.dap_init,
                "dap-type": self.dap_type,
                "encoder-norm": self.encoder_norm,
                "context-norm": self.context_norm,
                "mnet-norm": self.mnet_norm,
                "encoder-type": self.encoder_type,
                "share-dicl": self.share_dicl,
                "corr-reg-type": self.corr_reg_type,
                "corr-reg-args": self.corr_reg_args,
            },
            "arguments": default_args | self.arguments,
            "on-stage": {"freeze_batchnorm": True} | self.on_stage_arguments,
            "on-epoch": dict(self.on_epoch_arguments),
        }

    def get_adapter(self) -> ModelAdapter:
        return RaftAdapter(self)
