"""Coarse-to-fine RAFT with a single-level correlation per pyramid level
(``raft/sl-ctf-l2``, ``-l3``, ``-l4``), PyTorch port: forward and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/raft_sl_ctf.py``. The
public layout is the JAX one: images (B, H, W, 3), flows (B, H, W, 2),
channel 0 = x. Per pyramid level, coarse to fine (level ids ``levels + 2``
down to 3; level L is 1/2^L): one all-pairs volume of that level's
features (``ops.corr``, a one-level pyramid), and per iteration its
windowed lookup, the soft-argmax readout and the update block, shared
over the levels or per level (``share_rnn``); the flow goes up a level by
bilinear 2x, the hidden state through a hidden-state upsampler; convex 8x
upsampling runs once a forward, batched over the finest level's
iterations, so the combine kernel launches once forward and once
backward.

The iterations are a plain loop: the JAX module's ``nn.scan`` /
``nn.remat`` / ``unroll`` are how XLA compiles the same recurrence (its
body holds no batch norm) and leave the numbers as they are. Every
iteration starts from the carried coordinates with their gradient stopped;
``corr_grad_stop`` also stops the gradient into the lookup.

Names: ``fnet``, ``cnet``, ``update_block`` (``update_block_{lvl}``
unshared), ``upnet_h`` (``upnet_h_{lvl}`` unshared, as in ctf),
``flow_reg_{lvl}``, ``upnet`` (``convert.sl_ctf_rules``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.corr import (
    correlation_pyramid_direct,
    flatten_levels,
    lookup_pyramid_levels,
)
from ...ops.upsample import upsample_flow_2x
from ..common import hsup
from ..common.adapters.mlseq import MultiLevelSequenceAdapter
from ..common.carry import upsample_iterations
from ..common.grid import coordinate_grid
from ..common.util import init_parameters
from ..config import register_model
from ..model import Model, ModelAdapter
from .raft import UpdateBlock, make_flow_regression
from .raft_dicl_ctf import _DEFAULT_ITERATIONS, _PYRAMIDS, Up8Network


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class RaftSlCtfModule(nn.Module):
    """Coarse-to-fine RAFT over ``levels`` pyramid levels, a single-level
    all-pairs correlation per level."""

    def __init__(self, levels=3, corr_radius=4, corr_channels=256,
                 context_channels=128, recurrent_channels=128, dropout=0.0,
                 encoder_norm="instance", context_norm="batch",
                 encoder_type="raft", context_type="raft",
                 corr_reg_type="softargmax", corr_reg_args=None,
                 share_rnn=True, upsample_hidden="none"):
        super().__init__()
        self.levels = levels
        self.corr_radius = corr_radius
        self.hidden_dim = recurrent_channels
        self.share_rnn = share_rnn
        self.upsample_hidden = upsample_hidden
        # level ids coarse -> fine, e.g. (5, 4, 3) for 3 levels
        self.level_ids = tuple(range(levels + 2, 2, -1))

        self.fnet = _PYRAMIDS[levels](encoder_type, output_dim=corr_channels,
                                      norm_type=encoder_norm, dropout=dropout)
        self.cnet = _PYRAMIDS[levels](
            context_type, output_dim=recurrent_channels + context_channels,
            norm_type=context_norm, dropout=dropout)

        def update():
            return UpdateBlock((2 * corr_radius + 1) ** 2, recurrent_channels,
                               context_channels)

        def hup():
            return hsup.make_hidden_state_upsampler(upsample_hidden,
                                                    recurrent_channels)

        if share_rnn:
            self.update_block = update()
            self.upnet_h = hup()
        else:
            for lvl in self.level_ids:
                setattr(self, f"update_block_{lvl}", update())
            for lvl in self.level_ids[1:]:
                setattr(self, f"upnet_h_{lvl}", hup())
        for lvl in self.level_ids:
            setattr(self, f"flow_reg_{lvl}", make_flow_regression(
                corr_reg_type, 1, corr_radius, **(corr_reg_args or {})))
        self.upnet = Up8Network(recurrent_channels)

    def _level(self, name, lvl):
        return getattr(self, name if self.share_rnn else f"{name}_{lvl}")

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def forward(self, img1, img2, train=False, frozen_bn=False,
                iterations=None, upnet=True, corr_flow=False,
                corr_grad_stop=False):
        """img1, img2: (B, H, W, 3). Returns a list of per-level iteration
        lists, coarse to fine (finest level upsampled to (H, W), the others
        at their level's grid); with ``corr_flow`` each level's soft-argmax
        readouts come before its flows. ``iterations`` is per level, coarse
        to fine."""
        iterations = tuple(iterations or _DEFAULT_ITERATIONS[self.levels])
        if len(iterations) != self.levels:
            raise ValueError(f"iterations {iterations}: need one count per "
                             f"level ({self.levels})")

        hdim = self.hidden_dim
        b, h, w = img1.shape[:3]
        x1, x2 = _nchw(img1), _nchw(img2)

        f1, f2 = self.fnet((x1, x2), train, frozen_bn)  # finest first, NCHW
        ctx = self.cnet(x1, train, frozen_bn)
        hidden = [torch.tanh(c[:, :hdim]) for c in ctx]
        context = [F.relu(c[:, hdim:]) for c in ctx]

        out = []
        flow = None
        h_state = None
        for li, lvl in enumerate(self.level_ids):
            fine_idx = lvl - 3  # index into the finest-first feature tuples
            lh, lw = h // 2**lvl, w // 2**lvl

            coords0 = coordinate_grid(b, lh, lw, device=img1.device)
            if flow is None:
                coords1 = coords0
                h_state = hidden[fine_idx]
            else:
                coords1 = coords0 + upsample_flow_2x(flow)
                h_state = self._level("upnet_h", lvl)(h_state,
                                                      hidden[fine_idx])
            x = context[fine_idx]
            update = self._level("update_block", lvl)
            reg = getattr(self, f"flow_reg_{lvl}")

            # this level's single-level all-pairs volume
            pyramid = correlation_pyramid_direct(
                _nhwc(f1[fine_idx]).float(), _nhwc(f2[fine_idx]).float(), 1)

            flows, hiddens, readouts = [], [], []
            for _ in range(iterations[li]):
                coords1 = coords1.detach()
                flow = coords1 - coords0
                corr = lookup_pyramid_levels(pyramid, coords1,
                                             self.corr_radius)
                if corr_flow:
                    readouts.append(flow + reg(corr)[0])
                if corr_grad_stop:
                    corr = [c.detach() for c in corr]

                h_state, d = update(h_state, x, _nchw(flatten_levels(corr)),
                                    _nchw(flow))
                coords1 = coords1 + _nhwc(d)
                flows.append(coords1 - coords0)
                hiddens.append(h_state)
            flow = flows[-1]

            if li == self.levels - 1:
                # convex 8x upsampling, batched over the level's iterations
                out_lvl = upsample_iterations(self.upnet, hiddens, flows,
                                              (h, w), upnet)
            else:
                out_lvl = flows

            if corr_flow:
                out.append(readouts)
            out.append(out_lvl)

        return out


class _SlCtfModel(Model):
    """Shared config wrapper for the three registered level counts."""

    levels = None

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            dropout=float(p.get("dropout", 0.0)),
            corr_radius=p.get("corr-radius", 4),
            corr_channels=p.get("corr-channels", 256),
            context_channels=p.get("context-channels", 128),
            recurrent_channels=p.get("recurrent-channels", 128),
            encoder_norm=p.get("encoder-norm", "instance"),
            context_norm=p.get("context-norm", "batch"),
            encoder_type=p.get("encoder-type", "raft"),
            context_type=p.get("context-type", "raft"),
            share_rnn=p.get("share-rnn", True),
            corr_reg_type=p.get("corr-reg-type", "softargmax"),
            corr_reg_args=p.get("corr-reg-args", {}),
            upsample_hidden=p.get("upsample-hidden", "none"),
            arguments=cfg.get("arguments", {}),
            on_stage_args=cfg.get("on-stage", {"freeze_batchnorm": True}),
            on_epoch_args=cfg.get("on-epoch", {}),
        )

    def __init__(self, dropout=0.0, corr_radius=4, corr_channels=256,
                 context_channels=128, recurrent_channels=128,
                 encoder_norm="instance", context_norm="batch",
                 encoder_type="raft", context_type="raft", share_rnn=True,
                 corr_reg_type="softargmax", corr_reg_args={},
                 upsample_hidden="none", arguments={}, on_epoch_args={},
                 on_stage_args={"freeze_batchnorm": True}):
        self.dropout = dropout
        self.corr_radius = corr_radius
        self.corr_channels = corr_channels
        self.context_channels = context_channels
        self.recurrent_channels = recurrent_channels
        self.encoder_norm = encoder_norm
        self.context_norm = context_norm
        self.encoder_type = encoder_type
        self.context_type = context_type
        self.share_rnn = share_rnn
        self.corr_reg_type = corr_reg_type
        self.corr_reg_args = dict(corr_reg_args)
        self.upsample_hidden = upsample_hidden

        super().__init__(
            RaftSlCtfModule(
                levels=self.levels, corr_radius=corr_radius,
                corr_channels=corr_channels,
                context_channels=context_channels,
                recurrent_channels=recurrent_channels, dropout=dropout,
                encoder_norm=encoder_norm, context_norm=context_norm,
                encoder_type=encoder_type, context_type=context_type,
                corr_reg_type=corr_reg_type,
                corr_reg_args=dict(corr_reg_args), share_rnn=share_rnn,
                upsample_hidden=upsample_hidden,
            ),
            arguments=arguments,
            on_epoch_arguments=on_epoch_args,
            on_stage_arguments=on_stage_args,
        )

    def get_config(self):
        default_args = {
            "iterations": _DEFAULT_ITERATIONS[self.levels],
            "upnet": True,
            "corr_flow": False,
            "corr_grad_stop": False,
        }
        return {
            "type": self.type,
            "parameters": {
                "dropout": self.dropout,
                "corr-radius": self.corr_radius,
                "corr-channels": self.corr_channels,
                "context-channels": self.context_channels,
                "recurrent-channels": self.recurrent_channels,
                "encoder-norm": self.encoder_norm,
                "context-norm": self.context_norm,
                "encoder-type": self.encoder_type,
                "context-type": self.context_type,
                "share-rnn": self.share_rnn,
                "corr-reg-type": self.corr_reg_type,
                "corr-reg-args": self.corr_reg_args,
                "upsample-hidden": self.upsample_hidden,
            },
            "arguments": default_args | self.arguments,
            "on-stage": {"freeze_batchnorm": True} | self.on_stage_arguments,
            "on-epoch": dict(self.on_epoch_arguments),
        }

    def get_adapter(self) -> ModelAdapter:
        return MultiLevelSequenceAdapter(self)


@register_model
class RaftSlCtfL2(_SlCtfModel):
    """``raft/sl-ctf-l2``."""

    type = "raft/sl-ctf-l2"
    levels = 2


@register_model
class RaftSlCtfL3(_SlCtfModel):
    """``raft/sl-ctf-l3``."""

    type = "raft/sl-ctf-l3"
    levels = 3


@register_model
class RaftSlCtfL4(_SlCtfModel):
    """``raft/sl-ctf-l4``."""

    type = "raft/sl-ctf-l4"
    levels = 4
