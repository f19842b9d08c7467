"""RAFT+DICL single-level hybrid (``raft+dicl/sl``), PyTorch port: forward
and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/raft_dicl_sl.py``: s3
encoders and the RAFT GRU loop, the correlation features from a cost
module (``corr-type`` ``dicl``, ``dicl-1x1``, ``dicl-emb`` or ``dot``,
``make_cmod``) on the (2r+1)² window around the current flow, and a
soft-argmax readout per iteration. The public layout is the JAX one:
images (B, H, W, 3), flows (B, H, W, 2), channel 0 = x.

Each iteration is the JAX ``_CtfStep``: it starts from the carried flow
with its gradient stopped, and ``corr_grad_stop`` also stops the gradient
into the cost. In a train step each iteration's cost module is
checkpointed (``corr.common.checkpointed``, the JAX ``nn.remat`` that
keeps only the cost) when it holds a matching net: its activations are
recomputed in the backward, with live batch-norm statistics updated once.
``dot`` keeps no activations beyond its output and runs once. Convex 8x upsampling runs
once per forward over all iterations.

Names: ``fnet``, ``cnet``, ``corr``, ``flow_reg``, ``update_block``,
``upnet`` (``convert.sl_rules``). Mixed precision follows the JAX policy
(encoders, matching nets and update block in bf16, costs and flows
float32); the JAX module builds it with the ``raft`` encoders only, and
so does this one. The ladder carry (``flow_init``, ``hidden_init``,
``return_state``) is the JAX module's (``models/common/carry.py``); with
``return_state`` only the last iteration is upsampled.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import corr as corr_mod
from ..common import encoders
from ..common.carry import (initial_flow, initial_hidden, rung_state,
                            upsample_iterations)
from ..common.corr.common import checkpointed
from ..common.grid import coordinate_grid
from ..common.util import init_parameters
from ..config import register_model
from ..model import Model, ModelAdapter
from .raft import RaftAdapter, UpdateBlock
from .raft_dicl_ctf import Up8Network

_MATCHING = ("dicl", "dicl-1x1", "dicl-emb")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class RaftPlusDiclModule(nn.Module):
    """RAFT+DICL single-level network."""

    def __init__(self, dropout=0.0, mixed_precision=False, corr_radius=4,
                 corr_channels=32, context_channels=128,
                 recurrent_channels=128, dap_init="identity",
                 encoder_norm="instance", context_norm="batch",
                 mnet_norm="batch", corr_type="dicl", corr_args=None,
                 corr_reg_type="softargmax", corr_reg_args=None,
                 encoder_type="raft", context_type="raft"):
        super().__init__()
        self.hidden_dim = recurrent_channels
        self.corr_radius = corr_radius
        self.encoder_type = encoder_type
        self.context_type = context_type
        self.corr_type = corr_type

        dt = torch.bfloat16 if mixed_precision else None
        if dt is not None and (encoder_type != "raft"
                               or context_type != "raft"):
            # the JAX module hands its dtype to encoders that take none
            raise ValueError(
                "mixed-precision needs the raft encoders; got "
                f"encoder-type='{encoder_type}', "
                f"context-type='{context_type}'")
        self.compute_dtype = dt
        enc_kw = {"dtype": dt} if dt is not None else {}

        self.fnet = encoders.make_encoder_s3(
            encoder_type, output_dim=corr_channels, norm_type=encoder_norm,
            dropout=dropout, **enc_kw)
        self.cnet = encoders.make_encoder_s3(
            context_type, output_dim=recurrent_channels + context_channels,
            norm_type=context_norm, dropout=dropout, **enc_kw)

        corr_args = dict(corr_args or {})
        if dt is not None and corr_type in _MATCHING:
            corr_args.setdefault("dtype", dt)
        self.corr = corr_mod.make_cmod(
            corr_type, corr_channels, radius=corr_radius, dap_init=dap_init,
            norm_type=mnet_norm, **corr_args)
        self.flow_reg = corr_mod.make_flow_regression(
            corr_type, corr_reg_type, corr_radius, **(corr_reg_args or {}))
        self.update_block = UpdateBlock(self.corr.output_dim,
                                        recurrent_channels, context_channels,
                                        dtype=dt)
        self.upnet = Up8Network(recurrent_channels, dtype=dt)

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def forward(self, img1, img2, train=False, frozen_bn=False, iterations=12,
                dap=True, upnet=True, corr_flow=False, corr_grad_stop=False,
                flow_init=None, hidden_init=None, return_state=False):
        """img1, img2: (B, H, W, 3). Returns the per-iteration (B, H, W, 2)
        flows; with ``corr_flow`` ``[readouts, flows]``, the readouts the
        soft-argmax flows at 1/8. The ladder carry is raft/baseline's:
        ``flow_init``, ``hidden_init`` and ``return_state``."""
        hdim = self.hidden_dim
        x1, x2 = _nchw(img1), _nchw(img2)

        fmap1, fmap2 = self.fnet((x1, x2), train, frozen_bn)
        # NHWC-contiguous float32 (the JAX casts): the sampler kernel reads
        # f2 in place
        fmap1 = _nhwc(fmap1).float().contiguous()
        fmap2 = _nhwc(fmap2).float().contiguous()

        ctx = self.cnet(x1, train, frozen_bn)
        h = (initial_hidden(hidden_init, ctx) if hidden_init is not None
             else torch.tanh(ctx[:, :hdim]))
        x = F.relu(ctx[:, hdim:])

        b, hc, wc, _ = fmap1.shape
        coords0 = coordinate_grid(b, hc, wc, device=img1.device)
        flow = start = initial_flow(flow_init, b, hc, wc, img1.device)

        def cost(f1, f2, coords):
            return self.corr(f1, f2, coords, dap=dap, train=train,
                             frozen_bn=frozen_bn)

        flows, hiddens, readouts = [], [], []
        for _ in range(iterations):
            prev = flow.detach()
            coords1 = coords0 + prev
            if self.corr_type in _MATCHING:
                corr = checkpointed(self.corr, cost, fmap1, fmap2, coords1)
            else:
                # ``dot`` keeps nothing beyond its output to recompute
                corr = cost(fmap1, fmap2, coords1)
            if corr_flow:
                readouts.append(prev + self.flow_reg(corr))
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
            out = [readouts, out]
        if return_state:
            return out, rung_state(flows, start, h)
        return out


@register_model
class RaftPlusDicl(Model):
    """``raft+dicl/sl``."""

    type = "raft+dicl/sl"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            dropout=float(p.get("dropout", 0.0)),
            mixed_precision=bool(p.get("mixed-precision", False)),
            corr_radius=p.get("corr-radius", 4),
            corr_channels=p.get("corr-channels", 32),
            context_channels=p.get("context-channels", 128),
            recurrent_channels=p.get("recurrent-channels", 128),
            dap_init=p.get("dap-init", "identity"),
            encoder_norm=p.get("encoder-norm", "instance"),
            context_norm=p.get("context-norm", "batch"),
            mnet_norm=p.get("mnet-norm", "batch"),
            corr_type=p.get("corr-type", "dicl"),
            corr_args=p.get("corr-args", {}),
            corr_reg_type=p.get("corr-reg-type", "softargmax"),
            corr_reg_args=p.get("corr-reg-args", {}),
            encoder_type=p.get("encoder-type", "raft"),
            context_type=p.get("context-type", "raft"),
            arguments=cfg.get("arguments", {}),
            on_stage_args=cfg.get("on-stage", {"freeze_batchnorm": True}),
            on_epoch_args=cfg.get("on-epoch", {}),
        )

    def __init__(self, dropout=0.0, mixed_precision=False, corr_radius=4,
                 corr_channels=32, context_channels=128,
                 recurrent_channels=128, dap_init="identity",
                 encoder_norm="instance", context_norm="batch",
                 mnet_norm="batch", corr_type="dicl", corr_args={},
                 corr_reg_type="softargmax", corr_reg_args={},
                 encoder_type="raft", context_type="raft", arguments={},
                 on_epoch_args={}, on_stage_args={"freeze_batchnorm": True}):
        self.dropout = dropout
        self.mixed_precision = mixed_precision
        self.corr_radius = corr_radius
        self.corr_channels = corr_channels
        self.context_channels = context_channels
        self.recurrent_channels = recurrent_channels
        self.dap_init = dap_init
        self.encoder_norm = encoder_norm
        self.context_norm = context_norm
        self.mnet_norm = mnet_norm
        self.corr_type = corr_type
        self.corr_args = dict(corr_args)
        self.corr_reg_type = corr_reg_type
        self.corr_reg_args = dict(corr_reg_args)
        self.encoder_type = encoder_type
        self.context_type = context_type

        super().__init__(
            RaftPlusDiclModule(
                dropout=dropout, mixed_precision=mixed_precision,
                corr_radius=corr_radius, corr_channels=corr_channels,
                context_channels=context_channels,
                recurrent_channels=recurrent_channels, dap_init=dap_init,
                encoder_norm=encoder_norm, context_norm=context_norm,
                mnet_norm=mnet_norm, corr_type=corr_type,
                corr_args=dict(corr_args), corr_reg_type=corr_reg_type,
                corr_reg_args=dict(corr_reg_args), encoder_type=encoder_type,
                context_type=context_type,
            ),
            arguments=arguments,
            on_epoch_arguments=on_epoch_args,
            on_stage_arguments=on_stage_args,
        )

    def get_config(self):
        default_args = {
            "iterations": 12,
            "dap": True,
            "corr_flow": False,
            "corr_grad_stop": False,
            "upnet": True,
        }
        return {
            "type": self.type,
            "parameters": {
                "dropout": self.dropout,
                "mixed-precision": self.mixed_precision,
                "corr-radius": self.corr_radius,
                "corr-channels": self.corr_channels,
                "context-channels": self.context_channels,
                "recurrent-channels": self.recurrent_channels,
                "dap-init": self.dap_init,
                "encoder-norm": self.encoder_norm,
                "context-norm": self.context_norm,
                "mnet-norm": self.mnet_norm,
                "corr-type": self.corr_type,
                "corr-args": self.corr_args,
                "corr-reg-type": self.corr_reg_type,
                "corr-reg-args": self.corr_reg_args,
                "encoder-type": self.encoder_type,
                "context-type": self.context_type,
            },
            "arguments": default_args | self.arguments,
            "on-stage": {"freeze_batchnorm": True} | self.on_stage_arguments,
            "on-epoch": dict(self.on_epoch_arguments),
        }

    def get_adapter(self) -> ModelAdapter:
        return RaftAdapter(self)
