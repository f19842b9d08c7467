"""RAFT baseline (``raft/baseline``), PyTorch port: forward and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/raft.py``. The public
layout is the JAX one: images (B, H, W, 3), flows (B, H, W, 2) with
channel 0 = x. Convolutions run NCHW inside; parameter names follow torch
RAFT (``fnet``, ``cnet``, ``update_block.encoder.convc1``, ``...gru.convz1``,
``...flow_head.conv1``, ``update_block.mask.0`` / ``.2``), the names that
``scripts/chkpt_convert.py`` maps onto the JAX variable tree.

The GRU iterations are a Python loop. As in the JAX module, the convex 8x
upsampling runs once per forward, batched over all iterations, so its
kernels launch once per forward and once per backward. Every iteration
starts from the carried flow with its gradient stopped (JAX
``_RaftStep``: ``jax.lax.stop_gradient(flow)``); ``corr_grad_stop`` also
stops the gradient into the lookup. There is no activation checkpointing:
the JAX remat policy is a fit to the TPU's memory, not numerics. The
iteration ladder's carry (``flow_init``, ``hidden_init``,
``return_state``) is the JAX module's (``models/common/carry.py``); with
``return_state`` only the last iteration is upsampled.

Mixed precision (``mixed-precision: true``) follows the JAX policy: the
encoders, the correlation volume and the update block compute in bf16;
coords, flow, the soft-argmax and the Up8 softmax/combine stay float32;
the mask logits reach the kernel as bf16; the neighbour-flow window is
float32.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import quant as quant_ops
from ...ops.corr import (
    correlation_pyramid_direct,
    flatten_levels,
    lookup_pyramid_levels,
    window_delta,
)
from ...ops.upsample import convex_upsample_8x
from ..common import encoders
from ..common.blocks.dicl import DisplacementAwareProjection
from ..common.carry import (initial_flow, initial_hidden, rung_state,
                            upsample_iterations)
from ..common.grid import coordinate_grid
from ..common.util import Conv2d, init_parameters
from ..config import register_loss, register_model
from ..model import Loss, Model, ModelAdapter, Result


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class SoftArgMaxFlowRegression(nn.Module):
    """Cost -> flow readout: softmax-weighted displacement sum per level.

    Takes the per-level (B, H, W, K_dy, K_dx) windows; returns a list of
    per-level flow deltas (B, H, W, 2), scaled 2^level. With ``dap`` each
    level's (dx, dy) window first goes through its own identity-initialized
    displacement-aware projection (``dap.<level>``).
    """

    def __init__(self, num_levels, radius, temperature=1.0, dap=False):
        super().__init__()
        self.num_levels = num_levels
        self.radius = radius
        self.temperature = temperature
        if dap:
            self.dap = nn.ModuleList(DisplacementAwareProjection(radius)
                                     for _ in range(num_levels))
        else:
            self.dap = None

    def forward(self, corr):
        b, h, w = corr[0].shape[:3]
        k = 2 * self.radius + 1
        delta = window_delta(self.radius, corr[0].dtype, corr[0].device)

        out = []
        for lvl in range(self.num_levels):
            # per-level windows are (dy, dx); window_delta is dx-major
            score = corr[lvl].transpose(3, 4)
            if self.dap is not None:
                score = self.dap[lvl](score)
            score = score.reshape(b, h, w, k * k)
            score = torch.softmax(score / self.temperature, dim=-1)
            out.append(torch.einsum("bhwk,kc->bhwc", score,
                                    delta.reshape(k * k, 2) * 2**lvl))
        return out


def make_flow_regression(type, num_levels, radius, **kwargs):
    if type == "softargmax":
        return SoftArgMaxFlowRegression(num_levels, radius, dap=False,
                                        **kwargs)
    if type == "softargmax+dap":
        return SoftArgMaxFlowRegression(num_levels, radius, dap=True,
                                        **kwargs)
    raise ValueError(f"unknown correlation module type '{type}'")


class BasicMotionEncoder(nn.Module):
    """Correlation features + current flow -> 128 motion channels.

    ``convc1`` is the JAX ``_WindowConv1x1``: a 1x1 conv over the flat
    (level, dx, dy) lookup channels.
    """

    def __init__(self, corr_planes, dtype=None):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1, dtype=dtype)
        self.convc2 = Conv2d(256, 192, 3, dtype=dtype)
        self.convf1 = Conv2d(2, 128, 7, dtype=dtype)
        self.convf2 = Conv2d(128, 64, 3, dtype=dtype)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, dtype=dtype)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))

        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))

        out = F.relu(self.conv(torch.cat((cor, flo), dim=1)))
        return torch.cat((out, flow.to(out.dtype)), dim=1)


class SepConvGru(nn.Module):
    """Separable (1x5 then 5x1) convolutional GRU over (h, x).

    Per-gate convs ``convz1, convr1, convq1, convz2, convr2, convq2`` with
    input channels ordered (h, x) — the JAX ``Conv_0..5``.
    """

    def __init__(self, hidden_dim=128, input_dim=256, dtype=None):
        super().__init__()
        cin = hidden_dim + input_dim
        for i, ks in ((1, (1, 5)), (2, (5, 1))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{i}",
                        Conv2d(cin, hidden_dim, ks, dtype=dtype))
        self.compute_dtype = dtype

    def forward(self, h, x):
        cdt = self.compute_dtype or torch.float32
        x = x.to(cdt)
        for i in (1, 2):
            hx = torch.cat((h.to(cdt), x), dim=1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(
                torch.cat(((r * h).to(cdt), x), dim=1)))
            h = (1.0 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    """Hidden state -> delta flow (returned float32)."""

    def __init__(self, input_dim=128, hidden_dim=256, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, dtype=dtype)
        self.conv2 = Conv2d(hidden_dim, 2, 3, dtype=dtype)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x))).float()


class Up8Network(nn.Sequential):
    """Convex 8x upsampling: mask head (conv, relu, conv) + the convex
    combine.

    A Sequential so its convs are torch RAFT's ``update_block.mask.0`` /
    ``.2``. The convs run channels_last, so the (N, 576, h, w) logits are
    (N, h, w, 576)-contiguous and reach the kernel without a permute copy.
    """

    def __init__(self, hidden_dim=128, temperature=4.0, dtype=None):
        super().__init__(
            Conv2d(hidden_dim, 256, 3, dtype=dtype),
            nn.ReLU(),
            Conv2d(256, 8 * 8 * 9, 1, dtype=dtype),
        )
        self.temperature = temperature  # 4.0 = 1.0/0.25 in original RAFT

    def forward(self, hidden, flow):
        """hidden (N, C, h, w); flow (N, h, w, 2) float32 -> (N, 8h, 8w, 2)."""
        x = hidden.contiguous(memory_format=torch.channels_last)
        for layer in self:
            x = layer(x)
        return convex_upsample_8x(flow, _nhwc(x), temperature=self.temperature)


class UpdateBlock(nn.Module):
    """One recurrent update: motion encoding + GRU + flow head (the JAX
    ``BasicUpdateBlock``)."""

    def __init__(self, corr_planes, hidden_dim=128, context_dim=128,
                 dtype=None):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes, dtype=dtype)
        self.gru = SepConvGru(hidden_dim, context_dim + 128, dtype=dtype)
        self.flow_head = FlowHead(hidden_dim, 256, dtype=dtype)

    def forward(self, h, x, corr, flow):
        """h, x: NCHW; corr: (B, L*K*K, H, W) flat lookup; flow: NCHW f32.
        Returns the new hidden state and the delta flow (float32)."""
        m = self.encoder(flow, corr)
        x = torch.cat((x, m.to(x.dtype)), dim=1)
        h = self.gru(h, x)
        return h, self.flow_head(h)


class BasicUpdateBlock(UpdateBlock):
    """torch RAFT's update block: the recurrent update with the
    convex-upsampling head (``mask``) beside it; the head runs once per
    forward over all iterations (``RaftModule``)."""

    def __init__(self, corr_planes, hidden_dim=128, context_dim=128,
                 dtype=None):
        super().__init__(corr_planes, hidden_dim, context_dim, dtype)
        self.mask = Up8Network(hidden_dim, dtype=dtype)


class RaftModule(nn.Module):
    """RAFT flow estimation network."""

    def __init__(self, dropout=0.0, mixed_precision=False, corr_levels=4,
                 corr_radius=4, corr_channels=256, context_channels=128,
                 recurrent_channels=128, encoder_norm="instance",
                 context_norm="batch", encoder_type="raft",
                 context_type="raft", corr_reg_type="softargmax",
                 corr_reg_args=None):
        super().__init__()
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = recurrent_channels

        dt = torch.bfloat16 if mixed_precision else None
        self.compute_dtype = dt

        self.fnet = encoders.make_encoder_s3(
            encoder_type, output_dim=corr_channels, norm_type=encoder_norm,
            dropout=dropout, dtype=dt)
        self.cnet = encoders.make_encoder_s3(
            context_type, output_dim=recurrent_channels + context_channels,
            norm_type=context_norm, dropout=dropout, dtype=dt)

        corr_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.update_block = BasicUpdateBlock(
            corr_planes, recurrent_channels, context_channels, dtype=dt)
        self.corr_reg = make_flow_regression(
            corr_reg_type, corr_levels, corr_radius, **(corr_reg_args or {}))

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def forward(self, img1, img2, train=False, frozen_bn=False, iterations=12,
                flow_init=None, hidden_init=None, upnet=True, corr_flow=False,
                corr_grad_stop=False, mask_costs=(), return_state=False,
                quant=None, quant_clip=1.0):
        """img1, img2: (B, H, W, 3). Returns the list of per-iteration
        (B, H, W, 2) flows; with ``corr_flow`` also the per-level
        soft-argmax flows, coarse to fine, before it. ``train`` turns on
        dropout and batch-norm batch statistics, ``frozen_bn`` keeps batch
        norm on its running statistics while training;
        ``corr_grad_stop`` stops the gradient into the lookup.

        ``quant`` picks the quantized matching tier (``ops.quant``,
        inference only): ``u8`` stores the same pyramid at one byte an
        element, ``i8`` also computes the correlation as int8 dots; the
        lookup dequantizes. ``quant_clip`` is the fraction of each level's
        abs-max the quantized range spans. None leaves the forward as it
        is without the tier.

        The ladder carry: ``flow_init`` (B, H/8, W/8, 2) seeds the flow,
        ``hidden_init`` (B, H/8, W/8, C) replaces the context tanh, and
        ``return_state`` returns ``(out, {"flow", "hidden", "delta"})``
        with ``out`` the last iteration's upsampled flow alone."""
        hdim = self.hidden_dim
        dt = self.compute_dtype
        x1, x2 = _nchw(img1), _nchw(img2)

        fmap1, fmap2 = self.fnet((x1, x2), train, frozen_bn)
        if dt is None:
            fmap1, fmap2 = fmap1.float(), fmap2.float()
        qmode = quant_ops.normalize_mode(quant)
        if qmode == "i8":
            pyramid = quant_ops.correlation_pyramid_int8(
                _nhwc(fmap1), _nhwc(fmap2), self.corr_levels,
                clip=quant_clip)
        else:
            pyramid = correlation_pyramid_direct(
                _nhwc(fmap1), _nhwc(fmap2), self.corr_levels, dtype=dt)
            if qmode == "u8":
                pyramid = quant_ops.quantize_pyramid(pyramid, qmode,
                                                     clip=quant_clip)

        ctx = self.cnet(x1, train, frozen_bn)
        # a continuation rung re-enters from the carried hidden state
        h = (initial_hidden(hidden_init, ctx) if hidden_init is not None
             else torch.tanh(ctx[:, :hdim]))
        x = F.relu(ctx[:, hdim:])

        b, _, hc, wc = fmap1.shape
        coords0 = coordinate_grid(b, hc, wc, device=img1.device)
        flow = start = initial_flow(flow_init, b, hc, wc, img1.device)

        flows, hiddens, corr_flows = [], [], []
        for _ in range(iterations):
            flow = flow.detach()
            coords1 = coords0 + flow
            corr = lookup_pyramid_levels(pyramid, coords1, self.corr_radius,
                                         mask_costs)
            if corr_flow:
                corr_flows.append([flow + d for d in self.corr_reg(corr)])
            if corr_grad_stop:
                corr = [c.detach() for c in corr]

            h, d = self.update_block(h, x, _nchw(flatten_levels(corr)),
                                     _nchw(flow))

            coords1 = coords1 + _nhwc(d)
            flow = coords1 - coords0
            flows.append(flow)
            hiddens.append(h)

        # convex 8x upsampling, batched over all iterations at once
        out = upsample_iterations(self.update_block.mask, hiddens, flows,
                                  tuple(img1.shape[1:3]), upnet,
                                  last_only=return_state)

        if corr_flow:
            per_level = [[corr_flows[i][lvl] for i in range(iterations)]
                         for lvl in range(self.corr_levels)]
            out = (*reversed(per_level), out)
        if return_state:
            return out, rung_state(flows, start, h)
        return out


@register_model
class Raft(Model):
    """Config wrapper for ``raft/baseline``."""

    type = "raft/baseline"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        param_cfg = cfg["parameters"]
        return cls(
            dropout=float(param_cfg.get("dropout", 0.0)),
            mixed_precision=bool(param_cfg.get("mixed-precision", False)),
            corr_levels=param_cfg.get("corr-levels", 4),
            corr_radius=param_cfg.get("corr-radius", 4),
            corr_channels=param_cfg.get("corr-channels", 256),
            context_channels=param_cfg.get("context-channels", 128),
            recurrent_channels=param_cfg.get("recurrent-channels", 128),
            encoder_norm=param_cfg.get("encoder-norm", "instance"),
            context_norm=param_cfg.get("context-norm", "batch"),
            encoder_type=param_cfg.get("encoder-type", "raft"),
            context_type=param_cfg.get("context-type", "raft"),
            corr_reg_type=param_cfg.get("corr-reg-type", "softargmax"),
            corr_reg_args=param_cfg.get("corr-reg-args", {}),
            arguments=cfg.get("arguments", {}),
            on_stage_args=cfg.get("on-stage", {"freeze_batchnorm": True}),
            on_epoch_args=cfg.get("on-epoch", {}),
        )

    def __init__(self, dropout=0.0, mixed_precision=False, corr_levels=4,
                 corr_radius=4, corr_channels=256, context_channels=128,
                 recurrent_channels=128, encoder_norm="instance",
                 context_norm="batch", encoder_type="raft", context_type="raft",
                 corr_reg_type="softargmax", corr_reg_args={}, arguments={},
                 on_epoch_args={}, on_stage_args={"freeze_batchnorm": True}):
        self.dropout = dropout
        self.mixed_precision = mixed_precision
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.corr_channels = corr_channels
        self.context_channels = context_channels
        self.recurrent_channels = recurrent_channels
        self.encoder_norm = encoder_norm
        self.context_norm = context_norm
        self.encoder_type = encoder_type
        self.context_type = context_type
        self.corr_reg_type = corr_reg_type
        self.corr_reg_args = corr_reg_args

        super().__init__(
            RaftModule(
                dropout=dropout,
                mixed_precision=mixed_precision,
                corr_levels=corr_levels,
                corr_radius=corr_radius,
                corr_channels=corr_channels,
                context_channels=context_channels,
                recurrent_channels=recurrent_channels,
                encoder_norm=encoder_norm,
                context_norm=context_norm,
                encoder_type=encoder_type,
                context_type=context_type,
                corr_reg_type=corr_reg_type,
                corr_reg_args=corr_reg_args,
            ),
            arguments=arguments,
            on_epoch_arguments=on_epoch_args,
            on_stage_arguments=on_stage_args,
        )

    def get_config(self):
        default_args = {
            "iterations": 12,
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
                "encoder-norm": self.encoder_norm,
                "context-norm": self.context_norm,
                "encoder-type": self.encoder_type,
                "context-type": self.context_type,
                "corr-reg-type": self.corr_reg_type,
                "corr-reg-args": self.corr_reg_args,
            },
            "arguments": default_args | self.arguments,
            "on-stage": {"freeze_batchnorm": True} | self.on_stage_arguments,
            "on-epoch": dict(self.on_epoch_arguments),
        }

    def get_adapter(self) -> ModelAdapter:
        return RaftAdapter(self)


class RaftAdapter(ModelAdapter):
    def wrap_result(self, result, original_shape) -> Result:
        return RaftResult(result)


class RaftResult(Result):
    """Sequence of per-iteration flows; nested per-level lists when the
    corr-flow readouts are enabled."""

    def __init__(self, output):
        super().__init__()
        self.result = output
        self.has_corr_flow = any(isinstance(x, (list, tuple)) for x in output)

    def output(self, batch_index=None):
        if batch_index is None:
            return self.result

        def slice_one(x):
            return x[batch_index: batch_index + 1]

        if not self.has_corr_flow:
            return [slice_one(x) for x in self.result]
        return [[slice_one(x) for x in level] for level in self.result]

    def final(self):
        if not self.has_corr_flow:
            return self.result[-1]
        return self.result[-1][-1]

    def intermediate_flow(self):
        return self.result


@register_loss
class SequenceLoss(Loss):
    """gamma-weighted distance over the iteration sequence
    (``raft/sequence``)."""

    type = "raft/sequence"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("arguments", {}))

    def __init__(self, arguments={}):
        super().__init__(arguments)

    def get_config(self):
        default_args = {"ord": 1, "gamma": 0.8, "include_invalid": False}
        return {"type": self.type, "arguments": default_args | self.arguments}

    def compute(self, model, result, target, valid, ord=1, gamma=0.8,
                include_invalid=False):
        n = len(result)
        valid_f = valid.float()

        loss = 0.0
        for i, flow in enumerate(result):
            weight = gamma ** (n - i - 1)

            if ord == "absmean":
                dist = (flow - target).abs().mean(dim=-1)
            else:
                dist = torch.linalg.vector_norm(flow - target, ord=ord, dim=-1)

            if include_invalid:
                loss = loss + weight * (dist * valid_f).mean()
            else:
                loss = loss + weight * (dist * valid_f).sum() / torch.clamp(
                    valid_f.sum(), min=1.0)

        return loss
