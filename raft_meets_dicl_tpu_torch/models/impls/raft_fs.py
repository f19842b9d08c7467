"""RAFT with on-the-fly windowed correlation (``raft/fs``), PyTorch port:
forward and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/raft_fs.py``, the
repository's high-resolution model. The second frame's features are
avg-pooled into a pyramid; per pyramid level the model either
materializes the all-pairs volume against the pooled map once and looks
it up every iteration, or computes the level's correlation window on the
fly every iteration (the ``windowed_corr_pyramid`` kernels), never
building the O(H²W²) volume. ``volume_level_split`` picks the split per
level from the ``RMD_FS_VOLUME_GIB`` budget; both realizations compute the
same function (pooling and bilinear sampling commute with the dot
product), unnormalized (no 1/sqrt(C)).

The public layout is the JAX one: images (B, H, W, 3), flows (B, H, W, 2)
with channel 0 = x. The parameters are ``raft/baseline``'s without the
readout (``fnet``, ``cnet``, ``update_block.*``, ``update_block.mask.*``),
so the same modules and the same bridge rules serve both; the JAX tree
names the scan body ``ScanCheckpoint_FsStep_0``.

The GRU iterations are a Python loop that starts each iteration from the
carried flow with its gradient stopped; the convex 8x upsampling runs once
per forward over all iterations. There is no activation checkpointing (the
JAX ``nn.remat`` fits the TPU's memory, not the numerics). The ladder
carry (``flow_init``, ``hidden_init``, ``return_state``) is the JAX
module's (``models/common/carry.py``), with ``quant`` or without; with
``return_state`` only the last iteration is upsampled. ``quant`` (the quantized matching tier,
``ops.quant``) stores the materialized coarse suffix of volumes at one
byte an element; the windowed prefix has no volume to quantize, so both
modes are storage quantization here, as in the JAX module.

Mixed precision (``mixed-precision: true``) follows the JAX policy: the
encoders and the update block compute in bf16, the feature maps stay bf16
(the kernels accumulate in float32), the volumes are stored in bf16;
correlation outputs, coords and flows are float32.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import quant as quant_ops
from ...ops.corr import (
    correlation_volume,
    flatten_levels,
    lookup_pyramid_levels,
)
from ...ops.pool import avg_pool2d
from ...ops.windowed import windowed_corr_pyramid
from ...utils import env
from ..common import encoders
from ..common.carry import (initial_flow, initial_hidden, rung_state,
                            upsample_iterations)
from ..common.grid import coordinate_grid
from ..common.util import init_parameters
from ..config import register_model
from ..model import Model, ModelAdapter
from .raft import BasicUpdateBlock, RaftAdapter


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def volume_level_split(coarse_shape, corr_levels, itemsize, budget_gib=None):
    """How many fine pyramid levels stay on the windowed kernel.

    Walks the pyramid from the coarsest level (each volume is 4x the next
    coarser one) and moves levels onto materialized volumes while twice
    their running total (the 2x charges the backward's volume gradient)
    fits the budget, ``RMD_FS_VOLUME_GIB`` GiB by default (4.0; 0 puts
    every level on the kernel). Returns ``n_windowed``: levels
    ``[0, n_windowed)`` are computed on the fly, the rest are volumes.

    ``coarse_shape`` is (B, H/8, W/8). The budget is per device, and the
    port runs the batch on one device.
    """
    if budget_gib is None:
        budget_gib = env.get_float("RMD_FS_VOLUME_GIB")
    budget = budget_gib * 2 ** 30

    b0, hc0, wc0 = coarse_shape
    vol_bytes = [b0 * hc0 * wc0 * (hc0 // 2 ** l) * (wc0 // 2 ** l) * itemsize
                 for l in range(corr_levels)]
    n_windowed = corr_levels
    total = 0
    for l in reversed(range(corr_levels)):
        if 2 * (total + vol_bytes[l]) > budget:
            break
        total += vol_bytes[l]
        n_windowed = l
    return n_windowed


class RaftFsModule(nn.Module):
    """RAFT-fs network."""

    def __init__(self, dropout=0.0, mixed_precision=False, corr_levels=4,
                 corr_radius=4, corr_channels=256, context_channels=128,
                 recurrent_channels=128, encoder_norm="instance",
                 context_norm="batch"):
        super().__init__()
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = recurrent_channels

        dt = torch.bfloat16 if mixed_precision else None
        self.compute_dtype = dt

        self.fnet = encoders.make_encoder_s3(
            "raft", output_dim=corr_channels, norm_type=encoder_norm,
            dropout=dropout, dtype=dt)
        self.cnet = encoders.make_encoder_s3(
            "raft", output_dim=recurrent_channels + context_channels,
            norm_type=context_norm, dropout=dropout, dtype=dt)

        corr_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.update_block = BasicUpdateBlock(
            corr_planes, recurrent_channels, context_channels, dtype=dt)

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def forward(self, img1, img2, train=False, frozen_bn=False, iterations=12,
                upnet=True, mask_costs=(), flow_init=None, hidden_init=None,
                return_state=False, quant=None, quant_clip=1.0):
        """img1, img2: (B, H, W, 3). Returns the list of per-iteration
        (B, H, W, 2) flows. ``train`` turns on dropout and batch-norm batch
        statistics, ``frozen_bn`` keeps batch norm on its running
        statistics while training. ``quant`` (``u8``/``i8``, inference
        only) quantizes the volume levels, ``quant_clip`` the fraction of
        each level's abs-max the quantized range spans. The ladder carry
        is raft/baseline's: ``flow_init``, ``hidden_init`` and
        ``return_state`` (``(out, {"flow", "hidden", "delta"})``, ``out``
        the last iteration's upsampled flow alone)."""
        hdim = self.hidden_dim
        dt = self.compute_dtype
        levels = self.corr_levels
        radius = self.corr_radius
        x1, x2 = _nchw(img1), _nchw(img2)

        fmap1, fmap2 = self.fnet((x1, x2), train, frozen_bn)
        if dt is None:
            fmap1, fmap2 = fmap1.float(), fmap2.float()
        # NHWC-contiguous once: the kernels read f1 and the pooled levels
        # in place (under the bf16 policy they stay bf16)
        f1 = _nhwc(fmap1).contiguous()
        f2 = _nhwc(fmap2).contiguous()

        b, hc, wc = f1.shape[:3]
        n_win = volume_level_split((b, hc, wc), levels,
                                   2 if dt is not None else 4)

        # the pooled f2 pyramid; the coarse suffix [n_win, L) becomes
        # volumes against the same pooled maps
        f2_pyramid = [f2]
        for _ in range(1, levels):
            f2_pyramid.append(avg_pool2d(f2_pyramid[-1], 2))
        windowed = f2_pyramid[:n_win]
        volumes = [correlation_volume(f1, f2l, dtype=dt, normalize=False)
                   for f2l in f2_pyramid[n_win:]]
        qmode = quant_ops.normalize_mode(quant)
        if qmode is not None:
            volumes = quant_ops.quantize_pyramid(volumes, qmode,
                                                 clip=quant_clip)

        ctx = self.cnet(x1, train, frozen_bn)
        h = (initial_hidden(hidden_init, ctx) if hidden_init is not None
             else torch.tanh(ctx[:, :hdim]))
        x = F.relu(ctx[:, hdim:])

        coords0 = coordinate_grid(b, hc, wc, device=img1.device)
        flow = start = initial_flow(flow_init, b, hc, wc, img1.device)

        flows, hiddens = [], []
        for _ in range(iterations):
            flow = flow.detach()
            coords1 = coords0 + flow

            # the kernel's flat (level, dx, dy) chunk for the windowed
            # prefix, then the volume levels flattened in the same order:
            # the channel layout of the JAX _WindowConv1x1 mixed list
            corr = []
            if windowed:
                corr.append(windowed_corr_pyramid(
                    f1, windowed, coords1, radius, mask_costs=mask_costs,
                    normalize=False))
            if volumes:
                corr.append(flatten_levels(lookup_pyramid_levels(
                    volumes, coords1, radius, mask_costs,
                    first_level=n_win)))
            corr = corr[0] if len(corr) == 1 else torch.cat(corr, dim=-1)

            h, d = self.update_block(h, x, _nchw(corr), _nchw(flow))

            coords1 = coords1 + _nhwc(d)
            flow = coords1 - coords0
            flows.append(flow)
            hiddens.append(h)

        # convex 8x upsampling, batched over all iterations at once
        out = upsample_iterations(self.update_block.mask, hiddens, flows,
                                  tuple(img1.shape[1:3]), upnet,
                                  last_only=return_state)
        if return_state:
            return out, rung_state(flows, start, h)
        return out


@register_model
class RaftFs(Model):
    """Config wrapper for ``raft/fs``."""

    type = "raft/fs"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            dropout=float(p.get("dropout", 0.0)),
            mixed_precision=bool(p.get("mixed-precision", False)),
            corr_levels=p.get("corr-levels", 4),
            corr_radius=p.get("corr-radius", 4),
            corr_channels=p.get("corr-channels", 256),
            context_channels=p.get("context-channels", 128),
            recurrent_channels=p.get("recurrent-channels", 128),
            encoder_norm=p.get("encoder-norm", "instance"),
            context_norm=p.get("context-norm", "batch"),
            arguments=cfg.get("arguments", {}),
            on_stage_args=cfg.get("on-stage", {"freeze_batchnorm": True}),
            on_epoch_args=cfg.get("on-epoch", {}),
        )

    def __init__(self, dropout=0.0, mixed_precision=False, corr_levels=4,
                 corr_radius=4, corr_channels=256, context_channels=128,
                 recurrent_channels=128, encoder_norm="instance",
                 context_norm="batch", arguments={}, on_epoch_args={},
                 on_stage_args={"freeze_batchnorm": True}):
        self.dropout = dropout
        self.mixed_precision = mixed_precision
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.corr_channels = corr_channels
        self.context_channels = context_channels
        self.recurrent_channels = recurrent_channels
        self.encoder_norm = encoder_norm
        self.context_norm = context_norm

        super().__init__(
            RaftFsModule(
                dropout=dropout, mixed_precision=mixed_precision,
                corr_levels=corr_levels, corr_radius=corr_radius,
                corr_channels=corr_channels,
                context_channels=context_channels,
                recurrent_channels=recurrent_channels,
                encoder_norm=encoder_norm, context_norm=context_norm,
            ),
            arguments=arguments,
            on_epoch_arguments=on_epoch_args,
            on_stage_arguments=on_stage_args,
        )

    def get_config(self):
        default_args = {"iterations": 12, "upnet": True, "mask_costs": []}
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
            },
            "arguments": default_args | self.arguments,
            "on-stage": {"freeze_batchnorm": True} | self.on_stage_arguments,
            "on-epoch": dict(self.on_epoch_arguments),
        }

    def get_adapter(self) -> ModelAdapter:
        return RaftAdapter(self)
