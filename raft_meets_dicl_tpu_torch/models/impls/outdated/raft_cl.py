"""``raft/cl``, RAFT with hierarchical cost learning (a kept experiment),
and its three losses, PyTorch port: forward and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/outdated/raft_cl.py``:
a GA-Net hourglass gives raw ladder features (``FeatureEncoderGa`` with
``heads=False``, 64/96/128/160 channels at 1/8..1/64); the frame-2 head
(``fnet_d``) makes a 1/8..1/64 pyramid of them, the frame-1 head
(``fnet_u``) lifts every level to 1/8 through chains of mask-weighted 2x
block upsampling; per GRU iteration a correlation module samples each
level's (2r+1)² window around the centres (the ``sample_window`` kernel
pair on the card, radius 4 only) and runs that level's MatchingNet and
DAP on the unstacked pair; the four costs feed a RAFT update block. The
public layout is the JAX one: images (B, H, W, 3), flows (B, H, W, 2),
channel 0 = x; the result is a dict (``flow``, ``f1``, ``f2``, and with
``corr_loss_examples`` ``corr_pos`` / ``corr_neg``).

Every iteration starts from the carried coordinates with their gradient
stopped. In a train step each iteration's correlation module is
checkpointed (``corr.common.checkpointed``): the twelve calls of the
shipped stage would keep about 74 GB of MatchingNet activations at batch
10 and 512x384 otherwise; the recompute leaves live batch-norm statistics
as the one forward left them and launches the sampler again. Convex 8x
upsampling runs once a forward over all iterations (the JAX module calls
it per iteration: the same per-sample map).

The auxiliary correlation losses read example costs the model computes
with ``corr_loss_examples``: each level's MatchingNet on self pairs and on
pairs with a spatially permuted copy. The JAX module draws the
permutations from ``fold_in(PRNGKey(0), i)``; this port draws them from a
seeded ``torch.Generator`` (:func:`example_permutation`): fixed in both,
equal in neither. ``flow_init`` seeds the coordinates as in the JAX
module; like the JAX module, the model takes neither ``hidden_init`` nor
``return_state`` (Python's ``TypeError`` for an unexpected keyword), so
raft/cl rides no ladder.

Names: ``fnet``, ``fnet_u`` (``out.{i}``, ``mask{5,4,3}``), ``fnet_d``
(``out.{i}``), ``cnet``, ``corr`` (``mnet.{i}``, ``dap.{i}``),
``update_block``, ``upnet`` (``convert.cl_rules``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ....ops.sample import sample_window_fused
from ...common.blocks.dicl import (
    ConvBlock,
    DisplacementAwareProjection,
    MatchingNet,
)
from ...common.carry import upsample_iterations
from ...common.corr.common import checkpointed
from ...common.encoders.dicl import _CHANNELS, FeatureEncoderGa
from ...common.encoders.raft import FeatureEncoderS3
from ...common.grid import coordinate_grid
from ...common.util import Conv2d, init_parameters
from ...config import register_loss, register_model
from ...model import Loss, Model, ModelAdapter, Result
from ..raft import UpdateBlock
from ..raft_dicl_ctf import Up8Network

_LEVELS = 4  # 1/8 .. 1/64
# the raw ladder's channels at 1/8 .. 1/64 (levels 2-5)
_LADDER_CHANNELS = _CHANNELS[2:2 + _LEVELS]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def example_permutation(i, n):
    """The permutation of the ``n`` pixels of example feature map ``i``
    (frame-1 levels first, then frame-2's) that makes the negative pairs
    of the correlation losses: drawn from a ``torch.Generator`` seeded
    with ``i``, the same every call."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(i))


def example_costs(mnets, levels, features, train, frozen_bn):
    """Self-pair and permuted-pair matching costs of the example feature
    maps ``features`` (each (B, h, w, C); map i runs through ``mnets[i %
    levels]``). Returns the lists (positives, negatives) of (B, h, w, 1, 1)
    costs."""
    pos, neg = [], []
    for i, feats in enumerate(features):
        b, h, w, c = feats.shape
        level = i % levels
        pair = torch.cat((feats, feats), dim=-1)
        pos.append(mnets[level](pair[:, None, None], train, frozen_bn))

        perm = example_permutation(i, h * w).to(feats.device)
        shuffled = feats.reshape(b, h * w, c)[:, perm].reshape(b, h, w, c)
        pair = torch.cat((feats, shuffled), dim=-1)
        neg.append(mnets[level](pair[:, None, None], train, frozen_bn))
    return pos, neg


class _FeatureNetDown(nn.Module):
    """Frame-2 head: one conv block per ladder level (``out.{i}``)."""

    def __init__(self, output_dim):
        super().__init__()
        self.out = nn.ModuleList(ConvBlock(c, output_dim)
                                 for c in _LADDER_CHANNELS)

    def forward(self, ladder, train=False, frozen_bn=False):
        return tuple(block(x, train, frozen_bn)
                     for block, x in zip(self.out, ladder))


def _block_upsample(mask, v):
    """The mask-weighted 2x block upsampling: each coarse pixel of ``v``
    (B, C, h/2, w/2) expands into its 2x2 sub-block of ``mask`` (B, 9, h,
    w), weighted over the 9 softmax channels (which sum to one) and
    summed, as the JAX module computes it. Returns (B, C, h, w)."""
    b, _, h, w = mask.shape
    c = v.shape[1]
    m = mask.reshape(b, 9, h // 2, 2, w // 2, 2)
    vv = v.reshape(b, 1, c, h // 2, 1, w // 2, 1)
    out = (m[:, :, None] * vv).sum(dim=1)         # (B, C, h/2, 2, w/2, 2)
    return out.reshape(b, c, h, w)


class _FeatureNetUp(nn.Module):
    """Frame-1 head: one conv block per ladder level (``out.{i}``), and
    the masks (``mask{5,4,3}``: 3x3 conv, relu, 1x1 conv to 9, softmax)
    that lift levels 4-6 to 1/8 through the block upsampling."""

    def __init__(self, output_dim):
        super().__init__()
        self.out = nn.ModuleList(ConvBlock(c, output_dim)
                                 for c in _LADDER_CHANNELS)
        # created in the JAX module's order: the masks of x5, x4, x3
        for lvl, c in ((5, 128), (4, 96), (3, 64)):
            setattr(self, f"mask{lvl}", nn.Sequential(
                Conv2d(c, c, 3), nn.ReLU(), Conv2d(c, 9, 1)))

    def forward(self, ladder, train=False, frozen_bn=False):
        x3, x4, x5, _ = ladder
        u = [block(x, train, frozen_bn) for block, x in zip(self.out, ladder)]
        m5, m4, m3 = (torch.softmax(getattr(self, f"mask{lvl}")(x), dim=1)
                      for lvl, x in ((5, x5), (4, x4), (3, x3)))

        u6 = _block_upsample(m3, _block_upsample(m4, _block_upsample(m5,
                                                                     u[3])))
        u5 = _block_upsample(m3, _block_upsample(m4, u[2]))
        u4 = _block_upsample(m3, u[1])
        return u[0], u4, u5, u6  # all at 1/8


class _ClCorrelationModule(nn.Module):
    """Per level, the MatchingNet cost (``mnet.{i}``) of the window of
    frame 2's level around the centres scaled to it, and its DAP
    (``dap.{i}``); the four costs concatenated, (B, H, W, 4·(2r+1)²)."""

    def __init__(self, feature_dim, radius, dap_init="identity"):
        super().__init__()
        self.radius = radius
        self.mnet = nn.ModuleList(MatchingNet(feature_dim)
                                  for _ in range(_LEVELS))
        self.dap = nn.ModuleList(DisplacementAwareProjection(radius,
                                                             init=dap_init)
                                 for _ in range(_LEVELS))

    @property
    def output_dim(self):
        return _LEVELS * (2 * self.radius + 1) ** 2

    def forward(self, fmap1, fmap2, coords, dap=True, train=False,
                frozen_bn=False):
        """fmap1: the four (B, H, W, C) 1/8 maps; fmap2: the pyramid, each
        NHWC-contiguous (the sampler kernel reads it in place); coords (B,
        H, W, 2) on the 1/8 grid, detached."""
        b, h, w, _ = coords.shape
        out = []
        for i, (f1, f2) in enumerate(zip(fmap1, fmap2)):
            window = sample_window_fused(f2, coords / 2**i, self.radius)
            cost = self.mnet[i]((f1, window), train, frozen_bn)
            if dap:
                cost = self.dap[i](cost)
            out.append(cost.reshape(b, h, w, -1))
        return torch.cat(out, dim=-1)


class RaftClModule(nn.Module):
    """The raft/cl network."""

    def __init__(self, dap_init="identity", corr_radius=3, feature_dim=32):
        super().__init__()
        hdim = cdim = 128
        self.hidden_dim = hdim
        self.fnet = FeatureEncoderGa(depth=6, out_levels=(2, 3, 4, 5),
                                     heads=False)
        self.fnet_u = _FeatureNetUp(feature_dim)
        self.fnet_d = _FeatureNetDown(feature_dim)
        self.cnet = FeatureEncoderS3(output_dim=hdim + cdim, norm_type="batch")
        self.corr = _ClCorrelationModule(feature_dim, corr_radius, dap_init)
        self.update_block = UpdateBlock(self.corr.output_dim, hdim, cdim)
        self.upnet = Up8Network(hdim)

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def forward(self, img1, img2, train=False, frozen_bn=False, iterations=12,
                upnet=True, flow_init=None, corr_loss_examples=False):
        """img1, img2: (B, H, W, 3), H and W divisible by 128 (the config
        pads to it). Returns the result dict; ``flow_init`` (B, H/8, W/8,
        2) offsets the starting coordinates."""
        hdim = self.hidden_dim
        x1, x2 = _nchw(img1), _nchw(img2)

        l1, l2 = self.fnet((x1, x2), train, frozen_bn)
        # NHWC-contiguous: the sampler kernel reads frame 2's levels in
        # place; frame 1's NCHW views are then channels_last
        fmap1 = [_nhwc(f).contiguous()
                 for f in self.fnet_u(l1, train, frozen_bn)]
        fmap2 = [_nhwc(f).contiguous()
                 for f in self.fnet_d(l2, train, frozen_bn)]

        ctx = self.cnet(x1, train, frozen_bn)
        h = torch.tanh(ctx[:, :hdim])
        x = F.relu(ctx[:, hdim:])

        b, hc, wc, _ = fmap1[0].shape
        coords0 = coordinate_grid(b, hc, wc, device=img1.device)
        coords1 = coords0 + flow_init if flow_init is not None else coords0

        def cost(coords, *maps):
            return self.corr(maps[:_LEVELS], maps[_LEVELS:], coords,
                             train=train, frozen_bn=frozen_bn)

        flows, hiddens = [], []
        for _ in range(iterations):
            coords1 = coords1.detach()
            flow = coords1 - coords0
            corr = checkpointed(self.corr, cost, coords1, *fmap1, *fmap2)
            h, d = self.update_block(h, x, _nchw(corr), _nchw(flow))
            coords1 = coords1 + _nhwc(d)
            flows.append(coords1 - coords0)
            hiddens.append(h)

        result = {
            "flow": upsample_iterations(self.upnet, hiddens, flows,
                                        tuple(img1.shape[1:3]), upnet),
            "f1": fmap1, "f2": fmap2,
        }
        if corr_loss_examples:
            result["corr_pos"], result["corr_neg"] = example_costs(
                self.corr.mnet, _LEVELS, fmap1 + fmap2, train, frozen_bn)
        return result


@register_model
class RaftCl(Model):
    """``raft/cl``."""

    type = "raft/cl"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            dap_init=p.get("dap-init", "identity"),
            corr_radius=p.get("corr-radius", 3),
            arguments=cfg.get("arguments", {}),
        )

    def __init__(self, dap_init="identity", corr_radius=3, arguments={}):
        self.dap_init = dap_init
        self.corr_radius = corr_radius

        super().__init__(
            RaftClModule(dap_init=dap_init, corr_radius=corr_radius),
            arguments=arguments,
        )

    def get_config(self):
        default_args = {"iterations": 12, "upnet": True}
        return {
            "type": self.type,
            "parameters": {
                "corr-radius": self.corr_radius,
                "dap-init": self.dap_init,
            },
            "arguments": default_args | self.arguments,
        }

    def get_adapter(self) -> ModelAdapter:
        return RaftClAdapter(self)


class RaftClAdapter(ModelAdapter):
    def wrap_result(self, result, original_shape) -> Result:
        return RaftClResult(result)


class RaftClResult(Result):
    """The result dict: the ``flow`` sequence, the feature lists and the
    example costs."""

    def __init__(self, output):
        super().__init__()
        self.result = output

    def output(self, batch_index=None):
        if batch_index is None:
            return self.result
        return {k: [x[batch_index:batch_index + 1] for x in v]
                for k, v in self.result.items()}

    def final(self):
        return self.result["flow"][-1]

    def intermediate_flow(self):
        return self.result["flow"]


def corr_hinge(result, margin):
    """The hinge correlation loss over the example costs."""
    loss = 0.0
    for pos in result["corr_pos"]:
        loss = loss + torch.clamp(margin - pos, min=0.0).mean()
    for neg in result["corr_neg"]:
        loss = loss + torch.clamp(margin + neg, min=0.0).mean()
    return loss


def corr_mse(result):
    """The squared-error correlation loss over the example costs: 1 for
    the self pairs, 0 for the permuted ones."""
    loss = 0.0
    for pos in result["corr_pos"]:
        loss = loss + torch.square(pos - 1.0).mean()
    for neg in result["corr_neg"]:
        loss = loss + torch.square(neg).mean()
    return loss


@register_loss
class ClSequenceLoss(Loss):
    """``raft/cl/sequence``."""

    type = "raft/cl/sequence"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("arguments", {}))

    def __init__(self, arguments={}):
        super().__init__(arguments)

    def get_config(self):
        default_args = {"ord": 1, "gamma": 0.8, "scale": 1.0}
        return {"type": self.type, "arguments": default_args | self.arguments}

    def _flow_loss(self, result, target, valid, ord, gamma):
        flows = result["flow"]
        n = len(flows)
        valid_f = valid.float()
        denom = torch.clamp(valid_f.sum(), min=1.0)

        loss = 0.0
        for i, flow in enumerate(flows):
            weight = gamma ** (n - i - 1)
            dist = torch.linalg.vector_norm(flow - target, ord=float(ord),
                                            dim=-1)
            loss = loss + weight * (dist * valid_f).sum() / denom
        return loss

    def compute(self, model, result, target, valid, ord=1, gamma=0.8,
                scale=1.0):
        return self._flow_loss(result, target, valid, ord, gamma) * scale


@register_loss
class ClSequenceCorrHingeLoss(ClSequenceLoss):
    """``raft/cl/sequence+corr_hinge``; needs the model argument
    ``corr_loss_examples=True``."""

    type = "raft/cl/sequence+corr_hinge"

    def get_config(self):
        default_args = {"ord": 1, "gamma": 0.8, "alpha": 1.0, "margin": 1.0}
        return {"type": self.type, "arguments": default_args | self.arguments}

    def compute(self, model, result, target, valid, ord=1, gamma=0.8,
                alpha=1.0, margin=1.0):
        return self._flow_loss(result, target, valid, ord, gamma) \
            + alpha * corr_hinge(result, margin)


@register_loss
class ClSequenceCorrMseLoss(ClSequenceLoss):
    """``raft/cl/sequence+corr_mse``; needs the model argument
    ``corr_loss_examples=True``."""

    type = "raft/cl/sequence+corr_mse"

    def get_config(self):
        default_args = {"ord": 1, "gamma": 0.8, "alpha": 1.0}
        return {"type": self.type, "arguments": default_args | self.arguments}

    def compute(self, model, result, target, valid, ord=1, gamma=0.8,
                alpha=1.0):
        return self._flow_loss(result, target, valid, ord, gamma) \
            + alpha * corr_mse(result)
