"""RAFT+DICL coarse-to-fine hybrids (``raft+dicl/ctf-l2``, ``-l3``, ``-l4``),
PyTorch port: forward and training.

Counterpart of ``raft_meets_dicl_tpu/models/impls/raft_dicl_ctf.py``. The
public layout is the JAX one: images (B, H, W, 3), flows (B, H, W, 2),
channel 0 = x. Per pyramid level, coarse to fine (level ids ``levels + 2``
down to 3; level L is 1/2^L): a DICL correlation module (window sampler
kernel, MatchingNet, DAP) and a RAFT update block, level-shared or per
level (``share_dicl`` / ``share_rnn``); the flow goes up a level by
bilinear 2x, the hidden state through a hidden-state upsampler; convex 8x
upsampling on the finest level, once per forward over its iterations.

Parameter names follow the reference torch modules (``fnet.out3.conv1``,
``corr_3.mnet.0.0``, ``corr_3.dap.conv1``, ``update_block.encoder.convc1``,
``upnet.conv1``, ``upnet_h.conv1``, ``flow_reg_3.dap.conv1``), the targets
of the ``raft+dicl`` rules in ``scripts/chkpt_convert.py``, so ``convert``
maps both ways.

The iterations are a Python loop (the JAX module's unrolled form): batch
norm in train mode updates its statistics iteration by iteration, level by
level, as the JAX ``unrolled`` path does. Every iteration starts from the
carried flow with its gradient stopped; ``corr_grad_stop`` also stops the
gradient into the cost. The ladder carry is the JAX module's: with
``hidden_init`` only the finest (1/8) level runs, re-entered from the
carried ``(flow_init, hidden_init)``; ``return_state`` returns the finest
level's carry (``models/common/carry.py``) and upsamples only its last
iteration.

Mixed precision (``mixed-precision: true``) follows the JAX policy: the
encoders, the matching nets and the update blocks compute in bf16 (the
window is cast to bf16 before the MatchingNet); costs, coords, flows, the
hidden-state upsamplers and the Up8 combine stay float32. Only the raft
encoders and the dicl module take it; other types refuse.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.upsample import convex_upsample_8x, upsample_flow_2x
from ..common import corr as corr_mod
from ..common import encoders, hsup
from ..common.adapters.mlseq import MultiLevelSequenceAdapter
from ..common.carry import (initial_flow, initial_hidden, rung_state,
                            upsample_iterations)
from ..common.grid import coordinate_grid
from ..common.loss.mlseq import upsample_flow_to
from ..common.util import Conv2d, init_parameters
from ..config import register_loss, register_model
from ..model import Loss, Model, ModelAdapter
from .raft import UpdateBlock

_PYRAMIDS = {
    2: encoders.make_encoder_p34,
    3: encoders.make_encoder_p35,
    4: encoders.make_encoder_p36,
}

_DEFAULT_ITERATIONS = {2: (4, 3), 3: (4, 3, 3), 4: (3, 4, 4, 3)}


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Up8Network(nn.Module):
    """Convex 8x upsampling: mask head (``conv1``, relu, ``conv2``) + the
    convex-combine kernel. The convs run channels_last, so the logits reach
    the kernel without a permute copy."""

    def __init__(self, hidden_dim=128, temperature=4.0, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(hidden_dim, 256, 3, dtype=dtype)
        self.conv2 = Conv2d(256, 8 * 8 * 9, 1, dtype=dtype)
        self.temperature = temperature

    def forward(self, hidden, flow):
        """hidden (N, C, h, w); flow (N, h, w, 2) float32 -> (N, 8h, 8w, 2)."""
        x = hidden.contiguous(memory_format=torch.channels_last)
        x = self.conv2(F.relu(self.conv1(x)))
        return convex_upsample_8x(flow, _nhwc(x), temperature=self.temperature)


class RaftPlusDiclCtfModule(nn.Module):
    """Coarse-to-fine RAFT+DICL network over ``levels`` pyramid levels
    (finest always 1/8; coarsest 1/(8·2^(levels-1)))."""

    def __init__(self, levels=3, corr_radius=4, corr_channels=32,
                 context_channels=128, recurrent_channels=128,
                 dap_init="identity", encoder_norm="instance",
                 context_norm="batch", mnet_norm="batch", encoder_type="raft",
                 context_type="raft", corr_type="dicl", corr_args=None,
                 corr_reg_type="softargmax", corr_reg_args=None,
                 share_dicl=False, share_rnn=True, upsample_hidden="none",
                 mixed_precision=False):
        super().__init__()
        self.levels = levels
        self.corr_type = corr_type
        self.corr_radius = corr_radius
        self.hidden_dim = recurrent_channels
        self.share_dicl = share_dicl
        self.share_rnn = share_rnn
        self.upsample_hidden = upsample_hidden
        # level ids coarse -> fine, e.g. (5, 4, 3) for 3 levels
        self.level_ids = tuple(range(levels + 2, 2, -1))

        dt = torch.bfloat16 if mixed_precision else None
        if dt is not None and (encoder_type != "raft" or context_type != "raft"
                               or corr_type != "dicl"):
            # silently running parts in f32 would fake the policy
            raise ValueError(
                "mixed-precision is only plumbed through the raft encoders "
                "and the dicl correlation module; got encoder-type="
                f"'{encoder_type}', context-type='{context_type}', "
                f"corr-type='{corr_type}'")
        self.compute_dtype = dt

        # the dtype goes only where the policy asks for one, as in JAX
        dt_kw = {"dtype": dt} if dt is not None else {}
        self.fnet = _PYRAMIDS[levels](encoder_type, output_dim=corr_channels,
                                      norm_type=encoder_norm, dropout=0,
                                      **dt_kw)
        self.cnet = _PYRAMIDS[levels](
            context_type, output_dim=recurrent_channels + context_channels,
            norm_type=context_norm, dropout=0, **dt_kw)

        def cmod():
            return corr_mod.make_cmod(
                corr_type, corr_channels, radius=corr_radius,
                dap_init=dap_init, norm_type=mnet_norm, **dt_kw,
                **(corr_args or {}))

        def reg():
            return corr_mod.make_flow_regression(
                corr_type, corr_reg_type, corr_radius, **(corr_reg_args or {}))

        if share_dicl:
            self.corr = cmod()
            self.flow_reg = reg()
        else:
            for lvl in self.level_ids:
                setattr(self, f"corr_{lvl}", cmod())
                setattr(self, f"flow_reg_{lvl}", reg())

        corr_planes = self._level("corr", self.level_ids[0],
                                  share_dicl).output_dim

        def update():
            return UpdateBlock(corr_planes, recurrent_channels,
                               context_channels, dtype=dt)

        def hup():
            return hsup.make_hidden_state_upsampler(upsample_hidden,
                                                    recurrent_channels)

        # the reference ctf-l2 names its single transition 'upnet_h'
        # whatever the sharing
        if share_rnn:
            self.update_block = update()
        else:
            for lvl in self.level_ids:
                setattr(self, f"update_block_{lvl}", update())
        if share_rnn or levels == 2:
            self.upnet_h = hup()
        else:
            for lvl in self.level_ids[1:]:
                setattr(self, f"upnet_h_{lvl}", hup())

        self.upnet = Up8Network(recurrent_channels, dtype=dt)

    def _level(self, name, lvl, shared):
        return getattr(self, name if shared else f"{name}_{lvl}")

    def reset_parameters(self, generator):
        init_parameters(self, generator)

    def forward(self, img1, img2, train=False, frozen_bn=False,
                iterations=None, dap=True, upnet=True, corr_flow=False,
                prev_flow=False, corr_grad_stop=False, flow_init=None,
                hidden_init=None, return_state=False):
        """img1, img2: (B, H, W, 3). Returns a list of per-level iteration
        lists, coarse to fine (finest level upsampled to (H, W), the others
        at their level's grid); with ``corr_flow`` each level's soft-argmax
        readouts come before its flows; with ``prev_flow`` entries become
        (flow the iteration started from, flow) pairs. ``iterations`` is
        per level, coarse to fine; an int sets the finest level's count.

        The ladder carry: with ``hidden_init`` (B, H/8, W/8, C) only the
        finest level runs, from ``flow_init`` (or zeros); ``return_state``
        returns ``(out, {"flow", "hidden", "delta"})`` of the finest level,
        its last iteration alone upsampled."""
        # ladder continuation: only the finest level runs, re-entered from
        # the previous rung's carry (coarse levels keep their defaults — a
        # continuation never re-runs them)
        cont = hidden_init is not None
        if flow_init is not None and not cont:
            raise ValueError(
                "ctf models take flow_init only together with hidden_init "
                "(a continuation rung at the finest level); the coarse "
                "pyramid has no seeding protocol")
        if iterations is None:
            iterations = _DEFAULT_ITERATIONS[self.levels]
        elif isinstance(iterations, int):
            iterations = (*_DEFAULT_ITERATIONS[self.levels][:-1], iterations)
        iterations = tuple(iterations)
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
            finest = li == self.levels - 1
            if cont and not finest:
                continue
            fine_idx = lvl - 3  # index into the finest-first feature tuples
            lh, lw = h // 2**lvl, w // 2**lvl

            cmod = self._level("corr", lvl, self.share_dicl)
            reg = self._level("flow_reg", lvl, self.share_dicl)
            update = self._level("update_block", lvl, self.share_rnn)

            coords0 = coordinate_grid(b, lh, lw, device=img1.device)
            if cont:
                flow = initial_flow(flow_init, b, lh, lw, img1.device)
                h_state = initial_hidden(hidden_init, hidden[fine_idx])
            elif flow is None:
                flow = torch.zeros((b, lh, lw, 2), dtype=torch.float32,
                                   device=img1.device)
                h_state = hidden[fine_idx]
            else:
                flow = upsample_flow_2x(flow)
                hup = self._level("upnet_h", lvl,
                                  self.share_rnn or self.levels == 2)
                h_state = hup(h_state, hidden[fine_idx])
            entry_flow = flow
            x = context[fine_idx]
            # NHWC-contiguous once per level: the sampler kernel reads f2 in
            # place, and f1's NCHW view is then channels_last
            fl1 = _nhwc(f1[fine_idx]).contiguous()
            fl2 = _nhwc(f2[fine_idx]).contiguous()

            flows, hiddens, readouts, prevs = [], [], [], []
            for _ in range(iterations[li]):
                prev = flow.detach()
                coords1 = coords0 + prev
                cost = cmod(fl1, fl2, coords1, dap=dap, train=train,
                            frozen_bn=frozen_bn)      # (B, h, w, K²) f32
                if corr_flow:
                    readouts.append(prev + reg(cost))
                if corr_grad_stop:
                    cost = cost.detach()

                h_state, d = update(h_state, x, _nchw(cost), _nchw(prev))
                flow = coords1 + _nhwc(d) - coords0
                flows.append(flow)
                hiddens.append(h_state)
                prevs.append(prev)

            if finest:
                # convex 8x upsampling, batched over the level's iterations
                out_lvl = upsample_iterations(self.upnet, hiddens, flows,
                                              (h, w), upnet,
                                              last_only=return_state)
            else:
                out_lvl = flows

            if prev_flow:
                out_lvl = list(zip(prevs[-len(out_lvl):], out_lvl))
            if corr_flow:
                out.append(list(zip(prevs, readouts)) if prev_flow
                           else readouts)
            out.append(out_lvl)

        if return_state:
            return out, rung_state(flows, entry_flow, h_state)
        return out


class _CtfModel(Model):
    """Shared config wrapper for the three registered level counts."""

    levels = None

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            mixed_precision=bool(p.get("mixed-precision", False)),
            corr_radius=p.get("corr-radius", 4),
            corr_channels=p.get("corr-channels", 32),
            context_channels=p.get("context-channels", 128),
            recurrent_channels=p.get("recurrent-channels", 128),
            dap_init=p.get("dap-init", "identity"),
            encoder_norm=p.get("encoder-norm", "instance"),
            context_norm=p.get("context-norm", "batch"),
            mnet_norm=p.get("mnet-norm", "batch"),
            encoder_type=p.get("encoder-type", "raft"),
            context_type=p.get("context-type", "raft"),
            share_dicl=p.get("share-dicl", False),
            share_rnn=p.get("share-rnn", True),
            corr_type=p.get("corr-type", "dicl"),
            corr_args=p.get("corr-args", {}),
            corr_reg_type=p.get("corr-reg-type", "softargmax"),
            corr_reg_args=p.get("corr-reg-args", {}),
            upsample_hidden=p.get("upsample-hidden", "none"),
            arguments=cfg.get("arguments", {}),
            on_stage_args=cfg.get("on-stage", {"freeze_batchnorm": True}),
            on_epoch_args=cfg.get("on-epoch", {}),
        )

    def __init__(self, corr_radius=4, corr_channels=32, context_channels=128,
                 recurrent_channels=128, dap_init="identity",
                 encoder_norm="instance", context_norm="batch",
                 mnet_norm="batch", encoder_type="raft", context_type="raft",
                 share_dicl=False, share_rnn=True, corr_type="dicl",
                 corr_args={}, corr_reg_type="softargmax", corr_reg_args={},
                 upsample_hidden="none", mixed_precision=False, arguments={},
                 on_epoch_args={}, on_stage_args={"freeze_batchnorm": True}):
        self.mixed_precision = mixed_precision
        self.corr_radius = corr_radius
        self.corr_channels = corr_channels
        self.context_channels = context_channels
        self.recurrent_channels = recurrent_channels
        self.dap_init = dap_init
        self.encoder_norm = encoder_norm
        self.context_norm = context_norm
        self.mnet_norm = mnet_norm
        self.encoder_type = encoder_type
        self.context_type = context_type
        self.share_dicl = share_dicl
        self.share_rnn = share_rnn
        self.corr_type = corr_type
        self.corr_args = dict(corr_args)
        self.corr_reg_type = corr_reg_type
        self.corr_reg_args = dict(corr_reg_args)
        self.upsample_hidden = upsample_hidden

        super().__init__(
            RaftPlusDiclCtfModule(
                levels=self.levels, corr_radius=corr_radius,
                corr_channels=corr_channels,
                context_channels=context_channels,
                recurrent_channels=recurrent_channels, dap_init=dap_init,
                encoder_norm=encoder_norm, context_norm=context_norm,
                mnet_norm=mnet_norm, encoder_type=encoder_type,
                context_type=context_type, corr_type=corr_type,
                corr_args=dict(corr_args), corr_reg_type=corr_reg_type,
                corr_reg_args=dict(corr_reg_args), share_dicl=share_dicl,
                share_rnn=share_rnn, upsample_hidden=upsample_hidden,
                mixed_precision=mixed_precision,
            ),
            arguments=arguments,
            on_epoch_arguments=on_epoch_args,
            on_stage_arguments=on_stage_args,
        )

    def get_config(self):
        default_args = {
            "iterations": _DEFAULT_ITERATIONS[self.levels],
            "dap": True,
            "upnet": True,
            "corr_flow": False,
            "prev_flow": False,
            "corr_grad_stop": False,
        }
        return {
            "type": self.type,
            "parameters": {
                "mixed-precision": self.mixed_precision,
                "corr-radius": self.corr_radius,
                "corr-channels": self.corr_channels,
                "context-channels": self.context_channels,
                "recurrent-channels": self.recurrent_channels,
                "dap-init": self.dap_init,
                "encoder-norm": self.encoder_norm,
                "context-norm": self.context_norm,
                "encoder-type": self.encoder_type,
                "context-type": self.context_type,
                "mnet-norm": self.mnet_norm,
                "share-dicl": self.share_dicl,
                "share-rnn": self.share_rnn,
                "corr-type": self.corr_type,
                "corr-args": self.corr_args,
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
class RaftPlusDiclCtfL2(_CtfModel):
    """``raft+dicl/ctf-l2``."""

    type = "raft+dicl/ctf-l2"
    levels = 2


@register_model
class RaftPlusDiclCtfL3(_CtfModel):
    """``raft+dicl/ctf-l3``, the thesis flagship."""

    type = "raft+dicl/ctf-l3"
    levels = 3


@register_model
class RaftPlusDiclCtfL4(_CtfModel):
    """``raft+dicl/ctf-l4``."""

    type = "raft+dicl/ctf-l4"
    levels = 4


@register_loss
class RestrictedMultiLevelSequenceLoss(Loss):
    """``raft+dicl/mlseq-restricted``: per-level loss masked by the
    displacement still representable at that level, relative to the flow
    the iteration started from. Consumes (prev, flow) pairs: the model must
    run with ``prev_flow=True``."""

    type = "raft+dicl/mlseq-restricted"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("arguments", {}))

    def __init__(self, arguments={}):
        super().__init__(arguments)

    def get_config(self):
        default_args = {
            "ord": 1,
            "gamma": 0.85,
            "alpha": (0.38, 0.6, 1.0),
            "scale": 1.0,
            "delta_range": (128, 64, 32),
            "delta_mode": "bilinear",
        }
        return {"type": self.type, "arguments": default_args | self.arguments}

    def compute(self, model, result, target, valid, ord=1, gamma=0.8,
                alpha=(0.4, 1.0), scale=1.0, delta_range=(128, 64, 32),
                delta_mode="bilinear"):
        if delta_mode != "bilinear":
            raise ValueError(f"unsupported delta_mode '{delta_mode}'")

        th, tw = target.shape[1:3]
        valid_f = valid.float()

        loss = 0.0
        for i_level, level in enumerate(result):
            n = len(level)
            for i_seq, (flow_prev, flow) in enumerate(level):
                weight = alpha[i_level] * gamma ** (n - i_seq - 1)

                flow = upsample_flow_to(flow, (th, tw))
                flow_prev = upsample_flow_to(flow_prev, (th, tw))

                # restrict to displacements the level can still correct
                delta = (target - flow_prev).abs()
                in_range = (delta[..., 0] <= delta_range[i_level]) \
                    & (delta[..., 1] <= delta_range[i_level])
                mask = valid_f * in_range.float()

                dist = torch.linalg.vector_norm(flow - target, ord=float(ord),
                                                dim=-1)
                # an empty mask contributes zero
                loss = loss + weight * (dist * mask).sum() \
                    / torch.clamp(mask.sum(), min=1.0)

        return loss * scale
