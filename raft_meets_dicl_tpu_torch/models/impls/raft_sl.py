"""RAFT single-level (``raft/sl``), PyTorch port: the baseline with a
1-level correlation pyramid.

Counterpart of ``raft_meets_dicl_tpu/models/impls/raft_sl.py``: a config
wrapper around ``RaftModule`` with ``corr_levels=1``, so the windowed
lookup reads the full-resolution volume only. Everything else, the bf16
policy of ``mixed-precision: true`` and the convex 8x upsampling kernel
(once a forward, over all iterations) included, is ``raft/baseline``'s;
so are the weight rules (``convert.raft_rules(1)``) and the activation
capture points.
"""

from ..config import register_model
from ..model import Model, ModelAdapter
from .raft import RaftAdapter, RaftModule


@register_model
class RaftSl(Model):
    """``raft/sl``."""

    type = "raft/sl"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        p = cfg["parameters"]
        return cls(
            dropout=float(p.get("dropout", 0.0)),
            mixed_precision=bool(p.get("mixed-precision", False)),
            corr_radius=p.get("corr-radius", 4),
            corr_channels=p.get("corr-channels", 256),
            context_channels=p.get("context-channels", 128),
            recurrent_channels=p.get("recurrent-channels", 128),
            encoder_norm=p.get("encoder-norm", "instance"),
            context_norm=p.get("context-norm", "batch"),
            corr_reg_type=p.get("corr-reg-type", "softargmax"),
            corr_reg_args=p.get("corr-reg-args", {}),
            arguments=cfg.get("arguments", {}),
            on_stage_args=cfg.get("on-stage", {"freeze_batchnorm": True}),
            on_epoch_args=cfg.get("on-epoch", {}),
        )

    def __init__(self, dropout=0.0, mixed_precision=False, corr_radius=4,
                 corr_channels=256, context_channels=128,
                 recurrent_channels=128, encoder_norm="instance",
                 context_norm="batch", corr_reg_type="softargmax",
                 corr_reg_args={}, arguments={}, on_epoch_args={},
                 on_stage_args={"freeze_batchnorm": True}):
        self.dropout = dropout
        self.mixed_precision = mixed_precision
        self.corr_radius = corr_radius
        self.corr_channels = corr_channels
        self.context_channels = context_channels
        self.recurrent_channels = recurrent_channels
        self.encoder_norm = encoder_norm
        self.context_norm = context_norm
        self.corr_reg_type = corr_reg_type
        self.corr_reg_args = dict(corr_reg_args)

        super().__init__(
            RaftModule(
                dropout=dropout, mixed_precision=mixed_precision,
                corr_levels=1, corr_radius=corr_radius,
                corr_channels=corr_channels,
                context_channels=context_channels,
                recurrent_channels=recurrent_channels,
                encoder_norm=encoder_norm, context_norm=context_norm,
                corr_reg_type=corr_reg_type,
                corr_reg_args=dict(corr_reg_args),
            ),
            arguments=arguments,
            on_epoch_arguments=on_epoch_args,
            on_stage_arguments=on_stage_args,
        )

    def get_config(self):
        default_args = {"iterations": 12, "upnet": True, "corr_flow": False}
        return {
            "type": self.type,
            "parameters": {
                "dropout": self.dropout,
                "mixed-precision": self.mixed_precision,
                "corr-radius": self.corr_radius,
                "corr-channels": self.corr_channels,
                "context-channels": self.context_channels,
                "recurrent-channels": self.recurrent_channels,
                "encoder-norm": self.encoder_norm,
                "context-norm": self.context_norm,
                "corr-reg-type": self.corr_reg_type,
                "corr-reg-args": self.corr_reg_args,
            },
            "arguments": default_args | self.arguments,
            "on-stage": {"freeze_batchnorm": True} | self.on_stage_arguments,
            "on-epoch": dict(self.on_epoch_arguments),
        }

    def get_adapter(self) -> ModelAdapter:
        return RaftAdapter(self)
