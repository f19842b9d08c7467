"""``raft+dicl/sl-ca``, PyTorch port: the single-level hybrid with the
cross-attention pair embeddings.

Counterpart of ``raft_meets_dicl_tpu/models/impls/outdated/
raft_dicl_sl_ca.py``: a config wrapper around ``RaftPlusDiclModule`` with
the ``dicl-emb`` correlation module (``corr_args`` ``{"embedding_dim":
embedding-channels}``). Its weights follow ``convert.sl_rules``; its
window sampler kernel launches once an iteration forward, once more for
the checkpointed cost module's recompute in a train step, and once
backward.
"""

from ...config import register_model
from ...model import Model, ModelAdapter
from ..raft import RaftAdapter
from ..raft_dicl_sl import RaftPlusDiclModule


@register_model
class RaftPlusDiclSlCa(Model):
    """``raft+dicl/sl-ca``."""

    type = "raft+dicl/sl-ca"

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
            embedding_channels=p.get("embedding-channels", 32),
            dap_init=p.get("dap-init", "identity"),
            encoder_norm=p.get("encoder-norm", "instance"),
            context_norm=p.get("context-norm", "batch"),
            mnet_norm=p.get("mnet-norm", "batch"),
            arguments=cfg.get("arguments", {}),
            on_stage_args=cfg.get("on-stage", {"freeze_batchnorm": True}),
            on_epoch_args=cfg.get("on-epoch", {}),
        )

    def __init__(self, dropout=0.0, mixed_precision=False, corr_radius=4,
                 corr_channels=32, context_channels=128,
                 recurrent_channels=128, embedding_channels=32,
                 dap_init="identity", encoder_norm="instance",
                 context_norm="batch", mnet_norm="batch", arguments={},
                 on_epoch_args={}, on_stage_args={"freeze_batchnorm": True}):
        self.dropout = dropout
        self.mixed_precision = mixed_precision
        self.corr_radius = corr_radius
        self.corr_channels = corr_channels
        self.context_channels = context_channels
        self.recurrent_channels = recurrent_channels
        self.embedding_channels = embedding_channels
        self.dap_init = dap_init
        self.encoder_norm = encoder_norm
        self.context_norm = context_norm
        self.mnet_norm = mnet_norm

        super().__init__(
            RaftPlusDiclModule(
                dropout=dropout, mixed_precision=mixed_precision,
                corr_radius=corr_radius, corr_channels=corr_channels,
                context_channels=context_channels,
                recurrent_channels=recurrent_channels, dap_init=dap_init,
                encoder_norm=encoder_norm, context_norm=context_norm,
                mnet_norm=mnet_norm, corr_type="dicl-emb",
                corr_args={"embedding_dim": embedding_channels},
            ),
            arguments=arguments,
            on_epoch_arguments=on_epoch_args,
            on_stage_arguments=on_stage_args,
        )

    def get_config(self):
        default_args = {"iterations": 12, "dap": True, "upnet": True}
        return {
            "type": self.type,
            "parameters": {
                "dropout": self.dropout,
                "mixed-precision": self.mixed_precision,
                "corr-radius": self.corr_radius,
                "corr-channels": self.corr_channels,
                "context-channels": self.context_channels,
                "recurrent-channels": self.recurrent_channels,
                "embedding-channels": self.embedding_channels,
                "dap-init": self.dap_init,
                "encoder-norm": self.encoder_norm,
                "context-norm": self.context_norm,
                "mnet-norm": self.mnet_norm,
            },
            "arguments": default_args | self.arguments,
            "on-stage": {"freeze_batchnorm": True} | self.on_stage_arguments,
            "on-epoch": dict(self.on_epoch_arguments),
        }

    def get_adapter(self) -> ModelAdapter:
        return RaftAdapter(self)
