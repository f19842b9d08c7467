"""Encoder factories: family x output shape.

Counterpart of the JAX ``encoders/__init__.py``. Only the ``raft`` family
at shape ``s3`` is ported; the other families and the pyramid shapes come
with the ``raft+dicl`` slice (ROADMAP queue A). Unknown names raise.
"""

from . import raft

_S3_FAMILIES = {
    "raft": lambda output_dim, norm_type, dropout, **kw:
        raft.FeatureEncoderS3(output_dim=output_dim, norm_type=norm_type,
                              dropout=dropout, **kw),
}

_KNOWN_FAMILIES = ("raft", "raft-avgpool", "raft-maxpool", "dicl", "rfpm-raft")


def _resolve(families, encoder_type):
    if encoder_type in families:
        return families[encoder_type]
    if encoder_type in _KNOWN_FAMILIES:
        raise NotImplementedError(
            f"encoder family '{encoder_type}' is not ported yet "
            "(ROADMAP queue A, raft+dicl slice)")
    raise ValueError(f"unsupported feature encoder type: '{encoder_type}'")


def make_encoder_s3(encoder_type, output_dim, norm_type, dropout, **kwargs):
    build = _resolve(_S3_FAMILIES, encoder_type)
    return build(output_dim, norm_type, dropout, **kwargs)
