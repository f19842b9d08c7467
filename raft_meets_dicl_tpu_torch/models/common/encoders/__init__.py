"""Encoder factories: family x output shape.

Counterpart of the JAX ``encoders/__init__.py``. Only the ``raft`` family
is ported, at shape ``s3`` and the pyramids ``p34``/``p35``/``p36``; the
``dicl``, ``raft-avgpool``/``raft-maxpool`` and ``rfpm-raft`` families
refuse, naming their ROADMAP item. Unknown names raise ``ValueError``.
"""

from . import raft

_S3_FAMILIES = {
    "raft": lambda output_dim, norm_type, dropout, **kw:
        raft.FeatureEncoderS3(output_dim=output_dim, norm_type=norm_type,
                              dropout=dropout, **kw),
}
_PYRAMID_FAMILIES = {
    "raft": lambda levels, output_dim, norm_type, dropout, **kw:
        raft.FeatureEncoderPyramid(output_dim=output_dim, levels=levels,
                                   norm_type=norm_type, dropout=dropout, **kw),
}

_KNOWN_FAMILIES = ("raft", "raft-avgpool", "raft-maxpool", "dicl", "rfpm-raft")


def _resolve(families, encoder_type):
    if encoder_type in families:
        return families[encoder_type]
    if encoder_type in _KNOWN_FAMILIES:
        raise NotImplementedError(
            f"encoder family '{encoder_type}' is not ported yet (ROADMAP "
            "slice 4, item 4)")
    raise ValueError(f"unsupported feature encoder type: '{encoder_type}'")


def make_encoder_s3(encoder_type, output_dim, norm_type, dropout, **kwargs):
    build = _resolve(_S3_FAMILIES, encoder_type)
    return build(output_dim, norm_type, dropout, **kwargs)


def _make_pyramid(encoder_type, levels, output_dim, norm_type, dropout,
                  **kwargs):
    build = _resolve(_PYRAMID_FAMILIES, encoder_type)
    return build(levels, output_dim, norm_type, dropout, **kwargs)


def make_encoder_p34(encoder_type, output_dim, norm_type, dropout, **kwargs):
    return _make_pyramid(encoder_type, 2, output_dim, norm_type, dropout,
                         **kwargs)


def make_encoder_p35(encoder_type, output_dim, norm_type, dropout, **kwargs):
    return _make_pyramid(encoder_type, 3, output_dim, norm_type, dropout,
                         **kwargs)


def make_encoder_p36(encoder_type, output_dim, norm_type, dropout, **kwargs):
    return _make_pyramid(encoder_type, 4, output_dim, norm_type, dropout,
                         **kwargs)
