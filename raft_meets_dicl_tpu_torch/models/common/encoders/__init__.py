"""Encoder factories: family x output shape (counterpart of the JAX
``encoders/__init__.py``): families ``raft``, ``dicl``, ``raft-avgpool``,
``raft-maxpool`` and ``rfpm-raft`` over the shapes ``s3`` (single-scale
1/8) and ``p34``/``p35``/``p36`` (pyramids 1/8..1/16, 1/8..1/32,
1/8..1/64); the pooled families are pyramids only. Unknown names raise
``ValueError``.
"""

from . import dicl, pool, raft, rfpm

_S3_FAMILIES = {
    "raft": lambda output_dim, norm_type, dropout, **kw:
        raft.FeatureEncoderS3(output_dim=output_dim, norm_type=norm_type,
                              dropout=dropout, **kw),
    "dicl": lambda output_dim, norm_type, dropout, **kw:
        dicl.s3(output_dim=output_dim, norm_type=norm_type,
                **_reject_dropout(dropout, kw)),
    "rfpm-raft": lambda output_dim, norm_type, dropout, **kw:
        rfpm.FeatureEncoderRfpm(output_dim=output_dim, levels=1,
                                norm_type=norm_type, dropout=dropout, **kw),
}
_PYRAMID_FAMILIES = {
    "raft": lambda levels, output_dim, norm_type, dropout, **kw:
        raft.FeatureEncoderPyramid(output_dim=output_dim, levels=levels,
                                   norm_type=norm_type, dropout=dropout, **kw),
    "dicl": lambda levels, output_dim, norm_type, dropout, **kw:
        dicl.pyramid(levels, output_dim=output_dim, norm_type=norm_type,
                     **_reject_dropout(dropout, kw)),
    "raft-avgpool": lambda levels, output_dim, norm_type, dropout, **kw:
        pool.FeatureEncoderPool(output_dim=output_dim, levels=levels,
                                norm_type=norm_type, dropout=dropout,
                                pool_type="avg", **kw),
    "raft-maxpool": lambda levels, output_dim, norm_type, dropout, **kw:
        pool.FeatureEncoderPool(output_dim=output_dim, levels=levels,
                                norm_type=norm_type, dropout=dropout,
                                pool_type="max", **kw),
    "rfpm-raft": lambda levels, output_dim, norm_type, dropout, **kw:
        rfpm.FeatureEncoderRfpm(output_dim=output_dim, levels=levels,
                                norm_type=norm_type, dropout=dropout, **kw),
}


def _reject_dropout(dropout, kwargs):
    """GA-Net encoders have no dropout: silently ignoring a configured rate
    would fake regularization."""
    if dropout:
        raise ValueError("the 'dicl' encoder family does not support dropout")
    return kwargs


def _resolve(families, encoder_type):
    if encoder_type in families:
        return families[encoder_type]
    if encoder_type in _PYRAMID_FAMILIES:
        raise ValueError(f"encoder family '{encoder_type}' has pyramid "
                         "shapes only")
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
