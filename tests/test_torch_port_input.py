"""PyTorch port: the host-side input contract (``models/input.py``) and the
serving batcher (``serve/batcher.py``) held against their JAX-package
originals on the same numpy inputs.

Both are numpy code in both packages, so results must be identical: no
tolerance.
"""

import numpy as np
import pytest

from raft_meets_dicl_tpu.data.collection import Metadata, SampleArgs, SampleId
from raft_meets_dicl_tpu.models import input as jinput
from raft_meets_dicl_tpu.serve import batcher as jbatcher
from raft_meets_dicl_tpu_torch.models import input as tinput
from raft_meets_dicl_tpu_torch.serve import batcher as tbatcher

pytestmark = pytest.mark.torch_port


def _sample(seed, h, w):
    rs = np.random.RandomState(seed)
    img1 = rs.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    img2 = rs.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    flow = rs.randn(2, h, w, 2).astype(np.float32)
    valid = rs.rand(2, h, w) > 0.2
    meta = [Metadata(True, "d", SampleId("{}", SampleArgs([i]), SampleArgs([i + 1])),
                     ((0, h), (0, w))) for i in range(2)]
    return img1, img2, flow, valid, meta


def _assert_same(actual, expected):
    *arrays_a, meta_a = actual
    *arrays_e, meta_e = expected
    for a, e in zip(arrays_a, arrays_e):
        np.testing.assert_array_equal(a, e)
    assert [m.original_extents for m in meta_a] == \
        [m.original_extents for m in meta_e]


@pytest.mark.parametrize("mode", ["zeros", "torch.replicate", "reflect"])
@pytest.mark.parametrize("align", [("left", "top"), ("center", "center"),
                                   ("right", "bottom")])
@pytest.mark.parametrize("raw", [False, True])
def test_modulo_padding_matches_jax(mode, align, raw):
    # size is (w multiple, h multiple) in config order
    cfg = {"type": "modulo", "mode": mode, "size": [8, 4],
           "align-horizontal": align[0], "align-vertical": align[1]}
    jpad = jinput.ModuloPadding.from_config(cfg)
    tpad = tinput.ModuloPadding.from_config(cfg)
    assert tpad.get_config() == jpad.get_config()
    if raw:
        jpad = jpad.raw_variant((0.0, 1.0), (-1.0, 1.0))
        tpad = tpad.raw_variant((0.0, 1.0), (-1.0, 1.0))

    sample = _sample(0, 13, 21)
    out = tpad(*sample)
    assert out[0].shape == (2, 16, 24, 3)
    _assert_same(out, jpad(*sample))


def test_shape_buckets_match_jax():
    spec = "64x96, 32x48,64x96,40x128"
    jb, tb = jinput.ShapeBuckets.parse(spec), tinput.ShapeBuckets.parse(spec)
    assert tb.sizes == jb.sizes == [(32, 48), (40, 128), (64, 96)]
    assert tb.describe() == jb.describe()
    assert tb.get_config() == jb.get_config()
    for hw in [(1, 1), (32, 48), (33, 48), (40, 100), (64, 96), (65, 96)]:
        assert tb.assign(*hw) == jb.assign(*hw), hw
    assert tinput.ShapeBuckets.parse("group").sizes == []
    with pytest.raises(ValueError, match="HxW"):
        tinput.ShapeBuckets.parse("64by96")

    jraw = jb.raw_variant((0.0, 1.0), (-1.0, 1.0))
    traw = tb.raw_variant((0.0, 1.0), (-1.0, 1.0))
    img = np.random.RandomState(1).uniform(0, 1, (30, 45, 3)).astype(np.float32)
    for bucket in [(32, 48), (64, 96)]:
        np.testing.assert_array_equal(traw.pad_image(img, bucket),
                                      jraw.pad_image(img, bucket))

    sample = _sample(2, 36, 90)
    _assert_same(tb.pad(*sample), jb.pad(*sample))


def test_shape_buckets_check_the_model_modulo():
    pad = tinput.ModuloPadding("zeros", [8, 8])
    tinput.ShapeBuckets.parse("64x96").check_compatible(pad)
    with pytest.raises(ValueError, match="60x96"):
        tinput.ShapeBuckets.parse("60x96").check_compatible(pad)


def test_input_spec_config_matches_jax():
    cfg = {"clip": [0, 1], "range": [-1, 1],
           "padding": {"type": "modulo", "mode": "zeros", "size": [8, 8]}}
    for c in (cfg, None):
        assert tinput.InputSpec.from_config(c).get_config() == \
            jinput.InputSpec.from_config(c).get_config()


def _requests(module, seq):
    return [module.FlowRequest(rid=i, client="c", seq=i, bucket=bucket,
                               shape=bucket, img1=np.full((2, 2, 3), i, np.float32),
                               img2=np.full((2, 2, 3), -i, np.float32),
                               ticket=None, t_submit=0.0)
            for i, bucket in enumerate(seq)]


def test_batcher_coalesces_like_jax():
    """The same submission sequence coalesces into the same batches, in
    the same order, with the same backpressure and fill."""
    buckets = "32x48,64x96"
    seq = [(32, 48), (64, 96), (32, 48), (32, 48), (64, 96), (32, 48),
           (32, 48), (64, 96)]
    batches = {}
    for name, inp, mod in (("jax", jinput, jbatcher), ("port", tinput, tbatcher)):
        b = mod.BucketBatcher(inp.ShapeBuckets.parse(buckets), batch_size=3,
                              queue_limit=4)
        accepted = [b.offer(r) for r in _requests(mod, seq)]
        out = []
        while True:
            bucket, batch = b.take(now=0.0, max_wait_s=1e9, drain=True)
            if bucket is None:
                break
            img1, img2, fill = b.assemble(batch)
            out.append((bucket, [r.rid for r in batch], fill,
                        img1[:, 0, 0, 0].tolist(), img2[:, 0, 0, 0].tolist()))
        batches[name] = (accepted, out)

    assert batches["port"] == batches["jax"]
    accepted, out = batches["port"]
    assert accepted.count(False) == 1  # the fifth (32, 48) request
    assert out[0] == ((32, 48), [0, 2, 3], 0, [0, 2, 3], [0, -2, -3])
