"""PyTorch port: the quantized matching tier (``ops.quant``, the
``QuantizedLevel`` branch of ``ops.corr._lookup_level`` and the ``quant``
/ ``quant_clip`` forward arguments of ``raft/baseline`` and ``raft/fs``),
held against the JAX package on the CPU from the same numpy inputs.

- ``normalize_mode`` spellings, and its refusals, as JAX's;
- ``quantize_level`` (u8, i8, with and without clip), ``dequantize_level``
  and ``quantize_pyramid`` bit for bit;
- ``correlation_pyramid_int8``: the int8 dot is exact (a float32 matmul of
  integer values), so level 0 is bit for bit; the pooled levels may differ
  by one step where the two frameworks' pooled maps round apart;
- the quantized ``_lookup_level`` against JAX's;
- the ``raft/baseline`` f32 forward with u8 and i8, and ``raft/fs`` with
  u8 and i8 at a split with volumes, weights bridged from the JAX init;
- ``quant=None`` (or ``'off'``) runs no quant op and gives the forward
  without the argument, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
from raft_meets_dicl_tpu.ops import corr as jcorr
from raft_meets_dicl_tpu.ops import quant as jquant
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert, evaluation
from raft_meets_dicl_tpu_torch.models.impls import raft as traft
from raft_meets_dicl_tpu_torch.models.impls import raft_fs as traft_fs
from raft_meets_dicl_tpu_torch.ops import corr as tcorr
from raft_meets_dicl_tpu_torch.ops import quant as tquant
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ITERATIONS = 3
# small widths: 4 levels of radius 4 as shipped, 64 correlation channels
NARROW = {"corr-levels": 4, "corr-radius": 4, "corr-channels": 64,
          "context-channels": 32, "recurrent-channels": 32}


def _bf16_ulp(x):
    """Spacing of bfloat16 values at |x|: 2^(e - 7) for |x| in
    [2^e, 2^(e+1)); 0 at 0."""
    _, exp = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, exp - 8))


# -- modes and levels ---------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None, False, True, "", "0", "off", "OFF", "none", "false", "u8",
    " UINT8 ", "i8", "int8", "S8"])
def test_normalize_mode_matches_jax(spec):
    assert tquant.normalize_mode(spec) == jquant.normalize_mode(spec)


@pytest.mark.parametrize("spec", ["u4", "fp8", 8])
def test_normalize_mode_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jquant.normalize_mode(spec)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tquant.normalize_mode(spec)


def _volume(seed, shape=(2, 4, 5, 6, 7)):
    """A seeded float32 volume whose two samples differ in range (per
    sample scales), with a few outliers for the clip to saturate."""
    rs = np.random.RandomState(seed)
    v = rs.randn(*shape).astype(np.float32)
    v[1] *= 3.0
    v[0, 0, 0, 0, :2] = (9.0, -7.5)
    v[0, 0, 1, 0, 0] = 6.25
    return v


@pytest.mark.parametrize("clip", [1.0, 0.5])
@pytest.mark.parametrize("mode", ["u8", "i8"])
def test_quantize_and_dequantize_level_bit_for_bit(mode, clip):
    v = _volume(1)
    expected = jquant.quantize_level(jnp.asarray(v), mode, clip=clip)
    actual = tquant.quantize_level(torch.from_numpy(v), mode, clip=clip)
    assert actual.values.dtype == (torch.uint8 if mode == "u8"
                                   else torch.int8)
    assert tuple(actual.scale.shape) == (2, 1, 1, 1, 1)
    np.testing.assert_array_equal(actual.values.numpy(),
                                  np.asarray(expected.values))
    np.testing.assert_array_equal(actual.scale.numpy(),
                                  np.asarray(expected.scale))
    assert tquant.zero_point(actual.values) == jquant.zero_point(
        expected.values)
    if clip < 1.0:     # the outliers saturate
        lo, hi = (0, 255) if mode == "u8" else (-127, 127)
        assert actual.values.numpy().max() == hi
        assert actual.values.numpy().min() == lo

    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        deq = tquant.dequantize_level(actual, tdt)
        assert deq.dtype == tdt
        np.testing.assert_array_equal(
            deq.float().numpy(),
            np.asarray(jquant.dequantize_level(expected, jdt)
                       .astype(jnp.float32)))


def test_quantize_level_takes_bf16_volumes_and_refuses_no_mode():
    v = torch.from_numpy(_volume(2)).to(torch.bfloat16)
    expected = jquant.quantize_level(jnp.asarray(v.float().numpy(),
                                                 jnp.bfloat16), "u8")
    actual = tquant.quantize_level(v, "u8")
    np.testing.assert_array_equal(actual.values.numpy(),
                                  np.asarray(expected.values))
    for off in (None, "off"):
        with pytest.raises(ValueError, match="explicit mode"):
            tquant.quantize_level(v, off)


@pytest.mark.parametrize("mode", ["u8", "i8"])
def test_quantize_pyramid_bit_for_bit(mode):
    levels = [_volume(3, (2, 4, 6, 4 // 2**i + 1, 6 // 2**i + 1))
              for i in range(3)]
    expected = jquant.quantize_pyramid([jnp.asarray(v) for v in levels],
                                       mode, clip=0.9)
    actual = tquant.quantize_pyramid([torch.from_numpy(v) for v in levels],
                                     mode, clip=0.9)
    assert len(actual) == 3
    for a, e in zip(actual, expected):
        assert isinstance(a, tquant.QuantizedLevel)
        np.testing.assert_array_equal(a.values.numpy(), np.asarray(e.values))
        np.testing.assert_array_equal(a.scale.numpy(), np.asarray(e.scale))


# -- the int8 correlation pyramid ---------------------------------------------


# the pooled maps of the two frameworks may round apart (XLA and torch sum
# the 2x2 means in other orders), which can move a pooled level's scale by
# an ulp or two and flip a value by one step; these inputs read no flip
# (share 0) and scales within 2e-7 relative
INT8_MAX_STEP = 1
INT8_MAX_SHARE = 1e-3
INT8_SCALE_REL = 1e-6


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("clip", [1.0, 0.8])
def test_correlation_pyramid_int8_matches_jax(clip, normalize):
    rs = np.random.RandomState(4)
    f1 = rs.randn(2, 8, 12, 32).astype(np.float32)
    f2 = (rs.randn(2, 8, 12, 32) * 2.0).astype(np.float32)
    f2[:, :, :, 5] *= 20.0      # one hot channel: the equalizer's case
    expected = jquant.correlation_pyramid_int8(
        jnp.asarray(f1), jnp.asarray(f2), 4, normalize=normalize, clip=clip)
    actual = tquant.correlation_pyramid_int8(
        torch.from_numpy(f1), torch.from_numpy(f2), 4, normalize=normalize,
        clip=clip)
    assert len(actual) == 4
    for lvl, (a, e) in enumerate(zip(actual, expected)):
        assert a.values.dtype == torch.int8
        assert tuple(a.values.shape) == e.values.shape \
            == (2, 8, 12, 8 >> lvl, 12 >> lvl)
        step = np.abs(a.values.numpy().astype(int)
                      - np.asarray(e.values).astype(int))
        if lvl == 0:    # no pooling: the exact dot gives the same bits
            np.testing.assert_array_equal(step, 0)
            np.testing.assert_array_equal(a.scale.numpy(),
                                          np.asarray(e.scale))
        assert step.max() <= INT8_MAX_STEP
        assert (step > 0).mean() <= INT8_MAX_SHARE
        np.testing.assert_allclose(a.scale.numpy(), np.asarray(e.scale),
                                   rtol=INT8_SCALE_REL, atol=0)


def test_int8_dot_is_exact_integer_accumulation():
    """The float32 matmul of int8 values equals int64 accumulation at the
    largest magnitudes, C = 256 (|acc| = 256 · 127² < 2^24)."""
    rs = np.random.RandomState(5)
    q1 = rs.choice([-127, 127, -1, 3], size=(1, 3, 4, 256)).astype(np.int8)
    q2 = rs.choice([-127, 127, 126], size=(1, 2, 5, 256)).astype(np.int8)
    q1[0, 0, 0] = 127
    q2[0, 0, 0] = 127
    acc = tquant._int8_dot(torch.from_numpy(q1), torch.from_numpy(q2))
    exact = np.einsum("bijc,bklc->bijkl", q1.astype(np.int64),
                      q2.astype(np.int64))
    assert exact.max() == 256 * 127 * 127
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), exact)
    with pytest.raises(ValueError, match="exceeds"):
        tquant._int8_dot(torch.zeros(1, 1, 1, 1041, dtype=torch.int8),
                         torch.zeros(1, 1, 1, 1041, dtype=torch.int8))


# -- the quantized lookup -----------------------------------------------------


@pytest.mark.parametrize("mode", ["u8", "i8"])
def test_quantized_lookup_level_matches_jax(mode):
    """bf16 hat weights, a bf16 dequant, t rounded to bf16: the two
    frameworks can round t one bf16 ulp apart, so the bound is one ulp of
    t carried through the x weights, times the scale, plus float32
    summation order."""
    rs = np.random.RandomState(6)
    v = _volume(7, (2, 5, 6, 9, 11))
    coords = (rs.rand(2, 5, 6, 2) * [11, 9] + rs.randn(2, 5, 6, 2) * 2
              ).astype(np.float32)
    d = np.linspace(-4, 4, 9, dtype=np.float32)
    x = coords[..., 0:1] + d
    y = coords[..., 1:2] + d
    jlevel = jquant.quantize_level(jnp.asarray(v), mode)
    expected = np.asarray(jcorr._lookup_level(jlevel, jnp.asarray(x),
                                              jnp.asarray(y)))
    tlevel = tquant.quantize_level(torch.from_numpy(v), mode)
    actual = tcorr._lookup_level(tlevel, torch.from_numpy(x),
                                 torch.from_numpy(y))
    assert actual.dtype == torch.float32
    assert tuple(actual.shape) == expected.shape == (2, 5, 6, 9, 9)

    wy = np.maximum(0, 1 - np.abs(y[..., None] - np.arange(9)))
    wx = np.maximum(0, 1 - np.abs(x[..., None] - np.arange(11)))
    deq = (np.asarray(jlevel.values).astype(np.float32)
           - jquant.zero_point(jlevel.values))
    t = np.einsum("bijkh,bijhw->bijkw", wy, deq)
    scale = np.asarray(jlevel.scale)
    ulp = np.einsum("bijkw,bijaw->bijka", _bf16_ulp(t), wx) * scale
    s = np.einsum("bijkw,bijaw->bijka", np.abs(t), wx) * scale
    err = np.abs(actual.numpy() - expected)
    assert (err <= ulp + 2.0 ** -13 * s).all(), err.max()
    # in a masked level the branch gives zeros too
    masked = tcorr.lookup_pyramid_levels(
        [tlevel], torch.from_numpy(coords), 4, mask_costs=(3,))
    assert bool(torch.all(masked[0] == 0))


# -- the models ---------------------------------------------------------------


def _cfg(model_type, params, iterations=ITERATIONS):
    loss = "raft/sequence"
    return {
        "name": model_type, "id": model_type,
        "model": {"type": model_type,
                  "parameters": {**params, "mixed-precision": False},
                  "arguments": {"iterations": iterations}},
        "loss": {"type": loss},
        "input": None,
    }


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(0)
    return tuple(rs.uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
                 for _ in range(2))


def _models(model_type, images):
    """(JAX spec, its variables as numpy, the port's spec with them, a
    cache of the JAX forwards by argument)."""
    img1, img2 = (jnp.asarray(x) for x in images)
    jspec = jmodels.load(_cfg(model_type, NARROW))
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: jspec.model.init(k, img1, img2))(jax.random.PRNGKey(1)))
    tspec = tmodels.load(_cfg(model_type, NARROW))
    tspec.model.init(device="cpu")
    convert.load_jax_variables(tspec.model.module, variables)
    return jspec, variables, tspec, {}


@pytest.fixture(scope="module")
def raft_models(images):
    return _models("raft/baseline", images)


@pytest.fixture(scope="module")
def fs_models(images):
    return _models("raft/fs", images)


def _both(models, images, fresh=False, **args):
    """(JAX flows, the port's flows) of one forward with ``args``. The
    JAX forward (a compile each) is kept per ``args`` unless ``fresh``;
    the port's always runs."""
    jspec, variables, tspec, cache = models
    key = tuple(sorted(args.items()))
    if fresh or key not in cache:
        img1, img2 = (jnp.asarray(x) for x in images)
        cache[key] = jax.jit(
            lambda v: jspec.model.apply(v, img1, img2, **args))(
            jax.tree.map(jnp.asarray, variables))
    actual, _ = evaluation.make_eval_fn(tspec.model, args)(
        *(torch.from_numpy(x) for x in images))
    return cache[key], actual


def _max_abs(actual, expected):
    return float(np.abs(actual.numpy() - np.asarray(expected)).max())


# float32 forward, quantized. The two frameworks compute the volumes (and
# the features) as the same function summed in other orders, so a value at
# a rounding tie can quantize one step apart, and the recurrence carries
# the step on: the bound is relative to the largest |flow|. Readings (3
# iterations, flows of 13.5-16.5 px): u8 1.8e-5 px, u8 at clip 0.5 3.5e-4
# px, raft/fs u8 and i8 1.6e-4 px (its unquantized narrow forward reads
# 3.2e-4 px: the unnormalized correlation), all <= 2.6e-5 of the flow.
# The tier itself moves the flow 0.08-5.3 px (QUANT_MIN_EFFECT_PX), 50x
# the bound and more, so the bound tells a quantized run from a plain one
QUANT_REL = 1e-4
QUANT_MIN_EFFECT_PX = 0.05
# raft i8 builds int8 features: one of the 12,288 feature values the two
# encoders compute 2.3e-5 apart (on values up to 15.7) rounds to the
# neighbouring step, which moves every dot of its pixel, and the flows
# read 2.2e-2 px apart (1.4e-3 of the flow). Fed the same features (the
# JAX encoder's), the port's i8 forward reads 1.9e-5 px: the gap is the
# flip, so that run is held to QUANT_REL and its own-feature run to the
# flip count below and I8_OWN_FEATURES_REL
I8_OWN_FEATURES_REL = 5e-3
I8_MAX_FEATURE_FLIPS = 1e-3     # share of int8 feature values


def _bound(expected):
    return QUANT_REL * float(np.abs(np.asarray(expected[-1])).max())


@pytest.mark.parametrize("mode", ["u8", "i8"])
def test_raft_quantized_forward_matches_jax(mode, raft_models, images):
    expected, actual = _both(raft_models, images, quant=mode)
    assert len(actual) == len(expected) == ITERATIONS
    rel = QUANT_REL if mode == "u8" else I8_OWN_FEATURES_REL
    for a, e in zip(actual, expected):
        assert tuple(a.shape) == e.shape == (1, 64, 96, 2)
        assert _max_abs(a, e) <= rel / QUANT_REL * _bound(expected)
    plain, _ = _both(raft_models, images)
    assert _max_abs(actual[-1], plain[-1]) >= QUANT_MIN_EFFECT_PX


def test_raft_i8_forward_on_the_same_features_matches_jax(raft_models,
                                                          images):
    """The i8 forward with the port's int8 pyramid built from the JAX
    encoder's features (captured with a debug callback): the pyramid, the
    lookup and the recurrence then match within QUANT_REL; the two
    encoders' own features quantize to int8 at most one step apart in a
    share of at most I8_MAX_FEATURE_FLIPS."""
    captured, own = [], []
    jorig = jquant.correlation_pyramid_int8
    torig = tquant.correlation_pyramid_int8

    def capture(f1, f2, *args, **kwargs):
        jax.debug.callback(lambda a, b: captured.append(
            (np.asarray(a), np.asarray(b))), f1, f2)
        return jorig(f1, f2, *args, **kwargs)

    def substitute(f1, f2, *args, **kwargs):
        own.append((f1.numpy().copy(), f2.numpy().copy()))
        j1, j2 = captured[-1]
        return torig(torch.from_numpy(j1), torch.from_numpy(j2), *args,
                     **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant, "correlation_pyramid_int8", capture)
        mp.setattr(tquant, "correlation_pyramid_int8", substitute)
        expected, actual = _both(raft_models, images, fresh=True,
                                 quant="i8")
    assert len(captured) == len(own) == 1
    for a, e in zip(actual, expected):
        assert _max_abs(a, e) <= _bound(expected)

    def int8_features(f1, f2):
        f1, f2 = torch.from_numpy(f1), torch.from_numpy(f2)
        m1 = f1.abs().amax(dim=(1, 2), keepdim=True)
        m2 = f2.abs().amax(dim=(1, 2), keepdim=True)
        a = torch.sqrt(m1.clamp(min=1e-12) / m2.clamp(min=1e-12))
        return [tquant._quantize_features(g, 1.0)[0].numpy().astype(int)
                for g in (f1 / a, f2 * a)]

    for j, t in zip(int8_features(*captured[0]), int8_features(*own[0])):
        step = np.abs(j - t)
        assert step.max() <= 1
        assert (step > 0).mean() <= I8_MAX_FEATURE_FLIPS


def test_raft_quant_clip_matches_jax(raft_models, images):
    expected, actual = _both(raft_models, images, quant="u8",
                             quant_clip=0.5)
    for a, e in zip(actual, expected):
        assert _max_abs(a, e) <= _bound(expected)
    full, _ = _both(raft_models, images, quant="u8")
    assert _max_abs(actual[-1], full[-1]) > 0


def test_raft_quantized_pyramid_reaches_the_lookup(raft_models, images,
                                                   monkeypatch):
    """u8 quantizes the direct pyramid, i8 builds it from int8 dots; either
    way every lookup gets four QuantizedLevels of the mode's dtype."""
    tspec = raft_models[2]
    seen = []
    lookup = traft.lookup_pyramid_levels

    def record(pyramid, *args, **kwargs):
        seen.append([(type(p).__name__, p.values.dtype) for p in pyramid])
        return lookup(pyramid, *args, **kwargs)

    monkeypatch.setattr(traft, "lookup_pyramid_levels", record)
    x1, x2 = (torch.from_numpy(x) for x in images)
    for mode, dtype in (("u8", torch.uint8), ("int8", torch.int8)):
        seen.clear()
        with torch.no_grad():
            tspec.model.apply(x1, x2, quant=mode)
        assert seen == [[("QuantizedLevel", dtype)] * 4] * ITERATIONS


def test_raft_quant_off_is_the_unquantized_forward(raft_models, images,
                                                   monkeypatch):
    """quant None / 'off' calls no quant op and is bit for bit the forward
    without the argument (the pre-tier path), which JAX's unquantized
    forward holds within the f32 bound."""
    expected, plain = _both(raft_models, images)

    def refuse(*args, **kwargs):
        raise AssertionError("a quant op ran with quant off")

    monkeypatch.setattr(traft.quant_ops, "quantize_pyramid", refuse)
    monkeypatch.setattr(traft.quant_ops, "correlation_pyramid_int8", refuse)
    for off in (None, "off", False):
        _, actual = _both(raft_models, images, quant=off)
        for a, p in zip(actual, plain):
            assert torch.equal(a, p)
    for p, e in zip(plain, expected):
        assert _max_abs(p, e) <= 1e-4     # the unquantized f32 bound


# raft/fs at 1x64x96 (an 8x12 grid): budget 1e-5 GiB windows levels 0-1 and
# materializes levels 2-3, the suffix the tier quantizes (both modes store
# it quantized; there is no int8 feature dot in raft/fs)
FS_SPLIT = ("1e-5", 2)


@pytest.mark.parametrize("mode", ["u8", "i8"])
def test_raft_fs_quantized_forward_matches_jax(mode, fs_models, images,
                                               monkeypatch):
    gib, n_windowed = FS_SPLIT
    monkeypatch.setenv("RMD_FS_VOLUME_GIB", gib)
    assert traft_fs.volume_level_split((1, 8, 12), 4, 4) == n_windowed
    seen = []
    lookup = traft_fs.lookup_pyramid_levels

    def record(volumes, *args, first_level=0, **kwargs):
        seen.append((first_level, [
            v.values.dtype if isinstance(v, tquant.QuantizedLevel)
            else v.dtype for v in volumes]))
        return lookup(volumes, *args, first_level=first_level, **kwargs)

    monkeypatch.setattr(traft_fs, "lookup_pyramid_levels", record)
    expected, actual = _both(fs_models, images, quant=mode)
    dtype = torch.uint8 if mode == "u8" else torch.int8
    assert seen == [(n_windowed, [dtype] * 2)] * ITERATIONS
    for a, e in zip(actual, expected):
        assert tuple(a.shape) == e.shape == (1, 64, 96, 2)
        assert _max_abs(a, e) <= _bound(expected)
    plain, _ = _both(fs_models, images)
    assert _max_abs(actual[-1], plain[-1]) >= QUANT_MIN_EFFECT_PX


def test_raft_fs_quant_with_every_level_windowed_is_unquantized(
        fs_models, images, monkeypatch):
    """With no volume (budget 0) there is nothing to quantize: the forward
    equals the unquantized one bit for bit."""
    monkeypatch.setenv("RMD_FS_VOLUME_GIB", "0")
    tspec = fs_models[2]
    x1, x2 = (torch.from_numpy(x) for x in images)
    with torch.no_grad():
        plain = tspec.model.apply(x1, x2)
        quant = tspec.model.apply(x1, x2, quant="u8")
    for a, p in zip(quant, plain):
        assert torch.equal(a, p)
