"""PyTorch port: the host side of ``main evaluate`` held against the JAX
package on the CPU.

- every ``visual/`` map on the same seeded numpy inputs: bit for bit (the
  maps are the JAX package's numpy, colormaps included); the backwards
  warp preview within 1e-6;
- the embedded ``gray`` and ``viridis`` tables and their lookup against
  matplotlib's, and a missing matplotlib refused by name for any other
  colormap;
- ``ops/warp.py`` against JAX ``ops/warp.py`` within 1e-6;
- ``video/products.py`` bit for bit;
- ``write_flow_kitti`` read back through both packages' readers;
- the shape-grouping ``Loader`` (``group_by_shape`` over shape buckets and
  plain grouping) against the JAX ``Loader``: the same batches, in the
  same order, with the same ``meta``, over the shapes of
  ``tests/test_eval_buckets.py``;
- ``EvalRunStats``' counters and ``_real_pixels``.
"""

import sys
import warnings

import jax.numpy as jnp
import matplotlib
import matplotlib.colors
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.data.collection as jcoll
import raft_meets_dicl_tpu.data.io as jio
import raft_meets_dicl_tpu.evaluation as jeval
import raft_meets_dicl_tpu.models.input as jinput
import raft_meets_dicl_tpu.ops.warp as jwarp
import raft_meets_dicl_tpu.video.products as jproducts
from raft_meets_dicl_tpu import visual as jvisual
import raft_meets_dicl_tpu_torch.data.collection as tcoll
import raft_meets_dicl_tpu_torch.data.io as tio
import raft_meets_dicl_tpu_torch.evaluation as teval
import raft_meets_dicl_tpu_torch.models.input as tinput
import raft_meets_dicl_tpu_torch.ops.warp as twarp
import raft_meets_dicl_tpu_torch.video.products as tproducts
from raft_meets_dicl_tpu_torch import visual as tvisual
from raft_meets_dicl_tpu_torch.visual import colormaps
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# the warp: float32 bilinear weights and sums in the same order on both
# sides; allow a few float32 roundings of values in [0, 1]
WARP_ATOL = 1e-6

SHAPE = (23, 31)


def _flow_pair(seed, shape=SHAPE, scale=4.0):
    rs = np.random.RandomState(seed)
    target = (scale * rs.randn(*shape, 2)).astype(np.float32)
    estimate = (target + 2.0 * rs.randn(*shape, 2)).astype(np.float32)
    valid = rs.rand(*shape) > 0.25
    return estimate, target, valid


def _with_nonfinite(uv):
    uv = uv.copy()
    uv[0, 0, 0] = np.nan
    uv[1, 2, 1] = np.inf
    return uv


# -- colormaps ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["gray", "viridis"])
def test_embedded_colormap_tables_match_matplotlib(name):
    cmap = matplotlib.colormaps[name]
    x = np.linspace(0.0, 1.0, colormaps.N)
    assert np.array_equal(colormaps.TABLES[name][:colormaps.N], cmap(x))
    # every entry, and the under / over / bad colors
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(4000) * 0.6 + 0.5,
                        [0.0, -0.0, 1.0, -1e-300, 1.0 + 1e-16, 7.0, -3.0,
                         np.nan, np.inf, -np.inf],
                        (np.arange(colormaps.N) + 0.5) / colormaps.N])
    assert np.array_equal(colormaps.apply(name, x), cmap(x))


@pytest.mark.parametrize("bounds", [(0.0, None), (0.0, 2.5), (None, None),
                                    (1.0, 1.0), (0.5, 3.0)])
def test_normalize_matches_matplotlib(bounds):
    vmin, vmax = bounds
    d = np.abs(np.random.RandomState(1).randn(17, 19)) * 3
    expected = matplotlib.colors.Normalize(vmin=vmin, vmax=vmax)(d)
    actual = colormaps.normalize(d, vmin, vmax)
    assert np.array_equal(actual, np.ma.getdata(expected))


def test_other_colormaps_need_matplotlib(monkeypatch):
    d = np.abs(np.random.RandomState(2).randn(5, 7))
    # through matplotlib where it is installed
    assert np.array_equal(colormaps.apply("magma", d),
                          matplotlib.colormaps["magma"](d))
    # refused by name without it; the built-in maps need nothing
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        colormaps.apply("magma", d)
    colormaps.apply("gray", d)
    colormaps.apply("viridis", d)


# -- visual maps -------------------------------------------------------------


def _mask_cases():
    _, _, valid = _flow_pair(3)
    return {"none": None, "masked": valid}


@pytest.mark.parametrize("mask", ["none", "masked"])
@pytest.mark.parametrize("kwargs", [{}, {"mrm": 5.0}, {"gamma": 0.7},
                                    {"transform": "log"},
                                    {"transform": "loglog", "mrm": 2.0}],
                         ids=str)
def test_flow_to_rgba_dark_matches_jax(kwargs, mask):
    uv, _, _ = _flow_pair(4)
    m = _mask_cases()[mask]
    for flow in (uv, _with_nonfinite(uv)):
        # both warn of the non-finite values they draw in nan_color
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            expected = jvisual.flow_to_rgba_dark(flow, mask=m, **kwargs)
            actual = tvisual.flow_to_rgba_dark(flow, mask=m, **kwargs)
        assert np.array_equal(actual, expected)


@pytest.mark.parametrize("mask", ["none", "masked"])
@pytest.mark.parametrize("kwargs", [{}, {"vmax": 4.0}, {"cmap": "viridis"},
                                    {"ord": 1, "vmin": 1.0},
                                    {"cmap": "magma", "vmax": 8.0}], ids=str)
def test_end_point_error_matches_jax(kwargs, mask):
    uv, target, _ = _flow_pair(5)
    m = _mask_cases()[mask]
    expected = jvisual.end_point_error(uv, target, m, **kwargs)
    actual = tvisual.end_point_error(uv, target, m, **kwargs)
    assert np.array_equal(actual, expected)


@pytest.mark.parametrize("mask", ["none", "masked"])
def test_abs_epe_and_fl_error_match_jax(mask):
    uv, target, _ = _flow_pair(6, scale=12.0)
    uv = _with_nonfinite(uv)
    m = _mask_cases()[mask]
    with np.errstate(invalid="ignore"):
        assert np.array_equal(tvisual.end_point_error_abs(uv, target, m),
                              jvisual.end_point_error_abs(uv, target, m))
        assert np.array_equal(tvisual.fl_error(uv, target, m),
                              jvisual.fl_error(uv, target, m))


def test_occlusion_and_confidence_match_jax():
    rs = np.random.RandomState(7)
    img = rs.rand(*SHAPE, 3).astype(np.float32) * 1.2 - 0.1
    occlusion = rs.rand(*SHAPE) > 0.7
    confidence = rs.rand(*SHAPE).astype(np.float32)
    confidence[0, 0] = np.nan
    assert np.array_equal(tvisual.occlusion_overlay(img, occlusion),
                          jvisual.occlusion_overlay(img, occlusion))
    assert np.array_equal(
        tvisual.occlusion_overlay(None, occlusion, color=(0, 1, 0),
                                  strength=0.3),
        jvisual.occlusion_overlay(None, occlusion, color=(0, 1, 0),
                                  strength=0.3))
    for kwargs in ({}, {"cmap": "gray", "vmax": 0.5}, {"cmap": "magma"}):
        assert np.array_equal(
            tvisual.confidence_to_rgba(confidence, **kwargs),
            jvisual.confidence_to_rgba(confidence, **kwargs))


def test_rgba_to_bgra_and_aliases_match_jax():
    rgba = np.random.RandomState(8).rand(5, 6, 4)
    assert np.array_equal(tvisual.utils.rgba_to_bgra(rgba),
                          jvisual.utils.rgba_to_bgra(rgba))
    for name in jvisual.__all__:
        assert hasattr(tvisual, name), name


# -- warp --------------------------------------------------------------------


def test_coordinate_grid_matches_jax():
    expected = np.asarray(jwarp.coordinate_grid(2, 5, 7))
    actual = twarp.coordinate_grid(2, 5, 7).numpy()
    assert np.array_equal(actual, expected)


@pytest.mark.parametrize("scale", [0.5, 6.0, 40.0])
def test_warp_backwards_matches_jax(scale):
    rs = np.random.RandomState(9)
    img2 = rs.rand(2, *SHAPE, 3).astype(np.float32)
    flow = (scale * rs.randn(2, *SHAPE, 2)).astype(np.float32)
    est, mask = jwarp.warp_backwards(jnp.asarray(img2), jnp.asarray(flow))
    test, tmask = twarp.warp_backwards(torch.from_numpy(img2),
                                       torch.from_numpy(flow))
    assert np.array_equal(tmask.numpy(), np.asarray(mask))
    assert np.abs(test.numpy() - np.asarray(est)).max() <= WARP_ATOL

    # the host preview of visual/warp.py, one image
    expected = jvisual.warp_backwards(img2[0], flow[0])
    actual = tvisual.warp_backwards(img2[0], flow[0])
    assert np.abs(actual - expected).max() <= WARP_ATOL


# -- fw/bw products ----------------------------------------------------------


@pytest.mark.parametrize("scale", [0.5, 3.0, 30.0])
def test_fw_bw_products_match_jax_bit_for_bit(scale):
    rs = np.random.RandomState(10)
    fw = (scale * rs.randn(*SHAPE, 2)).astype(np.float32)
    bw = (-fw + 0.3 * rs.randn(*SHAPE, 2)).astype(np.float32)

    w, inside = tproducts.warp_flow(bw, fw)
    jw, jinside = jproducts.warp_flow(bw, fw)
    assert np.array_equal(w, jw) and np.array_equal(inside, jinside)

    occ, conf = tproducts.fw_bw_products(fw, bw, alpha=0.02, beta=0.3)
    jocc, jconf = jproducts.fw_bw_products(fw, bw, alpha=0.02, beta=0.3)
    assert occ.dtype == jocc.dtype and conf.dtype == jconf.dtype
    assert np.array_equal(occ, jocc) and np.array_equal(conf, jconf)

    batch = (np.stack([fw, bw]), np.stack([bw, fw]))
    for a, b in zip(tproducts.fw_bw_products_batch(*batch),
                    jproducts.fw_bw_products_batch(*batch)):
        assert np.array_equal(a, b)

    with pytest.raises(ValueError, match="share"):
        tproducts.fw_bw_products(fw, bw[:-1])


# -- KITTI flow files --------------------------------------------------------


@pytest.mark.parametrize("with_valid", [False, True])
def test_write_flow_kitti_reads_back_in_both_packages(tmp_path, with_valid):
    rs = np.random.RandomState(11)
    uv = (20 * rs.randn(*SHAPE, 2)).astype(np.float32)
    valid = rs.rand(*SHAPE) > 0.3 if with_valid else None
    tio.write_flow_kitti(tmp_path / "port.png", uv, valid)
    jio.write_flow_kitti(tmp_path / "jax.png", uv, valid)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()

    expected_valid = np.ones(SHAPE, bool) if valid is None else valid
    for read in (tio.read_flow_kitti, jio.read_flow_kitti):
        flow, v = read(tmp_path / "port.png")
        assert np.array_equal(v, expected_valid)
        # 1/64 px steps, truncated toward zero by the uint16 cast
        assert np.abs(flow - uv).max() < 1 / 64
    with pytest.raises(FileNotFoundError):
        tio.write_flow_kitti(tmp_path / "missing" / "x.png", uv)


# -- the shape-grouping loader -----------------------------------------------

# the shapes of tests/test_eval_buckets.py's cases, with the buckets and
# the input padding each ran with
MODULO = {"type": "modulo", "mode": "zeros", "size": [8, 8]}
GROUP_CASES = {
    "loader_group_by_shape": (
        [(32, 48), (16, 24), (32, 48), (16, 24), (32, 48), (24, 32)], 1,
        None, "group"),
    "input_buckets_end_to_end": (
        [(30, 40), (14, 22), (28, 38), (15, 23), (31, 41)], 1, None,
        "32x48,16x24"),
    "bucketed_epe_parity": ([(30, 44), (24, 34), (17, 25)], 2, MODULO,
                            "32x48,24x40"),
    "bucketed_epe_parity_group": ([(30, 44), (24, 34), (17, 25)], 2, MODULO,
                                  "group"),
    "pad_to": ([(30, 44), (17, 25)], 3, MODULO, "32x48,24x40"),
}


def _source(coll, shapes, per_shape, flow=True):
    """Seeded samples of ``shapes`` (``per_shape`` each, in order) with
    ``coll``'s Metadata; sample i's id is ``s/<i>``."""
    out = []
    i = 0
    for h, w in shapes:
        for _ in range(per_shape):
            rs = np.random.RandomState(1000 + i)
            meta = [coll.Metadata(
                True, "test",
                coll.SampleId("s/{i}", coll.SampleArgs([], {"i": i}),
                              coll.SampleArgs([], {"i": i})),
                ((0, h), (0, w)))]
            out.append((rs.rand(1, h, w, 3).astype(np.float32),
                        rs.rand(1, h, w, 3).astype(np.float32),
                        (3 * rs.randn(1, h, w, 2)).astype(np.float32)
                        if flow else None,
                        rs.rand(1, h, w) > 0.3 if flow else None, meta))
            i += 1
    return out


def _assert_batches_equal(actual, expected):
    assert len(actual) == len(expected)
    for a, e in zip(actual, expected):
        for x, y in zip(a[:4], e[:4]):
            if y is None:
                assert x is None
            else:
                assert np.array_equal(x.numpy(), y)
        assert [str(m.sample_id) for m in a[4]] == \
            [str(m.sample_id) for m in e[4]]
        assert [m.original_extents for m in a[4]] == \
            [m.original_extents for m in e[4]]


@pytest.mark.parametrize("batch_size", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_grouped_loader_matches_jax(case, batch_size):
    shapes, per_shape, padding, spec = GROUP_CASES[case]
    cfg = {"padding": padding}
    batches = []
    for coll, inp in ((jcoll, jinput), (tcoll, tinput)):
        source = _source(coll, shapes, per_shape)
        buckets = inp.ShapeBuckets.parse(spec)
        adapter = inp.InputSpec.from_config(cfg).apply(source,
                                                       buckets=buckets)
        adapter = adapter.jax() if inp is jinput else adapter.torch()
        batches.append(list(adapter.loader(
            batch_size=batch_size, shuffle=False, num_workers=0,
            group_by_shape=True)))
    expected, actual = batches
    _assert_batches_equal(actual, expected)
    # the port's batches are single-shape, and with buckets the padded
    # pixels are invalid
    for img1, _, _, valid, meta in actual:
        for b, m in enumerate(meta):
            (y0, y1), (x0, x1) = m.original_extents
            outside = torch.ones(valid.shape[1:], dtype=torch.bool)
            outside[y0:y1, x0:x1] = False
            assert not valid[b][outside].any()


@pytest.mark.parametrize("options", [
    {"num_workers": 2}, {"shuffle": True, "seed": 5},
    {"shuffle": True, "seed": 5, "num_workers": 2},
    {"drop_last": True}, {"flow": False}], ids=str)
def test_grouped_loader_options_match_jax(options):
    options = dict(options)
    flow = options.pop("flow", True)
    shapes, per_shape, padding, spec = GROUP_CASES["pad_to"]
    batches = []
    for coll, inp in ((jcoll, jinput), (tcoll, tinput)):
        source = _source(coll, shapes, per_shape, flow=flow)
        adapter = inp.InputSpec.from_config({"padding": padding}).apply(
            source, buckets=inp.ShapeBuckets.parse(spec))
        adapter = (adapter.jax(flow) if inp is jinput
                   else adapter.torch(flow))
        batches.append(list(adapter.loader(
            batch_size=2, group_by_shape=True, **options)))
    expected, actual = batches
    _assert_batches_equal(actual, expected)


def test_buckets_must_fit_the_padding():
    spec = tinput.InputSpec.from_config({"padding": MODULO})
    with pytest.raises(ValueError, match="not a multiple"):
        spec.apply([], buckets=tinput.ShapeBuckets([(30, 48)]))
    spec.apply([], buckets=tinput.ShapeBuckets([(32, 48)]))


# -- sweep accounting --------------------------------------------------------


def test_eval_run_stats_match_jax():
    batches = [((32, 48), 2, 0, [((0, 30), (0, 44))] * 2),
               ((24, 40), 2, 0, [((0, 24), (0, 34)), ((0, 17), (0, 25))]),
               ((32, 48), 1, 1, [((0, 30), (0, 44))]),
               ((24, 40), 1, 3, [None])]
    jstats, tstats = jeval.EvalRunStats(name="x"), teval.EvalRunStats(name="x")
    for shape, samples, pad, extents in batches:
        jmeta = [jcoll.Metadata(True, "t", None, e) for e in extents]
        tmeta = [tcoll.Metadata(True, "t", None, e) for e in extents]
        real = teval._real_pixels(tmeta, shape, samples)
        assert real == jeval._real_pixels(jmeta, shape, samples)
        jstats.add_batch(shape, samples, pad, real)
        tstats.add_batch(shape, samples, pad, real)
        jstats.add_phase("dispatch", 0.25)
        tstats.add_phase("dispatch", 0.25)

    for key in ("name", "samples", "batches", "pad_samples", "real_pixels",
                "total_pixels", "phases"):
        assert getattr(tstats, key) == getattr(jstats, key), key
    assert tstats.pad_waste_ratio() == jstats.pad_waste_ratio()
    # the JAX buckets also count compiles, which eager torch does not have
    assert tstats.buckets == {
        k: {n: v for n, v in b.items() if n != "compiles"}
        for k, b in jstats.buckets.items()}
    assert teval.EvalRunStats().pad_waste_ratio() == 0.0
    assert tstats.samples_per_sec() > 0
