"""PyTorch port: the data graph's wrappers held against the JAX package on
the CPU, bit for bit: the ``generic-backwards`` and ``multi`` layouts on a
FlyingThings3D-shaped tree with PFM flows (loaded through the shipped
``cfg/data/dataset/ufreiburg-flyingthings3d.yaml`` spec), ``concat``,
``repeat``, ``subset`` and ``cache``, both forwards/backwards sources and
the backwards-flow estimation with its fills, ``set_epoch``'s recursion,
and the loader's shuffled batches over a source that yields two pairs per
index."""

import json
import logging
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.data as jdata
import raft_meets_dicl_tpu.models.input as jinput
import raft_meets_dicl_tpu_torch.data as tdata
import raft_meets_dicl_tpu_torch.models.input as tinput
from raft_meets_dicl_tpu_torch.data import io as tio
from raft_meets_dicl_tpu_torch.utils import config as tconfig

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).parent.parent
THINGS_SPEC = ROOT / "cfg" / "data" / "dataset" / "ufreiburg-flyingthings3d.yaml"
SHAPE = (20, 28)
SEQUENCES = (("A", 0, range(6, 11)), ("B", 3, range(6, 10)))


def things_tree(root, shape=SHAPE, sequences=SEQUENCES, seed=0,
                outliers=0.0):
    """A FlyingThings3D-shaped tree under ``root``: PNG frames of both
    passes under ``frames_{clean,final}pass/TRAIN/<abc>/<seq>/left`` and
    3-channel PFM flows into the future and the past for every frame.
    ``outliers`` is the share of flow pixels made 50x larger. Returns the
    shipped Things spec with its ``path`` pointed at ``root``."""
    rs = np.random.RandomState(seed)
    h, w = shape
    for abc, seq, idxs in sequences:
        for pass_ in ("clean", "final"):
            d = root / f"frames_{pass_}pass" / "TRAIN" / abc / f"{seq:04d}" / "left"
            d.mkdir(parents=True)
            for i in idxs:
                cv2.imwrite(str(d / f"{i:04d}.png"),
                            rs.randint(0, 256, (h, w, 3), dtype=np.uint8))
        for direction in ("Future", "Past"):
            d = (root / "optical_flow" / "TRAIN" / abc / f"{seq:04d}"
                 / f"into_{direction.lower()}" / "left")
            d.mkdir(parents=True)
            for i in idxs:
                flow = np.zeros((h, w, 3), np.float32)
                flow[..., :2] = 3 * rs.randn(h, w, 2)
                flow[..., :2] *= np.where(rs.rand(h, w, 1) < outliers, 50, 1)
                tio.write_pfm(d / f"OpticalFlowInto{direction}_{i:04d}_L.pfm",
                              flow)
    return tconfig.load(THINGS_SPEC) | {"path": str(root)}


def things_source(spec, direction="forwards", pass_="clean"):
    return {"type": "dataset", "spec": spec,
            "parameters": {"type": "train", "pass": pass_,
                           "direction": direction, "camera": "left"}}


@pytest.fixture(scope="module")
def things(tmp_path_factory):
    root = tmp_path_factory.mktemp("things")
    return root, things_tree(root)


def _norm(cfg):
    return json.loads(json.dumps(cfg))


def assert_samples_equal(actual, expected):
    """Two ``(img1, img2, flow, valid, meta)`` samples bit for bit, the
    metadata field by field."""
    for a, e in zip(actual[:4], expected[:4]):
        if e is None:
            assert a is None
            continue
        assert a.dtype == e.dtype and a.shape == e.shape
        assert np.array_equal(a, e, equal_nan=a.dtype.kind == "f")
    assert len(actual[4]) == len(expected[4])
    for am, em in zip(actual[4], expected[4]):
        assert (am.valid, am.dataset_id, str(am.sample_id),
                vars(am.sample_id.img1), vars(am.sample_id.img2),
                am.original_extents, getattr(am, "direction", None)) == \
            (em.valid, em.dataset_id, str(em.sample_id),
             vars(em.sample_id.img1), vars(em.sample_id.img2),
             em.original_extents, getattr(em, "direction", None))


def assert_sources_equal(actual, expected):
    assert len(actual) == len(expected) > 0
    assert _norm(actual.get_config()) == _norm(expected.get_config())
    assert actual.description() == expected.description()
    for index in range(len(expected)):
        assert_samples_equal(actual[index], expected[index])


def _both(root, cfg):
    return tdata.load(root, cfg), jdata.load(root, cfg)


@pytest.mark.parametrize("pass_", ["clean", "final"])
@pytest.mark.parametrize("direction", ["forwards", "backwards"])
def test_things_layouts_match_jax(things, direction, pass_):
    """The shipped Things spec (``multi`` over ``generic`` and
    ``generic-backwards``): the same pairs, keys, PFM flows and masks."""
    root, spec = things
    actual, expected = _both(root, things_source(spec, direction, pass_))
    assert len(actual) == 7  # 4 + 3 pairs: a run's last frame has no partner
    assert [tuple(map(str, f)) for f in actual.files] == \
        [tuple(map(str, f)) for f in expected.files]
    assert_sources_equal(actual, expected)
    step = 1 if direction == "forwards" else -1
    for _, _, _, key in actual.files:
        assert key.img2.kwargs["idx"] == key.img1.kwargs["idx"] + step
    flow = actual[0][2]
    assert flow.shape == (1, *SHAPE, 2) and actual[0][3].all()


def test_concat_matches_jax(things):
    root, spec = things
    cfg = {"type": "concat", "sources": [
        things_source(spec, "forwards", "clean"),
        things_source(spec, "backwards", "final")]}
    actual, expected = _both(root, cfg)
    assert len(actual) == 14
    assert_sources_equal(actual, expected)
    assert_samples_equal(actual[-1], expected[-1])
    for bad in (14, -15):
        with pytest.raises(IndexError):
            actual[bad]
        with pytest.raises(IndexError):
            expected[bad]


def test_repeat_matches_jax(things):
    root, spec = things
    cfg = {"type": "repeat", "times": 3, "source": things_source(spec)}
    actual, expected = _both(root, cfg)
    assert len(actual) == 21
    assert_sources_equal(actual, expected)
    assert_samples_equal(actual[15], actual[1])
    with pytest.raises(IndexError):
        actual[21]


@pytest.mark.parametrize("seed", [None, 5])
def test_subset_matches_jax(things, seed):
    """A seeded subset draws its map from its own generator; without a
    seed, the seed comes from one global numpy draw, as in JAX."""
    root, spec = things
    cfg = {"type": "subset", "size": 5, "source": things_source(spec)}
    if seed is not None:
        cfg["seed"] = seed
    np.random.seed(1)
    actual = tdata.load(root, cfg)
    after = np.random.rand()
    np.random.seed(1)
    expected = jdata.load(root, cfg)
    assert np.random.rand() == after
    assert np.array_equal(actual.map, expected.map) and len(actual) == 5
    assert actual.seed == expected.seed
    assert_sources_equal(actual, expected)
    # the config pins the drawn seed: it reloads to the same subset
    again = tdata.load(root, actual.get_config())
    assert np.array_equal(again.map, actual.map)


class _Counting(tdata.Collection):
    """A source that logs each index it decodes to a file (one line per
    call, appended: worker processes share it) and returns arrays that own
    their data (a dataset's are views)."""

    def __init__(self, source, log):
        self.source = source
        self.log = log

    def __getitem__(self, index):
        with open(self.log, "a") as fd:
            fd.write(f"{index}\n")
        img1, img2, flow, valid, meta = self.source[index]
        return img1.copy(), img2.copy(), flow.copy(), valid.copy(), meta

    def __len__(self):
        return len(self.source)

    def calls(self):
        text = self.log.read_text() if self.log.exists() else ""
        return sorted(int(x) for x in text.split())


def test_cache_matches_jax(things, tmp_path, caplog):
    """Hits return the first decode's arrays, read-only where they own
    their data (as in JAX: a dataset's views stay writable), with fresh
    metadata each time; past the budget samples stream uncached and one
    warning is logged; both packages' caches decode and return the same."""
    root, spec = things
    cfg = {"type": "cache", "budget-gib": 1.0, "source": things_source(spec)}
    caches = _both(root, cfg)
    assert _norm(caches[0].get_config()) == _norm(caches[1].get_config())
    assert caches[0].description() == caches[1].description()
    samples = []
    for cache, name in zip(caches, ("port", "jax")):
        cache.source = _Counting(cache.source, tmp_path / name)
        first, hit = cache[2], cache[2]
        assert cache.source.calls() == [2]
        for a, b in zip(first[:4], hit[:4]):
            assert a is b and not a.flags.writeable
        with pytest.raises(ValueError, match="read-only"):
            hit[0][0, 0, 0, 0] = 1.0
        # fresh metadata per hit: the adapter's in-place flip stays local
        hit[4][0].valid = False
        assert cache[2][4][0].valid and first[4][0] is not hit[4][0]
        samples.append(cache[2])
    assert_samples_equal(*samples)

    # a budget of one sample: the second streams uncached, warned once
    one = sum(a.nbytes for a in samples[0][:4])
    caplog.set_level(logging.WARNING)
    for module, name in ((tdata, "port-small"), (jdata, "jax-small")):
        small = module.combinators.Cache(
            _Counting(module.load(root, things_source(spec)),
                      tmp_path / name), budget_gib=one / 2**30)
        for index in (0, 1, 1, 0, 3):
            small[index]
        assert small.source.calls() == [0, 1, 1, 3]
        assert small[1][0].flags.writeable
    assert [r.message for r in caplog.records] == [
        "sample cache budget (0.0 GiB) exhausted after 1 samples; further "
        "samples stream uncached"] * 2


def things_src(root, spec, direction="forwards"):
    return tdata.load(root, things_source(spec, direction))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_cache_across_epochs_under_the_loader(things, tmp_path, num_workers):
    """What a cache keeps under the port's Loader: in the caller (0
    workers) every index decodes once over two epochs; with worker
    processes, forked anew each epoch, every epoch decodes afresh."""
    root, spec = things
    counting = _Counting(things_src(root, spec), tmp_path / "calls")
    cache = tdata.combinators.Cache(counting)
    loader = tinput.Loader(cache, batch_size=2, shuffle=True,
                           num_workers=num_workers, seed=3)
    for _ in range(2):
        assert sum(len(b[4]) for b in loader) == len(counting)
    assert counting.calls() == sorted(list(range(len(counting))) * (
        1 if num_workers == 0 else 2))


def test_set_epoch_recurses_through_the_graph(things):
    """``set_epoch`` reaches every ``augment`` under ``concat``,
    ``repeat``, ``subset`` and ``cache``, as in JAX; the forwards/backwards
    sources hold ``forwards``/``backwards`` and it stops there on both
    sides."""
    root, spec = things
    aug = {"type": "augment", "augmentations": [{"type": "crop",
                                                 "size": [16, 12]}],
           "source": things_source(spec)}
    cfg = {"type": "concat", "sources": [
        {"type": "repeat", "times": 2, "source": aug},
        {"type": "subset", "size": 3, "seed": 1, "source": {
            "type": "cache", "source": aug}},
        {"type": "forwards-backwards-batch", "forwards": aug,
         "backwards": dict(aug, source=things_source(spec, "backwards"))}]}

    def epochs(src):
        found = []

        def walk(node):
            if node.type == "augment":
                found.append(node.epoch)
            for attr in ("source", "sources", "forwards", "backwards"):
                child = getattr(node, attr, None)
                for c in child if isinstance(child, list) else [child]:
                    if c is not None:
                        walk(c)
        walk(src)
        return found

    for src in _both(root, cfg):
        src.set_epoch(3)
        assert epochs(src) == [3, 3, 0, 0]


def test_forwards_backwards_batch_matches_jax(things):
    root, spec = things
    cfg = {"type": "forwards-backwards-batch",
           "forwards": things_source(spec, "forwards"),
           "backwards": things_source(spec, "backwards")}
    actual, expected = _both(root, cfg)
    assert_sources_equal(actual, expected)
    img1, img2, flow, valid, meta = actual[0]
    assert img1.shape[0] == 2 and [m.direction for m in meta] == \
        ["forwards", "backwards"]
    assert np.array_equal(img1[0], img2[1]) and np.array_equal(img2[0],
                                                               img1[1])


@pytest.mark.parametrize("fill", [
    {"method": "none"},
    {"method": "minimum", "parameters": {"kernel_size": [3, 3]}},
    {"method": "average", "parameters": {"kernel_size": [3, 3],
                                         "threshold": 2}},
], ids=lambda f: f["method"])
def test_forwards_backwards_estimate_matches_jax(things, fill):
    root, spec = things
    cfg = {"type": "forwards-backwards-estimate",
           "source": things_source(spec), "fill": fill,
           "parameters": {"th_weight": 0.2, "p_similarity": 1.5}}
    actual, expected = _both(root, cfg)
    assert_sources_equal(actual, expected)
    _, _, flow, valid, meta = actual[1]
    assert [str(m.sample_id).rsplit("/", 1)[0] for m in meta] == \
        [str(expected[1][4][0].sample_id).rsplit("/", 1)[0]] * 2
    assert meta[0].sample_id.format.endswith("-fwd")
    if fill["method"] == "none":
        assert np.isnan(flow[1][~valid[1]]).all()
    else:
        assert valid[1].all() and np.isfinite(flow[1]).all()


def _flow_case(seed, h=17, w=23):
    rs = np.random.RandomState(seed)
    img1 = rs.rand(h, w, 3).astype(np.float32)
    img2 = rs.rand(h, w, 3).astype(np.float32)
    flow = (3 * rs.randn(h, w, 2)).astype(np.float32)
    flow[4, 5] = (7.0, -2.0)  # an integer target: one corner gets it all
    valid = rs.rand(h, w) > 0.1
    return img1, img2, flow, valid


@pytest.mark.parametrize("params", [
    {}, {"th_weight": 0.0, "s_motion": 0.5, "p_motion": 2.0,
         "s_similarity": 3.0, "p_similarity": 1.0, "eps": 1e-3}],
    ids=["defaults", "tuned"])
def test_backwards_flow_estimation_matches_jax(params):
    for seed in (0, 1):
        args = _flow_case(seed)
        a = tdata.estimate_backwards_flow_sparse(*args, **params)
        e = jdata.estimate_backwards_flow_sparse(*args, **params)
        for x, y in zip(a, e):
            assert x.dtype == y.dtype and np.array_equal(x, y,
                                                         equal_nan=True)
        assert not a[1].all() and a[1].any()
        for method, fill_args in (("minimum", {}),
                                  ("average", {"threshold": 3}),
                                  ("none", {})):
            a = tdata.estimate_backwards_flow(*args, fill_method=method,
                                              fill_args=fill_args, **params)
            e = jdata.estimate_backwards_flow(*args, fill_method=method,
                                              fill_args=fill_args, **params)
            for x, y in zip(a, e):
                assert np.array_equal(x, y, equal_nan=True)
    with pytest.raises(ValueError, match="fill method"):
        tdata.estimate_backwards_flow(*args, fill_method="median")


@pytest.mark.parametrize("kernel_size,n_iter", [((3, 3), None), ((5, 3), 1),
                                                ((3, 5), 2)])
def test_fills_match_jax(kernel_size, n_iter):
    rs = np.random.RandomState(4)
    flow = rs.randn(19, 21, 2)
    valid = rs.rand(19, 21) > 0.6
    flow[~valid] = np.nan
    for name, kwargs in (("fill_min", {}), ("fill_avg", {"threshold": 2})):
        a = getattr(tdata.fw_bw, name)(flow.copy(), valid.copy(),
                                       kernel_size, n_iter=n_iter, **kwargs)
        e = getattr(jdata.fw_bw, name)(flow.copy(), valid.copy(),
                                       kernel_size, n_iter=n_iter, **kwargs)
        for x, y in zip(a, e):
            assert x.dtype == y.dtype and np.array_equal(x, y,
                                                         equal_nan=True)
        if n_iter is None:
            assert a[1].all()


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_shuffles_paired_batches_as_jax(things, num_workers):
    """A shuffled ``forwards-backwards-batch`` source (two pairs an index)
    through the adapter and the loader: the same seed gives the JAX
    Loader's batches, each batch's pairs permuted after concatenation,
    two epochs running; the last batch holds one index (two pairs)."""
    root, spec = things
    cfg = {"type": "forwards-backwards-batch",
           "forwards": things_source(spec, "forwards"),
           "backwards": things_source(spec, "backwards")}
    spec_in = {"padding": {"type": "modulo", "mode": "zeros",
                           "size": [8, 8]}}
    expected = jinput.InputSpec.from_config(spec_in).apply(
        jdata.load(root, cfg)).jax().loader(
        batch_size=3, shuffle=True, num_workers=0, seed=11)
    actual = tinput.InputSpec.from_config(spec_in).apply(
        tdata.load(root, cfg)).torch().loader(
        batch_size=3, shuffle=True, num_workers=num_workers, seed=11)
    assert len(actual) == len(expected) == 3

    for _ in range(2):
        sizes = []
        for a, e in zip(actual, expected, strict=True):
            for x, y in zip(a[:4], e[:4]):
                assert np.array_equal(x.numpy(), y)
            assert [str(m.sample_id) for m in a[4]] == \
                [str(m.sample_id) for m in e[4]]
            sizes.append(a[0].shape[0])
        assert sizes == [6, 6, 2]



class _Failing(tdata.Collection):
    def __init__(self, source, bad):
        self.source = source
        self.bad = bad

    def __getitem__(self, index):
        if index == self.bad:
            raise ValueError(f"cannot decode sample {index}")
        return self.source[index]

    def __len__(self):
        return len(self.source)


def test_loader_shuffle_thread_stops_and_raises(things):
    """With workers, a shuffled loader gathers in a thread of its own:
    leaving the loop early stops and joins it, and a sample that fails to
    decode raises in the caller."""
    root, spec = things

    def threads():
        return [t for t in threading.enumerate() if t.name == "loader-shuffle"]

    loader = tinput.Loader(things_src(root, spec), batch_size=2,
                           shuffle=True, num_workers=1, seed=1)
    for _ in loader:
        assert len(threads()) == 1
        break
    assert not threads()

    # healing off (budget 0): the sample's own error, not a substitute
    loader = tinput.Loader(_Failing(things_src(root, spec), 5), batch_size=2,
                           shuffle=True, num_workers=1, seed=1,
                           bad_sample_budget=0)
    with pytest.raises(ValueError, match="cannot decode sample 5"):
        list(loader)
    assert not threads()


@pytest.mark.parametrize("batch_size", [1, 3])
def test_loader_pins_every_shuffled_batch(things, monkeypatch, batch_size):
    """With ``pin_memory`` a shuffled batch is pinned after its gather,
    a single pair's too (which has no permutation to gather): each of its
    four tensors once."""
    root, spec = things
    pinned = []
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t: pinned.append(t.shape) or t)
    loader = tinput.Loader(things_src(root, spec), batch_size=batch_size,
                           shuffle=True, num_workers=0, seed=2,
                           pin_memory=True)
    batches = list(loader)
    assert len(pinned) == 4 * len(batches) == 4 * len(loader)
