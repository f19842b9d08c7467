"""PyTorch port: the streaming-video engine held against the JAX package on
the CPU.

- ``video.project_flow`` against JAX's on a smooth flow and on one that
  leaves the frame;
- ``video.SessionCache`` driven through one sequence of calls beside
  JAX's on a fake clock (return values, entry order, hit/miss/eviction/
  active counts), snapshots crossing between the packages, and every
  ``CarryMismatch`` message;
- ``evaluation.make_warm_fn``: a zero carry is bit for bit the port's base
  rung; a nonzero carry and a u8 wire against JAX's ``make_warm_fn`` with
  bridged weights;
- ``video.SequenceRunner`` over 4 frames, warm, ``carry_hidden=True`` and
  cold, against JAX's runner; ``fw_bw_flows``;
- serving: the scheduler's sequence requests on a stand-in session
  (``no_video``, partly warm batches, fill rows, resolution switches,
  products), ``run_open_loop(sequence=True)``'s warm/cold split, a video
  ``ServeSession`` and ``main serve --video`` on the CPU;
- ``inspect.summary.write_images`` with the fw/bw product images.

The model is JAX's ``tests/test_video.py`` tiny raft at 1x32x48, its JAX
variables drawn over ``jax.eval_shape`` (no init program compiled), and
the port runs on one thread. Flows are held to the raft forward test's
F32_MAX_ABS_PX (absolute), as ``test_torch_port_ladder.py`` holds rungs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu import evaluation as jevaluation
from raft_meets_dicl_tpu import video as jvideo
from raft_meets_dicl_tpu.inspect import summary as jsummary
from raft_meets_dicl_tpu.models import wire as jwire
from raft_meets_dicl_tpu.serve import ladder as jladder
from raft_meets_dicl_tpu.serve import loadgen as jloadgen
from raft_meets_dicl_tpu.serve import scheduler as jscheduler
from raft_meets_dicl_tpu.telemetry import metrics as jmetrics
from raft_meets_dicl_tpu_torch import evaluation, serve, video
from raft_meets_dicl_tpu_torch import main as port_main
from raft_meets_dicl_tpu_torch.data.collection import Metadata
from raft_meets_dicl_tpu_torch.inspect import summary as tsummary
from raft_meets_dicl_tpu_torch.models import wire as twire
from raft_meets_dicl_tpu_torch.models.input import ShapeBuckets
from raft_meets_dicl_tpu_torch.serve import loadgen
from test_torch_port_dicl_models import _port, _variables
from test_torch_port_raft import F32_MAX_ABS_PX
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# JAX's tests/test_video.py model, copied
TINY_VIDEO_MODEL = {
    "name": "video tiny", "id": "video-tiny",
    "model": {"type": "raft/baseline",
              "parameters": {"corr-levels": 2, "corr-radius": 2,
                             "corr-channels": 32, "context-channels": 16,
                             "recurrent-channels": 16},
              "arguments": {"iterations": 2}},
    "loss": {"type": "raft/sequence"},
    "input": {"padding": {"type": "modulo", "mode": "zeros",
                          "size": [8, 8]}},
}
SHAPE = (1, 32, 48)


def _frames(n=5, shift=2, seed=5):
    """JAX's constant-motion frames: a textured image rolled by ``shift``
    px a frame, in the model's [-1, 1] range."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (*SHAPE[1:], 3)).astype(np.float32)
    return [np.roll(base, i * shift, axis=1)[None] for i in range(n)]


@pytest.fixture(scope="module")
def tiny():
    """(JAX spec, JAX variables, the port's spec with them)."""
    frames = _frames()
    variables = _variables(TINY_VIDEO_MODEL, (frames[0], frames[1]))
    return (jmodels.load(TINY_VIDEO_MODEL),
            jax.tree.map(jnp.asarray, variables),
            _port(TINY_VIDEO_MODEL, variables))


def _t(x):
    return torch.from_numpy(np.array(x))


def _max_abs(actual, expected):
    return float(np.abs(np.asarray(actual) - np.asarray(expected)).max())


# -- project_flow ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["smooth", "leaves the frame"])
def test_project_flow_matches_jax(case):
    h, w = 12, 16
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    flow = np.stack([1.5 * np.sin(xx / 5.0) + 0.3 * yy / h,
                     np.cos(yy / 4.0) - 0.2], -1)[None].astype(np.float32)
    if case == "leaves the frame":
        flow = flow * 4.0 + np.float32(6.0)
    expected = np.asarray(jvideo.project_flow(jnp.asarray(flow)))
    actual = video.project_flow(torch.from_numpy(flow))
    assert actual.dtype == torch.float32
    assert _max_abs(actual, expected) <= 1e-6
    if case == "leaves the frame":
        # the masked samples are exact zeros in both
        assert np.array_equal(actual.numpy() == 0, expected == 0)
        assert (expected == 0).any()
    assert torch.equal(video.project_flow(torch.zeros(1, h, w, 2)),
                       torch.zeros(1, h, w, 2))


# -- SessionCache ---------------------------------------------------------------


class _Clock:
    """Injectable monotonic clock for TTL tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


_JAX_COUNTERS = {"hits": "rmd_serve_session_warm_hits_total",
                 "misses": "rmd_serve_session_misses_total",
                 "evictions": "rmd_serve_session_evictions_total",
                 "active": "rmd_serve_session_active"}


def _jax_counts():
    reg = jmetrics.registry()
    return {k: reg.get_metric(name).value
            for k, name in _JAX_COUNTERS.items()}


def _script(flow, small):
    """One sequence of calls through hit, miss, shape switch, TTL, LRU,
    drop and ``clients``, each as (method, args, clock time)."""
    return [
        ("get", ("a",), 0.0), ("put", ("a", flow), 0.0),
        ("get", ("a",), 1.0), ("get", ("a", (4, 6, 2)), 2.0),
        ("get", ("a", (8, 12, 2)), 3.0), ("get", ("a",), 3.0),
        ("put", ("a", flow), 4.0), ("put", ("b", small), 5.0),
        ("get", ("a",), 6.0), ("put", ("c", flow), 7.0),
        ("clients", (), 7.0), ("get", ("b",), 8.0),
        ("put", ("d", small), 9.0), ("clients", (), 9.0),
        ("drop", ("c",), 10.0), ("drop", ("c",), 10.0),
        ("get", ("a",), 14.5), ("clients", (), 15.0),
        ("get", ("a",), 25.0), ("put", ("e", flow), 30.0),
        ("get", ("d",), 31.0), ("clients", (), 50.0), ("get", ("e",), 51.0),
    ]


def test_session_cache_follows_jax_call_for_call():
    flow = np.arange(48, dtype=np.float32).reshape(4, 6, 2)
    small = np.ones((2, 3, 2), np.float32)
    jclock, tclock = _Clock(), _Clock()
    jcache = jvideo.SessionCache(capacity=2, ttl_s=10.0, clock=jclock)
    tcache = video.SessionCache(capacity=2, ttl_s=10.0, clock=tclock)
    before = _jax_counts()
    for method, args, t in _script(flow, small):
        jclock.t = tclock.t = t
        j = getattr(jcache, method)(*args)
        p = getattr(tcache, method)(*args)
        if isinstance(j, np.ndarray):
            assert p is not None and np.array_equal(p, j), (method, args, t)
        else:
            assert p == j, (method, args, t)
        assert list(tcache._entries) == list(jcache._entries), (method, t)
        assert len(tcache) == len(jcache)
    after = _jax_counts()
    assert (tcache.hits, tcache.misses, tcache.evictions) == tuple(
        after[k] - before[k] for k in ("hits", "misses", "evictions"))
    assert tcache.active == after["active"]
    assert tcache.hits and tcache.misses and tcache.evictions


def test_session_cache_defaults_and_validation_match_jax(monkeypatch):
    for name in ("RMD_VIDEO_SESSIONS", "RMD_VIDEO_SESSION_TTL_S"):
        monkeypatch.delenv(name, raising=False)
    j, t = jvideo.SessionCache(), video.SessionCache()
    assert (t.capacity, t.ttl_s) == (j.capacity, j.ttl_s) == (64, 30.0)
    monkeypatch.setenv("RMD_VIDEO_SESSIONS", "3")
    monkeypatch.setenv("RMD_VIDEO_SESSION_TTL_S", "2.5")
    assert (video.SessionCache().capacity, video.SessionCache().ttl_s) \
        == (3, 2.5)
    for kwargs in ({"capacity": 0, "ttl_s": 1.0},
                   {"capacity": 1, "ttl_s": 0.0}):
        with pytest.raises(ValueError) as je:
            jvideo.SessionCache(**kwargs)
        with pytest.raises(ValueError) as te:
            video.SessionCache(**kwargs)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_carry_snapshots_cross_between_the_packages(exporter):
    flow = np.random.default_rng(3).standard_normal((4, 6, 2)).astype(
        np.float32)
    caches = {"jax": jvideo.SessionCache(capacity=2, ttl_s=10.0),
              "port": video.SessionCache(capacity=2, ttl_s=10.0)}
    source = caches[exporter]
    target = caches["port" if exporter == "jax" else "jax"]
    source.put("cam0", flow)
    snap = source.export_carry("cam0")
    other = (jvideo if exporter == "port" else video).SessionCache(
        capacity=2, ttl_s=10.0)
    other.put("cam0", flow)
    assert json.dumps(snap) == json.dumps(other.export_carry("cam0"))
    got = target.import_carry(json.loads(json.dumps(snap)),
                              shape=(4, 6, 2))
    assert got.tobytes() == flow.tobytes() and got.dtype == flow.dtype
    assert target.get("cam0").tobytes() == flow.tobytes()
    assert source.export_carry("nobody") is None


def _bad_snapshots():
    flow = np.ones((2, 3, 2), np.float32)
    cache = video.SessionCache(capacity=2, ttl_s=10.0)
    cache.put("c", flow)
    good = cache.export_carry("c")
    return {
        "not an object": ([1, 2], {}),
        "missing keys": ({"shape": [2]}, {}),
        "no client": (dict(good, client=""), {}),
        "bad dtype": (dict(good, dtype="float99"), {}),
        "bad base64": (dict(good, data="@@@"), {}),
        "shape mismatch": (good, {"shape": (4, 6, 2)}),
        "short payload": (dict(good, shape=[2, 3, 3]), {}),
        "crc": (dict(good, crc=good["crc"] ^ 1), {}),
    }


@pytest.mark.parametrize("case", list(_bad_snapshots()))
def test_carry_mismatch_messages_match_jax(case):
    snap, kwargs = _bad_snapshots()[case]
    with pytest.raises(jvideo.CarryMismatch) as je:
        jvideo.SessionCache(capacity=2, ttl_s=10.0).import_carry(
            snap, **kwargs)
    with pytest.raises(video.CarryMismatch) as te:
        video.SessionCache(capacity=2, ttl_s=10.0).import_carry(
            snap, **kwargs)
    assert isinstance(te.value, ValueError)
    assert str(te.value) == str(je.value)


# -- make_warm_fn -----------------------------------------------------------------


def test_warm_step_on_a_zero_carry_is_the_base_rung(tiny):
    _, _, spec = tiny
    frames = _frames()
    img1, img2 = (torch.from_numpy(x) for x in frames[:2])
    plain = evaluation.make_rung_fn(spec.model, 2)
    warm = evaluation.make_warm_fn(spec.model, 2)
    assert (warm.iterations, warm.cont, warm.warm, warm.quant) == (
        2, False, True, None)
    flow_p, state_p = plain(img1, img2)
    flow_w, state_w = warm(img1, img2, torch.zeros_like(state_p["flow"]))
    flow_n, _ = warm(img1, img2, state_p["flow"])
    assert torch.equal(flow_w, flow_p)
    for key in ("flow", "hidden", "delta"):
        assert torch.equal(state_w[key], state_p[key]), key
    assert not torch.equal(flow_n, flow_p)


@pytest.mark.parametrize("wire", [None, "u8"])
def test_warm_step_matches_jax_on_a_nonzero_carry(tiny, wire):
    """The carry is JAX's own 2-iteration rung's on the previous pair;
    with a u8 wire both packages take the encoded images and decode them
    inside the step."""
    jspec, v, spec = tiny
    frames = _frames()
    jflow0, jstate0 = jevaluation.make_rung_fn(jspec.model, 2)(
        v, jnp.asarray(frames[0]), jnp.asarray(frames[1]))
    carry = np.array(jstate0["flow"])
    jw = tw = None
    x1, x2 = frames[1], frames[2]
    if wire is not None:
        jw = jwire.WireFormat.from_config(wire)
        tw = twire.WireFormat.from_config(wire)
        # raw [0, 1] images, as admission takes them
        x1, x2 = (tw.encode_image((x[0] + 1) / 2)[None] for x in (x1, x2))
        assert x1.dtype == np.uint8
    jflow, jstate = jevaluation.make_warm_fn(jspec.model, 2, wire=jw)(
        v, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(carry))
    step = evaluation.make_warm_fn(spec.model, 2, wire=tw)
    flow, state = step(twire.as_tensor(x1), twire.as_tensor(x2),
                       torch.from_numpy(carry))
    assert _max_abs(flow, jflow) <= F32_MAX_ABS_PX
    for key in ("flow", "hidden", "delta"):
        assert tuple(state[key].shape) == jstate[key].shape
        assert _max_abs(state[key], jstate[key]) <= F32_MAX_ABS_PX, key


def test_quant_warm_step_on_a_zero_carry_is_the_quant_base_rung(tiny):
    _, _, spec = tiny
    img1, img2 = (torch.from_numpy(x) for x in _frames()[:2])
    warm = evaluation.make_warm_fn(spec.model, 2, quant="u8")
    assert warm.quant == "u8"
    flow_p, state_p = evaluation.make_rung_fn(spec.model, 2,
                                              quant="u8")(img1, img2)
    flow_w, state_w = warm(img1, img2, torch.zeros_like(state_p["flow"]))
    assert torch.equal(flow_w, flow_p)
    assert torch.equal(state_w["hidden"], state_p["hidden"])


# -- SequenceRunner ---------------------------------------------------------------


# mode -> (runner options, run options, expected (warm, iterations, rungs)
# per frame); thresholds far from any delta, so the escalation decisions
# cannot differ between the packages
RUNS = {
    "warm": ({"threshold": float("inf")}, {},
             [(False, 2, 1), (True, 1, 1), (True, 1, 1)]),
    "carry_hidden": ({"threshold": 1e-12, "carry_hidden": True}, {},
                     [(False, 2, 1), (True, 2, 2), (True, 2, 2)]),
    "cold": ({"threshold": float("inf")}, {"warm": False},
             [(False, 2, 1), (False, 2, 1), (False, 2, 1)]),
}


@pytest.mark.parametrize("mode", list(RUNS))
def test_sequence_runner_matches_jax(tiny, mode):
    jspec, v, spec = tiny
    opts, run_opts, expected = RUNS[mode]
    frames = _frames(4)
    targets = [np.full((*SHAPE, 2), [2.0, 0.0], np.float32)] * 3
    jrun = jvideo.SequenceRunner(
        jspec.model, v, carry_hidden=opts.get("carry_hidden", False),
        ladder=jladder.LadderSpec((1, 2), threshold=opts["threshold"]))
    jres = jrun.run([jnp.asarray(f) for f in frames], targets=targets,
                    **run_opts)
    runner = video.SequenceRunner(
        spec.model, carry_hidden=opts.get("carry_hidden", False),
        ladder=serve.LadderSpec((1, 2), threshold=opts["threshold"]))
    assert runner.device == torch.device("cpu")
    res = runner.run(frames, targets=targets, **run_opts)
    got = [(f.warm, f.iterations, f.rungs) for f in res.frames]
    assert got == [(f.warm, f.iterations, f.rungs) for f in jres.frames] \
        == expected
    assert res.warm_frames() == jres.warm_frames()
    assert res.mean_iterations() == jres.mean_iterations()
    for f, jf in zip(res.frames, jres.frames):
        assert f.flow.shape == (*SHAPE, 2)
        assert _max_abs(f.flow, jf.flow) <= F32_MAX_ABS_PX
        assert abs(f.epe - jf.epe) <= F32_MAX_ABS_PX
        assert _max_abs(f.carry["flow"], jf.carry["flow"]) <= F32_MAX_ABS_PX
        assert f.seconds > 0
    assert res.frames_per_sec() > 0 and res.mean_epe() is not None
    with pytest.raises(ValueError, match="at least two frames"):
        runner.run(frames[:1])


def test_fw_bw_flows_splits_the_doubled_batch_as_jax():
    rng = np.random.default_rng(1)
    img1 = rng.random((2, 6, 8, 3), dtype=np.float32)
    img2 = rng.random((2, 6, 8, 3), dtype=np.float32)
    jfw, jbw = jvideo.fw_bw_flows(
        lambda variables, a, b: (np.asarray(a) - 2 * np.asarray(b))[..., :2],
        None, img1, img2)
    fw, bw = video.fw_bw_flows(
        lambda a, b: ((a - 2 * b)[..., :2], None),
        torch.from_numpy(img1), torch.from_numpy(img2))
    assert np.array_equal(fw.numpy(), np.asarray(jfw))
    assert np.array_equal(bw.numpy(), np.asarray(jbw))


# -- serving: the scheduler on stand-in sessions ------------------------------------


class _PlainSession:
    """A non-video stand-in (JAX's tests/test_video.py _PlainFakeSession)."""

    def __init__(self, buckets, batch_size=4):
        self.buckets = buckets
        self.batch_size = batch_size

    def encode_image(self, img):
        return np.asarray(img, np.float32)

    def compiles(self):
        return 0

    def run(self, img1, img2):
        return (img1 + img2)[..., :2]

    def fetch(self, flow):
        return np.asarray(flow)


class _VideoSession(_PlainSession):
    """A host-only video session (JAX's FakeVideoSession): a deterministic
    flow and a 2x-coarse carry; it records every carry it is handed."""

    video = True

    def __init__(self, buckets, batch_size=1):
        super().__init__(buckets, batch_size)
        self.carries = []

    def run_video(self, img1, img2, carry=None):
        self.carries.append(None if carry is None else np.array(carry))
        b, h, w = img1.shape[:3]
        flow = (img1 - img2)[..., :2]
        state = {"flow": np.full((b, h // 2, w // 2, 2), len(self.carries),
                                 np.float32),
                 "hidden": np.zeros((b, h // 2, w // 2, 4), np.float32),
                 "delta": np.zeros((b,), np.float32)}
        return flow, state, {"rungs": 1, "iterations": 4,
                             "warm": carry is not None}


def test_sequence_requests_need_a_video_session_as_jax():
    img = np.zeros((16, 24, 3), np.float32)
    errors = []
    for mod in (jscheduler, serve.scheduler):
        sched = mod.Scheduler(_PlainSession(ShapeBuckets([(16, 24)])),
                              batch_size=2)
        with pytest.raises(Exception) as e:
            sched.submit(img, img, sequence=True)
        errors.append(e.value)
    assert isinstance(errors[1], serve.ServeError)
    assert errors[1].kind == errors[0].kind == "no_video"
    assert str(errors[1]) == str(errors[0])


class _Req:
    def __init__(self, client):
        self.client = client


def test_carry_rows_match_jax_partly_warm_fill_and_resolution_switch():
    """``_gather_carry`` / ``_store_carry`` of both schedulers over one
    sequence of batches: a member without a carry gets a zero row, fill
    rows repeat the last row, no warm member gives None, and a bucket whose
    coarse shape differs from the stored carry's is a miss."""
    buckets = ShapeBuckets([(16, 24), (32, 48)])
    scheds = [mod.Scheduler(_VideoSession(buckets), batch_size=3)
              for mod in (jscheduler, serve.scheduler)]
    rng = np.random.default_rng(2)

    def state(b, bucket):
        return {"flow": rng.standard_normal(
            (b, bucket[0] // 8, bucket[1] // 8, 2)).astype(np.float32)}

    steps = [
        ("gather", ["a", "b"], (16, 24), 1), ("store", ["a"], (16, 24)),
        ("gather", ["a", "b"], (16, 24), 1), ("store", ["b", "c"], (16, 24)),
        ("gather", ["c", "x", "a"], (16, 24), 0),
        ("gather", ["a"], (32, 48), 2), ("gather", ["b", "c"], (16, 24), 1),
    ]
    for step in steps:
        if step[0] == "store":
            _, clients, bucket = step
            s = state(len(clients), bucket)
            for sched in scheds:
                sched._store_carry([_Req(c) for c in clients], bucket, s)
            continue
        _, clients, bucket, fill = step
        (jc, jrows), (tc, trows) = (
            sched._gather_carry([_Req(c) for c in clients], bucket, fill)
            for sched in scheds)
        assert [r is None for r in trows] == [r is None for r in jrows]
        if jc is None:
            assert tc is None
            continue
        assert tc.dtype == jc.dtype and np.array_equal(tc, jc)
        assert len(tc) == len(clients) + fill
        for i, row in enumerate(trows):
            if row is None:
                assert not tc[i].any()
        if fill:
            assert np.array_equal(tc[-1], tc[len(clients) - 1])
    jsched, tsched = scheds
    assert tsched._carry_factor == jsched._carry_factor == (8.0, 8.0)
    assert tsched.carry_shapes() == jsched.carry_shapes()
    assert tsched._carry_shape((32, 48)) == (4, 6, 2)
    # the resolution switch missed and dropped 'a'
    assert "a" not in tsched.sessions.clients()
    assert tsched.sessions.clients() == jsched.sessions.clients()


def test_video_dispatch_products_and_warm_split_as_jax():
    """``run_open_loop(sequence=True)`` on both packages' schedulers over
    the stand-in session: the same warm/cold split (each stream's first
    frame cold), every batch a video batch; then one ``products=True``
    frame: the reversed pair runs cold, the products are
    ``fw_bw_products`` of the two flows cropped to the request."""
    reports = []
    for mod, lg in ((jscheduler, jloadgen), (serve.scheduler, loadgen)):
        session = _VideoSession(ShapeBuckets([(16, 24)]))
        sched = mod.Scheduler(session, batch_size=1, max_wait_ms=2.0).start()
        try:
            reports.append(lg.run_open_loop(
                sched, [(16, 24)], requests=6, rate_hz=500.0, sequence=True,
                streams=2, seed=3))
        finally:
            sched.stop(drain=True)
    jrep, trep = reports
    assert trep["video"] == jrep["video"] == {"warm": 4, "cold": 2}
    assert trep["completed"] == 6 and not trep["errors"]
    assert [r.client for r in trep["results"]] == ["loadgen-0", "loadgen-1"] * 3
    assert all(b["video"] for b in sched.batch_log)
    assert sum(b["warm_members"] for b in sched.batch_log) == 4

    session = _VideoSession(ShapeBuckets([(16, 24)]), batch_size=2)
    sched = serve.Scheduler(session, max_wait_ms=2.0).start()
    rng = np.random.default_rng(4)
    img1, img2 = (rng.random((14, 20, 3), dtype=np.float32)
                  for _ in range(2))
    try:
        first = sched.submit(img1, img2, client="cam", sequence=True)
        first.result(timeout=30)
        result = sched.submit(img1, img2, client="cam", sequence=True,
                              products=True).result(timeout=30)
        with pytest.raises(serve.ServeError) as e:
            sched.submit(img1, img2, klass="fast")
        assert e.value.kind == "unknown_class"
    finally:
        sched.stop()
    assert result.warm and result.klass == "" and result.iterations == 4
    # warm forward pass, then the reversed pair cold
    assert session.carries[-1] is None and session.carries[-2] is not None
    # the fill row repeats the only member's carry
    assert np.array_equal(session.carries[-2][0], session.carries[-2][1])
    pad1, pad2 = (np.zeros((16, 24, 3), np.float32) for _ in range(2))
    pad1[:14, :20], pad2[:14, :20] = img1, img2
    fw, bw = (pad1 - pad2)[:14, :20, :2], (pad2 - pad1)[:14, :20, :2]
    occ, conf = video.fw_bw_products(fw, bw)
    assert np.array_equal(result.flow, fw)
    assert np.array_equal(result.occlusion, occ)
    assert np.array_equal(result.confidence, conf)
    assert sched.batch_log[-1]["products"] is True
    assert [b["warm_members"] for b in sched.batch_log] == [0, 1]


# -- a video ServeSession and main serve --video on the CPU -----------------------


def _serve_model():
    return TINY_VIDEO_MODEL | {"input": {
        "clip": [0, 1], "range": [-1, 1],
        "padding": {"type": "modulo", "mode": "zeros", "size": [8, 8]}}}


def test_video_session_runs_warm_and_cold(monkeypatch):
    monkeypatch.setenv("RMD_VIDEO_WARM_ITERATIONS", "2")
    session = serve.ServeSession(tmodels.load(_serve_model()), "32x48",
                                 batch_size=2, video=True, quant="u8",
                                 device="cpu")
    assert session.warm_iterations == 2 and session._warm_fn.quant == "u8"
    rng = np.random.default_rng(5)
    x1, x2 = (np.stack([session.encode_image(rng.random((32, 48, 3),
                                                        dtype=np.float32))
                        for _ in range(2)]) for _ in range(2))
    outcomes = session.warm_pool()
    cold, state, info = session.run_video(x1, x2)
    warm0, state0, info0 = session.run_video(
        x1, x2, np.zeros(state["flow"].shape, np.float32))
    warm1, _, _ = session.run_video(x1, x2, state["flow"].numpy())
    # JAX's test_serve_video_sticky_sessions_zero_compile's warm pool
    assert sorted(o["rung"] for o in outcomes if "rung" in o) == [
        "base:2", "warm:2"]
    assert [o.get("quant") for o in outcomes] == [None, "u8", "u8"]
    assert info == {"rungs": 1, "iterations": 2, "warm": False}
    assert info0["warm"] is True
    assert torch.equal(warm0, cold) and torch.equal(state0["hidden"],
                                                    state["hidden"])
    assert not torch.equal(warm1, cold)
    plain = serve.ServeSession(tmodels.load(_serve_model()), "32x48",
                               device="cpu")
    with pytest.raises(RuntimeError, match="video=True"):
        plain.run_video(x1, x2)
    ladder = serve.ServeSession(
        tmodels.load(_serve_model()), "32x48", batch_size=2, video=True,
        ladder=serve.LadderSpec((1, 2)), device="cpu")
    assert ladder.warm_iterations == 1
    rungs = [o.get("rung") for o in ladder.warm_pool()]
    assert rungs == [None, "base:1", "cont:+1", "full:2", "warm:1"]


def test_serve_command_with_video_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("RMD_VIDEO_WARM_ITERATIONS", "2")
    model = tmp_path / "model.json"
    model.write_text(json.dumps(_serve_model()))
    cfg = tmp_path / "serve.yaml"
    cfg.write_text(f"serve:\n  model: {model}\n  buckets: 32x48\n"
                   "  batch-size: 2\n  requests: 8\n  rate: 100\n"
                   "  wire-format: u8\n")
    report = port_main.main(["serve", "-c", str(cfg), "--device", "cpu",
                             "--video"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["completed"] == 8 and not report["errors"]
    assert "classes" not in printed
    video_split = printed["video"]
    assert video_split["warm"] + video_split["cold"] == 8
    assert video_split["warm"] > 0
    assert sum(b.get("warm_members", 0) for b in report["batch_log"]) \
        == video_split["warm"]
    assert all(b["video"] for b in report["batch_log"])
    # four sticky streams: one session each, their first frames cold
    assert report["video_sessions"]["active"] == 4
    assert {r.client for r in report["results"]} == {
        f"loadgen-{i}" for i in range(4)}
    assert [o.get("rung") for o in report["warmup"]] == [
        None, "base:2", "warm:2"]
    assert report["nonfinite"] == 0


# -- write_images with the fw/bw products ------------------------------------------


class _Writer:
    def __init__(self):
        self.tags = {}

    def add_image(self, tag, img, step, dataformats=None):
        self.tags[tag] = np.asarray(img)


def test_write_images_with_fwbw_products_matches_jax():
    """JAX's test_write_images_accepts_fwbw_products, on both packages:
    the same tags and the same images, products or not."""
    from raft_meets_dicl_tpu.data.collection import Metadata as JMetadata

    rng = np.random.default_rng(2)
    img = rng.random((1, 8, 10, 3), dtype=np.float32) * 2.0 - 1.0
    flow = rng.normal(size=(1, 8, 10, 2)).astype(np.float32)
    valid = np.ones((1, 8, 10), bool)
    occ = rng.random((1, 8, 10)) > 0.7
    conf = rng.random((1, 8, 10)).astype(np.float32)
    for products in ({}, {"occlusion": occ, "confidence": conf}):
        writers = []
        for mod, meta in ((jsummary, JMetadata), (tsummary, Metadata)):
            writer = _Writer()
            mod.write_images(writer, "p/", 0, img, img, flow, flow, valid,
                             [meta(True, "d", None, ((0, 8), (0, 10)))],
                             step=0, **products)
            writers.append(writer)
        jw, tw = writers
        assert sorted(tw.tags) == sorted(jw.tags)
        for tag in jw.tags:
            np.testing.assert_allclose(tw.tags[tag], jw.tags[tag],
                                       rtol=0, atol=1e-6, err_msg=tag)
    assert sorted(tw.tags) == ["p/flow-est", "p/flow-gt", "p/fwbw-confidence",
                               "p/fwbw-occlusion", "p/img1", "p/img2"]
    assert tw.tags["p/fwbw-occlusion"].shape == (8, 10, 4)
    assert tw.tags["p/fwbw-confidence"].shape == (8, 10, 4)
