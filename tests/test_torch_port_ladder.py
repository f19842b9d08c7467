"""PyTorch port: the iteration ladder held against the JAX package on the
CPU.

- ``LadderSpec`` parsing, validation, ``increments``, ``programs`` and
  ``describe`` against JAX's on the same inputs;
- the ``(flow, hidden)`` carry: chained rungs equal the monolithic rung
  bit for bit for raft, raft/fs, ctf-l2, ml and sl, and each model's base
  rung and a continuation fed JAX's carry match JAX's ``make_rung_fn``
  (final flow, carry flow, hidden, ``delta``);
- ``delta`` against its formula, a quantized base rung against JAX's;
- the int8 pyramid on 8 threads at once, as the quantized class runs it
  on the dispatch thread beside others;
- a ladder session through the scheduler (the three classes, the warm
  pool's rung records, typed ``unknown_class`` errors), ``main serve
  --ladder --quant`` on the CPU, and raft/cl's ``flow_init``.

The JAX variables are drawn over ``jax.eval_shape`` of the init (no init
program compiled), each JAX rung compiles once, and the port runs on one
thread. Bounds are those of each model's forward test: raft and raft/fs
F32_MAX_ABS_PX (absolute), ctf, ml and sl F32_REL (relative to a flow's
largest |value|, at least 1 px). The hidden state (|h| < 1) and ``delta``
(a root mean square of flow changes) are held to the same bound as the
flows.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu import evaluation as jevaluation
from raft_meets_dicl_tpu.serve import ladder as jladder
from raft_meets_dicl_tpu_torch import evaluation, serve
from raft_meets_dicl_tpu_torch import main as port_main
from raft_meets_dicl_tpu_torch.ops import quant as tquant
from raft_meets_dicl_tpu_torch.serve import ladder as tladder
from raft_meets_dicl_tpu_torch.serve import loadgen
from test_torch_port_ctf import F32_REL
from test_torch_port_dicl_models import _port, _variables
from test_torch_port_quant import QUANT_REL
from test_torch_port_raft import F32_MAX_ABS_PX
from test_torch_port_train import _one_thread
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# JAX's tests/test_ladder.py model, copied
TINY_LADDER_MODEL = {
    "name": "ladder tiny", "id": "ladder-tiny",
    "model": {"type": "raft/baseline",
              "parameters": {"corr-levels": 2, "corr-radius": 2,
                             "corr-channels": 32, "context-channels": 16,
                             "recurrent-channels": 16}},
    "loss": {"type": "raft/sequence"},
    "input": {"padding": {"type": "modulo", "mode": "zeros",
                          "size": [8, 8]}},
}

_NARROW = {"corr-channels": 8, "context-channels": 16,
           "recurrent-channels": 16}


def _cfg(ty, params):
    return {"name": ty, "id": ty,
            "model": {"type": ty, "parameters": params},
            "loss": {"type": "raft/sequence"}, "input": None}


# model -> (config, image shape, base rung, continuation, its bound rule):
# "abs" holds |diff| <= F32_MAX_ABS_PX, "rel" |diff| <= F32_REL of the
# largest |value| (at least 1)
MODELS = {
    "raft": (TINY_LADDER_MODEL, (2, 32, 48), 2, 2, "abs"),
    "raft/fs": (_cfg("raft/fs", TINY_LADDER_MODEL["model"]["parameters"]),
                (1, 64, 96), 2, 2, "abs"),
    "ctf-l2": (_cfg("raft+dicl/ctf-l2", {
        "corr-radius": 4, "corr-channels": 8, "context-channels": 8,
        "recurrent-channels": 8, "corr-args": {"mnet_scale": 0.125}}),
        (1, 64, 64), 2, 1, "rel"),
    "ml": (_cfg("raft+dicl/ml", _NARROW), (1, 64, 64), 1, 1, "rel"),
    "sl": (_cfg("raft+dicl/sl", _NARROW | {
        "corr-args": {"mnet_scale": 0.25}}), (1, 64, 64), 2, 1, "rel"),
}


def _images(shape, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (*shape, 3)).astype(np.float32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def ported():
    """model -> (its JAX variables, the port's spec with them, images)."""
    out = {}

    def get(name):
        if name not in out:
            cfg, shape = MODELS[name][:2]
            images = _images(shape)
            variables = _variables(cfg, images)
            out[name] = variables, _port(cfg, variables), images
        return out[name]
    return get


def _t(x):
    return torch.from_numpy(np.array(x))


# -- LadderSpec ---------------------------------------------------------------


SPECS = [("2, 4,6", None), ([2, 5], None), ("2,4", 0.25), ((4, 8, 12), None),
         ("2,4,8", 0.5), (True, None)]


@pytest.mark.parametrize("spec,threshold", SPECS)
def test_ladder_spec_matches_jax(spec, threshold, monkeypatch):
    if spec is True:
        monkeypatch.setenv("RMD_LADDER", "3,9")
        monkeypatch.setenv("RMD_LADDER_THRESHOLD", "0.5")
    j = jladder.LadderSpec.from_config(spec, threshold=threshold)
    t = tladder.LadderSpec.from_config(spec, threshold=threshold)
    assert (t.rungs, t.threshold) == (j.rungs, j.threshold)
    assert t.increments() == j.increments()
    assert t.programs() == j.programs()
    assert t.describe() == j.describe()
    assert tladder.CLASSES == jladder.CLASSES == serve.CLASSES


def test_ladder_spec_defaults_match_jax(monkeypatch):
    monkeypatch.delenv("RMD_LADDER", raising=False)
    monkeypatch.delenv("RMD_LADDER_THRESHOLD", raising=False)
    j, t = jladder.LadderSpec.from_config(), tladder.LadderSpec.from_config()
    assert (t.rungs, t.threshold) == (j.rungs, j.threshold) == ((4, 8, 12),
                                                                0.1)


@pytest.mark.parametrize("kwargs", [
    {"rungs": (12,)}, {"rungs": (0, 4)}, {"rungs": (4, 4, 8)},
    {"rungs": (8, 4)}, {"rungs": (4, 8), "threshold": 0.0}])
def test_ladder_spec_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError) as j:
        jladder.LadderSpec(**kwargs)
    with pytest.raises(ValueError) as t:
        tladder.LadderSpec(**kwargs)
    assert str(t.value) == str(j.value)


# -- the carry ----------------------------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_chained_rungs_equal_the_monolithic_rung(name, ported):
    """base + 2 continuations against one rung of the summed budget, bit
    for bit (a ctf continuation runs its finest level only)."""
    _, spec, images = ported(name)
    base_its, inc = MODELS[name][2:4]
    img1, img2 = (torch.from_numpy(x) for x in images)
    base = evaluation.make_rung_fn(spec.model, base_its)
    cont = evaluation.make_rung_fn(spec.model, inc, cont=True)
    full = evaluation.make_rung_fn(spec.model, base_its + 2 * inc)
    assert (cont.iterations, cont.cont, cont.quant) == (inc, True, None)
    with _one_thread():
        flow, state = base(img1, img2)
        for _ in range(2):
            flow, state = cont(img1, img2, state["flow"], state["hidden"])
        flow_full, state_full = full(img1, img2)
    assert torch.equal(flow, flow_full)
    assert torch.equal(state["flow"], state_full["flow"])
    assert torch.equal(state["hidden"], state_full["hidden"])
    assert torch.equal(state["delta"], state_full["delta"])
    b, h, w = MODELS[name][1]
    assert tuple(flow.shape) == (b, h, w, 2)
    assert tuple(state["flow"].shape) == (b, h // 8, w // 8, 2)
    assert state["hidden"].shape[:3] == state["flow"].shape[:3]


def _diff(actual, expected, rule):
    e = np.asarray(expected)
    d = float(np.abs(actual.numpy() - e).max())
    return d if rule == "abs" else d / max(float(np.abs(e).max()), 1.0)


@pytest.mark.parametrize("name", list(MODELS))
def test_rungs_match_jax_make_rung_fn(name, ported):
    """The port's base rung against JAX's, and its continuation fed JAX's
    carry against JAX's continuation."""
    variables, spec, images = ported(name)
    cfg, _, base_its, inc, rule = MODELS[name]
    bound = F32_MAX_ABS_PX if rule == "abs" else F32_REL
    jspec = jmodels.load(cfg)
    v = jax.tree.map(jnp.asarray, variables)
    x1, x2 = (jnp.asarray(x) for x in images)
    jbase = jevaluation.make_rung_fn(jspec.model, base_its)
    jcont = jevaluation.make_rung_fn(jspec.model, inc, cont=True)
    jflow, jstate = jbase(v, x1, x2)
    jflow2, jstate2 = jcont(v, x1, x2, jstate["flow"], jstate["hidden"])

    img1, img2 = (torch.from_numpy(x) for x in images)
    base = evaluation.make_rung_fn(spec.model, base_its)
    cont = evaluation.make_rung_fn(spec.model, inc, cont=True)
    with _one_thread():
        flow, state = base(img1, img2)
        flow2, state2 = cont(img1, img2, _t(jstate["flow"]),
                             _t(jstate["hidden"]))
    for (a, e) in ((flow, jflow), (flow2, jflow2)):
        assert _diff(a, e, rule) <= bound
    for s, js in ((state, jstate), (state2, jstate2)):
        for key in ("flow", "hidden", "delta"):
            assert tuple(s[key].shape) == js[key].shape, key
            assert _diff(s[key], js[key], rule) <= bound, key


def _rms(diff):
    return np.sqrt(np.mean(np.sum(diff.astype(np.float64) ** 2, axis=-1),
                           axis=(1, 2)))


@pytest.mark.parametrize("case", ["two iterations", "one from flow_init",
                                  "one from zero"])
def test_delta_is_the_rms_of_the_last_flow_change(case, ported):
    _, spec, images = ported("raft")
    img1, img2 = (torch.from_numpy(x) for x in images)
    with _one_thread():
        _, one = evaluation.make_rung_fn(spec.model, 1)(img1, img2)
        if case == "two iterations":
            _, state = evaluation.make_rung_fn(spec.model, 2)(img1, img2)
            prev = one["flow"].numpy()
        elif case == "one from flow_init":
            _, state = evaluation.make_rung_fn(spec.model, 1, cont=True)(
                img1, img2, one["flow"], one["hidden"])
            prev = one["flow"].numpy()
        else:
            state, prev = one, np.zeros(one["flow"].shape, np.float32)
    expected = _rms(state["flow"].numpy() - prev)
    assert state["delta"].dtype == torch.float32
    np.testing.assert_allclose(state["delta"].numpy(), expected, rtol=1e-6)


def test_quant_base_rung_matches_jax(ported):
    """u8 base rung against JAX's, within test_torch_port_quant.py's
    QUANT_REL of the largest |flow|; the quantized rung differs from the
    plain one."""
    variables, spec, images = ported("raft")
    jspec = jmodels.load(TINY_LADDER_MODEL)
    v = jax.tree.map(jnp.asarray, variables)
    jflow, jstate = jevaluation.make_rung_fn(jspec.model, 2, quant="u8")(
        v, *(jnp.asarray(x) for x in images))
    step = evaluation.make_rung_fn(spec.model, 2, quant="u8")
    assert step.quant == "u8"
    img1, img2 = (torch.from_numpy(x) for x in images)
    with _one_thread():
        flow, state = step(img1, img2)
        plain, _ = evaluation.make_rung_fn(spec.model, 2)(img1, img2)
    scale = float(np.abs(np.asarray(jflow)).max())
    assert float((flow - _t(jflow)).abs().max()) <= QUANT_REL * scale
    assert float((state["flow"] - _t(jstate["flow"])).abs().max()) \
        <= QUANT_REL * scale
    assert not torch.equal(flow, plain)


def test_quant_rung_of_a_model_without_the_tier_refuses_by_name(ported):
    _, spec, _ = ported("sl")
    with pytest.raises(ValueError, match="raft\\+dicl/sl.*quantized"):
        evaluation.make_rung_fn(spec.model, 2, quant="u8")


def test_rung_strips_reserved_model_args(ported):
    _, spec, images = ported("raft")
    img1, img2 = (torch.from_numpy(x) for x in images)
    reserved = {"iterations": 7, "return_state": False, "quant": "i8",
                "quant_clip": 0.5, "flow_init": None, "hidden_init": None}
    with _one_thread():
        a = evaluation.make_rung_fn(spec.model, 2, model_args=reserved)
        b = evaluation.make_rung_fn(spec.model, 2)
        assert a.quant is None
        assert torch.equal(a(img1, img2)[0], b(img1, img2)[0])


def test_ctf_flow_init_without_hidden_init_raises_as_jax(ported):
    variables, spec, images = ported("ctf-l2")
    jspec = jmodels.load(MODELS["ctf-l2"][0])
    x = jnp.asarray(images[0])
    with pytest.raises(ValueError) as j:
        jspec.model.apply(jax.tree.map(jnp.asarray, variables), x, x,
                          flow_init=jnp.zeros((1, 8, 8, 2)))
    img = torch.from_numpy(images[0])
    with pytest.raises(ValueError) as t:
        spec.model.apply(img, img, flow_init=torch.zeros(1, 8, 8, 2))
    assert str(t.value) == str(j.value)


def test_raft_cl_flow_init_matches_jax():
    """raft/cl's coordinates seeded from ``flow_init`` (one iteration at
    1x128x128, the GA-Net's smallest side); it takes neither
    ``hidden_init`` nor ``return_state``, in either package."""
    cfg = _cfg("raft/cl", {"corr-radius": 3})
    cfg["model"]["arguments"] = {"iterations": 1}
    images = _images((1, 128, 128))
    variables = _variables(cfg, images)
    spec = _port(cfg, variables)
    flow_init = 2.0 * np.random.default_rng(4).standard_normal(
        (1, 16, 16, 2)).astype(np.float32)
    jspec = jmodels.load(cfg)
    v = jax.tree.map(jnp.asarray, variables)
    x1, x2 = (jnp.asarray(x) for x in images)
    expected = jax.jit(lambda v: jspec.model.apply(
        v, x1, x2, flow_init=jnp.asarray(flow_init))["flow"])(v)
    with _one_thread(), torch.no_grad():
        actual = spec.model.apply(
            *(torch.from_numpy(x) for x in images),
            flow_init=torch.from_numpy(flow_init))["flow"]
        plain = spec.model.apply(
            *(torch.from_numpy(x) for x in images))["flow"]
    rel = _diff(actual[-1], expected[-1], "rel")
    assert rel <= F32_REL
    assert not torch.equal(actual[-1], plain[-1])
    img = torch.from_numpy(images[0])
    for arg in ("hidden_init", "return_state"):
        with pytest.raises(TypeError, match=f"unexpected keyword.*'{arg}'"):
            spec.model.apply(img, img, **{arg: True})


def test_int8_pyramid_is_thread_safe_and_leaves_tf32_alone():
    """8 threads build ``correlation_pyramid_int8`` at once: each equals the
    serial run bit for bit, and the process's TF32 switch reads as it was
    set (the int8 dot is an integer GEMM and touches no global state)."""
    rng = np.random.default_rng(8)
    pairs = [tuple(torch.from_numpy(rng.standard_normal((1, 6, 8, 64))
                                    .astype(np.float32)) for _ in range(2))
             for _ in range(8)]

    def run(pair):
        return tquant.correlation_pyramid_int8(*pair, 3)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with _one_thread():
            serial = [run(p) for p in pairs]
            with ThreadPoolExecutor(8) as pool:
                for _ in range(4):
                    concurrent = list(pool.map(run, pairs))
                    assert torch.backends.cuda.matmul.allow_tf32
                    for s, c in zip(serial, concurrent):
                        for a, b in zip(s, c):
                            assert torch.equal(a.values, b.values)
                            assert torch.equal(a.scale, b.scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# -- serving ------------------------------------------------------------------


def _session(threshold=0.1, quant="u8", **kwargs):
    ladder = serve.LadderSpec((2, 4, 6), threshold=threshold)
    return serve.ServeSession(tmodels.load(TINY_LADDER_MODEL), "32x48",
                              batch_size=2, ladder=ladder, quant=quant,
                              device="cpu", **kwargs)


@pytest.mark.parametrize("threshold,balanced", [(1e9, 2), (1e-9, 6)])
def test_ladder_session_serves_the_three_classes(threshold, balanced):
    session = _session(threshold)
    with _one_thread():
        warm = session.warm_pool()
        assert [(o["bucket"], o.get("rung"), o.get("quant")) for o in warm] \
            == [("32x48", None, None), ("32x48", "base:2", "u8"),
                ("32x48", "cont:+2", None), ("32x48", "full:6", None)]
        scheduler = serve.Scheduler(session, max_wait_ms=1).start()
        try:
            report = loadgen.run_open_loop(
                scheduler, [(32, 48), (24, 40)], requests=6, rate_hz=200,
                classes=list(serve.CLASSES), seed=2)
        finally:
            scheduler.stop()
    assert report["completed"] == 6 and not report["errors"]
    its = {r.klass: r.iterations for r in report["results"]}
    assert its == {"fast": 2, "balanced": balanced, "quality": 6}
    classes = report["classes"]
    assert sorted(classes) == ["balanced", "fast", "quality"]
    assert classes["fast"]["iterations"] == {2: 2}
    assert classes["quality"]["iterations"] == {6: 2}
    for r in report["results"]:
        assert r.flow.shape == (*r.shape, 2) and np.isfinite(r.flow).all()


def test_fast_class_is_the_quantized_base_rung():
    """The fast class's flow is the quantized 2-iteration rung of the
    padded pair; quality's the plain 6-iteration one."""
    session = _session()
    pair = _images((1, 32, 48))
    x1, x2 = (session.encode_image(x[0])[None] for x in pair)
    with _one_thread():
        fast, info = session.run_ladder(x1, x2, "fast")
        quality, _ = session.run_ladder(x1, x2, "quality")
        rung = evaluation.make_rung_fn(session.model, 2, quant="u8")
        full = evaluation.make_rung_fn(session.model, 6)
        t1, t2 = (torch.from_numpy(x) for x in (x1, x2))
        assert torch.equal(fast, rung(t1, t2)[0])
        assert torch.equal(quality, full(t1, t2)[0])
    assert info == {"rungs": 1, "iterations": 2}


def test_unknown_classes_fail_typed():
    img = np.zeros((32, 48, 3), np.float32)
    scheduler = serve.Scheduler(_session())
    with pytest.raises(serve.ServeError) as e:
        scheduler.submit(img, img, klass="turbo")
    assert e.value.kind == "unknown_class" and "fast/balanced/quality" in \
        str(e.value)
    plain = serve.ServeSession(tmodels.load(TINY_LADDER_MODEL), "32x48",
                               batch_size=2, device="cpu")
    with pytest.raises(serve.ServeError) as e:
        serve.Scheduler(plain).submit(img, img, klass="fast")
    assert e.value.kind == "unknown_class" and "serve --ladder" in \
        str(e.value)


@pytest.mark.parametrize("option,message", [
    # video is ported: a ladder session builds its warm-start step at the
    # bottom rung, on the fast class's quantized tier
    pytest.param({"video": True}, None, id="option0-slice 7 item 2"),
    ({"mesh": "-1"}, "slice 7 item 6")])
def test_ladder_session_refuses_video_and_mesh(option, message):
    if message is None:
        session = _session(**option)
        assert session.warm_iterations == 2
        assert session._warm_fn.quant == "u8"
        return
    with pytest.raises(NotImplementedError, match=message):
        _session(**option)


def test_serve_command_with_a_ladder_on_cpu(tmp_path, capsys):
    model = tmp_path / "model.json"
    model.write_text(json.dumps(TINY_LADDER_MODEL
                                | {"input": {"clip": [0, 1],
                                             "range": [-1, 1],
                                             "padding": {"type": "modulo",
                                                         "mode": "zeros",
                                                         "size": [8, 8]}}}))
    cfg = tmp_path / "serve.yaml"
    cfg.write_text(f"serve:\n  model: {model}\n  buckets: 32x48\n"
                   "  batch-size: 2\n  requests: 6\n  rate: 100\n"
                   "  wire-format: u8\n")
    with _one_thread():
        report = port_main.main(["serve", "-c", str(cfg), "--device", "cpu",
                                 "--ladder", "2,4", "--quant"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["completed"] == 6 and not report["errors"]
    assert report["ladder"] == "rungs 2,4 threshold 0.1"
    assert report["quant"] == "u8"
    assert sorted(printed["classes"]) == ["balanced", "fast", "quality"]
    assert printed["classes"]["fast"]["iterations"] == {"2": 2}
    assert printed["classes"]["quality"]["iterations"] == {"4": 2}
    assert [o.get("rung") for o in report["warmup"]] == [
        None, "base:2", "cont:+2", "full:4"]
