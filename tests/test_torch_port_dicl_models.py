"""PyTorch port: ``raft+dicl/ml``, ``raft+dicl/sl`` and ``dicl/baseline``
(with ``dicl/64to8`` and the ``dicl/multiscale`` loss) held against the JAX
package on the CPU, from the same seeded numpy batch and JAX variables
bridged with ``convert`` (drawn over the JAX tree's shapes, batch
statistics away from their (0, 1) init).

- each model's forward in eval, every output (the readouts with
  ``corr_flow``; ``raw`` for the DICL ladder, at dicl/64to8's levels),
  sl for every ``corr-type`` and with the ``dicl`` and ``rfpm-raft``
  encoders;
- one train step with live batch norm for ml, sl (``dicl``) and
  ``dicl/baseline`` (as the shipped s0-chairs stage runs it), each run
  once in both packages (``step_runs``): its train-mode forward's outputs
  and running statistics, its loss and gradients;
- the ``dicl/multiscale`` loss (``valid_range``, the robust norm) and
  ``DiclResult.final``;
- the weight bridge's coverage: a strict ``load_state_dict`` for ml and
  sl variants (encoder types, ``share-dicl``, ``dap-type``, corr types,
  readouts), ctf with the other encoder families and cmods, and both DICL
  ladders; ``dicl/baseline``'s names through ``scripts/chkpt_convert.py``'s
  DICL-Flow rules and back;
- the shipped model configs in both packages, and the ladder carry's
  round trips (``test_ladder_arguments_refuse_by_name``, named for what it
  checked before the carry was ported).

Bounds are ``test_torch_port_ctf.py``'s: F32_REL for flows (relative to
each flow's largest |value|), STATS_ATOL for running statistics,
GRAD_REL_L2 per gradient tensor, LOSS_REL; under live batch norm each is
NOISE_FACTOR times the JAX package's own spread when img1 moves by one
float32 ulp where that is larger, never above CAP_FACTOR times the base
or MAX_BOUND (``_widened``: a spread above that fails the test); a
live-BN forward's outputs take LIVE_F32_REL. The port's forwards run on
one thread, its train steps on two.
The models are cut to corr-channels 8, context and recurrent 16, a few
iterations, on 64-128 px images (the DICL ladder's step at batch 4, so
that batch norm over its 1/64 maps sees 16 values a channel).
"""

import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu.models.common import encoders as jencoders
from raft_meets_dicl_tpu.models.impls import dicl as jdicl
from raft_meets_dicl_tpu_torch import convert
from raft_meets_dicl_tpu_torch.models.impls import dicl as tdicl
from test_torch_port_ctf import (
    F32_REL, GRAD_REL_L2, GRAD_REL_L2_FINE, LOSS_REL, STATS_ATOL, ZERO_GRAD)
from test_torch_port_dicl_family import _draw
from test_torch_port_train import _one_thread
from test_torch_port_train import port_on_one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))
import chkpt_convert  # noqa: E402

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
NARROW = {"corr-channels": 8, "context-channels": 16,
          "recurrent-channels": 16}
SEQ_LOSS = {"type": "raft/sequence", "arguments": {"gamma": 0.85}}
DICL_LOSS = {"type": "dicl/multiscale",
             "arguments": {"weights": [1.0, 0.8, 0.75, 0.6, 0.5, 0.4, 0.5,
                                       0.4, 0.5, 0.4]}}
# a live-BN comparison's bound over the JAX package's own spread for a
# one-ulp change of img1 (``_nudged``), and how far such a bound may rise
# above its base: at most CAP_FACTOR times it and never above MAX_BOUND
NOISE_FACTOR = 4
CAP_FACTOR = 10
MAX_BOUND = 0.1
# a live-BN forward's outputs, relative as F32_REL: batch statistics over
# the DICL ladder's 2x2 maps amplify float32 rounding. There the JAX f32
# run is itself up to 2.3e-5 off its run in float64 up to the cost, the
# port's 3.7e-5, the two f32 runs 4.5e-5 apart, where a one-ulp change of
# img1 moves JAX's only 7e-6
LIVE_F32_REL = 1e-4

# the cost path and the encoders, held to GRAD_REL_L2_FINE as the ctf
# lockstep's finest level and stems are: the JAX f32 run is itself 5e-3
# to 9e-3 off a float64 run there
COST_PATH = ("corr.", "matching", "fnet.", "cnet.", "stack.", "pyramid.",
             "feature.")

# the DICL ladder at small displacement ranges, two of them not square
DISP = {"level-6": [2, 1], "level-5": [1, 1], "level-4": [1, 1],
        "level-3": [1, 1], "level-2": [1, 2]}


def _cfg(ty, params, args, loss=SEQ_LOSS):
    return {"name": ty, "id": ty,
            "model": {"type": ty, "parameters": params, "arguments": args},
            "loss": loss, "input": None}


def sl_cfg(corr_type="dicl", **params):
    corr_args = ({"mnet_scale": 0.25} if corr_type in ("dicl", "dicl-1x1")
                 else {"embedding_dim": 8} if corr_type == "dicl-emb" else {})
    return _cfg("raft+dicl/sl", NARROW | {"corr-type": corr_type,
                                          "corr-args": corr_args} | params,
                {"iterations": 3})


def ml_cfg(**params):
    return _cfg("raft+dicl/ml", NARROW | params, {"iterations": 2})


def dicl_cfg(ty="dicl/baseline", **params):
    disp = DISP if ty == "dicl/baseline" else {
        k: v for k, v in DISP.items() if k != "level-2"}
    return _cfg(ty, {"feature-channels": 8, "displacement-range": disp}
                | params, {"raw": True}, DICL_LOSS)


def _batch(h, w, seed=0, n=2):
    rs = np.random.RandomState(seed)
    img1, img2 = (rs.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
                  for _ in range(2))
    flow = (4 * rs.randn(n, h, w, 2)).astype(np.float32)
    valid = rs.rand(n, h, w) > 0.2
    return img1, img2, flow, valid


def _variables(cfg, batch, seed=1):
    """The JAX model's variables over its init's shapes, drawn from
    ``seed`` (``_draw``)."""
    model = jmodels.load(cfg).model
    x1, x2 = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    shapes = jax.eval_shape(lambda k: model.init(k, x1, x2),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: _draw(path, leaf, rs), shapes)


def _port(cfg, variables):
    spec = tmodels.load(cfg)
    spec.model.init(device="cpu")
    convert.load_jax_variables(spec.model.module, variables)
    return spec


def _max_rel(actual, expected):
    """Walk two output trees in step; the largest |diff| of a flow over
    that flow's largest |value| (at least 1 px)."""
    if isinstance(expected, (list, tuple)):
        assert isinstance(actual, (list, tuple))
        assert len(actual) == len(expected)
        return max(_max_rel(a, e) for a, e in zip(actual, expected))
    assert tuple(actual.shape) == expected.shape
    assert actual.dtype == torch.float32
    e = np.asarray(expected)
    return float(np.abs(actual.detach().numpy() - e).max()
                 / max(np.abs(e).max(), 1.0))


def _nudged(img):
    """``img`` one float32 ulp larger (relative 2^-23) everywhere: the
    JAX package's own spread under such a change is the noise floor of a
    live-BN comparison."""
    return (img * np.float32(1 + 2**-23)).astype(np.float32)


def _widened(base, spread):
    """A live-BN bound: ``base``, or NOISE_FACTOR times the JAX package's
    own ``spread`` where that is larger. The spread must stay within
    CAP_FACTOR times ``base`` and MAX_BOUND: a case where JAX itself moves
    further for a one-ulp change is too ill-conditioned to compare, and
    fails here rather than pass on a bound that holds nothing."""
    bound = NOISE_FACTOR * spread
    assert bound <= min(CAP_FACTOR * base, MAX_BOUND), (spread, base)
    return max(base, bound)


def _jax_forward(cfg, variables, batch):
    """The JAX model's eval output."""
    model = jmodels.load(cfg).model
    v = jax.tree.map(jnp.asarray, variables)
    x1, x2 = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    return jax.jit(lambda v: model.apply(v, x1, x2))(v)


def _port_forward(cfg, variables, batch):
    spec = _port(cfg, variables)
    with _one_thread(), torch.no_grad():
        return spec.model.apply(torch.from_numpy(batch[0]),
                                torch.from_numpy(batch[1]))


def _as_torch(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(x) for x in tree)
    return torch.from_numpy(np.array(tree))


@contextlib.contextmanager
def _two_threads():
    """The train steps' port side on two torch threads: one thread's
    float32 sums cancel worse (sl's context stem reads 2e-2 relative L2
    from JAX's there, 1.5e-3 at most anywhere on two), and the default
    threads beside the suite's other workers oversubscribe the cores (the
    ml step took 230 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# -- forwards in eval ------------------------------------------------------------

FORWARDS = {
    "ml": (ml_cfg(**{"corr-reg-type": "softargmax+dap"}), (64, 64),
           {"corr_flow": True}),
    "ml-avgpool-full": (ml_cfg(**{"encoder-type": "raft-avgpool",
                                  "dap-type": "full", "share-dicl": True}),
                        (64, 64), {}),
    "sl-dicl": (sl_cfg("dicl", **{"corr-reg-type": "softargmax+dap"}),
                (64, 96), {"corr_flow": True}),
    "sl-dicl-1x1": (sl_cfg("dicl-1x1"), (64, 96), {}),
    "sl-dicl-emb": (sl_cfg("dicl-emb", **{"corr-reg-type": "softargmax+dap"}),
                    (64, 96), {"corr_flow": True}),
    "sl-dot": (sl_cfg("dot"), (64, 96), {"corr_flow": True}),
    "dicl-64to8": (dicl_cfg("dicl/64to8"), (128, 128), {}),
}


# -- one live-BN train step ------------------------------------------------------------

# (config, image size, batch, the stage's model and loss arguments); the
# DICL ladder as the shipped dicl/s0-chairs stage trains it: no DAP, no
# context nets, valid ranges
STEPS = {
    "ml": (ml_cfg(**{"corr-levels": 2}), (64, 64), 2, {}, {}),
    "sl": (sl_cfg("dicl"), (64, 96), 2, {}, {}),
    "dicl": (dicl_cfg(), (128, 128), 4,
             {"raw": False, "dap": False, "ctx": False},
             {"weights": [1.0, 0.75, 0.5, 0.25, 0.25],
              "valid_range": [[12, 12], [10, 10], [8, 8], [6, 6], [4, 4]]}),
}


def _jax_step(cfg, variables, batch, model_args, loss_args):
    """Output, loss, gradients and batch statistics of one JAX live-BN
    step, for ``batch`` and for img1 nudged by one ulp (one compile)."""
    spec = jmodels.load(cfg)
    model = spec.model
    model.on_stage(None, freeze_batchnorm=False)
    adapter = model.get_adapter()
    x2, flow, valid = (jnp.asarray(x) for x in batch[1:])

    def loss_fn(params, x1):
        out, stats = model.apply({"params": params,
                                  "batch_stats": variables["batch_stats"]},
                                 x1, x2, train=True, **model_args)
        result = adapter.wrap_result(out, x1.shape[1:3])
        return spec.loss(model, result.output(), flow, valid,
                         **loss_args), (out, stats)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params = jax.tree.map(jnp.asarray, variables["params"])
    runs = []
    for img in (batch[0], _nudged(batch[0])):
        (loss, (out, stats)), grads = fn(params, jnp.asarray(img))
        runs.append({"out": out, "loss": float(loss),
                     "grads": jax.tree.map(np.asarray, grads),
                     "stats": jax.tree.map(np.asarray, stats)})
    return runs


def _port_step(cfg, variables, batch, model_args, loss_args):
    """The port's output, loss, gradients (by name) and module after one
    live-BN step on two threads."""
    spec = _port(cfg, variables)
    spec.model.on_stage(None, freeze_batchnorm=False)
    module = spec.model.module
    adapter = spec.model.get_adapter()
    img1, img2, flow, valid = (torch.from_numpy(x) for x in batch)
    with _two_threads(), torch.backends.mkldnn.flags(enabled=False):
        out = spec.model.apply(img1, img2, train=True, **model_args)
        result = adapter.wrap_result(out, tuple(img1.shape[1:3]))
        loss = spec.loss(spec.model, result.output(), flow, valid,
                         **loss_args)
        loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .numpy() for n, p in module.named_parameters()}
    return {"out": _detached(out), "loss": float(loss), "grads": grads,
            "module": module}


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(x) for x in tree)
    return tree.detach()


@pytest.fixture(scope="module")
def step_runs():
    """``name`` -> (JAX's run, JAX's run with img1 nudged, the port's run)
    of STEPS[name], each computed once for the module's tests."""
    runs = {}

    def get(name):
        if name not in runs:
            cfg, (h, w), n, model_args, loss_args = STEPS[name]
            batch = _batch(h, w, seed=3, n=n)
            variables = _variables(cfg, batch, seed=4)
            runs[name] = (*_jax_step(cfg, variables, batch, model_args,
                                     loss_args),
                          _port_step(cfg, variables, batch, model_args,
                                     loss_args))
        return runs[name]
    return get


def _check_stats(module, stats, nudged):
    """The running statistics within STATS_ATOL of JAX's, widened by
    JAX's own spread against ``nudged``'s (``_widened``)."""
    rules = convert.rules_for(module)
    expected, spread = (convert.jax_variables_to_state_dict(
        {"batch_stats": s}, rules) for s in (stats, nudged))
    actual = module.state_dict()
    for key, e in expected.items():
        if "running" in key:
            bound = _widened(STATS_ATOL,
                             float((spread[key] - e).abs().max()))
            np.testing.assert_allclose(actual[key].numpy(), e.numpy(), rtol=0,
                                       atol=bound, err_msg=key)


@pytest.mark.parametrize("name,train",
                         [(n, False) for n in FORWARDS]
                         + [(n, True) for n in STEPS])
def test_forward_matches_jax(name, train, step_runs):
    """Every output within F32_REL of JAX's in eval, for each FORWARDS
    model; in live-BN train mode the train step's forward within
    LIVE_F32_REL, with the running statistics after it (STATS_ATOL,
    ``_widened``)."""
    if train:
        jrun, nrun, prun = step_runs(name)
        expected, actual = jrun["out"], prun["out"]
        bound = LIVE_F32_REL
        _check_stats(prun["module"], jrun["stats"], nrun["stats"])
        moved = [k for k, v in prun["module"].state_dict().items()
                 if k.endswith("running_mean") and v.abs().max() > 0
                 and k.startswith(("corr", "matching"))]
        assert moved
    else:
        cfg, (h, w), args = FORWARDS[name]
        cfg = {**cfg, "model": {**cfg["model"], "arguments": {
            **cfg["model"]["arguments"], **args}}}
        batch = _batch(h, w)
        variables = _variables(cfg, batch)
        expected = _jax_forward(cfg, variables, batch)
        actual = _port_forward(cfg, variables, batch)
        bound = F32_REL
    assert _max_rel(actual, expected) <= bound


def _rel(a, e):
    return float(np.linalg.norm(a - e) / np.linalg.norm(e))


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_matches_jax(name, step_runs):
    """The loss and every gradient tensor (relative L2; tensors zero by
    construction bounded in norm) of one live-BN step. Each bound is
    GRAD_REL_L2, the cost path and the encoders GRAD_REL_L2_FINE
    (COST_PATH), widened by the JAX package's own spread for img1 nudged
    by one ulp (``_widened``: live batch norm, relus at their kinks); the
    port runs on two threads (``_two_threads``)."""
    jrun, nrun, prun = step_runs(name)
    jloss = jrun["loss"]
    bound = _widened(LOSS_REL, abs(nrun["loss"] - jloss) / abs(jloss))
    assert abs(prun["loss"] - jloss) <= bound * abs(jloss)

    rules = convert.rules_for(prun["module"])
    expected, nudged = ({k: v.numpy() for k, v in
                         convert.jax_variables_to_state_dict(
                             {"params": run["grads"]}, rules).items()}
                        for run in (jrun, nrun))
    actual = prun["grads"]
    assert set(actual) == set(expected)
    total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                        for g in expected.values()))
    for key, e in expected.items():
        a = actual[key]
        if np.linalg.norm(e) <= ZERO_GRAD * total:
            assert np.linalg.norm(a) <= ZERO_GRAD * total, key
            continue
        base = GRAD_REL_L2_FINE if key.startswith(COST_PATH) else GRAD_REL_L2
        bound = _widened(base, _rel(nudged[key], e))
        assert _rel(a, e) <= bound, (key, _rel(a, e), bound)


def test_checkpointed_cost_leaves_running_stats_as_one_forward():
    """The recomputed correlation module in the backward normalizes with
    the batch statistics again but does not update the running ones: one
    train forward + backward leaves them as a forward without autograd."""
    cfg, (h, w), n, _, _ = STEPS["sl"]
    batch = _batch(h, w, seed=3, n=n)
    variables = _variables(cfg, batch, seed=4)
    states = []
    for grad in (True, False):
        spec = _port(cfg, variables)
        spec.model.on_stage(None, freeze_batchnorm=False)
        with _one_thread(), torch.set_grad_enabled(grad):
            out = spec.model.apply(torch.from_numpy(batch[0]),
                                   torch.from_numpy(batch[1]), train=True)
            if grad:
                sum(o.sum() for o in out).backward()
        states.append(spec.model.module.state_dict())
    for key, value in states[1].items():
        if key.startswith("corr.") and "running" in key:
            assert torch.equal(states[0][key], value), key
        if key.startswith("corr.") and "num_batches" in key:
            assert int(states[0][key]) == int(value) == 3, key


# -- the DICL loss and result ------------------------------------------------------


@pytest.mark.parametrize("args", [
    {}, {"ord": "robust"},
    {"valid_range": [[6, 6], [5, 5], [4, 8], [3, 3], [9, 2]]}],
    ids=["l2", "robust", "valid_range"])
def test_multiscale_loss_matches_jax(args):
    rs = np.random.RandomState(5)
    target = (4 * rs.randn(2, 32, 48, 2)).astype(np.float32)
    valid = rs.rand(2, 32, 48) > 0.3
    flows = [(3 * rs.randn(2, 32 // 2**i, 48 // 2**i, 2)).astype(np.float32)
             for i in range(3, 8) if 32 // 2**i]
    flows = flows[:5]
    weights = [1.0, 0.75, 0.5, 0.25, 0.25][:len(flows)]
    cfg = {"type": "dicl/multiscale", "arguments": {"weights": weights, **args}}
    expected = jdicl.MultiscaleLoss.from_config(cfg)(
        None, [jnp.asarray(f) for f in flows], jnp.asarray(target),
        jnp.asarray(valid))
    actual = tdicl.MultiscaleLoss.from_config(cfg)(
        None, [torch.from_numpy(f) for f in flows], torch.from_numpy(target),
        torch.from_numpy(valid))
    assert abs(float(actual) - float(expected)) <= 1e-6 * abs(float(expected))

    final = tdicl.DiclResult([torch.from_numpy(f) for f in flows],
                             (32, 48)).final()
    jfinal = jdicl.DiclResult([jnp.asarray(f) for f in flows],
                              (32, 48)).final()
    assert _max_rel(final, jfinal) <= F32_REL


# -- the weight bridge, configs, refusals ------------------------------------------

BRIDGE = [
    (sl_cfg("dicl-1x1", **{"corr-reg-type": "softargmax+dap"}), 64),
    (ml_cfg(**{"share-dicl": True, "dap-type": "full"}), 64),
    (ml_cfg(**{"encoder-type": "raft-maxpool", "dap-type": "separate",
               "corr-reg-type": "softargmax+dap"}), 64),
    (_cfg("raft+dicl/ctf-l3", NARROW | {
        "encoder-type": "dicl", "context-type": "raft-avgpool",
        "corr-type": "dicl-emb", "corr-args": {"embedding_dim": 8}},
        {"iterations": [1, 1, 1]}), 128),
    (_cfg("raft+dicl/ctf-l2", NARROW | {
        "encoder-type": "rfpm-raft", "context-type": "raft-maxpool",
        "corr-type": "dot", "share-dicl": True}, {"iterations": [1, 1]}), 64),
    (dicl_cfg("dicl/64to8"), 128),
]


@pytest.mark.parametrize("cfg,side", BRIDGE, ids=[
    "sl-1x1-dap", "ml-share-full", "ml-maxpool",
    "ctf3-dicl-emb", "ctf2-rfpm-dot", "dicl-64to8"])
def test_bridge_covers_variants(cfg, side):
    """Every JAX leaf has a rule and a port key of its shape, and every
    port parameter and buffer is covered."""
    img = np.zeros((1, side, side, 3), np.float32)
    variables = _variables(cfg, (img, img))
    module = tmodels.load(cfg).model.module
    convert.load_jax_variables(module, variables)
    state = module.state_dict()
    n_bn = sum(k.endswith("num_batches_tracked") for k in state)
    assert len(state) == len(jax.tree.leaves(variables)) + n_bn


def test_dicl_bridge_round_trip_through_chkpt_convert():
    """``dicl/baseline``'s parameter names are the DICL-Flow reference's:
    the port's state_dict through ``scripts/chkpt_convert.py``'s torch ->
    flax fill (``_dicl_rules``, the transposed convs flipped there) and
    bridged back is identical, with no torch key left unused."""
    cfg = dicl_cfg()
    img = np.zeros((1, 128, 128, 3), np.float32)
    variables = _variables(cfg, (img, img))
    module = tmodels.load(cfg).model.init(torch.Generator().manual_seed(5),
                                          device="cpu")
    original = module.state_dict()

    torch_state = chkpt_convert._normalize(original, chkpt_convert._DICL_PFX)
    filled, unused = chkpt_convert._fill_variables(
        variables, torch_state, chkpt_convert._dicl_rules())
    assert not unused, sorted(unused)[:5]

    back = convert.jax_variables_to_state_dict(filled,
                                               convert.rules_for(module))
    assert back.keys() == original.keys()
    for k in original:
        assert torch.equal(back[k], original[k]), k


@pytest.mark.parametrize("encoder", ["dicl", "rfpm-raft"])
def test_sl_builds_the_encoders_the_jax_module_refuses(encoder, monkeypatch):
    """The JAX sl module hands its encoders a ``dtype`` that the ``dicl``
    and ``rfpm-raft`` families do not take, and raises; the port passes
    one only under the bf16 policy (refused there for these families, by
    name) and runs them in float32. The assembled forward is held to
    F32_REL against the JAX module with its encoders built without that
    ``dtype`` (None: float32)."""
    cfg = sl_cfg("dot", **{"encoder-type": encoder, "context-type": encoder})
    batch = _batch(64, 64)
    with pytest.raises(TypeError, match="dtype"):
        _variables(cfg, batch)

    build = jencoders.make_encoder_s3

    def without_dtype(*args, dtype, **kwargs):
        assert dtype is None
        return build(*args, **kwargs)

    monkeypatch.setattr(jencoders, "make_encoder_s3", without_dtype)
    variables = _variables(cfg, batch)
    expected = _jax_forward(cfg, variables, batch)
    actual = _port_forward(cfg, variables, batch)
    assert len(actual) == 3
    assert _max_rel(actual, expected) <= F32_REL

    bad = {**cfg["model"]["parameters"], "mixed-precision": True}
    with pytest.raises(ValueError, match="mixed-precision"):
        tmodels.load({**cfg, "model": {**cfg["model"], "parameters": bad}})


@pytest.mark.parametrize("name", ["raft+dicl-ml.yaml", "raft+dicl-sl.yaml",
                                  "dicl-baseline.yaml", "dicl-64to8.yaml"])
def test_model_configs_load_unchanged_in_both_packages(name):
    path = ROOT / "cfg" / "model" / name
    jsp, tsp = jmodels.load(path), tmodels.load(path)
    assert tsp.id == jsp.id
    assert tsp.model.get_config() == jsp.model.get_config()
    assert tsp.loss.get_config() == jsp.loss.get_config()
    assert tsp.input.get_config() == jsp.input.get_config()


@pytest.mark.parametrize("cfg", [ml_cfg(), sl_cfg()], ids=["ml", "sl"])
@pytest.mark.parametrize("arg", ["flow_init", "hidden_init", "return_state"])
def test_ladder_arguments_refuse_by_name(cfg, arg):
    """The ladder carry, which these models refused before the ladder was
    ported, round-trips: a zero ``flow_init`` is the plain start,
    ``hidden_init`` with the carried flow continues the recurrence bit for
    bit, and ``return_state`` gives the final flow with the coarse carry.
    (The chains against JAX are in ``test_torch_port_ladder.py``.)"""
    spec = tmodels.load(cfg)
    spec.model.init(torch.Generator().manual_seed(0), device="cpu")
    img1, img2 = (torch.from_numpy(x)
                  for x in _batch(64, 64, seed=2, n=1)[:2])

    def run(**args):
        with _one_thread(), torch.no_grad():
            return spec.model.apply(img1, img2, **({"iterations": 2} | args))

    plain = run()
    if arg == "flow_init":
        seeded = run(flow_init=torch.zeros(1, 8, 8, 2))
        assert all(torch.equal(a, e) for a, e in zip(seeded, plain))
    elif arg == "hidden_init":
        _, state = run(iterations=1, return_state=True)
        out, cont = run(iterations=1, flow_init=state["flow"],
                        hidden_init=state["hidden"], return_state=True)
        full_out, full = run(return_state=True)
        assert torch.equal(out[-1], full_out[-1])
        assert torch.equal(cont["flow"], full["flow"])
        assert torch.equal(cont["hidden"], full["hidden"])
    else:
        out, state = run(return_state=True)
        assert len(out) == 1 and tuple(out[0].shape) == (1, 64, 64, 2)
        np.testing.assert_allclose(out[0].numpy(), plain[-1].numpy(),
                                   rtol=0, atol=1e-5)
        assert tuple(state["flow"].shape) == (1, 8, 8, 2)
        assert tuple(state["hidden"].shape) == (1, 8, 8, 16)
        assert tuple(state["delta"].shape) == (1,)


def _report(float64=False):
    """Print, for each STEPS model, the bounds ``test_train_step_matches_jax``
    and ``test_forward_matches_jax`` apply and what the port reads
    against them; with ``float64`` for the DICL ladder only (the hybrids'
    GRU scans carry float32 and do not trace with float64 on), and each
    f32 run's live-BN outputs against JAX's run in float64 (up to the
    cost's float32 cast) besides."""
    for name in ["dicl"] if float64 else list(STEPS):
        cfg, (h, w), n, model_args, loss_args = STEPS[name]
        batch = _batch(h, w, seed=3, n=n)
        variables = _variables(cfg, batch, seed=4)
        jrun, nrun = _jax_step(cfg, variables, batch, model_args, loss_args)
        prun = _port_step(cfg, variables, batch, model_args, loss_args)
        rules = convert.rules_for(prun["module"])
        expected, nudged = ({k: v.numpy() for k, v in
                             convert.jax_variables_to_state_dict(
                                 {"params": run["grads"]}, rules).items()}
                            for run in (jrun, nrun))
        total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                            for g in expected.values()))
        rows = []
        for key, e in expected.items():
            if np.linalg.norm(e) <= ZERO_GRAD * total:
                continue
            base = (GRAD_REL_L2_FINE if key.startswith(COST_PATH)
                    else GRAD_REL_L2)
            bound = _widened(base, _rel(nudged[key], e))
            rows.append((bound / base, bound, base,
                         _rel(prun["grads"][key], e), key))
        widened = sorted((r for r in rows if r[0] > 1), reverse=True)
        print(f"{name}: {len(widened)} of {len(rows)} gradient bounds "
              "widened")
        for r in widened[:4]:
            print("  x%.2f bound %.3e (base %.0e) reads %.3e  %s" % r)
        widest = max(rows, key=lambda r: r[1])
        print("  largest bound %.3e (base %.0e) reads %.3e  %s"
              % widest[1:])
        worst = max(rows, key=lambda r: r[3] / r[1])
        print("  largest read/bound %.2f: %.3e of %.3e  %s"
              % (worst[3] / worst[1], worst[3], worst[1], worst[4]))
        print(f"  loss reads {abs(prun['loss'] - jrun['loss']) / abs(jrun['loss']):.3e}, "
              f"live outputs {_max_rel(prun['out'], jrun['out']):.3e}")
        if float64:
            model = jmodels.load(cfg).model
            model.on_stage(None, freeze_batchnorm=False)
            v64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                               variables)
            out64 = jax.jit(lambda v, x1, x2: model.apply(
                v, x1, x2, train=True, **model_args)[0])(
                    v64, *(jnp.asarray(x, jnp.float64) for x in batch[:2]))
            for side, out in (("jax f32", jrun["out"]),
                              ("port f32", prun["out"])):
                print(f"  {side} vs float64: "
                      f"{_max_rel(_as_torch(out), out64):.3e}")


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu \
    #     python tests/test_torch_port_dicl_models.py [--float64]
    if "--float64" in sys.argv:
        jax.config.update("jax_enable_x64", True)
    _report(float64="--float64" in sys.argv)
