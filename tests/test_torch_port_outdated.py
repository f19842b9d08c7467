"""PyTorch port: the kept experiments ``raft/cl``, ``wip/warp/1`` and
``wip/warp/2`` with their losses held against the JAX package on the CPU,
from the same seeded numpy batch and JAX variables bridged with
``convert`` (drawn over the JAX tree's shapes, batch statistics away from
their (0, 1) init).

- ``FeatureEncoderGa(heads=False)``, the raw ladder ``raft/cl`` reads;
- the plain window sampler at ``wip/warp/2``'s radii, with the gradient
  to the centres the kernel does not give;
- one live-BN train step of ``raft/cl`` (its checkpointed correlation
  module recomputed in the backward) and of ``wip/warp/2`` (the
  ``dicl/multiscale`` loss) in both packages: every output, the running
  statistics, the loss and every gradient; one eval forward of
  ``wip/warp/1`` with its example costs, and both families' correlation
  losses over them;
- every loss of the two families, on the same result in both packages;
- the shipped model configs in both packages, and the refusals.

The example costs' negatives pair each feature map with a permuted copy:
the JAX module draws the permutations from ``fold_in(PRNGKey(0), i)``,
the port from a seeded ``torch.Generator``. The model tests feed JAX's
into the port (``jax_permutations``).

Bounds are ``test_torch_port_dicl_models.py``'s: F32_REL for eval
outputs, LIVE_F32_REL for live-BN ones (relative to each map's largest
|value|, at least 1), STATS_ATOL, GRAD_REL_L2 per gradient tensor (the
encoders and the matching nets GRAD_REL_L2_FINE), LOSS_REL, each widened
under live batch norm only by ``_widened``; ``test_torch_port_dicl.py``'s
SAMPLE_ATOL for the sampler and ``test_torch_port_dicl_family.py``'s
ENCODER_REL for the encoder. The port's forwards run on one thread, its
train steps on two. The models run at their fixed widths (no width
parameter), cut in iterations and radius, on 128x128 images (the GA-Net
needs sides divisible by 128).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu.models.common.encoders import dicl as jga
from raft_meets_dicl_tpu.models.impls.outdated import raft_cl as jcl
from raft_meets_dicl_tpu.models.impls.outdated import wip_warp as jwarp
from raft_meets_dicl_tpu.ops import sample as jsample
from raft_meets_dicl_tpu_torch import convert
from raft_meets_dicl_tpu_torch.models.common.encoders import dicl as tga
from raft_meets_dicl_tpu_torch.models.impls.outdated import raft_cl as tcl
from raft_meets_dicl_tpu_torch.models.impls.outdated import wip_warp as twarp
from raft_meets_dicl_tpu_torch.ops import sample as tsample
from test_torch_port_ctf import F32_REL, GRAD_REL_L2, GRAD_REL_L2_FINE, \
    LOSS_REL, ZERO_GRAD
from test_torch_port_dicl import SAMPLE_ATOL, _sampler_inputs
from test_torch_port_dicl_family import ENCODER_REL, _bridge, _jax_init, \
    _tree_rel
from test_torch_port_dicl_models import (
    LIVE_F32_REL, ROOT, _batch, _cfg, _check_stats, _jax_step, _max_rel,
    _port_step, _rel, _variables, _widened)
from test_torch_port_train import _one_thread
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

SIDE = 128

CL = _cfg("raft/cl", {"corr-radius": 1}, {"iterations": 2},
          {"type": "raft/cl/sequence", "arguments": {"ord": 2,
                                                     "gamma": 0.85}})
WARP1 = _cfg("wip/warp/1", {"disp-range": [1, 2]},
             {"corr_loss_examples": True},
             {"type": "wip/warp/multiscale",
              "arguments": {"weights": [1.0, 0.75, 0.5, 0.25, 0.125]}})
WARP2 = _cfg("wip/warp/2",
             {"disp-range": [[1, 1], [2, 2], [1, 1], [1, 1], [1, 1]]},
             {"iterations": [1, 2, 1, 1, 1]},
             {"type": "dicl/multiscale",
              "arguments": {"weights": [1.0, 0.85, 0.72, 0.61, 0.52,
                                        0.44]}})

# the cost path: encoders, heads and matching nets, held to
# GRAD_REL_L2_FINE as in the dicl models
COST_PATH = ("fnet.", "fnet_u.", "fnet_d.", "cnet.", "corr.", "rfu.",
             "rlu.cvnets.")


def _jax_permutation(i, n):
    """The JAX modules' permutation of example map ``i``."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), i)
    return torch.from_numpy(np.array(jax.random.permutation(key, n)))


@contextlib.contextmanager
def jax_permutations():
    """The port's example costs with JAX's permutations."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcl, "example_permutation", _jax_permutation)
        yield


def _tree_max_rel(actual, expected):
    """``_max_rel`` over a result dict's entries, or a list."""
    if isinstance(expected, dict):
        assert set(actual) == set(expected)
        return max(_tree_max_rel(actual[k], expected[k]) for k in expected)
    return _max_rel(actual, expected)


# -- the modules the models add ----------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "live_bn"])
def test_ga_encoder_without_heads_matches_jax(train):
    """The raw ladder features (no output heads) of an image pair at
    levels 2 and 3, and in train mode the running statistics."""
    from test_torch_port_dicl_family import _check_stats as check_stats
    from test_torch_port_dicl_family import _jax_apply

    rs = np.random.RandomState(8)
    imgs = [rs.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
            for _ in range(2)]
    pair = tuple(jnp.asarray(x) for x in imgs)
    jmodule = jga.FeatureEncoderGa(depth=4, out_levels=(2, 3), heads=False)
    v = _jax_init(jmodule, 9, pair)
    expected, stats = _jax_apply(jmodule, v, pair, train=train)

    module = tga.FeatureEncoderGa(depth=4, out_levels=(2, 3), heads=False)
    assert not any(n.startswith("outconv") for n, _ in module.named_children())
    rules = convert._encoder_rules((("m", module),))
    _bridge(module, v, "FeatureEncoderGa_0", rules)
    with _one_thread(), torch.no_grad():
        actual = module(tuple(torch.from_numpy(x).permute(0, 3, 1, 2)
                              for x in imgs), train)
    actual = jax.tree.map(lambda t: t.permute(0, 2, 3, 1), actual)
    assert [a.shape[-1] for a in actual[0]] == [64, 96]
    assert _tree_rel(actual, expected) <= ENCODER_REL
    check_stats(module, stats, "FeatureEncoderGa_0", rules)


@pytest.mark.parametrize("radius", [2, 3])
def test_plain_sampler_gradients_match_jax(radius):
    """``wip/warp/2``'s sampler: the plain version's window and its
    gradients to f2 and to the centres against JAX's ``sample_window``
    (the XLA op its module calls). The port clamps the centres to [-(r+1),
    dim + r] first, JAX does not: a centre out there samples only zeros
    either way, and its gradient is zero on both sides."""
    f2, coords = _sampler_inputs(30 + radius, "float32")
    k = 2 * radius + 1
    dout = np.random.RandomState(40 + radius).randn(
        2, k, k, 6, 7, 5).astype(np.float32)
    window, vjp = jax.vjp(lambda m, c: jsample.sample_window(m, c, radius),
                          jnp.asarray(f2), jnp.asarray(coords))
    df2, dcoords = vjp(jnp.asarray(dout))

    tf2 = torch.from_numpy(f2).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    actual = tsample.sample_window(tf2, tc, radius)
    actual.backward(torch.from_numpy(dout))
    for a, e in ((actual, window), (tf2.grad, df2), (tc.grad, dcoords)):
        a = a.detach().numpy()
        assert a.shape == np.shape(e)
        assert np.abs(a - np.asarray(e)).max() <= SAMPLE_ATOL
    assert np.abs(tc.grad.numpy()).max() > 0
    assert np.all(tc.grad.numpy()[0, 0, 0] == 0)    # a far centre


# -- the models -------------------------------------------------------------

# (config, image size, batch, the stage's model and loss arguments), so
# that live batch norm over the GA-Net's 1/128 maps (one statistic per
# image of the pair) sees 4 values a channel: raft/cl at 4x128x128 (at
# batch 2 the encoder's deepest gradients move 2-3% for a one-ulp change
# of img2); wip/warp/2 at 2x256x128, whose coarsest unit at 4x128x128
# reads 2x2 maps, where JAX's own gradient of rfu.4's first batch-norm
# bias moves 3% for a one-ulp change of img1
STEPS = {"cl": (CL, (SIDE, SIDE), 4, {}, {}),
         "warp2": (WARP2, (2 * SIDE, SIDE), 2, {}, {})}

# raft/cl's Up8 head: the JAX module runs it once an iteration and sums
# its conv1 gradients in float32 1.5e-3 (bias) and 1.7e-3 (weight) off a
# float64 run of itself; the port's batched head reads 3.4e-6 and 4.5e-6
# off that run. Held to GRAD_REL_L2_FINE with the cost path
UP8_CONV1 = ("upnet.conv1.",)


@pytest.fixture(scope="module")
def step_runs():
    """``name`` -> (JAX's run, JAX's run with img1 nudged, the port's
    run) of STEPS[name], each computed once for the module's tests."""
    runs = {}

    def get(name):
        if name not in runs:
            cfg, (h, w), n, model_args, loss_args = STEPS[name]
            batch = _batch(h, w, seed=3, n=n)
            variables = _variables(cfg, batch, seed=4)
            with jax_permutations():
                port = _port_step(cfg, variables, batch, model_args,
                                  loss_args)
            runs[name] = (*_jax_step(cfg, variables, batch, model_args,
                                     loss_args), port)
        return runs[name]
    return get


@pytest.mark.parametrize("name", list(STEPS))
def test_live_forward_matches_jax(name, step_runs):
    """Every output of the live-BN step's forward (flows, feature maps,
    example costs) within LIVE_F32_REL of JAX's, and the running
    statistics after it (STATS_ATOL, ``_widened``); the matching nets'
    statistics moved."""
    jrun, nrun, prun = step_runs(name)
    assert _tree_max_rel(prun["out"], jrun["out"]) <= LIVE_F32_REL
    _check_stats(prun["module"], jrun["stats"], nrun["stats"])
    moved = [k for k, v in prun["module"].state_dict().items()
             if k.endswith("running_mean") and "mnet" in k
             and v.abs().max() > 0]
    assert moved


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_matches_jax(name, step_runs):
    """The loss and every gradient tensor (relative L2; tensors zero by
    construction bounded in norm) of one live-BN step: GRAD_REL_L2, the
    cost path and raft/cl's Up8 conv1 GRAD_REL_L2_FINE, widened by the
    JAX package's own spread for img1 nudged by one ulp (``_widened``).
    ``wip/warp/2``'s gradients run through the plain sampler's centres,
    unit to unit, as JAX's do."""
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
        fine = key.startswith(COST_PATH + UP8_CONV1)
        base = GRAD_REL_L2_FINE if fine else GRAD_REL_L2
        assert _rel(a, e) <= _widened(base, _rel(nudged[key], e)), key


@pytest.fixture(scope="module")
def warp1_run():
    """``wip/warp/1``'s eval forward with its example costs in both
    packages (the port with JAX's permutations), and the batch."""
    batch = _batch(SIDE, SIDE)
    variables = _variables(WARP1, batch)
    model = jmodels.load(WARP1).model
    x1, x2 = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    expected = jax.jit(lambda v: model.apply(v, x1, x2))(
        jax.tree.map(jnp.asarray, variables))

    spec = tmodels.load(WARP1)
    spec.model.init(device="cpu")
    convert.load_jax_variables(spec.model.module, variables)
    with _one_thread(), torch.no_grad(), jax_permutations():
        actual = spec.model.apply(torch.from_numpy(batch[0]),
                                  torch.from_numpy(batch[1]))
    return expected, actual, batch


def test_warp1_forward_matches_jax(warp1_run):
    """``wip/warp/1`` in eval: every level flow, the feature maps and the
    example costs (JAX's permutations) within F32_REL of JAX's."""
    expected, actual, _ = warp1_run
    assert len(actual["flow"]) == 5 and len(actual["corr_neg"]) == 10
    assert _tree_max_rel(actual, expected) <= F32_REL


@pytest.mark.parametrize("kind", ["corr_hinge", "corr_mse"])
def test_corr_losses_through_the_model_match_jax(kind, warp1_run):
    """The correlation losses of both families over ``wip/warp/1``'s
    example costs (the port's made with JAX's permutations) within
    LOSS_REL of JAX's; each differs from the flow loss alone."""
    expected, actual, batch = warp1_run
    target, valid = batch[2], batch[3]
    weights = [1.0, 0.75, 0.5, 0.25, 0.125]
    for jcls, tcls, result in (
            (jwarp, twarp, None),
            (jcl, tcl, {"flow": [jnp.zeros_like(target)] * 2})):
        name = {"corr_hinge": "CorrHinge", "corr_mse": "CorrMse"}[kind]
        prefix = "WipMultiscale" if jcls is jwarp else "ClSequence"
        args = {"weights": weights} if jcls is jwarp else {}
        jres = expected if result is None else {**expected, **result}
        tres = actual if result is None else {
            **actual, "flow": [torch.from_numpy(np.array(f))
                               for f in result["flow"]]}
        jloss = getattr(jcls, f"{prefix}{name}Loss")({})
        tloss = getattr(tcls, f"{prefix}{name}Loss")({})
        e = float(jloss(None, jres, jnp.asarray(target), jnp.asarray(valid),
                        **args))
        a = float(tloss(None, tres, torch.from_numpy(target),
                        torch.from_numpy(valid), **args))
        assert abs(a - e) <= LOSS_REL * abs(e)
        flow_only = float(getattr(jcls, f"{prefix}Loss")({})(
            None, jres, jnp.asarray(target), jnp.asarray(valid), **args))
        assert abs(e - flow_only) > 100 * LOSS_REL * abs(e)


# -- the losses -------------------------------------------------------------


def _loss_result(levels, rs):
    """A result dict in both packages: flows (full size for raft/cl, a
    pyramid for wip/warp) and example costs."""
    shapes = ([(2, 32, 48, 2)] * 3 if levels is None
              else [(2, 32 // 2**i, 48 // 2**i, 2) for i in range(levels)])
    flows = [(3 * rs.randn(*s)).astype(np.float32) for s in shapes]
    pos = [rs.randn(2, 8 // 2**i, 12 // 2**i, 1, 1).astype(np.float32)
           for i in range(3)]
    neg = [rs.randn(*p.shape).astype(np.float32) for p in pos]
    numpy = {"flow": flows, "corr_pos": pos, "corr_neg": neg}
    return ({k: [jnp.asarray(x) for x in v] for k, v in numpy.items()},
            {k: [torch.from_numpy(x) for x in v] for k, v in numpy.items()})


LOSSES = [
    (jcl.ClSequenceLoss, tcl.ClSequenceLoss, None, {"ord": 2}),
    (jcl.ClSequenceCorrHingeLoss, tcl.ClSequenceCorrHingeLoss, None,
     {"alpha": 0.5, "margin": 0.8}),
    (jcl.ClSequenceCorrMseLoss, tcl.ClSequenceCorrMseLoss, None,
     {"gamma": 0.85}),
    (jwarp.WipMultiscaleLoss, twarp.WipMultiscaleLoss, 3,
     {"weights": [1.0, 0.5, 0.25], "ord": "robust"}),
    (jwarp.WipMultiscaleCorrHingeLoss, twarp.WipMultiscaleCorrHingeLoss, 3,
     {"weights": [1.0, 0.5, 0.25],
      "valid_range": [[6, 6], [4, 8], [3, 3]]}),
    (jwarp.WipMultiscaleCorrMseLoss, twarp.WipMultiscaleCorrMseLoss, 3,
     {"weights": [1.0, 0.5, 0.25], "alpha": 2.0, "ord": 1}),
]


@pytest.mark.parametrize("jcls,tcls,levels,args", LOSSES,
                         ids=[c[1].type for c in LOSSES])
def test_losses_match_jax(jcls, tcls, levels, args):
    rs = np.random.RandomState(6)
    jresult, tresult = _loss_result(levels, rs)
    target = (4 * rs.randn(2, 32, 48, 2)).astype(np.float32)
    valid = rs.rand(2, 32, 48) > 0.3
    cfg = {"type": tcls.type, "arguments": args}
    assert tcls.from_config(cfg).get_config() == \
        jcls.from_config(cfg).get_config()
    expected = float(jcls.from_config(cfg)(
        None, jresult, jnp.asarray(target), jnp.asarray(valid)))
    actual = float(tcls.from_config(cfg)(
        None, tresult, torch.from_numpy(target), torch.from_numpy(valid)))
    assert abs(actual - expected) <= LOSS_REL * abs(expected)


# -- configs and refusals ----------------------------------------------------


@pytest.mark.parametrize("name", ["raft-cl.yaml", "wip-warp.yaml",
                                  "wip-warp2.yaml"])
def test_model_configs_load_unchanged_in_both_packages(name):
    path = ROOT / "cfg" / "model" / name
    jsp, tsp = jmodels.load(path), tmodels.load(path)
    assert tsp.id == jsp.id
    assert tsp.model.get_config() == jsp.model.get_config()
    assert tsp.loss.get_config() == jsp.loss.get_config()
    assert tsp.input.get_config() == jsp.input.get_config()


def test_port_permutations_are_fixed_and_not_jax_s():
    """The port's own permutations: one fixed permutation per example map,
    the same on every call, another than JAX's (ROADMAP C, not a fault)."""
    a, b = tcl.example_permutation(3, 64), tcl.example_permutation(3, 64)
    assert torch.equal(a, b) and sorted(a.tolist()) == list(range(64))
    assert not torch.equal(a, tcl.example_permutation(4, 64))
    assert not torch.equal(a, _jax_permutation(3, 64))


@pytest.mark.parametrize("name", ["wip-warp", "wip-warp2"])
def test_shipped_wip_stages_pass_their_loss_an_argument_it_refuses(name):
    """The shipped wip stages give their losses ``gamma``, which neither
    ``wip/warp/multiscale`` nor ``dicl/multiscale`` takes: both packages
    raise at the first step, by the same TypeError."""
    import json

    config = json.loads((ROOT / "cfg" / "full" / "baseline"
                         / f"{name}.s0-chairs.json").read_text())
    stage_args = config["strategy"]["stages"][0]["loss"]["arguments"]
    assert "gamma" in stage_args
    loss_cfg = config["model"]["loss"]
    flows = [np.zeros((1, 8, 8, 2), np.float32)] * 5
    target, valid = np.zeros((1, 8, 8, 2), np.float32), np.ones((1, 8, 8),
                                                                bool)
    for models, arr in ((jmodels, jnp.asarray), (tmodels, torch.from_numpy)):
        loss = models.load_loss(loss_cfg)
        res = [arr(f) for f in flows]
        if name == "wip-warp":
            res = {"flow": res}
        with pytest.raises(TypeError, match="'gamma'"):
            loss(None, res, arr(target), arr(valid), **stage_args)


def test_refusals():
    """raft/cl's ladder arguments (it takes ``flow_init``, as in JAX, but
    neither ``hidden_init`` nor ``return_state``), a non-square
    wip/warp/2 window and the activation hooks of the three models
    refuse."""
    for cfg in (CL, WARP1, WARP2):
        with pytest.raises(NotImplementedError, match="slice 2 item 7"):
            convert.activation_points(tmodels.load(cfg).model.module)
    model = tmodels.load(CL).model
    img = torch.zeros((1, SIDE, SIDE, 3))
    for arg in ("hidden_init", "return_state"):
        with pytest.raises(TypeError, match=f"unexpected keyword.*'{arg}'"):
            model.apply(img, img, **{arg: True})
    bad = {**WARP2["model"]["parameters"], "disp-range": [[1, 2]] * 5}
    with pytest.raises(ValueError, match="square"):
        tmodels.load({**WARP2, "model": {**WARP2["model"],
                                         "parameters": bad}})
