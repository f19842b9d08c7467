"""PyTorch port: ``raft/sl``, ``raft/sl-ctf-l2`` / ``-l3`` / ``-l4`` and
``raft+dicl/sl-ca`` held against the JAX package on the CPU, from the
same seeded numpy batch and JAX variables bridged with ``convert`` (drawn
over the JAX tree's shapes, batch statistics away from their (0, 1)
init).

- each model's forward in eval, every output (the readouts with
  ``corr_flow``), one JAX program a model; ``raft/sl``'s shipped config
  builds the bf16 policy;
- one live-BN train step of ``sl-ctf-l3`` (the s0-chairs stage's batch
  norm) in both packages: the train-mode forward's outputs and running
  statistics, the loss and every gradient;
- the weight bridge's coverage over the sl-ctf variants (sharing, every
  hidden-state upsampler, both readouts), and ``raft/sl``'s activation
  capture points against the JAX module's tree;
- the shipped model configs in both packages.

Bounds are ``test_torch_port_dicl_models.py``'s (from
``test_torch_port_ctf.py``): F32_REL for eval flows, LIVE_F32_REL for the
live-BN forward, STATS_ATOL for running statistics, GRAD_REL_L2 per
gradient tensor (GRAD_REL_L2_FINE on the encoders), LOSS_REL, each
widened under live batch norm only by ``_widened``. The port's forwards
run on one thread, its train step on two (``_two_threads``: a fixed
count, so the reading does not depend on the threads an earlier test of
the process left; it reads at most 0.29 of its bounds at any count from
1 to 8). The models are cut to
corr-channels 8, context and recurrent 16, a few iterations, on 64x96 to
128x128 images (sl-ctf-l4 at 128x128: at 64x128 its 1/64 level is 1x2,
where the instance norms of the pyramid heads amplify float32 rounding to
2e-5 of the flow on both sides).
"""

import jax
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert
from test_torch_port_ctf import F32_REL
from test_torch_port_dicl_models import (
    LIVE_F32_REL, NARROW, ROOT, _batch, _cfg, _check_stats, _jax_forward,
    _jax_step, _max_rel, _port_forward, _port_step, _variables)
from test_torch_port_dicl_models import \
    test_train_step_matches_jax as _check_train_step
from test_torch_port_train import _one_thread
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

MLSEQ = {"type": "raft+dicl/mlseq",
         "arguments": {"ord": 1, "gamma": 0.85, "alpha": [0.38, 0.6, 1.0]}}


def sl_ctf_cfg(levels, iterations, **params):
    return _cfg(f"raft/sl-ctf-l{levels}", NARROW | params,
                {"iterations": list(iterations)}, MLSEQ)


# (config, image size, forward arguments)
FORWARDS = {
    "sl": (_cfg("raft/sl", NARROW | {"corr-reg-type": "softargmax+dap"},
                {"iterations": 3}), (64, 96), {"corr_flow": True}),
    "sl-ctf-l2": (sl_ctf_cfg(2, (2, 2), **{
        "share-rnn": False, "upsample-hidden": "bilinear",
        "corr-reg-type": "softargmax+dap"}), (64, 128), {"corr_flow": True}),
    "sl-ctf-l4": (sl_ctf_cfg(4, (1, 1, 1, 2), **{
        "share-rnn": False, "upsample-hidden": "crossattn"}),
        (128, 128), {}),
    "sl-ca": (_cfg("raft+dicl/sl-ca", NARROW | {"embedding-channels": 8},
                   {"iterations": 2}), (64, 96), {}),
}

# the live-BN step: sl-ctf-l3 with shared update blocks and the
# cross-attention upsampler, as the dicl models' STEPS
STEP = (sl_ctf_cfg(3, (2, 1, 2), **{"upsample-hidden": "crossattn"}),
        (64, 128), 2, {}, {})


@pytest.fixture(scope="module")
def step_run():
    """(JAX's run, JAX's run with img1 nudged, the port's run) of STEP,
    computed once for the module's tests."""
    cfg, (h, w), n, model_args, loss_args = STEP
    batch = _batch(h, w, seed=3, n=n)
    variables = _variables(cfg, batch, seed=4)
    return (*_jax_step(cfg, variables, batch, model_args, loss_args),
            _port_step(cfg, variables, batch, model_args, loss_args))


def _with_args(cfg, args):
    model = cfg["model"]
    return {**cfg, "model": {**model, "arguments": {**model["arguments"],
                                                    **args}}}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_matches_jax(name):
    """Every output within F32_REL of JAX's in eval."""
    cfg, (h, w), args = FORWARDS[name]
    cfg = _with_args(cfg, args)
    batch = _batch(h, w)
    variables = _variables(cfg, batch)
    expected = _jax_forward(cfg, variables, batch)
    actual = _port_forward(cfg, variables, batch)
    assert _max_rel(actual, expected) <= F32_REL


def test_sl_shipped_config_runs_the_bf16_policy():
    """The shipped ``raft/sl`` config builds the bf16 policy, and its
    forward rounds: off the float32 run of the same weights by more than
    the float32 bound. The policy's code is ``raft/baseline``'s
    ``RaftModule``, which ``test_torch_port_raft.py`` holds against the
    JAX bf16 run."""
    spec = tmodels.load(ROOT / "cfg" / "model" / "raft-sl.yaml")
    module = spec.model.module
    assert module.compute_dtype == torch.bfloat16 and module.corr_levels == 1
    cfg = _cfg("raft/sl", NARROW, {"iterations": 2})
    f32 = tmodels.load(cfg).model
    f32.init(device="cpu")
    bf16 = tmodels.load(_cfg("raft/sl", NARROW | {"mixed-precision": True},
                             {"iterations": 2})).model
    bf16.init(device="cpu")
    bf16.module.load_state_dict(f32.module.state_dict())
    img1, img2 = (torch.from_numpy(x) for x in _batch(64, 64)[:2])
    with _one_thread(), torch.no_grad():
        a, b = bf16.apply(img1, img2), f32.apply(img1, img2)
    assert all(x.dtype == torch.float32 for x in a)
    assert _max_rel(a, [x.numpy() for x in b]) > 10 * F32_REL


def test_sl_ctf_live_forward_matches_jax(step_run):
    """The live-BN step's forward within LIVE_F32_REL of JAX's, and the
    running statistics after it (STATS_ATOL, ``_widened``); the context
    pyramid's statistics moved."""
    jrun, nrun, prun = step_run
    assert _max_rel(prun["out"], jrun["out"]) <= LIVE_F32_REL
    _check_stats(prun["module"], jrun["stats"], nrun["stats"])
    initial = convert.jax_variables_to_state_dict(
        _variables(STEP[0], _batch(*STEP[1], seed=3, n=STEP[2]), seed=4),
        convert.rules_for(prun["module"]))
    key = "cnet.out5.norm1.running_mean"
    assert not torch.equal(prun["module"].state_dict()[key], initial[key])


def test_sl_ctf_train_step_matches_jax(step_run):
    """The loss and every gradient tensor of the live-BN step, by
    ``test_torch_port_dicl_models.py``'s rule (GRAD_REL_L2, the encoders
    GRAD_REL_L2_FINE, ``_widened``)."""
    _check_train_step("sl-ctf-l3", lambda name: step_run)


# -- the weight bridge, capture points, configs -----------------------------

# the sharing, upsampler and readout combinations the forwards (which
# load strictly too) do not build
SL_CTF_VARIANTS = [
    (2, "none", True, "softargmax+dap"),
    (4, "bilinear", True, "softargmax"),
]


@pytest.mark.parametrize("levels,hup,share,reg", SL_CTF_VARIANTS)
def test_bridge_covers_sl_ctf_variants(levels, hup, share, reg):
    """Every JAX leaf has a rule and a port key of its shape, and every
    port parameter and buffer is covered."""
    cfg = sl_ctf_cfg(levels, (1,) * levels, **{
        "share-rnn": share, "upsample-hidden": hup, "corr-reg-type": reg})
    img = np.zeros((1, 128, 128, 3), np.float32)
    variables = _variables(cfg, (img, img))
    module = tmodels.load(cfg).model.module
    convert.load_jax_variables(module, variables)
    state = module.state_dict()
    n_bn = sum(k.endswith("num_batches_tracked") for k in state)
    assert len(state) == len(jax.tree.leaves(variables)) + n_bn


def test_sl_activation_points_match_the_jax_tree():
    """``raft/sl`` is ``raft/baseline``'s module with one level: every
    capture point with parameters is a module of the JAX raft/sl tree,
    and every JAX encoder and Up8 module with parameters has a point."""
    cfg = FORWARDS["sl"][0]
    img = np.zeros((1, 64, 64, 3), np.float32)
    variables = _variables(cfg, (img, img))
    jax_modules = {".".join(path[:-1]) for path, _ in
                   convert._named_leaves(variables["params"])}
    module = tmodels.load(cfg).model.module
    assert module.corr_levels == 1
    points = convert.activation_points(module)
    mods = dict(module.named_modules())
    for path, (target, _) in points.items():
        if any(True for _ in mods[target].parameters(recurse=False)):
            # the module, or a parameterless flax wrapper around it
            assert any(m == path or m.startswith(path + ".")
                       for m in jax_modules), path
    assert {m for m in jax_modules if m.startswith(
        ("FeatureEncoderS3", "Up8Network"))} <= set(points)


@pytest.mark.parametrize("name", ["raft-sl.yaml", "raft-sl-ctf2l.yaml",
                                  "raft-sl-ctf3l.yaml", "raft-sl-ctf4l.yaml",
                                  "raft+dicl-sl-ca.yaml"])
def test_model_configs_load_unchanged_in_both_packages(name):
    path = ROOT / "cfg" / "model" / name
    jsp, tsp = jmodels.load(path), tmodels.load(path)
    assert tsp.id == jsp.id
    assert tsp.model.get_config() == jsp.model.get_config()
    assert tsp.loss.get_config() == jsp.loss.get_config()
    assert tsp.input.get_config() == jsp.input.get_config()


def test_sl_ctf_refuses_a_wrong_iteration_count():
    """And its activation hooks refuse by name."""
    model = tmodels.load(sl_ctf_cfg(3, (1, 1))).model
    with pytest.raises(NotImplementedError, match="slice 2 item 7"):
        convert.activation_points(model.module)
    img = torch.zeros((1, 64, 64, 3))
    with pytest.raises(ValueError, match="one count per level"):
        model.apply(img, img)

