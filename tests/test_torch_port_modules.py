"""PyTorch port: the RAFT modules with weights bridged from JAX variables
drawn over the JAX init's shapes (``convert.jax_variables_to_state_dict``),
each held against its JAX counterpart on the CPU in float32; the weight
bridge against ``scripts/chkpt_convert.py``; config loading in both
packages."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
from raft_meets_dicl_tpu.models.common.encoders import raft as jenc
from raft_meets_dicl_tpu.models.impls import raft as jraft
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert
from raft_meets_dicl_tpu_torch.models.common.encoders import raft as tenc
from raft_meets_dicl_tpu_torch.models.impls import raft as traft

sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))
import chkpt_convert  # noqa: E402
from test_torch_port_train import _flax_init  # noqa: E402
from test_torch_port_train import port_on_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).parent.parent

# float32 convolutions summed in another order (oneDNN vs XLA:CPU at
# 'highest' precision) through up to 14 stacked conv/norm layers
ATOL = 1e-4

_CFG = {
    "name": "RAFT baseline", "id": "raft/baseline",
    "model": {"type": "raft/baseline", "parameters": {}},
    "loss": {"type": "raft/sequence"},
    "input": None,
}


@pytest.fixture(scope="module")
def variables():
    """JAX raft/baseline variables (numpy tree) over the JAX init's shapes,
    drawn from a seed as flax initializes them (``_flax_init``: no init
    program compiled), with batch statistics away from their (0, 1) init
    so the batch-norm mapping is exercised."""
    spec = jmodels.load(_CFG)
    img = jnp.zeros((1, 64, 96, 3), jnp.float32)
    return _flax_init(spec.model, 7, img, img, iterations=1)


@pytest.fixture(scope="module")
def state(variables):
    return convert.jax_variables_to_state_dict(variables)


def _sub(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def _close(actual, expected, atol=ATOL):
    np.testing.assert_allclose(actual.detach().float().numpy(),
                               np.asarray(expected, np.float32),
                               rtol=0, atol=atol)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("which,norm", [(0, "instance"), (1, "batch")])
def test_feature_encoder_matches_jax(variables, state, which, norm):
    name = f"FeatureEncoderS3_{which}"
    jvars = {"params": variables["params"][name]}
    if norm == "batch":
        jvars["batch_stats"] = variables["batch_stats"][name]
    img = np.random.RandomState(1).uniform(-1, 1, (2, 64, 96, 3)) \
        .astype(np.float32)

    expected = jenc.FeatureEncoderS3(output_dim=256, norm_type=norm).apply(
        jvars, jnp.asarray(img))

    enc = tenc.FeatureEncoderS3(output_dim=256, norm_type=norm).eval()
    enc.load_state_dict(_sub(state, "fnet." if which == 0 else "cnet."))
    with torch.inference_mode():
        actual = enc(_nchw(img)).permute(0, 2, 3, 1)
    assert tuple(actual.shape) == expected.shape == (2, 8, 12, 256)
    _close(actual, expected)


def test_update_block_matches_jax(variables, state):
    rs = np.random.RandomState(2)
    b, h, w = 2, 8, 12
    hid = np.tanh(rs.randn(b, h, w, 128)).astype(np.float32)
    ctx = np.maximum(rs.randn(b, h, w, 128), 0).astype(np.float32)
    corr = rs.randn(b, h, w, 4 * 81).astype(np.float32)
    flow = (2 * rs.randn(b, h, w, 2)).astype(np.float32)

    params = variables["params"]["ScanCheckpoint_RaftStep_0"]["BasicUpdateBlock_0"]
    jh, jd = jraft.BasicUpdateBlock(128).apply(
        {"params": params}, jnp.asarray(hid), jnp.asarray(ctx),
        jnp.asarray(corr), jnp.asarray(flow))

    block = traft.BasicUpdateBlock(4 * 81, 128, 128).eval()
    block.load_state_dict(_sub(state, "update_block."))
    with torch.inference_mode():
        th, td = block(_nchw(hid), _nchw(ctx), _nchw(corr), _nchw(flow))
    _close(th.permute(0, 2, 3, 1), jh)
    _close(td.permute(0, 2, 3, 1), jd)
    assert td.dtype == torch.float32


def test_up8_network_matches_jax(variables, state):
    rs = np.random.RandomState(3)
    hid = np.tanh(rs.randn(3, 6, 5, 128)).astype(np.float32)
    flow = (2 * rs.randn(3, 6, 5, 2)).astype(np.float32)

    expected = jraft.Up8Network().apply(
        {"params": variables["params"]["Up8Network_0"]},
        jnp.asarray(hid), jnp.asarray(flow))

    up = traft.Up8Network(128).eval()
    up.load_state_dict(_sub(state, "update_block.mask."))
    with torch.inference_mode():
        actual = up(_nchw(hid), torch.from_numpy(flow))
    assert tuple(actual.shape) == expected.shape == (3, 48, 40, 2)
    _close(actual, expected)


def test_bridge_round_trip_through_chkpt_convert(variables):
    """port state_dict -> chkpt_convert's torch->flax fill -> bridge back:
    identical, with no torch key left unused."""
    model = tmodels.load(_CFG).model
    module = model.init(torch.Generator().manual_seed(5), device="cpu")
    original = module.state_dict()

    torch_state = chkpt_convert._normalize(original, chkpt_convert._RAFT_PFX)
    filled, unused = chkpt_convert._fill_variables(
        variables, torch_state, chkpt_convert._raft_rules())
    assert not unused, sorted(unused)[:5]

    back = convert.jax_variables_to_state_dict(filled)
    assert back.keys() == original.keys()
    for k in original:
        assert torch.equal(back[k], original[k]), k


def test_bridge_loads_strictly_and_rejects_unknown_keys(variables):
    module = tmodels.load(_CFG).model.module
    convert.load_jax_variables(module, variables)  # strict load
    bad = {"params": {"Mystery_0": {"kernel": np.zeros((1, 1, 1, 1))}}}
    with pytest.raises(KeyError, match="Mystery_0"):
        convert.jax_variables_to_state_dict(bad)


@pytest.mark.parametrize("name", ["raft-baseline.yaml",
                                  "raft-baseline-mp.yaml"])
def test_model_configs_load_unchanged_in_both_packages(name):
    path = ROOT / "cfg" / "model" / name
    jspec, tspec = jmodels.load(path), tmodels.load(path)
    assert tspec.id == jspec.id
    assert tspec.model.get_config() == jspec.model.get_config()
    assert tspec.loss.get_config() == jspec.loss.get_config()
    assert tspec.input.get_config() == jspec.input.get_config()
    assert tspec.model.module.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("family", ["raft", "dicl", "raft-avgpool",
                                    "raft-maxpool", "rfpm-raft"])
def test_other_encoder_families_name_the_roadmap(family):
    """Every encoder family of the JAX factory builds (ROADMAP slice 4 item
    4 ported them; their parity with JAX is
    ``tests/test_torch_port_dicl_family.py``): its s3 shape, where it has
    one, and the p35 pyramid, at their output shapes. An unknown family
    raises ``ValueError``, as a pooled family's s3 shape does."""
    from raft_meets_dicl_tpu_torch.models.common import encoders

    img = torch.zeros((1, 3, 64, 64))
    if family in ("raft-avgpool", "raft-maxpool"):
        with pytest.raises(ValueError, match="pyramid"):
            encoders.make_encoder_s3(family, 16, "instance", 0.0)
    else:
        s3 = encoders.make_encoder_s3(family, 16, "instance", 0.0)
        assert tuple(s3(img).shape) == (1, 16, 8, 8)
    p35 = encoders.make_encoder_p35(family, 16, "instance", 0.0)
    assert [tuple(o.shape) for o in p35(img)] == [
        (1, 16, 8, 8), (1, 16, 4, 4), (1, 16, 2, 2)]
    with pytest.raises(ValueError):
        encoders.make_encoder_s3("nope", 256, "instance", 0.0)
