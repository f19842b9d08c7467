"""PyTorch port: ``ops/convex.py`` (the ``convex_combine_8x`` kernel
module) held against the JAX package's Pallas kernel and its XLA
reference, on the CPU.

The CUDA kernels themselves only run on the card (``chip_smoke.py`` holds
them against ``convex_combine_8x_reference`` there); here the plain version
is checked against both JAX forms, and the wrapper's CPU dispatch, counter,
build failure and refusal of CPU tensors on the kernel route are pinned.
The backward's plain version is held against JAX in
``test_torch_port_train.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_meets_dicl_tpu.ops import pallas as jax_pallas
from raft_meets_dicl_tpu_torch.ops import convex, cuda_build
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# float32 softmax + 9-term sums in a different order: a few ulps of values
# of magnitude ~10 (the window below) stay well inside 1e-5
ATOL = 1e-5
M = 700  # not a multiple of the TPU kernel's 512-row tile, nor of 4 rows


def _inputs(seed, dtype):
    rs = np.random.RandomState(seed)
    logits = (4 * rs.randn(M, 576)).astype(np.float32)
    if dtype == "bfloat16":
        # round once through bf16 so both frameworks see identical values
        logits = torch.from_numpy(logits).to(torch.bfloat16).float().numpy()
    win = (8 * rs.randn(M, 18)).astype(np.float32)
    return logits, win


def _torch_logits(logits, dtype):
    t = torch.from_numpy(logits)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_form", ["reference", "interpret"])
def test_reference_matches_jax(dtype, jax_form):
    logits, win = _inputs(11, dtype)
    jl = jnp.asarray(logits, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    if jax_form == "reference":
        expected = jax_pallas._combine_reference(jl, jnp.asarray(win), 0.25)
    else:
        expected = jax_pallas._run_fwd_interpret(jl, jnp.asarray(win), 0.25)

    actual = convex.convex_combine_8x_reference(
        _torch_logits(logits, dtype), torch.from_numpy(win), 0.25)
    assert actual.dtype == torch.float32 and actual.shape == (M, 128)
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               rtol=0, atol=ATOL)


def test_wrapper_cpu_path_uses_plain_version_and_counts_nothing():
    logits, win = _inputs(3, "float32")
    before = convex.launches
    out = convex.convex_combine_8x(
        torch.from_numpy(logits).reshape(7, 100, 576),
        torch.from_numpy(win).reshape(7, 100, 9, 2), temperature=4.0)
    assert convex.launches == before
    assert out.shape == (7, 100, 128)
    expected = convex.convex_combine_8x_reference(
        torch.from_numpy(logits), torch.from_numpy(win), 0.25)
    assert torch.equal(out.reshape(M, 128), expected)


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError, match="576"):
        convex.convex_combine_8x(torch.zeros(4, 575), torch.zeros(4, 9, 2))
    with pytest.raises(ValueError, match="window shape"):
        convex.convex_combine_8x(torch.zeros(4, 576), torch.zeros(4, 18))


def test_kernel_library_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("convex_combine_8x")
    assert not any(tmp_path.iterdir())


def test_backward_is_not_ported_yet():
    """The autograd pair's backward runs the CUDA kernel and nothing else:
    handed CPU tensors it raises instead of computing the plain version
    (on the CPU, autograd of the plain version is the backward)."""
    logits, win = _inputs(4, "float32")

    class Ctx:
        saved_tensors = (torch.from_numpy(logits), torch.from_numpy(win))
        inv_temp = 0.25

    before = (convex.launches, convex.bwd_launches)
    with pytest.raises(ValueError, match="CUDA"):
        convex._ConvexCombine8x.backward(Ctx, torch.zeros(M, 128))
    with pytest.raises(ValueError, match="CUDA"):
        convex._launch(*Ctx.saved_tensors, 0.25)
    assert (convex.launches, convex.bwd_launches) == before
