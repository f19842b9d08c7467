"""PyTorch port: serving on the CPU (session + scheduler + open-loop load),
the ``serve`` command's device rule, and the port's isolation from JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import serve
from raft_meets_dicl_tpu_torch.serve import loadgen
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).parent.parent
MODEL_CFG = ROOT / "cfg" / "model" / "raft-baseline.yaml"


def _spec():
    cfg = {
        "name": "RAFT baseline", "id": "raft/baseline",
        "model": {"type": "raft/baseline", "parameters": {},
                  "arguments": {"iterations": 2}},
        "loss": {"type": "raft/sequence"},
        "input": {"clip": [0, 1], "range": [-1, 1],
                  "padding": {"type": "modulo", "mode": "zeros",
                              "size": [8, 8]}},
    }
    return tmodels.load(cfg)


def test_cpu_serving_returns_the_direct_forward_of_each_padded_pair():
    session = serve.ServeSession(_spec(), "64x96", batch_size=2,
                                 device="cpu")
    assert [o["bucket"] for o in session.warm_pool()] == ["64x96"]
    scheduler = serve.Scheduler(session, max_wait_ms=20).start()
    shapes = [(64, 96), (56, 88)]
    try:
        report = loadgen.run_open_loop(scheduler, shapes, requests=4,
                                       rate_hz=50, seed=9)
    finally:
        scheduler.stop()

    assert report["completed"] == 4 and not report["errors"]
    assert not report["rejected"]
    assert scheduler.batches >= 2 and scheduler.errors == 0

    # regenerate the same raw pairs and run each alone, padded to the bucket
    rng = np.random.default_rng(9)
    for i, result in enumerate(report["results"]):
        h, w = shapes[i % len(shapes)]
        img1, img2 = loadgen.synthetic_pair((h, w), rng)
        assert result.shape == (h, w) and result.bucket == (64, 96)
        # zero padding in normalized space (the model config's 'zeros')
        x1 = session.encode_image(session.buckets.pad_image(img1, (64, 96)))
        x2 = session.encode_image(session.buckets.pad_image(img2, (64, 96)))
        assert np.all(x1[h:] == 0) and np.all(x1[:, w:] == 0)
        x1, x2 = x1[None], x2[None]
        direct = session.fetch(session.run(x1, x2))[0, :h, :w]
        assert result.flow.shape == (h, w, 2)
        np.testing.assert_allclose(result.flow, direct, rtol=0, atol=1e-4)


def test_scheduler_typed_admission_errors():
    session = serve.ServeSession(_spec(), "64x96", batch_size=2,
                                 device="cpu")
    scheduler = serve.Scheduler(session)
    with pytest.raises(serve.ServeError) as e:
        scheduler.submit(np.zeros((72, 96, 3), np.float32),
                         np.zeros((72, 96, 3), np.float32))
    assert e.value.kind == "oversized"
    with pytest.raises(serve.ServeError) as e:
        scheduler.submit(np.zeros((64, 96), np.float32),
                         np.zeros((64, 96), np.float32))
    assert e.value.kind == "malformed"


def test_dispatch_failure_completes_tickets_with_a_typed_cause():
    session = serve.ServeSession(_spec(), "64x96", batch_size=2,
                                 device="cpu")

    def broken(img1, img2):
        raise RuntimeError("kernel fault")

    session.run = broken
    scheduler = serve.Scheduler(session, max_wait_ms=1).start()
    try:
        ticket = scheduler.submit(np.zeros((64, 96, 3), np.float32),
                                  np.zeros((64, 96, 3), np.float32))
        with pytest.raises(serve.ServeError) as e:
            ticket.result(timeout=30)
    finally:
        scheduler.stop()
    assert e.value.kind == "internal"
    assert isinstance(e.value.__cause__, RuntimeError)
    assert scheduler.errors == 1 and scheduler.batches == 0


def test_session_rejects_unported_options():
    """``mesh`` is still refused by name; ``video`` is ported and builds
    its warm-start step on the CPU."""
    with pytest.raises(NotImplementedError, match="ROADMAP slice 7 item 6"):
        serve.ServeSession(_spec(), "64x96", mesh="-1", device="cpu")
    session = serve.ServeSession(_spec(), "64x96", video=True, device="cpu")
    assert session.video and session._warm_fn.warm
    assert session.warm_iterations == session._warm_fn.iterations


def test_session_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.ServeSession(_spec(), "64x96", device="cuda")


def test_serve_command_defaults_to_cuda(tmp_path):
    """Without --device the command runs on CUDA; here, with no CUDA, it
    exits non-zero naming it instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tmp_path / "serve.yaml"
    cfg.write_text(f"serve:\n  model: {MODEL_CFG}\n  buckets: 64x96\n"
                   "  requests: 1\n")
    proc = subprocess.run(
        [sys.executable, "-m", "raft_meets_dicl_tpu_torch.main", "serve",
         "-c", str(cfg)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "torch.cuda.is_available()" in proc.stderr


_FORBIDDEN = ("jax", "flax", "optax", "raft_meets_dicl_tpu")


def _imported_top_levels(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "raft_meets_dicl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the lookup kernels, the quantized tier, the scripts subpackage and
    # the video engine
    for new in ("ops/lookup.py", "ops/quant.py", "scripts/__init__.py",
                "scripts/probe_fused_lookup.py", "video/cache.py",
                "video/sequence.py", "video/warmstart.py"):
        assert ROOT / "raft_meets_dicl_tpu_torch" / new in files, new
    for path in files:
        for top in _imported_top_levels(path):
            # exact names: 'raft_meets_dicl_tpu_torch' is the port itself
            assert top not in _FORBIDDEN, f"{path.relative_to(ROOT)} imports {top}"
