"""PyTorch port: wire formats (``models/wire.py``) and the loader's healing
fetch held against the JAX package on the CPU.

- encode, per preset (f32, bf16, u8): image bytes (bf16: its bits), f16
  flow and the packed valid mask equal to JAX's, at a width that is a
  multiple of 8 and one that is not;
- decode on the device (torch) within one float32 ulp of JAX's jitted
  decode, the valid mask unpacked exactly; the host decode bit for bit;
- one train step and one eval step per preset against JAX
  ``make_train_step(..., wire=)`` / ``make_eval_step(..., wire=)``, the
  port's eval step being ``evaluation.make_eval_fn(..., wire=)``, which
  validation, serving and ``main evaluate`` run: the cut
  ``raft/baseline`` of ``tests/test_torch_port_train.py`` at 2x16x24, the
  same weights through ``convert``, that file's bounds; the port on the
  f32 wire within ``LOSS_REL`` of the port on host-normalized images;
- JAX's legacy bf16 image put for mixed-precision models: the port's bf16
  policy rounds the images at the first convolutions anyway, so the first
  step's loss and gradients are bit for bit the same with and without it;
- the Loader with a wire format over a tree with one corrupt PNG: JAX's
  batches bit for bit at 0 and 2 workers and at 2 through ``procs``, one
  substitution an epoch counted over both epochs; budget 0 re-raises the decode error, an
  exceeded budget raises;
- ``main serve`` with ``wire-format: u8`` at a 64x96 bucket: request 0
  against the in-process forward of its host-decoded images.
"""

import concurrent.futures
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu.strategy.spec as jspec
from raft_meets_dicl_tpu import data as jdata
from raft_meets_dicl_tpu.models import input as jinput
from raft_meets_dicl_tpu.models import wire as jwire
from raft_meets_dicl_tpu.parallel import TrainState as JTrainState
from raft_meets_dicl_tpu.parallel import make_eval_step as jmake_eval_step
from raft_meets_dicl_tpu.parallel import make_train_step as jmake_train_step
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert, evaluation, parallel, strategy
from raft_meets_dicl_tpu_torch import data as tdata
from raft_meets_dicl_tpu_torch import main as tmain
from raft_meets_dicl_tpu_torch.data import io as tio
from raft_meets_dicl_tpu_torch.models import input as tinput
from raft_meets_dicl_tpu_torch.models import wire as twire
from raft_meets_dicl_tpu_torch.serve import loadgen
from test_torch_port_train import (GRADIENT, LOSS_REL, OPTIMIZER,
                                   _cfg, _check_grads, _one_thread)
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

PRESETS = ("f32", "bf16", "u8")
CLIP, RANGE = (0.0, 1.0), (-1.0, 1.0)
SHAPE = (16, 24)
LR = 1e-3
# final flow of one step / one eval, float32 on both sides
FLOW_ATOL = 1e-4
# the device decode against JAX's: XLA fuses the two scalings of
# ``decode_image`` into one product and rounds once where torch (and the
# numpy host decode) round twice, so values near 0 that cancel part of
# ``rmin`` differ by up to half an ulp at |x| = 1 (reads <= 2.98e-8)
DECODE_ATOL = float(np.spacing(np.float32(1.0)))


def _wires(preset):
    return (jwire.WireFormat.from_config(preset, clip=CLIP, range=RANGE),
            twire.WireFormat.from_config(preset, clip=CLIP, range=RANGE))


def _bytes(x):
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.dtype.itemsize, np.ascontiguousarray(x).view(np.uint8)


def _raw(width, seed=0):
    """Raw images past the clip interval, flow with FLOW_INF markers and
    values f16 cannot hold, a valid mask."""
    rs = np.random.RandomState(seed)
    img = rs.uniform(-0.1, 1.1, (2, 5, width, 3)).astype(np.float32)
    flow = (40 * rs.randn(2, 5, width, 2)).astype(np.float32)
    flow[0, 0, 0] = (1e10, -1e10)
    flow[1, 1, 1] = (7e4, -7e4)
    valid = rs.rand(2, 5, width) > 0.3
    return img, flow, valid


@pytest.mark.parametrize("width", [24, 13])
@pytest.mark.parametrize("preset", PRESETS)
def test_encode_is_byte_equal_to_jax(preset, width):
    jw, tw = _wires(preset)
    img, flow, valid = _raw(width)

    expected = _bytes(jw.encode_image(img))
    actual = tw.encode_image(img)
    size, data = _bytes(actual)
    assert size == expected[0] and np.array_equal(data, expected[1])
    assert twire.as_tensor(actual).dtype == tw.image_dtype()

    jbatch = jw.encode_batch((None, None, flow, valid))
    for a, e in zip((tw.encode_flow(flow), tw.encode_valid(valid)),
                    jbatch[2:]):
        assert _bytes(a)[0] == _bytes(e)[0]
        assert np.array_equal(_bytes(a)[1], _bytes(e)[1])


@pytest.mark.parametrize("preset", PRESETS)
def test_decode_matches_jax(preset):
    jw, tw = _wires(preset)
    img, flow, valid = _raw(13, seed=1)
    wimg = tw.encode_image(img)
    wflow, wvalid = tw.encode_flow(flow), tw.encode_valid(valid)

    jargs = jw.encode_image(img), jw.encode_batch((None, None, flow, valid))
    j1, _, jflow, jvalid = jax.jit(jw.decode)(
        jargs[0], jargs[0], jargs[1][2], jargs[1][3])
    t1, _, tflow, tvalid = tw.decode(
        twire.as_tensor(wimg), twire.as_tensor(wimg),
        torch.from_numpy(np.asarray(wflow)),
        torch.from_numpy(np.asarray(wvalid)))
    j1 = np.asarray(j1)
    assert t1.dtype == torch.float32
    assert np.abs(t1.numpy() - j1).max() <= DECODE_ATOL
    np.testing.assert_array_equal(tflow.numpy(), np.asarray(jflow))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert tvalid.dtype == torch.bool and tvalid.shape == valid.shape

    # the host decode: JAX's bit for bit, and the device decode's too
    host = tw.decode_images_host(wimg)
    np.testing.assert_array_equal(host, jw.decode_images_host(jargs[0]))
    np.testing.assert_array_equal(t1.numpy(), host)


@pytest.fixture(scope="module")
def raw_batch():
    rs = np.random.RandomState(3)
    img1, img2 = (rs.rand(2, *SHAPE, 3).astype(np.float32) for _ in range(2))
    flow = (3 * rs.randn(2, *SHAPE, 2)).astype(np.float32)
    valid = rs.rand(2, *SHAPE) > 0.2
    return img1, img2, flow, valid


@pytest.fixture(scope="module")
def variables():
    model = jmodels.load(_cfg()).model
    x = jnp.zeros((1, *SHAPE, 3))
    init = jax.jit(lambda k: model.init(k, x, x))(jax.random.PRNGKey(4))
    return jax.tree.map(np.asarray, init)


@pytest.fixture(scope="module")
def jax_runs(raw_batch, variables):
    """Per preset, JAX's wired train step (its aux) and eval step (the
    final flow) on the batch encoded by JAX's wire. The six programs
    compile in threads side by side (XLA compiles without the GIL)."""
    img1, img2, flow, valid = raw_batch

    def run(preset):
        jw = _wires(preset)[0]
        jm = jmodels.load(_cfg())
        jm.model.on_stage(None, freeze_batchnorm=True)
        jtx, _ = jspec.OptimizerSpec.from_config(OPTIMIZER).build(
            jspec.GradientSpec.from_config(GRADIENT))
        jstep = jmake_train_step(jm.model, jm.loss, jtx, external_lr=True,
                                 with_grads=True, donate=False, wire=jw)
        batch = jw.encode_batch((jw.encode_image(img1),
                                 jw.encode_image(img2), flow, valid))
        state = JTrainState.create(jax.tree.map(jnp.asarray, variables), jtx)
        _, aux = jstep(state, LR, *batch)
        final = jmake_eval_step(jm.model, wire=jw)(variables, batch[0],
                                                    batch[1])
        return jax.tree.map(np.asarray, aux), np.asarray(final)

    with concurrent.futures.ThreadPoolExecutor(len(PRESETS)) as pool:
        return dict(zip(PRESETS, pool.map(run, PRESETS)))


def _port(variables, cfg=None):
    tm = tmodels.load(cfg or _cfg())
    tm.model.init(device="cpu")
    convert.load_jax_variables(tm.model.module, variables)
    tm.model.on_stage(None, freeze_batchnorm=True)
    return tm


def _port_step(tm, wire, batch):
    tx, _ = strategy.spec.OptimizerSpec.from_config(OPTIMIZER).build(
        tm.model.module.parameters(),
        strategy.spec.GradientSpec.from_config(GRADIENT))
    step = parallel.make_train_step(tm.model, tm.loss, with_grads=True,
                                    wire=wire)
    with torch.backends.mkldnn.flags(enabled=False), _one_thread():
        _, aux = step(parallel.TrainState(tm.model, tx), LR, *batch)
    return aux


def _tensors(batch):
    return [twire.as_tensor(np.asarray(x)) for x in batch]


@pytest.mark.parametrize("preset", PRESETS)
def test_wire_steps_match_jax(preset, raw_batch, variables, jax_runs):
    tw = _wires(preset)[1]
    img1, img2, flow, valid = raw_batch
    jaux, jflow = jax_runs[preset]

    tbatch = (tw.encode_image(img1), tw.encode_image(img2),
              tw.encode_flow(flow), tw.encode_valid(valid))
    tm = _port(variables)
    taux = _port_step(tm, tw, _tensors(tbatch))

    loss = float(jaux["loss"])
    assert abs(float(taux["loss"]) - loss) <= LOSS_REL * abs(loss)
    np.testing.assert_allclose(taux["final"].numpy(), jaux["final"],
                               rtol=0, atol=FLOW_ATOL)
    expected = {k: v.numpy() for k, v in convert.jax_variables_to_state_dict(
        {"params": jaux["grads"]}).items()}
    _check_grads(expected, {k: g.numpy() for k, g in taux["grads"].items()})
    # the decoded targets the loss read
    np.testing.assert_array_equal(taux["valid"].numpy(), valid)

    tm = _port(variables)
    with torch.backends.mkldnn.flags(enabled=False), _one_thread():
        _, tflow = evaluation.make_eval_fn(tm.model, wire=tw)(
            *_tensors(tbatch[:2]))
    np.testing.assert_allclose(tflow.numpy(), jflow, rtol=0, atol=FLOW_ATOL)

    if preset == "f32":
        # the f32 wire normalizes on the device what the host did before
        norm = [twire.as_tensor(tw.decode_images_host(x)) for x in tbatch[:2]]
        plain = _port_step(_port(variables), None,
                           norm + _tensors(tbatch[2:]))
        assert abs(float(taux["loss"]) - float(plain["loss"])) \
            <= LOSS_REL * abs(float(plain["loss"]))


def test_bf16_image_put_is_a_no_op_under_the_bf16_policy(raw_batch,
                                                         variables):
    """JAX puts a mixed-precision model's host-normalized images as
    bfloat16 when no wire format is set; the port's policy rounds them at
    the first convolutions, so the step is bit for bit the same."""
    cfg = _cfg()
    cfg["model"]["parameters"]["mixed-precision"] = True
    img1, img2, flow, valid = (torch.from_numpy(x) for x in raw_batch)
    img1, img2 = 2 * img1 - 1, 2 * img2 - 1
    rounded = [x.to(torch.bfloat16).float() for x in (img1, img2)]
    assert not torch.equal(rounded[0], img1)

    plain = _port_step(_port(variables, cfg), None, [img1, img2, flow, valid])
    put = _port_step(_port(variables, cfg), None, [*rounded, flow, valid])
    assert torch.equal(plain["loss"], put["loss"])
    for name, g in plain["grads"].items():
        assert torch.equal(g, put["grads"][name]), name


# -- the loader: wire and healing ------------------------------------------------

PAIRS = 5
FRAME = (20, 28)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """6 frames (5 pairs) with .flo flows; frame 0 is a truncated PNG, so
    pair 0 fails to decode and pair 1 takes its place."""
    root = tmp_path_factory.mktemp("heal")
    rs = np.random.RandomState(5)
    (root / "frames").mkdir()
    (root / "flows").mkdir()
    for i in range(PAIRS + 1):
        path = root / "frames" / f"frame_{i:04d}.png"
        cv2.imwrite(str(path), rs.randint(0, 256, (*FRAME, 3), np.uint8))
        tio.write_flow_mb(root / "flows" / f"frame_{i:04d}.flo",
                          (2 * rs.randn(*FRAME, 2)).astype(np.float32))
    corrupt = root / "frames" / "frame_0000.png"
    corrupt.write_bytes(corrupt.read_bytes()[:60])
    (root / "spec.yaml").write_text(
        "name: heal\nid: heal\npath: .\nlayout:\n  type: generic\n"
        "  images: 'frames/frame_{idx:04d}.png'\n"
        "  flows: 'flows/frame_{idx:04d}.flo'\n  key: 'heal/{idx:04d}'\n")
    (root / "source.yaml").write_text("type: dataset\nspec: spec.yaml\n")
    return root


def _spec(module):
    return module.InputSpec(
        CLIP, RANGE, module.ModuloPadding("zeros", [8, 8]))


def _jax_batches(tree, wire, epochs=2, **kwargs):
    jw = jwire.WireFormat.from_config(wire, clip=CLIP, range=RANGE)
    source = jdata.load(tree / "source.yaml")
    loader = _spec(jinput).apply(source, normalize=jw is None).jax(
        wire=jw).loader(batch_size=2, shuffle=True, seed=3, num_workers=0,
                        retries=1, **kwargs)
    return [list(loader) for _ in range(epochs)], loader


def _port_loader(tree, wire, workers, wire_targets=False, **kwargs):
    """``workers`` worker processes; "procs" asks for 2 through the
    loader's ``procs`` (the JAX decode processes' knob) over 0 workers."""
    tw = twire.WireFormat.from_config(wire, clip=CLIP, range=RANGE)
    source = tdata.load(tree / "source.yaml")
    if workers == "procs":
        kwargs["procs"], workers = 2, 0
    loader = _spec(tinput).apply(source, normalize=tw is None).torch(
        wire=tw, wire_targets=wire_targets).loader(
            batch_size=2, shuffle=True, seed=3, num_workers=workers,
            retries=1, **kwargs)
    assert loader.num_workers == (2 if "procs" in kwargs else workers)
    return loader


@pytest.mark.parametrize("workers", [0, 2, "procs"])
@pytest.mark.parametrize("wire", [None, "bf16", "u8"])
def test_healed_wire_batches_match_jax(tree, wire, workers):
    """Targets exact, as JAX's adapter leaves them; and the training
    adapter's (``wire_targets``), equal to JAX's put-time compression of
    the same batches."""
    expected, jloader = _jax_batches(tree, wire, bad_sample_budget=4)
    jw = jwire.WireFormat.from_config(wire, clip=CLIP, range=RANGE)
    loader = _port_loader(tree, wire, workers, bad_sample_budget=4)
    training = _port_loader(tree, wire, workers, wire_targets=True,
                            bad_sample_budget=4)
    for e, epoch in enumerate(expected):
        actual = list(loader)
        assert len(actual) == len(epoch) == 3
        encoded = [x[:4] for x in training]
        for a, t, b in zip(actual, encoded, epoch):
            put = b[:4] if jw is None else jw.encode_batch(b[:4])
            for x, y in (*zip(a[:4], b[:4]), *zip(t, put)):
                assert _bytes(x)[0] == _bytes(y)[0]
                assert np.array_equal(_bytes(x)[1], _bytes(y)[1])
            assert [str(m.sample_id) for m in a[4]] == \
                [str(m.sample_id) for m in b[4]]
        # one substitution an epoch, counted across the workers' epochs
        assert loader.bad_samples == e + 1
    assert jloader._bad_samples == 2
    ids = [str(m.sample_id) for b in expected[0] for m in b[4]]
    assert "heal/0000" not in ids and ids.count("heal/0001") == 2


@pytest.mark.parametrize("workers", [0, 2])
def test_bad_sample_budget(tree, workers):
    with pytest.raises(ValueError, match="could not decode image file"):
        list(_port_loader(tree, "u8", workers, bad_sample_budget=0))
    loader = _port_loader(tree, "u8", workers, bad_sample_budget=1)
    list(loader)
    with pytest.raises(RuntimeError, match="bad-sample budget exceeded"):
        list(loader)


# -- serving u8 ----------------------------------------------------------------


def test_serve_u8_on_cpu(tmp_path):
    """``wire-format: u8``: requests encoded on the host, decoded in the
    step; request 0, dispatched alone, against the in-process forward of
    its host-decoded images with the same weights: equal up to float
    rounding."""
    cfg = _cfg()
    cfg["input"] = {"clip": [0, 1], "range": [-1, 1],
                    "padding": {"type": "modulo", "mode": "zeros",
                                "size": [8, 8]}}
    (tmp_path / "model.json").write_text(json.dumps(cfg))
    (tmp_path / "serve.yaml").write_text(
        "serve:\n  model: model.json\n  buckets: 64x96\n"
        "  wire-format: u8\n  batch-size: 1\n  max-wait-ms: 1\n"
        "  requests: 4\n  rate: 100\n")
    with torch.backends.mkldnn.flags(enabled=False), _one_thread():
        report = tmain.main(["serve", "-c", str(tmp_path / "serve.yaml"),
                             "--device", "cpu"])
    assert report["completed"] == 4 and report["nonfinite"] == 0
    assert report["wire"] == "images=u8, flow=f16, valid=packed"
    assert report["warmup"][0]["wire"] == report["wire"]

    img1, img2 = loadgen.synthetic_pair((64, 96), np.random.default_rng(0))
    wire = twire.WireFormat.from_config("u8", clip=CLIP, range=RANGE)
    x1, x2 = (torch.from_numpy(wire.decode_images_host(
        wire.encode_image(x)))[None] for x in (img1, img2))
    spec = tmodels.load(cfg)
    spec.model.init(torch.Generator().manual_seed(0), "cpu")
    with torch.backends.mkldnn.flags(enabled=False), _one_thread(), \
            torch.inference_mode():
        out = spec.model.apply(x1, x2, train=False)
        flow = spec.model.get_adapter().wrap_result(out, (64, 96)).final()
    assert np.abs(report["results"][0].flow - flow[0].numpy()).max() <= 1e-6
