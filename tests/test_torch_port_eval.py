"""PyTorch port: ``main evaluate`` held against the JAX package's on the
CPU.

Both commands run in this process, once per case (a module-scoped
fixture), on a 3-pair 64x96 tree with the tiny raft/baseline of
``tests/test_torch_port_inspect.py``, from one JAX-written checkpoint;
the JAX side on one CPU device (``--device cpu --device-ids 0``) with no
compile cache or AOT store. Each case writes one of the 12 flow formats
and covers an option: ``--flow-only``, ``--fwbw``, ``--iterations`` and
``RMD_ITERATIONS``, ``--buckets`` (sizes and ``group``) and
``RMD_EVAL_BUCKETS`` and ``--incremental``. Held: the
sample ids and their order, per-sample metrics and the summary within
the bounds below, the incremental JSONL equal to the report, and every
flow file (``.flo`` within 1e-4 px, KITTI PNGs within one 16-bit level,
the other PNGs within one u8 level). Also: the generator's batches and
padding, the refused flags and the CUDA device rule.
"""

import contextlib
import json
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models.model as jmodel
import raft_meets_dicl_tpu.strategy.checkpoint as jchk
from raft_meets_dicl_tpu import models as jmodels
from raft_meets_dicl_tpu.main import main as jax_main
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import evaluation as teval
from raft_meets_dicl_tpu_torch import main as tmain
from raft_meets_dicl_tpu_torch.data import io as tio
from raft_meets_dicl_tpu_torch.models import input as tinput
from raft_meets_dicl_tpu_torch.strategy import checkpoint as tchk
from raft_meets_dicl_tpu_torch.utils import config as tconfig
from test_torch_port_inspect import FRACTION_ATOL, LOSS_REL, _tiny_cfg

pytestmark = pytest.mark.torch_port

SHAPE = (64, 96)
PAIRS = 3
# the final flow of the tiny model, float32 on both sides (sums in
# another order): per-sample mean EPE ...
EPE_ATOL = 1e-4
EPE_REL = 1e-6
# ... and the loss (LOSS_REL), 1px/3px/5px fractions and Fl-all
# (FRACTION_ATOL) of tests/test_torch_port_inspect.py
FLO_ATOL = 1e-4       # px, a .flo file's values
KITTI_LEVELS = 1      # 16-bit levels (1/64 px) of a KITTI flow PNG
PNG_LEVELS = 1        # u8 levels of a visual PNG
FWBW_RATIO_ATOL = FRACTION_ATOL   # the share of occluded pixels
FWBW_CONF_ATOL = 1e-4             # the mean confidence, rounded to 1e-5

# case: (arguments, environment, flow format); "{out}" is the case's
# output directory on each side
CASES = {
    "flo": (["-b", "2", "-o", "{out}/report.json"], {}, "flow:flo"),
    "kitti": (["-b", "3", "--flow-only"], {}, "flow:kitti"),
    "epe": (["-b", "2", "-o", "{out}/report.json", "--buckets", "72x104"],
            {}, "visual:epe"),
    "bp-fl": (["-b", "2", "-o", "{out}/report.json"],
              {"RMD_EVAL_BUCKETS": "group"}, "visual:bp-fl"),
    "flow": (["-b", "2", "-o", "{out}/report.json", "--iterations", "3",
              "--flow-mrm", "6", "--flow-gamma", "0.8"], {}, "visual:flow"),
    "flow-dark": (["-b", "2", "--flow-only", "--flow-transform", "log"],
                  {"RMD_ITERATIONS": "3"}, "visual:flow:dark"),
    "flow-gt": (["-b", "3", "-o", "{out}/report.json", "--incremental",
                 "{out}/inc/samples.jsonl"], {}, "visual:flow:gt"),
    "i1": (["--flow-only", "-b", "2"], {}, "visual:i1"),
    "warp": (["--flow-only"], {}, "visual:warp:backwards"),
    "intermediate": (["--flow-only", "-b", "2"], {},
                     "visual:intermediate:flow"),
    "occlusion": (["--fwbw", "-b", "2", "-o", "{out}/report.json",
                   "--no-incremental"], {}, "visual:occlusion"),
    "confidence": (["--fwbw", "--flow-only", "--buckets", "group", "-b",
                    "2"], {}, "visual:confidence"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU forwards on one thread: the suite runs its files in
    parallel workers, and torch's thread pool in each would oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 frames (3 pairs) at 64x96 with .flo flows, a source yaml, the
    tiny model and its JAX-initialized weights as a JAX checkpoint."""
    root = tmp_path_factory.mktemp("eval")
    rs = np.random.RandomState(21)
    (root / "frames").mkdir()
    (root / "flows").mkdir()
    for i in range(PAIRS + 1):
        cv2.imwrite(str(root / "frames" / f"frame_{i:04d}.png"),
                    rs.randint(0, 256, (*SHAPE, 3), dtype=np.uint8))
        tio.write_flow_mb(root / "flows" / f"frame_{i:04d}.flo",
                          (2 * rs.randn(*SHAPE, 2)).astype(np.float32))
    (root / "val.yaml").write_text(
        "name: val\nid: val\npath: .\nlayout:\n  type: generic\n"
        "  images: 'frames/frame_{idx:04d}.png'\n"
        "  flows: 'flows/frame_{idx:04d}.flo'\n  key: 'val/{idx:04d}'\n")
    (root / "source.yaml").write_text("type: dataset\nspec: val.yaml\n")
    (root / "model.json").write_text(json.dumps(_tiny_cfg()))

    spec = jmodels.load(_tiny_cfg())
    x = jnp.zeros((1, *SHAPE, 3))
    variables = jax.jit(lambda k: spec.model.init(k, x, x))(
        jax.random.PRNGKey(11))
    _inits[_config_key(spec.model)] = variables
    jchk.Checkpoint(
        model="raft/baseline", iteration=jchk.Iteration(0, None, 0),
        metrics=None,
        state=jchk.State(jax.tree.map(np.asarray, variables), {}, {}, [], []),
        metadata={"source": "init"}).save(root / "init.ckpt")
    return root


# variables of the JAX model by config, for the JAX command's model.init
_inits = {}


def _config_key(model):
    return json.dumps(model.get_config(), sort_keys=True)


def _kept_init(self, rng, img1, img2, **kwargs):
    """The JAX command's ``model.init``: the variables the tree's
    checkpoint was written from. They only give the checkpoint's structure
    (which does not depend on the image shape; the checkpoint replaces
    every leaf), and an eager init takes seconds a run."""
    return _inits[_config_key(self)]


def _argv(tree, out, case):
    args, env, fmt = CASES[case]
    argv = ["evaluate", "-d", str(tree / "source.yaml"), "-m",
            str(tree / "model.json"), "-c", str(tree / "init.ckpt"),
            "-f", str(out / "flows"), "--flow-format", fmt]
    return argv + [a.format(out=out) for a in args], env


@contextlib.contextmanager
def _environment(env):
    with pytest.MonkeyPatch.context() as mp:
        for name in ("RMD_ITERATIONS", "RMD_EVAL_BUCKETS"):
            mp.delenv(name, raising=False)
        for name, value in env.items():
            mp.setenv(name, value)
        yield mp


def _run_jax(argv, env):
    with _environment(env) as mp:
        mp.setenv("RMD_NO_COMPILE_CACHE", "1")
        mp.setenv("RMD_AOT", "0")
        mp.setattr(jmodel.Model, "init", _kept_init)
        mp.setattr(sys, "argv", ["main.py", *argv, "--device", "cpu",
                                 "--device-ids", "0"])
        try:
            jax_main()
        finally:
            jax.config.update("jax_default_device", None)


def _run_port(argv, env):
    # true float32 convolutions, as the JAX side runs at 'highest'
    with _environment(env), torch.backends.mkldnn.flags(enabled=False):
        return tmain.main([*argv, "--device", "cpu", "--device-ids", "0"])


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request, tree):
    """One case, both commands: their output directories and the port's
    returned report."""
    case = request.param
    outs = {}
    for side in ("jax", "port"):
        out = tree / case / side
        out.mkdir(parents=True)
        argv, env = _argv(tree, out, case)
        if side == "jax":
            _run_jax(argv, env)
        else:
            outs["report"] = _run_port(argv, env)
        outs[side] = out
    outs["case"] = case
    return outs


def _report(out):
    files = sorted(out.glob("report.*"))
    return tconfig.load(files[0]) if files else None


def _close(actual, expected, atol, rel=0.0):
    return abs(actual - expected) <= atol + rel * abs(expected)


def _metric_problems(actual, expected):
    problems = []
    assert list(actual) == list(expected)
    for k, e in expected.items():
        a = actual[k]
        if k.endswith("/mean"):
            ok = _close(a, e, EPE_ATOL, EPE_REL)
        elif k == "Loss":
            ok = _close(a, e, 0.0, LOSS_REL)
        else:
            ok = _close(a, e, FRACTION_ATOL)
        if not ok:
            problems.append(f"{k}: {a} vs {e}")
    return problems


def test_report_matches_jax(run):
    expected, actual = _report(run["jax"]), _report(run["port"])
    if expected is None:
        assert actual is None and run["report"]["samples"] == []
        return
    assert [s["id"] for s in actual["samples"]] == \
        [s["id"] for s in expected["samples"]] == \
        [f"val/{i:04d}" for i in range(PAIRS)]
    problems = []
    for a, e in zip(actual["samples"], expected["samples"]):
        problems += [f"{e['id']} {p}"
                     for p in _metric_problems(a["metrics"], e["metrics"])]
        assert ("fwbw" in a) == ("fwbw" in e)
        if "fwbw" in e:
            fa, fe = a["fwbw"], e["fwbw"]
            assert _close(fa["occlusion_ratio"], fe["occlusion_ratio"],
                          FWBW_RATIO_ATOL), (fa, fe)
            assert _close(fa["confidence_mean"], fe["confidence_mean"],
                          FWBW_CONF_ATOL), (fa, fe)
    assert list(actual["summary"]) == list(expected["summary"]) == ["mean"]
    problems += [f"summary {p}" for p in _metric_problems(
        actual["summary"]["mean"], expected["summary"]["mean"])]
    assert not problems
    # the returned report is the stored one
    assert json.loads(json.dumps(run["report"]["samples"])) == \
        actual["samples"]


def test_incremental_jsonl_matches_report(run):
    args = CASES[run["case"]][0]
    names = {"jax": None, "port": None}
    for side in names:
        if "--incremental" in args:
            path = run[side] / "inc" / "samples.jsonl"
        else:
            path = run[side] / "report.samples.jsonl"
        names[side] = path if path.exists() else None
    assert (names["port"] is None) == (names["jax"] is None)
    if names["port"] is None:
        # no report, or --no-incremental
        assert "-o" not in args or "--no-incremental" in args
        return
    lines = [json.loads(x) for x in names["port"].read_text().splitlines()]
    assert lines == _report(run["port"])["samples"]
    jlines = names["jax"].read_text().splitlines()
    assert [x["id"] for x in lines] == [json.loads(x)["id"] for x in jlines]


def _read_png(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img.astype(np.int64)


def test_flow_images_match_jax(run):
    fmt = CASES[run["case"]][2]
    jfiles = sorted(p.relative_to(run["jax"] / "flows")
                    for p in (run["jax"] / "flows").rglob("*.*"))
    pfiles = sorted(p.relative_to(run["port"] / "flows")
                    for p in (run["port"] / "flows").rglob("*.*"))
    assert pfiles == jfiles
    per_sample = 2 if fmt == "visual:intermediate:flow" else 1
    assert len(pfiles) == PAIRS * per_sample
    for name in pfiles:
        j, p = run["jax"] / "flows" / name, run["port"] / "flows" / name
        if fmt == "flow:flo":
            a, e = tio.read_flow_mb(p), tio.read_flow_mb(j)
            assert a.shape == e.shape == (*SHAPE, 2)
            assert np.abs(a - e).max() <= FLO_ATOL, name
            continue
        a, e = _read_png(p), _read_png(j)
        assert a.shape == e.shape and a.shape[:2] == SHAPE, name
        levels = KITTI_LEVELS if fmt == "flow:kitti" else PNG_LEVELS
        assert np.abs(a - e).max() <= levels, (name, np.abs(a - e).max())


def test_sweep_stats(run):
    """Batches and padding of each case: buckets pad every short batch to
    the batch size; without buckets the last batch runs short."""
    args = CASES[run["case"]][0]
    env = CASES[run["case"]][1]
    stats = run["report"]["stats"]
    batch = int(args[args.index("-b") + 1]) if "-b" in args else 1
    bucketed = "--buckets" in args or "RMD_EVAL_BUCKETS" in env
    assert stats.samples == PAIRS
    assert stats.batches == -(-PAIRS // batch)
    shape = (72, 104) if "72x104" in args else SHAPE
    assert list(stats.buckets) == [f"{shape[0]}x{shape[1]}"]
    pad = stats.batches * batch - PAIRS if bucketed else 0
    assert stats.pad_samples == pad
    real = PAIRS * SHAPE[0] * SHAPE[1]
    assert stats.real_pixels == real
    assert stats.total_pixels == (PAIRS + pad) * shape[0] * shape[1]
    assert stats.pad_waste_ratio() == pytest.approx(
        1 - real / stats.total_pixels, abs=1e-12)
    assert set(stats.phases) == {"dispatch", "drain"}


def test_generator_yields_real_samples_in_order(tree):
    """``evaluation.evaluate`` on the CPU: one EvalSample per real sample,
    in loader order, each batch's last marked; a padded remainder's
    outputs dropped; each sample's final flow equal to a batch-1 forward
    of its pair."""
    spec = tmodels.load(_tiny_cfg())
    spec.model.init(torch.Generator().manual_seed(0), "cpu")
    from raft_meets_dicl_tpu_torch import data as tdata

    source = tdata.load(tree / "source.yaml")
    loader = spec.input.apply(source).torch().loader(
        batch_size=2, num_workers=0)
    stats = teval.EvalRunStats()
    samples = list(teval.evaluate(spec.model, loader, pad_to=2,
                                  stats=stats))
    assert [str(s.meta.sample_id) for s in samples] == \
        [f"val/{i:04d}" for i in range(PAIRS)]
    assert [(s.batch, s.end_of_batch) for s in samples] == \
        [(0, False), (0, True), (1, True)]
    assert stats.pad_samples == 1 and stats.batches == 2
    step = teval.make_eval_fn(spec.model)
    with torch.backends.mkldnn.flags(enabled=False):
        for s in samples:
            assert s.final.shape == (*SHAPE, 2)
            assert [o.shape[0] for o in s.output] == [1, 1]
            _, final = step(s.img1[None], s.img2[None])
            assert torch.allclose(final[0], s.final, atol=1e-4)


@pytest.mark.parametrize("flag", [
    # ported, and refused where JAX refuses it: beside --fwbw
    ("--wire-format", "u8", "--fwbw needs the plain f32", ["--fwbw"],
     ValueError),
    ("--precompile", None, "slice 7", [], NotImplementedError),
    ("--compile-cache", "cache", "slice 7", [], NotImplementedError),
    ("--telemetry", "events.jsonl", "slice 7", [], NotImplementedError),
    ("--device-ids", "0,1", "slice 2 item 10", [], NotImplementedError),
], ids=lambda f: f[0])
def test_unported_flags_are_refused_by_name(tree, flag):
    name, value, item, extra, error = flag
    argv = ["evaluate", "-d", str(tree / "source.yaml"), "-m",
            str(tree / "model.json"), "-c", str(tree / "init.ckpt"),
            "--device", "cpu", name] + ([value] if value else []) + extra
    with pytest.raises(error, match=item):
        tmain.main(argv)


def test_cuda_is_the_default_and_required(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tmain.build_parser().parse_args(
        ["e", "-d", "d.yaml", "-m", "m.yaml", "-c", "c.ckpt"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["eval", "-d", str(tree / "source.yaml"), "-m",
                    str(tree / "model.json"), "-c", str(tree / "init.ckpt")])


def test_fwbw_formats_need_fwbw(tree):
    with pytest.raises(ValueError, match="--fwbw"):
        tmain.main(["evaluate", "-d", str(tree / "source.yaml"), "-m",
                    str(tree / "model.json"), "-c", str(tree / "init.ckpt"),
                    "--device", "cpu", "-f", str(tree / "x"),
                    "--flow-format", "visual:occlusion"])


def test_port_checkpoint_training_config_and_yaml(tree, tmp_path):
    """``-c`` also takes the port's own checkpoint format, ``-m`` a full
    training config's ``model`` section, ``-o`` a yaml file: the same
    report as from the JAX checkpoint in json. (The JAX command's yaml
    report fails on its ordered metric dicts; the port stores plain
    ones.)"""
    spec = tmodels.load(_tiny_cfg())
    spec.model.init(torch.Generator().manual_seed(0), "cpu")
    tchk.Checkpoint.load(tree / "init.ckpt").apply(module=spec.model.module)
    tchk.Checkpoint(
        model="raft/baseline", iteration=tchk.Iteration(0, None, 0),
        metrics=None, state=tchk.State(
            spec.model.module.state_dict(), {}, {}, [], []),
        metadata={}).save(tmp_path / "port.ckpt")
    (tmp_path / "config.json").write_text(json.dumps(
        {"model": _tiny_cfg(), "strategy": {}}))

    for model, chkpt, out in (
            (tree / "model.json", tree / "init.ckpt", "report.json"),
            (tmp_path / "config.json", tmp_path / "port.ckpt", "report.yaml")):
        _run_port(["evaluate", "-d", str(tree / "source.yaml"), "-m",
                   str(model), "-c", str(chkpt), "-b", "3", "-o",
                   str(tmp_path / out)], {})
    assert tconfig.load(tmp_path / "report.json") == \
        tconfig.load(tmp_path / "report.yaml")


def test_collate_refuses_mixed_shapes_naming_buckets():
    meta = [None]
    a = (np.zeros((1, 8, 8, 3)), np.zeros((1, 8, 8, 3)), None, None, meta)
    b = (np.zeros((1, 8, 16, 3)), np.zeros((1, 8, 16, 3)), None, None, meta)
    with pytest.raises(ValueError, match="bucket"):
        tinput.collate([a, b])
    img1, _, flow, valid, _ = tinput.collate([a, a])
    assert img1.shape == (2, 8, 8, 3) and flow is None and valid is None
