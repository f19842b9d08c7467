"""PyTorch port: the lookup contraction of ``ops.lookup`` (what its CUDA
kernels, ``lookup_stage1`` and ``lookup_fused``, are held against on the
card) and the port's lookup probe, held against the JAX repository's
``scripts/probe_fused_lookup.py`` on the CPU from the same numpy inputs.

- the plain versions against the JAX probe's stage-1 einsum and
  ``_xla_lookup`` (its Pallas kernels need a TPU; its plain XLA form is
  their oracle there), loaded with ``importlib`` from the script: float32
  and bf16, hat and dense inputs, the probe's level-0 row shape and small
  ragged shapes;
- the hat contraction is the model's own lookup (``ops.corr._lookup_level``);
- the fused kernel's plan (``ops.lookup.fused_plan``: whole or rows mode,
  the warps' column split, shared memory) at the shapes that take each
  branch, within a block's shared memory for every accepted shape, and
  the shapes of ``CASES`` covering every branch (``chip_smoke.py`` holds
  the built kernel's plan equal to it and each branch against the plain
  version on the card);
- the wrappers take the plain version for CPU tensors and count nothing;
  the card-side checks refuse K != 9, mixed dtypes, mismatched shapes,
  too wide a fused tile and CPU tensors;
- the port's probe ``main`` at tiny shapes with ``--device cpu``, and its
  refusal to run on ``cuda`` without CUDA.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_meets_dicl_tpu_torch.ops import corr as tcorr
from raft_meets_dicl_tpu_torch.ops import lookup as tlookup
from raft_meets_dicl_tpu_torch.scripts import probe_fused_lookup as tprobe
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).parent.parent
# float32 sums of the same n terms in other orders differ by at most
# 2 (n - 1) 2^-24 S, S the sum of the terms' magnitudes; 2^-13 covers
# n <= 1,024 (H2 + W2 here)
ORDER_REL = 2.0 ** -13


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_fused_lookup", ROOT / "scripts" / "probe_fused_lookup.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JPROBE = _jax_probe()


def _bf16_ulp(x):
    """Spacing of bfloat16 values at |x|: 2^(e - 7) for |x| in
    [2^e, 2^(e+1)); 0 at 0."""
    _, exp = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, exp - 8))


def _inputs(kind, lead, h2, w2, dtype, seed=0):
    """wy, corr, wx as float32 numpy, rounded to ``dtype`` once (both
    packages then read the same values): hat matrices around random
    in-range centres as the probe builds them, or dense randn ones."""
    rs = np.random.RandomState(seed)
    d = np.arange(-4, 5)
    if kind == "hat":
        cy = rs.rand(*lead, 1) * (h2 - 10) + 5
        cx = rs.rand(*lead, 1) * (w2 - 10) + 5
        wy = np.maximum(0.0, 1.0 - np.abs((cy + d)[..., None]
                                          - np.arange(h2)))
        wx = np.maximum(0.0, 1.0 - np.abs((cx + d)[..., None]
                                          - np.arange(w2)))
    else:
        wy = rs.randn(*lead, 9, h2)
        wx = rs.randn(*lead, 9, w2)
    corr = rs.randn(*lead, h2, w2)
    out = []
    for a in (wy, corr, wx):
        t = torch.from_numpy(a.astype(np.float32)).to(dtype)
        out.append(t.float().numpy())
    return out


CASES = [
    # (kind, leading axes, H2, W2): the probe's level-0 rows (NJ 90 of one
    # (b, i) row, H2 50, W2 90), and ragged ones
    ("hat", (1, 1, 90), 50, 90),
    ("dense", (1, 1, 90), 50, 90),
    ("hat", (2, 7, 13), 11, 37),
    ("dense", (2, 7, 13), 11, 37),
    ("dense", (1, 3, 5), 33, 12),
    # the CUDA stage 1 copies each run of positions flat from a 16-byte
    # boundary: an odd N, odd H2·W2 (bf16 blocks starting at 2-byte
    # offsets) and W2 not a multiple of 8 (ragged column tiles)
    ("dense", (1, 3, 7), 13, 21),
    ("hat", (1, 1, 15), 17, 29),
    ("dense", (2, 3, 4), 9, 23),
    # the fused kernel's branches (fused_plan): H2 and W2 not multiples of
    # 16, and W2 41 (six 8-column tiles: two 3-tile groups, each with a
    # lone third C fragment for the bf16 k16 repack); a position larger
    # than a stage (rows mode, t summed in shared memory); the widest row
    # it takes (its wx exceeds a stage's: rows mode at 3 rows)
    ("hat", (1, 2, 5), 37, 45),
    ("dense", (1, 3, 7), 13, 41),
    ("dense", (1, 2, 3), 20, 700),
    ("dense", (1, 1, 2), 3, tlookup.FUSED_MAX_W2),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,lead,h2,w2", CASES)
def test_plain_lookup_matches_the_jax_probe(kind, lead, h2, w2, dtype):
    wy, corr, wx = _inputs(kind, lead, h2, w2, getattr(torch, dtype))
    jdt = getattr(jnp, dtype)
    jwy, jcorr, jwx = (jnp.asarray(a, jdt) for a in (wy, corr, wx))
    twy, tcorr_, twx = (torch.from_numpy(a).to(getattr(torch, dtype))
                        for a in (wy, corr, wx))

    # stage 1 (the probe's check of arm B, float32 accumulation)
    expected = np.asarray(jnp.einsum("bijkh,bijhw->bijkw", jwy, jcorr,
                                     preferred_element_type=jnp.float32))
    actual = tlookup.lookup_stage1(twy, tcorr_)
    assert actual.dtype == torch.float32
    assert tuple(actual.shape) == expected.shape == (*lead, 9, w2)
    s1 = np.einsum("bijkh,bijhw->bijkw", np.abs(wy), np.abs(corr))
    assert (np.abs(actual.numpy() - expected) <= ORDER_REL * s1).all()

    # both stages (the probe's _xla_lookup): t rounds to the inputs'
    # dtype, which sums in other orders can move by one ulp
    expected = np.asarray(JPROBE._xla_lookup(jwy, jcorr, jwx))
    actual = tlookup.lookup_fused(twy, tcorr_, twx)
    assert actual.dtype == torch.float32
    assert tuple(actual.shape) == expected.shape == (*lead, 9, 9)
    s = np.einsum("bijkw,bijaw->bijka", s1, np.abs(wx))
    t = np.asarray(jnp.einsum("bijkh,bijhw->bijkw", jwy, jcorr,
                              preferred_element_type=jnp.float32)
                   .astype(jdt).astype(jnp.float32))
    ulp = (np.einsum("bijkw,bijaw->bijka", _bf16_ulp(t), np.abs(wx))
           if dtype == "bfloat16" else 0.0)
    assert (np.abs(actual.numpy() - expected) <= ORDER_REL * s + ulp).all()


def test_plain_fused_rounds_t_to_the_input_dtype():
    """In bf16 the intermediate t is rounded once (round to nearest even)
    before stage 2: the same function computed from float32 t differs."""
    wy, corr, wx = (torch.from_numpy(a).to(torch.bfloat16) for a in
                    _inputs("dense", (1, 2, 3), 20, 24, torch.bfloat16))
    t = tlookup.lookup_stage1_reference(wy, corr)
    rounded = torch.matmul(t.to(torch.bfloat16).float(),
                           wx.float().transpose(-1, -2))
    unrounded = torch.matmul(t, wx.float().transpose(-1, -2))
    fused = tlookup.lookup_fused_reference(wy, corr, wx)
    assert torch.equal(fused, rounded)
    assert not torch.equal(fused, unrounded)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hat_contraction_is_the_model_lookup(dtype):
    """``ops.corr._lookup_level`` is this contraction with hat matrices
    from the window positions: equal in float32, within one bf16 ulp of t
    through stage 2 in bf16 (its stage 1 is a bf16 matmul)."""
    rs = np.random.RandomState(3)
    b, h1, w1, h2, w2 = 2, 5, 6, 13, 17
    corr = torch.from_numpy(rs.randn(b, h1, w1, h2, w2).astype(np.float32)
                            ).to(dtype)
    coords = torch.from_numpy((rs.rand(b, h1, w1, 2) * [w2, h2]
                               + rs.randn(b, h1, w1, 2) * 3)
                              .astype(np.float32))
    d = tcorr.window_offsets(4)
    x = coords[..., 0:1] + d
    y = coords[..., 1:2] + d
    expected = tcorr._lookup_level(corr, x, y)
    wy = tcorr._interp_matrix(y, h2).to(dtype)
    wx = tcorr._interp_matrix(x, w2).to(dtype)
    actual = tlookup.lookup_fused(wy, corr, wx)
    if dtype == torch.float32:
        torch.testing.assert_close(actual, expected, rtol=0, atol=1e-5)
    else:
        t = tlookup.lookup_stage1_reference(wy, corr).to(dtype).float()
        ulp = torch.matmul(torch.from_numpy(_bf16_ulp(t.numpy())).float(),
                           wx.float().abs().transpose(-1, -2))
        assert bool(((actual - expected).abs() <= ulp + 1e-5).all())


@pytest.mark.parametrize("h2,w2,dtype,expected", [
    # the probe's bench rows: two bf16 positions a stage, a warp per 3-tile
    # group (12 tiles: 4 warps a position); one float32 position, a warp a
    # 32-column chunk
    (50, 90, torch.bfloat16, {"mode": "whole", "units": 2, "ipu": 4,
                              "gpi": 1}),
    (50, 90, torch.float32, {"mode": "whole", "units": 1, "ipu": 3,
                             "gpi": 1}),
    # small positions: eight a stage, a warp each, two granules a warp
    (13, 41, torch.bfloat16, {"mode": "whole", "units": 8, "ipu": 1,
                              "gpi": 2}),
    (11, 37, torch.float32, {"mode": "whole", "units": 8, "ipu": 1,
                             "gpi": 2}),
    # larger than a stage: rows mode in units of hc rows
    (20, 700, torch.float32, {"mode": "rows", "upp": 3, "hc": 8,
                              "ipu": 8, "gpi": 3}),
    (20, 700, torch.bfloat16, {"mode": "rows", "upp": 2, "hc": 17}),
    # wx past a stage's share: rows mode with one unit
    (3, 3211, torch.bfloat16, {"mode": "rows", "upp": 1, "hc": 3,
                               "ipu": 8, "gpi": 13}),
    # wy past a stage's staged tile: rows mode
    (2000, 2, torch.bfloat16, {"mode": "rows", "upp": 3, "hc": 768,
                               "ipu": 1}),
    (1, 1, torch.float32, {"mode": "whole", "units": 8, "ipu": 1}),
])
def test_fused_plan_at_each_branch(h2, w2, dtype, expected):
    plan = tlookup.fused_plan(h2, w2, dtype)
    assert {key: plan[key] for key in expected} == expected
    assert plan["smem"] <= tlookup.MAX_SHARED_BYTES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plan_fits_every_accepted_shape(dtype):
    """No shape the wrapper accepts is refused by the kernel's shared
    memory: the widest row (the rows-mode t tile beside the ring) at every
    H2, and whole mode's largest stages. Every warp split covers a
    position's columns with runs of gpi granules, none empty."""
    seen = set()
    for h2 in (1, 2, 3, 4, 7, 16, 17, 31, 33, 50, 64, 100, 257, 1000, 4000):
        for w2 in (1, 2, 7, 8, 9, 23, 33, 41, 64, 90, 455, 456, 910, 911,
                   2000, tlookup.FUSED_MAX_W2):
            plan = tlookup.fused_plan(h2, w2, dtype)
            seen.add(plan["mode"])
            assert plan["smem"] <= tlookup.MAX_SHARED_BYTES, (h2, w2, plan)
            mma = plan["mode"] == "whole" and dtype == torch.bfloat16
            granules = -(-(-(-w2 // 8)) // 3) if mma else -(-w2 // 32)
            assert (plan["ipu"] - 1) * plan["gpi"] < granules \
                <= plan["ipu"] * plan["gpi"]
            assert plan["units"] * plan["ipu"] <= 8
            assert plan["upp"] * plan["hc"] >= h2
    assert seen == {"whole", "rows"}
    with pytest.raises(ValueError, match="exceeds a stage"):
        tlookup.fused_plan(1, 20000, dtype)


def test_cases_take_every_fused_branch():
    """``CASES`` (held against the JAX probe above) take each branch of
    the fused kernel in both dtypes: whole and rows mode; bf16 tile groups
    of one, two and three 8-column tiles (a lone C fragment in the k16
    repack where a group's tile count is odd); H2 not a multiple of 16."""
    modes = set()
    group_tiles = set()
    for _, _, h2, w2 in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = tlookup.fused_plan(h2, w2, dtype)
            modes.add((plan["mode"], str(dtype)))
            if plan["mode"] == "whole" and dtype == torch.bfloat16:
                group_tiles.add(-(-w2 // 8) % 3 or 3)
    assert modes == {(m, str(d)) for m in ("whole", "rows")
                     for d in (torch.float32, torch.bfloat16)}
    assert group_tiles == {1, 2, 3}
    assert any(h2 % 16 and w2 % 16 for _, _, h2, w2 in CASES)


def test_wrappers_take_the_plain_version_on_cpu():
    wy, corr, wx = (torch.from_numpy(a) for a in
                    _inputs("hat", (1, 2, 3), 12, 16, torch.float32))
    tlookup.stage1_launches = tlookup.fused_launches = 0
    assert torch.equal(tlookup.lookup_stage1(wy, corr),
                       tlookup.lookup_stage1_reference(wy, corr))
    assert torch.equal(tlookup.lookup_fused(wy, corr, wx),
                       tlookup.lookup_fused_reference(wy, corr, wx))
    assert tlookup.stage1_launches == tlookup.fused_launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tlookup.lookup_fused(wy.to("meta"), corr.to("meta"), wx.to("meta"))


def _tensors(k=9, h2=12, w2=16, dtype=torch.float32, lead=(2, 3, 4)):
    return (torch.zeros(*lead, k, h2, dtype=dtype),
            torch.zeros(*lead, h2, w2, dtype=dtype),
            torch.zeros(*lead, k, w2, dtype=dtype))


@pytest.mark.parametrize("k", [7, 11])
def test_card_checks_refuse_k_other_than_9(k):
    wy, corr, wx = _tensors(k=k)
    for args in ((wy, corr), (wy, corr, wx)):
        with pytest.raises(ValueError, match="K = 9"):
            tlookup._check_inputs(*args)


def test_card_checks_refuse_what_the_kernels_do_not_take():
    wy, corr, wx = _tensors()
    with pytest.raises(TypeError, match="one dtype"):
        tlookup._check_inputs(wy, corr.to(torch.bfloat16))
    with pytest.raises(TypeError, match="one dtype"):
        tlookup._check_inputs(wy.half(), corr.half())
    with pytest.raises(ValueError, match="do not match"):
        tlookup._check_inputs(wy, corr[:, :, :, :-1])
    with pytest.raises(ValueError, match="do not match"):
        tlookup._check_inputs(wy, corr, wx[..., :-1])
    wide = _tensors(h2=2, w2=tlookup.FUSED_MAX_W2 + 1, lead=(1,))
    with pytest.raises(ValueError, match="shared"):
        tlookup._check_inputs(*wide)
    # stage 1 has no tile: the same width passes its shape checks and
    # stops at the device check
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlookup._check_inputs(*wide[:2])
    for args in ((wy, corr), (wy, corr, wx)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tlookup._check_inputs(*args)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_probe_main_on_cpu(dtype, capsys):
    rc = tprobe.main(["--device", "cpu", "--dtype", dtype, "--batch", "2",
                      "--ni", "3", "--nj", "4", "--h2", "12", "--w2", "17",
                      "--steps", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    result = json.loads(out[-1])["probe"]
    assert result["dtype"] == dtype
    assert result["shape"] == {"b": 2, "ni": 3, "nj": 4, "k": 9, "h2": 12,
                               "w2": 17}
    assert set(result["arms"]) == set("ABCD")
    for name, arm in result["arms"].items():
        assert arm["ms"] > 0 and np.isfinite(arm["max_abs_diff"])
        if name != "A":
            assert arm["share"] <= 1.0
    # B and C took the plain versions: no kernel launched on the CPU
    assert result["launches"] == {"lookup_stage1": 0, "lookup_fused": 0}
    # hat inputs: the plain versions reproduce the matmul lookup exactly
    assert result["arms"]["B"]["max_abs_diff"] == 0.0
    assert result["arms"]["C"]["max_abs_diff"] == 0.0
    assert result["arms"]["D"]["volume_bytes_ratio"] == (
        2 if dtype == "bf16" else 4)
    assert any(line.startswith("D  u8 volume") for line in out)


def test_probe_inputs_are_the_jax_probes():
    """The port's probe builds wy, corr, wx as the JAX probe's ``main``
    does (``np.random.RandomState(0)``, hats around random centres)."""
    wy, corr, wx = tprobe.make_inputs(2, 3, 4, 12, 17, torch.float32,
                                      "cpu")
    rs = np.random.RandomState(0)
    cy = rs.rand(2, 3, 4, 1) * (12 - 10) + 5
    cx = rs.rand(2, 3, 4, 1) * (17 - 10) + 5
    d = np.arange(-4, 5)
    np.testing.assert_array_equal(wy.numpy(), np.maximum(
        0.0, 1.0 - np.abs((cy + d)[..., None] - np.arange(12))).astype("f4"))
    np.testing.assert_array_equal(wx.numpy(), np.maximum(
        0.0, 1.0 - np.abs((cx + d)[..., None] - np.arange(17))).astype("f4"))
    np.testing.assert_array_equal(corr.numpy(),
                                  rs.randn(2, 3, 4, 12, 17).astype("f4"))
    assert (JPROBE.B, JPROBE.NI, JPROBE.NJ, JPROBE.K, JPROBE.H2, JPROBE.W2) \
        == (6, 50, 90, 9, 50, 90)
    with pytest.raises(ValueError, match="> 10"):
        tprobe.make_inputs(1, 1, 1, 10, 17, torch.float32, "cpu")


def test_probe_refuses_cuda_without_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprobe.main(["--steps", "1"]) == 2
    assert "torch.cuda.is_available()" in capsys.readouterr().err
