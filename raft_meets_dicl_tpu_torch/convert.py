"""Weight bridge: the JAX package's variables -> this package's
``state_dict``, for ``raft/baseline``, ``raft/fs`` and the ``raft+dicl``
coarse-to-fine models.

Input is the JAX variables tree as nested mappings of numpy arrays (for
example ``jax.tree.map(np.asarray, model.init(...))``). Flax module paths
map onto the reference torch module names by the same rules as
``scripts/chkpt_convert.py`` (its ``_raft_rules`` and ``_ctf_rules`` with
``_pyramid_rules``, ``_cmod_rules``, ``_update_block_rules``), kept as an
own copy here: conv kernels HWIO -> OIHW, transposed-conv kernels (flax
``ConvTranspose``) to torch's (in, out, kh, kw) with the spatial flip that
makes torch's k4/s2/p1 geometry equal flax's 'SAME', batch-norm
``scale``/``bias`` -> ``weight``/``bias``, ``batch_stats`` ``mean``/``var``
-> ``running_mean``/``running_var``.

The JAX package's checkpoint files load through the same rules
(:func:`load_jax_checkpoint`): the weights, and optax's Adam / AdamW state
(``count``, ``mu``, ``nu``) as torch's ``step``, ``exp_avg`` and
``exp_avg_sq``; a stage's ``optax.MultiSteps`` state (``mini_step``,
``acc_grads`` around the Adam state) also gives the running mean and the
count of a partial accumulation (``strategy.spec.GradientTransform``).

:func:`activation_points` maps flax module paths onto this package's
modules for the inspector's activation hooks.
"""

from collections.abc import Mapping

import numpy as np
import torch

from .models.impls.raft_dicl_ctf import RaftPlusDiclCtfModule
from .models.impls.raft_fs import RaftFsModule


def _stem_rules(src):
    """flax ``_Stem`` path fragment -> torch fnet/cnet path fragment."""
    rules = {
        "Conv_0": f"{src}.conv1",
        "Norm2d_0.BatchNorm_0": f"{src}.norm1",
    }
    for i in range(6):
        tgt = f"{src}.layer{i // 2 + 1}.{i % 2}"
        rules |= _residual_rules(f"ResidualBlock_{i}", tgt)
    return rules


def _residual_rules(flax_block, tgt):
    return {
        f"{flax_block}.Conv_0": f"{tgt}.conv1",
        f"{flax_block}.Conv_1": f"{tgt}.conv2",
        f"{flax_block}.Conv_2": f"{tgt}.downsample.0",
        f"{flax_block}.Norm2d_0.BatchNorm_0": f"{tgt}.norm1",
        f"{flax_block}.Norm2d_1.BatchNorm_0": f"{tgt}.norm2",
        f"{flax_block}.Norm2d_2.BatchNorm_0": f"{tgt}.downsample.1",
    }


def _update_block_rules(flax_path, torch_path):
    """Rules for one BasicUpdateBlock."""
    rules = {}
    enc = f"{flax_path}.BasicMotionEncoder_0"
    for i, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv")):
        rules[f"{enc}.Conv_{i}"] = f"{torch_path}.encoder.{name}"
    gru = f"{flax_path}.SepConvGru_0"
    for i, name in enumerate(("convz1", "convr1", "convq1",
                              "convz2", "convr2", "convq2")):
        rules[f"{gru}.Conv_{i}"] = f"{torch_path}.gru.{name}"
    rules[f"{flax_path}.FlowHead_0.Conv_0"] = f"{torch_path}.flow_head.conv1"
    rules[f"{flax_path}.FlowHead_0.Conv_1"] = f"{torch_path}.flow_head.conv2"
    return rules


def _s3_rules(step):
    """The modules raft/baseline and raft/fs share: both S3 encoders, the
    update block in the scan body ``step`` and the upsampling network,
    which runs outside the scan (batched application)."""
    rules = {}
    for flax_enc, torch_enc in (("FeatureEncoderS3_0", "fnet"),
                                ("FeatureEncoderS3_1", "cnet")):
        for flax_frag, torch_frag in _stem_rules(torch_enc).items():
            rules[f"{flax_enc}._Stem_0.{flax_frag}"] = torch_frag
        rules[f"{flax_enc}.Conv_0"] = f"{torch_enc}.conv2"

    rules |= _update_block_rules(f"{step}.BasicUpdateBlock_0", "update_block")
    rules["Up8Network_0.Conv_0"] = "update_block.mask.0"
    rules["Up8Network_0.Conv_1"] = "update_block.mask.2"
    return rules


def raft_rules(corr_levels=4):
    """flax module path (dotted) -> torch module path for raft/baseline
    (with the per-level DAPs of ``corr-reg-type: softargmax+dap``)."""
    step = "ScanCheckpoint_RaftStep_0"
    rules = _s3_rules(step)
    for i in range(corr_levels):
        rules[f"{step}.SoftArgMaxFlowRegression_0."
              f"DisplacementAwareProjection_{i}.Conv_0"] = \
            f"corr_reg.dap.{i}.conv1"
    return rules


def fs_rules():
    """flax module path -> torch module path for raft/fs: raft/baseline's
    modules without a readout, the scan body named ``_FsStep``."""
    return _s3_rules("ScanCheckpoint_FsStep_0")


def _pyramid_rules(flax_enc, torch_enc, levels):
    """Rules for one FeatureEncoderPyramid (stem layer1-3, heads
    out3..out{levels+2}, inter-level stages layer4..)."""
    rules = {}
    for frag, tgt in _stem_rules(torch_enc).items():
        rules[f"{flax_enc}._Stem_0.{frag}"] = tgt

    for i in range(levels):
        head = f"{flax_enc}.EncoderOutputNet_{i}"
        out = f"{torch_enc}.out{i + 3}"
        rules[f"{head}.Conv_0"] = f"{out}.conv1"
        rules[f"{head}.Norm2d_0.BatchNorm_0"] = f"{out}.norm1"
        rules[f"{head}.Conv_1"] = f"{out}.conv2"

    for j in range(levels - 1):
        for k in range(2):
            rules |= _residual_rules(f"{flax_enc}.ResidualBlock_{2 * j + k}",
                                     f"{torch_enc}.layer{4 + j}.{k}")
    return rules


def _cmod_rules(flax_path, torch_path):
    """Rules for one DICL CorrelationModule (MatchingNet hourglass + DAP)."""
    rules = {}
    mnet = f"{flax_path}.MatchingNet_0"
    for i in range(4):
        rules[f"{mnet}.ConvBlock_{i}.Conv_0"] = f"{torch_path}.mnet.{i}.0"
        rules[f"{mnet}.ConvBlock_{i}.Norm2d_0.BatchNorm_0"] = \
            f"{torch_path}.mnet.{i}.1"
    rules[f"{mnet}.ConvBlockTransposed_0.ConvTranspose_0"] = \
        f"{torch_path}.mnet.4.0"
    rules[f"{mnet}.ConvBlockTransposed_0.Norm2d_0.BatchNorm_0"] = \
        f"{torch_path}.mnet.4.1"
    rules[f"{mnet}.Conv_0"] = f"{torch_path}.mnet.5"
    rules[f"{flax_path}.DisplacementAwareProjection_0.Conv_0"] = \
        f"{torch_path}.dap.conv1"
    return rules


def ctf_rules(levels, share_dicl, share_rnn, upsample_hidden):
    """flax module path -> torch module path for raft+dicl/ctf-l*.

    Flax submodule suffixes follow creation order, coarse to fine over the
    level ids ``levels + 2 .. 3``: suffix i is torch ``corr_{lvl}`` /
    ``update_block_{lvl}`` of the i-th level id.
    """
    level_ids = tuple(range(levels + 2, 2, -1))
    rules = {}

    rules |= _pyramid_rules("FeatureEncoderPyramid_0", "fnet", levels)
    rules |= _pyramid_rules("FeatureEncoderPyramid_1", "cnet", levels)

    for i, lvl in enumerate(level_ids):
        suffix = 0 if share_dicl else i
        rules |= _cmod_rules(f"CorrelationModule_{suffix}",
                             "corr" if share_dicl else f"corr_{lvl}")
        # corr-reg-type softargmax+dap: the readout's own DAP
        rules[f"SoftArgMaxFlowRegressionWithDap_{suffix}."
              "DisplacementAwareProjection_0.Conv_0"] = \
            ("flow_reg" if share_dicl else f"flow_reg_{lvl}") + ".dap.conv1"
        rules |= _update_block_rules(
            f"BasicUpdateBlock_{0 if share_rnn else i}",
            "update_block" if share_rnn else f"update_block_{lvl}")

    for i, lvl in enumerate(level_ids[1:]):
        flax_h = 0 if share_rnn else i
        # the reference l2 variant has a single transition and names its
        # upsampler 'upnet_h' regardless of sharing
        torch_h = "upnet_h" if share_rnn or levels == 2 else f"upnet_h_{lvl}"
        if upsample_hidden == "bilinear":
            rules[f"HUpBilinear_{flax_h}.Conv_0"] = f"{torch_h}.conv1"
        elif upsample_hidden == "crossattn":
            for j, name in enumerate(("conv_q", "conv_k", "conv_v_prev",
                                      "conv_v_init", "conv_out")):
                rules[f"HUpCrossAttn_{flax_h}.Conv_{j}"] = f"{torch_h}.{name}"

    rules["Up8Network_0.Conv_0"] = "upnet.conv1"
    rules["Up8Network_0.Conv_1"] = "upnet.conv2"
    return rules


def rules_for(module):
    """The rules for this package's model ``module``."""
    if isinstance(module, RaftPlusDiclCtfModule):
        return ctf_rules(module.levels, module.share_dicl, module.share_rnn,
                         module.upsample_hidden)
    if isinstance(module, RaftFsModule):
        return fs_rules()
    return raft_rules(module.corr_levels)


def _named_leaves(tree, prefix=()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _named_leaves(value, (*prefix, key))
        else:
            yield (*prefix, key), value


_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def jax_variables_to_state_dict(variables, rules=None):
    """Map a JAX variables tree onto this package's ``state_dict`` (float32
    CPU tensors, batch-norm counters zero) by ``rules`` (default: the
    raft/baseline rules).

    Raises ``KeyError`` for a collection, module path or leaf the rules
    do not know, and ``ValueError`` if two leaves map onto one key.
    """
    rules = raft_rules() if rules is None else rules
    state = {}
    for (col, *path), leaf in _named_leaves(variables):
        module_path, leaf_name = ".".join(path[:-1]), path[-1]
        if module_path not in rules:
            raise KeyError(f"no conversion rule for flax module "
                           f"'{col}.{module_path}'")
        torch_mod = rules[module_path]

        value = np.asarray(leaf, np.float32)
        if col == "params" and leaf_name in _PARAM_LEAVES:
            if leaf_name == "kernel" and path[-2].startswith("ConvTranspose"):
                # flax (kh, kw, in, out), transpose_kernel=False -> torch
                # (in, out, kh, kw), spatially flipped (the inverse of
                # chkpt_convert's _conv_t)
                value = np.transpose(value, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            elif leaf_name == "kernel":
                value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
            key = f"{torch_mod}.{_PARAM_LEAVES[leaf_name]}"
        elif col == "batch_stats" and leaf_name in _STAT_LEAVES:
            key = f"{torch_mod}.{_STAT_LEAVES[leaf_name]}"
            state[f"{torch_mod}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise KeyError(f"unhandled leaf '{col}.{'.'.join(path)}'")

        if key in state:
            raise ValueError(f"two JAX leaves map onto '{key}'")
        state[key] = torch.from_numpy(np.array(value, np.float32))
    return state


def load_jax_variables(module, variables):
    """Load a JAX variables tree into ``module`` (strict: every parameter
    and buffer must be covered, nothing left over)."""
    state = jax_variables_to_state_dict(variables, rules_for(module))
    module.load_state_dict(state, strict=True)
    return module


# -- the JAX package's checkpoints ----------------------------------------------


def _adam_states(tree, path=()):
    """Yield ``(path, state)`` for every optax ``ScaleByAdamState`` in a
    flax state dict of an optax state (a mapping with exactly ``count``,
    ``mu`` and ``nu``), found by structure wherever the chain nests it;
    raise ``ValueError`` naming any other non-empty state."""
    if isinstance(tree, Mapping):
        if set(tree) == {"count", "mu", "nu"}:
            yield path, tree
            return
        for key in tree:
            yield from _adam_states(tree[key], (*path, str(key)))
        return
    raise ValueError(
        f"optimizer state '{'.'.join(path) or '<root>'}' is not Adam's "
        "(count, mu, nu): only the adam / adam-w chains are converted")


def optax_state_to_torch(opt_state, module, optimizer):
    """Map a JAX checkpoint's optax state (the flax state dict of the
    shipped clip -> adam / adam-w chain) onto ``optimizer``'s
    ``state_dict()`` form: ``count`` -> each parameter's ``step``, ``mu``
    -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``, through ``module``'s rules.
    ``optimizer`` must be ``torch.optim.Adam`` or ``AdamW`` over
    ``module``'s parameters."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise ValueError(f"cannot map optax Adam state onto "
                         f"{type(optimizer).__name__}")
    multi = _multi_steps_state(opt_state)
    if multi is not None:
        opt_state = multi["inner_opt_state"]
    found = list(_adam_states(opt_state))
    if len(found) != 1:
        raise ValueError(f"expected one optax ScaleByAdamState, found "
                         f"{len(found)}")
    (_, adam), = found

    rules = rules_for(module)
    exp_avg = jax_variables_to_state_dict({"params": adam["mu"]}, rules)
    exp_avg_sq = jax_variables_to_state_dict({"params": adam["nu"]}, rules)
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)

    names = {id(p): n for n, p in module.named_parameters()}
    target = optimizer.state_dict()
    state, order = {}, []
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            state[len(order)] = {"step": step.clone(),
                                 "exp_avg": exp_avg[name],
                                 "exp_avg_sq": exp_avg_sq[name]}
            order.append(name)
    out = {"state": state, "param_groups": target["param_groups"]}
    if multi is not None:
        acc = jax_variables_to_state_dict({"params": multi["acc_grads"]},
                                          rules)
        out["accumulate"] = {
            "mini_step": int(np.asarray(multi["mini_step"])),
            "acc": {i: acc[name] for i, name in enumerate(order)},
        }
    return out


def _multi_steps_state(tree):
    """The flax state dict of an ``optax.MultiSteps`` state at the root of
    ``tree`` (a mapping with ``mini_step``, ``acc_grads`` and
    ``inner_opt_state``), or None."""
    if isinstance(tree, Mapping) and {"mini_step", "acc_grads",
                                      "inner_opt_state"} <= set(tree):
        return tree
    return None


def load_jax_checkpoint(path, module, optimizer=None):
    """Load a checkpoint the JAX package wrote (``RMDT2``, or the legacy
    ``RMDT1``) into ``module``, and its Adam / AdamW state into
    ``optimizer`` when one is given. A corrupt file raises
    ``strategy.checkpoint.CheckpointCorrupt``. Returns the
    ``Checkpoint``, whose iteration, metrics and scheduler states are kept
    as the file holds them."""
    from .strategy.checkpoint import Checkpoint

    chkpt = Checkpoint.load(path)
    if chkpt.format != "jax":
        raise ValueError(f"'{path}' is not a JAX package checkpoint")
    chkpt.apply(module=module, optimizer=optimizer)
    return chkpt


# -- activation capture points ------------------------------------------------

# the module flax's Norm2d wraps, by this package's norm class
_NORM_INNER = {"BatchNorm2d": "BatchNorm_0", "GroupNorm": "GroupNorm_0",
               "InstanceNorm2d": "GroupNorm_0", "NoNorm2d": None}


def activation_points(module):
    """flax module path -> ``(torch module path, "output" | "input")`` for
    every module whose output the JAX package's ``capture_intermediates``
    forward records in raft/baseline and raft/fs: the two S3 encoders and
    everything in them, the convex upsampler (batched over the
    iterations, as in both packages) and the whole model (``__call__``).
    The recurrent step's modules run inside JAX's scan, whose
    intermediates flax does not keep, and have no point. ``input`` is the
    input of the module named: the encoders' ``_Stem_0`` output is the
    input of their ``conv2``.

    The names follow the S3 rules of :func:`raft_rules` (module paths
    with parameters), plus flax's parameterless wrappers: ``Norm2d_k``
    and its inner ``BatchNorm_0``/``GroupNorm_0`` are one torch norm
    module, ``ResidualBlock_i`` is torch's ``layer{i // 2 + 1}.{i % 2}``.
    Raises ``NotImplementedError`` for the coarse-to-fine models."""
    if isinstance(module, RaftPlusDiclCtfModule):
        raise NotImplementedError(
            "activation hooks of the raft+dicl coarse-to-fine models are "
            "not ported yet (ROADMAP slice 2 item 7's rest)")
    mods = dict(module.named_modules())
    points = {"__call__": ("", "output")}
    for flax_enc, torch_enc in (("FeatureEncoderS3_0", "fnet"),
                                ("FeatureEncoderS3_1", "cnet")):
        if f"{torch_enc}.conv2" not in mods or \
                f"{torch_enc}.layer3.1" not in mods:
            raise NotImplementedError(
                f"activation hooks of the '{torch_enc}' encoder type are "
                "not ported yet (ROADMAP slice 2 item 7's rest)")
        points[flax_enc] = (torch_enc, "output")
        points[f"{flax_enc}.Conv_0"] = (f"{torch_enc}.conv2", "output")
        stem = f"{flax_enc}._Stem_0"
        points[stem] = (f"{torch_enc}.conv2", "input")
        for flax_frag, torch_mod in _stem_rules(torch_enc).items():
            if torch_mod not in mods:  # the 1x1 shortcut of stride-1 blocks
                continue
            flax_path = f"{stem}.{flax_frag}"
            if flax_frag.endswith(".BatchNorm_0"):
                wrapper = flax_path[:-len(".BatchNorm_0")]
                points[wrapper] = (torch_mod, "output")
                inner = _NORM_INNER[type(mods[torch_mod]).__name__]
                if inner is not None:
                    points[f"{wrapper}.{inner}"] = (torch_mod, "output")
            else:
                points[flax_path] = (torch_mod, "output")
        for i in range(6):
            points[f"{stem}.ResidualBlock_{i}"] = (
                f"{torch_enc}.layer{i // 2 + 1}.{i % 2}", "output")
    points["Up8Network_0"] = ("update_block.mask", "output")
    points["Up8Network_0.Conv_0"] = ("update_block.mask.0", "output")
    points["Up8Network_0.Conv_1"] = ("update_block.mask.2", "output")
    return points
