"""Weight bridge: the JAX package's ``raft/baseline`` variables -> this
package's ``state_dict``.

Input is the JAX variables tree as nested mappings of numpy arrays (for
example ``jax.tree.map(np.asarray, model.init(...))``). Flax module paths
map onto torch RAFT module names by the same rules as
``scripts/chkpt_convert.py`` (its ``_raft_rules``), kept as an own copy
here: conv kernels HWIO -> OIHW, batch-norm ``scale``/``bias`` ->
``weight``/``bias``, ``batch_stats`` ``mean``/``var`` ->
``running_mean``/``running_var``.
"""

from collections.abc import Mapping

import numpy as np
import torch


def _stem_rules(src):
    """flax ``_Stem`` path fragment -> torch fnet/cnet path fragment."""
    rules = {
        "Conv_0": f"{src}.conv1",
        "Norm2d_0.BatchNorm_0": f"{src}.norm1",
    }
    for i in range(6):
        tgt = f"{src}.layer{i // 2 + 1}.{i % 2}"
        rules[f"ResidualBlock_{i}.Conv_0"] = f"{tgt}.conv1"
        rules[f"ResidualBlock_{i}.Conv_1"] = f"{tgt}.conv2"
        rules[f"ResidualBlock_{i}.Conv_2"] = f"{tgt}.downsample.0"
        rules[f"ResidualBlock_{i}.Norm2d_0.BatchNorm_0"] = f"{tgt}.norm1"
        rules[f"ResidualBlock_{i}.Norm2d_1.BatchNorm_0"] = f"{tgt}.norm2"
        rules[f"ResidualBlock_{i}.Norm2d_2.BatchNorm_0"] = f"{tgt}.downsample.1"
    return rules


def raft_rules():
    """flax module path (dotted) -> torch module path for raft/baseline."""
    rules = {}
    for flax_enc, torch_enc in (("FeatureEncoderS3_0", "fnet"),
                                ("FeatureEncoderS3_1", "cnet")):
        for flax_frag, torch_frag in _stem_rules(torch_enc).items():
            rules[f"{flax_enc}._Stem_0.{flax_frag}"] = torch_frag
        rules[f"{flax_enc}.Conv_0"] = f"{torch_enc}.conv2"

    block = "ScanCheckpoint_RaftStep_0.BasicUpdateBlock_0"
    for i, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv")):
        rules[f"{block}.BasicMotionEncoder_0.Conv_{i}"] = \
            f"update_block.encoder.{name}"
    for i, name in enumerate(("convz1", "convr1", "convq1",
                              "convz2", "convr2", "convq2")):
        rules[f"{block}.SepConvGru_0.Conv_{i}"] = f"update_block.gru.{name}"
    rules[f"{block}.FlowHead_0.Conv_0"] = "update_block.flow_head.conv1"
    rules[f"{block}.FlowHead_0.Conv_1"] = "update_block.flow_head.conv2"

    # the upsampling network runs outside the scan (batched application)
    rules["Up8Network_0.Conv_0"] = "update_block.mask.0"
    rules["Up8Network_0.Conv_1"] = "update_block.mask.2"
    return rules


def _named_leaves(tree, prefix=()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _named_leaves(value, (*prefix, key))
        else:
            yield (*prefix, key), value


_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def jax_variables_to_state_dict(variables):
    """Map a raft/baseline JAX variables tree onto this package's
    ``state_dict`` (float32 CPU tensors, batch-norm counters zero).

    Raises ``KeyError`` for a collection, module path or leaf the rules
    do not know, and ``ValueError`` if two leaves map onto one key.
    """
    rules = raft_rules()
    state = {}
    for (col, *path), leaf in _named_leaves(variables):
        module_path, leaf_name = ".".join(path[:-1]), path[-1]
        if module_path not in rules:
            raise KeyError(f"no conversion rule for flax module "
                           f"'{col}.{module_path}'")
        torch_mod = rules[module_path]

        value = np.asarray(leaf, np.float32)
        if col == "params" and leaf_name in _PARAM_LEAVES:
            if leaf_name == "kernel":
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
    state = jax_variables_to_state_dict(variables)
    module.load_state_dict(state, strict=True)
    return module
