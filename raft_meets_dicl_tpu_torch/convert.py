"""Weight bridge: the JAX package's variables -> this package's
``state_dict``, for every model type: ``raft/baseline`` and ``raft/sl``,
``raft/fs``, the ``raft/sl-ctf`` and ``raft+dicl`` coarse-to-fine models,
``raft+dicl/ml``, ``raft+dicl/sl`` and ``/sl-ca``, ``dicl/baseline`` /
``dicl/64to8``, ``raft/cl``, ``wip/warp/1`` and ``wip/warp/2``.

Input is the JAX variables tree as nested mappings of numpy arrays (for
example ``jax.tree.map(np.asarray, model.init(...))``). Flax module paths
map onto the reference torch module names by the same rules as
``scripts/chkpt_convert.py`` (its ``_raft_rules``, ``_ctf_rules`` with
``_pyramid_rules``, ``_cmod_rules``, ``_update_block_rules``, and
``_dicl_rules`` with ``_dicl_block_rules``), kept as an own copy here and
extended to the flax paths of the ml and sl modules and of every encoder
family: conv kernels HWIO -> OIHW, transposed-conv kernels (flax
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

from .models.common.encoders.dicl import FeatureEncoderGa
from .models.common.encoders.raft import FeatureEncoderPyramid
from .models.common.encoders.rfpm import FeatureEncoderRfpm
from .models.impls.dicl import DiclModule
from .models.impls.raft_dicl_ctf import RaftPlusDiclCtfModule
from .models.impls.raft_dicl_ml import RaftPlusDiclMlModule
from .models.impls.raft_dicl_sl import RaftPlusDiclModule
from .models.impls.outdated.raft_cl import RaftClModule
from .models.impls.outdated.wip_recwarp import WipRecWarpModule
from .models.impls.outdated.wip_warp import WipWarpModule
from .models.impls.raft_fs import RaftFsModule
from .models.impls.raft_sl_ctf import RaftSlCtfModule


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


def _conv_block_rules(flax_block, torch_block):
    """A JAX ``ConvBlock`` -> the port's (conv, norm) ``ConvBlock``."""
    return {f"{flax_block}.Conv_0": f"{torch_block}.0",
            f"{flax_block}.Norm2d_0.BatchNorm_0": f"{torch_block}.1"}


def _mnet_rules(flax_mnet, torch_mnet, blocks=4, transposed=True):
    """Rules for one MatchingNet (``blocks`` conv blocks, the transposed
    block, the output conv) or MatchingNet1x1 (three blocks, no transposed
    one)."""
    rules = {}
    for i in range(blocks):
        rules |= _conv_block_rules(f"{flax_mnet}.ConvBlock_{i}",
                                   f"{torch_mnet}.{i}")
    out = blocks
    if transposed:
        rules[f"{flax_mnet}.ConvBlockTransposed_0.ConvTranspose_0"] = \
            f"{torch_mnet}.{blocks}.0"
        rules[f"{flax_mnet}.ConvBlockTransposed_0.Norm2d_0.BatchNorm_0"] = \
            f"{torch_mnet}.{blocks}.1"
        out += 1
    rules[f"{flax_mnet}.Conv_0"] = f"{torch_mnet}.{out}"
    return rules


def _cmod_rules(flax_path, torch_path, cmod_type="dicl"):
    """Rules for one correlation module of ``corr.make_cmod``: the
    MatchingNet hourglass (``dicl``, ``dicl-emb`` with its pair embedding
    ``emb``) or the 1x1 net (``dicl-1x1``), and the DAP (every type)."""
    rules = {}
    if cmod_type in ("dicl", "dicl-emb"):
        rules |= _mnet_rules(f"{flax_path}.MatchingNet_0",
                             f"{torch_path}.mnet")
    elif cmod_type == "dicl-1x1":
        rules |= _mnet_rules(f"{flax_path}.MatchingNet1x1_0",
                             f"{torch_path}.mnet", blocks=3, transposed=False)
    if cmod_type == "dicl-emb":
        for i in range(3):
            rules[f"{flax_path}.PairEmbedding_0.Conv_{i}"] = \
                f"{torch_path}.emb.{i}"
    rules[f"{flax_path}.DisplacementAwareProjection_0.Conv_0"] = \
        f"{torch_path}.dap.conv1"
    return rules


def _basic_conv_rules(flax_block, torch_block, transposed=False):
    """A JAX ``ConvBlock`` / ``ConvBlockTransposed`` -> the DICL-Flow
    ``BasicConv`` (``conv``, ``bn``): ``_dicl_block_rules``."""
    conv = "ConvTranspose_0" if transposed else "Conv_0"
    return {f"{flax_block}.{conv}": f"{torch_block}.conv",
            f"{flax_block}.Norm2d_0.BatchNorm_0": f"{torch_block}.bn"}


def _ga_block_rules(flax_block, torch_block, transposed):
    first = "ConvTranspose_0" if transposed else "Conv_0"
    second = "Conv_0" if transposed else "Conv_1"
    return {
        f"{flax_block}.{first}": f"{torch_block}.conv1.conv",
        f"{flax_block}.{second}": f"{torch_block}.conv2.conv",
        f"{flax_block}.Norm2d_0.BatchNorm_0": f"{torch_block}.conv2.bn",
    }


def _ga_encoder_rules(flax_enc, torch_enc, depth, out_levels, heads=True):
    """Rules for one GA-Net ``FeatureEncoderGa``, by creation order as
    ``_dicl_rules`` has them for p26: stem ConvBlock_0..2, the down ladder
    ConvBlock_3.. (``conv{i}a``), the first up ladder
    GaConv2xBlockTransposed_0.. (``deconv{i}a``), the second down ladder
    GaConv2xBlock_* (``conv{i}b``), the final up ladder
    GaConv2xBlockTransposed_{depth}.. (``deconv{i}b``) with its heads, the
    ConvBlocks after the ladder (``outconv{i}``; none with ``heads``
    False, the raw ladder features of ``raft/cl``)."""
    rules = {}
    for i in range(3):
        rules |= _basic_conv_rules(f"{flax_enc}.ConvBlock_{i}",
                                   f"{torch_enc}.conv0.{i}")
    for i in range(1, depth + 1):
        rules |= _basic_conv_rules(f"{flax_enc}.ConvBlock_{i + 2}",
                                   f"{torch_enc}.conv{i}a")
    for n, i in enumerate(range(depth, 0, -1)):
        rules |= _ga_block_rules(f"{flax_enc}.GaConv2xBlockTransposed_{n}",
                                 f"{torch_enc}.deconv{i}a", True)
    for i in range(1, depth + 1):
        rules |= _ga_block_rules(f"{flax_enc}.GaConv2xBlock_{i - 1}",
                                 f"{torch_enc}.conv{i}b", False)
    n_heads = 0
    for n, i in enumerate(range(depth, min(out_levels), -1)):
        rules |= _ga_block_rules(
            f"{flax_enc}.GaConv2xBlockTransposed_{depth + n}",
            f"{torch_enc}.deconv{i}b", True)
        if heads and i - 1 in out_levels:
            rules |= _basic_conv_rules(
                f"{flax_enc}.ConvBlock_{depth + 3 + n_heads}",
                f"{torch_enc}.outconv{i}")
            n_heads += 1
    return rules


def _rfpm_rules(flax_enc, torch_enc, levels):
    """Rules for one ``FeatureEncoderRfpm``: the stem, per stage the left,
    center and right block pairs (ResidualBlock_* in that order, the
    center's first an RfpmRfdBlock_0 on strided stages) and the two repair
    masks, the heads RfpmOutputNet_* from stage 3 on."""
    rules = {f"{flax_enc}.Conv_0": f"{torch_enc}.conv1",
             f"{flax_enc}.Norm2d_0.BatchNorm_0": f"{torch_enc}.norm1"}
    for stage in range(1, levels + 3):
        flax_stage = f"{flax_enc}._Stage_{stage - 1}"
        tgt = f"{torch_enc}.stage{stage}"
        blocks = [f"{flax_stage}.ResidualBlock_{i}" for i in range(6)]
        if stage > 1:
            blocks = (blocks[:2] + [f"{flax_stage}.RfpmRfdBlock_0"]
                      + blocks[2:5])
        for j, side in enumerate(("left", "center", "right")):
            for k in range(2):
                rules |= _residual_rules(blocks[2 * j + k],
                                         f"{tgt}.{side}.{k}")
        for j, side in enumerate(("c", "r")):
            for k in range(2):
                rules[f"{flax_stage}.RfpmRepairMaskNet_{j}.Conv_{k}"] = \
                    f"{tgt}.repair_{side}.conv{k + 1}"
        if stage >= 3:
            head = f"{flax_enc}.RfpmOutputNet_{stage - 3}"
            rules[f"{head}.Conv_0"] = f"{torch_enc}.out{stage}.conv1"
            rules[f"{head}.Norm2d_0.BatchNorm_0"] = \
                f"{torch_enc}.out{stage}.norm1"
            rules[f"{head}.Conv_1"] = f"{torch_enc}.out{stage}.conv2"
    return rules


def _s3_encoder_rules(flax_enc, torch_enc):
    rules = {f"{flax_enc}._Stem_0.{frag}": tgt
             for frag, tgt in _stem_rules(torch_enc).items()}
    rules[f"{flax_enc}.Conv_0"] = f"{torch_enc}.conv2"
    return rules


def _encoder_rules(named):
    """Rules for the encoders ``named`` ((torch name, module) in the JAX
    module's creation order), by family: each flax module is its class
    name (the port's encoder classes carry the JAX names) with a suffix
    counted per class."""
    rules, seen = {}, {}
    for torch_enc, module in named:
        cls = type(module).__name__
        flax_enc = f"{cls}_{seen.get(cls, 0)}"
        seen[cls] = seen.get(cls, 0) + 1
        if isinstance(module, FeatureEncoderGa):
            rules |= _ga_encoder_rules(flax_enc, torch_enc, module.depth,
                                       module.out_levels, module.heads)
        elif isinstance(module, FeatureEncoderRfpm):
            rules |= _rfpm_rules(flax_enc, torch_enc, module.levels)
        elif isinstance(module, FeatureEncoderPyramid):
            rules |= _pyramid_rules(flax_enc, torch_enc, module.levels)
        else:  # the s3 encoder, the pooled pyramid
            rules |= _s3_encoder_rules(flax_enc, torch_enc)
    return rules


def ctf_rules(levels, share_dicl, share_rnn, upsample_hidden, fnet=None,
              cnet=None, cmod_type="dicl"):
    """flax module path -> torch module path for raft+dicl/ctf-l*.

    Flax submodule suffixes follow creation order, coarse to fine over the
    level ids ``levels + 2 .. 3``: suffix i is torch ``corr_{lvl}`` /
    ``update_block_{lvl}`` of the i-th level id. ``fnet`` and ``cnet``
    (the torch encoders) give their families; None is the raft pyramid.
    """
    level_ids = tuple(range(levels + 2, 2, -1))
    rules = {}

    if fnet is None or cnet is None:
        rules |= _pyramid_rules("FeatureEncoderPyramid_0", "fnet", levels)
        rules |= _pyramid_rules("FeatureEncoderPyramid_1", "cnet", levels)
    else:
        rules |= _encoder_rules((("fnet", fnet), ("cnet", cnet)))

    for i, lvl in enumerate(level_ids):
        suffix = 0 if share_dicl else i
        rules |= _cmod_rules(f"CorrelationModule_{suffix}",
                             "corr" if share_dicl else f"corr_{lvl}",
                             cmod_type)
        # corr-reg-type softargmax+dap: the readout's own DAP
        rules[f"SoftArgMaxFlowRegressionWithDap_{suffix}."
              "DisplacementAwareProjection_0.Conv_0"] = \
            ("flow_reg" if share_dicl else f"flow_reg_{lvl}") + ".dap.conv1"
        rules |= _update_block_rules(
            f"BasicUpdateBlock_{0 if share_rnn else i}",
            "update_block" if share_rnn else f"update_block_{lvl}")

    # the reference l2 variant has a single transition and names its
    # upsampler 'upnet_h' regardless of sharing
    rules |= _hup_rules(level_ids, share_rnn or levels == 2, share_rnn,
                        upsample_hidden)
    rules["Up8Network_0.Conv_0"] = "upnet.conv1"
    rules["Up8Network_0.Conv_1"] = "upnet.conv2"
    return rules


def _hup_rules(level_ids, shared_name, share_rnn, upsample_hidden):
    """The hidden-state upsamplers of the transitions into ``level_ids[1:]``:
    flax suffix 0 when shared, else the transition's index; torch
    ``upnet_h`` when ``shared_name``, else ``upnet_h_{lvl}``."""
    rules = {}
    for i, lvl in enumerate(level_ids[1:]):
        flax_h = 0 if share_rnn else i
        torch_h = "upnet_h" if shared_name else f"upnet_h_{lvl}"
        if upsample_hidden == "bilinear":
            rules[f"HUpBilinear_{flax_h}.Conv_0"] = f"{torch_h}.conv1"
        elif upsample_hidden == "crossattn":
            for j, name in enumerate(("conv_q", "conv_k", "conv_v_prev",
                                      "conv_v_init", "conv_out")):
                rules[f"HUpCrossAttn_{flax_h}.Conv_{j}"] = f"{torch_h}.{name}"
    return rules


def sl_ctf_rules(module):
    """flax module path -> torch module path for a raft/sl-ctf-l*
    ``module``: its encoders by family, per level (coarse to fine, flax
    suffix i for the i-th level id) the update block (suffix 0 when
    shared), the readout's DAPs (``SoftArgMaxFlowRegression_{i}``, one a
    level), the hidden-state upsamplers and the Up8 head. The JAX scan
    body's shared modules live in the parent scope, so no path names the
    scan."""
    level_ids = module.level_ids
    share = module.share_rnn
    rules = _encoder_rules((("fnet", module.fnet), ("cnet", module.cnet)))
    for i, lvl in enumerate(level_ids):
        rules |= _update_block_rules(
            f"BasicUpdateBlock_{0 if share else i}",
            "update_block" if share else f"update_block_{lvl}")
        rules[f"SoftArgMaxFlowRegression_{i}.DisplacementAwareProjection_0"
              ".Conv_0"] = f"flow_reg_{lvl}.dap.0.conv1"
    rules |= _hup_rules(level_ids, share, share, module.upsample_hidden)
    rules["Up8Network_0.Conv_0"] = "upnet.conv1"
    rules["Up8Network_0.Conv_1"] = "upnet.conv2"
    return rules


def _readout_rules(flax_reg, torch_reg):
    """A corr-module readout's own DAP (``softargmax+dap``)."""
    return {f"{flax_reg}.DisplacementAwareProjection_0.Conv_0":
            f"{torch_reg}.dap.conv1"}


def _recurrent_rules():
    """The update block and the Up8 head of the ml and sl modules."""
    return {**_update_block_rules("BasicUpdateBlock_0", "update_block"),
            "Up8Network_0.Conv_0": "upnet.conv1",
            "Up8Network_0.Conv_1": "upnet.conv2"}


def sl_rules(module):
    """flax module path -> torch module path for a raft+dicl/sl
    ``module``: its encoders by family, ``CorrelationModule_0`` (``corr``)
    by corr type, the readout's DAP (``flow_reg``), the update block and
    the Up8 head."""
    rules = _encoder_rules((("fnet", module.fnet), ("cnet", module.cnet)))
    rules |= _cmod_rules("CorrelationModule_0", "corr", module.corr_type)
    rules |= _readout_rules("SoftArgMaxFlowRegressionWithDap_0", "flow_reg")
    return rules | _recurrent_rules()


def _level_encoder_rules(flax_enc, torch_enc, levels):
    rules = {}
    for lvl in range(levels):
        head = f"{flax_enc}._OutputNet_{lvl}"
        rules[f"{head}.Conv_0"] = f"{torch_enc}.out{lvl}.conv1"
        rules[f"{head}.Norm2d_0.BatchNorm_0"] = \
            f"{torch_enc}.out{lvl}.norm1"
        rules[f"{head}.Conv_1"] = f"{torch_enc}.out{lvl}.conv2"
        if lvl:
            rules |= _residual_rules(f"{flax_enc}.ResidualBlock_{lvl - 1}",
                                     f"{torch_enc}.res{lvl}")
    return rules


def ml_rules(module):
    """flax module path -> torch module path for a raft+dicl/ml
    ``module``: the s3 base and context encoders, the frame-1 stack and
    frame-2 pyramid (``raft-cnn``), ``MlCorrelationModule_0`` (``corr``:
    ``MatchingNet_{i}`` per level, or one with ``share-dicl``; the DAPs),
    the raft readout (``corr_reg``), the update block and the Up8 head."""
    levels = module.corr_levels
    rules = _encoder_rules((("fnet", module.fnet), ("cnet", module.cnet)))
    if module.encoder_type == "raft-cnn":
        rules |= _level_encoder_rules("StackEncoder_0", "stack", levels)
        rules |= _level_encoder_rules("PyramidEncoder_0", "pyramid", levels)

    corr = "MlCorrelationModule_0"
    for i in range(1 if module.share_dicl else levels):
        name = "" if module.share_dicl else f"_{i}"
        rules |= _mnet_rules(f"{corr}.MatchingNet_{i}", f"corr.mnet{name}")
        rules[f"{corr}.DisplacementAwareProjection_{i}.Conv_0"] = \
            f"corr.dap{name}.conv1"
    rules[f"{corr}.Conv_0"] = "corr.dap_full"
    for i in range(levels):
        rules[f"SoftArgMaxFlowRegression_0.DisplacementAwareProjection_{i}"
              ".Conv_0"] = f"corr_reg.dap.{i}.conv1"
    return rules | _recurrent_rules()


def dicl_rules(levels=(6, 5, 4, 3, 2)):
    """flax module path -> torch module path for dicl/baseline (and, with
    ``levels`` 6..3, dicl/64to8): ``_dicl_rules`` of
    ``scripts/chkpt_convert.py`` over the ladder's levels. FlowLevel_i is
    the i-th level, coarse to fine."""
    from .models.impls.dicl import _CONTEXT_PLANS

    rules = _ga_encoder_rules("FeatureEncoderGa_0", "feature", 6,
                              tuple(lvl - 1 for lvl in sorted(levels)))
    for idx, lvl in enumerate(sorted(levels, reverse=True)):
        fl = f"FlowLevel_{idx}"
        mnet = f"matching{lvl}.match"
        for i in range(4):
            rules |= _basic_conv_rules(f"{fl}.MatchingNet_0.ConvBlock_{i}",
                                       f"{mnet}.{i}")
        rules |= _basic_conv_rules(f"{fl}.MatchingNet_0.ConvBlockTransposed_0",
                                   f"{mnet}.4", transposed=True)
        rules[f"{fl}.MatchingNet_0.Conv_0"] = f"{mnet}.5"
        rules[f"{fl}.DisplacementAwareProjection_0.Conv_0"] = f"dap{lvl}"

        n_ctx = len(_CONTEXT_PLANS[min(max(lvl, 3), 6)])
        for i in range(n_ctx):
            rules |= _basic_conv_rules(f"{fl}.CtfContextNet_0.ConvBlock_{i}",
                                       f"context_net{lvl}.{i}")
        rules[f"{fl}.CtfContextNet_0.Conv_0"] = f"context_net{lvl}.{n_ctx}"
    return rules


def cl_rules(module):
    """flax module path -> torch module path for a raft/cl ``module``: the
    GA-Net ladder without heads (``fnet``) and the s3 context encoder
    (``cnet``); the heads' conv blocks (``_FeatureNetUp_0`` /
    ``_FeatureNetDown_0``, ``out.{i}``) and the frame-1 head's masks
    (``Conv_0..5``: ``mask5``, ``mask4``, ``mask3``, as the JAX module
    creates them); the correlation module's ``mnets_{i}`` and
    ``daps_{i}``; the update block and the Up8 head."""
    rules = _encoder_rules((("fnet", module.fnet), ("cnet", module.cnet)))
    for flax_head, torch_head in (("_FeatureNetUp_0", "fnet_u"),
                                  ("_FeatureNetDown_0", "fnet_d")):
        for i in range(4):
            rules |= _conv_block_rules(f"{flax_head}.ConvBlock_{i}",
                                       f"{torch_head}.out.{i}")
    for j, lvl in enumerate((5, 4, 3)):
        rules[f"_FeatureNetUp_0.Conv_{2 * j}"] = f"fnet_u.mask{lvl}.0"
        rules[f"_FeatureNetUp_0.Conv_{2 * j + 1}"] = f"fnet_u.mask{lvl}.2"
    corr = "_ClCorrelationModule_0"
    for i in range(4):
        rules |= _mnet_rules(f"{corr}.mnets_{i}", f"corr.mnet.{i}")
        rules[f"{corr}.daps_{i}.Conv_0"] = f"corr.dap.{i}.conv1"
    return rules | _recurrent_rules()


def wip_warp_rules(module):
    """flax module path -> torch module path for a wip/warp/1 ``module``:
    the p26 GA-Net (``fnet``) and the level unit ``_RecurrentLevelUnit_0``
    (``rlu``): ``cvnets_{i}``, ``daps_{i}``, the motion encoder ``menet``,
    the GRU ``gru`` and the flow head ``fhead``."""
    rules = _encoder_rules((("fnet", module.fnet),))
    unit = "_RecurrentLevelUnit_0"
    for i in range(5):
        rules |= _mnet_rules(f"{unit}.cvnets_{i}", f"rlu.cvnets.{i}")
        rules[f"{unit}.daps_{i}.Conv_0"] = f"rlu.daps.{i}.conv1"
    for i in range(3):
        rules[f"{unit}.menet.Conv_{i}"] = f"rlu.menet.{i}"
    for i, name in enumerate(("convz1", "convr1", "convq1",
                              "convz2", "convr2", "convq2")):
        rules[f"{unit}.gru.Conv_{i}"] = f"rlu.gru.{name}"
    for i in range(2):
        rules[f"{unit}.fhead.Conv_{i}"] = f"rlu.fhead.{i}"
    return rules


def wip_recwarp_rules(module):
    """flax module path -> torch module path for a wip/warp/2 ``module``:
    the p26 GA-Net (``fnet``) and per level (finest first) the unit
    ``_RecurrentFlowUnit_{i}`` (``rfu.{i}``: ``mnet``, ``dap``)."""
    rules = _encoder_rules((("fnet", module.fnet),))
    for i in range(len(module.rfu)):
        unit = f"_RecurrentFlowUnit_{i}"
        rules |= _mnet_rules(f"{unit}.MatchingNet_0", f"rfu.{i}.mnet")
        rules[f"{unit}.DisplacementAwareProjection_0.Conv_0"] = \
            f"rfu.{i}.dap.conv1"
    return rules


def rules_for(module):
    """The rules for this package's model ``module``."""
    if isinstance(module, RaftSlCtfModule):
        return sl_ctf_rules(module)
    if isinstance(module, RaftClModule):
        return cl_rules(module)
    if isinstance(module, WipWarpModule):
        return wip_warp_rules(module)
    if isinstance(module, WipRecWarpModule):
        return wip_recwarp_rules(module)
    if isinstance(module, RaftPlusDiclCtfModule):
        return ctf_rules(module.levels, module.share_dicl, module.share_rnn,
                         module.upsample_hidden, module.fnet, module.cnet,
                         module.corr_type)
    if isinstance(module, RaftPlusDiclModule):
        return sl_rules(module)
    if isinstance(module, RaftPlusDiclMlModule):
        return ml_rules(module)
    if isinstance(module, DiclModule):
        return dicl_rules(module.levels)
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
    forward records in raft/baseline, raft/sl and raft/fs: the two S3
    encoders and everything in them, the convex upsampler (batched over
    the iterations, as in both packages) and the whole model
    (``__call__``).
    The recurrent step's modules run inside JAX's scan, whose
    intermediates flax does not keep, and have no point. ``input`` is the
    input of the module named: the encoders' ``_Stem_0`` output is the
    input of their ``conv2``.

    The names follow the S3 rules of :func:`raft_rules` (module paths
    with parameters), plus flax's parameterless wrappers: ``Norm2d_k``
    and its inner ``BatchNorm_0``/``GroupNorm_0`` are one torch norm
    module, ``ResidualBlock_i`` is torch's ``layer{i // 2 + 1}.{i % 2}``.
    Raises ``NotImplementedError`` for the other models."""
    if isinstance(module, RaftPlusDiclCtfModule):
        raise NotImplementedError(
            "activation hooks of the raft+dicl coarse-to-fine models are "
            "not ported yet (ROADMAP slice 2 item 7's rest)")
    if isinstance(module, (RaftPlusDiclMlModule, RaftPlusDiclModule,
                           DiclModule)):
        raise NotImplementedError(
            "activation hooks of raft+dicl/ml, raft+dicl/sl and the dicl "
            "models are not ported yet (ROADMAP slice 2 item 7's rest)")
    if isinstance(module, (RaftSlCtfModule, RaftClModule, WipWarpModule,
                           WipRecWarpModule)):
        raise NotImplementedError(
            "activation hooks of raft/sl-ctf, raft/cl and the wip/warp "
            "models are not ported yet (ROADMAP slice 2 item 7's rest)")
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
