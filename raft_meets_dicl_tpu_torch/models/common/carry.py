"""The iteration ladder's carry: what a rung's forward returns beside its
flows, and the convex upsampling every recurrent model shares.

Counterpart of the ``return_state`` blocks of the JAX recurrent models
(``raft.py``, ``raft_fs.py``, ``raft_dicl_ctf.py``, ``raft_dicl_sl.py``,
``raft_dicl_ml.py``): the coarse final flow and hidden state that seed the
next rung (``flow_init``, ``hidden_init``), and ``delta``, the per-sample
root mean square over pixels of the last iteration's flow change, which
the host reads between rungs.

The hidden state crosses in the JAX layout, (B, h, w, C): a permuted view
of the model's NCHW tensor, so a continuation's first update reads the
tensor the monolithic forward's would, strides included.

With ``return_state`` the models upsample only the last iteration: a rung
reads only its final flow, and the Up8 head then runs at batch B in every
rung, so a chain of rungs computes what one longer forward computes, bit
for bit (the head's batch of ``iterations · B`` would let the convolution
library pick another algorithm per rung length).
"""

import torch

from ...ops.upsample import interpolate_bilinear


def upsample_iterations(upnet, hiddens, flows, shape, use_upnet,
                        last_only=False):
    """Convex 8x upsampling of every iteration's flow at once (the kernel
    launches once), or 8x bilinear without the head; one (B, H, W, 2) per
    iteration. ``last_only`` upsamples the last iteration alone (a
    one-element list)."""
    if last_only:
        hiddens, flows = hiddens[-1:], flows[-1:]
    b = flows[0].shape[0]
    flows_flat = torch.cat(flows, dim=0)
    if use_upnet:
        ups = upnet(torch.cat(hiddens, dim=0), flows_flat)
    else:
        ups = 8.0 * interpolate_bilinear(flows_flat, shape)
    return list(ups.split(b, dim=0))


def initial_flow(flow_init, b, h, w, device):
    """The float32 (B, h, w, 2) flow a recurrence starts from: the carried
    ``flow_init``, else zeros."""
    if flow_init is not None:
        return flow_init.float()
    return torch.zeros((b, h, w, 2), dtype=torch.float32, device=device)


def initial_hidden(hidden_init, like):
    """The carried (B, h, w, C) hidden state as the model's NCHW tensor,
    in the dtype of ``like`` (the context tanh it replaces)."""
    return hidden_init.permute(0, 3, 1, 2).to(like.dtype)


def rung_state(flows, start, hidden):
    """``{"flow", "hidden", "delta"}`` of a recurrence that ran ``flows``
    (its per-iteration coarse flows) from ``start`` (the flow it entered
    with) and ended at ``hidden`` (NCHW)."""
    final = flows[-1]
    prev = flows[-2] if len(flows) >= 2 else start
    diff = (final - prev).float()
    delta = torch.sqrt(torch.mean(torch.sum(diff * diff, dim=-1),
                                  dim=(1, 2)))
    return {"flow": final, "hidden": hidden.permute(0, 2, 3, 1),
            "delta": delta}
