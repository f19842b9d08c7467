"""Metric math on tensors (counterpart of
``raft_meets_dicl_tpu/metrics/functional.py``).

Every function returns 0-d tensors on its inputs' device and reads
nothing back to the host; ``common.fetch`` brings many of them over in one
copy. Flow tensors are NHWC, as in the JAX package: ``estimate`` and
``target`` are (..., H, W, 2), ``valid`` is (..., H, W).
"""

import math

import torch


def masked_mean(x, valid):
    """Mean of ``x`` over pixels where ``valid``; 0 if no pixel is valid."""
    v = valid.to(x.dtype)
    return torch.sum(x * v) / torch.clamp(torch.sum(v), min=1.0)


def _epe(estimate, target):
    return torch.linalg.vector_norm(estimate.float() - target.float(), dim=-1)


def end_point_error(estimate, target, valid, distances=(1, 3, 5)):
    """EPE mean and, for each ``d``, the fraction of valid pixels with EPE
    <= d (``{d}px``), over valid pixels."""
    epe = _epe(estimate, target)
    out = {"mean": masked_mean(epe, valid)}
    for d in distances:
        out[f"{d}px"] = masked_mean((epe <= d).float(), valid)
    return out


def fl_all(estimate, target, valid):
    """KITTI Fl-all: the fraction of valid pixels with EPE > 3 px and
    EPE > 5% of the target's magnitude."""
    epe = _epe(estimate, target)
    mag = torch.linalg.vector_norm(target.float(), dim=-1)
    bad = torch.logical_and(epe > 3.0, epe > 0.05 * mag)
    return masked_mean(bad.float(), valid)


def average_angular_error(estimate, target, valid=None):
    """Mean angular error in degrees between (u, v, 1) vectors, the
    published formula (see the JAX function); ``valid`` restricts the mean
    to valid pixels."""
    estimate, target = estimate.float(), target.float()
    u_est, v_est = estimate[..., 0], estimate[..., 1]
    u_tgt, v_tgt = target[..., 0], target[..., 1]

    n_est = torch.sqrt(u_est ** 2 + v_est ** 2 + 1.0)
    n_tgt = torch.sqrt(u_tgt ** 2 + v_tgt ** 2 + 1.0)

    cos = (u_est * u_tgt + v_est * v_tgt + 1.0) / (n_est * n_tgt)
    angles = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    mean = torch.mean(angles) if valid is None else masked_mean(angles, valid)
    return mean * (180.0 / math.pi)


def flow_magnitude(estimate, ord=2, valid=None):
    """Mean per-pixel flow-vector norm; ``valid`` restricts the mean to
    valid pixels."""
    mag = torch.linalg.vector_norm(estimate.float(), ord=ord, dim=-1)
    return torch.mean(mag) if valid is None else masked_mean(mag, valid)


# -- gradient / parameter statistics, per named tensor ---------------------------
#
# ``named`` maps parameter names to tensors; the statistics come in sorted
# name order, as JAX flattens its parameter tree.


def tree_norm(named, ord=2):
    """Per-tensor norms and their norm, ``total``: ``named`` is a mapping
    of name -> tensor."""
    norms = {n: torch.linalg.vector_norm(t.detach().float().reshape(-1),
                                         ord=ord)
             for n, t in sorted(named.items())}
    norms["total"] = torch.linalg.vector_norm(
        torch.stack(list(norms.values())), ord=ord)
    return norms


def tree_mean(named):
    """Per-tensor (size, mean) and the size-weighted ``total``."""
    mean = {n: (t.numel(), torch.mean(t.detach().float()))
            for n, t in sorted(named.items())}
    total = sum(n for n, _ in mean.values()) or 1
    mean["total"] = (total, sum((n / total) * m for n, m in mean.values()))
    return mean


def tree_minmax(named):
    """Per-tensor (min, max) and the overall ``total``."""
    mm = {n: (torch.min(t.detach()).float(), torch.max(t.detach()).float())
          for n, t in sorted(named.items())}
    mm["total"] = (torch.min(torch.stack([lo for lo, _ in mm.values()])),
                   torch.max(torch.stack([hi for _, hi in mm.values()])))
    return mm
