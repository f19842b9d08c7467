"""Forwards/backwards flow pairing sources.

Two ways to train on both temporal directions (reference:
src/data/fw_bw_batch.py, fw_bw_est.py):

- ``forwards-backwards-batch`` zips a forward-layout and a backward-layout
  view of the same data and concatenates them along the batch axis (ground
  truth exists for both directions, e.g. FlyingChairs2).
- ``forwards-backwards-estimate`` *computes* the backward flow from the
  forward ground truth by inverse-flow estimation (weighted bilinear
  splatting after Sánchez, Salgado & Monzón 2015, methods 3/4) plus optional
  disocclusion fill.

All host-side numpy (an own copy of the JAX package's ``data/fw_bw.py``).
"""

import copy

import numpy as np

from .collection import Collection


class ForwardsBackwardsBatch(Collection):
    type = "forwards-backwards-batch"

    @classmethod
    def from_config(cls, path, cfg):
        from . import config as data_config

        cls._typecheck(cfg)
        return cls(
            data_config.load(path, cfg["forwards"]),
            data_config.load(path, cfg["backwards"]),
        )

    def __init__(self, forwards, backwards):
        super().__init__()
        assert len(forwards) == len(backwards)
        self.forwards = forwards
        self.backwards = backwards

    def get_config(self):
        return {
            "type": self.type,
            "forwards": self.forwards.get_config(),
            "backwards": self.backwards.get_config(),
        }

    def __getitem__(self, index):
        # both layouts sort by first-frame key, so index i is the same pair
        img1_fw, img2_fw, flow_fw, valid_fw, meta_fw = self.forwards[index]
        img1_bw, img2_bw, flow_bw, valid_bw, meta_bw = self.backwards[index]

        assert img1_fw.shape[:3] == img1_bw.shape[:3]
        for mf, mb in zip(meta_fw, meta_bw):
            assert mf.sample_id.img1 == mb.sample_id.img2
            assert mf.sample_id.img2 == mb.sample_id.img1

        for m in meta_fw:
            m.direction = "forwards"
        for m in meta_bw:
            m.direction = "backwards"

        img1 = np.concatenate((img1_fw, img1_bw), axis=0)
        img2 = np.concatenate((img2_fw, img2_bw), axis=0)

        flow, valid = None, None
        if flow_fw is not None:
            flow = np.concatenate((flow_fw, flow_bw), axis=0)
            valid = np.concatenate((valid_fw, valid_bw), axis=0)

        return img1, img2, flow, valid, meta_fw + meta_bw

    def __len__(self):
        return len(self.forwards)

    def description(self):
        return f"Forwards/Backwards batch: '{self.forwards.description()}'"


class ForwardsBackwardsEstimate(Collection):
    type = "forwards-backwards-estimate"

    @classmethod
    def from_config(cls, path, cfg):
        from . import config as data_config

        cls._typecheck(cfg)

        fill = cfg.get("fill", {})
        return cls(
            data_config.load(path, cfg["source"]),
            cfg.get("parameters", {}),
            fill.get("method", "none"),
            fill.get("parameters", {}),
        )

    def __init__(self, source, parameters, fill_method, fill_args):
        super().__init__()
        self.source = source
        self.parameters = parameters
        self.fill_method = fill_method
        self.fill_args = fill_args

    def get_config(self):
        return {
            "type": self.type,
            "source": self.source.get_config(),
            "fill": {"method": self.fill_method, "parameters": self.fill_args},
            "parameters": self.parameters,
        }

    def __getitem__(self, index):
        img1_fw, img2_fw, flow_fw, valid_fw, meta_fw = self.source[index]

        flow_bw, valid_bw = None, None
        if flow_fw is not None:
            est = [
                estimate_backwards_flow(
                    img1_fw[i], img2_fw[i], flow_fw[i], valid_fw[i],
                    fill_method=self.fill_method, fill_args=self.fill_args,
                    **self.parameters,
                )
                for i in range(img1_fw.shape[0])
            ]
            flow_bw = np.stack([e[0] for e in est], axis=0)
            valid_bw = np.stack([e[1] for e in est], axis=0)

        meta_bw = copy.deepcopy(meta_fw)
        for m in meta_fw:
            m.sample_id.format += "-fwd"
            m.direction = "forwards"
        for m in meta_bw:
            m.sample_id.format += "-bwd"
            m.direction = "backwards"

        img1 = np.concatenate((img1_fw, img2_fw), axis=0)
        img2 = np.concatenate((img2_fw, img1_fw), axis=0)

        flow, valid = None, None
        if flow_fw is not None:
            flow = np.concatenate((flow_fw, flow_bw), axis=0)
            valid = np.concatenate((valid_fw, valid_bw), axis=0)

        return img1, img2, flow, valid, meta_fw + meta_bw

    def __len__(self):
        return len(self.source)

    def description(self):
        return f"Forwards/Backwards estimation: '{self.source.description()}'"


def estimate_backwards_flow_sparse(img1, img2, flow, valid, th_weight=0.25,
                                   s_motion=1.0, p_motion=1.0, s_similarity=1.0,
                                   p_similarity=2.0, eps=1e-9):
    """Inverse a dense forward flow by weighted bilinear splatting.

    Each valid source pixel projects to ``p + flow(p)`` in frame 2 and
    splats ``-flow(p)`` onto the four surrounding integer pixels. Splat
    weights combine the bilinear kernel (zeroed below ``th_weight``) with a
    motion prior (larger motions win at occlusions, scaled ``s_motion``,
    power ``p_motion`` on the squared magnitude) and a visual-similarity
    prior between frame-1 source and frame-2 target pixels
    (``s_similarity * (1 - d)^p_similarity``). Pixels receiving no splats
    are disocclusions: invalid, NaN flow.

    Returns ``(flow_bw, valid_bw)``.
    """
    h, w = flow.shape[:2]

    ys, xs = np.mgrid[0:h, 0:w]
    tx = xs + flow[..., 0]
    ty = ys + flow[..., 1]

    mag2 = np.sum(np.square(flow), axis=-1)
    motion_score = s_motion * mag2**p_motion

    fx = np.floor(tx)
    fy = np.floor(ty)

    accum_uv = np.zeros(h * w * 2)
    accum_w = np.zeros(h * w)

    for cx, cy in ((fx, fy), (fx + 1, fy), (fx, fy + 1), (fx + 1, fy + 1)):
        # bilinear splat kernel; at integer targets the floor corner gets
        # weight 1 and the rest 0, so no degenerate special case is needed
        wgt = np.clip(1.0 - np.abs(tx - cx), 0.0, 1.0) * np.clip(
            1.0 - np.abs(ty - cy), 0.0, 1.0
        )
        wgt[wgt < th_weight] = 0.0

        inb = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
        ix = np.clip(cx, 0, w - 1).astype(np.int64)
        iy = np.clip(cy, 0, h - 1).astype(np.int64)

        # visual similarity between the source pixel and the splat target
        d = np.sum(np.square(img1 - img2[iy, ix]), axis=-1)

        wgt = wgt * (motion_score + s_similarity * (1.0 - d) ** p_similarity)
        wgt = np.where(valid & inb, wgt, 0.0)

        idx = iy * w + ix
        accum_w += np.bincount(idx.ravel(), weights=wgt.ravel(), minlength=h * w)
        duv = flow * wgt[..., None]
        accum_uv += np.bincount(
            (idx[..., None] * 2 + np.arange(2)).ravel(),
            weights=duv.ravel(),
            minlength=h * w * 2,
        )

    accum_uv = accum_uv.reshape(h, w, 2)
    accum_w = accum_w.reshape(h, w)

    valid_bw = accum_w >= eps
    denom = np.where(valid_bw, accum_w, 1.0)
    flow_bw = -accum_uv / denom[..., None]
    flow_bw[~valid_bw] = np.nan

    return flow_bw, valid_bw


def estimate_backwards_flow(img1, img2, flow, valid, th_weight=0.25, s_motion=1.0,
                            p_motion=1.0, s_similarity=1.0, p_similarity=2.0,
                            eps=1e-9, fill_method="none", fill_args={}):
    """Full backward-flow estimation: sparse inversion + disocclusion fill."""
    flow_bw, valid_bw = estimate_backwards_flow_sparse(
        img1, img2, flow, valid, th_weight, s_motion, p_motion,
        s_similarity, p_similarity, eps,
    )

    if fill_method == "minimum":
        flow_bw, valid_bw = fill_min(flow_bw, valid_bw, **fill_args)
    elif fill_method == "average":
        flow_bw, valid_bw = fill_avg(flow_bw, valid_bw, **fill_args)
    elif fill_method != "none":
        raise ValueError(f"invalid fill method '{fill_method}'")

    return flow_bw, valid_bw


def _windows(arr, kernel_size, fill):
    """Zero-padded sliding windows of shape (H, W, kh*kw)."""
    p_y, p_x = (kernel_size[0] - 1) // 2, (kernel_size[1] - 1) // 2
    padded = np.pad(arr, ((p_y, p_y), (p_x, p_x)), mode="constant", constant_values=fill)
    view = np.lib.stride_tricks.sliding_window_view(padded, kernel_size)
    return view.reshape(*view.shape[:2], -1)


def _fill_min_once(flow, valid, kernel_size):
    """Fill invalid pixels with the smallest-magnitude valid flow nearby."""
    u = np.where(valid, flow[..., 0], 0.0)
    v = np.where(valid, flow[..., 1], 0.0)
    mag = np.where(valid, u * u + v * v, np.inf)

    mag_w = _windows(mag, kernel_size, np.inf)
    idx = np.argmin(mag_w, axis=-1)[..., None]

    u_min = np.take_along_axis(_windows(u, kernel_size, 0.0), idx, axis=-1)[..., 0]
    v_min = np.take_along_axis(_windows(v, kernel_size, 0.0), idx, axis=-1)[..., 0]
    has_any = np.isfinite(np.take_along_axis(mag_w, idx, axis=-1)[..., 0])

    out = np.copy(flow)
    out[~valid, 0] = u_min[~valid]
    out[~valid, 1] = v_min[~valid]

    return out, valid | has_any


def fill_min(flow, valid, kernel_size=(5, 5), n_iter=None):
    """Iterate minimum-fill until dense (or for ``n_iter`` rounds)."""
    kernel_size = tuple(kernel_size)
    if n_iter is not None:
        for _ in range(n_iter):
            flow, valid = _fill_min_once(flow, valid, kernel_size)
    else:
        while not np.all(valid):
            flow, valid = _fill_min_once(flow, valid, kernel_size)
    return flow, valid


def _fill_avg_once(flow, valid, kernel_size, threshold):
    """Fill invalid pixels with the mean of ≥``threshold`` valid neighbors."""
    u = np.where(valid, flow[..., 0], 0.0)
    v = np.where(valid, flow[..., 1], 0.0)

    count = _windows(valid.astype(np.float64), kernel_size, 0.0).sum(axis=-1)
    denom = np.maximum(count, 1.0)
    u_avg = _windows(u, kernel_size, 0.0).sum(axis=-1) / denom
    v_avg = _windows(v, kernel_size, 0.0).sum(axis=-1) / denom

    enough = count >= threshold
    fill = ~valid & enough

    out = np.copy(flow)
    out[fill, 0] = u_avg[fill]
    out[fill, 1] = v_avg[fill]

    # previously-valid pixels stay valid (a fill must never lose data, and
    # dropping them can make the until-dense loop diverge)
    return out, valid | enough


def fill_avg(flow, valid, kernel_size=(5, 5), threshold=5, n_iter=None):
    """Iterate average-fill until dense (or for ``n_iter`` rounds)."""
    kernel_size = tuple(kernel_size)
    if n_iter is not None:
        for _ in range(n_iter):
            flow, valid = _fill_avg_once(flow, valid, kernel_size, threshold)
    else:
        while not np.all(valid):
            flow, valid = _fill_avg_once(flow, valid, kernel_size, threshold)
    return flow, valid
