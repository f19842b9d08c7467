"""Forwards-backwards consistency products: occlusion masks + confidence
(own copy of ``raft_meets_dicl_tpu/video/products.py``).

Running the estimator both ways over a frame pair — forward
``flow_fw = F(img1, img2)`` and backward ``flow_bw = F(img2, img1)`` —
buys a per-pixel consistency signal: where both directions see the same
surface, ``flow_fw(p) + flow_bw(p + flow_fw(p)) ≈ 0``; where a pixel is
occluded in the second frame (or the estimate is just wrong), the round
trip does not return home. The classic criterion (Sundaram, Brox &
Keutzer, ECCV 2010) thresholds the squared round-trip error against a
motion-magnitude-relative bound:

    |fw + bw∘fw|²  >  alpha * (|fw|² + |bw∘fw|²) + beta

Everything here is host-side numpy on fetched flows, as in the JAX
package, so the two agree bit for bit: ``main evaluate --fwbw`` runs the
reversed pair through the same inference step and derives the products
per sample on the host (O(HW) work, small beside a forward).
"""

import numpy as np

DEFAULT_ALPHA = 0.01
DEFAULT_BETA = 0.5


def warp_flow(flow_b, flow_a):
    """Backward-warp ``flow_b`` along ``flow_a``: ``out(p) =
    flow_b(p + flow_a(p))`` bilinearly, plus an in-bounds mask.

    flow_a, flow_b: (H, W, 2) float arrays, channel 0 = x. Returns
    ``(warped (H, W, 2), inside (H, W) bool)``; samples falling outside
    the image are zero-filled and flagged outside.
    """
    flow_a = np.asarray(flow_a, np.float32)
    flow_b = np.asarray(flow_b, np.float32)
    h, w = flow_a.shape[:2]
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    x = xs + flow_a[..., 0]
    y = ys + flow_a[..., 1]
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)

    x0 = np.clip(np.floor(x), 0, w - 2).astype(np.int64)
    y0 = np.clip(np.floor(y), 0, h - 2).astype(np.int64)
    fx = np.clip(x - x0, 0.0, 1.0)[..., None]
    fy = np.clip(y - y0, 0.0, 1.0)[..., None]

    v00 = flow_b[y0, x0]
    v01 = flow_b[y0, x0 + 1]
    v10 = flow_b[y0 + 1, x0]
    v11 = flow_b[y0 + 1, x0 + 1]
    warped = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
              + fy * ((1 - fx) * v10 + fx * v11))
    return np.where(inside[..., None], warped, 0.0), inside


def fw_bw_products(flow_fw, flow_bw, alpha=DEFAULT_ALPHA,
                   beta=DEFAULT_BETA):
    """Occlusion mask + confidence from a forward/backward flow pair.

    flow_fw, flow_bw: (H, W, 2). Returns ``(occlusion (H, W) bool,
    confidence (H, W) float32 in (0, 1])`` in the *first* frame's
    coordinates. Pixels whose forward flow leaves the image are
    occluded by definition (nothing to check against); confidence is
    ``1 / (1 + round_trip_err²)`` so consistent pixels sit near 1 and
    the scale degrades smoothly rather than cliffing at the mask
    threshold.
    """
    flow_fw = np.asarray(flow_fw, np.float32)
    flow_bw = np.asarray(flow_bw, np.float32)
    if flow_fw.shape != flow_bw.shape or flow_fw.shape[-1] != 2:
        raise ValueError(
            f"flow pair must share an (H, W, 2) shape, got "
            f"{flow_fw.shape} vs {flow_bw.shape}")
    bw_at_fw, inside = warp_flow(flow_bw, flow_fw)
    diff = flow_fw + bw_at_fw
    err2 = np.sum(diff * diff, axis=-1)
    mag2 = (np.sum(flow_fw * flow_fw, axis=-1)
            + np.sum(bw_at_fw * bw_at_fw, axis=-1))
    occluded = (err2 > alpha * mag2 + beta) | ~inside
    confidence = (1.0 / (1.0 + err2)).astype(np.float32)
    confidence[~inside] = 0.0
    return occluded, confidence


def fw_bw_products_batch(flow_fw, flow_bw, alpha=DEFAULT_ALPHA,
                         beta=DEFAULT_BETA):
    """Batched :func:`fw_bw_products`: (B, H, W, 2) pairs -> stacked
    (B, H, W) masks/confidences."""
    occ, conf = zip(*(fw_bw_products(f, b, alpha=alpha, beta=beta)
                      for f, b in zip(flow_fw, flow_bw)))
    return np.stack(occ), np.stack(conf)
