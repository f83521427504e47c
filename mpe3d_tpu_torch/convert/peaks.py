"""Heatmap peak finding and sub-pixel refinement.

Port of ``mpe3d_tpu/convert/peaks.py`` (``find_peaks`` :26,
``refine_peaks`` :51), itself the reference's trt_pose plugins
(panoptic_conversor/get_joints_from_panoptic_model.py:57-72):

* ``find_peaks``: a cell is a peak iff it is >= every value of its
  (2w+1)^2 window (cells past the border count as -inf) and above the
  threshold; up to ``max_peaks`` a channel, by value descending.  Equal
  values keep the lower flat index first, as ``lax.top_k`` does: a stable
  descending sort (``torch.topk`` promises no tie order), so the two cells
  of a plateau are both peaks and come out in row-major order.
* ``refine_peaks``: the confidence-weighted centroid of the clamped window
  around each peak, normalised to [0, 1] with the +0.5 cell-centre offset;
  empty slots give -1.

Plain PyTorch on the tensor's device: no TPU kernel computes these (the
JAX package runs them as XLA ops).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def find_peaks(cmap: torch.Tensor, threshold: float = 0.15,
               window: int = 5, max_peaks: int = 100
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cmap: [J, H, W] heatmaps.  Returns (counts [J] int32, peaks
    [J, max_peaks, 2] int32 (row, col), invalid slots -1), by confidence
    descending."""
    J, H, W = cmap.shape
    w = window // 2
    pooled = F.max_pool2d(cmap[None], window, stride=1, padding=w)[0]
    is_peak = (cmap >= pooled) & (cmap > threshold)
    flat = torch.where(is_peak, cmap,
                       torch.full_like(cmap, -torch.inf)).reshape(J, H * W)
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :max_peaks], idx[:, :max_peaks]
    ok = torch.isfinite(vals)
    neg = torch.full_like(idx, -1)
    rows = torch.where(ok, torch.div(idx, W, rounding_mode="floor"), neg)
    cols = torch.where(ok, idx % W, neg)
    counts = ok.sum(dim=1, dtype=torch.int32)
    return counts, torch.stack([rows, cols], dim=-1).to(torch.int32)


def refine_peaks(peaks: torch.Tensor, cmap: torch.Tensor,
                 window: int = 5) -> torch.Tensor:
    """peaks: [J, K, 2] (row, col); cmap: [J, H, W].  Returns [J, K, 2]
    normalised (x = col / W, y = row / H) coordinates with the +0.5
    cell-centre offset; invalid peaks give -1."""
    J, H, W = cmap.shape
    wr = window // 2
    off = torch.arange(-wr, wr + 1, device=cmap.device)
    dr, dc = torch.meshgrid(off, off, indexing="ij")
    dr, dc = dr.reshape(-1), dc.reshape(-1)                    # [w*w]
    r0 = peaks[..., 0].long()[..., None]                       # [J, K, 1]
    c0 = peaks[..., 1].long()[..., None]
    # border samples clamp to the image edge (trt_pose behaviour)
    rr = torch.clamp(r0 + dr, 0, H - 1)
    cc = torch.clamp(c0 + dc, 0, W - 1)
    flat = cmap.reshape(J, H * W)
    v = torch.gather(flat, 1, (rr * W + cc).reshape(J, -1)).reshape(rr.shape)
    wsum = torch.clamp(v.sum(-1), min=1e-12)
    ry = ((v * (r0 + dr)).sum(-1) / wsum + 0.5) / H
    cx = ((v * (c0 + dc)).sum(-1) / wsum + 0.5) / W
    out = torch.stack([cx, ry], dim=-1)
    return torch.where((peaks[..., :1] < 0), torch.full_like(out, -1.0), out)
