"""3D skeleton rendering to PNG frames or an animated GIF (matplotlib).

Port of ``mpe3d_tpu/viz/viewer.py`` (``remap_axes`` :25, ``render_frame``
:34, ``render_sequence`` :79), the headless counterpart of the reference's
pyqtgraph window (test/show_results_from_model.py:78-376): per-frame
multi-person COCO-18 skeletons in the rig's display axes
(``RigConfig.axes_3d``).  matplotlib (with Pillow for the GIF) is imported
by ``render_sequence`` when it is called, so the module imports without
it; where they are not installed, the HTML viewers (standard library
only) take their place.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from mpe3d_tpu_torch.config import COCO_BONES, RigConfig

# half-width of the view cube (m), shared by every renderer
VIEW_LIM = 2.5

_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
           "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan"]


def remap_axes(poses: np.ndarray, rig_config: RigConfig) -> np.ndarray:
    """World coords → display coords via the rig's axis map
    (label -> (source index, sign))."""
    out = np.zeros_like(poses)
    for axis_i, (_, (src, sign)) in enumerate(rig_config.axes_3d):
        out[..., axis_i] = sign * poses[..., src]
    return out


def render_frame(ax, poses: np.ndarray, rig_config: RigConfig,
                 gt: Optional[np.ndarray] = None,
                 track_ids: Optional[np.ndarray] = None,
                 quality: Optional[np.ndarray] = None) -> None:
    """Draw one frame of [P, J, 3] display-space poses on a 3D axis.

    ``track_ids`` keys each person's colour (stable across frames — the
    tracking extension's ids; positional colouring otherwise) and is shown
    above the head together with the ``quality`` column (px) when given.
    """
    ax.clear()
    for pi, person in enumerate(poses):
        key = int(track_ids[pi]) if track_ids is not None else pi
        color = _COLORS[key % len(_COLORS)]
        for a, b in COCO_BONES:
            ax.plot(*zip(person[a], person[b]), color=color, lw=2)
        ax.scatter(person[:, 0], person[:, 1], person[:, 2],
                   color=color, s=8)
        label = []
        if track_ids is not None:
            label.append(f"id {key}")
        if quality is not None and quality[pi] >= 0:
            label.append(f"{quality[pi]:.1f}px")
        if label:
            top = person[np.argmax(person[:, 2])]
            ax.text(top[0], top[1], top[2] + 0.08, " ".join(label),
                    color=color, fontsize=8, ha="center")
    if gt is not None:
        for person in gt:
            for a, b in COCO_BONES:
                ax.plot(*zip(person[a], person[b]), color="k", lw=0.8,
                        alpha=0.5, linestyle="--")
    ax.set_xlim(-VIEW_LIM, VIEW_LIM)
    ax.set_ylim(-VIEW_LIM, VIEW_LIM)
    ax.set_zlim(0, VIEW_LIM)
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")


def render_sequence(frames_poses: List[np.ndarray], rig_config: RigConfig,
                    out_path: str,
                    frames_gt: Optional[List[np.ndarray]] = None,
                    fps: int = 10,
                    frames_track_ids: Optional[List[np.ndarray]] = None,
                    frames_quality: Optional[List[np.ndarray]] = None
                    ) -> str:
    """Render a sequence of per-frame [P, J, 3] world poses.

    out_path ending in .gif → animated GIF; otherwise a directory of PNGs.
    ``frames_track_ids``/``frames_quality`` (per-frame [P] arrays) overlay
    stable identity colours and the per-pose quality column.
    Returns the written path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")

    display = [remap_axes(p, rig_config) if len(p) else p
               for p in frames_poses]
    gt_disp = ([remap_axes(g, rig_config) if g is not None and len(g) else None
                for g in frames_gt] if frames_gt else [None] * len(display))
    tids = frames_track_ids or [None] * len(display)
    quals = frames_quality or [None] * len(display)

    if out_path.endswith(".gif"):
        from matplotlib.animation import FuncAnimation, PillowWriter

        def update(i):
            render_frame(ax, display[i], rig_config, gt_disp[i],
                         track_ids=tids[i], quality=quals[i])
            ax.set_title(f"frame {i}")

        anim = FuncAnimation(fig, update, frames=len(display))
        anim.save(out_path, writer=PillowWriter(fps=fps))
    else:
        os.makedirs(out_path, exist_ok=True)
        for i in range(len(display)):
            render_frame(ax, display[i], rig_config, gt_disp[i],
                         track_ids=tids[i], quality=quals[i])
            ax.set_title(f"frame {i}")
            fig.savefig(os.path.join(out_path, f"frame_{i:05d}.png"),
                        dpi=80)
    plt.close(fig)
    return out_path
