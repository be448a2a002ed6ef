"""Tiny shared numpy rasterizer for the task schematic renderers (the
``render_obs_frame`` surfaces feeding the RealSurrogate frames). Port of
``bayes_sim_ig_tpu/sim/render2d.py``."""

import numpy as np


def draw_line(img, x0, y0, x1, y1, color, thick=1):
    """Draws a pixel line with square thickness onto an (H, W, 3) uint8
    image in place, clipping to the image bounds."""
    height, width = img.shape[:2]
    # +1 so both endpoints always draw (sub-pixel segments otherwise
    # collapse to the start pixel alone).
    n = max(int(abs(x1 - x0)), int(abs(y1 - y0)), 1) + 1
    xs = np.linspace(x0, x1, n).astype(int)
    ys = np.linspace(y0, y1, n).astype(int)
    for dx in range(-thick, thick + 1):
        for dy in range(-thick, thick + 1):
            img[np.clip(ys + dy, 0, height - 1),
                np.clip(xs + dx, 0, width - 1)] = color
