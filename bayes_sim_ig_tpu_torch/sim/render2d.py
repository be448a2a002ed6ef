"""Tiny shared numpy rasterizer for the task schematic renderers (the
``render_obs_frame`` surfaces feeding the RealSurrogate frames). Port of
``bayes_sim_ig_tpu/sim/render2d.py``, with ``draw_lines``, its
``draw_line`` over many segments and frames at once, and ``fill_discs``,
the one-frame disc mask over many frames at once."""

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


def draw_lines(imgs, frame_ids, x0, y0, x1, y1, color, thick=1):
    """Draws segment k onto ``imgs[frame_ids[k]]`` of a (T, H, W, 3) uint8
    batch in place, pixel for pixel as ``draw_line`` draws it, in one pass
    over all segments: their ragged points side by side, the square pen
    written through flat pixel indices."""
    if not imgs.flags.c_contiguous:
        raise ValueError("draw_lines draws into a C-contiguous batch")
    _, height, width, _ = imgs.shape
    frame_ids, x0, y0, x1, y1 = (np.ravel(a) for a in np.broadcast_arrays(
        frame_ids, *(np.asarray(v, np.float64) for v in (x0, y0, x1, y1))))
    n = np.maximum(np.maximum(np.abs(x1 - x0).astype(np.int64),
                              np.abs(y1 - y0).astype(np.int64)), 1) + 1
    seg = np.repeat(np.arange(n.size), n)
    ends = np.cumsum(n)
    i = (np.arange(seg.size) - (ends - n)[seg]).astype(np.float64)
    xs = _ragged_linspace(x0, x1, n, seg, i, ends)
    ys = _ragged_linspace(y0, y1, n, seg, i, ends)
    pen = np.arange(-thick, thick + 1)
    rows = np.clip(ys[:, None] + pen, 0, height - 1)
    cols = np.clip(xs[:, None] + pen, 0, width - 1)
    pix = ((frame_ids[seg].astype(np.int64) * height)[:, None] + rows) * width
    # One 3-byte item a pixel: a write of whole pixels, not of channels.
    pixels = imgs.reshape(-1, 3).view("V3")[:, 0]
    pixels[(pix[:, :, None] + cols[:, None, :]).ravel()] = (
        np.asarray([color], np.uint8).view("V3")[0, 0])


def fill_discs(imgs, frame_ids, cx, cy, r, color):
    """Fills disc k, the pixels ``(xx - cx[k])**2 + (yy - cy[k])**2 <= r*r``
    of integer centres and radius ``r >= 0``, into ``imgs[frame_ids[k]]``
    of a (T, H, W, 3) uint8 batch in place, pixel for pixel as the
    one-frame ``np.ogrid`` mask fills it: one offset stencil laid at every
    centre, its pixels outside the image dropped (not clamped, as
    ``draw_lines`` clamps)."""
    if not imgs.flags.c_contiguous:
        raise ValueError("fill_discs draws into a C-contiguous batch")
    _, height, width, _ = imgs.shape
    frame_ids, cx, cy = (np.ravel(a).astype(np.int64)
                         for a in np.broadcast_arrays(frame_ids, cx, cy))
    off = np.arange(-r, r + 1)
    dy, dx = (a.ravel() for a in np.meshgrid(off, off, indexing="ij"))
    keep = dx * dx + dy * dy <= r * r
    rows = cy[:, None] + dy[keep]
    cols = cx[:, None] + dx[keep]
    inside = (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
    pix = ((frame_ids[:, None] * height + rows) * width + cols)[inside]
    pixels = imgs.reshape(-1, 3).view("V3")[:, 0]
    pixels[pix] = np.asarray([color], np.uint8).view("V3")[0, 0]


def _ragged_linspace(start, stop, n, seg, i, ends):
    """``np.linspace(start[k], stop[k], n[k]).astype(int)`` of every
    segment k, concatenated: numpy's arithmetic (``i * step + start``, or
    ``i / (n - 1) * delta + start`` where the step rounds to 0, the last
    point ``stop``) on the points ``i`` of the segments ``seg``."""
    div = (n - 1).astype(np.float64)
    delta = stop - start
    step = delta / div
    y = i * step[seg]
    zero = (step == 0)[seg]
    if zero.any():
        y[zero] = i[zero] / div[seg][zero] * delta[seg][zero]
    y += start[seg]
    y[ends - 1] = stop
    return y.astype(int)
