"""The batched frames on the CPU: ``sim/render2d.py::draw_lines`` against a
loop of ``draw_line`` over the same segments, ``fill_discs`` against the
one-frame ``np.ogrid`` disc mask, and ``utils/collect.py::_render_env0``
through a task's batch renderer (ShadowHand's and Humanoid's
``render_obs_frames``) and frame by frame (Pendulum), with collection's
frame counters."""

import numpy as np
import pytest

from bayes_sim_ig_tpu_torch.sim import make_env
from bayes_sim_ig_tpu_torch.sim.render2d import (
    draw_line, draw_lines, fill_discs,
)
from bayes_sim_ig_tpu_torch.utils import collect

from . import torch_task_checks as tc

H, W = 40, 60


def _segments(rs):
    """(frame, x0, y0, x1, y1) rows: zero-length, sub-pixel, horizontal,
    vertical, steep, shallow, reversed, partly and wholly outside the
    image, a step that underflows to 0, one whose last point would round
    below its end but for linspace's ``stop``, then random ones, over 3
    frames."""
    fixed = [(0, 10.0, 10.0, 10.0, 10.0), (0, 5.2, 7.9, 5.6, 8.3),
             (1, 3.0, 20.0, 50.5, 20.0), (1, 30.0, 2.0, 30.0, 37.7),
             (2, 12.3, 1.0, 15.1, 38.9), (2, 1.0, 30.2, 58.7, 33.9),
             (0, 55.5, 35.5, 4.4, 2.2), (1, -15.0, -7.5, 20.0, 25.0),
             (2, 40.0, 30.0, 90.0, 70.0), (0, -30.0, -30.0, -5.0, -40.0),
             (1, 0.0, 1.0, 5e-324, 3.5), (2, 4.4, 12.0, 51.0, 12.0)]
    rand = np.column_stack([
        rs.randint(0, 3, 40), rs.uniform(-20, W + 20, (40, 2)),
        rs.uniform(-20, H + 20, (40, 2))])[:, [0, 1, 3, 2, 4]]
    return np.concatenate([np.array(fixed), rand])


@pytest.mark.parametrize("thick", [0, 1, 2])
def test_draw_lines_equals_a_loop_of_draw_line(thick):
    rs = np.random.RandomState(thick)
    segs = _segments(rs)
    start = rs.randint(0, 256, (3, H, W, 3)).astype(np.uint8)
    want = start.copy()
    for f, x0, y0, x1, y1 in segs:
        draw_line(want[int(f)], x0, y0, x1, y1, (204, 77, 77), thick)
    got = start.copy()
    draw_lines(got, segs[:, 0].astype(int), segs[:, 1], segs[:, 2],
               segs[:, 3], segs[:, 4], (204, 77, 77), thick)
    assert np.array_equal(got, want)
    assert (got != start).any(axis=-1).sum() > 100


def test_draw_lines_refuses_a_strided_batch():
    imgs = np.zeros((2, H, W, 3), np.uint8)[:, ::2]
    with pytest.raises(ValueError, match="C-contiguous"):
        draw_lines(imgs, [0], [1.0], [1.0], [5.0], [5.0], (1, 2, 3))


@pytest.mark.parametrize("r", [3, 8, 12])
def test_fill_discs_equals_the_one_frame_mask(r):
    """Discs centred inside the image, on each edge and corner, wholly
    outside it, several on one frame, over a batch of 4 frames: each
    frame equals the ``np.ogrid`` mask written disc by disc."""
    rs = np.random.RandomState(r)
    fixed = [(0, 30, 20), (0, 0, 20), (1, W - 1, 20), (1, 30, 0),
             (2, 30, H - 1), (2, 0, 0), (3, W - 1, H - 1), (3, -r, 20),
             (0, W + r, 5), (1, 30, -r - 1), (2, 10, H + 2 * r),
             (3, -50, -50), (3, 2, H - 3)]
    rand = np.column_stack([rs.randint(0, 4, 30),
                            rs.randint(-r - 2, W + r + 2, 30),
                            rs.randint(-r - 2, H + r + 2, 30)])
    discs = np.concatenate([np.array(fixed), rand])
    start = rs.randint(0, 256, (4, H, W, 3)).astype(np.uint8)
    want = start.copy()
    yy, xx = np.ogrid[:H, :W]
    for f, cx, cy in discs:
        want[f][(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = (150, 111, 214)
    got = start.copy()
    fill_discs(got, discs[:, 0], discs[:, 1], discs[:, 2], r,
               (150, 111, 214))
    assert np.array_equal(got, want)
    assert (got != start).any(axis=-1).sum() > 4 * r * r


@pytest.mark.parametrize("task_name,stem,batched", [
    ("ShadowHand", "shadow_hand", True), ("Humanoid", "humanoid", True),
    ("Pendulum", "pendulum", False)])
def test_render_env0_gives_the_episode_frames_and_counts_them(
        task_name, stem, batched):
    task = make_env(task_name, tc.load_cfg(stem, 2), device="cpu").task
    assert hasattr(task, "render_obs_frames") == batched
    T = 9
    obs = np.random.RandomState(0).uniform(
        -0.2, 0.2, (T, task.obs_dim)).astype(np.float32)
    before = dict(collect.STATS)
    imgs = collect._render_env0(task, obs)
    assert len(imgs) == T
    for t, img in enumerate(imgs):
        assert img.shape == (200, 200, 3) and img.dtype == np.uint8
        assert np.array_equal(img, task.render_obs_frame(obs[t]))
    assert collect.STATS["frames"] - before["frames"] == T
    assert (collect.STATS["frames_batched"] - before["frames_batched"]
            == (T if batched else 0))
    assert collect.STATS["stepped"] == before["stepped"]
