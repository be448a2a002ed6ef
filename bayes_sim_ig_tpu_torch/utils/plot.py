"""Posterior visualization: 1-D marginals and pairwise 2-D panels written
to TensorBoard (reference ``utils/plot.py:19-149``; same tag naming
``<msg>_<p1>_vs_<p2>``)."""

from __future__ import annotations

import warnings

import numpy as np

from ..distributions import pdf


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm
    return plt, cm


def plot_1d_posterior(ax, i, sim_params_names, true_params, posterior,
                      p_lower, p_upper, legend_on=False):
    """Marginal posterior curve vs the uniform prior with a true-value line
    (plot.py:19-35)."""
    # Pad the window by 10% of the RANGE. The reference pads by 10% of
    # the bound values themselves (plot.py:21-22), which shrinks or
    # inverts the window when a bound is negative (empty plot) —
    # documented divergence, PARITY.md.
    pad = 0.1 * (p_upper[i] - p_lower[i])
    lo, hi = p_lower[i] - pad, p_upper[i] + pad
    x = np.arange(lo, hi, 0.001).reshape(-1, 1)
    y = posterior.eval(x, ii=[i], log=False)
    prior = pdf.Uniform(p_lower[i:i + 1], p_upper[i:i + 1])
    y_prior = prior.eval(x, log=False)
    ax.plot(x, y, "-b", label="Predicted posterior")
    ax.plot(x, y_prior, "-g", label="Uniform prior")
    ax.axvline(np.ravel(true_params)[i], c="r", label="True value")
    if legend_on:
        ax.legend(fontsize=10)
    ax.set_xlabel(str(sim_params_names[i]), fontsize=10)
    ax.set_ylabel("likelihood", fontsize=10)


def get_2d_posterior_data(posterior, xmin, xmax, ymin, ymax, nbins=100,
                          dims=(0, 1)):
    xi, yi = np.mgrid[xmin:xmax:nbins * 1j, ymin:ymax:nbins * 1j]
    grid = np.stack([xi.ravel(), yi.ravel()], axis=1)
    zi = posterior.eval(grid, ii=list(dims), log=False)
    return xi, yi, zi


def plot_2d_posterior(ax, sim_params_names, true_params, posterior,
                      xmin, xmax, ymin, ymax, dims=(0, 1)):
    """2-D marginal heatmap with contour levels between the true-point
    likelihood and the max likelihood, plus component centers
    (plot.py:47-91)."""
    _, cm = _mpl()
    ax.set_xlim((xmin, xmax))
    ax.set_ylim((ymin, ymax))
    ax.set_xlabel(str(sim_params_names[0]), fontsize=10)
    ax.set_ylabel(str(sim_params_names[1]), fontsize=10)
    xi, yi, zi = get_2d_posterior_data(posterior, xmin, xmax, ymin, ymax,
                                       dims=dims)
    ax.pcolormesh(xi, yi, zi.reshape(xi.shape), shading="gouraud",
                  cmap=cm.cool)
    max_lik = float(np.max(zi))
    true_lik = float(posterior.eval(np.asarray(true_params).reshape(1, -1),
                                    ii=list(dims), log=False)[0])
    levels = []
    if max_lik > true_lik:
        levels = np.arange(true_lik, max_lik, (max_lik - true_lik) / 5.0)
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore",
            message="No contour levels were found within the data range.")
        cs = ax.contour(xi, yi, zi.reshape(xi.shape), levels=levels,
                        alpha=0.8)
    if len(levels) > 0:
        ax.clabel(cs, inline=True, fontsize=10)
    ax.scatter(true_params[0], true_params[1], 1000, "y", marker="*",
               label="True value")
    if hasattr(posterior, "n_components"):
        xc = [g.m[dims[0]] for g in posterior.components]
        yc = [g.m[dims[1]] for g in posterior.components]
        ax.plot(xc, yc, "b+", markersize=10)
    ax.grid(visible=True, which="major", alpha=0.8)


def plot_posterior_pair(row, col, sim_params_names, true_params, posterior,
                        p_lower, p_upper):
    """1-D-only figure for scalar params, else a 2x2 panel with both
    marginals and their joint (plot.py:94-117)."""
    plt, _ = _mpl()
    true_params = np.ravel(np.asarray(true_params))
    if len(true_params) == 1:
        fig, ax = plt.subplots(1, 1)
        plot_1d_posterior(ax, 0, sim_params_names, true_params, posterior,
                          p_lower, p_upper, legend_on=True)
        plt.tight_layout()
        return fig, str(sim_params_names[0])
    fig, axes = plt.subplots(2, 2)
    fig.set_size_inches((6, 6))
    plot_1d_posterior(axes[0, 0], row, sim_params_names, true_params,
                      posterior, p_lower, p_upper, legend_on=True)
    plot_1d_posterior(axes[1, 1], col, sim_params_names, true_params,
                      posterior, p_lower, p_upper, legend_on=True)
    ids = np.array([row, col])
    plot_2d_posterior(
        axes[1, 0], np.asarray(sim_params_names)[ids], true_params[ids],
        posterior, xmin=p_lower[ids[0]], xmax=p_upper[ids[0]],
        ymin=p_lower[ids[1]], ymax=p_upper[ids[1]], dims=tuple(ids))
    axes[0, 1].axis("off")
    plt.tight_layout()
    return fig, f"{sim_params_names[row]}_vs_{sim_params_names[col]}"


def add_fig_to_tensorboard(writer, fig, title, step):
    """Rasterizes a figure into a CHW image for the TB writer
    (plot.py:120-128)."""
    plt, _ = _mpl()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    img = img.astype(np.float32) / 255.0
    img = np.transpose(img, (2, 0, 1))
    writer.add_image(title, img, step)
    plt.close(fig)


def plot_posterior(writer, tb_msg, tb_step, sim_params_names, skip_ids,
                   true_params, posterior, p_lower, p_upper,
                   output_file=None):
    """All non-skipped pairwise posterior panels (plot.py:131-149)."""
    plt, _ = _mpl()
    true_params = np.ravel(np.asarray(true_params))
    n = len(true_params)
    skip = set(skip_ids)
    pairs = ([(0, 0)] if n == 1 else
             [(r, c) for r in range(n) if r not in skip
              for c in range(r + 1, n) if c not in skip])
    for row, col in pairs:
        fig, title = plot_posterior_pair(
            row, col, sim_params_names, true_params, posterior,
            p_lower, p_upper)
        if writer is not None:
            add_fig_to_tensorboard(writer, fig, f"{tb_msg}_{title}", tb_step)
            writer.flush()
        if output_file is not None:
            fig.savefig(output_file, dpi=100)
        plt.close(fig)
