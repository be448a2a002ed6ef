"""The core BayesSim engine: summarize trajectories, train a mixture density
model, extract posteriors over simulation parameters.

Port of ``bayes_sim_ig_tpu/engine.py`` with the same training budget
constants, chunked-training contract, model-class string parsing
(``MDRFF_<kernel>_<sigma>``), proposal correction, and the
multi-real-trajectory posterior combination (resample 1e4 points from the
per-trajectory mixtures, fit an unconditional MDNN, read off its single
conditional mixture). Every model tensor lives on ``device``, the refit's
included: the card unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .distributions import pdf
from .models import MDNN, get_model_class
from .summarizers import get_summarizer
from .utils.device import resolve_device


class BayesSim:
    NUM_TRAIN_TRAJ_PER_BATCH = 1000  # num trajs for each training batch
    NUM_TRAIN_EPOCHS = 10            # num times to go over the batch
    MINIBATCH_SIZE = 100             # minibatch size for NN training
    NUM_GRAD_UPDATES = (NUM_TRAIN_EPOCHS * NUM_TRAIN_TRAJ_PER_BATCH
                        // MINIBATCH_SIZE)
    TEST_FRACTION = 0.2              # fraction of dataset to use as test

    def __init__(self, model_cfg, obs_dim, act_dim, params_dim, params_lows,
                 params_highs, prior=None, proposal=None, seed=0,
                 device="cuda", **kwargs):
        """model_cfg is the ``bayessim`` section of the task yaml; the
        summarizer's output dimension is probed by running it on zeros of
        shape (1, trainTrajLen + 1, obs/act_dim). ``device`` defaults to
        the card and raises without one (``resolve_device``)."""
        self.prior = prior
        self.proposal = proposal
        self.device = resolve_device(device)
        self._refit_model = None
        model_class = model_cfg["modelClass"]
        self.summarizer_fxn = get_summarizer(model_cfg["summarizerFxn"])
        # Probe with trainTrajLen + 1 steps: the length collection
        # produces (the reference probes with trainTrajLen, which gives the
        # corr-family summaries another dim for trainTrajLen < 10).
        probe_len = int(model_cfg["trainTrajLen"]) + 1
        tmp = self.summarizer_fxn(torch.zeros((1, probe_len, obs_dim)),
                                  torch.zeros((1, probe_len, act_dim)))
        traj_summaries_dim = int(tmp.shape[-1])
        full_covariance = bool(model_cfg.get("fullCovariance", False))
        kwargs_model = {
            "input_dim": traj_summaries_dim, "output_dim": int(params_dim),
            "output_lows": np.asarray(params_lows),
            "output_highs": np.asarray(params_highs),
            "n_gaussians": model_cfg["components"],
            "hidden_layers": model_cfg["hiddenLayers"],
            "lr": model_cfg["lr"],
            "activation": "tanh",
            "full_covariance": full_covariance,
            "seed": seed,
            "device": self.device,
        }
        if model_class.startswith("MDRFF"):
            kernel, sigma = "RBF", 4.0
            if "_" in model_class:  # e.g. MDRFF_Matern32_2.0
                parts = model_class.split("_")
                model_class = parts[0]
                kernel = parts[1]
                if len(parts) > 2:
                    sigma = float(parts[2])
            kwargs_model.update(n_feat=200, sigma=sigma, kernel=kernel)
        self.model = get_model_class(model_class)(**kwargs_model)

    def free_graphs(self):
        """Drops the captured fits of the model and of the refit."""
        self.model.free_graphs()
        if self._refit_model is not None:
            self._refit_model.free_graphs()

    @staticmethod
    def get_n_trajs_per_batch(n_train_trajs, n_train_trajs_done):
        """Next chunk size, capped so the total hits n_train_trajs
        exactly."""
        n = BayesSim.NUM_TRAIN_TRAJ_PER_BATCH
        if n_train_trajs_done + n > n_train_trajs:
            n = n_train_trajs - n_train_trajs_done
        return n

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def run_training(self, params, traj_states, traj_actions):
        """Summarizes one chunk of rollouts and trains the model on it."""
        traj_summaries = self.summarizer_fxn(self._tensor(traj_states),
                                             self._tensor(traj_actions))
        params = self._tensor(params)
        # Drop trajectories whose features or labels are non-finite (a
        # physics blow-up under extreme DR): one bad row would NaN the
        # whole MDN fit and with it every later posterior.
        ok = (torch.isfinite(traj_summaries).all(dim=1)
              & torch.isfinite(params).all(dim=1))
        n_bad = int((~ok).sum())
        if n_bad:
            print(f"dropping {n_bad} non-finite trajs of {ok.shape[0]}")
            traj_summaries = traj_summaries[ok]
            params = params[ok]
        if traj_summaries.shape[0] == 0:
            # Every trajectory in the chunk blew up: skip the fit, an
            # empty dataset has no minibatch to draw.
            print("all trajectories in this chunk were non-finite; "
                  "skipping the model update")
            nan = float("nan")
            return {"train_loss": [nan], "test_loss": [nan]}
        return self.model.run_training(
            x_data=traj_summaries, y_data=params,
            n_updates=BayesSim.NUM_GRAD_UPDATES,
            batch_size=BayesSim.MINIBATCH_SIZE,
            test_frac=BayesSim.TEST_FRACTION)

    def predict(self, states, actions, threshold=0.005):
        """Posterior over sim params given (surrogate-)real trajectories.
        With several trajectories, the per-trajectory mixtures are combined
        by resampling and refitting an unconditional MDNN."""
        xs = self.summarizer_fxn(self._tensor(states), self._tensor(actions))
        mogs = self.model.predict_MoGs(xs)
        if self.proposal is not None:
            for i, mog in enumerate(mogs):
                mog.prune_negligible_components(threshold=threshold)
                if isinstance(self.prior, pdf.Uniform):
                    post = mog / self.proposal
                elif isinstance(self.prior, pdf.Gaussian):
                    post = (mog * self.prior) / self.proposal
                else:
                    raise NotImplementedError(
                        f"prior type {type(self.prior)} unsupported")
                mogs[i] = post
        if len(mogs) == 1:
            return mogs[0]
        # Combine: resample the mixtures, fit a small unconditional MDNN on
        # the model's device. The instance is cached and re-initialized
        # per call, so its fit is captured once per BayesSim.
        tot_smpls = int(1e4)
        n_per_mog = tot_smpls // len(mogs)
        mog_smpls = np.concatenate(
            [mog.gen(n_samples=n_per_mog) for mog in mogs], axis=0)
        if self._refit_model is None:
            self._refit_model = MDNN(
                input_dim=1, output_dim=self.model.output_dim,
                output_lows=self.model.output_lows,
                output_highs=self.model.output_highs,
                n_gaussians=self.model.n_gaussians,
                hidden_layers=(128, 128), lr=self.model.lr,
                activation=self.model.activation,
                # The reference passes `L_size > 0` here, which upgrades a
                # diagonal-covariance model's refit to full covariance for
                # any params_dim >= 2; the refit matches the main model.
                full_covariance=self.model.full_covariance,
                device=self.device)
        else:
            self._refit_model.reinit()
        mog_model = self._refit_model
        batch_size = 100
        n_updates = 5 * tot_smpls // batch_size
        inputs = np.zeros((mog_smpls.shape[0], 1), np.float32)
        mog_model.run_training(inputs, mog_smpls.astype(np.float32),
                               n_updates, batch_size)
        fitted = mog_model.predict_MoGs(inputs[0:1, :])
        assert len(fitted) == 1
        return fitted[0]
