"""Taps on the port's loop, installed from outside for one run and taken
off after it: the loop's code is not edited.

  * ``MemWriter`` stands in for the loop's TensorBoard writers: it keeps
    the scalars in memory and calls a hook on each, which is how the
    harness sees an ADR iteration end (``perf/sec_per_adr_iter``) or a
    PPO iteration end (``rl/env_steps_per_sec``) inside ``main``.
  * ``Patches`` sets attributes of the port's modules, classes or objects
    and puts them back.
  * ``Spans`` times calls into a layer from outside, with a synchronize on
    each side (traced runs only: the synchronizes change the timing).
  * ``PPOTap``, ``CollectTap`` and ``BSimTap`` copy, at one sampled PPO
    iteration, collection round, fit and posterior, what the check
    compares: the state and generators before a rollout step and the
    step's outputs; the weights, Adam state, lr, batch and generator
    before an update, the Adam moments after its first minibatch and the
    weights after it; a round's generator and distribution before its
    reset, the reset's state, one sampled step as for the rollout, the
    raw trajectory buffers and the episodes extracted from them; the same
    as for the update around an MDN fit; the inputs and the mixtures of
    the posterior. The copies are device copies, taken in the window: no
    synchronize, nothing else changes.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional


def _noop(*args, **kwargs):
    return None


class MemWriter:
    """A writer that keeps scalars: ``scalars[tag]`` is a list of
    (step, value); ``hook(tag, value, step)`` is called on each."""

    def __init__(self, hook: Optional[Callable] = None):
        self.scalars: Dict[str, List] = defaultdict(list)
        self.hook = hook

    def add_scalar(self, tag, value, step=None, *args, **kwargs):
        value = float(value)
        self.scalars[tag].append((step, value))
        if self.hook is not None:
            self.hook(tag, value, step)

    def __getattr__(self, name):
        return _noop


class Patches:
    """``set(obj, name, value)`` for one run; ``restore()`` undoes every
    set in reverse order."""

    def __init__(self):
        self._undo = []

    def set(self, obj, name, value):
        had = name in vars(obj)
        old = getattr(obj, name) if had else None
        self._undo.append((obj, name, had, old))
        setattr(obj, name, value)

    def restore(self):
        while self._undo:
            obj, name, had, old = self._undo.pop()
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)


class Spans:
    """Seconds of calls into each layer, by window iteration: ``wrap``
    returns ``fn`` timed under ``name`` while ``enabled``, each call
    between two synchronizes, less the profiler's own start and stop,
    and labelled in an open profiler slice."""

    def __init__(self, enabled: bool, tracer, current: Callable[[], int]):
        self.enabled = enabled
        self.tracer = tracer
        self.current = current
        self.seconds: Dict[int, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))

    def wrap(self, name: str, fn: Callable) -> Callable:
        if not self.enabled:
            return fn

        def timed(*args, **kwargs):
            import torch
            torch.cuda.synchronize()
            t0, o0 = time.perf_counter(), self.tracer.overhead_s
            with self.tracer.label(name):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            self.seconds[self.current()][name] += (
                time.perf_counter() - t0 - (self.tracer.overhead_s - o0))
            return out
        return timed


# ---------------------------------------------------------------------- #
# Copies for the check.
# ---------------------------------------------------------------------- #
def _clone(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(x) for x in tree]


def named_tuple(nt) -> dict:
    """A NamedTuple of tensors as {"type", "fields"}, each tensor copied."""
    return {"type": type(nt).__name__,
            "fields": {k: _clone(v) for k, v in nt._asdict().items()}}


def env_state(state) -> dict:
    d = named_tuple(state)
    d["fields"]["task_state"] = named_tuple(state.task_state)
    return d


class PPOTap:
    """Copies one PPO iteration of ``ppo`` for the check: iteration
    ``iteration`` (counted from ``arm``) and its rollout step ``step``.
    Also labels the rollout and the update in an open profiler slice."""

    def __init__(self, ppo, patches: Patches, tracer):
        self.ppo = ppo
        self.tracer = tracer
        self.count = 0
        self.target = None
        self.step_index = None
        self.step: Optional[dict] = None
        self.update: Optional[dict] = None
        patches.set(ppo, "rollout_graph", self._rollout_graph(
            ppo.rollout_graph))
        patches.set(ppo, "_rollout", self._labelled("rollout",
                                                    ppo._rollout))
        patches.set(ppo, "update_from_traj",
                    self._update_from_traj(ppo.update_from_traj))

    def arm(self, iteration: int, step: int):
        self.count, self.target, self.step_index = 0, iteration, step

    @property
    def armed_now(self) -> bool:
        return self.target is not None and self.count == self.target

    def _labelled(self, name, fn):
        def call(*args, **kwargs):
            with self.tracer.label(name):
                return fn(*args, **kwargs)
        return call

    def _rollout_graph(self, orig):
        def rollout_graph(distr, env_state_, obs):
            graph = orig(distr, env_state_, obs)
            if self.armed_now:
                self._tap_step(graph)
            return graph
        return rollout_graph

    def _tap_step(self, graph):
        ppo, j = self.ppo, self.step_index
        seen = [0]
        step = graph.step

        def tapped():
            if seen[0] == j:
                before = {"state": env_state(graph.state),
                          "obs": _clone(graph.obs),
                          "distr": named_tuple(graph.distr),
                          "policy_gen": ppo.gen.get_state(),
                          "env_gen": ppo.vec_env.gen.get_state()}
                step()
                self.step = {**before,
                             "state_after": env_state(graph.state),
                             "obs_after": _clone(graph.obs),
                             "outputs": {k: _clone(v[j])
                                         for k, v in graph.traj.items()}}
                del graph.step  # back to the class's method
            else:
                step()
            seen[0] += 1
        graph.step = tapped

    def _update_from_traj(self, orig):
        def update_from_traj(traj, last_val, perms=None):
            if not self.armed_now:
                self.count += 1
                with self.tracer.label("update"):
                    return orig(traj, last_val, perms)
            ppo = self.ppo
            snap = {"traj": _clone(traj), "last_val": _clone(last_val),
                    "params": _clone(ppo.params),
                    "adam_count": _clone(ppo.adam.count),
                    "adam_mu": _clone(ppo.adam.mu),
                    "adam_nu": _clone(ppo.adam.nu),
                    "lr": _clone(ppo.lr), "gen": ppo.gen.get_state()}
            update = ppo.update_program(traj, last_val, draw=perms is None)
            step = update.step

            def first_step():
                step()
                snap["mu_1"] = _clone(ppo.adam.mu)
                del update.step
            update.step = first_step
            try:
                out = orig(traj, last_val, perms)
            finally:
                update.__dict__.pop("step", None)
            snap.update(params_after=_clone(ppo.params),
                        lr_after=_clone(ppo.lr),
                        losses=_clone(update.metrics[..., 0].reshape(-1)))
            self.update = snap
            self.count += 1
            return out
        return update_from_traj


class CollectTap:
    """Copies, in one armed ADR iteration, two collection rounds: the
    evaluation's and the training round of chunk ``chunk`` (the chunk
    whose fit ``BSimTap`` copies). For each, the first round of its
    ``collect_trajectories`` call: the generator state, distribution and
    weights before the reset; the reset's state and observations (every
    env); the state, observations and generator before step ``j``
    (``draw_step(kind, steps)``) and the step's outputs (every env); and
    the rows of the envs whose episodes the call keeps, of the raw
    trajectory buffers and of the extracted episodes. Installed on the
    port's ``utils/collect.py`` for one run."""

    def __init__(self, patches: Patches, draw_step: Callable):
        from bayes_sim_ig_tpu_torch.utils import collect
        self.draw_step = draw_step
        self.armed = False
        self.calls = 0
        self.chunk = None
        self.policy = None
        self.rounds: List[dict] = []
        self._want = None
        self._graph_tap = None
        patches.set(collect, "_collect_round",
                    self._collect_round(collect._collect_round))
        patches.set(collect, "collect_step_graph",
                    self._step_graph(collect.collect_step_graph))

    def arm(self, chunk: int, policy: Optional[str]):
        """Arms the next ADR iteration's calls; ``policy`` is the
        configuration's ``collectPolicy``, the training rounds'."""
        self.armed, self.calls, self.chunk, self.policy = (True, 0, chunk,
                                                           policy)

    def disarm(self):
        self.armed = False

    def trajectories(self, fn: Callable) -> Callable:
        """``collect_trajectories`` with its calls counted: in an armed
        ADR iteration the first is the evaluation, the next the training
        chunks, the last the surrogate-real round."""
        tap = self

        def collect_trajectories(num_trajs, *args, **kwargs):
            if tap.armed:
                k, tap.calls = tap.calls, tap.calls + 1
                if k == 0:
                    tap._want = {"kind": "evaluation", "policy": None}
                elif k - 1 == tap.chunk:
                    tap._want = {"kind": f"training chunk {tap.chunk}",
                                 "policy": tap.policy}
                if tap._want is not None:
                    tap._want["keep"] = int(num_trajs)
            try:
                return fn(num_trajs, *args, **kwargs)
            finally:
                tap._want = None
        return collect_trajectories

    def _collect_round(self, orig):
        tap = self

        def collect_round(vec_env, policy_apply, collect_policy,
                          max_episode_length, policy_params, distr, gen):
            want, tap._want = tap._want, None  # the call's first round
            if want is None:
                return orig(vec_env, policy_apply, collect_policy,
                            max_episode_length, policy_params, distr, gen)
            from bayes_sim_ig_tpu_torch.utils.step_graph import distr_key
            steps = int(max_episode_length) - 1
            snap = dict(want, gen=gen.get_state(), distr=named_tuple(distr),
                        weights=_clone(list(policy_params.parameters())),
                        max_episode_length=int(max_episode_length),
                        j=tap.draw_step(want["kind"], steps), step=None)
            tap._graph_tap = (snap, gen, [])
            try:
                out = orig(vec_env, policy_apply, collect_policy,
                           max_episode_length, policy_params, distr, gen)
            finally:
                for graph in tap._graph_tap[2]:
                    graph.__dict__.pop("step", None)
                tap._graph_tap = None
            reset = vec_env.step_graphs[("reset", gen, distr_key(distr))]
            rnd = vec_env.step_graphs[("round", steps)]
            k = min(snap["keep"], out[0].shape[0])
            raw = {key: v[:, :k].clone() for key, v in rnd.traj.items()}
            raw.update(obs0=rnd.obs0[:k].clone(),
                       labels=rnd.labels[:k].clone())
            snap.update(reset={"state": env_state(reset.state),
                               "obs": _clone(reset.obs)},
                        raw=raw, out=[x[:k].clone() for x in out])
            tap.rounds.append(snap)
            return out
        return collect_round

    def _step_graph(self, orig):
        tap = self

        def collect_step_graph(*args, **kwargs):
            graph = orig(*args, **kwargs)
            if tap._graph_tap is not None and not tap._graph_tap[2]:
                tap._graph_tap[2].append(graph)
                tap._tap_step(graph, *tap._graph_tap[:2])
            return graph
        return collect_step_graph

    @staticmethod
    def _tap_step(graph, snap: dict, gen):
        j, seen, step = snap["j"], [0], graph.step

        def tapped():
            if seen[0] == j:
                before = {"state": env_state(graph.state),
                          "obs": _clone(graph.obs), "gen": gen.get_state()}
                step()
                snap["step"] = {**before,
                                "state_after": env_state(graph.state),
                                "obs_after": _clone(graph.obs),
                                "outputs": {k: _clone(v[j])
                                            for k, v in graph.traj.items()}}
                del graph.step  # back to the class's method
            else:
                step()
            seen[0] += 1
        graph.step = tapped


class BSimTap:
    """Copies, in one armed ADR iteration, the fit of training chunk
    ``chunk`` and the posterior: ``predict``'s inputs, the refit's fit and
    every mixture ``predict_MoGs`` returns inside it. Installed on the
    port's classes (``BayesSim``, ``MDNN``) for one run."""

    def __init__(self, patches: Patches, spans: Spans, on_fit_end=None):
        from bayes_sim_ig_tpu_torch import engine
        from bayes_sim_ig_tpu_torch.models import mdnn
        self.armed = False
        self.chunk = None
        self.chunks_seen = 0
        self.fits: List[dict] = []
        self.predict: Optional[dict] = None
        self._fit_kind = None
        self._in_predict = False
        self.on_fit_end = on_fit_end
        self.bsims = []  # every BayesSim the loop trained, to free its fits
        B, M = engine.BayesSim, mdnn.MDNN
        patches.set(B, "run_training", spans.wrap(
            "bsim", self._bsim_run_training(B.run_training)))
        patches.set(B, "predict", spans.wrap(
            "bsim", self._bsim_predict(B.predict)))
        patches.set(M, "run_training", self._mdnn_run_training(
            M.run_training))
        patches.set(M, "predict_MoGs", self._predict_mogs(M.predict_MoGs))

    def arm(self, chunk: int):
        self.armed, self.chunk, self.chunks_seen = True, chunk, 0

    def disarm(self):
        self.armed = False

    def _bsim_run_training(self, orig):
        tap = self

        def run_training(bsim, params, traj_states, traj_actions):
            if not any(b is bsim for b in tap.bsims):
                tap.bsims.append(bsim)
            if tap.armed and tap.chunks_seen == tap.chunk:
                tap._fit_kind = {"kind": "main", "labels": _clone(params),
                                 "states": _clone(traj_states),
                                 "actions": _clone(traj_actions)}
            try:
                return orig(bsim, params, traj_states, traj_actions)
            finally:
                tap._fit_kind = None
                if tap.armed:
                    tap.chunks_seen += 1
                    if tap.on_fit_end is not None:
                        tap.on_fit_end(tap.chunks_seen)
        return run_training

    def _bsim_predict(self, orig):
        tap = self

        def predict(bsim, states, actions, *args, **kwargs):
            if not tap.armed:
                return orig(bsim, states, actions, *args, **kwargs)
            tap.predict = {"states": _numpy(states),
                           "actions": _numpy(actions), "calls": []}
            tap._in_predict = True
            tap._fit_kind = {"kind": "refit"}
            try:
                out = orig(bsim, states, actions, *args, **kwargs)
            finally:
                tap._in_predict = False
                tap._fit_kind = None
            tap.predict["main_model"] = id(bsim.model)
            tap.predict["posterior"] = _mog(out)
            for call in tap.predict["calls"]:
                call["kind"] = ("main" if call.pop("model") == id(bsim.model)
                                else "refit")
            return out
        return predict

    def _mdnn_run_training(self, orig):
        tap = self

        def run_training(model, x_data, y_data, n_updates, batch_size,
                         test_frac=0.2):
            kind = tap._fit_kind
            if kind is None:
                return orig(model, x_data, y_data, n_updates, batch_size,
                            test_frac)
            snap = dict(kind)
            if snap["kind"] == "refit":
                snap.update(x=_tensor(x_data), y=_tensor(y_data))
            snap.update(params=_clone(list(model.net.parameters())),
                        gen=model._gen.get_state(), n_updates=int(n_updates),
                        batch_size=int(batch_size),
                        test_frac=float(test_frac))
            fit_program = model.fit_program
            fits = []

            def tapped_program(*args):
                fit = fit_program(*args)
                step = fit.step

                def first_step():
                    step()
                    snap["mu_1"] = _clone(model.adam_mu)
                    del fit.step
                fit.step = first_step
                fits.append(fit)
                return fit
            model.fit_program = tapped_program
            try:
                log = orig(model, x_data, y_data, n_updates, batch_size,
                           test_frac)
            finally:
                del model.fit_program
                for fit in fits:
                    fit.__dict__.pop("step", None)
            snap.update(params_after=_clone(list(model.net.parameters())),
                        losses=_clone(fits[0].losses),
                        test_losses=list(log["test_loss"]))
            tap.fits.append(snap)
            return log
        return run_training

    def _predict_mogs(self, orig):
        tap = self

        def predict_MoGs(model, xs, noise=None):
            if not tap._in_predict:
                return orig(model, xs, noise)
            call = {"model": id(model), "xs": _tensor(xs),
                    "params": _clone(list(model.net.parameters())),
                    "gen": model._gen.get_state()}
            out = orig(model, xs, noise)
            call["mogs"] = [_mog(m) for m in out]
            tap.predict["calls"].append(call)
            return out
        return predict_MoGs


def _numpy(x):
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x, copy=True)


def _tensor(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.as_tensor(x, dtype=torch.float32).clone()


def _mog(mog) -> dict:
    import numpy as np
    return {"a": np.asarray(mog.a, np.float64).copy(),
            "m": np.stack([g.m for g in mog.xs]).astype(np.float64),
            "S": np.stack([g.S for g in mog.xs]).astype(np.float64)}
