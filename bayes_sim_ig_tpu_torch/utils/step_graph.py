"""CUDA graphs of the port's compiled programs, which all capture their
bodies through ``Graphed``: one env step of a collection round or a PPO
rollout (``StepGraph``, with the rollout's last value as its ``finish``),
the collection round's reset and episode extraction
(``sim/task.py::EnvReset``, ``utils/collect.py::CollectRound``),
``VecEnv.reset`` and ``VecEnv.step`` (``EnvReset``, ``EnvStep``),
``PPO.act``, the PPO update (its permutations drawn by its first program)
and the MDN fit (``rl/ppo.py``, ``models/mdnn.py``).

The JAX package runs each of these inside a jitted program: the collection
round (``utils/collect.py::_collect_round``: the reset, a ``lax.scan`` of
env steps, the extraction), the PPO iteration (the rollout's ``lax.scan``,
GAE's and the epochs' ``lax.scan``s, the permutations drawn from its key),
``VecEnv``'s ``_reset_jit`` and ``_step_jit``, ``PPO``'s ``_act_fn`` and
``_mean_fn``, the MDN fit as a ``lax.scan`` of Adam steps. An eager torch
step is hundreds to thousands of small launches, and the host, not the
card, then sets its pace. Here each loop's body works on static buffers,
with its step counters on the device. On a CUDA device the first call of
a ``Graphed`` runs the body eagerly on a side stream (it builds the
per-model tables and loads every kernel), then captures it into a
``torch.cuda.CUDAGraph``; every later call is one replay. On the CPU the
body runs eagerly at every call. The device alone picks the path: there
is no switch, and a capture that fails raises.

What a graph reads must stay where it was captured:
  * the random generators are registered with the graph, so that a replay
    draws what the eager body draws and leaves each generator where the
    eager body leaves it;
  * the weights and the optimizer state are read and written in place
    (``PPO`` and the MDN models write them with ``copy_``, and their
    ``reinit`` writes fresh ones into the same tensors);
  * inputs are copied into the buffers (``load``), so a graph is keyed on
    their kinds and shapes (``distr_key``), not on their values.
Each kernel wrapper counts its launches on the host. A capture's counts
are put back, and its nonzero increments are added again in place at
every replay, so the counts stay those of the launches the card ran.
While tracing is on (``utils/trace.py``) each call is a ``graph.replay``
span with its phase; on the card the span also times the replay on the
device.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops.launch import launch_counts, launch_increments, set_launch_counts
from . import trace

# Captures, replays and capture seconds of this process, by phase
# ("reset", "collect", "extract", "rollout", "update", "fit", "step",
# "act"); read and reset by callers that must show a run went through the
# graphs.
STATS: Dict[str, Dict[str, float]] = {}

# Every Graphed of this process, held weakly: live_graphs() reads the
# captures that were not freed.
_ALL: "weakref.WeakSet[Graphed]" = weakref.WeakSet()


def live_graphs() -> list:
    """The phases of the captured graphs that are alive and not freed."""
    return sorted(g.phase for g in _ALL if g._graph is not None)


class Graphed:
    """``body()``, a function of static buffers and generators only, run
    by calling this object: eagerly on the CPU; on a CUDA device the first
    call runs it eagerly on a side stream and captures it there (with
    ``generators`` registered), and every later call replays the capture.
    ``phase`` names its line in ``STATS``."""

    def __init__(self, phase: str, body: Callable[[], None], device,
                 generators: Sequence[torch.Generator] = ()):
        self.phase = phase
        self.body = body
        self.device = torch.device(device)
        self._generators = list(generators)
        self._stats = STATS.setdefault(
            phase, {"captures": 0, "replays": 0, "capture_s": 0.0})
        self._graph = None
        self._launches = None
        self.replays = 0
        self.capture_s = None
        _ALL.add(self)

    def __call__(self):
        if self.device.type != "cuda":
            with trace.span("graph.replay", phase=self.phase):
                self.body()
            return
        if self._graph is None:
            self._capture()
            return
        if trace.ENABLED:
            with trace.device_span("graph.replay", phase=self.phase):
                self._graph.replay()
        else:
            self._graph.replay()
        for counts, key, n in self._launches:
            counts[key] += n
        self.replays += 1
        self._stats["replays"] += 1

    def _capture(self):
        """Runs the body eagerly on a side stream, then captures it on that
        stream (no kernel runs in a capture), with every generator
        registered."""
        with torch.cuda.device(self.device):
            current, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.body()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            for gen in self._generators:
                graph.register_generator_state(gen)
            before = launch_counts()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=side):
                self.body()
            self.capture_s = time.perf_counter() - t0
            after = launch_counts()
        set_launch_counts(before)
        self._launches = launch_increments(before, after)
        self._graph = graph
        self._stats["captures"] += 1
        self._stats["capture_s"] += self.capture_s

    def free(self):
        """Drops the capture and its memory pool; the next call captures
        again."""
        if self._graph is not None:
            self._graph.reset()
            self._graph = None


def tree_leaves(tree) -> list:
    """The tensors of nested (named) tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in tree_leaves(sub)]


def clone_tree(tree):
    """A copy of nested named tuples of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*[clone_tree(x) for x in tree])


def distr_key(distr) -> tuple:
    """A sampling distribution's kind and shapes: what a graph that reads
    its values from buffers depends on."""
    return (type(distr).__name__,) + tuple(tuple(x.shape) for x in distr)


def trajectory(steps: int, outputs: Dict[str, Tuple[tuple, torch.dtype]],
               device) -> Dict[str, torch.Tensor]:
    """Empty (steps, *shape) buffers of ``outputs``' {name: (shape,
    dtype)}."""
    return {k: torch.empty((int(steps),) + tuple(shape), dtype=dtype,
                           device=device)
            for k, (shape, dtype) in outputs.items()}


class StepGraph:
    """The step ``body(state, obs, distr) -> (state, obs, outputs)`` of
    ``phase`` (counted in ``STATS``) on static buffers: ``state`` an
    ``EnvState``, ``obs`` the observations, ``distr`` a device
    distribution, and ``outputs`` a {name: tensor} dict of the step's
    trajectory entries, each written into its row of ``traj`` (the
    caller's (steps, ...) buffers, which graphs of one shape may share).
    ``generators`` is every generator the body draws from. ``finish(state,
    obs) -> {name: tensor}``, if given, is a second program (``finish()``)
    run after the last step, written into ``final`` (buffers of its
    {name: (shape, dtype)})."""

    def __init__(self, phase: str, body: Callable, state, obs: torch.Tensor,
                 distr, traj: Dict[str, torch.Tensor],
                 generators: Sequence[torch.Generator],
                 finish: Optional[Callable] = None,
                 final: Optional[Dict[str, Tuple[tuple, torch.dtype]]] = None):
        self.device = obs.device
        self._body = body
        self.state = clone_tree(state)
        self.obs = obs.clone()
        self.distr = clone_tree(distr)
        self.traj = traj
        self.steps = next(iter(traj.values())).shape[0]
        self._t = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._host_t = 0
        self._program = Graphed(phase, self._run, self.device, generators)
        self._finish = finish
        self.final = {k: torch.empty(shape, dtype=dtype, device=self.device)
                      for k, (shape, dtype) in (final or {}).items()}
        self._final_program = (None if finish is None else
                               Graphed(phase, self._run_finish, self.device))

    @property
    def replays(self) -> int:
        return self._program.replays

    @property
    def capture_s(self):
        return self._program.capture_s

    def load(self, state, obs: torch.Tensor, distr):
        """Copies a round's first state, its observations and the
        distribution's values into the buffers; the trajectory starts
        again at step 0."""
        for dst, src in zip(tree_leaves((self.state, self.obs, self.distr)),
                            tree_leaves((state, obs, distr))):
            dst.copy_(src)
        self._t.zero_()
        self._host_t = 0

    def snapshot(self):
        """(EnvState, obs): copies of the state and observation buffers,
        which the next step overwrites."""
        return clone_tree(self.state), self.obs.clone()

    def _run(self):
        with torch.no_grad():
            state, obs, outs = self._body(self.state, self.obs, self.distr)
            for k, v in outs.items():
                self.traj[k].index_copy_(0, self._t, v.unsqueeze(0))
            for dst, src in zip(tree_leaves((self.state, self.obs)),
                                tree_leaves((state, obs))):
                dst.copy_(src)
            self._t.add_(1)

    def _run_finish(self):
        with torch.no_grad():
            for k, v in self._finish(self.state, self.obs).items():
                self.final[k].copy_(v)

    def _advance(self):
        if self._host_t >= self.steps:
            raise IndexError(f"step {self._host_t} of a trajectory of "
                             f"{self.steps}: load the next round first")
        self._host_t += 1

    def body(self):
        """One step, eagerly, on the buffers."""
        self._advance()
        self._run()

    def step(self):
        """One step: a replay of the captured step on a CUDA device (the
        first step captures it), the body on the CPU."""
        self._advance()
        self._program()

    def finish(self):
        """The ``finish`` program on the buffers after the last step."""
        self._final_program()

    def free(self):
        """Drops the captured programs and their memory pools."""
        self._program.free()
        if self._final_program is not None:
            self._final_program.free()
