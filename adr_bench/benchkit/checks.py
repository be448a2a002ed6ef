"""The check that decides ``correct``: the plain reference recomputes what
the window's sampled rollout step, collection rounds, PPO update, MDN fit
and posterior produced, from the copies the taps took before each, and
each number below is held to its limit in ``cells/<workload>.json``.

The reference follows the port step by step from the port's own state
(its weights, optimizer state, env state and generator states before
each program): a physics step, a PPO update and an MDN fit diverge from
any second run by rounding within a few steps, so only a comparison
from the same start can be tight.

  * ``step_gap``: one rollout step and, in the ADR loop, the reset and
    one sampled step of two collection rounds (the evaluation's and a
    training chunk's), env by env. For the actor's draw, its
    log-probability, the critic's value and the reward: the norm of an
    env's difference over the norm of its reference value; for the done
    flag, 1 where it differs. For every float leaf of the next env state
    and for the next observations: the norm of an env's difference over
    the norm of its change in the step (or a thousandth of its norm, or
    of the mean env's, where it barely moves), and over its norm after a
    reset. The 99.9th
    percentile over the envs, of the worst output or leaf: a fault in
    more than a thousandth of the envs shows.
  * ``step_gap_max``: the same gaps' widest env: one env's answer
    altered shows, above the few envs whose contact a rounding flips.
  * ``extract_gap``: the episodes the collection rounds extracted (each
    env's first, its last step repeated, the labels drawn at the reset,
    the summed reward), held to the reference's extraction from the same
    raw buffers: the round's output, the training chunk's as the fit got
    it, and the evaluation's logged mean, min and max reward. Each env's
    difference over the larger of its reference norm and the median
    env's; the worst.
  * ``update_loss_gap``, ``fit_loss_gap``: each minibatch's loss, the gap
    over the larger of the reference's loss and its median loss; the
    worst minibatch.
  * ``update_grad_gap``, ``fit_grad_gap``: the first minibatch's gradient
    as the optimizer took it (worked out from the Adam moments before and
    after that minibatch): the gap between the two norms of each leaf,
    over the larger of the reference's norm and the median leaf's; the
    worst leaf.
  * ``update_change_gap``, ``fit_change_gap``: the change of each leaf
    over the update or the fit, measured as the gradient. Leaves whose
    first gradient in the reference is under a thousandth of the median
    leaf's are left out of both gradient and change.
  * ``posterior_gap``: every mixture ``predict_MoGs`` returned inside
    ``predict`` (the model's at the surrogate-real trajectories and the
    refit's posterior): the widest gap of a weight, or of a mean or a
    standard deviation over its parameter's prior range.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

# A step's gap is read at this quantile over the envs: a rounding
# difference that flips a contact in one or two of 4,096 envs reads up to
# 0.25 there (Humanoid); a fault in more than a thousandth of the envs
# reads above the quantile.
STEP_QUANTILE = 0.999
# What a cell of each loop has to hold to a limit; ``step_gap_max`` is
# held where the cell's limits name it (where its sound runs' widest env
# stands far enough under a planted fault's).
TRAIN_NUMBERS = ("step_gap", "update_loss_gap", "update_grad_gap",
                 "update_change_gap")
NUMBERS = TRAIN_NUMBERS + ("extract_gap", "fit_loss_gap", "fit_grad_gap",
                           "fit_change_gap", "posterior_gap")
OPTIONAL = ("step_gap_max",)
ADAM_B1 = 0.9


# ---------------------------------------------------------------------- #
# Precision of the reference.
# ---------------------------------------------------------------------- #
def _round_tf32(x):
    """x rounded to TF32's 10-bit mantissa, to nearest; gradients pass
    through as if it were x."""
    import torch
    if x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


class _TF32:
    """A torch function mode that rounds the float32 operands of every
    matrix product to TF32, as the card's TF32 path does: the control's
    precision where there is no card."""


    def __init__(self):
        import torch
        from torch.overrides import TorchFunctionMode
        F = torch.nn.functional
        ops = {F.linear, torch.matmul, torch.mm, torch.bmm, torch.einsum,
               torch.Tensor.matmul, torch.Tensor.__matmul__}

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func in ops:
                    args = [_round_tf32(a) if isinstance(a, torch.Tensor)
                            else (type(a)(_round_tf32(t) if isinstance(
                                t, torch.Tensor) else t for t in a)
                                if isinstance(a, (list, tuple)) else a)
                            for a in args]
                return func(*args, **kwargs)
        self.mode = Mode()


@contextlib.contextmanager
def precision(mode: str, device: str):
    """``float32``: TF32 off. ``tf32``: TF32 on for the card's matrix
    products (cuBLAS and cuDNN), or its rounding emulated on the CPU."""
    import torch
    cuda = str(device).startswith("cuda")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        if mode == "tf32" and not cuda:
            with _TF32().mode:
                yield
        else:
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------- #
# Gaps.
# ---------------------------------------------------------------------- #
def _norm(x) -> float:
    return float(x.double().norm())


def _ratio(num: float, den: float) -> float:
    if not math.isfinite(num) or not math.isfinite(den):
        return math.inf
    if num == 0.0:
        return 0.0
    return num / den if den > 0.0 else math.inf


def _state_leaves(state) -> Dict[str, object]:
    """The float leaves of an EnvState (the port's or the reference's),
    by name."""
    out = {}
    for name in state._fields:
        value = getattr(state, name)
        if name == "task_state":
            for k in value._fields:
                out["task_state." + k] = getattr(value, k)
        elif value.is_floating_point():
            out[name] = value
    return {k: v for k, v in out.items() if v.is_floating_point()}


def _snap_leaves(snap: dict) -> Dict[str, object]:
    out = {}
    for name, value in snap["fields"].items():
        if name == "task_state":
            for k, v in value["fields"].items():
                out["task_state." + k] = v
        else:
            out[name] = value
    return {k: v for k, v in out.items() if v.is_floating_point()}


def step_gap(prog: dict, ref: dict, before: Optional[dict],
             where: str = "") -> Dict[str, Tuple[float, str]]:
    """``step_gap`` (the worst output's or leaf's 99.9th percentile over
    the envs of each env's gap) and ``step_gap_max`` (the widest env's
    gap), each with where it is worst; ``prog`` and ``ref``: {the outputs
    among "act", "logp", "val", "rew", "done"; "state" (leaves by name);
    "obs"}; ``before``: {"state", "obs"}, or None after a reset."""
    by_env = step_gaps_by_env(prog, ref, before)
    q = {k: _quantile(g, STEP_QUANTILE) for k, g in by_env.items()}
    top = {k: _quantile(g, 1.0) for k, g in by_env.items()}
    kq = max(q, key=lambda k: q[k])
    km = max(top, key=lambda k: top[k])
    env = _worst_env(by_env[km])
    return {"step_gap": (q[kq], f"{where}{kq}"),
            "step_gap_max": (top[km], f"{where}{km}, env {env}")}


def _worst_env(g) -> int:
    import torch
    return int(torch.argmax(torch.nan_to_num(g.double(), nan=math.inf)))


def _quantile(g, q: float) -> float:
    """The q-quantile of the env gaps, an env whose gap is not a number
    counting as infinitely far off."""
    import torch
    g = torch.nan_to_num(g.double(), nan=math.inf)
    return float(torch.quantile(g, q))


def _agree(p, r):
    """p and r with the entries where both are not finite, and equal as
    such (NaN and NaN, or the same infinity), set to 0 on both sides: an
    env whose state blew up in both is no gap."""
    import torch
    same = (~torch.isfinite(p) & ~torch.isfinite(r)
            & ((p == r) | (torch.isnan(p) & torch.isnan(r))))
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    return torch.where(same, zero, p), torch.where(same, zero, r)


def step_gaps_by_env(prog: dict, ref: dict, before: Optional[dict]) -> Dict:
    """Each env's gap, for each output and each float leaf of the next
    state: the norm of the env's difference over the norm of its
    reference value (the actor's draw, log-probability, value, reward),
    1 where the done flag differs, or the norm of the difference over the
    norm of the env's change in the step (the state's leaves and the
    observations; a thousandth of the env's norm, or of the mean env's,
    where it barely moves), over its norm where ``before`` is None (a
    reset)."""
    import torch
    out = {}
    for k in ("act", "logp", "val", "rew"):
        if k not in ref:
            continue
        p, r = _agree(prog[k].to(ref[k].device).double(), ref[k].double())
        d = (p - r).reshape(r.shape[0], -1).norm(dim=1)
        den = r.reshape(r.shape[0], -1).norm(dim=1)
        out[k] = (d / den.clamp_min(1e-300)).cpu()
    if "done" in ref:
        out["done"] = (prog["done"].to(ref["done"].device)
                       != ref["done"]).double().cpu()
    pairs = [(k, prog["state"][k], ref["state"][k],
              None if before is None else before["state"][k])
             for k in ref["state"]]
    pairs.append(("obs", prog["obs"], ref["obs"],
                  None if before is None else before["obs"]))
    for k, p, r, b in pairs:
        if r.ndim == 0:
            continue
        p, r = _agree(p.to(r.device).double(), r.double())
        n = r.shape[0]
        d = (p - r).reshape(n, -1).norm(dim=1)
        size = r.reshape(n, -1).norm(dim=1)
        # A leaf that is 0 in an env (a fingertip out of contact) is
        # measured against the mean env's size.
        floor = 1e-3 * torch.nan_to_num(size, posinf=0.0).mean()
        if b is None:
            den = torch.maximum(size, floor)
        else:
            b = torch.nan_to_num(b.to(r.device).double())
            den = torch.maximum(torch.maximum(
                (r - b).reshape(n, -1).norm(dim=1), 1e-3 * size), floor)
        out[k] = (d / den.clamp_min(1e-300)).cpu()
    return out


def rows_gap(prog, ref) -> float:
    """The worst env's gap between two tensors whose first axis is the
    envs: the norm of its difference over the larger of its reference
    norm and the median env's."""
    import torch
    p = torch.as_tensor(prog).to(torch.as_tensor(ref).device).double()
    r = torch.as_tensor(ref).double()
    if p.shape != r.shape:
        return math.inf
    p, r = _agree(p, r)
    n = r.shape[0]
    d = (p - r).reshape(n, -1).norm(dim=1)
    size = r.reshape(n, -1).norm(dim=1)
    den = torch.maximum(size, size.median()).clamp_min(1e-300)
    g = torch.where(d == 0, torch.zeros_like(d), d / den)
    return float(torch.nan_to_num(g, nan=math.inf).max())


def _median(xs: List[float]) -> float:
    return float(np.median(np.asarray(xs, np.float64)))


def train_gaps(prog: dict, ref: dict, before: List) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses", "grad", "params_after"};
    ``before``: the weights before. Returns the loss, gradient and change
    gaps."""
    pl = np.asarray(prog["losses"], np.float64)
    rl = np.asarray(ref["losses"], np.float64)
    if pl.shape != rl.shape:
        return {"loss": math.inf, "grad": math.inf, "change": math.inf}
    both = ~np.isfinite(pl) & ~np.isfinite(rl)  # a minibatch both skip
    pl, rl = np.where(both, 0.0, pl), np.where(both, 0.0, rl)
    scale = float(np.median(np.abs(rl)))
    loss = max((_ratio(abs(p - r), max(abs(r), scale))
                for p, r in zip(pl, rl)), default=0.0)
    g_ref = [_norm(g) for g in ref["grad"]]
    g_prog = [_norm(g) for g in prog["grad"]]
    med_g = _median(g_ref)
    keep = [i for i, g in enumerate(g_ref) if g >= 1e-3 * med_g]
    d_ref = [_norm(a.double() - b.to(a.device).double())
             for a, b in zip(ref["params_after"], before)]
    d_prog = [_norm(a.to(b.device).double() - b.double())
              for a, b in zip(prog["params_after"], before)]
    med_d = _median([d_ref[i] for i in keep]) if keep else 0.0
    grad = max((_ratio(abs(g_prog[i] - g_ref[i]), max(g_ref[i], med_g))
                for i in keep), default=0.0)
    change = max((_ratio(abs(d_prog[i] - d_ref[i]), max(d_ref[i], med_d))
                  for i in keep), default=0.0)
    return {"loss": loss, "grad": grad, "change": change}


def posterior_gap(prog: List[List[dict]], ref: List[List[dict]],
                  rng) -> float:
    worst = 0.0
    if len(prog) != len(ref):
        return math.inf
    for pc, rc in zip(prog, ref):
        if len(pc) != len(rc):
            return math.inf
        for p, r in zip(pc, rc):
            for key, scale in (("a", 1.0), ("m", rng), ("std", rng)):
                if np.shape(p[key]) != np.shape(r[key]):
                    return math.inf
                d = np.abs(np.asarray(p[key]) - np.asarray(r[key])) / scale
                if not np.all(np.isfinite(d)):
                    return math.inf
                worst = max(worst, float(d.max(initial=0.0)))
    return worst


# ---------------------------------------------------------------------- #
# The port's side, as the gaps read it.
# ---------------------------------------------------------------------- #
def _prog_step(snap: dict) -> dict:
    out = snap["outputs"]
    return {"act": out["act"], "logp": out["logp"], "val": out["val"],
            "rew": out["rew"], "done": out["done"],
            "state": _snap_leaves(snap["state_after"]),
            "obs": snap["obs_after"]}


def _ref_step(out: dict) -> dict:
    keys = [k for k in ("act", "logp", "val", "rew", "done") if k in out]
    return {**{k: out[k] for k in keys},
            "state": _state_leaves(out["state_after"]),
            "obs": out["obs_after"]}


def _prog_round_step(snap: dict) -> dict:
    out = snap["outputs"]
    return {"act": out["act"], "rew": out["rew"], "done": out["done"],
            "state": _snap_leaves(snap["state_after"]),
            "obs": snap["obs_after"]}


def _prog_extracts(run, snap: dict) -> List[Tuple[str, tuple]]:
    """What the port extracted from a tapped round, as (where, (labels,
    states, actions, rewards)), a piece None where the port has none to
    show: the round's output; for a training chunk the fit's input (its
    rows of this round); for the evaluation the logged mean, min and max
    reward."""
    out = [("round", tuple(snap["out"]))]
    k = snap["out"][0].shape[0]
    if snap["kind"] == "evaluation":
        logged = run.snapshots.get("real_rewards") or {}
        out.append(("logged rewards", (None, None, None, logged)))
    else:
        for fit in run.snapshots.get("fits") or []:
            if fit["kind"] == "main":
                out.append(("fit input", (fit["labels"][:k],
                                          fit["states"][:k],
                                          fit["actions"][:k], None)))
    return out


def extract_gap(pieces: List[Tuple[str, tuple]], ref: tuple,
                kind: str) -> Tuple[float, str]:
    """The worst of ``pieces`` against the reference's extraction
    ``ref`` (labels, states, actions, rewards)."""
    worst = (0.0, "")
    names = ("labels", "states", "actions", "rewards")
    for where, piece in pieces:
        for name, p, r in zip(names, piece, ref):
            if p is None:
                continue
            if isinstance(p, dict):  # the logged mean, min and max
                rr = r.double().cpu().numpy()
                scale = max(float(np.median(np.abs(rr))), 1e-300)
                want = {f: float(getattr(np, f)(rr))
                        for f in ("mean", "min", "max")}
                g = max((_ratio(abs(p.get(f, math.nan) - v),
                                max(abs(v), scale))
                         for f, v in want.items()), default=math.inf)
            else:
                g = rows_gap(p, r)
            if not g <= worst[0]:
                worst = (g, f"{kind}: {where}, {name}")
    return worst


def _prog_update(snap: dict) -> dict:
    grad = [(m1 - ADAM_B1 * m0) / (1.0 - ADAM_B1)
            for m0, m1 in zip(snap["adam_mu"], snap["mu_1"])]
    return {"losses": snap["losses"].double().cpu().numpy(), "grad": grad,
            "params_after": snap["params_after"]}


def _prog_fit(snap: dict) -> dict:
    return {"losses": snap["losses"].double().cpu().numpy(),
            "grad": [m / (1.0 - ADAM_B1) for m in snap["mu_1"]],
            "params_after": snap["params_after"]}


def _prog_mixtures(call: dict) -> List[dict]:
    from reference.train_ref import std_of
    return [{"a": m["a"], "m": m["m"], "std": std_of(m)}
            for m in call["mogs"]]


# ---------------------------------------------------------------------- #
# The references.
# ---------------------------------------------------------------------- #
class Reference:
    """The reference's outputs for one run's copies, in one precision and
    with at most one planted fault; cached by (precision, fault)."""

    def __init__(self, run):
        self.run = run
        self._task = None
        self._cache: Dict[Tuple, dict] = {}

    @property
    def model(self) -> dict:
        bs = self.run.env_cfg["bayessim"]
        spec = self.task.params_spec
        return {"summarizer": bs["summarizerFxn"],
                "components": int(bs["components"]),
                "hidden": tuple(bs["hiddenLayers"]), "lr": float(bs["lr"]),
                "lows": np.asarray(spec.lows), "highs": np.asarray(spec.highs)}

    @property
    def task(self):
        if self._task is None:
            from reference.frozen.sim import make_task
            self._task = make_task(self.run.config["task"], self.run.env_cfg,
                                   self.run.device)
        return self._task

    def _round(self, snap: dict, fault: Optional[str]) -> dict:
        from reference import collect_ref
        run, dev = self.run, self.run.device
        out = {"reset": collect_ref.reset(
            run.config["task"], run.env_cfg, snap, dev,
            fault=fault if fault == "altered" else None, task=self.task)}
        if snap["step"] is not None:
            out["step"] = _ref_step(collect_ref.step(
                run.config["task"], run.env_cfg, run.train_cfg, run.task,
                snap, dev, fault=fault, task=self.task))
        raw = {k: v.to(dev) for k, v in snap["raw"].items()}
        out["extract"] = collect_ref.extract(raw, fault=fault)
        return out

    def outputs(self, mode: str = "float32",
                fault: Optional[str] = None) -> dict:
        key = (mode, fault)
        if key in self._cache:
            return self._cache[key]
        from reference import step_ref, train_ref
        run, snaps, dev = self.run, self.run.snapshots, self.run.device
        out: dict = {}
        with precision(mode, dev):
            if snaps.get("step") is not None:
                out["step"] = _ref_step(step_ref.rollout_step(
                    run.config["task"], run.env_cfg, run.train_cfg,
                    run.task, snaps["update"]["params"], snaps["step"], dev,
                    fault=fault if fault != "unchanged" else None,
                    task=self.task))
                if fault == "unchanged":
                    out["step"].update(
                        state=_snap_leaves(snaps["step"]["state"]),
                        obs=snaps["step"]["obs"])
            if snaps.get("update") is not None:
                out["update"] = train_ref.ppo_update(
                    snaps["update"], run.train_cfg, run.task, dev,
                    fault=fault if fault in ("half", "altered") else None)
                if fault == "unchanged":
                    out["update"]["params_after"] = snaps["update"]["params"]
            rounds = []
            for snap in snaps.get("rounds") or []:
                rounds.append(self._round(snap, fault))
            out["rounds"] = rounds
            fits = []
            for snap in snaps.get("fits") or []:
                fit = train_ref.mdn_fit(
                    snap, self.model, dev,
                    fault=fault if fault in ("half", "altered") else None)
                if fault == "unchanged":
                    fit["params_after"] = snap["params"]
                fits.append(fit)
            out["fits"] = fits
            pred = snaps.get("predict")
            if pred is not None:
                mixes = []
                for call in pred["calls"]:
                    x = (train_ref.summaries(self.model["summarizer"],
                                             pred["states"],
                                             pred["actions"], dev)
                         if call["kind"] == "main" else call["xs"])
                    mixes.append(train_ref.mixtures(call, x, self.model,
                                                    dev))
                out["posterior"] = mixes
        self._cache[key] = out
        return out


def numbers(run, prog: Optional[dict] = None,
            ref: Optional[dict] = None) -> Dict[str, Tuple[float, str]]:
    """Each compared number of ``run`` (with a note on where it is worst):
    the port's outputs against the float32 reference, or ``prog`` (another
    reference output in the port's place) against ``ref``."""
    snaps = run.snapshots
    reference = getattr(run, "_reference", None)
    if reference is None:
        reference = run._reference = Reference(run)
    ref = ref if ref is not None else reference.outputs()
    res: Dict[str, Tuple[float, str]] = {}
    steps = []
    if "step" in ref:
        before = {"state": _snap_leaves(snaps["step"]["state"]),
                  "obs": snaps["step"]["obs"]}
        p = prog["step"] if prog is not None else _prog_step(snaps["step"])
        steps.append(step_gap(p, ref["step"], before, "rollout step: "))
    if ref.get("rounds"):
        worst = (0.0, "")
        for i, (snap, r) in enumerate(zip(snaps["rounds"], ref["rounds"])):
            kind = snap["kind"]
            p = prog["rounds"][i] if prog is not None else None
            if p is not None:
                p_reset = {"state": _state_leaves(p["reset"]["state"]),
                           "obs": p["reset"]["obs"]}
            else:
                p_reset = {"state": _snap_leaves(snap["reset"]["state"]),
                           "obs": snap["reset"]["obs"]}
            steps.append(step_gap(
                p_reset, {"state": _state_leaves(r["reset"]["state"]),
                          "obs": r["reset"]["obs"]}, None, f"{kind} reset: "))
            if "step" in r:
                s = snap["step"]
                before = {"state": _snap_leaves(s["state"]), "obs": s["obs"]}
                ps = p["step"] if p is not None else _prog_round_step(s)
                steps.append(step_gap(ps, r["step"], before,
                                      f"{kind} step {snap['j']}: "))
            pieces = ([("reference", p["extract"])] if p is not None
                      else _prog_extracts(run, snap))
            g = extract_gap(pieces, r["extract"], kind)
            if not g[0] <= worst[0]:
                worst = g
        res["extract_gap"] = worst
    for name in ("step_gap", "step_gap_max"):
        if steps:
            res[name] = max((s[name] for s in steps),
                            key=lambda x: (not x[0] <= math.inf, x[0]))
    if "update" in ref:
        p = prog["update"] if prog is not None else _prog_update(
            snaps["update"])
        g = train_gaps(p, ref["update"], snaps["update"]["params"])
        for k, v in g.items():
            res[f"update_{k}_gap"] = (v, "")
    if ref.get("fits"):
        worst = {"loss": (0.0, ""), "grad": (0.0, ""), "change": (0.0, "")}
        for i, (snap, r) in enumerate(zip(snaps["fits"], ref["fits"])):
            p = prog["fits"][i] if prog is not None else _prog_fit(snap)
            for k, v in train_gaps(p, r, snap["params"]).items():
                if not v <= worst[k][0]:
                    worst[k] = (v, snap["kind"])
        for k, v in worst.items():
            res[f"fit_{k}_gap"] = v
    if "posterior" in ref:
        model = reference.model
        rng = (np.asarray(model["highs"], np.float32)
               - np.asarray(model["lows"], np.float32)).astype(np.float64)
        p = prog["posterior"] if prog is not None else [
            _prog_mixtures(c) for c in snaps["predict"]["calls"]]
        res["posterior_gap"] = (posterior_gap(p, ref["posterior"], rng), "")
    return res


def expected(loop: str) -> List[str]:
    """The numbers a cell of ``loop`` has to hold to a limit."""
    return list(NUMBERS if loop == "adr" else TRAIN_NUMBERS)
