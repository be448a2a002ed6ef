# Frozen copy of bayes_sim_ig_tpu_torch/dr/params_spec.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Flat simulation-parameter spec from a randomization config tree.

Rebuild of the reference ``ParamsGenerator``
(``bayes_sim_ig/sim/params_generator.py:78-206``): walks the
``task.randomization_params.actor_params`` yaml tree against a task's named
bodies/shapes/dofs/tendons and emits one named scalar dimension per
(actor x property x attribute [x array index]), with lows/highs/defaults and
plot skip ids. The flat order of dimensions is the walk order — the same
invariant the reference enforces between sampling and application
(apply_randomizations.py:228-236).

Difference: the reference's generator also *samples* one vector at
a time on the host; here sampling is batched on device
(``distributions.device.sample_distr``) and "applying" a sample is just
handing the (N, P) params array to the task's pure step functions. The
``ParamsSpec.index_of``/``slice_of`` helpers let tasks bind flat dims to
semantic quantities once, at construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Property categories, in the reference's naming (params_generator.py:14-15).
# dof_properties is the only array-attribute category (one property object
# whose attrs are per-dof arrays); every other category is a list of
# per-body/shape/tendon objects with scalar attrs.
LINK_PROPS = ("rigid_body_properties", "rigid_shape_properties",
              "tendon_properties")
ARRAY_PROPS = ("dof_properties",)


@dataclass
class TaskNames:
    """Named structure of one actor, declared by each task."""
    body_names: Sequence[str] = ()
    shape_names: Sequence[str] = ()
    dof_names: Sequence[str] = ()
    tendon_names: Sequence[str] = ()


def make_name(names: TaskNames, oper: str, prop_name: str, prop_idx: int,
              attr_name: str, attr_idx: Optional[int] = None) -> str:
    """Human-readable dimension name (params_generator.py:38-62)."""
    sfx = "_" + attr_name
    if attr_idx is not None:
        sfx += "_" + str(attr_idx)
    if prop_name == "rigid_body_properties":
        name = names.body_names[prop_idx] + sfx
    elif prop_name == "rigid_shape_properties":
        name = names.shape_names[prop_idx] + sfx
    elif prop_name == "tendon_properties":
        name = names.tendon_names[prop_idx] + sfx
    elif (prop_name == "dof_properties" and attr_idx is not None
          and prop_idx == 0):
        name = names.dof_names[attr_idx] + "_" + attr_name
    else:
        name = prop_name + "_" + str(prop_idx) + sfx
    if oper == "scaling":
        name += "_mult"
    return name


def check_operation(operation: str, default: float, name: str) -> None:
    """Scaling needs a positive default; additive needs default == 0
    (params_generator.py:65-75)."""
    if operation == "scaling":
        assert default > 0, \
            f"Error: operation scaling zero default {name}"
    elif operation == "additive":
        assert default == 0, \
            f"Error: operation additive needs default==0 for {name}, " \
            f"got {default:0.4f}"
    else:
        raise AssertionError(f"Unknown operation {operation}")


@dataclass
class ParamsSpec:
    """Flat named parameter vector spec."""
    names: List[str]
    lows: np.ndarray
    highs: np.ndarray
    defaults: np.ndarray
    skip_ids: List[int]
    operations: List[str]
    # (actor, prop_name, prop_idx, attr_name, attr_idx) per dim, for tasks
    # that bind dims structurally rather than by name.
    keys: List[Tuple[str, str, int, str, Optional[int]]] = field(
        default_factory=list)

    @property
    def dim(self) -> int:
        return len(self.names)

    def index_of(self, substr: str) -> int:
        """First dim whose name contains ``substr`` (PendulumB-style lookup,
        openai_env_wrappers.py:44-48)."""
        for i, nm in enumerate(self.names):
            if substr in nm:
                return i
        raise KeyError(f"No param dim matching '{substr}' in {self.names}")

    def indices_of(self, prop_name: str, attr_name: str) -> List[int]:
        """All dims for a given (property, attribute) pair, in flat order."""
        return [i for i, k in enumerate(self.keys)
                if k[1] == prop_name and k[3] == attr_name]

    def describe(self) -> str:
        lines = [f"ParamsSpec with {self.dim} dims:"]
        for nm, d, lo, hi in zip(self.names, self.defaults, self.lows,
                                 self.highs):
            lines.append(
                f"{nm} range [{lo:0.6f} {hi:0.6f}] default {d:0.6f}")
        return "\n".join(lines)


def build_params_spec(
        dr_params: dict,
        actor_names_map: Dict[str, TaskNames],
        defaults_map: Dict[str, Dict[str, Dict[str, "np.ndarray | float"]]],
        plot_names_skip_patterns: Optional[Sequence[str]] = None,
) -> ParamsSpec:
    """Walks ``dr_params['actor_params']`` and emits the flat spec.

    Parameters
    ----------
    dr_params : the ``randomization_params`` config subtree.
    actor_names_map : actor name -> TaskNames (the rebuild's analogue of
        querying IG getters, params_generator.py:18-35).
    defaults_map : actor -> prop_name -> attr_name -> default value(s); an
        array gives one dim per entry (e.g. per-body masses), a scalar one
        dim. ``scale`` uses key ('scale', '') with a scalar default.
    plot_names_skip_patterns : name substrings whose dims are excluded from
        posterior plots (ig_env_wrappers.py per-task lists).
    """
    names: List[str] = []
    lows: List[float] = []
    highs: List[float] = []
    defaults: List[float] = []
    operations: List[str] = []
    keys: List[Tuple[str, str, int, str, Optional[int]]] = []
    skip_ids: List[int] = []

    def maybe_skip(name: str) -> None:
        if plot_names_skip_patterns is not None:
            for pattern in plot_names_skip_patterns:
                if pattern in name:
                    skip_ids.append(len(names))
                    return

    for actor_name, actor_properties in dr_params["actor_params"].items():
        tn = actor_names_map[actor_name]
        actor_defaults = defaults_map.get(actor_name, {})
        for prop_name, prop_attrs in actor_properties.items():
            if prop_name == "color":  # set randomly, never inferred
                continue
            if prop_name == "scale":
                lo_hi = np.asarray(prop_attrs["range"], np.float64)
                oper = prop_attrs["operation"]
                default = float(actor_defaults.get("scale", {}).get("", 1.0))
                check_operation(oper, default, actor_name + "_scale")
                name = actor_name + "_scale"
                if oper == "scaling":
                    name += "_mult"
                maybe_skip(name)
                names.append(name)
                lows.append(lo_hi[0])
                highs.append(lo_hi[1])
                defaults.append(default)
                operations.append(oper)
                keys.append((actor_name, "scale", 0, "", None))
                continue
            prop_defaults = actor_defaults.get(prop_name, {})

            def emit(name, lo_hi, oper, default, key):
                maybe_skip(name)
                check_operation(oper, default, name)
                names.append(name)
                lows.append(lo_hi[0])
                highs.append(lo_hi[1])
                defaults.append(default)
                operations.append(oper)
                keys.append(key)

            if prop_name == "dof_properties":
                # One property object with array-valued attributes: the
                # reference walks attr outer, dof index inner
                # (params_generator.py:167-187 ndarray branch). Tendon
                # properties are a LIST of per-tendon objects and take the
                # per-object branch below.
                for attr_name, attr_cfg in prop_attrs.items():
                    lo_hi = np.asarray(attr_cfg["range"], np.float64)
                    oper = attr_cfg["operation"]
                    dflts = np.atleast_1d(np.asarray(
                        prop_defaults.get(attr_name, 1.0), np.float64))
                    for attr_idx in range(dflts.shape[0]):
                        emit(make_name(tn, oper, prop_name, 0, attr_name,
                                       attr_idx),
                             lo_hi, oper, dflts[attr_idx],
                             (actor_name, prop_name, 0, attr_name, attr_idx))
            else:
                # A list of per-body/per-shape property objects with scalar
                # attributes: body outer, attr inner
                # (params_generator.py:167-168 list branch) — this ordering
                # defines the meaning of realParams vectors in the configs.
                n_props = max(
                    np.atleast_1d(np.asarray(
                        prop_defaults.get(a, 1.0), np.float64)).shape[0]
                    for a in prop_attrs)
                for prop_idx in range(n_props):
                    for attr_name, attr_cfg in prop_attrs.items():
                        lo_hi = np.asarray(attr_cfg["range"], np.float64)
                        oper = attr_cfg["operation"]
                        dflts = np.atleast_1d(np.asarray(
                            prop_defaults.get(attr_name, 1.0), np.float64))
                        if dflts.shape[0] != n_props:
                            # Broadcast a scalar default across the
                            # n_props bodies (n_props is the max over
                            # attrs; a scalar default for one attr next
                            # to per-body defaults for another would
                            # otherwise IndexError). A length mismatch
                            # that isn't a scalar is a config error.
                            assert dflts.shape[0] == 1, (
                                f"{actor_name}/{prop_name}/{attr_name}: "
                                f"{dflts.shape[0]} defaults vs {n_props} "
                                "bodies")
                            dflts = np.broadcast_to(dflts, (n_props,))
                        emit(make_name(tn, oper, prop_name, prop_idx,
                                       attr_name),
                             lo_hi, oper, dflts[prop_idx],
                             (actor_name, prop_name, prop_idx, attr_name,
                              None))
    return ParamsSpec(names=names, lows=np.asarray(lows),
                      highs=np.asarray(highs),
                      defaults=np.asarray(defaults), skip_ids=skip_ids,
                      operations=operations, keys=keys)
