"""Rigid-body physics in PyTorch: spatial algebra, articulated dynamics
(CRBA/RNEA + the dense SPD or the branch-sparse tree solve), penalty
contacts (ground plane, sphere-plane, sphere-box and sphere-sphere pairs)
and the velocity-level contact impulse pass.

Port of ``bayes_sim_ig_tpu/physics``: batched functions over env-first
state with env-last internals (dynamics.py).
"""

from .model import ArticulatedModel, LinkSpec, Geom, DynParams, JOINT_DOF
from .dynamics import (
    forward_kinematics, forward_dynamics, integrate, mass_matrix,
    bias_forces, clamp_limits, integrate_and_clamp, dof_positions,
    carried_mass_factor, mass_factor_solve, external_generalized_force,
)
from .contact import (
    ground_contact_forces, contact_points, sphere_plane_pair_forces,
    sphere_plane_pairs_forces, sphere_box_pairs_forces,
    sphere_sphere_pairs_forces, contact_pairs_impulse,
    contact_pairs_impulse_prepare, contact_pairs_impulse_apply,
    impulse_row_forces, impulse_generalized_force, sphere_sphere_impulse,
)

__all__ = [
    "ArticulatedModel", "LinkSpec", "Geom", "DynParams", "JOINT_DOF",
    "forward_kinematics", "forward_dynamics", "integrate", "mass_matrix",
    "bias_forces", "clamp_limits", "integrate_and_clamp", "dof_positions",
    "carried_mass_factor", "mass_factor_solve",
    "external_generalized_force",
    "ground_contact_forces", "contact_points",
    "sphere_plane_pair_forces", "sphere_plane_pairs_forces",
    "sphere_box_pairs_forces", "sphere_sphere_pairs_forces",
    "contact_pairs_impulse", "contact_pairs_impulse_prepare",
    "contact_pairs_impulse_apply", "impulse_row_forces",
    "impulse_generalized_force", "sphere_sphere_impulse",
]
