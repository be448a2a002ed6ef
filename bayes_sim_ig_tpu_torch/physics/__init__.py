"""Rigid-body physics in PyTorch: spatial algebra, articulated dynamics
(CRBA/RNEA + the dense SPD or the branch-sparse tree solve), ground-plane
penalty contacts and the sphere-vs-body-plane pair contact.

Port of ``bayes_sim_ig_tpu/physics``: batched functions over env-first
state with env-last internals (dynamics.py). Not ported yet: the
multi-pair and impulse contacts.
"""

from .model import ArticulatedModel, LinkSpec, Geom, DynParams, JOINT_DOF
from .dynamics import (
    forward_kinematics, forward_dynamics, integrate, mass_matrix,
    bias_forces, clamp_limits, dof_positions, carried_mass_factor,
    mass_factor_solve, external_generalized_force,
)
from .contact import (
    ground_contact_forces, contact_points, sphere_plane_pair_forces,
)

__all__ = [
    "ArticulatedModel", "LinkSpec", "Geom", "DynParams", "JOINT_DOF",
    "forward_kinematics", "forward_dynamics", "integrate", "mass_matrix",
    "bias_forces", "clamp_limits", "dof_positions",
    "carried_mass_factor", "mass_factor_solve",
    "external_generalized_force",
    "ground_contact_forces", "contact_points",
    "sphere_plane_pair_forces",
]
