"""States for the integration kernel's checks that drive every clamp of
``integrate`` and ``clamp_limits``, and for the kinematics kernel's; shared
by ``tests/test_torch_integrate_kernel.py``,
``tests/test_torch_fk_kernel.py`` and ``chip_smoke.py``. It imports no JAX,
so that the card's checks can use it where JAX is absent."""

import numpy as np
import torch


def clamp_driving_states(model, n, seed=0, device="cpu"):
    """q, v, qdd (float32, env-first) on ``device``: free bodies' world
    velocities around and past MAX_LIN_VEL and MAX_ANG_VEL, 1-dof
    velocities past max_velocity, positions past both limits."""
    rs = np.random.RandomState(seed)
    q = np.zeros((n, model.nq))
    v = np.zeros((n, model.nv))
    qdd = rs.uniform(-3000.0, 3000.0, (n, model.nv))
    for (_, qi, vi) in model.free_list:
        q[:, qi:qi + 3] = rs.uniform(-2.0, 2.0, (n, 3))
        quat = rs.normal(size=(n, 4))
        q[:, qi + 3:qi + 7] = quat / np.linalg.norm(quat, axis=1,
                                                    keepdims=True)
        v[:, vi:vi + 3] = rs.uniform(-70.0, 70.0, (n, 3))
        v[:, vi + 3:vi + 6] = rs.uniform(-110.0, 110.0, (n, 3))
    lo = np.maximum(model.j1_lo, -3.0)
    hi = np.minimum(model.j1_hi, 3.0)
    q[:, model.j1_q] = rs.uniform(lo - 0.3, hi + 0.3, (n, len(lo)))
    v[:, model.j1_v] = rs.uniform(-1.5, 1.5, (n, len(lo))) * model.j1_maxv
    return [torch.as_tensor(x, dtype=torch.float32, device=device)
            for x in (q, v, qdd)]


def kinematics_states(model, n, seed=0, device="cpu"):
    """q, v (float32, env-first) and a per-env geometry scale (N,) on
    ``device``: free bodies anywhere within 2 m at any orientation and
    speed, joints across and past their ranges, the scale DR'd in [0.7,
    1.3]."""
    q, v, _ = clamp_driving_states(model, n, seed, device)
    rs = np.random.RandomState(seed + 1)
    scale = torch.as_tensor(rs.uniform(0.7, 1.3, n), dtype=torch.float32,
                            device=device)
    return q, v, scale
