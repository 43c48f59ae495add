"""Halfcheetah benchmark with planar multibody dynamics (port of
``autompc_tpu/benchmarks/halfcheetah.py``: ``halfcheetah_dynamics``,
``HalfcheetahCost``, ``HalfcheetahBenchmark``).

18-dim state (9 qpos + 9 qvel), 6 torque controls, 200 steps, metric
``200 - R`` with the gym running reward. Generalized coordinates (gym
ordering): ``[rootx, rootz, rooty, bthigh, bshin, bfoot, fthigh, fshin,
ffoot]``. The simulator is the JAX package's: Lagrangian dynamics of
seven rods, soft ground contacts at the two feet and the two torso ends
solved at the velocity level by projected Gauss-Seidel on the
friction-cone problem, linearly-implicit Euler at dt = 0.002 with 25
substeps per control step.

The JAX code is written per sample, vmapped, and takes ``jax.jacfwd``
of the forward kinematics for the mass matrix, its derivative and the
contact Jacobian. Here everything is batch-native and in closed form.
Every body and contact point is ``root + sum_m w_m d_m(q)`` with ``d_m``
a unit vector at an angle ``a_m`` that is a 0/1 combination of the
joint angles. So the position Jacobians are ``E + sum_m w_m d_m' A_m``,
their time derivative is ``-sum_m w_m d_m (A_m . qdot) A_m`` (since
``d_m'' = -d_m``), the Coriolis/centrifugal bias ``Mdot qdot - 1/2
d(qdot' M qdot)/dq`` reduces to ``sum_i m_i Jp_i' (Jpdot_i qdot)``, and
gravity is ``g sum_i m_i Jp_i[z]``. The Gauss-Seidel sweeps are
unrolled in the JAX package's contact order. ``visualize`` and
``get_cached_tune_result`` are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..core.system import System
from ..core.task import Task
from ..costs.cost import Cost
from . import data_generation as dg
from .benchmark import Benchmark, check_data_gen_method

# Model parameters (approximating the gym half_cheetah.xml).
_TORSO_M, _TORSO_I, _TORSO_L = 6.25, 0.3, 1.0
_LINKS = (
    # (mass, length) of bthigh, bshin, bfoot, fthigh, fshin, ffoot
    (1.54, 0.29), (1.59, 0.30), (1.10, 0.188),
    (1.44, 0.266), (1.20, 0.212), (0.88, 0.14),
)
_GEARS = (120.0, 90.0, 60.0, 120.0, 60.0, 30.0)
_DAMPING = (6.0, 4.5, 3.0, 4.5, 3.0, 1.5)
_STIFFNESS = (240.0, 180.0, 120.0, 180.0, 120.0, 60.0)
_JNT_RANGE = (
    (-0.52, 1.05), (-0.785, 0.785), (-0.4, 0.785),
    (-1.0, 0.7), (-1.2, 0.87), (-0.5, 0.5),
)
_GRAVITY = 9.81
_FRICTION_MU = 0.4
_ARMATURE = 0.1
# Velocity-level contact solve (MuJoCo-style soft constraint):
_CONTACT_BETA = 0.2        # Baumgarte penetration push-out fraction/step
_CONTACT_PUSH_MAX = 0.5    # cap on push-out velocity (m/s)
_CONTACT_SOFT_N = 2e-3     # normal-constraint compliance (CFM)
_CONTACT_SOFT_T = 1e-3     # tangential compliance
_CONTACT_MARGIN = 1e-4     # activation distance (m)
_PGS_SWEEPS = 8
_SUBSTEPS = 25
_SUB_DT = 0.002
_N_CONTACTS = 4


@functools.lru_cache(maxsize=8)
def _constants(device, dtype):
    """The model's constant tensors on ``device``."""
    lens = [length for _, length in _LINKS]
    masses = [_TORSO_M] + [m for m, _ in _LINKS]
    inertias = [_TORSO_I] + [m * length * length / 12.0 for m, length in _LINKS]
    # A[m]: the angle of direction m as a 0/1 combination of q. Direction
    # 0 is the torso axis; 1..3 the back leg's links, 4..6 the front's.
    A = np.zeros((7, 9))
    A[:, 2] = 1.0
    for leg, first in ((0, 3), (1, 6)):
        for k in range(3):
            A[1 + 3 * leg + k, first:first + k + 1] = 1.0
    # W[p, m]: weight of direction m in point p. Points 0..6 are the body
    # centres (torso, bthigh, bshin, bfoot, fthigh, fshin, ffoot), 7..10
    # the contacts (bfoot tip, ffoot tip, torso rear, torso front).
    W = np.zeros((11, 7))
    for leg, sign in ((0, -1.0), (1, 1.0)):
        for k in range(3):
            p = 1 + 3 * leg + k
            W[p, 0] = sign * _TORSO_L / 2
            for m in range(k):
                W[p, 1 + 3 * leg + m] = lens[3 * leg + m]
            W[p, 1 + 3 * leg + k] = lens[3 * leg + k] / 2
        tip = 7 + leg
        W[tip, 0] = sign * _TORSO_L / 2
        for m in range(3):
            W[tip, 1 + 3 * leg + m] = lens[3 * leg + m]
        W[9 + leg, 0] = sign * _TORSO_L / 2
    E = np.zeros((2, 9))
    E[0, 0] = E[1, 1] = 1.0
    M_const = np.einsum("i,ij,ik->jk", np.array(inertias), A, A)
    M_const = M_const + np.diag([0.0] * 3 + [_ARMATURE] * 6)
    soft = np.zeros(2 * _N_CONTACTS)
    soft[0::2] = _CONTACT_SOFT_T
    soft[1::2] = _CONTACT_SOFT_N

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    return dict(
        A=t(A), W=t(W), E=t(E), masses=t(masses), M_const=t(M_const),
        gears=t(_GEARS), damping=t(_DAMPING), stiffness=t(_STIFFNESS),
        lo=t([r[0] for r in _JNT_RANGE]), hi=t([r[1] for r in _JNT_RANGE]),
        soft=t(soft),
    )


def _kinematics(q, C):
    """Points (B, 11, 2) [7 body centres, 4 contacts], their Jacobians
    Jp (B, 11, 2, 9), and the pieces of the Jacobians' time derivative:
    the directions d (B, 7, 2)."""
    ang = q @ C["A"].T                                   # (B, 7)
    s, c = torch.sin(ang), torch.cos(ang)
    # d_0 = (cos, sin) is the torso axis; d_m = (sin, -cos) a hanging link.
    d = torch.stack([s, -c], dim=-1)
    d[:, 0, 0], d[:, 0, 1] = c[:, 0], s[:, 0]
    dd = torch.stack([c, s], dim=-1)                     # d d_m / d a_m
    dd[:, 0, 0], dd[:, 0, 1] = -s[:, 0], c[:, 0]
    pts = q[:, None, :2] + torch.einsum("pm,bma->bpa", C["W"], d)
    T = dd[:, :, :, None] * C["A"][None, :, None, :]     # (B, 7, 2, 9)
    Jp = C["E"] + torch.einsum("pm,bmaj->bpaj", C["W"], T)
    return pts, Jp, d


def _contact_impulse(pts, Jf, Minv_Jt, qdot_unc, C):
    """Velocity-level soft-contact impulse solve (projected Gauss-Seidel
    on the friction-cone complementarity problem). ``pts`` (B, 4, 2)
    contact points, ``Jf`` (B, 8, 9) their Jacobian with rows (tangent,
    normal) per contact, ``Minv_Jt = A^-1 Jf'`` (B, 9, 8). Returns the
    generalized velocity correction ``A^-1 Jf' lam``."""
    W = Jf @ Minv_Jt                                     # (B, 8, 8)
    v0 = (Jf @ qdot_unc[:, :, None])[:, :, 0]            # (B, 8)
    pen = torch.clamp_min(-pts[:, :, 1], 0.0)
    active = (pts[:, :, 1] < _CONTACT_MARGIN).to(pts.dtype)
    b_n = torch.clamp_max(_CONTACT_BETA * pen / _SUB_DT, _CONTACT_PUSH_MAX)
    soft_dt = C["soft"] / _SUB_DT
    diagW = torch.diagonal(W, dim1=1, dim2=2) + soft_dt
    lam = torch.zeros_like(v0)
    for _ in range(_PGS_SWEEPS):
        # Normal then tangent per contact, full velocity coupling via W.
        for i in range(_N_CONTACTS):
            ni, ti = 2 * i + 1, 2 * i
            vn = v0[:, ni] + (W[:, ni] * lam).sum(-1)
            ln = lam[:, ni] - (vn - b_n[:, i] + soft_dt[ni] * lam[:, ni]) / diagW[:, ni]
            ln = torch.clamp_min(ln, 0.0) * active[:, i]
            lam[:, ni] = ln
            vt = v0[:, ti] + (W[:, ti] * lam).sum(-1)
            lt = lam[:, ti] - (vt + soft_dt[ti] * lam[:, ti]) / diagW[:, ti]
            lim = _FRICTION_MU * ln
            lt = torch.minimum(torch.maximum(lt, -lim), lim) * active[:, i]
            lam[:, ti] = lt
    return (Minv_Jt @ lam[:, :, None])[:, :, 0]


def _substep(q, qdot, tau_act, C):
    """One linearly-implicit Euler substep: joint stiffness, range
    penalties and damping implicit, everything else explicit:
    ``(M + dt D + dt^2 K) qdot' = M qdot + dt (tau - K q_err)``."""
    pts, Jp, d = _kinematics(q, C)
    Jb, masses = Jp[:, :7], C["masses"]
    M = torch.einsum("i,biaj,biak->bjk", masses, Jb, Jb) + C["M_const"]
    # Bias forces: sum_i m_i Jp_i' (Jpdot_i qdot).
    adot = qdot @ C["A"].T                               # (B, 7)
    Tq = d * (adot * adot)[:, :, None]                   # d_m (A_m.qdot)^2
    Jdq = -torch.einsum("pm,bma->bpa", C["W"][:7], Tq)   # Jpdot_i qdot
    c = torch.einsum("i,biaj,bia->bj", masses, Jb, Jdq)
    g = _GRAVITY * torch.einsum("i,bij->bj", masses, Jb[:, :, 1])

    # Joint spring/range forces at the current q plus implicit stiffness.
    qj = q[:, 3:]
    below = torch.clamp_max(qj - C["lo"], 0.0)
    above = torch.clamp_min(qj - C["hi"], 0.0)
    violated = ((below < 0) | (above > 0)).to(q.dtype)
    k_joint = C["stiffness"] + 2000.0 * violated
    d_joint = C["damping"] + 20.0 * violated
    tau = tau_act.clone()
    tau[:, 3:] += -C["stiffness"] * qj - 2000.0 * (below + above)

    rhs = (M @ qdot[:, :, None])[:, :, 0] + _SUB_DT * (tau - c - g)
    A = M.clone()
    diag = torch.diagonal(A, dim1=1, dim2=2)
    diag[:, 3:] += _SUB_DT * d_joint + _SUB_DT ** 2 * k_joint
    Jf = Jp[:, 7:].reshape(-1, 2 * _N_CONTACTS, 9)
    sol = torch.linalg.solve(A, torch.cat([rhs[:, :, None], Jf.transpose(1, 2)], dim=2))
    qdot_unc = sol[:, :, 0]
    qdot_new = qdot_unc + _contact_impulse(pts[:, 7:], Jf, sol[:, :, 1:], qdot_unc, C)
    # Clamp velocities for numerical robustness under wild random inputs.
    qdot_new = torch.clamp(qdot_new, -50.0, 50.0)
    return q + _SUB_DT * qdot_new, qdot_new


def halfcheetah_dynamics(x, u, n_frames=_SUBSTEPS):
    """Discrete dynamics: x = [qpos(9), qvel(9)] (..., 18), u (..., 6)
    in [-1, 1]^6, every leading axis a batch axis."""
    lead = x.shape[:-1]
    x2, u2 = x.reshape(-1, 18), u.reshape(-1, 6)
    C = _constants(x.device, x.dtype)
    q, qdot = x2[:, :9], x2[:, 9:]
    tau_act = x2.new_zeros((x2.shape[0], 9))
    tau_act[:, 3:] = C["gears"] * torch.clamp(u2, -1.0, 1.0)
    for _ in range(n_frames):
        q, qdot = _substep(q, qdot, tau_act, C)
    return torch.cat([q, qdot], dim=-1).reshape(lead + (18,))


class HalfcheetahCost(Cost):
    """``200 - R`` with the gym running reward in its telescoped
    stage/terminal form: zero observation stage cost, ``0.1 ||u||^2``
    control stage cost, terminal ``200 - (x_T[0] - init_x) / dt``."""

    def __init__(self, system, dt=0.05, init_x=0.0):
        super().__init__(system)
        self._dt = dt
        self._init_x = float(init_x)

    def __call__(self, traj):
        ctrl_r = -0.1 * (traj.ctrls[:-1] ** 2).sum()
        run_r = (traj.obs[1:, 0] - traj.obs[:-1, 0]).sum() / self._dt
        return 200.0 - (ctrl_r + run_r)

    def eval_obs_cost(self, obs):
        return obs.new_zeros(obs.shape[:-1])

    def eval_ctrl_cost(self, ctrl):
        return 0.1 * (ctrl * ctrl).sum(-1)

    def eval_term_obs_cost(self, obs):
        return 200.0 - (obs[..., 0] - self._init_x) / self._dt


class HalfcheetahBenchmark(Benchmark):
    """18 obs / 6 ctrl, 200 steps, metric 200 - R."""

    def __init__(self, data_gen_method="uniform_random"):
        check_data_gen_method(data_gen_method, self.data_gen_methods())
        system = System(
            [f"x{i}" for i in range(18)], [f"u{i}" for i in range(6)], dt=0.05
        )
        cost = HalfcheetahCost(system, dt=0.05)
        task = Task(system)
        task.set_cost(cost)
        task.set_ctrl_bounds(-np.ones(6), np.ones(6))
        init_qpos = np.zeros(9)
        init_qpos[1] = 0.7  # torso height above ground
        task.set_init_obs(np.concatenate([init_qpos, np.zeros(9)]))
        task.set_num_steps(200)
        super().__init__("halfcheetah", system, task, data_gen_method)

    def dynamics(self, x, u):
        return halfcheetah_dynamics(x, u)

    def _gen_trajs(self, n_trajs, traj_len, rng, draws=None):
        """The training set by the benchmark's data-generation method;
        ``draws`` replaces the generator's random draws (see
        ``data_generation``)."""
        init = np.asarray(self.task.get_init_obs(), dtype=np.float64)
        # Small random perturbations of the nominal standing pose.
        init_min = init - 0.1
        init_max = init + 0.1
        init_min[1] = init[1]
        init_max[1] = init[1] + 0.05
        common = dict(
            system=self.system, task=self.task, dynamics=self.dynamics,
            rng=rng, init_min=init_min, init_max=init_max,
            traj_len=traj_len, n_trajs=n_trajs, draws=draws,
        )
        method = self._data_gen_method
        if method == "uniform_random":
            return dg.uniform_random_generate_batch(**common)
        if method == "multisine":
            return dg.multisine_generate_batch(n_freqs=20, **common)
        if method == "random_walk":
            return dg.random_walk_generate_batch(walk_rate=1.0, **common)
        raise ValueError(f"Unknown data_gen_method {method!r}")

    def gen_trajs_batch(self, seed, n_trajs, traj_len=200, device=None):
        rng = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
        return self._gen_trajs(n_trajs, traj_len, rng)

    @staticmethod
    def data_gen_methods():
        return ["uniform_random", "multisine", "random_walk"]
