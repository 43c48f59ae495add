"""Iterative LQR: the batched solver with converged-lane compaction, the
single-lane solver and the receding-horizon controller (port of
``autompc_tpu/control/ilqr.py``: ``make_batched_ilqr_solver``,
``make_scheduled_ilqr_solver``, ``make_staged_ilqr_solver``,
``make_ilqr_solver``, ``IterativeLQR`` and ``IterativeLQRFactory``).

Semantics are the JAX package's: dt-scaled stage expansions, the Riccati
backward pass, ``alpha = ls_discount**i`` line search with the
expected-reduction acceptance test, Jacobians relinearized only after a
successful line search, a lane fails when its objective worsens by more
than 1e-3, and converges when ``||u_new - u_old|| < u_threshold``.

Two bodies of the iteration are ported.

``lanes_last=True`` — dc = 1, a diagonal quadratic cost (one fixed
QuadCost, or one per lane with ``quad_cost_batch``), a
linear-in-features model (``feature_spec``; one for every lane, or one a
lane with ``batch_params``, under either cost form: a fixed cost's
diagonals then ride the carry as per-lane planes), ``fuse_ls=True``. The carry
stays in the kernels' lanes-last layout for the whole solve — xs
(H+1, ds, B), us (H, B), gains (H, ds, B)/(H, B) and the packed Jacobian
plane jac (H, ds*(ds+1), B), float32 or, with ``jac_dtype="bf16"``,
bfloat16 — packed once at entry and unpacked once by ``finalize``. Each
iteration is two kernel launches (``ops/cuda_riccati.py`` and
``ops/cuda_linesearch.py``, which applies the carry select itself) plus
a few lane-vector ops; the entry relinearization is
``ops/cuda_relin.py``. With ``ls_wide=True`` an iteration whose batch
is a multiple of 1024 takes the split line search instead (two kernels
and the acceptance rule in tensor ops between them); the environment
variable ``AMPC_BQ_WIDE_IO`` ("cast", the default, or "reshape") picks
the backward pass's entry, as in the JAX package.

``lanes_last=False`` — the batch-major body: any (ds, dc), any cost with
``eval_*_cost_hess`` or per-lane diagonal costs, a model with a
closed-form Jacobian (``pred_diff``), a linear-in-features model
(``feature_spec``, dc = 1) or neither (every point differentiated by
``torch.func.jacfwd``, as the JAX package's ``jax.jacfwd``), one model
for every lane or one a lane (``batch_params``), one horizon or one a lane (``horizon_mask``). The carry is batch-major: xs (B, H+1, ds),
us (B, H, dc), Jx (B, H, ds, ds), Ju (B, H, ds, dc), gains
(B, H, dc, ds)/(B, H, dc). Each iteration runs the backward pass
(``backward="pallas"``: at dc = 1 with a diagonal cost the
inline-expansion kernel ``ops/cuda_riccati.py::backward_quad``, else the
dense stage expansions into the kernel of
``ops/cuda_riccati_general.py``; ``"scan"``: the expansions into
``ops/riccati.py``'s recursion; ``"assoc"``: into its associative scan,
O(log H) depth), rolls out every step size (``feature_spec``: the
kernel ``ops/cuda_linesearch.py::sindy_line_search``; ``mlp_ls``: the
kernel of ``ops/cuda_mlp_linesearch.py``; neither: a batched loop over H
through ``pred_core``), evaluates the L objectives and applies the
acceptance rule in tensor ops, and relinearizes the chosen trajectory
(``feature_spec``: ``ops/cuda_relin.py``'s batch-major entry, unless
``relin="xla"``; else ``pred_diff`` or autodiff; ``analytic_jac`` with
``relin="xla"``: the library's closed-form feature Jacobian). With
``fuse_ls`` and a ``feature_spec`` under a quadratic cost (diagonal per
lane, a fixed diagonal one broadcast to per-lane planes, or a fixed dense
one) the line search, the acceptance rule and the relinearization are one
kernel, K3's batch-major entry
(``ops/cuda_linesearch.py::fused_line_search_bm``, at any dc, each
control with its own bounds; under ``relin="xla"`` without its
Jacobians), and the body applies the carry select.

``reg_matrix``/``reg_goal`` (with ``quad_cost_batch``, batch-major body
only) add the GaussReg term ``regw_b (x - mu)' S (x - mu)`` to every
stage cost, ``regw`` (B,) a lane's weight in ``cost_params``: the
objective, the dense expansions (so the backward pass is the general
kernel or the plain recursion, never the inline-expansion kernel) and,
fused, K3's batch-major entry with its GaussReg term.

Both loops read the active-lane count on the host once per iteration.
``make_staged_ilqr_solver`` drives the batch-major body in chunks and
gathers the survivors into power-of-two buckets between them.
``make_ilqr_solver`` is the batch-major body at one lane, the model
differentiated by ``torch.func.jacfwd`` unless it has a closed-form
Jacobian. What the JAX solver refuses raises ``ValueError`` naming it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import NotPortedError
from ..config import ConfigurationSpace, UniformIntegerHyperparameter
from ..ops._build import WIDE_B
from ..ops.cuda_linesearch import (
    fused_line_search,
    fused_line_search_bm,
    fused_line_search_wide,
    sindy_line_search,
)
from ..ops.cuda_mlp_linesearch import check_precision, fold_mlp_params, mlp_line_search
from ..ops.cuda_relin import relin_jacobians, relin_jacobians_bm
from ..ops.cuda_riccati import backward_quad, backward_quad_ll
from ..ops.cuda_riccati_general import riccati_general
from ..ops.riccati import tvlqr_backward_assoc, tvlqr_backward_scan
from ..sysid.model import model_device
from .controller import Controller, ControllerFactory


def _unsupported(name, why="is not ported to autompc_torch yet"):
    return NotPortedError(f"{name} {why}")


def _fixed_diag(cost, obsdim):
    """(qd, rd, fd, goal) host tuples of a diagonal QuadCost, else
    None."""
    if cost is None or not getattr(cost, "is_quad", False) \
            or getattr(cost, "_Q", None) is None:
        return None
    Q, R, F = (np.asarray(M.cpu().numpy()) for M in (cost._Q, cost._R, cost._F))
    if not all(np.allclose(M, np.diag(np.diag(M))) for M in (Q, R, F)):
        return None
    g = cost._goal
    goal = np.zeros(obsdim) if g is None else g.cpu().numpy()
    return (
        tuple(float(v) for v in np.diag(Q)),
        tuple(float(v) for v in np.diag(R)),
        tuple(float(v) for v in np.diag(F)),
        tuple(float(v) for v in goal),
    )


def make_batched_ilqr_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds=None,
    u_threshold: float = 1e-3,
    max_iter: int = 50,
    ls_max_iter: int = 10,
    ls_discount: float = 0.2,
    ls_cost_threshold: float = 0.3,
    backward: str = "pallas",
    feature_spec=None,
    analytic_jac: bool = False,
    relin: str = "auto",
    feature_mask=None,
    fuse_ls: bool = False,
    lanes_last: bool = False,
    return_pieces: bool = False,
    quad_cost_batch: bool = False,
    quad_goal=None,
    batch_params: bool = False,
    reg_matrix=None,
    reg_goal=None,
    pred_diff=None,
    mlp_ls=None,
    ls_wide: bool = False,
    jac_dtype: str = "f32",
    horizon_mask: bool = False,
):
    """Batch-native iLQR solve: ``solve(params, x0s (B, ds), uguess
    (B, H, dc)[, cost_params]) -> (converged (B,), xs (B, H+1, ds),
    us (B, H, dc), Ks (B, H, dc, ds), ks (B, H, dc))`` on the device of
    ``x0s``.

    ``batch_params=True`` (without ``mlp_ls``) gives every lane its own
    model: every tensor of ``params`` (a dict, maybe of lists of dicts)
    has a leading lane axis and ``pred_core``/``pred_diff`` map lane b of
    the state through lane b of the params. The params ride the carry,
    so compaction gathers their rows with the lanes. With a
    ``feature_spec`` ``params[coeffs_key]`` is (B, ds, F) and the feature
    kernels take it as the lanes-last (ds, n, B) plane of their per-lane
    instances (the lanes-last body carries that plane; the batch-major
    body transposes the carried rows each iteration).

    ``horizon_mask=True`` (with ``quad_cost_batch``, batch-major body,
    no ``feature_spec``, ``fuse_ls`` or ``mlp_ls``) solves every lane at
    its own effective horizon ``cost_params["heff"]`` (B,) inside the
    H-step program: steps t >= heff are inert — frozen dynamics
    (x_{t+1} = x_t, Jx = I, Ju = 0), zero stage cost and cost gradients
    (Cuu stays positive definite, so the Riccati step gives K = k = 0
    there), and the line search keeps the previous controls there
    (du = 0). A lane then solves as a dedicated solve at H = heff. The
    inline-expansion kernel takes a time-constant cost, so the backward
    pass takes the dense expansions (``backward="pallas"``: the general
    Riccati kernel).

    ``params`` is the model's parameter dict. ``backward="pallas"``
    keeps the JAX package's name for the kernel backward pass (here a
    CUDA kernel); ``"scan"`` (batch-major body only) is the plain
    recursion and ``"assoc"`` (batch-major body only) the associative
    scan (``ops/riccati.py::tvlqr_backward_assoc``; needs Cuu
    invertible). ``return_pieces=True`` also returns ``(make_carry0,
    cond, make_body)`` for callers that run the iteration themselves.

    ``quad_cost_batch=True`` gives every lane its own diagonal quadratic
    cost: the solve takes a fourth argument ``cost_params``, a dict of
    tensors ``Qdiag (B, obsdim)``, ``Rdiag (B, dc)``, ``Fdiag
    (B, obsdim)`` with the shared ``quad_goal`` (None: zeros); ``cost``
    is ignored and may be None. Semantics are the QuadCost closed forms
    (value ``(x-g)'Q(x-g)``, gradient ``2Q(x-g)``, hessian ``2Q``). The
    diagonals ride the carry (``c["cost"]``, lanes-last planes in the
    lanes-last body), so compaction moves them with their lanes.

    ``feature_spec = (library, coeffs_key)`` names the
    linear-in-features model behind ``pred_core`` (``x' =
    params[coeffs_key] @ library(z)``). The lanes-last body needs it;
    the batch-major body then takes its rollouts and Jacobians from the
    feature kernels at any dc (the lanes-last body and ``fuse_ls`` take
    dc = 1). ``feature_mask`` (bool sequence or tuple
    of active feature indices) restricts the kernels to the features
    whose coefficient columns are nonzero; the solve is then only
    correct for such coefficients.

    Batch-major body (``lanes_last=False``) without ``feature_spec``:
    ``pred_diff(params, x, u) -> (pred, Jx, Ju)`` is the model's
    closed-form Jacobian, batched over every leading axis
    (``MLP.pred_diff_core``); without one, ``jacfwd_pred_diff`` of
    ``pred_core``. ``mlp_ls`` — a dict with ``nonlin``
    (required), ``layout`` and ``precision`` — routes the line-search
    rollouts through the MLP kernel; ``params`` must then be an MLP's.
    ``precision`` is "highest" (true float32), "default" (one bfloat16
    pass where the TPU kernel's ``layout`` takes one: every product in
    "feat", all but the first layer's control rows in "mxu", none in
    "slab") or "bf16x3" (the three-pass split; ``layout="feat"`` only, as
    in the JAX package); ``layout``, ``block_b`` and ``interpret`` are
    otherwise choices of the TPU kernel and are ignored.

    ``relin``: "auto" and "pallas" (the latter needs a ``feature_spec``)
    relinearize a feature model with its kernel; "xla" with the JAX
    package's other formulation: the library's closed-form feature
    Jacobian with ``analytic_jac=True``, else ``pred_diff`` or
    ``torch.func.jacfwd``. The lanes-last body refuses "xla" and ignores
    ``analytic_jac``, as the JAX package's does.

    ``ls_wide`` (lanes-last body; the batch-major body ignores it, as the
    JAX package's does): an iteration whose batch is a multiple of 1024
    takes the split line search (``fused_line_search_wide``), any other
    the fused kernel; decided per call, so each compaction stage of the
    scheduled solver decides for its own size. ``jac_dtype="bf16"``
    (lanes-last body only) stores the Jacobian carry in bfloat16; the
    kernels compute in float32 and round at the write.
    """
    if relin not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown relin mode {relin!r}")
    if relin == "pallas" and feature_spec is None:
        raise ValueError(
            "relin='pallas' needs feature_spec (the feature kernels' relinearization; a "
            "model without one takes its pred_diff or the jacfwd relinearization)")
    # The feature kernels relinearize a feature model unless relin="xla"
    # takes the JAX package's other formulation (analytic_jac: the
    # library's closed-form Jacobian; else pred_diff or jacfwd).
    kernel_relin = feature_spec is not None and relin != "xla"
    if reg_matrix is not None and not quad_cost_batch:
        raise ValueError("reg_matrix requires quad_cost_batch=True")
    if reg_matrix is not None and lanes_last:
        raise ValueError(
            "lanes_last=True requires the diagonal-quadratic path: reg_matrix (the "
            "GaussReg term) makes the stage hessian dense, so it takes the batch-major "
            "body (lanes_last=False)"
        )
    if mlp_ls is not None and batch_params:
        raise ValueError(
            "mlp_ls (the MLP line-search kernel) does not support "
            "batch_params=True (per-lane model parameters); use the "
            "default line search for per-lane MLP batches"
        )
    if horizon_mask:
        if not quad_cost_batch:
            raise ValueError("horizon_mask requires quad_cost_batch=True")
        if lanes_last or fuse_ls or mlp_ls is not None:
            raise ValueError(
                "horizon_mask uses the plain line-search path; fuse_ls, "
                "lanes_last and mlp_ls are unsupported with it"
            )
        if feature_spec is not None or analytic_jac:
            raise ValueError(
                "horizon_mask does not compose with feature-library "
                "kernels (feature_spec, analytic_jac) yet; keep horizon in "
                "the bucket key for feature-spec solvers"
            )
    if jac_dtype not in ("f32", "bf16"):
        raise ValueError(f"jac_dtype must be f32/bf16, got {jac_dtype!r}")
    if jac_dtype == "bf16" and not lanes_last:
        raise ValueError(
            "jac_dtype='bf16' (half-stream jac carry; the B=131072 "
            "HBM fit) is implemented for the lanes-last packed-jac "
            "carry only"
        )
    if feature_mask is not None and feature_spec is None:
        raise ValueError("feature_mask needs feature_spec")
    if ubounds is not None:
        umin = np.asarray(ubounds[0], dtype=float).reshape(-1)
        umax = np.asarray(ubounds[1], dtype=float).reshape(-1)
    else:
        umin, umax = np.full(dc, -np.inf), np.full(dc, np.inf)
    alphas = tuple(ls_discount ** k for k in range(ls_max_iter))
    fixed_diag = None if quad_cost_batch else _fixed_diag(cost, obsdim)
    goal_q = tuple(
        float(v) for v in
        (np.zeros(obsdim) if quad_goal is None else np.asarray(quad_goal).reshape(-1))
    )
    if quad_cost_batch and len(goal_q) != obsdim:
        raise ValueError(f"quad_goal must have length obsdim = {obsdim}")
    if reg_matrix is not None:
        # The GaussReg term w_b (x - mu)' S (x - mu) of every lane's stage
        # cost: S and mu shared (float64 on the host), w per lane
        # (cost_params["regw"]).
        def host64(v):
            v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            return np.asarray(v, dtype=np.float64)

        reg_S = host64(reg_matrix)
        reg_mu = np.zeros(obsdim) if reg_goal is None else host64(reg_goal).reshape(-1)
        if reg_S.shape != (obsdim, obsdim) or reg_mu.shape != (obsdim,):
            raise ValueError(f"reg_matrix must be (obsdim, obsdim) and reg_goal (obsdim,), "
                             f"obsdim = {obsdim}")
    reg_on = {}

    def reg_terms(like):
        """(S, mu) on ``like``'s device and dtype, copied there once."""
        key = (like.device, like.dtype)
        if key not in reg_on:
            reg_on[key] = (like.new_tensor(reg_S), like.new_tensor(reg_mu))
        return reg_on[key]

    def feature_pieces():
        """(active terms, params -> active coefficient columns) of
        ``feature_spec`` under ``feature_mask``."""
        library, coeffs_key = feature_spec
        if feature_mask is not None:
            fm = tuple(feature_mask)
            if all(isinstance(b, (bool, np.bool_)) for b in fm):
                active_idx = tuple(i for i, b in enumerate(fm) if b)
            else:
                active_idx = tuple(int(i) for i in fm)
            if not active_idx:
                raise ValueError("feature_mask masks out every feature")
        else:
            active_idx = tuple(range(library.n_features))
        terms = tuple(library.terms[k] for k in active_idx)

        def active_coeffs(params):
            """The kernels' coefficients: (ds, n) shared, or with
            ``batch_params`` the lanes' (B, ds, F) as the lanes-last
            (ds, n, B) plane the per-lane instances read."""
            c = params[coeffs_key][..., list(active_idx)]
            return (c.permute(1, 2, 0) if batch_params else c).contiguous()

        return terms, active_coeffs

    def lane_costs(cost_params, like):
        """The per-lane diagonals of a ``quad_cost_batch`` solve as
        contiguous (B, .) tensors like ``like``; {} for a fixed cost."""
        if not quad_cost_batch:
            return {}
        if cost_params is None:
            raise ValueError("quad_cost_batch solve needs cost_params")
        out = {}
        for key, width in (("Qdiag", obsdim), ("Rdiag", dc), ("Fdiag", obsdim)):
            v = torch.as_tensor(cost_params[key], dtype=like.dtype, device=like.device)
            if tuple(v.shape) != (like.shape[0], width):
                raise ValueError(
                    f"cost_params[{key!r}]: shape {tuple(v.shape)}, expected "
                    f"{(like.shape[0], width)}"
                )
            out[key] = v.contiguous()
        if reg_matrix is not None:
            if "regw" not in cost_params:
                raise ValueError("reg_matrix solve needs cost_params['regw'] (B,)")
            w = torch.as_tensor(cost_params["regw"], dtype=like.dtype, device=like.device)
            if tuple(w.shape) != (like.shape[0],):
                raise ValueError(
                    f"cost_params['regw']: shape {tuple(w.shape)}, expected {(like.shape[0],)}")
            out["regw"] = w.contiguous()
        if horizon_mask:
            if "heff" not in cost_params:
                raise ValueError("horizon_mask solve needs cost_params['heff']")
            h = torch.as_tensor(cost_params["heff"], device=like.device).to(torch.int64)
            if tuple(h.shape) != (like.shape[0],):
                raise ValueError(
                    f"cost_params['heff']: shape {tuple(h.shape)}, expected {(like.shape[0],)}")
            out["heff"] = h.contiguous()
        return out

    def stage_mask(cp, like):
        """horizon_mask: (B, H) True at each lane's live steps t < heff."""
        return torch.arange(H, device=like.device)[None, :] < cp["heff"][:, None]

    def eval_obj(xs, us, cp):
        """Objective of trajectories xs (B, ..., H+1, ds), us
        (B, ..., H, dc) under the fixed cost (``cp`` empty) or the
        batch-major per-lane diagonals ``cp``."""
        if not quad_cost_batch:
            oc = cost.eval_obs_cost(xs[..., :H, :obsdim]).sum(-1)
            cc = cost.eval_ctrl_cost(us).sum(-1)
            return dt * (oc + cc) + cost.eval_term_obs_cost(xs[..., H, :obsdim])

        def w(a, n_tail):
            """(B, n) -> (B, 1, ..., 1, n) against ``n_tail`` trailing axes."""
            return a.reshape(a.shape[:1] + (1,) * (xs.ndim - 3 + n_tail - 1) + a.shape[1:])

        goal = xs.new_tensor(goal_q)
        dx = xs[..., :H, :obsdim] - goal
        qterm = dx * dx * w(cp["Qdiag"], 2)
        rterm = us * us * w(cp["Rdiag"], 2)
        if horizon_mask:
            sw = stage_mask(cp, xs).to(xs.dtype)
            sw = sw.reshape(sw.shape[:1] + (1,) * (xs.ndim - 3) + sw.shape[1:] + (1,))
            qterm, rterm = qterm * sw, rterm * sw
        oc = qterm.sum(dim=(-2, -1))
        cc = rterm.sum(dim=(-2, -1))
        if reg_matrix is not None:
            S, mu = reg_terms(xs)
            dxm = xs[..., :H, :obsdim] - mu
            gterm = dxm * (dxm @ S)
            if horizon_mask:
                gterm = gterm * sw
            oc = oc + w(cp["regw"][:, None], 1)[..., 0] * gterm.sum(dim=(-2, -1))
        dxt = xs[..., H, :obsdim] - goal
        return dt * (oc + cc) + (dxt * dxt * w(cp["Fdiag"], 1)).sum(-1)

    def cond(c):
        if c["itr"] >= max_iter:
            return False
        return bool((~c["converged"] & ~c["failed"]).any())

    def rollout(params, x0s, uguess):
        xs = [x0s]
        for t in range(H):
            xs.append(pred_core(params, xs[-1], uguess[:, t]))
        return torch.stack(xs, dim=1)                              # (B, H+1, ds)

    def lanes_last_pieces():
        if dc != 1:
            # The JAX package refuses this too (a ValueError, which the
            # tuner scores inf), with this message.
            lib_gts = (getattr(feature_spec[0], "grad_terms", None)
                       if feature_spec is not None else None)
            raise ValueError(
                "lanes_last=True requires the fully-fused dc=1 "
                "diagonal-quadratic path: fuse_ls=True, a feature_spec "
                "whose library has grad_terms, relin != 'xla', and a "
                "diagonal quadratic cost (fixed QuadCost or "
                "quad_cost_batch); got "
                f"quad_backward={quad_cost_batch or fixed_diag is not None}, "
                f"fuse_ls={fuse_ls}, relin_pallas={relin != 'xla'}, dc={dc}, "
                f"grad_terms={'yes' if lib_gts is not None else 'no'}, "
                f"mlp_ls={'set' if mlp_ls is not None else 'None'}"
            )
        if mlp_ls is not None:
            raise ValueError("mlp_ls needs the batch-major body (lanes_last=False)")
        if backward != "pallas":
            raise ValueError(f"lanes_last=True requires backward='pallas' (the lanes-last "
                             f"Riccati kernel), got backward={backward!r}")
        if relin == "xla":
            raise ValueError("lanes_last=True requires relin != 'xla': the fused line search "
                             "relinearizes in the kernel")
        diag_cost = quad_cost_batch or fixed_diag is not None
        if not (fuse_ls and feature_spec is not None and diag_cost):
            raise ValueError(
                "lanes_last=True requires the fully-fused dc=1 "
                "diagonal-quadratic path: fuse_ls=True, a feature_spec, and a "
                "diagonal quadratic cost (a fixed QuadCost or quad_cost_batch); "
                f"got fuse_ls={fuse_ls}, feature_spec="
                f"{'set' if feature_spec is not None else 'None'}, "
                f"diagonal_cost={diag_cost}"
                + ("" if feature_spec is not None else
                   " (a model without one takes the batch-major body, lanes_last=False, "
                   "and its jacfwd relinearization)")
            )
        terms, active_coeffs = feature_pieces()
        goal = goal_q if quad_cost_batch else fixed_diag[3]
        ulo, uhi = float(umin[0]), float(umax[0])
        # Per-lane cost planes: the lanes' own, or with batch_params a
        # fixed cost's diagonals broadcast to lanes-last planes (the
        # per-lane-coefficient instances of K3 take per-lane cost planes;
        # the JAX body broadcasts them for its backward pass the same way).
        lane_planes = quad_cost_batch or batch_params

        def fixed_planes(like):
            """A fixed diagonal cost as lanes-last planes qd/fd (obsdim, B),
            rd (1, B), one fill a row."""
            B = like.shape[0]
            return {k: like.new_tensor(v)[:, None].expand(len(v), B).contiguous()
                    for k, v in zip(("Qdiag", "Rdiag", "Fdiag"), fixed_diag[:3])}

        def make_carry0(params, x0s, uguess, cost_params=None):
            B = x0s.shape[0]
            cp = lane_costs(cost_params, x0s)
            xs0 = rollout(params, x0s, uguess)
            xsT = xs0.permute(1, 2, 0).contiguous()
            usT = uguess[:, :, 0].T.contiguous()
            coeffs = active_coeffs(params)
            jac = relin_jacobians(terms, xsT, usT, coeffs)
            if jac_dtype == "bf16":
                jac = jac.to(torch.bfloat16)
            return dict(
                x0s=x0s.T.contiguous(), xs=xsT, us=usT, jac=jac,
                # batch_params: the lanes' (ds, n, B) coefficient plane,
                # lanes-last, so compaction gathers it with the lanes.
                **({"params": coeffs} if batch_params else {}),
                # Lanes-last planes (obsdim, B) / (1, B): compaction
                # gathers them with the lanes.
                cost=({k: v.T.contiguous() for k, v in cp.items()} if quad_cost_batch
                      else fixed_planes(x0s) if lane_planes else {}),
                obj=eval_obj(xs0, uguess, cp),
                Ks=x0s.new_zeros((H, ds, B)), ks=x0s.new_zeros((H, B)),
                itr=0,
                converged=torch.zeros(B, dtype=torch.bool, device=x0s.device),
                failed=torch.zeros(B, dtype=torch.bool, device=x0s.device),
            )

        def make_body(params):
            fixed_coeffs = None if batch_params else active_coeffs(params)
            # Read once per solve, as the JAX package reads it once per
            # trace.
            wide_io = os.environ.get("AMPC_BQ_WIDE_IO", "cast")

            def body(c):
                coeffs = c["params"] if batch_params else fixed_coeffs
                active = ~c["converged"] & ~c["failed"]
                if lane_planes:
                    cp = c["cost"]
                    qd, rd, fd = cp["Qdiag"], cp["Rdiag"], cp["Fdiag"]
                else:
                    qd, rd, fd = fixed_diag[:3]
                KsT, ksT, lin_red, quad_red = backward_quad_ll(
                    c["jac"], c["xs"], c["us"], qd, rd, fd, goal, dt, obsdim,
                    carry=(active, c["Ks"], c["ks"]), wide_io=wide_io,
                )
                # Inactive lanes' ksT rows hold their OLD gains (the carry
                # select); their line-search outcome is discarded by the
                # same masks, so the stale ks_small is inert.
                ks_small = torch.sqrt((ksT * ksT).sum(0)) < u_threshold
                search = (
                    fused_line_search_wide
                    if ls_wide and active.shape[0] % WIDE_B == 0 else fused_line_search
                )
                xs, us, obj, _, failed_now, jac, du2 = search(
                    terms, c["x0s"], c["xs"], c["us"], KsT, ksT, coeffs, alphas,
                    ulo, uhi, qd, rd, fd, goal, dt, c["obj"], lin_red,
                    quad_red, ks_small, active, c["jac"],
                    ls_cost_threshold=ls_cost_threshold,
                )
                converged_now = (torch.sqrt(du2) < u_threshold) & ~failed_now
                return dict(
                    x0s=c["x0s"], cost=c["cost"],
                    **({"params": coeffs} if batch_params else {}),
                    xs=xs, us=us, jac=jac, obj=obj,
                    Ks=KsT, ks=ksT,
                    itr=c["itr"] + 1,
                    converged=c["converged"] | (converged_now & active),
                    failed=c["failed"] | (failed_now & active),
                )

            return body

        def finalize(out):
            """Lanes-last carry -> the batch-major (converged, xs, us, Ks,
            ks) contract."""
            return (
                out["converged"],
                out["xs"].permute(2, 0, 1),
                out["us"].T[:, :, None],
                out["Ks"].permute(2, 0, 1)[:, :, None, :],
                out["ks"].T[:, :, None],
            )

        return make_carry0, make_body, finalize

    def batch_major_pieces():
        # The fused line search (K3's batch-major entry) for a feature
        # model under a quadratic cost, as the JAX body fuses it; without
        # a feature_spec, or under a cost that is not quadratic, fuse_ls
        # is ignored there too. With dc > 1 the feature path is K1's
        # batch-major entry, the dense-expansion backward pass (K4) and
        # K3's multi-control instances, each control with its own bounds
        # (the rollout line search, K7, without fuse_ls). A fixed cost
        # whose Q, R or F is not diagonal takes K3's dense form (the TPU
        # kernel's per_lane_diag_cost=False) and the backward pass from
        # dense expansions.
        fused = fuse_ls and feature_spec is not None and (
            quad_cost_batch or getattr(cost, "is_quad", False))
        if fused and not quad_cost_batch and fixed_diag is None:
            dense_cost = tuple(
                np.asarray(M.detach().cpu().numpy(), dtype=np.float64)
                for M in (cost._Q, cost._R, cost._F)
            ) + (tuple(goal_q) if cost._goal is None
                 else tuple(float(v) for v in cost._goal.detach().cpu().numpy()),)
        else:
            dense_cost = None
        if backward not in ("pallas", "scan", "assoc"):
            raise _unsupported(f"backward={backward!r}")
        if mlp_ls is not None and feature_spec is None:
            if "nonlin" not in mlp_ls:
                raise ValueError("mlp_ls needs the activation name under 'nonlin'")
            check_precision(str(mlp_ls.get("precision", "highest")),
                            str(mlp_ls.get("layout", "slab")))
        # The inline-expansion kernel: dc = 1 and a diagonal cost, fixed
        # (its diagonals broadcast to the batch) or per lane.
        quad_backward = (
            backward == "pallas" and dc == 1 and not horizon_mask and reg_matrix is None
            and (quad_cost_batch or fixed_diag is not None)
        )
        if feature_spec is not None:
            terms, active_coeffs = feature_pieces()
        # Without the feature kernels' relinearization: a feature model's
        # closed-form Jacobian (analytic_jac), else the model's pred_diff,
        # else every point differentiated by forward-mode autodiff, one
        # model a lane with batch_params (JAX's default relinearization,
        # jax.jacfwd of pred_core).
        if kernel_relin:
            model_diff = pred_diff
        elif analytic_jac and feature_spec is not None:
            model_diff = feature_pred_diff(pred_core, feature_spec, ds, batch_params)
        else:
            model_diff = pred_diff or jacfwd_pred_diff(pred_core, ds, batch_params=batch_params)

        def relinearize(params, coeffs, xs, us):
            """Jx (B, H, ds, ds), Ju (B, H, ds, dc) at the first H points
            of xs (B, H+1, ds), us (B, H, dc); ``coeffs`` the feature
            kernels' coefficients (``active_coeffs``)."""
            if not kernel_relin:
                _, Jx, Ju = model_diff(params, xs[:, :H], us)
                return Jx, Ju
            return relin_jacobians_bm(terms, xs.contiguous(), us.contiguous(), coeffs)

        def lane_expansions(xs, us, cp):
            """``expansions`` for per-lane diagonal costs."""
            B = xs.shape[0]
            goal = xs.new_tensor(goal_q)
            Qd, Rd, Fd = cp["Qdiag"], cp["Rdiag"], cp["Fdiag"]
            oi = torch.arange(obsdim, device=xs.device)
            ci = torch.arange(dc, device=xs.device)
            cx = xs.new_zeros((B, H, ds))
            cx[:, :, :obsdim] = 2.0 * (xs[:, :H, :obsdim] - goal) * Qd[:, None, :] * dt
            Cxx = xs.new_zeros((B, H, ds, ds))
            Cxx[:, :, oi, oi] = (2.0 * Qd * dt)[:, None, :]
            Cuu = xs.new_zeros((B, H, dc, dc))
            Cuu[:, :, ci, ci] = (2.0 * Rd * dt)[:, None, :]
            cu = 2.0 * us * Rd[:, None, :] * dt
            Vn = xs.new_zeros((B, ds, ds))
            Vn[:, oi, oi] = 2.0 * Fd
            vn = xs.new_zeros((B, ds))
            vn[:, :obsdim] = 2.0 * Fd * (xs[:, H, :obsdim] - goal)
            if reg_matrix is not None:
                # The dense GaussReg term: 2 dt w S (x - mu) and 2 dt w S.
                S, mu = reg_terms(xs)
                w2 = 2.0 * dt * cp["regw"]
                cx[:, :, :obsdim] += w2[:, None, None] * ((xs[:, :H, :obsdim] - mu) @ S)
                Cxx[:, :, :obsdim, :obsdim] += w2[:, None, None, None] * S
            if horizon_mask:
                # Inert steps: no state cost and no cost gradients; Cuu
                # stays positive definite (with Ju = 0 and cu = 0 the
                # Riccati step gives K = k = 0 there).
                sw = stage_mask(cp, xs).to(xs.dtype)
                cx, Cxx, cu = cx * sw[..., None], Cxx * sw[..., None, None], cu * sw[..., None]
            return Cxx, Cuu, cx, cu, Vn, vn

        def expansions(xs, us, cp, quad_hess):
            """dt-scaled stage expansions Cxx (B, H, ds, ds), Cuu
            (B, H, dc, dc), cx (B, H, ds), cu (B, H, dc) and the terminal
            Vn (B, ds, ds), vn (B, ds). ``quad_hess`` caches (Cxx, Cuu)
            of a fixed quadratic cost by batch size for one solve."""
            if quad_cost_batch:
                return lane_expansions(xs, us, cp)
            B = xs.shape[0]
            _, qx, Qh = cost.eval_obs_cost_hess(xs[:, :H, :obsdim])
            _, ru, Rh = cost.eval_ctrl_cost_hess(us)
            # A quadratic cost's hessians do not depend on the trajectory:
            # build them once for each batch size the solve runs at.
            if not cost.is_quad or B not in quad_hess:
                Cxx = xs.new_zeros((B, H, ds, ds))
                Cxx[:, :, :obsdim, :obsdim] = Qh * dt
                Cuu = (Rh * dt).expand(B, H, dc, dc).contiguous()
                quad_hess[B] = (Cxx, Cuu)
            Cxx, Cuu = quad_hess[B]
            cx = xs.new_zeros((B, H, ds))
            cx[:, :, :obsdim] = qx * dt
            _, tg, th = cost.eval_term_obs_cost_hess(xs[:, H, :obsdim])
            Vn = xs.new_zeros((B, ds, ds))
            Vn[:, :obsdim, :obsdim] = th
            vn = xs.new_zeros((B, ds))
            vn[:, :obsdim] = tg
            return Cxx, Cuu, cx, (ru * dt).contiguous(), Vn, vn

        def line_search_rollouts(params, x0s, xs, us, Ks, ks, cp):
            """Closed-loop rollouts of every step size through
            ``pred_core``: (B, L, H+1, ds), (B, L, H, dc). With the
            horizon mask an inert step keeps its control and state."""
            B, L = x0s.shape[0], len(alphas)
            a = x0s.new_tensor(alphas)[None, :, None]
            lo, hi = x0s.new_tensor(umin), x0s.new_tensor(umax)
            live = stage_mask(cp, x0s)[:, :, None, None] if horizon_mask else None
            x = x0s[:, None, :].expand(B, L, ds)
            ls_xs, ls_us = [x], []
            for t in range(H):
                ubar = us[:, t][:, None, :]
                fb = (x - xs[:, t][:, None, :]) @ Ks[:, t].transpose(1, 2)
                u = a * ks[:, t][:, None, :] + ubar + fb
                u = torch.minimum(torch.maximum(u, lo), hi)
                if live is None:
                    x = pred_core(params, x, u)
                else:
                    u = torch.where(live[:, t], u, ubar)
                    x = torch.where(live[:, t], pred_core(params, x, u), x)
                ls_xs.append(x)
                ls_us.append(u)
            return torch.stack(ls_xs, dim=2), torch.stack(ls_us, dim=2)

        def freeze(live, Jx, Ju):
            """Jacobians of the frozen dynamics, (I, 0), where ``live``
            is False (``live`` broadcasts against their leading axes)."""
            eye = torch.eye(ds, dtype=Jx.dtype, device=Jx.device)
            m = live[..., None, None]
            return torch.where(m, Jx, eye), torch.where(m, Ju, torch.zeros_like(Ju))

        def make_carry0(params, x0s, uguess, cost_params=None):
            B = x0s.shape[0]
            cp = lane_costs(cost_params, x0s)
            if kernel_relin or (
                    getattr(model_diff, "all_points", False) and not horizon_mask):
                # The Jacobians at every point in one call after the
                # rollout: the feature kernel, or an autodiff or
                # closed-form-feature pred_diff, whose cost is a call,
                # not a point.
                xs0 = rollout(params, x0s, uguess)
                Jx0, Ju0 = relinearize(
                    params, active_coeffs(params) if kernel_relin else None, xs0, uguess)
            else:
                live = stage_mask(cp, x0s) if horizon_mask else None
                x, xs, Jx, Ju = x0s, [x0s], [], []
                for t in range(H):
                    xn, jx, ju = model_diff(params, x, uguess[:, t])
                    if live is not None:
                        # Inert steps: the state freezes, linearized as (I, 0).
                        xn = torch.where(live[:, t, None], xn, x)
                        jx, ju = freeze(live[:, t], jx, ju)
                    x = xn
                    xs.append(x)
                    Jx.append(jx)
                    Ju.append(ju)
                xs0 = torch.stack(xs, dim=1)
                Jx0, Ju0 = torch.stack(Jx, dim=1), torch.stack(Ju, dim=1)
            return dict(
                x0s=x0s.contiguous(), cost=cp, xs=xs0, us=uguess.contiguous(),
                **({"params": params} if batch_params else {}),
                Jx=Jx0, Ju=Ju0,
                obj=eval_obj(xs0, uguess, cp),
                Ks=x0s.new_zeros((B, H, dc, ds)), ks=x0s.new_zeros((B, H, dc)),
                itr=0,
                converged=torch.zeros(B, dtype=torch.bool, device=x0s.device),
                failed=torch.zeros(B, dtype=torch.bool, device=x0s.device),
            )

        def make_body(params):
            layers = (
                fold_mlp_params(params)
                if mlp_ls is not None and feature_spec is None else None
            )
            fixed_coeffs = (active_coeffs(params)
                            if feature_spec is not None and not batch_params else None)
            quad_hess, fixed_rows = {}, {}

            def diag_rows(c):
                """The lane diagonals the inline-expansion kernel takes:
                the carry's, or the fixed cost's broadcast to (B, .),
                built once for each batch size."""
                if quad_cost_batch:
                    cp = c["cost"]
                    return cp["Qdiag"], cp["Rdiag"], cp["Fdiag"], goal_q
                B = c["x0s"].shape[0]
                if B not in fixed_rows:
                    fixed_rows[B] = tuple(
                        c["x0s"].new_tensor(v).expand(B, len(v)).contiguous()
                        for v in fixed_diag[:3]
                    )
                return (*fixed_rows[B], fixed_diag[3])

            def fused_search(c, coeffs, Ks, ks, lin_red, quad_red, ks_small):
                """K3's batch-major entry on the carry: the chosen rollout,
                its objective and flags, its Jacobians (None with
                relin="xla") and du2, every lane (the body applies the
                carry select)."""
                if dense_cost is not None:
                    Qd, Rd, Fd, goal = dense_cost
                else:
                    Qd, Rd, Fd, goal = diag_rows(c)
                    Qd, Rd, Fd = Qd.T.contiguous(), Rd.T.contiguous(), Fd.T.contiguous()
                reg = None
                if reg_matrix is not None:
                    reg = (reg_S, reg_mu, c["cost"]["regw"])
                # dc = 1: one pair of bounds; else each control's own.
                lo, hi = (float(umin[0]), float(umax[0])) if dc == 1 else (umin, umax)
                return fused_line_search_bm(
                    terms, c["x0s"], c["xs"], c["us"], Ks.contiguous(), ks.contiguous(),
                    coeffs, alphas, lo, hi, Qd, Rd, Fd, goal, dt,
                    c["obj"], lin_red, quad_red, ks_small, reg=reg,
                    ls_cost_threshold=ls_cost_threshold, jac=kernel_relin,
                )

            def body(c):
                x0s, xs, us, cp = c["x0s"], c["xs"], c["us"], c["cost"]
                # Per-lane params ride the carry, so compaction gathers
                # their rows with the trajectories.
                pp = c["params"] if batch_params else params
                # The lanes' (ds, n, B) coefficient plane, from the rows
                # compaction left in the carry.
                coeffs = active_coeffs(pp) if feature_spec is not None and batch_params \
                    else fixed_coeffs
                B = x0s.shape[0]
                active = ~c["converged"] & ~c["failed"]
                if quad_backward:
                    Qd, Rd, Fd, goal = diag_rows(c)
                    Ks, ks, lin_red, quad_red = backward_quad(
                        c["Jx"], c["Ju"], xs, us, Qd, Rd, Fd, goal, dt, obsdim
                    )
                else:
                    run_backward = {"pallas": riccati_general, "scan": tvlqr_backward_scan,
                                    "assoc": tvlqr_backward_assoc}[backward]
                    Ks, ks, lin_red, quad_red = run_backward(
                        c["Jx"], c["Ju"], *expansions(xs, us, cp, quad_hess)
                    )
                ks_small = torch.sqrt((ks * ks).sum(dim=(1, 2))) < u_threshold

                if fused:
                    new_xs, new_us, new_obj, ls_success, failed_now, Jx_lin, Ju_lin, du2 = \
                        fused_search(c, coeffs, Ks, ks, lin_red, quad_red, ks_small)
                    if not kernel_relin:
                        Jx_lin, Ju_lin = relinearize(pp, coeffs, new_xs, new_us)
                    return select(c, active, new_xs, new_us, new_obj, ls_success, failed_now,
                                  Jx_lin, Ju_lin, torch.sqrt(du2), Ks, ks)
                if feature_spec is not None:
                    ls_xs, ls_us = sindy_line_search(
                        terms, x0s, xs, us, Ks, ks, coeffs, alphas, umin, umax
                    )
                elif layers is not None:
                    ls_xs, ls_us = mlp_line_search(
                        layers, mlp_ls["nonlin"], x0s, xs, us, Ks, ks, alphas,
                        umin, umax, layout=str(mlp_ls.get("layout", "slab")),
                        precision=str(mlp_ls.get("precision", "highest")),
                    )
                else:
                    ls_xs, ls_us = line_search_rollouts(pp, x0s, xs, us, Ks, ks, cp)
                new_objs = eval_obj(ls_xs, ls_us, cp)              # (B, L)
                a = new_objs.new_tensor(alphas)[None, :]
                expect = a * lin_red[:, None] + (a ** 2) * quad_red[:, None] / 2
                denom = -expect
                ratios = torch.where(
                    denom.abs() > 1e-30,
                    (c["obj"][:, None] - new_objs) / denom,
                    torch.full_like(denom, -float("inf")),
                )
                accept = ratios > ls_cost_threshold
                any_acc = accept.any(dim=1)
                # argmax of 0/1 returns the FIRST accepted step size.
                first_acc = accept.to(torch.int8).argmax(dim=1)
                zero = torch.zeros_like(first_acc)
                chosen = torch.where(
                    ks_small, zero,
                    torch.where(any_acc, first_acc, new_objs.argmin(dim=1)),
                )

                def take(arr, idx):
                    return arr[torch.arange(B, device=arr.device), idx]

                best_obj = take(new_objs, chosen)
                ls_success = (best_obj < c["obj"]) | ks_small
                idx_last = torch.where(
                    ks_small, zero,
                    torch.where(any_acc, first_acc,
                                torch.full_like(first_acc, ls_max_iter - 1)),
                )
                last_obj = take(new_objs, idx_last)
                failed_now = ~ls_success & (last_obj > c["obj"] + 1e-3)
                sel = torch.where(ls_success, chosen, idx_last)
                new_xs, new_us = take(ls_xs, sel), take(ls_us, sel)
                new_obj = torch.where(ls_success, best_obj, last_obj)

                Jx_lin, Ju_lin = relinearize(pp, coeffs, new_xs, new_us)
                if horizon_mask:
                    Jx_lin, Ju_lin = freeze(stage_mask(cp, x0s), Jx_lin, Ju_lin)
                du_norm = torch.sqrt(((new_us - us) ** 2).sum(dim=(1, 2)))
                return select(c, active, new_xs, new_us, new_obj, ls_success, failed_now,
                              Jx_lin, Ju_lin, du_norm, Ks, ks)

            def select(c, active, new_xs, new_us, new_obj, ls_success, failed_now, Jx_lin,
                       Ju_lin, du_norm, Ks, ks):
                """The next carry: the new trajectory where the lane is
                active and did not fail, its Jacobians where the search
                also succeeded, the new gains where active."""
                succ = ls_success[:, None, None, None]
                Jx_new = torch.where(succ, Jx_lin, c["Jx"])
                Ju_new = torch.where(succ, Ju_lin, c["Ju"])
                converged_now = (du_norm < u_threshold) & ~failed_now

                def upd(new, old, keep):
                    m = keep.reshape((-1,) + (1,) * (new.ndim - 1))
                    return torch.where(m, new, old)

                moved = active & ~failed_now
                return dict(
                    x0s=c["x0s"], cost=c["cost"],
                    **({"params": c["params"]} if batch_params else {}),
                    xs=upd(new_xs, c["xs"], moved), us=upd(new_us, c["us"], moved),
                    Jx=upd(Jx_new, c["Jx"], moved), Ju=upd(Ju_new, c["Ju"], moved),
                    obj=upd(new_obj, c["obj"], moved),
                    Ks=upd(Ks, c["Ks"], active), ks=upd(ks, c["ks"], active),
                    itr=c["itr"] + 1,
                    converged=c["converged"] | (converged_now & active),
                    failed=c["failed"] | (failed_now & active),
                )

            return body

        def finalize(out):
            return out["converged"], out["xs"], out["us"], out["Ks"], out["ks"]

        return make_carry0, make_body, finalize

    make_carry0, make_body, finalize = (
        lanes_last_pieces() if lanes_last else batch_major_pieces()
    )

    def solve(params, x0s, uguess, cost_params=None):
        carry = make_carry0(params, x0s, uguess, cost_params)
        body = make_body(params)
        while cond(carry):
            carry = body(carry)
        return finalize(carry)

    solve._finalize = finalize
    if return_pieces:
        return solve, make_carry0, cond, make_body
    return solve


def _batch_gather(tree, idx, B, lanes_last=False):
    """Gather lanes ``idx`` from every batch-axis tensor of the carry,
    the per-lane cost dict ``c["cost"]`` and the per-lane params
    ``c["params"]`` included: lanes-last tensors (ndim >= 2, last dim B;
    checked first) on their last axis, (B,) and batch-leading tensors on
    axis 0; everything else (``itr``) passes through."""

    def g(a):
        if isinstance(a, dict):
            return {k: g(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(g(v) for v in a)
        if not isinstance(a, torch.Tensor):
            return a
        if lanes_last and a.ndim >= 2 and a.shape[-1] == B:
            return a[..., idx]
        if a.ndim >= 1 and a.shape[0] == B:
            return a[idx]
        return a

    return g(tree)


def _batch_scatter(full, front, idx, B, lanes_last=False):
    """Inverse of ``_batch_gather``: write ``front``'s lanes back at
    ``idx``. Updates ``full``'s tensors in place (the full carry is dead
    after the scatter, and this saves a copy of every carry array);
    non-batch leaves take the front's value. The per-lane cost
    ``c["cost"]`` and params ``c["params"]`` never change during a
    solve, so the full carry keeps its own and nothing is written into
    them."""

    def s(f, fr):
        if isinstance(f, dict):
            return {k: f[k] if k in ("cost", "params") else s(f[k], fr[k]) for k in f}
        if not isinstance(f, torch.Tensor):
            return fr
        if lanes_last and f.ndim >= 2 and f.shape[-1] == B:
            f[..., idx] = fr
        elif f.ndim >= 1 and f.shape[0] == B:
            f[idx] = fr
        else:
            return fr
        return f

    return s(full, front)


def make_staged_ilqr_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds=None,
    chunk_iters: int = 5,
    min_bucket: int = 1024,
    max_iter: int = 50,
    **kwargs,
):
    """Batched iLQR with host-staged converged-lane compaction.

    Same contract as ``make_batched_ilqr_solver`` (batch-major body
    only), per-lane results those of the uncompacted solve. The
    iteration runs in chunks of ``chunk_iters``; between chunks the host
    reads the finished mask, writes the finished lanes into the outputs
    and gathers the survivors into the smallest power of two at least
    their count (and at least ``min_bucket``, at most the current size),
    padded with finished lanes, which the masks keep inert. Unlike
    ``make_scheduled_ilqr_solver`` the buckets follow the measured
    survivors rather than a fixed schedule.
    """
    if kwargs.get("lanes_last"):
        raise ValueError(
            "lanes_last is not supported by the staged driver; use "
            "make_scheduled_ilqr_solver"
        )
    _, make_carry0, cond, make_body = make_batched_ilqr_solver(
        pred_core, cost, H=H, ds=ds, dc=dc, obsdim=obsdim, dt=dt,
        ubounds=ubounds, max_iter=max_iter, return_pieces=True, **kwargs,
    )

    def bucket(n_active, cur):
        b = 1 << max(0, int(np.ceil(np.log2(max(1, n_active)))))
        return min(cur, max(b, min_bucket))

    def solve(params, x0s, uguess, cost_params=None):
        B = x0s.shape[0]
        body = make_body(params)
        carry = make_carry0(params, x0s, uguess, cost_params)
        idx = np.arange(B)          # original lane of each slot; -1: padding
        out = dict(
            converged=torch.zeros(B, dtype=torch.bool, device=x0s.device),
            xs=x0s.new_zeros((B, H + 1, ds)), us=x0s.new_zeros((B, H, dc)),
            Ks=x0s.new_zeros((B, H, dc, ds)), ks=x0s.new_zeros((B, H, dc)),
        )

        def flush(slots):
            dst = torch.as_tensor(idx[slots], device=x0s.device)
            src = torch.as_tensor(slots, device=x0s.device)
            for key in out:
                out[key][dst] = carry[key][src]

        while True:
            n = 0
            while n < chunk_iters and cond(carry):
                carry = body(carry)
                n += 1
            done = (carry["converged"] | carry["failed"]).cpu().numpy()
            real = idx >= 0
            active = real & ~done
            n_active = int(active.sum())
            if n_active == 0 or carry["itr"] >= max_iter:
                flush(np.flatnonzero(real))
                break
            cur = len(idx)
            nb = bucket(n_active, cur)
            if nb < cur:
                flush(np.flatnonzero(real & done))
                act = np.flatnonzero(active)
                pad = np.flatnonzero(done)[: nb - n_active]
                sel = np.concatenate([act, pad])
                carry = _batch_gather(carry, torch.as_tensor(sel, device=x0s.device), cur)
                idx = np.concatenate([idx[act], np.full(nb - n_active, -1)])
        return out["converged"], out["xs"], out["us"], out["Ks"], out["ks"]

    return solve


def parse_schedule(s):
    """Parse ``"cut:frac,cut:frac,..."`` (e.g. ``"20:0.5,38:0.25"``) into
    ``((cut_iter, size_frac), ...)``. Empty/None -> None."""
    if not s:
        return None
    out = []
    for chunk in s.split(","):
        cut, frac = chunk.split(":")
        frac = float(frac)
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"schedule size_frac must be in (0, 1], got {frac}")
        out.append((int(cut), frac))
    return tuple(out)


def make_scheduled_ilqr_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds=None,
    schedule=((20, 0.5), (38, 0.25)),
    max_iter: int = 50,
    **kwargs,
):
    """Batched iLQR with converged-lane compaction at static cut points.

    Same contract as ``make_batched_ilqr_solver``. ``schedule`` is a
    list of ``(cut_iter, size_frac)`` with ``size_frac`` relative to the
    ORIGINAL batch: at each cut the host reads the active count; if the
    active lanes fit, they are stably moved to the front and the front
    ``round(size_frac * B)`` lanes continue alone (every kernel shrinks),
    to be scattered back at the end. If they do not fit, the solve stays
    at its size and the later cuts stay alive — the schedule is a
    performance hint, never a correctness bound. Per-lane results equal
    the uncompacted solver's.
    """
    solve0, make_carry0, cond, make_body = make_batched_ilqr_solver(
        pred_core, cost, H=H, ds=ds, dc=dc, obsdim=obsdim, dt=dt,
        ubounds=ubounds, max_iter=max_iter, return_pieces=True, **kwargs,
    )
    ll = bool(kwargs.get("lanes_last"))

    def solve(params, x0s, uguess, cost_params=None):
        B = x0s.shape[0]
        body = make_body(params)

        def run_until(carry, upto):
            while carry["itr"] < upto and cond(carry):
                carry = body(carry)
            return carry

        def recurse(carry, sched):
            B_cur = carry["converged"].shape[0]
            if not sched:
                return run_until(carry, max_iter)
            cut, frac = sched[0]
            B_next = max(1, int(round(B * frac)))
            if B_next >= B_cur:
                return recurse(carry, sched[1:])
            carry = run_until(carry, cut)
            done = carry["converged"] | carry["failed"]
            if int((~done).sum()) > B_next:
                return recurse(carry, sched[1:])
            perm = torch.argsort(done.to(torch.int8), stable=True)
            front_idx = perm[:B_next]
            front = _batch_gather(carry, front_idx, B_cur, lanes_last=ll)
            front = recurse(front, sched[1:])
            return _batch_scatter(carry, front, front_idx, B_cur, lanes_last=ll)

        out = recurse(make_carry0(params, x0s, uguess, cost_params), tuple(schedule))
        return solve0._finalize(out)

    return solve


def jacfwd_pred_diff(pred_core, ds, batch_params=False):
    """``pred_diff(params, x (..., ds), u (..., dc)) -> (pred, Jx, Ju)``
    of any model step by forward-mode autodiff (``torch.func.jacfwd``,
    the JAX package's ``jax.jacfwd``), one point at a time under
    ``torch.func.vmap`` over the flattened leading axes: Jx
    (..., ds, ds), Ju (..., ds, dc). With ``batch_params`` every tensor
    of ``params`` has a leading lane axis B, x and u lead with it too,
    and lane b's points go through lane b's params (``pred_core`` then
    sees one lane's params and one point)."""
    from torch.func import jacfwd, vmap

    def point(params, x, u):
        def f(z):
            y = pred_core(params, z[:ds], z[ds:])
            return y, y

        J, y = jacfwd(f, has_aux=True)(torch.cat([x, u]))
        return y, J[:, :ds], J[:, ds:]

    def points(params, x, u):
        return vmap(point, in_dims=(None, 0, 0))(params, x, u)

    def pred_diff(params, x, u):
        lead = x.shape[:-1]
        if batch_params:
            B = x.shape[0]
            y, Jx, Ju = vmap(points, in_dims=(0, 0, 0))(
                params, x.reshape(B, -1, x.shape[-1]), u.reshape(B, -1, u.shape[-1]))
        else:
            y, Jx, Ju = points(params, x.reshape(-1, x.shape[-1]),
                               u.reshape(-1, u.shape[-1]))
        # Contiguous, as the kernels take them (Jx, Ju are column slices).
        return (y.reshape(lead + y.shape[-1:]), Jx.reshape(lead + Jx.shape[-2:]).contiguous(),
                Ju.reshape(lead + Ju.shape[-2:]).contiguous())

    # A call costs the same for one point and for a horizon's: the solver
    # rolls out with pred_core and then differentiates every point at once.
    pred_diff.all_points = True
    return pred_diff


def feature_pred_diff(pred_core, feature_spec, ds, batch_params=False):
    """``pred_diff(params, x (..., ds), u (..., dc)) -> (pred, Jx, Ju)``
    of a linear-in-features model from the library's closed-form feature
    Jacobian (``FeatureLibrary.jacobian``): ``coeffs @ dTheta/dz``, one
    evaluation of the partials where ``jacfwd`` pushes a tangent a
    input (the JAX solver's ``analytic_jac``). ``feature_spec = (library,
    coeffs_key)``; with ``batch_params`` ``params[coeffs_key]`` is
    (B, ds, F) and x, u lead with the lane axis B."""
    library, key = feature_spec

    def pred_diff(params, x, u):
        Jth = library.jacobian(torch.cat([x, u], dim=-1))          # (..., F, d)
        C = params[key]
        if batch_params:
            B = x.shape[0]
            jac = torch.einsum("bnfd,bsf->bnsd", Jth.reshape((B, -1) + Jth.shape[-2:]), C)
            jac = jac.reshape(x.shape[:-1] + jac.shape[-2:])
        else:
            jac = torch.einsum("...fd,sf->...sd", Jth, C)
        return (pred_core(params, x, u), jac[..., :ds].contiguous(),
                jac[..., ds:].contiguous())

    pred_diff.all_points = True
    return pred_diff


def make_ilqr_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds=None,
    u_threshold: float = 1e-3,
    max_iter: int = 50,
    ls_max_iter: int = 10,
    ls_discount: float = 0.2,
    ls_cost_threshold: float = 0.3,
    unroll: int = 8,
    backward: str = "scan",
    pred_diff=None,
):
    """The single-lane iLQR solve: ``solve(params, x0 (ds,), uguess
    (H, dc)) -> (converged, xs (H+1, ds), us (H, dc), Ks (H, dc, ds),
    ks (H, dc))`` on the device of ``x0``.

    The JAX package's single-lane solver is the batch-major iteration of
    ``make_batched_ilqr_solver`` for one lane, and so is this one: that
    body run at B = 1 with the plain Riccati recursion
    (``ops/riccati.py::tvlqr_backward_scan``), all ``ls_max_iter`` step
    sizes rolled out together through ``pred_core``, and the reference's
    rules (Jacobians relinearized only after a successful line search; a
    failed search that worsens the objective by at most 1e-3 is still
    taken). ``pred_diff`` is the model's closed-form Jacobian, batched
    over every leading axis; without one the model is differentiated by
    ``jacfwd_pred_diff``. ``backward``: "scan" (the sequential Riccati
    recursion) or "assoc" (``ops/riccati.py::tvlqr_backward_assoc``,
    O(log H) depth); any other value takes "scan", as in the JAX
    package. ``unroll`` is a JAX scan option and is ignored.
    """
    del unroll
    solve_b = make_batched_ilqr_solver(
        pred_core, cost, H=H, ds=ds, dc=dc, obsdim=obsdim, dt=dt, ubounds=ubounds,
        u_threshold=u_threshold, max_iter=max_iter, ls_max_iter=ls_max_iter,
        ls_discount=ls_discount, ls_cost_threshold=ls_cost_threshold,
        backward="assoc" if backward == "assoc" else "scan",
        pred_diff=pred_diff or jacfwd_pred_diff(pred_core, ds),
    )

    def solve(params, x0, uguess):
        return tuple(a[0] for a in solve_b(params, x0[None], uguess[None]))

    return solve


class IterativeLQRFactory(ControllerFactory):
    """Hyperparameters:

    - *horizon* (int, 5..25, default 20): MPC optimization horizon.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Controller = IterativeLQR
        self.name = "IterativeLQR"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("horizon", lower=5, upper=25, default_value=20)
        )
        return cs


class IterativeLQR(Controller):
    """Receding-horizon iLQR on ``model``: each step solves from a zero
    control guess (``make_ilqr_solver``) and applies the first control
    with its feedback. ``reuse_feedback`` > 0 replays that many steps of
    the cached solution and gains before solving again (at most the
    horizon). ``mode`` None clips the controls to the bounds; the
    reference names "barrier" and "auglag" but implements neither.
    Runs on the device of the model's parameters."""

    def __init__(
        self,
        system,
        task,
        model,
        horizon,
        reuse_feedback=-1,
        ubounds=None,
        mode=None,
        verbose=False,
    ):
        super().__init__(system, task, model)
        self.horizon = int(horizon)
        if reuse_feedback is None or reuse_feedback <= 0:
            self.reuse_feedback = 0
        else:
            self.reuse_feedback = min(int(reuse_feedback), self.horizon)
        if mode not in (None, "barrier", "auglag"):
            raise ValueError("mode has to be None/barrier/auglag")
        if ubounds is None and task.are_ctrl_bounded():
            bounds = task.get_ctrl_bounds()
            ubounds = (bounds[:, 0], bounds[:, 1])
        self.ubounds = ubounds
        self._model_params = model.params
        self.device = model_device(model)
        self._solve = make_ilqr_solver(
            model.pred_core,
            task.get_cost(),
            H=self.horizon,
            ds=model.state_dim,
            dc=system.ctrl_dim,
            obsdim=system.obs_dim,
            dt=system.dt,
            ubounds=ubounds,
            pred_diff=getattr(model, "pred_diff_core", None),
        )

    @property
    def state_dim(self):
        return self.model.state_dim + self.system.ctrl_dim

    @staticmethod
    def is_compatible(system, task, model):
        return (
            task.get_cost().is_quad
            and not task.are_obs_bounded()
            and not task.eq_cons_present()
            and not task.ineq_cons_present()
        )

    def traj_to_state(self, traj):
        """The controller state: the model's state, the last control, the
        cached solution and gains, and (host integers) the steps taken
        from the cache and whether the next step must solve."""
        H, dc, ds = self.horizon, self.system.ctrl_dim, self.model.state_dim
        z = traj.obs.new_zeros
        return dict(
            model_state=self.model.traj_to_state(traj),
            last_u=traj[-1].ctrl,
            xs=z((H + 1, ds)), us=z((H, dc)), Ks=z((H, dc, ds)), ks=z((H, dc)),
            step_count=0,
            need_recompute=True,
        )

    def compute_ilqr(self, state, uguess, **kwargs):
        """One solve from ``state`` with the control guess ``uguess``
        (H, dc): ``(converged, states (H+1, ds), ctrls (H, dc), Ks, ks)``,
        the reference's one-shot API."""
        del kwargs
        return self._solve(self._model_params, torch.as_tensor(state, device=self.device),
                           torch.as_tensor(uguess, device=self.device))

    def step(self, cstate, new_obs):
        params = self._model_params
        state = self.model.update_state_core(
            params, cstate["model_state"], cstate["last_u"], new_obs
        )
        if self.reuse_feedback == 0 or cstate["need_recompute"]:
            _, xs, us, Ks, ks = self._solve(
                params, state, state.new_zeros((self.horizon, self.system.ctrl_dim)))
            step_count = 0
        else:
            xs, us, Ks, ks = (cstate[k] for k in ("xs", "us", "Ks", "ks"))
            step_count = cstate["step_count"]
        u = us[step_count] + Ks[step_count] @ (state - xs[step_count])
        return u, dict(
            model_state=state, last_u=u, xs=xs, us=us, Ks=Ks, ks=ks,
            step_count=step_count + 1,
            # Solve again when the cached gains are spent.
            need_recompute=step_count + 1 >= self.reuse_feedback,
        )
