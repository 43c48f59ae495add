"""Hold the per-lane-coefficient instances of K7 (``sindy_line_search``)
and K3 (``fused_line_search``) against their plain twins on random
inputs over the whole 1,686-term SINDy library of cartpole (polynomials
to degree 8 with cross terms, trig to frequency 8 with interaction), and
say where either side is not finite.

The inputs are those of a first check of these instances: a model near
the identity (coefficients 0.1 / sqrt(F) * N(0, 1), plus the identity on
the linear terms) with a per-lane perturbation 0.01 / sqrt(F) * N(0, 1),
states and controls U(-1, 1), gains 0.3 * N(0, 1), 10 step sizes 0.2^l,
controls clipped to [-2, 2], at B=1,024 and B=37 (H=10 and 7), drawn
from numpy's generator seeded with F + B. Such a model is not bounded:
a rollout that leaves [-1, 1] meets terms of degree 8, so a lane can
overflow float32 in a few steps, in the kernel and in the twin alike.
For each shape the script prints, per kernel, the rollouts (K7) or
lanes (K3) that are finite in the kernel and in the twin, and those not
finite in the kernel only or in the twin only, the largest magnitude the twin's states reach
on the rollouts it keeps finite, and the relative error on the rollouts
finite in both.

    python3 tools/torch_lane_random_check.py

Needs one card. Prints the card's name and power limit first; exits 1
if a rollout or lane is not finite in the kernel where the twin's is
finite, or where both are finite and they differ by more than 1e-4."""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autompc_torch.ops import cuda_linesearch as K3  # noqa: E402
from autompc_torch.sysid.basis import FeatureLibrary  # noqa: E402

LIB = dict(poly_basis=True, poly_degree=8, poly_cross_terms=True, trig_basis=True,
           trig_freq=8, trig_interaction=True)
SHAPES = ((1024, 10), (37, 7))
TOL = 1e-4


def rel_err(a, b):
    if a.numel() == 0:
        return 0.0
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def counts(kf, pf):
    """Finite in the kernel (kf), in the twin (pf), and not finite in one
    of them only."""
    return dict(finite_kernel=int(kf.sum()), finite_twin=int(pf.sum()),
                not_finite_kernel_only=int((~kf & pf).sum()),
                not_finite_twin_only=int((kf & ~pf).sum()), of=kf.numel())


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    terms = FeatureLibrary.from_config(5, **LIB).terms
    F = len(terms)
    bad = []
    for B, H in SHAPES:
        rng = np.random.default_rng(F + B)

        def f(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()

        C1 = rng.normal(size=(4, F)) * (0.1 / np.sqrt(F))
        C1[:, :4] += np.eye(4)
        plane = f(C1[:, :, None] + rng.normal(size=(4, F, B)) * (0.01 / np.sqrt(F)))
        xs = f(rng.uniform(-1, 1, (B, H + 1, 4)))
        us = f(rng.uniform(-1, 1, (B, H, 1)))
        x0 = xs[:, 0].contiguous()
        Ks = f(rng.normal(size=(B, H, 1, 4)) * 0.3)
        ks = f(rng.normal(size=(B, H, 1)) * 0.3)
        al = tuple(0.2 ** k for k in range(10))
        args = (terms, x0, xs, us, Ks, ks, plane, al, -2.0, 2.0)
        (kx, ku), (px, pu) = K3.sindy_line_search(*args), K3.sindy_line_search_plain(*args)
        kf = torch.isfinite(kx).all(dim=(2, 3)) & torch.isfinite(ku).all(dim=(2, 3))
        pf = torch.isfinite(px).all(dim=(2, 3)) & torch.isfinite(pu).all(dim=(2, 3))
        both = kf & pf
        e7 = rel_err(kx[both], px[both])
        c7 = counts(kf, pf)
        top = float(px[pf].abs().max()) if pf.any() else float("nan")
        print(f"F={F} B={B} H={H} K7 rollouts {c7}; largest |x| of the twin on its "
              f"finite rollouts {top:.3e}; rel err on both finite "
              f"{e7:.3e}", flush=True)
        if c7["not_finite_kernel_only"] or not e7 <= TOL:
            bad.append(("K7", B, c7, e7))

        xsT, usT = xs.permute(1, 2, 0).contiguous(), us[:, :, 0].T.contiguous()
        KsT, ksT = Ks[:, :, 0].permute(1, 2, 0).contiguous(), ks[:, :, 0].T.contiguous()
        qd = f(10 ** rng.uniform(-1, 1, (4, B)))
        rd = f(10 ** rng.uniform(-3, 0, (1, B)))
        fd = f(10 ** rng.uniform(-1, 1, (4, B)))
        obj0, lin, quad = f(rng.uniform(5, 30, B)), f(-rng.uniform(0.1, 5, B)), \
            f(-rng.uniform(0.1, 5, B))
        kss = torch.zeros(B, dtype=torch.bool, device=dev)
        act = torch.ones(B, dtype=torch.bool, device=dev)
        oj = f(rng.normal(size=(H, 20, B)))
        k3 = (terms, xsT[0].contiguous(), xsT, usT, KsT, ksT, plane, al, -2.0, 2.0, qd, rd, fd,
              (0.0,) * 4, 0.05, obj0, lin, quad, kss, act, oj)
        lk, lp = K3.fused_line_search(*k3), K3.fused_line_search_plain(*k3)

        def lane_finite(out):
            return torch.stack([torch.isfinite(t.float()).reshape(-1, B).all(0)
                                for t in out]).all(0)

        kf, pf = lane_finite(lk), lane_finite(lp)
        same = (lk[3] == lp[3]) & (lk[4] == lp[4]) & kf & pf
        e3 = rel_err(lk[2][same], lp[2][same])
        c3 = counts(kf, pf)
        print(f"    K3 lanes (every output finite or not) {c3}; flags agree on "
              f"{float(((lk[3] == lp[3]) & (lk[4] == lp[4])).float().mean()):.4f}; objective "
              f"rel err on the lanes finite in both with equal flags {e3:.3e}", flush=True)
        if c3["not_finite_kernel_only"] or not e3 <= TOL:
            bad.append(("K3", B, c3, e3))
    print("FAILS", bad, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
