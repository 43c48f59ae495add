"""K5: all-alpha line-search rollouts through a folded MLP (port of
``autompc_tpu/ops/pallas_mlp_linesearch.py``'s
``pallas_mlp_line_search``, all three layouts; kernel in
``csrc/mlp_linesearch.cu``).

For each lane b and step size l, from x = x0, for t = 0 .. H-1:
``u = clip(alpha_l k_t + ubar_t + K_t (x - xbar_t), umin, umax)``,
``x <- x + net([x; u])`` with the folded stack of ``fold_mlp_params``
(hidden layers ``act(z W + b)``, linear head). Every x and u is
returned. ``layout`` ("slab", "feat", "mxu") is a data-movement choice
of the TPU kernel and is accepted and ignored; ``precision`` must be
"highest" (true float32): the TPU's single-pass and split-bf16 matmul
modes are not ported.

A CPU tensor takes the plain PyTorch version ``mlp_line_search_plain``;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

ACTIVATIONS = ("relu", "tanh", "sigmoid", "selu")
LAYOUTS = ("slab", "feat", "mxu")
_ACT = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "selu": torch.selu,
}


def fold_mlp_params(params):
    """Fold the MLP's z-scoring into its first and last layers.

    ``MLP.pred_core`` computes ``x + (net((xu - m)/s) * dy_std +
    dy_means)``; with ``W1' = W1 / s[:, None]``, ``b1' = b1 - (m/s) W1``,
    ``W_L' = W_L * dy_std[None, :]`` and ``b_L' = b_L * dy_std +
    dy_means`` the same function is a plain stack over raw ``[x; u]``.
    Returns a tuple of (W (n_in, n_out), b (n_out,)) pairs. Folding
    does not depend on the activation, so its name is not an argument
    (the JAX function takes and ignores it)."""
    s, m = params["xu_std"], params["xu_means"]
    layers = [(la["W"], la["b"]) for la in params["net"]]
    W1, b1 = layers[0]
    layers[0] = (W1 / s[:, None], b1 - (m / s) @ W1)
    WL, bL = layers[-1]
    layers[-1] = (
        WL * params["dy_std"][None, :],
        bL * params["dy_std"] + params["dy_means"],
    )
    return tuple(layers)


def _bounds(v, dc):
    """umin or umax (scalar, sequence, array or tensor) as a list of dc
    floats."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v, dtype=np.float64).reshape(-1).tolist()
    if len(v) == 1:
        v = v * dc
    if len(v) != dc:
        raise ValueError(f"control bound has {len(v)} entries, expected 1 or {dc}")
    return v


def _alphas(alphas):
    if isinstance(alphas, torch.Tensor):
        return [float(a) for a in alphas.detach().cpu().tolist()]
    return [float(a) for a in alphas]


def _check(layers, nonlin, x0, xs, us, Ks, ks, alphas, layout, precision):
    if nonlin not in ACTIVATIONS:
        raise ValueError(f"unknown activation {nonlin!r}; one of {ACTIVATIONS}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if precision != "highest":
        raise ValueError(
            f"precision={precision!r} is not ported: the kernel computes "
            "in true float32 ('highest') only"
        )
    if xs.ndim != 3 or us.ndim != 3:
        raise ValueError("xs must be (B, H+1, ds) and us (B, H, dc)")
    B, Hp1, ds = xs.shape
    H, dc = Hp1 - 1, us.shape[-1]
    want = {
        "x0": (x0, (B, ds)), "us": (us, (B, H, dc)),
        "Ks": (Ks, (B, H, dc, ds)), "ks": (ks, (B, H, dc)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    widths = [ds + dc] + [int(b.shape[0]) for _, b in layers]
    for li, (W, b) in enumerate(layers):
        if tuple(W.shape) != (widths[li], widths[li + 1]):
            raise ValueError(
                f"layer {li}: W shape {tuple(W.shape)}, expected "
                f"{(widths[li], widths[li + 1])}"
            )
    if widths[-1] != ds:
        raise ValueError(f"MLP output width {widths[-1]} != state dim {ds}")
    if not 1 <= len(alphas) <= _build.MAX_L:
        raise ValueError(f"1..{_build.MAX_L} step sizes supported, got {len(alphas)}")
    return B, H, ds, dc, widths


def mlp_line_search_plain(layers, nonlin, x0, xs, us, Ks, ks, alphas, umin,
                          umax, layout="slab", precision="highest"):
    """Plain PyTorch version of the kernel: a loop over H of batched
    tensor ops on a (B, L, .) state."""
    alphas = _alphas(alphas)
    B, H, ds, dc, _ = _check(layers, nonlin, x0, xs, us, Ks, ks, alphas,
                             layout, precision)
    L = len(alphas)
    like = dict(dtype=xs.dtype, device=xs.device)
    a = torch.tensor(alphas, **like)[None, :, None]            # (1, L, 1)
    lo = torch.tensor(_bounds(umin, dc), **like)
    hi = torch.tensor(_bounds(umax, dc), **like)
    act = _ACT[nonlin]
    ls_xs = xs.new_empty((B, L, H + 1, ds))
    ls_us = xs.new_empty((B, L, H, dc))
    x = x0[:, None, :].expand(B, L, ds)
    ls_xs[:, :, 0] = x
    for t in range(H):
        dx = x - xs[:, t][:, None, :]
        fb = dx @ Ks[:, t].transpose(1, 2)                     # (B, L, dc)
        u = a * ks[:, t][:, None, :] + us[:, t][:, None, :] + fb
        u = torch.minimum(torch.maximum(u, lo), hi)
        h = torch.cat([x, u], dim=-1)
        for W, b in layers[:-1]:
            h = act(h @ W + b)
        W, b = layers[-1]
        x = x + (h @ W + b)
        ls_xs[:, :, t + 1] = x
        ls_us[:, :, t] = u
    return ls_xs, ls_us


def _smem_bytes(widths, ds, dc, L, lanes_per_block=1):
    """Shared memory the kernel needs (the C launcher's formula)."""
    def r4(n):
        return (n + 3) & ~3

    lp = -(-L // _build.MLP_RPT) * 8
    wtot = sum((widths[i] + 1) * widths[i + 1] for i in range(len(widths) - 1))
    lane = (r4((ds + dc) * lp) + 2 * r4(max(widths[1:]) * lp)
            + r4(dc * ds + ds + 2 * dc))
    return 4 * (r4(wtot) + lanes_per_block * lane)


def mlp_line_search(layers, nonlin, x0, xs, us, Ks, ks, alphas, umin, umax,
                    layout="slab", precision="highest"):
    """Line-search rollouts of every step size through an MLP model.

    layers: tuple of (W (n_in, n_out), b (n_out,)), the folded stack of
    ``fold_mlp_params``; nonlin: activation name; x0 (B, ds); xs
    (B, H+1, ds); us (B, H, dc); Ks (B, H, dc, ds); ks (B, H, dc);
    alphas: the L step sizes, umin/umax: scalars or dc values — host
    numbers (a tensor is read back to the host, which synchronizes).

    Returns (ls_xs (B, L, H+1, ds), ls_us (B, L, H, dc))."""
    if _build.device_kind(xs) == "cpu":
        return mlp_line_search_plain(layers, nonlin, x0, xs, us, Ks, ks,
                                     alphas, umin, umax, layout, precision)
    alphas = _alphas(alphas)
    B, H, ds, dc, widths = _check(layers, nonlin, x0, xs, us, Ks, ks, alphas,
                                  layout, precision)
    L = len(alphas)
    n_layers = len(layers)
    if n_layers > _build.MLP_MAX_LAYERS or max(widths) > _build.MLP_MAX_W \
            or dc > _build.MLP_MAX_DC:
        raise ValueError(
            f"MLP line-search kernel takes <= {_build.MLP_MAX_LAYERS} layers "
            f"of width <= {_build.MLP_MAX_W} and dc <= {_build.MLP_MAX_DC}; "
            f"got widths {widths}, dc {dc}"
        )
    groups = -(-L // _build.MLP_RPT)
    if dc * ds + ds + 2 * dc > _build.MLP_PF * _build.MLP_TX * groups:
        raise ValueError(
            f"MLP line-search kernel stages at most "
            f"{_build.MLP_PF * _build.MLP_TX * groups} gain and trajectory "
            f"values per step; ds={ds}, dc={dc} needs {dc * ds + ds + 2 * dc}"
        )
    if _smem_bytes(widths, ds, dc, L) > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"MLP of widths {widths} needs {_smem_bytes(widths, ds, dc, L)} "
            f"bytes of shared memory, over the {_build.MAX_SMEM_BYTES} a "
            "block can use"
        )
    dev, f32 = xs.device, torch.float32
    for name, t in (("x0", x0), ("xs", xs), ("us", us), ("Ks", Ks), ("ks", ks)):
        _build.check_cuda(name, t, t.shape, f32, dev)
    for li, (W, b) in enumerate(layers):
        for name, t in ((f"W{li}", W), (f"b{li}", b)):
            if t.device != dev or t.dtype != f32:
                raise ValueError(
                    f"{name}: {t.dtype} on {t.device}, the kernel takes "
                    f"{f32} on {dev}"
                )
    weights = torch.cat([t.reshape(-1) for W, b in layers for t in (W, b)])
    P = _build.MlpLS()
    P.n_layers, P.act = n_layers, ACTIVATIONS.index(nonlin)
    for i, w in enumerate(widths):
        P.widths[i] = w
    P.ds, P.dc, P.L = ds, dc, L
    for l, a in enumerate(alphas):
        P.alphas[l] = a
    for j, (lo, hi) in enumerate(zip(_bounds(umin, dc), _bounds(umax, dc))):
        P.umin[j], P.umax[j] = lo, hi
    ls_xs = torch.empty((B, L, H + 1, ds), dtype=f32, device=dev)
    ls_us = torch.empty((B, L, H, dc), dtype=f32, device=dev)
    p = _build.ptr
    rc = _build.library().ampc_mlp_line_search(
        ctypes.byref(P), p(weights), p(x0), p(xs), p(us), p(Ks), p(ks),
        p(ls_xs), p(ls_us), H, B, dev.index or 0, _build.stream_of(xs),
    )
    _build.check_rc("mlp_line_search", rc)
    mlp_line_search.launches += 1
    return ls_xs, ls_us


mlp_line_search.launches = 0
