"""K5: all-alpha line-search rollouts through a folded MLP (port of
``autompc_tpu/ops/pallas_mlp_linesearch.py``'s
``pallas_mlp_line_search``, all three layouts; kernel in
``csrc/mlp_linesearch.cu``).

For each lane b and step size l, from x = x0, for t = 0 .. H-1:
``u = clip(alpha_l k_t + ubar_t + K_t (x - xbar_t), umin, umax)``,
``x <- x + net([x; u])`` with the folded stack of ``fold_mlp_params``
(hidden layers ``act(z W + b)``, linear head). Every x and u is
returned. ``layout`` ("slab", "feat", "mxu") is a data-movement choice
of the TPU kernel and is accepted and ignored, but for ``precision``:

* "highest": true float32 products;
* "default": one bfloat16 pass where the TPU kernel's layout takes one:
  both operands of a product rounded to bfloat16 (to nearest, ties to
  even) and the sums kept in float32. The "feat" layout rounds every
  product of the net; "mxu" every one but the first layer's control
  rows, which the TPU kernel adds as float32 rank-1 updates; "slab"
  none (the TPU kernel multiplies on the VPU in float32, so its
  "default" is "highest");
* "bf16x3": ``_mlp_ls_kernel_feat3``'s three-pass split, "feat" layout
  only (``ValueError`` otherwise, as the JAX package): weights and
  activations split into bfloat16 hi and lo parts, each layer
  ``hi.hi + (hi.lo + lo.hi)`` with float32 sums.

The products of rounded operands are exact in float32, so the kernel
takes them as float32 FMAs; the control law and the biases stay float32.

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
# The kernel's template switch (mlp_linesearch.cu: PREC) is the index.
PRECISIONS = ("highest", "default", "bf16x3")
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


def check_precision(precision, layout):
    """Raise ``ValueError`` for a precision the line search does not take,
    and for "bf16x3" outside the "feat" layout (the JAX package's rule)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    if precision == "bf16x3" and layout != "feat":
        raise ValueError("precision='bf16x3' requires layout='feat'")


def round_bf16(t):
    """``t`` rounded to bfloat16 (to nearest, ties to even), in ``t``'s
    dtype. A float64 tensor is rounded to float32 first, the value the
    card's float32 kernel would hold."""
    return t.to(torch.float32).to(torch.bfloat16).to(t.dtype)


def split_bf16(t):
    """(hi, lo): ``hi`` = ``t`` rounded to bfloat16, ``lo`` = the rest
    rounded to bfloat16 (``_mlp_ls_kernel_feat3``'s split)."""
    hi = round_bf16(t)
    return hi, round_bf16(t - hi)


def kernel_precision(precision, layout):
    """The precision the products of ``layout`` take: the "slab" layout's
    "default" is "highest" (the TPU's slab kernel multiplies in float32
    whatever the precision)."""
    return "highest" if precision == "default" and layout == "slab" else precision


def round0(layers, layout):
    """How many of the first layer's inputs "default" rounds to bfloat16:
    every one, but in the "mxu" layout the ds state rows only (the TPU
    kernel multiplies the control rows in float32)."""
    return int(layers[-1][0].shape[1]) if layout == "mxu" else int(layers[0][0].shape[0])


def _weights(layers, precision, r0=None):
    """Each layer's (W, b) as the kernel multiplies: W rounded to
    bfloat16 for "default" (the first layer's rows from ``r0`` on left
    as they are), split into (hi, lo) for "bf16x3"."""
    if precision == "default":
        (W1, b1), rest = layers[0], layers[1:]
        r0 = W1.shape[0] if r0 is None else r0
        return (((torch.cat([round_bf16(W1[:r0]), W1[r0:]]), b1),)
                + tuple((round_bf16(W), b) for W, b in rest))
    if precision == "bf16x3":
        return tuple((split_bf16(W), b) for W, b in layers)
    return tuple(layers)


def _product(h, W, precision, r0=None):
    """``h @ W`` at ``precision``, W as ``_weights`` gives it; "default"
    rounds h's inputs before ``r0`` (all without it)."""
    if precision == "default":
        if r0 is not None and r0 < h.shape[-1]:
            return torch.cat([round_bf16(h[..., :r0]), h[..., r0:]], dim=-1) @ W
        return round_bf16(h) @ W
    if precision == "bf16x3":
        hh, hl = split_bf16(h)
        Wh, Wl = W
        return hh @ Wh + (hl @ Wh + hh @ Wl)
    return h @ W


def _check(layers, nonlin, x0, xs, us, Ks, ks, alphas, layout, precision):
    if nonlin not in ACTIVATIONS:
        raise ValueError(f"unknown activation {nonlin!r}; one of {ACTIVATIONS}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    check_precision(precision, layout)
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
    tensor ops on a (B, L, .) state, each product at ``precision`` as
    ``layout`` takes it."""
    alphas = _alphas(alphas)
    B, H, ds, dc, _ = _check(layers, nonlin, x0, xs, us, Ks, ks, alphas,
                             layout, precision)
    precision, r0 = kernel_precision(precision, layout), round0(layers, layout)
    L = len(alphas)
    like = dict(dtype=xs.dtype, device=xs.device)
    a = torch.tensor(alphas, **like)[None, :, None]            # (1, L, 1)
    lo = torch.tensor(_bounds(umin, dc), **like)
    hi = torch.tensor(_bounds(umax, dc), **like)
    act = _ACT[nonlin]
    wl = _weights(layers, precision, r0)
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
        for li, (W, b) in enumerate(wl):
            z = _product(h, W, precision, r0 if li == 0 else None) + b
            h = z if li == len(wl) - 1 else act(z)
        x = x + h
        ls_xs[:, :, t + 1] = x
        ls_us[:, :, t] = u
    return ls_xs, ls_us


def _r4(n):
    return (n + 3) & ~3


def _smem_floats(widths, ds, dc, L, lanes_per_block, precision="highest"):
    """Shared memory of a K5 block, in floats (``mlp_smem`` of the
    source): the weights with each layer's columns padded to 4 (twice
    for "bf16x3": the hi and the lo parts), the activations (ds + dc
    rows) and two hidden buffers of the block's rollouts padded to 4,
    and two buffers of each lane's staged step inputs."""
    rp = _r4(lanes_per_block * L)
    nin = dc * ds + ds + 2 * dc
    weights = sum((widths[i] + 1) * _r4(widths[i + 1]) for i in range(len(widths) - 1))
    if precision == "bf16x3":
        weights *= 2
    return (weights + (ds + dc) * rp + 2 * max(widths[1:]) * rp
            + 2 * lanes_per_block * _r4(nin))


def mlp_geometry(widths, ds, dc, L, B, n_sm=_build.H100_SMS, precision="highest"):
    """K5's launch for ``widths`` (ds + dc, hidden..., ds), L step sizes
    and B lanes: a block takes ``lanes_per_block`` lanes with all their
    step sizes, ``rollouts`` = lanes_per_block x L of them (rollout r of
    block k is output rollout k x rollouts + r). Up to 40 rollouts a
    block (4 lanes at L = 10). Where those blocks would all be resident
    at once (at most two an SM: B = 1024 at L = 10), the kernel is bound
    by each thread's chain of loads and FMAs, so a block takes half the
    lanes and ``threads`` gives one 2 x 4 tile (rollouts x units) of the
    widest layer to each thread; with more blocks than that it is bound
    by throughput, and each thread takes a 4 x 4 tile (fewer
    shared-memory loads an FMA). Fewer lanes where the shared memory
    would pass 227 KB; 64..320 threads. Raises, naming the wrapper, for
    shapes the kernel does not take."""
    n_layers = len(widths) - 1
    if not 1 <= L <= _build.MAX_L:
        raise ValueError(f"mlp_line_search: 1..{_build.MAX_L} step sizes supported, "
                         f"got {L}")
    if n_layers > _build.MLP_MAX_LAYERS or max(widths) > _build.MLP_MAX_W \
            or dc > _build.MLP_MAX_DC:
        raise ValueError(
            f"mlp_line_search: the kernel takes <= {_build.MLP_MAX_LAYERS} layers "
            f"of width <= {_build.MLP_MAX_W} and dc <= {_build.MLP_MAX_DC}; "
            f"got widths {list(widths)}, dc {dc}"
        )
    tile = _build.MLP_TILE
    full = max(1, 40 // L)
    one_wave = -(-B // full) <= 2 * n_sm
    nl = max(1, full // 2) if one_wave else full
    while nl > 1 and 4 * _smem_floats(widths, ds, dc, L, nl, precision) > _build.MAX_SMEM_BYTES:
        nl -= 1
    smem = 4 * _smem_floats(widths, ds, dc, L, nl, precision)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"mlp_line_search: an MLP of widths {list(widths)} needs {smem} bytes of "
            f"shared memory, over the {_build.MAX_SMEM_BYTES} a block can use"
        )
    tiles = (_r4(nl * L) // (2 if one_wave else tile)) * max(-(-w // tile) for w in widths[1:])
    threads = min(_build.MLP_MAX_THREADS, max(64, -(-tiles // 32) * 32))
    return dict(lanes_per_block=nl, rollouts=nl * L, threads=threads,
                blocks=-(-B // nl), smem=smem)


def _mlp_params(widths, nonlin, ds, dc, alphas, umin, umax):
    P = _build.MlpLS()
    P.n_layers, P.act = len(widths) - 1, ACTIVATIONS.index(nonlin)
    for i, w in enumerate(widths):
        P.widths[i] = w
    P.ds, P.dc, P.L = ds, dc, len(alphas)
    P.round0 = widths[0]
    for l, a in enumerate(alphas):
        P.alphas[l] = a
    for j, (lo, hi) in enumerate(zip(_bounds(umin, dc), _bounds(umax, dc))):
        P.umin[j], P.umax[j] = lo, hi
    return P


def mlp_line_search(layers, nonlin, x0, xs, us, Ks, ks, alphas, umin, umax,
                    layout="slab", precision="highest"):
    """Line-search rollouts of every step size through an MLP model.

    layers: tuple of (W (n_in, n_out), b (n_out,)), the folded stack of
    ``fold_mlp_params``; nonlin: activation name; x0 (B, ds); xs
    (B, H+1, ds); us (B, H, dc); Ks (B, H, dc, ds); ks (B, H, dc);
    alphas: the L step sizes, umin/umax: scalars or dc values — host
    numbers (a tensor is read back to the host, which synchronizes).

    Returns (ls_xs (B, L, H+1, ds), ls_us (B, L, H, dc)). The kernel's
    limits (``mlp_geometry``) hold on every device: the CPU's plain
    version is the kernel's twin, not a wider function."""
    alphas = _alphas(alphas)
    B, H, ds, dc, widths = _check(layers, nonlin, x0, xs, us, Ks, ks, alphas,
                                  layout, precision)
    on_cpu = _build.device_kind(xs) == "cpu"
    precision, r0 = kernel_precision(precision, layout), round0(layers, layout)
    geom = mlp_geometry(widths, ds, dc, len(alphas), B,
                        _build.H100_SMS if on_cpu else _build.sm_count(xs.device), precision)
    if on_cpu:
        return mlp_line_search_plain(layers, nonlin, x0, xs, us, Ks, ks,
                                     alphas, umin, umax, layout, precision)
    L = len(alphas)
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
    # The weights the kernel multiplies, made once a call: "default"'s
    # rounded, "bf16x3"'s hi parts, then (bf16x3) every lo part.
    wl = _weights(layers, precision, r0)
    if precision == "bf16x3":
        weights = torch.cat([t.reshape(-1) for (Wp, b) in wl for t in (Wp[0], b)]
                            + [t.reshape(-1) for (Wp, b) in wl for t in (Wp[1], b)])
    else:
        weights = torch.cat([t.reshape(-1) for W, b in wl for t in (W, b)])
    P = _mlp_params(widths, nonlin, ds, dc, alphas, umin, umax)
    P.round0 = r0
    prec = PRECISIONS.index(precision)
    ls_xs = torch.empty((B, L, H + 1, ds), dtype=f32, device=dev)
    ls_us = torch.empty((B, L, H, dc), dtype=f32, device=dev)
    p = _build.ptr
    rc = _build.library().ampc_mlp_line_search(
        ctypes.byref(P), p(weights), p(x0), p(xs), p(us), p(Ks), p(ks),
        p(ls_xs), p(ls_us), H, B, geom["lanes_per_block"], geom["threads"], prec,
        dev.index or 0, _build.stream_of(xs),
    )
    _build.check_rc("mlp_line_search", rc)
    mlp_line_search.launches += 1
    mlp_line_search.launches_by_precision[precision] += 1
    return ls_xs, ls_us


def mlp_line_search_occupancy(widths, nonlin, ds, dc, L, B, device, precision="highest"):
    """The compiled kernel's registers and local bytes a thread, its
    resident blocks an SM and the launch geometry at this shape and
    ``precision`` on the CUDA ``device``."""
    geom = mlp_geometry(widths, ds, dc, L, B, _build.sm_count(device), precision)
    P = _mlp_params(widths, nonlin, ds, dc, (1.0,) * L, 0.0, 0.0)
    occ = _build.occupancy("ampc_mlp_line_search_occupancy", ctypes.byref(P),
                           geom["lanes_per_block"], geom["threads"],
                           PRECISIONS.index(precision), device.index or 0)
    return {**geom, **occ}


mlp_line_search.launches = 0
mlp_line_search.launches_by_precision = dict.fromkeys(PRECISIONS, 0)
