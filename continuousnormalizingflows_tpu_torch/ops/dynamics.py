"""Augmented ODE dynamics, batch-first.

Counterpart of ``continuousnormalizingflows_tpu.ops.dynamics``.  State per
row ``u = [z (nz), dlogp, E, n]``; the derivative is
``du = [dz, -tr(J) estimate, |dz|, |eps^T J|]``, with the two regularizer
columns zero unless the mode and the lambdas ask for them.

The branches, in the JAX package's order: the fused Hutchinson-VJP stage
(K1, :mod:`.fused_dynamics`); the planar net's analytic trace (with its
exact Frobenius ``reg_j``); the analytic trace of 1- and 2-hidden-layer
MLPs; the generic exact sweep (one JVP a basis row, in blocks of
``exact_chunk`` rows when it is set); the Hutchinson VJP
(``torch.autograd.grad``) and the Hutchinson JVP.  The JVPs of the port's
own nets (an MLP of any depth or a planar net, under any ``CondLayer``s,
with an activation of :data:`ACTIVATION_DERIVATIVES`) are written out: the
tangents pushed through each product and each activation's derivative
(:func:`_written_jvps`), the same code eager, under autograd and under
``torch.export``.  Any other net's (``from_torch``) run in forward mode
(``torch.autograd.forward_ad``).  Both stay differentiable by autograd,
also under the non-reentrant checkpoint of ``remat``.

Inside a sharded step (:func:`..parallel.mesh.use_mesh`): with
``probe_axis`` each ``model`` rank holds its share of the probes and the
ensemble mean is a sum over the ranks (a differentiable all-reduce); with
``sweep_axis`` each sweeps its block of basis rows and the trace is summed
likewise; a tensor-parallel MLP's hidden width is split, so its analytic
trace all-reduces its contraction over that width (the Hutchinson VJP gets
this from the net's own collectives), and the fused stage gathers the
slices into the whole net first.  Where the model ranks split the probes or
the sweep of a tensor-parallel MLP, each runs its share through the whole
net, gathered, and the net's cotangents are averaged over the ranks
(:func:`..parallel.mesh.whole_mlp_params` with ``shares=True``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.autograd.forward_ad as fwad
import torch.nn.functional as F

from ..config import ICNFConfig, Mode, TraceEstimator
from ..models.nets import MLP, CondLayer, DynamicsNet, Params, Planar, linear, mlp_layers
from ..parallel import mesh as pmesh
from .fused_dynamics import MAX_HIDDEN, _row_norm, fused_dynamics_vjp

__all__ = ["make_augmented_dynamics", "make_field", "fused_dynamics_applicable",
           "exact_trace_traceable", "ACTIVATION_DERIVATIVES"]

Args = dict


def _net_input(cfg: ICNFConfig, t, z: torch.Tensor, ys: Optional[torch.Tensor]) -> torch.Tensor:
    """``[z, t (non-autonomous), ys (conditioned)]`` along the last axis."""
    cols = [z]
    if not cfg.autonomous:
        tt = torch.as_tensor(t, dtype=z.dtype, device=z.device)
        cols.append(tt.expand(z.shape[:-1] + (1,)))
    if cfg.conditioned:
        if ys is None:
            raise ValueError("conditioned ICNF requires ys")
        cols.append(ys.to(z.dtype).expand(z.shape[:-1] + (ys.shape[-1],)))
    return torch.cat(cols, dim=-1)


def make_field(cfg: ICNFConfig, net: DynamicsNet) -> Callable:
    """The raw vector field ``f(t, z, params, ys) -> dz``, ``(B, nz) -> (B, nz)``."""

    def field(t, z: torch.Tensor, params: Params, ys: Optional[torch.Tensor]) -> torch.Tensor:
        return net.apply(params, _net_input(cfg, t, z, ys))

    return field


def probe_share(cfg: ICNFConfig):
    """``(start, stop, group)``: this rank's share of the probe ensemble under
    ``probe_axis`` (with more than one probe, as in JAX), ``group`` the one
    its sum is all-reduced over; ``(0, nprobes, None)`` unsplit."""
    axis = cfg.probe_axis if cfg.nprobes > 1 else None
    lo, hi, group = pmesh.model_share(axis, cfg.nprobes)
    if group is not None and cfg.nprobes % pmesh.active().model_size:
        raise ValueError(f"nprobes={cfg.nprobes} does not split over the "
                         f"{pmesh.active().model_size} ranks of the {cfg.probe_axis!r} axis")
    return lo, hi, group


def _probe_mean(x: torch.Tensor, nprobes: int, group) -> torch.Tensor:
    """The ensemble mean over the leading probe axis of ``x``: local, or the
    sum of every model rank's share over ``nprobes``."""
    if group is None:
        return torch.mean(x, dim=0)
    return pmesh.sum_over_model(torch.sum(x, dim=0), group) / nprobes


def _mlp_exact_applicable(net) -> bool:
    return isinstance(net, MLP) and len(net.widths) in (3, 4)


def _softplus(z):
    return F.softplus(z), torch.sigmoid(z)


def _tanh(z):  # autograd's tanh_backward, 1 - a^2
    a = torch.tanh(z)
    return a, 1 - a * a


def _sigmoid(z):
    s = torch.sigmoid(z)
    return s, s * (1 - s)


def _relu(z):
    return torch.relu(z), (z > 0).to(z.dtype)


def _elu(z):  # alpha = 1
    return F.elu(z), torch.where(z > 0, torch.ones_like(z), torch.exp(z))


def _gelu(z):  # the exact (erf) form, F.gelu's default
    phi = torch.exp(-0.5 * z * z) * (1.0 / math.sqrt(2.0 * math.pi))
    return F.gelu(z), 0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0)))) + z * phi


def _silu(z):
    s = torch.sigmoid(z)
    return F.silu(z), s * (1 + z * (1 - s))


# the activations whose derivative is written out: ``act -> z -> (act(z),
# act'(z))``, plain tensor operations that ``torch.export`` captures and
# autograd differentiates again
ACTIVATION_DERIVATIVES = {
    F.softplus: _softplus, torch.tanh: _tanh, F.tanh: _tanh,
    torch.sigmoid: _sigmoid, F.sigmoid: _sigmoid, torch.relu: _relu, F.relu: _relu,
    F.elu: _elu, F.gelu: _gelu, F.silu: _silu,
}


def _act_and_deriv(act, z: torch.Tensor):
    """``(act(z), act'(z))`` of an elementwise activation: written out for
    those of :data:`ACTIVATION_DERIVATIVES`, else from autograd
    (``create_graph`` where ``z`` is in a graph, so it stays differentiable,
    also under a non-reentrant checkpoint; not captured by ``torch.export``)."""
    written = ACTIVATION_DERIVATIVES.get(act)
    if written is not None:
        return written(z)
    train = torch.is_grad_enabled() and z.requires_grad
    with torch.enable_grad():
        zz = z if train else z.detach().requires_grad_()
        a = act(zz)
        (d,) = torch.autograd.grad(a.sum(), zz, create_graph=train)
    return (a, d) if train else (a.detach(), d.detach())


def _written_net(net):
    """``(inner, conditions)`` where the JVPs of ``net`` are written out: an
    MLP or a planar net with an activation of
    :data:`ACTIVATION_DERIVATIVES`, under any ``CondLayer``s (whose
    conditions, outermost first, are appended to its input); else None."""
    conds = []
    while isinstance(net, CondLayer):
        conds.append(net.ys)
        net = net.net
    if isinstance(net, (MLP, Planar)) and net.activation in ACTIVATION_DERIVATIVES:
        return net, conds
    return None


def exact_trace_traceable(net) -> bool:
    """Whether the exact trace of ``net`` traces for ``torch.export``: the
    analytic planar and MLP traces and the written-out sweep
    (:func:`_written_net`).  A ``from_torch`` net's sweep runs in forward
    mode, which ``torch.export`` does not capture with a symbolic batch."""
    return _written_net(net) is not None


def activation_name(net) -> Optional[str]:
    """The name of the activation of ``net`` (under its ``CondLayer``s) that
    has no written-out derivative, or None."""
    while isinstance(net, CondLayer):
        net = net.net
    act = getattr(net, "activation", None)
    if act is None or act in ACTIVATION_DERIVATIVES:
        return None
    return getattr(act, "__name__", repr(act))


def _written_jvps(net, conds, params: Params, x_full: torch.Tensor, nz: int,
                  tangents: torch.Tensor):
    """``(field, J tangents)`` of a :func:`_written_net` at ``x_full`` (the
    field's input, before the ``CondLayer`` conditions), for tangents ``(C,
    B or 1, nz)`` on the ``z`` columns (zero on the time and condition
    columns): forward mode written out, the tangents through each product
    (without its bias) and times each activation's derivative.  A
    tensor-parallel MLP sums its row-parallel product's tangent over the
    model ranks as it sums the product."""
    for ys in conds:
        ys = ys.to(device=x_full.device, dtype=x_full.dtype)
        x_full = torch.cat([x_full, ys.expand(x_full.shape[:-1] + (ys.shape[-1],))], dim=-1)
    if isinstance(net, Planar):
        a, d = _act_and_deriv(net.activation, net._pre(params, x_full))
        u, w = params["u"], params["w"]
        return a[..., None] * u, (d * (tangents @ w[:nz]))[..., None] * u
    prec = net.precision
    layers = mlp_layers(params)
    tp = net.tp_group(params)
    if tp is not None:
        x_full = pmesh.copy_to_model(x_full, tp)
    h, last = x_full, len(layers) - 1
    for i, (a, b) in enumerate(layers):
        if i == 0:
            h, tan = linear(h, a, b, prec), linear(tangents, a[:, :nz], None, prec)
        elif i == 1 and tp is not None:
            h = pmesh.reduce_from_model(linear(h, a, None, prec), tp) + b
            tan = pmesh.reduce_from_model(linear(tan, a, None, prec), tp)
        else:
            h, tan = linear(h, a, b, prec), linear(tan, a, None, prec)
        if i != last:
            h, d = _act_and_deriv(net.activation, h)
            tan = d * tan
    return h, tan.expand(tangents.shape[:1] + h.shape)


def _planar_trace(net: Planar, params: Params, x_full: torch.Tensor, nz: int, reg: bool):
    """Analytic ``(dz, tr(J_z), ||J_z||_F)`` of planar dynamics
    ``u * act(w . x + b)``: ``J_z = act' u[:nz] w[:nz]^T`` has rank one, so
    ``tr = (u[:nz] . w[:nz]) act'`` and ``||J_z||_F = |act'| ||u[:nz]||
    ||w[:nz]||`` (None unless ``reg``)."""
    a, d = _act_and_deriv(net.activation, net._pre(params, x_full))
    u, w = params["u"], params["w"]
    dz = a[..., None] * u
    div = torch.sum(u[:nz] * w[:nz]) * d
    fro = torch.abs(d) * torch.linalg.norm(u[:nz]) * torch.linalg.norm(w[:nz]) if reg else None
    return dz, div, fro


def _jvps(fn, z: torch.Tensor, tangents: torch.Tensor):
    """``(fn(z), J tangents)`` for a stack of tangents ``(C, B or 1, nz)``:
    one forward-mode pass over ``C`` copies of the batch (the net maps any
    leading axes).  Differentiable where ``z`` or what ``fn`` closes over
    requires grad; plain values otherwise.  Forward mode is switched on
    explicitly: an ``autograd.Function``'s forward (the adjoints' forward
    solve) runs with it off."""
    shape = tangents.shape[:1] + z.shape
    with fwad._set_fwd_grad_enabled(True), fwad.dual_level():
        zd = fwad.make_dual(z.expand(shape).contiguous(), tangents.expand(shape).contiguous())
        out = fwad.unpack_dual(fn(zd))
    return out.primal[0], out.tangent


def _exact_sweep(jvps, z: torch.Tensor, nz: int, chunk: int, reg: bool, axis=None):
    """``(dz, tr(J), sum J^2 or None)`` by JVPs along the basis rows
    (``jvps(tangents (C, 1, nz)) -> (dz, J tangents)``): all ``nz`` at once
    when ``chunk == 0``, else in blocks of ``chunk`` rows (peak memory
    ``(chunk, B, nz)``), the last block's overrun rows zero.  ``axis``
    (``sweep_axis``): inside a sharded step this rank sweeps its block of the
    rows, and the sums are all-reduced over the axis."""
    eye = torch.eye(nz, dtype=z.dtype, device=z.device)
    batch = z.shape[:-1]
    lo, hi, group = pmesh.model_share(axis, nz)
    if group is not None:
        return _shared_sweep(jvps, z, eye[lo:hi], chunk, reg, group)
    if chunk == 0:
        dz, jcols = jvps(eye[:, None, :])
        div = torch.einsum("ibi->b", jcols)
        return dz, div, torch.sum(torch.square(jcols), dim=(0, 2)) if reg else None
    chunk = min(chunk, nz)
    nblocks = -(-nz // chunk)
    basis_all = torch.cat([eye, eye.new_zeros((nblocks * chunk - nz, nz))])
    div = fro = torch.zeros(batch, dtype=z.dtype, device=z.device)
    for o in range(0, nblocks * chunk, chunk):
        basis = basis_all[o:o + chunk]
        dz, jrows = jvps(basis[:, None, :])
        div = div + torch.einsum("cbj,cj->b", jrows, basis)
        if reg:
            fro = fro + torch.sum(torch.square(jrows), dim=(0, 2))
    return dz, div, fro if reg else None


def _shared_sweep(jvps, z: torch.Tensor, rows: torch.Tensor, chunk: int, reg: bool, group):
    """:func:`_exact_sweep` over this rank's ``rows`` of the basis (blocks of
    ``chunk`` of them, all at once when 0), its sums all-reduced in one
    differentiable collective."""
    batch = z.shape[:-1]
    div = fro = torch.zeros(batch, dtype=z.dtype, device=z.device)
    dz = None
    step = chunk if chunk > 0 else max(rows.shape[0], 1)
    for o in range(0, rows.shape[0], step):
        basis = rows[o:o + step]
        dz, jrows = jvps(basis[:, None, :])
        div = div + torch.einsum("cbj,cj->b", jrows, basis)
        if reg:
            fro = fro + torch.sum(torch.square(jrows), dim=(0, 2))
    if dz is None:  # a rank past the last row: the field alone
        dz = jvps(rows.new_zeros((1, 1, z.shape[-1])))[0]
    div, fro = pmesh.sum_over_model(torch.stack([div, fro]), group)
    return dz, div, fro if reg else None


def _mlp_exact_trace(net: MLP, params: Params, x_full: torch.Tensor, nz: int):
    """Analytic ``(dz, tr(J_z))`` for 1- and 2-hidden-layer MLPs.

    The z-block Jacobian of ``y = A3 sp(A2 sp(A1 x))`` is
    ``A3[:nz] D2 A2 D1 A1[:, :nz]`` with ``D_i = diag(s_i)``, so
    ``tr(J) = sum_{k,l} s1[k] G[k,l] s2[l]`` with
    ``G = A2^T o (A1[:, :nz] A3[:nz])``: one batch-independent masked
    product and one extra ``(B, h) x (h, h)`` product per evaluation.  The
    transposes are ``.t()`` calls, as in :func:`.models.nets.linear`.
    Tensor-parallel (this rank's slice of the first hidden width): layer 1's
    product and the trace's contraction over that width are all-reduced over
    ``model``."""
    prec = net.precision
    layers = mlp_layers(params)
    tp = net.tp_group(params)
    if tp is not None:
        x_full = pmesh.copy_to_model(x_full, tp)
    # a row-parallel product: summed over the model ranks' slices, then the bias once
    row_par = lambda h, a, b: (linear(h, a, b, prec) if tp is None
                               else pmesh.reduce_from_model(linear(h, a, None, prec), tp) + b)
    summed = lambda v: v if tp is None else pmesh.reduce_from_model(v, tp)
    if len(layers) == 2:
        (a1, b1), (a2, b2) = layers
        h1, s1 = _act_and_deriv(net.activation, linear(x_full, a1, b1, prec))
        dz = row_par(h1, a2, b2)
        g = torch.sum(a1[:, :nz] * a2[:nz, :].t(), dim=1)  # (h,)
        return dz, summed(s1 @ g)
    (a1, b1), (a2, b2), (a3, b3) = layers
    h1, s1 = _act_and_deriv(net.activation, linear(x_full, a1, b1, prec))
    h2, s2 = _act_and_deriv(net.activation, row_par(h1, a2, b2))
    dz = linear(h2, a3, b3, prec)
    m = linear(a1[:, :nz], a3[:nz, :].t(), None, prec)  # (h1, h2)
    g_mat = a2.t() * m
    div = torch.sum(linear(s1, g_mat.t(), None, prec) * s2, dim=-1)
    return dz, summed(div)


def _probe_vjps(fn, z: torch.Tensor, eps: torch.Tensor, inputs):
    """``(fn(z), stack of eps[p]^T dfn/dz)``.  Built on ``torch.autograd.grad``
    (not ``torch.func.vjp``, which refuses the saved-tensor hooks of a
    non-reentrant checkpoint, i.e. ``remat``).  The results stay in the graph
    when grad is enabled and ``z`` or one of ``inputs`` (what ``fn`` closes
    over) requires grad, and are plain values otherwise."""
    train = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (z, eps, *inputs))
    with torch.enable_grad():
        # outside a recorded graph (e.g. an adjoint's forward under no_grad)
        # z may be a no-grad view of a leaf: differentiate a detached copy
        zz = z if train and z.requires_grad else z.detach().requires_grad_()
        dz = fn(zz)
        eps_j = torch.stack([
            torch.autograd.grad(dz, zz, e, create_graph=train, retain_graph=True)[0]
            for e in eps
        ])  # (P, B, nz)
    return (dz, eps_j) if train else (dz.detach(), eps_j.detach())


def fused_dynamics_applicable(cfg: ICNFConfig, net, mode: Mode) -> bool:
    """The JAX fused-stage predicate with a float32 check in place of its
    TPU-backend check (the kernel takes float32; a float64 config solves
    unfused on every device, as JAX's does on the CPU)."""
    return (
        cfg.fused
        and cfg.dtype == torch.float32
        and cfg.trace_for(mode) is TraceEstimator.HUTCH_VJP
        and cfg.nprobes == 1
        and isinstance(net, MLP)
        and len(net.widths) == 4
        and net.widths[1] == net.widths[2]
        and net.widths[1] <= MAX_HIDDEN
        and net.activation is F.softplus
    )


def make_augmented_dynamics(cfg: ICNFConfig, net: DynamicsNet, mode: Mode) -> Callable:
    """Build ``f_aug(t, u, args) -> du`` for :func:`.ode.odeint`.

    ``args`` is ``{"params": dict, "eps": (P, B, nz) | None, "ys": (B, nc) | None}``."""
    nz = cfg.nz
    estimator = cfg.trace_for(mode)
    compute_reg_z = mode.regularized and cfg.norm_z
    compute_reg_j = mode.regularized and cfg.norm_j
    field = make_field(cfg, net)

    if fused_dynamics_applicable(cfg, net, mode):
        cdt = torch.bfloat16 if net.precision != "highest" else None

        def f_aug_fused(t, u: torch.Tensor, args: Args) -> torch.Tensor:
            x_full = _net_input(cfg, t, u[..., :nz], args.get("ys"))
            # the kernel takes the whole net: a tensor-parallel one's slices gathered
            dz, _epsj, div, reg_z, reg_j = fused_dynamics_vjp(
                x_full, args["eps"][0], pmesh.whole_mlp_params(args["params"]), nz, cdt
            )
            zero = torch.zeros_like(div)
            return torch.cat(
                [
                    dz,
                    -div[..., None],
                    (reg_z if compute_reg_z else zero)[..., None],
                    (reg_j if compute_reg_j else zero)[..., None],
                ],
                dim=-1,
            )

        return f_aug_fused

    planar = isinstance(net, Planar)
    mlp_exact = _mlp_exact_applicable(net) and not compute_reg_j
    written = _written_net(net)
    sweep = estimator is TraceEstimator.EXACT and not planar and not mlp_exact

    def f_aug(t, u: torch.Tensor, args: Args) -> torch.Tensor:
        params = args["params"]
        ys = args.get("ys")
        z = u[..., :nz]
        probes = probe_share(cfg)[2] if estimator is not TraceEstimator.EXACT else None
        sweeps = sweep and pmesh.model_share(cfg.sweep_axis, nz)[2] is not None
        if probes is not None or sweeps:
            # each model rank's share through the whole net: a tensor-parallel
            # one's slices gathered, their cotangents averaged over the ranks
            params = pmesh.whole_mlp_params(params, shares=True)
        zero = torch.zeros(z.shape[:-1], dtype=u.dtype, device=u.device)
        g = lambda zz: field(t, zz, params, ys)
        if written is not None:
            jvps = lambda tangents: _written_jvps(*written, params, _net_input(cfg, t, z, ys), nz,
                                                  tangents)
        else:
            jvps = lambda tangents: _jvps(g, z, tangents)
        reg_j = zero
        if estimator is TraceEstimator.EXACT and planar:
            dz, div, fro = _planar_trace(net, params, _net_input(cfg, t, z, ys), nz,
                                         compute_reg_j)
            reg_j = fro if compute_reg_j else zero
        elif estimator is TraceEstimator.EXACT and mlp_exact:
            dz, div = _mlp_exact_trace(net, params, _net_input(cfg, t, z, ys), nz)
        elif estimator is TraceEstimator.EXACT:
            dz, div, fro = _exact_sweep(jvps, z, nz, cfg.exact_chunk, compute_reg_j,
                                        cfg.sweep_axis)
            reg_j = torch.sqrt(fro) if compute_reg_j else zero
        elif estimator is TraceEstimator.HUTCH_VJP:  # one shared forward, one VJP a probe
            eps = args["eps"]
            dz, eps_j = _probe_vjps(g, z, eps, (*params.values(), ys))
            div = _probe_mean(torch.sum(eps_j * eps, dim=-1), cfg.nprobes, probes)
            reg_j = _probe_mean(_row_norm(eps_j), cfg.nprobes, probes) if compute_reg_j else zero
        else:  # HUTCH_JVP: J eps by forward mode
            eps = args["eps"]
            dz, j_eps = jvps(eps)
            div = _probe_mean(torch.sum(eps * j_eps, dim=-1), cfg.nprobes, probes)
            reg_j = _probe_mean(_row_norm(j_eps), cfg.nprobes, probes) if compute_reg_j else zero
        reg_z = _row_norm(dz) if compute_reg_z else zero
        return torch.cat(
            [dz, -div[..., None], reg_z[..., None], reg_j[..., None]], dim=-1
        )

    return f_aug
