"""Batched Nelder-Mead simplex minimizer.

Port of ``dss_ml_at_scale_tpu/ops/neldermead.py``. The JAX minimizer runs
one ``lax.while_loop`` per start and is ``vmap``-ed over thousands of
them; here every start is a lane of one batched simplex ``[L, n+1, n]``.
A lane that meets its tolerances freezes (``torch.where(active, new,
old)``), as a vmapped while loop freezes it, so each lane's result is the
one the unbatched search gives; the loop ends when no lane is active or
after ``max_iter`` iterations.

Branchless variant, as the JAX one: each iteration evaluates reflection,
expansion, both contractions and the shrink simplex, then selects with
``torch.where``. The four candidates and the ``n+1`` shrink points go to
the objective as ONE stacked call of ``n+5`` points per lane. Constants
follow Nelder & Mead (alpha=1, gamma=2, rho=0.5, sigma=0.5), scipy's
defaults.

Two rules keep the lanes' decisions those of JAX:

- :func:`nan_to_max` maps NaN and +inf to the dtype's largest finite
  value, as ``jnp.nan_to_num(x, nan=jnp.inf)`` does (JAX maps NaN to inf
  and then clamps inf); ``torch.nan_to_num(x, nan=inf)`` would leave inf.
- The vertex order is a STABLE sort, as ``jnp.argsort``: vertices whose
  values were mapped to the same float max keep their order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# Iterations between the host's "any lane still active?" checks: frozen
# lanes do not change, so checking less often changes no result.
CHECK_EVERY = 8


class NelderMeadResult(NamedTuple):
    x: torch.Tensor  # [L, n] best point per lane
    fun: torch.Tensor  # [L] objective at x
    n_iter: torch.Tensor  # [L] int32 iterations actually run
    converged: torch.Tensor  # [L] bool: tolerances met before max_iter


def nan_to_max(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nan_to_num(x, nan=jnp.inf)``: NaN and +inf to the largest
    finite value, -inf to the smallest."""
    return torch.nan_to_num(x, nan=torch.finfo(x.dtype).max)


def _init_simplex(x0: torch.Tensor) -> torch.Tensor:
    # scipy's initialization: perturb each coordinate by 5% (0.00025 if zero).
    pert = torch.where(x0 == 0.0, 0.00025, 0.05 * x0)
    return torch.cat([x0.unsqueeze(1), x0.unsqueeze(1) + torch.diag_embed(pert)], 1)


def _spreads(simplex: torch.Tensor, fvals: torch.Tensor):
    x_spread = (simplex[:, 1:] - simplex[:, :1]).abs().amax((1, 2))
    f_spread = (fvals[:, 1:] - fvals[:, :1]).abs().amax(1)
    return x_spread, f_spread


def nelder_mead(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iter: int = 200,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
) -> NelderMeadResult:
    """Minimize ``fn`` from each row of ``x0`` (``[L, n]``).

    ``fn`` maps points ``[L, k, n]`` to values ``[L, k]``: row ``l`` of
    every call belongs to lane ``l``. A floating ``x0`` keeps its dtype (an
    f64 start gives an f64 search); any other start takes torch's default
    float.
    """
    if not x0.is_floating_point():
        x0 = x0.to(torch.get_default_dtype())
    L, n = x0.shape
    with torch.no_grad():
        simplex = _init_simplex(x0)
        # Non-finite objective values must not poison the simplex ordering.
        fvals = nan_to_max(fn(simplex))
        it = torch.zeros(L, dtype=torch.int32, device=x0.device)

        def active_lanes():
            x_spread, f_spread = _spreads(simplex, fvals)
            return (it < max_iter) & ~((x_spread <= xatol) & (f_spread <= fatol))

        active = active_lanes()
        for k in range(max_iter):
            if k % CHECK_EVERY == 0 and not bool(active.any()):
                break
            order = torch.argsort(fvals, dim=1, stable=True)
            s = torch.take_along_dim(simplex, order.unsqueeze(-1), 1)
            f = torch.take_along_dim(fvals, order, 1)
            f_best, f_second, f_worst = f[:, 0], f[:, -2], f[:, -1]
            centroid = s[:, :-1].mean(1)
            step = centroid - s[:, -1]
            cands = torch.stack([
                centroid + step,  # reflection
                centroid + 2.0 * step,  # expansion
                centroid + 0.5 * step,  # outside contraction
                centroid - 0.5 * step,  # inside contraction
            ], 1)
            shrunk = s[:, :1] + 0.5 * (s - s[:, :1])
            fs = nan_to_max(fn(torch.cat([cands, shrunk], 1)))
            fr, fe, foc, fic = fs[:, 0], fs[:, 1], fs[:, 2], fs[:, 3]
            shrunk_f = torch.cat([f[:, :1], fs[:, 5:]], 1)  # best vertex unchanged

            # Decide the replacement for the worst vertex.
            take_exp = (fr < f_best) & (fe < fr)
            take_ref = (fr < f_second) & ~take_exp & ~(fr < f_best)
            take_ref = take_ref | ((fr < f_best) & ~(fe < fr))
            take_oc = (fr >= f_second) & (fr < f_worst) & (foc <= fr)
            take_ic = (fr >= f_second) & ~(fr < f_worst) & (fic < f_worst)
            shrink = ~(take_exp | take_ref | take_oc | take_ic)
            pick = torch.where(take_exp, 1, torch.where(take_ref, 0, torch.where(take_oc, 2, 3)))
            new_vertex = torch.take_along_dim(cands, pick[:, None, None], 1)
            new_f = torch.take_along_dim(fs, pick[:, None], 1)

            replaced = torch.cat([s[:, :-1], new_vertex], 1)
            replaced_f = torch.cat([f[:, :-1], new_f], 1)
            s = torch.where(shrink[:, None, None], shrunk, replaced)
            f = torch.where(shrink[:, None], shrunk_f, replaced_f)

            simplex = torch.where(active[:, None, None], s, simplex)
            fvals = torch.where(active[:, None], f, fvals)
            it = it + active.to(torch.int32)
            active = active_lanes()

        best = torch.argmin(fvals, 1)
        x_spread, f_spread = _spreads(simplex, fvals)
        converged = (x_spread <= xatol) & (f_spread <= fatol)
        x = torch.take_along_dim(simplex, best[:, None, None], 1).squeeze(1)
        fun = torch.take_along_dim(fvals, best[:, None], 1).squeeze(1)
    return NelderMeadResult(x, fun, it, converged)
