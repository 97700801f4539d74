"""Batched BFGS with a strong-Wolfe line search.

The port's copy of ``jax.scipy.optimize.minimize(method="BFGS")``, which
the JAX package's SARIMAX fit calls to polish each Nelder-Mead result
(``jax/_src/scipy/optimize/bfgs.py`` ``minimize_bfgs`` and
``line_search.py`` ``line_search``/``_zoom``, JAX 0.9). The JAX version
runs three nested ``lax.while_loop``s per start and is ``vmap``-ed over
thousands of starts, so a batch waits at every level for its slowest
lane. Here every start is a lane of one batch and its own small state
machine (:class:`_Lanes`): each round evaluates the objective once for
all lanes, each at the step its own search asks for, so every lane takes
the steps the unbatched search takes (the same iterates, function counts
and status codes) and the batch takes as many rounds as its busiest lane
needs evaluations. JAX's line search runs both of its zooms in every
iteration, one of them passed through; a lane enters at most one, so
here one zoom serves both, each lane starting from its own bracket.

Gradients come from ``torch.autograd.grad`` of the summed batched
objective: the lanes are independent, so each lane's gradient is exact.
``lane_chunk`` bounds how many lanes one backward pass holds (the filter
behind the SARIMAX objective saves its whole time loop); the results do
not depend on it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Objective = Callable[[torch.Tensor, slice], torch.Tensor]


class BFGSResult(NamedTuple):
    """``jax.scipy.optimize.OptimizeResults`` of every lane."""

    x: torch.Tensor  # [L, d]
    success: torch.Tensor  # [L] bool: converged and no line-search failure
    status: torch.Tensor  # [L] 0 converged, 1 maxiter, 2 + ls status, -1 undefined
    fun: torch.Tensor  # [L]
    jac: torch.Tensor  # [L, d]
    hess_inv: torch.Tensor  # [L, d, d]
    nfev: torch.Tensor  # [L]
    njev: torch.Tensor  # [L]
    nit: torch.Tensor  # [L]


def value_and_grad(fun: Objective, x: torch.Tensor,
                   lane_chunk: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``fun(x)`` ``[L]`` and its gradient ``[L, d]``, lane by lane exact;
    at most ``lane_chunk`` lanes per backward pass."""
    L = x.shape[0]
    step = L if not lane_chunk else lane_chunk
    fs, gs = [], []
    for lo in range(0, L, step):
        lanes = slice(lo, min(lo + step, L))
        with torch.enable_grad():
            xs = x[lanes].detach().requires_grad_(True)
            f = fun(xs, lanes)
            (g,) = torch.autograd.grad(f.sum(), xs)
        fs.append(f.detach())
        gs.append(g)
    if len(fs) == 1:
        return fs[0], gs[0]
    return torch.cat(fs), torch.cat(gs)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    d2a = fb - fa - C * db
    d2b = fc - fa - C * dc
    A = (dc * dc * d2a + -(db * db) * d2b) / denom
    B = (-(dc * dc * dc) * d2a + db * db * db * d2b) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


class _Lanes:
    """Every lane's BFGS, line-search and zoom state, advanced one
    function evaluation at a time.

    JAX nests the zoom loop in the line-search loop in the BFGS loop, so a
    vmapped batch waits at every level for its slowest lane. Here each
    lane is a small state machine: every round evaluates the objective
    once for all lanes, each at the step its own search asks for, and
    moves each lane to its next request (the next line-search step, a zoom
    step, or, once its line search is over, the BFGS update and the first
    step of the next line search). A lane goes through exactly the
    evaluations and updates of its unbatched search; the batch takes as
    many rounds as its busiest lane needs evaluations.
    """

    def __init__(self, x0, f, g, maxiter, gtol, ls_maxiter, c1=1e-4, c2=0.9):
        L, d = x0.shape
        dt, dev = x0.dtype, x0.device
        self.maxiter, self.gtol, self.ls_maxiter, self.c1, self.c2 = (
            maxiter, gtol, ls_maxiter, c1, c2)
        self.threshold = 1e-10 if dt == torch.float64 else 1e-5
        self.eye = torch.eye(d, dtype=dt, device=dev)
        zi = torch.zeros(L, dtype=torch.int32, device=dev)
        zf = torch.zeros(L, dtype=dt, device=dev)
        zb = torch.zeros(L, dtype=torch.bool, device=dev)
        # BFGS.
        self.x, self.f, self.g = x0, f, g
        self.H = self.eye.expand(L, d, d).clone()
        self.converged = g.abs().amax(-1) < gtol
        self.failed, self.k, self.nfev, self.ls_status = zb, zi, zi + 1, zi
        self.old_old_fval = f + torch.linalg.vector_norm(g, dim=-1) / 2
        # Line search (``p`` its direction, ``t`` the step to evaluate next).
        self.p, self.t = torch.zeros_like(x0), zf
        self.phi_0 = self.dphi_0 = self.a_i1 = self.phi_i1 = self.dphi_i1 = zf
        self.a_star = self.phi_star = self.dphi_star = zf
        self.g_star = torch.zeros_like(x0)
        self.i, self.ls_nfev, self.ls_done, self.ls_failed = zi, zi, zb, zb
        # Zoom.
        self.in_zoom, self.z_done, self.z_failed, self.j = zb, zb, zb, zi
        self.a_lo = self.phi_lo = self.dphi_lo = self.a_hi = self.phi_hi = zf
        self.dphi_hi = self.a_rec = self.phi_rec = zf
        self.za_star = self.zphi_star = self.zdphi_star = zf
        self.zg_star = torch.zeros_like(x0)

    def _set(self, mask, **values):
        """``state.name = where(mask, value, state.name)`` for each value."""
        for name, v in values.items():
            old = getattr(self, name)
            m = mask.reshape(mask.shape + (1,) * (old.dim() - mask.dim()))
            setattr(self, name, torch.where(m, v, old))

    def running(self) -> torch.Tensor:
        return ~self.converged & ~self.failed & (self.k < self.maxiter)

    def start_line_search(self, m):
        """Lanes ``m`` begin a BFGS iteration: its line search's state, and
        its first step as the next request."""
        p = -(self.H @ self.g.unsqueeze(-1)).squeeze(-1)
        dphi_0 = _dot(self.g, p)
        cand = 1.01 * 2 * (self.f - self.old_old_fval) / dphi_0
        start = torch.where(cand > 1, torch.ones_like(cand), cand)
        zero = torch.zeros_like(self.f)
        self._set(m, p=p, phi_0=self.f, dphi_0=dphi_0, i=torch.ones_like(self.i), a_i1=zero,
                  phi_i1=self.f, dphi_i1=dphi_0, a_star=zero, phi_star=self.f,
                  dphi_star=dphi_0, g_star=self.g, ls_nfev=torch.zeros_like(self.i),
                  ls_done=torch.zeros_like(m), ls_failed=torch.zeros_like(m),
                  in_zoom=torch.zeros_like(m), t=start)

    def _wolfe_one(self, a, phi):  # the negation of W1
        return phi > self.phi_0 + self.c1 * a * self.dphi_0

    def _wolfe_two(self, dphi):
        return torch.abs(dphi) <= -self.c2 * self.dphi_0

    def line_search_step(self, m, phi, dphi, g):
        """One iteration of JAX's ``line_search`` body for lanes ``m``, at
        their step ``t``. Returns the lanes whose line search ended."""
        a_i = self.t
        to_zoom1 = self._wolfe_one(a_i, phi) | ((phi >= self.phi_i1) & (self.i > 1))
        to_i = self._wolfe_two(dphi) & ~to_zoom1
        to_zoom2 = (dphi >= 0.0) & ~to_zoom1 & ~to_i
        zin = m & (to_zoom1 | to_zoom2)
        # zoom1 brackets [a_i1, a_i], zoom2 [a_i, a_i1].
        z1 = to_zoom1
        a_lo = torch.where(z1, self.a_i1, a_i)
        phi_lo = torch.where(z1, self.phi_i1, phi)
        dphi_lo = torch.where(z1, self.dphi_i1, dphi)
        a_hi = torch.where(z1, a_i, self.a_i1)
        phi_hi = torch.where(z1, phi, self.phi_i1)
        dphi_hi = torch.where(z1, dphi, self.dphi_i1)
        self._set(zin, in_zoom=zin, z_done=torch.zeros_like(m), z_failed=torch.zeros_like(m),
                  j=torch.zeros_like(self.j), a_lo=a_lo, phi_lo=phi_lo, dphi_lo=dphi_lo,
                  a_hi=a_hi, phi_hi=phi_hi, dphi_hi=dphi_hi, a_rec=(a_lo + a_hi) / 2.0,
                  phi_rec=(phi_lo + phi_hi) / 2.0, za_star=torch.ones_like(a_lo),
                  zphi_star=phi_lo, zdphi_star=dphi_lo, zg_star=self.g)
        star = m & to_i
        self._set(star, a_star=a_i, phi_star=phi, dphi_star=dphi, g_star=g,
                  ls_done=torch.ones_like(m))
        self._set(m, ls_nfev=self.ls_nfev + 1, i=self.i + 1, a_i1=a_i, phi_i1=phi,
                  dphi_i1=dphi)
        cont = m & ~zin & ~star & (self.i <= self.ls_maxiter)
        self._set(cont, t=a_i * 2.0)
        self.zoom_request(zin)
        return m & ~zin & ~cont

    def zoom_request(self, m):
        """The first half of JAX's ``_zoom`` body for lanes ``m``: the
        bracket check and the next trial step (cubic, quadratic or
        bisection), as the next request."""
        dalpha = self.a_hi - self.a_lo
        a = torch.minimum(self.a_hi, self.a_lo)
        b = torch.maximum(self.a_hi, self.a_lo)
        cchk = 0.2 * dalpha
        qchk = 0.1 * dalpha
        a_j_cubic = _cubicmin(self.a_lo, self.phi_lo, self.dphi_lo, self.a_hi, self.phi_hi,
                              self.a_rec, self.phi_rec)
        use_cubic = (self.j > 0) & (a_j_cubic > a + cchk) & (a_j_cubic < b - cchk)
        a_j_quad = _quadmin(self.a_lo, self.phi_lo, self.dphi_lo, self.a_hi, self.phi_hi)
        use_quad = ~use_cubic & (a_j_quad > a + qchk) & (a_j_quad < b - qchk)
        a_j_bisection = (self.a_lo + self.a_hi) / 2.0
        use_bisection = ~use_cubic & ~use_quad
        a_j = torch.where(use_cubic, a_j_cubic, self.a_rec)
        a_j = torch.where(use_quad, a_j_quad, a_j)
        a_j = torch.where(use_bisection, a_j_bisection, a_j)
        # A collapsed bracket stops the search once this step is evaluated.
        self._set(m, z_failed=self.z_failed | (dalpha <= self.threshold), t=a_j)

    def zoom_step(self, m, phi_j, dphi_j, g_j):
        """The second half of the ``_zoom`` body for lanes ``m``, at their
        step ``t``. Returns the lanes whose zoom, and line search, ended."""
        a_j = self.t
        hi_to_j = self._wolfe_one(a_j, phi_j) | (phi_j >= self.phi_lo)
        star_to_j = self._wolfe_two(dphi_j) & ~hi_to_j
        hi_to_lo = (dphi_j * (self.a_hi - self.a_lo) >= 0.0) & ~hi_to_j & ~star_to_j
        lo_to_j = ~hi_to_j & ~star_to_j
        # hi_to_j: the bracket's high end moves to a_j (rec <- old hi);
        # hi_to_lo: it moves to the low end (rec <- old hi); else lo_to_j:
        # rec <- old lo. lo_to_j then moves the low end to a_j.
        moved = hi_to_j | hi_to_lo
        self._set(m & star_to_j, za_star=a_j, zphi_star=phi_j, zdphi_star=dphi_j, zg_star=g_j)
        self._set(
            m,
            a_hi=torch.where(hi_to_j, a_j, torch.where(hi_to_lo, self.a_lo, self.a_hi)),
            phi_hi=torch.where(hi_to_j, phi_j, torch.where(hi_to_lo, self.phi_lo, self.phi_hi)),
            dphi_hi=torch.where(hi_to_j, dphi_j,
                                torch.where(hi_to_lo, self.dphi_lo, self.dphi_hi)),
            a_rec=torch.where(moved, self.a_hi, torch.where(lo_to_j, self.a_lo, self.a_rec)),
            phi_rec=torch.where(moved, self.phi_hi,
                                torch.where(lo_to_j, self.phi_lo, self.phi_rec)),
            a_lo=torch.where(lo_to_j, a_j, self.a_lo),
            phi_lo=torch.where(lo_to_j, phi_j, self.phi_lo),
            dphi_lo=torch.where(lo_to_j, dphi_j, self.dphi_lo),
            z_done=self.z_done | star_to_j, j=self.j + 1, ls_nfev=self.ls_nfev + 1)
        self._set(m, z_failed=self.z_failed | (self.j >= 30))
        end = m & (self.z_done | self.z_failed)
        self._set(end, in_zoom=torch.zeros_like(m), ls_done=torch.ones_like(m),
                  ls_failed=self.ls_failed | self.z_failed, a_star=self.za_star,
                  phi_star=self.zphi_star, dphi_star=self.zdphi_star, g_star=self.zg_star)
        self.zoom_request(m & ~end)
        return end

    def update(self, m):
        """The BFGS update of lanes ``m``, whose line search ended; returns
        those that go on to another iteration."""
        status = torch.where(self.ls_failed, 1, torch.where(self.i > self.ls_maxiter, 3, 0))
        alpha = self.a_star
        if alpha.dtype != torch.float64:
            # Too small a step gets the optimizer stuck below 64 bits.
            alpha = torch.where(alpha.abs() < 1e-8, torch.sign(alpha) * 1e-8, alpha)
        s = alpha.unsqueeze(-1) * self.p
        y = self.g_star - self.g
        rho = torch.reciprocal(_dot(y, s))
        w = self.eye - rho[:, None, None] * (s.unsqueeze(-1) * y.unsqueeze(-2))
        H = w @ self.H @ w.mT + rho[:, None, None] * (s.unsqueeze(-1) * s.unsqueeze(-2))
        H = torch.where(torch.isfinite(rho)[:, None, None], H, self.H)
        self._set(m, nfev=self.nfev + self.ls_nfev, failed=self.ls_failed | ~self.ls_done,
                  ls_status=status, converged=self.g_star.abs().amax(-1) < self.gtol,
                  k=self.k + 1, old_old_fval=self.f, x=self.x + s, f=self.phi_star,
                  g=self.g_star, H=H)
        return m & self.running()


def minimize_bfgs(
    fun: Objective,
    x0: torch.Tensor,
    maxiter: int | None = None,
    gtol: float = 1e-5,
    line_search_maxiter: int = 10,
    lane_chunk: int | None = None,
) -> BFGSResult:
    """Minimize ``fun`` from each row of ``x0`` (``[L, d]``) by BFGS
    (Nocedal & Wright algorithm 6.1), with JAX's defaults: ``gtol`` on the
    inf-norm of the gradient, 10 line-search iterations, ``maxiter``
    200 * d.

    ``fun(x, lanes)`` maps points ``[k, d]`` to values ``[k]``, where the
    rows are the lanes ``lanes`` (a slice) of the batch.
    """
    if line_search_maxiter < 1:
        raise ValueError("line_search_maxiter must be at least 1")
    L, d = x0.shape
    if maxiter is None:
        maxiter = d * 200
    x0 = x0.detach()
    f, g = value_and_grad(fun, x0, lane_chunk)
    s = _Lanes(x0, f, g, maxiter, gtol, line_search_maxiter)
    busy = s.running()
    s.start_line_search(busy)
    while bool(busy.any()):
        phi, g = value_and_grad(fun, s.x + s.t.unsqueeze(-1) * s.p, lane_chunk)
        dphi = _dot(g, s.p)
        zooming = busy & s.in_zoom
        ended = s.line_search_step(busy & ~zooming, phi, dphi, g)
        ended = ended | s.zoom_step(zooming, phi, dphi, g)
        again = s.update(ended)
        s.start_line_search(again)
        busy = (busy & ~ended) | again

    status = torch.where(s.converged, 0, torch.where(
        s.k == maxiter, 1, torch.where(s.failed, 2 + s.ls_status, -1)))
    return BFGSResult(x=s.x, success=s.converged & ~s.failed, status=status, fun=s.f, jac=s.g,
                      hess_inv=s.H, nfev=s.nfev, njev=s.nfev, nit=s.k)
