"""Tree-structured Parzen Estimator suggestion algorithm.

Port of ``dss_ml_at_scale_tpu/hpo/tpe.py``, the reference's
``tpe.suggest``: a NumPy implementation of the TPE idea (Bergstra et al.
2011). Completed trials split into "good" (best gamma-quantile) and "bad";
each group's density per parameter is a Parzen (Gaussian-mixture)
estimator in latent space; candidates drawn from the good model are
ranked by good(x)/bad(x), the expected-improvement surrogate. The
arithmetic and the order of the generator's draws are the JAX package's,
so a seeded generator proposes the same points.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .space import Param, iter_params


@dataclasses.dataclass
class TPE:
    n_startup_trials: int = 10
    gamma: float = 0.25
    n_candidates: int = 24
    prior_weight: float = 1.0

    def suggest(self, space, history, rng: np.random.Generator) -> dict:
        """Propose the next point.

        ``history``: sequence of ``(point_dict, loss)`` for completed
        trials (failed trials excluded by the caller). Non-finite losses
        are additionally dropped here: a single NaN would poison the
        argsort that splits good/bad (NaN compares false with
        everything, so the quantile split becomes arbitrary) and an Inf
        would skew the split point — a diverged trial must not steer
        the surrogate, whatever store produced the history.
        """
        params = iter_params(space)
        history = [
            (point, loss)
            for point, loss in history
            if loss is not None and math.isfinite(loss)
        ]
        if len(history) < self.n_startup_trials:
            return {p.label: p.sample(rng) for p in params}

        losses = np.array([loss for _, loss in history], float)
        n_good = max(1, int(math.ceil(self.gamma * len(losses))))
        good_idx = np.argsort(losses)[:n_good]
        good_mask = np.zeros(len(losses), bool)
        good_mask[good_idx] = True

        out = {}
        for p in params:
            obs = np.array(
                [p.to_latent(point[p.label]) for point, _ in history], float
            )
            good, bad = obs[good_mask], obs[~good_mask]
            if p.kind == "choice":
                out[p.label] = self._suggest_categorical(p, good, bad, rng)
            else:
                out[p.label] = p.from_latent(
                    self._suggest_numeric(p, good, bad, rng)
                )
        return out

    # -- numeric params: Parzen estimator in latent space ----------------

    def _suggest_numeric(
        self, p: Param, good: np.ndarray, bad: np.ndarray, rng
    ) -> float:
        lo, hi = p.latent_bounds
        prior_mu, prior_sigma = self._prior(p)

        good_mix = self._mixture(good, prior_mu, prior_sigma)
        bad_mix = self._mixture(bad, prior_mu, prior_sigma)
        cands = self._sample_mixture(good_mix, lo, hi, rng)
        score_good = self._log_pdf_mixture(cands, good_mix)
        score_bad = self._log_pdf_mixture(cands, bad_mix)
        return float(cands[np.argmax(score_good - score_bad)])

    def _prior(self, p: Param) -> tuple[float, float]:
        lo, hi = p.latent_bounds
        if math.isfinite(lo) and math.isfinite(hi):
            return (lo + hi) / 2.0, (hi - lo)
        # normal/lognormal: latent prior is the declared Gaussian
        return float(p.args[0]), float(p.args[1])

    def _bandwidths(self, mus: np.ndarray, prior_sigma: float) -> np.ndarray:
        """Adaptive per-component widths: distance to neighbouring points,
        floored to keep the mixture from collapsing."""
        if len(mus) == 1:
            return np.array([prior_sigma])
        order = np.argsort(mus)
        sorted_mus = mus[order]
        gaps = np.diff(sorted_mus)
        left = np.concatenate([[gaps[0]], gaps])
        right = np.concatenate([gaps, [gaps[-1]]])
        widths_sorted = np.maximum(left, right)
        floor = prior_sigma / max(10.0, len(mus))
        widths_sorted = np.clip(widths_sorted, floor, prior_sigma)
        widths = np.empty_like(widths_sorted)
        widths[order] = widths_sorted
        return widths

    def _mixture(self, mus, prior_mu, prior_sigma):
        """Observations + prior as one Parzen mixture (mus, sigmas, weights)."""
        bw = self._bandwidths(mus, prior_sigma) if len(mus) else np.empty(0)
        mus_all = np.concatenate([mus, [prior_mu]])
        sigmas_all = np.concatenate([bw, [prior_sigma]])
        weights = np.concatenate([np.ones(len(mus)), [self.prior_weight]])
        return mus_all, sigmas_all, weights / weights.sum()

    def _sample_mixture(self, mix, lo, hi, rng):
        mus_all, sigmas_all, weights = mix
        comp = rng.choice(len(mus_all), size=self.n_candidates, p=weights)
        z = rng.normal(mus_all[comp], sigmas_all[comp])
        return np.clip(z, lo, hi)

    def _log_pdf_mixture(self, x, mix):
        mus_all, sigmas_all, weights = mix
        x = x[:, None]
        log_comp = (
            -0.5 * ((x - mus_all[None, :]) / sigmas_all[None, :]) ** 2
            - np.log(sigmas_all[None, :] * math.sqrt(2 * math.pi))
            + np.log(weights[None, :])
        )
        m = log_comp.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(log_comp - m).sum(axis=1, keepdims=True))).ravel()

    # -- categorical params: smoothed frequency ratio ---------------------

    def _suggest_categorical(self, p: Param, good, bad, rng) -> int:
        n = p.n_choices
        good_counts = np.bincount(good.astype(int), minlength=n) + self.prior_weight
        bad_counts = np.bincount(bad.astype(int), minlength=n) + self.prior_weight
        p_good = good_counts / good_counts.sum()
        p_bad = bad_counts / bad_counts.sum()
        # Sample candidates from the good distribution, keep best ratio.
        cands = rng.choice(n, size=min(self.n_candidates, 4 * n), p=p_good)
        return int(cands[np.argmax(p_good[cands] / p_bad[cands])])


_DEFAULT = TPE()


def tpe_suggest(space, history, rng) -> dict:
    """Default-config TPE (the ``tpe.suggest`` equivalent)."""
    return _DEFAULT.suggest(space, history, rng)


def random_suggest(space, history, rng) -> dict:
    """Pure random search (hyperopt's ``rand.suggest``)."""
    from .space import sample_space

    return sample_space(space, rng)
