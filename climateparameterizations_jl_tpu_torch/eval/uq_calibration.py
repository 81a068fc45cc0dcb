"""Post-hoc calibration of deep-ensemble predictive bands (numpy and scipy).

The port's own copy of ``climateparameterizations_jl_tpu/eval/uq_calibration.py``
(the port imports nothing of the JAX package). Deep ensembles are
typically under-dispersed: the JAX package measured its flagship K = 4/8
ensembles' 2-sigma coverage at 0.78-0.87 against the nominal 0.95. A scalar
variance inflation is fit on a held-out VALIDATION simulation and applied
unchanged to the test simulations:

- ``fit_inflation_nll``: Gaussian maximum likelihood. With ``z = (truth -
  mean) / std`` the per-cell standardized errors, the MLE of a scalar
  inflation ``std' = lam * std`` is ``lam = sqrt(mean(z^2))``.
- ``fit_inflation_coverage``: empirical-quantile matching, ``lam =
  q_{0.95}(|z|) / 1.959964``: the inflated 2-sigma band covers exactly the
  nominal fraction of the validation cells.

``band_report`` scores any Gaussian band (ensemble spread, GP posterior
sigma) with one metric set.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# 97.5th percentile of the standard normal: the 2-sigma band's half-width in
# standard units (P(|z| <= 1.959964) = 0.95).
_Z_95 = 1.959964


def standardized_errors(truth, mean, std, eps: float = 1e-12) -> np.ndarray:
    """Per-cell ``z = (truth - mean) / std`` with a floor on ``std``.

    Degenerate cells (std == 0, e.g. identical members at the anchored
    initial frame) are floored rather than dropped so the z-statistics stay
    aligned with the coverage counts.
    """
    truth, mean, std = (np.asarray(a, np.float64) for a in (truth, mean, std))
    return (truth - mean) / np.maximum(std, eps)


def fit_inflation_nll(z) -> float:
    """Gaussian-MLE scalar inflation: ``lam = sqrt(mean(z^2))``."""
    z = np.asarray(z, np.float64)
    return float(np.sqrt(np.mean(z * z)))


def fit_inflation_coverage(z, nominal: float = 0.95) -> float:
    """Quantile-matching inflation: the ``nominal`` quantile of ``|z|``
    divided by the Gaussian band half-width for that nominal level."""
    z = np.abs(np.asarray(z, np.float64))
    from scipy.stats import norm

    half_width = norm.ppf(0.5 + nominal / 2.0)
    return float(np.quantile(z, nominal) / half_width)


def coverage(truth, mean, std, n_sigma: float = _Z_95) -> float:
    """Fraction of cells with ``|truth - mean| <= n_sigma * std``."""
    truth, mean, std = (np.asarray(a, np.float64) for a in (truth, mean, std))
    return float(np.mean(np.abs(truth - mean) <= n_sigma * std))


def spread_skill(truth, mean, std) -> float | None:
    """Pearson r between predicted spread and actual |error| per cell
    (None when either is degenerate — corrcoef of a constant is 0/0)."""
    truth, mean, std = (np.asarray(a, np.float64) for a in (truth, mean, std))
    err = np.abs(truth - mean).ravel()
    sd = std.ravel()
    if float(sd.std()) == 0.0 or float(err.std()) == 0.0:
        return None
    return float(np.corrcoef(sd, err)[0, 1])


@dataclasses.dataclass(frozen=True)
class BandCalibration:
    """A fitted scalar variance inflation (both fitting rules recorded)."""

    lam_nll: float
    lam_coverage: float
    nominal: float = 0.95
    floor: float = 1.0

    @property
    def lam(self) -> float:
        """The inflation applied downstream: the coverage-matching fit,
        floored at ``floor`` (the NLL fit is recorded beside it).

        The floor defaults to 1.0: only inflate. The JAX package measured
        (its ``docs/gp_at_scale_r4.json``) that where the validation sim
        over-covers, the quantile fit shrinks the bands and the shrink
        transfers badly to a harder held-out sim (2-sigma coverage 0.74 ->
        0.49 against the nominal 0.95), while an inflation transfers
        safely. Pass ``floor=0.0`` for the unfloored fit.
        """
        return max(self.lam_coverage, self.floor)


def fit_band_calibration(truth, mean, std, nominal: float = 0.95,
                         floor: float = 1.0) -> BandCalibration:
    """Fit both inflation rules on one validation sim's bands."""
    z = standardized_errors(truth, mean, std)
    return BandCalibration(
        lam_nll=fit_inflation_nll(z),
        lam_coverage=fit_inflation_coverage(z, nominal),
        nominal=nominal,
        floor=floor,
    )


def band_report(truth, mean, std, lam: float = 1.0, nominal: float = 0.95) -> dict:
    """Coverage / width / spread-skill of (possibly inflated) Gaussian bands.

    The one schema both UQ families (deep-ensemble spread, GP posterior
    sigma) are scored with.
    """
    from scipy.stats import norm

    n_sigma = float(norm.ppf(0.5 + nominal / 2.0))
    std_eff = np.asarray(std, np.float64) * lam
    return {
        "coverage": coverage(truth, mean, std_eff, n_sigma),
        "mean_band": float(np.mean(n_sigma * std_eff)),
        "spread_skill_r": spread_skill(truth, mean, std_eff),
        "lam": float(lam),
        "nominal": nominal,
    }
