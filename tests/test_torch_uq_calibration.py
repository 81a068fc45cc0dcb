"""Port parity: band calibration (``eval/uq_calibration.py``), the port's copy against the JAX module.

The counterparts of ``tests/test_uq_calibration.py``. Both modules are numpy
and scipy, so every function returns the same float, checked for equality
(``==``), on the reference suite's synthetic bands: the truth drawn with a
spread ``understate`` times the predicted one.
"""

import numpy as np
import pytest

from climateparameterizations_jl_tpu.eval import uq_calibration as juq
from climateparameterizations_jl_tpu_torch.eval import uq_calibration as tuq


def _gaussian_bands(rng, n=20000, understate=2.0):
    mean = rng.normal(size=n)
    std_pred = 0.1 + rng.uniform(size=n)
    truth = mean + understate * std_pred * rng.standard_normal(n)
    return truth, mean, std_pred


@pytest.mark.parametrize("understate", [0.4, 1.0, 1.7, 2.0])
def test_fits_equal_jax(understate):
    rng = np.random.default_rng(int(understate * 10))
    bands = _gaussian_bands(rng, understate=understate)
    z_t, z_j = tuq.standardized_errors(*bands), juq.standardized_errors(*bands)
    np.testing.assert_array_equal(z_t, z_j)
    assert tuq.fit_inflation_nll(z_t) == juq.fit_inflation_nll(z_j)
    assert tuq.fit_inflation_coverage(z_t) == juq.fit_inflation_coverage(z_j)
    assert tuq.fit_inflation_coverage(z_t, 0.68) == juq.fit_inflation_coverage(z_j, 0.68)
    for floor in (1.0, 0.0):
        t, j = tuq.fit_band_calibration(*bands, floor=floor), juq.fit_band_calibration(*bands, floor=floor)
        assert (t.lam_nll, t.lam_coverage, t.nominal, t.floor, t.lam) == (j.lam_nll, j.lam_coverage, j.nominal,
                                                                         j.floor, j.lam)
    for lam in (1.0, 2.5):
        assert tuq.band_report(*bands, lam=lam) == juq.band_report(*bands, lam=lam)
    assert tuq.coverage(*bands) == juq.coverage(*bands)
    assert tuq.spread_skill(*bands) == juq.spread_skill(*bands)


def test_recovers_understatement():
    rng = np.random.default_rng(0)
    truth, mean, std = _gaussian_bands(rng, understate=2.0)
    assert 1.9 < tuq.fit_inflation_nll(tuq.standardized_errors(truth, mean, std)) < 2.1
    assert 1.85 < tuq.fit_inflation_coverage(tuq.standardized_errors(truth, mean, std)) < 2.15


def test_only_inflate_floor_and_transfer():
    rng = np.random.default_rng(7)
    val = _gaussian_bands(rng, understate=0.4)
    test = _gaussian_bands(rng, understate=1.0)
    unfloored, floored = tuq.fit_band_calibration(*val, floor=0.0), tuq.fit_band_calibration(*val)
    assert floored.lam == 1.0 and unfloored.lam == unfloored.lam_coverage < 0.6
    assert tuq.band_report(*test, lam=unfloored.lam)["coverage"] < 0.7
    assert tuq.band_report(*test, lam=floored.lam)["coverage"] > 0.93


def test_before_after_on_held_out():
    rng = np.random.default_rng(5)
    cal = tuq.fit_band_calibration(*_gaussian_bands(rng, understate=2.0))
    truth, mean, std = _gaussian_bands(rng, understate=2.0)
    before, after = tuq.band_report(truth, mean, std), tuq.band_report(truth, mean, std, lam=cal.lam)
    assert before["coverage"] < 0.75 and abs(after["coverage"] - 0.95) < 0.02
    assert after["mean_band"] == pytest.approx(before["mean_band"] * cal.lam, rel=1e-12)
    assert after["spread_skill_r"] == pytest.approx(before["spread_skill_r"], rel=1e-9)


def test_degenerate_cases():
    truth = np.zeros(10)
    assert tuq.spread_skill(truth, truth, np.ones(10)) is None
    truth, mean, std = np.array([0.0, 3.0]), np.array([0.0, 0.0]), np.array([0.0, 1.0])
    assert np.isfinite(tuq.standardized_errors(truth, mean, std)[0])
    assert tuq.coverage(truth, mean, std) == juq.coverage(truth, mean, std) == 0.5
