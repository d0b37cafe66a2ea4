"""The physics anchors through the port, in float64 on the CPU, at the JAX
package's own sizes and limits: the second harmonic of a finite-amplitude
plane wave against Fubini (``tests/test_westervelt_fubini.py``, 2%) and
two-layer transmission against T_p = 2 Z2 / (Z1 + Z2)
(``tests/test_transmission.py``, 3%).  The card runs them in float32
(``chip_smoke.py`` phase 33)."""

import numpy as np
import torch

from fustpu_torch.demos import anchors

torch.set_num_threads(1)


def test_second_harmonic_matches_fubini():
    """A quasi-1D lossless Westervelt plane wave (rigid side walls, an
    absorbing far end): the second harmonic at x = 12 mm within 2% of the
    Fubini amplitude for the sigma inferred from the measured fundamental,
    genuinely nonlinear (0.15 < sigma < 0.9, B2 / B1 > 5%)."""
    r = anchors.fubini(torch.float64, "cpu")
    assert 0.15 < r["sigma"] < 0.9, r
    assert r["rel"] < anchors.FUBINI_TOL, r
    assert r["B2"] / r["B1"] > 0.05, r


def test_two_layer_transmission_matches_analytic():
    """A CW plane wave through the impedance step Z1 -> Z2 at normal
    incidence: the amplitude in medium 2 within 3% of T_p p0, with T_p
    more than 10% above unity."""
    r = anchors.transmission(torch.float64, "cpu")
    assert r["dev"] < anchors.TRANSMISSION_TOL, r
    assert abs(r["T_p"] - 1.0) > 0.1
    assert np.isfinite(r["amp"])
