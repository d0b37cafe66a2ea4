"""Time-dependent boundary source terms.

The source fields are time-separable, g(t) times a precomputed facet
vector, so each RK stage needs only scalar coefficients.  The stage time is
known on the host, so they are computed here as Python float64 scalars:
no device work and no synchronisation.  Counterpart of
``fustpu/models/sources.py``.
"""

from __future__ import annotations

import math

import numpy as np

from fustpu_torch.config import Source


def hann_window(t: float, source: Source) -> tuple[float, float]:
    """window(t) ramps 0 -> 1 over `window_periods` periods; and its time
    derivative."""
    alpha = source.window_periods
    f = source.frequency
    if t < alpha / f:
        arg = f * math.pi * t / alpha
        return (0.5 * (1.0 - math.cos(arg)),
                0.5 * math.pi * f / alpha * math.sin(arg))
    return 1.0, 0.0


# ---------------------------------------------------------------------------
# Phased (focused) sources.  A per-node delay tau(x) makes the source field
# g(t - tau(x)); because it is time-separable,
#   cos(omega (t - tau)) = cos(omega t) cos(phi) + sin(omega t) sin(phi),
# phi = omega tau, the facet-mass contribution splits into two precomputed
# diagonal vectors (built with cos(phi) / sin(phi) node weights) times the
# scalar coefficients below.  (The window w(t) is not delayed per node, which
# is exact once t > tau + ramp.)
# ---------------------------------------------------------------------------

def linear_source_coeffs(t: float, source: Source, sound_speed: float):
    """(alpha_cos, alpha_sin): source term = a_c * s_cos + a_s * s_sin."""
    w, _ = hann_window(t, source)
    omega = source.angular_frequency
    K = source.amplitude * omega / sound_speed
    return w * K * math.cos(omega * t), w * K * math.sin(omega * t)


def westervelt_source_coeffs(t: float, source: Source, sound_speed: float):
    """((g_c, g_s), (dg_c, dg_s)) coefficients for the g and dg terms."""
    w, dw = hann_window(t, source)
    omega = source.angular_frequency
    K = 2.0 * source.amplitude * omega / sound_speed
    c_, s_ = math.cos(omega * t), math.sin(omega * t)
    g_c, g_s = w * K * c_, w * K * s_
    dg_c = dw * K * c_ - w * K * omega * s_
    dg_s = dw * K * s_ + w * K * omega * c_
    return (g_c, g_s), (dg_c, dg_s)


def resolve_profiles(disc, block, omega: float, delays, apod):
    """Normalise user-supplied delay/apodisation profiles (callables over
    facet-node coordinates or (nf, n^2) arrays) into node-weight arrays:
    returns (apod_weights (nf,n^2) or None, phase phi = omega*tau or None)."""
    pts = None
    if callable(delays) or callable(apod):
        pts = disc.facet_points(block).reshape(-1, 3)
    shape = tuple(block.dofmap.shape)

    def norm(p):
        if p is None:
            return None
        if callable(p):
            return np.asarray(p(pts)).reshape(shape)
        return np.broadcast_to(np.asarray(p, np.float64), shape)

    tau = norm(delays)
    a = norm(apod)
    return a, (None if tau is None else omega * tau)


def focus_delays(points, focus, sound_speed: float):
    """Delays tau(x) >= 0 so all wavelets arrive at `focus` in phase: a
    spherical-cap (bowl) transducer emulated by a flat phased aperture."""
    r = np.linalg.norm(np.asarray(points) - np.asarray(focus), axis=-1)
    return (r.max() - r) / sound_speed
