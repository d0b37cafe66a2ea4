"""The physics anchors of the port: a finite-amplitude plane wave's second
harmonic against Fubini, and two-layer transmission against the normal-
incidence pressure coefficient, each on a quasi-1D box (rigid side walls,
so the wave stays plane).  Counterpart of the JAX package's anchor tests
``tests/test_westervelt_fubini.py`` and ``tests/test_transmission.py``,
at their sizes and limits; the CPU tests run them in float64, the card in
float32.

    python -m fustpu_torch.demos.anchors [--device cuda|cpu]
        [--dtype f32|f64]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.common import add_device_args, check_device, pick_dtype
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.utils.eval import PointSampler

FUBINI_TOL = 0.02          # the JAX package's limit (it measured 0.04%)
TRANSMISSION_TOL = 0.03    # the JAX package's limit


def bessel_j(n: int, x: float, terms: int = 30) -> float:
    """J_n(x) by its series (x is O(1) here)."""
    s, fact_m, fact_mn = 0.0, 1.0, float(math.factorial(n))
    for m in range(terms):
        s += (-1) ** m / (fact_m * fact_mn) * (x / 2.0) ** (2 * m + n)
        fact_m *= (m + 1)
        fact_mn *= (m + 1 + n)
    return s


def _trace(model, mesh, point, nsteps: int, dt: float) -> np.ndarray:
    pfn = PointSampler(mesh, np.array([point])).torch_probe(model.device)
    _, ys = model.solve(model.init_state(), dt, nsteps,
                        probe=lambda s: pfn(s.u))
    return ys.double().cpu().numpy()[:, 0]


def fubini(dtype: torch.dtype, device) -> dict:
    """A lossless Westervelt plane wave (1 MHz, beta 5, p0 1.5 MPa, 18 mm at
    4 cells a wavelength, P = 4): the harmonic amplitudes B1, B2 of the
    probe at 12 mm over its last two periods, sigma inferred from B1
    (B1 = 2 p0 J1(sigma) / sigma, sigma = x beta omega p0 / (rho c^3)),
    the Fubini B2 for it and their relative difference `rel`."""
    c0, rho, beta, f0 = 1500.0, 1000.0, 5.0, 1.0e6
    omega = 2 * np.pi * f0
    p0, L, probe_x = 1.5e6, 0.018, 0.012
    mat = Material(sound_speed=c0, density=rho, nonlinearity=beta,
                   attenuation_dB=0.0)
    src = Source(frequency=f0, amplitude=p0, window_periods=2.0)
    nx = int(round(4 * L / (c0 / f0)))
    h = L / nx
    mesh = build_box_mesh((nx, 1, 1), 4, hi=(L, h, h))
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.boundary_facets("x+"), dtype=dtype,
                            device=device)
    dt, spp = model.cfl_dt(0.4)
    t_need = probe_x / c0 + (src.window_periods + 3.0) * src.period
    nsteps = (int(t_need / dt) // spp + 2) * spp
    w = _trace(model, mesh, [probe_x, h / 2, h / 2], nsteps, dt)[-2 * spp:]
    spec = np.abs(np.fft.rfft(w)) / w.size * 2
    B1, B2 = spec[2], spec[4]          # 2 periods: harmonic n at bin 2n
    K = probe_x * beta * omega / (rho * c0**3)
    sigma = K * B1
    for _ in range(20):
        p0_eff = B1 * sigma / (2 * bessel_j(1, sigma))
        sigma = K * p0_eff
    B2_pred = 2 * p0_eff * bessel_j(2, 2 * sigma) / (2 * sigma)
    return dict(B1=float(B1), B2=float(B2), B2_pred=float(B2_pred),
                sigma=float(sigma), rel=float(abs(B2 - B2_pred) / B2_pred),
                steps=nsteps)


def transmission(dtype: torch.dtype, device) -> dict:
    """A 0.5 MHz CW plane wave from water into c = 1800, rho = 1100 at the
    middle of a 12-wavelength box (48 cells, P = 4): the largest |p| in
    medium 2 (x = 3L/4) after the ramped front has passed and before the
    interface echo returns, against T_p p0; `dev` their relative
    difference."""
    c1, rho1, c2, rho2 = 1500.0, 1000.0, 1800.0, 1100.0
    Z1, Z2 = rho1 * c1, rho2 * c2
    T_p = 2.0 * Z2 / (Z1 + Z2)
    f0, p0, nx = 0.5e6, 60000.0, 48
    L = 12.0 * c1 / f0
    h = L / nx
    mesh = build_box_mesh((nx, 1, 1), 4, hi=(L, h, h))
    cs = np.full(mesh.nc, c1)
    cs[nx // 2:] = c2
    rho = np.full(mesh.nc, rho1)
    rho[nx // 2:] = rho2
    src = Source(frequency=f0, amplitude=p0, window_periods=2.0)
    model = LinearWaveModel(mesh, Material(sound_speed=cs, density=rho), src,
                            mesh.boundary_facets("x-"),
                            mesh.boundary_facets("x+"), dtype=dtype,
                            device=device)
    dt, _ = model.cfl_dt(0.4)
    xp = 0.75 * L
    t_front = ((L / 2) / c1 + (xp - L / 2) / c2
               + (src.window_periods + 1.0) * src.period)
    t_echo = 1.5 * L / c1 + (xp - L / 2) / c2
    nsteps = int(t_echo / dt)
    ys = _trace(model, mesh, [xp, h / 2, h / 2], nsteps, dt)
    amp = float(np.abs(ys[int(t_front / dt):]).max())
    return dict(amp=amp, T_p=T_p, expected=T_p * p0,
                dev=abs(amp - T_p * p0) / (T_p * p0), steps=nsteps,
                window=t_echo - t_front, period=src.period)


def main(argv=None) -> dict:
    p = add_device_args(argparse.ArgumentParser())
    args = p.parse_args(argv)
    check_device(args)
    dtype = pick_dtype(args.dtype)
    fb = fubini(dtype, args.device)
    print(f"Fubini: B1 {fb['B1']:.6e}, B2 {fb['B2']:.6e} Pa against "
          f"{fb['B2_pred']:.6e} (sigma {fb['sigma']:.4f}): {fb['rel']:.4%} "
          f"(limit {FUBINI_TOL:.0%}), {fb['steps']} steps")
    tr = transmission(dtype, args.device)
    print(f"transmission: |p| {tr['amp']:.6e} Pa against T_p p0 "
          f"{tr['expected']:.6e} (T_p {tr['T_p']:.6f}): {tr['dev']:.4%} "
          f"(limit {TRANSMISSION_TOL:.0%}), {tr['steps']} steps")
    return {"fubini": fb, "transmission": tr}


if __name__ == "__main__":
    main()
