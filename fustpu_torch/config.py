"""Central configuration: material and source constants, the RK4 tableau and
CFL step selection, as frozen dataclasses (numpy, float64).

Vendored from ``fustpu/config.py`` so that the port never imports the JAX
package; the values and formulas are the same.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def num_quad_points_1d(degree: int) -> int:
    """Collocated GLL quadrature: P+1 points per direction, so every
    quadrature point is a dof and the mass matrix is diagonal."""
    return degree + 1


# Classic RK4 Butcher tableau.
RK4_A = np.array([0.0, 0.5, 0.5, 1.0])
RK4_B = np.array([1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0])
RK4_C = np.array([0.0, 0.5, 0.5, 1.0])


@dataclasses.dataclass(frozen=True, eq=False)
class Material:
    """Material parameters: scalars for homogeneous media, or per-cell
    arrays (any shape broadcastable to mesh.nc) for heterogeneous media."""

    sound_speed: float | np.ndarray = 1500.0   # c0 [m/s]
    density: float | np.ndarray = 1000.0       # rho0 [kg/m^3]
    nonlinearity: float | np.ndarray = 0.0     # beta (Westervelt)
    attenuation_dB: float | np.ndarray = 0.0   # alpha [dB/m]

    @property
    def is_uniform(self) -> bool:
        return all(np.ndim(v) == 0 for v in
                   (self.sound_speed, self.density, self.nonlinearity,
                    self.attenuation_dB))

    def cell_fields(self, nc) -> tuple:
        """(c, rho, beta, alpha) broadcast to per-cell arrays of shape nc."""
        return tuple(np.broadcast_to(np.asarray(v, np.float64), nc)
                     for v in (self.sound_speed, self.density,
                               self.nonlinearity, self.attenuation_dB))

    def diffusivity_of_sound(self, angular_frequency: float):
        """delta = 2 c^3 alpha_Np / omega^2."""
        alpha_np = np.asarray(self.attenuation_dB) / 20.0 * math.log(10.0)
        if angular_frequency == 0.0:
            return np.zeros_like(alpha_np) if alpha_np.ndim else 0.0
        delta = (2.0 * alpha_np * np.asarray(self.sound_speed) ** 3
                 / angular_frequency**2)
        return delta if delta.ndim else float(delta)


@dataclasses.dataclass(frozen=True)
class Source:
    """Windowed sinusoidal velocity source on the source boundary:
    g(t) = window(t) * amplitude * omega / c * cos(omega t), with a Hann
    window ramp over `window_periods` periods."""

    frequency: float = 0.5e6           # f0 [Hz]
    amplitude: float = 60000.0         # p0 [Pa]
    window_periods: float = 4.0        # Hann ramp length in periods

    @property
    def period(self) -> float:
        return 1.0 / self.frequency

    @property
    def angular_frequency(self) -> float:
        return 2.0 * math.pi * self.frequency


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    """CFL-based step selection, snapped so a period is an integer number of
    steps."""

    cfl: float = 0.65
    start_time: float = 0.0
    final_time: float = 1.0e-5

    def step_size(self, hmin: float, sound_speed: float, degree: int,
                  period: float) -> tuple[float, int]:
        dt = self.cfl * hmin / (sound_speed * degree**2)
        steps_per_period = int(period / dt) + 1
        dt = period / steps_per_period
        return dt, steps_per_period

    def num_steps(self, dt: float) -> int:
        return int((self.final_time - self.start_time) / dt) + 1
