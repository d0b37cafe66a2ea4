"""Westervelt nonlinear wave equation.

Coefficient recipes:

    steady LHS    m0 = (1/(rho c^2)) u v dx + (delta/(rho c^3)) u v ds(abs)
    unsteady LHS  m  = m0 - (2 beta/(rho^2 c^4)) u_n u v dx     (per stage)
    RHS b = -(1/rho) grad(u_n).grad(v) dx
            - (delta/(rho c^2)) grad(v_n).grad(v) dx
            + (2 beta/(rho^2 c^4)) v_n^2 v dx
            + (g(t)/rho) v ds(src) + (delta dg(t)/(rho c^2)) v ds(src)
            - (v_n/(rho c)) v ds(abs)
    dv/dt = b / m

Per RK stage one stiffness apply: in uniform media the two stiffness terms
fold into A(c3 u + c4 v) since the operator is linear and the coefficients
are scalars; in heterogeneous media the pair kernel applies
A_c3(u) + A_c4(v) in one pass with a unit G (in the corner-streamed
capacity mode, ``stiffness_impl="pallas_corner"``, with the coefficient
channel 1: the JAX package's two folded corner operators as one pair
apply).  Every mass-type term is a precomputed diagonal.  Counterpart of the structured, extruded and
indexed branches of ``fustpu/models/westervelt.py``: on an imported mesh
the stiffness is the extruded operator (prismatic) or the indexed one (any
other), the rest is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from fustpu_torch.config import Material, Source
from fustpu_torch.models import sources
from fustpu_torch.models.base import WaveModelBase
from fustpu_torch.models.discretization import (CORNER_IMPLS,
                                                ENGINE_IMPL,
                                                INDEXED_IMPL,
                                                Discretization,
                                                stiffness_module)
from fustpu_torch.ops import vector as vec


class WesterveltModel(WaveModelBase):
    DEFAULT_CFL = 0.4
    VECTORS = ("m0", "mvec2", "s1_cos", "s2_cos", "s1_sin", "s2_sin",
               "fvec")

    def __init__(
        self,
        mesh,
        material: Material,
        source: Source,
        source_facets: np.ndarray,
        absorbing_facets: np.ndarray | None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
        source_delays=None,
        source_apodization=None,
        stiffness_impl: str = "auto",
        setup_device=None,
    ):
        """`source_delays` / `source_apodization`: optional per-node
        phased-aperture profiles (callable(points)->array or (nf, n^2)
        arrays).  `device`: the card ('cuda', the default) or 'cpu'.
        `stiffness_impl`: 'auto' (the CUDA kernels on a CUDA device, the
        plain version elsewhere), 'mm' (the plain version) or
        'pallas_corner' / 'extruded_pallas_corner' (the corner-streamed
        capacity mode on a box or an extruded mesh, kernel or plain
        version by device as for 'auto'; a general mesh takes the indexed
        operator) or 'indexed_engine' (the staged gather / contract /
        scatter engine on an imported mesh; the pair form gathers both
        fields in one pass) or 'indexed' (the fused indexed kernel on any
        mesh, a box or a prismatic import too), or the JAX package's names
        'pallas' and 'extruded_pallas' (as 'auto') and 'extruded' (the
        plain version on a prismatic import; `resolve_stiffness_impl`).
        `setup_device`: where the geometry, facet and diagonal set-up
        runs: the model's device (None: the set-up kernels on the card)
        or 'cpu' (the host's float64 numpy, uploaded)."""
        super().__init__()
        self._setup(mesh, material, source, source_facets, dtype, device,
                    stiffness_impl, setup_device)
        disc = Discretization(mesh, self.setup_device)
        self.disc = disc
        c, rho, beta, _ = material.cell_fields(self.cell_shape)
        delta = self._delta
        self.stiffness = stiffness_module(disc.stiffness_op(
            dtype, self.device,
            pair=None if self.uniform else self._pair_coeffs,
            corner=stiffness_impl in CORNER_IMPLS,
            engine=stiffness_impl == ENGINE_IMPL,
            indexed=stiffness_impl == INDEXED_IMPL), self.impl)

        # unsteady mass diagonal: mass(u; -nl) = u * mvec2 (and the v^2 RHS
        # term uses +nl, i.e. exactly -mvec2)
        nl = 2.0 * beta / (rho * rho * c**4)
        vecs = {"mvec2": disc.mass_diag(-nl)}
        # steady LHS m0 (+ absorbing-facet delta term), float64
        m0 = disc.mass_diag(1.0 / (rho * c * c))
        if absorbing_facets is not None and len(absorbing_facets) > 0:
            blk = disc.facet_block(absorbing_facets)
            cells = blk.cells
            m0 = m0 + disc.facet_diag(
                blk, (delta / (rho * c**3)).reshape(-1)[cells])
            vecs["fvec"] = disc.facet_diag(
                blk, (-1.0 / (rho * c)).reshape(-1)[cells])
        vecs["m0"] = m0

        # source boundary: g/dg time-separable -> precomputed vectors (a
        # cos/sin pair each for phased apertures)
        src_block = disc.facet_block(source_facets)
        apod, phi = sources.resolve_profiles(
            disc, src_block, source.angular_frequency, source_delays,
            source_apodization)
        scells = src_block.cells
        f1 = (1.0 / rho).reshape(-1)[scells]
        f2 = (delta / (rho * c * c)).reshape(-1)[scells]
        if phi is None:
            vecs["s1_cos"] = disc.facet_diag(src_block, f1, apod)
            vecs["s2_cos"] = disc.facet_diag(src_block, f2, apod)
        else:
            cw = np.cos(phi) if apod is None else apod * np.cos(phi)
            sw = np.sin(phi) if apod is None else apod * np.sin(phi)
            vecs["s1_cos"] = disc.facet_diag(src_block, f1, cw)
            vecs["s1_sin"] = disc.facet_diag(src_block, f1, sw)
            vecs["s2_cos"] = disc.facet_diag(src_block, f2, cw)
            vecs["s2_sin"] = disc.facet_diag(src_block, f2, sw)
        self._load_vectors(vecs)

    def _coefficients(self) -> None:
        c, rho, _, _ = self.material.cell_fields(self.cell_shape)
        self._delta = np.broadcast_to(np.asarray(
            self.material.diffusivity_of_sound(
                self.source.angular_frequency), np.float64), self.cell_shape)
        # the two stiffness coefficients -1/rho and -delta/(rho c^2)
        self._pair_coeffs = (-1.0 / rho, -self._delta / (rho * c * c))
        self.c3_scalar = self.c4_scalar = None
        if self.uniform:
            self.c3_scalar = -1.0 / float(rho.flat[0])
            self.c4_scalar = (-float(self._delta.flat[0])
                              / float((rho * c * c).flat[0]))

    # ------------------------------------------------------------------
    def _rhs(self, t: float, u: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
        """kv = M(u)^{-1} b(t, u, v) on flat vectors.  `b` is a fresh
        tensor (the apply's output), so the updates below are in place."""
        g = self.mesh.grid_shape
        m = torch.addcmul(self.m0, u, self.mvec2)   # unsteady diagonal LHS
        if self.uniform:
            x = torch.add(u * self.c3_scalar, v, alpha=self.c4_scalar)
            b = self.stiffness(x.reshape(g)).reshape(-1)
        else:
            b = self.stiffness.pair(u.reshape(g), v.reshape(g)).reshape(-1)
        b.sub_(vec.square(v) * self.mvec2)          # + nl * v^2 mass term
        (g_c, g_s), (dg_c, dg_s) = sources.westervelt_source_coeffs(
            t, self.source, self.c_src)
        vec.axpy_(g_c, self.s1_cos, b)
        vec.axpy_(dg_c, self.s2_cos, b)
        if self.s1_sin is not None:
            vec.axpy_(g_s, self.s1_sin, b)
            vec.axpy_(dg_s, self.s2_sin, b)
        if self.fvec is not None:
            b.addcmul_(v, self.fvec)
        return vec.pointwise_divide(b, m)           # the diagonal solve
