"""Linear second-order wave equation with windowed velocity source and
first-order absorbing boundary.

Weak form:

    LHS  m  = (1/(rho c^2)) u v dx                        (diagonal)
    RHS  b  = -(1/rho) grad(u_n).grad(v) dx
              + (g(t)/rho) v ds(Gamma_src)
              - (v_n/(rho c)) v ds(Gamma_abs)
    du/dt = v ;  dv/dt = b / m

Per RK stage: one stiffness apply plus elementwise updates (the mass LHS,
the source vectors and the absorbing facet term are precomputed
diagonals).  Counterpart of the structured, extruded and indexed
branches of ``fustpu/models/linear.py``: on an imported mesh the stiffness
is the extruded operator (prismatic) or the indexed one (any other), the
rest is the same.  The per-cell -1/rho of a heterogeneous medium is folded
into G at build time on every mesh kind (the JAX package's indexed path
multiplies it in its kernel instead), except on the staged engine
(``stiffness_impl="indexed_engine"``), whose contraction applies it as the
JAX package's does.
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


class LinearWaveModel(WaveModelBase):
    DEFAULT_CFL = 0.65
    VECTORS = ("m", "s_cos", "s_sin", "fvec")

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
        """`source_delays`: optional per-node delay profile tau(x) for a
        phased (focused) aperture, a callable(points (N,3)) -> tau (N,) or
        an (nf, n^2) array.  `source_apodization`: optional amplitude
        profile, same convention.  `device`: the card ('cuda', the
        default) or 'cpu'.  `stiffness_impl`: 'auto' (the CUDA kernel on
        a CUDA device, the plain version elsewhere), 'mm' (the plain
        version) or 'pallas_corner' / 'extruded_pallas_corner' (the
        corner-streamed capacity mode on a box or an extruded mesh, kernel
        or plain version by device as for 'auto'; a general mesh takes
        the indexed operator) or 'indexed_engine' (the staged gather /
        contract / scatter engine on an imported mesh, the per-cell -1/rho
        applied in its contraction) or 'indexed' (the fused indexed kernel
        on any mesh, a box or a prismatic import too), or the JAX
        package's names 'pallas' and 'extruded_pallas' (as 'auto') and
        'extruded' (the plain version on a prismatic import;
        `resolve_stiffness_impl`).  `setup_device`: where the geometry,
        facet and diagonal set-up runs: the model's device (None: the
        set-up kernels on the card) or 'cpu' (the host's float64 numpy,
        uploaded)."""
        super().__init__()
        self._setup(mesh, material, source, source_facets, dtype, device,
                    stiffness_impl, setup_device)
        disc = Discretization(mesh, self.setup_device)
        self.disc = disc
        c, rho, _, _ = material.cell_fields(self.cell_shape)
        # stiffness coefficient -1/rho: a scalar applied to the output for
        # uniform media, folded into G (or the coefficient channel)
        # otherwise
        self.stiffness = stiffness_module(disc.stiffness_op(
            dtype, self.device, coeff=None if self.uniform else -1.0 / rho,
            corner=stiffness_impl in CORNER_IMPLS,
            engine=stiffness_impl == ENGINE_IMPL,
            indexed=stiffness_impl == INDEXED_IMPL), self.impl)

        vecs = {"m": disc.mass_diag(1.0 / (rho * c * c))}
        # source boundary: the g(t) facet term reduces to precomputed
        # diagonal vector(s): one for a plain aperture, a cos/sin pair for a
        # phased one (see fustpu_torch.models.sources)
        src_block = disc.facet_block(source_facets)
        fcoeff = 1.0 / rho.reshape(-1)[src_block.cells]
        apod, phi = sources.resolve_profiles(
            disc, src_block, source.angular_frequency, source_delays,
            source_apodization)
        if phi is None:
            vecs["s_cos"] = disc.facet_diag(src_block, fcoeff, apod)
        else:
            cw = np.cos(phi) if apod is None else apod * np.cos(phi)
            sw = np.sin(phi) if apod is None else apod * np.sin(phi)
            vecs["s_cos"] = disc.facet_diag(src_block, fcoeff, cw)
            vecs["s_sin"] = disc.facet_diag(src_block, fcoeff, sw)
        # absorbing boundary: -(1/(rho c)) v_n v ds, a facet diagonal
        if absorbing_facets is not None and len(absorbing_facets) > 0:
            blk = disc.facet_block(absorbing_facets)
            rc = (rho * c).reshape(-1)[blk.cells]
            vecs["fvec"] = disc.facet_diag(blk, -1.0 / rc)
        self._load_vectors(vecs)

    def _coefficients(self) -> None:
        rho = self.material.cell_fields(self.cell_shape)[1]
        self.c2_scalar = -1.0 / float(rho.flat[0]) if self.uniform else None

    # ------------------------------------------------------------------
    def _rhs(self, t: float, u: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
        """kv = M^{-1} b(t, u, v) on flat vectors.  `b` is a fresh tensor
        (the apply's output), so the updates below are in place."""
        g = self.mesh.grid_shape
        b = self.stiffness(u.reshape(g)).reshape(-1)
        if self.uniform:
            b.mul_(self.c2_scalar)
        a_c, a_s = sources.linear_source_coeffs(t, self.source, self.c_src)
        vec.axpy_(a_c, self.s_cos, b)
        if self.s_sin is not None:
            vec.axpy_(a_s, self.s_sin, b)
        if self.fvec is not None:
            b.addcmul_(v, self.fvec)
        return vec.pointwise_divide(b, self.m)     # the diagonal solve
