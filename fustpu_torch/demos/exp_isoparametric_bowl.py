"""Trilinear against isoparametric (hex27) bowl-cap geometry: the focal
pressure's difference.  The same Westervelt bowl runs twice on the
unstructured form (`from_box`) of the mapped lattice: once with the
trilinear corner geometry, once with the conformal map sampled at each
cell's 27-node lattice (`geom_nodes`, a curved triquadratic cell).  Both
meshes are prismatic, so `as_extruded` takes them and the card runs the
stack kernel #6 (``csrc/extruded_stack.cu``), the second with the curved
cells' G stream.  Prints the focal probe's min p and max |p| of each run
and the max |p| delta.

    python -m fustpu_torch.demos.exp_isoparametric_bowl [--elements 24]
        [--degree 4] [--periods 2] [--frequency 0.3e6]
        [--device cpu] [--dtype f32|f64]

Counterpart of ``demos/exp_isoparametric_bowl.py``, with its arguments;
`build` and `run` are its two halves, for callers that time or check each
run.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.common import (add_device_args, check_device, clock,
                                       pick_dtype)
from fustpu_torch.demos.nonlinear_bowl import bowl_mapping
from fustpu_torch.elements.hex import hex8_tabulate
from fustpu_torch.mesh.box import build_box_mesh, build_mapped_mesh
from fustpu_torch.mesh.extruded import as_extruded
from fustpu_torch.mesh.unstructured import UPointSampler, from_box
from fustpu_torch.models.westervelt import WesterveltModel

DOMAIN_LENGTH, LT = 0.08, 0.05
APERTURE_RADIUS, FOCAL_LENGTH = 0.016, 0.035
# the 27-node lattice of the unit cell, in the hex27 order 9i + 3j + k
_LAT = np.array([[i / 2, j / 2, k / 2] for i in range(3)
                 for j in range(3) for k in range(3)])


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--elements", type=int, default=24)
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--periods", type=float, default=2.0)
    p.add_argument("--frequency", type=float, default=0.3e6,
                   help="source frequency; 0.3 MHz resolves the wave (more "
                        "than 2 cells a wavelength) at --elements 24 (1.1 "
                        "MHz needs --elements >= 56)")
    return add_device_args(p)


def meshes(elements: int, degree: int) -> dict:
    """{"trilinear", "hex27"}: the unstructured mapped lattice with corner
    geometry, and the same with the conformal map sampled at each cell's
    27-node lattice (the parameter cell's trilinear lattice pushed through
    the map)."""
    yc = zc = LT / 2
    ne = elements
    nc = (ne, int(round(ne * LT / DOMAIN_LENGTH)) or 1,
          int(round(ne * LT / DOMAIN_LENGTH)) or 1)
    mapping = bowl_mapping(FOCAL_LENGTH, APERTURE_RADIUS, yc, zc,
                           DOMAIN_LENGTH)
    hi = (DOMAIN_LENGTH, LT, LT)
    um_tri = from_box(build_mapped_mesh(nc, degree, mapping, hi=hi))
    vals, _ = hex8_tabulate(_LAT)                    # (27, 8)
    pcorners = from_box(build_box_mesh(nc, degree, hi=hi)).cell_corners_flat
    lat = np.einsum("qv,cvd->cqd", vals, pcorners)
    geom = mapping(lat.reshape(-1, 3)).reshape(lat.shape)
    return {"trilinear": um_tri,
            "hex27": dataclasses.replace(um_tri, geom_nodes=geom)}


def facet_sets(um, nc0: int) -> tuple[np.ndarray, np.ndarray]:
    """(source, absorbing) facets from the exterior faces' centroids: the
    source the faces on the cap inside the aperture, every other face
    absorbing (the mesh carries no tags)."""
    yc = zc = LT / 2
    bd = um.boundary_facets()
    cent = um.facet_centroids(bd)
    r2 = (cent[:, 1] - yc) ** 2 + (cent[:, 2] - zc) ** 2
    on_xmin = cent[:, 0] < 0.25 * DOMAIN_LENGTH / nc0 + (
        FOCAL_LENGTH - np.sqrt(np.maximum(
            FOCAL_LENGTH**2 - np.minimum(r2, APERTURE_RADIUS**2), 0.0)))
    src = on_xmin & (r2 <= APERTURE_RADIUS**2)
    return bd[src], bd[~src]


def build(args) -> dict:
    """{name: SimpleNamespace(model, dt, steps, probe)} of the two runs on
    `args.device`, each on `as_extruded` of its mesh: the probe reads u at
    the focus each step."""
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    amplitude = mat.density * mat.sound_speed * 0.38557513826589934
    src = Source(frequency=args.frequency, amplitude=amplitude)
    pts = np.array([[FOCAL_LENGTH, LT / 2, LT / 2]])
    out = {}
    for name, um in meshes(args.elements, args.degree).items():
        um = as_extruded(um) or um
        srcf, absf = facet_sets(um, args.elements)
        model = WesterveltModel(um, mat, src, srcf, absf,
                                dtype=pick_dtype(args.dtype),
                                device=args.device)
        dt, _ = model.cfl_dt(0.4)
        tf = DOMAIN_LENGTH / mat.sound_speed + args.periods / src.frequency
        probe = UPointSampler(um, pts).torch_probe(args.device)
        out[name] = SimpleNamespace(model=model, dt=dt,
                                    steps=int(np.ceil(tf / dt)),
                                    probe=lambda s, p=probe: p(s.u))
    return out


def run(case, steps: int | None = None) -> tuple:
    """(final state, the focal probe's trace (steps, 1) float64 on the
    host) of one `build` case, over its steps (or the first `steps`)."""
    state, ys = case.model.solve(case.model.init_state(), case.dt,
                                 case.steps if steps is None else steps,
                                 probe=case.probe)
    return state, ys.detach().cpu().double().numpy()


def main(argv=None) -> dict:
    """Returns {name: trace} and the delta (`delta`, of the hex27 value)."""
    args = parser().parse_args(argv)
    check_device(args)
    cases = build(args)
    out = {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        _, ys = run(case)
        st = case.model.stiffness
        print(f"{name}: {type(st).__name__} kernel {st.kernel} "
              f"steps={case.steps} wall={time.perf_counter() - t0:.1f}s "
              f"focal min p={ys.min() / 1e6:.4f} MPa "
              f"max |p|={np.abs(ys).max() / 1e6:.4f} MPa", flush=True)
        out[name] = ys
    pk_t = np.abs(out["trilinear"]).max()
    pk_q = np.abs(out["hex27"]).max()
    out["delta"] = (pk_q - pk_t) / pk_q
    print(f"focal |p| delta (hex27 vs trilinear): {out['delta']:+.3%} of "
          f"the quadratic value; timed by {clock(args.device)}")
    return out


if __name__ == "__main__":
    main()
