"""Flagship: H131-class focused transducer at ~100 W in water, Westervelt
nonlinear propagation (1.1 MHz, beta = 3.5, alpha = 0.2 dB/m, source
velocity 0.3856 m/s, every boundary facet outside the aperture absorbing).

Bowl realisations (--geometry):
- `conformal` (default): a body-fitted spherical-cap mesh; the x- face of a
  deformed box is morphed onto the H131 cap and the transducer is a
  constant-velocity source on the curved patch;
- `phased`: flat aperture with per-node focus delays;
- `unstructured`: the conformal mesh exported as a tagged Gmsh .msh file
  (tag 1 = bowl cap, tag 2 = absorbing) and imported again, the workflow
  of a Gmsh-built transducer mesh; the import detects as prismatic
  (extruded along x) and runs the extruded stiffness kernels.  `--mesh`
  imports a given tagged .msh instead;
- `bodyfit`: the same round trip of a genuinely non-prismatic mesh (the
  conformal bowl with its interior nodes clustered toward the focal axis,
  so no lattice axis is an extrusion), the workflow of an arbitrary
  Gmsh body-fitted mesh: the import keeps the general mesh, ordered by
  `locality_order`, and runs the indexed stiffness kernels.
H131 geometry: aperture radius 16 mm, focal length 35 mm.  `--two-layer`
adds a soft-tissue layer past x = 20 mm (heterogeneous Westervelt, the
pair stiffness kernel).  `--stiffness-impl pallas_corner` runs the
corner-streamed capacity mode (the corner kernels on the conformal, phased
and unstructured bowls; the bodyfit bowl has no corner form and keeps the
indexed kernels).

    python -m fustpu_torch.demos.nonlinear_bowl [--elements N] [--degree P]
        [--geometry conformal|phased|unstructured|bodyfit]
        [--mesh file.msh] [--stiffness-impl auto|pallas_corner]
        [--two-layer] [--device cuda|cpu]
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.common import (check_device, demo_argparser,
                                       pick_dtype, run_demo)
from fustpu_torch.mesh import msh_io
from fustpu_torch.mesh.box import build_box_mesh, build_mapped_mesh
from fustpu_torch.mesh.extruded import ExtrudedHexMesh
from fustpu_torch.models import sources
from fustpu_torch.models.discretization import IndexedStiffness
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.utils import eval as fev


def bowl_mapping(focal_length, aperture_radius, yc, zc, Lx):
    """Morph the x- face onto the spherical cap x_s(r) = F - sqrt(F^2-r^2)
    (apex at the origin, rim towards the focus), tapering the displacement
    to zero by x = Lx/2 and beyond ~1.4 aperture radii."""

    def mapping(p):
        q = p.copy()
        r = np.sqrt((p[:, 1] - yc) ** 2 + (p[:, 2] - zc) ** 2)
        rc = np.minimum(r, aperture_radius)
        sag = focal_length - np.sqrt(focal_length**2 - rc**2)
        # smooth radial taper beyond the aperture
        t = np.clip((1.4 * aperture_radius - r) / (0.4 * aperture_radius),
                    0.0, 1.0)
        decay = np.clip(1.0 - 2.0 * p[:, 0] / Lx, 0.0, 1.0)
        q[:, 0] = p[:, 0] + sag * t * decay
        return q

    return mapping


def bodyfit_mapping(focal_length, aperture_radius, yc, zc, Lx, Lt):
    """A non-prismatic body-fitted bowl: the cap sag of `bowl_mapping`
    composed with a transverse clustering of nodes toward the focal axis
    whose strength varies along x (peaked mid-domain, zero at the cap plane
    and the domain end).  The domain, its boundary faces and the cap are
    those of the conformal mesh; only interior nodes move, and no lattice
    axis is an extrusion any more."""

    def mapping(p):
        # cluster first (vanishes on every boundary face), then sag
        q = p.copy()
        cx = np.sin(np.pi * np.clip(p[:, 0] / Lx, 0.0, 1.0)) ** 2
        for ax, c in ((1, yc), (2, zc)):
            s = np.sin(np.pi * np.clip(p[:, ax] / Lt, 0.0, 1.0)) ** 2
            q[:, ax] = p[:, ax] - 0.12 * (p[:, ax] - c) * s * cx
        return bowl_mapping(focal_length, aperture_radius, yc, zc,
                            Lx)(q)

    return mapping


def parser():
    p = demo_argparser(degree=6, periods=8.0)
    p.add_argument("--geometry",
                   choices=["conformal", "phased", "unstructured",
                            "bodyfit"],
                   default="conformal",
                   help="unstructured = export the conformal bowl mesh to "
                        "a tagged Gmsh .msh file and import it again; "
                        "bodyfit = the same round trip of a non-prismatic "
                        "body-fitted bowl (the indexed kernels)")
    p.add_argument("--mesh", default="",
                   help="pre-built tagged .msh (tag 1 = bowl cap, tag 2 = "
                        "absorbing); implies unstructured")
    p.add_argument("--two-layer", action="store_true",
                   help="water -> soft-tissue layer (c=1560, rho=1045) "
                        "past x=20 mm: heterogeneous Westervelt, the pair "
                        "stiffness kernel")
    p.add_argument("--stiffness-impl", default="auto",
                   choices=["auto", "pallas_corner"],
                   help="auto = the G-stream kernels; pallas_corner = the "
                        "corner-streamed capacity mode (either runs its "
                        "plain version on the CPU)")
    return p


def problem(args) -> SimpleNamespace:
    """The bowl problem of the parsed arguments, before any model: mesh,
    material, source, aperture and absorbing facets, delay profile, focus
    point and domain length.  A caller may replace the mesh (e.g. by the
    same geometry carried as hex27) before `build`."""
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    source_velocity = 0.38557513826589934        # m/s (100 W drive)
    amplitude = mat.density * mat.sound_speed * source_velocity
    src = Source(frequency=1.1e6, amplitude=amplitude)

    domain_length = 0.08                         # m
    aperture_radius = 0.016                      # H131: 32 mm aperture
    focal_length = 0.035                         # H131: 35 mm focus
    Lt = 0.05                                    # transverse extent
    wavelength = mat.sound_speed / src.frequency
    nex = args.elements or int(2 * domain_length / wavelength)
    net = max(8, int(round(nex * Lt / domain_length / 8)) * 8)
    yc = zc = Lt / 2
    focus = np.array([focal_length, yc, zc])
    in_aperture = lambda c: ((c[:, 1] - yc) ** 2
                             + (c[:, 2] - zc) ** 2) < aperture_radius**2
    if args.mesh:
        args.geometry = "unstructured"
    mesh = None                  # a supplied .msh needs no generated mesh
    if args.geometry == "phased":
        mesh = build_box_mesh((nex, net, net), args.degree,
                              hi=(domain_length, Lt, Lt))
    elif not args.mesh:
        t0 = time.perf_counter()
        mapping = (bodyfit_mapping(focal_length, aperture_radius, yc, zc,
                                   domain_length, Lt)
                   if args.geometry == "bodyfit" else
                   bowl_mapping(focal_length, aperture_radius, yc, zc,
                                domain_length))
        mesh = build_mapped_mesh((nex, net, net), args.degree, mapping,
                                 hi=(domain_length, Lt, Lt))
        print(f"host: mapped mesh {time.perf_counter() - t0:.1f} s")
    if args.geometry in ("unstructured", "bodyfit"):
        mesh = import_bowl(args, mesh, in_aperture)
        aperture = mesh.boundary_facets(1)
        absorbing = mesh.boundary_facets(2)
    else:
        aperture = mesh.boundary_facets("x-", predicate=in_aperture)
        # absorbing on every boundary facet except the source aperture
        absorbing = np.concatenate(
            [mesh.boundary_facets("x-",
                                  predicate=lambda c: ~in_aperture(c))]
            + [mesh.boundary_facets(p) for p in
               ["x+", "y-", "y+", "z-", "z+"]])
    delays = (None if args.geometry != "phased" else
              (lambda pts: sources.focus_delays(pts, focus, 1480.0)))
    return SimpleNamespace(mesh=mesh, material=mat, source=src,
                           aperture=aperture, absorbing=absorbing,
                           delays=delays, focus=focus,
                           domain_length=domain_length)


def build(args, pb: SimpleNamespace | None = None):
    """(model, dt, number of steps, focus point) for the parsed arguments,
    on the problem `pb` (`problem(args)` when not given)."""
    pb = problem(args) if pb is None else pb
    mesh, mat, src, aperture = pb.mesh, pb.material, pb.source, pb.aperture
    print(f"degree {args.degree}, {args.geometry} bowl, "
          f"Number of degrees-of-freedom: {mesh.ndofs}")
    if len(aperture) == 0:
        raise SystemExit("aperture selected no facets: increase --elements "
                         "so facet centroids resolve the 16 mm radius")
    print(f"aperture facets: {len(aperture)}")
    if args.two_layer:
        cent = mesh.cell_corners_flat.mean(axis=1)
        tissue = cent[:, 0] > 0.02
        shape = mesh.nc if hasattr(mesh, "nc") else (mesh.num_cells,)
        mat = Material(
            sound_speed=np.where(tissue, 1560.0, 1480.0).reshape(shape),
            density=np.where(tissue, 1045.0, 1000.0).reshape(shape),
            nonlinearity=3.5, attenuation_dB=0.2)
        print(f"two-layer medium (interface x=20 mm, "
              f"{int(tissue.sum())} tissue cells)")
    t0 = time.perf_counter()
    model = WesterveltModel(mesh, mat, src, aperture, pb.absorbing,
                            dtype=pick_dtype(args.dtype), device=args.device,
                            source_delays=pb.delays,
                            stiffness_impl=args.stiffness_impl)
    steps = ", ".join(f"{k} {v:.1f} s"
                      for k, v in model.disc.host_seconds.items())
    print(f"host: model set-up {time.perf_counter() - t0:.1f} s "
          f"({steps or 'no geometry pass'})")
    print(f"stiffness: {type(model.stiffness).__name__}, kernel "
          f"{model.stiffness_kernel}")
    if isinstance(model.stiffness, IndexedStiffness):
        print(f"indexed scatter: {len(model.stiffness.bounds) - 1} colour "
              f"classes over {mesh.num_cells} cells")
    dt, _ = model.cfl_dt(0.4)
    tf = (pb.domain_length / float(np.min(mat.sound_speed))
          + args.periods / src.frequency)
    nsteps = int(tf / dt) + 1
    print(f"Number of steps: {nsteps}")
    return model, dt, nsteps, pb.focus


def import_bowl(args, box_mesh, in_aperture):
    """Export `box_mesh` (the conformal or bodyfit bowl) as a tagged .msh
    file and import it again, or import `args.mesh` when given.  The
    import detects a prismatic mesh as an ExtrudedHexMesh and keeps any
    other as a general mesh in `locality_order`; the bodyfit bowl must not
    detect as an extrusion."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        if args.mesh:
            mesh_file = args.mesh
        else:
            cap = box_mesh.boundary_facets("x-", predicate=in_aperture)
            other = np.concatenate(
                [box_mesh.boundary_facets(
                    "x-", predicate=lambda c: ~in_aperture(c))]
                + [box_mesh.boundary_facets(p) for p in
                   ["x+", "y-", "y+", "z-", "z+"]])
            mesh_file = msh_io.export_box_msh(
                box_mesh, {1: cap, 2: other}, str(Path(workdir) / "bowl"))
        t1 = time.perf_counter()
        mesh = msh_io.read_msh(mesh_file, degree=args.degree)
    print(f"host: .msh export {t1 - t0:.1f} s, import (extrusion "
          f"detection, locality_order) {time.perf_counter() - t1:.1f} s")
    if args.geometry == "bodyfit" and isinstance(mesh, ExtrudedHexMesh):
        raise SystemExit("bodyfit mesh unexpectedly detected as an "
                         "extrusion")
    kind = ("extruded" if isinstance(mesh, ExtrudedHexMesh)
            else "general (non-prismatic)")
    print(f"mesh: {Path(mesh_file).name} ({mesh.num_cells} hex cells, "
          f"imported, {kind})")
    if isinstance(mesh, ExtrudedHexMesh):
        print(f"extrusion: axis {mesh.axis}, {mesh.nstacks} stacks, "
              f"{mesh.nz} layers, {mesh.n2d} rows")
    return mesh


def focal_pressure(model, state, focus) -> float:
    """The pressure (u) at the focus, evaluated on the host."""
    u = state.u.detach().cpu().double().numpy()
    if hasattr(model.mesh, "nc"):
        return float(fev.evaluate(model.mesh, u, focus[None, :])[0])
    return float(model.mesh.evaluate(u, focus[None, :])[0])


def main(argv=None):
    args = parser().parse_args(argv)
    check_device(args)
    model, dt, nsteps, focus = build(args)
    state = run_demo(model, dt, nsteps, args, "nonlinear_bowl")
    p = focal_pressure(model, state, focus)
    print(f"pressure at focus: {p:.1f} Pa")
    return model, state, p


if __name__ == "__main__":
    main()
