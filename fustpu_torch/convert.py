"""Move operator data and solver state from the JAX package's layouts into
the port's.

The functions take numpy arrays (``np.asarray`` of the JAX package's pytree
leaves) and never see a JAX object.  A bfloat16 model's arrays are
``ml_dtypes`` arrays there; every array goes through float64 (the cast
the array's own dtype provides, exact for bfloat16 values) before it
becomes a tensor, so the port's bfloat16 tensors equal the JAX package's
bit for bit without this package importing ``ml_dtypes``.

- `stiffness_from_fustpu` accepts the arrays of a matmul-form operator
  (``MMStiffness``: W, Dt, G (6, ex, ey, ez)), of the fused-kernel operator
  (``PallasStiffness``: G (ncx, n, 6, ey, ez) and ``D_host``) or of its
  pair form (``PallasStiffnessPair``: plus C (ncx, 2, ncy, ncz)), and
  returns the port's (cells, 6, n^3) G, D and per-cell coefficients.  For
  an imported prismatic mesh (given its row ids) it accepts the arrays of
  the einsum-form ``operators.ExtrudedStiffness`` (G6 (6, ns, n, n, ez)
  and D), of the fused-kernel ``PallasExtruded`` (Gt (n^2, 6, ns_pad, ez)
  and ``statics[0]`` as D) and of ``PallasExtrudedPair`` (plus ce
  (2, ns_pad, ez)), and returns G, coefficients and C in stack order
  (cell s * nz + kz).  For a non-prismatic imported mesh (given its
  dofmap) it accepts the arrays of ``Discretization.indexed_op`` (G
  (6, cells, n^3), D) and of the fused engine's ``FusedEngine`` (G6p
  (6, cellsp, 128) and D3p (3, 128, 128)), and returns G, coefficients and
  C in mesh cell order.
- `corner_from_fustpu` accepts the arrays of the corner-streamed
  operators of the capacity mode (``PallasStiffnessCorner``: JC
  (ncx, 37, ncy, ncz), or the heterogeneous Westervelt model's pair of
  them; ``PallasExtrudedCorner``: the identity-padded T
  (nch+1, ns_pad, nz) and ce (2, ns_pad, ez)), and returns the port's
  (cells, nch+1) channels and pair coefficients.
- `slab2_from_fustpu` / `slab2w_from_fustpu` accept the arrays of the
  experimental two-slab operators (``PallasStiffness2``: G2
  (ncx2, n, 6, ey, 2, ezp), lane-padded halves; ``PallasStiffness2W``: G2
  (ncx2, n, 6, ey, 2 ez), slab i beside slab ncx2 + i; both with
  ``statics`` (D, ncx, ez) and a zero-G ghost slab for odd ncx) and return
  the port's ``ops.slab2.Slab2Stiffness``.
- `windows_from_fustpu` accepts the windowed layout of
  ``Discretization.G_s`` / ``detJ_s`` ((ncx, n, ncy, n, ncz, n[, 6])) and
  returns it as a tensor of the port's ``ops.operators``.
- `model_from_fustpu` builds a port model whose buffers are a JAX model's
  ``params`` (no host assembly) and moves an ``RKState`` across; an indexed
  model's params can build the port's staged engine
  (``stiffness_impl="indexed_engine"``, in bfloat16 too: a bf16 engine
  model's G, D and per-cell coefficients bit for bit) as well as its
  indexed kernel.
- `sharded_state_from_fustpu` collects a JAX sharded model's distributed
  state into global host arrays, or into a port sharded model's per-rank
  state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.mesh.extruded import ExtrudedHexMesh
from fustpu_torch.mesh.unstructured import UnstructuredHexMesh
from fustpu_torch.models.discretization import ENGINE_IMPL, stiffness_module
from fustpu_torch.models.timestepping import RKState
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import slab2 as s2


class HostStiffness(NamedTuple):
    """Stiffness operator data in the kernel layout, float64 host."""

    G: np.ndarray                    # (cells, 6, n^3)
    D: np.ndarray                    # (n, n)
    coeff: np.ndarray | None         # (cells,) coefficient not yet in G
    C: np.ndarray | None             # (cells, 2) pair coefficients
    dofmap: np.ndarray | None = None  # (cells, n^3) of an indexed operator

    def to_device(self, dtype: torch.dtype, device, nc,
                  engine: bool = False):
        """The operator on `device`, any single coefficient folded into G.
        `nc`: cells per axis of a box mesh, or the imported mesh of an
        extruded or indexed operator.  `engine`: the staged engine's
        operator of an indexed one, its coefficient kept per cell."""
        if engine:
            if self.dofmap is None:
                raise ValueError("the staged engine needs an indexed "
                                 "operator (a dofmap)")
            return cen.from_host(self.dofmap, nc.ndofs, self.G, self.D,
                                 dtype, device, coeff=self.coeff, C=self.C)
        G = self.G if self.coeff is None else self.G * self.coeff[:, None,
                                                                 None]
        if isinstance(nc, ExtrudedHexMesh):
            return ce.from_host(nc, G, self.D, dtype, device, self.C)
        if self.dofmap is not None:
            return ci.from_host(self.dofmap, nc.ndofs, G, self.D, dtype,
                                device, self.C)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=device)
        return cs.CellStiffness(G=t(G), D=t(self.D), nc=tuple(nc),
                                C=None if self.C is None else t(self.C))


class HostCorner(NamedTuple):
    """Corner-streamed operator data in the kernel layout, float64 host."""

    T: np.ndarray                    # (cells, nch + 1) channels
    D: np.ndarray                    # (n, n)
    C: np.ndarray | None             # (cells, 2) pair coefficients

    def to_device(self, dtype: torch.dtype, device, nc):
        """The operator on `device`.  `nc`: cells per axis of a box mesh,
        or the extruded mesh."""
        build = (cc.from_host_extruded if isinstance(nc, ExtrudedHexMesh)
                 else cc.from_host_box)
        return build(nc, self.T, self.D, dtype, device, self.C)


def corner_from_fustpu(JC=None, *, D, T=None, C=None, ns=None
                       ) -> HostCorner:
    """JC: the (ncx, 37, ncy, ncz) channels of a PallasStiffnessCorner, or
    a pair of them (the heterogeneous Westervelt model's two folded
    operators, whose geometry channels agree: their coefficient channels
    become the pair coefficients).  T: the (nch+1, ns_pad, nz) channels of
    a PallasExtrudedCorner, with `ns` the mesh's stacks (the rest is
    identity padding) and C its ce (2, ns_pad, ez).  D: the 1D derivative
    matrix (``statics[0]``).  A bfloat16 corner model's arrays go through
    float64 like every other (exact), so that `HostCorner.to_device` in
    bfloat16 gives its channels and pair coefficients bit for bit."""
    D = np.asarray(D, np.float64)
    if T is not None:
        T = np.asarray(T, np.float64)[:, :ns]
        nz = T.shape[2]
        Tc = T.transpose(1, 2, 0).reshape(ns * nz, -1)
        if C is not None:
            C = np.asarray(C, np.float64)
            n = C.shape[2] // nz
            C = C[:, :ns, ::n].reshape(2, -1).T
        return HostCorner(T=np.ascontiguousarray(Tc), D=D,
                          C=None if C is None else np.ascontiguousarray(C))
    cells = lambda a: np.asarray(a, np.float64).transpose(0, 2, 3, 1
                                                          ).reshape(-1, 37)
    if isinstance(JC, (tuple, list)):
        T3, T4 = (cells(a) for a in JC)
        if not np.array_equal(T3[:, :36], T4[:, :36]):
            raise ValueError("the two corner operators' geometry differs")
        Tc = T3.copy()
        Tc[:, 36] = 1.0
        return HostCorner(T=Tc, D=D, C=np.stack([T3[:, 36], T4[:, 36]],
                                                axis=1))
    return HostCorner(T=np.ascontiguousarray(cells(JC)), D=D, C=None)


def _cells_from_expanded(a: np.ndarray, n: int) -> np.ndarray:
    """(ex, ey, ez) per-cell field repeated n-fold -> (cells,)."""
    return np.ascontiguousarray(np.asarray(a, np.float64)[::n, ::n, ::n]
                                ).reshape(-1)


def windows_from_fustpu(a, dtype: torch.dtype = torch.float64,
                        device="cpu") -> torch.Tensor:
    """The JAX package's windowed layout (`Discretization.G_s` (ncx, n,
    ncy, n, ncz, n, 6), `detJ_s` without the 6) as a tensor of the port's
    windowed operators (``ops.operators``), which take the same layout."""
    a = np.asarray(a, np.float64)
    if a.ndim not in (6, 7) or a.shape[1] != a.shape[3] or \
            a.shape[1] != a.shape[5] or a.shape[6:] not in ((), (6,)):
        raise ValueError(f"shape {a.shape}: expected the windowed layout "
                         "(ncx, n, ncy, n, ncz, n[, 6])")
    return torch.tensor(a, dtype=dtype, device=device)


def _cells_from_x(a: np.ndarray, n: int) -> np.ndarray:
    """(ns, 1, 1, ez) z-expanded per-cell field -> (cells,) stack order."""
    return np.ascontiguousarray(np.asarray(a, np.float64)[:, 0, 0, ::n]
                                ).reshape(-1)


def _extruded_from_fustpu(G, nc, D, C, coeff_e, c1_e, c2_e
                          ) -> HostStiffness:
    """The extruded layouts (see stiffness_from_fustpu); nc = (ns, nz)."""
    ns, nz = nc
    if G.ndim == 5:                                  # G6 (6, ns, n, n, ez)
        n = G.shape[2]
        Gc = G.reshape(6, ns, n, n, nz, n).transpose(1, 4, 0, 2, 3, 5)
        coeff = None if coeff_e is None else _cells_from_x(coeff_e, n)
        if c1_e is not None:
            C = np.stack([_cells_from_x(c1_e, n), _cells_from_x(c2_e, n)],
                         axis=1)
    elif G.ndim == 4:                                # Gt (n^2, 6, ns_pad, ez)
        n = int(round(G.shape[0] ** 0.5))
        Gc = G[:, :, :ns].reshape(n, n, 6, ns, nz, n).transpose(3, 4, 2, 0,
                                                                1, 5)
        coeff = None
        if C is not None:                            # ce (2, ns_pad, ez)
            C = np.asarray(C, np.float64)[:, :ns, ::n].reshape(2, -1).T
    else:
        raise ValueError(f"unrecognised extruded G of shape {G.shape}")
    Gc = np.ascontiguousarray(Gc).reshape(ns * nz, 6, n ** 3)
    return HostStiffness(G=Gc, D=np.asarray(D, np.float64), coeff=coeff,
                         C=None if C is None else np.ascontiguousarray(C))


def _indexed_from_fustpu(G, dofmap, D, D3p, coeff, c1, c2) -> HostStiffness:
    """The indexed layouts (see stiffness_from_fustpu)."""
    dofmap = np.asarray(dofmap)
    cells, n3 = dofmap.shape
    if G.ndim != 3:
        raise ValueError(f"unrecognised indexed G of shape {G.shape}")
    # G6p pads cells and lanes with zeros; indexed_op's G has no padding
    Gc = np.ascontiguousarray(G[:, :cells, :n3].transpose(1, 0, 2))
    if D is None:
        if D3p is None:
            raise ValueError("need D or D3p")
        # D3p[2] = I (x) I (x) D: its top-left n x n block is D
        n = round(n3 ** (1 / 3))
        D = np.asarray(D3p, np.float64)[2, :n, :n]
    cell = lambda a: None if a is None else np.asarray(a, np.float64)
    C = None if c1 is None else np.stack([cell(c1), cell(c2)], axis=1)
    return HostStiffness(G=Gc, D=np.asarray(D, np.float64),
                         coeff=cell(coeff), C=C, dofmap=dofmap)


def stiffness_from_fustpu(G, nc, *, D=None, Dt=None, D3p=None, C=None,
                          coeff_e=None, c1_e=None, c2_e=None, rows=None,
                          dofmap=None) -> HostStiffness:
    """G: (6, ex, ey, ez) of an MMStiffness or (ncx, n, 6, ey, ez) of a
    PallasStiffness(Pair).  D: the (n, n) ``D_host``, or Dt: the three
    block-diagonal derivative matrices of an MMStiffness.  C: the pair
    operator's (ncx, 2, ncy, ncz) coefficients.  coeff_e / (c1_e, c2_e):
    the expanded per-cell coefficient fields the matmul path applies at run
    time (linear, or Westervelt pair).

    Given `rows` (the extruded operator's row ids), the operator is an
    extruded one and nc = (nstacks, nz): G is the G6 (6, ns, n, n, ez) of
    an ExtrudedStiffness or the Gt (n^2, 6, ns_pad, ez) of a
    PallasExtruded(Pair), D its 1D derivative matrix, C the pair form's ce
    (2, ns_pad, ez), and coeff_e / (c1_e, c2_e) the (ns, 1, 1, ez)
    coefficient fields (c2_x, or c3_x and c4_x) of the einsum path.

    Given `dofmap` (the mesh's (cells, n^3) dofmap), the operator is an
    indexed one and nc is unused: G is the (6, cells, n^3) of
    ``indexed_op`` with its D, or the (6, cellsp, 128) G6p of a
    ``FusedEngine`` with its D3p, and coeff_e / (c1_e, c2_e) the (cells,)
    coefficients (c2_c, or c3_c and c4_c) that path applies at run
    time."""
    G = np.asarray(G, np.float64)
    if dofmap is not None:
        return _indexed_from_fustpu(G, dofmap, D, D3p, coeff_e, c1_e, c2_e)
    if rows is not None:
        return _extruded_from_fustpu(G, nc, D, C, coeff_e, c1_e, c2_e)
    ncx, ncy, ncz = nc
    if G.ndim == 4:                                  # (6, ex, ey, ez)
        n = G.shape[1] // ncx
        Gc = G.reshape(6, ncx, n, ncy, n, ncz, n).transpose(1, 3, 5, 0, 2,
                                                            4, 6)
    elif G.ndim == 5:                                # (ncx, n, 6, ey, ez)
        n = G.shape[1]
        Gc = G.reshape(ncx, n, 6, ncy, n, ncz, n).transpose(0, 3, 5, 2, 1,
                                                            4, 6)
    else:
        raise ValueError(f"unrecognised stiffness G of shape {G.shape}")
    Gc = np.ascontiguousarray(Gc).reshape(ncx * ncy * ncz, 6, n ** 3)
    if D is None:
        if Dt is None:
            raise ValueError("need D (D_host) or Dt")
        D = np.asarray(Dt[0], np.float64)[:n, :n]
    coeff = None if coeff_e is None else _cells_from_expanded(coeff_e, n)
    if C is not None:
        C = np.asarray(C, np.float64).transpose(0, 2, 3, 1).reshape(-1, 2)
    elif c1_e is not None:
        C = np.stack([_cells_from_expanded(c1_e, n),
                      _cells_from_expanded(c2_e, n)], axis=1)
    return HostStiffness(G=Gc, D=np.asarray(D, np.float64), coeff=coeff,
                         C=C)


def _slab2_from_slabs(Gs: np.ndarray, statics, dtype, device,
                      far: bool) -> s2.Slab2Stiffness:
    """Gs: (slabs, n, 6, ey, ez or more) per-slab G, the ghost slab and lane
    padding included."""
    D, ncx, ez = statics
    n = Gs.shape[1]
    ncy, ncz = Gs.shape[3] // n, ez // n
    D = np.asarray(D, np.float64)
    G = stiffness_from_fustpu(Gs[:ncx, ..., :ez], (ncx, ncy, ncz), D=D).G
    return s2.from_host((ncx, ncy, ncz), G, D, dtype, device, far)


def slab2_from_fustpu(G2, statics, dtype: torch.dtype = torch.float64,
                      device="cuda") -> s2.Slab2Stiffness:
    """The port's adjacent-paired operator from a PallasStiffness2's G2
    (ncx2, n, 6, ey, 2, ezp) and statics (D, ncx, ez): the two lane halves
    are slabs 2q and 2q + 1."""
    G2 = np.asarray(G2, np.float64)
    ncx2, n, _, ey, _, ezp = G2.shape
    Gs = G2.transpose(0, 4, 1, 2, 3, 5).reshape(2 * ncx2, n, 6, ey, ezp)
    return _slab2_from_slabs(Gs, statics, dtype, device, far=False)


def slab2w_from_fustpu(G2, statics, dtype: torch.dtype = torch.float64,
                       device="cuda") -> s2.Slab2Stiffness:
    """The port's far-paired operator from a PallasStiffness2W's G2
    (ncx2, n, 6, ey, 2 ez) and statics (D, ncx, ez): lanes [0, ez) hold
    slab i, lanes [ez, 2 ez) slab ncx2 + i."""
    G2 = np.asarray(G2, np.float64)
    ez = statics[2]
    Gs = np.concatenate([G2[..., :ez], G2[..., ez:]], axis=0)
    return _slab2_from_slabs(Gs, statics, dtype, device, far=True)


def state_from_fustpu(state, dtype: torch.dtype, device) -> RKState:
    """(u, v, ku, kv, t) numpy arrays -> the port's RKState (t a float)."""
    u, v, ku, kv, t = state
    f = lambda a: torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                                  device=device)
    return RKState(u=f(u), v=f(v), ku=f(ku), kv=f(kv), t=float(t))


def model_from_fustpu(cls, params: dict, state=None, *, mesh, material,
                      source, source_facets, dtype: torch.dtype, device,
                      stiffness_impl: str = "auto"):
    """A port model of class `cls` (LinearWaveModel or WesterveltModel)
    whose buffers are the JAX model's `params`, as numpy arrays:
    ``params["stiff"]`` is a dict of the keyword arrays of
    `stiffness_from_fustpu` (with `rows` on an ExtrudedHexMesh; on any
    other UnstructuredHexMesh the dofmap defaults to the mesh's, and a
    fused-engine model gives ``params["fused"]`` instead) or, for a
    corner-mode model, of `corner_from_fustpu` (JC or T), and the
    run-time coefficient fields c2_e (linear) or c3_e / c4_e (Westervelt)
    of the matmul path, c2_x / c3_x / c4_x of the extruded einsum path,
    or the per-cell c2_c / c3_c / c4_c of the indexed path, are given
    where the JAX model holds them.  `state` (u, v, ku, kv, t) is moved
    across too.  `stiffness_impl`: 'auto', or 'indexed_engine' for the
    staged engine on an indexed model's params.  Returns (model, state or
    None)."""
    model = cls.__new__(cls)
    torch.nn.Module.__init__(model)
    model._setup(mesh, material, source, source_facets, dtype, device,
                 stiffness_impl)
    extruded = isinstance(mesh, ExtrudedHexMesh)
    indexed = isinstance(mesh, UnstructuredHexMesh) and not extruded
    stiff = dict(params["fused"] if params.get("stiff") is None
                 else params["stiff"])
    where = mesh if extruded or indexed else mesh.nc
    if "JC" in stiff or "T" in stiff:
        # the corner layouts carry every coefficient in their channels or C
        host = corner_from_fustpu(**stiff, ns=getattr(mesh, "nstacks", None))
        op = host.to_device(dtype, model.device, where)
        return _finish(model, cls, params, op, state, dtype)
    if indexed:
        stiff.setdefault("dofmap", mesh.dofmap)
        # the indexed path holds per-cell coefficients even in uniform
        # media, where the port applies them as scalars instead
        runtime, tag = not model.uniform, "c"
    else:
        # only the einsum layouts apply the coefficient fields at run
        # time; the fused-kernel layouts fold them into G or carry them
        # in C
        runtime = np.ndim(stiff["G"]) == (5 if extruded else 4)
        tag = "x" if extruded else "e"
    if runtime and f"c2_{tag}" in params:
        stiff["coeff_e"] = params[f"c2_{tag}"]
    if runtime and f"c3_{tag}" in params:
        stiff["c1_e"], stiff["c2_e"] = params[f"c3_{tag}"], params[
            f"c4_{tag}"]
    op = stiffness_from_fustpu(
        nc=(mesh.nstacks, mesh.nz) if extruded else getattr(mesh, "nc",
                                                            None),
        **stiff)
    return _finish(model, cls, params, op.to_device(
        dtype, model.device, where, engine=stiffness_impl == ENGINE_IMPL),
        state, dtype)


def sharded_state_from_fustpu(fsharded, state, sharded=None):
    """A JAX sharded model's distributed `state` (u, v, ku, kv, t) through
    its `collect` (which returns numpy arrays): the global host state
    (u, v, ku, kv, t), or, given the port's sharded model `sharded`, that
    rank's RKState of it."""
    f = lambda a: np.asarray(fsharded.collect(a))
    host = (f(state[0]), f(state[1]), f(state[2]), f(state[3]),
            float(np.asarray(state[4])))
    return host if sharded is None else sharded.split_state(host)


def _finish(model, cls, params: dict, op, state, dtype: torch.dtype):
    """Install the operator and the diagonal vectors; move the state."""
    model.stiffness = stiffness_module(op, model.impl)
    model._load_vectors({k: None if params.get(k) is None
                         else np.asarray(params[k], np.float64)
                         for k in cls.VECTORS})
    if state is not None:
        state = state_from_fustpu(state, dtype, model.device)
    return model, state
