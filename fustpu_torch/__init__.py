"""fustpu_torch: the PyTorch / CUDA port of fustpu for one NVIDIA H100.

Matrix-free GLL spectral-element solver for the linear and Westervelt
(nonlinear) acoustic wave equations on structured or mapped box meshes
and imported Gmsh hex meshes (prismatic or general): float64 numpy host
setup, hand-written CUDA kernels for the stiffness apply on each mesh kind
and for the corner-streamed capacity mode, which evaluates the metric in
registers from 37 (hex8) or 163 (hex27) values per cell
(``fustpu_torch/csrc/*.cu``, built with nvcc at first use), and an RK4
loop of eager torch ops.  The JAX package ``fustpu``
is the reference this package is tested against; this package imports
neither JAX nor ``fustpu``.
"""

__version__ = "0.1.0"

from fustpu_torch.config import Material, Source
from fustpu_torch.mesh.box import BoxMesh, build_box_mesh, build_mapped_mesh
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel

__all__ = ["Material", "Source", "BoxMesh", "build_box_mesh",
           "build_mapped_mesh", "LinearWaveModel", "WesterveltModel"]
