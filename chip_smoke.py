"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints its time; any failure exits non-zero):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels of fustpu_torch/csrc, from source;
  3. kernel vs plain: both structured stiffness kernels (the z-pencil
     kernel) against the plain torch version at P = 2..10 on small odd
     meshes, float64 and float32, two applies bitwise equal, and against
     the parity-class design of the same kernels in float64;
  4. operator throughput at P = 4, 32^3 cells, float32, through
     `utils.benchmarks.bench_operators`' parts (kernel, plain and
     mass-multiply times, GDOF/s, each apply's least bytes);
  5. the linear box demo at its default size, the full run;
  6. the flagship conformal-bowl Westervelt run (--elements 64 --degree 4,
     float32, 6,661,697 DOF): 10 steps kernel vs plain, then the whole
     solve on the kernel, with the focal pressure checked;
  7. the two-layer flagship: 10 steps pair kernel vs plain, then 50 steps
     through the pair kernel;
  8. the extruded kernels (imported prismatic meshes; the stack kernel)
     against their plain version at P = 2..10 on an imported cylinder and
     a shuffled box, float64 and float32, two applies bitwise equal, and
     against the class-launch design of the same kernels in float64, with
     each mesh's stack colours (run right after phase 3);
  9. the piston demo on the imported O-grid cylinder (--refine 2, P=4,
     float32), the full run, checked against the O'Neil solution;
 10. the imported H131 bowl (--geometry unstructured --elements 64
     --degree 4, float32, 6,661,697 DOF): kernel vs plain with the stack
     kernel's schedule, 10 steps kernel vs plain, then the whole solve on
     the kernel, its focal pressure checked against the band and against
     phase 6's conformal run;
 11. the two-layer imported bowl, 50 steps through the extruded pair
     kernel;
 12. the indexed kernels (non-prismatic meshes; the chunk kernel) against
     their plain version at P = 2..10 on the imported cylinder read as a
     general mesh and a perturbed shuffled box, float64 and float32, two
     applies bitwise equal, and against the class-launch design in
     float64, with each mesh's chunk schedule (run right after phase 8);
 13. the bodyfit H131 bowl (--geometry bodyfit --elements 64 --degree 4,
     float32, 6,661,697 DOF on a mesh that no axis extrudes): kernel vs
     plain and 10 steps kernel vs plain, then the whole solve on the
     kernel, the focal pressure checked against phase 6's conformal run,
     and the first PLAIN_DEPTH steps on the plain version against the
     kernel's (13c);
 14. the two-layer bodyfit bowl, 50 steps through the indexed pair kernel;
 15. the bodyfit bowl at P=6 (--elements 48 --degree 6, 10,764,961 DOF):
     kernel vs plain, 10 steps kernel vs plain, 50 steps on the kernel
     (ms/step), then the whole solve, its focal pressure checked against
     the conformal bowl's at the same degree and size;
 16. the corner kernels of the capacity mode (the walk of box pencils and
     of stacks) against their plain version at P = 2..10 on a perturbed
     odd box (structured), the imported cylinder and the shuffled box
     (extruded, hex8) and a curved hex27 prism, float64 and float32, each
     also against the G-stream kernel on the same mesh and against the
     class-launch design it replaced (float64), two applies bitwise equal
     (run right after phase 12);
 17. the flagship conformal bowl in corner mode (--stiffness-impl
     pallas_corner): no host metric built, kernel vs plain and vs phase
     6a's G-stream kernel, 10 steps vs the G-stream model, device memory of
     both (17a); the whole solve, its focal pressure against phase 6b's
     (17b); the two-layer flagship, 50 steps through the corner pair
     kernel (17c);
 18. the imported bowl in extruded corner mode: kernel vs plain and vs
     phase 10a's G-stream kernel, 10 steps (18a); the whole solve against
     phase 10b's focal pressure (18b); the two-layer imported bowl, 50
     steps through the extruded corner pair kernel (18c); the imported bowl
     with its geometry carried as hex27 (the trilinear map on the 27-node
     lattice: the same geometry through the 163-channel kernel), kernel vs
     plain and vs the hex8 corner kernel, then the whole solve against
     phase 10b (18d); the two-layer hex27 bowl, its pair kernel vs plain
     and vs the hex8 corner pair kernel, then 50 steps (18e);
 19. the capacity demos: `fustpu_torch.demos.capacity` at its default size
     (664 x 56 x 56 cells, P = 4, 134,510,625 DOF) (19a, also phase 33h's
     set-up on the card) and `capacity_imported` at a quarter of its
     default depth (--nz 30) (19b): 10 warm-up and 10 timed steps,
     ms/step, peak device memory; what the model holds and what a 10-step
     solve adds on the walk and on the class-launch design; then the
     model's kernel against its plain version at that size;
 20. the four kernels of the staged gather / contract / scatter engine
     against their plain version at P = 2..10 on phase 12's meshes, float64
     and float32: each kernel alone (the gathers bitwise, the single-field
     gather also against its first design), the composed apply and pair,
     and the composed apply against the indexed kernel on the same buffers
     (run right after phase 16);
 21. the bodyfit bowl on the engine (--stiffness-impl indexed_engine, on
     phase 13a's import): each kernel against its plain version and timed,
     the composed apply against the indexed kernel in the same run, 10
     steps against the indexed model; the single-field gather against its
     first design and `index_select` in turns, warm and cold, and the
     composed apply and 50 steps with either gather in turns, the steps
     bitwise equal (21a); the whole solve, its focal
     pressure against phase 13b's, 12 engine kernel launches a step (21b);
     the two-layer bowl, 50 steps through gather2 (21c); the P=6 bowl, 50
     steps against phase 15b's indexed run (21d);
 22. ranks on the one card (parallel.multihost.spawn, gloo on cuda:0, 4
     ranks, after 21b): in one process group, the flagship on a (2, 2, 1)
     grid for 50 steps, the two-layer flagship and the flagship in corner
     mode for 20 (22a-c), the imported bowl and the bodyfit bowl (indexed
     and indexed_engine) for 20 (22d-e), time_halo's 16^3 P=4 Westervelt
     box on a (4, 1, 1) grid for 20 with and without the exchange (22g:
     without it the owners of the shared entries must disagree and u
     differ from the one-rank run and from the exchanged one; ms/step of
     both and the exchange's share); then the flagship on nccl at world
     size 1 (22f); each against the one-rank model over the same steps (u
     and the probe traces), with ms/step, the exchange's ms per stage and
     every rank's launches of each of its kernels.  Each model is saved for
     the ranks, and run alone for the reference, where the script builds
     it;
 23. the two-slab kernels (slab2: adjacent slab pairs, slab2w: far pairs)
     on the z-pencil walk (a slab pair's two pencils in turn) and on the
     class-launch design, against their
     plain versions at P = 2..10 on the boxes (4, 3, 2), (5, 2, 3) (odd
     ncx) and (2, 3, 3) (one pair), each with and without a coefficient,
     float64 and float32; the walk against the class-launch design (1e-14)
     and against #1 on the same buffers, two applies bitwise (run right
     after phase 20);
 24. the exp_slab2w demo at P = 4, 32^3, float32, both designs in turns:
     #1, slab2 and slab2w on the walk and on the class-launch design, each
     against its plain version;
 25. the exp_kernel_anatomy demo at P = 4, 32^3, float32, both designs in
     turns: #1 (full), its gstream, contract and ywin variants and #2
     (full_pair), as policies of the z-pencil walk and on the
     parity-class kernel, each against its plain version; the walk's full
     and ywin bitwise #1;
 26. the exp_g_layout demo (the (32, 5, 6, 160, 160) float32 G summed in
     the per-cell and the component-major layout) and the
     exp_mosaic_relayout demo (128 and 16384 tiles of (8192, 1) float32,
     four permutations, bitwise), each kernel against its plain version,
     with one PyTorch call's time beside it (einsum; clone, transpose);
     the relayout kernels against their first designs and the PyTorch
     calls in turns (--turns: CUDA events at both sizes; at 128 tiles also
     the host clock per call and the profiler's device time);
 27. the parity-class design of #1 and #2 (anatomy's full and
     full_pair) against the z-pencil kernels that replaced them: the
     exp_pencil demo at the flagship's 64 x 40 x 40 cells and at 32^3
     (P = 4, float32), in turns (old, new, new, old), single and pair, ms,
     TB/s and share of the bound (27a); the flagship's whole solve on the
     parity-class kernel, its focal pressure against phase 6b's (27b);
 28. the class-launch designs of #6 and #11 (`extruded_classes`,
     `indexed_classes` and their pair forms) against the stack and chunk
     kernels that replaced them, and #11 against the composed engine: the
     exp_imported demo on phase 10a's imported bowl, phase 13a's bodyfit
     bowl and phase 15a's P=6 bodyfit bowl (P = 4 and 6, float32), in
     turns (old, new, new, old), single and pair, ms, TB/s and share of
     the bound, each new kernel's schedule and a few other schedules'
     times (run after phase 15);
 29. the class-launch corner designs (`corner_classes`,
     `extruded_corner_classes` and their pair forms, hex8 and hex27)
     against the walk that replaced them, on phase 17's and 18's models
     right after each is built: in turns (old, new, new, old, twice), ms,
     share of the bound and launches an apply for each, the walk's
     schedule, and 10 steps of the model on each design (29a-f); the
     kernels line takes both designs' ms from their best turn;
 30. file I/O and tools, each check a hard failure: the flagship on #1
     (run right after phase 27b) restarts exactly, 100 + 100 steps
     against 100 steps, an npz checkpoint, its load and 100 more, and
     through the asynchronous Checkpointer, whose save overlaps the next
     100 steps (30a: bitwise, MB and write seconds); its structured VTK
     (binary) read back exactly, a 179 x 179 plane point cloud and a
     probe trace (30b); its state at step 100 moved from P=4 to P=6 on the
     card against the float64 host transfer (float64 1e-12, float32 1e-6)
     and 10 steps of the P=6 bowl from it (30d); the nonlinear_bowl demo
     at the flagship's size with --output, --checkpoint-every 1000,
     --snapshot-every 1000 and --probe at the focus, in a subprocess: its
     files, focal pressure in the band and launches 4 x steps (30e);
     phase 10a's imported bowl written as inline XDMF and read back: mesh
     arrays bitwise the .msh import's, 10 steps on #6 bitwise phase 10a's
     model's, the full-GLL unstructured VTK (30c, right after 10b); the
     flagship's per-rank snapshots of 22a's four ranks reassembled
     bitwise as collect() gives them (30f); the bodyfit bowl on #11
     restarts exactly and writes its full-GLL VTK (30g, right after 13c);
 31. #4 / #5 and #13 on the walk against the first designs in turns (old, new,
     new, old) at P = 4, float32, on 32^3 (phases 24 and 25's turns) and
     64 x 40 x 40 cells: slab2 and slab2w beside #1 on the same buffers,
     the anatomy's four variants and full_pair in both designs, each with
     ms and its share of the bound, full - gstream - contract for each
     design; every gate a hard failure (run right after phase 26).
 32. the measurement modules and their demos, float32 unless stated,
     every gate a hard failure (run after phase 31; f-h right after 21b):
     the triad c = c*d + e over 256 MiB arrays, a 2 GiB copy and the
     4096^3 matmul in bf16 and in f32 with TF32 off, each at most 105% of
     the published peak (32a); time_operators at P = 2..6 on 32^3, #1
     against its plain version (32b); exp_degree_sweep at P = 2..10, each
     against its plain version, and, after phase 19, #1 in float64 on a
     2^3 box against the dense oracle (``fustpu_torch.oracle``, 1e-12),
     which a process of its own computes from phase 5 on (32c);
     bench_rk4_step on the 32^3 Westervelt and linear boxes, #1 launched
     4 x steps, the state finite (32d); exp_kernel_speed f32 4 2, its four
     formulations pairwise (32e); on phase 13a's bodyfit bowl,
     exp_engine_mesh (the engine apply against #11), exp_indexed_pair
     (the pair against two singles on each route) and exp_sharded_engine
     at k = 2 and 4 (the parts' scattered sum against the one-device
     pair) (32f-h);
     exp_isoparametric_bowl at --elements 24 --periods 3: #6 launched 4 x
     steps in each run, the fields finite, both focal |p| within 2% of
     the JAX package's recorded values and the hex27 one the larger (32i);
 33. the set-up kernels (csrc/setup.cu): each model of the set-up table
     (the flagship, the imported bowl as hex8 and hex27, the bodyfit bowl,
     the P=6 bodyfit and conformal bowls, the flagship's mesh at P=6) set
     up on the host (the numpy plain versions) and then on the card, the
     seconds of each split into geometry, mass diagonals, facets and the
     rest, 10
     float32 steps of the two against each other; each set-up kernel
     against its plain version, float64 <= 1e-14 (the dofmap and the
     diagonals bitwise), launched twice bitwise equal; timed at the
     flagship and the bodyfit bowl (33a-g); the capacity demo in its own
     process with the set-up on the host, its set-up seconds, peak device
     memory and host peak resident, beside 19a's set-up on the card
     (33h); the
     Fubini and transmission anchors in float32 (33i); the piston on 2
     gloo ranks sharing the card against phase 9's table (33j); 2
     separately launched gloo ranks joined over tcp:// against one rank
     (33k); the set-up table.
 34. bfloat16 state (the JAX package's --dtype bf16): the bf16 forms of
     #1 / #2, #6 and #11, single and pair, against their plain version
     (bf16 in, float32 arithmetic, y rounded once) at P = 2..10 on phases
     3, 8 and 12's meshes, <= 2^-7, two applies bitwise equal, every bf16
     counter moved (run right after phase 12; 34a); the flagship in bf16
     (after phase 7): #1 vs plain, 10 steps kernel vs plain <= 2e-2, the
     whole solve on #1 with its focal pressure beside 6b's (no band: bf16
     drifts from float32), the first PLAIN_DEPTH steps on the plain
     version (its field against #1's and float32's over the same steps),
     ms a step in turns with the float32 flagship (34b); the two-layer
     flagship in bf16, #2 vs plain and 50 steps (34c); the imported bowl
     (after 10b) and the bodyfit bowl (after 13c) in bf16, single and
     two-layer: #6 / #11 and their pair forms vs plain, 50 steps each, ms
     a step in turns with the float32 model (34d, 34e); bf16 in the corner (capacity) mode, the bf16 forms of #3
     and #6c (hex8, hex27): each against its plain version (bf16 in, the
     metric and the apply in float32, y rounded once) <= 2^-7 and against
     the bf16 G-stream kernel <= 1e-2 at P = 2..10, single and pair, on
     phase 16's meshes, two applies bitwise equal (inside phase 16; 34f);
     the flagship in corner mode in bf16 (after 29a): built without the
     host metric, #3 vs plain, 10 steps kernel vs plain <= 2e-2, 50 steps
     in turns with 17a's float32 corner model (ms a step), the device
     bytes each holds and a solve adds; its two-layer form, #3 pair vs
     plain and 50 steps (after 17c) (34g); the imported bowl in corner
     mode in bf16, hex8 (after 18c) and hex27 (after 18d), single and
     two-layer, each vs plain and 50 steps, ms a step in turns (34h); the
     capacity demo in bf16 at its default size, its peak device memory
     and what its model holds beside 19a's float32, #3 bf16 vs plain at
     that size (after 19b; 34i); bf16 on the staged engine, the bf16 forms
     of #7-#10: each kernel against its plain version (bf16 in, float32
     arithmetic, y2 and y rounded where they are stored) <= 2^-7 at P =
     2..10 on phase 20's meshes, the gathers bitwise `index_select`, the
     composed apply and pair <= 2^-7 and within 1e-2 of bf16 #11 on the
     same buffers, two applies bitwise, the redesigned #9 and #10
     (engine_bf16.cu) against their first designs on the same inputs (#10
     bitwise, #9 within 1e-3 with at most 1% of its values differing, the
     count printed), every bf16 engine counter and both first designs'
     moved (after phase 20; 34j); the bodyfit bowl on the engine in bf16
     on phase 13a's import (after 21b): each kernel against its plain
     version at that size and timed, #9 (also in COEFF mode) and #10
     against their first designs in turns, 10 steps kernel vs plain and
     vs the bf16 #11 model <= 2e-2, 50 steps counted, ms a step in turns
     with the float32 engine and bf16 #11, the device bytes of the model
     and of a solve beside the float32 engine's, and its two-layer form
     (pair, after 21c) in the same way (34k); the P=6 bodyfit bowl on the
     engine in bf16 (after 21d): kernels vs plain and the turns against
     the first designs, 50 steps, ms a step in turns with 21d's float32
     engine (34l); a two-layer bf16 engine model (a 12^3 P=4
     general box) on phase 22's 4 gloo ranks against its one-rank run
     <= 2e-2 (22e).
  - the two-field gather (#8) on the quads design: bitwise its first
    design (`cen.gather2_flat`, one thread a position) at P = 2..10 in
    float32 and float64 (20) and bfloat16 (34j); in turns against it and
    two `index_select` calls, with the pair apply on each, at the
    two-layer bodyfit bowl in float32 (21c) and bfloat16 (34k).
  - the RK4 solve as captured CUDA graphs (every `Model.solve` on the
    card replays them): on the flagship in float32 (35a, after 7b) and on
    the bodyfit bowl on the bf16 engine (35b, inside 34k), 10 replayed
    steps bitwise equal to 10 eager steps of the same step function and
    within 1e-5 (f32; bf16 2e-2) of the eager loop of Python-float
    coefficients, the replays counted; ms a step over 50 steps in turns
    (python-float, eager, captured) with the device busy and idle share
    of each from the profiler; the RK4 update kernel (`csrc/vector.cu`)
    bitwise its plain version and PyTorch's add, timed (35a, 34b), its
    launches in 6b's and 34b's whole solves; the capacity boxes' peak
    device memory of a 10-step solve, eager against captured (19a, 34i).
Each run of the main paths (6b, 7b, 9, 10b, 11b, 13b, 14b, 15b, 15c, 17b,
17c, 18b, 18c, 18d, 18e, 19a, 19b, 21b, 21c, 21d, 27b, 30a-e, 30g, 34b-e,
34g-i, 34k-l, in every rank of 22 its solve, and the demos of 24, 25, 26,
27a, 28, 31 and 32b-i and the turns of 29) has the launch counters reset
just before it and read just after.
The script's total time is printed after the last phase; then the
kernels' JSON summary, the card's name and power limit, and as the last
line the result.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PAIR_DEGREES = (2, 4, 6)
F64_TOL = 1e-12
# float32 kernel vs the float64 plain version: one apply rounds each of its
# ~3N products per node once, relative error ~1e-7 (measured, at worst
# 1.9e-7), inside the JAX package's own float32 operator gate of 1e-6
F32_TOL = 1e-6
# 10 RK4 steps (40 applies plus the float32 RK updates) of the kernel vs the
# plain float32 version: the two differ only in float32 summation order,
# ~1e-7 per apply, which the explicit, stable steps carry forward without
# amplification; 1e-5 leaves two orders of margin for the accumulation
TRAJ_TOL = 1e-5
FOCAL_BAND_PA = (-7.3e6, -6.0e6)
# the imported bowl is the conformal bowl's discrete problem under another
# dof numbering; float32 summation order alone separates the two runs
FOCAL_AGREE = 1e-4
# the pencil kernel against the parity-class kernel in float64: the two
# differ only in the order of their sums (relative ~1e-16)
PARITY_TOL = 1e-14
ONEIL_GATE = 0.12               # the JAX package's own piston gate
# phase 33: a set-up kernel against its plain version in float64: the same
# formulas, the sums over the geometry dofs in another order (the native
# runtime's own agreement with numpy is ~1e-16)
SETUP_TOL = 1e-14
# The bodyfit bowl is another discretisation of the conformal bowl's
# domain, cap and source, with its nodes clustered toward the focal axis.
# At P=4 and 2 elements per wavelength neither resolves the focal peak:
# the nonlinear_bowl demo reads -6.87 (conformal) and -9.43 MPa (bodyfit)
# at 6.66M DOF, and both -15.96 MPa at 25.4M DOF.  The finer near-axis
# mesh resolves more of the peak, never less, and stays below the
# converged value, so the bodyfit / conformal ratio at P=4 lies in
# BODYFIT_RATIO (measured 1.37; a broken source or absorbing boundary
# moves it far out: the JAX package's aperture fault read half the
# pressure).  At P=6 (--elements 48) both resolve it (-16.14 and -16.05
# MPa) and must agree to BODYFIT_P6_AGREE.
BODYFIT_RATIO = (1.0, 2.0)
BODYFIT_P6_AGREE = 0.05
# the card's published peaks (NVIDIA's data sheet, H100 SXM): device memory
# rate and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float64 outside the tensor cores (the set-up kernels' type)
PEAK_F64_PER_S = 34e12
PEAK_BF16_PER_S = 989e12        # dense, in the tensor cores
# phase 32i: the focal |p| of the JAX package's recorded isoparametric bowl
# run (BENCH_NOTES.md:607-622: (24, 15, 15) cells, P=4, 0.3 MHz, 3 periods
# past transit, delta +0.72%), which the port must meet within ISO_BAND;
# the port's own float64 run of the same on the CPU read 5.4995 and 5.5584
# MPa (-0.19%, +0.15%; delta +1.06%), so 2% leaves room for float32 and
# the card's summation order, and a wrong geometry or source falls outside
ISO_PEAK_PA = {"trilinear": 5.510e6, "hex27": 5.550e6}
ISO_BAND = 0.02
# phase 34 (bfloat16 state): a bf16 kernel against its plain version on the
# same bf16 inputs.  The plain version widens them to float32, contracts
# and rounds y once; the kernel computes in float32 in another order and
# rounds y each time it stores it, once per colour class that adds to the
# node: for #1 / #2 and #6 up to four (a node on a pencil's or a stack's
# side edge), for #11 up to its class count (8 on the P = 4 bowls, 9-12 on
# phase 12's small meshes), since each class reads back the bfloat16 y that
# the earlier ones left.  A rounding is at most 2^-8 of the partial sum it
# rounds (bfloat16 keeps 8 significant bits), so no node-wise bound of
# 2^-7 holds beyond two roundings: the gate is on the rel-l2 over the
# field, where the nodes inside a pencil, a stack or a chunk round once
# and the shared nodes' roundings are unbiased.  Measured on an H100: at
# most 1.65e-3 over P = 2..10, 9.4e-4 / 9.8e-4 on the flagship and the
# bodyfit bowl.
BF16_TOL = 2.0 ** -7
# a bf16 corner kernel against the bf16 G-stream kernel on the same mesh
# and inputs, or the bf16 engine against bf16 #11 on the same buffers: two
# bf16 operators (the metric rebuilt in float32 from bf16 channels, or G
# rounded to bf16; y2 and y rounded, or y alone), each within ~5e-3 of
# float64
BF16_G_TOL = 1e-2
# the redesigned bf16 contraction (#9) against its first design on the
# same bf16 inputs: the same float32 expressions in the same order, so
# bitwise where the compiler fuses them alike; a value whose rounding to
# bf16 a different fusion flips differs by one bf16 step (2^-8 of it), so
# 1e-3 over the field, with at most 1% of the values differing
FIRST_DESIGN_TOL = 1e-3
# the depth of the plain versions' runs of the bowls beside their kernels'
# whole solves (13c, 34b): the first PLAIN_DEPTH steps, about a sixth of
# the 1,889-1,957 (a whole solve on the plain version was among the run's
# slowest phases; 10 steps of each are also held in 13a and 34b)
PLAIN_DEPTH = 300
# 10 bf16 RK4 steps of the flagship, kernel vs plain: each of the 40
# applies differs by the roundings above, and the bf16 state rounds every
# RK update (the JAX package's bf16 drifts ~20% from its float32 in 60
# steps), so the two trajectories part by ~1e-3 a step at most
BF16_TRAJ_TOL = 2e-2
# phase 22's halo box (time_halo): one probe point inside the 1 cm box
HALO_POINTS = np.array([[0.0052, 0.0047, 0.0051]])


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str):
    class _Phase:
        def __enter__(self):
            print(f"== {name}", flush=True)
            self.t0 = time.perf_counter()

        def __exit__(self, exc_type, *exc):
            if exc_type is None:
                print(f"   [{name}: {time.perf_counter() - self.t0:.1f} s]",
                      flush=True)
    return _Phase()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call in ms, CUDA events over `reps` calls
    after a warm-up (`benchmarks.time_apply`, one run)."""
    from fustpu_torch.utils.benchmarks import time_apply

    return time_apply(lambda _, __: fn(), None, None, chain=reps,
                      reps=1)[0] * 1e3


def bound(nbytes: int, flops: int,
          peak_flops: float = PEAK_F32_PER_S) -> tuple[float, str]:
    """(least time in ms, what bounds it) for the bytes an apply must move
    and the operations it does, at the card's published peaks (float32,
    or `peak_flops` for another type)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def apply_cost(G: torch.Tensor, ndofs: int, fields: int,
               extra: int = 0) -> tuple[int, int]:
    """(minimum bytes, operations) of one stiffness apply: G, each input
    field and the per-cell coefficients read once, y written once, plus
    `extra` bytes (row ids); per node 2 x 3 derivative sums of
    n products each way, 15 for the metric and 1 for the add (3 more to
    combine a pair)."""
    cells, _, nnn = G.shape
    n = round(nnn ** (1 / 3))
    b = G.element_size()
    nbytes = G.numel() * b + (fields + 1) * ndofs * b + extra
    if fields == 2:
        nbytes += cells * 2 * b
    flops = cells * nnn * (12 * n + 16 + (3 if fields == 2 else 0))
    return nbytes, flops


class ClassLaunchCorner(torch.nn.Module):
    """The class-launch corner designs on a corner operator (kept as the
    comparison of the walk): `corner_classes` on a box, `extruded_corner_
    classes` otherwise, and their pair forms."""

    def __init__(self, op):
        super().__init__()
        self.op = op

    def forward(self, x):
        from fustpu_torch.ops import cuda_corner as cc

        f = cc.corner_classes if self.op.box else cc.extruded_corner_classes
        return f(self.op, x)

    def pair(self, x1, x2):
        from fustpu_torch.ops import cuda_corner as cc

        f = (cc.corner_classes_pair if self.op.box
             else cc.extruded_corner_classes_pair)
        return f(self.op, x1, x2)


def held_bytes(model) -> int:
    """Device bytes of a model's buffers (operator data and diagonals)."""
    return sum(b.numel() * b.element_size() for b in model.buffers())


def solve_peak(model, dt: float, steps: int) -> int:
    """Peak device bytes that a solve of `steps` steps adds to what is
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.solve(model.init_state(), dt, steps)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def solve_peaks(model, dt: float, steps: int) -> dict:
    """Peak device bytes that a solve of `steps` steps adds to what is
    allocated and to what is reserved, eager (`solve_eager`) and captured
    (the model's solvers dropped first, so its warm-up and capture
    included; a graph's private pool shows in what is reserved):
    {form: (allocated, reserved)}."""
    out = {}
    for form, run in (("eager", model.solve_eager),
                      ("captured", model.solve)):
        model.__dict__.pop("_solvers", None)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        a0 = torch.cuda.memory_allocated()
        r0 = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        run(model.init_state(), dt, steps)
        torch.cuda.synchronize()
        out[form] = (torch.cuda.max_memory_allocated() - a0,
                     torch.cuda.max_memory_reserved() - r0)
    model.__dict__.pop("_solvers", None)
    return out


def scatter_summary(mesh) -> str:
    """The extruded kernels' scatter design on `mesh`: stack colours, and
    the class-launch kernel's (colour, layer parity) classes."""
    from fustpu_torch.ops import cuda_extruded as ce

    colours = int(ce.colour_stacks(mesh.rows2d).max()) + 1
    classes = len(ce.scatter_classes(mesh.rows2d, mesh.nz)[1]) - 1
    return (f"{colours} stack colours ({classes} classes of the "
            "class-launch kernel)")


def stack_summary(s) -> str:
    """The stack kernel's schedule `s` (`cuda_extruded.StackSchedule`)."""
    return (f"stack kernel: {s.cpb} cells a chunk, {s.segments} segment(s) "
            f"a stack, {len(s.classes)} classes of "
            f"{s.classes[:, 1].tolist()} segments, {len(s.chunks)} chunks, "
            f"{s.blocks_per_sm} blocks an SM, {s.blocks} blocks, "
            f"{s.smem:,} B shared a block")


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    if not (ROOT / "fustpu_torch" / "csrc" / "extruded.cu").exists():
        fail("run from a checkout of the repository (fustpu_torch/ is "
             "missing next to this script)")

    from fustpu_torch import _build
    from fustpu_torch.demos import (capacity, capacity_imported, linear_box,
                                    linear_piston, nonlinear_bowl)
    from fustpu_torch.demos import (exp_g_layout, exp_imported,
                                    exp_kernel_anatomy, exp_mosaic_relayout,
                                    exp_pencil, exp_slab2w)
    # phase 32: the measurement modules and their demos
    from fustpu_torch.demos import (exp_degree_sweep, exp_engine_mesh,
                                    exp_indexed_pair, exp_isoparametric_bowl,
                                    exp_kernel_speed, exp_sharded_engine,
                                    time_halo, time_operators)
    from fustpu_torch.tools import profile_step
    from fustpu_torch.utils import benchmarks as B
    from fustpu_torch.demos.common import run_demo
    from fustpu_torch.mesh import msh_io, shapes
    from fustpu_torch.mesh.box import build_box_mesh
    from fustpu_torch.mesh.extruded import ExtrudedHexMesh, as_extruded
    from fustpu_torch.mesh.unstructured import from_box
    from fustpu_torch.mesh.unstructured import UPointSampler
    from fustpu_torch.models.discretization import (CornerStiffness,
                                                    Discretization,
                                                    EngineStiffness,
                                                    ExtrudedStiffness,
                                                    IndexedStiffness,
                                                    StructuredStiffness,
                                                    stiffness_module)
    from fustpu_torch.ops import cuda_corner as cc
    from fustpu_torch.ops import cuda_engine as cen
    from fustpu_torch.ops import cuda_extruded as ce
    from fustpu_torch.ops import cuda_indexed as ci
    from fustpu_torch.ops import anatomy
    from fustpu_torch.ops import cuda_slab2
    from fustpu_torch.ops import launch
    from fustpu_torch.ops import cuda_stiffness as cs
    from fustpu_torch.ops import engine as eng
    from fustpu_torch.ops import precompute as pre
    from fustpu_torch.ops import probes
    from fustpu_torch.ops import slab2
    from fustpu_torch.ops import spectral_mm as mm
    from fustpu_torch.parallel import multihost
    from fustpu_torch.utils.eval import PointSampler
    # phase 30: the file I/O and tools
    import dataclasses
    from fustpu_torch.mesh import xdmf_io
    from fustpu_torch.ops import kronecker as kr
    from fustpu_torch.utils import dist_io
    from fustpu_torch.utils import io as fio
    from fustpu_torch.utils.eval import eval_plane, locate
    # phase 33: the set-up kernels, the anchors, the piston and the check
    # over ranks
    from fustpu_torch.demos import anchors
    # phase 35: the captured RK4 solve and the RK4 update kernel
    from fustpu_torch.demos import exp_solver
    from fustpu_torch.models import timestepping
    from fustpu_torch.ops import cuda_vector as cv
    from fustpu_torch.mesh.box import dofmap_rows
    from fustpu_torch.config import Material, Source
    from fustpu_torch.models.westervelt import WesterveltModel
    from fustpu_torch.ops import cuda_setup as setup

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # the staged engine's kernels: one launch of each per apply
    STAGED = ("engine_gather", "engine_contract", "engine_scatter")
    STAGED16 = tuple(f"{k}_bf16" for k in STAGED)
    # phase 22: each model is saved for the ranks, and run alone for the
    # reference, where it is built; the ranks run in groups (ranks_group)
    ranks_dir = tempfile.TemporaryDirectory()
    ranks_cases = {}
    # phase 30's files (a few GB at most; removed at exit)
    io_dir = tempfile.TemporaryDirectory()
    IO = Path(io_dir.name)

    def megabytes(path) -> float:
        return Path(path).stat().st_size / 1e6

    def same_state(a, b) -> bool:
        """u, v, ku, kv bitwise equal and the same time."""
        return a.t == b.t and all(torch.equal(x, y)
                                  for x, y in zip(a[:4], b[:4]))

    def read_vtk(path, npts, names):
        """(points, {name: values}) of a binary legacy VTK file, as the
        big-endian float32 it holds."""
        data = Path(path).read_bytes()
        key = f"POINTS {npts} float\n".encode()
        off = data.index(key) + len(key)
        pts = np.frombuffer(data, ">f4", npts * 3, off).reshape(-1, 3)
        out = {}
        for name in names:
            key = (f"SCALARS {name} float 1\nLOOKUP_TABLE default\n"
                   .encode())
            off = data.index(key) + len(key)
            out[name] = np.frombuffer(data, ">f4", npts, off)
        return pts, out

    def restart_check(model, dt_, steps, label):
        """Phase 30's exact restart: `steps` steps, an npz checkpoint, and
        `steps` more from the file, against the same two solves with the
        state kept on the card (bitwise).  Returns (state at `steps`, the
        final state)."""
        first, _ = model.solve(model.init_state(), dt_, steps)
        straight, _ = model.solve(first, dt_, steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = fio.save_checkpoint(str(IO / label), first, steps,
                                   {"case": label})
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        arrays, step, meta = fio.load_checkpoint(path)
        resumed, _ = model.solve(fio.state_from_checkpoint(model, arrays),
                                 dt_, steps)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        mb = megabytes(path)
        same = same_state(resumed, straight)
        print(f"   {label}: {steps} + {steps} steps vs {steps}, npz "
              f"checkpoint, load, {steps}: "
              f"{'bitwise equal' if same else 'NOT bitwise equal'}; "
              f"checkpoint {mb:.1f} MB written in {t_save:.3f} s "
              f"({mb / t_save:.1f} MB/s, host clock), load + "
              f"{steps} steps {t_load:.3f} s ({smi})", flush=True)
        if not same or step != steps or meta != {"case": label}:
            fail(f"{label}: the restart from the checkpoint is not exact "
                 f"(step {step}, meta {meta})")
        return first, straight

    def device_probe(model, points):
        """A per-step probe of u at `points`, on the model's device."""
        smp = (PointSampler if hasattr(model.mesh, "nc") else UPointSampler)
        f = smp(model.mesh, points).torch_probe(dev)
        return lambda s: f(s.u)

    def keep_for_ranks(name, model, dt_, steps, points, grid=None,
                       impl=None, like=None, **keys):
        """Phase 22's case `name`: `model` saved for the ranks (or the file
        of case `like`) and its one-rank run of `steps` steps from rest,
        with the probe trace at `points`; `keys` are more case keys of
        `solve_cases` (phase 30f's `dist_output`)."""
        path = (ranks_cases[like]["model"] if like else
                str(Path(ranks_dir.name) / f"{name}.pt"))
        if like is None:
            torch.save(model, path)
        st, ys = model.solve(model.init_state(), dt_, steps,
                             probe=device_probe(model, points))
        ranks_cases[name] = dict(
            model=path, steps=steps, dt=dt_, grid=grid, impl=impl,
            probe=points, exchange_reps=20,
            ref_u=fio.to_host(st.u).reshape(-1), ref_ys=fio.to_host(ys),
            **keys)

    def ranks_group(names, nprocs, backend):
        """Phase 22: the saved models of `names` over `nprocs` spawned ranks
        on the card, each against its one-rank run: rel-l2(u) and the probe
        traces within TRAJ_TOL, u, v and kv bitwise consistent across
        owners, every kernel of each rank's stiffness (the staged engine's
        three) launched 4 x steps times.  Deletes the saved files."""
        cases = [{k: v for k, v in ranks_cases[n].items()
                  if not k.startswith("ref")} for n in names]
        with phase(f"22 {nprocs} rank(s) ({backend} on one card): "
                   + "; ".join(names)):
            res = multihost.spawn(multihost.solve_cases, nprocs, backend,
                                  "cuda", timeout=600, args=(cases,))
            for i, name in enumerate(names):
                c, r0 = ranks_cases[name], res[0][i]
                u = r0["u"].reshape(-1)
                err = rel_l2(torch.as_tensor(u), torch.as_tensor(c["ref_u"]))
                npts = c["ref_ys"].shape[1]
                dy = np.abs(r0["ys"][:, :npts] - c["ref_ys"]).max()
                perr = float(dy / max(np.abs(c["ref_ys"]).max(), 1e-30))
                same = np.array_equal(u, c["ref_u"])
                ok = r0["u_consistent"] and r0["v_consistent"] and \
                    r0["kv_consistent"]
                launches = [r[i]["launches"] for r in res]
                kernel = (r0["kernel"],)
                if r0["kernel"] in ("engine", "engine_bf16"):
                    # the staged engine's three kernels, gather2 for a pair
                    kernel = cen.kernels(
                        BF16 if r0["kernel"] == "engine_bf16" else
                        torch.float32, any(k.startswith("engine_gather2")
                                           for k in launches[0]))
                tol = c.get("ref_tol", TRAJ_TOL)
                print(f"   {name}: {nprocs} rank(s) sharing one H100 "
                      f"({backend}; not a multi-GPU speed) {smi}: "
                      f"{r0['ms_per_step']:.4f} ms/step over {c['steps']} "
                      f"steps, exchange {r0['exchange_ms']:.4f} ms per "
                      f"stage; vs one rank rel-l2(u) {err:.3e}, probes "
                      f"(max relative) {perr:.3e} (tol {tol}), "
                      f"{'bitwise equal' if same else 'not bitwise equal'};"
                      f" shared entries consistent {ok}; stiffness "
                      f"{r0['stiffness']}; launches per rank {launches}",
                      flush=True)
                if not c.get("exchange", True):
                    # the exchange makes every owner of a shared entry hold
                    # the same sum: without it the owners disagree, and u
                    # leaves the one-rank run (by little while the wave has
                    # not reached the cuts)
                    if ok or not err > 0.0:
                        fail(f"{name}: without the exchange the shared "
                             f"entries are consistent ({ok}) or u equals the "
                             f"one-rank run ({err:.3e})")
                elif not (err <= tol and perr <= tol and ok):
                    fail(f"{name}: sharded vs one rank {err:.3e}, probes "
                         f"{perr:.3e}, consistent {ok}")
                if any(la.get(k, 0) != 4 * c["steps"]
                       for la in launches for k in kernel):
                    fail(f"{name}: launches {launches} != 4 x {c['steps']} "
                         f"of each of {kernel}")
            for name in names:
                path = ranks_cases.pop(name)["model"]
                if all(c["model"] != path for c in ranks_cases.values()):
                    Path(path).unlink()
            return res

    # ---- phase 33: each model's set-up before (host) and after (card) ----
    setup_table = []          # (label, before, after): (seconds, split)
    setup_launches = {}       # each set-up kernel's launches in its build

    def bowl_model(pb, args_, setup_device):
        """`nonlinear_bowl.build(args_, pb)`'s uniform model with its
        set-up on `setup_device` ('cpu': the host's numpy; None: the
        card's kernels)."""
        return WesterveltModel(
            pb.mesh, pb.material, pb.source, pb.aperture, pb.absorbing,
            dtype=torch.float32, device=dev, source_delays=pb.delays,
            stiffness_impl=args_.stiffness_impl, setup_device=setup_device)

    def setup_turn(label, build):
        """Phase 33: the model `build(setup_device)` set up on the host
        (before: 'cpu', the float64 numpy plain versions) and then on the card
        (after: the set-up kernels); each's seconds (host clock, the card's
        queue drained) split into the geometry, the mass diagonals, the
        facets (their geometry, dofs and diagonals) and the rest; 10
        float32 steps of each from rest against each other (TRAJ_TOL).
        Returns (after model, before model, the after build's set-up
        kernel launches)."""
        res = {}
        for when, sd in (("before", "cpu"), ("after", None)):
            torch.cuda.synchronize()
            setup.reset_launches()
            t0 = time.perf_counter()
            m = build(sd)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            split = {k: m.disc.host_seconds.get(k, 0.0)
                     for k in ("geometry", "mass", "facets")}
            split["rest"] = total - sum(split.values())
            res[when] = (m, total, split, dict(setup.launches))
            print(f"   {label}: set-up {when} ("
                  f"{'host numpy' if sd else 'set-up kernels'}) "
                  f"{total:.3f} s: "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
                  + f"; set-up kernel launches "
                  f"{ {k: v for k, v in setup.launches.items() if v} }",
                  flush=True)
        after, before = res["after"][0], res["before"][0]
        if any(res["before"][3].values()) or not res["after"][3][
                "setup_cell_detJ"]:
            fail(f"{label}: set-up kernel launches {res['before'][3]} "
                 f"(host set-up), {res['after'][3]} (card set-up)")
        dt_ = after.cfl_dt(0.4)[0]
        ua = after.solve(after.init_state(), dt_, 10)[0].u
        ub = before.solve(before.init_state(), dt_, 10)[0].u
        traj = rel_l2(ua, ub)
        print(f"   {label}: 10 steps, the card's set-up vs the host's: "
              f"rel-l2(u) {traj:.3e} (tol {TRAJ_TOL}), max |u| "
              f"{float(ua.abs().max()):.4e} ({smi})", flush=True)
        if not traj <= TRAJ_TOL:
            fail(f"{label}: card set-up vs host set-up {traj:.3e}")
        setup_table.append((label, res["before"][1:3], res["after"][1:3]))
        return after, before, res["after"][3]

    def setup_rel(a, b) -> tuple[float, float]:
        """(rel-l2, max abs) of `a` against `b`, float64 on the host."""
        a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                       np.float64)
        b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b,
                       np.float64)
        return (float(np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                   1e-300)),
                float(np.abs(a - b).max()) if a.size else 0.0)

    def setup_check(label, after, before, bd, launches_=None):
        """Phase 33: the set-up kernels of `after`'s card set-up against
        their plain versions on the same inputs, the host set-up of the
        G-stream model `before` (geometry <= SETUP_TOL relative, the
        dofmap bitwise), the diagonals also against the plain version on
        the card's detJ (bitwise), each launched twice (bitwise equal);
        with `launches_` (the build's set-up kernel launches) each kernel's
        row for the JSON line at this size: ms (CUDA events), the plain
        version's ms (host clock, one call), the least bytes and float64
        operations."""
        da, db, mesh = after.disc, before.disc, after.mesh
        card, P = da._card, mesh.degree
        host = lambda t: t.cpu().numpy()
        errs, rows = {}, {}

        def gate(name, a, b, exact=False):
            e, m = setup_rel(a, b)
            errs[name] = max(errs.get(name, 0.0), e)
            if not (e == 0.0 if exact else e <= SETUP_TOL):
                fail(f"{label}: {name} {e:.3e} "
                     f"({'bitwise' if exact else SETUP_TOL})")
            return m

        def timed_plain(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3

        gd, gr, w = card.gdofs, card.grads, card.wts
        cells, ng, nq = gd.shape[0], gd.shape[1], w.shape[0]
        dJ, G = setup.cell_geometry(gd, gr, w)
        dJ2, G2 = setup.cell_geometry(gd, gr, w)
        d1, _ = setup.cell_geometry(gd, gr, w, with_G=False)
        d2, _ = setup.cell_geometry(gd, gr, w, with_G=False)
        if not (torch.equal(dJ, dJ2) and torch.equal(G, G2)
                and torch.equal(d1, d2)):
            fail(f"{label}: cell_geometry's launches differ")
        # the host set-up's arrays are the plain versions on the same
        # geometry dofs (the same congruence representatives)
        mg = gate("cell_geometry", card._cells(G), db._G_host)
        md = gate("cell_detJ", card._cells(d1), db._detJ_host)
        gate("cell_detJ", card._cells(dJ), db._detJ_host)
        fa, fa2 = da.facet_block(bd), da.facet_block(bd)
        fb = db.facet_block(bd)
        if not (torch.equal(fa.detJ, fa2.detJ)
                and torch.equal(fa.dofmap, fa2.dofmap)):
            fail(f"{label}: facet set-up launches differ")
        mf = gate("facet_geometry", fa.detJ, fb.detJ)
        gate("facet dofmap", fa.dofmap, fb.dofmap, exact=True)
        coeff = rng.uniform(0.5, 2.0, mesh.num_cells)
        m1, m2 = da.mass_diag(coeff), da.mass_diag(coeff)
        if not torch.equal(m1, m2):
            fail(f"{label}: mass_diagonal's launches differ")
        gate("mass diagonal vs the host set-up", m1,
             db.mass_diag_host(coeff))
        detJ = card.detJ()
        ct = torch.as_tensor(coeff, device=dev)
        if hasattr(mesh, "nc"):
            pm, m_ms = timed_plain(lambda: mm.mass_diagonal(
                mesh.nc, P, host(detJ), coeff.reshape(mesh.nc)))
            mb = gate("mass_diagonal_box", m1, pm, exact=True)
            cells_f = torch.as_tensor(np.asarray(bd)[:, 0].astype(np.int64),
                                      device=dev)
            r1 = setup.box_dofmap(cells_f, mesh.nc, P)
            if not torch.equal(r1, setup.box_dofmap(cells_f, mesh.nc, P)):
                fail(f"{label}: box_dofmap's launches differ")
            pr, r_ms = timed_plain(lambda: dofmap_rows(mesh.nc, P,
                                                       host(cells_f)))
            gate("box_dofmap", r1, pr, exact=True)
        else:
            dm = torch.as_tensor(mesh.dofmap, device=dev)
            pos, ptr = setup.inverse_map(dm, mesh.ndofs)
            y = setup.mass_diagonal_map(detJ.reshape(-1), ct, nq, pos, ptr)
            pm, m_ms = timed_plain(lambda: setup.mass_diagonal_map(
                detJ.reshape(-1).cpu(), ct.cpu(), nq, pos.cpu(), ptr.cpu()))
            mb = gate("mass_diagonal_map", y, pm, exact=True)
        print(f"   {label}: set-up kernels vs plain (float64, tol "
              f"{SETUP_TOL}; the dofmap and the diagonals bitwise), each "
              f"launched twice bitwise equal: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)
        if launches_ is None:
            return rows
        nf, nqf = fa.detJ.shape
        f64 = 8
        if hasattr(mesh, "nc"):
            _, g_ms = timed_plain(lambda: pre.geometry_of(
                host(gd), host(gr), host(w)))
            _, d_ms = timed_plain(lambda: pre.detJ_of(host(gd), host(gr),
                                                      host(w)))
            gb = gd.numel() * f64 + gr.numel() * f64 + nq * f64
            rows["setup_cell_geometry"] = dict(
                max_abs_err=mg, plain_ms=g_ms,
                ms=time_ms(lambda: setup.cell_geometry(gd, gr, w), 5),
                cost=(gb + cells * nq * 7 * f64, cells * nq * (18 * ng + 91),
                      PEAK_F64_PER_S))
            rows["setup_cell_detJ"] = dict(
                max_abs_err=md, plain_ms=d_ms,
                ms=time_ms(lambda: setup.cell_geometry(gd, gr, w, False), 5),
                cost=(gb + cells * nq * f64, cells * nq * (18 * ng + 18),
                      PEAK_F64_PER_S))
            sub = torch.as_tensor(np.ascontiguousarray(pre.facet_grads(
                mesh)[0][np.asarray(bd)[:, 0]]), device=dev)
            fg = torch.as_tensor(pre.facet_grads(mesh)[1], device=dev)
            fw = torch.as_tensor(mesh.element.facet_quad_weights,
                                 device=dev)
            loc = torch.as_tensor(np.stack([np.arange(nf), np.asarray(
                bd)[:, 1]], axis=1).astype(np.int64), device=dev)
            _, f_ms = timed_plain(lambda: pre.facet_geometry_of(
                host(sub), host(fg), host(fw), host(loc)))
            rows["setup_facet_geometry"] = dict(
                max_abs_err=mf, plain_ms=f_ms,
                ms=time_ms(lambda: setup.facet_geometry(sub, fg, fw, loc), 5),
                cost=(sub.numel() * f64 + fg.numel() * f64 + nf * 16
                      + nf * nqf * f64, nf * nqf * (12 * ng + 16),
                      PEAK_F64_PER_S))
            rows["setup_box_dofmap"] = dict(
                max_abs_err=0.0, plain_ms=r_ms,
                ms=time_ms(lambda: setup.box_dofmap(cells_f, mesh.nc, P), 5),
                cost=(nf * 8 + nf * (P + 1) ** 3 * 4, 0, PEAK_F64_PER_S))
            rows["setup_mass_diagonal_box"] = dict(
                max_abs_err=mb, plain_ms=m_ms,
                ms=time_ms(lambda: setup.mass_diagonal_box(
                    detJ, ct, mesh.nc, P), 5),
                cost=(detJ.numel() * f64 + cells * f64 + mesh.ndofs * f64,
                      2 * detJ.numel(), PEAK_F64_PER_S))
        else:
            g = dm.reshape(-1).long()
            v = (detJ * ct[:, None]).reshape(-1)
            rows["setup_mass_diagonal_map"] = dict(
                max_abs_err=mb, plain_ms=m_ms,
                ms=time_ms(lambda: setup.mass_diagonal_map(
                    detJ.reshape(-1), ct, nq, pos, ptr), 5),
                library_ms=time_ms(lambda: torch.zeros(
                    mesh.ndofs, dtype=torch.float64, device=dev).index_add_(
                        0, g, v), 5),
                cost=(detJ.numel() * (f64 + 4) + (mesh.ndofs + 1) * 4
                      + mesh.num_cells * f64 + mesh.ndofs * f64,
                      2 * detJ.numel(), PEAK_F64_PER_S))
        for name, row in rows.items():
            if not launches_[name]:
                fail(f"{label}: {name} was not launched in the model's "
                     "build")
            setup_launches[name] = launches_[name]
            print(f"   {smi}: {name} at {label}: {row['ms']:.4f} ms "
                  f"(bound {bound(*row['cost'])[0]:.4f} ms, "
                  f"{bound(*row['cost'])[1]}), plain {row['plain_ms']:.1f} "
                  f"ms (host), launches in the build {launches_[name]}"
                  + (f", index_add_ {row['library_ms']:.4f} ms"
                     if row.get("library_ms") else ""), flush=True)
        return rows

    with phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}, "
              f"{torch.cuda.get_device_name(0)}")

    with phase("2 build"):
        path, secs = _build.build()
        _build.load()
        print(f"built {path.relative_to(ROOT)} in {secs:.1f} s "
              f"(0 = reused)")

    with phase("3 kernel vs plain, P=2..10"):
        worst = {"f64": 0.0, "f32": 0.0, "parity": 0.0}
        cs.reset_launches()
        for P in range(2, 11):
            nc = (5, 3, 7) if P <= 6 else (3, 3, 5)
            mesh = build_box_mesh(nc, P, hi=(1.0, 0.8, 1.3), perturb=0.15,
                                  seed=P)
            _, Gh = pre.cell_geometry_factors(mesh)
            D = mesh.element.deriv_1d
            coeff = rng.uniform(0.5, 2.0, nc)
            C = rng.uniform(-2.0, 2.0, (mesh.num_cells, 2))
            x1 = rng.standard_normal(mesh.grid_shape)
            x2 = rng.standard_normal(mesh.grid_shape)
            cases = [("single", cs.pack_G(Gh), None),
                     ("single+coeff", cs.pack_G(Gh, coeff), None)]
            if P in PAIR_DEGREES:
                cases.append(("pair", cs.pack_G(Gh), C))
            for label, G, Cp in cases:
                def op(dtype):
                    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
                    return cs.CellStiffness(G=t(G), D=t(D), nc=nc,
                                            C=None if Cp is None else t(Cp))

                def apply(o, plain):
                    t = lambda a: torch.as_tensor(a, dtype=o.G.dtype,
                                                  device=dev)
                    if Cp is None:
                        f = cs.stiffness_plain if plain else cs.stiffness
                        return f(o, t(x1))
                    f = cs.stiffness_pair_plain if plain \
                        else cs.stiffness_pair
                    return f(o, t(x1), t(x2))

                def parity(o):
                    t = lambda a: torch.as_tensor(a, dtype=o.G.dtype,
                                                  device=dev)
                    if Cp is None:
                        return anatomy.variant_classes(o, t(x1), "full")
                    return anatomy.full_pair_classes(o, t(x1), t(x2))

                ref = apply(op(torch.float64), plain=True)
                y64 = apply(op(torch.float64), plain=False)
                y32 = apply(op(torch.float32), plain=False)
                e64, e32 = rel_l2(y64, ref), rel_l2(y32, ref)
                e_par = rel_l2(y64, parity(op(torch.float64)))
                same = all(torch.equal(y, apply(op(y.dtype), plain=False))
                           for y in (y64, y32))
                torch.cuda.synchronize()
                print(f"   P={P:2d} {label:13s} f64 {e64:.3e}  "
                      f"f32 {e32:.3e}  vs the parity-class kernel f64 "
                      f"{e_par:.3e}, "
                      f"two applies bitwise {same}", flush=True)
                worst["parity"] = max(worst["parity"], e_par)
                if not same:
                    fail(f"P={P} {label}: two applies differ")
                if not e_par <= PARITY_TOL:
                    fail(f"f64 kernel vs the parity-class kernel "
                         f"{e_par:.3e} > {PARITY_TOL}")
                worst["f64"] = max(worst["f64"], e64)
                worst["f32"] = max(worst["f32"], e32)
                if not e64 <= F64_TOL:
                    fail(f"f64 kernel vs plain {e64:.3e} > {F64_TOL}")
                if not e32 <= F32_TOL:
                    fail(f"f32 kernel vs plain f64 {e32:.3e} > {F32_TOL}")
        print(f"   worst rel-l2: f64 {worst['f64']:.3e} (tol {F64_TOL}), "
              f"f32 {worst['f32']:.3e} (tol {F32_TOL}), vs the parity-class "
              f"kernel "
              f"{worst['parity']:.3e} (tol {PARITY_TOL}); launches "
              f"{dict(cs.launches)}")
        if cs.launches["stiffness"] == 0 or cs.launches["stiffness_pair"] == 0:
            fail("a kernel's launch counter did not move")

    with phase("8 extruded kernels vs plain, P=2..10"), \
            tempfile.TemporaryDirectory() as tmp:
        worst = {"f64": 0.0, "f32": 0.0, "old": 0.0}
        ce.reset_launches()
        for P in range(2, 11):
            v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1,
                                           nr_ann=1, nz=4 if P <= 6 else 2)
            cyl = msh_io.read_msh(msh_io.write_msh(
                str(Path(tmp) / f"cyl{P}"), v, c, t), P)
            box = as_extruded(from_box(build_box_mesh(
                (5, 3, 7) if P <= 6 else (3, 3, 4), P, hi=(1.0, 0.8, 1.3)),
                shuffle_seed=11))
            for mname, mesh in (("cylinder", cyl), ("box", box)):
                disc = Discretization(mesh)
                print(f"   P={P:2d} {mname}: {mesh.num_cells} cells, "
                      f"{scatter_summary(mesh)}", flush=True)
                c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
                c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
                x1 = torch.as_tensor(rng.standard_normal(mesh.ndofs),
                                     device=dev)
                x2 = torch.as_tensor(rng.standard_normal(mesh.ndofs),
                                     device=dev)
                cases = [("single", {}), ("single+coeff", {"coeff": c1})]
                if P in PAIR_DEGREES:
                    cases.append(("pair", {"pair": (c1, c2)}))
                for label, kw in cases:
                    pair = "pair" in kw
                    fns = {"plain": (ce.extruded_plain,
                                     ce.extruded_pair_plain),
                           "kernel": (ce.extruded, ce.extruded_pair),
                           "classes": (ce.extruded_classes,
                                       ce.extruded_classes_pair)}

                    def apply(dtype, kind):
                        o = disc.stiffness_op(dtype, dev, **kw)
                        a, b = x1.to(dtype), x2.to(dtype)
                        f = fns[kind][pair]
                        return f(o, a, b) if pair else f(o, a)

                    ref = apply(torch.float64, "plain")
                    y64 = apply(torch.float64, "kernel")
                    y32 = apply(torch.float32, "kernel")
                    e64, e32 = rel_l2(y64, ref), rel_l2(y32, ref)
                    e_old = rel_l2(y64, apply(torch.float64, "classes"))
                    same = all(torch.equal(y, apply(y.dtype, "kernel"))
                               for y in (y64, y32))
                    torch.cuda.synchronize()
                    print(f"   P={P:2d} {mname:8s} {label:13s} f64 "
                          f"{e64:.3e}  f32 {e32:.3e}  vs the class-launch "
                          f"kernel f64 {e_old:.3e}, two applies bitwise "
                          f"{same}", flush=True)
                    worst["f64"] = max(worst["f64"], e64)
                    worst["f32"] = max(worst["f32"], e32)
                    worst["old"] = max(worst["old"], e_old)
                    if not same:
                        fail(f"P={P} {mname} {label}: two applies differ")
                    if not e64 <= F64_TOL:
                        fail(f"f64 extruded kernel vs plain {e64:.3e}")
                    if not e32 <= F32_TOL:
                        fail(f"f32 extruded kernel vs plain f64 {e32:.3e}")
                    if not e_old <= PARITY_TOL:
                        fail(f"f64 stack kernel vs the class-launch kernel "
                             f"{e_old:.3e} > {PARITY_TOL}")
        print(f"   worst rel-l2: f64 {worst['f64']:.3e} (tol {F64_TOL}), "
              f"f32 {worst['f32']:.3e} (tol {F32_TOL}), vs the class-launch "
              f"kernel {worst['old']:.3e} (tol {PARITY_TOL}); launches "
              f"{dict(ce.launches)}, {dict(ce.class_launches)}")
        if ce.launches["extruded"] == 0 or ce.launches["extruded_pair"] == 0:
            fail("an extruded kernel's launch counter did not move")

    with phase("12 indexed kernels vs plain, P=2..10"), \
            tempfile.TemporaryDirectory() as tmp:
        worst = {"f64": 0.0, "f32": 0.0, "old": 0.0}
        ci.reset_launches()
        for P in range(2, 11):
            v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1,
                                           nr_ann=1, nz=4 if P <= 6 else 2)
            cyl = msh_io.read_msh(msh_io.write_msh(
                str(Path(tmp) / f"gcyl{P}"), v, c, t), P,
                detect_extrusion=False)
            box = from_box(build_box_mesh(
                (5, 3, 7) if P <= 6 else (3, 3, 4), P, hi=(1.0, 0.8, 1.3),
                perturb=0.15, seed=P), shuffle_seed=11)
            for mname, mesh in (("cylinder", cyl), ("box", box)):
                disc = Discretization(mesh)
                c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
                c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
                x1 = torch.as_tensor(rng.standard_normal(mesh.ndofs),
                                     device=dev)
                x2 = torch.as_tensor(rng.standard_normal(mesh.ndofs),
                                     device=dev)
                cases = [("single", {}), ("single+coeff", {"coeff": c1})]
                if P in PAIR_DEGREES:
                    cases.append(("pair", {"pair": (c1, c2)}))
                for label, kw in cases:
                    pair = "pair" in kw
                    fns = {"plain": (ci.indexed_plain, ci.indexed_pair_plain),
                           "kernel": (ci.indexed, ci.indexed_pair),
                           "classes": (ci.indexed_classes,
                                       ci.indexed_classes_pair)}

                    def apply(dtype, kind):
                        o = disc.stiffness_op(dtype, dev, **kw)
                        a, b = x1.to(dtype), x2.to(dtype)
                        f = fns[kind][pair]
                        return f(o, a, b) if pair else f(o, a)

                    ref = apply(torch.float64, "plain")
                    y64 = apply(torch.float64, "kernel")
                    y32 = apply(torch.float32, "kernel")
                    e64, e32 = rel_l2(y64, ref), rel_l2(y32, ref)
                    e_old = rel_l2(y64, apply(torch.float64, "classes"))
                    same = all(torch.equal(y, apply(y.dtype, "kernel"))
                               for y in (y64, y32))
                    torch.cuda.synchronize()
                    print(f"   P={P:2d} {mname:8s} {label:13s} f64 "
                          f"{e64:.3e}  f32 {e32:.3e}  vs the class-launch "
                          f"kernel f64 {e_old:.3e}, two applies bitwise "
                          f"{same}", flush=True)
                    worst["f64"] = max(worst["f64"], e64)
                    worst["f32"] = max(worst["f32"], e32)
                    worst["old"] = max(worst["old"], e_old)
                    if not same:
                        fail(f"P={P} {mname} {label}: two applies differ")
                    if not e64 <= F64_TOL:
                        fail(f"f64 indexed kernel vs plain {e64:.3e}")
                    if not e32 <= F32_TOL:
                        fail(f"f32 indexed kernel vs plain f64 {e32:.3e}")
                    if not e_old <= PARITY_TOL:
                        fail(f"f64 chunk kernel vs the class-launch kernel "
                             f"{e_old:.3e} > {PARITY_TOL}")
                ist = IndexedStiffness(disc.stiffness_op(torch.float32, dev),
                                       "cuda")
                print(f"   P={P:2d} {mname}: {mesh.num_cells} cells, "
                      f"{ist.scatter_summary()}", flush=True)
        print(f"   worst rel-l2: f64 {worst['f64']:.3e} (tol {F64_TOL}), "
              f"f32 {worst['f32']:.3e} (tol {F32_TOL}), vs the class-launch "
              f"kernel {worst['old']:.3e} (tol {PARITY_TOL}); launches "
              f"{dict(ci.launches)}, {dict(ci.class_launches)}")
        if ci.launches["indexed"] == 0 or ci.launches["indexed_pair"] == 0:
            fail("an indexed kernel's launch counter did not move")

    # ---- phase 34: bfloat16 state, the bf16 forms of #1 / #2, #6 and #11
    # ---- (a generator of its own, so that the other phases' inputs stay
    # ---- as they were) ----
    BF16 = torch.bfloat16
    rng16 = np.random.default_rng(34)
    bf16_counts = {}                    # the main path's bf16 launches
    forms16 = {                         # (plain, kernel) by route and form
        "#1 / #2": ((cs.stiffness_plain, cs.stiffness_pair_plain),
                    (cs.stiffness, cs.stiffness_pair)),
        "#6": ((ce.extruded_plain, ce.extruded_pair_plain),
               (ce.extruded, ce.extruded_pair)),
        "#11": ((ci.indexed_plain, ci.indexed_pair_plain),
                (ci.indexed, ci.indexed_pair))}

    def bf16_counters() -> dict:
        return {**cs.bf16_launches, **ce.bf16_launches, **ci.bf16_launches,
                **cc.bf16_launches}

    def bf16_reset() -> None:
        for mod in (cs, ce, ci, cc):
            mod.reset_launches()

    with phase("34a bf16 kernels vs plain, P=2..10: #1 / #2, #6 and #11, "
               "single and pair, on phases 3, 8 and 12's meshes"), \
            tempfile.TemporaryDirectory() as tmp:
        worst16 = {"plain": 0.0, "f64": 0.0}
        bf16_reset()
        for P in range(2, 11):
            v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1,
                                           nr_ann=1, nz=4 if P <= 6 else 2)
            path = msh_io.write_msh(str(Path(tmp) / f"cyl{P}"), v, c, t)
            small = (5, 3, 7) if P <= 6 else (3, 3, 4)
            meshes = [
                ("#1 / #2", "box", build_box_mesh(
                    (5, 3, 7) if P <= 6 else (3, 3, 5), P,
                    hi=(1.0, 0.8, 1.3), perturb=0.15, seed=P)),
                ("#6", "cylinder", msh_io.read_msh(path, P)),
                ("#6", "box", as_extruded(from_box(build_box_mesh(
                    small, P, hi=(1.0, 0.8, 1.3)), shuffle_seed=11))),
                ("#11", "cylinder", msh_io.read_msh(
                    path, P, detect_extrusion=False)),
                ("#11", "box", from_box(build_box_mesh(
                    small, P, hi=(1.0, 0.8, 1.3), perturb=0.15, seed=P),
                    shuffle_seed=11))]
            for route, mname, mesh in meshes:
                disc = Discretization(mesh)
                n = mesh.num_cells
                c1 = rng16.uniform(0.5, 2.0, n)
                c2 = rng16.uniform(-1.5, -0.5, n)
                if hasattr(mesh, "nc"):
                    c1, c2 = c1.reshape(mesh.nc), c2.reshape(mesh.nc)
                xs = [torch.as_tensor(rng16.standard_normal(mesh.grid_shape),
                                      device=dev) for _ in range(2)]
                for label, kw in (("single", {}),
                                  ("single+coeff", {"coeff": c1}),
                                  ("pair", {"pair": (c1, c2)})):
                    pair = "pair" in kw
                    plain, kernel = (f[pair] for f in forms16[route])

                    def apply(dtype, f):
                        o = disc.stiffness_op(dtype, dev, **kw)
                        a = [x.to(dtype) for x in xs[:1 + pair]]
                        return f(o, *a)

                    y = apply(BF16, kernel)
                    e = rel_l2(y, apply(BF16, plain))
                    e64 = rel_l2(y, apply(torch.float64, plain))
                    same = torch.equal(y, apply(BF16, kernel))
                    torch.cuda.synchronize()
                    print(f"   P={P:2d} {route:7s} {mname:8s} {label:13s} "
                          f"bf16 vs plain bf16 {e:.3e}, vs plain f64 "
                          f"{e64:.3e}, two applies bitwise {same}",
                          flush=True)
                    worst16["plain"] = max(worst16["plain"], e)
                    worst16["f64"] = max(worst16["f64"], e64)
                    if not same:
                        fail(f"34a: P={P} {route} {mname} {label}: two "
                             "bf16 applies differ")
                    if not e <= BF16_TOL:
                        fail(f"34a: P={P} {route} {mname} {label}: bf16 "
                             f"kernel vs plain {e:.3e} > {BF16_TOL}")
        counts = {**cs.bf16_launches, **ce.bf16_launches,
                  **ci.bf16_launches}
        print(f"   worst rel-l2: bf16 kernel vs plain bf16 "
              f"{worst16['plain']:.3e} (tol {BF16_TOL}), vs plain f64 "
              f"{worst16['f64']:.3e}; bf16 launches {counts}")
        if not all(counts.values()):
            fail(f"34a: a bf16 kernel's launch counter did not move: "
                 f"{counts}")

    def bf16_model(label, argv, pb):
        """The bowl of `argv` in bf16 on the problem `pb`: a model on the
        bf16 form of its G-stream kernel, which is held against its plain
        version (bf16 in, float32 arithmetic, y rounded once) on unit
        normal inputs, repeated bitwise and timed.  Returns (model, dt,
        steps, focus, plain module, kernel entry for the JSON line)."""
        args_ = nonlinear_bowl.parser().parse_args(argv + ["--dtype",
                                                           "bf16"])
        model, dt_, nsteps_, focus_ = nonlinear_bowl.build(args_, pb)
        kst, mesh = model.stiffness, model.mesh
        if kst.impl != "cuda" or kst.G.dtype != BF16 or \
                not kst.kernel.endswith("_bf16"):
            fail(f"34: {label}: not on a bf16 kernel ({kst.kernel})")
        pst = type(kst)(kst.cell_op, "mm")
        xs = [torch.as_tensor(rng16.standard_normal(mesh.grid_shape),
                              dtype=BF16, device=dev)
              for _ in range(2 if kst.is_pair else 1)]
        run = (lambda m: m.pair(*xs)) if kst.is_pair else \
            (lambda m: m(xs[0]))
        yk, yp = run(kst), run(pst)
        err, same = rel_l2(yk, yp), torch.equal(yk, run(kst))
        if not (err <= BF16_TOL and same):
            fail(f"34: {label}: bf16 kernel vs plain {err:.3e} (tol "
                 f"{BF16_TOL}), repeat bitwise {same}")
        extra = (kst.rows.numel() * 4 if hasattr(kst, "rows") else
                 kst.dofmap.numel() * 4 if hasattr(kst, "dofmap") else 0)
        entry = dict(max_abs_err=float((yk.float() - yp.float()).abs().max()),
                     rel_l2=err, ms=time_ms(lambda: run(kst), 20),
                     plain_ms=time_ms(lambda: run(pst), 10),
                     cost=apply_cost(kst.G, mesh.ndofs, len(xs),
                                     extra=extra))
        print(f"   {smi}: {label} in bf16 ({kst.kernel}): {entry}; two "
              f"applies bitwise", flush=True)
        if isinstance(kst, IndexedStiffness):
            print(f"   {kst.scatter_summary()}")
        elif isinstance(kst, ExtrudedStiffness):
            sch = ce.card_schedule(kst.cell_op, xs[0], kst.is_pair)
            print(f"   {stack_summary(sch)}")
        else:
            sch = cs.card_schedule(kst.cell_op, xs[0], kst.is_pair)
            print(f"   pencil kernel: {sch.cpb} cells a chunk, "
                  f"{sch.stage_bytes:,} B a stage, {sch.smem:,} B shared a "
                  f"block, {sch.blocks_per_sm} blocks an SM, {sch.blocks} "
                  "blocks")
        return model, dt_, nsteps_, focus_, pst, entry

    def bf16_steps(model, dt_, steps, label) -> tuple:
        """`steps` RK4 steps of a bf16 model from rest, the bf16 counters
        reset just before and read just after: each its kernel's 4 a step,
        the state finite and non-zero.  Returns (state, the kernel's
        launches)."""
        kernel = model.stiffness.kernel
        bf16_reset()
        s, _ = model.solve(model.init_state(), dt_, steps)
        torch.cuda.synchronize()
        counts = bf16_counters()
        print(f"   {label}: {steps} bf16 steps, launches "
              f"{ {k: v for k, v in counts.items() if v} }, max |u| "
              f"{float(s.u.abs().max()):.4e}", flush=True)
        if counts[kernel] != 4 * steps or sum(counts.values()) != 4 * steps:
            fail(f"34: {label}: launches {counts} != 4 x {steps} of "
                 f"{kernel}")
        if not bool(torch.isfinite(s.u).all()) or \
                float(s.u.abs().max()) == 0.0:
            fail(f"34: {label}: the bf16 field is not finite and non-zero")
        return s, counts[kernel]

    def ms_turns(models, steps: int = 50) -> dict:
        """ms a step of each (name, model, dt) from rest, in turns: each
        model, then each again in reverse order; the smaller of its two.
        A solve of `steps` steps of each comes first, untimed: it captures
        the graphs that the timed solves replay."""
        out = {}
        for _, model, dt_ in models:
            model.solve(model.init_state(), dt_, steps)
        for name, model, dt_ in (*models, *reversed(models)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.solve(model.init_state(), dt_, steps)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
            out[name] = min(out.get(name, ms), ms)
        return out

    def captured_solve(model, dt_, label, tol):
        """Phase 35: 10 replayed steps of `model`'s solver against the same
        10 steps launched eagerly (bitwise) and against the eager loop of
        Python-float coefficients (`timestepping.solve`, <= `tol`); then
        ``demos/exp_solver``'s turns over 50 steps (python-float, eager,
        captured), the captured form again bitwise the eager one, and the
        device busy and idle share of each from the profiler's trace."""
        flat = model._flat_state(model.init_state())
        solver = model.solver(10)
        before = [dict(d) for d in launch.counter_dicts()]
        cap = solver(flat, dt_)[0]
        held = {k: n - b[k] for d, b in zip(launch.counter_dicts(), before)
                for k, n in d.items() if n != b[k]}
        eag = solver.eager(flat, dt_)[0]
        old = timestepping.solve(model._rhs, flat, dt_, 10)
        same = all(torch.equal(a, b) for a, b in zip(cap[:4], eag[:4]))
        traj = rel_l2(cap.u, old.u)
        print(f"   {label}: 10 replayed steps (graphs of "
              f"{solver.chunk} steps) vs 10 eager steps of the same step "
              f"function: {'bitwise equal' if same else 'NOT bitwise'}; vs "
              f"the Python-float loop rel-l2(u) {traj:.3e} (tol {tol}); "
              f"the replays counted {held}", flush=True)
        if not same:
            fail(f"35: {label}: 10 replayed steps differ from 10 eager ones")
        if not traj <= tol:
            fail(f"35: {label}: captured vs the Python-float loop "
                 f"{traj:.3e} > {tol}")
        if not held or any(n % 10 for n in held.values()):
            fail(f"35: {label}: the replays counted {held}")
        r = exp_solver.run(model, dt_, steps=50, turns=1)
        if not r["bitwise_captured_eager"]:
            fail(f"35: {label}: 50 captured steps differ from eager ones")
        best = {k: min(v) for k, v in r["ms_per_step"].items()}
        prof = {f: r.get(f"profile_{f}", {}) for f in ("eager", "captured")}
        print(f"   {smi}: {label} ms a step over 50 steps in turns: "
              + ", ".join(f"{k} {v:.4f}" for k, v in best.items())
              + "; under the profiler: " + ", ".join(
                  f"{f} busy {p.get('busy_ms') or 0:.4f} of a span of "
                  f"{p.get('span_ms') or 0:.4f} ms (idle "
                  f"{(p.get('idle') or 0):.4%})" for f, p in prof.items()),
              flush=True)
        return r

    def axpy_entry(dtype, n):
        """The RK4 update kernel on `n` values in `dtype` (a coefficient
        in its update type): bitwise its plain version and PyTorch's add
        with the coefficient as a Python float (the library call), each
        timed; its least bytes (x, y read, out written) and operations."""
        x, y = (torch.as_tensor(rng.standard_normal(n), device=dev).to(
            dtype) for _ in range(2))
        a = torch.tensor(0.37, device=dev, dtype=cv.coefficient_dtype(dtype))
        alpha = float(a)
        yk, yp = cv.axpy(a, x, y), cv.axpy_plain(a, x, y)
        lib = torch.add(y, x, alpha=alpha)
        if not (torch.equal(yk, yp) and torch.equal(yk, lib)):
            fail(f"axpy ({dtype}): the kernel is not bitwise its plain "
                 "version and torch.add")
        e = dict(max_abs_err=0.0, rel_l2=0.0,
                 ms=time_ms(lambda: cv.axpy(a, x, y), 20),
                 plain_ms=time_ms(lambda: cv.axpy_plain(a, x, y), 20),
                 library_ms=time_ms(lambda: torch.add(y, x, alpha=alpha),
                                    20),
                 cost=(3 * n * x.element_size(), 2 * n))
        print(f"   {smi}: the RK4 update kernel on {n:,} {dtype} values: "
              f"{e}", flush=True)
        return e

    def bf16_corner(label, argv, pb, kernel):
        """The bowl of `argv` in corner mode in bf16 on the problem `pb`: a
        model on the bf16 form of its corner kernel (`kernel`_bf16), built
        without the host metric, held against its plain version (bf16 in,
        the metric and the apply in float32, y rounded once) on unit
        normal inputs, repeated bitwise and timed.  Returns (model, dt,
        steps, focus, plain module, kernel entry for the JSON line)."""
        args_ = nonlinear_bowl.parser().parse_args(argv + ["--dtype",
                                                           "bf16"])
        t0 = time.perf_counter()
        model, dt_, nsteps_, focus_ = nonlinear_bowl.build(args_, pb)
        t_build = time.perf_counter() - t0
        kst, mesh = model.stiffness, model.mesh
        if not isinstance(kst, CornerStiffness) or kst.T.dtype != BF16 or \
                model.stiffness_kernel != f"{kernel}_bf16":
            fail(f"34: {label}: {type(kst).__name__} on "
                 f"{model.stiffness_kernel}, expected {kernel}_bf16")
        if "_G_host" in model.disc.__dict__:
            fail(f"34: {label}: the bf16 corner model built the host metric")
        pst = CornerStiffness(kst.cell_op, "mm")
        xs = [torch.as_tensor(rng16.standard_normal(mesh.grid_shape),
                              dtype=BF16, device=dev)
              for _ in range(2 if kst.is_pair else 1)]
        run = (lambda m: m.pair(*xs)) if kst.is_pair else \
            (lambda m: m(xs[0]))
        yk, yp = run(kst), run(pst)
        err, same = rel_l2(yk, yp), torch.equal(yk, run(kst))
        if not (err <= BF16_TOL and same):
            fail(f"34: {label}: bf16 corner kernel vs plain {err:.3e} (tol "
                 f"{BF16_TOL}), repeat bitwise {same}")
        index = kst.rows.numel() * 4 if kst.rows is not None else 0
        entry = dict(max_abs_err=float((yk.float() - yp.float()).abs().max()),
                     rel_l2=err, ms=time_ms(lambda: run(kst), 20),
                     plain_ms=time_ms(lambda: run(pst), 10),
                     cost=cc.apply_cost(kst.cell_op, mesh.ndofs, len(xs),
                                        extra=index))
        sch = cc.card_schedule(kst.cell_op, xs[0], kst.is_pair)
        segs = (f", {sch.segments} segment(s) a stack"
                if hasattr(sch, "segments") else "")
        print(f"   {smi}: {label} in bf16 corner mode ({kst.kernel}; built "
              f"in {t_build:.1f} s, no host metric): {entry}; two applies "
              f"bitwise; walk schedule {sch.cpb} cells a chunk{segs}, "
              f"{sch.stage_bytes:,} B a stage, {sch.smem:,} B shared a "
              f"block, {sch.blocks_per_sm} blocks an SM, {sch.blocks} "
              "blocks", flush=True)
        return model, dt_, nsteps_, focus_, pst, entry

    with phase("16 corner kernels vs plain, P=2..10, float64, float32 and "
               "bf16 (34f)"), tempfile.TemporaryDirectory() as tmp:
        worst = {"f64": 0.0, "f32": 0.0, "g64": 0.0, "old": 0.0,
                 "bf16": 0.0, "g16": 0.0}
        cc.reset_launches()
        for P in range(2, 11):
            small = P > 6
            v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1,
                                           nr_ann=1, nz=2 if small else 4)
            meshes = (
                ("box", build_box_mesh(
                    (3, 3, 5) if small else (5, 3, 7), P,
                    hi=(1.0, 0.8, 1.3), perturb=0.15, seed=P)),
                ("cylinder", msh_io.read_msh(msh_io.write_msh(
                    str(Path(tmp) / f"ccyl{P}"), v, c, t), P)),
                ("shuffled", as_extruded(from_box(build_box_mesh(
                    (3, 3, 4) if small else (5, 3, 7), P,
                    hi=(1.0, 0.8, 1.3)), shuffle_seed=11))),
                ("hex27", as_extruded(shapes.hex27_lattice(from_box(
                    build_box_mesh((2, 2, 3) if small else (3, 2, 4), P),
                    shuffle_seed=11), shapes.curved_prism_map))))
            for mname, mesh in meshes:
                disc = Discretization(mesh)
                shape = mesh.nc if mname == "box" else (mesh.num_cells,)
                c1 = rng.uniform(0.5, 2.0, shape)
                c2 = rng.uniform(-1.5, -0.5, shape)
                x1 = torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                                     device=dev)
                x2 = torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                                     device=dev)
                cases = [("single", {}), ("single+coeff", {"coeff": c1})]
                if P in PAIR_DEGREES:
                    cases.append(("pair", {"pair": (c1, c2)}))
                for label, kw in cases:
                    pair = "pair" in kw

                    def run(module, dtype):
                        a, b = x1.to(dtype), x2.to(dtype)
                        return module.pair(a, b) if pair else module(a)

                    op64 = disc.stiffness_op(torch.float64, dev,
                                             corner=True, **kw)
                    op32 = disc.stiffness_op(torch.float32, dev,
                                             corner=True, **kw)
                    ref = run(CornerStiffness(op64, "mm"), torch.float64)
                    k64 = CornerStiffness(op64, "cuda")
                    k32 = CornerStiffness(op32, "cuda")
                    y64 = run(k64, torch.float64)
                    y32 = run(k32, torch.float32)
                    e64 = rel_l2(y64, ref)
                    e32 = rel_l2(y32, ref)
                    g64 = rel_l2(y64, run(stiffness_module(
                        disc.stiffness_op(torch.float64, dev, **kw),
                        "cuda"), torch.float64))
                    o64 = rel_l2(y64, run(ClassLaunchCorner(op64),
                                          torch.float64))
                    same = torch.equal(run(k64, torch.float64), y64) and \
                        torch.equal(run(k32, torch.float32), y32)
                    torch.cuda.synchronize()
                    print(f"   P={P:2d} {mname:8s} {label:13s} f64 "
                          f"{e64:.3e}  f32 {e32:.3e}  vs G stream "
                          f"{g64:.3e}  vs class-launch {o64:.3e}  repeat "
                          f"{'bitwise' if same else 'DIFFERS'}", flush=True)
                    for key, e in (("f64", e64), ("f32", e32),
                                   ("g64", g64), ("old", o64)):
                        worst[key] = max(worst[key], e)
                    if not e64 <= F64_TOL:
                        fail(f"f64 corner kernel vs plain {e64:.3e}")
                    if not e32 <= F32_TOL:
                        fail(f"f32 corner kernel vs plain f64 {e32:.3e}")
                    if not g64 <= F64_TOL:
                        fail(f"f64 corner kernel vs G-stream kernel "
                             f"{g64:.3e}")
                    if not o64 <= PARITY_TOL:
                        fail(f"f64 corner walk vs the class-launch design "
                             f"{o64:.3e} > {PARITY_TOL}")
                    if not same:
                        fail("a repeated corner apply is not bitwise equal")
                # 34f: the bf16 forms, single and pair at every degree,
                # on the same inputs in bf16
                for label, kw in (("single", {}),
                                  ("single+coeff", {"coeff": c1}),
                                  ("pair", {"pair": (c1, c2)})):
                    a16 = [x1.to(BF16), x2.to(BF16)] if "pair" in kw \
                        else [x1.to(BF16)]

                    def run16(module):
                        return module.pair(*a16) if len(a16) == 2 \
                            else module(a16[0])

                    op16 = disc.stiffness_op(BF16, dev, corner=True, **kw)
                    k16 = CornerStiffness(op16, "cuda")
                    y16 = run16(k16)
                    e16 = rel_l2(y16, run16(CornerStiffness(op16, "mm")))
                    g16 = rel_l2(y16, run16(stiffness_module(
                        disc.stiffness_op(BF16, dev, **kw), "cuda")))
                    same = torch.equal(run16(k16), y16)
                    torch.cuda.synchronize()
                    print(f"   P={P:2d} {mname:8s} {label:13s} bf16 vs plain "
                          f"bf16 {e16:.3e}  vs the bf16 G stream {g16:.3e}  "
                          f"repeat {'bitwise' if same else 'DIFFERS'}",
                          flush=True)
                    worst["bf16"] = max(worst["bf16"], e16)
                    worst["g16"] = max(worst["g16"], g16)
                    if not e16 <= BF16_TOL:
                        fail(f"34f: P={P} {mname} {label}: bf16 corner "
                             f"kernel vs plain {e16:.3e} > {BF16_TOL}")
                    if not g16 <= BF16_G_TOL:
                        fail(f"34f: P={P} {mname} {label}: bf16 corner vs "
                             f"bf16 G-stream kernel {g16:.3e} > "
                             f"{BF16_G_TOL}")
                    if not same:
                        fail(f"34f: P={P} {mname} {label}: two bf16 corner "
                             "applies differ")
        print(f"   worst rel-l2: f64 {worst['f64']:.3e}, f32 "
              f"{worst['f32']:.3e}, vs the G stream {worst['g64']:.3e}, "
              f"vs the class-launch design {worst['old']:.3e} (tol "
              f"{PARITY_TOL}); bf16 vs plain {worst['bf16']:.3e} (tol "
              f"{BF16_TOL}), vs the bf16 G stream {worst['g16']:.3e} (tol "
              f"{BF16_G_TOL}); launches {dict(cc.launches)}, "
              f"{dict(cc.class_launches)}, {dict(cc.bf16_launches)}")
        if not all(cc.launches.values()) or \
                not all(cc.class_launches.values()) or \
                not all(cc.bf16_launches.values()):
            fail("a corner kernel's launch counter did not move")

    with phase("20 engine kernels vs plain, P=2..10"), \
            tempfile.TemporaryDirectory() as tmp:
        worst = {"f64": 0.0, "f32": 0.0, "indexed": 0.0}
        cen.reset_launches()
        for P in range(2, 11):
            v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1,
                                           nr_ann=1, nz=4 if P <= 6 else 2)
            cyl = msh_io.read_msh(msh_io.write_msh(
                str(Path(tmp) / f"ecyl{P}"), v, c, t), P,
                detect_extrusion=False)
            box = from_box(build_box_mesh(
                (5, 3, 7) if P <= 6 else (3, 3, 4), P, hi=(1.0, 0.8, 1.3),
                perturb=0.15, seed=P), shuffle_seed=11)
            for mname, mesh in (("cylinder", cyl), ("box", box)):
                disc = Discretization(mesh)
                c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
                c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
                x1 = torch.as_tensor(rng.standard_normal(mesh.ndofs),
                                     device=dev)
                x2 = torch.as_tensor(rng.standard_normal(mesh.ndofs),
                                     device=dev)
                for label, kw in (("single", {}), ("single+coeff",
                                                   {"coeff": c1}),
                                  ("pair", {"pair": (c1, c2)})):
                    pair = "pair" in kw
                    o64 = disc.stiffness_op(torch.float64, dev, engine=True,
                                            **kw)
                    p64 = cen.to_plain(o64)
                    ref = (cen.engine_pair_plain(o64, x1, x2) if pair
                           else cen.engine_plain(o64, x1))
                    errs = {}
                    for dtype, key in ((torch.float64, "f64"),
                                       (torch.float32, "f32")):
                        op = disc.stiffness_op(dtype, dev, engine=True, **kw)
                        a, b = x1.to(dtype), x2.to(dtype)
                        g = op.dofmap.reshape(-1).long()
                        # each kernel alone against its plain version
                        if pair:
                            u1, u2 = cen.gather2(op, a, b)
                            ok = (torch.equal(u1.reshape(-1), eng.gather(a, g))
                                  and torch.equal(u2.reshape(-1),
                                                  eng.gather(b, g)))
                            # the first design, kept as the comparison
                            f1, f2 = cen.gather2_flat(op, a, b)
                            ok = ok and torch.equal(f1, u1) and \
                                torch.equal(f2, u2)
                            uc = (p64.c1[:, None] * u1.double()
                                  + p64.c2[:, None] * u2.double())
                            yk = cen.contract(op, u1, u2)
                        else:
                            u1 = cen.gather(op, a)
                            ok = torch.equal(u1.reshape(-1), eng.gather(a, g))
                            # the first design, kept as the comparison
                            ok = ok and torch.equal(cen.gather_flat(op, a),
                                                    u1)
                            uc = u1.double()
                            yk = cen.contract(op, u1)
                        if not ok:
                            fail(f"P={P} {mname} {label} {key}: gather not "
                                 "bitwise equal to plain and to its "
                                 "one-thread-a-position first design")
                        ec = rel_l2(yk, eng.dense_contract(uc, p64.G6, p64.D,
                                                           p64.coeff))
                        es = rel_l2(cen.scatter(op, yk), eng.scatter_add(
                            yk.double(), g, mesh.ndofs))
                        y = (cen.engine_pair(op, a, b) if pair
                             else cen.engine(op, a))
                        e = max(rel_l2(y, ref), ec, es)
                        errs[key] = e
                        tol = F64_TOL if key == "f64" else F32_TOL
                        if not e <= tol:
                            fail(f"P={P} {mname} {label} {key}: engine vs "
                                 f"plain {e:.3e} (contract {ec:.3e}, "
                                 f"scatter {es:.3e})")
                        worst[key] = max(worst[key], e)
                        if "coeff" not in kw:
                            iop = cen.to_indexed(op, disc.chunk_plan)
                            yi = (ci.indexed_pair(iop, a, b) if pair
                                  else ci.indexed(iop, a))
                            ei = rel_l2(y, yi)
                            errs[f"indexed {key}"] = ei
                            if not ei <= tol:
                                fail(f"P={P} {mname} {label} {key}: engine "
                                     f"vs indexed kernel {ei:.3e}")
                            worst["indexed"] = max(worst["indexed"],
                                                   ei if key == "f64" else 0)
                    torch.cuda.synchronize()
                    print(f"   P={P:2d} {mname:8s} {label:13s} "
                          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
                          flush=True)
        print(f"   worst rel-l2 against plain (each kernel and composed): "
              f"f64 {worst['f64']:.3e} (tol {F64_TOL}), f32 "
              f"{worst['f32']:.3e} (tol {F32_TOL}); f64 against the indexed "
              f"kernel {worst['indexed']:.3e}; the gathers bitwise equal to "
              f"plain and to their first designs; launches "
              f"{dict(cen.launches)}, the first designs "
              f"{dict(cen.comparison_launches)}")
        if not all(cen.launches.values()) or \
                not cen.comparison_launches["engine_gather_flat"] or \
                not cen.comparison_launches["engine_gather2_flat"]:
            fail("an engine kernel's launch counter did not move")

    with phase("34j bf16 engine kernels vs plain, P=2..10: #7-#10 alone, "
               "the composed apply and pair, against bf16 #11 on the same "
               "buffers, #9 and #10 against their first designs, on phase "
               "20's meshes"), \
            tempfile.TemporaryDirectory() as tmp:
        worst16, differ16, values16 = {}, 0, 0
        cen.reset_launches()
        for P in range(2, 11):
            v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1,
                                           nr_ann=1, nz=4 if P <= 6 else 2)
            cyl = msh_io.read_msh(msh_io.write_msh(
                str(Path(tmp) / f"ecyl{P}"), v, c, t), P,
                detect_extrusion=False)
            box = from_box(build_box_mesh(
                (5, 3, 7) if P <= 6 else (3, 3, 4), P, hi=(1.0, 0.8, 1.3),
                perturb=0.15, seed=P), shuffle_seed=11)
            for mname, mesh in (("cylinder", cyl), ("box", box)):
                disc = Discretization(mesh)
                c1 = rng16.uniform(0.5, 2.0, mesh.num_cells)
                c2 = rng16.uniform(-1.5, -0.5, mesh.num_cells)
                x1, x2 = (torch.as_tensor(rng16.standard_normal(mesh.ndofs),
                                          device=dev).to(BF16)
                          for _ in range(2))
                for label, kw in (("single", {}), ("single+coeff",
                                                   {"coeff": c1}),
                                  ("pair", {"pair": (c1, c2)})):
                    pair = "pair" in kw
                    op = disc.stiffness_op(BF16, dev, engine=True, **kw)
                    p16 = cen.to_plain(op)
                    if pair:
                        u1, u2 = cen.gather2(op, x1, x2)
                        ok = (torch.equal(u1.reshape(-1),
                                          x1.index_select(0, p16.g))
                              and torch.equal(u2.reshape(-1),
                                              x2.index_select(0, p16.g)))
                        # gather2 against its first design
                        f1, f2 = cen.gather2_flat(op, x1, x2)
                        ok = ok and torch.equal(f1, u1) and \
                            torch.equal(f2, u2)
                        yk = cen.contract(op, u1, u2)
                        yp = eng.dense_contract(eng.fold(u1, p16.c1, u2,
                                                         p16.c2), p16.G6,
                                                p16.D)
                    else:
                        u1 = cen.gather(op, x1)
                        ok = torch.equal(u1.reshape(-1),
                                         x1.index_select(0, p16.g))
                        yk = cen.contract(op, u1)
                        yp = eng.dense_contract(u1, p16.G6, p16.D, p16.coeff)
                    ys = cen.scatter(op, yk)
                    errs = {"contract": rel_l2(yk, yp),
                            "scatter": rel_l2(ys, eng.scatter_add(
                                yk, p16.g, mesh.ndofs))}
                    # the redesigned #9 and #10 against the first designs
                    yo = cen.contract_cells(op, *((u1, u2) if pair
                                                  else (u1,)))
                    differ = int((yk != yo).sum())
                    errs["vs first #9"] = rel_l2(yk, yo)
                    if differ > yk.numel() // 100 or not torch.equal(
                            ys, cen.scatter_dofs(op, yk)):
                        fail(f"34j: P={P} {mname} {label}: #9 differs from "
                             f"its first design in {differ} of "
                             f"{yk.numel()} values, or #10 not bitwise its "
                             f"first design's")
                    differ16 += differ
                    values16 += yk.numel()
                    run = (lambda: cen.engine_pair(op, x1, x2)) if pair \
                        else (lambda: cen.engine(op, x1))
                    y = run()
                    errs["apply"] = rel_l2(y, cen.engine_pair_plain(
                        op, x1, x2) if pair else cen.engine_plain(op, x1))
                    same = torch.equal(run(), y)
                    if "coeff" not in kw:
                        iop = cen.to_indexed(op, disc.chunk_plan)
                        errs["vs #11"] = rel_l2(y, ci.indexed_pair(
                            iop, x1, x2) if pair else ci.indexed(iop, x1))
                    torch.cuda.synchronize()
                    print(f"   P={P:2d} {mname:8s} {label:13s} " + ", ".join(
                        f"{k} {e:.3e}" for k, e in errs.items()), flush=True)
                    if not (ok and same):
                        fail(f"34j: P={P} {mname} {label}: gather bitwise "
                             f"index_select (gather2: and its first design) "
                             f"{ok}, two applies bitwise {same}")
                    for k, e in errs.items():
                        tol = {"vs #11": BF16_G_TOL,
                               "vs first #9": FIRST_DESIGN_TOL}.get(
                                   k, BF16_TOL)
                        if not e <= tol:
                            fail(f"34j: P={P} {mname} {label}: {k} {e:.3e} > "
                                 f"{tol}")
                        worst16[k] = max(worst16.get(k, 0.0), e)
        print(f"   worst rel-l2 (tol {BF16_TOL}, against bf16 #11 "
              f"{BF16_G_TOL}): " + ", ".join(
                  f"{k} {v:.3e}" for k, v in worst16.items())
              + f"; the gathers bitwise index_select, gather2 bitwise its "
              f"first design, two applies bitwise; "
              f"#10 bitwise its first design; #9 differs from its first "
              f"design in {differ16} of {values16} values (tol "
              f"{FIRST_DESIGN_TOL}); launches {dict(cen.launches)}, "
              f"{dict(cen.bf16_launches)}, {dict(cen.comparison_launches)}")
        if not all(cen.bf16_launches.values()) or \
                any(cen.launches.values()) or \
                not cen.comparison_launches["engine_contract_cells_bf16"] or \
                not cen.comparison_launches["engine_scatter_dofs_bf16"] or \
                not cen.comparison_launches["engine_gather2_flat_bf16"]:
            fail(f"34j: the bf16 engine counters {dict(cen.bf16_launches)}, "
                 f"the float32 ones {dict(cen.launches)}, the first "
                 f"designs' {dict(cen.comparison_launches)}")

    with phase("23 slab2 and slab2w kernels vs plain, P=2..10: the walk "
               "and the class-launch design"):
        worst = {"f64": 0.0, "f32": 0.0, "classes": 0.0, "single": 0.0}
        cuda_slab2.reset_launches()
        for P in range(2, 11):
            for nc in ((4, 3, 2), (5, 2, 3), (2, 3, 3)):
                mesh = build_box_mesh(nc, P, perturb=0.12, seed=5)
                _, Gh = pre.cell_geometry_factors(mesh)
                D = mesh.element.deriv_1d
                x = torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                                    device=dev)
                errs = {}
                for coeff in (None, rng.uniform(0.5, 2.0, nc)):
                    for far in (False, True):
                        build, plain, old = (
                            (slab2.build_slab2w, slab2.slab2w_plain,
                             cuda_slab2.slab2w_classes) if far else
                            (slab2.build_slab2, slab2.slab2_plain,
                             cuda_slab2.slab2_classes))
                        name, kernel = (("slab2w", cuda_slab2.slab2w) if far
                                        else ("slab2", cuda_slab2.slab2))
                        o64 = build(nc, P, D, Gh, torch.float64, coeff=coeff,
                                    device=dev)
                        o32 = build(nc, P, D, Gh, torch.float32, coeff=coeff,
                                    device=dev)
                        ref = plain(o64, x)
                        y_old = old(o64, x)
                        tag = "+coeff" if coeff is not None else ""
                        errs[f"{'slab2w' if far else 'slab2'}_classes{tag}"] \
                            = {"f64": rel_l2(y_old, ref),
                               "f32": rel_l2(old(o32, x.float()), ref)}
                        y = kernel(o64, x)
                        errs[name + tag] = {
                            "f32": rel_l2(kernel(o32, x.float()), ref),
                            "f64": rel_l2(y, ref),
                            # the class-launch design on the same buffers
                            "classes": rel_l2(y, y_old),
                            # #1 on the same buffers
                            "single": rel_l2(y, cs.stiffness(o64.cell_op,
                                                             x))}
                        if not torch.equal(kernel(o64, x), y):
                            fail(f"P={P} {nc} {name}{tag}: two applies "
                                 "not bitwise equal")
                for label, e in errs.items():
                    for key, v in e.items():
                        worst[key] = max(worst[key], v)
                        tol = {"f32": F32_TOL, "classes": PARITY_TOL}.get(
                            key, F64_TOL)
                        if not v <= tol:
                            fail(f"P={P} {nc} {label}: {key} {v:.3e} > {tol}")
                torch.cuda.synchronize()
                print(f"   P={P:2d} {nc}: " + "; ".join(
                    f"{k} " + " ".join(f"{v:.2e}" for v in e.values())
                    for k, e in errs.items()), flush=True)
        print(f"   worst rel-l2: f64 {worst['f64']:.3e} (tol {F64_TOL}), f32 "
              f"{worst['f32']:.3e} (tol {F32_TOL}); the walk against the "
              f"first design {worst['classes']:.3e} (tol {PARITY_TOL}), "
              f"against "
              f"#1 {worst['single']:.3e}; repeats bitwise; launches "
              f"{dict(cuda_slab2.launches)}")
        if not all(cuda_slab2.launches.values()):
            fail("a slab2 kernel's launch counter did not move")

    with phase("4 operator throughput, P=4 32^3 f32 (bench_operators)"):
        mesh = build_box_mesh((32, 32, 32), 4)
        x, benches = B.operator_benches(mesh, torch.float32, dev)
        res = {r.name: r for r in B.time_benches(mesh, x, benches,
                                                 torch.float32)}
        op = benches[1][2]
        plain_op = cs.to_mm(op.cell_op)[0]
        t_k = res["stiffness"].mean_s * 1e3
        t_m = res["mass"].mean_s * 1e3
        t_p = time_ms(lambda: mm.stiffness_apply_mm(plain_op, x), 20)
        err = rel_l2(op(x), mm.stiffness_apply_mm(plain_op, x))
        for r in res.values():
            mb = B.min_bytes(r.name, mesh, torch.float32)
            print(f"   {r.row()}  min {mb / 1e6:.1f} MB "
                  f"({B.warmth(mb, dev)})")
        print(f"   {smi}: {mesh.ndofs} DOF: stiffness kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, mass multiply {t_m:.4f} ms; "
              f"mass+stiffness {mesh.ndofs / ((t_k + t_m) * 1e-3) / 1e9:.4f}"
              f" GDOF/s (kernel vs plain rel-l2 {err:.2e})")
        if not err <= F32_TOL:
            fail(f"32^3 kernel vs plain {err:.3e} > {F32_TOL}")
        del op, plain_op, x, benches, res

    # ---- the experiment demos, the path of kernels #4, #5 and #12-#14:
    # ---- counters reset just before each, read just after ----
    demo_kernels, demo_launches = {}, {}

    def demo_entry(name, yk, yp, ms, plain, cost, library=None):
        """A kernel row from a demo run: its output against its plain
        version's, its time there, the plain version's and the library
        call's timed here."""
        err = rel_l2(yk, yp)
        if not err <= F32_TOL:
            fail(f"{name}: kernel vs plain {err:.3e} > {F32_TOL}")
        demo_kernels[name] = dict(
            max_abs_err=float((yk.double() - yp.double()).abs().max()),
            rel_l2=err, ms=ms, plain_ms=time_ms(plain, 3), cost=cost,
            library_ms=None if library is None else time_ms(library, 20))
        print(f"   {smi}: {name}: {demo_kernels[name]}", flush=True)

    with phase("24 exp_slab2w at P=4, 32^3, f32: #1, slab2 and slab2w "
               "on the walk and on the class-launch design, in turns"):
        cuda_slab2.reset_launches()
        out = exp_slab2w.main(["f32", "4", "--nc", "32", "--design", "both"])
        torch.cuda.synchronize()
        demo_launches.update(cuda_slab2.launches)
        print(f"   launches in the demo: {dict(cuda_slab2.launches)}")
        if not all(cuda_slab2.launches.values()):
            fail("a slab2 kernel was not launched by the demo")
        x = out["x"]
        for name in cuda_slab2.launches:
            far = name.startswith("slab2w")
            op = out["ops"]["far" if far else "adjacent"]
            plain = slab2.slab2w_plain if far else slab2.slab2_plain
            if not out["rel"][name] <= F32_TOL:
                fail(f"{name} vs the production kernel {out['rel'][name]:.3e}")
            demo_entry(name, out["ys"][name], plain(op, x),
                       min(t[0] for t in out["times"][name]) * 1e3,
                       lambda op=op, plain=plain: plain(op, x),
                       apply_cost(op.G, out["mesh"].ndofs, 1))
        # its turns at 32^3 are phase 31's
        turns = {(32, 32, 32): {"slab2": {k: out[k] for k in (
            "times", "rel", "nbytes")}}}
        del out, x, op

    with phase("25 exp_kernel_anatomy at P=4, 32^3, f32: the walk's "
               "variants and the parity-class ones, in turns"):
        anatomy.reset_launches()
        out = exp_kernel_anatomy.main(["--design", "both"])
        torch.cuda.synchronize()
        demo_launches.update(anatomy.launches)
        print(f"   launches in the demo: {dict(anatomy.launches)}")
        if not all(anatomy.launches.values()):
            fail("an anatomy kernel was not launched by the demo")
        op, x, outs = out["op"], out["x"], out["outs"]
        walk = outs["pencil"]
        y1 = cs.stiffness(op, x)
        for name in ("full", "ywin"):
            if not torch.equal(walk[name], y1):
                fail(f"the walk's {name} is not bitwise #1")
        err = rel_l2(outs["classes"]["ywin"], outs["classes"]["full"])
        print(f"   the walk's full and ywin bitwise #1; the parity-class "
              f"ywin vs full: rel-l2 {err:.3e}")
        if not err <= F32_TOL:
            fail(f"the parity-class ywin vs full {err:.3e}")
        for design in anatomy.DESIGNS:
            for name in exp_kernel_anatomy.NAMES:
                e = rel_l2(outs[design][name], out["plains"][name])
                print(f"   {design} {name} vs its plain version: rel-l2 "
                      f"{e:.3e}")
                if not e <= F32_TOL:
                    fail(f"anatomy {design} {name} vs plain {e:.3e}")
                if name in ("full", "full_pair"):
                    continue
                demo_entry(anatomy.counter(name, design), outs[design][name],
                           out["plains"][name],
                           min(t[0] for t in out["times"][design][name]) * 1e3,
                           lambda name=name: anatomy.variant_plain(op, x,
                                                                   name),
                           out["costs"][name])
        turns[(32, 32, 32)]["anatomy"] = {k: out[k] for k in (
            "times", "costs")}
        del out, op, x, outs, walk, y1

    with phase("26 exp_g_layout and exp_mosaic_relayout (f32), the "
               "relayouts in turns at 128 and 16384 tiles"):
        probes.reset_launches()
        g = exp_g_layout.main([])
        r = exp_mosaic_relayout.main(["--turns"])
        big = exp_mosaic_relayout.main(["--tiles", "16384", "--turns",
                                        "--enqueues", "0"])
        torch.cuda.synchronize()
        demo_launches.update(probes.launches)
        demo_launches.update(probes.comparison_launches)
        print(f"   launches in the demos: {dict(probes.launches)}, "
              f"{dict(probes.comparison_launches)}")
        if not all(probes.launches.values()) or \
                not all(probes.comparison_launches.values()):
            fail("a probe kernel was not launched by its demo")
        w = torch.arange(1, 7, dtype=torch.float32, device=dev)
        for layout in probes.LAYOUTS:
            Ga, c = g["G"][layout], g["c"]
            view = probes.cells_view(Ga, g["nc"], layout)
            demo_entry(
                f"g_layout_{layout}", g["outs"][layout], g["plains"][layout],
                g["times"][layout][0] * 1e3,
                lambda Ga=Ga, layout=layout: probes.g_weighted_sum_plain(
                    Ga, c, g["nc"], layout),
                (Ga.numel() * 4 + 2 * c.numel() * 4, 2 * Ga.numel()),
                library=lambda view=view: torch.einsum("abcmijk,m->bjck",
                                                       view, w))
        for out in (r, big):
            for kind in probes.KINDS:
                if not torch.equal(out["outs"][kind], out["plains"][kind]):
                    fail(f"relayout {kind} at {out['x'].shape[0]} values: "
                         "not bitwise the plain version's")
        # the rows: the new kernels and the first designs at 128 tiles,
        # each with its reading in turns and the PyTorch call's
        x = r["x"]
        for kind, old in (("copy", "relayout_copy_flat"),
                          ("transpose", "relayout_transpose_padded")):
            ms = r["turns"][kind]["ms"]
            for name, variant in ((f"relayout_{kind}", "new"),
                                  (old, "old")):
                y = exp_mosaic_relayout.VARIANTS[variant](kind, x)
                demo_entry(name, y, r["plains"][kind], min(ms[variant]),
                           lambda kind=kind: probes.relayout_plain(x, kind),
                           (2 * x.numel() * 4, 0))
                demo_kernels[name]["library_ms"] = min(ms["library"])
        for out in (r, big):
            nbytes = 2 * out["x"].numel() * 4
            b_ms = bound(nbytes, 0)[0]
            for kind, t in out["turns"].items():
                best = {k: min(v) for k, v in t["ms"].items()}
                print(f"   {smi}: relayout {kind} at "
                      f"{out['x'].shape[0] // probes.TM} tiles "
                      f"({nbytes:,} B), best of the rounds in turns: old "
                      f"{best['old']:.4f}, new {best['new']:.4f}, library "
                      f"{best['library']:.4f} ms; new / library "
                      f"{best['new'] / best['library']:.4f}, old / new "
                      f"{best['old'] / best['new']:.4f}; of the bound "
                      f"{b_ms:.4f} ms: new {b_ms / best['new']:.1%}, old "
                      f"{b_ms / best['old']:.1%}, library "
                      f"{b_ms / best['library']:.1%}", flush=True)
        print(f"   device bytes of (2^20, 1) f32 {r['bytes']['column']:,}, "
              f"of (2^13, 128) f32 {r['bytes']['packed']:,}")
        del g, r, big, x, y
        torch.cuda.empty_cache()

    # ---- phase 31: #4 / #5 and #13, the walk against the first designs in
    # ---- turns, at 32^3 phases 24 and 25's turns, at 64 x 40 x 40 its own
    # ---- (counters reset just before, read just after) ----
    with phase("31 the two-slab and anatomy kernels on the walk against "
               "the first designs in turns, P=4 f32, 32^3 (phases 24 and "
               "25) and 64x40x40"):
        cuda_slab2.reset_launches()
        anatomy.reset_launches()
        for nc in ((32, 32, 32), (64, 40, 40)):
            cells = [str(c) for c in nc]
            if nc in turns:
                s, a = turns[nc]["slab2"], turns[nc]["anatomy"]
            else:
                s = exp_slab2w.main(["f32", "4", "--nc", *cells, "--design",
                                     "both"])
                a = exp_kernel_anatomy.main(["--nc", *cells, "--design",
                                             "both"])
                for name in exp_kernel_anatomy.NAMES:
                    for design in anatomy.DESIGNS:
                        e = rel_l2(a["outs"][design][name],
                                   a["plains"][name])
                        if not e <= F32_TOL:
                            fail(f"{nc} anatomy {design} {name} vs plain "
                                 f"{e:.3e}")
                if not torch.equal(a["outs"]["pencil"]["ywin"],
                                   a["outs"]["pencil"]["full"]):
                    fail(f"{nc} the walk's ywin is not bitwise its full")
            b_ms = bound(s["nbytes"], 0)[0]
            ms = {k: [t[0] * 1e3 for t in v] for k, v in s["times"].items()}
            for name, r in s["rel"].items():
                if not r <= F32_TOL:
                    fail(f"{nc} {name} vs #1 {r:.3e}")
            p1 = min(ms["production"])
            for new, old in (("slab2", "slab2_classes"),
                             ("slab2w", "slab2w_classes")):
                print(f"   {smi}: {nc} {new}: the class-launch design "
                      f"{ms[old][0]:.4f} / {ms[old][1]:.4f} ms, the walk "
                      f"{ms[new][0]:.4f} / {ms[new][1]:.4f} (old, new, new, "
                      f"old): {min(ms[old]) / min(ms[new]):.4f}x; "
                      f"{b_ms / min(ms[new]):.1%} of the bound {b_ms:.4f} ms "
                      f"(the first design's {b_ms / min(ms[old]):.1%}); #1 "
                      f"in the same turns {ms['production'][0]:.4f} / "
                      f"{ms['production'][1]:.4f}, the walk / #1 "
                      f"{min(ms[new]) / p1:.4f}", flush=True)
            for name in exp_kernel_anatomy.NAMES:
                b_v = bound(*a["costs"][name])[0]
                t = {d: [v[0] * 1e3 for v in a["times"][d][name]]
                     for d in anatomy.DESIGNS}
                print(f"   {smi}: {nc} anatomy {name}: the parity-class "
                      f"design {t['classes'][0]:.4f} / {t['classes'][1]:.4f} "
                      f"ms, the "
                      f"walk {t['pencil'][0]:.4f} / {t['pencil'][1]:.4f} "
                      f"(old, new, new, old): "
                      f"{min(t['classes']) / min(t['pencil']):.4f}x; "
                      f"{b_v / min(t['pencil']):.1%} of its bound {b_v:.4f} "
                      f"ms (the parity-class design's "
                      f"{b_v / min(t['classes']):.1%})",
                      flush=True)
            for design in anatomy.DESIGNS:
                best = {k: min(v[0] for v in a["times"][design][k]) * 1e3
                        for k in ("full", "gstream", "contract")}
                rest = best["full"] - best["gstream"] - best["contract"]
                print(f"   {smi}: {nc} {design}: full {best['full']:.4f} - "
                      f"gstream {best['gstream']:.4f} - contract "
                      f"{best['contract']:.4f} = {rest:+.4f} ms", flush=True)
            del s, a
        del turns
        torch.cuda.synchronize()
        print(f"   launches: {dict(cuda_slab2.launches)}, "
              f"{dict(anatomy.launches)}")
        if not all(cuda_slab2.launches.values()) or \
                not all(anatomy.launches.values()):
            fail("a kernel of phase 31 was not launched")
        torch.cuda.empty_cache()

    # ---- phase 32 (a-e, i): the measurement modules and experiment demos
    # ---- on the card; counters reset just before each run, read just
    # ---- after ----
    with phase("32a the card's rates: the triad, a 2 GiB copy, the matmul "
               "in bf16 and in f32 (TF32 off)"):
        triad = B.measure_streaming_roofline() / 1e3
        copy_ms, copy_tbs = profile_step.streaming_copy(profile_step.COPY_GIB)
        bf16 = B.measure_matmul_roofline(dtype=torch.bfloat16)
        f32 = B.measure_matmul_roofline(dtype=torch.float32, iters=100)
        print(f"   {smi}: triad c = c*d + e over 256 MiB arrays "
              f"{triad:.4f} TB/s; copy of {profile_step.COPY_GIB} GiB "
              f"{copy_ms:.4f} ms, "
              f"{copy_tbs:.4f} TB/s read and written (published "
              f"{PEAK_BYTES_PER_S / 1e12} TB/s); matmul 4096^3 bf16 "
              f"{bf16:.1f} TFLOP/s (published {PEAK_BF16_PER_S / 1e12:.0f}),"
              f" f32 TF32 off {f32:.2f} TFLOP/s (published "
              f"{PEAK_F32_PER_S / 1e12:.0f})", flush=True)
        for name, got, peak in (("triad", triad * 1e12, PEAK_BYTES_PER_S),
                                ("copy", copy_tbs * 1e12, PEAK_BYTES_PER_S),
                                ("bf16", bf16 * 1e12, PEAK_BF16_PER_S),
                                ("f32", f32 * 1e12, PEAK_F32_PER_S)):
            if not 0.0 < got <= 1.05 * peak:
                fail(f"32a: the {name} rate {got:.4e} is outside (0, 105% of "
                     f"the published {peak:.4e}]")
    cs.reset_launches()
    with phase("32b time_operators --degrees 2 3 4 5 6 at 32^3, f32"):
        ops32 = time_operators.main(["--nc", "32", "--degrees", "2", "3",
                                     "4", "5", "6"])
        torch.cuda.synchronize()
        n32 = cs.launches["stiffness"]
        print(f"   {smi}: #1 launches {n32}")
        for P, (_, rel, _) in ops32.items():
            if not rel <= F32_TOL:
                fail(f"32b: P={P} #1 vs plain {rel:.3e} > {F32_TOL}")
        if n32 == 0:
            fail("32b: #1 was not launched")
        del ops32
    cs.reset_launches()
    with phase("32c exp_degree_sweep at P=2..10 (f32)"):
        sweep = exp_degree_sweep.main(["2", "10"])
        torch.cuda.synchronize()
        n32 = cs.launches["stiffness"]
        print(f"   {smi}: #1 launches {n32}")
        for row in sweep:
            if not row["rel"] <= F32_TOL:
                fail(f"32c: P={row['P']} #1 vs plain {row['rel']:.3e}")
        if n32 == 0:
            fail("32c: #1 was not launched")
        del sweep
    with phase("32d bench_rk4_step: the 32^3 Westervelt and linear boxes, "
               "f32"):
        for label, nonlinear in (("Westervelt", True), ("linear", False)):
            cs.reset_launches()
            sb = B.bench_rk4_step(nonlinear=nonlinear)
            torch.cuda.synchronize()
            n32 = cs.launches["stiffness"]
            umax = float(sb.state.u.abs().max())
            print(f"   {smi}: {label} box {sb.ndofs} DOF: "
                  f"{sb.mean_s * 1e3:.4f} ms/step (+-{sb.std_s * 1e3:.4f}), "
                  f"20 steps between CUDA events; #1 launches {n32} for "
                  f"{sb.steps} steps; max |u| {umax:.4e}", flush=True)
            if n32 != 4 * sb.steps:
                fail(f"32d {label}: #1 launches {n32} != 4 x {sb.steps}")
            if not bool(torch.isfinite(sb.state.u).all()) or umax == 0.0:
                fail(f"32d {label}: the state is not finite and non-zero")
            del sb
        halo, halo_dt = time_halo.build(16, 4, torch.float32, dev)
        for case in time_halo.cases(halo, halo_dt, 20, 4):
            keep_for_ranks("22g halo box, grid (4, 1, 1), exchange "
                           + ("on" if case.get("exchange", True) else "off"),
                           halo, halo_dt, 20, HALO_POINTS, grid=case["grid"],
                           like=None if case.get("exchange", True) else
                           "22g halo box, grid (4, 1, 1), exchange on",
                           **{k: v for k, v in case.items()
                              if k == "exchange"})
        del halo
    cs.reset_launches()
    with phase("32e exp_kernel_speed f32 4 2: auto (#1), mm, windows, "
               "indexed"):
        speed = exp_kernel_speed.main(["f32", "4", "2"])
        torch.cuda.synchronize()
        n32 = cs.launches["stiffness"]
        print(f"   {smi}: #1 launches {n32}")
        for pair, rel in speed["rel"].items():
            if not rel <= F32_TOL:
                fail(f"32e: {pair} rel-l2 {rel:.3e} > {F32_TOL}")
        if n32 == 0:
            fail("32e: #1 was not launched")
        del speed
    with phase("32i exp_isoparametric_bowl --elements 24 --periods 3: "
               "trilinear and hex27 on #6"):
        iso_args = exp_isoparametric_bowl.parser().parse_args(
            ["--elements", "24", "--periods", "3"])
        iso = exp_isoparametric_bowl.build(iso_args)
        peaks = {}
        for name, case in iso.items():
            ce.reset_launches()
            state, ys = exp_isoparametric_bowl.run(case)
            torch.cuda.synchronize()
            n6 = ce.launches["extruded"]
            peaks[name] = float(np.abs(ys).max())
            print(f"   {smi}: {name}: {case.model.mesh.ndofs} DOF, "
                  f"{case.steps} steps, #6 launches {n6}; focal min p "
                  f"{ys.min() / 1e6:.4f} MPa, max |p| "
                  f"{peaks[name] / 1e6:.4f} MPa (recorded "
                  f"{ISO_PEAK_PA[name] / 1e6} MPa)", flush=True)
            if n6 != 4 * case.steps or ce.launches["extruded_pair"]:
                fail(f"32i {name}: #6 launches {dict(ce.launches)} != 4 x "
                     f"{case.steps}")
            if not np.isfinite(ys).all() or not bool(
                    torch.isfinite(state.u).all()):
                fail(f"32i {name}: the field or the probe trace is not "
                     "finite")
            if not abs(peaks[name] / ISO_PEAK_PA[name] - 1) <= ISO_BAND:
                fail(f"32i {name}: focal |p| {peaks[name]:.1f} Pa more than "
                     f"{ISO_BAND:.0%} from {ISO_PEAK_PA[name]:.1f}")
        delta = (peaks["hex27"] - peaks["trilinear"]) / peaks["hex27"]
        print(f"   focal |p| delta (hex27 vs trilinear): {delta:+.3%} of the "
              f"quadratic value (recorded +0.72%)")
        if not delta > 0:
            fail(f"32i: the hex27 focal |p| is not above the trilinear "
                 f"({delta:+.3%})")
        del iso, case, state
        torch.cuda.empty_cache()

    # phase 32c's dense oracle at P = 2..10 (~5 minutes of one core's numpy,
    # most at P = 9 and 10): one spawned process computes it from here on,
    # after phase 32's timed runs, and the check comes last (a daemon
    # worker, ended at exit if the script fails first)
    oracle_pool = mp.get_context("spawn").Pool(1)
    oracle_jobs = {P: oracle_pool.apply_async(
        exp_degree_sweep.oracle_reference, (P,)) for P in range(2, 11)}
    oracle_pool.close()

    with phase("5 linear box demo (default size)"):
        model, state = linear_box.main(["--device", "cuda"])
        u = state.u
        if not bool(torch.isfinite(u).all()) or float(u.abs().max()) == 0.0:
            fail("linear box field is not finite and non-zero")
        print(f"   max |u| = {float(u.abs().max()):.6e} Pa")
        del model, state, u

    kernels = {}
    with phase("6a flagship build + kernel vs plain"):
        args = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "4"])
        t0 = time.perf_counter()
        pb6 = nonlinear_bowl.problem(args)
        bowl, dt, nsteps, focus = nonlinear_bowl.build(args, pb6)
        print(f"   host setup + upload {time.perf_counter() - t0:.1f} s")
        # the plain version: the same operator data in the matmul layout, as
        # a model built with stiffness_impl="mm" holds it
        kstiff = bowl.stiffness
        pstiff = StructuredStiffness(kstiff.cell_op, "mm")
        x = torch.as_tensor(rng.standard_normal(bowl.mesh.grid_shape),
                            dtype=torch.float32, device=dev)
        yk, yp = kstiff(x), pstiff(x)
        err = rel_l2(yk, yp)
        if not err <= F32_TOL:
            fail(f"flagship stiffness kernel vs plain {err:.3e} > {F32_TOL}")
        kernels["stiffness"] = dict(
            max_abs_err=float((yk - yp).abs().max()), rel_l2=err,
            ms=time_ms(lambda: kstiff(x), 20),
            plain_ms=time_ms(lambda: pstiff(x), 10),
            cost=apply_cost(kstiff.G, bowl.mesh.ndofs, 1))
        print(f"   {smi}: stiffness at {tuple(bowl.mesh.nc)} cells: "
              f"{kernels['stiffness']}")
        del yk, yp
        # 10 RK4 steps from the same state: kernel, then plain
        s0 = bowl.init_state()
        sk, _ = bowl.solve(s0, dt, 10)
        bowl.stiffness = pstiff
        sp, _ = bowl.solve(s0, dt, 10)
        bowl.stiffness = kstiff
        del pstiff
        traj = rel_l2(sk.u, sp.u)
        print(f"   10 steps kernel vs plain: rel-l2(u) {traj:.3e} "
              f"(tol {TRAJ_TOL}), max |u| {float(sk.u.abs().max()):.4e}")
        if not traj <= TRAJ_TOL:
            fail(f"10-step trajectory kernel vs plain {traj:.3e}")
        del sk, sp
        # the focus, and a point on the axis 0.8 mm in front of the cap's
        # apex, which the wave reaches within the ranks' 20 steps
        BOWL_POINTS = np.array([focus, [0.0008, focus[1], focus[2]]])
        keep_for_ranks("22a flagship, grid (2, 2, 1)", bowl, dt, 50,
                       BOWL_POINTS, grid=(2, 2, 1),
                       dist_output=str(IO / "ranks"))
        keep_for_ranks("22f flagship on nccl, world size 1", bowl, dt, 20,
                       BOWL_POINTS, grid=(1, 1, 1),
                       like="22a flagship, grid (2, 2, 1)")

    with phase("33a flagship set-up before (host numpy) and after (the "
               "set-up kernels); each set-up kernel vs plain"):
        a33, b33, l33 = setup_turn("flagship",
                                   lambda sd: bowl_model(pb6, args, sd))
        kernels.update(setup_check("flagship", a33, b33, pb6.absorbing, l33))
        del a33, b33

    with phase("7a two-layer build + pair kernel vs plain"):
        args2 = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "4", "--two-layer"])
        bowl2, dt2, _, _ = nonlinear_bowl.build(args2, pb6)
        if not bowl2.stiffness.is_pair:
            fail("two-layer model did not build the pair operator")
        kst2 = bowl2.stiffness
        pst2 = StructuredStiffness(kst2.cell_op, "mm")
        x2 = torch.as_tensor(rng.standard_normal(bowl2.mesh.grid_shape),
                             dtype=torch.float32, device=dev)
        yk, yp = kst2.pair(x, x2), pst2.pair(x, x2)
        err = rel_l2(yk, yp)
        if not err <= F32_TOL:
            fail(f"pair kernel vs plain {err:.3e} > {F32_TOL}")
        kernels["stiffness_pair"] = dict(
            max_abs_err=float((yk - yp).abs().max()), rel_l2=err,
            ms=time_ms(lambda: kst2.pair(x, x2), 20),
            plain_ms=time_ms(lambda: pst2.pair(x, x2), 10),
            cost=apply_cost(kst2.G, bowl2.mesh.ndofs, 2))
        print(f"   {smi}: pair at {tuple(bowl2.mesh.nc)} cells: "
              f"{kernels['stiffness_pair']}")
        del yk, yp
        # 10 RK4 steps from the same state: kernel, then plain
        s0 = bowl2.init_state()
        sk, _ = bowl2.solve(s0, dt2, 10)
        bowl2.stiffness = pst2
        sp, _ = bowl2.solve(s0, dt2, 10)
        bowl2.stiffness = kst2
        traj = rel_l2(sk.u, sp.u)
        print(f"   10 steps pair kernel vs plain: rel-l2(u) {traj:.3e} "
              f"(tol {TRAJ_TOL}), max |u| {float(sk.u.abs().max()):.4e}")
        if not traj <= TRAJ_TOL:
            fail(f"10-step two-layer trajectory kernel vs plain {traj:.3e}")
        del sk, sp, pst2, x, x2
        keep_for_ranks("22b two-layer flagship, grid (2, 2, 1)", bowl2, dt2,
                       20, BOWL_POINTS, grid=(2, 2, 1))

    # ---- the main path: counters reset just before, read just after ----
    cs.reset_launches()
    cv.reset_launches()
    with phase("6b flagship full solve (kernel)"):
        state = run_demo(bowl, dt, nsteps, args, "nonlinear_bowl")
        n_single = cs.launches["stiffness"]
        n_axpy = cv.launches["axpy"]
        print(f"   RK4 update kernel launches {n_axpy} for {nsteps} steps")
        if not n_axpy or n_axpy % nsteps:
            fail(f"axpy launches {n_axpy}: not a positive multiple of "
                 f"{nsteps} steps")
        p_focus = nonlinear_bowl.focal_pressure(bowl, state, focus)
        print(f"pressure at focus: {p_focus:.1f} Pa")
        print(f"   the set-up on the card: focal {p_focus:.1f} Pa against "
              f"-6874748.0 Pa with the host set-up's G (band "
              f"{FOCAL_BAND_PA})")
        print(f"   stiffness launches {n_single} for {nsteps} steps")
        if n_single != 4 * nsteps:
            fail(f"stiffness launches {n_single} != 4 x {nsteps} steps")
        if not bool(torch.isfinite(state.u).all()):
            fail("flagship field is not finite")
        if not FOCAL_BAND_PA[0] <= p_focus <= FOCAL_BAND_PA[1]:
            fail(f"focal pressure {p_focus:.1f} Pa outside {FOCAL_BAND_PA}")
        u6b = state.u                   # the bf16 run's comparison (34b)
        del state
    with phase("7b two-layer flagship, 50 steps (pair kernel)"):
        s2, _ = bowl2.solve(bowl2.init_state(), dt2, 50)
        torch.cuda.synchronize()
        n_pair = cs.launches["stiffness_pair"]
        print(f"   pair launches {n_pair}, max |u| "
              f"{float(s2.u.abs().max()):.4e}")
        if n_pair != 4 * 50 or cs.launches["stiffness"] != n_single:
            fail(f"launches {dict(cs.launches)} after the two-layer run")
        if not bool(torch.isfinite(s2.u).all()) or \
                float(s2.u.abs().max()) == 0.0:
            fail("two-layer field is not finite and non-zero")
    launches = dict(cs.launches)
    launches["axpy"] = n_axpy
    del bowl2, s2, kst2

    with phase("35a flagship: the RK4 solve as captured CUDA graphs "
               "against the same steps launched eagerly and the eager loop "
               "of Python-float coefficients; the RK4 update kernel"):
        captured_solve(bowl, dt, "flagship", TRAJ_TOL)
        kernels["axpy"] = axpy_entry(torch.float32, bowl.mesh.ndofs)

    with phase("34b flagship in bf16: build, #1 vs plain, 10 steps kernel "
               "vs plain, the whole solve, ms a step beside float32's"):
        argv34 = ["--elements", "64", "--degree", "4"]
        hbowl, dt34, nsteps34, _, pst34, kernels["stiffness_bf16"] = \
            bf16_model("flagship", argv34, pb6)
        kst34 = hbowl.stiffness
        s0 = hbowl.init_state()
        sk, _ = hbowl.solve(s0, dt34, 10)
        hbowl.stiffness = pst34
        sp, _ = hbowl.solve(s0, dt34, 10)
        hbowl.stiffness = kst34
        traj = rel_l2(sk.u, sp.u)
        print(f"   10 bf16 steps kernel vs plain: rel-l2(u) {traj:.3e} "
              f"(tol {BF16_TRAJ_TOL}), max |u| {float(sk.u.abs().max()):.4e}")
        if not traj <= BF16_TRAJ_TOL:
            fail(f"34b: 10 bf16 steps kernel vs plain {traj:.3e}")
        del sk, sp, pst34
        bf16_reset()
        cv.reset_launches()
        state = run_demo(hbowl, dt34, nsteps34, nonlinear_bowl.parser(
            ).parse_args(argv34 + ["--dtype", "bf16"]), "nonlinear_bowl")
        counts = bf16_counters()
        launches["axpy_bf16"] = cv.bf16_launches["axpy_bf16"]
        if not launches["axpy_bf16"] or launches["axpy_bf16"] % nsteps34:
            fail(f"34b: axpy_bf16 launches {launches['axpy_bf16']}: not a "
                 f"positive multiple of {nsteps34} steps")
        kernels["axpy_bf16"] = axpy_entry(BF16, hbowl.mesh.ndofs)
        bf16_counts["stiffness_bf16"] = counts["stiffness_bf16"]
        p16 = nonlinear_bowl.focal_pressure(hbowl, state, focus)
        print(f"   bf16 pressure at focus: {p16:.1f} Pa, float32 (6b) "
              f"{p_focus:.1f} Pa: bf16 / float32 {p16 / p_focus:.4f} (no "
              f"gate: bf16 drifts from float32); launches {counts} for "
              f"{nsteps34} steps")
        if counts["stiffness_bf16"] != 4 * nsteps34 or \
                sum(counts.values()) != 4 * nsteps34:
            fail(f"34b: bf16 launches {counts} != 4 x {nsteps34}")
        if not (bool(torch.isfinite(state.u).all()) and np.isfinite(p16)):
            fail("34b: the bf16 flagship field is not finite")
        print(f"   the bf16 field at t_final against 6b's float32 field: "
              f"rel-l2(u) {rel_l2(state.u, u6b):.3e}, max |u| "
              f"{float(state.u.abs().max()):.4e} (float32 "
              f"{float(u6b.abs().max()):.4e})")
        # the first PLAIN_DEPTH steps of the same solve on the plain version
        # (bf16 in, float32 arithmetic, y rounded once an apply), beside
        # the kernel's and float32's: whether the kernel's roundings or the
        # bf16 state part the field from float32's
        sk, _ = hbowl.solve(hbowl.init_state(), dt34, PLAIN_DEPTH)
        s32, _ = bowl.solve(bowl.init_state(), dt, PLAIN_DEPTH)
        hbowl.stiffness = StructuredStiffness(kst34.cell_op, "mm")
        bf16_reset()
        t0 = time.perf_counter()
        sp, _ = hbowl.solve(hbowl.init_state(), dt34, PLAIN_DEPTH)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        hbowl.stiffness = kst34
        print(f"   the first {PLAIN_DEPTH} of {nsteps34} bf16 steps on the "
              f"plain version ({t_plain:.1f} s, bf16 launches "
              f"{sum(bf16_counters().values())}): rel-l2(u) plain vs "
              f"kernel {rel_l2(sp.u, sk.u):.3e}, plain vs float32 "
              f"{rel_l2(sp.u, s32.u):.3e}, kernel vs float32 "
              f"{rel_l2(sk.u, s32.u):.3e}, max |u| "
              f"{float(sp.u.abs().max()):.4e} (kernel "
              f"{float(sk.u.abs().max()):.4e}, float32 "
              f"{float(s32.u.abs().max()):.4e})", flush=True)
        if not bool(torch.isfinite(sp.u).all()):
            fail("34b: the plain bf16 flagship field is not finite")
        if any(bf16_counters().values()):
            fail(f"34b: the plain solve launched a kernel: "
                 f"{bf16_counters()}")
        del state, u6b, sp, sk, s32
        turns = ms_turns([("f32", bowl, dt), ("bf16", hbowl, dt34)])
        print(f"   {smi}: ms a step (50 steps from rest, in turns f32, "
              f"bf16, bf16, f32): float32 {turns['f32']:.4f}, bf16 "
              f"{turns['bf16']:.4f}; stiffness ms an apply: float32 (6a) "
              f"{kernels['stiffness']['ms']:.4f}, bf16 "
              f"{kernels['stiffness_bf16']['ms']:.4f}", flush=True)
        del hbowl, kst34

    with phase("34c two-layer flagship in bf16: #2 vs plain, 50 steps"):
        bbowl16, dt34c, _, _, _, kernels["stiffness_pair_bf16"] = \
            bf16_model("two-layer flagship",
                       ["--elements", "64", "--degree", "4", "--two-layer"],
                       pb6)
        _, bf16_counts["stiffness_pair_bf16"] = bf16_steps(
            bbowl16, dt34c, 50, "two-layer flagship")
        del bbowl16

    # ---- the parity-class design of #1 / #2 against the pencil kernels:
    # ---- the demo's run, counters reset just before, read just after ----
    with phase("27a exp_pencil: the parity-class and the pencil kernels "
               "in turns, P=4 f32, the flagship's 64x40x40 cells and "
               "32^3"):
        anatomy.reset_launches()
        cs.reset_launches()
        cmp = {nc: exp_pencil.main(["--nc", *map(str, nc)])
               for nc in ((64, 40, 40), (32, 32, 32))}
        torch.cuda.synchronize()
        print(f"   launches in the demo: {dict(anatomy.launches)}, "
              f"{dict(cs.launches)}")
        for name in ("anatomy_full", "anatomy_full_pair"):
            demo_launches[name] = anatomy.launches[name]
            if not anatomy.launches[name]:
                fail(f"{name} was not launched by the demo")
        for nc, out in cmp.items():
            for form, fields in (("single", 1), ("pair", 2)):
                f = out[form]
                for name in ("parity", "pencil"):
                    e = rel_l2(f["ys"][name], f["plain"])
                    if not e <= F32_TOL:
                        fail(f"{nc} {form} {name} vs plain {e:.3e}")
                ms = {name: [tt[0] * 1e3 for tt in f["times"][name]]
                      for name in ("parity", "pencil")}
                b_ms = bound(*apply_cost(f["op"].G, out["mesh"].ndofs,
                                         fields))[0]
                best = {name: min(v) for name, v in ms.items()}
                print(f"   {smi}: {nc} {form}: the parity-class kernel "
                      f"{ms['parity'][0]:.4f} / {ms['parity'][1]:.4f} ms, "
                      f"pencil "
                      f"{ms['pencil'][0]:.4f} / {ms['pencil'][1]:.4f} ms "
                      f"(old, new, new, old): "
                      f"{best['parity'] / best['pencil']:.4f}"
                      f"x; {f['nbytes'] / best['pencil'] / 1e9:.4f} TB/s, "
                      f"{b_ms / best['pencil']:.1%} of the bound {b_ms:.4f} "
                      f"ms (parity-class {b_ms / best['parity']:.1%})",
                      flush=True)
        flag = cmp[(64, 40, 40)]
        for name, form in (("anatomy_full", "single"),
                           ("anatomy_full_pair", "pair")):
            f = flag[form]
            pst = StructuredStiffness(f["op"], "mm")
            xs = f["xs"]
            plain = (lambda pst=pst, xs=xs: pst(xs[0])) if form == "single" \
                else (lambda pst=pst, xs=xs: pst.pair(*xs))
            yk, yp = f["ys"]["parity"], f["plain"]
            kernels[name] = dict(
                max_abs_err=float((yk - yp).abs().max()),
                rel_l2=rel_l2(yk, yp),
                ms=min(tt[0] for tt in f["times"]["parity"]) * 1e3,
                plain_ms=time_ms(plain, 3),
                cost=apply_cost(f["op"].G, flag["mesh"].ndofs, len(xs)))
            print(f"   {smi}: {name}: {kernels[name]}", flush=True)
        del cmp, flag, f, pst, xs, yk, yp

    class ParityClassStiffness(torch.nn.Module):
        """The parity-class kernels #1 / #2 on a structured operator:
        anatomy's full and full_pair."""

        def __init__(self, op):
            super().__init__()
            self.op = op

        def forward(self, x):
            return anatomy.variant_classes(self.op, x, "full")

        def pair(self, x1, x2):
            return anatomy.full_pair_classes(self.op, x1, x2)

    with phase("27b flagship full solve on the parity-class kernel"):
        anatomy.reset_launches()
        bowl.stiffness = ParityClassStiffness(kstiff.cell_op)
        state = run_demo(bowl, dt, nsteps, args, "nonlinear_bowl")
        bowl.stiffness = kstiff
        p_par = nonlinear_bowl.focal_pressure(bowl, state, focus)
        agree = abs(p_focus - p_par) / abs(p_par)
        n_par = anatomy.launches["anatomy_full"]
        print(f"   the parity-class kernel: pressure at focus {p_par:.1f} "
              f"Pa, the "
              f"pencil kernel's (6b) {p_focus:.1f} Pa: relative difference "
              f"{agree:.3e} (tol {FOCAL_AGREE}); {n_par} launches for "
              f"{nsteps} steps")
        if n_par != 4 * nsteps:
            fail(f"the parity-class kernel: launches {n_par} != 4 x "
                 f"{nsteps} steps")
        if not agree <= FOCAL_AGREE:
            fail(f"focal pressure vs the parity-class kernel {agree:.3e}")
        if not FOCAL_BAND_PA[0] <= p_par <= FOCAL_BAND_PA[1]:
            fail(f"the parity-class kernel's focal pressure {p_par:.1f} Pa "
                 f"outside "
                 f"{FOCAL_BAND_PA}")
        del state

    # ---- phase 30 on the flagship (#1): counters reset just before, read
    # ---- just after ----
    cs.reset_launches()
    with phase("30a flagship exact restart on #1: npz checkpoint and the "
               "async Checkpointer"):
        fprobe = device_probe(bowl, focus[None, :])
        s100, s200 = restart_check(bowl, dt, 100, "flagship")
        # the asynchronous saver: the copy and the write overlap the next
        # 100 steps, which must come out as without it
        ck = fio.Checkpointer(str(IO / "ck"), async_save=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bowl.solve(s100, dt, 100, probe=fprobe)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.save(s100, 100)
        t_enq = time.perf_counter() - t0
        cont, ys30 = bowl.solve(s100, dt, 100, probe=fprobe)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        ck.wait()
        t_ck = time.perf_counter() - t0
        st, step = ck.restore(100, like=s100)
        resumed, _ = bowl.solve(st, dt, 100)
        mb = megabytes(IO / "ck" / "step_0000000100.pt")
        ok = same_state(cont, s200) and same_state(resumed, s200)
        n30 = cs.launches["stiffness"]
        print(f"   Checkpointer: save() returned in {t_enq * 1e3:.2f} ms, "
              f"the 100 steps it overlaps done at {t_solve:.3f} s (the "
              f"same 100 steps without a save {t_plain:.3f} s), the "
              f"{mb:.1f} MB save on disk at {t_ck:.3f} s (host clock); "
              f"steps() {ck.steps()}; the overlapped run and the restored "
              f"run {'bitwise equal' if ok else 'NOT equal'} to the "
              f"uninterrupted one; stiffness launches {n30} for 600 steps "
              f"({smi})")
        if not ok or ck.steps() != [100] or step != 100:
            fail("phase 30a: the Checkpointer round trip is not exact")
        if n30 != 4 * 600:
            fail(f"phase 30a: stiffness launches {n30} != 4 x 600")
        del cont, resumed, st
    with phase("30b flagship field output: structured VTK (binary), a "
               "179 x 179 plane point cloud, a probe trace"):
        npts = bowl.mesh.ndofs
        t0 = time.perf_counter()
        path = fio.write_vtk_structured(str(IO / "flagship"), bowl.mesh,
                                        {"u": s200.u, "v": s200.v})
        t_vtk = time.perf_counter() - t0
        pts, got = read_vtk(path, npts, ("u", "v"))
        ok = (np.array_equal(pts, bowl.mesh.node_coords.reshape(-1, 3)
                             .astype(">f4"))
              and all(np.array_equal(got[k], getattr(s200, k).cpu().numpy()
                                     .reshape(-1).astype(">f4"))
                      for k in ("u", "v")))
        mb = megabytes(path)
        print(f"   VTK {npts} points: {mb:.1f} MB in {t_vtk:.3f} s "
              f"({mb / t_vtk:.1f} MB/s, host clock); payload read back "
              f"{'exactly' if ok else 'NOT exactly'}")
        if not ok:
            fail("phase 30b: the VTK payload does not read back exactly")
        t0 = time.perf_counter()
        ppts, vals = eval_plane(bowl.mesh, s200.u.cpu().numpy(), axis=2,
                                coord=focus[2], n0=179, n1=179)
        ppath = fio.save_point_cloud(str(IO / "plane.txt"), ppts, vals,
                                     cols=(0, 1))
        t_plane = time.perf_counter() - t0
        rows = np.loadtxt(ppath, delimiter=",")
        # NaN exactly at the points outside the bowl's curved domain
        inside = locate(bowl.mesh, ppts)[2]
        tpath = IO / "probe.txt"
        ts = s100.t + np.arange(1, 101) * dt
        np.savetxt(tpath, np.hstack([ts[:, None],
                                     ys30.double().cpu().numpy()]),
                   delimiter=",", header="t, p(focus)")
        trace = np.loadtxt(tpath, delimiter=",")
        print(f"   plane: {rows.shape[0]} points ({int(inside.sum())} in the "
              f"domain), {megabytes(ppath):.2f} MB in {t_plane:.3f} s; "
              f"probe trace {trace.shape[0]} steps, last p(focus) "
              f"{trace[-1, 1]:.1f} Pa")
        if rows.shape != (179 * 179, 3) or not inside.any() \
                or not np.array_equal(np.isfinite(rows[:, 2]), inside) \
                or trace.shape != (100, 2) or not np.isfinite(trace).all():
            fail("phase 30b: the plane or the probe trace is malformed")
        del got, pts, rows
    with phase("30d degree transfer of the flagship at step 100, P=4 -> "
               "P=6 on the card, then 10 steps at P=6 (#1)"):
        args6 = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "6"])
        t0 = time.perf_counter()
        bowl6, dt6, _, _ = nonlinear_bowl.build(
            args6, nonlinear_bowl.problem(args6))
        print(f"   host set-up of the P=6 bowl {time.perf_counter() - t0:.1f}"
              f" s")
        host = {k: kr.interpolate_box_field(
            getattr(s100, k).double().cpu().numpy(), bowl.mesh, bowl6.mesh)
            for k in ("u", "v")}
        errs, card = {}, {}
        for dt_ in (torch.float64, torch.float32):
            for k in ("u", "v"):
                x = getattr(s100, k).to(dt_)
                tm = time_ms(lambda: kr.interpolate_box_field(
                    x, bowl.mesh, bowl6.mesh), 3)
                y = kr.interpolate_box_field(x, bowl.mesh, bowl6.mesh)
                errs[(dt_, k)] = rel_l2(y.cpu(), torch.as_tensor(host[k]))
                card[(dt_, k)] = (y, tm)
        for (dt_, k), e in errs.items():
            tol = 1e-12 if dt_ == torch.float64 else 1e-6
            print(f"   {k} {str(dt_)[6:]} on the card {card[(dt_, k)][1]:.3f}"
                  f" ms ({smi}) vs the float64 host transfer: rel-l2 "
                  f"{e:.3e} (tol {tol})")
            if not e <= tol:
                fail(f"phase 30d: {k} {dt_} transfer {e:.3e} > {tol}")
        cs.reset_launches()
        s6 = bowl6.init_state(t0=s100.t, u0=card[(torch.float32, "u")][0],
                              v0=card[(torch.float32, "v")][0])
        s6, _ = bowl6.solve(s6, dt6, 10)
        torch.cuda.synchronize()
        umax = float(s6.u.abs().max())
        print(f"   P=6 ({bowl6.mesh.ndofs} DOF, dt {dt6:.4e} s): 10 steps "
              f"from the transferred state, max |u| {umax:.4e}, stiffness "
              f"launches {cs.launches['stiffness']}")
        if not bool(torch.isfinite(s6.u).all()) or umax == 0.0:
            fail("phase 30d: the P=6 restart is not finite and non-zero")
        if cs.launches["stiffness"] != 40:
            fail(f"phase 30d: launches {cs.launches['stiffness']} != 40")
        del bowl6, s6, card, host, s100, s200
    with phase("33g the flagship's mesh at P=6 (22,361,185 DOF): set-up "
               "before and after; the set-up kernels vs plain"):
        pb33 = nonlinear_bowl.problem(args6)
        a33, b33, _ = setup_turn("flagship at P=6",
                                 lambda sd: bowl_model(pb33, args6, sd))
        setup_check("flagship at P=6", a33, b33, pb33.absorbing)
        del a33, b33, pb33
    with phase("30e nonlinear_bowl demo with --output, --checkpoint-every, "
               "--snapshot-every and --probe (a subprocess)"):
        pre, ckp = IO / "demo", IO / "demo_ck"
        cmd = [sys.executable, "-m", "fustpu_torch.demos.nonlinear_bowl",
               "--elements", "64", "--degree", "4", "--output", str(pre),
               "--checkpoint", str(ckp), "--checkpoint-every", "1000",
               "--snapshot-every", "1000", "--probe",
               *(str(x) for x in focus)]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        text = out.stdout
        keep = [ln for ln in text.splitlines()
                if not ln.startswith("t: ")][-14:]
        print("\n".join(f"   | {ln}" for ln in keep))
        if out.returncode != 0:
            fail(f"phase 30e: the demo exited {out.returncode}: "
                 f"{out.stderr[-2000:]}")
        m = re.search(r"pressure at focus: (\S+) Pa", text)
        n = re.search(r"Number of steps: (\d+)", text)
        la = re.search(r"stiffness launches: stiffness (\d+)", text)
        p_demo = float(m.group(1)) if m else float("nan")
        files = [Path(f"{pre}_nonlinear_bowl.vtk"),
                 Path(f"{pre}_pressure_plane.txt"),
                 Path(f"{pre}_nonlinear_bowl_probe.txt"),
                 Path(f"{pre}_nonlinear_bowl_snap_1000.txt"),
                 Path(f"{ckp}_1000.npz")]
        print(f"   files: " + ", ".join(
            f"{f.name} {megabytes(f):.1f} MB" if f.exists()
            else f"{f.name} MISSING" for f in files))
        if not all(f.exists() for f in files):
            fail("phase 30e: a file of the demo is missing")
        if not FOCAL_BAND_PA[0] <= p_demo <= FOCAL_BAND_PA[1]:
            fail(f"phase 30e: focal pressure {p_demo} outside "
                 f"{FOCAL_BAND_PA}")
        if not (n and la and int(la.group(1)) == 4 * int(n.group(1))):
            fail("phase 30e: the demo's stiffness launches are not 4 x its "
                 "steps")
        for f in files:
            f.unlink()

    def corner_check(model, label, kernel, g_module=None):
        """A corner-mode model: the corner operator on its kernel, no host
        metric; the kernel against its plain version (and against the
        G-stream module `g_module` of the same mesh) on unit-normal
        input(s).  Returns (plain module, kernel entry for the JSON
        line)."""
        kst = model.stiffness
        if not isinstance(kst, CornerStiffness) or \
                model.stiffness_kernel != kernel:
            fail(f"{label}: stiffness {type(kst).__name__} on "
                 f"{model.stiffness_kernel}, expected {kernel}")
        if "_G_host" in model.disc.__dict__:
            fail(f"{label}: the corner model built the host metric")
        pst = CornerStiffness(kst.cell_op, "mm")
        xs = [torch.as_tensor(rng.standard_normal(model.mesh.grid_shape),
                              dtype=torch.float32, device=dev)
              for _ in range(2 if kst.is_pair else 1)]
        run = (lambda m: m.pair(*xs)) if kst.is_pair else (lambda m: m(xs[0]))
        yk, yp = run(kst), run(pst)
        err = rel_l2(yk, yp)
        if not err <= F32_TOL:
            fail(f"{label}: corner kernel vs plain {err:.3e} > {F32_TOL}")
        msg = ""
        if g_module is not None:
            errg = rel_l2(yk, run(g_module))
            msg = f", vs the G-stream kernel {errg:.3e}"
            if not errg <= F32_TOL:
                fail(f"{label}: corner vs G-stream kernel {errg:.3e}")
        index = kst.rows.numel() * 4 if kst.rows is not None else 0
        entry = dict(max_abs_err=float((yk - yp).abs().max()), rel_l2=err,
                     ms=time_ms(lambda: run(kst), 20),
                     plain_ms=time_ms(lambda: run(pst), 10),
                     cost=cc.apply_cost(kst.cell_op, model.mesh.ndofs,
                                        len(xs), extra=index))
        print(f"   {smi}: {label} at {model.mesh.num_cells} cells: {entry}"
              f"{msg}", flush=True)
        return pst, entry

    def corner_turns(tag, model, dt_, label, entry):
        """Phase 29 on a corner-mode model just built: the class-launch
        design against the walk in turns (old, new, new, old, twice) on
        seeded unit-normal input(s), ms, share of the bound and launches an
        apply of each; the walk's schedule; 10 steps on each design within
        TRAJ_TOL.  `entry`: the walk's kernel entry (corner_check's), whose
        plain time and cost the class-launch design shares.  Records the
        class-launch design's kernel entry and its launches here, and sets
        both entries' `ms` to their best turn (corner_check's single
        reading of the walk is printed beside it)."""
        kst = model.stiffness
        op = kst.cell_op
        old = ClassLaunchCorner(op)
        name = f"{op.kernel}_classes" + ("_pair" if kst.is_pair else "")
        with phase(f"29{tag} {label}: the class-launch design against the "
                   "walk in turns, 10 steps on each"):
            cc.reset_launches()
            # a generator of its own: the later phases' inputs stay as
            # they were without phase 29
            own = np.random.default_rng(29)
            xs = [torch.as_tensor(own.standard_normal(
                model.mesh.grid_shape), dtype=torch.float32, device=dev)
                for _ in range(2 if kst.is_pair else 1)]
            run = (lambda m: m.pair(*xs)) if kst.is_pair else \
                (lambda m: m(xs[0]))
            yp = run(CornerStiffness(op, "mm"))
            yo, yn = run(old), run(kst)
            eo, en = rel_l2(yo, yp), rel_l2(yn, yp)
            if not (eo <= F32_TOL and en <= F32_TOL):
                fail(f"{label}: vs plain, class-launch {eo:.3e}, walk "
                     f"{en:.3e} (tol {F32_TOL})")
            ms = {"old": [], "new": []}
            for who in ("old", "new", "new", "old") * 2:
                ms[who].append(time_ms(
                    lambda m=old if who == "old" else kst: run(m), 20))
            best = {k: min(v) for k, v in ms.items()}
            print(f"   the walk: corner_check's reading {entry['ms']:.4f} "
                  f"ms, its best turn here {best['new']:.4f} ms (the "
                  "kernels line's)")
            entry["ms"] = best["new"]
            b_ms = bound(*entry["cost"])[0]
            sched = cc.card_schedule(op, xs[0], kst.is_pair)
            per_old = 8 if op.box else sum(
                1 for a, b in zip(op.bounds, op.bounds[1:]) if b > a)
            segs = (f", {sched.segments} segment(s) a stack"
                    if hasattr(sched, "segments") else "")
            print(f"   {smi}: {label}: the class-launch design "
                  + " / ".join(f"{t:.4f}" for t in ms["old"])
                  + f" ms ({b_ms / best['old']:.1%} of the bound "
                  f"{b_ms:.4f} ms, {per_old} launches an apply), the walk "
                  + " / ".join(f"{t:.4f}" for t in ms["new"])
                  + f" ms ({b_ms / best['new']:.1%}, {len(sched.classes)} "
                  f"launches an apply): the walk "
                  f"{'faster' if best['new'] < best['old'] else 'SLOWER'}, "
                  f"{best['old'] / best['new']:.4f}x; vs plain {eo:.3e} / "
                  f"{en:.3e}; walk schedule {sched.cpb} cells a "
                  f"chunk{segs}, {sched.blocks_per_sm} blocks an SM, "
                  f"{sched.blocks} blocks", flush=True)
            sn, _ = model.solve(model.init_state(), dt_, 10)
            model.stiffness = old
            try:
                so, _ = model.solve(model.init_state(), dt_, 10)
            finally:
                model.stiffness = kst
            traj = rel_l2(so.u, sn.u)
            torch.cuda.synchronize()
            print(f"   10 steps on the class-launch design vs the walk: "
                  f"rel-l2(u) {traj:.3e} (tol {TRAJ_TOL}); launches "
                  f"{dict(cc.launches)}, {dict(cc.class_launches)}")
            if not traj <= TRAJ_TOL:
                fail(f"{label}: 10 steps class-launch vs walk {traj:.3e}")
            demo_launches[name] = cc.class_launches[name]
            if not demo_launches[name]:
                fail(f"{name} was not launched")
            kernels[name] = dict(
                max_abs_err=float((yo - yp).abs().max()), rel_l2=eo,
                ms=best["old"], plain_ms=entry["plain_ms"],
                cost=entry["cost"])
            del xs, yp, yo, yn, sn, so

    with phase("17a flagship in corner mode: build, kernel vs plain and "
               "G stream, 10 steps"):
        args9 = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "4", "--stiffness-impl",
             "pallas_corner"])
        t0 = time.perf_counter()
        cbowl, dt9, nsteps9, focus9 = nonlinear_bowl.build(args9, pb6)
        print(f"   host set-up on phase 6a's mesh (channels, diagonals, "
              f"upload) {time.perf_counter() - t0:.1f} s", flush=True)
        if (dt9, nsteps9) != (dt, nsteps):
            fail(f"corner flagship steps {dt9}, {nsteps9} != {dt}, {nsteps}")
        pst9, kernels["corner"] = corner_check(cbowl, "flagship corner",
                                               "corner", g_module=kstiff)
        print(f"   per apply: corner kernel {kernels['corner']['ms']:.4f} "
              f"ms, G-stream kernel {kernels['stiffness']['ms']:.4f} ms "
              f"({smi})")
        sc, _ = cbowl.solve(cbowl.init_state(), dt, 10)
        sg, _ = bowl.solve(bowl.init_state(), dt, 10)
        traj = rel_l2(sc.u, sg.u)
        print(f"   10 steps corner vs G-stream model: rel-l2(u) {traj:.3e} "
              f"(tol {TRAJ_TOL})")
        if not traj <= TRAJ_TOL:
            fail(f"flagship 10 steps corner vs G stream {traj:.3e}")
        del sc, sg, pst9
        mem = {name: (held_bytes(m), solve_peak(m, dt, 10))
               for name, m in (("corner", cbowl), ("G stream", bowl))}
        for name, (held, peak) in mem.items():
            print(f"   {name} model: buffers {held / 1e9:.4f} GB, a "
                  f"10-step solve adds at most {peak / 1e9:.4f} GB ({smi})")
        keep_for_ranks("22c flagship in corner mode, grid (2, 2, 1)", cbowl,
                       dt9, 20, BOWL_POINTS, grid=(2, 2, 1))
    del bowl, kstiff
    corner_turns("a", cbowl, dt9, "flagship corner (#3)", kernels["corner"])
    with phase("34g flagship in corner mode, bf16: build without the host "
               "metric, #3 vs plain, 10 steps kernel vs plain, 50 steps in "
               "turns with 17a's float32 corner model, device memory"):
        argv34g = ["--elements", "64", "--degree", "4", "--stiffness-impl",
                   "pallas_corner"]
        cbowl16, dt34g, _, _, pst34g, kernels["corner_bf16"] = bf16_corner(
            "flagship", argv34g, pb6, "corner")
        k34g = cbowl16.stiffness
        bf16_reset()
        sk, _ = cbowl16.solve(cbowl16.init_state(), dt34g, 10)
        torch.cuda.synchronize()
        counts = bf16_counters()
        bf16_counts["corner_bf16"] = counts["corner_bf16"]
        if counts["corner_bf16"] != 4 * 10 or sum(counts.values()) != 40:
            fail(f"34g: bf16 launches {counts} != 4 x 10 of corner_bf16")
        cbowl16.stiffness = pst34g
        sp, _ = cbowl16.solve(cbowl16.init_state(), dt34g, 10)
        cbowl16.stiffness = k34g
        traj = rel_l2(sk.u, sp.u)
        print(f"   10 bf16 corner steps kernel vs plain: rel-l2(u) "
              f"{traj:.3e} (tol {BF16_TRAJ_TOL}), max |u| "
              f"{float(sk.u.abs().max()):.4e}; launches {counts}")
        if not traj <= BF16_TRAJ_TOL:
            fail(f"34g: 10 bf16 corner steps kernel vs plain {traj:.3e}")
        if not bool(torch.isfinite(sk.u).all()) or \
                float(sk.u.abs().max()) == 0.0:
            fail("34g: the bf16 corner field is not finite and non-zero")
        del sk, sp, pst34g
        pair34 = (("f32 corner", cbowl, dt9), ("bf16 corner", cbowl16, dt34g))
        turns = ms_turns(list(pair34))
        print(f"   {smi}: ms a step (50 steps from rest, in turns f32, bf16, "
              f"bf16, f32): float32 corner {turns['f32 corner']:.4f}, bf16 "
              f"corner {turns['bf16 corner']:.4f}; #3 ms an apply: float32 "
              f"(17a) {kernels['corner']['ms']:.4f}, bf16 "
              f"{kernels['corner_bf16']['ms']:.4f}", flush=True)
        for name, m, d in pair34:
            held, add = held_bytes(m), solve_peak(m, d, 10)
            print(f"   {smi}: {name} flagship: buffers {held / 1e9:.4f} GB "
                  f"(held_bytes), a 10-step solve adds at most "
                  f"{add / 1e9:.4f} GB (peak device memory over what is "
                  f"allocated before it): {(held + add) / 1e9:.4f} GB",
                  flush=True)
        del cbowl16, k34g, pair34
    cc.reset_launches()
    with phase("17b flagship in corner mode, full solve (corner kernel)"):
        state = run_demo(cbowl, dt9, nsteps9, args9, "nonlinear_bowl")
        n_corner = cc.launches["corner"]
        p_corner = nonlinear_bowl.focal_pressure(cbowl, state, focus9)
        agree = abs(p_corner - p_focus) / abs(p_focus)
        print(f"pressure at focus: {p_corner:.1f} Pa")
        print(f"   corner launches {n_corner} for {nsteps9} steps; focal "
              f"pressure vs the G stream ({p_focus:.1f} Pa): relative "
              f"difference {agree:.3e} (tol {FOCAL_AGREE})")
        if n_corner != 4 * nsteps9 or sum(cc.launches.values()) != n_corner:
            fail(f"corner flagship launches {dict(cc.launches)} != "
                 f"4 x {nsteps9}")
        if not bool(torch.isfinite(state.u).all()):
            fail("corner flagship field is not finite")
        if not agree <= FOCAL_AGREE:
            fail(f"corner vs G-stream focal pressure {agree:.3e}")
        del state, cbowl
    with phase("17c two-layer flagship in corner mode: build + pair kernel "
               "vs plain"):
        args10 = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "4", "--two-layer",
             "--stiffness-impl", "pallas_corner"])
        cbowl2, dt10, _, _ = nonlinear_bowl.build(args10, pb6)
        _, kernels["corner_pair"] = corner_check(
            cbowl2, "two-layer flagship corner pair", "corner_pair")
    corner_turns("b", cbowl2, dt10, "two-layer flagship corner pair (#3 "
                 "pair)", kernels["corner_pair"])
    cc.reset_launches()
    with phase("17c two-layer flagship in corner mode, 50 steps (corner pair "
               "kernel)"):
        s10, _ = cbowl2.solve(cbowl2.init_state(), dt10, 50)
        torch.cuda.synchronize()
        n_corner_pair = cc.launches["corner_pair"]
        print(f"   corner pair launches {n_corner_pair}, max |u| "
              f"{float(s10.u.abs().max()):.4e}")
        if n_corner_pair != 4 * 50 or \
                sum(cc.launches.values()) != n_corner_pair:
            fail(f"launches {dict(cc.launches)} after the two-layer corner "
                 "run")
        if not bool(torch.isfinite(s10.u).all()) or \
                float(s10.u.abs().max()) == 0.0:
            fail("two-layer corner field is not finite and non-zero")
    corner_launches = dict(corner=n_corner, corner_pair=n_corner_pair)
    with phase("34g two-layer flagship in corner mode, bf16: #3 pair vs "
               "plain, 50 steps"):
        cbowl16b, dt34gb, _, _, _, kernels["corner_pair_bf16"] = bf16_corner(
            "two-layer flagship", argv34g + ["--two-layer"], pb6,
            "corner_pair")
        _, bf16_counts["corner_pair_bf16"] = bf16_steps(
            cbowl16b, dt34gb, 50, "two-layer flagship corner")
        del cbowl16b
    del cbowl2, s10, pb6

    ce.reset_launches()
    with phase("9 piston demo on the imported cylinder (--refine 2)"):
        piston, state, dev_oneil, psteps, ptraces = linear_piston.main(
            ["--refine", "2", "--device", "cuda"])
        n_piston = ce.launches["extruded"]
        print(f"   extruded launches {n_piston} for {psteps} steps; "
              f"{piston.mesh.num_cells} cells, {piston.mesh.ndofs} DOF, "
              f"{scatter_summary(piston.mesh)}")
        if n_piston != 4 * psteps or ce.launches["extruded_pair"] != 0:
            fail(f"piston launches {dict(ce.launches)} != 4 x {psteps}")
        if not dev_oneil < ONEIL_GATE:
            fail(f"O'Neil deviation {dev_oneil:.2%} >= {ONEIL_GATE:.0%}")
        if not bool(torch.isfinite(state.u).all()):
            fail("piston field is not finite")
        pspp = piston.cfl_dt()[1]
        amp9 = linear_piston.on_axis_amplitude(ptraces, pspp)
        del piston, state

    with phase("33j piston demo on 2 gloo ranks sharing the card "
               "(--refine 2 --ranks 2): the O'Neil table against phase 9's"):
        _, res33, dev33, n33, traces33 = linear_piston.main(
            ["--refine", "2", "--device", "cuda", "--ranks", "2",
             "--backend", "gloo"])
        amp33 = linear_piston.on_axis_amplitude(traces33, pspp)
        e33 = float(np.abs(amp33 - amp9).max() / np.abs(amp9).max())
        la33 = [r["launches"].get("extruded", 0) for r in res33]
        print(f"   2 ranks: {n33} steps, O'Neil deviation {dev33:.4%} (one "
              f"rank {dev_oneil:.4%}); on-axis amplitudes vs one rank: max "
              f"relative {e33:.3e} (tol {TRAJ_TOL}); extruded launches per "
              f"rank {la33} ({smi})", flush=True)
        if not (e33 <= TRAJ_TOL and n33 == psteps
                and all(n == 4 * n33 for n in la33)):
            fail(f"33j: piston on 2 ranks {e33:.3e}, {n33} steps, "
                 f"launches {la33}")
        del res33, traces33

    with phase("10a imported bowl build + extruded kernel vs plain"):
        args3 = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "4",
             "--geometry", "unstructured"])
        t0 = time.perf_counter()
        pb10 = nonlinear_bowl.problem(args3)
        ibowl, dt3, nsteps3, focus3 = nonlinear_bowl.build(args3, pb10)
        imesh = ibowl.mesh
        print(f"   host setup (export, import, extrusion detection, "
              f"geometry, upload) {time.perf_counter() - t0:.1f} s")
        idisc3 = ibowl.disc             # for phase 28
        structure = (imesh.axis, imesh.nstacks, imesh.nz, imesh.ndofs)
        print(f"   axis {structure[0]}, {structure[1]} stacks, "
              f"{structure[2]} layers, {structure[3]} DOF, "
              f"{scatter_summary(imesh)}")
        if structure != (0, 1600, 64, 6661697):
            fail(f"imported bowl structure {structure}")
        kst3 = ibowl.stiffness
        pst3 = ExtrudedStiffness(kst3.cell_op, "mm")
        x = torch.as_tensor(rng.standard_normal(imesh.ndofs),
                            dtype=torch.float32, device=dev)
        yk, yp = kst3(x), pst3(x)
        err = rel_l2(yk, yp)
        if not err <= F32_TOL:
            fail(f"imported bowl extruded kernel vs plain {err:.3e}")
        kernels["extruded"] = dict(
            max_abs_err=float((yk - yp).abs().max()), rel_l2=err,
            ms=time_ms(lambda: kst3(x), 20),
            plain_ms=time_ms(lambda: pst3(x), 10),
            cost=apply_cost(kst3.G, imesh.ndofs, 1,
                            extra=kst3.rows.numel() * 4))
        print(f"   {smi}: extruded at {imesh.num_cells} cells: "
              f"{kernels['extruded']}")
        print(f"   {stack_summary(ce.card_schedule(kst3.cell_op, x, False))}")
        del yk, yp
        s0 = ibowl.init_state()
        sk, _ = ibowl.solve(s0, dt3, 10)
        ibowl.stiffness = pst3
        sp, _ = ibowl.solve(s0, dt3, 10)
        ibowl.stiffness = kst3
        del pst3
        traj = rel_l2(sk.u, sp.u)
        print(f"   10 steps kernel vs plain: rel-l2(u) {traj:.3e} "
              f"(tol {TRAJ_TOL}), max |u| {float(sk.u.abs().max()):.4e}")
        if not traj <= TRAJ_TOL:
            fail(f"imported 10-step trajectory kernel vs plain {traj:.3e}")
        del sk, sp
        keep_for_ranks("22d imported bowl, 4 ranks", ibowl, dt3, 20,
                       BOWL_POINTS)

    with phase("33b imported bowl set-up before and after; the set-up "
               "kernels vs plain"):
        a33, b33, _ = setup_turn("imported bowl",
                                 lambda sd: bowl_model(pb10, args3, sd))
        setup_check("imported bowl", a33, b33, pb10.absorbing)
        del a33, b33
    with phase("33c imported bowl as hex27 on the G stream: set-up before "
               "and after; the set-up kernels (27 geometry dofs) vs plain"):
        pb33 = SimpleNamespace(**vars(pb10))
        pb33.mesh = shapes.hex27_lattice(pb10.mesh)
        a33, b33, _ = setup_turn("imported bowl hex27",
                                 lambda sd: bowl_model(pb33, args3, sd))
        if a33.disc._card.gdofs.shape[1] != 27:
            fail("33c: the hex27 bowl's geometry is not hex27")
        setup_check("imported bowl hex27", a33, b33, pb33.absorbing)
        del a33, b33, pb33
    ce.reset_launches()
    with phase("10b imported bowl full solve (extruded kernel)"):
        state = run_demo(ibowl, dt3, nsteps3, args3, "nonlinear_bowl")
        n_ext = ce.launches["extruded"]
        p_imp = nonlinear_bowl.focal_pressure(ibowl, state, focus3)
        agree = abs(p_imp - p_focus) / abs(p_focus)
        print(f"pressure at focus: {p_imp:.1f} Pa")
        print(f"   extruded launches {n_ext} for {nsteps3} steps; focal "
              f"pressure vs conformal ({p_focus:.1f} Pa): relative "
              f"difference {agree:.3e} (tol {FOCAL_AGREE})")
        if n_ext != 4 * nsteps3 or ce.launches["extruded_pair"] != 0:
            fail(f"imported bowl launches {dict(ce.launches)} != "
                 f"4 x {nsteps3}")
        if not bool(torch.isfinite(state.u).all()):
            fail("imported bowl field is not finite")
        if not FOCAL_BAND_PA[0] <= p_imp <= FOCAL_BAND_PA[1]:
            fail(f"imported focal pressure {p_imp:.1f} Pa outside "
                 f"{FOCAL_BAND_PA}")
        if not agree <= FOCAL_AGREE:
            fail(f"imported vs conformal focal pressure {agree:.3e}")
        del state

    with phase("34d imported bowl in bf16: #6 and its pair form vs plain, "
               "50 steps each, ms a step beside float32's"):
        argv34 = ["--elements", "64", "--degree", "4", "--geometry",
                  "unstructured"]
        ibowl16, dt34d, _, _, _, kernels["extruded_bf16"] = bf16_model(
            "imported bowl", argv34, pb10)
        _, bf16_counts["extruded_bf16"] = bf16_steps(ibowl16, dt34d, 50,
                                                     "imported bowl")
        ibowl16b, dt34e, _, _, _, kernels["extruded_pair_bf16"] = \
            bf16_model("two-layer imported bowl", argv34 + ["--two-layer"],
                       pb10)
        _, bf16_counts["extruded_pair_bf16"] = bf16_steps(
            ibowl16b, dt34e, 50, "two-layer imported bowl")
        turns = ms_turns([("f32", ibowl, dt3), ("bf16", ibowl16, dt34d),
                          ("bf16 pair", ibowl16b, dt34e)])
        print(f"   {smi}: ms a step (50 steps from rest, in turns): "
              f"float32 {turns['f32']:.4f}, bf16 {turns['bf16']:.4f}, bf16 "
              f"two-layer {turns['bf16 pair']:.4f}; #6 ms an apply: float32 "
              f"(10a) {kernels['extruded']['ms']:.4f}, bf16 "
              f"{kernels['extruded_bf16']['ms']:.4f}", flush=True)
        del ibowl16, ibowl16b

    ce.reset_launches()
    with phase("30c imported bowl through inline XDMF on #6: read_xdmf vs "
               "the .msh import, 10 steps, full-GLL unstructured VTK"):
        _, xcells, xquads = msh_io.box_msh_arrays(
            pb10.box, nonlinear_bowl.bowl_tags(pb10.box, pb10.in_aperture))
        t0 = time.perf_counter()
        xpath = xdmf_io.write_xdmf(str(IO / "bowl.xdmf"), imesh.vertices,
                                   xcells, xquads)
        t_w = time.perf_counter() - t0
        t0 = time.perf_counter()
        xmesh = xdmf_io.read_xdmf(xpath, 4)
        t_r = time.perf_counter() - t0
        same = isinstance(xmesh, ExtrudedHexMesh) and all(
            (getattr(xmesh, f.name).keys() == getattr(imesh, f.name).keys()
             and all(np.array_equal(getattr(xmesh, f.name)[k],
                                    getattr(imesh, f.name)[k])
                     for k in getattr(imesh, f.name)))
            if isinstance(getattr(imesh, f.name), dict) else
            np.array_equal(getattr(xmesh, f.name), getattr(imesh, f.name))
            for f in dataclasses.fields(imesh))
        print(f"   XDMF {megabytes(xpath):.1f} MB written in {t_w:.2f} s, "
              f"read (extrusion detection) in {t_r:.2f} s (host clock): "
              f"{type(xmesh).__name__}, mesh arrays "
              f"{'bitwise equal' if same else 'NOT equal'} to phase 10a's "
              f".msh import")
        if not same:
            fail("phase 30c: the XDMF import differs from the .msh import")
        pbx = SimpleNamespace(**vars(pb10))
        pbx.mesh, pbx.aperture, pbx.absorbing = (
            xmesh, xmesh.boundary_facets(1), xmesh.boundary_facets(2))
        xbowl, dtx, _, _ = nonlinear_bowl.build(args3, pbx)
        sa, _ = ibowl.solve(ibowl.init_state(), dt3, 10)
        sb, _ = xbowl.solve(xbowl.init_state(), dtx, 10)
        torch.cuda.synchronize()
        ok = dtx == dt3 and same_state(sa, sb)
        n_x = ce.launches["extruded"]
        print(f"   10 steps on the XDMF model vs phase 10a's: "
              f"{'bitwise equal' if ok else 'NOT equal'}; extruded "
              f"launches {n_x}")
        if not ok or n_x != 4 * 20:
            fail(f"phase 30c: 10 steps not bitwise equal ({ok}) or "
                 f"launches {n_x} != 80")
        t0 = time.perf_counter()
        cells_rows = fio.vtk_cells(xmesh)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        vpath = fio.write_vtk_unstructured(str(IO / "imported"), xmesh,
                                           {"u": sb.u, "v": sb.v})
        t_v = time.perf_counter() - t0
        pts, got = read_vtk(vpath, xmesh.ndofs, ("u",))
        okv = np.array_equal(got["u"], sb.u.cpu().numpy().astype(">f4"))
        mb = megabytes(vpath)
        print(f"   full-GLL VTK: {cells_rows.shape[0]} sub-hexes (cells "
              f"built in {t_c:.2f} s), {mb:.1f} MB in {t_v:.2f} s "
              f"({mb / t_v:.1f} MB/s, host clock); u read back "
              f"{'exactly' if okv else 'NOT exactly'} ({smi})")
        if cells_rows.shape[0] != xmesh.num_cells * 64 or not okv:
            fail("phase 30c: the unstructured VTK is malformed")
        Path(vpath).unlink()
        del xbowl, xmesh, sa, sb, cells_rows, pts, got

    def imported_corner(argv, label, kernel, pb, g_module=None):
        """Build an imported-bowl corner model on the problem `pb` and
        check it (corner_check).  Returns (model, dt, steps, focus, plain
        module, kernel entry)."""
        a = nonlinear_bowl.parser().parse_args(argv)
        t0 = time.perf_counter()
        model, dt_, nsteps_, focus_ = nonlinear_bowl.build(a, pb)
        print(f"   host set-up on phase 10a's import (channels, "
              f"diagonals, upload) {time.perf_counter() - t0:.1f} s",
              flush=True)
        pst, entry = corner_check(model, label, kernel, g_module)
        return model, dt_, nsteps_, focus_, a, pst, entry

    IMPORTED = ["--elements", "64", "--degree", "4", "--geometry",
                "unstructured", "--stiffness-impl", "pallas_corner"]
    with phase("18a imported bowl in corner mode: build, kernel vs plain "
               "and G stream, 10 steps"):
        cibowl, dt11, nsteps11, focus11, args11, pst11, \
            kernels["extruded_corner"] = imported_corner(
                IMPORTED, "imported bowl corner", "extruded_corner", pb10,
                g_module=kst3)
        if (dt11, nsteps11) != (dt3, nsteps3):
            fail(f"imported corner steps {dt11}, {nsteps11}")
        sc, _ = cibowl.solve(cibowl.init_state(), dt3, 10)
        sg, _ = ibowl.solve(ibowl.init_state(), dt3, 10)
        traj = rel_l2(sc.u, sg.u)
        print(f"   10 steps corner vs G-stream model: rel-l2(u) {traj:.3e} "
              f"(tol {TRAJ_TOL})")
        if not traj <= TRAJ_TOL:
            fail(f"imported 10 steps corner vs G stream {traj:.3e}")
        del sc, sg, pst11, ibowl, kst3
    corner_turns("c", cibowl, dt11, "imported bowl corner (#6c hex8)",
                 kernels["extruded_corner"])
    cc.reset_launches()
    with phase("18b imported bowl in corner mode, full solve (extruded "
               "corner kernel)"):
        state = run_demo(cibowl, dt11, nsteps11, args11, "nonlinear_bowl")
        n_ext_corner = cc.launches["extruded_corner"]
        p_ic = nonlinear_bowl.focal_pressure(cibowl, state, focus11)
        agree = abs(p_ic - p_imp) / abs(p_imp)
        print(f"pressure at focus: {p_ic:.1f} Pa")
        print(f"   extruded corner launches {n_ext_corner} for {nsteps11} "
              f"steps; focal pressure vs the G stream ({p_imp:.1f} Pa): "
              f"relative difference {agree:.3e} (tol {FOCAL_AGREE})")
        if n_ext_corner != 4 * nsteps11 or \
                sum(cc.launches.values()) != n_ext_corner:
            fail(f"imported corner launches {dict(cc.launches)} != "
                 f"4 x {nsteps11}")
        if not bool(torch.isfinite(state.u).all()):
            fail("imported corner field is not finite")
        if not agree <= FOCAL_AGREE:
            fail(f"imported corner vs G-stream focal pressure {agree:.3e}")
        del state
    with phase("18c two-layer imported bowl in corner mode: build + pair "
               "kernel vs plain"):
        cibowl2, dt12, _, _, _, _, kernels["extruded_corner_pair"] = \
            imported_corner(IMPORTED + ["--two-layer"],
                            "two-layer imported corner pair",
                            "extruded_corner_pair", pb10)
    corner_turns("d", cibowl2, dt12, "two-layer imported corner pair (#6c "
                 "hex8 pair)", kernels["extruded_corner_pair"])
    cc.reset_launches()
    with phase("18c two-layer imported bowl in corner mode, 50 steps "
               "(extruded corner pair kernel)"):
        s12, _ = cibowl2.solve(cibowl2.init_state(), dt12, 50)
        torch.cuda.synchronize()
        n_ext_corner_pair = cc.launches["extruded_corner_pair"]
        print(f"   extruded corner pair launches {n_ext_corner_pair}, max "
              f"|u| {float(s12.u.abs().max()):.4e}")
        if n_ext_corner_pair != 4 * 50 or \
                sum(cc.launches.values()) != n_ext_corner_pair:
            fail(f"launches {dict(cc.launches)} after the two-layer "
                 "imported corner run")
        if not bool(torch.isfinite(s12.u).all()) or \
                float(s12.u.abs().max()) == 0.0:
            fail("two-layer imported corner field is not finite and "
                 "non-zero")
        del s12
    with phase("34h imported bowl in corner mode, bf16, hex8: #6c and its "
               "pair form vs plain, 50 steps each, ms a step in turns with "
               "18's float32 corner models"):
        ic16, dt34h, _, _, _, kernels["extruded_corner_bf16"] = bf16_corner(
            "imported bowl", IMPORTED, pb10, "extruded_corner")
        _, bf16_counts["extruded_corner_bf16"] = bf16_steps(
            ic16, dt34h, 50, "imported bowl corner")
        ic16b, dt34hb, _, _, _, kernels["extruded_corner_pair_bf16"] = \
            bf16_corner("two-layer imported bowl", IMPORTED + ["--two-layer"],
                        pb10, "extruded_corner_pair")
        _, bf16_counts["extruded_corner_pair_bf16"] = bf16_steps(
            ic16b, dt34hb, 50, "two-layer imported bowl corner")
        turns = ms_turns([("f32", cibowl, dt11), ("bf16", ic16, dt34h),
                          ("f32 pair", cibowl2, dt12),
                          ("bf16 pair", ic16b, dt34hb)])
        print(f"   {smi}: ms a step (50 steps from rest, in turns): float32 "
              f"corner {turns['f32']:.4f}, bf16 corner {turns['bf16']:.4f}, "
              f"two-layer float32 {turns['f32 pair']:.4f}, bf16 "
              f"{turns['bf16 pair']:.4f}; #6c ms an apply: float32 (18a) "
              f"{kernels['extruded_corner']['ms']:.4f}, bf16 "
              f"{kernels['extruded_corner_bf16']['ms']:.4f}", flush=True)
        del ic16, ic16b
    with phase("18d imported bowl as hex27: build, 163-channel kernel vs "
               "plain and vs the hex8 corner kernel"):
        t0 = time.perf_counter()
        pb27 = SimpleNamespace(**vars(pb10))
        pb27.mesh = shapes.hex27_lattice(pb10.mesh)
        print(f"   hex27 lattice {time.perf_counter() - t0:.1f} s")
        hbowl, dt13, nsteps13, focus13, args13, _, \
            kernels["extruded_corner_hex27"] = imported_corner(
                IMPORTED, "imported bowl hex27 corner",
                "extruded_corner_hex27", pb27,
                g_module=cibowl.stiffness)
        if hbowl.stiffness.T.shape[1] != 163:
            fail(f"hex27 channels {hbowl.stiffness.T.shape}")
        del cibowl
    corner_turns("e", hbowl, dt13, "imported bowl hex27 corner (#6c hex27)",
                 kernels["extruded_corner_hex27"])
    cc.reset_launches()
    with phase("18d imported bowl as hex27, full solve (hex27 corner "
               "kernel)"):
        state = run_demo(hbowl, dt13, nsteps13, args13, "nonlinear_bowl")
        n_hex27 = cc.launches["extruded_corner_hex27"]
        p_h27 = nonlinear_bowl.focal_pressure(hbowl, state, focus13)
        agree = abs(p_h27 - p_imp) / abs(p_imp)
        print(f"pressure at focus: {p_h27:.1f} Pa")
        print(f"   hex27 corner launches {n_hex27} for {nsteps13} steps; "
              f"focal pressure vs the hex8 G stream ({p_imp:.1f} Pa): "
              f"relative difference {agree:.3e} (tol {FOCAL_AGREE})")
        if n_hex27 != 4 * nsteps13 or sum(cc.launches.values()) != n_hex27:
            fail(f"hex27 launches {dict(cc.launches)} != 4 x {nsteps13}")
        if not bool(torch.isfinite(state.u).all()):
            fail("hex27 field is not finite")
        if not agree <= FOCAL_AGREE:
            fail(f"hex27 vs hex8 focal pressure {agree:.3e}")
        del state, hbowl
    with phase("34h imported bowl as hex27 in corner mode, bf16: the hex27 "
               "kernel and its pair form vs plain, 50 steps each"):
        h16, dt34j, _, _, _, kernels["extruded_corner_hex27_bf16"] = \
            bf16_corner("imported bowl hex27", IMPORTED, pb27,
                        "extruded_corner_hex27")
        _, bf16_counts["extruded_corner_hex27_bf16"] = bf16_steps(
            h16, dt34j, 50, "imported bowl hex27 corner")
        h16b, dt34jb, _, _, _, kernels["extruded_corner_hex27_pair_bf16"] = \
            bf16_corner("two-layer imported bowl hex27",
                        IMPORTED + ["--two-layer"], pb27,
                        "extruded_corner_hex27_pair")
        _, bf16_counts["extruded_corner_hex27_pair_bf16"] = bf16_steps(
            h16b, dt34jb, 50, "two-layer imported bowl hex27 corner")
        turns = ms_turns([("bf16", h16, dt34j), ("bf16 pair", h16b, dt34jb)])
        print(f"   {smi}: ms a step (50 steps from rest, in turns): bf16 "
              f"hex27 corner {turns['bf16']:.4f}, two-layer "
              f"{turns['bf16 pair']:.4f}; hex27 ms an apply: float32 (18d) "
              f"{kernels['extruded_corner_hex27']['ms']:.4f}, bf16 "
              f"{kernels['extruded_corner_hex27_bf16']['ms']:.4f}",
              flush=True)
        del h16, h16b
    with phase("18e two-layer imported bowl as hex27: build + hex27 pair "
               "kernel vs plain and vs the hex8 corner pair kernel"):
        hbowl2, dt14, _, _, _, _, kernels["extruded_corner_hex27_pair"] = \
            imported_corner(IMPORTED + ["--two-layer"],
                            "two-layer imported hex27 corner pair",
                            "extruded_corner_hex27_pair", pb27,
                            g_module=cibowl2.stiffness)
        del cibowl2, pb27
    corner_turns("f", hbowl2, dt14, "two-layer imported hex27 corner pair "
                 "(#6c hex27 pair)", kernels["extruded_corner_hex27_pair"])
    cc.reset_launches()
    with phase("18e two-layer imported bowl as hex27, 50 steps (hex27 "
               "corner pair kernel)"):
        s14, _ = hbowl2.solve(hbowl2.init_state(), dt14, 50)
        torch.cuda.synchronize()
        n_hex27_pair = cc.launches["extruded_corner_hex27_pair"]
        print(f"   hex27 corner pair launches {n_hex27_pair}, max |u| "
              f"{float(s14.u.abs().max()):.4e}")
        if n_hex27_pair != 4 * 50 or \
                sum(cc.launches.values()) != n_hex27_pair:
            fail(f"launches {dict(cc.launches)} after the two-layer hex27 "
                 "run")
        if not bool(torch.isfinite(s14.u).all()) or \
                float(s14.u.abs().max()) == 0.0:
            fail("two-layer hex27 field is not finite and non-zero")
        del s14, hbowl2
    corner_launches.update(extruded_corner=n_ext_corner,
                           extruded_corner_pair=n_ext_corner_pair,
                           extruded_corner_hex27=n_hex27,
                           extruded_corner_hex27_pair=n_hex27_pair)

    with phase("11a two-layer imported bowl build + pair kernel vs plain"):
        args4 = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "4",
             "--geometry", "unstructured", "--two-layer"])
        ibowl2, dt4, _, _ = nonlinear_bowl.build(args4, pb10)
        del pb10
        kst4 = ibowl2.stiffness
        if not kst4.is_pair:
            fail("two-layer imported model did not build the pair operator")
        pst4 = ExtrudedStiffness(kst4.cell_op, "mm")
        x = torch.as_tensor(rng.standard_normal(ibowl2.mesh.ndofs),
                            dtype=torch.float32, device=dev)
        x2 = torch.as_tensor(rng.standard_normal(ibowl2.mesh.ndofs),
                             dtype=torch.float32, device=dev)
        yk, yp = kst4.pair(x, x2), pst4.pair(x, x2)
        err = rel_l2(yk, yp)
        if not err <= F32_TOL:
            fail(f"extruded pair kernel vs plain {err:.3e} > {F32_TOL}")
        kernels["extruded_pair"] = dict(
            max_abs_err=float((yk - yp).abs().max()), rel_l2=err,
            ms=time_ms(lambda: kst4.pair(x, x2), 20),
            plain_ms=time_ms(lambda: pst4.pair(x, x2), 10),
            cost=apply_cost(kst4.G, ibowl2.mesh.ndofs, 2,
                            extra=kst4.rows.numel() * 4))
        print(f"   {smi}: extruded pair at {ibowl2.mesh.num_cells} cells: "
              f"{kernels['extruded_pair']}")
        print(f"   {stack_summary(ce.card_schedule(kst4.cell_op, x, True))}")
        del yk, yp, pst4, x, x2

    ce.reset_launches()
    with phase("11b two-layer imported bowl, 50 steps (pair kernel)"):
        s4, _ = ibowl2.solve(ibowl2.init_state(), dt4, 50)
        torch.cuda.synchronize()
        n_ext_pair = ce.launches["extruded_pair"]
        print(f"   extruded pair launches {n_ext_pair}, max |u| "
              f"{float(s4.u.abs().max()):.4e}")
        if n_ext_pair != 4 * 50 or ce.launches["extruded"] != 0:
            fail(f"launches {dict(ce.launches)} after the two-layer "
                 "imported run")
        if not bool(torch.isfinite(s4.u).all()) or \
                float(s4.u.abs().max()) == 0.0:
            fail("two-layer imported field is not finite and non-zero")
    launches.update(extruded=n_piston + n_ext, extruded_pair=n_ext_pair)
    del ibowl2, kst4, s4

    def gather2_turns(op, xs, label):
        """The two-field gather (new, four positions a thread) against its
        first design (old, `cen.gather2_flat`, one thread a position) and
        two `index_select` calls (library) on the fields `xs` of the pair
        operator `op`, each bitwise the others': ms per call in turns
        (old, new, new, old, library); then the composed pair apply on
        each gather, in turns.  Returns the updates of the JSON line's
        entries (the gather's ms and library_ms, its first design's ms,
        library_ms and launches in the turns), in that order."""
        g = op.dofmap.reshape(-1).long()
        sfx = "_bf16" if op.G.dtype == BF16 else ""
        run = {"old": lambda: cen.gather2_flat(op, *xs),
               "new": lambda: cen.gather2(op, *xs),
               "library": lambda: tuple(x.index_select(0, g) for x in xs)}
        got = {k: torch.cat([u.reshape(-1) for u in f()])
               for k, f in run.items()}
        if not (torch.equal(got["old"], got["new"])
                and torch.equal(got["library"], got["new"])):
            fail(f"{label}: gather2, its first design and index_select are "
                 "not bitwise equal")
        cen.comparison_launches[f"engine_gather2_flat{sfx}"] = 0
        t = {k: [] for k in run}
        for name in ("old", "new", "new", "old", "library"):
            t[name].append(time_ms(run[name], 20))
        n_old = cen.comparison_launches[f"engine_gather2_flat{sfx}"]
        b_ms = bound(profile_step.engine_bytes(op)[0], 0)[0]
        best = {k: min(v) for k, v in t.items()}
        print(f"   {smi}: {label} gather2{sfx} ({g.numel():,} positions) "
              f"in turns (old, new, new, old, two index_select): "
              + ", ".join(f"{v:.4f}" for v in (
                  t["old"][0], t["new"][0], t["new"][1], t["old"][1],
                  t["library"][0]))
              + f" ms; of the bound {b_ms:.4f} ms: new "
              f"{b_ms / best['new']:.1%}, old {b_ms / best['old']:.1%}; "
              f"old / new {best['old'] / best['new']:.4f}", flush=True)
        pair = {"old": lambda: cen.scatter(op, cen.contract(
                    op, *cen.gather2_flat(op, *xs))),
                "new": lambda: cen.engine_pair(op, *xs)}
        if not torch.equal(pair["old"](), pair["new"]()):
            fail(f"{label}: the pair apply on gather2's first design is not "
                 "bitwise the kernel's")
        a = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            a[name].append(time_ms(pair[name], 20))
        print(f"   {smi}: {label} pair apply{sfx} on the old / new gather2 "
              f"in turns: {a['old'][0]:.4f} / {a['new'][0]:.4f} / "
              f"{a['new'][1]:.4f} / {a['old'][1]:.4f} ms", flush=True)
        return ({"ms": best["new"], "library_ms": t["library"][0],
                 "turns": {k: t[k] for k in ("old", "new")},
                 "apply_turns": a},
                {"ms": best["old"], "library_ms": t["library"][0],
                 "launches": n_old})

    def merge_gather2_turns(out, op, xs, label):
        """`gather2_turns` into the JSON line's entries `out`: the
        gather's ms and library_ms from the turns, and its first design's
        entry (the gather's checks, bitwise)."""
        sfx = "_bf16" if op.G.dtype == BF16 else ""
        new, old = gather2_turns(op, xs, label)
        out[f"engine_gather2{sfx}"].update(new)
        out[f"engine_gather2_flat{sfx}"] = dict(
            out[f"engine_gather2{sfx}"], **old)

    def engine_kernels(model, ist, label):
        """The engine model's kernels at this size, float32: each against
        its plain version on the same inputs (the gathers bitwise) and
        timed, with its minimum bytes (and operations); the composed apply
        against its plain version and against the indexed kernel `ist` (the
        IndexedStiffness of the same mesh and coefficients), timed in the
        same run.  Returns the kernels' entries for the JSON line."""
        est = model.stiffness
        op, ndofs = est.cell_op, model.mesh.ndofs
        p = cen.to_plain(op)
        n, cells, N = op.P + 1, op.dofmap.shape[0], op.dofmap.numel()
        b = op.G.element_size()
        flops = cells * n ** 3 * (12 * n + 16)
        xs = [torch.as_tensor(rng.standard_normal(ndofs), dtype=torch.float32,
                              device=dev) for _ in range(2 if est.is_pair
                                                         else 1)]
        out = {}

        def entry(yk, yp, run, run_plain, cost, library=None):
            err = rel_l2(yk, yp)
            return dict(max_abs_err=float((yk - yp).abs().max()), rel_l2=err,
                        ms=time_ms(run, 20), plain_ms=time_ms(run_plain, 10),
                        cost=cost, library_ms=None if library is None
                        else time_ms(library, 20))

        if est.is_pair:
            u1, u2 = cen.gather2(op, *xs)
            r1, r2 = eng.gather2(*xs, p.g)
            out["engine_gather2"] = entry(
                torch.cat([u1.reshape(-1), u2.reshape(-1)]),
                torch.cat([r1, r2]), lambda: cen.gather2(op, *xs),
                lambda: eng.gather2(*xs, p.g),
                (N * 4 + 2 * ndofs * b + 2 * N * b, 0))
            merge_gather2_turns(out, op, xs, label)
            uc = p.c1[:, None] * u1 + p.c2[:, None] * u2
            yk = cen.contract(op, u1, u2)
            out["engine_contract"] = entry(
                yk, eng.dense_contract(uc, p.G6, p.D),
                lambda: cen.contract(op, u1, u2),
                lambda: eng.dense_contract(p.c1[:, None] * u1
                                           + p.c2[:, None] * u2, p.G6, p.D),
                ((2 + 6 + 1) * N * b + 2 * cells * b, flops + cells * n ** 3
                 * 3))
        else:
            u1 = cen.gather(op, xs[0])
            out["engine_gather"] = entry(
                u1.reshape(-1), eng.gather(xs[0], p.g),
                lambda: cen.gather(op, xs[0]), lambda: eng.gather(xs[0], p.g),
                (N * 4 + ndofs * b + N * b, 0),
                library=lambda: xs[0].index_select(0, p.g))
            yk = cen.contract(op, u1)
            out["engine_contract"] = entry(
                yk, eng.dense_contract(u1, p.G6, p.D, p.coeff),
                lambda: cen.contract(op, u1),
                lambda: eng.dense_contract(u1, p.G6, p.D, p.coeff),
                ((1 + 6 + 1) * N * b + (0 if p.coeff is None else cells * b),
                 flops))
        out["engine_scatter"] = entry(
            cen.scatter(op, yk), eng.scatter_add(yk, p.g, ndofs),
            lambda: cen.scatter(op, yk),
            lambda: eng.scatter_add(yk, p.g, ndofs),
            (N * b + N * 4 + (ndofs + 1) * 4 + ndofs * b, 0),
            library=lambda: torch.zeros(ndofs, dtype=yk.dtype,
                                        device=dev).index_add_(
                0, p.g, yk.reshape(-1)))
        run = (lambda m: m.pair(*xs)) if est.is_pair else (lambda m: m(xs[0]))
        pst = EngineStiffness(op, "mm")
        y = run(est)
        out["engine"] = entry(y, run(pst), lambda: run(est), lambda: run(pst),
                              apply_cost(op.G, ndofs, len(xs), extra=N * 4))
        ms_idx = time_ms(lambda: run(ist), 20)
        e_idx = rel_l2(y, run(ist))
        for name, k in out.items():
            print(f"   {smi}: {label} {name}: {k}", flush=True)
            tol = 0.0 if "gather" in name else F32_TOL
            if not k["rel_l2"] <= tol:
                fail(f"{label}: {name} vs plain {k['rel_l2']:.3e}")
        print(f"   {smi}: {label} at {cells} cells: composed engine "
              f"{out['engine']['ms']:.4f} ms per apply vs the indexed kernel "
              f"{ms_idx:.4f} ms (same run), relative difference "
              f"{e_idx:.3e}", flush=True)
        if not e_idx <= F32_TOL:
            fail(f"{label}: engine vs indexed kernel {e_idx:.3e}")
        out["engine"]["indexed_ms"] = ms_idx
        return out

    class FlatGatherEngine(torch.nn.Module):
        """The staged engine with the single-field gather's first design
        (`cen.gather_flat`, one thread a position) in place of the
        kernel's."""

        def __init__(self, op):
            super().__init__()
            self.op = op

        def forward(self, x):
            return cen.scatter(self.op, cen.contract(
                self.op, cen.gather_flat(self.op, x)))

    def cold_ms(fn, reps: int = 20) -> float:
        """Mean device ms of one call of `fn` after a 256 MB write that
        leaves none of its inputs in the 50 MB L2 (CUDA events around each
        call)."""
        flush = torch.empty(2 ** 26, dtype=torch.float32, device=dev)
        fn()
        pairs = []
        for _ in range(reps):
            flush.fill_(1.0)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            pairs.append(ev)
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    def gather_turns(model, state, dt_, label):
        """The single-field gather's kernel (new) against its first design
        (old, `cen.gather_flat`) and `index_select` (library) on one f32
        field of `model`'s engine, each bitwise the others': ms per call
        in turns (old, new, new, old, library) with a warm L2 (a chain on
        the same x) and a cold one; the composed apply and `model`'s
        steady ms/step over 50 steps from `state`, old gather against new,
        in turns (old, new, new, old), the steps bitwise equal.  Returns
        ({variant: [warm ms]}, the first design's launches in the run)."""
        est = model.stiffness
        op = est.cell_op
        g = op.dofmap.reshape(-1).long()
        x = torch.as_tensor(rng.standard_normal(op.ndofs),
                            dtype=torch.float32, device=dev)
        run = {"old": lambda: cen.gather_flat(op, x),
               "new": lambda: cen.gather(op, x),
               "library": lambda: x.index_select(0, g)}
        y = run["new"]().reshape(-1)
        if not (torch.equal(run["old"]().reshape(-1), y)
                and torch.equal(run["library"](), y)):
            fail(f"{label}: the gathers are not bitwise equal")
        cen.reset_launches()
        warm = {k: [] for k in run}
        cold = {k: [] for k in run}
        for name in ("old", "new", "new", "old", "library"):
            warm[name].append(time_ms(run[name], 20))
            cold[name].append(cold_ms(run[name]))
        n_flat = cen.comparison_launches["engine_gather_flat"]
        N = op.dofmap.numel()
        b_ms = bound(N * 4 + op.ndofs * 4 + N * 4, 0)[0]
        for what, t in (("warm", warm), ("cold", cold)):
            best = {k: min(v) for k, v in t.items()}
            print(f"   {smi}: {label} gather ({N:,} positions), {what} L2, "
                  f"in turns (old, new, new, old, library): "
                  + ", ".join(f"{v:.4f}" for v in (
                      t["old"][0], t["new"][0], t["new"][1], t["old"][1],
                      t["library"][0]))
                  + f" ms; new / index_select "
                  f"{best['new'] / best['library']:.4f}, old / new "
                  f"{best['old'] / best['new']:.4f}; of the bound "
                  f"{b_ms:.4f} ms: new {b_ms / best['new']:.1%}, old "
                  f"{b_ms / best['old']:.1%}, index_select "
                  f"{b_ms / best['library']:.1%}", flush=True)
        flat = FlatGatherEngine(op)
        if not torch.equal(flat(x), est(x)):
            fail(f"{label}: the composed apply with the first gather is not "
                 "bitwise the kernel's")
        apply_ms = {"old": [], "new": []}
        for name, m in (("old", flat), ("new", est), ("new", est),
                        ("old", flat)):
            apply_ms[name].append(time_ms(lambda m=m: m(x), 20))
        step_ms, finals = {"old": [], "new": []}, {}
        # each stiffness module with solvers of its own (a new stiffness
        # module drops the model's), captured before the turns
        solvers = {m: timestepping.SolverCache() for m in (flat, est)}
        for m in (flat, est):
            model.stiffness = m
            model._solvers = solvers[m]
            model.solve(state, dt_, 50)
        for name, m in (("old", flat), ("new", est), ("new", est),
                        ("old", flat)):
            model.stiffness = m
            model._solvers = solvers[m]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            finals[name] = model.solve(state, dt_, 50)[0].u
            end.record()
            end.synchronize()
            step_ms[name].append(start.elapsed_time(end) / 50)
        model.stiffness = est
        same = torch.equal(finals["old"], finals["new"])
        print(f"   {smi}: {label} composed apply, old gather / new, in turns:"
              f" {apply_ms['old'][0]:.4f} / {apply_ms['new'][0]:.4f} / "
              f"{apply_ms['new'][1]:.4f} / {apply_ms['old'][1]:.4f} ms; "
              f"steady ms/step over 50 steps {step_ms['old'][0]:.4f} / "
              f"{step_ms['new'][0]:.4f} / {step_ms['new'][1]:.4f} / "
              f"{step_ms['old'][1]:.4f}; the 50 steps "
              f"{'bitwise equal' if same else 'NOT bitwise equal'}",
              flush=True)
        if not same:
            fail(f"{label}: 50 steps with the first gather differ from the "
                 "kernel's")
        return warm, n_flat

    def bodyfit_build(argv, label, pb=None):
        """Build a bodyfit bowl through the demo (on the problem `pb`, or
        a new import), check that it imported as a general mesh on the
        indexed kernel, and hold the kernel against its plain version on
        one unit-normal input (two for a pair model).  Returns (model, dt,
        steps, focus, plain module, kernel entry for the JSON line,
        problem)."""
        args = nonlinear_bowl.parser().parse_args(argv)
        t0 = time.perf_counter()
        pb = nonlinear_bowl.problem(args) if pb is None else pb
        model, dt, nsteps, focus = nonlinear_bowl.build(args, pb)
        mesh, kst = model.mesh, model.stiffness
        print(f"   host set-up (mapping, export, import with "
              f"locality_order, geometry, colouring, upload) "
              f"{time.perf_counter() - t0:.1f} s; {mesh.num_cells} cells, "
              f"{mesh.ndofs} DOF, {type(mesh).__name__}, "
              f"{kst.scatter_summary()}, dt {dt:.6e} s, "
              f"{nsteps} steps", flush=True)
        if isinstance(mesh, ExtrudedHexMesh) or not isinstance(
                kst, IndexedStiffness) or kst.impl != "cuda":
            fail(f"{label}: not a general mesh on the indexed kernel")
        pst = IndexedStiffness(kst.cell_op, "mm")
        xs = [torch.as_tensor(rng.standard_normal(mesh.ndofs),
                              dtype=torch.float32, device=dev)
              for _ in range(2 if kst.is_pair else 1)]
        run = (lambda m: m.pair(*xs)) if kst.is_pair else \
            (lambda m: m(xs[0]))
        yk, yp = run(kst), run(pst)
        err = rel_l2(yk, yp)
        if not err <= F32_TOL:
            fail(f"{label}: indexed kernel vs plain {err:.3e} > {F32_TOL}")
        entry = dict(max_abs_err=float((yk - yp).abs().max()), rel_l2=err,
                     ms=time_ms(lambda: run(kst), 20),
                     plain_ms=time_ms(lambda: run(pst), 10),
                     cost=apply_cost(kst.G, mesh.ndofs, len(xs),
                                     extra=kst.dofmap.numel() * 4))
        print(f"   {smi}: {label} at {mesh.num_cells} cells: {entry}",
              flush=True)
        return model, dt, nsteps, focus, pst, entry, pb

    def ten_steps(model, pst, dt, label):
        """10 RK4 steps from one state on the kernel, then on the plain
        version."""
        kst = model.stiffness
        s0 = model.init_state()
        sk, _ = model.solve(s0, dt, 10)
        model.stiffness = pst
        sp, _ = model.solve(s0, dt, 10)
        model.stiffness = kst
        traj = rel_l2(sk.u, sp.u)
        print(f"   10 steps kernel vs plain: rel-l2(u) {traj:.3e} "
              f"(tol {TRAJ_TOL}), max |u| {float(sk.u.abs().max()):.4e}")
        if not traj <= TRAJ_TOL:
            fail(f"{label}: 10-step trajectory kernel vs plain {traj:.3e}")

    with phase("13a bodyfit bowl build + indexed kernel vs plain"):
        args5_argv = ["--elements", "64", "--degree", "4", "--geometry",
                      "bodyfit"]
        bbowl, dt5, nsteps5, focus5, pst5, kernels["indexed"], pb13 = \
            bodyfit_build(args5_argv, "bodyfit bowl")
        bdisc5 = bbowl.disc             # for phase 28
        if (bbowl.mesh.num_cells, bbowl.mesh.ndofs) != (102400, 6661697):
            fail(f"bodyfit bowl structure {bbowl.mesh.num_cells} cells, "
                 f"{bbowl.mesh.ndofs} DOF")
        ten_steps(bbowl, pst5, dt5, "bodyfit bowl")
        keep_for_ranks("22e bodyfit bowl, 4 ranks, indexed", bbowl, dt5, 20,
                       BOWL_POINTS, impl="indexed")
        keep_for_ranks("22e bodyfit bowl, 4 ranks, indexed_engine", bbowl,
                       dt5, 20, BOWL_POINTS, impl="indexed_engine",
                       like="22e bodyfit bowl, 4 ranks, indexed")

    with phase("33d bodyfit bowl set-up before and after; the set-up "
               "kernels vs plain (the mass diagonal through the inverse "
               "map)"):
        args33 = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "4", "--geometry", "bodyfit"])
        a33, b33, l33 = setup_turn("bodyfit bowl",
                                   lambda sd: bowl_model(pb13, args33, sd))
        kernels.update(setup_check("bodyfit bowl", a33, b33, pb13.absorbing,
                                   l33))
        del a33, b33

    ci.reset_launches()
    with phase("13b bodyfit bowl full solve (indexed kernel)"):
        args5 = nonlinear_bowl.parser().parse_args(args5_argv)
        state = run_demo(bbowl, dt5, nsteps5, args5, "nonlinear_bowl")
        n_idx = ci.launches["indexed"]
        p_body = nonlinear_bowl.focal_pressure(bbowl, state, focus5)
        print(f"pressure at focus: {p_body:.1f} Pa")
        ratio = p_body / p_focus
        print(f"   indexed launches {n_idx} for {nsteps5} steps; focal "
              f"pressure / conformal ({p_focus:.1f} Pa) = {ratio:.6f} "
              f"(gate {BODYFIT_RATIO})")
        if n_idx != 4 * nsteps5 or ci.launches["indexed_pair"] != 0:
            fail(f"bodyfit launches {dict(ci.launches)} != 4 x {nsteps5}")
        if not bool(torch.isfinite(state.u).all()):
            fail("bodyfit bowl field is not finite")
        if not BODYFIT_RATIO[0] <= ratio <= BODYFIT_RATIO[1]:
            fail(f"bodyfit / conformal focal pressure {ratio:.4f} outside "
                 f"{BODYFIT_RATIO}")
        del state
    with phase(f"13c bodyfit bowl, the first {PLAIN_DEPTH} steps on the plain "
               "version against the kernel"):
        kst5 = bbowl.stiffness
        sk, _ = bbowl.solve(bbowl.init_state(), dt5, PLAIN_DEPTH)
        bbowl.stiffness = pst5
        sp, _ = bbowl.solve(bbowl.init_state(), dt5, PLAIN_DEPTH)
        bbowl.stiffness = kst5
        agree = rel_l2(sk.u, sp.u)
        print(f"   {PLAIN_DEPTH} of {nsteps5} steps, kernel vs plain: rel-l2(u) "
              f"{agree:.3e} (tol {FOCAL_AGREE}), max |u| "
              f"{float(sp.u.abs().max()):.4e}")
        if not agree <= FOCAL_AGREE:
            fail(f"bodyfit {PLAIN_DEPTH} steps kernel vs plain {agree:.3e}")
        del sk, sp, pst5

    with phase("34e bodyfit bowl in bf16: #11 and its pair form vs plain, "
               "50 steps each, ms a step beside float32's"):
        bfit16, dt34f, _, _, _, kernels["indexed_bf16"] = bf16_model(
            "bodyfit bowl", args5_argv, pb13)
        _, bf16_counts["indexed_bf16"] = bf16_steps(bfit16, dt34f, 50,
                                                    "bodyfit bowl")
        bfit16b, dt34g, _, _, _, kernels["indexed_pair_bf16"] = bf16_model(
            "two-layer bodyfit bowl", args5_argv + ["--two-layer"], pb13)
        _, bf16_counts["indexed_pair_bf16"] = bf16_steps(
            bfit16b, dt34g, 50, "two-layer bodyfit bowl")
        turns = ms_turns([("f32", bbowl, dt5), ("bf16", bfit16, dt34f),
                          ("bf16 pair", bfit16b, dt34g)])
        print(f"   {smi}: ms a step (50 steps from rest, in turns): "
              f"float32 {turns['f32']:.4f}, bf16 {turns['bf16']:.4f}, bf16 "
              f"two-layer {turns['bf16 pair']:.4f}; #11 ms an apply: "
              f"float32 (13a) {kernels['indexed']['ms']:.4f}, bf16 "
              f"{kernels['indexed_bf16']['ms']:.4f}", flush=True)
        del bfit16, bfit16b

    ci.reset_launches()
    with phase("30g bodyfit bowl on #11: exact restart, full-GLL "
               "unstructured VTK"):
        _, s20 = restart_check(bbowl, dt5, 10, "bodyfit")
        n_g = ci.launches["indexed"]
        t0 = time.perf_counter()
        vpath = fio.write_vtk_unstructured(str(IO / "bodyfit"), bbowl.mesh,
                                           {"u": s20.u, "v": s20.v})
        t_v = time.perf_counter() - t0
        nsub = fio.vtk_cells(bbowl.mesh).shape[0]
        mb = megabytes(vpath)
        print(f"   indexed launches {n_g} for 30 steps; full-GLL VTK "
              f"{nsub} sub-hexes, {mb:.1f} MB in {t_v:.2f} s, cells "
              f"included ({mb / t_v:.1f} MB/s, host clock; {smi})")
        if n_g != 4 * 30 or nsub != bbowl.mesh.num_cells * 64:
            fail(f"phase 30g: launches {n_g} != 120 or {nsub} sub-hexes")
        Path(vpath).unlink()
        bbowl.mesh.__dict__.pop("_vtk_cells")
        del s20

    def engine16_kernels(model, label):
        """The bf16 engine model's kernels at this size: each against its
        plain version on the same bf16 inputs (the gathers bitwise, the
        rest <= BF16_TOL) and timed, with its least bytes in stored types
        (``profile_step.engine_bytes``) and float32 operations; the
        composed apply (bound: the apply's minimum, as #11's) against its
        plain version, repeated bitwise, and against bf16 #11 on the same
        buffers (<= BF16_G_TOL), timed in the same run.  Returns the
        entries for the JSON line."""
        est = model.stiffness
        op, ndofs = est.cell_op, model.mesh.ndofs
        if not isinstance(est, EngineStiffness) or est.impl != "cuda" or \
                op.G.dtype != BF16 or est.kernel != "engine_bf16":
            fail(f"34: {label}: not the bf16 engine ({est.kernel})")
        p16 = cen.to_plain(op)
        n, cells = op.P + 1, op.dofmap.shape[0]
        gb, cb, sb = profile_step.engine_bytes(op)
        flops = cells * n ** 3 * (12 * n + 16 + (3 if est.is_pair else 0))
        xs = [torch.as_tensor(rng16.standard_normal(ndofs), device=dev).to(
            BF16) for _ in range(2 if est.is_pair else 1)]
        out = {}

        def entry(name, yk, yp, run, run_plain, cost, library=None,
                  tol=BF16_TOL):
            err = rel_l2(yk, yp)
            if not err <= tol:
                fail(f"34: {label}: {name} vs plain {err:.3e} > {tol}")
            out[name] = dict(
                max_abs_err=float((yk.float() - yp.float()).abs().max()),
                rel_l2=err, ms=time_ms(run, 20), plain_ms=time_ms(run_plain,
                                                                  10),
                cost=cost, library_ms=None if library is None
                else time_ms(library, 20))

        if est.is_pair:
            u1, u2 = cen.gather2(op, *xs)
            entry("engine_gather2_bf16",
                  torch.cat([u1.reshape(-1), u2.reshape(-1)]),
                  torch.cat(list(eng.gather2(*xs, p16.g))),
                  lambda: cen.gather2(op, *xs),
                  lambda: eng.gather2(*xs, p16.g), (gb, 0), tol=0.0)
            merge_gather2_turns(out, op, xs, label)
            yk = cen.contract(op, u1, u2)
            plain_c = lambda: eng.dense_contract(
                eng.fold(u1, p16.c1, u2, p16.c2), p16.G6, p16.D)
            entry("engine_contract_bf16", yk, plain_c(),
                  lambda: cen.contract(op, u1, u2), plain_c, (cb, flops))
        else:
            u1 = cen.gather(op, xs[0])
            entry("engine_gather_bf16", u1.reshape(-1),
                  eng.gather(xs[0], p16.g), lambda: cen.gather(op, xs[0]),
                  lambda: eng.gather(xs[0], p16.g), (gb, 0),
                  library=lambda: xs[0].index_select(0, p16.g), tol=0.0)
            yk = cen.contract(op, u1)
            plain_c = lambda: eng.dense_contract(u1, p16.G6, p16.D,
                                                 p16.coeff)
            entry("engine_contract_bf16", yk, plain_c(),
                  lambda: cen.contract(op, u1), plain_c, (cb, flops))
        plain_s = lambda: eng.scatter_add(yk, p16.g, ndofs)
        entry("engine_scatter_bf16", cen.scatter(op, yk), plain_s(),
              lambda: cen.scatter(op, yk), plain_s, (sb, 0))
        # index_add_ on bf16 values accumulates in bf16: not the scatter's
        # function (float32 sums rounded once), so its time stands apart
        add_ms = time_ms(lambda: torch.zeros(ndofs, dtype=BF16, device=dev)
                         .index_add_(0, p16.g, yk.reshape(-1)), 20)
        # #9 and #10 against their first designs (kept as the comparison)
        # on the same buffers, in turns (old, new, new, old); #9 in COEFF
        # mode too (a seeded per-cell coefficient) where the model is single
        us = (u1, u2) if est.is_pair else (u1,)
        yo, yso = cen.contract_cells(op, *us), cen.scatter_dofs(op, yk)
        differ = int((yk != yo).sum())
        if differ > yk.numel() // 100 or not rel_l2(yk, yo) <= \
                FIRST_DESIGN_TOL or not torch.equal(yso,
                                                    cen.scatter(op, yk)):
            fail(f"34: {label}: #9 differs from its first design in "
                 f"{differ} values (rel-l2 {rel_l2(yk, yo):.3e}), or #10 "
                 f"not bitwise its first design's")
        designs = {
            "contract": (lambda: cen.contract(op, *us),
                         lambda: cen.contract_cells(op, *us)),
            "scatter": (lambda: cen.scatter(op, yk),
                        lambda: cen.scatter_dofs(op, yk))}
        if not est.is_pair:
            cop = op._replace(coeff=torch.as_tensor(
                rng16.uniform(0.5, 2.0, cells), device=dev).to(BF16))
            designs["contract COEFF"] = (lambda: cen.contract(cop, u1),
                                         lambda: cen.contract_cells(cop, u1))
        for k in cen.comparison_launches:
            cen.comparison_launches[k] = 0
        turns = {k: {"new": [], "old": []} for k in designs}
        for k, (new, old) in designs.items():
            for which in ("old", "new", "new", "old"):
                turns[k][which].append(time_ms(new if which == "new"
                                               else old, 20))
        for (name, k), (oname, err) in zip(
                (("engine_contract_bf16", "contract"),
                 ("engine_scatter_bf16", "scatter")),
                (("engine_contract_cells_bf16", plain_c() - yo.float()),
                 ("engine_scatter_dofs_bf16", plain_s().float() -
                  yso.float()))):
            out[name].update(ms=min(turns[k]["new"]), turns=turns[k])
            out[oname] = dict(out[name], ms=min(turns[k]["old"]),
                              max_abs_err=float(err.abs().max()),
                              launches=cen.comparison_launches[oname])
        b9, b10 = bound(*out["engine_contract_bf16"]["cost"])[0], \
            bound(*out["engine_scatter_bf16"]["cost"])[0]
        mode, card = cen._MODES[op.mode], u1.get_device()
        bps = launch.contract_occupancy(card, op.P, mode)
        smem = launch.entry("fustpu_engine_contract_bf16_smem")(op.P, mode)
        grid = launch.contract_blocks(cells, op.P, bps, launch.sm_count(card))
        print(f"   {label}: #9 in bf16 (mode {op.mode}): "
              f"{launch.CONTRACT_CELLS[op.P]} cells a chunk, {smem} B of "
              f"shared memory a block, {bps} blocks an SM, grid {grid}; "
              f"#10: {launch.scatter_blocks(ndofs)} blocks of "
              f"{launch.SCATTER_DOFS} dofs", flush=True)
        print(f"   {smi}: {label}: #9 and #10 in bf16, redesigned (new) "
              f"against the first designs (old), ms in turns (old, new, "
              f"new, old): " + "; ".join(
                  f"{k} old {t['old'][0]:.4f} / {t['old'][1]:.4f}, new "
                  f"{t['new'][0]:.4f} / {t['new'][1]:.4f} (new "
                  f"{(b10 if k == 'scatter' else b9) / min(t['new']):.1%}"
                  f" of the bound, old "
                  f"{(b10 if k == 'scatter' else b9) / min(t['old']):.1%})"
                  for k, t in turns.items())
              + f"; #9 differs from its first design in {differ} of "
              f"{yk.numel()} values; #10 bitwise", flush=True)
        run = (lambda m: m.pair(*xs)) if est.is_pair else (lambda m: m(xs[0]))
        pst = EngineStiffness(op, "mm")
        y = run(est)
        if not torch.equal(run(est), y):
            fail(f"34: {label}: two bf16 engine applies differ")
        entry("engine_bf16", y, run(pst), lambda: run(est), lambda: run(pst),
              (apply_cost(op.G, ndofs, len(xs), extra=op.dofmap.numel() * 4)[
                  0], flops))
        iop = cen.to_indexed(op, model.disc.chunk_plan)
        on11 = (lambda: ci.indexed_pair(iop, *xs)) if est.is_pair else \
            (lambda: ci.indexed(iop, xs[0]))
        e11, ms11 = rel_l2(y, on11()), time_ms(on11, 20)
        for name, k in out.items():
            print(f"   {smi}: {label} {name}: {k}", flush=True)
        print(f"   {smi}: {label} at {cells} cells: the composed "
              f"bf16 engine {out['engine_bf16']['ms']:.4f} ms per apply vs "
              f"bf16 #11 on the same buffers {ms11:.4f} ms (same run), "
              f"rel-l2 {e11:.3e} (tol {BF16_G_TOL}); index_add_ on bf16 "
              f"(bf16 sums, not the same function) {add_ms:.4f} ms",
              flush=True)
        if not e11 <= BF16_G_TOL:
            fail(f"34: {label}: bf16 engine vs bf16 #11 {e11:.3e}")
        out["engine_bf16"]["indexed_ms"] = ms11
        return out

    class FirstDesigns:
        """`model` (a bf16 engine model) with the first designs of #9 and
        #10, the comparison kernels, in place of the redesigned ones while
        it solves: the same buffers and the same gather, for steps in
        turns."""

        def __init__(self, model):
            self.model = model
            # its own captured solvers: the graphs hold the kernels that
            # ran at their capture (the model's hold the redesigned ones)
            self.solvers = timestepping.SolverCache()

        def init_state(self):
            return self.model.init_state()

        def solve(self, *args):
            keep = cen.contract, cen.scatter
            theirs = self.model.__dict__.get("_solvers")
            self.model._solvers = self.solvers
            cen.contract, cen.scatter = cen.contract_cells, cen.scatter_dofs
            try:
                return self.model.solve(*args)
            finally:
                cen.contract, cen.scatter = keep
                if theirs is None:
                    self.model.__dict__.pop("_solvers")
                else:
                    self.model._solvers = theirs

    def engine16_steps(model, dt_, steps, label):
        """`steps` RK4 steps of a bf16 engine model from rest, the engine's
        counters reset just before and read just after: each of its three
        bf16 kernels 4 a step and nothing else, the state finite and
        non-zero.  Returns (state, launches by kernel)."""
        want = {k: 4 * steps for k in model.stiffness.kernels}
        cen.reset_launches()
        st, _ = model.solve(model.init_state(), dt_, steps)
        torch.cuda.synchronize()
        got = {k: v for k, v in {**cen.launches, **cen.bf16_launches}.items()
               if v}
        print(f"   {label}: {steps} bf16 engine steps, launches {got}, max "
              f"|u| {float(st.u.abs().max()):.4e}", flush=True)
        if got != want:
            fail(f"34: {label}: launches {got} != {want}")
        if not bool(torch.isfinite(st.u).all()) or \
                float(st.u.abs().max()) == 0.0:
            fail(f"34: {label}: the bf16 field is not finite and non-zero")
        return st, got

    def engine16_bowl(label, argv, pb, f32_model, dt_f32):
        """Phase 34k: the bowl of `argv` on the engine in bf16 on the
        problem `pb`, beside the float32 engine model `f32_model` and a
        bf16 #11 model of the same bowl: the kernels against their plain
        versions and timed; 10 steps kernel vs plain and vs bf16 #11 <=
        BF16_TRAJ_TOL; 50 steps counted; ms a step in turns (the bf16
        engine, the float32 engine, bf16 #11); the device bytes of each
        model and of a 10-step solve.  Returns (kernel entries,
        launches)."""
        args_ = nonlinear_bowl.parser().parse_args(
            argv + ENGINE + ["--dtype", "bf16"])
        t0 = time.perf_counter()
        m16, dt_, _, _ = nonlinear_bowl.build(args_, pb)
        print(f"   {label}: the bf16 engine model built in "
              f"{time.perf_counter() - t0:.1f} s on the earlier import",
              flush=True)
        b16 = bf16_model(f"{label} (#11)", argv, pb)[0]
        entries = engine16_kernels(m16, label)
        s0 = m16.init_state()
        sk = m16.solve(s0, dt_, 10)[0]
        kst = m16.stiffness
        m16.stiffness = EngineStiffness(kst.cell_op, "mm")
        sp = m16.solve(s0, dt_, 10)[0]
        m16.stiffness = kst
        s11 = b16.solve(b16.init_state(), dt_, 10)[0]
        first = FirstDesigns(m16)
        s_first = first.solve(s0, dt_, 10)[0]
        e_plain, e11 = rel_l2(sk.u, sp.u), rel_l2(sk.u, s11.u)
        e_first = rel_l2(sk.u, s_first.u)
        print(f"   {label}: 10 bf16 steps, engine vs plain rel-l2(u) "
              f"{e_plain:.3e}, vs bf16 #11 {e11:.3e} (tol {BF16_TRAJ_TOL}); "
              f"vs the first designs of #9 / #10 "
              f"{'bitwise' if torch.equal(sk.u, s_first.u) else e_first}; "
              f"max |u| {float(sk.u.abs().max()):.4e}", flush=True)
        if not (e_plain <= BF16_TRAJ_TOL and e11 <= BF16_TRAJ_TOL
                and e_first <= BF16_TRAJ_TOL):
            fail(f"34k: {label}: 10 steps vs plain {e_plain:.3e}, vs bf16 "
                 f"#11 {e11:.3e}, vs the first designs {e_first:.3e}")
        _, counts = engine16_steps(m16, dt_, 50, label)
        if not m16.stiffness.is_pair:
            # phase 35b: the captured solve on the bf16 engine
            print(f"== 35b {label} on the bf16 engine: the RK4 solve as "
                  f"captured CUDA graphs against eager launches", flush=True)
            captured_solve(m16, dt_, f"{label} (bf16 engine)",
                           BF16_TRAJ_TOL)
        turns = ms_turns([("bf16 engine", m16, dt_),
                          ("bf16 engine, first #9 / #10", first, dt_),
                          ("float32 engine", f32_model, dt_f32),
                          ("bf16 #11", b16, dt_)])
        print(f"   {smi}: {label} ms a step (50 steps from rest, in turns, "
              f"host clock): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in turns.items()), flush=True)
        mem = {"bf16 engine": (held_bytes(m16), solve_peak(m16, dt_, 10)),
               "float32 engine": (held_bytes(f32_model),
                                  solve_peak(f32_model, dt_f32, 10)),
               "bf16 #11": (held_bytes(b16), solve_peak(b16, dt_, 10))}
        print(f"   {smi}: {label} device bytes (the model holds, a 10-step "
              f"solve adds): " + ", ".join(
                  f"{k} {h / 1e9:.4f} GB + {a / 1e9:.4f} GB"
                  for k, (h, a) in mem.items()), flush=True)
        del b16, m16
        return entries, counts

    ENGINE = ["--stiffness-impl", "indexed_engine"]
    with phase("21a bodyfit bowl on the engine: build, each kernel vs plain "
               "and timed, the composed apply vs the indexed kernel, 10 "
               "steps vs the indexed model"):
        t0 = time.perf_counter()
        ebowl, dt15, nsteps15, _ = nonlinear_bowl.build(
            nonlinear_bowl.parser().parse_args(args5_argv + ENGINE), pb13)
        print(f"   host set-up on phase 13a's import (geometry, inverse "
              f"map, upload) {time.perf_counter() - t0:.1f} s", flush=True)
        if not isinstance(ebowl.stiffness, EngineStiffness) or \
                ebowl.stiffness.impl != "cuda" or (dt15, nsteps15) != \
                (dt5, nsteps5):
            fail("bodyfit engine model: not the engine kernels on the card")
        kernels.update(engine_kernels(ebowl, kst5, "bodyfit bowl"))
        s0 = bbowl.init_state()
        s10 = ebowl.solve(s0, dt5, 10)[0]
        traj = rel_l2(s10.u, bbowl.solve(s0, dt5, 10)[0].u)
        print(f"   10 steps engine vs indexed model: rel-l2(u) {traj:.3e} "
              f"(tol {TRAJ_TOL})")
        if not traj <= TRAJ_TOL:
            fail(f"bodyfit 10 steps engine vs indexed {traj:.3e}")
        del bbowl, kst5
        bmesh = ebowl.mesh              # for phase 32f-h
        # the gather's kernel against its first design and index_select
        warm, n_flat = gather_turns(ebowl, s10, dt5, "bodyfit bowl")
        kernels["engine_gather_flat"] = dict(
            kernels["engine_gather"], ms=min(warm["old"]),
            library_ms=warm["library"][0])
        kernels["engine_gather"].update(ms=min(warm["new"]),
                                        library_ms=warm["library"][0])
        del s10
    cen.reset_launches()
    with phase("21b bodyfit bowl on the engine, full solve"):
        state = run_demo(ebowl, dt5, nsteps5, args5, "nonlinear_bowl")
        n_eng = dict(cen.launches)
        p_eng = nonlinear_bowl.focal_pressure(ebowl, state, focus5)
        agree = abs(p_eng - p_body) / abs(p_body)
        staged = sum(n_eng[k] for k in STAGED)
        print(f"pressure at focus: {p_eng:.1f} Pa")
        print(f"   engine launches {n_eng} for {nsteps5} steps ({staged} "
              f"kernel launches); focal pressure vs the indexed kernel "
              f"({p_body:.1f} Pa): relative difference {agree:.3e} (tol "
              f"{FOCAL_AGREE})")
        if any(n_eng[k] != 4 * nsteps5 for k in STAGED) or \
                n_eng["engine_gather2"] != 0:
            fail(f"bodyfit engine launches {n_eng} != 12 x {nsteps5}")
        if not bool(torch.isfinite(state.u).all()):
            fail("bodyfit engine field is not finite")
        if not agree <= FOCAL_AGREE:
            fail(f"bodyfit engine vs indexed focal pressure {agree:.3e}")
        del state
    with phase("34k bodyfit bowl on the engine in bf16: build, each kernel "
               "vs plain and timed, 10 steps vs plain and vs bf16 #11, 50 "
               "steps, ms a step in turns, device bytes"):
        k34k, n34k = engine16_bowl("bodyfit bowl", args5_argv, pb13, ebowl,
                                   dt5)
        kernels.update(k34k)
        del ebowl
        # the bf16 engine's rank case: two-layer Westervelt on a 1 cm 12^3
        # P=4 perturbed box read as a shuffled general mesh (the pair form)
        gmesh = from_box(build_box_mesh((12, 12, 12), 4, hi=(0.01,) * 3,
                                        perturb=0.1, seed=5), shuffle_seed=7)
        ext = gmesh.boundary_facets()
        xc = gmesh.facet_centroids(ext)[:, 0]
        deep = gmesh.cell_corners_flat.mean(axis=1)[:, 0] >= 0.005
        g16 = WesterveltModel(
            gmesh, Material(sound_speed=np.where(deep, 1560.0, 1500.0),
                            density=np.where(deep, 1045.0, 1000.0),
                            nonlinearity=3.5, attenuation_dB=0.3),
            Source(frequency=0.5e6, amplitude=1e5), ext[xc < 1e-9],
            ext[xc >= 1e-9], dtype=BF16, device=dev,
            stiffness_impl="indexed_engine")
        if g16.stiffness.kernels != ("engine_gather2_bf16",
                                     "engine_contract_bf16",
                                     "engine_scatter_bf16"):
            fail(f"34k: the rank case's model runs {g16.stiffness.kernels}")
        keep_for_ranks("22e two-layer general box, 4 ranks, indexed_engine, "
                       "bf16", g16, g16.cfl_dt(0.4)[0], 20,
                       np.array([[0.0003, 0.0052, 0.0047]]),
                       impl="indexed_engine", ref_tol=BF16_TRAJ_TOL)
        del g16, gmesh
    # ---- phase 32f-h: the three engine demos on phase 13a's bodyfit bowl
    # ---- (no new import); counters reset just before, read just after ----
    cen.reset_launches()
    ci.reset_launches()
    with phase("32f exp_engine_mesh on the bodyfit bowl (P=4, f32): the "
               "engine's gather, scatter and apply, #11, index_select and "
               "index_add_"):
        em = exp_engine_mesh.run(bmesh, torch.float32, dev)
        torch.cuda.synchronize()
        got = {**cen.launches, **ci.launches}
        print(f"   {smi}: launches {got}")
        if not em["rel"] <= F32_TOL:
            fail(f"32f: the engine apply vs #11 {em['rel']:.3e}")
        if not all(got[k] for k in STAGED + ("indexed",)):
            fail(f"32f: a kernel was not launched: {got}")
        del em
    cen.reset_launches()
    ci.reset_launches()
    with phase("32g exp_indexed_pair on the bodyfit bowl: the pair against "
               "two singles on the engine and on #11"):
        ip = exp_indexed_pair.run(bmesh, torch.float32, dev)
        torch.cuda.synchronize()
        got = {**cen.launches, **ci.launches}
        print(f"   {smi}: launches {got}")
        for route, r in ip.items():
            if not r["rel"] <= F32_TOL:
                fail(f"32g: {route} pair vs two singles {r['rel']:.3e}")
        if not all(got.values()):
            fail(f"32g: a kernel was not launched: {got}")
        del ip
    cen.reset_launches()
    ci.reset_launches()
    with phase("32h exp_sharded_engine on the bodyfit bowl, k = 2 and 4: "
               "each part's pair alone against the one-device pair"):
        sh_ = exp_sharded_engine.run(bmesh, [2, 4], torch.float32, dev)
        torch.cuda.synchronize()
        got = {k: v for k, v in {**cen.launches, **ci.launches}.items() if v}
        print(f"   {smi}: launches {got}")
        for k in (2, 4):
            for route, r in sh_[k].items():
                if not r["rel"] <= F32_TOL:
                    fail(f"32h: k={k} {route} parts vs one device "
                         f"{r['rel']:.3e}")
        if not all(got.get(k) for k in ("engine_gather2", "engine_contract",
                                         "engine_scatter", "indexed_pair")):
            fail(f"32h: a kernel was not launched: {got}")
        del sh_, bmesh
        torch.cuda.empty_cache()
    # every 4-rank case in one process group: rank start-up paid once
    halo_names = ["22g halo box, grid (4, 1, 1), exchange on",
                  "22g halo box, grid (4, 1, 1), exchange off"]
    res22 = ranks_group(["22a flagship, grid (2, 2, 1)",
                 "22b two-layer flagship, grid (2, 2, 1)",
                 "22c flagship in corner mode, grid (2, 2, 1)",
                 "22d imported bowl, 4 ranks",
                 "22e bodyfit bowl, 4 ranks, indexed",
                 "22e bodyfit bowl, 4 ranks, indexed_engine",
                 "22e two-layer general box, 4 ranks, indexed_engine, bf16"]
                        + halo_names, 4, "gloo")
    with phase("22g time_halo: the 16^3 P=4 box on 4 gloo ranks sharing the "
               "card, with and without the exchange"):
        on, off = res22[0][-2], res22[0][-1]
        print(f"   {smi} (4 ranks sharing one card over gloo; not a "
              f"multi-card speed):")
        time_halo.report(on["ms_per_step"], off["ms_per_step"])
        differ = rel_l2(torch.as_tensor(off["u"]), torch.as_tensor(on["u"]))
        print(f"   u without the exchange vs with it: rel-l2 {differ:.3e} "
              f"(20 steps from rest: the wave has not reached the cuts)")
        if not differ > 0.0:
            fail("22g: u without the exchange equals u with it")
    with phase("30f the flagship's per-rank snapshots (22a, 4 gloo ranks) "
               "reassembled"):
        t0 = time.perf_counter()
        full = dist_io.assemble_snapshot(str(IO / "ranks"), "u_000050")
        t_asm = time.perf_counter() - t0
        files = sorted((IO / "ranks").glob("u_000050.d*.npy"))
        same = np.array_equal(full, res22[0][0]["u"])
        print(f"   {len(files)} rank files, {sum(map(megabytes, files)):.1f} "
              f"MB, reassembled {full.shape} in {t_asm:.3f} s (host "
              f"clock): {'bitwise equal' if same else 'NOT equal'} to "
              f"collect()")
        if len(files) != 4 or not same:
            fail("phase 30f: the reassembled per-rank snapshot is not "
                 "collect()'s field")
    ranks_group(["22f flagship on nccl, world size 1"], 1, "nccl")

    with phase("14a two-layer bodyfit bowl build + pair kernel vs plain"):
        bbowl2, dt6, _, _, pst6, kernels["indexed_pair"], _ = bodyfit_build(
            args5_argv + ["--two-layer"], "two-layer bodyfit bowl", pb13)
        if not bbowl2.stiffness.is_pair:
            fail("two-layer bodyfit model did not build the pair operator")
        del pst6
    ci.reset_launches()
    with phase("14b two-layer bodyfit bowl, 50 steps (indexed pair kernel)"):
        s6, _ = bbowl2.solve(bbowl2.init_state(), dt6, 50)
        torch.cuda.synchronize()
        n_idx_pair = ci.launches["indexed_pair"]
        print(f"   indexed pair launches {n_idx_pair}, max |u| "
              f"{float(s6.u.abs().max()):.4e}")
        if n_idx_pair != 4 * 50 or ci.launches["indexed"] != 0:
            fail(f"launches {dict(ci.launches)} after the two-layer "
                 "bodyfit run")
        if not bool(torch.isfinite(s6.u).all()) or \
                float(s6.u.abs().max()) == 0.0:
            fail("two-layer bodyfit field is not finite and non-zero")

    with phase("21c two-layer bodyfit bowl on the engine: build, kernels vs "
               "plain and vs the indexed pair kernel"):
        ebowl2, dt16, _, _ = nonlinear_bowl.build(
            nonlinear_bowl.parser().parse_args(
                args5_argv + ["--two-layer"] + ENGINE), pb13)
        if not ebowl2.stiffness.is_pair or dt16 != dt6:
            fail("two-layer bodyfit engine model did not build the pair "
                 "operator")
        k21c = engine_kernels(ebowl2, bbowl2.stiffness,
                              "two-layer bodyfit bowl")
        for k in ("engine_gather2", "engine_gather2_flat"):
            kernels[k] = k21c[k]
        del bbowl2
    cen.reset_launches()
    with phase("21c two-layer bodyfit bowl on the engine, 50 steps "
               "(gather2)"):
        s16, _ = ebowl2.solve(ebowl2.init_state(), dt16, 50)
        torch.cuda.synchronize()
        n_eng2 = dict(cen.launches)
        traj = rel_l2(s16.u, s6.u)
        print(f"   engine launches {n_eng2}; vs the indexed pair kernel's "
              f"50 steps rel-l2(u) {traj:.3e} (tol {TRAJ_TOL})")
        if any(n_eng2[k] != 4 * 50
               for k in ("engine_gather2",) + STAGED[1:]) or \
                n_eng2["engine_gather"] != 0:
            fail(f"launches {n_eng2} after the two-layer engine run")
        if not traj <= TRAJ_TOL:
            fail(f"two-layer engine vs indexed 50 steps {traj:.3e}")
        del s6, s16
    with phase("34k two-layer bodyfit bowl on the engine in bf16 (pair): "
               "build, kernels vs plain, 10 steps vs plain and vs bf16 #11 "
               "pair, 50 steps, ms a step in turns"):
        k34kb, n34kb = engine16_bowl(
            "two-layer bodyfit bowl", args5_argv + ["--two-layer"], pb13,
            ebowl2, dt16)
        for k in ("engine_gather2_bf16", "engine_gather2_flat_bf16"):
            kernels[k] = k34kb[k]
        del ebowl2, pb13

    with phase("15a bodyfit bowl at P=6 build + kernel vs plain"):
        P6 = ["--elements", "48", "--degree", "6", "--geometry", "bodyfit"]
        bbowl7, dt7, nsteps7, focus7, pst7, k7, pb15 = bodyfit_build(
            P6, "P=6 bodyfit bowl")
        bdisc7 = bbowl7.disc            # for phase 28
        if (bbowl7.mesh.num_cells, bbowl7.mesh.ndofs) != (49152, 10764961):
            fail(f"P=6 bodyfit structure {bbowl7.mesh.num_cells} cells, "
                 f"{bbowl7.mesh.ndofs} DOF")
        ten_steps(bbowl7, pst7, dt7, "P=6 bodyfit bowl")
        del pst7
    with phase("33e P=6 bodyfit bowl set-up before and after; the set-up "
               "kernels vs plain"):
        a33, b33, _ = setup_turn("P=6 bodyfit bowl", lambda sd: bowl_model(
            pb15, nonlinear_bowl.parser().parse_args(P6), sd))
        setup_check("P=6 bodyfit bowl", a33, b33, pb15.absorbing)
        del a33, b33
    ci.reset_launches()
    with phase("15b bodyfit bowl at P=6, 50 steps (indexed kernel)"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        s7, _ = bbowl7.solve(bbowl7.init_state(), dt7, 50)
        end.record()
        end.synchronize()
        n_idx7 = ci.launches["indexed"]
        print(f"   {smi}: P=6 bodyfit bowl {bbowl7.mesh.ndofs} DOF: "
              f"{start.elapsed_time(end) / 50:.4f} ms/step over 50 steps "
              f"(of {nsteps7} for the full run); indexed launches "
              f"{n_idx7}; max |u| {float(s7.u.abs().max()):.4e}; kernel "
              f"{k7['ms']:.4f} ms vs plain {k7['plain_ms']:.4f} ms per "
              f"apply")
        if n_idx7 != 4 * 50 or ci.launches["indexed_pair"] != 0:
            fail(f"launches {dict(ci.launches)} after the P=6 run")
        if not bool(torch.isfinite(s7.u).all()) or \
                float(s7.u.abs().max()) == 0.0:
            fail("P=6 bodyfit field is not finite and non-zero")

    with phase("21d P=6 bodyfit bowl on the engine: build, kernels vs plain "
               "and vs the indexed kernel"):
        ebowl7, dt17, _, _ = nonlinear_bowl.build(
            nonlinear_bowl.parser().parse_args(P6 + ENGINE), pb15)
        k17 = engine_kernels(ebowl7, bbowl7.stiffness, "P=6 bodyfit bowl")
    cen.reset_launches()
    with phase("21d P=6 bodyfit bowl on the engine, 50 steps"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        s17, _ = ebowl7.solve(ebowl7.init_state(), dt7, 50)
        end.record()
        end.synchronize()
        n_eng7 = dict(cen.launches)
        traj = rel_l2(s17.u, s7.u)
        print(f"   {smi}: P=6 bodyfit bowl on the engine: "
              f"{start.elapsed_time(end) / 50:.4f} ms/step over 50 steps; "
              f"composed engine {k17['engine']['ms']:.4f} ms vs indexed "
              f"{k17['engine']['indexed_ms']:.4f} ms per apply; launches "
              f"{n_eng7}; vs the indexed kernel's 50 steps rel-l2(u) "
              f"{traj:.3e} (tol {TRAJ_TOL})")
        if any(n_eng7[k] != 4 * 50 for k in STAGED):
            fail(f"launches {n_eng7} after the P=6 engine run")
        if not traj <= TRAJ_TOL:
            fail(f"P=6 engine vs indexed 50 steps {traj:.3e}")
        del s7, s17
    with phase("34l P=6 bodyfit bowl on the engine in bf16: kernels vs "
               "plain, 50 steps, ms a step in turns with 21d's float32 "
               "engine"):
        m34l, dt34l, _, _ = nonlinear_bowl.build(
            nonlinear_bowl.parser().parse_args(P6 + ENGINE + ["--dtype",
                                                              "bf16"]), pb15)
        k34l = engine16_kernels(m34l, "P=6 bodyfit bowl")
        _, n34l = engine16_steps(m34l, dt34l, 50, "P=6 bodyfit bowl")
        turns = ms_turns([("float32 engine", ebowl7, dt7),
                          ("bf16 engine", m34l, dt34l),
                          ("bf16 engine, first #9 / #10",
                           FirstDesigns(m34l), dt34l)])
        print(f"   {smi}: P=6 bodyfit bowl ms a step (50 steps from rest, "
              f"in turns, host clock): float32 engine "
              f"{turns['float32 engine']:.4f}, bf16 engine "
              f"{turns['bf16 engine']:.4f}, bf16 engine on the first "
              f"designs of #9 / #10 "
              f"{turns['bf16 engine, first #9 / #10']:.4f}; the composed "
              f"apply float32 "
              f"(21d) {k17['engine']['ms']:.4f} ms, bf16 "
              f"{k34l['engine_bf16']['ms']:.4f} ms", flush=True)
        del m34l, ebowl7, k17, pb15
    for k in STAGED:
        launches[k] = n_eng[k] + n_eng2[k] + n_eng7[k]
    launches["engine_gather2"] = n_eng2["engine_gather2"]
    # the first design of the gather: its launches in 21a's run in turns;
    # gather2's: in 21c's and 34k's
    launches["engine_gather_flat"] = n_flat
    launches["engine_gather2_flat"] = kernels["engine_gather2_flat"][
        "launches"]
    launches["engine_gather2_flat_bf16"] = kernels[
        "engine_gather2_flat_bf16"]["launches"]
    # the composed apply: the launches of its kernels
    launches["engine"] = sum(launches[k] for k in
                             STAGED + ("engine_gather2",))
    # the bf16 engine: its kernels' launches in 34k-l's counted runs
    for counts in (n34k, n34kb, n34l):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    launches["engine_bf16"] = sum(launches[k] for k in STAGED16
                                  + ("engine_gather2_bf16",))
    # the first designs of #9 and #10 in bf16: their launches in 34k-l's
    # runs in turns
    for k in ("engine_contract_cells_bf16", "engine_scatter_dofs_bf16"):
        launches[k] = sum(e[k]["launches"] for e in (k34k, k34kb, k34l))
    ci.reset_launches()
    with phase("15c bodyfit bowl at P=6, full solve (indexed kernel)"):
        args7 = nonlinear_bowl.parser().parse_args(
            ["--elements", "48", "--degree", "6", "--geometry", "bodyfit"])
        state = run_demo(bbowl7, dt7, nsteps7, args7, "nonlinear_bowl")
        n_idx7c = ci.launches["indexed"]
        p_body6 = nonlinear_bowl.focal_pressure(bbowl7, state, focus7)
        print(f"pressure at focus: {p_body6:.1f} Pa")
        print(f"   indexed launches {n_idx7c} for {nsteps7} steps")
        if n_idx7c != 4 * nsteps7 or ci.launches["indexed_pair"] != 0:
            fail(f"P=6 launches {dict(ci.launches)} != 4 x {nsteps7}")
        if not bool(torch.isfinite(state.u).all()):
            fail("P=6 bodyfit field is not finite")
        del state, bbowl7
    with phase("15d conformal bowl at P=6, full solve (the comparison)"):
        cbowl, dt8, nsteps8, focus8 = nonlinear_bowl.build(
            nonlinear_bowl.parser().parse_args(
                ["--elements", "48", "--degree", "6"]))
        state = run_demo(cbowl, dt8, nsteps8, args7, "nonlinear_bowl")
        p_conf6 = nonlinear_bowl.focal_pressure(cbowl, state, focus8)
        agree6 = abs(p_body6 - p_conf6) / abs(p_conf6)
        print(f"   conformal P=6 focal {p_conf6:.1f} Pa; bodyfit "
              f"{p_body6:.1f} Pa; relative difference {agree6:.3e} (tol "
              f"{BODYFIT_P6_AGREE})")
        if not agree6 <= BODYFIT_P6_AGREE:
            fail(f"P=6 bodyfit vs conformal focal pressure {agree6:.3e}")
        del state, cbowl
    with phase("33f conformal P=6 bowl set-up before and after; the set-up "
               "kernels vs plain"):
        args33 = nonlinear_bowl.parser().parse_args(
            ["--elements", "48", "--degree", "6"])
        pb33 = nonlinear_bowl.problem(args33)
        a33, b33, _ = setup_turn("conformal P=6 bowl",
                                 lambda sd: bowl_model(pb33, args33, sd))
        setup_check("conformal P=6 bowl", a33, b33, pb33.absorbing)
        del a33, b33, pb33
    launches.update(indexed=n_idx + n_idx7 + n_idx7c,
                    indexed_pair=n_idx_pair)

    with phase("28 exp_imported: the class-launch kernels against the "
               "stack and chunk kernels (and the engine) in turns, P=4 f32 "
               "at the imported and bodyfit bowls, P=6 bodyfit"):
        ce.reset_launches()
        ci.reset_launches()
        cmp = {"#6": exp_imported.compare_extruded(idisc3, dev),
               "#11": exp_imported.compare_indexed(bdisc5, dev),
               "#11 P=6": exp_imported.compare_indexed(
                   bdisc7, dev, label="#11 P=6", pair=False, others=())}
        torch.cuda.synchronize()
        print(f"   launches in the demo: {dict(ce.class_launches)}, "
              f"{dict(ci.class_launches)}")
        for counts in (ce.class_launches, ci.class_launches):
            for name, n in counts.items():
                demo_launches[name] = n
                if not n:
                    fail(f"{name} was not launched by the demo")
        for label, out in cmp.items():
            old, new = ("classes", "stack") if label == "#6" else \
                ("classes", "chunks")
            for form, f in out.items():
                for name, y in f["ys"].items():
                    e = rel_l2(y, f["plain"])
                    if not e <= F32_TOL:
                        fail(f"{label} {form} {name} vs plain {e:.3e}")
                ms = {name: min(t[0] for t in tt) * 1e3
                      for name, tt in f["times"].items()}
                b_ms = f["nbytes"] / PEAK_BYTES_PER_S * 1e3
                vs = "".join(f", {name} {m:.4f} ms ({b_ms / m:.1%})"
                             for name, m in ms.items()
                             if name not in (old, new))
                print(f"   {smi}: {label} {form}: the class-launch kernel "
                      f"{ms[old]:.4f} ms ({b_ms / ms[old]:.1%} of the bound "
                      f"{b_ms:.4f} ms), the new kernel {ms[new]:.4f} ms "
                      f"({b_ms / ms[new]:.1%}, "
                      f"{f['nbytes'] / ms[new] / 1e9:.4f} TB/s){vs}: "
                      f"{ms[old] / ms[new]:.4f}x", flush=True)
        for name, label, form in (
                ("extruded_classes", "#6", "single"),
                ("extruded_classes_pair", "#6", "pair"),
                ("indexed_classes", "#11", "single"),
                ("indexed_classes_pair", "#11", "pair")):
            f = cmp[label][form]
            module = (ExtrudedStiffness if label == "#6"
                      else IndexedStiffness)(f["op"], "mm")
            xs = f["xs"]
            plain = (lambda m=module, xs=xs: m(xs[0])) if form == "single" \
                else (lambda m=module, xs=xs: m.pair(*xs))
            yk, yp = f["ys"]["classes"], f["plain"]
            index = (f["op"].rows if label == "#6" else f["op"].dofmap)
            kernels[name] = dict(
                max_abs_err=float((yk - yp).abs().max()),
                rel_l2=rel_l2(yk, yp),
                ms=min(t[0] for t in f["times"]["classes"]) * 1e3,
                plain_ms=time_ms(plain, 3),
                cost=apply_cost(f["op"].G, f["op"].ndofs, len(xs),
                                extra=index.numel() * 4))
            print(f"   {smi}: {name}: {kernels[name]}", flush=True)
        del cmp, f, module, xs, yk, yp, idisc3, bdisc5, bdisc7

    def capacity_run(demo, argv, label, kernel):
        """Run a capacity demo through its `main` on the card (counters
        reset just before, read just after); check its launches and its
        field; what the model holds and what a 10-step solve adds, on the
        walk and (float32) on the class-launch design; then the model's
        kernel at this size against its plain version on one seeded
        unit-normal field in the model's dtype (F32_TOL, bf16 BF16_TOL).  Returns (the launches of the demo's
        run, its host set-up seconds and their split)."""
        torch.cuda.empty_cache()
        cc.reset_launches()
        model, state, ms, peak, timed, t_setup = demo.main(argv)
        counts = {**cc.launches, **cc.bf16_launches}
        total = counts[kernel]
        others = sum(counts.values()) - total
        umax = float(state.u.abs().max())
        b = model.stiffness.T.element_size()
        # the G stream that the same mesh would hold in the model's dtype
        g_bytes = model.mesh.num_cells * 6 * (model.mesh.degree + 1) ** 3 * b
        split = ", ".join(f"{k} {v:.1f} s"
                          for k, v in model.disc.host_seconds.items())
        print(f"   {smi}: {label}: {model.mesh.ndofs} DOF, "
              f"{model.mesh.num_cells} cells, {model.dtype}; host set-up "
              f"{t_setup:.1f} s ({split}); {ms:.4f} ms/step; peak device "
              f"memory {peak / 1e9:.4f} GB; channels "
              f"{model.stiffness.T.numel() * b / 1e9:.4f} GB, the G stream "
              f"would add {g_bytes / 1e9:.4f} GB (computed, not "
              f"allocated); {kernel} launches {timed} in the timed solve, "
              f"{total} in all; max |u| {umax:.4e}", flush=True)
        if timed != 4 * 10 or total != 4 * 20 or others != 0:
            fail(f"{label}: launches {counts}, {timed} in the timed solve")
        if not bool(torch.isfinite(state.u).all()) or umax == 0.0:
            fail(f"{label}: field is not finite and non-zero")
        del state
        kst = model.stiffness
        f32 = kst.T.dtype == torch.float32
        # what the model holds and what a solve adds on each design, in
        # one process, apart from what earlier phases still hold: the
        # buffers (channels, diagonals) serve both designs, the walk adds
        # its schedule's tables (the class-launch design has no bf16 form)
        op_ = kst.cell_op
        _, chunks_, ids_, _ = cc._card(op_, op_.T.dtype, kst.is_pair,
                                       op_.T.device)
        tables = sum(t.numel() * t.element_size()
                     for t in (chunks_, ids_) if t is not None)
        held = held_bytes(model)
        dt_ = model.cfl_dt(0.4)[0]
        adds = {"walk": solve_peak(model, dt_, 10)}
        if f32:
            model.stiffness = ClassLaunchCorner(op_)
            try:
                adds["class-launch"] = solve_peak(model, dt_, 10)
            finally:
                model.stiffness = kst
        for name, add in adds.items():
            own = held + add + (tables if name == "walk" else 0)
            print(f"   {label} on the {name} design: buffers "
                  f"{held / 1e9:.4f} GB"
                  + (f" and schedule tables {tables / 1e9:.4f} GB"
                     if name == "walk" else "")
                  + f", a 10-step solve adds at most {add / 1e9:.4f} GB: "
                  f"{own / 1e9:.4f} GB, {own / model.mesh.ndofs:.2f} B a DOF"
                  f" ({smi})", flush=True)
        peaks = solve_peaks(model, dt_, 10)
        print(f"   {smi}: {label}: a 10-step solve adds at its peak "
              + ", ".join(f"{form} {a / 1e9:.4f} GB allocated, "
                          f"{r / 1e9:.4f} GB reserved"
                          for form, (a, r) in peaks.items())
              + f" (captured - eager reserved "
              f"{(peaks['captured'][1] - peaks['eager'][1]) / 1e9:.4f} GB; "
              f"the model holds {held / 1e9:.4f} GB)", flush=True)
        tol = F32_TOL if f32 else BF16_TOL
        pst = CornerStiffness(kst.cell_op, "mm")
        x = torch.randn(model.mesh.grid_shape, dtype=torch.float32,
                        device=dev, generator=torch.Generator(
                            device=dev).manual_seed(19)).to(kst.T.dtype)
        yk = kst(x)
        yp = pst(x)
        err = rel_l2(yk, yp)
        print(f"   {label}: {kernel} kernel vs plain at this size: "
              f"rel-l2 {err:.3e} (tol {tol}), max abs "
              f"{float((yk.float() - yp.float()).abs().max()):.3e}",
              flush=True)
        if not err <= tol:
            fail(f"{label}: corner kernel vs plain {err:.3e} > {tol}")
        del pst, x, yk, yp
        del model, kst
        torch.cuda.empty_cache()
        return total, t_setup, split

    with phase("19a capacity demo at its default size (664 x 56 x 56 cells, "
               "P=4), set-up on the card (33h's after)"):
        n19a, t19a, split19a = capacity_run(
            capacity, ["--steps", "10"], "capacity box", "corner")
        corner_launches["corner"] += n19a
    with phase("19b capacity_imported at --nz 30 (a quarter of the default "
               "depth)"):
        print("   reduced: --nz 30 of the default 120 layers, at the "
              "default footprint (--m 48 --mr 24 --nr-ann 24)")
        corner_launches["extruded_corner"] += capacity_run(
            capacity_imported, ["--nz", "30", "--steps", "10"],
            "capacity cylinder (nz 30)", "extruded_corner")[0]
    with phase("34i capacity demo in bf16 at its default size (664 x 56 x "
               "56 cells, P=4): the bf16 corner walk, peak device memory "
               "beside 19a's float32, #3 bf16 vs plain at this size"):
        bf16_counts["corner_bf16"] += capacity_run(
            capacity, ["--steps", "10", "--dtype", "bf16"],
            "capacity box in bf16", "corner_bf16")[0]
    with phase("33h capacity demo in its own process (664 x 56 x 56 cells, "
               "P=4, --steps 10), set-up on the host (before; after: 19a's "
               "run on the card): set-up seconds, peak device memory, host "
               "peak resident"):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "fustpu_torch.demos.capacity",
             "--steps", "10", "--setup-device", "cpu"], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith(("set-up", "10 steps", "|u| max",
                                   "launches"))]
        for ln in lines:
            print(f"   capacity box, set-up before: {ln}")
        print(f"   capacity box, set-up before: the process took "
              f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)
        m = re.search(r"^set-up ([0-9.]+) s \((.*?)\);", out.stdout, re.M)
        if out.returncode != 0 or m is None or len(lines) != 4 or \
                "launches in the timed solve: corner 40" not in out.stdout:
            fail(f"33h: the capacity demo (before) exited {out.returncode} "
                 f"or did not launch corner 4 x 10 times in its timed "
                 f"solve: {out.stderr[-2000:]}")
        setup_table.append(("capacity box (before, its own process)",
                            float(m.group(1)), m.group(2)))
        setup_table.append(("capacity box (after, 19a in this process)",
                            t19a, split19a))
    with phase("33i the physics anchors in float32 on the card: Fubini's "
               "second harmonic (2%) and two-layer transmission (3%)"):
        cs.reset_launches()
        an = anchors.main(["--device", "cuda"])
        torch.cuda.synchronize()
        fb, tr = an["fubini"], an["transmission"]
        n_an = cs.launches["stiffness"] + cs.launches["stiffness_pair"]
        print(f"   {smi}: Fubini {fb['rel']:.4%} (sigma {fb['sigma']:.4f}),"
              f" transmission {tr['dev']:.4%}; #1 / #2 launches {n_an} for "
              f"{fb['steps'] + tr['steps']} steps", flush=True)
        if not (fb["rel"] < anchors.FUBINI_TOL and 0.15 < fb["sigma"] < 0.9
                and fb["B2"] / fb["B1"] > 0.05
                and tr["dev"] < anchors.TRANSMISSION_TOL):
            fail(f"33i: the anchors missed: {an}")
        if n_an != 4 * (fb["steps"] + tr["steps"]):
            fail(f"33i: launches {n_an}")
    with phase("33k the multi-node check: 2 separately launched gloo ranks "
               "sharing the card, joined over tcp://127.0.0.1"):
        e33 = multihost.run_separate_check(2, (2, 1, 1), device="cuda",
                                           init="tcp", timeout=600.0)
        print(f"   2 separately launched ranks on the card: sharded vs "
              f"one rank rel-l2 {e33:.3e} (tol {multihost.CHECK_TOL}), "
              f"shared entries consistent ({smi})", flush=True)
    with phase("33 the set-up seconds, before (host numpy) and after "
               "(the set-up kernels), in this call"):
        for row in setup_table:
            if len(row) == 3 and isinstance(row[1], tuple):
                label, (tb, sb), (ta, sa) = row
                fmt = lambda sp: ", ".join(f"{k} {v:.3f}"
                                           for k, v in sp.items())
                print(f"   {label}: {tb:.3f} s ({fmt(sb)}) -> {ta:.3f} s "
                      f"({fmt(sa)}) ({smi})")
            else:
                print(f"   {row[0]}: {row[1]:.3f} s ({row[2]}) ({smi})")
    cs.reset_launches()
    with phase("32c #1 against the dense oracle at P=2..10 (f64, 2^3; the "
               "oracle computed in a process of its own since phase 32i)"):
        t0 = time.perf_counter()
        refs = {P: job.get(timeout=900) for P, job in oracle_jobs.items()}
        oracle_pool.join()
        print(f"   the oracle's processes: waited "
              f"{time.perf_counter() - t0:.1f} s")
        for P in sorted(refs):
            e = exp_degree_sweep.oracle_check(P, dev, refs[P])
            print(f"   {smi}: P={P} 2^3 float64: #1 vs the dense oracle "
                  f"rel-l2 {e:.3e} (tol {F64_TOL})", flush=True)
            if not e <= F64_TOL:
                fail(f"32c: P={P} f64 #1 vs the dense oracle {e:.3e} > "
                     f"{F64_TOL}")
        torch.cuda.synchronize()
        if len(refs) != 9 or cs.launches["stiffness"] != 9:
            fail(f"32c: {len(refs)} oracle degrees, "
                 f"{cs.launches['stiffness']} #1 launches")
        del refs, oracle_jobs
    launches.update(corner_launches)
    launches.update(demo_launches)
    launches.update(setup_launches)
    launches.update(bf16_counts)
    kernels.update(demo_kernels)

    meta = {
        "stiffness": ("fustpu_torch/csrc/stiffness_pencil.cuh",
                      "fustpu/ops/pallas_stiffness.py:170"),
        "stiffness_pair": ("fustpu_torch/csrc/stiffness_pencil.cuh",
                           "fustpu/ops/pallas_stiffness.py:726"),
        "anatomy_full": ("fustpu_torch/csrc/stiffness.cuh",
                         "fustpu/ops/pallas_stiffness.py:170"),
        "anatomy_full_pair": ("fustpu_torch/csrc/stiffness.cuh",
                              "fustpu/ops/pallas_stiffness.py:726"),
        "extruded": ("fustpu_torch/csrc/extruded_stack.cu",
                     "fustpu/ops/pallas_extruded.py:604"),
        "extruded_pair": ("fustpu_torch/csrc/extruded_stack.cu",
                          "fustpu/ops/pallas_extruded.py:604"),
        "extruded_classes": ("fustpu_torch/csrc/extruded.cu",
                             "fustpu/ops/pallas_extruded.py:604"),
        "extruded_classes_pair": ("fustpu_torch/csrc/extruded.cu",
                                  "fustpu/ops/pallas_extruded.py:604"),
        "indexed": ("fustpu_torch/csrc/indexed_chunk.cu",
                    "fustpu/ops/pallas_gather.py:1417"),
        "indexed_pair": ("fustpu_torch/csrc/indexed_chunk.cu",
                         "fustpu/ops/pallas_gather.py:1417"),
        # the bf16 forms of the G-stream kernels (phase 34)
        "stiffness_bf16": ("fustpu_torch/csrc/stiffness_pencil.cuh",
                           "fustpu/ops/pallas_stiffness.py:170"),
        "stiffness_pair_bf16": ("fustpu_torch/csrc/stiffness_pencil.cuh",
                                "fustpu/ops/pallas_stiffness.py:726"),
        "extruded_bf16": ("fustpu_torch/csrc/extruded_stack.cu",
                          "fustpu/ops/pallas_extruded.py:604"),
        "extruded_pair_bf16": ("fustpu_torch/csrc/extruded_stack.cu",
                               "fustpu/ops/pallas_extruded.py:604"),
        "indexed_bf16": ("fustpu_torch/csrc/indexed_chunk.cu",
                         "fustpu/ops/pallas_gather.py:1417"),
        "indexed_pair_bf16": ("fustpu_torch/csrc/indexed_chunk.cu",
                              "fustpu/ops/pallas_gather.py:1417"),
        # the bf16 forms of the corner walk (phase 34f-h)
        "corner_bf16": ("fustpu_torch/csrc/corner_pencil.cu",
                        "fustpu/ops/pallas_stiffness.py:963"),
        "corner_pair_bf16": ("fustpu_torch/csrc/corner_pencil.cu",
                             "fustpu/ops/pallas_stiffness.py:963"),
        "extruded_corner_bf16": ("fustpu_torch/csrc/corner_stack.cu",
                                 "fustpu/ops/pallas_extruded.py:604"),
        "extruded_corner_pair_bf16": ("fustpu_torch/csrc/corner_stack.cu",
                                      "fustpu/ops/pallas_extruded.py:604"),
        "extruded_corner_hex27_bf16": (
            "fustpu_torch/csrc/corner_stack27.cu",
            "fustpu/ops/pallas_extruded.py:604"),
        "extruded_corner_hex27_pair_bf16": (
            "fustpu_torch/csrc/corner_stack27.cu",
            "fustpu/ops/pallas_extruded.py:604"),
        "indexed_classes": ("fustpu_torch/csrc/indexed.cu",
                            "fustpu/ops/pallas_gather.py:1417"),
        "indexed_classes_pair": ("fustpu_torch/csrc/indexed.cu",
                                 "fustpu/ops/pallas_gather.py:1417"),
        "corner": ("fustpu_torch/csrc/corner_pencil.cu",
                   "fustpu/ops/pallas_stiffness.py:963"),
        "corner_pair": ("fustpu_torch/csrc/corner_pencil.cu",
                        "fustpu/ops/pallas_stiffness.py:963"),
        "extruded_corner": ("fustpu_torch/csrc/corner_stack.cu",
                            "fustpu/ops/pallas_extruded.py:604"),
        "extruded_corner_pair": ("fustpu_torch/csrc/corner_stack.cu",
                                 "fustpu/ops/pallas_extruded.py:604"),
        "extruded_corner_hex27": ("fustpu_torch/csrc/corner_stack27.cu",
                                  "fustpu/ops/pallas_extruded.py:604"),
        "extruded_corner_hex27_pair": (
            "fustpu_torch/csrc/corner_stack27.cu",
            "fustpu/ops/pallas_extruded.py:604"),
        "corner_classes": ("fustpu_torch/csrc/corner.cu",
                           "fustpu/ops/pallas_stiffness.py:963"),
        "corner_classes_pair": ("fustpu_torch/csrc/corner.cu",
                                "fustpu/ops/pallas_stiffness.py:963"),
        "extruded_corner_classes": ("fustpu_torch/csrc/extruded_corner.cu",
                                    "fustpu/ops/pallas_extruded.py:604"),
        "extruded_corner_classes_pair": (
            "fustpu_torch/csrc/extruded_corner.cu",
            "fustpu/ops/pallas_extruded.py:604"),
        "extruded_corner_hex27_classes": (
            "fustpu_torch/csrc/extruded_corner27.cu",
            "fustpu/ops/pallas_extruded.py:604"),
        "extruded_corner_hex27_classes_pair": (
            "fustpu_torch/csrc/extruded_corner27.cu",
            "fustpu/ops/pallas_extruded.py:604"),
        "engine_gather": ("fustpu_torch/csrc/engine.cu",
                          "fustpu/ops/pallas_gather.py:534"),
        "engine_gather_flat": ("fustpu_torch/csrc/engine.cu",
                               "fustpu/ops/pallas_gather.py:534"),
        "engine_gather2": ("fustpu_torch/csrc/engine.cu",
                           "fustpu/ops/pallas_gather.py:566"),
        "engine_contract": ("fustpu_torch/csrc/engine.cu",
                            "fustpu/ops/pallas_gather.py:1078"),
        "engine_scatter": ("fustpu_torch/csrc/engine.cu",
                           "fustpu/ops/pallas_gather.py:610"),
        "engine": ("fustpu_torch/csrc/engine.cu",
                   "fustpu/ops/operators.py:290"),
        # the bf16 forms of the staged engine (phase 34j-l)
        "engine_gather_bf16": ("fustpu_torch/csrc/engine.cu",
                               "fustpu/ops/pallas_gather.py:534"),
        "engine_gather2_bf16": ("fustpu_torch/csrc/engine.cu",
                                "fustpu/ops/pallas_gather.py:566"),
        # the RK4 update with its coefficient on the card (the captured
        # solve): no TPU kernel, XLA fuses the JAX package's update
        "axpy": ("fustpu_torch/csrc/vector.cu",
                 "fustpu/models/timestepping.py:61"),
        "axpy_bf16": ("fustpu_torch/csrc/vector.cu",
                      "fustpu/models/timestepping.py:61"),
        # gather2's first design, kept as the comparison (21c, 34k)
        "engine_gather2_flat": ("fustpu_torch/csrc/engine.cu",
                                "fustpu/ops/pallas_gather.py:566"),
        "engine_gather2_flat_bf16": ("fustpu_torch/csrc/engine.cu",
                                     "fustpu/ops/pallas_gather.py:566"),
        "engine_contract_bf16": ("fustpu_torch/csrc/engine_bf16.cu",
                                 "fustpu/ops/pallas_gather.py:1078"),
        "engine_scatter_bf16": ("fustpu_torch/csrc/engine_bf16.cu",
                                "fustpu/ops/pallas_gather.py:610"),
        "engine_contract_cells_bf16": ("fustpu_torch/csrc/engine.cu",
                                       "fustpu/ops/pallas_gather.py:1078"),
        "engine_scatter_dofs_bf16": ("fustpu_torch/csrc/engine.cu",
                                     "fustpu/ops/pallas_gather.py:610"),
        "engine_bf16": ("fustpu_torch/csrc/engine_bf16.cu",
                        "fustpu/ops/operators.py:290"),
        **{name: ("fustpu_torch/csrc/slab2.cu",
                  "fustpu/ops/pallas_stiffness.py:314")
           for name in ("slab2", "slab2_classes")},
        **{name: ("fustpu_torch/csrc/slab2.cu",
                  "fustpu/ops/pallas_stiffness.py:528")
           for name in ("slab2w", "slab2w_classes")},
        **{f"anatomy_{v}": ("fustpu_torch/csrc/anatomy_walk.cuh",
                            "demos/exp_kernel_anatomy.py:34")
           for v in ("gstream", "contract", "ywin")},
        **{f"anatomy_classes_{v}": ("fustpu_torch/csrc/anatomy_classes.cu",
                                    "demos/exp_kernel_anatomy.py:34")
           for v in ("gstream", "contract", "ywin")},
        **{f"g_layout_{v}": ("fustpu_torch/csrc/probes.cu",
                             "demos/exp_g_layout.py:24")
           for v in probes.LAYOUTS},
        **{f"relayout_{v}": ("fustpu_torch/csrc/probes.cu",
                             "demos/exp_mosaic_relayout.py:38")
           for v in ("copy", "transpose", "copy_flat", "transpose_padded")},
        # the set-up kernels: no TPU kernel, the native C++ set-up runtime
        **{name: ("fustpu_torch/csrc/setup.cu",
                  f"native/fustpu_native.cpp:{ln}")
           for name, ln in (("setup_cell_geometry", 76),
                            ("setup_cell_detJ", 76),
                            ("setup_facet_geometry", 111),
                            ("setup_box_dofmap", 140),
                            ("setup_mass_diagonal_box", 163),
                            ("setup_mass_diagonal_map", 163))}}
    print(f"   total {time.perf_counter() - t_start:.1f} s ({smi})",
          flush=True)
    rows = []
    for name, (source, replaces) in meta.items():
        k = kernels[name]
        bound_ms, bound_by = bound(*k["cost"])
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": k.get("library_ms")})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
