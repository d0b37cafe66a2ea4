"""Separately launched ranks and the piston over ranks, on CPU gloo ranks:
`python -m fustpu_torch.parallel.multihost` as one rank of a process group
joined over ``tcp://`` or ``env://`` (the JAX package's separately
launched `run_multiprocess_check`), and `linear_piston --ranks 2` against
the one-rank run, in float64 and in bfloat16."""

import numpy as np
import pytest
import torch

from fustpu_torch.demos import linear_piston
from fustpu_torch.parallel import multihost

torch.set_num_threads(1)

TOL = 1e-12


@pytest.mark.parametrize("init", ["tcp", "env"])
def test_separately_launched_ranks_match_one_rank(init):
    """Two separately launched gloo processes on 127.0.0.1 (a free port;
    ``env://`` with MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
    LOCAL_RANK as torchrun sets them) solve the sharded Westervelt box
    within 1e-12 of rank 0's one-rank solve, shared planes bitwise
    consistent (each rank checks and prints its OK line)."""
    err = multihost.run_separate_check(2, (2, 1, 1), device="cpu", init=init,
                                       timeout=240.0)
    assert err <= TOL


def test_a_failing_separate_rank_fails_the_check():
    """Ranks that raise (a rank grid of 4 blocks for a world of 2) fail the
    call with every rank's output, and no rank is left running."""
    with pytest.raises(RuntimeError, match=r"(?s)failed.*needs 4 ranks"):
        multihost.run_separate_check(2, (2, 2, 1), device="cpu", init="tcp",
                                     timeout=120.0)


def test_piston_over_ranks_matches_one_rank():
    """`linear_piston --ranks 2` (the imported piston on
    `ExtrudedShardedModel`, the sharded on-axis probe's trace from rank 0)
    prints the O'Neil table of the one-rank run: the on-axis amplitudes
    within 1e-12, the traces too."""
    argv = ["--device", "cpu", "--dtype", "f64", "--degree", "2",
            "--periods", "0.2", "--progress-every", "1000"]
    model, _, dev1, n1, t1 = linear_piston.main(argv)
    _, res, dev2, n2, t2 = linear_piston.main(argv + ["--ranks", "2"])
    _, spp = model.cfl_dt()
    a1 = linear_piston.on_axis_amplitude(t1, spp)
    a2 = linear_piston.on_axis_amplitude(t2, spp)
    assert n1 == n2 and t1.shape == t2.shape == (n1, 13)
    assert np.abs(a2 - a1).max() <= TOL * np.abs(a1).max()
    assert np.abs(t2 - t1).max() <= TOL * np.abs(t1).max()
    assert abs(dev2 - dev1) <= TOL
    assert res[0]["stiffness"] == "ExtrudedStiffness"


def test_piston_over_ranks_bf16_matches_one_rank():
    """`linear_piston --ranks 2 --dtype bf16`: the bf16 sharded piston's
    vectors and rank 0's probe trace (read through `to_host`) give the
    one-rank bf16 run's trace and O'Neil figure bitwise, as the JAX
    package's bf16 sharded run gives its single-device one."""
    argv = ["--device", "cpu", "--dtype", "bf16", "--degree", "2",
            "--periods", "0.2", "--progress-every", "1000"]
    model, state, dev1, n1, t1 = linear_piston.main(argv)
    _, res, dev2, n2, t2 = linear_piston.main(argv + ["--ranks", "2"])
    assert model.dtype == state.u.dtype == torch.bfloat16
    assert n1 == n2 and t1.shape == t2.shape == (n1, 13)
    assert np.isfinite(t2).all() and np.abs(t2).max() > 0.0
    assert np.array_equal(t2, t1) and dev2 == dev1
    assert res[0]["stiffness"] == "ExtrudedStiffness"
    assert all(not r["launches"] for r in res)
