"""The port's examples against the reference's, on the CPU.

``examples/torch_quickstart.py`` and ``examples/torch_stencil_kernel.py``
run with ``--device cpu`` beside ``examples/quickstart.py`` and
``examples/stencil_kernel.py``.  Their numbers come from host numpy (the
MARS analysis, the layout, the executor, the transfer model) or from a
formula (the stencil's halo bytes), so every such line the reference
prints is held exactly.  The reference's stencil example runs its plain
route (``use_pallas=False``), as its own CPU tests run the kernel, and the
port's stencil output is held to the reference's ``ref.jacobi_chunked_ref``
on the same seeded input within 1e-5 (the tolerance of
tests/test_kernels.py).  The quickstart's added last line, the chunked
stencil on the device against the dense reference, is held within 1e-5.
"""
import contextlib
import io
import os
import re
import runpy
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JACOBI_TOL = 1e-5
#: the stencil example's input: n, T and the seed of its field
STENCIL_N, STENCIL_T, STENCIL_SEED = 1 << 15, 32, 0


def _run(name, *argv):
    """An example run in this process: (its printed lines, what its
    ``main`` returned).  A reference example is a script and runs as
    ``__main__`` (returning None); a port example's ``main`` takes argv."""
    out = io.StringIO()
    path = os.path.join(REPO, "examples", name)
    with contextlib.redirect_stdout(out):
        if name.startswith("torch_"):
            ret = runpy.run_path(path, run_name="example")["main"](list(argv))
        else:
            saved, sys.argv = sys.argv, [name]
            try:
                runpy.run_path(path, run_name="__main__")
            finally:
                sys.argv = saved
            ret = None
    return out.getvalue().strip().splitlines(), ret


@pytest.fixture(scope="module")
def quickstart():
    return _run("quickstart.py")[0], _run("torch_quickstart.py", "--device", "cpu")[0]


@pytest.fixture(scope="module")
def stencil():
    """(the reference's lines, the port's lines, the port's output, the
    reference's oracle on the same input)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    tiled = jops.jacobi1d_tiled
    # the oracle jitted: 0.5 s where it takes 6.5 s op by op
    oracle = jax.jit(jref.jacobi_chunked_ref, static_argnums=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "jacobi1d_tiled",
                   lambda x, t, width=512, use_pallas="auto":
                   tiled(x, t, width=width, use_pallas=False))
        mp.setattr(jref, "jacobi_chunked_ref", oracle)
        theirs, _ = _run("stencil_kernel.py")
    mine, y = _run("torch_stencil_kernel.py", "--device", "cpu")
    x = np.cumsum(np.random.default_rng(STENCIL_SEED).uniform(-0.01, 0.01, STENCIL_N))
    want = np.asarray(oracle(jnp.asarray(x, jnp.float32), STENCIL_T))
    return theirs, mine, y, want


def test_quickstart_prints_the_references_numbers(quickstart):
    theirs, mine = quickstart
    assert mine[:len(theirs)] == theirs
    assert "MARS: 7 in / 4 out" in mine[0] and "3 read bursts" in mine[1]


def test_quickstart_runs_the_chunked_stencil_on_the_device(quickstart):
    _, mine = quickstart
    last = mine[-1]
    assert last.startswith("chunked jacobi on cpu:")
    err = float(re.findall(r"\d+\.\d+e[-+]\d+", last)[-1])
    assert err <= JACOBI_TOL


def test_stencil_example_prints_the_references_numbers(stencil):
    theirs, mine, *_ = stencil
    assert len(mine) == len(theirs) == 3
    assert mine[0] == theirs[0] == "jacobi1d chunked kernel: n=32768 T=32 W=512"
    assert mine[2] == theirs[2]
    # each side's route against its own oracle: the port's plain route is
    # bit-identical to it on the CPU
    errs = [float(line.rsplit("= ", 1)[1]) for line in (theirs[1], mine[1])]
    assert errs[0] <= JACOBI_TOL and errs[1] == 0.0


def test_stencil_example_output_equals_the_references(stencil):
    *_, y, want = stencil
    assert y.shape == want.shape == (STENCIL_N,) and y.device.type == "cpu"
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=JACOBI_TOL)
