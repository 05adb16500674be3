"""The port's kernel entry points (plain path on the CPU) against the JAX package.

The JAX side runs as its own tests run it: Pallas in interpret mode, or
``repro.kernels.ref``.  The CUDA kernels themselves run only on a GPU and
are held against these plain versions by ``chip_smoke.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import obs as jobs
from repro.kernels import jacobi_mars as jjm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.kernels import bitplane, jacobi_mars, ops

ROOT = Path(__file__).resolve().parents[1]


def _cpu(a):
    return convert.to_torch(a, device="cpu")


def _np(t):
    return convert.to_numpy(t)


# -- codec: the sweep of tests/test_kernels.py, against Pallas interpret -----

@pytest.mark.parametrize("bits", [4, 6, 8, 12, 16])
@pytest.mark.parametrize("n,block", [(8, 128), (16, 256), (32, 512)])
def test_pack_unpack_vs_interpret_sweep(bits, n, block):
    rng = np.random.default_rng(bits * n)
    lim = max(1 << (bits - 2), 1)
    d = rng.integers(-lim // 2 - 1, lim // 2 + 1, size=(n, block)).astype(np.int32)
    q = np.cumsum(d, axis=1, dtype=np.int32)
    jp = np.asarray(jops.pack_codes(jnp.asarray(q), bits, use_pallas="interpret"))
    tp = ops.pack_codes(_cpu(q), bits)
    assert tp.dtype == torch.uint32
    assert np.array_equal(_np(tp), jp)
    ju = np.asarray(jops.unpack_codes(jnp.asarray(jp), bits, block,
                                      use_pallas="interpret"))
    tu = ops.unpack_codes(convert.to_torch(jp, device="cpu"), bits, block)
    assert np.array_equal(_np(tu), ju)
    assert np.array_equal(_np(tu), q)


@pytest.mark.parametrize("bits", range(1, 33))
def test_pack_unpack_full_range_wrap(bits):
    """Every width, on codes whose deltas wrap int32 and overflow `bits`."""
    rng = np.random.default_rng(1000 + bits)
    q = rng.integers(-2**31, 2**31, size=(8, 64), dtype=np.int64).astype(np.int32)
    jp = np.asarray(jops.pack_codes(jnp.asarray(q), bits, use_pallas="interpret"))
    tp = ops.pack_codes(_cpu(q), bits)
    assert np.array_equal(_np(tp), jp)
    ju = np.asarray(jops.unpack_codes(jnp.asarray(jp), bits, 64,
                                      use_pallas="interpret"))
    tu = ops.unpack_codes(tp, bits, 64)
    assert np.array_equal(_np(tu), ju)
    if bits == 32:
        assert np.array_equal(_np(tu), q)


# -- jacobi: the sweep of tests/test_kernels.py, 1e-5 as there ----------------

@pytest.mark.parametrize("t_steps,width,n", [
    (4, 256, 1024), (16, 512, 2048), (63, 128, 1024), (8, 1024, 4096)])
def test_jacobi1d_tiled_vs_interpret_sweep(t_steps, width, n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    y_int = np.asarray(jops.jacobi1d_tiled(jnp.asarray(x), t_steps, width=width,
                                           use_pallas="interpret"))
    y_t = _np(ops.jacobi1d_tiled(_cpu(x), t_steps, width=width))
    assert y_t.shape == (n,) and y_t.dtype == np.float32
    assert np.abs(y_t - y_int).max() < 1e-5
    y_ref = np.asarray(jref.jacobi_chunked_ref(jnp.asarray(x), t_steps))
    assert np.abs(y_t - y_ref).max() < 1e-5


@pytest.mark.parametrize("t_steps,width,n", [(4, 16, 64), (7, 12, 48), (0, 8, 32)])
def test_jacobi_chunked_plain_is_skewed_buffer(t_steps, width, n):
    """The plain version equals the Pallas kernel's skewed buffer itself."""
    rng = np.random.default_rng(width)
    x = rng.standard_normal(n).astype(np.float32)
    y_int = np.asarray(jjm.jacobi_chunked(jnp.asarray(x), t_steps=t_steps,
                                          width=width, interpret=True))
    y_t = _np(jacobi_mars.jacobi_chunked(_cpu(x), t_steps, width))
    assert np.abs(y_t - y_int).max() < 1e-5


def _evolving_ghost(rng) -> np.float32:
    """A value a with ((a + a) + a) / 3 != a in f32: as x[0] it makes the
    ghost left of cell 0 change from level to level."""
    while True:
        a = np.float32(rng.standard_normal())
        if ((a + a) + a) / np.float32(3) != a:
            return a


def _tiled_jacobi(x, t_steps, tile):
    """The CUDA kernel's algorithm at a tile width of its own: every tile
    steps its cells with the carry, the two cells left of it at the same
    level; the first tile's carry is the ghost x[0], evolved by the same
    update.  Cells past n are 0: the update only reads to the left."""
    n = x.shape[0]
    c = torch.zeros(-(-n // tile) * tile)
    c[:n] = x
    c = c.reshape(-1, tile)
    three = torch.tensor(3.0)
    ghost = x[:1].reshape(1, 1)
    for _ in range(t_steps):
        ext = torch.cat([torch.cat([ghost.expand(1, 2), c[:-1, -2:]]), c], 1)
        ghost = (ghost + ghost + ghost) / three
        c = (ext[:, :-2] + ext[:, 1:-1] + ext[:, 2:]) / three
    return c.reshape(-1)[:n]


@pytest.mark.parametrize("n,t_steps,widths", [
    (1024, 16, (64, 256)), (2048, 61, (64, 512)), (768, 0, (16, 256))])
def test_jacobi_skewed_buffer_does_not_depend_on_width(n, t_steps, widths):
    """The fact that lets the CUDA kernel tile by its own width: the skewed
    buffer is the same at every chunk width W.  The reference's Pallas
    kernel in interpret mode gives bit-identical buffers at two widths,
    within 1e-5 of the port's plain version (not bit-identical: under jit,
    XLA on the CPU divides by 3 as a multiply by 1/3, where the port keeps
    the IEEE quotient); and the kernel's algorithm, emulated at the two
    widths, at its own 32-cell lanes and 4096-cell blocks, and with a
    ragged last tile, is bit-identical to the plain version."""
    rng = np.random.default_rng(n + t_steps)
    x = rng.standard_normal(n).astype(np.float32)
    x[0] = _evolving_ghost(rng)
    ys = [np.asarray(jjm.jacobi_chunked(jnp.asarray(x), t_steps=t_steps,
                                        width=w, interpret=True))
          for w in widths]
    assert np.array_equal(ys[0], ys[1])
    plain = jacobi_mars.jacobi_chunked_plain(_cpu(x), t_steps, widths[0])
    assert np.abs(_np(plain) - ys[0]).max() < 1e-5
    for tile in (*widths, 32, 4096, 48):
        got = _tiled_jacobi(_cpu(x), t_steps, tile)
        assert torch.equal(got, plain), tile


@pytest.mark.parametrize("n,width,t_steps", [(100, 8, 6), (64, 64, 62)])
def test_jacobi_chunked_asserts(n, width, t_steps):
    x = torch.zeros(n)
    with pytest.raises(ValueError):
        jacobi_mars.jacobi_chunked(x, t_steps, width)


# -- analytic byte models and obs series ---------------------------------------

@pytest.mark.parametrize("n,block,bits", [(8, 128, 4), (1 << 18, 256, 8), (3, 32, 32)])
def test_io_bytes_equal(n, block, bits):
    assert ops.pack_io_bytes(n, block, bits) == jops.pack_io_bytes(n, block, bits)
    assert ops.unpack_io_bytes(n, block, bits) == jops.unpack_io_bytes(n, block, bits)
    assert ops.jacobi_io_bytes(n * block) == jops.jacobi_io_bytes(n * block)
    assert ops.BEAT_BYTES == jops.BEAT_BYTES


def test_obs_series_equal_reference():
    """Same kernels/* counters, names, labels and values as the reference."""
    rng = np.random.default_rng(3)
    q = np.cumsum(rng.integers(-3, 4, size=(8, 128)), axis=1).astype(np.int32)
    x = rng.standard_normal(1024).astype(np.float32)
    with jobs.enabled_scope() as (jreg, _):
        jp = jops.pack_codes(jnp.asarray(q), 6, use_pallas="ref")
        jops.unpack_codes(jp, 6, 128, use_pallas="ref")
        jops.jacobi1d_tiled(jnp.asarray(x), 8, width=256, use_pallas="ref")
    with tobs.enabled_scope() as (treg, trc):
        tp = ops.pack_codes(_cpu(q), 6)
        ops.unpack_codes(tp, 6, 128)
        ops.jacobi1d_tiled(_cpu(x), 8, width=256)
    assert treg.snapshot().counters == jreg.snapshot().counters
    assert [r.name for r in trc.records] == [
        "kernels/pack", "kernels/unpack", "kernels/jacobi1d"]


# -- backends ----------------------------------------------------------------

@pytest.mark.parametrize("entry", ["pack", "unpack", "jacobi"])
def test_cuda_backend_on_cpu_tensor_raises(entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "pack":
            ops.pack_codes(torch.zeros(8, 64, dtype=torch.int32), 8, backend="cuda")
        elif entry == "unpack":
            ops.unpack_codes(torch.zeros(8, 16, dtype=torch.int32), 8, 64,
                             backend="cuda")
        else:
            ops.jacobi1d_tiled(torch.zeros(256), 4, width=64, backend="cuda")


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        ops.pack_codes(torch.zeros(8, 64, dtype=torch.int32), 8, backend="pallas")


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    q = torch.zeros(8, 64, dtype=torch.int32)
    ops.unpack_codes(ops.pack_codes(q, 8), 8, 64)
    bitplane.unpack(bitplane.pack(q, 8), 8, 64)
    ops.jacobi1d_tiled(torch.zeros(256), 4, width=64)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


@pytest.mark.parametrize("bits,block", [(0, 64), (33, 64), (8, 48)])
def test_kernel_wrapper_rejects_bad_shapes(bits, block):
    with pytest.raises(ValueError):
        bitplane.pack(torch.zeros(4, block, dtype=torch.int32), bits)


# -- the port stands alone ------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py",
     *(ROOT / "examples").glob("torch_*.py")]))
def test_port_imports_no_jax_or_repro(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(src), path
    assert "__import__(" not in src and "importlib" not in src, path
