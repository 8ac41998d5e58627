"""Port of the streaming matmul: the plain PyTorch versions in
``repro_torch.kernels.stream_matmul`` against the JAX package's Pallas kernel
(interpret mode) and its pure-jnp oracle, on the cases of
tests/test_kernels.py, plus the meta-device dispatch admission relies on.
The CUDA kernel is held against the plain versions on the card in
tests/test_torch_cuda.py.

Tolerance, as in tests/test_kernels.py: atol tol * sqrt(k), rtol tol, with
tol 2e-4 in float32 and 2e-2 in bfloat16 (summation order; bf16 rounds the
output once); the batched paper sizes at 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import launches, ops
from repro_torch.kernels import stream_matmul as tmm

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(16, 16, 16), (32, 32, 32),
                                   (128, 128, 128), (200, 300, 150),
                                   (129, 257, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_reference(m, k, n, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(m + k + n)
    a, b = _normal(rng, (m, k)), _normal(rng, (k, n))
    ta = torch.from_numpy(a).to(tdt)
    tb = torch.from_numpy(b).to(tdt)
    got = tmm.matmul_ref(ta, tb)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    for force in ("interpret", "ref"):
        ref = jops.matmul(ja, jb, force=force)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=tol * k ** 0.5, rtol=tol)


@pytest.mark.parametrize("size", [16, 32])
def test_matmul_batched_plain_paper_sizes(size):
    """The paper's workload: a G = 64 block of a 16x16 / 32x32 stream."""
    rng = np.random.default_rng(size)
    a = _normal(rng, (64, size, size))
    b = _normal(rng, (64, size, size))
    got = tmm.matmul_batched_ref(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()
    for force in ("interpret", "ref"):
        ref = jops.matmul_batched(a, b, force=force)
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)


def test_ops_dispatch_cpu_and_meta():
    """CPU tensors take the plain version and launch nothing; meta tensors
    give an empty meta result of the output's shape and dtype, and a shape
    that does not chain raises; other devices raise."""
    launches.reset()
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_normal(rng, (4, 16, 16)))
    b = torch.from_numpy(_normal(rng, (4, 16, 16)))
    assert torch.equal(ops.matmul_batched(a, b), tmm.matmul_batched_ref(a, b))
    assert torch.equal(ops.matmul(a[0], b[0]), tmm.matmul_ref(a[0], b[0]))
    assert all(n == 0 for n in launches.values())
    ma = torch.empty((100, 32, 32), dtype=torch.bfloat16, device="meta")
    out = ops.matmul_batched(ma, ma)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert tuple(out.shape) == (100, 32, 32)
    out = ops.matmul(torch.empty((129, 257), device="meta"),
                     torch.empty((257, 65), device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (129, 65)
    with pytest.raises(RuntimeError):
        ops.matmul(torch.empty((4, 5), device="meta"),
                   torch.empty((4, 5), device="meta"))
    assert all(n == 0 for n in launches.values())


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper given CPU tensors raises; it never falls back."""
    a = torch.ones((2, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmm.stream_matmul_batched_cuda(a, a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmm.stream_matmul_cuda(a[0], a[0])
