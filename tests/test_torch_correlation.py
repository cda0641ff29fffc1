"""The port's cost volume against the JAX package's.

On a CPU tensor ``local_correlation`` runs its plain version; it is held
to the JAX XLA formulation and to the JAX Pallas kernel in interpret
mode, on the cases of tests/test_pallas_correlation.py (ragged H and W
and the zero-padding case included). Tolerances: fp32 1e-5 (the same
products, summed in another order); bf16 outputs 1e-2 (both sides round
each product to bf16 and sum in fp32, so they differ by the sum order
and one final bf16 rounding, about one ulp of values below 1).
The kernel itself runs only on the card; its cases skip here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_tpu.ops.correlation import local_correlation as jax_local_correlation
from video_features_tpu.ops.pallas.correlation_kernel import local_correlation_pallas
from video_features_tpu_torch.ops.correlation import (
    local_correlation,
    local_correlation_reference,
)
from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel

ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SHAPES = [
    (2, 16, 16, 24),  # H a multiple of the Pallas tile
    (1, 8, 13, 17),  # ragged H and W
    (1, 32, 8, 8),  # one tile
    (2, 64, 16, 16),
    (2, 64, 32, 32),
    (2, 32, 64, 64),  # PWC's level 2 extent
]


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def _as(dtype, *arrays):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_xla_and_pallas(shape, dtype):
    f1, f2 = _pair(shape)
    t1, t2 = _as(dtype, f1, f2)
    out = local_correlation(t1, t2)
    assert out.dtype == dtype and out.shape == (shape[0], 81, shape[2], shape[3])
    j1, j2 = (jnp.asarray(t.float().numpy(), JNP[dtype]) for t in (t1, t2))
    xla = np.asarray(jax_local_correlation(j1, j2, method="xla").astype(jnp.float32))
    pallas = np.asarray(local_correlation_pallas(j1, j2, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), xla, atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=ATOL[dtype], rtol=0)


def test_zero_padding_semantics():
    """Displacements that land outside f2 add exact zeros."""
    ones = torch.ones((1, 4, 8, 8))
    out = local_correlation(ones, ones)
    assert out[0, 0, 0, 0] == 0.0  # (dy, dx) = (-4, -4) at (0, 0) reads f2[-4, -4]
    assert out[0, 0, 4, 4] == 1.0
    torch.testing.assert_close(out[0, 40], torch.ones(8, 8))  # (0, 0) everywhere
    ref = np.asarray(local_correlation_pallas(jnp.ones((1, 4, 8, 8)), jnp.ones((1, 4, 8, 8)),
                                              interpret=True))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_plain_method_and_routing():
    t1, t2 = _as(torch.float32, *_pair((1, 8, 5, 7), seed=1))
    torch.testing.assert_close(local_correlation(t1, t2, method="plain"),
                               local_correlation_reference(t1, t2), rtol=0, atol=0)
    with pytest.raises(ValueError, match="method"):
        local_correlation(t1, t2, method="pallas")
    # other displacements go to the plain version on the CPU
    assert local_correlation(t1, t2, max_displacement=2).shape == (1, 25, 5, 7)


def test_kernel_wrapper_rejects_what_it_cannot_launch():
    t1, t2 = _as(torch.float32, *_pair((1, 8, 5, 7), seed=2))
    before = local_correlation_kernel.launches
    # a tensor off the card launches the kernel or raises: never the plain path
    with pytest.raises(ValueError, match="CUDA"):
        local_correlation_kernel(t1, t2)
    with pytest.raises(ValueError, match="CUDA"):
        local_correlation(t1.to("meta"), t2.to("meta"))
    assert local_correlation_kernel.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((64, 32, 64, 96), torch.float32),  # level 2 of the I3D main path
        ((64, 196, 4, 6), torch.float32),  # level 6
        ((4, 32, 67, 121), torch.float32),  # ragged H and W
        ((64, 32, 64, 96), torch.bfloat16),
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    rng = np.random.default_rng(7)
    f1, f2 = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda_device, dtype)
              for _ in range(2))
    before = local_correlation_kernel.launches
    out = local_correlation(f1, f2)
    torch.cuda.synchronize()
    assert local_correlation_kernel.launches == before + 1
    ref = local_correlation_reference(f1, f2)
    assert (out.float() - ref.float()).abs().max().item() <= ATOL[dtype]
    with pytest.raises(ValueError, match="displacement"):
        local_correlation_kernel(f1, f2, max_displacement=3)
