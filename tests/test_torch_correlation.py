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
from video_features_tpu_torch.ops.correlation_kernel import (
    MAX_THREADS,
    SEGMENT,
    SMEM_MAX,
    launch_shape,
    local_correlation_kernel,
    staged_layout,
)

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


# PWC's five levels on the I3D main path (64 pairs), the ragged case of
# chip_smoke.py, a 1x1 plane and two small odd shapes
LAUNCH_SHAPES = [
    (64, 32, 64, 96), (64, 64, 32, 48), (64, 96, 16, 24), (64, 128, 8, 12), (64, 196, 4, 6),
    (64, 32, 67, 121), (1, 8, 1, 1), (3, 5, 13, 17), (2, 300, 2, 3),
]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", LAUNCH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_shape_covers_each_output_once_within_limits(shape, itemsize):
    """The kernel's tiles and thread map (csrc/local_correlation.cu), walked
    here in Python: each (pair, dy, y, x) output is stored by exactly one
    thread, each channel is summed by exactly one (chunk, group) slot, and
    threads, shared memory and TMA box depth stay within the card's limits."""
    n, c, h, w = shape
    ls = launch_shape(n, c, h, w, itemsize)
    assert ls.tile_w % SEGMENT == 0 and 1 <= ls.tile_h and ls.splits >= 1 and ls.chunk >= 1
    seg_row = ls.tile_w // SEGMENT
    per_split = 9 * ls.tile_h * seg_row
    assert ls.threads == per_split * ls.splits and 1 <= ls.threads <= MAX_THREADS
    assert ls.smem_bytes <= SMEM_MAX and ls.splits * ls.chunk <= 256
    tiles_w, tiles_h = -(-w // ls.tile_w), -(-h // ls.tile_h)
    assert ls.tiles == (tiles_w * tiles_h, n) and n * tiles_w * tiles_h < 2 ** 31

    stored = np.zeros((9, h, w), np.int64)  # one pair: the tiles repeat per pair
    for t in range(tiles_w * tiles_h):
        y0, x0 = (t // tiles_w) * ls.tile_h, (t % tiles_w) * ls.tile_w
        for lt in range(per_split):  # group 0 stores
            seg, r, dy = lt % seg_row, (lt // seg_row) % ls.tile_h, lt // (seg_row * ls.tile_h)
            y, x = y0 + r, x0 + seg * SEGMENT
            if y < h and x < w:
                stored[dy, y, x:min(x + SEGMENT, w)] += 1
    np.testing.assert_array_equal(stored, 1)

    summed = np.zeros(c, np.int64)
    per_stage = ls.splits * ls.chunk
    for k in range(-(-c // per_stage)):
        for split in range(ls.splits):
            c0 = k * per_stage + split * ls.chunk
            summed[c0:c0 + max(0, min(ls.chunk, c - c0))] += 1
    np.testing.assert_array_equal(summed, 1)

    if ls.staging != "planes":  # staged rows start on 16 bytes (TMA boxes, vector loads)
        f1_chan, f2_chan = staged_layout(h, w, ls.tile_h, ls.tile_w, itemsize, ls.staging)
        assert (f1_chan // ls.tile_h * itemsize) % 16 == 0
        assert (f2_chan // (ls.tile_h + 8) * itemsize) % 16 == 0


def test_launch_shape_of_the_main_path():
    """The stagings PWC's levels take: the copy engine's boxes for rows of
    16-byte multiples, one bulk copy of whole planes at level 6."""
    stagings = [launch_shape(64, c, h, w, 4).staging
                for c, h, w in [(32, 64, 96), (64, 32, 48), (96, 16, 24), (128, 8, 12), (196, 4, 6)]]
    assert stagings == ["tensor"] * 4 + ["planes"]
    assert launch_shape(64, 32, 67, 121, 4).staging == "copies"


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((64, 32, 64, 96), torch.float32),  # level 2 of the I3D main path
        ((64, 196, 4, 6), torch.float32),  # level 6
        ((4, 32, 67, 121), torch.float32),  # ragged H and W
        ((64, 32, 64, 96), torch.bfloat16),
        ((8, 196, 4, 6), torch.bfloat16),  # W=6: rows of 12 bytes, whole planes
        ((8, 128, 8, 12), torch.bfloat16),  # rows of 24 bytes: cp.async copies
        ((4, 32, 5, 6), torch.float32),  # W=6 rows of 24 bytes, tiled
        ((4, 16, 9, 7), torch.bfloat16),  # odd W: plain 2-byte copies
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


@pytest.mark.cuda
def test_kernel_shapes_in_turns_on_card(cuda_device):
    """A kernel's shared-memory limit is one value per device: launches of
    a larger, a smaller and the larger shape again (PWC's levels of a
    320-wide clip, fp32: three share one kernel) all run."""
    rng = np.random.default_rng(8)
    for shape in [(8, 32, 64, 80), (8, 96, 16, 20), (8, 64, 32, 40), (8, 32, 64, 80)]:
        f1, f2 = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda_device)
                  for _ in range(2))
        out = local_correlation_kernel(f1, f2)
        torch.cuda.synchronize()
        assert (out - local_correlation_reference(f1, f2)).abs().max().item() <= ATOL[torch.float32]
