"""The port's two kernel wrappers (uslam_tpu_torch/frontend/kernels.py)
against the JAX package's Pallas kernels and XLA oracles.

On the CPU each wrapper runs its plain PyTorch version; those are held here
to the Pallas kernels in interpret mode (as tests/test_pallas_kernels.py
runs them) and to ``fast.fast_corners`` / ``harris_response`` /
``match.hamming_distance_matrix``. The CUDA kernels themselves are held to
the plain versions by the tests marked ``cuda``, which skip without a GPU
(and by chip_smoke.py on the card).

Tolerances: corners and Hamming distances are integers and must agree
exactly. Harris is compared on pixels at least 5 px inside the border
(the three versions treat borders differently: wrap, edge-pad + roll,
clamp) within 2e-5 * max|R|, the JAX package's tolerance for its own
kernel (jit fusion may contract multiply-adds, so bit equality with XLA is
not promised).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_frontend import textured_image
from uslam_tpu.frontend.fast import fast_corners, harris_response
from uslam_tpu.frontend.match import hamming_distance_matrix
from uslam_tpu.frontend.pallas_kernels import fast_harris_pallas, hamming_matrix_pallas
from uslam_tpu_torch.frontend import kernels
from uslam_tpu_torch.solvers.eig import sym_eigh

MARGIN = 5
HARRIS_RTOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _interior(h, w):
    m = np.zeros((h, w), bool)
    m[MARGIN:-MARGIN, MARGIN:-MARGIN] = True
    return m


def _assert_harris_close(ours, ref):
    scale = np.abs(ref).max() + 1e-9
    np.testing.assert_allclose(ours / scale, ref / scale, rtol=0, atol=HARRIS_RTOL)


@pytest.mark.parametrize("shape", [(160, 256), (100, 128), (57, 90)])
def test_fast_harris_plain_matches_pallas(shape):
    h, w = shape
    imgs = np.stack([textured_image(h, w, seed=s) for s in (3, 5)])
    corner_p, harris_p = (np.asarray(a) for a in fast_harris_pallas(
        jnp.asarray(imgs), 10.0, tile_h=64, interpret=True))
    corner_t, harris_t = kernels.fast_harris(torch.from_numpy(imgs), 10.0)
    m = np.broadcast_to(_interior(h, w), imgs.shape)
    np.testing.assert_array_equal(corner_t.numpy().astype(bool)[m], corner_p.astype(bool)[m])
    assert corner_t.numpy()[m].sum() > 0
    _assert_harris_close(harris_t.numpy()[m], harris_p[m])


def test_fast_harris_plain_matches_xla_oracle():
    """Against the XLA reference itself: corners over the whole image
    (both mask the 3 px border), Harris on the interior."""
    img = textured_image(192, 256)
    corner_t, harris_t = kernels.fast_harris(torch.from_numpy(img)[None], 10.0)
    np.testing.assert_array_equal(
        corner_t.numpy()[0].astype(bool), np.asarray(fast_corners(jnp.asarray(img), 10.0))
    )
    m = _interior(192, 256)
    _assert_harris_close(harris_t.numpy()[0][m], np.asarray(harris_response(jnp.asarray(img)))[m])


def test_fast_harris_corners_are_bool_and_match_pallas():
    """Both the wrapper and the plain version return torch.bool corners,
    equal to the Pallas kernel's (interpret mode) on the interior."""
    imgs = np.stack([textured_image(64, 96, seed=s) for s in (3, 4)])
    corner_p, _ = fast_harris_pallas(jnp.asarray(imgs), 10.0, tile_h=64, interpret=True)
    m = np.broadcast_to(_interior(64, 96), imgs.shape)
    for corner, _ in (kernels.fast_harris(torch.from_numpy(imgs), 10.0),
                      kernels.fast_harris_plain(torch.from_numpy(imgs), 10.0)):
        assert corner.dtype == torch.bool
        np.testing.assert_array_equal(corner.numpy()[m], np.asarray(corner_p).astype(bool)[m])
        assert corner.numpy()[m].sum() > 0


def test_fast_harris_zero_image():
    """Ragged chunks are padded with zero images: no corners, zero Harris."""
    corner, harris = kernels.fast_harris(torch.zeros((2, 40, 64)), 10.0)
    assert int(corner.sum()) == 0 and float(harris.abs().max()) == 0.0


@pytest.mark.parametrize("sizes", [(70, 130), (48, 48), (1, 5)])
def test_hamming_plain_matches_pallas(sizes):
    na, nb = sizes
    rng = np.random.default_rng(na)
    da = rng.integers(0, 2**32, (3, na, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (3, nb, 8), dtype=np.uint32)
    ours = kernels.hamming(
        torch.from_numpy(da.view(np.int32)), torch.from_numpy(db.view(np.int32))
    ).numpy()
    for f in range(3):
        ref_p = hamming_matrix_pallas(jnp.asarray(da[f]), jnp.asarray(db[f]), tile=64, interpret=True)
        ref_x = hamming_distance_matrix(jnp.asarray(da[f]), jnp.asarray(db[f]))
        np.testing.assert_array_equal(ours[f], np.asarray(ref_p))
        np.testing.assert_array_equal(ours[f], np.asarray(ref_x))


def test_popcount32_bit_patterns():
    words = np.array(
        [0, -1, -(2**31), 2**31 - 1, 0x55555555, -0x55555556, 1, 0x0F0F0F0F], np.int64
    ).astype(np.int32)
    expect = [bin(int(w) & 0xFFFFFFFF).count("1") for w in words]
    assert kernels.popcount32(torch.from_numpy(words)).tolist() == expect


@pytest.mark.parametrize(
    "bad",
    [
        lambda: torch.zeros((2, 16, 16), dtype=torch.float64),
        lambda: torch.zeros((16, 16)),
        lambda: torch.zeros((2, 16, 32))[:, :, ::2],
    ],
)
def test_fast_harris_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        kernels.fast_harris(bad(), 10.0)


def test_hamming_rejects_bad_input():
    a = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.hamming(a, torch.zeros((3, 4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.hamming(a.to(torch.int64), a.to(torch.int64))


def test_plain_versions_do_not_count_launches():
    kernels.reset_launch_counts()
    kernels.fast_harris(torch.zeros((1, 16, 16)), 10.0)
    a = torch.zeros((1, 4, 8), dtype=torch.int32)
    kernels.hamming(a, a)
    sym_eigh(torch.eye(3))
    assert kernels.launch_counts == {"fast_harris": 0, "hamming": 0, "preintegrate": 0,
                                     "jacobi_eigh": 0, "graph_cond": 0}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(16, 270, 480), (3, 57, 90), (1, 71, 250), (1, 270, 480), (48, 270, 480)]
)
def test_fast_harris_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    imgs = torch.rand(shape, generator=gen, device=cuda) * 255.0
    before = kernels.launch_counts["fast_harris"]
    ck, hk = kernels.fast_harris(imgs, 10.0)
    cp, hp = kernels.fast_harris_plain(imgs, 10.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts["fast_harris"] == before + 1
    inner = (slice(None), slice(MARGIN, -MARGIN), slice(MARGIN, -MARGIN))
    assert ck.dtype == cp.dtype == torch.bool
    assert torch.equal(ck[inner], cp[inner])
    # Same float operations in the same order: expected bit-identical.
    assert torch.equal(hk[inner], hp[inner])


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(16, 48, 48), (8, 48, 37), (3, 70, 130)])
def test_hamming_kernel_matches_plain(cuda, sizes):
    b, na, nb = sizes
    gen = torch.Generator(device=cuda).manual_seed(1)
    da, db = (
        torch.randint(-2**31, 2**31 - 1, (b, n, 8), generator=gen, device=cuda, dtype=torch.int32)
        for n in (na, nb)
    )
    assert torch.equal(kernels.hamming(da, db), kernels.hamming_plain(da, db))
