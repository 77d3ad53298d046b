"""The GroupNorm statistics wrappers' plain twins against the JAX package,
and the launch geometry of their kernels, on the CPU.

``group_stats_plain`` (K1 with the forward's group algebra) is held against
the residuals and output of ``pallas_group_norm._fwd`` and
``group_grad_coeffs_plain`` (K2 with the backward's algebra) against
``_bwd``, both with the Pallas kernels in interpret mode, on the same numpy
inputs. fp32, tolerance 1e-4: f32 sums taken in another order.

The geometry tests replay the kernels' index arithmetic in numpy: every
(row, channel) of ``[N, M, C]`` is visited by exactly one thread, and the
grid and scratch stay within the kernels' limits at the paths' shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.ops.pallas_group_norm import _bwd, _fwd
from e_osvos_torch.ops import cuda_group_norm as kernels

EPS = 1e-6
TOL = 1e-4

# (N, M, C, G): ragged M (143 rows, 257 rows), C = 48, M = 1, N = 1, two
# channels a group (the Mask R-CNN stem's GroupNorm-32 at C = 64)
CASES = [(2, 143, 32, 4), (1, 257, 48, 16), (3, 1, 64, 16), (1, 90, 256, 16),
         (2, 37, 64, 32)]


def _inputs(n, m, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, m, c) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.randn(c) * 0.5).astype(np.float32)
    dy = rng.randn(n, m, c).astype(np.float32)
    return x, scale, bias, dy


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("n,m,c,g", CASES)
def test_group_stats_twin_matches_pallas_fwd(n, m, c, g):
    """mean/rstd against ``_fwd``'s residuals, a/b against the coefficients
    computed from them, y = x·a + b against ``_fwd``'s output."""
    x, scale, bias, _ = _inputs(n, m, c, 10 + c)
    y_j, (_, _, mean_j, rstd_j) = _fwd(jnp.asarray(x), jnp.asarray(scale),
                                       jnp.asarray(bias), g, EPS, True)
    a, b, mean, rstd = kernels.group_stats_plain(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        g, EPS)
    assert a.shape == b.shape == (n, c) and mean.shape == rstd.shape == (n, g)
    _close(mean, mean_j)
    _close(rstd, rstd_j)
    a_j = np.repeat(np.asarray(rstd_j), c // g, 1) * scale
    _close(a, a_j)
    _close(b, bias - np.repeat(np.asarray(mean_j), c // g, 1) * a_j)
    _close(kernels.affine_apply_plain(torch.from_numpy(x), a, b), y_j)


@pytest.mark.parametrize("n,m,c,g", CASES)
def test_group_grad_coeffs_twin_matches_pallas_bwd(n, m, c, g):
    """dx through ``affine_dx_plain(A, B, D)``, dgamma and dbeta against
    ``_bwd`` on ``_fwd``'s residuals."""
    x, scale, bias, dy = _inputs(n, m, c, 20 + c)
    _, res = _fwd(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), g,
                  EPS, True)
    dx_j, dgamma_j, dbeta_j = _bwd(g, EPS, True, res, jnp.asarray(dy))
    mean = torch.from_numpy(np.array(res[2]))
    rstd = torch.from_numpy(np.array(res[3]))
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    A, B, D, dgamma, dbeta = kernels.group_grad_coeffs_plain(
        dyt, xt, torch.from_numpy(scale), mean, rstd, g)
    assert A.shape == B.shape == D.shape == (n, c)
    _close(kernels.affine_dx_plain(dyt, xt, A, B, D), dx_j)
    _close(dgamma, dgamma_j)
    _close(dbeta, dbeta_j)


def test_wrappers_take_twins_on_cpu_and_check_groups():
    x, scale, bias, dy = (torch.from_numpy(t) for t in _inputs(2, 9, 24, 3))
    kernels.reset_launch_counts()
    got = kernels.group_stats(x, scale, bias, 4, EPS)
    for t, w in zip(got, kernels.group_stats_plain(x, scale, bias, 4, EPS)):
        assert torch.equal(t, w)
    _, _, mean, rstd = got
    got = kernels.group_grad_coeffs(dy, x, scale, mean, rstd, 4)
    want = kernels.group_grad_coeffs_plain(dy, x, scale, mean, rstd, 4)
    for t, w in zip(got, want):
        assert torch.equal(t, w)
    assert kernels.launch_counts() == {k: 0 for k in kernels.WRAPPERS}
    with pytest.raises(ValueError):
        kernels.group_stats(x, scale, bias, 5, EPS)
    with pytest.raises(ValueError):
        kernels.group_grad_coeffs(dy, x, scale, mean, rstd, 7)


# ---- launch geometry -----------------------------------------------------

# (N, M, C, G): the DeepLab decoder at batches 3/4/5, the Mask R-CNN
# backbone's GroupNorm-32 (stem at batch 3 to layer4), the edge shapes of
# chip_smoke.py, and C not a multiple of the vector width
PATH_SHAPES = [(3, 25680, 256, 16), (4, 25680, 256, 16), (5, 25680, 256, 16),
               (3, 102480, 64, 32), (3, 405, 2048, 32), (1, 1620, 1024, 32),
               (4, 6420, 512, 32), (3, 25680, 48, 16), (3, 1, 256, 16),
               (2, 1000, 256, 16), (1, 777, 48, 16), (2, 129, 36, 4),
               (1, 50, 30, 5)]


def _visits(t, m, c):
    """How often the kernels' threads of one image visit each (row,
    channel): the Sweep arithmetic of csrc/group_norm.cu in numpy."""
    counts = np.zeros((m, c), np.int32)
    step = kernels.THREADS // t.lanes
    for chunk in range(t.chunks):
        m_end = min((chunk + 1) * t.rows_per_chunk, m)
        for cs in range(t.cslices):
            vecs = cs * t.lanes + np.arange(t.lanes)
            vecs = vecs[vecs < c // t.vec]
            chans = (vecs[:, None] * t.vec + np.arange(t.vec)).ravel()
            for row_lane in range(step):
                rows = np.arange(chunk * t.rows_per_chunk + row_lane, m_end,
                                 step)
                counts[np.ix_(rows, chans)] += 1
    return counts


@pytest.mark.parametrize("min_rows", [kernels.MIN_CHUNK_ROWS, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,m,c,g", PATH_SHAPES)
def test_sweep_tiling_covers_every_element_once(n, m, c, g, dtype, min_rows):
    """The partial-sums tiling (``MIN_CHUNK_ROWS``) and the elementwise one
    (any chunk)."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    for aligned in (True, False):
        t = kernels.sweep_tiling(n, m, c, itemsize, aligned, min_rows)
        wide = 16 // itemsize
        assert t.vec == (wide if aligned and c % wide == 0 else 1)
        assert t.lanes & (t.lanes - 1) == 0 and t.lanes <= kernels.MAX_LANES
        rows = t.rows_per_chunk
        assert (t.chunks - 1) * rows < m <= t.chunks * rows
        assert t.rows_per_chunk % (kernels.THREADS // t.lanes) == 0
        # the grid: at most one wave of BLOCKS_PER_SM blocks an SM unless
        # one chunk an image and slice already exceeds it; CUDA's limits
        blocks = t.chunks * t.cslices * n
        target = kernels.BLOCKS_PER_SM * kernels.H100_SMS
        assert blocks <= max(target, n * t.cslices)
        assert t.chunks < 2**31 and t.cslices <= 65535 and n <= 65535
        # the scratch of partial sums: [N, chunks, C] f32 pairs
        scratch = n * t.chunks * c * 8
        assert scratch <= 8 * c * max(target, n)
        assert t.chunks == 1 or t.rows_per_chunk >= min_rows
        if m * c <= 300_000:  # the full replay at the small shapes
            assert (_visits(t, m, c) == 1).all()
    if m >= 25680:  # the big path shapes fill the card in one wave or so
        t = kernels.sweep_tiling(n, m, c, itemsize, True, min_rows)
        assert t.chunks * t.cslices * n >= kernels.H100_SMS * 2


@pytest.mark.parametrize("n,m,c,g", PATH_SHAPES)
def test_finalize_tiling_covers_whole_groups(n, m, c, g):
    """Whole groups a block, about FINALIZE_CHANNELS channels, shared
    memory within its limit; the blocks the C side launches cover G."""
    gpb = kernels.finalize_groups(c, g)
    gs = c // g
    blocks = -(-g // gpb)
    assert 1 <= gpb <= g and (blocks - 1) * gpb < g <= blocks * gpb
    assert gpb * gs <= max(kernels.FINALIZE_CHANNELS, gs)
    assert (2 * gpb * gs + 4 * gpb) * 4 <= kernels.MAX_FINALIZE_SMEM


def test_sweep_tiling_replays_the_stem_and_decoder():
    """The replay at a full path shape, one image: the Mask R-CNN stem's
    [*, 102480, 64] and the decoder's [*, 25680, 256] in bf16."""
    for m, c in ((102480, 64), (25680, 256)):
        t = kernels.sweep_tiling(3, m, c, 2, True, kernels.MIN_CHUNK_ROWS)
        assert t.vec == 8
        assert (_visits(t, m, c) == 1).all()


def test_finalize_tiling_rejects_groups_past_shared_memory():
    with pytest.raises(ValueError):
        kernels.finalize_groups(8192, 1)


def test_geometry_fields_match_the_c_struct():
    """The kernels read the Python ``Geometry`` as the C struct of
    csrc/group_norm.cu: the same int fields in the same order."""
    import re
    from pathlib import Path

    src = (Path(kernels.cuda_build.CSRC) / "group_norm.cu").read_text()
    body = re.search(r"struct Geometry \{(.*?)\n\n", src, re.S).group(1)
    fields = [f.strip() for decl in re.findall(r"int ([^;]+);", body)
              for f in decl.split(",")]
    py = {"n": "N", "m": "M", "c": "C", "g": "G"}
    assert fields == [py.get(f, f) for f in kernels.Geometry._fields]
