"""Port parity: ``audiocodecs_tpu_torch.quant.fsq`` against the JAX package's
``quant/fsq.py`` on the same numpy arrays, on the CPU.

The lattices of the zoo: NanoCodec's (8, 8, 8, 8), X-Codec 2.0's (4,)×8
(65,536 codes), StableCodec's (6,)×6, (5,)×6 and (3,)×6. ``fsq_bound``
(tanh) agrees to an ulp or two, not bit for bit: XLA's and PyTorch's tanh
round differently. Everything after it is exact: the rounding on the
bounded latents, the mixed-radix indices of every code and back, the
implicit codebook. The arrays hold exact half-steps: latents whose bound
lands on m + ½ in both packages, which both round half to even.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocodecs_tpu.quant import fsq as J
from audiocodecs_tpu_torch.quant import fsq as T
from zoo_pairs import one_thread  # noqa: F401 (autouse)

LATTICES = [(8, 8, 8, 8), (4,) * 8, (6,) * 6, (5,) * 6, (3,) * 6]


def _half_step_latents(levels):
    """Latents whose bound is an exact half-step in both packages: for each
    half-step t of each dimension, float32 neighbours of the latent that
    maps to t, kept where both bounds equal t. ``[n, D]``."""
    L = np.asarray(levels, np.float64)
    half_l = (L - 1) * 1.001 / 2
    offset = np.where(L % 2 == 0, 0.5, 0.0)
    shift = np.arctanh(offset / half_l)
    rows, targets = [], []
    for d in range(len(levels)):
        for t in np.arange(-np.floor(half_l[d]), np.floor(half_l[d]) + 1) \
                - 0.5:
            y = (t + offset[d]) / half_l[d]
            if abs(y) >= 1:
                continue
            z0 = np.float32(np.arctanh(y) - shift[d])
            z = np.zeros((513, len(levels)), np.float32)
            z[:, d] = z0 + np.arange(-256, 257, dtype=np.float32) * \
                np.spacing(z0)
            jb = np.asarray(J.fsq_bound(jnp.asarray(z), levels))[:, d]
            tb = T.fsq_bound(torch.from_numpy(z), levels).numpy()[:, d]
            hit = (jb == t) & (tb == t)
            rows.append(z[hit])
            targets += [t] * int(hit.sum())
    return np.concatenate(rows), np.asarray(targets, np.float32)


@pytest.mark.parametrize("levels", LATTICES, ids=str)
def test_quantize_bit_exact_with_half_steps(rng, levels):
    D = len(levels)
    z = (rng.standard_normal((4, 50, D)) * 2).astype(np.float32)
    jb = np.asarray(J.fsq_bound(jnp.asarray(z), levels))
    tb = T.fsq_bound(torch.from_numpy(z), levels).numpy()
    np.testing.assert_allclose(tb, jb, rtol=0, atol=4e-7 * max(levels))
    half, targets = _half_step_latents(levels)
    if levels != (3,) * 6:  # its tanh puts no half-step on a float both hit
        assert len(half) >= 8
    arrays = [z.reshape(-1, D)]
    if len(half):
        arrays.append(half)
        # half to even: the bound's half-step t rounds to the even neighbour
        hw = (np.asarray(levels) // 2).astype(np.float32)
        got = T.fsq_quantize(torch.from_numpy(half), levels).numpy()
        dims = np.argmax(half != 0, axis=1)
        want = np.round(targets) / hw[dims]  # numpy rounds half to even
        np.testing.assert_array_equal(got[np.arange(len(half)), dims], want)
    allz = np.concatenate(arrays)
    jq = np.asarray(J.fsq_quantize(jnp.asarray(allz), levels))
    tq = T.fsq_quantize(torch.from_numpy(allz), levels)
    np.testing.assert_array_equal(tq.numpy(), jq)
    ji = np.asarray(J.fsq_codes_to_indices(jnp.asarray(jq), levels))
    ti = T.fsq_codes_to_indices(tq, levels)
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), ji)


@pytest.mark.parametrize("levels", LATTICES, ids=str)
def test_every_index_and_the_implicit_codebook(levels):
    """All ∏levels tokens to codes and back, in int64, against JAX."""
    total = int(np.prod(levels))
    idx = np.arange(total, dtype=np.int32)
    jc = np.asarray(J.fsq_indices_to_codes(jnp.asarray(idx), levels))
    tc = T.fsq_indices_to_codes(torch.arange(total), levels)
    assert tc.dtype == torch.float32 and tc.shape == (total, len(levels))
    np.testing.assert_array_equal(tc.numpy(), jc)
    back = T.fsq_codes_to_indices(tc, levels)
    np.testing.assert_array_equal(back.numpy(), np.arange(total))
    np.testing.assert_array_equal(T.fsq_implicit_codebook(levels),
                                  J.fsq_implicit_codebook(levels))
    np.testing.assert_array_equal(T.fsq_implicit_codebook(levels), jc)


def test_the_largest_lattice_stays_exact_in_int64():
    """(4,)×8: the last code's index is 65,535, and a token tensor of any
    integer dtype decodes the same."""
    levels = (4,) * 8
    codes = torch.ones(1, 8) * 0.5  # digit 3 everywhere
    assert int(T.fsq_codes_to_indices(codes, levels)) == 4 ** 8 - 1
    for dtype in (torch.int32, torch.int64):
        got = T.fsq_indices_to_codes(torch.tensor([65535], dtype=dtype),
                                     levels)
        assert torch.equal(got, codes)
