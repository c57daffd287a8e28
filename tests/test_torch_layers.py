"""Port parity: ``audiocodecs_tpu_torch.nn.layers`` against the JAX package's
``nn.layers`` on the same numpy inputs (CPU, fp32).

Layouts differ by design: the JAX package is channel-last with conv weights
``[K, Cin, Cout]`` (transposed convs pre-flipped); the port is ``[B, C, T]``
with PyTorch's weights. Tolerance 1e-6: the same fp32 sums in another order.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocodecs_tpu.nn import layers as jl
from audiocodecs_tpu_torch.nn import layers as tl

ATOL = 1e-6


def _btc_to_bct(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def _bct_to_btc(t):
    return t.numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("K,stride,dilation", [(7, 1, 1), (4, 2, 1),
                                               (3, 1, 2), (10, 5, 1)])
def test_conv1d(rng, K, stride, dilation):
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    w = rng.standard_normal((K, 6, 5)).astype(np.float32) * 0.3
    b = rng.standard_normal(5).astype(np.float32)
    want = jl.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=stride, dilation=dilation)
    got = tl.conv1d(_btc_to_bct(x), torch.from_numpy(w.transpose(2, 1, 0)),
                    torch.from_numpy(b), stride=stride, dilation=dilation)
    np.testing.assert_allclose(_bct_to_btc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("K,stride", [(16, 8), (4, 2), (10, 5), (3, 1)])
def test_conv_transpose1d_preflip(rng, K, stride):
    """The JAX weight is stored pre-flipped; the port's is PyTorch's."""
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((K, 6, 4)).astype(np.float32) * 0.3
    b = rng.standard_normal(4).astype(np.float32)
    want = jl.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=stride)
    w_port = np.ascontiguousarray(np.flip(w, 0).transpose(1, 2, 0))
    got = tl.conv_transpose1d(_btc_to_bct(x), torch.from_numpy(w_port),
                              torch.from_numpy(b), stride=stride)
    assert got.shape[-1] == (9 - 1) * stride + K
    np.testing.assert_allclose(_bct_to_btc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mode", ["reflect", "constant", "replicate"])
@pytest.mark.parametrize("T,left,right", [(10, 2, 3), (3, 6, 0), (1, 2, 2),
                                          (4, 0, 4), (5, 5, 1)])
def test_pad1d(rng, mode, T, left, right):
    """Includes length ≤ pad, where reflect zero-extends first."""
    x = rng.standard_normal((2, T, 3)).astype(np.float32)
    want = jl.pad1d(jnp.asarray(x), left, right, mode=mode)
    got = tl.pad1d(_btc_to_bct(x), left, right, mode=mode)
    np.testing.assert_array_equal(_bct_to_btc(got), np.asarray(want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,K,stride,dilation", [(37, 7, 1, 1), (37, 8, 4, 1),
                                                 (50, 3, 1, 3), (11, 10, 5, 1),
                                                 (3, 7, 1, 1)])
def test_causal_conv1d(rng, causal, T, K, stride, dilation):
    """Left padding plus the right extra padding to a whole frame count."""
    x = rng.standard_normal((2, T, 4)).astype(np.float32)
    w = rng.standard_normal((K, 4, 5)).astype(np.float32) * 0.3
    b = rng.standard_normal(5).astype(np.float32)
    want = jl.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            stride=stride, dilation=dilation, causal=causal,
                            pad_mode="reflect")
    got = tl.causal_conv1d(_btc_to_bct(x),
                           torch.from_numpy(w.transpose(2, 1, 0).copy()),
                           torch.from_numpy(b), stride=stride,
                           dilation=dilation, causal=causal, pad_mode="reflect")
    np.testing.assert_allclose(_bct_to_btc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("length,k,stride", [(100, 7, 1), (101, 8, 4),
                                             (12000, 16, 8), (5, 10, 5)])
def test_frame_arithmetic(length, k, stride):
    assert tl.extra_padding_for_frames(length, k, stride, k - stride) == \
        jl.extra_padding_for_frames(length, k, stride, k - stride)
    assert tl.streaming_conv_frames(length, k, stride) == \
        jl.streaming_conv_frames(length, k, stride)


def test_elu_uses_expm1(rng):
    x = np.concatenate([rng.standard_normal(64).astype(np.float32),
                        np.float32([-1e-7, -3e-4, 0.0, 5e-8])])
    want = np.asarray(jl.elu(jnp.asarray(x)))
    got = tl.elu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_exact_fp32_nests_and_restores_across_threads():
    """TF32 stays off while any caller is inside; the last one out restores
    the caller's settings (the switches are process-wide)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    inside, release = threading.Event(), threading.Event()

    def hold():
        with tl.exact_fp32():
            inside.set()
            release.wait(timeout=30)

    worker = threading.Thread(target=hold)
    try:
        with tl.exact_fp32():
            with tl.exact_fp32():
                assert not cudnn.allow_tf32 and not matmul.allow_tf32
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
        assert cudnn.allow_tf32 and matmul.allow_tf32
        worker.start()
        assert inside.wait(timeout=30)
        with tl.exact_fp32():
            pass
        assert not cudnn.allow_tf32 and not matmul.allow_tf32
        release.set()
        worker.join(timeout=30)
        assert not worker.is_alive()
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        release.set()
        cudnn.allow_tf32, matmul.allow_tf32 = saved
