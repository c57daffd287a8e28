"""Helpers of the training parity tests (``tests/test_torch_train.py``,
``tests/test_torch_train_steps.py``): the tiny EnCodec of
``tests/test_codec_training.py`` in the JAX package and its port twin on
the same weights, the JAX package in float64, the batches."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.encodec import Encodec as JEncodec
from audiocodecs_tpu.models.encodec import EncodecModelConfig as JConfig
from audiocodecs_tpu.nn import layers as jlayers
from audiocodecs_tpu.nn import seanet as jseanet
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig
from audiocodecs_tpu_torch.params import from_jax_params

SR = 800
K = 2


def tiny_cfg():
    return JConfig(sampling_rate=SR, num_filters=8, hidden_size=16,
                   upsampling_ratios=(4, 2), codebook_size=64,
                   codebook_dim=16, num_quantizers=2)


@pytest.fixture(scope="module")
def jax_codec():
    return JEncodec(SR, SR, model_config=tiny_cfg(),
                    key=jax.random.PRNGKey(0))


def _port(jc):
    tree = jax.tree.map(np.asarray, jc.params)
    tc = Encodec(SR, SR, num_codebooks=K, device="cpu",
                 model_config=EncodecModelConfig(
                     **dataclasses.asdict(tiny_cfg())))
    tc.load_state_dict(from_jax_params(tree, tc), strict=True)
    return tc


class _F64Names:
    """``jnp`` as the JAX SEANet module sees it under ``jax_f64``: its
    float32 casts (the LSTM islands) cast to float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture
def jax_f64(monkeypatch):
    """The JAX package in float64: x64 on, the conv stacks' activation
    dtype and the LSTM islands float64 (nothing in the package changes)."""
    monkeypatch.setattr(jseanet, "jnp", _F64Names())
    monkeypatch.setattr(jlayers, "act_dtype",
                        lambda role="encoder": jnp.float64)
    with jax.enable_x64(True):
        yield


def _in_dtype(request, jc, dtype):
    """The JAX params and the port (its weights from them) in ``dtype``."""
    tc = _port(jc)
    if dtype == "float32":
        return jc.params, tc
    request.getfixturevalue("jax_f64")
    params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                          jc.params)
    return params, tc.double()


def _batch(seed, B=4, T=SR):
    return (np.random.default_rng(seed).standard_normal((B, T))
            * 0.1).astype(np.float32)


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _jax_rows(steps, num_codebooks, codebook_size, n):
    key = jax.random.fold_in(jax.random.PRNGKey(0x5EAC0DE), steps)
    rows = jax.random.randint(key, (num_codebooks, codebook_size), 0, n)
    return torch.from_numpy(np.array(rows)).long()
