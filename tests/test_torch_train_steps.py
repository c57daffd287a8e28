"""Port parity for codec training's steps: three steps of
``audiocodecs_tpu_torch.parallel.train.make_codec_train_step`` against the
JAX package's on the same weights and batches, on the CPU, at the tiny
EnCodec of ``tests/test_codec_training.py``, in a file of their own so
that two pytest workers share the training tests. ``tests/
test_torch_train.py`` holds the rest; its docstring gives the tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from audiocodecs_tpu.parallel import train as jtrain
from audiocodecs_tpu_torch.parallel import train
from train_pairs import (  # noqa: F401 (jax_f64: a fixture _in_dtype asks for)
    K,
    _batch,
    _in_dtype,
    _jax_rows,
    _rel,
    jax_codec,
    jax_f64,
    tiny_cfg,
)
from zoo_pairs import one_thread  # noqa: F401 (autouse)

_STEP_CASES = {
    # the chip's loss settings at the tiny config: EMA, spectral term live
    # from the second update on
    "ema_spec": dict(spec_weight=1.0, spec_delay=0, spec_ramp=2,
                     commit_warmup=2),
    "ema": dict(commit_warmup=2),
    "gradient_codebooks": dict(ema_decay=None),
    # gradient codebooks, spectral term at a fixed weight from the first
    "gradient_codebooks_spec": dict(ema_decay=None, spec_weight=0.5),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(_STEP_CASES))
def test_three_train_steps_match_jax(jax_codec, monkeypatch, request, case,
                                     dtype):
    """Adam (optax.adam against torch.optim.Adam), the EMA rule with its
    restarts on the JAX package's rows, the commit warm-up and the spectral
    curriculum, three steps on three batches."""
    kw = _STEP_CASES[case]
    ema = kw.get("ema_decay", 0.99) is not None
    monkeypatch.setattr(train, "restart_rows", _jax_rows)
    j_params, tc = _in_dtype(request, jax_codec, dtype)
    opt = optax.adam(1e-3)
    j_step = jax.jit(jtrain.make_codec_train_step(tiny_cfg(), K, opt, **kw))
    j_state = (jtrain.init_codec_opt_state(opt, j_params, K) if ema
               else opt.init(j_params))
    optimizer = torch.optim.Adam(tc.parameters(), lr=1e-3)
    state = (train.init_codec_opt_state(optimizer, tc, K) if ema
             else optimizer)
    step = train.make_codec_train_step(tc, K, **kw)
    spec_updates = 0  # updates so far with a live spectral weight
    for i in range(3):
        sig = _batch(10 + i).astype(dtype)
        j_params, j_state, j_met = j_step(j_params, j_state, sig)
        met = step(state, sig)
        assert sorted(met) == sorted(j_met)
        limit = 1e-4 if dtype == "float64" or spec_updates == 0 else 1e-2
        for k in j_met:
            assert _rel(met[k], j_met[k]) <= limit, (i, k)
        if kw.get("spec_weight", 0) > 0 and (not ema
                                             or i > kw["spec_delay"]):
            spec_updates += 1
    assert tc.codebooks.dtype == getattr(torch, dtype)
    if ema:
        assert state[1]["steps"] == int(j_state[1]["steps"]) == 3
    if dtype == "float64" or spec_updates == 0:
        np.testing.assert_allclose(tc.codebooks.detach().numpy(),
                                   np.asarray(j_params["codebooks"]),
                                   rtol=0, atol=1e-4)
