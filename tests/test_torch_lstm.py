"""Port parity: the LSTM recurrence and the stacked LSTM of
``audiocodecs_tpu_torch`` against the JAX package (CPU, fp32, atol 1e-5).

On the CPU the port's recurrence wrapper runs its plain version; the CUDA
kernel is held against that plain version on the card by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.nn.lstm import init_lstm_params as j_init
from audiocodecs_tpu.nn.lstm import lstm as j_lstm
from audiocodecs_tpu.ops.lstm_pallas import _scan_reference, lstm_layer_pallas
from audiocodecs_tpu_torch.nn.lstm import LSTM, init_lstm_params, lstm
from audiocodecs_tpu_torch.ops.lstm_recurrence import (
    lstm_recurrence,
    lstm_recurrence_reference,
)

ATOL = 1e-5


def _inputs(rng, T, B, H, nonzero_state):
    gx = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    if nonzero_state:
        h0 = rng.standard_normal((B, H)).astype(np.float32) * 0.5
        c0 = rng.standard_normal((B, H)).astype(np.float32) * 0.5
    else:
        h0 = c0 = np.zeros((B, H), np.float32)
    return gx, w_hh, h0, c0


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("nonzero_state", [False, True])
@pytest.mark.parametrize("T,chunk", [(16, 8), (23, 8), (5, 16), (1, 4)])
def test_recurrence_matches_pallas_interpret(rng, T, chunk, nonzero_state):
    """T not a multiple of the Pallas chunk exercises its tail masking."""
    B, H = 3, 32
    gx, w_hh, h0, c0 = _inputs(rng, T, B, H, nonzero_state)
    want = lstm_layer_pallas(jnp.asarray(gx), jnp.asarray(w_hh),
                             jnp.asarray(h0), jnp.asarray(c0), chunk=chunk,
                             interpret=True)
    got = lstm_recurrence_reference(*_torch(gx, w_hh, h0, c0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("T,B,H", [(9, 2, 32), (31, 4, 64)])
def test_recurrence_matches_scan_reference(rng, T, B, H):
    gx, w_hh, h0, c0 = _inputs(rng, T, B, H, True)
    want = _scan_reference(*map(jnp.asarray, (gx, w_hh, h0, c0)))
    got = lstm_recurrence_reference(*_torch(gx, w_hh, h0, c0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_wrapper_on_cpu_runs_plain_version_without_launching(rng):
    gx, w_hh, h0, c0 = _inputs(rng, 6, 2, 32, True)
    before = lstm_recurrence.launches
    got = lstm_recurrence(*_torch(gx, w_hh, h0, c0))
    want = lstm_recurrence_reference(*_torch(gx, w_hh, h0, c0))
    assert lstm_recurrence.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("T,B,H", [(1, 1, 32), (1, 5, 64), (2, 3, 32),
                                   (7, 2, 64), (12, 4, 32), (3, 9, 96)])
def test_wrapper_matches_pallas_interpret(rng, T, B, H):
    """The entry point the models call, at one step (``lstm_cell_step``),
    two steps (one exchange) and a few, against the Pallas kernel."""
    gx, w_hh, h0, c0 = _inputs(rng, T, B, H, True)
    want = lstm_layer_pallas(*map(jnp.asarray, (gx, w_hh, h0, c0)), chunk=4,
                             interpret=True)
    got = lstm_recurrence(*_torch(gx, w_hh, h0, c0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_kernel_input_checks(rng):
    """What the kernel does not take raises before any launch."""
    from audiocodecs_tpu_torch.ops.lstm_recurrence import _check

    gx, w_hh, h0, c0 = _torch(*_inputs(rng, 4, 2, 32, True))
    _check(gx, w_hh, h0, c0)
    with pytest.raises(ValueError):
        _check(gx[..., :-4], w_hh[:, :-4], h0, c0)  # H not a multiple of 32
    with pytest.raises(ValueError):
        _check(gx, w_hh, h0[:1], c0)
    with pytest.raises(TypeError):
        _check(gx.double(), w_hh.double(), h0.double(), c0.double())
    with pytest.raises(ValueError):
        _check(gx[:0], w_hh, h0, c0)
    with pytest.raises(ValueError):
        lstm_recurrence(*[t.to("meta") for t in (gx, w_hh, h0, c0)])


@pytest.mark.parametrize("H", [24, 32])
def test_layer_and_step_hand_every_width_to_the_wrapper(monkeypatch, H):
    """The LSTM never picks the plain loop itself: the wrapper decides by
    device, and on the card refuses widths the kernel does not take."""
    from audiocodecs_tpu_torch.nn import lstm as lstm_mod

    widths = []

    def spy(gates_x, w_hh, h0, c0):
        widths.append(w_hh.shape[0])
        return lstm_recurrence(gates_x, w_hh, h0, c0)

    monkeypatch.setattr(lstm_mod, "lstm_recurrence", spy)
    params = init_lstm_params(torch.Generator().manual_seed(0), 2, 8, H)
    lstm(torch.zeros(1, 3, 8), params)
    lstm_mod.lstm_cell_step(torch.zeros(1, 4 * H), torch.zeros(1, H),
                            torch.zeros(1, H), params[0]["w_hh"])
    assert widths == [H, H, H]


def test_lstm_off_the_cpu_never_runs_the_plain_loop():
    params = [{k: v.to("meta") for k, v in p.items()} for p in
              init_lstm_params(torch.Generator().manual_seed(0), 1, 8, 24)]
    with pytest.raises(ValueError, match="no kernel for device"):
        lstm(torch.zeros(1, 3, 8, device="meta"), params)


def _jax_layers(num_layers, cin, H, seed):
    params = j_init(jax.random.PRNGKey(seed), num_layers, cin, H)
    return params, [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
                    for p in params]


@pytest.mark.parametrize("num_layers,cin,H,T", [(2, 32, 32, 21), (1, 16, 32, 7),
                                                (2, 64, 64, 13)])
def test_stacked_lstm_matches_jax(rng, num_layers, cin, H, T):
    jp, tp = _jax_layers(num_layers, cin, H, seed=num_layers + H)
    x = rng.standard_normal((2, T, cin)).astype(np.float32)
    want, want_state = j_lstm(jnp.asarray(x), jp)
    got, got_state = lstm(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for (gh, gc), (wh, wc) in zip(got_state, want_state):
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=ATOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=ATOL)


def test_stacked_lstm_carried_state_matches_jax(rng):
    jp, tp = _jax_layers(2, 32, 32, seed=3)
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    state = [(rng.standard_normal((2, 32)).astype(np.float32),
              rng.standard_normal((2, 32)).astype(np.float32))
             for _ in range(2)]
    want, _ = j_lstm(jnp.asarray(x), jp,
                     [(jnp.asarray(h), jnp.asarray(c)) for h, c in state])
    got, _ = lstm(torch.from_numpy(x), tp,
                  [(torch.from_numpy(h), torch.from_numpy(c)) for h, c in state])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_module_and_init_shapes():
    gen = torch.Generator().manual_seed(0)
    params = init_lstm_params(gen, 2, 16, 32)
    mod = LSTM(2, 16, 32)
    mod.load_state_dict({f"{i}.{k}": v for i, p in enumerate(params)
                         for k, v in p.items()}, strict=True)
    assert params[0]["w_ih"].shape == (16, 128)
    assert params[1]["w_ih"].shape == (32, 128)
    assert float(params[0]["w_hh"].abs().max()) <= 1 / np.sqrt(32)
    y, state = mod(torch.zeros(1, 5, 16))
    assert y.shape == (1, 5, 32) and len(state) == 2
