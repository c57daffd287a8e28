"""Port parity: the fused DAC residual unit's plain version against the JAX
package's XLA ``_residual_unit`` and its Pallas kernel in interpret mode
(CPU, fp32, atol/rtol 2e-5, the JAX kernel test's limits), plus the
wrapper's CPU dispatch, its input checks, the kernel's weight layout and
the model unit's cache of it.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocodecs_tpu.models.dac import _residual_unit as j_residual_unit
from audiocodecs_tpu.ops.dac_resunit_pallas import dac_resunit_pallas
from audiocodecs_tpu_torch.models.dac import ResidualUnit
from audiocodecs_tpu_torch.ops.dac_resunit import (
    _check,
    dac_resunit,
    dac_resunit_reference,
    pack_resunit_weights,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def _unit_params(rng, C):
    """The JAX kernel test's draws: α = |N| + 0.5, small conv weights."""
    return {
        "alpha1": (np.abs(rng.standard_normal(C)) + 0.5).astype(np.float32),
        "conv1": {"w": (rng.standard_normal((7, C, C)) * 0.05).astype(
            np.float32),
            "b": (rng.standard_normal(C) * 0.1).astype(np.float32)},
        "alpha2": (np.abs(rng.standard_normal(C)) + 0.5).astype(np.float32),
        "conv2": {"w": (rng.standard_normal((1, C, C)) * 0.05).astype(
            np.float32),
            "b": (rng.standard_normal(C) * 0.1).astype(np.float32)},
    }


def _port_args(p):
    """The JAX unit's params in the port's layouts (conv ``[Cout, Cin, K]``)."""
    t = torch.from_numpy
    return (t(p["conv1"]["w"].transpose(2, 1, 0).copy()), t(p["conv1"]["b"]),
            t(p["alpha1"]), t(p["conv2"]["w"].transpose(2, 1, 0).copy()),
            t(p["conv2"]["b"]), t(p["alpha2"]))


def _bct(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("T", [20, 700, 1024])
def test_plain_unit_matches_jax_xla_and_pallas(rng, monkeypatch, T,
                                               dilation):
    monkeypatch.delenv("ACX_PALLAS_DAC_RESUNIT", raising=False)  # XLA path
    C = 8
    p = _unit_params(rng, C)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v)) for k, v in p.items()}
    want = np.asarray(j_residual_unit(jnp.asarray(x), jp, dilation))
    kernel = np.asarray(dac_resunit_pallas(
        jnp.asarray(x), jp["conv1"]["w"], jp["conv1"]["b"], jp["alpha1"],
        jp["conv2"]["w"], jp["conv2"]["b"], jp["alpha2"], dilation=dilation,
        tile=256, interpret=True, precision_name="highest"))
    got = dac_resunit_reference(_bct(x), *_port_args(p), dilation)
    got = got.numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == kernel.shape == (2, T, C)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, kernel, **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_unit_module_paths_agree(rng, fused):
    """The model's unit, fused (the wrapper's plain version on the CPU) or
    unfused (the plain version itself), passes its weights in the plain
    version's order."""
    C, d = 16, 3
    p = _unit_params(rng, C)
    unit = ResidualUnit(C, d, fused=fused)
    w7, b7, a1, w1, b1, a2 = _port_args(p)
    with torch.no_grad():
        for dst, src in ((unit.conv1.w, w7), (unit.conv1.b, b7),
                         (unit.alpha1, a1), (unit.conv2.w, w1),
                         (unit.conv2.b, b1), (unit.alpha2, a2)):
            dst.copy_(src)
        x = _bct(rng.standard_normal((2, 300, C)).astype(np.float32))
        want = dac_resunit_reference(x, w7, b7, a1, w1, b1, a2, d)
        torch.testing.assert_close(unit(x), want, **TOL)


def test_wrapper_on_cpu_runs_plain_version_without_launching(rng):
    p = _unit_params(rng, 8)
    x = _bct(rng.standard_normal((2, 45, 8)).astype(np.float32))
    before = dac_resunit.launches
    got = dac_resunit(x, *_port_args(p), 9)
    assert dac_resunit.launches == before
    torch.testing.assert_close(
        got, dac_resunit_reference(x, *_port_args(p), 9), rtol=0, atol=0)


def test_kernel_input_checks(rng):
    """What the kernel does not take raises before any launch."""
    C = 8
    p = _unit_params(rng, C)
    x = _bct(rng.standard_normal((1, 20, C)).astype(np.float32))
    args = [x, *_port_args(p)]
    _check(*args, 3)
    with pytest.raises(ValueError):  # a bias of the wrong shape
        _check(*args[:2], args[2][:4], *args[3:], 3)
    with pytest.raises(ValueError):  # x without its batch axis
        _check(x[0], *args[1:], 3)
    with pytest.raises(TypeError):
        _check(*[a.double() for a in args], 3)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2)] + args[1:]
    with pytest.raises(ValueError, match="contiguous"):
        _check(*strided, 3)
    with pytest.raises(ValueError):
        _check(*args, 0)
    with pytest.raises(ValueError):
        dac_resunit(*[a.to("meta") for a in args], 3)
    C = 384  # wider than the kernel takes
    wide = [torch.zeros(s) for s in ((1, C, 4), (C, C, 7), (C,), (C,),
                                     (C, C, 1), (C,), (C,))]
    with pytest.raises(ValueError, match="C <= 256"):
        _check(*wide, 1)


@pytest.mark.parametrize("C,Kp,Cp", [(5, 8, 96), (96, 96, 96),
                                     (192, 192, 192), (200, 200, 256)])
def test_pack_resunit_weights_layout(rng, C, Kp, Cp):
    """``w7p [Kp, 7, Cp]`` with ``w7p[c, k, o] = w7[o, c, k]``, ``w1p
    [Kp, Cp]`` with ``w1p[m, o] = w1[o, m, 0]``, padded lanes zero."""
    w7 = torch.from_numpy(rng.standard_normal((C, C, 7)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((C, C, 1)).astype(np.float32))
    w7p, w1p = pack_resunit_weights(w7, w1)
    assert w7p.shape == (Kp, 7, Cp) and w1p.shape == (Kp, Cp)
    assert w7p.dtype == w1p.dtype == torch.float32
    assert w7p.is_contiguous() and w1p.is_contiguous()
    assert torch.equal(w7p[:C, :, :C], w7.permute(1, 2, 0))
    assert torch.equal(w1p[:C, :C], w1[:, :, 0].T)
    for pad in (w7p[C:], w7p[:, :, C:], w1p[C:], w1p[:, C:]):
        assert not pad.any()


def test_unit_packs_once_and_again_after_new_weights(rng):
    """The fused unit builds the kernel's layout on its first forward, keeps
    it across forwards, and rebuilds it when ``load_state_dict`` writes new
    weights; the layout is no state-dict entry."""
    C, d = 16, 3
    unit = ResidualUnit(C, d, fused=True)
    state = dict(zip(("conv1.w", "conv1.b", "alpha1", "conv2.w", "conv2.b",
                      "alpha2"), _port_args(_unit_params(rng, C))))
    unit.load_state_dict(state, strict=True)
    x = _bct(rng.standard_normal((1, 40, C)).astype(np.float32))
    before = pack_resunit_weights.packs
    with torch.inference_mode():
        unit(x)
        first = unit.packed_weights()
        unit(x)
    assert pack_resunit_weights.packs == before + 1
    assert unit.packed_weights() is first
    assert set(unit.state_dict()) == set(state)

    new = dict(zip(state, _port_args(_unit_params(rng, C))))
    unit.load_state_dict(new, strict=True)
    with torch.inference_mode():
        unit(x)
    assert pack_resunit_weights.packs == before + 2
    w7p, w1p = unit.packed_weights()
    want = pack_resunit_weights(new["conv1.w"], new["conv2.w"])
    assert torch.equal(w7p, want[0]) and torch.equal(w1p, want[1])


def test_wrapper_on_cpu_with_packed_pair_equals_plain_version(rng):
    C, d = 12, 9
    p = _unit_params(rng, C)
    args = _port_args(p)
    x = _bct(rng.standard_normal((2, 77, C)).astype(np.float32))
    packed = pack_resunit_weights(args[0], args[3])
    got = dac_resunit(x, *args, d, packed=packed)
    torch.testing.assert_close(got, dac_resunit_reference(x, *args, d),
                               rtol=0, atol=0)


def test_kernel_input_checks_on_the_packed_pair(rng):
    C = 8
    args = [_bct(rng.standard_normal((1, 20, C)).astype(np.float32)),
            *_port_args(_unit_params(rng, C))]
    w7p, w1p = pack_resunit_weights(args[1], args[4])
    _check(*args, 3, (w7p, w1p))
    with pytest.raises(ValueError, match="packed w7"):
        _check(*args, 3, (w7p[:, :, :64], w1p))
    with pytest.raises(ValueError, match="packed w1"):
        _check(*args, 3, (w7p, w1p.T))
    with pytest.raises(TypeError):
        _check(*args, 3, (w7p.double(), w1p))
