"""Port parity: the fused DAC residual unit's plain version against the JAX
package's XLA ``_residual_unit`` and its Pallas kernel in interpret mode
(CPU, fp32, atol/rtol 2e-5, the JAX kernel test's limits), plus the
wrapper's CPU dispatch and its input checks.

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
