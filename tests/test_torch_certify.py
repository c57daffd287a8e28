"""The port's token-safety certificates (``audiocodecs_tpu_torch/quant/
certify.py``) against the JAX package's (``audiocodecs_tpu/quant/
certify.py``) on the same arrays, bit for bit, and the soundness cases of
``tests/test_certify.py`` against the port's own quantizers: every
certified frame gives the same tokens under the perturbation, and
``equal`` is the observed agreement. Then ``certify_codec`` and
``tools/certify_torch.py`` on the CPU, at a small size.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiocodecs_tpu.quant import certify as jcert
from audiocodecs_tpu_torch.models.dac import (
    DACModelConfig,
    QuantizerStage,
    dac_rvq_encode,
)
from audiocodecs_tpu_torch.models.mimi import (
    MimiModelConfig,
    SplitRVQ,
    _split_rvq_encode,
)
from audiocodecs_tpu_torch.quant import certify as tcert
from audiocodecs_tpu_torch.quant.rvq import rvq_encode

REPO = Path(__file__).resolve().parent.parent


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _perturbed(rng, z):
    return (z + rng.standard_normal(z.shape) * 10.0 ** rng.uniform(-4, -0.5)
            ).astype(np.float32)


def _dac_stages(rng, K, H, D, C):
    """``K`` of the port's DAC stages and the reference's dicts, on the same
    arrays."""
    cfg = DACModelConfig(hidden_size=H, codebook_dim=D, codebook_size=C)
    stages, dicts = [], []
    for _ in range(K):
        w_in, b_in = _f32(rng, 1, H, D, scale=H**-0.5), _f32(rng, D, scale=.1)
        w_out, b_out = _f32(rng, 1, D, H, scale=D**-0.5), _f32(rng, H,
                                                              scale=.1)
        cb = _f32(rng, C, D)
        q = QuantizerStage(cfg)
        with torch.no_grad():
            q.in_proj.w.copy_(torch.from_numpy(w_in[0].T[..., None].copy()))
            q.in_proj.b.copy_(torch.from_numpy(b_in))
            q.out_proj.w.copy_(torch.from_numpy(w_out[0].T[..., None].copy()))
            q.out_proj.b.copy_(torch.from_numpy(b_out))
            q.codebook.copy_(torch.from_numpy(cb))
        stages.append(q)
        dicts.append({"in_proj": {"w": w_in, "b": b_in},
                      "out_proj": {"w": w_out, "b": b_out}, "codebook": cb})
    return stages, dicts


def _mimi_quantizer(rng, H, D, C, n_acoustic):
    cfg = MimiModelConfig(hidden_size=H, codebook_dim=D, codebook_size=C,
                          num_quantizers=1 + n_acoustic,
                          num_semantic_quantizers=1)
    q = SplitRVQ(cfg)
    tree = {}
    for side, n in (("semantic", 1), ("acoustic", n_acoustic)):
        proj, cbs = _f32(rng, H, D, scale=H**-0.5), _f32(rng, n, C, D)
        mod = getattr(q, side)
        with torch.no_grad():
            mod.in_proj.copy_(torch.from_numpy(proj))
            mod.codebooks.copy_(torch.from_numpy(cbs))
        tree[side] = {"in_proj": proj, "codebooks": cbs}
    return q, tree


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("trial", range(3))
def test_rvq_certificate_equals_the_reference(trial):
    rng = np.random.default_rng(10 + trial)
    cb, z = _f32(rng, 3, 32, 8), _f32(rng, 4, 16, 8)
    zf = _perturbed(rng, z)
    extra = np.abs(_f32(rng, 4, 16, scale=1e-3)).astype(np.float64)
    _equal(tcert.certify_rvq_tokens(torch.from_numpy(z), torch.from_numpy(zf),
                                    torch.from_numpy(cb), 2, extra),
           jcert.certify_rvq_tokens(z, zf, cb, 2, extra))


@pytest.mark.parametrize("trial", range(3))
def test_dac_certificate_equals_the_reference(trial):
    rng = np.random.default_rng(20 + trial)
    stages, dicts = _dac_stages(rng, 3, 16, 8, 32)
    z = _f32(rng, 2, 12, 16)
    zf = _perturbed(rng, z)
    _equal(tcert.certify_dac_tokens(torch.from_numpy(z),
                                    torch.from_numpy(zf), stages),
           jcert.certify_dac_tokens(z, zf, dicts))


@pytest.mark.parametrize("trial", range(3))
def test_mimi_certificate_equals_the_reference(trial):
    rng = np.random.default_rng(30 + trial)
    q, tree = _mimi_quantizer(rng, 12, 8, 16, 3)
    emb = _f32(rng, 2, 10, 12)
    ef = _perturbed(rng, emb)
    _equal(tcert.certify_mimi_tokens(torch.from_numpy(emb),
                                     torch.from_numpy(ef), q, 4, 1),
           jcert.certify_mimi_tokens(emb, ef, tree, 4, 1))


def test_certificate_soundness_random():
    """Every certified frame produces identical tokens (the port's
    ``rvq_encode``), for many latent and perturbation draws; ``equal``
    tracks the observed agreement exactly."""
    rng = np.random.default_rng(0)
    codebooks = torch.from_numpy(_f32(rng, 3, 32, 8))
    violations = 0
    for _ in range(20):
        z = torch.from_numpy(_f32(rng, 4, 16, 8))
        zf = torch.from_numpy(_perturbed(rng, z.numpy()))
        cert, equal, _ = tcert.certify_rvq_tokens(z, zf, codebooks)
        same = torch.all(rvq_encode(z, codebooks) == rvq_encode(zf, codebooks),
                         dim=-1).numpy()
        violations += int(np.sum(cert & ~same))
        np.testing.assert_array_equal(equal, same)
    assert violations == 0


def test_certificate_tightness_extremes():
    rng = np.random.default_rng(1)
    codebooks = torch.from_numpy(_f32(rng, 2, 16, 8))
    z = torch.from_numpy(_f32(rng, 2, 8, 8))
    cert, equal, delta = tcert.certify_rvq_tokens(z, z, codebooks)
    assert cert.all() and equal.all() and float(delta.max()) == 0.0
    cert2, _, _ = tcert.certify_rvq_tokens(z, z + 100.0, codebooks)
    assert not cert2.any()


def test_dac_certificate_soundness_random():
    rng = np.random.default_rng(2)
    stages, _ = _dac_stages(rng, 3, 16, 8, 32)
    violations = 0
    for _ in range(20):
        z = torch.from_numpy(_f32(rng, 2, 12, 16))
        zf = torch.from_numpy(_perturbed(rng, z.numpy()))
        cert, equal, _ = tcert.certify_dac_tokens(z, zf, stages)
        with torch.no_grad():
            same = torch.all(dac_rvq_encode(z, stages, 3)
                             == dac_rvq_encode(zf, stages, 3), -1).numpy()
        violations += int(np.sum(cert & ~same))
        np.testing.assert_array_equal(equal, same)
    assert violations == 0


def test_mimi_certificate_soundness_random():
    rng = np.random.default_rng(3)
    q, _ = _mimi_quantizer(rng, 12, 8, 16, 3)
    violations = 0
    for _ in range(20):
        emb = torch.from_numpy(_f32(rng, 2, 10, 12))
        ef = torch.from_numpy(_perturbed(rng, emb.numpy()))
        cert, equal, _ = tcert.certify_mimi_tokens(emb, ef, q, 4, 1)
        with torch.no_grad():
            same = torch.all(_split_rvq_encode(q, emb, 4, 1)
                             == _split_rvq_encode(q, ef, 4, 1), -1).numpy()
        violations += int(np.sum(cert & ~same))
        np.testing.assert_array_equal(equal, same)
    assert violations == 0


def _tool():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import certify_torch
    finally:
        sys.path.pop(0)
    return certify_torch


def test_certify_codec_on_a_small_encodec():
    """The one-pass encoder of a small EnCodec against its exact one: no
    certified frame's real tokens differ, the shares are consistent, and
    the one-pass encoder moves the features (δ > 0)."""
    from audiocodecs_tpu_torch.models.encodec import (
        Encodec,
        EncodecModelConfig,
    )

    mc = EncodecModelConfig(num_filters=8, hidden_size=16,
                            upsampling_ratios=(4, 2), codebook_size=64,
                            codebook_dim=16, num_quantizers=4)

    def build(**kw):
        return Encodec(24000, 24000, mode="encode", num_codebooks=4,
                       model_config=mc, device="cpu",
                       generator=torch.Generator().manual_seed(0), **kw)

    sig = _tool().signal(2, 0.25, 24000)
    res = tcert.certify_codec(build(), build(encode_precision="default"),
                              sig)
    assert res["frames"] == 2 * 750
    assert res["certified_but_real_mismatch"] == 0
    assert res["certified"] <= res["equal"] <= 1.0
    assert res["equal"] == res["real_token_match"]
    assert res["max_delta"] > 0
    same = tcert.certify_codec(build(), build(), sig)
    assert same["certified"] == same["real_token_match"] == 1.0


def test_certify_tool_on_the_cpu(capsys):
    import json

    tool = _tool()
    assert tool.main(["--device", "cpu", "--codec", "mimi", "--batch", "1",
                      "--seconds", "0.16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("certified", "equal", "mismatch", "real_token_match",
                "max_delta"):
        assert key in out
    assert out["device"] == "cpu" and out["frames"] == 2
    with pytest.raises(ValueError, match="three-pass"):
        tool.main(["--device", "cpu", "--prec", "high"])
    with pytest.raises(NotImplementedError, match="DAC"):
        tool.main(["--device", "cpu", "--codec", "dac"])
