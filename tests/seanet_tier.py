"""Helpers of the SEANet families' tier tests (``tests/test_torch_*.py``):
the reference's serving tier under its environment switches, and the check
that holds the port's tier to it.

The reference's EnCodec-style tier (``ACX_ACT_DTYPE=decoder-bfloat16``) runs
its decoder's residual blocks on XLA in bf16 (every conv and sum rounded to
bf16), or, under ``ACX_PALLAS_RESBLOCK=1``, through its fused kernel on the
bf16 input cast to f32 (here in interpret mode). The port's fused blocks
compute the kernel's one-pass form on bf16 operands, which rounds at fewer
points than XLA's bf16 path. Two bf16 decodes part wherever a sum straddles
a rounding boundary, so the port's tier is held, as DAC's is
(``test_torch_dac.check_bf16_tier``), to the reference's own move:
rms(port tier − reference tier) below rms(reference tier − reference
exact), and the port's own move at least a quarter of it.
"""

import contextlib
import os

import numpy as np
from test_torch_dac import _KNOBS, check_bf16_tier

from audiocodecs_tpu.serving import apply_serving_preset as j_apply

KNOBS = (*_KNOBS, "ACX_PALLAS_RESBLOCK")


@contextlib.contextmanager
def switches(env: dict, fused: bool = False):
    """The reference's switches ``env`` inside ``with``; with ``fused`` its
    fused block on (the Pallas kernel in interpret mode). The environment
    and the kernel are put back after it."""
    from audiocodecs_tpu.ops import seanet_block_pallas as pallas

    saved = {k: os.environ.pop(k, None) for k in KNOBS}
    kernel = pallas.seanet_resblock_pallas
    try:
        for k, v in env.items():
            if v:
                os.environ[k] = v
        if fused:
            os.environ["ACX_PALLAS_RESBLOCK"] = "1"

            def interpreted(*args, **kw):
                return kernel(*args, interpret=True, **kw)

            interpreted.jitted = kernel
            pallas.seanet_resblock_pallas = interpreted
        yield
    finally:
        pallas.seanet_resblock_pallas = kernel
        for k in KNOBS:
            os.environ.pop(k, None)
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v


@contextlib.contextmanager
def reference_tier(family: str, quality: str = "balanced",
                   fused: bool = False):
    """The reference's serving tier of ``family`` inside ``with`` (its
    ``apply_serving_preset`` writes the switches, :func:`switches` puts
    them back)."""
    with switches({}, fused):
        yield j_apply(family, quality)


class _OnePassDots:
    """``jax.numpy`` with ``dot`` at ``Precision.DEFAULT`` computed as the
    TPU computes it: both operands rounded to bf16, products summed in
    f32. JAX on the CPU runs DEFAULT f32 dots in full f32."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def dot(self, a, b, *, precision=None, **kw):
        import jax

        jnp = self._jnp
        if precision == jax.lax.Precision.DEFAULT:
            a = a.astype(jnp.bfloat16).astype(jnp.float32)
            b = b.astype(jnp.bfloat16).astype(jnp.float32)
            precision = jax.lax.Precision.HIGHEST
        return jnp.dot(a, b, precision=precision, **kw)


@contextlib.contextmanager
def one_pass_kernel():
    """Inside ``with``, the reference's fused block (switched on by
    :func:`switches`)
    runs the decoder's blocks at ``precision_name="default"`` with the
    TPU's one-pass dots: the one-pass form of the block on the bf16 input
    cast to f32 and back. The encoder's keep the switches' precision."""
    from audiocodecs_tpu.nn import layers
    from audiocodecs_tpu.ops import seanet_block_pallas as pallas

    kernel, jnp = pallas.seanet_resblock_pallas, pallas.jnp
    pallas.jnp = _OnePassDots(jnp)

    def one_pass(*args, precision_name="highest", **kw):
        if layers._CONV_ROLE == "decoder":
            # unjitted: a trace cached before the patch would skip it
            return kernel.jitted.__wrapped__(*args, precision_name="default",
                                             interpret=True, **kw)
        return kernel(*args, precision_name=precision_name, **kw)

    pallas.seanet_resblock_pallas = one_pass
    try:
        yield
    finally:
        pallas.seanet_resblock_pallas, pallas.jnp = kernel, jnp


@contextlib.contextmanager
def port_unfused():
    """Inside ``with``, the port's SEANet blocks take the unfused path (the
    plain bf16 convs of the tier's form, as the reference's XLA path)."""
    from audiocodecs_tpu_torch.nn import seanet

    gate = seanet._fused_eligible
    seanet._fused_eligible = lambda *a: False
    try:
        yield
    finally:
        seanet._fused_eligible = gate


def check_family_tier(family, jc, tc, make_j, make_t, sig, fused=False):
    """``family``'s balanced tier, port against reference, on the tokens of
    ``sig``: the port's tier codec (``make_t(**preset)``) gives the exact
    tier's tokens, which the reference's tier (``make_j()`` under its
    switches, a fresh trace) gives too; its decode is held to the
    reference's tier by :func:`check_bf16_tier`. With ``fused`` (the causal
    blocks take the fused kernel), also the port's fused tier against the
    reference's fused block in the one-pass form, and the port's unfused
    tier against the reference's XLA tier. Returns the port's tier codec
    and the tokens."""
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    toks = np.asarray(jc.sig_to_toks(sig))
    j_exact = np.asarray(jc.toks_to_sig(toks))
    t_exact = tc.toks_to_sig(toks).numpy()
    tt = make_t(**apply_serving_preset(family))
    np.testing.assert_array_equal(tt.sig_to_toks(sig).numpy(), toks)
    t_tier = tt.toks_to_sig(toks).numpy()
    assert t_tier.dtype == np.float32 and t_tier.shape == j_exact.shape

    def reference(fused_block):
        with reference_tier(family, fused=fused_block), (
                one_pass_kernel() if fused_block
                else contextlib.nullcontext()):
            jt = make_j()
            np.testing.assert_array_equal(np.asarray(jt.sig_to_toks(sig)),
                                          toks)
            return np.asarray(jt.toks_to_sig(toks))

    j_xla = reference(False)
    check_bf16_tier(t_tier, t_exact, j_xla, j_exact)
    if fused:
        check_bf16_tier(t_tier, t_exact, reference(True), j_exact)
        with port_unfused():
            t_unfused = tt.toks_to_sig(toks).numpy()
        check_bf16_tier(t_unfused, t_exact, j_xla, j_exact)
    return tt, toks


def check_encode_precision(jc, make_j, make_t, sig):
    """The port's encoder at ``encode_precision="default"`` (one bf16 pass)
    against the reference's under ``ACX_CONV_PRECISION=default``: features
    within 1e-2 · max|features| (JAX on the CPU runs DEFAULT f32 dots in
    full f32, so this is the bf16 scale), and moved off the port's exact
    features by one bf16 pass."""
    with switches({"ACX_CONV_PRECISION": "default"}):
        want = np.asarray(make_j().sig_to_feats(sig))
    got = make_t(encode_precision="default").sig_to_feats(sig).numpy()
    exact = make_t().sig_to_feats(sig).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-2 * scale
    assert np.abs(got - exact).max() > 1e-6 * scale
