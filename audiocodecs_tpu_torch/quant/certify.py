"""Sound token-safety certificates for reduced-precision encoders.

The port's copy of ``audiocodecs_tpu/quant/certify.py`` (same constants,
same float64 arithmetic on the host), taking the port's tensors and
quantizer modules. The exact fp32 encoder is the token-parity reference; a
reduced-precision encoder (``encode_precision="default"``: one bf16 pass,
the reference's ``ACX_CONV_PRECISION=default``) perturbs the
pre-quantizer latents by a small δ per frame, which can flip
argmin-marginal tokens. This module turns that into a PER-FRAME PROOF:

For an RVQ stage with exact residual r, nearest codeword e₁, and any
competitor e_j with squared-distance margin m_j = d²(r,e_j) − d²(r,e₁) ≥ 0:
perturbing the latent by δ changes the margin by exactly 2·δ·(e₁−e_j)
(the ‖δ‖² terms cancel), so a flip to j requires

    ‖δ‖ ≥ m_j / (2‖e₁−e_j‖).

A frame is **certified** at the stage iff
``2‖δ‖‖e₁−e_j‖ + rounding_slack < m_j`` for every competitor j.
Certification composes across RVQ stages: if every earlier stage of the
frame is certified (same token ⇒ the same codeword is subtracted from both
paths), the residual perturbation entering the next stage is still the same
δ, so the per-stage tests use one δ. The certificate is sound, not tight —
an uncertified frame may still agree (check ``equal``); a certified frame
PROVABLY agrees.

``rounding_slack`` covers the REAL quantizer's finite precision: the
encoder computes its scores in float32, so frames with f64 margins below
the f32 dot-product forward-error bound could still flip regardless of δ.
Per frame and codeword the slack is ``SAFETY · γ_H · (2·Σ|r_i||c_ji| +
Σc_ji²)`` with ``γ_H = H·u/(1−H·u)``, ``u = 2⁻²⁴`` (classic Higham
dot-product bound) and a ×4 SAFETY factor; the flip test deflates each
margin by ``slack₁ + slack_j``.

The analysis runs in float64 numpy on the host: the device's reduced
precision must not reach the margins the proof relies on.
"""

from __future__ import annotations

import numpy as np

__all__ = ["certify_codec", "certify_rvq_tokens", "certify_dac_tokens",
           "certify_mimi_tokens"]

# f32 unit roundoff and dot-product forward-error coefficient
_U32 = 2.0 ** -24
_SAFETY = 4.0


def _gamma(n: int) -> float:
    return n * _U32 / (1.0 - n * _U32)


def _host(t) -> np.ndarray:
    """A tensor (or array) as a contiguous float64 array on the host."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().double().numpy()
    return np.ascontiguousarray(np.asarray(t, np.float64))


def certify_rvq_tokens(z_exact, z_fast, codebooks,
                       num_codebooks: int | None = None, extra_delta=None):
    """``z_exact``/``z_fast``: [B, N, H] latents from the exact and
    reduced-precision encoders; ``codebooks``: [K, C, H].

    Returns ``(certified [B, N] bool, equal [B, N] bool, delta [B, N])``:
    ``certified`` frames provably produce identical tokens at every stage;
    ``equal`` is the observed agreement (⊇ certified); ``delta`` = ‖δ‖."""
    z_exact = _host(z_exact)
    z_fast = _host(z_fast)
    codebooks = _host(codebooks)
    K = codebooks.shape[0] if num_codebooks is None else num_codebooks
    delta = np.linalg.norm(z_exact - z_fast, axis=-1)  # [B, N]
    if extra_delta is not None:  # e.g. upstream-projection f32 rounding
        delta = delta + np.asarray(extra_delta, np.float64)
    residual = z_exact
    certified = np.ones(z_exact.shape[:2], bool)
    equal = np.ones(z_exact.shape[:2], bool)
    res_fast = z_fast
    for k in range(K):
        cb = codebooks[k]  # [C, H]
        cb_sq = np.sum(cb**2, -1)
        # exact-path distances and margins
        d2 = (np.sum(residual**2, -1, keepdims=True)
              - 2.0 * np.einsum("bnh,ch->bnc", residual, cb)
              + cb_sq[None, None])  # [B, N, C]
        i1 = np.argmin(d2, axis=-1)  # [B, N]
        m = d2 - np.take_along_axis(d2, i1[..., None], axis=-1)  # margins
        # pairwise codeword distances, row of the winner per frame
        g2 = cb_sq[:, None] - 2.0 * cb @ cb.T + cb_sq[None, :]  # [C, C]
        dist = 2.0 * np.sqrt(np.maximum(g2[i1], 1e-24))  # 2‖e₁−e_j‖
        # f32 score-rounding slack (see module docstring): per codeword j,
        # SAFETY·γ_H·(2 Σ|r||c_j| + Σc_j²); margin must clear both slacks
        gam = _SAFETY * _gamma(cb.shape[-1])
        absdot = np.einsum("bnh,ch->bnc", np.abs(residual), np.abs(cb))
        slack = gam * (2.0 * absdot + np.sum(cb**2, -1)[None, None])
        slack1 = np.take_along_axis(slack, i1[..., None], axis=-1)
        ok = (delta[..., None] * dist + slack + slack1
              < np.maximum(m, 0.0))
        ok |= np.arange(cb.shape[0])[None, None] == i1[..., None]
        certified &= np.all(ok, axis=-1)
        # observed agreement on the fast path (same f64 quantizer math)
        d2f = (np.sum(res_fast**2, -1, keepdims=True)
               - 2.0 * np.einsum("bnh,ch->bnc", res_fast, cb)
               + cb_sq[None, None])
        i1_fast = np.argmin(d2f, axis=-1)
        equal &= i1_fast == i1
        residual = residual - cb[i1]
        # fast path subtracts ITS OWN codeword (as the real encoder would)
        res_fast = res_fast - cb[i1_fast]
    return certified, equal, delta


def certify_dac_tokens(z_exact, z_fast, quantizers,
                       num_codebooks: int | None = None):
    """DAC variant (projected cosine RVQ): ``quantizers`` are the port's
    stages (``models/dac.py::QuantizerStage``: ``in_proj`` and
    ``out_proj`` 1×1 convs, ``codebook`` [C, D]).

    Stage scores are ``unit(W_in·r + b) · unit(c_j)``. With previous-stage
    tokens equal, the fast residual is ``r + δ`` with the SAME δ at every
    stage, so the unit-projection perturbation ``Δu`` is computable exactly
    per frame; a flip to competitor j requires
    ``Δu·(ĉ₁−ĉ_j) ≤ −m_j`` ⇒ ``‖Δu‖ ≥ m_j / ‖ĉ₁−ĉ_j‖``.
    Returns ``(certified [B, N], equal [B, N], delta [B, N])``."""
    z_exact = _host(z_exact)
    z_fast = _host(z_fast)
    K = len(quantizers) if num_codebooks is None else num_codebooks
    delta = np.linalg.norm(z_exact - z_fast, axis=-1)
    certified = np.ones(z_exact.shape[:2], bool)
    equal = np.ones(z_exact.shape[:2], bool)
    r_e, r_f = z_exact, z_fast

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-24)

    for k in range(K):
        q = quantizers[k]
        w_in = _host(q.in_proj.w[:, :, 0].T)  # [H, D]
        b_in = _host(q.in_proj.b)
        cb = unit(_host(q.codebook))  # [C, D] unit rows
        z_e_raw = r_e @ w_in + b_in
        u_e = unit(z_e_raw)  # [B, N, D]
        u_f = unit(r_f @ w_in + b_in)
        du = np.linalg.norm(u_f - u_e, axis=-1)  # [B, N]
        # f32 rounding of the real in_proj conv: elementwise |z| error
        # ≤ γ_H · (|r|·|W| + |b|), propagated through the normalization
        # (‖Δu‖ ≤ 2‖Δz‖/‖z‖)
        gam_h = _SAFETY * _gamma(w_in.shape[0])
        zabs = np.abs(r_e) @ np.abs(w_in) + np.abs(b_in)
        znorm = np.linalg.norm(z_e_raw, axis=-1)
        du_tot = du + 2.0 * gam_h * np.linalg.norm(zabs, axis=-1) \
            / np.maximum(znorm, 1e-24)
        s = np.einsum("bnd,cd->bnc", u_e, cb)
        i1 = np.argmax(s, axis=-1)
        m = np.take_along_axis(s, i1[..., None], axis=-1) - s  # ≥ 0
        # ‖ĉ₁−ĉ_j‖ per frame: row i1 of the pairwise unit-codeword distances
        g = np.sqrt(np.maximum(
            2.0 - 2.0 * cb @ cb.T, 1e-24))  # [C, C]
        # f32 score-dot slack + normalization ulps on both operands
        gam_d = _SAFETY * _gamma(cb.shape[-1])
        score_slack = (gam_d * np.einsum("bnd,cd->bnc", np.abs(u_e),
                                         np.abs(cb))
                       + _SAFETY * (cb.shape[-1] + 2) * _U32)
        slack1 = np.take_along_axis(score_slack, i1[..., None], axis=-1)
        ok = (du_tot[..., None] * g[i1] + score_slack + slack1
              < np.maximum(m, 0.0))
        ok |= np.arange(cb.shape[0])[None, None] == i1[..., None]
        certified &= np.all(ok, axis=-1)
        i1_f = np.argmax(np.einsum("bnd,cd->bnc", u_f, cb), axis=-1)
        equal &= i1_f == i1
        w_out = _host(q.out_proj.w[:, :, 0].T)  # [D, H]
        b_out = _host(q.out_proj.b)
        cb_raw = _host(q.codebook)
        r_e = r_e - (cb_raw[i1] @ w_out + b_out)
        r_f = r_f - (cb_raw[i1_f] @ w_out + b_out)
    return certified, equal, delta


def certify_mimi_tokens(emb_exact, emb_fast, quantizer,
                        num_codebooks: int, num_semantic: int = 1):
    """Mimi variant (split RVQ): ``quantizer`` is the port's
    ``models/mimi.py::SplitRVQ``, two independent branches (``semantic``,
    ``acoustic``), each ``z = emb · in_proj`` then plain RVQ — the
    projected perturbations are computed exactly per branch and the
    euclidean certificate applies; the frame certificate is the AND.
    Returns ``(certified [B, N], equal [B, N], delta [B, N])``."""
    emb_exact = _host(emb_exact)
    emb_fast = _host(emb_fast)
    delta = np.linalg.norm(emb_exact - emb_fast, axis=-1)

    def branch(p, n):
        proj = _host(p.in_proj)
        # the real branch projection runs in f32: fold its per-frame
        # forward-error bound into the perturbation budget (both paths)
        extra = 2.0 * _SAFETY * _gamma(proj.shape[0]) * np.linalg.norm(
            np.abs(emb_exact) @ np.abs(proj), axis=-1)
        return certify_rvq_tokens(emb_exact @ proj, emb_fast @ proj,
                                  p.codebooks, n, extra_delta=extra)

    cert, equal, _ = branch(quantizer.semantic, num_semantic)
    if num_codebooks > num_semantic:
        c2, e2, _ = branch(quantizer.acoustic,
                           num_codebooks - num_semantic)
        cert, equal = cert & c2, equal & e2
    return cert, equal, delta


def certify_codec(exact, fast, sig) -> dict:
    """Certify ``fast``'s tokens of ``sig`` [B, T] against ``exact``'s: two
    codecs with the same weights, ``fast`` with a reduced-precision encoder.
    Runs both encoders (features and the real tokens of each) and the
    certificate of the codec's quantizer (EnCodec's and SEANet-RVQ's plain
    RVQ without a projector, Mimi's split RVQ). Returns the certified and
    observed shares per frame, the real token match, the certified frames
    whose real tokens differ (a sound certificate finds none) and
    max ‖δ‖."""
    z_exact, z_fast = exact.sig_to_feats(sig), fast.sig_to_feats(sig)
    t_exact, t_fast = exact.sig_to_toks(sig), fast.sig_to_toks(sig)
    K = exact.config.num_codebooks
    if hasattr(exact, "codebooks") and not hasattr(exact, "in_proj"):
        certified, equal, delta = certify_rvq_tokens(
            z_exact, z_fast, exact.codebooks, K)
    elif hasattr(getattr(exact, "quantizer", None), "semantic"):
        certified, equal, delta = certify_mimi_tokens(
            z_exact, z_fast, exact.quantizer, K,
            exact.model_config.num_semantic_quantizers)
    else:
        raise NotImplementedError(
            f"no certificate for {type(exact).__name__}'s quantizer here")
    real = np.all(_host(t_exact) == _host(t_fast), axis=-1)  # [B, N]
    return {
        "frames": int(certified.size),
        "certified": float(np.mean(certified)),
        "equal": float(np.mean(equal)),
        "uncertified_but_equal": float(np.mean(~certified & equal)),
        "mismatch": float(np.mean(~equal)),
        "real_token_match": float(np.mean(real)),
        "certified_but_real_mismatch": int(np.sum(certified & ~real)),
        "max_delta": float(np.max(delta)),
    }
