"""Helpers of the zoo's port tests (``tests/test_torch_zoo_*.py``,
``tests/test_torch_xcodec2.py``, ``tests/test_torch_convert*.py``): a JAX
codec and its port twin on the same weights, carried across by
``from_jax_params``, and the checks that hold one to the other."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from audiocodecs_tpu_torch.params import (
    flatten_tree,
    from_jax_params,
    to_jax_params,
)

REL = 1e-4


def assert_same_state(got: dict, want: dict, folded=lambda k: False):
    """Two state dicts with the same keys, float32 CPU tensors equal bit
    for bit, where ``folded(key)`` (a weight-norm fold, float64 sums in
    another order) within 2 ulp."""
    assert sorted(got) == sorted(want)
    for k, ref in want.items():
        t = got[k]
        assert t.dtype == torch.float32 and t.device.type == "cpu", k
        assert tuple(t.shape) == tuple(ref.shape), k
        a, b = t.numpy(), ref.numpy()
        if folded(k):
            np.testing.assert_array_max_ulp(a, b, maxulp=2)
        else:
            assert a.tobytes() == b.tobytes(), k


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch while a zoo test module runs (import
    this fixture into the module). With six pytest workers on the
    machine's cores, torch's thread pool makes each op of a small conv
    stack wait: NanoCodec's published-width encoder took 108 s on eight
    threads under load against 0.8 s on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# leaves kept as the reference draws them: the quantizers' scale is part of
# what they search
_KEEP = ("codebooks", "codebook", "semantic_codebook", "acoustic_codebook")
# gains: drawn around one (SemantiCodec's ``latent_scale`` divides the
# latents)
_GAINS = ("g", "attn_norm", "ffn_norm", "latent_scale")
# learned embeddings added to the input (AudioMAE's)
_EMBEDS = ("cls_token", "pos_embed")


def redraw(tree, seed):
    """Every leaf of the reference's tree redrawn from numpy (``seed``), so
    that biases, gains and every weight move the output: weights
    0.5 · N(0, 1) / √fan_in (fan_in: the product of all but the last axis),
    biases 0.1 · N(0, 1), gains 1 + 0.1 · N(0, 1) (the LDM's norms name
    theirs ``scale`` and ``bias``), snake α and batch-norm variances
    |N| + 0.5, LSTM weights U(±1/√H), AudioMAE's cls token and positions
    0.5 · N(0, 1). Codebooks keep their draws."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(jax.tree.map(np.asarray, tree))

    def draw(key, a):
        leaf = key.rsplit(".", 1)[-1]
        if leaf in _KEEP:
            return a
        if leaf in _GAINS or leaf == "scale" and a.ndim == 1:
            return 1.0 + 0.1 * rng.standard_normal(a.shape)
        if leaf in _EMBEDS:
            return 0.5 * rng.standard_normal(a.shape)
        if leaf in ("b", "bias"):
            return 0.1 * rng.standard_normal(a.shape)
        if "alpha" in leaf or leaf == "var":
            # snake α (also NanoCodec's post_alpha), ECAPA's BN variances
            return np.abs(rng.standard_normal(a.shape)) + 0.5
        if leaf in ("w_ih", "w_hh"):
            return rng.uniform(-1, 1, a.shape) / np.sqrt(a.shape[1] / 4)
        fan = max(int(np.prod(a.shape[:-1])), 1)
        return 0.5 * rng.standard_normal(a.shape) / np.sqrt(fan)

    new = {k: np.asarray(draw(k, a), np.float32) for k, a in flat.items()}

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, f"{prefix}.{i}") for i, v in enumerate(node)]
        return jax.numpy.asarray(new[prefix])

    return rebuild(tree, "")


def port_config(port_cls, jcfg):
    """The port's config dataclass with the reference config's fields (a
    nested config dataclass becomes the port's of the same name)."""
    import importlib

    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            mod = importlib.import_module(
                type(v).__module__.replace("audiocodecs_tpu.",
                                           "audiocodecs_tpu_torch.", 1))
            v = getattr(mod, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return port_cls(**kw)


def pair(jcls, tcls, tcfg_cls, jcfg, sr, seed=0, **kw):
    """``tcls`` on the CPU at ``jcfg`` with weights from its own init
    (generator seed 0, the reference's distributions) redrawn from ``seed``
    (kept as drawn with ``seed=None``), and ``jcls`` on the same weights,
    carried across by ``to_jax_params``: the JAX package's own init is
    eager and takes seconds a family (20 s for NanoCodec's published
    width)."""
    tc = tcls(sr, sr, model_config=port_config(tcfg_cls, jcfg), device="cpu",
              generator=torch.Generator().manual_seed(0), **kw)
    params = to_jax_params(tc.state_dict(), tc)
    if seed is not None:
        params = redraw(params, seed)
    jc = jcls(sr, sr, model_config=jcfg,
              params=jax.tree.map(jax.numpy.asarray, params), **kw)
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


def close(got, want, rel=REL):
    """Within ``rel`` of the reference's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


def jax_outputs(jc, sig, feats_decode=True):
    """The reference's features, tokens, qfeats and decode of ``sig`` (and
    the decode of its features, with ``feats_decode``), traced as one
    program: one compile where the public entry points take one each."""
    import jax.numpy as jnp

    def run(params, x):
        feats = jc._sig_to_feats(params, x, None)
        toks = jc._sig_to_toks(params, x, None)
        out = {"feats": feats, "toks": toks,
               "qfeats": jc._toks_to_qfeats(params, toks, None),
               "sig": jc._toks_to_sig(params, toks, None)}
        if feats_decode:
            out["feats_sig"] = jc._feats_to_sig(params, feats, None)
        return out

    out = jax.jit(run)(jc.params, jnp.asarray(sig))
    return {k: np.asarray(v) for k, v in out.items()}


def check_roundtrip(jc, tc, sig, feats_decode=True):
    """Tokens identical; features, qfeats, the decode of the same tokens
    (and of the features, with ``feats_decode``) within ``REL``. Returns
    the reference's outputs (:func:`jax_outputs`)."""
    want = jax_outputs(jc, sig, feats_decode)
    toks = tc.sig_to_toks(sig)
    assert toks.dtype == torch.int64
    np.testing.assert_array_equal(toks.numpy(), want["toks"])
    close(tc.sig_to_feats(sig), want["feats"])
    close(tc.sig_to_qfeats(sig), want["qfeats"])
    close(tc.toks_to_qfeats(want["toks"]), want["qfeats"])
    close(tc.toks_to_sig(want["toks"]), want["sig"])
    if feats_decode:
        close(tc.feats_to_sig(want["feats"]), want["feats_sig"])
    return want


def check_bridge(jc, tc):
    """``to_jax_params`` gives the reference's tree back, leaf for leaf."""
    back = flatten_tree(to_jax_params(tc.state_dict(), tc))
    want = flatten_tree(jax.tree.map(np.asarray, jc.params))
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def check_modes(jcls, tcls, tc, jparams, sr, **kw):
    """Encode and decode modes drop what the reference's drop: the port's
    state dict in each mode is the reference's pruned tree."""
    for mode in ("encode", "decode"):
        jm = jcls(sr, sr, mode=mode, model_config=jparams[0],
                  params=jparams[1], **kw)
        tm = tcls(sr, sr, mode=mode, model_config=tc.model_config,
                  device="cpu", state_dict=tc.state_dict(), **kw)
        assert sorted(tm.state_dict()) == sorted(
            flatten_tree(jax.tree.map(np.asarray, jm.params))), mode


def check_tier(jc, tc, family, toks):
    """The family's balanced tier: the reference's decode of ``toks`` under
    the tier's switches is its exact decode bit for bit, and so is the
    port's tier codec's (built with ``apply_serving_preset(family)``)
    against the port's exact one."""
    from seanet_tier import reference_tier

    from audiocodecs_tpu_torch.serving import apply_serving_preset

    kw = apply_serving_preset(family)
    assert kw == {"decode_dtype": torch.bfloat16,
                  "decode_precision": "default"}
    sr = tc.sample_rate
    extra = {"num_codebooks": tc.config.num_codebooks}
    j_exact = np.asarray(jc.toks_to_sig(toks))
    with reference_tier(family):
        jt = type(jc)(sr, sr, model_config=jc.model_config,
                      params=jc.params, **extra)
        j_tier = np.asarray(jt.toks_to_sig(toks))
    np.testing.assert_array_equal(j_tier, j_exact)
    tier = type(tc)(sr, sr, model_config=tc.model_config, device="cpu",
                    state_dict=tc.state_dict(), **extra, **kw)
    assert tier.decode_form.dtype == torch.bfloat16
    got = tier.toks_to_sig(toks)
    assert torch.equal(got, tc.toks_to_sig(toks))
    close(got, j_tier)


def check_one_pass_decode(jc, tc, toks):
    """The decoder at fp32 activations and one bf16 pass
    (``decode_precision="default"``) against the reference's under
    ``ACX_DEC_CONV_PRECISION=default`` on ``toks``: within 1e-2 ·
    max|sig| (JAX on the CPU runs DEFAULT f32 dots in full f32, so this is
    the bf16 scale), and moved more than 1e-6 · max|sig| off the port's
    exact decode: the form reaches the decoder."""
    from seanet_tier import switches

    sr = tc.sample_rate
    extra = {"num_codebooks": tc.config.num_codebooks}
    with switches({"ACX_DEC_CONV_PRECISION": "default"}):
        jt = type(jc)(sr, sr, model_config=jc.model_config,
                      params=jc.params, **extra)
        want = np.asarray(jt.toks_to_sig(toks))
    one = type(tc)(sr, sr, model_config=tc.model_config, device="cpu",
                   state_dict=tc.state_dict(), decode_dtype=torch.float32,
                   decode_precision="default", **extra)
    got = one.toks_to_sig(toks).numpy()
    exact = tc.toks_to_sig(toks).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-2 * scale
    assert np.abs(got - exact).max() > 1e-6 * scale
