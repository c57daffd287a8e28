"""Port parity for the parallel layer's SLM steps
(``audiocodecs_tpu_torch/parallel/train.py``: Megatron's layout and
sequence parallelism) against the JAX package, on the CPU.

The port's ranks are gloo processes (``spawn_ranks``, one intra-op
thread each) whose work is in ``tests/torch_dist_workers.py`` (no JAX
there); the JAX references come from this process, on the 8-device
virtual CPU mesh of ``conftest.py``.

* Megatron SLM steps against the reference's sharded step (losses 1e-5
  relative; first-step gradients 1e-5 of each leaf's largest against
  ``jax.grad``), at mp = 2 (GQA split, remat on), mp = 4 (attention,
  table and head whole: they do not divide) and with every block split
  (a vocab-parallel table); the split leaves as the rule says.
* Sequence parallelism on (data, seq, model) = (1, 2, 2) and (2, 2, 1)
  against the reference's ``sequence_axis`` step on ragged masks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from audiocodecs_tpu.downstream.models import llama as jllama
from audiocodecs_tpu.parallel import mesh as jmesh
from audiocodecs_tpu.parallel import train as jtrain
from audiocodecs_tpu_torch.parallel import mesh as pmesh
from audiocodecs_tpu_torch.params import flatten_tree
import torch_dist_workers as workers
from zoo_pairs import one_thread  # noqa: F401 (autouse)

LLAMA_KW = dict(vocab_size=32, num_codebooks=2, hidden_size=64,
                num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=128)


def _close_leaves(got: dict, want: dict, tol: float, what: str):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        top = max(float(np.abs(w).max()), 1e-30)
        gap = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        assert gap <= tol * top, (what, k, gap / top)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _slm_batch(B, L, lcfg, seed=1):
    """Ragged rows: BOS, content, EOS, pad; the mask over content+EOS."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, lcfg.vocab_size, (B, L)).astype(np.int64)
    mask = np.zeros((B, L), np.float32)
    for b in range(B):
        n = L - 2 - (3 * b) % (L - 4)
        flat[b, 0], flat[b, n] = lcfg.bos_token, lcfg.eos_token
        flat[b, n + 1:] = lcfg.pad_token
        mask[b, 1:n + 1] = 1.0
    return flat, mask


def _jax_slm(kw, B=8, L=24, seed=1):
    lcfg = jllama.LlamaConfig(**kw)
    params = jllama.init_llama_params(jax.random.PRNGKey(seed), lcfg)
    tree = jax.tree.map(np.asarray, params)
    flat, mask = _slm_batch(B, L, lcfg, seed)

    def loss(p, f, m):
        logits = jllama.llama_forward(p, jllama.llama_embed(p, f, lcfg),
                                      lcfg)
        return jtrain.slm_interleaved_ce(logits, f, m, lcfg.num_codebooks,
                                         lcfg.vocab_size)

    grads = jax.tree.map(np.asarray, jax.grad(loss)(
        params, jnp.asarray(flat), jnp.asarray(mask)))
    return lcfg, params, tree, flat, mask, flatten_tree(grads), loss


def _jax_losses(lcfg, params, mesh, flat, mask, sequence_axis=None,
                steps=2):
    opt = optax.adam(1e-3)
    step = jax.jit(jtrain.make_slm_train_step(lcfg, opt, sequence_axis))
    out = []
    with jax.set_mesh(mesh):
        p = jtrain.shard_llama_params(params, mesh)
        st = opt.init(p)
        f, m = jmesh.shard_batch(mesh, flat.astype(np.int32)), \
            jmesh.shard_batch(mesh, mask)
        for _ in range(steps):
            p, st, loss = step(p, st, f, m)
            out.append(float(loss))
    return out


def _expected_split(kw, mp):
    """The leaves Megatron's layout splits: the attention when the KV
    heads divide, the FFN, table and head when their axes divide."""
    lcfg = jllama.LlamaConfig(**kw)
    out = set()
    for i in range(lcfg.num_layers):
        if lcfg.num_kv_heads % mp == 0:
            out |= {f"body.layers.{i}.{n}.w" for n in "qkvo"}
        if lcfg.intermediate_size % mp == 0:
            out |= {f"body.layers.{i}.mlp.{n}.w"
                    for n in ("gate", "up", "down")}
    if lcfg.flat_vocab % mp == 0:
        out.add("embedding.table")
    if lcfg.num_codebooks * lcfg.head_vocab % mp == 0:
        out.add("head.w")
    return out


@pytest.mark.parametrize("mp,kw", [
    (2, dict(LLAMA_KW, remat=True)),  # GQA split; 67 table rows whole
    (4, LLAMA_KW),  # 2 KV heads, 67 rows, 70 head columns stay whole
    (2, dict(LLAMA_KW, vocab_size=33, num_codebooks=1))])  # every block
def test_megatron_slm_step_matches_the_reference(mp, kw):
    lcfg, params, tree, flat, mask, jgrads, _ = _jax_slm(kw)
    jmesh_ = jmesh.make_mesh(8, model_parallel=mp, backend="cpu")
    want = _jax_losses(lcfg, params, jmesh_, flat, mask)
    shape = (4 // mp, mp)
    got = pmesh.spawn_ranks(workers.slm_steps, 4, shape,
                            ("data", "model"), kw, tree, flat, mask)
    for r in got:
        for a, b in zip(r["losses"], want):
            assert _rel(a, b) <= 1e-5
    grads = workers.assemble(got, mp)
    _close_leaves(grads, jgrads, 1e-5, f"Megatron mp={mp} gradients")
    assert got[0]["tree_keys"] == sorted(jgrads)
    split = {k for k, (_, a) in got[0]["grads"].items() if a is not None}
    assert split == _expected_split(kw, mp)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 1)])
def test_sequence_parallel_step_matches_the_reference(shape):
    lcfg, params, tree, flat, mask, jgrads, _ = _jax_slm(LLAMA_KW, B=4)
    grid = np.asarray(jax.devices("cpu")[:4]).reshape(shape)
    jm = jax.sharding.Mesh(grid, ("data", "seq", "model"))
    want = _jax_losses(lcfg, params, jm, flat, mask, sequence_axis="seq")
    got = pmesh.spawn_ranks(workers.slm_steps, 4, shape,
                            ("data", "seq", "model"), LLAMA_KW, tree, flat,
                            mask, 2, "tp", "seq")
    for r in got:
        for a, b in zip(r["losses"], want):
            assert _rel(a, b) <= 1e-5
    _close_leaves(workers.assemble(got, shape[2]), jgrads, 1e-5,
                  f"sequence parallel {shape} gradients")
