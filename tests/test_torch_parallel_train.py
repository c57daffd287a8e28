"""Port parity for the parallel layer's mesh and sharded codec step
(``audiocodecs_tpu_torch/parallel/{mesh,comm,train}.py``) against the JAX
package, on the CPU (the SLM steps: ``tests/test_torch_parallel_slm.py``).

The port's ranks are processes joined over gloo (``spawn_ranks``: a file
store in a temporary directory, one intra-op thread each), whose work is
in ``tests/torch_dist_workers.py`` (no JAX there); the JAX references come
from this process, on the 8-device virtual CPU mesh of ``conftest.py``.

* The mesh: axis sizes, coordinates and lines, this rank's rows of a
  batch (contiguous), the placements, data-parallel gathering; the
  refusals (more ranks than the group, an axis that does not divide it,
  CUDA without cards) before any group is joined.
* ``_leaf_spec`` rule for rule against the reference's on every leaf of
  the tiny EnCodec at mp = 2, 3, 4, and each port leaf's axis in the
  reference's layout.
* The sharded codec step (dp×tp on 4 ranks, (2, 2)): step 1's loss within
  1e-5 relative of the reference's sharded step, its gradients within
  1e-5 of each leaf's largest against ``jax.grad`` of the reference's
  ``codec_loss``; two steps' metrics, the EMA codebooks (dead-code
  restarts drawn over the global batch's rows) and every leaf against the
  port's one-device steps.
* Data-parallel serving on 4 ranks: tokens bit-equal to the reference
  codec's, waveforms within 1e-5 of max.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audiocodecs_tpu.models.encodec import Encodec as JEncodec
from audiocodecs_tpu.models.encodec import EncodecModelConfig as JConfig
from audiocodecs_tpu.parallel import mesh as jmesh
from audiocodecs_tpu.parallel import train as jtrain
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig
from audiocodecs_tpu_torch.parallel import mesh as pmesh
from audiocodecs_tpu_torch.parallel import train as ptrain
from audiocodecs_tpu_torch.params import (
    flatten_tree,
    from_jax_params,
    to_jax_params,
)
import torch_dist_workers as workers
from zoo_pairs import one_thread  # noqa: F401 (autouse)

CODEC_KW = dict(sampling_rate=800, num_filters=8, hidden_size=16,
                upsampling_ratios=(4, 2), codebook_size=64, codebook_dim=16,
                num_quantizers=4)


def _close_leaves(got: dict, want: dict, tol: float, what: str):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        top = max(float(np.abs(w).max()), 1e-30)
        gap = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        assert gap <= tol * top, (what, k, gap / top)


def _rel(a, b):
    return abs(a - b) / abs(b)


# ------------------------------- mesh --------------------------------- #


@pytest.mark.parametrize("shape,names", [
    ((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
    ((1, 2, 2), ("data", "seq", "model"))])
def test_mesh_axes_rows_and_gathers(shape, names):
    n = int(np.prod(shape))
    out = pmesh.spawn_ranks(workers.mesh_info, n, shape, names)
    D = shape[0]
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, o in enumerate(out):
        coords = np.unravel_index(r, shape)
        assert o["sizes"] == dict(zip(names, shape))
        assert o["index"] == {k: int(c) for k, c in zip(names, coords)}
        d = coords[0]
        rows = slice(d * 8 // D, (d + 1) * 8 // D)
        assert np.array_equal(o["x"], x[rows]) and o["contiguous"]
        assert np.array_equal(o["y1"], np.arange(16).reshape(8, 2)[rows])
        assert o["slice"] == rows
        assert o["placements"] == ["Shard" if a == "data" else "Replicate"
                                   for a in names]
        assert o["replicated"] == ["Replicate"] * len(names)
        assert o["main"] == (r == 0)
        assert np.array_equal(o["gathered"], np.arange(8.0)[:, None] * 2)
        grid = np.arange(n).reshape(shape)
        line = grid[tuple(slice(None) if i == names.index("model") else c
                          for i, c in enumerate(coords))]
        assert o["ranks"]["model"] == list(line)


def test_mesh_refusals_join_no_group():
    import torch.distributed as dist

    with pytest.raises(ValueError, match="requested 2 devices"):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        pmesh.make_mesh(1, device="cuda")
    with pytest.raises(ValueError, match="cards"):
        pmesh.spawn_ranks(workers.refusals, 2, device="cuda")
    assert not dist.is_initialized()
    assert pmesh.backend_for("cpu") == "gloo"
    assert pmesh.backend_for("cuda") == "nccl"
    out = pmesh.spawn_ranks(workers.refusals, 2)
    for o in out:
        assert "requested 4 devices" in o["more_ranks"]
        assert "not divisible by mp=3" in o["indivisible"]
        assert "3 experts not divisible" in o["experts"]
        assert "3 experts not divisible" in o["ep_experts"]
        assert "stage stack has 1 stages" in o["stages"]
        assert "moe_experts > 0" in o["ep_dense"]


# ------------------------------- codec -------------------------------- #


def test_leaf_spec_is_the_reference_rule():
    codec = Encodec(800, 800, model_config=EncodecModelConfig(**CODEC_KW),
                    num_codebooks=4, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    tree = to_jax_params(codec.state_dict(), codec)
    flat = flatten_tree(tree)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == len(flat) > 40
    for mp in (2, 3, 4):
        for path, leaf in leaves:
            pstr = "/".join(str(p) for p in path)
            spec = jtrain._leaf_spec(pstr, np.asarray(leaf), mp)
            want = next((i for i, a in enumerate(spec) if a == "model"),
                        None)
            assert ptrain._leaf_spec(pstr, leaf.shape, mp) == want, (pstr,
                                                                     mp)
    for name, p in codec.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = codec.get_submodule(owner_name) if owner_name else codec
        ref_shape, to_port = ptrain._port_axis(owner, leaf, p.shape)
        assert ref_shape == flat[name].shape, name
        for a, b in to_port.items():
            assert ref_shape[a] == p.shape[b], name


@pytest.fixture(scope="module")
def codec_case():
    """The tiny EnCodec's port state, its reference twin and two global
    batches of 8 rows."""
    codec = Encodec(800, 800, model_config=EncodecModelConfig(**CODEC_KW),
                    num_codebooks=4, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().numpy().copy()
             for k, v in codec.state_dict().items()}
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((8, 400)) * 0.3).astype(np.float32)
               for _ in range(2)]
    return codec, state, batches


def test_sharded_codec_step_matches_the_reference(codec_case):
    codec, state, batches = codec_case
    tree = to_jax_params(codec.state_dict(), codec)
    cfg = JConfig(**CODEC_KW)
    jparams = jax.tree.map(jnp.asarray, tree)
    # the reference's sharded step on a (2, 2) mesh: step 1's loss
    mesh = jmesh.make_mesh(4, model_parallel=2, backend="cpu")
    opt = optax.adam(1e-3)
    step = jax.jit(jtrain.make_codec_train_step(cfg, 4, opt,
                                                commit_warmup=1))
    with jax.set_mesh(mesh):
        sp = jtrain.shard_codec_params(jparams, mesh)
        _, _, jmet = step(sp, jtrain.init_codec_opt_state(opt, sp, 4),
                          jmesh.shard_batch(mesh, batches[0]))
    jgrads = jax.grad(lambda p: jtrain.codec_loss(
        p, jnp.asarray(batches[0]), cfg, 4, commit_weight=0.0,
        ema=True)[0])(jparams)
    jgrads = from_jax_params(jax.tree.map(np.asarray, jgrads), codec)

    got = pmesh.spawn_ranks(workers.codec_steps, 4, (2, 2), state, batches)
    one = workers.codec_steps(0, None, state, batches, sharded=False)
    for k in ("loss", "recon", "commit", "codebook_util"):
        assert _rel(got[0]["metrics"][0][k], float(jmet[k])) <= 1e-5, k
    grads = workers.assemble(got, 2)
    assert grads["codebooks"] is None  # EMA codebooks take no gradient
    _close_leaves({k: v for k, v in grads.items() if k != "codebooks"},
                  {k: v.numpy() for k, v in jgrads.items()
                   if k != "codebooks"}, 1e-5, "first-step gradients")
    for r in got:  # every rank reports the global metrics
        for a, b in zip(r["metrics"], one["metrics"]):
            for k in b:
                assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1e-3), k
    params = got[0]["params"]
    np.testing.assert_allclose(params["codebooks"], one["params"][
        "codebooks"], rtol=0, atol=1e-5 * np.abs(
            one["params"]["codebooks"]).max())
    _close_leaves(params, one["params"], 1e-4, "params after two steps")


def test_dp_serving_tokens_are_the_reference_tokens(codec_case):
    codec, state, _ = codec_case
    tree = to_jax_params(codec.state_dict(), codec)
    jc = JEncodec(800, 800, model_config=JConfig(**CODEC_KW),
                  num_codebooks=4, params=jax.tree.map(jnp.asarray, tree))
    sig = (np.random.default_rng(5).standard_normal((8, 400))
           * 0.1).astype(np.float32)
    toks = np.asarray(jc.sig_to_toks(jnp.asarray(sig)))
    rec = np.asarray(jc.toks_to_sig(jnp.asarray(toks)))
    for o in pmesh.spawn_ranks(workers.serve, 4, (4, 1), state, sig):
        assert np.array_equal(o["toks"], toks)
        scale = max(float(np.abs(rec).max()), 1.0)
        assert np.abs(o["rec"] - rec).max() <= 1e-5 * scale
