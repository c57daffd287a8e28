"""Port parity for the downstream trainer (``audiocodecs_tpu_torch/downstream/
recipes/trainer.py``) against the JAX package's optax chain, on the CPU.

* ``newbob_schedule``: the same LR decisions over a metric sequence, for
  both directions and patiences; ``trainer_kwargs`` the same dict.
* ``Trainer``: 4 steps on a small loss from the same params and batches,
  with the global-norm clip triggered (``max_grad_norm`` 0.05) and not
  (5.0): params within 1e-5 relative of the JAX ``Trainer``'s; the same
  through an ``nn.Module`` as through a param tree.
* ``grad_accumulation_factor = 2``: the same params after 4 steps, and
  Adam's step count 2.
* A non-finite loss is skipped (params as if the batch were absent) and
  past ``nonfinite_patience`` the fit raises.
* ``precision: bf16`` on the classification probe (H = 16), where the port
  runs the recurrence in float32 (the kernel takes float32 only) and the
  JAX package in bf16: the bf16 loss within 1e-2 relative of JAX's, and
  the update of 2 steps (params minus init) within 0.1 relative (L2) of
  JAX's bf16 update. Measured over seeds 0-3: losses equal or 4.8e-3
  apart (one bf16 step), updates 1.7e-2 to 7.8e-2 apart, where JAX's own
  bf16 and fp32 updates are 3.0e-2 to 6.1e-2 apart and the two packages'
  fp32 updates 1.9e-6 (``tools/bf16_probe_gap.py``, this file's probe).
  A param tree and an ``nn.Module`` agree exactly.
* Checkpoints written by either package load in the other.
* In one process, ``model_parallel > 1`` and a ``param_sharder`` are
  refused (a model axis the one rank cannot hold; a sharder with one
  device, the reference's message); the mesh runs are
  ``tests/test_torch_parallel_recipes.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.downstream.recipes import classification as jcls
from audiocodecs_tpu.downstream.recipes import trainer as jtrainer
from audiocodecs_tpu.utils.checkpoint import load_params as jload_params
from audiocodecs_tpu.utils.checkpoint import save_params as jsave_params
from audiocodecs_tpu_torch.downstream.recipes import classification, trainer
from zoo_pairs import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("lower,patience,factor", [
    (True, 0, 0.5), (True, 2, 0.5), (False, 1, 0.8)])
def test_newbob_makes_the_same_decisions(lower, patience, factor):
    metrics = [1.0, 0.9, 0.899, 0.899, 0.95, 0.7, 0.7, 0.71, 0.5, 0.5, 0.5]
    if not lower:
        metrics = [1.0 - m for m in metrics]
    got = trainer.newbob_schedule(1e-3, factor, 0.0025, patience, lower)
    want = jtrainer.newbob_schedule(1e-3, factor, 0.0025, patience, lower)
    assert [got.update(m) for m in metrics] == [want.update(m)
                                                for m in metrics]


def test_trainer_kwargs_match():
    cfg = {"grad_accumulation_factor": "2", "max_grad_norm": 3,
           "precision": "bf16", "lr_patience": 1.0, "epochs": 4,
           "keep_checkpoints": 2, "lr_annealing_factor": "0.25"}
    assert trainer.trainer_kwargs(cfg) == jtrainer.trainer_kwargs(cfg)


def _data(n_batches=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((6, 5)).astype(np.float32),
             "y": rng.standard_normal((6, 3)).astype(np.float32)}
            for _ in range(n_batches)]


def _init(seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32) * 0.1}


def _jax_loss(params, batch, key):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2 * 0.5), {}


def _port_loss(params, batch, generator):
    w, b = ((params.w, params.b) if isinstance(params, torch.nn.Module)
            else (params["w"], params["b"]))
    pred = batch["x"].to(w.dtype) @ w + b  # torch does not promote in @
    return torch.mean((pred - batch["y"]) ** 2 * 0.5), {}


class _Affine(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(tree["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(tree["b"].copy()))


def _jax_fit(tmp_path, batches, **kw):
    t = jtrainer.Trainer(_jax_loss, {k: jnp.asarray(v)
                                     for k, v in _init().items()},
                         lr=0.05, output_folder=str(tmp_path / "jax"), **kw)
    t.fit(1, lambda: iter([{k: jnp.asarray(v) for k, v in b.items()}
                           for b in batches]))
    return t


def _port_fit(tmp_path, batches, module=False, **kw):
    init = _init()
    params = (_Affine(init) if module else
              {k: torch.from_numpy(v.copy()) for k, v in init.items()})
    t = trainer.Trainer(_port_loss, params, lr=0.05,
                        output_folder=str(tmp_path / "port"), **kw)
    t.fit(1, lambda: iter([{k: torch.from_numpy(v) for k, v in b.items()}
                           for b in batches]))
    return t


def _assert_params_close(got, want, rtol=1e-5):
    for k, w in want.items():
        g = got[k]
        w = np.asarray(w)
        assert np.abs(g - w).max() <= rtol * np.abs(w).max(), k


@pytest.mark.parametrize("max_norm", [0.05, 5.0])
@pytest.mark.parametrize("module", [False, True], ids=["tree", "module"])
def test_trainer_steps_match_jax(tmp_path, max_norm, module):
    batches = _data()
    # the clip's case is the one asked for: every step's gradient norm is
    # above 0.05 and below 5
    for b in batches:
        g = jax.grad(lambda p: _jax_loss(p, b, None)[0])(
            {k: jnp.asarray(v) for k, v in _init().items()})
        norm = float(jnp.sqrt(sum(jnp.sum(x * x) for x in
                                  jax.tree.leaves(g))))
        assert 0.05 < norm < 5.0
    want = _jax_fit(tmp_path, batches, max_grad_norm=max_norm)
    got = _port_fit(tmp_path, batches, module=module,
                    max_grad_norm=max_norm)
    _assert_params_close(got.jax_params(), want.params)
    assert os.path.exists(tmp_path / "port" / "ckpt_latest.npz")


def test_grad_accumulation_matches_jax(tmp_path):
    batches = _data()
    want = _jax_fit(tmp_path, batches, grad_accumulation_factor=2,
                    max_grad_norm=0.05)
    got = _port_fit(tmp_path, batches, grad_accumulation_factor=2,
                    max_grad_norm=0.05)
    _assert_params_close(got.jax_params(), want.params)
    steps = {int(s["step"]) for s in got.optimizer.state.values()}
    assert steps == {2}
    # one step short of the second update: the params are the first's
    one = _port_fit(tmp_path, batches[:3], grad_accumulation_factor=2)
    two = _port_fit(tmp_path, batches[:2], grad_accumulation_factor=2)
    _assert_params_close(one.jax_params(), two.jax_params(), rtol=0)


def test_nonfinite_loss_is_skipped(tmp_path):
    batches = _data()
    bad = {"x": batches[1]["x"].copy(), "y": batches[1]["y"]}
    bad["x"][0, 0] = np.nan
    got = _port_fit(tmp_path, batches[:1] + [bad] + batches[1:])
    want = _port_fit(tmp_path, batches)
    _assert_params_close(got.jax_params(), want.jax_params(), rtol=0)
    log = (tmp_path / "port" / "train_log.txt").read_text()
    assert "skipped non-finite loss" in log
    with pytest.raises(RuntimeError, match="non-finite 2 times"):
        _port_fit(tmp_path, [bad, bad], nonfinite_patience=1)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_packages(tmp_path, writer):
    batches = _data(2)
    port = _port_fit(tmp_path, batches)
    jax_t = _jax_fit(tmp_path, batches)
    if writer == "port":
        port.save_checkpoint("best")
        tree = jload_params(str(tmp_path / "port" / "ckpt_best.npz"))
        _assert_params_close(tree, port.jax_params(), rtol=0)
    else:
        jsave_params(str(tmp_path / "port" / "ckpt_best.npz"),
                     jax.tree.map(np.asarray, jax_t.params))
        loaded = port.load_checkpoint("best")
        assert loaded is port.params
        _assert_params_close(port.jax_params(), jax_t.params, rtol=0)
        mod = _port_fit(tmp_path, batches, module=True)
        mod.load_checkpoint("best")
        _assert_params_close(mod.jax_params(), jax_t.params, rtol=0)


def test_model_parallel_raises(tmp_path):
    import torch.distributed as dist

    p = {"w": torch.zeros(2)}
    out = str(tmp_path)
    with pytest.raises(ValueError, match="1 devices not divisible by mp=2"):
        trainer.Trainer(_port_loss, p, model_parallel=2, output_folder=out)
    with pytest.raises(ValueError, match="only one device is visible"):
        trainer.Trainer(_port_loss, p, param_sharder=lambda p, m: p,
                        output_folder=out)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="precision"):
        trainer.Trainer(_port_loss, p, precision="fp16")


def _probe_case(seed=0, H=16):
    """The classification probe at a small width and two batches of
    tokens, in both packages' forms."""
    K, C, E, classes = 2, 32, 16, 3
    init = jax.tree.map(np.asarray, jcls.build_probe_params(
        jax.random.PRNGKey(seed), K, C, E, H, classes))
    rng = np.random.default_rng(seed)
    batches = [{"toks": rng.integers(0, C, (3, 20, K)),
                "length": np.asarray([1.0, 0.75, 0.4], np.float32),
                "label": rng.integers(0, classes, 3)} for _ in range(2)]
    return init, batches, C


def _jax_probe_loss(C):
    import optax

    def loss(params, batch, key):
        logits = jcls.probe_forward(params, batch["toks"], batch["length"],
                                    vocab_size=C)
        oh = jax.nn.one_hot(batch["label"], logits.shape[-1])
        return optax.softmax_cross_entropy(logits, oh).mean(), {}
    return loss


def test_bf16_probe_steps_within_the_measured_tolerance(tmp_path):
    init, batches, C = _probe_case()
    jt = jtrainer.Trainer(_jax_probe_loss(C), jax.tree.map(jnp.asarray, init),
                          lr=1e-2, output_folder=str(tmp_path / "jax"),
                          precision="bf16")
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jloss = float(jt.loss_fn(jt.params, jbatches[0], None)[0])
    jt.fit(1, lambda: iter(jbatches))

    def loss(params, batch, generator):
        return classification.classification_loss(params, batch, generator,
                                                  vocab_size=C)

    tbatches = [{k: torch.from_numpy(v) for k, v in b.items()}
                for b in batches]
    t = trainer.Trainer(loss, classification.probe_params_from_jax(init),
                        lr=1e-2, output_folder=str(tmp_path / "port"),
                        precision="bf16")
    ploss = float(t.compute_loss(tbatches[0], None)[0].detach())
    t.fit(1, lambda: iter(tbatches))
    assert abs(ploss - jloss) <= 1e-2 * abs(jloss), (ploss, jloss)
    def flat(tree):
        return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])

    i0 = flat(init)
    got = flat(t.jax_params()) - i0
    want = flat(jax.tree.map(np.asarray, jt.params)) - i0
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= 0.1, err


def test_bf16_module_and_tree_agree(tmp_path):
    """The module's bf16 loss runs through ``torch.func.functional_call``
    on the cast params, the tree's through the cast tree: the same steps."""
    batches = _data()
    tree = _port_fit(tmp_path, batches, precision="bf16")
    mod = _port_fit(tmp_path, batches, module=True, precision="bf16")
    _assert_params_close(mod.jax_params(), tree.jax_params(), rtol=0)
    fp32 = _port_fit(tmp_path, batches)
    assert not np.array_equal(fp32.jax_params()["w"], tree.jax_params()["w"])
