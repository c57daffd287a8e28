"""Training loop for the downstream recipes.

Counterpart of ``audiocodecs_tpu/downstream/recipes/trainer.py``, which
replaces the reference's SpeechBrain ``Brain`` lifecycle (NewBob annealing,
the checkpointer, non-finite patience, the train log — reference
``train_asr.py:40-163``, ``tasks/asr.yaml:180-188``).

The reference package's update is an optax chain, and this trainer keeps
its rule, not the nearest torch default:

* **clipping** by the global norm ``g`` of all gradients, scaled by
  ``max_norm / g`` only when ``g >= max_norm`` (``optax.clip_by_global_norm``;
  ``torch.nn.utils.clip_grad_norm_`` divides by ``g + 1e-6`` and is not used);
* **Adam** (``torch.optim.Adam``: b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, as ``optax.adam``); the NewBob schedule writes each param
  group's ``lr``;
* **accumulation** as ``optax.MultiSteps``: the running mean of k
  microbatch gradients, with clip and Adam applied once every k steps, so
  Adam's step count counts only the applied updates;
* a **non-finite loss** skips the step (no gradient, no optimizer state
  change) and counts against ``nonfinite_patience``;
* ``precision: bf16`` computes the loss through a bf16 cast of the float32
  params; the gradients and the update stay float32.

The model is a tree of tensors (nested dicts and lists, the reference's
param-tree layout) or an ``nn.Module``; ``loss_fn(model_or_params, batch,
generator) -> (loss, aux)``. Checkpoints ``ckpt_{best,latest,eN}.npz`` are
written by :func:`..utils.checkpoint.save_params` in the reference's key
layout (a module through :func:`..params.to_jax_params`), so a checkpoint
of either package loads in the other.

Over several ranks (a ``torch.distributed`` group of more than one rank,
``model_parallel > 1`` or a prebuilt ``mesh``) the trainer runs on a
``(data, model)`` mesh (:func:`...parallel.mesh.make_mesh`), as the
reference's does: each batch whose rows divide by the data degree is split
on ``data`` (else every rank takes all of it), the loss is the mean of the
ranks' values and the gradients their mean. A ``param_sharder(params,
mesh)`` returns a :class:`...parallel.train.ShardedModule` (Megatron,
expert or pipeline parallelism), which reduces its own gradients and
makes the clip's global norm: its split leaves' squares summed over
``model``, each replicated leaf counted once. Logs and checkpoints are
written by rank 0 only; a sharded checkpoint is gathered whole, so
:meth:`Trainer.load_checkpoint` and the evaluation see the one-device tree.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from audiocodecs_tpu_torch.downstream.recipes.common import is_main_process
from audiocodecs_tpu_torch.parallel.comm import all_reduce
from audiocodecs_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    axis_size,
    launched_world_size,
    local_batch_slice,
)
from audiocodecs_tpu_torch.parallel.train import ShardedModule
from audiocodecs_tpu_torch.params import flatten_tree
from audiocodecs_tpu_torch.utils.checkpoint import load_params, save_params

__all__ = ["Trainer", "newbob_schedule", "params_from_jax", "params_to_jax",
           "trainer_kwargs", "tree_map"]


def trainer_kwargs(cfg: dict) -> dict:
    """Config keys every recipe forwards to the Trainer (reference run-opt
    surface: ``grad_accumulation_factor``, ``ckpt_interval_steps``,
    ``nonfinite_patience``, ``keep_checkpoints`` —
    ``hparams/tasks/asr.yaml:30-39``)."""
    out = {}
    for k in ("grad_accumulation_factor", "ckpt_interval_steps",
              "nonfinite_patience", "keep_checkpoints", "max_grad_norm",
              "precision", "lr_annealing_factor",
              "lr_improvement_threshold", "lr_patience"):
        if k in cfg:
            out[k] = (float(cfg[k])
                      if k in ("max_grad_norm", "lr_annealing_factor",
                               "lr_improvement_threshold")
                      else cfg[k] if k == "precision" else int(cfg[k]))
    return out


class newbob_schedule:
    """NewBob-style annealing: multiply the LR by ``factor`` when the
    validation metric fails to improve by ``threshold`` for more than
    ``patience`` epochs (SpeechBrain's NewBob, reference
    ``train_asr.py:148-163``)."""

    def __init__(self, lr: float, factor: float = 0.5, threshold: float = 0.0025,
                 patience: int = 0, lower_is_better: bool = True):
        self.lr = lr
        self.factor = factor
        self.threshold = threshold
        self.patience = patience
        self.lower_is_better = lower_is_better
        self.best = math.inf if lower_is_better else -math.inf
        self.bad_epochs = 0

    def update(self, metric: float) -> float:
        improved = (
            (self.best - metric) > self.threshold
            if self.lower_is_better
            else (metric - self.best) > self.threshold
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def params_from_jax(tree, device=None):
    """The reference package's param tree (numpy arrays) as the same tree
    of float32 tensors on ``device``: the probes' weight bridge."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device), tree)


def params_to_jax(tree):
    """A tree of tensors as the reference's tree of float32 numpy arrays."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(),
                    tree)


class _ModuleLoss(nn.Module):
    """``loss_fn(model, …)`` as a module, so that ``torch.func.
    functional_call`` can run it on a bf16 cast of the model's params."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch, generator):
        return self.loss_fn(self.model, batch, generator)


class Trainer:
    def __init__(
        self,
        loss_fn: Callable,  # (model_or_params, batch, generator) -> (loss, aux)
        params,
        lr: float = 1e-3,
        output_folder: str = "results",
        max_grad_norm: float = 5.0,
        nonfinite_patience: int = 10,
        keep_checkpoints: int = 1,
        lower_is_better: bool = True,
        model_parallel: int = 1,
        param_sharder: Optional[Callable] = None,
        mesh=None,
        grad_accumulation_factor: int = 1,
        ckpt_interval_steps: int = 0,
        precision: str = "fp32",
        lr_annealing_factor: float = 0.5,
        lr_improvement_threshold: float = 0.0025,
        lr_patience: int = 0,
    ):
        """``params``: a tree of tensors (its float leaves detached and made
        trainable; ``self.params`` is that tree) or an ``nn.Module``, on the
        device the loss runs on. ``model_parallel > 1`` carves a ``(data,
        model)`` mesh out of the process group's ranks (one a device) and
        ``param_sharder(params, mesh)`` places the params on it; a
        prebuilt ``mesh`` is used as it is (pipeline parallelism's loss
        closes over the same mesh)."""
        if precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be fp32|bf16, got {precision}")
        self.mesh = mesh
        mp = max(1, int(model_parallel))
        if self.mesh is None and (launched_world_size() > 1 or mp > 1):
            from audiocodecs_tpu_torch.parallel.mesh import make_mesh

            first = (next(params.parameters()) if isinstance(params,
                                                              nn.Module)
                     else _leaves(params)[0])
            self.mesh = make_mesh(model_parallel=mp, device=first.device)
        if self.mesh is not None:
            if param_sharder is not None:
                params = param_sharder(params, self.mesh)
        elif param_sharder is not None:
            raise ValueError(
                "param_sharder given but only one device is visible")
        self.sharded = isinstance(params, ShardedModule)
        self.precision = precision
        self.loss_fn = loss_fn
        self.is_module = isinstance(params, nn.Module)
        if self.is_module:
            self._leaves = [p for p in params.parameters() if p.requires_grad]
            self._module_loss = _ModuleLoss(params, loss_fn)
        else:
            params = tree_map(
                lambda t: t.detach().requires_grad_(t.is_floating_point()),
                params)
            self._leaves = [t for t in _leaves(params) if t.requires_grad]
        self.params = params
        self.output_folder = output_folder
        # NewBob's yaml surface (annealing_factor / improvement_threshold /
        # patient); lr_patience > 0 lets CTC leave its all-blank plateau on
        # small corpora before the LR is halved
        self.scheduler = newbob_schedule(
            lr, factor=lr_annealing_factor,
            threshold=lr_improvement_threshold,
            patience=lr_patience, lower_is_better=lower_is_better)
        self.lower_is_better = lower_is_better
        self.nonfinite_patience = nonfinite_patience
        self.keep_checkpoints = keep_checkpoints
        self.max_grad_norm = float(max_grad_norm)
        os.makedirs(output_folder, exist_ok=True)
        self._log_path = os.path.join(output_folder, "train_log.txt")
        self.optimizer = torch.optim.Adam(self._leaves, lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self._accum = max(1, int(grad_accumulation_factor))
        self._mini_step = 0
        self._acc = None  # running mean of the microbatch gradients
        self.ckpt_interval_steps = max(0, int(ckpt_interval_steps))
        self._kept: list = []
        self.best_metric = math.inf if lower_is_better else -math.inf
        n_params = sum(t.numel() for t in self._leaves)
        dev = self._leaves[0].device if self._leaves else "cpu"
        mesh_note = ("" if self.mesh is None else ", mesh " + str(
            dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))))
        self.log(f"trainer: {n_params / 1e6:.2f} M trainable params, "
                 f"device {dev}{mesh_note}")

    @property
    def device(self) -> torch.device:
        return self._leaves[0].device

    def log(self, msg: str):
        if is_main_process():
            with open(self._log_path, "a") as f:
                f.write(msg + "\n")
            print(msg, flush=True)

    def _set_lr(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def compute_loss(self, batch, generator):
        """``(loss, aux)`` of the current params (float32 loss), through
        their bf16 cast under ``precision: bf16``."""
        def to16(t):
            return (t.to(torch.bfloat16) if t.dtype == torch.float32
                    else t)

        if self.precision == "fp32":
            loss, aux = self.loss_fn(self.params, batch, generator)
        elif self.is_module:
            cast = {k: to16(v) for k, v in
                    self._module_loss.named_parameters()}
            loss, aux = torch.func.functional_call(
                self._module_loss, cast, (batch, generator))
        else:
            loss, aux = self.loss_fn(tree_map(to16, self.params), batch,
                                     generator)
        return loss.to(torch.float32), aux

    def _data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over the mesh's data axis (itself without one)."""
        if self.mesh is None:
            return t
        return all_reduce(t, axis_group(self.mesh, DATA_AXIS)) / axis_size(
            self.mesh, DATA_AXIS)

    def _place_batch(self, batch):
        """This rank's rows of ``batch`` when every leaf's rows divide by
        the data degree, else ``batch`` whole (every rank computes it)."""
        if self.mesh is None:
            return batch
        n = axis_size(self.mesh, DATA_AXIS)
        leaves = _leaves(batch)
        split = not any(np.ndim(x) == 0 or np.shape(x)[0] % n
                        for x in leaves)
        if self.sharded:
            self.params.data_split = split
        if not split:
            return batch
        rows = local_batch_slice(np.shape(leaves[0])[0], self.mesh)
        return tree_map(lambda x: x[rows].contiguous()
                        if isinstance(x, torch.Tensor) else x[rows], batch)

    def _clip(self, grads: list) -> list:
        """``optax.clip_by_global_norm``: unchanged below ``max_norm``,
        else ``(g / norm) * max_norm``."""
        if self.sharded:
            norm = torch.sqrt(self.params.sq_norm(grads))
        else:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.max_grad_norm
        return [torch.where(keep, g, (g / norm) * self.max_grad_norm)
                for g in grads]

    def step(self, batch, generator):
        """One train step: ``(loss as a float, aux, applied)``. A non-finite
        loss leaves params and optimizer state as they were; with
        accumulation, ``applied`` is True on the steps that update. On a
        mesh ``batch`` is this rank's part (``fit`` places it) and the loss
        is the ranks' mean."""
        loss, aux = self.compute_loss(batch, generator)
        value = float(self._data_mean(loss.detach()))
        if not math.isfinite(value):
            return value, aux, False
        grads = torch.autograd.grad(loss, self._leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._leaves, grads)]
        if self.sharded:
            grads = self.params.reduce_grads(grads)
        elif self.mesh is not None:
            grads = [self._data_mean(g) for g in grads]
        if self._accum > 1:
            n = self._mini_step
            self._acc = (grads if self._acc is None else
                         [a + (g - a) / (n + 1)
                          for a, g in zip(self._acc, grads)])
            self._mini_step += 1
            if self._mini_step < self._accum:
                return value, aux, False
            grads, self._acc, self._mini_step = self._acc, None, 0
        for p, g in zip(self._leaves, self._clip(grads)):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return value, aux, True

    def fit(
        self,
        epochs: int,
        train_loader_fn: Callable[[], Iterable[dict]],
        valid_fn: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``valid_fn(model_or_params) -> metric`` runs once per epoch;
        ``generator`` (on the params' device; seed 0 if None) is handed to
        every loss call."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        nonfinite = 0
        global_step = 0
        for epoch in range(1, epochs + 1):
            t0 = time.time()
            losses = []
            for batch in train_loader_fn():
                loss, _, _ = self.step(self._place_batch(batch), generator)
                if not math.isfinite(loss):
                    nonfinite += 1
                    if nonfinite > self.nonfinite_patience:
                        raise RuntimeError(
                            f"loss non-finite {nonfinite} times — aborting"
                        )
                    self.log(f"epoch {epoch}: skipped non-finite loss")
                    continue
                losses.append(loss)
                global_step += 1
                if (self.ckpt_interval_steps
                        and global_step % self.ckpt_interval_steps == 0):
                    # mid-epoch checkpoint (reference ckpt_interval_steps,
                    # hparams/tasks/asr.yaml:38)
                    self.save_checkpoint("latest")
            train_loss = float(np.mean(losses)) if losses else float("nan")
            stats = {
                "epoch": epoch,
                "lr": self.scheduler.lr,
                "train_loss": round(train_loss, 4),
                "time_s": round(time.time() - t0, 1),
            }
            if valid_fn is not None:
                with torch.no_grad():
                    metric = float(valid_fn(self.params))
                stats["valid_metric"] = round(metric, 4)
                self._set_lr(self.scheduler.update(metric))
                better = (
                    metric < self.best_metric
                    if self.lower_is_better
                    else metric > self.best_metric
                )
                if better:
                    self.best_metric = metric
                    self.save_checkpoint("best")
                if self.keep_checkpoints > 1:
                    # keep the N metric-best epoch checkpoints (reference
                    # save_and_keep_only(num_to_keep), train_asr.py:158-163)
                    tag = f"e{epoch}"
                    self.save_checkpoint(tag)
                    self._kept.append((metric, os.path.join(
                        self.output_folder, f"ckpt_{tag}.npz")))
                    self._kept.sort(key=lambda t: t[0],
                                    reverse=not self.lower_is_better)
                    for _, pth in self._kept[self.keep_checkpoints:]:
                        if is_main_process() and os.path.exists(pth):
                            os.remove(pth)
                    self._kept = self._kept[: self.keep_checkpoints]
            self.save_checkpoint("latest")
            self.log(json.dumps(stats))
        return self.params

    def jax_params(self):
        """The current params as the reference's tree of numpy arrays
        (sharded params gathered whole: every rank must call it)."""
        if self.sharded:
            return self.params.jax_tree()
        if self.is_module:
            from audiocodecs_tpu_torch.params import to_jax_params

            return to_jax_params(self.params.state_dict(), self.params)
        return params_to_jax(self.params)

    def save_checkpoint(self, tag: str):
        tree = self.jax_params()  # a collective when sharded
        if is_main_process():
            save_params(os.path.join(self.output_folder, f"ckpt_{tag}.npz"),
                        tree)
        if self.mesh is not None:
            # no rank may read the file before the main process has written
            torch.distributed.barrier()

    def load_checkpoint(self, tag: str = "best"):
        """Copy ``ckpt_<tag>.npz``, if it exists, into the params in place
        (the optimizer keeps them); returns the params."""
        path = os.path.join(self.output_folder, f"ckpt_{tag}.npz")
        if os.path.exists(path):
            tree = load_params(path)
            if self.sharded:
                self.params.load_jax_tree(tree)
            elif self.is_module:
                from audiocodecs_tpu_torch.params import from_jax_params

                self.params.load_state_dict(
                    from_jax_params(tree, self.params), strict=True)
            else:
                want, got = flatten_tree(self.params), flatten_tree(tree)
                if sorted(want) != sorted(got):
                    raise KeyError(f"{path}: keys {sorted(got)[:5]} do not "
                                   f"match the params' {sorted(want)[:5]}")
                with torch.no_grad():
                    for name, dst in want.items():
                        dst.copy_(torch.from_numpy(np.asarray(got[name])))
        return self.params
