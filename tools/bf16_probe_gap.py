"""How far the port's bf16 training of the classification probe parts from
the JAX package's, on the CPU.

Under ``precision: bf16`` both trainers compute the loss through a bf16
cast of the float32 params. The JAX package runs the probe's LSTM
recurrence in bf16; the port runs it in float32, the gates and ``w_hh``
cast up at the kernel's boundary and the output cast back down (the LSTM
kernel takes float32 only). For each seed this tool builds the probe of
``tests/test_torch_trainer.py`` (K = 2, C = 32, 16 wide, 3 classes; the
JAX init), takes two Adam steps at lr 1e-2 in each package and each
precision, and prints one JSON line a seed: the first batch's loss in each
package and precision, and the relative L2 distance between updates
(params minus init) of port bf16 and JAX bf16, JAX fp32 and JAX bf16 (the
reference's own bf16 noise) and port fp32 and JAX fp32.

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tools/bf16_probe_gap.py [--seeds 4]
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np


def _probe_case(seed, H=16):
    import jax

    from audiocodecs_tpu.downstream.recipes import classification as jcls

    K, C, E, classes = 2, 32, 16, 3
    init = jax.tree.map(np.asarray, jcls.build_probe_params(
        jax.random.PRNGKey(seed), K, C, E, H, classes))
    rng = np.random.default_rng(seed)
    batches = [{"toks": rng.integers(0, C, (3, 20, K)),
                "length": np.asarray([1.0, 0.75, 0.4], np.float32),
                "label": rng.integers(0, classes, 3)} for _ in range(2)]
    return init, batches, C


def _flat(tree):
    import jax

    return np.concatenate([np.ravel(np.asarray(x))
                           for x in jax.tree.leaves(tree)])


def measure(seed: int) -> dict:
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from audiocodecs_tpu.downstream.recipes import classification as jcls
    from audiocodecs_tpu.downstream.recipes import trainer as jtrainer
    from audiocodecs_tpu_torch.downstream.recipes import (
        classification,
        trainer,
    )

    init, batches, C = _probe_case(seed)

    def jloss(params, batch, key):
        logits = jcls.probe_forward(params, batch["toks"], batch["length"],
                                    vocab_size=C)
        oh = jax.nn.one_hot(batch["label"], logits.shape[-1])
        return optax.softmax_cross_entropy(logits, oh).mean(), {}

    def ploss(params, batch, generator):
        return classification.classification_loss(params, batch, generator,
                                                  vocab_size=C)

    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    i0 = _flat(init)
    out, upd = {"seed": seed}, {}
    for prec in ("fp32", "bf16"):
        jt = jtrainer.Trainer(jloss, jax.tree.map(jnp.asarray, init),
                              lr=1e-2, output_folder=tempfile.mkdtemp(),
                              precision=prec)
        out[f"jax_{prec}_loss"] = float(jt.loss_fn(jt.params, jb[0], None)[0])
        jt.fit(1, lambda: iter(jb))
        pt = trainer.Trainer(ploss, classification.probe_params_from_jax(
            init), lr=1e-2, output_folder=tempfile.mkdtemp(), precision=prec)
        with torch.no_grad():
            out[f"port_{prec}_loss"] = float(pt.compute_loss(tb[0], None)[0])
        pt.fit(1, lambda: iter(tb))
        upd["jax", prec] = _flat(jt.params) - i0
        upd["port", prec] = _flat(pt.jax_params()) - i0

    def rel(a, b):
        return float(np.linalg.norm(upd[a] - upd[b]) / np.linalg.norm(upd[b]))

    out["update_port_bf16_vs_jax_bf16"] = rel(("port", "bf16"),
                                              ("jax", "bf16"))
    out["update_jax_fp32_vs_jax_bf16"] = rel(("jax", "fp32"), ("jax", "bf16"))
    out["update_port_fp32_vs_jax_fp32"] = rel(("port", "fp32"),
                                              ("jax", "fp32"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    for seed in range(args.seeds):
        print(json.dumps(measure(seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
