"""The multichip dry run on ``torch.distributed``.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: ``n`` ranks, one
process each, joined over a file store in a temporary directory
(:func:`.mesh.spawn_ranks`), take the reference's six sharded steps on its
tiny configs over a ``(data = n/2, model = 2)`` mesh (``model = 1`` for
odd ``n``):

1. codec dp×tp: the VQ-VAE step, batch on ``data``, conv out-channels,
   LSTM gates and codebook vocab on ``model`` (:func:`.train.
   shard_codec_params`);
2. SLM dp×tp: the Llama step with Megatron's layout (:func:`.train.
   shard_llama_params`);
3. dp×sp×tp when ``n % 8 == 0``: the same step with its tokens split on a
   ``seq`` axis of a ``(data, seq, model)`` mesh;
4. dp×pp: a GPipe schedule of the decoder's layers over the ``model`` axis
   (:mod:`.pipeline`);
5. dp×ep: the switch-MoE decoder with its experts on ``model``
   (:func:`.moe.shard_moe_llama_params`);
6. data-parallel serving: ``sig_to_toks`` then ``toks_to_sig`` on each
   rank's rows, gathered (:func:`.mesh.data_parallel`).

It is a check of the parallel math, not a smoke test: every step's loss is
held within 2e-4 relative of the same step unsharded on one rank (the
reference holds steps 1-2 so; steps 3-5 here too), and serving's tokens
bit-equal to the one-rank path with waveforms within 1e-5 of their
largest magnitude.

Run: ``python -m audiocodecs_tpu_torch.parallel.dryrun [N] [--device
cpu]`` (the card by default, one rank a card).
"""

from __future__ import annotations

import copy
import sys

import numpy as np
import torch

__all__ = ["dryrun_multichip"]

RTOL = 2e-4


def _close(sharded: float, ref: float, what: str) -> None:
    rel = abs(sharded - ref) / max(abs(ref), 1e-8)
    if not (np.isfinite(sharded) and rel <= RTOL):
        raise AssertionError(f"{what}: sharded loss {sharded!r} != unsharded "
                             f"{ref!r} (rel {rel:.2e} > {RTOL})")


def _llama(lcfg, seed: int, dev):
    from audiocodecs_tpu_torch.downstream.models.llama import (
        Llama, init_llama_params)

    model = Llama(lcfg)
    model.load_state_dict(init_llama_params(
        torch.Generator().manual_seed(seed), lcfg))
    return model.to(dev)


def _slm_pair(lcfg, seed: int, dev, shard, lr: float, flat, mask, **kw):
    """(sharded step's loss, unsharded step's loss) from one init."""
    from audiocodecs_tpu_torch.parallel.train import make_slm_train_step

    ref = _llama(lcfg, seed, dev)
    sharded = shard(copy.deepcopy(ref))
    flat = torch.as_tensor(flat, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    want = float(make_slm_train_step(ref, torch.optim.Adam(
        ref.parameters(), lr))(flat, mask))
    got = float(make_slm_train_step(sharded, torch.optim.Adam(
        sharded.parameters(), lr), **kw)(flat, mask))
    return got, want


def _rank(rank: int, n: int, device_type: str) -> str:
    from audiocodecs_tpu_torch.downstream.models.llama import LlamaConfig
    from audiocodecs_tpu_torch.models.encodec import (
        Encodec, EncodecModelConfig)
    from audiocodecs_tpu_torch.parallel.mesh import (
        SEQ_AXIS, data_parallel, make_mesh)
    from audiocodecs_tpu_torch.parallel.moe import shard_moe_llama_params
    from audiocodecs_tpu_torch.parallel.pipeline import (
        make_pp_slm_train_step, shard_pp_llama_params,
        stack_pipeline_stages)
    from audiocodecs_tpu_torch.parallel.train import (
        init_codec_opt_state, make_codec_train_step, shard_codec_params,
        shard_llama_params)
    from audiocodecs_tpu_torch.params import to_jax_params

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    mp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n, model_parallel=mp, device=device_type)

    # ---- step 1: codec dp × tp ---- #
    cfg = EncodecModelConfig(sampling_rate=800, num_filters=8,
                             hidden_size=16, upsampling_ratios=(4, 2),
                             codebook_size=64, codebook_dim=16,
                             num_quantizers=4)
    codec = Encodec(800, 800, model_config=cfg, num_codebooks=4, device=dev,
                    generator=torch.Generator().manual_seed(0))
    batch = np.random.default_rng(0).standard_normal(
        (n * 2, 400)).astype(np.float32)
    losses = []
    for sharded in (False, True):
        model = Encodec(800, 800, model_config=cfg, num_codebooks=4,
                        device=dev, state_dict=codec.state_dict())
        if sharded:
            model = shard_codec_params(model, mesh)
        opt = torch.optim.Adam(model.parameters(), 1e-4)
        state = init_codec_opt_state(opt, model, 4)
        step = make_codec_train_step(model, 4)
        losses.append(float(step(state, batch)["loss"]))
    want, codec_loss = losses
    _close(codec_loss, want, "codec dp*tp step")

    # ---- step 2: SLM dp × tp (Megatron) ---- #
    lcfg = LlamaConfig(vocab_size=32, num_codebooks=2, hidden_size=64,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       intermediate_size=128)
    rng = np.random.default_rng(1)
    flat = rng.integers(0, lcfg.vocab_size, (n * 2, 24)).astype(np.int64)
    mask = np.ones((n * 2, 24), np.float32)
    slm_loss, want = _slm_pair(lcfg, 1, dev,
                               lambda m: shard_llama_params(m, mesh), 1e-4,
                               flat, mask)
    _close(slm_loss, want, "slm dp*tp step")

    # ---- step 3: dp × sp × tp ---- #
    sp_loss = float("nan")
    if n % 8 == 0:
        mesh3 = make_mesh(n, model_parallel=2, seq_parallel=2,
                          axis_names=("data", SEQ_AXIS, "model"),
                          device=device_type)
        rng = np.random.default_rng(2)
        flat3 = rng.integers(0, lcfg.vocab_size, (n, 24)).astype(np.int64)
        sp_loss, want = _slm_pair(
            lcfg, 2, dev, lambda m: shard_llama_params(m, mesh3), 1e-4,
            flat3, np.ones((n, 24), np.float32), sequence_axis=SEQ_AXIS)
        _close(sp_loss, want, "slm dp*sp*tp step")

    # ---- step 4: dp × pp (GPipe over the model axis) ---- #
    pp_loss = float("nan")
    if mp > 1:
        from audiocodecs_tpu_torch.parallel.train import make_slm_train_step

        data = n // mp
        rng = np.random.default_rng(3)
        flat4 = torch.as_tensor(rng.integers(
            0, lcfg.vocab_size, (2 * data, 24)), device=dev)
        mask4 = torch.ones((2 * data, 24), device=dev)
        ref = _llama(lcfg, 3, dev)
        stage = shard_pp_llama_params(stack_pipeline_stages(
            to_jax_params(ref.state_dict(), ref), mp), mesh, lcfg,
            device=dev)
        want = float(make_slm_train_step(ref, torch.optim.Adam(
            ref.parameters(), 1e-4))(flat4, mask4))
        pp_step, _ = make_pp_slm_train_step(
            lcfg, torch.optim.Adam(stage.parameters(), 1e-4), mesh, 2)
        pp_loss = float(pp_step(stage, flat4, mask4))
        _close(pp_loss, want, "slm dp*pp step")

    # ---- step 5: dp × ep (switch-MoE decoder) ---- #
    ep_loss = float("nan")
    if mp > 1:
        lcfg_moe = LlamaConfig(
            vocab_size=32, num_codebooks=2, hidden_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, intermediate_size=128,
            moe_experts=2 * mp, moe_capacity_factor=4.0)
        rng = np.random.default_rng(4)
        flat5 = rng.integers(0, lcfg.vocab_size, (n * 2, 24)).astype(
            np.int64)
        ep_loss, want = _slm_pair(
            lcfg_moe, 4, dev, lambda m: shard_moe_llama_params(m, mesh),
            1e-3, flat5, np.ones((n * 2, 24), np.float32))
        _close(ep_loss, want, "moe dp*ep step")

    # ---- step 6: data-parallel serving ---- #
    serve = (np.random.default_rng(5).standard_normal((n * 2, 400))
             .astype(np.float32) * 0.1)
    with torch.no_grad():
        toks_ref = codec.sig_to_toks(serve)
        rec_ref = codec.toks_to_sig(toks_ref)
        toks_dp = data_parallel(codec.sig_to_toks, mesh, serve)
        rec_dp = data_parallel(codec.toks_to_sig, mesh, toks_dp)
    if not torch.equal(toks_dp, toks_ref):
        raise AssertionError(
            "dp serving: batch-sharded tokens differ from single-device "
            f"({float((toks_dp != toks_ref).float().mean()):.4f} mismatch "
            "rate)")
    scale = max(float(rec_ref.abs().max()), 1.0)
    gap = float((rec_dp - rec_ref).abs().max())
    if not gap <= 1e-5 * scale:
        raise AssertionError(f"dp serving: waveform mismatch max={gap:.3e}")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return (f"dryrun_multichip({n}) ok: codec_loss={codec_loss:.4f} "
            f"slm_loss={slm_loss:.4f} slm_sp_loss={sp_loss:.4f} "
            f"slm_pp_loss={pp_loss:.4f} moe_ep_loss={ep_loss:.4f} "
            f"dp_serving=token-exact(B={serve.shape[0]}) "
            f"tp/dp_loss_match=f32 mesh={shape}")


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run the six sharded steps on ``n_devices`` ranks, one process each,
    on ``device`` (``"cuda"``: rank r on card r, which must exist;
    ``"cpu"``: gloo). Raises on any mismatch; prints and returns the
    reference's summary line."""
    from audiocodecs_tpu_torch.parallel.mesh import spawn_ranks

    line = spawn_ranks(_rank, int(n_devices), int(n_devices),
                       torch.device(device).type, device=device)[0]
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    dryrun_multichip(int(argv[0]) if argv else 8, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
