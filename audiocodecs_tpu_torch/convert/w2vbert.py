"""HF ``Wav2Vec2BertModel`` checkpoint → the port's :class:`..nn.w2vbert.
W2VBert`.

Counterpart of ``audiocodecs_tpu/convert/w2vbert.py``. X-Codec 2.0's
semantic branch is ``facebook/w2v-bert-2.0``; inside X-Codec 2.0's fused
checkpoint its keys carry a ``semantic_model.`` prefix, from a standalone
HF model none: ``prefix`` takes either. The conformer's pointwise convs
(1×1, ``[Cout, Cin, 1]``) become ``[Cin, Cout]`` matrices; its depthwise
conv keeps its ``[C, 1, K]`` layout.
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    put_linear,
    put_norm,
    to_np,
)

__all__ = ["convert_w2vbert_state_dict"]


def _pointwise(sd, key) -> np.ndarray:
    return np.ascontiguousarray(to_np(sd[key])[:, :, 0].astype(np.float32).T)


def convert_w2vbert_state_dict(sd, num_layers: int = 24, prefix: str = ""):
    """A state dict → :class:`W2VBert`'s (``proj_ln``, ``proj``,
    ``layers.<i>``) for its first ``num_layers`` layers. Keys it does not
    read are ignored, as the reference ignores them."""
    p = prefix
    out = {}
    put_norm(out, "proj_ln", sd, f"{p}feature_projection.layer_norm")
    put_linear(out, "proj", sd, f"{p}feature_projection.projection")
    for i in range(num_layers):
        src, dst = f"{p}encoder.layers.{i}", f"layers.{i}"
        put_norm(out, f"{dst}.ffn1_ln", sd, f"{src}.ffn1_layer_norm")
        put_linear(out, f"{dst}.ffn1.in", sd,
                   f"{src}.ffn1.intermediate_dense")
        put_linear(out, f"{dst}.ffn1.out", sd, f"{src}.ffn1.output_dense")
        put_norm(out, f"{dst}.attn_ln", sd, f"{src}.self_attn_layer_norm")
        for name, proj in (("q", "linear_q"), ("k", "linear_k"),
                           ("v", "linear_v"), ("o", "linear_out")):
            put_linear(out, f"{dst}.attn.{name}", sd,
                       f"{src}.self_attn.{proj}")
        out[f"{dst}.attn.dist_emb"] = to_np(
            sd[f"{src}.self_attn.distance_embedding.weight"]).astype(
                np.float32)
        cm = f"{src}.conv_module"
        put_norm(out, f"{dst}.conv.ln", sd, f"{cm}.layer_norm")
        out[f"{dst}.conv.pw1"] = _pointwise(sd, f"{cm}.pointwise_conv1.weight")
        out[f"{dst}.conv.dw"] = to_np(
            sd[f"{cm}.depthwise_conv.weight"]).astype(np.float32)
        put_norm(out, f"{dst}.conv.dw_ln", sd, f"{cm}.depthwise_layer_norm")
        out[f"{dst}.conv.pw2"] = _pointwise(sd, f"{cm}.pointwise_conv2.weight")
        put_norm(out, f"{dst}.ffn2_ln", sd, f"{src}.ffn2_layer_norm")
        put_linear(out, f"{dst}.ffn2.in", sd,
                   f"{src}.ffn2.intermediate_dense")
        put_linear(out, f"{dst}.ffn2.out", sd, f"{src}.ffn2.output_dense")
        put_norm(out, f"{dst}.final_ln", sd, f"{src}.final_layer_norm")
    return as_state_dict(out)
