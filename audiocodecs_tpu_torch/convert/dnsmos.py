"""DNSMOS P.808 ``model_v8.onnx`` → parameters.

Counterpart of ``audiocodecs_tpu/convert/dnsmos.py``. The reference runs
this small Keras-exported CNN through onnxruntime (reference
``metrics/dnsmos.py:45-152``); here the weights are read out of the ONNX
file once (:mod:`.onnx_lite`, numpy only) and run by the port's
:class:`..downstream.metrics.dnsmos.DNSMOS`.

Graph: mel [B, T, 120] → NCHW → Conv3x3(1→32) ReLU MaxPool2 →
Conv3x3(32→32) ReLU MaxPool2 → Conv3x3(32→32) ReLU → Conv3x3(32→32) ReLU
MaxPool2 → Conv3x3(32→64) ReLU → global max pool → Dense(64) ReLU →
Dense(64) ReLU → Dense(1).
"""

from __future__ import annotations

import numpy as np

__all__ = ["convert_dnsmos_onnx", "DNSMOS_CONV_LAYERS", "DNSMOS_DENSE_LAYERS"]

# (onnx initializer prefix, has_pool_after)
DNSMOS_CONV_LAYERS = [
    ("conv2d_5", True),
    ("conv2d_6", True),
    ("conv2d_7", False),
    ("conv2d_8", True),
    ("conv2d_9", False),
]
DNSMOS_DENSE_LAYERS = ["dense_3", "dense_4", "dense_5"]


def convert_dnsmos_onnx(path: str) -> dict:
    """Parse ``model_v8.onnx`` into ``{"conv": [...], "dense": [...]}``
    (conv kernels kept OIHW; dense kept ``[in, out]``)."""
    from audiocodecs_tpu_torch.convert.onnx_lite import read_onnx

    g = read_onnx(path)
    init = g.initializers
    params = {"conv": [], "dense": []}
    for name, _ in DNSMOS_CONV_LAYERS:
        w = np.asarray(init[f"{name}/kernel:0"], dtype=np.float32)
        b = np.asarray(init[f"{name}/bias:0"], dtype=np.float32)
        if w.ndim != 4 or w.shape[0] != b.shape[0]:
            raise ValueError(f"{name}: unexpected shapes {w.shape} {b.shape}")
        params["conv"].append({"w": w, "b": b})
    for name in DNSMOS_DENSE_LAYERS:
        prefix = f"mos_estimator_small_1/{name}"
        w = np.asarray(init[f"{prefix}/MatMul/ReadVariableOp/resource:0"],
                       dtype=np.float32)
        b = np.asarray(init[f"{prefix}/BiasAdd/ReadVariableOp/resource:0"],
                       dtype=np.float32)
        params["dense"].append({"w": w, "b": b})
    return params
