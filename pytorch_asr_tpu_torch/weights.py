"""Load the JAX package's ASRModel parameters into the port's ``state_dict``.

The JAX tree (flax ``params``, as nested dicts of arrays) has, for the
BiLSTM model, the keys ``encoder/ConvSubsampler_0/Conv_{i}/{kernel,bias}``
and ``encoder/lstm{k}_{fwd,bwd}/{wih,whh,bias}``; for the TCN,
``encoder/Conv_0/{kernel,bias}`` (the stem),
``encoder/block{i}/{ln_scale,ln_bias,w_conv,b_conv,w_point,b_point}`` and
``encoder/LayerNorm_0/{scale,bias}``; and ``ctc_head/{kernel,bias}``.
Conversions: flax HWIO conv kernels -> OIHW, the stem's WIO -> OIW, the
Dense kernel ``(in, out)`` -> the Linear weight ``(out, in)``; the LSTM and
TCN block tensors keep the JAX layout, which the port's kernels take.  An
``.npz`` holding the same tree under ``/``-joined keys loads through
``load_npz``.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_CONV = re.compile(r"encoder/ConvSubsampler_0/Conv_(\d+)/(kernel|bias)")
_LSTM = re.compile(r"encoder/lstm(\d+)_(fwd|bwd)/(wih|whh|bias)")
_HEAD = re.compile(r"ctc_head/(kernel|bias)")
_STEM = re.compile(r"encoder/Conv_0/(kernel|bias)")
_BLOCK = re.compile(r"encoder/block(\d+)/(ln_scale|ln_bias|w_conv|b_conv|w_point|b_point)")
_FINAL_LN = re.compile(r"encoder/LayerNorm_0/(scale|bias)")


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts of arrays -> ``{"a/b/c": array}``."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def load_jax_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``params`` tree (nested or already ``/``-flattened) -> the port's
    ``state_dict`` for ``models.asr_model.ASRModel``.  Raises on a key it
    does not know, so a tree of another architecture is never half-loaded."""
    state = {}
    for path, arr in flatten(params).items():
        if m := _CONV.fullmatch(path):
            i, what = m.groups()
            value = arr.transpose(3, 2, 0, 1) if what == "kernel" else arr
            state[f"encoder.conv.convs.{i}.{'weight' if what == 'kernel' else 'bias'}"] = value
        elif m := _LSTM.fullmatch(path):
            k, direction, what = m.groups()
            state[f"encoder.layers.{k}.{direction}.{what}"] = arr
        elif m := _STEM.fullmatch(path):
            what = m.group(1)
            state[f"encoder.stem.{'weight' if what == 'kernel' else 'bias'}"] = (
                arr.transpose(2, 1, 0) if what == "kernel" else arr)
        elif m := _BLOCK.fullmatch(path):
            i, what = m.groups()
            state[f"encoder.blocks.{i}.{what}"] = arr
        elif m := _FINAL_LN.fullmatch(path):
            what = m.group(1)
            state[f"encoder.final_ln.{'weight' if what == 'scale' else 'bias'}"] = arr
        elif m := _HEAD.fullmatch(path):
            what = m.group(1)
            state[f"ctc_head.{'weight' if what == 'kernel' else 'bias'}"] = (
                arr.T if what == "kernel" else arr)
        else:
            raise KeyError(f"unexpected parameter {path!r} for the CTC BiLSTM or TCN model")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in state.items()}


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """``load_jax_params`` of an ``.npz`` whose keys are ``/``-joined paths."""
    with np.load(path) as data:
        return load_jax_params({k: data[k] for k in data.files})
