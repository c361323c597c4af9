"""Load the JAX package's ASRModel parameters into the port's ``state_dict``.

The JAX tree (flax ``params``, as nested dicts of arrays) has, for the
BiLSTM model, the keys ``encoder/ConvSubsampler_0/Conv_{i}/{kernel,bias}``
and ``encoder/lstm{k}_{fwd,bwd}/{wih,whh,bias}``; for the TCN,
``encoder/Conv_0/{kernel,bias}`` (the stem),
``encoder/block{i}/{ln_scale,ln_bias,w_conv,b_conv,w_point,b_point}`` and
``encoder/LayerNorm_0/{scale,bias}``; ``ctc_head/{kernel,bias}``; and, with
the LAS decoder, ``las/{embed,lstm{l}_wx,lstm{l}_wh,lstm{l}_b,w_e,w_s,b_att,
w_f,loc_filter,v_att,w_out,b_out}``, which keep their names and layouts.
Conversions: flax HWIO conv kernels -> OIHW, the stem's WIO -> OIW, the
Dense kernel ``(in, out)`` -> the Linear weight ``(out, in)``; the LSTM and
TCN block tensors keep the JAX layout, which the port's kernels take.  An
``.npz`` holding the same tree under ``/``-joined keys loads through
``load_npz``.  The char RNN LM's tree (``embed``, ``lstm{l}_{wx,wh,b}``,
``w_out``, ``b_out``) keeps its names and layout (``load_jax_rnn_lm``).
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
_LAS = re.compile(r"las/(embed|w_[esf]|b_att|loc_filter|v_att|w_out|b_out|lstm\d+_(?:wx|wh|b))")


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
        elif m := _LAS.fullmatch(path):
            state[f"las.{m.group(1)}"] = arr
        elif m := _HEAD.fullmatch(path):
            what = m.group(1)
            state[f"ctc_head.{'weight' if what == 'kernel' else 'bias'}"] = (
                arr.T if what == "kernel" else arr)
        else:
            raise KeyError(f"unexpected parameter {path!r} for the BiLSTM or TCN model")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in state.items()}


_PORT_NAMES = (
    (re.compile(r"encoder\.conv\.convs\.(\d+)\.(weight|bias)"),
     lambda i, w: f"encoder/ConvSubsampler_0/Conv_{i}/{'kernel' if w == 'weight' else 'bias'}"),
    (re.compile(r"encoder\.layers\.(\d+)\.(fwd|bwd)\.(wih|whh|bias)"),
     lambda k, d, w: f"encoder/lstm{k}_{d}/{w}"),
    (re.compile(r"encoder\.stem\.(weight|bias)"),
     lambda w: f"encoder/Conv_0/{'kernel' if w == 'weight' else 'bias'}"),
    (re.compile(r"encoder\.blocks\.(\d+)\.(\w+)"), lambda i, w: f"encoder/block{i}/{w}"),
    (re.compile(r"encoder\.final_ln\.(weight|bias)"),
     lambda w: f"encoder/LayerNorm_0/{'scale' if w == 'weight' else 'bias'}"),
    (re.compile(r"las\.(\w+)"), lambda w: f"las/{w}"),
    (re.compile(r"ctc_head\.(weight|bias)"),
     lambda w: f"ctc_head/{'kernel' if w == 'weight' else 'bias'}"))


def jax_path(name: str) -> str:
    """The JAX tree path of the port parameter ``name``: the inverse of
    ``load_jax_params``'s naming."""
    for rx, path in _PORT_NAMES:
        if m := rx.fullmatch(name):
            return path(*m.groups())
    raise KeyError(f"no JAX path for the parameter {name!r}")


_RNN_LM = re.compile(r"embed|w_out|b_out|lstm\d+_(wx|wh|b)")


def load_jax_rnn_lm(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``CharRNNLM`` params tree -> the ``state_dict`` of
    ``models.lm_rnn.CharRNNLM``: the same names and layouts, as float32.
    Raises on a key it does not know."""
    state = {}
    for path, arr in flatten(params).items():
        if not _RNN_LM.fullmatch(path):
            raise KeyError(f"unexpected parameter {path!r} for the char RNN LM")
        state[path] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return state


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """``load_jax_params`` of an ``.npz`` whose keys are ``/``-joined paths."""
    with np.load(path) as data:
        return load_jax_params({k: data[k] for k in data.files})
