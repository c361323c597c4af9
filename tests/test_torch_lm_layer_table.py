"""K9's LM arguments: the six tensors the C entry takes by a host array and
the device table of the layers' 3 nl pointers that ``RnnLm`` reads
(``ops/beam_cuda.py::_lm_tensors``, ``LAYER_KINDS``), for LMs of 1, 2, 9
and 12 layers, against the C source's ``rnn_lm`` and ``RnnLm::wx``, ``wh``
and ``b``.  Pure Python, no device: no layer count is refused."""

from __future__ import annotations

import re

import pytest
import torch

from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.ops import beam_cuda, build

V = 31


def _c_source() -> str:
    return (build.CSRC / "prefix_beam.cu").read_text()


def _c_slots() -> dict:
    """RnnLm's accessors as Python: kind -> slot(l, nl)."""
    out = {}
    for kind in beam_cuda.LAYER_KINDS:
        m = re.search(r"const float\* " + kind + r"\(int l\) const \{ return layer\[([^\]]*)\]; \}",
                      _c_source())
        out[kind] = eval(f"lambda l, nl: {m.group(1)}")  # noqa: S307 - the repo's own source
    return out


def test_head_is_the_order_rnn_lm_reads():
    """``rnn_lm`` takes embed, w_out, b_out, h0, c0, lmp0 from weights[0..5]."""
    reads = dict(re.findall(r"lm\.(\w+) = weights\[(\d)\];", _c_source()))
    lm = CharRNNLM(RNNLMConfig(embed_dim=4, hidden_dim=6, num_layers=1), V)
    head, _ = beam_cuda._lm_tensors(lm, torch.zeros(1, 6), torch.zeros(1, 6), torch.zeros(V), V)
    assert [int(reads[name]) for name in head] == list(range(6))


@pytest.mark.parametrize("nl", [1, 2, 9, 12])
def test_layer_table_is_the_order_the_kernel_reads(nl):
    E, H = 4, 6
    lm = CharRNNLM(RNNLMConfig(embed_dim=E, hidden_dim=H, num_layers=nl), V)
    head, layers = beam_cuda._lm_tensors(lm, torch.zeros(nl, H), torch.zeros(nl, H),
                                         torch.zeros(V), V)
    assert len(head) == 6 and len(layers) == 3 * nl
    slots = _c_slots()
    names = list(layers)
    for kind in beam_cuda.LAYER_KINDS:
        for l in range(nl):
            slot = slots[kind](l, nl)
            tensor, shape = layers[names[slot]]
            assert names[slot] == f"lstm{l}_{kind}"
            assert tensor is getattr(lm, f"lstm{l}_{kind}") and tuple(tensor.shape) == shape
    assert sorted(slots[k](l, nl) for k in beam_cuda.LAYER_KINDS
                  for l in range(nl)) == list(range(3 * nl))


@pytest.mark.parametrize("nl", [1, 2, 9, 12])
def test_no_layer_count_is_refused(nl):
    """The route and the block rule take any layer count by their bytes."""
    assert beam_cuda.fits(16, V, V, (nl, 32, 64))
    assert beam_cuda.rnn_grid_route(16, 16, V, V, nl, 32, 64) is not None
