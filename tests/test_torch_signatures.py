"""Each ctypes signature the ops modules give ``build.load`` matches the C
entry point of the same name in ``csrc/``, argument for argument: a pointer
where the source takes a pointer, an int where it takes an int, a float
where it takes a float.  No compiler and no device: the sources are read as
text, so a mismatch shows here and not first as a refused call on the card."""

from __future__ import annotations

import ctypes
import re

import pytest

from pytorch_asr_tpu_torch.ops import beam_cuda, build, ctc_cuda, lstm_cuda, stft_cuda, tcn_cuda

TABLES = {"lstm_seq": lstm_cuda._SIGNATURES, "stft_log_mel": stft_cuda._SIGNATURES,
          "ctc_alpha_beta": ctc_cuda._SIGNATURES, "prefix_beam": beam_cuda._SIGNATURES,
          "prefix_beam_study": beam_cuda._STUDY_SIGNATURES, "tcn_block": tcn_cuda._SIGNATURES}
ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _kind(param: str):
    """The ctypes type a C parameter declaration passes as."""
    if "*" in param:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[param.split()[-2]]


def _entries(source: str) -> dict[str, list]:
    text = (build.CSRC / f"{source}.cu").read_text()
    return {name: [_kind(p) for p in params.split(",")] for name, params in ENTRY.findall(text)}


@pytest.mark.parametrize("source", sorted(TABLES))
def test_signatures_match_the_c_entry_points(source):
    entries = _entries(source)
    for name, argtypes in TABLES[source].items():
        assert name in entries, f"{source}.cu has no entry point {name}"
        assert argtypes == entries[name], name
