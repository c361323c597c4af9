"""The launch rule of K11's backward recurrence on its dual grid
(``ops/lstm_cuda.py::backward_grid`` and ``backward_route`` with directions
2): each direction gets half the SMs and the one-direction rule on them.
Pure Python, no device; the byte count is read from the C source."""

from __future__ import annotations

import re

import pytest

from pytorch_asr_tpu_torch.ops import build, lstm_cuda

SMEM = 232448
SMS = 132


def _c_bwd_grid_bytes():
    """csrc/lstm_seq.cu::bwd_grid_smem_bytes as Python: its local constants
    then its return expression, the casts dropped and sizeof as 4."""
    text = (build.CSRC / "lstm_seq.cu").read_text()
    m = re.search(r"size_t bwd_grid_smem_bytes\(([^)]*)\) \{(.*?)\n\}", text, re.S)
    params = [p.split()[-1] for p in m.group(1).split(",")]
    body = re.sub(r"\(size_t\)", "", m.group(2))
    body = re.sub(r"sizeof\((float|int)\)", "4", body)
    lines = []
    for stmt in body.split(";"):
        stmt = " ".join(stmt.split())
        if stmt.startswith("const size_t "):
            lines += [f"    {a.strip()}" for a in stmt[len("const size_t "):].split(",")]
        elif stmt.startswith("return "):
            lines.append(f"    return {stmt[len('return '):]}")
    env = {}
    exec(f"def f({', '.join(params)}):\n" + "\n".join(lines) + "\n", env)
    return env["f"]


def test_byte_count_is_the_c_sources():
    c = _c_bwd_grid_bytes()
    for H in (48, 384, 512, 640, 924, 925, 1536):
        for B in (1, 5, 8, 16, 32):
            grid, _, _, _ = lstm_cuda._bwd_grid_shape(H, B, SMS, SMEM, 2)
            assert grid.smem == c(H, B, grid.units, grid.rows), (H, B)


@pytest.mark.parametrize("B", [1, 2, 5, 8, 16, 32])
@pytest.mark.parametrize("H", [48, 384, 512, 640])
def test_each_direction_owns_every_unit_once_and_fits_the_card(H, B):
    grid = lstm_cuda.backward_grid(H, B, directions=2)
    assert grid.directions == 2 and grid.ctas <= SMS // 2
    assert grid.units == -(-H // (SMS // 2))
    # CTA (j, d) owns [j units, min((j + 1) units, H)) of direction d.
    owned = [range(j * grid.units, min((j + 1) * grid.units, H)) for j in range(grid.ctas)]
    assert sorted(k for units in owned for k in units) == list(range(H))
    assert all(len(units) > 0 for units in owned)
    assert grid.smem == _c_bwd_grid_bytes()(H, B, grid.units, grid.rows) <= SMEM
    assert 1 <= grid.rows <= B
    assert grid.rows == B or _c_bwd_grid_bytes()(H, B, grid.units, grid.rows + 1) > SMEM
    # Each half is the one-direction rule on half the SMs.
    assert grid == lstm_cuda.backward_grid(H, B, sms=SMS // 2)._replace(directions=2)


@pytest.mark.parametrize("H,B,units,ctas,rows", [(384, 8, 6, 64, 8), (512, 16, 8, 64, 16),
                                                 (640, 32, 10, 64, 11)])
def test_dual_grid_at_the_configs(H, B, units, ctas, rows):
    """Config 1 (H 384, B 8): 64 CTAs of 6 units a direction; config 2 (H
    512, B 16): 64 of 8, ~201 KB a CTA; config 5 (H 640, B 32) stages its
    utterances in groups of 11."""
    grid = lstm_cuda.backward_route(H, B, directions=2)
    assert (grid.units, grid.ctas, grid.rows) == (units, ctas, rows)
    if (H, B) == (512, 16):
        assert grid.smem == 201280


def test_route_ends_near_h924_at_b8():
    """14 units' rows of whh and one staged row fit a block at H 924; at H
    925 a CTA takes 15 units and passes it: the per-utterance kernel runs."""
    assert lstm_cuda.backward_route(924, 8, directions=2).units == 14
    assert lstm_cuda.backward_route(925, 8, directions=2) is None
    with pytest.raises(ValueError, match="H 925"):
        lstm_cuda.backward_grid(925, 8, directions=2)
    assert lstm_cuda.backward_route(1536, 8, directions=2) is None
    # One direction keeps the whole card, so it runs further.
    assert lstm_cuda.backward_route(925, 8) is not None


@pytest.mark.parametrize("B", [1, 8, 16, 256])
def test_route_is_the_grid_exactly_where_the_grid_fits(B):
    for H in range(32, 2049, 37):
        try:
            want = lstm_cuda.backward_grid(H, B, directions=2)
        except ValueError:
            want = None
        assert lstm_cuda.backward_route(H, B, directions=2) == want, H


def test_directions_other_than_one_or_two_raise():
    with pytest.raises(ValueError, match="directions"):
        lstm_cuda.backward_route(384, 8, directions=3)
