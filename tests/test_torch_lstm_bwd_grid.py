"""The launch rule of K3's backward recurrence on the co-resident grid
(``ops/lstm_cuda.py::backward_grid``, ``backward_route``): pure Python, no
device."""

from __future__ import annotations

import pytest

from pytorch_asr_tpu_torch.ops import lstm_cuda

SMEM = 232448


def _need(H: int, B: int, units: int, rows: int) -> int:
    """csrc/lstm_seq.cu::bwd_grid_smem_bytes: whh's rows of the CTA's units
    and the staged dgates rows (4H floats each), dh, dc and 7 cell inputs a
    (utterance, unit), then B lengths."""
    return 4 * ((units + rows) * 4 * H + 9 * B * units) + 4 * B


@pytest.mark.parametrize("B", [1, 5, 8, 16, 32])
@pytest.mark.parametrize("H", [48, 384, 512, 640])
def test_backward_grid_owns_every_unit_once_and_fits_the_card(H, B):
    grid = lstm_cuda.backward_grid(H, B)
    # CTA j owns [j units, min((j + 1) units, H)), as the kernel's k0 and nu.
    owned = [range(j * grid.units, min((j + 1) * grid.units, H)) for j in range(grid.ctas)]
    assert sorted(k for units in owned for k in units) == list(range(H))
    assert all(len(units) > 0 for units in owned)
    assert grid.ctas <= 132 and grid.directions == 1
    assert grid.units == -(-H // 132)
    assert grid.smem == _need(H, B, grid.units, grid.rows) <= SMEM
    # As many staged rows as fit, B where B fits.
    assert 1 <= grid.rows <= B
    assert grid.rows == B or _need(H, B, grid.units, grid.rows + 1) > SMEM


@pytest.mark.parametrize("H,B,rows", [(384, 8, 8), (512, 16, 16), (640, 32, 17)])
def test_backward_route_takes_the_grid_at_the_configs(H, B, rows):
    """Config 1 (H 384, B 8) and config 2 (H 512, B 16) stage every
    utterance at once; config 5 (H 640, B 32) stages them in groups."""
    grid = lstm_cuda.backward_route(H, B)
    assert grid == lstm_cuda.backward_grid(H, B)
    assert (grid.ctas, grid.rows) == (128, rows)


def test_backward_route_takes_the_per_utterance_kernel_at_h1536():
    with pytest.raises(ValueError, match="H 1536"):
        lstm_cuda.backward_grid(1536, 8)
    assert lstm_cuda.backward_route(1536, 8) is None


def test_backward_grid_stops_where_the_forward_grid_does():
    """Both grids end near H 1300 at B 8: the backward at H 1305, where 10
    units' rows of whh and one staged row pass a block."""
    assert lstm_cuda.backward_route(1304, 8) is not None
    assert lstm_cuda.backward_route(1305, 8) is None
    assert lstm_cuda.forward_route(1304, 8) is not None


def test_backward_route_raises_past_the_per_utterance_kernel():
    # 6 H floats a block: 232,440 bytes at H 9,685 fit, 232,464 at 9,686 do not.
    assert lstm_cuda.backward_route(9685, 8) is None
    with pytest.raises(ValueError, match="H 9686"):
        lstm_cuda.backward_route(9686, 8)


@pytest.mark.parametrize("B", [1, 8, 16, 256])
def test_backward_route_is_the_grid_exactly_where_the_grid_fits(B):
    """Across widths, the per-utterance route is taken where, and only where,
    ``backward_grid`` refuses: the route is read off the same rule."""
    for H in range(32, 2049, 37):
        try:
            want = lstm_cuda.backward_grid(H, B)
        except ValueError:
            want = None
        assert lstm_cuda.backward_route(H, B) == want, H


@pytest.mark.parametrize("units", [3, 4, 8])
def test_backward_grid_takes_other_units(units):
    """On a card of fewer SMs the rule gives fewer, wider CTAs: every unit
    still owned once, the bytes still counted."""
    grid = lstm_cuda.backward_grid(384, 8, sms=384 // units)
    assert grid.units == units and grid.ctas == -(-384 // units)
    assert grid.smem == _need(384, 8, units, 8)
