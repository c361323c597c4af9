"""The launch rule of K2's and K3's forward recurrence on the co-resident grid
(``ops/lstm_cuda.py::recurrence_grid``): pure Python, no device."""

from __future__ import annotations

import pytest

from pytorch_asr_tpu_torch.ops import lstm_cuda

# chip_smoke.py's sweep chose the most CTAs, ceil(H / 132) units each, at
# config 1 (H 384, B 8) and config 2 (H 512, B 16); the rule gives config
# 5's H 640 the same 128.
SWEPT_CTAS = {384: 128, 512: 128, 640: 128}


@pytest.mark.parametrize("B", [1, 5, 8, 16, 32])
@pytest.mark.parametrize("H", [48, 384, 512, 640])
def test_grid_owns_every_unit_once_and_fits_the_card(H, B):
    grid = lstm_cuda.recurrence_grid(H, B)
    # CTA j owns [j units, min((j + 1) units, H)), as the kernel's k0 and nu.
    owned = [range(j * grid.units, min((j + 1) * grid.units, H)) for j in range(grid.ctas)]
    assert sorted(k for units in owned for k in units) == list(range(H))
    assert all(len(units) > 0 for units in owned)
    assert grid.ctas <= 132
    hp = lstm_cuda._padded_row(H)
    assert hp % 32 == 4 and hp >= H
    # whh columns, the staged h rows, gates, cell carry, two steps' xproj,
    # the tail the last row's loads may reach, lengths.
    need = 4 * (4 * grid.units * hp + grid.rows * hp + 13 * B * grid.units + 16) + 4 * B
    assert grid.smem == need <= 232448
    assert grid.rows == B
    if H in SWEPT_CTAS:
        assert grid.ctas == SWEPT_CTAS[H]


def test_a_width_past_the_card_raises():
    with pytest.raises(ValueError, match="H 1536"):
        lstm_cuda.recurrence_grid(1536, 8)


# K11's grid: each direction on half the SMs, 64 CTAs at configs 1, 2 and 5.
DUAL_CTAS = {384: 64, 512: 64, 640: 64}


@pytest.mark.parametrize("B", [1, 5, 8, 16, 32])
@pytest.mark.parametrize("H", [48, 384, 512, 640])
def test_dual_grid_owns_every_unit_once_a_direction_and_fits_the_card(H, B):
    grid = lstm_cuda.recurrence_grid(H, B, directions=2)
    assert grid.directions == 2
    # Each direction's CTAs own [j units, min((j + 1) units, H)): every unit once.
    for _ in range(grid.directions):
        owned = [range(j * grid.units, min((j + 1) * grid.units, H)) for j in range(grid.ctas)]
        assert sorted(k for units in owned for k in units) == list(range(H))
        assert all(len(units) > 0 for units in owned)
    assert grid.ctas * grid.directions <= 132
    hp = lstm_cuda._padded_row(H)
    need = 4 * (4 * grid.units * hp + grid.rows * hp + 13 * B * grid.units + 16) + 4 * B
    assert grid.smem == need <= 232448
    assert grid.rows == B
    # The one-direction rule on half the SMs.
    assert grid._replace(directions=1) == lstm_cuda.recurrence_grid(H, B, sms=66)
    if H in DUAL_CTAS:
        assert grid.ctas == DUAL_CTAS[H]
    if (H, B) == (640, 16):
        assert grid.smem == 152704


def test_a_width_past_the_card_raises_for_the_dual_grid():
    # H 1024 fits one direction's grid on 132 SMs, not a direction on 66.
    assert lstm_cuda.recurrence_grid(1024, 8).ctas == 128
    with pytest.raises(ValueError, match="H 1024"):
        lstm_cuda.recurrence_grid(1024, 8, directions=2)
    with pytest.raises(ValueError, match="directions"):
        lstm_cuda.recurrence_grid(384, 8, directions=3)


# ---------------------------------------------------------------- the route of the ops' forward


@pytest.mark.parametrize("directions", [1, 2])
@pytest.mark.parametrize("B", [1, 5, 8, 16, 32])
@pytest.mark.parametrize("H", [384, 512, 640])
def test_route_takes_the_grid_at_the_configs_widths(H, B, directions):
    assert lstm_cuda.forward_route(H, B, directions=directions) == lstm_cuda.recurrence_grid(
        H, B, directions=directions)


# One direction past the grid at H 1536 and at B 931 (H 512); K11's dual
# grid past it at H 1024.
@pytest.mark.parametrize("H,B,directions", [(1536, 8, 1), (1024, 8, 2), (512, 931, 1),
                                            (9685, 8, 1), (9685, 1, 2)])
def test_route_takes_the_per_utterance_kernel_past_the_grid(H, B, directions):
    with pytest.raises(ValueError):
        lstm_cuda.recurrence_grid(H, B, directions=directions)
    assert lstm_cuda.forward_route(H, B, directions=directions) is None


@pytest.mark.parametrize("directions", [1, 2])
def test_route_raises_past_the_per_utterance_kernel(directions):
    # 6 H floats a block: 232,440 bytes at H 9,685 fit, 232,464 at 9,686 do not.
    with pytest.raises(ValueError, match="H 9686"):
        lstm_cuda.forward_route(9686, 8, directions=directions)


@pytest.mark.parametrize("directions", [1, 2])
@pytest.mark.parametrize("B", [1, 8, 16, 256])
def test_route_is_the_grid_exactly_where_the_grid_fits(B, directions):
    """Across widths, the per-utterance route is taken where, and only where,
    ``recurrence_grid`` refuses: the route is read off the same rule."""
    for H in range(32, 2049, 37):
        try:
            want = lstm_cuda.recurrence_grid(H, B, directions=directions)
        except ValueError:
            want = None
        assert lstm_cuda.forward_route(H, B, directions=directions) == want, H
