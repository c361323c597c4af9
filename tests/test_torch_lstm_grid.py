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
