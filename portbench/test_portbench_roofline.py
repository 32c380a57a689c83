"""The bytes of ``wave_roofline_share``, counted by hand."""
import pytest

from portbench import peaks


def test_wave_bytes_by_hand_at_a_tiny_graph():
    # V 10, E 25, 2 dangling, kappa 4, 3 iterations, k 2, 4-byte words:
    # an iteration reads 25 edges x (index + value) = 200, 11 row offsets
    # = 44, 2 dangling ids = 8, 4 personalization ids = 16, P_t 10 x 4 x 4
    # = 160 and writes P_t+1 = 160: 588; top-K reads 160 and writes 4 x 2
    # x (id + score) = 64.
    assert peaks.wave_bytes(10, 25, 2, 4, 3, 2) == 3 * 588 + 224


def test_wave_bytes_of_gnp_2e5():
    per_iter = 2_000_000 * 8 + 200_001 * 4 + 9_517 * 4 + 16 * 4 + 2 * 200_000 * 16 * 4
    topk = 200_000 * 16 * 4 + 16 * 10 * 8
    assert peaks.wave_bytes(200_000, 2_000_000, 9_517, 16, 10, 10) == 10 * per_iter + topk
    assert peaks.wave_bytes(200_000, 2_000_000, 9_517, 16, 10, 10) == 437_182_640


def test_roofline_share_is_least_time_over_device_time():
    assert peaks.roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert peaks.roofline_pct(437_182_640, 1.3e-3) == pytest.approx(10.0387, rel=1e-4)
