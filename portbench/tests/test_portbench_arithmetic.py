"""Percentiles, spreads, rates and model operations on hand-made
stamps, and the frozen bounds against the numbers PERF.md's kernel table
lists for K1-K5."""

import types

import pytest

from portbench import readers, spec, stats
from portbench.frozen import bounds, flops
from portbench.tests.conftest import DATA


def test_percentile_nearest_rank():
    values = list(range(1, 11))
    assert stats.percentile(values, 90) == 9
    assert stats.percentile(values, 100) == 10
    assert stats.percentile([5.0], 90) == 5.0


def test_spread_matches_statistics_quartiles():
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)


def _served(due, times, max_new=None, admitted=None):
    req = types.SimpleNamespace(admitted_at=admitted, submitted_at=due)
    n = len(times) if max_new is None else max_new
    return types.SimpleNamespace(due=due, times=times, max_new=n,
                                 request=req, prompt=[0] * 4,
                                 finished=len(times) == n)


def test_latency_readers_on_hand_made_stamps():
    served = [_served(10.0 + i, [10.0 + i + 0.1 * (i + 1),
                                 10.0 + i + 0.1 * (i + 1) + 0.5],
                      admitted=10.0 + i + 0.05 * i) for i in range(10)]
    run = types.SimpleNamespace(window=(9.0, 30.0), end=40.0, served=served)
    run.in_window = lambda: [s for s in served if 9.0 <= s.due <= 30.0]
    assert readers.ttft_ms(run, 90) == pytest.approx(900.0)
    assert readers.ttft_ms(run, 50) == pytest.approx(500.0)
    assert readers.tpot_ms(run, 50) == pytest.approx(500.0)
    assert readers.queue_wait_p90_ms(run) == pytest.approx(400.0)
    # a request that never got its first token waited until the run ended
    served.append(_served(29.0, [], max_new=3))
    assert readers.ttft_ms(run, 90) == pytest.approx(1000.0)
    served += [_served(29.0, [], max_new=3) for _ in range(2)]
    assert readers.ttft_ms(run, 90) == pytest.approx(11000.0)
    assert readers.ttft_ms(run, 50) == pytest.approx(700.0)


def test_model_operations():
    cfg = types.SimpleNamespace(hidden_size=8, q_dim=8, kv_dim=4,
                                intermediate_size=16, num_layers=2,
                                vocab_size=10, num_heads=2, head_dim=4)
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    n = 2 * per_layer + 8 * 10
    assert flops.matmul_params(cfg) == n
    assert flops.train_step_flops(cfg, 2, 4) == (
        6 * n * 8 + 14 * 4 * (2 * 4 * 5 // 2) * 2 * 2)
    moe = types.SimpleNamespace(**vars(cfg), num_experts=8,
                                experts_per_token=2)
    assert flops.matmul_params(moe) == n + 2 * (3 * 8 * 16 + 8 * 8)


def test_train_rate_and_mfu():
    cfg = types.SimpleNamespace(hidden_size=8, q_dim=8, kv_dim=4,
                                intermediate_size=16, num_layers=2,
                                vocab_size=10, num_heads=2, head_dim=4)
    run = types.SimpleNamespace(steps=10, batch=2, seq=4, seconds=2.0,
                                cfg=cfg, cell=spec.find("tiny-dense-train",
                                                        DATA))
    assert readers.train_tokens_per_s(run) == 40.0
    assert readers.train_mfu(run) == pytest.approx(
        100 * 10 * flops.train_step_flops(cfg, 2, 4)
        / (2.0 * bounds.PEAK_BF16_FLOPS))


def test_frozen_bounds_against_the_kernel_table():
    k12 = bounds.flash_bounds((4, 2048, 32, 8, 128))
    k34 = bounds.flash_bounds((8, 1024, 32, 8, 64))
    assert round(k12["fwd"][0] * 1e3, 1) == 139.0
    assert round(k12["bwd"][0] * 1e3, 1) == 347.6
    assert round(k34["fwd"][0] * 1e3, 1) == 34.8
    assert round(k34["bwd"][0] * 1e3, 1) == 86.9
    k5 = bounds.paged_decode_bound([0, 1, 31, 32, 33, 500, 1000, 1024], 128,
                                   False, 8, 4, 32)
    assert round(k5[0] * 1e3, 2) == 3.26 and k5[1] == "bytes"
