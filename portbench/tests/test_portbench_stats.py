"""The end-to-end statistics and the trace's reductions."""

import types

from portbench import harness, tracing


def metric(name, **ctx):
    return harness.reader(name).read(types.SimpleNamespace(**ctx))


def test_rate_is_all_work_over_all_time():
    window = {"seconds": 2.0, "ok": [True, True, False], "work_per_request": 10,
              "latencies_s": [0.5, 0.5, 1.0], "steps_per_request": 1}
    # The failed request's work does not count; its time does.
    assert metric("rollout_particle_steps_per_s", window=window) == 10.0


def test_train_step_is_all_time_over_all_steps():
    window = {"seconds": 3.0, "ok": [True] * 5 + [False], "latencies_s": [0.1] * 6,
              "work_per_request": 1, "steps_per_request": 1}
    assert metric("train_step_ms", window=window) == 500.0


def test_busy_is_the_union_of_intervals():
    events = [("a", 0, 10), ("b", 5, 10), ("c", 20, 5)]
    assert tracing.merged(events) == [(0, 15), (20, 25)]
    assert tracing.busy_s(events) == 20e-9  # not the 25 ns their sum gives


def test_idle_share_uses_the_untraced_step():
    trace = tracing.Trace([("k", 0, 3_000_000), ("k", 2_000_000, 2_000_000)], [], 1.0, 2)
    window = {"seconds": 0.02, "ok": [True], "steps_per_request": 2, "latencies_s": [0.02],
              "work_per_request": 1}
    # Busy 4 ms over 2 steps against 10 ms a step: 80 % idle.
    for suffix in ("rollout", "train"):
        value = metric(f"device_idle_pct.{suffix}", trace=trace, window=window)
        assert abs(value - 80.0) < 1e-9
        assert metric(f"device_ops_per_step.{suffix}", trace=trace) == 1.0


def test_roofline_share():
    # 3.35e9 bytes take 1 ms; two calls of 2 ms each: 50 %.
    trace = tracing.Trace([("void persistent::kernel<false, 128>(x)", 0, 2_000_000),
                           ("void persistent::kernel<false, 128>(x)", 5_000_000, 2_000_000),
                           ("void persistent::kernel<true, 128>(x)", 9_000_000, 1_000_000)],
                          [], 1.0, 1)
    count = {"bytes": 3.35e9, "ops": 0, "op_rate": "bf16_tensor"}
    assert tracing.roofline_pct(trace, r"kernel<false", count) == 50.0
    assert tracing.roofline_pct(trace, r"nothing", count) is None


def test_breakdown():
    device = [("k1", 0, 10), ("k2", 30, 10), ("k1", 100, 10)]
    host = [("outer", 0, 200), ("aten::mm", 50, 40)]
    trace = tracing.Trace(device, host, 1.0, 1)
    assert tracing.top_ops(device) == [["k1", 20e-9], ["k2", 10e-9]]
    # Gaps 10-30 (only "outer" runs at 20) and 40-100 ("aten::mm" at 70).
    assert tracing.idle_gaps(trace) == [["aten::mm", 60e-9], ["outer", 20e-9]]
