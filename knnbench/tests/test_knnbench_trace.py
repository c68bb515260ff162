"""The trace's reduction: busy time, idle stretches and what the host was
doing in them, on made-up events."""

from knnbench.trace import Trace


def test_busy_idle_and_breakdown():
    t = Trace(window_s=10.0,
              device=[("k1", 1.0, 3.0), ("Memcpy HtoD", 2.0, 4.0), ("k2", 6.0, 7.0), ("k1", 9.5, 11.0)],
              host=[("aten::sort", 4.0, 6.0), ("cudaLaunchKernel", 4.5, 4.6), ("aten::mm", 7.0, 9.0)])
    assert abs(t.busy() - 4.5) < 1e-12  # [1, 4], [6, 7] and [9.5, 10], clipped to the window
    assert t.idle_gaps() == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.5)]
    assert [k[0] for k in t.kernels()] == ["k1", "k2", "k1"]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", 3.5]
    assert dict(b["idle_gaps"]) == {"python": 1.0, "aten::sort": 2.0, "aten::mm": 2.5}
