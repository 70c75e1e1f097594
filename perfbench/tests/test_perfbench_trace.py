"""The device trace's reduction and the per-layer readers, on synthetic
profiler events."""

import pytest

from perfbench.harness import spec, trace, yardstick


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("aten::zero_", "cpu_op", 0.0, 15.0),
    ev("void render_fwd_train_kernel<float, false>(float const*)", "kernel",
       20.0, 100.0),
    ev("optimize.backward", "cpu_op", 110.0, 60.0),
    ev("render_bwd_kernel", "kernel", 150.0, 200.0),
    ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 360.0, 10.0),
    ev("vectorized_elementwise_kernel", "kernel", 380.0, 20.0),
    ev("flow", "ac2g", 0.0, 1.0),
]


def test_ident_and_classes():
    assert trace.ident("void render_bwd_kernel<float, false>(x)") \
        == "render_bwd_kernel"
    assert trace.is_forward("render_fwd_tc_kernel(float const*)")
    assert trace.is_backward("void render_bwd_kernel<double>()")
    assert trace.is_port_kernel("march_tc_kernel(float const*)")
    assert not trace.is_port_kernel("void at::native::elementwise_kernel<>")


def test_reduce_events():
    c = trace.reduce_events(EVENTS)
    assert c.span_s == pytest.approx(400e-6)
    assert c.busy_s == pytest.approx(330e-6)
    gaps = {}
    for name, seconds in c.gaps:
        gaps[name] = gaps.get(name, 0.0) + seconds
    assert gaps["aten::zero_"] == pytest.approx(20e-6)
    assert gaps["host outside torch operations"] == pytest.approx(20e-6)
    assert gaps["optimize.backward"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(70e-6)


def test_clipped_cycle_holds_whole_frame_periods():
    """A pipelined loop's cycle, read between the starts of its first and
    last forward kernels: three periods of 100 µs, one a frame."""
    fwd = "render_fwd_tc_kernel(float const*)"
    events = [ev("aten::copy_", "cpu_op", 0.0, 500.0)]
    for i in range(4):
        events += [ev(fwd, "kernel", 50.0 + 100 * i, 80.0),
                   ev("elementwise_kernel", "kernel", 135.0 + 100 * i, 5.0)]
    c = trace.reduce_events(events, clip=trace.is_forward)
    assert c.units == 3
    assert c.span_s == pytest.approx(300e-6)
    assert c.busy_s == pytest.approx(3 * 85e-6)
    assert sum(1 for n, cat, _ in c.device if trace.is_forward(n)) == 3
    assert trace.reduce_events(events[:2], clip=trace.is_forward).units == 0
    s = _summary("serve", [c, c])
    assert s.units == 6
    assert spec.reader("launches_per_frame.serve")(s) == 2
    assert spec.reader("device_idle_share.serve")(s) == pytest.approx(
        100 * 45 / 300)
    assert spec.reader("fwd_kernel_roofline.serve")(s) == pytest.approx(
        100 * s.least_seconds("forward") / 80e-6)


def _summary(kind, cycles):
    cfg = {"render": {"marching_steps": 32},
           "work": {"ops_per_eval": 65, "ops_per_vjp": 226,
                    "matmul_flops_per_eval": 0, "matmul_flops_per_vjp": 0,
                    "param_scalars": 14},
           "peaks": {"f32_flops_per_s": 67e12, "tf32_flops_per_s": 495e12,
                     "hbm_bytes_per_s": 3.35e12}}
    rays = 1000
    return trace.Summary(
        kind=kind, cycles=cycles,
        work={"forward": yardstick.forward_work(cfg, rays),
              "backward": yardstick.backward_work(cfg, rays),
              "step": yardstick.train_step_work(cfg, rays),
              "frame": yardstick.serve_frame_work(cfg, rays)},
        peaks=cfg["peaks"])


def test_readers_on_a_training_trace():
    s = _summary("train", [trace.reduce_events(EVENTS)] * 2)
    read = {m: spec.reader(m)(s) for m in (
        "fwd_kernel_roofline.train", "bwd_kernel_roofline.train",
        "glue_device_ms.train", "launches_per_step.train",
        "device_idle_share.train", "mfu.train")}
    assert read["fwd_kernel_roofline.train"] == pytest.approx(
        100 * s.least_seconds("forward") / 100e-6)
    assert read["bwd_kernel_roofline.train"] == pytest.approx(
        100 * s.least_seconds("backward") / 200e-6)
    assert read["glue_device_ms.train"] == pytest.approx(0.030)
    assert read["launches_per_step.train"] == 3
    assert read["device_idle_share.train"] == pytest.approx(100 * 70 / 400)
    assert read["mfu.train"] == pytest.approx(
        100 * s.least_seconds("step") / 400e-6)
    for m in ("fwd_kernel_roofline.serve", "mfu.serve",
              "glue_device_ms.serve", "launches_per_frame.serve",
              "device_idle_share.serve"):
        assert spec.reader(m)(s) is None


def test_readers_find_nothing_to_read():
    empty = _summary("serve", [])
    for path in sorted((spec.BENCH_DIR / "metrics").glob("*.py")):
        assert spec.reader(path.stem)(empty) is None
    no_kernels = _summary("train", [trace.reduce_events(EVENTS[:1])])
    assert spec.reader("fwd_kernel_roofline.train")(no_kernels) is None


def test_breakdown_has_at_most_ten_of_each():
    s = _summary("train", [trace.reduce_events(EVENTS)])
    b = s.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0][0].endswith("render_bwd_kernel")
