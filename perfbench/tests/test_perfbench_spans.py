"""The program's spans in the device trace and the readers of them
(``harness/span_readers.py``, whose ``reduce_events`` keeps them beside
``harness/trace.py``'s reduction), on synthetic profiler events: a fit step
whose backward launches on a thread of its own, as autograd's device
thread does, and a pipelined viewer's clipped cycle, each worked by hand
(times in µs)."""

import pytest

from perfbench.harness import span_readers, spec, trace, yardstick

FWD, BWD = "render_fwd_train_kernel<float>", "render_bwd_kernel<float>"
NEW = ("host_ms", "idle_host_ms", "wrapper_host_ms")


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, tid=1):
    return ev("cudaLaunchKernel", "cuda_runtime", ts, 3.0, tid, corr)


def kernel(name, ts, dur, corr):
    return ev(name, "kernel", ts, dur, tid=7, corr=corr)


def mark(name, a, b, tid=1):
    return ev(name, "user_annotation", a, b - a, tid)


# One fit step. Device records: pose glue 25-35 (launch 10), the training
# forward 40-140 (30), shading 140-150 (55), the loss 150-155 (62); on the
# backward's thread shading's backward 160-170 (75), the backward kernel
# 170-270 (90) and its partials' sum 270-275 (100) inside its wrapper, the
# pose's backward 275-285 (130); Adam 312-320 (310); a copy 380-390 with no
# launching call. Idle: 0-25, 35-40, 155-160, 285-312, 320-380, 390-400.
STEP_BASE = [
    ev("aten::zero_", "cpu_op", 0.0, 5.0),
    launch(10, 1), kernel("elementwise_kernel", 25, 10, 1),
    launch(30, 2), kernel(FWD, 40, 100, 2),
    launch(55, 3), kernel("elementwise_kernel", 140, 10, 3),
    launch(62, 4), kernel("reduce_kernel", 150, 5, 4),
    launch(75, 5, tid=2), kernel("mul_kernel", 160, 10, 5),
    launch(90, 6, tid=2), kernel(BWD, 170, 100, 6),
    launch(100, 7, tid=2), kernel("reduce_kernel", 270, 5, 7),
    launch(130, 8, tid=2), kernel("mul_kernel", 275, 10, 8),
    launch(310, 9), kernel("multi_tensor_apply_kernel", 312, 8, 9),
    ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 380, 10),
    ev("cudaStreamSynchronize", "cuda_runtime", 330, 70),
]
STEP_SPANS = [
    mark("rm.optimize.step", 0, 400),
    mark("rm.optimize.render", 5, 60),
    mark("rm.render.pose", 5, 20),
    mark("rm.render.march", 20, 50),
    mark("rm.kernel.fwd.train.simt", 22, 48),
    mark("rm.render.shade", 50, 60),
    mark("rm.optimize.loss", 60, 70),
    mark("rm.optimize.backward", 70, 300),
    mark("rm.kernel.bwd.hist.simt", 80, 120, tid=2),
    mark("rm.optimize.update", 300, 330),
    mark("rm.optimize.sync", 330, 400),
    # torch's own record_function ranges are no program span
    mark("Optimizer.step#Adam.step", 305, 325),
]

# A pipelined viewer: frame i's span 100i+20 to 100i+120, its wait the last
# 30 µs, its render 100i+25 to 100i+45 holding the wrapper 100i+30 to
# 100i+40, whose launch at 100i+35 runs a frame later (100i+150, 80 µs),
# and a quantize launched at 100i+38 behind it. Forward kernels of frames
# 0-3 start at 150, 250, 350, 450: three periods, 150-450.
VIEW_BASE, VIEW_SPANS = [], []
for i in range(5):
    b = 100 * i
    VIEW_SPANS += [mark("rm.viewer.frame", b + 20, b + 120),
                   mark("rm.viewer.render", b + 25, b + 45),
                   mark("rm.kernel.fwd.serve.tc", b + 30, b + 40),
                   mark("rm.viewer.wait", b + 90, b + 120)]
    if i < 4:
        VIEW_BASE += [launch(b + 35, 10 + i),
                      kernel("render_fwd_tc_kernel(float const*)", b + 150,
                             80, 10 + i),
                      launch(b + 38, 20 + i),
                      kernel("elementwise_kernel", b + 230, 5, 20 + i)]
VIEW_BASE.append(ev("aten::copy_", "cpu_op", 0.0, 600.0))


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


def _read(name, s):
    reader, kind = name.split(".")
    return span_readers.READERS[reader](s, kind)


def test_spans_and_their_launches_across_two_threads():
    c = span_readers.reduce_events(STEP_BASE + STEP_SPANS)
    names = [n for n, _, _ in c.spans]
    assert "Optimizer.step#Adam.step" not in names and len(names) == 11
    assert ("rm.kernel.bwd.hist.simt", pytest.approx(80e-6),
            pytest.approx(120e-6)) in c.spans
    assert len(c.launched_in) == len(c.device)
    by_name = {}
    for (n, _, _), opened in zip(c.device, c.launched_in):
        by_name.setdefault(n, []).append(opened)
    step, back = "rm.optimize.step", "rm.optimize.backward"
    assert by_name[FWD] == [(step, "rm.optimize.render", "rm.render.march",
                             "rm.kernel.fwd.train.simt")]
    assert by_name[BWD] == [(step, back, "rm.kernel.bwd.hist.simt")]
    assert by_name["mul_kernel"] == [(step, back), (step, back)]
    assert by_name["Memcpy DtoD (Device -> Device)"] == [()]
    assert c.idle == [pytest.approx(x) for x in [
        (0, 25e-6), (35e-6, 40e-6), (155e-6, 160e-6), (285e-6, 312e-6),
        (320e-6, 380e-6), (390e-6, 400e-6)]]


def test_readers_on_a_fit_step():
    c = span_readers.reduce_events(STEP_BASE + STEP_SPANS)
    s = _summary("train", [c] * 2)
    assert _read("host_ms.train", s) == pytest.approx(0.330)
    # 132 µs idle, 60 of it inside the loss read.
    assert _read("idle_host_ms.train", s) == pytest.approx(0.072)
    assert _read("wrapper_host_ms.train", s) == pytest.approx(0.026 + 0.040)
    # Shading's and the pose's backward and the partials' sum; not the
    # backward kernel.
    assert _read("bwd_glue_device_ms.train", s) == pytest.approx(0.025)
    for kind in NEW:
        assert _read(f"{kind}.serve", s) is None
    assert span_readers.readings(s) == {
        "host_ms.train": pytest.approx(0.330),
        "idle_host_ms.train": pytest.approx(0.072),
        "wrapper_host_ms.train": pytest.approx(0.066),
        "bwd_glue_device_ms.train": pytest.approx(0.025)}
    split = span_readers.split(s)
    assert split["rm.optimize.step"]["count"] == 1
    assert split["rm.kernel.bwd.hist.simt"]["device_ms"] == pytest.approx(
        0.105)
    assert split["rm.kernel.bwd.hist.simt"]["glue_device_ms"] == \
        pytest.approx(0.005)
    assert split["rm.optimize.backward"]["device_ms"] == pytest.approx(0.020)
    assert split["rm.kernel.bwd.hist.simt"]["kernels"] == 1
    assert split["rm.kernel.fwd.train.simt"]["kernels"] == 1
    assert split["rm.optimize.backward"]["kernels"] == 0
    assert split[None]["device_ms"] == pytest.approx(0.010)
    idle = {n: r["idle_ms"] for n, r in split.items()}
    assert idle["rm.optimize.sync"] == pytest.approx(0.060)
    assert idle["rm.optimize.backward"] == pytest.approx(0.020)
    assert idle["rm.render.pose"] == pytest.approx(0.015)
    assert sum(idle.values()) == pytest.approx(0.132)
    assert sum(r["records"] for r in split.values()) == 10


def test_a_clipped_cycle_cuts_its_spans_to_the_frame_periods():
    c = span_readers.reduce_events(VIEW_BASE + VIEW_SPANS,
                                   clip=trace.is_forward)
    assert c.units == 3 and c.span_s == pytest.approx(300e-6)
    frames = sorted((a, b) for n, a, b in c.spans if n == "rm.viewer.frame")
    assert frames == [pytest.approx(x) for x in [
        (0, 70e-6), (70e-6, 170e-6), (170e-6, 270e-6), (270e-6, 300e-6)]]
    assert all(0 <= a <= b <= c.span_s for _, a, b in c.spans)
    # Frame 0's spans end before the window: cut away, yet its kernel,
    # which starts the window, names them as its launch's spans.
    assert c.launched_in[0] == ("rm.viewer.frame", "rm.viewer.render",
                                "rm.kernel.fwd.serve.tc")
    assert len(c.launched_in) == len(c.device)
    s = _summary("serve", [c])
    # (70 + 100 + 100 + 30) µs of frames less 3 × 30 of waits, 3 periods.
    assert _read("host_ms.serve", s) == pytest.approx(0.070)
    assert _read("idle_host_ms.serve", s) == pytest.approx(0.015)
    assert _read("wrapper_host_ms.serve", s) == pytest.approx(0.010)
    wrappers = [n for n, _, _ in c.spans if n.startswith("rm.kernel.")]
    assert len(wrappers) == c.units
    for kind in NEW:
        assert _read(f"{kind}.train", s) is None
    assert _read("bwd_glue_device_ms.train", s) is None
    assert _read("bwd_glue_device_ms.serve", s) is None
    assert set(span_readers.readings(s)) == {f"{k}.serve" for k in NEW}


@pytest.mark.parametrize("events, clip", [
    (STEP_BASE + STEP_SPANS, None),
    (VIEW_BASE + VIEW_SPANS, trace.is_forward)], ids=["step", "clipped"])
def test_nothing_to_read_without_program_spans(events, clip):
    bare = [e for e in events if not (e["cat"] == "user_annotation"
                                      and e["name"].startswith("rm."))]
    c = span_readers.reduce_events(bare, clip=clip)
    assert c.spans == [] and set(c.launched_in) == {()}
    # The harness's own cycles, reduced without the spans, read so too.
    plain = trace.reduce_events(events, clip=clip)
    for cycle in (c, plain):
        for kind in ("train", "serve"):
            s = _summary(kind, [cycle])
            for name in NEW:
                assert _read(f"{name}.{kind}", s) is None
            assert _read("bwd_glue_device_ms.train", s) is None
            assert span_readers.readings(s) == {}
    assert span_readers.readings(None) == {}


@pytest.mark.parametrize("events, clip", [
    ([], None), (STEP_BASE[:1] + STEP_SPANS, trace.is_forward)],
    ids=["no-events", "no-forward-kernel"])
def test_an_empty_cycle_has_no_spans(events, clip):
    c = span_readers.reduce_events(events, clip=clip)
    assert c.units == 0 and c.spans == [] and c.launched_in == []
    assert span_readers.readings(_summary("train", [c])) == {}


@pytest.mark.parametrize("base, spans, clip", [
    (STEP_BASE, STEP_SPANS, None),
    (VIEW_BASE, VIEW_SPANS, trace.is_forward)], ids=["step", "clipped"])
def test_spans_leave_the_existing_readings_unchanged(base, spans, clip):
    bare = trace.reduce_events(base, clip=clip)
    spanned = trace.reduce_events(base + spans, clip=clip)
    kept = span_readers.reduce_events(base + spans, clip=clip)
    for c in (spanned, kept):
        assert (c.span_s, c.busy_s, c.units) == \
            (bare.span_s, bare.busy_s, bare.units)
        assert c.device == bare.device
        assert [s for _, s in c.gaps] == [s for _, s in bare.gaps]
    # The span-keeping reduction is the harness's, with the spans beside.
    assert (kept.span_s, kept.busy_s, kept.device, kept.gaps, kept.units) \
        == (spanned.span_s, spanned.busy_s, spanned.device, spanned.gaps,
            spanned.units)
    assert sum(b - a for a, b in kept.idle) == pytest.approx(
        sum(s for _, s in kept.gaps))
    kind = "train" if clip is None else "serve"
    for p in sorted((spec.BENCH_DIR / "metrics").glob("*.py")):
        read = spec.reader(p.stem)
        values = {read(_summary(kind, [c])) for c in (bare, spanned, kept)}
        assert len(values) == 1, p.stem


def test_the_harness_tracer_keeps_the_spans_inside_in_the_tracer():
    torch = pytest.importorskip("torch")

    def traced():
        tracer = trace.Tracer(1)
        tracer.begin()
        with torch.profiler.record_function("rm.optimize.step"):
            x = torch.ones(64)
            with torch.profiler.record_function("rm.optimize.render"):
                (x * 2).sum()
        tracer.end({})
        return tracer.kept[0]

    raw = []
    with span_readers.in_the_tracer(raw):
        kept = traced()
    assert trace.reduce_events is span_readers._reduce
    assert [c for _, c in raw] == [kept]
    assert [n for n, _, _ in kept.spans] == ["rm.optimize.step",
                                             "rm.optimize.render"]
    assert all(0 <= a <= b <= kept.span_s for _, a, b in kept.spans)
    # Outside it the harness reduces as before: no spans kept.
    assert not getattr(traced(), "spans", None)
