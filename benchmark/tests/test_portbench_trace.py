"""Busy time, idle gaps and annotation time from a trace."""

from benchmark import trace
from benchmark.trace import Span, Trace


def _trace():
    device = [Span("void glimpse_sample_kernel<true, true>", 0, 10),
              Span("elementwise_kernel", 5, 20), Span("Memset (Device)", 30, 32),
              Span("multi_tensor_apply_kernel", 40, 50), Span("nccl AllReduce", 60, 70)]
    host = [Span("aten::conv2d", 0, 100), Span("aten::copy_", 20, 35),
            Span("Optimizer.step#Adam.step", 36, 55)]
    notes = [Span("Optimizer.step#Adam.step", 38, 52)]
    return Trace(device, notes, host, 100.0)


def test_busy_is_the_union():
    tr = _trace()
    assert tr.busy_us() == 20 + 2 + 10 + 10
    assert tr.gaps() == [(20, 30), (32, 40), (50, 60)]
    assert len(tr.kernels) == 4


def test_gaps_named_by_the_host_op_open():
    gaps = trace.named_gaps(_trace())
    assert gaps["copies / casts"] == 10 / 1e6
    assert gaps["Optimizer.step#Adam.step"] == 8 / 1e6
    assert gaps["convolution"] == 10 / 1e6


def test_time_under_an_annotation():
    assert trace.time_under(_trace(), "Optimizer.step#") == 10
    assert trace.time_under(_trace(), "nothing") == 0


def test_groups_name_the_device_ops():
    ops = trace.device_ops(_trace())
    assert ops["retina sampler (B1)"] == 10 / 1e6
    assert ops["optimizer"] == 10 / 1e6


def test_every_reader_on_a_synthetic_run():
    """Each metric file under ``benchmark/metrics/`` reads a run made up
    here; the kernel readers find what they name in the trace."""
    from types import SimpleNamespace

    from benchmark import spec

    run = SimpleNamespace(
        setup_s=20.0, window_s=30.0, steps=300, step_ms=[100.0] * 290 + [150.0] * 10,
        images_per_step=256, flops_per_step=4e12, peak_bytes=2**30, world=1,
        peaks={"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}, trace=_trace(),
        trace_steps=2, b1_bytes=[3.35e6], busy_s=[4e-5], traced_window_s=[1e-4])
    want = {"setup_s": 20.0, "train_images_per_s": 2560.0, "peak_mem_gib": 1.0,
            "dispatch.launches_per_step": 2.0, "optimizer.device_ms": 0.005,
            "glimpse_sample.roofline_pct": 10.0,
            "device.busy_ms": 0.02}
    names = sorted(p.stem for p in (spec.HERE / "metrics").glob("*.py"))
    assert len(names) == 10
    for name in names:
        value = spec.reader(name)(run)
        assert value is not None and value > 0, name
        if name in want:
            assert abs(value - want[name]) < 1e-9 * max(1.0, want[name]), (name, value)
