"""The window's arithmetic and the trace's reduction, on made-up numbers."""

import pytest

from portbench import cells, trace


def e2e(name, run):
    return cells.reader("end_to_end", name).read(run)


def test_rate_is_all_work_over_all_time():
    # 7 whole iterations of 4 images, the last one ending (its wait) at 43.5 s
    run = {"units": 28, "seconds": 43.5, "steps": 7, "peak_bytes": 3 * 2**30, "setup_s": 51.0}
    assert e2e("image_iters_per_s", run) == pytest.approx(28 / 43.5)
    assert e2e("peak_mem_gib", run) == 3.0
    assert e2e("setup_s", run) == 51.0
    assert e2e("peak_mem_gib", dict(run, peak_bytes=0)) is None


def test_window_counts_whole_iterations(tiny_cell):
    drv = cells.driver(tiny_cell).Driver(tiny_cell, 5, "cpu")
    win = drv.window(3600.0, max_steps=3)
    assert win["steps"] == 3 and win["units"] == 3 * tiny_cell.traffic["images"]
    assert sorted(drv.losses) == [0, 1, 2, 3] and sorted(drv.iterates) == [0, 1, 2, 3]
    assert drv.failures() == {"attempted": 12, "failed": 0}


US = 1000  # ns


def test_summarize_union_gaps_and_groups():
    ev = [
        (trace.HOST, 0, 100 * US, trace.WINDOW_SPAN),
        (trace.HOST, 0, 10 * US, "portbench.draws"),
        (trace.HOST, 10 * US, 90 * US, "portbench.step"),
        (trace.DEVICE, 12 * US, 30 * US, "cudnn_conv_fprop"),
        (trace.DEVICE, 20 * US, 40 * US, "nvjet_gemm"),        # overlaps the convolution
        (trace.DEVICE, 20 * US, 40 * US, "nvjet_gemm"),        # listed twice
        (trace.DEVICE, 60 * US, 70 * US, "flash_fwd_kernel_tma"),
        (trace.DEVICE, 95 * US, 96 * US, "RowwiseMoments"),
        (trace.DEVICE, 150 * US, 160 * US, "after_the_window"),
    ]
    t = trace.summarize(ev, steps=2, units=8)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((28 + 10 + 1) * 1e-6)
    assert t.device_ops == 4
    assert t.group_s[trace.CONV] == pytest.approx(18e-6)
    assert t.group_s[trace.ATTENTION] == pytest.approx(10e-6)
    # gaps: 0-12 (starts in draws), 40-60 and 70-95 (start in step), 96-100
    # (between calls), longest first
    assert [n for n, _ in t.gaps] == ["portbench.step", "portbench.step", "portbench.draws",
                                      "portbench.window (between calls)"]
    assert [g for _, g in t.gaps] == pytest.approx([25e-6, 20e-6, 12e-6, 4e-6])
    assert sum(g for _, g in t.gaps) == pytest.approx(100e-6 - t.busy_s)
    read = lambda n: cells.reader("metrics", n).read(t)  # noqa: E731
    assert read("idle_share") == pytest.approx(100 * (1 - 39 / 100))
    assert read("kernels_per_iter") == 2.0
    assert read("attn_ms_per_iter") == pytest.approx(5e-3)
    assert read("conv_ms_per_iter") == pytest.approx(9e-3)
    t.work = {"attention_bound_s": 1e-6, "flops": 1e12,
              "peak": {"flops": 989e12, "bytes_per_s": 3.35e12}}
    t.run = {"image_iters_per_s": 0.5}
    assert read("attn_roofline") == pytest.approx(100 * 1e-6 * 8 / 10e-6)
    assert read("mfu") == pytest.approx(100 * 1e12 * 0.5 / 989e12)
    b = t.breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_device_only_trace_uses_the_wall_and_annotations():
    ev = [(trace.ANNOTATION, 5 * US, 60 * US, "portbench.step"),
          (trace.DEVICE, 10 * US, 30 * US, "k1"), (trace.DEVICE, 40 * US, 50 * US, "k2")]
    t = trace.summarize(ev, steps=1, units=4, wall_s=100e-6)
    assert t.window_s == pytest.approx(100e-6) and t.busy_s == pytest.approx(30e-6)
    assert t.gaps == [(trace.OUTSIDE, pytest.approx(60e-6)), ("portbench.step", pytest.approx(10e-6))]


def test_readers_find_nothing_where_nothing_ran():
    t = trace.summarize([(trace.HOST, 0, 10 * US, trace.WINDOW_SPAN)], steps=1, units=4)
    for name in ("kernels_per_iter", "conv_ms_per_iter", "attn_ms_per_iter", "attn_roofline",
                 "mfu", "norm_ms_per_iter"):
        assert cells.reader("metrics", name).read(t) is None
    assert cells.reader("metrics", "idle_share").read(t) == 100.0
