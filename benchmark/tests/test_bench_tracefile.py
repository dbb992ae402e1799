"""The trace reader on a hand-made Chrome trace: the traced window, busy
time, launches a step, device time of a span's work, the breakdown."""

import json

import pytest


def X(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def events(tmp_path):
    import tracefile
    raw = [X("user_annotation", tracefile.WINDOW, 0, 100),
           X("user_annotation", tracefile.STEP, 10, 30),
           X("user_annotation", tracefile.STEP, 50, 30),
           X("user_annotation", "bench.attn", 12, 10),
           X("cpu_op", "aten::mm", 11, 5),
           X("cpu_op", "aten::copy_", 45, 4),
           # launches: two in step 1 (one inside attn), one in step 2,
           # one outside any step
           X("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=1),
           X("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
           X("cuda_driver", "cuLaunchKernel", 55, 1, corr=3),
           X("cuda_runtime", "cudaMemcpyAsync", 90, 1, corr=4),
           X("cuda_runtime", "cudaStreamSynchronize", 60, 1),
           X("kernel", "flash", 20, 10, tid=7, corr=1),
           X("kernel", "gemm", 30, 10, tid=7, corr=2),
           X("kernel", "gemm", 60, 20, tid=7, corr=3),
           X("gpu_memcpy", "Memcpy HtoD", 95, 10, tid=7, corr=4)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": raw}))
    return tracefile.load(str(path))


def test_busy_window_and_launches(events):
    import tracefile
    busy, window = tracefile.busy_seconds(events)
    assert window == pytest.approx(100e-6)
    # 20..40 and 60..80 and 95..100 (clipped at the window's end)
    assert busy == pytest.approx(45e-6)
    assert len(events.launches_in(tracefile.STEP)) == 3
    assert events.device_seconds_of("bench.attn") == pytest.approx(10e-6)
    assert events.device_seconds_of("bench.none") is None


def test_breakdown_names_device_ops_and_idle_gaps(events):
    import tracefile
    b = tracefile.breakdown(events)
    ops = dict(b["device_ops"])
    assert ops["gemm"] == pytest.approx(30e-6)
    assert ops["flash"] == pytest.approx(10e-6)
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(55e-6)
    # the gaps 0..20 and 40..60 have their middles in a train step's span
    # (aten::mm starts after 10, aten::copy_ ends before 50); nothing but
    # the window covers 80..95
    assert gaps[tracefile.STEP] == pytest.approx(40e-6)
    assert gaps["(no host operation)"] == pytest.approx(15e-6)
