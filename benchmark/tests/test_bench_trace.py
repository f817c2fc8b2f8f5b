"""The reduction of a device trace: busy union, idle gaps, names."""

from benchmark import trace


def test_busy_union_merges_overlaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.busy_union_s(iv) == 3.0
    assert trace.busy_union_s([]) == 0.0


def test_idle_gaps_lie_between_merged_intervals():
    iv = [(3.0, 4.0), (0.0, 1.0), (0.5, 2.0)]
    assert trace.idle_gaps(iv) == [(2.0, 3.0)]


def test_summarize_names_and_sums():
    dev = [("gemm", 0.0, 1.0), ("flash_fwd_mma_kernel<80>", 1.0, 1.5),
           ("gemm", 2.5, 3.0)]
    host = [("aten::mm", 1.4, 2.9), ("cudaLaunchKernel", 1.9, 2.1)]
    s = trace.summarize(dev, host, 4.0)
    assert s["busy_s"] == 2.0 and s["window_s"] == 4.0
    assert s["device_ops"][0] == ["gemm", 1.5]
    assert s["idle_gaps"] == [["host in cudaLaunchKernel", 1.0]]
    assert trace.kernel_time(s, "flash_fwd") == (0.5, 1)
    assert trace.kernel_time(s, "nothing") == (0.0, 0)


def test_stretch_counts_the_steps_it_holds():
    now = [0.0]
    st = trace.Stretch(False, 1.0, 2.0, clock=lambda: now[0])
    for t in range(5):
        now[0] = float(t)
        st.tick()
    assert st.summary is None and not st.active and st.ticks == 0
