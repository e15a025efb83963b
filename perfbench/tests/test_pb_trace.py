"""The reduction of a traced stretch: the busy union, idle gaps by the
span open, and kernels told apart by name."""

import pytest
import torch

from perfbench.core import trace as tr
from perfbench.core.profiled import Stretch
from perfbench.core.spans import Spans

NAMES = {
    "void (anonymous namespace)::conv3x3_fwd_wgmma<64, true>(CUtensorMap_st, int)": "hand",
    "void conv3x3_dw_reduce<__nv_bfloat16>(float const*, __nv_bfloat16*, int)": "hand",
    "tc_fwd(float const*, float const*, float const*, int)": "hand",
    "tc_bwd_dmu(double2 const*, float const*)": "hand",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "library",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized>": "library",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>": "memory",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>": "memory",
    "void at::native::reduce_kernel<512, 1>": "memory",
    "Memcpy DtoH (Device -> Pageable)": "memory",
}


def test_kernels_by_name():
    for name, kind in NAMES.items():
        got = ("hand" if tr.is_hand(name) else
               "library" if tr.is_library_compute(name) else "memory")
        assert got == kind, name
        assert tr.is_memory_bound(name) == (kind == "memory")
    assert tr.TC_KERNEL.search("tc_bwd_dz(double2 const*)")
    assert not tr.TC_KERNEL.search("void at::native::batch_norm_stats_kernel")


def test_busy_union_gaps_and_their_spans():
    device = [("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 4.0, 5.0), ("d", 6.0, 7.0)]
    ranges = [("perfbench::traced", 0.5, 7.5), ("perfbench::train_step", 2.9, 4.5),
              ("perfbench::drain", 5.2, 5.4), ("perfbench::loader_next", 5.6, 5.9)]
    t = tr.Trace(device=device, ranges=ranges, lo=1.0, hi=7.0)
    assert t.busy_s() == pytest.approx(4.0)
    assert t.window_s == pytest.approx(6.0)
    assert tr.gaps(device, 1.0, 7.0) == [(3.0, 4.0), (5.0, 6.0)]
    gaps = dict(t.idle_gaps())
    assert gaps == {"perfbench::train_step": pytest.approx(1.0),
                    "perfbench::traced": pytest.approx(1.0)}
    assert t.by_name(2) == [["b", 1.5], ["a", 1.0]]
    assert t.seconds_where(lambda n: n in ("c", "d")) == pytest.approx(2.0)
    assert tr.busy(device, 1.2, 1.4) == pytest.approx(0.2)


def test_stretch_on_the_cpu_reads_the_harness_spans():
    spans = Spans()
    st = Stretch(spans, torch.device("cpu"), after_share=0.0, device_s=0.0)
    for done in range(5):
        st.before(done, 1.0 * done, 10.0)
        with spans("train_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        st.after(done + 1)
    st.close(5)
    assert st.units == 3 and st.t_on < st.t_off
    names = {n for n, _, _ in st.trace.ranges}
    assert {"perfbench::traced", "perfbench::train_step"} <= names
    assert st.trace.device == []  # a CPU trace has no device operations
    assert [n for n, _, _ in spans.records] == ["train_step"] * 5
