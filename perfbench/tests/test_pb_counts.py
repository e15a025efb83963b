"""The operation and bound counts the per-layer metrics divide by,
reconciled with the figures the program's own count gave (PERF.md)."""

import pytest

from perfbench.core.peaks import conv3x3_bound_s, tc_bounds_s
from perfbench.reference import flops
from perfbench.reference.model import Arch

A64 = Arch(64, (64, 128, 256, 512), 3, 128)
A128 = Arch(128, (64, 128, 256, 512, 512), 3, 128)


@pytest.mark.parametrize("arch, program_count", [(A64, 49.591), (A128, 203.068)])
def test_step_count_reconciles_with_the_programs(arch, program_count):
    """The program pairs phase E's decoder passes, so its count (analysis/
    ceiling.py, batch 64) also holds the input gradient of the prior's half,
    one decode's worth an image, that the model does not need."""
    per_image = flops.step_flops_per_image(arch, 64) / 1e9
    decode = flops.decode_flops_per_image(arch) / 1e9
    assert per_image + decode == pytest.approx(program_count, abs=1e-3)


def test_decode_counts():
    assert flops.decode_flops_per_image(A64) / 1e9 == pytest.approx(1.476, abs=1e-3)
    assert flops.decode_flops_per_image(A128) / 1e9 == pytest.approx(6.048, abs=1e-3)


def test_routed_conv_calls_of_a_step():
    calls = [(k, x[0], x[2]) for k, x, w in flops.conv_calls(A64, 64) if flops.routed(x, w)]
    # 8 decoder passes a step: every one forward, 7 with input gradients
    # (phase E's prior pass needs none), phase D's 4 with weight gradients;
    # two routed convs at 64 x 64, one at 32 x 32
    want = {("fwd", 64, 64): 16, ("fwd", 64, 32): 8, ("dx", 64, 64): 14, ("dx", 64, 32): 7,
            ("dw", 64, 64): 8, ("dw", 64, 32): 4}
    assert {k: calls.count(k) for k in want} == want and len(calls) == sum(want.values())
    assert not flops.routed((64, 64, 16, 16), (128, 64, 3, 3))
    assert not flops.routed((64, 64, 8, 8), (64, 64, 3, 3))


def test_bounds_match_the_kernel_table():
    """PERF.md's kernel table: tc_fwd 0.00057 ms at B = 64, Z = 128; the
    bf16 conv 0.04009 ms at [128, 64, 64, 64]."""
    assert tc_bounds_s(64, 64, 128)["tc_fwd"] * 1e3 == pytest.approx(0.00057, abs=5e-6)
    assert conv3x3_bound_s((128, 64, 64, 64), "bf16") * 1e3 == pytest.approx(0.04009, abs=5e-6)
    assert flops.tc_bound_s(A64, 64) == pytest.approx(5 * sum(tc_bounds_s(64, 64, 128).values()))
