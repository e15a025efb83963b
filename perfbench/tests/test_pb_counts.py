"""The operation and bound counts the per-layer metrics divide by,
reconciled with the figures the program's own count gave (PERF.md); the
conv configurations' counts and weights pinned to the values the cells
were measured with; and the other archs' operations counted as the
program's modules count them."""

import hashlib

import pytest
import torch

from perfbench.core.peaks import conv3x3_bound_s, tc_bounds_s
from perfbench.reference import flops
from perfbench.reference import model as ref
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


def _digest(items) -> str:
    return hashlib.sha256(repr(tuple(items)).encode()).hexdigest()


@pytest.mark.parametrize("arch, batch, products, decode, tc_s, conv_s, calls, calls_digest", [
    (A64, 64, 3079055343616, float.fromhex("0x1.5fe0000000000p+30"),
     float.fromhex("0x1.3d95c53815a38p-17"), float.fromhex("0x1.c1a6fd8642f39p-11"), 323,
     "e8bd1f9954fb829d673ef28a7931ebbeead729d8ba876f3b9bb64bd6e9026faf"),
    (A128, 128, 25217900478464, float.fromhex("0x1.6880000000000p+32"),
     float.fromhex("0x1.3d95c53815a38p-15"), float.fromhex("0x1.c113a9fa67580p-8"), 387,
     "6d849259b4ebff9ac0f648aa968e89e422ebcc505cc976c7215a77ec2c0f2909"),
])
def test_conv_counts_are_pinned(arch, batch, products, decode, tc_s, conv_s, calls,
                                calls_digest):
    """What ``mfu.train``, ``mfu.sample``, ``tc_roofline`` and
    ``conv_roofline`` divide by in the four cells, bit for bit."""
    assert arch.block == "conv"
    assert flops.step_products(arch, batch) == products
    assert flops.decode_flops_per_image(arch) == decode
    assert flops.tc_bound_s(arch, batch) == tc_s
    assert flops.routed_conv_bound_s(arch, batch, "bf16") == conv_s
    got = flops.conv_calls(arch, batch)
    assert len(got) == calls and _digest(got) == calls_digest


def test_conv_weights_are_pinned():
    """``make_weights`` draws the conv leaves in the same order from the
    same flat draw: names, order and every bit of a seed's weights."""
    w = ref.make_weights(A64, 2**33 + 5, "cpu")
    names = list(w)
    assert len(names) == 63
    assert names[:3] == ["encoder.main.0.weight", "encoder.main.1.weight", "encoder.main.1.bias"]
    assert names[-3:] == ["decoder.main.res_in_64.bn2.bias", "decoder.main.predict.weight",
                          "decoder.main.predict.bias"]
    assert hashlib.sha256("\n".join(names).encode()).hexdigest() == \
        "24db32a0c5af67ef042dfb79911d6dd1e2583394e452c520f2e9f415799f1163"
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == "46b483769d89d55304e7407f2b08db32219ccfe495c181304d0e7f8fd7c04558"


@pytest.mark.parametrize("block", ["res", "inception"])
def test_block_counts_match_the_ports_modules(block):
    """One forward of the reference's encoder and decoder counts the same
    conv and dense operations as the program's ``Encoder`` and ``Decoder``
    at the same shapes (32 px, channels 16-32, z 16: both expanding and
    identity blocks)."""
    from torch.utils.flop_counter import FlopCounterMode

    from intro_tc_vae_tpu_torch.models import Decoder, Encoder

    arch = Arch(32, (16, 32), 3, 16, block)
    weights = ref.make_weights(arch, 3, "cpu")
    x, z = torch.rand(2, 3, 32, 32), torch.randn(2, arch.zdim)
    kw = dict(arch=block, cdim=3, zdim=arch.zdim, channels=arch.channels,
              image_size=arch.image_size)

    def count(fn):
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn()
        return counter.get_total_flops()

    for program, reference, inp in ((Encoder(**kw), ref.encoder, x),
                                    (Decoder(**kw), ref.decoder, z)):
        want = count(lambda: reference(weights, arch, inp))
        assert want > 0 and count(lambda: program(inp)) == want
