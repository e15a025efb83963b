"""3x3 stride-1 'SAME' conv, 64 -> 64 channels: eligibility gate and plain versions.

Counterpart of the shape logic of ``intro_tc_vae_tpu/ops/conv_pallas.py``,
translated to the port's layouts (activations NCHW, weights OIHW):

* ``supported`` is the JAX predicate (conv_pallas.py:339) unchanged, so
  both packages route the same convs: a 3x3 kernel, Cin = Cout = 64, no
  bias (the caller's condition), H % 16 == 0, W even and >= 4,
  H * W <= 128^2.
* ``rot_t`` is ``_rot_t`` (conv_pallas.py:143): the weights of a stride-1
  conv's input-gradient pass, rot180 with input and output channels
  swapped.
* ``conv3x3_reference`` and its input and weight gradients are the plain
  PyTorch versions of the CUDA kernels (``ops/conv_cuda.py``). The kernel
  wrappers take them for CPU tensors.
* ``kernel_body`` is the one rule that says which body of ``conv3x3_fwd``
  and ``conv3x3_dw`` a shape and dtype run on the card: ``"fp32"``
  (``csrc/conv_fp32.cu``), ``"wgmma"`` (``csrc/conv_wgmma.cu``, W in
  FAST_WIDTHS) or ``"ragged"`` (the same kernels' entry points for every
  other even W).
* ``fast_path``, ``box_width``, ``tile_schedule``, ``pack_weights`` and
  ``conv3x3_dw_partials_reference`` are the host side of the bf16 kernels:
  which shapes take the wgmma entry points, how wide a box of a row is,
  which units of the activations each persistent block walks, the weight
  layout they read, and the split dW sum in the order the card takes it.
* ``fp32_tile``, ``fp32_launch_plan`` and ``fp32_tile_schedule`` are the
  same for the fp32 kernels, which take every shape; ``pack_weights`` and
  ``conv3x3_dw_partials_reference`` serve them with ``co_inner`` and
  ``schedule=fp32_tile_schedule``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

CHANNELS = 64
WEIGHT_SHAPE = (CHANNELS, CHANNELS, 3, 3)
FAST_WIDTHS = (32, 64, 128)  # the widths the wgmma kernels take
FP32_TILE_PIXELS = 512       # pixels of a unit of the fp32 kernels


def _pick_tile(h: int) -> int:
    """The JAX kernel's row-strip height (conv_pallas.py:274); part of its
    gate, kept so that both packages accept the same shapes."""
    return h if h <= 64 else 64


def supported(x_shape, w_shape) -> bool:
    """Whether the conv kernels take this conv: x [N, 64, H, W], w
    [64, 64, 3, 3], H a multiple of 16 (and of the JAX strip height), W
    even and >= 4, H * W <= 128^2."""
    if tuple(w_shape) != WEIGHT_SHAPE:
        return False
    _, c, h, w = x_shape
    return (c == CHANNELS and h % 16 == 0 and h % _pick_tile(h) == 0
            and w % 2 == 0 and w >= 4 and h * w <= 128 * 128)


def rot_t(w: torch.Tensor) -> torch.Tensor:
    """OIHW weights of the input-gradient conv: dx = conv3x3(gy, rot_t(w))."""
    return w.transpose(0, 1).flip(2, 3)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = conv3x3(x, w), zero padding 1."""
    return F.conv2d(x, w, padding=1)


def conv3x3_dx_reference(gy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dx of y = conv3x3(x, w) for the incoming gy."""
    return F.conv2d(gy, rot_t(w), padding=1)


def conv3x3_dw_reference(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """dL/dw [64, 64, 3, 3] of y = conv3x3(x, w) for the incoming gy, in
    x's dtype."""
    return torch.nn.grad.conv2d_weight(x, WEIGHT_SHAPE, gy, padding=1)


def fast_path(shape, dtype) -> bool:
    """Whether the wgmma entry points take activations of this shape and
    dtype: bf16 [N, 64, H, W] with W in FAST_WIDTHS (one or two 64-pixel
    boxes a row, or one 32-pixel box, none cut; TMA lands every row). Every
    other bf16 shape the wrappers accept runs the ragged entry points of
    the same kernels."""
    if dtype != torch.bfloat16 or len(shape) != 4:
        return False
    n, c, h, w = shape
    return (c == CHANNELS and n >= 1 and h >= 1 and w in FAST_WIDTHS
            and n * c * h * w < 2**31)


def kernel_body(shape, dtype) -> str:
    """The body of conv3x3_fwd and conv3x3_dw that activations of this
    shape and dtype run on the card: all of fp32 the FFMA kernels, bf16
    the wgmma entry points where ``fast_path`` admits the shape and the
    ragged ones elsewhere (which take even W only: the wrappers raise on
    an odd bf16 width, which the gate never routes)."""
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if fast_path(shape, dtype) else "ragged"


def box_width(w: int) -> int:
    """Pixels of a row in one shared-memory slab: 16 where the row has at
    most 16, 32 where it has at most 32, else 64 (ceil(W / 64) boxes a
    row). A narrower box costs more shared-memory reads per product, so a
    row takes the widest box it needs (csrc/conv_wgmma.cu)."""
    return 16 if w <= 16 else 32 if w <= 32 else 64


def box_columns(w: int) -> int:
    """Boxes a row: the last one is cut at W where the box does not divide it."""
    return -(-w // box_width(w))


@functools.lru_cache(maxsize=None)
def row_chunk(n: int, h: int, w: int, n_blocks: int) -> int:
    """Rows per unit: the divisor rc of H for which the busiest of n_blocks
    blocks loads the fewest rows, ceil(units / blocks) * (rc + 2) with the
    one-row halo above and below; the larger rc on a tie. Small images get
    short units on many blocks (a row's latency chain is the cost there),
    large ones one unit a block."""
    cols = box_columns(w)
    best, best_cost = h, None
    for rc in range(h, 0, -1):
        if h % rc:
            continue
        units = n * (h // rc) * cols
        blocks = min(n_blocks, units)
        cost = -(-units // blocks) * (rc + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = rc, cost
    return best


def launch_plan(n: int, h: int, w: int, n_blocks: int) -> tuple:
    """(rows per unit, persistent blocks) the launchers are given."""
    rc = row_chunk(n, h, w, n_blocks)
    return rc, min(n_blocks, n * (h // rc) * box_columns(w))


def tile_schedule(n: int, h: int, w: int, n_blocks: int) -> list:
    """The units each persistent block walks, in order: block b of P =
    min(n_blocks, units) takes units b, b + P, ...; a unit is (image, first
    row, first column, rows, columns), numbered columns fastest, then row
    chunks, then images; the last box of a row is cut at W (the kernel
    lands it zero-filled past W). The kernels' ``unit_of`` is the same
    arithmetic."""
    (rc, blocks), bw = launch_plan(n, h, w, n_blocks), box_width(w)
    cols, chunks = box_columns(w), h // rc

    def unit(u):
        w0 = u % cols * bw
        return (u // (cols * chunks), (u // cols) % chunks * rc, w0, rc, min(bw, w - w0))

    return [[unit(u) for u in range(b, n * chunks * cols, blocks)] for b in range(blocks)]


def fp32_tile(w: int) -> tuple:
    """(rows, columns) of a unit of the fp32 kernels: FP32_TILE_PIXELS
    pixels, 64 columns wide, 32 where the image is no wider."""
    cols = 64 if w > 32 else 32
    return FP32_TILE_PIXELS // cols, cols


def fp32_launch_plan(n: int, h: int, w: int, n_blocks: int) -> int:
    """Persistent blocks of the fp32 kernels: no more than units."""
    rows, cols = fp32_tile(w)
    return min(n_blocks, n * -(-h // rows) * -(-w // cols))


def fp32_tile_schedule(n: int, h: int, w: int, n_blocks: int) -> list:
    """``tile_schedule`` for the fp32 kernels, which take any H and W: the
    units tile each image in ``fp32_tile`` steps and the last of a row or
    column is cut at the image's edge. Same numbering, same walk (block b
    of P takes units b, b + P, ...), same tuples. The kernels' ``unit_of``
    (csrc/conv_fp32.cu) is the same arithmetic."""
    (rows, cols), blocks = fp32_tile(w), fp32_launch_plan(n, h, w, n_blocks)
    col_chunks, row_chunks = -(-w // cols), -(-h // rows)

    def unit(u):
        h0, w0 = (u // col_chunks) % row_chunks * rows, u % col_chunks * cols
        return (u // (col_chunks * row_chunks), h0, w0, min(rows, h - h0), min(cols, w - w0))

    return [[unit(u) for u in range(b, n * row_chunks * col_chunks, blocks)]
            for b in range(blocks)]


def pack_weights(w: torch.Tensor, rot: bool, co_inner: bool = False) -> torch.Tensor:
    """OIHW weights as [9, 64, 64] = [tap ky*3+kx][co][ci], the layout the
    wgmma forward reads, or with ``co_inner`` [tap][ci][co], the layout the
    fp32 forward reads; with ``rot`` the weights of the input-gradient
    conv, rot_t(w), in the same pass: out[t, co, ci] = w[ci, co, 8 - t]."""
    taps = w.permute(2, 3, 1, 0).flip(0, 1) if rot else w.permute(2, 3, 0, 1)
    if co_inner:
        taps = taps.transpose(2, 3)
    return taps.reshape(9, CHANNELS, CHANNELS).contiguous()


def unpack_weights(wp: torch.Tensor, co_inner: bool = False) -> torch.Tensor:
    """The OIHW weights a packed [9, 64, 64] tensor stands for."""
    taps = wp.reshape(3, 3, CHANNELS, CHANNELS)
    return taps.permute(3, 2, 0, 1) if co_inner else taps.permute(2, 3, 0, 1)


def conv3x3_dw_partials_reference(x: torch.Tensor, gy: torch.Tensor, n_blocks: int,
                                  schedule=tile_schedule):
    """dW by the split the bf16 kernels (or, with ``schedule=
    fp32_tile_schedule``, the fp32 kernel) takes: block b sums its units of
    the schedule into an fp32 partial [64, 64, 3, 3]; the partials are then
    added in order b = 0..P-1 and rounded once to x's dtype.
    Returns (dw, partials [P, 64, 64, 3, 3])."""
    n, _, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    g = gy.float()
    parts = []
    for units in schedule(n, h, w, n_blocks):
        part = torch.zeros(WEIGHT_SHAPE, dtype=torch.float32, device=x.device)
        for i, h0, w0, rows, cols in units:
            part += torch.nn.grad.conv2d_weight(
                xp[i:i + 1, :, h0:h0 + rows + 2, w0:w0 + cols + 2], WEIGHT_SHAPE,
                g[i:i + 1, :, h0:h0 + rows, w0:w0 + cols])
        parts.append(part)
    total = torch.zeros(WEIGHT_SHAPE, dtype=torch.float32, device=x.device)
    for part in parts:
        total += part
    return total.to(x.dtype), torch.stack(parts)
