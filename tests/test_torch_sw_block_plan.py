"""The host-side plan of the sw_block kernels (K1, K3, K4) on the CPU.

``ops/sw_block.py:sw_plan`` decides how ``csrc/sw_block.cu`` lays out a
launch: slabs of 48 token rows per consumer warpgroup, slabs per CTA, the
weight ring and the shared-memory carve-up; the C entries take it as an int
array.  These tests check, without a card, that the grid computes every
window and token row exactly once (ragged last CTAs included), that the
carve-up fits an H100's 227 KB with no two live regions overlapping, and
that the wrappers' checks still refuse what the kernels do not take.
"""

import itertools
import re
from pathlib import Path

import pytest
import torch

from pgtformer_tpu_torch.ops import sw_block as sb

CSRC = Path(sb.__file__).resolve().parents[1] / "csrc" / "sw_block.cu"

WIDTHS = [(C, hd) for C in (64, 128, 256, 512) for hd in (16, 32, 64)]


def test_constants_match_the_kernel_source():
    src = CSRC.read_text()
    for name, value in (("SLAB", sb.SLAB), ("TILE", sb.TILE), ("MAX_NW", sb.MAX_NW),
                        ("ROW_TABLE", sb.ROW_TABLE)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("N", [16, 48])
@pytest.mark.parametrize("C,hd", WIDTHS)
def test_carve_up_fits_and_regions_do_not_overlap(C, hd, N, pair):
    p = sb.sw_plan(C, C // hd, N, 100, pair=pair)
    assert p.smem <= sb.SMEM_LIMIT - (sb.PAIR_ARGS if pair else 0)
    assert p.nw in (1, 2) and p.stages >= 2
    assert p.gw % 64 == 0 and p.gw % hd == 0 and C % p.gw == 0
    # A and B buffers: 48 rows of every 64-column chunk, the last chunk's 16
    # padding rows reading the next region (B after A, X after B: 2 KB at
    # least); X: the fp32 residual, or the q/k/v of one head group before it
    assert p.off_b >= 48 * C * 2
    assert p.off_x - p.off_b >= 48 * C * 2
    assert p.slab_bytes - p.off_x >= max(48 * C * 4, 3 * 48 * (p.gw + 8) * 2, 2048)
    # ring slots, slab bases and A buffers on 1024-byte swizzle atoms
    for off in (p.off_slab, p.slab_bytes, p.off_b, p.off_x, sb.TILE_BYTES):
        assert off % 1024 == 0
    spans = [(0, p.stages * sb.TILE_BYTES)]
    spans += [(p.off_slab + s * p.slab_bytes, p.off_slab + (s + 1) * p.slab_bytes)
              for s in range(p.nw)]
    spans += [(p.off_lab, p.off_lab + sb.ROW_TABLE * p.nw),
              (p.off_bar, p.off_bar + 16 * p.stages)]
    for (a0, a1), (b0, b1) in itertools.combinations(spans, 2):
        assert a1 <= b0 or b1 <= a0
    assert max(end for _, end in spans) + 1024 <= p.smem     # room to align the base
    assert p.off_bar % 8 == 0


def test_two_slabs_share_a_cta_where_they_fit():
    """C=256 (the 128^2 and 64^2 layers) holds two slabs per CTA beside a
    4-slot ring, C=512 one; the pair kernel always one."""
    assert sb.sw_plan(256, 8, 48, 100).nw == 2
    assert sb.sw_plan(256, 8, 48, 100).stages == sb.sw_plan(512, 8, 48, 100).stages == 4
    assert sb.sw_plan(512, 8, 48, 100).nw == 1
    assert sb.sw_plan(256, 8, 48, 100, pair=True).nw == 1


def _windows(shape):
    B, T, H, W, C = shape
    return T * 16, B * (H // 4) * (W // 4)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("shape", [
    (1, 3, 4, 4, 64), (1, 3, 8, 12, 128), (1, 3, 8, 12, 512), (2, 3, 16, 16, 64),
    (1, 3, 4, 12, 256), (1, 1, 4, 4, 256), (1, 1, 8, 12, 256), (1, 1, 4, 28, 512),
    (3, 1, 12, 20, 64), (8, 3, 128, 128, 256), (8, 3, 64, 64, 256), (8, 3, 32, 32, 512)])
def test_every_window_row_computed_once(shape, pair):
    """The kernels give CTA b slabs b*nw .. b*nw + nw - 1 and slab s the
    window-token rows s*48 .. s*48 + 47; rows past the input are not written.
    Under the plan's grid that covers every (window, token) once, with no
    CTA that holds no row of the input."""
    N, nwin = _windows(shape)
    p = sb.sw_plan(shape[-1], 8 if shape[-1] >= 256 else 4, N, nwin, pair=pair)
    assert p.nslab == -(-nwin * N // 48)
    assert p.grid * p.nw >= p.nslab > (p.grid - 1) * p.nw
    seen = {}
    for cta in range(p.grid):
        for slab in range(cta * p.nw, (cta + 1) * p.nw):
            for row in range(slab * 48, slab * 48 + 48):
                if row < nwin * N:
                    seen[divmod(row, N)] = seen.get(divmod(row, N), 0) + 1
    assert seen == {(w, n): 1 for w in range(nwin) for n in range(N)}


def test_plan_array_is_what_the_c_entries_read():
    p = sb.sw_plan(512, 8, 48, 512)
    arr = p.as_array()
    assert len(arr) == 11 and list(arr) == list(p[:11])
    assert list(arr)[10] == p.grid


@pytest.mark.parametrize("C,heads,N", [(96, 4, 48), (576, 8, 48), (256, 2, 48), (256, 32, 48),
                                       (256, 8, 32), (256, 8, 64), (256, 3, 48)])
def test_plan_refuses_what_the_kernels_do_not_take(C, heads, N):
    with pytest.raises(NotImplementedError):
        sb.sw_plan(C, heads, N, 10)


def _weights(C, heads, N, dtype=torch.bfloat16):
    mat = lambda: torch.zeros((C, C), dtype=dtype)
    vec = lambda: torch.zeros((C,))
    return sb.SWBlockWeights(vec(), vec(), mat(), vec(), mat(), vec(), mat(), vec(), mat(),
                             vec(), vec(), vec(), mat(), vec(), mat(), vec(),
                             torch.zeros((heads, N, N)), heads, (4, 4))


@pytest.mark.parametrize("shape,heads,shift,wdtype", [
    ((1, 3, 8, 8, 96), 4, (0, 0), torch.bfloat16),     # C % 64
    ((1, 3, 8, 8, 256), 2, (0, 0), torch.bfloat16),    # hd = 128
    ((1, 3, 8, 8, 64), 4, (0, 0), torch.float32),      # fp32 weights
    ((1, 3, 6, 8, 64), 4, (0, 0), torch.bfloat16),     # H % window
    ((1, 3, 8, 8, 64), 4, (4, 0), torch.bfloat16),     # shift >= window
    ((1, 2, 8, 8, 64), 4, (0, 0), torch.bfloat16)])    # N = 32
def test_wrapper_checks_refuse(shape, heads, shift, wdtype):
    x = torch.zeros(shape, dtype=torch.bfloat16)
    w = _weights(shape[-1], heads, shape[1] * 16, wdtype)
    with pytest.raises(NotImplementedError):
        sb._check_5d("sw_block", x, w, shift)


def test_wrapper_checks_take_the_serving_shapes():
    for shape in ((8, 3, 128, 128, 256), (8, 3, 32, 32, 512), (2, 1, 16, 16, 64)):
        x = torch.zeros((1,) + shape[1:4] + (shape[-1],), dtype=torch.bfloat16)
        w = _weights(shape[-1], 8 if shape[-1] >= 256 else 4, shape[1] * 16)
        sb._check_5d("sw_block", x, w, (2, 2))
        sb.sw_plan(shape[-1], w.num_heads, shape[1] * 16, 64)


def test_wrapper_checks_refuse_an_unaligned_input():
    """The kernels stage the slab's rows with 16-byte copies."""
    base = torch.zeros((1 + 3 * 8 * 8 * 64,), dtype=torch.bfloat16)
    x = base[1:].view(1, 3, 8, 8, 64)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(NotImplementedError):
        sb._check_5d("sw_block", x, _weights(64, 4, 48), (0, 0))
