"""The host-side plan of the sw_block kernels (K1, K3, K4) on the CPU.

``ops/sw_block.py:sw_plan`` decides how ``csrc/sw_block.cu`` lays out a
launch: slabs of 48 token rows per consumer warpgroup, slabs per CTA, the
product width, the weight ring, the shared-memory carve-up and the
persistent grid; the C entries take it as an int array.  These tests check,
without a card, that the persistent grid computes every window and token row
exactly once (ragged last groups and CTAs that walk many groups included),
that the carve-up fits an H100's 227 KB with no two live regions
overlapping, and that the wrappers' checks still refuse what the kernels do
not take.
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
                        ("ROW_TABLE", sb.ROW_TABLE), ("STATIC_SMEM", sb.STATIC_SMEM)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("N", [16, 48])
@pytest.mark.parametrize("C,hd", WIDTHS)
def test_carve_up_fits_and_regions_do_not_overlap(C, hd, N, pair):
    p = sb.sw_plan(C, C // hd, N, 100, pair=pair)
    assert p.smem <= sb.SMEM_LIMIT - sb.STATIC_SMEM
    assert p.nw in (1, 2) and p.stages >= 2 and p.nb in (1, 2)
    assert p.gw % (64 * p.nb) == 0 and p.gw % hd == 0 and C % p.gw == 0
    # A and B buffers: 48 rows of every 64-column chunk, the last chunk's 16
    # padding rows reading the next region (B after A, X after B: 2 KB at
    # least); X: the q/k/v of one head group (the fp32 residual lives in the
    # x1 scratch, off chip)
    assert p.off_b >= 48 * C * 2
    assert p.off_x - p.off_b >= 48 * C * 2
    assert p.slab_bytes - p.off_x >= max(3 * 48 * (p.gw + 8) * 2, 2048)
    # LN2's weight and bias pass through X after the attention
    assert p.slab_bytes - p.off_x >= 2 * C * 4
    # ring slots, slab bases and A buffers on 1024-byte swizzle atoms
    for off in (p.off_slab, p.slab_bytes, p.off_b, p.off_x, p.nb * sb.TILE_BYTES):
        assert off % 1024 == 0
    spans = [(0, p.stages * p.nb * sb.TILE_BYTES)]
    spans += [(p.off_slab + s * p.slab_bytes, p.off_slab + (s + 1) * p.slab_bytes)
              for s in range(p.nw)]
    spans += [(p.off_lab, p.off_lab + 2 * sb.ROW_TABLE * p.nw),
              (p.off_bar, p.off_bar + 16 * p.stages)]
    for (a0, a1), (b0, b1) in itertools.combinations(spans, 2):
        assert a1 <= b0 or b1 <= a0
    assert max(end for _, end in spans) + 1024 <= p.smem     # room to align the base
    assert p.off_bar % 8 == 0


def test_two_slabs_share_a_cta_where_they_fit():
    """C=256 (the 128^2 and 64^2 layers) holds two slabs per CTA beside a
    ring of 3 slots of two 64 x 64 tiles (m64n128 products), C=512 one slab
    beside 5 such slots; the pair kernel always one."""
    p256, p512 = sb.sw_plan(256, 8, 48, 100), sb.sw_plan(512, 8, 48, 100)
    assert (p256.nw, p256.nb, p256.stages) == (2, 2, 3)
    assert (p512.nw, p512.nb, p512.stages) == (1, 2, 5)
    assert sb.sw_plan(256, 8, 48, 100, pair=True).nw == 1


@pytest.mark.parametrize("C,heads,nb,gw", [(64, 4, 1, 64), (128, 4, 2, 128), (256, 8, 2, 128),
                                           (512, 8, 2, 128), (256, 16, 2, 128), (192, 4, 1, 192),
                                           (384, 8, 2, 384)])
def test_products_as_wide_as_the_widths_allow(C, heads, nb, gw):
    """m64n128 products where C and the head group (lcm(hd, 128)) allow, else
    m64n64; q, k and v come a head group of gw columns at a time."""
    p = sb.sw_plan(C, heads, 48, 100)
    assert (p.nb, p.gw) == (nb, gw)


def _windows(shape):
    B, T, H, W, C = shape
    return T * 16, B * (H // 4) * (W // 4)


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("shape", [
    (1, 3, 4, 4, 64), (1, 3, 8, 12, 128), (1, 3, 8, 12, 512), (2, 3, 16, 16, 64),
    (1, 3, 4, 12, 256), (1, 1, 4, 4, 256), (1, 1, 8, 12, 256), (1, 1, 4, 28, 512),
    (3, 1, 12, 20, 64), (8, 3, 128, 128, 256), (8, 3, 64, 64, 256), (8, 3, 32, 32, 512),
    (1, 3, 92, 92, 256), (1, 3, 76, 76, 512)])
def test_every_window_row_computed_once(shape, pair, sms):
    """The kernels are persistent: CTA b of the grid walks groups b, b +
    grid, ... of nw slabs, consumer warpgroup w taking slab group * nw + w,
    and slab s the window-token rows s*48 .. s*48 + 47; rows past the input
    are not written.  Under the plan's grid (at most one CTA per SM, none
    without a group) that covers every (window, token) once."""
    N, nwin = _windows(shape)
    p = sb.sw_plan(shape[-1], 8 if shape[-1] >= 256 else 4, N, nwin, pair=pair, sms=sms)
    assert p.nslab == -(-nwin * N // 48)
    assert p.groups == -(-p.nslab // p.nw) and p.grid == min(sms, p.groups)
    seen = {}
    for cta in range(p.grid):
        for group in range(cta, p.groups, p.grid):
            for slab in range(group * p.nw, (group + 1) * p.nw):
                for row in range(slab * 48, slab * 48 + 48):
                    if row < nwin * N:
                        seen[divmod(row, N)] = seen.get(divmod(row, N), 0) + 1
    assert seen == {(w, n): 1 for w in range(nwin) for n in range(N)}


@pytest.mark.parametrize("shape,walks", [((8, 3, 128, 128, 256), 32), ((8, 3, 64, 64, 256), 8),
                                         ((8, 3, 32, 32, 512), 4), ((1, 3, 92, 92, 256), 3),
                                         ((1, 3, 76, 76, 512), 3)])
def test_persistent_ctas_walk_the_serving_shapes(shape, walks):
    """On an H100's 132 SMs the serving shapes give each CTA up to `walks`
    groups, so the next slab's rows are requested during a pass."""
    N, nwin = _windows(shape)
    p = sb.sw_plan(shape[-1], 8, N, nwin)
    assert p.grid == 132 and -(-p.groups // p.grid) == walks


def test_x1_scratch_holds_every_thread_of_the_grid():
    """The fp32 residual's scratch: C / 2 values for each of the 96 threads
    of a warpgroup whose accumulator rows are real, per consumer warpgroup of
    the grid."""
    p = sb.sw_plan(256, 8, 48, 40)
    assert (p.grid, p.nw) == (20, 2)
    t = sb._scratch(p, 256, torch.device("cpu"))
    assert t.dtype == torch.float32 and t.numel() == 20 * 2 * 96 * 128
    assert sb.X1_THREADS == 96


def test_plan_array_is_what_the_c_entries_read():
    p = sb.sw_plan(512, 8, 48, 512)
    arr = p.as_array()
    assert len(arr) == 12 and list(arr) == list(p[:12])
    assert list(arr)[3] == p.nb and list(arr)[11] == p.grid
    src = CSRC.read_text()
    fields = re.search(r"plan\[12\] \(ops/sw_block.py:sw_plan\): ([^.]*)\.", src).group(1)
    names = [f.strip() for f in fields.replace("//", " ").split(",")]
    assert names == list(sb.SWPlan._fields[:12])


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
