"""The yardstick's arithmetic on hand-worked shapes: the operation counter
on the meta device, K1's and K6's operations and bytes, the union of
device intervals and the idle share, the kernel groups, the traffic plan,
the percentile."""

import math
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

import devtrace
import roofline
import traffic


def test_flop_counter_on_meta():
    # conv 3x3, 4 -> 8 channels, on 2 x 16 x 16: 2*9*4 per output value;
    # linear 32 -> 64 on 10 rows: 2*32 per output value; bmm [3, 5, 7] x [3, 7, 2]
    with torch.device("meta"):
        x = torch.empty(2, 4, 16, 16)
        w = torch.empty(8, 4, 3, 3)
        a, wl = torch.empty(10, 32), torch.empty(64, 32)
        p, q = torch.empty(3, 5, 7), torch.empty(3, 7, 2)

        def run():
            F.conv2d(x, w, padding=1)
            F.linear(a, wl)
            torch.bmm(p, q)
        flops = roofline.count_flops(run)
    assert flops == 2 * 9 * 4 * (2 * 8 * 16 * 16) + 2 * 32 * (10 * 64) + 2 * 7 * (3 * 5 * 2)


def test_upsample_counts_its_phase_convs():
    # nearest 2x + conv3x3, 4 -> 6 channels on 2 x 8 x 8: counted as the
    # four 2x2 phase convs at the input's size, not the 3x3 conv at 16 x 16
    from reference import layers
    with torch.device("meta"):
        up = layers.Upsample(4)
        up.conv = layers.Conv2d(4, 6, 3, padding=1)
        x = torch.empty(2, 8, 8, 4)
        flops, seen = roofline.reference_shapes(lambda: up(x), layers)
        xc, k = torch.empty(2, 4, 9, 9), torch.empty(6, 4, 2, 2)
        phases = roofline.count_flops(lambda: [F.conv2d(xc, k) for _ in range(4)])
    assert seen["upsample"] == [((2, 8, 8, 4), 6)]
    assert flops == phases == 2 * 16 * 4 * 6 * (2 * 8 * 8)
    assert layers.record_upsample is None


def test_sw_block_count_and_bound():
    # one block over [1, 3, 4, 4, 8]: 48 tokens, 12*64 + 4*48*8 a token
    assert roofline.sw_block_flops((1, 3, 4, 4, 8)) == 48 * (12 * 64 + 4 * 48 * 8)
    # the release step's largest K1 shape is bound by its operations
    shape = (8, 3, 128, 128, 256)
    ms, by = roofline.sw_block_bound(shape)
    flops = 8 * 3 * 128 * 128 * (12 * 256 ** 2 + 4 * 48 * 256)
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)
    nbytes = 2 * (8 * 3 * 128 * 128) * 256 * 2 + 6 * 256 ** 2 * 2 + 10 * 256 * 4 + 8 * 48 ** 2 * 4
    assert ms > nbytes / 3.35e12 * 1e3


def test_mha_count_and_bound():
    assert roofline.mha_flops(2, 16, 4, 8) == 4 * 2 * 4 * 16 * 16 * 8
    ms, by = roofline.mha_bound(8, 3072, 8, 64)
    assert by == "operations"
    assert ms == pytest.approx(4 * 8 * 8 * 3072 ** 2 * 64 / 989e12 * 1e3)
    ms, by = roofline.mha_bound(1, 8, 1, 64)      # tiny: bound by its bytes
    assert by == "bytes" and ms == pytest.approx(4 * 8 * 64 * 2 / 3.35e12 * 1e3)


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (38, 45), (60, 70)]
    assert devtrace.union(iv, 0, 100) == [(0, 20), (30, 45), (60, 70)]
    assert devtrace.union(iv, 8, 65) == [(8, 20), (30, 45), (60, 65)]
    assert devtrace.gaps([(8, 20), (30, 45), (60, 65)], 0, 100) == [
        (0, 8), (20, 30), (45, 60), (65, 100)]


def _ev(s, t, n, x):
    return (s, t, n, x)


def test_reduce_takes_the_union_and_names_the_gaps():
    """Two streams overlap (a kernel and a readback copy): busy is their
    union, not the sum; a gap is named by the main thread's innermost op."""
    us = 1000
    host = [_ev(0, 1 * us, devtrace.BEGIN, 1),
            _ev(1 * us, 400 * us, "bench.call", 1),
            _ev(100 * us, 250 * us, "aten::cat", 1),
            _ev(150 * us, 160 * us, "cudaEventSynchronize", 2),     # another thread
            _ev(399 * us, 400 * us, devtrace.END, 1)]
    dev = [_ev(10 * us, 100 * us, "void sw_block_kernel<256>(Params)", False),
           _ev(50 * us, 120 * us, "Memcpy DtoH (Device -> Pinned)", True),
           _ev(300 * us, 305 * us, "vectorized_elementwise_kernel<add>", False),
           _ev(306 * us, 310 * us, "sm90_xmma_fprop_implicit_gemm_bf16", False)]
    red = devtrace.reduce(dev, host)
    assert red["window_s"] == pytest.approx(400e-6)
    assert red["busy_s"] == pytest.approx((120 - 10 + 5 + 4) * 1e-6)
    assert red["groups_s"] == pytest.approx({"sw_block (K1)": 90e-6,
                                             "elementwise/other": 5e-6,
                                             "conv (cuDNN)": 4e-6})
    assert red["kernels"]["Memcpy DtoH (Device -> Pinned)"] == pytest.approx((70e-6, 1))
    idle = red["idle_gaps"]
    assert idle["aten::cat"] == pytest.approx(180e-6)              # 120 .. 300
    assert idle["bench.call"] == pytest.approx((10 + 90) * 1e-6)   # 0 .. 10, 310 .. 400
    assert idle["(gaps under 10 us)"] == pytest.approx(1e-6)       # 305 .. 306
    assert sum(idle.values()) == pytest.approx(red["window_s"] - red["busy_s"])


@pytest.mark.parametrize("name,group", [
    ("void sw_block_kernel<256, 2>(SwParams)", "sw_block (K1)"),
    ("void sw_block_pair_kernel<512>(P)", "sw_block_pair (K4)"),
    ("void dense_mha_kernel<64>(MhaParams)", "dense_mha (K2/K6)"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16", "conv (cuDNN)"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNN", "gemm"),
    ("void at::native::vectorized_layer_norm_kernel<float>", "norm"),
    ("void at::native::elementwise_kernel<128, 4, copy_>", "copy/layout"),
    ("void at::native::vectorized_elementwise_kernel<4, silu>", "elementwise/other")])
def test_kernel_groups(name, group):
    assert devtrace.group_of(name) == group


def test_clip_plan_is_restore_videos():
    plan = traffic.clip_plan(240, 8, 1)
    assert len(plan) == 30 and all(n == 8 for _, n in plan)
    assert plan[0][0] == tuple(range(1, 9)) and plan[-1][0] == tuple(range(233, 240)) + (239,)
    # 17 frames at B=8: two full calls, then 0 left over owing r=1 output
    plan = traffic.clip_plan(17, 8, 1)
    assert [n for _, n in plan] == [8, 8, 1] and plan[-1][0] == (16,) * 8


def test_reservoirs_keep_their_kinds():
    res = traffic.Reservoirs({"first": 2, "last": 2, "any": 3}, seed=2 ** 40 + 3)
    for c in (traffic.calls({"batch": 8, "clip_frames": 240}, 1)):
        res.offer(c)
        if c.index == 299:
            break
    kept = res.kept
    assert all(i % 30 == 0 for i in kept["first"]) and len(kept["first"]) == 2
    assert all(i % 30 == 29 for i in kept["last"]) and len(kept["last"]) == 2
    assert len(kept["any"]) == 3
    again = traffic.Reservoirs({"first": 2, "last": 2, "any": 3}, seed=2 ** 40 + 3)
    for c in (traffic.calls({"batch": 8, "clip_frames": 240}, 1)):
        again.offer(c)
        if c.index == 299:
            break
    assert again.chosen() == res.chosen()


def test_percentile_and_rates():
    import importlib.util
    from pathlib import Path
    here = Path(__file__).resolve().parents[1] / "metrics"

    def load(name):
        spec = importlib.util.spec_from_file_location(name, here / f"{name}.py")
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        return m
    call = SimpleNamespace(n_valid=8)
    recs = [{"call": call, "t_submit": 0.0, "t_done": (i + 1) / 1000} for i in range(100)]
    run = SimpleNamespace(records=recs, seconds=4.0)
    assert load("chunk_latency_p95_ms").read(run) == pytest.approx(95.0)
    assert load("frames_per_s").read(run) == 200.0
    trace = {"window_s": 2.0, "busy_s": 1.5}
    assert load("device_idle_share").read(SimpleNamespace(trace=trace)) == pytest.approx(25.0)
    mfu = load("step_mfu").read(SimpleNamespace(trace=trace, flops_per_call=8 * 989e9,
                                                frames_per_call=8, traced_frames=1000))
    assert mfu == pytest.approx(100.0 * 989e9 * 1000 / 2.0 / 989e12)
    assert math.isclose(mfu, 50.0)
