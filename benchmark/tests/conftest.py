"""The benchmark's own tests: the harness's modules importable by name, as
``run.py`` makes them, and small CPU geometries of both configurations."""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

# a few threads a test process: the CPU runs of a cell finish calls within
# their short windows also where several test processes share the cores
torch.set_num_threads(min(4, torch.get_num_threads()))

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# small geometries with as many codes a frame as the published ones hold
# in proportion: PGTFormer as the port's own CPU tests run it (32x32
# frames, T=3, a 16x16 latent); CodeFormer at 128x128 (a 16x16 latent, as
# at 512) with its block tables relabelled
SMALL_PGT_DD = dict(z_channels=32, resolution=32, ch=32, ch_mult=[1, 2], depths=[2, 2],
                    num_heads=[4, 4], window_sizes=[[4, 4], [4, 4]], attn_resolutions=[16])
SMALL_PGT = dict(embed_dim=32, n_embed=64, latent_shape=[16, 16, 32], code_shape=[16, 16, 1],
                 dim_embd=64, n_head=4, n_layers=2, connect_list=["16", "32"])
SMALL_CF = dict(dim_embd=32, n_head=4, n_layers=2, codebook_size=64, latent_size=256,
                connect_list=["32", "64", "128"], img_size=128, nf=32, ch_mult=[1, 2, 2, 4],
                res_blocks=1, attn_resolutions=[16], emb_dim=32,
                FUSE_ENCODER_BLOCK={"128": 1, "64": 3, "32": 5, "16": 8},
                FUSE_GENERATOR_BLOCK={"16": 5, "32": 7, "64": 9, "128": 11},
                CHANNELS={"16": 128, "32": 64, "64": 64, "128": 32})


def small_spec(workload: str, **traffic_overrides):
    """The cell's spec (harness.load_spec) at the small geometry, with a
    short traffic: clips of 11 frames, 4 frames a call."""
    import harness
    spec = harness.load_spec(workload)
    spec = copy.deepcopy(spec)
    model = spec.config["model"]
    if spec.config["driver"] == "pgt_video":
        model["ddconfig"].update(SMALL_PGT_DD)
        model.update(SMALL_PGT)
        spec.traffic.update(clip_frames=11)
    else:
        spec.config["model"] = dict(SMALL_CF)
        spec.traffic.update(pool=16)
        gain = {k: v for k, v in spec.config["weights"]["gain"].items() if "generator" not in k}
        gain["generator.blocks.13.weight"] = 0.5        # the small generator's output conv
        spec.config["weights"]["gain"] = gain
    spec.traffic.update(batch=4, warmup_calls=2, trace_first_call=3, trace_calls=3,
                        **traffic_overrides)
    return spec


@pytest.fixture
def bench_json():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)
