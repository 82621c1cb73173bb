"""Entry adapter: video restoration through ``pipeline.py:VideoRestorer``.

The path ``cli.py`` runs, without the file: per clip ``reset`` and
``prime`` with the clip's first frame, then ``restore_chunk`` on B new
frames a call (its first call in a clip runs to its end), the tail of
per-frame features carried across the calls by the restorer.

The check: each sampled call's uint8 frames against the plain float32
reference's serving step (``reference/pgtformer.py:serve_chunk``) on the
same frames and weights, its left context worked out again from the clip.
"""

from __future__ import annotations

import torch

import judge
import roofline
import traffic
from harness import Clock
from reference import layers as ref_layers
from reference.pgtformer import PGTFormer as RefPGTFormer, chunk_context, serve_chunk
from weights import make_state_dict


class System:
    def __init__(self, config: dict, tr: dict, seed: int, device: torch.device):
        from pgtformer_tpu_torch.config import PGTFormerConfig
        from pgtformer_tpu_torch.pipeline import VideoRestorer
        self.config, self.tr, self.device = config, tr, device
        self.model_cfg = config["model"]
        self.dtype = getattr(torch, config["dtype"])
        clock = Clock()
        with torch.device("meta"):
            shapes = ref_layers.key_shapes(RefPGTFormer(self.model_cfg))
        self.sd = make_state_dict(shapes, 2 * seed, config["weights"], self.dtype, device)
        clock("weights")
        self.restorer = VideoRestorer(
            weights=self.sd, cfg=PGTFormerConfig.from_dict(self.model_cfg),
            w=config["call"]["w"], batch_windows=tr["batch"], dtype=self.dtype, device=device,
            inflight=tr["inflight"], use_pallas=config["use_pallas"])
        self.radius = self.restorer.radius
        clock("model")
        res = self.model_cfg["ddconfig"]["resolution"]
        self.frames = traffic.make_frames(2 * seed + 1, traffic.pool_size(tr), res, device)
        clock("frames")
        self.phases = clock.phases
        self.calls = 0
        self.launches0 = launches()

    def start_clip(self, call) -> None:
        self.restorer.reset()
        self.restorer.prime(self.frames[0])

    def call(self, call):
        self.calls += 1
        return self.restorer.restore_chunk(self.frames[list(call.frames)])

    def counters(self) -> dict:
        """Kernel launches a call, from the port's launch counters."""
        return {f"{name}_per_call": (n - self.launches0[name]) / max(1, self.calls)
                for name, n in launches().items()}

    def reference_work(self):
        """(operations, kernel shapes) of one call, from the reference's
        shapes on the meta device: B frames encoded, B windows restored."""
        B, r = self.tr["batch"], self.radius
        res = self.model_cfg["ddconfig"]["resolution"]
        w, use_adain = self.config["call"]["w"], self.model_cfg["adain"]
        with torch.device("meta"):
            model = RefPGTFormer(self.model_cfg)
            ctx = torch.empty(B + 2 * r, res, res, 3)
            feats = model.encode_frames(ctx)
            idx = torch.stack([torch.arange(i, i + 2 * r + 1) for i in range(B)])

        def run():
            model.encode_frames(ctx[:B])
            model.restore_windows([f[idx] for f in feats], w, use_adain)
        with torch.device("meta"):
            return roofline.reference_shapes(run, ref_layers)

    def free(self) -> None:
        self.restorer = None

    def judge(self, samples, control: bool = False) -> list:
        """`samples`: (call, uint8 frames [n_valid, H, W, 3]) of the sampled
        calls.  Every clip replays the same frames, so one reference run
        serves each chunk index.  With `control`, the control's frames (the
        reference with its products in fp8) stand in for the program's."""
        w, use_adain = self.config["call"]["w"], self.model_cfg["adain"]
        B, L = self.tr["batch"], self.tr["clip_frames"]
        reference = lambda dtype: judge.reference_model(RefPGTFormer, self.model_cfg, self.sd,
                                                        self.device, dtype)

        def make_step(model):
            def step(chunk):
                ctx = chunk_context(chunk, B, L, self.radius)
                x = torch.from_numpy(self.frames[ctx]).to(self.device)
                return serve_chunk(model, x, w, use_adain).cpu().numpy()
            return step
        return judge.judge_outputs(reference, make_step, [call.chunk for call, _ in samples],
                                   samples, self.config["correct"]["limits"], control)

def launches() -> dict:
    """The port's launch counters of the kernels this path runs."""
    from pgtformer_tpu_torch.ops.dense_mha import dense_mha_bnhd
    from pgtformer_tpu_torch.ops.sw_block import sw_block
    return {"sw_block": sw_block.launches, "dense_mha_bnhd": dense_mha_bnhd.launches}
