"""Entry adapter: single-image restoration through ``models/codeformer.py``.

``inference_codeformer.py``'s step on a batch of aligned 512x512 faces:
uint8 faces uploaded from pinned memory, normalized to [-1, 1] and rounded
to the served dtype, one ``CodeFormer`` forward at the fidelity weight w
with AdaIN, the output mapped back to uint8 on the device.

The check: each sampled call's uint8 faces against the plain float32
reference (``reference/codeformer.py:restore_faces``) on the same faces and
weights.
"""

from __future__ import annotations

import torch

import judge
import roofline
import traffic
from harness import Clock
from reference import layers as ref_layers
from reference.codeformer import CodeFormer as RefCodeFormer, restore_faces
from weights import make_state_dict


class System:
    radius = 0

    def __init__(self, config: dict, tr: dict, seed: int, device: torch.device):
        from pgtformer_tpu_torch.convert import load_into
        from pgtformer_tpu_torch.models.codeformer import CodeFormer
        self.config, self.tr, self.device = config, tr, device
        self.model_cfg = config["model"]
        self.dtype = getattr(torch, config["dtype"])
        clock = Clock()
        with torch.device("meta"):
            shapes = ref_layers.key_shapes(RefCodeFormer(self.model_cfg))
        self.sd = make_state_dict(shapes, 2 * seed, config["weights"], self.dtype, device)
        clock("weights")
        # a configuration may relabel the class's block tables (CodeFormer's
        # class attributes, as the published model names them)
        tables = {k: v for k, v in self.model_cfg.items() if k.isupper()}
        cls = type("CodeFormer", (CodeFormer,), tables) if tables else CodeFormer
        kwargs = {k: v for k, v in self.model_cfg.items() if not k.isupper()}
        model = cls(**kwargs, use_pallas=config["use_pallas"])
        load_into(model, self.sd)
        self.model = model.to(device=device, dtype=self.dtype).eval()
        self.w, self.adain = config["call"]["w"], config["call"]["adain"]
        clock("model")
        res = self.model_cfg["img_size"]
        self.frames = traffic.make_frames(2 * seed + 1, traffic.pool_size(tr), res, device)
        clock("frames")
        self.phases = clock.phases
        self.calls = 0
        self.launches0 = launches()

    def start_clip(self, call) -> None:
        pass

    @torch.inference_mode()
    def call(self, call):
        self.calls += 1
        faces = torch.from_numpy(self.frames[list(call.frames)])
        if self.device.type == "cuda":
            # from pinned memory the upload is enqueued without waiting for
            # the calls ahead of it, as VideoRestorer uploads
            faces = faces.pin_memory()
        x = faces.to(self.device, non_blocking=True)
        x = ((x.float() / 255.0 - 0.5) / 0.5).to(self.dtype)
        out = self.model(x, w=self.w, adain=self.adain)[0]
        return ((out.float().clamp(-1.0, 1.0) + 1.0) * 127.5).round().to(torch.uint8)

    def counters(self) -> dict:
        """Kernel launches a call, from the port's launch counters."""
        return {f"{name}_per_call": (n - self.launches0[name]) / max(1, self.calls)
                for name, n in launches().items()}

    def reference_work(self):
        """(operations, kernel shapes) of one call, from the reference's
        shapes on the meta device."""
        B, res = self.tr["batch"], self.model_cfg["img_size"]
        with torch.device("meta"):
            model = RefCodeFormer(self.model_cfg)
            x = torch.empty(B, res, res, 3)
            return roofline.reference_shapes(lambda: model(x, self.w, self.adain), ref_layers)

    def free(self) -> None:
        self.model = None

    def judge(self, samples, control: bool = False) -> list:
        """`samples`: (call, uint8 faces [B, H, W, 3]) of the sampled calls;
        the pool repeats, so one reference run serves each batch of it.  With
        `control`, the control's faces (the reference with its products in
        fp8) stand in for the program's."""
        reference = lambda dtype: judge.reference_model(RefCodeFormer, self.model_cfg, self.sd,
                                                        self.device, dtype)

        def make_step(model):
            def step(frames):
                x = torch.from_numpy(self.frames[list(frames)]).to(self.device)
                return restore_faces(model, x, self.w, self.adain).cpu().numpy()
            return step
        return judge.judge_outputs(reference, make_step, [call.frames for call, _ in samples],
                                   samples, self.config["correct"]["limits"], control)


def launches() -> dict:
    """The port's launch counter of the kernel this path runs."""
    from pgtformer_tpu_torch.ops.dense_mha import dense_mha_bnhd
    return {"dense_mha_bnhd": dense_mha_bnhd.launches}
