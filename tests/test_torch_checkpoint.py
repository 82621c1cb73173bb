"""Checkpoints, exports, pretrained merges, logging and validation of the
port's training run, at the small test geometry on the CPU.

- save/restore loads into the trainer's live modules, optimizers and
  schedulers: after a restore the next step equals the step an
  uninterrupted trainer takes, bit for bit (fp32);
- `merge_pretrained` of a stage-I export into a stage-II student loads the
  same tensors as the JAX package's (keys mapped by
  `convert.flax_path_to_torch_key`);
- `make_val_fn`'s PSNR within 1e-3 dB and SSIM within 1e-5 of the JAX
  package's on weights converted from the same JAX variables.
"""

import dataclasses
import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pgtformer_tpu_torch.convert import flax_path_to_torch_key, flax_to_state_dict, load_checkpoint, load_into
from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
from pgtformer_tpu_torch.train import stages as P
from pgtformer_tpu_torch.utils.checkpoint import (
    CheckpointManager, generator_export, merge_pretrained, read_export)
from tests.test_torch_common import (  # noqa: F401
    SMALL_DISC, one_torch_thread, random_variables, small_configs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _stage1(seed: int = 0, restarts: bool = True):
    _, tc = small_configs()
    cfg = dataclasses.replace(tc.vqvae, restart_unused_codes=restarts)
    hp = dataclasses.replace(P.STAGE_HYPERS["I"], warmup_iter=2, milestones=(3,), lr_g=1e-3,
                             lr_d=1e-3)
    tr = P.Stage1Trainer(cfg, hp, device="cpu", disc=VQGANDiscriminator(**SMALL_DISC))
    return tr, tr.init_state(torch.Generator().manual_seed(seed))


def _batches(n: int):
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (2, 3, 32, 32, 3), dtype=np.uint8) for _ in range(n)]


def _snapshot(tr, state):
    """Every tensor of a training state, cloned, by name."""
    out = {f"g.{k}": v.detach().clone() for k, v in tr.model.state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in state.g.ema_params.items()})
    out.update({f"d.{k}": v.detach().clone() for k, v in tr.disc.state_dict().items()})
    for name, opt in (("opt_g", tr.opt_g), ("opt_d", tr.opt_d)):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v.clone() for k, v in st.items()})
        out[f"{name}.lr"] = torch.tensor([g["lr"] for g in opt.param_groups], dtype=torch.float64)
    out["sched"] = torch.tensor([tr.sched_g.last_epoch, tr.sched_d.last_epoch])
    out["rng"] = state.rng.get_state()
    return out


def test_restore_loads_in_place_and_the_next_step_is_exact(tmp_path):
    """Two steps, save, one more step (the reference); a second trainer from
    another seed restores the save and takes the same step: every tensor of
    the state equal, bit for bit, and the state's dicts and the optimizers
    still hold the modules' own tensors."""
    batches = _batches(3)
    tr, state = _stage1(0)
    step = tr.make_step()
    for b in batches[:2]:
        state, _ = step(state, b)
    ck = CheckpointManager(str(tmp_path))
    pos = {"epoch": 0, "consumed": 2, "batches_per_epoch": 3, "batch_size": 2}
    path, nbytes = ck.save(state.step, state, tr, loader_position=pos)
    assert nbytes == os.path.getsize(path) > 0 and ck.latest_step() == 2
    state, m_ref = step(state, batches[2])
    ref = _snapshot(tr, state)

    tr2, state2 = _stage1(5)
    live = dict(tr2.model.named_parameters())
    restored, at = ck.restore(state2, tr2)
    assert restored is state2 and at == 2 and state2.step == 2
    assert ck.restored_loader_position == pos
    assert all(state2.g.params[n] is live[n] for n in state2.g.params)
    opt_params = [p for g in tr2.opt_g.param_groups for p in g["params"]]
    assert all(any(p is q for q in live.values()) for p in opt_params)
    state2, m = tr2.make_step()(state2, batches[2])
    got = _snapshot(tr2, state2)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m_ref.items()}


def test_gc_latest_and_exports(tmp_path):
    tr, state = _stage1(0)
    ck = CheckpointManager(str(tmp_path), max_to_keep=3)
    for s in range(1, 6):
        state.step = s
        ck.save(s, state, tr)
    assert sorted(os.listdir(tmp_path / "state")) == ["3.pth", "4.pth", "5.pth"]
    assert ck.latest_step() == 5 and not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    with torch.no_grad():
        for t in state.g.ema_params.values():
            t.add_(1.0)
    path, _ = ck.export_params_ema(5, generator_export(tr, state))
    sd = load_checkpoint(path)
    model = load_into(type(tr.model)(tr.cfg), sd)
    for n, p in model.named_parameters():
        want = state.g.ema_params.get(n, dict(tr.model.named_parameters())[n])
        assert torch.equal(p.detach(), want.detach()), n
    assert torch.equal(sd["quantizer.codebooks.0.weight"],
                       tr.model.state_dict()["quantizer.codebooks.0.weight"])
    assert read_export(path).keys() == sd.keys()


def test_read_export_refuses_an_orbax_directory(tmp_path):
    with pytest.raises(ValueError, match="flax_to_state_dict"):
        read_export(str(tmp_path))


def test_merge_pretrained_matches_jax():
    """A stage-I export (EMA params + codebook) merged into a stage-II
    student: the same tensors loaded and skipped as by the JAX package."""
    from pgtformer_tpu.models.pgtformer import PGTFormer as JaxPGTFormer
    from pgtformer_tpu.models.vae import TDCRQVAE3 as JaxTDCRQVAE3
    from pgtformer_tpu.utils.checkpoint import merge_pretrained as jmerge
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    jc, tc = small_configs()
    x = jnp.zeros((1, 3, 32, 32, 3), jnp.float32)
    t_vars = random_variables(JaxTDCRQVAE3(jc.vqvae), x, seed=3)
    s_vars = random_variables(JaxPGTFormer(jc), x, seed=4, w=1.0)
    export = {"params_ema": t_vars["params"], "codebook": t_vars["codebook"]}
    merged_j, n_j, skipped_j = jmerge(s_vars, export)

    from flax import traverse_util
    loaded_j = {flax_path_to_torch_key(col, k)
                for src_col, col in (("params_ema", "params"), ("codebook", "codebook"))
                for k in traverse_util.flatten_dict(dict(export[src_col]))
                if (col,) + k not in set(map(tuple, skipped_j))}
    student = PGTFormer(tc, generator=torch.Generator().manual_seed(0))
    pre = {k: torch.from_numpy(v) for k, v in flax_to_state_dict(
        {"params": t_vars["params"], "codebook": t_vars["codebook"]}).items()}
    merged, n, skipped = merge_pretrained(student.state_dict(), {"params_ema": pre})
    assert n == n_j == len(loaded_j) and len(skipped) == len(skipped_j)
    assert set(pre) - set(skipped) == loaded_j
    ref = flax_to_state_dict(merged_j)
    for k in loaded_j:
        np.testing.assert_array_equal(merged[k].numpy(), ref[k], err_msg=k)
    load_into(student, merged)


def test_tb_logger(tmp_path):
    from pgtformer_tpu_torch.utils.logging import TBLogger, get_root_logger
    TBLogger(None).scalars(1, {"a": 1.0})
    tb = TBLogger(str(tmp_path / "tb"))
    if tb.writer is None:
        pytest.skip("tensorboard is not installed: TBLogger is a no-op by design")
    tb.scalars(3, {"l_pix": 0.5, "name": "not a number"})
    tb.close()
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(tmp_path / "tb"))
    assert get_root_logger() is get_root_logger()


@pytest.fixture(scope="module")
def val_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    rng = np.random.default_rng(8)
    os.makedirs(root / "GT" / "clip_0")
    for i in range(3):
        cv2.imwrite(str(root / "GT" / "clip_0" / f"{i:08d}.png"),
                    rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    return str(root)


@pytest.mark.parametrize("stage", ["I", "III"])
def test_val_fn_matches_jax(val_tree, tmp_path, stage):
    """The EMA weights (here: equal to the converted JAX variables, with the
    live parameters moved away from them) through the port's make_val_fn
    against the JAX package's: PSNR within 1e-3 dB, SSIM within 1e-5, the
    same images saved; then the EMA moved, and the metrics move with it."""
    from pgtformer_tpu.data.vfhq import VFHQTestDataset as JaxTestDataset
    from pgtformer_tpu.models.pgtformer import PGTFormer as JaxPGTFormer
    from pgtformer_tpu.models.vae import TDCRQVAE3 as JaxTDCRQVAE3
    from pgtformer_tpu.train.validate import make_val_fn as jmake
    from pgtformer_tpu_torch.data.vfhq import VFHQTestDataset
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    from pgtformer_tpu_torch.train.validate import make_val_fn
    jc, tc = small_configs()
    x = jnp.zeros((1, 3, 32, 32, 3), jnp.float32)
    if stage == "I":
        jv = random_variables(JaxTDCRQVAE3(jc.vqvae), x, seed=6)
        jm = JaxTDCRQVAE3(jc.vqvae)
        tr = P.Stage1Trainer(tc.vqvae, device="cpu", disc=VQGANDiscriminator(**SMALL_DISC))
        state = tr.init_state(torch.Generator().manual_seed(0), flax_to_state_dict(jv))
    else:
        jv = random_variables(JaxPGTFormer(jc), x, seed=6, w=1.0)
        jm = JaxPGTFormer(jc)
        tr = P.PGTFormerTrainer(tc, "III", device="cpu", disc=VQGANDiscriminator(**SMALL_DISC))
        teacher = TDCRQVAE3(tc.vqvae, generator=torch.Generator().manual_seed(1)).state_dict()
        state = tr.init_state(torch.Generator().manual_seed(0), teacher, flax_to_state_dict(jv))
    # the live parameters drift from their EMA, as after training steps: a
    # validation that read them would leave the JAX package's numbers
    noise = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in state.g.params.values():
            p.add_(0.1 * torch.randn(p.shape, generator=noise))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    j_state = SimpleNamespace(g=SimpleNamespace(ema_params=jv["params"],
                                                codebook=jv.get("codebook"),
                                                batch_stats=jv.get("batch_stats")))
    val_fn = make_val_fn(tr, VFHQTestDataset(val_tree), stage, save_dir=str(tmp_path / "t"))
    ours = val_fn(state, 7)
    ref = jmake(SimpleNamespace(model=jm), JaxTestDataset(val_tree), stage,
                save_dir=str(tmp_path / "j"))(j_state, 7)
    print(f"stage {stage}: port {ours}, JAX {ref}")
    assert ours.keys() == ref.keys() == {"psnr", "ssim"}
    assert abs(ours["psnr"] - ref["psnr"]) <= 1e-3
    assert abs(ours["ssim"] - ref["ssim"]) <= 1e-5
    names = sorted(os.listdir(tmp_path / "j" / "iter_7"))
    assert names == sorted(os.listdir(tmp_path / "t" / "iter_7")) and len(names) == 3
    for n in names:
        a = cv2.imread(str(tmp_path / "t" / "iter_7" / n)).astype(int)
        b = cv2.imread(str(tmp_path / "j" / "iter_7" / n)).astype(int)
        assert np.abs(a - b).max() <= 1, n
    # the training model was not touched: validation ran its own copy
    after = tr.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    # validation reads the EMA: moving it moves the metrics
    with torch.no_grad():
        for t in state.g.ema_params.values():
            t.add_(0.1 * torch.randn(t.shape, generator=noise))
    moved = val_fn(state, 8)
    print(f"stage {stage}: EMA moved: {moved}")
    assert abs(moved["psnr"] - ours["psnr"]) > 1e-2
