"""Serving and training across several processes (the port's
``parallel/``, ``VideoRestorer(group=)``, the trainers' and ``train_cli``'s
data parallelism), on the CPU over gloo, at the small test geometry, fp32.

- the sharded serving step at n=2 and n=4 ranks with B=4 (n=4: Bl=1 < 2r,
  the two-hop halo) restores frames bit-equal to one port process at
  ``batch_windows=B/n`` over the same frames (each rank runs exactly that
  process's batches), and within test_torch_pipeline.py's 1 LSB of the JAX
  package's unsharded restorer; ``restore_video`` across two ranks writes
  the one-process file;
- the codebook EMA update with restarts and the synced BatchNorm across two
  ranks against the JAX functions under ``shard_map`` on a 2-device mesh;
- one stage-I and one stage-III step across two ranks against one process
  at the global batch, under tests/test_train.py's tolerances (``l_pix``
  rtol 1e-4, parameters 5e-5, ``cluster_size_ema`` 1e-4), every trained
  tensor bit-equal across the ranks;
- ``train_cli --devices 2 --device cpu``: two steps, a resume to three, the
  same ``metrics.jsonl`` as ``--devices 1`` at the same global batch, one
  writer.

The ranks run functions of tests/torch_parallel_workers.py (no JAX) in
spawned processes, each torch on one thread, rendezvousing through a file
store in the tests' temporary directories; every run is bounded by a
timeout.  The runs across ranks start in background threads while the JAX
references compute.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jax.sharding import Mesh, PartitionSpec as PS

from pgtformer_tpu_torch import parallel as P
from pgtformer_tpu_torch.convert import flax_to_state_dict
from pgtformer_tpu_torch.pipeline import VideoRestorer
from tests import torch_parallel_workers as W
from tests.test_torch_common import (  # noqa: F401
    SMALL_DISC, one_torch_thread, random_variables, small_configs, small_pgt)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPAWN_TIMEOUT_S = 180.0
B = 4
N_CHUNKS = 3


@pytest.fixture(scope="module")
def clip():
    return np.random.default_rng(7).integers(0, 256, (1 + N_CHUNKS * B, 32, 32, 3),
                                             dtype=np.uint8)


def _one_process(sd, cfg, frames, batch):
    """prime + the frames in chunks of `batch` through one port process."""
    r = VideoRestorer(sd, cfg, w=1.0, batch_windows=batch, dtype=torch.float32, device="cpu")
    r.prime(frames[0])
    n = (len(frames) - 1) // batch
    return np.concatenate([r.restore_chunk(frames[1 + c * batch:1 + (c + 1) * batch]).numpy()
                           for c in range(n)])


@pytest.fixture(scope="module")
def jax_frames(small_pgt, clip):
    """The JAX package's unsharded restorer (B=4) over the clip."""
    from pgtformer_tpu.pipeline import VideoRestorer as JaxVideoRestorer
    _, v, _, _ = small_pgt
    jr = JaxVideoRestorer(v, small_configs()[0], w=1.0, batch_windows=B, dtype=jnp.float32,
                          io_backend="opencv")
    jr.prime(clip[0])
    return np.concatenate([np.asarray(jr.restore_chunk(clip[1 + c * B:1 + (c + 1) * B]))
                           for c in range(N_CHUNKS)])


def _write_clip(path, frames):
    import cv2
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    for f in frames:
        w.write(np.ascontiguousarray(f[..., ::-1]))
    w.release()


def _read_all(path):
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


# -- inputs of the two-rank run ---------------------------------------------------

def _codebook_case(n_vectors, n_embed=16, dim=8, seed=3):
    r = np.random.default_rng(seed)
    weight = r.normal(size=(n_embed + 1, dim)).astype(np.float32)
    weight[-1] = 0
    cluster = r.uniform(0, 2, n_embed).astype(np.float32)
    embed_ema = r.normal(size=(n_embed, dim)).astype(np.float32)
    vecs = r.normal(size=(n_vectors, dim)).astype(np.float32)
    idx = r.integers(0, n_embed // 2, n_vectors)        # half the codes unused
    return weight, cluster, embed_ema, vecs, idx


EMA_VECTORS = (40, 10)     # 20 / 5 vectors a rank against 16 codes: with and without noise

FAST_HP = dict(milestones=(100,), warmup_iter=-1, total_iter=100, gan_start_iter=-1)


def _batch(n=2, seed=1):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 256, (n, 3, 32, 32, 3), dtype=np.uint8)
    lq = np.clip(gt.astype(np.int16) + rng.integers(-12, 13, gt.shape), 0, 255).astype(np.uint8)
    return gt, lq


def _train_cases():
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    from pgtformer_tpu_torch.train.stages import STAGE_HYPERS
    _, tc = small_configs()
    gt, lq = _batch()
    teacher = {k: v.numpy() for k, v in
               TDCRQVAE3(tc.vqvae, generator=torch.Generator().manual_seed(7)).state_dict().items()}
    return {
        "I": dict(cfg=tc.vqvae, hp=dataclasses.replace(STAGE_HYPERS["I"], **FAST_HP),
                  disc=SMALL_DISC, batch=torch.from_numpy(gt)),
        "III": dict(cfg=tc, hp=dataclasses.replace(STAGE_HYPERS["III"], **FAST_HP),
                    disc=SMALL_DISC, teacher=teacher,
                    batch={"gt": torch.from_numpy(gt), "lq": torch.from_numpy(lq)}),
    }


@pytest.fixture(scope="module")
def bn_case():
    from pgtformer_tpu.models.vqgan import VQGANDiscriminator as JaxDisc
    x = np.random.default_rng(11).normal(size=(4, 32, 32, 3)).astype(np.float32)
    v = random_variables(JaxDisc(**SMALL_DISC), x, seed=9, train=False)
    return v, x


@pytest.fixture(scope="module")
def rank_runs(small_pgt, clip, bn_case, tmp_path_factory):
    """The runs across ranks, started in background threads as soon as the
    first test asks (the JAX references compute meanwhile): one two-rank
    group runs every two-rank check (serving: chunks, then restore_video of
    the clip as a file; the EMA update; the synced BatchNorm; a stage-I and
    a stage-III step), and four ranks serve the clip.  Each value is a
    future of the ranks' results."""
    from concurrent.futures import ThreadPoolExecutor
    _, v, _, _ = small_pgt
    root = tmp_path_factory.mktemp("ranks")
    src = str(root / "in.mp4")
    _write_clip(src, clip)
    bn_v, bn_x = bn_case
    serve = dict(state_dict=flax_to_state_dict(v), cfg=small_configs()[1], frames=clip, B=B)
    cases = {"serve": dict(serve, video=(src, str(root / "ranks.mp4"))),
             "ema": [_codebook_case(n) for n in EMA_VECTORS],
             "bn": (flax_to_state_dict(bn_v), bn_x, SMALL_DISC),
             **_train_cases()}
    for d in ("two", "four"):
        os.makedirs(root / d)
    with ThreadPoolExecutor(2) as pool:
        yield dict(
            cases=cases, root=root,
            two=pool.submit(P.spawn, W.two_ranks, 2, args=(cases,), timeout_s=SPAWN_TIMEOUT_S,
                            store_dir=str(root / "two")),
            four=pool.submit(P.spawn, W.serve, 4, args=(serve,), timeout_s=SPAWN_TIMEOUT_S,
                             store_dir=str(root / "four")))


# -- serving ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_sharded_serving_matches_one_process(rank_runs, n, small_pgt, clip, jax_frames):
    """Rank 0's gathered frames equal one port process at batch_windows=B/n
    bit for bit, and the JAX unsharded restorer's within 1 LSB."""
    _, v, _, _ = small_pgt
    sd, tc = flax_to_state_dict(v), small_configs()[1]
    ref = _one_process(sd, tc, clip, B // n)
    if n == 2:
        got = rank_runs["two"].result()[0]["serve"]["frames"]
    else:
        got = rank_runs["four"].result()[0]["frames"]
    assert got.shape == (N_CHUNKS * B, 32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got.astype(int) - jax_frames.astype(int)).max() <= 1


def test_sharded_restore_video_writes_the_one_process_file(small_pgt, rank_runs):
    """restore_video across two ranks (rank 0 reads and writes, rank 1
    follows every chunk) writes the file one process at B/2 writes."""
    results, cases, root = rank_runs["two"].result(), rank_runs["cases"], rank_runs["root"]
    assert results[0]["serve"]["video"]["frames"] == len(cases["serve"]["frames"])
    assert results[1]["serve"]["video"] == {"frames": 0, "steps": N_CHUNKS + 1}
    _, v, _, _ = small_pgt
    ref = VideoRestorer(flax_to_state_dict(v), small_configs()[1], w=1.0,
                        batch_windows=B // 2, dtype=torch.float32, device="cpu",
                        io_backend="opencv")
    ref.restore_video(cases["serve"]["video"][0], str(root / "one.mp4"))
    a, b = _read_all(str(root / "ranks.mp4")), _read_all(str(root / "one.mp4"))
    assert a.shape == b.shape == (1 + N_CHUNKS * B, 32, 32, 3)
    np.testing.assert_array_equal(a, b)


def test_sharded_restorer_refusals(small_pgt):
    """The JAX asserts (B % n == 0, B >= 2r) and a device other than the
    group's."""
    _, v, _, _ = small_pgt
    sd, tc = flax_to_state_dict(v), small_configs()[1]
    g = P.Group(rank=0, world=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="divide"):
        VideoRestorer(sd, tc, batch_windows=4, dtype=torch.float32, group=g)
    g = P.Group(rank=0, world=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="halo"):
        VideoRestorer(sd, tc, batch_windows=0, dtype=torch.float32, group=g)
    with pytest.raises(ValueError, match="group's"):
        VideoRestorer(sd, tc, batch_windows=4, dtype=torch.float32, device="meta", group=g)


# -- the EMA update and the synced BatchNorm against shard_map ------------------------

def _mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


@pytest.mark.parametrize("case", range(len(EMA_VECTORS)))
def test_ema_update_across_ranks_matches_jax_shard_map(case, rank_runs):
    """The JAX ema_codebook_update under shard_map on 2 devices against the
    port's across two ranks, restarts firing: every buffer equal on both
    ranks; the counts, and the used codes' sums and weights, within 1e-5 of
    JAX's; the same codes restarted, each from rank 0's vectors (JAX draws
    its permutation from jax.random, the port from torch, so the rows
    chosen differ)."""
    from pgtformer_tpu.models.quantizer import ema_codebook_update as jax_update
    cases = rank_runs["cases"]
    w, c, e, vecs, idx = cases["ema"][case]
    f = jax.shard_map(lambda *a: jax_update(*a, decay=0.9, restart_unused_codes=True,
                                        rng=jax.random.PRNGKey(0), axis_name="data"),
                  mesh=_mesh2(), in_specs=(PS(), PS(), PS(), PS("data"), PS("data")),
                  out_specs=(PS(), PS(), PS()), check_vma=False)
    jw, jc, je = (np.asarray(a) for a in f(*(jnp.asarray(a) for a in (w, c, e, vecs, idx))))
    results = rank_runs["two"].result()
    ours = results[0]["ema"][case]
    for a, b in zip(ours, results[1]["ema"][case]):
        np.testing.assert_array_equal(a, b)
    pw, pc, pe = ours
    np.testing.assert_allclose(pc, jc, rtol=1e-5, atol=1e-5)
    restarted = c * 0.9 + np.bincount(idx, minlength=len(c)) * 0.1 < 1.0
    assert restarted.any() and (~restarted).any()
    np.testing.assert_allclose(pe[~restarted], je[~restarted], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pw[:-1][~restarted], jw[:-1][~restarted], rtol=1e-5, atol=1e-5)
    rank0 = vecs[:len(vecs) // 2]
    for rows in (pe[restarted], je[restarted]):
        for row in rows:
            d = row[None, :] - rank0
            if len(rank0) >= len(c):
                assert np.any(np.all(d == 0, axis=1))
            else:
                assert np.any(np.all((d >= 0) & (d < 0.01 / np.sqrt(d.shape[1]) + 1e-6),
                                     axis=1))
    assert np.array_equal(pw[-1], np.zeros_like(pw[-1]))


def test_synced_batchnorm_matches_jax_shard_map(bn_case, rank_runs):
    """The discriminator in train mode across two ranks (each its half of
    the batch) against flax's BatchNorm with axis_name under shard_map:
    logits and running statistics within 1e-5; its gradients (averaged over
    the ranks) against one port process over the whole batch."""
    from pgtformer_tpu.models.vqgan import VQGANDiscriminator as JaxDisc
    from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
    v, x = bn_case
    jd = JaxDisc(**SMALL_DISC, axis_name="data")
    f = jax.shard_map(lambda p, bs, xx: jd.apply({"params": p, "batch_stats": bs}, xx, train=True,
                                             mutable=["batch_stats"]),
                  mesh=_mesh2(), in_specs=(PS(), PS(), PS("data")),
                  out_specs=(PS("data"), PS()), check_vma=False)
    logits, upd = f(v["params"], v["batch_stats"], jnp.asarray(x))
    results = rank_runs["two"].result()
    r0, r1 = results[0]["bn"], results[1]["bn"]
    ours = np.concatenate([r0["logits"], r1["logits"]])
    np.testing.assert_allclose(ours, np.asarray(logits), rtol=1e-5, atol=1e-5)
    ref_stats = flax_to_state_dict({"batch_stats": upd["batch_stats"]})
    assert set(ref_stats) == set(r0["stats"])
    for k, ref in ref_stats.items():
        np.testing.assert_array_equal(r0["stats"][k], r1["stats"][k])
        np.testing.assert_allclose(r0["stats"][k], ref, rtol=1e-5, atol=1e-6, err_msg=k)
    one = VQGANDiscriminator(**SMALL_DISC)
    one.load_state_dict({k: torch.from_numpy(a) for k, a in flax_to_state_dict(v).items()})
    one(torch.from_numpy(x), train=True).mean().backward()
    for n, p in one.named_parameters():
        np.testing.assert_array_equal(r0["grads"][n], r1["grads"][n])
        ref = p.grad.numpy()
        np.testing.assert_allclose(r0["grads"][n], ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=n)


# -- training steps -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["I", "III"])
def test_train_step_two_ranks_matches_one_process(kind, rank_runs):
    """One step across two ranks (one clip each) against one process over
    both clips: every trained tensor (parameters, EMA, codebook, BatchNorm
    statistics, Adam's moments) bit-equal across the ranks; l_pix within
    rtol 1e-4, the parameters within 5e-5 and cluster_size_ema within 1e-4
    of one process's, as tests/test_train.py holds the JAX mesh step."""
    c = rank_runs["cases"][kind]
    tr, state = W.build_trainer(kind, c["cfg"], c["hp"], c["disc"], c.get("teacher"),
                                device="cpu")
    state, metrics = tr.make_step()(state, c["batch"])
    results = rank_runs["two"].result()
    r0, r1 = results[0][kind], results[1][kind]
    assert r0["digest"] == r1["digest"]
    assert r0["metrics"] == r1["metrics"]
    np.testing.assert_allclose(r0["metrics"]["l_pix"], float(metrics["l_pix"]), rtol=1e-4)
    for k, v in metrics.items():
        np.testing.assert_allclose(r0["metrics"][k], float(v), rtol=1e-3, atol=1e-5, err_msg=k)
    diff = max(float(np.abs(r0["params"][n] - p.detach().numpy()).max())
               for n, p in state.g.params.items())
    print(f"stage {kind}: parameters at most {diff:.3e} from one process's")
    assert diff < 5e-5
    for n, t in (state.g.codebook or {}).items():
        if n.endswith("cluster_size_ema"):
            np.testing.assert_allclose(r0["codebook"][n], t.numpy(), atol=1e-4)


# -- train_cli --devices 2 ------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The seeded VFHQ tree and stage-I YAML of tests/test_torch_train_cli.py
    (batch 2, 3 batches an epoch) with the codebook restarts off, and a
    runner of train_cli.main.  A restart draws its rows from rank 0's
    vectors across ranks (the reference's DDP broadcast) and from the whole
    batch's in one process, so with restarts the runs part after the first
    step; test_train_step_two_ranks_matches_one_process holds a step with
    restarts."""
    import cv2
    import yaml
    from pgtformer_tpu_torch import train_cli as T
    from tests.test_torch_train_cli import tiny_options
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for c in range(2):
        d = root / "vfhq" / "GT" / f"clip_{c}"
        os.makedirs(d)
        for i in range(3):
            cv2.imwrite(str(d / f"{i:08d}.png"), rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    opt = tiny_options("I")
    opt["network_g"]["restart_unused_codes"] = False
    (root / "tiny_stage_I.yml").write_text(yaml.safe_dump(opt))

    def run(exp, *extra):
        return T.main(["-opt", str(root / "tiny_stage_I.yml"), "--data-root", str(root / "vfhq"),
                       "--exp-dir", str(root / "exp" / exp), "--device", "cpu", "--no-lpips",
                       *extra])
    return root, run


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_cli_two_ranks_on_the_cpu(cli_runs):
    """`--devices 2 --device cpu --batch-size 1` (global batch 2): two steps,
    then a resume to three, bit for bit the state of three steps in one run;
    one writer (one metrics line a step, one timings line a run, one state
    and export per save), the loader's position that of the global batch,
    and the losses of `--devices 1` (batch 2) at every step.  The three
    runs go side by side."""
    from concurrent.futures import ThreadPoolExecutor
    from tests.test_torch_train_cli import _state_tensors
    root, run = cli_runs
    two = ("--devices", "2", "--batch-size", "1")

    def resumed():
        return (run("two", *two, "--total-iter", "2"), run("two", *two, "--total-iter", "3"))

    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(resumed), pool.submit(run, "two_once", *two, "--total-iter", "3"),
                pool.submit(run, "one", "--total-iter", "3")]
        assert [j.result() for j in jobs] == [(0, 0), 0, 0]
    two, one = root / "exp" / "two", root / "exp" / "one"
    a = [r for r in _jsonl(two / "metrics.jsonl") if "it_per_s" in r]
    b = [r for r in _jsonl(one / "metrics.jsonl") if "it_per_s" in r]
    assert [r["step"] for r in a] == [r["step"] for r in b] == [1, 2, 3]
    for ra, rb in zip(a, b):
        assert set(ra) == set(rb)
        for k in ra:
            if k not in ("step", "it_per_s"):
                np.testing.assert_allclose(ra[k], rb[k], rtol=1e-3, atol=2e-5, err_msg=k)
    x, y = _state_tensors(two / "state" / "3.pth"), _state_tensors(root / "exp" / "two_once" /
                                                                   "state" / "3.pth")
    assert x.keys() == y.keys()
    for k in x:
        assert (torch.equal(x[k], y[k]) if isinstance(x[k], torch.Tensor) else x[k] == y[k]), k
    timings = _jsonl(two / "timings.jsonl")
    assert [(t["start_step"], t["end_step"]) for t in timings] == [(0, 2), (2, 3)]
    assert timings[1]["restore"]["loader"] == {"epoch": 0, "consumed": 2,
                                               "batches_per_epoch": 3, "batch_size": 2}
    assert sorted(os.listdir(two / "state")) == ["2.pth", "3.pth"]
    assert sorted(n for n in os.listdir(two) if n.endswith(".pth")) == [
        "net_d_2.pth", "net_d_3.pth", "net_g_2.pth", "net_g_3.pth"]
