"""The training loop (BasicSR ``train.py -opt <yml>``; the port's
counterpart of the JAX package's ``train/trainer.py``).

Wires the batch iterator -> stage step -> logging -> periodic checkpoint and
EMA export -> validation, resuming from the newest checkpoint of the
experiment directory (reference conventions: ``print_freq`` 100,
``save_checkpoint_freq`` 1e4, ``val_freq``, ``auto_resume``, which the port
always does).

The metrics are read to the host only at ``print_freq`` and the step
counter is a host ``int``, so the loop does not wait on the card between
prints.  ``metrics.jsonl`` gets a line per print (``step``, ``it_per_s``,
the step's metrics, as the JAX package's) and per validation
(``val/<metric>``).  One difference: ``it_per_s`` counts training time only;
the clock stops while a checkpoint is written or validation runs.  The
time the loop waits for each batch, each checkpoint's seconds and bytes,
the restore's, and each validation's seconds and peak device memory go to
``timings.jsonl`` (one line per ``fit``) and to the log.

Under data parallelism (`group`) every rank runs the loop on its rows of
each batch and restores the same state; rank 0 alone writes the states,
exports, ``metrics.jsonl``, ``timings.jsonl``, TensorBoard and the
validation (its images and metrics, from the EMA weights every rank
holds), and the others wait for it at a barrier after each save and each
validation.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable, Iterator, Optional

import torch

from pgtformer_tpu_torch.parallel import group as P
from pgtformer_tpu_torch.utils.checkpoint import CheckpointManager, generator_export
from pgtformer_tpu_torch.utils.logging import TBLogger, get_root_logger


class Trainer:
    """`loader`, when given (``data/loader.py:PrefetchLoader``), is the
    source of `batches`: its position is saved with each checkpoint and, on
    resume, read back to start the loader where the saved run stood; its
    batch assembly times are reported.  `group`: the ranks of a
    data-parallel run (module docstring)."""

    def __init__(self, stage_trainer, exp_dir: str,
                 print_freq: int = 100,
                 save_checkpoint_freq: int = 10000,
                 val_freq: int = 20000,
                 use_tb_logger: bool = True,
                 loader=None, group: Optional[P.Group] = None):
        self.group = group if group is not None and group.world > 1 else None
        self.writes = self.group is None or self.group.rank == 0
        self.stage = stage_trainer
        self.exp_dir = exp_dir
        self.print_freq = print_freq
        self.save_freq = save_checkpoint_freq
        self.val_freq = val_freq
        self.logger = get_root_logger()
        self.tb = TBLogger(f"{exp_dir}/tb" if use_tb_logger and self.writes else None)
        self.ckpt = CheckpointManager(exp_dir)
        self.loader = loader

    def _export(self, step, state):
        """net_g export = EMA parameters + the buffers a consumer needs to
        run the model (codebooks, BatchNorm statistics); net_d export = the
        discriminator's state_dict, which the reference chains through the
        stages (stage III loads stage I's net_d, stage IV stage III's)."""
        self.ckpt.export_params_ema(step, generator_export(self.stage, state))
        if getattr(state, "d", None) is not None:
            self.ckpt.export_params_ema(step, self.stage.disc.state_dict(), prefix="net_d")

    def _save(self, step, state, timings):
        if self.writes:
            self._write(step, state, timings)
        if self.group is not None:
            P.barrier(self.group)

    def _write(self, step, state, timings):
        t0 = time.perf_counter()
        pos = self.loader.position_at(step) if self.loader is not None else None
        _, nbytes = self.ckpt.save(step, state, self.stage, loader_position=pos)
        t1 = time.perf_counter()
        self._export(step, state)
        t2 = time.perf_counter()
        timings["save"].append({"step": step, "bytes": nbytes, "seconds": t1 - t0,
                                "export_seconds": t2 - t1})
        self.logger.info(f"checkpoint saved at iter {step} ({nbytes} bytes in "
                         f"{t1 - t0:.2f} s, exports in {t2 - t1:.2f} s)")

    def _append_jsonl(self, rec: dict, name: str = "metrics.jsonl"):
        """Machine-readable training curve (exp_dir/metrics.jsonl)."""
        if not self.writes:
            return
        os.makedirs(self.exp_dir, exist_ok=True)
        with open(os.path.join(self.exp_dir, name), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _validate(self, val_fn, state, step, timings):
        if self.writes:
            self._run_val(val_fn, state, step, timings)
        if self.group is not None:
            P.barrier(self.group)

    def _run_val(self, val_fn, state, step, timings):
        cuda = self.stage.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.stage.device)
            torch.cuda.reset_peak_memory_stats(self.stage.device)
        t0 = time.perf_counter()
        val_metrics = val_fn(state, step)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(self.stage.device) if cuda else None
        timings["val"].append({"step": step, "seconds": dt, "peak_bytes": peak})
        self.logger.info(f"val @ {step}: " + "  ".join(
            f"{k}:{v:.4f}" for k, v in val_metrics.items()) + f"  ({dt:.2f} s)")
        self.tb.scalars(step, {f"val/{k}": v for k, v in val_metrics.items()})
        self._append_jsonl({"step": step,
                            **{f"val/{k}": round(float(v), 5)
                               for k, v in val_metrics.items()}})

    def fit(self, state, batches: Iterator[Any],
            total_iter: Optional[int] = None,
            val_fn: Optional[Callable[[Any, int], dict]] = None):
        total = total_iter or self.stage.hp.total_iter
        timings = {"restore": None, "save": [], "val": [], "data_wait_s": deque(maxlen=1000)}
        t0 = time.perf_counter()
        restored, step0 = self.ckpt.restore(state, self.stage)
        if restored is not None:
            state = restored
            dt = time.perf_counter() - t0
            nbytes = os.path.getsize(self.ckpt.state_path(step0))
            pos = self.ckpt.restored_loader_position
            timings["restore"] = {"step": step0, "bytes": nbytes, "seconds": dt,
                                  "loader": pos}
            self.logger.info(f"auto-resumed from step {step0} ({nbytes} bytes in "
                             f"{dt:.2f} s)")
            if self.loader is not None:
                # before `batches` draws its first batch from the loader
                if pos is None:
                    raise ValueError(f"the state of step {step0} holds no loader position")
                self.loader.seek(pos)
                self.logger.info(f"the loader starts at epoch {self.loader.epoch}, past "
                                 f"{self.loader.skip} of its {len(self.loader)} batches")
        start = step = state.step

        step_fn = self.stage.make_step()
        t0 = time.time()
        window_steps = 0
        it = iter(batches)
        while step < total:
            t_wait = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            timings["data_wait_s"].append(time.perf_counter() - t_wait)
            state, metrics = step_fn(state, batch)
            window_steps += 1
            step += 1

            if step % self.print_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                rate = window_steps / dt if dt > 0 else 0.0
                self.logger.info(
                    f"iter {step}/{total}  {rate:.2f} it/s  "
                    + "  ".join(f"{k}:{v:.4f}" for k, v in m.items()))
                self.tb.scalars(step, m)
                self._append_jsonl({"step": step, "it_per_s": round(rate, 3),
                                    **{k: round(v, 5) for k, v in m.items()}})
                t0 = time.time()
                window_steps = 0

            paused = time.time()
            if step % self.save_freq == 0:
                self._save(step, state, timings)
            if val_fn is not None and step % self.val_freq == 0:
                self._validate(val_fn, state, step, timings)
            t0 += time.time() - paused   # checkpoints and validation are not training time

        final = state.step
        if final % self.save_freq != 0:   # else the loop already saved it
            self._save(final, state, timings)
        self.tb.flush()
        rec = {"start_step": start, "end_step": final,
               **{k: (list(v) if isinstance(v, deque) else v) for k, v in timings.items()}}
        if self.loader is not None:
            rec["loader_load_s"] = list(self.loader.load_seconds)
        self._append_jsonl(rec, "timings.jsonl")
        return state


def epoch_repeat(make_iter: Callable[[], Iterator[Any]]) -> Iterator[Any]:
    """Endlessly cycle a re-creatable dataset iterator."""
    while True:
        yield from make_iter()
