"""Trainer: the training loop with checkpoint/resume, periodic eval,
retention and metric logging, over make_train_step.

Counterpart of kfunca_tpu/models/trainer.py.  The loop is thin: the
numerics live in models/train.py and models/eval.py; the Trainer adds what
a real run needs around them:

  * exact resume: TokenDataset.batch_at(step) is stateless in the step
    index, the checkpoint carries (params, opt_state, step), and the flash
    attention backward uses no atomics, so a crash + resume replays the
    uninterrupted run and the resumed params are BITWISE identical to a
    never-crashed run's;
  * periodic checkpoints (`ckpt_every`) with retention (`keep` newest),
    written via utils/checkpoint (fp32 masters and moments round-trip
    exactly);
  * periodic eval (`eval_every`) through models/eval.evaluate on a held-out
    TokenDataset;
  * metrics from the step (loss, grad-norm, lr, step) handed to an optional
    `on_step` callback and collected in `history`.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

from ..runtime.backend import resolve_device
from ..utils import checkpoint as ckpt
from .data import TokenDataset
from .eval import evaluate
from .train import OptConfig, init_opt_state, make_train_step
from .transformer import TransformerConfig, init_params

_CKPT_RE = re.compile(r"^step_(\d+)\.npz$")


@dataclass
class TrainerConfig:
    out_dir: str
    total_steps: int
    ckpt_every: int = 0      # 0 = only the final checkpoint
    eval_every: int = 0      # 0 = never
    eval_batches: int = 8
    log_every: int = 50
    keep: int = 3            # newest checkpoints retained
    loss_chunk: int | None = None
    grad_accum: int = 1
    ignore_index: int | None = None


class Trainer:
    """Runs on `device` (default: the CUDA device; raises without one)."""

    def __init__(self, cfg: TransformerConfig, tc: TrainerConfig,
                 oc: OptConfig = OptConfig(), device=None):
        self.cfg = cfg
        self.tc = tc
        self.oc = oc
        self.device = resolve_device(device)
        os.makedirs(tc.out_dir, exist_ok=True)
        self._step_fn = make_train_step(
            cfg, oc, grad_accum=tc.grad_accum, loss_chunk=tc.loss_chunk,
            ignore_index=tc.ignore_index, with_metrics=True,
            device=self.device)

    # -- checkpoints -----------------------------------------------------
    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.tc.out_dir, f"step_{step:08d}.npz")

    def latest_checkpoint(self) -> tuple[str, int] | None:
        best = None
        for name in os.listdir(self.tc.out_dir):
            m = _CKPT_RE.match(name)
            if m:
                s = int(m.group(1))
                if best is None or s > best[1]:
                    best = (os.path.join(self.tc.out_dir, name), s)
        return best

    def _save(self, step: int, params, opt_state) -> None:
        ckpt.save(self._ckpt_path(step),
                  {"params": params, "opt": opt_state,
                   "step": np.int64(step)})
        self._retain()

    def _retain(self) -> None:
        found = sorted(
            (int(_CKPT_RE.match(n).group(1)), n)
            for n in os.listdir(self.tc.out_dir) if _CKPT_RE.match(n))
        for _s, name in found[: max(0, len(found) - self.tc.keep)]:
            os.remove(os.path.join(self.tc.out_dir, name))

    # -- the loop ----------------------------------------------------------
    def fit(self, dataset: TokenDataset, params=None, *, seed: int = 0,
            eval_dataset: TokenDataset | None = None, on_step=None) -> dict:
        """Train to tc.total_steps, resuming from the newest checkpoint in
        out_dir when one exists (the params argument is then only the
        structure to load into).  Params are updated in place by the step.
        Returns {"params", "opt_state", "step", "history", "evals"}."""
        tc = self.tc
        latest = self.latest_checkpoint()
        if params is None:
            params = init_params(seed, self.cfg, device=self.device)
        opt_state = init_opt_state(params, self.oc, device=self.device)
        if latest is not None:
            path, _ = latest
            like = {"params": params, "opt": opt_state, "step": np.int64(0)}
            tree = ckpt.load(path, like=like)
            params, opt_state = tree["params"], tree["opt"]
            step0 = int(tree["step"])
        else:
            step0 = 0

        history, evals = [], {}
        for step in range(step0, tc.total_steps):
            tokens, targets = dataset.batch_at(step)
            params, opt_state, metrics = self._step_fn(
                params, opt_state, tokens, targets)
            if on_step is not None or (
                    tc.log_every and (step + 1) % tc.log_every == 0):
                metrics = {k: float(v) for k, v in metrics.items()}
                if tc.log_every and (step + 1) % tc.log_every == 0:
                    history.append(metrics)
                if on_step is not None:
                    on_step(step + 1, metrics)
            if tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
                self._save(step + 1, params, opt_state)
            if (eval_dataset is not None and tc.eval_every
                    and (step + 1) % tc.eval_every == 0):
                evals[step + 1] = evaluate(
                    params, self.cfg,
                    (eval_dataset.batch_at(i) for i in range(tc.eval_batches)),
                    vocab_chunk=tc.loss_chunk or 4096,
                    ignore_index=tc.ignore_index, device=self.device)
        if tc.total_steps > step0:
            self._save(tc.total_steps, params, opt_state)
        return {"params": params, "opt_state": opt_state,
                "step": tc.total_steps, "history": history, "evals": evals}
