"""Meta-training loop, port of ``e_osvos_tpu/engine/meta_trainer.py``.

A host loop around ``parallel.MetaStep``: sample a batch of tasks on the
host (``meta_optim.MetaTaskset``), run the meta step on the device, log,
checkpoint every ``vis_interval`` iterations, and call an optional
evaluation hook every ``eval_interval``, keeping the best-scoring
meta-parameters.

CUDA launches are asynchronous, so the loop is pipelined one deep: after
iteration k is issued, its losses are queued for copy to pinned host memory
behind it, the host samples iteration k+1's tasks while the card still runs
k, issues k+1, and only then waits for k's losses (an event recorded after
k's copy, so it does not wait for k+1). Logged, evaluated and final
iterations are fetched at once, so every logged value is exact for its own
iteration.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from e_osvos_torch.meta_optim import (
    MetaOptimConfig,
    MetaParams,
    init_meta_params,
    lr_per_tensor,
    lr_stats,
)
from e_osvos_torch.meta_optim.tasksets import MetaTaskset
from e_osvos_torch.parallel import (
    MetaStepConfig,
    MetaStepOut,
    OuterOptimConfig,
    TaskFns,
    make_meta_step,
)
from e_osvos_torch.utils import (
    MetricsLogger,
    Timer,
    load_checkpoint,
    resolve_device,
    save_checkpoint,
)
from e_osvos_torch.utils.device import to_host


@dataclasses.dataclass
class MetaTrainConfig:
    """Top-level meta-training settings. ``profile_iters`` ``(start,
    stop)`` traces meta-iterations [start, stop) with ``torch.profiler``
    into a Chrome trace under ``profile_dir``. ``increase_seed_per_meta_run``
    reseeds the task sampler with ``seed + iteration`` before each
    iteration."""

    meta_batch_size: int = 4
    num_meta_iters: int = 1000
    vis_interval: int = 10
    eval_interval: int = 0  # 0 = no interleaved evaluation
    save_dir: Optional[str] = None
    seed: int = 1
    profile_iters: Optional[Tuple[int, int]] = None
    profile_dir: str = "profile"
    increase_seed_per_meta_run: bool = True


def _losses_to_host(out: MetaStepOut):
    """The step's meta-loss and per-task losses queued for copy to the
    host: ``(host tensor, event to wait on or None)``."""
    return to_host(torch.cat([out.meta_loss.reshape(1).float(),
                              out.per_task_loss.float()]))


class MetaTrainer:
    """Host-side loop of meta-training on one device.

    ``model_apply`` is the functional model (``models.functional_apply``);
    ``init_params`` the model (its parameters and frozen-BN buffers become
    the learned init) or a parameter dict. ``task_fns`` picks the task
    family (``parallel.detection_task_fns`` for Mask R-CNN; the dense
    family by default)."""

    def __init__(self, model_apply: Callable, init_params: Any,
                 taskset: MetaTaskset,
                 meta_cfg: MetaOptimConfig = MetaOptimConfig(),
                 step_cfg: MetaStepConfig = MetaStepConfig(),
                 outer_cfg: OuterOptimConfig = OuterOptimConfig(),
                 train_cfg: MetaTrainConfig = MetaTrainConfig(),
                 logger: Optional[MetricsLogger] = None,
                 eval_fn: Optional[Callable[[MetaParams, int], Dict]] = None,
                 device=None, task_fns: Optional[TaskFns] = None):
        self.device = resolve_device(device)
        self.taskset = taskset
        self.train_cfg = train_cfg
        self.logger = logger or MetricsLogger(
            path=(f"{train_cfg.save_dir}/metrics.jsonl"
                  if train_cfg.save_dir else None))
        self.eval_fn = eval_fn
        mp = init_meta_params(meta_cfg, init_params)
        self.meta_params = MetaParams(*(
            None if d is None else {k: v.to(self.device) for k, v in d.items()}
            for d in mp))
        self.step = make_meta_step(model_apply, meta_cfg, step_cfg, outer_cfg,
                                   train_cfg.meta_batch_size,
                                   device=self.device, task_fns=task_fns)
        self.opt_state = self.step.init(self.meta_params)
        self.meta_iter = 0
        self.best_eval = -float("inf")
        self.timer = Timer()

    # -- checkpointing ------------------------------------------------------

    def _state(self) -> Dict[str, Any]:
        return {"meta_params": self.meta_params._asdict(),
                "opt_state": self.opt_state.state_dict()}

    def save(self, name: str = "last_meta_iter") -> Optional[str]:
        if not self.train_cfg.save_dir:
            return None
        return save_checkpoint(
            f"{self.train_cfg.save_dir}/{name}.ckpt", self._state(),
            metadata={"meta_iter": self.meta_iter,
                      "best_eval": self.best_eval})

    @torch.no_grad()
    def restore(self, path: str) -> None:
        """Load a checkpoint into the current meta-parameters (in place, so
        the outer optimizer keeps them) and the optimizer's state."""
        state, meta = load_checkpoint(path, map_location=self.device)
        for field, saved in state["meta_params"].items():
            current = getattr(self.meta_params, field)
            if (current is None) != (saved is None) or (
                    current is not None and set(current) != set(saved)):
                raise ValueError(f"checkpoint {path}: {field} does not match "
                                 "this trainer's meta-parameters")
            for k, v in (current or {}).items():
                v.copy_(saved[k])
        self.opt_state.load_state_dict(state["opt_state"])
        if meta:
            self.meta_iter = int(meta.get("meta_iter", 0))
            self.best_eval = float(meta.get("best_eval", -float("inf")))

    # -- training loop ------------------------------------------------------

    def _profile(self, prof):
        """Start or stop the ``torch.profiler`` trace at the configured
        iterations; returns the active profiler or None."""
        cfg = self.train_cfg
        if cfg.profile_iters is None:
            return prof
        start, stop = cfg.profile_iters
        if prof is None and self.meta_iter == start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        elif prof is not None and self.meta_iter == stop:
            self._stop_profile(prof, start)
            prof = None
        return prof

    def _stop_profile(self, prof, start: int) -> None:
        prof.stop()
        os.makedirs(self.train_cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.train_cfg.profile_dir,
            f"meta_iters_{start}_{self.meta_iter}.json"))

    def run(self, num_iters: Optional[int] = None) -> Dict[str, Any]:
        """Run ``num_iters`` meta-iterations (default ``num_meta_iters``);
        returns the last fetched iteration's metrics."""
        cfg = self.train_cfg
        n = num_iters if num_iters is not None else cfg.num_meta_iters
        last: Dict[str, Any] = {}
        pending = None  # (host losses, event, sample seconds, issue time)
        prof = None

        def finalize(p) -> Dict[str, Any]:
            host, event, sample_s, t0 = p
            if event is not None:
                event.synchronize()
            vals = host.tolist()
            # issue→fetch wall time; pipelined, it spans the next
            # iteration's sampling too (exact on fetched-at-once iterations)
            return {"meta_loss": vals[0], "per_task_loss": vals[1:],
                    "sample_s": sample_s,
                    "step_s": time.perf_counter() - t0}

        for _ in range(n):
            prof = self._profile(prof)
            self.timer.start("sample")
            if cfg.increase_seed_per_meta_run:
                self.taskset.rng.seed(cfg.seed + self.meta_iter)
            batch = self.taskset.sample_batch(cfg.meta_batch_size)
            t_sample = self.timer.stop("sample")

            t0 = time.perf_counter()
            out = self.step(self.meta_params, self.opt_state, batch)
            self.meta_iter += 1
            fetch = (*_losses_to_host(out), t_sample, t0)
            if pending is not None:
                last = finalize(pending)
            pending = fetch

            log_now = (self.meta_iter % cfg.vis_interval == 0
                       or self.meta_iter == 1)
            eval_now = bool(self.eval_fn is not None and cfg.eval_interval
                            and self.meta_iter % cfg.eval_interval == 0)
            if log_now or eval_now:
                last = finalize(pending)
                pending = None
            if log_now:
                use_log = self.step.meta_cfg.use_log_init_lr
                stats = lr_stats(self.meta_params.log_init_lr, use_log)
                last["lr_mean"] = float(stats["mean"])
                last["lr_std"] = float(stats["std"])
                last["lr_per_tensor"] = lr_per_tensor(
                    self.meta_params.log_init_lr, use_log)
                self.logger.log("meta_train", step=self.meta_iter, **last)
                self.save("last_meta_iter")
            if eval_now:
                ev = self.eval_fn(self.meta_params, self.meta_iter)
                self.logger.log("eval", step=self.meta_iter, **ev)
                score = ev.get("J_mean", -float("inf"))
                if score > self.best_eval:
                    self.best_eval = score
                    self.save("best_meta_iter")
        if pending is not None:
            last = finalize(pending)
        if prof is not None:
            self._stop_profile(prof, cfg.profile_iters[0])
        return last
