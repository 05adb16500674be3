"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler watchdog, elastic re-mesh on restore.

Port of ``repro.train.loop``:

* every step runs under a deadline watchdog: a straggling step is logged
  and counted;
* an exception inside a step (``FloatingPointError``, ``RuntimeError`` or
  ``ValueError``; injected in tests through ``failure_hook``) rolls back to
  the latest checkpoint and resumes, up to ``max_restarts`` times; the data
  pipeline's step counter is restored from the checkpoint's extra dict, so
  the batch sequence is bit-identical;
* checkpoints use the reference's layout (``checkpoint.ckpt``), so a run can
  resume from the reference's checkpoints and the reverse;
* on a ``mesh`` (``launch.mesh``) every rank runs the loop on its rows of
  each batch and its blocks of the state; rank 0 alone writes a checkpoint
  of whole leaves (each gathered to rank 0's host from the ranks' blocks,
  one leaf at a time) and every rank restores its blocks on the *current*
  mesh (it reads each whole leaf on the host and copies in its block), so
  a run checkpointed on one mesh resumes on another of other ``data`` and
  ``model`` sizes (elastic re-mesh);
* the run keeps one ``TrainState``: a restore, or a restart with no
  checkpoint yet, copies into its tensors in place;
* on a CUDA device, without a mesh or on a mesh whose collectives are
  NCCL's, each step replays the whole step as a CUDA graph
  (``train.step.GraphedTrainStep``, captured once before the first step,
  on a mesh by every rank at once; a failed capture raises), as the
  reference always runs its jitted step; on a gloo mesh the step runs
  eagerly (gloo stages a CUDA tensor's collectives through host memory,
  which no graph captures), and on the CPU op by op.  Checkpoints are
  written outside the graph, between replays.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import SyntheticPipeline, device_batch
from repro_torch.distributed import sharding as shd
from repro_torch.models import model_zoo
from repro_torch.obs import instrument as obs
from repro_torch.train import step as train_step_mod

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    step_deadline_s: float = 120.0
    max_restarts: int = 3


def train(cfg: ModelConfig, rc: RunConfig, loop: LoopConfig, mesh=None,
          device="cuda", failure_hook: Optional[Callable[[int], None]] = None,
          log_every: int = 10) -> Dict[str, list]:
    """Run the loop on ``device`` (the card by default), on one device or on
    every rank of ``mesh``; returns the metric history: ``loss`` and
    ``step_time`` per step run (a rolled-back step counts each time it
    runs), ``stragglers`` and ``restarts``."""
    with shd.use_rules(train_step_mod.rules_for(rc, mesh)):
        return _run(cfg, rc, loop, mesh, device, failure_hook, log_every)


def _run(cfg, rc, loop, mesh, device, failure_hook, log_every):
    api = model_zoo.get_api(cfg, rc, device)
    writer = mesh is None or mesh.rank == 0
    # on a mesh every rank reads what rank 0 wrote: write synchronously
    mgr = CheckpointManager(loop.ckpt_dir, keep=loop.keep,
                            async_save=mesh is None)
    pipeline = SyntheticPipeline(cfg, rc)
    # one state for the whole run: every restore copies into its tensors
    state = train_step_mod.init_state(api, rc, 0, mesh)

    def save(state):
        if mesh is None:
            tree = train_step_mod.checkpoint_tree(state)
        else:
            tree = train_step_mod.whole_tree(state, api, rc, mesh)
        if writer:
            mgr.save(int(state.step), tree, extra=pipeline.state())
        if mesh is not None:
            dist.barrier()

    def restore_latest(fresh: bool) -> None:
        """The latest checkpoint into ``state``, in place; without one, a
        fresh state (unless ``state`` is one)."""
        step_num = mgr.latest_step()
        if step_num is None:
            if not fresh:
                train_step_mod.copy_state(
                    state, train_step_mod.init_state(api, rc, 0, mesh))
            return
        blocks = (None if mesh is None else
                  train_step_mod.checkpoint_blocks(api, rc, mesh))
        _, extra = mgr.restore(step_num, train_step_mod.checkpoint_tree(state),
                               blocks)
        pipeline.restore(extra)
        log.info("restored checkpoint at step %d", step_num)

    try:
        restore_latest(fresh=True)
        if (state.step.device.type == "cuda"
                and train_step_mod.graph_backend(mesh) is None):
            step_fn = train_step_mod.GraphedTrainStep(api, cfg, rc, state, mesh)
        else:
            step_fn = train_step_mod.make_train_step(api, cfg, rc, mesh)
        history: Dict[str, list] = {"loss": [], "step_time": [],
                                    "stragglers": 0, "restarts": 0}
        restarts = 0
        while int(state.step) < loop.total_steps:
            step_num = int(state.step)
            try:
                if failure_hook is not None:
                    failure_hook(step_num)
                batch_np = pipeline.next()
                batch = device_batch(batch_np, cfg, rc, device, mesh)
                t0 = time.monotonic()
                with obs.span("train/step", step=step_num, arch=cfg.name):
                    state, metrics = step_fn(state, batch)
                    loss = float(metrics["loss"])   # waits for the device
                dt = time.monotonic() - t0
                obs.hist_observe("train/step_ms", dt * 1e3, arch=cfg.name)
                obs.gauge_set("train/loss", loss, arch=cfg.name)
                obs.counter_inc("train/steps", 1, arch=cfg.name)
                obs.counter_inc("train/tokens",
                                int(np.prod(batch_np["tokens"].shape))
                                if "tokens" in batch_np else 0, arch=cfg.name)
                if dt > loop.step_deadline_s:
                    history["stragglers"] += 1
                    obs.counter_inc("train/stragglers", 1, arch=cfg.name)
                    log.warning("step %d exceeded deadline (%.1fs) — "
                                "straggler mitigation would re-dispatch",
                                step_num, dt)
                history["loss"].append(loss)
                history["step_time"].append(dt)
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step_num}")
                if log_every and step_num % log_every == 0:
                    log.info("step %d loss %.4f (%.2fs)", step_num, loss, dt)
                if (step_num + 1) % loop.ckpt_every == 0:
                    save(state)
            except (FloatingPointError, RuntimeError, ValueError) as e:
                restarts += 1
                history["restarts"] = restarts
                log.error("step %d failed (%s); restart %d/%d", step_num, e,
                          restarts, loop.max_restarts)
                if restarts > loop.max_restarts:
                    raise
                restore_latest(fresh=False)
        save(state)
        return history
    finally:
        mgr.close()
