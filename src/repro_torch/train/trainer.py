"""The training loop: the train step + the data stream + checkpointing +
straggler monitoring + crash/restart recovery.

``Trainer.run`` restores from the last atomic checkpoint (or starts fresh)
and resumes the data stream at the checkpoint's ``data_step``; after a
``SimulatedFailure`` it restarts from the last checkpoint, up to
``max_restarts`` times.  With ``mesh=`` (a ``DeviceMesh``) the train state is
laid out on the mesh (``launch.specs.train_state_specs``) and a checkpoint is
restored onto those placements.  Failure injection runs inside the timed region, so
an injected slow step shows in the step's wall time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, make_batch
from repro_torch.ft import FailureInjector, SimulatedFailure, StragglerMonitor
from repro_torch.kernels import runtime
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig, abstract_train_state, distribute_train_state, \
    init_train_state, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    batch_override: Optional[int] = None
    seq_override: Optional[int] = None
    max_restarts: int = 3


class Trainer:
    def __init__(self, model: Model, shape, opt_cfg: AdamWConfig, tcfg: TrainConfig = TrainConfig(),
                 rcfg: TrainerConfig = TrainerConfig(), dcfg: DataConfig = DataConfig(),
                 injector: Optional[FailureInjector] = None, log_fn: Callable[[str], None] = print,
                 device=None, mesh=None):
        self.model, self.shape = model, shape
        self.opt_cfg, self.tcfg, self.rcfg, self.dcfg = opt_cfg, tcfg, rcfg, dcfg
        self.injector = injector
        self.log = log_fn
        self.device = runtime.resolve_device(device)
        self.mesh = mesh
        self.monitor = StragglerMonitor()
        self.ckpt = Checkpointer(rcfg.ckpt_dir, keep=rcfg.ckpt_keep) if rcfg.ckpt_dir else None
        self.step_fn = make_train_step(model, opt_cfg, tcfg, mesh=mesh)
        self.history: list[dict] = []

    # -------------------------------------------------------------- state --
    def fresh_state(self, seed: int = 0) -> dict:
        """Weights drawn on the trainer's device from ``torch.Generator(device).manual_seed(seed)``
        (every rank draws the whole state and keeps its shards)."""
        state = init_train_state(self.model, seed, self.opt_cfg, self.tcfg, self.device)
        if self.mesh is not None:
            state = distribute_train_state(state, self.model, self.opt_cfg, self.tcfg, self.mesh)
        return state

    def _restore_or_fresh(self):
        if self.ckpt is not None:
            self.ckpt.wait()  # a save still in flight when a step failed is the one to restore
            if self.ckpt.latest_step() is not None:
                like = abstract_train_state(self.model, self.opt_cfg, self.tcfg)
                shardings = None
                if self.mesh is not None:
                    from repro_torch.launch.specs import as_placements, train_state_specs

                    shardings = as_placements(self.mesh, train_state_specs(self.model, self.mesh, self.opt_cfg,
                                                                            self.tcfg))
                state, extra = self.ckpt.restore(None, like, device=self.device, shardings=shardings)
                start = int(extra.get("data_step", int(state["step"])))
                self.log(f"[trainer] restored checkpoint at step {start}")
                return state, start
        return self.fresh_state(), 0

    # ---------------------------------------------------------------- run --
    def run(self) -> dict:
        restarts = 0
        while True:
            try:
                return self._run_once()
            except SimulatedFailure as e:
                restarts += 1
                self.log(f"[trainer] {e}; restart {restarts}/{self.rcfg.max_restarts}")
                if restarts > self.rcfg.max_restarts:
                    raise

    def _run_once(self) -> dict:
        state, start = self._restore_or_fresh()
        r = self.rcfg
        losses = []
        t_total0 = time.time()
        for step in range(start, r.steps):
            batch = make_batch(self.model.cfg, self.shape, step, self.dcfg,
                               batch_override=r.batch_override, seq_override=r.seq_override)
            t0 = time.time()
            if self.injector is not None:
                self.injector.maybe_fail(step)  # inside the timed region:
                # a simulated slow device shows up in the step wall time
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["total_loss"])  # waits for the step
            dt = time.time() - t0
            straggler = self.monitor.record(step, dt)
            losses.append(loss)
            self.history.append({"step": step, "loss": loss, "dt": dt, "straggler": straggler})
            if straggler:
                self.log(f"[trainer] step {step} straggler: {dt:.3f}s vs ewma {self.monitor.ewma:.3f}s")
            if r.log_every and step % r.log_every == 0:
                self.log(f"[trainer] step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)"
                         f" grad_norm {float(metrics['grad_norm']):.3f}")
            if self.ckpt is not None and (step + 1) % r.ckpt_every == 0:
                self.ckpt.save(step + 1, state, extra={"data_step": step + 1})
        if self.ckpt is not None:
            self.ckpt.save(r.steps, state, extra={"data_step": r.steps})
            self.ckpt.wait()
        return {
            "state": state,
            "losses": losses,
            "wall": time.time() - t_total0,
            "stragglers": list(self.monitor.flagged),
        }
