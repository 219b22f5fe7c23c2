"""Experiment manager (port of qasr_tpu/utils/exp_manager.py, host only).

Creates exp_dir/name/version_N, writes the run's config and git state,
wires the log file, checkpoints every N steps with top-k retention plus a
'last' checkpoint (the JAX package's training-checkpoint layout,
``utils/checkpoint.py::save_training_ckpt``), and finds the checkpoint to
resume from (``check_resume``).  Metrics go to a JSONL stream, TensorBoard
event files (``tb_writer.py``) and, when asked, W&B (the ``wandb`` package
imported lazily; without it the same stream is recorded offline).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from qasr_tpu_torch.utils.logging import logging


@dataclass
class ExpManagerConfig:
    exp_dir: str = "qasr_experiments"
    name: str = "default"
    version: Optional[int] = None
    create_checkpoint_callback: bool = True
    checkpoint_every_n_steps: int = 1000
    keep_top_k: int = 3
    resume_if_exists: bool = False
    resume_ignore_no_checkpoint: bool = False
    # TensorBoard event files beside the JSONL stream (the in-tree tfevents
    # encoder; no tensorboard package needed)
    create_tensorboard_logger: bool = True
    # Weights & Biases: requires name / project in wandb_kwargs; uses the
    # wandb package when importable, else records the same stream to
    # <log_dir>/wandb_offline.jsonl
    create_wandb_logger: bool = False
    wandb_kwargs: Dict[str, Any] = field(default_factory=dict)


class _WandbLogger:
    """Thin W&B adapter.  When the wandb package is importable a real run is
    created under <log_dir>; otherwise the same (step, metrics) stream goes
    to <log_dir>/wandb_offline.jsonl so the hook is exercisable anywhere."""

    def __init__(self, log_dir: str, kwargs: Dict[str, Any]):
        self._run = None
        self._offline = None
        try:
            import wandb  # noqa: F401  (optional dependency)

            self._run = wandb.init(dir=log_dir, **kwargs)
            logging.info("WandbLogger has been set up")
        except ImportError:
            path = os.path.join(log_dir, "wandb_offline.jsonl")
            self._offline = open(path, "a")
            json.dump({"wandb_init": kwargs}, self._offline)
            self._offline.write("\n")
            self._offline.flush()
            logging.warning("wandb package not installed; recording the "
                            f"W&B stream offline to {path}", once=True)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._run is not None:
            self._run.log(dict(metrics), step=step)
        elif self._offline is not None:
            json.dump({"step": step, **{k: _scalar(v)
                                        for k, v in metrics.items()}},
                      self._offline)
            self._offline.write("\n")
            self._offline.flush()

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
        elif self._offline is not None:
            self._offline.close()
            self._offline = None


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class ExpManager:
    def __init__(self, cfg: ExpManagerConfig, run_config: Optional[Dict] = None):
        self.cfg = cfg
        base = os.path.join(cfg.exp_dir, cfg.name)
        if cfg.version is None:
            v = 0
            while os.path.exists(os.path.join(base, f"version_{v}")) and not cfg.resume_if_exists:
                v += 1
            if cfg.resume_if_exists and os.path.exists(base):
                versions = [int(d.split("_")[1]) for d in os.listdir(base)
                            if d.startswith("version_")]
                v = max(versions) if versions else 0
        else:
            v = cfg.version
        self.log_dir = os.path.join(base, f"version_{v}")
        self.ckpt_dir = os.path.join(self.log_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        logging.add_file_handler(os.path.join(self.log_dir, "qasr.log"))
        self._metrics = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        self.tb = None
        if cfg.create_tensorboard_logger:
            from qasr_tpu_torch.utils.tb_writer import TBWriter

            self.tb = TBWriter(self.log_dir)
        self.wandb = None
        if cfg.create_wandb_logger:
            kw = dict(cfg.wandb_kwargs or {})
            if "name" not in kw and "project" not in kw:
                raise ValueError("name and project are required for "
                                 "wandb_logger")
            self.wandb = _WandbLogger(self.log_dir, kw)
        self._ckpts: List[str] = []
        if run_config is not None:
            from qasr_tpu_torch.utils.yaml_io import safe_dump

            with open(os.path.join(self.log_dir, "run_config.yaml"), "w") as f:
                safe_dump(run_config, f)
        self._capture_git()
        logging.info(f"ExpManager: logging to {self.log_dir}")

    def _capture_git(self) -> None:
        # the commit the run was made from, where there is a git checkout
        try:
            sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                                 text=True, timeout=5).stdout.strip()
            if sha:
                with open(os.path.join(self.log_dir, "git-info.log"), "w") as f:
                    f.write(f"commit: {sha}\n")
        except Exception:
            pass

    # -- metrics ---------------------------------------------------------

    def log_metrics(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                try:
                    self.tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass  # non-scalar metric: JSONL only
        if self.wandb is not None:
            self.wandb.log(step, metrics)

    def close(self) -> None:
        """Flush + release the metric sinks (run end)."""
        if self.wandb is not None:
            self.wandb.finish()
        if self.tb is not None:
            self.tb.close()
        if not self._metrics.closed:
            self._metrics.close()

    # -- checkpoints -----------------------------------------------------

    def maybe_checkpoint(self, step: int, params, opt_state, qstate=None,
                         force: bool = False) -> Optional[str]:
        """Every checkpoint_every_n_steps (or ``force``): step_<n>.npz and
        last.npz of the host params, the optimizer's state (an
        ``OptaxOptimizer`` or its leaves) and the step."""
        if not self.cfg.create_checkpoint_callback:
            return None
        if not force and (step == 0 or step % self.cfg.checkpoint_every_n_steps):
            return None
        from qasr_tpu_torch.utils.checkpoint import save_training_ckpt

        path = os.path.join(self.ckpt_dir, f"step_{step}.npz")
        save_training_ckpt(path, params, opt_state, step, qstate)
        self._ckpts.append(path)
        while len(self._ckpts) > self.cfg.keep_top_k:
            old = self._ckpts.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass
        last = os.path.join(self.ckpt_dir, "last.npz")
        save_training_ckpt(last, params, opt_state, step, qstate)
        logging.info(f"checkpoint saved: {path}")
        return path

    def check_resume(self) -> Optional[str]:
        """The 'last' checkpoint to resume from, if any."""
        last = os.path.join(self.ckpt_dir, "last.npz")
        if os.path.exists(last):
            return last
        if self.cfg.resume_if_exists and not self.cfg.resume_ignore_no_checkpoint:
            raise FileNotFoundError(
                f"resume_if_exists set but no checkpoint under {self.ckpt_dir}")
        return None
