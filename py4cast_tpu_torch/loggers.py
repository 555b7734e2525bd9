"""Experiment loggers: CSV always; TensorBoard and MLflow when installed.

The same three loggers as the JAX package, with the same degradation:
``default_loggers`` keeps CSV and drops a logger whose package is
missing. TensorBoard and MLflow are imported only when one is built.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Optional


class CSVLogger:
    def __init__(self, save_dir: Path, name: str = "metrics.csv"):
        self.path = Path(save_dir) / name
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", newline="")
        self._writer = csv.writer(self._fh)
        if self._fh.tell() == 0:
            self._writer.writerow(["time", "step", "tag", "value"])

    def log_scalar(self, tag: str, value: float, step: int):
        self._writer.writerow([f"{time.time():.3f}", step, tag, value])
        self._fh.flush()

    def log_figure(self, tag: str, fig, step: int):
        figdir = self.path.parent / "figures"
        figdir.mkdir(exist_ok=True)
        fig.savefig(figdir / f"{tag.replace('/', '_')}_{step}.png")

    def close(self):
        self._fh.close()


class TensorBoardLogger:
    """Thin wrapper over torch.utils.tensorboard (needs tensorboard)."""

    def __init__(self, save_dir: Path):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=str(save_dir))

    def log_scalar(self, tag: str, value: float, step: int):
        self.writer.add_scalar(tag, value, step)

    def log_figure(self, tag: str, fig, step: int):
        self.writer.add_figure(tag, fig, step)

    def close(self):
        self.writer.close()


class MLFlowLogger:
    """Optional MLflow scalar/figure logging (needs mlflow)."""

    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment: str = "py4cast_tpu_torch"):
        import mlflow

        self._mlflow = mlflow
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment)
        self._run = mlflow.start_run()

    def log_scalar(self, tag: str, value: float, step: int):
        self._mlflow.log_metric(tag.replace("/", "."), value, step=step)

    def log_figure(self, tag: str, fig, step: int):
        self._mlflow.log_figure(fig, f"figures/{tag.replace('/', '_')}_{step}.png")

    def log_artifacts(self, local_dir, artifact_path: str = "model"):
        self._mlflow.log_artifacts(str(local_dir), artifact_path=artifact_path)

    def close(self):
        self._mlflow.end_run()


def default_loggers(save_dir: Path, tensorboard: bool = True, mlflow: bool = False):
    loggers = [CSVLogger(save_dir)]
    if tensorboard:
        try:
            loggers.append(TensorBoardLogger(Path(save_dir) / "tb"))
        except ImportError:
            pass
    if mlflow:
        try:
            loggers.append(MLFlowLogger())
        except ImportError:
            pass
    return loggers
