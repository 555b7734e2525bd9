"""Command-line interface: ``fit`` / ``test`` / ``predict``.

    python -m py4cast_tpu_torch fit --config config/CLI/trainer.yaml \\
        --config config/CLI/dataset/dummy.yaml --config config/CLI/model/graphlam.yaml

The JAX package's CLI over the same ``config/CLI/*.yaml`` files: several
``--config file.yaml`` flags composed in order (trainer / dataset /
model), plus dotted-path overrides (``--model.learning_rate 1e-4`` or
``--data.batch_size=8``). One key more: ``--trainer.device`` (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels).

Cross-section links: ``data.num_input_steps``, ``data.num_pred_steps_*``
and ``data.batch_size`` flow into the training settings and trainer.
``test`` and ``predict`` rebuild the model from the checkpoint's
manifest and check the dataset against its contract.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
import yaml

from py4cast_tpu_torch.checkpoint import CheckpointManager, load_manifest
from py4cast_tpu_torch.datasets import get_datasets
from py4cast_tpu_torch.loggers import default_loggers
from py4cast_tpu_torch.training import (
    AutoRegressiveModule,
    Trainer,
    TrainerConfig,
    TrainingSettings,
    check_manifest_contract,
)
from py4cast_tpu_torch.utils import merge_dicts


@dataclasses.dataclass
class DataConfig:
    """The `data:` config section."""

    dataset_name: str = "dummy"
    dataset_conf: Optional[str] = None
    config_override: Optional[dict] = None
    num_input_steps: int = 2
    num_pred_steps_train: int = 1
    num_pred_steps_val_test: int = 1
    batch_size: int = 1
    num_workers: int = 2
    prefetch_factor: int = 2
    # inference options
    save_gifs: bool = False
    save_gribs: bool = False
    list_run_hour: Optional[List[int]] = None
    #: parameters of another port checkpoint injected into the restored state
    use_old_weights: Optional[str] = None

    def __post_init__(self):
        for key in ("save_gifs", "save_gribs"):
            if getattr(self, key):
                raise NotImplementedError(
                    f"data.{key}: the GIF/GRIB product export is not yet ported to "
                    "py4cast_tpu_torch (ROADMAP.md, queue 1 item 9); predictions "
                    "are saved as .npy"
                )


class DataModule:
    """Builds the train/valid/test datasets once."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.train_ds, self.val_ds, self.test_ds = get_datasets(
            cfg.dataset_name,
            cfg.num_input_steps,
            cfg.num_pred_steps_train,
            cfg.num_pred_steps_val_test,
            dataset_conf=cfg.dataset_conf,
            config_override=cfg.config_override,
        )

    @property
    def train_dataset_info(self):
        return self.train_ds.dataset_info

    @property
    def infer_ds(self):
        return self.test_ds


def _coerce(value: str):
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def _set_dotted(d: dict, dotted: str, value):
    keys = dotted.split(".")
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = value


def parse_cli(argv: List[str]) -> Tuple[str, dict]:
    """Parse `<subcommand> --config a.yaml [--config b.yaml ...] [--x.y v]`."""
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("usage: python -m py4cast_tpu_torch {fit,test,predict} --config FILE [...] "
              "[--section.key value] [--trainer.ckpt_path PATH]")
        sys.exit(0)
    subcommand = argv[0]
    if subcommand not in ("fit", "test", "predict"):
        raise SystemExit(f"Unknown subcommand {subcommand!r}; use fit/test/predict")

    conf: dict = {}
    i = 1
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"Unexpected argument {arg!r}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
            i += 1
        else:
            key = arg[2:]
            if i + 1 >= len(argv):
                raise SystemExit(f"Missing value for --{key}")
            value = argv[i + 1]
            i += 2
        if key == "config":
            with open(value) as f:
                conf = merge_dicts(conf, yaml.safe_load(f) or {})
        else:
            _set_dotted(conf, key, _coerce(value))
    return subcommand, conf


def _filter_fields(kls, d: dict) -> dict:
    known = {f.name for f in dataclasses.fields(kls)}
    unknown = set(d) - known
    if unknown:
        raise SystemExit(
            f"Unknown {kls.__name__} keys: {sorted(unknown)}; accepted: {sorted(known)}"
        )
    return d


def _load_ckpt_manifest(conf: dict) -> Optional[dict]:
    """The manifest.json written next to the run's checkpoints, resolved
    from trainer.ckpt_path / trainer.save_path (None when absent)."""
    trainer_conf = conf.get("trainer", {})
    ckpt_path = str(trainer_conf.get("ckpt_path", "last"))
    base = Path(str(trainer_conf.get("save_path", "runs/default"))) / "checkpoints"
    cand = base / ckpt_path
    target = cand if cand.exists() else Path(ckpt_path)
    try:
        return load_manifest(target)
    except FileNotFoundError:
        return None


def build_all(conf: dict, manifest: Optional[dict] = None):
    """Build datamodule + module + trainer from the composed config.

    With ``manifest`` (test/predict) the model is rebuilt from the
    checkpoint's stored training settings, not the current config, and
    the dataset is checked against the stored feature/stats contract."""
    data_cfg = DataConfig(**_filter_fields(DataConfig, conf.get("data", {})))
    dm = DataModule(data_cfg)

    if manifest is not None:
        model_conf = dict(manifest["training_settings"])
        # inference-time knobs stay overridable; everything structural
        # (model, strategy, steps, ...) comes from the checkpoint
        for key in ("io_conf", "num_samples_to_plot"):
            if key in conf.get("model", {}):
                model_conf[key] = conf["model"][key]
        check_manifest_contract(manifest, dm.train_dataset_info)
    else:
        model_conf = dict(conf.get("model", {}))
        model_conf.setdefault("num_input_steps", data_cfg.num_input_steps)
        model_conf.setdefault("num_pred_steps_train", data_cfg.num_pred_steps_train)
        model_conf.setdefault("num_pred_steps_val_test", data_cfg.num_pred_steps_val_test)
    if "betas" in model_conf:
        model_conf["betas"] = tuple(model_conf["betas"])
    settings = TrainingSettings(**_filter_fields(TrainingSettings, model_conf))

    trainer_conf = dict(conf.get("trainer", {}))
    ckpt_path = trainer_conf.pop("ckpt_path", None)
    trainer_conf.setdefault("batch_size", data_cfg.batch_size)
    trainer_conf.setdefault("num_workers", data_cfg.num_workers)
    tcfg = TrainerConfig(**_filter_fields(TrainerConfig, trainer_conf))

    module = AutoRegressiveModule(settings, dm.train_dataset_info, device=tcfg.device)
    trainer = Trainer(tcfg, loggers=default_loggers(Path(tcfg.save_path)))
    return dm, module, trainer, ckpt_path


def _restore_state(module: AutoRegressiveModule, trainer: Trainer, ckpt_path: str):
    state = module.init_state(torch.Generator().manual_seed(0), num_training_steps=1)
    ckpt = CheckpointManager(Path(trainer.config.save_path) / "checkpoints")
    return ckpt.restore(ckpt_path, state)


def main(argv: Optional[List[str]] = None) -> int:
    subcommand, conf = parse_cli(argv if argv is not None else sys.argv[1:])
    manifest = None
    if subcommand in ("test", "predict"):
        manifest = _load_ckpt_manifest(conf)
        if manifest is None:
            print(
                "WARNING: no manifest.json next to the checkpoint — "
                "rebuilding the model from the CURRENT config without a "
                "train/predict contract check"
            )
    dm, module, trainer, ckpt_path = build_all(conf, manifest=manifest)

    if subcommand == "fit":
        trainer.fit(module, dm.train_ds, dm.val_ds, ckpt_path=ckpt_path)
    elif subcommand == "test":
        if not ckpt_path:
            raise SystemExit("test requires --trainer.ckpt_path")
        state = _restore_state(module, trainer, ckpt_path)
        print(trainer.test(module, dm.test_ds, state))
    elif subcommand == "predict":
        if not ckpt_path:
            raise SystemExit("predict requires --trainer.ckpt_path")
        state = _restore_state(module, trainer, ckpt_path)
        if dm.cfg.use_old_weights:
            state = module.load_raw_params(state, dm.cfg.use_old_weights)
            print(f"Injected raw params from {dm.cfg.use_old_weights}")
        infer_ds = dm.infer_ds
        if dm.cfg.list_run_hour:
            # keep only samples whose run hour is requested
            hours = set(int(h) for h in dm.cfg.list_run_hour)
            try:
                infer_ds = infer_ds.filter_samples(
                    lambda s: s.timestamps.datetime.hour in hours
                )
            except ValueError:
                raise SystemExit(f"No samples with run hour in {sorted(hours)}")
        preds = trainer.predict(module, infer_ds, state)
        out_dir = Path(trainer.config.save_path) / "predictions"
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, p in enumerate(preds):
            np.save(out_dir / f"batch_{i}.npy", np.asarray(p.array))
        print(f"Saved {len(preds)} prediction batches to {out_dir}")
    for lg in trainer.loggers:
        lg.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
