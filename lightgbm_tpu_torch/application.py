"""Config-file driven command line application.

The port of the JAX package's ``application.py`` (reference ``src/main.cpp``,
``src/application/application.cpp``): ``python -m lightgbm_tpu_torch
config=train.conf [key=value ...]`` with the tasks train, predict,
convert_model and refit (``config.h:29``), in the reference's ``key = value``
config-file grammar (``#`` comments), so the ``examples/*/train.conf`` files
run unchanged.  LightGBM's ``device_type`` picks the device: ``cpu`` the
CPU, and ``tpu`` (the default), ``cuda`` or ``gpu`` the CUDA card, which
raises ``NoCudaDeviceError`` when there is none.  ``python -m
lightgbm_tpu_torch obs-report [...]`` renders the perf journal
(``obs/report.py``).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import Config
from .engine import train as train_fn
from .utils.log import Log, LightGBMError


def parse_config_file(path: str) -> Dict[str, str]:
    """``key = value`` lines, ``#`` comments (reference ``Config::KV2Map`` /
    config-file loading, ``application.cpp:52-85``)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_argv(argv: List[str]) -> Dict[str, str]:
    """CLI ``key=value`` arguments; ``config=<file>`` pulls in a config file
    with CLI taking precedence (reference ``Application::Application``)."""
    cli: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            raise LightGBMError(f"unknown argument {arg!r}; expected key=value")
        k, v = arg.split("=", 1)
        cli[k.strip()] = v.strip()
    params: Dict[str, str] = {}
    if "config" in cli:
        params.update(parse_config_file(cli.pop("config")))
    params.update(cli)                       # CLI overrides the file
    return params


class Application:
    """Task dispatcher (reference ``Application::Run``)."""

    def __init__(self, params: Dict[str, str]):
        self.raw_params = dict(params)
        self.config = Config.from_params(params)
        # device_type: cpu, or the card for tpu/cuda/gpu
        self.device = "cpu" if self.config.device_type == "cpu" else None

    def run(self) -> None:
        task = self.config.task
        if task == "train":
            self.train()
        elif task == "predict":
            self.predict()
        elif task == "convert_model":
            self.convert_model()
        elif task == "refit":
            self.refit()
        else:
            raise LightGBMError(f"unknown task {task!r}")

    def _load_model(self) -> Booster:
        if not self.config.input_model:
            raise LightGBMError("no model: set input_model=<file>")
        return Booster(model_file=self.config.input_model, device=self.device)

    def _load_data(self):
        """The features and labels of ``data``."""
        from .io.loader import load_file
        if not self.config.data:
            raise LightGBMError("no data: set data=<file>")
        return load_file(self.config.data, self.config)[:2]

    # ------------------------------------------------------------------
    def train(self) -> None:
        cfg = self.config
        if not cfg.data:
            raise LightGBMError("no training data: set data=<file>")
        params = dict(self.raw_params)
        for key in ("task", "data", "valid", "valid_data", "valid_data_file",
                    "test", "test_data", "output_model", "input_model",
                    "output_result"):
            params.pop(key, None)
        train_set = Dataset(cfg.data, params=params, device=self.device)
        valid_sets = [Dataset(v, params=params, reference=train_set,
                              device=self.device) for v in cfg.valid]
        booster = train_fn(params, train_set,
                           num_boost_round=cfg.num_iterations,
                           valid_sets=valid_sets or None,
                           valid_names=[os.path.basename(v) for v in cfg.valid]
                           or None,
                           init_model=cfg.input_model or None,
                           verbose_eval=(cfg.metric_freq if cfg.verbosity >= 0
                                         else False),
                           device=self.device)
        booster.save_model(cfg.output_model)
        Log.info("Finished training; model saved to %s", cfg.output_model)

    def predict(self) -> None:
        cfg = self.config
        booster = self._load_model()
        X = self._load_data()[0]
        pred = booster.predict(
            X, raw_score=cfg.predict_raw_score,
            pred_leaf=cfg.predict_leaf_index,
            pred_contrib=cfg.predict_contrib,
            num_iteration=cfg.num_iteration_predict,
            start_iteration=cfg.start_iteration_predict,
            predict_disable_shape_check=cfg.predict_disable_shape_check)
        pred = np.atleast_1d(pred)
        with open(cfg.output_result, "w") as f:
            if pred.ndim == 1:
                f.write("\n".join(repr(float(v)) for v in pred) + "\n")
            else:
                for row in pred:
                    f.write("\t".join(repr(float(v)) for v in row) + "\n")
        Log.info("Finished prediction; results saved to %s", cfg.output_result)

    def convert_model(self) -> None:
        from .models.convert import model_to_cpp
        booster = self._load_model()
        with open(self.config.convert_model, "w") as f:
            f.write(model_to_cpp(booster._gbdt))
        Log.info("Finished converting model; code saved to %s",
                 self.config.convert_model)

    def refit(self) -> None:
        cfg = self.config
        booster = self._load_model()
        X, y = self._load_data()
        booster.refit(X, y, decay_rate=cfg.refit_decay_rate)
        booster.save_model(cfg.output_model)
        Log.info("Finished refit; model saved to %s", cfg.output_model)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "obs-report":
        # observability subcommand: render the perf journal + telemetry
        # snapshot (docs/OBSERVABILITY.md) — not a key=value task
        from .obs.report import main as obs_report_main
        return obs_report_main(argv[1:])
    if not argv:
        print("usage: python -m lightgbm_tpu_torch config=<file> "
              "[key=value ...]   (device_type=cpu for the CPU)\n"
              "       python -m lightgbm_tpu_torch obs-report "
              "[--format md|json] [--roofline] [--regressions [--gate]] "
              "[--health [--health-url HOST:PORT]]")
        return 1
    try:
        Application(parse_argv(argv)).run()
    except LightGBMError as e:
        Log.warning("error: %s", e)
        return 2
    return 0
