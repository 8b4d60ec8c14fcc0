"""Typed configuration — the single flag mechanism shared by every layer.

A copy of the JAX package's ``config.py`` (same names, aliases and
``finalize`` checks, so one parameter dict drives both packages); the
hist-variant name list comes from the port's own ``ops/onehot_variants.py``.

Re-design of the reference's ``Config`` system
(``include/LightGBM/config.h:34``, parsing ``src/io/config.cpp:194``, generated
alias table ``src/io/config_auto.cpp:10``).  Same public parameter names and
aliases so reference param dicts / config files work unchanged; implementation
is a plain dataclass + explicit alias table instead of generated C++.

Differences from the reference, by design:
- ``device_type`` gains ``tpu`` (the default compute substrate) next to
  ``cpu``; ``gpu``/``cuda`` map to the same XLA path.
- Threading params are accepted-and-ignored (XLA owns parallelism).
- Histogram layout params (``force_col_wise``/``force_row_wise``) select the
  histogram kernel strategy instead of CPU loop order.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from .ops.onehot_variants import VARIANT_NAMES
from .utils.log import LightGBMError, Log, check

# ``hist_variant`` (one of VARIANT_NAMES, or auto) picks the one-hot body of
# the row-wise histogram kernels; it acts only under ``force_row_wise``, as
# in the JAX package, where the scatter method ignores it.  Every name runs
# there; ``auto`` elects one by timing the candidates on the card
# (ops/onehot_variants.pick_variant) and is ``base`` on the CPU.

# ---------------------------------------------------------------------------
# Alias table (reference: src/io/config_auto.cpp:10-168). Maps alias -> canonical.
# ---------------------------------------------------------------------------
PARAM_ALIASES: Dict[str, str] = {
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective", "app": "objective", "application": "objective",
    "loss": "objective",
    "boosting_type": "boosting", "boost": "boosting",
    "train": "data", "train_data": "data", "train_data_file": "data", "data_filename": "data",
    "test": "valid", "valid_data": "valid", "valid_data_file": "valid",
    "test_data": "valid", "test_data_file": "valid", "valid_filenames": "valid",
    "num_iteration": "num_iterations", "n_iter": "num_iterations",
    "num_tree": "num_iterations", "num_trees": "num_iterations",
    "num_round": "num_iterations", "num_rounds": "num_iterations",
    "nrounds": "num_iterations", "num_boost_round": "num_iterations",
    "n_estimators": "num_iterations", "max_iter": "num_iterations",
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "max_leaves": "num_leaves", "max_leaf": "num_leaves",
    "max_leaf_nodes": "num_leaves",
    "tree": "tree_learner", "tree_type": "tree_learner", "tree_learner_type": "tree_learner",
    "num_thread": "num_threads", "nthread": "num_threads", "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed", "random_state": "seed",
    "hist_pool_size": "histogram_pool_size",
    "min_data_per_leaf": "min_data_in_leaf", "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf", "min_samples_leaf": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf", "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction", "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction", "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction", "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode", "colsample_bynode": "feature_fraction_bynode",
    "early_stopping_rounds": "early_stopping_round", "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step", "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1", "l1_regularization": "lambda_l1",
    "reg_lambda": "lambda_l2", "lambda": "lambda_l2", "l2_regularization": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints", "monotone_constraint": "monotone_constraints",
    "monotone_constraining_method": "monotone_constraints_method", "mc_method": "monotone_constraints_method",
    "monotone_splits_penalty": "monotone_penalty", "ms_penalty": "monotone_penalty",
    "mc_penalty": "monotone_penalty",
    "feature_contrib": "feature_contri", "fc": "feature_contri", "fp": "feature_contri",
    "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename", "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename", "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "model_input": "input_model", "model_in": "input_model",
    "model_output": "output_model", "model_out": "output_model",
    "save_period": "snapshot_freq",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "data_seed": "data_random_seed",
    "is_sparse": "is_enable_sparse", "enable_sparse": "is_enable_sparse", "sparse": "is_enable_sparse",
    "is_enable_bundle": "enable_bundle", "bundle": "enable_bundle",
    "is_pre_partition": "pre_partition",
    "two_round_loading": "two_round", "use_two_round_loading": "two_round",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column", "group_id": "group_column", "query_column": "group_column",
    "query": "group_column", "query_id": "group_column",
    "ignore_feature": "ignore_column", "blacklist": "ignore_column",
    "cat_feature": "categorical_feature", "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "is_save_binary": "save_binary", "is_save_binary_file": "save_binary",
    "is_predict_raw_score": "predict_raw_score", "predict_rawscore": "predict_raw_score",
    "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index", "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib", "contrib": "predict_contrib",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance", "unbalanced_sets": "is_unbalance",
    "metric_types": "metric", "metrics": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric", "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at", "ndcg_at": "eval_at", "map_eval_at": "eval_at", "map_at": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port", "port": "local_listen_port",
    "machine_list_filename": "machine_list_file", "machine_list": "machine_list_file",
    "mlist": "machine_list_file",
    "workers": "machines", "nodes": "machines",
    "max_bins": "max_bin",
}

_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

TASK_TYPES = ("train", "predict", "convert_model", "refit")

# canonical serving bucket defaults (the serve subsystem and bench_serve
# source this ONE definition; retune here after hardware measurements)
SERVE_DEFAULT_BUCKETS = (1024, 16384, 262144)
BOOSTING_TYPES = ("gbdt", "rf", "dart", "goss")
TREE_LEARNER_TYPES = ("serial", "feature", "data", "voting")
DEVICE_TYPES = ("cpu", "gpu", "cuda", "tpu")


@dataclass
class Config:
    """Full training/prediction configuration (reference ``config.h:34``).

    Field defaults mirror the reference's documented defaults
    (``docs/Parameters.rst``); citations next to non-obvious ones.
    """

    # -- core (config.h:96-233) --
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0                      # accepted, ignored (XLA owns threads)
    device_type: str = "tpu"                  # reference default "cpu" (config.h:222)
    seed: int = 0
    deterministic: bool = False

    # -- learning control (config.h:235-580) --
    force_col_wise: bool = False
    force_row_wise: bool = False
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1                    # dart
    max_drop: int = 50                        # dart
    skip_drop: float = 0.5                    # dart
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2                     # goss
    other_rate: float = 0.1                   # goss
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20                           # voting parallel
    monotone_constraints: List[int] = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    path_smooth: float = 0.0
    interaction_constraints: List[List[int]] = field(default_factory=list)
    verbosity: int = 1
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    saved_feature_importance_type: int = 0
    snapshot_freq: int = -1

    # -- dataset (config.h:582-800) --
    linear_tree: bool = False
    linear_lambda: float = 0.0                # ridge reg for leaf linear models (config.h:383)
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: Union[str, List[int]] = ""
    forcedbins_filename: str = ""
    save_binary: bool = False
    precise_float_parser: bool = False

    # -- predict (config.h:802-900) --
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    output_result: str = "LightGBM_predict_result.txt"

    # -- convert (config.h:902-920) --
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # -- objective params (config.h:922-960) --
    objective_seed: int = 5
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)

    # -- metric (config.h:962-1010) --
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # -- network (config.h:1012-1040): TPU build uses jax.distributed, these
    #    select mesh shape / coordinator instead of a socket mesh. --
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_file: str = ""
    machines: str = ""

    # -- device/TPU (replaces gpu_platform_id/gpu_device_id, config.h:1042+) --
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    num_gpu: int = 1
    # TPU-specific knobs (new in this framework):
    hist_chunk_rows: int = 8192               # rows per one-hot matmul chunk
    # one-hot build strategy for the Pallas histogram kernels: 'auto' (a
    # one-time cached on-device micro-bench elects the fastest — the TPU
    # analog of the reference's col/row-wise histogram auto-tuner,
    # train_share_states.h) or a registry name from ops/onehot_variants.py
    # (base | bf16cmp | i16cmp | u8cmp | sub1abs | staged | packed | int8)
    hist_variant: str = "auto"
    # adaptive leaf compaction: gather the smaller sibling's rows into the
    # tightest power-of-4 capacity bucket before histogramming, so per-split
    # cost tracks leaf size (the TPU analog of the reference's per-leaf
    # DataPartition index ranges) instead of full-dataset masking
    hist_compact: bool = True
    hist_compact_min_cap: int = 8192          # smallest gather bucket
    # bucket growth factor (>= 1.2): 1.41 benched ~10% faster trees than 2
    # on v5e (half the round-up waste) for ~30% more compile time
    hist_compact_ladder: float = 1.41
    # round-batched best-first growth (ops/frontier.py): auto | serial |
    # frontier.  'auto' batches whenever the feature set is order-decoupled
    # (no monotone/CEGB/interaction/forced/extra-trees/per-node sampling)
    tree_grower: str = "auto"
    frontier_k: int = 16                      # leaves expanded per round
    frontier_block_rows: int = 512            # kernel rows/block (128-mult)
    mesh_shape: List[int] = field(default_factory=list)   # device mesh, [] = all devices on one axis
    pred_device: str = "auto"                 # auto | device | host ensemble predict
    # out-of-core training (lightgbm_tpu/stream, docs/STREAMING.md): when the
    # projected device footprint of the binned matrix exceeds this byte
    # budget, the Dataset stays host-resident and training streams
    # double-buffered row blocks through HBM.  0 = no budget (whole matrix
    # device-resident, the historical behavior); the STREAM_FAKE_HBM_BYTES
    # env var overrides it for CPU testing of the eviction/prefetch path
    max_bin_matrix_bytes: int = 0
    # force streaming with this row-block size (0 = decide by budget);
    # 128-multiple so blocks tile the TPU sublane grid
    stream_rows: int = 0
    # row blocks in flight on device (the consumed block + prefetched
    # ones); 2 = classic double buffering, the H2D copy of block k+1 hides
    # behind the histogram pass on block k
    stream_prefetch: int = 2
    # serving subsystem (lightgbm_tpu/serve, docs/SERVING.md): batch-shape
    # buckets the PredictorArtifact AOT-compiles (requests pad to the
    # nearest bucket; larger requests chunk by the biggest one)
    serve_buckets: List[int] = field(
        default_factory=lambda: list(SERVE_DEFAULT_BUCKETS))
    # micro-batcher: how long the first request of a batch waits for
    # company, and how many requests may queue before load is shed
    serve_batch_deadline_ms: float = 2.0
    serve_queue_depth: int = 64
    # serving SLO objectives tracked by the health plane as multi-window
    # burn rates (docs/OBSERVABILITY.md "Live health & forensics");
    # 0 = objective disabled
    serve_slo_p99_ms: float = 0.0
    serve_slo_error_rate: float = 0.0

    # -- observability (lightgbm_tpu/obs, docs/OBSERVABILITY.md) --
    # master switch for training-loop telemetry: per-iteration structured
    # events, phase-seconds metrics and tracer spans.  Off = zero cost
    # beyond one attribute check per iteration (the <2% overhead budget
    # is measured by scripts/bench_obs_overhead.py)
    obs_telemetry: bool = False
    # event-sink override; "" = the shared journal (WATCHER_PERF_LOG env
    # var, else the repo-root perf_results.jsonl)
    obs_events_path: str = ""
    # also wrap spans in jax.profiler Step/TraceAnnotation so host phases
    # align with XLA ops when a device trace capture is active
    obs_trace_device: bool = False
    # uniform-reservoir size of the rolling-percentile (p50/p99) histograms
    obs_reservoir_size: int = 512
    # live health plane (obs/health.py): serve /metrics (Prometheus text)
    # and /healthz (JSON) from a background thread on 127.0.0.1:<port>.
    # 0 = off; the LGBM_OBS_HEALTH_PORT env var (exported by the watcher
    # to its stages) enables it too
    obs_health_port: int = 0
    # numeric divergence sentinels: every this many boosting rounds sample
    # device-side isfinite/max-abs reductions over gradients, hessians and
    # leaf values, emit a numeric_health event and raise DivergenceError
    # on NaN/Inf.  Rides the async tree materialization — no extra device
    # sync on the healthy path.  0 = off
    obs_health_check_iters: int = 0

    # unknown keys seen during parsing (kept for model-file round trip)
    _unknown: Dict[str, Any] = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    @staticmethod
    def resolve_alias(name: str) -> str:
        return PARAM_ALIASES.get(name, name)

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]] = None, **kwargs) -> "Config":
        cfg = cls()
        cfg.update(dict(params or {}, **kwargs))
        cfg.finalize()
        return cfg

    def update(self, params: Dict[str, Any]) -> None:
        fields = {f.name for f in dataclasses.fields(self)}
        seen: Dict[str, str] = {}
        for raw_key, value in params.items():
            key = self.resolve_alias(str(raw_key))
            if key in seen and seen[key] != raw_key:
                Log.warning("%s is set with both %s and %s, using the latter", key, seen[key], raw_key)
            seen[key] = raw_key
            if key in fields and not key.startswith("_"):
                setattr(self, key, self._coerce(key, value))
            else:
                if key != "config":     # CLI pseudo-param, handled upstream
                    # reference logs every unrecognized key ("Unknown
                    # parameter", config.cpp) instead of dropping it
                    Log.warning("Unknown parameter: %s", key)
                self._unknown[key] = value

    def _coerce(self, key: str, value: Any) -> Any:
        cur = getattr(self, key)
        if key == "interaction_constraints":
            # nested-list grammar "[0,1,2],[2,3]" (reference config.h:614)
            if isinstance(value, str):
                import re
                return [[int(x) for x in grp.replace(",", " ").split()]
                        for grp in re.findall(r"\[([^\]]*)\]", value)]
            return [list(g) for g in value]
        if isinstance(cur, bool):
            if isinstance(value, str):
                return value.lower() in ("true", "1", "yes", "+", "on")
            return bool(value)
        if isinstance(cur, int) and not isinstance(value, bool):
            return int(value)
        if isinstance(cur, float):
            return float(value)
        if isinstance(cur, list):
            if isinstance(value, str):
                parts = [p for p in value.replace(",", " ").split() if p]
                out: List[Any] = []
                for p in parts:
                    try:
                        out.append(int(p))
                    except ValueError:
                        try:
                            out.append(float(p))
                        except ValueError:
                            out.append(p)
                return out
            if isinstance(value, (list, tuple)):
                return list(value)
            if isinstance(value, (set, frozenset)):
                # sets are legal param values (reference param_dict_to_str
                # accepts them); sort for a deterministic metric order
                return sorted(value, key=str)
            return [value]
        return value

    # ------------------------------------------------------------------
    def finalize(self) -> None:
        """Normalize enums + run conflict checks (reference
        ``Config::Set``/``CheckParamConflict``, ``src/io/config.cpp:194,255``)."""
        # verbosity drives the global logger exactly like the reference's
        # per-entry ResetLogLevel (c_api: <0 Fatal-only, 0 Warning,
        # 1 Info, >1 Debug)
        from .utils.log import LogLevel, reset_log_level
        reset_log_level(LogLevel.FATAL if self.verbosity < 0
                        else LogLevel.WARNING if self.verbosity == 0
                        else LogLevel.INFO if self.verbosity == 1
                        else LogLevel.DEBUG)
        self.objective = _OBJECTIVE_ALIASES.get(self.objective.lower(), self.objective.lower())
        self.boosting = {"gbrt": "gbdt", "random_forest": "rf"}.get(self.boosting.lower(), self.boosting.lower())
        self.tree_learner = {"serial_tree_learner": "serial", "feature_parallel": "feature",
                             "data_parallel": "data", "voting_parallel": "voting"}.get(
                                 self.tree_learner.lower(), self.tree_learner.lower())
        self.device_type = self.device_type.lower()
        self.task = {"training": "train", "prediction": "predict", "test": "predict",
                     "refit_tree": "refit"}.get(self.task.lower(), self.task.lower())

        self.monotone_constraints_method = self.monotone_constraints_method.lower()

        self.hist_variant = self.hist_variant.lower()
        if self.hist_variant not in ("auto",) + VARIANT_NAMES:
            raise LightGBMError(
                f"hist_variant must be auto or one of "
                f"{'/'.join(VARIANT_NAMES)}, got '{self.hist_variant}'")

        self.serve_buckets = sorted({int(b) for b in self.serve_buckets})
        if not self.serve_buckets or self.serve_buckets[0] < 1:
            raise LightGBMError(
                "serve_buckets must be a non-empty list of positive row "
                "counts")
        if self.serve_batch_deadline_ms < 0:
            raise LightGBMError("serve_batch_deadline_ms must be >= 0")
        if self.serve_queue_depth < 1:
            raise LightGBMError("serve_queue_depth must be >= 1")

        if self.obs_reservoir_size < 1:
            raise LightGBMError("obs_reservoir_size must be >= 1")
        if not 0 <= self.obs_health_port < 65536:
            raise LightGBMError("obs_health_port must be in [0, 65535]")
        if self.obs_health_check_iters < 0:
            raise LightGBMError("obs_health_check_iters must be >= 0")
        if self.serve_slo_p99_ms < 0:
            raise LightGBMError("serve_slo_p99_ms must be >= 0")
        if not 0 <= self.serve_slo_error_rate < 1:
            raise LightGBMError("serve_slo_error_rate must be in [0, 1)")

        if self.max_bin_matrix_bytes < 0:
            raise LightGBMError("max_bin_matrix_bytes must be >= 0")
        if self.stream_rows < 0 or (self.stream_rows
                                    and self.stream_rows % 128):
            raise LightGBMError(
                "stream_rows must be 0 (auto) or a 128-multiple >= 128 "
                "(row blocks tile the TPU sublane grid)")
        if self.stream_prefetch < 1:
            raise LightGBMError("stream_prefetch must be >= 1")

        self.tree_grower = self.tree_grower.lower()
        if self.tree_grower not in ("auto", "serial", "frontier"):
            raise LightGBMError(
                f"tree_grower must be auto/serial/frontier, got "
                f"'{self.tree_grower}'")
        if self.frontier_k < 1:
            raise LightGBMError("frontier_k must be >= 1")
        if self.frontier_block_rows < 128 or self.frontier_block_rows % 128:
            raise LightGBMError(
                "frontier_block_rows must be a 128-multiple >= 128 "
                "(the Pallas kernel's row-block tiling)")

        # (force_col_wise/force_row_wise conflict is checked below with the
        # other CheckParamConflict analogs)
        if self.num_machines > 1 or self.machines:
            Log.warning(
                "machines/num_machines configure multi-PROCESS training: "
                "bring the ranks up with parallel.set_network (machine "
                "list) or parallel.init_distributed, then train with "
                "parallel.train_distributed; a single process ignores "
                "these fields")
        if self.two_round:
            Log.info("two_round is ignored by design: ingest always streams "
                     "through the double-buffered PipelineReader")
        if self.is_enable_sparse is False:
            Log.info("is_enable_sparse is ignored: sparse input is handled "
                     "structurally (streamed block binning + EFB packing)")
        if self.histogram_pool_size >= 0:
            Log.info("histogram_pool_size is ignored: the dense device "
                     "histogram store has no LRU pool (HBM is the pool)")
        check(self.monotone_constraints_method in ("basic", "intermediate", "advanced"),
              f"unknown monotone_constraints_method: {self.monotone_constraints_method}")
        # 'advanced' extends the intermediate rect machinery: each new
        # child's bounds are re-derived from current rectangle
        # comparability over all active leaves (ops/grower.py apply_split
        # mono_adv), the TPU-design analog of the reference's
        # per-threshold AdvancedLeafConstraints
        # (monotone_constraints.hpp:230-375).
        check(self.boosting in BOOSTING_TYPES, f"unknown boosting type: {self.boosting}")
        check(self.tree_learner in TREE_LEARNER_TYPES, f"unknown tree learner: {self.tree_learner}")
        check(self.device_type in DEVICE_TYPES, f"unknown device type: {self.device_type}")
        check(self.num_leaves >= 2, "num_leaves must be >= 2")
        check(2 <= self.max_bin <= 65535, "max_bin must be in [2, 65535]")
        check(0.0 < self.bagging_fraction <= 1.0, "bagging_fraction must be in (0, 1]")
        check(0.0 < self.feature_fraction <= 1.0, "feature_fraction must be in (0, 1]")
        check(0.0 < self.feature_fraction_bynode <= 1.0, "feature_fraction_bynode must be in (0, 1]")
        check(self.learning_rate > 0.0, "learning_rate must be > 0")
        check(self.lambda_l1 >= 0 and self.lambda_l2 >= 0, "lambda_l1/l2 must be >= 0")
        check(self.top_rate + self.other_rate <= 1.0, "top_rate + other_rate must be <= 1.0")

        # objective-driven num_class consistency (config.cpp CheckParamConflict)
        if self.objective in ("multiclass", "multiclassova"):
            check(self.num_class >= 2, "num_class must be >= 2 for multiclass objectives")
        elif self.objective != "none":
            check(self.num_class == 1, f"num_class must be 1 for objective {self.objective}")
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            Log.fatal("Cannot set both is_unbalance and scale_pos_weight")
        # rf needs bagging (rf.hpp:35)
        if self.boosting == "rf":
            check(self.bagging_freq > 0 and self.bagging_fraction < 1.0,
                  "Random forest requires bagging_freq > 0 and bagging_fraction < 1.0")
        if self.boosting == "goss" and self.bagging_freq > 0:
            Log.warning("GOSS replaces bagging; bagging params are ignored")
            self.bagging_freq = 0
        if self.force_col_wise and self.force_row_wise:
            Log.fatal("Cannot set both force_col_wise and force_row_wise")
        if not self.metric:
            self.metric = [_default_metric_for(self.objective)]
        if self.max_depth > 0:
            # reference caps num_leaves at 2^max_depth (config.cpp:305)
            self.num_leaves = min(self.num_leaves, 1 << self.max_depth)

    # ------------------------------------------------------------------
    def to_dict(self, only_non_default: bool = False) -> Dict[str, Any]:
        default = Config()
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            if f.name.startswith("_"):
                continue
            v = getattr(self, f.name)
            if only_non_default and v == getattr(default, f.name):
                continue
            out[f.name] = v
        return out

    def num_class_per_iteration(self) -> int:
        return self.num_class if self.objective in ("multiclass", "multiclassova") else 1


def _default_metric_for(objective: str) -> str:
    return {
        "regression": "l2", "regression_l1": "l1", "huber": "huber", "fair": "fair",
        "poisson": "poisson", "quantile": "quantile", "mape": "mape", "gamma": "gamma",
        "tweedie": "tweedie", "binary": "binary_logloss", "multiclass": "multi_logloss",
        "multiclassova": "multi_logloss", "cross_entropy": "cross_entropy",
        "cross_entropy_lambda": "cross_entropy_lambda", "lambdarank": "ndcg",
        "rank_xendcg": "ndcg", "none": "custom",
    }.get(objective, "l2")


def parse_config_str(s: str) -> Dict[str, str]:
    """Parse ``key=value`` tokens (CLI args / param strings — reference
    ``Config::KV2Map``/``Str2Map``, ``config.cpp``)."""
    out: Dict[str, str] = {}
    for tok in s.replace("\n", " ").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_config_file(path: str) -> Dict[str, str]:
    """Parse a CLI config file: one ``key = value`` per line, ``#`` comments
    (reference ``application.cpp:52-85``)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out
