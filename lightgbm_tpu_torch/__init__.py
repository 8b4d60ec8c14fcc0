"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu for one NVIDIA
H100.

The same module layout and names as the JAX package, in PyTorch; the
histogram kernels of the training path are hand-written CUDA for Hopper
(``ops/kernels``).  Entry points (``train``, ``cv``, ``Booster``,
``Dataset.construct`` and the sklearn estimators ``LGBMRegressor``,
``LGBMClassifier``, ``LGBMRanker``), the serving artifact
(``serve.PredictorArtifact``) and the out-of-core engines (``stream``) run
on the CUDA card unless the caller passes ``device="cpu"``; the command
line (``python -m lightgbm_tpu_torch``)
reads ``device_type``.  This package imports neither jax nor lightgbm_tpu.
"""
from .basic import Booster, Dataset
from .callback import early_stopping, print_evaluation, log_evaluation, \
    record_evaluation, reset_parameter
from .config import Config
from .device import NoCudaDeviceError, NotPortedError
from .engine import CVBooster, cv, train
from .utils.log import LightGBMError, register_log_callback

__version__ = "0.1.0"

__all__ = ["Booster", "Dataset", "Config", "CVBooster", "cv", "train",
           "LightGBMError", "register_log_callback", "NoCudaDeviceError",
           "NotPortedError", "early_stopping", "print_evaluation",
           "log_evaluation", "record_evaluation", "reset_parameter",
           "__version__"]


def __getattr__(name):
    # the optional API surfaces load on first use, as in the JAX package
    if name in ("LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"):
        from . import sklearn as _sk
        return getattr(_sk, name)
    if name in ("serve", "PredictorArtifact", "Predictor", "MicroBatcher",
                "QueueSaturatedError"):
        from . import serve as _serve
        return _serve if name == "serve" else getattr(_serve, name)
    if name in ("DistLGBMClassifier", "DistLGBMRegressor"):
        from .parallel import estimators as _est
        return getattr(_est, name)
    if name == "parallel":
        from . import parallel as _parallel
        return _parallel
    if name == "stream":
        from . import stream as _stream
        return _stream
    if name.startswith("plot_") or name in ("create_tree_digraph", "plotting"):
        import importlib
        _pl = importlib.import_module(".plotting", __name__)
        return _pl if name == "plotting" else getattr(_pl, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
