"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu for one NVIDIA
H100.

The same module layout and names as the JAX package, in PyTorch; the
histogram kernels of the training path are hand-written CUDA for Hopper
(``ops/kernels``).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; the command line (``python -m lightgbm_tpu_torch``)
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
