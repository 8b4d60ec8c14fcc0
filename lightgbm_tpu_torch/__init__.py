"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu for one NVIDIA
H100.

The same module layout and names as the JAX package, in PyTorch; the two
histogram kernels of the training path are hand-written CUDA for Hopper
(``ops/kernels``).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.  This package imports neither jax nor lightgbm_tpu.
"""
from .basic import Booster, Dataset
from .callback import early_stopping, print_evaluation, log_evaluation, \
    record_evaluation
from .config import Config
from .device import NoCudaDeviceError, NotPortedError
from .engine import train
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "Dataset", "Config", "train", "LightGBMError",
           "NoCudaDeviceError", "NotPortedError", "early_stopping",
           "print_evaluation", "log_evaluation", "record_evaluation",
           "__version__"]
