"""``python -m lightgbm_tpu_torch``: the command line entry point
(reference ``src/main.cpp``)."""
import sys

from .application import main

sys.exit(main())
