"""Host-resident bin matrix + the streaming budget decision.

The port's copy of the JAX package's ``stream/host_matrix.py``.  The
budget model: with prefetch depth ``d``, at most ``d + 1`` row blocks are
device-resident at once (the block being consumed plus the in-flight
prefetches: the pipeline's ring of ``d + 1`` slots), so the block size is
chosen as

    block_rows = budget // ((prefetch + 1) * (bytes_per_row + 16))

rounded down to a 128-multiple, the 16 bytes being the per-row sidecar
that rides with each block.  ``STREAM_FAKE_DEVICE_BYTES`` (the port's name
for the JAX package's ``STREAM_FAKE_HBM_BYTES``) overrides the configured
budget, so CPU tests exercise real eviction and prefetch without a card.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

FAKE_DEVICE_ENV = "STREAM_FAKE_DEVICE_BYTES"

# floor on the auto-chosen block: blocks below this thrash launch
# overhead without saving meaningful device memory
MIN_BLOCK_ROWS = 128

# per-row device bytes riding alongside each bins block: gradients,
# hessians, row weights, leaf-index vector (4 x f32/i32).  Folded into the
# block-size math so the STREAMED residency — not just the bins — stays
# under the budget (for wide rows this is noise; for narrow ones it is
# not)
SIDECAR_BYTES_PER_ROW = 16


class StreamPlan(NamedTuple):
    """Decision record of the out-of-core budget check."""
    block_rows: int          # rows per streamed block (128-multiple)
    num_blocks: int
    budget_bytes: int        # effective budget (0 = none configured)
    prefetch: int            # blocks in flight beyond the consumed one
    total_bytes: int         # full bin-matrix footprint
    reason: str              # 'stream_rows' | 'budget' — what triggered


def effective_budget_bytes(config) -> int:
    """Configured device budget for the bin matrix; the fake-cap env var
    (testing seam) wins over the config knob.  0 = unbudgeted;
    ``STREAM_FAKE_DEVICE_BYTES=0`` disables the seam and the config knob
    governs again (a 0->1-byte clamp here would silently force every run
    to the 128-row block floor)."""
    env = os.environ.get(FAKE_DEVICE_ENV, "").strip()
    if env and int(env) > 0:
        return int(env)
    return int(getattr(config, "max_bin_matrix_bytes", 0) or 0)


def plan_streaming(num_data: int, num_cols: int, itemsize: int,
                   config) -> Optional[StreamPlan]:
    """Decide whether (and how) training should stream; None = fits.

    The decision depends on the row count, so anything that must not
    depend on the data size (the EFB layout) gates on config alone, never
    on this plan.
    """
    if num_data <= 0 or num_cols <= 0:
        return None
    prefetch = max(1, int(getattr(config, "stream_prefetch", 2)))
    row_bytes = num_cols * itemsize
    total = num_data * row_bytes
    forced = int(getattr(config, "stream_rows", 0) or 0)
    budget = effective_budget_bytes(config)
    if forced:
        block = min(_floor128(forced), _ceil128(num_data))
        return StreamPlan(block_rows=block,
                          num_blocks=-(-num_data // block),
                          budget_bytes=budget, prefetch=prefetch,
                          total_bytes=total, reason="stream_rows")
    if not budget or total <= budget:
        return None
    # best-effort floor: a budget smaller than (prefetch+1) MIN_BLOCK_ROWS
    # rows cannot be honored (blocks below 128 rows thrash launches); the
    # plan still streams at the floor and the peak accounting reports the
    # true residency, so the overshoot is visible, not silent
    block = _floor128(budget // ((prefetch + 1)
                                 * (row_bytes + SIDECAR_BYTES_PER_ROW)))
    block = max(MIN_BLOCK_ROWS, block)
    block = min(block, _ceil128(num_data))
    return StreamPlan(block_rows=block, num_blocks=-(-num_data // block),
                      budget_bytes=budget, prefetch=prefetch,
                      total_bytes=total, reason="budget")


def _floor128(v: int) -> int:
    return max(MIN_BLOCK_ROWS, (v // 128) * 128)


def _ceil128(v: int) -> int:
    return -(-v // 128) * 128


class HostBinMatrix:
    """Row-block-chunked view of a host numpy bin matrix.

    Blocks are VIEWS into the backing array (no copy); the final partial
    block reports its true row count and the pipeline pads it to the
    uniform ``block_rows`` shape in its staging slot, so every block has
    one shape.
    """

    def __init__(self, bins: np.ndarray, block_rows: int) -> None:
        if bins.ndim != 2:
            raise ValueError("HostBinMatrix wants a [num_data, num_cols] "
                             f"matrix, got shape {bins.shape}")
        self.bins = bins
        self.block_rows = int(block_rows)
        if self.block_rows < 1:
            raise ValueError("block_rows must be >= 1")
        self.num_data, self.num_cols = bins.shape
        self.num_blocks = max(1, -(-self.num_data // self.block_rows))

    @property
    def block_nbytes(self) -> int:
        """Device footprint of ONE (padded) block."""
        return self.block_rows * self.num_cols * self.bins.dtype.itemsize

    def block_slice(self, i: int) -> slice:
        s = i * self.block_rows
        return slice(s, min(s + self.block_rows, self.num_data))

    def block(self, i: int) -> np.ndarray:
        """Host view of block ``i`` (unpadded)."""
        return self.bins[self.block_slice(i)]

    def block_rows_actual(self, i: int) -> int:
        sl = self.block_slice(i)
        return sl.stop - sl.start
