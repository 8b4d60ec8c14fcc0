"""Host->device row-block pipeline: a pinned staging ring and a copy stream.

Port of the JAX package's ``stream/pipeline.py``.  The consumer iterates
blocks; the pipeline keeps up to ``prefetch`` blocks in flight beyond the
one being consumed.  In place of the JAX package's ``jax.device_put``:

- a ring of ``prefetch + 1`` slots, each a pinned host staging buffer and
  a device buffer of one padded block (bins, then the per-row sidecar of
  at most four 4-byte extras: gradients, hessians, row weights, leaf ids),
  so the pinned memory is the ring, never the whole matrix;
- each block is copied into its slot's staging buffer on the host, then
  to the device by one copy on a dedicated CUDA stream, after which an
  event is recorded; the compute stream waits on that event before the
  consumer's kernels read the block;
- a slot is reused only after the compute that read it has finished: when
  the consumer moves on, an event is recorded on the compute stream, and
  the copy stream waits on it before it overwrites the slot's device
  buffer (the host waits for the slot's previous copy before it rewrites
  the staging buffer).  A reused buffer that a histogram kernel is still
  reading would give histograms that change from run to run.

On the CPU the slot's staging buffer is the block the consumer reads, and
everything runs in order.  Every block is padded to the uniform
``block_rows`` shape (pad rows ride weight 0, so they vanish from every
histogram and sum).  Transfer accounting (``PipelineStats``) mirrors the
JAX package's, and the ``stream.*`` counters mirror it process-wide.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..obs import costs as obs_costs
from ..obs import metrics as obs_metrics
from ..utils.log import check
from .host_matrix import SIDECAR_BYTES_PER_ROW, HostBinMatrix

# the extras a block carries: the sidecar's bytes of 4-byte values a row
MAX_EXTRAS = SIDECAR_BYTES_PER_ROW // 4


@dataclass
class PipelineStats:
    """Cumulative transfer accounting across passes (shared per trainer).

    ``events``: None, or a list that the pipeline fills with one
    ``(copy_start, copy_end, compute_start, compute_end)`` tuple of timing
    CUDA events a block (the copy on the copy stream, the consumer's work
    on the compute stream), for measuring how much copy time hides behind
    compute; off by default."""
    puts: int = 0                  # blocks copied to the device
    bytes_h2d: int = 0             # bytes moved host -> device
    peak_block_bytes: int = 0      # max bytes of blocks live at once
    passes: int = 0                # full sweeps over the matrix
    blocks_skipped: int = 0        # blocks never transferred (empty leaves)
    events: Optional[List[tuple]] = None

    def as_dict(self) -> dict:
        return dict(puts=self.puts, bytes_h2d=self.bytes_h2d,
                    peak_block_bytes=self.peak_block_bytes,
                    passes=self.passes, blocks_skipped=self.blocks_skipped)


class Block(NamedTuple):
    """One in-flight row block (views into its ring slot)."""
    index: int
    rows: int                # actual rows (<= block_rows; rest is padding)
    start: int               # global row offset of the block
    bins: torch.Tensor       # [block_rows, C] on the device
    extras: Dict[str, torch.Tensor]   # name -> [block_rows] (padded)


class _Slot:
    """One ring entry: pinned staging bytes, device bytes, and the events
    that order their reuse."""

    __slots__ = ("staging", "dev", "copied", "consumed", "timing")

    def __init__(self, nbytes: int, device: torch.device):
        cuda = device.type == "cuda"
        # pin_memory raises when the host cannot pin: no pageable fallback
        self.staging = torch.zeros(nbytes, dtype=torch.uint8,
                                   pin_memory=cuda)
        self.dev = (torch.empty(nbytes, dtype=torch.uint8, device=device)
                    if cuda else self.staging)
        self.copied = torch.cuda.Event() if cuda else None
        self.consumed = torch.cuda.Event() if cuda else None
        self.timing = None


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class RowBlockPipeline:
    """Bounded-prefetch iterator over a ``HostBinMatrix``'s row blocks.

    ``extras`` are per-row host arrays (float32 or int32) sliced, padded
    and copied with each bins block in one transfer: gradients, hessians,
    row weights and leaf ids ride here, so ONE copy per block moves
    everything the pass consumes.  ``device=None`` means the CUDA card.
    """

    def __init__(self, matrix: HostBinMatrix, prefetch: int = 2,
                 stats: Optional[PipelineStats] = None, device=None) -> None:
        self.matrix = matrix
        self.prefetch = max(1, int(prefetch))
        self.stats = stats if stats is not None else PipelineStats()
        self.device = resolve_device(device)
        m = matrix
        # the slot layout: bins at offset 0, the sidecar 16-byte aligned
        self._bins_nbytes = m.block_rows * m.num_cols * m.bins.dtype.itemsize
        self._side_off = -(-self._bins_nbytes // 16) * 16
        self._bins_dtype = _torch_dtype(m.bins.dtype)
        self._slots: List[_Slot] = []
        self._next_slot = 0
        # one dedicated copy stream; creating it raises without a card
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # process-wide mirrors of the per-trainer PipelineStats, so
        # obs-report sees the transfer volume without a handle on the
        # trainer
        self._m_puts = obs_metrics.counter("stream.h2d_puts")
        self._m_bytes = obs_metrics.counter("stream.h2d_bytes")
        self._m_passes = obs_metrics.counter("stream.passes")
        self._m_skipped = obs_metrics.counter("stream.blocks_skipped")
        self._m_peak = obs_metrics.gauge("stream.peak_block_bytes")

    # ------------------------------------------------------------------
    def _slot(self) -> _Slot:
        """The next ring slot (made on first use, at most prefetch + 1)."""
        ring = min(self.prefetch + 1, self.matrix.num_blocks)
        if len(self._slots) < ring:
            self._slots.append(_Slot(
                self._side_off + MAX_EXTRAS * 4 * self.matrix.block_rows,
                self.device))
            return self._slots[-1]
        slot = self._slots[self._next_slot % ring]
        self._next_slot += 1
        return slot

    def _put(self, i: int, extras: Dict[str, np.ndarray], dtypes,
             compute):
        """Fill the next slot with block ``i`` and its extras (torch's CPU
        copies into the pinned bytes), and start its copy on the copy
        stream (``compute``, the consumer's stream, is current again on
        return).  Returns ``(slot, Block)``."""
        m = self.matrix
        br = m.block_rows
        sl = m.block_slice(i)
        rows = sl.stop - sl.start
        slot = self._slot()
        if slot.copied is not None:
            # the staging buffer is rewritten only after its last copy
            slot.copied.synchronize()
        # the pad rows are zero (weight 0)
        st = slot.staging
        nb = rows * m.num_cols * m.bins.dtype.itemsize
        st[:nb].copy_(torch.from_numpy(m.bins[sl]).reshape(-1).view(
            torch.uint8))
        st[nb:self._bins_nbytes].zero_()
        off = self._side_off
        views = []
        for name, arr in extras.items():
            reg = st[off:off + 4 * br].view(dtypes[name])
            reg[:rows].copy_(torch.from_numpy(arr[sl]))
            reg[rows:].zero_()
            views.append((name, off))
            off += 4 * br
        cs = self._copy_stream
        if cs is not None:
            torch.cuda.set_stream(cs)
            try:
                # the device buffer is overwritten only after the compute
                # that read its previous block
                cs.wait_event(slot.consumed)
                if self.stats.events is not None:
                    slot.timing = [torch.cuda.Event(enable_timing=True)
                                   for _ in range(4)]
                    slot.timing[0].record(cs)
                slot.dev[:off].copy_(st[:off], non_blocking=True)
                if slot.timing is not None:
                    slot.timing[1].record(cs)
                slot.copied.record(cs)
            finally:
                torch.cuda.set_stream(compute)
        dev = slot.dev
        bins = dev[:self._bins_nbytes].view(self._bins_dtype).view(
            br, m.num_cols)
        nbytes = self._bins_nbytes + 4 * br * len(extras)
        self.stats.puts += 1
        self.stats.bytes_h2d += nbytes
        self._m_puts.inc()
        self._m_bytes.inc(nbytes)
        return slot, Block(index=i, rows=rows, start=sl.start, bins=bins,
                           extras={name: dev[o:o + 4 * br].view(dtypes[name])
                                   for name, o in views})

    def _consumed(self, slot: _Slot, compute) -> None:
        """The consumer is done enqueueing work on ``slot``'s block."""
        if slot.consumed is None:
            return
        if slot.timing is not None:
            slot.timing[3].record(compute)
            self.stats.events.append(tuple(slot.timing))
            slot.timing = None
        slot.consumed.record(compute)

    def blocks(self, extras: Optional[Dict[str, np.ndarray]] = None,
               only: Optional[Sequence[int]] = None) -> Iterator[Block]:
        """Yield blocks in index order with bounded prefetch.

        ``only``: optional block-index subset — blocks whose target leaf is
        empty are never transferred at all (the skip is recorded, so tests
        can assert the eviction math).
        """
        extras = extras or {}
        check(len(extras) <= MAX_EXTRAS,
              f"a block carries at most {MAX_EXTRAS} extras")
        for arr in extras.values():
            check(arr.dtype.itemsize == 4 and arr.ndim == 1,
                  "block extras are 1-D arrays of 4-byte values")
        m = self.matrix
        order = list(range(m.num_blocks)) if only is None else sorted(only)
        if only is not None:
            self.stats.blocks_skipped += m.num_blocks - len(order)
            self._m_skipped.inc(m.num_blocks - len(order))
        self.stats.passes += 1
        self._m_passes.inc()
        per_block = m.block_nbytes + 4 * m.block_rows * len(extras)
        dtypes = {name: _torch_dtype(arr.dtype)
                  for name, arr in extras.items()}
        compute = (torch.cuda.current_stream(self.device)
                   if self._copy_stream is not None else None)
        q: deque = deque()
        nxt = 0
        held = None
        try:
            while nxt < len(order) or q:
                # issue the copies of upcoming blocks BEFORE consuming the
                # oldest, so they run behind the caller's compute.  Refill
                # only to `prefetch`: the consumer still holds the
                # previously yielded block's slot, so residency is
                # len(q) + 1 <= prefetch + 1, the plan's budget model
                while nxt < len(order) and len(q) < self.prefetch:
                    q.append(self._put(order[nxt], extras, dtypes, compute))
                    nxt += 1
                self.stats.peak_block_bytes = max(
                    self.stats.peak_block_bytes,
                    (len(q) + (held is not None)) * per_block)
                self._m_peak.set_max(self.stats.peak_block_bytes)
                if held is not None:
                    self._consumed(held, compute)
                held, blk = q.popleft()
                if held.copied is not None:
                    compute.wait_event(held.copied)
                    if held.timing is not None:
                        held.timing[2].record(compute)
                yield blk
        finally:
            if held is not None:
                self._consumed(held, compute)
            # the device memory watermark, once a pass ({} on the CPU)
            obs_costs.record_watermarks("stream", device=self.device)
