"""Out-of-core training: host-resident bin matrix, streamed row blocks
(the port of the JAX package's ``stream/``).

The binned matrix stays in host RAM (``HostBinMatrix``) and moves to the
card in row blocks through a ring of pinned staging buffers and a
dedicated copy stream (``RowBlockPipeline``: the copy of block k+1 runs
behind the histogram pass on block k).  Trees grow by accumulating each
block's histogram with the K1 kernel into the ``[F, B, 3]`` layout the
in-memory growers use, so the split search is shared.

Entry points:
- ``io.dataset.Dataset.stream_plan()`` — the budget decision
  (``max_bin_matrix_bytes`` / ``stream_rows`` / ``STREAM_FAKE_DEVICE_BYTES``);
- ``stream.booster.StreamGBDT`` / ``StreamGOSS`` — engine classes that
  ``Booster`` routes to when the plan streams;
- ``stream.grower.StreamTreeGrower`` — one tree from host blocks, the
  structure of the sequential grower's (``ops/grower.grow_tree_serial``).
"""
from .host_matrix import HostBinMatrix, StreamPlan, plan_streaming
from .pipeline import RowBlockPipeline
from .grower import StreamTreeGrower
from .booster import StreamGBDT, StreamGOSS

__all__ = ["HostBinMatrix", "StreamPlan", "plan_streaming",
           "RowBlockPipeline", "StreamTreeGrower", "StreamGBDT",
           "StreamGOSS"]
