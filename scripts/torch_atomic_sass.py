"""The instruction mix of the atomic histogram kernels' inner loop.

    python3 scripts/torch_atomic_sass.py

Builds ``hist_full`` and ``hist_leaves`` (``lightgbm_tpu_torch/ops/
_build.py``), disassembles each library with ``cuobjdump -sass`` and, for
every kernel in it, prints one JSON line: the count of each opcode in the
whole kernel, the shared-memory atomics (``ATOMS``, with ``ATOMS.CAS`` --
the compare-and-swap loop a float64 ``atomicAdd`` on shared memory becomes
-- counted apart), the global atomics and reductions (``ATOM``, ``RED``),
the warp matches (``MATCH``), and the opcode mix of the update loop: from
the first to the last ``MATCH``, ``ATOMS`` or float64 add (``DADD``).
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card; run it from
an older checkout's root to read that checkout's kernels.
"""
import collections
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*"
                   r"(?:\.[A-Z0-9_]+)*)")
_FUNC = re.compile(r"Function : (\S+)")
KERNELS = ("hist_full", "hist_leaves")


def kernel_mix(sass: str):
    """{mangled kernel name: summary} of one library's ``cuobjdump -sass``:
    opcode counts (base opcode, modifiers dropped) over the kernel and over
    its update loop, and the atomics by kind (modifiers kept)."""
    out = {}
    parts = _FUNC.split(sass)
    for name, body in zip(parts[1::2], parts[2::2]):
        full = _INSN.findall(body)
        ops = [op.split(".")[0] for op in full]
        marks = [i for i, op in enumerate(ops)
                 if op in ("MATCH", "ATOMS", "DADD")]
        loop = collections.Counter(ops[marks[0]:marks[-1] + 1]) if marks \
            else collections.Counter()
        atomics = collections.Counter(
            op for op in full if op.split(".")[0] in ("ATOMS", "ATOM", "RED",
                                                      "ATOMG", "REDG"))
        out[name] = {
            "instructions": len(ops),
            "atoms_cas": sum(c for op, c in atomics.items()
                             if op.startswith("ATOMS.CAS")),
            "atoms": sum(c for op, c in atomics.items()
                         if op.startswith("ATOMS")),
            "global_atomics": sum(c for op, c in atomics.items()
                                  if not op.startswith("ATOMS")),
            "match": ops.count("MATCH"),
            "atomics_by_kind": dict(atomics.most_common()),
            "loop_instructions": sum(loop.values()),
            "loop_ops": dict(loop.most_common()),
            "ops": dict(collections.Counter(ops).most_common())}
    return out


def main() -> int:
    from lightgbm_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    _build.build(KERNELS)
    for k in KERNELS:
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(k))],
                              capture_output=True, text=True,
                              check=True).stdout
        for fn, mix in kernel_mix(sass).items():
            print(json.dumps({"library": k, "kernel": fn, **mix}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
