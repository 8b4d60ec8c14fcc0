"""The instruction mix of the one-hot kernels' inner loop.

    python3 scripts/torch_onehot_sass.py [NAME ...]

Builds ``onehot_full`` and ``onehot_leaves`` (``lightgbm_tpu_torch/ops/
_build.py``), disassembles each library with ``cuobjdump -sass`` and, for
every kernel whose mangled name holds one of the NAMEs (default: the int8
kernels, ``int8_kernel``), counts the opcodes between its first and last
tensor-core instruction (``IMMA`` or ``HMMA``): the chunk loop where the
kernel spends its time.  Prints one JSON line per kernel: the tensor-core
instructions, the others, their ratio and the opcode counts.  Needs the
CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.
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

_INSN = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
_FUNC = re.compile(r"Function : (\S+)")


def loop_mix(sass: str):
    """{mangled kernel name: Counter of the opcodes from its first to its
    last tensor-core instruction} of one library's ``cuobjdump -sass``."""
    out = {}
    parts = _FUNC.split(sass)
    for name, body in zip(parts[1::2], parts[2::2]):
        ops = _INSN.findall(body)
        mma = [i for i, op in enumerate(ops) if op in ("IMMA", "HMMA")]
        if mma:
            out[name] = collections.Counter(ops[mma[0]:mma[-1] + 1])
    return out


def main() -> int:
    from lightgbm_tpu_torch.ops import _build
    names = sys.argv[1:] or ["int8_kernel"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    kernels = ("onehot_full", "onehot_leaves")
    _build.build(kernels)
    for k in kernels:
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(k))],
                              capture_output=True, text=True,
                              check=True).stdout
        for fn, mix in loop_mix(sass).items():
            if not any(n in fn for n in names):
                continue
            mma = mix["IMMA"] + mix["HMMA"]
            other = sum(mix.values()) - mma
            print(json.dumps({"library": k, "kernel": fn, "mma": mma,
                              "other": other,
                              "other_per_mma": round(other / mma, 3),
                              "ops": dict(mix.most_common())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
