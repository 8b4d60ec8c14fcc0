"""Model → standalone C++ code generation (a copy of the JAX package's
``models/convert.py``).

Analog of the reference ``GBDT::ModelToIfElse``
(``src/boosting/gbdt_model_text.cpp:124-286``) behind the CLI
``task=convert_model``: emits a self-contained C++ translation unit with one
if-else function per tree, a ``PredictRaw`` accumulator and a ``Predict``
applying the objective's output transform, so trained models can be deployed
with zero runtime dependencies.  The reference's CLI test recompiles the
generated code and asserts prediction parity (``tests/cpp_test``); ours does
the same through a shared object + ctypes.
"""
from __future__ import annotations

from typing import List

K_ZERO_THRESHOLD = 1e-35


def _leaf_code(tree, leaf: int, indent: str) -> str:
    if not tree.is_linear:
        return f"{indent}return {float(tree.leaf_value[leaf])!r};\n"
    # linear leaf: const + coeff.x, constant fallback on NaN inputs
    feats = tree.leaf_features[leaf] if leaf < len(tree.leaf_features) else []
    const = float(tree.leaf_const[leaf]) if len(tree.leaf_const) > leaf \
        else float(tree.leaf_value[leaf])
    if not feats:
        return f"{indent}return {const!r};\n"
    nan_chk = " || ".join(f"std::isnan(f[{f}])" for f in feats)
    terms = " + ".join(f"{float(c)!r} * f[{f}]"
                       for c, f in zip(tree.leaf_coeff[leaf], feats))
    return (f"{indent}if ({nan_chk}) return {float(tree.leaf_value[leaf])!r};\n"
            f"{indent}return {const!r} + {terms};\n")


def _node_code(tree, node: int, indent: str) -> str:
    """Emit the decision at an internal node or the value at a leaf."""
    if node < 0:
        return _leaf_code(tree, ~node, indent)
    f = int(tree.split_feature[node])
    mt = tree.missing_type(node)
    dl = tree.default_left(node)
    lines = []
    if tree.is_categorical_split(node):
        ci = int(tree.threshold[node])
        lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
        words = tree.cat_threshold[lo:hi]
        cats = [w * 32 + b for w in range(len(words)) for b in range(32)
                if words[w] >> b & 1]
        cond = " || ".join(f"(int)f[{f}] == {c}" for c in cats) or "false"
        lines.append(f"{indent}if (!std::isnan(f[{f}]) && f[{f}] >= 0 && ({cond})) {{\n")
    else:
        th = repr(float(tree.threshold[node]))
        if mt == 0:          # None: NaN treated as 0
            lines.append(f"{indent}if ((std::isnan(f[{f}]) ? 0.0 : f[{f}]) <= {th}) {{\n")
        elif mt == 1:        # Zero as missing
            miss = f"(std::isnan(f[{f}]) || std::fabs(f[{f}]) <= {K_ZERO_THRESHOLD!r})"
            base = f"(std::isnan(f[{f}]) ? 0.0 : f[{f}]) <= {th}"
            branch = f"({miss} ? {str(dl).lower()} : ({base}))"
            lines.append(f"{indent}if ({branch}) {{\n")
        else:                # NaN as missing
            branch = (f"(std::isnan(f[{f}]) ? {str(dl).lower()} : "
                      f"(f[{f}] <= {th}))")
            lines.append(f"{indent}if ({branch}) {{\n")
    lines.append(_node_code(tree, int(tree.left_child[node]), indent + "  "))
    lines.append(f"{indent}}} else {{\n")
    lines.append(_node_code(tree, int(tree.right_child[node]), indent + "  "))
    lines.append(f"{indent}}}\n")
    return "".join(lines)


def _tree_fn(tree, idx: int) -> str:
    if tree.num_leaves > 1:
        body = _node_code(tree, 0, "  ")
    elif tree.is_linear:
        body = _leaf_code(tree, 0, "  ")
    else:
        body = f"  return {float(tree.leaf_value[0] if len(tree.leaf_value) else 0.0)!r};\n"
    return (f"static double PredictTree{idx}(const double* f) {{\n"
            f"{body}}}\n\n")


def model_to_cpp(gbdt) -> str:
    """Generate the standalone C++ source for a trained GBDT."""
    K = gbdt.num_tree_per_iteration
    trees: List = gbdt.models
    parts = ["// generated by lightgbm_tpu_torch convert_model "
             "(analog of gbdt_model_text.cpp:124 ModelToIfElse)\n",
             "#include <cmath>\n#include <cstring>\n\n",
             f'extern "C" {{\n'
             f"int NumClass() {{ return {K}; }}\n"
             f"int NumTrees() {{ return {len(trees)}; }}\n}}\n\n"]
    for i, t in enumerate(trees):
        parts.append(_tree_fn(t, i))
    if K == 1:
        sums = [" + ".join(f"PredictTree{i}(f)"
                           for i in range(0, len(trees))) or "0.0"]
    else:
        sums = [" + ".join(f"PredictTree{i}(f)"
                           for i in range(k, len(trees), K)) or "0.0"
                for k in range(K)]
    parts.append('extern "C" void PredictRaw(const double* f, double* out) {\n')
    for k, s in enumerate(sums):
        parts.append(f"  out[{k}] = {s};\n")
    parts.append("}\n\n")

    obj_name = getattr(gbdt.objective, "name", None) or \
        getattr(gbdt.config, "objective", "regression")
    parts.append('extern "C" void Predict(const double* f, double* out) {\n'
                 "  PredictRaw(f, out);\n")
    if obj_name == "binary":
        sig = getattr(gbdt.config, "sigmoid", 1.0)
        parts.append(f"  out[0] = 1.0 / (1.0 + std::exp(-{sig!r} * out[0]));\n")
    elif obj_name in ("poisson", "gamma", "tweedie"):
        parts.append("  out[0] = std::exp(out[0]);\n")
    elif obj_name in ("multiclass", "multiclassova"):
        if obj_name == "multiclass":
            parts.append(
                f"  double m = out[0];\n"
                f"  for (int k = 1; k < {K}; ++k) if (out[k] > m) m = out[k];\n"
                f"  double s = 0.0;\n"
                f"  for (int k = 0; k < {K}; ++k) {{ out[k] = std::exp(out[k] - m); s += out[k]; }}\n"
                f"  for (int k = 0; k < {K}; ++k) out[k] /= s;\n")
        else:
            sig = getattr(gbdt.config, "sigmoid", 1.0)
            parts.append(f"  for (int k = 0; k < {K}; ++k) "
                         f"out[k] = 1.0 / (1.0 + std::exp(-{sig!r} * out[k]));\n")
    parts.append("}\n")
    return "".join(parts)


__all__ = ["model_to_cpp"]
