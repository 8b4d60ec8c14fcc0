"""Model text serialization — reference-compatible grammar.

Mirrors ``src/boosting/gbdt_model_text.cpp`` (save ``:311``, load ``:416``):
a header (version/num_class/objective/feature names/feature infos), ``Tree=N``
blocks, ``end of trees``, feature importances, and a parameters section, so
models round-trip with the reference's loader.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import Config
from ..io.bin import BinType
from ..utils.log import Log, check
from .tree import Tree

_VERSION = "v3"


def feature_infos_from_dataset(dataset) -> List[str]:
    """Per-feature ``[min:max]`` / categorical ``a:b:c`` infos
    (reference ``Dataset::DumpTextFile`` feature_infos)."""
    infos = []
    for f in range(dataset.num_total_features):
        m = dataset.bin_mappers[f]
        if m.is_trivial:
            infos.append("none")
        elif m.bin_type == BinType.CATEGORICAL:
            infos.append(":".join(str(c) for c in m.bin_2_categorical))
        else:
            infos.append(f"[{m.min_val:g}:{m.max_val:g}]")
    return infos


def save_model_to_string(gbdt, num_iteration: int = -1,
                         start_iteration: int = 0,
                         feature_importance_type: int = 0) -> str:
    cfg: Config = gbdt.config
    K = gbdt.num_tree_per_iteration
    models = gbdt.models
    n_total_iters = len(models) // max(1, K)
    if num_iteration is None or num_iteration <= 0:
        num_iteration = n_total_iters - start_iteration
    num_iteration = min(num_iteration, n_total_iters - start_iteration)
    used = models[start_iteration * K:(start_iteration + num_iteration) * K]

    lines = ["tree", f"version={_VERSION}", f"num_class={cfg.num_class}",
             f"num_tree_per_iteration={K}", "label_index=0",
             f"max_feature_idx={gbdt.max_feature_idx}",
             f"objective={_objective_string(cfg)}"]
    if getattr(gbdt, "average_output", False):
        lines.append("average_output")
    fnames = (gbdt.train_data.feature_names if gbdt.train_data is not None
              else [f"Column_{i}" for i in range(gbdt.max_feature_idx + 1)])
    lines.append("feature_names=" + " ".join(fnames))
    if gbdt.train_data is not None:
        lines.append("feature_infos=" + " ".join(feature_infos_from_dataset(gbdt.train_data)))
    else:
        lines.append("feature_infos=" + " ".join(
            ["none"] * (gbdt.max_feature_idx + 1)))
    tree_strs = [t.to_text(i) for i, t in enumerate(used)]
    lines.append("tree_sizes=" + " ".join(str(len(s) + 1) for s in tree_strs))
    lines.append("")
    body = "\n".join(lines) + "\n" + "\n".join(tree_strs) + "\n"
    body += "end of trees\n\n"

    imp = gbdt.feature_importance(
        "gain" if feature_importance_type == 1 else "split")
    order = np.argsort(-imp, kind="stable")
    body += "feature_importances:\n"
    for f in order:
        if imp[f] > 0:
            body += f"{fnames[f]}={int(imp[f]) if feature_importance_type == 0 else imp[f]}\n"
    body += "\nparameters:\n"
    for k, v in cfg.to_dict(only_non_default=True).items():
        if isinstance(v, list):
            v = ",".join(str(x) for x in v)
        body += f"[{k}: {v}]\n"
    body += "end of parameters\n"
    return body


def _objective_string(cfg: Config) -> str:
    s = cfg.objective
    if cfg.objective in ("multiclass", "multiclassova"):
        s += f" num_class:{cfg.num_class}"
    if cfg.objective == "binary":
        s += f" sigmoid:{cfg.sigmoid:g}"
    if cfg.objective in ("lambdarank", "rank_xendcg"):
        pass
    return s


def format_pandas_categorical(pandas_categorical) -> str:
    """Trailing ``pandas_categorical:<json>`` line, the same format the
    reference python package appends after the C++ model text
    (``basic.py _dump_pandas_categorical:445``); the reference's text
    parser ignores trailing content, so files stay interoperable."""
    import json

    def _default(o):
        if isinstance(o, np.generic):
            return o.item()
        raise TypeError(f"cannot serialize {type(o).__name__}")

    return ("\npandas_categorical:"
            + json.dumps(pandas_categorical, default=_default) + "\n")


def parse_pandas_categorical(text: str):
    """Recover the category lists from a saved model's trailing line
    (reference ``_load_pandas_categorical``, ``basic.py:455``)."""
    import json
    tag = "pandas_categorical:"
    pos = text.rfind("\n" + tag)
    if pos < 0:
        return None
    lines = text[pos + 1 + len(tag):].splitlines()
    if not lines:            # file truncated right after the tag
        return None
    try:
        return json.loads(lines[0])
    except json.JSONDecodeError:
        return None


def load_model_from_string(text: str, gbdt_cls, config: Optional[Config] = None):
    """Parse a model file (reference ``GBDT::LoadModelFromString``,
    ``gbdt_model_text.cpp:416``)."""
    check(text.lstrip().startswith("tree"), "unknown model format")
    header, _, rest = text.partition("\nTree=")
    kv = {}
    for line in header.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            kv[k.strip()] = v.strip()

    params = {}
    if "parameters:" in text:
        psec = text.split("parameters:", 1)[1].split("end of parameters", 1)[0]
        for line in psec.splitlines():
            line = line.strip()
            if line.startswith("[") and ":" in line:
                k, v = line[1:-1].split(":", 1)
                params[k.strip()] = v.strip()
    obj_str = kv.get("objective", "regression").split()
    params.setdefault("objective", obj_str[0] if obj_str else "regression")
    for tok in obj_str[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            params.setdefault(k, v)
    cfg = config or Config.from_params(params)

    gbdt = gbdt_cls(cfg)
    gbdt.num_tree_per_iteration = int(kv.get("num_tree_per_iteration", 1))
    gbdt.num_class = int(kv.get("num_class", 1))
    gbdt.max_feature_idx = int(kv.get("max_feature_idx", 0))
    gbdt.feature_names_ = kv.get("feature_names", "").split()
    gbdt.average_output = "average_output" in header.split()

    from ..objective import create_objective
    gbdt.objective = create_objective(cfg)

    if rest:
        tree_blocks = ("Tree=" + rest).split("end of trees")[0]
        blocks = tree_blocks.split("\nTree=")
        for i, b in enumerate(blocks):
            if not b.strip():
                continue
            if not b.startswith("Tree="):
                b = "Tree=" + b
            gbdt.models.append(Tree.from_text(b))
    gbdt.iter_ = len(gbdt.models) // max(1, gbdt.num_tree_per_iteration)
    return gbdt
