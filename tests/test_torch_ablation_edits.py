"""PyTorch port: the one-hot ablation script's text edits still fit the
kernel sources.

``scripts/torch_onehot_ablation.py`` times copies of the one-hot kernels
with a part of the work taken out, made by text edits of
``onehot_common.cuh`` that must each match exactly once.  A change to the
kernels that one edit no longer matches would only show on the card, so
each copy's edits are applied here, on the CPU, to a copy of the current
sources (an edit may fall in either edited header), and so are the register-bound sweep's and those of the quantize
kernel's copies (``scripts/torch_quant_bench.py --copies``).
"""
import importlib.util
import os

import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_DIR = os.path.join(REPO, "lightgbm_tpu_torch", "ops", "kernels")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ABL = _script("torch_onehot_ablation")
QUANT = _script("torch_quant_bench")


@pytest.mark.parametrize("name", ABL.ABLATIONS + tuple(ABL.SWEEP))
def test_ablation_edits_match_the_sources_once(tmp_path, name):
    """Each edit matches exactly once in the edited sources taken together
    (``onehot_common.cuh`` and ``onehot_bucket.cuh``)."""
    edits = ABL.ablation_edits(name)
    assert bool(edits) == (name != "repo")
    out = tmp_path / name
    ABL._patched_sources(name, edits, KERNEL_DIR, str(out))
    before, after = {}, {}
    for fn in ABL.EDITED:
        with open(os.path.join(KERNEL_DIR, fn)) as fh:
            before[fn] = fh.read()
        after[fn] = (out / fn).read_text()
    for old, new in edits:
        assert sum(t.count(old) for t in before.values()) == 1
        assert sum(t.count(old) for t in after.values()) == (
            1 if old in new else 0)
    # the other sources are copied as they are
    for fn in os.listdir(KERNEL_DIR):
        if fn not in ABL.EDITED:
            with open(os.path.join(KERNEL_DIR, fn), "rb") as fh:
                assert (out / fn).read_bytes() == fh.read()


def test_ablation_edits_refuse_a_source_they_do_not_fit(tmp_path):
    """The edits for the earlier int8 body (``lanes``) do not fit the
    current one: the script stops instead of timing an unedited copy."""
    with pytest.raises(RuntimeError, match="not once"):
        ABL._patched_sources("const_a", ABL.ablation_edits("const_a",
                                                           "lanes"),
                             KERNEL_DIR, str(tmp_path / "x"))


@pytest.mark.parametrize("name", tuple(QUANT.EDITS))
def test_quant_bench_edits_match_the_source_once(name):
    with open(os.path.join(KERNEL_DIR, "onehot_quant.cu")) as fh:
        before = fh.read()
    after = QUANT.patched_source(name, before)
    for old, new in QUANT.EDITS[name]:
        assert before.count(old) == 1
        assert after.count(old) == (1 if old in new else 0)
    with pytest.raises(RuntimeError, match="not once"):
        QUANT.patched_source(name, after)
