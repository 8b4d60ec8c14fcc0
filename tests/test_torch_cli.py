"""PyTorch port, the command line (``python -m lightgbm_tpu_torch``)
against the JAX package's.

``examples/binary_classification/train.conf`` (bagging, feature_fraction,
training and valid metrics) drives both CLIs with ``device_type=cpu`` and
key=value overrides on an examples-style TSV with a ``.weight`` sidecar:
the train task gives the JAX package's model text (leaf values to 1e-5, as
``test_torch_train.py`` holds), the predict task on one model the JAX
package's output file (raw scores bit for bit), refit the JAX package's
leaf values within 5e-6, and convert_model C++ that ``g++`` compiles and
that predicts as the model does (``tests/test_cli_convert.py``'s check).
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import application as japp
from lightgbm_tpu_torch import application as tapp

from test_torch_train import _assert_same_model_text, _data

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "examples", "binary_classification", "train.conf")


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The data files and both packages' trained models."""
    d = tmp_path_factory.mktemp("cli")
    X, y, Xv, yv = _data(0, n=4000, nv=1000)
    for name, A, b in (("binary.train", X, y), ("binary.test", Xv, yv)):
        np.savetxt(d / name, np.column_stack([b, A]), delimiter="\t",
                   fmt="%.9g")
    w = np.random.default_rng(1).uniform(0.5, 1.5, len(y)).round(4)
    np.savetxt(d / "binary.train.weight", w, fmt="%.4f")
    args = {pkg: [f"config={CONF}", f"data={d / 'binary.train'}",
                  f"valid_data={d / 'binary.test'}", "num_trees=5",
                  "num_leaves=15", "min_data_in_leaf=20", "verbose=-1",
                  "device_type=cpu", f"output_model={d / (pkg + '.txt')}"]
            for pkg in ("jax", "torch")}
    assert japp.main(args["jax"]) == 0
    assert tapp.main(args["torch"]) == 0
    return d, Xv, w


def test_cli_train_matches_jax(cli):
    d, _, _ = cli
    tj, tt = (open(d / f"{p}.txt").read() for p in ("jax", "torch"))
    _assert_same_model_text(tj, tt)
    # the example's parameters reached the model
    assert "[bagging_freq: 5]" in tt and "[feature_fraction: 0.8]" in tt


def _tree_lines(text):
    return [line for line in text.split("end of trees")[0].splitlines()
            if not line.startswith(("tree_sizes", "feature_infos"))]


def test_cli_train_equals_the_api_on_the_same_arrays(cli):
    """The CLI's trees are the API's on the matrix the file holds (its
    float32 values to nine digits, parsed into doubles: a double within
    1e-9 of a float32 can bin apart from it when a bin bound lies
    between, so the API takes the parsed matrix) and the sidecar's
    weights: line for line."""
    from lightgbm_tpu_torch.io.loader import load_file
    d, _, w = cli
    X, y = load_file(str(d / "binary.train"))[:2]
    np.testing.assert_array_equal(X.astype(np.float32),
                                  _data(0, n=4000, nv=1000)[0])
    params = dict(tapp.parse_config_file(CONF), num_leaves=15,
                  min_data_in_leaf=20, verbose=-1)
    for key in ("task", "data", "valid_data", "output_model", "num_trees"):
        params.pop(key)
    bt = lgt.train(params, lgt.Dataset(X, label=y, weight=w), 5,
                   verbose_eval=False, device="cpu")
    assert _tree_lines(bt.model_to_string()) == \
        _tree_lines(open(d / "torch.txt").read())


def test_cli_predict_matches_jax(cli):
    d, Xv, _ = cli
    model = d / "torch.txt"
    for pkg, app in (("jax", japp), ("torch", tapp)):
        for raw in (False, True):
            assert app.main([
                "task=predict", f"data={d / 'binary.test'}",
                f"input_model={model}", "device_type=cpu",
                f"predict_raw_score={str(raw).lower()}",
                f"output_result={d / f'pred_{pkg}_{raw}.txt'}"]) == 0
    bt = lgt.Booster(model_file=str(model), device="cpu")
    for raw in (False, True):
        pt = np.loadtxt(d / f"pred_torch_{raw}.txt")
        pj = np.loadtxt(d / f"pred_jax_{raw}.txt")
        np.testing.assert_array_equal(pt, bt.predict(Xv, raw_score=raw))
        if raw:
            np.testing.assert_array_equal(pt, pj)
        else:
            np.testing.assert_allclose(pt, pj, rtol=0, atol=1.2e-7)
    # the predict task from a Booster's file path
    np.testing.assert_array_equal(bt.predict(str(d / "binary.test")),
                                  bt.predict(Xv))


def test_cli_refit_matches_jax(cli):
    d, _, _ = cli
    for pkg, app in (("jax", japp), ("torch", tapp)):
        assert app.main([
            "task=refit", f"data={d / 'binary.test'}", "device_type=cpu",
            f"input_model={d / 'torch.txt'}", "refit_decay_rate=0.5",
            f"output_model={d / f'refit_{pkg}.txt'}"]) == 0
    rj = lgb.Booster(model_file=str(d / "refit_jax.txt"))
    rt = lgt.Booster(model_file=str(d / "refit_torch.txt"), device="cpu")
    before = lgt.Booster(model_file=str(d / "torch.txt"), device="cpu")
    for tj, tt, t0 in zip(rj._gbdt.models, rt._gbdt.models,
                          before._gbdt.models):
        np.testing.assert_array_equal(tt.split_feature, t0.split_feature)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=0,
                                   atol=5e-6)


def test_cli_convert_model_compiles_and_matches(cli, tmp_path):
    d, Xv, _ = cli
    for pkg, app in (("jax", japp), ("torch", tapp)):
        assert app.main(["task=convert_model", "device_type=cpu",
                         f"input_model={d / 'torch.txt'}",
                         f"convert_model={tmp_path / (pkg + '.cpp')}"]) == 0
    code_t = (tmp_path / "torch.cpp").read_text()
    code_j = (tmp_path / "jax.cpp").read_text()
    # the same code under its own header line
    assert code_t.split("\n", 1)[1] == code_j.split("\n", 1)[1]
    so = tmp_path / "model.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC",
                    str(tmp_path / "torch.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.Predict.argtypes = [ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_double)]
    bt = lgt.Booster(model_file=str(d / "torch.txt"), device="cpu")
    want = bt.predict(Xv[:100])
    out = (ctypes.c_double * 1)()
    for i in range(100):
        row = np.ascontiguousarray(Xv[i], dtype=np.float64)
        lib.Predict(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), out)
        assert abs(out[0] - want[i]) < 1e-6, i


def test_cli_key_value_overrides():
    p = tapp.parse_argv([f"config={CONF}", "num_trees=5",
                         "learning_rate=0.3"])
    assert p == japp.parse_argv([f"config={CONF}", "num_trees=5",
                                 "learning_rate=0.3"])
    assert p["num_trees"] == "5" and p["learning_rate"] == "0.3"
    assert p["objective"] == "binary" and p["bagging_freq"] == "5"
    with pytest.raises(lgt.LightGBMError, match="key=value"):
        tapp.parse_argv(["num_trees"])


def test_cli_device_type_picks_the_card(cli):
    """``device_type`` tpu (the default), cuda or gpu means the card: with
    none, the task raises NoCudaDeviceError and the CLI exits with 2."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error; this machine has a card")
    d, _, _ = cli
    for dev in ("tpu", "cuda", "gpu"):
        app = tapp.Application({"task": "predict", "device_type": dev,
                                "data": str(d / "binary.test"),
                                "input_model": str(d / "torch.txt")})
        with pytest.raises(lgt.NoCudaDeviceError):
            app.run()
    assert tapp.main(["task=train", f"data={d / 'binary.train'}",
                      "num_trees=1"]) == 2
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "device_type=cpu" in r.stdout
