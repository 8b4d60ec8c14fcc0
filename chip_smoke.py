"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

(``--profile`` adds a torch.profiler phase over three more iterations and
writes its tables to ``chiprun_out/profile_train.txt``).

Drives ``lightgbm_tpu_torch``'s main path on the card, in phases, printing
one JSON line per phase; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile both histogram kernels from the sources in this checkout
   (one ``nvcc`` per source, all at once);
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (max relative error ``|a-b|/(|b|+1)`` <= 1e-5: both
   sum in float64 in different orders and round to float32 once), with
   per-launch times from CUDA events;
4. train: binary GBDT on 1,000,000 x 28 Higgs-shaped rows, 255 leaves,
   20 iterations, once through the kernels (launches counted from zero
   around this run) and once with ``force_plain()``; held-out AUC of both
   within 1e-3 and tree 0's splits identical;
5. predict: ``save_model`` -> ``Booster(model_file=...)`` predicts
   bit-identically to the booster in memory.

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``.  Without a CUDA card, or without the package beside it, it fails
before printing any result.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and f32 outside the
# tensor cores
HBM_TB_PER_S = 3.35
F32_TFLOP_PER_S = 67.0
REL_TOL = 1e-5
AUC_TOL = 1e-3
N_TRAIN, N_VALID, N_FEAT, N_ITERS = 1_000_000, 100_000, 28, 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_higgs_like(n_rows: int, n_feat: int = 28, seed: int = 42):
    """Synthetic stand-in with Higgs geometry (dense floats, ~even classes);
    the same generator as the repository's ``bench.py``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 3]
             + 0.5 * np.sin(3.0 * X[:, 4]) + 0.3 * X[:, 5] ** 2)
    y = (logit + rng.logistic(size=n_rows) > 0).astype(np.float32)
    return X, y


def relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / (b.abs() + 1.0)).max())


def median_ms(fn, reps: int = 20) -> float:
    """Median per-call device time from CUDA events (after 3 warm-ups)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, nflops: float):
    t_bytes = nbytes / (HBM_TB_PER_S * 1e12) * 1e3
    t_ops = nflops / (F32_TFLOP_PER_S * 1e12) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from lightgbm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build()
    for name in _build.KERNELS:
        _build.load(name)
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "smem" in ln]
             for n in _build.KERNELS}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in secs.items()},
          "ptxas": ptxas})


def _rows(gen, n, dev):
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) * 0.2 + 0.05
    m = (torch.rand(n, generator=gen, device=dev) > 0.1).float()
    return g, h, m


def _check_full(hist, gen, dev, n, f, B):
    bins = torch.randint(0, B, (n, f), generator=gen, device=dev,
                         dtype=torch.uint8)
    g, h, m = _rows(gen, n, dev)
    with hist.force_plain():
        ref = hist.build_histogram(bins, g, h, m, B)
    got = hist.hist_full(bins, g, h, m, B)
    torch.cuda.synchronize()
    err = relerr(got, ref)
    if not err <= REL_TOL:
        raise AssertionError(f"hist_full {n}x{f}x{B}: relerr {err}")
    return bins, g, h, m, got, ref, err


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    from lightgbm_tpu_torch.ops import histogram as hist
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}

    # hist_full: the frontier's root histogram (N=1M, F=28, B=256) and an
    # odd shape (ragged row count, feature count not a power of two)
    n, f, B = N_TRAIN, N_FEAT, 256
    bins, g, h, m, got, ref, err = _check_full(hist, gen, dev, n, f, B)
    _, _, _, _, _, _, err_odd = _check_full(hist, gen, dev, 100_003, 13, 64)
    ms = median_ms(lambda: hist.hist_full(bins, g, h, m, B))
    with hist.force_plain():
        plain_ms = median_ms(lambda: hist.build_histogram(bins, g, h, m, B))
    flat = (bins.long() + B * torch.arange(f, device=dev)).reshape(-1)
    vals = torch.stack([g * m, h * m, m], 1)[:, None, :].expand(n, f, 3) \
        .reshape(-1, 3).contiguous()
    lib_out = torch.zeros(f * B, 3, device=dev)
    library_ms = median_ms(lambda: lib_out.index_add_(0, flat, vals))
    b_ms, b_by = bound(n * f + 12 * n + f * B * 12, 3 * n * f + 2 * n)
    out["hist_full"] = dict(
        shape=[n, f, B], relerr=err, relerr_odd_shape=err_odd,
        max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    del bins, g, h, m, flat, vals

    # hist_leaves: one frontier round's batched smaller-child histograms
    C, NC, fl, k, BR = 262_144, 40, 28, 16, 512
    nb = C // BR
    comb = torch.randint(0, 256, (C, NC), generator=gen, device=dev,
                         dtype=torch.uint8)
    g, h, m = _rows(gen, C, dev)
    empty, nan_block = 5, 100
    slots = torch.tensor([s for s in range(k) if s != empty], device=dev)
    block_leaf = slots[torch.randint(0, k - 1, (nb,), generator=gen,
                                     device=dev)].to(torch.int32)
    g[nan_block * BR + 7] = float("nan")
    nan_slot = int(block_leaf[nan_block])
    with hist.force_plain():
        ref = hist.build_histogram_leaves(comb, g, h, m, block_leaf, k, B,
                                          block_rows=BR, f_limit=fl)
    got = hist.hist_leaves(comb, g, h, m, block_leaf, k, B, block_rows=BR,
                           f_limit=fl)
    torch.cuda.synchronize()
    if not bool((got[empty] == 0).all()):
        raise AssertionError("hist_leaves: the empty slot is not zero")
    others = [s for s in range(k) if s != nan_slot]
    if not (bool(torch.isnan(got[nan_slot]).any())
            and bool(torch.isfinite(got[others]).all())):
        raise AssertionError("hist_leaves: the NaN is not confined to its slot")
    if not torch.equal(torch.isnan(got), torch.isnan(ref)):
        raise AssertionError("hist_leaves: NaN pattern differs from plain")
    fin = torch.isfinite(ref)
    err = relerr(got[fin], ref[fin])
    if not err <= REL_TOL:
        raise AssertionError(f"hist_leaves: relerr {err}")
    ms = median_ms(lambda: hist.hist_leaves(comb, g, h, m, block_leaf, k, B,
                                            block_rows=BR, f_limit=fl))
    with hist.force_plain():
        plain_ms = median_ms(lambda: hist.build_histogram_leaves(
            comb, g, h, m, block_leaf, k, B, block_rows=BR, f_limit=fl))
    row_leaf = block_leaf.long().repeat_interleave(BR)
    flat = ((row_leaf[:, None] * fl + torch.arange(fl, device=dev)) * B
            + comb[:, :fl].long()).reshape(-1)
    vals = torch.stack([g * m, h * m, m], 1)[:, None, :].expand(C, fl, 3) \
        .reshape(-1, 3).contiguous()
    lib_out = torch.zeros(k * fl * B, 3, device=dev)
    library_ms = median_ms(lambda: lib_out.index_add_(0, flat, vals))
    b_ms, b_by = bound(C * fl + 12 * C + 4 * nb + k * fl * B * 12,
                       3 * C * fl + 2 * C)
    out["hist_leaves"] = dict(
        shape=[C, NC, fl, k, BR], relerr=err,
        max_abs_err=float((got[fin] - ref[fin]).abs().max()), ms=ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
        bound_by=b_by, empty_slot_zero=True, nan_confined=True)
    emit({"phase": "kernels", **out})
    return out


def _auc(scores, labels):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.metric.base import AUCMetric
    md = Metadata(len(labels))
    md.set_field("label", labels)
    m = AUCMetric(Config())
    m.init(md, len(labels))
    return m.eval(np.asarray(scores, np.float64))[0][1]


def _train(lgt, ds, params):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster = lgt.train(params, ds, N_ITERS, verbose_eval=False,
                        device="cuda")
    booster._gbdt.models                       # drain the pending trees
    torch.cuda.synchronize()
    return booster, time.perf_counter() - t0


def phase_train(card):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbose": -1}
    X, y = make_higgs_like(N_TRAIN, N_FEAT, seed=42)
    Xv, yv = make_higgs_like(N_VALID, N_FEAT, seed=43)
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params=params).construct(device="cuda")
    construct_s = time.perf_counter() - t0

    # the main path: launch counts from zero around this run only
    hist.reset_launch_counts()
    booster, secs = _train(lgt, ds, params)
    launches = dict(hist.launch_counts)
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    hist.reset_launch_counts()
    with hist.force_plain():
        booster_p, secs_p = _train(lgt, ds, params)
    if any(hist.launch_counts.values()):
        raise AssertionError(f"force_plain launched kernels: "
                             f"{hist.launch_counts}")

    t_k, t_p = booster._gbdt.models[0], booster_p._gbdt.models[0]
    same_tree0 = (t_k.num_leaves == t_p.num_leaves
                  and np.array_equal(t_k.split_feature, t_p.split_feature)
                  and np.array_equal(t_k.threshold, t_p.threshold))
    auc_k = _auc(booster.predict(Xv, raw_score=True), yv)
    auc_p = _auc(booster_p.predict(Xv, raw_score=True), yv)
    leaves = [t.num_leaves for t in booster._gbdt.models]
    rows_iters = N_TRAIN * N_ITERS / 1e6
    emit({"phase": "train", "card": card, "rows": N_TRAIN,
          "features": N_FEAT, "iterations": N_ITERS, "num_leaves": 255,
          "construct_s": construct_s,
          "kernel": {"s_per_tree": secs / N_ITERS,
                     "mrow_iters_per_s": rows_iters / secs,
                     "auc_holdout": auc_k},
          "plain": {"s_per_tree": secs_p / N_ITERS,
                    "mrow_iters_per_s": rows_iters / secs_p,
                    "auc_holdout": auc_p},
          "launches": launches,
          "hist_leaves_per_tree": launches["hist_leaves"] / N_ITERS,
          "leaves_per_tree": [min(leaves), max(leaves)],
          "tree0_identical": bool(same_tree0)})
    if abs(auc_k - auc_p) > AUC_TOL:
        raise AssertionError(f"AUC kernel {auc_k} vs plain {auc_p}")
    if not same_tree0:
        raise AssertionError("tree 0 differs between kernel and plain runs")
    if not auc_k > 0.75:
        raise AssertionError(f"held-out AUC {auc_k} below 0.75")
    return booster, Xv, launches


def phase_predict(booster, Xv):
    import lightgbm_tpu_torch as lgt
    p_mem = booster.predict(Xv)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "model.txt")
        booster.save_model(path)
        p_file = lgt.Booster(model_file=path, device="cuda").predict(Xv)
    if not (p_mem.shape == (len(Xv),) and np.isfinite(p_mem).all()
            and ((p_mem >= 0) & (p_mem <= 1)).all()):
        raise AssertionError("predictions are not finite probabilities")
    if not np.array_equal(p_mem, p_file):
        raise AssertionError("reloaded predictions differ from in-memory")
    emit({"phase": "predict", "rows": len(Xv), "bit_identical": True,
          "mean_p": float(p_mem.mean())})


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_profile(booster, card, iters: int = 3):
    """torch.profiler over a few more boosting iterations of the trained
    booster: device busy time by kernel, host time by op, kernel launches,
    host reads of device values, and the device's idle share of the wall
    time (with the profiler on).  The full tables go to
    ``chiprun_out/profile_train.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.ops import histogram as hist
    booster._gbdt.models                       # drain the pending trees
    torch.cuda.synchronize()
    hist.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            booster.update()
        booster._gbdt.models
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rounds = hist.launch_counts["hist_leaves"]
    ka = prof.key_averages()
    # device rows (kernels, copies) and host rows (ops, runtime calls); an
    # op's own row repeats its kernels' device time, so only device rows
    # are summed
    dev_rows = [e for e in ka if e.device_type != DeviceType.CPU]
    host_rows = [e for e in ka if e.device_type == DeviceType.CPU]
    busy_us = sum(_device_us(e) for e in dev_rows)
    by_dev = sorted(dev_rows, key=_device_us, reverse=True)
    by_cpu = sorted(host_rows, key=lambda e: e.self_cpu_time_total,
                    reverse=True)

    def count(*keys):
        return sum(e.count for e in host_rows if e.key in keys)
    # ops whose result the host reads back (a scalar, or a mask's size)
    reads = count("aten::_local_scalar_dense", "aten::nonzero")
    launches = count("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaLaunchKernelExC")
    host_us = sum(e.self_cpu_time_total for e in host_rows)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_train.txt"), "w") as fh:
        fh.write(f"{card}\n{iters} iterations, wall {wall_s:.6f} s\n")
        fh.write("\ndevice rows by device time: name, calls, device ms\n")
        for e in by_dev[:40]:
            fh.write(f"{e.key[:120]}\t{e.count}\t"
                     f"{_device_us(e) / 1e3:.3f}\n")
        fh.write("\nhost rows by host self time: name, calls, self ms, "
                 "total ms\n")
        for e in by_cpu[:40]:
            fh.write(f"{e.key}\t{e.count}\t{e.self_cpu_time_total / 1e3:.3f}"
                     f"\t{e.cpu_time_total / 1e3:.3f}\n")

    def top(events, fn, k=10):
        return [[e.key[:80], e.count, round(fn(e) / 1e3, 3)]
                for e in events[:k]]
    emit({"phase": "profile", "card": card, "iterations": iters,
          "wall_s_per_tree": wall_s / iters,
          "device_busy_s_per_tree": busy_us / 1e6 / iters,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
          "host_self_s_per_tree": host_us / 1e6 / iters,
          "rounds_per_tree": rounds / iters,
          "kernel_launches_per_tree": launches / iters,
          "host_reads_per_tree": reads / iters,
          "top_device_ms": top(by_dev, _device_us),
          "top_host_ms": top(by_cpu, lambda e: e.self_cpu_time_total)})


KERNEL_INFO = {
    "hist_full": ("lightgbm_tpu_torch/ops/kernels/hist_full.cu",
                  "lightgbm_tpu/ops/histogram.py:350",
                  "lightgbm_tpu/ops/histogram.py::_hist_pallas"),
    "hist_leaves": ("lightgbm_tpu_torch/ops/kernels/hist_leaves.cu",
                    "lightgbm_tpu/ops/histogram.py:226",
                    "lightgbm_tpu/ops/histogram.py::_hist_leaves_pallas"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few more iterations (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    kern = phase_kernels()
    booster, Xv, launches = phase_train(smi)
    phase_predict(booster, Xv)
    if args.profile:
        phase_profile(booster, smi)
    rows = []
    for kname, (src, replaces, jax_fn) in KERNEL_INFO.items():
        k = kern[kname]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "jax": jax_fn,
                     "launches": launches[kname],
                     "max_abs_err": k["max_abs_err"], "relerr": k["relerr"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"], "card": smi})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
