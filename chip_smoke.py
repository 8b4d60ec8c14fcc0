"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

(``--profile`` adds a torch.profiler phase over three more iterations and
writes its tables to ``chiprun_out/profile_train.txt``; the whole output
is also written to ``chiprun_out/chip_smoke.out``).

Drives ``lightgbm_tpu_torch``'s main path on the card, in phases, printing
one JSON line per phase; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the five histogram kernels from the sources in this
   checkout (one ``nvcc`` per source, all at once); then the sparse_efb
   phase's data (made first: the kernels phase uses its bundle matrix);
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (max relative error ``|a-b|/(|b|+1)`` <= 1e-5: both
   sum in float64 in different orders and round to float32 once), with
   per-launch times from CUDA events.  The atomic kernels (``hist_full``,
   ``hist_leaves``) within ``ATOMIC_REL_TOL`` (one float32 rounding step),
   the same NaNs and the same bits from two calls, with the share of
   entries bit-identical to the plain version, ``kernel_ms`` (the main and
   reduce kernels' device time a call), the ratio to ``index_add_``, the
   shared-memory floor beside the byte bound, and the plan's registers,
   spills, shared bytes, CTAs an SM and scratch partials; ``hist_full``
   also at an odd shape and on wide rows (20,011 x 700); ``hist_leaves``
   on three inputs:
   the random block->slot map, the same blocks slot by slot as the
   frontier lays a round out, and that layout with skewed bins (one
   feature in one bin, one in four).  The one-hot kernels for every
   variant the width
   serves, at B=256 (all but ``packed``) and B=64 (all eight):
   ``onehot_full`` in both layouts (``featmajor``, the root histogram of
   ``force_row_wise``; ``rowmajor``, which no entry point reaches) and
   ``onehot_leaves``, a NaN gradient in one leaf block making the same
   NaNs as the plain version.  Each one-hot row also gives its ratio to
   ``index_add_``, its kernel's registers a thread, spilled bytes, static
   and dynamic shared bytes (``cudaFuncGetAttributes``) and CTAs an SM
   (the occupancy calculator), and ``kernel_ms``, the kernel's own device
   time (torch.profiler), beside ``ms``, the time of the whole call; the
   int8 rows' times, registers and spills are also printed and gathered
   under ``int8``.  The one-hot kernels' u16 instantiations for the four
   bodies that serve widths above 256 (base, i16cmp, staged, int8), the
   same way plus the tensor-core floor: 1M x 28 at B = 1,024 in both
   layouts, one frontier round's comb at B = 1,024 (28 features + 6 u16
   gh columns, k = 16, an empty slot and a NaN block), and the sparse_efb
   phase's bundle matrix (featmajor) at its bundle width.  The atomic
   kernels' u16 instantiations the same way (relerr, same bits twice, ms,
   kernel alone, plain, ``index_add_``, the byte bound at 2 bytes a bin,
   the plan with its design, feature group, warps a feature and warps an
   SM): 1M x 28 at B = 1,024 with random bins and with Zipf-skewed bins,
   and one frontier round's comb (28 features + 6 u16 gh columns), bins
   >= B present; a comb of odd stride (27 + 6 u16); the sparse_efb
   phase's own bundle matrix at its bundle width, full and per leaf; and
   the widths at which not even one feature's histogram fits a CTA, B =
   12,000, 16,384 and 65,536 (bin tiles), 1M x 28 and one round's comb,
   with random bins (bin 65,535 present) and Zipf-skewed ones, bit for bit
   the plain version, each with its bin tiles and scratch bytes; one-hot
   ``staged`` at B = 65,536 on 1M x 28 beside them;
4. quant: the int8 quantize kernel (``onehot_quant``) bit-identical to its
   plain version at the main path's blocks (1M rows per 1024 and per 512,
   the leaves' 262,144 rows per 512 with a NaN block), in both input
   forms: grad, hess and mask (the int8 wrappers' fused pre-pass, which
   must launch once a call) and prepped rows (the shootout shell's); each
   case with both forms' ``ms`` a call, kernel alone and launches a call,
   the plain version's time, the kernel's registers and spills, and the
   byte bound;
5. shootout: the shootout shell's entry (``onehot_bench``, the JAX
   package's ``make_bench_kernel``) once per election candidate at B=256,
   B=64 and B=1,024 (u16 bins), on the shootout's shape (1,001,472 x 28,
   BR=512), against its plain version, with the same ratio and
   attributes;
6. elect: ``hist_variant=auto``'s election at B=256, B=64 and B=1,024:
   every candidate's time and error (none may be disqualified), the
   winner, and a second call served from the cache without a launch;
7. train: binary GBDT on 1,000,000 x 28 Higgs-shaped rows, 255 leaves,
   ``max_bin=255``, 20 iterations, three times: by default (the atomic
   kernels), with ``force_row_wise=True, hist_variant="staged"`` and with
   ``hist_variant="int8"`` (the one-hot kernels).  Each runs once through
   the kernels (launch counts from zero around that run) and once with
   ``force_plain()``; held-out AUC within 1e-3 of the plain run (and the
   one-hot runs' of the atomic run's), tree 0 identical to the plain run's
   for the atomic and int8 runs.  Then ``force_row_wise=True`` with no
   ``hist_variant`` (so ``auto``) for 5 iterations, which trains with the
   elected variant, and a ``packed`` run at ``max_bin=63`` on 200,000 rows
   for 5 iterations;
7b. obs: the observability plane on the train phase's rows, 255 leaves,
   ``max_bin=255``, 10 iterations, once with telemetry off and once with
   ``obs_telemetry=True, obs_health_check_iters=1, obs_health_port=<a
   free port>`` (journal and flight dumps in a temporary directory):
   the same model text (the parameters section aside) and the same
   ``hist_full``/``hist_leaves`` launches, s/tree of both and the
   overhead (not gated); one ``train_iter`` an iteration with its phase
   seconds and device memory (peak >= in use > 0), one ``train_tree`` a
   tree, one passing ``numeric_health`` an iteration; the
   ``train.grow_tree`` roofline on the ``h100`` row (``hbm_util`` <=
   1.05); ``/metrics`` and ``/healthz`` fetched over HTTP from a callback
   at two iterations, the second's ``iteration`` later; ``python -m
   lightgbm_tpu_torch obs-report --roofline`` renders the grow row and
   ``--regressions --gate`` exits 0; a NaN-gradient objective under
   ``LGBM_FLIGHT_DIR`` raises ``DivergenceError`` at iteration 0 with a
   flight dump; a torch.profiler window over 2 iterations with
   ``obs_trace_device=True`` shows the ``lgbm/hist`` and
   ``lgbm/split_search`` ranges;
8. serial: ``tree_grower=serial`` (the sequential grower) on the train
   phase's 1M rows at 63 leaves, 5 iterations, by default (``hist_full``)
   and with ``force_row_wise=True, hist_variant="staged"``
   (``onehot_full``): one launch for the root and one a split, never a
   per-leaf kernel, the same leaf for every held-out row as the default
   frontier run; then on 200,000 rows, 3 iterations each, interaction
   constraints, a forced-splits file (the forced nodes land), CEGB (the
   split and coupled penalties), monotone intermediate and advanced
   (monotone along feature 0), ``linear_tree`` and ``feature_contri`` on
   the frontier.  Each run once through the kernels and once under
   ``force_plain()``, tree 0 identical, held-out AUC within 1e-3 and
   above 0.5, printing s/tree and launches/tree.  Then K1 on the serial
   grower's own inputs: two split histograms' arguments recorded from a
   1M-row serial tree (the root's first child and split 40: a permuted,
   ragged parent segment of 40-byte rows, 28 bin columns and g, h, w,
   the side as the mask, ``f_limit=28``), ``hist_full`` within
   ``ATOMIC_REL_TOL`` and ``onehot_full`` staged within 1e-5 of their
   plain versions, timed (``serial_blocks`` in the K1 rows of the
   ``kernels`` line); and torch.profiler over two serial iterations at
   1M and 200k rows (device busy and ``hist_full`` time a tree, idle
   share, device launches and copies to the host a tree).  Last,
   ``LGBMClassifier(device="cuda")`` (the stand-in bases where sklearn is
   absent) fits and predicts 200,000 rows bit for bit as ``train``;
9. knobs: the training knobs, objectives and boosting types on the atomic
   kernels, each run once through the kernels (launch counts from zero
   around it, ``hist_full`` and ``hist_leaves`` and no other) and once
   under ``force_plain()``: tree 0 identical, the held-out metric within
   tolerance of the plain run's and better than the constant model's.
   First the card's counter-based draws (a 1M-row bagging uniform, a
   bynode draw) bit-identical to the CPU's.  On the train phase's 1M rows:
   the binary example's bagging (0.8 every 5, a masked bag) and
   ``feature_fraction=0.8``, 20 iterations; a compacted bag (0.5 every
   iteration) with ``feature_fraction_bynode=0.8`` and ``extra_trees``, 10
   iterations, every ``hist_full`` on ``cap`` rows; GOSS, 10; 5 classes
   from quantiles of the generator's latent score with the multiclass
   example's settings, 10 iterations (50 ``hist_full`` launches); L2 with
   the regression example's, 20.  On 200,000 rows: L1 (leaf renewal), 5
   iterations; DART and RF, 10 each; monotone-basic (+1 on feature 0), 10,
   with predictions monotone along it.  Each run prints s/tree,
   launches/tree and ``cap``;
10. predict: ``save_model`` -> ``Booster(model_file=...)`` predicts
   bit-identically to the booster in memory, for the 1M-row boosters;
10b. serve: the train phase's default model frozen into a
   ``PredictorArtifact`` with the default buckets (1,024, 16,384 and
   262,144 rows, one captured CUDA graph each): raw and transformed
   predictions bit for bit ``Booster.predict`` (``pred_device=device``)
   at 1, 1,023, 1,024, 1,025, 16,384 and 300,000 rows, a padded row as in
   its full bucket, three captures before and after every request,
   save/load, the parity gate; a ``MicroBatcher`` under 8 threads x 200
   requests of 1-64 rows (every answer the artifact's, more than one
   request a batch), a hot swap under that load to a 10-iteration model
   (nothing dropped or failed), an artifact with doubled leaf values
   refused by the gate and rolled back; each bucket's p50/p99 ms against
   the eager ``Booster.predict``, launch calls a request (torch.profiler),
   capture seconds and graph pool bytes;
10c. stream: the train phase's rows out of core under an 8 MB budget
   (17 blocks of 60,544 rows, prefetch 2), 255 leaves, 3 iterations: the
   trees of ``tree_grower=serial`` in memory (splits, thresholds,
   counts), predictions within 1e-5, peak block bytes within the budget,
   puts + skipped = passes x 17, ``hist_full`` on a streamed block bit
   for bit its plain version, a repeat run with the same trees (timed on
   both streams: the share of copy time hidden behind compute);
   ``force_row_wise`` staged and u16 (``max_bin=1023``) streamed runs on
   200k rows, 63 leaves, 1 iteration, within 1e-3 AUC of their in-memory
   runs (``--only serve,stream`` runs these two phases alone);
11-15. data breadth, each run once through the kernels (launch counts
   from zero around it: ``hist_full`` and ``hist_leaves`` and no other;
   the force_row_wise runs the one-hot kernels named below)
   and once under ``force_plain()``, tree 0 identical, the held-out
   metric within 1e-3 of the plain run's and better than the constant
   model's, the reloaded model predicting bit-identically, each printing
   s/tree, launches a tree and the kernel width: rank (MS LTR width, 1M x
   137, queries of ~120 documents and one of 1,251, lambdarank with the
   Experiments settings for 5 iterations, then rank_xendcg for 3, NDCG@5
   held out, the card's xendcg draw equal to the CPU's); categorical
   (the airline data's 1M x 8, six categorical columns, 255 leaves, 5
   iterations at max_cat_to_onehot 4 and 8: sorted subsets, and
   DayOfWeek's one-hot splits at 8); wide_bins (Higgs 1M x 28 at
   max_bin=1023, u16, B = 1,024; then ``force_row_wise`` with staged and
   int8, 5 iterations each, and auto, 3: ``onehot_full`` once a tree and
   ``onehot_leaves``, held-out AUC also within 1e-3 of the atomic run's
   at the same iterations); sparse_efb (Allstate width, 250k x 4,228 CSR,
   bundled into u16 columns, the kernels at the bundle width, CSR
   prediction equal to dense; then ``force_row_wise`` staged, 3
   iterations: ``onehot_full`` once a tree, its per-leaf histograms by
   ``hist_leaves``, outside the leaves cut); widest_bins (Higgs 1M x 28
   at max_bin=65535, the JAX package's widest: the atomic kernels at B =
   65,536 in 8 bin tiles of 8,192 a feature, 255 leaves, 5 iterations,
   then ``force_row_wise`` staged, 3: ``onehot_full`` at B = 65,536 once a
   tree and the per-leaf histograms by ``hist_leaves``; the plans' scratch
   bytes and the phase's peak device memory);
16. engine: the engine surface on the generator's 1M x 28 (``max_bin``
   255), each float32 value written to nine digits as TSV with the label
   in column 0 and a ``.weight`` sidecar (in a temporary directory; the
   writing and the native parse timed apart, as set-up): the command line
   (``application.main``) on ``examples/binary_classification/train.conf``
   with ``num_trees=20``, its ``hist_full``/``hist_leaves`` launches
   counted from zero around it; its trees equal line for line to
   ``lgt.train`` on the parsed matrix and the weights; the predict task's
   file bit for bit ``Booster.predict`` on the held-out file; held-out AUC
   within 1e-3 of a ``force_plain()`` run and above 0.5; the native
   library used, its parse equal to numpy's; convert_model writes code;
   the binary cache trains tree 0 again; 7 + 13 iterations from a saved
   model (the split inside a bagging period) within 1e-5 of 20, and a
   rollback plus an update reproduce the
   last tree; a custom logloss within 1e-3 AUC of the builtin one without
   boost-from-average; 3-fold ``cv`` on 300k rows within 1e-3 of plain;
   ``pred_contrib`` on 10k rows summing to the raw score within 1e-5; and
   refit on the held-out rows.

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

# the H100 SXM's peaks (HBM3 bandwidth, f32 outside the tensor cores,
# dense bf16 and int8 in them) come from the port's one peak table,
# lightgbm_tpu_torch/obs/costs.py:PEAK_RATES["h100"] (peak_rates())
REL_TOL = 1e-5
# the atomic kernels sum in float64 and round once, as their plain
# versions do: at most one float32 rounding step apart
ATOMIC_REL_TOL = 1.2e-7
# shared-memory bytes an SM moves a clock: the atomic kernels' update
# floor is one read-add-write of three float64 values (48 bytes) per
# (row, feature) at this rate on every SM
SMEM_BYTES_PER_CLK = 128
# the kernels a call of each atomic wrapper launches (profiler names)
ATOMIC_KERNELS = {"hist_full": ("hist_full_kernel", "hist_reduce_kernel"),
                  "hist_leaves": ("hist_leaves_kernel",
                                  "hist_reduce_kernel")}
AUC_TOL = 1e-3
N_TRAIN, N_VALID, N_FEAT, N_ITERS = 1_000_000, 100_000, 28, 20
# the packed run: a smaller one at the width packing serves
N_PACKED, ITERS_PACKED = 200_000, 5
# the knobs phase's smaller runs (L1, DART, RF, monotone)
N_SMALL = 200_000
# one frontier round's batched smaller-child histograms
LEAVES_SHAPE = dict(C=262_144, NC=40, f=28, k=16, BR=512)
# the JAX shootout's shape (scripts/bench_onehot_variants.py): 1M rows
# padded to a multiple of 2048, 28 features, every family at BR=512
SHOOTOUT_SHAPE = dict(N=1_001_472, rows=1_000_000, f=28, BR=512)
ITERS_AUTO = 5
# the data-breadth phases (LightGBM's docs/Experiments.rst shapes, cut in
# rows): MS LTR (MSLR-WEB30K: 2,270,296 x 137, queries of ~120 documents,
# the longest 1,251) to 1M rows; the airline on-time data of
# szilard/benchm-ml (train-1m: 1M x 8, six categorical); Higgs at
# max_bin=1023; Allstate (13,184,290 x 4,228 one-hot sparse) to 250k rows
MSLR_SHAPE = dict(rows=1_000_000, valid=100_000, features=137,
                  longest=1251, docs=(20, 220))
N_AIRLINE, N_AIRLINE_VALID = 1_000_000, 100_000
N_ALLSTATE, N_ALLSTATE_VALID = 250_000, 50_000
# Allstate's one-hot groups (Blind_Submodel, Blind_Model, Blind_Make,
# Model_Year, NVCat, the Cat columns, OrdCat, Calendar_Year) and its 12
# numeric columns (Var1-8, NVVar1-4): 4,216 + 12 = 4,228 columns
ALLSTATE_GROUPS = (2700, 1250, 117, 30, 20, 16, 12, 10, 8, 7, 6, 5, 5, 4, 4,
                   4, 3, 3, 3, 3, 2, 2, 2)
ALLSTATE_NUMERIC = 12
# the seeds of the synthetic effects of categories and levels, the same
# for the training and held-out samples
AIRLINE_EFFECT_SEED, ALLSTATE_EFFECT_SEED = 1050, 1046
ITERS_BREADTH = 5
# the force_row_wise runs of the data-breadth phases: auto at max_bin=1023,
# and staged on the sparse_efb bundles
ITERS_WIDE_AUTO = 3
ITERS_EFB_ROW_WISE = 3
# the atomic kernels' widths above one feature's CTA (bin tiles), held in
# the kernels phase; the widest_bins phase trains at the widest
# (max_bin=65535: B = 65,536), atomic and by force_row_wise staged
WIDE_WIDTHS = (12_000, 16_384, 65_536)
MAX_BIN_WIDEST = 65_535
ITERS_WIDEST_ROW_WISE = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def higgs_latent(X):
    """The generator's latent score (its logit before the logistic noise)."""
    return (1.2 * X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 3]
            + 0.5 * np.sin(3.0 * X[:, 4]) + 0.3 * X[:, 5] ** 2)


def make_higgs_like(n_rows: int, n_feat: int = 28, seed: int = 42):
    """Synthetic stand-in with Higgs geometry (dense floats, ~even classes);
    the same generator as the repository's ``bench.py``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    y = (higgs_latent(X) + rng.logistic(size=n_rows) > 0).astype(np.float32)
    return X, y


def make_mslr_like(n_rows: int, n_feat: int, seed: int, longest: int = 1251,
                   docs=(20, 220)):
    """MS LTR geometry: dense float features, queries of ``docs`` documents
    (uniform, mean ~120) and one of ``longest``, labels 0-4 from a latent
    score with MSLR's skew (~52% 0, 32% 1, 13% 2, 2% 3, 1% 4).  Returns
    ``(X, y, query sizes)``."""
    rng = np.random.default_rng(seed)
    sizes = [min(longest, n_rows)]
    left = n_rows - sizes[0]
    while left > 0:
        s = min(int(rng.integers(docs[0], docs[1] + 1)), left)
        sizes.append(s)
        left -= s
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    # a per-query shift, as real queries differ in how relevant their
    # candidates are
    qshift = np.repeat(rng.normal(size=len(sizes)) * 0.5, sizes)
    lat = (X[:, 0] + 0.7 * X[:, 1] - 0.5 * X[:, 2] * X[:, 3]
           + 0.4 * np.sin(2.0 * X[:, 4]) + qshift
           + 0.5 * rng.normal(size=n_rows))
    y = np.digitize(lat, np.quantile(lat, [0.52, 0.84, 0.97, 0.99]))
    return X, y.astype(np.float32), np.asarray(sizes, np.int64)


def _zipf_choice(rng, k: int, n: int, a: float = 0.8) -> np.ndarray:
    """``n`` draws of ``k`` levels, level ``i`` with weight 1/(i+1)^a."""
    p = 1.0 / np.arange(1, k + 1) ** a
    return rng.choice(k, n, p=p / p.sum())


def make_airline_like(n_rows: int, seed: int):
    """The airline on-time data's 8 columns (szilard/benchm-ml train-1m):
    Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin, Dest as category
    codes (12, 31, 7, 22, 300, 300 levels; carriers and airports by
    popularity), DepTime (hhmm) and Distance; ``dep_delayed_15min`` (~19%
    positive) from a latent of them."""
    rng = np.random.default_rng(seed)
    month = rng.integers(1, 13, n_rows)
    dom = rng.integers(1, 32, n_rows)
    dow = rng.integers(1, 8, n_rows)
    carrier = _zipf_choice(rng, 22, n_rows)
    origin = _zipf_choice(rng, 300, n_rows)
    dest = _zipf_choice(rng, 300, n_rows)
    hour = np.clip(rng.normal(13.5, 4.5, n_rows), 5, 23.98)
    dep = np.floor(hour) * 100 + np.floor((hour % 1) * 60)
    dist = np.clip(rng.lognormal(6.4, 0.6, n_rows), 30, 4900)
    # the categories' effects: one draw for every sample, so a held-out
    # set follows the training set's law
    eff = np.random.default_rng(AIRLINE_EFFECT_SEED)
    e_car, e_apt = eff.normal(0, 0.4, 22), eff.normal(0, 0.5, 300)
    e_dst, e_mon = eff.normal(0, 0.3, 300), eff.normal(0, 0.3, 13)
    e_dow = eff.normal(0, 0.2, 8)
    lat = (0.12 * (hour - 13.5) + e_car[carrier] + e_apt[origin]
           + e_dst[dest] + e_mon[month] + e_dow[dow]
           + 0.1 * np.log(dist / 600.0) + rng.logistic(size=n_rows))
    y = (lat > np.quantile(lat, 0.81)).astype(np.float32)
    X = np.stack([month, dom, dow, carrier, origin, dest, dep, dist],
                 1).astype(np.float32)
    return X, y


def make_allstate_like(n_rows: int, seed: int):
    """Allstate's geometry as CSR: ``ALLSTATE_GROUPS`` one-hot blocks (one
    level a row, levels by popularity; 5% of rows miss a block) and
    ``ALLSTATE_NUMERIC`` dense numeric columns, 4,228 columns in all; a
    binary claim label (~30% positive) from a latent of both."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    eff = np.random.default_rng(ALLSTATE_EFFECT_SEED)    # as the airline's
    rows, cols, vals, lat, off = [], [], [], np.zeros(n_rows), 0
    for g in ALLSTATE_GROUPS:
        lvl = _zipf_choice(rng, g, n_rows)
        keep = rng.random(n_rows) >= 0.05
        rows.append(np.flatnonzero(keep))
        cols.append(off + lvl[keep])
        vals.append(np.ones(int(keep.sum())))
        lat += np.where(keep, eff.normal(0, 0.6, g)[lvl], 0.0)
        off += g
    num = rng.normal(size=(n_rows, ALLSTATE_NUMERIC))
    for j in range(ALLSTATE_NUMERIC):
        rows.append(np.arange(n_rows))
        cols.append(np.full(n_rows, off + j))
        vals.append(num[:, j])
    lat += 0.6 * num[:, 0] - 0.4 * num[:, 1] * num[:, 2]
    X = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n_rows, off + ALLSTATE_NUMERIC))
    y = (lat + rng.logistic(size=n_rows)
         > np.quantile(lat, 0.6)).astype(np.float32)
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


def peak_rates() -> dict:
    """The H100 row of the port's peak table (per second)."""
    from lightgbm_tpu_torch.obs import costs
    return costs.PEAK_RATES["h100"]


def bound(nbytes: float, nflops: float):
    peak = peak_rates()
    t_bytes = nbytes / peak["bytes_per_sec"] * 1e3
    t_ops = nflops / peak["f32_flops"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tensor_core_floor_ms(lanes: int, rows: int, variant: str) -> float:
    """The one-hot design's own floor: mma does 2 operations for each of
    its N columns, each lane and each row, at the dense peak of its type:
    8 columns (6 channel rows used) in bf16, or for int8 two n8 tiles (9
    channel rows used) at the int8 peak."""
    peak = peak_rates()
    if variant == "int8":
        return 32.0 * lanes * rows / peak["int8_ops"] * 1e3
    return 16.0 * lanes * rows / peak["flops"] * 1e3


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "clock_max_sm_mhz": clock,
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi, clock


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


def _atomic_stats(got, again, ref):
    """An atomic kernel's result against its plain version: relerr and the
    largest error on the finite entries, the NaN pattern, the same bits
    from a second call, and the share of finite entries that are
    bit-identical to the plain version's."""
    fin = torch.isfinite(ref)
    return dict(
        relerr=relerr(got[fin], ref[fin]),
        max_abs_err=float((got[fin] - ref[fin]).abs().max()),
        nan_equal=bool(torch.equal(torch.isnan(got), torch.isnan(ref))),
        same_bits_twice=bool(torch.equal(got.view(torch.int32),
                                         again.view(torch.int32))),
        bit_identical_share=float((got[fin] == ref[fin]).float().mean()))


def _hold_atomic(name, st):
    if not (st["relerr"] <= ATOMIC_REL_TOL and st["nan_equal"]
            and st["same_bits_twice"]):
        raise AssertionError(f"{name}: {st}")


def _check_full(hist, gen, dev, n, f, B):
    bins = torch.randint(0, B, (n, f), generator=gen, device=dev,
                         dtype=torch.uint8)
    g, h, m = _rows(gen, n, dev)
    with hist.force_plain():
        ref = hist.build_histogram(bins, g, h, m, B)
    got = hist.hist_full(bins, g, h, m, B)
    again = hist.hist_full(bins, g, h, m, B)
    torch.cuda.synchronize()
    st = _atomic_stats(got, again, ref)
    _hold_atomic(f"hist_full {n}x{f}x{B}", st)
    return bins, g, h, m, st


def smem_floor_ms(rows, feats, clock_mhz, sms):
    """The atomic kernels' update floor: 48 bytes a (row, feature) through
    shared memory at SMEM_BYTES_PER_CLK on each of ``sms`` SMs at the
    card's highest SM clock."""
    return (48.0 * rows * feats / (SMEM_BYTES_PER_CLK * sms * clock_mhz * 1e6)
            * 1e3)


# torch.profiler on the card now and then closes a window without the
# kernels that ran in it (no device event at all, or none of the kernel
# asked for): such a window is taken again, up to this many times in all
PROFILE_TRIES = 5


def _window_ok(rows, want, tries_left):
    """True when a profile window's device rows are usable: not empty, and
    holding a kernel whose name holds one of ``want`` (if given).  A
    window that is not is reported on standard error."""
    if rows and (not want or any(n in e.key for e in rows for n in want)):
        return True
    print(f"torch.profiler: a window held {len(rows)} device rows and none "
          f"of {list(want) or 'any'}; {tries_left} more tries",
          file=sys.stderr, flush=True)
    return False


def _device_rows(fn, reps: int, want=()):
    """torch.profiler's device rows (kernels, copies, fills) over ``reps``
    calls of ``fn``, after one call outside the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU]
        if _window_ok(rows, want, PROFILE_TRIES - 1 - t):
            break
    return rows


def calls_ms(fn, names, reps: int = 10):
    """Device time per call of the kernels whose names hold one of
    ``names`` (torch.profiler over ``reps`` calls): a wrapper's kernels
    alone, without its host work and allocations.  None when the profiler
    records no launch of them."""
    rows = [e for e in _device_rows(fn, reps, names)
            if any(n in e.key for n in names)]
    if not rows:
        return None
    return sum(_device_us(e) for e in rows) / 1e3 / reps


def launches_per_call(fn, reps: int = 10, want=()) -> float:
    """Device launches a call of ``fn``, of any kernel, copy or fill
    (``want``: the kernels the window must show, as in ``_device_rows``)."""
    return sum(e.count for e in _device_rows(fn, reps, want)) / reps


def _skewed_bins(comb):
    """Every row of feature 0 in one bin, feature 1 in four: the worst
    case for lanes that share a bin."""
    out = comb.clone()
    out[:, 0] = 7
    out[:, 1] = (comb[:, 1] & 3) * 60 + 3
    return out


def _atomic_attrs(hist, kernel, dev, units, stride, f, B, k=1, esz=1):
    """The launch plan's geometry and design, its kernel's registers,
    spills, shared bytes and CTAs an SM, the warps an SM and the warps
    that add rows a feature (``W``: the owned design's warps own whole
    features; the dealt design's item warps share the group's features),
    the bin tiles of a feature and the bins each holds, and the float64
    partials a call writes (one a CTA along x for the full pass; for the
    leaves one a CTA for each slot its blocks may name, min(blocks a CTA,
    k)) with their scratch bytes."""
    plan = hist.atomic_plan(kernel, dev, stride, f, B, esz)
    grid_x, _, partials = hist.atomic_partials(kernel, plan, units, k)
    warps = plan["threads"] // 32
    return {**{x: plan[x] for x in ("registers", "local_bytes",
                                    "static_smem_bytes",
                                    "dynamic_smem_bytes", "ctas_per_sm",
                                    "fg", "tile", "threads", "stagers",
                                    "tiles", "tile_bins")},
            "design": hist.ATOMIC_DESIGNS[plan["design"]],
            "warps_per_sm": warps * plan["ctas_per_sm"],
            "W": (warps - plan["stagers"]) / plan["fg"],
            "grid_x": grid_x, "partials": partials,
            "scratch_bytes": partials * f * B * 3 * 8}


def _index_add_ms(dev, flat, vals, size):
    """The library yardstick: one float32 ``index_add_`` of every (row,
    feature) value into its (slot, feature, bin) row."""
    out = torch.zeros(size, 3, device=dev)
    return median_ms(lambda: out.index_add_(0, flat, vals))


def _full_yardstick(dev, bins, g, h, m, B):
    from lightgbm_tpu_torch.ops.histogram import widen_bins
    n, f = bins.shape
    b = widen_bins(bins)             # a uint8 compare with 256 wraps to 0
    keep = (b < B).reshape(-1)
    flat = (b + B * torch.arange(f, device=dev)).reshape(-1)[keep]
    vals = torch.stack([g * m, h * m, m], 1)[:, None, :].expand(n, f, 3) \
        .reshape(-1, 3)[keep].contiguous()
    return _index_add_ms(dev, flat, vals, f * B)


def _leaves_yardstick(dev, comb, g, h, m, block_leaf, k, B, BR, fl):
    C = comb.shape[0]
    from lightgbm_tpu_torch.ops.histogram import widen_bins
    row_leaf = block_leaf.long().repeat_interleave(BR)
    b = widen_bins(comb[:, :fl])
    keep = (b < B).reshape(-1)
    flat = ((row_leaf[:, None] * fl + torch.arange(fl, device=dev)) * B
            + b).reshape(-1)[keep]
    vals = torch.stack([g * m, h * m, m], 1)[:, None, :].expand(C, fl, 3) \
        .reshape(-1, 3)[keep].contiguous()
    return _index_add_ms(dev, flat, vals, k * fl * B)


def _f4(ms):
    """A kernel-alone time for a log line ("not measured" when the
    profiler never showed the kernel)."""
    return "not measured" if ms is None else f"{ms:.4f}"


def kernel_ms(fn, match, reps: int = 10):
    """Mean device time of one launch of the kernel whose name holds
    ``match`` (a name, or a tuple of names of which a call launches one):
    the kernel alone, without the wrapper's host work and small torch ops
    that ``ms`` includes.  None when the profiler records no launch of
    it."""
    return calls_ms(fn, match if isinstance(match, tuple) else (match,),
                    reps)


def _vs_library(row, attrs, fn, match):
    """The row's ratio to ``index_add_``, its kernel's attributes and its
    kernel-only time."""
    row["vs_index_add"] = row["ms"] / row["library_ms"]
    row["kernel_ms"] = kernel_ms(fn, match)
    row.update(attrs)
    return row


def _kernel_name(kernel, variant):
    """The CUDA functions a one-hot row may launch, one a call: the dense
    design's (int8: its own kernel) and the bucketed design's (u16 bins;
    int8 is its template's body 7)."""
    return (kernel + ("_int8_kernel" if variant == "int8" else "_kernel"),
            kernel + ("_bucket_kernel<7" if variant == "int8"
                      else "_bucket_kernel<"))


def _leaves_inputs(gen, dev):
    """One frontier round's shapes: unsorted block->slot map with slot 5
    empty, and a NaN gradient in block 100."""
    C, NC, k, BR = (LEAVES_SHAPE[x] for x in ("C", "NC", "k", "BR"))
    nb = C // BR
    comb = torch.randint(0, 256, (C, NC), generator=gen, device=dev,
                         dtype=torch.uint8)
    g, h, m = _rows(gen, C, dev)
    empty, nan_block = 5, 100
    slots = torch.tensor([s for s in range(k) if s != empty], device=dev)
    block_leaf = slots[torch.randint(0, k - 1, (nb,), generator=gen,
                                     device=dev)].to(torch.int32)
    g[nan_block * BR + 7] = float("nan")
    return comb, g, h, m, block_leaf, empty, int(block_leaf[nan_block])


def _u16(gen, shape, hi, dev):
    """u16 bins in [0, hi) with a tenth raised to 40,000-65,535 (past any
    B: dropped), a CUDA uint16 tensor."""
    b = torch.randint(0, hi, shape, generator=gen, device=dev,
                      dtype=torch.int32)
    high = torch.rand(shape, generator=gen, device=dev) < 0.1
    b = torch.where(high, torch.randint(40_000, 65_536, shape, generator=gen,
                                        device=dev, dtype=torch.int32), b)
    return b.to(torch.int16).view(torch.uint16)


def _zipf_u16(gen, shape, B, dev, a=1.1):
    """u16 bins in [0, B), bin i drawn with weight 1/(i+1)^a: a few bins
    hold most rows, as an EFB bundle's do."""
    p = 1.0 / torch.arange(1, B + 1, device=dev, dtype=torch.float64) ** a
    idx = torch.multinomial(p.float(), shape[0] * shape[1], replacement=True,
                            generator=gen)
    return idx.view(shape).to(torch.int16).view(torch.uint16)


def _wide_u16(gen, shape, B, dev, kind):
    """u16 bins for a width above one feature's CTA (bin tiles): uniform
    over [0, B) with a tenth raised to [min(B, 65,535), 65,536) (dropped
    below B = 65,536; at 65,536 the top bin, the dealt design's sentinel
    value), or Zipf-skewed over [0, B) (bin i with weight 1/(i+1)^1.1: most
    rows in a few low bins, so most steps of a high bin tile hold no row
    of it); every column holds bin 65,535 (row 3) and bin B - 1 (row 11)."""
    if kind == "zipf":
        p = 1.0 / torch.arange(1, B + 1, device=dev,
                               dtype=torch.float64) ** 1.1
        b = torch.multinomial(p.float(), shape[0] * shape[1],
                              replacement=True, generator=gen).view(shape)
    else:
        b = torch.randint(0, B, shape, generator=gen, device=dev)
        high = torch.rand(shape, generator=gen, device=dev) < 0.1
        b = torch.where(high, torch.randint(min(B, 65_535), 65_536, shape,
                                            generator=gen, device=dev), b)
    b[3], b[11] = 65_535, B - 1
    return b.to(torch.int32).to(torch.int16).view(torch.uint16)


def _frontier_comb(bins, g, h, m):
    """The frontier's row payload: bins, then (g, h, m) as 12 bytes in
    bin-typed columns (6 u16)."""
    from lightgbm_tpu_torch.ops.histogram import movable_bins
    mv = movable_bins(bins)
    gh = torch.stack([g, h, m], 1).contiguous().view(mv.dtype)
    return torch.cat([mv, gh], 1).view(bins.dtype)


def _u16_cases(hist, gen, dev, clock_mhz, sms, efb_bins):
    """The atomic kernels' u16 instantiations against their plain versions:
    1M x 28 at B = 1,024 (max_bin=1023) with random bins and with
    Zipf-skewed bins, and one frontier round's comb of 28 features and 6
    gh columns; a comb of odd stride (27 + 6 = 33 u16, 66 bytes: rows
    2-byte aligned); the sparse_efb phase's own bundle matrix at its
    bundle width, full and per leaf; and at the widths above one feature's
    CTA, B = 12,000, 16,384 and 65,536 (bin tiles: 2, 2 and 8 a feature),
    1M x 28 and one round's comb with random and Zipf-skewed bins
    (``_wide_u16``), bit for bit the plain version.  Bins >= B are present
    in the random cases.  Each: relerr, the same bits twice, ms, kernel
    alone, plain, index_add_, the byte bound (2 bytes a bin) and the plan
    with its design, feature group, warps a feature (W), warps an SM, bin
    tiles and scratch bytes."""
    out = {}
    k, BR = LEAVES_SHAPE["k"], LEAVES_SHAPE["BR"]

    def exact(name, st):
        if st["bit_identical_share"] != 1.0:
            raise AssertionError(f"{name}: not bit for bit the plain "
                                 f"version: {st}")

    def hold_full(name, bins, B, f, bits=False):
        n = bins.shape[0]
        g, h, m = _rows(gen, n, dev)
        with hist.force_plain():
            ref = hist.build_histogram(bins, g, h, m, B, f_limit=f)
        got = hist.hist_full(bins, g, h, m, B, f_limit=f)
        again = hist.hist_full(bins, g, h, m, B, f_limit=f)
        torch.cuda.synchronize()
        st = _atomic_stats(got, again, ref)
        _hold_atomic(name, st)
        if bits:
            exact(name, st)

        def call():
            return hist.hist_full(bins, g, h, m, B, f_limit=f)
        with hist.force_plain():
            plain_ms = median_ms(lambda: hist.build_histogram(
                bins, g, h, m, B, f_limit=f), reps=5)
        b_ms, b_by = bound(2 * n * f + 12 * n + f * B * 12,
                           3 * n * f + 2 * n)
        ms = median_ms(call)
        lib = _full_yardstick(dev, bins[:, :f].contiguous(), g, h, m, B)
        out[name] = dict(
            shape=[n, bins.shape[1], f, B], dtype="uint16", **st, ms=ms,
            kernel_ms=calls_ms(call, ATOMIC_KERNELS["hist_full"]),
            plain_ms=plain_ms, library_ms=lib, vs_index_add=ms / lib,
            bound_ms=b_ms, bound_by=b_by,
            smem_floor_ms=smem_floor_ms(n, f, clock_mhz, sms),
            **_atomic_attrs(hist, "hist_full", dev, n, bins.shape[1], f, B,
                            esz=2))

    def hold_leaves(name, comb, B, f, timed=True, bits=False):
        C = comb.shape[0]
        nb = C // BR
        g, h, m = _rows(gen, C, dev)
        bl = torch.sort(torch.randint(0, k, (nb,), generator=gen,
                                      device=dev)).values.to(torch.int32)
        kw = dict(block_rows=BR, f_limit=f)
        with hist.force_plain():
            ref = hist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
        got = hist.hist_leaves(comb, g, h, m, bl, k, B, **kw)
        again = hist.hist_leaves(comb, g, h, m, bl, k, B, **kw)
        torch.cuda.synchronize()
        st = _atomic_stats(got, again, ref)
        _hold_atomic(name, st)
        if bits:
            exact(name, st)
        out[name] = dict(shape=[C, comb.shape[1], f, k, BR, B],
                         dtype="uint16", **st)
        if not timed:
            return

        def call():
            return hist.hist_leaves(comb, g, h, m, bl, k, B, **kw)
        with hist.force_plain():
            plain_ms = median_ms(lambda: hist.build_histogram_leaves(
                comb, g, h, m, bl, k, B, **kw), reps=5)
        b_ms, b_by = bound(2 * C * f + 12 * C + 4 * nb + k * f * B * 12,
                           3 * C * f + 2 * C)
        ms = median_ms(call)
        lib = _leaves_yardstick(dev, comb, g, h, m, bl, k, B, BR, f)
        out[name].update(
            ms=ms, kernel_ms=calls_ms(call, ATOMIC_KERNELS["hist_leaves"]),
            plain_ms=plain_ms, library_ms=lib, vs_index_add=ms / lib,
            bound_ms=b_ms, bound_by=b_by,
            smem_floor_ms=smem_floor_ms(C, f, clock_mhz, sms),
            **_atomic_attrs(hist, "hist_leaves", dev, nb, comb.shape[1], f,
                            B, k, esz=2))

    n, f, B = N_TRAIN, N_FEAT, 1024
    hold_full("hist_full/u16/B1024", _u16(gen, (n, f), B + 60, dev), B, f)
    hold_full("hist_full/u16/B1024/zipf", _zipf_u16(gen, (n, f), B, dev), B,
              f)
    C = LEAVES_SHAPE["C"]
    hold_leaves("hist_leaves/u16/B1024",
                _frontier_comb(_u16(gen, (C, f), B + 60, dev),
                               *_rows(gen, C, dev)), B, f)
    hold_leaves("hist_leaves/u16/odd_stride",
                _frontier_comb(_u16(gen, (C // 4, 27), B + 60, dev),
                               *_rows(gen, C // 4, dev)), B, 27, timed=False)
    # the sparse_efb phase's bundle matrix at its own width
    Bb = int(efb_bins["bundle_bins"])
    bins = efb_bins["bins"]
    nc = bins.shape[1]
    hold_full("hist_full/u16/bundle", bins, Bb, nc)
    rows = torch.randperm(bins.shape[0], generator=gen, device=dev)[
        :min(C, bins.shape[0] // BR * BR)]
    hold_leaves("hist_leaves/u16/bundle",
                _frontier_comb(hist.take_rows(bins, rows),
                               *_rows(gen, rows.numel(), dev)), Bb, nc)
    del bins, rows
    # the widths above one feature's CTA: bin tiles
    for Bw in WIDE_WIDTHS:
        for kind in ("random", "zipf"):
            tag = f"B{Bw}" + ("/zipf" if kind == "zipf" else "")
            hold_full(f"hist_full/u16/{tag}",
                      _wide_u16(gen, (n, f), Bw, dev, kind), Bw, f,
                      bits=True)
            hold_leaves(f"hist_leaves/u16/{tag}",
                        _frontier_comb(_wide_u16(gen, (C, f), Bw, dev, kind),
                                       *_rows(gen, C, dev)), Bw, f,
                        bits=True)
            torch.cuda.empty_cache()
    for name, r in out.items():
        if "ms" in r:
            print(f"{name} {r['shape']}: kernel {_f4(r['kernel_ms'])} ms, "
                  f"call {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"index_add_ {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms, {r['design']} design, fg "
                  f"{r['fg']}, W {r['W']:.3g}, {r['warps_per_sm']} warps "
                  f"an SM, tile {r['tile']}, {r['tiles']} bin tiles of "
                  f"{r['tile_bins']}, scratch {r['scratch_bytes']} bytes, "
                  f"{r['ctas_per_sm']} CTAs an SM, relerr "
                  f"{r['relerr']:.3g}, bit-identical share "
                  f"{r['bit_identical_share']}", flush=True)
    return out


def phase_kernels(clock_mhz, efb_bins):
    """Each atomic kernel against its plain version at the main path's
    shapes, with its kernel-alone time, its attributes, and for the leaves
    three inputs: the random block->slot map, the same blocks slot by slot
    as the frontier lays a round out, and that layout with skewed bins."""
    from lightgbm_tpu_torch.ops import histogram as hist
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}

    # hist_full: the frontier's root histogram (N=1M, F=28, B=256), an odd
    # shape (ragged row count, feature count not a power of two) and wide
    # rows (staged row by row, features in groups)
    n, f, B = N_TRAIN, N_FEAT, 256
    bins, g, h, m, st = _check_full(hist, gen, dev, n, f, B)
    st_odd = _check_full(hist, gen, dev, 100_003, 13, 64)[-1]
    st_wide = _check_full(hist, gen, dev, 20_011, 700, 256)[-1]

    def full():
        return hist.hist_full(bins, g, h, m, B)
    ms = median_ms(full)
    with hist.force_plain():
        plain_ms = median_ms(lambda: hist.build_histogram(bins, g, h, m, B))
    library_ms = _full_yardstick(dev, bins, g, h, m, B)
    b_ms, b_by = bound(n * f + 12 * n + f * B * 12, 3 * n * f + 2 * n)
    out["hist_full"] = dict(
        shape=[n, f, B], **st, relerr_odd_shape=st_odd["relerr"],
        relerr_wide_rows=st_wide["relerr"], ms=ms,
        kernel_ms=calls_ms(full, ATOMIC_KERNELS["hist_full"]),
        plain_ms=plain_ms, library_ms=library_ms,
        vs_index_add=ms / library_ms, bound_ms=b_ms, bound_by=b_by,
        smem_floor_ms=smem_floor_ms(n, f, clock_mhz, sms),
        **_atomic_attrs(hist, "hist_full", dev, n, f, f, B))
    del bins, g, h, m

    # hist_leaves: one frontier round's batched smaller-child histograms
    C, NC, fl, k, BR = (LEAVES_SHAPE[x] for x in ("C", "NC", "f", "k", "BR"))
    nb = C // BR
    comb, g, h, m, block_leaf, empty, _ = _leaves_inputs(gen, dev)
    ordered = torch.sort(block_leaf).values
    inputs = {"random": (comb, block_leaf), "slot_ordered": (comb, ordered),
              "skewed": (_skewed_bins(comb), ordered)}
    cases = {}
    for case, (cb, bl) in inputs.items():
        def leaves(cb=cb, bl=bl):
            return hist.hist_leaves(cb, g, h, m, bl, k, B, block_rows=BR,
                                    f_limit=fl)
        with hist.force_plain():
            ref = hist.build_histogram_leaves(cb, g, h, m, bl, k, B,
                                              block_rows=BR, f_limit=fl)
        got, again = leaves(), leaves()
        torch.cuda.synchronize()
        nan_slot = int(bl[100])                  # the block with the NaN
        others = [s for s in range(k) if s != nan_slot]
        if not bool((got[empty] == 0).all()):
            raise AssertionError(f"hist_leaves {case}: the empty slot is "
                                 "not zero")
        if not (bool(torch.isnan(got[nan_slot]).any())
                and bool(torch.isfinite(got[others]).all())):
            raise AssertionError(f"hist_leaves {case}: the NaN is not "
                                 "confined to its slot")
        st = _atomic_stats(got, again, ref)
        _hold_atomic(f"hist_leaves {case}", st)
        case_ms = median_ms(leaves)
        lib_ms = _leaves_yardstick(dev, cb, g, h, m, bl, k, B, BR, fl)
        cases[case] = dict(
            **st, ms=case_ms,
            kernel_ms=calls_ms(leaves, ATOMIC_KERNELS["hist_leaves"]),
            library_ms=lib_ms, vs_index_add=case_ms / lib_ms)
    with hist.force_plain():
        plain_ms = median_ms(lambda: hist.build_histogram_leaves(
            comb, g, h, m, block_leaf, k, B, block_rows=BR, f_limit=fl))
    b_ms, b_by = bound(C * fl + 12 * C + 4 * nb + k * fl * B * 12,
                       3 * C * fl + 2 * C)
    out["hist_leaves"] = dict(
        shape=[C, NC, fl, k, BR], **cases["random"], plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by,
        smem_floor_ms=smem_floor_ms(C, fl, clock_mhz, sms),
        **_atomic_attrs(hist, "hist_leaves", dev, nb, NC, fl, B, k),
        cases=cases, empty_slot_zero=True, nan_confined=True)
    for name, r in out.items():
        print(f"{name}: kernel {_f4(r['kernel_ms'])} ms, call {r['ms']:.4f} "
              f"ms, index_add_ {r['library_ms']:.4f} ms, {r['registers']} "
              f"registers, {r['local_bytes']} spilled bytes, "
              f"{r['ctas_per_sm']} CTAs an SM", flush=True)
    for case, r in cases.items():
        print(f"hist_leaves {case}: kernel {_f4(r['kernel_ms'])} ms, call "
              f"{r['ms']:.4f} ms, relerr {r['relerr']:.3g}", flush=True)
    del comb, g, h, m
    out.update(_u16_cases(hist, gen, dev, clock_mhz, sms, efb_bins))
    emit({"phase": "kernels", "tolerance": ATOMIC_REL_TOL,
          "clock_max_sm_mhz": clock_mhz, **out})
    return out


def onehot_cases():
    """(variant, B) for every one-hot body at the two widths: B=256 (all
    but packed) and B=64 (all eight)."""
    from lightgbm_tpu_torch.ops import onehot_variants as ov
    return [(v, B) for B in (256, 64) for v in ov.VARIANT_NAMES
            if ov.VARIANTS[v].kernel_id is not None
            and ov.VARIANTS[v].supports(B)]


# the one-hot bodies that serve widths above 256 (u16 bins)
ONEHOT_U16_BODIES = ("base", "i16cmp", "staged", "int8")


def _onehot_u16_cases(hist, ov, gen, dev, efb_bins):
    """The one-hot kernels' u16 instantiations against their plain versions
    on the card, for the four bodies that serve widths above 256: 1M x 28
    at B = 1,024 (the wide_bins run's root) in both layouts, one frontier
    round's comb at B = 1,024 (28 features + 6 u16 gh columns, k = 16,
    inside the leaves cut: an empty slot and a NaN block), and the
    sparse_efb phase's own bundle matrix at its bundle width (its
    force_row_wise run's root; its per-leaf histograms lie outside the
    cut).  Bins >= B present in the random cases.  Each row: relerr, the
    same bits twice, the launch of the one-hot kernel, ms a call, kernel
    alone, plain, index_add_, the byte bound (2 bytes a bin), the
    tensor-core floor of the dense design (every row through every
    128-lane bucket) and of the bucketed one (through its own), the
    kernel's design (``histogram.onehot_plan``: bucketed at u16) and its
    attributes.  The Zipf-skewed cases (bin i with weight 1/(i+1)^1.1, as
    an EFB bundle's default bin skews its rows) hold the bucketed design's
    dealing of a hot bucket's rows across warps: the full pass at 1M x 28
    and the leaves, both at B = 1,024.  At B = 65,536, ``staged`` alone
    (the widest_bins phase's force_row_wise run's root, 1M x 28 in 512
    buckets a feature)."""
    rows = {}
    n, f, B = N_TRAIN, N_FEAT, 1024
    C, k, BR = (LEAVES_SHAPE[x] for x in ("C", "k", "BR"))
    nb = C // BR
    _, lg, lh, lm, block_leaf, empty, nan_slot = _leaves_inputs(gen, dev)
    combs = {"B1024": _frontier_comb(_u16(gen, (C, f), B + 60, dev), lg, lh,
                                     lm),
             "zipf": _frontier_comb(_zipf_u16(gen, (C, f), B, dev), lg, lh,
                                    lm)}
    others = [s for s in range(k) if s != nan_slot]
    if not hist.onehot_leaves_fits(f, k, B):
        raise AssertionError("the u16 leaves case lies outside the cut")
    g, h, m = _rows(gen, n, dev)
    full_cases = (("B1024", (_u16(gen, (n, f), B + 60, dev), g, h, m), B,
                   ("featmajor", "rowmajor"), ONEHOT_U16_BODIES),
                  ("zipf", (_zipf_u16(gen, (n, f), B, dev), g, h, m), B,
                   ("featmajor",), ONEHOT_U16_BODIES),
                  ("bundle", (efb_bins["bins"],
                              *_rows(gen, efb_bins["bins"].shape[0], dev)),
                   int(efb_bins["bundle_bins"]), ("featmajor",),
                   ONEHOT_U16_BODIES),
                  (f"B{WIDE_WIDTHS[-1]}",
                   (_wide_u16(gen, (n, f), WIDE_WIDTHS[-1], dev, "random"),
                    g, h, m), WIDE_WIDTHS[-1], ("featmajor",), ("staged",)))

    def hold(name, kernel, fn, ref, leaves=False):
        before = hist.launch_counts[kernel]
        got, again = fn(), fn()
        torch.cuda.synchronize()
        ok = hist.launch_counts[kernel] == before + 2
        if leaves:
            fin = torch.isfinite(ref)
            ok = (ok and bool((got[empty] == 0).all())
                  and bool(torch.isnan(got[nan_slot][..., 0]).all())
                  and bool(torch.isfinite(got[others]).all())
                  and torch.equal(torch.isnan(got), torch.isnan(ref))
                  and torch.equal(got[others], again[others]))
            got, ref = got[fin], ref[fin]
        else:
            ok = ok and torch.equal(got, again)
        err = relerr(got, ref)
        if not (ok and err <= REL_TOL):
            raise AssertionError(f"{name}: relerr {err}, checks {ok}")
        return dict(relerr=err, max_abs_err=float((got - ref).abs().max()))

    for case, (bins, g, h, m), Bc, layouts, bodies in full_cases:
        nc, fc = bins.shape[0], bins.shape[1]

        def full(v, layout, bins=bins, g=g, h=h, m=m, Bc=Bc):
            return hist.build_histogram(bins, g, h, m, Bc, method="onehot",
                                        variant=v, layout=layout)
        ref, plain_ms = {}, {}
        with hist.force_plain():
            for fam in {"int8" if v == "int8" else "base" for v in bodies}:
                for layout in layouts:
                    ref[fam, layout] = full(fam, layout)
                plain_ms[fam] = median_ms(lambda: full(fam, "featmajor"),
                                          reps=5)
        lib = _full_yardstick(dev, bins, g, h, m, Bc)
        b_ms, b_by = bound(2 * nc * fc + 12 * nc + fc * Bc * 12,
                           3 * nc * fc + 2 * nc)
        for v in bodies:
            fam = "int8" if v == "int8" else "base"
            lanes = ov.total_lanes(v, fc, Bc)
            for layout in layouts:
                name = f"onehot_full/{layout}/{v}/u16/{case}"
                fn = (lambda v=v, layout=layout: full(v, layout))
                rows[name] = _vs_library(dict(
                    kernel="onehot_full", layout=layout, variant=v, B=Bc,
                    case=case, dtype="uint16", shape=[nc, fc, Bc],
                    lanes=lanes,
                    **hold(name, "onehot_full", fn, ref[fam, layout]),
                    ms=median_ms(fn), plain_ms=plain_ms[fam],
                    library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                    tensor_core_floor_ms=tensor_core_floor_ms(lanes, nc, v),
                    bucket_floor_ms=tensor_core_floor_ms(128 * fc, nc, v)),
                    hist.onehot_kernel_attributes("onehot_full", v, fc, Bc,
                                                  layout),
                    fn, _kernel_name("onehot_full", v))

    for case, comb in combs.items():
        def leaves(v, comb=comb):
            return hist.build_histogram_leaves(
                comb, lg, lh, lm, block_leaf, k, B, block_rows=BR, f_limit=f,
                method="onehot", variant=v)
        ref, plain_ms = {}, {}
        with hist.force_plain():
            for fam in ("base", "int8"):
                ref[fam] = leaves(fam)
                plain_ms[fam] = median_ms(lambda: leaves(fam), reps=5)
        lib = _leaves_yardstick(dev, comb, lg, lh, lm, block_leaf, k, B, BR,
                                f)
        b_ms, b_by = bound(2 * C * f + 12 * C + 4 * nb + k * f * B * 12,
                           3 * C * f + 2 * C)
        for v in ONEHOT_U16_BODIES:
            lanes = ov.total_lanes(v, f, B)
            name = f"onehot_leaves/rowmajor/{v}/u16/{case}"
            fn = (lambda v=v: leaves(v))
            rows[name] = _vs_library(dict(
                kernel="onehot_leaves", layout="rowmajor", variant=v, B=B,
                case=case, dtype="uint16",
                shape=[C, comb.shape[1], f, k, BR], lanes=lanes,
                **hold(name, "onehot_leaves", fn,
                       ref["int8" if v == "int8" else "base"], leaves=True),
                ms=median_ms(fn), plain_ms=plain_ms["int8" if v == "int8"
                                                    else "base"],
                library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                tensor_core_floor_ms=tensor_core_floor_ms(lanes, C, v),
                bucket_floor_ms=tensor_core_floor_ms(128 * f, C, v),
                empty_slot_zero=True, nan_confined=True),
                hist.onehot_kernel_attributes("onehot_leaves", v, f, B,
                                              ld=comb.shape[1]),
                fn, _kernel_name("onehot_leaves", v))
    for name, r in rows.items():
        print(f"{name} {r['shape']}: {r['design']} design, kernel "
              f"{_f4(r['kernel_ms'])} ms, call {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms, tc floor "
              f"{r['tensor_core_floor_ms']:.4f} ms (bucketed "
              f"{r['bucket_floor_ms']:.4f}), {r['registers']} registers, "
              f"{r['local_bytes']} spilled bytes, "
              f"{r['dynamic_smem_bytes']} shared bytes, {r['ctas_per_sm']} "
              f"CTAs an SM, relerr {r['relerr']:.3g}", flush=True)
    return rows


def phase_kernels_onehot(card, efb_bins):
    """Every one-hot kernel, layout and variant against the plain version
    on the card, at the main path's shapes (u8 at B = 256 and 64; u16,
    ``_onehot_u16_cases``); returns one row per (kernel, layout, variant,
    width)."""
    from lightgbm_tpu_torch.ops import histogram as hist
    from lightgbm_tpu_torch.ops import onehot_variants as ov
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n, f = N_TRAIN, N_FEAT
    bins256 = torch.randint(0, 256, (n, f), generator=gen, device=dev,
                            dtype=torch.uint8)
    g, h, m = _rows(gen, n, dev)
    C, k, BR, fl = (LEAVES_SHAPE[x] for x in ("C", "k", "BR", "f"))
    nb = C // BR
    comb256, lg, lh, lm, block_leaf, empty, nan_slot = _leaves_inputs(gen,
                                                                     dev)
    others = [s for s in range(k) if s != nan_slot]
    # bins as a width-B dataset has them (the card tests cover bins >= B)
    bins = {256: bins256, 64: bins256 & 63}
    comb = {256: comb256, 64: comb256 & 63}

    def full(B, **kw):
        return hist.build_histogram(bins[B], g, h, m, B, method="onehot",
                                    **kw)

    def leaves(B, **kw):
        return hist.build_histogram_leaves(
            comb[B], lg, lh, lm, block_leaf, k, B, block_rows=BR,
            f_limit=fl, method="onehot", **kw)

    # the plain versions: one for the seven bf16-pair variants (the same
    # function), and int8's own, whose blocks depend on the layout
    ref, plain_ms, lib_ms = {}, {}, {}
    for B in (256, 64):
        for fam in ("base", "int8"):
            with hist.force_plain():
                for layout in ("featmajor", "rowmajor"):
                    ref[B, fam, layout] = full(B, variant=fam, layout=layout)
                ref[B, fam, "leaves"] = leaves(B, variant=fam)
                plain_ms[B, fam] = (
                    median_ms(lambda: full(B, variant=fam)),
                    median_ms(lambda: leaves(B, variant=fam)))
        lib_ms[B] = (_full_yardstick(dev, bins[B], g, h, m, B),
                     _leaves_yardstick(dev, comb[B], lg, lh, lm, block_leaf,
                                       k, B, BR, fl))
    rows = {}
    for v, B in onehot_cases():
        fam = "int8" if v == "int8" else "base"
        lanes_full = ov.total_lanes(v, f, B)
        lanes_leaves = ov.total_lanes(v, fl, B)
        for layout in ("featmajor", "rowmajor"):
            got = full(B, variant=v, layout=layout)
            again = full(B, variant=v, layout=layout)
            torch.cuda.synchronize()
            r = ref[B, fam, layout]
            err = relerr(got, r)
            if not (err <= REL_TOL and torch.equal(got, again)):
                raise AssertionError(f"onehot_full {layout} {v} B={B}: "
                                     f"relerr {err}")
            b_ms, b_by = bound(n * f + 12 * n + f * B * 12,
                               3 * n * f + 2 * n)
            rows[f"onehot_full/{layout}/{v}/B{B}"] = _vs_library(dict(
                kernel="onehot_full", layout=layout, variant=v, B=B,
                shape=[n, f, B], lanes=lanes_full, relerr=err,
                max_abs_err=float((got - r).abs().max()),
                ms=median_ms(lambda: full(B, variant=v, layout=layout)),
                plain_ms=plain_ms[B, fam][0], library_ms=lib_ms[B][0],
                bound_ms=b_ms, bound_by=b_by,
                tensor_core_floor_ms=tensor_core_floor_ms(lanes_full, n, v)),
                hist.onehot_kernel_attributes("onehot_full", v, f, B, layout),
                lambda: full(B, variant=v, layout=layout),
                _kernel_name("onehot_full", v))
        got = leaves(B, variant=v)
        again = leaves(B, variant=v)
        torch.cuda.synchronize()
        r = ref[B, fam, "leaves"]
        fin = torch.isfinite(r)
        ok = (bool((got[empty] == 0).all())
              and bool(torch.isnan(got[nan_slot][..., 0]).all())
              and bool(torch.isfinite(got[others]).all())
              and torch.equal(torch.isnan(got), torch.isnan(r))
              and torch.equal(got[others], again[others]))
        err = relerr(got[fin], r[fin])
        if not (ok and err <= REL_TOL):
            raise AssertionError(f"onehot_leaves {v} B={B}: relerr {err}, "
                                 f"slot checks {ok}")
        b_ms, b_by = bound(C * fl + 12 * C + 4 * nb + k * fl * B * 12,
                           3 * C * fl + 2 * C)
        rows[f"onehot_leaves/rowmajor/{v}/B{B}"] = _vs_library(dict(
            kernel="onehot_leaves", layout="rowmajor", variant=v, B=B,
            shape=[C, LEAVES_SHAPE["NC"], fl, k, BR], lanes=lanes_leaves,
            relerr=err,
            max_abs_err=float((got[fin] - r[fin]).abs().max()),
            ms=median_ms(lambda: leaves(B, variant=v)),
            plain_ms=plain_ms[B, fam][1], library_ms=lib_ms[B][1],
            bound_ms=b_ms, bound_by=b_by,
            tensor_core_floor_ms=tensor_core_floor_ms(lanes_leaves, C, v),
            empty_slot_zero=True, nan_confined=True),
            hist.onehot_kernel_attributes("onehot_leaves", v, fl, B,
                                          ld=LEAVES_SHAPE["NC"]),
            lambda: leaves(B, variant=v), _kernel_name("onehot_leaves", v))
    # the int8 kernels' times beside their registers, spills and CTAs an SM
    int8 = {name: {k: r[k] for k in ("kernel_ms", "ms", "registers",
                                     "local_bytes", "ctas_per_sm")}
            for name, r in rows.items() if r["variant"] == "int8"}
    for name, r in int8.items():
        print(f"{name}: kernel {_f4(r['kernel_ms'])} ms, call "
              f"{r['ms']:.4f} ms, {r['registers']} registers, "
              f"{r['local_bytes']} spilled bytes, {r['ctas_per_sm']} CTAs "
              "an SM", flush=True)
    del bins256, comb256, bins, comb, g, h, m, lg, lh, lm
    rows.update(_onehot_u16_cases(hist, ov, gen, dev, efb_bins))
    emit({"phase": "kernels_onehot", "card": card, "tolerance": REL_TOL,
          "int8": int8, "rows": rows})
    return rows


def _same_quant(a, b) -> bool:
    """q identical, and s identical bit for bit where it is not NaN, NaN in
    the same places (a NaN's payload is not part of the function)."""
    (qa, sa), (qb, sb) = a, b
    ok = ~torch.isnan(sb)
    return (torch.equal(qa, qb)
            and torch.equal(torch.isnan(sa), torch.isnan(sb))
            and torch.equal(sa[ok].view(torch.int32),
                            sb[ok].view(torch.int32)))


def phase_quant(card):
    """The int8 quantize kernel, bit-identical to its plain version at the
    blocks the main path gives it, in both input forms: grad, hess and
    mask, whose products it forms itself (``quantize_int8``, the int8
    wrappers' pre-pass, one launch a call), and rows prepped by
    ``prep_f32`` (``quantize_int8_blocks``, the shootout shell's)."""
    from lightgbm_tpu_torch.ops import histogram as hist
    from lightgbm_tpu_torch.ops import onehot_variants as ov
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    n, f, B = N_TRAIN, N_FEAT, 256
    ghm = _rows(gen, n, dev)
    _, lg, lh, lm, _, _, _ = _leaves_inputs(gen, dev)    # NaN in block 100
    cases = {"featmajor": (ghm, ov.pallas_block_rows("int8", "featmajor",
                                                     n, f, B)),
             "rowmajor": (ghm, ov.pallas_block_rows("int8", "rowmajor",
                                                    n, f, B)),
             "leaves": ((lg, lh, lm), LEAVES_SHAPE["BR"])}
    out = {}
    for name, (x, br) in cases.items():
        rows = ov.prep_f32(*x)
        rn = rows.shape[1]
        forms = {"fused": lambda x=x, br=br: hist.quantize_int8(*x, br),
                 "prep_rows": lambda rows=rows, br=br:
                     hist.quantize_int8_blocks(rows, br)}
        plain = (lambda x=x, br=br: ov.quantize_int8_blocks_plain(
            ov.prep_f32(*x), br))
        ref = plain()
        # per element and level: abs, max, divide, round, fused
        # multiply-add, convert -- 6 operations on each of 3 rows, 3 levels
        b_ms, b_by = bound(21 * rn + 36 * (-(-rn // br)), 54 * rn)
        case = dict(rows=rn, block_rows=br, bound_ms=b_ms, bound_by=b_by,
                    plain_ms=median_ms(plain),
                    **hist.quant_kernel_attributes(br))
        for form, fn in forms.items():
            got = fn()
            torch.cuda.synchronize()
            if not _same_quant(got, ref):
                raise AssertionError(f"onehot_quant {name} (block {br}, "
                                     f"{form}): not bit-identical to the "
                                     "plain version")
            case[form] = dict(ms=median_ms(fn),
                              kernel_ms=kernel_ms(fn, "quant_kernel"),
                              launches_per_call=launches_per_call(
                                  fn, want=("quant_kernel",)))
        if case["fused"]["launches_per_call"] != 1:
            raise AssertionError(f"onehot_quant {name}: the fused pre-pass "
                                 f"launched {case['fused']} a call")
        case["nan_blocks"] = int(torch.isnan(ref[1]).any(1).sum())
        fu, pr = case["fused"], case["prep_rows"]
        print(f"quant {name} ({rn} rows per {br}): fused {fu['ms']:.4f} ms "
              f"a call, kernel {fu['kernel_ms']} ms, "
              f"{fu['launches_per_call']:g} launch a call; prepped rows "
              f"{pr['ms']:.4f} / {pr['kernel_ms']} ms; {case['registers']} "
              f"registers, {case['local_bytes']} spilled bytes; bound "
              f"{b_ms:.5f} ms", flush=True)
        out[name] = case
    fm = out["featmajor"]
    row = dict(shape=[3, n], block_rows=fm["block_rows"], bit_identical=True,
               relerr=0.0, max_abs_err=0.0, ms=fm["fused"]["ms"],
               kernel_ms=fm["fused"]["kernel_ms"], plain_ms=fm["plain_ms"],
               library_ms=None, bound_ms=fm["bound_ms"],
               bound_by=fm["bound_by"], registers=fm["registers"],
               local_bytes=fm["local_bytes"])
    emit({"phase": "quant", "card": card, "cases": out, **row})
    return row


def phase_shootout(card):
    """The shootout shell (K4) once per election candidate at B = 256, 64
    and 1,024 (u16 bins: base, staged, int8), on the JAX shootout's shape;
    each candidate's launches are counted from zero around its own run,
    then it is held against its plain version and timed."""
    from lightgbm_tpu_torch.ops import histogram as hist
    from lightgbm_tpu_torch.ops import onehot_variants as ov
    dev = torch.device("cuda")
    N, nrows, f, BR = (SHOOTOUT_SHAPE[x] for x in ("N", "rows", "f", "BR"))
    rng = np.random.default_rng(0)
    rows_out = {}
    for B in (256, 64, 1024):
        dtype = np.uint8 if B <= 256 else np.uint16
        bins = torch.as_tensor(rng.integers(0, B, size=(N, f),
                                            dtype=dtype)).to(dev)
        g = torch.as_tensor(rng.normal(size=N).astype(np.float32)).to(dev)
        g[nrows:] = 0.0
        h = torch.full((N,), 0.25, device=dev)
        m = (torch.arange(N, device=dev) < nrows).float()
        # [F, N], once (u16 moves as int16)
        bins_t = hist.movable_bins(bins).t().contiguous().view(bins.dtype)
        lib_ms = _full_yardstick(dev, bins, g, h, m, B)
        esz = bins.element_size()
        b_ms, b_by = bound(esz * N * f + 12 * N + f * B * 12,
                           3 * N * f + 2 * N)
        for v in ov.AUTO_CANDIDATES:
            if not ov.VARIANTS[v].supports(B):
                continue
            prep, run = ov.make_bench_kernel(v, f, B, BR)
            x = prep(g, h, m)
            hist.reset_launch_counts()
            got = run(bins_t, x)
            torch.cuda.synchronize()
            launches = dict(hist.launch_counts)
            want = {"onehot_bench": 1, "onehot_quant": int(v == "int8")}
            if any(launches[k] != want.get(k, 0) for k in launches):
                raise AssertionError(f"onehot_bench {v} B={B}: launches "
                                     f"{launches}")
            with hist.force_plain():
                ref = run(bins_t, x)
                plain_ms = median_ms(lambda: run(bins_t, x))
            err = relerr(got, ref)
            if not err <= REL_TOL:
                raise AssertionError(f"onehot_bench {v} B={B}: relerr {err}")
            # the shell launches the main path's featmajor kernel of the body
            rows_out[f"onehot_bench/{v}/B{B}"] = _vs_library(dict(
                variant=v, B=B, shape=[f, N, BR], relerr=err,
                max_abs_err=float((got - ref).abs().max()),
                ms=median_ms(lambda: run(bins_t, x)), plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                launches=launches["onehot_bench"]),
                hist.onehot_kernel_attributes("onehot_full", v, f, B,
                                              "featmajor"),
                lambda: run(bins_t, x), _kernel_name("onehot_full", v))
        del bins, bins_t, g, h, m
    emit({"phase": "shootout", "card": card, "tolerance": REL_TOL,
          "rows": rows_out})
    return rows_out


def phase_elect(card):
    """hist_variant=auto's election at B = 256, 64 and 1,024 (u16 bins),
    from an empty cache; then again, served from the cache with no
    launch."""
    from lightgbm_tpu_torch.ops import histogram as hist
    from lightgbm_tpu_torch.ops import onehot_variants as ov
    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(dev)
    out = {}
    for B in (256, 64, 1024):
        ov._AUTO_CACHE.pop((name, B), None)
        t0 = time.perf_counter()
        won = ov.pick_variant(B, N_FEAT, device=dev)
        secs = time.perf_counter() - t0
        res = ov.AUTO_RESULTS[(name, B)]
        bad = [v for v, r in res.items() if not r["qualified"]]
        if bad:
            raise AssertionError(f"election B={B} disqualified {bad}: {res}")
        print(f"elected B={B}: {won}", flush=True)
        hist.reset_launch_counts()
        again = ov.pick_variant(B, N_FEAT, device=dev)
        if again != won or any(hist.launch_counts.values()):
            raise AssertionError(f"election B={B}: the second call gave "
                                 f"{again} with launches "
                                 f"{hist.launch_counts}")
        out[f"B{B}"] = {"winner": won, "seconds": secs, "candidates": res,
                        "second_call_from_cache": True}
    emit({"phase": "elect", "card": card, "rows": 262144,
          "features": N_FEAT, **out})
    return {B: out[f"B{B}"]["winner"] for B in (256, 64, 1024)}


def _auc(scores, labels):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.metric.base import AUCMetric
    md = Metadata(len(labels))
    md.set_field("label", labels)
    m = AUCMetric(Config())
    m.init(md, len(labels))
    return m.eval(np.asarray(scores, np.float64))[0][1]


def _train(lgt, ds, params, iters):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster = lgt.train(params, ds, iters, verbose_eval=False,
                        device="cuda")
    booster._gbdt.models                       # drain the pending trees
    torch.cuda.synchronize()
    return booster, time.perf_counter() - t0


def auc_holdout(Xv, yv, floor=0.75):
    """The held-out AUC gate: kernel within ``AUC_TOL`` of plain, above
    ``floor`` (0.5 is the constant model's)."""
    return {"name": "auc", "higher": True, "tol": AUC_TOL, "floor": floor,
            "fn": lambda b: _auc(b.predict(Xv, raw_score=True), yv)}


def loss_holdout(name, fn, constant):
    """A held-out loss gate: kernel within 1e-3 (relative) of plain, below
    ``constant``, the constant model's loss."""
    return {"name": name, "higher": False, "tol": 1e-3, "floor": constant,
            "fn": fn}


def _train_pair(lgt, hist, ds, params, iters, Xv, yv, expect, metric=None):
    """Train once through the kernels, with the launch counts set to 0 just
    before and read just after, and once under ``force_plain()``.  Every
    kernel in ``expect`` must have launched and no other.  ``metric``
    (default: the held-out AUC above 0.75) gates both runs' models."""
    metric = metric or auc_holdout(Xv, yv)
    hist.reset_launch_counts()
    booster, secs = _train(lgt, ds, params, iters)
    launches = dict(hist.launch_counts)
    for name, cnt in launches.items():
        if (cnt > 0) != (name in expect):
            raise AssertionError(f"{params}: {name} launched {cnt} times; "
                                 f"this run must launch {sorted(expect)}")
    hist.reset_launch_counts()
    with hist.force_plain():
        booster_p, secs_p = _train(lgt, ds, params, iters)
    if any(hist.launch_counts.values()):
        raise AssertionError(f"force_plain launched kernels: "
                             f"{hist.launch_counts}")
    t_k, t_p = booster._gbdt.models[0], booster_p._gbdt.models[0]
    same_tree0 = (t_k.num_leaves == t_p.num_leaves
                  and np.array_equal(t_k.split_feature, t_p.split_feature)
                  and np.array_equal(t_k.threshold, t_p.threshold))
    v_k, v_p = metric["fn"](booster), metric["fn"](booster_p)
    key = metric["name"] + "_holdout"
    leaves = [t.num_leaves for t in booster._gbdt.models]
    trees = len(leaves)
    n = ds.num_data()
    out = {"rows": n, "iterations": iters, "trees": trees,
           "hist_method": booster._gbdt._grower_cfg.hist_method,
           "hist_variant": booster._gbdt._grower_cfg.hist_variant,
           "kernel": {"s_per_tree": secs / trees,
                      "mrow_iters_per_s": n * iters / 1e6 / secs,
                      key: v_k},
           "plain": {"s_per_tree": secs_p / trees,
                     "mrow_iters_per_s": n * iters / 1e6 / secs_p,
                     key: v_p},
           "launches": launches,
           "launches_per_tree": {k: v / trees for k, v in launches.items()
                                 if v},
           "per_leaf_launches_per_tree": (launches["hist_leaves"]
                                          + launches["onehot_leaves"]) / trees,
           "leaves_per_tree": [min(leaves), max(leaves)],
           "tree0_identical": bool(same_tree0)}
    tol = metric["tol"] * (1.0 if metric["higher"] else abs(v_p))
    if abs(v_k - v_p) > tol:
        raise AssertionError(f"{params}: held-out {metric['name']} kernel "
                             f"{v_k} vs plain {v_p}")
    beats = v_k > metric["floor"] if metric["higher"] else v_k < metric["floor"]
    if not beats:
        raise AssertionError(f"{params}: held-out {metric['name']} {v_k} "
                             f"does not beat {metric['floor']}")
    return booster, out


def phase_train(card, elected):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    base = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
            "learning_rate": 0.1, "verbose": -1}
    onehot = dict(base, force_row_wise=True, hist_variant="staged")
    X, y = make_higgs_like(N_TRAIN, N_FEAT, seed=42)
    Xv, yv = make_higgs_like(N_VALID, N_FEAT, seed=43)
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params=base).construct(device="cuda")
    construct_s = time.perf_counter() - t0
    one_hot_kernels = {"onehot_full", "onehot_leaves"}

    # the default path: the atomic kernels
    booster, atomic = _train_pair(lgt, hist, ds, base, N_ITERS, Xv, yv,
                                  {"hist_full", "hist_leaves"})
    if not atomic["tree0_identical"]:
        raise AssertionError("tree 0 differs between kernel and plain runs")
    # the row-wise path: the one-hot kernels, root once per tree
    booster_oh, row_wise = _train_pair(lgt, hist, ds, onehot, N_ITERS, Xv,
                                       yv, one_hot_kernels)
    # the int8 body: the quantize kernel before each one-hot launch
    int8 = dict(base, force_row_wise=True, hist_variant="int8")
    booster_i8, int8_run = _train_pair(lgt, hist, ds, int8, N_ITERS, Xv, yv,
                                       one_hot_kernels | {"onehot_quant"})
    if not int8_run["tree0_identical"]:
        raise AssertionError("int8: tree 0 differs between kernel and plain")
    gaps = {}
    for tag, run in (("staged", row_wise), ("int8", int8_run)):
        if run["launches"]["onehot_full"] != N_ITERS:
            raise AssertionError(f"{tag}: onehot_full ran "
                                 f"{run['launches']} times in {N_ITERS} "
                                 "trees")
        gaps[tag] = abs(run["kernel"]["auc_holdout"]
                        - atomic["kernel"]["auc_holdout"])
        if gaps[tag] > AUC_TOL:
            raise AssertionError(f"{tag} vs atomic AUC gap {gaps[tag]}")
    # force_row_wise with no hist_variant: auto, the elected variant
    auto = dict(base, force_row_wise=True)
    kernels_auto = one_hot_kernels | (
        {"onehot_quant"} if elected[256] == "int8" else set())
    _, auto_run = _train_pair(lgt, hist, ds, auto, ITERS_AUTO, Xv, yv,
                              kernels_auto)
    if auto_run["hist_variant"] != elected[256]:
        raise AssertionError(f"auto trained with {auto_run['hist_variant']}"
                             f", the election chose {elected[256]}")
    print(f"auto trained with the elected variant: {elected[256]}",
          flush=True)
    # packed at the width it serves, on fewer rows
    packed = dict(base, max_bin=63, force_row_wise=True,
                  hist_variant="packed")
    Xp, yp = make_higgs_like(N_PACKED, N_FEAT, seed=44)
    dsp = lgt.Dataset(Xp, label=yp, params=packed).construct(device="cuda")
    _, packed_run = _train_pair(lgt, hist, dsp, packed, ITERS_PACKED, Xv,
                                yv, one_hot_kernels)
    if packed_run["hist_variant"] != "packed":
        raise AssertionError(f"max_bin=63 resolved {packed_run}")
    emit({"phase": "train", "card": card, "features": N_FEAT,
          "num_leaves": 255, "construct_s": construct_s,
          "atomic": atomic, "row_wise_staged": row_wise,
          "row_wise_int8": int8_run, "row_wise_auto": auto_run,
          "row_wise_packed_max_bin_63": packed_run,
          "onehot_vs_atomic_auc_gap": gaps})
    return (booster, booster_oh, booster_i8), (ds, X, Xv, yv), {
        "atomic": atomic["launches"], "staged": row_wise["launches"],
        "int8": int8_run["launches"], "packed": packed_run["launches"]}


# the obs phase: the train phase's rows and model, telemetry off and on
N_OBS_ITERS = 10
# the iterations at which the callback fetches /metrics and /healthz
OBS_SCRAPE_AT = (1, N_OBS_ITERS - 1)
# a profiler window of this many iterations with obs_trace_device on
OBS_TRACE_ITERS = 2
# the device ranges that window must show (the growers' lgbm/* phases)
OBS_RANGES = ("lgbm/hist", "lgbm/split_search")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http_get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.read().decode()


def _model_trees(booster):
    """The model text before its parameters section (which records the
    obs_* knobs themselves): the header, every tree and the importances."""
    return booster.model_to_string().split("\nparameters:\n")[0]


def _obs_report(args, want):
    """``python -m lightgbm_tpu_torch obs-report ...`` in its own process
    from this checkout: it must exit 0 and print ``want``."""
    p = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                        "obs-report", *args], capture_output=True,
                       text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    if p.returncode or want not in p.stdout:
        raise AssertionError(f"obs-report {args}: rc {p.returncode}\n"
                             f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")


def _check_journal(events, iters):
    """The telemetry run's journal: one train_iter an iteration and one
    train_tree a tree, each iteration with its phase seconds and device
    memory (peak >= in use > 0), one passing numeric check an iteration,
    and the grow program's roofline on the H100 row."""
    kinds = [e["event"] for e in events]
    its = [e for e in events if e["event"] == "train_iter"]
    trees = [e for e in events if e["event"] == "train_tree"]
    checks = [e for e in events if e["event"] == "numeric_health"]
    if ([e["iteration"] for e in its] != list(range(iters))
            or [e["iteration"] for e in trees] != list(range(iters))):
        raise AssertionError(f"journal events {kinds}")
    for e in its:
        wm = e.get("device_memory", {})
        if not (set(e["phase_seconds"]) >= {"gradients", "grow_tree",
                                             "update_score"}
                and wm.get("peak_bytes_in_use", 0)
                >= wm.get("bytes_in_use", 0) > 0):
            raise AssertionError(f"train_iter without phases or memory: {e}")
    if len(checks) != iters or not all(e["ok"] for e in checks):
        raise AssertionError(f"numeric checks {checks}")
    costs_ = [e for e in events if e["event"] == "program_cost"]
    if ([e["program"] for e in costs_] != ["train.grow_tree"]
            or costs_[0]["chip"] != "h100"
            or not 0.0 < costs_[0]["hbm_util"] <= 1.05):
        raise AssertionError(f"program_cost events {costs_}")
    return its, trees, costs_[0]


def phase_obs(card, data):
    """The observability plane on the train phase's data and model (1M x
    28, 255 leaves, ``max_bin=255``): the same model with telemetry off
    and on (s/tree of both, not gated), the journal, the roofline, the
    live /metrics and /healthz, the divergence sentinel, the obs-report
    command line and the device ranges of ``obs_trace_device``.  Every
    file goes to a temporary directory."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.obs import costs, flight, health
    from lightgbm_tpu_torch.obs.tracer import get_tracer
    from lightgbm_tpu_torch.ops import histogram as hist
    from lightgbm_tpu_torch.utils.timer import global_timer
    from torch.profiler import ProfilerActivity, profile
    ds = data[0]
    base = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
            "learning_rate": 0.1, "verbose": -1}
    out = {"phase": "obs", "card": card, "iterations": N_OBS_ITERS}
    with tempfile.TemporaryDirectory() as td:
        journal = os.path.join(td, "journal.jsonl")
        hist.reset_launch_counts()
        off, secs_off = _train(lgt, ds, base, N_OBS_ITERS)
        launches_off = dict(hist.launch_counts)

        port = _free_port()
        url = f"http://127.0.0.1:{port}"
        scrapes = []

        def scrape(env):
            if env.iteration in OBS_SCRAPE_AT:
                code_m, text = _http_get(url + "/metrics")
                code_h, body = _http_get(url + "/healthz")
                scrapes.append({"at": env.iteration, "metrics": code_m,
                                "healthz": code_h,
                                "iteration": json.loads(body)["iteration"],
                                "counter": "lgbtpu_train_iterations" in text})
        on_params = dict(base, obs_telemetry=True, obs_health_check_iters=1,
                         obs_health_port=port, obs_events_path=journal)
        costs.reset_ledger()
        hist.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on = lgt.train(on_params, ds, N_OBS_ITERS, verbose_eval=False,
                       device="cuda", callbacks=[scrape])
        on._gbdt.models                        # drain: the last tree event
        torch.cuda.synchronize()
        secs_on = time.perf_counter() - t0
        launches_on = dict(hist.launch_counts)
        costs.get_ledger().emit(on._gbdt._obs.log)
        on._gbdt._obs.close()
        health.stop_health_server()
        flight.uninstall()
        # off once more, so the overhead stands against two timings that
        # bracket the telemetry run
        _, secs_off2 = _train(lgt, ds, base, N_OBS_ITERS)
        if _model_trees(on) != _model_trees(off):
            raise AssertionError("telemetry changed the model")
        if launches_on != launches_off or launches_on["hist_full"] != (
                N_OBS_ITERS) or {k for k, v in launches_on.items() if v} != {
                    "hist_full", "hist_leaves"}:
            raise AssertionError(f"launches with telemetry {launches_on}, "
                                 f"without {launches_off}")
        if (len(scrapes) != len(OBS_SCRAPE_AT)
                or any(s["metrics"] != 200 or s["healthz"] != 200
                       or not s["counter"] for s in scrapes)
                or scrapes[0]["iteration"] >= scrapes[1]["iteration"]):
            raise AssertionError(f"live scrapes {scrapes}")
        with open(journal) as fh:
            events = [json.loads(line) for line in fh]
        its, trees, cost = _check_journal(events, N_OBS_ITERS)
        _obs_report(["--path", journal, "--roofline"], "train.grow_tree")
        _obs_report(["--path", journal, "--regressions", "--gate"],
                    "gate: clean")

        # the divergence sentinel: a supervised run (LGBM_FLIGHT_DIR) with
        # a NaN-gradient objective stops at iteration 0 with a flight dump
        def nan_fobj(preds, train_set):
            return np.full(len(preds), np.nan), np.ones(len(preds))
        os.environ["LGBM_FLIGHT_DIR"] = td
        try:
            lgt.train(dict(base, objective="none", obs_health_check_iters=1),
                      ds, 3, fobj=nan_fobj, verbose_eval=False,
                      device="cuda")
            raise AssertionError("NaN gradients trained without "
                                 "DivergenceError")
        except health.DivergenceError as e:
            diverged = {"iteration": e.iteration, "message": str(e),
                        "flight_dump": os.path.basename(e.flight_path or "")}
            if e.iteration != 0 or not (e.flight_path and os.path.exists(
                    e.flight_path)):
                raise AssertionError(f"divergence {diverged}")
        finally:
            del os.environ["LGBM_FLIGHT_DIR"]
            flight.uninstall()

        # the device ranges: a profiler window over obs_trace_device
        # iterations
        traced = dict(base, obs_telemetry=True, obs_trace_device=True,
                      obs_events_path=os.path.join(td, "traced.jsonl"))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tb = lgt.train(traced, ds, OBS_TRACE_ITERS, verbose_eval=False,
                           device="cuda")
            tb._gbdt.models
            torch.cuda.synchronize()
        tb._gbdt._obs.close()
        get_tracer().annotate_device = False
        global_timer.detach_tracer()
        flight.uninstall()
        keys = {e.key: e.count for e in prof.key_averages()}
        ranges = {k: v for k, v in keys.items()
                  if k.startswith(("lgbm/", "train/", "GBDT::"))}
        if not all(k in ranges for k in OBS_RANGES):
            raise AssertionError(f"profiler ranges {sorted(ranges)}")
    trees_n = len(on._gbdt.models)
    out.update(
        s_per_tree_off=[secs_off / trees_n, secs_off2 / trees_n],
        s_per_tree_on=secs_on / trees_n,
        overhead=2.0 * secs_on / (secs_off + secs_off2) - 1.0,
        same_model=True,
        launches=launches_on,
        launches_per_tree={k: v / trees_n for k, v in launches_on.items()
                           if v},
        scrapes=scrapes, journal_events=len(events),
        phase_seconds_iter0=its[0]["phase_seconds"],
        device_memory_last=its[-1]["device_memory"],
        split_gain_tree0=trees[0]["split_gain"],
        roofline={k: cost.get(k) for k in ("chip", "calls",
                                           "seconds_per_call",
                                           "bytes_accessed", "hbm_util",
                                           "bound", "flops_source",
                                           "memory")},
        divergence=diverged, trace_ranges=ranges)
    emit(out)
    return launches_on


# the serial phase: the sequential grower at Higgs width (63 leaves) and
# the features only it serves, on the train phase's rows and a smaller set
SERIAL_LEAVES, ITERS_SERIAL = 63, 5
N_SERIAL_SMALL, ITERS_SERIAL_SMALL = 200_000, 3
# a forced root on x0 (the latent's largest weight), x1 on its left and
# the x2 * x3 interaction's x2 on its right
SERIAL_FORCED = {"feature": 0, "threshold": 0.0,
                 "left": {"feature": 1, "threshold": 0.0},
                 "right": {"feature": 2, "threshold": 0.0}}


def _monotone_along(booster, Xv, feat, sign):
    """The smallest step of the raw prediction along ``feat`` (times
    ``sign``) over a grid, for 200 held-out rows: >= 0 when monotone."""
    grid = np.linspace(-3.0, 3.0, 41, dtype=np.float32)
    rows = np.repeat(Xv[:200], len(grid), axis=0)
    rows[:, feat] = np.tile(grid, 200)
    p = booster.predict(rows, raw_score=True).reshape(200, len(grid))
    return float((sign * np.diff(p, axis=1)).min())


# the splits of tree 0 whose K1 inputs the serial phase records: the root's
# first child (a ragged, permuted segment of most rows) and a deep one
SERIAL_BLOCK_SPLITS = (1, 40)


def _serial_blocks(lgt, ds, params):
    """The serial grower's own K1 inputs: the arguments of the split
    histograms numbered ``SERIAL_BLOCK_SPLITS`` in tree 0 of a one-
    iteration run (the parent segment's gathered rows, its NC bin columns
    followed by 12 bytes of g, h and w a row, the side as the mask,
    ``f_limit=NC``), recorded as ``grow_tree_serial`` passes them to
    ``build_histogram``.  The root's call takes no ``f_limit``."""
    from lightgbm_tpu_torch.ops import grower
    orig = grower.build_histogram
    blocks, n_split = {}, [0]

    def record(bins, grad, hess, mask, max_bin, **kw):
        if kw.get("f_limit") is not None:
            if n_split[0] in SERIAL_BLOCK_SPLITS:
                blocks[f"split{n_split[0]}"] = (
                    bins.clone(), grad.clone(), hess.clone(), mask.clone(),
                    max_bin, kw["f_limit"])
            n_split[0] += 1
        return orig(bins, grad, hess, mask, max_bin, **kw)
    grower.build_histogram = record
    try:
        _train(lgt, ds, params, 1)
    finally:
        grower.build_histogram = orig
    if len(blocks) != len(SERIAL_BLOCK_SPLITS):
        raise AssertionError(f"serial blocks: recorded {sorted(blocks)} of "
                             f"{n_split[0]} splits")
    return blocks


def _hold_serial_block(hist, dev, name, blk):
    """K1 on one recorded serial block against its plain version on the
    same inputs: ``hist_full`` within ``ATOMIC_REL_TOL`` (and the same
    bits twice), ``onehot_full`` featmajor ``staged`` (what
    ``force_row_wise`` launches) within ``REL_TOL``; each with its call
    time, kernel-alone time, plain time, ``index_add_`` and bound."""
    bins, g, h, m, B, f = blk
    r = bins.shape[0]
    esz = bins.element_size()
    oh = dict(method="onehot", variant="staged")
    with hist.force_plain():
        ref = hist.build_histogram(bins, g, h, m, B, f_limit=f)
        ref_oh = hist.build_histogram(bins, g, h, m, B, f_limit=f, **oh)
        plain_ms = median_ms(lambda: hist.build_histogram(
            bins, g, h, m, B, f_limit=f), reps=5)
        plain_oh_ms = median_ms(lambda: hist.build_histogram(
            bins, g, h, m, B, f_limit=f, **oh), reps=5)

    def atomic():
        return hist.hist_full(bins, g, h, m, B, f_limit=f)

    def onehot():
        return hist.build_histogram(bins, g, h, m, B, f_limit=f, **oh)
    got, again = atomic(), atomic()
    torch.cuda.synchronize()
    st = _atomic_stats(got, again, ref)
    _hold_atomic(f"hist_full serial {name}", st)
    got_oh, again_oh = onehot(), onehot()
    torch.cuda.synchronize()
    err = relerr(got_oh, ref_oh)
    if not (err <= REL_TOL and torch.equal(got_oh, again_oh)):
        raise AssertionError(f"onehot_full serial {name}: relerr {err}")
    b_ms, b_by = bound(esz * r * f + 12 * r + f * B * 12, 3 * r * f + 2 * r)
    lib = _full_yardstick(dev, bins[:, :f].contiguous(), g, h, m, B)
    shape = [r, bins.shape[1], f, B]
    return (
        dict(shape=shape, **st, ms=median_ms(atomic),
             kernel_ms=calls_ms(atomic, ATOMIC_KERNELS["hist_full"]),
             plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
             bound_by=b_by),
        dict(shape=shape, relerr=err,
             max_abs_err=float((got_oh - ref_oh).abs().max()),
             ms=median_ms(onehot),
             kernel_ms=kernel_ms(onehot, _kernel_name("onehot_full",
                                                      "staged")),
             plain_ms=plain_oh_ms, library_ms=lib, bound_ms=b_ms,
             bound_by=b_by))


def _serial_profile(lgt, d, params, iters=2):
    """torch.profiler (the device only) over ``iters`` serial iterations:
    s/tree with the profiler on, the device's busy time a tree and its
    idle share of the wall time, K1's device time a tree (its kernel and
    its reduce), and the device's kernels, copies and fills a tree, of
    them the copies to the host (a split's row counts come back so)."""
    wall_s, dev_rows, _ = _profiled(lambda: _train(lgt, d, params, iters),
                                    host=False)
    busy_us = sum(_device_us(e) for e in dev_rows)
    k1_us = sum(_device_us(e) for e in dev_rows
                if any(n in e.key for n in ATOMIC_KERNELS["hist_full"]))
    dtoh = sum(e.count for e in dev_rows if "DtoH" in e.key)
    return {"iterations": iters, "wall_s_per_tree": wall_s / iters,
            "device_busy_ms_per_tree": busy_us / 1e3 / iters,
            "hist_full_ms_per_tree": k1_us / 1e3 / iters,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "device_launches_per_tree": sum(e.count for e in dev_rows)
            / iters,
            "dtoh_copies_per_tree": dtoh / iters}


def phase_serial(card, data):
    """``tree_grower=serial`` on the card at Higgs width: the default
    (atomic) path and ``force_row_wise`` staged on the train phase's 1M
    rows, 63 leaves, 5 iterations, the same trees as the frontier's; then
    on 200k rows, 3 iterations each, the features that need the split
    order (interaction constraints, forced splits, CEGB, monotone
    intermediate and advanced), linear trees, and ``feature_contri`` on
    the frontier.  Each run once through the kernels (launch counts from
    zero: a serial run launches one full histogram for the root and one a
    split, never a per-leaf kernel) and once under ``force_plain()``, tree
    0 identical, held-out AUC within 1e-3 and above 0.5; the monotone runs
    monotone along feature 0.  Then K1 on the serial grower's own inputs
    (two recorded split blocks, ``_serial_blocks``) against its plain
    version, and a profile of the default serial run at 1M and 200k rows
    (``_serial_profile``).  Last, ``LGBMClassifier(device="cuda")``
    predicts the ``train`` API's model bit for bit.  Returns the runs'
    launch counts and the block checks."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    ds, X, Xv, yv = data
    base = {"objective": "binary", "num_leaves": SERIAL_LEAVES,
            "max_bin": 255, "learning_rate": 0.1, "verbose": -1}
    serial = dict(base, tree_grower="serial")
    auc = auc_holdout(Xv, yv, floor=0.5)
    runs, launches = {}, {}

    def pair(name, d, params, iters, kernels, serial_run=True):
        booster, out = _train_pair(lgt, hist, d, params, iters, Xv, yv,
                                   kernels, metric=auc)
        if not out["tree0_identical"]:
            raise AssertionError(f"serial {name}: tree 0 differs between "
                                 "kernel and plain runs")
        leaves = sum(t.num_leaves for t in booster._gbdt.models)
        if serial_run:
            (kname,) = kernels
            if out["launches"][kname] != leaves:
                raise AssertionError(
                    f"serial {name}: {kname} ran {out['launches'][kname]} "
                    f"times for {leaves} leaves (the root and one a split)")
        out["leaves"] = leaves
        print(f"serial {name}: s/tree {out['kernel']['s_per_tree']:.4f}, "
              f"launches/tree {out['launches_per_tree']}", flush=True)
        runs[name], launches[name] = out, out["launches"]
        return booster

    # 1M x 28, 63 leaves: the default path, then force_row_wise staged
    b_serial = pair("default", ds, serial, ITERS_SERIAL, {"hist_full"})
    pair("row_wise_staged", ds, dict(serial, force_row_wise=True,
                                     hist_variant="staged"),
         ITERS_SERIAL, {"onehot_full"})
    # the frontier grows the same trees: the same leaf for every row
    b_front, _ = _train(lgt, ds, base, ITERS_SERIAL)
    same = np.array_equal(b_serial.predict(Xv, pred_leaf=True),
                          b_front.predict(Xv, pred_leaf=True))
    if not same:
        raise AssertionError("serial and frontier trees differ at 63 leaves")
    runs["serial_equals_frontier_pred_leaf"] = same

    # 200k rows, 3 iterations: the features only the serial grower serves
    Xs, ys = make_higgs_like(N_SERIAL_SMALL, N_FEAT, seed=48)
    dss = lgt.Dataset(Xs, label=ys, params=base).construct(device="cuda")
    it = ITERS_SERIAL_SMALL
    pair("interaction_constraints", dss, dict(
        base, interaction_constraints=[[0, 1, 4], [2, 3, 5],
                                       list(range(6, N_FEAT))]),
         it, {"hist_full"})
    with tempfile.TemporaryDirectory() as td:
        forced_f = os.path.join(td, "forced.json")
        with open(forced_f, "w") as fh:
            json.dump(SERIAL_FORCED, fh)
        b = pair("forced_splits", dss, dict(base,
                                            forcedsplits_filename=forced_f),
                 it, {"hist_full"})
    root = b.dump_model()["tree_info"][0]["tree_structure"]
    if (root["split_feature"], root["left_child"]["split_feature"],
            root["right_child"]["split_feature"]) != (0, 1, 2):
        raise AssertionError("the forced splits did not land")
    pair("cegb", dss, dict(base, cegb_penalty_split=1e-5,
                           cegb_penalty_feature_coupled=[50.0] * N_FEAT),
         it, {"hist_full"})
    # the directions are the Dataset's (its device metadata), as in the
    # knobs phase's monotone run
    mono = dict(base, monotone_constraints=[1] + [0] * (N_FEAT - 1))
    dsm = lgt.Dataset(Xs, label=ys, params=mono).construct(device="cuda")
    for method in ("intermediate", "advanced"):
        b = pair(f"monotone_{method}", dsm, dict(
            mono, monotone_constraints_method=method), it, {"hist_full"})
        step = _monotone_along(b, Xv, 0, +1)
        if step < -1e-9:
            raise AssertionError(f"monotone {method}: a prediction falls "
                                 f"by {-step} along feature 0")
        runs[f"monotone_{method}"]["min_step_along_feature_0"] = step
    lin = dict(base, linear_tree=True, tree_grower="serial")
    dsl = lgt.Dataset(Xs, label=ys, params=lin).construct(device="cuda")
    pair("linear_tree", dsl, lin, it, {"hist_full"})
    pair("feature_contri_frontier", dss, dict(
        base, feature_contri=[1.0, 0.5] + [1.0] * (N_FEAT - 2)), it,
         {"hist_full", "hist_leaves"}, serial_run=False)

    # K1 on the serial grower's own inputs, and where a serial tree's time
    # goes (the profiler on)
    dev = torch.device("cuda", torch.cuda.current_device())
    blocks = {"hist_full": {}, "onehot_full": {}}
    for name, blk in _serial_blocks(lgt, ds, serial).items():
        a, o = _hold_serial_block(hist, dev, name, blk)
        blocks["hist_full"][name], blocks["onehot_full"][name] = a, o
        for kname, r in (("hist_full", a), ("onehot_full staged", o)):
            print(f"serial block {name} {r['shape']}: {kname} relerr "
                  f"{r['relerr']:.3g}, kernel {_f4(r['kernel_ms'])} ms, call "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"index_add_ {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms", flush=True)
    runs["blocks"] = blocks
    runs["profile"] = {"default_1m": _serial_profile(lgt, ds, serial),
                       "default_200k": _serial_profile(lgt, dss, serial)}
    for pname, pr in runs["profile"].items():
        print(f"serial profile {pname}: {pr}", flush=True)

    # the sklearn estimator on the card (this machine may lack sklearn:
    # the estimators then derive from stand-in bases)
    from lightgbm_tpu_torch.sklearn import LGBMClassifier, _SKLBase
    clf = LGBMClassifier(n_estimators=it, num_leaves=SERIAL_LEAVES,
                         max_bin=255, device="cuda")
    t0 = time.perf_counter()
    clf.fit(Xs, ys.astype(int))
    p_clf = clf.predict_proba(Xv)[:, 1]
    fit_predict_s = time.perf_counter() - t0
    api = lgt.train(dict(base, learning_rate=0.1), lgt.Dataset(Xs, label=ys),
                    it, verbose_eval=False, device="cuda")
    if not np.array_equal(p_clf, api.predict(Xv)):
        raise AssertionError("LGBMClassifier predicts another model than "
                             "train")
    runs["sklearn_classifier"] = {
        "rows": N_SERIAL_SMALL, "fit_predict_s": fit_predict_s,
        "sklearn_present": _SKLBase is not object,
        "predictions_equal_train_api": True}
    emit({"phase": "serial", "card": card, "features": N_FEAT,
          "num_leaves": SERIAL_LEAVES, **runs})
    return launches, blocks


def _noisy_latent(X, seed):
    rng = np.random.default_rng(seed)
    return higgs_latent(X) + 0.5 * rng.normal(size=len(X))


def _rng_gate(dev):
    """The counter-based draws on the card are bit-identical to the CPU's:
    the bagging draw of 1M rows and a bynode draw of 2k = 32 children."""
    from lightgbm_tpu_torch.ops.grower import node_feature_mask_for
    from lightgbm_tpu_torch.utils import random_gen
    key = random_gen.key_for_iteration(3, 0)
    u_cpu = random_gen.uniform(key, N_TRAIN)
    u_card = random_gen.uniform(key.to(dev), N_TRAIN)
    steps = torch.arange(1, 33)
    fmask = torch.ones(N_FEAT)
    fmask[[3, 9, 17, 22, 27]] = 0.0                 # a feature_fraction draw
    m_cpu = node_feature_mask_for(key, steps, fmask, 0.8)
    m_card = node_feature_mask_for(key.to(dev), steps.to(dev), fmask.to(dev),
                                   0.8)
    same = {"uniform_1m": torch.equal(u_card.cpu(), u_cpu),
            "bynode_32x28": torch.equal(m_card.cpu(), m_cpu)}
    if not all(same.values()):
        raise AssertionError(f"card draws differ from the CPU's: {same}")
    return {"bit_identical": same, "uniform_mean": float(u_card.mean())}


class _RowsSeen:
    """Records the rows of every ``hist_full``/``hist_leaves`` launch (the
    kernel wrappers themselves; the plain versions are not patched)."""

    def __init__(self, hist):
        self.hist = hist
        self.rows = {"hist_full": [], "hist_leaves": []}

    def __enter__(self):
        self.orig = {k: getattr(self.hist, k) for k in self.rows}
        for k, fn in self.orig.items():
            def rec(mat, *a, _k=k, _fn=fn, **kw):
                self.rows[_k].append(int(mat.shape[0]))
                return _fn(mat, *a, **kw)
            setattr(self.hist, k, rec)
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.hist, k, fn)


def phase_knobs(card, data):
    """The training knobs, objectives and boosting types on the card's
    atomic kernels (the examples' settings, ``examples/*/train.conf``):
    each run once through the kernels and once under ``force_plain()``,
    tree 0 identical, the held-out metric within tolerance of the plain
    run's and better than the constant model's."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    ds, X, Xv, yv = data
    dev = torch.device("cuda")
    atomic = {"hist_full", "hist_leaves"}
    base = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
            "learning_rate": 0.1, "verbose": -1}
    auc = auc_holdout(Xv, yv, floor=0.5)
    runs = {"rng": _rng_gate(dev)}

    def pair(name, d, params, iters, metric, check_tree0=True):
        booster, out = _train_pair(lgt, hist, d, params, iters, Xv, yv,
                                   atomic, metric=metric)
        if check_tree0 and not out["tree0_identical"]:
            raise AssertionError(f"{name}: tree 0 differs between kernel "
                                 "and plain runs")
        cap = booster._gbdt._bag_subset_capacity()
        out["cap"] = cap
        print(f"{name}: s/tree {out['kernel']['s_per_tree']:.4f}, "
              f"launches/tree {out['launches_per_tree']}, cap {cap}",
              flush=True)
        runs[name] = out
        return booster, out

    # the binary example's knobs: a masked bag (fraction 0.8 is not
    # compacted), feature_fraction 0.8
    pair("binary_sampling", ds, dict(base, feature_fraction=0.8,
                                     bagging_freq=5, bagging_fraction=0.8),
         20, auc)
    # the compacted bag, with the per-node draws: every histogram over
    # cap rows
    compact = dict(base, bagging_fraction=0.5, bagging_freq=1,
                   feature_fraction_bynode=0.8, extra_trees=True)
    with _RowsSeen(hist) as seen:
        _, out = pair("bag_compaction", ds, compact, 10, auc)
    cap, k, br = out["cap"], 16, 512
    if not (cap and set(seen.rows["hist_full"]) == {cap}
            and max(seen.rows["hist_leaves"]) <= cap // 2 + k * br):
        raise AssertionError(f"compaction: cap {cap}, hist_full rows "
                             f"{sorted(set(seen.rows['hist_full']))}, "
                             f"hist_leaves rows up to "
                             f"{max(seen.rows['hist_leaves'])}")
    out["hist_full_rows"] = cap
    out["hist_leaves_rows_max"] = max(seen.rows["hist_leaves"])
    with _RowsSeen(hist) as seen:
        _, out = pair("goss", ds, dict(base, boosting="goss", top_rate=0.2,
                                       other_rate=0.1), 10, auc)
    out["hist_full_rows"] = sorted(set(seen.rows["hist_full"]))

    # multiclass: 5 classes from quantiles of the latent score, the
    # multiclass example's settings
    lat, lat_v = _noisy_latent(X, 1), _noisy_latent(Xv, 2)
    q = np.quantile(lat, [0.2, 0.4, 0.6, 0.8])
    y5, y5v = np.digitize(lat, q), np.digitize(lat_v, q)
    prior = np.bincount(y5, minlength=5) / len(y5)

    def mlogloss(b):
        p = np.clip(b.predict(Xv)[np.arange(len(y5v)), y5v], 1e-15, 1.0)
        return float(-np.mean(np.log(p)))
    ds.set_field("label", y5.astype(np.float32))
    multi = {"objective": "multiclass", "num_class": 5, "num_leaves": 31,
             "learning_rate": 0.05, "min_data_in_leaf": 50, "max_bin": 255,
             "metric": "multi_logloss", "verbose": -1}
    _, out = pair("multiclass", ds, multi, 10, loss_holdout(
        "multi_logloss", mlogloss, float(-np.mean(np.log(prior[y5v])))))
    if out["launches"]["hist_full"] != 50:
        raise AssertionError(f"multiclass: hist_full ran "
                             f"{out['launches']['hist_full']} times, not 50")

    # regression (L2) with the regression example's settings
    mu, sd = lat.mean(), lat.std()
    yr, yrv = (lat - mu) / sd, (lat_v - mu) / sd
    ds.set_field("label", yr.astype(np.float32))
    reg = {"objective": "regression", "metric": "l2", "num_leaves": 31,
           "learning_rate": 0.05, "feature_fraction": 0.9,
           "bagging_freq": 5, "bagging_fraction": 0.8,
           "min_data_in_leaf": 100, "min_sum_hessian_in_leaf": 5.0,
           "max_bin": 255, "verbose": -1}
    pair("regression_l2", ds, reg, 20, loss_holdout(
        "l2", lambda b: float(np.mean((b.predict(Xv) - yrv) ** 2)),
        float(np.mean((yrv - yr.mean()) ** 2))))

    # 200k rows: L1 (leaf renewal on the host), DART, RF
    Xs, ys = make_higgs_like(N_SMALL, N_FEAT, seed=45)
    lat_s = (_noisy_latent(Xs, 3) - mu) / sd
    dss = lgt.Dataset(Xs, label=lat_s.astype(np.float32),
                      params=base).construct(device="cuda")
    pair("regression_l1", dss, dict(reg, objective="regression_l1",
                                    metric="l1"), 5, loss_holdout(
        "l1", lambda b: float(np.mean(np.abs(b.predict(Xv) - yrv))),
        float(np.mean(np.abs(yrv - np.median(lat_s))))))
    dss.set_field("label", ys)
    pair("dart", dss, dict(base, boosting="dart"), 10, auc)
    pair("rf", dss, dict(base, boosting="rf", bagging_fraction=0.5,
                         bagging_freq=1, feature_fraction=0.8), 10, auc)
    # monotone-basic: +1 on feature 0 (the latent score's 1.2 x0)
    mono = dict(base, monotone_constraints=[1] + [0] * (N_FEAT - 1))
    dsm = lgt.Dataset(Xs, label=ys, params=mono).construct(device="cuda")
    booster, out = pair("monotone_basic", dsm, mono, 10, auc)
    grid = np.linspace(-3.0, 3.0, 41, dtype=np.float32)
    rows = np.repeat(Xv[:200], len(grid), axis=0)
    rows[:, 0] = np.tile(grid, 200)
    p = booster.predict(rows, raw_score=True).reshape(200, len(grid))
    worst = float(np.diff(p, axis=1).min())
    if worst < -1e-9:
        raise AssertionError(f"monotone: a prediction falls by {-worst} "
                             "along feature 0")
    out["min_step_along_feature_0"] = worst
    emit({"phase": "knobs", "card": card, "features": N_FEAT, **runs})
    return {name: r["launches"] for name, r in runs.items() if name != "rng"}


def breadth_data():
    """The sparse_efb phase's data, made first: the kernels phase holds the
    atomic kernels against their plain versions on its bundle matrix.
    Returns the Allstate-shaped CSR train and held-out sets, the card
    Dataset (its construct seconds) and its device bundle matrix."""
    import lightgbm_tpu_torch as lgt
    X, y = make_allstate_like(N_ALLSTATE, seed=46)
    Xv, yv = make_allstate_like(N_ALLSTATE_VALID, seed=47)
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params={"verbose": -1}).construct(
        device="cuda")
    construct_s = time.perf_counter() - t0
    dd = ds._inner.device_data("cuda")
    if dd.efb is None or dd.bins.dtype != torch.uint16:
        raise AssertionError(f"Allstate-shaped data: bundles "
                             f"{dd.efb is not None}, bins {dd.bins.dtype}")
    return {"X": X, "y": y, "Xv": Xv, "yv": yv, "ds": ds,
            "construct_s": construct_s, "bins": dd.bins,
            "bundle_bins": dd.bundle_bins}


def _breadth_pair(lgt, hist, name, ds, params, iters, metric, X_pred,
                  expect=("hist_full", "hist_leaves")):
    """One data-breadth run through the kernels (``expect``: the kernels
    it must launch, and no other) and under force_plain(): tree 0
    identical, the held-out metric as ``_train_pair`` holds it, and the
    reloaded model predicting ``X_pred`` bit-identically.  Prints s/tree,
    launches a tree and the kernel width."""
    booster, out = _train_pair(lgt, hist, ds, params, iters, None, None,
                               set(expect), metric=metric)
    if not out["tree0_identical"]:
        raise AssertionError(f"{name}: tree 0 differs between kernel and "
                             "plain runs")
    gcfg = booster._gbdt._grower_cfg
    out["kernel_width"] = gcfg.bundle_bins or gcfg.max_bin
    out["bin_dtype"] = str(ds._inner.bins.dtype)
    p_mem = booster.predict(X_pred, raw_score=True)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "model.txt")
        booster.save_model(path)
        p_file = lgt.Booster(model_file=path, device="cuda").predict(
            X_pred, raw_score=True)
    if not (np.isfinite(p_mem).all() and np.array_equal(p_mem, p_file)):
        raise AssertionError(f"{name}: reloaded predictions differ")
    out["reload_bit_identical"] = True
    print(f"{name}: s/tree {out['kernel']['s_per_tree']:.4f} (plain "
          f"{out['plain']['s_per_tree']:.4f}), launches/tree "
          f"{out['launches_per_tree']}, kernel width {out['kernel_width']} "
          f"({out['bin_dtype']}), held-out {metric['name']} "
          f"{out['kernel'][metric['name'] + '_holdout']:.6f}", flush=True)
    return booster, out


def _ndcg_holdout(Xv, yv, qv, k: int = 5):
    """NDCG@k of the held-out queries (the port's metric), gated against
    the constant model's (every score 0: the documents in their order)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.metric.rank import NDCGMetric
    md = Metadata(len(yv))
    md.set_field("label", yv)
    md.set_field("group", qv)
    m = NDCGMetric(Config.from_params({"eval_at": [k]}))
    m.init(md, len(yv))

    def ndcg(scores):
        return m.eval(np.asarray(scores, np.float64))[0][1]
    return {"name": f"ndcg@{k}", "higher": True, "tol": 1e-3,
            "floor": ndcg(np.zeros(len(yv))),
            "fn": lambda b: ndcg(b.predict(Xv, raw_score=True))}


def phase_rank(card):
    """lambdarank at MS LTR width (the Experiments settings: 255 leaves,
    lr 0.1, min_data_in_leaf=1, min_sum_hessian_in_leaf=100), 5
    iterations, then rank_xendcg, 3; the card's xendcg draw equal to the
    CPU's."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    sh = MSLR_SHAPE
    X, y, q = make_mslr_like(sh["rows"], sh["features"], seed=48,
                             longest=sh["longest"], docs=sh["docs"])
    Xv, yv, qv = make_mslr_like(sh["valid"], sh["features"], seed=49,
                                longest=sh["longest"], docs=sh["docs"])
    params = {"objective": "lambdarank", "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 1,
              "min_sum_hessian_in_leaf": 100, "ndcg_eval_at": [1, 3, 5],
              "max_bin": 255, "verbose": -1}
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, group=q, params=params).construct(
        device="cuda")
    construct_s = time.perf_counter() - t0
    metric = _ndcg_holdout(Xv, yv, qv)
    runs = {}
    booster, runs["lambdarank"] = _breadth_pair(
        lgt, hist, "rank lambdarank", ds, params, ITERS_BREADTH, metric, Xv)
    xe = dict(params, objective="rank_xendcg")
    booster, runs["rank_xendcg"] = _breadth_pair(
        lgt, hist, "rank rank_xendcg", ds, xe, 3, metric, Xv)
    obj = booster._gbdt.objective
    same = all(torch.equal(obj.draw(it, "cuda").cpu(), obj.draw(it, "cpu"))
               for it in (0, 2))
    if not same:
        raise AssertionError("rank_xendcg: the card's draw differs from "
                             "the CPU's")
    emit({"phase": "rank", "card": card, "rows": sh["rows"],
          "features": sh["features"], "queries": len(q),
          "longest_query": int(q.max()), "padded_width": obj.L,
          "construct_s": construct_s, "xendcg_draw_bit_identical": True,
          "ndcg5_constant": metric["floor"], **runs})
    return {k: r["launches"] for k, r in runs.items()}


def _cat_split_kinds(booster):
    """(one-hot splits, sorted-subset splits) over the booster's trees."""
    onehot = subset = 0
    for t in booster._gbdt.models:
        for j in range(t.num_leaves - 1):
            if t.is_categorical_split(j):
                c = int(t.threshold[j])
                words = t.cat_threshold[t.cat_boundaries[c]:
                                        t.cat_boundaries[c + 1]]
                bits = sum(bin(int(w) & 0xFFFFFFFF).count("1")
                           for w in words)
                onehot, subset = onehot + (bits == 1), subset + (bits > 1)
    return onehot, subset


def phase_categorical(card):
    """The airline data's six categorical columns: binary, 255 leaves, 5
    iterations at max_cat_to_onehot=4 (every categorical column takes the
    sorted scan) and at 8 (DayOfWeek's 7 levels take the one-hot
    splits)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    X, y = make_airline_like(N_AIRLINE, seed=50)
    Xv, yv = make_airline_like(N_AIRLINE_VALID, seed=51)
    cats = [0, 1, 2, 3, 4, 5]
    base = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
            "max_bin": 255, "verbose": -1}
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, categorical_feature=cats,
                     params=base).construct(device="cuda")
    construct_s = time.perf_counter() - t0
    runs = {}
    for cap in (4, 8):
        params = dict(base, max_cat_to_onehot=cap)
        booster, out = _breadth_pair(lgt, hist, f"categorical onehot<={cap}",
                                     ds, params, ITERS_BREADTH,
                                     auc_holdout(Xv, yv, floor=0.5), Xv)
        sc = booster._gbdt._grower_cfg.sorted_cat
        out["sorted_scan_features"] = list(sc)
        out["onehot_splits"], out["subset_splits"] = _cat_split_kinds(
            booster)
        if out["subset_splits"] == 0 or (cap == 8) == (2 in sc):
            raise AssertionError(f"categorical onehot<={cap}: sorted scan "
                                 f"on {sc}, splits {out}")
        runs[f"max_cat_to_onehot_{cap}"] = out
    emit({"phase": "categorical", "card": card, "rows": N_AIRLINE,
          "construct_s": construct_s, **runs})
    return {k: r["launches"] for k, r in runs.items()}


def _row_wise_vs_atomic(lgt, hist, name, ds, params, iters, atomic, Xv,
                        yv, floor, expect, used):
    """A force_row_wise run of a data-breadth phase (``_breadth_pair``:
    tree 0 identical to the plain run's, held-out AUC within 1e-3 of it,
    reload bit-identical) with the one-hot body ``used`` and one
    ``onehot_full`` a tree, its held-out AUC also within 1e-3 of the
    atomic booster's at the same iterations."""
    _, out = _breadth_pair(lgt, hist, name, ds, params, iters,
                           auc_holdout(Xv, yv, floor=floor), Xv,
                           expect=expect)
    if (out["hist_method"], out["hist_variant"]) != ("onehot", used) or \
            out["launches"]["onehot_full"] != iters:
        raise AssertionError(f"{name}: {out}")
    gap = abs(out["kernel"]["auc_holdout"]
              - _auc(atomic.predict(Xv, raw_score=True, num_iteration=iters),
                     yv))
    if gap > AUC_TOL:
        raise AssertionError(f"{name}: AUC {gap} from the atomic run's")
    out["vs_atomic_auc_gap"] = gap
    return out


def phase_wide_bins(card, elected):
    """Higgs geometry at max_bin=1023: the u16 bin matrix and the atomic
    kernels' u16 instantiations at B = 1,024; then force_row_wise with
    staged and int8 (5 iterations each) and auto (3, the elected body):
    the one-hot kernels' u16 instantiations, every per-leaf call inside
    the leaves cut (28 x 1,024 lanes)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    X, y = make_higgs_like(N_TRAIN, N_FEAT, seed=52)
    Xv, yv = make_higgs_like(N_VALID, N_FEAT, seed=43)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 1023,
              "learning_rate": 0.1, "verbose": -1}
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params=params).construct(device="cuda")
    construct_s = time.perf_counter() - t0
    booster, out = _breadth_pair(lgt, hist, "wide_bins", ds, params,
                                 ITERS_BREADTH, auc_holdout(Xv, yv), Xv)
    if out["kernel_width"] != 1024 or out["bin_dtype"] != "uint16":
        raise AssertionError(f"wide_bins: {out}")
    one_hot = ("onehot_full", "onehot_leaves")
    row_wise = {}
    for tag, variant, iters in (("staged", "staged", ITERS_BREADTH),
                                ("int8", "int8", ITERS_BREADTH),
                                ("auto", None, ITERS_WIDE_AUTO)):
        p = dict(params, force_row_wise=True)
        if variant is not None:
            p["hist_variant"] = variant
        used = variant or elected[1024]
        row_wise[tag] = _row_wise_vs_atomic(
            lgt, hist, f"wide_bins row_wise {tag}", ds, p, iters, booster,
            Xv, yv, 0.75, one_hot + (("onehot_quant",) if used == "int8"
                                     else ()), used)
    emit({"phase": "wide_bins", "card": card, "construct_s": construct_s,
          **out, "row_wise": row_wise})
    return {"wide_bins": out["launches"],
            **{f"wide_{t}": r["launches"] for t, r in row_wise.items()}}


def phase_sparse_efb(card, data):
    """Allstate geometry as CSR: sparse binning, EFB bundles of u16
    columns, the atomic kernels at the bundle width, and sparse prediction
    input (equal to the dense input's); then force_row_wise staged (3
    iterations): the one-hot root at the bundle width, and the per-leaf
    histograms by hist_leaves (35 bundle columns x 2,688 lanes lie outside
    the leaves cut)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    ds, Xv, yv = data["ds"], data["Xv"], data["yv"]
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "enable_bundle": True, "verbose": -1}
    booster, out = _breadth_pair(lgt, hist, "sparse_efb", ds, params,
                                 ITERS_BREADTH, auc_holdout(Xv, yv,
                                                            floor=0.5), Xv)
    inner = ds._inner
    if out["kernel_width"] != data["bundle_bins"]:
        raise AssertionError(f"sparse_efb: kernel width {out}")
    part = Xv[:2000]
    if not np.array_equal(booster.predict(part),
                          booster.predict(part.toarray())):
        raise AssertionError("sparse_efb: CSR input predicts otherwise "
                             "than its dense twin")
    rw = _row_wise_vs_atomic(
        lgt, hist, "sparse_efb row_wise staged", ds,
        dict(params, force_row_wise=True, hist_variant="staged"),
        ITERS_EFB_ROW_WISE, booster, Xv, yv, 0.5,
        ("onehot_full", "hist_leaves"), "staged")
    emit({"phase": "sparse_efb", "card": card, "rows": N_ALLSTATE,
          "columns": data["X"].shape[1], "nnz": int(data["X"].nnz),
          "features": inner.num_features, "bundles": len(inner.bundles),
          "bundle_widths_top": sorted(int(w) for w in
                                      inner.bundle_widths)[-4:],
          "construct_s": data["construct_s"], "sparse_equals_dense": True,
          **out, "row_wise_staged": rw})
    return {"sparse_efb": out["launches"], "efb_staged": rw["launches"]}


def phase_widest_bins(card):
    """Higgs geometry at max_bin=65535, the JAX package's widest: every
    feature 65,535 bins, the atomic kernels at B = 65,536 in bin tiles (8
    of 8,192 a feature), 255 leaves, 5 iterations; then force_row_wise
    staged for 3: K1's bucketed one-hot kernel at B = 65,536 and the
    per-leaf histograms by hist_leaves (28 x 65,536 lanes lie outside the
    leaves cut).  Each run as ``_breadth_pair`` holds it (tree 0 identical
    to force_plain()'s, held-out AUC within 1e-3 of plain and above 0.75,
    reload bit-identical), the row-wise run's AUC also within 1e-3 of the
    atomic run's; with the plans' bin tiles and scratch bytes and the
    phase's peak device memory (the frontier's leaf store alone is 255 x
    28 x 65,536 x 3 float32, 5.6 GB)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    X, y = make_higgs_like(N_TRAIN, N_FEAT, seed=53)
    Xv, yv = make_higgs_like(N_VALID, N_FEAT, seed=43)
    params = {"objective": "binary", "num_leaves": 255,
              "max_bin": MAX_BIN_WIDEST, "learning_rate": 0.1, "verbose": -1}
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params=params).construct(device="cuda")
    construct_s = time.perf_counter() - t0
    del X
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    booster, out = _breadth_pair(lgt, hist, "widest_bins", ds, params,
                                 ITERS_BREADTH, auc_holdout(Xv, yv), Xv)
    width = out["kernel_width"]
    if width != WIDE_WIDTHS[-1] or out["bin_dtype"] != "uint16":
        raise AssertionError(f"widest_bins: {out}")
    dev = torch.device("cuda", torch.cuda.current_device())
    LS = LEAVES_SHAPE
    plans = {"hist_full": _atomic_attrs(hist, "hist_full", dev, N_TRAIN,
                                        N_FEAT, N_FEAT, width, esz=2),
             "hist_leaves": _atomic_attrs(hist, "hist_leaves", dev,
                                          LS["C"] // LS["BR"], N_FEAT + 6,
                                          N_FEAT, width, LS["k"], esz=2)}
    if any(p["tiles"] < 2 for p in plans.values()):
        raise AssertionError(f"widest_bins: untiled plans {plans}")
    rw = _row_wise_vs_atomic(
        lgt, hist, "widest_bins row_wise staged", ds,
        dict(params, force_row_wise=True, hist_variant="staged"),
        ITERS_WIDEST_ROW_WISE, booster, Xv, yv, 0.75,
        ("onehot_full", "hist_leaves"), "staged")
    peak = torch.cuda.max_memory_allocated()
    print(f"widest_bins: kernel width {width}, bin tiles "
          f"{plans['hist_full']['tiles']} of "
          f"{plans['hist_full']['tile_bins']}, scratch a call "
          f"{plans['hist_full']['scratch_bytes']} bytes (K1, 1M rows), "
          f"{plans['hist_leaves']['scratch_bytes']} (K2, 262,144 rows), "
          f"peak device memory {peak} bytes, construct {construct_s:.3f} s",
          flush=True)
    emit({"phase": "widest_bins", "card": card, "construct_s": construct_s,
          **out, "plans": plans, "peak_memory_bytes": peak,
          "row_wise_staged": rw})
    return {"widest_bins": out["launches"], "widest_staged": rw["launches"]}


# the engine phase: the binary example's parameters (train.conf) on Higgs
# geometry through the command line and the rest of the engine surface
ENGINE_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "binary_classification", "train.conf")
N_ENGINE, N_ENGINE_CV, ENGINE_ITERS = 1_000_000, 300_000, 20
# continued training starts from a model of this many trees, inside the
# binary example's bagging period of 5
ENGINE_INIT_ITERS = 7
N_CONTRIB = 10_000


def _write_tsv(path, X, y):
    """examples/generate_data.py's layout: TSV, the label in column 0; each
    float32 value to nine digits, which name it exactly."""
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.9g")


def _tree_lines(text):
    return [line for line in text.split("end of trees")[0].splitlines()
            if not line.startswith(("tree_sizes", "feature_infos"))]


def _same_trees(a, b):
    """Model texts with the same trees: every header and tree line equal
    (the sizes and feature ranges aside)."""
    for x, z in zip(_tree_lines(a), _tree_lines(b)):
        if x != z:
            raise AssertionError(f"tree lines differ: {x[:80]} / {z[:80]}")
    if len(_tree_lines(a)) != len(_tree_lines(b)):
        raise AssertionError("the models have different lengths")


def _timed(steps, name, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    steps[name] = time.perf_counter() - t0
    return out


def phase_engine(card):
    """The engine surface on the card: the command line on the binary
    example's train.conf (1M x 28 TSV with a .weight sidecar, 20 trees),
    its predict, convert_model and refit tasks, the binary cache,
    init_model and rollback, a custom objective, cv and pred_contrib."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import application, native
    from lightgbm_tpu_torch.io.dataset import Dataset as Inner
    from lightgbm_tpu_torch.io.loader import load_file
    from lightgbm_tpu_torch.ops import histogram as hist
    setup, steps, out = {}, {}, {}
    X, y = make_higgs_like(N_ENGINE, N_FEAT, seed=45)
    Xv, yv = make_higgs_like(N_VALID, N_FEAT, seed=46)
    w = np.random.default_rng(47).uniform(0.5, 1.5, N_ENGINE).round(4)
    conf = application.parse_config_file(ENGINE_CONF)
    params = {k: v for k, v in conf.items()
              if k not in ("task", "data", "valid_data", "output_model",
                           "num_trees")}
    params["verbose"] = -1
    res = os.path.join("chiprun_out", "engine")
    os.makedirs(res, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        train_f, test_f = (os.path.join(td, n)
                           for n in ("binary.train", "binary.test"))
        t0 = time.perf_counter()
        _write_tsv(train_f, X, y)
        np.savetxt(train_f + ".weight", w, fmt="%.4f")
        _write_tsv(test_f, Xv, yv)
        setup["write_files_s"] = time.perf_counter() - t0
        # the native parser, timed alone, and its matrix held to the arrays
        # (training file: nine digits name each float32, so the parse
        # rounds back to it) and to the numpy loader (held-out file).  The
        # API trains on the parsed matrix, the values the file holds: a
        # double within 1e-9 of a float32 can fall in another bin than the
        # float32 itself when a bin bound lies between them
        calls = dict(native.native_calls)
        t0 = time.perf_counter()
        Xp, yp = load_file(train_f)[:2]
        setup["parse_1m_rows_s"] = time.perf_counter() - t0
        if not (np.array_equal(Xp.astype(np.float32), X)
                and np.array_equal(yp, y)):
            raise AssertionError("the parsed file is not its arrays")
        Xv_native = load_file(test_f)[0]
        Xv_numpy = np.genfromtxt(test_f, delimiter="\t", dtype=np.float64)
        if not np.allclose(Xv_native, Xv_numpy[:, 1:], rtol=1e-14, atol=0):
            raise AssertionError("native and numpy parses differ")
        model_f = os.path.join(res, "model.txt")
        hist.reset_launch_counts()
        rc = _timed(steps, "cli_train", lambda: application.main([
            f"config={ENGINE_CONF}", f"data={train_f}",
            f"valid_data={test_f}", f"num_trees={ENGINE_ITERS}",
            f"output_model={model_f}", "verbose=-1"]))
        launches = dict(hist.launch_counts)
        if rc != 0:
            raise AssertionError(f"the train task returned {rc}")
        if not (launches["hist_full"] == ENGINE_ITERS
                and launches["hist_leaves"] > 0
                and sum(launches.values()) == launches["hist_full"]
                + launches["hist_leaves"]):
            raise AssertionError(f"the CLI run launched {launches}")
        used = {k: native.native_calls[k] - calls[k] for k in calls}
        if not (used["parse_delimited"] >= 4 and used["bin_values"] >= 2):
            raise AssertionError(f"the native library served {used}")
        out["native_calls"] = used
        cli_text = open(model_f).read()
        # the file's matrix and weights through the API, kernels and plain
        ds = lgt.Dataset(Xp, label=y, weight=w)
        api = _timed(steps, "api_train", lambda: lgt.train(
            params, ds, ENGINE_ITERS, verbose_eval=False, device="cuda"))
        _same_trees(api.model_to_string(), cli_text)
        with hist.force_plain():
            plain = _timed(steps, "api_train_plain", lambda: lgt.train(
                params, ds, ENGINE_ITERS, verbose_eval=False, device="cuda"))
        # the predict task, bit for bit Booster.predict on the file
        pred_f = os.path.join(res, "predictions.txt")
        rc = _timed(steps, "cli_predict", lambda: application.main([
            "task=predict", f"data={test_f}", f"input_model={model_f}",
            f"output_result={pred_f}"]))
        loaded = lgt.Booster(model_file=model_f, device="cuda")
        p_file, p_api = np.loadtxt(pred_f), loaded.predict(test_f)
        if rc != 0 or not np.array_equal(p_file, p_api):
            raise AssertionError("the predict task's file is not "
                                 "Booster.predict's")
        auc_cli = _auc(p_file, yv)
        auc_plain = _auc(plain.predict(Xv), yv)
        if not (auc_cli > 0.5 and abs(auc_cli - auc_plain) <= AUC_TOL):
            raise AssertionError(f"held-out AUC {auc_cli} (plain "
                                 f"{auc_plain})")
        cpp_f = os.path.join(res, "model.cpp")
        rc = _timed(steps, "cli_convert_model", lambda: application.main([
            "task=convert_model", f"input_model={model_f}",
            f"convert_model={cpp_f}"]))
        if rc != 0 or "PredictRaw" not in open(cpp_f).read():
            raise AssertionError("convert_model wrote no model code")
        # the binary cache: tree 0 of the cache's training is the arrays'
        cache_f = os.path.join(td, "train.bin")
        _timed(steps, "save_binary", lambda: ds.save_binary(cache_f))
        cached = lgt.Dataset(None, params=params)
        cached._inner = _timed(steps, "load_binary",
                               lambda: Inner.load_binary(cache_f))
        one = lgt.train(params, cached, 1, verbose_eval=False, device="cuda")
        if one._gbdt.models[0].to_text(0) != api._gbdt.models[0].to_text(0):
            raise AssertionError("the cache trains another tree 0")
        # init_model: 7 + 13 iterations from a saved model; then a
        # rollback and one more update reproduce the last tree
        half = os.path.join(td, "half.txt")
        lgt.train(params, ds, ENGINE_INIT_ITERS, verbose_eval=False,
                  device="cuda").save_model(half)
        cont = _timed(steps, "init_model_train", lambda: lgt.train(
            params, ds, ENGINE_ITERS - ENGINE_INIT_ITERS, init_model=half,
            verbose_eval=False, device="cuda"))
        gap = float(np.max(np.abs(cont.predict(Xv) - api.predict(Xv))))
        if cont.num_trees() != ENGINE_ITERS or gap > 1e-5:
            raise AssertionError(f"init_model predicts {gap} from the "
                                 "single run")
        last = cont.model_to_string()
        _timed(steps, "rollback_update",
               lambda: (cont.rollback_one_iter(), cont.update()))
        if cont.model_to_string() != last:
            raise AssertionError("rollback + update changed the last tree")
        # fobj: binary logloss as a function of the host scores
        base = {k: v for k, v in params.items() if k != "objective"}

        def fobj(score, dataset):
            p = 1.0 / (1.0 + np.exp(-score))
            return (p - y) * w, p * (1.0 - p) * w

        hist.reset_launch_counts()
        custom = _timed(steps, "fobj_train", lambda: lgt.train(
            base, ds, ENGINE_ITERS // 2, fobj=fobj, verbose_eval=False,
            device="cuda"))
        fobj_launches = dict(hist.launch_counts)
        builtin = lgt.train(dict(params, boost_from_average=False), ds,
                            ENGINE_ITERS // 2, verbose_eval=False,
                            device="cuda")
        auc_fobj = _auc(custom.predict(Xv, raw_score=True), yv)
        auc_builtin = _auc(builtin.predict(Xv, raw_score=True), yv)
        if abs(auc_fobj - auc_builtin) > AUC_TOL:
            raise AssertionError(f"fobj AUC {auc_fobj} vs {auc_builtin}")
        # cv: 3 folds of 300k rows, 10 iterations, kernels and plain
        cv_params = dict(params, metric="auc")
        cv_ds = lgt.Dataset(X[:N_ENGINE_CV], label=y[:N_ENGINE_CV])
        hist.reset_launch_counts()
        cv_k = _timed(steps, "cv", lambda: lgt.cv(
            cv_params, cv_ds, ENGINE_ITERS // 2, nfold=3, device="cuda"))
        cv_launches = dict(hist.launch_counts)
        with hist.force_plain():
            cv_p = _timed(steps, "cv_plain", lambda: lgt.cv(
                cv_params, lgt.Dataset(X[:N_ENGINE_CV], label=y[:N_ENGINE_CV]),
                ENGINE_ITERS // 2, nfold=3, device="cuda"))
        cv_auc, cv_auc_plain = (r["valid auc-mean"][-1] for r in (cv_k, cv_p))
        if abs(cv_auc - cv_auc_plain) > AUC_TOL:
            raise AssertionError(f"cv AUC {cv_auc} vs plain {cv_auc_plain}")
        # TreeSHAP: the contributions sum to the raw score
        contrib = _timed(steps, "pred_contrib", lambda: loaded.predict(
            Xv[:N_CONTRIB], pred_contrib=True))
        sum_gap = float(np.max(np.abs(
            contrib.sum(axis=1) - loaded.predict(Xv[:N_CONTRIB],
                                                 raw_score=True))))
        if contrib.shape != (N_CONTRIB, N_FEAT + 1) or sum_gap > 1e-5:
            raise AssertionError(f"pred_contrib sums off by {sum_gap}")
        # refit on the held-out rows
        _timed(steps, "refit", lambda: loaded.refit(Xv, yv))
        auc_refit = _auc(loaded.predict(Xv), yv)
    trees = ENGINE_ITERS
    emit({"phase": "engine", "card": card, "rows": N_ENGINE,
          "valid_rows": N_VALID, "features": N_FEAT, "trees": trees,
          "params": params, "setup": setup, "steps_s": steps,
          "s_per_tree": {"cli": steps["cli_train"] / trees,
                         "api": steps["api_train"] / trees,
                         "api_plain": steps["api_train_plain"] / trees,
                         "init_model": steps["init_model_train"]
                         / (trees // 2),
                         "fobj": steps["fobj_train"] / (trees // 2),
                         "cv_per_fold_tree": steps["cv"] / (3 * trees // 2)},
          "cli_launches": launches, "fobj_launches": fobj_launches,
          "cv_launches": cv_launches, "auc_holdout": {
              "cli": auc_cli, "plain": auc_plain, "fobj": auc_fobj,
              "binary_no_boost_from_average": auc_builtin, "cv": cv_auc,
              "cv_plain": cv_auc_plain, "after_refit": auc_refit},
          "init_model_max_gap": gap, "contrib_sum_gap": sum_gap,
          "cli_trees_equal_api": True, "predict_file_bit_identical": True,
          "cache_tree0_equal": True, "rollback_reproduces_last_tree": True,
          **out})
    return {"engine_cli": launches}


# the serve phase: the train phase's atomic model frozen into one captured
# CUDA graph per default bucket (1,024, 16,384, 262,144 rows)
SERVE_ROWS = (1, 1023, 1024, 1025, 16_384, 300_000)
SERVE_TIMED_CALLS, SERVE_EAGER_CALLS = 50, 5
SERVE_THREADS, SERVE_REQUESTS, SERVE_MAX_ROWS = 8, 200, 64
SERVE_SWAP_ITERS = 10


def _pcts(ms):
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def _host_ms(fn, calls):
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _launch_calls(fn):
    """Runtime launch calls (``cudaLaunchKernel``/``cuLaunchKernel`` and
    ``cudaGraphLaunch``, host rows) and device kernels of one call of
    ``fn`` under torch.profiler."""
    _, dev_rows, host_rows = _profiled(fn, host=True)
    calls = {k: sum(e.count for e in host_rows if k in e.key)
             for k in ("LaunchKernel", "GraphLaunch")}
    kernels = sum(e.count for e in dev_rows
                  if "Memcpy" not in e.key and "Memset" not in e.key)
    return {"kernel_launch_calls": calls["LaunchKernel"],
            "graph_launch_calls": calls["GraphLaunch"],
            "device_kernels": kernels}


def _serve_load(srv_or_art, X, seed, check):
    """``SERVE_THREADS`` threads of ``SERVE_REQUESTS`` requests of 1 to
    ``SERVE_MAX_ROWS`` rows each through ``srv_or_art.predict`` (a batcher
    or a Predictor): every answer must pass ``check(rows, out)``.
    Returns (requests, errors)."""
    import threading
    errors, done = [], [0]
    lock = threading.Lock()

    def client(t):
        rng = np.random.default_rng(seed + t)
        for _ in range(SERVE_REQUESTS):
            a = int(rng.integers(0, len(X) - SERVE_MAX_ROWS))
            rows = slice(a, a + int(rng.integers(1, SERVE_MAX_ROWS + 1)))
            try:
                out = srv_or_art.predict(X[rows], timeout=60)
                if not check(rows, out):
                    raise AssertionError(f"wrong answer for rows {rows}")
                with lock:
                    done[0] += 1
            except Exception as e:      # a drop or an error fails the gate
                with lock:
                    errors.append(repr(e))
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_THREADS)]
    for t in threads:
        t.start()
    return threads, done, errors


def phase_serve(card, booster, data):
    """The serving artifact on the train phase's model (1M x 28 Higgs
    rows, 255 leaves, ``max_bin=255``, 20 iterations, atomic kernels),
    frozen with the default buckets: raw and transformed predictions bit
    for bit ``Booster.predict`` with ``pred_device=device`` at 1, 1,023,
    1,024, 1,025, 16,384 and 300,000 rows; a padded row as in a full
    bucket; three captures before and after every request; ``save``/
    ``load`` the same bits and captures; the parity gate passes.  A
    ``MicroBatcher`` under 8 threads x 200 requests of 1-64 rows answers
    every request as the artifact does and coalesces more than one
    request a batch; a ``Predictor`` hot-swaps under that load to a
    10-iteration model with no request dropped or failed; an artifact
    with its leaf values doubled fails the gate and is rolled back.
    Prints each bucket's p50/p99 ms (host clock, 50 calls) beside the
    eager ``Booster.predict``'s, the launch calls of a request (graph
    against eager, torch.profiler), and each bucket's capture seconds and
    graph pool bytes."""
    from lightgbm_tpu_torch import LightGBMError
    from lightgbm_tpu_torch.serve import (MicroBatcher, Predictor,
                                          PredictorArtifact)
    _, X, Xv, _ = data
    Xs = np.concatenate([Xv, X[:SERVE_ROWS[-1] - len(Xv)]])
    gb = booster._gbdt
    gb.config.pred_device = "device"
    t0 = time.perf_counter()
    art = PredictorArtifact.freeze(booster)
    freeze_s = time.perf_counter() - t0
    if art.buckets != (1024, 16_384, 262_144):
        raise AssertionError(f"default buckets {art.buckets}")

    def captures():
        if art.compile_count != 3 or len(art._graphs) != 3:
            raise AssertionError(f"{art.compile_count} captures")
    bits = {}
    for n in SERVE_ROWS:
        captures()
        for raw in (False, True):
            got = art.predict(Xs[:n], raw_score=raw)
            want = booster.predict(Xs[:n], raw_score=raw)
            if not (got.shape == want.shape and np.array_equal(got, want)):
                raise AssertionError(f"serve: {n} rows (raw={raw}) differ "
                                     "from Booster.predict")
        captures()
        bits[n] = True
    full = art.predict(Xs[:1024])
    if not np.array_equal(art.predict(Xs[7:8]), full[7:8]):
        raise AssertionError("serve: a padded row differs from its bucket")
    captures()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "artifact.txt")
        art.save(path)
        loaded = PredictorArtifact.load(path)
    if loaded.compile_count != 3 or not np.array_equal(
            loaded.predict(Xs[:20_000]), art.predict(Xs[:20_000])):
        raise AssertionError("serve: save/load changed the predictions")
    ok, reason = art.parity_check(Xv[:10_000])
    if not ok:
        raise AssertionError(f"serve: parity gate {reason}")

    # the buckets' latency, graph against eager, and launches a request
    buckets = {}
    for b in art.buckets:
        st = art.capture_stats[b]
        buckets[b] = {"graph": _pcts(_host_ms(lambda: art.predict(Xs[:b]),
                                              SERVE_TIMED_CALLS)),
                      "eager": _pcts(_host_ms(lambda: booster.predict(
                          Xs[:b]), SERVE_EAGER_CALLS)),
                      "capture_s": st["seconds"],
                      "graph_pool_bytes": st["pool_bytes"]}
        print(f"serve bucket {b}: graph p50 "
              f"{buckets[b]['graph']['p50_ms']:.3f} ms p99 "
              f"{buckets[b]['graph']['p99_ms']:.3f} ms, eager p50 "
              f"{buckets[b]['eager']['p50_ms']:.3f} ms, capture "
              f"{st['seconds']:.3f} s, pool {st['pool_bytes']} bytes "
              f"({card})", flush=True)
    launches = {"graph": _launch_calls(lambda: art.predict(Xs[:1024])),
                "eager": _launch_calls(lambda: booster.predict(Xs[:1024]))}
    print(f"serve launches a 1,024-row request: {launches}", flush=True)
    captures()

    # the micro-batcher under load: every answer the artifact's
    direct = art.predict(Xs[:len(Xs)])
    mb = MicroBatcher(art.predict, max_batch_rows=art.buckets[-1],
                      deadline_ms=2.0, queue_depth=4096, name="smoke",
                      num_features=art.num_features)
    try:
        threads, done, errors = _serve_load(
            mb, Xs, 100, lambda rows, out: np.array_equal(out, direct[rows]))
        for t in threads:
            t.join(timeout=300)
        alive = any(t.is_alive() for t in threads)
    finally:
        mb.close()
    stats = dict(mb.stats)
    per_batch = stats["requests"] / max(1, stats["batches"])
    want = SERVE_THREADS * SERVE_REQUESTS
    if alive or errors or done[0] != want or per_batch <= 1.0:
        raise AssertionError(f"batcher: {done[0]}/{want} answered, errors "
                             f"{errors[:3]}, {per_batch} requests a batch")
    captures()

    # a hot swap under that load, then a failed gate rolled back
    art10 = PredictorArtifact.freeze(booster, num_iteration=SERVE_SWAP_ITERS)
    exp10 = art10.predict(Xs[:len(Xs)])
    srv = Predictor(art, batching=True, deadline_ms=2.0, queue_depth=4096)
    try:
        threads, sdone, serrors = _serve_load(
            srv, Xs, 200, lambda rows, out: (np.array_equal(out, direct[rows])
                                             or np.array_equal(out,
                                                               exp10[rows])))
        time.sleep(0.05)
        srv.stage("default", art10)
        gen = srv.swap("default", parity_X=Xv[:2048])
        after = srv.predict(Xs[:64])
        for t in threads:
            t.join(timeout=300)
        alive = any(t.is_alive() for t in threads)
        bad = PredictorArtifact.freeze(booster, num_iteration=SERVE_SWAP_ITERS)
        bad._ens.leaf_value.mul_(2.0)     # the captured graphs read it
        srv.stage("default", bad)
        try:
            srv.swap("default", parity_X=Xv[:2048])
            rolled_back = False
        except LightGBMError as e:
            rolled_back = "mismatch" in str(e)
        still = srv.predict(Xs[:64])
        info = srv.models()["default"]
    finally:
        srv.close()
    if (alive or serrors or sdone[0] != want or gen != 2
            or not np.array_equal(after, exp10[:64])):
        raise AssertionError(f"hot swap: {sdone[0]}/{want} answered, errors "
                             f"{serrors[:3]}, generation {gen}")
    if not (rolled_back and np.array_equal(still, exp10[:64])
            and info["generation"] == 2 and not info["staged"]):
        raise AssertionError("the doubled artifact was not rolled back")
    out = {"phase": "serve", "card": card, "trees": art.num_trees,
           "buckets": list(art.buckets), "freeze_s": freeze_s,
           "bit_identical_rows": bits, "captures": art.compile_count,
           "latency_by_bucket": buckets, "launches_1024_rows": launches,
           "batcher": {"requests": stats["requests"],
                       "batches": stats["batches"],
                       "requests_per_batch": per_batch,
                       "max_batch_requests": stats["max_batch_requests"]},
           "hot_swap": {"requests": sdone[0], "errors": len(serrors),
                        "generation": gen},
           "gate_rolled_back": rolled_back}
    emit(out)
    return out


# the stream phase: the train phase's rows out of core.  The real case is a
# bin matrix larger than the card's 80 GB; the run's time limit forces a
# smaller one, so an 8 MB budget stands in for the card and cuts the 28 MB
# u8 matrix into 17 blocks of 60,544 rows (8e6 // (3 x (28 + 16)) =
# 60,606, floored to a multiple of 128)
STREAM_BUDGET, STREAM_PREFETCH, STREAM_BLOCKS = 8_000_000, 2, 17
STREAM_LEAVES, ITERS_STREAM = 255, 3
# the force_row_wise and u16 runs: 200k rows, 63 leaves, 1 iteration, a
# 2 MB budget (14 and 22 blocks)
N_STREAM_SMALL, STREAM_SMALL_LEAVES, STREAM_SMALL_BUDGET = 200_000, 63, \
    2_000_000


def _structure(booster):
    return [ln for ln in booster.model_to_string().splitlines()
            if ln.startswith(("split_feature=", "threshold=", "left_child=",
                              "right_child=", "leaf_count="))]


def _hidden_share(events, ref):
    """The share of the copies' device time that ran while the compute
    stream was busy with a block: ``events`` holds one (copy start, copy
    end, compute start, compute end) tuple of CUDA events a block, times
    from ``ref`` recorded before all of them."""
    spans = [[ref.elapsed_time(e) for e in ev] for ev in events]
    copies = sorted((a, b) for a, b, _, _ in spans)
    merged = []                 # the compute intervals' union, in order
    for c, d in sorted((c, d) for _, _, c, d in spans):
        if merged and c <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], d)
        else:
            merged.append([c, d])
    total = sum(b - a for a, b in copies)
    hidden, j = 0.0, 0
    for a, b in copies:         # both in start order: one sweep
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            hidden += min(b, merged[k][1]) - max(a, merged[k][0])
            k += 1
    return hidden / total if total > 0 else 0.0, total


def _stream_block_check(hist, dev, matrix, g, h, w, B):
    """K1 on the first streamed block of the matrix (a pinned slot copied
    on the copy stream) against its plain version on the same device
    block, bit for bit, with its times beside the plain version's,
    ``index_add_``'s and the byte bound."""
    from lightgbm_tpu_torch.stream.pipeline import RowBlockPipeline
    pipe = RowBlockPipeline(matrix, STREAM_PREFETCH, device=dev)
    it = pipe.blocks({"g": g, "h": h, "rw": w})
    blk = next(it)
    args = (blk.bins, blk.extras["g"], blk.extras["h"], blk.extras["rw"], B)

    def kernel():
        return hist.hist_full(*args)
    got, again = kernel(), kernel()
    with hist.force_plain():
        ref = hist.build_histogram(*args)
        plain_ms = median_ms(lambda: hist.build_histogram(*args), reps=5)
    torch.cuda.synchronize()
    if not (torch.equal(got, ref) and torch.equal(got, again)):
        raise AssertionError(f"hist_full on a streamed block: relerr "
                             f"{relerr(got, ref)}")
    r, f = blk.bins.shape
    b_ms, b_by = bound(r * f + 12 * r + f * B * 12, 3 * r * f + 2 * r)
    out = {"shape": [r, f, B], "bit_identical": True,
           "max_abs_err": float((got - ref).abs().max()),
           "relerr": relerr(got, ref), "ms": median_ms(kernel),
           "kernel_ms": calls_ms(kernel, ATOMIC_KERNELS["hist_full"]),
           "plain_ms": plain_ms,
           "library_ms": _full_yardstick(dev, blk.bins, *args[1:4], B),
           "bound_ms": b_ms, "bound_by": b_by}
    it.close()
    return out


# --profile: cProfile over one more streamed tree (host time by function,
# chiprun_out/profile_stream.txt)
PROFILE_STREAM = False


def _profile_stream(booster):
    import cProfile
    import io
    import pstats
    events = booster._gbdt.stream_stats.events
    booster._gbdt.stream_stats.events = None
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    booster.update()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    booster.rollback_one_iter()
    booster._gbdt.stream_stats.events = events
    out = io.StringIO()
    st = pstats.Stats(prof, stream=out)
    st.sort_stats("tottime").print_stats(40)
    st.sort_stats("cumulative").print_stats(40)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_stream.txt"), "w") as f:
        f.write(f"one streamed tree under cProfile: {wall:.3f} s\n")
        f.write(out.getvalue())
    print(f"stream profile: one tree {wall:.3f} s under cProfile "
          "(chiprun_out/profile_stream.txt)", flush=True)


def phase_stream(card, data):
    """Out-of-core training on the train phase's rows (1M x 28,
    ``max_bin=255``, 255 leaves, 3 iterations) under an 8 MB budget with
    prefetch 2 (17 blocks of 60,544 rows, ``STREAM_BUDGET``), against the
    in-memory ``tree_grower=serial`` run on the card: the same splits,
    thresholds and counts in every tree, predictions within 1e-5, peak
    block bytes within the budget, the blocks put plus skipped equal to
    the passes x 17, K1 on a streamed block bit for bit its plain version,
    and a repeat run (timed on both streams) the same trees.  Then a
    ``force_row_wise`` (staged) run and a u16 run (``max_bin=1023``), 200k
    rows, 63 leaves, 1 iteration, each within 1e-3 AUC of its in-memory
    run, launching the one-hot and the u16 K1.  Prints s/tree against the
    in-memory run, H2D bytes and GB/s, K1 launches a tree and the share of
    copy time hidden behind compute.  Returns the runs' launch counts and
    the block check."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as hist
    ds, X, Xv, yv = data
    y = ds.get_label()
    steps, last = {}, [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        steps[name] = now - last[0]
        last[0] = now
    base = {"objective": "binary", "num_leaves": STREAM_LEAVES,
            "max_bin": 255, "learning_rate": 0.1, "verbose": -1,
            "tree_grower": "serial"}
    ref, ref_s = _train(lgt, ds, base, ITERS_STREAM)
    step("memory_serial_run")
    sp = dict(base, max_bin_matrix_bytes=STREAM_BUDGET,
              stream_prefetch=STREAM_PREFETCH)
    dss = lgt.Dataset(X, label=y, params=sp).construct(device="cuda")
    step("construct")
    plan = dss._inner.stream_plan()
    if (plan is None or plan.num_blocks != STREAM_BLOCKS
            or plan.block_rows != 60_544):
        raise AssertionError(f"stream plan {plan}")
    hist.reset_launch_counts()
    st, st_s = _train(lgt, dss, sp, ITERS_STREAM)
    launches = dict(hist.launch_counts)
    step("stream_run")
    eng = st._gbdt
    if type(eng).__name__ != "StreamGBDT":
        raise AssertionError(f"routed to {type(eng).__name__}")
    stats = eng.stream_stats.as_dict()
    if _structure(st) != _structure(ref):
        raise AssertionError("streamed trees differ from the serial trees")
    pdiff = float(np.abs(st.predict(Xv) - ref.predict(Xv)).max())
    if pdiff > 1e-5:
        raise AssertionError(f"streamed predictions differ by {pdiff}")
    if stats["peak_block_bytes"] > STREAM_BUDGET:
        raise AssertionError(f"peak block bytes {stats}")
    if stats["puts"] + stats["blocks_skipped"] != \
            stats["passes"] * STREAM_BLOCKS:
        raise AssertionError(f"block accounting {stats}")
    if launches["hist_full"] != stats["puts"] or any(
            v for k, v in launches.items() if k != "hist_full"):
        raise AssertionError(f"stream launches {launches}, {stats}")
    trees = len(st._gbdt.models)
    step("gates")

    # K1 on a streamed block, bit for bit
    dev = torch.device("cuda", torch.cuda.current_device())
    g = (0.5 - y).astype(np.float32)
    block = _stream_block_check(hist, dev, eng._matrix, g,
                                np.full(len(y), 0.25, np.float32),
                                np.ones(len(y), np.float32),
                                eng._grower_cfg.max_bin)
    print(f"stream block {block['shape']}: hist_full bit for bit, kernel "
          f"{_f4(block['kernel_ms'])} ms, call {block['ms']:.4f} ms, plain "
          f"{block['plain_ms']:.4f} ms, index_add_ "
          f"{block['library_ms']:.4f} ms, bound {block['bound_ms']:.5f} ms",
          flush=True)

    step("block_check")
    # the repeat run, its copies and compute timed on both streams
    ref_evt = torch.cuda.Event(enable_timing=True)
    ref_evt.record()
    torch.cuda.synchronize()
    b2 = lgt.Booster(params=sp, train_set=dss, device="cuda")
    b2._gbdt.stream_stats.events = []
    for _ in range(ITERS_STREAM):
        b2.update()
    torch.cuda.synchronize()
    _same_trees(b2.model_to_string(), st.model_to_string())
    step("repeat_run")
    if PROFILE_STREAM:
        _profile_stream(b2)
    hidden, copy_ms = _hidden_share(b2._gbdt.stream_stats.events, ref_evt)
    if not copy_ms > 0:
        raise AssertionError("the repeat run timed no copies")
    step("hidden_share")
    h2d = stats["bytes_h2d"]
    run = {"rows": len(y), "iterations": ITERS_STREAM, "trees": trees,
           "plan": plan._asdict(), "stats": stats,
           "s_per_tree": st_s / trees, "serial_s_per_tree": ref_s / trees,
           "h2d_bytes_per_tree": h2d / trees,
           "h2d_run_gb_s": h2d / st_s / 1e9,
           "h2d_copy_gb_s": (b2._gbdt.stream_stats.bytes_h2d
                             / (copy_ms / 1e3) / 1e9),
           "k1_launches_per_tree": launches["hist_full"] / trees,
           "copy_hidden_share": hidden, "pred_max_abs_diff": pdiff,
           "same_trees_as_serial": True, "repeat_same_trees": True}
    print(f"stream: s/tree {run['s_per_tree']:.4f} (in-memory serial "
          f"{run['serial_s_per_tree']:.4f}), H2D {h2d / trees / 1e9:.3f} GB"
          f"/tree at {run['h2d_copy_gb_s']:.2f} GB/s a copy, K1 "
          f"launches/tree {run['k1_launches_per_tree']:.1f}, copy hidden "
          f"{hidden:.3f} ({card})", flush=True)

    # force_row_wise (the one-hot K1) and u16 (max_bin=1023), 200k rows
    Xs, ys = make_higgs_like(N_STREAM_SMALL, N_FEAT, seed=49)
    small = {}
    for name, extra, kern in (
            ("row_wise_staged", {"force_row_wise": True,
                                 "hist_variant": "staged"}, "onehot_full"),
            ("u16", {"max_bin": 1023}, "hist_full")):
        p = dict(base, num_leaves=STREAM_SMALL_LEAVES, **extra)
        d_mem = lgt.Dataset(Xs, label=ys, params=p).construct(device="cuda")
        b_mem, mem_s = _train(lgt, d_mem, p, 1)
        ps = dict(p, max_bin_matrix_bytes=STREAM_SMALL_BUDGET)
        d_st = lgt.Dataset(Xs, label=ys, params=ps).construct(device="cuda")
        hist.reset_launch_counts()
        b_st, st_small_s = _train(lgt, d_st, ps, 1)
        cnt = dict(hist.launch_counts)
        if not cnt[kern] or any(v for k, v in cnt.items() if k != kern):
            raise AssertionError(f"stream {name}: launches {cnt}")
        a_mem = _auc(b_mem.predict(Xv, raw_score=True), yv)
        a_st = _auc(b_st.predict(Xv, raw_score=True), yv)
        if abs(a_mem - a_st) > AUC_TOL:
            raise AssertionError(f"stream {name}: AUC {a_st} vs {a_mem}")
        small[name] = {"rows": N_STREAM_SMALL, "launches": cnt,
                       "blocks": d_st._inner.stream_plan().num_blocks,
                       "dtype": str(d_st._inner.bins.dtype),
                       "s_per_tree": st_small_s, "memory_s_per_tree": mem_s,
                       "auc": a_st, "memory_auc": a_mem}
        print(f"stream {name}: {small[name]}", flush=True)
    step("small_runs")
    print(f"stream steps (s): {steps}", flush=True)
    emit({"phase": "stream", "card": card, "budget_bytes": STREAM_BUDGET,
          "steps_s": steps,
          "prefetch": STREAM_PREFETCH, **run, "block": block,
          "small": small})
    return ({"atomic": launches,
             **{k: v["launches"] for k, v in small.items()}}, block)


def phase_predict(boosters, Xv):
    import lightgbm_tpu_torch as lgt
    out = []
    for booster in boosters:
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
        out.append(float(p_mem.mean()))
    emit({"phase": "predict", "rows": len(Xv), "bit_identical": True,
          "mean_p": out})


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profiled(fn, host=True):
    """torch.profiler over one call of ``fn``: its wall time with the
    profiler on, the device rows (kernels, copies, fills) and, with
    ``host``, the host rows (ops, runtime calls; tracing them costs the
    most).  An op's own row repeats its kernels' device time, so only
    device rows are summed for device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        ka = prof.key_averages()
        dev_rows = [e for e in ka if e.device_type != DeviceType.CPU]
        if _window_ok(dev_rows, (), PROFILE_TRIES - 1 - t):
            break
    return wall_s, dev_rows, [e for e in ka
                              if e.device_type == DeviceType.CPU]


def phase_profile(booster, card, iters: int = 3):
    """torch.profiler over a few more boosting iterations of the trained
    booster: device busy time by kernel, host time by op, kernel launches,
    host reads of device values, and the device's idle share of the wall
    time (with the profiler on).  The full tables go to
    ``chiprun_out/profile_train.txt``."""
    from lightgbm_tpu_torch.ops import histogram as hist
    booster._gbdt.models                       # drain the pending trees
    hist.reset_launch_counts()

    def more():
        for _ in range(iters):
            booster.update()
        booster._gbdt.models
    wall_s, dev_rows, host_rows = _profiled(more)
    rounds = hist.launch_counts["hist_leaves"]
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
# the one-hot kernels: the shell each (kernel, layout) replaces, and the
# body each variant replaces
ONEHOT_SHELLS = {
    ("onehot_full", "featmajor"): (
        "lightgbm_tpu_torch/ops/kernels/onehot_full.cu",
        "lightgbm_tpu/ops/histogram.py:483",
        "lightgbm_tpu/ops/histogram.py::_hist_pallas (kernel_fm)"),
    ("onehot_full", "rowmajor"): (
        "lightgbm_tpu_torch/ops/kernels/onehot_full.cu",
        "lightgbm_tpu/ops/histogram.py:437",
        "lightgbm_tpu/ops/histogram.py::_hist_pallas (kernel_rm)"),
    ("onehot_leaves", "rowmajor"): (
        "lightgbm_tpu_torch/ops/kernels/onehot_leaves.cu",
        "lightgbm_tpu/ops/histogram.py:273",
        "lightgbm_tpu/ops/histogram.py::_hist_leaves_pallas"),
}
ONEHOT_BODIES = {"base": 178, "bf16cmp": 187, "i16cmp": 196, "u8cmp": 205,
                 "sub1abs": 214, "staged": 227, "packed": 250, "int8": 267}
# which training run drives each (variant, width) of the u8 rows (the
# train phase's), and each (variant, case) of the u16 rows (the data-breadth
# phases' force_row_wise runs; the sparse_efb run's per-leaf histograms
# take hist_leaves, outside the cut)
MAIN_PATH_RUNS = {("staged", 256): "staged", ("packed", 64): "packed",
                  ("int8", 256): "int8", ("staged", "B1024"): "wide_staged",
                  ("int8", "B1024"): "wide_int8",
                  ("staged", "bundle"): "efb_staged",
                  ("staged", f"B{WIDE_WIDTHS[-1]}"): "widest_staged"}
# the int8 quantize kernel (the `level` chain of the int8 body) and the
# shootout shell's entry
QUANT_INFO = ("lightgbm_tpu_torch/ops/kernels/onehot_quant.cu",
              "lightgbm_tpu/ops/onehot_variants.py:284",
              "lightgbm_tpu/ops/onehot_variants.py::_contrib_int8 (level)")
BENCH_INFO = ("lightgbm_tpu_torch/ops/kernels/onehot_full.cu",
              "lightgbm_tpu/ops/onehot_variants.py:440",
              "lightgbm_tpu/ops/onehot_variants.py::make_bench_kernel")


def _only_phases(names, smi, timed):
    """``--only``: the serve and stream phases alone, on the train phase's
    data and its default model (trained once, no plain run)."""
    import lightgbm_tpu_torch as lgt
    unknown = set(names) - {"serve", "stream"}
    if unknown:
        raise SystemExit(f"--only: unknown phases {sorted(unknown)}")
    base = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
            "learning_rate": 0.1, "verbose": -1}
    X, y = make_higgs_like(N_TRAIN, N_FEAT, seed=42)
    Xv, yv = make_higgs_like(N_VALID, N_FEAT, seed=43)
    ds = lgt.Dataset(X, label=y, params=base).construct(device="cuda")
    data = (ds, X, Xv, yv)
    if "serve" in names:
        booster, _ = _train(lgt, ds, base, N_ITERS)
        timed("serve", phase_serve, smi, booster, data)
    if "stream" in names:
        timed("stream", phase_stream, smi, data)


def kernel_rows(kern, onehot, quant, bench, launches, serial_blocks,
                stream_block, card):
    """The ``{"kernels": [...]}`` rows: the atomic kernels, one row per
    one-hot (kernel, layout, variant, width), the quantize kernel, and one
    row per shootout (variant, width).  ``launches`` is the count from the
    run that drives the row's kernel: a training run (0 for the row-major
    layout and the variants no run trains with), or for the shootout shell
    its own run in the shootout phase.  The K1 rows the serial grower
    launches (``hist_full``; ``onehot_full`` featmajor ``staged`` at 256
    bins) carry its recorded blocks' checks as ``serial_blocks``."""
    keys = ("max_abs_err", "relerr", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    rows = []
    atomic_keys = ("kernel_ms", "vs_index_add", "smem_floor_ms",
                   "registers", "local_bytes", "dynamic_smem_bytes",
                   "ctas_per_sm", "design", "fg", "W", "warps_per_sm",
                   "tiles", "tile_bins", "scratch_bytes")
    for kname, (src, replaces, jax_fn) in KERNEL_INFO.items():
        r = kern[kname]
        row = {"name": kname, "route": "cuda", "source": src,
               "replaces": replaces, "jax": jax_fn,
               "launches": launches["atomic"][kname],
               "launches_by_knob_run": {run: cnt[kname] for run, cnt in
                                        launches["knobs"].items()},
               "launches_by_engine_cli_run": launches["engine_cli"][kname],
               "launches_by_obs_run": launches["obs"][kname],
               "launches_by_serial_run": {run: cnt[kname] for run, cnt in
                                          launches["serial"].items()},
               **{k: r[k] for k in keys + atomic_keys}, "card": card}
        if kname in serial_blocks:
            row["serial_blocks"] = serial_blocks[kname]
        if kname == "hist_full":
            row["launches_by_stream_run"] = \
                launches["stream"]["atomic"][kname]
            row["stream_block"] = stream_block
        if "cases" in r:
            row["cases"] = {c: {k: v[k] for k in ("relerr", "ms",
                                                  "kernel_ms", "library_ms")}
                            for c, v in r["cases"].items()}
        rows.append(row)
    # the u16 instantiations: at B = 1,024 (the wide_bins run's launches;
    # the full pass also on Zipf-skewed bins), at the sparse_efb run's
    # bundle width (its own launches), and in bin tiles at the wide widths
    # (B = 65,536: the widest_bins run's launches; no run trains at the
    # others)
    wide = [(f"B{w}{z}", "widest_bins" if w == WIDE_WIDTHS[-1] else None)
            for w in WIDE_WIDTHS for z in ("", "/zipf")]
    for case, run in (("B1024", "wide_bins"), ("B1024/zipf", "wide_bins"),
                      ("bundle", "sparse_efb"), *wide):
        for kname, (src, replaces, jax_fn) in KERNEL_INFO.items():
            if f"{kname}/u16/{case}" not in kern:
                continue
            r = kern[f"{kname}/u16/{case}"]
            stream = ({"launches_by_stream_run":
                       launches["stream"]["u16"][kname]}
                      if case == "B1024" else {})
            rows.append({"name": f"{kname}/u16/{case}", "route": "cuda",
                         "source": src, "replaces": replaces, "jax": jax_fn,
                         "dtype": "uint16", "shape": r["shape"],
                         "launches": launches[run][kname] if run else 0,
                         **stream,
                         **{k: r[k] for k in keys + atomic_keys},
                         "card": card})
    for name, r in onehot.items():
        src, replaces, jax_fn = ONEHOT_SHELLS[(r["kernel"], r["layout"])]
        run = MAIN_PATH_RUNS.get((r["variant"], r.get("case", r["B"])))
        on_path = run is not None and (r["kernel"], r["layout"]) != (
            "onehot_full", "rowmajor")
        n = launches[run][r["kernel"]] if on_path else 0
        serial = ({"launches_by_serial_run": launches["serial"][
            "row_wise_staged"]["onehot_full"],
                   "serial_blocks": serial_blocks["onehot_full"],
                   "launches_by_stream_run": launches["stream"][
                       "row_wise_staged"]["onehot_full"]}
                  if (r["kernel"], r["layout"], r["variant"], r["B"]) == (
                      "onehot_full", "featmajor", "staged", 256) else {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "jax": jax_fn,
                     "body": "lightgbm_tpu_torch/ops/kernels/"
                             "onehot_common.cuh",
                     "body_replaces": "lightgbm_tpu/ops/onehot_variants.py:"
                                      f"{ONEHOT_BODIES[r['variant']]}",
                     "launches": n, **serial, **{k: r[k] for k in keys},
                     "design": r["design"],
                     **({"dtype": "uint16", "shape": r["shape"]}
                        if r.get("dtype") == "uint16" else {}),
                     "card": card})
    src, replaces, jax_fn = QUANT_INFO
    rows.append({"name": "onehot_quant", "route": "cuda", "source": src,
                 "replaces": replaces, "jax": jax_fn,
                 "launches": launches["int8"]["onehot_quant"],
                 **{k: quant[k] for k in keys + ("kernel_ms", "registers",
                                                 "local_bytes")},
                 "card": card})
    src, replaces, jax_fn = BENCH_INFO
    for name, r in bench.items():
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "jax": jax_fn,
                     "body": "lightgbm_tpu_torch/ops/kernels/"
                             "onehot_common.cuh",
                     "body_replaces": "lightgbm_tpu/ops/onehot_variants.py:"
                                      f"{ONEHOT_BODIES[r['variant']]}",
                     "launches": r["launches"], "design": r["design"],
                     **{k: r[k] for k in keys}, "card": card})
    return rows


class _Tee:
    """Standard output, and a copy in ``chiprun_out/chip_smoke.out`` (the
    whole run: the end of standard output may be all a caller keeps)."""

    def __init__(self, stream, path):
        self.stream = stream
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.copy = open(path, "w")

    def write(self, text):
        self.copy.write(text)
        return self.stream.write(text)

    def flush(self):
        self.copy.flush()
        self.stream.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few more iterations (torch.profiler)")
    ap.add_argument("--only", default="",
                    help="comma-separated phases among serve,stream: build "
                         "the kernels, train the train phase's default "
                         "model once and run only these (no kernels line)")
    args = ap.parse_args()
    global PROFILE_STREAM
    PROFILE_STREAM = args.profile
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.stdout = _Tee(sys.stdout, os.path.join("chiprun_out",
                                               "chip_smoke.out"))
    t_start = time.perf_counter()
    seconds = {}

    def timed(label, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[label] = time.perf_counter() - t0
        return out
    name, smi, clock = timed("device", phase_device)
    timed("build", phase_build)
    if args.only:
        _only_phases(args.only.split(","), smi, timed)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "phase_seconds": seconds})
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    breadth = timed("breadth_data", breadth_data)
    kern = timed("kernels", phase_kernels, clock, breadth)
    onehot = timed("kernels_onehot", phase_kernels_onehot, smi, breadth)
    quant = timed("quant", phase_quant, smi)
    bench = timed("shootout", phase_shootout, smi)
    elected = timed("elect", phase_elect, smi)
    boosters, data, launches = timed("train", phase_train, smi, elected)
    launches["obs"] = timed("obs", phase_obs, smi, data)
    launches["serial"], serial_blocks = timed("serial", phase_serial, smi,
                                              data)
    launches["knobs"] = timed("knobs", phase_knobs, smi, data)
    Xv = data[2]
    timed("predict", phase_predict, boosters, Xv)
    timed("serve", phase_serve, smi, boosters[0], data)
    launches["stream"], stream_block = timed("stream", phase_stream, smi,
                                             data)
    if args.profile:
        timed("profile", phase_profile, boosters[0], smi)
    del data, boosters
    launches["rank"] = timed("rank", phase_rank, smi)
    launches["categorical"] = timed("categorical", phase_categorical, smi)
    launches.update(timed("wide_bins", phase_wide_bins, smi, elected))
    launches.update(timed("sparse_efb", phase_sparse_efb, smi, breadth))
    launches.update(timed("widest_bins", phase_widest_bins, smi))
    launches.update(timed("engine", phase_engine, smi))
    rows = kernel_rows(kern, onehot, quant, bench, launches, serial_blocks,
                       stream_block, smi)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
