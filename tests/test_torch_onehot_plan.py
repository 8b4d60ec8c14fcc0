"""PyTorch port: the one-hot kernels' plan (``histogram.onehot_plan``),
on the CPU.

The plan picks the one-hot kernels' design from the bin width alone: the
dense design of every u8 width, the bucketed one (rows sorted by their
128-lane bucket, ``kernels/onehot_bucket.cuh``) of every u16 width, and
``onehot_design`` may ask for the dense one at u16 but for no design a
width does not serve.  The plan is computed from the kernels' constants,
so it is checked here without a card; the card tests hold it against the
kernels' own attribute query.
"""
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import onehot_variants as ov

pytestmark = pytest.mark.torch_port

SMEM_LIMIT = 232_448          # shared bytes one CTA may opt into on an H100
SM_SMEM = 233_472             # shared bytes of an H100 SM, 1,024 of them
                              # reserved for each resident CTA


@pytest.mark.parametrize("variant", ov.VARIANT_NAMES)
def test_plan_keeps_the_dense_design_at_every_u8_width(variant):
    spec = ov.VARIANTS[variant]
    for B in range(1, 257):
        if spec.supports(B):
            assert thist.onehot_plan(variant, 28, B)["design"] == "dense"


@pytest.mark.parametrize("variant", ("base", "i16cmp", "staged", "int8"))
def test_plan_buckets_every_u16_width_within_shared_memory(variant):
    """B from 257 to 4,096 and f from 1 to 4,228 (the sparse_efb phase's
    raw feature count): the bucketed design, CTAs of up to 8 buckets of one
    feature, covering its buckets, within the card's grid and shared
    memory."""
    for B in range(257, 4097):
        nb = ov.padded_bins(B) // 128
        for f in (1, 2, 28, 35, 4228):
            p = thist.onehot_plan(variant, f, B)
            assert p["design"] == "bucketed" and p["threads"] == 256
            assert p["dynamic_smem_bytes"] <= SMEM_LIMIT
            assert p["buckets"] == nb and 1 <= p["bpg"] <= 8
            assert p["gpf"] * p["bpg"] >= nb > (p["gpf"] - 1) * p["bpg"]
            assert f * p["gpf"] <= 65535


def test_plan_buckets_int8_over_every_quantization_block():
    """int8's segments of 512 rows span the quantization blocks of fewer
    (up to four of 128 rows; a block of 512 or more cuts them, one block a
    segment): the bucketed design at every block size, the full pass's
    row-major blocks at B = 1,024 and its feature-major ones at the bundle
    width (128 rows) included; the dense design only where
    ``onehot_design`` asks for it.  Blocks under 512 rows take the kernel
    whose segments span them, with shared bytes of its own; both leave
    room for two CTAs an SM."""
    want = {128: 4, 256: 3, 384: 2, 512: 1, 640: 1, 1024: 1}
    one = thist.onehot_plan("int8", 28, 1024)["dynamic_smem_bytes"]
    for br, blocks in want.items():
        for B in (1024, 1536, 2599, 4096, 65_536):
            p = thist.onehot_plan("int8", 28, B, br)
            assert p["design"] == "bucketed"
            assert p["segment_blocks"] == blocks
            assert (p["dynamic_smem_bytes"] > one) == (br < 512)
            assert 2 * (p["dynamic_smem_bytes"] + 1024) <= SM_SMEM
        with thist.onehot_design("dense"):
            assert thist.onehot_plan("int8", 28, 1024, br)["design"] == (
                "dense")
    for layout, B in (("rowmajor", 1024), ("featmajor", 2599)):
        qbr = ov.pallas_block_rows("int8", layout, 1 << 20, 28, B)
        assert qbr == 128
        assert thist.onehot_plan("int8", 28, B, qbr)["design"] == (
            "bucketed")
    assert not hasattr(thist, "_OH_BUCKET_INT8_MIN_BLOCK")


def test_plan_obeys_an_override_it_serves_and_refuses_the_rest():
    with thist.onehot_design("dense"):
        assert thist.onehot_plan("staged", 28, 1024)["design"] == "dense"
        assert thist.onehot_plan("staged", 28, 255)["design"] == "dense"
    with thist.onehot_design("bucketed"):
        assert thist.onehot_plan("int8", 35, 2599)["design"] == "bucketed"
        for B in (2, 64, 256):
            with pytest.raises(ValueError, match="does not serve"):
                thist.onehot_plan("base", 28, B)
    with pytest.raises(ValueError, match="unknown one-hot design"):
        with thist.onehot_design("sorted"):
            pass
    # the override ends with its block
    assert thist.onehot_plan("staged", 28, 1024)["design"] == "bucketed"


def test_finish_hist_takes_the_bucketed_kernels_three_rows():
    """The bucketed kernels add hi and lo themselves and write three rows:
    ``finish_hist`` gives what it gives for six rows whose lo rows are
    zero."""
    f, B = 3, 300
    spec = ov.VARIANTS["staged"]
    Bp = ov.padded_bins(B)
    out3 = torch.randn(2, 3, f * Bp, dtype=torch.float64)
    out6 = torch.cat([out3, torch.zeros_like(out3)], dim=1)
    got = ov.finish_hist(out3, f, B, Bp, spec)
    assert got.shape == (2, f, B, 3)
    assert torch.equal(got, ov.finish_hist(out6, f, B, Bp, spec))
