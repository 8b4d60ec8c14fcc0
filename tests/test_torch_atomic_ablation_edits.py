"""PyTorch port: the atomic kernels' ablation and SASS scripts still fit the
kernel sources.

``scripts/torch_atomic_ablation.py`` times copies of ``hist_full`` and
``hist_leaves`` with a part of the work taken out, made by text edits of
the sources that must each match exactly once.  A change to the kernels
that one edit no longer matches would only show on the card, so each
copy's edits are applied here, on the CPU, to a copy of the current
sources.  ``scripts/torch_atomic_sass.py`` reads ``cuobjdump -sass``
output, which needs the toolkit; its parser is checked on a listing
written out here.
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


ABL = _script("torch_atomic_ablation")
SASS = _script("torch_atomic_sass")


@pytest.mark.parametrize("name", ABL.ABLATIONS)
def test_atomic_ablation_edits_match_the_sources_once(tmp_path, name):
    edits = ABL.ablation_edits(name)
    assert bool(edits) == (name != "repo")
    out = tmp_path / name
    ABL._patched_sources(name, edits, KERNEL_DIR, str(out))
    edited = {fn for fn, _, _ in edits}
    for fn, old, new in edits:
        with open(os.path.join(KERNEL_DIR, fn)) as fh:
            assert fh.read().count(old) == 1
        assert (out / fn).read_text().count(old) == (1 if old in new else 0)
    # the other sources are copied as they are
    for fn in os.listdir(KERNEL_DIR):
        if fn not in edited:
            with open(os.path.join(KERNEL_DIR, fn), "rb") as fh:
                assert (out / fn).read_bytes() == fh.read()


def test_atomic_ablation_reads_registers_from_ptxas():
    log = ("ptxas info    : Compiling entry function '_Z18hist_reduce_kernel'"
           " for 'sm_90a'\n"
           "ptxas info    : Used 20 registers, used 0 barriers\n"
           "ptxas info    : Compiling entry function '_Z16hist_full_kernelPKh'"
           " for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           "loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers\n")
    assert ABL._ptxas(log, "hist_full_kernel") == (64, 8)
    assert ABL._ptxas(log, "hist_reduce_kernel") == (20, None)


def test_atomic_sass_counts_atomics_and_the_update_loop():
    sass = """
        Function : _Z16hist_full_kernelPKh
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 ATOMS.CAST.SPIN.64 P0, [R2], R4, R6 ;
        /*0020*/                   DADD R4, R4, R6 ;
        /*10030*/                  ATOMS.CAST.SPIN.64 P0, [R2], R4, R6 ;
        /*10040*/                  REDG.E.ADD.F64.RN.STRONG.GPU [R2.64], R4 ;
        Function : _Z16hist_leaves_kernelPKh
        /*0000*/                   ATOMS.OR R5, [R2], R4 ;
        /*0010*/                   LDS R4, [R2] ;
        /*0020*/                   DADD R4, R4, R6 ;
    """
    mix = SASS.kernel_mix(sass)
    full = mix["_Z16hist_full_kernelPKh"]
    assert (full["atoms"], full["atoms_cas"], full["global_atomics"]) == \
        (2, 2, 1)
    assert full["loop_ops"] == {"ATOMS": 2, "DADD": 1}
    assert full["loop_instructions"] == 3
    leaves = mix["_Z16hist_leaves_kernelPKh"]
    assert (leaves["atoms"], leaves["atoms_cas"]) == (1, 0)
    assert leaves["atomics_by_kind"] == {"ATOMS.OR": 1}
    assert leaves["instructions"] == 3
    assert leaves["loop_ops"] == {"ATOMS": 1, "LDS": 1, "DADD": 1}
