"""PyTorch port, ``Config`` parity with the JAX package: for every parameter
of ``docs/Parameters.md`` (generated from the JAX package's ``Config``) the
two classes agree on the default, the aliases, and what ``Config.update``
makes of a value given by the name and by each alias.  The only allowed
difference is where ``VARIANT_NAMES`` (the ``hist_variant`` names) comes
from: each package's own ``ops/onehot_variants.py``, whose lists agree.
"""
import os
import re

import pytest

from lightgbm_tpu import config as jcfg
from lightgbm_tpu.ops import onehot_variants as jov
from lightgbm_tpu_torch import config as tcfg
from lightgbm_tpu_torch.ops import onehot_variants as tov

pytestmark = pytest.mark.torch_port

DOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs", "Parameters.md")
_ROW = re.compile(r"^\| `([^`]+)` \| ([^|]+) \| (.*) \| (.*) \|$")


def _documented():
    rows = []
    with open(DOC) as fh:
        for line in fh:
            m = _ROW.match(line.strip())
            if m:
                name, typ, _, aliases = m.groups()
                rows.append((name, typ.strip(),
                             sorted(re.findall(r"`([^`]+)`", aliases))))
    return rows


DOCUMENTED = _documented()


def _value(name, typ, default):
    """A value unlike the default, as a user would write it in a config
    file (a string), for the parameter's type."""
    if name == "interaction_constraints":
        return "[0,1],[2,3,4]"
    if typ == "bool":
        return "false" if default else "true"
    if typ == "int":
        return str(default + 3)
    if typ == "float":
        return repr(default + 0.25)
    if typ.startswith("List[int]") or typ.startswith("Union"):
        return "1,2,5"
    if typ == "List[float]":
        return "0.5,1.5,2"
    if typ == "List[str]":
        return "a,b"
    if typ.startswith("Dict"):
        return {"k": "v"}
    return f"{default}_x"


def test_parameters_are_documented():
    assert len(DOCUMENTED) > 100
    assert tov.VARIANT_NAMES == jov.VARIANT_NAMES


@pytest.mark.parametrize("name,typ,aliases", DOCUMENTED,
                         ids=[r[0] for r in DOCUMENTED])
def test_config_matches_jax(name, typ, aliases):
    jal = sorted(a for a, c in jcfg.PARAM_ALIASES.items() if c == name)
    tal = sorted(a for a, c in tcfg.PARAM_ALIASES.items() if c == name)
    assert tal == jal == aliases
    if name == "config":            # the command line's pseudo-parameter
        assert not hasattr(tcfg.Config(), name)
        return
    j0, t0 = jcfg.Config(), tcfg.Config()
    assert getattr(t0, name) == getattr(j0, name)
    value = _value(name, typ, getattr(j0, name))
    for key in [name] + aliases:
        j, t = jcfg.Config(), tcfg.Config()
        j.update({key: value})
        t.update({key: value})
        assert getattr(t, name) == getattr(j, name), key
        assert getattr(t, name) != getattr(t0, name) or name == "_unknown"
