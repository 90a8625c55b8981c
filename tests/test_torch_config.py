"""The port's constants and config are exact copies of the JAX package's,
and importing the port pulls in no JAX."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from cice4_tpu import config as jcfg
from cice4_tpu import constants as jcn
from cice4_tpu_torch import config as tcfg
from cice4_tpu_torch import constants as tcn

torch.set_num_threads(1)

_PRESETS = ("gx3_config", "gx1_config", "access_om_config", "col_config")


def _public_values(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and isinstance(v, (int, float, str))}


def test_constants_equal():
    j, t = _public_values(jcn), _public_values(tcn)
    assert j.keys() == t.keys()
    for k in j:
        assert j[k] == t[k], k
    for enum_name in ("FieldLoc", "FieldType"):
        je, te = getattr(jcn, enum_name), getattr(tcn, enum_name)
        assert {m.name: m.value for m in je} == {m.name: m.value for m in te}


@pytest.mark.parametrize("dtype,expected", [
    (torch.float32, 1.0e-8), (torch.float64, jcn.puny), ("float32", 1.0e-8),
    ("float64", jcn.puny)])
def test_a_negligible(dtype, expected):
    assert tcn.a_negligible(dtype) == expected
    if isinstance(dtype, str):
        assert jcn.a_negligible(dtype) == expected


def _as_tree(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("preset", _PRESETS)
def test_presets_equal(preset):
    # the file-based presets differ only in where they look for files
    kw = {"data_dir": "grids/x"} if preset in ("gx3_config", "gx1_config") \
        else {}
    assert _as_tree(getattr(jcfg, preset)(**kw)) == \
        _as_tree(getattr(tcfg, preset)(**kw))


def test_config_sections_and_fields_equal():
    for name in jcfg._SECTION_TYPES:
        jf = [(f.name, f.default if f.default is not dataclasses.MISSING
               else f.default_factory())
              for f in dataclasses.fields(jcfg._SECTION_TYPES[name])]
        tf = [(f.name, f.default if f.default is not dataclasses.MISSING
               else f.default_factory())
              for f in dataclasses.fields(tcfg._SECTION_TYPES[name])]
        assert jf == tf, name


def test_with_values_and_from_dict():
    over = {"dynamics.kdyn": 0, "transport.advection": "none",
            "grid.kmt_file": "", "domain.nx_global": 32}
    assert _as_tree(jcfg.gx1_config().with_values(**over)) == \
        _as_tree(tcfg.gx1_config().with_values(**over))
    tree = {"domain": {"ncat": 4}, "thermo": {"conduct": "bubbly"}}
    assert _as_tree(jcfg.config_from_dict(tree)) == \
        _as_tree(tcfg.config_from_dict(tree))


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        import cice4_tpu_torch.model, cice4_tpu_torch.convert
        import cice4_tpu_torch.io.forcing_data, cice4_tpu_torch.guards
        import cice4_tpu_torch.cuda_build
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "cice4_tpu."))
               or m == "cice4_tpu"]
        assert not bad, bad
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr
