"""The in-repo YAML loader reads every parameter file of the repo to the
same values as PyYAML's safe_load, and the package imports without
PyYAML."""
import glob
import os
import subprocess
import sys

import pytest

from vsmartmom.config.yaml_subset import loads, resolve_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(
    glob.glob(os.path.join(ROOT, "tests", "data", "ref_yaml", "*.yaml"))
    + [os.path.join(ROOT, "tests", "data", "rayleigh_benchmark.yaml"),
       os.path.join(ROOT, "vsmartmom", "config", "default_parameters.yaml")])


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_loader_matches_safe_load(path):
    yaml = pytest.importorskip("yaml")
    from vsmartmom.config.yaml_subset import load
    with open(path, encoding="utf-8") as f:
        assert load(path) == yaml.safe_load(f)


@pytest.mark.parametrize("text, value", [
    ("60", 60), ("60.", 60.0), ("-1", -1), ("0.00000001", 1e-8),
    ("400e-6", "400e-6"), ("1.5e-3", 0.0015), ("1e-3", "1e-3"),
    ("1.5e+3", 1500.0), ("Float64", "Float64"), ("true", True),
    ("~", None), (".inf", float("inf")),
    ("(1e7/777):0.015:(1e7/757)", "(1e7/777):0.015:(1e7/757)"),
])
def test_plain_scalars_resolve_as_yaml_1_1(text, value):
    assert resolve_plain(text) == value


def test_nested_structures():
    doc = loads("""
a:            # comment
  - [x, 'y #1', [1, 2.0]]
  - k: v
    m:
      - 3
b: [1,
    2]    # flow sequence across lines
c:
- "q"
""")
    assert doc == {"a": [["x", "y #1", [1, 2.0]], {"k": "v", "m": [3]}],
                   "b": [1, 2], "c": ["q"]}


def test_import_without_pyyaml():
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import vsmartmom\n"
            "p = vsmartmom.default_parameters()\n"
            "assert len(p.spec_bands[0]) == 22669, len(p.spec_bands[0])\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
