"""salsa_tpu_torch.utils.config against salsa_tpu.utils.config and PyYAML: the
port's reader for the YAML subset equals `yaml.safe_load` on every config in
`configs/` and on `yaml.safe_dump` of each, types plain scalars as PyYAML's YAML 1.1
resolver does, refuses what lies outside the subset, and `apply_overrides`
equals salsa_tpu's."""
import copy
import glob
import math
import os

import pytest
import yaml

from salsa_tpu.utils import config as jconfig
from salsa_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yml")))


def _same(a, b):
    """Equal values of equal types, recursively (1 == 1.0 == True would pass ==)."""
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_every_repo_config_is_read():
    assert len(CONFIGS) >= 6


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_safe_load_on_repo_configs(path):
    with open(path) as f:
        text = f.read()
    want = yaml.safe_load(text)
    assert _same(tconfig.parse_yaml(text), want)
    assert _same(tconfig.load_config(path).to_dict(), jconfig.load_config(path).to_dict())
    dumped = yaml.safe_dump(want, sort_keys=False)
    assert "- " in dumped or "[" not in text  # block lists appear where flow lists were
    assert _same(tconfig.parse_yaml(dumped), want)
    dumped = yaml.safe_dump(want)  # keys sorted
    assert _same(tconfig.parse_yaml(dumped), yaml.safe_load(dumped))


SCALARS = [
    "3.0e-4", "3e-4", "1.0e+3", "1e3", "-.5", ".5", "+1.5", "1.", "1_000.5", "6.8523015e+5",
    "0", "-0", "+12", "012", "0o12", "09", "0x1F", "0b101", "1_000", "190:20:30", "1:30.5",
    ".inf", "-.Inf", ".NaN", "null", "Null", "~", "", "true", "False", "yes", "NO", "on",
    "Off", "y", "n", "foo bar", "foo#bar", "a-b", "-foo", "http://x/y", "'quoted'",
    "'it''s'", '"tab\\there"', '"\\u00e9\\x41"', "'# not a comment'", "[1, 2.0, '3', x]",
    "[]", "[[1, 2], [3]]", "[a , b,]", "2021", "'2021'", "value # comment",
]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_typed_as_pyyaml(text):
    doc = f"key: {text}\nnested:\n  - {text}\n  -  {text}\n"
    assert _same(tconfig.parse_yaml(doc), yaml.safe_load(doc)), text


def test_block_structures_as_pyyaml():
    doc = """
# header comment
a:
  b:
    c: 1   # trailing
    d: [1, 2]
  e:
  - x
  - y: 1
    z: [2]
  -
    - 3
    - 4
  f:
      - deep
'quoted key': "v"
1: int key
g: - not - a list
""".replace("g: - not - a list\n", "")
    assert _same(tconfig.parse_yaml(doc), yaml.safe_load(doc))
    assert tconfig.parse_yaml("") is None and tconfig.parse_yaml("# only\n") is None
    assert tconfig.parse_yaml("- 1\n- [a]\n") == yaml.safe_load("- 1\n- [a]\n")


@pytest.mark.parametrize("doc", [
    "a: &anchor 1\nb: *anchor\n",
    "a: !!str 1\n",
    "a: |\n  text\n",
    "a: >\n  text\n",
    "a: {b: 1}\n",
    "a: b: c\n",
    "a: 'unterminated\n",
    "a: [1, 2\n",
    "a: plain\n  continued\n",
    "a: 1\n   b: 2\n",
    "a:\n  b: 1\n c: 2\n",
    "---\na: 1\n",
    "a: 2021-10-16\n",
    "<<: 1\n",
    "? complex\n",
    "a:\n\t- 1\n",
    "a: 'x' trailing\n",
    'a: "bad \\q escape"\n',
], ids=lambda d: d.split("\n")[0][:24])
def test_out_of_subset_yaml_raises_naming_the_line(doc):
    with pytest.raises(ValueError, match="line [0-9]"):
        tconfig.parse_yaml(doc)


@pytest.mark.parametrize("override", [
    "a.b=3e-4", "x=null", "l=[1, 2]", "t=true", "new.nested.key=5", "s=hello", "f=2.5",
    "q='3e-4'", "m=a: 1",
])
def test_apply_overrides_equals_salsa_tpu(override):
    base = {"a": {"b": 1, "c": "keep"}, "x": 3, "l": [0], "t": False}
    want = jconfig.apply_overrides(jconfig.AttrDict(copy.deepcopy(base)), [override])
    got = tconfig.apply_overrides(tconfig.AttrDict(copy.deepcopy(base)), [override])
    assert _same(got.to_dict(), want.to_dict()), (got, want)


def test_apply_overrides_refuses_a_bare_key():
    with pytest.raises(ValueError, match="key=value"):
        tconfig.apply_overrides(tconfig.AttrDict(), ["novalue"])


def test_attrdict_wraps_nested_mappings():
    cfg = tconfig.AttrDict({"a": {"b": [{"c": 1}, 2]}})
    assert cfg.a.b[0].c == 1 and isinstance(cfg.a, tconfig.AttrDict)
    cfg.z = {"y": 2}
    assert cfg.z.y == 2 and copy.deepcopy(cfg).to_dict() == {"a": {"b": [{"c": 1}, 2]},
                                                             "z": {"y": 2}}
    with pytest.raises(AttributeError):
        cfg.missing
