"""The port's YAML reader, config merge and tuning grid against the
libraries ocl_tpu uses: `yaml.load(..., Loader=yaml.FullLoader)` on every
recipe under config/ and config_CVPR/, `ocl_tpu.config.merge_yaml_params`
on the recipes chip_smoke.py runs, and sklearn's ParameterGrid on every
tuning grid."""

import glob
import io
import math
import os

import pytest
import yaml

from ocl_tpu.config import merge_yaml_params as j_merge_yaml_params
from ocl_tpu_torch.config import load_yaml, merge_yaml_params
from ocl_tpu_torch.experiment.tune import parameter_grid
from ocl_tpu_torch.utils.io import parse_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = sorted(glob.glob(os.path.join(REPO, "config", "**", "*.yml"), recursive=True) +
                    glob.glob(os.path.join(REPO, "config_CVPR", "**", "*.yml"), recursive=True))
YAML_DIRS = sorted({os.path.relpath(os.path.dirname(f), REPO) for f in YAML_FILES})


def full_loader(path):
    with open(path) as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def test_the_recipes_are_all_there():
    assert len(YAML_FILES) == 192 and len(YAML_DIRS) == 30


@pytest.mark.parametrize("directory", YAML_DIRS)
def test_load_yaml_matches_full_loader(directory):
    files = [f for f in YAML_FILES if os.path.relpath(os.path.dirname(f), REPO) == directory]
    for path in files:
        with open(path) as f:
            got = parse_yaml(f, path)
        want = full_loader(path)
        # repr tells 1 from 1.0 and True from 1, which == does not
        assert got == want and repr(got) == repr(want), path
        key = "path" if "path" in want else "parameters"
        assert load_yaml(path, key) == want[key]


SCALARS = """\
float: 1.0e-05
not_float: 1e-5
exp_no_dot: 1.0e5
signed_exp: 3.0e+2
int: -800
underscored: 1_000
zero: 0
plus: +3
half: .5
neg_half: -.5
dot_end: 1.
inf: .inf
neg_inf: -.Inf
yes: yes
off: Off
tilde: ~
null_word: null
empty:
word: random
url: http://example.org/x
comment: value # trailing comment
# a whole-line comment
nested:
  inner:
  - 0.1
  - ASER
  flag: true
list_at_key_indent:
- 1
- two
1: int key
"""


def test_scalars_and_structure_match_full_loader():
    got = parse_yaml(io.StringIO(SCALARS))
    want = yaml.load(io.StringIO(SCALARS), Loader=yaml.FullLoader)
    assert repr(got) == repr(want)
    assert got["not_float"] == "1e-5" and got["float"] == 1e-5 and math.isinf(got["inf"])
    nan = parse_yaml(io.StringIO("x: .NaN\n"))["x"]
    assert math.isnan(nan) and math.isnan(yaml.load("x: .NaN\n", Loader=yaml.FullLoader)["x"])


@pytest.mark.parametrize("text,line", [
    ("a: 'quoted'\n", 1), ('a: "quoted"\n', 1), ("a: [1, 2]\n", 1), ("a: {b: 1}\n", 1),
    ("a: &anchor 1\n", 1), ("a: *anchor\n", 1), ("a: !!str 1\n", 1), ("a: |\n  text\n", 1),
    ("a: 010\n", 1), ("a: 0x1f\n", 1), ("a: 1:30\n", 1), ("a: 2020-01-01\n", 1),
    ("a:\n  - - 1\n", 2), ("a:\n  - b: 1\n", 2), ("a: 1\n  b: 2\n", 2), ("a: b: c\n", 1),
    ("a 1\n", 1), ("---\na: 1\n", 1), ("a:\n\tb: 1\n", 2), ("  a: 1\n", 1),
    ("a:\n  b: 1\n c: 2\n", 3),
], ids=lambda v: repr(v) if isinstance(v, str) else str(v))
def test_outside_the_subset_raises_naming_the_line(text, line):
    with pytest.raises(ValueError, match=r"<yaml>:{}:".format(line)):
        parse_yaml(io.StringIO(text))


RECIPES = [
    ("config/general_1.yml", "config/data/synthetic/synthetic_nc.yml",
     "config_CVPR/agent/aser/aser_1k_cifar100.yml"),
    ("config/general_1.yml", "config/data/synthetic/synthetic_nc.yml",
     "config/agent/er/er_1k.yml"),
    ("config/general_offline_1.yml", "config/data/synthetic/synthetic_nc.yml",
     "config/agent/er/offline.yml"),
    ("config/general_1.yml", "config/data/synthetic/synthetic_noise.yml",
     "config/agent/er/er_1k.yml"),
    ("config/general_1.yml", "config/data/synthetic/synthetic_occlusion.yml",
     "config/agent/er/er_1k.yml"),
    ("config/general_labels_trick_1.yml", "config/data/synthetic/synthetic_blur.yml",
     "config/agent/icarl/icarl_1k.yml"),
]


@pytest.mark.parametrize("files", RECIPES, ids=lambda f: "+".join(
    os.path.splitext(os.path.basename(p))[0] for p in f))
def test_merge_yaml_params_matches_ocl_tpu(files):
    sections = [load_yaml(os.path.join(REPO, f)) for f in files]
    got = vars(merge_yaml_params(*sections, nf=4))
    want = vars(j_merge_yaml_params(*[full_loader(os.path.join(REPO, f))["parameters"]
                                      for f in files], nf=4))
    assert set(got) - set(want) == {"device"} and got["device"] == "cuda"
    # scan_unroll's default comes from an environment variable in ocl_tpu
    for key in set(want) - {"scan_unroll", "cuda"}:
        assert got[key] == want[key], key


def test_parameter_grid_matches_sklearn():
    from sklearn.model_selection import ParameterGrid

    tune_files = [f for f in YAML_FILES
                  if "_tune" in os.path.basename(f) and "finetune" not in f]
    assert len(tune_files) == 19
    for path in tune_files:
        grid = load_yaml(path)
        assert parameter_grid(grid) == list(ParameterGrid(grid)), path
    mixed = {"b": [1, 2], "a": 0.5, "c": ["x", "y", "z"]}
    assert parameter_grid(mixed) == list(ParameterGrid(
        {k: v if isinstance(v, list) else [v] for k, v in mixed.items()}))
