"""The PyTorch port's own file formats against the libraries dcpt_tpu reads them
with: its YAML loader against PyYAML on the shipped train options, and its refusals."""

import os

import pytest
import yaml

import _torch_threads  # noqa: F401
from _torch_io_util import OPTIONS
from dcpt_tpu_torch.utils.yaml_lite import YamlError, loads

TRAIN_OPTIONS = [p for p in OPTIONS if os.path.basename(os.path.dirname(p)) == "train"]


@pytest.mark.parametrize("path", TRAIN_OPTIONS, ids=[os.path.basename(p) for p in TRAIN_OPTIONS])
def test_yaml_loader_equals_pyyaml_on_shipped_options(path):
    with open(path) as f:
        text = f.read()
    assert loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n  - 2\n", "a: &x 1\n", "a: |\n  text\n", "---\na: 1\n"])
def test_yaml_loader_raises_outside_its_subset(text):
    with pytest.raises(YamlError):
        loads(text)
