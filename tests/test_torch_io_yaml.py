"""The PyTorch port's own file formats against the libraries dcpt_tpu reads them
with: its YAML loader against PyYAML on the shipped test options and on scalars."""

import os

import pytest
import yaml

import _torch_threads  # noqa: F401
from _torch_io_util import OPTIONS
from dcpt_tpu_torch.utils.yaml_lite import loads

TEST_OPTIONS = [p for p in OPTIONS if os.path.basename(os.path.dirname(p)) == "test"]


@pytest.mark.parametrize("path", TEST_OPTIONS, ids=[os.path.basename(p) for p in TEST_OPTIONS])
def test_yaml_loader_equals_pyyaml_on_shipped_options(path):
    with open(path) as f:
        text = f.read()
    assert loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, -2, 2.5, 1.0e-4, 1e-4, .5, ~, null, yes, Off, 010, 0x1F, 0b11, .inf, -.inf, 1_000]",
    "a: {b: {c: [d, 'e f', \"g\\th\"]}, f: {}, g: []}  # comment",
    "a: 'it''s #not a comment'\nb:\n  c: x#y\n  d:\n",
    "list: [[1, 2], {k: v}]\nnested:\n  deeper:\n    deepest: 3\n",
])
def test_yaml_loader_resolves_scalars_like_pyyaml(text):
    assert loads(text) == yaml.safe_load(text)
