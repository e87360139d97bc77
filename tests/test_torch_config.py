"""The port's YAML config (CPU) against the JAX package's ``load_config``:
the same ``TRAIN`` / ``TEST`` trees (``dataclasses.asdict``, exact), the
same flag-over-YAML properties, and a YAML of another geometry or
vocabulary served (``tests/test_torch_geometry.py`` holds the geometry
against JAX)."""

import dataclasses
import os

import pytest

from tatt_tpu.core.config import Flags as JFlags
from tatt_tpu.core.config import load_config as jload_config
from tatt_tpu_torch.core.config import Flags, load_config

REPO_YAML = os.path.join(os.path.dirname(__file__), "..", "config", "super_resolution.yaml")
UNKNOWN_KEYS = """\
# a reference-style YAML with keys neither package knows
TRAIN:
  train_data_dir: ['/data/a', "/data/b"]   # flow list, both quote styles
  batch_size: 48
  workers: 3
  lr: 0.0002
  saveInterval: 7
  voc_type: lower
  no_such_key: 5
  VAL:
    val_data_dir: [/data/easy]
    valInterval: 9
    crnn_pretrained: ''
    also_unknown: {a: 1}
TEST:
  checkpoint: ckpt/x.ckpt
  test_data_dir: []
MODEL_TYPO: {x: 1}
"""


def _yaml(tmp_path, text: str) -> str:
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("which", ["repo", "unknown_keys"])
def test_load_config_matches_the_jax_package(tmp_path, which):
    path = REPO_YAML if which == "repo" else _yaml(tmp_path, UNKNOWN_KEYS)
    ours, theirs = load_config(path), jload_config(path)
    assert dataclasses.asdict(ours.TRAIN) == dataclasses.asdict(theirs.TRAIN)
    assert dataclasses.asdict(ours.TEST) == dataclasses.asdict(theirs.TEST)
    assert dataclasses.asdict(load_config().TRAIN) == dataclasses.asdict(jload_config().TRAIN)


@pytest.mark.parametrize("flags_set", [False, True])
def test_flag_precedence_matches(tmp_path, flags_set):
    """Every port flag has the JAX name and default; flags win over the
    YAML through the same properties."""
    jfields = {f.name: f.default for f in dataclasses.fields(JFlags)}
    for f in dataclasses.fields(Flags):
        assert jfields[f.name] == f.default, f.name
    kw = dict(batch_size=16, lr=2e-4, resume="ckpt/run", vis_dir="vis_x", epochs=3) if flags_set else {}
    path = _yaml(tmp_path, UNKNOWN_KEYS)
    ours, theirs = load_config(path, Flags(**kw)), jload_config(path, flags=JFlags(**kw))
    for prop in ("batch_size", "lr", "resume", "vis_dir", "epochs", "scale_factor"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    assert ours.batch_size == (16 if flags_set else 48)


@pytest.mark.parametrize(
    "line", ["  width: 256", "  height: 64", "  down_sample_scale: 4", "  voc_type: chinese"]
)
def test_unserved_yaml_is_refused(tmp_path, line, capsys):
    """Each YAML once refused is served: it loads as the JAX package loads
    it (since the Chinese path for ``voc_type: chinese``, since the
    geometry for ``width``, ``height`` and ``down_sample_scale``), and
    ``--go_test`` evaluates at its geometry."""
    from tatt_tpu_torch.cli import main as cli

    path = _yaml(tmp_path, f"TRAIN:\n{line}\n  VAL:\n    crnn_pretrained: ''\n")
    ours, theirs = load_config(path), jload_config(path)
    assert dataclasses.asdict(ours.TRAIN) == dataclasses.asdict(theirs.TRAIN)
    if "chinese" in line:
        assert ours.TRAIN.voc_type == "chinese"
        return
    assert cli.main(["--go_test", "--mask", "--synthetic", "8", "--config", path, "--srb", "1",
                     "--hd_u", "4", "--tiny_tpg", "--batch_size", "4", "--device", "cpu"]) == 0
    assert "'images': 8" in capsys.readouterr().out
