"""BENCHMARK.json against the contract it is written to, and the files
it names; a new cell, configuration or kernel roofline is files and
entries alone."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from stisr_bench import bench, readers, trace
from stisr_bench.bounds import recurrence
from stisr_bench.reference import archs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
TREE = bench.HERE  # the tree's benchmark, before a test points the harness at a copy


@pytest.fixture(scope="module")
def manifest():
    return bench.manifest()


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for name in names + [m["name"] for m in metrics]:
        assert NAME.match(name), name
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in manifest[kind]}) == len(manifest[kind])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in manifest["workloads"]:
        assert LINE.match(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in manifest["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_paths_and_command(manifest):
    assert manifest["paths"] == ["stisr_bench"]
    assert len(manifest["command"]) <= 32
    for word in manifest["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)


def test_budget_of_a_full_check(manifest):
    """24 cells at this run length fit the check's 43,200 seconds."""
    s = manifest["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in manifest["end_to_end"])


def test_metric_cells_exist_and_report_what_they_move(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = [m for m in manifest["end_to_end"] if cell in m.get("workloads", cells)]
        assert any(m["name"] == "setup_s" for m in reported) and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in manifest["per_layer"])


def test_every_per_layer_metric_lists_its_cells(manifest):
    """The harness reports a per-layer metric in the cells its
    ``workloads`` name, and nowhere else."""
    for m in manifest["per_layer"]:
        assert m.get("workloads"), m["name"]


def test_each_name_has_its_files(manifest):
    for c in manifest["configs"]:
        config = json.load(open(os.path.join(bench.ROOT, c["file"])))
        assert config["name"] == c["name"] and set(c["reduced"]) <= set(config)
        assert c["file"].startswith("stisr_bench/")
    for w in manifest["workloads"]:
        cell = bench.Cell(w["name"], manifest)
        assert cell.config["name"] == w["config"]
        assert os.path.exists(os.path.join(bench.HERE, "drivers", cell.mix["driver"] + ".py"))
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(bench.HERE, "metrics", m["name"] + ".py")), m["name"]


def test_shares_are_percent(manifest):
    for m in manifest["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_is_files_alone(tmp_path):
    """A workload file and a manifest entry, no code: the copy finds it."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.HERE, root / "stisr_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = bench.manifest()
    manifest["workloads"].append({"name": "tatt-train-b128", "config": "tatt", "traffic": "train",
                                  "chips": 1, "why": "a smaller batch"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "tatt-train-b256" in m.get("workloads", ()):
            m["workloads"].append("tatt-train-b128")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (root / "stisr_bench" / "workloads" / "tatt-train-b128.json").write_text(
        json.dumps({"name": "tatt-train-b128", "config": "tatt", "traffic": "train", "batch": 128,
                    "limits": {}}))
    code = ("from stisr_bench import bench; c = bench.Cell('tatt-train-b128'); "
            "print(c.workload['batch'], c.config['name'], c.mix['driver'], "
            "sorted(m['name'] for m in c.per_layer))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         check=True).stdout
    assert out.startswith("128 tatt train") and "bilstm_roofline.train" in out


def _hashes(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): hashlib.sha256(
                open(os.path.join(d, f), "rb").read()).hexdigest()
            for d, _, files in os.walk(root) if "__pycache__" not in d for f in files}


def _copy(tmp_path, monkeypatch):
    """The benchmark copied into a fresh checkout, which the harness then
    reads in place of the tree: (checkout root, its stisr_bench, the
    copy's manifest)."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.HERE, root / "stisr_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(bench.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    monkeypatch.setattr(bench, "ROOT", str(root))
    monkeypatch.setattr(bench, "HERE", str(root / "stisr_bench"))
    monkeypatch.setattr(readers, "HERE", str(root / "stisr_bench"))
    monkeypatch.setattr(archs, "HERE", str(root / "stisr_bench" / "reference" / "archs"))
    return root, root / "stisr_bench", bench.manifest()


def _unchanged(copy_dir, added) -> None:
    """Every file of the copy but ``added`` is the tree's, byte for byte."""
    copied = {k: v for k, v in _hashes(copy_dir).items() if k not in added}
    tree = {k: v for k, v in _hashes(TREE).items()
            if not k.startswith("tests" + os.sep)}
    assert copied == tree


# SRResNet as the port's zoo runs it (``models/zoo/resnets.py``): five
# residual blocks of 64 channels, one x2 up-sampler; the plain step's MSE
# x100 on the four planes of ``--mask``
SRRES = '''"""SRResNet (arXiv:1609.04802) as TextZoom's zoo trains it."""

import math

import torch

from .. import ops
from ..nets import CRNN, BatchNorm, Conv2d, PReLU


class _Block(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1, self.prelu = Conv2d(64, 64), BatchNorm(64), PReLU()
        self.conv2, self.bn2 = Conv2d(64, 64), BatchNorm(64)

    def forward(self, x):
        return x + self.bn2(self.conv2(self.prelu(self.bn1(self.conv1(x)))))


class _Up(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv, self.prelu = Conv2d(64, 256), PReLU()

    def forward(self, x):
        return self.prelu(ops.pixel_shuffle(self.conv(x), 2))


class SRResNet(torch.nn.Module):
    def __init__(self, scale: int, planes: int):
        super().__init__()
        self.block1_conv, self.block1_act = Conv2d(planes, 64, (9, 9), (4, 4)), PReLU()
        for i in range(5):
            setattr(self, f"block{i + 2}", _Block())
        self.block7_conv, self.block7_bn = Conv2d(64, 64), BatchNorm(64)
        self.n_up = int(math.log2(scale))
        for i in range(self.n_up):
            setattr(self, f"up{i}", _Up())
        self.final = Conv2d(64, planes, (9, 9), (4, 4))

    def forward(self, x):
        b1 = self.block1_act(self.block1_conv(x))
        h = b1
        for i in range(5):
            h = getattr(self, f"block{i + 2}")(h)
        h = b1 + self.block7_bn(self.block7_conv(h))
        for i in range(self.n_up):
            h = getattr(self, f"up{i}")(h)
        return torch.tanh(self.final(h))


def build(config):
    crnn = config["recognizer"]
    planes = 4 if "--mask" in config["flags"] else 3
    return {"generator": SRResNet(config["geometry"]["down_sample_scale"], planes),
            "student": CRNN(**crnn), "teacher": CRNN(**crnn)}


def loss(models, batch, gen):
    hr = ops.normalize_u8(batch["images_hr"], True)
    lr = ops.normalize_u8(batch["images_lr"], True)
    return ((models["generator"](lr) - hr) ** 2).mean(dim=(1, 2, 3)).mean() * 100.0


def sr(models, lr):
    return models["generator"](lr)
'''

LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-3, "update_gap": 0.2, "rows_off": 0.0,
          "sr_gap": 1e-4, "psnr_gap": 1e-3, "ssim_gap": 1e-4, "logit_gap": 1e-4,
          "strings_off": 0.0}


def test_a_new_configuration_is_files_alone(tmp_path, monkeypatch, cpu_harness, tiny_cell,
                                            capsys):
    """A zoo arch that the port trains on the plain step, with another
    criterion than TSRN's (SRResNet, MSE): its configuration, its
    reference file, two workload files and the manifest's entries.  A
    tiny train and a tiny eval through the mixes come out correct, and
    no file that was there changes."""
    root, here, manifest = _copy(tmp_path, monkeypatch)
    config = json.load(open(here / "configs" / "tsrn.json"))
    config.update(name="srres", arch="srres", source="https://arxiv.org/abs/1609.04802",
                  about="SRResNet on the plain step with --mask",
                  flags=["--arch=srres", "--mask", "--test_model=CRNN"])
    added = {os.path.join("configs", "srres.json"): json.dumps(config),
             os.path.join("reference", "archs", "srres.py"): SRRES}
    manifest["configs"].append({"name": "srres", "source": config["source"],
                                "file": "stisr_bench/configs/srres.json", "reduced": [],
                                "why": "SRResNet on the plain step"})
    for traffic in ("train", "eval"):
        name = f"srres-{traffic}-b256"
        added[os.path.join("workloads", f"{name}.json")] = json.dumps(
            {"name": name, "config": "srres", "traffic": traffic, "batch": 256, "limits": {}})
        manifest["workloads"].append({"name": name, "config": "srres", "traffic": traffic,
                                      "chips": 1, "why": "a plain arch"})
        for m in manifest["end_to_end"]:
            if m["name"] == f"{traffic}_images_per_s":
                m["workloads"].append(name)
        for m in manifest["per_layer"]:
            if m["name"] == f"device_idle.{traffic}":
                m["workloads"].append(name)
    for path, text in added.items():
        (here / path).write_text(text)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    try:
        for traffic in ("train", "eval"):
            cell = tiny_cell(f"srres-{traffic}-b256", LIMITS)
            cell.driver().run(cell, 2**31 + 77, 0.5, False, 0.0)
            line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert line["correct"] is True, (traffic, line["checks"])
        assert archs.load("srres").__file__ == str(here / "reference" / "archs" / "srres.py")
    finally:
        sys.modules.pop(f"{archs.__name__}.srres", None)
    _unchanged(here, added)


# the TP Interpreter's query GRU (hidden 512, one row): the chains of
# ``csrc/query_gru.cu``, bound as a recurrence
QUERY_GRU_BOUND = '''"""The query GRU's chains: a BiGRU call wider than 128 over one row."""

from stisr_bench.bounds import recurrence


def shapes(module, args):
    one_row = module.hidden > 128 and args[0].shape[0] == 1
    return recurrence.launches(module, args) if one_row else []


def bound(shape, backward, peak):
    return recurrence.bound("gru", *shape, backward, peak)
'''


def test_a_new_kernel_roofline_is_files_alone(tmp_path, monkeypatch):
    """A spec, its bound file, a metric file and the manifest's entry: the
    trace's hooks record the kernel's launches on the program's layer,
    and the metric reads them against a fixture trace; no file that was
    there changes."""
    from tatt_tpu_torch.kernels.rnn import BiGRU

    root, here, manifest = _copy(tmp_path, monkeypatch)
    counters = ["tatt_tpu_torch.kernels.query_gru.query_gru_recurrence.launches",
                "tatt_tpu_torch.kernels.query_gru.query_gru_recurrence_bwd.launches"]
    added = {
        os.path.join("metrics", "query_gru_roofline.json"): json.dumps(
            {"module": "tatt_tpu_torch.kernels.rnn.BiGRU", "counters": counters,
             "kernels": ["query_gru_fwd_chain", "query_gru_bwd_chain"], "bound": "query_gru"}),
        os.path.join("bounds", "query_gru.py"): QUERY_GRU_BOUND,
        os.path.join("metrics", "query_gru_roofline.train.py"): (
            "from stisr_bench.readers import roofline\n\n\ndef read(ctx):\n"
            "    return roofline(ctx, 'train', 'query_gru_roofline.json')\n"),
    }
    for path, text in added.items():
        (here / path).write_text(text)
    manifest["per_layer"].append({"name": "query_gru_roofline.train", "unit": "%",
                                  "better": "higher", "source": "device_trace",
                                  "layer": "kernels", "moves": "train_images_per_s",
                                  "workloads": ["tatt-train-b256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = bench.Cell("tatt-train-b256")
    specs = bench.rooflines(cell)
    assert set(specs) == {"bigru_roofline", "bilstm_roofline", "query_gru_roofline"}

    query, trunk = BiGRU(1024, 512), BiGRU(64, 32)
    with trace._ShapeHooks([query, trunk], specs) as hooks:
        query(torch.zeros(1, 64, 1024)).sum().backward()
        with torch.no_grad():
            trunk(torch.zeros(8, 16, 64))
    assert hooks.calls["query_gru_roofline"] == [((64, 1, 512), True)]
    assert hooks.calls["bigru_roofline"] == [((16, 8, 32), False)]
    peak = {"flops_per_s": {"float32": 67e12}, "hbm_bytes_per_s": 3.35e12}
    fixture = {"busy_s": 1.0, "window_s": 2.0, "launches": hooks.calls,
               "counted": dict.fromkeys(counters, 1),
               "device_s": {"query_gru_fwd_chain": 2e-4, "query_gru_bwd_chain": 3e-4,
                            "bigru_fwd_kernel": 5.0}}
    got = bench.read_per_layer(cell, {"mode": "train", "trace": fixture, "peak": peak})
    least = sum(recurrence.bound("gru", 64, 1, 512, b, peak)[0] for b in (False, True))
    assert got["query_gru_roofline.train"]["value"] == pytest.approx(100 * least / 5e-4)
    assert "bigru_roofline.train" not in got  # its counters read no launch
    fixture["counted"] = {counters[0]: 1, counters[1]: 0}
    got = bench.read_per_layer(cell, {"mode": "train", "trace": fixture, "peak": peak})
    assert "query_gru_roofline.train" not in got  # launches that disagree read nothing
    _unchanged(here, added)


def test_no_module_outside_the_arch_files_names_an_arch():
    """Only ``reference/archs/<arch>.py`` knows an arch: no other module of
    the benchmark holds an arch's name as a string (docstrings aside), so
    none compares one or keys a table by one."""
    names = {json.load(open(os.path.join(bench.HERE, "configs", f)))["arch"]
             for f in os.listdir(os.path.join(bench.HERE, "configs"))}
    names |= {f[:-3] for f in os.listdir(archs.HERE) if f.endswith(".py") and f != "__init__.py"}
    assert {"tatt", "tsrn"} <= names
    for folder, _, files in os.walk(bench.HERE):
        rel = os.path.relpath(folder, bench.HERE)
        if rel.split(os.sep)[0] == "tests" or rel == os.path.join("reference", "archs"):
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(folder, f)).read())
            docs = {id(n.body[0].value) for n in ast.walk(tree)
                    if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
                    and n.body and isinstance(n.body[0], ast.Expr)}
            found = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                     and n.value in names and id(n) not in docs]
            assert not found, (os.path.join(rel, f), found)


def test_an_unknown_arch_fails_with_the_path_it_looked_for():
    with pytest.raises(ValueError, match=re.escape(os.path.join(archs.HERE, "nope.py"))):
        archs.load("nope")
