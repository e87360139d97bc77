"""The port's spans (``train/observe.py``) on the CPU, shrunk width: while
no profiler runs a span is one shared null context and records nothing;
under ``torch.profiler`` the TATT and TSRN steps, the evaluation and the
loader open the spans of ``observe.SPANS``, nested where the work runs,
with the calls and seconds that ``span_totals`` returns; the step's loss
and parameters come out bit for bit as without the profiler; and the
benchmark's readers of the totals (``stisr_bench/metrics/*_ms.*.py``)
give the value by hand, or None."""

import ast
import os
import threading

import pytest
import torch

from test_torch_cli import RECIPE, SHRUNK
from stisr_bench import bench
from stisr_bench import spans as bench_spans
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.data.loader import DataLoader
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.train import observe

TSRN = ["--arch=tsrn", "--STN", "--mask", "--gradient", "--rotate_train=5.0", "--tssim_loss"]
TINY = SHRUNK + ["--batch_size", "4", "--synthetic", "8", "--max_iters", "0", "--log_dir", ""]
PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tatt_tpu_torch")

# (child, parent) pairs of the spans a step or a batch opens
TATT_NESTING = [("tatt.step.batch", "tatt.step"), ("tatt.step.forward", "tatt.step"),
                ("tatt.step.backward", "tatt.step"), ("tatt.step.optimizer", "tatt.step"),
                ("tatt.teacher", "tatt.step.forward"), ("tatt.student", "tatt.step.forward"),
                ("tatt.generator", "tatt.step.forward"),
                ("tatt.tp_interpreter", "tatt.generator"),
                ("tatt.query_gru", "tatt.tp_interpreter")]
TSRN_NESTING = TATT_NESTING[:4] + [("tatt.generator", "tatt.step.forward")]
EVAL_NESTING = [("tatt.eval.sr", "tatt.eval.batch"), ("tatt.eval.score", "tatt.eval.batch"),
                ("tatt.judge", "tatt.eval.batch"), ("tatt.judge.decode", "tatt.judge"),
                ("tatt.student", "tatt.eval.sr"), ("tatt.generator", "tatt.eval.sr"),
                ("tatt.query_gru", "tatt.tp_interpreter")]


def trainer_of(flags):
    code, trainer = cli.run(flags + TINY)
    assert code == 0 and trainer.iters == 0
    return trainer


@pytest.fixture(scope="module")
def trainers():
    torch.manual_seed(0)
    return {"tatt": trainer_of(RECIPE), "tsrn": trainer_of(TSRN)}


def profiled(fn):
    """(fn's result, {name: [(start, end, thread)]} of the ``tatt.*`` host
    ranges the profiler recorded, the span totals ``fn`` added)."""
    before = observe.span_totals()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    after = observe.span_totals()
    added = {}
    for name, t in after.items():
        b = before.get(name, {"calls": 0, "seconds": 0.0, "self_seconds": 0.0})
        if t["calls"] > b["calls"]:
            added[name] = {k: t[k] - b[k] for k in t}
    ranges = {}  # the raw events: prof.events() takes seconds at a step's op count
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("tatt."):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns(), e.start_thread_id()))
    return out, ranges, added


def assert_nested(ranges: dict, pairs) -> None:
    for child, parent in pairs:
        assert ranges.get(child) and ranges.get(parent), (child, parent)
        for s, e, thread in ranges[child]:
            assert any(ps <= s and e <= pe and pt == thread for ps, pe, pt in ranges[parent]), (
                child, parent)


def test_off_is_one_shared_null_context_and_records_nothing(trainers):
    trainer = trainers["tatt"]
    assert not observe.tracing()
    assert observe.span("tatt.step") is observe.span("tatt.judge")
    before = observe.span_totals()
    trainer.train(max_iters=trainer.iters + 1)
    assert observe.span_totals() == before


@pytest.mark.parametrize("arch,nesting,steps_in_call", [("tatt", TATT_NESTING, 1),
                                                        ("tsrn", TSRN_NESTING, 1)])
def test_a_profiled_step_opens_its_spans_nested(trainers, arch, nesting, steps_in_call):
    trainer = trainers[arch]
    _, ranges, added = profiled(lambda: trainer.train(max_iters=trainer.iters + steps_in_call))
    assert_nested(ranges, nesting)
    assert set(ranges) <= set(observe.SPANS) and "tatt.loader.first" in ranges
    # the loader's pool threads add to the totals; the profiler, whose
    # callbacks are the starting thread's, does not record them
    assert set(added) - {"tatt.loader.read", "tatt.loader.collate"} == set(ranges)
    assert added["tatt.step"]["calls"] == len(ranges["tatt.step"]) == steps_in_call
    for name, t in added.items():
        assert name not in ranges or t["calls"] == len(ranges[name]), name
        assert 0.0 <= t["self_seconds"] <= t["seconds"] + 1e-9, name
    generator = 1 if arch == "tatt" else 2  # the plain step's counter-rotated second forward
    assert added["tatt.generator"]["calls"] == generator
    if arch == "tatt":
        assert added["tatt.query_gru"]["calls"] == added["tatt.teacher"]["calls"] == 1
    parts = sum(added[f"tatt.step.{p}"]["seconds"] for p in ("batch", "forward", "backward",
                                                               "optimizer"))
    assert parts <= added["tatt.step"]["seconds"]
    assert added["tatt.step"]["self_seconds"] == pytest.approx(
        added["tatt.step"]["seconds"] - parts, abs=1e-6)


def test_the_profiler_changes_no_result():
    """Two trainers of the same flags and seed, one step each, one under
    the profiler: the loss and every parameter bit for bit."""
    results = []
    for traced in (True, False):
        torch.manual_seed(0)
        trainer = trainer_of(RECIPE)
        if traced:
            out = profiled(lambda: trainer.train(max_iters=1))[0]
        else:
            out = trainer.train(max_iters=1)
        params = [p.detach().clone() for m in trainer.generators + trainer.students
                  for p in m.parameters()]
        results.append((out["metrics"]["loss_total"], params))
    (loss_a, params_a), (loss_b, params_b) = results
    assert loss_a == loss_b
    assert len(params_a) == len(params_b)
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


def test_loader_spans_one_first_wait_and_reads_on_the_workers():
    ds = SyntheticTextDataset(n=12, seed=1)
    main, readers = threading.get_ident(), set()
    get = ds.__getitem__

    class Watched:
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            readers.add(threading.get_ident())
            return get(i)

    loader = DataLoader(Watched(), 4, shuffle=False, num_workers=2)
    batches, ranges, added = profiled(lambda: list(loader))
    assert len(batches) == 3 and main not in readers
    assert {k: v["calls"] for k, v in added.items()} == {
        "tatt.loader.first": 1, "tatt.loader.wait": 2, "tatt.loader.read": 3,
        "tatt.loader.collate": 3}
    # the reads and collates ran on the pool's threads: no consumer span holds them
    for name in ("tatt.loader.first", "tatt.loader.wait"):
        assert added[name]["self_seconds"] == added[name]["seconds"]
    assert len(ranges["tatt.loader.wait"]) == 2 and "tatt.loader.read" not in ranges


def test_an_evaluation_of_two_batches(trainers):
    evaluator = trainers["tatt"].evaluator
    summary, ranges, added = profiled(lambda: evaluator.evaluate(SyntheticTextDataset(n=8,
                                                                                      seed=2)))
    assert summary["images"] == 8
    calls = {k: v["calls"] for k, v in added.items()}
    assert calls["tatt.eval.batch"] == calls["tatt.eval.sr"] == calls["tatt.eval.score"] == 2
    assert calls["tatt.judge"] == calls["tatt.judge.decode"] == 6
    assert calls["tatt.query_gru"] == calls["tatt.generator"] == 2
    assert calls["tatt.loader.first"] == calls["tatt.loader.wait"] == 1
    assert_nested(ranges, EVAL_NESTING)


def _span_names(node) -> set:
    return {n.value for n in ast.walk(node) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and n.value.startswith("tatt.")}


def test_the_program_opens_the_listed_spans_and_no_other():
    used = set()
    for folder, _, files in os.walk(PACKAGE):
        for f in files:
            if not f.endswith(".py") or f == "observe.py":
                continue
            tree = ast.parse(open(os.path.join(folder, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                    used |= _span_names(node.args[0])
                elif isinstance(node, ast.Assign) and _span_names(node.value):
                    used |= _span_names(node.value)  # a name bound and later spanned
    assert used == set(observe.SPANS)
    assert len(observe.SPANS) == len(set(observe.SPANS))


TOTALS = {name: {"calls": calls, "seconds": seconds} for name, calls, seconds in [
    ("tatt.step", 8, 4.0), ("tatt.step.forward", 8, 2.0), ("tatt.step.backward", 8, 1.2),
    ("tatt.step.optimizer", 8, 0.4), ("tatt.query_gru", 8, 0.16), ("tatt.eval.batch", 20, 5.0),
    ("tatt.judge", 60, 0.5), ("tatt.loader.first", 2, 0.3)]}


@pytest.mark.parametrize("metric,mode,value,totals", [
    ("forward_ms.train", "train", 250.0, TOTALS),
    ("backward_ms.train", "train", 150.0, TOTALS),
    ("optimizer_ms.train", "train", 50.0, TOTALS),
    ("query_gru_ms.train", "train", 20.0, TOTALS),
    ("loader_first_wait_ms.train", "train", 150.0, TOTALS),
    # eval: the query GRU a batch, the judge's readings a batch, a set's first wait
    ("query_gru_ms.eval", "eval", 8.0,
     {**TOTALS, "tatt.query_gru": {"calls": 20, "seconds": 0.16}}),
    ("judge_ms.eval", "eval", 25.0, TOTALS),
    ("loader_first_wait_ms.eval", "eval", 150.0, TOTALS),
])
def test_the_span_readers(metric, mode, value, totals, monkeypatch):
    reader = bench.load_module(os.path.join(bench.HERE, "metrics", f"{metric}.py"))
    ctx = {"mode": mode, "trace": {"window_s": 1.0}}
    monkeypatch.setattr(bench_spans, "totals", lambda: totals)
    assert reader.read(ctx) == pytest.approx(value)
    assert reader.read({**ctx, "mode": "eval" if mode == "train" else "train"}) is None
    assert reader.read({"mode": mode, "trace": None}) is None
    monkeypatch.setattr(bench_spans, "totals", lambda: {})
    assert reader.read(ctx) is None
