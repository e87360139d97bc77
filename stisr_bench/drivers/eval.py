"""The ``eval`` mix: ``Evaluator.evaluate``, the ``--go_test`` protocol.

Set-up renders the cell's test sets (the configuration's ``test_sets``:
name and size) as TextZoom-layout LMDBs under ``TMPDIR``, makes the
weights on the card, builds the port's evaluator as its CLI does, and
runs one pass over every set, which warms every batch shape (the full
batch and each set's tail).  The window is whole passes, as many as end
inside ``--seconds`` (:func:`~stisr_bench.harness.whole_units`); the
mix's rate metric is the images of its passes over their wall time (each
pass ends on the host's reads, which wait for the card).  The first pass of the window is recorded for the
check: every set's summary, and in ``sample_batches`` batches a set,
drawn from the seed, the SR images, the judge's logits and its strings.
With ``--trace 1`` the window gives the whole step's FLOP rate, and one
profiled pass the device's idle share and the kernels' rooflines.
After the window the program is freed and the reference evaluates the
same sets from the same weights.  :func:`calibrate_seed` takes the
readings that the cell's limits are set from.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np
import torch

from stisr_bench import bench, checks, flops, guard, harness, program, trace, traffic
from stisr_bench.reference import full_precision, nets, ops, steps, tf32


class Recorder:
    """Proxies around the evaluator's batches, SR function and judge, and
    a hook on the judge's recognizer.  The batches' ``next()`` is timed
    (``wait_s``, ``waits``: :func:`~stisr_bench.harness.timed`), the
    judge's reading spanned as ``stisr_bench.judge``; in the sampled batches
    of a recorded pass it keeps the SR images, and the logits and strings
    of each reading (SR, LR, HR)."""

    def __init__(self, evaluator, judge_model, sampled: dict):
        self.sampled, self.on, self.set, self.batch = sampled, False, None, -1
        self.sr, self.logits, self.strings = {}, {}, {}
        self.wait_s, self.waits = 0.0, 0
        batches, sr_fn, decode = evaluator.batches, evaluator.sr_fn, evaluator.decode

        def batches_proxy(dataset):
            for waited, item in harness.timed(batches(dataset)):
                self.wait_s += waited
                self.waits += 1
                yield item

        def sr_proxy(gens, stus, lr):
            sr, aux = sr_fn(gens, stus, lr)
            self.batch += 1
            if self._keep():
                self.sr[(self.set, self.batch)] = sr.detach().clone()
            return sr, aux

        def decode_proxy(images):
            with torch.profiler.record_function("stisr_bench.judge"):
                strings = decode(images)
            if self._keep():
                self.strings.setdefault((self.set, self.batch), []).append(strings)
            return strings

        def logits_hook(module, args, out):
            if self._keep():
                self.logits.setdefault((self.set, self.batch), []).append(out.detach().clone())

        evaluator.batches, evaluator.sr_fn, evaluator.decode = batches_proxy, sr_proxy, decode_proxy
        self.handle = judge_model.register_forward_hook(logits_hook)

    def _keep(self) -> bool:
        return self.on and self.batch in self.sampled.get(self.set, ())

    def start_set(self, name: str) -> None:
        self.set, self.batch = name, -1


def build(cell, seed: int, setup, tmp: str) -> dict:
    """Data, weights, the port's evaluator and the recorder: the run's
    state, with ``one_pass(record)`` over every set."""
    config, workload, mix = cell.config, cell.workload, cell.mix
    batch = workload["batch"]
    hr_size, lr_size = harness.shape(config)
    with setup.part("render"):
        crops = traffic.render(seed, sum(config["test_sets"].values()), hr_size, lr_size,
                               mix["store"], traffic.cpu_workers())
    sets, at = {}, 0
    for name, size in config["test_sets"].items():
        sets[name] = crops[at:at + size]
        at += size
    rng = np.random.default_rng(seed)
    sampled = {name: set(rng.choice(math.ceil(len(c) / batch), mix["sample_batches"],
                                    replace=False).tolist()) for name, c in sets.items()}
    roots = {name: os.path.join(tmp, name) for name in sets}
    with setup.part("lmdb"):
        for name, c in sets.items():
            program.write_lmdb(roots[name], traffic.lmdb_records(c))
    device, leaves = harness.prepare(setup, seed, config)
    with setup.part("import"):
        program.import_all()
    with setup.part("program"):
        yaml = program.yaml_text(config, seed, [], list(roots.values()), batch,
                                 os.path.join(tmp, "ckpt"))
        cfg, _ = program.parse(config, harness.write_yaml(tmp, yaml), batch, ["--go_test"])
        models = program.build_models(cfg, leaves, device)
        evaluator = program.evaluator(cfg, models, device)
        data = {name: program.lmdb_dataset(root, config["voc_type"]) for name, root in roots.items()}
        recorder = Recorder(evaluator, models[2], sampled)

    def one_pass(record: bool = False) -> tuple[int, dict]:
        recorder.on, images, summaries = record, 0, {}
        for name, ds in data.items():
            recorder.start_set(name)
            summaries[name] = evaluator.evaluate(ds)
            images += summaries[name]["images"]
        recorder.on = False
        return images, summaries

    return {"config": config, "batch": batch, "sets": sets, "sampled": sampled, "device": device,
            "leaves": leaves, "models": models, "recorder": recorder, "one_pass": one_pass}


def recorded(state: dict, summaries: dict) -> dict:
    """What the recorder kept of its pass, with that pass's summaries;
    the recorder's hook removed."""
    rec = state["recorder"]
    rec.handle.remove()
    return {"sr": rec.sr, "logits": rec.logits, "strings": rec.strings, "summaries": summaries}


def run(cell, seed: int, seconds: float, traced: bool, t0: float) -> None:
    setup = bench.Setup(t0)
    with harness.scratch() as tmp:
        state = build(cell, seed, setup, tmp)
        one_pass, models, batch = state["one_pass"], state["models"], state["batch"]
        with setup.part("warmup"):
            one_pass()
        setup_s = setup.seconds()
        harness.sync()
        peak = harness.peak_bytes()
        counted, first = [], []
        recorder = state["recorder"]
        recorder.wait_s, recorder.waits = 0.0, 0

        def a_pass(k):
            n, summaries = one_pass(record=k == 0)
            counted.append(n)
            if k == 0:
                first.append(summaries)

        t = time.perf_counter()
        each = harness.whole_units(a_pass, seconds)
        harness.sync()
        window_s = time.perf_counter() - t
        images, passes = sum(counted), len(each)
        window = {"seconds": window_s, "images": images, "steps": passes,
                  "loader_wait_s": recorder.wait_s, "loader_waits": recorder.waits,
                  "peak_bytes": harness.peak_bytes()}
        print(f"[window] {passes} passes, {images} images in {window_s:.3f} s (passes "
              + " ".join(f"{x:.3f}" for x in each) + " s)", file=sys.stderr, flush=True)
        breakdown, traced_window = None, None
        if traced:
            ctx = harness.context("eval", cell.config, window)
            ctx["trace"] = traced_window = trace.profile(
                one_pass, [*models[0], *models[1], models[2]], bench.rooflines(cell),
                harness.sync)
            ctx["flops"] = flops.eval_batch(cell.config, batch) / batch
            metrics = bench.read_per_layer(cell, ctx)
            breakdown = {"device_ops": traced_window["device_ops"],
                         "idle_gaps": traced_window["idle_gaps"]}
        else:
            values = {cell.mix["rate_metric"]: images / window_s, "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end}
        peak = max(peak, harness.peak_bytes())
        got = recorded(state, first[0])
        del one_pass, a_pass, models, recorder
        release(state)
        t = time.perf_counter()
        numbers = compare(state, got)
        print(f"[check] the reference in {time.perf_counter() - t:.3f} s", file=sys.stderr,
              flush=True)
    ok, compared = checks.verdict(numbers, cell.workload.get("limits", {}))
    guard.require_no_jax()
    bench.emit(ok, images, 0, metrics, bench.device_info(cell.chips, peak, traced_window), compared,
               breakdown)


def calibrate_seed(cell, seed: int, control: bool) -> dict:
    """The check's numbers on one seed, without a window (one warm pass,
    one recorded): the program's (its lower readings), and with
    ``control`` the TF32 control's and the half batch's (the reference in
    the program's place)."""
    out = {}
    with harness.scratch() as tmp:
        state = build(cell, seed, bench.Setup(time.perf_counter()), tmp)
        state["one_pass"]()
        _, summaries = state["one_pass"](record=True)
        got = recorded(state, summaries)
        release(state)
        with full_precision():
            ref = reference_pass(state)
        out["program"] = numbers(got, ref)
        if control:
            with tf32():
                ctl = reference_pass(state)
            out["control"] = numbers(as_recorded(ctl), ref)
            with full_precision():
                cut = reference_pass(state, fault=harness.half)
            out["half_batch"] = numbers(as_recorded(cut), ref)
    return out


def release(state: dict) -> None:
    """Free the program's objects before the reference runs."""
    for key in ("models", "recorder", "one_pass"):
        state.pop(key, None)
    harness.free_program()


def reference_pass(state: dict, fault=None) -> dict:
    """The reference's evaluation of every set: each set's per-batch
    average PSNR and SSIM, and in the sampled batches the SR images and
    the judge's logits on SR, LR and HR; ``fault(batch)`` may plant a
    fault in its batches."""
    config, batch, device = state["config"], state["batch"], state["device"]
    hr_size, lr_size = harness.shape(config)
    models = nets.build(config)
    for name, module in models.items():
        module.to(device).eval()
        with torch.no_grad():
            for k, p in module.named_parameters():
                p.copy_(state["leaves"][name][k])
    out = {"psnr": {}, "ssim": {}, "sr": {}, "logits": {}, "summaries": {}}
    for name, crops in state["sets"].items():
        psnrs, ssims = [], []
        for b in range(math.ceil(len(crops) / batch)):
            rows = range(b * batch, min((b + 1) * batch, len(crops)))
            data = {k: torch.from_numpy(v).to(device)
                    for k, v in traffic.batch_arrays(crops, rows, hr_size, lr_size).items()}
            if fault is not None:
                data = fault(data)
            got = steps.evaluate_batch(config["arch"], models, data)
            psnrs.append(got["psnr"])
            ssims.append(got["ssim"])
            if b in state["sampled"][name]:
                out["sr"][(name, b)], out["logits"][(name, b)] = got["sr"], got["logits"]
        out["psnr"][name], out["ssim"][name] = sum(psnrs) / len(psnrs), sum(ssims) / len(ssims)
        out["summaries"][name] = {"psnr_avg": out["psnr"][name], "ssim_avg": out["ssim"][name]}
    return out


def as_recorded(ref: dict) -> dict:
    """A reference pass in the form of a recorded program pass (its
    strings the greedy decode of its own logits): the control's."""
    strings = {k: [ops.ctc_greedy(x.argmax(-1).T.cpu().numpy()) for x in v]
               for k, v in ref["logits"].items()}
    return {"sr": ref["sr"], "logits": ref["logits"], "strings": strings,
            "summaries": ref["summaries"]}


def compare(state: dict, got: dict) -> dict:
    with full_precision():
        ref = reference_pass(state)
    return numbers(got, ref)


def _gap(got: torch.Tensor | None, want: torch.Tensor) -> float:
    """Largest absolute gap; rows the program left out count as zeros."""
    if got is None:
        return math.inf
    if got.shape != want.shape:
        pad = torch.zeros_like(want)
        n = min(len(got), len(want))
        pad[:n] = got[:n]
        got = pad
    return float((got - want).abs().max())


def numbers(got: dict, ref: dict) -> dict:
    """The eval checks of ``checks`` from the program's recorded pass and
    the reference's."""
    summaries = got["summaries"]
    sr_gap = max((_gap(got["sr"].get(k), ref["sr"][k]) for k in ref["sr"]), default=math.nan)
    logit, off = [], 0
    for k, want in ref["logits"].items():
        readings, strings = got["logits"].get(k, []), got["strings"].get(k, [])
        off += abs(len(readings) - len(want)) + abs(len(strings) - len(want))
        for p, r in zip(readings, want):
            logit.append(float((p - r).abs().max()) if p.shape == r.shape else math.inf)
        for logits, said in zip(readings, strings):
            decoded = ops.ctc_greedy(logits.argmax(-1).T.cpu().numpy())
            off += sum(a != b for a, b in zip(said, decoded)) + abs(len(said) - len(decoded))
    return {
        "sr_gap": sr_gap,
        "psnr_gap": max(abs(summaries[n]["psnr_avg"] - ref["psnr"][n]) for n in ref["psnr"]),
        "ssim_gap": max(abs(summaries[n]["ssim_avg"] - ref["ssim"][n]) for n in ref["ssim"]),
        "logit_gap": max(logit) if len(logit) == 3 * len(ref["logits"]) else math.inf,
        "strings_off": float(off),
    }
