"""The ``train`` mix: ``Trainer.train`` on a TextZoom-layout LMDB.

Set-up renders the cell's crops and writes them as an LMDB under
``TMPDIR``, makes the weights on the card, builds the port's trainer as
its CLI does, and steps it ``check_steps`` times through the window's
own call and loader (these are the steps the reference follows, and
they warm every shape).  The window is whole epochs, one
``Trainer.train`` call each (the loader restarts at each), as many as
end inside ``--seconds`` (:func:`~stisr_bench.harness.whole_units`);
each call ends on the host's read of its metrics, which waits for the
card.  The mix's rate metric is the window's images over its wall time.
With ``--trace 1`` the same window gives the loader's wait, the peak
memory and the whole step's FLOP rate, and a further profiled call of
``trace_steps`` steps the device's idle share and the kernels'
rooflines.  After the window the program is freed and the reference
takes its first steps from the same weights, on the same rows with the
same draws.  :func:`calibrate_seed` takes the readings that the cell's
limits are set from.
"""

from __future__ import annotations

import math
import os
import sys
import time

import torch

from stisr_bench import bench, checks, flops, guard, harness, program, trace, traffic
from stisr_bench.reference import full_precision, nets, steps, tf32


def build(cell, seed: int, setup, tmp: str) -> dict:
    """Data, weights and the port's trainer (its loader behind the
    benchmark's proxy): the run's state."""
    config, workload, mix = cell.config, cell.workload, cell.mix
    batch = workload["batch"]
    hr_size, lr_size = harness.shape(config)
    with setup.part("render"):
        crops = traffic.render(seed, config["train_pairs"], hr_size, lr_size, mix["store"],
                               traffic.cpu_workers())
    root = os.path.join(tmp, "train")
    with setup.part("lmdb"):
        program.write_lmdb(root, traffic.lmdb_records(crops))
    device, leaves = harness.prepare(setup, seed, config)
    with setup.part("import"):
        program.import_all()
    with setup.part("program"):
        yaml = program.yaml_text(config, seed, [root], [], batch,
                                 os.path.join(tmp, "ckpt"))
        cfg, _ = program.parse(config, harness.write_yaml(tmp, yaml), batch)
        models = program.build_models(cfg, leaves, device)
        trainer = program.trainer(cfg, models, program.lmdb_dataset(root, config["voc_type"]),
                                  device)
        proxy = harness.LoaderProxy(trainer.loader)
        trainer.loader = proxy
    return {"config": config, "seed": seed, "batch": batch, "crops": crops, "device": device,
            "leaves": leaves, "models": models, "trainer": trainer, "proxy": proxy}


def first_steps(state: dict, n: int) -> dict:
    """The trainer's first ``n`` steps through ``Trainer.train`` and its
    loader: each step's loss, Adam's first moments after step 1 (taken
    when batch 2 arrives: step 1's update is queued, step 2's not yet),
    the trainable leaves after step ``n`` and the batches' crops."""
    trainer, proxy, (gens, stus, _) = state["trainer"], state["proxy"], state["models"]
    named = {f"{role}.{k}": p for role, mods in (("generator", gens), ("student", stus))
             for m in mods for k, p in m.named_parameters()}
    by_id = {id(p): k for k, p in named.items()}
    moments = {}

    def take_moments():
        for p, st in trainer.optimizer.state.items():
            moments[by_id[id(p)]] = st["exp_avg"].detach().clone()

    proxy.on_next, proxy.keep = (lambda k: take_moments() if k == 2 else None), n
    result = trainer.train(max_iters=n)
    proxy.on_next = None
    if n == 1:
        take_moments()
    return {"losses": result["metrics"]["loss_total"], "moments": moments,
            "after": {k: p.detach().clone() for k, p in named.items()},
            "kept": list(proxy.kept)}


def run(cell, seed: int, seconds: float, traced: bool, t0: float) -> None:
    mix = cell.mix
    setup = bench.Setup(t0)
    with harness.scratch() as tmp:
        state = build(cell, seed, setup, tmp)
        trainer, proxy, models, batch = (state[k] for k in ("trainer", "proxy", "models", "batch"))
        with setup.part("check_steps"):
            readings = first_steps(state, mix["check_steps"])
        setup_s = setup.seconds()
        harness.sync()
        peak = harness.peak_bytes()
        harness.reset_peak()
        proxy.reset()
        epoch, losses = len(proxy), []

        def one_epoch(_):
            losses.extend(trainer.train(max_iters=trainer.iters + epoch)["metrics"]["loss_total"])

        t = time.perf_counter()
        each = harness.whole_units(one_epoch, seconds)
        harness.sync()
        window_s = time.perf_counter() - t
        n_steps = epoch * len(each)
        window = {"seconds": window_s, "steps": n_steps, "images": n_steps * batch,
                  "loader_wait_s": proxy.wait_s, "loader_waits": proxy.waits,
                  "peak_bytes": harness.peak_bytes()}
        print(f"[window] {len(each)} epochs, {n_steps} steps of {batch} in {window_s:.3f} s "
              "(epochs " + " ".join(f"{x:.3f}" for x in each) + " s)", file=sys.stderr, flush=True)
        failed = sum(1 for v in losses if not math.isfinite(v))
        breakdown, traced_window = None, None
        if traced:
            ctx = harness.context("train", cell.config, window)
            ctx["trace"] = traced_window = trace.profile(
                lambda: trainer.train(max_iters=trainer.iters + mix["trace_steps"]),
                [*models[0], *models[1], models[2]], bench.rooflines(cell), harness.sync)
            ctx["flops"] = flops.train_step(cell.config, batch)
            metrics = bench.read_per_layer(cell, ctx)
            breakdown = {"device_ops": traced_window["device_ops"],
                         "idle_gaps": traced_window["idle_gaps"]}
        else:
            values = {mix["rate_metric"]: window["images"] / window_s, "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end}
        peak = max(peak, harness.peak_bytes())
        del trainer, proxy, models
        release(state)
        t = time.perf_counter()
        numbers = compare(state, readings)
        print(f"[check] the reference in {time.perf_counter() - t:.3f} s", file=sys.stderr,
              flush=True)
    ok, compared = checks.verdict(numbers, cell.workload.get("limits", {}))
    guard.require_no_jax()
    bench.emit(ok, window["steps"], failed, metrics,
               bench.device_info(cell.chips, peak, traced_window), compared, breakdown)


def release(state: dict) -> None:
    """Free the program's objects before the reference runs."""
    for key in ("trainer", "proxy", "models"):
        state.pop(key, None)
    harness.free_program()


def reference_steps(state: dict, n_steps: int, fault=None) -> dict:
    """The reference's first ``n_steps`` steps from the run's weights on
    the rows and with the draws the program's loader and step take:
    losses, the first step's gradient norms, each leaf's change after the
    last step, and the rows it read; ``fault(batch)`` may plant a fault in
    its batches."""
    config, crops, batch, seed, device = (state[k] for k in ("config", "crops", "batch", "seed",
                                                              "device"))
    hr_size, lr_size = harness.shape(config)
    models = nets.build(config)
    for name, module in models.items():
        module.to(device)
        with torch.no_grad():
            for k, p in module.named_parameters():
                p.copy_(state["leaves"][name][k])
    start = {k: p.detach().clone() for k, p in steps.trainable(models).items()}
    opt = steps.Adam(steps.trainable(models), config["lr"])
    order = traffic.epoch_order(len(crops), seed, 0)
    losses, grad, rows = [], None, []
    for i in range(n_steps):
        arrays = traffic.batch_arrays(crops, order[i * batch:(i + 1) * batch], hr_size, lr_size)
        rows.append(arrays)
        data = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        if fault is not None:
            data = fault(data)
        # the trainer's per-step generator: the run's seed and the step number
        gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)
        loss, grads = steps.train_step(config["arch"], models, opt, data, gen)
        losses.append(loss)
        if i == 0:
            grad = checks.leaf_norms(grads)
    update = checks.leaf_norms({k: p.detach() - start[k] for k, p in steps.trainable(models).items()})
    return {"losses": losses, "grad": grad, "update": update, "rows": rows}


def program_readings(state: dict, readings: dict, ref: dict) -> dict:
    """The program's losses, first-gradient and change norms, and rows
    that differ from the reference's."""
    beta1 = state["config"]["beta1"]
    start = {f"{role}.{k}": v for role in ("generator", "student")
             for k, v in state["leaves"][role].items()}
    kept = readings["kept"]
    return {
        "losses": readings["losses"],
        "grad": checks.leaf_norms({k: m / (1.0 - beta1) for k, m in readings["moments"].items()}),
        "update": checks.leaf_norms({k: v - start[k] for k, v in readings["after"].items()}),
        "rows_off": sum(checks.rows_differ(hr, r["images_hr"]) + checks.rows_differ(lr, r["images_lr"])
                        for (hr, lr), r in zip(kept, ref["rows"])) + abs(len(kept) - len(ref["rows"])),
    }


def compare(state: dict, readings: dict) -> dict:
    """The program's readings against the reference's (``checks``)."""
    with full_precision():
        ref = reference_steps(state, len(readings["losses"]))
    return checks.train_numbers(program_readings(state, readings, ref), ref)


def calibrate_seed(cell, seed: int, control: bool) -> dict:
    """The check's numbers on one seed, without a window: the program's
    (its lower readings), and with ``control`` the TF32 control's and the
    half batch's (the reference in the program's place)."""
    out = {}
    with harness.scratch() as tmp:
        state = build(cell, seed, bench.Setup(time.perf_counter()), tmp)
        readings = first_steps(state, cell.mix["check_steps"])
        release(state)
        n = len(readings["losses"])
        with full_precision():
            ref = reference_steps(state, n)
        prog = program_readings(state, readings, ref)
        out["program"] = checks.train_numbers(prog, ref)
        out["program_update"] = checks.update_diagnosis(prog, ref)
        if control:
            def as_program(r):
                return {"losses": r["losses"], "grad": r["grad"], "update": r["update"],
                        "rows_off": 0}

            with tf32():
                ctl = as_program(reference_steps(state, n))
            out["control"] = checks.train_numbers(ctl, ref)
            out["control_update"] = checks.update_diagnosis(ctl, ref)
            with full_precision():
                out["half_batch"] = checks.train_numbers(
                    as_program(reference_steps(state, n, fault=harness.half)), ref)
    return out
