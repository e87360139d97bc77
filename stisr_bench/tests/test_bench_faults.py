"""A run on the CPU at a tiny size, its look for a card skipped, comes
out correct; with the measured path broken underneath it comes out not
correct: a step that leaves the state unchanged, half of each batch left
out (the mean taken over the rest), a judge's answer altered where it is
produced."""

import json

import pytest
import torch

LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-3, "update_gap": 0.2, "rows_off": 0.0,
          "sr_gap": 1e-4, "psnr_gap": 1e-3, "ssim_gap": 1e-4, "logit_gap": 1e-4,
          "strings_off": 0.0}


def drive(cell, capsys) -> dict:
    cell.driver().run(cell, 2**31 + 99, 0.5, False, 0.0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["device"]["count"] == 1
    return line


def halve(rows: dict) -> dict:
    return {k: v[: len(v) // 2] for k, v in rows.items()}


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_train_run(fault, cpu_harness, tiny_cell, monkeypatch, capsys):
    from tatt_tpu_torch.train import loop

    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        step_batch = loop.step_batch
        monkeypatch.setattr(loop, "step_batch", lambda *a, **k: halve(step_batch(*a, **k)))
    line = drive(tiny_cell("tatt-train-b256", LIMITS), capsys)
    assert line["correct"] is (fault is None), line["checks"]
    if fault == "unchanged":
        assert line["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", [None, "answer", "half_batch"])
def test_eval_run(fault, cpu_harness, tiny_cell, monkeypatch, capsys):
    from tatt_tpu_torch.train import judge, loop

    if fault == "answer":
        collapse = judge.ctc_collapse
        monkeypatch.setattr(judge, "ctc_collapse",
                            lambda *a, **k: [s + "x" if i == 0 else s
                                             for i, s in enumerate(collapse(*a, **k))])
    elif fault == "half_batch":
        to_device = loop.to_device
        monkeypatch.setattr(loop, "to_device",
                            lambda *a, **k: tuple(t[: len(t) // 2] for t in to_device(*a, **k)))
    line = drive(tiny_cell("tatt-eval-b256", LIMITS), capsys)
    assert line["correct"] is (fault is None), line["checks"]
