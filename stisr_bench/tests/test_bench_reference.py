"""The frozen reference against the port's plain path at a tiny size on
the CPU (the one place where both are imported): one training step of
each configuration's recipe and one evaluation batch, from the same
weights, on the same rows, with the same draws."""

import copy
import itertools
import json
import os

import pytest
import torch

from stisr_bench import bench, checks, program, traffic, weights
from stisr_bench.reference import nets, ops, steps

STORE = {"odd_every": 7, "odd_size": {"hr": [120, 30], "lr": [72, 18]}, "jpeg_every": 4}


def tiny(name: str) -> dict:
    config = json.load(open(os.path.join(bench.HERE, "configs", f"{name}.json")))
    config = copy.deepcopy(config)
    config["flags"] = config["flags"] + ["--tiny_tpg"]
    config["recognizer"] = {"nclass": 37, "nh": 16, "nm": [8, 8, 16, 16, 32, 32, 32]}
    config["srb"] = 2
    return config


def both(config: dict, seed: int):
    from tatt_tpu_torch.cli.main import parse_config

    leaves = weights.make(nets.build(config), seed, "cpu")
    cfg, _ = parse_config(config["flags"] + [f"--srb={config['srb']}"])
    port = program.build_models(cfg, leaves, "cpu")
    ref = nets.build(config)
    for name, module in ref.items():
        weights.load(module, leaves[name])
    crops = traffic.render(seed, 6, (128, 32), (64, 16), STORE, 1)
    arrays = traffic.batch_arrays(crops, range(6), (128, 32), (64, 16))
    return cfg, port, ref, {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.mark.parametrize("name", ["tatt", "tsrn"])
def test_one_training_step(name):
    from tatt_tpu_torch.models.factory import arch_steps
    from tatt_tpu_torch.train.loop import step_config
    from tatt_tpu_torch.train.state import make_optimizer

    torch.manual_seed(0)
    config = tiny(name)
    cfg, (gens, stus, teacher), ref, batch = both(config, 2**31 + 21)
    train_fn, _ = arch_steps(cfg)
    opt = make_optimizer(itertools.chain(*(m.parameters() for m in gens + stus)), 1e-3, 0.5)
    for m in gens + stus:
        m.train()
    teacher.eval()
    got = train_fn(gens, stus, teacher, opt, dict(batch), step_config(cfg.args),
                   torch.Generator().manual_seed(77))
    ref_opt = steps.Adam(steps.trainable(ref), 1e-3)
    loss, grads = steps.train_step(name, ref, ref_opt, dict(batch), torch.Generator().manual_seed(77))
    assert abs(float(got["loss_total"]) - loss) <= 1e-5 * abs(loss)
    named = {f"{r}.{k}": p for r, ms in (("generator", gens), ("student", stus))
             for m in ms for k, p in m.named_parameters()}
    prog = checks.leaf_norms({k: opt.state[p]["exp_avg"] / 0.5 for k, p in named.items()})
    assert set(prog) == set(grads)
    assert checks.gap_by_leaf(prog, checks.leaf_norms(grads), grads) < 1e-3
    after = {k: float((p.detach() - ref_opt.params[k].detach()).abs().max()) for k, p in named.items()}
    assert max(after.values()) <= 2.1e-3  # one Adam step of at most lr apart, leaf by leaf


def test_one_evaluation_batch():
    from tatt_tpu_torch.data.device_pipeline import device_normalize
    from tatt_tpu_torch.models.factory import arch_steps
    from tatt_tpu_torch.models.recognizers.crnn import parse_crnn_input
    from tatt_tpu_torch.train.judge import make_judge

    config = tiny("tatt")
    cfg, (gens, stus, teacher), ref, batch = both(config, 2**31 + 22)
    for m in [*gens, *stus, teacher, *ref.values()]:
        m.eval()
    _, sr_fn = arch_steps(cfg)
    lr = device_normalize(batch["images_lr"], True)
    sr, _ = sr_fn(gens, stus, lr)
    want = steps.evaluate_batch("tatt", ref, batch)
    assert float((sr - want["sr"]).abs().max()) < 1e-5
    with torch.no_grad():
        logits = teacher(parse_crnn_input(sr))
    assert float((logits - want["logits"][0]).abs().max()) < 1e-5
    assert make_judge("CRNN", teacher)(sr) == ops.ctc_greedy(logits.argmax(-1).T.numpy())
