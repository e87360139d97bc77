"""CTC pretraining of the CRNN in the port against ``tatt_tpu.train.pretrain``
(CPU, a narrow CRNN).

The learning-rate schedule equals optax's ``warmup_cosine_decay_schedule``
at every update count within rtol 1e-6 (float32 on optax's side); the
augmentation, fed the draws of the JAX function's key, within 1e-6; three
pretraining steps without augmentation from the JAX function's own
initial weights: losses within 1e-4 relative, word accuracies equal, and
the trained weights within the bound below; and a port-trained
``state_dict`` saved as a ``.pth`` is read by the JAX package's
``import_crnn`` into a CRNN that gives the port's logits (atol 1e-5 /
rtol 1e-4, the module tolerance of ``test_torch_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tatt_tpu.core.torch_import import import_crnn
from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.recognizers.crnn import parse_crnn_input as jparse
from tatt_tpu.train import pretrain as jpretrain
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.models.common import init_parameters
from tatt_tpu_torch.models.recognizers.crnn import CRNN, parse_crnn_input
from tatt_tpu_torch.train.pretrain import augment_images, lr_at, pretrain_recognizer

TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))


@pytest.mark.parametrize("steps", [300, 3000, 5])
def test_schedule_matches_optax(steps):
    """Every update count of the run and past its end (warmup
    ``min(200, steps // 10)``: 30, 200, and 0)."""
    lr = 1e-3
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.1, peak_value=lr, warmup_steps=min(200, steps // 10), decay_steps=steps,
        end_value=lr * 0.05)
    counts = np.arange(0, min(steps, 400) + 5)
    want = np.asarray(jax.vmap(schedule)(jnp.asarray(counts)))
    got = np.array([lr_at(int(k), lr, steps) for k in counts])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("max_sigma", [1.0, 0.4])
def test_augment_images_matches_with_the_jax_draws(max_sigma):
    rng = np.random.default_rng(2)
    images = rng.uniform(0, 1, (5, 3, 32, 128)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jpretrain.augment_images(key, jnp.asarray(images), max_sigma))
    # the JAX function's draws, in its order (pretrain.py:70-88)
    k_sig, k_nsig, k_noise, k_bright, k_contrast = jax.random.split(key, 5)
    b = images.shape[0]
    draws = {
        "sigma": jax.random.uniform(k_sig, (b,), minval=0.0, maxval=max_sigma),
        "noise_sigma": jax.random.uniform(k_nsig, (b, 1, 1, 1), maxval=8.0 / 255.0),
        "noise": jax.random.normal(k_noise, images.shape),
        "bright": jax.random.uniform(k_bright, (b, 1, 1, 1), minval=-0.15, maxval=0.15),
        "contrast": jax.random.uniform(k_contrast, (b, 1, 1, 1), minval=0.85, maxval=1.15),
    }
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    got = augment_images(torch.tensor(images), draws, max_sigma)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_three_pretraining_steps_match(capsys):
    """``augment=False``, batch 8, an evaluation after each step.  The
    trained weights within rtol 1e-3 / atol 3e-6, but for the three conv
    biases before a training-mode BatchNorm (``cnn.conv2/4/6.bias``): their
    gradient is zero analytically, so each side's Adam moves them by about
    lr (1e-3 here: 3 steps leave no warmup) a step in the direction of its
    own rounding noise, the two sides possibly opposite; they are held
    within 2 x 3 updates' worth, 6e-3, and so are the running means of the
    BatchNorms after them, which take in each step's bias with momentum
    0.1."""
    crnn_j = JCRNN(**TINY_CRNN)
    train = dict(steps=3, batch_size=8, lr=1e-3, seed=0, augment=False, eval_every=1)
    want = jpretrain.pretrain_recognizer(crnn_j, JSynthetic(n=24, seed=4),
                                         eval_dataset=JSynthetic(n=16, seed=5), log_fn=None, **train)
    # the JAX function's initial weights (pretrain.py:131-134)
    _, k_init = jax.random.split(jax.random.PRNGKey(0))
    init = crnn_j.init(k_init, jnp.zeros((2, 1, 32, 100)))
    crnn = CRNN(**TINY_CRNN)
    crnn.load_state_dict(from_jax(jax.tree_util.tree_map(np.asarray, init)))
    got = pretrain_recognizer(crnn, SyntheticTextDataset(n=24, seed=4),
                              eval_dataset=SyntheticTextDataset(n=16, seed=5), device="cpu", **train)
    assert [h["step"] for h in got.history] == [h["step"] for h in want.history] == [1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in got.history], [h["loss"] for h in want.history],
                               rtol=1e-4)
    assert [h["acc"] for h in got.history] == [h["acc"] for h in want.history]
    assert "[pretrain] step 3/3 loss " in capsys.readouterr().out
    trained = from_jax(jax.tree_util.tree_map(np.asarray, want.variables))
    for name, value in crnn.state_dict().items():
        free = name in {f"cnn.{m}" for i in (2, 4, 6)
                        for m in (f"conv{i}.bias", f"batchnorm{i}.running_mean")}
        atol = 6e-3 if free else 3e-6
        np.testing.assert_allclose(value.numpy(), trained[name].numpy(), rtol=1e-3, atol=atol,
                                   err_msg=name)


def test_port_trained_crnn_reads_back_through_import_crnn(tmp_path):
    crnn = init_parameters(CRNN(**TINY_CRNN), 3)
    pretrain_recognizer(crnn, SyntheticTextDataset(n=16, seed=6), steps=2, batch_size=4,
                        eval_every=2, log_fn=None, device="cpu")
    path = str(tmp_path / "crnn.pth")
    torch.save(crnn.state_dict(), path)
    images = np.random.default_rng(4).uniform(0, 1, (3, 3, 32, 128)).astype(np.float32)
    want = JCRNN(**TINY_CRNN).apply(import_crnn(path), jparse(jnp.asarray(images)), train=False)
    with torch.no_grad():
        got = crnn.eval()(parse_crnn_input(torch.tensor(images)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_cli_takes_a_pretrained_crnn_of_its_own_width(tmp_path, capsys):
    """A CRNN pretrained at widths of neither the default nor ``--tiny_tpg``
    is the CLI's teacher (its weights as the file holds them, every
    student starting from them) and ``--go_test``'s judge."""
    from tatt_tpu_torch.cli import main as cli

    widths = dict(nh=8, nm=(8, 8, 8, 8, 16, 16, 16))
    crnn = init_parameters(CRNN(**widths), 5)
    pretrain_recognizer(crnn, SyntheticTextDataset(n=16, seed=7), steps=2, batch_size=4,
                        eval_every=2, log_fn=None, device="cpu")
    path = str(tmp_path / "crnn.pth")
    torch.save(crnn.state_dict(), path)
    shrink = ["--srb", "1", "--hd_u", "4", "--batch_size", "4", "--synthetic", "8", "--device", "cpu",
              "--crnn_pretrained", path]
    code, trainer = cli.run(["--mask", "--use_distill", "--stu_iter=2", "--max_iters", "1"] + shrink)
    assert code == 0 and len(trainer.students) == 2
    for name, value in crnn.state_dict().items():
        assert torch.equal(trainer.teacher.state_dict()[name], value), name
    assert cli.main(["--go_test", "--mask"] + shrink) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("[easy] {")
