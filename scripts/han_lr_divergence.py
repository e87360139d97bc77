"""HAN at full width under the recipe's Adam (lr from the command line,
beta1 0.5), the JAX package against the port, on the CPU: the same seeded
weights (the port's init, read into JAX by ``import_han``), the same batch,
``--steps`` plain steps each (MSE x100, ``--tssim_loss``, no rotation).
Prints ``loss_sr`` step by step for both.

  JAX_PLATFORMS=cpu python scripts/han_lr_divergence.py --lr 1e-3 --steps 4

At the YAML's lr 1e-3 both diverge after the first update (the 200
residual blocks each gain a little from one coherent Adam step), which is
why ``chip_smoke.py`` phase 15 trains HAN at 1e-4.  Both packages are
imported here, as in the tests: this is a cross-check, not part of the
port.  ~3 min and ~6 GB at batch 4 on one CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tatt_tpu.core.torch_import import import_han  # noqa: E402
from tatt_tpu.data.collate import collate as jcollate  # noqa: E402
from tatt_tpu.data.synthetic import SyntheticTextDataset  # noqa: E402
from tatt_tpu.losses.image import mse_loss as jmse  # noqa: E402
from tatt_tpu.models.zoo.han import HAN as JHAN  # noqa: E402
from tatt_tpu.train.state import TrainState  # noqa: E402
from tatt_tpu.train.state import make_optimizer as jmake_optimizer  # noqa: E402
from tatt_tpu.train.steps import StepConfig as JStepConfig  # noqa: E402
from tatt_tpu.train.steps import make_plain_train_step  # noqa: E402
from tatt_tpu_torch.core.config import Config, Flags  # noqa: E402
from tatt_tpu_torch.models.common import init_parameters  # noqa: E402
from tatt_tpu_torch.models.factory import arch_steps  # noqa: E402
from tatt_tpu_torch.models.zoo.han import HAN  # noqa: E402
from tatt_tpu_torch.train.state import make_optimizer  # noqa: E402
from tatt_tpu_torch.train.steps import StepConfig  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "highest")
    port = init_parameters(HAN(), args.seed)
    jvars = import_han({k: v.numpy() for k, v in port.state_dict().items()})
    ds = SyntheticTextDataset(n=args.batch, seed=3)
    arrays = jcollate([ds[i] for i in range(args.batch)]).device_arrays()
    batch = {k: np.asarray(arrays[k]) for k in ("images_hr", "images_lr")}
    flags = dict(tssim_loss=True, rotate_train=0.0)
    model = JHAN()

    def sr_apply(variables, lr, train, rngs=None, mutable=False):
        return model.apply(variables, lr, train=train, rngs=rngs, mutable=mutable)

    t0 = time.perf_counter()
    step = jax.jit(make_plain_train_step(sr_apply, jmse, JStepConfig(**flags), 3))
    state = TrainState.create([dict(jvars, batch_stats={})], [{"params": {}, "batch_stats": {}}],
                              jmake_optimizer(args.lr, 0.5))
    jax_losses = []
    for i in range(args.steps):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(i))
        jax_losses.append(float(metrics["loss_sr"]))
    print(f"JAX  loss_sr by step at lr {args.lr}: {jax_losses} ({time.perf_counter() - t0:.0f} s)")

    t0 = time.perf_counter()
    train_fn, _ = arch_steps(Config(args=Flags(arch="han", mask=True)))
    opt = make_optimizer(list(port.parameters()), args.lr, 0.5)
    port_losses = []
    for i in range(args.steps):
        metrics = train_fn([port.train()], [], None, opt,
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           StepConfig(**flags), torch.Generator().manual_seed(i))
        port_losses.append(metrics["loss_sr"].item())
    print(f"port loss_sr by step at lr {args.lr}: {port_losses} ({time.perf_counter() - t0:.0f} s)")


if __name__ == "__main__":
    main()
