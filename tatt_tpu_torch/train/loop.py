"""Evaluation and training loops (counterpart of ``tatt_tpu/train/loop.py``).

:class:`Evaluator` is ``Trainer.evaluate``: for each batch the eval step
(student prior -> TATT, ``stu_iter`` times, with ``for_cascading``), PSNR/SSIM
of SR and of the bicubic-upscaled LR against HR, and the judge's
reading of SR, LR and HR (:mod:`.judge`: CRNN, ASTER or MORAN), its
accuracy after ``str_filt`` with ``filter_mode`` (``lower``, or ``chinese``
under ``--CHNSR``) and the SR reading's NED;
with an LPIPS function also LPIPS of SR and of the bicubic LR against HR;
with ``n_vis`` the first ``n_vis`` samples of each evaluation as LR / SR /
HR triptychs, and the TP-Interpreter's attention tiles (``att_``), under
``vis_root`` (``demo/<vis_dir>`` in the trainer, as JAX writes them).

:class:`Trainer` is ``Trainer.train`` (``loop.py:546-673``), configured by a
:class:`~tatt_tpu_torch.core.config.Config`: the step's flags
(:func:`step_config`), ``n_sr`` generators and ``n_stu`` students
(:func:`copies`, ``loop.py:168-174``) under one Adam, seeded shuffled
batches (``TRAIN.workers`` threads; ``--syn``'s collate under that
flag), one step each with a generator seeded from the run's seed and the
step number: :func:`train_step` for an arch
of ``ABLATION_SET``, else :func:`plain_train_step` (the students then
carry no loss, as in JAX's ``TrainState``), as
:func:`~tatt_tpu_torch.models.factory.arch_steps` says; a log
line every ``displayInterval`` steps.  When ``iters`` reaches a
multiple of ``valInterval`` it evaluates the val sets, appends
``{"iterator", "results"}`` to ``converge_list`` and, on a new best sum of
the sets' accuracies, saves ``model_best_acc_0.ckpt``; at a multiple of
``saveInterval`` it saves ``checkpoint.ckpt``, both under
``<TRAIN.ckpt_dir>/<vis_dir>/`` (``core/checkpoint.py``).  The rolling
checkpoint also carries ``best_history_res``, which the JAX package leaves
empty there, so that a resume from it keeps the best sum-accuracy.
:meth:`Trainer.resume` restores models, BN buffers, Adam state, ``iters``,
``converge_list`` and the best history, then sets the configured ``lr``.
With ``--log_dir`` (default ``tensorboard``) and tensorboardX installed,
the trainer writes every metric as ``loss/<name>`` every 5 steps and each
val set's ``eval/{psnr,ssim,accuracy}_<set>`` at each validation, under
``<log_dir>/<vis_dir>`` (:func:`make_summary_writer`); tensorboardX
writes its queue out when the writer is closed, at the latest when the
process exits.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import time
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from tatt_tpu_torch.core import distributed
from tatt_tpu_torch.core.checkpoint import resume_models, save_checkpoint
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.mesh import shard_batch
from tatt_tpu_torch.data.collate import Batch
from tatt_tpu_torch.data.device_pipeline import device_normalize
from tatt_tpu_torch.data.loader import DataLoader
from tatt_tpu_torch.kernels.resize import resize_bicubic
from tatt_tpu_torch.losses.ssim import psnr, ssim
from tatt_tpu_torch.models.common import set_bn_replicas
from tatt_tpu_torch.models.factory import CRNN_SPEC, RecognizerSpec, arch_steps, recognizer_spec
from tatt_tpu_torch.train.demo import attention_grid, triptych
from tatt_tpu_torch.train.judge import make_judge
from tatt_tpu_torch.train.metrics import EvalAccumulator
from tatt_tpu_torch.train.observe import span
from tatt_tpu_torch.train.state import make_optimizer
from tatt_tpu_torch.train.steps import StepConfig, eval_step

_warned_no_tensorboard = False


def make_summary_writer(log_dir: str, vis_dir: str):
    """A tensorboardX ``SummaryWriter`` on ``<log_dir>/<vis_dir>`` with the
    directory's old event files removed (``loop.py:46-71``), or None, with
    one warning on stderr a process, when tensorboardX is not installed."""
    global _warned_no_tensorboard
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        if not _warned_no_tensorboard:
            print(f"tatt_tpu_torch: tensorboardX is not installed — scalar logging to {log_dir!r} "
                  "is disabled (install tensorboardX to enable)", file=sys.stderr)
            _warned_no_tensorboard = True
        return None
    tb_dir = os.path.join(log_dir, vis_dir)
    os.makedirs(tb_dir, exist_ok=True)
    for name in os.listdir(tb_dir):
        path = os.path.join(tb_dir, name)
        if os.path.isfile(path):
            with contextlib.suppress(FileNotFoundError):  # another run's wipe got there first
                os.unlink(path)
    return SummaryWriter(tb_dir)


def to_device(batch, device: torch.device, mask: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(HR, LR) of a uint8 batch, normalized on the device."""
    return tuple(
        device_normalize(torch.from_numpy(a).to(device), mask) for a in (batch.images_hr, batch.images_lr)
    )


def step_batch(batch: Batch, device: torch.device, cfg: StepConfig, rank: int = 0,
               world: int = 1) -> dict:
    """The leaves of a batch that :func:`train_step` reads under ``cfg``,
    on the device: the uint8 crops (the step normalizes them), and the
    ``YCbCr`` crops and CTC labels where ``y_domain`` / ``use_label`` ask;
    of a global batch, rank ``rank``'s rows of ``world``
    (:func:`~tatt_tpu_torch.core.mesh.shard_batch`)."""
    names = ["images_hr", "images_lr"]
    if cfg.y_domain:
        names += ["images_hr_y", "images_lr_y"]
    if cfg.use_label:
        names += ["ctc_targets", "ctc_lengths", "weighted_tics"]
    with span("tatt.step.batch"):
        rows = shard_batch({k: getattr(batch, k) for k in names}, rank, world)
        out = {k: torch.from_numpy(v).to(device) for k, v in rows.items()}
        if cfg.use_label:
            out["weighted_tics"] = out["weighted_tics"].float()
    return out


def copies(args: Flags) -> tuple[int, int]:
    """(n_sr, n_stu): one generator and one student, or ``stu_iter`` of
    each where ``--sr_share`` / ``--tpg_share`` is off (``loop.py:168-174``)."""
    n = args.stu_iter
    return (1 if args.sr_share or n == 1 else n), (1 if args.tpg_share or n == 1 else n)


def geometry_of(cfg: Config) -> dict:
    """``TRAIN``'s crop geometry as the collate's keywords (JAX's
    ``loop.py:365-367, 723-725``)."""
    t = cfg.TRAIN
    return dict(width=t.width, height=t.height, down_sample_scale=t.down_sample_scale)


def step_config(args: Flags) -> StepConfig:
    """The train step's options from the flags (``loop.py:194-213``)."""
    return StepConfig(
        stu_iter=args.stu_iter, sr_share=args.sr_share or args.stu_iter == 1,
        tpg_share=args.tpg_share or args.stu_iter == 1, use_distill=args.use_distill,
        use_label=args.use_label, for_cascading=args.for_cascading, y_domain=args.y_domain,
        learning_STN=args.learning_STN, color_loss=args.color_loss, gradient=args.gradient,
        ssim_loss=args.ssim_loss, tssim_loss=args.tssim_loss, fused_tssim=args.fused_tssim,
        mse_fuse=args.mse_fuse, rotate_train=args.rotate_train,
        training_stablize=args.training_stablize, compute_dtype=args.dtype, mask=args.mask,
    )


class Evaluator:
    """The ``--go_test`` protocol over a dataset of (HR, LR, label)
    samples, collated at ``width`` x ``height`` (HR) and that over
    ``down_sample_scale`` (LR): ``TRAIN``'s geometry.  Models must
    already sit on ``device`` in eval mode; ``generators`` / ``students``
    hold one module or one per ``stu_iter`` iteration.  ``judge`` reads
    images into strings (:func:`~tatt_tpu_torch.train.judge.make_judge`; a
    module given here is taken as a CRNN-kind judge of ``spec``).  ``lpips``: a function of
    (images, HR) -> per-sample LPIPS, or None.  ``workers`` threads build
    the batches (the same batches for any count).  ``sr_fn(generators,
    students, lr) -> (sr, aux)`` makes the SR images: the arch's, from
    :func:`~tatt_tpu_torch.models.factory.arch_steps`; by default the TATT
    eval (:func:`eval_step` with ``stu_iter``, ``for_cascading`` and the
    students' input adapter).  ``spec``: the recognizer
    (:func:`~tatt_tpu_torch.models.factory.recognizer_spec`), whose input
    adapter the eval step and judge take, whose alphabet the judge decodes
    over and whose ``filter_mode`` filters the accuracy."""

    def __init__(
        self,
        generators: Sequence[nn.Module],
        students: Sequence[nn.Module],
        judge,
        device: torch.device,
        batch_size: int = 64,
        mask: bool = True,
        workers: int = 1,
        stu_iter: int = 1,
        for_cascading: bool = False,
        lpips: Optional[Callable] = None,
        n_vis: int = 0,
        vis_root: str = os.path.join("demo", "demo"),
        sr_fn: Optional[Callable] = None,
        spec: RecognizerSpec = CRNN_SPEC,
        width: int = 128,
        height: int = 32,
        down_sample_scale: int = 2,
    ):
        self.generators = list(generators)
        self.students = list(students)
        self.sr_fn = sr_fn or (lambda gens, stus, lr: eval_step(gens, stus, lr, stu_iter,
                                                                for_cascading, spec.parse_fn))
        self.decode = make_judge("CRNN", judge, spec=spec) if isinstance(judge, nn.Module) else judge
        self.spec = spec
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.mask = mask
        self.workers = workers
        self.lpips = lpips
        self.n_vis, self.vis_root = n_vis, vis_root
        self.geometry = dict(width=width, height=height, down_sample_scale=down_sample_scale)

    def batches(self, dataset):
        """(HR, LR, labels) per batch, images normalized on the device."""
        for b in DataLoader(dataset, self.batch_size, shuffle=False, drop_last=False,
                            num_workers=self.workers, **self.geometry):
            yield (*to_device(b, self.device, self.mask), b.label_strs)

    @torch.no_grad()
    def evaluate(self, dataset) -> dict:
        acc = EvalAccumulator()
        t0 = time.perf_counter()
        n_vis_left = self.n_vis
        for hr, lr, labels in self.batches(dataset):
            with span("tatt.eval.batch"):
                with span("tatt.eval.sr"):
                    sr, aux = self.sr_fn(self.generators, self.students, lr)
                with span("tatt.eval.score"):
                    lr_up = resize_bicubic(lr, hr.shape[-2], hr.shape[-1])
                    lpips_sr = lpips_lr = None
                    if self.lpips is not None:
                        lpips_sr = self.lpips(sr, hr).mean().item()
                        lpips_lr = self.lpips(lr_up, hr).mean().item()
                    psnr_sr, ssim_sr = psnr(sr, hr).item(), ssim(sr, hr).item()
                    psnr_lr, ssim_lr = psnr(lr_up, hr).item(), ssim(lr_up, hr).item()
                preds = [self.decode(im) for im in (sr, lr, hr)]
                acc.add_batch(psnr_sr, ssim_sr, *preds, labels, filter_mode=self.spec.filter_mode,
                              psnr_lr=psnr_lr, ssim_lr=ssim_lr, lpips_sr=lpips_sr,
                              lpips_lr=lpips_lr, n_real=len(labels))
                if n_vis_left > 0:
                    n = min(n_vis_left, len(labels))
                    self.visualize(lr[:n], sr[:n], hr[:n], preds[1][:n], preds[0][:n], labels[:n],
                                   aux.get("pr_weights") if isinstance(aux, dict) else None)
                    n_vis_left -= n
        acc.infer_time = time.perf_counter() - t0
        return acc.summary()

    def visualize(self, lr, sr, hr, preds_lr, preds_sr, labels, pr_weights) -> None:
        """``--vis`` (``loop.py:785-829``): a triptych per sample, named by
        its LR and SR readings and label, and its attention tiles (``att_``)."""
        lr, sr, hr = (t.cpu().numpy() for t in (lr, sr, hr))
        weights = None if pr_weights is None else pr_weights.cpu().numpy()
        for i, (p_lr, p_sr, label) in enumerate(zip(preds_lr, preds_sr, labels)):
            name = f"{p_lr}_{p_sr}_{label}_.png".replace("/", "")
            triptych(lr[i], sr[i], hr[i], os.path.join(self.vis_root, name))
            if weights is not None:
                attention_grid(weights[i], os.path.join(self.vis_root, "att_" + name),
                               feat_hw=tuple(lr.shape[-2:]))


BATCH_REFUSAL = ("batch_size {batch} does not split over {world} data-parallel ranks (the JAX "
                 "package's shard_batch refuses it too: device_put needs the global size of "
                 "dimension 0 divisible by {world})")


class Trainer:
    """Trains ``generators`` and ``students`` (the :func:`copies` of each,
    as lists; one Adam over all) against the frozen ``teacher``.  The
    validation judge is ``judge`` (:func:`~tatt_tpu_torch.train.judge.
    make_judge`), else the teacher read as a CRNN judge (the JAX package's
    CRNN judge without dedicated weights, ``loop.py:353-355``), through
    the :func:`~tatt_tpu_torch.models.factory.recognizer_spec` of ``cfg``,
    which also gives the alphabet the train batches' label fields are
    encoded over; ``lpips``
    adds LPIPS to each validation.  The models must already sit on
    ``device``.  A generator without parameters (``bicubic``) is refused.

    In a process group of D ranks (``core/distributed.py``; the JAX
    trainer's mesh, ``loop.py:91-101, 548-606``) ``cfg.batch_size`` is the
    global batch, which D must divide: every rank builds the same global
    batches and steps on its rows (:func:`step_batch`), the state starts
    as rank 0's (also after :meth:`resume`), the BatchNorms are sync-BN or,
    with ``--bn_per_replica``, per rank (``models/common.set_bn_replicas``),
    and rank 0 alone validates, saves, prints and writes scalars while the
    others wait."""

    def __init__(
        self,
        cfg: Config,
        generators: Sequence[nn.Module],
        students: Sequence[nn.Module],
        teacher: nn.Module,
        train_dataset,
        device: torch.device,
        val_datasets: Optional[dict] = None,
        judge: Optional[Callable] = None,
        lpips: Optional[Callable] = None,
    ):
        self.cfg = cfg
        self.generators, self.students = list(generators), list(students)
        want = copies(cfg.args)
        if (len(self.generators), len(self.students)) != want:
            raise ValueError(f"{len(self.generators)} generators and {len(self.students)} students "
                             f"given, the flags ask for {want[0]} and {want[1]}")
        if not any(True for m in self.generators for _ in m.parameters()):
            # BICUBIC: the JAX Trainer fails on it too (train/state.py:36)
            raise ValueError(f"--arch={cfg.args.arch}: the generator has no parameters to train")
        self.teacher = teacher
        self.device = torch.device(device)
        self.rank, self.world = distributed.rank(), distributed.world()
        if cfg.batch_size % self.world:
            raise ValueError(BATCH_REFUSAL.format(batch=cfg.batch_size, world=self.world))
        # process-wide, as JAX's set_bn_replicas (loop.py:95-101)
        set_bn_replicas(self.world if cfg.args.bn_per_replica else 1)
        self.step_cfg = step_config(cfg.args)
        self.train_fn, sr_fn = arch_steps(cfg)
        self.optimizer = make_optimizer(
            itertools.chain(*(m.parameters() for m in self.generators + self.students)),
            cfg.lr, cfg.TRAIN.beta1,
        )
        workers, spec, geometry = max(cfg.TRAIN.workers, 1), recognizer_spec(cfg), geometry_of(cfg)
        self.loader = DataLoader(train_dataset, cfg.batch_size, shuffle=True, drop_last=True,
                                 seed=cfg.TRAIN.manualSeed, num_workers=workers,
                                 y_domain=cfg.args.y_domain, alphabet=spec.alphabet,
                                 syn=cfg.args.syn, **geometry)
        self.evaluator = Evaluator(
            self.generators, self.students, judge or teacher, device,
            cfg.args.val_batch_size or cfg.batch_size, cfg.args.mask, workers, cfg.args.stu_iter,
            cfg.args.for_cascading, lpips, cfg.TRAIN.VAL.n_vis if cfg.args.vis else 0,
            os.path.join("demo", cfg.vis_dir), sr_fn, spec, **geometry,
        )
        self.val_datasets = val_datasets or {}
        self.ckpt_dir = os.path.join(cfg.TRAIN.ckpt_dir, cfg.vis_dir)
        self.iters = 0
        self.converge_list: list = []
        self.best_history: dict = {}
        self.best_sum_acc = -1.0
        self.writer = (make_summary_writer(cfg.args.log_dir, cfg.vis_dir)
                       if cfg.args.log_dir and self.rank == 0 else None)
        self._broadcast()

    def _broadcast(self) -> None:
        distributed.broadcast_state(self.generators + self.students, self.optimizer, self.device)

    def resume(self, path: str) -> None:
        """``--resume`` of a port checkpoint, a run directory or a
        reference ``.pth`` (``loop.py:421-452``).  The saved Adam
        ``param_groups`` hold the old ``lr``; the finetune stage resumes
        with a new one (``--lr 2e-4``), so the configured ``lr`` is set
        again after the restore, the moments and step counts kept."""
        payload = resume_models(path, self.generators, self.students, self.optimizer)
        if payload is None:  # a reference .pth: weights only
            return
        for group in self.optimizer.param_groups:
            group["lr"] = self.cfg.lr
        self.iters = payload["iters"]
        self.converge_list = list(payload["converge"])
        self.best_history = dict(payload["best_history_res"])
        if self.best_history:
            self.best_sum_acc = sum(r.get("accuracy", 0.0) for r in self.best_history.values())
        self._broadcast()
        if self.rank == 0:
            print(f"resumed from {path} at step {self.iters}: {payload['info']}")

    def evaluate(self, dataset) -> dict:
        for m in self.generators + self.students:
            m.eval()
        return self.evaluator.evaluate(dataset)

    def validate(self) -> dict:
        results = {name: self.evaluate(ds) for name, ds in self.val_datasets.items()}
        for name, s in results.items():
            print(
                f"eval[{name}] psnr {s['psnr_avg']:.3f} ssim {s['ssim_avg']:.4f} "
                f"acc {s['accuracy']:.4f}"
            )
        return results

    def _info(self, epoch: int) -> dict:
        return {
            "arch": self.cfg.args.arch,
            "iters": self.iters,
            "epochs": epoch,
            "batch_size": self.cfg.batch_size,
            "voc_type": self.cfg.TRAIN.voc_type,
            "up_scale_factor": self.cfg.scale_factor,
        }

    def _save(self, name: str, epoch: int) -> None:
        save_checkpoint(
            os.path.join(self.ckpt_dir, name), self.generators, self.students, self.optimizer,
            self.iters, info=self._info(epoch), best_history=self.best_history,
            converge=self.converge_list,
        )

    def _scalars(self, metrics: dict) -> None:
        """``loop.py:539-543``: every metric as ``loss/<name>``."""
        for key, value in metrics.items():
            self.writer.add_scalar(f"loss/{key.replace('loss_', '')}", float(value), self.iters)

    def _validate_and_checkpoint(self, epoch: int) -> None:
        """``loop.py:685-711``."""
        results = self.validate()
        if self.writer is not None:
            for name, r in results.items():
                for key in ("psnr", "ssim", "accuracy"):
                    value = r["accuracy" if key == "accuracy" else f"{key}_avg"]
                    self.writer.add_scalar(f"eval/{key}_{name}", value, self.iters)
        self.converge_list.append({"iterator": self.iters, "results": results})
        sum_acc = sum(r["accuracy"] for r in results.values())
        if results and sum_acc > self.best_sum_acc:
            self.best_sum_acc = sum_acc
            self.best_history = results
            self._save("model_best_acc_0.ckpt", epoch)
            print(f"new best sum-acc {sum_acc:.4f} @ iter {self.iters}")

    def train(self, max_iters: Optional[int] = None) -> dict:
        """Steps until ``max_iters`` (counted over every call) or the last
        epoch.  Returns ``iters``, the per-step metrics of this call, as
        lists of floats (read from the device once, at the end), and the
        call's wall ``seconds``."""
        cfg = self.cfg.TRAIN
        history = []
        self.teacher.eval()
        t0 = time.perf_counter()
        done = max_iters is not None and self.iters >= max_iters
        for epoch in range(self.cfg.epochs):
            if done:
                break
            for batch in self.loader:
                with span("tatt.step"):
                    for m in self.generators + self.students:
                        m.train()
                    # seeded from the run's seed and the step number, as the JAX
                    # loop keys each step with PRNGKey(iters) (loop.py:599)
                    gen = torch.Generator(device=self.device).manual_seed(
                        cfg.manualSeed * 1_000_003 + self.iters
                    )
                    metrics = self.train_fn(self.generators, self.students, self.teacher,
                                            self.optimizer,
                                            step_batch(batch, self.device, self.step_cfg, self.rank,
                                                       self.world),
                                            self.step_cfg, gen)
                    history.append(metrics)
                    self.iters += 1
                    if self.writer is not None and self.iters % 5 == 0:
                        self._scalars(metrics)
                    if self.iters % cfg.displayInterval == 0 and self.rank == 0:
                        ips = len(history) * self.cfg.batch_size / (time.perf_counter() - t0)
                        print(
                            f"[epoch {epoch}] iter {self.iters} "
                            + " ".join(f"{k} {v.item():.3f}" for k, v in metrics.items())
                            + f" ({ips:.1f} img/s)"
                        )
                # validation, then the rolling save (_boundary, loop.py:575-591),
                # on rank 0 while the other ranks wait
                validate = cfg.VAL.valInterval > 0 and self.iters % cfg.VAL.valInterval == 0
                save = cfg.saveInterval > 0 and self.iters % cfg.saveInterval == 0
                if self.rank == 0 and validate:
                    self._validate_and_checkpoint(epoch)
                if self.rank == 0 and save:
                    self._save("checkpoint.ckpt", epoch)
                if validate or save:
                    distributed.barrier()
                if max_iters is not None and self.iters >= max_iters:
                    done = True
                    break
        keys = history[0].keys() if history else ()
        metrics = {k: torch.stack([m[k] for m in history]).tolist() for k in keys}
        return {"iters": self.iters, "metrics": metrics, "seconds": time.perf_counter() - t0}
